"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. device   — a Hopper card (capability 9.0); its name and power limit;
2. build    — every CUDA source of rau_vqa_tpu_torch/csrc that a path runs
              (not the stage kernel's probe build, fused_resnet_probe.cu)
              with nvcc for sm_90a, one nvcc each, all at once, with the
              ptxas register / shared-memory / spill report (the encoder's
              and the stage kernel's per instantiation, the training
              forward's and backward's per phase kernel), the encoder's
              grid plan (CTAs, units a CTA, shared memory) at each batch
              size the run uses, and the training kernels' ``fwd_plan`` and
              ``bwd_plan`` (kernels a hop, K chunks, scratch, shared
              memory), their grids held to the launches of a dry run of
              each built C entry at B in {1, 19, 37, 100}, in both types,
              and the hop kernel's ``hops_plan`` held likewise to its C
              entry's dry run at B in {1, 4, 16, 19, 37, 83, 512};
3. kernels  — each kernel against its plain version at ``ours_ms`` widths:
              the encoder at B in {1, 19, 83, 512} (rows of length 0 and T + 1
              give zeros; a second call gives the same bits) and the hop
              kernel at B in {1, 19, 83, 512}, at the bars of
              tests/test_pallas_rau.py (each reading logged beside its bar;
              a second call gives the same bits); the device mask hash bit
              for bit; the
              training hop loop's forward (rtol / atol 1e-4) and backward
              (grads norm-relative 1e-3 per leaf), each twice on the same
              inputs for the same bits, at B in {19, 100}, the bf16
              forward's and backward's two calls at B=100 likewise; the same
              kernels' bf16 instantiations against their bf16 plain versions
              on bf16 weights, each output and grad leaf norm-relative: at
              one hop, B in {19, 100}, within ``TRAIN_BF16_BARS``, each bar
              under half the plain bf16-vs-float32 distance (logged); at
              eight hops, B in {19, 100}, within twice the plain version's
              own drift when it runs on the host CPU (bf16 rounding flips
              compound over the hops) and under 3/4 of the float32
              distance, which a kernel that skips the rounding reaches; the
              ResNet identity-stage kernel at the four 448-px stage shapes
              (real N, B=2, bf16; each plan's shared memory as the built
              launcher reckons it), in float32 at stage 3's, and at B=3 on
              tiles cut by the image's edge (bars
              scale-normalised, as in tests/test_fused_resnet.py, set from
              readings), where with biases around +1 a relu(b1) halo or a
              dropped bias must land beyond twice the bar; a host watchdog
              ends the run with a message if the stage checks hang, and the
              kernel's own mbarrier watchdog traps a wait that never ends;
4. serving  — ``make_predict_step`` on cuda answers batches of 1, 4, 16, 83
              and 512 with length buckets 8, 16 and 26 each hit; outputs are
              finite and agree with the plain float32 path; both serving
              kernels' launch counts rose during this phase;
5. training — ``make_train_step`` on cuda, ``ours_ms``, B=100, T=26, 10 steps
              on one batch with all dropout and gradient noise on, losses and
              grad norms finite and the last loss below the first, in three
              configurations: fused_train in float32 (each float32 training
              kernel launched exactly 10 times; one step with the backward
              kernel and one with autograd through the plain version agree on
              every grad norm); the preset as shipped (unfused, no training
              kernel launched; one step with remat_hops and one without give
              the same grad norms); fused_train with compute_dtype bfloat16
              (each bf16 kernel launched exactly 10 times, the float32 ones
              never; the first loss within 5% of the float32 fused step's);
              the preset unfused with compute_dtype bfloat16 (no training
              kernel; the first loss within 5% of the unfused float32
              step's);
6. pixels   — ``answer_pixels`` on cuda: the ``ours_resnet`` head, a folded
              bf16 ResNet-101 from the seed, 448x448 uint8 images, B in
              {1, 7, 120} (32, 5 and 1 calls); against ``pixels_forward``
              (the unfused cuDNN backbone on the same tree, the plain float32
              head), with bf16's own effect measured as ``pixels_forward`` on
              the bf16 tree against the float32 tree: answers agree > 0.95
              counting bf16 ties, and with the float32 tree no less than
              ``pixels_forward`` does; attention within twice bf16's own
              change; the kernels' head agrees with the float32 head on the
              same features at the serving bars; the fused backbone is no
              farther from the float32 features than cuDNN's bf16 one; the
              stage kernel ran 4 times a call, the encoder and hop kernels
              once; and the stage kernel agrees with its plain version at
              the B=120 call's own stage inputs;
7. timing   — CUDA-event times of each kernel and its plain version; the
              encoder at B in {1, 16, 83, 512}, T=26, beside torch.nn.LSTM
              in float32 (TF32 off; the ``library_ms`` yardstick) and, logged
              only, in bf16; the predict step at B in {1, 4, 16, 83, 512},
              the train step and its parts at B=100 (fused float32, fused
              bf16, the unfused preset and it in bf16, each with its idle
              share; the bf16
              kernels beside their plain versions), the hop kernel at B in
              {1, 4, 16, 83, 512} with the host's enqueue time of a call and
              its device kernels a call (the profiler's count, held to its
              plan's 2 + 11 a hop), and ``answer_pixels``
              at B=120 with its peak device memory and its parts: each stage kernel beside its plain
              version, the unfused cuDNN stage and its bound, with its plan
              (tile, ring, shared memory, registers) and the weight bytes its
              CTAs read from L2; the stage kernel's levers one at a time (the
              old 4x14 tile at stage 2, the ring's depth at stage 1); the
              device time by kernel with the
              op that launched it; the mask hash beside its plain version;
              each training kernel's device kernels a call, from the
              profiler's records, held to its plan's phases times the hops,
              in both types; the forward's peak device memory a call;
8. trainer  — ``Trainer`` on cuda: ``ours_ms`` at full width (vocab 12,605,
              1000 answers, 14x14x512 features) on the port's fixture built
              in memory (1000 train questions, 166 test, 100 images a
              split; the features as .t7 files in a temporary directory),
              B=100, test batch 83, in the preset's configuration
              (unfused, float32, dropout and noise on, buckets 8 and 16) and
              with fused_train: a straight 3-epoch fit with a sweep and a
              background checkpoint each epoch; 2 epochs in a second
              trainer, restored by a third that fits 1 more; a fourth
              straight run for the run-to-run spread.  Gates: the epoch-3
              mean loss below epoch 1's; the resumed run's step count,
              epoch, LR and per-step qids those of the straight run, its
              params within twice the spread of two straight runs (equal
              where the spread is 0); the sweep's n_hops + 2 OE and MC
              files of 166 unique qids each; the sweep's OE answers agree
              with the plain float32 predict on the card on > 0.97; a sync
              and a background save byte-identical; a restore bit-identical
              on the card; the path's kernels launched.  Readings: epoch
              seconds, trained q/s of the loop beside the bare step's, the
              epoch's idle share, runtime synchronisations and copies a step
              in the loop beside the bare step's, sweep ms and q/s, save,
              restore, snapshot MB, peak device memory of an epoch and of
              the sweep, the phase's seconds;
9. serve    — the HTTP service (``rau_vqa_tpu_torch.serve``) on 127.0.0.1, a
              free port, max_batch 16, max_wait_ms 5, buckets 8 and 16:
              ``ours_ms`` at full width from a ``.pt`` snapshot of seeded
              weights, on the trainer phase's fixture, its features packed
              by ``pack_feature_dir`` into a float32 shard.  Gates: /healthz
              ok; 64 sequential and 32 x 8 concurrent /answer requests
              (distinct question/feature pairs) all 200, each answer's
              top-5 scores within the serving bars (rtol 0.05, atol 0.02)
              of the plain float32 predict on the card and top-1 agreement
              > 0.95, 8 per-hop answers; /stats counts every request, the
              concurrent part ran fewer dispatches than requests, max batch
              in [2, 16]; each dispatch launched the encoder and hop kernels
              once; /answer_many of 3 questions matches the single calls
              with one feature fetch; attention rows sum to 1; 400 for an
              unknown feature, 404 for an unknown path.  Then the
              ``ours_resnet`` head with the pixels phase's bf16 ResNet-101:
              one 448 px PNG (written with zlib) sent 3 times at once as
              image_b64 runs the backbone once (4 stage-kernel launches)
              and answers as ``answer_pixels``: the same select answers,
              the top-5 scores within the serving bars of its select row
              and nearer to it than a tenth of a wrong feature path's row
              (the other image, feat_norm flipped).  Readings: unloaded
              p50/p99 beside the bare step at B=1, saturated q/s, p99 and
              mean micro-batch, a device-cache miss against a hit, an image
              miss against a hit, the native packed store against the
              Python one over an epoch of B=100 batches, the phase's
              seconds;
10. backbones — the flagship heads from pixels: ``lstm_encode`` and
              ``rau_hops`` against their plain versions at ``ours_vit``
              widths (S 256, D 1024) at B in {1, 19, 64}, at the serving
              bars, two calls bit-equal, the hop plan the launcher's dry
              run; ``answer_pixels`` for ``ours_ms`` through a bf16 VGG16
              (He init x0.72 a convolution) on 448 px images at B in {1, 8,
              64} and for ``ours_vit`` through a bf16 ViT-L/14 at 224 px at
              B in {1, 64}, gated as the pixels phase against
              ``pixels_forward`` with bf16's own effect measured against the
              float32 tree (8 images at a time, TF32 off), one launch of each
              head kernel a call and none of the stage kernel; readings of
              each call, the backbone and the head alone beside the
              backbone's bound, the idle share and peak memory at B=64;
              ``precompute_features`` over 300 distinct 448 px PNGs at B=64
              into a float32 shard (each row ``extract_features``' at the
              same batch size to 1e-5 of the RMS) and an int8 one (bit for
              bit the host writer's quantization), with the sweep's, the
              backbone's and the decode's images/s and the decoder that ran;
              the ``Trainer`` one epoch from the paper-dims fixture's 448 px
              JPEGs through the frozen VGG16 and one from a shard of them
              (first-step losses within 5e-3, sweep answers >= 0.99 alike,
              trained q/s); ``RAUService(backbone="vgg16")`` answering three
              PNGs by ``image_b64`` as by ``feat_name`` on the float32 shard;
11. finetune — backbone fine-tuning (under a 300 s watchdog): the
              ``ours_resnet_ft`` preset as shipped (bf16, unfused, no remat,
              'imggroup' groups of 3: B=288 on 96 unique 448 px images, a
              random folded ResNet-101, the RMS interface, Zipf labels) for
              10 steps: every loss finite, the loss falls, grad_norm_backbone
              > 0, every backbone leaf moves, the first loss within 5% of the
              plain float32 step's; readings: step ms, trained q/s, idle
              share, device kernels a step, peak memory with remat off and
              on, and step 1's backbone grads with remat against without
              (norm-relative 1e-3); ``ours_ms`` fused through VGG16 at B=96
              (32 unique 448 px images): the backward kernel with the
              features' gradient against its plain version (norm-relative
              1e-3 per output, two calls bit-equal), its bf16 instantiation at
              the backward's bf16 bars, both timed beside their bounds, and
              the fine-tuning step 4 times in float32 and 3 in bf16, each
              launching its dfeats backward and never the other; the
              ``Trainer`` one fine-tuning epoch from the paper-dims fixture's
              448 px JPEGs through VGG16 in the 'imggroup' order, its sweep
              with the trained backbone, a snapshot that resumes to the same
              bits, and ``RAUService`` serving it through its own backbone as
              ``answer_pixels`` answers;
12. workflow — the paper's workflow through ``rau_vqa_tpu_torch.cli``'s
              ``main`` (under a 600 s watchdog): fabricated official VQA v1
              JSONs (two train2014 sources, ~6,000 questions on 300 images
              over 12,604 words, Zipf-like answers over 1,100 strings;
              val2014's 830 questions on 100 images with 10 raters, types
              and 18 MultipleChoice candidates) and .t7 14x14x512 features;
              ``prepro`` (the bundle written by data/hdf5.py: vocab 12,605
              with UNK, 1000 answers, rows dropped, the h5 read back equal
              to what was written), ``pack-features`` (each image's
              datatype read from the bundle, its rows its own source's),
              ``train --preset ours_ms`` as shipped for 2 epochs from the
              bundle and the shard with ``--visatt --visatt-batches 1``
              (the loss finite and falling, (nHop+2) x 83 224x224
              grayscale PNGs an epoch, the OE and MC files), the sweep's ms
              with and without the dumps, ``vqa-accuracy`` on hop 1's OE
              file equal to 100 x the Trainer's testOEaccOfficial[0] within
              1e-9, released-format tarballs of the last snapshot:
              ``verify-released`` exits 0 at min_agree 1.0 and 1 where
              mult's att_q and att_i trade places, ``diagnose-snapshot``
              (against the run's .pt) finds every group's order on the
              first and names the pair on the second; the fixture-learning
              gate (the tiny fixture on disk, 30 epochs, the sweep through
              the plain predict: the encoder kernel needs rnn_size in
              multiples of 32) in float32, bf16, fused float32 and fused
              bf16, each best OE > 0.5; each step's
              seconds, prepro's questions/s, the bundle's bytes and read
              time, the phase's seconds;
13. export_bench — export, the benches and the rig tools through the
              user's entry points (under a 400 s watchdog): ``export`` of a
              full-width ``ours_ms`` ``.pt`` snapshot with ladder 8/16/26
              (the serving kernels as the ``rau_vqa::`` custom ops in
              ``torch.export`` programs), loaded and run at B in {1, 83,
              512}, one bucket each: per-hop answers equal to
              ``PredictStep``'s and scores within the service's bar (rtol
              1e-3, atol 1e-4), the encoder's and the hop loop's launches
              rising by one a call; an ``ours_resnet`` pixels artifact (a
              folded bf16 ResNet-101 from the seed baked in, 448 px) at B=7
              against ``answer_pixels``: the same answers, attention within
              the bar, 4 stage launches a call; the two benches at their
              defaults, live and from an ``--artifact``, their JSON lines
              printed, each with ``mfu``, ``device``, ``power_limit_w`` and
              the canary; the bench's q/s at B=512 within 15% of this
              phase's own ``PredictStep`` timing; ``profile`` of 3 fused
              float32 train steps (whether ``key_averages()`` shows device
              time and the trace names the training kernels' phases);
              ``doctor --canary`` healthy, the canary beside the 989 TFLOP/s
              peak and the power limit; the phase's seconds.

14. mesh    — ``parallel/mesh.py`` (under a 400 s watchdog): (a) a world of
              1 on NCCL: ``make_sharded_train_step`` on mesh (1, 1), fused
              float32, B=100, 3 steps with the preset's dropout and noise,
              bit for bit ``make_train_step``'s (loss and every parameter),
              ``make_sharded_predict`` at B=512 equal to ``PredictStep``;
              the training kernels at row0 = 50 on rows 50-99 against
              their plain versions and the whole batch's rows;
              (b) 2 ranks of this script on the one card over gloo against
              one process on the same inputs: DP (2, 1) fused float32 and
              the unfused preset, TP (1, 2) fused (cls.w (M, A / 2) a
              rank), 3 steps at B=100, the last loss within rtol 2e-4 and
              cls.w within rtol 2e-4 / atol 2e-5; sharded predict at B=512
              and sharded ``answer_pixels`` for ``ours_resnet`` at B=120,
              448 px (the stage kernel 4 times a rank): scores within the
              serving bars, and the answers one process's but where its two
              leading scores lie within twice the row's score difference
              (the ranks' smaller batches round bf16 sums apart);
              (c) ``train --mesh-data 2`` on the fixture and
              ``precompute-features --mesh-data 2`` under ``python -m
              torch.distributed.run`` against one process (steps, head bias
              within 1e-4 / 1e-6, the sweep's OE; the shard byte for byte
              at the same rows a device); (d) the 2-rank step's ms beside
              one process's, one all-reduce of the gradient's size over
              NCCL at world 1 and over gloo on 2 ranks.

15. variants — the image transforms, the space-to-depth stem and the int8
              ResNet-101 (under a 300 s watchdog): (a) 120 uint8 480x640
              images scaled to [0, 1]: the eval chain (``scale_shorter_side``
              then ``center_crop`` to 448), the training chain
              (``random_sized_crop(448)``, ``color_jitter(0.4, 0.4, 0.4)``,
              ``lighting(0.1)``, ``horizontal_flip``), ``rotation(10)``,
              ``random_scale_crop(448, 512, 448)`` and ``ten_crop(448)`` at
              B=16, each against the same apply on a CPU copy of its first 8
              rows with those rows' draws within 1e-4 (TF32 off), with its
              ms; (b) ``answer_pixels`` for ``ours_resnet`` at B=120 on the
              s2d tree of the pixels phase's bf16 ResNet-101 (4 stage
              launches) at the pixels phase's bf16 gates against the 7x7
              tree, the stem alone in float32 against conv1 at rtol 1e-4 /
              atol 1e-5, both stems' ms; (c) int8: each conv shape class at
              448-px shapes, B=2, its int32 accumulators bit-equal to the
              CPU's; the JAX test's shrunk net (one block a stage, 64 px)
              against float32 at corr > 0.995 and rel < 0.1; the full
              ResNet-101 at B=120 (corr, rel, ms beside the bf16 and float32
              folded trees, peak memory: readings); (d)
              ``bench_torch_pixels.py --s2d`` and ``--int8`` (``--chain 2
              --rounds 2``), each its JSON line and exit 0.

16. scripts — the measurement and experiment scripts
              (``rau_vqa_tpu_torch/scripts/``, under a 900 s watchdog), each
              a subprocess as a user runs it (``python -m ...``, the card's
              own): ``bench_train`` at B=100 (3 steps, 1 warm and 2 timed
              rounds) with ``plain,remat,fused,trunc16,accum2,maskref`` in
              float32 and ``plain,remat,fused`` in bf16, and ``pixels`` and
              ``finetunegrp`` on ``ours_resnet`` at B=48, qpi 3;
              ``bench_serve`` (8 clients x 5 requests, 10 unloaded);
              ``bench_precompute`` (VGG16, 64 images); ``probe_serving_batch``
              (B 512 and 2048, K=3); ``profile_vit`` (B=8); ``paper_dims_run``
              ``generate`` and 2 epochs of ``train``; ``ft_accuracy_ab``
              (2 epochs); three lanes of them at once (the training
              bench; the serving and backbone scripts; the experiments), so
              their times are readings under contention.  Gates: each exits 0 (``paper_dims_run train`` 1
              where its criterion is unmet, as its contract says), its last
              line has its ``metric``, a value > 0 (``ft_ab_gap``: a value,
              and the fine-tuned arm's backbone gradient alive), no
              ``error``, and names the card; each fused variant launched its
              type's forward and backward kernels once a warm and a timed
              step, no unfused variant any; the serving scripts launched
              both serving kernels.  Each line is printed; the ``kernels``
              line's ``scripts_launches`` are the lines' ``launches``.

Prints each number beside the card's name and power limit, a ``kernels``
JSON line (the hop kernel's and the training kernels' entries also give
their device kernels a call, as recorded), and as the last line
``{"ok": true, "device": {...}}``.  Weights
are random, from the seed.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from rau_vqa_tpu_torch.utils.flops import (  # noqa: E402 (the one count)
    H100_BF16_FLOPS,
    H100_BYTES_PER_S,
    H100_F32_FLOPS,
    H100_INT32_OPS,
    bound,
    hops_bound,
    lstm_bound,
    nbytes,
    stage_bound,
    train_hop_flops,
    vgg_flops,
    vit_flops,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 3):
    """Per call of ``fn`` under torch.profiler: (the sum of the device's
    kernel times in ms, [(kernel name, ms)] largest first, {kernel name: the
    op that launched most of its time, with two of its callers}, the number
    of device kernels and copies a call ran, [(host op, its own host ms,
    calls)] largest first).  The sum is 0 where the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name, n_kernels, host = {}, 0, []
    for e in prof.key_averages():
        # the device's own rows (kernels, copies); CPU-op rows repeat them
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
            n_kernels += e.count
        elif e.device_type == DeviceType.CPU:
            host.append((e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    # each CPU op lists the device kernels it launched
    launched = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        chain, up = [e.name], e.cpu_parent
        while up is not None and len(chain) < 3:
            chain.append(up.name)
            up = up.cpu_parent
        for k in e.kernels:
            per_op = launched.setdefault(k.name, {})
            per_op[" < ".join(chain)] = per_op.get(" < ".join(chain), 0.0) + k.duration
    ops = {k: max(v, key=v.get) for k, v in launched.items()}
    return sum(by_name.values()), top, ops, n_kernels / iters, sorted(host, key=lambda r: -r[1])


# the CUDA runtime's and driver's kernel launches, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel")


def device_kernels(fn, want: int, what: str, card: str, calls: int = 3) -> int:
    """Holds each of ``calls`` calls of ``fn``, each profiled alone, to
    ``want`` device kernels: torch.profiler's kernel records of the call
    (memsets and copies not counted) must be ``want``, or, where they fall
    short, the same profile's host-side launch records must be ``want``:
    then the call made every launch and the profiler lost device records.
    Logs every call's two counts; returns the most kernels recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        counts.append((
            sum(1 for e in events if e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memset", "Memcpy"))),
            sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith(LAUNCH_CALLS))))
    log(f"{what}: device kernels recorded a call {[d for d, _ in counts]}, host launch "
        f"records {[n for _, n in counts]}, the plan's {want} [{card}]")
    for n_dev, n_launch in counts:
        if n_dev != want and not (n_dev < want and n_launch == want):
            raise SystemExit(f"{what}: {n_dev} device kernels and {n_launch} launches "
                             f"recorded in a call, not the plan's {want}")
    return max(d for d, _ in counts)


def fwd_bit_equal(rth, got, *args) -> bool:
    """Whether a second call of the training forward on the same inputs
    gives the bits of ``got`` in every output."""
    again = rth.train_hops_fwd(*args)
    torch.cuda.synchronize()
    return all(torch.equal(g, a) for g, a in zip(got, again))


def bwd_bit_equal(rth, *args) -> bool:
    """Whether two calls of the training backward on the same inputs give
    the same bits in every emission and feats-path grad."""
    em, gw = rth.train_hops_bwd(*args)
    em2, gw2 = rth.train_hops_bwd(*args)
    torch.cuda.synchronize()
    return (all(torch.equal(em[k], em2[k]) for k in em)
            and all(torch.equal(gw[k], gw2[k]) for k in gw))


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Ends the process with a message if the block takes longer than
    ``seconds``: a kernel that hangs must fail the run, never stall it."""
    def fire():
        print(f"chip_smoke: watchdog: {what} did not finish in {seconds:.0f} s", flush=True)
        print(f"chip_smoke: watchdog: {what} did not finish in {seconds:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(3)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def make_batch(cfg, B, max_len, rs, dev):
    lengths = rs.randint(1, max_len + 1, B).astype(np.int32)
    lengths[0] = max_len
    tokens = np.zeros((B, cfg.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    feats = np.abs(rs.randn(B, cfg.cnn_spat, cfg.cnn_dim)).astype(np.float32)
    return (torch.as_tensor(tokens, device=dev), torch.as_tensor(lengths, device=dev),
            torch.as_tensor(feats, device=dev))


def _operand_size_and_peak(dtype):
    """Bytes an operand of the training kernels takes, and the peak rate of
    their products: float32 FMA, or bf16 on the tensor cores."""
    if dtype == torch.bfloat16:
        return 2, H100_BF16_FLOPS
    return 4, H100_F32_FLOPS


def train_fwd_bound(cfg, mp, B, dtype=torch.float32):
    """Least time for the training hop loop's forward: q, feats (in the
    products' type ``dtype``) and the weights ``mp`` read once, the five
    float32 outputs written once; the products at ``dtype``'s peak."""
    Q, S, Dc, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim,
                         cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    e, peak = _operand_size_and_peak(dtype)
    n_bytes = ((B * Q + B * S * Dc) * e + (H * B * (A + 1 + S) + 2 * (H + 1) * B * R) * 4
               + nbytes(mp))
    return bound(n_bytes, B * H * train_hop_flops(cfg)[0], peak)


def train_bwd_bound(cfg, mp, B, dtype=torch.float32, dfeats=False):
    """Least time for the backward kernel's work: q, feats (in ``dtype``),
    the carries, gmerge and the weights read once; its emissions (float32
    cotangents, qfeat / join / merge_d in ``dtype``) and the summed
    feats-path grads written once; the hop's remat (without the classifier)
    plus its backward at ``dtype``'s peak; with ``dfeats`` also the
    features' gradient, written once, and its product a hop."""
    Q, S, Dc, M, F, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim,
                               cfg.attfeat_dim, cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    e, peak = _operand_size_and_peak(dtype)
    cotangents = 3 * M + F + S + 4 * R
    n_bytes = ((B * Q + B * S * Dc) * e + H * B * 3 * M * e
               + (2 * (H + 1) * B * R + H * B * M + H * B * cotangents
                  + Dc * M + M + M * F + 2 * F) * 4 + nbytes(mp))
    fwd, bwd = train_hop_flops(cfg)
    n_ops = B * H * (fwd - 2 * (M * A + M) + bwd)
    if dfeats:
        n_bytes += B * S * Dc * 4
        n_ops += B * H * 2 * S * Dc * M
    return bound(n_bytes, n_ops, peak)


def phase_kernel_label(line: str) -> str:
    """A short name for a phase kernel of the training forward or backward,
    or of the serving hop loop, from the mangled name in ptxas's "Compiling
    entry" line: the tile GEMM's body, tile (BM x BN x BK, ring depth) and
    operand layouts (k: k-contiguous, r: row-contiguous), or the other
    kernel and its type."""
    m = re.search(r"gemm_(fma|mma)INS_\d+(?:Fma|Mma)CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                  r".*?ELb([01])ELb([01])E", line)
    if m:
        body, bm, bn, bk, st, a, b = m.groups()
        operands = " bf16 operands" if body == "fma" and "nv_bfloat16" in line else ""
        return (f"gemm_{body} {bm}x{bn}x{bk} ring {st} A {'k' if a == '1' else 'r'} "
                f"B {'k' if b == '1' else 'r'}{operands}")
    k = re.search(r"(prep|rows_fwd|rows_eval|softmax_bwd|dpre_add|cell_bwd|cell|colsum|reduce)"
                  r"_kernel", line)
    kind = " bf16" if "nv_bfloat16" in line else (" float32" if "IfE" in line else "")
    return (k.group(1) if k else "kernel") + kind


def norm_rel(got, want) -> float:
    """|got - want| / |want|; where want is all zeros, 0 if got is too and
    inf if not."""
    diff, ref = (got.float() - want.float()).norm().item(), want.float().norm().item()
    if ref == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return diff / ref


# The bf16 training kernels' bars at one hop, norm-relative against their
# bf16 plain versions on the same inputs (train_bf16_readings): 2-3x the
# largest reading of the sound kernels at B in {19, 100} (PERF.md, §6),
# each under half the float32 plain version's distance (4.7e-4 for
# do_pred, 1.7e-3 for the scores, 1.9e-3 to 4.5e-3 for the grads).  Both
# sides round the same operands to bf16 and differ in the order of their
# float32 sums, which now and then flips a rounding; each flip moves what
# follows it, so the readings grow with the depth.  Backward: by leaf, then
# the weights' grads and dq, then the biases'.
TRAIN_BF16_BARS = {
    "fwd": {"scores": 7.5e-4, "do_pred": 2e-4, "attprob": 2.5e-4, "c_all": 2.5e-4,
            "h_all": 2.5e-4},
    "bwd": {"i_embed/w": 2.5e-4, "weights": 9e-4, "biases": 2.5e-4},
}


def train_bf16_bar(kind: str, name: str) -> float:
    bars = TRAIN_BF16_BARS[kind]
    if name in bars:
        return bars[name]
    return bars["biases" if name.rsplit("/", 1)[-1] in ("b", "bi", "bh") else "weights"]


def train_bf16_deep_bar(r) -> float:
    """The bf16 training kernels' bar at eight hops for one output or grad
    leaf's readings ``r`` (train_bf16_readings with ``host``): twice the
    plain version's own drift on the host CPU, and under 3/4 of the float32
    plain version's distance, where a kernel that skips the rounding lands."""
    return min(2 * r["host"], 0.75 * r["float32"])


def train_bf16_readings(rth, cfg, mp, B, rs, dev, host=False, dfeats=False):
    """The bf16 training kernels against their bf16 plain versions on one
    batch of B rows (``cfg``: fused, bf16): {"fwd": {output: r}, "bwd":
    {grad leaf: r}}, where r holds the norm-relative distance from the bf16
    plain version (on the card) of the kernel, of the float32 plain version
    on the same bf16-valued inputs and, with ``host``, of the bf16 plain
    version run on the host CPU (the same arithmetic summed in another
    order).  The backward's leaves are its feats-path grads and the outside
    products over its emissions, on the kernel forward's carries, with the
    cotangent of a per-hop cross-entropy, and with ``dfeats`` the features'
    gradient ("feats"); att_score b's grad, zero in exact arithmetic, is
    held to an absolute 1e-5 here instead."""
    from rau_vqa_tpu_torch.convert import map_tree
    bf16 = torch.bfloat16
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    H, A, Q = cfg.n_hops, cfg.answer_size, cfg.rnnout_dim
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    mp32 = map_tree(lambda w: w.float(), mp16)
    feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2].to(bf16)
    q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev).to(bf16)
    seed = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    labels = torch.as_tensor(rs.randint(0, A, B), device=dev)
    hop_w = torch.tensor([1.0 + 0.5 * h for h in range(H)], device=dev)
    cpu = torch.device("cpu")

    def on(device, *xs):
        return [map_tree(lambda t: t.to(device), x) if isinstance(x, dict) else x.to(device)
                for x in xs]

    fwd_runs = {"kernel": (rth.train_hops_fwd, cfg, dev, mp16, q, feats),
                "plain": (rth.train_hops_fwd_reference, cfg, dev, mp16, q, feats),
                "float32": (rth.train_hops_fwd_reference, cfg32, dev, mp32, q.float(),
                            feats.float())}
    if host:
        fwd_runs["host"] = (rth.train_hops_fwd_reference, cfg, cpu, mp16, q, feats)
    outs = {}
    for k, (fn, c, d, mp_, q_, feats_) in fwd_runs.items():
        mp_, q_, feats_, seed_ = on(d, mp_, q_, feats_, seed)
        outs[k] = on(dev, *fn(mp_, c, q_, feats_, seed_))
    names = ("scores", "do_pred", "attprob", "c_all", "h_all")
    fwd = {n: {k: norm_rel(v[i], outs["plain"][i]) for k, v in outs.items() if k != "plain"}
           for i, n in enumerate(names)}

    _, _, attprob, c_all, h_all = outs["kernel"]
    s_ = outs["kernel"][0].detach().requires_grad_()
    ce = torch.nn.functional.cross_entropy(
        s_.reshape(-1, A), labels.repeat(H), reduction="none").reshape(H, B).mean(1)
    g_scores, = torch.autograd.grad((hop_w * ce).sum(), s_)

    def hand_grads(bwd, c, d, mp_, q_, feats_):
        mp_, q_, feats_, seed_, c_, h_, p_, g_ = on(d, mp_, q_, feats_, seed, c_all, h_all,
                                                    attprob, g_scores)
        dd = rth.dot_dtype(c)
        gmerge = (rth._rnd(g_.reshape(H * B, -1), dd)
                  @ rth._rnd(mp_["cls"]["w"], dd).T).reshape(H, B, -1)
        em, gw_in = bwd(mp_, c, q_, feats_, seed_, c_, h_, gmerge.contiguous(), dfeats)
        gw_out, dq = rth._outside_grads(c, mp_, q_, seed_, h_, p_, g_, em)
        grads = {p: (gw_in[p] if p in gw_in else gw_out[p]) for p in rth._DIFF_WEIGHTS}
        if dfeats:
            grads["feats"] = gw_in[rth.DFEATS]
        return {**on(dev, grads)[0], "dq": dq.to(dev)}

    grads = {"kernel": hand_grads(rth.train_hops_bwd, cfg, dev, mp16, q, feats),
             "plain": hand_grads(rth.train_hops_bwd_reference, cfg, dev, mp16, q, feats),
             "float32": hand_grads(rth.train_hops_bwd_reference, cfg32, dev, mp32,
                                   q.float(), feats.float())}
    if host:
        grads["host"] = hand_grads(rth.train_hops_bwd_reference, cfg, cpu, mp16, q, feats)
    torch.cuda.synchronize()
    bwd = {}
    for path in grads["plain"]:
        name = path if isinstance(path, str) else "/".join(map(str, path))
        if path == ("att_score", "b"):
            noise = max(v[path].abs().max().item() for v in grads.values())
            if noise > 1e-5:
                raise SystemExit(f"train_hops_bwd_bf16: att_score b grad {noise:.3e} > 1e-5")
            continue
        bwd[name] = {k: norm_rel(v[path], grads["plain"][path])
                     for k, v in grads.items() if k != "plain"}
    return {"fwd": fwd, "bwd": bwd}


def old_stage_weight_bytes(B, H, W, C, Cw, N):
    """L2 weight bytes a call of the mma.sync stage kernel read: each CTA of
    its 8x8 tiling (4x14 where that divides W and 8x8 does not) read every
    weight of a block."""
    th, tw = (4, 14) if W % 8 and W % 14 == 0 else (8, 8)
    return -(-H // th) * -(-W // tw) * B * N * 2 * (2 * C * Cw + 9 * Cw * Cw)


def mask_bound(shape):
    """Least time for one mask: the float32 mask written once; ~16 integer
    operations an element (the index, the multiply-xor and fmix32, the
    compare and select)."""
    n = int(np.prod(shape))
    t_bytes = n * 4 / H100_BYTES_PER_S * 1e3
    t_ops = 16 * n / H100_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_stack(N, C, Cw, dtype, gen, dev, bias_mean=0.0):
    """A random stacked identity run: He-normal weights, biases of std 0.1
    around ``bias_mean``."""
    def r(*shape, std, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(dtype)
    return {"w1": r(N, C, Cw, std=(2 / C) ** .5), "b1": r(N, 1, Cw, std=.1, mean=bias_mean),
            "w2": r(N, 9, Cw, Cw, std=(2 / (9 * Cw)) ** .5),
            "b2": r(N, 1, Cw, std=.1, mean=bias_mean),
            "w3": r(N, Cw, C, std=(2 / Cw) ** .5), "b3": r(N, 1, C, std=.1, mean=bias_mean)}


def stage_faults(plain, x, stack):
    """The plain stage with the classic faults of a stage kernel: the 3x3's
    border taken as relu(b1) instead of 0 (each block run over x padded with
    a zero pixel, whose y1 is relu(b1), then cropped), b2 dropped, b3
    dropped."""
    halo = x
    for n in range(stack["w1"].shape[0]):
        one = {k: v[n:n + 1] for k, v in stack.items()}
        halo = plain(torch.nn.functional.pad(halo, (0, 0, 1, 1, 1, 1)), one)[:, 1:-1, 1:-1]
    return {"relu(b1) halo": halo,
            "b2 dropped": plain(x, {**stack, "b2": torch.zeros_like(stack["b2"])}),
            "b3 dropped": plain(x, {**stack, "b3": torch.zeros_like(stack["b3"])})}


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|: the stage's activations grow across
    its residual blocks at random init, so errors are held to their scale."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def stage_bar(N: int) -> float:
    """The bf16 stage kernel's bar on ``scaled_err``: ~3x the largest reading
    of the sound kernel against its plain version (PERF.md, PR 3: 4.1-5.4e-3
    over runs of 2-3 blocks, 1.6e-2 over stage 2's 22, where bf16 rounding
    flips compound).  The JAX package's 0.1 (tests/test_fused_resnet.py:70-72)
    is ~20x the readings and passes a wrong kernel."""
    return 5e-2 if N > 3 else 2e-2


def torch_lstm_from(cfg, rnn, dev):
    """torch.nn.LSTM holding the encoder's weights, gates permuted from the
    DeepLSTM's [i, f, o | g] to PyTorch's [i, f, g, o]; a yardstick only."""
    R = cfg.rnn_size
    lstm = torch.nn.LSTM(cfg.embed_dim, R, cfg.rnn_layers, batch_first=True).to(dev)

    def perm(x):   # last axis [i, f, o, g] -> [i, f, g, o]
        return torch.cat([x[..., :2 * R], x[..., 3 * R:], x[..., 2 * R:3 * R]], -1)

    with torch.no_grad():
        for L, lp in enumerate(rnn["layers"]):
            getattr(lstm, f"weight_ih_l{L}").copy_(perm(lp["wi"]).T)
            getattr(lstm, f"weight_hh_l{L}").copy_(perm(lp["wh"]).T)
            getattr(lstm, f"bias_ih_l{L}").copy_(perm(lp["bi"]))
            getattr(lstm, f"bias_hh_l{L}").copy_(perm(lp["bh"]))
    return lstm


def runtime_calls(averages) -> dict:
    """The CUDA runtime's synchronisations and copies in a profile's
    ``key_averages()``, by name."""
    from torch.autograd import DeviceType
    return {e.key: e.count for e in averages
            if e.device_type == DeviceType.CPU
            and e.key.startswith(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                  "cudaEventSynchronize", "cudaMemcpy"))}


def device_busy_ms(averages) -> float:
    """The device's kernel and copy time in a profile's ``key_averages()``."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def trainer_phase(seed: int, card: str) -> dict:
    """Phase 8: ``Trainer`` fits, sweeps, saves, restores and resumes
    ``ours_ms`` at full width from the fixture's files, in the preset's
    configuration and with fused_train; returns each kernel's launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
    from rau_vqa_tpu_torch.data.features import PackedShardWriter, T7DirFeatureSource
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.train.trainer import Trainer
    from rau_vqa_tpu_torch.utils.checkpoint import (
        flush_checkpoint_writes, latest_checkpoint)

    counters = {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
                "train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL}
    total = {k: 0 for k in counters}
    # the JAX package's paper-dims fixture (scripts/paper_dims_run.py:55-63)
    spec = FixtureSpec(n_train=1000, n_test=166, n_images=100, n_words=12604,
                       n_answers=1000, seq_len=26, feat_dim=512, feat_w=14,
                       feat_h=14, n_mc=4, seed=11 + seed, n_img_classes=10,
                       class_code="dense")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as root:
        t0 = time.perf_counter()
        bundle = fixture_bundle(root, spec)
        feat_mb = sum(os.path.getsize(os.path.join(bundle.feat_dir, f))
                      for f in os.listdir(bundle.feat_dir)) / 1e6
        log(f"trainer fixture: {spec.n_train} train / {spec.n_test} test questions, "
            f"{2 * spec.n_images} .t7 feature files ({feat_mb:.1f} MB), made in "
            f"{time.perf_counter() - t0:.2f} s")
        gt = {int(k): v for k, v in bundle.gt.items()}

        def make(name, model, qids=None, source=None):
            exp = get_experiment("ours_ms")
            exp = exp.replace(model=dataclasses.replace(exp.model, **model),
                              data=dataclasses.replace(exp.data, split="val2014",
                                                       test_batch_size=83))
            data = build_vqa_data(bundle.info, bundle.arrays, exp.train.batch_size,
                                  split="val2014", test_batch_size=83,
                                  seed=exp.train.seed)
            src = source or T7DirFeatureSource([bundle.feat_dir], spec.feat_dim,
                                               spec.feat_w, spec.feat_h)
            tr = Trainer(exp, data, src, os.path.join(root, name), gt_anno=gt)
            if qids is not None:    # each train batch's qids, as the loop puts it
                put = tr._put_batch

                def spy(batch, **kw):
                    if batch.labels is not None:
                        qids.append(batch.qids.copy())
                    return put(batch, **kw)
                tr._put_batch = spy
            return tr

        def flat(tr):
            return torch.cat([x.reshape(-1).float() for x in tree_leaves(tr.state.params)])

        for name, model in (("preset", {}), ("fused", {"fused_train": True})):
            for k in counters.values():
                k.launches = 0
            qa, qb = [], []
            # 1. straight: 3 epochs, a sweep and a background save each
            t_cfg = time.perf_counter()
            a = make(f"{name}_a", model, qa)
            # peaks above what the earlier phases still hold
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a.fit(epochs=3)
            fit_peak = (torch.cuda.max_memory_allocated() - held) / 1e6
            recs = a.logger.read("train")
            B = a.tcfg.batch_size
            log(f"trainer {name}: epoch losses " + " ".join(
                f"{r['loss']:.4f}" for r in recs) + "; epoch s " + " ".join(
                f"{r['sec']:.3f}" for r in recs) + "; trained q/s " + " ".join(
                f"{r['examples_per_sec']:.1f}" for r in recs) + f" B={B} [{card}]")
            if not recs[2]["loss"] < recs[0]["loss"]:
                raise SystemExit(f"trainer {name}: the epoch-3 loss {recs[2]['loss']} is "
                                 f"not below epoch 1's {recs[0]['loss']}")
            # 2. 2 epochs, then a restore of their snapshot and 1 more
            b = make(f"{name}_b", model, qb)
            b.fit(epochs=2)
            c = make(f"{name}_c", model, qb)
            c.restore(latest_checkpoint(b.ckpt_dir))
            c.fit(epochs=1)
            if (c.state.step, c.epoch, c.lr, c.mult_lr) != \
                    (a.state.step, a.epoch, a.lr, a.mult_lr):
                raise SystemExit(f"trainer {name}: resumed step/epoch/lr "
                                 f"{(c.state.step, c.epoch, c.lr, c.mult_lr)} vs straight "
                                 f"{(a.state.step, a.epoch, a.lr, a.mult_lr)}")
            if len(qa) != 30 or len(qb) != 30 or any(
                    not np.array_equal(x, y) for x, y in zip(qa, qb)):
                raise SystemExit(f"trainer {name}: the resumed run's per-step qids "
                                 f"differ from the straight run's")
            # 3. a second straight run for the spread, its third epoch profiled
            d = make(f"{name}_d", model)
            d.fit(epochs=2, eval_each=False)
            log(f"trainer {name}: four fits took {time.perf_counter() - t_cfg:.1f} s")
            torch.cuda.synchronize()
            held_d = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            # the profiler records steps 4-7 of the epoch (steady state; reading
            # a whole epoch's events back takes ~25 s): their runtime calls and
            # device time, over the host's time between those step boundaries
            step, marks = d.train_step, []
            window = 4
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(
                             wait=2, warmup=1, active=window, repeat=1)) as prof:
                def stepping(*a):
                    out = step(*a)
                    marks.append(time.perf_counter())
                    prof.step()
                    return out
                d.train_step = stepping
                rec_d = d.train_epoch()
                torch.cuda.synchronize()
            d.train_step = step
            window_ms = (marks[3 + window - 1] - marks[3 - 1]) * 1e3
            epoch_peak = (torch.cuda.max_memory_allocated() - held_d) / 1e6
            # the main path ends here: the bare step below is a yardstick
            launched = {k: c.launches for k, c in counters.items()}
            t_read = time.perf_counter()
            averages = prof.key_averages()
            loop_calls = runtime_calls(averages)
            busy = device_busy_ms(averages)
            log(f"trainer {name}: reading the profile of {window} steps took "
                f"{time.perf_counter() - t_read:.1f} s")
            spread = (flat(a) - flat(d)).norm().item()
            dist = (flat(a) - flat(c)).norm().item()
            log(f"trainer {name}: resumed vs straight params {dist:.6e} (L2; max |diff| "
                f"{(flat(a) - flat(c)).abs().max().item():.3e}), two straight runs "
                f"{spread:.6e} (max |diff| {(flat(a) - flat(d)).abs().max().item():.3e}); "
                f"bar: {'equal' if spread == 0 else '2x the spread'}")
            if (spread == 0 and dist != 0) or dist > 2 * spread:
                raise SystemExit(f"trainer {name}: the resumed run's params are {dist} from "
                                 f"the straight run's, beyond the spread {spread}")
            if not model:
                # where the loop's host time goes: the loader alone over an
                # epoch of .t7 batches, and an epoch fed from a packed shard
                # (one mmap gather a batch) in place of the .t7 files
                t0 = time.perf_counter()
                n_b = sum(1 for _ in d.data.train_data.batches(
                    d.source, finish=d._pinning(d._train_ladder)))
                load_s = time.perf_counter() - t0
                names = sorted(os.listdir(bundle.feat_dir))
                w = PackedShardWriter(os.path.join(root, "packed"), len(names),
                                      spec.feat_w * spec.feat_h, spec.feat_dim)
                t7src = T7DirFeatureSource([bundle.feat_dir], spec.feat_dim,
                                           spec.feat_w, spec.feat_h)
                for i in range(0, len(names), 100):
                    w.write(i, t7src.get_batch(names[i:i + 100], [1] * 100))
                packed = make(f"{name}_packed", model, source=w.finish(names))
                packed.train_epoch()
                rec_p = packed.train_epoch()
                log(f"trainer {name}: the loader alone reads an epoch of {n_b} .t7 "
                    f"batches in {load_s:.3f} s; an epoch fed from a packed float32 "
                    f"shard takes {rec_p['sec']:.3f} s ({rec_p['examples_per_sec']:.1f} "
                    f"trained q/s) against {recs[2]['sec']:.3f} s from the .t7 files "
                    f"[{card}]")
            # the bare step on one batch of the same data, placed beforehand
            td = d.data.train_data
            batch = next(td.batches(d.source))
            dev = d._put_batch(batch)
            hs = d._hop_scale(1).cuda()
            step_args = (dev["tokens"], dev["lengths"], dev["feats"], dev["labels"], hs,
                         d.lr, d.mult_lr)
            bare_ms = time_ms(lambda: d.train_step(d.state, *step_args), iters=10)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    d.train_step(d.state, *step_args)
                torch.cuda.synchronize()
            bare_calls = runtime_calls(prof.key_averages())
            loop_s = recs[2]["sec"]
            log(f"trainer {name}: loop {recs[2]['examples_per_sec']:.1f} trained q/s "
                f"(epoch 3, {loop_s:.3f} s for {rec_d['steps']} steps) vs the bare step "
                f"{B / bare_ms * 1e3:.1f} q/s ({bare_ms:.3f} ms a step) B={B} [{card}]")
            log(f"trainer {name}: device busy {busy:.1f} ms of the {window_ms:.1f} ms "
                f"that steps 4-7 of an epoch took on the host (idle share "
                f"{1 - busy / window_ms:.3f}; that epoch, profiled, {rec_d['sec']:.3f} s) "
                f"[{card}]")
            for key in sorted(set(loop_calls) | set(bare_calls)):
                log(f"trainer {name}: {key} a step: loop "
                    f"{loop_calls.get(key, 0) / window:.2f}, bare step "
                    f"{bare_calls.get(key, 0) / 3:.2f} [{card}]")
            # the stream's and events' waits; cudaDeviceSynchronize is left
            # out: the bare steps' window ends in this script's own
            # torch.cuda.synchronize() (its count is printed above)
            syncs = ("cudaStreamSynchronize", "cudaEventSynchronize")
            added = (sum(loop_calls.get(k, 0) for k in syncs) / window
                     - sum(bare_calls.get(k, 0) for k in syncs) / 3)
            log(f"trainer {name}: synchronisations a step added by the loop "
                f"(cudaStreamSynchronize and cudaEventSynchronize): {added:.2f} [{card}]")
            log(f"trainer {name}: peak device memory above what was held before "
                f"({held / 1e6:.1f} MB): the 3-epoch fit with its sweeps and saves "
                f"{fit_peak:.1f} MB, an epoch {epoch_peak:.1f} MB (above the trainer's "
                f"{held_d / 1e6:.1f} MB) [{card}]")
            # the sweep: its files, its answers against the plain float32 path
            H2 = a.mcfg.n_hops + 2
            for task in ("OpenEnded", "MultipleChoice"):
                files = [os.path.join(dp, f) for dp, _, fs in
                         os.walk(os.path.join(a.workdir, "results")) for f in fs
                         if f"_{task}_" in f and "-3.00_" in f]
                qsets = []
                for f in files:
                    with open(f) as fh:
                        qsets.append({r["question_id"] for r in json.load(fh)})
                if len(files) != H2 or any(len(q) != spec.n_test for q in qsets):
                    raise SystemExit(f"trainer {name}: {len(files)} {task} files of "
                                     f"{[len(q) for q in qsets]} qids, expected {H2} "
                                     f"of {spec.n_test}")
            torch.cuda.synchronize()
            held_s = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            swept = a.evaluate(write_submissions=False, return_rows=True)
            torch.cuda.synchronize()
            sweep_ms = (time.perf_counter() - t0) * 1e3
            sweep_peak = (torch.cuda.max_memory_allocated() - held_s) / 1e6
            fused_step, a.predict_step = a.predict_step, a._plain_predict
            plain = a.evaluate(write_submissions=False, return_rows=True)
            a.predict_step = fused_step
            agree = np.mean([x["answer"] == y["answer"]
                             for h in range(H2)
                             for x, y in zip(swept["rows_oe"][h], plain["rows_oe"][h])])
            log(f"trainer {name}: sweep {sweep_ms:.2f} ms, "
                f"{spec.n_test / sweep_ms * 1e3:.1f} q/s ({spec.n_test} questions, "
                f"batches of 83), peak device memory {sweep_peak:.1f} MB above the "
                f"{held_s / 1e6:.1f} MB held; OE answers "
                f"agree with the plain float32 predict on {agree:.4f} (bar > 0.97); "
                f"testOEacc {max(swept['testOEacc']):.4f} best hop [{card}]")
            if not agree > 0.97:
                raise SystemExit(f"trainer {name}: the sweep agrees with predict on "
                                 f"{agree} <= 0.97")
            # saves: sync and background byte-identical; a restore bit-identical
            t0 = time.perf_counter()
            p_sync = a.save()
            save_ms = (time.perf_counter() - t0) * 1e3
            a.ckpt_dir = os.path.join(a.workdir, "snapshot_bg")
            t0 = time.perf_counter()
            p_bg = a.save(background=True)
            bg_ms = (time.perf_counter() - t0) * 1e3
            flush_checkpoint_writes()
            bg_total_ms = (time.perf_counter() - t0) * 1e3
            for suffix in (".pt", ".json"):
                with open(p_sync[:-3] + suffix, "rb") as f1, \
                        open(p_bg[:-3] + suffix, "rb") as f2:
                    if f1.read() != f2.read():
                        raise SystemExit(f"trainer {name}: sync and background "
                                         f"saves differ ({suffix})")
            e = make(f"{name}_e", model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.restore(p_sync)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            same = []
            map_tree(lambda x, y: same.append(torch.equal(x, y)),
                     (e.state.params, e.state.opt), (a.state.params, a.state.opt))
            if not all(same) or e.state.step != a.state.step:
                raise SystemExit(f"trainer {name}: the restore is not bit-identical")
            log(f"trainer {name}: save {save_ms:.1f} ms sync, background {bg_ms:.1f} ms "
                f"to return ({bg_total_ms:.1f} ms to land), restore {restore_ms:.1f} ms, "
                f"snapshot {os.path.getsize(p_sync) / 1e6:.1f} MB; the two saves "
                f"byte-identical, the restore bit-identical [{card}]")
            log(f"trainer {name}: launches in the four fits {launched}")
            want = (("lstm_encode", "rau_hops", "train_hops_fwd", "train_hops_bwd")
                    if model else ("lstm_encode", "rau_hops"))
            if any(launched[k] < 1 for k in want) or (
                    not model and launched["train_hops_fwd"] + launched["train_hops_bwd"]):
                raise SystemExit(f"trainer {name}: the path's kernels did not run as "
                                 f"expected: {launched}")
            for k in total:
                total[k] += launched[k]
            log(f"trainer {name}: {time.perf_counter() - t_cfg:.1f} s in all")
    return total


def png_bytes(pixels: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> a PNG (8-bit RGB, no row filter), written with zlib
    and struct alone."""
    import struct
    import zlib
    h, w, _ = pixels.shape
    raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def http_json(port: int, path: str, payload=None, timeout: float = 120.0):
    """(status, JSON body, ms) of one GET (``payload`` None) or POST to
    127.0.0.1:``port``, bounded by ``timeout`` seconds."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, (time.perf_counter() - t0) * 1e3


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def serve_phase(seed: int, card: str) -> dict:
    """Phase 9: the HTTP service (``rau_vqa_tpu_torch.serve``) answers
    ``ours_ms`` questions over features, and ``ours_resnet`` questions over
    an image, on the card; returns each kernel's launches in the driven
    requests (which equal the services' dispatches)."""
    import base64
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.data import native
    from rau_vqa_tpu_torch.data.features import PackedFeatureStore, pack_feature_dir
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.eval.predict import predict, predict_fused
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.serve import RAUService, serve
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
                "fused_identity_stage": fused_resnet.KERNEL}
    total = {k: 0 for k in counters}
    dispatches = [0]

    @contextlib.contextmanager
    def driven(services):
        """Counts each kernel's launches in the block (every count set to 0
        just before, read just after) and the services' dispatches."""
        for k in counters.values():
            k.launches = 0
        before = [s.stats()["dispatches"] for s in services]
        seen = {}
        yield seen
        torch.cuda.synchronize()
        seen.update({n: k.launches for n, k in counters.items()})
        seen["dispatches"] = sum(s.stats()["dispatches"] - b
                                 for s, b in zip(services, before))
        for n in total:
            total[n] += seen[n]
        dispatches[0] += seen["dispatches"]

    # the trainer phase's paper-dims fixture, in memory
    spec = FixtureSpec(n_train=1000, n_test=166, n_images=100, n_words=12604,
                       n_answers=1000, seq_len=26, feat_dim=512, feat_w=14,
                       feat_h=14, n_mc=4, seed=11 + seed, n_img_classes=10,
                       class_code="dense")
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        bundle = fixture_bundle(root, spec)
        data = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014",
                              test_batch_size=1)
        mcfg = dataclasses.replace(get_preset("ours_ms"), vocab_size=data.vocab_size,
                                   answer_size=data.answer_size, seq_len=data.seq_len)
        if (mcfg.vocab_size, mcfg.answer_size, mcfg.seq_len) != \
                (spec.n_words + 1, spec.n_answers, spec.seq_len):
            raise SystemExit(f"serve: fixture dims {mcfg}")
        state = init_train_state(mcfg, seed, device=dev)
        snap = save_checkpoint(os.path.join(root, "snap"), 0, 0.0, state._asdict(),
                               extra={"model_config": dataclasses.asdict(mcfg)})
        imgs = bundle.info["unique_img_train"] + bundle.info["unique_img_test"]
        shard = os.path.join(root, "shard")
        t0 = time.perf_counter()
        pack_feature_dir([bundle.feat_dir], imgs, [1] * len(imgs), shard,
                         spec.feat_dim, spec.feat_w, spec.feat_h)
        log(f"serve: {len(imgs)} images packed into a float32 shard in "
            f"{time.perf_counter() - t0:.2f} s")
        svc = RAUService(snap, None, [shard], data=data, max_batch=16,
                         max_wait_ms=5.0, buckets=(8, 16))
        if svc.source.__class__.__name__ != "PackedFeatureStore":
            raise SystemExit(f"serve: the shard was read by {svc.source!r}")
        server = serve(svc, port=0, host="127.0.0.1")
        port = server.server_address[1]
        srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
        srv_thread.start()
        try:
            code, body, _ = http_json(port, "/healthz")
            if (code, body) != (200, {"status": "ok"}):
                raise SystemExit(f"serve: /healthz gave {code} {body}")
            td = data.train_data
            # distinct (question, feature) pairs of the fixture, in order
            pairs = list(dict.fromkeys(
                (data.tokens_to_question(td.questions[i], td.lengths[i]), td.img_names[i])
                for i in range(td.num_examples)))
            if len(pairs) < 349:
                raise SystemExit(f"serve: {len(pairs)} distinct pairs in the fixture")
            pairs, warm = pairs[:320], pairs[320:349]
            # warm-up, as scripts/bench_serve.py: one request (the first one
            # casts the kernels' bf16 weights), then bursts of 4, 8 and 16
            with driven([svc]) as warm_launch:
                code, _, first_ms = http_json(port, "/answer", {"question": warm[0][0],
                                                                "feat_name": warm[0][1]})
                at, codes = 1, []
                for burst in (4, 8, 16):
                    with ThreadPoolExecutor(burst) as ex:
                        codes += ex.map(lambda p: http_json(
                            port, "/answer", {"question": p[0], "feat_name": p[1]})[0],
                            warm[at:at + burst])
                    at += burst
            if code != 200 or set(codes) != {200}:
                raise SystemExit(f"serve: warm-up requests failed: {code} {codes}")
            log(f"serve: the first request took {first_ms:.3f} ms; warm-up launches "
                f"{warm_launch}")
            # 2. unloaded: one request at a time
            with driven([svc]) as seq_launch:
                unloaded = [http_json(port, "/answer", {"question": q, "feat_name": f,
                                                        "topk": 5})
                            for q, f in pairs[:64]]
            # 3. saturated: 32 clients, 8 requests each, back to back
            st0 = svc.stats()

            def client(c):
                return [http_json(port, "/answer", {"question": q, "feat_name": f,
                                                    "topk": 5})
                        for q, f in pairs[64 + 8 * c: 72 + 8 * c]]
            with driven([svc]) as sat_launch:
                t0 = time.perf_counter()
                with ThreadPoolExecutor(32) as ex:
                    saturated = [r for rs in ex.map(client, range(32)) for r in rs]
                sat_s = time.perf_counter() - t0
            st1 = svc.stats()
            responses = unloaded + saturated
            bad = [(c, b) for c, b, _ in responses if c != 200]
            if bad:
                raise SystemExit(f"serve: {len(bad)} requests failed, e.g. {bad[0]}")
            # 4. each answer against the plain float32 predict on the card
            toks = np.stack([data.question_to_tokens(q, normalize=True)[0] for q, _ in pairs])
            lens = np.array([data.question_to_tokens(q, normalize=True)[1] for q, _ in pairs],
                            np.int32)
            feats = torch.as_tensor(svc.source.get_batch([f for _, f in pairs],
                                                         [1] * len(pairs)), device=dev)
            with torch.no_grad():
                ref = torch.cat([predict(svc.params, mcfg,
                                         torch.as_tensor(toks[i:i + 64], device=dev),
                                         torch.as_tensor(lens[i:i + 64], device=dev),
                                         feats[i:i + 64])[0][-1]
                                 for i in range(0, len(pairs), 64)]).cpu().numpy()
            aid = {a: i for i, a in enumerate(data.answers)}
            worst, top1 = 0.0, 0
            for (_, body, _), r in zip(responses, ref):
                got = np.array([a["score"] for a in body["answers"]])
                want = r[[aid[a["answer"]] for a in body["answers"]]]
                worst = max(worst, float((np.abs(got - want) / (0.02 + 0.05 * np.abs(want))).max()))
                top1 += aid[body["answers"][0]["answer"]] == int(r.argmax())
                if len(body["per_hop"]) != mcfg.n_hops:
                    failed.append(f"per_hop has {len(body['per_hop'])} entries")
            agree = top1 / len(responses)
            log(f"serve: {len(responses)} answers against the plain float32 predict on the "
                f"card: scores at {worst:.3f} of the bar (rtol 0.05 atol 0.02), top-1 "
                f"agreement {agree:.4f} (bar > 0.95), per_hop {mcfg.n_hops} entries each")
            if worst > 1.0 or not agree > 0.95:
                failed.append(f"answers: {worst:.3f} of the bar, top-1 {agree:.4f}")
            # 5. stats
            sat_disp = st1["dispatches"] - st0["dispatches"]
            log(f"serve: /stats {json.dumps(st1)}")
            if st1["requests_served"] != len(responses) + 29 or not sat_disp < 256 \
                    or not 2 <= st1["max_batch_seen"] <= 16:
                failed.append(f"stats: served {st1['requests_served']} of "
                              f"{len(responses) + 29}, saturated {sat_disp} dispatches for "
                              f"256 requests, max batch {st1['max_batch_seen']}")
            # 6. launches: one of each serving kernel a dispatch
            for what, seen in (("warm-up", warm_launch), ("unloaded", seq_launch),
                               ("saturated", sat_launch)):
                log(f"serve {what}: launches {seen}")
                if not seen["lstm_encode"] == seen["rau_hops"] == seen["dispatches"] > 0:
                    failed.append(f"{what} launches {seen}")
            # 7. /answer_many: 3 questions about one image, one feature fetch
            name = data.test_data.img_names[0]
            qs = [data.tokens_to_question(data.test_data.questions[i],
                                          data.test_data.lengths[i]) for i in range(3)]
            n_dev = svc.stats()["device_feat_cache_entries"]
            with driven([svc]) as many_launch:
                code, many, _ = http_json(port, "/answer_many",
                                          {"questions": qs, "feat_name": name, "topk": 5})
                singles = [http_json(port, "/answer", {"question": q, "feat_name": name,
                                                       "topk": 5})[1] for q in qs]
            grew = svc.stats()["device_feat_cache_entries"] - n_dev
            same = code == 200 and all(
                m["answers"][0]["answer"] == s["answers"][0]["answer"]
                and np.allclose([a["score"] for a in m["answers"]],
                                [a["score"] for a in s["answers"]], rtol=0.05, atol=0.02)
                for m, s in zip(many["results"], singles))
            log(f"serve: /answer_many of 3 questions: top-1 as the single calls {same}, the "
                f"device feature cache grew by {grew}; launches {many_launch}")
            if not same or grew != 1:
                failed.append(f"answer_many: same {same}, cache grew {grew}")
            # 8. attention rows
            code, body, _ = http_json(port, "/answer", {"question": qs[0], "feat_name": name,
                                                        "attention": True})
            rows = np.array(body["attention"]["rows"]) if code == 200 else np.zeros((0,))
            row_err = float(np.abs(rows.sum(1) - 1).max()) if rows.ndim == 2 else 1.0
            log(f"serve: attention {rows.shape} rows on grid {body.get('attention', {}).get('grid')}, "
                f"row sums within {row_err:.2e} of 1")
            if rows.shape != (mcfg.n_hops + 2, mcfg.cnn_spat) or row_err > 1e-3 \
                    or body["attention"]["grid"] != [mcfg.cnn_w, mcfg.cnn_h]:
                failed.append(f"attention {rows.shape}")
            # 9. errors
            c1, b1, _ = http_json(port, "/answer", {"question": qs[0],
                                                    "feat_name": "no-such-image.t7"})
            c2, _, _ = http_json(port, "/nothing")
            log(f"serve: unknown feat_name -> {c1} {b1}; unknown path -> {c2}")
            if c1 != 400 or not b1.get("error") or c2 != 404:
                failed.append(f"errors: {c1} {b1} {c2}")

            # readings: latency unloaded beside the bare step at B=1
            lat = [ms for _, _, ms in unloaded]
            step = svc.predict
            bare = []
            with torch.no_grad():
                for i in range(64):
                    f = feats[i:i + 1]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tab, _ = step(svc.params, toks[i:i + 1], lens[i:i + 1], f)
                    tab.float().cpu()
                    bare.append((time.perf_counter() - t0) * 1e3)
            sat_lat = [ms for _, _, ms in saturated]
            log(f"serve_unloaded_ms p50={pct(lat, 50):.3f} p99={pct(lat, 99):.3f} "
                f"(64 sequential requests); the bare PredictStep at B=1 on the same "
                f"questions p50={pct(bare, 50):.3f} p99={pct(bare, 99):.3f} [{card}]")
            log(f"serve_saturated: 32 clients x 8 requests in {sat_s:.3f} s = "
                f"{256 / sat_s:.1f} q/s, latency p50={pct(sat_lat, 50):.3f} "
                f"p99={pct(sat_lat, 99):.3f} ms, {sat_disp} dispatches, mean micro-batch "
                f"{256 / sat_disp:.2f} [{card}]")
            # a device-cache miss (a feature never asked for) against a hit
            fresh = [n for n in sorted(set(data.test_data.img_names)) if n != name][:16]
            miss = [http_json(port, "/answer", {"question": qs[1], "feat_name": n})[2]
                    for n in fresh]
            hit = [http_json(port, "/answer", {"question": qs[1], "feat_name": n})[2]
                   for n in fresh]
            log(f"serve_feat_cache_ms miss p50={pct(miss, 50):.3f} hit p50={pct(hit, 50):.3f} "
                f"(16 features each) [{card}]")
            # the native loader against the Python store: an epoch of B=100
            names = [td.img_names[i] for i in range(td.num_examples)]
            py = PackedFeatureStore(shard)
            t0 = time.perf_counter()
            for i in range(0, len(names), 100):
                py.get_batch(names[i:i + 100], [1] * 100)
            py_s = time.perf_counter() - t0
            try:
                nat = native.NativePackedFeatureStore(shard, n_threads=4)
            except native.NativeUnavailable as e:
                log(f"serve: NativePackedFeatureStore not measured: {str(e).splitlines()[0]}")
            else:
                t0 = time.perf_counter()
                for i in range(0, len(names), 100):
                    got = nat.get_batch(names[i:i + 100], [1] * 100)
                nat_s = time.perf_counter() - t0
                if not np.array_equal(got, py.get_batch(names[-100:], [1] * 100)):
                    failed.append("the native store's batch differs from the Python store's")
                nat.close()
                log(f"serve_loader_epoch_s native={nat_s:.4f} python={py_s:.4f} "
                    f"({len(names) // 100} batches of 100 x {mcfg.cnn_spat} x "
                    f"{mcfg.cnn_dim} float32) [{card}]")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
            srv_thread.join(60)

        # 10. an image: the ours_resnet head and a folded bf16 ResNet-101
        cfg_r = dataclasses.replace(get_preset("ours_resnet"), vocab_size=data.vocab_size,
                                    answer_size=data.answer_size, seq_len=data.seq_len)
        state_r = init_train_state(cfg_r, seed, device=dev)
        snap_r = save_checkpoint(os.path.join(root, "snap_r"), 0, 0.0, state_r._asdict(),
                                 extra={"model_config": dataclasses.asdict(cfg_r)})
        bb = resnet.fold_batchnorm(resnet.resnet101_init(
            torch.Generator().manual_seed(seed + 1), torch.bfloat16, dev))
        svc_r = RAUService(snap_r, None, [], data=data, backbone="resnet101",
                           bb_params=bb, max_batch=16, max_wait_ms=5.0)
        server = serve(svc_r, port=0, host="127.0.0.1")
        port = server.server_address[1]
        srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
        srv_thread.start()
        try:
            rs = np.random.RandomState(seed)
            size = svc_r.image_size     # 448: the 14 x 14 grid at stride 32
            pixels = [rs.randint(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(2)]
            b64 = [base64.b64encode(png_bytes(p)).decode() for p in pixels]
            try:
                native.load_image_library()
                route = "native"
            except native.NativeUnavailable as e:
                why = str(e).splitlines()
                log(f"serve: the native decoder does not build here: "
                    f"{next((x for x in why if 'error' in x), why[0]).strip()}")
                try:
                    import PIL  # noqa: F401
                    route = "PIL"
                except ImportError:
                    route = "none: image_b64 requests get a 400"
            log(f"serve: image decode route: {route}")
            img_qs = qs

            def ask_image(q, k=0):
                return http_json(port, "/answer", {"question": q, "image_b64": b64[k],
                                                   "topk": 5})
            with driven([svc_r]) as img_launch:
                with ThreadPoolExecutor(3) as ex:
                    img_out = list(ex.map(ask_image, img_qs))
            st = svc_r.stats()
            log(f"serve image: 3 requests at once: {[c for c, _, _ in img_out]}, "
                f"feat_cache_entries {st['feat_cache_entries']}, launches {img_launch}")
            if any(c != 200 for c, _, _ in img_out) or st["feat_cache_entries"] != 1 \
                    or img_launch["fused_identity_stage"] != 4 \
                    or not img_launch["lstm_encode"] == img_launch["rau_hops"] \
                    == img_launch["dispatches"] > 0:
                failed.append(f"image: {[(c, b) for c, b, _ in img_out if c != 200]}, cache "
                              f"{st['feat_cache_entries']}, launches {img_launch}")
            else:
                # against answer_pixels on the same image and questions: its
                # select answers, and its select row's scores (computed by
                # its own parts) for the answers each response ranked
                t_q = torch.as_tensor(np.stack([data.question_to_tokens(q, normalize=True)[0]
                                                for q in img_qs]), device=dev)
                l_q = torch.as_tensor([data.question_to_tokens(q, normalize=True)[1]
                                       for q in img_qs], dtype=torch.int32, device=dev)

                def select_row(image, feat_norm=False):
                    with torch.no_grad():
                        f = pipeline.extract_features(
                            "resnet101", bb, torch.as_tensor(np.stack([image] * 3), device=dev),
                            fused_stages=pipeline.SERVING_STAGES, feat_norm=feat_norm).float()
                        tab, _ = predict_fused(svc_r.params, pipeline._head_weights(svc_r.params),
                                               svc_r.mcfg, t_q, l_q, f)
                    return tab[-1].float().cpu().numpy()

                def bar_share(ref):
                    """The responses' largest score distance from ``ref``, as a
                    share of the serving bar (rtol 0.05, atol 0.02)."""
                    out = 0.0
                    for (_, b, _), r in zip(img_out, ref):
                        got = np.array([a["score"] for a in b["answers"]])
                        want = r[[aid[a["answer"]] for a in b["answers"]]]
                        out = max(out, float((np.abs(got - want)
                                              / (0.02 + 0.05 * np.abs(want))).max()))
                    return out
                ids, _ = pipeline.answer_pixels(svc_r.params, bb, svc_r.mcfg, "resnet101",
                                                np.stack([pixels[0]] * 3), t_q, l_q)
                ids = ids[-1].cpu().numpy()
                ref = select_row(pixels[0])
                got = [b["answers"][0]["answer"] for _, b, _ in img_out]
                want = [data.answers[int(i)] for i in ids]
                share = bar_share(ref)
                # a near tie (the other answer within the serving bar of the
                # top score) counts as agreement, as in the pixels phase
                tied = [w in {a["answer"] for a in b["answers"]
                              if abs(a["score"] - b["answers"][0]["score"])
                              <= 0.02 + 0.05 * abs(b["answers"][0]["score"])}
                        for w, (_, b, _) in zip(want, img_out)]
                # the same distance from a wrong feature path: the other image,
                # and the features with feat_norm flipped.  The random head
                # gives every image nearly the same scores, so the other
                # image's row lies within the bar: the served scores must
                # also lie nearer than a tenth of each wrong row's distance
                wrong = {"the other image": bar_share(select_row(pixels[1])),
                         "feat_norm flipped": bar_share(select_row(pixels[0], not svc_r.feat_norm))}
                log(f"serve image: select answers {got}, answer_pixels {want} (ties {tied}); the served "
                    f"top-5 scores at {share:.4f} of the serving bar (rtol 0.05 atol 0.02) of "
                    f"answer_pixels' select row; a wrong feature path's row at "
                    + ", ".join(f"{v:.4f} ({k})" for k, v in wrong.items())
                    + " (bar: the served scores nearer than a tenth of each)")
                if not all(g == w or t for g, w, t in zip(got, want, tied)) or share > 1.0 \
                        or not share < 0.1 * min(wrong.values()) \
                        or not (ref.argmax(-1) == ids).all():
                    failed.append(f"image answers {got} vs answer_pixels {want}, scores at "
                                  f"{share:.4f} of the bar")
            # readings: an image request on a miss (a new image) against a hit
            with driven([svc_r]):
                _, _, miss_ms = ask_image(img_qs[1], 1)
                _, _, hit_ms = ask_image(img_qs[2], 1)
            log(f"serve_image_ms miss={miss_ms:.3f} hit={hit_ms:.3f} ({size} px, route "
                f"{route}) [{card}]")
        finally:
            server.shutdown()
            server.server_close()
            svc_r.close()
            srv_thread.join(60)
    log(f"serve launches in the driven requests {total}, dispatches {dispatches[0]}")
    if not total["lstm_encode"] == total["rau_hops"] == dispatches[0]:
        failed.append(f"launches {total} for {dispatches[0]} dispatches")
    log(f"serve_phase_s={time.perf_counter() - t_phase:.1f} [{card}]")
    if failed:
        raise SystemExit("serve: " + "; ".join(failed))
    return total


# the backbones phase's image sides (VGG16 at ours_ms's 14x14 grid, ViT-L/14
# at its 224 px) and the images its precomputation sweeps
BACKBONE_SIDES = {"vgg16": 448, "vit": 224}
PRECOMPUTE_IMAGES = 300


def pixels_gates(name, cfg, calls, plain, head, f32_feats, predict_plain, gen, failed,
                 pooled):
    """The pixels phase's gates for one batch size, set against bf16's own
    effect measured on these calls: ``calls`` [((ids, att), (images, tokens,
    lengths))]; ``plain`` runs pixels_forward on the bf16 tree; ``head`` the
    kernels' head on the bf16 tree's features; ``f32_feats`` the float32
    tree's features; ``predict_plain`` the float32 head.  Logs each reading
    beside its bar; appends what fails to ``failed``."""
    from rau_vqa_tpu_torch.eval.predict import _aggregate
    S, H, A = cfg.cnn_spat, cfg.n_hops, cfg.answer_size
    hits = dict.fromkeys(("same", "head", "near", "near_random", "plain_f32", "ref_f32"), 0)
    total, att_err, att_bf16, att_head = 0, 0.0, 0.0, 0.0
    B = calls[0][1][0].shape[0]
    for (ids, att), (images, tokens, lengths) in calls:
        if ids.shape != (H + 2, B) or att.shape != (H + 2, B, S) \
                or not torch.isfinite(att).all():
            raise SystemExit(f"{name} B={B}: shapes {tuple(ids.shape)} {tuple(att.shape)} "
                             f"or non-finite attention")
        with torch.no_grad():
            out, f_ref = plain(images, tokens, lengths)
            ref_pred, ref_att = _aggregate(out.scores, out.do_pred, out.attprob)
            head_pred, head_att = head(tokens, lengths, f_ref)
            f32_pred, f32_att = predict_plain(tokens, lengths, f32_feats(images))
        ref_ids, f32_ids = ref_pred.argmax(-1), f32_pred.argmax(-1)
        slack = 2 * (ref_pred - f32_pred).abs().amax(-1)
        best = ref_pred.amax(-1)

        def near(i):
            return (best - ref_pred.gather(-1, i[..., None])[..., 0] <= slack).sum().item()

        hits["near"] += near(ids)
        hits["near_random"] += near(torch.randint(0, A, ids.shape, device=ids.device,
                                                  generator=gen))
        hits["same"] += (ids == ref_ids).sum().item()
        hits["head"] += (head_pred.argmax(-1) == ref_ids).sum().item()
        hits["plain_f32"] += (ids == f32_ids).sum().item()
        hits["ref_f32"] += (ref_ids == f32_ids).sum().item()
        total += ids.numel()
        att_err = max(att_err, (att - ref_att).abs().max().item())
        att_bf16 = max(att_bf16, (ref_att - f32_att).abs().max().item())
        att_head = max(att_head, (head_att - ref_att).abs().max().item())
    r = {k: v / total for k, v in hits.items()}
    pooled["ids"] += total
    pooled["plain_f32"] += hits["plain_f32"]
    pooled["ref_f32"] += hits["ref_f32"]
    log(f"{name} B={B} x {len(calls)} calls, {total} ids: answers agree with "
        f"pixels_forward {r['same']:.4f} (kernels' head alone {r['head']:.4f}, bar > 0.95), "
        f"within bf16's tie slack {r['near']:.4f} (bar > 0.95; random answers "
        f"{r['near_random']:.4f}, bar < 0.2); with the float32 tree: answer_pixels "
        f"{r['plain_f32']:.4f}, pixels_forward {r['ref_f32']:.4f}; attention max_abs_err "
        f"{att_err:.3e} (bar {2 * att_bf16 + 5e-4:.3e}: twice bf16's own {att_bf16:.3e} "
        f"+ 5e-4), head alone {att_head:.3e} (bar 5e-4)")
    if r["near"] <= 0.95 or r["near_random"] >= 0.2:
        failed.append(f"{name} B={B}: answers within bf16's tie slack {r['near']:.4f}, "
                      f"random answers {r['near_random']:.4f}")
    if att_err > 2 * att_bf16 + 5e-4:
        failed.append(f"{name} B={B}: attention {att_err:.3e}, bf16's own {att_bf16:.3e}")
    if r["head"] <= 0.95 or att_head > 5e-4:
        failed.append(f"{name} B={B}: kernels' head vs float32 head: agreement "
                      f"{r['head']:.4f}, attention {att_head:.3e}")


def backbones_phase(seed: int, card: str) -> dict:
    """Phase 10: the flagship heads from pixels: ``ours_ms`` through VGG16 at
    448 px and ``ours_vit`` through ViT-L/14 at 224 px by ``answer_pixels``,
    the serving kernels at ``ours_vit`` widths against their plain versions,
    ``precompute_features`` into float32 and int8 shards, and the same
    images through ``RAUService`` and the ``Trainer``; returns the head
    kernels' launches on those paths."""
    import base64
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from rau_vqa_tpu_torch.config import get_experiment, get_preset
    from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
    from rau_vqa_tpu_torch.data.features import PackedShardWriter, coco_feat_name
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.eval.predict import predict, predict_fused
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import vgg, vit
    from rau_vqa_tpu_torch.models.rau import embed_image, embed_question, init_params
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.precompute import (
        precompute_features, quantize_feats_device, scan_image_dir, unique_by_feat_name)
    from rau_vqa_tpu_torch.serve import RAUService
    from rau_vqa_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rs = np.random.RandomState(seed + 40)
    heads = {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL}
    total = dict.fromkeys(heads, 0)
    failed = []

    def count(block_launches):
        for n in total:
            total[n] += block_launches[n]

    # 1. the serving kernels at ours_vit widths (S 256 cells of 1024
    # channels), against their plain versions at the serving bars
    cfg_v = get_preset("ours_vit")
    params_v = init_params(cfg_v, torch.Generator().manual_seed(seed + 41), dev)
    widths = (cfg_v.rnnout_dim, cfg_v.cnn_spat, cfg_v.multfeat_dim, cfg_v.attfeat_dim,
              cfg_v.att_rnn_size, cfg_v.answer_size)
    enc = lstm_encoder.pack_encoder_weights(params_v["rnn"])
    hw = rau_hops.pack_hop_weights(params_v["mult"])
    for B in (1, 19, 64):
        plan = rau_hops.hops_plan(B, cfg_v)
        scratch, launches = rau_hops.hops_launcher_plan(B, *widths)
        if scratch <= 0 or [x[:3] for x in launches] != [ph.grid for ph in plan.phases]:
            raise SystemExit(f"hops_plan at ours_vit widths B={B}: the launcher runs "
                             f"{launches} with {scratch} scratch floats")
        tokens, lengths, feats = make_batch(cfg_v, B, cfg_v.seq_len, rs, dev)
        emb = embed_question(params_v, tokens).contiguous()
        q = lstm_encoder.lstm_encode(enc, cfg_v, emb, lengths)
        q2 = lstm_encoder.lstm_encode(enc, cfg_v, emb, lengths)
        q_ref = lstm_encoder.lstm_encode_reference(enc, cfg_v, emb, lengths, dot_dtype=bf16)
        ifeat, iatt = embed_image(params_v["mult"], feats)
        ifeat, iatt = ifeat.to(bf16).contiguous(), iatt.to(bf16).contiguous()
        s, d, a = rau_hops.rau_hops(hw, cfg_v, q_ref, ifeat, iatt)
        again = rau_hops.rau_hops(hw, cfg_v, q_ref, ifeat, iatt)
        s_r, d_r, a_r = rau_hops.rau_hops_reference(hw, cfg_v, q_ref, ifeat, iatt,
                                                    dot_dtype=bf16)
        torch.cuda.synchronize()
        e_q = (q - q_ref).abs().max().item()
        q_share = ((q - q_ref).abs() / (5e-3 + 0.05 * q_ref.abs())).max().item()
        share = ((s - s_r).abs() / (0.01 + 0.05 * s_r.abs())).max().item()
        agree = (s.argmax(-1) == s_r.argmax(-1)).float().mean().item()
        e_a, e_d = (a - a_r).abs().max().item(), (d - d_r).abs().max().item()
        bits = torch.equal(q, q2) and all(torch.equal(x, y) for x, y in zip((s, d, a), again))
        log(f"ours_vit widths B={B} (S {cfg_v.cnn_spat}, D {cfg_v.cnn_dim}): lstm_encode "
            f"max_abs_err {e_q:.3e} ({q_share:.3f} of the bar atol 5e-3 rtol 0.05); rau_hops "
            f"scores {(s - s_r).abs().max().item():.3e} ({share:.3f} of the bar atol 0.01 "
            f"rtol 0.05), argmax_agree {agree:.4f} (bar > 0.97), attprob {e_a:.3e} (atol "
            f"5e-4), do_pred {e_d:.3e} (atol 5e-3); two calls bit-equal: {bits}; the plan's "
            f"{len(plan.phases)} launches a one-hop call are the launcher's")
        if not (q_share <= 1 and share <= 1 and agree > 0.97 and bits):
            failed.append(f"kernels at ours_vit widths B={B}: encoder {q_share:.3f} of its "
                          f"bar, hops {share:.3f}, agreement {agree:.4f}, bit-equal {bits}")
        torch.testing.assert_close(a, a_r, rtol=0.05, atol=5e-4)
        torch.testing.assert_close(d, d_r, rtol=0.05, atol=5e-3)

    # 2. ours_ms through VGG16 at 448 px and ours_vit through ViT-L/14 at
    # 224 px: bf16 trees from the seed (VGG16's He init x0.72 a convolution,
    # pool5 near unit scale), their float32 copies the yardstick of bf16's
    # own effect (TF32 off), run 8 images at a time
    cfg_m = get_preset("ours_ms")
    params_m = init_params(cfg_m, torch.Generator().manual_seed(seed + 42), dev)
    bb_vgg = vgg.vgg16_pool5_init(torch.Generator().manual_seed(seed + 43), device=dev)
    bb_vgg = map_tree(lambda t: (t * 0.72 if t.ndim == 4 else t).to(bf16), bb_vgg)
    bb_vit = vit.vit_init(torch.Generator().manual_seed(seed + 44), vit.VIT_L14, bf16, dev)
    side = BACKBONE_SIDES["vgg16"]
    models = {"vgg16": (cfg_m, params_m, bb_vgg, side, {1: 24, 8: 4, 64: 1}),
              "vit": (cfg_v, params_v, bb_vit, BACKBONE_SIDES["vit"], {1: 24, 64: 1})}
    gen = torch.Generator(dev).manual_seed(seed)
    timing = {}
    for name, (cfg, params, bb, img_side, n_calls) in models.items():
        bb_f32 = map_tree(lambda t: t.float(), bb)
        data = {B: [(torch.as_tensor(rs.randint(0, 256, (B, img_side, img_side, 3),
                                                dtype=np.uint8),
                                     device=dev), *make_batch(cfg, B, cfg.seq_len, rs, dev)[:2])
                    for _ in range(n)] for B, n in n_calls.items()}
        for k in (fused_resnet.KERNEL, *heads.values()):
            k.launches = 0
        outs = {B: [pipeline.answer_pixels(params, bb, cfg, name, *d) for d in batches]
                for B, batches in data.items()}
        torch.cuda.synchronize()
        launched = {n: k.launches for n, k in heads.items()}
        n_all = sum(n_calls.values())
        log(f"{name} answer_pixels launches in {n_all} calls: {launched}, stage kernel "
            f"{fused_resnet.KERNEL.launches}")
        if launched != {"lstm_encode": n_all, "rau_hops": n_all} or fused_resnet.KERNEL.launches:
            raise SystemExit(f"{name}: expected one launch of each head kernel a call and "
                             f"no stage kernel, got {launched}, {fused_resnet.KERNEL.launches}")
        count(launched)
        head_w = pipeline._head_weights(params)

        def f32_feats(images, _bb=bb_f32, _name=name):
            return torch.cat([pipeline.extract_features(_name, _bb, images[i:i + 8])
                              for i in range(0, images.shape[0], 8)])

        pooled = {"ids": 0, "plain_f32": 0, "ref_f32": 0}
        for B, batches in data.items():
            pixels_gates(
                name, cfg, list(zip(outs[B], batches)),
                plain=lambda im, t, ln, _bb=bb, _c=cfg, _p=params, _n=name: (
                    pipeline.pixels_forward(_p, _bb, _c, _n, im, t, ln),
                    pipeline.extract_features(_n, _bb, im).float()),
                head=lambda t, ln, f, _p=params, _w=head_w, _c=cfg: predict_fused(
                    _p, _w, _c, t, ln, f),
                f32_feats=f32_feats,
                predict_plain=lambda t, ln, f, _p=params, _c=cfg: predict(_p, _c, t, ln, f),
                gen=gen, failed=failed, pooled=pooled)
        a_f32 = pooled["plain_f32"] / pooled["ids"]
        r_f32 = pooled["ref_f32"] / pooled["ids"]
        log(f"{name}, all {pooled['ids']} ids: agreement with the float32 tree, "
            f"answer_pixels {a_f32:.4f}, pixels_forward {r_f32:.4f} (bar: no less, less 0.03)")
        if a_f32 < r_f32 - 0.03:
            failed.append(f"{name}: answer_pixels agrees {a_f32:.4f} with the float32 tree, "
                          f"pixels_forward {r_f32:.4f}")
        del bb_f32
        timing[name] = (cfg, params, bb, data)

    # 3. readings: answer_pixels, the backbone alone and the head alone at
    # each B, each beside the backbone's bound; the idle share and the peak
    # device memory at B=64
    for name, (cfg, params, bb, data) in timing.items():
        flops = vgg_flops(side) if name == "vgg16" else vit_flops(vit.VIT_L14)
        w_bytes = nbytes(bb)
        head_w = pipeline._head_weights(params)
        for B, batches in data.items():
            images, tokens, lengths = batches[0]
            iters = 5 if B == 64 else 20
            ans_ms = time_ms(lambda: pipeline.answer_pixels(params, bb, cfg, name, images,
                                                            tokens, lengths), iters=iters)
            with torch.no_grad():
                bb_ms = time_ms(lambda: pipeline.extract_features(name, bb, images), iters=iters)
                feats = pipeline.extract_features(name, bb, images).float()
                head_ms = time_ms(lambda: predict_fused(params, head_w, cfg, tokens, lengths,
                                                        feats), iters=iters)
            io_bytes = w_bytes + images.numel() + feats.numel() * 2
            b_ms, b_by = bound(io_bytes, B * flops, H100_BF16_FLOPS)
            log(f"{name}_answer_pixels_ms={ans_ms:.4f} B={B} images_per_s="
                f"{B / ans_ms * 1e3:.1f}; backbone alone {bb_ms:.4f} ms (bound {b_ms:.4f} ms "
                f"by {b_by}: {B * flops / 1e9:.1f} GFLOP, {io_bytes / 1e9:.3f} GB; "
                f"{B * flops / bb_ms / 1e9:.1f} TFLOP/s), head alone {head_ms:.4f} ms [{card}]")
        images, tokens, lengths = data[64][0]
        busy_ms, top, ops, _, _ = device_profile(lambda: pipeline.answer_pixels(
            params, bb, cfg, name, images, tokens, lengths))
        if busy_ms > 0:
            log(f"{name}_answer_pixels_device_busy_ms={busy_ms:.4f} of {ans_ms:.4f} (idle "
                f"share {1 - busy_ms / ans_ms:.3f}) B=64 [{card}]")
            for k, t in top[:8]:
                log(f"{name}_answer_pixels_device_ms={t:.4f} {k[:70]} <- "
                    f"{ops.get(k, 'no op')[:100]}")
        else:
            log(f"{name}_answer_pixels_device_busy_ms: not measured (the profiler recorded "
                f"no device time)")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipeline.answer_pixels(params, bb, cfg, name, images, tokens, lengths)
        torch.cuda.synchronize()
        log(f"{name}_answer_pixels_peak_mb={(torch.cuda.max_memory_allocated() - held) / 1e6:.1f} "
            f"B=64 above the {held / 1e6:.1f} MB held [{card}]")
    del timing, models, bb_vit

    with tempfile.TemporaryDirectory(prefix="chip_smoke_backbones_") as root:
        # 4. precompute_features: 300 distinct 448 px PNGs, B=64 (the last
        # batch partial), the bf16 VGG16 into a float32 and an int8 shard
        img_root = os.path.join(root, "images")
        os.makedirs(os.path.join(img_root, "val2014"))
        rel = [f"val2014/COCO_val2014_{i:012d}.png" for i in range(PRECOMPUTE_IMAGES)]
        pix = rs.randint(0, 256, (len(rel), side, side, 3), dtype=np.uint8)

        def write(i):
            with open(os.path.join(img_root, rel[i]), "wb") as f:
                f.write(png_bytes(pix[i]))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            list(ex.map(write, range(len(rel))))
        log(f"precompute: {len(rel)} PNGs of {side} px written in "
            f"{time.perf_counter() - t0:.2f} s")
        del pix
        found = scan_image_dir(img_root)
        names, paths = unique_by_feat_name(found)
        t0 = time.perf_counter()
        f32 = precompute_features(img_root, found, os.path.join(root, "f32"), "vgg16", bb_vgg,
                                  size=side, batch_size=64)
        sweep_s = time.perf_counter() - t0
        q8 = precompute_features(img_root, found, os.path.join(root, "i8"), "vgg16", bb_vgg,
                                 size=side, batch_size=64, dtype="int8")
        log(f"precompute: decoded by {f32.decoder}; the int8 sweep's {q8.decoder}")
        if list(f32.index) != names or list(q8.index) != names:
            failed.append("precompute: the shard's names are not unique_by_feat_name's")
        # each row against extract_features of the same decoded images at the
        # same batch size, the last batch padded alike
        src = ImageDirSource(img_root, size=side, backend="native")
        rows = np.asarray(f32.mmap)
        worst, bit_equal = 0.0, True
        t_dec = 0.0
        for i in range(0, len(paths), 64):
            chunk = paths[i:i + 64]
            t0 = time.perf_counter()
            imgs = src.get_batch(chunk + [chunk[-1]] * (64 - len(chunk)))
            t_dec += time.perf_counter() - t0
            with torch.no_grad():
                want = pipeline.extract_features("vgg16", bb_vgg, torch.as_tensor(
                    imgs, device=dev)).float().cpu().numpy()[:len(chunk)]
            got = rows[i:i + len(chunk)]
            rms = float(np.sqrt(np.square(want).mean()))
            worst = max(worst, float(np.abs(got - want).max()) / rms)
            bit_equal = bit_equal and np.array_equal(got, want)
        log(f"precompute: float32 rows vs extract_features at B=64: max_abs_err/RMS "
            f"{worst:.3e} (bar 1e-5), bit-equal {bit_equal}; decoded by {src.decoders()}")
        if worst > 1e-5:
            failed.append(f"precompute: float32 rows {worst:.3e} of the features' RMS from "
                          f"extract_features")
        host = PackedShardWriter(os.path.join(root, "host"), len(names), f32.spat, f32.dim,
                                 dtype="int8")
        host.write(0, rows)
        q_equal = (np.array_equal(np.asarray(q8.mmap), np.asarray(host.arr))
                   and np.array_equal(q8.scales, host.scales))
        # and the quantization alone on 64 rows of spread scales, a zero row
        # and round-half-even ties at the clip's edge (the JAX pin's cases)
        feats = (rs.randn(64, f32.spat, f32.dim)
                 * rs.uniform(0.05, 40.0, (64, 1, 1))).astype(np.float32)
        feats[3] = 0.0
        feats[4, 0, :2] = (127.5, -126.5)
        pin = PackedShardWriter(os.path.join(root, "pin"), 64, f32.spat, f32.dim, dtype="int8")
        pin.write(0, feats)
        q, sc = quantize_feats_device(torch.as_tensor(feats, device=dev))
        pin_equal = (np.array_equal(q.cpu().numpy(), np.asarray(pin.arr))
                     and np.array_equal(sc.cpu().numpy(), pin.scales))
        log(f"precompute: the int8 shard equals PackedShardWriter.write's host quantization "
            f"of the float32 rows bit for bit: {q_equal}; quantize_feats_device on {feats.size} "
            f"values of spread scales, a zero row and ties: {pin_equal}")
        if not (q_equal and pin_equal):
            failed.append(f"precompute: the int8 shard ({q_equal}) or the quantization "
                          f"({pin_equal}) differs from the host's")
        images64 = torch.as_tensor(src.get_batch(paths[:64]), device=dev)
        with torch.no_grad():
            bb64 = time_ms(lambda: pipeline.extract_features("vgg16", bb_vgg, images64),
                           iters=5)
        log(f"precompute_images_per_s={len(names) / sweep_s:.1f} (the float32 sweep, "
            f"{len(names)} images, {sweep_s:.3f} s); the backbone alone at B=64 "
            f"{64 / bb64 * 1e3:.1f} images/s; the decode alone "
            f"{len(paths) / t_dec:.1f} images/s [{card}]")

        # 5. the Trainer from the paper-dims fixture's images at 448 px, and
        # from a shard that precompute_features made of the same images
        spec = FixtureSpec(n_train=1000, n_test=166, n_images=100, n_words=12604,
                           n_answers=1000, seq_len=26, feat_dim=512, feat_w=14,
                           feat_h=14, n_mc=4, seed=11 + seed, n_img_classes=5,
                           class_code="dense")
        t0 = time.perf_counter()
        bundle = fixture_bundle(os.path.join(root, "fixture"), spec, images=True,
                                image_size=side)
        fix_images = os.path.join(root, "fixture", "images")
        log(f"trainer from images: the fixture with {2 * spec.n_images} JPEGs of {side} px "
            f"made in {time.perf_counter() - t0:.2f} s")
        gt = {int(k): v for k, v in bundle.gt.items()}
        shard = precompute_features(fix_images, scan_image_dir(fix_images),
                                    os.path.join(root, "fix_shard"), "vgg16", bb_vgg,
                                    size=side, batch_size=64)
        runs = {}
        for kind in ("images", "shard"):
            exp = get_experiment("ours_ms")
            exp = exp.replace(data=dataclasses.replace(exp.data, split="val2014",
                                                       test_batch_size=83))
            data = build_vqa_data(bundle.info, bundle.arrays, exp.train.batch_size,
                                  split="val2014", test_batch_size=83, seed=exp.train.seed)
            if kind == "images":
                src_t = ImageDirSource(fix_images, size=side, backend="native")
                tr = Trainer(exp, data, src_t, os.path.join(root, kind), gt_anno=gt,
                             backbone="vgg16", bb_params=bb_vgg)
            else:
                tr = Trainer(exp, data, shard, os.path.join(root, kind), gt_anno=gt)
            losses, step = [], tr.train_step

            def spy(*a, _step=step, _losses=losses):
                out = _step(*a)
                _losses.append(out[1]["loss"])
                return out
            tr.train_step = spy
            for k in heads.values():
                k.launches = 0
            tr.fit(epochs=1, eval_each=False)
            res = tr.evaluate(return_rows=True, write_submissions=False)
            torch.cuda.synchronize()
            count({n: k.launches for n, k in heads.items()})
            rec = tr.logger.read("train")[-1]
            runs[kind] = (float(losses[0]), res, rec, tr)
            log(f"trainer from {kind}: first-step loss {float(losses[0]):.6f}, epoch loss "
                f"{rec['loss']:.4f}, trained q/s {rec['examples_per_sec']:.1f} "
                f"(B={exp.train.batch_size}, epoch {rec['sec']:.3f} s)"
                + (f"; images decoded by {src_t.decoders()}" if kind == "images" else "")
                + f" [{card}]")
        (l_i, r_i, _, tr_i), (l_s, r_s, _, _) = runs["images"], runs["shard"]
        rel_l = abs(l_i - l_s) / abs(l_s)
        rows_i = [x for h in r_i["rows_oe"] for x in h]
        rows_s = [x for h in r_s["rows_oe"] for x in h]
        agree = np.mean([x == y for x, y in zip(rows_i, rows_s)])
        log(f"trainer: first-step losses from images and from the shard part by {rel_l:.3e} "
            f"relative (bar 5e-3); the sweeps' answers agree on {agree:.4f} of "
            f"{len(rows_i)} (bar >= 0.99)")
        if rel_l > 5e-3 or agree < 0.99 or len(rows_i) != len(rows_s):
            failed.append(f"trainer: losses {rel_l:.3e} apart, answers agree {agree:.4f}")

        # 6. the service: the image-trained snapshot, three of the 300 PNGs by
        # image_b64 against feat_name requests on the float32 shard
        snap = tr_i.save()
        data1 = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014",
                               test_batch_size=1)
        svc = RAUService(snap, None, [os.path.join(root, "f32")], data=data1,
                         backbone="vgg16", bb_params=bb_vgg)
        try:
            words = [data1.tokens_to_question(data1.test_data.questions[i],
                                              data1.test_data.lengths[i]) for i in range(3)]
            for k in heads.values():
                k.launches = 0
            for i, p in enumerate(paths[:3]):
                with open(os.path.join(img_root, p), "rb") as f:
                    b64 = base64.b64encode(f.read()).decode()
                by_img = svc.answer(words[i], image_b64=b64, topk=5)
                by_name = svc.answer(words[i], feat_name=names[i], topk=5)
                gs = np.array([x["score"] for x in by_img["answers"]])
                ws = np.array([x["score"] for x in by_name["answers"]])
                gap = ws[0] - ws[1]
                same_top = by_img["answers"][0]["answer"] == by_name["answers"][0]["answer"]
                err = float(np.abs(gs - ws).max())
                log(f"serve vgg16 image {i}: top answer {by_img['answers'][0]['answer']!r} "
                    f"by image_b64, {by_name['answers'][0]['answer']!r} by feat_name (top-2 "
                    f"gap {gap:.3e}); top-5 scores max_abs_err {err:.3e} (bar atol 0.02 "
                    f"rtol 0.05)")
                if not np.all(np.abs(gs - ws) <= 0.02 + 0.05 * np.abs(ws)) or \
                        (not same_top and gap > 2 * (0.02 + 0.05 * abs(ws[0]))):
                    failed.append(f"serve image {i}: {by_img['answers'][:2]} vs "
                                  f"{by_name['answers'][:2]}")
            torch.cuda.synchronize()
            served = {n: k.launches for n, k in heads.items()}
            log(f"serve vgg16: launches in 6 requests {served}, dispatches "
                f"{svc.stats()['dispatches']}")
            if served["lstm_encode"] < 1 or served["rau_hops"] < 1:
                failed.append(f"serve vgg16: the head kernels did not run: {served}")
            count(served)
        finally:
            svc.close()
    if failed:
        raise SystemExit("backbones: " + "; ".join(failed))
    log(f"backbones_phase_s={time.perf_counter() - t_phase:.1f} [{card}]")
    return total


def finetune_phase(seed: int, card: str) -> dict:
    """Phase 11: backbone fine-tuning through the user's entry points.
    ``ours_resnet_ft`` as the preset ships it (bf16, unfused, no remat,
    grouped images) through a random folded ResNet-101, then with remat;
    ``ours_ms`` fused through VGG16, whose backward kernel sums the
    features' gradient (``dfeats``), held to its plain version; the
    ``Trainer`` fine-tuning from the paper-dims fixture's JPEGs, its sweep,
    snapshot, resume and ``RAUService``.  Returns the launches of this
    phase's kernels and the dfeats kernels' readings."""
    import base64
    import tempfile

    from rau_vqa_tpu_torch.config import get_experiment, get_train_preset
    from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet, vgg
    from rau_vqa_tpu_torch.models.rau import init_params
    from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.serve import RAUService
    from rau_vqa_tpu_torch.train.losses import hop_grad_scale
    from rau_vqa_tpu_torch.train.trainer import (
        Trainer, _generator, featurizer, head_params, init_train_state, loss_and_grads,
        make_train_step)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rs = np.random.RandomState(seed + 50)
    failed = []
    zipf = 1.0 / np.arange(1, 11)
    log(f"finetune: TF32 in this run: matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32} (the train step leaves both as the process sets "
        f"them); the backbone computes in the compute type: under bfloat16 on a bf16 cast of "
        f"its float32 masters made in the step, in float32 on them")

    def inputs(cfg, B, n_images, side, s):
        tokens, lengths, _ = make_batch(dataclasses.replace(cfg, cnn_dim=1), B, cfg.seq_len,
                                        rs, dev)
        images = torch.randint(0, 256, (n_images, side, side, 3), dtype=torch.uint8,
                               device=dev, generator=torch.Generator(dev).manual_seed(s))
        labels = torch.as_tensor(rs.choice(10, B, p=zipf / zipf.sum()), device=dev)
        return tokens, lengths, images, labels

    def moved(a, b):
        leaves = list(zip(tree_leaves(a), tree_leaves(b)))
        return sum(1 for x, y in leaves if not torch.equal(x, y)), len(leaves)

    # 1. ours_resnet_ft as the preset ships it: bf16, unfused, no remat,
    # 'imggroup' groups of 3 (B=288 on 96 unique 448 px images), a random
    # folded ResNet-101, the RMS interface (the zero-asset rule), Zipf labels
    mcfg, tcfg = get_train_preset("ours_resnet_ft")
    tcfg = dataclasses.replace(tcfg, backbone_feat_norm=True)
    g, B, side = 3, tcfg.batch_size, mcfg.cnn_w * 32
    bb = resnet.fold_batchnorm(resnet.resnet101_init(
        torch.Generator().manual_seed(seed + 51), device=dev))
    state0 = init_train_state(mcfg, seed, bb_params=bb)
    del bb
    tokens, lengths, images, labels = inputs(mcfg, B, B // g, side, seed + 52)
    hop_scale = hop_grad_scale(mcfg.n_hops, scale_by_nhop=tcfg.hop_grad_scale_nhop,
                               stop_timing=tcfg.hop_stop_timing, epoch=1).to(dev)
    lr, mult_lr = tcfg.learning_rate, tcfg.mult_learning_rate
    batch = (tokens, lengths, images, labels, hop_scale, lr, mult_lr)
    step = make_train_step(mcfg, tcfg, backbone="resnet101", img_repeat=g)
    state, hist, step_ms, peak = state0, [], [], {}
    for i in range(10):
        if i == 1:
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            peak["off"] = (torch.cuda.max_memory_allocated() - held) / 1e6
        hist.append({k: v.detach() for k, v in m.items()})
    losses = [m["loss"].item() for m in hist]
    bad = [i for i, m in enumerate(hist) if not all(torch.isfinite(v).all() for v in m.values())]
    n_moved, n_leaves = moved(state.params["backbone"], state0.params["backbone"])
    gnb = [m["grad_norm_backbone"].item() for m in hist]
    ms = float(np.mean(step_ms[1:]))
    log(f"ours_resnet_ft losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"ours_resnet_ft grad_norm_backbone first/last {gnb[0]:.4e} / {gnb[-1]:.4e}; backbone "
        f"leaves moved {n_moved} of {n_leaves}")
    if bad or not losses[-1] < losses[0] or min(gnb) <= 0 or n_moved < n_leaves:
        failed.append(f"ours_resnet_ft: non-finite steps {bad}, losses {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}, grad_norm_backbone {min(gnb):.3e}, moved "
                      f"{n_moved}/{n_leaves}")
    busy, top, ops, n_kern, host = device_profile(lambda: step(state, *batch), iters=2)
    for name, t in top[:8]:
        log(f"ours_resnet_ft_device_ms={t:.3f} {name[:70]} <- {ops.get(name, 'no op')[:110]}")
    log("ours_resnet_ft host ops (own ms a step, calls a step): " + "; ".join(
        f"{k} {v:.1f} ({c:.0f})" for k, v, c in host[:8]))
    log(f"ours_resnet_ft_step_ms={ms:.2f} (steps 2-10; the first {step_ms[0]:.1f}) B={B} on "
        f"{B // g} unique {side} px images; trained_q_per_s={B / ms * 1e3:.1f}; device busy "
        + (f"{busy:.2f} ms a step, idle share {1 - busy / ms:.3f}" if busy > 0
           else "not measured (the profiler recorded no device time)")
        + f"; {n_kern:.0f} device kernels a step; peak memory {peak['off']:.1f} MB above the "
        f"{held / 1e6:.1f} MB held, remat off [{card}]")
    # the first step against the plain float32 step on the same inputs (the
    # float32 one with remat, the same values in less memory)
    mcfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
    tcfg32 = dataclasses.replace(tcfg, backbone_remat=True)
    _, m32 = make_train_step(mcfg32, tcfg32, backbone="resnet101", img_repeat=g)(state0, *batch)
    gap = abs(losses[0] - m32["loss"].item()) / abs(m32["loss"].item())
    log(f"ours_resnet_ft first-step loss: bf16 {losses[0]:.6f}, float32 "
        f"{m32['loss'].item():.6f}, relative gap {gap:.3e} (bar 0.05)")
    if gap > 0.05:
        failed.append(f"ours_resnet_ft: first-step loss {gap:.3e} from float32's")
    del m32
    # remat on: its peak memory in a step, and step 1's backbone grads
    # against remat off's
    step_r = make_train_step(mcfg, dataclasses.replace(tcfg, backbone_remat=True),
                             backbone="resnet101", img_repeat=g)
    torch.cuda.synchronize()
    held_r = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_r(state0, *batch)
    torch.cuda.synchronize()
    peak["on"] = (torch.cuda.max_memory_allocated() - held_r) / 1e6
    remat_ms = (time.perf_counter() - t0) * 1e3
    grads = {}
    for remat in (False, True):
        fz = featurizer(mcfg, dataclasses.replace(tcfg, backbone_remat=remat), "resnet101",
                        img_repeat=g)
        gr, _ = loss_and_grads(mcfg, state0.params, tokens, lengths, images, labels,
                               hop_scale, generator=_generator(dev, state0.seed, 0, 0),
                               featurize=fz)
        grads[remat] = gr["backbone"]
        del gr
    worst = max(norm_rel(a, b) for a, b in zip(tree_leaves(grads[True]),
                                                tree_leaves(grads[False])))
    log(f"ours_resnet_ft remat on: peak memory {peak['on']:.1f} MB above the "
        f"{held_r / 1e6:.1f} MB held (off: {peak['off']:.1f} MB), a step {remat_ms:.1f} ms; "
        f"backbone grads against remat off's: worst leaf norm-relative {worst:.3e} (bar 1e-3) "
        f"[{card}]")
    if worst > 1e-3:
        failed.append(f"ours_resnet_ft: remat's backbone grads {worst:.3e} from remat off's")
    del grads, state, state0, hist, step, step_r, images
    torch.cuda.empty_cache()

    # 2. ours_ms fused through VGG16, float32, B=96 on 32 unique 448 px
    # images: the backward kernel with the features' gradient
    mcfg2, tcfg2 = get_train_preset("ours_ms")
    mcfg2 = dataclasses.replace(mcfg2, fused_train=True)
    tcfg2 = dataclasses.replace(tcfg2, train_backbone=True, backbone_feat_norm=True,
                                batch_size=96)
    B2 = tcfg2.batch_size
    vbb = map_tree(lambda t: t * 0.72 if t.ndim == 4 else t,
                   vgg.vgg16_pool5_init(torch.Generator().manual_seed(seed + 53), device=dev))
    batch2 = inputs(mcfg2, B2, B2 // g, side, seed + 54)
    hs2 = hop_grad_scale(mcfg2.n_hops, scale_by_nhop=tcfg2.hop_grad_scale_nhop,
                         stop_timing=tcfg2.hop_stop_timing, epoch=1).to(dev)
    with torch.no_grad():
        feats = featurizer(mcfg2, tcfg2, "vgg16", img_repeat=g)(vbb, batch2[2]).contiguous()
    mp = init_params(mcfg2, torch.Generator().manual_seed(seed + 55), dev)["mult"]
    q = torch.as_tensor(0.5 * rs.randn(B2, mcfg2.rnnout_dim).astype(np.float32), device=dev)
    s = torch.tensor([seed + 56], dtype=torch.int32, device=dev)
    _, _, _, c_all, h_all = rth.train_hops_fwd(mp, mcfg2, q, feats, s)
    gsc = 1e-3 * torch.randn(mcfg2.n_hops, B2, mcfg2.answer_size, device=dev,
                             generator=torch.Generator(dev).manual_seed(seed + 57))
    gmerge = (gsc @ mp["cls"]["w"].T).contiguous()
    args = (mp, mcfg2, q, feats, s, c_all, h_all, gmerge)
    em, gw = rth.train_hops_bwd(*args, dfeats=True)
    em2, gw2 = rth.train_hops_bwd(*args, dfeats=True)
    want_em, want_gw = rth.train_hops_bwd_reference(*args, dfeats=True)
    torch.cuda.synchronize()
    errs = {"/".join(map(str, k)): norm_rel(gw[k], want_gw[k]) for k in gw}
    errs.update({k: norm_rel(em[k], want_em[k]) for k in em})
    same = (all(torch.equal(gw[k], gw2[k]) for k in gw)
            and all(torch.equal(em[k], em2[k]) for k in em))
    dfe = errs["feats"]
    log(f"train_hops_bwd dfeats B={B2} (VGG16 features, 448 px): dfeats norm-relative "
        f"{dfe:.3e}, worst of every output {max(errs.values()):.3e} (bar 1e-3); two calls "
        f"bit-equal {same}")
    if max(errs.values()) > 1e-3 or not same:
        failed.append(f"train_hops_bwd dfeats: {errs}, bit-equal {same}")
    # the plan with dfeats against the built launcher's dry run, and the
    # device kernels a call against the plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    widths = (mcfg2.cnn_spat, mcfg2.cnn_dim, mcfg2.multfeat_dim, mcfg2.attfeat_dim,
              mcfg2.att_state_dim, mcfg2.rnnout_dim)
    kern_a_call = {}
    for dtp in (torch.float32, torch.bfloat16):
        plan = rth.bwd_plan(B2, *widths, n_sm, dtp, True)
        scratch, launches_ = rth.launcher_plan(B2, *widths, dtp, plan.chunk_rows, True)
        if scratch <= 0 or [x[:3] for x in launches_] != [ph.grid for ph in plan.phases]:
            failed.append(f"bwd_plan with dfeats {dtp}: the launcher runs {launches_}")
        kern_a_call[dtp] = len(plan.phases) * mcfg2.n_hops
    log(f"train_hops_bwd with dfeats B={B2}: {kern_a_call[torch.float32] // mcfg2.n_hops} "
        f"kernels a hop (the plan's, the launcher's dry run alike in both types)")
    dt = {"device_kernels": device_kernels(
        lambda: rth.train_hops_bwd(*args, dfeats=True), kern_a_call[torch.float32],
        f"train_hops_bwd dfeats float32 B={B2}", card)}
    dt["ms"] = time_ms(lambda: rth.train_hops_bwd(*args, dfeats=True), iters=5, warmup=2)
    dt["without_ms"] = time_ms(lambda: rth.train_hops_bwd(*args), iters=5, warmup=2)
    dt["plain_ms"] = time_ms(lambda: rth.train_hops_bwd_reference(*args, dfeats=True),
                             iters=2, warmup=1)
    b_ms, b_by = train_bwd_bound(mcfg2, mp, B2, dfeats=True)
    log(f"train_hops_bwd_dfeats_ms={dt['ms']:.3f} (without dfeats {dt['without_ms']:.3f}) "
        f"plain_ms={dt['plain_ms']:.3f} bound_ms={b_ms:.3f} by {b_by} B={B2} float32 [{card}]")
    # the dfeats product alone at ours_resnet_ft's shapes (computed, not run:
    # the preset ships unfused): its operations over the peaks, and the
    # float32 sum's read and write a hop that the kernel makes
    Bp, Sp, Dp, Mp, Hp = B, mcfg.cnn_spat, mcfg.cnn_dim, mcfg.multfeat_dim, mcfg.n_hops
    ops_p = 2 * Bp * Sp * Dp * Mp * Hp
    traffic = 2 * Bp * Sp * Dp * 4 * Hp
    log(f"dfeats at ours_resnet_ft's shapes (B={Bp}, S={Sp}, Dc={Dp}, M={Mp}, {Hp} hops): "
        f"{ops_p / 1e12:.3f} TFLOP, {ops_p / H100_BF16_FLOPS * 1e3:.2f} ms at the bf16 peak, "
        f"{ops_p / H100_F32_FLOPS * 1e3:.2f} ms at the float32 peak; the kernel's float32 sum "
        f"read and written each hop: {traffic / 1e9:.2f} GB, "
        f"{traffic / H100_BYTES_PER_S * 1e3:.2f} ms at {H100_BYTES_PER_S / 1e12:.2f} TB/s")
    # the bf16 instantiation against its bf16 plain version at these shapes:
    # at one hop dfeats within the backward's bf16 bar, under half the
    # float32 plain version's distance; at the main path's eight hops, where
    # the sum over the hops in hop order, each hop's feats mask and its bf16
    # dpre_i first come into play, dfeats and every grad leaf within
    # train_bf16_deep_bar (twice the plain version's own drift on the host
    # CPU, under 3/4 of the float32 plain version's distance)
    cfg16 = dataclasses.replace(mcfg2, compute_dtype="bfloat16", n_hops=1)
    r16 = train_bf16_readings(rth, cfg16, mp, B2, rs, dev, dfeats=True)["bwd"]["feats"]
    bar16 = train_bf16_bar("bwd", "feats")
    log(f"train_hops_bwd_bf16 dfeats B={B2}, one hop: norm-relative {r16['kernel']:.3e} from "
        f"the bf16 plain version (bar {bar16:.1e}); the float32 plain version "
        f"{r16['float32']:.3e} (the bar must be under half of it)")
    if not r16["kernel"] <= bar16 < 0.5 * r16["float32"]:
        failed.append(f"train_hops_bwd_bf16 dfeats: {r16}")
    cfg16 = dataclasses.replace(mcfg2, compute_dtype="bfloat16")
    deep = train_bf16_readings(rth, cfg16, mp, B2, rs, dev, host=True, dfeats=True)["bwd"]
    deep_bars = {k: train_bf16_deep_bar(r) for k, r in deep.items()}
    log(f"train_hops_bwd_bf16 dfeats B={B2}, {cfg16.n_hops} hops, norm-relative from the bf16 "
        f"plain version: kernel / float32 plain / bf16 plain on the host (bar): " + ", ".join(
            f"{k} {r['kernel']:.3e} / {r['float32']:.3e} / {r['host']:.3e} ({deep_bars[k]:.3e})"
            for k, r in deep.items()) + f" [{card}]")
    for k, r in deep.items():
        if not r["kernel"] <= deep_bars[k]:
            failed.append(f"train_hops_bwd_bf16 dfeats {cfg16.n_hops} hops: {k} "
                          f"{r['kernel']:.3e} > {deep_bars[k]:.3e}")
    r16_deep = deep["feats"]
    b16 = torch.bfloat16
    mcfg16 = dataclasses.replace(mcfg2, compute_dtype="bfloat16")
    mp16 = map_tree(lambda w: w.to(b16), mp)
    args16 = (mp16, mcfg16, q.to(b16), feats.to(b16), s, c_all, h_all,
              (rth._rnd(gsc, b16) @ rth._rnd(mp["cls"]["w"], b16).T).contiguous())
    _, g16 = rth.train_hops_bwd(*args16, dfeats=True)
    _, g16b = rth.train_hops_bwd(*args16, dfeats=True)
    _, w16 = rth.train_hops_bwd_reference(*args16, dfeats=True)
    torch.cuda.synchronize()
    same16 = all(torch.equal(g16[k], g16b[k]) for k in g16)
    err16 = norm_rel(g16[rth.DFEATS], w16[rth.DFEATS])
    dt16 = {"device_kernels": device_kernels(
                lambda: rth.train_hops_bwd(*args16, dfeats=True), kern_a_call[torch.bfloat16],
                f"train_hops_bwd dfeats bfloat16 B={B2}", card),
            "ms": time_ms(lambda: rth.train_hops_bwd(*args16, dfeats=True), iters=5, warmup=2),
            "plain_ms": time_ms(lambda: rth.train_hops_bwd_reference(*args16, dfeats=True),
                                iters=2, warmup=1)}
    b16_ms, b16_by = train_bwd_bound(mcfg16, mp16, B2, b16, dfeats=True)
    log(f"train_hops_bwd_dfeats_bf16_ms={dt16['ms']:.3f} plain_ms={dt16['plain_ms']:.3f} "
        f"bound_ms={b16_ms:.3f} by {b16_by} B={B2}, eight hops: dfeats norm-relative "
        f"{err16:.3e} from the bf16 plain version; two calls bit-equal {same16} [{card}]")
    if not same16:
        failed.append("train_hops_bwd_bf16 dfeats: two calls differ")
    del args, args16, em, em2, gw, gw2, want_em, want_gw, g16, g16b, w16
    # the main path: the fine-tuning step, fused, in float32 then bf16; the
    # counts start at 0 here
    counted = {"train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL,
               "train_hops_bwd_dfeats": rth.BWD_DFEATS_KERNEL,
               "train_hops_fwd_bf16": rth.FWD_BF16_KERNEL,
               "train_hops_bwd_bf16": rth.BWD_BF16_KERNEL,
               "train_hops_bwd_dfeats_bf16": rth.BWD_DFEATS_BF16_KERNEL,
               "lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL}
    for k in counted.values():
        k.launches = 0
    init = init_train_state(mcfg2, seed, bb_params=vbb)
    runs = {}
    for name, cfg_, n in (("float32", mcfg2, 4), ("bfloat16", mcfg16, 3)):
        st, ls, t0 = init, [], time.perf_counter()
        step2 = make_train_step(cfg_, tcfg2, backbone="vgg16", img_repeat=g)
        for _ in range(n):
            st, m = step2(st, *batch2[:4], hs2, tcfg2.learning_rate, tcfg2.mult_learning_rate)
            ls.append(m["loss"].item())
        runs[name] = (ls, moved(st.params["backbone"], init.params["backbone"]),
                      (time.perf_counter() - t0) * 1e3 / n)
    launches = {n: k.launches for n, k in counted.items()}
    for name, (ls, (nm, nl), t) in runs.items():
        log(f"ours_ms fused through VGG16, {name}, B={B2}: losses "
            + " ".join(f"{x:.4f}" for x in ls) + f"; backbone leaves moved {nm} of {nl}; "
            f"{t:.1f} ms a step (with its host reads) [{card}]")
        if not all(np.isfinite(ls)) or nm == 0:
            failed.append(f"ours_ms fused {name}: losses {ls}, moved {nm}")
    log(f"finetune launches, fused steps (4 float32, 3 bf16): {launches}")
    want = {"train_hops_fwd": 4, "train_hops_bwd": 0, "train_hops_bwd_dfeats": 4,
            "train_hops_fwd_bf16": 3, "train_hops_bwd_bf16": 0,
            "train_hops_bwd_dfeats_bf16": 3}
    if any(launches[k] != v for k, v in want.items()):
        failed.append(f"fused fine-tuning launches {launches}, expected {want}")
    del init, batch2

    # 3. the Trainer: one fine-tuning epoch on the paper-dims fixture's 448 px
    # JPEGs through VGG16 in the 'imggroup' order, its sweep with the trained
    # backbone, a snapshot that resumes to the same bits and that
    # RAUService serves through its own backbone
    with tempfile.TemporaryDirectory(prefix="chip_smoke_finetune_") as root:
        spec = FixtureSpec(n_train=1000, n_test=166, n_images=100, n_words=12604,
                           n_answers=1000, seq_len=26, feat_dim=512, feat_w=14, feat_h=14,
                           n_mc=4, seed=13 + seed, n_img_classes=5, class_code="dense")
        bundle = fixture_bundle(os.path.join(root, "fixture"), spec, images=True,
                                image_size=side, uniform_img_assign=True)
        fix_images = os.path.join(root, "fixture", "images")
        gt = {int(k): v for k, v in bundle.gt.items()}
        exp = get_experiment("ours_ms")
        exp = exp.replace(
            train=dataclasses.replace(exp.train, train_backbone=True),
            data=dataclasses.replace(exp.data, split="val2014", test_batch_size=83,
                                     batch_order="imggroup"))

        def trainer(work):
            data = build_vqa_data(bundle.info, bundle.arrays, exp.train.batch_size,
                                  split="val2014", test_batch_size=83, seed=exp.train.seed)
            return Trainer(exp, data, ImageDirSource(fix_images, size=side, backend="native"),
                           os.path.join(root, work), gt_anno=gt, backbone="vgg16",
                           bb_params=vbb)
        tr = trainer("run")
        for k in counted.values():
            k.launches = 0
        t0 = time.perf_counter()
        rec = tr.train_epoch()
        t_epoch = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = tr.evaluate(write_submissions=False)
        t_sweep = time.perf_counter() - t0
        nm, nl = moved(tr.state.params["backbone"], map_tree(lambda t: t.float(), vbb))
        log(f"trainer fine-tuning: img_repeat {tr.img_repeat} (imggroup), epoch loss "
            f"{rec['loss']:.4f}, grad_norm_backbone {rec['grad_norm_backbone']:.4e}, "
            f"{rec['steps']} steps in {t_epoch:.2f} s, trained q/s "
            f"{rec['examples_per_sec']:.1f}; sweep {t_sweep:.2f} s with the trained backbone "
            f"(OE {res['testOEacc'][-1]:.4f}); backbone leaves moved {nm} of {nl} [{card}]")
        if (not np.isfinite(rec["loss"]) or nm == 0 or tr._bb_tree() is not
                tr.state.params["backbone"] or len(res["testOEacc"]) != exp.model.n_hops + 2):
            failed.append(f"trainer fine-tuning: loss {rec['loss']}, moved {nm}")
        snap = tr.save()
        tr2 = trainer("resumed")
        tr2.restore(snap)
        same = (all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.state.params),
                                                      tree_leaves(tr2.state.params)))
                and all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.state.opt),
                                                          tree_leaves(tr2.state.opt)))
                and (tr.state.step, tr.state.seed, tr.epoch, tr.lr)
                == (tr2.state.step, tr2.state.seed, tr2.epoch, tr2.lr))
        log(f"trainer fine-tuning: the 4-group snapshot resumes to the same bits: {same}")
        if not same:
            failed.append("trainer fine-tuning: the resumed state differs")
        data1 = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014",
                               test_batch_size=1)
        svc = RAUService(snap, None, [], data=data1)
        try:
            if svc.backbone != "vgg16" or not all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(svc.bb_params),
                                                      tree_leaves(tr.state.params["backbone"]))):
                failed.append("serve: not the snapshot's own backbone")
            head = head_params(tr.state.params)
            for i in range(3):
                words = data1.tokens_to_question(data1.test_data.questions[i],
                                                 data1.test_data.lengths[i])
                path = os.path.join(fix_images, data1.test_data.img_paths[i])
                with open(path, "rb") as f:
                    raw = f.read()
                out = svc.answer(words, image_b64=base64.b64encode(raw).decode(), topk=2)
                tok, ln = data1.question_to_tokens(words, normalize=True)
                ids, _ = pipeline.answer_pixels(head, tr.state.params["backbone"], tr.mcfg,
                                                "vgg16", svc._decode_image(raw), tok[None],
                                                np.asarray([ln]))
                want_a = [data1.answers[int(x)] for x in ids[:, 0].tolist()]
                sc = [a["score"] for a in out["answers"]]
                ok = out["answers"][0]["answer"] == want_a[-1] and out["per_hop"] == want_a[:-2]
                log(f"serve fine-tuned snapshot, image {i}: select answer "
                    f"{out['answers'][0]['answer']!r}, answer_pixels' {want_a[-1]!r}; per-hop "
                    f"answers alike {out['per_hop'] == want_a[:-2]}; top-2 gap "
                    f"{sc[0] - sc[1]:.3e}")
                if not ok:
                    failed.append(f"serve image {i}: {out['answers'][0]['answer']!r} / "
                                  f"{out['per_hop']} vs answer_pixels' {want_a}")
        finally:
            svc.close()
    torch.cuda.synchronize()
    for n in ("lstm_encode", "rau_hops"):
        launches[n] += counted[n].launches
    if failed:
        raise SystemExit("finetune: " + "; ".join(failed))
    log(f"finetune_phase_s={time.perf_counter() - t_phase:.1f} [{card}]")
    return {"launches": launches, "err": {"train_hops_bwd_dfeats": max(errs.values()),
                                          "train_hops_bwd_dfeats_bf16": max(r16["kernel"],
                                                                            r16_deep["kernel"])},
            "ms": {"train_hops_bwd_dfeats": dt, "train_hops_bwd_dfeats_bf16": dt16},
            "bound": {"train_hops_bwd_dfeats": (b_ms, b_by),
                      "train_hops_bwd_dfeats_bf16": (b16_ms, b16_by)}}


# phase 12's sizes: VQA v1's shapes at the scale a run of the smoke allows
# (a CPU rehearsal patches them smaller)
WF_TRAIN_IMAGES = 300          # train2014 images, two train sources by image
WF_TEST_IMAGES = 100           # val2014 images
WF_WORDS = 12604               # distinct words of the train questions (+ UNK: 12,605)
WF_ANSWERS = 1100              # answer strings, Zipf-like; the top-1000 cut drops the tail
WF_TRAIN_QUESTIONS = 6000      # about; the Zipf counts fix the exact number
WF_TEST_QUESTIONS = 830        # 10 sweep batches of 83
WF_MC = 18                     # MultipleChoice candidates a question
WF_FEAT = (512, 14, 14)        # .t7 feature [D, W, H]
WF_LEARN_EPOCHS = 30
WF_DEVICE = "cuda"


def png_shape(path: str):
    """(width, height, bit depth, colour type) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise SystemExit(f"workflow: {path} is not a PNG")
    return (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"),
            head[24], head[25])


def fabricate_vqa_v1(root: str, rs) -> dict:
    """Official-format VQA v1 files under ``root``: two train2014 sources
    (questions and annotations, split by image), val2014 questions with 10
    rater answers each, answer and question types, and their
    MultipleChoice questions JSON, and the .t7 features of every image (one
    directory a train source; val2014's beside the first).  Train answers
    are Zipf-like over ``WF_ANSWERS`` strings, every one at least once, so
    that prepro's top-1000 cut drops the tail's rows; the
    ``WF_WORDS`` distinct words each appear in a row whose answer occurs
    twice or more, which that cut keeps.  Returns the paths and counts."""
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.data.qa_utils import cocofeat_name

    words = (["what", "is", "the", "color", "how", "many", "are", "there", "does",
              "this"] + [f"w{i:05d}" for i in range(WF_WORDS)])[:WF_WORDS]
    answers = (["yes", "no"] + [str(n) for n in range(20)]
               + [f"answer{i:04d}" for i in range(WF_ANSWERS)])[:WF_ANSWERS]
    # counts A/(rank), at least 1, the A that lands nearest the target
    ranks = np.arange(1, WF_ANSWERS + 1)
    best = min(range(1, 20 * WF_TRAIN_QUESTIONS),
               key=lambda a: abs(np.maximum(1, a // ranks).sum() - WF_TRAIN_QUESTIONS))
    counts = np.maximum(1, best // ranks)
    labels = rs.permutation(np.repeat(np.arange(WF_ANSWERS), counts))
    n_train = len(labels)
    safe = np.flatnonzero(counts[labels] >= 2)   # rows the top-N cut keeps
    if (counts >= 2).sum() > 1000 or len(safe) * 8 < WF_WORDS:
        raise SystemExit("workflow: the fabricated counts do not fit the top-1000 cut")
    qwords = [[] for _ in range(n_train)]
    for k, w in enumerate(rs.permutation(WF_WORDS)):
        qwords[safe[k % len(safe)]].append(words[w])
    zipf_w = 1.0 / np.arange(1, 201)
    zipf_w /= zipf_w.sum()
    for q in qwords:
        q.extend(words[int(j)] for j in rs.choice(200, rs.randint(2, 6), p=zipf_w))
        rs.shuffle(q)
    img_train = 1 + rs.randint(0, WF_TRAIN_IMAGES, n_train)
    split_at = 2 * WF_TRAIN_IMAGES // 3       # source 1: images 1..split_at
    out = {"n_train": n_train, "words": words, "answers": answers}
    feat_dirs = [os.path.join(root, "feat_train_a"), os.path.join(root, "feat_train_b")]
    for d in feat_dirs:
        os.makedirs(d, exist_ok=True)
    train_files = []
    for s, pick in enumerate((img_train <= split_at, img_train > split_at)):
        rows = np.flatnonzero(pick)
        qs = [{"question_id": 1_000_000 + int(i), "image_id": int(img_train[i]),
               "question": " ".join(qwords[i])} for i in rows]
        an = [{"question_id": 1_000_000 + int(i), "image_id": int(img_train[i]),
               "multiple_choice_answer": answers[labels[i]],
               "answers": [{"answer": answers[labels[i]], "answer_confidence": "yes",
                            "answer_id": 1}]} for i in rows]
        qp, ap = (os.path.join(root, f"train_{s}_questions.json"),
                  os.path.join(root, f"train_{s}_annotations.json"))
        with open(qp, "w") as f:
            json.dump({"questions": qs}, f)
        with open(ap, "w") as f:
            json.dump({"annotations": an}, f)
        train_files.append((qp, ap))
    # val2014: answers from the same Zipf law, 10 raters (7 agree), types
    val_labels = rs.choice(WF_ANSWERS, WF_TEST_QUESTIONS, p=counts / counts.sum())
    img_val = 1 + rs.randint(0, WF_TEST_IMAGES, WF_TEST_QUESTIONS)
    vq, va, vmc = [], [], []
    for i in range(WF_TEST_QUESTIONS):
        toks = [words[int(j)] for j in rs.choice(200, rs.randint(3, 9), p=zipf_w)]
        if i % 20 == 0:
            toks.append(f"unseen{i}")              # a word prepro maps to UNK
        qid, ans = 2_000_000 + i, answers[val_labels[i]]
        atype = ("yes/no" if ans in ("yes", "no") else "number" if ans.isdigit()
                 else "other")
        raters = [ans] * 7 + [answers[int(j)] for j in rs.choice(WF_ANSWERS, 3)]
        rs.shuffle(raters)
        vq.append({"question_id": qid, "image_id": int(img_val[i]),
                   "question": " ".join(toks)})
        va.append({"question_id": qid, "image_id": int(img_val[i]),
                   "question_type": " ".join(toks[:2]), "answer_type": atype,
                   "multiple_choice_answer": ans,
                   "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": k + 1}
                               for k, a in enumerate(raters)]})
        choices = [ans] + [answers[int(j)] for j in rs.choice(WF_ANSWERS, WF_MC - 1,
                                                              replace=False)]
        rs.shuffle(choices)
        vmc.append({**vq[-1], "multiple_choices": choices})
    paths = {"train": train_files}
    for name, key, rows in (("val_questions", "questions", vq),
                            ("val_annotations", "annotations", va),
                            ("val_mc_questions", "questions", vmc)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({key: rows}, f)
    # features: [D, W, H] float32 a unique image, in its source's directory
    gen = np.random.default_rng(int(rs.randint(1 << 30)))
    n_feat = 0
    for split, ids, pick_dir in (
            ("train2014", np.unique(img_train),
             lambda i: feat_dirs[0] if i <= split_at else feat_dirs[1]),
            ("val2014", np.unique(img_val), lambda i: feat_dirs[0])):
        for i in ids:
            t7.save_t7(os.path.join(pick_dir(int(i)), cocofeat_name(split, int(i))),
                       gen.standard_normal(WF_FEAT, dtype=np.float32))
            n_feat += 1
    out.update(paths=paths, feat_dirs=feat_dirs, n_images=n_feat,
               n_train_images=len(np.unique(img_train)), n_test_images=len(np.unique(img_val)),
               n_source_b=int((img_train > split_at).sum()))
    return out


def workflow_phase(seed: int, card: str) -> dict:
    """Phase 12: the paper's workflow through ``rau_vqa_tpu_torch.cli``'s
    ``main`` on ``ours_ms`` at full width: fabricated official VQA v1 files
    -> ``prepro`` (the bundle by data/hdf5.py) -> ``pack-features`` (each
    image's datatype read from the bundle) -> ``train --visatt`` for 2
    epochs -> ``vqa-accuracy`` on hop 1's OE file against the Trainer's own
    official score -> released-format tarballs -> ``verify-released`` and
    ``diagnose-snapshot`` on the true one and on one with mult's two (F, M)
    attention projections swapped; then the fixture-learning gate in four
    configurations.  Returns the launches of this phase's kernels."""
    import glob
    import io
    import shutil
    import tarfile
    import tempfile
    from contextlib import redirect_stdout

    from rau_vqa_tpu_torch import cli
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data import prepro as prepro_mod
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.data.features import (
        PackedFeatureStore, T7DirFeatureSource, coco_feat_name)
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, generate_fixture
    from rau_vqa_tpu_torch.data.loader import (
        load_gt_annotations, load_vqa_data, read_prepro)
    from rau_vqa_tpu_torch.eval.submission import write_results
    from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.train import trainer as trainer_mod
    from rau_vqa_tpu_torch.train.trainer import Trainer, init_train_state
    from rau_vqa_tpu_torch.utils import torch_convert as tc
    from rau_vqa_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    t_phase = time.perf_counter()
    counters = {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
                "train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL,
                "train_hops_fwd_bf16": rth.FWD_BF16_KERNEL,
                "train_hops_bwd_bf16": rth.BWD_BF16_KERNEL}
    for k in counters.values():
        k.launches = 0
    rs = np.random.RandomState(seed + 1600)
    steps = {}

    def run(name, argv, quiet=False):
        """One command through the CLI's main; its seconds and stdout."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = cli.main(["--device", WF_DEVICE] + argv)
        steps[name] = time.perf_counter() - t0
        out = buf.getvalue()
        if not quiet:
            for line in out.strip().splitlines()[-12:]:
                log(f"  {name}| {line}")
        log(f"workflow {name}: exit {rc} in {steps[name]:.3f} s [{card}]")
        return rc, out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_") as root:
        # (a) the official-format files
        t0 = time.perf_counter()
        fab = fabricate_vqa_v1(os.path.join(root, "vqa_v1"), rs)
        steps["fabricate"] = time.perf_counter() - t0
        feat_mb = sum(os.path.getsize(os.path.join(d, f)) for d in fab["feat_dirs"]
                      for f in os.listdir(d)) / 1e6
        log(f"workflow fabricate: {fab['n_train']} train questions on "
            f"{fab['n_train_images']} images ({fab['n_source_b']} in the second source), "
            f"{WF_TEST_QUESTIONS} val on {fab['n_test_images']}, {len(fab['words'])} words, "
            f"{len(fab['answers'])} answers, {fab['n_images']} .t7 features "
            f"({feat_mb:.1f} MB) in {steps['fabricate']:.3f} s")
        p = fab["paths"]
        bundle = os.path.join(root, "bundle")
        # (b) prepro, its h5 captured as written
        written = {}
        write_h5 = prepro_mod.write_h5

        def capture(path, arrays):
            written.update({k: v.copy() for k, v in arrays.items()})
            write_h5(path, arrays)
        prepro_mod.write_h5 = capture
        try:
            rc, out = run("prepro", ["prepro"]
                          + [x for s, (q, a) in enumerate(p["train"])
                             for x in ("--train", "train2014", q, a)]
                          + ["--test", "val2014", p["val_questions"], "--test-annotations",
                             p["val_annotations"], "--test-mc", p["val_mc_questions"],
                             "--out", bundle])
        finally:
            prepro_mod.write_h5 = write_h5
        if rc != 0:
            raise SystemExit(f"workflow: prepro exited {rc}")
        n_q = fab["n_train"] + WF_TEST_QUESTIONS
        log(f"workflow prepro: {n_q / steps['prepro']:.1f} questions/s ({n_q} questions) "
            f"[{card}]")
        m = re.search(r": (\d+) train questions \((\d+) dropped outside the top-(\d+) "
                      r"answers\), (\d+) test, vocab (\d+)", out)
        kept, dropped, n_ans, n_test, vocab = (int(x) for x in m.groups())
        h5_path = os.path.join(bundle, "data_prepro.h5")
        t0 = time.perf_counter()
        info, arrays = read_prepro(bundle)
        read_s = time.perf_counter() - t0
        same = (sorted(arrays) == sorted(written) and all(
            arrays[k].dtype == written[k].dtype and np.array_equal(arrays[k], written[k])
            for k in written))
        log(f"workflow bundle: data_prepro.h5 {os.path.getsize(h5_path)} bytes "
            f"({len(arrays)} datasets), read back by data/hdf5.py in {read_s * 1e3:.2f} ms, "
            f"equal to what was written: {same}; data_prepro.json "
            f"{os.path.getsize(os.path.join(bundle, 'data_prepro.json'))} bytes; vocab "
            f"{vocab} (with UNK), {n_ans} answers, {kept} kept, {dropped} dropped, "
            f"{n_test} test [{card}]")
        if not (vocab == WF_WORDS + 1 and n_ans == 1000 and dropped > 0 and same
                and len(info["ix_to_word"]) == vocab and n_test == WF_TEST_QUESTIONS
                and kept + dropped == fab["n_train"]
                and set(np.unique(arrays["datatype_train"])) == {1, 2}):
            raise SystemExit(f"workflow: the bundle's gates failed: vocab {vocab}, answers "
                             f"{n_ans}, dropped {dropped}, read back equal {same}")
        shard = os.path.join(root, "shard")
        rc, _ = run("pack-features", ["pack-features", "--vqa-dir", bundle, "--feat-dir",
                                      fab["feat_dirs"][0], "--feat-dir", fab["feat_dirs"][1],
                                      "--out", shard, "--cnnout-dim", str(WF_FEAT[0]),
                                      "--cnnout-w", str(WF_FEAT[1]), "--cnnout-h",
                                      str(WF_FEAT[2])])
        # the second source's images are only in the second directory: each
        # image took its datatype from the bundle, and its rows are its file's
        store = PackedFeatureStore(shard)
        rel = info["unique_img_train"]
        dts = np.ones(len(rel), np.int64)
        dts[arrays["img_pos_train"] - 1] = arrays["datatype_train"]
        t7src = T7DirFeatureSource(fab["feat_dirs"], *WF_FEAT)
        picks = [int(np.flatnonzero(dts == d)[0]) for d in (1, 2)]
        names = [coco_feat_name(rel[i]) for i in picks]
        got = np.asarray(store.get_batch(names, [1, 1]), np.float32)
        want = np.asarray(t7src.get_batch(names, [int(dts[i]) for i in picks]), np.float32)
        if rc != 0 or len(store.index) != fab["n_images"] or not np.array_equal(got, want):
            raise SystemExit(f"workflow: pack-features exited {rc}, packed "
                             f"{len(store.index)} of {fab['n_images']} images, rows equal "
                             f"{np.array_equal(got, want)}")
        log(f"workflow pack-features: {len(store.index)} images, datatypes from the bundle "
            f"{ {int(k): int(v) for k, v in zip(*np.unique(dts, return_counts=True))} } "
            f"(train images), rows of "
            f"each source equal its .t7 file")

        # (c) train, as shipped, from the bundle and the shard
        work = os.path.join(root, "run")
        made = []
        init = trainer_mod.Trainer.__init__

        def keep(self, *a, **kw):
            init(self, *a, **kw)
            made.append(self)
        trainer_mod.Trainer.__init__ = keep
        try:
            rc, _ = run("train", ["train", "--preset", "ours_ms", "--vqa-dir", bundle,
                                  "--feat-dir", shard, "--split", "val2014", "--gt-anno",
                                  os.path.join(bundle, "gt_annotations.json"),
                                  "--official-anno", p["val_annotations"], "--epochs", "2",
                                  "--save-dir", work, "--visatt", "--visatt-batches", "1"])
        finally:
            trainer_mod.Trainer.__init__ = init
        tr = made[0]
        H2 = tr.mcfg.n_hops + 2
        trows = tr.logger.read("train")
        tests = tr.logger.read("test")
        losses = [r["loss"] for r in trows]
        log(f"workflow train: {tr.mcfg.n_hops} hops, vocab {tr.mcfg.vocab_size} (with "
            f"ZEROPAD), {tr.mcfg.answer_size} answers, B={tr.tcfg.batch_size}, "
            f"{tr.data.train_data.iter_per_epoch} steps an epoch; epoch losses "
            + " ".join(f"{x:.5f}" for x in losses) + "; epoch s "
            + " ".join(f"{r['sec']:.3f}" for r in trows) + "; trained q/s "
            + " ".join(f"{r['examples_per_sec']:.1f}" for r in trows)
            + f"; testOEacc {max(tests[-1][f'testOEacc_{h + 1:02d}'] for h in range(H2)):.4f} "
            f"best hop [{card}]")
        if rc != 0 or len(losses) != 2 or not all(np.isfinite(losses)) \
                or not losses[1] < losses[0]:
            raise SystemExit(f"workflow: train exited {rc}, epoch losses {losses}")
        pngs = {}
        for e in (1, 2):
            pngs[e] = sorted(glob.glob(os.path.join(work, "figures", f"epoch_{e:03d}",
                                                    "hop_*", "*.png")))
        shapes = {png_shape(f) for e in pngs for f in pngs[e]}
        side = (tr.mcfg.cnn_w * 16, tr.mcfg.cnn_h * 16)
        log(f"workflow visatt: {[len(pngs[e]) for e in (1, 2)]} PNGs in epochs 1 and 2 "
            f"(want {H2} x {tr.data.test_data.batch_size} each), (w, h, depth, colour) "
            f"{sorted(shapes)}")
        if any(len(pngs[e]) != H2 * tr.data.test_data.batch_size for e in pngs) \
                or shapes != {side + (8, 0)}:
            raise SystemExit(f"workflow: attention PNGs {[len(pngs[e]) for e in pngs]}, "
                             f"shapes {shapes}")
        results = os.path.join(work, "results")
        files = {task: sorted(glob.glob(os.path.join(results, "hop_*",
                                                     f"vqa_{task}_*-2.00_results.json")))
                 for task in ("OpenEnded", "MultipleChoice")}
        if any(len(v) != H2 for v in files.values()):
            raise SystemExit(f"workflow: submission files {files}")
        # the sweep with and without the dumps, on the trained Trainer
        torch.cuda.synchronize()
        sweep = {}
        for dumps in (True, False, True, False):
            tr.exp = tr.exp.replace(visatt=dumps)
            t0 = time.perf_counter()
            tr.evaluate(write_submissions=False)
            torch.cuda.synchronize()
            sweep.setdefault(dumps, []).append((time.perf_counter() - t0) * 1e3)
        log(f"workflow sweep: {tr.data.test_data.num_examples} questions in batches of "
            f"{tr.data.test_data.batch_size}: {min(sweep[False]):.2f} ms without the PNG "
            f"dumps, {min(sweep[True]):.2f} ms with one batch's {H2 * tr.data.test_data.batch_size} "
            f"(each the best of 2: {sweep}) [{card}]")

        # (d) vqa-accuracy on hop 1's OE file against the Trainer's score
        report = os.path.join(root, "vqa_accuracy.json")
        hop1 = [f for f in files["OpenEnded"] if f"{os.sep}hop_01{os.sep}" in f][0]
        rc, _ = run("vqa-accuracy", ["vqa-accuracy", "--results", hop1, "--annotations",
                                     p["val_annotations"], "--out", report, "--precision",
                                     "6"])
        with open(report) as f:
            overall = json.load(f)["overall"]
        official = tests[-1]["testOEaccOfficial_01"]
        log(f"workflow vqa-accuracy: overall {overall!r} vs the Trainer's "
            f"testOEaccOfficial[0] x 100 = {100 * official!r} (bar 1e-9)")
        if rc != 0 or abs(overall - 100 * official) > 1e-9:
            raise SystemExit(f"workflow: vqa-accuracy {overall} vs {100 * official}")

        # (e) released-format tarballs from the last snapshot
        t0 = time.perf_counter()
        snap_pt = latest_checkpoint(tr.ckpt_dir)
        template = init_train_state(tr.mcfg, 0, device="cpu")._asdict()
        tree, meta = load_checkpoint(snap_pt, template)
        epoch = float(meta["epoch"])
        rel_root = os.path.join(root, "released", "save_result_vqa_val2014")
        os.makedirs(os.path.join(rel_root, "snapshot"))
        snap_t7 = os.path.join(rel_root, "snapshot",
                               f"snapshot_iter{int(meta['step']):06d}_epoch{epoch:.2f}.t7")
        opt = {"nhop": float(tr.mcfg.n_hops), "alg_name": tr.exp.alg_name,
               "cnnout_dim": float(tr.mcfg.cnn_dim), "cnnout_w": float(tr.mcfg.cnn_w),
               "cnnout_h": float(tr.mcfg.cnn_h)}
        tc.export_snapshot(snap_t7, tree["params"], tr.mcfg, it=int(meta["step"]),
                           epoch=epoch, opt=opt)
        for task, fs in files.items():
            rows = []
            for f in fs:
                with open(f) as fh:
                    rows.append(json.load(fh))
            write_results(rel_root, task, "val2014", tr.exp.alg_name, epoch, rows)

        def tar(src, path):
            with tarfile.open(path, "w:gz", compresslevel=1) as tf:
                tf.add(src, arcname=os.path.basename(src))
        good = os.path.join(root, "released_good.tar.gz")
        tar(rel_root, good)
        # the swapped twin: att_q and att_i, both (F, M), trade places
        layout = list(tc.GROUP_LAYOUTS["mult"](tr.mcfg))
        pos = {e[0]: i for i, e in enumerate(layout)}
        for leaf in ("w", "b"):
            i, j = pos[("mult", "att_q", leaf)], pos[("mult", "att_i", leaf)]
            layout[i], layout[j] = layout[j], layout[i]
        snap = t7.load_t7(snap_t7)
        flats = tc.flats_from_snapshot(snap)
        flats[2] = tc.group_to_flat(tree["params"]["mult"], tr.mcfg, "mult", layout=layout)
        swapped_root = os.path.join(root, "swapped", "save_result_vqa_val2014")
        shutil.copytree(rel_root, swapped_root)
        t7.save_t7(os.path.join(swapped_root, "snapshot", os.path.basename(snap_t7)),
                   {"it": snap["it"], "epoch": snap["epoch"], "params": flats,
                    "opt": snap["opt"]})
        bad = os.path.join(root, "released_swapped.tar.gz")
        tar(swapped_root, bad)
        steps["tarballs"] = time.perf_counter() - t0
        log(f"workflow tarballs: {os.path.getsize(good) / 1e6:.1f} MB and "
            f"{os.path.getsize(bad) / 1e6:.1f} MB (snapshot .t7 "
            f"{os.path.getsize(snap_t7) / 1e6:.1f} MB, float64) in {steps['tarballs']:.3f} s")
        common = ["--preset", "ours_ms", "--vqa-dir", bundle, "--feat-dir", shard,
                  "--split", "val2014", "--gt-anno", os.path.join(bundle, "gt_annotations.json"),
                  "--official-anno", p["val_annotations"]]
        reports = {}
        for name, tb in (("verify-released", good), ("verify-released swapped", bad)):
            wd = os.path.join(root, name.replace(" ", "_"))
            rc, _ = run(name, ["verify-released", "--tarball", tb, "--save-dir", wd] + common)
            with open(os.path.join(wd, "verify_released_report.json")) as f:
                reports[name] = (rc, json.load(f))
        (rc_good, rep_good), (rc_bad, rep_bad) = reports.values()
        log(f"workflow verify-released: min_agree {rep_good['min_agree']!r} (exit {rc_good}); "
            f"swapped pair {rep_bad['min_agree']!r} (exit {rc_bad})")
        if rc_good != 0 or rep_good["min_agree"] != 1.0 or rc_bad != 1:
            raise SystemExit(f"workflow: verify-released exits {rc_good} (min_agree "
                             f"{rep_good['min_agree']}) and {rc_bad} on the swapped pair")
        dims = ["--vocab-size", str(tr.mcfg.vocab_size), "--answer-size",
                str(tr.mcfg.answer_size), "--seq-len", str(tr.mcfg.seq_len),
                "--preset", "ours_ms", "--ref-checkpoint", snap_pt]
        outs = {}
        for name, s in (("diagnose-snapshot", snap_t7),
                        ("diagnose-snapshot swapped",
                         os.path.join(swapped_root, "snapshot", os.path.basename(snap_t7)))):
            rc, outs[name] = run(name, ["diagnose-snapshot", "--input", s] + dims, quiet=True)
            for line in outs[name].splitlines():
                if line.startswith(("embed", "rnn", "mult", "  position")):
                    log(f"  {name}| {line}")
            if rc != 0:
                raise SystemExit(f"workflow: {name} exited {rc}")
        d_good, d_bad = outs.values()
        if not (all(f"{g}: order matches GROUP_LAYOUTS" in d_good
                    for g in ("embed", "rnn", "mult"))
                and "mult: ORDER MISMATCH" in d_bad
                and "ours mult/att_q/w vs snapshot mult/att_i/w" in d_bad
                and all(f"{g}: order matches GROUP_LAYOUTS" in d_bad for g in ("embed", "rnn"))):
            raise SystemExit("workflow: diagnose-snapshot did not find the order, or the pair")
        main_path = {k: c.launches for k, c in counters.items()}
        log(f"workflow launches in the commands: {main_path}")
        if main_path["lstm_encode"] < 1 or main_path["rau_hops"] < 1 or any(
                main_path[k] for k in counters if k.startswith("train_hops")):
            raise SystemExit(f"workflow: the sweeps' kernels did not run as expected "
                             f"(the preset trains unfused): {main_path}")

        # (f) the fixture-learning gate, four configurations
        fx = os.path.join(root, "fixture")
        spec = FixtureSpec()
        vqa_dir = generate_fixture(fx, spec)
        gt = load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
        best = {}
        for name, model in (("float32", {}), ("bf16", {"compute_dtype": "bfloat16"}),
                            ("fused float32", {"fused_train": True}),
                            ("fused bf16", {"fused_train": True,
                                            "compute_dtype": "bfloat16"})):
            t0 = time.perf_counter()
            before = {k: c.launches for k, c in counters.items()}
            exp = get_experiment("ours_ms")
            exp = exp.replace(
                model=dataclasses.replace(
                    exp.model, n_hops=2, cnn_dim=spec.feat_dim, cnn_w=spec.feat_w,
                    cnn_h=spec.feat_h, embed_dim=16, rnn_size=16, multfeat_dim=16,
                    attfeat_dim=8, att_rnn_size=16, embed_dropout=0.0, rnn_dropout=0.0,
                    mult_dropout=0.1, **model),
                train=dataclasses.replace(
                    exp.train, batch_size=16, learning_rate=1e-2, mult_learning_rate=1e-2,
                    lr_decay=1.0, mult_lr_decay=1.0, noisy_eta=0.0, grad_clip=10.0,
                    length_buckets=()),
                data=dataclasses.replace(exp.data, split="val2014"),
                # the sweep through the plain float32 predict on the card, as
                # the JAX package's Trainer sweeps by default: the serving
                # encoder kernel takes rnn_size in multiples of 32
                # (ops/lstm_encoder.py lstm_plan), these widths are 16
                fused_eval=False)
            data = load_vqa_data(vqa_dir, 16, split="val2014", test_batch_size=8)
            src = T7DirFeatureSource([os.path.join(fx, "feat")], spec.feat_dim,
                                     spec.feat_w, spec.feat_h)
            t = Trainer(exp, data, src, os.path.join(root, "learn", name.replace(" ", "_")),
                        gt_anno=gt, device=WF_DEVICE)
            t.fit(epochs=WF_LEARN_EPOCHS, eval_each=False)
            oe = t.evaluate()["testOEacc"]
            steps[f"learn {name}"] = time.perf_counter() - t0
            rows = t.logger.read("train")
            best[name] = max(oe)
            ran = {k: c.launches - before[k] for k, c in counters.items()}
            log(f"workflow learn {name}: best OE {best[name]:.4f} (per hop "
                + " ".join(f"{a:.4f}" for a in oe) + f"), {len(rows)} train rows "
                f"({sum(1 for r in rows if r.get('aborted'))} aborted by the guard), last "
                f"loss {[r['loss'] for r in rows if 'loss' in r][-1]:.4f}, "
                f"{time.perf_counter() - t0:.2f} s; launches {ran} [{card}]")
            fused = "fused" in name
            want = ("train_hops_fwd_bf16", "train_hops_bwd_bf16") if "bf16" in name \
                else ("train_hops_fwd", "train_hops_bwd")
            if fused and any(ran[k] < 1 for k in want):
                raise SystemExit(f"workflow learn {name}: the training kernels did not run")
            if not fused and any(ran[k] for k in ran if k.startswith("train_hops")):
                raise SystemExit(f"workflow learn {name}: a training kernel ran unfused")
        log(f"workflow learning gate: best OE {best} (bar > 0.5, chance 0.2) [{card}]")
        if not all(v > 0.5 for v in best.values()):
            raise SystemExit(f"workflow: the fixture was not learned: {best}")
    total = {k: c.launches for k, c in counters.items()}
    log("workflow steps s: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; the phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


EXPORT_LADDER = (8, 16)          # with seq_len 26: the service's buckets
EXPORT_BATCHES = ((1, 8), (83, 16), (512, 26))   # (B, longest question): each bucket
SERVE_BAR = dict(rtol=1e-3, atol=1e-4)            # the service's bar (tests)
BENCH_AGREE = 0.15               # the bench's q/s against the smoke's step timing
EB_DEVICE = "cuda"               # a CPU rehearsal sets "cpu" (and the sizes below)
EB_SIDE = 448                    # the pixels artifact's images (ours_resnet's 14x14 grid)
EB_STEP_B = 512                  # the batch of (d)'s PredictStep timing
EB_PIXELS_ARGS = []              # the pixels bench's flags: its defaults


def _run_cli_json(main, argv):
    """``main(argv)`` in this process with its standard output captured:
    (exit code, its last line as JSON or None, the whole output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    try:
        line = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        line = None
    return rc, line, out


def export_bench_phase(seed: int, card: str) -> dict:
    """13. export_bench: the serving kernels as the rau_vqa:: custom ops in a
    torch.export artifact, the two benches, profile and doctor, through the
    user's entry points; returns each kernel's launches in the phase."""
    import tempfile

    from rau_vqa_tpu_torch import bench, bench_pixels, cli
    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.eval import export as E
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.models.rau import init_params
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    dev = torch.device(EB_DEVICE)
    dev_flag = ["--device", EB_DEVICE]
    counters = {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
                "fused_identity_stage": fused_resnet.KERNEL,
                "train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL}
    start = {k: c.launches for k, c in counters.items()}
    failed = []
    rs = np.random.RandomState(seed + 13)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
        # (a) the predict artifact of a .pt snapshot at full width, ladder 8/16/26
        cfg = get_preset("ours_ms")
        state = init_train_state(cfg, seed, device="cpu")._asdict()
        snap = save_checkpoint(os.path.join(root, "snap"), 1, 1.0, state,
                               extra={"model_config": dataclasses.asdict(cfg)})
        art = os.path.join(root, "predict")
        t0 = time.perf_counter()
        rc, _, out = _run_cli_json(cli.main, dev_flag + [
            "export", "--checkpoint", snap, "--out", art, "--eval-buckets", "8,16"])
        export_s = time.perf_counter() - t0
        mb = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art)) / 1e6
        log(f"export: rc {rc}, {export_s:.2f} s for 3 programs, {mb:.1f} MB "
            f"({out.strip().splitlines()[-1]}) [{card}]")
        run = E.load_exported(art)
        params = map_tree(lambda x: x.to(dev), state["params"])
        step = make_predict_step(cfg, buckets=EXPORT_LADDER, device=dev)
        for B, max_len in EXPORT_BATCHES:
            tokens, lengths, feats = make_batch(cfg, B, max_len, rs, dev)
            with torch.no_grad():
                want = step(params, tokens, lengths, feats)
                k0 = (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches)
                t0 = time.perf_counter()
                got = run(tokens, lengths, feats)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                rose = (lstm_encoder.KERNEL.launches - k0[0], rau_hops.KERNEL.launches - k0[1])
            diff = max((g - w).abs().max().item() for g, w in zip(got, want))
            agree = bool(torch.equal(got[0].argmax(-1), want[0].argmax(-1)))
            log(f"export predict B={B} T<={max_len}: max |artifact - PredictStep| {diff:.3e} "
                f"(bar rtol 1e-3 atol 1e-4), per-hop answers equal {agree}, launches "
                f"{rose} (want (1, 1)), first call {first_s:.3f} s [{card}]")
            try:
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, **SERVE_BAR)
            except AssertionError as e:
                failed.append(f"(a) B={B}: {str(e).splitlines()[0]}")
            if not agree or rose != (1, 1):
                failed.append(f"(a) B={B}: answers equal {agree}, launches {rose}")

        # (b) the pixels artifact of ours_resnet, a folded bf16 ResNet-101, 448 px
        cfg_r = dataclasses.replace(get_preset("ours_resnet"), cnn_w=EB_SIDE // 32,
                                    cnn_h=EB_SIDE // 32)
        params_r = init_params(cfg_r, torch.Generator().manual_seed(seed), dev)
        bb = resnet.fold_batchnorm(resnet.resnet101_init(
            torch.Generator(dev).manual_seed(seed + 1), torch.bfloat16, dev))
        pix = os.path.join(root, "pixels")
        t0 = time.perf_counter()
        E.export_pixels_predict(params_r, cfg_r, "resnet101", bb, pix, image_size=EB_SIDE,
                                device=dev)
        pix_s = time.perf_counter() - t0
        B = 7
        images = torch.as_tensor(
            rs.randint(0, 256, (B, EB_SIDE, EB_SIDE, 3)).astype(np.uint8), device=dev)
        tokens, lengths, _ = make_batch(cfg_r, B, cfg_r.seq_len, rs, dev)
        with torch.no_grad():
            ids, att = pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101", images,
                                              tokens, lengths, device=dev)
            k0 = {k: counters[k].launches for k in ("lstm_encode", "rau_hops",
                                                    "fused_identity_stage")}
            tab_p, att_p = E.load_exported(pix)(images, tokens, lengths)
            torch.cuda.synchronize()
        rose = {k: counters[k].launches - v for k, v in k0.items()}
        diff = (att_p - att).abs().max().item()
        agree = bool(torch.equal(tab_p.argmax(-1), ids))
        log(f"export pixels B={B}: export {pix_s:.2f} s; per-hop answers equal to "
            f"answer_pixels {agree}, max |attention diff| {diff:.3e} (bar rtol 1e-3 atol "
            f"1e-4), launches {rose} (want 1, 1, 4) [{card}]")
        if not agree or rose != {"lstm_encode": 1, "rau_hops": 1, "fused_identity_stage": 4}:
            failed.append(f"(b) answers equal {agree}, launches {rose}")
        try:
            torch.testing.assert_close(att_p, att, **SERVE_BAR)
        except AssertionError as e:
            failed.append(f"(b) attention: {str(e).splitlines()[0]}")

        # (d) the smoke's own timing of PredictStep at B=512, T=26
        tokens, lengths, feats = make_batch(cfg, EB_STEP_B, cfg.seq_len, rs, dev)
        with torch.no_grad():
            step_ms = time_ms(lambda: step(params, tokens, lengths, feats), iters=10)
        smoke_qps = EB_STEP_B / step_ms * 1e3
        log(f"export_bench PredictStep B={EB_STEP_B} T=26: {step_ms:.4f} ms, "
            f"{smoke_qps:.1f} questions/s [{card}]")

        # (c) the two benches at their defaults, live and from an artifact
        lines = {}
        for name, main, argv in (
                ("bench", bench.main, dev_flag),
                ("bench --artifact", bench.main,
                 dev_flag + ["--artifact", os.path.join(root, "chain")]),
                ("bench-pixels", bench_pixels.main, dev_flag + EB_PIXELS_ARGS),
                ("bench-pixels --artifact", bench_pixels.main,
                 dev_flag + EB_PIXELS_ARGS + ["--artifact", os.path.join(root, "pchain")])):
            t0 = time.perf_counter()
            rc, line, _ = _run_cli_json(main, argv)
            print(json.dumps(line), flush=True)
            log(f"{name}: rc {rc}, {time.perf_counter() - t0:.1f} s [{card}]")
            keys = ("metric", "value", "mfu", "device", "power_limit_w", "compile_s",
                    "rig_canary_tflops", "rig_canary_frac_peak")
            if rc != 0 or line is None or any(line.get(k) is None for k in keys) \
                    or "vs_baseline" in line:
                failed.append(f"(c) {name}: rc {rc}, line {line}")
            lines[name] = line or {}
        bench_qps = lines["bench"].get("value", 0.0)
        off = abs(bench_qps / smoke_qps - 1)
        log(f"export_bench: the bench's {bench_qps:.1f} q/s against the smoke's "
            f"{smoke_qps:.1f} at B=512: {off * 100:.1f}% apart (bar {BENCH_AGREE * 100:.0f}%); "
            f"from the artifact {lines['bench --artifact'].get('value')} q/s [{card}]")
        if not off <= BENCH_AGREE:
            failed.append(f"(d) the bench's q/s is {off * 100:.1f}% from the smoke's")

        # (e) profile: 3 fused float32 train steps of ours_ms
        prof_dir = os.path.join(root, "profile")
        t0 = time.perf_counter()
        rc, _, out = _run_cli_json(cli.main, dev_flag + [
            "profile", "--preset", "ours_ms", "--out", prof_dir, "--steps", "3",
            "--fused-train"])
        with open(os.path.join(prof_dir, "trace.json")) as f:
            trace = f.read()
        named = {k: k in trace for k in ("rows_fwd_kernel", "softmax_bwd_kernel",
                                         "cell_bwd_kernel")}
        tail = out.strip().splitlines()[-1]
        log(f"profile: rc {rc}, {time.perf_counter() - t0:.1f} s; key_averages {tail!r}; "
            f"the trace names the training kernels' phases {named} [{card}]")
        if rc != 0:
            failed.append(f"(e) profile rc {rc}")

        # (f) doctor --canary
        t0 = time.perf_counter()
        rc, report, _ = _run_cli_json(cli.main, ["doctor", "--canary"])
        report = report or {}
        c = report.get("canary", {})
        log(f"doctor --canary: rc {rc} healthy {report.get('healthy')} in "
            f"{time.perf_counter() - t0:.1f} s; canary {c.get('tflops')} TFLOP/s bf16 "
            f"against the 989 TFLOP/s dense peak ({c.get('frac_of_peak')}) on "
            f"{c.get('device')} at {c.get('power_limit_w')} W; native_images "
            f"{report.get('native_images', {}).get('status')} [{card}]")
        for k in ("device", "cpu", "build", "native_features", "native_images"):
            log(f"doctor {k}: {report.get(k)}")
        if rc != 0 or not report.get("healthy") or c.get("status") != "ok":
            failed.append(f"(f) doctor rc {rc}, healthy {report.get('healthy')}")
    launches = {k: c.launches - start[k] for k, c in counters.items()}
    log(f"export_bench launches {launches}; export_bench_phase_s="
        f"{time.perf_counter() - t_phase:.1f} [{card}]")
    if failed:
        raise SystemExit("export_bench: " + "; ".join(failed))
    return launches


MESH_DEVICE = "cuda"       # a CPU rehearsal sets "cpu" (and the sizes below)
MESH_B = 100               # the train step's global batch: 50 rows a rank on (2, 1)
MESH_STEPS = 3
MESH_PREDICT_B = 512
MESH_PIXELS_B = 120        # ours_resnet from 448 px images: 60 a rank
MESH_SIDE = 448
MESH_PRECOMPUTE = (16, 224, 8)   # images, side, the single process's batch (a rank's)
MESH_TRAIN = (("dp_fused", (2, 1), False, True), ("dp_unfused", (2, 1), False, False),
              ("tp_fused", (1, 2), True, True))   # (name, mesh, tp, fused_train)
MESH_BAR = dict(rtol=2e-4, atol=2e-5)             # tests/test_parallel.py's, on cls.w


def mesh_inputs(seed: int, dev) -> dict:
    """The inputs of mesh_phase, the same in every process from ``seed``:
    ``ours_ms`` at full width (the preset's dropout and gradient noise; B
    rows and labels), its params, a predict batch, and ``ours_resnet``'s head
    with a folded bf16 ResNet-101 and 448 px images."""
    from rau_vqa_tpu_torch.config import get_preset, get_train_preset
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.models.rau import init_params
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    rs = np.random.RandomState(seed + 14)
    cfg, tcfg = get_train_preset("ours_ms")
    state = init_train_state(cfg, seed, device=dev)
    tokens, lengths, feats = make_batch(cfg, MESH_B, cfg.seq_len, rs, dev)
    labels = torch.as_tensor(rs.randint(0, cfg.answer_size, MESH_B), device=dev)
    predict = make_batch(cfg, MESH_PREDICT_B, cfg.seq_len, rs, dev)
    cfg_r = dataclasses.replace(get_preset("ours_resnet"), cnn_w=MESH_SIDE // 32,
                                cnn_h=MESH_SIDE // 32)
    head_r = init_params(cfg_r, torch.Generator().manual_seed(seed + 2), dev)
    bb = resnet.fold_batchnorm(resnet.resnet101_init(
        torch.Generator().manual_seed(seed + 3), torch.bfloat16, dev))
    p_tokens, p_lengths, _ = make_batch(cfg_r, MESH_PIXELS_B, cfg_r.seq_len, rs, dev)
    images = torch.as_tensor(rs.randint(0, 256, (MESH_PIXELS_B, MESH_SIDE, MESH_SIDE, 3),
                                        dtype=np.uint8), device=dev)
    return {"cfg": cfg, "tcfg": tcfg, "state": state,
            "batch": (tokens, lengths, feats, labels), "predict": predict,
            "cfg_r": cfg_r, "head_r": head_r, "bb": bb,
            "pixels": (images, p_tokens, p_lengths)}


def _mesh_counters():
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    return {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
            "train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL,
            "fused_identity_stage": fused_resnet.KERNEL}


def _mesh_train(inp, name, mesh, tp, fused, pm=None):
    """3 steps of the named configuration: through ``make_sharded_train_step``
    on ``mesh`` (pm: parallel.mesh) on this rank's rows, or ``make_train_step``
    on the whole batch; (losses, whole cls.w, local cls.w shape, ms a step
    over steps 2 and 3, the state)."""
    from rau_vqa_tpu_torch.train.trainer import make_train_step
    cfg = dataclasses.replace(inp["cfg"], fused_train=fused)
    hop_scale = torch.ones(cfg.n_hops, device=inp["state"].params["mult"]["cls"]["w"].device)
    state = inp["state"]
    if pm is None:
        step = make_train_step(cfg, inp["tcfg"], device=hop_scale.device)
        batch = inp["batch"]
    else:
        step = pm.make_sharded_train_step(cfg, inp["tcfg"], mesh, state, tp=tp)
        shardings = pm.state_shardings(mesh, state, tp=tp)
        state = pm.place_state(mesh, state, tp=tp)
        batch = pm.shard_batch(mesh, *inp["batch"])
    local = tuple(state.params["mult"]["cls"]["w"].shape)
    losses, t = [], []
    for i in range(MESH_STEPS):
        sync(hop_scale.device)
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, hop_scale, inp["tcfg"].learning_rate,
                              inp["tcfg"].mult_learning_rate)
        losses.append(float(metrics["loss"]))
        t.append((time.perf_counter() - t0) * 1e3)
    cls_w = state.params["mult"]["cls"]["w"]
    if pm is not None:
        cls_w = pm.gather_state(state, shardings).params["mult"]["cls"]["w"]
    return losses, cls_w.float().cpu(), local, float(np.mean(t[1:])), state


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _allreduce_ms(pm, mesh, n: int, iters: int = 5) -> float:
    """Host ms of one sum of ``n`` float32 over the world (synchronised)."""
    t = torch.ones(n, device=mesh.device)
    pm.all_reduce_(mesh, t, None)
    sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        pm.all_reduce_(mesh, t, None)
    sync(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / iters


def mesh_answer_readings(tab, ref_tab, att, ref_att):
    """(max |score diff|, answers that differ, the largest of one process's
    top-2 score gaps among them, max |attention diff|) of a sharded table
    against one process's at the whole batch: a reading of the kernels'
    batch-size dependence (other tile plans, other bf16 sums, other cuDNN
    algorithms), not of the sharding, which the rows' exact check holds."""
    tab, ref_tab = tab.float().cpu(), ref_tab.float().cpu()
    top2 = ref_tab.topk(2, -1).values
    diff = tab.argmax(-1) != ref_tab.argmax(-1)
    gaps = (top2[..., 0] - top2[..., 1])[diff]
    return ((tab - ref_tab).abs().max().item(), int(diff.sum()),
            gaps.max().item() if gaps.numel() else 0.0,
            (att.float().cpu() - ref_att.float().cpu()).abs().max().item())


def mesh_rows_exact(got, key: str) -> bool:
    """Whether both ranks gathered the same tables, and each rank's rows of
    them are bit for bit what that rank's own single-process call on those
    rows gave (``own``): the sharding and the gather order, exactly."""
    tab, att = got[0][key]["tab"], got[0][key]["att"]
    ok = all(torch.equal(g[key]["tab"], tab) and torch.equal(g[key]["att"], att)
             for g in got)
    for g in got:
        a, b = g["rows"][key]
        ok = ok and torch.equal(tab[:, a:b], g[key]["own_tab"]) \
            and torch.equal(att[:, a:b], g[key]["own_att"])
    return ok


def mesh_rank_main(workdir: str, seed: int) -> int:
    """One rank of mesh_phase (b), on the one card beside the other (gloo):
    the train configurations of MESH_TRAIN, sharded predict and sharded
    answer_pixels on this rank's rows, the gloo all-reduce of the gradient's
    size; its readings and kernel launches to ``workdir/rank<r>.pt``."""
    import torch.distributed as dist

    from rau_vqa_tpu_torch.convert import tree_leaves
    from rau_vqa_tpu_torch.parallel import mesh as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.init_distributed(device=MESH_DEVICE)
    inp = mesh_inputs(seed, dev)
    meshes = {(2, 1): pm.make_mesh(2, 1), (1, 2): pm.make_mesh(1, 2)}
    counters = _mesh_counters()
    for k in counters.values():
        k.launches = 0
    out = {}
    for name, shape, tp, fused in MESH_TRAIN:
        losses, cls_w, local, ms, _ = _mesh_train(inp, name, meshes[shape], tp, fused, pm)
        out[name] = {"losses": losses, "cls_w": cls_w, "local": local, "ms": ms}
    dp = meshes[(2, 1)]
    fn, placed = pm.make_sharded_predict(inp["cfg"], dp, inp["state"].params)
    tab, att = fn(placed, *pm.shard_batch(dp, *inp["predict"]))
    out["predict"] = {"tab": tab.cpu(), "att": att.float().cpu()}
    stage0 = counters["fused_identity_stage"].launches
    fn = pm.make_sharded_pixels_predict(inp["cfg_r"], dp, inp["head_r"], "resnet101")
    tab, att = fn(inp["head_r"], inp["bb"], *pm.shard_batch(dp, *inp["pixels"]))
    out["pixels"] = {"tab": tab.cpu(), "att": att.float().cpu(),
                     "stage_launches": counters["fused_identity_stage"].launches - stage0}
    sync(dev)
    out["launches"] = {k: c.launches for k, c in counters.items()}
    # the references, not counted: this rank's rows through PredictStep and
    # pixels_tables in this process alone
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.models import pipeline
    rows = pm.rank_rows(dp, MESH_PREDICT_B), pm.rank_rows(dp, MESH_PIXELS_B)
    out["rows"] = {"predict": (rows[0].start, rows[0].stop),
                   "pixels": (rows[1].start, rows[1].stop)}
    tab, att = make_predict_step(inp["cfg"], device=dev)(
        inp["state"].params, *pm.shard_batch(dp, *inp["predict"]))
    out["predict"].update(own_tab=tab.cpu(), own_att=att.float().cpu())
    tab, att = pipeline.pixels_tables(inp["head_r"], inp["bb"], inp["cfg_r"], "resnet101",
                                      *pm.shard_batch(dp, *inp["pixels"]), device=dev)
    out["pixels"].update(own_tab=tab.cpu(), own_att=att.float().cpu())
    n = sum(t.numel() for t in tree_leaves(inp["state"].params))
    out["allreduce"] = {"n": n, "ms": _allreduce_ms(pm, dp, n)}
    out["backend"] = dist.get_backend()
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()
    return 0


def _spawn(cmd, n_env: int = 0, port: str = "", timeout: float = 300.0):
    """Start ``cmd`` (as rank i of n_env when n_env) in its own session."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(n_env or 1):
        if n_env:
            env = dict(env, RANK=str(r), WORLD_SIZE=str(n_env), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n_env), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port)
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      start_new_session=True))
    return procs


def _finish(procs, what: str, timeout: float) -> list:
    """Wait for ``procs``; on a failure or past ``timeout`` kill every one
    of them (their sessions) and raise."""
    outs, failed = [], []
    deadline = time.time() + timeout
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"{what} process {i} exited {p.returncode}:\n{out[-3000:]}")
    except subprocess.TimeoutExpired:
        failed.append(f"{what} outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    if failed:
        raise SystemExit("mesh: " + "\n".join(failed))
    return outs


def _free_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _torchrun(args, n: int = 2):
    return _spawn([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                   "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
                   "--master-port", _free_port(), "-m", "rau_vqa_tpu_torch.cli"] + args)


def _run_summary(workdir: str) -> dict:
    """A train run's step count, head bias and last sweep (from its last
    snapshot and its log)."""
    from rau_vqa_tpu_torch.utils.checkpoint import latest_checkpoint
    snap = torch.load(latest_checkpoint(os.path.join(workdir, "snapshot")),
                      map_location="cpu", weights_only=True)
    with open(os.path.join(workdir, "training_log", "metrics.jsonl")) as f:
        tests = [r for r in map(json.loads, f) if r.get("kind") == "test"]
    oe = {k: v for k, v in tests[-1].items() if k.startswith("testOEacc")}
    return {"step": int(snap["step"]), "cls_b": snap["params"]["mult"]["cls"]["b"].float(),
            "oe": oe, "sweeps": len(tests)}


def mesh_phase(seed: int, card: str) -> dict:
    """14. mesh: parallel/mesh.py's DP and TP on the card.  (a) a world of 1
    on NCCL: the sharded step on mesh (1, 1) bit for bit make_train_step's,
    sharded predict PredictStep's; (b) 2 ranks on the one card over gloo
    (subprocesses of this script) against one process on the same inputs;
    (c) ``train --mesh-data 2`` and ``precompute-features --mesh-data 2``
    under ``torch.distributed.run`` against one process; (d) times.  Returns
    the kernels' launches in the phase's main path ((a) and (b)) and its
    readings."""
    import tempfile

    import torch.distributed as dist

    from rau_vqa_tpu_torch.convert import tree_leaves
    from rau_vqa_tpu_torch.data.features import PackedFeatureStore
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import vgg
    from rau_vqa_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    # TF32 off here, as main() and the ranks set it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if MESH_DEVICE == "cuda":
        # built once here before the ranks load them (a no-op after phase 2)
        from rau_vqa_tpu_torch.ops import _build
        _build.build_all(["lstm_encoder", "rau_hops", "rau_train_hops_fwd",
                          "rau_train_hops_bwd", "fused_resnet"])
    counters = _mesh_counters()
    failed = []
    readings = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        # (b) starts first: its ranks load while (a) runs here
        ranks = _spawn([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                        "--mesh-rank", root], n_env=2, port=_free_port())
        # (a) a world of 1 on NCCL; the single-process references first
        dev = pm.init_distributed(device=MESH_DEVICE)
        backend = dist.get_backend()
        inp = mesh_inputs(seed, dev)
        one = pm.make_mesh(1, 1)
        ref = _mesh_train(inp, "dp_fused", None, False, True)
        want = make_predict_step(inp["cfg"], device=dev)(inp["state"].params, *inp["predict"])
        # the mesh path's launches: the sharded runs here and on the ranks
        for k in counters.values():
            k.launches = 0
        got = _mesh_train(inp, "dp_fused", one, False, True, pm)
        fn, placed = pm.make_sharded_predict(inp["cfg"], one, inp["state"].params)
        have = fn(placed, *pm.shard_batch(one, *inp["predict"]))
        sync(dev)
        main_launches = {k: c.launches for k, c in counters.items()}
        equal = ref[0] == got[0] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(ref[4].params),
                                              tree_leaves(got[4].params)))
        log(f"mesh (a) world 1 on {backend}: make_sharded_train_step on (1, 1), fused "
            f"float32, B={MESH_B}, {MESH_STEPS} steps: losses {got[0]} against "
            f"make_train_step's {ref[0]}; loss and every parameter bit-equal: {equal}")
        if not equal or backend != ("nccl" if MESH_DEVICE == "cuda" else "gloo"):
            failed.append(f"(a) world 1: bit-equal {equal}, backend {backend}")
        # the training kernels on a rank's rows: rows 50..99 of the batch at
        # row0 = 50 against their plain versions there, and against the
        # whole batch's rows (the global row keys the masks)
        from rau_vqa_tpu_torch.ops import rau_train_hops as rth
        cfg_f = dataclasses.replace(inp["cfg"], fused_train=True)
        mp = inp["state"].params["mult"]
        feats = inp["batch"][2]
        q = torch.as_tensor(0.5 * np.random.RandomState(seed + 15).randn(
            MESH_B, cfg_f.rnnout_dim).astype(np.float32), device=dev)
        seed_t = torch.tensor([1234], dtype=torch.int32, device=dev)
        h = MESH_B // 2
        whole = rth.train_hops_fwd(mp, cfg_f, q, feats, seed_t)
        half = rth.train_hops_fwd(mp, cfg_f, q[h:].contiguous(), feats[h:].contiguous(),
                                  seed_t, row0=h)
        plain = rth.train_hops_fwd_reference(mp, cfg_f, q[h:], feats[h:], seed_t, row0=h)
        f_err = max((a - b).abs().max().item() for a, b in zip(half, plain))
        w_err = max((a[:, h:] - b).abs().max().item() for a, b in zip(whole[:3], half[:3]))
        gm = 1e-3 * torch.randn(cfg_f.n_hops, MESH_B - h, cfg_f.multfeat_dim, device=dev,
                                generator=torch.Generator(dev).manual_seed(seed))
        args = (mp, cfg_f, q[h:].contiguous(), feats[h:].contiguous(), seed_t, half[3],
                half[4], gm)
        em, g = rth.train_hops_bwd(*args, row0=h)
        em_r, g_r = rth.train_hops_bwd_reference(*args, row0=h)
        b_err = max([norm_rel(em[k].float(), em_r[k].float()) for k in em]
                    + [norm_rel(g[k], g_r[k]) for k in g])
        log(f"mesh (a) training kernels at row0={h} on rows {h}..{MESH_B - 1}: forward "
            f"against its plain version max |diff| {f_err:.3e} (bar 1e-4), against the "
            f"whole batch's rows {w_err:.3e} (bar 1e-4); backward worst norm-relative "
            f"{b_err:.3e} (bar 1e-3)")
        if not (f_err <= 1e-4 and w_err <= 1e-4 and b_err <= 1e-3):
            failed.append(f"(a) training kernels at row0: forward {f_err:.3e} / {w_err:.3e}, "
                          f"backward {b_err:.3e}")
        p_equal = all(torch.equal(a, b) for a, b in zip(have, want))
        log(f"mesh (a) make_sharded_predict on (1, 1) at B={MESH_PREDICT_B}: tables equal "
            f"PredictStep's: {p_equal}")
        if not p_equal:
            failed.append("(a) sharded predict differs from PredictStep at world 1")
        # (d) one all-reduce of the gradient's size over NCCL at world 1
        n_grad = sum(t.numel() for t in tree_leaves(inp["state"].params))
        readings["nccl_allreduce_ms"] = _allreduce_ms(pm, one, n_grad, iters=20)
        log(f"mesh (d) all-reduce of {n_grad} float32 ({n_grad * 4 / 1e6:.1f} MB) over "
            f"{backend} at world 1: {readings['nccl_allreduce_ms']:.4f} ms [{card}]")
        dist.destroy_process_group()

        # (b) the single-process references on the same inputs
        refs = {name: _mesh_train(inp, name, None, tp, fused)
                for name, _, tp, fused in MESH_TRAIN}
        px_tab, px_att = pipeline.pixels_tables(inp["head_r"], inp["bb"], inp["cfg_r"],
                                                "resnet101", *inp["pixels"], device=dev)
        sync(dev)
        outs = _finish(ranks, "the 2-rank mesh", 600)
        got = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
               for r in range(2)]
        M, A = inp["cfg"].multfeat_dim, inp["cfg"].answer_size
        for name, shape, tp, fused in MESH_TRAIN:
            r0 = got[0][name]
            losses, cls_w = refs[name][0], refs[name][1]
            loss_ok = np.allclose(r0["losses"][-1], losses[-1], rtol=2e-4, atol=0)
            w_err = (r0["cls_w"] - cls_w).abs().max().item()
            w_ok = torch.allclose(r0["cls_w"], cls_w, **MESH_BAR)
            same = torch.equal(got[1][name]["cls_w"], r0["cls_w"])
            want_local = (M, A // 2) if tp else (M, A)
            log(f"mesh (b) {name} on {shape} over {got[0]['backend']}: losses {r0['losses']} "
                f"against one process's {losses} (last within rtol 2e-4: {loss_ok}); cls.w "
                f"max |diff| {w_err:.3e} (bar rtol 2e-4 atol 2e-5: {w_ok}); ranks equal "
                f"{same}; cls.w a rank {r0['local']} (want {want_local})")
            if not (loss_ok and w_ok and same and r0["local"] == want_local
                    and got[1][name]["local"] == want_local):
                failed.append(f"(b) {name}: loss {loss_ok}, cls.w {w_ok}, ranks {same}, "
                              f"local {r0['local']}")
        # the answers: each rank's rows of the gathered tables are bit for
        # bit its own single-process call's on those rows; against one
        # process at the whole batch, a reading (the ranks' smaller batches
        # take other tile plans, bf16 sums and cuDNN algorithms)
        for what, key, ref_tab, ref_att in (("predict", "predict", want[0], want[1]),
                                            ("answer_pixels", "pixels", px_tab, px_att)):
            exact = mesh_rows_exact(got, key)
            tab, att = got[0][key]["tab"], got[0][key]["att"]
            d, n_diff, gap, a_err = mesh_answer_readings(tab, ref_tab, att, ref_att)
            log(f"mesh (b) sharded {what} at B={tab.shape[1]}: each rank's rows of the "
                f"gathered tables and attention bit-equal to its own call on those rows, "
                f"the same on both ranks: {exact}; against one process at B={tab.shape[1]} "
                f"(a reading): {n_diff} of {tab.shape[0] * tab.shape[1]} answers differ, "
                f"their largest top-2 gap {gap:.3e}, scores max |diff| {d:.3e}, attention "
                f"{a_err:.3e}")
            if not exact:
                failed.append(f"(b) sharded {what}: a rank's rows differ from its own call's")
        stage = [g["pixels"]["stage_launches"] for g in got]
        log(f"mesh (b) stage-kernel launches a rank in its answer_pixels call: {stage}")
        if min(stage) < 4:
            failed.append(f"(b) sharded answer_pixels: stage launches {stage}")
        launches = {k: main_launches[k] + got[0]["launches"][k] + got[1]["launches"][k]
                    for k in counters}
        log(f"mesh launches (the sharded runs of (a) here and of (b) on 2 ranks): "
            f"{launches}")
        if min(launches.values()) < 1:
            failed.append(f"a kernel of the mesh path never launched: {launches}")

        # (d) the 2-rank step against the single step; gloo's all-reduce
        readings["step_ms"] = {"single": refs["dp_fused"][3],
                               "two_ranks": got[0]["dp_fused"]["ms"]}
        readings["gloo_allreduce_ms"] = got[0]["allreduce"]["ms"]
        log(f"mesh (d) fused float32 step B={MESH_B}: one process {refs['dp_fused'][3]:.2f} "
            f"ms, 2 ranks on one card over gloo {got[0]['dp_fused']['ms']:.2f} ms; "
            f"all-reduce of {got[0]['allreduce']['n']} float32 over gloo (2 ranks, one "
            f"card) {readings['gloo_allreduce_ms']:.3f} ms [{card}]")
        del outs

        # (c) the user's entry points under torch.distributed.run against one
        # process of the same command (the CLI's own defaults, TF32 included),
        # all four at once
        n_img, side, batch = MESH_PRECOMPUTE
        img_root = os.path.join(root, "images")
        os.makedirs(os.path.join(img_root, "val2014"))
        rs = np.random.RandomState(seed + 140)
        rel = []
        for i in range(n_img):
            p = f"val2014/COCO_val2014_{i:012d}.png"
            with open(os.path.join(img_root, p), "wb") as f:
                f.write(png_bytes(rs.randint(0, 256, (side, side, 3)).astype(np.uint8)))
            rel.append(p)
        tree = vgg.vgg16_pool5_init(torch.Generator().manual_seed(seed + 141), device="cpu")
        pth = os.path.join(root, "vgg16.pth")
        torch.save({f"features.{i}.{k}": (c["w"].permute(3, 2, 0, 1) if k == "weight"
                                          else c["b"])
                    for i, c in zip(vgg.TORCH_CONV_INDICES, tree["convs"])
                    for k in ("weight", "bias")}, pth)
        dev_flag = ["--device", MESH_DEVICE]
        train = ["train", "--preset", "ours_ms", "--fixture", "--epochs", "2",
                 "--plain-eval"]
        pre = ["precompute-features", "--image-root", img_root, "--backbone", "vgg16",
               "--backbone-state", pth, "--size", str(side), "--backend", "pil"]
        t0 = time.perf_counter()
        one_cli = [sys.executable, "-m", "rau_vqa_tpu_torch.cli"] + dev_flag
        runs = (_torchrun(dev_flag + train + ["--save-dir", os.path.join(root, "t2"),
                                              "--mesh-data", "2"])
                + _torchrun(dev_flag + pre + ["--out", os.path.join(root, "p2"),
                                              "--batch", str(2 * batch), "--mesh-data", "2"])
                + _spawn(one_cli + train + ["--save-dir", os.path.join(root, "t1")])
                + _spawn(one_cli + pre + ["--out", os.path.join(root, "p1"),
                                          "--batch", str(batch)]))
        outs = _finish(runs[:2], "train under torch.distributed.run", 300)
        _finish(runs[2:4], "precompute-features under torch.distributed.run", 300)
        _finish(runs[4:], "the single-process train and precompute-features", 300)
        c_s = time.perf_counter() - t0
        one, two = _run_summary(os.path.join(root, "t1")), _run_summary(os.path.join(root, "t2"))
        b_ok = torch.allclose(two["cls_b"], one["cls_b"], rtol=1e-4, atol=1e-6)
        oe_ok = one["oe"].keys() == two["oe"].keys() and all(
            abs(two["oe"][k] - one["oe"][k]) <= 1e-6 for k in one["oe"])
        gloo = "backend gloo" in outs[0]
        log(f"mesh (c) train --mesh-data 2 under torch.distributed.run (gloo: {gloo}) "
            f"against one process: steps {two['step']} / {one['step']}, head bias within "
            f"1e-4/1e-6: {b_ok}, sweeps {two['sweeps']} / {one['sweeps']}, OE equal: {oe_ok}")
        if not (gloo and b_ok and oe_ok and two["step"] == one["step"] > 0
                and two["sweeps"] == one["sweeps"]):
            failed.append(f"(c) train: steps {two['step']}/{one['step']}, bias {b_ok}, "
                          f"OE {oe_ok}")
        names = sorted(os.listdir(os.path.join(root, "p1")))
        byte_equal = sorted(os.listdir(os.path.join(root, "p2"))) == names and all(
            open(os.path.join(root, "p1", n), "rb").read()
            == open(os.path.join(root, "p2", n), "rb").read() for n in names)
        n_rows = len(PackedFeatureStore(os.path.join(root, "p2")).index)
        log(f"mesh (c) precompute-features --mesh-data 2 --batch {2 * batch} ({n_rows} images, "
            f"{side} px) against one process at --batch {batch}: shard byte-equal "
            f"{byte_equal}; (c) took {c_s:.1f} s")
        if not byte_equal or n_rows != n_img:
            failed.append(f"(c) precompute-features: byte-equal {byte_equal}, rows {n_rows}")
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh_phase_s={readings['phase_s']:.1f} [{card}]")
    if failed:
        raise SystemExit("mesh: " + "; ".join(failed))
    return {"launches": launches, "readings": readings}


VAR_DEVICE = "cuda"        # a CPU rehearsal sets "cpu" (and the sizes below)
VAR_B = 120                # the transforms' and the s2d / int8 backbones' batch
VAR_SRC = (480, 640)       # COCO's usual image size, the transforms' source
VAR_SIDE = 448             # ours_resnet's input side: 14x14 features
VAR_TEN_B = 16             # ten_crop's batch
VAR_CHECK = 8              # rows of each transform held against the CPU copy
VAR_INT8_B = 2             # the int8 shape classes' batch
VAR_SHRUNK_SIDE = 64       # the shrunk int8 net's input (the JAX test's)
VAR_BENCH_ARGS = ["--chain", "2", "--rounds", "2"]
TRANSFORM_BAR = 1e-4       # the card against the CPU copy, TF32 off, absolute
STEM_BAR = dict(rtol=1e-4, atol=1e-5)   # the JAX package's for the s2d stem


def variants_phase(seed: int, card: str) -> dict:
    """15. variants: (a) the image transforms at VAR_B 480x640 images against
    the same function on a CPU copy of their first rows, on the same draws;
    (b) ``answer_pixels`` for ``ours_resnet`` on the s2d tree of the pixels
    phase's folded bf16 ResNet-101, at the pixels phase's bf16 gates against
    the 7x7 tree, and the stem alone in float32 at JAX's bar; (c) the int8
    mode: each conv shape class's int32 accumulators on the card bit-equal to
    the CPU's, the shrunk net against float32 at JAX's bars, the full
    ResNet-101's readings; (d) ``bench_torch_pixels.py --s2d`` and
    ``--int8``.  Returns the kernels' launches in (b) and (d)."""
    from rau_vqa_tpu_torch import bench_pixels
    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.eval.predict import predict, predict_fused
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.models.rau import init_params
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
    from rau_vqa_tpu_torch.ops import transforms as T

    t_phase = time.perf_counter()
    dev, cpu, bf16 = torch.device(VAR_DEVICE), torch.device("cpu"), torch.bfloat16
    rs = np.random.RandomState(seed + 15)
    kernels = {"fused_identity_stage": fused_resnet.KERNEL, "lstm_encode": lstm_encoder.KERNEL,
               "rau_hops": rau_hops.KERNEL}
    launches = dict.fromkeys(kernels, 0)
    failed = []
    B, side, n = VAR_B, VAR_SIDE, VAR_CHECK

    # (a) the transforms: each public function on the card (draw, then
    # apply), its ms, and its apply on the CPU copy of the first rows with
    # those rows' draws
    u8 = torch.as_tensor(rs.randint(0, 256, (B, *VAR_SRC, 3), dtype=np.uint8), device=dev)
    img = u8.float() / 255.0
    gen = torch.Generator(dev).manual_seed(seed)
    cases = (
        ("scale_shorter_side", lambda x, g: (), lambda x: T.scale_shorter_side(x, side)),
        ("center_crop", lambda x, g: (), lambda x: T.center_crop(x, side)),
        ("random_sized_crop", lambda x, g: T.random_sized_crop_draw(x, g),
         lambda x, *d: T.random_sized_crop_at(x, *d, side)),
        ("color_jitter", lambda x, g: T.color_jitter_draw(x, g),
         lambda x, order, alphas: T.color_jitter_at(x, order, alphas)),
        ("lighting", lambda x, g: (T.lighting_draw(x, g, 0.1),), T.lighting_at),
        ("horizontal_flip", lambda x, g: (T.horizontal_flip_draw(x, g),),
         T.horizontal_flip_at),
        ("rotation", lambda x, g: (T.rotation_draw(x, g, 10.0),), T.rotation_at),
        ("random_scale_crop", lambda x, g: T.random_scale_crop_draw(x, g, side, 512, side),
         lambda x, *d: T.random_scale_crop_at(x, *d, side)),
    )
    public = {"random_sized_crop": lambda x, g: T.random_sized_crop(x, g, side),
              "color_jitter": lambda x, g: T.color_jitter(x, g, brightness_var=0.4,
                                                          contrast_var=0.4,
                                                          saturation_var=0.4),
              "lighting": lambda x, g: T.lighting(x, g, 0.1),
              "horizontal_flip": T.horizontal_flip,
              "rotation": lambda x, g: T.rotation(x, g, 10.0),
              "random_scale_crop": lambda x, g: T.random_scale_crop(x, g, side, 512, side)}
    # the eval chain (scale, centre crop), the training chain (sized crop,
    # jitter, lighting, flip), then rotation and the scale-and-crop on the
    # source images
    inputs = {"scale_shorter_side": img, "random_sized_crop": img, "rotation": img,
              "random_scale_crop": img}
    x = img
    t_ms = {}
    with torch.no_grad():
        for name, draw, apply in cases:
            x = inputs.get(name, x)
            d = draw(x, gen)
            y = apply(x, *d)
            # the first n rows' draws (color_jitter's: its order, alphas [3, B])
            cut = (d[0], d[1][:, :n].to(cpu)) if name == "color_jitter" else \
                tuple(v[:n].to(cpu) for v in d)
            err = (y[:n].to(cpu) - apply(x[:n].to(cpu), *cut)).abs().max().item()
            fn = public.get(name)
            t_ms[name] = time_ms((lambda: fn(x, gen)) if fn else (lambda: apply(x, *d)),
                                 iters=5, warmup=1)
            log(f"variants (a) {name}: {tuple(x.shape)} -> {tuple(y.shape)}, card against "
                f"the CPU on {n} rows max_abs_err {err:.3e} (bar {TRANSFORM_BAR}), "
                f"{t_ms[name]:.4f} ms B={B} [{card}]")
            if not (torch.isfinite(y).all() and err <= TRANSFORM_BAR):
                failed.append(f"(a) {name}: max_abs_err {err:.3e}")
            if name in ("center_crop", "horizontal_flip"):
                log(f"variants (a) the {'eval' if name == 'center_crop' else 'training'} "
                    f"chain ends in {tuple(y.shape)}")
            x = y
        x = img[:VAR_TEN_B]
        y = T.ten_crop(x, side)
        err = (y.to(cpu) - T.ten_crop(x.to(cpu), side)).abs().max().item()
        t_ms["ten_crop"] = time_ms(lambda: T.ten_crop(x, side), iters=5, warmup=1)
        log(f"variants (a) ten_crop: {tuple(x.shape)} -> {tuple(y.shape)}, max_abs_err "
            f"{err:.3e}, {t_ms['ten_crop']:.4f} ms B={VAR_TEN_B} [{card}]")
        if tuple(y.shape) != (10, VAR_TEN_B, side, side, 3) or err > TRANSFORM_BAR:
            failed.append(f"(a) ten_crop: {tuple(y.shape)}, max_abs_err {err:.3e}")
        del u8, img, x, y, inputs

    # (b) the s2d stem on the pixels phase's tree (the same seeds)
    cfg = dataclasses.replace(get_preset("ours_resnet"), cnn_w=side // 32, cnn_h=side // 32)
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    bb = resnet.fold_batchnorm(resnet.resnet101_init(
        torch.Generator().manual_seed(seed + 1), bf16, dev))
    bb_f32 = map_tree(lambda t: t.float(), bb)
    s2d = resnet.space_to_depth_stem(bb)
    images = torch.as_tensor(rs.randint(0, 256, (B, side, side, 3), dtype=np.uint8),
                             device=dev)
    tokens, lengths, _ = make_batch(cfg, B, cfg.seq_len, rs, dev)
    for k in kernels.values():
        k.launches = 0
    out = pipeline.answer_pixels(params, s2d, cfg, "resnet101", images, tokens, lengths,
                                 device=dev)
    sync(dev)
    got = {name: k.launches for name, k in kernels.items()}
    log(f"variants (b) answer_pixels on the s2d tree: launches {got}")
    if got != {"fused_identity_stage": 4, "lstm_encode": 1, "rau_hops": 1}:
        failed.append(f"(b) answer_pixels on the s2d tree launched {got}")
    for name in launches:
        launches[name] += got[name]
    head_w = pipeline._head_weights(params)
    f32_cache = {}

    def f32_feats(im):
        if "f" not in f32_cache:
            with torch.no_grad():
                f32_cache["f"] = pipeline.extract_features("resnet101", bb_f32, im)
        return f32_cache["f"]

    pooled = {"ids": 0, "plain_f32": 0, "ref_f32": 0}
    pixels_gates(
        "variants (b) s2d", cfg, [(out, (images, tokens, lengths))],
        plain=lambda im, t, ln: (pipeline.pixels_forward(params, bb, cfg, "resnet101", im, t,
                                                         ln),
                                 pipeline.extract_features("resnet101", bb, im).float()),
        head=lambda t, ln, f: predict_fused(params, head_w, cfg, t, ln, f),
        f32_feats=f32_feats,
        predict_plain=lambda t, ln, f: predict(params, cfg, t, ln, f),
        gen=torch.Generator(dev).manual_seed(seed), failed=failed, pooled=pooled)
    a_f32, r_f32 = pooled["plain_f32"] / pooled["ids"], pooled["ref_f32"] / pooled["ids"]
    log(f"variants (b) s2d, {pooled['ids']} ids: agreement with the float32 tree, "
        f"answer_pixels on the s2d tree {a_f32:.4f}, pixels_forward on the 7x7 tree "
        f"{r_f32:.4f} (bar: no less, less 0.03)")
    if a_f32 < r_f32 - 0.03:
        failed.append(f"(b) s2d agrees {a_f32:.4f} with the float32 tree, the 7x7 tree "
                      f"{r_f32:.4f}")
    with torch.no_grad():
        x32 = T.color_normalize(images.float() / 255.0)
        s2d_f32 = resnet.space_to_depth_stem(bb_f32)
        want = resnet._stem(x32, bb_f32, resnet._prepared(bb_f32))
        got_stem = resnet._stem(x32, s2d_f32, resnet._prepared(s2d_f32))
        excess = ((got_stem - want).abs()
                  - (STEM_BAR["atol"] + STEM_BAR["rtol"] * want.abs())).max().item()
        stem_err = (got_stem - want).abs().max().item()
        del want, got_stem
        x16 = x32.to(bf16)
        stem_ms = {name: time_ms(lambda t=tree: resnet._stem(x16, t, resnet._prepared(t)),
                                 iters=5)
                   for name, tree in (("7x7/2", bb), ("s2d 4x4/1", s2d))}
    log(f"variants (b) the s2d stem against conv1 in float32 (TF32 off): max_abs_err "
        f"{stem_err:.3e}, worst excess over rtol 1e-4 / atol 1e-5 {excess:.3e} (bar <= 0)")
    if excess > 0:
        failed.append(f"(b) the s2d stem is off conv1 by {stem_err:.3e}")
    log(f"variants (b) stem ms in bf16, conv + bias + ReLU at B={B}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in stem_ms.items()) + f" [{card}]")

    # (c) int8: each shape class of the 448-px path at B=VAR_INT8_B, its int32
    # accumulators on the card against the CPU's on the same codes
    classes = (("stem 7x7/2", 7, 2, side, 3, 64), ("1x1", 1, 1, side // 4, 256, 64),
               ("3x3/1", 3, 1, side // 4, 64, 64), ("3x3/2", 3, 2, side // 4, 128, 128),
               ("down 1x1/2", 1, 2, side // 4, 256, 512))
    g = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for name, k, stride, hw, ci, co in classes:
            x = torch.randn((VAR_INT8_B, hw, hw, ci), generator=g, device=dev)
            w = torch.randn((k, k, ci, co), generator=g, device=dev) * 0.05
            p = resnet.quantize_resnet({"conv1": {"w": w, "b": torch.zeros(co, device=dev)},
                                        "stages": []})["conv1"]
            xq, xs = resnet._quantize_act(x)
            xq_c, xs_c = resnet._quantize_act(x.to(cpu))
            acc = resnet._conv_int8_acc(xq, p["wq"], stride)
            acc_c = resnet._conv_int8_acc(xq.to(cpu), p["wq"].to(cpu), stride)
            same = acc.dtype == torch.int32 and torch.equal(acc.to(cpu), acc_c)
            conv_ms = time_ms(lambda: resnet._conv_int8(x, p, stride), iters=5)
            log(f"variants (c) int8 {name} {tuple(x.shape)} -> {tuple(acc.shape)}: int32 "
                f"accumulators bit-equal to the CPU's: {same}; codes equal: "
                f"{torch.equal(xq.to(cpu), xq_c)}, scale equal: {xs.item() == xs_c.item()}; "
                f"_conv_int8 {conv_ms:.4f} ms [{card}]")
            if not same:
                failed.append(f"(c) int8 {name}: accumulators differ from the CPU's")
        # the JAX test's shrunk net: one block a stage, at VAR_SHRUNK_SIDE px
        net = resnet.resnet101_init(torch.Generator().manual_seed(seed + 5), device=dev)
        net["stages"] = [blocks[:1] for blocks in net["stages"]]
        net = resnet.fold_batchnorm(net)
        xs_ = torch.rand((2, VAR_SHRUNK_SIDE, VAR_SHRUNK_SIDE, 3), generator=g, device=dev)
        ref = resnet.resnet101_apply(net, xs_).flatten()
        got8 = resnet.resnet101_apply_int8(resnet.quantize_resnet(net), xs_).flatten()
        corr = torch.corrcoef(torch.stack([ref, got8]))[0, 1].item()
        rel = ((got8 - ref).norm() / (ref.norm() + 1e-9)).item()
        log(f"variants (c) int8 shrunk net (one block a stage, {VAR_SHRUNK_SIDE} px): corr "
            f"{corr:.5f} (bar > 0.995), rel {rel:.4f} (bar < 0.1)")
        if not (corr > 0.995 and rel < 0.1):
            failed.append(f"(c) int8 shrunk net: corr {corr:.5f}, rel {rel:.4f}")
        # the full ResNet-101 at B=VAR_B: readings
        q8 = resnet.quantize_resnet(bb)
        sync(dev)
        held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        f8 = resnet.resnet101_apply_int8(q8, x32)
        sync(dev)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e6 if dev.type == "cuda" else 0
        f32 = f32_feats(images)
        corr = torch.corrcoef(torch.stack([f32.flatten(), f8.flatten()]))[0, 1].item()
        rel = ((f8 - f32).norm() / f32.norm()).item()
        ms8 = time_ms(lambda: resnet.resnet101_apply_int8(q8, x32), iters=3, warmup=1)
        ms16 = time_ms(lambda: resnet.resnet101_apply(bb, x16), iters=3, warmup=1)
        ms32 = time_ms(lambda: resnet.resnet101_apply(bb_f32, x32), iters=3, warmup=1)
    log(f"variants (c) int8 ResNet-101 B={B} {side} px against the float32 folded tree: "
        f"corr {corr:.5f}, rel {rel:.4f} (readings); ms int8 {ms8:.4f}, bf16 folded "
        f"{ms16:.4f}, float32 folded {ms32:.4f} (TF32 off); int8 peak {peak:.1f} MB above "
        f"the {held / 1e6:.1f} MB held [{card}]")
    del f8, q8, x32, x16, bb_f32, f32_cache

    # (d) the bench's variants, each its JSON line
    dev_flag = [] if dev.type == "cuda" else ["--device", "cpu"]
    for flag in ("--s2d", "--int8"):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        rc, line, _ = _run_cli_json(bench_pixels.main, dev_flag + [flag] + VAR_BENCH_ARGS)
        print(json.dumps(line), flush=True)
        log(f"variants (d) bench_torch_pixels.py {flag}: rc {rc}, "
            f"{time.perf_counter() - t0:.1f} s, launches "
            f"{ {name: k.launches for name, k in kernels.items()} } [{card}]")
        for name, k in kernels.items():
            launches[name] += k.launches
        if rc != 0 or line is None or "error" in line or line.get(flag[2:]) is not True:
            failed.append(f"(d) bench_torch_pixels.py {flag}: rc {rc}, line {line}")
    log(f"variants_phase_s={time.perf_counter() - t_phase:.1f} [{card}]")
    if failed:
        raise SystemExit("variants phase failed: " + "; ".join(failed))
    return {"launches": launches, "transforms_ms": t_ms, "stem_ms": stem_ms,
            "int8": {"corr": corr, "rel": rel, "ms": ms8, "bf16_ms": ms16,
                     "f32_ms": ms32, "peak_mb": peak}}


SCRIPTS_DEVICE = "cuda"      # a CPU rehearsal sets "cpu" (and the flags below)
SCRIPTS_TIMEOUT = 300        # seconds a script may run
SCRIPTS_LANES = 3            # lanes of scripts run at once (1: one script at a time)
SCRIPTS_TRAIN = ["--batch", "100", "--steps", "3", "--rounds", "2"]
SCRIPTS_PIXELS = ["--preset", "ours_resnet", "--batch", "48", "--qpi", "3", "--steps", "2",
                  "--rounds", "1"]
SCRIPTS_SERVE = ["--clients", "8", "--requests", "5", "--unloaded", "10"]
SCRIPTS_PRECOMPUTE = ["--backbone", "vgg16", "--n", "64"]
SCRIPTS_PROBE = ["--batches", "512,2048", "--rounds", "1", "--chain", "3"]
SCRIPTS_VIT = ["--batch", "8", "--chain", "2", "--rounds", "1"]
SCRIPTS_PAPER = (["--n-train", "1024", "--n-test", "512", "--n-images", "64"],
                 ["--epochs", "2", "--batch-size", "256"])
SCRIPTS_FT_AB = ["--epochs", "2", "--n-train", "64", "--n-test", "32"]
TRAIN_KERNEL_NAMES = ("train_hops_fwd", "train_hops_bwd", "train_hops_fwd_bf16",
                      "train_hops_bwd_bf16", "train_hops_bwd_dfeats",
                      "train_hops_bwd_dfeats_bf16")


def run_script_json(module: str, argv, timeout: float = SCRIPTS_TIMEOUT):
    """``python -m rau_vqa_tpu_torch.scripts.<module> argv`` from the
    checkout's root, as a user runs it: (exit code, its last stdout line as
    JSON or None, its stderr's tail, seconds)."""
    import ctypes
    import signal

    def die_with_parent():
        # the script ends with this process, a watchdog's os._exit included
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG

    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", f"rau_vqa_tpu_torch.scripts.{module}",
                               *argv], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=timeout,
                              preexec_fn=die_with_parent)
    except subprocess.TimeoutExpired as e:
        return None, None, f"killed after {timeout} s: {(e.stderr or b'')[-3000:]!r}", timeout
    secs = time.perf_counter() - t0
    try:
        line = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        line = None
    return proc.returncode, line, proc.stderr[-3000:], secs


def train_launch_faults(line) -> list:
    """The bench_train line's launch gates: each fused variant launched its
    type's forward and backward kernel once a warm and a timed step, and no
    other training kernel; no other variant launched any."""
    faults = []
    bf16 = line.get("compute_dtype") == "bfloat16"
    want = ("train_hops_fwd_bf16", "train_hops_bwd_bf16") if bf16 else \
        ("train_hops_fwd", "train_hops_bwd")
    for key, counts in line["launches_by_variant"].items():
        steps = line["steps_by_variant"][key]
        train = {n: counts.get(n, 0) for n in TRAIN_KERNEL_NAMES if counts.get(n, 0)}
        if re.match(r"^fused\d*_b\d+$", key):
            if train != {n: steps for n in want}:
                faults.append(f"{key}: training launches {train}, want {want} x {steps}")
        elif train:
            faults.append(f"{key}: an unfused variant launched {train}")
    return faults


def scripts_phase(seed: int, card: str) -> dict:
    """16. scripts: the port's measurement and experiment scripts
    (``rau_vqa_tpu_torch/scripts/``), each run as a subprocess at cut flags;
    returns each kernel's launches over them (from each line's
    ``launches``) and each run's line."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    on_card = SCRIPTS_DEVICE == "cuda"
    dev_flag = [] if on_card else ["--device", "cpu"]
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()     # the card's memory to the subprocesses
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scripts_")
    runs = [
        ("bench_train float32", "bench_train",
         SCRIPTS_TRAIN + ["--f32", "--variants", "plain,remat,fused,trunc16,accum2,maskref"]),
        ("bench_train bf16", "bench_train", SCRIPTS_TRAIN + ["--variants", "plain,remat,fused"]),
        ("bench_train pixels", "bench_train", SCRIPTS_PIXELS + ["--variants",
                                                                "pixels,finetunegrp"]),
        ("bench_serve", "bench_serve", SCRIPTS_SERVE),
        ("bench_precompute", "bench_precompute", SCRIPTS_PRECOMPUTE),
        ("probe_serving_batch", "probe_serving_batch", SCRIPTS_PROBE),
        ("profile_vit", "profile_vit", SCRIPTS_VIT),
        ("paper_dims_run generate", "paper_dims_run",
         ["generate", "--root", os.path.join(tmp, "paper")] + SCRIPTS_PAPER[0]),
        ("paper_dims_run train", "paper_dims_run",
         ["train", "--root", os.path.join(tmp, "paper")] + SCRIPTS_PAPER[1]),
        ("ft_accuracy_ab", "ft_accuracy_ab", ["--root", os.path.join(tmp, "ft_ab")]
         + SCRIPTS_FT_AB),
    ]
    # three lanes of runs that share nothing (the training bench; the
    # serving and backbone scripts; the experiments, generate before train),
    # SCRIPTS_LANES of them at once: each script spends 15-20 s starting and
    # probing the card before its work
    lanes = [runs[:3], runs[3:7], runs[7:]]

    def run_lane(lane):
        out = []
        for label, module, argv in lane:
            argv = argv + ([] if module == "paper_dims_run" and argv[0] == "generate"
                           else dev_flag)
            out.append((label, module) + run_script_json(module, argv))
        return out

    from concurrent.futures import ThreadPoolExecutor
    launches: dict = {}
    lines: dict = {}
    failed = []
    try:
        with ThreadPoolExecutor(SCRIPTS_LANES) as ex:
            done = [r for lane in ex.map(run_lane, lanes) for r in lane]
        for label, module, rc, line, err, secs in done:
            lines[label] = line
            faults = []
            if label == "paper_dims_run generate":
                if rc != 0 or not os.path.exists(os.path.join(tmp, "paper", "shard_int8",
                                                              "features.npy")):
                    faults.append(f"rc {rc}, no int8 shard")
            elif line is None or "error" in line:
                faults.append(f"rc {rc}, line {line}")
            else:
                if line.get("device") != kind:
                    faults.append(f"device {line.get('device')!r}, not {kind!r}")
                if label == "paper_dims_run train":
                    # the learnability criterion is not reachable in 2
                    # epochs: the exit code must say whether it was met
                    if rc != (0 if line["criterion"]["met"] else 1) or \
                            line["epochs_run"] < 1 or not line["value"] >= 0:
                        faults.append(f"rc {rc}, line {line}")
                elif label == "ft_accuracy_ab":
                    arms = line.get("arms", {})
                    gb = [h["grad_norm_backbone"] for h in arms.get("finetune", {})
                          .get("history", [])]
                    if rc != 0 or line.get("value") is None or not gb or min(gb) <= 0:
                        faults.append(f"rc {rc}, value {line.get('value')}, finetune "
                                      f"grad_norm_backbone {gb}")
                elif rc != 0 or not line.get("value", 0) > 0:
                    faults.append(f"rc {rc}, value {line.get('value')}")
                if module == "bench_train":
                    faults += train_launch_faults(line)
                elif module in ("bench_serve", "probe_serving_batch", "profile_vit"):
                    got = line.get("launches", {})
                    if on_card and not (got.get("lstm_encode", 0) > 0
                                        and got.get("rau_hops", 0) > 0):
                        faults.append(f"the serving kernels were not launched: {got}")
                for n, c in (line.get("launches") or {}).items():
                    launches[n] = launches.get(n, 0) + c
            print(json.dumps({"script": label, **(line or {})}), flush=True)
            log(f"scripts: {label}: rc {rc}, {secs:.1f} s (preflight "
                f"{(line or {}).get('preflight_s')} s, body {(line or {}).get('body_s')} s), "
                f"launches {(line or {}).get('launches')} [{card}]")
            for ln in err.strip().splitlines()[-12:]:
                log(f"scripts: {label} | {ln[:300]}")
            if faults:
                log(f"scripts: {label} stderr tail:\n{err}")
                failed.append(f"{label}: " + "; ".join(faults))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"scripts_phase_s={time.perf_counter() - t_phase:.1f} ({SCRIPTS_LANES} lanes at once; "
        f"the scripts' own {sum(r[-1] for r in done):.1f} s) [{card}]")
    if failed:
        raise SystemExit("scripts phase failed: " + " | ".join(failed))
    return {"launches": launches, "lines": lines}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank:
        # one rank of the mesh phase's 2-rank world (it starts them itself)
        return mesh_rank_main(args.mesh_rank, args.seed)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2

    from rau_vqa_tpu_torch.config import get_preset, get_train_preset
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.eval.predict import (
        _aggregate, compute_answers, make_predict_step, pick_bucket, predict, predict_fused)
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.models.rau import (
        embed_image, embed_question, encode_question, init_params)
    from rau_vqa_tpu_torch.ops import _build, fused_resnet, lstm_encoder, maskgen, rau_hops
    from rau_vqa_tpu_torch.ops.transforms import color_normalize
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.ops.treeflat import pluck
    from rau_vqa_tpu_torch.train.losses import hop_grad_scale
    from rau_vqa_tpu_torch.train.optim import (
        adam_update, add_gradient_noise, clip_by_global_norm)
    from rau_vqa_tpu_torch.train.trainer import (
        PARAM_GROUPS, init_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    # 1. device
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), found {cap}")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all(["lstm_encoder", "rau_hops", "maskgen",
                                "rau_train_hops_fwd", "rau_train_hops_bwd",
                                "fused_resnet"], force=True)
    log(f"build_s={time.perf_counter() - t0:.3f} [{card}]")
    stage_regs = {}   # (TH, TW, NB, ring) -> registers a thread
    for name, rep in reports.items():
        what, inst = "", None
        for line in rep.splitlines():
            if name == "lstm_encoder" and "Compiling entry" in line:
                # the encoder's one instantiation per units a CTA
                what = " U=" + line.split("lstm_encode_kernelILi")[1].split("E")[0]
            if name == "fused_resnet" and "Compiling entry" in line:
                # the stage kernel's instantiations: Cfg<TH, TW, NB, S>
                m = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
                inst = tuple(int(v) for v in m.groups()) if m else None
                what = (f" tile {inst[0]}x{inst[1]} nb {inst[2]} ring {inst[3]}" if m
                        else " float32")
            if name.startswith(("rau_train_hops", "rau_hops")) and "Compiling entry" in line:
                what = " " + phase_kernel_label(line)
            if name == "fused_resnet" and inst and "registers" in line:
                stage_regs[inst] = int(re.search(r"Used (\d+) registers", line).group(1))
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}{what}: {line.strip()}")

    cfg = get_preset("ours_ms")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, 4, 16, 19, 83, 512):
        plan = lstm_encoder.lstm_plan(B, cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers, n_sm)
        log(f"lstm_encode plan B={B}: grid {plan.ctas} CTAs on {n_sm} SMs, {plan.units} units "
            f"a CTA, {plan.row_groups} row group(s) of {plan.rows} rows, {plan.splits} K "
            f"split(s), {plan.passes} pass(es), {plan.smem} bytes of shared memory a CTA")
    # the training kernels' plans against the launches their built C entries
    # make (a dry run of each): the same grids, shared memory within the plan's
    bwd_widths = (cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                  cfg.att_state_dim, cfg.rnnout_dim)
    fwd_widths = bwd_widths + (cfg.answer_size,)
    for dt in (torch.float32, bf16):
        for B in (1, 19, 37, 100):
            plan = rth.fwd_plan(B, *fwd_widths, n_sm, dt)
            scratch, launches = rth.fwd_launcher_plan(B, *fwd_widths, dt)
            grids = [ph.grid for ph in plan.phases]
            if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                    x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
                raise SystemExit(f"fwd_plan B={B} {dt}: the launcher runs {launches} with "
                                 f"{scratch} scratch floats, the plan {grids}")
        log(f"train_hops_fwd plan B=100 {dt}: {len(plan.phases)} kernels a hop "
            f"({sum(1 for p in plan.phases if p.tile)} tile GEMMs), scratch "
            f"{scratch * 4 / 1e6:.1f} MB beside the {plan.work_floats * 4 / 1e6:.1f} MB "
            f"workspace; the launcher's dry run makes the plan's grids at B in 1, 19, 37, "
            f"100, with shared memory up to {max(x[3] for x in launches)} B")
        for B in (1, 19, 37, 100):
            plan = rth.bwd_plan(B, *bwd_widths, n_sm, dt)
            scratch, launches = rth.launcher_plan(B, *bwd_widths, dt, plan.chunk_rows)
            grids = [ph.grid for ph in plan.phases]
            if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                    x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
                raise SystemExit(f"bwd_plan B={B} {dt}: the launcher runs {launches} with "
                                 f"{scratch} scratch floats, the plan {grids}")
        gemms = [p for p in plan.phases if p.tile]
        log(f"train_hops_bwd plan B=100 {dt}: {len(plan.phases)} kernels a hop "
            f"({len(gemms)} tile GEMMs), {plan.chunks} K chunks of {plan.chunk_rows} rows, "
            f"scratch {scratch * 4 / 1e6:.1f} MB; the launcher's dry run makes the plan's "
            f"grids at B in 1, 19, 37, 100, with shared memory up to "
            f"{max(x[3] for x in launches)} B")
    # the hop kernel's plan against its built C entry's dry run of a one-hop call
    hops_widths = (cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim,
                   cfg.att_rnn_size, cfg.answer_size)
    for B in (1, 4, 16, 19, 37, 83, 512):
        plan = rau_hops.hops_plan(B, cfg)
        scratch, launches = rau_hops.hops_launcher_plan(B, *hops_widths)
        grids = [ph.grid for ph in plan.phases]
        if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
            raise SystemExit(f"hops_plan B={B}: the launcher runs {launches} with "
                             f"{scratch} scratch floats, the plan {grids}")
        log(f"rau_hops plan B={B}: {plan.kernels(cfg.n_hops)} kernels a call ({len(plan.setup)} "
            f"+ {len(plan.hop)} a hop, {sum(1 for p in plan.phases if p.tile)} tile GEMMs in "
            f"a one-hop call), scratch {scratch * 4 / 1e6:.2f} MB, shared memory up to "
            f"{max(x[3] for x in launches)} B; the launcher's dry run makes the plan's grids")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    hw = rau_hops.pack_hop_weights(params["mult"])
    rs = np.random.RandomState(args.seed)

    # 3. kernels against their plain versions
    err = {"lstm_encode": 0.0, "rau_hops": 0.0}
    for B in (1, 19, 83, 512):
        tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
        if B > 1:   # lengths outside [1, T] give zero rows
            lengths[1], lengths[2] = 0, cfg.seq_len + 1
        emb = embed_question(params, tokens).contiguous()
        got = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        again = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        want = lstm_encoder.lstm_encode_reference(enc, cfg, emb, lengths, dot_dtype=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0.05, atol=5e-3)
        if not torch.equal(got, again):
            raise SystemExit(f"lstm_encode B={B}: two calls on the same inputs differ")
        if B > 1 and not bool((got[1:3] == 0).all()):
            raise SystemExit(f"lstm_encode B={B}: rows of length 0 and T + 1 are not zero")
        e = (got - want).abs().max().item()
        err["lstm_encode"] = max(err["lstm_encode"], e)
        log(f"lstm_encode B={B} max_abs_err={e:.3e} (bar rtol 0.05 atol 5e-3), "
            f"two calls bit-equal{', lengths 0 and T+1 zero' if B > 1 else ''}")

        q = want
        ifeat, iatt = embed_image(params["mult"], feats)
        ifeat = ifeat.to(bf16).contiguous()
        iatt = iatt.to(bf16).contiguous()
        s, d, a = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        again = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        s_r, d_r, a_r = rau_hops.rau_hops_reference(hw, cfg, q, ifeat, iatt,
                                                    dot_dtype=bf16)
        torch.cuda.synchronize()
        es = [(x - y).abs().max().item() for x, y in ((s, s_r), (d, d_r), (a, a_r))]
        # the scores' reading as a share of its bar (atol 0.01 + rtol 0.05 |want|)
        share = ((s - s_r).abs() / (0.01 + 0.05 * s_r.abs())).max().item()
        agree = (s.argmax(-1) == s_r.argmax(-1)).float().mean().item()
        log(f"rau_hops B={B} max_abs_err scores={es[0]:.3e} ({share:.3f} of the bar atol 0.01 "
            f"rtol 0.05) argmax_agree={agree:.4f} (bar > 0.97) do_pred={es[1]:.3e} (atol "
            f"5e-3) attprob={es[2]:.3e} (atol 5e-4)")
        torch.testing.assert_close(s, s_r, rtol=0.05, atol=0.01)
        if agree <= 0.97:
            raise SystemExit(f"rau_hops argmax agreement {agree} <= 0.97")
        torch.testing.assert_close(a, a_r, rtol=0.05, atol=5e-4)
        torch.testing.assert_close(d, d_r, rtol=0.05, atol=5e-3)
        if not all(torch.equal(x, y) for x, y in zip((s, d, a), again)):
            raise SystemExit(f"rau_hops B={B}: two calls on the same inputs differ")
        err["rau_hops"] = max(err["rau_hops"], *es)

    # the training kernels, float32, at mult_dropout 0.5 (the preset's)
    tcfg_m = dataclasses.replace(cfg, fused_train=True)
    mp = params["mult"]
    Q, S, Dc, M = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim
    H, A = cfg.n_hops, cfg.answer_size
    maskgen.KERNEL.launches = 0
    for seed in (0, 12345, 2 ** 31 - 2):
        seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
        for hop in (0, 7):
            for site, rest in ((0, (S, Dc)), (1, (Q,)), (2, (M,))):
                shape = (19,) + rest
                got = maskgen.dropout_mask(seed_t, hop, site, shape, 81, 0.5)
                want = maskgen.dropout_scale_mask(
                    shape, 81, maskgen.site_salt(seed_t, hop, site), 0.5)
                if not torch.equal(got, want):
                    raise SystemExit(f"maskgen: device hash differs from the plain "
                                     f"version at seed {seed} hop {hop} site {site}")
    mask_launches = maskgen.KERNEL.launches
    log(f"maskgen: device hash equals the plain version bit for bit "
        f"(seeds 0, 12345, 2^31-2; hops 0, 7; 3 sites; row_offset 81; "
        f"{mask_launches} launches)")
    err["train_hops_fwd"] = err["train_hops_bwd"] = 0.0
    hop_w = torch.tensor([1.0 + 0.5 * h for h in range(H)], device=dev)
    for B in (19, 100):
        feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2]
        q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev)
        seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
        got = rth.train_hops_fwd(mp, tcfg_m, q, feats, seed_t)
        want = rth.train_hops_fwd_reference(mp, tcfg_m, q, feats, seed_t)
        torch.cuda.synchronize()
        es = []
        for name, g, w in zip(("scores", "do_pred", "attprob", "c_all", "h_all"), got, want):
            # 8 recurrent hops of float32 sums in another order than cuBLAS's
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
            es.append((g - w).abs().max().item())
        err["train_hops_fwd"] = max(err["train_hops_fwd"], *es)
        if not fwd_bit_equal(rth, got, mp, tcfg_m, q, feats, seed_t):
            raise SystemExit(f"train_hops_fwd B={B}: two calls on the same inputs differ")
        log(f"train_hops_fwd B={B} max_abs_err {max(es):.3e} (bar rtol 1e-4 atol 1e-4), "
            f"two calls bit-equal")
        gmerge = 1e-3 * torch.randn(H, B, M, device=dev,
                                    generator=torch.Generator(dev).manual_seed(B))
        if not bwd_bit_equal(rth, mp, tcfg_m, q, feats, seed_t, got[3], got[4], gmerge):
            raise SystemExit(f"train_hops_bwd B={B}: two calls on the same inputs differ")
        log(f"train_hops_bwd B={B}: two calls bit-equal (9 emissions, 5 grads)")

        labels = torch.as_tensor(rs.randint(0, A, B), device=dev)

        def grads(bwd):
            c = dataclasses.replace(tcfg_m, fused_train_bwd=bwd)
            mp_ = map_tree(lambda w: w.detach().clone().requires_grad_(), mp)
            q_ = q.clone().requires_grad_()
            s = rth.rau_train_hops(mp_, c, q_, feats, seed_t)[0]
            ce = torch.nn.functional.cross_entropy(
                s.reshape(-1, A), labels.repeat(H), reduction="none").reshape(H, B).mean(1)
            (hop_w * ce).sum().backward()
            return mp_, q_.grad

        g_k, dq_k = grads("kernel")
        g_x, dq_x = grads("xla")
        torch.cuda.synchronize()
        rel = {"dq": ((dq_k - dq_x).norm() / dq_x.norm()).item()}
        for path in rth._DIFF_WEIGHTS:
            g, w = pluck(g_k, path).grad, pluck(g_x, path).grad
            if path == ("att_score", "b"):
                # zero in exact arithmetic (the softmax is shift-invariant):
                # both values are rounding noise, held to an absolute bar
                noise = max(g.abs().max().item(), w.abs().max().item())
                if noise > 1e-5:
                    raise SystemExit(f"train_hops_bwd: att_score b grad {noise:.3e} > 1e-5")
                continue
            rel["/".join(map(str, path))] = ((g - w).norm() / w.norm()).item()
        worst = max(rel, key=rel.get)
        if rel[worst] > 1e-3:
            raise SystemExit(f"train_hops_bwd B={B}: {worst} norm-relative error "
                             f"{rel[worst]:.3e} > 1e-3")
        if (g_k["do_pred"]["w"].grad.abs().max().item() != 0.0
                or g_k["do_pred"]["b"].grad.abs().max().item() != 0.0):
            raise SystemExit("train_hops_bwd: do_pred grads are not exactly 0")
        err["train_hops_bwd"] = max(err["train_hops_bwd"], rel[worst])
        log(f"train_hops_bwd B={B} worst norm-relative grad error {rel[worst]:.3e} "
            f"({worst}; bar 1e-3 per leaf), do_pred grads exactly 0")

    # the training kernels' bf16 instantiations (compute_dtype "bfloat16",
    # the --bf16 path) against their bf16 plain versions at mult_dropout 0.5
    # on bf16-cast weights (train_bf16_readings).  One hop at B in {19, 100}:
    # each output and grad leaf within TRAIN_BF16_BARS, each bar under half
    # the distance from the float32 plain version.  Eight hops at B in {19,
    # 100} (the main path's depth, and its batch), where two right
    # implementations that sum in another order drift apart to near half of
    # bf16's own effect: each within twice the plain version's own drift,
    # the same plain version run on the host CPU, and under 3/4 of the
    # float32 plain version's distance, where a kernel that leaves its
    # products unrounded lands (the forward's readings: 0.33-0.48 of it).
    err["train_hops_fwd_bf16"] = err["train_hops_bwd_bf16"] = 0.0
    failed = []
    for H_b, B in ((1, 19), (1, 100), (8, 19), (8, 100)):
        cfg_b = dataclasses.replace(tcfg_m, compute_dtype="bfloat16", n_hops=H_b)
        floor = H_b > 1
        readings = train_bf16_readings(rth, cfg_b, mp, B, rs, dev, host=floor)
        for kind, per in readings.items():
            # a leaf that no bf16 product reaches (cls b) must come out the
            # same; the others within the bar
            bars = {k: (train_bf16_deep_bar(r) if floor else
                        train_bf16_bar(kind, k) if r["float32"] > 0 else 0.0)
                    for k, r in per.items()}
            log(f"train_hops_{kind}_bf16 H={H_b} B={B}, norm-relative from the bf16 plain "
                f"version: kernel / float32 plain" + (" / bf16 plain on the host" if floor
                                                      else "") + " (bar): " + ", ".join(
                f"{k} {r['kernel']:.3e} / {r['float32']:.3e}"
                + (f" / {r['host']:.3e}" if floor else "") + f" ({bars[k]:.3e})"
                for k, r in per.items()))
            for k, r in per.items():
                if not r["kernel"] <= bars[k]:
                    failed.append(f"train_hops_{kind}_bf16 H={H_b} B={B}: {k} {r['kernel']:.3e} "
                                  f"> {bars[k]:.3e}")
                if not floor and r["float32"] > 0 and not bars[k] < 0.5 * r["float32"]:
                    failed.append(f"train_hops_{kind}_bf16 H={H_b} B={B}: {k}'s bar {bars[k]} "
                                  f"is not under half the float32 distance {r['float32']:.3e}")
            if not floor:
                err[f"train_hops_{kind}_bf16"] = max(err[f"train_hops_{kind}_bf16"],
                                                     *(r["kernel"] for r in per.values()))
    if failed:
        raise SystemExit("kernels: " + "; ".join(failed))
    cfg_b = dataclasses.replace(tcfg_m, compute_dtype="bfloat16")
    # the bf16 backward twice on the same inputs at B=100, eight hops
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    feats_b = make_batch(cfg, 100, cfg.seq_len, rs, dev)[2].to(bf16)
    q_b = torch.as_tensor(0.5 * rs.randn(100, Q).astype(np.float32), device=dev).to(bf16)
    seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    out16 = rth.train_hops_fwd(mp16, cfg_b, q_b, feats_b, seed_t)
    if not fwd_bit_equal(rth, out16, mp16, cfg_b, q_b, feats_b, seed_t):
        raise SystemExit("train_hops_fwd_bf16 B=100: two calls on the same inputs differ")
    log("train_hops_fwd_bf16 B=100 H=8: two calls bit-equal (5 outputs)")
    _, _, _, c16, h16 = out16
    gmerge = 1e-3 * torch.randn(H, 100, M, device=dev,
                                generator=torch.Generator(dev).manual_seed(7))
    if not bwd_bit_equal(rth, mp16, cfg_b, q_b, feats_b, seed_t, c16, h16, gmerge):
        raise SystemExit("train_hops_bwd_bf16 B=100: two calls on the same inputs differ")
    log("train_hops_bwd_bf16 B=100 H=8: two calls bit-equal (9 emissions, 5 grads)")
    # through the autograd Function: grads in the weights' type, do_pred's 0
    mp_r = map_tree(lambda w: w.detach().to(bf16).requires_grad_(), mp)
    feats_b = make_batch(cfg, 19, cfg.seq_len, rs, dev)[2].to(bf16)
    q_b = torch.as_tensor(0.5 * rs.randn(19, Q).astype(np.float32), device=dev).to(bf16)
    s_r = rth.rau_train_hops(mp_r, cfg_b, q_b, feats_b, 7)[0]
    torch.nn.functional.cross_entropy(s_r.reshape(-1, A), torch.zeros(
        H * 19, dtype=torch.long, device=dev)).backward()
    if (mp_r["do_pred"]["w"].grad.abs().max().item() != 0.0
            or mp_r["do_pred"]["b"].grad.abs().max().item() != 0.0):
        raise SystemExit("train_hops_bwd_bf16: do_pred grads are not exactly 0")
    if mp_r["i_embed"]["w"].grad.dtype != bf16:
        raise SystemExit("train_hops_bwd_bf16: the grads are not in the weights' type")
    log("train_hops_bwd_bf16: do_pred grads exactly 0, grads in bf16")

    # the identity-stage kernel at the 448-px stage shapes (H, C, Cw, N), and
    # at B=3 on tiles cut by the image's edge, against its plain version on
    # scale-normalised errors (tests/test_fused_resnet.py:100-102): bf16 at
    # stage_bar, float32 at 2e-5 (:54-55).  On edge-cut tiles with biases
    # around +1, the classic faults (stage_faults) must land beyond twice the
    # bar, so that the bar can see them; they are logged around 0 as well,
    # where biases of std 0.1 move the output far less.
    stages = [(448 // 4 >> s, 4 * w, w, n - 1) for s, (n, w) in
              enumerate(zip(resnet.RESNET101_BLOCKS, resnet.STAGE_WIDTH))]
    gen_s = torch.Generator(dev).manual_seed(args.seed)
    plain_stage = fused_resnet.fused_identity_stage_reference
    failed = []
    checks = ([(2, Hs, Hs, C, Cw, N, bf16, stage_bar(N), 0.0) for Hs, C, Cw, N in stages]
              + [(2, 14, 14, 2048, 512, 2, torch.float32, 2e-5, 0.0)]
              # each tile cut at the image's edge (4x28 with 128- and 64-column
              # chunks, 4x14), biases around 0 and +1
              + [(3, 13, Ws, C, Cw, 2, bf16, stage_bar(2), mean) for mean in (0.0, 1.0)
                 for Ws, C, Cw in ((21, 512, 128), (28, 256, 64), (14, 512, 512))])
    with watchdog(300, "the stage kernel's checks"):
        for B, Hs, Ws, C, Cw, N, dt, bar, mean in checks:
            stack = stage_stack(N, C, Cw, dt, gen_s, dev, bias_mean=mean)
            x = torch.randn(B, Hs, Ws, C, generator=gen_s, device=dev).abs().to(dt)
            what = f"fused_identity_stage B={B} H={Hs} W={Ws} C={C} Cw={Cw} N={N} {dt}"
            if dt == bf16:
                p = fused_resnet.stage_plan(B, Hs, Ws, C, Cw, n_sm)
                what += f" (tile {p.th}x{p.tw} ring {p.ring})"
                # the plan's shared memory is what the launcher will ask for
                smem = fused_resnet.launcher_smem(p.th, p.tw, p.nb, p.ring, C, Cw)
                if smem != p.smem:
                    failed.append(f"{what}: stage_plan reckons {p.smem} B of shared memory, "
                                  f"the launcher {smem}")
            if mean:
                what += f" biases around {mean}"
            try:
                got = fused_resnet.fused_identity_stage(x, stack, block_b=1)
                want = plain_stage(x, stack)
                torch.cuda.synchronize()
            except RuntimeError as err:
                # a fault or a trap of the kernel's mbarrier watchdog (a wait
                # that never completes) leaves the context unusable
                raise SystemExit(f"kernels: {what}: the stage kernel failed: {err}")
            e = scaled_err(got, want)
            if not e <= bar:
                failed.append(f"{what}: scale-normalised error {e:.3e} > {bar}")
            log(f"{what}: max_abs_err/max|want| {e:.3e} (bar {bar}), max_abs_err "
                f"{(got.float() - want.float()).abs().max().item():.3e}, "
                f"max|want| {want.float().abs().max().item():.3e}")
            if B == 3:   # the edge-cut cases
                for fault, wrong in stage_faults(plain_stage, x, stack).items():
                    fe = scaled_err(wrong, want)
                    log(f"  the plain stage with a {fault}: {fe:.3e} from the right one")
                    if mean and not fe > 2 * bar:
                        failed.append(f"{what}: a {fault} lands {fe:.3e} from the plain "
                                      f"stage, within twice the bar {bar}")
    if failed:
        raise SystemExit("kernels: " + "; ".join(failed))
    log("phase kernels: ok")

    # 4. serving through the user's entry point
    step = make_predict_step(cfg, buckets=(8, 16))
    serve_batches = [(1, 8), (4, 16), (16, 26), (83, 12), (512, 26)]
    data = [make_batch(cfg, B, max_len, rs, dev) for B, max_len in serve_batches]
    lstm_encoder.KERNEL.launches = 0
    rau_hops.KERNEL.launches = 0
    outs = [step(params, *batch) for batch in data]
    torch.cuda.synchronize()
    launches = {"lstm_encode": lstm_encoder.KERNEL.launches,
                "rau_hops": rau_hops.KERNEL.launches}
    log(f"serving launches: {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the serving path never launched: {launches}")
    hit = sorted({pick_bucket(step.ladder, int(b[1].max())) for b in data})
    if hit != [8, 16, 26]:
        raise SystemExit(f"buckets hit {hit}, expected [8, 16, 26]")
    H, A, S = cfg.n_hops, cfg.answer_size, cfg.cnn_spat
    for (B, _), (tokens, lengths, feats), (tab_pred, tab_att) in zip(serve_batches, data, outs):
        if tab_pred.shape != (H + 2, B, A) or tab_att.shape != (H + 2, B, S):
            raise SystemExit(f"B={B}: shapes {tuple(tab_pred.shape)} {tuple(tab_att.shape)}")
        if not (torch.isfinite(tab_pred).all() and torch.isfinite(tab_att).all()):
            raise SystemExit(f"B={B}: non-finite outputs")
        with torch.no_grad():
            ref_pred, _ = predict(params, cfg, tokens, lengths, feats)
        torch.testing.assert_close(tab_pred, ref_pred, rtol=0.05, atol=0.02)
        oe, _ = compute_answers(tab_pred)
        oe_ref, _ = compute_answers(ref_pred)
        agree = (oe == oe_ref).float().mean().item()
        if agree <= 0.95:
            raise SystemExit(f"B={B}: answer agreement {agree} <= 0.95")
        log(f"serving B={B}: ok, answer agreement with f32 path {agree:.4f}, "
            f"max_abs_err {(tab_pred - ref_pred).abs().max().item():.3e}")
    log("phase serving: ok")

    # 5. training through the user's entry point
    mcfg_t, tcfg_t = get_train_preset("ours_ms")
    mcfg_t = dataclasses.replace(mcfg_t, fused_train=True)
    B = tcfg_t.batch_size
    train_step = make_train_step(mcfg_t, tcfg_t)
    state0 = init_train_state(mcfg_t, args.seed)
    tokens, lengths, feats = make_batch(mcfg_t, B, mcfg_t.seq_len, rs, dev)
    # VQA's answers are skewed: labels from ten answers, Zipf-weighted
    zipf = 1.0 / np.arange(1, 11)
    labels = torch.as_tensor(rs.choice(10, B, p=zipf / zipf.sum()), device=dev)
    hop_scale = hop_grad_scale(H, scale_by_nhop=tcfg_t.hop_grad_scale_nhop,
                               stop_timing=tcfg_t.hop_stop_timing, epoch=1)
    lr, mult_lr = tcfg_t.learning_rate, tcfg_t.mult_learning_rate
    for k in (lstm_encoder.KERNEL, rau_hops.KERNEL, maskgen.KERNEL,
              rth.FWD_KERNEL, rth.BWD_KERNEL):
        k.launches = 0
    state, history = state0, []
    for _ in range(10):
        state, metrics = train_step(state, tokens, lengths, feats, labels, hop_scale,
                                    lr, mult_lr)
        history.append(metrics)
    torch.cuda.synchronize()
    train_launches = {"train_hops_fwd": rth.FWD_KERNEL.launches,
                      "train_hops_bwd": rth.BWD_KERNEL.launches}
    log(f"training launches in 10 steps: {train_launches}")
    if set(train_launches.values()) != {10}:
        raise SystemExit(f"training kernels did not launch once per step: {train_launches}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"train step {i}: non-finite {bad}")
    losses = [m["loss"].item() for m in history]
    log("train losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("train grad norms (embed rnn mult), first and last step: " + " | ".join(
        " ".join(f"{m[f'grad_norm_{g}'].item():.4f}" for g in PARAM_GROUPS)
        for m in (history[0], history[-1])))
    if not losses[-1] < losses[0]:
        raise SystemExit(f"joint loss did not fall over 10 steps: {losses}")
    # the backward kernel against autograd through the plain version, one
    # step each from one state and seed; noise off, so the norms are the
    # gradient's and not the noise's
    quiet = dataclasses.replace(tcfg_t, noisy_eta=0.0)
    norms = {}
    for bwd in ("kernel", "xla"):
        step_b = make_train_step(dataclasses.replace(mcfg_t, fused_train_bwd=bwd), quiet)
        _, m = step_b(state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        norms[bwd] = {g: m[f"grad_norm_{g}"].item() for g in PARAM_GROUPS}
    log(f"grad norms, backward kernel {norms['kernel']} vs autograd {norms['xla']}")
    for g in PARAM_GROUPS:
        if abs(norms["kernel"][g] - norms["xla"][g]) > 1e-3 * abs(norms["xla"][g]):
            raise SystemExit(f"grad_norm_{g}: kernel {norms['kernel'][g]} vs "
                             f"autograd {norms['xla'][g]} beyond rtol 1e-3")
    # (a) the ours_ms preset as shipped: the unfused path, float32; no
    # training kernel runs
    mcfg_u, tcfg_u = get_train_preset("ours_ms")
    step_u = make_train_step(mcfg_u, tcfg_u)
    train_kernels = (rth.FWD_KERNEL, rth.BWD_KERNEL, rth.FWD_BF16_KERNEL, rth.BWD_BF16_KERNEL)
    for k in train_kernels:
        k.launches = 0
    state, hist_u = state0, []
    for _ in range(10):
        state, metrics = step_u(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_u.append(metrics)
    torch.cuda.synchronize()
    if any(k.launches for k in train_kernels):
        raise SystemExit("the unfused step launched a fused training kernel")
    for i, m in enumerate(hist_u):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"unfused train step {i}: non-finite {bad}")
    losses_u = [m["loss"].item() for m in hist_u]
    log("unfused (ours_ms as shipped) train losses: " + " ".join(f"{x:.4f}" for x in losses_u))
    if not losses_u[-1] < losses_u[0]:
        raise SystemExit(f"unfused: joint loss did not fall over 10 steps: {losses_u}")
    # remat_hops recomputes each hop under the masks it drew: the same grads
    norms_u = {}
    for remat in (False, True):
        step_r = make_train_step(dataclasses.replace(mcfg_u, remat_hops=remat), quiet)
        _, m = step_r(state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        norms_u[remat] = {g: m[f"grad_norm_{g}"].item() for g in PARAM_GROUPS}
    log(f"unfused grad norms, remat_hops off {norms_u[False]} vs on {norms_u[True]}")
    for g in PARAM_GROUPS:
        if abs(norms_u[True][g] - norms_u[False][g]) > 1e-4 * abs(norms_u[False][g]):
            raise SystemExit(f"grad_norm_{g}: remat_hops {norms_u[True][g]} vs "
                             f"{norms_u[False][g]} beyond rtol 1e-4")
    # (b) fused, compute_dtype bfloat16 (the --bf16 --fused-train path):
    # the bf16 kernels once a step, the float32 ones never
    mcfg_b = dataclasses.replace(mcfg_t, compute_dtype="bfloat16")
    step_b16 = make_train_step(mcfg_b, tcfg_t)
    for k in train_kernels:
        k.launches = 0
    state, hist_b = state0, []
    for _ in range(10):
        state, metrics = step_b16(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_b.append(metrics)
    torch.cuda.synchronize()
    bf16_launches = {"train_hops_fwd_bf16": rth.FWD_BF16_KERNEL.launches,
                     "train_hops_bwd_bf16": rth.BWD_BF16_KERNEL.launches,
                     "train_hops_fwd": rth.FWD_KERNEL.launches,
                     "train_hops_bwd": rth.BWD_KERNEL.launches}
    log(f"bf16 training launches in 10 steps: {bf16_launches}")
    if list(bf16_launches.values()) != [10, 10, 0, 0]:
        raise SystemExit(f"bf16 training: expected 10 launches of each bf16 kernel and none "
                         f"of the float32 ones, got {bf16_launches}")
    for i, m in enumerate(hist_b):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"bf16 train step {i}: non-finite {bad}")
    losses_b = [m["loss"].item() for m in hist_b]
    log("bf16 fused train losses: " + " ".join(f"{x:.4f}" for x in losses_b))
    if not losses_b[-1] < losses_b[0]:
        raise SystemExit(f"bf16: joint loss did not fall over 10 steps: {losses_b}")
    # the same state, batch and masks as the float32 fused run's first step
    # (tests/test_pallas_train.py:227-242: within 5%)
    gap = abs(losses_b[0] - losses[0]) / abs(losses[0])
    log(f"first-step loss: bf16 {losses_b[0]:.6f}, float32 {losses[0]:.6f}, "
        f"relative gap {gap:.3e} (bar 0.05)")
    if gap > 0.05:
        raise SystemExit(f"bf16 first-step loss {losses_b[0]} is {gap:.3e} from the "
                         f"float32 step's {losses[0]}")
    # (c) the preset unfused with compute_dtype bfloat16 (the --bf16 path
    # without --fused-train): every hop in PyTorch on bf16 casts
    mcfg_ub = dataclasses.replace(mcfg_u, compute_dtype="bfloat16")
    step_ub = make_train_step(mcfg_ub, tcfg_u)
    for k in train_kernels:
        k.launches = 0
    state, hist_ub = state0, []
    for _ in range(10):
        state, metrics = step_ub(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_ub.append(metrics)
    torch.cuda.synchronize()
    if any(k.launches for k in train_kernels):
        raise SystemExit("the unfused bf16 step launched a fused training kernel")
    for i, m in enumerate(hist_ub):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"unfused bf16 train step {i}: non-finite {bad}")
    losses_ub = [m["loss"].item() for m in hist_ub]
    log("unfused bf16 train losses: " + " ".join(f"{x:.4f}" for x in losses_ub))
    if not losses_ub[-1] < losses_ub[0]:
        raise SystemExit(f"unfused bf16: joint loss did not fall over 10 steps: {losses_ub}")
    # the same state, batch and generator as the unfused float32 run's first step
    gap_u = abs(losses_ub[0] - losses_u[0]) / abs(losses_u[0])
    log(f"first-step loss: unfused bf16 {losses_ub[0]:.6f}, float32 {losses_u[0]:.6f}, "
        f"relative gap {gap_u:.3e} (bar 0.05)")
    if gap_u > 0.05:
        raise SystemExit(f"unfused bf16 first-step loss {losses_ub[0]} is {gap_u:.3e} from "
                         f"the float32 step's {losses_u[0]}")
    log("phase training: ok")

    # 6. from pixels through the user's entry point: answer_pixels
    cfg_r = get_preset("ours_resnet")
    params_r = init_params(cfg_r, torch.Generator().manual_seed(args.seed), dev)
    bb = resnet.fold_batchnorm(resnet.resnet101_init(
        torch.Generator().manual_seed(args.seed + 1), bf16, dev))
    bb_f32 = map_tree(lambda t: t.float(), bb)
    # calls per batch size: one B=1 call gives only 10 answer ids, too few to
    # resolve a 0.95 bar, so B=1 and B=7 run on several batches (>= 300 ids)
    pix_calls = {1: 32, 7: 5, 120: 1}
    pix_data = {}
    for B, n in pix_calls.items():
        for _ in range(n):
            tokens, lengths, _ = make_batch(cfg_r, B, cfg_r.seq_len, rs, dev)
            images = torch.as_tensor(rs.randint(0, 256, (B, 448, 448, 3), dtype=np.uint8),
                                     device=dev)
            pix_data.setdefault(B, []).append((images, tokens, lengths))
    for k in (fused_resnet.KERNEL, lstm_encoder.KERNEL, rau_hops.KERNEL):
        k.launches = 0
    pix_out = {B: [pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101", *d)
                   for d in batches] for B, batches in pix_data.items()}
    torch.cuda.synchronize()
    pix_launches = {"fused_identity_stage": fused_resnet.KERNEL.launches,
                    "lstm_encode": lstm_encoder.KERNEL.launches,
                    "rau_hops": rau_hops.KERNEL.launches}
    n_calls = sum(pix_calls.values())
    log(f"pixels launches in {n_calls} calls: {pix_launches}")
    if pix_launches != {"fused_identity_stage": 4 * n_calls, "lstm_encode": n_calls,
                        "rau_hops": n_calls}:
        raise SystemExit(f"answer_pixels: expected 4 stage-kernel launches and one of each "
                         f"head kernel a call, got {pix_launches}")
    S, Hr, Ar = cfg_r.cnn_spat, cfg_r.n_hops, cfg_r.answer_size
    head_w = pipeline._head_weights(params_r)
    gen_r = torch.Generator(dev).manual_seed(args.seed)
    # Random weights leave many near-ties among the answers, and two bf16
    # backbones differ by ~2% of the features' scale (activations ~1e7, the
    # head's tanh saturated), so exact agreement with pixels_forward sits at
    # 0.95-0.96 whatever the kernel (PERF.md).  The gates are set against
    # bf16's own effect, measured on each call as pixels_forward on the bf16
    # tree against the same tree in float32:
    # - answers > 0.95 at each B, an answer agreeing when pixels_forward
    #   scores it within twice the largest change that bf16 rounding makes to
    #   that row's scores (random answers must stay below 0.2 there, or the
    #   slack would pass anything);
    # - over all calls, answer_pixels agrees with the float32 tree no less
    #   than pixels_forward does, less 0.03 (sampling over ~1,900 ids);
    # - attention within twice bf16's own change to it, plus 5e-4;
    # - the kernels' head against the float32 head on the same features: the
    #   serving bars (0.95; attention atol 5e-4, tests/test_pallas_rau.py);
    # - the fused backbone no farther from the float32 features than cuDNN's
    #   bf16 one (1.5x, plus 1e-3 for the sampling).
    # A kernel fault that these cannot see is caught at the main path's own
    # stage inputs below.
    failed, pooled = [], {"ids": 0, "fused_f32": 0, "cudnn_f32": 0}
    for B, batches in pix_data.items():
        hits = dict.fromkeys(("same", "head", "backbone", "near", "near_random",
                              "fused_f32", "cudnn_f32"), 0)
        total = 0
        att_err = att_bf16 = att_head = att_bb = 0.0
        feat_err = feat_max = err_fused = err_cudnn = 0.0
        for (ids, att), d in zip(pix_out[B], batches):
            if ids.shape != (Hr + 2, B) or att.shape != (Hr + 2, B, S):
                raise SystemExit(f"pixels B={B}: shapes {tuple(ids.shape)} {tuple(att.shape)}")
            if not torch.isfinite(att).all():
                raise SystemExit(f"pixels B={B}: non-finite attention")
            images, tokens, lengths = d
            with torch.no_grad():
                out = pipeline.pixels_forward(params_r, bb, cfg_r, "resnet101", *d)
                ref_pred, ref_att = _aggregate(out.scores, out.do_pred, out.attprob)
                # where the answers part: the kernels' head on the unfused
                # backbone's features, and the float32 head on the fused ones;
                # and the same tree's weights in float32, free of bf16 rounding
                f_ref = pipeline.extract_features("resnet101", bb, images).float()
                f_fused = pipeline.extract_features(
                    "resnet101", bb, images, fused_stages=pipeline.SERVING_STAGES).float()
                f32 = pipeline.extract_features("resnet101", bb_f32, images)
                head_pred, head_att = predict_fused(params_r, head_w, cfg_r, tokens,
                                                    lengths, f_ref)
                bb_pred, bb_att = predict(params_r, cfg_r, tokens, lengths, f_fused)
                f32_pred, f32_att = predict(params_r, cfg_r, tokens, lengths, f32)
            ref_ids, f32_ids = ref_pred.argmax(-1), f32_pred.argmax(-1)
            slack = 2 * (ref_pred - f32_pred).abs().amax(-1)
            best = ref_pred.amax(-1)

            def near(i):
                return (best - ref_pred.gather(-1, i[..., None])[..., 0] <= slack).sum().item()

            hits["near"] += near(ids)
            hits["near_random"] += near(torch.randint(0, Ar, ids.shape, device=dev,
                                                      generator=gen_r))
            hits["same"] += (ids == ref_ids).sum().item()
            hits["head"] += (head_pred.argmax(-1) == ref_ids).sum().item()
            hits["backbone"] += (bb_pred.argmax(-1) == ref_ids).sum().item()
            hits["fused_f32"] += (ids == f32_ids).sum().item()
            hits["cudnn_f32"] += (ref_ids == f32_ids).sum().item()
            total += ids.numel()
            att_err = max(att_err, (att - ref_att).abs().max().item())
            att_bf16 = max(att_bf16, (ref_att - f32_att).abs().max().item())
            att_head = max(att_head, (head_att - ref_att).abs().max().item())
            att_bb = max(att_bb, (bb_att - ref_att).abs().max().item())
            feat_max = max(feat_max, f_ref.abs().max().item())
            feat_err = max(feat_err, scaled_err(f_fused, f_ref))
            err_fused = max(err_fused, scaled_err(f_fused, f32))
            err_cudnn = max(err_cudnn, scaled_err(f_ref, f32))
        r = {k: v / total for k, v in hits.items()}
        pooled["ids"] += total
        pooled["fused_f32"] += hits["fused_f32"]
        pooled["cudnn_f32"] += hits["cudnn_f32"]
        log(f"pixels B={B} x {len(batches)} calls, {total} ids: answers agree with "
            f"pixels_forward {r['same']:.4f} (kernels' head alone {r['head']:.4f}, fused "
            f"backbone alone {r['backbone']:.4f}), within bf16's tie slack {r['near']:.4f} "
            f"(random answers {r['near_random']:.4f}); with the float32 tree: answer_pixels "
            f"{r['fused_f32']:.4f}, pixels_forward {r['cudnn_f32']:.4f}; attention "
            f"max_abs_err {att_err:.3e}, bf16's own {att_bf16:.3e} (head alone "
            f"{att_head:.3e}, backbone alone {att_bb:.3e}); features fused vs unfused "
            f"max_abs_err/max {feat_err:.3e}, max|features| {feat_max:.3e}; against "
            f"float32 features: fused {err_fused:.3e}, unfused {err_cudnn:.3e}")
        if r["near"] <= 0.95 or r["near_random"] >= 0.2:
            failed.append(f"B={B}: answers within bf16's tie slack {r['near']:.4f} "
                          f"(bar > 0.95), random answers {r['near_random']:.4f} (bar < 0.2)")
        if att_err > 2 * att_bf16 + 5e-4:
            failed.append(f"B={B}: attention max_abs_err {att_err:.3e}, bf16's own "
                          f"{att_bf16:.3e}")
        if r["head"] <= 0.95 or att_head > 5e-4:
            failed.append(f"B={B}: kernels' head vs float32 head: agreement "
                          f"{r['head']:.4f}, attention {att_head:.3e} (bars 0.95, 5e-4)")
        if err_fused > 1.5 * err_cudnn + 1e-3:
            failed.append(f"B={B}: fused backbone {err_fused:.3e} from float32, unfused "
                          f"{err_cudnn:.3e}")
    fused_f32, cudnn_f32 = (pooled[k] / pooled["ids"] for k in ("fused_f32", "cudnn_f32"))
    log(f"pixels, all {pooled['ids']} ids: agreement with the float32 tree, answer_pixels "
        f"{fused_f32:.4f}, pixels_forward {cudnn_f32:.4f} (bar: no less, less 0.03)")
    if fused_f32 < cudnn_f32 - 0.03:
        failed.append(f"answer_pixels agrees {fused_f32:.4f} with the float32 tree, "
                      f"pixels_forward {cudnn_f32:.4f}")

    # the stage kernel against its plain version at the main path's own stage
    # inputs (B=120, 448 px), walking the backbone as answer_pixels does; the
    # walk's intermediates are the timing phase's inputs
    B = 120
    images, tokens, lengths = pix_data[B][0]
    prep = resnet._prepared(bb)
    walk, stage_err = [], {}
    with torch.no_grad():
        x0 = color_normalize(images.float() / 255.0).to(bf16)
        x = resnet._maxpool(torch.relu(resnet._conv_p(x0, prep["conv1"], 2)))
        for st in range(4):
            down = resnet._prepared_block(bb, prep, st, 0)
            x_down = x
            x = resnet._block(x, down, 2 if st else 1).contiguous()
            stack = resnet._stage_stack(bb, prep, st)
            got = fused_resnet.fused_identity_stage(x, stack)
            want = plain_stage(x, stack)
            e = scaled_err(got, want)
            stage_err[st] = (e, (got.float() - want.float()).abs().max().item())
            bar = stage_bar(stack["w1"].shape[0])
            log(f"fused_identity_stage at the main path's stage {st} input "
                f"{tuple(x.shape)}: max_abs_err/max|want| {e:.3e} (bar {bar}), max_abs_err "
                f"{stage_err[st][1]:.3e}, max|want| {want.float().abs().max().item():.3e}")
            if not e <= bar:
                failed.append(f"stage {st} at B={B}: scale-normalised error {e:.3e} > {bar}")
            walk.append((st, x_down, down, x, stack))
            x = got
            del want
    if failed:
        raise SystemExit("pixels: " + "; ".join(failed))
    log("phase pixels: ok")

    # 7. timing: serving at B=512, T=26
    B = 512
    tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
    with torch.no_grad():
        emb = embed_question(params, tokens).contiguous()
        q = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        ifeat, iatt = embed_image(params["mult"], feats)
        ifeat = ifeat.to(bf16).contiguous()
        iatt = iatt.to(bf16).contiguous()
        lstm = torch_lstm_from(cfg, params["rnn"], dev)
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            emb, lengths.cpu().long(), batch_first=True, enforce_sorted=False)
        _, (h_n, c_n) = lstm(packed)
        lib_state = torch.cat([x for L in range(cfg.rnn_layers)
                               for x in (c_n[L], h_n[L])], dim=1)
        f32_state = lstm_encoder.lstm_encode_reference(params["rnn"], cfg, emb, lengths)
        lib_err = (lib_state - f32_state).abs().max().item()
        log(f"torch.nn.LSTM yardstick vs plain f32 encoder: max_abs_err {lib_err:.3e}")
        if lib_err > 1e-3:
            raise SystemExit("torch.nn.LSTM yardstick does not compute the encoder")

        ms = {
            "lstm_encode": time_ms(lambda: lstm_encoder.lstm_encode(enc, cfg, emb, lengths)),
            "lstm_plain": time_ms(lambda: lstm_encoder.lstm_encode_reference(
                enc, cfg, emb, lengths, dot_dtype=bf16)),
            "lstm_library": time_ms(lambda: lstm(packed)),
            "rau_hops": time_ms(lambda: rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)),
            "hops_plain": time_ms(lambda: rau_hops.rau_hops_reference(
                hw, cfg, q, ifeat, iatt, dot_dtype=bf16)),
        }
        # the rest of the predict step, for its breakdown
        ms["embed_image"] = time_ms(lambda: embed_image(params["mult"], feats))
        ms["embed_question"] = time_ms(lambda: embed_question(params, tokens))
        s_k, d_k, a_k = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        ms["aggregate"] = time_ms(lambda: _aggregate(s_k, d_k, a_k))
        step_ms = time_ms(lambda: step(params, tokens, lengths, feats), iters=10)
    for k, v in ms.items():
        log(f"{k}_ms={v:.4f} B=512 T=26 [{card}]")
    log(f"predict_step_ms={step_ms:.4f} B=512 [{card}]")
    for (B_s, _), batch in zip(serve_batches[:-1], data[:-1]):
        with torch.no_grad():
            t_s = time_ms(lambda: step(params, *batch), iters=10)
        log(f"predict_step_ms={t_s:.4f} B={B_s} T={int(batch[1].max())} [{card}]")
    # the hop kernel at the service's batch sizes: device time (CUDA events),
    # the host's enqueue time of one call (its C entry enqueues 2 + 11 H
    # launches), beside its bound and the floor of reading the features
    # once a hop, which do not fit in L2 at B=512
    hops_kernels = {}
    for (B_s, _), (tok_s, len_s, feats_s) in zip(serve_batches, data):
        with torch.no_grad():
            q_s = lstm_encoder.lstm_encode(enc, cfg, embed_question(params, tok_s).contiguous(),
                                           len_s)
            if_s, ia_s = (x.to(bf16).contiguous() for x in embed_image(params["mult"], feats_s))
            h_ms = time_ms(lambda: rau_hops.rau_hops(hw, cfg, q_s, if_s, ia_s), iters=50)
            host_s = 0.0
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rau_hops.rau_hops(hw, cfg, q_s, if_s, ia_s)
                host_s += time.perf_counter() - t0
            want_k = rau_hops.hops_plan(B_s, cfg).kernels(cfg.n_hops)
            hops_kernels[B_s] = device_kernels(lambda: rau_hops.rau_hops(
                hw, cfg, q_s, if_s, ia_s), want_k, f"rau_hops B={B_s}", card)
        hb_s, hb_s_by = hops_bound(cfg, hw, B_s)
        floor_s = (cfg.n_hops * B_s * cfg.cnn_spat * (cfg.multfeat_dim + cfg.attfeat_dim) * 2
                   / H100_BYTES_PER_S * 1e3)
        log(f"rau_hops_ms={h_ms:.4f} host_enqueue_ms={host_s / 20 * 1e3:.4f} bound_ms="
            f"{hb_s:.4f} by {hb_s_by}, features read each hop {floor_s:.4f} ms; "
            f"{hops_kernels[B_s]} device kernels a call (the plan's {want_k}) B={B_s} [{card}]")
    log(f"predict_step_questions_per_s={B / step_ms * 1e3:.1f} B=512 [{card}]")

    # the encoder at the service's batch sizes, T=26, beside torch.nn.LSTM in
    # float32 (the yardstick) and, logged only, in bf16: the same precision
    # as the kernel's operands.  Neither library call is on the port's path.
    lstm_bf16 = torch_lstm_from(cfg, params["rnn"], dev).to(bf16)
    lstm_bf16.flatten_parameters()
    for B_e in (1, 16, 83, 512):
        tok_e, len_e, _ = make_batch(cfg, B_e, cfg.seq_len, rs, dev)
        with torch.no_grad():
            emb_e = embed_question(params, tok_e).contiguous()
            pk, pk16 = (torch.nn.utils.rnn.pack_padded_sequence(
                x, len_e.cpu().long(), batch_first=True, enforce_sorted=False)
                for x in (emb_e, emb_e.to(bf16)))
            k_ms = time_ms(lambda: lstm_encoder.lstm_encode(enc, cfg, emb_e, len_e), iters=50)
            f_ms = time_ms(lambda: lstm(pk))
            try:
                b_ms = f"{time_ms(lambda: lstm_bf16(pk16)):.4f}"
            except RuntimeError as e:
                b_ms = f"not measured ({str(e).splitlines()[0][:80]})"
        log(f"lstm_encode_ms={k_ms:.4f} torch_lstm_f32_ms={f_ms:.4f} "
            f"torch_lstm_bf16_ms={b_ms} B={B_e} T=26 [{card}]")
        if B_e > 1:   # the plan's row-group choice (ROW_GROUP_MIN_B), both ways
            rg_ms = {}
            for rg in (1, 2):
                plan = lstm_encoder.lstm_plan(B_e, cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers,
                                              n_sm, row_groups=rg)
                with torch.no_grad():
                    rg_ms[rg] = time_ms(lambda: lstm_encoder.lstm_encode(
                        enc, cfg, emb_e, len_e, plan=plan), iters=50)
            log(f"lstm_encode_ms by row groups: 1: {rg_ms[1]:.4f} 2: {rg_ms[2]:.4f} "
                f"B={B_e} T=26 [{card}]")

    lb_ms, lb_by = lstm_bound(cfg, enc, lengths, cfg.seq_len)
    hb_ms, hb_by = hops_bound(cfg, hw, B)

    # training at B=100, T=26: the two kernels, their plain versions, and the
    # train step with its parts
    B = tcfg_t.batch_size
    tokens, lengths, feats = make_batch(mcfg_t, B, mcfg_t.seq_len, rs, dev)
    p0 = state0.params
    mp = p0["mult"]
    seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(args.seed)
    with torch.no_grad():
        q = encode_question(p0, mcfg_t, tokens, lengths)
        fwd_out = rth.train_hops_fwd(mp, mcfg_t, q, feats, seed_t)
        _, _, attprob, c_all, h_all = fwd_out
        g_scores = 1e-3 * torch.randn(H, B, A, device=dev, generator=gen)
        gmerge = (g_scores @ mp["cls"]["w"].T).contiguous()
        em, _ = rth.train_hops_bwd(mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge)
        tms = {
            "train_hops_fwd": time_ms(lambda: rth.train_hops_fwd(mp, mcfg_t, q, feats, seed_t),
                                      iters=10),
            "train_fwd_plain": time_ms(lambda: rth.train_hops_fwd_reference(
                mp, mcfg_t, q, feats, seed_t), iters=5),
            "train_hops_bwd": time_ms(lambda: rth.train_hops_bwd(
                mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge), iters=10),
            "train_bwd_plain": time_ms(lambda: rth.train_hops_bwd_reference(
                mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge), iters=5),
            "train_outside_grads": time_ms(lambda: rth._outside_grads(
                mcfg_t, mp, q, seed_t, h_all, attprob, g_scores, em)),
        }

        def optimizer():
            for i, g in enumerate(PARAM_GROUPS):
                gg = add_gradient_noise(p0[g], gen, 1, tcfg_t.noisy_eta, tcfg_t.noisy_gamma)
                gg, _ = clip_by_global_norm(gg, tcfg_t.grad_clip)
                adam_update(p0[g], gg, lr, state0.opt[g])

        tms["train_optimizer"] = time_ms(optimizer)

    def encoder_fwd_bwd():
        p = {g: map_tree(lambda x: x.detach().requires_grad_(), p0[g])
             for g in ("embed", "rnn")}
        encode_question(p, mcfg_t, tokens, lengths, train=True, generator=gen).sum().backward()

    tms["train_encoder_fwd_bwd"] = time_ms(encoder_fwd_bwd)
    train_ms = time_ms(lambda: train_step(state0, tokens, lengths, feats, labels,
                                          hop_scale, lr, mult_lr), iters=10)
    for k, v in tms.items():
        log(f"{k}_ms={v:.4f} B={B} [{card}]")
    log(f"train_step_ms={train_ms:.4f} B={B} T={mcfg_t.seq_len} [{card}]")
    log(f"train_step_other_ms={train_ms - sum(v for k, v in tms.items() if 'plain' not in k):.4f} "
        f"(loss, gmerge, autograd glue) B={B} [{card}]")
    log(f"train_step_questions_per_s={B / train_ms * 1e3:.1f} B={B} [{card}]")
    busy_ms, top, _, n_k, host = device_profile(lambda: train_step(
        state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr))
    if busy_ms > 0:
        log(f"train_step_device_busy_ms={busy_ms:.4f} of {train_ms:.4f} "
            f"(idle share {1 - busy_ms / train_ms:.3f}; {n_k:.0f} device kernels a step) "
            f"B={B} [{card}]")
        for name, t in top[:8]:
            log(f"train_step_device_ms={t:.4f} {name[:70]}")
        for name, t, n in host[:6]:
            log(f"train_step_host_ms={t:.4f} {name[:50]} ({n:.0f} calls)")
    else:
        log("train_step_device_busy_ms: not measured (the profiler recorded no device time)")
    fb_ms, fb_by = train_fwd_bound(mcfg_t, mp, B)
    bb_ms, bb_by = train_bwd_bound(mcfg_t, mp, B)
    # each training kernel's device kernels a call, as the profiler records
    # them: its plan's phases, every hop; and the forward's peak memory
    fwd_kernels, bwd_kernels, fwd_peak = {}, {}, {}

    def want_fwd(dt):
        return H * len(rth.fwd_plan(B, *fwd_widths, n_sm, dt).phases)

    def want_bwd(dt):
        return H * len(rth.bwd_plan(B, *bwd_widths, n_sm, dt).phases)

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    with torch.no_grad():
        fwd_kernels[torch.float32] = device_kernels(lambda: rth.train_hops_fwd(
            mp, mcfg_t, q, feats, seed_t), want_fwd(torch.float32),
            f"train_hops_fwd float32 B={B}", card)
        fwd_peak[torch.float32] = peak_mb(lambda: rth.train_hops_fwd(
            mp, mcfg_t, q, feats, seed_t))
        bwd_kernels[torch.float32] = device_kernels(lambda: rth.train_hops_bwd(
            mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge), want_bwd(torch.float32),
            f"train_hops_bwd float32 B={B}", card)

    # the bf16 kernels and their plain versions at B=100 on the step's own
    # bf16 casts, then the bf16 fused and the unfused steps, each with its
    # idle share
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    with torch.no_grad():
        q16, feats16 = q.to(bf16), feats.to(bf16)
        _, _, attprob16, c16, h16 = rth.train_hops_fwd(mp16, mcfg_b, q16, feats16, seed_t)
        tms16 = {
            "train_hops_fwd_bf16": time_ms(lambda: rth.train_hops_fwd(
                mp16, mcfg_b, q16, feats16, seed_t), iters=10),
            "train_fwd_bf16_plain": time_ms(lambda: rth.train_hops_fwd_reference(
                mp16, mcfg_b, q16, feats16, seed_t), iters=5),
            "train_hops_bwd_bf16": time_ms(lambda: rth.train_hops_bwd(
                mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge), iters=10),
            "train_bwd_bf16_plain": time_ms(lambda: rth.train_hops_bwd_reference(
                mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge), iters=5),
        }
        bwd_kernels[bf16] = device_kernels(lambda: rth.train_hops_bwd(
            mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge), want_bwd(bf16),
            f"train_hops_bwd bfloat16 B={B}", card)
        fwd_kernels[bf16] = device_kernels(lambda: rth.train_hops_fwd(
            mp16, mcfg_b, q16, feats16, seed_t), want_fwd(bf16),
            f"train_hops_fwd bfloat16 B={B}", card)
        fwd_peak[bf16] = peak_mb(lambda: rth.train_hops_fwd(mp16, mcfg_b, q16, feats16, seed_t))
    for k, v in tms16.items():
        log(f"{k}_ms={v:.4f} B={B} [{card}]")
    for kind, counts, want_of in (("fwd", fwd_kernels, want_fwd), ("bwd", bwd_kernels, want_bwd)):
        for dt, n in counts.items():
            log(f"train_hops_{kind} {dt} device kernels a call: {n} recorded by the "
                f"profiler, {want_of(dt)} in the plan (its phases x {H} hops) B={B} [{card}]")
    for dt, mb in fwd_peak.items():
        log(f"train_hops_fwd {dt} peak device memory a call: {mb:.1f} MB above its inputs "
            f"(outputs, workspace, scratch) B={B} [{card}]")
    fb16_ms, fb16_by = train_fwd_bound(mcfg_b, mp16, B, bf16)
    bb16_ms, bb16_by = train_bwd_bound(mcfg_b, mp16, B, bf16)
    log(f"train_hops_fwd_bound_ms={fb_ms:.4f} by {fb_by}, bf16 {fb16_ms:.4f} by {fb16_by}; "
        f"train_hops_bwd_bound_ms={bb_ms:.4f} by {bb_by}, bf16 {bb16_ms:.4f} by {bb16_by}")
    for name, step_fn in (("bf16_fused", step_b16), ("unfused", step_u),
                          ("unfused_bf16", step_ub)):
        st_ms = time_ms(lambda: step_fn(state0, tokens, lengths, feats, labels, hop_scale,
                                        lr, mult_lr), iters=10)
        log(f"train_step_{name}_ms={st_ms:.4f} B={B} T={mcfg_t.seq_len} [{card}]")
        log(f"train_step_{name}_questions_per_s={B / st_ms * 1e3:.1f} B={B} [{card}]")
        busy_ms, top, _, n_k, host = device_profile(lambda: step_fn(
            state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr))
        if busy_ms > 0:
            log(f"train_step_{name}_device_busy_ms={busy_ms:.4f} of {st_ms:.4f} "
                f"(idle share {1 - busy_ms / st_ms:.3f}; {n_k:.0f} device kernels a step) "
                f"B={B} [{card}]")
            for kname, t in top[:6]:
                log(f"train_step_{name}_device_ms={t:.4f} {kname[:70]}")
            for hname, t, n in host[:6]:
                log(f"train_step_{name}_host_ms={t:.4f} {hname[:50]} ({n:.0f} calls)")
        else:
            log(f"train_step_{name}_device_busy_ms: not measured (no device time recorded)")
    log(f"lstm_encode_bound_ms={lb_ms:.4f} by {lb_by}; "
        f"rau_hops_bound_ms={hb_ms:.4f} by {hb_by}")

    # the mask hash's check entry at the largest shape of its check
    shape = (19, cfg.cnn_spat, cfg.cnn_dim)
    seed_t = torch.tensor([12345], dtype=torch.int32, device=dev)
    mask_ms = time_ms(lambda: maskgen.dropout_mask(seed_t, 0, 0, shape, 81, 0.5))
    mask_plain_ms = time_ms(lambda: maskgen.dropout_scale_mask(
        shape, 81, maskgen.site_salt(seed_t, 0, 0), 0.5))
    mb_ms, mb_by = mask_bound(shape)
    log(f"maskgen_ms={mask_ms:.4f} plain_ms={mask_plain_ms:.4f} bound_ms={mb_ms:.5f} "
        f"by {mb_by} shape={shape} [{card}]")

    # from pixels at B=120, 448 px: answer_pixels and its parts, taken in the
    # order the call runs them, on the pixels phase's walk
    B = 120
    images, tokens, lengths = pix_data[B][0]
    pms, stage_ms = {}, []

    def unfused(x, st, n_blocks):
        for b in range(1, n_blocks):
            x = resnet._block(x, resnet._prepared_block(bb, prep, st, b), 1)
        return x

    with torch.no_grad():
        def normalize():
            return color_normalize(images.float() / 255.0).to(bf16)

        pms["normalize"] = time_ms(normalize, iters=5)
        pms["stem_maxpool"] = time_ms(lambda: resnet._maxpool(
            torch.relu(resnet._conv_p(x0, prep["conv1"], 2))), iters=5)
        for st, x_down, down, x, stack in walk:
            pms[f"down_block{st}"] = time_ms(
                lambda: resnet._block(x_down, down, 2 if st else 1), iters=5)
            Bs, Hs, Ws, C = x.shape
            N, _, Cw = stack["w1"].shape
            row = {"stage": st, "shape": (Bs, Hs, Ws, C, Cw, N),
                   "ms": time_ms(lambda: fused_resnet.fused_identity_stage(x, stack), iters=5),
                   "plain_ms": time_ms(lambda: plain_stage(x, stack), iters=2, warmup=1),
                   "library_ms": time_ms(lambda: unfused(x, st, N + 1), iters=5)}
            row["bound_ms"], row["bound_by"] = stage_bound(Bs, Hs, Ws, C, Cw, N)
            row["plan"] = fused_resnet.stage_plan(Bs, Hs, Ws, C, Cw, n_sm)
            row["weight_gb"] = row["plan"].weight_bytes * N / 1e9
            row["old_weight_gb"] = old_stage_weight_bytes(Bs, Hs, Ws, C, Cw, N) / 1e9
            stage_ms.append(row)
            pms[f"stage_kernel{st}"] = row["ms"]
        # the stage kernel's levers one at a time, on the call's own inputs:
        # the old 4x14 tile at stage 2, the ring's depth at stage 1 (stage 3
        # has no other choice)
        variants = []
        for st, _, _, x, stack in walk[1:3]:
            Bs, Hs, Ws, C = x.shape
            N, _, Cw = stack["w1"].shape
            shape = (Bs, Hs, Ws, C, Cw, n_sm)
            alt = [("the plan", fused_resnet.stage_plan(*shape))]
            if st == 1:
                alt.append(("a 3-deep ring", fused_resnet.stage_plan(*shape, ring=3)))
            if st == 2:
                alt.append(("the old 4x14 tile", fused_resnet.stage_plan(*shape, tile=(4, 14))))
            for name, p in alt:
                v_ms = time_ms(lambda: fused_resnet.fused_identity_stage(x, stack, plan=p),
                               iters=5)
                variants.append((st, name, p, v_ms, p.weight_bytes * N / 1e9))
        x = fused_resnet.fused_identity_stage(walk[-1][3], walk[-1][4])
        feats = x.reshape(B, -1, x.shape[-1]).float()
        pms["head"] = time_ms(lambda: predict_fused(params_r, head_w, cfg_r, tokens, lengths,
                                                    feats), iters=5)
        ans_ms = time_ms(lambda: pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101",
                                                        images, tokens, lengths), iters=5)
    for k, v in pms.items():
        log(f"pixels_{k}_ms={v:.4f} B={B} 448px [{card}]")
    log(f"pixels_rest_ms={ans_ms - sum(pms.values()):.4f} (feature casts, host) B={B}")
    for row in stage_ms:
        p = row["plan"]
        log(f"stage{row['stage']} {row['shape']} (B, H, W, C, Cw, N): kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} unfused_cudnn_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} by {row['bound_by']}; plan: tile {p.th}x{p.tw}, "
            f"ring {p.ring}, {p.smem} B shared memory, "
            f"{stage_regs.get((p.th, p.tw, p.nb, p.ring), 'unknown')} registers, {p.ctas} CTAs; "
            f"L2 weight reads {row['weight_gb']:.3f} GB a call "
            f"(the mma.sync kernel's 8x8/4x14 tiling: {row['old_weight_gb']:.3f}) [{card}]")
    for st, name, p, v_ms, gb in variants:
        log(f"stage{st} variant {name}: tile {p.th}x{p.tw} ring {p.ring}: "
            f"kernel_ms={v_ms:.4f}, L2 weight reads {gb:.3f} GB [{card}]")
    log(f"answer_pixels_ms={ans_ms:.4f} B={B} 448px; images_per_s={B / ans_ms * 1e3:.1f}; "
        f"questions_per_s={B / ans_ms * 1e3:.1f} (one question an image) [{card}]")
    busy_ms, top, ops, _, _ = device_profile(lambda: pipeline.answer_pixels(
        params_r, bb, cfg_r, "resnet101", images, tokens, lengths))
    if busy_ms > 0:
        log(f"answer_pixels_device_busy_ms={busy_ms:.4f} of {ans_ms:.4f} "
            f"(idle share {1 - busy_ms / ans_ms:.3f}) B={B} [{card}]")
        for name, t in top[:10]:
            log(f"answer_pixels_device_ms={t:.4f} {name[:70]} <- {ops.get(name, 'no op')[:110]}")
    else:
        log("answer_pixels_device_busy_ms: not measured (the profiler recorded no device time)")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101", images, tokens, lengths)
    torch.cuda.synchronize()
    log(f"answer_pixels_peak_mb={(torch.cuda.max_memory_allocated() - held) / 1e6:.1f} B={B} "
        f"above the {held / 1e6:.1f} MB held [{card}]")
    # 8. train and evaluate from files through the user's entry point
    t_phase = time.perf_counter()
    with watchdog(900, "the trainer phase"):
        trainer_launches = trainer_phase(args.seed, card)
    log(f"trainer_phase_s={time.perf_counter() - t_phase:.1f} [{card}]")
    log("phase trainer: ok")
    # 9. the HTTP service through the user's entry points
    with watchdog(600, "the serve phase"):
        serve_launches = serve_phase(args.seed, card)
    log("phase serve: ok")
    # 10. the flagship heads from pixels through VGG16 and ViT-L/14
    with watchdog(600, "the backbones phase"):
        backbones_launches = backbones_phase(args.seed, card)
    log("phase backbones: ok")
    # 11. backbone fine-tuning through the user's entry points
    with watchdog(300, "the finetune phase"):
        ft = finetune_phase(args.seed, card)
    ft_launches = ft["launches"]
    log("phase finetune: ok")
    # 12. the paper's workflow through the CLI: prepro to the official score
    with watchdog(600, "the workflow phase"):
        wf_launches = workflow_phase(args.seed, card)
    log("phase workflow: ok")
    # 13. export, the benches, profile and doctor through the user's entry points
    with watchdog(400, "the export_bench phase"):
        eb_launches = export_bench_phase(args.seed, card)
    log("phase export_bench: ok")

    with watchdog(400, "the mesh phase"):
        mesh = mesh_phase(args.seed, card)
    mesh_launches = mesh["launches"]
    log("phase mesh: ok")
    # 15. the transforms, the s2d stem and the int8 ResNet-101
    with watchdog(300, "the variants phase"):
        variants = variants_phase(args.seed, card)
    log("phase variants: ok")
    # 16. the measurement and experiment scripts, each as a user runs it
    with watchdog(900, "the scripts phase"):
        scripts = scripts_phase(args.seed, card)
    log("phase scripts: ok")

    s2 = stage_ms[2]
    kernels = [
        {"name": "lstm_encode", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/lstm_encoder.cu",
         "replaces": "rau_vqa_tpu/ops/lstm_encoder.py:81",
         "launches": launches["lstm_encode"] + serve_launches["lstm_encode"]
         + backbones_launches["lstm_encode"] + ft_launches["lstm_encode"]
         + wf_launches["lstm_encode"] + eb_launches["lstm_encode"],
         "max_abs_err": err["lstm_encode"],
         "ms": ms["lstm_encode"], "plain_ms": ms["lstm_plain"],
         "bound_ms": lb_ms, "bound_by": lb_by, "library_ms": ms["lstm_library"],
         "trainer_launches": trainer_launches["lstm_encode"],
         "serve_launches": serve_launches["lstm_encode"],
         "backbones_launches": backbones_launches["lstm_encode"],
         "finetune_launches": ft_launches["lstm_encode"],
         "workflow_launches": wf_launches["lstm_encode"],
         "export_bench_launches": eb_launches["lstm_encode"]},
        {"name": "rau_hops", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_hops.cu",
         "replaces": "rau_vqa_tpu/ops/rau_hops.py:152",
         "launches": launches["rau_hops"] + serve_launches["rau_hops"]
         + backbones_launches["rau_hops"] + ft_launches["rau_hops"]
         + wf_launches["rau_hops"] + eb_launches["rau_hops"],
         "max_abs_err": err["rau_hops"],
         "ms": ms["rau_hops"], "plain_ms": ms["hops_plain"],
         "bound_ms": hb_ms, "bound_by": hb_by, "library_ms": None,
         "trainer_launches": trainer_launches["rau_hops"],
         "serve_launches": serve_launches["rau_hops"],
         "backbones_launches": backbones_launches["rau_hops"],
         "finetune_launches": ft_launches["rau_hops"],
         "workflow_launches": wf_launches["rau_hops"],
         "export_bench_launches": eb_launches["rau_hops"],
         "device_kernels_a_call": hops_kernels[512]},
        {"name": "train_hops_fwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_fwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:358",
         "launches": train_launches["train_hops_fwd"] + wf_launches["train_hops_fwd"]
         + eb_launches["train_hops_fwd"],
         "workflow_launches": wf_launches["train_hops_fwd"],
         "export_bench_launches": eb_launches["train_hops_fwd"],
         "max_abs_err": err["train_hops_fwd"],
         "ms": tms["train_hops_fwd"], "plain_ms": tms["train_fwd_plain"],
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None,
         "trainer_launches": trainer_launches["train_hops_fwd"],
         "finetune_launches": ft_launches["train_hops_fwd"],
         "device_kernels_a_call": fwd_kernels[torch.float32]},
        # max_abs_err here: the worst norm-relative grad error over the leaves
        {"name": "train_hops_bwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": train_launches["train_hops_bwd"] + wf_launches["train_hops_bwd"]
         + eb_launches["train_hops_bwd"],
         "workflow_launches": wf_launches["train_hops_bwd"],
         "export_bench_launches": eb_launches["train_hops_bwd"],
         "max_abs_err": err["train_hops_bwd"],
         "ms": tms["train_hops_bwd"], "plain_ms": tms["train_bwd_plain"],
         "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": None,
         "trainer_launches": trainer_launches["train_hops_bwd"],
         "device_kernels_a_call": bwd_kernels[torch.float32]},
        # the bf16 instantiations (compute_dtype "bfloat16"); launches: the
        # bf16 fused step's 10 and the workflow phase's; max_abs_err: the worst norm-relative error
        # against the bf16 plain version, the forward's over its outputs,
        # the backward's over the grad leaves
        {"name": "train_hops_fwd_bf16", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_fwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:358",
         "launches": bf16_launches["train_hops_fwd_bf16"] + wf_launches["train_hops_fwd_bf16"],
         "workflow_launches": wf_launches["train_hops_fwd_bf16"],
         "max_abs_err": err["train_hops_fwd_bf16"],
         "ms": tms16["train_hops_fwd_bf16"], "plain_ms": tms16["train_fwd_bf16_plain"],
         "bound_ms": fb16_ms, "bound_by": fb16_by, "library_ms": None,
         "finetune_launches": ft_launches["train_hops_fwd_bf16"],
         "device_kernels_a_call": fwd_kernels[bf16]},
        {"name": "train_hops_bwd_bf16", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": bf16_launches["train_hops_bwd_bf16"] + wf_launches["train_hops_bwd_bf16"],
         "workflow_launches": wf_launches["train_hops_bwd_bf16"],
         "max_abs_err": err["train_hops_bwd_bf16"],
         "ms": tms16["train_hops_bwd_bf16"], "plain_ms": tms16["train_bwd_bf16_plain"],
         "bound_ms": bb16_ms, "bound_by": bb16_by, "library_ms": None,
         "device_kernels_a_call": bwd_kernels[bf16]},
        # the backward with the features' gradient (backbone fine-tuning,
        # fused): launches in the finetune phase's fused steps; at B=96,
        # ours_ms widths, eight hops; max_abs_err: the worst norm-relative
        # error of its outputs (float32) and of dfeats at one hop (bf16)
        # against the plain version
        {"name": "train_hops_bwd_dfeats", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": ft_launches["train_hops_bwd_dfeats"],
         "max_abs_err": ft["err"]["train_hops_bwd_dfeats"],
         "ms": ft["ms"]["train_hops_bwd_dfeats"]["ms"],
         "plain_ms": ft["ms"]["train_hops_bwd_dfeats"]["plain_ms"],
         "bound_ms": ft["bound"]["train_hops_bwd_dfeats"][0],
         "bound_by": ft["bound"]["train_hops_bwd_dfeats"][1], "library_ms": None,
         "without_dfeats_ms": ft["ms"]["train_hops_bwd_dfeats"]["without_ms"],
         "device_kernels_a_call": ft["ms"]["train_hops_bwd_dfeats"]["device_kernels"]},
        {"name": "train_hops_bwd_dfeats_bf16", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": ft_launches["train_hops_bwd_dfeats_bf16"],
         "max_abs_err": ft["err"]["train_hops_bwd_dfeats_bf16"],
         "ms": ft["ms"]["train_hops_bwd_dfeats_bf16"]["ms"],
         "plain_ms": ft["ms"]["train_hops_bwd_dfeats_bf16"]["plain_ms"],
         "bound_ms": ft["bound"]["train_hops_bwd_dfeats_bf16"][0],
         "bound_by": ft["bound"]["train_hops_bwd_dfeats_bf16"][1], "library_ms": None,
         "device_kernels_a_call": ft["ms"]["train_hops_bwd_dfeats_bf16"]["device_kernels"]},
        # the check entry of the device hash; launches: its check's
        {"name": "maskgen", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/maskgen.cu",
         "replaces": "rau_vqa_tpu/ops/maskgen.py:34",
         "launches": mask_launches, "max_abs_err": 0.0,
         "ms": mask_ms, "plain_ms": mask_plain_ms,
         "bound_ms": mb_ms, "bound_by": mb_by, "library_ms": None},
        # at stage 2 of the main path (B=120, 448 px), the other stages in
        # the lines above: max_abs_err absolute, scaled_err over max|want|
        # (activations reach ~1e5 there); library_ms: the unfused stage
        # (three F.conv2d a block, bf16 channels_last through cuDNN)
        {"name": "fused_identity_stage", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/fused_resnet.cu",
         "replaces": "rau_vqa_tpu/ops/fused_resnet.py:129",
         "launches": pix_launches["fused_identity_stage"]
         + serve_launches["fused_identity_stage"] + eb_launches["fused_identity_stage"],
         "serve_launches": serve_launches["fused_identity_stage"],
         "export_bench_launches": eb_launches["fused_identity_stage"],
         "max_abs_err": stage_err[2][1], "scaled_err": stage_err[2][0],
         "ms": s2["ms"], "plain_ms": s2["plain_ms"],
         "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
         "library_ms": s2["library_ms"]},
    ]
    # the mesh phase's launches: (a) here and (b) on its 2 ranks
    for k in kernels:
        k["mesh_launches"] = mesh_launches.get(k["name"], 0)
        k["variants_launches"] = variants["launches"].get(k["name"], 0)
        k["scripts_launches"] = scripts["launches"].get(k["name"], 0)
        k["launches"] += k["mesh_launches"] + k["variants_launches"] + k["scripts_launches"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
