#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; no phase's failure is caught):

1. Build every CUDA kernel from ``dgc_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel), launch the candidates and compensate libraries
   once and compile the Triton kernel (``compensate_bits``).
1b. A flat layout of 2**31 slots or more, first, on the empty card
   (``phase_large_layout``): ResNet-50 at the epoch-5 ratio beside a
   synthetic compressed tensor of 2**31 + 128 elements (T =
   2,174,683,136), the bf16 error-feedback state. The index dtypes int64
   and the apply fed the int64 wire; every kernel that meets offsets past
   2**31 held bitwise against its plain version over the whole buffer,
   chunk by chunk (a window across 2**31 and ResNet-50's region whole
   among the chunks): ``compensate_bits``' 64-bit form,
   ``compensate_bits_cands`` and ``seg_top2_candidates`` at f32 and bf16
   state, ``topk_rows`` on the 3-D fallback's [65536, 32770] candidate
   rows, ``apply_rows``' 64-bit form on a W=2 payload (and one inside the
   window, outside which nothing changes), ``opaque_view_from`` past and
   across 2**31; then W=2 workers take 2 steps through
   ``DistributedOptimizer.update_flat`` under the conservation probe
   (C1-C3 bitwise, its copies on the host), the path's 64-bit launches
   counted; ResNet-50's slice of the parameters, exchanged gradient and
   memory bitwise the ResNet-50-only layout's fed the same gradients and
   draws; the times against their bounds, the 32-bit compensates re-timed
   at ResNet-50's T, and the peak allocated memory. The kernels line
   lists these 64-bit forms as ``<kernel> int64``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the DGC paths give it — ResNet-20 across the wm5 warm-up for
   ``compensate_bits``, ``topk_rows`` and ``apply_rows``, ResNet-110 at
   the epoch-0 and epoch-5 ratios for those three (the
   ``resnet110_wm5o`` path's shapes), and ResNet-50 at the epoch-0 and
   epoch-5 ratios for ``topk_rows``, ``apply_rows`` and the segment
   candidates (with ties planted in every segment bucket), both models'
   guarded weights for the opaque copies, and every bucket the
   megakernel or the fused select takes at epochs 3-5 of both models
   for ``dgc_forward_rows`` and ``select_pack_rows`` (plus the gate's
   widest row, an empty row at an unaligned base, k = 1 and 1,024 on a
   cluster shape, the sort and block routes, all momentum flags, ties
   planted around the plan's slice boundaries, a valid-column tail ending
   inside a non-first slice and a selected -0.0, each twice; an unstaged
   ``select_pack_rows``; with ``--old-select-src DIR``, the earlier
   kernels' sources unpacked from ``git archive c58eb1e dgc_tpu_torch/csrc``, their
   times in turns with the new ones, ``old_ms``); ``apply_rows`` also at planted
   payloads through both of its routes (4,096 boundaries, a partial last
   chunk, a hot chunk past its shared memory, W=8 on every coordinate,
   zero, -0.0, NaN and out-of-range entries, n = 0, over 12,288 chunks,
   divisors 3 and none), each real shape run twice and required bitwise
   equal; the compensate kernel (``csrc/compensate.cu``, many tensors a
   launch) over one ResNet-20 worker's 22 compressed tensors, the 88 of a
   W=4 step, ResNet-50's 216 (over one launch's capacity), views at odd
   offsets of one flat buffer and n = 0..5 entries, f32 and bf16 state,
   every flag, and ``fused_compensate`` / ``fused_compensate_masked`` at
   one tensor of 4,096 and of 65,536 elements and at n = 2,101,248 (f32
   state) and 2,105,345 (bf16), every flag
   combination, infinities, NaNs and bf16 rounding ties planted (with
   ``--old-compensate-src PATH``, an earlier ``ops/kernels.py`` such as
   ``git show 2bc9984:dgc_tpu_torch/ops/kernels.py``, its Triton kernels
   held bitwise and timed in turns, ``old_ms``);
   ``ladder_counts`` at [17, 262144], L = 11, with values
   planted on the levels, at L = 128 with cols % 4 != 0, at unaligned row
   bases, at ResNet-50's adaptive buckets at the
   epoch-0 and epoch-5 ratios, and at L = 1 at ResNet-20's and
   ResNet-110's adaptive buckets (the non-resample adaptation's count; the
   kernel's line reports the first of these), one launch each, each also timed at a block
   a row and, where its plan splits the levels, at one split (with
   ``--old-ladder-src DIR``, the earlier sources
   from ``git archive 2bc9984 dgc_tpu_torch/csrc``, the earlier kernel in
   turns) — bitwise; and time kernel, plain
   version and the PyTorch yardstick call, L2-warm: each time is the
   device time per call, 20 calls queued behind a spin kernel so the card
   runs them back to back (``ms``, also printed as ``kernel_ms``, is the
   kernel's; the 2.1M-element compensates also get ``ms_l2_cold``; the
   compensate tables are timed behind a 0.1 s hold, as they queue many
   launches).
   ``topk_rows`` runs every path call twice (bitwise each time), with its
   route from ``kernels.topk_plan`` and, with ``--old-src PATH`` (an
   earlier source with today's launch signature, beside its own headers,
   e.g. ``topk_rows.cu`` from ``git archive c58eb1e dgc_tpu_torch/csrc``),
   the earlier kernel's time beside it (``old_ms``); and
   planted cases on each route, twice each (ties at the slice boundaries
   cols/8*j +- 1, k = cols, k = 1, all-equal and all-zero rows, -0.0,
   -1/-inf sentinels, columns that are not a multiple of 4 or 128, a row
   too wide to stage). The opaque copy is re-timed in turns with
   ``clone`` (200 pairs at 512, 2,048 and 4,096 elements; with
   ``--old-copy-src PATH`` the earlier kernel too). The candidates kernels
   (``csrc/seg_top2.cu``) run twice at ResNet-50's T (all four momentum
   flag combinations for the fused one, its m and v also against
   ``compensate_bits``) and buckets, and twice on planted segments (ties
   of opposite signs straddling the record rows, at blocks 0 and 255,
   +-inf, an all -0.0 lane, a ragged tail with sent bits); with
   ``--old-cands-src PATH`` (an earlier ``dgc_tpu_torch/ops/kernels.py``,
   e.g. ``git show 5427a94:dgc_tpu_torch/ops/kernels.py``) its two Triton
   candidates kernels are held bitwise against the new ones and timed in
   turns with them (``old_ms``).
   VGG-16 (the engines at epochs 0, 1, 4 and 5) is one more model of the
   same holds: ``topk_rows`` at every call of one worker's step that it
   takes (the 3-D fallback's per-(row, lane) candidates over the [R *
   128, nb] view, up to [2048, 50176], their top-k, the thresholds, epoch
   5's segment selections), and on a planted tie column, where the lower
   block comes first; ``apply_rows`` on real W=4 payloads at epochs 0
   (n = 175.0M) and 5; ``compensate_bits`` and ``compensate_bits_cands``
   (all four momentum flags, ties planted in its segment buckets) at
   VGG's T = 139,028,480, twice each. Each kernel's VGG summary is its
   line's ``vgg16_bn`` entry.
   The bf16 error-feedback state (``phase_bf16_kernels``):
   ``compensate_bits`` (infinities, NaNs and -0.0 planted in the state)
   and ``compensate_bits_cands`` under all four momentum flags,
   ``seg_top2_candidates`` on the stored bf16 velocity, each twice and
   bitwise its plain version at ResNet-50's and ResNet-20's T (ties
   planted in ResNet-50's segment buckets), timed beside the f32 state
   at the same T with both byte bounds; ``topk_rows`` on bf16 rows at
   ResNet-50's epoch-4 buckets. Each of the three kernels' line gets a
   ``bf16`` entry.
   Stdout gets a summary line per kernel (and per apply shape, epochs 0
   and 5); the per-call detail and every path's launch counts go to
   ``chiprun_out/chip_smoke_detail.json``.
3. Check the flat engine's W=4 exchange on the card against the same
   exchange on the CPU (plain versions) on one input: bitwise, for
   ResNet-20 at the epoch-0 and epoch-5 ratios, ResNet-50 at epoch 0 and
   ResNet-110 at epoch 5 (ResNet-50's epoch 5 is held again by the
   telemetry and resilience slices', ResNet-110's epoch 0 is ResNet-20's
   route), and with
   ``megakernel=True`` and ``fused_select=True`` at the epoch-3 and
   epoch-5 ratios (ResNet-50: epoch 5; the card's megakernel engine also
   against the card's default engine); and ``engine.sparsify(vec, phases)`` without
   candidates (the standalone candidates kernel) against the same call
   with the fused candidates. The per-tensor W=4 exchange
   (``DistributedOptimizer.exchange``) on the card against the CPU at
   ResNet-20's epoch-0 and epoch-5 ratios (bitwise, memory included,
   apart from coordinates several workers sent: rtol 1e-6), and against
   the card's flat engine at ratio 0.05, ``sample_ratio=1.0`` (ResNet-20
   3 steps, ResNet-50 1; rtol 1e-5, atol 1e-6). At W=3, where 1/W is
   inexact, ResNet-20's flat exchange card == CPU bitwise at the epoch-0
   and epoch-5 ratios, and its per-tensor exchange as at W=4: the divide
   by W is an IEEE divide on both devices (``kernels.divide_exact``).
   The all-dense branch (``resnet20_wm5o`` at epoch 4) card == CPU bitwise
   at W=4 and W=3 over a compressed step, two dense steps (the pending
   record folded) and a compressed step; the engine with ``resample=False,
   strided_sample=False`` card == CPU bitwise at epochs 0 and 5; the
   engine with the memory's ``gradient_clipping`` (a norm clip, and the
   global one) at W=3, epochs 4 and 5, within rtol 1e-6, records equal.
   VGG-16's W=2 exchange card == CPU at the epoch-0 ratio (the 3-D
   fallback on the split fc buckets, n = 87.5M entries applied a worker),
   one step, bitwise (its epoch-5 segment path is ResNet-50's).
   The wires (``phase_wires_vs_cpu``): ResNet-20's W=4 exchange card ==
   CPU bitwise, 2 steps at the epoch-0 and epoch-5 ratios, for every wire
   regime as a uniform plan (dense, fp32, fp16 and int8 with plain or
   packed indices, int4_packed, int8_delta_idx), three mixed plans, int8
   without error feedback, the int64 index wire and the bf16 state;
   ``wire_bytes_per_worker`` printed for each.
   Then run to run: ResNet-20 (flat, default route, W=4) trained 2 steps
   at the epoch-0 ratio twice from one seed, parameters, momentum and
   memory bitwise equal.
4. The ResNet-20 path: full width, batch 128 per worker, W=4 ``LocalComm``
   workers on the card — 2 steps at the epoch-0 ratio, the engine
   rebuild, 2 steps at 0.001.
4b. The ResNet-50 path (the main path): full width, 224x224
   synthetic ImageNet, batch 32 per worker, W=4 ``LocalComm`` workers on
   the card — 1 step at the epoch-0 ratio 0.316 (the ``lax_top_k`` route),
   the engine rebuild, 3 steps at 0.001 (the segment path).
4c. The standalone-candidates path: ``engine.sparsify`` with no candidates
   at ResNet-50 geometry, for 4 workers.
4d. The megakernel paths, W=4 on the card as above: ``resnet20_wm5_
   megakernel`` 2 steps at epoch 3 and 2 at epoch 5; ``resnet20_wm5``
   with ``fused_select`` 2 and 1; ``resnet50_wm5_megakernel`` 1 and 2.
   Each path's launch counters are zeroed just before it and read just
   after; every kernel that the path runs must have launched. A kernel's
   ``launches`` is the count of its own path (ResNet-50, else the one
   path named in ``_OWN_PATH``); the detail file has every path's.
   After the ResNet-20 path, the masked check: ``fused_compensate_
   masked`` on its engine's own transmit record and state, bitwise
   ``compensate_bits``.
4e. The per-tensor path ``resnet20_per_tensor``: ``train_step_per_tensor``
   at full width, batch 128 per worker, W=4 ``LocalComm`` on the card, 2
   steps at the epoch-0 ratio, the compressor's re-initialisation, 2 at
   0.001: one ``fused_compensate`` launch a step (the 88 compressed
   tensors of the 4 workers), no ``compensate_bits``.
4g. The slice of the reference's remaining recipes, W=4 on the card, each
   path's counts zeroed just before each epoch and read just after:
   ``resnet110_wm5o`` (ResNet-110, batch 128 per worker) 2 steps at epoch
   4 (ratio 1, the all-dense exchange: none of ``compensate_bits``,
   ``topk_rows``, ``apply_rows``) and 2 at epoch 5 (0.001: all three), then
   ``Trainer.evaluate("test")`` (top-1 and top-5 finite, in [0, 100]); the
   dense baseline ``resnet20`` (stock SGD, ``FlatDenseExchange``) 2 steps,
   no DGC kernel; ``resnet20_nonresample`` (``resnet20_wm5`` with
   ``resample=False, strided_sample=False``) 2 steps at epoch 5, which
   launch ``ladder_counts`` (one level, each adaptation round).
4f. The ladder check: on the flat engine's own velocity at each wm5
   ratio of ResNet-20 and ResNet-50, every bucket whose selection is an
   exact top-k of the row and that adapts: ``_ladder_adapt`` (through
   ``ladder_counts``) bitwise ``_ladder_adapt_from_topk``.
4h. The run lifecycle. Resume is bitwise at full width, W=4 on the card:
   ``resnet20_wm5`` (epochs 4 and 5, 2 steps each), ``resnet110_wm5o``
   (1 step each across its dense -> compressed handover: epoch 4 at
   ratio 1, epoch 5 at 0.001) and ``resnet50_wm5`` (1 step each, the
   segment path) run
   uninterrupted, then again as epoch 4, a checkpoint save, a fresh
   ``Trainer`` that restores, and epoch 5: the losses, parameters,
   optimizer state, every worker's memory and transmit record, BatchNorm
   statistics and sampling generators bitwise, epoch 5's launch counts
   equal; the checkpoint's bytes and its save and restore seconds printed.
   The input path on ResNet-50 (W=4, epoch 5, 2 steps): batches from the
   prefetch thread in pinned memory, uploaded on a side stream one step
   ahead, bitwise the inline pageable batches (losses and state); 3 more
   steps under the profiler give the host-to-device copies by memory
   kind and the device's busy share (the inline path's too with
   ``--profile``). The host crop kernel (``csrc/crop_flip_normalize.c``,
   gcc) bitwise its numpy version on 512 CIFAR images, both host times
   printed.
4i. The VGG-16 path (``vgg16_bn_wm5``: full width, 224x224 synthetic
   ImageNet, batch 32 a worker, W=4 on the card, dropout from each
   worker's generator): one step at each of epochs 0 and 4 (the 3-D
   fallback: ``sel3d`` counted, no candidates kernel) and two at epoch 5
   (the segment path: ``compensate_bits_cands``, no ``sel3d``), every
   epoch launching ``topk_rows`` and ``apply_rows``, then the evaluation;
   its bf16 twin (``vgg16_bn_wm5_bf16``) one step at epochs 0 and 5, no
   opaque copy, its first loss within 2% of the f32 path's; resume
   bitwise across the 3-D -> segment handover (epochs 4 -> 5, the
   dropout generators included).
4j. The slice's path (``phase_slice_path``):
   ``resnet50_wm5_bf16mem_int8_packidx`` (the bf16 state, the int8 wire
   with error feedback, bit-packed indices) at full width, batch 32 a
   worker, W=4: 1 step at epoch 4 (``compensate_bits`` on the bf16 state)
   and 3 at epoch 5 (``compensate_bits_cands`` on it), each epoch's
   launches of the compensates, ``topk_rows`` and ``apply_rows`` the
   engine's predicted counts (``_predicted_launches``), the record empty;
   its resume bitwise across the handover (in 4h's list). ResNet-20 with
   ``--autotune``'s block (``phase_autotune``): the plan, 3 steps at epoch
   4, the refit and replan, 2 steps at epoch 5, the second refit,
   ``fabric.json``.
4k. The resilience slice (``phase_guard_vs_cpu``,
   ``phase_resilient_path``, ``phase_preempt_drill``, ``phase_elastic``,
   ``phase_twotier_adasum_vs_cpu`` and their training paths). ResNet-50's
   checksummed engine at the epoch-4 and epoch-5 ratios, W=4, card == CPU
   bitwise with ``DGC_FAULTS`` armed (``bitflip`` and a negative, then an
   out-of-range ``badidx``), the mismatch counts equal; all-NaN gradients
   through the compensate, selection and apply kernels at full width, no
   fault, every payload index in [0, T) or on the sentinel; the guard
   snapshot and revert and the checksum timed. ``resnet50_wm5_resilience``
   at full width, W=4: 1 step at epoch 4 and 3 at epoch 5 with ``nan@2``,
   the bitflip and the bad indices: the skipped step's state bitwise its
   pre-step state, the counters the CPU's, and every epoch's launches and
   every collective the unguarded ``resnet50_wm5`` path's. The preemption
   drill through the CLI in subprocesses, ResNet-20 and ResNet-50
   (resilience recipes, W=4): ``kill@K`` -> exit 75 -> the same command ->
   the mid-epoch resume, whose losses and final checkpoint are bitwise the
   uninterrupted run's. The elastic restore at ResNet-50's geometry: 4 ->
   2 (merge, nbps 2), 2 -> 4 (split) and 4 -> 3 (collapse), the total
   error-feedback mass conserved, each trained on. The two-tier exchange
   (2 nodes x 2) card == CPU bitwise at ResNet-20's epoch-0 and epoch-5
   ratios and ResNet-50's epoch 5; Adasum (``op="adasum"``) at W=4
   (recursive doubling) and W=3 (the gathered reduce) card == CPU within
   rtol 1e-5 (its dot products sum in another order); the paths
   ``resnet50_twotier`` (W=4 as 2 x 2, epochs 4 and 5) and
   ``resnet20_adasum`` at W=4 and W=3 (``AdasumDistributedOptimizer``,
   epoch 5).
4l. The telemetry slice (``phase_telemetry_vs_cpu``,
   ``phase_telemetry_path``, ``phase_adaptive_path``). The engine's step
   stats (``exchange(..., telemetry=True)``, W=4) card == CPU at
   ResNet-50's epoch-4 and epoch-5 ratios and at ResNet-20 with the bf16
   state and int8 error feedback: the payload counts, the selected
   fractions, the thresholds and the wire bytes bitwise, the norms within
   rtol 1e-5 (CUDA and CPU sums reduce in other orders).
   ``resnet50_wm5_telemetry`` (the taps, the fleet gather, the CLI's sink)
   at full width, W=4, 1 step at epoch 4 and 3 at epoch 5, against
   ``resnet50_wm5`` on the same schedule: every epoch's launches equal,
   the collectives the plain path's plus one all-gather a step, the step
   thread's synchronising calls over 2 steps under the profiler equal
   with telemetry on and off, one sink record a step under a valid
   header, a traced window (the phase markers on, a step at epochs 4 and
   6) through ``telemetry.attrib.phase_table`` with every
   ``compensate_bits`` (``_cands``), ``topk_rows`` and ``apply_rows`` event
   in the ``compensate``, ``select`` and ``apply`` phase (the attributed
   share printed), and both paths' step times in turns.
   ``resnet50_wm5_adaptive``, the same schedule, fed the clocks
   ``_CLOCKS`` (step 2 skewed: worker 3 150 ms past the 200 ms median):
   worker 3 sends 1 - 0.75 x 150 / 500 of its quota at step 3
   (``adaptive_engaged`` 1) and all of it at step 4; the launches the
   plain path's; that engine's exchange at those fractions card == CPU
   bitwise, worker 3's wire the slots of rank below ``ceil(quota x
   0.775)``, its withheld selections in its velocity and out of its
   transmit record.
4m. The serving slice (``phase_serving_path``, ``phase_surgery_drill``).
   ``resnet50_wm5`` at full width, W=4, 1 step at epoch 4 and 3 at epoch
   5, with an ``Exporter`` on the card (ratio 0.001) publishing the base
   before step 1 and a delta after each step from the trainer's
   parameters, and two card ``Replica``s and one CPU ``Replica`` polling
   after each publish: every replica's digest the exporter's at every
   ``(V, S)`` (the apply card == CPU), 8 ``topk_rows`` launches a delta,
   52,085 B an update; then a second stream over 3 more steps with
   ``DGC_SERVE_DROP=1:2``: the replicas report the gap, the next publish
   rebases to V=2 and every replica ends at its digest. ``topk_rows`` is
   held and timed at the 8 buckets' shapes (the line's ``serving``
   entry), the real publish ticks split into flatten, encode, apply,
   digest and write, and a delta poll and the rebase's poll timed on
   each device. The surgery drill through
   ``train.main`` in this process (``--surgery``, W=4 on one process): an
   excise order for process 0 before step 2 -> exit 76, the exit record,
   the order cleared -> the same command resumes at batch 1, bitwise the
   uninterrupted run.
4n. The control slice (``phase_control_drill``): a ``ControlPlane`` in a
   process of its own (never initialising CUDA) supervises three
   ``resnet20_wm5_control`` trainers (W=4) on the card: ``steady`` killed
   after step 2 (exit 75), relaunched and resumed bitwise the
   uninterrupted run (whose launches show ``compensate_bits``,
   ``topk_rows`` and ``apply_rows``); ``cursed`` aborted by the non-finite
   streak (exit 70, one launch, quarantined on its flight dump); ``hung``
   SIGKILLed from its stale heartbeat within a 30 s budget and a poll;
   every fleet event under its run's ``run_id``, the fleet monitor's
   exposition over all three; ``python -m dgc_tpu_torch.control`` on a
   clean run exits 0. The relaunch, the hang's detection, the plane's tick
   and ``collect_fleet`` are timed.
4o. The gossip slice (``phase_gossip_path``): the flat engine on gossip
   plans at ResNet-50's epoch-5 geometry, W=4, 8 rounds for each topology
   (ring: ``sync_every`` 2, ``max_staleness`` 4; hcube: masks 1-3) card ==
   CPU bitwise (the CPU side on a thread while the VGG paths run), each
   round's velocity mass balanced against residual, inbox and output
   within 1e-6; the ``droplink:peer=3@1-5`` ladder (forced syncs and
   worker 3's ages exact); ``resnet50_wm5_gossip`` at full width with the
   fleet taps (1 step at epoch 4, 3 at 5): the staleness lanes and forced
   count ``round_state_np``'s, the launches the written prediction
   (``seg_top2_candidates`` on a training path, no
   ``compensate_bits_cands``), its step time and ``resnet50_wm5``'s in
   turns; ``resnet20_wm5_gossip`` resumed bitwise with the inbox in
   flight, and that checkpoint restored elastically on 2 workers (inbox
   and mass conserved, ages merged by max).
   The analysis slice (``phase_analysis``): the lints, the race lint and
   the model checker over the port's writers (``drop_fsync`` red); the
   33 contracts over recorded steps of the W=8 fixture on the card, and
   two that read a profiler window (guards and telemetry add no
   synchronising call over the plain step); ``resnet50_wm5`` W=4, a step
   at epoch 4 and one at 5 under the verifier's recorder: the recorded
   collectives ``Plan.collectives()`` plus the loss mean, error-feedback
   conservation bit for bit for every worker and bucket (red on C3 under
   ``DGC_VERIFY_MUTATE=drop_foldback``), the alias coverage and the
   card's peak memory, the launches the engines' own count.
5. One step through ``ProcessGroupComm`` on a one-rank NCCL group. Then
   the CLI in subprocesses from a scratch directory: ``torchrun
   --standalone --nproc_per_node=1`` trains ``resnet20_wm5`` as one NCCL
   rank through ``parallel.multihost.initialize_multihost``, 2 epochs of
   2 steps saved, its losses bitwise those of
   ``LocalComm(1)`` with the same flags; ``--evaluate`` in a second
   process restores ``best`` and prints the best epoch's top-1 and top-5.

With ``--profile``, ``torch.profiler`` (device activity only) also records
three more steps of each model (VGG-16 in 4i) at ratio 0.001 and prints
their step times, the device time by kernel and the device's busy share
of the same window; then three more traced with host ops and their
shapes, for the share of the device time in autograd's per-view [P]
gradient sums (the kernels of [P]-sized fills and adds inside the
backward); and 4h also traces the inline input path.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It trains in full f32
with cuDNN restricted to deterministic algorithms, as the port's entry
points set it (``utils.device.set_reproducible_numerics``).
"""

import functools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: where the per-call detail of the kernel checks and the compiler's
#: report are written (stdout keeps a summary)
DETAIL_PATH = Path(__file__).resolve().parent / "chiprun_out" / \
    "chip_smoke_detail.json"
BUILD_LOG = DETAIL_PATH.with_name("chip_smoke_build.log")

# H100 SXM, NVIDIA data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
DEVICE = "cuda"
#: ``--old-src PATH``: the earlier top-k source, timed beside the kernel;
#: ``--old-copy-src PATH``: the earlier opaque copy, timed in the re-time;
#: ``--old-cands-src PATH``: an earlier ``dgc_tpu_torch/ops/kernels.py``
#: whose candidates kernels are timed in turns with the new ones;
#: ``--old-select-src DIR``: the earlier select-and-pack and forward
#: kernels' sources, timed in turns with the new ones
OLD_TOPK_SRC = None
OLD_SELECT_SRC = None
OLD_COPY_SRC = None
OLD_CANDS_SRC = None
#: ``--old-compensate-src PATH``: an earlier ``dgc_tpu_torch/ops/kernels.py``
#: whose Triton compensates are timed in turns with the new kernel;
#: ``--old-ladder-src DIR``: the earlier sources, whose ``ladder_counts.cu``
#: is timed in turns with the new one
OLD_COMPENSATE_SRC = None
OLD_LADDER_SRC = None
#: what goes to :data:`DETAIL_PATH` besides the kernels' per-call detail
DETAIL = {}


def _device_ms(fn, reps=20, warmup=3, hold_cycles=20_000_000):
    """Device time per call over ``reps`` back-to-back calls. A spin
    kernel (``hold_cycles`` clocks, ~10 ms) holds the stream while the
    host queues the calls behind it, so the events measure the card
    running them with no host launch gaps (a call that waits for the
    device on the host, as ``apply_rows_plain`` does, keeps its gap)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(**fns):
    """``{key: device ms}`` for each of ``ms=kernel, plain_ms=plain,
    library_ms=library`` given."""
    return {key: _device_ms(fn) for key, fn in fns.items()}


def _cold_ms(fn):
    """Device time per call with the 50 MB L2 flushed before each call:
    each call follows a 128 MB fill, whose own time is subtracted."""
    import torch
    flush = torch.empty(32 * 1024 * 1024, device=DEVICE)
    both = _device_ms(lambda: (flush.fill_(1.0), fn()))
    return both - _device_ms(lambda: flush.fill_(1.0))


def _bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the larger of the bytes the call must move
    over the HBM rate and its operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the recipes' wire flags, which the compressor takes as they are
_WIRE_FLAGS = ("fp16_values", "int8_values", "int8_error_feedback",
               "packed_indices", "int32_indices")


def _geometries(recipe="resnet20_wm5", epochs=range(6), clip=None,
                plan=None, mem_dtype=None, **flags):
    """The flat engine's bucket geometry for a recipe's model at the
    warm-up ratios of ``epochs``, with the recipe's wires and memory dtype,
    the compressor's ``flags`` (``megakernel``, ``fused_select``,
    ``resample``, ``strided_sample``, the wires) and the memory's
    ``gradient_clipping`` ``clip``; ``plan``, one regime a bucket of each
    epoch's engine (a sequence, or a regime name for every bucket);
    ``mem_dtype`` the memory's dtype in place of the recipe's:
    {epoch: (compress ratio, engine)}."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression.dgc import DGCCompressor
    from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
    from dgc_tpu_torch.compression.memory import DGCSGDMemory
    from dgc_tpu_torch.models import from_config, param_tree
    cfg = configs.RECIPES[recipe]()
    cc = cfg.train.compression
    wires = {k: cc[k] for k in _WIRE_FLAGS if k in cc}
    comp = DGCCompressor(
        cc.compress_ratio, memory=DGCSGDMemory(
            cc.memory.momentum, nesterov=cc.memory.nesterov,
            momentum_masking=cc.memory.momentum_masking,
            gradient_clipping=clip,
            dtype=mem_dtype or cc.memory.get("dtype")),
        sample_ratio=cc.sample_ratio, warmup_epochs=cc.warmup_epochs,
        warmup_coeff=cc.warmup_coeff, **{**wires, **flags})
    model = from_config(cfg.model, torch.Generator())  # shapes only
    tree = param_tree(model)
    comp.initialize((n.replace(".", "/"), tuple(p.shape))
                    for n, p in model.named_parameters() if p.dim() > 1)
    out = {}
    for epoch in epochs:
        comp.warmup_compress_ratio(epoch)
        layout = ParamLayout.for_compressor(tree, comp)
        regimes = plan
        if isinstance(plan, str):
            regimes = (plan,) * len(FlatDGCEngine(comp, layout).buckets)
        out[epoch] = (comp.compress_ratio,
                      FlatDGCEngine(comp, layout, plan=regimes))
    return out


def _ptxas_summary(log):
    """``kernel<template flags>: registers, spill stores`` of each entry
    function in ``nvcc -Xptxas -v`` output."""
    def kernel_name(mangled):
        # a length-prefixed identifier ending in "kernel", and its bool
        # template arguments (CLUSTER, STAGED) where it has them
        for m in re.finditer(r"\d+", mangled):
            for k in range(len(m.group())):
                end = m.end() + int(m.group()[k:])
                ident = mangled[m.end():end]
                if re.fullmatch(r"[A-Za-z_]\w*kernel", ident):
                    t = re.match(r"I((?:Lb[01]E)+)E", mangled[end:])
                    if t:
                        return ident + "<" + ",".join(
                            re.findall(r"[01]", t[1])) + ">"
                    # an index-type template (int or long long)
                    t = re.match(r"I([ix])E", mangled[end:])
                    return ident + ({"i": "<int>", "x": "<long long>"}[t[1]]
                                    if t else "")
        return mangled

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = kernel_name(m.group(1)), "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} regs, {spills} B spilled")
            name = None
    return out


def phase_build():
    import contextlib
    import io
    import torch
    from dgc_tpu_torch.ops import build, kernels
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build(verbose=True)
    t_nvcc = time.perf_counter() - t0
    BUILD_LOG.parent.mkdir(exist_ok=True)
    BUILD_LOG.write_text(log.getvalue())
    print(f"[build] ptxas ({BUILD_LOG.name}): "
          + "; ".join(_ptxas_summary(log.getvalue())))
    n = 2 * kernels.SEG_SPAN
    g = torch.zeros(n, device=DEVICE)
    bits = torch.zeros(kernels.num_sent_words(n), dtype=torch.int32,
                       device=DEVICE)
    # the candidates and compensate libraries (CUDA C++): loaded and
    # launched once
    kernels.compensate_bits_cands(g, torch.zeros_like(g),
                                  torch.zeros_like(g), bits, 0.9)
    kernels.seg_top2_candidates(g, 0, 2, kernels.SEG_SPAN)
    kernels.fused_compensate(g, torch.zeros_like(g), torch.zeros_like(g),
                             0.9)
    t0 = time.perf_counter()
    kernels.compensate_bits(g, torch.zeros_like(g), torch.zeros_like(g),
                            bits, 0.9)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"[build] nvcc {t_nvcc:.1f} s (parallel), triton {t_triton:.1f} s")


def _check_equal(name, got, want):
    """Bitwise equality of each pair (floats by their bits, so signed
    zeros and NaN payloads count); returns the largest absolute difference
    over the finite values, which bitwise equality makes 0.0."""
    import torch
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if a.dtype in bits:
            same = torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
        else:
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"{name}: kernel and plain version differ")
    return 0.0


def _topk_inputs(eng, gen, host_gen):
    """``(role, input, k)`` of every top-k kernel call one worker's step
    makes with this engine, on random data: each bucket's selection and
    sampled threshold, over the [R, cols] importance (2-D path), the
    candidates and the raw-view samples (segment path), or the per-(row,
    lane) candidates' [R * 128, nb] view, their [R, kp * 128] layout and
    the raw-view samples (3-D fallback)."""
    import torch
    from dgc_tpu_torch.compression import flat
    from dgc_tpu_torch.ops import kernels as K
    consts = eng._bucket_consts(torch.device(DEVICE))
    vec = torch.randn(eng.T, device=DEVICE, generator=gen)
    out = []
    for b, c, seg, sel3d in zip(eng.buckets, consts, eng._seg, eng._sel3d):
        phases = torch.rand(len(b.stride_groups), generator=host_gen).tolist()
        if seg:
            sel = K.seg_top2_candidates(vec, b.base, b.rows,
                                        b.cols)[0].abs()
            smp = eng._sample_rows_3d(b, c, vec.view(-1, 128), phases)
        elif sel3d:
            R, nb = b.rows, b.cols // 128
            block = vec[b.base:b.base + R * b.cols].view(R, b.cols)
            kp = flat.lane_quota(b.cols, b.max_sel)
            lanes = block.view(R, nb, 128).abs().transpose(1, 2).reshape(
                R * 128, nb).contiguous()
            if kp <= K.TOPK_MAX_K:
                out.append(("candidates", lanes, kp))
            sel = flat.lane_candidates(block, kp)[0]
            smp = eng._sample_rows_3d(b, c, vec.view(-1, 128), phases)
        else:
            block = vec[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
            sel = torch.where(c["in_row"], block.abs(), -1.0)
            smp = (None if b.exact else
                   eng._sample_rows(b, c, sel, phases).contiguous())
        for role, inp, k in (("select", sel, b.max_sel),
                             ("threshold", smp, b.max_k)):
            if inp is not None and k <= K.TOPK_MAX_K:
                out.append((role, inp, k))
    return out


def _old_library(src, fn, argtypes):
    """An earlier kernel built from the source file ``src`` into the build
    directory (the headers beside it first, as its quoted includes find
    them, then this checkout's ``csrc/``), ``fn``'s argtypes set and an
    int return."""
    import ctypes
    import hashlib
    from dgc_tpu_torch.ops import build
    src = Path(src)
    text = src.read_bytes() + b"".join(
        h.read_bytes() for d in (src.parent, build.CSRC)
        for h in sorted(d.glob("*.cuh")))
    tag = hashlib.sha1(text).hexdigest()[:12]
    lib = build.BUILD_DIR / f"old-{src.stem}-{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not lib.exists():
        subprocess.run([build._nvcc(), *build._FLAGS, "-I", str(build.CSRC),
                        "-o", str(lib), str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    getattr(cdll, fn).argtypes = argtypes
    getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def _old_topk_library(src):
    """An earlier top-k kernel with today's C signature and planner
    (``csrc/topk_rows.cu`` as of commit 5427a94 or c58eb1e, beside its own
    ``topk_select.cuh``, e.g. from ``git archive c58eb1e
    dgc_tpu_torch/csrc``)."""
    from dgc_tpu_torch.ops import kernels as K
    return _old_library(src, "topk_rows_launch",
                        K._TOPK_ARGS["topk_rows_launch"])


def _old_topk(lib, x, k):
    import torch
    from dgc_tpu_torch.ops import kernels as K
    R, cols = x.shape
    plan = K.topk_plan(R, cols, k)
    v = torch.empty((R, k), dtype=torch.float32, device=x.device)
    i = torch.empty((R, k), dtype=torch.int32, device=x.device)
    tmp = (torch.empty(R * plan.padded, dtype=torch.int64, device=x.device)
           if plan.radix else None)
    err = lib.topk_rows_launch(
        x.data_ptr(), v.data_ptr(), i.data_ptr(),
        tmp.data_ptr() if tmp is not None else None, R, cols, k,
        *K._plan_args(plan), *K._stream_args(x))
    if err:
        raise RuntimeError(f"old topk_rows launch failed: CUDA error {err}")
    return v, i


#: the planted top-k cases: (route forced, or None for the planner's,
#: columns, ks); five rows each (see _topk_planted_rows). Forced routes
#: reach the bitonic sort's chunked form (a 16,384-word sort route) and a
#: block reading its row from global memory.
_TOPK_PLANTED = (("sort", 95, (1, 10, 95)), ("sort", 2049, (1, 300, 2049)),
                 ("sort", 9000, (37, 9000)), ("block", 1026, (1, 37, 300)),
                 ("block", 4099, (1, 1000, 2048, 4099)),
                 ("block", 9216, (2915,)), ("block", 36867, (16384,)),
                 ("cluster", 16384, (1, 16384)),
                 ("cluster", 36867, (1, 37, 11658, 16384)),
                 (None, 300001, (16384,)))


def _topk_planted_rows(cols, k, gen):
    """Five rows: random values with the row's k-th value planted at
    columns cols/8*j - 1, cols/8*j and cols/8*j + 1 (ties across the
    cluster route's slice boundaries, taken in part), an all-equal row,
    an all-zero row with -0.0 at even columns, a row of |x| with a -1
    tail and -inf entries (the engine's sentinels), and signed values
    with -0.0 planted."""
    import torch
    x = torch.randn(5, cols, device=DEVICE, generator=gen)
    kth = torch.sort(x[0], descending=True).values[k - 1]
    ties = [c for j in range(9) for c in (cols // 8 * j - 1, cols // 8 * j,
                                          cols // 8 * j + 1) if 0 <= c < cols]
    x[0, ties] = kth
    x[1] = 0.5
    x[2] = 0.0
    x[2, ::2] = -0.0
    x[3] = x[3].abs()
    x[3, cols // 2:] = -1.0
    x[3, ::7] = -float("inf")
    x[4, ::5] = -0.0
    return x


def _topk_call(label, inp, k, errs, old=None):
    """``topk_rows`` on one input: bitwise its plain version, twice (and
    the earlier kernel ``old``, timed in turns with it); its time, the
    plain version's, ``torch.topk``'s and the bound."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    want = K.topk_rows_plain(inp, k)
    errs.append(_check_twice(f"topk_rows {label}",
                             lambda: K.topk_rows(inp, k), want))
    if old is not None:
        _check_equal(f"old topk_rows {label}", _old_topk(old, inp, k), want)
    R, cols = inp.shape
    plan = K.topk_plan(R, cols, k)
    # bytes: the rows read, k (value, column) pairs written; ops: one
    # comparison per element
    bound_ms, bound_by = _bound(4 * R * cols + 8 * R * k, R * cols)
    return dict(shape=[R, cols], k=k, route=plan.route,
                threads=plan.threads, cluster=plan.cluster,
                staged=plan.staged, radix=plan.radix,
                **_in_turns(lambda: K.topk_rows(inp, k),
                            old and (lambda: _old_topk(old, inp, k))),
                **_timed(plain_ms=lambda: K.topk_rows_plain(inp, k),
                         library_ms=lambda: torch.topk(inp, k, dim=1)),
                bound_ms=bound_ms, bound_by=bound_by)


def _check_tie_column(eng, gen):
    """A planted tie column on the 3-D fallback's candidates view of
    ``eng``'s first bucket: equal magnitudes, above every other, in
    blocks 3, 40 and 41 of (row 0, lane 5). ``topk_rows`` must put them
    first, lower block first (the port's tie rule), bitwise its plain
    version, twice. Returns the largest difference and the case's
    description."""
    import torch
    from dgc_tpu_torch.compression import flat
    from dgc_tpu_torch.ops import kernels as K
    b = eng.buckets[0]
    nb, kp = b.cols // 128, flat.lane_quota(b.cols, b.max_sel)
    lanes = torch.rand(b.rows * 128, nb, device=DEVICE, generator=gen)
    lanes[5, [3, 40, 41]] = 2.0
    err = _check_twice("topk_rows planted tie column",
                       lambda: K.topk_rows(lanes, kp),
                       K.topk_rows_plain(lanes, kp))
    vals, blocks = K.topk_rows(lanes, kp)
    if blocks[5, :3].tolist() != [3, 40, 41] or vals[5, :3].tolist() != [
            2.0] * 3:
        raise AssertionError(f"tie column: blocks {blocks[5, :4].tolist()}")
    plan = K.topk_plan(*lanes.shape, kp)
    return err, (f"{plan.route} x{plan.cluster} [{b.rows * 128}, {nb}] "
                 f"k={kp} tie column, lower block first")


def phase_topk_kernel(models, gen):
    """``topk_rows`` at every call of the paths (``models``: {model:
    geometries}; bitwise the plain version, twice) with its times beside
    the earlier design's (``--old-src``), ``torch.topk`` and the bound,
    at the planted cases on each route (twice, bitwise), and at a planted
    tie column of VGG-16's 3-D fallback."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    old = _old_topk_library(OLD_TOPK_SRC) if OLD_TOPK_SRC else None
    calls, errs = [], []
    host_gen = torch.Generator().manual_seed(1)
    for model, gs in models.items():
        for epoch, (ratio, eng) in gs.items():
            for role, inp, k in _topk_inputs(eng, gen, host_gen):
                calls.append(dict(
                    model=model, epoch=epoch, ratio=ratio, role=role,
                    **_topk_call(f"{model} epoch {epoch} {role}", inp, k,
                                 errs, old)))
        torch.cuda.empty_cache()
    planted = []
    pgen = torch.Generator(device=DEVICE).manual_seed(2)
    for route, cols, ks in _TOPK_PLANTED:
        for k in ks:
            x = _topk_planted_rows(cols, k, pgen)
            plan = K.topk_plan(5, cols, k, route)
            if route is not None and plan.route != route:
                raise AssertionError(f"topk_plan: {route} forced, got {plan}")
            want = K.topk_rows_plain(x, k)
            for _ in range(2):
                _check_equal(f"topk_rows planted {route} [5, {cols}] k={k}",
                             K._topk_rows_launch(x, k, plan), want)
            planted.append(f"{plan.route}{' radix' if plan.radix else ''}"
                           f"{'' if plan.staged else ' unstaged'}"
                           f" x{plan.cluster} [5, {cols}] k={k}")
    err, case = _check_tie_column(models["vgg16_bn"][1][1], pgen)
    errs.append(err)
    planted.append(case)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    by_epoch = {m: {e: {k: sum(c[k] for c in calls
                               if c["model"] == m and c["epoch"] == e)
                        for k in keys} for e in gs}
                for m, gs in models.items()}
    step = {m: dict(by_epoch[m][5]) for m in models}
    vgg = [c for c in calls if c["model"] == "vgg16_bn"]
    vgg_worst = max(vgg, key=lambda c: c["ms"] / c["library_ms"])
    worst = max(calls, key=lambda c: c["ms"] / c["library_ms"])
    losing = [c for c in calls if c["ms"] > c["library_ms"]]
    by_route = {}
    for c in calls:
        r = by_route.setdefault(c["route"], {"calls": 0, "ms": 0.0,
                                             "library_ms": 0.0})
        r["calls"] += 1
        r["ms"] += c["ms"]
        r["library_ms"] += c["library_ms"]
    print(f"[topk_rows] {len(calls)} path calls, worst ratio to torch.topk "
          f"{worst['ms'] / worst['library_ms']:.3f} at {worst['shape']} "
          f"k={worst['k']} ({worst['route']}); slower than torch.topk at "
          f"{len(losing)}: "
          + ", ".join(f"{c['shape']} k={c['k']}" for c in losing)
          + "; by route " + json.dumps(by_route))
    if old is not None:
        print(f"[topk_rows] sums over the {len(calls)} path calls: new "
              f"{sum(c['ms'] for c in calls):.4f} ms, old "
              f"{sum(c['old_ms'] for c in calls):.4f}, torch.topk "
              f"{sum(c['library_ms'] for c in calls):.4f}")
        for m in models:
            step[m]["old_ms"] = sum(c["old_ms"] for c in calls
                                    if c["model"] == m and c["epoch"] == 5)
            print(f"[topk_rows] {m} step at ratio 0.001: new "
                  f"{step[m]['ms']:.4f} ms, old {step[m]['old_ms']:.4f}")
    print(f"[topk_rows] {len(planted)} planted cases on the "
          f"{', '.join(sorted({p.split()[0] for p in planted}))} routes "
          f"({sum(' radix' in p for p in planted)} radix-sorted, "
          f"{sum(' unstaged' in p for p in planted)} unstaged), twice each, "
          "bitwise")
    print(f"[topk_rows] vgg16_bn: {len(vgg)} path calls; per worker step ms "
          + json.dumps({e: round(v["ms"], 4)
                        for e, v in by_epoch["vgg16_bn"].items()})
          + "; 3-D candidates " + json.dumps({
              f"{c['shape']} k={c['k']}": [round(c["ms"], 4),
                                           round(c["library_ms"], 4)]
              for c in vgg if c["role"] == "candidates"}))
    return dict(
        name="topk_rows", route="cuda",
        source="dgc_tpu_torch/csrc/topk_rows.cu",
        replaces="dgc_tpu/ops/kernels.py:739",
        check="bitwise vs topk_rows_plain (stable sort), twice; planted "
              "cases on every route",
        max_abs_err=max(errs), **step["resnet50"], bound_by="bytes",
        summed_over="the calls of one worker's ResNet-50 step at ratio "
                    "0.001", resnet20_step=step["resnet20"],
        resnet110_step=step["resnet110"],
        vgg16_bn=dict(
            calls=len(vgg), by_epoch=by_epoch["vgg16_bn"],
            worst_ratio_to_library=vgg_worst["ms"] / vgg_worst["library_ms"],
            worst_shape=[*vgg_worst["shape"], vgg_worst["k"]],
            slower_than_library=sum(c["ms"] > c["library_ms"] for c in vgg),
            candidates={f"{c['shape']} k={c['k']}": {
                key: c[key] for key in ("ms", "library_ms", "bound_ms",
                                        "route", "cluster", "staged")}
                for c in vgg if c["role"] == "candidates"}),
        worst_ratio_to_library=worst["ms"] / worst["library_ms"],
        worst_shape=[*worst["shape"], worst["k"]],
        shapes_slower_than_library=len(losing), planted=planted,
        calls=calls)


def phase_kernels(models):
    """Bitwise checks and timings of ``compensate_bits``, ``topk_rows`` and
    ``apply_rows`` at the paths' shapes: ``models`` {model: geometries}
    (ResNet-20 across the warm-up, ResNet-50 and ResNet-110 at the epoch-0
    and epoch-5 ratios, VGG-16 at epochs 0, 1, 4 and 5).
    Returns {kernel: entry} with per-call details under "calls"."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = {}

    # --- K1 compensate at T of the 2-D paths and of VGG-16's warm-up
    #     (ResNet-50's compensates through compensate_bits_cands) ---
    calls = []
    for model in ("resnet20", "resnet110", "vgg16_bn"):
        T = models[model][5][1].T
        nw = K.num_sent_words(T)
        g, m, v = (torch.randn(T, device=dev, generator=gen)
                   for _ in range(3))
        sent = torch.randperm(T, device=dev, generator=gen)[:T // 4].int()
        bits = K.pack_sent_bits(sent, T)
        want = K.compensate_bits_plain(g, m, v, bits, 0.9, False, True)
        err = _check_twice(f"compensate_bits {model}",
                           lambda: K.compensate_bits(g, m.clone(), v.clone(),
                                                     bits, 0.9, False, True),
                           want)
        del want
        mm, vv = m.clone(), v.clone()
        # bytes: g, m, v read, m, v written, the record read; ops: ~5 per
        # element
        bound_ms, bound_by = _bound(20 * T + 4 * nw, 5 * T)
        # cold_ms: from HBM (ResNet-110's 41 MB of state fit the 50 MB L2,
        # so the L2-warm time can undercut the byte bound)
        calls.append(dict(
            model=model, shape=[T], per_worker_step=1, max_abs_err=err,
            **_timed(ms=lambda: K.compensate_bits(g, mm, vv, bits, 0.9),
                     plain_ms=lambda: K.compensate_bits_plain(
                         g, m, v, bits, 0.9)),
            cold_ms=_cold_ms(lambda: K.compensate_bits(g, mm, vv, bits,
                                                       0.9)),
            bound_ms=bound_ms, bound_by=bound_by))
        c = calls[-1]
        print(f"[compensate_bits] {model} T={T}: bitwise twice, "
              f"{c['ms']:.5f} ms (cold {c['cold_ms']:.5f}, plain "
              f"{c['plain_ms']:.5f}, bound {bound_ms:.5f})")
        del g, m, v, mm, vv, sent, bits
    torch.cuda.empty_cache()
    head = calls[0]
    entries["compensate_bits"] = dict(
        name="compensate_bits", route="triton",
        source="dgc_tpu_torch/ops/kernels.py",
        replaces="dgc_tpu/ops/kernels.py:527",
        check="bitwise vs compensate_bits_plain",
        max_abs_err=max(c["max_abs_err"] for c in calls),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, of="ResNet-20's T", vgg16_bn={
            k: calls[-1][k] for k in ("shape", "ms", "cold_ms", "plain_ms",
                                      "bound_ms")}, calls=calls)

    # --- K2 top-k: every selection and threshold call it takes
    #     (ResNet-50's selections above its k take the lax_top_k route) ---
    entries["topk_rows"] = phase_topk_kernel(models, gen)
    entries["apply_rows"] = phase_apply_kernel(models, gen)
    return entries


def _apply_payloads(models, gen, world=4):
    """One worker's apply inputs at W=4 on real gathered payloads, with
    duplicates (correlated workers select overlapping coordinates), for
    each of ``models`` ({model: geometries}) at the epoch-0 and epoch-5
    ratios: yields dicts with ``model, epoch, eng, args`` (``args`` =
    values, indices, flags, T, divisor), one at a time (VGG-16's epoch-0
    payload holds 175.0M entries)."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    dev = DEVICE
    for model, gs in models.items():
        for epoch in (0, 5):
            eng = gs[epoch][1]
            common = torch.randn(eng.layout.total, device=dev, generator=gen)
            sent = []
            for w in range(world):
                grad = common + 0.3 * torch.randn(
                    eng.layout.total, device=dev, generator=gen)
                mem = eng.init_memory(dev)
                ph = eng.draw_phases(torch.Generator().manual_seed(w))
                sent.append(eng.compress(grad, mem, ph))
            gv = LocalComm(world).all_gather([s[0] for s in sent])[0]
            gi = LocalComm(world).all_gather([s[1] for s in sent])[0]
            flags = ((torch.arange(world, device=dev)[:, None] == 0)
                     & (gi != eng.layout.sentinel)).reshape(-1)
            del sent, common, grad, mem
            yield dict(model=model, epoch=epoch, eng=eng, args=(
                gv.reshape(-1), gi.reshape(-1), flags, eng.T, float(world)))
            del gv, gi, flags


def _apply_planted(gen):
    """``(case, values, indices, flags, total, divisor)`` of the planted
    apply cases: entries on both sides of a 4,096 boundary, a partial last
    chunk, a hot chunk with more entries than a chunk block's shared
    memory (and a run longer than a thread sorts alone), W=8 with every
    coordinate sent by all workers, zero-valued flagged entries, selected
    -0.0 and NaN, indices of -1, ``total`` and above, n = 0, more chunks
    than the scatter's shared histogram takes, and a divisor that is not
    a power of two. Flagged indices are unique, as the
    engine's are."""
    import torch
    dev = DEVICE

    def rnd(n):
        return torch.randn(n, device=dev, generator=gen)

    def pick(hi, n):
        return torch.randint(0, hi, (n,), device=dev, generator=gen,
                             dtype=torch.int32)

    def no_flags(n):
        return torch.zeros(n, dtype=torch.bool, device=dev)

    cases = []
    T = 4 * 4096
    i = torch.tensor([4094, 4095, 4096, 4097, 4095, 4096, 8191, 8192],
                     dtype=torch.int32, device=dev)
    f = torch.tensor([1, 1, 1, 1, 0, 0, 1, 1], dtype=torch.bool, device=dev)
    cases.append(("4096 boundary", rnd(8), i, f, T, 4.0))
    T = 2 * 4096
    i = torch.cat([pick(T, 2800), torch.full((200,), 4100, device=dev,
                                             dtype=torch.int32)])
    i = i[torch.randperm(i.numel(), device=dev, generator=gen)]
    cases.append(("long run in shared memory", rnd(3000), i, no_flags(3000),
                  T, 4.0))
    T = 3 * 4096 + 2048
    i = torch.cat([pick(T, 3000), torch.arange(T - 256, T, device=dev,
                                               dtype=torch.int32)])
    f = torch.zeros(i.numel(), dtype=torch.bool, device=dev)
    f[-256:] = True
    cases.append(("partial last chunk", rnd(i.numel()), i, f, T, 4.0))
    # 40,000 entries in chunk 1 (over the largest shared capacity), 2,000
    # of them on one coordinate; plus a thin spread elsewhere
    T = 4 * 4096
    i = torch.cat([4096 + pick(4096, 38_000),
                   torch.full((2000,), 5000, dtype=torch.int32, device=dev),
                   pick(T, 500)])
    i = i[torch.randperm(i.numel(), device=dev, generator=gen)]
    f = no_flags(i.numel())
    f[:4096] = True
    i[:4096] = torch.arange(4096, 8192, device=dev, dtype=torch.int32)
    cases.append(("hot chunk", rnd(i.numel()), i, f, T, 4.0))
    T, W = 2 * 4096 + 128, 8
    i = torch.stack([torch.randperm(T, device=dev, generator=gen)
                     for _ in range(W)]).int()
    f = (torch.arange(W, device=dev)[:, None] == 3).expand(W, T)
    cases.append(("W=8, every coordinate from all", rnd(W * T),
                  i.reshape(-1), f.reshape(-1).contiguous(), T, 8.0))
    T = 2 * 4096
    i = torch.randperm(T, device=dev, generator=gen)[:600].int()
    v = rnd(600)
    v[:100] = 0.0
    v[100:150] = -0.0
    v[150:153] = float("nan")
    v[153:155] = float("inf")
    f = no_flags(600)
    f[50:300] = True
    cases.append(("zeros, -0.0, NaN, inf", v, i, f, T, 4.0))
    i = pick(T, 600)
    i[:40] = torch.tensor([-1, T, T + 4096, -4096] * 10, dtype=torch.int32)
    cases.append(("out of range", rnd(600), i, no_flags(600) | (i < 0), T,
                  4.0))
    cases.append(("n = 0", rnd(0), pick(T, 0), no_flags(0), T, 4.0))
    i = pick(T, 5000)
    cases.append(("divisor 3", rnd(5000), i, no_flags(5000), T,
                  3.0))
    cases.append(("no divisor", rnd(5000), i, no_flags(5000), T, None))
    # more chunks than the scatter's shared histogram takes (its per-warp
    # path)
    T = 12_289 * 4096
    i = torch.cat([torch.randperm(T, device=dev, generator=gen)[:1500].int(),
                   pick(T, 1000), 4096 * 12_288 + pick(4096, 500)])
    f = no_flags(3000)
    f[:1500] = True                         # unique indices
    order = torch.randperm(3000, device=dev, generator=gen)
    cases.append(("over 12,288 chunks", rnd(3000), i[order], f[order], T,
                  4.0))
    return cases


def _apply_routes(n):
    """The routes the apply kernel can take for ``n`` entries: both while
    a scan-route block's shared memory can hold ``n`` entries."""
    from dgc_tpu_torch.ops import kernels as K
    fits = K.apply_plan(n, 4096, "scan").smem_bytes <= 227 * 1024
    return ("scan", "list") if fits else ("list",)


def _apply_call(p, errs):
    """One real apply payload ``p`` (of :func:`_apply_payloads`) through
    ``apply_rows``: bitwise ``apply_rows_plain``, run twice, then timed
    against the plain version and ``torch.zeros(T).index_add_(0, idx, v /
    W)``; its detail dict (printed), its error appended to ``errs``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    vals, idx, flags, T, world = args = p["args"]
    real = idx[idx != p["eng"].layout.sentinel]
    dups = int(real.numel() - torch.unique(real).numel())
    del real
    first = K.apply_rows(*args)
    errs.append(_check_equal(f"apply_rows {p['model']} epoch {p['epoch']}",
                             first, K.apply_rows_plain(*args)))
    _check_equal("apply_rows run twice", K.apply_rows(*args), first)
    del first
    n, nwords = vals.numel(), K.num_sent_words(T)
    plan = K.apply_plan(n, T)
    keep = ((vals != 0) | flags) & (idx >= 0) & (idx < T)
    per_chunk = torch.bincount(idx[keep].long() // K.APPLY_CHUNK,
                               minlength=plan.grid)
    ilong = idx.long()
    # bytes: values, indices, flags read, acc and the record written;
    # ops: a divide and an add per entry
    bound_ms, bound_by = _bound(9 * n + 4 * T + 4 * nwords, 2 * n)
    c = dict(
        model=p["model"], epoch=p["epoch"],
        payload_per_worker=p["eng"].payload_size, entries=n,
        duplicate_entries=dups, route=plan.route, cap=plan.cap,
        max_chunk_entries=int(per_chunk.max()),
        chunks_over_cap=int((per_chunk > plan.cap).sum()),
        **_timed(
            ms=lambda: K.apply_rows(*args),
            plain_ms=lambda: K.apply_rows_plain(*args),
            library_ms=lambda: torch.zeros(
                T, device=DEVICE).index_add_(0, ilong, vals / world)),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[apply] {c['model']} epoch {c['epoch']}: n {c['entries']}, "
          f"{c['route']} route, {c['ms']:.4f} ms (plain "
          f"{c['plain_ms']:.4f}, index_add_ {c['library_ms']:.4f}, "
          f"bound {c['bound_ms']:.5f}); chunk max "
          f"{c['max_chunk_entries']} of cap {c['cap']}")
    return c


def phase_apply_kernel(models, gen):
    """``apply_rows`` bitwise ``apply_rows_plain`` on the card: every
    planted case through both routes, and the real W=4 payloads of each
    of ``models`` at the epoch-0 and epoch-5 ratios through the planned
    route, each run twice (bitwise equal); then each real shape timed
    against the plain version and ``torch.zeros(T).index_add_(0, idx, v / W)``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    errs, planted = [], []
    for case, *args in _apply_planted(gen):
        want = K.apply_rows_plain(*args)
        for route in _apply_routes(args[0].numel()):
            plan = K.apply_plan(args[0].numel(), args[3], route)
            errs.append(_check_equal(f"apply_rows {case} ({route})",
                                     K._apply_rows_launch(*args, plan),
                                     want))
        planted.append(case)
    print(f"[apply] {len(planted)} planted cases bitwise, both routes")
    calls = []
    for p in _apply_payloads(models, gen):
        calls.append(_apply_call(p, errs))
        del p
        torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    steady = {c["model"]: c for c in calls if c["epoch"] == 5}
    return dict(
        name="apply_rows", route="cuda",
        source="dgc_tpu_torch/csrc/apply_rows.cu",
        replaces="dgc_tpu/ops/kernels.py:1743",
        check="bitwise vs apply_rows_plain (payload-order sums), planted "
              "cases through both routes, each real shape run twice",
        max_abs_err=max(errs), **{k: steady["resnet50"][k] for k in keys},
        of="one worker's apply at ResNet-50, ratio 0.001, W=4",
        resnet20_step={k: steady["resnet20"][k] for k in keys},
        resnet110_step={k: steady["resnet110"][k] for k in keys},
        vgg16_bn={f"epoch {c['epoch']}": {k: c[k] for k in (
            "entries", "route", "cap", "ms", "plain_ms", "library_ms",
            "bound_ms", "max_chunk_entries", "chunks_over_cap")}
            for c in calls if c["model"] == "vgg16_bn"},
        planted=planted, calls=calls)


def _plant_ties(g, m, v, start, span):
    """Three segments from ``start`` whose stored velocity (g, with m and
    v zero) holds ties: one all zero, one of a single value (every lane a
    256-way tie), one random with equal |v| in blocks 3 and 200 of lane 7
    (signs mixed) and in blocks 5, 6 and 255 of lane 9. Returns
    ``[(segment, lane, blocks, values)]`` that the candidates must show."""
    m[start:start + 3 * span] = 0.0
    v[start:start + 3 * span] = 0.0
    g[start:start + span] = 0.0
    g[start + span:start + 2 * span] = -1.5
    s = start + 2 * span
    for block, lane, val in ((3, 7, 9.0), (200, 7, -9.0), (5, 9, 8.0),
                             (6, 9, 8.0), (255, 9, -8.0)):
        g[s + block * 128 + lane] = val
    seg = start // span
    return [(seg, lane, (0, 1), (0.0, 0.0)) for lane in (0, 127)] + [
        (seg + 1, lane, (0, 1), (-1.5, -1.5)) for lane in (0, 127)] + [
        (seg + 2, 7, (3, 200), (9.0, -9.0)), (seg + 2, 9, (5, 6), (8.0, 8.0))]


def _old_cands_module(path):
    """An earlier ``dgc_tpu_torch/ops/kernels.py`` (``--old-cands-src``)
    loaded as a module of its own, so its launches count apart."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("old_cands_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_turns(new, old, timer=None, rounds=1, **timing):
    """``{"ms", "old_ms"}``: device ms per call of ``new`` and ``old``, each
    timed twice a round in the order new, old, old, new (``old_ms`` None
    without an old kernel) by ``timer`` (:func:`_device_ms`, given
    ``timing``), averaged over ``rounds``."""
    timer = timer or (lambda f: _device_ms(f, **timing))
    if old is None:
        return {"ms": timer(new), "old_ms": None}
    t = [sum(timer(f) for _ in range(rounds)) / rounds
         for f in (new, old, old, new)]
    return {"ms": (t[0] + t[3]) / 2, "old_ms": (t[1] + t[2]) / 2}


#: the planted candidate segments: (segment, lane, blocks, values) that
#: the candidates must show (see _seg_planted)
_SEG_PLANTS = ((0, 7, (31, 32), (9.0, -9.0)), (0, 8, (223, 224), (-9.0, 9.0)),
               (1, 3, (0, 255), (-9.0, 9.0)),
               (2, 0, (31, 32), (math.inf, -math.inf)),
               (2, 2, (0, 1), (math.inf, math.inf)),
               (3, 4, (0, 1), (0.0, 0.0)))


#: the momentum flags (nesterov, momentum_masking) of the fused kernel's
#: checks, the default ones last: the checks after the loop read its result
_MOMENTUM_FLAGS = ((True, True), (True, False), (False, False),
                   (False, True))


def _check_fused_cands(label, g, m, v, bits, old=None):
    """``compensate_bits_cands`` at each of :data:`_MOMENTUM_FLAGS`, twice,
    bitwise its plain version, its m and v bitwise ``compensate_bits``,
    and the earlier kernel's output bitwise it (``old``). Returns the plain
    and the kernel's outputs under the default flags, and the largest
    finite difference (0.0 when bitwise)."""
    from dgc_tpu_torch.ops import kernels as K
    errs = []
    for flags in _MOMENTUM_FLAGS:
        args = (0.9, *flags)
        want = K.compensate_bits_cands_plain(g, m, v, bits, *args)
        for run in range(2):
            got = K.compensate_bits_cands(g, m.clone(), v.clone(), bits,
                                          *args)
            errs.append(_check_equal(
                f"compensate_bits_cands {label} {args}, run {run}", got,
                want))
        _check_equal(f"compensate_bits {label} {args}",
                     K.compensate_bits(g, m.clone(), v.clone(), bits, *args),
                     want[:2])
        if old is not None:
            _check_equal(f"old compensate_bits_cands {label} {args}",
                         old.compensate_bits_cands(g, m.clone(), v.clone(),
                                                   bits, *args), want)
    return want, got, max(errs)


def _seg_planted(gen):
    """Four planted segments and a ragged tail, as compensate state whose
    stored velocity is g in the segments (m and v zero there): equal |x| of
    opposite signs straddling the record rows (blocks 31/32 in lane 7,
    223/224 in lane 8), a tie at blocks 0 and 255 (lane 3), +-inf (a tie at
    blocks 31/32 in lane 0, -inf in lane 1, an all-inf lane 2), an all
    -0.0 lane 4 (g, m and v all -0.0 there, so the stored velocity is -0.0
    under every momentum flag); then 2,048 tail elements of random state
    with sent bits set. Returns ``(g, m, v, bits)``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    nseg, tail = 4, 2048
    n = nseg * K.SEG_SPAN + tail
    g, m, v = (torch.randn(n, device=DEVICE, generator=gen)
               for _ in range(3))
    m[:nseg * K.SEG_SPAN] = 0.0
    v[:nseg * K.SEG_SPAN] = 0.0
    x = g[:nseg * K.SEG_SPAN].view(nseg, 256, 128)
    for seg, lane, blocks, vals in _SEG_PLANTS:
        for b, val in zip(blocks, vals):
            x[seg, b, lane] = val
    x[2, 5, 1] = -math.inf
    x[2, :, 2] = math.inf
    for t in (g, m, v):
        t[:nseg * K.SEG_SPAN].view(nseg, 256, 128)[3, :, 4] = -0.0
    sent = torch.cat([torch.randperm(n, device=DEVICE, generator=gen)[:n // 50],
                      nseg * K.SEG_SPAN + torch.arange(0, tail, 7,
                                                       device=DEVICE)])
    return g, m, v, K.pack_sent_bits(sent.unique().int(), n)


def _check_seg_planted(gen):
    """Both candidates kernels on the planted segments, twice each: the
    fused one as :func:`_check_fused_cands` has it (the plants under the
    default flags), the standalone one bitwise its plain version and the
    fused candidates. Returns the largest finite difference."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    g, m, v, bits = _seg_planted(gen)
    nseg = g.shape[0] // K.SEG_SPAN
    want, got, err = _check_fused_cands("planted", g, m, v, bits)
    for seg, lane, blocks, vals in _SEG_PLANTS:
        if (tuple(want[3][seg, :, lane].tolist()) != blocks
                or tuple(want[2][seg, :, lane].tolist()) != vals):
            raise AssertionError(f"planted case at segment {seg} lane {lane}")
    _check_negative_zero_lane("compensate_bits_cands", got[1], got[2])
    alone = K.seg_top2_candidates_plain(got[1], 0, 1, nseg * K.SEG_SPAN)
    _check_equal("planted: plain candidates vs the fused ones", alone, (
        got[2].reshape(1, -1), K.seg_cols_local(got[3].view(1, nseg, 2,
                                                             128))))
    errs = [err] + [_check_equal(
        f"seg_top2_candidates planted, run {run}",
        K.seg_top2_candidates(got[1], 0, 1, nseg * K.SEG_SPAN), alone)
        for run in range(2)]
    for run in range(2):
        _check_negative_zero_lane(
            f"seg_top2_candidates, run {run}", got[1], K.seg_top2_candidates(
                got[1], 0, 1, nseg * K.SEG_SPAN)[0].view(nseg, 2, 128))
    return max(errs)


def _check_negative_zero_lane(name, vec, cv):
    """Lane 4 of planted segment 3: every stored velocity there is -0.0
    (sign bit set, so a value read back without the + 0.0 would differ)
    and both candidates read +0.0 (bits 0)."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    lane = vec[:4 * K.SEG_SPAN].view(4, 256, 128)[3, :, 4]
    if not bool((lane.view(torch.int32) == -2 ** 31).all()):
        raise AssertionError(f"{name}: the planted lane is not all -0.0")
    if cv[3, :, 4].view(torch.int32).tolist() != [0, 0]:
        raise AssertionError(f"{name}: a -0.0 candidate did not read +0.0")


def _fused_cands_at(label, eng, gen, old):
    """``compensate_bits_cands`` at ``eng``'s T (its epoch-5 buckets),
    ties planted at the start of every segment bucket: held by
    :func:`_check_fused_cands`, the ties checked in the candidates, then
    timed (in turns with ``old``) beside ``compensate_bits`` at the same
    T and the plain version. Returns the call's dict and the kernel's
    outputs under the default flags."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    T, span = eng.T, K.SEG_SPAN
    nw, nseg = K.num_sent_words(T), T // span
    g, m, v = (torch.randn(T, device=DEVICE, generator=gen)
               for _ in range(3))
    ties = []
    for b, seg in zip(eng.buckets, eng._seg):
        if seg:
            ties += _plant_ties(g, m, v, b.base, span)
    sent = torch.randperm(T, device=DEVICE, generator=gen)[:T // 1000].int()
    bits = K.pack_sent_bits(sent, T)
    del sent
    # (compensate_bits at this T is the warm-up ratios' compensate)
    want, got, err = _check_fused_cands(f"at {label}'s T", g, m, v, bits,
                                        old)
    for seg, lane, blocks, vals in ties:       # the ties reach the kernel
        if (tuple(want[3][seg, :, lane].tolist()) != blocks
                or tuple(want[2][seg, :, lane].tolist()) != vals):
            raise AssertionError(f"planted tie at {label} segment {seg} "
                                 f"lane {lane}")
    del want
    mm, vv = m.clone(), v.clone()
    # bytes: g, m, v read, m, v written, the record read, 2 KB of
    # candidates per segment written; ops: ~5 per element for the
    # compensate, ~4 compares per element for the candidates
    bound_ms, bound_by = _bound(20 * T + 4 * nw + 2048 * nseg, 9 * T)
    call = dict(
        model=label, shape=[T], segments=nseg, per_worker_step=1,
        max_abs_err=err, **_in_turns(
            lambda: K.compensate_bits_cands(g, mm, vv, bits, 0.9),
            old and (lambda: old.compensate_bits_cands(g, mm, vv, bits,
                                                       0.9))),
        plain_ms=_device_ms(lambda: K.compensate_bits_cands_plain(
            g, m, v, bits, 0.9)),
        bound_ms=bound_ms, bound_by=bound_by,
        compensate_bits_ms_same_T=_device_ms(
            lambda: K.compensate_bits(g, mm, vv, bits, 0.9)))
    return call, got


def phase_seg_kernels(geoms50, geoms_vgg):
    """The segment-candidate kernels at ResNet-50's T and buckets (ratio
    0.001), twice each, bitwise against their plain versions and each
    other, on ties planted at the start of every segment bucket, with all
    four momentum flag combinations for the fused kernel (m and v also
    bitwise ``compensate_bits``), the fused kernel so also at VGG-16's T
    and buckets; on the planted cases of :func:`_seg_planted`; times, in
    turns with the earlier kernels under ``--old-cands-src``."""
    import torch
    from dgc_tpu_torch.ops import build
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    old = _old_cands_module(OLD_CANDS_SRC) if OLD_CANDS_SRC else None
    gen = torch.Generator(device=dev).manual_seed(2)
    eng = geoms50[5][1]
    span = K.SEG_SPAN
    head, got = _fused_cands_at("resnet50", eng, gen, old)
    vgg = _fused_cands_at("vgg16_bn", geoms_vgg[5][1], gen, old)[0]
    torch.cuda.empty_cache()
    err = max(head["max_abs_err"], vgg["max_abs_err"],
              _check_seg_planted(gen))
    entries = {"compensate_bits_cands": dict(
        name="compensate_bits_cands", route="cuda",
        source="dgc_tpu_torch/csrc/seg_top2.cu",
        replaces="dgc_tpu/ops/kernels.py:1265",
        check="bitwise vs compensate_bits_cands_plain, twice, all four "
              "momentum flag combinations; m, v bitwise compensate_bits; "
              "planted cases twice", max_abs_err=err,
        **{k: head[k] for k in ("ms", "old_ms", "plain_ms", "bound_ms",
                                "bound_by", "compensate_bits_ms_same_T")},
        library_ms=None, of="ResNet-50's T",
        vgg16_bn={k: vgg[k] for k in ("shape", "segments", "ms", "plain_ms",
                                      "bound_ms",
                                      "compensate_bits_ms_same_T")},
        calls=[head, vgg])}

    vec = got[1]
    lib = build.library("seg_top2.cu", K._SEG_ARGS)
    calls, errs = [], []
    for b, seg in zip(eng.buckets, eng._seg):
        if not seg:
            continue
        R, cols, base = b.rows, b.cols, b.base
        ns = cols // span
        want = K.seg_top2_candidates_plain(vec, base, R, cols)
        for run in range(2):
            a = K.seg_top2_candidates(vec, base, R, cols)
            errs.append(_check_equal(f"seg_top2_candidates, run {run}", a,
                                     want))
        s0 = base // span
        _check_equal("seg_top2_candidates vs the fused candidates", a, (
            got[2][s0:s0 + R * ns].reshape(R, -1),
            K.seg_cols_local(got[3][s0:s0 + R * ns].view(R, ns, 2, 128))))
        if old is not None:
            _check_equal("old seg_top2_candidates",
                         old.seg_top2_candidates(vec, base, R, cols), want)
        region = vec[base:base + R * cols]
        cvb, cbb = a[0].clone(), torch.empty_like(a[1])
        # the kernel's launch alone (the wrapper also recomposes the
        # columns, seg_cols_local: a few small elementwise launches)
        launch = lambda: lib.seg_top2_launch(  # noqa: E731
            vec.data_ptr() + 4 * base, R * ns, cvb.data_ptr(),
            cbb.data_ptr(), 0, *K._stream_args(vec))
        # bytes: the bucket read once, 2 KB of candidates per segment
        # written; ops: ~4 compares per element
        bound_ms, bound_by = _bound(4 * R * cols + 2048 * R * ns,
                                    4 * R * cols)
        calls.append(dict(shape=[R, cols], segments=R * ns, **_in_turns(
            lambda: K.seg_top2_candidates(vec, base, R, cols),
            old and (lambda: old.seg_top2_candidates(vec, base, R, cols))),
            **_timed(
                kernel_only_ms=launch,
                plain_ms=lambda: K.seg_top2_candidates_plain(vec, base, R,
                                                             cols),
                # a time only: torch.topk's tie order is not the kernel's
                library_ms=lambda: region.abs().view(R * ns, 256,
                                                     128).topk(2, dim=1)),
            bound_ms=bound_ms, bound_by=bound_by))
    entries["seg_top2_candidates"] = dict(
        name="seg_top2_candidates", route="cuda",
        source="dgc_tpu_torch/csrc/seg_top2.cu",
        replaces="dgc_tpu/ops/kernels.py:1130",
        check="bitwise vs seg_top2_candidates_plain, twice, and vs "
              "compensate_bits_cands' candidates; planted cases twice",
        max_abs_err=max(errs),
        **{k: sum(c[k] for c in calls) for k in (
            "ms", "kernel_only_ms", "plain_ms", "library_ms", "bound_ms")},
        old_ms=None if old is None else sum(c["old_ms"] for c in calls),
        bound_by=calls[0]["bound_by"],
        summed_over="the six segment-path buckets of one worker's step",
        calls=calls)
    for e in entries.values():
        old_txt = "" if old is None else f", earlier {e['old_ms']:.4f}"
        alone = e.get("kernel_only_ms")
        old_txt += "" if alone is None else f", its launch alone {alone:.4f}"
        print(f"[seg] {e['name']}: {e['ms']:.4f} ms{old_txt} (bound "
              f"{e['bound_ms']:.4f}); bitwise twice, planted cases, "
              + ("four flag combinations" if "cands" in e["name"]
                 else f"{len(calls)} buckets"))
    print(f"[seg] compensate_bits_cands at vgg16_bn's T={vgg['shape'][0]}: "
          f"{vgg['ms']:.4f} ms (plain {vgg['plain_ms']:.4f}, bound "
          f"{vgg['bound_ms']:.4f}, compensate_bits "
          f"{vgg['compensate_bits_ms_same_T']:.4f}); bitwise twice, four "
          "flag combinations, ties planted in its segment buckets")
    return entries


def phase_opaque_kernels(geoms20, geoms50):
    """The opaque copies at the guarded weights of both models: forward
    and backward bitwise against the plain versions; times."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    entries, calls = {}, {"opaque_view": [], "opaque_view_from": []}
    errs = {k: [] for k in calls}
    for model, geoms in (("resnet20", geoms20), ("resnet50", geoms50)):
        lay = geoms[5][1].layout
        flat = torch.randn(lay.total, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               lay.total % 1000))
        for n in sorted(lay.convert_hoist_risky()):
            base, size = lay.offsets[n], lay.sizes[n]
            shape = lay.shapes[n]
            gout = torch.randn(size, device=dev)
            outs = {}
            for where in (dev, "cpu"):
                fp = flat.detach().to(where).requires_grad_(True)
                if K.opaque_view_eligible(lay.total, base, size):
                    kind = "opaque_view_from"
                    y = K.opaque_view_from(fp, base, size)
                else:
                    kind = "opaque_view"
                    y = K.opaque_view(fp[base:base + size].view(shape))
                y.backward(gout.to(where).view(y.shape))
                outs[where] = (y.detach().reshape(-1), fp.grad)
            errs[kind].append(_check_equal(
                kind, outs[dev], [t.to(dev) for t in outs["cpu"]]))
            src = flat[base:base + size]
            view = src.view(shape)
            run = ((lambda: K.opaque_view_from(flat, base, size))
                   if kind == "opaque_view_from"
                   else (lambda: K.opaque_view(view)))
            plain = ((lambda: K.opaque_view_from_plain(flat, base, size))
                     if kind == "opaque_view_from"
                     else (lambda: K.opaque_view_plain(view)))
            # bytes: the tensor read once and written once; no arithmetic
            bound_ms, bound_by = _bound(8 * size, 0)
            calls[kind].append(dict(
                model=model, tensor=n, numel=size, **_timed(
                    ms=run, plain_ms=plain, library_ms=src.clone),
                bound_ms=bound_ms, bound_by=bound_by))
    for kind, line in (("opaque_view", 1776), ("opaque_view_from", 1872)):
        c = calls[kind][-1]          # the last model that binds one
        entries[kind] = dict(
            name=kind, route="cuda",
            source="dgc_tpu_torch/csrc/opaque_copy.cu",
            replaces=f"dgc_tpu/ops/kernels.py:{line}",
            check="bitwise vs the plain copy, forward and backward",
            max_abs_err=max(errs[kind]),
            **{k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
            calls=calls[kind])
    return entries


def _old_copy_library(src):
    """The earlier opaque copy (``csrc/opaque_copy.cu`` as of commit
    fa52c64; the same C signature as today's)."""
    from dgc_tpu_torch.ops import kernels as K
    return _old_library(src, "opaque_copy_launch",
                        K._COPY_ARGS["opaque_copy_launch"])


def phase_opaque_retime(sizes=(512, 2048, 4096), pairs=200):
    """The opaque copy (``opaque_view_from``'s launch) and ``clone`` timed
    in turns over the same source, a tile-aligned slice of a flat buffer:
    each sample is the device time per call of 20 back-to-back calls
    queued behind a ~1 ms spin; ``pairs`` pairs (kernel, clone) per size,
    and with ``--old-copy-src`` the earlier kernel as a third member of
    each turn. Reports the medians, the median of the pairs' differences
    and its spread (the 5th and 95th percentiles of the differences)."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    old = _old_copy_library(OLD_COPY_SRC) if OLD_COPY_SRC else None
    flat = torch.randn(16384, device=DEVICE)
    out = []
    for n in sizes:
        src = flat[1024:1024 + n]
        fns = {"kernel": lambda: K._copy_on_card("opaque_view_from", flat,
                                                 1024, n),
               "clone": src.clone}
        if old is not None:
            def run_old(n=n):
                dst = torch.empty(n, device=DEVICE)
                err = old.opaque_copy_launch(src.data_ptr(), dst.data_ptr(),
                                             n, *K._stream_args(src))
                if err:
                    raise RuntimeError(f"old opaque copy: CUDA error {err}")
                return dst
            _check_equal("old opaque copy", [run_old()], [src.clone()])
            fns["old_kernel"] = run_old
        samples = {k: [] for k in fns}
        for _ in range(pairs):
            for k, fn in fns.items():
                samples[k].append(_device_ms(fn, warmup=1,
                                             hold_cycles=2_000_000))

        def q(v, f):
            v = sorted(v)
            return v[min(len(v) - 1, int(f * len(v)))]
        row = {"numel": n, "pairs": pairs}
        for k, v in samples.items():
            row[f"{k}_ms"] = q(v, 0.5)
        for k in [k for k in fns if k != "clone"]:
            d = [a - b for a, b in zip(samples[k], samples["clone"])]
            row[f"{k}_minus_clone"] = {"median": q(d, 0.5), "p5": q(d, 0.05),
                                       "p95": q(d, 0.95)}
        out.append(row)
        print(f"[opaque_retime] {json.dumps(row)}")
    return out


def _train_state(recipe, schedule):
    """A fresh W=4 trainer on the card after ``schedule`` (``[(epoch,
    steps)]``): the parameters, the optimizer's momentum and every
    worker's memory, on the CPU."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    trainer = Trainer(configs.RECIPES[recipe](), comm=LocalComm(4),
                      device=DEVICE)
    for epoch, steps in schedule:
        trainer.run_epoch(epoch, steps)
    torch.cuda.synchronize()
    st = trainer.state
    out = [st.params] + [t for t in st.opt_state if torch.is_tensor(t)]
    return [t.detach().cpu()
            for t in out + [t for m in st.memory for t in m.values()]]


def phase_run_to_run():
    """ResNet-20 (flat engine, default route, W=4 on the card) trained 2
    steps at the epoch-0 ratio twice from one seed: the parameters,
    momentum and every worker's error-feedback memory bitwise equal (cuDNN
    restricted to deterministic algorithms, as the entry points set it)."""
    a = _train_state("resnet20_wm5", [(0, 2)])
    b = _train_state("resnet20_wm5", [(0, 2)])
    _check_equal("resnet20 training, run to run", a, b)
    print(f"[run_to_run] resnet20 W=4, 2 steps at the epoch-0 ratio, twice: "
          f"parameters, momentum and memory bitwise equal ({len(a)} tensors)")


def _fused_ids(eng):
    """The 2-D buckets that select through ``select_pack_rows``."""
    return [bi for bi, b in enumerate(eng.buckets)
            if not eng._seg[bi] and eng._use_fused_select(b)]


def _select_cases(model, geoms):
    """``(label, R, cols, base, numels, k)`` of every bucket that the
    megakernel or the fused select takes at ``geoms``' ratios."""
    out = []
    for epoch, (_, eng) in geoms.items():
        for bi in sorted(set(eng._mk_fwd_ids) | set(_fused_ids(eng))):
            b = eng.buckets[bi]
            out.append((f"{model} epoch {epoch} bucket {bi}", b.rows, b.cols,
                        b.base, [int(n) for n in b.numels], b.max_sel))
    return out


def _tie_columns(cols, cluster):
    """The columns of rows 0 and R - 1 where every case plants ties of the
    largest |v'|, in column order: four spread over the row, and
    cols/C*j - 1, cols/C*j and cols/C*j + 1 around the boundaries of the
    C slices of the case's cluster plan (column 5 holds the -0.0)."""
    spread = {1, cols // 3, cols // 2, cols - 129}
    edges = {c for j in range(cluster + 1)
             for c in (cols // cluster * j - 1, cols // cluster * j,
                       cols // cluster * j + 1)}
    return sorted(c for c in spread | edges if 0 <= c < cols and c != 5)


def _plant_select_ties(g, m, v, R, cols, base, ties):
    """In a bucket region at ``base``: ties of the largest |v'| at columns
    ``ties`` of rows 0 and R - 1 (g = +-50 with m = v = 0 gives equal |v'|
    under every momentum flag, far above the random entries), signs
    mixed; and g = m = v = -0.0 at column 5 of rows 0 and 1, which makes
    v' = -0.0 there under every flag."""
    for r in {0, R - 1}:
        for j, c in enumerate(ties):
            p = base + r * cols + c
            g[p], m[p], v[p] = 50.0 if j % 2 == 0 else -50.0, 0.0, 0.0
    for r in (0, 1):
        g[base + r * cols + 5] = m[base + r * cols + 5] = -0.0
        v[base + r * cols + 5] = -0.0


def _tail_numels(numels, cols, cluster):
    """``numels`` with its last row's valid columns ending inside the
    second slice of the cluster plan (the middle of the row for one
    block), not on a multiple of 4."""
    out = list(numels)
    out[-1] = (cols // cluster + cols // (2 * cluster) if cluster > 1
               else cols // 2) + 3
    return out


def _old_select_libraries(src_dir):
    """The earlier select-and-pack and forward kernels (a block a row, as
    of commit c58eb1e): ``select_pack_rows.cu`` and ``dgc_forward_rows.cu``
    beside their ``row_select.cuh`` and ``compensate.cuh`` in ``src_dir``
    (e.g. ``git archive c58eb1e dgc_tpu_torch/csrc``), with their C
    signatures of then."""
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    ll, f = ctypes.c_longlong, ctypes.c_float
    d = Path(src_dir)
    return (_old_library(d / "select_pack_rows.cu", "select_pack_rows_launch",
                         [p, p, i, i, i, p, p, p, i, p]),
            _old_library(d / "dgc_forward_rows.cu", "dgc_forward_rows_launch",
                         [p, p, p, p, ll, ll, p, i, i, i, f, i, i, p, p, p,
                          i, p]))


def _old_select(lib, x, nr, k):
    from dgc_tpu_torch.ops import kernels as K
    R, cols = x.shape
    out = K._select_outputs(R, k, x.device)
    err = lib.select_pack_rows_launch(x.data_ptr(), nr.data_ptr(), R, cols, k,
                                      *(t.data_ptr() for t in out),
                                      *K._stream_args(x))
    if err:
        raise RuntimeError(f"old select_pack_rows launch failed: {err}")
    return out


def _old_forward(lib, g, m, v, bits, base, nr, k, nesterov=False,
                 momentum_masking=True):
    from dgc_tpu_torch.ops import kernels as K
    R = nr.shape[0]
    out = K._select_outputs(R, k, g.device)
    err = lib.dgc_forward_rows_launch(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), bits.data_ptr(),
        bits.shape[0], base, nr.data_ptr(), R, g.shape[0] // R, k, 0.9,
        int(nesterov), int(momentum_masking), *(t.data_ptr() for t in out),
        *K._stream_args(g))
    if err:
        raise RuntimeError(f"old dgc_forward_rows launch failed: {err}")
    return out


def _check_twice(name, run, want):
    """``run()`` twice, each bitwise ``want``; the largest difference."""
    err = _check_equal(name, run(), want)
    _check_equal(f"{name}, second run", run(), want)
    return err


def phase_select_kernels(geoms20, geoms50):
    """``select_pack_rows`` and ``dgc_forward_rows`` bitwise against their
    plain versions, twice, at every bucket the megakernel or the fused
    select takes in ``geoms20`` / ``geoms50`` (engines built with both
    flags), at the gate's widest row, on a bucket with an empty row at a
    base that is not a multiple of 32 x 128, whose row 1 (100 valid
    columns, k = 164) selects the planted -0.0, at k = 1 and k = 1,024 on
    a cluster shape, on a 512-column row (the sort route) and on 17 rows
    of 2,048 columns (a block a row); every
    momentum flag combination on ResNet-20's epoch-3 [16, 9216] bucket.
    Each case plants ties of the top |v'| around its cluster plan's slice
    boundaries and is run again with a row whose valid columns end inside
    a non-first slice. ``select_pack_rows`` also on a row too wide to
    stage (the block route forced). Times, beside the earlier kernels' with
    ``--old-select-src``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(3)
    olds = _old_select_libraries(OLD_SELECT_SRC) if OLD_SELECT_SRC else None
    cases = (_select_cases("resnet20", geoms20)
             + _select_cases("resnet50", geoms50)
             + [("gate's widest row", 2, 131072, 640, [131072, 70000], 1024),
                ("empty row", 3, 16384, 128 * 37, [16384, 100, 0], 164),
                ("cluster k=1", 6, 36864, 0, [36864] * 6, 1),
                ("cluster k=1024", 6, 36864, 0, [36864] * 6, 1024),
                ("sort route", 11, 512, 384, [512] * 10 + [300], 66),
                ("block route", 17, 2048, 0, [2048] * 16 + [1000], 263)])
    flags = [dict(nesterov=n, momentum_masking=mm)
             for n in (False, True) for mm in (True, False)]
    calls = {"select_pack_rows": [], "dgc_forward_rows": []}
    errs = {k: [] for k in calls}
    for label, R, cols, base, numels, k in cases:
        plan = K.topk_plan(R, cols, k)
        ties = _tie_columns(cols, plan.cluster)
        n = R * cols
        total = base + n + 4096             # the record runs past the end
        g, m, v = (torch.randn(total, device=dev, generator=gen)
                   for _ in range(3))
        _plant_select_ties(g, m, v, R, cols, base, ties)
        bits = K.pack_sent_bits(torch.randperm(
            total, device=dev, generator=gen)[:total // 50].int(), total)
        gs = g[base:base + n]
        all_flags = label == "resnet20 epoch 3 bucket 1"   # [16, 9216]
        for nl in (numels, _tail_numels(numels, cols, plan.cluster)):
            nr = torch.tensor(nl, dtype=torch.int32, device=dev)
            for fl in (flags if all_flags else flags[:1]):
                want = K.dgc_forward_rows_plain(
                    gs, m[base:base + n], v[base:base + n], bits, base, nr,
                    k, 0.9, **fl)

                def forward(old=False):
                    ms, vs = m[base:base + n].clone(), v[base:base + n].clone()
                    sel = (_old_forward(olds[1], gs, ms, vs, bits, base, nr,
                                        k, **fl) if old else
                           K.dgc_forward_rows(gs, ms, vs, bits, base, nr, k,
                                              0.9, **fl))
                    return (ms, vs, *sel)

                tag = f"{label} numels {nl[-1]} {fl}"
                errs["dgc_forward_rows"].append(_check_twice(
                    f"dgc_forward_rows {tag}", forward, want))
                if olds is not None:
                    _check_equal(f"old dgc_forward_rows {tag}",
                                 forward(old=True), want)
                for row in {0, R - 1}:      # the planted ties, in order
                    first = [c for c in ties if c < nl[row]][:k]
                    if want[4][row, :len(first)].tolist() != first:
                        raise AssertionError(f"{tag}: the planted ties did "
                                             "not reach the selection")
                if want[1][5:6].view(torch.int32).item() != -2 ** 31:
                    raise AssertionError(f"{tag}: the planted -0.0")
            if R > 1 and nl[1] < k:   # row 1 selects its -0.0, read +0.0
                slot = want[4][1].tolist().index(5)
                if want[3][1, slot:slot + 1].view(torch.int32).item() != 0:
                    raise AssertionError(f"{label}: the selected -0.0")
            x = want[1].view(R, cols)
            want_sel = K.select_pack_rows_plain(x, nr, k)
            errs["select_pack_rows"].append(_check_twice(
                f"select_pack_rows {label} numels {nl[-1]}",
                lambda: K.select_pack_rows(x, nr, k), want_sel))
            if olds is not None:
                _check_equal(f"old select_pack_rows {label}",
                             _old_select(olds[0], x, nr, k), want_sel)
        # the times, at the bucket's own numels
        nr = torch.tensor(numels, dtype=torch.int32, device=dev)
        x = K.dgc_forward_rows_plain(gs, m[base:base + n], v[base:base + n],
                                     bits, base, nr, k, 0.9)[1].view(R, cols)
        col = torch.arange(cols, device=dev)[None, :]
        # select: x read, (score, value, column) written; a few compares
        # per element
        b_sel = _bound(4 * n + 4 * R + 12 * R * k, 2 * n)
        calls["select_pack_rows"].append(dict(
            case=label, shape=[R, cols], k=k, route=plan.route,
            cluster=plan.cluster, threads=plan.threads,
            **_in_turns(lambda: K.select_pack_rows(x, nr, k),
                        olds and (lambda: _old_select(olds[0], x, nr, k))),
            **_timed(
                plain_ms=lambda: K.select_pack_rows_plain(x, nr, k),
                library_ms=lambda: x.gather(1, torch.topk(torch.where(
                    col < nr[:, None], x.abs(), -1.0), k, dim=1).indices)),
            bound_ms=b_sel[0], bound_by=b_sel[1]))
        # forward: g, m, v read and m, v written (20 B per element), the
        # region's record words read, the selection written; ~5 operations
        # per element for the compensate and a compare
        words = ((base + n - 1) // 4096 - base // 4096 + 1) * 128
        b_fwd = _bound(20 * n + 4 * words + 4 * R + 12 * R * k, 6 * n)
        win = K.realign_bits(bits, base, n)
        ms, vs = m[base:base + n].clone(), v[base:base + n].clone()
        calls["dgc_forward_rows"].append(dict(
            case=label, shape=[R, cols], k=k, base=base, route=plan.route,
            cluster=plan.cluster, threads=plan.threads,
            **_in_turns(
                lambda: K.dgc_forward_rows(gs, ms, vs, bits, base, nr, k,
                                           0.9),
                olds and (lambda: _old_forward(olds[1], gs, ms, vs, bits,
                                               base, nr, k))),
            **_timed(
                plain_ms=lambda: K.dgc_forward_rows_plain(
                    gs, ms, vs, bits, base, nr, k, 0.9),
                unfused_ms=lambda: K.select_pack_rows(K.compensate_bits(
                    gs, ms, vs, win, 0.9)[1].view(R, cols), nr, k)),
            library_ms=None, bound_ms=b_fwd[0], bound_by=b_fwd[1]))
    # a row too wide to stage: the block route forced on [3, 65536]
    x = torch.randn(3, 65536, device=dev, generator=gen)
    nr = torch.tensor([65536, 40000, 0], dtype=torch.int32, device=dev)
    plan = K.topk_plan(3, 65536, 208, "block")
    if plan.staged:
        raise AssertionError(f"select_pack_rows: {plan} stages the row")
    errs["select_pack_rows"].append(_check_twice(
        "select_pack_rows unstaged [3, 65536] k=208",
        lambda: K._select_pack_rows_launch(x, nr, 208, plan),
        K.select_pack_rows_plain(x, nr, 208)))
    sel = calls["select_pack_rows"]
    losing = [c for c in sel if c["ms"] > c["library_ms"]]
    print(f"[select_pack_rows] {len(cases)} cases x 2 numels (+ 1 unstaged),"
          " twice each, bitwise; slower than torch.topk + gather at "
          f"{len(losing)}: " + ", ".join(f"{c['case']} {c['shape']} "
                                        f"k={c['k']}" for c in losing))
    entries = {}
    for name, src, line in (
            ("select_pack_rows", "select_pack_rows.cu", 853),
            ("dgc_forward_rows", "dgc_forward_rows.cu", 1427)):
        step = [c for c in calls[name]
                if c["case"].startswith("resnet20 epoch 5")]
        sums = {key: (None if step[0][key] is None
                      else sum(c[key] for c in step))
                for key in step[0] if key.endswith("_ms") or key == "ms"}
        print(f"[{name}] ResNet-20 step at ratio 0.001 ({len(step)} calls): "
              + ", ".join(f"{key} {val:.4f}" for key, val in sums.items()
                          if val is not None)
              + "; " + "; ".join(
                  f"{c['shape']} k={c['k']} {c['route']} x{c['cluster']}: "
                  f"{c['ms']:.4f}" + (f" (old {c['old_ms']:.4f})"
                                      if c["old_ms"] else "")
                  for c in calls[name] if not c["case"].startswith(
                      "resnet20 epoch 5")))
        entries[name] = dict(
            name=name, route="cuda", source=f"dgc_tpu_torch/csrc/{src}",
            replaces=f"dgc_tpu/ops/kernels.py:{line}",
            check=f"bitwise vs {name}_plain at every case, twice",
            max_abs_err=max(errs[name]), **sums,
            bound_by=step[0]["bound_by"],
            summed_over="the calls of one worker's ResNet-20 step at ratio "
                        "0.001 (both buckets)", calls=calls[name])
    entries["select_pack_rows"]["replaces_also"] = (
        "dgc_tpu/ops/kernels.py:1001 (_select_pack_rows_mr)")
    return entries


def _plant_specials(g, m, v):
    """Infinities and NaNs in g, m and v at the start of the buffers, and
    from element 8 on bf16 rounding ties: with m = v = 0 and no nesterov,
    m' = v' = g exactly, so a g half-way between two bf16 values must round
    to the even one (1 + 2**-8 -> 1.0, 1 + 3 * 2**-8 -> 1.015625, ...).
    Returns the tie positions and the bf16 values they must store."""
    inf, nan = float("inf"), float("nan")
    g[0], g[1], g[2], m[3], v[4], m[5], v[5] = inf, -inf, nan, inf, nan, \
        -inf, inf
    ties = [(1 + 2 ** -8, 1.0), (1 + 3 * 2 ** -8, 1.015625),
            (-(1 + 2 ** -8), -1.0), (3 + 2 ** -7, 3.0),
            (3 + 3 * 2 ** -7, 3.03125)]
    for i, (x, _) in enumerate(ties):
        g[8 + i], m[8 + i], v[8 + i] = x, 0.0, 0.0
    return [(8 + i, want) for i, (_, want) in enumerate(ties)]


def _compensate_state(n, dtype, gen, sent_frac=0.25):
    """Random f32 gradient, state in ``dtype`` and a transmit count vector
    (0 = keep), with :func:`_plant_specials`' values."""
    import torch
    dev = DEVICE
    g, m, v = (torch.randn(n, device=dev, generator=gen) for _ in range(3))
    ties = _plant_specials(g, m, v)
    sent = (torch.rand(n, device=dev, generator=gen) < sent_frac).float()
    sent[:16] = 0.0
    sent[5] = 1.0                          # an inf masked by a multiply
    return g, m.to(dtype), v.to(dtype), sent, ties


#: holds the stream while a call of many launches is queued (~0.1 s)
_LONG_HOLD = 200_000_000


def _old_ladder_library(src_dir):
    """The earlier ``ladder_counts.cu`` from a directory of earlier sources
    (``git archive 2bc9984 dgc_tpu_torch/csrc``): its C launch takes a
    zero-filled output that it adds into."""
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    return _old_library(Path(src_dir) / "ladder_counts.cu",
                        "ladder_counts_launch",
                        [p, p, p, i, ctypes.c_longlong, i, p, i, p])


def _old_ladder(lib, x, t, lower, levels):
    """The earlier ladder kernel as its wrapper ran it: a zero fill of the
    [R, L] output, then the launch that adds into it."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    R, cols = x.shape
    out = torch.zeros((R, levels), dtype=torch.int32, device=x.device)
    f = K.ladder_factors(lower, levels).numpy()
    err = lib.ladder_counts_launch(x.data_ptr(), t.data_ptr(), f.ctypes.data,
                                   R, cols, levels, out.data_ptr(),
                                   *K._stream_args(x))
    if err:
        raise RuntimeError(f"old ladder_counts launch: CUDA error {err}")
    return out


def _library_compensate(gs, ms, vs):
    """One PyTorch call that computes ``m = 0.9 m + g; v = v + m`` over the
    tensors, as a time yardstick only (it may round through an FMA; the
    port never calls it): ``torch._fused_sgd_`` with lr = -1 on (v, g, m),
    else three ``torch._foreach_`` calls. Returns ``(fn, name)``."""
    import torch
    if hasattr(torch, "_fused_sgd_"):
        return (lambda: torch._fused_sgd_(
            vs, gs, ms, weight_decay=0.0, momentum=0.9, lr=-1.0,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), "torch._fused_sgd_")
    return (lambda: (torch._foreach_mul_(ms, 0.9), torch._foreach_add_(ms, gs),
                     torch._foreach_add_(vs, ms)),
            "three torch._foreach_ calls")


def _odd_views(sizes, dtype, gen):
    """Views at odd offsets of one flat buffer each (g, m, v, sent): every
    entry starts 1-7 elements past the previous one's end, and the state's
    views are shifted by one element from g's at every other entry (so
    those entries' streams share no alignment and run scalar)."""
    import torch
    dev = DEVICE
    total = sum(sizes) + 8 * len(sizes) + 8
    G, M, V = (torch.randn(total, device=dev, generator=gen)
               for _ in range(3))
    M, V = M.to(dtype), V.to(dtype)
    S = (torch.rand(total, device=dev, generator=gen) < 0.3).float()
    out, p = ([], [], [], []), 0
    for i, n in enumerate(sizes):
        p += 1 + (2 * i) % 7
        sh = i % 2
        for lst, buf, o in zip(out, (G, M, V, S), (0, sh, sh, 0)):
            lst.append(buf[p + o:p + o + n])
        p += n + 1
    return out


def phase_compensate_ladder_kernels(geoms20, geoms50, l1_engines=()):
    """The compensate kernel (``csrc/compensate.cu``, many tensors a
    launch) bitwise against ``fused_compensate_multi_plain`` at the
    per-tensor path's tables, one worker's 22 ResNet-20 tensors and the 88
    of a W=4 step, ResNet-50's 216 (over one launch's capacity), views at
    odd offsets of one flat buffer, n = 0 and n < 4 entries, with f32 and
    bf16 state and every flag; ``fused_compensate`` and
    ``fused_compensate_masked`` at one small tensor (4,096 and 65,536
    elements) and at the reference's check sizes (n =
    2,101,248 with f32 state, 2,105,345 with bf16), every flag
    combination, infinities, NaNs and bf16 rounding ties planted;
    ``ladder_counts`` bitwise against its plain version at [17, 262144], L
    = 11, with values planted on the levels, at L = 128 with cols % 4 != 0
    (one block a row and, at 262,147 columns, levels split), at unaligned
    row bases, at ResNet-50's adaptive buckets at the epoch-0 and
    epoch-5 ratios, and at L = 1 (the non-resample adaptation's count) at
    the adaptive buckets of ``l1_engines`` ``[(label, engine)]``, one
    launch each.
    Times; with ``--old-compensate-src`` / ``--old-ladder-src`` the PR-8
    kernels are held bitwise too and timed in turns with the new ones."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev = DEVICE
    old = _old_cands_module(OLD_COMPENSATE_SRC) if OLD_COMPENSATE_SRC else None
    old_lad = _old_ladder_library(OLD_LADDER_SRC) if OLD_LADDER_SRC else None
    gen = torch.Generator(device=dev).manual_seed(4)
    calls = {"fused_compensate": [], "fused_compensate_masked": [],
             "ladder_counts": []}
    errs = {k: [] for k in calls}
    flag_sets = [dict(nesterov=n, momentum_masking=mm)
                 for n in (False, True) for mm in (True, False)]
    # the reference's check sizes, every flag, specials planted
    for n, dtype in ((2_101_248, torch.float32), (2_105_345, torch.bfloat16)):
        g, m, v, sent, ties = _compensate_state(n, dtype, gen)
        for name in ("fused_compensate", "fused_compensate_masked"):
            masked = name == "fused_compensate_masked"
            extra = (sent,) if masked else ()
            kern, plain = getattr(K, name), getattr(K, name + "_plain")
            olds = getattr(old, name) if old else None
            for fl in flag_sets if masked else flag_sets[::2]:
                fl = fl if masked else {"nesterov": fl["nesterov"]}
                want = plain(g, m, v, *extra, 0.9, **fl)
                got = kern(g, m.clone(), v.clone(), *extra, 0.9, **fl)
                errs[name].append(_check_equal(
                    f"{name} n={n} {dtype} {fl}", got, want))
                if olds is not None:
                    _check_equal(f"old {name} n={n} {dtype} {fl}",
                                 olds(g, m.clone(), v.clone(), *extra, 0.9,
                                      **fl), want)
                if dtype == torch.bfloat16 and not fl["nesterov"]:
                    for i, val in ties:
                        if float(want[1][i]) != val:
                            raise AssertionError(f"{name}: the bf16 tie at "
                                                 f"{i} did not round to even")
            mm, vv = m.clone(), v.clone()
            per = 4 * dtype.itemsize + 4 + 4 * masked   # bytes per element
            bound_ms, bound_by = _bound(per * n, 5 * n)
            new_fn = lambda: kern(g, mm, vv, *extra, 0.9)  # noqa: E731
            old_fn = olds and (lambda: olds(g, mm, vv, *extra, 0.9))
            # the two kernels differ by a few percent here: three rounds
            cold = _in_turns(new_fn, old_fn, timer=_cold_ms, rounds=3)
            calls[name].append(dict(
                shape=[n], state=str(dtype).split(".")[-1],
                **_in_turns(new_fn, old_fn, rounds=3),
                plain_ms=_device_ms(lambda: plain(g, m, v, *extra, 0.9)),
                ms_l2_cold=cold["ms"], old_ms_l2_cold=cold["old_ms"],
                bound_ms=bound_ms, bound_by=bound_by))
    # one small tensor a call (fused_compensate's own one-entry launch)
    for n in (4096, 65536):
        g, m, v, sent, _ = _compensate_state(n, torch.float32, gen)
        for name in ("fused_compensate", "fused_compensate_masked"):
            extra = (sent,) if name == "fused_compensate_masked" else ()
            kern, plain = getattr(K, name), getattr(K, name + "_plain")
            olds = getattr(old, name) if old else None
            errs[name].append(_check_equal(
                f"{name} n={n}", kern(g, m.clone(), v.clone(), *extra, 0.9),
                plain(g, m, v, *extra, 0.9)))
            mm, vv = m.clone(), v.clone()
            calls[name].append(dict(
                table=f"one tensor n={n}", shape=[n], state="float32",
                **_in_turns(lambda: kern(g, mm, vv, *extra, 0.9),
                            olds and (lambda: olds(g, mm, vv, *extra, 0.9)),
                            rounds=3),
                plain_ms=_device_ms(lambda: plain(g, m, v, *extra, 0.9)),
                bound_ms=_bound((20 + 4 * len(extra)) * n, 5 * n)[0]))
    # the per-tensor path's tables, bitwise, and their times
    lay20, lay50 = geoms20[5][1].layout, geoms50[5][1].layout
    sizes20 = [lay20.sizes[nm] for nm in lay20.compressed_names]
    sizes50 = [lay50.sizes[nm] for nm in lay50.compressed_names]
    tables = [("resnet20 worker", sizes20, (torch.float32, torch.bfloat16)),
              ("resnet20 W=4 step", sizes20 * 4, (torch.float32,
                                                  torch.bfloat16)),
              ("resnet50 W=4 step", sizes50 * 4, (torch.float32,)),
              ("odd views", [5, 4099, 36864, 3, 1000, 17, 1, 2, 4096, 7],
               (torch.float32, torch.bfloat16)),
              ("n = 0 and n < 4", [0, 1, 3, 0, 2, 4, 5],
               (torch.float32, torch.bfloat16))]
    n_launches = {}
    for label, sizes, dtypes in tables:
        for dtype in dtypes:
            if label == "odd views":
                gs, ms, vs, ss = _odd_views(sizes, dtype, gen)
            else:
                gs, ms, vs = ([torch.randn(n, device=dev, generator=gen)
                               .to(dt) for n in sizes]
                              for dt in (torch.float32, dtype, dtype))
                ss = [(torch.rand(n, device=dev, generator=gen) < 0.3).float()
                      for n in sizes]
            plan = K.compensate_plan(
                sizes, [(x.data_ptr(), y.data_ptr(), z.data_ptr(), None)
                        for x, y, z in zip(gs, ms, vs)], dtype.itemsize)
            n_launches[label] = len(plan)
            if label == "odd views" and not (
                    any(h == -1 for h in plan[0].head)
                    and any(h > 0 for h in plan[0].head)):
                raise AssertionError(f"odd views: heads {plan[0].head}")
            for fl in flag_sets:
                for sents in (None, ss):
                    if sents is None and not fl["momentum_masking"]:
                        continue
                    name = ("fused_compensate" if sents is None
                            else "fused_compensate_masked")
                    want = K.fused_compensate_multi_plain(gs, ms, vs, 0.9,
                                                          sents=sents, **fl)
                    m2, v2 = [x.clone() for x in ms], [x.clone() for x in vs]
                    K.reset_launches()
                    K.fused_compensate_multi(gs, m2, v2, 0.9, sents=sents,
                                             **fl)
                    if K.LAUNCHES[name] != len(plan):
                        raise AssertionError(f"{label}: {K.LAUNCHES[name]} "
                                             f"launches, planned {len(plan)}")
                    errs[name].append(_check_equal(
                        f"fused_compensate_multi {label} {dtype} {fl} "
                        f"masked={sents is not None}", m2 + v2,
                        want[0] + want[1]))
                    if old is not None and dtype == torch.float32 and (
                            fl == flag_sets[0]):
                        m3, v3 = [x.clone() for x in ms], [x.clone()
                                                          for x in vs]
                        for i in range(len(gs)):
                            if sents is None:
                                old.fused_compensate(gs[i], m3[i], v3[i], 0.9)
                            else:
                                old.fused_compensate_masked(
                                    gs[i], m3[i], v3[i], sents[i], 0.9)
                        _check_equal(f"old compensate {label}", m3 + v3,
                                     want[0] + want[1])
            if dtype != torch.float32 or label not in (
                    "resnet20 worker", "resnet20 W=4 step"):
                continue
            mm, vv = [x.clone() for x in ms], [x.clone() for x in vs]
            lib_fn, lib_name = _library_compensate(gs, mm, vv)
            # the old kernels queue a launch a tensor: at most ~440 a timing
            reps = max(2, min(20, 440 // len(sizes)))
            calls["fused_compensate"].append(dict(
                table=label, tensors=len(sizes), elements=sum(sizes),
                launches=len(plan), **_in_turns(
                    lambda: K.fused_compensate_multi(gs, mm, vv, 0.9),
                    old and (lambda: [old.fused_compensate(x, y, z, 0.9)
                                      for x, y, z in zip(gs, mm, vv)]),
                    reps=reps, hold_cycles=_LONG_HOLD),
                plain_ms=_device_ms(lambda: K.fused_compensate_multi_plain(
                    gs, ms, vs, 0.9), hold_cycles=_LONG_HOLD),
                library_ms=_device_ms(lib_fn, hold_cycles=_LONG_HOLD),
                library=lib_name,
                bound_ms=_bound(20 * sum(sizes), 5 * sum(sizes))[0]))
    # ResNet-50's 54 tensors of one worker, timed (one launch)
    gs, ms, vs = ([torch.randn(n, device=dev, generator=gen) for n in sizes50]
                  for _ in range(3))
    lib_fn, lib_name = _library_compensate(gs, ms, vs)
    calls["fused_compensate"].append(dict(
        table="resnet50 worker", tensors=len(sizes50),
        elements=sum(sizes50), launches=1, **_in_turns(
            lambda: K.fused_compensate_multi(gs, ms, vs, 0.9),
            old and (lambda: [old.fused_compensate(x, y, z, 0.9)
                              for x, y, z in zip(gs, ms, vs)]),
            reps=8, hold_cycles=_LONG_HOLD),
        library_ms=_device_ms(lib_fn, hold_cycles=_LONG_HOLD),
        library=lib_name, bound_ms=_bound(20 * sum(sizes50), 0)[0]))
    del gs, ms, vs
    if n_launches["resnet50 W=4 step"] < 2:
        raise AssertionError("the 216-tensor table fit one launch")
    DETAIL["compensate_launches_by_table"] = n_launches

    # ladder_counts: planted levels at the reference's check shape, L = 128
    # with cols % 4 != 0, an unaligned row base, ResNet-50's buckets
    lower = 0.8
    card = functools.partial(K._ladder_max_clusters,
                             torch.cuda.current_device())
    cases = []
    for label, R, cols, levels, base in (
            ("[17, 262144] planted", 17, 262144, 11, 0),
            ("[5, 3001] L=128 planted", 5, 3001, 128, 0),
            ("[9, 1027] L=17 unaligned base planted", 9, 1027, 17, 1),
            ("[6, 70001] L=16 unaligned base planted", 6, 70001, 16, 3),
            ("[4, 300001] L=17 unaligned base planted", 4, 300001, 17, 1),
            ("[4, 262147] L=128 planted", 4, 262147, 128, 0)):
        flat = torch.rand(R * cols + base, device=dev, generator=gen) * 3.0
        imp = flat[base:].view(R, cols)
        thr = torch.rand(R, device=dev, generator=gen) + 0.5
        thr[3] = 0.0
        if R > 5:
            thr[4] = float("nan")
        imp[2, 7] = float("nan")
        imp[0, 1:4] = torch.tensor([-0.0, float("inf"), -float("inf")])
        imp[:, -100:] = -1.0
        fac = K.ladder_factors(lower, levels).to(dev)
        for i in range(levels):
            c = 10 + 3 * i
            if c + 2 >= cols - 100:
                break
            lv = fac[i] * thr
            imp[:, c] = lv
            imp[:, c + 1] = torch.nextafter(lv, torch.full_like(lv, 9.0))
            imp[:, c + 2] = torch.nextafter(lv, torch.full_like(lv, -9.0))
        cases.append((label, imp, thr, levels))
    for epoch in (0, 5):
        eng = geoms50[epoch][1]
        consts = eng._bucket_consts(torch.device(dev))
        vec = torch.randn(eng.T, device=dev, generator=gen)
        for b, c in zip(eng.buckets, consts):
            if b.exact or not b.adapt.any():
                continue
            block = vec[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
            x = torch.where(c["in_row"], block.abs(), -1.0)
            k = min(b.max_sel, b.cols)
            cases.append((f"resnet50 epoch {epoch} [{b.rows}, {b.cols}]", x,
                          torch.topk(x, k, dim=1).values[:, -1].contiguous(),
                          11))
    for label, eng in l1_engines:
        consts = eng._bucket_consts(torch.device(dev))
        vec = torch.randn(eng.T, device=dev, generator=gen)
        for b, c in zip(eng.buckets, consts):
            if b.exact or not b.adapt.any():
                continue
            block = vec[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
            x = torch.where(c["in_row"], block.abs(), -1.0)
            cases.append((
                f"{label} [{b.rows}, {b.cols}] L=1", x,
                torch.topk(x, b.max_sel, dim=1).values[:, -1].contiguous(),
                1))
    for label, x, t, levels in cases:
        want = K.ladder_counts_plain(x, t, lower, levels)
        if "planted" in label and not bool((want[3] == want[3, 0]).all()):
            raise AssertionError("ladder_counts: thr = 0 counts every "
                                 "level alike")
        K.reset_launches()
        errs["ladder_counts"].append(_check_equal(
            f"ladder_counts {label}", [K.ladder_counts(x, t, lower, levels)],
            [want]))
        if K.LAUNCHES["ladder_counts"] != 1:
            raise AssertionError(f"ladder_counts {label}: not one launch")
        if old_lad is not None:
            _check_equal(f"old ladder_counts {label}",
                         [_old_ladder(old_lad, x, t, lower, levels)], [want])
        R, cols = x.shape
        # bytes: the rows read once, the [R, L] counts written; ops: L
        # compares per element
        bound_ms, bound_by = _bound(4 * R * cols + 4 * R * levels,
                                    levels * R * cols)
        plan = K.ladder_plan(R, cols, levels, card)
        # the same kernel at a block a row, and, where the plan splits the
        # levels, at one split: what the cluster and the splits each buy
        row = K.LadderPlan("row", 1, 1, plan.threads, R)
        one = plan._replace(splits=1, grid=R * plan.cluster)
        calls["ladder_counts"].append(dict(
            case=label, shape=[R, cols], levels=levels,
            plan=plan._asdict(), **_in_turns(
                lambda: K.ladder_counts(x, t, lower, levels),
                old_lad and (lambda: _old_ladder(old_lad, x, t, lower,
                                                 levels))),
            row_ms=_device_ms(lambda: K._ladder_counts_launch(
                x, t, lower, levels, row)),
            one_split_ms=(_device_ms(lambda: K._ladder_counts_launch(
                x, t, lower, levels, one)) if plan.splits > 1 else None),
            plain_ms=_device_ms(lambda: K.ladder_counts_plain(x, t, lower,
                                                              levels)),
            bound_ms=bound_ms, bound_by=bound_by))
    if not any(c["plan"]["splits"] > 1 for c in calls["ladder_counts"]):
        raise AssertionError("ladder_counts: no case split its levels")
    if any(c["plan"]["splits"] > 1 for c in calls["ladder_counts"]
           if c["levels"] == 1):
        raise AssertionError("ladder_counts: a one-level case split")
    DETAIL["ladder_max_clusters"] = {
        th: [card(th, c) for c in range(1, K.LADDER_MAX_CLUSTER + 1)]
        for th in (512, 1024)}
    entries = {}
    step = next(c for c in calls["fused_compensate"]
                if c.get("table") == "resnet20 worker")
    entries["fused_compensate"] = dict(
        name="fused_compensate", route="cuda",
        source="dgc_tpu_torch/csrc/compensate.cu",
        replaces="dgc_tpu/ops/kernels.py:171",
        check="bitwise vs fused_compensate_multi_plain at every table (f32 "
              "and bf16 state, every flag, odd-offset views, n = 0..5, 216 "
              "tensors over three launches) and vs fused_compensate_plain "
              "at 2.1M elements (infinities, NaNs, bf16 ties)",
        max_abs_err=max(errs["fused_compensate"]),
        **{k: step[k] for k in ("ms", "old_ms", "plain_ms", "bound_ms",
                                "library_ms", "library")},
        bound_by="bytes",
        summed_over=f"one launch over the {step['tensors']} compressed "
                    "tensors of one worker's ResNet-20 per-tensor step (f32 "
                    "state); old_ms: the earlier kernel's launch a tensor",
        calls=calls["fused_compensate"])
    for name, line in (("fused_compensate_masked", 275),
                       ("ladder_counts", 652)):
        # the ladder's headline: the first one-level case, a shape of its
        # training path (the non-resample adaptation), where there is one
        c = next((c for c in calls[name] if c.get("levels") == 1),
                 calls[name][0])
        entries[name] = dict(
            name=name, route="cuda",
            source=("dgc_tpu_torch/csrc/ladder_counts.cu"
                    if name == "ladder_counts"
                    else "dgc_tpu_torch/csrc/compensate.cu"),
            replaces=f"dgc_tpu/ops/kernels.py:{line}",
            check=f"bitwise vs {name}_plain at every case",
            max_abs_err=max(errs[name]),
            **{k: c[k] for k in ("ms", "old_ms", "plain_ms", "bound_ms",
                                 "bound_by")},
            library_ms=None, of=str(c.get("case", c["shape"])),
            calls=calls[name])
    return entries


def _print_entries(entries):
    """One summary line per kernel; the per-call detail (and a kernel's
    planted cases or re-timing) goes to :data:`DETAIL_PATH`."""
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
        print(f"[kernel] {e['name']}: {e['ms']:.4f} ms on the device "
              f"(plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.5f}, "
              f"{len(e['calls'])} call shapes)")
        DETAIL[e["name"]] = e.pop("calls")
        for extra in ("planted", "retime"):
            if extra in e:
                DETAIL[f"{e['name']} {extra}"] = e.pop(extra)
    _write_detail()
    print(f"[kernel] per-call detail: {DETAIL_PATH}")


def _write_detail():
    DETAIL_PATH.parent.mkdir(exist_ok=True)
    DETAIL_PATH.write_text(json.dumps(DETAIL, indent=1))


def _exchange_run(eng, dev, steps, world=4):
    """``steps`` exchanges of ``eng`` among ``world`` workers on ``dev``
    from seeded inputs: every worker's exchanged gradient and final
    memory, on the CPU."""
    return _exchange_seq([eng] * steps, dev, world)


def _exchange_seq(engines, dev, world=4):
    """One exchange of each engine in ``engines`` in turn (e.g. across a
    ratio change; the memory carries) among ``world`` workers on ``dev``
    from seeded inputs: every worker's exchanged gradient and final
    memory, on the CPU."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    mems = [engines[0].init_memory(dev) for _ in range(world)]
    res = []
    for step, eng in enumerate(engines):
        grads = [torch.randn(eng.layout.total,
                             generator=torch.Generator().manual_seed(
                                 100 * step + w)).to(dev)
                 for w in range(world)]
        phases = [eng.draw_phases(torch.Generator().manual_seed(
            10 * step + w)) for w in range(world)]
        res += eng.exchange(grads, mems, phases, LocalComm(world))
    res += [t for m in mems for t in m.values()]
    return [t.cpu() for t in res]


def phase_engine_vs_cpu(geoms, label, steps, world=4, epochs=(0, 5)):
    """The exchange among ``world`` workers on the card and on the CPU,
    same inputs: every output bitwise, at the ``epochs``' ratios (at W = 3
    this holds the divide by W: an IEEE divide on both). Each check's
    seconds go to the detail's ``engine_vs_cpu_s``."""
    for epoch in epochs:
        eng = geoms[epoch][1]
        t0 = time.perf_counter()
        _check_equal(f"{label} engine exchange W={world} (epoch {epoch})",
                     _exchange_run(eng, DEVICE, steps, world),
                     _exchange_run(eng, "cpu", steps, world))
        DETAIL.setdefault("engine_vs_cpu_s", {})[
            f"{label} W={world} epoch {epoch}"] = time.perf_counter() - t0
    print(f"[engine] {label} W={world} exchange, {steps} step(s): card == "
          f"CPU bitwise at the ratios of epochs {list(epochs)}")


def _check_close(name, got, want, rtol, atol):
    """Each pair within ``rtol`` / ``atol`` (integer tensors, the transmit
    records, equal); returns the largest absolute difference."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: integer outputs differ")
            continue
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: beyond rtol {rtol}, atol {atol}")
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    return worst


def phase_dense_vs_cpu(world):
    """The all-dense branch (``resnet20_wm5o`` at epoch 4, ratio 1) among
    ``world`` workers, card against CPU, bitwise: a compressed step (the
    epoch-5 engine), which leaves a pending transmit record, two dense
    steps, which fold it into the memory, and a compressed step again,
    which reads the dense steps' momentum and an empty record."""
    geoms = _geometries("resnet20_wm5o", (4, 5))
    dense, comp = geoms[4][1], geoms[5][1]
    if not dense.dense or comp.dense:
        raise AssertionError("resnet20_wm5o: epoch 4 must be dense, 5 not")
    seq = [comp, dense, dense, comp]
    _check_equal(f"dense branch W={world}", _exchange_seq(seq, DEVICE, world),
                 _exchange_seq(seq, "cpu", world))
    print(f"[dense] resnet20_wm5o W={world}, steps "
          f"{['dense' if e.dense else 'compressed' for e in seq]}: card == "
          "CPU bitwise (the pending record folded, then the handover)")


def phase_nonresample_vs_cpu():
    """The W=4 exchange with ``resample=False, strided_sample=False``
    (uniform samples, the raise-or-lower adaptation through the ladder
    kernel at one level), card against CPU, bitwise, at the epoch-0 and
    epoch-5 ratios of ResNet-20."""
    geoms = _geometries("resnet20_wm5", (0, 5), resample=False,
                        strided_sample=False)
    for epoch, (ratio, eng) in geoms.items():
        _check_equal(f"non-resample exchange (epoch {epoch})",
                     _exchange_run(eng, DEVICE, 2),
                     _exchange_run(eng, "cpu", 2))
    print("[nonresample] resnet20 W=4 exchange, 2 steps, uniform samples "
          "and the raise-or-lower adaptation: card == CPU bitwise at the "
          "epoch-0 and epoch-5 ratios")


def phase_clip_vs_cpu(world=3):
    """The exchange with the memory's ``gradient_clipping`` (a per-tensor
    norm clip, and the global one reducing over the workers), card
    against CPU at ``resnet20_wm5o``'s epochs 4 (dense: the clip on the
    average) and 5 (the clip on each worker's compressed block and on the
    averaged dense tail): the tolerance of ``tests/test_torch_clip.py``
    (rtol 1e-6, atol 1e-7: the clip factors' sums of squares run in
    another order on the card), the transmit records equal."""
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.utils import clip_grad
    clips = {"norm": functools.partial(clip_grad.clip_grad_norm,
                                       max_norm=0.5),
             "global": clip_grad.global_norm_clipper(0.5, LocalComm(world))}
    worst = 0.0
    for label, clip in clips.items():
        geoms = _geometries("resnet20_wm5o", (4, 5), clip=clip)
        for epoch, (_, eng) in geoms.items():
            worst = max(worst, _check_close(
                f"{label} clip exchange (epoch {epoch})",
                _exchange_run(eng, DEVICE, 2, world),
                _exchange_run(eng, "cpu", 2, world), rtol=1e-6, atol=1e-7))
    print(f"[clip] resnet20_wm5o W={world}, norm and global clips, epochs 4 "
          f"and 5: card == CPU within rtol 1e-6 (largest difference "
          f"{worst:.3g}), records equal")


def phase_routes_vs_cpu(recipe, label, steps, epochs=(3, 5)):
    """The W=4 exchange with ``megakernel=True`` and with
    ``fused_select=True``, card against CPU, bitwise; and the card's
    megakernel engine against the card's default engine, bitwise (the
    exchanged gradients and memories: the payloads differ only where a
    selected -0.0 travels as +0.0, which no sum sees)."""
    geoms = {route: _geometries(recipe, epochs, **flags) for route, flags in (
        ("default", {}), ("megakernel", {"megakernel": True}),
        ("fused_select", {"fused_select": True}))}
    for epoch in epochs:
        card = {}
        for route in ("megakernel", "fused_select"):
            eng = geoms[route][epoch][1]
            card[route] = _exchange_run(eng, DEVICE, steps)
            _check_equal(f"{label} {route} exchange (epoch {epoch})",
                         card[route], _exchange_run(eng, "cpu", steps))
        _check_equal(f"{label} megakernel vs default engine (epoch {epoch})",
                     card["megakernel"],
                     _exchange_run(geoms["default"][epoch][1], DEVICE,
                                   steps))
        print(f"[routes] {label} epoch {epoch}: megakernel owns buckets "
              f"{list(geoms['megakernel'][epoch][1]._mk_fwd_ids)}, fused "
              f"select on {_fused_ids(geoms['fused_select'][epoch][1])}")
    print(f"[routes] {label} W=4 exchange, {steps} step(s), epochs "
          f"{list(epochs)}: megakernel and fused_select card == CPU, "
          "megakernel == default on the card, bitwise")


def _per_tensor_compressor(recipe, epoch=None, **overrides):
    """The recipe's compressor at the wm5 ratio of ``epoch`` (or with
    ``overrides``, e.g. ``compress_ratio`` and ``sample_ratio``) over the
    recipe model's compressed tensors, and ``{name: shape}`` of every
    parameter (the model built on the CPU for its shapes)."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression.dgc import DGCCompressor
    from dgc_tpu_torch.compression.memory import DGCSGDMemory
    from dgc_tpu_torch.models import create, param_tree
    from dgc_tpu_torch.utils.pytree import named_flatten
    cfg = configs.RECIPES[recipe]()
    cc = cfg.train.compression
    kw = dict(compress_ratio=cc.compress_ratio, sample_ratio=cc.sample_ratio,
              warmup_epochs=cc.warmup_epochs)
    kw.update(overrides)
    comp = DGCCompressor(kw.pop("compress_ratio"),
                         memory=DGCSGDMemory(cc.memory.momentum), **kw)
    model = create(cfg.model.name, cfg.model.num_classes, torch.Generator())
    shapes = {n: tuple(p.shape) for n, p in
              named_flatten(param_tree(model)).items()}
    comp.initialize((n, sh) for n, sh in shapes.items() if len(sh) > 1)
    if epoch is not None:
        comp.warmup_compress_ratio(epoch)
    return comp, shapes


def _worker_grads(shapes, dev, seed):
    """One worker's ``{name: gradient}``, views of one seeded flat draw."""
    import torch
    total = sum(math.prod(sh) for sh in shapes.values())
    flat = torch.randn(total, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    out, off = {}, 0
    for n, sh in shapes.items():
        k = math.prod(sh)
        out[n] = flat[off:off + k].view(sh)
        off += k
    return out


def _per_tensor_run(comp, shapes, dev, steps, sent=None, world=4):
    """``steps`` per-tensor exchanges among ``world`` workers
    (``DistributedOptimizer.exchange`` over ``LocalComm``) on ``dev`` from
    seeded gradients and
    phases: every worker's exchanged gradients, then its memory, on the
    CPU, in name order. ``sent`` collects ``{(step, name): [(valid
    indices, their |values|) per worker]}``."""
    import torch
    from dgc_tpu_torch.optim.distributed import DistributedOptimizer
    from dgc_tpu_torch.optim.sgd import dgc_sgd
    from dgc_tpu_torch.parallel.comm import LocalComm
    dist = DistributedOptimizer(dgc_sgd(0.1), comp, LocalComm(world))
    zeros = {n: torch.zeros(sh) for n, sh in shapes.items()}
    mems = [dist.init_memory(zeros, dev) for _ in range(world)]
    sparsify = comp.sparsify
    step = 0

    def recording(grad, name, phase=0):
        vals, idx, valid = sparsify(grad, name, phase)
        if sent is not None:
            sent.setdefault((step, name), []).append(
                (idx[valid].cpu(), vals[valid].float().abs().cpu()))
        return vals, idx, valid
    comp.sparsify = recording
    res = []
    try:
        for step in range(steps):
            grads = [_worker_grads(shapes, dev, 100 * step + w)
                     for w in range(world)]
            phases = [comp.draw_phases(torch.Generator().manual_seed(
                10 * step + w)) for w in range(world)]
            outs, mems = dist.exchange(grads, mems, phases)
            res.append([{n: t.cpu() for n, t in o.items()} for o in outs])
    finally:
        del comp.sparsify
    return res, [{k: {n: t.cpu() for n, t in m[k].items()} for k in m}
                 for m in mems]


def phase_per_tensor_vs_cpu(recipe="resnet20_wm5", label="resnet20",
                            steps=2, world=4):
    """The per-tensor exchange among ``world`` workers on the card and on
    the CPU, same inputs, at the epoch-0 and epoch-5 ratios: memory
    bitwise; the exchanged gradients bitwise apart from coordinates
    several workers sent, whose sums ``index_add_`` takes in atomic order
    on the card. Two orders of a sum of W terms differ by at most
    (W - 1) eps sum|v_i|; the divide by W is an IEEE divide on both
    devices (``kernels.divide_exact``), which adds at most one rounding of
    |sum|/W to each side, so the two quotients are held within
    eps sum|v_i| at any W."""
    import torch
    for epoch in (0, 5):
        comp, shapes = _per_tensor_compressor(recipe, epoch)
        sent = {}
        cpu_out, cpu_mem = _per_tensor_run(comp, shapes, "cpu", steps, sent,
                                           world)
        card_out, card_mem = _per_tensor_run(comp, shapes, DEVICE, steps,
                                             world=world)
        for m_card, m_cpu in zip(card_mem, cpu_mem):
            for k in m_cpu:
                _check_equal(f"{label} per-tensor memory W={world} "
                             f"(epoch {epoch})",
                             list(m_card[k].values()),
                             list(m_cpu[k].values()))
        n_dup, eps = 0, torch.finfo(torch.float32).eps
        for step, (o_card, o_cpu) in enumerate(zip(card_out, cpu_out)):
            for n in shapes:
                numel = math.prod(shapes[n])
                dup = torch.zeros(numel, dtype=torch.bool)
                mass = torch.zeros(numel)
                if (step, n) in sent:
                    idx = torch.cat([i for i, _ in sent[(step, n)]]).long()
                    u, c = idx.unique(return_counts=True)
                    dup[u[c > 1]] = True
                    mass.index_add_(0, idx, torch.cat(
                        [a for _, a in sent[(step, n)]]))
                n_dup += int(dup.sum())
                for a, b in zip(o_card, o_cpu):
                    x, y = a[n].reshape(-1), b[n].reshape(-1)
                    _check_equal(f"{label} per-tensor {n} W={world} "
                                 f"(epoch {epoch})",
                                 [x[~dup]], [y[~dup]])
                    if bool(((x - y).abs() > eps * mass)[dup].any()):
                        raise AssertionError(f"{label} per-tensor {n}: the "
                                             "duplicate coordinates")
        print(f"[per-tensor] {label} W={world} exchange, {steps} step(s), "
              "epoch "
              f"{epoch}: card == CPU bitwise, memory included, apart from "
              f"{n_dup} coordinates several workers sent (within eps "
              "sum|v_i|)")


def phase_per_tensor_vs_flat(recipe, label, steps):
    """On the card, the per-tensor W=4 exchange against the flat engine's,
    same gradients, ``sample_ratio=1.0`` at ratio 0.05 (the JAX package's
    test_flat.py contract): exchanged gradients and memory within rtol
    1e-5 / atol 1e-6 over ``steps`` steps."""
    import torch
    from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
    from dgc_tpu_torch.parallel.comm import LocalComm
    comp, shapes = _per_tensor_compressor(recipe, compress_ratio=0.05,
                                          sample_ratio=1.0, warmup_epochs=-1)
    out_p, mem_p = _per_tensor_run(comp, shapes, DEVICE, steps)
    eng = FlatDGCEngine(comp, ParamLayout.for_compressor(shapes, comp))
    mems = [eng.init_memory(DEVICE) for _ in range(4)]
    worst = 0.0
    for step in range(steps):
        grads = [eng.layout.flatten(_worker_grads(shapes, DEVICE,
                                                  100 * step + w),
                                    device=DEVICE) for w in range(4)]
        outs = eng.exchange(grads, mems, [[[]] * len(eng.buckets)] * 4,
                            LocalComm(4))
        for w in range(4):
            got = eng.layout.unflatten_named(outs[w].cpu())
            for n in shapes:
                a, b = got[n], out_p[step][w][n]
                if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"{label} per-tensor vs flat {n}")
                worst = max(worst, float((a - b).abs().max()))
    for w in range(4):
        sd = eng.memory_state_dict(mems[w])
        for k in sd:
            for n in shapes:
                if not torch.allclose(sd[k][n].cpu(), mem_p[w][k][n],
                                      rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"{label} per-tensor vs flat {k} {n}")
    print(f"[per-tensor] {label} W=4, {steps} step(s), ratio 0.05, "
          f"sample_ratio 1.0: per-tensor == flat engine on the card "
          f"(rtol 1e-5, atol 1e-6; largest difference {worst:.3g})")


def phase_masked_check(trainer):
    """``fused_compensate_masked`` on the flat engine's own transmit record
    and state after a training path (the record expanded to a count
    vector) against ``compensate_bits`` on the record itself: bitwise.
    Counts zeroed just before the masked launch and read just after."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    eng, mem = trainer.setup.engine, trainer.state.memory[0]
    T, mcfg = eng.T, eng.c.memory
    g = torch.randn(T, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(6))
    sent = 1.0 - K.keep_from_bits(mem["sent_bits"], T)
    args = (mcfg.momentum, mcfg.nesterov, mcfg.momentum_masking)
    m, v = mem["momentums_c"].clone(), mem["velocities_c"].clone()
    torch.cuda.synchronize()
    _zero_counts()
    got = K.fused_compensate_masked(g, m, v, sent, *args)
    torch.cuda.synchronize()
    counts = _read_counts("masked_check", ["fused_compensate_masked"])
    want = K.compensate_bits(g, mem["momentums_c"].clone(),
                             mem["velocities_c"].clone(), mem["sent_bits"],
                             *args)
    _check_equal("fused_compensate_masked vs compensate_bits on the "
                 "engine's record", got, want)
    print(f"[masked_check] T={T}, {int(sent.sum())} coordinates pending in "
          "the record: fused_compensate_masked == compensate_bits bitwise")
    return counts


def phase_per_tensor_path(label="resnet20_per_tensor", recipe="resnet20_wm5",
                          schedule=((0, 2), (5, 2))):
    """The per-tensor path: ``train_step_per_tensor`` at full width, the
    recipe's batch per worker, W=4 ``LocalComm`` on the card; ``schedule``
    is ``[(epoch, steps)]``, the compressor re-initialised at each epoch's
    ratio. Counts zeroed just before the steps and read just after: the
    exchange compensates every compressed tensor of the 4 workers in one
    ``fused_compensate`` launch a step (one per
    ``COMPENSATE_MAX_ENTRIES`` tensors), and nothing launches
    ``compensate_bits``."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.data.sampler import epoch_batches
    from dgc_tpu_torch.ops import kernels as K
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.step import (make_flat_state,
                                             make_per_tensor_setup,
                                             train_step_per_tensor)
    trainer = Trainer(configs.RECIPES[recipe](), comm=LocalComm(4),
                      device=DEVICE)
    setup = make_per_tensor_setup(trainer.model, trainer.dist)
    state = make_flat_state(trainer.model, trainer.dist, setup,
                            trainer.device)
    n_comp = len(trainer.compression.attributes)
    torch.cuda.synchronize()
    _zero_counts()
    times, losses, ratios = {}, {}, {}
    for epoch, steps in schedule:
        trainer.compression.warmup_compress_ratio(epoch)
        ratios[epoch] = trainer.compression.compress_ratio
        it = epoch_batches(len(trainer.dataset["train"]),
                           trainer.global_batch, epoch, seed=trainer.seed)
        times[epoch], losses[epoch] = [], []
        for _, idx in zip(range(steps), it):
            xs, ys = trainer._batches(idx)
            t0 = time.perf_counter()
            state, loss = train_step_per_tensor(
                trainer.model, setup, trainer.dist, state, xs, ys,
                trainer.gens)
            torch.cuda.synchronize()
            times[epoch].append(time.perf_counter() - t0)
            losses[epoch].append(float(loss))
    counts = _read_counts(label, ["fused_compensate"])
    per_step = -(-n_comp * 4 // K.COMPENSATE_MAX_ENTRIES)
    want = per_step * sum(st for _, st in schedule)
    if counts["fused_compensate"] != want or counts["compensate_bits"]:
        raise AssertionError(f"{label}: fused_compensate launched "
                             f"{counts['fused_compensate']} times (want "
                             f"{want}), compensate_bits "
                             f"{counts['compensate_bits']}")
    for epoch, ls in losses.items():
        if not all(math.isfinite(x) for x in ls):
            raise AssertionError(f"{label}: losses at epoch {epoch}: {ls}")
        print(f"[{label}] epoch {epoch} ratio {ratios[epoch]:.4g} loss {ls} "
              f"step_s {times[epoch]}")
    if not bool(torch.isfinite(state.params).all()):
        raise AssertionError(f"{label}: non-finite parameters")
    return counts


def _ladder_inputs(eng, bi, vec, gen):
    """One 2-D bucket's importance view, selection top-k and sampled
    threshold, as the engine's ``_sparsify_bucket_2d`` forms them."""
    from dgc_tpu_torch.compression.flat import select_topk
    import torch
    b = eng.buckets[bi]
    c = eng._bucket_consts(torch.device(DEVICE))[bi]
    block = vec[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
    imp = torch.where(c["in_row"], block.abs(), -1.0)
    top = select_topk(imp, b.max_sel)[0]
    phases = torch.rand(len(b.stride_groups), generator=gen).tolist()
    smp = eng._sample_rows(b, c, imp, phases).contiguous()
    thr = select_topk(smp, b.max_k)[0].gather(1, c["k_idx"])[:, 0]
    return imp, top, thr, c


def phase_ladder_check(engines):
    """The full-scan ladder (``flat._ladder_adapt``, through
    ``ladder_counts``) against the engine's from-top-k derivation on the
    engine's own velocity (the compensate of a seeded gradient), at every
    bucket whose selection is an exact top-k of the row and that adapts,
    for ``engines`` ``[(label, engine)]``: the adapted thresholds equal
    bitwise. Counts zeroed just before the ladder calls and read after."""
    import numpy as np
    import torch
    from dgc_tpu_torch.compression import flat
    dev, gen = DEVICE, torch.Generator().manual_seed(8)
    inputs = []
    for label, eng in engines:
        mem = eng.init_memory(dev)
        grad = torch.randn(eng.layout.total, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               eng.T % 1000))
        vec, _ = eng._compensate_acc(mem, grad[:eng.T])
        for bi, b in enumerate(eng.buckets):
            if (eng._seg[bi] or eng._use_3d(b) or b.exact
                    or not b.adapt.any()):
                continue
            inputs.append((label, bi, b, eng, *_ladder_inputs(eng, bi, vec,
                                                              gen)))
    torch.cuda.synchronize()
    _zero_counts()
    full = [flat._ladder_adapt(
        imp, thr, torch.from_numpy(b.num_selects.astype(np.float32)).to(dev),
        c["adapt"], eng.c.compress_lower_bound, eng.c.max_adaptation_iters)
        for _, _, b, eng, imp, _, thr, c in inputs]
    torch.cuda.synchronize()
    counts = _read_counts("ladder_check", ["ladder_counts"])
    moved = 0
    for (label, bi, b, eng, imp, top, thr, c), a in zip(inputs, full):
        want = eng._ladder_adapt_from_topk(c, top, thr)
        _check_equal(f"ladder {label} bucket {bi} [{b.rows}, {b.cols}]",
                     [a], [want])
        moved += int((a != thr).sum())
    print(f"[ladder_check] {len(inputs)} bucket-epochs: _ladder_adapt "
          "(ladder_counts) == _ladder_adapt_from_topk bitwise; "
          f"{moved} row thresholds adapted")
    return counts


def _zero_counts():
    from dgc_tpu_torch.compression import flat
    from dgc_tpu_torch.ops import kernels as K
    K.reset_launches()
    for route in flat.ROUTES:
        flat.ROUTES[route] = 0


def _read_counts(label, must_launch):
    """The launch and route counts since :func:`_zero_counts`; fails when
    a kernel (or route) of ``must_launch`` has none."""
    from dgc_tpu_torch.compression import flat
    from dgc_tpu_torch.ops import kernels as K
    counts = {**K.LAUNCHES, **flat.ROUTES}
    missing = [k for k in must_launch if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: never launched: {missing}")
    return counts


#: the kernels of the DGC exchange: all but the opaque copies, which bind
#: guarded weights on any path (and the ``lax_top_k`` route)
_DGC_KERNELS = ("compensate_bits", "compensate_bits_cands",
                "seg_top2_candidates", "topk_rows", "apply_rows",
                "select_pack_rows", "dgc_forward_rows", "fused_compensate",
                "fused_compensate_masked", "ladder_counts", "lax_top_k",
                "sel3d")


def phase_train_path(label, recipe, schedule, must_launch, epoch_rules=None,
                     predict=False, world=4, comm=None, adasum=False,
                     train=None, on_epoch=None, **compression):
    """A ``Trainer`` over W=``world`` ``LocalComm`` workers (or ``comm``)
    on the card, with the recipe's compression settings overridden by
    ``compression`` and its ``train`` keys by ``train`` (``adasum``: the
    Adasum optimizer): ``schedule`` is ``[(epoch, steps)]``; counts zeroed
    just before each epoch's steps and read just after (the path's counts
    are their sums); ``on_epoch(epoch)`` runs before each epoch.
    ``epoch_rules`` maps an epoch to ``(must launch, must not launch)``;
    with ``predict`` each epoch's counts of the exchange's kernels must be
    the ones its engine predicts (:func:`_predicted_launches`)."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    cfg = configs.RECIPES[recipe]()
    cfg.train.compression.update(compression)
    cfg.train.update(train or {})
    trainer = Trainer(cfg, comm=comm or LocalComm(world), device=DEVICE,
                      adasum=adasum)
    times, losses, ratios, per_epoch = {}, {}, {}, {}
    for epoch, steps in schedule:
        if on_epoch is not None:
            on_epoch(epoch)
        t = []
        torch.cuda.synchronize()
        _zero_counts()
        losses[epoch] = [float(x) for x in trainer.run_epoch(epoch, steps,
                                                             t)]
        torch.cuda.synchronize()
        must, must_not = (epoch_rules or {}).get(epoch, ((), ()))
        per_epoch[epoch] = _read_counts(f"{label} epoch {epoch}", must)
        if predict:
            want = _predicted_launches(trainer.setup.engine, world,
                                       len(losses[epoch]))
            got = {k: per_epoch[epoch][k] for k in want}
            if got != want:
                raise AssertionError(f"{label} epoch {epoch}: launches "
                                     f"{got}, predicted {want}")
        launched = [k for k in must_not if per_epoch[epoch][k]]
        if launched:
            raise AssertionError(f"{label} epoch {epoch} launched "
                                 f"{launched}")
        times[epoch] = t
        ratios[epoch] = trainer.compression.compress_ratio
    counts = {k: sum(c[k] for c in per_epoch.values())
              for k in per_epoch[schedule[0][0]]}
    DETAIL[f"launches {label} by epoch"] = per_epoch
    DETAIL[f"losses {label}"] = losses
    missing = [k for k in must_launch if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: never launched: {missing}")
    for epoch, ls in losses.items():
        if len(ls) != dict(schedule)[epoch] or not all(
                math.isfinite(x) for x in ls):
            raise AssertionError(f"{label}: losses at epoch {epoch}: {ls}")
    if not bool(torch.isfinite(trainer.state.params).all()):
        raise AssertionError(f"{label}: non-finite parameters")
    for epoch, _ in schedule:
        ratio = "dense" if ratios[epoch] is None else f"{ratios[epoch]:.4g}"
        print(f"[{label}] epoch {epoch} ratio {ratio} loss "
              f"{losses[epoch]} step_s {times[epoch]}")
    DETAIL[f"step_s {label}"] = times
    return trainer, counts


def _predicted_launches(eng, world, steps):
    """The launches ``steps`` exchanges of ``eng`` among ``world`` workers
    make of the compensates, ``topk_rows`` and ``apply_rows``, from the
    engine's routes: a compensate and an apply a worker step (the fused
    candidates' compensate where a sparse bucket takes the segment path);
    a top-k launch for every selection and threshold top-k whose k the
    kernel takes (the segment path: the threshold and the candidates'
    selection; the 2-D path: the selection unless fused, the threshold
    unless the bucket samples every element); without the fused
    candidates (a gossip plan) a ``seg_top2_candidates`` launch for each
    segment bucket a worker step."""
    from dgc_tpu_torch.ops import kernels as K
    out = {"compensate_bits": 0, "compensate_bits_cands": 0, "topk_rows": 0,
           "apply_rows": 0, "seg_top2_candidates": 0}
    if eng.dense:
        return out
    if eng._mk_fwd_ids or eng._sel3d.count(True):
        raise AssertionError("no prediction for the megakernel or the 3-D "
                             "fallback")

    def topk(k):
        return int(0 < k <= K.TOPK_MAX_K)
    per = 0
    for bi in eng._sparse_ids:
        b = eng.buckets[bi]
        if eng._seg[bi]:
            per += topk(b.max_k) + topk(b.max_sel)
        else:
            per += (0 if eng._use_fused_select(b) else topk(b.max_sel))
            per += 0 if b.exact else topk(b.max_k)
    n = world * steps
    out["compensate_bits_cands" if eng._seg_fused else "compensate_bits"] = n
    out["topk_rows"], out["apply_rows"] = per * n, n
    # segment buckets without the fused candidates (a gossip plan) take
    # the standalone candidates kernel, one launch a bucket
    out["seg_top2_candidates"] = (0 if eng._seg_fused else n * sum(
        eng._seg[bi] for bi in eng._sparse_ids))
    return out


def phase_slice_path():
    """The slice's path: ``resnet50_wm5_bf16mem_int8_packidx`` (the bf16
    error-feedback state, the int8 wire with error feedback, bit-packed
    indices) at full width, 224x224, batch 32 a worker, W=4 on the card,
    across the epoch 4 -> 5 handover (1 step at epoch 4, where every
    bucket selects on the 2-D path and compensates through
    ``compensate_bits``; 3 at epoch 5, where six buckets take the segment
    path and every compensate emits the candidates): each epoch's launches
    of the compensates, ``topk_rows`` and ``apply_rows`` the engine's
    predicted counts, the state bf16 and the transmit record empty (the
    int8 slots stay out of it). Returns ``(trainer, counts)``."""
    import torch
    label = "resnet50_bf16mem_int8_packidx"
    trainer, counts = phase_train_path(
        label, "resnet50_wm5_bf16mem_int8_packidx", [(4, 1), (5, 3)],
        ["compensate_bits", "compensate_bits_cands", "topk_rows",
         "apply_rows"],
        epoch_rules={4: (("compensate_bits",), ("compensate_bits_cands",)),
                     5: (("compensate_bits_cands",), ("compensate_bits",))},
        predict=True)
    eng = trainer.setup.engine
    mem = trainer.state.memory[0]
    if (mem["velocities_c"].dtype != torch.bfloat16
            or set(eng.regimes) != {"int8_packed"}):
        raise AssertionError(f"{label}: state {mem['velocities_c'].dtype}, "
                             f"regimes {eng.regimes}")
    if int(mem["sent_bits"].ne(0).sum()):
        raise AssertionError(f"{label}: the int8 slots reached the record")
    by_epoch = DETAIL[f"launches {label} by epoch"]
    print(f"[{label}] launches by epoch: " + "; ".join(
        f"{e}: " + ", ".join(f"{k} {v}" for k, v in c.items() if v)
        for e, c in by_epoch.items()))
    print(f"[{label}] wire {eng.wire_bytes_per_worker()} bytes a worker "
          f"(the f32 wire's at the same ratio: "
          f"{_geometries('resnet50_wm5', (5,))[5][1].wire_bytes_per_worker()})")
    return trainer, counts


def phase_autotune():
    """ResNet-20 (``resnet20_wm5_autotune``: the ``--autotune`` block)
    W=4 on the card across one epoch boundary: the plan at build time, 3
    steps at epoch 4, the refit and replan at its end (``fabric.json``
    written), 2 steps at epoch 5 (the engine rebuilt for the new ratio,
    and for a plan whose key changed), the second refit. Counts zeroed
    before each epoch and read after; the losses finite. Returns the
    path's counts."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    label = "resnet20_autotune"
    with tempfile.TemporaryDirectory() as tmp:
        fab = Path(tmp) / "fabric.json"
        trainer = Trainer(configs.resnet20_wm5_autotune(), LocalComm(4),
                          device=DEVICE, fabric_out=str(fab))
        at = trainer.autotuner
        record = {"fabric": at.fabric._asdict(), "epochs": {}}
        counts = {}
        for epoch, steps in ((4, 3), (5, 2)):
            torch.cuda.synchronize()
            _zero_counts()
            losses = [float(x) for x in trainer.run_epoch(epoch, steps)]
            torch.cuda.synchronize()
            c = _read_counts(f"{label} epoch {epoch}", ())
            key = at.plan.key()
            new = trainer.autotune_epoch_end(epoch)
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{label}: losses {losses}")
            record["epochs"][epoch] = dict(
                regimes=list(trainer.setup.engine.regimes), losses=losses,
                launches={k: v for k, v in c.items() if v},
                refit=at.fabric._asdict(), points=len(at.points),
                key_changed=new is not None and new.key() != key,
                next_regimes=list(at.plan.regimes))
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        written = json.loads(fab.read_text())
    if at.refit_count != 2 or written["provenance"]["refit"] != 2:
        raise AssertionError(f"{label}: {at.refit_count} refits")
    record["fabric.json"] = written
    DETAIL[f"autotune {label}"] = record
    for epoch, r in record["epochs"].items():
        print(f"[{label}] epoch {epoch}: plan {r['regimes']}, losses "
              f"{r['losses']}; refit {r['refit']['gbps']:.4g} GB/s alpha "
              f"{r['refit']['alpha_ms']:.4g} ms over {r['points']} points "
              f"-> {r['next_regimes']} (key changed: {r['key_changed']})")
    print(f"[{label}] fabric.json: {json.dumps(written['fit'])}, "
          f"provenance refit {written['provenance']['refit']}")
    return counts


#: the VGG-16 path's rules: the warm-up epochs select wide buckets on the
#: 3-D fallback and compensate alone, epoch 5 takes the segment path,
#: whose compensate emits the candidates
_VGG_WARMUP = (("topk_rows", "apply_rows", "compensate_bits", "sel3d"),
               ("compensate_bits_cands", "seg_top2_candidates"))
_VGG_SEG = (("topk_rows", "apply_rows", "compensate_bits_cands"),
            ("sel3d", "compensate_bits"))


def phase_vgg_paths(profile=False):
    """VGG-16-BN on synthetic ImageNet, full width (224x224, batch 32 a
    worker, W=4 on the card, dropout from each worker's generator): one
    step at each of epochs 0 and 4 (the 3-D fallback), two at epoch 5
    (the segment path), each epoch's launch rules held, then the
    evaluation; the bf16 twin one step at epochs 0 and 5, no opaque copy,
    its first loss within 2% of the f32 path's (the same weights, batch
    and dropout masks); resume bitwise across the 3-D -> segment handover
    (epochs 4 -> 5); under ``profile`` a traced window of 3 steps at epoch
    5. Each part's peak of allocated device memory is printed. Returns
    ``{path: counts}``."""
    import torch
    by_path, peaks = {}, {}

    def peak(part):
        peaks[part] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    peak("before")
    rules = {e: _VGG_WARMUP for e in (0, 4)}
    rules[5] = _VGG_SEG
    trainer, by_path["vgg16_bn"] = phase_train_path(
        "vgg16_bn", "vgg16_bn_wm5", [(0, 1), (4, 1), (5, 2)],
        ["topk_rows", "apply_rows", "compensate_bits",
         "compensate_bits_cands", "sel3d"], epoch_rules=rules)
    phase_evaluate(trainer, "vgg16_bn")
    if profile:
        phase_profile(trainer, "vgg16_bn")
    del trainer
    peak("vgg16_bn")
    copies = ("opaque_view", "opaque_view_from")
    _, by_path["vgg16_bn_bf16"] = phase_train_path(
        "vgg16_bn_bf16", "vgg16_bn_wm5_bf16", [(0, 1), (5, 1)],
        ["topk_rows", "apply_rows", "sel3d", "compensate_bits_cands"],
        epoch_rules={0: (_VGG_WARMUP[0], _VGG_WARMUP[1] + copies),
                     5: (_VGG_SEG[0], _VGG_SEG[1] + copies)})
    peak("vgg16_bn_bf16")
    f32 = DETAIL["losses vgg16_bn"][0][0]
    b16 = DETAIL["losses vgg16_bn_bf16"][0][0]
    if not abs(b16 - f32) <= 0.02 * abs(f32):
        raise AssertionError(f"bf16 first loss {b16}, f32 {f32}")
    print(f"[vgg16_bn_bf16] first loss {b16} against the f32 path's {f32} "
          f"(within 2%), no opaque copy")
    phase_resume("vgg16_bn_wm5", "vgg16_bn_wm5", [(4, 1), (5, 1)],
                 list(_VGG_SEG[0]))
    peak("resume")
    del peaks["before"]
    DETAIL["vgg16_bn peak_gib"] = peaks
    print("[vgg16_bn] peak allocated device memory, GiB: "
          + json.dumps({k: round(v, 2) for k, v in peaks.items()}))
    return by_path


def phase_evaluate(trainer, label):
    """``Trainer.evaluate("test")`` on the card: top-1 and top-5 finite and
    in [0, 100]."""
    t0 = time.perf_counter()
    meters = trainer.evaluate("test")
    secs = time.perf_counter() - t0
    if not meters or not all(math.isfinite(v) and 0.0 <= v <= 100.0
                             for v in meters.values()):
        raise AssertionError(f"{label} evaluation: {meters}")
    print(f"[{label}] eval on {len(trainer.dataset['test'])} test images "
          f"({secs:.2f} s): " + ", ".join(f"[{k}] = {v:.2f}"
                                         for k, v in meters.items()))
    DETAIL[f"eval {label}"] = dict(meters, seconds=secs)
    return meters


def phase_standalone_candidates(geoms50):
    """The standalone-candidates path at ResNet-50 geometry (ratio 0.001)
    for 4 workers: ``engine.sparsify(vec, phases)`` without candidates,
    counts zeroed just before and read just after; each payload bitwise
    the same call with the compensate pass's candidates."""
    import torch
    eng = geoms50[5][1]
    vecs, cands, phases = [], [], []
    for w in range(4):
        mem = eng.init_memory(DEVICE)
        grad = torch.randn(eng.layout.total, device=DEVICE,
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(50 + w))
        vec, c = eng._compensate_acc(mem, grad[:eng.T])
        vecs.append(vec)
        cands.append(c)
        phases.append(eng.draw_phases(torch.Generator().manual_seed(w)))
    torch.cuda.synchronize()
    _zero_counts()
    alone = [eng.sparsify(v, p) for v, p in zip(vecs, phases)]
    torch.cuda.synchronize()
    counts = _read_counts("candidates", ["seg_top2_candidates"])
    for a, v, c, p in zip(alone, vecs, cands, phases):
        _check_equal("sparsify without candidates", a,
                     eng.sparsify(v, p, seg_cands=c))
    print("[candidates] sparsify without candidates == with the fused "
          "candidates, bitwise, 4 workers")
    return counts


#: the ops whose [P]-sized launches inside autograd's backward are its
#: per-view gradient sums: the zeros of each view's [P] gradient and the
#: adds that sum them
_VIEW_SUM_OPS = ("aten::fill_", "aten::zero_", "aten::add_", "aten::add")


def _in_backward(event):
    """Whether a host op ran inside one of autograd's
    ``evaluate_function`` scopes."""
    p = event.cpu_parent
    while p is not None:
        if p.name.startswith("autograd::engine::evaluate_function"):
            return True
        p = p.cpu_parent
    return False


def _view_sums_window(run, P):
    """``run()`` traced with host ops and their input shapes: the device ms
    and launch count of autograd's per-view [P] gradient sums (the
    kernels that :data:`_VIEW_SUM_OPS` on a [P] tensor launch inside the
    backward; the optimizer's [P] adds run outside it), and the device ms
    of every activity in the same window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    total_us = sums_us = 0.0
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total_us += e.time_range.end - e.time_range.start
        elif (e.name in _VIEW_SUM_OPS and e.input_shapes
              and list(e.input_shapes[0]) == [P] and _in_backward(e)):
            sums_us += sum(k.duration for k in e.kernels)
            launches += len(e.kernels)
    return sums_us / 1e3, launches, total_us / 1e3


def phase_profile(trainer, label, steps=3):
    """Over ``steps`` further steps at the epoch-5 ratio, traced with
    ``torch.profiler`` on the device only (no host-side events, which
    slow the host): the step times, the device time by kernel, and the
    device's busy share (the union of kernel intervals) of the host wall
    time of that same window. Then ``steps`` more, traced with host ops
    and shapes, for the share of the device time in autograd's per-view
    [P] gradient sums (:func:`_view_sums_window`)."""
    epoch = 5
    trainer.run_epoch(epoch, 1)            # warm, outside the window
    step_s = []
    wall_ms, busy_ms, by_name = _device_window(
        lambda: trainer.run_epoch(epoch, steps, step_s))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = {k: v for k, v in by_name.items()
            if any(n in k for n in _KERNEL_SYMBOLS)}
    kernel_ms = sum(v[0] for v in by_name.values())
    # autograd's sums of each parameter view's [P] gradient (ROADMAP 2b
    # item 0), in a window of their own
    sums_ms, sums_n, traced_ms = _view_sums_window(
        lambda: trainer.run_epoch(epoch, steps), trainer.state.params.numel())
    print(json.dumps({"profile": {
        "model": label, "steps": steps, "step_s": step_s,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "device_kernel_ms": kernel_ms, "view_sums_ms": sums_ms,
        "view_sums_launches": sums_n,
        "view_sums_window_device_ms": traced_ms,
        "view_sums_share": sums_ms / traced_ms,
        "ported_kernels": {k[:60]: {"ms": v[0], "count": v[1]}
                           for k, v in ours.items()},
        "top": [{"kernel": k[:90], "ms": v[0], "count": v[1]}
                for k, v in rows[:20]]}}))


def _share_datasets():
    """Build each synthetic dataset once for the whole run: every
    ``Trainer`` of a recipe shares its splits (the synthetic ImageNet's
    512 images at 224x224 take seconds to draw on the host). A synthetic
    split is a pure function of its size, classes and seed, so a shared
    one hands every trainer the same batches a fresh one would."""
    from dgc_tpu_torch import train
    for name in ("CIFAR", "ImageNet"):
        setattr(train, name, functools.lru_cache(maxsize=None)(
            getattr(train, name)))


def _snapshot(trainer):
    """Everything a ``Trainer`` carries from step to step, on the CPU: the
    parameters, the optimizer state, every worker's memory (its transmit
    record included) and BatchNorm statistics, the sampling and dropout
    generators' states, and the step counts."""
    import torch
    st = trainer.state
    out = [st.params] + [v for v in st.opt_state if torch.is_tensor(v)]
    for mem, stats in zip(st.memory, st.batch_stats):
        out += [mem[k] for k in sorted(mem)] + [stats]
    return ([t.detach().cpu() for t in out]
            + [g.get_state() for g in trainer.gens]
            + [g.get_state() for g in trainer.dropout_gens or ()]
            + [torch.tensor([st.step, st.opt_state.count])])


def _check_same_state(label, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} tensors, {len(want)}")
    _check_equal(label, got, want)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_resume(label, recipe, schedule, must_launch):
    """Resume is bitwise, at full width (W=4 ``LocalComm`` on the card):
    ``schedule`` ``[(epoch a, steps), (epoch b, steps)]`` run
    uninterrupted, then again as epoch a, a save, a fresh ``Trainer``
    that restores, and epoch b. After epoch b the losses and everything
    ``_snapshot`` holds are bitwise equal, and epoch b's launches (counts
    zeroed just before it, read just after) are equal in both runs."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.checkpoint import CheckpointManager
    (ea, sa), (eb, sb) = schedule
    t_phase = time.perf_counter()

    def trainer():
        return Trainer(configs.RECIPES[recipe](), comm=LocalComm(4),
                       device=DEVICE)

    def second_epoch(t):
        torch.cuda.synchronize()
        _zero_counts()
        losses = [float(x) for x in t.run_epoch(eb, sb)]
        torch.cuda.synchronize()
        return losses, dict(_read_counts(f"{label} epoch {eb}",
                                         must_launch))

    a = trainer()
    a.run_epoch(ea, sa)
    want_losses, want_counts = second_epoch(a)
    want = _snapshot(a)
    del a
    b = trainer()
    b.run_epoch(ea, sa)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.save_checkpoint(ckpt, ea, {"acc/test_top1": 0.0})
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(Path(tmp) / f"e{ea}")
        del b
        c = trainer()
        t0 = time.perf_counter()
        restored = c.restore_checkpoint(ckpt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if restored is None or restored[0] != ea:
        raise AssertionError(f"{label}: restored {restored}")
    got_losses, got_counts = second_epoch(c)
    got = _snapshot(c)
    if got_losses != want_losses:
        raise AssertionError(f"{label}: resumed losses {got_losses}, "
                             f"uninterrupted {want_losses}")
    _check_same_state(f"{label} resumed state", got, want)
    if got_counts != want_counts:
        raise AssertionError(f"{label}: resumed launches {got_counts}, "
                             f"uninterrupted {want_counts}")
    launched = {k: v for k, v in got_counts.items() if v}
    DETAIL[f"resume {label}"] = {
        "schedule": schedule, "losses": got_losses, "launches": launched,
        "checkpoint_bytes": nbytes, "save_s": save_s,
        "restore_s": restore_s, "tensors": len(got),
        "phase_s": time.perf_counter() - t_phase}
    print(f"[resume {label}] epochs {ea} -> {eb} ({sa} + {sb} steps, W=4): "
          f"losses {got_losses} and {len(got)} state tensors bitwise the "
          f"uninterrupted run's; epoch {eb} launches equal {launched}; "
          f"checkpoint {nbytes / 1e6:.1f} MB, save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s (phase "
          f"{time.perf_counter() - t_phase:.1f} s)")
    return got_counts


def _cli(args, cwd, timeout=600):
    """``python -m <args>`` from ``cwd`` with this checkout on the path;
    its stdout. Fails on a non-zero exit."""
    import os
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    out = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode:
        raise AssertionError(f"{' '.join(args[:4])} exited "
                             f"{out.returncode}:\n{out.stderr[-4000:]}")
    return out.stdout


def _summaries(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith('{"epoch"')]


def phase_cli():
    """The CLI on the card, in subprocesses from a scratch directory.
    ``torchrun --standalone --nproc_per_node=1`` runs ``resnet20_wm5`` as
    one NCCL rank through ``parallel.multihost.initialize_multihost``: 2
    epochs of 2 steps, each saved; its losses are bitwise those of the
    in-process ``LocalComm(1)`` run with the same flags. Then
    ``--evaluate`` in a second process (no launcher: ``LocalComm(1)``,
    the same topology) restores ``best`` and prints the best epoch's
    top-1 and top-5."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    flags = ["dgc_tpu_torch.train", "--config", "resnet20_wm5"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = _cli(["torch.distributed.run", "--standalone",
                    "--nproc_per_node=1", "-m", *flags, "--epochs", "2",
                    "--steps", "2"], tmp)
        t_run = time.perf_counter() - t0
        if "[multihost] 1 processes over nccl" not in out:
            raise AssertionError(f"torchrun: no NCCL group ({out[-800:]})")
        t0 = time.perf_counter()
        evaluated = _cli(flags + ["--evaluate"], tmp)
        t_eval = time.perf_counter() - t0
    epochs = _summaries(out)
    got = [x for e in epochs for x in e["loss"]]
    trainer = Trainer(configs.resnet20_wm5(), comm=LocalComm(1),
                      device=DEVICE)
    want = [float(x) for e in (0, 1) for x in trainer.run_epoch(e, 2)]
    torch.cuda.synchronize()
    if got != want:
        raise AssertionError(f"torchrun losses {got}, LocalComm(1) {want}")
    tops = [e["eval"]["acc/test_top1"] for e in epochs]
    best = epochs[tops.index(max(tops))]
    printed = re.findall(r"^\[(acc/test_top[15])\] = (\S+)$", evaluated,
                         re.M)
    want_meters = [(k, f"{best['eval'][k]:.2f}")
                   for k in ("acc/test_top1", "acc/test_top5")]
    if (printed != want_meters
            or f"[resumed] epoch {best['epoch']}," not in evaluated):
        raise AssertionError(f"--evaluate printed {printed} "
                             f"({evaluated[-500:]}); the best epoch "
                             f"{want_meters}")
    DETAIL["cli"] = {"torchrun_loss": got, "epochs": epochs,
                     "evaluate": printed, "torchrun_s": t_run,
                     "evaluate_s": t_eval}
    print(f"[torchrun] one NCCL rank through initialize_multihost, 2 "
          f"epochs saved: losses {got} bitwise LocalComm(1)'s "
          f"({t_run:.1f} s)")
    print(f"[evaluate_cli] --evaluate restored best = epoch "
          f"{best['epoch']} and printed "
          + ", ".join(f"[{k}] = {v}" for k, v in printed)
          + f" ({t_eval:.1f} s)")


def _device_window(run):
    """``run()`` under ``torch.profiler`` (device activity only): the
    wall ms of the window, the device's busy ms (the union of its
    activity intervals) and ``{name: (ms, count)}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    if not spans:
        raise AssertionError("profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for t0_us, t1_us in sorted(spans):
        if t1_us > end:
            busy_us += t1_us - max(t0_us, end)
            end = t1_us
    return wall_ms, busy_us / 1e3, by_name


def phase_input_path(trace_inline, steps=2, traced=3):
    """The ``Trainer``'s input path on ResNet-50 (224x224, batch 32 per
    worker, W=4, epoch 5): batches from the prefetch thread, copied into
    pinned memory and uploaded on a side stream one step ahead, against
    batches made inline and uploaded from pageable memory (the earlier
    path): ``steps`` steps' losses and the whole state bitwise. Then
    ``traced`` more steps under the profiler (the inline path's too with
    ``trace_inline``): the host-to-device copies by memory kind and the
    device's busy share of the window."""
    import itertools
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.data.sampler import epoch_batches
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    t_phase = time.perf_counter()

    class Inline(Trainer):
        def epoch_inputs(self, epoch, steps=None, start=0):
            it = epoch_batches(len(self.dataset["train"]), self.global_batch,
                               epoch, seed=self.seed,
                               drop_last=self.nbps > 1)
            for idx in itertools.islice(it, start, steps):
                yield self._batches(idx)

    out = {}
    for name, cls in (("prefetch_pinned", Trainer), ("inline_pageable",
                                                     Inline)):
        t = cls(configs.resnet50_wm5(), comm=LocalComm(4), device=DEVICE)
        losses = [float(x) for x in t.run_epoch(5, steps)]
        torch.cuda.synchronize()
        out[name] = {"losses": losses, "state": _snapshot(t)}
        if cls is Trainer or trace_inline:
            step_s = []
            wall_ms, busy_ms, by_name = _device_window(
                lambda: t.run_epoch(5, traced, step_s))
            out[name].update(
                step_s=step_s, wall_ms=wall_ms, busy_share=busy_ms / wall_ms,
                h2d={k: {"ms": v[0], "count": v[1]}
                     for k, v in by_name.items()
                     if k.startswith("Memcpy HtoD")})
        del t
    a, b = out["prefetch_pinned"], out["inline_pageable"]
    if a["losses"] != b["losses"]:
        raise AssertionError(f"input path: losses {a['losses']} prefetched, "
                             f"{b['losses']} inline")
    _check_same_state("input path: prefetched vs inline state", a["state"],
                      b["state"])
    if not any("Pinned" in k for k in a["h2d"]):
        raise AssertionError(f"input path: no pinned upload in {a['h2d']}")
    for v in out.values():
        del v["state"]
    DETAIL["input_path resnet50"] = out
    print(f"[input_path] resnet50 W=4, {steps} steps: prefetched + pinned "
          f"losses {a['losses']} and state bitwise the inline batches' "
          f"(phase {time.perf_counter() - t_phase:.1f} s)")
    for name, v in out.items():
        if "h2d" not in v:
            continue
        print(f"[input_path] {name}: {traced} steps {v['step_s']} s, device "
              f"busy {v['busy_share']:.1%} of {v['wall_ms']:.1f} ms; "
              "H2D " + "; ".join(f"{k} {c['ms']:.2f} ms x{c['count']}"
                                 for k, c in v["h2d"].items()))


def phase_crop_kernel(n=512, reps=20):
    """The input pipeline's host kernel (``csrc/crop_flip_normalize.c``,
    built with gcc) on a CIFAR batch of ``n`` images, bitwise its numpy
    version; both host times (median of ``reps`` calls)."""
    import statistics
    import numpy as np
    from dgc_tpu_torch.data import native
    from dgc_tpu_torch.data.datasets import CIFAR_MEAN, CIFAR_STD
    rng = np.random.RandomState(0)
    args = (rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            rng.randint(0, 9, n), rng.randint(0, 9, n),
            rng.randint(0, 2, n).astype(np.uint8), 4, CIFAR_MEAN, CIFAR_STD)
    t0 = time.perf_counter()
    got = native.crop_flip_normalize(*args)
    first_s = time.perf_counter() - t0
    want = native.crop_flip_normalize_plain(*args)
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("crop kernel and its numpy version differ")
    ms = {}
    for name, fn in (("c", native.crop_flip_normalize),
                     ("numpy", native.crop_flip_normalize_plain)):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(ts)
    DETAIL["crop_kernel"] = {"images": n, "first_call_s": first_s, **ms}
    print(f"[crop_kernel] {n} CIFAR images: C kernel bitwise its numpy "
          f"version; host {ms['c']:.3f} ms (C, OpenMP) against "
          f"{ms['numpy']:.3f} ms (numpy), median of {reps}; first call "
          f"with the gcc build {first_s:.2f} s")


#: the device symbols of the ported kernels, as the profiler names them
#: (the candidates kernels are csrc/seg_top2.cu's CUDA symbols)
# ------------------------------------------------------------------ #
# the narrow wires and state                                         #
# ------------------------------------------------------------------ #

def phase_bf16_kernels(geoms20, geoms50):
    """The kernels that take the bf16 error-feedback state, each bitwise
    against its plain version, twice, at ResNet-50's and ResNet-20's T:
    ``compensate_bits`` and ``compensate_bits_cands`` under all four
    momentum flag combinations (infinities, NaNs and -0.0 planted in the
    state of ``compensate_bits``; ties planted in ResNet-50's segment
    buckets, which the candidates must show; the fused kernel's m and v
    also bitwise ``compensate_bits``), ``seg_top2_candidates`` on the
    stored bf16 velocity (ResNet-50's segment buckets; ResNet-20's whole
    segments) and bitwise the fused candidates; ``topk_rows`` on bf16 rows
    (one up-cast to f32 in the wrapper) at ResNet-50's 2-D buckets. Times
    beside the f32 state's at the same T, and the byte bounds: 12 B an
    element with bf16 state (g read, m and v read and written) against
    20 with f32, plus the record's T / 8 and the candidates' 2 KB a
    segment. ``geoms50`` holds epochs 4 and 5. Returns ``{kernel: {model:
    detail}}``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    dev, span = DEVICE, K.SEG_SPAN
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"compensate_bits": {}, "compensate_bits_cands": {},
           "seg_top2_candidates": {}, "topk_rows": {}}
    for model, eng in (("resnet50", geoms50[5][1]),
                       ("resnet20", geoms20[5][1])):
        T = eng.T
        nw, nseg = K.num_sent_words(T), T // span
        g = torch.randn(T, device=dev, generator=gen)
        m, v = (torch.randn(T, device=dev, generator=gen).bfloat16()
                for _ in range(2))
        ties = []
        for b, seg in zip(eng.buckets, eng._seg):
            if seg:
                ties += _plant_ties(g, m, v, b.base, span)
        sent = torch.randperm(T, device=dev, generator=gen)[:T // 1000]
        bits = K.pack_sent_bits(sent.int(), T)
        specials = m.clone()
        specials[-8:] = torch.tensor([math.nan, math.inf, -math.inf, -0.0,
                                      0.0, 1.0, -1.0, 3.0], device=dev)
        errs = {k: [] for k in out}
        for flags in _MOMENTUM_FLAGS:
            args = (0.9, *flags)
            want = K.compensate_bits_plain(g, specials, v, bits, *args)
            errs["compensate_bits"].append(_check_twice(
                f"compensate_bits bf16 {model} {flags}",
                lambda: K.compensate_bits(g, specials.clone(), v.clone(),
                                          bits, *args), want))
            want = K.compensate_bits_cands_plain(g, m, v, bits, *args)
            errs["compensate_bits_cands"].append(_check_twice(
                f"compensate_bits_cands bf16 {model} {flags}",
                lambda: K.compensate_bits_cands(g, m.clone(), v.clone(),
                                                bits, *args), want))
            _check_equal(f"compensate_bits vs cands bf16 {model} {flags}",
                         K.compensate_bits(g, m.clone(), v.clone(), bits,
                                           *args), want[:2])
        for seg, lane, blocks, vals in ties:    # the default flags' result
            if (tuple(want[3][seg, :, lane].tolist()) != blocks
                    or tuple(want[2][seg, :, lane].tolist()) != vals):
                raise AssertionError(f"bf16 tie at {model} segment {seg}")
        vec = want[1]
        if vec.dtype != torch.bfloat16:
            raise AssertionError("compensate_bits_cands: state not bf16")
        regions = ([(b.base, b.rows, b.cols) for b, seg
                    in zip(eng.buckets, eng._seg) if seg]
                   or [(0, 1, nseg * span)])
        for base, R, cols in regions:
            ns = cols // span
            alone = K.seg_top2_candidates_plain(vec, base, R, cols)
            errs["seg_top2_candidates"].append(_check_twice(
                f"seg_top2_candidates bf16 {model} [{R}, {cols}]",
                lambda: K.seg_top2_candidates(vec, base, R, cols), alone))
            s0 = base // span
            _check_equal("bf16 seg_top2_candidates vs the fused ones", alone,
                         (want[2][s0:s0 + R * ns].reshape(R, -1),
                          K.seg_cols_local(want[3][s0:s0 + R * ns].view(
                              R, ns, 2, 128))))
        del want
        mm, vv = m.clone(), v.clone()
        mf, vf = m.float(), v.float()
        rec = 4 * nw
        for name, per, extra, kern, plain in (
                ("compensate_bits", 12, 0, K.compensate_bits,
                 K.compensate_bits_plain),
                ("compensate_bits_cands", 12, 2048 * nseg,
                 K.compensate_bits_cands, K.compensate_bits_cands_plain)):
            bound = _bound(per * T + rec + extra, (5 + 4 * bool(extra)) * T)
            out[name][model] = dict(
                shape=[T], state="bfloat16", max_abs_err=max(errs[name]),
                ms=_device_ms(lambda: kern(g, mm, vv, bits, 0.9)),
                plain_ms=_device_ms(lambda: plain(g, m, v, bits, 0.9)),
                f32_ms=_device_ms(lambda: kern(g, mf, vf, bits, 0.9)),
                bound_ms=bound[0], bound_by=bound[1],
                f32_bound_ms=_bound(20 * T + rec + extra, 9 * T)[0])
        base, R, cols = regions[0]
        nb = R * cols
        ns = cols // span
        vf = vec.float()
        out["seg_top2_candidates"][model] = dict(
            shape=[R, cols], state="bfloat16",
            max_abs_err=max(errs["seg_top2_candidates"]),
            ms=_device_ms(lambda: K.seg_top2_candidates(vec, base, R, cols)),
            plain_ms=_device_ms(lambda: K.seg_top2_candidates_plain(
                vec, base, R, cols)),
            f32_ms=_device_ms(lambda: K.seg_top2_candidates(vf, base, R,
                                                            cols)),
            bound_ms=_bound(2 * nb + 2048 * R * ns, 4 * nb)[0],
            bound_by="bytes", f32_bound_ms=_bound(4 * nb + 2048 * R * ns,
                                                  4 * nb)[0])
        for name, d in out.items():
            if model in d:
                print(f"[bf16] {name} {model} {d[model]['shape']}: bitwise "
                      f"twice, {d[model]['ms']:.5f} ms (f32 state "
                      f"{d[model]['f32_ms']:.5f}; bound "
                      f"{d[model]['bound_ms']:.5f}, f32 "
                      f"{d[model]['f32_bound_ms']:.5f}; plain "
                      f"{d[model]['plain_ms']:.5f})")
        del g, m, v, mm, vv, mf, vf, specials, vec
    # topk_rows on bf16 rows: ResNet-50's buckets at the epoch-4 ratio (all
    # on the 2-D path, the bf16 path's topk calls of that epoch)
    eng = geoms50[4][1]
    calls = []
    for b, seg in zip(eng.buckets, eng._seg):
        if seg or b.max_sel > K.TOPK_MAX_K:
            continue
        x = torch.randn(b.rows, b.cols, device=dev,
                        generator=gen).abs().bfloat16()
        calls.append(dict(shape=[b.rows, b.cols], k=b.max_sel,
                          max_abs_err=_check_twice(
                              f"topk_rows bf16 [{b.rows}, {b.cols}]",
                              lambda: K.topk_rows(x, b.max_sel),
                              K.topk_rows_plain(x, b.max_sel))))
    out["topk_rows"]["resnet50"] = calls
    print(f"[bf16] topk_rows on bf16 rows at {len(calls)} ResNet-50 "
          "epoch-4 buckets: bitwise twice")
    DETAIL["bf16 kernels"] = out
    torch.cuda.empty_cache()
    return out


#: the wire regimes of the card == CPU check (the reference's but its
#: gossip ones, which ride the fp32 wire and are held by
#: :func:`phase_gossip_path`), then the mixed plans over ResNet-20's two
#: buckets
_WIRE_REGIMES = ("dense", "fp32", "fp32_packed", "fp16", "fp16_packed",
                 "int8", "int8_packed", "int4_packed", "int8_delta_idx")
_WIRE_MIXED = (("int8_delta_idx", "fp16_packed"), ("dense", "int4_packed"),
               ("int8", "fp32_packed"))


def phase_wires_vs_cpu():
    """ResNet-20's W=4 exchange, card against CPU, bitwise (every worker's
    exchanged gradient, memory and transmit record; 2 steps), at the
    epoch-0 and epoch-5 ratios, for every wire regime as a uniform plan,
    the mixed plans, int8 without error feedback, the int64 index wire
    and the bf16 state on the int8 wire with packed indices. Returns
    ``{regime: wire_bytes_per_worker}`` at the epoch-5 ratio (and
    epoch 0's under ``"epoch 0"``)."""
    cases = [(r, r, {}) for r in _WIRE_REGIMES]
    cases += [("+".join(m), m, {}) for m in _WIRE_MIXED]
    cases += [("int8 no feedback", "int8", dict(int8_error_feedback=False)),
              ("int64 indices", "fp32", dict(int32_indices=False)),
              ("int8_packed int64", "int8_packed",
               dict(int32_indices=False)),
              ("bf16 state int8_packed", "int8_packed",
               dict(mem_dtype="bfloat16")),
              ("bf16 state fp32", "fp32", dict(mem_dtype="bfloat16"))]
    bytes_by = {"epoch 0": {}, "epoch 5": {}}
    t0 = time.perf_counter()
    for label, plan, flags in cases:
        geoms = _geometries("resnet20_wm5", (0, 5), plan=plan, **flags)
        for epoch, (_, eng) in geoms.items():
            _check_equal(f"wire {label} exchange (epoch {epoch})",
                         _exchange_run(eng, DEVICE, 2),
                         _exchange_run(eng, "cpu", 2))
            bytes_by[f"epoch {epoch}"][label] = eng.wire_bytes_per_worker()
    DETAIL["wire bytes per worker"] = bytes_by
    print(f"[wires] resnet20 W=4 exchange, 2 steps, epochs 0 and 5: card "
          f"== CPU bitwise for {[c[0] for c in cases]} "
          f"({time.perf_counter() - t0:.1f} s)")
    for epoch, d in bytes_by.items():
        print(f"[wires] wire_bytes_per_worker at {epoch}: {d}")
    return bytes_by


_KERNEL_SYMBOLS = ("compensate_bits_kernel", "compensate_bits_cands_kernel",
                   "seg_top2_kernel", "topk_rows_kernel", "apply_rows_",
                   "opaque_copy_kernel", "select_pack_rows_kernel",
                   "dgc_forward_rows_kernel", "compensate_multi_kernel",
                   "ladder_counts_kernel")

#: the path whose count is a kernel's ``launches`` where it is not the
#: ResNet-50 default path (which binds no ``opaque_view`` and launches
#: neither the standalone candidates, the fused routes' kernels, the
#: per-tensor path's compensate nor the non-resample adaptation's ladder
#: counts; no training path launches the count-masked compensate, which
#: the reference keeps as a tested building block: its check is its path)
_OWN_PATH = {"opaque_view": "resnet20",
             "seg_top2_candidates": "resnet50_megakernel",
             "select_pack_rows": "resnet20_fused_select",
             "dgc_forward_rows": "resnet20_megakernel",
             "fused_compensate": "resnet20_per_tensor",
             "fused_compensate_masked": "masked_check",
             "ladder_counts": "resnet20_nonresample"}


# ------------------------------------------------------------------ #
# the resilience slice: guards, checksum, faults, preemption, elastic #
# restarts, two tiers and Adasum                                      #
# ------------------------------------------------------------------ #

#: the engine fault drills of the resilient path, by epoch: a bitflip
#: after the gather, and a negative (epoch 4) or out-of-range (epoch 5)
#: gathered index before the clamp
_ENGINE_FAULTS = {4: "bitflip:elem=0:bit=18,badidx:elem=3:set=-5",
                  5: "bitflip:elem=0:bit=18,badidx:elem=7:set=2000000000"}
#: the resilient path's step that is poisoned (``TrainState.step``)
_NAN_STEP = 2


class _faults_armed:
    """``DGC_FAULTS=spec`` inside the block (the engines and trainers read
    it when they are built); restored after."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        import os
        self.prev = os.environ.get("DGC_FAULTS")
        if self.spec:
            os.environ["DGC_FAULTS"] = self.spec
        else:
            os.environ.pop("DGC_FAULTS", None)

    def __exit__(self, *exc):
        import os
        if self.prev is None:
            os.environ.pop("DGC_FAULTS", None)
        else:
            os.environ["DGC_FAULTS"] = self.prev
        return False


def _recording_comm(world):
    """A ``LocalComm`` of ``world`` workers counting its collectives (and
    its two tiers' groups'): the analysis layer's recording Comm."""
    from dgc_tpu_torch.analysis.program import RecordingComm
    from dgc_tpu_torch.parallel.comm import LocalComm
    return RecordingComm(LocalComm(world))


def _exchange_health(eng, dev, world=4, nan=False, local_size=1, op=None):
    """One exchange of ``eng`` among ``world`` workers on ``dev`` from
    seeded inputs, with ``health`` (the checksum count), two tiers of
    ``local_size`` and the combine ``op``: the outputs, memories and count
    on the CPU. ``nan``: every gradient NaN (the ``nan@K`` drill)."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    mems = [eng.init_memory(dev) for _ in range(world)]
    grads = [torch.randn(eng.layout.total,
                         generator=torch.Generator().manual_seed(300 + w))
             .to(dev) for w in range(world)]
    if nan:
        grads = [torch.full_like(g, float("nan")) for g in grads]
    phases = [eng.draw_phases(torch.Generator().manual_seed(30 + w))
              for w in range(world)]
    comm, kw = LocalComm(world), {}
    if local_size > 1:
        kw["local_comm"], comm = comm.split(local_size)
    if op is not None:
        kw["op"] = op
    health = {} if eng.checksum else None
    if health is not None:
        kw["health"] = health
    outs = eng.exchange(grads, mems, phases, comm, **kw)
    res = [t.cpu() for t in outs + [t for m in mems for t in m.values()]]
    return res, (None if health is None
                 else float(health["checksum_failures"]))


def phase_guard_vs_cpu():
    """ResNet-50's checksummed engine (``resnet50_wm5_resilience``), W=4, at
    the epoch-4 (2-D) and epoch-5 (segment) ratios with each epoch's
    engine fault drill armed: card == CPU bitwise, the mismatch counts
    equal (returned by epoch: the resilient path's expected count a step).
    Then all-NaN gradients (the ``nan@K`` step) through the compensate,
    selection and apply kernels at full width: no fault, every payload
    index in [0, T) or the sentinel. And the
    costs the resilient step adds: the guard snapshot and the revert over
    a ResNet-50 W=4 state, the checksum and the count of one worker."""
    import torch
    from dgc_tpu_torch.resilience import guard, integrity
    counts, nan_idx = {}, {}
    for epoch, spec in _ENGINE_FAULTS.items():
        with _faults_armed(spec):
            eng = _geometries("resnet50_wm5_resilience", (epoch,),
                              checksum=True)[epoch][1]
            if not eng.checksum or eng._faults is None:
                raise AssertionError("resilient engine without its drill")
            got, cg = _exchange_health(eng, DEVICE)
            want, cw = _exchange_health(eng, "cpu")
        _check_equal(f"resilient exchange (epoch {epoch}, {spec})", got,
                     want)
        if cg != cw or not cg >= 1:
            raise AssertionError(f"epoch {epoch}: checksum count {cg} on the "
                                 f"card, {cw} on the CPU")
        counts[epoch] = cg
        with _faults_armed(None):
            eng = _geometries("resnet50_wm5_resilience", (epoch,),
                              checksum=True)[epoch][1]
            # what a NaN step selects is thrown away by the revert: the
            # exchange must only run without a fault (the order the
            # selections give NaNs is the kernels', not compared)
            _exchange_health(eng, DEVICE, nan=True)
            mem = eng.init_memory(DEVICE)
            g = torch.full((eng.layout.total,), float("nan"), device=DEVICE)
            _, idx = eng.compress(g, mem, eng.draw_phases(
                torch.Generator().manual_seed(1)))
            torch.cuda.synchronize()
            S, T = eng.layout.sentinel, eng.T
            bad = int(((idx < 0) | (idx >= T)).sum())
            if bad:
                raise AssertionError(f"NaN step: {bad} indices out of range")
            nan_idx[epoch] = {"payload": int(idx.numel()),
                              "on_sentinel": int((idx == S).sum())}
    # the costs: a resilient W=4 state's snapshot and revert, and one
    # worker's checksum and count at the epoch-5 payload
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression.flat import ParamLayout
    from dgc_tpu_torch.models import from_config, stats_tree
    eng = _geometries("resnet50_wm5_resilience", (5,), checksum=True)[5][1]
    n_stats = ParamLayout(stats_tree(from_config(
        configs.resnet50_wm5().model, torch.Generator()))).total
    mems = [eng.init_memory(DEVICE) for _ in range(4)]
    stats = [torch.zeros(n_stats, device=DEVICE) for _ in range(4)]
    params = torch.zeros(eng.layout.total, device=DEVICE)
    skip = torch.tensor(False, device=DEVICE)

    def snap_and_select():
        m0, s0 = guard.snapshot(mems), guard.snapshot(stats)
        guard.tree_select(skip, params, params)
        guard.tree_select(skip, m0, mems)
        guard.tree_select(skip, s0, stats)
    vals = torch.randn(eng.payload_size, device=DEVICE)
    idx = torch.randint(0, eng.T, (eng.payload_size,), device=DEVICE,
                        dtype=torch.int32)
    seg = torch.as_tensor(eng._seg_ids, device=DEVICE)
    chk = integrity.payload_checksum(vals, idx, seg, eng._num_seg)
    gv, gi, gc = (torch.stack([x] * 4) for x in (vals, idx, chk))
    times = {"snapshot_and_revert_ms": _device_ms(snap_and_select, reps=5),
             "checksum_ms": _device_ms(lambda: integrity.payload_checksum(
                 vals, idx, seg, eng._num_seg)),
             "count_mismatches_ms": _device_ms(
                 lambda: integrity.count_mismatches(gv, gi, gc, seg,
                                                    eng._num_seg))}
    state_bytes = sum(t.numel() * t.element_size() for m in mems
                      for t in m.values()) + 4 * n_stats * 4
    DETAIL["guard_vs_cpu"] = {"counts": counts, "nan_indices": nan_idx,
                              "snapshot_bytes": state_bytes, **times}
    print(f"[guard] resnet50 W=4 checksummed exchange, faults armed: card == "
          f"CPU bitwise, mismatch counts {counts} (epoch: count); NaN "
          f"gradients through the kernels: no fault, indices in range or "
          f"on the sentinel {nan_idx}; snapshot + revert of "
          f"{state_bytes / 1e6:.1f} MB {times['snapshot_and_revert_ms']:.3f}"
          f" ms, checksum {times['checksum_ms']:.4f} ms and count "
          f"{times['count_mismatches_ms']:.4f} ms a worker "
          f"(payload {eng.payload_size})")
    return counts


def _state_snapshot(trainer):
    """The resilient path's revertible state on the CPU (the optimizer's
    count read after the pending verdict)."""
    import torch
    from dgc_tpu_torch.training.step import resolve_pending_skip
    st = resolve_pending_skip(trainer.state)
    out = [st.params, st.opt_state.momentum_buffer]
    for mem, stats in zip(st.memory, st.batch_stats):
        out += [mem[k] for k in sorted(mem)] + [stats]
    return ([t.detach().to("cpu", copy=True) for t in out if t is not None]
            + [torch.tensor([st.opt_state.count])])


def phase_resilient_path(counts_cpu):
    """The slice's main path, ``resnet50_wm5_resilience`` (the guards, the
    checksum, the watchdog's and flight recorder's recipe) at full width,
    224x224, batch 32 a worker, W=4 on the card: 1 step at epoch 4 and 3
    at epoch 5, ``nan@2`` (the second epoch-5 step) with each epoch's
    engine drill (``_ENGINE_FAULTS``). The skipped step's state bitwise
    its pre-step state; the counters 1 skipped, 1 non-finite, and the
    checksum's the CPU's counts (``counts_cpu``, by epoch) a step; every
    epoch's launches and the collectives the unguarded ``resnet50_wm5``
    path's (same schedule, no fault). Returns the path's counts."""
    import torch
    schedule = [(4, 1), (5, 3)]
    must = ["topk_rows", "apply_rows", "opaque_view_from"]
    rules = {4: (("compensate_bits",), ("compensate_bits_cands",)),
             5: (("compensate_bits_cands",), ("compensate_bits",))}
    plain_comm = _recording_comm(4)
    with _faults_armed(None):
        _, _ = phase_train_path("resnet50_unguarded", "resnet50_wm5",
                                schedule, must, epoch_rules=rules,
                                comm=plain_comm)
    snaps, seen = [], []

    def on_step(batch, metrics):
        seen.append({"step": metrics["step"],
                     "guards": {k: float(v)
                                for k, v in metrics["guards"].items()}})
        snaps.append(_state_snapshot(trainer))
        del snaps[:-2]
        if metrics["step"] == _NAN_STEP:
            _check_same_state("resilient: the skipped step's state",
                              snaps[-1], snaps[-2])

    import os
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.train import Trainer
    comm = _recording_comm(4)
    label = "resnet50_resilience"
    per_epoch, times = {}, {}
    try:
        for epoch, steps in schedule:
            # the trainer reads nan@K once; each epoch's engine its drill
            os.environ["DGC_FAULTS"] = (f"nan@{_NAN_STEP},"
                                        + _ENGINE_FAULTS[epoch])
            if epoch == schedule[0][0]:
                trainer = Trainer(configs.resnet50_wm5_resilience(),
                                  comm=comm, device=DEVICE)
            t = []
            torch.cuda.synchronize()
            _zero_counts()
            trainer.run_epoch(epoch, steps, t, on_step=on_step)
            torch.cuda.synchronize()
            per_epoch[epoch] = _read_counts(f"{label} epoch {epoch}",
                                            rules[epoch][0])
            times[epoch] = t
    finally:
        os.environ.pop("DGC_FAULTS", None)
    want_launch = DETAIL["launches resnet50_unguarded by epoch"]
    for epoch in per_epoch:
        if per_epoch[epoch] != want_launch[epoch]:
            raise AssertionError(f"{label} epoch {epoch}: launches "
                                 f"{per_epoch[epoch]}, unguarded "
                                 f"{want_launch[epoch]}")
    if comm.calls != plain_comm.calls:
        raise AssertionError(f"{label}: collectives {comm.calls}, unguarded "
                             f"{plain_comm.calls}")
    g = seen[-1]["guards"]
    want_chk = sum(counts_cpu[e] * s for e, s in schedule)
    if (g["skipped_steps"] != 1.0 or g["nonfinite_rate"] != 0.25
            or g["checksum_failures"] != want_chk):
        raise AssertionError(f"{label}: guard counters {g}, want 1 skipped, "
                             f"rate 0.25, {want_chk} checksum failures")
    if not bool(torch.isfinite(trainer.state.params).all()):
        raise AssertionError(f"{label}: non-finite parameters")
    counts = {k: sum(c[k] for c in per_epoch.values())
              for k in per_epoch[4]}
    DETAIL[f"launches {label} by epoch"] = per_epoch
    DETAIL[label] = {"guards": seen, "collectives": comm.calls,
                     "step_s": times,
                     "unguarded_step_s": DETAIL["step_s resnet50_unguarded"]}
    print(f"[{label}] W=4, epochs 4 (1 step) and 5 (3 steps), nan@"
          f"{_NAN_STEP} + {_ENGINE_FAULTS}: the skipped step bitwise a "
          f"no-op, guards {g}; launches by epoch equal the unguarded path's "
          f"({per_epoch}); collectives {comm.calls} equal; step_s {times} "
          f"(unguarded {DETAIL['step_s resnet50_unguarded']})")
    return counts


def _cli_run(args, cwd, env=None, timeout=900):
    """``python -m <args>`` from ``cwd`` with this checkout on the path:
    ``(exit code, stdout)``."""
    import os
    e = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    e.pop("DGC_FAULTS", None)
    e.update(env or {})
    out = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=e,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr[-3000:]


def _epoch_files(run, epoch):
    import torch
    d = Path(run) / "checkpoints" / f"e{epoch}"
    return {f.name: torch.load(f, weights_only=True)
            for f in sorted(d.glob("*.pt"))}


def _uninterrupted(recipe, args, path):
    """The CLI's run of ``args`` (``--epochs 1``, ``--steps``,
    ``--synthetic-size``) on a ``Trainer`` at W=4, epoch 0 saved under
    ``path`` as the CLI saves it: its losses."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.checkpoint import CheckpointManager
    opts = dict(zip(args[::2], args[1::2]))
    if opts.get("--epochs") != "1":
        raise AssertionError(f"the drill runs one epoch, not {args}")
    cfg = configs.RECIPES[recipe]()
    if "--synthetic-size" in opts:
        cfg.dataset.synthetic_size = int(opts["--synthetic-size"])
    t = Trainer(cfg, comm=LocalComm(4), device=DEVICE)
    losses = [float(x) for x in t.run_epoch(0, int(opts["--steps"]))]
    torch.cuda.synchronize()
    t.save_checkpoint(CheckpointManager(str(path / "checkpoints")), 0,
                      {"acc/test_top1": 0.0})
    return losses


def phase_preempt_drill(recipe, label, args, kill):
    """The preemption drill through the CLI, in subprocesses from a scratch
    directory: the uninterrupted run (in this process,
    :func:`_uninterrupted`), then ``DGC_FAULTS=kill@<kill>`` (exit
    75, the emergency checkpoint of the epoch in progress with
    ``preempt_batch``), then the same command again (the mid-epoch resume
    at the next batch): its losses and the final checkpoint's every tensor
    bitwise the uninterrupted run's. ``kill@K`` fires after the K-th step,
    so the run stops before batch K (``preempt_batch`` K - 1)."""
    import torch
    stop_batch = kill - 1
    flags = ["dgc_tpu_torch.train", "--config", recipe, "--world", "4",
             *args]
    with tempfile.TemporaryDirectory() as tmp:
        # the uninterrupted run in this process (the CLI's flags on a
        # Trainer: a CLI run is bitwise one, phase_cli), saved as the CLI
        # saves the epoch
        t0 = time.perf_counter()
        full_run = Path(tmp, "uninterrupted")
        want = _uninterrupted(recipe, args, full_run)
        t_full = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc, killed = _cli_run(flags, tmp, {"DGC_FAULTS": f"kill@{kill}"})
        t_kill = time.perf_counter() - t0
        want_line = f"stopping at epoch 0, batch {stop_batch}"
        if rc != 75 or want_line not in killed:
            raise AssertionError(f"{label}: kill@{kill} exited {rc}, want 75 "
                                 f"and '{want_line}':\n{killed[-3000:]}")
        save_s = float(re.search(r"emergency checkpoint -> \S+ \(([\d.]+) s\)",
                                 killed).group(1))
        t0 = time.perf_counter()
        rc, resumed = _cli_run(flags, tmp)
        t_resume = time.perf_counter() - t0
        if rc or f"[resumed] mid-epoch 0 at batch {stop_batch + 1}" not in \
                resumed:
            raise AssertionError(f"{label}: resume exited {rc}:\n"
                                 f"{resumed[-3000:]}")
        (run,) = Path(tmp, "runs").iterdir()
        a, b = _epoch_files(run, 0), _epoch_files(full_run, 0)
        if set(a) != set(b):
            raise AssertionError(f"{label}: files {sorted(a)}, {sorted(b)}")
        n = 0
        for f in a:
            if set(a[f]) != set(b[f]):
                raise AssertionError(f"{label}: {f} keys differ")
            for k in a[f]:
                n += 1
                if not torch.equal(a[f][k], b[f][k]):
                    raise AssertionError(f"{label}: resumed {f}:{k} differs "
                                         "from the uninterrupted run's")
    got = [x for s in _summaries(killed) for x in s["loss"]] + [
        x for s in _summaries(resumed) for x in s["loss"]]
    if got != want:
        raise AssertionError(f"{label}: killed + resumed losses {got}, "
                             f"uninterrupted {want}")
    DETAIL[f"preempt {label}"] = {
        "losses": got, "tensors": n, "emergency_save_s": save_s,
        "uninterrupted_s": t_full, "killed_s": t_kill, "resumed_s": t_resume}
    print(f"[preempt {label}] kill@{kill} -> exit 75 (emergency save "
          f"{save_s:.2f} s) -> resume at batch {stop_batch + 1}: losses "
          f"{got} and {n} checkpoint tensors bitwise the uninterrupted run's "
          f"(processes {t_full:.1f} / {t_kill:.1f} / {t_resume:.1f} s)")


def _total_mass(trainer):
    """Every worker's error-feedback mass, pending records folded (and a
    gossip inbox in flight), summed in float64 on the card."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    T = trainer.setup.engine.T
    mask = trainer.compression.memory.momentum_masking
    total = torch.zeros((), dtype=torch.float64, device=DEVICE)
    for mem in trainer.state.memory:
        keep = K.keep_from_bits(mem["sent_bits"], T)
        total += (mem["velocities_c"] * keep).double().sum()
        total += (mem["momentums_c"] * (keep if mask else 1)).double().sum()
        total += mem["momentums_d"].double().sum()
        total += mem["velocities_d"].double().sum()
        if "gossip_inbox" in mem:
            total += mem["gossip_inbox"].double().sum()
    return float(total)


def phase_elastic():
    """The elastic restore at ResNet-50's geometry (``resnet50_wm5``, full
    width, W=4 on the card, epoch 5): 4 workers train a step and save; 2
    restore with ``elastic=True`` (a merge, ``num_batches_per_step`` 2
    keeping the global batch), the total error-feedback mass conserved,
    train a step and save; 4 restore that (a split) and 3 restore the
    first (a collapse), each conserving the mass and training on. The
    restores' seconds."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.checkpoint import CheckpointManager

    def trainer(world, nbps=1):
        cfg = configs.resnet50_wm5()
        cfg.train.num_batches_per_step = nbps
        return Trainer(cfg, comm=LocalComm(world), device=DEVICE)

    def restore(t, ckpt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = t.restore_checkpoint(ckpt, elastic=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        c4, c2 = (CheckpointManager(str(Path(tmp) / n)) for n in ("a", "b"))
        a = trainer(4)
        a.run_epoch(5, 1)
        a.save_checkpoint(c4, 5, {"acc/test_top1": 0.0})
        mass4 = _total_mass(a)
        del a
        for label, (world, nbps, src, epoch) in (
                ("4->2 merge", (2, 2, c4, 5)), ("2->4 split", (4, 1, c2, 6)),
                ("4->3 collapse", (3, 1, c4, 5))):
            t = trainer(world, nbps)
            (ep, meters), secs = restore(t, src)
            if ep != epoch or "_elastic" not in meters:
                raise AssertionError(f"elastic {label}: restored {ep}, "
                                     f"{meters}")
            before = mass4 if src is c4 else res["4->2 merge"]["mass_after"]
            mass = _total_mass(t)
            if not math.isclose(mass, before, rel_tol=1e-6):
                raise AssertionError(f"elastic {label}: mass {mass}, saved "
                                     f"{before}")
            losses = [float(x) for x in t.run_epoch(epoch + 1, 1)]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"elastic {label}: losses {losses}")
            res[label] = {"restore_s": secs, "mass_before": before,
                          "mass_restored": mass, "losses": losses,
                          "mass_after": _total_mass(t)}
            if label == "4->2 merge":
                t.save_checkpoint(c2, 6, {"acc/test_top1": 0.0})
            del t
    DETAIL["elastic"] = res
    print("[elastic] resnet50 W=4 epoch 5: " + "; ".join(
        f"{k}: mass {v['mass_restored']:.9g} (saved {v['mass_before']:.9g}), "
        f"restore {v['restore_s']:.2f} s, then loss {v['losses']}"
        for k, v in res.items()))


def phase_twotier_adasum_vs_cpu():
    """The two-tier exchange (``LocalComm(4).split(2)``: 2 nodes x 2) card
    == CPU bitwise at ResNet-20's epoch-0 and epoch-5 ratios and
    ResNet-50's epoch 5; the Adasum exchange (``op="adasum"``) at W=4
    (recursive doubling over ``Comm.swap``) and W=3 (the gathered
    reduce) at ResNet-20's epochs 0 and 5 card == CPU within rtol 1e-5
    (the dot products are reductions in another order; integer outputs
    equal)."""
    geoms = _geometries("resnet20_wm5", (0, 5))
    for epoch, (_, eng) in geoms.items():
        _check_equal(f"two-tier exchange resnet20 (epoch {epoch})",
                     _exchange_health(eng, DEVICE, local_size=2)[0],
                     _exchange_health(eng, "cpu", local_size=2)[0])
    eng = _geometries("resnet50_wm5", (5,))[5][1]
    _check_equal("two-tier exchange resnet50 (epoch 5)",
                 _exchange_health(eng, DEVICE, local_size=2)[0],
                 _exchange_health(eng, "cpu", local_size=2)[0])
    worst = {}
    for world in (4, 3):
        for epoch, (_, eng) in geoms.items():
            worst[f"W={world} epoch {epoch}"] = _check_close(
                f"Adasum exchange W={world} (epoch {epoch})",
                _exchange_health(eng, DEVICE, world=world, op="adasum")[0],
                _exchange_health(eng, "cpu", world=world, op="adasum")[0],
                rtol=1e-5, atol=1e-7)
    DETAIL["adasum_vs_cpu_max_abs"] = worst
    print("[twotier] 2 nodes x 2: card == CPU bitwise (resnet20 epochs 0 "
          "and 5, resnet50 epoch 5); [adasum] W=4 and W=3 card == CPU "
          f"within rtol 1e-5 (max abs {worst})")


def phase_process_group():
    import torch
    import torch.distributed as dist
    from dgc_tpu_torch.parallel.comm import ProcessGroupComm
    from dgc_tpu_torch.train import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                world_size=1, rank=0)
        try:
            trainer = Trainer(comm=ProcessGroupComm(), device=DEVICE)
            loss = [float(x) for x in trainer.run_epoch(5, 1)]
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    if not all(math.isfinite(x) for x in loss):
        raise AssertionError(f"ProcessGroupComm step loss {loss}")
    print(f"[pg] one NCCL rank, one step: loss {loss}")


# ------------------------------------------------------------------ #
# the telemetry slice: step taps, the sink, phase attribution, the    #
# fleet gather and the straggler-adaptive exchange                    #
# ------------------------------------------------------------------ #

#: the step stats the card and the CPU give bitwise (counts and minima);
#: the norms and masses sum [T] elements, in another order on each
_EXACT_STATS = ("payload_elems", "selected_frac", "threshold", "wire_bytes",
                "clip_delta")
#: device kernel name -> the phase its launches must land in
_PHASE_OF = (("compensate_bits_cands_kernel", "compensate"),
             ("compensate_bits_kernel", "compensate"),
             ("topk_rows_kernel", "select"), ("apply_rows_", "apply"))
#: the adaptive path's clocks, step by step: step 2 skewed
_CLOCKS = ([200.0] * 4, [200.0, 200.0, 200.0, 350.0], [200.0] * 4,
           [200.0] * 4)


def _exchange_stats(eng, dev, steps=1, world=4, send_frac=None):
    """``steps`` telemetry exchanges of ``eng`` among ``world`` workers on
    ``dev`` from seeded inputs (``send_frac``: each worker's fraction):
    ``(outputs and final memories, [per step, per worker stats])`` on the
    CPU."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    mems = [eng.init_memory(dev) for _ in range(world)]
    res, stats = [], []
    frac = (None if send_frac is None else
            [torch.tensor(f, device=dev) for f in send_frac])
    for step in range(steps):
        grads = [torch.randn(eng.layout.total,
                             generator=torch.Generator().manual_seed(
                                 700 + 100 * step + w)).to(dev)
                 for w in range(world)]
        phases = [eng.draw_phases(torch.Generator().manual_seed(
            70 + 10 * step + w)) for w in range(world)]
        outs, st = eng.exchange(grads, mems, phases, LocalComm(world),
                                telemetry=True, send_frac=frac)
        res += outs
        stats.append([{k: v.cpu() for k, v in s.items()} for s in st])
    res += [t for m in mems for t in m.values()]
    return [t.cpu() for t in res], stats


def _check_stats(label, got, want):
    """The per-step, per-worker stats of the card against the CPU's:
    :data:`_EXACT_STATS` bitwise, the norms within rtol 1e-5 (torch's
    CUDA sum reduces a [T] vector as a tree of blocks, its CPU sum in
    vectorized runs: another order). Returns the worst relative
    difference of the norms."""
    import torch
    worst = 0.0
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            for k in w:
                if k in _EXACT_STATS:
                    _check_equal(f"{label} {k}", [g[k]], [w[k]])
                    continue
                if not torch.allclose(g[k], w[k], rtol=1e-5, atol=0):
                    raise AssertionError(f"{label} {k}: card {g[k]}, CPU "
                                         f"{w[k]} (rtol 1e-5)")
                rel = float(((g[k] - w[k]).abs()
                             / w[k].abs().clamp(min=1e-30)).max())
                worst = max(worst, rel)
    return worst


def phase_telemetry_vs_cpu():
    """The engine's step stats (``exchange(..., telemetry=True)``), W=4,
    card against CPU on one input: ResNet-50 at the epoch-4 (2-D) and
    epoch-5 (segment) ratios and ResNet-20 with the bf16 state and the
    int8 wire's error feedback, 2 steps: every output and memory bitwise,
    the stats as :func:`_check_stats` holds them."""
    cases = [(f"resnet50 epoch {e}", eng) for e, (_, eng) in
             _geometries("resnet50_wm5", (4, 5)).items()]
    cases.append(("resnet20 bf16 int8-ef epoch 5", _geometries(
        "resnet20_wm5", (5,), mem_dtype="bfloat16", int8_values=True,
        int8_error_feedback=True)[5][1]))
    worst, seen = {}, {}
    for label, eng in cases:
        steps = 1 if label.startswith("resnet50") else 2
        got, gst = _exchange_stats(eng, DEVICE, steps)
        want, wst = _exchange_stats(eng, "cpu", steps)
        _check_equal(f"telemetry exchange {label}", got, want)
        worst[label] = _check_stats(f"stats {label}", gst, wst)
        seen[label] = {k: v.tolist() for k, v in gst[-1][0].items()}
    DETAIL["telemetry_vs_cpu"] = {"norm_rel_diff": worst, "stats": seen}
    print(f"[telemetry] W=4 step stats card == CPU: counts, fractions, "
          f"thresholds, wire bytes bitwise; norms within rtol 1e-5 (worst "
          f"{worst})")


def _sync_calls(trainer, epoch, steps, on_step=None):
    """``steps`` steps of ``trainer`` at ``epoch`` (``on_step`` after each)
    under the profiler: the synchronising calls its main thread made, by
    name (the analysis layer's ``max_syncs`` reading)."""
    from dgc_tpu_torch.analysis.program import sync_calls
    return sync_calls(lambda: trainer.run_epoch(epoch, steps,
                                                on_step=on_step))


def _attributed_window(trainer, schedule):
    """The ``schedule``'s steps of ``trainer`` under the profiler with the
    phase markers on: ``(phase table, {kernel prefix: (events, phases
    seen)})`` over the window's device events."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dgc_tpu_torch.telemetry import attrib, trace
    prev = trace.enable(True)
    torch.cuda.synchronize()
    try:
        with tempfile.TemporaryDirectory() as d:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for epoch, steps in schedule:
                    trainer.run_epoch(epoch, steps)
                torch.cuda.synchronize()
            path = os.path.join(d, "t.json")
            prof.export_chrome_trace(path)
            dev = attrib.device_events(attrib.load_trace_events(path),
                                       device="gpu")
    finally:
        trace.enable(prev)
    table = attrib.phase_table(dev, steps=sum(s for _, s in schedule))
    kernels = {}
    for e in dev:
        for prefix, _ in _PHASE_OF:
            # CUDA names come demangled ("void topk_rows_kernel<...>(...)")
            if prefix in e["name"]:
                n, seen = kernels.get(prefix, (0, set()))
                seen.add(attrib.op_phase(e)[0])
                kernels[prefix] = (n + 1, seen)
                break
    return table, kernels


def _telemetry_trainer(recipe, comm):
    """A ``Trainer`` of ``recipe`` on the card whose steps write the CLI's
    sink (``train._Telemetry``: one record a step, the telemetry means,
    the fleet columns and the loss) under a scratch directory, without the
    recipe's tracing (the markers are turned on where a window asks):
    ``(trainer, sink helper, directory)``."""
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.train import Trainer, _Telemetry
    cfg = configs.RECIPES[recipe]()
    cfg.train.trace.enabled = False
    trainer = Trainer(cfg, comm=comm, device=DEVICE)
    d = tempfile.mkdtemp(prefix="dgc_telemetry_")
    return trainer, _Telemetry(cfg, trainer, d), d


def _run_schedule(label, trainer, schedule, on_step=None):
    """The schedule's epochs, each epoch's launch counts zeroed before it
    and read after: ``({epoch: counts}, {epoch: step seconds})``."""
    import torch
    per_epoch, times = {}, {}
    for epoch, steps in schedule:
        t = []
        torch.cuda.synchronize()
        _zero_counts()
        trainer.run_epoch(epoch, steps, t,
                          on_step=None if on_step is None
                          else on_step(epoch))
        torch.cuda.synchronize()
        per_epoch[epoch] = _read_counts(f"{label} epoch {epoch}", ())
        times[epoch] = t
    return per_epoch, times


def phase_telemetry_path():
    """The slice's main path, ``resnet50_wm5_telemetry`` (the step taps,
    the fleet gather, the sink) at full width, 224x224, batch 32 a
    worker, W=4 on the card: 1 step at epoch 4 and 3 at epoch 5, against
    ``resnet50_wm5`` over the same schedule: every epoch's kernel
    launches equal, the collectives the plain path's plus one all-gather
    a step; the main thread's synchronising calls over 2 steps equal with
    telemetry on and off; one sink record a step under a valid header; a
    traced window (epoch 4 and epoch 6, a step each, the phase markers
    on) attributed by ``attrib.phase_table``: every ``compensate_bits``
    (``_cands``), ``topk_rows`` and ``apply_rows`` event in the
    ``compensate``, ``select`` and ``apply`` phase; then the step times
    of both in turns. Returns the path's launch counts."""
    import shutil
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.telemetry import registry, sink
    from dgc_tpu_torch.train import Trainer
    schedule = [(4, 1), (5, 3)]
    label = "resnet50_telemetry"
    plain_comm = _recording_comm(4)
    plain = Trainer(configs.resnet50_wm5(), comm=plain_comm, device=DEVICE)
    want_launch, _ = _run_schedule("resnet50 (plain)", plain, schedule)
    want_calls = dict(plain_comm.calls)
    comm = _recording_comm(4)
    trainer, tel, d = _telemetry_trainer("resnet50_wm5_telemetry", comm)
    seen = []

    def on_step(epoch):
        write = tel.on_step(epoch)

        def after(batch, metrics):
            seen.append(metrics)
            write(batch, metrics)
        return after
    try:
        per_epoch, times = _run_schedule(label, trainer, schedule, on_step)
        for epoch in per_epoch:
            if per_epoch[epoch] != want_launch[epoch]:
                raise AssertionError(f"{label} epoch {epoch}: launches "
                                     f"{per_epoch[epoch]}, plain "
                                     f"{want_launch[epoch]}")
        nsteps = sum(s for _, s in schedule)
        want = dict(want_calls, all_gather=want_calls["all_gather"] + nsteps)
        if comm.calls != want:
            raise AssertionError(f"{label}: collectives {comm.calls}, want "
                                 f"the plain path's {want_calls} + one "
                                 "all_gather a step")
        calls = dict(comm.calls)
        # the synchronising calls of the step's own thread, on and off
        syncs = {"off": _sync_calls(plain, 6, 2),
                 "on": _sync_calls(trainer, 6, 2, on_step(6))}
        if syncs["on"] != syncs["off"]:
            raise AssertionError(f"{label}: synchronising calls {syncs}")
        # the phase attribution of a traced window
        table, kernels = _attributed_window(trainer, [(4, 1), (6, 1)])
        for prefix, phase in _PHASE_OF:
            if prefix not in kernels:
                raise AssertionError(f"{label}: no {prefix} event traced")
            if kernels[prefix][1] != {phase}:
                raise AssertionError(f"{label}: {prefix} attributed to "
                                     f"{kernels[prefix][1]}, not {phase}")
        share = table["attributed_ms"] / max(table["total_ms"], 1e-12)
        # step times, telemetry off and on in turns
        turns = {"off": [], "on": []}
        for which in ("off", "on", "on", "off", "off", "on"):
            t = []
            (plain if which == "off" else trainer).run_epoch(7, 2, t)
            turns[which] += t
        n_written = len(seen)
        # the taps' [T] reductions of a W=4 step alone on the device (the
        # gradient's, the momenta's norms, the residual's sum of squares
        # and mass), against their byte bound (each input read once)
        from dgc_tpu_torch.telemetry import taps
        mems = trainer.state.memory
        grads = [torch.randn(trainer.setup.layout.total,
                             generator=torch.Generator().manual_seed(w))
                 .to(DEVICE) for w in range(len(mems))]

        def reductions():
            for g, m in zip(grads, mems):
                taps.l2(g)
                taps.l2(m["momentums_c"])
                taps.l2(m["momentums_d"])
                taps.sumsq(m["velocities_c"])
                taps.l1(m["velocities_c"])
        taps_ms = _device_ms(reductions, reps=5, hold_cycles=_LONG_HOLD)
        taps_bound = _bound(sum(4 * (g.numel() + m["momentums_c"].numel()
                                     + m["momentums_d"].numel()
                                     + m["velocities_c"].numel())
                                for g, m in zip(grads, mems)), 0)[0]
        del grads
    finally:
        tel.close()
    header, recs = sink.read_run(str(Path(d) / "telemetry" / "host0" /
                                     "telemetry.jsonl"))
    shutil.rmtree(d, ignore_errors=True)
    steps = [r for r in recs if "event" not in r]
    if (header["schema"] != registry.SCHEMA or not header.get(
            "fleet_metrics") or len(steps) != n_written
            or n_written != nsteps + 2):
        raise AssertionError(f"{label}: sink {header.get('schema')}, "
                             f"{len(steps)} records of {n_written} steps")
    for r in steps:
        missing = (set(registry.step_stat_names())
                   | set(registry.fleet_stat_names())) - set(r)
        if missing or not all(math.isfinite(x) for x in r["w_grad_norm"]):
            raise AssertionError(f"{label}: record {r['step']}: {missing}")
    last = {k: (v.tolist() if torch.is_tensor(v) else v)
            for k, v in {**seen[-1]["telemetry"],
                         **seen[-1]["fleet"]}.items()}
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    DETAIL[f"launches {label} by epoch"] = per_epoch
    DETAIL[label] = {"collectives": calls,
                     "plain_collectives": want_calls, "sync_calls": syncs,
                     "phase_table": table, "attributed_share": share,
                     "kernel_phases": {k: [n, sorted(s)] for k, (n, s)
                                       in kernels.items()},
                     "step_s": times, "turns_step_s": turns,
                     "median_step_s": med, "last_stats": last,
                     "records": len(steps), "taps_ms": taps_ms,
                     "taps_bound_ms": taps_bound}
    print(f"[{label}] W=4, epochs 4 (1 step) and 5 (3 steps): launches by "
          f"epoch equal resnet50_wm5's; collectives {calls} = plain "
          f"{want_calls} + {nsteps} all_gather; main-thread syncs over 2 "
          f"steps {syncs}; {len(steps)} sink records; attributed "
          f"{100 * share:.1f}% of {table['total_ms']:.2f} device ms a "
          f"step, phases {table['phases']}; kernels "
          f"{DETAIL[label]['kernel_phases']}; median step s in turns "
          f"{med}; the taps' [T] reductions {taps_ms:.3f} ms a step "
          f"(bound {taps_bound:.3f}, {100 * taps_ms / 1e3 / med['on']:.2f}% "
          f"of the step)")
    counts = {k: sum(c[k] for c in per_epoch.values())
              for k in per_epoch[4]}
    del plain, trainer
    torch.cuda.empty_cache()
    return counts


def phase_adaptive_path():
    """``resnet50_wm5_adaptive`` at full width, W=4 on the card, the same
    schedule, fed the clocks of :data:`_CLOCKS` (one process shares one
    host stamp, so the skew cannot come from a sleep): step 2's skewed
    clock gives worker 3 the send fraction 1 - 0.75 x 150 / 500 for step
    3, which step 3's fleet lanes carry (``adaptive_engaged`` 1) and step
    4 drops (memoryless release); every epoch's launches ``resnet50_wm5``'s.
    Then that epoch-5 engine's exchange at those fractions, card against
    CPU bitwise (stats as :func:`_check_stats`), worker 3's wire the
    slots of rank below ``ceil(quota x 0.775)`` of its selection, and its
    withheld selections still in its velocity and out of its record.
    Returns the path's launch counts."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.ops import kernels as K
    label = "resnet50_adaptive"
    schedule = [(4, 1), (5, 3)]
    want_launch = DETAIL["launches resnet50_telemetry by epoch"]
    cfg = configs.resnet50_wm5_adaptive()
    from dgc_tpu_torch.train import Trainer
    trainer = Trainer(cfg, comm=_recording_comm(4), device=DEVICE)
    clocks = iter(_CLOCKS)
    trainer.clock = lambda dt_ms: torch.tensor(next(clocks), device=DEVICE)
    seen, fracs = [], []

    def on_step(epoch):
        def after(batch, metrics):
            seen.append({k: v.cpu() for k, v in metrics["fleet"].items()})
            fracs.append(trainer.state.adaptive["w_frac"].cpu())
        return after
    per_epoch, times = _run_schedule(label, trainer, schedule, on_step)
    for epoch in per_epoch:
        if per_epoch[epoch] != want_launch[epoch]:
            raise AssertionError(f"{label} epoch {epoch}: launches "
                                 f"{per_epoch[epoch]}, plain "
                                 f"{want_launch[epoch]}")
    want = (torch.tensor(1.0) - torch.tensor(0.75)
            * (torch.tensor(150.0) / torch.tensor(500.0)))
    engaged = [float(s["adaptive_engaged"]) for s in seen]
    if (fracs[1][3] != want or not bool((fracs[1][:3] == 1).all())
            or seen[2]["w_eff_ratio"][3] != want
            or engaged != [0.0, 0.0, 1.0, 0.0]
            or not bool((fracs[2] == 1).all())):
        raise AssertionError(f"{label}: fractions {fracs}, engaged "
                             f"{engaged}, eff {seen[2]['w_eff_ratio']}")
    # the step-3 exchange of the path's epoch-5 engine at those fractions
    eng = trainer.setup.engine
    frac = fracs[1].tolist()
    got, gst = _exchange_stats(eng, DEVICE, send_frac=frac)
    wantx, wst = _exchange_stats(eng, "cpu", send_frac=frac)
    _check_equal(f"{label} masked exchange", got, wantx)
    worst = _check_stats(f"{label} stats", gst, wst)
    # worker 3's selection before the mask, and what the wire kept
    S = eng.layout.sentinel
    mem = eng.init_memory(DEVICE)
    g3 = torch.randn(eng.layout.total, generator=torch.Generator(
        ).manual_seed(703)).to(DEVICE)
    ph3 = eng.draw_phases(torch.Generator().manual_seed(73))
    vals, idx = eng.compress(g3, mem, ph3)
    rank = torch.as_tensor(eng._adaptive_rank, device=DEVICE)
    quota = torch.as_tensor(eng._adaptive_quota, device=DEVICE)
    keep = rank < torch.ceil(quota * want.to(DEVICE))
    kept = int(((idx != S) & keep).sum())
    cap = int(keep.sum())
    if float(gst[0][3]["payload_elems"]) != kept or kept > cap:
        raise AssertionError(f"{label}: worker 3 sent "
                             f"{float(gst[0][3]['payload_elems'])}, its "
                             f"selection kept {kept} (cap {cap})")
    keys = list(eng.init_memory("cpu"))
    mem3 = dict(zip(keys, got[4 + 3 * len(keys): 4 + 4 * len(keys)]))
    rec = K.keep_from_bits(mem3["sent_bits"].to(DEVICE), eng.T)
    held = idx[(idx != S) & ~keep].long()
    if held.numel() == 0 or not bool((rec[held] == 1).all()) or not bool(
            (mem3["velocities_c"].to(DEVICE)[held]
             == vals[(idx != S) & ~keep]).all()):
        raise AssertionError(f"{label}: the withheld selections left the "
                             "velocity or entered the record")
    DETAIL[f"launches {label} by epoch"] = per_epoch
    DETAIL[label] = {"w_frac": [f.tolist() for f in fracs],
                     "adaptive_engaged": engaged, "step_s": times,
                     "worker3_payload": kept, "worker3_cap": cap,
                     "withheld": int(held.numel()),
                     "norm_rel_diff": worst}
    print(f"[{label}] W=4, clocks {list(_CLOCKS)}: worker 3's step-3 send "
          f"fraction {float(fracs[1][3])} (1 - 0.75 x 150 / 500), engaged "
          f"{engaged}, released at step 4; launches by epoch equal "
          f"resnet50_wm5's; the masked exchange card == CPU bitwise, "
          f"worker 3 sent {kept} of its selection's {int((idx != S).sum())}"
          f" (sum of ceil(quota x 0.775) = {cap}), {int(held.numel())} "
          f"withheld in its velocity; step_s {times}")
    counts = {k: sum(c[k] for c in per_epoch.values())
              for k in per_epoch[4]}
    del trainer
    torch.cuda.empty_cache()
    return counts


def _poll_all(label, reps, exp):
    """Every replica polls once: each must report ``ok`` at the exporter's
    head with the exporter's digest there. Returns each poll's ms (wall,
    the poll's own digest copy included)."""
    from dgc_tpu_torch.telemetry import registry
    ms = []
    for r in reps:
        t0 = time.perf_counter()
        st = r.poll()
        ms.append((time.perf_counter() - t0) * 1e3)
        registry.validate_replica_status(st)
        key = f"{exp.base_version}:{exp.delta_seq}"
        if st["health"] != "ok" or r.digest() != exp.digests[key]:
            raise AssertionError(f"{label}: replica {r.name} at {key}: "
                                 f"{st['health']}, digest {r.digest()} "
                                 f"vs {exp.digests[key]}")
    return ms


class _PublishParts:
    """Times the parts of real publish ticks: inside ``with parts:`` the
    exporter's ``spec.flatten`` / ``encode`` / ``apply``, ``DeltaSpec.
    digest`` (the copy to the host and sha256) and the protocol's atomic
    writes (the artifact's ``.npz`` and the manifest) are wrapped, each
    synchronised on the card, and their ms summed into one ``{part: ms}``
    dict a tick, appended to ``ticks``. What the parts leave out of the
    tick (the difference, the resync check, the digest trail) is the
    caller's remainder."""

    PARTS = (("spec", "flatten", "flatten_ms"),
             ("spec", "encode", "encode_ms"),
             ("spec", "apply", "apply_ms"),
             ("cls", "digest", "digest_ms"),
             ("protocol", "save_npz_atomic", "write_ms"),
             ("protocol", "write_json_atomic", "write_ms"))

    def __init__(self, exp):
        from dgc_tpu_torch.serving import protocol
        from dgc_tpu_torch.serving.delta import DeltaSpec
        self.owners = {"spec": exp.spec, "cls": DeltaSpec,
                       "protocol": protocol}
        self.ticks = []

    def _timed(self, fn, part):
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            tick = self.ticks[-1]
            tick[part] = tick.get(part, 0.0) + (time.perf_counter()
                                                - t0) * 1e3
            return out
        return run

    def __enter__(self):
        self.ticks.append({})
        self.saved = []
        for owner, name, part in self.PARTS:
            obj = self.owners[owner]
            self.saved.append((obj, name, obj.__dict__.get(name)))
            fn = self._timed(getattr(obj, name), part)
            setattr(obj, name, staticmethod(fn) if owner == "cls" else fn)
        return self

    def __exit__(self, *exc):
        for obj, name, was in reversed(self.saved):
            if was is None:
                delattr(obj, name)
            else:
                setattr(obj, name, was)
        return False


def _serving_topk(spec, delta, errs):
    """``topk_rows`` at the serving encode's shapes (each bucket's [rows,
    cols] magnitudes, the row tails at -1, k the bucket's largest quota),
    on the path's last delta: bitwise its plain version, twice, and
    timed (:func:`_topk_call`)."""
    import torch
    out = []
    for b in spec.buckets:
        x = delta[b.base:b.base + b.rows * b.cols].view(b.rows, b.cols)
        col = torch.arange(b.cols, device=x.device)
        numels = torch.as_tensor(b.numels, device=x.device).long()
        imp = torch.where(col[None, :] < numels[:, None], x.abs(), -1.0)
        out.append(_topk_call(f"serving [{b.rows}, {b.cols}] k={b.max_sel}",
                              imp, b.max_sel, errs))
    return out


def phase_serving_path():
    """The serving slice's main path at full width: ``resnet50_wm5``
    (224x224, batch 32 a worker, W=4 on the card), 1 step at epoch 4 and
    3 at epoch 5; an ``Exporter`` on the card (ratio 0.001) publishes the
    base before step 1 and a delta after each step from the trainer's
    parameters (``{flax name: view}`` of its flat buffer); two card
    ``Replica``s and one CPU ``Replica`` poll after each publish, and
    each digest equals the exporter's at every ``(V, S)`` (card == CPU
    on the apply). Then a second stream from the same trainer with
    ``DGC_SERVE_DROP=1:2`` and auto resync over 3 more steps: the
    replicas report the gap, the next publish rebases to V=2, and every
    replica ends at V=2's digest. Counts zeroed before the path and read
    after; the publishes' ``topk_rows`` launches (8 buckets a delta)
    counted apart. Then ``topk_rows`` held and timed at the 8 buckets'
    shapes, the publish tick's split (:class:`_PublishParts`, over the
    first stream's ticks) and a delta poll's ms apart from the rebase's. Returns ``(path counts, serving entry of topk_rows)``."""
    import os
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.ops import kernels as K
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.serving import DeltaSpec, Exporter, Replica
    from dgc_tpu_torch.train import Trainer
    label = "resnet50_serving"
    trainer = Trainer(configs.resnet50_wm5(), comm=LocalComm(4),
                      device=DEVICE)
    layout = trainer.setup.layout

    def params():
        return layout.unflatten_named(trainer.state.params)
    root = tempfile.mkdtemp(prefix="dgc_serving_")
    log = {"publish_ms": [], "poll_ms": {}, "rebase_poll_ms": {},
           "topk_launches": [], "split": []}

    def stream(name, drop=None):
        d = os.path.join(root, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = Exporter(d, params(), ratio=0.001, max_lag=8,
                       lineage={"epoch": 4, "step": 0}, device=DEVICE)
        log["base_ms"] = (time.perf_counter() - t0) * 1e3
        reps = [Replica(d, name=f"card{i}", device=DEVICE) for i in (0, 1)]
        reps.append(Replica(d, name="cpu0", device="cpu"))
        _poll_all(f"{label} {name} base", reps, exp)
        state = {"gstep": 0, "records": []}
        parts = _PublishParts(exp)
        if drop is None:
            log["split"] = parts.ticks

        def on_step(epoch):
            def after(batch, metrics):
                state["gstep"] += 1
                if drop:
                    os.environ["DGC_SERVE_DROP"] = drop
                torch.cuda.synchronize()
                before = K.LAUNCHES["topk_rows"]
                t0 = time.perf_counter()
                with parts:
                    rec = exp.publish(params(), step=state["gstep"])
                    torch.cuda.synchronize()
                log["publish_ms"].append((time.perf_counter() - t0) * 1e3)
                log["topk_launches"].append(K.LAUNCHES["topk_rows"] - before)
                os.environ.pop("DGC_SERVE_DROP", None)
                state["records"].append(rec)
                if rec.get("dropped"):
                    for r in reps:
                        st = r.poll()
                        if st["health"] != "gap" or r.gaps != 1:
                            raise AssertionError(f"{label}: {r.name} after "
                                                 f"the drop: {st}")
                    return
                ms = _poll_all(f"{label} {name} step {state['gstep']}",
                               reps, exp)
                # a poll after a rebase reloads the whole base
                polls = log["rebase_poll_ms" if rec["kind"] == "base"
                            else "poll_ms"]
                for r, m in zip(reps, ms):
                    polls.setdefault(r.name, []).append(m)
            return after
        return exp, reps, state, on_step

    torch.cuda.synchronize()
    _zero_counts()
    exp, reps, st1, on_step = stream("stream")
    per_epoch, times = _run_schedule(label, trainer, [(4, 1), (5, 3)],
                                     on_step)
    exp2, reps2, st2, on_step2 = stream("dropped", drop="1:2")
    per_epoch2, _ = _run_schedule(f"{label} dropped", trainer, [(5, 3)],
                                  on_step2)
    torch.cuda.synchronize()
    counts = {k: per_epoch[4][k] + per_epoch[5][k] + per_epoch2[5][k]
              for k in per_epoch[4]}
    kinds = [(r["kind"], r["base_version"], r["delta_seq"],
              bool(r.get("dropped"))) for r in st2["records"]]
    if kinds != [("delta", 1, 1, False), ("delta", 1, 2, True),
                 ("base", 2, 0, False)]:
        raise AssertionError(f"{label}: the dropped stream published {kinds}")
    for r in reps2:
        if (r.base_version, r.delta_seq, r.resyncs, r.gaps) != (2, 0, 1, 1) \
                or r.digest() != exp2.digests["2:0"]:
            raise AssertionError(f"{label}: {r.name} ended at "
                                 f"{r.base_version}:{r.delta_seq}")
    if st2["records"][2]["request"]["reason"] != "gap at 1:2":
        raise AssertionError(f"{label}: {st2['records'][2]['request']}")
    desc = exp.spec.describe()
    if desc["wire_bytes_per_update"] != 52_085 or \
            desc["num_params"] != 25_557_032:
        raise AssertionError(f"{label}: {desc}")
    nb = len(exp.spec.buckets)
    deltas = [n for n, r in zip(log["topk_launches"],
                                st1["records"] + st2["records"])
              if r["kind"] == "delta"]
    if deltas != [nb] * len(deltas):
        raise AssertionError(f"{label}: topk_rows launches a delta {deltas}")
    missing = [k for k in ("topk_rows", "apply_rows", "opaque_view_from",
                           "compensate_bits_cands") if counts[k] == 0]
    if missing or counts["topk_rows"] < sum(deltas):
        raise AssertionError(f"{label}: never launched {missing}, or "
                             f"{counts['topk_rows']} top-k launches")
    # held at the serving shapes, on the last tick's delta
    errs = []
    spec = exp.spec
    last = spec.flatten(params()) - exp.published
    shapes = _serving_topk(spec, last, errs)
    ticks = log["split"][1:4]
    split = {k: statistics.median(t.get(k, 0.0) for t in ticks)
             for k in ("flatten_ms", "encode_ms", "apply_ms", "digest_ms",
                       "write_ms")}
    split["rest_ms"] = statistics.median(
        p - sum(t.values()) for p, t in zip(log["publish_ms"][1:4], ticks))
    card_poll = statistics.median(log["poll_ms"]["card0"]
                                  + log["poll_ms"]["card1"])
    cpu_poll = statistics.median(log["poll_ms"]["cpu0"])
    rebase = log["rebase_poll_ms"]
    publish = statistics.median(log["publish_ms"][1:4])
    print(f"[{label}] wire_bytes_per_update {desc['wire_bytes_per_update']}"
          f" (full checkpoint {desc['full_checkpoint_bytes']}, payload "
          f"{desc['payload']}, {nb} buckets, {desc['bits_per_index']} bits "
          f"an index)")
    print(f"[{label}] publish tick {publish:.2f} ms (median of steps 2-4, "
          f"parts synchronised; base {log['base_ms']:.1f} ms): flatten "
          f"{split['flatten_ms']:.2f}, encode {split['encode_ms']:.2f}, "
          f"apply {split['apply_ms']:.2f}, digest "
          f"{split['digest_ms']:.2f}, write {split['write_ms']:.2f}, rest "
          f"{split['rest_ms']:.2f} ms")
    print(f"[{label}] replica poll (one delta, digest included; median of "
          f"{len(log['poll_ms']['card0'])} a replica): card "
          f"{card_poll:.2f} ms, CPU {cpu_poll:.2f} ms; poll after the "
          f"rebase (base reload): card {rebase['card0'][0]:.2f} / "
          f"{rebase['card1'][0]:.2f} ms, CPU {rebase['cpu0'][0]:.2f} ms; "
          f"3 replicas == exporter at {len(st1['records']) + 1} heads, "
          "dropped 1:2 -> gap -> rebase to 2:0 on all 3")
    print(f"[{label}] topk_rows at the 8 buckets: " + ", ".join(
        f"[{c['shape'][0]}, {c['shape'][1]}] k={c['k']} {c['ms']:.4f} ms "
        f"(plain {c['plain_ms']:.4f}, torch.topk {c['library_ms']:.4f})"
        for c in shapes))
    DETAIL[label] = dict(describe=desc, publish_ms=log["publish_ms"],
                         poll_ms=log["poll_ms"], base_ms=log["base_ms"],
                         rebase_poll_ms=rebase, split_ms=split,
                         split_ticks=log["split"], topk_launches=log["topk_launches"],
                         step_s=times, launches_by_epoch=per_epoch,
                         topk_shapes=shapes)
    serving = dict(
        shapes=shapes, launches_a_delta=nb,
        ms=sum(c["ms"] for c in shapes),
        plain_ms=sum(c["plain_ms"] for c in shapes),
        library_ms=sum(c["library_ms"] for c in shapes),
        bound_ms=sum(c["bound_ms"] for c in shapes),
        max_abs_err=max(errs, default=0.0))
    del trainer, exp, exp2, reps, reps2
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return counts, serving


def phase_surgery_drill():
    """Cohort surgery through the CLI's entry point (``train.main`` in this
    process, from a scratch directory), one process on the card:
    ``--config resnet20_wm5_resilience --surgery --world 4 --epochs 1
    --steps 3``, an excise order for process 0 published at the boundary
    before step 2 (``surgery.publish_order``, through the step-boundary
    check): exit 76, the exit record (verdict ``manual``, target 0, world
    1, step 1), the order cleared, the emergency checkpoint at
    ``preempt_batch`` 0; the same command again resumes at batch 1, and
    its epoch checkpoint's every tensor and its losses are the
    uninterrupted run's (:func:`_uninterrupted`). The two-process
    agreement and the lost cohort's deadline need several processes:
    their CPU tests hold them over gloo."""
    import os
    import torch
    from dgc_tpu_torch import train
    from dgc_tpu_torch.resilience import surgery
    label = "surgery_drill"
    recipe = "resnet20_wm5_resilience"
    args = ["--epochs", "1", "--steps", "3", "--synthetic-size", "2048"]
    flags = ["--config", recipe, "--world", "4", "--surgery", "--device",
             DEVICE, *args]
    cwd = os.getcwd()
    stop = train._Resilience.stop

    def stop_publishing(self, epoch):
        check = stop(self, epoch)

        def publish_then_check(batch):
            if batch == 1:
                surgery.publish_order(
                    os.path.join(self.ckpt_dir, surgery.ORDER_FILE),
                    "manual", 0, step=1)
            return check(batch)
        return publish_then_check
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        want = _uninterrupted(recipe, args, Path(tmp, "uninterrupted"))
        t_full = time.perf_counter() - t0
        os.chdir(tmp)
        try:
            train._Resilience.stop = stop_publishing
            t0 = time.perf_counter()
            try:
                train.main(flags)
                code = 0
            except SystemExit as e:
                code = e.code
            finally:
                train._Resilience.stop = stop
            t_cut = time.perf_counter() - t0
            if code != surgery.EXIT_SURGERY:
                raise AssertionError(f"{label}: exit {code}, want 76")
            (run,) = Path(tmp, "runs").iterdir()
            ckpt = run / "checkpoints"
            rec = surgery.read_exit_record(str(ckpt / surgery.EXIT_RECORD))
            got = {k: rec[k] for k in ("verdict", "target", "lost", "world",
                                       "process_index", "step")}
            if got != dict(verdict="manual", target=0, lost=False, world=1,
                           process_index=0, step=1):
                raise AssertionError(f"{label}: exit record {rec}")
            if (ckpt / surgery.ORDER_FILE).exists():
                raise AssertionError(f"{label}: the order was not cleared")
            meters = json.loads((ckpt / "e0" / "meters.json").read_text())
            if meters["preempt_batch"] != 0:
                raise AssertionError(f"{label}: meters {meters}")
            t0 = time.perf_counter()
            resumed = train.main(flags)
            t_resume = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        a, b = _epoch_files(run, 0), _epoch_files(Path(tmp,
                                                       "uninterrupted"), 0)
        if set(a) != set(b):
            raise AssertionError(f"{label}: files {sorted(a)}, {sorted(b)}")
        n = 0
        for f in a:
            for k in a[f]:
                n += 1
                if not torch.equal(a[f][k], b[f][k]):
                    raise AssertionError(f"{label}: resumed {f}:{k} differs "
                                         "from the uninterrupted run's")
    if resumed != want[1:]:
        raise AssertionError(f"{label}: resumed losses {resumed}, "
                             f"uninterrupted {want}")
    DETAIL[label] = {"record": got, "tensors": n, "losses": resumed,
                     "uninterrupted_s": t_full, "excised_s": t_cut,
                     "resumed_s": t_resume}
    print(f"[{label}] excise order for process 0 before step 2 -> exit 76, "
          f"record {got}, order cleared -> resume at batch 1: losses and "
          f"{n} checkpoint tensors bitwise the uninterrupted run's "
          f"({t_full:.1f} / {t_cut:.1f} / {t_resume:.1f} s)")


#: the control drill's plane process, written into its scratch directory:
#: the fleet from ``fleet.json`` (``hung`` given the hang timeout, ``steady``
#: a heartbeat file for the relaunch latency), one ``ControlPlane`` run with
#: its ticks timed and ``steady``'s heartbeats polled, then
#: ``collect_fleet`` timed; one JSON line out
_PLANE = """
import json, os, sys, threading, time
import torch
from dgc_tpu_torch.control.__main__ import load_fleet
from dgc_tpu_torch.control.plane import ControlPlane
from dgc_tpu_torch.telemetry import monitor

root, specs = load_fleet(sys.argv[1])
specs = [s._replace(hang_timeout=float(sys.argv[2])) if s.name == "hung"
         else s._replace(heartbeat=os.path.join(s.run_dir, "heartbeat"))
         if s.name == "steady" else s for s in specs]
plane = ControlPlane(specs, root, interval=0.5)
ticks, beats, done = [], set(), threading.Event()
tick = plane.tick

def timed_tick(now=None):
    t0 = time.perf_counter()
    try:
        return tick(now)
    finally:
        ticks.append(time.perf_counter() - t0)

def poll(path):
    while not done.wait(0.05):
        try:
            with open(path) as f:
                beats.add(float(f.read()))
        except (OSError, ValueError):
            pass

plane.tick = timed_tick
threading.Thread(target=poll, daemon=True, args=(os.path.join(
    plane.specs["steady"].run_dir, "heartbeat"),)).start()
final = plane.run()
done.set()
collect_s = []
for _ in range(5):
    t0 = time.perf_counter()
    monitor.collect_fleet(root)
    collect_s.append(time.perf_counter() - t0)
print(json.dumps({"final": final, "ticks": ticks, "beats": sorted(beats),
                  "collect_fleet_s": collect_s,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""

#: ``cursed``'s trainer: the CLI whose losses turn non-finite from the 4th
#: step on (the loss function patched as ``tests/test_torch_preempt_cli.py``
#: patches it, past three finite steps): the guards skip those steps and
#: the streak aborts the run at the epoch's end. Three finite steps first
#: hold the guards' cumulative non-finite rate at 0.5, never above the
#: quarantine rule's 0.5, so the flight dump is the plane's only evidence;
#: with every loss NaN the rate passes 0.5 steps before the dump, and which
#: evidence a tick reads first would be a race
_CURSED = """
import sys
import torch.nn.functional as F
from dgc_tpu_torch import train
ce, step, steps = F.cross_entropy, train.train_step, [0]

def counted(*a, **k):
    steps[0] += 1
    return step(*a, **k)

train.train_step = counted
F.cross_entropy = lambda *a, **k: ce(*a, **k) * (
    float("nan") if steps[0] > 3 else 1.0)
train.main(sys.argv[1:])
"""

_HANG_TIMEOUT = 30.0
#: each supervised run's flags after ``--config ... --world 4``
_CONTROL_ARGS = ["--epochs", "1", "--steps", "4", "--synthetic-size", "2048"]
#: ``cursed``'s: six steps (three finite, three not)
_CURSED_ARGS = ["--epochs", "1", "--steps", "6", "--synthetic-size", "3072"]


def _run_log(run, events):
    return [e for e in events if e.get("run") == run]


def _spawn(cmd, cwd, env):
    """``cmd`` in a session of its own (so it and every trainer it starts
    can be killed together), its output in ``cwd/plane.out`` and
    ``plane.err``."""
    with open(Path(cwd, "plane.out"), "w") as out, \
            open(Path(cwd, "plane.err"), "w") as err:
        return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out,
                                stderr=err, start_new_session=True)


def phase_control_drill():
    """The control plane supervising the port's trainer on the card. In a
    scratch directory, ``fleet.json`` holds three runs of ``python -m
    dgc_tpu_torch.train --config resnet20_wm5_control --world 4 --epochs
    1 --steps 4 --synthetic-size 2048``, each with its ``--suffix`` and
    its ``run_dir`` the save path the CLI derives (each child's output
    appended to a log beside it by ``sh -c 'exec ...'``):
    ``steady`` under ``DGC_FAULTS=kill@2`` (exit 75, relaunched by its
    supervisor, the resume at batch 2, exit 0: its epoch-0 checkpoint's
    every tensor and its losses bitwise :func:`_uninterrupted`'s, whose
    launch counts show ``compensate_bits``, ``topk_rows`` and
    ``apply_rows``); ``cursed`` (6 steps, :data:`_CURSED_ARGS`) through
    a launcher that makes the losses NaN from the 4th step on
    (:data:`_CURSED`: the streak's exit 70 after one launch, quarantined,
    one audited ``quarantine`` on the flight dump's
    ``nonfinite-streak``); ``hung`` under
    ``DGC_FAULTS=hang:secs=600@2`` with a 30 s hang timeout (its stale
    ``DGC_HEARTBEAT`` gets it SIGKILLed within the budget and one poll,
    quarantined). The plane runs in a fresh process (:data:`_PLANE`)
    that must not initialise CUDA; every fleet event of a run carries
    the ``run_id`` of its telemetry header and flight static; the fleet
    monitor's ``--once --openmetrics`` exposition labels every run's
    gauges and ``cursed``'s flight dump; ``python -m
    dgc_tpu_torch.control`` on ``steady`` alone, without the fault,
    exits 0 (started once ``hung`` has beaten, beside the rest). Timed:
    the relaunch (exit 75 to the relaunched child's first heartbeat; the
    backoff is 1 s), the hang's detection (last heartbeat to the kill),
    the plane's median tick, ``collect_fleet``."""
    import os
    import shlex
    import signal
    import torch
    from dgc_tpu_torch import configs, train
    label = "control_drill"
    recipe = "resnet20_wm5_control"
    args = _CONTROL_ARGS
    base = train.get_save_path(*configs.CONFIG_FILES[recipe])
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("DGC_FAULTS", None)
    torch.cuda.empty_cache()        # the children own the card from here

    def run_spec(tmp, name, cmd, flags=args, **extra):
        run_dir = os.path.join(tmp, f"{base}-{name}.np4")
        os.makedirs(run_dir, exist_ok=True)
        log = os.path.join(run_dir, "train.log")
        return dict(extra, name=name, run_dir=run_dir, backoff=1.0, cmd=[
            "sh", "-c", f'exec "$0" "$@" >> {shlex.quote(log)} 2>&1',
            *cmd, "--config", recipe, "--world", "4", *flags,
            f"--suffix=-{name}"])

    def read(path):
        with open(path) as f:
            return f.read()

    def jsonl(path):
        return [json.loads(x) for x in read(path).splitlines() if x.strip()]

    cli = [sys.executable, "-m", "dgc_tpu_torch.train"]
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts()
        t0 = time.perf_counter()
        want = _uninterrupted(recipe, args, Path(tmp, "uninterrupted"))
        t_full = time.perf_counter() - t0
        counts = _read_counts(label, ("compensate_bits", "topk_rows",
                                      "apply_rows"))
        Path(tmp, "cursed.py").write_text(_CURSED)
        Path(tmp, "plane.py").write_text(_PLANE)
        runs = [run_spec(tmp, "steady", cli, env={"DGC_FAULTS": "kill@2"}),
                run_spec(tmp, "cursed", [sys.executable,
                                         os.path.join(tmp, "cursed.py")],
                         _CURSED_ARGS),
                run_spec(tmp, "hung", cli,
                         env={"DGC_FAULTS": "hang:secs=600@2"})]
        root = os.path.dirname(runs[0]["run_dir"])
        Path(tmp, "fleet.json").write_text(json.dumps(
            {"fleet_root": root, "runs": runs}))
        # the CLI on steady alone, without the fault, must end clean: it
        # starts once hung has beaten (no start-up of its own competes with
        # hung's hang budget) and runs beside the rest of the drill
        solo = Path(tmp, "solo")
        solo.mkdir()
        Path(solo, "fleet.json").write_text(json.dumps(
            {"runs": [run_spec(str(solo), "solo", cli)]}))
        procs = {}
        try:
            t0 = time.perf_counter()
            procs["plane"] = _spawn([sys.executable, "plane.py", "fleet.json",
                                     str(_HANG_TIMEOUT)], tmp, env)
            beat = Path(runs[2]["run_dir"], "heartbeat")
            while (not beat.exists() and procs["plane"].poll() is None
                   and time.perf_counter() - t0 < 300):
                time.sleep(0.2)
            t1 = time.perf_counter()
            procs["solo"] = _spawn([sys.executable, "-m",
                                    "dgc_tpu_torch.control", "fleet.json",
                                    "--interval", "0.5"], str(solo), env)
            rc = procs["plane"].wait(timeout=600)
            t_plane = time.perf_counter() - t0
            rc_solo = procs["solo"].wait(timeout=300)
            t_solo = time.perf_counter() - t1
        finally:
            for proc in procs.values():
                if proc.poll() is None:       # the plane and its trainers
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        out, err = (read(os.path.join(tmp, f"plane.{k}")) for k in ("out",
                                                                     "err"))
        if rc:
            raise AssertionError(f"{label}: the plane exited {rc}:\n"
                                 f"{err[-4000:]}")
        solo_out = read(os.path.join(solo, "plane.out"))
        if rc_solo or "fleet done: 1/1 runs clean" not in solo_out:
            raise AssertionError(f"{label}: python -m dgc_tpu_torch.control "
                                 f"exited {rc_solo}:\n{solo_out[-2000:]}"
                                 + read(os.path.join(solo, "plane.err"))[-2000:])
        res = json.loads(out.strip().splitlines()[-1])
        final = res["final"]
        logs = {r["name"]: read(os.path.join(r["run_dir"], "train.log"))
                for r in runs}
        if res["cuda_initialized"]:
            raise AssertionError(f"{label}: the plane initialised CUDA")
        states = {n: (v["state"], v["rc"], v["launches"])
                  for n, v in final.items()}
        if states != {"steady": ("done", 0, 2),
                      "cursed": ("quarantined", 70, 1),
                      "hung": ("quarantined", -9, 1)}:
            raise AssertionError(f"{label}: final states {states}\n"
                                 + "\n".join(f"{n}: {t[-2000:]}"
                                             for n, t in logs.items()))
        if not final["hung"]["quarantined"].startswith("hang:"):
            raise AssertionError(f"{label}: hung {final['hung']}")
        events = jsonl(os.path.join(root, "control_events.jsonl"))
        actions = [e for e in events if e["event"] == "control_action"]
        cursed_acts = [(a["action"], a["evidence"]["kind"],
                        a["evidence"].get("reason", ""))
                       for a in actions if a["run"] == "cursed"]
        if (len(cursed_acts) != 1 or cursed_acts[0][:2] != (
                "quarantine", "flight_dump")
                or not cursed_acts[0][2].startswith("nonfinite-streak")):
            raise AssertionError(f"{label}: cursed's actions {cursed_acts}")
        if [a["run"] for a in actions if a["run"] == "steady"]:
            raise AssertionError(f"{label}: steady was remediated: "
                                 f"{actions}")
        # one run id a run: the fleet stream, the telemetry header (the
        # last launch's) and the flight static agree
        for r in runs:
            name, rid = r["name"], final[r["name"]]["run_id"]
            ids = {e["run_id"] for e in _run_log(name, events)}
            with open(os.path.join(r["run_dir"], "telemetry", "host0",
                                   "telemetry.jsonl")) as f:
                header = json.loads(f.readline())
            ids.add(header["static"].get("run_id"))
            if name != "hung":
                ids.add(json.loads(read(os.path.join(
                    r["run_dir"], "flight.json")))["static"].get("run_id"))
            if ids != {rid}:
                raise AssertionError(f"{label}: {name}'s run ids {ids}")
        # steady: killed after step 2, relaunched, resumed at batch 2
        sup = [e for e in _run_log("steady", events) if e["event"] in (
            "launch", "relaunch", "done")]
        if [(e["event"], e.get("rc")) for e in sup] != [
                ("launch", None), ("relaunch", 75), ("launch", None),
                ("done", 0)]:
            raise AssertionError(f"{label}: steady's events {sup}")
        if ("stopping at epoch 0, batch 1" not in logs["steady"]
                or "[resumed] mid-epoch 0 at batch 2" not in logs["steady"]):
            raise AssertionError(f"{label}: steady's log\n"
                                 f"{logs['steady'][-3000:]}")
        got = [x for s in _summaries(logs["steady"]) for x in s["loss"]]
        if got != want:
            raise AssertionError(f"{label}: killed + resumed losses {got}, "
                                 f"uninterrupted {want}")
        a = _epoch_files(runs[0]["run_dir"], 0)
        b = _epoch_files(Path(tmp, "uninterrupted"), 0)
        if set(a) != set(b):
            raise AssertionError(f"{label}: files {sorted(a)}, {sorted(b)}")
        n = 0
        for f in a:
            if set(a[f]) != set(b[f]):
                raise AssertionError(f"{label}: {f} keys differ")
            for k in a[f]:
                n += 1
                if not torch.equal(a[f][k], b[f][k]):
                    raise AssertionError(f"{label}: steady's {f}:{k} "
                                         "differs from the uninterrupted "
                                         "run's")
        relaunch_t = sup[1]["t"]
        first_beat = min(b for b in res["beats"] if b > sup[2]["t"])
        relaunch_s = first_beat - relaunch_t
        # hung: killed from its stale heartbeat within the budget + a poll
        (kill,) = [e for e in _run_log("hung", events)
                   if e["event"] == "hang_kill"]
        hung_dir = runs[2]["run_dir"]
        detect_s = kill["t"] - os.path.getmtime(os.path.join(hung_dir,
                                                            "heartbeat"))
        stale_s = float(re.search(r"no heartbeat for ([\d.]+)s",
                                  kill["reason"]).group(1))
        poll = min(1.0, _HANG_TIMEOUT / 4.0)
        if not (_HANG_TIMEOUT < stale_s <= _HANG_TIMEOUT + poll + 0.05
                and detect_s <= _HANG_TIMEOUT + poll + 0.5):
            raise AssertionError(f"{label}: the hang was detected after "
                                 f"{detect_s:.2f} s (reported {stale_s} s)")
        hang_acts = [(a["action"], a["evidence"]["kind"]) for a in actions
                     if a["run"] == "hung"]
        # the fleet monitor exports every run's gauges
        mon = subprocess.run(
            [sys.executable, "-m", "dgc_tpu_torch.telemetry.monitor", root,
             "--fleet", "--once", "--openmetrics"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=120)
        want_lines = [f'dgc_step{{run="{final[r["name"]]["run_id"]}"}}'
                      for r in runs]
        want_lines.append(
            f'dgc_flight_dump{{run="{final["cursed"]["run_id"]}"}}')
        if mon.returncode or any(x not in mon.stdout for x in want_lines):
            raise AssertionError(f"{label}: monitor exited "
                                 f"{mon.returncode}, wanted {want_lines}:\n"
                                 f"{mon.stdout[-3000:]}{mon.stderr[-2000:]}")
    tick_ms = 1e3 * statistics.median(res["ticks"])
    collect_ms = 1e3 * statistics.median(res["collect_fleet_s"])
    DETAIL[label] = {
        "final": final, "losses": got, "tensors": n,
        "launches_uninterrupted": counts, "relaunch_s": relaunch_s,
        "relaunch_backoff_s": 1.0, "hang_detect_s": detect_s,
        "hang_reported_s": stale_s, "hang_timeout_s": _HANG_TIMEOUT,
        "hang_actions": hang_acts, "tick_ms": [1e3 * t for t in res["ticks"]],
        "tick_median_ms": tick_ms, "collect_fleet_ms": [
            1e3 * t for t in res["collect_fleet_s"]],
        "plane_s": t_plane, "uninterrupted_s": t_full, "solo_s": t_solo,
        "actions": actions}
    print(f"[{label}] 3 supervised resnet20_wm5_control runs, W=4: steady "
          f"kill@2 -> exit 75 -> relaunched -> resumed at batch 2, losses "
          f"and {n} checkpoint tensors bitwise the uninterrupted run's; "
          f"cursed exit 70 after 1 launch, quarantined on its flight dump; "
          f"hung SIGKILLed {detect_s:.2f} s after its last heartbeat "
          f"(budget {_HANG_TIMEOUT:.0f} s), then {hang_acts}; the plane "
          "never initialised CUDA; the fleet monitor labels all 3 runs; "
          "python -m dgc_tpu_torch.control on steady alone exits 0")
    print(f"[{label}] relaunch {relaunch_s:.2f} s (exit 75 to the first "
          f"heartbeat, 1 s backoff included), plane tick median "
          f"{tick_ms:.2f} ms over {len(res['ticks'])} ticks, collect_fleet "
          f"{collect_ms:.2f} ms; plane {t_plane:.1f} s, solo {t_solo:.1f} s, "
          f"uninterrupted {t_full:.1f} s")


# ------------------------------------------------------------------ #
# the gossip slice: ring and hypercube rounds with bounded staleness #
# ------------------------------------------------------------------ #

#: the launches of ``resnet50_wm5_gossip``'s path (W=4: 1 step at epoch
#: 4, 3 at epoch 5): no fused candidates (gossip turns them off), so each
#: worker step compensates through ``compensate_bits`` and, at epoch 5,
#: its six segment buckets take ``seg_top2_candidates`` over the velocity
#: with the inbox in it; the top-k, apply and weight-copy counts are those
#: of the other paths on this schedule (``resnet50_wm5_telemetry``'s).
#: Each epoch's counts are also held against :func:`_predicted_launches`
_GOSSIP_PREDICTED = {"compensate_bits": 16, "compensate_bits_cands": 0,
                     "seg_top2_candidates": 72, "topk_rows": 212,
                     "apply_rows": 16, "opaque_view_from": 16}
#: the gossip engine's rounds a topology (ResNet-50's epoch-5 geometry,
#: W=4): full rounds 0, 2, 4 and 6, gossip rounds covering every ring
#: stride and hypercube mask
_GOSSIP_ROUNDS = 8


def _gossip_engine(eng, topology, **kw):
    """``eng``'s geometry (its compressor at its ratio) on a gossip plan
    of ``topology`` for W=4 (``kw``: the schedule's knobs)."""
    from dgc_tpu_torch.compression.flat import FlatDGCEngine
    from dgc_tpu_torch.compression.planner import plan_engine
    plan = plan_engine(eng, fabric="32x25GbE", world=4,
                       candidates=(f"gossip_{topology}",), **kw)
    return FlatDGCEngine(eng.c, eng.layout, plan=plan)


def _mass_balance(eng, mems, out):
    """The round's velocity mass (the compensate's and the inbox fold's,
    unmasked in the memory under deferred masking) against what it
    became: the residual the records keep, the inbox in flight and the
    sparse output every worker applied, W times; relative to the
    velocities' absolute mass, in float64 on the device."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    T = eng.T
    gap = torch.zeros((), dtype=torch.float64, device=out.device)
    scale = torch.zeros((), dtype=torch.float64, device=out.device)
    for m in mems:
        v = m["velocities_c"].double()
        keep = K.keep_from_bits(m["sent_bits"], T)
        gap += v.sum() - (v * keep).sum() - m["gossip_inbox"].double().sum()
        scale += v.abs().sum()
    gap -= len(mems) * out[:T].double().sum()
    return float(gap.abs() / scale.clamp(min=1e-12))


def _gossip_grads(total, rounds=_GOSSIP_ROUNDS, world=4):
    """Each round's seeded gradients, ``[round][worker]`` on the CPU."""
    import torch
    return [[torch.randn(total, generator=torch.Generator().manual_seed(
        100 * step + w)) for w in range(world)] for step in range(rounds)]


def _gossip_rounds(eng, dev, grads, balance=False):
    """The gossip exchanges of ``eng`` on ``dev``, one a round of
    ``grads`` (``[round][worker]``, on the CPU): ``(every output and the
    final memory on the CPU, per round (full, forced count, ages[, mass
    balance]))``."""
    import torch
    from dgc_tpu_torch.parallel.comm import LocalComm
    world = len(grads[0])
    mems = [eng.init_memory(dev) for _ in range(world)]
    res, hist = [], []
    for step, gs in enumerate(grads):
        phases = [eng.draw_phases(torch.Generator().manual_seed(
            10 * step + w)) for w in range(world)]
        outs = eng.exchange([g.to(dev) for g in gs], mems, phases,
                            LocalComm(world))
        hist.append((bool(outs[0][:eng.T].ne(0).any()),
                     int(mems[0]["gossip_forced"]),
                     mems[0]["gossip_age"].tolist())
                    + ((_mass_balance(eng, mems, outs[0]),) if balance
                       else ()))
        res += outs
    res += [t for m in mems for t in m.values()]
    return [t.cpu() for t in res], hist


def start_gossip_cpu():
    """The CPU side of :func:`phase_gossip_path`'s engine rounds, on a
    thread (torch's CPU ops leave the interpreter lock, so it runs while
    the card phases after the build run): each topology's engine at
    ResNet-50's epoch-5 geometry, the seeded gradients, and their CPU
    rounds and seconds. Returns the future."""
    from concurrent.futures import ThreadPoolExecutor
    from dgc_tpu_torch.ops import kernels as K
    base = _geometries("resnet50_wm5", (5,))[5][1]
    engines = {topo: _gossip_engine(base, topo) for topo in ("ring", "hcube")}
    # the thread must not move the route counters the card phases read
    # (``flat.ROUTES``): no 3-D fallback, every k on the top-k kernel
    if any(base._sel3d) or any(max(b.max_k, b.max_sel) > K.TOPK_MAX_K
                               for b in base.buckets):
        raise AssertionError("gossip CPU rounds would take a counted route")

    def run():
        t0 = time.perf_counter()
        grads = _gossip_grads(base.layout.total)
        out = {"grads": grads, "engines": engines}
        for topo, eng in engines.items():
            out[topo] = _gossip_rounds(eng, "cpu", grads)
        out["cpu_s"] = time.perf_counter() - t0
        return out
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def phase_gossip_path(cpu_rounds):
    """The gossip slice (``compression/gossip.py`` on the flat engine;
    ``cpu_rounds``: :func:`start_gossip_cpu`'s future):

    1. the engine at ResNet-50's epoch-5 geometry (T = 27,068,416), W=4,
       card == CPU bitwise over 8 rounds for each topology (ring:
       ``sync_every`` 2, ``max_staleness`` 4; hcube: masks 1-3), every
       round's velocity mass balanced against residual, inbox and output
       within 1e-6; then the ``droplink:peer=3@1-5`` ladder at
       ``sync_every = max_staleness = 4`` on the card: forced counts
       ``[0, 0, 0, 0, 0, 1, 2, 2]``, worker 3's age ``[0, 1, 2, 3, 4, 4,
       0, 1]``;
    2. ``resnet50_wm5_gossip`` (ring) at full width, 224x224, batch 32 a
       worker, W=4 with the fleet taps: 1 step at epoch 4 and 3 at epoch
       5, finite losses, the ``w_staleness`` lanes and the forced count
       ``round_state_np``'s, the launches :data:`_GOSSIP_PREDICTED` and
       each epoch's :func:`_predicted_launches` (``compensate_bits_cands``
       none), then its step time and ``resnet50_wm5``'s in turns;
    3. ``resnet20_wm5_gossip`` W=4 saved after a gossip round (the inbox
       in flight) and resumed: bitwise the uninterrupted run;
    4. that checkpoint restored elastically on 2 workers: the inbox total
       and the error-feedback mass conserved, ages, clock and forced count
       merged by max.

    Returns the ResNet-50 path's launch counts."""
    import numpy as np
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression import gossip
    from dgc_tpu_torch.parallel.comm import LocalComm
    from dgc_tpu_torch.train import Trainer
    from dgc_tpu_torch.training.checkpoint import CheckpointManager
    res = {}
    t0 = time.perf_counter()
    cpu = cpu_rounds.result()
    wait_s = time.perf_counter() - t0
    engines = cpu.pop("engines")
    for topo, eng in engines.items():
        t0 = time.perf_counter()
        got, hist = _gossip_rounds(eng, DEVICE, cpu["grads"], balance=True)
        t_card = time.perf_counter() - t0
        want, hist_cpu = cpu.pop(topo)
        _check_equal(f"gossip {topo} engine W=4 (resnet50 epoch 5)", got,
                     want)
        worst = max(h[3] for h in hist)
        if worst > 1e-6 or [h[:3] for h in hist] != hist_cpu:
            raise AssertionError(f"gossip {topo}: mass balance {worst}, "
                                 f"rounds {hist} / {hist_cpu}")
        fulls = [h[0] for h in hist]
        if fulls != [r % eng._gossip.sync_every == 0
                     for r in range(_GOSSIP_ROUNDS)]:
            raise AssertionError(f"gossip {topo}: full rounds {fulls}")
        res[topo] = {"config": list(eng._gossip), "rounds": hist,
                     "max_mass_gap": worst, "card_s": t_card}
        del got, want
    # the ladder: a droplink on worker 3 over rounds 1..5
    with _faults_armed("droplink:peer=3@1-5"):
        eng = _gossip_engine(engines["ring"], "ring", gossip_sync_every=4,
                             gossip_max_staleness=4)
    _, hist = _gossip_rounds(eng, DEVICE, cpu.pop("grads"), balance=True)
    res["cpu_s"], res["cpu_wait_s"] = cpu["cpu_s"], wait_s
    forced = [h[1] for h in hist]
    age3 = [h[2][3] for h in hist]
    worst = max(h[3] for h in hist)
    if (forced != [0, 0, 0, 0, 0, 1, 2, 2] or age3 != [0, 1, 2, 3, 4, 4, 0, 1]
            or worst > 1e-6):
        raise AssertionError(f"gossip ladder: forced {forced}, worker 3's "
                             f"age {age3}, mass balance {worst}")
    res["ladder"] = {"forced": forced, "age3": age3, "max_mass_gap": worst,
                     "full": [h[0] for h in hist]}
    del eng, engines
    torch.cuda.empty_cache()
    print(f"[gossip] resnet50 epoch-5 engine W=4, {_GOSSIP_ROUNDS} rounds: "
          f"ring and hcube card == CPU bitwise, full rounds "
          f"{[h[0] for h in res['ring']['rounds']]}, mass balance within "
          f"{max(res[t]['max_mass_gap'] for t in ('ring', 'hcube')):.3g} "
          f"(card {res['ring']['card_s']:.1f} / {res['hcube']['card_s']:.1f}"
          f" s; CPU side {res['cpu_s']:.1f} s on its thread, waited "
          f"{wait_s:.1f} s); droplink:peer=3@1-5 ladder forced {forced}, "
          f"worker 3's age {age3}, mass within {worst:.3g}")

    # 2. the slice's path at full width, with the fleet taps
    label = "resnet50_gossip"
    schedule = [(4, 1), (5, 3)]
    trainer = Trainer(configs.resnet50_wm5_gossip(), comm=LocalComm(4),
                      device=DEVICE)
    lanes = []

    def on_step(epoch):
        return lambda batch, m: lanes.append(
            (m["fleet"]["w_staleness"].tolist(),
             float(m["fleet"]["gossip_forced_syncs"]),
             float(m["fleet"]["max_staleness_seen"]), float(m["loss"])))
    per_epoch, times, engines = {}, {}, {}
    for epoch, steps in schedule:
        pe, tm = _run_schedule(label, trainer, [(epoch, steps)], on_step)
        per_epoch.update(pe)
        times.update(tm)
        engines[epoch] = trainer.setup.engine
    counts = {k: sum(c[k] for c in per_epoch.values()) for k in per_epoch[4]}
    for epoch, steps in schedule:
        want = _predicted_launches(engines[epoch], 4, steps)
        got = {k: per_epoch[epoch][k] for k in want}
        if got != want:
            raise AssertionError(f"{label} epoch {epoch}: launches {got}, "
                                 f"the engine's prediction {want}")
    g = trainer.setup.engine._gossip
    age, want_lanes = np.zeros(4, np.int32), []
    for r in range(len(lanes)):
        age = gossip.round_state_np(g, r, age)[2]
        want_lanes.append((age.astype(float).tolist(), 0.0,
                           float(age.max())))
    if [x[:3] for x in lanes] != want_lanes:
        raise AssertionError(f"{label}: fleet lanes {lanes}, want "
                             f"{want_lanes}")
    if not all(math.isfinite(x[3]) for x in lanes):
        raise AssertionError(f"{label}: losses {lanes}")
    got = {k: counts[k] for k in _GOSSIP_PREDICTED}
    if got != _GOSSIP_PREDICTED:
        raise AssertionError(f"{label}: launches {got}, predicted "
                             f"{_GOSSIP_PREDICTED}")
    plain = Trainer(configs.resnet50_wm5(), comm=LocalComm(4), device=DEVICE)
    plain.run_epoch(4, 1)
    turns = {"resnet50_wm5": [], label: []}
    for which in (label, "resnet50_wm5", "resnet50_wm5", label, label,
                  "resnet50_wm5"):
        t = []
        (trainer if which == label else plain).run_epoch(6, 2, t)
        turns[which] += t
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    DETAIL[f"launches {label} by epoch"] = per_epoch
    DETAIL["gossip"] = {**res, "path_lanes": lanes, "step_s": times,
                        "turns_step_s": turns, "median_step_s": med,
                        "launches": got, "predicted": _GOSSIP_PREDICTED}
    print(f"[{label}] W=4, epochs 4 (1 step) and 5 (3 steps): regimes "
          f"{sorted(set(trainer.setup.engine.regimes))}, {g}; losses "
          f"{[x[3] for x in lanes]}; w_staleness lanes "
          f"{[x[0] for x in lanes]} and forced syncs "
          f"{[x[1] for x in lanes]} = round_state_np's; launches {got} = "
          f"the prediction; median step s in turns {med}")
    del trainer, plain
    torch.cuda.empty_cache()

    # 3. resume with the inbox in flight; 4. its elastic restore on 2
    def small(world):
        return Trainer(configs.resnet20_wm5_gossip(), comm=LocalComm(world),
                       device=DEVICE)

    def inflight(t):
        return sum(float(m["gossip_inbox"].double().sum())
                   for m in t.state.memory)
    a = small(4)
    a.run_epoch(4, 2)
    want_losses = [float(x) for x in a.run_epoch(5, 2)]
    want = _snapshot(a)
    del a
    b = small(4)
    b.run_epoch(4, 2)
    inbox = inflight(b)
    if not all(bool(m["gossip_inbox"].ne(0).any()) for m in b.state.memory):
        raise AssertionError("gossip resume: no inbox in flight at the save")
    mass4 = _total_mass(b)
    ages4 = b.state.memory[0]["gossip_age"].tolist()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)
        b.save_checkpoint(ckpt, 4, {"acc/test_top1": 0.0})
        del b
        c = small(4)
        if c.restore_checkpoint(ckpt) is None:
            raise AssertionError("gossip resume: nothing restored")
        got_losses = [float(x) for x in c.run_epoch(5, 2)]
        if got_losses != want_losses:
            raise AssertionError(f"gossip resume: losses {got_losses}, "
                                 f"uninterrupted {want_losses}")
        _check_same_state("gossip resumed state", _snapshot(c), want)
        del c
        d = small(2)
        t0 = time.perf_counter()
        restored = d.restore_checkpoint(ckpt, elastic=True)
        restore_s = time.perf_counter() - t0
        if restored is None or "_elastic" not in restored[1]:
            raise AssertionError(f"gossip elastic: restored {restored}")
    ages2 = [m["gossip_age"].tolist() for m in d.state.memory]
    want_ages = [max(ages4[0:2]), max(ages4[2:4])]
    inbox2, mass2 = inflight(d), _total_mass(d)
    if (not math.isclose(inbox2, inbox, rel_tol=1e-6)
            or not math.isclose(mass2, mass4, rel_tol=1e-6)
            or ages2 != [want_ages] * 2):
        raise AssertionError(f"gossip elastic 4->2: inbox {inbox2} (saved "
                             f"{inbox}), mass {mass2} (saved {mass4}), "
                             f"ages {ages2} (want {want_ages})")
    losses2 = [float(x) for x in d.run_epoch(5, 1)]
    if not all(math.isfinite(x) for x in losses2):
        raise AssertionError(f"gossip elastic: losses {losses2}")
    DETAIL["gossip"].update(resume_losses=got_losses, elastic={
        "inbox_saved": inbox, "inbox_restored": inbox2,
        "mass_saved": mass4, "mass_restored": mass2, "ages": ages2,
        "restore_s": restore_s, "losses": losses2})
    print(f"[gossip resume] resnet20_wm5_gossip W=4 saved after a gossip "
          f"round (inbox {inbox:.6g} in flight), resumed: losses "
          f"{got_losses} and the state bitwise the uninterrupted run's; "
          f"4 -> 2 elastic: inbox {inbox2:.6g}, mass {mass2:.9g} (saved "
          f"{mass4:.9g}), ages {ages2}, "
          f"restore {restore_s:.2f} s, then loss {losses2}")
    return counts


def _card_name():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def phase_analysis():
    """The analysis slice on the card (``dgc_tpu_torch.analysis``):

    1. the host layers — the lints, the race lint, the model checker over
       the port's writers, and the ``drop_fsync`` mutation, which must
       turn the checker red;
    2. the contract suite on the card (the W=8 fixture over a recording
       ``LocalComm``): every contract green, guards and telemetry adding
       no synchronising call over the plain step;
    3. ``resnet50_wm5`` at full width, W=4, 1 step at epoch 4 and 1 at
       epoch 5 under the verifier's recorder: the recorded collectives a
       step equal ``Plan.collectives()`` plus the loss mean and the plain
       contract's; error-feedback conservation bit for bit for every
       worker and bucket (:class:`~dgc_tpu_torch.analysis.verify.
       ConservationProbe`: C1 payload = compensated velocity at its
       indices and on the wire, C2 the wire's indices, C3 the transmit
       record's bits = the indices and the unselected velocity unchanged
       into the next compensate), red on C3 under
       ``DGC_VERIFY_MUTATE=drop_foldback``; the state's alias coverage and
       the card's peak memory in the report's schema; the launches of
       ``compensate_bits``, ``topk_rows``, ``compensate_bits_cands``,
       ``apply_rows`` and ``opaque_view_from`` the engines' own count.
    Returns the ResNet-50 steps' launch counts."""
    import os
    import weakref

    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.analysis import contracts, program, suite, verify
    from dgc_tpu_torch.analysis.astlint import lint_paths
    from dgc_tpu_torch.analysis.mc import run_mc_suite
    from dgc_tpu_torch.analysis.racelint import race_lint_paths
    from dgc_tpu_torch.compression.planner import Plan
    from dgc_tpu_torch.ops import kernels as K
    from dgc_tpu_torch.train import Trainer
    t_start = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    card = _card_name()
    out = {"card": card}

    # 1. the host layers (no device)
    t = time.perf_counter()
    lint = lint_paths(root=root)
    race = race_lint_paths(root=root)
    mc = run_mc_suite(log=lambda m: None)
    red = run_mc_suite(log=lambda m: None, mutate="drop_fsync", fast=True)
    bad = ([f.format() for f in lint + race if not f.allowed]
           + [f"{n}: {v[:2]}" for n, v in mc if v])
    if bad or not any(v for _, v in red):
        raise AssertionError(f"analysis host layers: {bad[:4]}, "
                             f"drop_fsync red {[n for n, v in red if v]}")
    out["host"] = {"lint_allowed": len(lint), "race_allowed": len(race),
                   "mc_protocols": len(mc),
                   "drop_fsync_red": [n for n, v in red if v],
                   "s": time.perf_counter() - t}

    # 2. the contract suite on the card
    t = time.perf_counter()
    syncs = []
    results = suite.run_contract_suite(
        log=lambda m: syncs.append(m) if m.startswith("syncs ") else None,
        device=DEVICE)
    failed = {n: v for n, v in results if v}
    if failed or len(results) != 33 + 2 * (DEVICE != "cpu"):
        raise AssertionError(f"analysis contracts on the card: {failed} "
                             f"({len(results)} contracts)")
    out["contracts"] = {"green": len(results), "syncs": syncs,
                        "s": time.perf_counter() - t}

    # 3. ResNet-50 at full width under the recorder
    t = time.perf_counter()
    comm = _recording_comm(4)
    trainer = Trainer(configs.resnet50_wm5(), comm=comm, device=DEVICE)
    probe = verify.ConservationProbe()
    engines, per_epoch, calls = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with program.Recorder(trace=False, modules=False, probe=probe):
        for epoch in (4, 5):
            if epoch == 5:
                refs = {k: weakref.ref(v) for k, v in
                        contracts.state_storages(trainer.state).items()}
            comm.reset()
            probe.begin_step()
            _zero_counts()
            trainer.run_epoch(epoch, 1)
            torch.cuda.synchronize()
            per_epoch[epoch] = _read_counts(f"analysis resnet50 epoch "
                                            f"{epoch}", ())
            engines[epoch] = trainer.setup.engine
            calls[epoch] = comm.counts()
            sites = list(comm.sites)
    peak = torch.cuda.max_memory_allocated()
    after = contracts.state_storages(trainer.state)
    coverage = sum(r() is not None and r() is after.get(k)
                   for k, r in refs.items()) / len(refs)
    layout = trainer.setup.layout
    opaque = sum(K.opaque_view_eligible(layout.total, layout.offsets[n],
                                        layout.sizes[n])
                 for n in layout.convert_hoist_risky())
    for epoch, eng in engines.items():
        want = dict(Plan(eng.regimes, fabric="32x25GbE",
                         world=4).collectives(dense_reduces=1))
        want["all-reduce"] += 1                 # the loss mean
        got = {k: calls[epoch][k] for k in want}
        if got != want or got != suite.FLAT_COLLECTIVES or sum(
                calls[epoch].values()) != sum(want.values()):
            raise AssertionError(f"analysis resnet50 epoch {epoch}: "
                                 f"collectives {calls[epoch]}, "
                                 f"Plan.collectives() + the loss {want}")
        want_l = dict(_predicted_launches(eng, 4, 1),
                      opaque_view_from=4 * opaque)
        got_l = {k: per_epoch[epoch][k] for k in want_l}
        if got_l != want_l:
            raise AssertionError(f"analysis resnet50 epoch {epoch}: "
                                 f"launches {got_l}, the engine's "
                                 f"{want_l}")
    launched = {k: sum(c[k] for c in per_epoch.values()) for k in (
        "compensate_bits", "topk_rows", "compensate_bits_cands",
        "apply_rows", "opaque_view_from")}
    if not all(launched.values()):
        raise AssertionError(f"analysis resnet50: launches {launched}")
    conserve = {e: probe.check(engines[e], i)
                for i, e in enumerate((4, 5))}
    broken = {e: c for e, c in conserve.items() if any(c.values())}
    if broken:
        raise AssertionError(f"analysis resnet50: conservation {broken}")
    # the seeded mutation: the same check turns red on C3
    os.environ["DGC_VERIFY_MUTATE"] = "drop_foldback"
    try:
        with program.Recorder(trace=False, modules=False, probe=probe):
            probe.begin_step()
            trainer.run_epoch(5, 1)
            torch.cuda.synchronize()
    finally:
        os.environ.pop("DGC_VERIFY_MUTATE", None)
    mutated = probe.check(engines[5], 2)
    if not mutated["C3"] or mutated["C1"] or mutated["C2"]:
        raise AssertionError(f"analysis resnet50: drop_foldback gave "
                             f"{mutated}, want C3 red only")
    report = {"schema": verify.REPORT_SCHEMA, "alias_coverage":
              round(coverage, 4), "peak_live_bytes": float(peak),
              "configs": {"resnet50_wm5": {
                  "conservation": "ok", "peak_live_bytes": int(peak),
                  "collectives": sorted(f"{op}@{ax}" for op, ax, _, _ in
                                        sites)}},
              "devices": {"ef-conservation-runtime": "cuda",
                          "donation-liveness": "cuda (alias coverage; "
                          "torch.cuda.max_memory_allocated)"},
              "card": card}
    del trainer, probe
    torch.cuda.empty_cache()
    out["resnet50"] = {"collectives_a_step": {e: {k: v for k, v in c.items()
                                                  if v}
                                              for e, c in calls.items()},
                       "launches": launched, "opaque_per_worker": opaque,
                       "drop_foldback": {k: v[:2] for k, v in
                                         mutated.items()},
                       "report": report, "s": time.perf_counter() - t}
    out["s"] = time.perf_counter() - t_start
    DETAIL["analysis"] = out
    print(f"[analysis] {card}: host layers {len(lint)} + {len(race)} "
          f"allowlisted findings, mc {len(mc)} protocols green, drop_fsync "
          f"red on {out['host']['drop_fsync_red']} "
          f"({out['host']['s']:.1f} s); contracts {len(results)}/"
          f"{len(results)} green on the card ({out['contracts']['s']:.1f} "
          f"s), {syncs}")
    print(f"[analysis] {card}: resnet50_wm5 W=4 epochs 4+5: collectives a "
          f"step {out['resnet50']['collectives_a_step']} = Plan."
          f"collectives() + the loss mean; conservation C1-C3 bitwise on "
          f"every worker and bucket, drop_foldback red on C3 "
          f"({len(mutated['C3'])} workers); launches {launched}; "
          f"alias_coverage {coverage:.4f}, peak {peak} bytes "
          f"({out['resnet50']['s']:.1f} s); phase {out['s']:.1f} s")
    return launched


# ------------------------------------------------------------------ #
# the large layout: 2**31 slots or more on one card                  #
# ------------------------------------------------------------------ #

#: the synthetic compressed tensor beside ResNet-50, the JAX package's
#: own 64-bit test size (tests/test_flat.py): the layout passes 2**31
LARGE_W = 2 ** 31 + 128
#: elements of one chunk of the chunked plain versions: whole candidate
#: segments (32,768), 768 MiB of f32
_LARGE_CHUNK = 3 * 2 ** 26
#: half the width of the window that straddles the 32-bit limit
_LARGE_WINDOW = 2 ** 20


def _large_engines(w_numel=LARGE_W, recipe="resnet50_wm5", epoch=5):
    """The large layout and its engine: ``recipe``'s compressed tensors at
    the epoch-``epoch`` ratio, the bf16 error-feedback state, and one more
    compressed tensor ``w`` of ``w_numel`` elements (sorted first, so every
    tensor of the recipe lies past it), beside the recipe's own layout and
    engine: ``(big layout, big engine, layout, engine, compressors)``."""
    import torch
    from dgc_tpu_torch import configs
    from dgc_tpu_torch.compression.dgc import DGCCompressor
    from dgc_tpu_torch.compression.flat import FlatDGCEngine, ParamLayout
    from dgc_tpu_torch.compression.memory import DGCSGDMemory
    from dgc_tpu_torch.models import from_config
    cfg = configs.RECIPES[recipe]()
    cc = cfg.train.compression
    with torch.device("meta"):
        model = from_config(cfg.model, None)          # shapes only
    shapes = {n.replace(".", "/"): tuple(p.shape)
              for n, p in model.named_parameters()}
    conv = [n for n, s in shapes.items() if len(s) > 1]
    out = []
    for tree, names in ((dict(shapes, w=(w_numel,)), conv + ["w"]),
                        (shapes, conv)):
        comp = DGCCompressor(
            cc.compress_ratio, memory=DGCSGDMemory(
                cc.memory.momentum, nesterov=cc.memory.nesterov,
                momentum_masking=cc.memory.momentum_masking,
                dtype="bfloat16"),
            sample_ratio=cc.sample_ratio, warmup_epochs=cc.warmup_epochs,
            warmup_coeff=cc.warmup_coeff)
        comp.initialize((n, tree[n]) for n in names)
        comp.warmup_compress_ratio(epoch)
        layout = ParamLayout(tree, list(comp.attributes))
        out.append((layout, FlatDGCEngine(comp, layout), comp))
    (lay, eng, comp), (lay50, eng50, comp50) = out
    return lay, eng, lay50, eng50, (comp, comp50)


def _large_bounds(T, straddle, shift):
    """Chunk boundaries over [0, T): ``_LARGE_CHUNK`` apart up to the
    window that straddles the 32-bit limit, then the window itself
    ([straddle, shift)) and the recipe's region ([shift, T)) whole."""
    b = list(range(0, straddle, _LARGE_CHUNK)) + [straddle, shift, T]
    return list(zip(b[:-1], b[1:]))


def _chunked_equal(name, bounds, got, want):
    """``got(lo, hi)`` bitwise ``want(lo, hi)`` on every chunk of
    ``bounds``; the largest difference over the finite values."""
    err = 0.0
    for lo, hi in bounds:
        err = max(err, _check_equal(f"{name} [{lo}, {hi})", got(lo, hi),
                                    want(lo, hi)))
    return err


def _bits_window(bits, lo, hi):
    """The transmit record's words of [lo, hi) (lo a multiple of 4,096)."""
    return bits[(lo >> 12) * 128:-(-hi // 4096) * 128]


def _large_compensates(T, bounds, dtype, gen):
    """``compensate_bits`` (its 64-bit form), ``compensate_bits_cands`` and
    ``seg_top2_candidates`` launched once each over the whole [T] state of
    ``dtype`` (f32 or bf16; infinities, NaNs and -0.0 planted around the
    32-bit limit), held bitwise against their plain versions chunk by
    chunk over all of [0, T), and timed (the plain versions chunked
    alike). Returns ``{kernel: call}``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    L, dev = K.INDEX32_LIMIT, DEVICE
    nw = K.num_sent_words(T)
    g = torch.empty(T, device=dev).normal_(generator=gen)
    m = torch.empty(T, dtype=dtype, device=dev).normal_(generator=gen)
    v = torch.empty(T, dtype=dtype, device=dev).normal_(generator=gen)
    for t in (g, m, v):
        t[L - 4:L + 4] = torch.tensor([math.inf, -math.inf, math.nan, -0.0,
                                       0.0, 1.0, -2.0, 3.0])
    bits = (torch.randint(-2 ** 31, 2 ** 31, (nw,), dtype=torch.int32,
                          device=dev, generator=gen)
            & torch.randint(-2 ** 31, 2 ** 31, (nw,), dtype=torch.int32,
                            device=dev, generator=gen))
    m0, v0 = m.clone(), v.clone()
    sb = 2 * m.element_size()          # state bytes an element, read + write
    out = {}
    checked = (f"bitwise over [0, T) in {len(bounds)} chunks (the window "
               f"[{bounds[-2][0]}, {bounds[-2][1]}) across the 32-bit "
               f"limit; [{bounds[-1][0]}, {T}), ResNet-50's, whole)")

    def plain_comp(lo, hi):
        return K.compensate_bits_plain(g[lo:hi], m0[lo:hi], v0[lo:hi],
                                       _bits_window(bits, lo, hi), 0.9,
                                       False, True)
    K.compensate_bits(g, m, v, bits, 0.9, False, True)
    err = _chunked_equal(f"compensate_bits 64-bit {dtype}", bounds,
                         lambda lo, hi: (m[lo:hi], v[lo:hi]), plain_comp)
    bound_ms, bound_by = _bound((4 + 2 * sb) * T + 4 * nw, 5 * T)
    out["compensate_bits"] = dict(
        shape=[T], max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, checked=checked, **_large_times(
            lambda: K.compensate_bits(g, m, v, bits, 0.9),
            lambda: [plain_comp(lo, hi) for lo, hi in bounds]))

    m0.copy_(m)
    v0.copy_(v)

    def plain_cands(lo, hi):
        mm, vv, cv, cb = K.compensate_bits_cands_plain(
            g[lo:hi], m0[lo:hi], v0[lo:hi], _bits_window(bits, lo, hi), 0.9,
            True, True)
        return mm, vv, cv, cb
    _, _, cv, cb = K.compensate_bits_cands(g, m, v, bits, 0.9, True, True)
    span = K.SEG_SPAN

    def got_cands(lo, hi):
        s0, s1 = lo // span, lo // span + (hi - lo) // span
        return m[lo:hi], v[lo:hi], cv[s0:s1], cb[s0:s1]
    err = _chunked_equal(f"compensate_bits_cands 64-bit {dtype}", bounds,
                         got_cands, plain_cands)
    # the candidates: 2 KB a segment
    bound_ms, bound_by = _bound((4 + 2 * sb) * T + 4 * nw
                                + 2048 * (T // span), 5 * T)
    out["compensate_bits_cands"] = dict(
        shape=[T], max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, checked=checked, **_large_times(
            lambda: K.compensate_bits_cands(g, m, v, bits, 0.9, True, True),
            lambda: [plain_cands(lo, hi) for lo, hi in bounds]))
    del m0, v0, cv, cb

    # the standalone candidates over the whole velocity: rows of two
    # segments, so every bucket-local column fits its int32
    cols = 2 * span
    rows = T // cols
    vals, ccol = K.seg_top2_candidates(v, 0, rows, cols)

    def rows_of(lo, hi):
        return lo // cols, min(hi // cols, rows)
    err = _chunked_equal(
        f"seg_top2_candidates 64-bit {dtype}", bounds,
        lambda lo, hi: (vals[slice(*rows_of(lo, hi))],
                        ccol[slice(*rows_of(lo, hi))]),
        lambda lo, hi: K.seg_top2_candidates_plain(
            v, rows_of(lo, hi)[0] * cols, max(0, rows_of(lo, hi)[1]
                                              - rows_of(lo, hi)[0]), cols))
    nseg = rows * cols // span
    bound_ms, bound_by = _bound(m.element_size() * rows * cols
                                + 2048 * nseg, 3 * rows * cols)
    out["seg_top2_candidates"] = dict(
        shape=[rows, cols], max_abs_err=err, bound_ms=bound_ms,
        bound_by=bound_by, checked=checked, **_large_times(
            lambda: K.seg_top2_candidates(v, 0, rows, cols),
            lambda: [K.seg_top2_candidates_plain(v, a * cols, b - a, cols)
                     for a, b in (rows_of(lo, hi) for lo, hi in bounds)
                     if b > a],
            lambda: v[:rows * cols].view(nseg, 256, 128).float().abs()
            .topk(2, dim=1)))
    del vals, ccol, g, m, v, bits
    torch.cuda.empty_cache()
    return out


def _large_times(kernel, plain, library=None):
    """``ms``, ``plain_ms`` (and ``library_ms``) at the large layout's
    sizes: 3 calls after a warm-up, the chunked plain version once."""
    out = {"ms": _device_ms(kernel, reps=3, warmup=1),
           "plain_ms": _device_ms(plain, reps=1, warmup=0)}
    if library is not None:
        out["library_ms"] = _device_ms(library, reps=3, warmup=1)
    return out


def _retime_compensates32(T, dtype, gen):
    """The device ms of ``compensate_bits`` and ``compensate_bits_cands``
    at a T under 2**31 (their 32-bit launches), state of ``dtype``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    g = torch.randn(T, device=DEVICE, generator=gen)
    m, v = (torch.randn(T, device=DEVICE, generator=gen).to(dtype)
            for _ in range(2))
    bits = torch.zeros(K.num_sent_words(T), dtype=torch.int32,
                       device=DEVICE)
    out = _timed(
        compensate_bits=lambda: K.compensate_bits(g, m, v, bits, 0.9),
        compensate_bits_cands=lambda: K.compensate_bits_cands(
            g, m, v, bits, 0.9, True, True))
    del g, m, v, bits
    return out


#: the kernels a layout of 2**31 slots or more meets at 64-bit offsets:
#: route, source, the TPU kernel it replaces, and how it got there
_LARGE_KERNELS = {
    "compensate_bits": ("triton", "dgc_tpu_torch/ops/kernels.py",
                        "dgc_tpu/ops/kernels.py:527",
                        "the INDEX64 instantiation"),
    "compensate_bits_cands": ("cuda", "dgc_tpu_torch/csrc/seg_top2.cu",
                              "dgc_tpu/ops/kernels.py:1265",
                              "one form, 64-bit offsets"),
    "seg_top2_candidates": ("cuda", "dgc_tpu_torch/csrc/seg_top2.cu",
                            "dgc_tpu/ops/kernels.py:1130",
                            "one form, 64-bit offsets"),
    "topk_rows": ("cuda", "dgc_tpu_torch/csrc/topk_rows.cu",
                  "dgc_tpu/ops/kernels.py:739",
                  "one form, 64-bit row bases"),
    "apply_rows": ("cuda", "dgc_tpu_torch/csrc/apply_rows.cu",
                   "dgc_tpu/ops/kernels.py:1743",
                   "the apply_rows_launch64 instantiation"),
    "opaque_view_from": ("cuda", "dgc_tpu_torch/csrc/opaque_copy.cu",
                         "dgc_tpu/ops/kernels.py:1872",
                         "one form, a pointer past 2**31 elements")}


def _large_entries(held, counts64):
    """The kernels line's entries of the 64-bit forms (the bf16 state's
    compensates, the large path's, as their head; the f32 state beside):
    ``launches`` are the large path's 64-bit launches."""
    entries = {}
    for kernel, (route, source, replaces, form) in _LARGE_KERNELS.items():
        by = held[kernel]
        head = by.get("bfloat16", by["float32"])
        name = f"{kernel} int64"
        entries[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            form=form, launches=counts64[kernel], launches_path="large_layout",
            max_abs_err=max(c["max_abs_err"] for c in by.values()),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            library_ms=head.get("library_ms"), shape=head["shape"],
            of="the large layout (T = 2**31 + ResNet-50)",
            **({"float32": {k: by["float32"][k] for k in (
                "ms", "plain_ms", "bound_ms")}} if "bfloat16" in by else {}))
    return entries


def _large_topk(eng, gen):
    """``topk_rows`` on the 3-D fallback's candidate rows of the large
    bucket (the [rows x 128, cols / 128] view, 2**31 elements or more):
    one launch over the whole input, every row held bitwise against the
    plain version a block of rows at a time, timed beside ``torch.topk``."""
    import torch
    from dgc_tpu_torch.compression.flat import lane_quota
    from dgc_tpu_torch.ops import kernels as K
    L = K.INDEX32_LIMIT
    w0 = eng.buckets[0]
    if eng._sel3d[0]:
        R, C = w0.rows * 128, w0.cols // 128
        k = lane_quota(w0.cols, w0.max_sel)
    else:                          # a rehearsal's small stand-in
        R, C, k = 256, L // 256 + 2, 66
    x = torch.empty(R, C, device=DEVICE).uniform_(generator=gen)
    vals, cols = K.topk_rows(x, k)
    rb = max(1, _LARGE_CHUNK // C)
    blocks = [(r, min(r + rb, R)) for r in range(0, R, rb)]
    err = _chunked_equal("topk_rows 64-bit", blocks,
                         lambda a, b: (vals[a:b], cols[a:b]),
                         lambda a, b: K.topk_rows_plain(x[a:b], k))
    bound_ms, bound_by = _bound(4 * R * C + 8 * R * k, 2 * R * C)
    out = dict(shape=[R, C], k=k, max_abs_err=err, bound_ms=bound_ms,
               bound_by=bound_by, checked=(
                   f"every row bitwise, {len(blocks)} blocks of {rb} rows "
                   f"(row {L // C} straddles the 32-bit limit)"),
               **_large_times(lambda: K.topk_rows(x, k),
                              lambda: [K.topk_rows_plain(x[a:b], k)
                                       for a, b in blocks],
                              lambda: torch.topk(x, k, dim=1)))
    del x, vals, cols
    torch.cuda.empty_cache()
    return out


def _large_payload(T, shift, S, n_w, n_r, gen, lo=None, hi=None):
    """A W=2 gathered payload over [0, T): each worker's distinct
    coordinates, ``n_w`` over [0, shift) and ``n_r`` over [shift, T) (or
    all in [lo, hi)), worker 1 sharing half of worker 0's; pads on the
    sentinel ``S``, zeros, -0.0 and out-of-range entries planted, worker
    0's real entries flagged. ``(values, int64 indices, flags)``."""
    import torch
    dev = DEVICE

    def spread(a, b, n):
        stride = (b - a) // n
        return a + torch.arange(n, device=dev) * stride + torch.randint(
            0, stride, (n,), device=dev, generator=gen)
    if lo is None:
        w0 = torch.cat([spread(0, shift, n_w), spread(shift, T, n_r),
                        torch.arange(T - 2048, T, 64, device=dev)])
    else:
        w0 = spread(lo, hi, n_w + n_r)
    half = w0.numel() // 2
    w1 = torch.cat([w0[:half], spread(0 if lo is None else lo,
                                      T if lo is None else hi,
                                      w0.numel() - half)])
    pads = torch.full((64,), S, device=dev)
    odd = torch.tensor([-1, T, T + 5, 2 ** 33], device=dev)
    idx = torch.cat([w0, pads, w1, pads, odd])
    vals = torch.empty(idx.numel(), device=dev).normal_(generator=gen)
    vals[::101] = 0.0
    vals[1::211] = -0.0
    vals[idx == S] = 0.0               # the engine's pads carry +0.0
    flags = torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
    flags[:w0.numel()] = True
    return vals, idx, flags


def _large_apply(T, shift, S, payload, win, gen):
    """``apply_rows``' 64-bit instantiation over [T]: a W=2 payload the
    size of the large path's, held bitwise whole against the plain version
    (the sums and the record), then a payload inside the window that
    straddles the 32-bit limit, after which everything outside the window
    is +0.0 and its record words 0, and the window the plain version's;
    timed beside ``index_add_``."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    L = K.INDEX32_LIMIT
    n_w, n_r = payload
    vals, idx, flags = _large_payload(T, shift, S, n_w, n_r, gen)
    plan = K.apply_plan(idx.numel(), T)
    got = K.apply_rows(vals, idx, flags, T, 2.0)
    want = K.apply_rows_plain(vals, idx, flags, T, 2.0)
    err = _check_equal("apply_rows 64-bit", got, want)
    del got, want
    lo, hi = L - win, L + win
    wv, wi, wf = _large_payload(T, shift, S, n_w // 8, 0, gen, lo, hi)
    acc, bits = K.apply_rows(wv, wi, wf, T, 2.0)
    outside = (int(torch.count_nonzero(acc.view(torch.int32)[:lo]))
               + int(torch.count_nonzero(acc.view(torch.int32)[hi:]))
               + int(torch.count_nonzero(bits[:(lo >> 12) * 128]))
               + int(torch.count_nonzero(bits[(hi >> 12) * 128:])))
    if outside:
        raise AssertionError(f"apply_rows 64-bit: {outside} words changed "
                             f"outside the window [{lo}, {hi})")
    inside = (wi >= lo) & (wi < hi)
    err = max(err, _check_equal(
        "apply_rows 64-bit window", (acc[lo:hi], _bits_window(bits, lo, hi)),
        K.apply_rows_plain(wv[inside], wi[inside] - lo, wf[inside],
                           hi - lo, 2.0)))
    del acc, bits, wv, wi, wf, inside
    n = idx.numel()
    ilong, half = idx.long().clamp(0, T - 1), vals / 2.0
    bound_ms, bound_by = _bound(9 * n + 4 * T + 4 * K.num_sent_words(T),
                                2 * n)
    out = dict(shape=[n], total=T, route=plan.route, cap=plan.cap,
               scratch_bytes=plan.scratch_bytes, max_abs_err=err,
               bound_ms=bound_ms, bound_by=bound_by, checked=(
                   f"bitwise whole (sums and record); a payload inside "
                   f"[{lo}, {hi}) changed nothing outside it"),
               **_large_times(
                   lambda: K.apply_rows(vals, idx, flags, T, 2.0),
                   lambda: K.apply_rows_plain(vals, idx, flags, T, 2.0),
                   lambda: torch.zeros(T, device=DEVICE).index_add_(
                       0, ilong, half)))
    del vals, idx, flags, ilong, half
    torch.cuda.empty_cache()
    return out


def _large_opaque(lay, gen):
    """``opaque_view_from`` on a flat [P] buffer at the guarded weights
    past the 32-bit limit and at a window straddling it, bitwise ``clone``
    of the slice."""
    import torch
    from dgc_tpu_torch.ops import kernels as K
    L = K.INDEX32_LIMIT
    flat = torch.empty(lay.total, device=DEVICE).normal_(generator=gen)
    cases = [(lay.offsets[n], lay.sizes[n])
             for n in sorted(lay.convert_hoist_risky())
             if K.opaque_view_eligible(lay.total, lay.offsets[n],
                                       lay.sizes[n])]
    cases.append((L - 2 ** 16, 2 ** 17))
    err = max(_check_equal(f"opaque_view_from 64-bit at {b}",
                           (K.opaque_view_from(flat, b, n),),
                           (K.opaque_view_from_plain(flat, b, n),))
              for b, n in cases)
    b, n = cases[-1]
    bound_ms, bound_by = _bound(8 * n, 0)
    out = dict(shape=[n], base=b, cases=len(cases), max_abs_err=err,
               bound_ms=bound_ms, bound_by=bound_by, checked=(
                   f"bitwise at {len(cases)} slices (the guarded weights "
                   f"past the 32-bit limit, one across it at {b})"),
               **_timed(
                   ms=lambda: K.opaque_view_from(flat, b, n),
                   plain_ms=lambda: K.opaque_view_from_plain(flat, b, n),
                   library_ms=lambda: flat[b:b + n].clone()))
    del flat
    torch.cuda.empty_cache()
    return out


def _fill_named(flat, lay, gen, std):
    """Each named tensor's region of ``flat`` drawn ~N(0, std) in place;
    the gaps and row tails stay as they are (zeros)."""
    for name in lay.names:
        o = lay.offsets[name]
        flat[o:o + lay.sizes[name]].normal_(0.0, std, generator=gen)


def _large_steps(lay, eng, comp, phases, grads_fn, steps, probe=None):
    """``steps`` exchange-and-update steps of W=2 workers through the
    flat entry point (``DistributedOptimizer.update_flat``, ``dgc_sgd``)
    from seeded parameters, each worker's gradient from ``grads_fn(step,
    worker, flat)``; under a recorder with ``probe`` where given.
    Returns ``(params, memories, last exchanged gradient, step seconds)``."""
    import torch
    from dgc_tpu_torch.analysis import program
    from dgc_tpu_torch.optim.distributed import DistributedOptimizer
    from dgc_tpu_torch.optim.sgd import dgc_sgd
    from dgc_tpu_torch.parallel.comm import LocalComm
    opt = DistributedOptimizer(dgc_sgd(0.1, momentum=0.9), comp,
                               LocalComm(2))
    params = grads_fn(-1, 0, torch.zeros(lay.total, device=DEVICE))
    opt_state = opt.init(params)
    mems = [eng.init_memory(DEVICE) for _ in range(2)]
    grads = [torch.zeros(lay.total, device=DEVICE) for _ in range(2)]
    secs, last = [], None
    for step in range(steps):
        for w, g in enumerate(grads):
            grads_fn(step, w, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        del last
        if probe is not None:
            probe.begin_step()
            with program.Recorder(trace=False, modules=False, probe=probe):
                params, opt_state, ex = opt.update_flat(
                    grads, opt_state, params, mems, phases[step], eng)
        else:
            params, opt_state, ex = opt.update_flat(
                grads, opt_state, params, mems, phases[step], eng)
        last = ex[0]
        del ex
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    del grads
    return params, mems, last, secs


def phase_large_layout(w_numel=LARGE_W, steps=2):
    """A flat layout of 2**31 slots or more on one card (ROADMAP queue 1
    item 14): ResNet-50's compressed tensors at the epoch-5 ratio (0.001)
    beside a synthetic compressed tensor ``w`` of 2**31 + 128 elements,
    T = 2,174,683,136, the bf16 error-feedback state (the f32 state's
    peak, about 96 GB, does not fit the card):

    (a) the layout's and the engine's index dtype int64, and the apply fed
        the int64 wire;
    (b) every kernel that meets offsets past 2**31 held bitwise against its
        plain version over all of [0, T), chunk by chunk (a window that
        straddles 2**31 and ResNet-50's region whole among the chunks):
        ``compensate_bits``' 64-bit form, ``compensate_bits_cands`` and
        ``seg_top2_candidates`` at f32 and bf16 state; ``topk_rows`` on the
        3-D fallback's [65536, 32770] candidate rows of ``w``;
        ``apply_rows``' 64-bit form on a W=2 payload of the path's size,
        and on one inside the straddling window, outside which nothing
        changes; ``opaque_view_from`` at the guarded weights past 2**31
        and across it;
    (c) W=2 workers (``LocalComm``) take ``steps`` exchange-and-update
        steps through ``DistributedOptimizer.update_flat``, gradients drawn
        on the card from a seeded generator, under the conservation probe
        (copies kept on the host): C1-C3 bitwise on every worker and
        bucket; the path's launches (``compensate_bits_cands``,
        ``topk_rows``, ``apply_rows``, all at 64-bit offsets) counted;
    (d) ResNet-50's slice of the parameters, the exchanged gradient and
        the memory bitwise the ResNet-50-only layout's, fed the same
        gradients and draws (the bucket partition and the draws printed
        equal);
    (e) device times against their bounds, the 32-bit forms of the
        compensates re-timed at ResNet-50's T beside them, and the peak
        allocated memory, with the card's name and power limit.
    Returns the 64-bit forms' kernel entries."""
    import gc

    import torch
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # the path's [T]-sized buffers come and go in several sizes near the
    # card's capacity: segments that grow, so a freed block's tail is not
    # stranded (the setting the allocator reads for new segments; back off
    # after the phase)
    settings = getattr(torch.cuda.memory, "_set_allocator_settings", None)
    if settings is not None and DEVICE != "cpu":
        settings("expandable_segments:True")
    try:
        return _large_layout(w_numel, steps, t_start)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        if settings is not None and DEVICE != "cpu":
            settings("expandable_segments:False")


def _large_layout(w_numel, steps, t_start):
    """The body of :func:`phase_large_layout`."""
    import gc

    import torch
    from dgc_tpu_torch.analysis import verify
    from dgc_tpu_torch.ops import kernels as K
    card = _card_name()
    L = K.INDEX32_LIMIT
    lay, eng, lay50, eng50, (comp, comp50) = _large_engines(w_numel)
    T, S, shift = eng.T, lay.sentinel, eng.buckets[1].base
    # (a) the index dtypes, from shapes alone
    if not (lay.index_dtype == eng.index_dtype == torch.int64
            and T >= L and shift >= L):
        raise AssertionError(f"large layout: T {T}, index dtypes "
                             f"{lay.index_dtype} / {eng.index_dtype}")
    seen = []
    apply_rows = K.apply_rows

    def spy(values, indices, *a, **k):
        seen.append(indices.dtype)
        return apply_rows(values, indices, *a, **k)
    out = {"card": card, "T": T, "total": lay.total, "shift": shift,
           "payload_per_worker": eng.payload_size,
           "w_bucket": [eng.buckets[0].rows, eng.buckets[0].cols],
           "w_route": "sel3d" if eng._sel3d[0] else (
               "seg" if eng._seg[0] else "2d")}
    print(f"[large] {card}: T {T} (total {lay.total}), ResNet-50 from "
          f"{shift}, payload {eng.payload_size} a worker, w "
          f"{out['w_bucket']} on the {out['w_route']} route; index dtype "
          f"{lay.index_dtype} / wire {eng.index_dtype}")

    # (b) the kernels at 64-bit offsets
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    win = min(_LARGE_WINDOW, L // 4)
    bounds = _large_bounds(T, L - win, shift)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    held = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, c in _large_compensates(T, bounds, dtype, gen).items():
            held.setdefault(name, {})[str(dtype)[6:]] = c
    held["topk_rows"] = {"float32": _large_topk(eng, gen)}
    held["apply_rows"] = {"float32": _large_apply(
        T, shift, S, (eng.buckets[0].payload, eng50.payload_size), win,
        gen)}
    held["opaque_view_from"] = {"float32": _large_opaque(lay, gen)}
    out["holds_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["holds_s"] = time.perf_counter() - t
    for name, by in held.items():
        for dt, c in by.items():
            print(f"[large] {name} 64-bit ({dt}) {c['shape']}: "
                  f"{c['checked']}; {c['ms']:.4f} ms (plain "
                  f"{c['plain_ms']:.4f}, bound "
                  f"{c['bound_ms']:.4f} by {c['bound_by']}"
                  + (f", library {c['library_ms']:.4f}"
                     if c.get("library_ms") is not None else "") + ")")
    # the 32-bit forms at ResNet-50's T, in the same call
    g50 = torch.Generator(device=DEVICE).manual_seed(50)
    re32 = {str(dt)[6:]: _retime_compensates32(eng50.T, dt, g50)
            for dt in (torch.float32, torch.bfloat16)}
    out["retime_32bit_resnet50"] = re32
    print(f"[large] 32-bit forms at ResNet-50's T {eng50.T}: " + "; ".join(
        f"{dt} compensate_bits {r['compensate_bits']:.4f} ms, "
        f"compensate_bits_cands {r['compensate_bits_cands']:.4f} ms"
        for dt, r in re32.items()))

    # (c) the path: W=2 through update_flat under the probe
    gen_w = torch.Generator().manual_seed(7)
    gen_r = torch.Generator().manual_seed(8)
    phases, phases50 = [], []
    for _ in range(steps):
        big, small = [], []
        for _w in range(2):
            bd, sd = eng.draw_phases(gen_w), eng50.draw_phases(gen_r)
            big.append([bd[0]] + sd)
            small.append(sd)
        phases.append(big)
        phases50.append(small)
    same_draws = all(b[1:] == s for pb, ps in zip(phases, phases50)
                     for b, s in zip(pb, ps))
    same_buckets = [(b.base - shift, b.rows, b.cols, b.payload, b.max_sel)
                    for b in eng.buckets[1:]] == [
        (b.base, b.rows, b.cols, b.payload, b.max_sel) for b in eng50.buckets]
    print(f"[large] ResNet-50's bucket partition the same in both layouts: "
          f"{same_buckets}; its sampling draws the same: {same_draws}")
    saved = {}
    g_path = torch.Generator(device=DEVICE).manual_seed(5)

    def grads_big(step, w, flat):
        _fill_named(flat, lay, g_path, 0.05 if step < 0 else 1e-3)
        saved[(step, w)] = flat[shift:].clone()
        return flat
    probe = verify.ConservationProbe(store="cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.apply_rows = spy
    try:
        _zero_counts()
        params, mems, ex, secs = _large_steps(lay, eng, comp, phases,
                                              grads_big, steps, probe)
        counts = _read_counts("large layout",
                              ["compensate_bits_cands", "topk_rows",
                               "apply_rows", "sel3d"])
        counts64 = dict(K.LAUNCHES64)
    finally:
        K.apply_rows = apply_rows
    peak = torch.cuda.max_memory_allocated()
    # (the plain versions a CPU rehearsal runs count no launch)
    if set(seen) != {torch.int64} or DEVICE != "cpu" and not all(
            counts64[k] for k in ("compensate_bits_cands", "topk_rows",
                                  "apply_rows")):
        raise AssertionError(f"large layout: the apply got {set(seen)}, "
                             f"64-bit launches {counts64}")
    # the next compensate's input: the velocity the next step would read
    probe.begin_step()
    for mem in mems:
        probe.on_tag("dgcver.src.residual", mem["velocities_c"])
    conserve = [probe.check(eng, s) for s in range(steps)]
    if any(any(c.values()) for c in conserve):
        raise AssertionError(f"large layout: conservation {conserve}")
    keep = {"params": params[shift:].clone(), "ex": ex[shift:].clone(),
            "mems": [{k: (v[shift:] if k.endswith("_c") else
                          v[(shift >> 12) * 128:] if k == "sent_bits"
                          else v).clone() for k, v in m.items()}
                     for m in mems]}
    finite = bool(torch.isfinite(params).all())
    del params, mems, ex, probe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[large] W=2, {steps} steps through update_flat: "
          + ", ".join(f"{s:.3f}" for s in secs) + " s; launches "
          f"compensate_bits_cands {counts['compensate_bits_cands']}, "
          f"topk_rows {counts['topk_rows']}, apply_rows "
          f"{counts['apply_rows']} (64-bit: {counts64}); the apply fed "
          f"{sorted(str(d) for d in set(seen))}; conservation C1-C3 "
          f"bitwise on both workers, every bucket; parameters finite "
          f"{finite}; peak allocated {peak} B ({peak / 2 ** 30:.2f} GiB)")
    if not finite:
        raise AssertionError("large layout: non-finite parameters")

    # (d) ResNet-50 alone, fed the same gradients and draws
    def grads_small(step, w, flat):
        flat.copy_(saved[(step, w)])
        return flat
    p50, m50, ex50, _ = _large_steps(lay50, eng50, comp50, phases50,
                                     grads_small, steps)
    _check_equal("large layout: ResNet-50's parameters", (keep["params"],),
                 (p50,))
    _check_equal("large layout: ResNet-50's exchanged gradient",
                 (keep["ex"],), (ex50,))
    for w, (mb, ms) in enumerate(zip(keep["mems"], m50)):
        _check_equal(f"large layout: ResNet-50's memory, worker {w}",
                     [mb[k] for k in sorted(ms)], [ms[k] for k in sorted(ms)])
    print("[large] ResNet-50's parameters, exchanged gradient and memory "
          "bitwise the ResNet-50-only layout's")
    del p50, m50, ex50, keep, saved
    torch.cuda.empty_cache()
    out.update(same_buckets=same_buckets, same_draws=same_draws,
               step_s=secs, launches=counts, launches64=counts64,
               peak_bytes=peak, held=held, s=time.perf_counter() - t_start)
    DETAIL["large_layout"] = out
    print(f"[large] phase {out['s']:.1f} s on {card}")
    return _large_entries(held, counts64)


def _clock_phases():
    """Time every outermost ``phase_*`` call into ``DETAIL["phase_s"]``
    (by phase, summed over its calls): where the run's time goes."""
    spent, depth = DETAIL.setdefault("phase_s", {}), [0]
    for name, fn in list(globals().items()):
        if not (name.startswith("phase_") and callable(fn)):
            continue

        def timed(*a, _fn=fn, _name=name, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    spent[_name] = spent.get(_name, 0.0) + (
                        time.perf_counter() - t0)
        globals()[name] = functools.wraps(fn)(timed)
    return spent


def main(argv):
    global OLD_TOPK_SRC, OLD_COPY_SRC, OLD_CANDS_SRC, OLD_SELECT_SRC
    global OLD_COMPENSATE_SRC, OLD_LADDER_SRC
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dgc_tpu_torch.utils.device import set_reproducible_numerics
    set_reproducible_numerics()
    flags = {"--old-src": "OLD_TOPK_SRC", "--old-copy-src": "OLD_COPY_SRC",
             "--old-cands-src": "OLD_CANDS_SRC",
             "--old-select-src": "OLD_SELECT_SRC",
             "--old-compensate-src": "OLD_COMPENSATE_SRC",
             "--old-ladder-src": "OLD_LADDER_SRC"}
    for flag, name in flags.items():
        if flag in argv:
            globals()[name] = argv[argv.index(flag) + 1]
    t_start = time.perf_counter()
    spent = _clock_phases()
    _share_datasets()
    phase_build()
    # first, on the empty card: a layout of 2**31 slots or more
    large = phase_large_layout()
    geoms = _geometries()
    geoms50_all = _geometries("resnet50_wm5")
    geoms50 = {e: geoms50_all[e] for e in (0, 5)}
    geoms110 = _geometries("resnet110_wm5", (0, 5))
    geoms_vgg = _geometries("vgg16_bn_wm5", (0, 1, 4, 5))
    entries = phase_kernels({"resnet20": geoms, "resnet50": geoms50,
                             "resnet110": geoms110, "vgg16_bn": geoms_vgg})
    entries.update(phase_seg_kernels(geoms50, geoms_vgg))
    entries.update(phase_opaque_kernels(geoms, geoms50))
    entries["opaque_view_from"]["retime"] = phase_opaque_retime()
    both = dict(megakernel=True, fused_select=True)
    entries.update(phase_select_kernels(
        _geometries("resnet20_wm5", (3, 4, 5), **both),
        _geometries("resnet50_wm5", (3, 4, 5), **both)))
    entries.update(phase_compensate_ladder_kernels(
        geoms, geoms50, [(f"{m} epoch {e}", g[e][1])
                         for m, g in (("resnet20", geoms),
                                      ("resnet110", geoms110))
                         for e in (5, 0)]))
    for name, d in phase_bf16_kernels(geoms, geoms50_all).items():
        if name != "topk_rows":
            entries[name]["bf16"] = {
                model: {k: c[k] for k in ("shape", "ms", "plain_ms",
                                          "f32_ms", "bound_ms",
                                          "f32_bound_ms", "max_abs_err")}
                for model, c in d.items()}
    _print_entries(entries)
    entries.update(large)
    phase_engine_vs_cpu(geoms, "resnet20", steps=2)
    # ResNet-50's epoch 5 (the fused candidates) and ResNet-110's epoch 0
    # (the route of ResNet-20's) are held card == CPU again by
    # phase_telemetry_vs_cpu / phase_guard_vs_cpu and above
    phase_engine_vs_cpu(geoms50, "resnet50", steps=1, epochs=(0,))
    phase_engine_vs_cpu(geoms, "resnet20", steps=2, world=3)
    phase_engine_vs_cpu(geoms110, "resnet110", steps=1, epochs=(5,))
    phase_routes_vs_cpu("resnet20_wm5", "resnet20", steps=2)
    phase_routes_vs_cpu("resnet50_wm5", "resnet50", steps=1, epochs=(5,))
    phase_per_tensor_vs_cpu()
    phase_per_tensor_vs_cpu(world=3)
    phase_per_tensor_vs_flat("resnet20_wm5", "resnet20", steps=3)
    phase_per_tensor_vs_flat("resnet50_wm5", "resnet50", steps=1)
    phase_dense_vs_cpu(world=4)
    phase_dense_vs_cpu(world=3)
    phase_nonresample_vs_cpu()
    phase_clip_vs_cpu()
    # VGG's epoch 0 (the 3-D fallback, its own) over 2 workers, whose CPU
    # side applies half of W=4's 175.0M entries; the segment path at full
    # width is ResNet-50's epoch 5
    phase_engine_vs_cpu(geoms_vgg, "vgg16_bn", steps=1, world=2,
                        epochs=(0,))
    del geoms_vgg
    wire_bytes = phase_wires_vs_cpu()
    phase_run_to_run()
    common = ["topk_rows", "apply_rows", "opaque_view_from"]
    by_path = {}
    r20, by_path["resnet20"] = phase_train_path(
        "resnet20", "resnet20_wm5", [(0, 2), (5, 2)],
        common + ["compensate_bits", "opaque_view"])
    by_path["masked_check"] = phase_masked_check(r20)
    r50, by_path["resnet50"] = phase_train_path(
        "resnet50", "resnet50_wm5", [(0, 1), (5, 3)],
        common + ["compensate_bits", "compensate_bits_cands", "lax_top_k"])
    by_path["standalone_candidates"] = phase_standalone_candidates(geoms50)
    slice_label = "resnet50_bf16mem_int8_packidx"
    by_path[slice_label] = phase_slice_path()[1]
    by_path["resnet20_autotune"] = phase_autotune()
    by_path["resnet20_megakernel"] = phase_train_path(
        "resnet20_megakernel", "resnet20_wm5_megakernel", [(3, 2), (5, 2)],
        ["dgc_forward_rows", "compensate_bits", "apply_rows"])[1]
    by_path["resnet20_fused_select"] = phase_train_path(
        "resnet20_fused_select", "resnet20_wm5", [(3, 2), (5, 1)],
        ["select_pack_rows"], fused_select=True)[1]
    by_path["resnet50_megakernel"] = phase_train_path(
        "resnet50_megakernel", "resnet50_wm5_megakernel", [(3, 1), (5, 2)],
        ["dgc_forward_rows", "seg_top2_candidates", "apply_rows"])[1]
    by_path["resnet20_per_tensor"] = phase_per_tensor_path()
    exchange = ["compensate_bits", "topk_rows", "apply_rows"]
    r110, by_path["resnet110_wm5o"] = phase_train_path(
        "resnet110_wm5o", "resnet110_wm5o", [(4, 2), (5, 2)], exchange,
        epoch_rules={4: ((), exchange), 5: (exchange, ())})
    phase_evaluate(r110, "resnet110_wm5o")
    del r110
    by_path["resnet20_dense"] = phase_train_path(
        "resnet20_dense", "resnet20", [(0, 2)], [],
        epoch_rules={0: ((), _DGC_KERNELS)})[1]
    by_path["resnet20_nonresample"] = phase_train_path(
        "resnet20_nonresample", "resnet20_wm5", [(5, 2)],
        exchange + ["ladder_counts"], resample=False,
        strided_sample=False)[1]
    by_path["ladder_check"] = phase_ladder_check(
        [(f"resnet20 epoch {e}", g[1]) for e, g in geoms.items()]
        + [(f"resnet50 epoch {e}", g[1]) for e, g in geoms50_all.items()])
    if "--profile" in argv:
        phase_profile(r20, "resnet20")
        phase_profile(r50, "resnet50")
    del r20, r50
    # the gossip slice's CPU rounds run on a thread while the VGG paths
    # (bound by the card and the checkpoint's disk) run
    gossip_cpu = start_gossip_cpu()
    by_path.update(phase_vgg_paths("--profile" in argv))
    resume = ["topk_rows", "apply_rows", "opaque_view_from"]
    cifar = resume + ["compensate_bits", "opaque_view"]
    phase_resume("resnet20_wm5", "resnet20_wm5", [(4, 2), (5, 2)], cifar)
    phase_resume("resnet110_wm5o", "resnet110_wm5o", [(4, 1), (5, 1)],
                 cifar)
    # at epoch 5 every ResNet-50 compensate emits the segment candidates
    phase_resume("resnet50_wm5", "resnet50_wm5", [(4, 1), (5, 1)],
                 resume + ["compensate_bits_cands"])
    # the slice's path: the bf16 state and the int8 error feedback
    phase_resume("resnet50_wm5_bf16mem_int8_packidx",
                 "resnet50_wm5_bf16mem_int8_packidx", [(4, 1), (5, 1)],
                 resume + ["compensate_bits_cands"])
    # the resilience slice: guards, checksum, faults, preemption, elastic
    # restarts, two tiers and Adasum
    counts_cpu = phase_guard_vs_cpu()
    by_path["resnet50_resilience"] = phase_resilient_path(counts_cpu)
    phase_twotier_adasum_vs_cpu()
    by_path["resnet50_twotier"] = phase_train_path(
        "resnet50_twotier", "resnet50_wm5_twotier", [(4, 1), (5, 2)],
        resume + ["compensate_bits", "compensate_bits_cands"],
        train={"num_local_workers": 2})[1]
    by_path["resnet20_adasum"] = phase_train_path(
        "resnet20_adasum", "resnet20_wm5", [(5, 2)], exchange,
        adasum=True)[1]
    phase_train_path("resnet20_adasum_w3", "resnet20_wm5", [(5, 2)],
                     exchange, adasum=True, world=3)
    # the telemetry slice: the step taps card == CPU, the main path with
    # the sink, the syncs, the attribution, and the adaptive exchange
    phase_telemetry_vs_cpu()
    by_path["resnet50_telemetry"] = phase_telemetry_path()
    by_path["resnet50_adaptive"] = phase_adaptive_path()
    # the serving slice: the delta stream at ResNet-50 and cohort surgery
    by_path["resnet50_serving"], serving_topk = phase_serving_path()
    entries["topk_rows"]["serving"] = serving_topk
    phase_surgery_drill()
    phase_elastic()
    phase_preempt_drill("resnet20_wm5_resilience", "resnet20",
                        ["--epochs", "1", "--steps", "4"], kill=2)
    phase_preempt_drill("resnet50_wm5_resilience", "resnet50",
                        ["--epochs", "1", "--steps", "2",
                         "--synthetic-size", "256"], kill=1)
    # the control slice: the plane supervising the trainer on the card
    phase_control_drill()
    # the gossip slice: ring and hypercube rounds on the flat engine
    by_path["resnet50_gossip"] = phase_gossip_path(gossip_cpu)
    # the analysis slice: lints, model checker, contracts, conservation
    phase_analysis()
    phase_input_path(trace_inline="--profile" in argv)
    phase_crop_kernel()
    phase_process_group()
    phase_cli()
    for name, e in entries.items():
        if name in large:
            continue            # counted on the large layout's path
        # the count of the one path that is each kernel's own
        e["launches_path"] = _OWN_PATH.get(name, "resnet50")
        e["launches"] = by_path[e["launches_path"]][name]
        # and on the slice's paths (PR 13's bf16 state; the resilient,
        # two-tier and Adasum paths)
        for path in (slice_label, "resnet50_resilience", "resnet50_twotier",
                     "resnet20_adasum", "resnet50_telemetry",
                     "resnet50_adaptive", "resnet50_serving",
                     "resnet50_gossip"):
            e[f"launches_{path}"] = by_path[path][name]
    DETAIL["launches_by_path"] = by_path
    DETAIL["wire_bytes_per_worker"] = wire_bytes
    _write_detail()
    print("[phases] " + ", ".join(
        f"{k[6:]} {v:.1f}" for k, v in sorted(spent.items(),
                                             key=lambda kv: -kv[1])[:15]))
    print("[phases] telemetry slice: " + ", ".join(
        f"{k[6:]} {spent.get(k, 0.0):.1f}" for k in (
            "phase_telemetry_vs_cpu", "phase_telemetry_path",
            "phase_adaptive_path")))
    print("[phases] serving slice: " + ", ".join(
        f"{k[6:]} {spent.get(k, 0.0):.1f}" for k in (
            "phase_serving_path", "phase_surgery_drill")))
    print(f"[phases] control slice: control_drill "
          f"{spent.get('phase_control_drill', 0.0):.1f}")
    print(f"[phases] gossip slice: gossip_path "
          f"{spent.get('phase_gossip_path', 0.0):.1f}")
    print(f"[phases] analysis slice: analysis "
          f"{spent.get('phase_analysis', 0.0):.1f}")
    print(f"[phases] large layout: large_layout "
          f"{spent.get('phase_large_layout', 0.0):.1f}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(_card_name())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
