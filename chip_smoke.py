#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stofnet_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Builds the four CUDA sources of ``stofnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), prints the build time and the card,
   and runs the canary (o = 2 x on (8, 128) f32) before any other kernel:
   it must equal ``x * 2`` bit for bit, so a failure there names the
   toolchain or the CUDA runtime, not a kernel. Its launch route is read
   three ways beside ``torch.mul``'s (the ``canary launch route`` line, us
   a call): CUDA events around one call (its kernels-line time), the host
   clock over 1,000 calls back to back with no synchronise, and the
   kernel's device time under the profiler over 100 calls.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (B=128, L=8000; JAX's ``sgb_contract_pool``
   counterpart at L_UNCHUNKED=2000, a serving length JAX's DMA kernel
   refuses; bf16 inputs from a seeded numpy generator; plain versions in
   f32 with TF32 off), with max|kernel - plain| <= 2e-2 * max|plain|, and
   times the kernel, the plain version and one PyTorch yardstick the port
   never calls (CUDA events, a different input each launch, median of
   20). Both of JAX's serving SGB kernels have one counterpart, the
   serving instantiation of the streamed kernel (``wgmma``, on the weight
   image of ``sgb_dma_weights``): its ``sgb_contract_pool`` row is timed
   at L_UNCHUNKED through ``sgb.sgb_contract_pool_prepared``, its
   ``sgb_contract_pool_dma`` row at L through
   ``sgb_dma.sgb_contract_pool_dma_prepared``. It is also held at L=800
   over 3 seeds, and bit for bit to its plain version on spike inputs at
   L=240, 800, L_UNCHUNKED and L (``sgb_dma.spike_inputs``: spikes at
   window offsets 0, 1, 78, 79 and at the sequence ends, every f32 sum
   exact, so a tap that reads one row off differs; 3 and 25 windows leave
   a masked last tile). The conv stack is also held bit for bit to
   its plain version at L and L_UNCHUNKED with weights that only shift, to
   either side (exact small integers, so a tile whose halo is a row short
   differs), and prints its tile count and its achieved TFLOP/s on the
   positions it keeps and on the rows it computes (halos included); the
   build prints every ptxas line that names ``wgmma`` (a serialized
   ``wgmma`` runs far below its rate) and the line that names each
   function (the streamed kernel's two instantiations, serving and kernel
   A, share a source).
3. The probe: ``stofnet_tpu_torch.scripts.dma_probe``'s sweep on the
   card, every point held to its total (rtol 1e-3 of the PyTorch sum), to
   each element of the plain version (64 f32 epsilons of the sum of its
   terms' magnitudes) and to the same bits twice; prints its
   ``manual_dma_bandwidth`` line.
4. Serves through ``serve.make_pipeline`` with a seeded random-init
   StofNet (different-armadillo architecture, x4) at two lengths, each
   over one warm-up batch and 2 fresh batches of 128 echo-bearing
   waveforms: at L=8000 and at L_UNCHUNKED=2000 (L % 800 != 0) the
   serving SGB kernel and the conv stack must launch once on every batch,
   and no other kernel; the counts are set to 0 before each length and
   read after it. At each length >= 0.99
   of the coords must lie within 1 sample of the plain path's (the same
   forward through the plain versions). Prints the agreement over coord
   slots and over rows with a detection, ms per batch (median of the 2),
   witnesses of where decoded positions move (the plain path on the CPU,
   the StofNet module in bf16 and in f32), and device time by kernel over
   the 2 batches served again under the profiler. Fails when the kernel
   path moves more rows against the plain path than twice those that the
   plain path moves between the card and the CPU (f32 summation order
   alone), plus 4. Then one batch of 128 at L_MODULE=1000 (L % 80 != 0),
   which the pipeline serves through the ``StofNet`` module (its module
   route): it must launch no kernel and agree with the bf16 module on
   >= 0.99 of the coord slots.
5. Holds the trainable SGB op's kernels against their plain versions at
   B=128, L=8000, F=512: kernel A (forward with argmax, the streamed
   kernel's ``wgmma`` loop on the ``sgb_dma_weights`` image) to the
   tolerance above, its offsets equal to the plain version's wherever the
   plain window maximum beats its runner-up by more than 1e-3 of its
   magnitude, and bit for bit, pooled and offsets, on spike inputs at
   L=800 and L (ties across whole windows); kernel B (backward) per
   output on kernel A's own outputs, its f32 sums (dkernel, dbias) also to
   relative L2 1e-5, and bitwise equal
   over two runs; then bit for bit to its plain version on
   ``sgb.bwd_exact_inputs`` at L=800 and L (every sum exact, offsets at the
   window seams, so a missed seam term differs). Times both as in 2
   (kernel A's yardstick: cuDNN conv + max-pool with indices + leaky;
   kernel B's: the backward of cuDNN conv + max-pool + leaky in bf16, timed
   alone), prints kernel A's device time under the profiler beside its
   bound and yardstick, with the device time of the weight image the op
   builds each step, kernel B's device time by pass and its CUDA-core
   floor beside its bound, and requires one
   forward + backward of the op to stay below the 1.05 GB of one
   (128, 8000, 512) bf16 plane of device memory.
6. The bench's paths (``bench_paths.py``) over a gate batch and 2 fresh
   batches: ``try_fused_pipeline`` (the streamed SGB kernel, the conv stack
   as plain convs) must pass its gate against the plain path on the card
   (``stofnet_apply_reference(fused_stack=False)``),
   launch the streamed kernel on every batch and not the conv-stack
   kernel, agree with the plain path on >= 0.99 of the coord
   slots, and move no more rows against it than twice those the plain path
   moves between the card and the CPU, plus 4; its agreement with the f32
   ``StofNet`` module (the bench's own gate) is printed. Then
   ``try_packed_pipeline`` (plain PyTorch, no kernel) gated on and held to
   >= 0.99 of the bf16 ``StofNet`` module's coord slots. Each path prints
   ms per batch (median of the 2), waveforms/s and device time by kernel
   under the profiler.
7. Trains: ``train.make_fused_train_step`` (bf16 forward, f32 masters,
   AdamW with the cosine schedule) on the same architecture (weights from
   the next seed) at B=128, L=8000 over seeded noise frames with two GT
   echoes per row. First the gradients of one step through the kernels
   against the same step through the plain versions on the card
   (relative L2 per parameter <= 2e-2; the plain path in bf16 against
   f32 printed beside it), then
   one warm-up step and 4 timed steps on 4 other batches: both kernels
   launch on every step, every loss is finite, and the warm-up batch's
   loss is lower after the steps. Prints ms per step (median), training
   waveforms per second, peak memory and device time by kernel over the
   4 batches trained on again under the profiler. Last, a witness: the
   same 5 steps from the serving weights, through the kernels and through
   the plain versions, with the warm-up batch's loss before and after.
From here on the script runs under PyTorch's own TF32 defaults (cuDNN's
   on, cuBLAS's off), as a daemon process serves; each plain reference
   these phases compare with computes in its own TF32-off scope
   (``ops/conv.full_f32``). First what TF32 moves: the daemon gate's batch
   (16 echo rows at L=8000, seed 3008) through the f32 ``StofNet`` module
   and the f32 int8 route with TF32 on and off (the ``tf32 rows`` line:
   rows that differ, rows moved by more than 1 sample; and one f32
   training step of the module at B, L, its loss and the relative L2 of
   each gradient with TF32 on against off); ``make_pipeline``
   in f32 must give the module's TF32-off coords bit for bit and leave the
   caller's flag on.
8. The serving daemon (``cli/serve.build``) from a checkpoint of the
   serving weights written by ``train/checkpoint.save_checkpoint``, at
   L=8000, max_batch 128, max_wait_ms 2, its dtype gate left at auto
   (the gate's agreement and verdict are printed) and every bucket warmed
   before the server binds: 8 client threads send 32 single echo-bearing
   waveforms each and one more client a batch of 128 over the s8c wire.
   Every returned row must equal ``make_pipeline``'s direct coords for it
   bit for bit (the s8c rows: on the decoded wire rows). Prints
   requests/s, p50 and p99 single-request latency, the buckets used, the
   client's stats query and the kernels' launches during the traffic
   (counts set to 0 just before it), each kernel once a batch. The gate
   must serve bf16 on these weights, and the serving SGB kernel and the
   conv stack must both launch. The daemon is shut down and drained.
9. The int8-SGB route of ``make_pipeline``, calibrated on a (128, 1,
   8000) gate batch, the launch counts set to 0 before the phase and held
   at 0 after it: served in bf16 and in f32 over a warm-up batch and 4
   timed batches (ms per batch, peak memory; device time by kernel of the
   bf16 route under the profiler). The bf16 route must equal the same
   forward with the s8 conv as K shifted products on the card bit for
   bit, and move no more rows against its CPU twin (the same bf16 int8
   forward on the CPU on the card's calibration) than twice what
   summation order moves in the bf16 ``StofNet`` module (card against
   CPU) plus 4;
   the f32 route to the f32 module on >= 0.99 of the slots (the bench's
   gate, as the JAX package's int8 test holds it). Then
   ``bench_paths.try_int8_pipeline`` must return a pipe gated against the
   twin on the calibration batch, whose coords equal the served bf16
   route's bit for bit; it prints its s8 conv's form.
10. The export phase: ``serve.export_pipeline`` at B=128, L=8000, bf16 on
   the seeded weights, a batch-polymorphic artifact (``batch="b"``), one
   at the fixed batch 128 and a weightless one (the state from its
   ``.weights.npz`` sidecar), each exported, saved and loaded on the card
   (export and load seconds, file size): on 2 fresh gate batches each must
   launch the serving SGB kernel and the conv stack once a batch through
   their custom ops and give ``make_pipeline``'s direct coords bit for
   bit; ms per batch (median of 2) beside the direct pipeline's, and the
   device time of the weight layouts the weightless program runs on every
   call. Then the daemon from two artifacts (``artifact=``, L=8000 and
   L=2000, both batch-polymorphic) under the daemon phase's traffic, half
   the clients at each length: every row bit for bit ``make_pipeline``'s,
   each kernel once a batch.
11. Train and evaluate from data through the driver a user calls,
   ``cli/main.run`` (``python -m stofnet_tpu_torch.cli.main``), under
   PyTorch's default flags, the launch counts set to 0 before the phase
   and held at 0 after it (the driver trains and evaluates the ``StofNet``
   module and the int8 route: no kernel of the port, as JAX's driver
   reaches no Pallas kernel). It writes a chirp stand-in with
   ``data/synthetic.generate_chirp_dataset`` under the gitignored
   ``build/`` (2 classes, 16 positions, 40 train and 8 test measurements
   a position, 800 IQ samples: L=8000 at the config's rf_scale_factor 10;
   1,024 train, 256 val and 256 test items; the seconds it took), and
   requires the native text loader to be built. Then, at B=128 and the
   config's defaults otherwise (f32, crop 0.75, SNR 30, th 0.5, 64 echoes,
   4 loader threads), with ``profile_dir=``: 2 epochs in f32 with
   ``export_pth=True``, the loader alone over LOADER_BATCHES batches of
   the train split (4 threads and 1), 2 epochs with ``amp=True``, and
   ``evaluate=True`` from the f32 run's checkpoint over the 2 test
   batches in f32 and with ``int8=True compute_dtype=bfloat16``. The readings come from outside the driver
   (``DriverProbe``). The profiler traces steps 2..6, all in the first
   epoch, so the times are the second epoch's, which runs with the
   profiler off: ms a train step (median), training waveforms/s end to
   end (steps x B over the loop's wall time, validation left out) and of
   the bare step, the loader's wait a step. Beside them, the median step
   by state: profiled, and unprofiled with the loader busy (its last
   batch not yet read) or idle (the last steps of an epoch). The device
   idle share and device ms by kernel come from the profiled window (the
   driver's Chrome trace); then peak memory and the summary; for
   evaluation the summary, the forward's ms a batch (the driver's own
   reading) and ``find_threshold``'s. Every loss must be finite, the
   checkpoint and the ``.pth`` written, the ``.pth`` read by
   ``load_stofnet`` equal to the run's final parameters bit for bit, and
   the first logged loss within 1e-6 relative of the same loss on the
   CPU in f32 (the initial weights on the first batch of a second loader
   with the same seed, the whole batch): the two agree exactly, and TF32
   in the step moves this loss by about 3e-5. The stand-in stays for the
   zoo phase and is removed after it.
12. The zoo phase, on the same stand-in and flags, the launch counts set
   to 0 before it and held at 0 after it (JAX's zoo reaches no Pallas
   kernel). Serving: each of the registry's seven other families (edsr,
   espcn, zonzini, unet, sincnet, kuleshov, gradpeak) from seeded random
   weights drawn on the CPU at the chirp configuration's widths (800 IQ
   samples at rf_scale_factor 10; the seconds of the draw printed),
   through ``serve.make_pipeline(model_name=...)`` on the card at B=128
   and its driver length (L=8000; the unet 32000 after its rf fold), in
   f32 and in bf16: a warm-up batch and 2 timed gate batches (ms a batch,
   waveforms/s, peak memory; the first again under the profiler, device
   time by kernel), then 4 rows of the first batch against the
   same pipeline on the CPU: in f32 >= 0.99 of the coord slots within 1
   sample (gradpeak too; moved rows printed), zonzini's ToA within 1e-4
   relative; in bf16 the agreement and ``probe_dtype_agreement`` printed,
   not held. Training: ``cli/main.run`` with ``model=<name>`` for the six
   trainable families, one f32 epoch at B=128 from fresh seeded weights
   (ms a step after the first, training waveforms/s end to end and bare,
   peak memory), then ``evaluate=True`` from its checkpoint (summary,
   forward ms a batch); gradpeak evaluates only, with its detector's
   auto threshold (``th=Null``). Every loss must be finite, the train-mode
   loss of 16 rows of the first batch from the run's initial weights
   within 1e-5 relative of the CPU's (Kuleshov in eval mode: its dropout
   draws differ between devices), and a BatchNorm family's running
   statistics moved over the epoch. Prints the phase's seconds.
13. The zoo export phase, on the zoo phase's checkpoints and flags, the
   launch counts set to 0 before it and held at 0 after it: each family
   through ``cli/export.py model=<name>`` at its zoo-phase length (L; the
   unet 32000) in f32 and bf16, batch-polymorphic, baked (Kuleshov
   weightless at ``sample_num=800``, its 1.2e9 weights in a 5 GB sidecar,
   in bf16 only: the six others run the f32 export), loaded with
   ``load_pipeline`` and served over a warm-up batch and 1 gate batch of
   B against ``make_pipeline(model_name=)`` on the
   card on the same state (under ``full_f32``, as a loaded program runs):
   every row equal bit for bit. Then the daemon at bf16 twice, from the
   checkpoint (``model=<name>``) and from the bf16 artifact
   (``artifact=``), one request of B rows each, every row the direct
   pipeline's. Prints per family export and load seconds, file and
   sidecar sizes, ms a batch beside the direct pipeline's, rows equal,
   and the phase's seconds.
14. The PALA phase: ``data/pala.generate_pala_dataset`` at
   ``scripts/pala_bmode_figure.py``'s geometry (128 channels, 1024
   samples, 3 angles, 24 frames a sequence, 2 sequences, 3 targets) under
   the work directory, then ``cli/main.run`` with ``ch_gap=32
   rf_scale_factor=10`` (L=10240, 4 channels of 8 frames a step), the
   counts set to 0 before the runs and held at 0 after them: StofNet for
   one epoch (its first loss within 1e-6 of the CPU's), its evaluation,
   one epoch each of zonzini (ZonziniNetLarge) and the unet (n_layers 10,
   L=40960) and of StofNet on a rat-named copy (the temporal filter), on
   one sequence at 4 frames a step. Then StofNet from that run's
   checkpoint serves the 192 channel rows of the evaluation's items in
   bf16 through ``make_pipeline`` (the fused route, counts from 0: both
   serving kernels once a batch, the SGB kernel's to the
   ``sgb_contract_pool`` row, since 10240 % 800 != 0) at >= 0.99 of the
   coord slots with the plain twin on the card. Last the figure's compute
   stages on sequence 0 (a 128 x 192 grid): ``svd_filter_db`` against the
   CPU's (rtol = atol = 5e-3, the threshold halfway between the 2nd and
   3rd components' levels), ``svd_filter(lo_cut=2)``, the analytic signal
   and ``bf_das_batch`` (4 frames against the CPU's at rtol = atol =
   2e-3 of the dB values, as ``tests/test_ops_pala.py`` holds it, and the
   pixels above -40 dB within 2e-3 dB; the largest error printed for
   each 20 dB band of level), each
   timed with CUDA events, and the 3 angles' DAS on precomputed tables in
   the gather form and in JAX's band-matmul form (held to each other,
   relative 1e-4) with their times and bytes.
15. The array phase, on the data phase's stand-in at StofNet's full width
   (B=128, L=8000, f32 under ``full_f32``), the launch counts set to 0
   before it and held at 0 after it (JAX's array is ``jax.vmap`` of its
   steps, which reach no Pallas kernel): ``cli/array.run`` with
   ``seeds=2`` for one epoch, each member held to the solo f32
   ``make_train_step`` from its initial weights over the batches the run
   took (an ``ArrayProbe`` around the driver's ``make_array_train_step``):
   the first loss within 1e-5 relative, the parameters after the first
   update within 1e-4 relative L2, the distance after the epoch printed;
   ``lrs=[2.5e-4,5e-4,1e-3]`` for one epoch, the three first losses equal
   (one init); ``model_files=`` the two member checkpoints (rows printed),
   and ``make_array_eval_step`` on them against each one's solo eval step
   on the test split's first 2 batches (>= 0.99 of the coord slots within
   1 sample, moved rows printed); ``th_sweep=`` 8 thresholds (rows
   printed), and ``make_threshold_sweep_step`` on the first test batch
   equal bit for bit at each threshold to ``mask2coords`` of the same
   forward; then ``scripts/bench_array.measure`` (solo B=32, 4 members x
   B=32, solo B=128 train steps, the eval step and an 8-threshold sweep at
   B=128: median CUDA-event ms after 2 warm-up calls on batches staged
   apart, peak memory), and device time by kernel of one array step beside
   its members' solo steps under the profiler, at 4 x B=32 and 2 x B=128.
   Each run prints ms a step, waveforms/s, peak memory and its summary.
16. The sweep phase: ``cli/sweep.run_sweep`` under
   ``SWEEP_OVERRIDES["chirp"]`` (batch 1, rf_scale_factor 10, etol 1) on
   the stand-in's test split, the launch counts set to 0 before it and
   held at 0 after it, one row at a time (seconds a row printed): StofNet
   from the data phase's checkpoint, in f32 and with ``int8=True``, each
   zoo phase checkpoint but Kuleshov's, gradpeak, and a prefix that is
   not there (random weights). No row may fail, the random-init row must
   carry the dagger, and ``cli/report.py run_dir=... num_recent=<rows>``
   must rebuild the table's cells from the runs' summaries (newest first;
   a summary holds no checkpoint name, so a label keeps its model, its
   dagger and its int8 mark). Prints both tables.
17. The mesh phase (``parallel/mesh.py``; one card, so dp=1 wherever the
   entry points run their own ranks), on the stand-in: ``cli/main.run
   mesh=True mesh_dp=1`` (NCCL, world size 1) for one f32 epoch beside the
   same run without a mesh, the launch counts set to 0 before the runs
   and held at 0 after them: the first loss equal bit for bit, the
   parameters after the epoch within 1e-4 relative L2 and ``val_loss``
   within rtol 1e-3; then ``evaluate=True th=Null`` (a detection in
   every row) from the run's checkpoint with and without the mesh,
   ``val_loss``, distance and Jaccard equal bit for bit. Then 2 ranks on
   the card (``parallel/mesh.launch``, both on cuda:0, gloo: NCCL takes
   one rank a card) each take 64 rows of
   one B=128 batch at L=8000 through ``scripts/dp_check``: the f32
   StofNet step and the SincNet step (BatchNorm), held to the single
   process's step on the whole batch by ``tests/test_parallel.py``'s
   rules (the loss within rtol 1e-5, 99.9 % of the parameters within
   1e-5 and all within 2 lr, SincNet's running statistics within rtol
   1e-5, atol 1e-6), every rank's parameters rank 0's bit for bit; ms a
   step for the 2 ranks against the single step, and whether gloo itself
   takes CUDA tensors (``parallel/mesh.py`` stages gloo's collectives
   through the host by rule); the same ranks then run the sp phase's two
   steps (item 18), one launch of ranks for both phases. Then the daemon with ``mesh=True
   mesh_dp=1`` in bf16 at L=8000, from the data phase's checkpoint and
   from an artifact exported from it, under the daemon phase's traffic:
   every row ``make_pipeline``'s direct coords bit for bit (the rows the
   daemon without a mesh gives, as the daemon phase holds it), both
   serving kernels once a batch, counted into the kernels line. Last
   ``cli/array.run mesh=True mesh_dp=1 seeds=2`` for one epoch: each
   member's first loss equal bit for bit to the array phase's ``seeds=2``
   run's. Prints the phase's seconds.
18. The sp phase (``parallel/seq.py``, the sp axis of
   ``parallel/mesh.py``; one card, so every shard on cuda:0), the launch
   counts set to 0 before each run and read after it: ``make_pipeline``'s
   bf16 fused route split along L by ``cli/serve._mesh_adjust`` over a
   mesh listing cuda:0 sp times, at sp = 2, 4, 8 (B=128, L=8000; 1000
   samples a shard at sp=8, whose pool windows straddle shards) and sp=8
   at L=16000, over a warm-up and 2 gate batches: both serving kernels
   launched sp times a batch and no other kernel, the coords equal to
   the single pipeline's on every row (or, failing that, >= 0.99 of the
   slots and no more moved rows than the main path's rule), ms a batch
   beside the single pipeline's, the share of positions computed twice;
   one batch at L=1000 at sp=2 (the module route on every shard, no
   kernel) against the bf16 module at >= 0.99 of the slots. Then 2 gloo
   ranks on cuda:0 at dp=1, sp=2 (``scripts/dp_check``, run by the mesh
   phase's ranks): the f32 and amp StofNet steps at B=128, L=8000 against
   the single process's, by
   ``tests/test_parallel.py``'s rules (f32: loss rtol 1e-5, 99.9 % of the
   parameters within 1e-5, all within 2 lr; amp: rtol 1e-2, 99 % within
   1e-4), ms a step beside the single step's. Then the daemon at
   ``mesh=True mesh_sp=2`` from the data phase's checkpoint (bf16, its
   two replicas on cuda:0) under the daemon phase's traffic: every row
   ``make_pipeline``'s direct coords, both kernels twice a batch.
   Prints the phase's seconds.
19. The zoo-sp phase (``parallel/seq.py``'s rule of each family), the
   launch counts set to 0 before it and held at 0 after it: every family
   of the registry from the zoo phase's checkpoints (GradPeak without
   weights) in f32 and bf16 at the zoo phase's configuration (B=128,
   L=8000; the unet at L * 4), its single forward and its sharded forward
   (``parallel/seq.local_forward``: a thread a shard, every shard on the
   card) at sp = 2 and 4 over a warm-up and 1 batch, ms a batch of
   each beside the share of positions computed twice, each batch gated:
   bit for bit, or JAX's tolerances (a heatmap's decoded coords within 1
   sample on >= 0.99 of the slots, Zonzini's ToA rel 1e-4); GradPeak's
   rows equal. The same on PALA data at L=10240 for the 10-layer unet
   (its window the row) and ESPCN. Then each trainable family's f32 step
   at dp=1, sp=2 on the mesh phase's two gloo ranks (its launch, B=128 at
   the family's length, Kuleshov at L=2000), against the single step:
   the loss rtol 1e-5, every parameter within 2 lr, 99.9 % within 1e-5
   (the BatchNorm families: gradients rtol 1e-3, atol 1e-4 of the
   largest, running statistics rtol 1e-5). Last the daemon at
   ``model=espcn`` and ``model=zonzini mesh_sp=2`` from the zoo phase's
   checkpoints (both replicas on the card), one B=128 request against
   ``make_pipeline``'s direct rows. Prints the phase's seconds.
20. Prints one ``{"kernels": [...]}`` line (seven kernels, each with the
   launches of its paths: the serving, bench, training, probe, daemon,
   export, PALA serving, mesh daemon and sp runs, each counted from 0,
   summed over the paths that launch it; the serving instantiation's
   launches go to ``sgb_contract_pool`` at L_UNCHUNKED and L_PALA and to
   ``sgb_contract_pool_dma`` at L and L_LONG, on the fused path, through
   the daemons and over the sp shards), the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero. It exits non-zero
without a CUDA device too.
"""

from __future__ import annotations

import contextlib
import gc
import io
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.bench_paths import (
    AGREE_MIN, coord_agreement, make_xla_pipeline, try_fused_pipeline,
    try_int8_pipeline, try_packed_pipeline,
)
from stofnet_tpu_torch import native
from stofnet_tpu_torch.cli import array as cli_array
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.cli import main as cli_main
from stofnet_tpu_torch.cli import report as cli_report
from stofnet_tpu_torch.cli import serve as serve_cli
from stofnet_tpu_torch.cli import sweep as cli_sweep
from stofnet_tpu_torch.data.pala import PalaDatasetRf, generate_pala_dataset
from stofnet_tpu_torch.data.loader import (
    DataLoader, default_num_workers, split_dataset,
)
from stofnet_tpu_torch.data.synthetic import (
    DEFAULT_SPECS, gate_batch, generate_chirp_dataset,
)
from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_reference,
)
from stofnet_tpu_torch.models.int8 import (
    quantize_stofnet, stofnet_apply_int8,
)
from stofnet_tpu_torch.models.registry import REGRESSION, build_model
from stofnet_tpu_torch.ops.kernels import (
    KERNEL_MODULES, SOURCES, _build, conv_stack, dma_probe,
    reset_launch_counts, sgb, sgb_dma,
)
from stofnet_tpu_torch.ops.kernels._timing import time_ms, time_once
from stofnet_tpu_torch.models.torch_import import (
    load_stofnet, stofnet_overrides,
)
from stofnet_tpu_torch.ops.beamform import das_rx_batch, make_delay_table
from stofnet_tpu_torch.ops.conv import conv1d_same, full_f32
from stofnet_tpu_torch.ops.gaussian import gaussian_kernel
from stofnet_tpu_torch.ops.peaks import mask2coords
from stofnet_tpu_torch.ops.hilbert import analytic_signal
from stofnet_tpu_torch.ops.svd_filter import (
    singular_levels_db, svd_filter_db,
)
from stofnet_tpu_torch.parallel import (
    init_array_state, make_array_eval_step, make_array_train_step,
    make_threshold_sweep_step, stack_checkpoint_variables,
)
from stofnet_tpu_torch.parallel import mesh as dp_mesh
from stofnet_tpu_torch.parallel import seq
from stofnet_tpu_torch.scripts import bench_array, dp_check
from stofnet_tpu_torch.scripts import dma_probe as probe_script
from stofnet_tpu_torch.scripts.mesh_serve_check import (
    ZONZINI_RTOL,  # Zonzini's ToA: card against CPU, sharded against whole
)
from stofnet_tpu_torch.scripts import pala_bmode_figure as figure
from stofnet_tpu_torch.serve import (
    export_pipeline, export_pipeline_weightless, load_pipeline, make_pipeline,
    module_coords, probe_dtype_agreement, save_pipeline,
)
from stofnet_tpu_torch.serving import (
    ServingClient, decode_payload, encode_rows,
)
from stofnet_tpu_torch.serving.codecs import DEFAULT_CHUNKS
from stofnet_tpu_torch.serving.tcp import WIRE_INT8C
from stofnet_tpu_torch.train import (
    LossConfig, fused_loss, heatmap_loss, make_eval_step,
    make_fused_train_step, make_optimizer, make_train_step,
)
from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_model_variables, save_checkpoint,
)
from stofnet_tpu_torch.utils.config import load_config, merge_cli

B, L, UP = 128, 8000, 4
L_UNCHUNKED = 2000  # a serving length JAX's dma_supported refuses (L % 800)
L_MODULE = 1000  # a serving length the fused forward does not take (L % 80)
# the kernels each served batch launches, by length and counter
SERVE = {L: {"sgb_dma.launches": 1, "conv_stack.launches": 1},
         L_UNCHUNKED: {"sgb_dma.launches": 1, "conv_stack.launches": 1}}
# the kernels line's row of the serving SGB kernel's launches, by length
SGB_ROW = {L: "sgb_contract_pool_dma", L_UNCHUNKED: "sgb_contract_pool"}
DECODE = dict(window_size=20, threshold=None, upsample_factor=UP,
              max_echoes=8)
SEED = 0
TOL = 2e-2  # max|kernel - plain| <= TOL * max|plain|: bf16 outputs
N_BATCHES = 2  # gate batches a serving path
ROW_NOISE = 4  # rows of counting noise allowed beside the summation witness
PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense bf16 (data sheet)
PEAK_F32 = 67e12  # FLOP/s, H100 SXM f32 on the CUDA cores (data sheet)
PEAK_HBM = 3.35e12  # B/s, H100 SXM HBM3 (data sheet)
MARGIN = 1e-3  # offsets compared where max - runner-up > MARGIN * |max|
PLANE_BYTES = B * L * 512 * 2  # one (128, 8000, 512) bf16 pre-pool plane
GRAD_TOL = 2e-2  # relative L2 of each gradient leaf, kernels vs plain
SUM_TOL = 1e-5  # relative L2 of kernel B's f32 sums (dkernel, dbias)
OPT = dict(lr=5e-4, weight_decay=1e-8, epochs=80, steps_per_epoch=100)
N_STEPS = 4  # timed training steps, after one warm-up step
DMA_SEEDS = 3  # seeds of the streamed SGB kernel's check at L=800
HOST_CALLS = 1000  # back-to-back calls of the canary's host-time reading
PROFILE_CALLS = 100  # calls of the canary's device-time reading
DAEMON_CLIENTS = 8  # client threads of single-waveform requests
DAEMON_REQUESTS = 32  # single-waveform requests per client
DAEMON_ECHOES = 64  # cli/serve.py's default max_echoes
GATE_ROWS, GATE_SEED = 16, 3008  # the daemon's dtype gate batch (L=8000)
# the data phase's stand-in: 2 classes x 16 positions, 40 train and 8 test
# measurements a position, 800 IQ samples -> L=8000 at rf_scale_factor 10:
# 1,280 train-split items (1,024 train, 256 val), 256 test items
DRIVER_DATA = dict(n_positions=16, n_train_per_pos=40, n_test_per_pos=8,
                   sample_num=800)
PROFILE_STEPS = 5  # the driver's profile_steps default
LOADER_BATCHES = 2  # batches of the loader alone at each thread count
# the zoo phase: the registry's families at the driver's chirp
# configuration (the stand-in's 800 IQ samples at rf_scale_factor 10, fs of
# data/synthetic's sensor specs); the unet serves at L * UP after its fold
ZOO = ("edsr", "espcn", "zonzini", "unet", "sincnet", "kuleshov",
       "gradpeak")
ZOO_OVERRIDES = dict(dataset_kind="chirp", upsample_factor=UP,
                     sample_num=DRIVER_DATA["sample_num"], rf_scale_factor=10,
                     fs=DEFAULT_SPECS["fhz_sample"])
ZOO_ROWS = 4  # rows of a batch held against the CPU's pipeline
ZOO_LOSS_ROWS = 16  # rows of the first batch in the first-loss check
ZOO_LOSS_RTOL = 1e-5  # TF32 moved StofNet's loss by 3.3e-5
ZOO_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
ZOO_EXPORT_BATCHES = 1  # timed batches of each zoo artifact, after a warm-up
# the PALA phase: generate_pala_dataset at scripts/pala_bmode_figure.py's
# geometry (128 channels, 1024 samples, 3 angles, 24 frames a sequence, 3
# targets; 2 sequences); the driver at ch_gap 32 (4 channels a frame) and
# rf_scale_factor 10: L = 1024 * 10 = 10240 = 128 * 80
PALA_DATA = dict(n_sequences=2, n_frames=24, n_angles=3, n_channels=128,
                 n_samples=1024, n_targets=3)
L_PALA = 10240
PALA_FRAMES = 8  # frames a driver batch: 32 waveforms
PALA_ARGS = ["ch_gap=32", "rf_scale_factor=10", f"batch_size={PALA_FRAMES}",
             "epochs=1"]
# JAX serves L % 800 != 0 through sgb_contract_pool (dma_supported)
SGB_ROW[L_PALA] = "sgb_contract_pool"
SVD_TOL = 5e-3  # svd_filter_db, card against CPU (tests/test_ops_pala.py)
DB_TOL = 2e-3  # bf_das_batch's B-mode in dB, card against CPU: rtol, atol
DB_BRIGHT = -40.0  # pixels above it are held to DB_TOL dB absolute too
DB_BANDS = (0.0, -20.0, -40.0, -60.0)  # the B-mode error read by level
PALA_CPU_FRAMES = 4  # frames of the B-mode held against the CPU


# the array phase: cli/array.py on the data phase's stand-in
ARRAY_LRS = "[2.5e-4,5e-4,1e-3]"
ARRAY_THRESHOLDS = [0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0]
ARRAY_LOSS_RTOL = 1e-5  # a member's first loss against its solo step's
ARRAY_PARAM_RTOL = 1e-4  # relative L2 after the first update
SWEEP_MISSING = "no-such-prefix"  # the sweep's random-init row
MESH_PARAM_RTOL = 1e-4  # relative L2 after an epoch, mesh against none
MESH_LOSS_RTOL = 1e-5  # the 2-rank step's loss (tests/test_parallel.py)
MESH_AGREE = 1e-5  # a parameter within it after the 2-rank step ...
MESH_SHARE = 0.999  # ... for this share of them, all within 2 lr
MESH_TIMED = 1  # steps timed after the compared one
# the sp phase: (L, sp) of the sharded fused route; JAX's long-sequence
# target is L=16000 over 8 shards (tests/test_parallel.py:248)
L_LONG = 16000
SP_SERVE = ((L, 2), (L, 4), (L, 8), (L_LONG, 8))
SGB_ROW[L_LONG] = "sgb_contract_pool_dma"  # L % 800 == 0 in JAX
SP_AMP_RTOL, SP_AMP_AGREE, SP_AMP_SHARE = 1e-2, 1e-4, 0.99
# the zoo-sp phase: every family sharded over sp of the one card against
# its single forward, at the zoo phase's configuration (B, L; Kuleshov at
# its batch there, B); the driver steps in the mesh phase's two ranks at
# sp=2 (Kuleshov at ZOO_SP_STEP_L: at L its 1.2e9 gradients would cross
# gloo's host copies twice a step); the daemon for two families
ZOO_SP = (2, 4)
ZOO_SP_BATCHES = 1  # timed batches of each (family, dtype, sp), after one
ZOO_SP_PALA = ("unet", "espcn")  # on PALA data at L_PALA
ZOO_SP_STEP_L = {"kuleshov": 2000}
ZOO_SP_DAEMON = ("espcn", "zonzini")
ZOO_SP_BN = ("sincnet", "unet", "kuleshov")
# Kuleshov's f32 gradients of the down path lie 1.5e-3 to 4e-3 (relative
# L2) from an f64 step's on the card, the single step's as far as the
# ranks' (measured on one H100): held to the f64 witness instead of to
# each other, a tensor at most ZOO_SP_F64_RATIO times as far as the
# single step's; tensors whose f64 gradient is rounding noise (a conv
# bias before a BatchNorm) are held only by the 2 lr rule
ZOO_SP_F64 = ("kuleshov",)
ZOO_SP_F64_RATIO = 2.0
ZOO_SP_NOISE = 1e-6  # of the largest tensor's f64 gradient norm


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, bf16: float = 0.0, f32: float = 0.0):
    """Least time in ms for ``nbytes`` moved and ``bf16`` + ``f32`` FLOP,
    each type at its peak, and which of the two sets it."""
    t_ops = (bf16 / PEAK_BF16 + f32 / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def variants(t: torch.Tensor, n: int = 4):
    """``n`` distinct copies of a batch (rolled along the batch axis): a
    launch cycling through them finds its input evicted from the 50 MB L2
    cache by the three others read since (each at least 33 MB at the
    paths' shapes)."""
    return [torch.roll(t, i, dims=0).contiguous() for i in range(n)]


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    log(f"{name}: max|kernel - plain| = {err:.6g}, max|plain| = {scale:.6g}")
    if not (got.shape == ref.shape and np.isfinite(err)
            and err <= TOL * scale):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {TOL} * {scale})")
    return err


def contract_bf16(state):
    """The contract conv's kernel (5, 64, 512) and bias in bf16."""
    w = state["semi_global_block.contract_conv.weight"].permute(2, 1, 0)
    b = state["semi_global_block.contract_conv.bias"].to(torch.bfloat16)
    return w.to(torch.bfloat16).contiguous(), b


def sgb_yardstick_ms(hs, w, b) -> float:
    """The SGB kernels' yardstick: cuDNN conv + pool + leaky in bf16 on
    channels-first copies of the inputs."""
    wc = w.permute(2, 1, 0).contiguous()
    return time_ms(lambda x: F.leaky_relu(F.max_pool1d(
        F.conv1d(x, wc, b, padding=2), sgb.POOL), 0.01),
        [(x.transpose(1, 2).contiguous(),) for x in hs])


def sgb_bound(h, w, b):
    """The SGB contract+pool's bound: its inputs and pooled output moved
    once, the direct conv's bf16 operations."""
    bsz, length, _ = h.shape
    f = w.shape[2]
    return bound(nbytes(h, w, b) + bsz * (length // sgb.POOL) * f * 2,
                 bf16=2.0 * bsz * length * f * w.shape[0] * w.shape[1])


def kernel_sgb(dev, rng, state) -> dict:
    """JAX's ``sgb_contract_pool`` counterpart (the serving instantiation
    of the streamed kernel) at the shapes the main path gives it: B=128 at
    L_UNCHUNKED, a serving length JAX's DMA kernel refuses; then bit for
    bit on spike inputs at L=240 and L_UNCHUNKED (odd window counts)."""
    h = torch.from_numpy(rng.standard_normal((B, L_UNCHUNKED, 64),
                                             np.float32)).to(
        dev, torch.bfloat16)
    w, b = contract_bf16(state)
    # as make_pipeline lays it out
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    err = check_close("sgb_contract_pool",
                      sgb.sgb_contract_pool_prepared(h, image, bias),
                      sgb.sgb_contract_pool_reference(h, w, b))
    for length in (240, L_UNCHUNKED):
        spike_bits(length, dev, sgb.sgb_contract_pool)

    hs = variants(h)
    ms = time_ms(lambda x: sgb.sgb_contract_pool_prepared(x, image, bias),
                 [(x,) for x in hs])
    plain_ms = time_ms(lambda x: sgb.sgb_contract_pool_reference(x, w, b),
                       [(x,) for x in hs])
    t, by = sgb_bound(h, w, b)
    flop = 2.0 * B * L_UNCHUNKED * w.shape[0] * w.shape[1] * w.shape[2]
    log(f"sgb_contract_pool: {ms:.4f} ms at L={L_UNCHUNKED}, "
        f"{flop / ms / 1e9:.1f} TFLOP/s ({t / ms:.3f} of the bound)")
    return dict(name="sgb_contract_pool", route="cuda",
                source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
                replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:189",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=sgb_yardstick_ms(hs, w, b))


def shift_state(up: int, side: str, dev) -> dict:
    """Conv-stack weights that only shift to one side: every layer's output
    is its input at one outermost tap (identity there, zeros elsewhere,
    zero biases), so output p sums inputs up to 34 rows away along paths
    of weight 1."""
    tap_mid, tap_last = (0, 0) if side == "left" else (6, 2)
    state = {}
    for i in range(2, 13):
        w = torch.zeros(64, 64, 7, device=dev)
        w[:, :, tap_mid] = torch.eye(64, device=dev)
        state[f"conv{i}.weight"] = w
        state[f"conv{i}.bias"] = torch.zeros(64, device=dev)
    w = torch.zeros(up, 64, 3, device=dev)
    w[:, :up, tap_last] = torch.eye(up, device=dev)
    state["conv_last.weight"] = w
    state["conv_last.bias"] = torch.zeros(up, device=dev)
    return state


def kernel_stack(dev, rng, state) -> dict:
    """Fused conv stack at the main path's shapes and types."""
    h0 = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    wts = conv_stack.stack_weights(state, torch.bfloat16)  # as make_pipeline
    err = check_close("conv_stack_fused",
                      conv_stack.conv_stack_fused_prepared(h0, wts),
                      conv_stack.conv_stack_fused_reference(h0, state))
    # the halo and seams: with shift weights and inputs in {1, 2, 3} every
    # value is an integer under 256, exact in bf16 and in any order of f32
    # sums, and a path to a row outside a tile's halo is missed exactly
    for length in (L, L_UNCHUNKED):
        x = torch.from_numpy(rng.integers(1, 4, (B, length, 64)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for side in ("left", "right"):
            shift = shift_state(UP, side, dev)
            got = conv_stack.conv_stack_fused(x, shift)
            ref = conv_stack.conv_stack_fused_reference(x, shift)
            torch.cuda.synchronize()
            if not (0 < ref.max().item() < 256 and torch.equal(got, ref)):
                raise AssertionError(
                    f"conv_stack_fused: shift weights ({side}) at L={length}"
                    f": {(got != ref).sum().item()} outputs differ from the "
                    "plain version")
    log(f"conv_stack_fused: shift weights, both sides, L={L} and "
        f"L={L_UNCHUNKED}: the plain version's bits")

    hs = variants(h0)
    ms = time_ms(lambda x: conv_stack.conv_stack_fused_prepared(x, wts),
                 [(x,) for x in hs])
    plain_ms = time_ms(
        lambda x: conv_stack.conv_stack_fused_reference(x, state),
        [(x,) for x in hs])
    # yardstick: the chain of 12 cuDNN convs in bf16, channels-first
    wb = {k: v.to(torch.bfloat16) for k, v in state.items()}

    def library(x):
        h = res = res1 = x
        for i in range(2, 12):
            y = F.conv1d(h, wb[f"conv{i}.weight"], wb[f"conv{i}.bias"],
                         padding=3)
            if i % 2:
                h = res = res + y
            else:
                h = F.leaky_relu(y, 0.01)
        h = res1 + F.conv1d(h, wb["conv12.weight"], wb["conv12.bias"],
                            padding=3)
        return F.conv1d(h, wb["conv_last.weight"], wb["conv_last.bias"],
                        padding=1)

    library_ms = time_ms(library, [(x.transpose(1, 2).contiguous(),)
                                   for x in hs])
    r = state["conv_last.weight"].shape[0]
    weights = [state[f"conv{i}.{p}"] for i in range(2, 13)
               for p in ("weight", "bias")]
    weights += [state["conv_last.weight"], state["conv_last.bias"]]
    useful = 2.0 * B * L * (11 * 7 * 64 * 64 + 3 * 64 * r)
    t, by = bound(nbytes(h0, *weights) + B * L * r * 4, bf16=useful)
    tiles = B * len(conv_stack.tile_plan(L)[0])
    computed = 2.0 * tiles * conv_stack.ROWS * (
        11 * 7 * 64 * 64 + 3 * 64 * conv_stack.MAX_OUT)
    log(f"conv_stack_fused: {tiles} tiles of {conv_stack.ROWS} rows; "
        f"{useful / ms / 1e9:.1f} TFLOP/s on the kept positions, "
        f"{computed / ms / 1e9:.1f} on the computed rows "
        f"({B * L / (tiles * conv_stack.ROWS):.3f} of them kept)")
    return dict(name="conv_stack_fused", route="cuda",
                source="stofnet_tpu_torch/csrc/conv_stack.cu",
                replaces="stofnet_tpu/ops/pallas/conv_stack_kernel.py:137",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=library_ms)


def canary(dev, rng) -> dict:
    """The canary, right after the build and before any other kernel: 2 x
    must equal x * 2 bit for bit. Its time is the launch's host work."""
    x = torch.from_numpy(rng.standard_normal((8, 128), np.float32)).to(dev)
    got = dma_probe.canary(x)
    torch.cuda.synchronize()
    if not torch.equal(got, x * 2):
        raise AssertionError("canary: the kernel's 2 x differs from x * 2 "
                             "(toolchain or CUDA runtime)")
    log("canary: 2 x equals x * 2 bit for bit")
    xs = [(x + i,) for i in range(4)]
    t, by = bound(2 * nbytes(x))
    row = dict(name="canary", route="cuda",
               source="stofnet_tpu_torch/csrc/dma_probe.cu",
               replaces="scripts/dma_probe.py:145", max_abs_err=0.0,
               ms=time_ms(dma_probe.canary, xs),
               plain_ms=time_ms(dma_probe.canary_reference, xs),
               bound_ms=t, bound_by=by,
               library_ms=time_ms(lambda v: torch.mul(v, 2), xs))
    route = {}
    for name, fn, ms in (("canary", dma_probe.canary, row["ms"]),
                         ("torch.mul", lambda v: torch.mul(v, 2),
                          row["library_ms"])):
        route[name] = dict(event_us=ms * 1e3, host_us=host_us(fn, x),
                           device_us=profile_runs(fn, [x] * PROFILE_CALLS)[
                               "device_busy_ms"] * 1e3)
    log(f"canary launch route (us a call): {json.dumps(route)}")
    return row


def host_us(fn, x) -> float:
    """Host microseconds a call of ``fn(x)`` over HOST_CALLS back-to-back
    calls with no synchronise between them (``time.perf_counter``): the
    launch route's host work, which the card, idle, cannot hide."""
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn(x)
    us = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
    torch.cuda.synchronize()
    return us


def spike_bits(length: int, dev, op=sgb_dma.sgb_contract_pool_dma) -> None:
    """The serving kernel through ``op`` (either of its wrappers) on
    ``sgb_dma.spike_inputs`` at B=128 must give its plain version's bits:
    every f32 sum is exact there, and a tap that reads one row off (a
    short halo, a misplaced window) moves a spike into another window,
    which random inputs at TOL would hide."""
    h, w, b = (torch.from_numpy(a).to(dev)
               for a in sgb_dma.spike_inputs(B, length, seed=length))
    h = h.to(torch.bfloat16)
    got = op(h, w, b)
    ref = sgb.sgb_contract_pool_reference(h, w, b)
    torch.cuda.synchronize()
    if not (0 < ref.float().max().item() < 32 and torch.equal(got, ref)):
        raise AssertionError(f"{op.__name__}: spike inputs at L={length}: "
                             f"{int((got != ref).sum())} outputs differ from "
                             f"the plain version")
    log(f"{op.__name__}: spike inputs at L={length}: the plain version's "
        f"bits")


def kernel_sgb_dma(dev, rng, state) -> dict:
    """The streamed SGB kernel at the main path's shapes and types, then at
    L=800 (one ring's worth of windows and a little more) over DMA_SEEDS
    seeds, and on spike inputs at L=800 and L."""
    w, b = contract_bf16(state)
    # as fused_forward lays it out
    image, bias = sgb_dma.sgb_dma_weights(w, b, torch.bfloat16)
    for seed in range(DMA_SEEDS):
        h8 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (B, 800, 64), np.float32)).to(dev, torch.bfloat16)
        check_close(f"sgb_contract_pool_dma L=800 seed {seed}",
                    sgb_dma.sgb_contract_pool_dma_prepared(h8, image, bias),
                    sgb_dma.sgb_contract_pool_dma_reference(h8, w, b))
    for length in (800, L):
        spike_bits(length, dev)
    h = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    got = sgb_dma.sgb_contract_pool_dma_prepared(h, image, bias)
    err = check_close("sgb_contract_pool_dma", got,
                      sgb_dma.sgb_contract_pool_dma_reference(h, w, b))

    hs = variants(h)
    ms = time_ms(lambda x: sgb_dma.sgb_contract_pool_dma_prepared(
        x, image, bias), [(x,) for x in hs])
    plain_ms = time_ms(lambda x: sgb_dma.sgb_contract_pool_dma_reference(
        x, w, b), [(x,) for x in hs])
    t, by = sgb_bound(h, w, b)
    flop = 2.0 * B * L * w.shape[0] * w.shape[1] * w.shape[2]
    log(f"sgb_contract_pool_dma: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
        f"({t / ms:.3f} of the bound)")
    return dict(name="sgb_contract_pool_dma", route="cuda",
                source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
                replaces="stofnet_tpu/ops/pallas/sgb_dma_kernel.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t,
                bound_by=by, library_ms=sgb_yardstick_ms(hs, w, b))


def probe_path():
    """The probe entry point's logic on the card, every point checked
    (``scripts/dma_probe.run``, strict): its kernels line row from the
    fastest point, and the launches of this run."""
    reset_launch_counts()
    res = probe_script.run(strict=True)
    launches = {"stream_probe": dma_probe.probe_launches,
                "canary": dma_probe.canary_launches}
    print(json.dumps(res["line"]), flush=True)
    best = res["best"]
    log(f"probe: best point {best}, {res['ms'][best]:.4f} ms; launches "
        f"{json.dumps(launches)}")
    x_bytes = probe_script.N_ROWS * dma_probe.WIDTH * 2
    t, by = bound(x_bytes + dma_probe.GROUP * dma_probe.WIDTH * 4,
                  f32=probe_script.N_ROWS * dma_probe.WIDTH)
    row = dict(name="stream_probe", route="cuda",
               source="stofnet_tpu_torch/csrc/dma_probe.cu",
               replaces="scripts/dma_probe.py:37",
               max_abs_err=res["max_abs_err"][best], ms=res["ms"][best],
               plain_ms=res["plain_ms"], bound_ms=t, bound_by=by,
               library_ms=res["library_ms"])
    return row, launches


def row_agreement(a: torch.Tensor, b: torch.Tensor):
    """Over the rows with a detection in either: the fraction whose slots
    all lie within 1 sample, and the count of the others."""
    has = (a != 0).any(1) | (b != 0).any(1)
    ok = (a - b).abs().le(1.0).all(1)
    return float(ok[has].float().mean()), int((has & ~ok).sum())


def counts() -> dict:
    """Every launch counter of the kernel modules, as ``module.counter``."""
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{c}": getattr(mod, c)
            for mod in KERNEL_MODULES for c in mod.COUNTERS}


def serve_timed(name, run, batches, per_batch):
    """``run(x)`` over the batches, each timed on the host clock (numpy
    frame in, coords on the host out); on each batch every launch counter
    must rise by its ``per_batch`` launches (0 where absent). Returns the
    coords and the ms of each batch."""
    coords, batch_ms = [], []
    for x in batches:
        before = counts()
        t0 = time.perf_counter()
        coords.append(run(x))  # the copy to the host waits for the card
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        rose = {k: v - before[k] for k, v in counts().items()}
        wrong = {k: v for k, v in rose.items() if v != per_batch.get(k, 0)}
        if wrong:
            raise AssertionError(f"{name}: launches on one batch {wrong}, "
                                 f"not {per_batch}")
    got = torch.cat(coords)
    if got.shape != (len(batches) * B, DECODE["max_echoes"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{name}: bad coords {tuple(got.shape)}")
    return got, batch_ms


def main_path(dev, state, rng) -> dict:
    """make_pipeline at each length of SERVE over one warm-up batch and
    N_BATCHES fresh gate batches, each batch launching the kernels SERVE
    names for its length and no other, the counts set to 0 just before
    each length and read just after; then, per length, the agreement with
    the plain path, the witnesses and the profile. Returns the launches of
    the served batches by kernels-line row."""
    pipe = make_pipeline(state, {"upsample_factor": UP}, device=dev,
                         window_size=DECODE["window_size"],
                         threshold=DECODE["threshold"],
                         max_echoes=DECODE["max_echoes"])

    def run(x):
        return pipe(x).cpu()

    batches = {}
    for length in SERVE:
        run(gate_batch(B, length, rng))  # cuDNN's algorithm choice, not timed
        batches[length] = [gate_batch(B, length, rng)
                           for _ in range(N_BATCHES)]
    served, launches = {}, {"conv_stack_fused": 0}
    for length, per_batch in SERVE.items():
        reset_launch_counts()
        served[length] = serve_timed(f"main path L={length}", run,
                                     batches[length], per_batch)
        c = counts()
        launches[SGB_ROW[length]] = c["sgb_dma.launches"]
        launches["conv_stack_fused"] += c["conv_stack.launches"]
    log(f"main path launches: {json.dumps(launches)}")
    module_route(dev, state, pipe, run, rng)

    params = {k: v.to(dev) for k, v in state.items()}
    for length, (got, batch_ms) in served.items():
        name = f"main path L={length}"
        with torch.inference_mode():
            plain = torch.cat([mask2coords(stofnet_apply_reference(
                params, torch.from_numpy(x).to(dev)), **DECODE).cpu()
                for x in batches[length]])
        if bool((got < 0).any() or (got > length).any()):
            raise AssertionError(f"{name}: coords outside [0, {length}]")
        agree = coord_agreement(got, plain)
        rows, moved = row_agreement(got, plain)
        ms = float(np.median(batch_ms))
        out = dict(coord_agreement=agree, row_agreement=rows,
                   rows_moved=moved, rows=int(got.shape[0]),
                   detections_per_row=float((got != 0).sum(1).float().mean()),
                   ms_per_batch=ms, batch_ms=batch_ms,
                   waveforms_per_s=B / ms * 1e3)
        log(f"{name}: {json.dumps(out)}")
        if agree < AGREE_MIN:
            raise AssertionError(f"{name}: coord agreement {agree} < "
                                 f"{AGREE_MIN}")
        wit = witness(dev, state, batches[length], got, plain)
        log(f"{name} witness: {json.dumps(wit)}")
        base = wit["plain~plain_cpu"]["moved"]
        if moved > 2 * base + ROW_NOISE:
            raise AssertionError(
                f"{name}: the kernel path moves {moved} rows against the "
                f"plain path, more than twice the {base} that f32 summation "
                f"order alone moves (plain path on the CPU) plus {ROW_NOISE}")
        prof = profile_runs(run, batches[length])
        prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
        log(f"{name} profile: {json.dumps(prof)}")
    return launches


def module_route(dev, state, pipe, run, rng) -> None:
    """One batch at L_MODULE through the main pipeline: its module route,
    which launches no kernel (serve_timed holds every counter still) and
    must agree with the bf16 StofNet module on >= AGREE_MIN of the coord
    slots."""
    x = gate_batch(B, L_MODULE, rng)
    before = pipe.calls["module"]
    got, batch_ms = serve_timed(f"main path L={L_MODULE}", run, [x], {})
    ref = torch.from_numpy(module_coords(
        state, {"upsample_factor": UP}, x, torch.bfloat16, dev,
        window_size=DECODE["window_size"], threshold=DECODE["threshold"],
        max_echoes=DECODE["max_echoes"]))
    agree = coord_agreement(got, ref)
    out = dict(route_calls=pipe.calls["module"] - before,
               coord_agreement_module_bf16=agree, ms=batch_ms[0])
    log(f"main path L={L_MODULE}: {json.dumps(out)}")
    if out["route_calls"] != 1 or agree < AGREE_MIN:
        raise AssertionError(f"main path L={L_MODULE}: {out}, not one module "
                             f"call at >= {AGREE_MIN} of the slots")


def bench_paths(dev, state, rng) -> dict:
    """The bench's fused and packed paths over a gate batch (their warm-up)
    and N_BATCHES fresh batches; launch counts of the fused path."""
    ov = {"upsample_factor": UP}
    xg = torch.from_numpy(gate_batch(B, L, rng)).to(dev)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    cpu_state = {k: v.cpu() for k, v in state.items()}

    def plain(st, x):  # the fused path's plain versions
        return mask2coords(stofnet_apply_reference(
            st, x, fused_stack=False), **DECODE)

    m16 = make_xla_pipeline(ov, torch.bfloat16, dev)
    m32 = make_xla_pipeline(ov, None, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref_gate = plain(state, xg).cpu()
        ref, ref_cpu, c16, c32 = [], [], [], []
        for x in batches:
            xd = torch.from_numpy(x).to(dev)
            ref.append(plain(state, xd).cpu())
            ref_cpu.append(plain(cpu_state, torch.from_numpy(x)))
            c16.append(m16(state, xd).cpu())
            c32.append(m32(state, xd).cpu())
        c16_gate = m16(state, xg).cpu()
    ref, ref_cpu = torch.cat(ref), torch.cat(ref_cpu)
    c16, c32 = torch.cat(c16), torch.cat(c32)
    log(f"bench paths: references {time.perf_counter() - t0:.1f} s")

    fused = try_fused_pipeline(state, ov, xg, ref_gate)
    if fused is None:
        raise AssertionError("try_fused_pipeline: the gate refused the fused "
                             "path against the plain path")
    reset_launch_counts()
    got, ms, launches = serve_bench_path("fused", fused, dev, state, batches,
                                         {"sgb_dma.launches": 1})
    agree = coord_agreement(got, ref)
    rows, moved = row_agreement(got, ref)
    base = row_agreement(ref, ref_cpu)[1]
    out = dict(coord_agreement=agree, row_agreement=rows, rows_moved=moved,
               plain_rows_moved_card_vs_cpu=base,
               module_f32=dict(slots=coord_agreement(got, c32),
                               moved=row_agreement(got, c32)[1]),
               ms_per_batch=ms, waveforms_per_s=B / ms * 1e3,
               launches={"sgb_contract_pool_dma": launches[
                   "sgb_dma.launches"]})
    log(f"fused path: {json.dumps(out)}")
    if agree < AGREE_MIN:
        raise AssertionError(f"fused path: coord agreement {agree} < "
                             f"{AGREE_MIN}")
    if moved > 2 * base + ROW_NOISE:
        raise AssertionError(
            f"fused path: moves {moved} rows against the plain path, more "
            f"than twice the {base} that f32 summation order alone moves "
            f"(plain path on the CPU) plus {ROW_NOISE}")

    packed = try_packed_pipeline(state, ov, xg, c16_gate)
    if packed is None:
        raise AssertionError("try_packed_pipeline: the gate refused the "
                             "packed path against the bf16 module")
    got, ms, _ = serve_bench_path("packed", packed, dev, state, batches, {})
    agree = coord_agreement(got, c16)
    out_p = dict(coord_agreement_module_bf16=agree,
                 rows_moved_module_bf16=row_agreement(got, c16)[1],
                 module_f32=dict(slots=coord_agreement(got, c32),
                                 moved=row_agreement(got, c32)[1]),
                 ms_per_batch=ms, waveforms_per_s=B / ms * 1e3)
    log(f"packed path: {json.dumps(out_p)}")
    if agree < AGREE_MIN:
        raise AssertionError(f"packed path: coord agreement {agree} with the "
                             f"bf16 module < {AGREE_MIN}")
    return out


def serve_bench_path(name, pipe, dev, state, batches, per_batch):
    """``pipe(state, x)`` over the batches as :func:`serve_timed` serves
    them. Returns (coords, median ms, the launch counters after the
    batches); then device time by kernel under the profiler."""
    def run(x):
        return pipe(state, torch.from_numpy(x).to(dev)).cpu()

    got, batch_ms = serve_timed(f"{name} path", run, batches, per_batch)
    launches = counts()
    ms = float(np.median(batch_ms))
    prof = profile_runs(run, batches)
    prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
    log(f"{name} path profile: {json.dumps(prof)}")
    return got, ms, launches


def witness(dev, state, batches, got, plain) -> dict:
    """Row agreement of the served coords with other forwards of the same
    batches, each a witness of where decoded positions move:

    - ``plain_cpu``: the plain path on the CPU. It rounds where the plain
      path on the card does and sums in another order, so what moves
      between the two is f32 summation order alone.
    - ``module_bf16``: the StofNet module in bf16, at flax's rounding
      points (after each conv and each bias add).
    - ``module_f32``: the StofNet module in f32 on the card (TF32 off),
      the model without bf16; held against the kernel path, the plain
      path and ``module_bf16``.
    """
    cpu_state = {k: v.cpu() for k, v in state.items()}
    m16 = StofNet(dtype=torch.bfloat16, device=dev)
    m32 = StofNet(device=dev)
    m16.load_state_dict(state)
    m32.load_state_dict(state)
    cpu, c16, c32 = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for x in batches:
            xc = torch.from_numpy(x)
            cpu.append(mask2coords(stofnet_apply_reference(cpu_state, xc),
                                   **DECODE))
            xd = xc.to(dev)
            c16.append(mask2coords(m16(xd), **DECODE).cpu())
            c32.append(mask2coords(m32(xd), **DECODE).cpu())
    cpu, c16, c32 = torch.cat(cpu), torch.cat(c16), torch.cat(c32)
    pairs = {"kernel~plain_cpu": (got, cpu), "plain~plain_cpu": (plain, cpu),
             "kernel~module_bf16": (got, c16),
             "kernel~module_f32": (got, c32), "plain~module_f32": (plain, c32),
             "module_bf16~module_f32": (c16, c32)}
    out = {}
    for name, (a, b) in pairs.items():
        rows, moved = row_agreement(a, b)
        out[name] = dict(rows=rows, moved=moved, slots=coord_agreement(a, b))
    out["seconds"] = time.perf_counter() - t0
    return out


def profile_runs(run_one, items) -> dict:
    """Device time by kernel over ``run_one(x)`` for each of ``items``
    (each run ends in a copy to the host), under the profiler: where a
    batch's or a step's time goes. Its wall time is the profiler's, so the
    idle share is derived against the unprofiled median."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in items:
            run_one(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / len(items)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kern:  # names cut to 60 characters; sum what they merge
        name = e.key[:60]
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / len(items))
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(runs=len(items), profiled_wall_ms=wall_us / 1e3,
                device_busy_ms=busy_us / 1e3,
                top_ms={k: v / 1e3 for k, v in top})


def kernels_trainable(dev, rng, state):
    """Kernels A and B of the trainable SGB op at the main path's shapes:
    the f32 master weights of the contract conv, bf16 features."""
    h = torch.from_numpy(rng.standard_normal((B, L, 64), np.float32)).to(
        dev, torch.bfloat16)
    w = state["semi_global_block.contract_conv.weight"].permute(
        2, 1, 0).contiguous()  # (5, 64, 512) f32
    b = state["semi_global_block.contract_conv.bias"]
    f = w.shape[2]
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)  # as the op does
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    err_a = check_close("sgb_contract_pool_argmax", pooled, ref_pooled)
    y = conv1d_same(h.float(), w.to(h.dtype).float(), b.to(h.dtype).float())
    top = y.reshape(B, L // sgb.POOL, sgb.POOL, f).topk(2, dim=2).values
    del y
    clear = (top[:, :, 0] - top[:, :, 1]) > MARGIN * top[:, :, 0].abs()
    differ = off != ref_off
    offsets = dict(mismatch_rate=float(differ.float().mean()),
                   clear_share=float(clear.float().mean()),
                   mismatch_clear=int((differ & clear).sum()))
    log(f"sgb_contract_pool_argmax offsets: {json.dumps(offsets)}")
    if offsets["mismatch_clear"]:
        raise AssertionError("kernel A's offsets differ from the plain "
                             "version's where the window maximum is clear")
    for length in (800, L):
        argmax_spike_bits(length, dev)

    g = torch.from_numpy(rng.standard_normal(pooled.shape, np.float32)).to(
        dev, torch.bfloat16)
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    again = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    err_b = 0.0
    for name, x, y2, z in zip(("dh", "dkernel", "dbias"), got, again, ref):
        err_b = max(err_b, check_close(f"sgb_contract_pool_bwd {name}", x, z))
        if not torch.equal(x, y2):
            raise AssertionError(f"sgb_contract_pool_bwd {name}: two runs on "
                                 "the same inputs differ")
        if name != "dh":  # f32 sums of exact products: order alone differs
            rel = rel_l2(x, z)
            log(f"sgb_contract_pool_bwd {name}: relative L2 {rel:.3g}")
            if not rel <= SUM_TOL:
                raise AssertionError(f"sgb_contract_pool_bwd {name}: relative "
                                     f"L2 {rel} > {SUM_TOL}")
    log("sgb_contract_pool_bwd: two runs bitwise equal")
    for length in (800, L):
        bwd_exact_bits(length, dev)
    peak = trainable_peak_bytes(h, w, b, g)
    log(f"trainable op forward + backward: peak {peak / 1e6:.1f} MB above "
        f"the inputs (one bf16 pre-pool plane: {PLANE_BYTES / 1e6:.1f} MB)")
    if peak >= PLANE_BYTES:
        raise AssertionError(f"the trainable op took {peak} bytes, not less "
                             f"than one (B, L, 512) bf16 plane")

    hs = variants(h)
    fwd = [sgb.sgb_contract_pool_argmax(x, image, bias) for x in hs]
    gs = variants(g)
    ms_a = time_ms(lambda x: sgb.sgb_contract_pool_argmax(x, image, bias),
                   [(x,) for x in hs])
    # 20 calls: over 4, one reading came to 3/4 of the event time (an
    # event lost to the profiler), which 20 calls dilute
    device_a = profile_runs(lambda x: sgb.sgb_contract_pool_argmax(
        x, image, bias), hs * 5)
    layout = profile_runs(lambda _: sgb.sgb_dma_weights(
        w, b, torch.bfloat16), [None] * 20)
    plain_a = time_ms(
        lambda x: sgb.sgb_contract_pool_argmax_reference(x, w, b),
        [(x,) for x in hs])
    # yardstick: cuDNN conv + pool with indices + leaky, bf16, channels-first
    hc = [(x.transpose(1, 2).contiguous(),) for x in hs]
    wc, bc = w.permute(2, 1, 0).to(torch.bfloat16), b.to(torch.bfloat16)

    def library_a(x):
        y, idx = F.max_pool1d(F.conv1d(x, wc, bc, padding=2), sgb.POOL,
                              return_indices=True)
        return F.leaky_relu(y, 0.01), idx
    lib_a = time_ms(library_a, hc)
    t_a, by_a = bound(nbytes(h, image, bias, pooled, off),
                      bf16=2.0 * B * L * f * w.shape[0] * w.shape[1])
    log(f"sgb_contract_pool_argmax: {ms_a:.4f} ms (device "
        f"{device_a['device_busy_ms']:.4f} ms a call under the profiler, "
        f"{json.dumps(device_a['top_ms'])}), bound {t_a:.4f} ms by {by_a}, "
        f"library (cuDNN conv + pool with indices + leaky) {lib_a:.4f} ms; "
        f"the weight image it takes, built each step: device "
        f"{layout['device_busy_ms']:.4f} ms a call "
        f"{json.dumps(layout['top_ms'])}")

    bwd_args = [(x, gi, p, o) for x, gi, (p, o) in zip(hs, gs, fwd)]
    ms_b = time_ms(lambda x, gi, p, o: sgb.sgb_contract_pool_bwd(
        x, w, gi, p, o), bwd_args)
    plain_b = time_ms(lambda x, gi, p, o: sgb.sgb_contract_pool_bwd_reference(
        x, w, gi, p, o), bwd_args)
    split = profile_runs(lambda a: sgb.sgb_contract_pool_bwd(
        a[0], w, *a[1:]), bwd_args)
    log(f"sgb_contract_pool_bwd passes, device ms a call: "
        f"{json.dumps(split['top_ms'])}")
    # yardstick: the backward alone of cuDNN conv + max-pool + leaky in bf16
    graphs = []
    for x, gi in zip(hs[:2], gs[:2]):
        xc = x.transpose(1, 2).contiguous().requires_grad_(True)
        wl = wc.detach().clone().requires_grad_(True)
        bl = bc.detach().clone().requires_grad_(True)
        out = F.leaky_relu(F.max_pool1d(F.conv1d(xc, wl, bl, padding=2),
                                        sgb.POOL), 0.01)
        graphs.append((out, (xc, wl, bl), gi.transpose(1, 2).contiguous()))
    lib_b = time_ms(lambda out, inputs, gc: torch.autograd.grad(
        out, inputs, gc, retain_graph=True), graphs)
    del graphs
    # work this run's offsets need: taps that land inside [0, L)
    pos = (off.long() - sgb.PAD
           + torch.arange(L // sgb.POOL, device=dev)[:, None] * sgb.POOL)
    taps = sum(int(((pos + t >= 0) & (pos + t < L)).sum())
               for t in range(sgb.KSIZE))
    # dkernel: bf16 x bf16 products summed in f32, the bf16 tensor-core
    # type; dh: f32 g_pre x f32 w, and dbias, on the f32 CUDA cores
    t_b, by_b = bound(nbytes(h, w, g, pooled, off, *got),
                      bf16=2.0 * taps * 64,
                      f32=2.0 * taps * 64 + 2.0 * pooled.numel())
    # the kernel's own design runs both passes' products in f32 on the
    # CUDA cores: its floor, beside the bound
    floor_b = (4.0 * taps * 64 + 2.0 * pooled.numel()) / PEAK_F32 * 1e3
    log(f"sgb_contract_pool_bwd: {ms_b:.4f} ms; bound {t_b:.4f} ms by "
        f"{by_b}, CUDA-core floor of the design {floor_b:.4f} ms")
    a = dict(name="sgb_contract_pool_argmax", route="cuda",
             source="stofnet_tpu_torch/csrc/sgb_contract_pool_dma.cu",
             replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:209",
             max_abs_err=err_a, ms=ms_a, plain_ms=plain_a, bound_ms=t_a,
             bound_by=by_a, library_ms=lib_a)
    bk = dict(name="sgb_contract_pool_bwd", route="cuda",
              source="stofnet_tpu_torch/csrc/sgb_contract_pool_bwd.cu",
              replaces="stofnet_tpu/ops/pallas/sgb_kernel.py:244",
              max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=t_b,
              bound_by=by_b, library_ms=lib_b)
    return a, bk


def argmax_spike_bits(length: int, dev) -> None:
    """Kernel A on ``sgb_dma.spike_inputs`` at B=128 must give its plain
    version's bits, pooled and offsets: every f32 sum is exact there, the
    all-bias columns tie across whole windows (the first position wins),
    and a tap that reads one row off moves a spike into another window."""
    h, w, b = (torch.from_numpy(a).to(dev)
               for a in sgb_dma.spike_inputs(B, length, seed=length))
    h = h.to(torch.bfloat16)
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    torch.cuda.synchronize()
    for name, x, z in (("pooled", pooled, ref_pooled), ("offsets", off,
                                                         ref_off)):
        if not (0 < ref_pooled.float().max().item() < 32
                and torch.equal(x, z)):
            raise AssertionError(f"sgb_contract_pool_argmax {name}: spike "
                                 f"inputs at L={length}: "
                                 f"{int((x != z).sum())} outputs differ from "
                                 f"the plain version")
    log(f"sgb_contract_pool_argmax: spike inputs at L={length}: the plain "
        f"version's bits, pooled and offsets")


def bwd_exact_bits(length: int, dev) -> None:
    """Kernel B on ``sgb.bwd_exact_inputs`` at B=128 must give its plain
    version's bits: every f32 sum is exact there and dh exact in bf16, and
    offsets at window positions 0, 1, 78, 79 put terms across the seams,
    so a missed seam term changes dh where random inputs at TOL hide it."""
    h, w, g, pooled, off = (torch.from_numpy(a).to(dev)
                            for a in sgb.bwd_exact_inputs(B, length,
                                                          seed=length))
    h, g, pooled = (t.to(torch.bfloat16) for t in (h, g, pooled))
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    torch.cuda.synchronize()
    for name, x, z in zip(("dh", "dkernel", "dbias"), got, ref):
        if not (z.abs().max().item() > 0 and torch.equal(x, z)):
            raise AssertionError(f"sgb_contract_pool_bwd {name}: exact inputs "
                                 f"at L={length}: {int((x != z).sum())} "
                                 f"outputs differ from the plain version")
    log(f"sgb_contract_pool_bwd: exact inputs at L={length}: the plain "
        f"version's bits")


def trainable_peak_bytes(h, w, b, g) -> int:
    """Peak device memory of one forward + backward of the trainable op,
    above what was allocated before it (its inputs)."""
    hg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (h, w, b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sgb.sgb_contract_pool_trainable(hg, wg, bg).backward(g)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def train_batches(rng, n: int, dev):
    """``n`` seeded noise frames (B, 1, L), max-normalized per waveform, and
    the GT of two echoes per row at samples 2000.25 and 5500.5, in
    upsampled units (B, 1, 2): the training bench's recipe."""
    frames = []
    for _ in range(n):
        x = rng.standard_normal((B, 1, L)).astype(np.float32)
        x /= np.abs(x).max(axis=-1, keepdims=True)
        frames.append(torch.from_numpy(x).to(dev))
    gt = np.round(np.array([2000.25, 5500.5]) * UP).astype(np.int32)
    return frames, torch.from_numpy(np.tile(gt, (B, 1, 1))).to(dev)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def trainer(dev, seed: int, cfg, forward=stofnet_apply_fused):
    """StofNet's f32 masters drawn from ``seed`` and the fused train step
    over them with ``forward``: (params, step)."""
    model = StofNet(generator=torch.Generator().manual_seed(seed),
                    device=dev)
    params = dict(model.named_parameters())
    opt, sched = make_optimizer(params.values(), **OPT)
    return params, make_fused_train_step(params, opt, sched, cfg,
                                         forward=forward)


def train_path(dev) -> dict:
    """The fused train step: a gradient witness, one warm-up step, then the
    timed steps with their launch counts, then the seed witness. The
    weights are drawn from seed SEED + 1 (see :func:`seed_witness`)."""
    cfg = LossConfig(upsample_factor=UP, max_echoes=8)
    params, step = trainer(dev, SEED + 1, cfg)
    frames, gt = train_batches(np.random.default_rng(SEED + 1),
                               1 + N_STEPS, dev)

    t0 = time.perf_counter()
    grads = {}
    for name, forward, dt in (
            ("kernel", stofnet_apply_fused, torch.bfloat16),
            ("plain", stofnet_apply_reference, torch.bfloat16),
            ("plain_f32", stofnet_apply_reference, None)):
        loss = fused_loss(params, frames[0], gt, cfg, dt, forward)
        grads[name] = torch.autograd.grad(loss, list(params.values()))
    kernel_vs_plain = {k: rel_l2(a, b) for k, a, b in zip(
        params, grads["kernel"], grads["plain"])}
    bf16_vs_f32 = {k: rel_l2(a, b) for k, a, b in zip(
        params, grads["plain"], grads["plain_f32"])}
    del grads
    log(f"gradients, relative L2 per leaf, kernel path vs plain path: "
        f"{json.dumps(kernel_vs_plain)}")
    log(f"gradients, relative L2 per leaf, plain bf16 vs plain f32: "
        f"{json.dumps(bf16_vs_f32)}")
    log(f"gradient witness: {time.perf_counter() - t0:.1f} s")
    bad = {k: v for k, v in kernel_vs_plain.items() if not v <= GRAD_TOL}
    if bad:
        raise AssertionError(f"gradients beyond relative L2 {GRAD_TOL} of "
                             f"the plain path's (or not finite): {bad}")

    loss0 = float(step(frames[0], gt))  # cuDNN's algorithm choice, not timed
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for x in frames[1:1 + N_STEPS]:
        before = (sgb.argmax_launches, sgb.bwd_launches)
        t0 = time.perf_counter()
        losses.append(float(step(x, gt)))  # the copy waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = (sgb.argmax_launches, sgb.bwd_launches)
        if not all(a > b for a, b in zip(after, before)):
            raise AssertionError(f"a trainable kernel did not launch on this "
                                 f"step: (A, B) {before} -> {after}")
    launches = {"sgb_contract_pool_argmax": sgb.argmax_launches,
                "sgb_contract_pool_bwd": sgb.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss_after = float(fused_loss(params, frames[0], gt, cfg))
    ms = float(np.median(step_ms))
    out = dict(loss_warmup=loss0, losses=losses, loss_warmup_after=loss_after,
               ms_per_step=ms, step_ms=step_ms,
               train_waveforms_per_s=B / ms * 1e3, peak_memory_gb=peak / 1e9,
               launches=launches)
    log(f"train path: {json.dumps(out)}")
    if not all(np.isfinite(losses + [loss0, loss_after])):
        raise AssertionError(f"a loss is not finite: {out}")
    if not loss_after < loss0:
        raise AssertionError(f"the warm-up batch's loss did not fall: "
                             f"{loss0} -> {loss_after}")
    prof = profile_runs(lambda x: float(step(x, gt)), frames[1:])
    prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
    log(f"train profile: {json.dumps(prof)}")
    log(f"seed witness: {json.dumps(seed_witness(dev, cfg, frames, gt))}")
    return out


def seed_witness(dev, cfg, frames, gt) -> dict:
    """The same 5 steps from the serving weights (seed SEED), through the
    kernels and through their plain versions: each step's loss, and the
    warm-up batch's loss after the steps. These weights start within
    about 0.011 of the loss of an all-zero heatmap, and AdamW's first step
    moves every weight by lr; where both paths end above their start, the
    step itself raises the loss, not the kernels, and the train path's
    weights come from the next seed for that reason. Printed, not held."""
    out = {}
    for name, forward in (("kernel", stofnet_apply_fused),
                          ("plain", stofnet_apply_reference)):
        params, step = trainer(dev, SEED, cfg, forward)
        losses = [float(step(x, gt)) for x in frames]
        with torch.no_grad():
            after = float(fused_loss(params, frames[0], gt, cfg,
                                     forward=forward))
        out[name] = dict(losses=losses, loss_warmup_after=after)
    return out


def daemon_path(dev, state) -> dict:
    """The serving daemon (``cli/serve.build``) from a checkpoint of the
    seeded weights, its dtype gate left at auto, every bucket warmed
    before the server binds, under :func:`daemon_traffic`. On these
    weights the gate serves bf16, whose fused route runs the kernels: the
    phase fails where it chose f32 (the ``StofNet`` module, no kernel) or
    where a kernel of the fused route did not launch. Returns the launches
    of the traffic by kernels-line row."""
    rng = np.random.default_rng(SEED + 3)
    rows = list(gate_batch(DAEMON_CLIENTS * DAEMON_REQUESTS, L, rng)[:, 0])
    batch = gate_batch(B, L, rng)[:, 0]
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(Path(tmp) / "armadillo-seed0.pt", state)
        args = {"model_file": "armadillo", "ckpt_dir": tmp, "length": L,
                "max_batch": B, "max_wait_ms": 2, "port": 0}
        dtype, launches = daemon_traffic("daemon (dtype=auto)", args, state,
                                         dev, rows, batch)
    if dtype != torch.bfloat16 or not all(launches.values()):
        raise AssertionError(f"daemon: served {dtype}, not bf16 on the fused "
                             f"route, or a kernel did not launch: {launches}")
    return launches


def daemon_traffic(name, args, state, dev, rows, batch, dtype=None,
                   shards=1):
    """Build the daemon of ``args``; DAEMON_CLIENTS clients send
    DAEMON_REQUESTS single waveforms each from the list ``rows`` (client c
    the c-th run of them; their lengths are those the daemon serves) and
    one more client the (B, L) ``batch`` over the s8c wire, the launch
    counts set to 0 just before the traffic and read just after; every
    returned row must equal ``make_pipeline``'s direct coords for it bit
    for bit (the s8c rows: on the decoded wire rows), in ``dtype`` or, when
    None, the one the daemon's dtype gate chose. The route is read from the
    launch counts: on the fused route every batch launches both kernels
    once. Shuts the daemon down and drains it. Returns the daemon's dtype
    and the traffic's launches by kernels-line row, the serving SGB
    kernel's by the length of their batches."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        hostd, server, port = serve_cli.build(args)
    build_s = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        log(f"{name} build: {line}")
    if dtype is None:
        dtype = (torch.bfloat16 if args.get("dtype") == "bfloat16"
                 or "bf16 OK" in err.getvalue() else torch.float32)
    got = [None] * len(rows)
    lat = np.zeros(len(rows))
    box = {}

    def single(c: int) -> None:
        with ServingClient(("127.0.0.1", port)) as cli:
            for i in range(c * DAEMON_REQUESTS, (c + 1) * DAEMON_REQUESTS):
                t = time.perf_counter()
                got[i] = cli.infer(rows[i])
                lat[i] = time.perf_counter() - t

    def wire() -> None:
        with ServingClient(("127.0.0.1", port), wire="s8c") as cli:
            box["s8c"] = cli.infer(batch)
            box["stats"] = cli.stats()

    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=single, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        threads.append(threading.Thread(target=wire))
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        wall = time.perf_counter() - t0
        c = counts()
        if any(t.is_alive() for t in threads) or "stats" not in box:
            raise AssertionError(f"{name}: a client did not finish")
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()
    stats = hostd.stats()
    per_length = (stats["per_length"] if "per_length" in stats
                  else {hostd.length: stats})
    batches = {n: s["batches"] for n, s in per_length.items()}
    fused = c["sgb_dma.launches"] > 0
    if (c["sgb_dma.launches"] != c["conv_stack.launches"]
            or (fused and c["sgb_dma.launches"]
                != shards * sum(batches.values()))):
        raise AssertionError(f"{name}: launches {c} on {batches} batches, "
                             f"not both kernels {shards} times a batch")
    launches = {"conv_stack_fused": c["conv_stack.launches"]}
    for n, k in batches.items():
        launches[SGB_ROW[n]] = shards * k if fused else 0

    direct = make_pipeline(state, {"upsample_factor": UP}, dtype=dtype,
                           device=dev)
    want = [None] * len(rows)
    for n in batches:
        idx = [i for i, r in enumerate(rows) if len(r) == n]
        xs = np.stack([rows[i] for i in idx])[:, None]
        coords = np.concatenate([direct(xs[j:j + B]).cpu().numpy()
                                 for j in range(0, len(idx), B)])
        for i, row in zip(idx, coords):
            want[i] = row
    wire_rows = decode_payload(encode_rows(batch, WIRE_INT8C, DEFAULT_CHUNKS),
                               WIRE_INT8C, B, L, DEFAULT_CHUNKS)
    want_s8c = direct(wire_rows).cpu().numpy()
    out = dict(build_s=build_s, dtype=str(dtype),
               route="fused" if fused else "module", route_calls=direct.calls,
               requests=len(rows) + 1, waveforms=len(rows) + B, wall_s=wall,
               requests_per_s=(len(rows) + 1) / wall,
               waveforms_per_s=(len(rows) + B) / wall,
               single_latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
               single_latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
               buckets_used={n: {k: v for k, v in s["bucket_counts"].items()
                                 if v} for n, s in per_length.items()},
               rows_differing=sum(not np.array_equal(g, w)
                                  for g, w in zip(got, want)),
               rows_differing_by_length={n: sum(
                   not np.array_equal(g, w) for g, w, r in
                   zip(got, want, rows) if len(r) == n) for n in batches},
               s8c_rows_differing=int((box["s8c"] != want_s8c).any(1).sum()),
               launches=launches, client_stats=box["stats"])
    log(f"{name}: {json.dumps(out)}")
    if out["rows_differing"] or out["s8c_rows_differing"]:
        raise AssertionError(f"{name}: rows differ from make_pipeline's "
                             f"direct coords: {out['rows_differing']} single"
                             f", {out['s8c_rows_differing']} s8c")
    if stats["errors"] or stats["pending"]:
        raise AssertionError(f"{name}: errors or undrained work: {stats}")
    return dtype, launches


def tf32_rows(dev, state) -> None:
    """What TF32 moves, measured before its repair was trusted: the daemon
    gate's batch (GATE_ROWS echo rows at L, seed GATE_SEED) through the f32
    ``StofNet`` module and the f32 int8 route (calibrated on the int8
    phase's batch), each with cuDNN's TF32 on (PyTorch's default) and off;
    prints the rows whose coords differ, those that move by more than 1
    sample, and the largest change of the heatmap beside its largest
    value. Then the repair: ``make_pipeline`` in f32 under PyTorch's
    default flags must give the module's TF32-off coords bit for bit, and
    leave the flag on."""
    x = gate_batch(GATE_ROWS, L, np.random.default_rng(GATE_SEED))
    ov = {"upsample_factor": UP}
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"], max_echoes=DAEMON_ECHOES)
    q = quantize_stofnet(state, gate_batch(B, L, np.random.default_rng(
        SEED + 4)))
    model = StofNet(device=dev)
    model.load_state_dict(state)
    xd = torch.from_numpy(x).to(dev)
    forwards = {"module_f32": model,
                "int8_f32": lambda xb: stofnet_apply_int8(
                    q, xb, dtype=torch.float32)}
    out, off = {}, {}
    for name, forward in forwards.items():
        heat, coords = {}, {}
        for tf32 in (True, False):
            with torch.inference_mode(), (contextlib.nullcontext() if tf32
                                          else full_f32()):
                heat[tf32] = forward(xd)
                coords[tf32] = mask2coords(
                    heat[tf32], DECODE["window_size"], DECODE["threshold"],
                    UP, DAEMON_ECHOES).cpu()
        on, off[name] = coords[True], coords[False]
        out[name] = dict(
            rows=GATE_ROWS, rows_differing=int((on != off[name]).any(1).sum()),
            rows_moved=row_agreement(on, off[name])[1],
            heat_max_abs_diff=float((heat[True] - heat[False]).abs().max()),
            heat_max_abs=float(heat[False].abs().max()))
    out["train_step_f32"] = tf32_train_step(dev, state)
    pipe = make_pipeline(state, ov, dtype=torch.float32, device=dev, **decode)
    out["pipeline_f32_equals_module_without_tf32"] = bool(torch.equal(
        pipe(x).cpu(), off["module_f32"]))
    out["cudnn_allow_tf32_after"] = torch.backends.cudnn.allow_tf32
    log(f"tf32 rows: {json.dumps(out)}")
    if not (out["pipeline_f32_equals_module_without_tf32"]
            and out["cudnn_allow_tf32_after"]):
        raise AssertionError(f"tf32: the f32 pipeline computes in TF32 or "
                             f"changes the caller's flag: {out}")


def tf32_train_step(dev, state) -> dict:
    """What TF32 moves in one f32 training step of the ``StofNet`` module at
    B, L (the train path's noise frames and GT): the loss and its backward
    with cuDNN's TF32 on (PyTorch's default) and off; the two losses and
    the relative L2 of each gradient, on against off."""
    frames, gt = train_batches(np.random.default_rng(SEED + 5), 1, dev)
    model = StofNet(device=dev)
    model.load_state_dict(state)
    kernel = gaussian_kernel(7, 1.0, device=dev)
    loss, grads = {}, {}
    for tf32 in (True, False):
        model.zero_grad(set_to_none=True)
        with contextlib.nullcontext() if tf32 else full_f32():
            value = heatmap_loss(model(frames[0]), gt, kernel=kernel)[0]
            value.backward()
        loss[tf32] = float(value.detach())
        grads[tf32] = {k: p.grad for k, p in model.named_parameters()}
    rel = {k: rel_l2(g, grads[False][k]) for k, g in grads[True].items()}
    return dict(loss_tf32=loss[True], loss_f32=loss[False],
                grad_rel_l2_max=max(rel.values()), grad_rel_l2=rel)


def int8_path(dev, state) -> None:
    """The int8-SGB route of ``make_pipeline``, calibrated on a (B, 1, L)
    gate batch, the launch counts set to 0 just before the phase and held
    at 0 just after (no kernel of the port launches: its s8 product is
    ``torch._int_mm``):

    - served in bf16 (its default) and in f32, each over one warm-up
      batch and N_BATCHES fresh batches: ms per batch, peak memory;
    - the bf16 route held to two twins, as the main path holds the
      kernels to the plain path and its CPU witness: bit for bit to the
      same forward on the card with the s8 conv as K shifted products
      (``impl="dots"``; s32 sums are exact, so the codes are the same),
      and to the same bf16 int8 forward on the CPU on the card's
      calibration (the same codes and scales, another order of float
      sums) on moved rows: no more than twice what summation order alone
      moves in a bf16 forward (the bf16 ``StofNet`` module on the card
      against it on the CPU) plus ROW_NOISE. Its slots against the CPU
      twin are printed: bf16 summation order moves more than 1 % of them
      on these weights, in the module as in the int8 route;
    - the f32 route held to the f32 module on >= AGREE_MIN of the slots,
      the bench's gate, as the JAX package's own int8 test holds it: what
      the quantization alone moves (the bf16 route's agreement with the
      f32 and bf16 modules printed beside it; bf16 alone moves more on
      these weights);
    - ``bench_paths.try_int8_pipeline`` on the calibration batch, gated
      against the twin's coords on it: it must return a pipe, which must
      equal the served bf16 route's coords there bit for bit."""
    rng = np.random.default_rng(SEED + 4)
    ov = {"upsample_factor": UP}
    calib = gate_batch(B, L, rng)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"],
                  max_echoes=DECODE["max_echoes"])
    reset_launch_counts()
    out, got = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t0 = time.perf_counter()
        pipe = make_pipeline(state, ov, device=dev, int8_calib=calib,
                             dtype=dtype, **decode)
        calib_s = time.perf_counter() - t0

        def run(x, pipe=pipe):
            return pipe(x).cpu()

        run(gate_batch(B, L, rng))  # cuDNN's algorithm choice, not timed
        torch.cuda.reset_peak_memory_stats()
        got[name], batch_ms = serve_timed(f"int8 route {name}", run,
                                          batches, {})
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(batch_ms))
        if pipe.calls["int8"] != 1 + N_BATCHES:
            raise AssertionError(f"int8 route {name}: calls {pipe.calls}")
        out[name] = dict(calibration_s=calib_s, ms_per_batch=ms,
                         batch_ms=batch_ms, waveforms_per_s=B / ms * 1e3,
                         peak_memory_gb=peak / 1e9)
        if name == "bf16":
            served = pipe
            prof = profile_runs(run, batches)
            prof["idle_share_derived"] = 1.0 - prof["device_busy_ms"] / ms
            log(f"int8 route bf16 profile: {json.dumps(prof)}")

    t0 = time.perf_counter()
    q = quantize_stofnet(state, calib)  # the card's calibration
    q_cpu = to_cpu(q)
    with torch.inference_mode(), full_f32():  # the references without TF32
        dots = torch.cat([mask2coords(stofnet_apply_int8(
            q, torch.from_numpy(x).to(dev), impl="dots"), **DECODE).cpu()
            for x in batches])
        twin = [mask2coords(stofnet_apply_int8(
            q_cpu, torch.from_numpy(x)), **DECODE) for x in [calib] + batches]
        ref = {(dt, where): torch.from_numpy(np.concatenate([module_coords(
            state, ov, x, dt, where, **decode) for x in batches]))
            for dt, where in ((torch.float32, dev), (torch.bfloat16, dev),
                              (torch.bfloat16, "cpu"))}
    twin_calib, twin = twin[0], torch.cat(twin[1:])
    m16, m16_cpu, m32 = (ref[torch.bfloat16, dev], ref[torch.bfloat16, "cpu"],
                         ref[torch.float32, dev])

    def pair(a, b):
        return dict(slots=coord_agreement(a, b), moved=row_agreement(a, b)[1])

    out.update(references_s=time.perf_counter() - t0,
               bf16_dots_equal=bool(torch.equal(got["bf16"], dots)),
               bf16_twin=pair(got["bf16"], twin),
               module_bf16_card_cpu=pair(m16, m16_cpu),
               bf16_module_f32=pair(got["bf16"], m32),
               bf16_module_bf16=pair(got["bf16"], m16),
               f32_module_f32=pair(got["f32"], m32))
    log(f"int8 route: {json.dumps(out)}")
    if not out["bf16_dots_equal"]:
        raise AssertionError("int8 route bf16: its coords differ from the "
                             "same forward's with the s8 conv as K shifted "
                             "products on the card (exact s32 sums)")
    moved, base = out["bf16_twin"]["moved"], out["module_bf16_card_cpu"][
        "moved"]
    if moved > 2 * base + ROW_NOISE:
        raise AssertionError(
            f"int8 route bf16: moves {moved} rows against its CPU twin, more "
            f"than twice the {base} that summation order moves in the bf16 "
            f"module (card against CPU) plus {ROW_NOISE}")
    if out["f32_module_f32"]["slots"] < AGREE_MIN:
        raise AssertionError(f"int8 route f32: {out['f32_module_f32']} of "
                             f"the f32 module's slots (< {AGREE_MIN})")

    xg = torch.from_numpy(calib).to(dev)
    gated = try_int8_pipeline(state, ov, xg, twin_calib)
    if gated is None:
        raise AssertionError("try_int8_pipeline: the gate refused the int8 "
                             "path against its CPU twin")
    card = gated(state, xg).cpu()
    same = bool(torch.equal(card, served(calib).cpu()))
    log(f"try_int8_pipeline: gated pipe, impl {gated.impl}, "
        f"{coord_agreement(card, twin_calib):.6f} of the slots of the CPU "
        f"twin, {row_agreement(card, twin_calib)[1]} rows moved; equal to "
        f"the served bf16 route: {same}")
    if not same:
        raise AssertionError("try_int8_pipeline: its coords differ from the "
                             "served bf16 int8 route's on the same batch")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"int8 phase: a kernel launched: {launched}")


def export_path(dev, state) -> dict:
    """The artifacts of ``serve.export_pipeline`` at B, L, bf16 on the
    seeded weights, exported, saved, loaded and served on the card: a
    batch-polymorphic one (``batch="b"``), one at the fixed batch B and a
    weightless one (its state from the ``.weights.npz`` sidecar). Each
    prints its export and load seconds and its size, serves a warm-up
    batch and N_BATCHES fresh gate batches, each launching the serving SGB
    kernel and the conv stack once through their custom ops (counts set to
    0 before each artifact's batches), and must give ``make_pipeline``'s
    direct coords on them bit for bit; ms per batch (median) beside the
    direct pipeline's, and the device time of the weight layouts that the
    weightless program runs on every call. Then the daemon from two
    artifacts (``artifact=``, L and L_UNCHUNKED) under
    :func:`daemon_traffic`, half its clients at each length. Returns the
    phase's launches by kernels-line row."""
    rng = np.random.default_rng(SEED + 5)
    ov = {"upsample_factor": UP}
    decode = dict(window_size=DECODE["window_size"],
                  threshold=DECODE["threshold"],
                  max_echoes=DECODE["max_echoes"])
    warm = gate_batch(B, L, rng)
    batches = [gate_batch(B, L, rng) for _ in range(N_BATCHES)]
    direct = make_pipeline(state, ov, device=dev, **decode)

    def run_direct(x):
        return direct(x).cpu()

    run_direct(warm)  # cuDNN's algorithm choice, not timed
    want, direct_ms = serve_timed("export phase direct", run_direct, batches,
                                  SERVE[L])
    out = {"direct_ms_per_batch": float(np.median(direct_ms))}
    launches = {"sgb_contract_pool_dma": 0, "conv_stack_fused": 0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for kind, batch in (("b", "b"), ("fixed", B), ("weightless", "b")):
            t0 = time.perf_counter()
            if kind == "weightless":
                program, weights = export_pipeline_weightless(
                    state, ov, batch, L, device=dev, **decode)
            else:
                program = export_pipeline(state, ov, batch, L, device=dev,
                                          **decode)
                weights = None
            export_s = time.perf_counter() - t0
            paths[kind] = path = save_pipeline(Path(tmp) / f"{kind}.pt2",
                                               program, weights)
            sidecar = Path(str(path) + ".weights.npz")
            t0 = time.perf_counter()
            served = load_pipeline(path)
            load_s = time.perf_counter() - t0

            def run(x, served=served):
                return served(x).cpu()

            run(warm)
            reset_launch_counts()
            got, batch_ms = serve_timed(f"export {kind}", run, batches,
                                        SERVE[L])
            c = counts()
            launches["sgb_contract_pool_dma"] += c["sgb_dma.launches"]
            launches["conv_stack_fused"] += c["conv_stack.launches"]
            out[kind] = dict(
                export_s=export_s, load_s=load_s,
                file_mb=path.stat().st_size / 1e6,
                sidecar_mb=(sidecar.stat().st_size / 1e6
                            if sidecar.exists() else 0.0),
                in_spec=[str(d) for d in served.in_specs[0].shape],
                equal_to_direct=bool(torch.equal(got, want)),
                ms_per_batch=float(np.median(batch_ms)), batch_ms=batch_ms)
        kernel, bias = contract_bf16(state)
        out["weightless_layout_ms"] = time_ms(lambda: (
            sgb.sgb_dma_weights(kernel, bias, torch.bfloat16),
            conv_stack.stack_weights(state, torch.bfloat16)), [()])
        log(f"export phase: {json.dumps(out)}")
        bad = [k for k in ("b", "fixed", "weightless")
               if not out[k]["equal_to_direct"]]
        if bad:
            raise AssertionError(f"export phase: artifacts {bad} differ from "
                                 f"make_pipeline's direct coords")

        paths["l2000"] = save_pipeline(Path(tmp) / "l2000.pt2",
                                       export_pipeline(
                                           state, ov, "b", L_UNCHUNKED,
                                           device=dev,
                                           max_echoes=DAEMON_ECHOES))
        paths["l8000"] = save_pipeline(Path(tmp) / "l8000.pt2",
                                       export_pipeline(
                                           state, ov, "b", L, device=dev,
                                           max_echoes=DAEMON_ECHOES))
        half = DAEMON_CLIENTS // 2 * DAEMON_REQUESTS
        rows = (list(gate_batch(half, L, rng)[:, 0])
                + list(gate_batch(half, L_UNCHUNKED, rng)[:, 0]))
        args = {"artifact": f"{paths['l8000']},{paths['l2000']}",
                "max_batch": B, "max_wait_ms": 2, "port": 0}
        _, served = daemon_traffic(f"daemon (artifacts L={L}, "
                                   f"{L_UNCHUNKED})", args,
                                   state, dev, rows,
                                   gate_batch(B, L, rng)[:, 0],
                                   dtype=torch.bfloat16)
    if not all(served.values()):
        raise AssertionError(f"daemon from artifacts: a kernel did not "
                             f"launch: {served}")
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    return launches


class DriverProbe:
    """Readings of ``cli/main.py``'s runs taken from outside the driver: it
    wraps the ``make_train_step``, ``pipeline_batches``,
    ``find_threshold`` and ``save_checkpoint`` that the driver's module
    calls, and changes nothing they compute. Each train step is timed on
    the host clock up to the card's end (the driver's next line copies the
    loss to the host, which waits for the card anyway) and its start kept;
    each batch the training loop takes from its iterator is timed from the
    request to its arrival (the loader's wait and the copy's enqueueing).
    Each training loop keeps its wall time from its first request to its
    end, its steps' range, its waits and the time its last host batch
    arrived (the loader's threads have no item left to read after it);
    ``find_threshold`` and each checkpoint write are timed on the host.
    The train step's model and its weights before the first step are
    kept."""

    def __init__(self):
        self.step_ms, self.step_t0, self.th_ms = [], [], []
        self.save_s = []  # each checkpoint write
        self.loops = []  # dicts: s, steps (a range), wait_ms, loader_done
        self.steps = 0
        self.model = self.init_state = None
        self._saved = {}

    def __enter__(self):
        self._saved = {k: getattr(cli_main, k) for k in (
            "make_train_step", "pipeline_batches", "find_threshold",
            "save_checkpoint")}
        make_step = self._saved["make_train_step"]
        pipeline = self._saved["pipeline_batches"]
        find = self._saved["find_threshold"]
        save = self._saved["save_checkpoint"]

        def make_train_step(model, *args, **kwargs):
            self.model = model
            self.init_state = {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}
            step = make_step(model, *args, **kwargs)

            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.step_t0.append(t0)
                self.steps += 1
                return out
            return timed

        def pipeline_batches(host_iter, put):
            steps0, waits, arrived = self.steps, [], []

            def host():
                for batch in host_iter:
                    arrived.append(time.perf_counter())
                    yield batch
            it = pipeline(host(), put)
            t_first = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                waits.append((time.perf_counter() - t0) * 1e3)
                yield item
            if self.steps > steps0:  # a training loop, not validation
                self.loops.append(dict(
                    s=time.perf_counter() - t_first,
                    steps=range(steps0, self.steps), wait_ms=waits,
                    loader_done=arrived[-1]))

        def find_threshold(*a, **kw):
            t0 = time.perf_counter()
            out = find(*a, **kw)
            self.th_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def save_checkpoint(*a, **kw):
            t0 = time.perf_counter()
            out = save(*a, **kw)
            self.save_s.append(time.perf_counter() - t0)
            return out

        cli_main.save_checkpoint = save_checkpoint
        cli_main.make_train_step = make_train_step
        cli_main.pipeline_batches = pipeline_batches
        cli_main.find_threshold = find_threshold
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            setattr(cli_main, k, v)


def trace_summary(trace_dir: Path, steps: int) -> dict:
    """The profiled window of a driver run from its Chrome trace: its wall
    time (first to last event), the card's busy time (the union of its
    kernels, copies and sets) and idle share, and device ms a step by
    kernel name (the 8 largest)."""
    (path,) = Path(trace_dir).glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev_events = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev_events:
        raise AssertionError(f"{path}: no device activity in the trace")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, t0
    for e in sorted(dev_events, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    by_name: dict = {}
    for e in dev_events:
        name = e["name"][:60]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(window_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / (t1 - t0),
                device_ms_per_step=dict(top))


def driver_train(name: str, work: Path, data: str, argv) -> dict:
    """One ``cli/main.run`` training from ``data`` (the config's defaults
    and ``argv``, 2 epochs or more) under a :class:`DriverProbe`; prints
    and returns its readings. The profiler traces steps 2..6, so the step
    time, the rates and the loader's wait are the last epoch's, which the
    profiler does not slow; every step after the first is also read by
    its state: profiled, or unprofiled with the loader busy or idle."""
    prof_dir = work / f"profile_{name}"
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        "model=stofnet", f"batch_size={B}", f"data_dir={data}",
        f"run_dir={work / 'runs'}", f"ckpt_dir={work / 'ckpts'}",
        f"profile_dir={prof_dir}", f"profile_steps={PROFILE_STEPS}", *argv])
    torch.cuda.reset_peak_memory_stats()
    with DriverProbe() as probe:
        t0 = time.perf_counter()
        summary = cli_main.run(cfg)
        wall = time.perf_counter() - t0
    log_path = Path(cfg.run_dir) / f"{summary['run_name']}.jsonl"
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    losses = [e["train_loss"] for e in events if e["event"] == "train"]
    last = probe.loops[-1]
    if last["steps"].start <= PROFILE_STEPS:
        raise AssertionError(f"{name} training: the last epoch holds a "
                             f"profiled step")
    by_state: dict = {"profiled": [], "loader busy": [], "loader idle": []}
    for loop in probe.loops:
        for i in loop["steps"]:
            if i == 0:  # the first step's one-time work
                continue
            state = ("profiled" if i <= PROFILE_STEPS else "loader busy"
                     if probe.step_t0[i] < loop["loader_done"]
                     else "loader idle")
            by_state[state].append(probe.step_ms[i])
    ms = float(np.median([probe.step_ms[i] for i in last["steps"]]))
    out = dict(
        run_s=wall, steps=len(losses), epochs=summary["epochs"],
        val_loss=summary["val_loss"], first_loss=losses[0],
        ms_per_step=ms, ms_per_step_by_state={
            k: dict(median=float(np.median(v)), n=len(v))
            for k, v in by_state.items() if v},
        step_ms=probe.step_ms,
        train_waveforms_per_s=len(last["steps"]) * B / last["s"],
        train_waveforms_per_s_by_epoch=[
            len(loop["steps"]) * B / loop["s"] for loop in probe.loops],
        bare_step_waveforms_per_s=B / ms * 1e3,
        loader_wait_ms_per_step=dict(
            median=float(np.median(last["wait_ms"])),
            mean=float(np.mean(last["wait_ms"])), max=max(last["wait_ms"])),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=trace_summary(prof_dir, PROFILE_STEPS),
        summary={k: v for k, v in summary.items() if k != "run_name"})
    log(f"data phase, {name} training: {json.dumps(out)}")
    if len(losses) != probe.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} training: a loss is not finite or a "
                             f"step went unlogged: {losses}")
    return dict(out, probe=probe, cfg=cfg, summary=summary)


def first_loss_on_cpu(cfg, init_state) -> float:
    """The first step's loss of a StofNet training run recomputed on the
    CPU in f32: the initial weights on the first batch of a second loader
    built like the driver's (same seed, split, epoch and batch size; a
    PALA batch's channels flattened as the driver flattens them), the
    forward in chunks of 16 rows, the loss over the whole batch."""
    cfg = cfg.copy()
    ds, info = cli_main.build_dataset(cfg)
    train_idx, _ = split_dataset(len(ds), 0.2, seed=int(cfg.seed))
    loader = DataLoader(ds, train_idx, batch_size=int(cfg.batch_size),
                        shuffle=True, drop_last=True, seed=int(cfg.seed))
    loader.set_epoch(0)
    frame, gt = cli_main.batch_to_arrays(next(iter(loader)), info["kind"])
    gt_true = np.round(gt[:, None, :] * int(cfg.upsample_factor)).astype(
        np.int32)
    model = StofNet(device="cpu")
    model.load_state_dict(init_state)
    step = make_eval_step(model, cli_main._loss_config(cfg))
    with torch.no_grad():
        pred = torch.cat([model(torch.from_numpy(f))
                          for f in np.split(frame, len(frame) // 16)])
    out = step.finish(pred, torch.from_numpy(gt), torch.from_numpy(gt_true))
    return float(out["loss"])


def loader_alone(cfg) -> dict:
    """The training loader's own rate, with no device work: the first
    LOADER_BATCHES batches of the train split of a fresh dataset built
    like the driver's, at the driver's default thread count and with one
    thread."""
    out = {}
    for workers in (default_num_workers(), 0):
        ds, _ = cli_main.build_dataset(cfg.copy())
        train_idx, _ = split_dataset(len(ds), 0.2, seed=int(cfg.seed))
        loader = DataLoader(ds, train_idx, batch_size=B, shuffle=True,
                            drop_last=True, seed=int(cfg.seed),
                            num_workers=workers)
        t0 = time.perf_counter()
        items = sum(len(batch[1]) for batch in itertools.islice(
            loader, LOADER_BATCHES))
        dt = time.perf_counter() - t0
        out[f"threads_{max(workers, 1)}"] = dict(
            items_per_s=items / dt, ms_per_batch=dt / LOADER_BATCHES * 1e3)
    log(f"data phase, the loader alone: {json.dumps(out)}")
    return out


def driver_eval(name: str, work: Path, data: str, model_file: str,
                argv=(), phase: str = "data phase") -> dict:
    """``cli/main.run`` with ``evaluate=True`` from ``model_file`` on the
    test split (``model=stofnet`` unless ``argv`` names another); prints
    the summary, the forward's ms a batch (the driver's own reading: the
    first batch's is NaN, so the second batch's) and ``find_threshold``'s
    ms a batch."""
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        "model=stofnet", f"batch_size={B}", f"data_dir={data}",
        f"run_dir={work / 'runs'}", f"ckpt_dir={work / 'ckpts'}",
        f"model_file={model_file}", "evaluate=True", *argv])
    with DriverProbe() as probe:
        t0 = time.perf_counter()
        summary = cli_main.run(cfg)
        wall = time.perf_counter() - t0
    log_path = Path(cfg.run_dir) / f"{summary['run_name']}.jsonl"
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    forward_ms = [e["inference_time"] * B * 1e3 for e in events
                  if e["event"] == "val"]
    out = dict(run_s=wall, summary={k: v for k, v in summary.items()
                                    if k != "run_name"},
               forward_ms_per_batch=forward_ms,
               find_threshold_ms_per_batch=probe.th_ms)
    log(f"{phase}, {name} evaluation: {json.dumps(out)}")
    # the Jaccard index and the distance are NaN where nothing is detected
    # (the weights train for 2 epochs): printed, not held
    if summary.get("random_init") or not all(np.isfinite([
            summary["val_loss"], summary["total_inference_time"]])):
        raise AssertionError(f"{name} evaluation: {summary}")
    return out


@contextlib.contextmanager
def stand_in():
    """The chirp stand-in of the data and zoo phases, generated once under
    the gitignored ``build/`` (a relative path: the driver picks the
    dataset's class by words in it) and removed after both: (work dir,
    data dir)."""
    work = Path("build") / "chip_smoke_driver"
    shutil.rmtree(work, ignore_errors=True)
    data = str(work / "stof_chirp101_dataset")
    try:
        t0 = time.perf_counter()
        generate_chirp_dataset(data, **DRIVER_DATA)
        log(f"data phase: generated {data} in "
            f"{time.perf_counter() - t0:.1f} s")
        if cli_main.dataset_kind(data) != "chirp" or not native.available():
            raise AssertionError(f"data phase: the native loader is not "
                                 f"built (g++), or {data} is not chirp data")
        yield work, data
    finally:
        shutil.rmtree(work, ignore_errors=True)


def data_path(dev, work: Path, data: str) -> str:
    """The data phase (item 11 of the module docstring): train and
    evaluate through ``cli/main.py`` from the chirp stand-in, the launch
    counts set to 0 before the phase and held at 0 after it: the driver's
    path runs no kernel of the port. Returns the f32 run's checkpoint
    name."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    f32 = driver_train("f32", work, data, ["epochs=2", "export_pth=True"])
    model, summary = f32["probe"].model, f32["summary"]
    pth, _ = load_stofnet(summary["export_pth"])
    final = {k: v.cpu() for k, v in model.state_dict().items()}
    if not (Path(summary["checkpoint"]).is_file()
            and pth.keys() == final.keys()
            and all(torch.equal(pth[k], v) for k, v in final.items())):
        raise AssertionError("data phase: the checkpoint is missing or "
                             "the exported .pth is not the run's final "
                             "parameters")
    t0 = time.perf_counter()
    cpu = first_loss_on_cpu(f32["cfg"], f32["probe"].init_state)
    rel = abs(f32["first_loss"] - cpu) / abs(cpu)
    log(f"data phase: first loss {f32['first_loss']!r} on the card, "
        f"{cpu!r} on the CPU, relative {rel:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not rel <= 1e-6:  # measured: exact; TF32 moves it by 3.3e-5
        raise AssertionError(f"data phase: the first loss is {rel:.3e} "
                             f"from the CPU's, beyond 1e-6")
    loader_alone(f32["cfg"])
    driver_train("amp", work, data, ["epochs=2", "amp=True"])
    name = Path(summary["checkpoint"]).name
    driver_eval("f32", work, data, name)
    driver_eval("int8 bf16", work, data, name,
                ["int8=True", "compute_dtype=bfloat16"])
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"data phase: a kernel launched: {launched}")
    log(f"data phase: {time.perf_counter() - t_phase:.1f} s")
    return name


def fresh_peak() -> None:
    """Reset the card's peak-memory reading with nothing of an earlier
    family alive: collected cycles (which can hold a pipeline's weights)
    freed first."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def zoo_state(name: str) -> dict:
    """Seeded random weights of a zoo family at the chirp configuration's
    widths, drawn on the CPU (``registry.build_model``)."""
    model, _ = build_model(name, **ZOO_OVERRIDES, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
    return model.state_dict()


def zoo_serve(dev, name: str, rng) -> None:
    """One family through ``serve.make_pipeline(model_name=)`` on the card
    (item 12 of the module docstring): per dtype a warm-up batch and
    N_BATCHES timed gate batches of B at the family's driver length, each
    launching no kernel, then the first timed batch again under the
    profiler (device time by kernel); the card against the same pipeline
    on the CPU over ZOO_ROWS rows of the first batch, and the bf16
    probe."""
    length = L * (UP if name == "unet" else 1)
    t_family = t0 = time.perf_counter()
    state = zoo_state(name)
    init_s = time.perf_counter() - t0
    batches = [gate_batch(B, length, rng) for _ in range(N_BATCHES + 1)]
    rows = batches[1][:ZOO_ROWS]
    out = dict(length=length, init_on_cpu_s=init_s,
               parameters=sum(v.numel() for k, v in state.items()
                              if not k.endswith(ZOO_BUFFERS)))
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fresh_peak()
        kw = dict(model_name=name, dtype=dtype, max_echoes=DECODE[
            "max_echoes"], threshold=None)
        pipe = make_pipeline(state, ZOO_OVERRIDES, device=dev, **kw)
        before = counts()
        batch_ms = []
        for i, x in enumerate(batches):
            t0 = time.perf_counter()
            got = pipe(x).cpu()
            if i:
                batch_ms.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"zoo {name} {label}: non-finite "
                                     f"output")
        if counts() != before:
            raise AssertionError(f"zoo {name} {label}: a kernel launched")
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_runs(lambda x: pipe(x).cpu(), batches[1:2])
        card_rows = pipe(rows).cpu()
        cpu_rows = make_pipeline(state, ZOO_OVERRIDES, device="cpu",
                                 **kw)(rows)
        ms = float(np.median(batch_ms))
        res = dict(ms_per_batch=ms, batch_ms=batch_ms,
                   waveforms_per_s=B / ms * 1e3, out_shape=list(got.shape),
                   detected_rows=float((got != 0).any(1).float().mean()),
                   peak_memory_gb=peak, profile=prof)
        if name == "zonzini":
            rel = float(((card_rows - cpu_rows).abs()
                         / cpu_rows.abs().clamp_min(1e-12)).max())
            res["max_rel_diff_vs_cpu"] = rel
            ok = rel <= ZONZINI_RTOL
        else:
            agree = float(((card_rows - cpu_rows).abs() <= 1.0).float()
                          .mean())
            res["agreement_vs_cpu"] = agree
            res["rows_agreement_vs_cpu"], res["moved_rows"] = (
                row_agreement(card_rows, cpu_rows))
            ok = agree >= AGREE_MIN
        if label == "bf16":
            res["probe_dtype_agreement"] = probe_dtype_agreement(
                state, ZOO_OVERRIDES, length=length, model_name=name,
                device=dev, max_echoes=DECODE["max_echoes"])
        log(f"zoo phase, {name} serving {label}: {json.dumps(res)}")
        # bf16: printed, not held (ESPCN's sigmoid ties and zonzini's
        # quantized ToA are traps of the reference)
        if label == "f32" and not ok:
            raise AssertionError(f"zoo {name} f32: the card disagrees with "
                                 f"the CPU: {res}")
        del pipe
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_family
    log(f"zoo phase, {name} serving: {json.dumps(out)}")


def zoo_first_loss(name: str, model, cfg, init_state) -> dict:
    """The loss of the first training batch's first ZOO_LOSS_ROWS rows from
    the run's initial weights, in train mode (Kuleshov in eval mode: its
    dropout draws differ between devices), on the card and on the CPU in
    f32 through the driver's model (moved), loader and loss."""
    cfg = cfg.copy()
    ds, _ = cli_main.build_dataset(cfg)
    train_idx, _ = split_dataset(len(ds), 0.2, seed=int(cfg.seed))
    loader = DataLoader(ds, train_idx, batch_size=B, shuffle=True,
                        drop_last=True, seed=int(cfg.seed))
    loader.set_epoch(0)
    frame, gt = cli_main.batch_to_arrays(next(iter(loader)))
    frame, gt = frame[:ZOO_LOSS_ROWS], gt[:ZOO_LOSS_ROWS]
    gt_true = np.round(gt[:, None, :] * int(cfg.upsample_factor)).astype(
        np.int32)
    kind = "regression" if name in REGRESSION else "heatmap"
    out = {}
    for where in ("card", "cpu"):
        dev = next(model.parameters()).device if where == "card" else "cpu"
        model.to(dev).load_state_dict(init_state)
        model.train(name != "kuleshov")
        step = make_eval_step(model, cli_main._loss_config(cfg, kind))
        with torch.no_grad(), full_f32():
            pred = model(torch.from_numpy(frame).to(dev))
        out[where] = float(step.finish(pred, torch.from_numpy(gt).to(dev),
                                       torch.from_numpy(gt_true).to(dev))[
            "loss"])
    out["rel"] = abs(out["card"] - out["cpu"]) / abs(out["cpu"])
    return out


def zoo_train(name: str, work: Path, data: str) -> str:
    """One epoch of ``cli/main.run`` at B in f32 from the family's fresh
    seeded weights, under a :class:`DriverProbe`: prints ms a step (the
    median after the first), training waveforms/s end to end and of the
    bare step, peak memory and the first-loss check; holds every loss
    finite, the first loss to the CPU's within ZOO_LOSS_RTOL and a
    BatchNorm family's running statistics moved. Returns the
    checkpoint's name."""
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        f"model={name}", f"batch_size={B}", f"data_dir={data}",
        f"run_dir={work / 'runs'}", f"ckpt_dir={work / 'ckpts'}",
        "epochs=1"])
    fresh_peak()
    with DriverProbe() as probe:
        t0 = time.perf_counter()
        summary = cli_main.run(cfg)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    log_path = Path(cfg.run_dir) / f"{summary['run_name']}.jsonl"
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    losses = [e["train_loss"] for e in events if e["event"] == "train"]
    loop = probe.loops[-1]
    ms = float(np.median(probe.step_ms[1:]))
    final = probe.model.state_dict()
    stats = [k for k in final if k.endswith(ZOO_BUFFERS[:2])]
    moved = [k for k in stats if not torch.equal(final[k].cpu(),
                                                 probe.init_state[k])]
    first = zoo_first_loss(name, probe.model, cfg, probe.init_state)
    probe.model = None
    torch.cuda.empty_cache()
    out = dict(run_s=wall, checkpoint_write_s=probe.save_s,
               steps=len(losses), first_loss=first,
               losses=losses, ms_per_step=ms, step_ms=probe.step_ms,
               train_waveforms_per_s=len(loop["steps"]) * B / loop["s"],
               bare_step_waveforms_per_s=B / ms * 1e3, peak_memory_gb=peak,
               bn_buffers_moved=f"{len(moved)}/{len(stats)}",
               summary={k: v for k, v in summary.items()
                        if k != "run_name"})
    log(f"zoo phase, {name} training: {json.dumps(out)}")
    if len(losses) != probe.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"zoo {name} training: a loss is not finite "
                             f"or a step went unlogged: {losses}")
    if not first["rel"] <= ZOO_LOSS_RTOL:
        raise AssertionError(f"zoo {name}: the first loss is {first} "
                             f"against the CPU's, beyond {ZOO_LOSS_RTOL}")
    if len(moved) != len(stats):
        raise AssertionError(f"zoo {name}: BatchNorm statistics did not "
                             f"move: {sorted(set(stats) - set(moved))}")
    return Path(summary["checkpoint"]).name


def zoo_path(dev, work: Path, data: str, rng) -> dict:
    """The zoo phase (item 12 of the module docstring), the launch counts
    set to 0 before it and held at 0 after it: JAX's zoo reaches no Pallas
    kernel. Returns the checkpoint names of the trained families."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    for name in ZOO:
        zoo_serve(dev, name, rng)
    ckpts = {}
    for name in ZOO:
        if name == "gradpeak":  # no parameters: the detector's threshold
            driver_eval(name, work, data, "none", [
                f"model={name}", "th=Null"], phase="zoo phase")
            continue
        ckpts[name] = zoo_train(name, work, data)
        driver_eval(name, work, data, ckpts[name], [f"model={name}"],
                    phase="zoo phase")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"zoo phase: a kernel launched: {launched}")
    log(f"zoo phase: {time.perf_counter() - t_phase:.1f} s")
    return ckpts


def zoo_length(name: str) -> int:
    """A zoo family's serving length at the driver's chirp configuration:
    L, the unet L * UP after its rf fold."""
    return L * (UP if name == "unet" else 1)


def zoo_export_argv(name: str, work: Path, ckpts: dict) -> list:
    """``cli/export.py``'s (and the daemon's) arguments of a zoo family at
    the zoo phase's widths, from the checkpoint its training wrote."""
    argv = [f"model={name}", f"length={zoo_length(name)}",
            f"max_echoes={DECODE['max_echoes']}", "th=Null",
            "dataset_kind=chirp", f"upsample_factor={UP}",
            f"rf_scale_factor={ZOO_OVERRIDES['rf_scale_factor']}"]
    if name == "kuleshov":
        argv.append(f"sample_num={DRIVER_DATA['sample_num']}")
    if name == "sincnet":
        argv.append(f"fs={ZOO_OVERRIDES['fs']}")
    if name != "gradpeak":
        argv += [f"model_file={ckpts[name]}", f"ckpt_dir={work / 'ckpts'}"]
    return argv


def equal_rows(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows of ``a`` equal to ``b``'s bit for bit."""
    return int((a == b).all(1).sum())


def zoo_export_family(dev, name: str, work: Path, ckpts: dict, rng) -> None:
    """One family through ``cli/export.py model=<name>`` in f32 and bf16
    (batch-polymorphic; Kuleshov weightless and in bf16 only: its f32
    artifact would repeat the route of its bf16 one over 5 GB of sidecar
    again, and the six others run the f32 export; the others baked), each
    artifact loaded and served over a warm-up batch and ZOO_EXPORT_BATCHES
    gate batches against ``make_pipeline(model_name=)`` on the card on the
    same state (under ``full_f32``, as a loaded program runs); then the
    daemon twice at bf16, from the checkpoint (``model=``) and from the
    bf16 artifact (``artifact=``), one request of B rows each, held to
    the bf16 direct pipeline. Every row must equal the direct pipeline's
    bit for bit."""
    t_family = time.perf_counter()
    length = zoo_length(name)
    base = zoo_export_argv(name, work, ckpts)
    state, ov = cli_export.resolve_zoo_variables_and_overrides(
        cli_export.parse_args(base), name)
    batches = [gate_batch(B, length, rng)
               for _ in range(ZOO_EXPORT_BATCHES + 1)]
    out_dir = work / "zoo_export"
    out_dir.mkdir(parents=True, exist_ok=True)
    res: dict = {"length": length, "bake_weights": name != "kuleshov"}
    paths = {}
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    for label, dtype in dtypes[name == "kuleshov":]:
        fresh_peak()
        out = out_dir / f"{name}_{label}.pt2"
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            path = Path(cli_export.main(base + [
                "batch=b", f"out={out}", f"dtype={label}",
                f"bake_weights={name != 'kuleshov'}"]))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_pipeline(path)
        load_s = time.perf_counter() - t0
        direct = make_pipeline(state, ov, model_name=name, dtype=dtype,
                               device=dev, max_echoes=DECODE["max_echoes"],
                               threshold=None)

        def run_direct(x):
            with full_f32():
                return direct(x).cpu()

        served(batches[0]).cpu()
        run_direct(batches[0])
        got, want, ms, direct_ms = [], [], [], []
        for x in batches[1:]:
            t0 = time.perf_counter()
            got.append(served(x).cpu())
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want.append(run_direct(x))
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        got, want = torch.cat(got), torch.cat(want)
        sidecar = Path(str(path) + ".weights.npz")
        res[label] = dict(
            export_s=export_s, load_s=load_s,
            file_mb=path.stat().st_size / 1e6,
            sidecar_mb=(sidecar.stat().st_size / 1e6
                        if sidecar.exists() else 0.0),
            ms_per_batch=float(np.median(ms)), batch_ms=ms,
            direct_ms_per_batch=float(np.median(direct_ms)),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            rows_equal=f"{equal_rows(got, want)}/{len(got)}")
        if equal_rows(got, want) != len(got):
            raise AssertionError(f"zoo export {name} {label}: rows differ "
                                 f"from make_pipeline's: {res[label]}")
        paths[label] = path
        del served
        if label == "f32":
            del direct  # bf16's stays for the daemons
    # the daemon at bf16, held to the bf16 direct pipeline: from the
    # checkpoint and from the bf16 artifact
    x = batches[1]
    want_module = direct(x).cpu().numpy()
    with full_f32():
        want_program = direct(x).cpu().numpy()
    serve_args = dict(max_batch=B, max_wait_ms=2, port=0, warmup=False)
    for src, args, want in (
            ("checkpoint", dict(cli_export.parse_args(base),
                                dtype="bfloat16", **serve_args),
             want_module),
            ("artifact", dict(artifact=str(paths["bf16"]), **serve_args),
             want_program)):
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            hostd, server, port = serve_cli.build(args)
        build_s = time.perf_counter() - t0
        try:
            with ServingClient(("127.0.0.1", port)) as cli:
                t0 = time.perf_counter()
                rows = np.asarray(cli.infer(x[:, 0]))
                request_ms = (time.perf_counter() - t0) * 1e3
        finally:
            server.shutdown()
            server.server_close()
            hostd.close()
        n_eq = equal_rows(torch.from_numpy(rows), torch.from_numpy(want))
        res[f"daemon_{src}"] = dict(build_s=build_s, request_ms=request_ms,
                                    rows_equal=f"{n_eq}/{len(want)}")
        if n_eq != len(want):
            raise AssertionError(f"zoo export {name}: the daemon from its "
                                 f"{src} differs from make_pipeline: {res}")
    del direct
    for path in paths.values():
        for f in (path, Path(str(path) + ".weights.npz")):
            f.unlink(missing_ok=True)
    res["s"] = time.perf_counter() - t_family
    log(f"zoo export phase, {name}: {json.dumps(res)}")


def zoo_export_path(dev, work: Path, ckpts: dict, rng) -> None:
    """The zoo export phase (item 13 of the module docstring), the launch
    counts set to 0 before it and held at 0 after it."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    for name in ZOO:
        zoo_export_family(dev, name, work, ckpts, rng)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"zoo export phase: a kernel launched: "
                             f"{launched}")
    log(f"zoo export phase: {time.perf_counter() - t_phase:.1f} s")


def pala_train(name: str, work: Path, data: Path, argv) -> dict:
    """One epoch of ``cli/main.run`` on PALA or rat data (the config's
    defaults, PALA_ARGS and ``argv``) under a :class:`DriverProbe`:
    prints ms a step (the median after the first), waveforms a step and
    training waveforms/s end to end, the losses and the summary; holds
    every loss finite. Returns the readings with the probe and config."""
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        f"data_dir={data}", f"run_dir={work / 'runs'}",
        f"ckpt_dir={work / 'ckpts'}", *PALA_ARGS, *argv])
    fresh_peak()
    with DriverProbe() as probe:
        t0 = time.perf_counter()
        summary = cli_main.run(cfg)
        wall = time.perf_counter() - t0
    log_path = Path(cfg.run_dir) / f"{summary['run_name']}.jsonl"
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    losses = [e["train_loss"] for e in events if e["event"] == "train"]
    loop = probe.loops[-1]
    ms = float(np.median(probe.step_ms[1:] or probe.step_ms))
    rows = int(cfg.batch_size) * len(range(0, PALA_DATA["n_channels"],
                                           int(cfg.ch_gap)))
    out = dict(run_s=wall, steps=len(losses), waveforms_a_step=rows,
               length=PALA_DATA["n_samples"] * int(cfg.rf_scale_factor),
               losses=losses, ms_per_step=ms, step_ms=probe.step_ms,
               train_waveforms_per_s=len(loop["steps"]) * rows / loop["s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               summary={k: v for k, v in summary.items()
                        if k != "run_name"})
    log(f"pala phase, {name} training: {json.dumps(out)}")
    if not losses or len(losses) != probe.steps or not all(
            np.isfinite(losses)):
        raise AssertionError(f"pala {name} training: a loss is not finite "
                             f"or a step went unlogged: {losses}")
    return dict(out, probe=probe, cfg=cfg, summary=summary)


def pala_serve(dev, state, cfg) -> dict:
    """StofNet from the PALA run's weights served through
    ``make_pipeline`` in bf16 on the PALA channel frames at L_PALA (the
    evaluation's items, ``cfg``'s dataset with ``evaluate=True``: wave 1,
    4 channels of each of the 48 frames, in batches of up to B), the
    first call of each batch shape untimed, the counts set to 0 after
    it: the fused route, both serving kernels
    once a batch, >= AGREE_MIN of the coord slots with the plain twin on
    the card. Returns the launches by kernels-line row."""
    cfg = cfg.copy()
    cfg.evaluate = True
    ds, info = cli_main.build_dataset(cfg)
    frames = np.concatenate([
        cli_main.batch_to_arrays(batch, info["kind"])[0]
        for batch in DataLoader(ds, batch_size=PALA_FRAMES)])
    if frames.shape[-1] != L_PALA:
        raise AssertionError(f"pala serving: frames {frames.shape}")
    batches = [frames[i:i + B] for i in range(0, len(frames), B)]
    pipe = make_pipeline(state, stofnet_overrides(state), device=dev,
                         **{k: DECODE[k] for k in ("window_size",
                                                   "threshold",
                                                   "max_echoes")})
    for x in {len(x): x for x in batches}.values():
        pipe(x).cpu()  # each shape's first call (cuDNN's choice), untimed
    reset_launch_counts()
    got, ms = [], []
    for x in batches:
        t0 = time.perf_counter()
        got.append(pipe(x).cpu())
        ms.append((time.perf_counter() - t0) * 1e3)
    c = counts()
    got = torch.cat(got)
    params = {k: v.to(dev) for k, v in state.items()}
    with torch.inference_mode():
        plain = torch.cat([mask2coords(stofnet_apply_reference(
            params, torch.from_numpy(x).to(dev)), **DECODE).cpu()
            for x in batches])
    agree = coord_agreement(got, plain)
    rows, moved = row_agreement(got, plain)
    launches = {SGB_ROW[L_PALA]: c["sgb_dma.launches"],
                "conv_stack_fused": c["conv_stack.launches"]}
    out = dict(route=pipe.route(L_PALA), waveforms=len(frames),
               batches=len(batches), launches=launches,
               coord_agreement=agree, row_agreement=rows, rows_moved=moved,
               detections_per_row=float((got != 0).sum(1).float().mean()),
               ms_per_batch=ms, waveforms_per_s=len(frames) / sum(ms) * 1e3)
    log(f"pala phase, stofnet serving bf16: {json.dumps(out)}")
    if (out["route"] != "fused" or agree < AGREE_MIN
            or c["sgb_dma.launches"] != len(batches)
            or c["conv_stack.launches"] != len(batches)):
        raise AssertionError(f"pala serving: {out}")
    return launches


def das_band(sigs: torch.Tensor, table) -> torch.Tensor:
    """JAX's form of ``das_rx_batch`` (``stofnet_tpu/ops/beamform.py:
    112-174``) in PyTorch, for its time beside the gather form: per
    channel a (P, N) band matrix from an iota comparison, applied to all
    frames as an (F, N) @ (N, P) product, phase-rotated and accumulated.
    Complex frames only; the port never calls it."""
    dev = sigs.device
    sr, si = sigs.real.float(), sigs.imag.float()
    idxf = torch.from_numpy(table.idxf.astype(np.int64)).to(dev)
    frac = torch.from_numpy(table.frac).to(dev)
    mask = torch.from_numpy((~table.invalid) & table.aperture).to(dev).float()
    ph_r = torch.from_numpy(np.real(table.phase).astype(np.float32)).to(dev)
    ph_i = torch.from_numpy(np.imag(table.phase).astype(np.float32)).to(dev)
    iota = torch.arange(sigs.shape[1], device=dev)[None, :]
    acc_r = torch.zeros(sigs.shape[0], idxf.shape[0], device=dev)
    acc_i = torch.zeros_like(acc_r)
    with full_f32():
        for c in range(idxf.shape[1]):
            i0, f = idxf[:, c:c + 1], frac[:, c:c + 1]
            band = ((iota == i0).float() * (1.0 - f)
                    + (iota == i0 + 1).float() * f) * mask[:, c:c + 1]
            gr, gi = sr[:, :, c] @ band.T, si[:, :, c] @ band.T
            pr, pi = ph_r[None, :, c], ph_i[None, :, c]
            acc_r += gr * pr - gi * pi
            acc_i += gr * pi + gi * pr
    return torch.complex(acc_r, acc_i)


def pala_imaging(dev, data: Path) -> None:
    """The figure's compute stages on the card (sequence 0: 24 frames x 3
    angles x 128 channels x 1024 samples, a 128 x 192 grid):
    ``svd_filter_db`` over the slow-time ensemble against the CPU's
    (rtol = atol = SVD_TOL), ``svd_filter(lo_cut=2)``, the analytic signal
    and ``bf_das_batch`` (first PALA_CPU_FRAMES frames against the CPU's,
    rtol = atol = DB_TOL of the dB values, and DB_TOL dB absolute above
    DB_BRIGHT), each timed with CUDA events;
    the DAS of the 3 angles on precomputed delay tables in the gather form
    and in JAX's band-matmul form, the two held to each other and
    timed."""
    ds = PalaDatasetRf(data, sequences=[0], rescale_factor=1, ch_gap=1)
    params, gx, gz = figure.geometry(ds, PALA_DATA["n_samples"])
    frames = torch.from_numpy(figure.load_frames(ds)).to(dev)
    f, a, c, n = frames.shape
    ens = frames.permute(1, 2, 3, 0).reshape(a * c, n, f)
    # the threshold halfway between the 2nd and 3rd components' levels
    # (those of the CPU): the two strongest cut
    level = singular_levels_db(ens.cpu())
    db = float(level[1] + level[2]) / 2
    svd_filter_db(ens, db)  # cuSOLVER's and cuBLAS's first calls
    got, svd_db_ms = time_once(svd_filter_db, ens, db, device=dev)
    ref = svd_filter_db(ens.cpu(), db)
    svd_err = float((got.cpu() - ref).abs().max())
    svd_ok = bool(torch.allclose(got.cpu(), ref, rtol=SVD_TOL, atol=SVD_TOL))
    figure.clutter_filter(frames)
    filt, svd_ms = time_once(figure.clutter_filter, frames, device=dev)
    figure.image(filt[:1], params, gx, gz)  # cuFFT's plans
    bmode, image_ms = time_once(figure.image, filt, params, gx, gz,
                                 device=dev)
    cpu = figure.image(filt[:PALA_CPU_FRAMES].cpu(), params, gx, gz)
    err = (bmode[:PALA_CPU_FRAMES].cpu() - cpu).abs()
    db_err = float(err.max())
    # allclose's rtol and atol, as tests/test_ops_pala.py holds it
    db_ratio = float((err / (DB_TOL + DB_TOL * cpu.abs())).max())
    # where the error sits: its largest value in each band of the CPU's
    # level (top, bottom]; the pixels above DB_BRIGHT at DB_TOL absolute
    edges = (*DB_BANDS, -float("inf"))
    by_level = {f"{top:g}..{bottom:g}": float(err[(cpu <= top)
                                                  & (cpu > bottom)].max())
                for top, bottom in zip(edges, edges[1:])
                if bool(((cpu <= top) & (cpu > bottom)).any())}
    bright_err = float(err[cpu > DB_BRIGHT].max())
    # the DAS alone, on the analytic frames and the tables of the 3 angles
    iq = analytic_signal(filt, axis=2)
    xg, zg = np.meshgrid(gx, gz)
    tables = [make_delay_table(params, float(th), xg.ravel(), zg.ravel(), n)
              for th in params.angles_list]

    def das_all(form):
        return sum(form(iq[:, i], t) for i, t in enumerate(tables))

    das_all(das_rx_batch)
    gather, gather_ms = time_once(das_all, das_rx_batch, device=dev)
    band, band_ms = time_once(das_all, das_band, device=dev)
    band_err = float((band - gather).abs().max() / gather.abs().max())
    p = xg.size
    out = dict(frames=f, angles=a, channels=c, samples=n, pixels=p,
               clutter_db=db, svd_filter_db_ms=svd_db_ms,
               svd_filter_db_max_abs_err=svd_err,
               svd_filter_lo2_ms=svd_ms, bf_das_batch_ms=image_ms,
               bf_das_batch_ms_a_frame=image_ms / f,
               bmode_max_abs_err_db=db_err,
               bmode_err_over_tolerance=db_ratio,
               bmode_max_abs_err_db_by_level=by_level,
               bmode_bright_pixels=int((cpu > DB_BRIGHT).sum()),
               bmode_bright_max_abs_err_db=bright_err,
               bmode_min_db=float(cpu.min()),
               das_gather_ms=gather_ms, das_band_matmul_ms=band_ms,
               band_vs_gather_rel_err=band_err,
               gather_bytes_gb=2 * a * f * p * c * 8 / 1e9,
               band_bytes_written_gb=a * c * p * n * 4 / 1e9)
    log(f"pala phase, imaging: {json.dumps(out)}")
    if (not svd_ok or db_ratio > 1.0 or bright_err > DB_TOL
            or band_err > 1e-4):
        raise AssertionError(f"pala imaging: the card disagrees: {out}")


def pala_path(dev, work: Path) -> dict:
    """The PALA phase (item 14 of the module docstring). Returns its
    serving launches by kernels-line row; the driver's runs launch no
    kernel (counts set to 0 before and held at 0 after them)."""
    t_phase = time.perf_counter()
    data = work / "pala_synth"
    t0 = time.perf_counter()
    generate_pala_dataset(data, **PALA_DATA)
    log(f"pala phase: generated {data} in {time.perf_counter() - t0:.1f} s")
    if cli_main.dataset_kind(str(data)) != "pala":
        raise AssertionError(f"pala phase: {data} is not PALA data")
    reset_launch_counts()
    seqs = f"sequences={list(range(PALA_DATA['n_sequences']))}"
    run = pala_train("stofnet", work, data, ["model=stofnet", seqs])
    t0 = time.perf_counter()
    cpu = first_loss_on_cpu(run["cfg"], run["probe"].init_state)
    rel = abs(run["losses"][0] - cpu) / abs(cpu)
    log(f"pala phase: first loss {run['losses'][0]!r} on the card, {cpu!r} "
        f"on the CPU, relative {rel:.3e} ({time.perf_counter() - t0:.1f} s)")
    if not rel <= 1e-6:
        raise AssertionError(f"pala phase: the first loss is {rel:.3e} from "
                             f"the CPU's, beyond 1e-6")
    ckpt = Path(run["summary"]["checkpoint"])
    driver_eval("stofnet", work, str(data), ckpt.name,
                [*PALA_ARGS, seqs], phase="pala phase")
    # one sequence (24 frames, 23 on rat data): a validation split of 4
    one = ["sequences=[0]", "batch_size=4"]
    for name in ("zonzini", "unet"):
        pala_train(name, work, data, [f"model={name}", *one])
    rat = work / "rat_synth"
    shutil.copytree(data, rat)
    pala_train("stofnet rat", work, rat, ["model=stofnet", *one])
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"pala phase: the driver launched {launched}")
    state = load_model_variables("stofnet", ckpt)
    launches = pala_serve(dev, state, run["cfg"])
    pala_imaging(dev, data)
    log(f"pala phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


class ArrayProbe:
    """Readings of ``cli/array.py``'s train runs taken from outside the
    driver: it wraps the ``make_array_train_step`` that the driver's module
    calls and changes nothing it computes. It keeps the array state, the
    members' state dicts before the first step and after it, a clone of
    every batch a step took, and each step's losses and host ms up to the
    card's end."""

    def __init__(self):
        self.state = self.init = self.first = None
        self.batches, self.losses, self.step_ms = [], [], []

    def __enter__(self):
        self._saved = cli_array.make_array_train_step

        def members():
            return [{k: v.clone() for k, v in self.state.member(i).items()}
                    for i in range(len(self.state.seeds))]

        def make(state, *args, **kwargs):
            self.state = state
            self.init = members()
            step = self._saved(state, *args, **kwargs)

            def timed(*batch):
                self.batches.append(tuple(t.clone() for t in batch))
                t0 = time.perf_counter()
                out = step(*batch)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.losses.append(out["loss"].cpu())
                if self.first is None:
                    self.first = members()
                return out
            return timed

        cli_array.make_array_train_step = make
        return self

    def __exit__(self, *exc):
        cli_array.make_array_train_step = self._saved


def array_cfg(work: Path, data: str, *argv):
    return merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        "model=stofnet", f"batch_size={B}", f"data_dir={data}",
        f"run_dir={work / 'array_runs'}", f"ckpt_dir={work / 'array_ckpts'}",
        *argv])


def params_rel_l2(got: dict, ref: dict) -> float:
    """The largest relative L2 distance over the float tensors of two state
    dicts."""
    return max(rel_l2(got[k].float(), v.float()) for k, v in ref.items()
               if v.is_floating_point() and v.norm() > 0)


def array_train(dev, work: Path, data: str, name: str, *argv) -> dict:
    """One ``cli/array.run`` training of one epoch under an
    :class:`ArrayProbe`: prints its summary, ms a step and waveforms/s,
    peak memory and each member's first loss; returns the run, the probe
    and the config."""
    cfg = array_cfg(work, data, "epochs=1", *argv)
    fresh_peak()
    with ArrayProbe() as probe:
        t0 = time.perf_counter()
        out = cli_array.run(cfg.copy())
        wall = time.perf_counter() - t0
    losses = torch.stack(probe.losses)
    ms = float(np.median(probe.step_ms[1:]))
    res = dict(run_s=wall, steps=len(probe.batches),
               members=len(probe.state.seeds), ms_per_step=ms,
               step_ms=probe.step_ms,
               waveforms_per_s=len(probe.state.seeds) * B / ms * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_losses=losses[0].tolist(),
               summary={k: v for k, v in out.items() if k != "run_name"})
    log(f"array phase, {name}: {json.dumps(res)}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"array phase, {name}: a loss is not finite")
    return dict(out=out, probe=probe, cfg=cfg)


def array_against_solo(dev, run: dict) -> None:
    """Each member of the ``seeds=`` run against the solo f32
    ``make_train_step`` from its initial weights over the batches the run
    took, on the card: the first loss within 1e-5 relative and the
    parameters after the first update within 1e-4 relative L2 (the largest
    over the tensors); the distance after the epoch printed."""
    probe, cfg = run["probe"], run["cfg"]
    n_steps = len(probe.batches)
    out = []
    for i in range(len(probe.state.seeds)):
        model = StofNet(device=dev)
        model.load_state_dict(probe.init[i])
        opt, sched = make_optimizer(
            model.parameters(), lr=float(cfg.lr),
            weight_decay=float(cfg.weight_decay), epochs=int(cfg.epochs),
            steps_per_epoch=n_steps)
        step = make_train_step(model, opt, sched, cli_main._loss_config(cfg))
        first = float(step(*probe.batches[0])["loss"])
        first_l2 = params_rel_l2(probe.first[i], model.state_dict())
        for b in probe.batches[1:]:
            step(*b)
        got = float(probe.losses[0][i])
        out.append(dict(member=i, first_loss=got, solo_first_loss=first,
                        first_loss_rel=abs(got - first) / abs(first),
                        params_rel_l2_first_update=first_l2,
                        params_rel_l2_after_epoch=params_rel_l2(
                            probe.state.member(i), model.state_dict())))
    log(f"array phase, members against solo steps: {json.dumps(out)}")
    bad = [o for o in out if not (o["first_loss_rel"] <= ARRAY_LOSS_RTOL
                                  and o["params_rel_l2_first_update"]
                                  <= ARRAY_PARAM_RTOL)]
    if bad:
        raise AssertionError(f"array phase: members differ from their solo "
                             f"steps: {bad}")


def split_batches(cfg, n: int, dev):
    """The first ``n`` batches of B of the test split, on the card."""
    cfg = cfg.copy()
    cfg.evaluate = True
    ds, info = cli_main.build_dataset(cfg)
    out = []
    for batch in DataLoader(ds, batch_size=B, drop_last=True):
        frame, gt = cli_main.batch_to_arrays(batch, info["kind"])
        gt_true = np.round(gt[:, None, :] * UP).astype(np.int32)
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (frame, gt, gt_true)))
        if len(out) == n:
            return out
    return out


def array_eval(dev, work: Path, data: str, names: list) -> None:
    """``cli/array.run`` with ``model_files=`` the members' checkpoints
    (rows printed), then ``make_array_eval_step`` on the stacked
    checkpoints against the solo eval step of each on the test split's
    first 2 batches: >= 0.99 of the coord slots within 1 sample."""
    cfg = array_cfg(work, data, "evaluate=True",
                    "model_files=[" + ",".join(names) + "]")
    t0 = time.perf_counter()
    out = cli_array.run(cfg.copy())
    log(f"array phase, model_files rows ({time.perf_counter() - t0:.1f} s):"
        f" {json.dumps(out['rows'])}")
    states = [load_model_variables("stofnet", find_checkpoint(
        cfg.ckpt_dir, n)) for n in names]
    stacked = {k: v.to(dev) for k, v in
               stack_checkpoint_variables(states).items()}
    lcfg = cli_main._loss_config(cfg)
    aeval = make_array_eval_step(StofNet(device="meta"), lcfg)
    res = []
    for i, state in enumerate(states):
        model = StofNet(device=dev)
        model.load_state_dict(state)
        solo, got = [], []
        for b in split_batches(cfg, 2, dev):
            solo.append(make_eval_step(model, lcfg)(*b)["es_sample"])
            got.append(aeval(stacked, *b)["es_sample"][i])
        solo, got = torch.cat(solo), torch.cat(got)
        rows, moved = row_agreement(got, solo)
        res.append(dict(member=names[i], agreement=coord_agreement(got, solo),
                        row_agreement=rows, rows_moved=moved))
    log(f"array phase, model_files against solo eval steps: "
        f"{json.dumps(res)}")
    if min(r["agreement"] for r in res) < AGREE_MIN:
        raise AssertionError(f"array phase: the array eval moves the coords "
                             f"of a member: {res}")


def array_th_sweep(dev, work: Path, data: str, name: str) -> None:
    """``cli/array.run`` with ``th_sweep=`` 8 thresholds from one member's
    checkpoint (rows printed), then ``make_threshold_sweep_step`` on the
    test split's first batch: each threshold's coords equal bit for bit to
    ``mask2coords`` at that threshold of the same forward (cuDNN set
    deterministic, so the two forwards give the same bits)."""
    ths = ARRAY_THRESHOLDS
    cfg = array_cfg(work, data, "evaluate=True", f"model_file={name}",
                    "th_sweep=[" + ",".join(map(str, ths)) + "]")
    t0 = time.perf_counter()
    out = cli_array.run(cfg.copy())
    log(f"array phase, th_sweep rows ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(out['rows'])}")
    lcfg = cli_main._loss_config(cfg)
    model = StofNet(device=dev)
    model.load_state_dict(load_model_variables(
        "stofnet", find_checkpoint(cfg.ckpt_dir, name)))
    (frame, gs, gt), = split_batches(cfg, 1, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = make_threshold_sweep_step(model, lcfg)(
            model.state_dict(), frame, gs, gt,
            torch.tensor(ths, dtype=torch.float32, device=dev))["es_sample"]
        pred = make_eval_step(model, lcfg).forward(frame)[0]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    equal = [bool(torch.equal(got[t], mask2coords(
        pred, window_size=lcfg.nms_win_size, threshold=th,
        upsample_factor=lcfg.upsample_factor, max_echoes=lcfg.max_echoes)))
        for t, th in enumerate(ths)]
    log(f"array phase, th_sweep against mask2coords: thresholds {ths}, "
        f"equal {equal}")
    if not all(equal):
        raise AssertionError(f"array phase: the sweep's coords differ at "
                             f"thresholds {[t for t, e in zip(ths, equal) if not e]}")


def array_profile(dev, members: int, batch: int) -> None:
    """Device time by kernel of one ``members`` x ``batch`` array step and
    of the members' solo steps, each on one warmed-up batch under the
    profiler: where the vmapped step's time goes."""
    batches = bench_array.staged(np.random.default_rng(SEED), 2, batch, L,
                                 dev)

    def build(g):
        return StofNet(generator=g, device=dev)

    state = init_array_state(build, range(members))
    opt, sched = make_optimizer(state.params.values(), steps_per_epoch=100)
    astep = make_array_train_step(state, opt, sched, bench_array.CFG)
    solos = []
    for seed in range(members):
        model = build(torch.Generator().manual_seed(seed))
        opt, sched = make_optimizer(model.parameters(), steps_per_epoch=100)
        solos.append(make_train_step(model, opt, sched, bench_array.CFG))

    def solo(b):
        return [float(step(*b)["loss"]) for step in solos]

    solo(batches[0])
    astep(*batches[0])
    out = dict(array=profile_runs(lambda b: astep(*b)["loss"].cpu(),
                                  batches[1:]),
               solo_steps=profile_runs(solo, batches[1:]))
    log(f"array phase, profile of {members} members x B={batch}: "
        f"{json.dumps(out)}")


def array_path(dev, work: Path, data: str) -> torch.Tensor:
    """The array phase (item 15 of the module docstring), the launch
    counts set to 0 before it and held at 0 after it: JAX's array step is
    ``jax.vmap`` of its train and eval steps, which reach no Pallas
    kernel. Returns the ``seeds=2`` run's first losses."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    seeds = array_train(dev, work, data, "seeds=2", "seeds=2")
    array_against_solo(dev, seeds)
    lrs = array_train(dev, work, data, "lrs", f"lrs={ARRAY_LRS}")
    first = lrs["probe"].losses[0]
    spread = float((first.max() - first.min()) / first.abs().max())
    log(f"array phase, lrs first losses {first.tolist()}: bitwise equal "
        f"{bool((first == first[0]).all())}, relative spread {spread:.3e}")
    if not spread <= 1e-6:
        raise AssertionError(f"array phase: the lr sweep's members do not "
                             f"start from one init: {first.tolist()}")
    out = seeds["out"]
    names = [f"{out['run_name']}_seed{m['seed']}" for m in out["members"]]
    seeds_first = seeds["probe"].losses[0]
    seeds = lrs = None  # the runs' states leave the card
    array_eval(dev, work, data, names)
    array_th_sweep(dev, work, data, names[0])
    fresh_peak()
    t0 = time.perf_counter()
    bench = bench_array.measure(dev)
    log(f"array phase, bench_array ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(bench)}")
    for members, batch in ((4, 32), (2, B)):
        array_profile(dev, members, batch)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"array phase: a kernel launched: {launched}")
    log(f"array phase: {time.perf_counter() - t_phase:.1f} s")
    return seeds_first


def table_cells(table: str) -> list:
    """The cells of a sweep table's markdown rows."""
    return [line.split("|")[1:-1] for line in table.splitlines()
            if line.startswith("| ") and "Method" not in line]


def sweep_path(work: Path, data: str, stofnet_ckpt: str,
               ckpts: dict) -> None:
    """The sweep phase (item 16 of the module docstring), the launch counts
    set to 0 before it and held at 0 after it."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    run_dir = work / "sweep_runs"
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        f"data_dir={data}", f"run_dir={run_dir}",
        f"ckpt_dir={work / 'ckpts'}"])
    cfg.update(cli_sweep.SWEEP_OVERRIDES["chirp"])
    rows = ([["stofnet", stofnet_ckpt, None],
             ["stofnet", stofnet_ckpt, None, {"int8": True}]]
            + [[n, c, None] for n, c in ckpts.items() if n != "kuleshov"]
            + [["gradpeak", None, None], ["edsr", SWEEP_MISSING, None]])
    results, seconds = [], []
    for row in rows:
        t0 = time.perf_counter()
        results += cli_sweep.run_sweep(cfg, [row])
        seconds.append(time.perf_counter() - t0)
    md = cli_sweep.write_tables(results, run_dir)
    log("sweep phase, the table:\n" + md)
    log(f"sweep phase, seconds a row: {json.dumps(dict(zip((' '.join(map(str, r[:2])) + (' int8' if len(r) > 3 else '') for r in rows), seconds)))}")
    errors = [r for r in results if "error" in r]
    if errors:
        raise AssertionError(f"sweep phase: rows failed: {errors}")
    if f"edsr ({SWEEP_MISSING}) †" not in md:
        raise AssertionError("sweep phase: the random-init row carries no "
                             "dagger")
    t0 = time.perf_counter()
    cli_report.main([f"run_dir={run_dir}", f"num_recent={len(rows)}"])
    rebuilt = (run_dir / "metrics_table.md").read_text()
    log(f"sweep phase, cli/report.py ({time.perf_counter() - t0:.1f} s):\n"
        + rebuilt)
    sweep_rows, report_rows = table_cells(md), table_cells(rebuilt)[::-1]
    same = len(sweep_rows) == len(report_rows) and all(
        a[1:] == b[1:] and a[0].split()[0] == b[0].split()[0]
        and ("†" in a[0]) == ("†" in b[0]) and ("int8" in a[0])
        == ("int8" in b[0]) for a, b in zip(sweep_rows, report_rows))
    if not same:
        raise AssertionError("sweep phase: cli/report.py does not rebuild "
                             "the sweep's table from the summaries")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"sweep phase: a kernel launched: {launched}")
    log(f"sweep phase: {time.perf_counter() - t_phase:.1f} s")


def mesh_driver(work: Path, data: str) -> None:
    """``cli/main.run mesh=True mesh_dp=1`` (NCCL, world size 1) against
    the same run without a mesh: one f32 epoch, then ``evaluate=True``
    from the run's checkpoint both ways; the launch counts held at 0."""
    reset_launch_counts()
    common = ["model=stofnet", f"batch_size={B}", f"data_dir={data}",
              f"run_dir={work / 'mesh_runs'}", f"ckpt_dir={work / 'ckpts'}"]
    mesh = ["mesh=True", "mesh_dp=1"]
    runs = {}
    for name, argv in (("without", []), ("mesh", mesh)):
        cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG),
                        [*common, "epochs=1", *argv])
        t0 = time.perf_counter()
        summary = cli_main.run(cfg)
        log_path = Path(cfg.run_dir) / f"{summary['run_name']}.jsonl"
        losses = [json.loads(line)["train_loss"]
                  for line in log_path.read_text().splitlines()
                  if '"event": "train"' in line]
        runs[name] = dict(summary=summary, losses=losses,
                          s=time.perf_counter() - t0,
                          params=load_model_variables(
                              "stofnet", summary["checkpoint"]))
    a, b = runs["mesh"], runs["without"]
    flat = {k: torch.cat([v.float().reshape(-1)
                          for v in r["params"].values()])
            for k, r in runs.items()}
    out = dict(first_loss=[a["losses"][0], b["losses"][0]],
               first_loss_equal=a["losses"][0] == b["losses"][0],
               params_rel_l2=rel_l2(flat["mesh"], flat["without"]),
               val_loss=[a["summary"]["val_loss"], b["summary"]["val_loss"]],
               run_s=[a["s"], b["s"]])
    ckpt = Path(b["summary"]["checkpoint"]).name
    evals = {}
    for name, argv in (("without", []), ("mesh", mesh)):
        cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
            *common, f"model_file={ckpt}", "evaluate=True", "th=Null",
            *argv])
        evals[name] = cli_main.run(cfg)
    keys = ("val_loss", "total_distance_mean", "total_jaccard")
    out["evaluation"] = {k: [evals["mesh"][k], evals["without"][k]]
                         for k in keys}
    out["evaluation_equal"] = all(
        np.array_equal(evals["mesh"][k], evals["without"][k],
                       equal_nan=True) for k in keys)
    log(f"mesh phase, the driver at dp=1: {json.dumps(out)}")
    val = out["val_loss"]
    if not (out["first_loss_equal"] and out["evaluation_equal"]
            and out["params_rel_l2"] <= MESH_PARAM_RTOL
            and abs(val[0] - val[1]) <= 1e-3 * abs(val[1])):
        raise AssertionError(f"mesh phase: the driver at dp=1 is not the "
                             f"run without a mesh: {out}")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"mesh phase: the driver launched {launched}")


def sp_cases() -> list:
    """The sp phase's steps: StofNet f32 and amp at dp=1, sp=2, each rank
    4000 samples of every row of one B=128 batch at L=8000."""
    shape = dict(mesh=(1, 2), timed=MESH_TIMED)
    return [dp_check.stofnet_case(L, B, name="stofnet", **shape),
            dp_check.stofnet_case(L, B, amp=True, name="stofnet amp",
                                  **shape)]


def mesh_two_ranks() -> list:
    """2 ranks on cuda:0 (gloo) each take 64 rows of one B=128 batch at
    L=8000 through ``scripts/dp_check``, against the single process's
    step on the whole batch. The same ranks then run :func:`sp_cases`,
    one launch for both phases; returns those cases' (case, rank 0's
    result, the single process's result) for :func:`sp_two_ranks`."""
    zoo = zoo_sp_cases()
    cases = [dp_check.stofnet_case(L, B, timed=MESH_TIMED),
             dp_check.sincnet_case(L, B, timed=MESH_TIMED), *sp_cases(),
             *zoo]
    t0 = time.perf_counter()
    ranks = dp_mesh.launch(dp_check.run_cases, (cases, "cuda:0", True),
                           devices=["cuda:0", "cuda:0"], backend="gloo")
    launch_s = time.perf_counter() - t0
    alone = dp_check.run_cases(cases, "cuda:0")
    gloo = ranks.pop()["gloo_cuda"]
    n = len(cases) - len(zoo)
    sp_runs = list(zip(cases[2:n], ranks[2:n], alone[2:n]))
    zoo_runs = list(zip(cases[n:], ranks[n:], alone[n:]))
    lr = OPT["lr"]
    out, bad = {"launch_s": launch_s, "gloo_takes_cuda": gloo,
                "gloo_route": "host copies, by rule (parallel/mesh.py)"}, []
    for case, dp, one in zip(cases[:2], ranks, alone):
        diff = np.abs(np.concatenate([np.ravel(dp["params"][k] - v)
                                      for k, v in one["params"].items()]))
        res = dict(loss=[dp["loss"][0], one["loss"][0]],
                   share_within=float(np.mean(diff < MESH_AGREE)),
                   max_param_diff=float(diff.max()),
                   ranks_equal=dp["ranks_equal"],
                   ms_2_ranks=dp["ms"], ms_single=one["ms"])
        stats = [k for k in one["buffers"]
                 if k.endswith(("running_mean", "running_var"))]
        if stats:
            res["stats_max_diff"] = max(
                float(np.abs(dp["buffers"][k] - one["buffers"][k]).max())
                for k in stats)
            if not all(np.allclose(dp["buffers"][k], one["buffers"][k],
                                   rtol=1e-5, atol=1e-6) for k in stats):
                bad.append(f"{case['model']} statistics")
        if not (abs(res["loss"][0] - res["loss"][1])
                <= MESH_LOSS_RTOL * abs(res["loss"][1])
                and res["share_within"] > MESH_SHARE
                and res["max_param_diff"] < 2 * lr and res["ranks_equal"]):
            bad.append(case["model"])
        out[case["model"]] = res
    log(f"mesh phase, 2 ranks on one card: {json.dumps(out)}")
    if bad:
        raise AssertionError(f"mesh phase: the 2-rank step misses the "
                             f"single step: {bad}")
    return sp_runs, zoo_runs


def mesh_daemon(dev, work: Path, stofnet_ckpt: str) -> dict:
    """The daemon with ``mesh=True mesh_dp=1`` in bf16 at L, from the data
    phase's checkpoint and from an artifact exported from it, under
    :func:`daemon_traffic`. Returns the launches by kernels-line row."""
    rng = np.random.default_rng(SEED + 7)
    state = load_model_variables("stofnet", find_checkpoint(
        work / "ckpts", stofnet_ckpt))
    state = {k: v.to(dev) for k, v in state.items()}
    rows = list(gate_batch(DAEMON_CLIENTS * DAEMON_REQUESTS, L, rng)[:, 0])
    batch = gate_batch(B, L, rng)[:, 0]
    mesh = {"mesh": True, "mesh_dp": 1, "max_batch": B, "max_wait_ms": 2,
            "port": 0}
    launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        art = save_pipeline(Path(tmp) / "mesh.pt2", export_pipeline(
            state, {"upsample_factor": UP}, "b", L, device=dev,
            max_echoes=DAEMON_ECHOES))
        for name, args in (
                ("checkpoint", {"model_file": stofnet_ckpt,
                                "ckpt_dir": str(work / "ckpts"),
                                "length": L, "dtype": "bfloat16"}),
                ("artifact", {"artifact": str(art)})):
            _, served = daemon_traffic(f"mesh phase, daemon dp=1 from "
                                       f"{name}", {**args, **mesh}, state,
                                       dev, rows, batch,
                                       dtype=torch.bfloat16)
            if not all(served.values()):
                raise AssertionError(f"mesh phase, daemon from {name}: a "
                                     f"kernel did not launch: {served}")
            for k, v in served.items():
                launches[k] = launches.get(k, 0) + v
    return launches


def mesh_array(work: Path, data: str, array_first: torch.Tensor) -> None:
    """``cli/array.run mesh=True mesh_dp=1 seeds=2``, one epoch: each
    member's first loss equal bit for bit to the array phase's."""
    reset_launch_counts()
    cfg = array_cfg(work, data, "epochs=1", "seeds=2", "mesh=True",
                    "mesh_dp=1")
    with ArrayProbe() as probe:
        t0 = time.perf_counter()
        cli_array.run(cfg.copy())
        wall = time.perf_counter() - t0
    first = probe.losses[0]
    out = dict(run_s=wall, first_losses=[first.tolist(),
                                         array_first.tolist()],
               equal=bool(torch.equal(first, array_first)))
    log(f"mesh phase, the array at dp=1: {json.dumps(out)}")
    launched = {k: v for k, v in counts().items() if v}
    if not out["equal"] or launched:
        raise AssertionError(f"mesh phase: the array's first losses differ "
                             f"or a kernel launched: {out}, {launched}")


def mesh_path(dev, work: Path, data: str, stofnet_ckpt: str,
              array_first: torch.Tensor):
    """The mesh phase (item 17 of the module docstring). Returns the mesh
    daemon's launches by kernels-line row, and the sp and zoo-sp phases'
    steps that its ranks ran (:func:`mesh_two_ranks`)."""
    t_phase = time.perf_counter()
    mesh_driver(work, data)
    sp_runs, zoo_runs = mesh_two_ranks()
    launches = mesh_daemon(dev, work, stofnet_ckpt)
    mesh_array(work, data, array_first)
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, sp_runs, zoo_runs


def sp_replica(state):
    """``replica(device)`` of ``cli/serve._mesh_adjust``: the main path's
    bf16 pipeline on that device (the fused route at L % 80 == 0)."""
    def replica(where):
        return make_pipeline(state, {"upsample_factor": UP}, device=where,
                             window_size=DECODE["window_size"],
                             threshold=DECODE["threshold"],
                             max_echoes=DECODE["max_echoes"])
    return replica


def sp_pipeline(dev, state, sp: int):
    """The daemon's sp pipeline over a mesh listing ``dev`` sp times (one
    card): a numpy batch in, the coords as a CPU tensor out; and its
    replicas' first pipeline (its ``calls``)."""
    mesh = dp_mesh.make_mesh(1, sp, [dev] * sp)
    pipe, _ = serve_cli._mesh_adjust(sp_replica(state), dev, mesh, None, B)
    return (lambda x: torch.from_numpy(pipe(x))), pipe


def sp_serving(dev, state, rng) -> dict:
    """The sharded fused route at each (L, sp) of SP_SERVE against the
    single pipeline on the same batches, then the module route at
    L_MODULE over sp=2. Returns the launches by kernels-line row."""
    single = make_pipeline(state, {"upsample_factor": UP}, device=dev,
                           window_size=DECODE["window_size"],
                           threshold=DECODE["threshold"],
                           max_echoes=DECODE["max_echoes"])

    def run_single(x):
        return single(x).cpu()

    launches = {"conv_stack_fused": 0}
    arch = single.arch
    for length, sp in SP_SERVE:
        name = f"sp phase, L={length} sp={sp}"
        run, _ = sp_pipeline(dev, state, sp)
        warm = gate_batch(B, length, rng)
        run(warm)  # cuDNN's algorithm choice, not timed
        run_single(warm)
        batches = [gate_batch(B, length, rng) for _ in range(N_BATCHES)]
        want, single_ms = serve_timed(f"{name} single", run_single, batches,
                                      SERVE[L])
        reset_launch_counts()
        got, batch_ms = serve_timed(name, run, batches,
                                    {"sgb_dma.launches": sp,
                                     "conv_stack.launches": sp})
        c = counts()
        launches[SGB_ROW[length]] = (launches.get(SGB_ROW[length], 0)
                                     + c["sgb_dma.launches"])
        launches["conv_stack_fused"] += c["conv_stack.launches"]
        equal = bool(torch.equal(got, want))
        rows, moved = row_agreement(got, want)
        out = dict(rows_equal=equal, coord_agreement=coord_agreement(
            got, want), row_agreement=rows, rows_moved=moved,
            launches_per_batch={k: v / N_BATCHES for k, v in c.items() if v},
            ms_per_batch=float(np.median(batch_ms)), batch_ms=batch_ms,
            single_ms_per_batch=float(np.median(single_ms)),
            single_batch_ms=single_ms,
            redundant_share=seq.redundant_share(length, sp, arch),
            windows=[w for w, _ in seq.windows(length, sp, arch)])
        if not equal:  # the main path's rule, on the plain path's witness
            params = {k: v.to(dev) for k, v in state.items()}
            with torch.inference_mode():
                plain = torch.cat([mask2coords(stofnet_apply_reference(
                    params, torch.from_numpy(x).to(dev)), **DECODE).cpu()
                    for x in batches])
            out["witness"] = witness(dev, state, batches, want, plain)
        log(f"{name}: {json.dumps(out)}")
        if not equal:
            base = out["witness"]["plain~plain_cpu"]["moved"]
            if (out["coord_agreement"] < AGREE_MIN
                    or moved > 2 * base + ROW_NOISE):
                raise AssertionError(f"{name}: the sharded coords miss the "
                                     f"single pipeline's: {out}")
    run, first = sp_pipeline(dev, state, 2)
    x = gate_batch(B, L_MODULE, rng)
    reset_launch_counts()
    got, batch_ms = serve_timed(f"sp phase, L={L_MODULE} sp=2", run, [x], {})
    ref = torch.from_numpy(module_coords(
        state, {"upsample_factor": UP}, x, torch.bfloat16, dev,
        window_size=DECODE["window_size"], threshold=DECODE["threshold"],
        max_echoes=DECODE["max_echoes"]))
    out = dict(route_calls=first.calls, coord_agreement_module_bf16=(
        coord_agreement(got, ref)), ms=batch_ms[0])
    log(f"sp phase, L={L_MODULE} sp=2: {json.dumps(out)}")
    if first.calls != {"fused": 0, "module": 1} or (
            out["coord_agreement_module_bf16"] < AGREE_MIN):
        raise AssertionError(f"sp phase, L={L_MODULE}: {out}, not one module "
                             f"call a shard at >= {AGREE_MIN} of the slots")
    return launches


def sp_two_ranks(sp_runs: list) -> None:
    """The f32 and amp StofNet steps of 2 gloo ranks on cuda:0 at dp=1,
    sp=2 (:func:`sp_cases`, run by the mesh phase's ranks) against the
    single process's."""
    rules = [(MESH_LOSS_RTOL, MESH_AGREE, MESH_SHARE),
             (SP_AMP_RTOL, SP_AMP_AGREE, SP_AMP_SHARE)]
    out, bad = {}, []
    for (case, got, one), (rtol, agree, share) in zip(sp_runs, rules):
        diff = np.abs(np.concatenate([np.ravel(got["params"][k] - v)
                                      for k, v in one["params"].items()]))
        res = dict(loss=[got["loss"][0], one["loss"][0]],
                   share_within=float(np.mean(diff < agree)),
                   max_param_diff=float(diff.max()),
                   ranks_equal=got["ranks_equal"],
                   ms_2_ranks=got["ms"], ms_single=one["ms"])
        if not (abs(res["loss"][0] - res["loss"][1])
                <= rtol * abs(res["loss"][1]) and res["share_within"] > share
                and res["max_param_diff"] < 2 * OPT["lr"]
                and res["ranks_equal"]):
            bad.append(case["name"])
        out[case["name"]] = res
    log(f"sp phase, 2 ranks at sp=2 on one card: {json.dumps(out)}")
    if len(out) != len(rules) or bad:
        raise AssertionError(f"sp phase: the sp=2 step misses the single "
                             f"step: {bad or out}")


def sp_daemon(dev, work: Path, stofnet_ckpt: str) -> dict:
    """The daemon with ``mesh=True mesh_sp=2`` in bf16 at L from the data
    phase's checkpoint, its two replicas on ``dev``, under
    :func:`daemon_traffic`. Returns the launches by kernels-line row."""
    rng = np.random.default_rng(SEED + 8)
    state = load_model_variables("stofnet", find_checkpoint(
        work / "ckpts", stofnet_ckpt))
    state = {k: v.to(dev) for k, v in state.items()}
    rows = list(gate_batch(DAEMON_CLIENTS * DAEMON_REQUESTS, L, rng)[:, 0])
    batch = gate_batch(B, L, rng)[:, 0]
    args = {"model_file": stofnet_ckpt, "ckpt_dir": str(work / "ckpts"),
            "length": L, "dtype": "bfloat16", "mesh": True, "mesh_sp": 2,
            "max_batch": B, "max_wait_ms": 2, "port": 0}

    def one_card(device, dp, sp):  # the mesh's devices: cuda:0, sp times
        return [torch.device(dev)] * ((dp or 1) * sp)

    orig = serve_cli.local_devices
    serve_cli.local_devices = one_card
    try:
        _, launches = daemon_traffic("sp phase, daemon sp=2 from checkpoint",
                                     args, state, dev, rows, batch,
                                     dtype=torch.bfloat16, shards=2)
    finally:
        serve_cli.local_devices = orig
    if not all(launches.values()):
        raise AssertionError(f"sp phase, daemon: a kernel did not launch: "
                             f"{launches}")
    return launches


def sp_path(dev, work: Path, stofnet_ckpt: str, sp_runs: list) -> dict:
    """The sp phase (item 18 of the module docstring); ``sp_runs`` are its
    steps, which the mesh phase's ranks ran. Returns its launches by
    kernels-line row."""
    t_phase = time.perf_counter()
    state = StofNet(generator=torch.Generator().manual_seed(SEED),
                    device=dev).state_dict()
    launches = sp_serving(dev, state, np.random.default_rng(SEED + 9))
    sp_two_ranks(sp_runs)
    for k, v in sp_daemon(dev, work, stofnet_ckpt).items():
        launches[k] = launches.get(k, 0) + v
    log(f"sp phase launches: {json.dumps(launches)}")
    log(f"sp phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def zoo_sp_cases() -> list:
    """The zoo-sp phase's driver steps: every trainable family's f32 step
    at dp=1, sp=2 on one B=128 batch at its driver length (Kuleshov at
    ZOO_SP_STEP_L), run by the mesh phase's ranks."""
    out = []
    for name in ZOO:
        if name == "gradpeak":
            continue
        length = ZOO_SP_STEP_L.get(name, zoo_length(name))
        case = dp_check.zoo_case(name, length, B, seed=SEED, mesh=(1, 2),
                                 timed=1, name=f"{name} sp=2")
        if name not in ("kuleshov",):
            case["arch"] = dict(ZOO_OVERRIDES)
        out.append(case)
    return out


def zoo_sp_model(name: str, state: dict, dtype, dev, **over):
    """The family's module at the zoo phase's configuration on ``dev`` in
    eval mode, holding ``state``."""
    model, _ = build_model(name, **{**ZOO_OVERRIDES, **over}, dtype=dtype,
                           device="meta", th=None)
    if state:
        model.load_state_dict({k: v.to(dev) for k, v in state.items()},
                              strict=True, assign=True)
    else:
        model.to(dev)
    if name == "gradpeak":
        model.device = torch.device(dev)
    return model.eval()


def zoo_sp_gate(name: str, got: torch.Tensor, want: torch.Tensor,
                up: int) -> dict:
    """The sharded output against the single forward's: bit for bit, or
    JAX's tolerances (a heatmap's decoded coords within 1 sample on >=
    0.99 of the slots; Zonzini's ToA within ZONZINI_RTOL)."""
    res = dict(equal=bool(torch.equal(got, want)),
               max_abs_diff=float((got.float() - want.float()).abs().max()))
    if name == "zonzini":
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-12))
                    .max())
        res.update(max_rel_diff=rel,
                   ok=res["equal"] or rel <= ZONZINI_RTOL)
        return res
    if name == "gradpeak":
        res["ok"] = res["equal"]
        return res
    kw = dict(window_size=DECODE["window_size"], threshold=None,
              upsample_factor=up, max_echoes=DECODE["max_echoes"])
    a, b = mask2coords(got, **kw).cpu(), mask2coords(want, **kw).cpu()
    res["coords_equal"] = bool(torch.equal(a, b))
    res["coord_agreement"] = float(((a - b).abs() <= 1.0).float().mean())
    res["ok"] = res["coords_equal"] or res["coord_agreement"] >= AGREE_MIN
    return res


def zoo_sp_family(dev, name: str, state: dict, rows_of, phase: str,
                  **over) -> dict:
    """One family in f32 and bf16: the single forward and the sharded one
    (``parallel/seq.local_forward``: a thread a shard, every shard on
    ``dev``) at each sp of ZOO_SP over a warm-up and ZOO_SP_BATCHES timed
    batches (``rows_of(i)``: batch i, numpy), ms a batch (CUDA-synced
    host clock) and the gate of :func:`zoo_sp_gate`."""
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fresh_peak()
        model = zoo_sp_model(name, state, dtype, dev, **over)
        arch = seq.model_arch(model)
        up = int(arch["upsample_factor"])
        precision = (full_f32 if dtype == torch.float32 or name == "gradpeak"
                     else contextlib.nullcontext)
        xs = [torch.from_numpy(rows_of(i)).to(dev)
              for i in range(ZOO_SP_BATCHES + 1)]
        length = xs[0].shape[-1]

        def timed(fn):
            outs, ms = [], []
            for i, x in enumerate(xs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode(), precision():
                    y = fn(x)
                torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
                    outs.append(y)
            return outs, ms

        want, single_ms = timed(model)
        res = dict(length=length, single_ms_per_batch=float(
            np.median(single_ms)), single_batch_ms=single_ms)
        for sp in ZOO_SP:
            def sharded(x, sp=sp):
                parts = seq.local_forward(model, x, sp, arch)
                return (torch.cat(parts, -1) if arch["family"] in seq.HEATMAP
                        else parts[0])
            got, ms = timed(sharded)
            gates = [zoo_sp_gate(name, g, w, up) for g, w in zip(got, want)]
            res[f"sp{sp}"] = dict(
                ms_per_batch=float(np.median(ms)), batch_ms=ms,
                redundant_share=seq.redundant_share(length, sp, arch),
                gate=gates, equal=all(g["equal"] for g in gates))
            if not all(g["ok"] for g in gates):
                raise AssertionError(f"{phase}, {name} {label} sp={sp}: "
                                     f"the sharded forward misses the "
                                     f"single one: {gates}")
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"{phase}, {name} {label}: {json.dumps(res)}")
        out[label] = res
        del model, want
    return out


def zoo_sp_forwards(dev, work: Path, ckpts: dict, rng) -> None:
    """Every family (the zoo phase's trained checkpoints; gradpeak has no
    weights) and, on PALA data, the unet (10 layers: its reach spans the
    row, so each shard's window is the row) and ESPCN at L_PALA."""
    for name in ZOO:
        state = ({} if name == "gradpeak" else load_model_variables(
            name, find_checkpoint(work / "ckpts", ckpts[name])))
        length = zoo_length(name)
        batches = [gate_batch(B, length, rng)
                   for _ in range(ZOO_SP_BATCHES + 1)]
        zoo_sp_family(dev, name, state, batches.__getitem__,
                      "zoo-sp phase")
        del state
    cfg = merge_cli(load_config(cli_main.DEFAULT_CONFIG), [
        f"data_dir={work / 'pala_synth'}", "evaluate=True", "ch_gap=32",
        "rf_scale_factor=10", "sequences=[0]"])
    ds, _ = cli_main.build_dataset(cfg)
    loader = iter(DataLoader(ds, batch_size=PALA_FRAMES, drop_last=True))
    frames = [cli_main.batch_to_arrays(next(loader), "pala")[0]
              for _ in range(ZOO_SP_BATCHES + 1)]
    for name in ZOO_SP_PALA:
        over = dict(dataset_kind="pala", rf_scale_factor=10,
                    sample_num=PALA_DATA["n_samples"])
        model, _ = build_model(name, **{**ZOO_OVERRIDES, **over},
                               device="cpu", generator=torch.Generator()
                               .manual_seed(SEED))
        zoo_sp_family(dev, name, model.state_dict(), frames.__getitem__,
                      "zoo-sp phase, pala", **over)


def f64_grads(case: dict, dev) -> dict:
    """The gradients of the single step of ``case`` in f64 on ``dev`` (the
    model, the batch and the loss in f64; the dropout masks the f32
    step's): the witness of a family whose f32 gradients are far from
    exact on the card."""
    model = build_model(case["model"], device=dev, generator=torch.Generator()
                        .manual_seed(int(case["seed"])),
                        **case["arch"])[0].double()
    opt, sch = make_optimizer(model.parameters(), steps_per_epoch=1)
    step = make_train_step(model, opt, sch, LossConfig(**case["loss"]),
                           seed=int(case["seed"]))
    gt = case["gt_sample"]
    gt_true = np.round(gt[:, None, :] * case["loss"]["upsample_factor"])
    step(torch.from_numpy(case["frame"]).double().to(dev),
         torch.from_numpy(gt).double().to(dev),
         torch.from_numpy(gt_true.astype(np.int32)).to(dev))
    return {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}


def f64_witness(got: dict, one: dict, ref: dict) -> dict:
    """Per tensor whose f64 gradient is not rounding noise: the relative
    L2 distance of the ranks' and of the single step's f32 gradients from
    the f64 witness."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    top = max(norms.values())
    out = {}
    for k, r in ref.items():
        if norms[k] <= ZOO_SP_NOISE * top:
            continue
        out[k] = [float(np.linalg.norm(got[k] - r) / norms[k]),
                  float(np.linalg.norm(one[k] - r) / norms[k])]
    return out


def zoo_sp_two_ranks(runs: list, dev) -> None:
    """Each family's f32 step of the mesh phase's 2 gloo ranks on cuda:0
    at dp=1, sp=2 (:func:`zoo_sp_cases`) against the single process's:
    the loss rtol 1e-5, every parameter within 2 lr, and 99.9 % within
    1e-5, or for a BatchNorm family (whose conv biases before a BatchNorm
    take gradients of rounding noise, which AdamW's first step turns into
    updates of up to lr) the gradients rtol 1e-3, atol 1e-4 of the
    largest (Kuleshov: against its f64 witness, :data:`ZOO_SP_F64`) and
    the running statistics rtol 1e-5, atol 1e-6."""
    out, bad = {}, []
    for case, got, one in runs:
        name = case["model"]
        diff = np.abs(np.concatenate([np.ravel(got["params"][k] - v)
                                      for k, v in one["params"].items()]))
        res = dict(length=case["frame"].shape[-1],
                   loss=[got["loss"][0], one["loss"][0]],
                   share_within=float(np.mean(diff < MESH_AGREE)),
                   max_param_diff=float(diff.max()),
                   ranks_equal=got["ranks_equal"],
                   ms_2_ranks=got["ms"], ms_single=one["ms"])
        ok = (abs(res["loss"][0] - res["loss"][1])
              <= MESH_LOSS_RTOL * abs(res["loss"][1])
              and res["max_param_diff"] < 2 * OPT["lr"]
              and res["ranks_equal"])
        if name in ZOO_SP_BN:
            scale = max(float(np.abs(g).max())
                        for g in one["grads"].values())
            res["grads_max_diff"] = max(
                float(np.abs(g - one["grads"][k]).max())
                for k, g in got["grads"].items())
            if name in ZOO_SP_F64:
                wit = f64_witness(got["grads"], one["grads"],
                                  f64_grads(case, dev))
                res["f64_rel_l2_ranks_single"] = wit
                res["grads_off"] = [k for k, (a, b) in wit.items()
                                    if a > ZOO_SP_F64_RATIO * b + 1e-6]
            else:
                res["grads_off"] = [
                    k for k, g in got["grads"].items()
                    if not np.allclose(g, one["grads"][k], rtol=1e-3,
                                       atol=1e-4 * scale)]
            stats = [k for k in one["buffers"]
                     if k.endswith(ZOO_BUFFERS[:2])]
            res["stats_off"] = {
                k: float(np.abs(got["buffers"][k] - one["buffers"][k]).max())
                for k in stats if not np.allclose(
                    got["buffers"][k], one["buffers"][k], rtol=1e-5,
                    atol=1e-6)}
            ok = ok and not res["grads_off"] and not res["stats_off"]
        else:
            ok = ok and res["share_within"] > MESH_SHARE
        if not ok:
            bad.append(case["name"])
        out[case["name"]] = res
    log(f"zoo-sp phase, 2 ranks at sp=2 on one card: {json.dumps(out)}")
    if len(out) != len(zoo_sp_cases()) or bad:
        raise AssertionError(f"zoo-sp phase: the sp=2 step misses the "
                             f"single step: {bad or out}")


def zoo_sp_daemon(dev, work: Path, ckpts: dict, rng) -> None:
    """``cli/serve.py model=<family> mesh=True mesh_sp=2`` in f32 from the
    zoo phase's checkpoints (both replicas on ``dev``), one batch of B
    rows as one request, against ``make_pipeline``'s direct rows."""
    def one_card(device, dp, sp):  # the mesh's devices: dev, sp times
        return [torch.device(dev)] * ((dp or 1) * sp)

    orig = serve_cli.local_devices
    serve_cli.local_devices = one_card
    try:
        for name in ZOO_SP_DAEMON:
            args = {"model": name, "model_file": ckpts[name],
                    "ckpt_dir": str(work / "ckpts"), "length": L,
                    "dtype": "float32", "mesh": True, "mesh_sp": 2,
                    "max_batch": B, "max_wait_ms": 2, "port": 0,
                    "warmup": False, "th": "Null",
                    "max_echoes": DECODE["max_echoes"], **{
                        k: v for k, v in ZOO_OVERRIDES.items()
                        if k != "sample_num"}}
            state, over = cli_export.resolve_zoo_variables_and_overrides(
                args, name)
            rows = gate_batch(B, L, rng)
            want = make_pipeline(state, over, model_name=name, device=dev,
                                 dtype=torch.float32, threshold=None,
                                 max_echoes=DECODE["max_echoes"])(rows).cpu()
            hostd, server, port = serve_cli.build(args)
            try:
                with ServingClient(("127.0.0.1", port)) as client:
                    client.infer(rows[:, 0])  # warm-up
                    t0 = time.perf_counter()
                    got = torch.from_numpy(np.asarray(
                        client.infer(rows[:, 0])))
                    ms = (time.perf_counter() - t0) * 1e3
            finally:
                server.shutdown()
                server.server_close()
                hostd.close()
            res = zoo_sp_gate(name, got.reshape(want.shape).float(),
                              want.float(), 1)
            if name != "zonzini":  # the coords themselves, not a heatmap
                agree = float(((got - want).abs() <= 1.0).float().mean())
                res = dict(equal=bool(torch.equal(got, want)),
                           coord_agreement=agree,
                           ok=bool(torch.equal(got, want))
                           or agree >= AGREE_MIN)
            res["ms_per_request"] = ms
            log(f"zoo-sp phase, daemon {name} sp=2: {json.dumps(res)}")
            if not res["ok"]:
                raise AssertionError(f"zoo-sp phase, daemon {name}: {res}")
    finally:
        serve_cli.local_devices = orig


def zoo_sp_path(dev, work: Path, ckpts: dict, zoo_runs: list) -> None:
    """The zoo-sp phase (item 19 of the module docstring), the launch
    counts set to 0 before it and held at 0 after it: JAX's zoo under
    GSPMD reaches no Pallas kernel."""
    t_phase = time.perf_counter()
    reset_launch_counts()
    rng = np.random.default_rng(SEED + 10)
    zoo_sp_forwards(dev, work, ckpts, rng)
    zoo_sp_two_ranks(zoo_runs, dev)
    zoo_sp_daemon(dev, work, ckpts, rng)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"zoo-sp phase: a kernel launched: {launched}")
    log(f"zoo-sp phase: {time.perf_counter() - t_phase:.1f} s")


def default_flags() -> None:
    """PyTorch's own TF32 defaults (cuDNN's on, cuBLAS's off), which a
    daemon process serves under: the phases after the kernel checks run
    with them, their plain references in their own TF32-off scope."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def to_cpu(tree):
    """A nested dict of tensors, copied to the CPU."""
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all(SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "wgmma")):
                log(f"  {name}: {line.strip()}")
    log(f"card: {card()}")
    rng_new = np.random.default_rng(SEED + 2)  # this slice's phases
    first = canary(dev, rng_new)

    state = StofNet(generator=torch.Generator().manual_seed(SEED),
                    device=dev).state_dict()
    rng = np.random.default_rng(SEED)
    kernels = [kernel_sgb(dev, rng, state), kernel_stack(dev, rng, state),
               *kernels_trainable(dev, rng, state),
               kernel_sgb_dma(dev, rng_new, state)]
    probe_row, probe_launches = probe_path()
    kernels += [probe_row, first]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']})")

    paths = [probe_launches, main_path(dev, state, rng),
             bench_paths(dev, state, rng_new)["launches"],
             train_path(dev)["launches"]]
    default_flags()
    tf32_rows(dev, state)
    paths.append(daemon_path(dev, state))
    int8_path(dev, state)
    paths.append(export_path(dev, state))
    with stand_in() as (work, data):
        stofnet_ckpt = data_path(dev, work, data)
        ckpts = zoo_path(dev, work, data, rng_new)
        zoo_export_path(dev, work, ckpts, rng_new)
        paths.append(pala_path(dev, work))
        array_first = array_path(dev, work, data)
        sweep_path(work, data, stofnet_ckpt, ckpts)
        launches, sp_runs, zoo_runs = mesh_path(dev, work, data,
                                                stofnet_ckpt, array_first)
        paths.append(launches)
        paths.append(sp_path(dev, work, stofnet_ckpt, sp_runs))
        zoo_sp_path(dev, work, ckpts, zoo_runs)
    least = {"stream_probe": len(probe_script.POINTS), "canary": 1}
    for k in kernels:
        k["launches"] = sum(p.get(k["name"], 0) for p in paths)
        need = least.get(k["name"], N_BATCHES)
        if k["launches"] < need:
            raise AssertionError(f"{k['name']} launched {k['launches']} "
                                 f"times on its paths, fewer than {need}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
