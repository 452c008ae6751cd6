"""Drive the PyTorch/CUDA port (text2protein_tpu_torch) on one GPU.

Phases, each printing a flushed line with the seconds since start:
  1. device: needs CUDA; prints the card and its power limit.
  2. build: compiles every CUDA kernel with nvcc, one process per source,
     all started together, and prints each instantiation's registers,
     stack frame and spills from ptxas; a spill or a stack frame fails.
  3. kernels: holds each f32 kernel to its plain PyTorch version at every
     shape its L=128 path gives it (the forward at the serving shapes, the
     backward at the training shapes, with a fully masked row), prints each
     launch's route and plan (TF32 wgmma or mma.sync, tile, stages, blocks,
     cluster, shared memory, blocks per SM; a call with D <= 512 that does
     not take the wgmma kernels fails, but the mid block's AttnBlock, Tq =
     Tk = 16 at D = 256, which keeps mma.sync), and times kernel, plain
     version and the PyTorch library call that computes the same function,
     beside two bounds: f32 on the CUDA cores, and 3xTF32 on the tensor
     cores (the kernels' route); also each wrapper's host time per call,
     and the device time alone (calls replayed from a CUDA graph) of the
     kernel and of the library call (SDPA's backward: its forward and
     backward less its forward, both replayed). Then the f32
     instantiations' registers.
  4. serving: a flagship-width L=128 Server with seeded random weights
     answers requests (different captions and lengths, one seeded) over a
     short PC trajectory; every map must be finite, (5, 128, 128), with the
     length mask as its last channel, and the kernels' launch counts must be
     exactly what the path makes (36 forward launches per PC step, no
     backward launch).
  5. reference: one score evaluation on the GPU (kernels) against the same
     model on the CPU (plain versions).
  6. training: `cli/train.main` trains the bench_l128 configuration at batch
     16 on records written here (enough that the steps fall in one epoch,
     so the loader reads ahead as on a real dataset), 2 warm-up and 3 timed
     steps; losses finite, exactly 18 backward and 30 forward launches per
     step (18 + the 12 of the rematted transformer blocks' recompute), the
     weights moved, the EMA apart from them. A Server loads the EMA weights
     it wrote and answers a request. The run's workdir (config.yml, the
     split's ids, the meta, best_train and best_eval slots) goes under
     build/chip_smoke/; phase 12's too, removed after it.
  7. train reference: one flagship train step at B=1 (dropout 0, injected
     draws) on the GPU against the CPU: loss and every gradient.
  8. kernels bf16: the bf16 kernels against their plain versions at every
     shape of the N=256 paths (configs/quality_n256.yml: the forward at
     serving batch 4, the backward at training batch 8), timed as in 3,
     with bounds at the bf16 tensor-core rate: the function's, and that of
     the mma work the kernels issue (S recomputed per column chunk, the
     split products twice); every forward and every backward up to D=512
     on the wgmma kernels.
  9. serving N=256: a Server with quality_n256.yml's widths (bf16, seeded
     random weights) at batch 4 answers two batches of requests over 10 PC
     steps: maps finite, (5, 256, 256), the length mask as the last
     channel, exactly 96 bf16 forward launches per PC step.
 10. reference N=256: one bf16 score evaluation at B=1 on the GPU against
     the CPU in bf16 (plain versions) and in f32, and on the GPU with the
     attention through its plain version: the kernels' share.
 11. train reference N=256: one bf16 train step at B=1 with dropout 0.1
     (injected t and z, the same generator seed): remat against no remat
     and the kernels against the plain attention backward (both with cuDNN
     off, whose algorithm choice follows the allocator's free memory),
     beside the bf16-against-f32 gap.
 12. training N=256: `cli/train.main --config configs/quality_n256.yml` as
     written (bf16, remat, featurization on the device, batch 8) on seeded
     helix records of lengths 128-256, 1 warm-up and 2 timed steps: losses
     finite, weights and EMA moved, exactly 80 bf16 forward (48 + the 32 of
     the transformer blocks' recompute) and 32 bf16 backward launches per
     step (the 16 masked cross-attention calls over the 16-token caption
     take the JAX route, the einsum recompute); then the peak memory of one
     step at batch 2 with and without remat.
 13. deployment serving: `cli/serve` with configs/deploy_l128.yml as
     written (the hybrid sampler, 60 Heun + 170 PC steps, CFG 2.0) and
     `--checkpoint` phase 6's workdir (its best_eval EMA; bench_l128 has the
     same architecture) answers a seeded batch of 4 requests (different
     captions and lengths; one batch: the depth cut to keep the script
     inside its limit) over the full schedule:
     maps finite, (5, 128, 128), the length mask as the last channel, nfe
     920 in every response, exactly 16,560 f32 forward launches a batch
     (920 evaluations x 18) and no backward launch.
 14. sampling CLI: `cli/sampling_6d.main` on the same config and
     checkpoint, `--sampler pc --num_steps 10 --batch_size 4
     --select_length --length_index 37`, the captions of the workdir's
     held-out ids from phase 6's records: one pickle per held-out id of
     the first full batch, (1, 5, 128, 128), finite, the length-100 mask
     as the last channel.
 15. hybrid reference: a short hybrid (2 Heun + 2 PC steps, CFG 2.0) at
     B=1 at the deployment widths, seeded random weights and injected
     draws: the card with its kernels against the CPU with the plain
     versions, within a tolerance derived from phase 5's per-evaluation
     agreement.
 16. N=256 hybrid: `Server` with quality_n256.yml and `sampler="hybrid"`
     (4 Heun + 6 PC steps, no CFG) at batch 4: 20 evaluations x 48 bf16
     forward launches.
 17. SS training: `cli/train.main --config configs/quality_ss.yml` as
     written (length + SS + inpainting, C=8 featurized on the device, the
     caption padded to 16 tokens, batch 16, the JAX initializers) on C=8
     helix records written here, 2 warm-up and 3 timed steps: losses
     finite, weights and EMA moved, exactly 30 f32 forward (18 + the 12 of
     the transformer blocks' recompute) and 12 f32 backward launches per
     step (the 6 masked cross-attention calls over 16 keys take the JAX
     route, the einsum recompute); ms per step, samples/s, peak memory.
     First the f32 forward is held and timed at the step's 16-key shapes
     (batch 16, a fully masked row).
 18. SS train reference: one quality_ss.yml train step at B=1, dropout 0,
     injected t, z, inpainting mask and SS block dropout, on the card
     against the CPU (phase 7's tolerances).
 19. SS sampling: `cli/sampling_6d.main` with quality_ss.yml, phase 17's
     checkpoint and `--pdb` (a backbone written from one of its records)
     `--mask_info 1:5,10:15`, 10 PC steps at batch 4, `--n_iter 2`:
     pickles (1, 8, 128, 128), finite, their SS channels the PDB's, every
     entry outside the inpainting region the condition's, the last channel
     the length mask, exactly 720 f32 forward launches; s per PC step at
     batch 4 from the CLI's own sampler calls (the better of the two).
 20. bf16 at L=128 (configs/quality_ss_vp.yml): both bf16 kernels against
     their plain versions at every shape of its train step (batch 16: the
     AttnBlock at D=256, the transformer's 8 heads of 32, the
     cross-attention over 16 keys with a fully masked row, the 4x4 mid
     block), timed as in 8; then `cli/train.main --config
     configs/quality_ss_vp.yml` for 2 + 2 steps: finite losses, exactly 30
     bf16 forward and 12 bf16 backward launches per step, no f32 launch.
 21. text (configs/quality_text_cfgft.yml: the flagship widths in bf16,
     C=5 on the device, a 16-token hashed caption at D=512, context
     dropout 0.1, steps_per_launch 10): the bf16 kernels at its sampler's
     batch-4 shapes and its train step's backward shapes against their
     plain versions; `cli/text_preprocess` on a captions json written from
     data/processed_synth_text's 384 records (33 unique captions), the
     cache held against the hash encoder (exact); `cli/train.main` for 23
     steps at batch 16 with log_freq cut to 10: the resident bf16 context
     table (its size printed), 20 steps from it and 3 tail steps on the
     f32 encode, an epoch boundary crossed, exactly 30 bf16 forward and 12
     bf16 backward launches per step and 18 for the eval batch, the JAX
     trainer's tags in workdir/tb/metrics.jsonl; ms per step, peak memory
     and the host time of the f32 encode a table step saves;
     `cli/sampling_6d` on the held-out captions (10 PC steps, batch 4, 36
     bf16 forward launches per step); the samples scored by
     `eval.coords_compare` (every MSE finite) and `eval.helix_count`, and
     `eval.tm_sweeps.gt_gen_tm_compare` on two records' backbones written
     as PDBs: a record against itself scores 1 within 1e-6 by the native
     `run_tmalign` (which must run where it exists) and by the Python
     scorer.
 22. realize: four helix bundles of L=128 (`data/synthetic`, compacted by
     the port's L-BFGS on the card), their GT maps saved to
     chiprun_out/realize_maps.npz; every energy term and its gradient on
     the card against the CPU (energies 1e-5 relative, gradients 1e-4 of
     their scale) and the first 5 fold-stage L-BFGS iterations (the same
     linesearch steps, iterates within 1e-3 A); `run_minimization` at the
     JAX test's bar (L=64 bundle, 3 restarts, max_iter 150, seed 1: TM >
     0.8 to the truth by `eval.tmscore`, N-CA and C-N within 0.1 A of
     ideal); `realize_batch` of the 4 designs (5 restarts, its default,
     and max_iter 75 where it defaults to 300: the depth cut to keep the
     script inside its limit): TM-scores, selection energies, evaluations
     per solve, seconds per batch; 2 fold-stage iterations of that batch
     under the profiler (device busy share, launches per evaluation); the flagship
     Server at batch 4 with realize on at lengths 128, 96, 64 and 40: PDBs
     of those lengths, finite energies, seconds per realized design, no
     flash launch outside sampling; `cli/sampling_rosetta --fastdesign
     --designer learned --n_restarts 2 --max_iter 10` on phase 14's
     pickles (the depth cut to keep the script inside its limit), its
     score.txt files read back by `eval.tm_sweeps.reu_stats`.
 23. distributed: min(cards, 4) ranks (2 of 3), one per card, NCCL, by
     `parallel.launch.spawn`: 2 train steps of bench_l128_config() at
     batch 16 on phase 6's first batches under FSDP2 (mesh.model 1),
     held to the plain one-device steps on rank 0's card (phase 6's bars:
     loss 1e-4, the last step's gradients and the parameters 5e-3 of their
     scale), every rank's losses equal, exactly 30 f32 forward and 18 f32
     backward launches per sharded step on every rank; the checkpoint
     gathered from the shards, written, restored into a one-device state
     and saved again, bit for bit; ms per plain and per sharded step, and
     one more step of each timed in parts (forward + backward, clip +
     Adam, EMA, the card synchronized around each); with
     2 cards or more also data 2, with 4 also data 2 x model 2; then
     `graft_entry.entry()`'s flagship forward on the card (18 forward
     launches) and `graft_entry.dryrun_multichip(n)` on the same ranks.
 24. sequence parallel: both f32 kernels against their plain versions at
     every shape of the bench_l128 train step with the pair grid's rows
     split over 2 ranks (batch 16 x 2 stacked ranks: 128 query rows against
     256 gathered keys at 16x16, 8 against 16 and the 64-token caption in
     the 4x4 mid block), timed as in 3; then 2 train steps of
     bench_l128_config() at batch 16 (dropout 0.1) with the rows split over
     a `parallel.sequence.StackedRowGroup` of 2 (the `model` ranks stacked
     on the batch axis of one process, which needs only one card) against
     the plain steps from the same weights on phase 6's first batches:
     losses within 2e-4 relative, the last step's gradients within 5e-3 of
     their scale (phase 7's bar), exactly 30 forward and 18 backward
     launches per SP step (the plain step's calls at twice the batch); ms
     per plain and per SP step, peak memory of each.
 25. sequence parallel N=256: both bf16 kernels against their plain
     versions at every shape of the quality_n256.yml train step with the
     pair grid's rows split over 2 ranks (batch 8 x 2 stacked ranks: 512,
     128 or 32 query rows against 1024, 256 or 64 gathered keys, or the
     16-token caption), the forward at all 9, the backward at the 6
     unmasked, timed as in 8; then 2 train steps of quality_n256_config()
     as written (bf16, remat, featurization on the device, batch 8,
     dropout 0.1) with the rows over a `StackedRowGroup` of 2 against the
     plain steps from the same weights on phase 12's first batches:
     losses within 2e-3 relative and the last step's gradients within
     1e-1 of their scale (the CPU test's bf16 + remat bars), exactly 80
     bf16 forward (48 + the 32 of the transformer blocks' recompute) and
     32 bf16 backward launches per SP step and no f32 launch; ms per plain
     and per SP step, peak memory of each.
 26. HTTP server: `python -m text2protein_tpu_torch.cli.serve
     configs/deploy_l128.yml <phase 6's workdir>/checkpoints/best_eval
     --batch_size 4 --sampler pc --num_steps 10 --max_wait_ms 500
     --warmup --realize --port 0` (the JAX server's command line) as a
     process: /healthz (the JAX keys, platform gpu, the checkpoint's
     step); a burst of 4 concurrent requests and a seeded one sent while
     the burst is queued, a pair 100 ms apart, a realized request and a
     length of 1 (HTTP 400); the batches formed (one seed a batch) must be
     the JAX batcher's: the burst one batch, the seeded request alone, the
     pair one batch; the seeded map equal to the same request re-sent
     alone; every map checked as in 4; per-request latency and samples/min
     over the burst; on SIGINT the server prints its batches (the warm-up
     included) and flash launches, exactly batches x nfe x 18 f32
     forward and no other.
 27. kernels at the reference configurations: both f32 kernels against
     their plain versions at test_config.yml's shapes (the forward at its
     sampling batch 4, the backward at its training batch 2: the AttnBlock
     at D=512 and the transformer's 8 heads of 64 at 32x32, 16x16 and
     8x8, the cross-attention over the 512-key caption bucket, timed as in
     3, and over the 64-, 192- and 320-key buckets, held only), at
     test_config_large's 8x8 level (batch 2: the AttnBlock at D=1024, heads
     of 128) and at the caption configs' cross-attention (batch 8, heads
     of 32, every bucket from 128 to 512 keys, held only); the bf16
     forward at test_config_large's 8x8 shapes at batch 1 (D=1024 on a
     cluster of two blocks), its backward at batch 2 (D=1024 on the
     mma.sync kernels) and the forward at every call of bench_l128's bf16
     PC step at batch 16, timed as in 8. Every masked call has a fully
     masked row.
 28. reference config: `cli/train.main` on configs/test_config.yml as
     written (f32, N=256, no condition, the 4096-wide caption hashed to
     64-token buckets, batch 2) on 24 N=256 helix records with
     abstract-length captions (40-600 hash tokens), 1 + 2 steps; its
     end-of-run snapshot sample cut to 2 PC steps (the yml's 2000: the
     depth cut): losses finite, exactly 80 f32 forward (48 + the 32 of the
     transformer blocks' recompute) and 48 backward launches per step, 48
     for the eval batch and 48 x 2 x 2 for the snapshot, the snapshot
     (2, 5, 256, 256) finite; ms per train step, peak memory; then a
     Server from the checkpoint it wrote answers a seeded batch of 4
     (captions past the 512-token cut) over 10 PC steps, after one
     evaluation at its shapes (cuDNN's search): 960 forward launches,
     maps finite (5, 256, 256) with the length mask last; ms per PC step,
     peak memory. The caption buckets every encode took are printed.
 29. reference config on the CPU: test_config.yml at B=1 from seeded
     random weights: one score evaluation (rel 1e-4) and one train step
     (dropout 0, injected t and z: loss 1e-4, gradients 5e-3 of scale,
     the kernels against the plain attention backward on the card 1e-3)
     on the card against the CPU; 48 forward and 48 backward launches.
 30. reference variants: pod_config.yml and test_config_large.yml as
     written (f32, batch 1 and 2): one PC step of a Server with seeded
     random weights at the yml's batch, then one train step of those
     weights by `training.steps.make_train_step` (what cli/train.main runs
     each step; the trainer's two checkpoint slots would be 2 x 8 GB and
     2 x 14 GB): 18 and 66 forward launches an evaluation (attention pairs
     from the yml), 5 and 3 times that a train step, maps finite with the
     length mask last, the gradients finite; then test_config_large in
     bf16 (bench.py's dtype) with the same weights: one forward at batch
     1, 66 bf16 launches, finite, against the same forward with the plain
     attention (reported).
 31. caption family: the 4096-wide caption configs at L=128 as written
     (batch 8) on C=5 and C=8 helix records with abstract-length captions:
     `cli/train.main` on cond_ss_inpainting.yml for 3 steps and
     `cli/sampling_6d --pdb --mask_info` at 4 PC steps; cond_length,
     cond_length_no_ss, cond_length_inpainting, cond_ss and no_cond one
     train step and `cli/sampling_6d` at 2 PC steps each (--pdb where the
     yml conditions on SS or inpainting, else --select_length): exactly 30
     forward and 18 backward launches per step, 18 for the eval batch, 36
     per PC step; pickles finite, the conditions clamped, the length mask
     last. Then bench.py's default: a Server with bench_l128.yml in bf16
     at batch 16 over 10 PC steps, two batches: 360 bf16 forward launches
     a batch, no f32 launch, maps checked; ms per PC step (a smoke line).
     The batches of phases 28-31 must together have taken every caption
     bucket from 64 to 512 keys (the 600-token captions cut to 512).
Phase 3 also holds and times the f32 forward at the deployment config's
cross-attention shapes (the caption padded to 16 tokens: 256x16 and 16x16,
a fully masked row).

The f32 phases run in full f32 (TF32 off for matmuls and cuDNN); bf16 runs
with f32 accumulation (`use_full_f32`). The last line of stdout is
{"ok": true, "device": {...}}; any failure prints its traceback and exits
non-zero. Details go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
STEPS = 10           # PC steps per request batch (the full schedule is 2000)
BATCH = 4            # serving batch size
TOL = 1e-4           # forward kernel vs plain version, f32, max abs error
# backward kernel vs plain version: max abs error over 1e-4 of the largest
# |gradient| of the call (or 1e-4 absolute below 1): sums of up to 256 f32
# products in another order, on gradients up to ~100
BWD_TOL = 1e-4
E2E_TOL = 1e-4       # GPU vs CPU score, relative max diff
# GPU vs CPU train step: loss relative diff, and each gradient's max diff
# over its own max |grad| (floored at 1e-3 of the model's largest, as the
# attention key biases have a gradient of 0 in exact arithmetic). f32
# through ~100 layers of backward with the card's convolution, matmul and
# reduction orders: with the attention backward on its plain version the
# card already differs from the CPU by up to 2.5e-3 (GroupNorm scales of
# the 16x16 level; the median gradient 5e-4), hence 5e-3. The kernel's own
# share is held apart, on the card: the same step with the attention
# backward through its plain version, within 1e-3 (cuDNN's backward
# algorithms also sum in a different order from run to run).
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-3
TRAIN_KERNEL_TOL = 1e-3
TRAIN_BATCH = 16     # configs/bench_l128.yml training.batch_size
TRAIN_WARMUP = 2     # train steps before the timed ones
TRAIN_TIMED = 3
# the 95/5 split leaves 138 train records: 8 batches of 16, so every step
# of the run is in one epoch and the loader's thread reads ahead (a split of
# one batch would start a new loader, unread, on every step); the 7 eval
# records are filled to one batch
N_RECORDS = 145
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_S = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_TF32_S = 495e12     # H100 SXM TF32 tensor cores, dense
PEAK_BF16_S = 989e12     # H100 SXM bf16 tensor cores, dense

# N=256 (configs/quality_n256.yml): serving batch 4 over N256_STEPS PC
# steps; training at the yml's batch 8 on N256_RECORDS records of lengths
# 128-256 (the 95/5 split leaves 69 train records, 8 batches: the 8 steps
# fall in one epoch and the loader reads ahead; 3 eval records are filled
# to one batch)
N256_STEPS = 10
N256_BATCH = 4
N256_TRAIN_BATCH = 8
N256_WARMUP = 1
N256_TIMED = 2
N256_RECORDS = 72
N256_MEM_BATCH = 2   # the remat / no-remat peak-memory step
# a bf16 kernel against its plain version: both round one f32 result to
# bf16, and the f32 sums run in other orders, so an element may land one
# rounding step apart: max abs error <= one bf16 step (ulp) at the scale of
# the tensor (its largest |value|); lse (f32) within 1e-5 of max(1, |lse|)
LSE_TOL = 1e-5
# remat against no remat at B=1 on the card, each gradient's max |diff| over
# its max |grad| (floored at 1e-3 of the largest), cuDNN off
REMAT_TOL = 1e-5

# (name, H, Tq, Tk, D, masked, launches per PC step): the attention calls of
# the flagship score UNet, 2 evaluations per PC step (corrector, predictor).
PATH_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 10),
    ("self_16x16", 8, 256, 256, 32, False, 10),
    ("cross_16x16", 8, 256, 64, 32, True, 10),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 2),
    ("self_mid_4x4", 8, 16, 16, 32, False, 2),
    ("cross_mid_4x4", 8, 16, 64, 32, True, 2),
]
LAUNCHES_PER_STEP = sum(s[-1] for s in PATH_SHAPES)  # 36

# (name, H, Tq, Tk, D, masked, launches per PC step) of the N=256 model:
# attention at 32x32, 16x16 and 8x8 (the mid block's 8x8 pair included),
# the AttnBlock with one head of 512, the transformer with 8 heads of 64,
# the caption padded to its 16-token bucket (text.pad_to_bucket); five
# pairs at 32 and at 16, six at 8, per evaluation, 2 evaluations per PC
# step
N256_SHAPES = [
    ("attnblock_32x32", 1, 1024, 1024, 512, False, 10),
    ("self_32x32", 8, 1024, 1024, 64, False, 10),
    ("cross_32x32", 8, 1024, 16, 64, True, 10),
    ("attnblock_16x16", 1, 256, 256, 512, False, 10),
    ("self_16x16", 8, 256, 256, 64, False, 10),
    ("cross_16x16", 8, 256, 16, 64, True, 10),
    ("attnblock_8x8", 1, 64, 64, 512, False, 12),
    ("self_8x8", 8, 64, 64, 64, False, 12),
    ("cross_8x8", 8, 64, 16, 64, True, 12),
]
N256_LAUNCHES_PER_STEP = sum(s[-1] for s in N256_SHAPES)  # 96
# one forward and one backward per call in a train step (calls per step =
# PC-step launches / 2); the masked cross-attention over 16 keys is refused
# by the backward gate (`supports_bwd`, Tk % 64) and takes the einsum
# recompute, as in the JAX package
N256_TRAIN_SHAPES = [(n, h, tq, tk, d, m, c // 2)
                     for n, h, tq, tk, d, m, c in N256_SHAPES]
N256_BWD_SHAPES = [s for s in N256_TRAIN_SHAPES if not s[5]]
N256_FWD_PER_TRAIN_STEP = sum(s[6] for s in N256_TRAIN_SHAPES)  # 48
N256_BWD_PER_TRAIN_STEP = sum(s[6] for s in N256_BWD_SHAPES)  # 32
# the recompute of the rematted transformer blocks: self and cross of the
# 16 blocks
N256_REMAT_FWD_PER_TRAIN_STEP = 2 * 16

# (name, H, Tq, Tk, D, masked, calls per train step) of the flagship
# training step at B=16, one forward and one backward per call (no remat).
# Tk=64 is the hash encoder's caption bucket (text.pad_to_bucket). Every
# backward takes the kernel: the unmasked Tk=16 calls, which the JAX rule
# (`supports_bwd`) sends to the einsum fallback, pass `supports_bwd_cuda`.
TRAIN_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 5),
    ("self_16x16", 8, 256, 256, 32, False, 5),
    ("cross_16x16", 8, 256, 64, 32, True, 5),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 1),
    ("self_mid_4x4", 8, 16, 16, 32, False, 1),
    ("cross_mid_4x4", 8, 16, 64, 32, True, 1),
]
FWD_PER_TRAIN_STEP = sum(s[6] for s in TRAIN_SHAPES)  # 18
BWD_PER_TRAIN_STEP = FWD_PER_TRAIN_STEP  # 18
# the JAX model remats its transformer blocks (`remat_attention`), and so
# does the port: the backward recomputes self- and cross-attention of the 6
# blocks
REMAT_FWD_PER_TRAIN_STEP = 2 * 6


# the deployment config (configs/deploy_l128.yml): the flagship widths with
# the caption padded to a 16-token bucket, the hybrid sampler (60 Heun + 170
# PC steps) under CFG 2.0: NFE (2 * 60 + 170 * 2) * 2 = 920 a batch, 18
# f32 forward launches each
DEPLOY_CONFIG = ROOT / "configs" / "deploy_l128.yml"
DEPLOY_BATCH = 4
DEPLOY_NFE = 920
DEPLOY_LAUNCHES_PER_EVAL = 18
# (name, H, Tq, Tk, D, masked, launches per evaluation): the deployment
# path's cross-attention over the 16-token caption; its other 12 calls per
# evaluation have the serving path's shapes (PATH_SHAPES, unmasked)
DEPLOY_SHAPES = [
    ("cross_16x16_tk16", 8, 256, 16, 32, True, 5),
    ("cross_mid_4x4_tk16", 8, 16, 16, 32, True, 1),
]
SAMPLING_STEPS = 10  # PC steps of the sampling CLI phase
# the N=256 hybrid: 4 Heun + 6 PC steps, quality_n256.yml has no CFG
N256_HYBRID = (4, 6)
N256_HYBRID_NFE = 2 * N256_HYBRID[0] + 2 * N256_HYBRID[1]  # 20
HYBRID_REF_STEPS = (2, 2)  # the hybrid reference's Heun and PC steps
WORK = ROOT / "build" / "chip_smoke"  # training workdirs, samples

# configs/quality_ss.yml (C=8, length + ss + inpainting, f32, batch 16) and
# its bf16 sibling quality_ss_vp.yml, trained on SS_RECORDS C=8 helix
# records of the yml's lengths 64-128 (the 95/5 split leaves 138 train
# records, 8 batches of 16: one epoch, the loader reads ahead; the 7 eval
# records are filled to one batch)
SS_CONFIG = ROOT / "configs" / "quality_ss.yml"
SS_VP_CONFIG = ROOT / "configs" / "quality_ss_vp.yml"
SS_RECORDS = 145
SS_BATCH = 16
SS_WARMUP, SS_TIMED = 2, 3
SS_VP_WARMUP, SS_VP_TIMED = 2, 2
# (name, H, Tq, Tk, D, masked, calls per train step) of a quality_ss train
# step: the flagship's attention with the caption padded to 16 tokens
# (text.pad_to_bucket), forward calls counting the transformer blocks'
# recompute (self and cross twice); the masked calls over 16 keys fail the
# backward gate (`supports_bwd`, Tk % 64) and take the einsum recompute
SS_TRAIN_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 5),
    ("self_16x16", 8, 256, 256, 32, False, 10),
    ("cross_16x16_tk16", 8, 256, 16, 32, True, 10),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 1),
    ("self_mid_4x4", 8, 16, 16, 32, False, 2),
    ("cross_mid_4x4_tk16", 8, 16, 16, 32, True, 2),
]
SS_FWD_PER_TRAIN_STEP = sum(s[6] for s in SS_TRAIN_SHAPES)  # 30
SS_FWD_PER_EVAL = 18  # an eval batch: one call each, no recompute
SS_BWD_SHAPES = [(n, h, tq, tk, d, m, c if "attnblock" in n else c // 2)
                 for n, h, tq, tk, d, m, c in SS_TRAIN_SHAPES if not m]
SS_BWD_PER_TRAIN_STEP = sum(s[6] for s in SS_BWD_SHAPES)  # 12
SS_SAMPLING_STEPS = 10
SS_SAMPLING_BATCH = 4
SS_SAMPLING_ITERS = 2  # the CLI's --n_iter: the second call is warm
SS_MASK_INFO = "1:5,10:15"

# the caption path and evaluation (configs/quality_text_cfgft.yml: the
# flagship widths in bf16, C=5 featurized on the device, the caption padded
# to 16 hashed tokens at D=512, context dropout 0.1, steps_per_launch 10,
# batch 16) on the tracked records of data/processed_synth_text (384
# records, 33 unique captions; the 95/5 split leaves 365 train records,
# 22 steps an epoch). 23 steps: 2 full groups of 10 take their context
# from the resident bf16 table, 3 tail steps the f32 encode, and the run
# crosses an epoch boundary. The yml's log_freq 50 is cut to 10, so that
# the run writes training_loss (at steps 10 and 20).
TEXT_CONFIG = ROOT / "configs" / "quality_text_cfgft.yml"
TEXT_RECORDS = ROOT / "data" / "processed_synth_text"
TEXT_STEPS = 23
TEXT_TABLE_STEPS = 20
TEXT_LOG_FREQ = 10
TEXT_WARMUP = 2  # train steps left out of the step times
TEXT_SAMPLING_STEPS = 10
TEXT_SAMPLING_BATCH = 4
# (name, H, Tq, Tk, D, masked, launches per PC step) of its sampler at
# batch 4: the flagship's attention with the caption's 16 keys
TEXT_PC_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 10),
    ("self_16x16", 8, 256, 256, 32, False, 10),
    ("cross_16x16_tk16", 8, 256, 16, 32, True, 10),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 2),
    ("self_mid_4x4", 8, 16, 16, 32, False, 2),
    ("cross_mid_4x4_tk16", 8, 16, 16, 32, True, 2),
]
TEXT_FWD_PER_PC_STEP = sum(s[6] for s in TEXT_PC_SHAPES)  # 36


# sequence parallelism (phase 24): bench_l128 at batch 16 with the pair
# grid's rows split over SP_MODEL ranks stacked on the batch axis of one
# process (parallel.sequence.StackedRowGroup), so every attention call runs
# at batch 16 x 2 with a rank's query rows (8 of 16 rows, 2 of 4 in the mid
# block) against the gathered keys (self) or the whole 64-token caption
# (cross). (name, H, Tq, Tk, D, masked, forward calls per train step, the
# transformer blocks' recompute included); the backward takes one call per
# attention, every one the kernel (`supports_bwd_cuda`)
SP_MODEL = 2
SP_STEPS = 2
SP_BATCH = TRAIN_BATCH * SP_MODEL
SP_SHAPES = [
    ("sp_attnblock_16x16", 1, 128, 256, 256, False, 5),
    ("sp_self_16x16", 8, 128, 256, 32, False, 10),
    ("sp_cross_16x16", 8, 128, 64, 32, True, 10),
    ("sp_attnblock_mid_4x4", 1, 8, 16, 256, False, 1),
    ("sp_self_mid_4x4", 8, 8, 16, 32, False, 2),
    ("sp_cross_mid_4x4", 8, 8, 64, 32, True, 2),
]
SP_BWD_SHAPES = [(n, h, tq, tk, d, m, c if "attnblock" in n else c // 2)
                 for n, h, tq, tk, d, m, c in SP_SHAPES]
SP_LOSS_TOL = 2e-4   # the SP step's losses against the plain step's (rel)

# sequence parallelism at N=256 (phase 25): quality_n256.yml as written
# (bf16, remat, featurization on the device, batch 8) with the rows split
# over SP_MODEL stacked ranks, so every attention call runs at batch 8 x 2
# with a rank's query rows (16 of 32 rows, 8 of 16, 4 of 8) against the
# gathered keys (self) or the 16-token caption (cross). (name, H, Tq, Tk,
# D, masked, forward calls per train step, the transformer blocks'
# recompute included: 80); the backward takes the unmasked calls (32), the
# masked cross-attention over 16 keys the einsum recompute (`supports_bwd`)
SP256_BATCH = N256_TRAIN_BATCH * SP_MODEL
SP256_SHAPES = [
    ("sp_attnblock_32x32", 1, 512, 1024, 512, False, 5),
    ("sp_self_32x32", 8, 512, 1024, 64, False, 10),
    ("sp_cross_32x32", 8, 512, 16, 64, True, 10),
    ("sp_attnblock_16x16", 1, 128, 256, 512, False, 5),
    ("sp_self_16x16", 8, 128, 256, 64, False, 10),
    ("sp_cross_16x16", 8, 128, 16, 64, True, 10),
    ("sp_attnblock_8x8", 1, 32, 64, 512, False, 6),
    ("sp_self_8x8", 8, 32, 64, 64, False, 12),
    ("sp_cross_8x8", 8, 32, 16, 64, True, 12),
]
SP256_BWD_SHAPES = [(n, h, tq, tk, d, m, c if "attnblock" in n else c // 2)
                    for n, h, tq, tk, d, m, c in SP256_SHAPES if not m]
# the SP step against the plain one in bf16 + remat: the bars of the CPU
# test of the same settings (tests/test_torch_sequence_parallel.py
# SETTINGS["bf16_remat"]): the split rows sum the halo convolutions,
# GroupNorm and the gathered attention in another order and bf16 rounds
# each op, so the two steps sit about as far apart as bf16 from f32 (on the
# CPU at the N=256 depth: loss 0, gradients 9.0e-3 of their scale)
SP256_LOSS_TOL = 2e-3
SP256_GRAD_TOL = 1e-1

# the HTTP server (phase 26): the JAX server's command line on phase 6's
# best_eval with the deployment config, sampled by 10 PC steps at batch 4
HTTP_BATCH = 4
HTTP_STEPS = 10
HTTP_WAIT_MS = 500      # the batcher's window
HTTP_START_S = 600      # the server's start (imports, weights, warm-up)
HTTP_REQUEST_S = 600    # each request's limit (the realized one included)
HTTP_PAIR_GAP_S = 0.1   # the pair's second request, inside the window
HTTP_BURST = [
    {"caption": "A small alpha-helical bundle that binds zinc.",
     "length": 64},
    {"caption": "beta barrel membrane transporter", "length": 100},
    {"caption": "", "length": 128},
    {"caption": "three helix bundle", "length": 87},
]
HTTP_SEEDED = {"caption": "Kinase domain with a long activation loop.",
               "length": 77, "seed": 24680}
HTTP_PAIR = [{"caption": "a coiled coil", "length": 112},
             {"caption": "a four helix bundle", "length": 96}]
HTTP_REALIZE = {"caption": "a helical hairpin", "length": 40,
                "realize": True}


# the repo's reference configurations (phases 27-31). test_config.yml: the
# reference's f32 N=256 model, attention at 32, 16 and 8 (the AttnBlock one
# head of 512, the transformer 8 heads of 64), the caption 4096 wide,
# hashed to 64-token buckets of at most 512, no condition; trained at its
# batch 2, sampled at batch 4. Its variants: test_config_large.yml (the 8x8
# level 1024 wide: the AttnBlock at D=1024, heads of 128; 3 res blocks)
# and pod_config.yml (attention at 8 only, a 128-wide caption, batch 1).
# The caption configs at L=128 (batch 8, the caption 4096 wide). Captions
# of abstract length (`helix_records.abstract_captions`: 40-600 hash
# tokens), so that the batches land in every bucket from 64 to 512 and
# past the 512-token cut.
REF_CONFIG = ROOT / "configs" / "test_config.yml"
REF_LARGE_CONFIG = ROOT / "configs" / "test_config_large.yml"
REF_POD_CONFIG = ROOT / "configs" / "pod_config.yml"
BENCH_CONFIG = ROOT / "configs" / "bench_l128.yml"
# N=256 records of lengths 128-256: the 95/5 split leaves 23 train records,
# 11 batches of 2, and the eval record is filled to one batch
REF_RECORDS = 24
REF_TRAIN_BATCH = 2
REF_BATCH = 4
REF_WARMUP, REF_TIMED = 1, 2
REF_STEPS = 10           # PC steps of test_config's sampling batch
REF_SNAPSHOT_STEPS = 2   # the end-of-run snapshot sample's PC steps (the
#                          yml's schedule is 2000: the depth cut)
REF_TK = 512             # the sampling batch's caption bucket
REF_BUCKETS = (64, 192, 320, 512)
CAPTION_BUCKETS = tuple(range(128, 513, 64))


def attn_pairs(config):
    """Attention pairs (an AttnBlock and a SpatialTransformer) of one
    evaluation, from the yml: num_res_blocks on the way down and
    num_res_blocks + 1 on the way up at each attention resolution, and the
    mid block's."""
    m = config.model
    return (2 * m.num_res_blocks + 1) * len(m.attn_resolutions) + 1


def attn_shapes(levels, d_model, tk, per_call):
    """(name, H, Tq, Tk, D, masked, count) of the AttnBlock (one head of
    d_model), the transformer's self-attention (8 heads) and its masked
    cross-attention over the `tk`-key caption at each (resolution, pairs)
    of `levels`; `per_call(kind, pairs)` gives each kind's count."""
    out = []
    for res, pairs in levels:
        t = res * res
        out += [(f"attnblock_{res}x{res}", 1, t, t, d_model, False,
                 per_call("attnblock", pairs)),
                (f"self_{res}x{res}", 8, t, t, d_model // 8, False,
                 per_call("self", pairs)),
                (f"cross_{res}x{res}", 8, t, tk, d_model // 8, True,
                 per_call("cross", pairs))]
    return out


# test_config's attention: five pairs at 32 and at 16, six at 8 (the mid
# block's included), 48 calls an evaluation; the PC step's counts (two
# evaluations) and the train step's backward calls (one each: every masked
# call over a 64-multiple bucket passes `supports_bwd`)
REF_LEVELS = ((32, 5), (16, 5), (8, 6))
REF_SHAPES = attn_shapes(REF_LEVELS, 512, REF_TK, lambda k, p: 2 * p)
REF_BWD_SHAPES = attn_shapes(REF_LEVELS, 512, REF_TK, lambda k, p: p)
# test_config_large's 8x8 level (seven pairs and the mid block's), at
# its training batch 2
REF_LARGE_SHAPES = attn_shapes(((8, 8),), 1024, REF_TK, lambda k, p: p)
# the caption configs' cross-attention (batch 8; five pairs at 16x16, the
# 4x4 mid block's), 8 heads of 32, over every bucket from 128 to 512
CAPTION_SHAPES = [
    (f"cross_{r}x{r}_tk{tk}", 8, r * r, tk, 32, True, p)
    for tk in CAPTION_BUCKETS for r, p in ((16, 5), (4, 1))]
CAPTION_BATCH = 8
# (yml, record set's channels, train steps, sampling condition, PC steps):
# the union config first, for a few steps
CAPTION_FAMILY = [
    ("cond_ss_inpainting.yml", 8, 3, "pdb", 4),
    ("cond_length.yml", 5, 1, "length", 2),
    ("cond_length_no_ss.yml", 5, 1, "length", 2),
    ("cond_length_inpainting.yml", 8, 1, "pdb", 2),
    ("cond_ss.yml", 8, 1, "pdb", 2),
    ("no_cond.yml", 8, 1, "length", 2),
]
CAPTION_RECORDS = {5: 24, 8: 24}   # L=128 records (lengths 64-128) a set
CAPTION_LENGTH_INDEX = 61          # --select_length: length 100
# bench.py's default: bench_l128.yml in bf16 at batch 16, every forward
# call of its PC step: the flagship's attention over the 64-key caption
# bucket, the f32 serving path's shapes
BENCH_BF16_BATCH = 16
BENCH_BF16_STEPS = 10
BENCH_BF16_SHAPES = PATH_SHAPES
# test_config_large in bf16 (bench.py's dtype): its 8x8 calls (the
# AttnBlock at D=1024, heads of 128, the caption's 128-key bucket)
REF_LARGE_BF16_SHAPES = attn_shapes(((8, 8),), 1024, 128, lambda k, p: p)


def log(msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(torch, fn, iters=50, warmup=3):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
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


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script needs a GPU")
    from text2protein_tpu_torch import use_full_f32

    use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off for matmul and cuDNN, "
        f"cudnn.benchmark on")
    return kind, smi


def bound(nbytes, flops):
    """(least ms, what bounds it) at the H100's HBM and f32 rates."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def tc_bound(nbytes, flops):
    """Least ms of the kernels' route: 3xTF32 does three TF32 products per
    f32 product on the tensor cores."""
    return max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3


def host_us(fn, iters=50):
    """Microseconds of host time per call of fn(), the device not waited
    for (the wrapper's checks, allocations and launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def graph_us(torch, fn, calls=20, replays=5):
    """Microseconds of device time per call of fn(): `calls` calls captured
    in one CUDA graph and replayed, so the host's time per call (which
    paces back-to-back calls of the small shapes) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls) * 1e3


def ptxas_functions(log_text):
    """{kernel instantiation: {registers, stack, spill_stores,
    spill_loads}} from `nvcc -Xptxas -v` output."""
    import re

    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            mangled = m.group(1)
            # the name follows its length digits (Itanium mangling), after
            # the anonymous namespace's hashed file name
            k = re.search(r"\d(flash_[a-z0-9_]*?kernel)I((?:Li\d+E)+)",
                          mangled)
            name = (k.group(1) + "<" + ",".join(
                re.findall(r"Li(\d+)E", k.group(2))) + ">") if k else mangled
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from text2protein_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    # one nvcc process per source, all at once
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    ptxas = {}
    for src in sources:
        info = _build.BUILD_LOG[src]
        log(f"build: {src} in {info['seconds']:.2f}s")
        for fn, r in ptxas_functions(info["ptxas"]).items():
            ptxas[fn] = r
            log(f"  ptxas: {fn}: {r.get('registers')} registers, "
                f"{r.get('stack')} bytes stack frame, "
                f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
                f"stores/loads")
    bad = [fn for fn, r in ptxas.items()
           if r.get("stack") or r.get("spill_stores") or r.get("spill_loads")]
    if not ptxas or bad:
        raise AssertionError(f"ptxas: a stack frame or spills in {bad}"
                             if bad else "ptxas reported no kernel")
    return ptxas


def f32_route(name, tq, tk, d, plan, *prefixes):
    """The route of an f32 call from its launch plan ("wgmma": the TF32
    wgmma kernels; "mma.sync": those of D > 512 and of the 4x4 mid block's
    AttnBlock, Tq = Tk = 16 at D = 256, the route's one exception); fails
    where a call takes another route than that rule's (every kernel of the
    backward, by the plan's `prefixes`)."""
    wgmma = all(plan[f"{p}wgmma"] == 1 for p in prefixes or ("",))
    if wgmma != (d <= 512 and not (d > 128 and tq <= 16 and tk <= 16)):
        raise AssertionError(f"{name}: D={d} took the "
                             f"{'wgmma' if wgmma else 'mma.sync'} kernels: "
                             f"plan {plan}")
    return "wgmma" if wgmma else "mma.sync"


def f32_register_report(ptxas):
    """{instantiation: (registers, spill stores, spill loads)} of the f32
    kernels: the TF32 wgmma ones and the mma.sync ones of D > 512."""
    return {k: (r.get("registers"), r.get("spill_stores"),
                r.get("spill_loads"))
            for k, r in ptxas.items()
            if "_bf16" not in k and "wgmma" not in k}


def phase_kernels(torch, shapes=PATH_SHAPES, lengths=(5, 12, 37), b=BATCH,
                  timed=True):
    """The f32 forward at `shapes` (batch b), a masked call's key lengths
    `lengths` and then all keys (a length of 0: a fully masked row); with
    `timed` False only held to the plain version."""
    import torch.nn.functional as F

    from text2protein_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, h, tq, tk, d, masked, per_step in shapes:
        q, k, v = (torch.randn((b, h, t, d), device=dev, generator=gen)
                   for t in (tq, tk, tk))
        mask = None
        if masked:
            lengths_t = torch.tensor(
                [*lengths] + [tk] * max(1, b - len(lengths)), device=dev)[:b]
            mask = torch.arange(tk, device=dev)[None, :] < lengths_t[:, None]
        scale = d**-0.5
        out, lse = flash.flash_attention_fwd(q, k, v, scale, mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attention_fwd_reference(
            q, k, v, scale, mask)
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not (err <= TOL and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err:.3e} > {TOL:.0e}")
        if masked and 0 in lengths and not bool((out[0] == 0).all()):
            raise AssertionError(f"{name}: the fully masked row is not 0")
        plan = flash.launch_plan("fwd", b, h, tq, tk, d)
        route = f32_route(name, tq, tk, d, plan)
        if not timed:
            rows.append(dict(shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                             masked=masked, max_abs_err=err, route=route,
                             plan=plan))
            log(f"kernel flash_fwd {name} B={b} H={h} Tq={tq} Tk={tk} "
                f"D={d} mask={masked}"
                f"{' +dead row' if masked and 0 in lengths else ''}: "
                f"max_abs_err {err:.2e} (tol {TOL:.0e}) route {route} "
                f"plan {plan}")
            continue
        attn_mask = None if mask is None else mask[:, None, None, :]
        kernel_ms = cuda_ms(torch, lambda: flash.flash_attention_fwd(
            q, k, v, scale, mask))
        host = host_us(lambda: flash.flash_attention_fwd(q, k, v, scale,
                                                         mask))
        device = graph_us(torch, lambda: flash.flash_attention_fwd(
            q, k, v, scale, mask))
        plain_ms = cuda_ms(torch, lambda: flash.flash_attention_fwd_reference(
            q, k, v, scale, mask))
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                  scale=scale)

        library_ms = cuda_ms(torch, sdpa)
        library_device = graph_us(torch, sdpa)
        nbytes = (4 * (2 * q.numel() + k.numel() + v.numel() + b * h * tq)
                  + (b * tk if masked else 0))
        flops = 4 * b * h * tq * tk * d
        bound_ms, bound_by = bound(nbytes, flops)
        rows.append(dict(
            shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d, masked=masked,
            per_step=per_step, max_abs_err=err, ms=kernel_ms,
            host_us=host, device_ms=device / 1e3, plain_ms=plain_ms,
            library_ms=library_ms, library_device_ms=library_device / 1e3,
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            tc_bound_ms=tc_bound(nbytes, flops), route=route, plan=plan))
        log(f"kernel flash_fwd {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"mask={masked}{' +dead row' if masked and 0 in lengths else ''}"
            f": max_abs_err {err:.2e} (tol {TOL:.0e}) "
            f"kernel_ms {kernel_ms:.4f} host_us {host:.1f} device_us "
            f"{device:.1f} plain_ms {plain_ms:.4f} library_ms(sdpa) "
            f"{library_ms:.4f} library_device_us(sdpa) {library_device:.1f} "
            f"bound_ms {bound_ms:.5f} (f32) {tc_bound(nbytes, flops):.5f} "
            f"(3xTF32) route {route} plan {plan}")
    return rows


def phase_kernels_bwd(torch, shapes=TRAIN_SHAPES, b=TRAIN_BATCH,
                      timed=True):
    """The backward at the training shapes, B=16 (or `shapes` at batch
    `b`): the kernel against its plain version on the same residuals (from
    the forward kernel), with the serving masks plus one fully masked
    row (at b < 5, the first b - 1 of them); with `timed` False only held
    to the plain version."""
    import torch.nn.functional as F

    from text2protein_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, h, tq, tk, d, masked, per_step in shapes:
        q, k, v, g = (torch.randn((b, h, t, d), device=dev, generator=gen)
                      for t in (tq, tk, tk, tq))
        mask = None
        if masked:
            lengths = torch.tensor(
                ([5, 12, 37] + [tk] * (b - 4))[:b - 1] + [0], device=dev)
            mask = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
        scale = d**-0.5
        out, lse = flash.flash_attention_fwd(q, k, v, scale, mask)
        if not flash.supports_bwd_cuda(q, k, v, masked):
            raise AssertionError(f"{name}: the backward gate refuses it")
        got = flash.flash_attention_bwd(q, k, v, out, lse, g, scale, mask)
        torch.cuda.synchronize()
        want = flash.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                   scale, mask)
        err = max((x - w).abs().max().item() for x, w in zip(got, want))
        ref_scale = max(w.abs().max().item() for w in want)
        finite = all(torch.isfinite(x).all() for x in got)
        if not (finite and err <= BWD_TOL * max(1.0, ref_scale)):
            raise AssertionError(
                f"{name}: backward kernel vs plain max abs error "
                f"{err:.3e} > {BWD_TOL:.0e} x {max(1.0, ref_scale):.3g}")
        plan = flash.launch_plan("bwd", b, h, tq, tk, d)
        route = f32_route(name, tq, tk, d, plan, "dq_", "dkdv_")
        if not timed:
            rows.append(dict(shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                             masked=masked, dead_row=masked,
                             max_abs_err=err, grad_scale=ref_scale,
                             route=route, plan=plan))
            log(f"kernel flash_bwd {name} B={b} H={h} Tq={tq} Tk={tk} "
                f"D={d} mask={masked}{' +dead row' if masked else ''}: "
                f"max_abs_err {err:.2e} (tol {BWD_TOL:.0e} x "
                f"{max(1.0, ref_scale):.3g}) route {route} plan {plan}")
            continue
        kernel_ms = cuda_ms(torch, lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        host = host_us(lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        device = graph_us(torch, lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        plain_ms = cuda_ms(torch, lambda: flash.flash_attention_bwd_reference(
            q, k, v, out, lse, g, scale, mask))
        # the library's backward: autograd of SDPA, fwd+bwd minus fwd, back
        # to back and by device time (CUDA-graph replay, as the kernel's)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        attn_mask = None if mask is None else mask[:, None, None, :]

        def sdpa():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(
                    *xs, attn_mask=attn_mask, scale=scale)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), xs, g)

        library_ms = cuda_ms(torch, sdpa_both) - cuda_ms(torch, sdpa)
        library_device = (graph_us(torch, sdpa_both)
                          - graph_us(torch, lambda: sdpa().detach()))
        # bytes: q, k, v, out, dO, lse (and mask) read once, dq, dk, dv
        # written once; FLOPs: 10 B H Tq Tk D (the JAX cost estimate)
        nbytes = (4 * (2 * (q.numel() + k.numel() + v.numel()) + out.numel()
                       + g.numel() + b * h * tq) + (b * tk if masked else 0))
        flops = 10 * b * h * tq * tk * d
        bound_ms, bound_by = bound(nbytes, flops)
        rows.append(dict(
            shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d, masked=masked,
            dead_row=masked, per_step=per_step, max_abs_err=err,
            grad_scale=ref_scale, ms=kernel_ms, host_us=host,
            device_ms=device / 1e3,
            plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=library_device / 1e3, bytes=nbytes,
            flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            tc_bound_ms=tc_bound(nbytes, flops), route=route, plan=plan))
        log(f"kernel flash_bwd {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"mask={masked}{' +dead row' if masked else ''}: max_abs_err "
            f"{err:.2e} (tol {BWD_TOL:.0e} x {max(1.0, ref_scale):.3g}) "
            f"ms {kernel_ms:.4f} host_us {host:.1f} device_us {device:.1f} "
            f"plain_ms "
            f"{plain_ms:.4f} library_ms(sdpa bwd) {library_ms:.4f} "
            f"library_device_us(sdpa bwd) {library_device:.1f} bound_ms "
            f"{bound_ms:.5f} (f32) {tc_bound(nbytes, flops):.5f} (3xTF32) "
            f"route {route} plan {plan}")
    return rows


def check_maps(results, reqs, n):
    """Every response's map finite, (5, n, n), its last channel the
    request's length mask."""
    import numpy as np

    from text2protein_tpu_torch.cli.serve import decode_coords

    for req, res in zip(reqs, results):
        cnn = decode_coords(res)
        L = req["length"]
        if cnn.shape != (5, n, n) or not np.isfinite(cnn).all():
            raise AssertionError(f"bad map {cnn.shape} for {req}")
        want = np.zeros((n, n), np.float32)
        want[:L, :L] = 1.0
        if not np.array_equal(cnn[-1], want):
            raise AssertionError(f"last channel is not the length mask for "
                                 f"{req}")
        if "seed" in req and res["seed"] != req["seed"]:
            raise AssertionError("the request's seed was not used")


def phase_serving(torch):
    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import flagship_config
    from text2protein_tpu_torch.ops import flash

    t = time.perf_counter()
    server = Server(flagship_config(), batch_size=BATCH, num_steps=STEPS,
                    device="cuda", weight_seed=0)
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serving: flagship Server ({n_params} params, batch {BATCH}, "
        f"{STEPS} PC steps) built in {time.perf_counter() - t:.2f}s")
    server.run_batch([{"caption": "warm-up", "length": 64}])
    log("serving: warm-up batch done")

    batches = [
        [{"caption": "A small alpha-helical bundle that binds zinc.",
          "length": 64},
         {"caption": "beta barrel membrane transporter", "length": 100},
         {"caption": "", "length": 128}],
        [{"caption": "Kinase domain with a long activation loop.",
          "length": 77, "seed": 1234}],
    ]
    launches = 0
    seconds = []
    for reqs in batches:
        flash.flash_attention_fwd.launches = 0
        flash.flash_attention_bwd.launches = 0
        t = time.perf_counter()
        results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = flash.flash_attention_fwd.launches
        launches += got
        if got != LAUNCHES_PER_STEP * STEPS:
            raise AssertionError(f"flash_fwd launched {got} times in a "
                                 f"batch, expected {LAUNCHES_PER_STEP} x "
                                 f"{STEPS}")
        if flash.flash_attention_bwd.launches:
            raise AssertionError("serving launched the backward kernel")
        check_maps(results, reqs, 128)
        log(f"serving: batch of {len(reqs)} request(s) in "
            f"{seconds[-1]:.3f}s, flash_fwd launches {got} "
            f"(= {LAUNCHES_PER_STEP} x {STEPS} steps), maps finite "
            f"(5, 128, 128), last channel = length mask, nfe "
            f"{results[0]['nfe']}")
    s_per_step = min(seconds) / STEPS
    log(f"serving: {s_per_step * 1e3:.2f} ms per PC step at batch {BATCH}; "
        f"{BATCH * 60 / (s_per_step * STEPS):.1f} samples/min at {STEPS} "
        f"steps, {BATCH * 60 / (s_per_step * 2000):.3f} samples/min at the "
        f"full 2000 steps")
    return server, launches, seconds


def phase_reference(torch, server):
    import copy

    import numpy as np

    from text2protein_tpu_torch.ops import flash

    model = server.model
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.standard_normal((1, 128, 128, 5)) * 10).astype(np.float32))
    labels = torch.tensor([1000.0])
    ctx_np, mask_np = server.encoder.encode(
        ["A small alpha-helical bundle that binds zinc."])
    ctx, mask = torch.from_numpy(ctx_np), torch.from_numpy(mask_np)
    before = flash.flash_attention_fwd.launches
    with torch.inference_mode():
        gpu = model(x.cuda(), labels.cuda(), ctx.cuda(), mask.cuda()).cpu()
        cpu = cpu_model(x, labels, ctx, mask)
    if flash.flash_attention_fwd.launches - before != 18:
        raise AssertionError("the GPU score evaluation did not launch the "
                             "flash kernel 18 times")
    diff = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
    if not diff < E2E_TOL:
        raise AssertionError(f"GPU score vs CPU score: rel max diff {diff}")
    log(f"reference: flagship score on GPU vs CPU, rel max diff {diff:.2e} "
        f"(tol {E2E_TOL:.0e})")
    return diff


def moved_from_start(torch, config, state):
    """(params moved from the trainer's start, params the EMA holds apart
    from them, the number of params) after a run of cli/train.main; the
    start is the JAX initializers' draw from config.seed (`init_params`).
    Fails unless at least half moved and half stand apart."""
    from text2protein_tpu_torch.models.unet import build_model, init_params

    start = dict(init_params(build_model(config, device="cpu"),
                             torch.Generator().manual_seed(int(config.seed)))
                 .named_parameters())
    params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    moved = sum(not torch.equal(params[k], start[k]) for k in params)
    ema_apart = sum(not torch.equal(params[k], state.ema.params[k].cpu())
                    for k in params)
    if moved < len(params) // 2 or ema_apart < len(params) // 2:
        raise AssertionError(f"{moved} of {len(params)} params moved, "
                             f"{ema_apart} EMA params differ from them")
    return moved, ema_apart, len(params)


def phase_training(torch, records, weights):
    """cli/train.main at bench_l128_config(), batch 16, from seeded random
    weights; then a Server answers one request from the EMA weights it
    wrote."""
    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.cli.serve import Server, decode_coords
    from text2protein_tpu_torch.config import bench_l128_config
    from text2protein_tpu_torch.data.helix_records import CAPTIONS
    from text2protein_tpu_torch.ops import flash

    steps = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.reset_peak_memory_stats()
    flash.flash_attention_fwd.launches = 0
    flash.flash_attention_bwd.launches = 0
    res = train.main(["--data", str(records), "--max_steps", str(steps),
                      "--out", str(weights), "--workdir_root",
                      str(WORK / "training")])
    fwd = flash.flash_attention_fwd.launches
    bwd = flash.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    losses, secs, state = res["losses"], res["step_seconds"], res["state"]
    eval_loss = res["eval_loss"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    if not np.isfinite(eval_loss):
        raise AssertionError(f"eval loss {eval_loss}")
    if bwd != BWD_PER_TRAIN_STEP * steps:
        raise AssertionError(f"flash_bwd launched {bwd} times, expected "
                             f"{BWD_PER_TRAIN_STEP} x {steps}")
    # 18 + 12 (the rematted transformer blocks' recompute) per train step
    # and 18 per eval batch (the eval split is filled to one batch)
    per_step = FWD_PER_TRAIN_STEP + REMAT_FWD_PER_TRAIN_STEP
    if fwd != per_step * steps + FWD_PER_TRAIN_STEP:
        raise AssertionError(f"flash_fwd launched {fwd} times, expected "
                             f"{per_step} x {steps} + {FWD_PER_TRAIN_STEP}")
    lrs = res["lrs"]
    if lrs[0] != 0.0 or not lrs[1] > 0.0:
        raise AssertionError(f"learning rates {lrs[:3]}: the first update "
                             "must run at lr 0")
    config = bench_l128_config()
    if config.training.batch_size != TRAIN_BATCH:
        raise AssertionError("bench_l128_config() trains at batch "
                             f"{config.training.batch_size}")
    moved, ema_apart, n_params = moved_from_start(torch, config, state)
    timed = np.asarray(secs[TRAIN_WARMUP:]) * 1e3
    ms = float(np.median(timed))
    log(f"training: bench_l128 at batch {TRAIN_BATCH}, {steps} steps on "
        f"{res['records']} records: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (all finite), eval (EMA) {eval_loss:.4f}; "
        f"flash_bwd launches {bwd} (= {BWD_PER_TRAIN_STEP} x {steps}), "
        f"flash_fwd {fwd} (= {per_step} x {steps} + {FWD_PER_TRAIN_STEP} "
        f"eval); "
        f"lr {lrs[0]} then {lrs[1]:.1e}; {moved}/{n_params} "
        f"params moved from the JAX initializers' draw, {ema_apart} EMA "
        f"params apart from them")
    log(f"training: {ms:.2f} ms per train step (median of the last "
        f"{TRAIN_TIMED}, range {timed.min():.2f}-{timed.max():.2f}; first "
        f"{TRAIN_WARMUP}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs[:TRAIN_WARMUP])} ms), "
        f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    workdir = res["workdir"]
    del state, res

    server = Server(bench_l128_config(), batch_size=1, num_steps=STEPS,
                    weights=str(weights), device="cuda")
    flash.flash_attention_fwd.launches = 0
    reply = server.run_batch([{"caption": CAPTIONS[0], "length": 90}])
    cnn = decode_coords(reply[0])
    served = flash.flash_attention_fwd.launches
    if cnn.shape != (5, 128, 128) or not np.isfinite(cnn).all():
        raise AssertionError(f"bad map {cnn.shape} from the trained weights")
    if served != LAUNCHES_PER_STEP * STEPS:
        raise AssertionError(f"serving the trained weights launched "
                             f"flash_fwd {served} times")
    log(f"training: a Server loaded the EMA weights it wrote (strict) and "
        f"answered a request: finite (5, 128, 128) map, flash_fwd launches "
        f"{served}")
    weights.unlink()
    slots = sorted(str(p.relative_to(workdir))
                   for p in workdir.rglob("*.pt"))
    if slots != ["checkpoints-meta/checkpoint.pt",
                 "checkpoints/best_eval.pt", "checkpoints/best_train.pt"]:
        raise AssertionError(f"the training workdir holds {slots}")
    log(f"training: workdir {workdir.relative_to(ROOT)}: config.yml, "
        f"train_ids.txt, test_ids.txt, {', '.join(slots)}")
    return dict(steps=steps, losses=losses, step_seconds=secs,
                workdir=str(workdir),
                ms_per_step=ms, ms_per_step_range=[float(timed.min()),
                                                   float(timed.max())],
                samples_per_s=TRAIN_BATCH / ms * 1e3,
                eval_loss=eval_loss, peak_bytes=peak, lrs=lrs[:3],
                fwd_launches=fwd, bwd_launches=bwd)


DEPLOY_REQUESTS = [
    [{"caption": "A small alpha-helical bundle that binds zinc.",
      "length": 64, "seed": 2024},
     {"caption": "beta barrel membrane transporter", "length": 100},
     {"caption": "", "length": 128},
     {"caption": "three helix bundle", "length": 77}],
]


def phase_deploy(torch, workdir):
    """`cli/serve --config configs/deploy_l128.yml --checkpoint WORKDIR`
    answers a seeded batch of 4 over the full hybrid + CFG schedule."""
    from text2protein_tpu_torch.cli import serve
    from text2protein_tpu_torch.ops import flash

    t = time.perf_counter()
    server = serve.server_from_args(serve.build_parser().parse_args([
        "--config", str(DEPLOY_CONFIG), "--checkpoint", str(workdir),
        "--batch_size", str(DEPLOY_BATCH)]))
    log(f"deploy: Server from {DEPLOY_CONFIG.name} with the EMA of step "
        f"{server.step} of {workdir.relative_to(ROOT)} (best_eval), batch "
        f"{DEPLOY_BATCH}, built in {time.perf_counter() - t:.2f}s")
    want = DEPLOY_NFE * DEPLOY_LAUNCHES_PER_EVAL
    seconds, launches = [], 0
    for reqs in DEPLOY_REQUESTS:
        flash.flash_attention_fwd.launches = 0
        flash.flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = flash.flash_attention_fwd.launches
        launches += got
        nfes = sorted({r["nfe"] for r in results})
        if nfes != [DEPLOY_NFE]:
            raise AssertionError(f"deploy nfe {nfes}, expected {DEPLOY_NFE}")
        if got != want or flash.flash_attention_bwd.launches:
            raise AssertionError(
                f"deploy launches: flash_fwd {got} (expected {want}), "
                f"flash_bwd {flash.flash_attention_bwd.launches} (expected "
                f"0)")
        check_maps(results, reqs, 128)
        log(f"deploy: batch of {len(reqs)} in {seconds[-1]:.3f}s "
            f"({DEPLOY_BATCH * 60 / seconds[-1]:.3f} samples/min at batch "
            f"{DEPLOY_BATCH}), nfe {DEPLOY_NFE} in every response, "
            f"flash_fwd launches {got} (= {DEPLOY_NFE} x "
            f"{DEPLOY_LAUNCHES_PER_EVAL}), flash_bwd 0, maps finite "
            f"(5, 128, 128), last channel = length mask")
    return dict(step=server.step, batch_seconds=seconds,
                samples_per_min=[DEPLOY_BATCH * 60 / x for x in seconds],
                ms_per_eval=[x / DEPLOY_NFE * 1e3 for x in seconds],
                launches=launches)


def phase_sampling_cli(torch, workdir, records):
    """`cli/sampling_6d.main` on the deployment config and phase 6's
    best_eval: the PC sampler (10 steps, CFG 2.0) at the selected length
    100 over the held-out captions."""
    import pickle

    import numpy as np

    from text2protein_tpu_torch.cli import sampling_6d
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.ops import flash

    config = load_config(DEPLOY_CONFIG)
    index = 37
    length = config.data.min_res_num + index - 1
    flash.flash_attention_fwd.launches = 0
    t = time.perf_counter()
    out = sampling_6d.main([
        str(DEPLOY_CONFIG), str(workdir / "checkpoints" / "best_eval.pt"),
        "--sampler", "pc", "--num_steps", str(SAMPLING_STEPS),
        "--batch_size", str(DEPLOY_BATCH), "--select_length",
        "--length_index", str(index), "--processed_dir", str(records),
        "--workdir_root", str(WORK / "sampling")])["workdir"]
    secs = time.perf_counter() - t
    launches = flash.flash_attention_fwd.launches
    ids = (workdir / "test_ids.txt").read_text().split("\n")
    chunk = (ids * DEPLOY_BATCH)[:DEPLOY_BATCH]  # the first full batch
    got = sorted(p.name for p in out.glob("*.pkl"))
    if got != sorted({f"sampled_{i}.pkl" for i in chunk}):
        raise AssertionError(f"sampling CLI wrote {got} for ids {ids}")
    want = np.zeros((128, 128), np.float32)
    want[:length, :length] = 1.0
    for name in got:
        with open(out / name, "rb") as f:
            a = pickle.load(f)
        if (a.shape != (1, 5, 128, 128) or a.dtype != np.float32
                or not np.isfinite(a).all()
                or not np.array_equal(a[0, -1], want)):
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
    evals = SAMPLING_STEPS * 2 * 2  # corrector + predictor, CFG
    if launches != evals * DEPLOY_LAUNCHES_PER_EVAL:
        raise AssertionError(f"sampling CLI launched flash_fwd {launches} "
                             f"times, expected {evals} x 18")
    log(f"sampling CLI: {len(got)} pickles for {len(ids)} held-out ids "
        f"(first full batch of {DEPLOY_BATCH}), (1, 5, 128, 128) finite, "
        f"last channel = the length-{length} mask; flash_fwd launches "
        f"{launches}; {secs:.2f}s with the restore")
    return dict(pickles=got, launches=launches, seconds=secs,
                out_dir=str(out))


def phase_hybrid_reference(torch, e2e):
    """A short hybrid under CFG 2.0 at B=1 and the deployment widths,
    seeded random weights and injected draws: the card (kernels) against
    the CPU (plain versions). Tolerance: each guided score is 2 s_c - s_n,
    within 3x phase 5's per-evaluation agreement; the differences of the
    evaluations add up along the trajectory, and a factor 10 covers the
    Langevin step size's ratio of norms, taken from the scores."""
    import copy

    import numpy as np

    from text2protein_tpu_torch.conditioning import length_mask
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.diffusion.ode import get_hybrid_sampler
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    config = load_config(DEPLOY_CONFIG)
    ode_steps, pc_steps = HYBRID_REF_STEPS
    sde, eps = get_sde(config)
    gpu_model = init_random_weights(build_model(config, device="cuda"), 3)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    shape = (1, 128, 128, 5)
    rng = np.random.default_rng(4)
    draws = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(1 + 2 * pc_steps)]
    ctx, ctx_mask = build_text_encoder(config).encode(
        ["A small alpha-helical bundle that binds zinc."])
    cond = length_mask(torch.tensor([100]), 128)
    outs, nfes, secs = [], [], []
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        it = iter(draws)
        sampler = get_hybrid_sampler(
            sde, model, shape, ode_steps=ode_steps, pc_steps=pc_steps,
            cfg_scale=float(config.sampling.cfg_scale), eps=eps)
        before = flash.flash_attention_fwd.launches
        t = time.perf_counter()
        out, nfe = sampler(
            condition={"length": cond.to(dev)},
            context=torch.from_numpy(ctx).to(dev),
            context_mask=torch.from_numpy(ctx_mask).to(dev),
            noise_fn=lambda s: torch.from_numpy(next(it)).to(dev))
        outs.append(out.cpu().numpy())
        secs.append(time.perf_counter() - t)
        nfes.append((nfe, flash.flash_attention_fwd.launches - before))
    (nfe, launched), (_, cpu_launched) = nfes
    if launched != nfe * DEPLOY_LAUNCHES_PER_EVAL or cpu_launched:
        raise AssertionError(f"hybrid reference launches GPU {launched}, "
                             f"CPU {cpu_launched}")
    gpu, cpu = outs
    diff = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    tol = 10 * 3 * nfe // 2 * e2e
    log(f"hybrid reference: {ode_steps} Heun + {pc_steps} PC steps, CFG "
        f"{config.sampling.cfg_scale}, B=1, deployment widths, GPU vs CPU "
        f"rel max diff {diff:.2e} (tol 10 x 3 x {nfe // 2} evaluations x "
        f"phase 5's {e2e:.2e} = {tol:.2e}); NFE {nfe}, GPU launches "
        f"{launched}; GPU {secs[0]:.2f}s, CPU {secs[1]:.2f}s")
    if not (np.isfinite(gpu).all() and diff <= tol):
        raise AssertionError("the GPU hybrid disagrees (line above)")
    return dict(rel_diff=diff, tol=tol, nfe=nfe)


def phase_hybrid_n256(torch):
    """A Server with quality_n256.yml and the hybrid sampler (4 Heun + 6 PC
    steps), seeded random weights, batch 4: the bf16 forward serves it."""
    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.ops import flash

    config = quality_n256_config()
    config.sampling.hybrid_ode_steps, config.sampling.hybrid_pc_steps = (
        N256_HYBRID)
    server = Server(config, batch_size=N256_BATCH, device="cuda",
                    weight_seed=0, sampler="hybrid")
    reqs = N256_REQUESTS[0]
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = server.run_batch(reqs)
    secs = time.perf_counter() - t
    got = flash.flash_attention_fwd.launches_bf16
    others = sum(c.launches for c in counters) + \
        flash.flash_attention_bwd.launches_bf16
    want = N256_HYBRID_NFE * N256_LAUNCHES_PER_STEP // 2
    nfes = sorted({r["nfe"] for r in results})
    if nfes != [N256_HYBRID_NFE] or got != want or others:
        raise AssertionError(f"N=256 hybrid: nfe {nfes}, bf16 forward "
                             f"launches {got} (expected {want}), others "
                             f"{others}")
    check_maps(results, reqs, 256)
    log(f"hybrid N=256: quality_n256.yml, {N256_HYBRID[0]} Heun + "
        f"{N256_HYBRID[1]} PC steps at batch {N256_BATCH}: nfe "
        f"{N256_HYBRID_NFE}, flash_fwd_bf16 launches {got} (= "
        f"{N256_HYBRID_NFE} x {N256_LAUNCHES_PER_STEP // 2}), maps finite "
        f"(5, 256, 256), last channel = length mask; {secs:.2f}s (the "
        f"first batch of this Server)")
    del server
    torch.cuda.empty_cache()
    return dict(launches=got, seconds=secs, nfe=N256_HYBRID_NFE)


def worst_grad_diff(got, want):
    """(max over tensors of max|got - want| / max|want|, its name), each
    scale floored at 1e-3 of the largest gradient of `want`."""
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    worst, key = 0.0, None
    for k, w in want.items():
        if not bool(got[k].isfinite().all()):
            raise AssertionError(f"non-finite gradient {k}")
        d = ((got[k] - w).abs().max() / max(w.abs().max().item(),
                                            floor)).item()
        if d >= worst:
            worst, key = d, k
    return worst, key


def train_step_card_vs_cpu(torch, config, records, index, seed=1,
                           score=False):
    """One train step of `config` at B=1 (record `index`, dropout 0,
    injected t and z from one seed, random weights from `seed`): on the
    GPU (kernels), on the GPU with the attention backward through its
    plain version, and on the CPU (plain versions). Returns the losses,
    the gradients' worst diffs (each over its own scale, floored) and the
    GPU's backward launches; with `score`, first one score evaluation of
    the same models on a random map at label 1000 (its relative max diff
    and the GPU's forward launches)."""
    import copy

    import numpy as np

    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    config.model.dropout = 0.0
    n, c = config.data.max_res_num, config.data.num_channels
    sde, _ = get_sde(config)
    gpu_model = init_random_weights(build_model(config, device="cuda"), seed)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    rec = ProteinProcessedDataset(records)[index]
    host = make_batch([rec], n)
    ctx, ctx_mask = build_text_encoder(config).encode(host["caption"])
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.uniform(0.05, 1.0, 1).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, n, n, c))
                         .astype(np.float32))
    kernel_bwd = flash.flash_attention_bwd
    out = {}
    if score:
        x = torch.from_numpy((rng.standard_normal((1, n, n, c)) * 10)
                             .astype(np.float32))
        labels = torch.tensor([1000.0])
        args = (labels, torch.from_numpy(ctx), torch.from_numpy(ctx_mask))
        before = flash.flash_attention_fwd.launches
        with torch.inference_mode():
            gpu = gpu_model(x.cuda(), *(a.cuda() for a in args)).cpu()
            out["score_launches"] = flash.flash_attention_fwd.launches - (
                before)
            t0 = time.perf_counter()
            cpu = cpu_model(x, *args)
            out["score_cpu_seconds"] = time.perf_counter() - t0
        out["score_rel_diff"] = ((gpu - cpu).abs().max()
                                 / cpu.abs().max()).item()

    def step(model, dev):
        batch = batch_to_device_arrays(host, config, device=dev)
        batch["context"] = torch.from_numpy(ctx).to(dev)
        batch["context_mask"] = torch.from_numpy(ctx_mask).to(dev)
        loss_fn = get_sde_loss_fn(sde, model, train=True,
                                  condition=tuple(config.model.condition))
        model.zero_grad(set_to_none=True)
        before = kernel_bwd.launches
        loss = loss_fn(None, batch, t=t.to(dev), z=z.to(dev))
        loss.backward()
        launched = kernel_bwd.launches - before
        return loss.item(), {k: p.grad.detach().cpu() for k, p in
                             model.named_parameters()}, launched

    g_loss, g_grads, g_launch = step(gpu_model, "cuda")
    flash.flash_attention_bwd = flash.flash_attention_bwd_reference
    try:
        _, p_grads, _ = step(gpu_model, "cuda")
    finally:
        flash.flash_attention_bwd = kernel_bwd
    del gpu_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c_loss, c_grads, c_launch = step(cpu_model, "cpu")
    worst, worst_key = worst_grad_diff(g_grads, c_grads)
    plain_worst, plain_key = worst_grad_diff(p_grads, c_grads)
    kernel_worst, kernel_key = worst_grad_diff(g_grads, p_grads)
    return dict(out, loss_gpu=g_loss, loss_cpu=c_loss,
                loss_rel_diff=abs(g_loss - c_loss) / abs(c_loss),
                worst_grad=worst_key, worst_grad_rel_diff=worst,
                plain_bwd_worst_grad=plain_key,
                plain_bwd_worst_grad_rel_diff=plain_worst,
                kernel_vs_plain_bwd_worst=kernel_worst,
                kernel_vs_plain_bwd_worst_grad=kernel_key,
                n_grads=len(c_grads), gpu_bwd_launches=g_launch,
                cpu_bwd_launches=c_launch, caption_tokens=ctx.shape[1],
                cpu_seconds=time.perf_counter() - t0)


def check_train_reference(what, r, bwd_per_step):
    """Logs a `train_step_card_vs_cpu` result and holds it to the bars
    (loss 1e-4, gradients 5e-3 of scale, kernels vs plain backward on the
    card 1e-3, `bwd_per_step` backward launches on the card, none on the
    CPU)."""
    log(f"{what}: GPU (kernels) vs CPU: loss {r['loss_gpu']:.6f} vs "
        f"{r['loss_cpu']:.6f} (rel {r['loss_rel_diff']:.2e}, tol "
        f"{TRAIN_LOSS_TOL:.0e}); worst of {r['n_grads']} gradients "
        f"{r['worst_grad']} {r['worst_grad_rel_diff']:.2e} (tol "
        f"{TRAIN_GRAD_TOL:.0e}; with the attention backward on its plain "
        f"version {r['plain_bwd_worst_grad_rel_diff']:.2e} at "
        f"{r['plain_bwd_worst_grad']}); GPU kernels vs GPU plain attention "
        f"backward: worst {r['kernel_vs_plain_bwd_worst_grad']} "
        f"{r['kernel_vs_plain_bwd_worst']:.2e} (tol "
        f"{TRAIN_KERNEL_TOL:.0e}); GPU backward launches "
        f"{r['gpu_bwd_launches']}; caption {r['caption_tokens']} keys; CPU "
        f"step {r['cpu_seconds']:.1f}s")
    if (r["gpu_bwd_launches"], r["cpu_bwd_launches"]) != (bwd_per_step, 0):
        raise AssertionError(f"backward launches GPU {r['gpu_bwd_launches']}"
                             f", CPU {r['cpu_bwd_launches']}; expected "
                             f"{bwd_per_step}, 0")
    if not (r["loss_rel_diff"] < TRAIN_LOSS_TOL
            and r["worst_grad_rel_diff"] < TRAIN_GRAD_TOL
            and r["kernel_vs_plain_bwd_worst"] < TRAIN_KERNEL_TOL):
        raise AssertionError("the GPU train step disagrees (line above)")


def phase_train_reference(torch, records):
    """One flagship train step at B=1, dropout 0 and injected t, z, from the
    same weights: on the GPU (kernels) against the CPU (plain versions),
    and on the GPU against itself with the attention backward through its
    plain version: the loss and every gradient."""
    from text2protein_tpu_torch.config import bench_l128_config

    r = train_step_card_vs_cpu(torch, bench_l128_config(), records, 3)
    check_train_reference("train reference: flagship train step at B=1", r,
                          BWD_PER_TRAIN_STEP)
    return r


def bf16_step(scale):
    """One bf16 rounding step (ulp) at the magnitude `scale`."""
    import math

    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def bf16_bound(nbytes, flops):
    """(least ms, what bounds it) at the H100's HBM and bf16 tensor-core
    rates."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def register_report(ptxas, kind):
    """{instantiation: registers / spills} of the bf16 kernels of `kind`:
    the wgmma kernels and the mma.sync ones of D > 512."""
    return {k: (r.get("registers"), r.get("spill_stores"),
                r.get("spill_loads"))
            for k, r in ptxas.items()
            if f"flash_{kind}" in k and ("_bf16" in k or "wgmma" in k)}


def bf16_mma_flops(kind, b, h, tq, tk, d, plan):
    """The mma work (FLOPs) the bf16 wgmma kernels issue for one call, from
    their launch plan: blocks of `rows` rows and inner tiles of `tile` rows
    (ragged ends padded), S and dP over D rounded to 16 once per column
    chunk, the products with P and dS (split in two) over D's boxes (of
    the plan's `box` columns, 64 where it names none)."""
    def up(x, m):
        return -(-x // m) * m

    box = plan.get("box") or plan.get("dq_box") or 64
    d16, dbox = up(d, 16), up(d, box)
    if kind == "fwd":
        return 2 * b * h * up(tq, plan["rows"]) * up(tk, plan["tile"]) * (
            d16 * plan["chunks"] + 2 * dbox)
    dq = 2 * b * h * up(tq, plan["dq_rows"]) * up(tk, plan["dq_tile"]) * (
        2 * d16 * plan["dq_chunks"] + 2 * dbox)
    dkdv = (2 * b * h * up(tk, plan["dkdv_rows"])
            * up(tq, plan["dkdv_tile"])
            * (2 * d16 * plan["dkdv_chunks"] + 4 * dbox))
    return dq + dkdv


def bf16_route(kind, name, d, plan):
    """The route of a bf16 call from its launch plan: every forward and
    every backward up to D = 512 on the wgmma kernels (a forward above
    D = 512 on a cluster of two blocks), the backward above on mma.sync;
    fails on any other."""
    if kind == "fwd":
        want = {"wgmma": 1, "cluster": 2 if d > 512 else 1}
    else:
        w = int(d <= 512)
        want = {"dq_wgmma": w, "dkdv_wgmma": w}
    got = {k: plan[k] for k in want}
    if got != want:
        raise AssertionError(f"bf16 {kind} {name}: D={d} plan {plan}, "
                             f"expected {want}")
    if kind == "bwd" and d > 512:
        return "mma.sync"
    return "wgmma" + (" cluster 2" if kind == "fwd" and d > 512 else "")


N256_BF16_RUNS = (("fwd", N256_SHAPES, N256_BATCH),
                  ("bwd", N256_BWD_SHAPES, N256_TRAIN_BATCH))


def phase_kernels_bf16(torch, ptxas, runs=N256_BF16_RUNS, seed=3):
    """The bf16 kernels at every shape of a path, by default N=256's: the
    forward at B=4 (the serving batch), the backward at B=8 (the training
    batch) on the forward kernel's residuals, with a fully masked batch
    row where the call is masked. Each against its plain version, with the
    times of phase 3 and the bf16 bounds."""
    import torch.nn.functional as F

    from text2protein_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    fwd_rows, bwd_rows = [], []
    for kind, shapes, b in runs:
        for name, h, tq, tk, d, masked, per_step in shapes:
            q, k, v, g = (torch.randn((b, h, t, d), device=dev,
                                      generator=gen).bfloat16()
                          for t in (tq, tk, tk, tq))
            mask = None
            if masked:
                lengths = torch.tensor([3, 9, tk] + [tk] * (b - 4) + [0],
                                       device=dev)[:b]
                mask = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
            scale = d**-0.5
            out, lse = flash.flash_attention_fwd(q, k, v, scale, mask)
            plan = flash.launch_plan(kind, b, h, tq, tk, d, torch.bfloat16)
            route = bf16_route(kind, name, d, plan)
            attn_mask = None if mask is None else mask[:, None, None, :]
            if kind == "fwd":
                torch.cuda.synchronize()
                ref, ref_lse = flash.flash_attention_fwd_reference(
                    q, k, v, scale, mask)
                err = (out.float() - ref.float()).abs().max().item()
                tol = bf16_step(ref.float().abs().max().item())
                # a fully masked row's lse is -1e30 in both, exactly
                live = ref_lse > -1e29
                lerr = (lse - ref_lse)[live].abs().max().item()
                ltol = LSE_TOL * max(1.0, ref_lse[live].abs().max().item())
                ok = (err <= tol and lerr <= ltol
                      and torch.equal(lse[~live], ref_lse[~live])
                      and bool(torch.isfinite(out).all()))
                what = f"lse err {lerr:.2e} (tol {ltol:.1e})"

                def call():
                    return flash.flash_attention_fwd(q, k, v, scale, mask)

                def plain():
                    return flash.flash_attention_fwd_reference(
                        q, k, v, scale, mask)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=attn_mask, scale=scale)

                library_ms = cuda_ms(torch, sdpa)
                library_device = graph_us(torch, sdpa)
                nbytes = (2 * (2 * q.numel() + k.numel() + v.numel())
                          + 4 * b * h * tq + (b * tk if masked else 0))
                flops = 4 * b * h * tq * tk * d
            else:
                if not flash.supports_bwd_cuda(q, k, v, masked):
                    raise AssertionError(f"{name}: the gate refuses it")
                got = flash.flash_attention_bwd(q, k, v, out, lse, g, scale,
                                                mask)
                torch.cuda.synchronize()
                want = flash.flash_attention_bwd_reference(
                    q, k, v, out, lse, g, scale, mask)
                errs = [((x.float() - w.float()).abs().max().item(),
                         bf16_step(w.float().abs().max().item()))
                        for x, w in zip(got, want)]
                err = max(e for e, _ in errs)
                tol = min(t for _, t in errs)
                ok = (all(e <= t for e, t in errs)
                      and all(bool(torch.isfinite(x).all()) for x in got))
                what = ("dq/dk/dv err " + ", ".join(
                    f"{e:.2e} (tol {t:.1e})" for e, t in errs))

                def call():
                    return flash.flash_attention_bwd(q, k, v, out, lse, g,
                                                     scale, mask)

                def plain():
                    return flash.flash_attention_bwd_reference(
                        q, k, v, out, lse, g, scale, mask)

                xs = [t.detach().requires_grad_() for t in (q, k, v)]

                def sdpa():
                    with torch.enable_grad():
                        return F.scaled_dot_product_attention(
                            *xs, attn_mask=attn_mask, scale=scale)

                def sdpa_both():
                    return torch.autograd.grad(sdpa(), xs, g)

                library_ms = cuda_ms(torch, sdpa_both) - cuda_ms(torch, sdpa)
                library_device = (graph_us(torch, sdpa_both)
                                  - graph_us(torch, lambda: sdpa().detach()))
                nbytes = (2 * (2 * (q.numel() + k.numel() + v.numel())
                               + out.numel() + g.numel()) + 4 * b * h * tq
                          + (b * tk if masked else 0))
                flops = 10 * b * h * tq * tk * d
            if not ok:
                raise AssertionError(f"bf16 {kind} {name}: kernel vs plain "
                                     f"{what}")
            kernel_ms = cuda_ms(torch, call)
            host = host_us(call)
            device = graph_us(torch, call)
            plain_ms = cuda_ms(torch, plain)
            bound_ms, bound_by = bf16_bound(nbytes, flops)
            mma = bf16_mma_flops(kind, b, h, tq, tk, d, plan)
            mma_ms = max(nbytes / PEAK_BYTES_S, mma / PEAK_BF16_S) * 1e3
            row = dict(shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                       masked=masked, per_step=per_step, max_abs_err=err,
                       tol=tol, ms=kernel_ms, host_us=host,
                       device_ms=device / 1e3, plain_ms=plain_ms,
                       library_ms=library_ms,
                       library_device_ms=library_device / 1e3, bytes=nbytes,
                       flops=flops, mma_flops=mma, bound_ms=bound_ms,
                       bound_by=bound_by, tc_bound_ms=mma_ms, route=route,
                       plan=plan)
            (fwd_rows if kind == "fwd" else bwd_rows).append(row)
            log(f"kernel flash_{kind}_bf16 {name} B={b} H={h} Tq={tq} "
                f"Tk={tk} D={d} mask={masked}"
                f"{' +dead row' if masked else ''}: max_abs_err {err:.2e} "
                f"({what}) ms {kernel_ms:.4f} host_us {host:.1f} device_us "
                f"{device:.1f} plain_ms {plain_ms:.4f} library_ms(sdpa"
                f"{' bwd' if kind == 'bwd' else ''} bf16) {library_ms:.4f} "
                f"library_device_us {library_device:.1f} "
                f"bound_ms {bound_ms:.5f} ({bound_by}) mma_bound_ms "
                f"{mma_ms:.5f} route {route} plan {plan}")
        log(f"kernels bf16 {kind}: ptxas registers/spill stores/spill loads "
            f"{register_report(ptxas, kind)}")
    return fwd_rows, bwd_rows


N256_REQUESTS = [
    [{"caption": "A small alpha-helical bundle that binds zinc.",
      "length": 128},
     {"caption": "beta barrel membrane transporter", "length": 200},
     {"caption": "", "length": 256},
     {"caption": "three helix bundle", "length": 171}],
    [{"caption": "Kinase domain with a long activation loop.",
      "length": 233, "seed": 4321}],
]


def phase_serving_n256(torch):
    """A Server with quality_n256.yml's widths, bf16, seeded random
    weights, batch 4, N256_STEPS PC steps, two batches of requests."""
    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.ops import flash

    t = time.perf_counter()
    server = Server(quality_n256_config(), batch_size=N256_BATCH,
                    num_steps=N256_STEPS, device="cuda", weight_seed=0)
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serving N=256: Server ({n_params} params, {server.model.dtype}, "
        f"batch {N256_BATCH}, {N256_STEPS} PC steps) built in "
        f"{time.perf_counter() - t:.2f}s")
    seconds, launches = [], 0
    for reqs in N256_REQUESTS:
        counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)
        for c in counters:
            c.launches = c.launches_bf16 = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = flash.flash_attention_fwd.launches_bf16
        launches += got
        if got != N256_LAUNCHES_PER_STEP * N256_STEPS:
            raise AssertionError(f"flash_fwd_bf16 launched {got} times in a "
                                 f"batch, expected {N256_LAUNCHES_PER_STEP} "
                                 f"x {N256_STEPS}")
        others = (flash.flash_attention_fwd.launches
                  + flash.flash_attention_bwd.launches
                  + flash.flash_attention_bwd.launches_bf16)
        if others:
            raise AssertionError(f"serving N=256 launched {others} f32 or "
                                 "backward kernels")
        check_maps(results, reqs, 256)
        log(f"serving N=256: batch of {len(reqs)} request(s) in "
            f"{seconds[-1]:.3f}s, flash_fwd_bf16 launches {got} (= "
            f"{N256_LAUNCHES_PER_STEP} x {N256_STEPS} steps), maps finite "
            f"(5, 256, 256), last channel = length mask")
    s_per_step = min(seconds[1:] or seconds) / N256_STEPS
    log(f"serving N=256: {s_per_step * 1e3:.2f} ms per PC step at batch "
        f"{N256_BATCH} (the second batch; the first includes cuDNN's "
        f"search: {seconds[0]:.2f}s); "
        f"{N256_BATCH * 60 / (s_per_step * 2000):.3f} samples/min at the "
        f"full 2000 steps")
    return server, launches, dict(batch_seconds=seconds,
                                  ms_per_pc_step=s_per_step * 1e3,
                                  samples_per_min_2000=N256_BATCH * 60
                                  / (s_per_step * 2000))


def rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_reference_n256(torch, server):
    """One score evaluation at B=1 in bf16: the GPU (kernels) against the
    CPU in bf16 (plain versions) and in f32 (the same weights). Bar: the
    GPU may differ from the CPU in bf16 by no more than bf16 differs from
    f32 (sums in another order flip bf16 roundings, and a flip spreads
    through the ~100 layers as a difference of the size of bf16's own
    rounding). The kernels' share: the same GPU evaluation with the
    attention through its plain version."""
    import copy

    import numpy as np

    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.models.unet import build_model
    from text2protein_tpu_torch.ops import flash

    model = server.model
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        (rng.standard_normal((1, 256, 256, 5)) * 10).astype(np.float32))
    labels = torch.tensor([1000.0])
    ctx_np, mask_np = server.encoder.encode(
        ["A small alpha-helical bundle that binds zinc."])
    ctx, mask = torch.from_numpy(ctx_np), torch.from_numpy(mask_np)
    args = (x.cuda(), labels.cuda(), ctx.cuda(), mask.cuda())
    kernel_fwd = flash.flash_attention_fwd
    before = kernel_fwd.launches_bf16
    with torch.inference_mode():
        gpu = model(*args).cpu()
        if kernel_fwd.launches_bf16 - before != N256_LAUNCHES_PER_STEP // 2:
            raise AssertionError("the GPU score evaluation did not launch "
                                 "the bf16 forward 48 times")
        flash.flash_attention_fwd = flash.flash_attention_fwd_reference
        try:
            gpu_plain = model(*args).cpu()
        finally:
            flash.flash_attention_fwd = kernel_fwd
    t = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    cfg = quality_n256_config()
    cfg.model.dtype = "float32"
    f32_model = build_model(cfg, device="cpu")
    f32_model.load_state_dict(cpu_model.state_dict())
    with torch.inference_mode():
        cpu = cpu_model(x, labels, ctx, mask)
        cpu_f32 = f32_model(x, labels, ctx, mask)
    cpu_s = time.perf_counter() - t
    del cpu_model, f32_model
    for name, out in (("gpu", gpu), ("gpu_plain", gpu_plain), ("cpu", cpu),
                      ("cpu_f32", cpu_f32)):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite N=256 score on {name}")
    diff = rel_max(gpu, cpu)
    bf16_gap = rel_max(cpu, cpu_f32)
    kernel_share = rel_max(gpu, gpu_plain)
    log(f"reference N=256: bf16 score, GPU vs CPU rel max diff {diff:.2e} "
        f"(tol: the CPU's bf16 vs f32, {bf16_gap:.2e}); GPU kernels vs GPU "
        f"plain attention {kernel_share:.2e}; GPU vs CPU f32 "
        f"{rel_max(gpu, cpu_f32):.2e} (CPU part {cpu_s:.1f}s)")
    if not (diff <= bf16_gap and kernel_share <= bf16_gap):
        raise AssertionError("the N=256 GPU score disagrees (line above)")
    return dict(gpu_vs_cpu=diff, cpu_bf16_vs_f32=bf16_gap,
                kernels_vs_plain=kernel_share)


def phase_training_n256(torch, records):
    """cli/train.main on configs/quality_n256.yml as written, then one step
    at batch N256_MEM_BATCH with and without remat for the peak memory."""
    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.ops import flash

    steps = N256_WARMUP + N256_TIMED
    config = quality_n256_config()
    if config.training.batch_size != N256_TRAIN_BATCH:
        raise AssertionError("quality_n256.yml trains at batch "
                             f"{config.training.batch_size}")
    torch.cuda.reset_peak_memory_stats()
    for c in (flash.flash_attention_fwd, flash.flash_attention_bwd):
        c.launches = c.launches_bf16 = 0
    res = train.main(["--config", str(ROOT / "configs/quality_n256.yml"),
                      "--data", str(records), "--max_steps", str(steps),
                      "--workdir_root", str(WORK / "training_n256")])
    shutil.rmtree(res["workdir"])  # two 6 GB slots
    fwd = flash.flash_attention_fwd.launches_bf16
    bwd = flash.flash_attention_bwd.launches_bf16
    f32 = (flash.flash_attention_fwd.launches
           + flash.flash_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    losses, secs, state = res["losses"], res["step_seconds"], res["state"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"N=256 train losses {losses}")
    if not np.isfinite(res["eval_loss"]):
        raise AssertionError(f"N=256 eval loss {res['eval_loss']}")
    per_step = N256_FWD_PER_TRAIN_STEP + N256_REMAT_FWD_PER_TRAIN_STEP
    want_fwd = per_step * steps + N256_FWD_PER_TRAIN_STEP  # + the eval batch
    if (fwd, bwd, f32) != (want_fwd, N256_BWD_PER_TRAIN_STEP * steps, 0):
        raise AssertionError(
            f"N=256 launches: fwd_bf16 {fwd} (expected {want_fwd}), "
            f"bwd_bf16 {bwd} (expected {N256_BWD_PER_TRAIN_STEP * steps}), "
            f"f32 {f32} (expected 0)")
    moved, ema_apart, n_params = moved_from_start(torch, config, state)
    timed = np.asarray(secs[N256_WARMUP:]) * 1e3
    ms = float(np.median(timed))
    log(f"training N=256: quality_n256.yml (bf16, remat, featurize on "
        f"device) at batch {N256_TRAIN_BATCH}, {steps} steps on "
        f"{res['records']} records: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (all finite), eval (EMA) {res['eval_loss']:.4f}; "
        f"flash_fwd_bf16 launches {fwd} (= {per_step} x {steps} + "
        f"{N256_FWD_PER_TRAIN_STEP} eval), flash_bwd_bf16 {bwd} (= "
        f"{N256_BWD_PER_TRAIN_STEP} x {steps}), f32 kernels 0; "
        f"{moved}/{n_params} params moved, {ema_apart} EMA params apart")
    log(f"training N=256: {ms:.2f} ms per train step (median of the last "
        f"{N256_TIMED}, range {timed.min():.2f}-{timed.max():.2f}; first "
        f"{N256_WARMUP}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs[:N256_WARMUP])} ms), "
        f"{N256_TRAIN_BATCH / ms * 1e3:.2f} samples/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    out = dict(steps=steps, losses=losses, step_seconds=secs,
               ms_per_step=ms, ms_per_step_range=[float(timed.min()),
                                                  float(timed.max())],
               samples_per_s=N256_TRAIN_BATCH / ms * 1e3,
               eval_loss=res["eval_loss"], peak_bytes=peak,
               fwd_launches=fwd, bwd_launches=bwd)
    del state, res
    torch.cuda.empty_cache()
    out["remat_peak_bytes"] = remat_peak_memory(torch, records)
    return out


def _n256_batch(torch, records, b, config):
    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.text.encoder import build_text_encoder
    from text2protein_tpu_torch.training.steps import featurize

    ds = ProteinProcessedDataset(records)
    host = make_batch([ds[i] for i in range(b)], config.data.max_res_num)
    batch = batch_to_device_arrays(host, config, device="cuda")
    ctx, ctx_mask = build_text_encoder(config).encode(host["caption"])
    batch["context"] = torch.from_numpy(ctx).cuda()
    batch["context_mask"] = torch.from_numpy(ctx_mask).cuda()
    return featurize(config, batch)


def _set_remat(model, on):
    from text2protein_tpu_torch.models.attention import SpatialTransformer

    model.remat_resblocks = on
    for m in model.modules():
        if isinstance(m, SpatialTransformer):
            m.remat = on


def remat_peak_memory(torch, records):
    """Peak device memory of one train step (loss, backward, clip + Adam,
    EMA) at batch N256_MEM_BATCH, with remat (the yml's) and without (the
    residual and transformer blocks keep their activations)."""
    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.training.state import create_train_state
    from text2protein_tpu_torch.training.steps import make_train_step

    config = quality_n256_config()
    model = init_random_weights(build_model(config, device="cuda"), 0)
    sde, _ = get_sde(config)
    state = create_train_state(config, model)
    step = make_train_step(config, sde, model)
    batch = _n256_batch(torch, records, N256_MEM_BATCH, config)
    out = {}
    for remat in (True, False):
        _set_remat(model, remat)
        step(state, batch, 0)  # warm: cuDNN's search and the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch, 0)
        torch.cuda.synchronize()
        out["remat" if remat else "no_remat"] = (
            torch.cuda.max_memory_allocated(), base)
    (rp, rb), (np_, nb) = out["remat"], out["no_remat"]
    log(f"training N=256: one train step at batch {N256_MEM_BATCH}: peak "
        f"{rp / 2**30:.2f} GiB with remat, {np_ / 2**30:.2f} GiB without "
        f"(weights, Adam and EMA state {rb / 2**30:.2f} GiB of it); "
        f"activations {(rp - rb) / 2**30:.2f} vs {(np_ - nb) / 2**30:.2f} "
        f"GiB, x{(np_ - nb) / max(rp - rb, 1):.2f}")
    del state, model, step
    torch.cuda.empty_cache()
    return dict(remat=rp, no_remat=np_, state_bytes=rb)


def phase_train_reference_n256(torch, records):
    """One train step's loss and gradients at B=1 on the card, dropout 0.1
    (the same generator seed), injected t and z: bf16 with remat against
    bf16 without (each gradient within REMAT_TOL of its scale), and bf16
    with the kernels against bf16 with the plain attention backward, beside
    bf16 against f32 (the flattened gradient's max |diff| over max |f32
    gradient|): the kernels' share must stay within half of bf16's own.

    The remat and kernel comparisons run with cuDNN off (the convolutions
    on PyTorch's own im2col + GEMM path): cuDNN chooses its algorithms
    within the largest free block of the caching allocator, so two steps
    that hold different activations (remat's purpose) can get different
    algorithms and round bf16 differently; seen on an H100 as 1e-2 of a
    gradient's scale between remat and no remat in some processes, and 0
    between two runs of the same step."""
    import numpy as np

    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash

    config = quality_n256_config()
    sde, _ = get_sde(config)
    model = init_random_weights(build_model(config, device="cuda"), 1)
    cfg32 = quality_n256_config()
    cfg32.model.dtype = "float32"
    model32 = build_model(cfg32, device="cuda")
    model32.load_state_dict(model.state_dict())
    batch = _n256_batch(torch, records, 1, config)
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.uniform(0.05, 1.0, 1).astype(np.float32)).cuda()
    z = torch.from_numpy(rng.standard_normal((1, 256, 256, 5))
                         .astype(np.float32)).cuda()
    kernel_bwd = flash.flash_attention_bwd

    def grads(m):
        loss_fn = get_sde_loss_fn(sde, m, train=True,
                                  condition=tuple(config.model.condition))
        m.zero_grad(set_to_none=True)
        before = kernel_bwd.launches_bf16
        gen = torch.Generator(device="cuda").manual_seed(11)
        loss = loss_fn(None, batch, gen, t=t, z=z)
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in
                             m.named_parameters()}, \
            kernel_bwd.launches_bf16 - before

    with torch.backends.cudnn.flags(enabled=False):
        l_r, g_r, n_r = grads(model)
        _set_remat(model, False)
        l_n, g_n, _ = grads(model)
        _set_remat(model, True)
        flash.flash_attention_bwd = flash.flash_attention_bwd_reference
        try:
            _, g_p, _ = grads(model)
        finally:
            flash.flash_attention_bwd = kernel_bwd
    # bf16 against f32, both as the trainer runs them (cuDNN on)
    _, g_b, _ = grads(model)
    l_f, g_f, _ = grads(model32)
    if n_r != N256_BWD_PER_TRAIN_STEP:
        raise AssertionError(f"bf16 backward launches {n_r}, expected "
                             f"{N256_BWD_PER_TRAIN_STEP}")
    remat_worst, remat_key = worst_grad_diff(g_r, g_n)
    keys = sorted(g_f)

    def flat(g):
        return torch.cat([g[k].float().flatten() for k in keys])

    vr, vp, vb, vf = flat(g_r), flat(g_p), flat(g_b), flat(g_f)
    scale = vf.abs().max().item()
    kernel_gap = (vr - vp).abs().max().item() / scale
    bf16_gap = (vb - vf).abs().max().item() / scale
    log(f"train reference N=256: bf16 step at B=1, dropout 0.1: loss remat "
        f"{l_r:.6f}, no remat {l_n:.6f}, f32 {l_f:.6f}; remat vs no remat "
        f"worst gradient {remat_key} {remat_worst:.2e} (tol "
        f"{REMAT_TOL:.0e}, cuDNN off); kernels vs plain attention "
        f"backward {kernel_gap:.2e} of the gradient's scale (tol: half of "
        f"bf16 vs f32, {bf16_gap:.2e}); bf16 backward launches {n_r}")
    if not (l_r == l_n and remat_worst <= REMAT_TOL
            and kernel_gap <= 0.5 * bf16_gap):
        raise AssertionError("the N=256 train reference disagrees (line "
                             "above)")
    del model, model32
    torch.cuda.empty_cache()
    return dict(loss_remat=l_r, loss_no_remat=l_n, loss_f32=l_f,
                remat_worst=remat_worst, remat_worst_grad=remat_key,
                kernels_vs_plain_bwd=kernel_gap, bf16_vs_f32=bf16_gap)


def phase_training_ss(torch, records):
    """cli/train.main on configs/quality_ss.yml as written (C=8 on the
    device, length + ss + inpainting, batch 16) from the JAX initializers;
    first the f32 forward at the step's masked 16-key shapes, batch 16."""
    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.config import quality_ss_config
    from text2protein_tpu_torch.ops import flash

    config = quality_ss_config()
    if (config.training.batch_size, config.data.num_channels) != (SS_BATCH,
                                                                  8):
        raise AssertionError("quality_ss.yml trains C=8 at batch "
                             f"{config.training.batch_size}")
    rows = phase_kernels(torch, [s for s in SS_TRAIN_SHAPES if s[5]],
                         lengths=(0, 3, 9), b=SS_BATCH)
    steps = SS_WARMUP + SS_TIMED
    torch.cuda.reset_peak_memory_stats()
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    res = train.main(["--config", str(SS_CONFIG), "--data", str(records),
                      "--max_steps", str(steps), "--workdir_root",
                      str(WORK / "training_ss")])
    fwd = flash.flash_attention_fwd.launches
    bwd = flash.flash_attention_bwd.launches
    bf16 = sum(c.launches_bf16 for c in counters)
    peak = torch.cuda.max_memory_allocated()
    losses, secs, state = res["losses"], res["step_seconds"], res["state"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"SS train losses {losses}")
    if not np.isfinite(res["eval_loss"]):
        raise AssertionError(f"SS eval loss {res['eval_loss']}")
    want_fwd = SS_FWD_PER_TRAIN_STEP * steps + SS_FWD_PER_EVAL
    want_bwd = SS_BWD_PER_TRAIN_STEP * steps
    if (fwd, bwd, bf16) != (want_fwd, want_bwd, 0):
        raise AssertionError(f"SS launches: flash_fwd {fwd} (expected "
                             f"{want_fwd}), flash_bwd {bwd} (expected "
                             f"{want_bwd}), bf16 {bf16} (expected 0)")
    moved, ema_apart, n_params = moved_from_start(torch, config, state)
    timed = np.asarray(secs[SS_WARMUP:]) * 1e3
    ms = float(np.median(timed))
    log(f"training SS: quality_ss.yml (C=8 on the device, length + ss + "
        f"inpainting, the JAX initializers) at batch {SS_BATCH}, {steps} "
        f"steps on {res['records']} records: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (all finite), eval (EMA) {res['eval_loss']:.4f}; "
        f"flash_fwd launches {fwd} (= {SS_FWD_PER_TRAIN_STEP} x {steps} + "
        f"{SS_FWD_PER_EVAL} eval), flash_bwd {bwd} (= "
        f"{SS_BWD_PER_TRAIN_STEP} x {steps}), bf16 0; {moved}/{n_params} "
        f"params moved from the JAX initializers' draw, {ema_apart} EMA "
        f"params apart")
    log(f"training SS: {ms:.2f} ms per train step (median of the last "
        f"{SS_TIMED}, range {timed.min():.2f}-{timed.max():.2f}; first "
        f"{SS_WARMUP}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs[:SS_WARMUP])} ms), "
        f"{SS_BATCH / ms * 1e3:.1f} samples/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    out = dict(steps=steps, losses=losses, step_seconds=secs,
               workdir=str(res["workdir"]), ms_per_step=ms,
               ms_per_step_range=[float(timed.min()), float(timed.max())],
               samples_per_s=SS_BATCH / ms * 1e3, eval_loss=res["eval_loss"],
               peak_bytes=peak, fwd_launches=fwd, bwd_launches=bwd,
               kernel_rows=rows)
    del state, res
    torch.cuda.empty_cache()
    return out


def phase_train_reference_ss(torch, records):
    """One quality_ss.yml train step at B=1, dropout 0, from the same
    weights, with injected t, z, inpainting mask (the random branch) and
    SS block dropout: the card (kernels) against the CPU (plain versions),
    and the card against itself with the attention backward through its
    plain version."""
    import copy

    import numpy as np

    from text2protein_tpu_torch.conditioning import (
        batch_to_device_arrays,
        random_mask_batch,
    )
    from text2protein_tpu_torch.config import quality_ss_config
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import build_text_encoder
    from text2protein_tpu_torch.training.steps import featurize

    config = quality_ss_config()
    config.model.dropout = 0.0
    condition = tuple(config.model.condition)
    sde, _ = get_sde(config)
    gpu_model = init_random_weights(build_model(config, device="cuda"), 1)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    rec = ProteinProcessedDataset(records)[3]
    host = make_batch([rec], config.data.max_res_num)
    ctx, ctx_mask = build_text_encoder(config).encode(host["caption"])
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.uniform(0.05, 1.0, 1).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 128, 128, 8))
                         .astype(np.float32))
    mask = random_mask_batch(
        torch.from_numpy(host["length"]), 128, config,
        draws={"prob": 0.0, "span": rng.uniform(size=1),
               "scores": rng.uniform(size=(1, 128)),
               "start": rng.uniform(size=1)})
    drop = torch.from_numpy(rng.uniform(size=(1, 32)) < 0.5)
    kernel_bwd = flash.flash_attention_bwd

    def step(model, dev):
        batch = featurize(config, batch_to_device_arrays(host, config,
                                                         device=dev))
        batch.update(context=torch.from_numpy(ctx).to(dev),
                     context_mask=torch.from_numpy(ctx_mask).to(dev),
                     mask_inpaint=mask.to(dev))
        loss_fn = get_sde_loss_fn(sde, model, train=True,
                                  condition=condition)
        model.zero_grad(set_to_none=True)
        before = kernel_bwd.launches
        loss = loss_fn(None, batch, t=t.to(dev), z=z.to(dev),
                       ss_drop=drop.to(dev))
        loss.backward()
        return loss.item(), {k: p.grad.detach().cpu() for k, p in
                             model.named_parameters()}, \
            kernel_bwd.launches - before

    g_loss, g_grads, g_launch = step(gpu_model, "cuda")
    flash.flash_attention_bwd = flash.flash_attention_bwd_reference
    try:
        _, p_grads, _ = step(gpu_model, "cuda")
    finally:
        flash.flash_attention_bwd = kernel_bwd
    c_loss, c_grads, c_launch = step(cpu_model, "cpu")
    if g_launch != SS_BWD_PER_TRAIN_STEP or c_launch != 0:
        raise AssertionError(f"SS backward launches GPU {g_launch}, CPU "
                             f"{c_launch}; expected "
                             f"{SS_BWD_PER_TRAIN_STEP}, 0")
    loss_diff = abs(g_loss - c_loss) / abs(c_loss)
    worst, worst_key = worst_grad_diff(g_grads, c_grads)
    kernel_worst, kernel_key = worst_grad_diff(g_grads, p_grads)
    log(f"train reference SS: quality_ss.yml step at B=1 (inpainting mask "
        f"{int(mask.sum())} of {mask.numel()} entries free, SS blocks "
        f"{rec['ss_indices']}), GPU (kernels) vs CPU: loss {g_loss:.6f} vs "
        f"{c_loss:.6f} (rel {loss_diff:.2e}, tol {TRAIN_LOSS_TOL:.0e}); "
        f"worst of {len(c_grads)} gradients {worst_key} {worst:.2e} (tol "
        f"{TRAIN_GRAD_TOL:.0e}); GPU kernels vs GPU plain attention "
        f"backward: worst {kernel_key} {kernel_worst:.2e} (tol "
        f"{TRAIN_KERNEL_TOL:.0e}); GPU backward launches {g_launch}")
    if not (loss_diff < TRAIN_LOSS_TOL and worst < TRAIN_GRAD_TOL
            and kernel_worst < TRAIN_KERNEL_TOL):
        raise AssertionError("the GPU SS train step disagrees (line above)")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    return dict(loss_gpu=g_loss, loss_cpu=c_loss, loss_rel_diff=loss_diff,
                worst_grad=worst_key, worst_grad_rel_diff=worst,
                kernel_vs_plain_bwd_worst=kernel_worst)


def phase_sampling_ss(torch, workdir, records):
    """`cli/sampling_6d.main` on quality_ss.yml and phase 17's best_eval,
    conditioned on a PDB written from one of its records with an
    inpainting mask, twice (--n_iter 2); the PC step's time at batch 4 is
    the CLI's own timing of its sampler calls."""
    import pickle

    import numpy as np

    from text2protein_tpu_torch.cli import sampling_6d
    from text2protein_tpu_torch.conditioning import get_conditions_from_pdb
    from text2protein_tpu_torch.config import quality_ss_config
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.data.pdbio import write_backbone_pdb
    from text2protein_tpu_torch.ops import flash

    config = quality_ss_config()
    rec = ProteinProcessedDataset(records)[0]
    pdb = WORK / "ss_condition.pdb"
    write_backbone_pdb(pdb, rec["coords"], seq=rec["aa_str"])
    ckpt = workdir / "checkpoints" / "best_eval.pt"
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    t = time.perf_counter()
    res = sampling_6d.main([
        str(SS_CONFIG), str(ckpt), "--pdb", str(pdb), "--chain", "A",
        "--mask_info", SS_MASK_INFO, "--sampler", "pc", "--num_steps",
        str(SS_SAMPLING_STEPS), "--batch_size", str(SS_SAMPLING_BATCH),
        "--n_iter", str(SS_SAMPLING_ITERS), "--processed_dir", str(records),
        "--workdir_root", str(WORK / "sampling_ss")])
    secs = time.perf_counter() - t
    out, times = res["workdir"], res["sample_seconds"]
    launches = flash.flash_attention_fwd.launches
    others = (flash.flash_attention_bwd.launches
              + sum(c.launches_bf16 for c in counters))
    # one batch per call, no CFG
    want = SS_SAMPLING_ITERS * SS_SAMPLING_STEPS * 2 * SS_FWD_PER_EVAL
    if launches != want or others:
        raise AssertionError(f"SS sampling CLI launched flash_fwd {launches} "
                             f"times (expected {want}), others {others}")
    cond = get_conditions_from_pdb(str(pdb), config, "A", SS_MASK_INFO,
                                   batch_size=1)
    coords = cond["inpainting"]["coords_6d"][0].numpy()
    free = cond["inpainting"]["mask_inpaint"][0].numpy()
    ss = cond["ss"][0].numpy()
    length = cond["length"][0].numpy()
    pickles = sorted(out.glob("*.pkl"))
    if (len(pickles) != SS_SAMPLING_BATCH * SS_SAMPLING_ITERS
            or len(times) != SS_SAMPLING_ITERS):
        raise AssertionError(f"SS sampling CLI wrote {len(pickles)} "
                             f"pickles in {len(times)} sampler calls")
    for p in pickles:
        with open(p, "rb") as f:
            a = pickle.load(f)
        if a.shape != (1, 8, 128, 128) or not np.isfinite(a).all():
            raise AssertionError(f"{p.name}: {a.shape}")
        x = a[0].transpose(1, 2, 0)
        if not (np.array_equal(x[..., 4:7], ss)
                and np.array_equal(x[~free], coords[~free])
                and np.array_equal(x[..., -1], length)):
            raise AssertionError(f"{p.name}: the conditions are not clamped")
    s_per_step = min(times) / SS_SAMPLING_STEPS
    log(f"sampling SS: cli/sampling_6d --pdb (record {rec['id']}, length "
        f"{len(rec['aa'])}, SS blocks {rec['ss_indices']}) --mask_info "
        f"{SS_MASK_INFO} --n_iter {SS_SAMPLING_ITERS}: {len(pickles)} "
        f"pickles (1, 8, 128, 128), finite, SS channels = the PDB's, the "
        f"{int((~free).sum())} entries outside the inpainting region = the "
        f"condition, last channel = the length mask; flash_fwd launches "
        f"{launches} (= {SS_SAMPLING_ITERS} x {SS_SAMPLING_STEPS} x 2 x "
        f"{SS_FWD_PER_EVAL}); {secs:.2f}s with the restore")
    log(f"sampling SS: {s_per_step * 1e3:.2f} ms per PC step at batch "
        f"{SS_SAMPLING_BATCH} (the better of the CLI's {SS_SAMPLING_ITERS} "
        f"sampler calls of {SS_SAMPLING_STEPS} steps: "
        f"{', '.join(f'{x:.3f}' for x in times)} s); "
        f"{SS_SAMPLING_BATCH * 60 / (s_per_step * 2000):.3f} samples/min at "
        f"the yml's 2000 steps")
    return dict(launches=launches, cli_seconds=secs, run_seconds=times,
                ms_per_pc_step=s_per_step * 1e3,
                samples_per_min_2000=SS_SAMPLING_BATCH * 60
                / (s_per_step * 2000))


def phase_bf16_l128(torch, ptxas, records):
    """The bf16 kernels at every shape of a quality_ss_vp.yml train step
    (batch 16), then cli/train.main on the yml for 2 + 2 steps: a launch
    check."""
    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.config import quality_ss_vp_config
    from text2protein_tpu_torch.ops import flash

    config = quality_ss_vp_config()
    if (str(config.model.dtype), config.training.batch_size) != (
            "bfloat16", SS_BATCH):
        raise AssertionError("quality_ss_vp.yml is not bf16 at batch "
                             f"{SS_BATCH}")
    fwd_rows, bwd_rows = phase_kernels_bf16(
        torch, ptxas, runs=(("fwd", SS_TRAIN_SHAPES, SS_BATCH),
                            ("bwd", SS_BWD_SHAPES, SS_BATCH)), seed=5)
    steps = SS_VP_WARMUP + SS_VP_TIMED
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    res = train.main(["--config", str(SS_VP_CONFIG), "--data", str(records),
                      "--max_steps", str(steps), "--workdir_root",
                      str(WORK / "training_ss_vp")])
    shutil.rmtree(res["workdir"])
    fwd = flash.flash_attention_fwd.launches_bf16
    bwd = flash.flash_attention_bwd.launches_bf16
    f32 = sum(c.launches for c in counters)
    losses, secs = res["losses"], res["step_seconds"]
    if len(losses) != steps or not (np.isfinite(losses).all()
                                    and np.isfinite(res["eval_loss"])):
        raise AssertionError(f"SS bf16 losses {losses}, eval "
                             f"{res['eval_loss']}")
    want_fwd = SS_FWD_PER_TRAIN_STEP * steps + SS_FWD_PER_EVAL
    want_bwd = SS_BWD_PER_TRAIN_STEP * steps
    if (fwd, bwd, f32) != (want_fwd, want_bwd, 0):
        raise AssertionError(f"SS bf16 launches: fwd_bf16 {fwd} (expected "
                             f"{want_fwd}), bwd_bf16 {bwd} (expected "
                             f"{want_bwd}), f32 {f32} (expected 0)")
    timed = np.asarray(secs[SS_VP_WARMUP:]) * 1e3
    log(f"bf16 L=128: quality_ss_vp.yml at batch {SS_BATCH}, {steps} steps: "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f} (all finite), eval "
        f"{res['eval_loss']:.4f}; flash_fwd_bf16 launches {fwd} (= "
        f"{SS_FWD_PER_TRAIN_STEP} x {steps} + {SS_FWD_PER_EVAL} eval), "
        f"flash_bwd_bf16 {bwd} (= {SS_BWD_PER_TRAIN_STEP} x {steps}), f32 0; "
        f"last {SS_VP_TIMED} steps {', '.join(f'{x:.1f}' for x in timed)} ms")
    del res
    torch.cuda.empty_cache()
    return dict(fwd_rows=fwd_rows, bwd_rows=bwd_rows, fwd_launches=fwd,
                bwd_launches=bwd, losses=losses, step_seconds=secs)


def phase_text(torch, ptxas, smi):
    """The caption path and evaluation on quality_text_cfgft.yml: the bf16
    kernels at its sampler's and train step's shapes; the caption cache
    (`cli/text_preprocess`, hash at D=512, 16 tokens) from a captions json
    written from the records, held against the hash encoder; `cli/train`
    for TEXT_STEPS steps with the resident bf16 context table; the sampling
    CLI on the held-out captions; then the samples scored
    (`eval.coords_compare`, `eval.helix_count`) and `eval.tm_sweeps` run on
    ground-truth backbones written as PDBs, by the native TM-align and by
    the Python one."""
    import pickle
    import re

    import numpy as np

    from text2protein_tpu_torch.cli import sampling_6d, text_preprocess, train
    from text2protein_tpu_torch.config import load_config, save_config
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        load_record,
    )
    from text2protein_tpu_torch.data.pdbio import write_backbone_pdb
    from text2protein_tpu_torch.eval import (
        coords_compare,
        helix_count,
        tm_sweeps,
        tmscore,
    )
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import (
        CachedTextEncoder,
        build_text_encoder,
    )

    config = load_config(TEXT_CONFIG)
    want = ("bfloat16", SS_BATCH, True, 10, "hash", 16, 512)
    got = (str(config.model.dtype), config.training.batch_size,
           bool(config.data.featurize_on_device),
           int(config.training.steps_per_launch), config.text.encoder,
           config.text.max_tokens, config.model.context_dim)
    if got != want:
        raise AssertionError(f"quality_text_cfgft.yml: {got}, not {want}")
    work = WORK / "text"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)

    def zero():
        for c in counters:
            c.launches = c.launches_bf16 = 0

    def read():
        return (flash.flash_attention_fwd.launches_bf16,
                flash.flash_attention_bwd.launches_bf16,
                sum(c.launches for c in counters))

    fwd_rows, bwd_rows = phase_kernels_bf16(
        torch, ptxas, runs=(("fwd", TEXT_PC_SHAPES, TEXT_SAMPLING_BATCH),
                            ("bwd", SS_BWD_SHAPES, SS_BATCH)), seed=7)

    # the caption cache, from a captions json of the records
    ds = ProteinProcessedDataset(TEXT_RECORDS)
    captions = {name.split(".")[0]: ds.caption(i)
                for i, name in enumerate(ds.data_paths)}
    (work / "captions.json").write_text(json.dumps(captions))
    config.data.caption_path = str(work / "captions.json")
    config.training.log_freq = TEXT_LOG_FREQ
    cfg_path = work / TEXT_CONFIG.name
    save_config(config, cfg_path)
    t = time.perf_counter()
    cache = text_preprocess.main([str(cfg_path), "--out",
                                  str(work / "id2emb.npz")])
    cache_s = time.perf_counter() - t
    cached = CachedTextEncoder(cache, pad_to_bucket=config.text.pad_to_bucket,
                               max_tokens=config.text.max_tokens)
    encoder = build_text_encoder(config)
    ids = list(captions)
    for i in range(0, len(ids), 64):
        chunk = ids[i:i + 64]
        for a, b in zip(cached.encode_ids(chunk),
                        encoder.encode([captions[c] for c in chunk])):
            if not np.array_equal(a, b):
                raise AssertionError("the cached embeddings are not the "
                                     "hash encoder's rows")
    unique = len(set(captions.values()))
    log(f"text cache: cli/text_preprocess wrote {len(ids)} caption "
        f"embeddings ({unique} unique captions, D={cached.dim}) in "
        f"{cache_s:.2f}s; CachedTextEncoder.encode_ids = the hash "
        f"encoder's rows for every record (exact)")
    # the host time of the f32 encode a table step does not pay
    batch_caps = [captions[c] for c in ids[:SS_BATCH]]
    enc_ms = []
    for _ in range(20):
        t = time.perf_counter()
        encoder.encode(batch_caps)
        enc_ms.append((time.perf_counter() - t) * 1e3)
    enc_ms = float(np.median(enc_ms))

    # training with the resident table
    zero()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(["--config", str(cfg_path), "--data",
                      str(TEXT_RECORDS), "--max_steps", str(TEXT_STEPS),
                      "--workdir_root", str(work / "training")])
    fwd, bwd, f32 = read()
    peak = torch.cuda.max_memory_allocated()
    losses, secs = res["losses"], res["step_seconds"]
    if len(losses) != TEXT_STEPS or not (np.isfinite(losses).all()
                                         and np.isfinite(res["eval_loss"])):
        raise AssertionError(f"text train losses {losses}, eval "
                             f"{res['eval_loss']}")
    want_fwd = SS_FWD_PER_TRAIN_STEP * TEXT_STEPS + SS_FWD_PER_EVAL
    want_bwd = SS_BWD_PER_TRAIN_STEP * TEXT_STEPS
    if (fwd, bwd, f32) != (want_fwd, want_bwd, 0):
        raise AssertionError(f"text train launches: fwd_bf16 {fwd} "
                             f"(expected {want_fwd}), bwd_bf16 {bwd} "
                             f"(expected {want_bwd}), f32 {f32}")
    table = res["context_table"]
    if (res["table_steps"] != TEXT_TABLE_STEPS or table is None
            or table["unique"] != unique):
        raise AssertionError(f"table steps {res['table_steps']}, table "
                             f"{table}, {unique} unique captions")
    workdir = Path(res["workdir"])
    n_train = len((workdir / "train_ids.txt").read_text().split("\n"))
    per_epoch = n_train // SS_BATCH
    if not per_epoch < TEXT_STEPS:
        raise AssertionError(f"{TEXT_STEPS} steps stay in one epoch of "
                             f"{per_epoch}")
    metrics = [json.loads(x) for x in
               (workdir / "tb" / "metrics.jsonl").read_text().splitlines()]
    tags = sorted((m["tag"], m["step"]) for m in metrics)
    want_tags = sorted([("training_loss", s) for s in range(
        TEXT_LOG_FREQ, TEXT_STEPS + 1, TEXT_LOG_FREQ)]
        + [("avg_training_loss", TEXT_STEPS), ("avg_eval_loss", TEXT_STEPS)])
    if tags != want_tags:
        raise AssertionError(f"metrics.jsonl holds {tags}, not {want_tags}")
    table_ms = np.asarray(secs[TEXT_WARMUP:TEXT_TABLE_STEPS]) * 1e3
    tail_ms = np.asarray(secs[TEXT_TABLE_STEPS:]) * 1e3
    ms = float(np.median(table_ms))
    log(f"text training: quality_text_cfgft.yml (bf16, featurized on the "
        f"device, context dropout {config.model.context_dropout}) at batch "
        f"{SS_BATCH}, {TEXT_STEPS} steps on {res['records']} records "
        f"({per_epoch} steps an epoch: the run crosses an epoch boundary): "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f} (all finite), eval "
        f"{res['eval_loss']:.4f}; resident context table {table['unique']} "
        f"unique captions, {table['bytes'] / 2**20:.4f} MiB bf16; "
        f"{res['table_steps']} steps took the table, "
        f"{TEXT_STEPS - res['table_steps']} the f32 encode; "
        f"flash_fwd_bf16 {fwd} (= {SS_FWD_PER_TRAIN_STEP} x {TEXT_STEPS} + "
        f"{SS_FWD_PER_EVAL} eval), flash_bwd_bf16 {bwd} (= "
        f"{SS_BWD_PER_TRAIN_STEP} x {TEXT_STEPS}), f32 0; metrics.jsonl "
        f"tags {sorted({m['tag'] for m in metrics})}")
    log(f"text training ({smi}): {ms:.2f} ms per table step (median of "
        f"steps {TEXT_WARMUP + 1}-{TEXT_TABLE_STEPS}, range "
        f"{table_ms.min():.2f}-{table_ms.max():.2f}), tail steps (f32 "
        f"encode) {', '.join(f'{x:.2f}' for x in tail_ms)} ms; first "
        f"{TEXT_WARMUP}: {', '.join(f'{x * 1e3:.1f}' for x in secs[:2])} "
        f"ms; {SS_BATCH / ms * 1e3:.1f} samples/s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; the f32 encode a table step saves: "
        f"{enc_ms:.3f} ms of host time per batch of {SS_BATCH}")
    del res
    torch.cuda.empty_cache()

    # sampling the held-out captions
    zero()
    t = time.perf_counter()
    samp = sampling_6d.main([
        str(cfg_path), str(workdir / "checkpoints" / "best_eval.pt"),
        "--sampler", "pc", "--num_steps", str(TEXT_SAMPLING_STEPS),
        "--batch_size", str(TEXT_SAMPLING_BATCH), "--processed_dir",
        str(TEXT_RECORDS), "--workdir_root", str(work / "sampling")])
    cli_s = time.perf_counter() - t
    fwd_s, bwd_s, f32_s = read()
    out, times = samp["workdir"], samp["sample_seconds"]
    test_ids = (workdir / "test_ids.txt").read_text().split("\n")
    calls = len(test_ids) // TEXT_SAMPLING_BATCH
    want_fwd_s = calls * TEXT_SAMPLING_STEPS * TEXT_FWD_PER_PC_STEP
    if (fwd_s, bwd_s, f32_s) != (want_fwd_s, 0, 0) or len(times) != calls:
        raise AssertionError(f"text sampling: {len(times)} calls, launches "
                             f"fwd_bf16 {fwd_s} (expected {want_fwd_s}), "
                             f"bwd_bf16 {bwd_s}, f32 {f32_s}")
    pickles = sorted(out.glob("sampled_*.pkl"))
    if len(pickles) != calls * TEXT_SAMPLING_BATCH:
        raise AssertionError(f"{len(pickles)} pickles for {calls} calls")
    samples = {}
    for p in pickles:
        with open(p, "rb") as f:
            a = pickle.load(f)
        if a.shape != (1, 5, 128, 128) or not np.isfinite(a).all():
            raise AssertionError(f"{p.name}: {a.shape}")
        samples[p.stem[len("sampled_"):]] = a[0]
    pc_ms = min(times) / TEXT_SAMPLING_STEPS * 1e3
    log(f"text sampling ({smi}): cli/sampling_6d on {len(test_ids)} "
        f"held-out captions: {len(pickles)} pickles (1, 5, 128, 128), "
        f"finite, in {calls} calls of {TEXT_SAMPLING_STEPS} PC steps at "
        f"batch {TEXT_SAMPLING_BATCH}; flash_fwd_bf16 {fwd_s} (= {calls} x "
        f"{TEXT_SAMPLING_STEPS} x {TEXT_FWD_PER_PC_STEP}); {pc_ms:.2f} ms "
        f"per PC step (the best call; calls "
        f"{', '.join(f'{x:.3f}' for x in times)} s), {cli_s:.2f}s with the "
        f"restore")

    # scoring
    stats = coords_compare.coord_compare(out, TEXT_RECORDS,
                                         work / "coords_6d_losses.yaml")
    mses = list(stats["per_pdb"].values())
    if stats["count"] != len(pickles) or not np.isfinite(mses).all():
        raise AssertionError(f"coord_compare: {stats}")
    helices = {}
    for pid, a in samples.items():
        gt = load_record(TEXT_RECORDS / f"{pid}.npz")
        L = gt["coords_6d"].shape[1]
        said = re.search(r"(\d+) helices", gt["caption"])
        helices[pid] = dict(
            length=L, caption=int(said.group(1)) if said else None,
            gt=helix_count.count_helices(gt["coords_6d"], L),
            sample=helix_count.count_helices(a, L))
    pdbs = work / "pdbs"
    pdbs.mkdir()
    picked = [ids[0], ids[-1]]
    for pid in picked:
        rec = load_record(TEXT_RECORDS / f"{pid}.npz")
        write_backbone_pdb(pdbs / f"{pid}.pdb", rec["coords"],
                           seq=rec["aa_str"])
    a_pdb, b_pdb = (pdbs / f"{pid}.pdb" for pid in picked)
    pairs = [(picked[0], a_pdb, a_pdb), (picked[1], b_pdb, b_pdb),
             ("cross", a_pdb, b_pdb)]
    binary = tmscore._NATIVE_BINARY
    if binary.exists():
        ran = subprocess.run([str(binary), str(a_pdb), str(a_pdb)],
                             capture_output=True, text=True, timeout=120)
        if ran.returncode != 0 or "TM-score" not in ran.stdout:
            raise AssertionError(f"{binary} exists but does not run: rc "
                                 f"{ran.returncode} {ran.stderr[-500:]}")
        route = f"native ({binary.relative_to(ROOT)})"
    else:
        route = "Python (no native binary)"
    tm = {}
    for native in (True, False):
        res_tm = tm_sweeps.gt_gen_tm_compare(
            pairs, out_path=work / f"tm-scores-{int(native)}.json",
            use_native=native)
        tm["run_tmalign" if native else "python"] = res_tm["samples"]
        for pid in picked:
            if abs(res_tm["samples"][pid] - 1.0) > 1e-6:
                raise AssertionError(f"TM-score of {pid} against itself: "
                                     f"{res_tm['samples'][pid]}")
    counts = ", ".join(f"{h['caption']}/{h['gt']}/{h['sample']}"
                       for h in helices.values())
    log(f"text scoring: coord_compare of {stats['count']} samples: 6D MSE "
        f"avg {stats['avg']:.5f} min {stats['min']:.5f} max "
        f"{stats['max']:.5f} (all finite); helices (caption / ground truth "
        f"/ sample) {counts}; run_tmalign ran {route}; TM-scores (self, "
        f"self, cross) by run_tmalign {list(tm['run_tmalign'].values())}, "
        f"by the Python scorer {list(tm['python'].values())}")
    return dict(fwd_rows=fwd_rows, bwd_rows=bwd_rows, fwd_launches=fwd
                + fwd_s, bwd_launches=bwd, cache_seconds=cache_s,
                unique_captions=unique, table=table,
                table_steps=TEXT_TABLE_STEPS, losses=losses,
                step_seconds=secs, ms_per_table_step=ms,
                ms_per_table_step_range=[float(table_ms.min()),
                                         float(table_ms.max())],
                tail_step_ms=tail_ms.tolist(), peak_bytes=peak,
                f32_encode_ms=enc_ms, ms_per_pc_step=pc_ms,
                sample_seconds=times, mse=stats, helices=helices,
                tmalign_route=route, tm_scores=tm)


# realization (phase 22): L=128 designs of the port's synthetic helix
# bundles, compacted on the card; the quality check of the JAX package's
# own test (tests/test_realize.py: L=64, 3 restarts, max_iter 150, seed 1,
# TM > 0.8, N-CA and C-N within 0.1 A of ideal); realize_batch with 5
# restarts and REALIZE_BATCH_ITERS (its default 300 halved: the depth cut
# that keeps the script inside its time limit, ~75 s); the flagship Server
# at batch 4 with realize; cli/sampling_rosetta on phase 14's pickles
REALIZE_L = 128
REALIZE_BATCH_ITERS = 75
REALIZE_SEEDS = (0, 1, 2, 3)
REALIZE_QUALITY = dict(L=64, seed=5, n_restarts=3, max_iter=150, run_seed=1)
REALIZE_LENGTHS = (128, 96, 64, 40)
# card against CPU: energies within 1e-5 relative (floored at 1, one
# squared standard deviation), gradients within 1e-4 of the term's largest
# |gradient|, on the ground truth of design 0 perturbed by 0.5 A
REALIZE_E_RTOL = 1e-5
REALIZE_G_RTOL = 1e-4
# the first fold-stage L-BFGS iterations on the card against the CPU, from
# 5 starts 0.5 A off the ground truth: the same linesearch steps, iterates
# within 1e-2 A (coordinates up to ~40 A; f32 sums over L^2 pairs in the
# card's order, which part further at each iteration, as the port and JAX
# do on the CPU). Not from the protocol's MDS starts: there the terminal
# residues' N, CA and C lie on a line, the theta dihedral is singular and
# the f32 gradient is rounding (scripts/realize_start_singularity.py), so
# no two machines take the same first step.
REALIZE_ITERS = 5
REALIZE_X_ATOL = 1e-2
# cli/sampling_rosetta's depth, cut from its defaults (5 restarts, max_iter
# 150) so the phase stays inside the script's time limit: ~20 ms per
# batched evaluation on the card's host, and up to 20 evaluations an
# iteration on maps from an 8-step model
ROSETTA_FLAGS = ["--n_restarts", "2", "--max_iter", "10"]
REALIZE_PROFILE_ITERS = 2


def _realize_terms(rst, ca_ref):
    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize import restraints as tr

    return {
        "restraint": lambda b: tr.restraint_energy(
            b, rst, 1e9, {"dist": 3.0, "orient": 1.0}),
        "long_dist": lambda b: tr.long_dist_energy(b, rst),
        "ca_coordinate": lambda b: tr.ca_coordinate_energy(b, ca_ref),
        "bonded": tr.bonded_energy,
        "rama_cartesian": tr.rama_energy_cartesian,
        "hbond": tr.hbond_energy,
        "clash": tr.clash_energy,
        "e_fold": lambda b: tm.e_fold(b, rst),
        "e_ideal": lambda b: tm.e_ideal(b, rst),
    }


def _value_and_grad(torch, fn, x):
    x = x.detach().clone().requires_grad_(True)
    e = fn(x)
    (g,) = torch.autograd.grad(e.sum(), x)
    return e.detach().cpu().double(), g.cpu().double()


def realize_card_vs_cpu(torch, npz, bb_true):
    """Every energy term and its gradient, and the first fold-stage L-BFGS
    iterations, on the card against the CPU."""
    import numpy as np

    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize import restraints as tr
    from text2protein_tpu_torch.realize.lbfgs import LBFGS

    rng = np.random.default_rng(0)
    x = torch.from_numpy((bb_true + rng.standard_normal(bb_true.shape)
                          * 0.5).astype(np.float32))
    ref = torch.from_numpy(bb_true[:, 1].copy())
    rst = {d: tr.restraints_from_maps(npz, device=d) for d in ("cpu",
                                                               "cuda")}
    terms = {d: _realize_terms(rst[d], ref.to(d)) for d in rst}
    rows = {}
    for name in terms["cpu"]:
        e_c, g_c = _value_and_grad(torch, terms["cpu"][name], x)
        e_g, g_g = _value_and_grad(torch, terms["cuda"][name], x.cuda())
        e_err = abs(float(e_g - e_c)) / max(abs(float(e_c)), 1.0)
        scale = float(g_c.abs().max())
        g_err = float((g_g - g_c).abs().max()) / max(scale, 1e-30)
        if not (e_err <= REALIZE_E_RTOL and g_err <= REALIZE_G_RTOL
                and torch.isfinite(g_g).all()):
            raise AssertionError(f"realize: {name} on the card against the "
                                 f"CPU: energy {e_err:.2e}, gradient "
                                 f"{g_err:.2e} of its scale")
        rows[name] = {"energy": float(e_c), "energy_rel_err": e_err,
                      "grad_scale": scale, "grad_rel_err": g_err}
    starts = torch.from_numpy((bb_true[None] + rng.standard_normal(
        (5,) + bb_true.shape) * 0.5).astype(np.float32))
    solvers = {d: LBFGS(lambda b, r=rst[d]: tm.e_fold(b, r), starts.to(d))
               for d in rst}
    worst = 0.0
    for i in range(REALIZE_ITERS):
        for s in solvers.values():
            s.step()
        c, g = solvers["cpu"], solvers["cuda"]
        if not np.array_equal(c.linesearch_steps[i], g.linesearch_steps[i]):
            raise AssertionError(f"realize: iteration {i}: linesearch "
                                 f"steps {g.linesearch_steps[i]} on the "
                                 f"card, {c.linesearch_steps[i]} on the CPU")
        worst = max(worst, float((g.x.cpu() - c.x).abs().max()))
    if not worst <= REALIZE_X_ATOL:
        raise AssertionError(f"realize: fold-stage iterates on the card "
                             f"{worst:.2e} A from the CPU's")
    worst_e = max(r["energy_rel_err"] for r in rows.values())
    log(f"realize: card = CPU at L={len(bb_true)}: {len(rows)} energy "
        f"terms, worst energy {worst_e:.2e} "
        f"(tol {REALIZE_E_RTOL:.0e}), worst gradient "
        f"{max(r['grad_rel_err'] for r in rows.values()):.2e} of its scale "
        f"(tol {REALIZE_G_RTOL:.0e}); {REALIZE_ITERS} fold-stage L-BFGS "
        f"iterations x 5 starts: the same linesearch steps, iterates within "
        f"{worst:.2e} A (tol {REALIZE_X_ATOL:.0e})")
    return {"terms": rows, "fold_iters": REALIZE_ITERS,
            "fold_iterate_max_diff": worst}


def _bond_dev(bb):
    import numpy as np

    from text2protein_tpu_torch.realize.geometry import B_C_N, B_N_CA

    n_ca = np.linalg.norm(bb[:, 1] - bb[:, 0], axis=-1)
    c_n = np.linalg.norm(bb[1:, 0] - bb[:-1, 2], axis=-1)
    return float(np.abs(n_ca - B_N_CA).max()), float(np.abs(c_n - B_C_N).max())


def _solver_stats(log_):
    return [{"iterations": len(s.linesearch_steps),
             "evaluations": s.evaluations, "batch": int(s.x.shape[0])}
            for s in log_]


def phase_realize(torch, smi, sampled_dir):
    """Realization on the card: card = CPU, the L=64 quality bar,
    realize_batch at L=128, the Server's realize branch and
    cli/sampling_rosetta."""
    import numpy as np

    from text2protein_tpu_torch.cli import sampling_rosetta
    from text2protein_tpu_torch.cli.profile_serving import device_kernels
    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import flagship_config
    from text2protein_tpu_torch.data import pdbio, synthetic
    from text2protein_tpu_torch.data.featurize import featurize_structure
    from text2protein_tpu_torch.eval.tm_sweeps import reu_stats
    from text2protein_tpu_torch.eval.tmscore import tm_score
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize.restraints import inverse_scale

    out = {"nvidia_smi": smi}
    L = REALIZE_L
    flash.flash_attention_fwd.launches = 0
    flash.flash_attention_bwd.launches = 0
    t = time.perf_counter()
    bbs = synthetic.helix_bundle_backbones(L, REALIZE_SEEDS, device="cuda")
    torch.cuda.synchronize()
    out["bundle_seconds"] = time.perf_counter() - t
    maps = np.stack([featurize_structure(b, np.ones(L),
                                         ss_constraints=False)[0]
                     for b in bbs])
    if not np.isfinite(bbs).all() or maps.shape != (4, 5, L, L):
        raise AssertionError("realize: bad synthetic designs")
    OUT.mkdir(exist_ok=True)
    np.savez_compressed(OUT / "realize_maps.npz", maps=maps, backbones=bbs)
    log(f"realize ({smi}): {len(bbs)} helix bundles of L={L} built and "
        f"compacted on the card in {out['bundle_seconds']:.2f}s (maps and "
        f"backbones in chiprun_out/realize_maps.npz)")

    out["card_vs_cpu"] = realize_card_vs_cpu(
        torch, inverse_scale(maps[0], L), bbs[0])

    # the JAX package's quality bar, on the port's own L=64 bundle
    q = REALIZE_QUALITY
    bb_q = synthetic.helix_bundle_backbone(q["L"], seed=q["seed"],
                                           device="cuda")
    c6d, _, _ = featurize_structure(bb_q, np.ones(q["L"]),
                                    ss_constraints=False)
    solver_log = []
    t = time.perf_counter()
    bb_min, e_best, energies = tm.run_minimization(
        inverse_scale(c6d, q["L"]), "A" * q["L"], n_restarts=q["n_restarts"],
        max_iter=q["max_iter"], seed=q["run_seed"], device="cuda",
        solver_log=solver_log)
    secs = time.perf_counter() - t
    tm_q = tm_score(bb_min[:, 1], bb_q[:, 1])
    dev = _bond_dev(bb_min)
    if not (np.isfinite(bb_min).all() and tm_q > 0.8 and max(dev) < 0.1):
        raise AssertionError(f"realize: L={q['L']} quality TM {tm_q:.3f}, "
                             f"bond deviations {dev} (energies {energies})")
    out["quality"] = dict(tm=tm_q, bond_dev=dev, energy=e_best,
                          restart_energies=energies.tolist(), seconds=secs,
                          solves=_solver_stats(solver_log))
    log(f"realize ({smi}): run_minimization L={q['L']}, "
        f"{q['n_restarts']} restarts, max_iter {q['max_iter']}, seed "
        f"{q['run_seed']}: TM {tm_q:.4f} to the truth (bar 0.8), N-CA/C-N "
        f"within {dev[0]:.4f}/{dev[1]:.4f} A of ideal, energy {e_best:.2f}, "
        f"{secs:.2f}s, evaluations per solve "
        f"{[s.evaluations for s in solver_log]}")

    # realize_batch on the 4 L=128 designs
    solver_log = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    got, es = tm.realize_batch(maps, max_iter=REALIZE_BATCH_ITERS,
                               device="cuda", solver_log=solver_log)
    secs = time.perf_counter() - t
    tms = [tm_score(got[k, :, 1], bbs[k, :, 1]) for k in range(len(bbs))]
    if not (np.isfinite(got).all() and np.isfinite(es).all()):
        raise AssertionError("realize: realize_batch gave non-finite output")
    if (flash.flash_attention_fwd.launches
            or flash.flash_attention_bwd.launches):
        raise AssertionError("realization launched a flash kernel")
    out["batch"] = dict(tm=tms, energies=es.tolist(), seconds=secs,
                        solves=_solver_stats(solver_log),
                        bond_dev=[_bond_dev(b) for b in got])
    log(f"realize ({smi}): realize_batch D=4 x 5 restarts at L={L}, "
        f"max_iter {REALIZE_BATCH_ITERS}: {secs:.2f}s per batch; TM to the "
        f"truth {[round(x, 4) for x in tms]}; selection energies "
        f"{[round(float(x), 2) for x in es]}; evaluations per solve "
        f"{[s.evaluations for s in solver_log]} over "
        f"{[len(s.linesearch_steps) for s in solver_log]} iterations")

    # one window of the fold stage under the profiler: the device's busy
    # share of a batched solve
    from text2protein_tpu_torch.realize import restraints as tr
    from text2protein_tpu_torch.realize.lbfgs import LBFGS
    from torch.profiler import ProfilerActivity, profile

    rst = tr.Restraints.stack([tr.restraints_from_maps(
        inverse_scale(m, L), device="cuda") for m in maps]).map(
            lambda x: x[:, None])
    starts = torch.from_numpy(np.stack([tm._restart_starts(
        inverse_scale(m, L)["dist_abs"], L, 5, 31 * k)
        for k, m in enumerate(maps)])).cuda().reshape(20, L, 3, 3)
    solver = LBFGS(lambda b: tm.e_fold(b.view(4, 5, L, 3, 3), rst)
                   .reshape(-1), starts)
    for _ in range(3):
        solver.step()
    torch.cuda.synchronize()
    evals0 = solver.evaluations
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(REALIZE_PROFILE_ITERS):
            solver.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = device_kernels(prof)
    busy = sum(r["device_ms"] for r in rows) / 1e3
    evals = solver.evaluations - evals0
    launches = sum(r["calls"] for r in rows)
    out["profile"] = dict(iterations=REALIZE_PROFILE_ITERS, wall_s=wall,
                          busy_s=busy, busy_share=busy / wall,
                          evaluations=evals, kernel_launches=launches,
                          top=rows[:10])
    log(f"realize profile ({smi}): {REALIZE_PROFILE_ITERS} fold-stage "
        f"iterations of the D=4 x 5 batch at L={L}: {wall:.3f}s wall, "
        f"device busy {busy:.3f}s ({busy / wall:.1%}), {evals} evaluations "
        f"({wall / max(evals, 1) * 1e3:.2f} ms each), "
        f"{launches / max(evals, 1):.0f} kernel launches per evaluation")

    # the flagship Server at batch 4 with realize
    server = Server(flagship_config(), batch_size=BATCH, num_steps=STEPS,
                    device="cuda", weight_seed=0, realize=True)
    reqs = [{"caption": f"design {L_}", "length": L_, "realize": True}
            for L_ in REALIZE_LENGTHS]
    server.run_batch([dict(r, realize=False) for r in reqs])  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    server.run_batch([dict(r, realize=False) for r in reqs])
    sample_s = time.perf_counter() - t
    flash.flash_attention_fwd.launches = 0
    t = time.perf_counter()
    results = server.run_batch(reqs)
    total_s = time.perf_counter() - t
    fwd = flash.flash_attention_fwd.launches
    if fwd != LAUNCHES_PER_STEP * STEPS:
        raise AssertionError(f"realize serving launched flash_fwd {fwd} "
                             f"times")
    check_maps(results, reqs, 128)
    for req, res in zip(reqs, results):
        path = WORK / f"served_{req['length']}.pdb"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(res["pdb"])
        n = len(pdbio.read_pdb(path).amino_residues())
        if n != req["length"] or not np.isfinite(res["energy"]):
            raise AssertionError(f"realize serving: {n} residues, energy "
                                 f"{res['energy']} for {req}")
    per_design = (total_s - sample_s) / len(reqs)
    out["serving"] = dict(lengths=list(REALIZE_LENGTHS),
                          energies=[r["energy"] for r in results],
                          batch_seconds=total_s, sample_seconds=sample_s,
                          seconds_per_design=per_design, launches=fwd)
    log(f"realize serving ({smi}): flagship Server batch {BATCH}, "
        f"{STEPS} PC steps, realize on at lengths {list(REALIZE_LENGTHS)}: "
        f"PDBs of those lengths, energies "
        f"{[round(r['energy'], 2) for r in results]}; {total_s:.2f}s for "
        f"the batch, {sample_s:.2f}s of it sampling: {per_design:.2f}s per "
        f"realized design; flash_fwd launches {fwd}")
    del server

    # cli/sampling_rosetta on phase 14's pickles
    root = WORK / "rosetta"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    sampling_rosetta.main([str(DEPLOY_CONFIG), "--coords_path",
                           str(sampled_dir), "--n_iter", "1",
                           "--fastdesign", "--designer", "learned",
                           "--out_root", str(root), "--device", "cuda"]
                          + ROSETTA_FLAGS)
    secs = time.perf_counter() - t
    ids = sorted(p.stem[len("sampled_"):]
                 for p in Path(sampled_dir).glob("sampled_*.pkl"))
    base = root / Path(sampled_dir).parent.parent.stem
    for i in ids:
        for rel in ("round_1/structure_before_design.pdb",
                    "round_1/final_structure.pdb",
                    "round_1/structure_after_design.pdb",
                    "round_1/score.txt", "best_run", f"rosetta_{i}.pdb"):
            if not (base / i / rel).exists():
                raise AssertionError(f"sampling_rosetta: no {i}/{rel}")
    stats = reu_stats(sorted(root.rglob("score.txt")))
    if stats["count"] != len(ids):
        raise AssertionError(f"reu_stats read {stats} for {len(ids)} ids")
    out["sampling_rosetta"] = dict(ids=ids, seconds=secs, reu=stats)
    log(f"realize ({smi}): cli/sampling_rosetta --fastdesign --designer "
        f"learned {' '.join(ROSETTA_FLAGS)} on {len(ids)} sampled pickles "
        f"in {secs:.2f}s "
        f"({secs / max(len(ids), 1):.2f}s per design); eval.tm_sweeps."
        f"reu_stats read {stats['count']} score.txt files, avg "
        f"{stats['avg']:.3f} per residue")
    out["launches"] = fwd
    return out


# phase 23: bench_l128 at batch 16 on a mesh of ranks, one per card (NCCL),
# against the plain one-device steps on rank 0's card; each layout is one
# `parallel.launch.spawn` of its ranks
DIST_STEPS = 2       # train steps of each run (the first warms cuDNN up)
DIST_GROUP_S = 600   # every collective's time limit (rank 0 runs the plain
#                      steps while the others wait in their first one)
DIST_LOSS_TOL = TRAIN_LOSS_TOL   # phase 6's card bars: loss 1e-4,
DIST_GRAD_TOL = TRAIN_GRAD_TOL   # gradients and parameters 5e-3 of scale


def step_parts(torch, state, step, batch, seed):
    """One more train step, timed in parts with the card synchronized
    around each (so the parts add up to a little more than a step):
    {"step", "optimizer" (clip + Adam), "ema", "forward_backward" (the
    rest: the draws, the loss, its backward and FSDP2's collectives)}."""
    from text2protein_tpu_torch.training import steps as steps_mod

    ms = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t) * 1e3
            return out
        return call

    opt_step, ema = state.optimizer.step, steps_mod.ema_update
    state.optimizer.step = timed("optimizer", opt_step)
    steps_mod.ema_update = timed("ema", ema)
    try:
        timed("step", step)(state, batch, seed)
    finally:
        state.optimizer.step, steps_mod.ema_update = opt_step, ema
    ms["forward_backward"] = ms["step"] - ms["optimizer"] - ms["ema"]
    return ms


def dist_rank(records, data, model, ckpt):
    """One rank of phase 23: DIST_STEPS steps of bench_l128_config() at
    batch 16 on the first batches of phase 6's records, sharded over the
    data x model mesh (FSDP2), with each step's flash launches; on rank 0
    also the plain one-device steps on the same batches (first) and the
    comparison, and the gathered checkpoint written, restored into a
    one-device state and saved again, bit for bit."""
    import numpy as np
    import torch

    from text2protein_tpu_torch import use_full_f32
    from text2protein_tpu_torch.cli.train import (
        split_dataset,
        train_batches_from,
    )
    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.config import bench_l128_config
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import build_model, init_params
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.parallel.mesh import (
        full_tensor,
        init_distributed,
        make_mesh,
        shard_batch,
        shard_train_state,
    )
    from text2protein_tpu_torch.text.encoder import build_text_encoder
    from text2protein_tpu_torch.training.checkpoint import (
        load_slot,
        read_slot,
        state_slot,
    )
    from text2protein_tpu_torch.training.state import create_train_state
    from text2protein_tpu_torch.training.steps import make_train_step

    info = init_distributed("cuda")
    dev = info.device
    use_full_f32()
    config = bench_l128_config()
    ds = ProteinProcessedDataset(records)
    train_idx, _ = split_dataset(len(ds), config.seed)
    stream = train_batches_from(ds, train_idx, TRAIN_BATCH,
                                config.data.max_res_num, config.seed, 0)
    host = [next(stream) for _ in range(DIST_STEPS)]
    encoder = build_text_encoder(config)
    ctx = [dict(zip(("context", "context_mask"), encoder.encode(b["caption"])))
           for b in host]
    sde, _ = get_sde(config)

    def prepare(b, c, mesh):
        arrays = batch_to_device_arrays(shard_batch(mesh, b), config,
                                        device=dev)
        for k, v in shard_batch(mesh, c).items():
            arrays[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        return arrays

    def run(mesh):
        model = init_params(build_model(config, device=dev),
                            torch.Generator().manual_seed(int(config.seed)))
        state = create_train_state(config, model)
        if mesh is not None:
            shard_train_state(state, mesh)
        step = make_train_step(config, sde, model, mesh)
        out = {"losses": [], "ms": [], "fwd": [], "bwd": []}
        for b, c in zip(host, ctx):
            batch = prepare(b, c, mesh)
            torch.cuda.synchronize()
            flash.flash_attention_fwd.launches = 0
            flash.flash_attention_bwd.launches = 0
            t0 = time.perf_counter()
            out["losses"].append(float(step(state, batch, config.seed + 1)))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["fwd"].append(flash.flash_attention_fwd.launches)
            out["bwd"].append(flash.flash_attention_bwd.launches)
        out["parts_ms"] = step_parts(torch, state, step,
                                     prepare(host[0], ctx[0], mesh),
                                     config.seed + 1)
        # the last step's (clipped) gradients and the parameters, whole
        grads = {k: full_tensor(p.grad) for k, p in
                 state.model.named_parameters()}
        params = {k: full_tensor(p.detach()) for k, p in
                  state.model.named_parameters()}
        return state, out, grads, params

    res = {"rank": info.rank}
    if info.rank == 0:
        _, plain, p_grads, p_params = run(None)
        res["plain"] = plain
    mesh = make_mesh(data, model, device=dev)
    state, sharded, s_grads, s_params = run(mesh)
    res["sharded"] = sharded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = state_slot(state, config)
    res["gather_s"] = time.perf_counter() - t0
    if info.rank != 0:
        return res
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(sharded["losses"], plain["losses"]))
    grad_worst, grad_key = worst_grad_diff(s_grads, p_grads)
    param_worst, param_key = worst_grad_diff(s_params, p_params)
    t0 = time.perf_counter()
    torch.save(slot, ckpt)
    res["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = create_train_state(config, build_model(config, device=dev))
    load_slot(one, read_slot(ckpt))
    again = state_slot(one, config)
    res["restore_s"] = time.perf_counter() - t0

    def tensors(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from tensors(v, f"{prefix}/{k}")
        elif isinstance(obj, torch.Tensor):
            yield prefix, obj

    a, b = dict(tensors(slot)), dict(tensors(again))
    res["ckpt_tensors"] = len(a)
    res["ckpt_bitwise"] = a.keys() == b.keys() and all(
        torch.equal(v, b[k]) for k, v in a.items())
    res["ckpt_bytes"] = Path(ckpt).stat().st_size
    Path(ckpt).unlink()
    res.update(loss_rel=loss_rel, grad_worst=grad_worst, grad_key=grad_key,
               param_worst=param_worst, param_key=param_key)
    return res


def phase_distributed(torch, smi, records):
    """Phase 23: the sharded bench_l128 train step on min(cards, 4) ranks
    (FSDP2, mesh.model 1) held to the plain steps, its flash launches, the
    gathered checkpoint bit for bit; on 2 cards or more also data 2, on 4
    also data 2 x model 2; then graft_entry.entry() on the card and
    dryrun_multichip on the same ranks."""
    import numpy as np

    from text2protein_tpu_torch import graft_entry
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.parallel.launch import spawn

    n = min(torch.cuda.device_count(), 4)
    # batch 16 splits over 1, 2 or 4 data ranks (3 cards run 2)
    data = 2 if n == 3 else n
    layouts = [(data, 1)] + [(2, 1)] * (data > 2) + [(2, 2)] * (data == 4)
    torch.cuda.empty_cache()
    WORK.mkdir(parents=True, exist_ok=True)
    runs, fwd, bwd = [], 0, 0
    per_step = FWD_PER_TRAIN_STEP + REMAT_FWD_PER_TRAIN_STEP  # 30
    for data, model in layouts:
        t0 = time.perf_counter()
        res = spawn(dist_rank, data * model,
                    args=(str(records), data, model,
                          str(WORK / "dist_checkpoint.pt")),
                    device="cuda", timeout=900, group_timeout=DIST_GROUP_S)
        seconds = time.perf_counter() - t0
        r0 = res[0]
        for r in res:
            sh = r["sharded"]
            if sh["losses"] != r0["sharded"]["losses"]:
                raise AssertionError(f"rank {r['rank']} losses "
                                     f"{sh['losses']} differ from rank 0's")
            if (sh["fwd"] != [per_step] * DIST_STEPS
                    or sh["bwd"] != [BWD_PER_TRAIN_STEP] * DIST_STEPS):
                raise AssertionError(
                    f"rank {r['rank']}: flash launches per sharded step "
                    f"fwd {sh['fwd']} bwd {sh['bwd']}, expected {per_step} "
                    f"and {BWD_PER_TRAIN_STEP}")
            fwd += sum(sh["fwd"])
            bwd += sum(sh["bwd"])
        plain, sharded = r0["plain"], r0["sharded"]
        ms_plain = float(np.median(plain["ms"][1:]))
        ms_sharded = float(np.median(sharded["ms"][1:]))
        log(f"distributed: data={data} x model={model} on {data * model} "
            f"card(s) ({smi}): bench_l128 at batch {TRAIN_BATCH}, "
            f"{DIST_STEPS} steps: losses {sharded['losses']} vs plain "
            f"{plain['losses']} (worst rel {r0['loss_rel']:.2e}, tol "
            f"{DIST_LOSS_TOL:.0e}); last step's gradients worst "
            f"{r0['grad_key']} {r0['grad_worst']:.2e}, parameters worst "
            f"{r0['param_key']} {r0['param_worst']:.2e} (tol "
            f"{DIST_GRAD_TOL:.0e}); flash launches per sharded step "
            f"{sharded['fwd'][0]} fwd + {sharded['bwd'][0]} bwd on every "
            f"rank")
        parts = {k: (f"{plain['parts_ms'][k]:.1f} / "
                     f"{sharded['parts_ms'][k]:.1f}")
                 for k in ("forward_backward", "optimizer", "ema", "step")}
        log(f"distributed: {ms_plain:.2f} ms per plain step, {ms_sharded:.2f}"
            f" ms per sharded step (median of steps 2-{DIST_STEPS}; all: "
            f"plain {', '.join(f'{x:.1f}' for x in plain['ms'])}; sharded "
            f"{', '.join(f'{x:.1f}' for x in sharded['ms'])}); checkpoint "
            f"gathered in {r0['gather_s']:.2f} s, written "
            f"({r0['ckpt_bytes'] / 2**20:.1f} MiB) in {r0['save_s']:.2f} s, "
            f"restored into one device and saved again in "
            f"{r0['restore_s']:.2f} s: {r0['ckpt_tensors']} tensors bit for "
            f"bit {r0['ckpt_bitwise']}; {seconds:.1f} s with the ranks' "
            f"start; one more step in parts, plain / sharded ms: {parts}")
        if not (r0["loss_rel"] < DIST_LOSS_TOL
                and r0["grad_worst"] < DIST_GRAD_TOL
                and r0["param_worst"] < DIST_GRAD_TOL
                and r0["ckpt_bitwise"]):
            raise AssertionError("the sharded step disagrees with the plain "
                                 "one, or the checkpoint (line above)")
        runs.append(dict(data=data, model=model, seconds=seconds,
                         ms_per_plain_step=ms_plain,
                         ms_per_sharded_step=ms_sharded,
                         **{k: v for k, v in r0.items() if k != "rank"}))

    fn, args = graft_entry.entry()
    flash.flash_attention_fwd.launches = 0
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    entry_launches = flash.flash_attention_fwd.launches
    if (tuple(out.shape) != (2, 128, 128, 5)
            or not bool(out.isfinite().all())
            or entry_launches != FWD_PER_TRAIN_STEP):
        raise AssertionError(f"entry(): shape {tuple(out.shape)}, launches "
                             f"{entry_launches}")
    fwd += entry_launches
    del fn, args, out
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(n)
    dry_s = time.perf_counter() - t0
    fwd += dry["fwd_launches"]
    bwd += dry["bwd_launches"]
    log(f"distributed: entry() forward on the card (2, 128, 128, 5), finite,"
        f" {entry_launches} flash_fwd launches; dryrun_multichip({n}): mesh "
        f"{dry['mesh']}, loss {dry['loss']:.4f}, sampler "
        f"{dry['samples'].shape} finite, nfe {dry['nfe']}, flash launches "
        f"fwd {dry['fwd_launches']} bwd {dry['bwd_launches']}, "
        f"{dry_s:.1f} s")
    return dict(ranks=n, runs=runs, fwd_launches=fwd, bwd_launches=bwd,
                entry_launches=entry_launches,
                dryrun={k: v for k, v in dry.items() if k != "samples"},
                dryrun_seconds=dry_s)


def first_train_batches(torch, config, records, b, steps):
    """The trainer's first `steps` batches of `records` at batch `b` (its
    data order from config.seed), on the card with their captions
    encoded."""
    from text2protein_tpu_torch.cli.train import (
        split_dataset,
        train_batches_from,
    )
    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    dev = torch.device("cuda")
    ds = ProteinProcessedDataset(records)
    train_idx, _ = split_dataset(len(ds), config.seed)
    stream = train_batches_from(ds, train_idx, b, config.data.max_res_num,
                                config.seed, 0)
    encoder = build_text_encoder(config)
    batches = []
    for _ in range(steps):
        host = next(stream)
        arrays = batch_to_device_arrays(host, config, device=dev)
        ctx, ctx_mask = encoder.encode(host["caption"])
        arrays["context"] = torch.from_numpy(ctx).to(dev)
        arrays["context_mask"] = torch.from_numpy(ctx_mask).to(dev)
        batches.append(arrays)
    return batches


def sp_against_plain(torch, config, batches, group):
    """Train steps of `config` on `batches` (seed config.seed + 1), plain
    and with the pair grid's rows over `group`, each from the JAX
    initializers drawn from config.seed: per run {"losses", "ms" (host,
    the card synchronized by the loss), "fwd", "bwd", "fwd_bf16",
    "bwd_bf16" (flash launches per step), "peak" (max_memory_allocated)};
    then the worst relative loss difference and the last step's worst
    gradient difference (`worst_grad_diff`) and its name."""
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import build_model, init_params
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.training.state import create_train_state
    from text2protein_tpu_torch.training.steps import make_train_step

    dev = torch.device("cuda")
    sde, _ = get_sde(config)
    counters = (flash.flash_attention_fwd, flash.flash_attention_bwd)

    def run(group):
        model = init_params(build_model(config, device=dev),
                            torch.Generator().manual_seed(int(config.seed)))
        state = create_train_state(config, model)
        step = make_train_step(config, sde, model, shard_grid=group or False)
        out = {k: [] for k in ("losses", "ms", "fwd", "bwd", "fwd_bf16",
                               "bwd_bf16")}
        for batch in batches:
            if group is not None:
                batch = group.shard_batch(batch)
            torch.cuda.synchronize()
            for c in counters:
                c.launches = c.launches_bf16 = 0
            t0 = time.perf_counter()
            out["losses"].append(float(step(state, batch, config.seed + 1)))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            for c, kind in zip(counters, ("fwd", "bwd")):
                out[kind].append(c.launches)
                out[kind + "_bf16"].append(c.launches_bf16)
        grads = {k: p.grad.detach().clone() for k, p in
                 state.model.named_parameters()}
        return out, grads

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain, p_grads = run(None)
    plain["peak"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sp, s_grads = run(group)
    sp["peak"] = torch.cuda.max_memory_allocated()
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(sp["losses"], plain["losses"]))
    grad_worst, grad_key = worst_grad_diff(s_grads, p_grads)
    del p_grads, s_grads
    torch.cuda.empty_cache()
    return plain, sp, loss_rel, grad_worst, grad_key


def report_sp(what, smi, runs, loss_tol, grad_tol, launches):
    """Log `sp_against_plain`'s `runs`; raise where a launch count differs
    from `launches` ({counter: per step}, 0 where absent) or a bar is
    missed. Returns the phase's record."""
    import numpy as np

    plain, sp, loss_rel, grad_worst, grad_key = runs
    ms_plain = float(np.median(plain["ms"][1:]))
    ms_sp = float(np.median(sp["ms"][1:]))
    counts = {k: sp[k] for k in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")}
    log(f"{what} ({smi}), {SP_STEPS} steps: losses {sp['losses']} vs "
        f"plain {plain['losses']} (worst rel {loss_rel:.2e}, tol "
        f"{loss_tol:.0e}); last step's gradients worst {grad_key} "
        f"{grad_worst:.2e} (tol {grad_tol:.0e}); flash launches per SP "
        f"step {counts} (plain "
        f"{ {k: plain[k] for k in counts} })")
    log(f"{what}: {ms_plain:.2f} ms per plain step, {ms_sp:.2f} ms per SP "
        f"step (median of steps 2-{SP_STEPS}; all: plain "
        f"{', '.join(f'{x:.1f}' for x in plain['ms'])}; SP "
        f"{', '.join(f'{x:.1f}' for x in sp['ms'])}); "
        f"max_memory_allocated plain {plain['peak'] / 2**30:.2f} GiB, SP "
        f"{sp['peak'] / 2**30:.2f} GiB")
    want = {k: [launches.get(k, 0)] * SP_STEPS for k in counts}
    if counts != want:
        raise AssertionError(f"flash launches per SP step {counts}, "
                             f"expected {want}")
    if not (np.isfinite(sp["losses"]).all() and loss_rel < loss_tol
            and grad_worst < grad_tol):
        raise AssertionError("the SP step disagrees with the plain one "
                             "(line above)")
    return dict(model=SP_MODEL, steps=SP_STEPS, losses=sp["losses"],
                plain_losses=plain["losses"], loss_rel=loss_rel,
                grad_worst=grad_worst, grad_key=grad_key, ms=sp["ms"],
                plain_ms=plain["ms"], ms_per_step=ms_sp,
                ms_per_plain_step=ms_plain, peak_bytes=sp["peak"],
                plain_peak_bytes=plain["peak"], launches_per_step=counts)


def phase_sequence_parallel(torch, smi, records):
    """Phase 24: both f32 kernels at every shape of the sequence-parallel
    train step against their plain versions and timed, then SP_STEPS train
    steps of bench_l128_config() at batch 16 with the pair grid's rows
    split over a stacked group of SP_MODEL ranks, against the plain steps
    from the same weights on the same batches (phase 6's first) and seed:
    the losses (rel SP_LOSS_TOL), the last step's gradients (TRAIN_GRAD_TOL
    of their scale), exactly 30 forward and 18 backward launches per SP
    step, ms per step of each."""
    from text2protein_tpu_torch.config import bench_l128_config
    from text2protein_tpu_torch.parallel.sequence import StackedRowGroup

    fwd_rows = phase_kernels(torch, SP_SHAPES, b=SP_BATCH)
    bwd_rows = phase_kernels_bwd(torch, SP_BWD_SHAPES, b=SP_BATCH)
    config = bench_l128_config()
    batches = first_train_batches(torch, config, records, TRAIN_BATCH,
                                  SP_STEPS)
    runs = sp_against_plain(torch, config, batches,
                            StackedRowGroup(SP_MODEL))
    out = report_sp(
        f"sequence parallel: bench_l128 at batch {TRAIN_BATCH}, the pair "
        f"grid's rows over a stacked group of {SP_MODEL}", smi, runs,
        SP_LOSS_TOL, TRAIN_GRAD_TOL,
        {"fwd": FWD_PER_TRAIN_STEP + REMAT_FWD_PER_TRAIN_STEP,  # 30
         "bwd": BWD_PER_TRAIN_STEP})
    return dict(out, fwd_launches=sum(runs[1]["fwd"]),
                bwd_launches=sum(runs[1]["bwd"]), fwd_rows=fwd_rows,
                bwd_rows=bwd_rows)


def phase_sequence_parallel_n256(torch, ptxas, smi, records):
    """Phase 25: both bf16 kernels at every shape of the quality_n256
    train step with the rows split over SP_MODEL stacked ranks against
    their plain versions and timed, then SP_STEPS train steps of
    quality_n256_config() as written with the rows split, against the
    plain steps from the same weights on phase 12's first batches: losses
    (rel SP256_LOSS_TOL), the last step's gradients (SP256_GRAD_TOL of
    their scale), exactly 80 bf16 forward and 32 bf16 backward launches
    per SP step and no f32 launch."""
    from text2protein_tpu_torch.config import quality_n256_config
    from text2protein_tpu_torch.parallel.sequence import StackedRowGroup

    fwd_rows, bwd_rows = phase_kernels_bf16(
        torch, ptxas, runs=(("fwd", SP256_SHAPES, SP256_BATCH),
                            ("bwd", SP256_BWD_SHAPES, SP256_BATCH)))
    config = quality_n256_config()
    batches = first_train_batches(torch, config, records, N256_TRAIN_BATCH,
                                  SP_STEPS)
    runs = sp_against_plain(torch, config, batches,
                            StackedRowGroup(SP_MODEL))
    out = report_sp(
        f"sequence parallel N=256: quality_n256.yml (bf16, remat, "
        f"featurization on the device) at batch {N256_TRAIN_BATCH}, the "
        f"pair grid's rows over a stacked group of {SP_MODEL}", smi, runs,
        SP256_LOSS_TOL, SP256_GRAD_TOL,
        {"fwd_bf16": N256_FWD_PER_TRAIN_STEP
         + N256_REMAT_FWD_PER_TRAIN_STEP,  # 80
         "bwd_bf16": N256_BWD_PER_TRAIN_STEP})  # 32
    return dict(out, fwd_launches=sum(runs[1]["fwd_bf16"]),
                bwd_launches=sum(runs[1]["bwd_bf16"]), fwd_rows=fwd_rows,
                bwd_rows=bwd_rows)


class _Lines:
    """The lines a process prints, read by a daemon thread."""

    def __init__(self, stream):
        import threading

        self.lines = []
        self.cond = threading.Condition()
        threading.Thread(target=self._read, args=(stream,),
                         daemon=True).start()

    def _read(self, stream):
        for line in stream:
            with self.cond:
                self.lines.append(line.rstrip("\n"))
                self.cond.notify_all()

    def wait_for(self, prefix, timeout, proc):
        """The first line that starts with `prefix`; raises if the process
        exits or `timeout` passes first."""
        def found():
            return next((x for x in self.lines if x.startswith(prefix)),
                        None)

        with self.cond:
            self.cond.wait_for(lambda: found() is not None
                               or proc.poll() is not None, timeout)
            line = found()
        if line is None:
            raise AssertionError(f"no line {prefix!r} from the server "
                                 f"(exit code {proc.poll()}); its output:\n"
                                 + "\n".join(self.lines[-40:]))
        return line


def _http(base, payload=None, path="/v1/sample"):
    """(status, response, seconds) of a GET (`payload` None) or POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_REQUEST_S) as r:
            return r.status, json.load(r), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), time.perf_counter() - t0


def phase_http(torch, smi, workdir, step):
    """Phase 26: the JAX server's command line on phase 6's best_eval (the
    EMA of training step `step`) as a process, driven over HTTP: /healthz,
    the batches formed from a burst, a seeded request, a pair inside the
    window, a realized request and a refused length; the launches the
    server counted."""
    import re
    import signal
    import threading

    import numpy as np

    from text2protein_tpu_torch.cli.serve import decode_coords

    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "text2protein_tpu_torch.cli.serve",
           str(DEPLOY_CONFIG.relative_to(ROOT)),
           str(workdir / "checkpoints" / "best_eval"),
           "--batch_size", str(HTTP_BATCH), "--sampler", "pc",
           "--num_steps", str(HTTP_STEPS), "--max_wait_ms",
           str(HTTP_WAIT_MS), "--warmup", "--realize", "--port", "0"]
    log(f"http: {' '.join(cmd[1:])}")
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out = _Lines(proc.stdout)
    try:
        line = out.wait_for("serving ", HTTP_START_S, proc)
        start_s = time.perf_counter() - t_start
        warmup = out.wait_for("warmup batch done in ", 1, proc)
        base = re.search(r"(http://[^ ]+)", line).group(1)
        status, health, _ = _http(base, path="/healthz")
        want = {"status": "ok", "step": step, "platform": "gpu",
                "batch_size": HTTP_BATCH, "max_res_num": 128,
                "sampler": "pc"}
        if status != 200 or health != want:
            raise AssertionError(f"/healthz {status} {health}, expected "
                                 f"{want}")
        log(f"http: {line} after {start_s:.1f}s ({warmup}); /healthz "
            f"{health}")

        replies = {}

        def post(name, req, gate=None):
            if gate is not None:
                gate.wait(HTTP_REQUEST_S)
            replies[name] = _http(base, req)

        gate = threading.Barrier(len(HTTP_BURST))
        burst = [threading.Thread(target=post, args=(f"burst{i}", r, gate))
                 for i, r in enumerate(HTTP_BURST)]
        t0 = time.perf_counter()
        for t in burst:
            t.start()
        time.sleep(HTTP_PAIR_GAP_S)  # the burst is queued or running
        seeded = threading.Thread(target=post, args=("seeded", HTTP_SEEDED))
        seeded.start()
        for t in burst:
            t.join(HTTP_REQUEST_S)
        burst_s = time.perf_counter() - t0
        seeded.join(HTTP_REQUEST_S)
        pair = threading.Thread(target=post, args=("pair0", HTTP_PAIR[0]))
        pair.start()
        time.sleep(HTTP_PAIR_GAP_S)
        post("pair1", HTTP_PAIR[1])
        pair.join(HTTP_REQUEST_S)
        post("realize", HTTP_REALIZE)
        post("refused", {"caption": "too short", "length": 1})
        post("seeded_alone", HTTP_SEEDED)

        reqs = {f"burst{i}": r for i, r in enumerate(HTTP_BURST)}
        reqs.update(seeded=HTTP_SEEDED, pair0=HTTP_PAIR[0],
                    pair1=HTTP_PAIR[1], realize=HTTP_REALIZE,
                    seeded_alone=HTTP_SEEDED)
        for name in reqs:
            if name not in replies or replies[name][0] != 200:
                raise AssertionError(f"http: {name} answered "
                                     f"{replies.get(name)}")
        if replies["refused"][0] != 400:
            raise AssertionError(f"http: length 1 answered "
                                 f"{replies['refused'][:2]}, expected 400")
        check_maps([replies[k][1] for k in reqs], list(reqs.values()), 128)
        # one seed a batch: the responses that share one formed a batch
        # (the seeded request re-sent alone, the last batch, left out)
        by_seed = {}
        for name in list(reqs)[:-1]:
            by_seed.setdefault(replies[name][1]["seed"], []).append(name)
        want_batches = [sorted(f"burst{i}" for i in range(len(HTTP_BURST))),
                        ["pair0", "pair1"], ["realize"], ["seeded"]]
        formed = sorted(sorted(b) for b in by_seed.values())
        if formed != sorted(want_batches):
            raise AssertionError(f"http: batches formed {formed}, the JAX "
                                 f"batcher's {sorted(want_batches)}")
        if not np.array_equal(decode_coords(replies["seeded"][1]),
                              decode_coords(replies["seeded_alone"][1])):
            raise AssertionError("http: the seeded map differs from the "
                                 "same request sent alone")
        pdb = replies["realize"][1].get("pdb", "")
        ca = [x for x in pdb.splitlines()
              if x.startswith("ATOM") and x[12:16].strip() == "CA"]
        if len(ca) != HTTP_REALIZE["length"]:
            raise AssertionError(f"http: the realized backbone has "
                                 f"{len(ca)} CA atoms")
        nfe = {replies[k][1]["nfe"] for k in reqs}
        latency = {k: round(replies[k][2], 3) for k in replies}
        per_min = len(HTTP_BURST) * 60 / burst_s
        log(f"http: batches formed {formed} (the JAX batcher's); latency "
            f"s {latency}; the burst of {len(HTTP_BURST)} in {burst_s:.3f}s "
            f"({per_min:.2f} samples/min at {HTTP_STEPS} PC steps, batch "
            f"{HTTP_BATCH}); nfe {sorted(nfe)}; seeded map = sent alone; "
            f"realized: {len(ca)} CA atoms, energy "
            f"{replies['realize'][1]['energy']:.1f}; length 1: HTTP 400")
        proc.send_signal(signal.SIGINT)
        stopped = out.wait_for("stopped after ", HTTP_START_S, proc)
        rc = proc.wait(HTTP_START_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # batches run; flash launches forward f32, bf16, backward f32, bf16
    counts = [int(x) for x in re.fullmatch(
        r"stopped after (\d+) batches; flash launches: forward (\d+) f32, "
        r"(\d+) bf16; backward (\d+) f32, (\d+) bf16", stopped).groups()]
    ran = counts[0]
    # + the seeded request alone and the warm-up
    want_counts = [len(want_batches) + 2,
                   ran * max(nfe) * DEPLOY_LAUNCHES_PER_EVAL, 0, 0, 0]
    if rc != 0 or len(nfe) != 1 or counts != want_counts:
        raise AssertionError(f"http: server exit code {rc}, {stopped!r}; "
                             f"expected exit 0, batches and launches "
                             f"{want_counts}, one "
                             f"nfe {nfe}")
    log(f"http: {stopped} (the warm-up included: {ran} x {max(nfe)} nfe "
        f"x {DEPLOY_LAUNCHES_PER_EVAL}), exit code 0 ({smi})")
    return dict(command=cmd[1:], start_s=start_s, warmup=warmup,
                healthz=health, batches=formed, latency_s=latency,
                burst_s=burst_s, burst_samples_per_min=per_min,
                nfe=max(nfe), stopped=stopped, launches=counts[1])


class BucketLog:
    """Records the token width of every hash-encoder call while entered:
    the caption buckets the paths took."""

    def __enter__(self):
        from text2protein_tpu_torch.text import encoder

        self.widths = []
        self._cls, self._real = encoder.HashTextEncoder, (
            encoder.HashTextEncoder.encode)
        real, widths = self._real, self.widths

        def encode(enc, captions):
            out = real(enc, captions)
            widths.append(int(out[0].shape[1]))
            return out

        self._cls.encode = encode
        return self

    def __exit__(self, *exc):
        self._cls.encode = self._real


def reset_launches():
    from text2protein_tpu_torch.ops import flash

    for c in (flash.flash_attention_fwd, flash.flash_attention_bwd):
        c.launches = c.launches_bf16 = 0


def read_launches():
    """(f32 forward, f32 backward, bf16 forward, bf16 backward)."""
    from text2protein_tpu_torch.ops import flash

    f, b = flash.flash_attention_fwd, flash.flash_attention_bwd
    return f.launches, b.launches, f.launches_bf16, b.launches_bf16


def check_train_run(what, res, steps, want):
    """A cli/train.main result: finite losses and eval loss, the launches
    (f32 fwd, f32 bwd, bf16 fwd, bf16 bwd) exactly `want`."""
    import numpy as np

    got = read_launches()
    if len(res["losses"]) != steps or not (
            np.isfinite(res["losses"]).all()
            and np.isfinite(res["eval_loss"])):
        raise AssertionError(f"{what}: losses {res['losses']}, eval "
                             f"{res['eval_loss']}")
    if got != want:
        raise AssertionError(f"{what}: launches (f32 fwd, f32 bwd, bf16 fwd,"
                             f" bf16 bwd) {got}, expected {want}")
    return got


def abstract_requests(seed, tokens, lengths, seeded=None):
    from text2protein_tpu_torch.data.helix_records import abstract_caption
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = [{"caption": abstract_caption(rng, t), "length": n}
            for t, n in zip(tokens, lengths)]
    if seeded is not None:
        reqs[0]["seed"] = seeded
    return reqs


# test_config's sampling batch: past the 512-token cut, the first seeded
REF_REQUESTS = ((600, 30, 450, 290), (233, 64, 140, 256), 97531)


def phase_kernels_reference(torch, ptxas):
    """The f32 kernels at the shapes of the reference configurations, each
    against its plain version: test_config's forward at its sampling batch
    4 and backward at its training batch 2 (timed at the REF_TK bucket;
    the cross-attention also over the other REF_BUCKETS), the 8x8 level of
    test_config_large at batch 2 (the AttnBlock at D=1024, heads of 128),
    the caption configs' cross-attention at batch 8 over every bucket from
    128 to 512; the bf16 forward at test_config_large's 8x8 shapes at
    batch 1 (D=1024 on a cluster of two blocks) and its backward at batch
    2 (D=1024 on the mma.sync kernels), and the bf16 forward at every
    call of bench_l128's PC step at batch 16."""
    def other_buckets(shapes, buckets):
        return [(f"{n}_tk{tk}", h, tq, tk, d, m, c)
                for n, h, tq, _, d, m, c in shapes if m
                for tk in buckets if tk != REF_TK]

    fwd = phase_kernels(torch, REF_SHAPES, lengths=(0, 37, 300),
                        b=REF_BATCH)
    bwd = phase_kernels_bwd(torch, REF_BWD_SHAPES, b=REF_TRAIN_BATCH)
    checked = phase_kernels(torch, other_buckets(REF_SHAPES, REF_BUCKETS),
                            lengths=(0, 37, 300), b=REF_BATCH, timed=False)
    checked += phase_kernels_bwd(
        torch, other_buckets(REF_BWD_SHAPES, REF_BUCKETS),
        b=REF_TRAIN_BATCH, timed=False)
    large_fwd = phase_kernels(torch, REF_LARGE_SHAPES, lengths=(0, 300),
                              b=REF_TRAIN_BATCH)
    large_bwd = phase_kernels_bwd(torch, REF_LARGE_SHAPES,
                                  b=REF_TRAIN_BATCH)
    checked += phase_kernels(
        torch, other_buckets(REF_LARGE_SHAPES, REF_BUCKETS),
        lengths=(0, 300), b=REF_TRAIN_BATCH, timed=False)
    checked += phase_kernels_bwd(
        torch, other_buckets(REF_LARGE_SHAPES, REF_BUCKETS),
        b=REF_TRAIN_BATCH, timed=False)
    caption_fwd = phase_kernels(torch, CAPTION_SHAPES, lengths=(0, 37, 300),
                                b=CAPTION_BATCH, timed=False)
    caption_bwd = phase_kernels_bwd(torch, CAPTION_SHAPES, b=CAPTION_BATCH,
                                    timed=False)
    large16_fwd, large16_bwd = phase_kernels_bf16(
        torch, ptxas, runs=(("fwd", REF_LARGE_BF16_SHAPES, 1),
                            ("bwd", REF_LARGE_BF16_SHAPES, REF_TRAIN_BATCH)),
        seed=7)
    bench16_fwd, _ = phase_kernels_bf16(
        torch, ptxas, runs=(("fwd", BENCH_BF16_SHAPES, BENCH_BF16_BATCH),),
        seed=9)
    return dict(fwd_rows=fwd, bwd_rows=bwd, large_fwd_rows=large_fwd,
                large_bwd_rows=large_bwd, checked=checked,
                caption_fwd=caption_fwd, caption_bwd=caption_bwd,
                large_bf16_fwd_rows=large16_fwd,
                large_bf16_bwd_rows=large16_bwd,
                bench_bf16_fwd_rows=bench16_fwd)


def phase_reference_config(torch, records):
    """test_config.yml as written (f32, no remat of the residual blocks,
    batch 2) through cli/train.main on N=256 helix records with
    abstract-length captions, its end-of-run snapshot sample cut to
    REF_SNAPSHOT_STEPS PC steps; then a Server from the checkpoint it
    wrote answers a batch of 4 over REF_STEPS PC steps."""
    import pickle

    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import load_config

    config = load_config(REF_CONFIG)
    p = attn_pairs(config)
    if (config.training.batch_size, str(config.model.get("dtype",
                                                           "float32")),
            p, config.training.snapshot_sampling) != (
                REF_TRAIN_BATCH, "float32", 16, True):
        raise AssertionError("test_config.yml is not the f32 batch-2 model "
                             "with 16 attention pairs and snapshot sampling")
    steps = REF_WARMUP + REF_TIMED
    real_sampling_fn = train.get_sampling_fn

    def snapshot_sampling_fn(*a, **k):
        return real_sampling_fn(*a, **dict(k, num_steps=REF_SNAPSHOT_STEPS))

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    train.get_sampling_fn = snapshot_sampling_fn
    try:
        with BucketLog() as buckets:
            res = train.main(["--config", str(REF_CONFIG), "--data",
                              str(records), "--max_steps", str(steps),
                              "--workdir_root", str(WORK / "training_ref")])
    finally:
        train.get_sampling_fn = real_sampling_fn
    peak = torch.cuda.max_memory_allocated()
    # 3 calls a pair, the transformer blocks' self and cross again in the
    # backward's recompute; the eval batch; the snapshot's 2 evaluations a
    # PC step
    want_fwd = (5 * p * steps + 3 * p + 3 * p * 2 * REF_SNAPSHOT_STEPS)
    launches = check_train_run("test_config training", res, steps,
                               (want_fwd, 3 * p * steps, 0, 0))
    workdir = res["workdir"]
    pkls = sorted(workdir.glob("samples/epoch_*/sample.pkl"))
    if len(pkls) != 1:
        raise AssertionError(f"snapshot samples {pkls}")
    with open(pkls[0], "rb") as f:
        snap = pickle.load(f)
    if snap.shape != (REF_TRAIN_BATCH, 5, 256, 256) or not np.isfinite(
            snap).all():
        raise AssertionError(f"snapshot sample {snap.shape}")
    # the weights moved: the EMA (decay 0.999) stands apart from them
    state = res["state"]
    n_params = sum(p.numel() for p in state.model.parameters())
    named = dict(state.model.named_parameters())
    ema_apart = sum(not torch.equal(named[k].detach(), v)
                    for k, v in state.ema.params.items())
    if ema_apart < len(named) // 2:
        raise AssertionError(f"{ema_apart} of {len(named)} EMA params apart "
                             f"from the params")
    del state
    secs = res["step_seconds"]
    timed = np.asarray(secs[REF_WARMUP:]) * 1e3
    ms = float(np.median(timed))
    log(f"reference config: test_config.yml (f32, N=256, {n_params} params) "
        f"at batch {REF_TRAIN_BATCH}, {steps} steps on {res['records']} "
        f"records: losses {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} "
        f"(all finite), eval (EMA) {res['eval_loss']:.4f}; flash_fwd "
        f"launches {launches[0]} (= {5 * p} x {steps} + {3 * p} eval + "
        f"{3 * p} x 2 x {REF_SNAPSHOT_STEPS} snapshot), flash_bwd "
        f"{launches[1]} (= {3 * p} x {steps}), bf16 0; snapshot sample "
        f"{snap.shape} finite; {ema_apart} of {len(named)} EMA tensors "
        f"apart from the weights; caption buckets "
        f"{sorted(set(buckets.widths))}")
    log(f"reference config: {ms:.2f} ms per train step (median of the last "
        f"{REF_TIMED}: {', '.join(f'{x:.1f}' for x in timed)}; first "
        f"{REF_WARMUP}: {', '.join(f'{x * 1e3:.1f}' for x in secs[:REF_WARMUP])}"
        f" ms), max_memory_allocated {peak / 2**30:.2f} GiB")
    del res, named
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    server = Server(config, batch_size=REF_BATCH, num_steps=REF_STEPS,
                    checkpoint=workdir, device="cuda")
    log(f"reference config: Server from the EMA of step {server.step} of "
        f"{workdir.relative_to(ROOT)} built in {time.perf_counter() - t:.2f}s")
    tokens, lengths, seed = REF_REQUESTS
    reqs = abstract_requests(40, tokens, lengths, seed)
    # one evaluation at the batch's shapes first: cuDNN's search
    t = time.perf_counter()
    with torch.inference_mode():
        server.model(torch.zeros((REF_BATCH, 256, 256, 5), device="cuda"),
                     torch.zeros(REF_BATCH, device="cuda"),
                     *(torch.from_numpy(a).cuda() for a in
                       server.encoder.encode([r["caption"] for r in reqs])))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    with BucketLog() as served:
        reset_launches()
        t = time.perf_counter()
        results = server.run_batch(reqs)
        batch_s = time.perf_counter() - t
    sampled = read_launches()
    if sampled != (3 * p * 2 * REF_STEPS, 0, 0, 0):
        raise AssertionError(f"test_config sampling launches {sampled}")
    check_maps(results, reqs, 256)
    sample_peak = torch.cuda.max_memory_allocated()
    ms_pc = batch_s / REF_STEPS * 1e3
    log(f"reference config: sampling at batch {REF_BATCH} over {REF_STEPS} "
        f"PC steps (after one evaluation with cuDNN's search, "
        f"{warm_s:.2f}s): {batch_s:.3f}s, flash_fwd {sampled[0]} (= "
        f"{3 * p} x 2 x {REF_STEPS}), maps finite (5, 256, 256), last "
        f"channel = length mask; caption bucket {served.widths}; "
        f"{ms_pc:.2f} ms per PC step; max_memory_allocated "
        f"{sample_peak / 2**30:.2f} GiB")
    del server
    shutil.rmtree(workdir)  # two 6 GB slots
    torch.cuda.empty_cache()
    return dict(ms_per_train_step=ms, train_ms=timed.tolist(),
                step_seconds=secs, peak_train_bytes=peak,
                warm_seconds=warm_s, batch_seconds=batch_s,
                ms_per_pc_step=ms_pc, peak_sampling_bytes=sample_peak,
                fwd_launches=launches[0] + sampled[0],
                bwd_launches=launches[1], train_buckets=buckets.widths,
                sampling_buckets=served.widths, n_params=n_params)


def phase_reference_config_cpu(torch, records):
    """test_config.yml at B=1 from the same random weights: one score
    evaluation and one train step (dropout 0, injected t, z) on the card
    against the CPU (score rel 1e-4; loss 1e-4, gradients 5e-3 of scale)."""
    from text2protein_tpu_torch.config import load_config

    config = load_config(REF_CONFIG)
    p = attn_pairs(config)
    r = train_step_card_vs_cpu(torch, config, records, 5, seed=3,
                               score=True)
    log(f"reference config: test_config score at B=1 (caption "
        f"{r['caption_tokens']} keys), GPU vs CPU rel max diff "
        f"{r['score_rel_diff']:.2e} (tol {E2E_TOL:.0e}), "
        f"{r['score_launches']} flash_fwd launches; CPU "
        f"{r['score_cpu_seconds']:.1f}s")
    if not (r["score_rel_diff"] < E2E_TOL and r["score_launches"] == 3 * p):
        raise AssertionError("test_config: GPU score vs CPU score")
    check_train_reference("reference config: test_config train step at B=1",
                          r, 3 * p)
    return r


def phase_reference_variants(torch, records):
    """pod_config.yml and test_config_large.yml as written (f32, batch 1
    and 2): one PC step of a Server with seeded random weights at the
    yml's batch, then one train step of those weights through the
    trainer's step (`training.steps.make_train_step`, what cli/train.main
    runs each step; the trainer's checkpoint slots would be 2 x 8 GB and
    2 x 14 GB) on a batch of the records; then test_config_large in bf16
    (bench.py's dtype): one forward at batch 1 with the same weights, the
    AttnBlock at D=1024 on the bf16 forward's 2-block clusters, against
    the same forward with the plain attention."""
    import numpy as np

    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import build_model
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import build_text_encoder
    from text2protein_tpu_torch.training.state import create_train_state
    from text2protein_tpu_torch.training.steps import make_train_step

    def pc_then_step(path, tokens, first):
        config = load_config(path)
        p, b = attn_pairs(config), config.training.batch_size
        server = Server(config, batch_size=b, num_steps=1, device="cuda",
                        weight_seed=0)
        reqs = abstract_requests(60, tokens, (256, 133)[:b])
        reset_launches()
        t = time.perf_counter()
        with BucketLog() as served:
            results = server.run_batch(reqs)
        pc_s = time.perf_counter() - t
        sampled = read_launches()
        if sampled != (3 * p * 2, 0, 0, 0):
            raise AssertionError(f"{path.name} PC step launches {sampled}, "
                                 f"expected {3 * p * 2} f32 forward")
        check_maps(results, reqs, 256)
        weights = server.model.state_dict()
        del server
        torch.cuda.reset_peak_memory_stats()
        model = build_model(config, device="cuda")
        model.load_state_dict(weights)
        sde, _ = get_sde(config)
        state = create_train_state(config, model)
        step = make_train_step(config, sde, model)
        ds = ProteinProcessedDataset(records)
        host = make_batch([ds[i] for i in range(first, first + b)],
                          config.data.max_res_num)
        batch = batch_to_device_arrays(host, config, device="cuda")
        with BucketLog() as buckets:
            ctx = build_text_encoder(config).encode(host["caption"])
        batch["context"], batch["context_mask"] = (
            torch.from_numpy(a).cuda() for a in ctx)
        reset_launches()
        t = time.perf_counter()
        loss = float(step(state, batch, 0))
        secs = time.perf_counter() - t
        got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        # the first step runs at lr 0 (warmup): its gradients, not its
        # update
        graded = sum(q.grad is not None and bool(q.grad.isfinite().all())
                     and bool(q.grad.any()) for q in model.parameters())
        n_tensors = len(list(model.parameters()))
        if got != (5 * p, 3 * p, 0, 0) or not np.isfinite(loss) or (
                graded < n_tensors // 2):
            raise AssertionError(f"{path.name} step: loss {loss}, launches "
                                 f"{got}, {graded} of {n_tensors} gradients "
                                 f"finite and nonzero")
        del state, step, model, batch
        torch.cuda.empty_cache()
        log(f"reference variants: {path.name} (f32, {p} attention pairs, "
            f"batch {b}): one PC step of a Server (seeded random weights): "
            f"{pc_s:.2f}s, flash_fwd {sampled[0]} (= {3 * p} x 2), maps "
            f"finite, last channel = length mask, bucket {served.widths}; "
            f"one train step of those weights (training.steps): loss "
            f"{loss:.4f}, {secs:.2f}s with cuDNN's search, flash_fwd "
            f"{got[0]} (= {5 * p}), flash_bwd {got[1]}, {graded} of "
            f"{n_tensors} gradients finite and nonzero; caption bucket "
            f"{buckets.widths}; max_memory_allocated {peak / 2**30:.2f} GiB")
        return dict(pairs=p, batch=b, train_seconds=secs, loss=loss,
                    peak_bytes=peak, pc_seconds=pc_s, launches=got,
                    pc_launches=sampled,
                    buckets=buckets.widths + served.widths), weights, ctx

    out = {}
    # the requests' and records' captions take the 256-, 384-, 192- and
    # 512-key buckets
    out["pod_config"], _, _ = pc_then_step(REF_POD_CONFIG, (230,), 9)
    out["test_config_large"], weights, ctx = pc_then_step(REF_LARGE_CONFIG,
                                                          (170, 60), 0)

    # test_config_large in bf16, the same weights
    config = load_config(REF_LARGE_CONFIG)
    config.model.dtype = "bfloat16"
    p = attn_pairs(config)
    model = build_model(config, device="cuda")
    model.load_state_dict(weights)
    del weights
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((1, 256, 256, 5)) * 10)
                         .astype(np.float32)).cuda()
    labels = torch.tensor([700.0], device="cuda")
    ctx, mask = (torch.from_numpy(a[:1]).cuda() for a in ctx)
    reset_launches()
    with torch.inference_mode():
        got16 = model(x, labels, ctx, mask).float()
        launched = read_launches()
        kernel_fwd = flash.flash_attention_fwd
        flash.flash_attention_fwd = flash.flash_attention_fwd_reference
        try:
            plain16 = model(x, labels, ctx, mask).float()
        finally:
            flash.flash_attention_fwd = kernel_fwd
    if launched != (0, 0, 3 * p, 0) or not bool(torch.isfinite(got16).all()):
        raise AssertionError(f"test_config_large bf16 forward: launches "
                             f"{launched}, finite "
                             f"{bool(torch.isfinite(got16).all())}")
    gap = ((got16 - plain16).abs().max() / plain16.abs().max()).item()
    log(f"reference variants: test_config_large.yml in bf16 (bench.py's "
        f"dtype), one forward at batch 1: {launched[2]} bf16 flash_fwd "
        f"launches (= 3 x {p}; the 8x8 AttnBlock at D=1024 on 2-block "
        f"clusters), finite; against the same forward with the plain "
        f"attention: rel max diff {gap:.2e} (reported)")
    del model
    torch.cuda.empty_cache()
    out["large_bf16"] = dict(launches=launched[2], kernels_vs_plain=gap)
    runs = (out["pod_config"], out["test_config_large"])
    return dict(out, fwd_launches=sum(r["launches"][0] + r["pc_launches"][0]
                                      for r in runs),
                bwd_launches=sum(r["launches"][1] for r in runs),
                fwd_bf16_launches=launched[2])


def check_pickles(out_dir, n_want, c, cond):
    """Each pickle (1, c, 128, 128), finite; the conditions of `cond`
    clamped: SS channels, the entries outside the inpainting region, the
    length mask as the last channel."""
    import pickle

    import numpy as np

    pickles = sorted(out_dir.glob("*.pkl"))
    if len(pickles) != n_want:
        raise AssertionError(f"{len(pickles)} pickles, expected {n_want}")
    for p in pickles:
        with open(p, "rb") as f:
            a = pickle.load(f)
        if a.shape != (1, c, 128, 128) or not np.isfinite(a).all():
            raise AssertionError(f"{p.name}: {a.shape}")
        x = a[0].transpose(1, 2, 0)
        ok = np.array_equal(x[..., -1], cond["length"][0].cpu().numpy())
        if "ss" in cond:
            ok &= np.array_equal(x[..., 4:7], cond["ss"][0].cpu().numpy())
        if "inpainting" in cond:
            free = cond["inpainting"]["mask_inpaint"][0].cpu().numpy()
            coords = cond["inpainting"]["coords_6d"][0].cpu().numpy()
            ok &= np.array_equal(x[~free], coords[~free])
        if not ok:
            raise AssertionError(f"{p.name}: the conditions are not clamped")
    return len(pickles)


def phase_caption_family(torch):
    """The 4096-wide caption configs at L=128 (batch 8) as written, on C=5
    and C=8 helix records with abstract-length captions:
    cond_ss_inpainting.yml through cli/train.main for 3 steps, then
    cli/sampling_6d --pdb --mask_info at 4 PC steps; cond_length,
    cond_length_no_ss, cond_length_inpainting, cond_ss and no_cond one
    train step and 2 PC steps each (--pdb where the yml conditions on SS
    or inpainting, else --select_length)."""
    from text2protein_tpu_torch.cli import sampling_6d, train
    from text2protein_tpu_torch.conditioning import get_conditions_from_pdb
    from text2protein_tpu_torch.conditioning import get_mask_all_lengths
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.data import helix_records
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.data.pdbio import write_backbone_pdb

    records = {}
    for c, n in CAPTION_RECORDS.items():
        records[c] = WORK / f"caption_records_c{c}"
        helix_records.write_records(
            records[c], n, lengths=(64, 128), seed=10 + c, num_channels=c,
            captions=helix_records.abstract_captions(n, seed=c))
    rec = ProteinProcessedDataset(records[8])[0]
    pdb = WORK / "caption_condition.pdb"
    write_backbone_pdb(pdb, rec["coords"], seq=rec["aa_str"])
    out, fwd_launches, bwd_launches, all_buckets = {}, 0, 0, set()
    for name, c, steps, how, pc_steps in CAPTION_FAMILY:
        path = ROOT / "configs" / name
        config = load_config(path)
        p = attn_pairs(config)
        if (config.data.num_channels, config.model.context_dim,
                config.training.batch_size, p) != (c, 4096, CAPTION_BATCH,
                                                   6):
            raise AssertionError(f"{name}: not C={c}, 4096 wide, batch "
                                 f"{CAPTION_BATCH}, 6 attention pairs")
        reset_launches()
        with BucketLog() as buckets:
            res = train.main(["--config", str(path), "--data",
                              str(records[c]), "--max_steps", str(steps),
                              "--workdir_root",
                              str(WORK / "training_caption")])
        got = check_train_run(name, res, steps, (5 * p * steps + 3 * p,
                                                 3 * p * steps, 0, 0))
        workdir, secs, losses = (res["workdir"], res["step_seconds"],
                                 res["losses"])
        del res
        if how == "pdb":
            flags = ["--pdb", str(pdb), "--chain", "A", "--mask_info",
                     SS_MASK_INFO]
            cond = get_conditions_from_pdb(str(pdb), config, "A",
                                           SS_MASK_INFO, batch_size=1)
        else:
            flags = ["--select_length", "--length_index",
                     str(CAPTION_LENGTH_INDEX)]
            cond = {"length": get_mask_all_lengths(config, batch_size=1)[
                CAPTION_LENGTH_INDEX - 1]}
        reset_launches()
        t = time.perf_counter()
        with BucketLog() as sampled_buckets:
            s = sampling_6d.main([
                str(path), str(workdir / "checkpoints" / "best_eval.pt"),
                *flags, "--sampler", "pc", "--num_steps", str(pc_steps),
                "--batch_size", str(CAPTION_BATCH), "--processed_dir",
                str(records[c]), "--workdir_root",
                str(WORK / "sampling_caption")])
        cli_s = time.perf_counter() - t
        sampled = read_launches()
        if sampled != (pc_steps * 2 * 3 * p, 0, 0, 0):
            raise AssertionError(f"{name} sampling launches {sampled}")
        # one pickle per held-out id of the first full batch (the ids
        # cycle to fill it)
        ids = (workdir / "test_ids.txt").read_text().split()
        n_pkl = check_pickles(s["workdir"], len(set(
            (ids * CAPTION_BATCH)[:CAPTION_BATCH])), c, cond)
        shutil.rmtree(workdir)
        shutil.rmtree(s["workdir"])
        fwd_launches += got[0] + sampled[0]
        bwd_launches += got[1]
        all_buckets |= set(buckets.widths) | set(sampled_buckets.widths)
        log(f"caption family: {name} (C={c}, {config.model.condition}) "
            f"{steps} train step(s) at batch {CAPTION_BATCH}: losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, eval finite; step "
            f"{', '.join(f'{x * 1e3:.1f}' for x in secs)} ms; flash_fwd "
            f"{got[0]} (= {5 * p} x {steps} + {3 * p} eval), flash_bwd "
            f"{got[1]} (= {3 * p} x {steps}); buckets {buckets.widths}; "
            f"sampling_6d {' '.join(flags[:1])} at {pc_steps} PC steps, batch "
            f"{CAPTION_BATCH}: {n_pkl} pickles (1, {c}, 128, 128) finite, "
            f"conditions clamped, last channel = length mask, flash_fwd "
            f"{sampled[0]} (= {pc_steps} x 2 x {3 * p}), bucket "
            f"{sampled_buckets.widths}, {cli_s:.2f}s with the restore; "
            f"sampler {', '.join(f'{x:.3f}' for x in s['sample_seconds'])} s")
        out[name] = dict(losses=losses, step_seconds=secs, launches=got,
                         sampling_launches=sampled,
                         sample_seconds=s["sample_seconds"],
                         buckets=buckets.widths,
                         sampling_buckets=sampled_buckets.widths)
    return dict(out, fwd_launches=fwd_launches, bwd_launches=bwd_launches,
                buckets=sorted(all_buckets))


def phase_bench_bf16(torch):
    """bench.py's default: bench_l128.yml with model.dtype bfloat16, a
    Server at batch 16 over BENCH_BF16_STEPS PC steps, two batches: bf16
    forward launches only (36 a PC step), maps checked; ms per PC step
    from the second batch (a smoke line, not a benchmark)."""
    import numpy as np

    from text2protein_tpu_torch.cli.serve import Server
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.data.helix_records import CAPTIONS

    config = load_config(BENCH_CONFIG)
    config.model.dtype = "bfloat16"
    p = attn_pairs(config)
    server = Server(config, batch_size=BENCH_BF16_BATCH,
                    num_steps=BENCH_BF16_STEPS, device="cuda",
                    weight_seed=0)
    rng = np.random.default_rng(5)
    seconds, launches = [], 0
    for i in range(2):
        reqs = [{"caption": CAPTIONS[j % len(CAPTIONS)],
                 "length": int(rng.integers(40, 129))}
                for j in range(BENCH_BF16_BATCH)]
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with BucketLog() as buckets:
            results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = read_launches()
        if got != (0, 0, 3 * p * 2 * BENCH_BF16_STEPS, 0):
            raise AssertionError(f"bench_l128 bf16 launches {got}")
        launches += got[2]
        check_maps(results, reqs, 128)
    ms = seconds[-1] / BENCH_BF16_STEPS * 1e3
    log(f"bench bf16: bench_l128.yml in bf16 (bench.py's default), Server "
        f"batch {BENCH_BF16_BATCH}, {BENCH_BF16_STEPS} PC steps a batch: "
        f"{', '.join(f'{x:.3f}' for x in seconds)} s (the first with cuDNN's "
        f"search); bf16 flash_fwd {3 * p * 2 * BENCH_BF16_STEPS} a batch, no "
        f"f32 launch; maps finite (5, 128, 128), last channel = length "
        f"mask; {ms:.2f} ms per PC step (a smoke line, not a benchmark)")
    del server
    torch.cuda.empty_cache()
    return dict(batch_seconds=seconds, ms_per_pc_step=ms,
                fwd_bf16_launches=launches, buckets=buckets.widths)


def check_buckets(*widths):
    """Every caption bucket from 64 to 512 keys was taken by a batch of
    the reference configurations' paths (the captions past 512 tokens are
    cut to it)."""
    took = sorted({int(w) for ws in widths for w in ws})
    log(f"caption buckets the reference configurations' batches took: "
        f"{took}")
    if not set(range(64, 513, 64)) <= set(took):
        raise AssertionError(f"caption buckets {took}: not every bucket "
                             f"from 64 to 512")
    return took


def main():
    from concurrent.futures import ThreadPoolExecutor

    # the kernels' nvcc builds run while torch starts on the card
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(phase_build)
        import torch

        from text2protein_tpu_torch.data import helix_records

        kind, smi = phase_device(torch)
        ptxas = build.result()
    rows = phase_kernels(torch)
    log(f"kernels f32: ptxas registers/spill stores/spill loads "
        f"{f32_register_report(ptxas)}")
    deploy_rows = phase_kernels(torch, DEPLOY_SHAPES, lengths=(0, 3, 9))
    bwd_rows = phase_kernels_bwd(torch)
    server, launches, seconds = phase_serving(torch)
    e2e = phase_reference(torch, server)
    del server
    records = OUT / "train_records"
    helix_records.write_records(records, N_RECORDS)
    weights = ROOT / "build" / "t2p_torch" / "chip_smoke_ema.pt"
    weights.parent.mkdir(parents=True, exist_ok=True)
    training = phase_training(torch, records, weights)
    train_ref = phase_train_reference(torch, records)
    workdir = Path(training["workdir"])
    deploy = phase_deploy(torch, workdir)
    sampling = phase_sampling_cli(torch, workdir, records)
    hybrid_ref = phase_hybrid_reference(torch, e2e)
    fwd16_rows, bwd16_rows = phase_kernels_bf16(torch, ptxas)
    server, launches16, serving16 = phase_serving_n256(torch)
    ref16 = phase_reference_n256(torch, server)
    del server
    torch.cuda.empty_cache()
    hybrid16 = phase_hybrid_n256(torch)
    records16 = OUT / "train_records_n256"
    helix_records.write_records(records16, N256_RECORDS, lengths=(128, 256),
                                seed=1)
    train_ref16 = phase_train_reference_n256(torch, records16)
    training16 = phase_training_n256(torch, records16)
    records_ss = WORK / "train_records_ss"
    helix_records.write_records(records_ss, SS_RECORDS, lengths=(64, 128),
                                seed=2, num_channels=8)
    training_ss = phase_training_ss(torch, records_ss)
    train_ref_ss = phase_train_reference_ss(torch, records_ss)
    sampling_ss = phase_sampling_ss(torch, Path(training_ss["workdir"]),
                                    records_ss)
    bf16_l128 = phase_bf16_l128(torch, ptxas, records_ss)
    text = phase_text(torch, ptxas, smi)
    realize = phase_realize(torch, smi, sampling["out_dir"])
    distributed = phase_distributed(torch, smi, records)
    sequence = phase_sequence_parallel(torch, smi, records)
    sequence16 = phase_sequence_parallel_n256(torch, ptxas, smi, records16)
    http = phase_http(torch, smi, workdir, deploy["step"])
    ref_kernels = phase_kernels_reference(torch, ptxas)
    records_ref = WORK / "train_records_ref"
    helix_records.write_records(
        records_ref, REF_RECORDS, lengths=(128, 256), seed=3,
        captions=helix_records.abstract_captions(REF_RECORDS, seed=3))
    reference = phase_reference_config(torch, records_ref)
    reference_cpu = phase_reference_config_cpu(torch, records_ref)
    variants = phase_reference_variants(torch, records_ref)
    caption_family = phase_caption_family(torch)
    bench16 = phase_bench_bf16(torch)
    buckets = check_buckets(
        reference["train_buckets"], reference["sampling_buckets"],
        [reference_cpu["caption_tokens"]],
        variants["pod_config"]["buckets"],
        variants["test_config_large"]["buckets"], caption_family["buckets"],
        bench16["buckets"])

    def per_step(rs, key):
        return sum(r[key] * r["per_step"] for r in rs)

    def host_per_call(rs):
        """The wrapper's host microseconds per call, averaged over a
        step's calls."""
        return per_step(rs, "host_us") / sum(r["per_step"] for r in rs)

    def bound_by(rs, peak=PEAK_F32_S):
        bytes_ms = sum(r["bytes"] / PEAK_BYTES_S * r["per_step"] for r in rs)
        ops_ms = sum(r["flops"] / peak * r["per_step"] for r in rs)
        return "bytes" if bytes_ms >= ops_ms else "operations"

    def kernel(name, source, replaces, launches, rs, what,
               peak=PEAK_F32_S):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # times: the kernel's share of one step (`what`), the sum over
            # the path's shapes of (launches per step x time)
            "ms": per_step(rs, "ms"),
            "plain_ms": per_step(rs, "plain_ms"),
            "bound_ms": per_step(rs, "bound_ms"),
            "bound_by": bound_by(rs, peak),
            "library_ms": per_step(rs, "library_ms"),
            # the library call's device time alone (CUDA-graph replay), the
            # yardstick of `device_ms`
            "library_device_ms": per_step(rs, "library_device_ms"),
            # the bound of the kernels' route: f32, 3xTF32 on the tensor
            # cores; bf16, the mma work they issue (bf16_mma_flops)
            "tc_bound_ms": per_step(rs, "tc_bound_ms"),
            # the kernels' device time alone (CUDA graph replay): `ms`
            # less what the wrapper's host time adds to back-to-back calls
            "device_ms": per_step(rs, "device_ms"),
            "host_us": host_per_call(rs),
            "per": what,
        }

    # one evaluation of the deployment path: the serving path's unmasked
    # calls (half of a PC step's) and the cross-attention over 16 keys
    deploy_calls = ([(r, r["per_step"] // 2) for r in rows
                     if not r["masked"]]
                    + [(r, r["per_step"]) for r in deploy_rows])

    def per_eval(key):
        return sum(r[key] * n for r, n in deploy_calls)

    fwd_f32 = kernel(
        "flash_fwd_f32", "text2protein_tpu_torch/ops/csrc/flash_fwd.cu",
        "text2protein_tpu/ops/flash.py:50",
        launches + training["fwd_launches"] + deploy["launches"]
        + sampling["launches"] + training_ss["fwd_launches"]
        + sampling_ss["launches"] + realize["launches"]
        + distributed["fwd_launches"] + sequence["fwd_launches"]
        + http["launches"] + reference["fwd_launches"]
        + reference_cpu["score_launches"] + variants["fwd_launches"]
        + caption_family["fwd_launches"], rows, f"PC step at batch {BATCH}")
    fwd_f32["deploy"] = dict(
        per=f"evaluation of the deployment path at batch {DEPLOY_BATCH}",
        **{k: per_eval(k) for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "library_ms",
                                    "library_device_ms", "tc_bound_ms")},
        max_abs_err=max(r["max_abs_err"] for r in deploy_rows))
    def per_row_step(rs, what, peak=PEAK_BF16_S):
        """A kernel's share of one step of another path (`what`)."""
        return dict(per=what, max_abs_err=max(r["max_abs_err"] for r in rs),
                    **{k: per_step(rs, k) for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms", "library_device_ms", "tc_bound_ms")},
                    host_us=host_per_call(rs), bound_by=bound_by(rs, peak))

    sp_what = (f"train step at batch {TRAIN_BATCH} with the grid's rows "
               f"over a stacked group of {SP_MODEL}")
    fwd_f32["sequence_parallel"] = per_row_step(
        sequence["fwd_rows"], sp_what + " (forward calls)", PEAK_F32_S)
    fwd_f32["reference_config"] = per_row_step(
        ref_kernels["fwd_rows"], f"test_config PC step at batch {REF_BATCH}"
        f" (the caption's {REF_TK}-key bucket)", PEAK_F32_S)
    fwd_f32["reference_config_large_8x8"] = per_row_step(
        ref_kernels["large_fwd_rows"], f"test_config_large's 8x8 calls of "
        f"one evaluation at batch {REF_TRAIN_BATCH}", PEAK_F32_S)

    fwd_bf16 = kernel(
        "flash_fwd_bf16", "text2protein_tpu_torch/ops/csrc/flash_fwd.cu",
        "text2protein_tpu/ops/flash.py:50",
        launches16 + training16["fwd_launches"] + hybrid16["launches"]
        + bf16_l128["fwd_launches"] + text["fwd_launches"]
        + sequence16["fwd_launches"] + variants["fwd_bf16_launches"]
        + bench16["fwd_bf16_launches"], fwd16_rows,
        f"N=256 PC step at batch {N256_BATCH}", PEAK_BF16_S)
    fwd_bf16["l128"] = per_row_step(
        bf16_l128["fwd_rows"],
        f"quality_ss_vp train step at batch {SS_BATCH} (forward calls)")
    fwd_bf16["text"] = per_row_step(
        text["fwd_rows"], f"quality_text_cfgft PC step at batch "
        f"{TEXT_SAMPLING_BATCH}")
    sp16_what = (f"quality_n256 train step at batch {N256_TRAIN_BATCH} with "
                 f"the grid's rows over a stacked group of {SP_MODEL}")
    fwd_bf16["sequence_parallel_n256"] = per_row_step(
        sequence16["fwd_rows"], sp16_what + " (forward calls)")
    fwd_bf16["reference_config_large_bf16"] = per_row_step(
        ref_kernels["large_bf16_fwd_rows"], "test_config_large's 8x8 calls "
        "of one bf16 evaluation at batch 1")
    fwd_bf16["bench_l128_bf16"] = per_row_step(
        ref_kernels["bench_bf16_fwd_rows"], f"bench_l128 bf16 PC step at "
        f"batch {BENCH_BF16_BATCH} (its forward calls)")
    bwd_bf16 = kernel(
        "flash_bwd_bf16", "text2protein_tpu_torch/ops/csrc/flash_bwd.cu",
        "text2protein_tpu/ops/flash.py:168",
        training16["bwd_launches"] + bf16_l128["bwd_launches"]
        + text["bwd_launches"] + sequence16["bwd_launches"], bwd16_rows,
        f"N=256 train step at batch {N256_TRAIN_BATCH}", PEAK_BF16_S)
    bwd_bf16["l128"] = per_row_step(
        bf16_l128["bwd_rows"],
        f"quality_ss_vp train step at batch {SS_BATCH}")
    bwd_bf16["text"] = per_row_step(
        text["bwd_rows"], f"quality_text_cfgft train step at batch "
        f"{SS_BATCH}")
    bwd_bf16["sequence_parallel_n256"] = per_row_step(sequence16["bwd_rows"],
                                                      sp16_what)
    bwd_bf16["reference_config_large_bf16"] = per_row_step(
        ref_kernels["large_bf16_bwd_rows"], f"test_config_large's 8x8 calls "
        f"of one bf16 train step at batch {REF_TRAIN_BATCH}")
    bwd_f32 = kernel(
        "flash_bwd_f32", "text2protein_tpu_torch/ops/csrc/flash_bwd.cu",
        "text2protein_tpu/ops/flash.py:168",
        training["bwd_launches"] + training_ss["bwd_launches"]
        + distributed["bwd_launches"] + sequence["bwd_launches"]
        + reference["bwd_launches"] + reference_cpu["gpu_bwd_launches"]
        + variants["bwd_launches"] + caption_family["bwd_launches"],
        bwd_rows, f"train step at batch {TRAIN_BATCH}")
    bwd_f32["sequence_parallel"] = per_row_step(sequence["bwd_rows"],
                                                sp_what, PEAK_F32_S)
    bwd_f32["reference_config"] = per_row_step(
        ref_kernels["bwd_rows"], f"test_config train step at batch "
        f"{REF_TRAIN_BATCH} (the caption's {REF_TK}-key bucket)",
        PEAK_F32_S)
    bwd_f32["reference_config_large_8x8"] = per_row_step(
        ref_kernels["large_bwd_rows"], f"test_config_large's 8x8 calls of "
        f"one train step at batch {REF_TRAIN_BATCH}", PEAK_F32_S)
    kernels = [
        # launches on the main paths: serving, training (+ its eval), the
        # deployment batches, the sampling CLI, SS training and sampling,
        # the realize phase's serving batch, the sharded train steps, the
        # entry() forward and the dryrun (phase 23), the SP train steps
        # (phase 24), the HTTP server's batches and warm-up (phase 26)
        fwd_f32,
        bwd_f32,
        # bf16: N=256 serving, training (+ its eval) and hybrid; the
        # quality_ss_vp train steps (+ eval); the quality_text_cfgft train
        # steps (+ eval) and its sampling CLI; the N=256 SP train steps
        # (phase 25)
        fwd_bf16,
        bwd_bf16,
    ]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "steps": STEPS, "batch": BATCH,
        "shapes": rows, "bwd_shapes": bwd_rows, "kernels": kernels,
        "ptxas": ptxas,
        "batch_seconds": seconds, "e2e_rel_diff": e2e,
        "training": training, "train_reference": train_ref,
        "bf16_shapes": fwd16_rows, "bf16_bwd_shapes": bwd16_rows,
        "serving_n256": serving16, "reference_n256": ref16,
        "training_n256": training16, "train_reference_n256": train_ref16,
        "deploy_shapes": deploy_rows, "deploy": deploy,
        "sampling_cli": sampling, "hybrid_reference": hybrid_ref,
        "hybrid_n256": hybrid16, "training_ss": training_ss,
        "train_reference_ss": train_ref_ss, "sampling_ss": sampling_ss,
        "bf16_l128": bf16_l128, "text": text, "realize": realize,
        "distributed": distributed, "sequence_parallel": sequence,
        "sequence_parallel_n256": sequence16, "http": http,
        "reference_kernels": ref_kernels, "reference_config": reference,
        "reference_config_cpu": reference_cpu,
        "reference_variants": variants, "caption_family": caption_family,
        "bench_bf16": bench16, "caption_buckets": buckets,
    }, indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
