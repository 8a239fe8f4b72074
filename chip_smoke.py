#!/usr/bin/env python3
"""Drive the PyTorch port's render, training, serving, geometry, pose and
multi-scene paths on one NVIDIA GPU and check them.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: compile ``nerf_tpu_torch/csrc`` with nvcc for sm_90a; the bf16
     instances of #1, #2, #3, #4, #7, #8 and #9 must hold tensor-core
     instructions (TENSOR_CORE_KERNELS), and the f32 4x128 forwards, #8's
     f32 backward passes, the f32 Paper kernels and #9's bf16
     weight-gradient pass on wgmma must not spill (F32_FLEX_KERNELS,
     F32_FLEX_BWD_KERNELS, F32_PAPER_KERNELS, WGMMA_BWD_KERNELS);
  3. kernel vs plain: the fused encode+MLP kernel against its plain PyTorch
     version at the render path's shapes, float32 and bfloat16 (the bf16
     instance on the tensor cores, to TC_BF16_FWD_TOL), the bf16 one also at
     a frame's four shapes and ragged ones, one wgmma launch each;
  4. main path: ``nerf_tpu_torch.eval_nerf.render_trajectory`` renders three
     400x400 orbit frames of the flagship 4x128 FlexibleNeRF
     (``configs/lego_fused.yml``, seeded random weights saved as a reference
     ``.ckpt``), and must have gone through the kernel; frame 0 is held
     against the plain path; a bf16 frame's 4 launches all take the wgmma
     body;
  5. times on this card: the kernel against the plain version at one
     fine-pass chunk, and seconds per 400x400 frame for both paths;
  6. training kernels vs plain: the fused FlexibleNeRF forward + backward
     pair against its plain PyTorch version at the training path's shapes,
     float32 and bfloat16: the forward and its residuals, and every
     parameter gradient and ddc against the plain backward on the forward
     kernel's own residuals; two backward calls bitwise equal;
  7. training main path: ``nerf_tpu_torch.train_nerf.train`` trains the
     flagship model at the ``configs/lego_fused.yml`` train protocol (bf16,
     training kernels on) on the procedural synthetic scene (20 views of
     400x400) for TRAIN_STEPS steps, through both training kernels; the loss
     must fall; the checkpoint it writes is rendered at a novel orbit pose
     through ``eval_nerf.render_trajectory`` and the forward kernel, and must
     clear PSNR_FLOOR_TRAINED_DB against the analytic scene; a float32
     trajectory through the kernels must track the plain path's;
  8. times on this card: the training kernels against the plain pair, and
     rays per second of a training step on the kernel and plain paths; the
     bf16 kernel path's step under the profiler (device busy share);
  9. PaperNeRF kernels vs plain: the 8x256 forward kernel and training pair
     against their plain versions at the Paper path's shapes, float32 and
     bfloat16, at 10 encoding frequencies and once each at 6, 0 and 16 (the
     forward's output and residuals against the plain forward's, the
     backward against the plain backward on the forward kernel's residuals);
     layers_dir.3's gradient exactly zero, two backward calls bitwise equal;
 10. PaperNeRF main path: ``train_nerf.train`` trains the
     ``configs/lego_paper.yml`` protocol (8x256, lr 5e-4, bf16, training
     kernels on) on the synthetic scene for PAPER_TRAIN_STEPS steps through
     the training pair (2 + 2 launches a step); the checkpoint it writes is
     rendered through ``eval_nerf.render_trajectory`` and the forward kernel
     (2 launches a chunk) and must clear PAPER_PSNR_FLOOR_DB against the
     analytic scene; the same frame on the plain path (at PLAIN_CHUNK rays a
     chunk: its 256-wide f32 activations would near the card's 80 GB at
     131072) must match; a float32 trajectory through the kernels must track
     the plain path's;
 11. times on this card: the Paper kernels against their plain versions,
     seconds per 400x400 Paper frame and training rays per second on the
     kernel and plain paths;
 12. compositing, resampling and whole-stage kernels vs plain: the
     compositing scan (#5), the inverse-CDF resample (#6) and the whole
     render stage (#7) against their plain versions at the flagship render
     path's chunks (131072 x 64 and x 128) and a ragged (333, 61), on the
     fields the encode+MLP kernel makes at orbit points (and a random one);
     #6 on those composited weights, det and with uniforms that include 1.0,
     each sample within RESAMPLE_TOL in depth or RESAMPLE_CDF_TOL in CDF
     space; #7 in float32 and bfloat16, and its bf16 maps bitwise equal to
     #5 on #1's bf16 field (the same tensor-core tile and scan);
 13. the flagship render path with these kernels: chain A (#1 -> #5 -> #6 ->
     sort -> #1 -> #5) and chain B (#7 -> #6 -> sort -> #7) render a 400x400
     frame of ``configs/lego_fused.yml`` at chunk 131072 with their expected
     launches and are held against the renderer's kernel path; then the
     three kernels' times against their plain versions (#6 by CUDA events
     around its wrapper and by the profiler's device time of its kernel; #7
     also against #1 + plain compositing) and seconds per frame of the
     renderer's kernel path and of both chains;
 14. the point-major (#2) and ray-major (#3) 4x128 forwards vs their plain
     versions at the render path's shapes, float32 and bfloat16 (their bf16
     instances on the tensor cores, to TC_BF16_FWD_TOL), and #3 bitwise
     equal to #1 in both (the same tile body on the same dc rows); chain C
     (#3 -> plain compositing -> sample_pdf -> sort -> #3) and chain D (the
     same with #2 on the flattened points) render the flagship frame (4
     launches each) against the renderer's kernel path;
 15. times: #2 and #3 vs plain with #1 in the same turns at one fine-pass
     chunk, float32 and bfloat16; frames of chains C and D beside the
     renderer's kernel path, then bf16 frames of chains B, C and D beside
     the renderer's bf16 kernel path, each with its launches and at least
     PSNR_FLOOR_DB against the renderer's float32 frame;
 16. the render server: phase 7's checkpoint written as a native .ntc and
     served at bf16 by ``nerf_tpu_torch.serve_nerf`` over HTTP from a thread
     (/health, /, GET and POST renders whose PNGs must be bitwise equal to
     the renderer's u8 frames, 4 launches of #1 a frame, a 400 and a 404),
     the median request latency, then a --logdir service that must pick up
     a newer .ntc of other weights;
 17. the flagship protocol from a dataset on disk: the analytic scene written
     as a blender dataset (DISK_VIEWS views of 800x800 RGBA PNGs, lego's size
     and camera angle, row filters cycling through all five); ``train_nerf.
     main`` on it at the lego_fused protocol (half_res: a native-built store
     of 6.4M rays, #8 2 + 2 launches a step, the loss falling); a resume from
     its step-DISK_RESUME_AT ``.ntc`` whose losses must be bitwise the
     uninterrupted run's; ``cache_dataset --format binary`` to a ``.nrc``
     holding the same store bitwise, and training from it to the same first
     losses; ``eval_nerf --split test --gif`` through #1 (its launches, each
     frame's PSNR over DISK_PSNR_FLOOR_DB, the GIF's frame count); the fern
     protocol on an LLFF scene written with ``images/`` only (minified at
     load), in NDC on the plain path, and its test split rendered; then the
     decode, store-build, training and eval times;
 18. geometry and camera-pose refinement on phase 17's field and dataset:
     ``train_nerf --tighten-aabb`` resumed for GEO_TIGHT_STEPS bf16 steps
     (the 64^3 sweep's box strictly inside the sweep cube and holding the
     analytic sigma > GEO_TAU ball less a voxel, #8 2 + 2 launches a step);
     ``eval_nerf --tighten-aabb --split test`` in f32 and bf16 through #1
     (its launches, PSNR over DISK_PSNR_FLOOR_DB), every tightened f32 frame
     held against the plain path's with phase 4's gates, and a covering box
     against no box; ``extract_geometry`` at 256^3 (a watertight mesh, its
     vertex radii in GEO_RADII, the card's 64^3 grid and baked normals equal
     to the CPU's) and the analytic field's own mesh (watertight, normals
     outward, on the shell); ``optimize_poses`` lowering the photometric loss of
     perturbed cameras, the JAX test's pose recovery through
     ``make_pose_opt_loop``, and a short ``--joint-train`` whose ``.ntc``
     ``eval_nerf`` renders; then the sweep, query, frame and per-iteration
     times;
 19. the multi-scene workflow on phase 17's field and datasets:
     ``distill_dataset --renderer pallas`` into a blender set of MS_SIZE
     views through #1 (its launches; view 0 held against the plain path
     with phase 4's gates, and its PNG bitwise the kernel path's u8 frame);
     ``train_multiscene`` at the full lowres protocol (MS_SCENES synthetic
     scenes, 64 + 64 samples, 10/4, 1024 rays a scene, f32, MS_STEPS steps,
     no kernel launch, as in JAX): every scene's loss falling, every
     exported ``.ntc`` rendered by ``eval_nerf`` through #1; the batched
     step against the single-scene step on each scene's own draws at full
     width (MS_LOSS_RTOL, MS_GRAD_TOL); two groups (the distilled set and
     phase 17's scene | its LLFF scene) for MS_GROUP_STEPS steps;
     ``eval_multiscene`` on the blender group through #1 in f32 and bf16
     (launches), and ``evaluate_metrics`` on its PNGs reproducing its
     PSNR/SSIM; the seven other optimizer names, OPT_STEPS ``train_nerf``
     steps each at lego_fused through #8; the VeryTiny, MultiHead and
     Replicate families' frames on the card against the CPU with the kernel
     flags on and no launch; ``tiny_nerf``'s rising PSNR; a ``.ckpt ->
     .ntc -> .ckpt`` ``convert_checkpoint`` round trip; then the multi-scene
     step's rays/s beside phase 8's plain f32 single-scene step, distill
     s/view and eval s/frame. The scene axis of #8 and #9: their
     scene-batched launches at MS_PAIR_SHAPES, f32 and bf16, bitwise the
     single-scene launches on each scene's inputs; then the same 6-scene
     full-width step with ``use_pallas_train`` (2 + 2 launches of #8 a
     step, whatever the scene count), f32 and bf16, against the plain
     batched step and the single-scene kernel step per scene (f32:
     MS_LOSS_RTOL, MS_GRAD_TOL; bf16: TC_BF16_FWD_TOL and BF16_TOL against
     the single-scene kernel step, BF16_TOL and MS_BF16_GRAD_NORM against
     the plain f32 step), and a 6-scene PaperNeRF step through #9 against
     its single-scene kernel steps; the kernel loops' ms a step, rays/s
     and busy share beside the plain loop's, in turns;
 20. the multi-device layer (``nerf_tpu_torch/parallel``) on this one card,
     every rank's kernels on it: (a) in a one-rank NCCL group, the
     data-parallel step at lego_fused's protocol (#8) bitwise the serial
     step; two ranks sharing the card through gloo (one spawned group):
     (b) ``train_nerf --num-devices 2`` for P20_TRAIN_STEPS steps (2 + 2
     launches of #8 a step on each rank, the loss falling, the ranks' final
     weights bitwise equal, one checkpoint set from rank 0 that ``eval_nerf``
     renders through #1), one f32 data-parallel step against the serial step
     on the union batch (P20_DP_TOL), rays/s, the all-reduce's ms a step and
     its bucket's bytes; (c) the mesh server on phase 7's ``.ntc`` at bf16,
     400x400 (every served PNG bitwise the one-card u8 frame, /health
     devices 2, #1 launches on both ranks, a ``--logdir`` reload on both,
     the follower gone after the stop) and its median latency beside phase
     16's; (e) ``optimize_poses --num-devices 2`` on phase 18's 8 views (the
     final twists within P20_POSE_TOL of phase 18's serial run); (f)
     ``train_multiscene --num-devices 2`` on phase 19's six scenes, and one
     data-parallel step against the one-device batched step (phase 19's
     gates); and (d) ``extract_geometry --num-devices 2``, which spawns its
     own ranks, at 256^3 on phase 17's field (grid and PLY bitwise phase
     18's serial run's). One card cannot show scaling: the ranks share it;
 21. Instant-NGP's hash-grid field (``configs/lego_hashgrid.yml``) and its
     encoding pair (#10): the pair's registers (HASH_KERNELS, no spill); the
     pair against its plain version at ``ngp_train``'s encodings and a fine
     pass packed at a surface (HASH_SHAPES), f32 and bf16: the forward
     bitwise, the backward within the atomics' order bound; ``train_nerf.
     train`` at the lego_hashgrid protocol on the synthetic scene for
     HASH_TRAIN_STEPS steps (2 + 2 launches of #10 a step, 2 a validation
     frame, the loss falling); then a step's encodings each way against the
     plain version's by CUDA events, and the fills that zero the table
     gradients.

Then one JSON line of per-kernel results (each kernel's launches on its main
path, error, time, plain time and the least time the card could take for the
same work) and, last, the JSON device line.
Any failure raises: the script exits non-zero and prints no result. There is
no CPU path: without CUDA it exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

F32_TOL = 1e-4          # kernel vs plain, float32: summation order, sincosf vs sin
BF16_TOL = 2e-2         # kernel vs bf16-emulating plain: bf16 roundings that flip
# The tensor-core kernels' bf16 forward output (#1-#4 and the #8/#9
# forwards) against plain, on the unopacified check models: a sum in another
# order flips a bf16 rounding and moves the output by ~2e-4 (2.2e-4 measured
# for #4 on an H100); a tile that overlapped half the encoding rows read
# ~1e-2, inside BF16_TOL.
TC_BF16_FWD_TOL = 2e-3
RENDER_RGB_TOL = 1e-3   # float32 frame, kernel path vs plain path
PSNR_FLOOR_DB = 37.5    # bf16 kernel frame vs float32 plain frame (bench.py guard floor)
MAX_RESAMPLE_PIXELS = 160  # fine-pass pixels whose resampled depths may move (0.1%)
NUM_POSES = 3
SEED = 0
KERNEL_CHUNK = (131072, 128)   # one fine-pass chunk: rays x samples
TRAIN_CHECK_SHAPES = ((1024, 64), (1024, 128), (333, 61))   # coarse, fine, ragged
TRAIN_SHAPE = (1024, 128)      # the fine pass of a 1024-ray training step
TRAIN_STEPS = 300
TRAJECTORY_STEPS = 20
TRAJECTORY_RTOL = 2e-3         # f32 loss per step, kernel path vs plain path
PSNR_FLOOR_TRAINED_DB = 30.0   # novel view after TRAIN_STEPS steps (37.64 dB measured on an H100)
# Novel view of the Paper checkpoint after PAPER_TRAIN_STEPS steps: a CPU
# rehearsal of the protocol at 64x64, 512 rays, 32 + 32 samples reached
# 29.4 dB in 300 steps, the empty white scene it may collapse to reads ~11 dB;
# the floor sits between.
PAPER_PSNR_FLOOR_DB = 20.0
TIMED_STEPS = 30
# The PaperNeRF slice (phases 9-11).
PAPER_CHECK_SHAPES = ((2048, 64), (2048, 128), (1000, 128), (333, 61))
# #4's calls in a 400x400 frame of 64 + 128 samples at chunk 131072: coarse
# and fine (64 + 192 samples), a whole chunk and the rest of 160,000 rays.
PAPER_FRAME_SHAPES = ((131072, 64), (28928, 64), (131072, 192), (28928, 192))
# #9's calls in the benchmark's paper_train step: 4096 rays of 64 coarse and
# 64 + 128 fine samples.
PAPER_TRAIN_SHAPES = ((4096, 64), (4096, 192))
# #1's calls in a 400x400 frame of 64 + 64 samples (the flagship's), the same
# way, and ragged ones: samples that do not divide a 64-point tile.
FRAME_SHAPES = ((131072, 64), (131072, 128), (28928, 64), (28928, 128))
RAGGED_SHAPES = ((333, 48), (100, 100))
PAPER_FREQS = (10, 6, 0, 16)   # encoding depths phase 9 checks: lego_paper's, the JAX default, ends
PAPER_TRAIN_STEPS = 300
PAPER_TIMED_STEPS = 10
PLAIN_CHUNK = 16384            # rays a chunk of the plain Paper path (memory, not speed)
# The compositing, resampling and whole-stage slice (phases 12-13): the
# render path's coarse and fine chunks, and a shape whose points end mid-tile.
STAGE_CHECK_SHAPES = ((131072, 64), (131072, 128), (333, 61))
# #5 and #7 vs plain, float32, per map: summation order only (disp relative).
MAP_TOLS = {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4, "disp": 1e-4}
RESAMPLE_TOL = 1e-5        # #6 vs sample_pdf, depth
# #6, a sample over RESAMPLE_TOL in depth, in CDF space: the 1e-5 guard's
# width plus the two prefix sums' rounding (check_resample).
RESAMPLE_CDF_TOL = 1.1e-5
# Operations a sample of the compositing scan: the distance, alpha (exp),
# the transmittance factor, its product, the weight, three sigmoids (exp,
# add, divide) and five sums.
COMPOSITE_OPS_PER_SAMPLE = 25
# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): f32 outside the
# tensor cores, bf16 on them, and device memory.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# The render path's shapes, and one whose points end mid-tile.
CHECK_SHAPES = ((2048, 64), (2048, 128), (1000, 128), (333, 61))
SERVE_RENDERS = 5              # renders over HTTP whose median latency phase 16 reports
# Phase 17: the flagship protocol from a dataset on disk.
DISK_SIZE = 800                 # lego's images: 800x800 RGBA, half_res to 400x400
DISK_VIEWS = (("train", 40), ("val", 8), ("test", 8))   # lego: 100 / 100 / 200
DISK_FILTERS = (0, 1, 2, 3, 4)  # PNG row filters, cycled: None, Sub, Up, Average, Paeth
DISK_STEPS = 300
DISK_RESUME_AT = 200            # the .ntc the resumed run starts from
DISK_CACHE_STEPS = 20
# The test views after DISK_STEPS steps, against their PNGs composited on
# white: phase 7's protocol reached 37.6 dB on a novel view of the analytic
# scene; the empty white scene a failed run collapses to reads ~11 dB.
DISK_PSNR_FLOOR_DB = 30.0
LLFF_VIEWS = 20                 # fern has 20 views (llffhold 8: 3 held out)
LLFF_SIZE = (48, 64)            # images_8's (height, width); images/ is 8x that
LLFF_STEPS = 20
# Phase 18: geometry and pose refinement on phase 17's field. The scene is
# data/synthetic.py's soft sphere, sigma = 40 (0.8 - r): every gate below is
# written from that field.
GEO_TAU = 1.0                   # --tighten-aabb: bound sigma > 1, the ball r < 0.775
GEO_BALL = 0.8 - GEO_TAU / 40.0
GEO_VOXEL = 3.0 / 63.0          # the 64^3 sweep's step over [-1.5, 1.5]^3
GEO_TIGHT_STEPS = 20            # bf16 steps resumed on the tightened intervals
GEO_RESOLUTION = 256            # extract_geometry's default grid and chunk (262144)
# extract_geometry --iso, from the analytic field: the level set the images
# pin down is where the transmittance from the surface is still high,
# exp(-20 d^2) >= 0.8 at depth d <= 0.106, i.e. sigma = 40 d <= 4.2. Deeper
# the trained interior is free (on the card it levels off near
# sigma 11 with ripples, and the sigma = 8 level set meshed them).
GEO_ISO = 4.0                   # the analytic sigma = 4 shell: r = 0.7
# The 1st-99th percentiles of the mesh's vertex radii: between the analytic
# sigma = 8 shell (r = 0.6) and the surface r = 0.8 plus 0.05 of blur.
GEO_RADII = (0.6, 0.85)
# The orientation gate runs on the analytic field itself (sigma = 40 (0.8 -
# r), exact gradients): the share of vertex normals, baked and the mesh's
# own winding, with n . v > 0, and every vertex within a voxel diagonal of
# r = 0.7. On the trained field the iso 4 level set is corrugated at the
# voxel scale (on the card: 537,042 vertices where the sphere needs ~150k,
# 78.67% of the winding and 69.96% of the baked normals outward): its
# density ripples at the 10th encoding frequency (a 0.012 period), which
# renders the same images, so there the mesh is held to the band and the
# card's normals to the CPU's.
GEO_OUTWARD = 0.95
GEO_NORMALS_CHECK = 4096        # vertices whose normals the card and the CPU compute
GEO_GRID_CHECK = 64             # the card's grid against the CPU's, at 64^3
GEO_GRID_TOL = 1e-4             # of the grid's maximum: TF32 in the plain matmuls would miss it
POSE_ARGS = ["--max-images", "8", "--perturb-rot-deg", "2", "--perturb-trans", "0.05"]
# On phase 17's sphere the orbit about its centre changes the images only
# through the slow colour pattern (on the card the loss fell 26x while the
# cameras drifted along it), so there the gate is the photometric loss:
# cameras misplaced by 2 degrees and 0.05 misalign the sphere by ~17% of
# its radius, and a working refinement at least halves that loss.
POSE_LOSS_GAIN = 0.5
# tests/test_pose_refinement.py:126-175 on the card: its narrow field (2 x
# 32, 4/2 encoding, weights x3 and a +2 density bias, here from a torch
# seed), its own renders as targets, 2 degrees / 0.04 recovered by Adam 3e-3
# in 4 x 40 steps of 48 rays: mean rotation error after < 0.6 x before, and
# the translation error falls.
POSE_GAIN = 0.6
JOINT_ITERS = 10
# Phase 19: the multi-scene workflow, from phase 17's trained field.
MS_DISTILL = ("16", "4", "4")   # distilled train / val / test views at MS_SIZE
MS_SIZE = 400
MS_SCENES = 6                   # the README's 6-scene sweep, full lowres protocol
MS_STEPS = 300
MS_CALL = 100                   # steps a call (--print-every)
MS_GROUP_STEPS = 20             # the two-group run (distilled + lego | fern)
MS_PROFILE_STEPS = 10           # the 6-scene loop's steps under the profiler
MS_LOSS_RTOL = 1e-5             # scene s of the batched step vs the single-scene step
# Their gradients, scaled by each leaf's largest: both are float32 sums of
# 65,536-131,072 points in another order, and each reads up to 1.9e-3 from
# the float64 gradient on this batch (a CPU probe at this width); a scene
# that took another's gradient would read O(1).
MS_GRAD_TOL = 1e-3
# The scene-batched training pairs against single-scene launches, bitwise:
# (family, scenes, rays, samples, encoding depth); phase 19's coarse and
# fine passes, a partial last tile a scene, one scene.
MS_PAIR_SHAPES = (("flex", MS_SCENES, 1024, 64, 10), ("flex", MS_SCENES, 1024, 128, 10),
                  ("flex", 3, 333, 61, 10), ("flex", 1, 333, 61, 10),
                  ("paper", 3, 1024, 64, 10), ("paper", 2, 333, 61, 6), ("paper", 1, 41, 50, 10))
# A bf16 kernel step's gradient against the plain f32 step's, each leaf's
# relative L2 distance: bf16 operands move every product by ~2^-9 and flip
# ReLU masks near 0; the CPU tests find the port's bf16 training gradients
# within about 7% of f32 (JAX's own bf16 path within 14%), and a scene that
# took another's gradient would read O(1).
MS_BF16_GRAD_NORM = 0.1
MS_PAPER_RAYS = 512             # rays a scene of the 6-scene Paper kernel step
SHORT = {"float32": "f32", "bfloat16": "bf16"}
MS_METRIC_TOL = (0.1, 5e-3)     # evaluate_metrics on the 8-bit PNGs vs eval_multiscene (dB, SSIM)
OPTIMIZER_NAMES = ("RMSprop", "Adagrad", "Adamax", "Adadelta", "NAdam", "RAdam", "Rprop")
OPT_STEPS = 3
FAMILY_TOL = 1e-4               # a family's frame, card vs CPU, plain path
TINY_ITERS = 300
P20_TRAIN_STEPS = 60            # phase 20(b): 2 ranks x 512 rays a step
P20_DP_TOL = 1e-5               # DP step vs serial on the union batch, of each leaf's largest
P20_SERVE_RENDERS = 5
P20_POSE_TOL = 1e-4             # final twists, 2 ranks vs phase 18's serial run
P20_MS_STEPS = 20
P20_DEADLINE_S = 600            # a spawned group's whole run
P20_TIMEOUT_S = 60.0            # its collectives' limit, so a hung rank fails fast
DEVICE = "cuda"
# Multiply-adds per point of the 4x128 10/4 FlexibleNeRF forward, dir
# contribution excluded: 63x128 + 3x128x128 + 128x129 + 128x64 + 64x3; of its
# backward: the layer-gradient pass (74048, as many as the backward weights)
# and the weight gradients (as many as the forward's).
MACS_PER_POINT = 63 * 128 + 3 * 128 * 128 + 128 * 129 + 128 * 64 + 64 * 3
BWD_MACS_PER_POINT = 74048 + MACS_PER_POINT
# The same for the 8x256 10/4 PaperNeRF: 63x256 + 3x256x256 + 319x256 +
# 3x256x256 + 256x256 + 256 + 256x128 + 2x128x128 + 128x3 forward; backward
# 590464 (layer gradients) + the forward's count (weight gradients).
PAPER_MACS_PER_POINT = 622720
PAPER_BWD_MACS_PER_POINT = 590464 + PAPER_MACS_PER_POINT


FLEX_MODEL = {
    "type": "FlexibleNeRFModel", "num_layers": 4, "hidden_size": 128,
    "skip_connect_every": 4, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
    "use_viewdirs": True,
}
PAPER_MODEL = {
    "type": "PaperNeRFModel", "num_layers": 8, "hidden_size": 256,
    "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4, "use_viewdirs": True,
}
# Instant-NGP's hash-grid field at its published shape (configs/lego_hashgrid.yml).
HASH_MODEL = {
    "type": "HashGridNeRFModel", "num_levels": 16, "features_per_level": 2,
    "log2_hashmap_size": 19, "base_resolution": 16, "max_resolution": 2048,
    "hidden_size": 64, "density_outputs": 16, "sh_degree": 4, "box": 1.5,
}
# Phase 21, #10: the ngp_train step's encodings (1024 rays of 64 coarse and
# 64 + 128 fine samples) along rays through the cube, and the fine one packed
# in a short depth interval, as training gathers samples at surfaces:
# (rays, samples, depth interval).
HASH_SHAPES = ((1024, 64, 3.0), (1024, 192, 3.0), (1024, 192, 0.05))
HASH_STEP_SHAPES = HASH_SHAPES[:2]
HASH_TRAIN_STEPS = 300
# Operations a point of #10 each way: at each of 16 levels and 8 corners the
# weight's two products and two multiply-adds of the features (or the
# gradient's two products and two adds).
HASH_OPS_PER_POINT = 16 * 8 * 6


def lego_fused_config():
    """``configs/lego_fused.yml``'s values merged over the defaults, in code
    (no YAML reader needed)."""
    return lego_config(FLEX_MODEL, 5.0e-3, "lego-fused")


def lego_paper_config():
    """``configs/lego_paper.yml``'s values merged over the defaults, in code:
    the same protocol as lego_fused.yml with the 8x256 PaperNeRF and lr 5e-4."""
    return lego_config(PAPER_MODEL, 5.0e-4, "lego-paper")


def lego_config(model: dict, lr: float, experiment_id: str):
    """The blender lego protocol shared by configs/lego_fused.yml and
    configs/lego_paper.yml, with ``model`` as both models."""
    from nerf_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.set_new_allowed(True)
    pairs = [
        "dataset.type", "blender", "dataset.basedir", "cache/nerf_synthetic/lego",
        "dataset.half_res", True, "dataset.testskip", 1, "dataset.no_ndc", True,
        "dataset.near", 2, "dataset.far", 6, "dataset.height", 400, "dataset.width", 400,
    ]
    for which in ("coarse", "fine"):
        for key, value in model.items():
            pairs += [f"models.{which}.{key}", value]
    validation = {
        "chunksize": 131072, "perturb": False, "num_coarse": 64, "num_fine": 64,
        "white_background": True, "radiance_field_noise_std": 0.0, "lindisp": False,
    }
    for key, value in validation.items():
        pairs += [f"nerf.validation.{key}", value]
    train = dict(validation, num_random_rays=1024, perturb=True, radiance_field_noise_std=0.2,
                 compute_dtype="bfloat16", use_pallas_train=True)
    for key, value in train.items():
        pairs += [f"nerf.train.{key}", value]
    pairs += [
        "experiment.id", experiment_id, "experiment.logdir", "logs", "experiment.randomseed", 42,
        "experiment.train_iters", 200000, "experiment.validate_every", 1000,
        "experiment.save_every", 5000, "experiment.print_every", 100,
        "optimizer.type", "Adam", "optimizer.lr", lr,
        "scheduler.lr_decay", 250, "scheduler.lr_decay_factor", 0.1,
    ]
    cfg.merge_from_list(pairs)
    return cfg


def lego_hashgrid_config():
    """``configs/lego_hashgrid.yml``'s values merged over the defaults, in
    code: the lego protocol on Instant-NGP's field, 64 + 128 samples, no
    sigma noise, bf16 through the hash-encoding pair (#10), Adam 1e-2."""
    cfg = lego_config(HASH_MODEL, 1.0e-2, "lego-hashgrid")
    pairs = ["experiment.train_iters", 35000, "nerf.train.ray_sampling", "gather",
             "nerf.validation.compute_dtype", "bfloat16", "nerf.validation.use_pallas", True]
    for mode in ("train", "validation"):
        pairs += [f"nerf.{mode}.num_fine", 128, f"nerf.{mode}.radiance_field_noise_std", 0.0]
    cfg.merge_from_list(pairs)
    return cfg


def synthetic_train_config(train_iters: int, base=lego_fused_config):
    """A lego protocol (``base``) with its dataset replaced by the procedural
    synthetic scene (20 views of 400x400, a 3.2M-ray store), cut to
    ``train_iters`` steps."""
    cfg = base()
    cfg.merge_from_list(["dataset.type", "synthetic", "dataset.num_views", 20,
                         "dataset.image_size", 400, "experiment.train_iters", train_iters])
    return cfg


def seeded_model(seed: int, opacify: bool, family: str = "FlexibleNeRFModel"):
    """The flagship FlexibleNeRF (or the 8x256 PaperNeRF), 10/4 encoding,
    with weights from ``seed``.

    ``opacify`` scales every weight by 3 and adds 2 to the density bias, as
    bench.py's numerics guard does: plain random fields render almost empty,
    and a white frame would make every image comparison pass trivially.
    """
    import torch

    from nerf_tpu_torch import models

    model = getattr(models, family)(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                                    generator=torch.Generator().manual_seed(seed))
    if opacify:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(3.0)
            model.fc_alpha.bias.add_(2.0)
    return model.eval()


def orbit_points(num_rays: int, num_samples: int, device, seed: int):
    """Points as the render path makes them: random pixels of the 400x400
    orbit frames, at sorted depths in [near, far] = [2, 6]. Returns the
    points and the normalized view directions."""
    return orbit_rays(num_rays, num_samples, device, seed)[:2]


def orbit_rays(num_rays: int, num_samples: int, device, seed: int):
    """``orbit_points``, with the depths (N, S) and the un-normalized ray
    directions (N, 3) as well."""
    import torch

    from nerf_tpu_torch.data import spherical_render_poses
    from nerf_tpu_torch.ops import get_ray_bundle

    gen = torch.Generator(device=device).manual_seed(seed)
    side = 400
    focal = 0.5 * side / math.tan(0.5 * 0.6911112070083618)
    poses = torch.as_tensor(spherical_render_poses(40, phi=-30.0, radius=4.0),
                            dtype=torch.float32, device=device)
    pose = poses[int(torch.randint(40, (1,), generator=gen, device=device))][:3, :4]
    ro, rd = get_ray_bundle(side, side, focal, pose)
    pick = torch.randint(side * side, (num_rays,), generator=gen, device=device)
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    z, _ = torch.sort(2.0 + 4.0 * torch.rand(num_rays, num_samples, generator=gen,
                                             device=device), dim=-1)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    return pts, rd / torch.linalg.norm(rd, dim=-1, keepdim=True), z, rd


def check_resample_outliers(cfg, pixels, hwf, mc, mf, kernel) -> None:
    """Hold the fine pass at the pixels where the two paths' frames differ
    against itself on common depth samples, and fail if they still differ.

    ``sample_pdf`` keeps the reference's ``denom < 1e-5`` guard, so a fine
    sample jumps across a bin when a coarse weight sits on that edge (a bin
    of weight ~6e-9 has a floored pdf of ~1e-5). Coarse weights that agree to
    1e-7 can then give depths a bin apart, and fine colours that differ. So
    at each such pixel the fine stage of ``mc``/``mf`` is run again, through
    the forward ``kernel`` and through the plain model, on the same depths
    (the kernel path's), and the two composited colours must agree to
    ``RENDER_RGB_TOL``.
    """
    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import encode_points, render_rays
    from nerf_tpu_torch.ops import (
        coarse_z_values, get_ray_bundle, sample_pdf, volume_render_radiance_field,
    )

    h, w, focal = hwf
    poses = resolve_render_poses(cfg)[0]
    ro, rd = get_ray_bundle(h, w, focal, torch.as_tensor(poses[0], device=DEVICE))
    ro, rd = ro.reshape(-1, 3)[pixels], rd.reshape(-1, 3)[pixels]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    s = render_settings_from_config(cfg, "validation", hwf=hwf)
    with torch.inference_mode():
        z = coarse_z_values(torch.full((len(pixels),), s.near, device=DEVICE), s.far,
                            s.num_coarse)
        z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
        coarse = {k: render_rays(mc, None, ro, rd, dataclasses.replace(s, use_pallas=k,
                                                                        num_fine=0)).coarse
                  for k in (True, False)}
        z_fine = {k: sample_pdf(z_mid, c.weights[:, 1:-1], s.num_fine, det=True)
                  for k, c in coarse.items()}
        z_all, _ = torch.sort(torch.cat([z, z_fine[True]], dim=-1), dim=-1)
        pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
        rgb = {
            "kernel": kernel(mf, pts, vd),
            "plain": mf(encode_points(pts, vd, s)),
        }
        rgb = {k: volume_render_radiance_field(v, z_all, rd, white_background=True).rgb
               for k, v in rgb.items()}
    w_err = (coarse[True].weights - coarse[False].weights).abs().amax(dim=-1)
    z_err = (z_fine[True] - z_fine[False]).abs().amax(dim=-1)
    same_z_err = (rgb["kernel"] - rgb["plain"]).abs().amax(dim=-1)
    print(f"[main]   at those pixels: coarse weights differ by at most {float(w_err.max()):.3e}, "
          f"resampled z by {float(z_err.min()):.3e} to {float(z_err.max()):.3e}; "
          f"on common z, rgb_fine kernel vs plain differ by at most "
          f"{float(same_z_err.max()):.3e}")
    check(bool((same_z_err <= RENDER_RGB_TOL).all()),
          "rgb_fine outliers that differ on common depth samples")


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name as source:name, its bool template argument as
    <0>/<1> (the f32 / bf16 instance)."""
    import re

    source = re.search(r"_\d+_([a-z_]+?)_cu_", mangled)
    kernel = re.search(r"\d+([a-z_]+)_kernel(ILb([01])E)?", mangled)
    if kernel is None:
        return mangled
    return (f"{source.group(1) if source else '?'}:{kernel.group(1)}"
            + (f"<{kernel.group(3)}>" if kernel.group(2) else ""))


def ptxas_summary(log: str, frames: bool = False) -> str:
    """``nvcc -Xptxas -v``'s report as one line: each kernel as source:name
    (``kernel_label``), its registers and, where it spills, the spill
    store/load bytes; with ``frames``, its stack frame bytes too."""
    import re

    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_label(entry.group(1))
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frames and frame and name and frame.group(1) != "0":
            name += f" [frame {frame.group(1)}]"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name and spill.groups() != ("0", "0"):
            name += f" ({spill.group(1)}/{spill.group(2)})"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name} {regs.group(1)}")
            name = None
    return ", ".join(out)


def sass_mma_counts(lib) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of the built
    library ``lib``, by ``cuobjdump -sass``: kernel_label -> count."""
    import re

    from nerf_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = kernel_label(head.group(1))
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


# The kernels that must run on the tensor cores.
TENSOR_CORE_KERNELS = ("mlp_t:mlp_t<1>", "flex_train:train_fwd<1>",
                       "flex_train:train_bwd_act<1>", "flex_train:train_bwd_wgrad<1>",
                       "mlp:flexible_mlp<1>", "mlp:flexible_mlp_rays<1>", "stage:stage<1>",
                       "paper_t:paper_t<1>", "paper_train:train_fwd<1>",
                       "paper_train:train_bwd_act<1>", "paper_train:train_bwd_wgrad<1>",
                       "flex_train:train_bwd_act_one<1>", "paper_train:train_bwd_act_one<1>")


# The f32 4x128 forwards (#8's one-scene kernel too), on flex_mlp.cuh's
# register-blocked FMA body: none may spill.
F32_FLEX_KERNELS = ("mlp_t:mlp_t<0>", "flex_train:train_fwd<0>", "mlp:flexible_mlp<0>",
                    "mlp:flexible_mlp_rays<0>", "stage:stage<0>", "flex_train:train_fwd_one<0>")
# #8's f32 backward passes, the layer gradient on flex_mlp.cuh's body and
# the weight gradient on fma_wgrad.cuh's register blocks: neither may spill.
F32_FLEX_BWD_KERNELS = ("flex_train:train_bwd_act<0>", "flex_train:train_bwd_wgrad<0>")
# #10's forward and backward, f32 and bf16 features: none may spill.
HASH_KERNELS = ("hashgrid:hash_encode_fwd<0>", "hashgrid:hash_encode_fwd<1>",
                "hashgrid:hash_encode_bwd<0>", "hashgrid:hash_encode_bwd<1>")
# The f32 8x256 Paper kernels, on paper_mlp.cuh's register-blocked FMA body
# and fma_wgrad.cuh's register-blocked weight-gradient pass: none may spill.
F32_PAPER_KERNELS = ("paper_t:paper_t<0>", "paper_train:train_fwd<0>",
                     "paper_train:train_bwd_act<0>", "paper_train:train_bwd_wgrad<0>",
                     "paper_train:train_fwd_one<0>")
# #9's bf16 weight-gradient pass, persistent on wgmma (wgrad_wg.cuh): its
# consumers keep 128 f32 sums a thread in registers, and must not spill.
WGMMA_BWD_KERNELS = ("paper_train:train_bwd_wgrad<1>",)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def quiet():
    """Keep the progress lines of what runs inside (the trainer's, the eval
    loop's, the server's request log) out of the output, which a run must
    keep short; failures still raise."""
    import contextlib
    import io

    return contextlib.redirect_stdout(io.StringIO())


def launch_counters():
    """Every kernel wrapper's launch counter: name -> (holder, attribute)."""
    from nerf_tpu_torch.kernels.composite import fused_volume_render
    from nerf_tpu_torch.kernels.flex_train import fused_flex_mlp_train
    from nerf_tpu_torch.kernels.mlp import fused_flexible_mlp, fused_flexible_mlp_rays
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.kernels.paper_t import fused_paper_mlp_t
    from nerf_tpu_torch.kernels.paper_train import fused_paper_mlp_train
    from nerf_tpu_torch.kernels.resample import fused_sample_pdf
    from nerf_tpu_torch.kernels.stage import fused_render_stage

    return {
        "fused_mlp_t": (fused_mlp_t, "launches"),
        "fused_flex_mlp_train_fwd": (fused_flex_mlp_train, "fwd_launches"),
        "fused_flex_mlp_train_bwd": (fused_flex_mlp_train, "bwd_launches"),
        "fused_paper_mlp_t": (fused_paper_mlp_t, "launches"),
        "fused_paper_mlp_train_fwd": (fused_paper_mlp_train, "fwd_launches"),
        "fused_paper_mlp_train_bwd": (fused_paper_mlp_train, "bwd_launches"),
        "fused_paper_mlp_train_wgmma_bwd": (fused_paper_mlp_train, "wgmma_bwd_launches"),
        "fused_volume_render": (fused_volume_render, "launches"),
        "fused_sample_pdf": (fused_sample_pdf, "launches"),
        "fused_render_stage": (fused_render_stage, "launches"),
        "fused_flexible_mlp": (fused_flexible_mlp, "launches"),
        "fused_flexible_mlp_rays": (fused_flexible_mlp_rays, "launches"),
    }


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (just before a main path runs)."""
    for holder, attr in launch_counters().values():
        setattr(holder, attr, 0)


def read_launches() -> dict:
    return {name: getattr(holder, attr) for name, (holder, attr) in launch_counters().items()}


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS):
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes over the memory rate. Returns
    (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, pattern: str) -> dict:
    """Device milliseconds per call of ``fn()`` by ``torch.profiler`` over
    ``reps`` calls after a warm-up: each kernel whose name matches the
    regular expression ``pattern``, under the matched text, and the rest of
    its device work as "other". Unlike ``cuda_ms`` it reads the kernels'
    own time, not the host's rate of enqueueing them."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"other": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != torch.autograd.DeviceType.CUDA or not t:
            continue
        name = re.search(pattern, e.key)
        label = name.group(0) if name else "other"
        out[label] = out.get(label, 0.0) + t / 1e3 / reps
    return out


def frame_seconds(render, pose) -> float:
    """Host seconds for one frame, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(pose)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-12))


def train_case(n: int, s: int, model, dev, seed: int):
    """Inputs of the training kernel pair at a training pass's shape: orbit
    points, the direction contribution, the packed parameters and a random
    cotangent."""
    import torch

    from nerf_tpu_torch.kernels.mlp import dir_contribution, pack_params

    pts, vd = orbit_points(n, s, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn(n, s, 4, generator=gen, device=dev)
    return pts, dir_contribution(model, vd).detach(), pack_params(model).detach(), g


def flex_pair_errors(pts, dc, params, g, n: int, s: int, dtype: str) -> dict:
    """The #8 pair against its plain version on one input: the forward's
    largest error ("fwd"), its residuals' (each scaled by the plain one's
    largest entry, "res"), and the 16 gradient leaves' and ddc's, scaled
    ("bwd", at "bwd_at"), the backward held against the plain backward on
    the forward kernel's own residuals (``residuals_as_plain``): a bf16
    tensor-core sum in another order flips roundings and ReLU masks that the
    backward then follows. "repeatable": two backward calls bitwise equal."""
    import torch

    from nerf_tpu_torch.kernels.flex_train import (
        flex_train_bwd, flex_train_fwd, flex_train_plain_bwd, flex_train_plain_fwd,
        residuals_as_plain,
    )
    from nerf_tpu_torch.kernels.mlp import unpack_params

    out, res = flex_train_fwd(pts, dc, params, dtype)
    grad, ddc = flex_train_bwd(g, res, params, n, s, dtype)
    again = flex_train_bwd(g, res, params, n, s, dtype)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all() and torch.isfinite(grad).all()
               and torch.isfinite(ddc).all()), f"training kernels at ({n}, {s}) {dtype}")
    want, want_res = flex_train_plain_fwd(pts, dc, params, dtype)
    kernel_res = residuals_as_plain(res, n * s, dtype)
    want_grad, want_ddc = flex_train_plain_bwd(g, kernel_res, params, n, s, dtype)
    errs = {"ddc": float((ddc - want_ddc).abs().max() / want_ddc.abs().max())}
    got_leaves = unpack_params(grad)
    for name, leaves in unpack_params(want_grad).items():
        for leaf, got, ref in zip(("weight", "bias"), got_leaves[name], leaves):
            errs[f"{name}.{leaf}"] = float((got - ref).abs().max()
                                           / ref.abs().max().clamp(min=1e-30))
    b_name, b_err = max(errs.items(), key=lambda kv: kv[1])
    return {"fwd": float((out - want).abs().max()), "bwd": b_err, "bwd_at": b_name,
            "res": max(float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
                       for a, b in zip(kernel_res, want_res)),
            "repeatable": torch.equal(grad, again[0]) and torch.equal(ddc, again[1])}


def check_training_kernels(model, dev) -> dict:
    """Phase 6: the training kernel pair against its plain version
    (``flex_pair_errors``). Returns the worst error of each kernel per dtype
    (gradients scaled by the plain gradient's largest entry, per leaf)."""
    worst = {(k, d): 0.0 for k in ("fwd", "bwd") for d in ("float32", "bfloat16")}
    fwd_tols = {"float32": F32_TOL, "bfloat16": TC_BF16_FWD_TOL}
    print(f"[train-kernel] forward/residuals/gradients vs plain (tol {F32_TOL:g}, bf16 "
          f"{TC_BF16_FWD_TOL:g}/{BF16_TOL:g}/{BF16_TOL:g}), backward repeatable:")
    for n, s in TRAIN_CHECK_SHAPES:
        pts, dc, params, g = train_case(n, s, model, dev, seed=n * s)
        parts = []
        for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            e = flex_pair_errors(pts, dc, params, g, n, s, dtype)
            worst["fwd", dtype] = max(worst["fwd", dtype], e["fwd"])
            worst["bwd", dtype] = max(worst["bwd", dtype], e["bwd"])
            parts.append(f"{dtype[:4]} {e['fwd']:.2e}/{e['res']:.2e}/{e['bwd']:.2e} "
                         f"({e['bwd_at']})")
            check(e["repeatable"], f"training backward at ({n}, {s}) {dtype} not repeatable")
            check(e["fwd"] <= fwd_tols[dtype], f"training forward at ({n}, {s}) {dtype}: {e}")
            check(e["res"] <= tol and e["bwd"] <= tol, f"training pair at ({n}, {s}) {dtype}: {e}")
        print(f"[train-kernel] ({n}, {s}): {'; '.join(parts)}")
    return worst


def training_loss_trajectories(cfg, dev, family: str = "FlexibleNeRFModel"):
    """Phases 7 and 10, part 3: TRAJECTORY_STEPS float32 steps (perturb off,
    noise 0) through the training kernels and through the plain path, from
    the same seeded models, on the same seeded ray batches. Returns both loss
    lists."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset
    from nerf_tpu_torch.engine.train import create_train_state, make_train_loop

    data = make_synthetic_dataset(num_views=4, height=100, width=100, device=dev)
    store = [torch.as_tensor(a, device=dev) for a in flatten_rays(data, dev)]
    base = dataclasses.replace(render_settings_from_config(cfg, "train", hwf=data.hwf),
                               perturb=False, radiance_field_noise_std=0.0,
                               compute_dtype="float32")
    losses = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        mc = seeded_model(SEED, opacify=False, family=family).train().to(dev)
        mf = seeded_model(SEED + 1, opacify=False, family=family).train().to(dev)
        state = create_train_state(mc, mf, optimizer_from_config(cfg))
        loop = make_train_loop(mc, mf, dataclasses.replace(base, use_pallas_train=kernel),
                               int(cfg.nerf.train.num_random_rays), TRAJECTORY_STEPS)
        state, metrics = loop(state, *store, SEED)
        losses[label] = metrics.loss.cpu()
    return losses["kernel"], losses["plain"]


def train_main_path(cfg, tmp: str, dev) -> dict:
    """Phase 7: train through ``train_nerf.train`` and check what it did and
    what it wrote. Returns the launch counts and the numbers it printed."""
    import torch

    from nerf_tpu_torch.data import render_analytic_image, resolve_render_poses
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.train_nerf import train

    reset_launches()
    with quiet():
        run = train(cfg, logdir=os.path.join(tmp, "train"), device=DEVICE)
    counts = read_launches()
    launches = {"fwd": counts["fused_flex_mlp_train_fwd"],
                "bwd": counts["fused_flex_mlp_train_bwd"]}
    steps = len(run.losses)
    print(f"[train] {steps} steps of {cfg.nerf.train.num_random_rays} rays, "
          f"{cfg.nerf.train.compute_dtype}: {launches['fwd']} forward and {launches['bwd']} "
          f"backward kernel launches (expected {2 * steps} each); "
          f"{run.rays_per_sec:,.0f} rays/s over {run.seconds:.2f} s")
    check(steps == TRAIN_STEPS, f"{steps} steps trained")
    check(launches["fwd"] == 2 * steps and launches["bwd"] == 2 * steps,
          f"training kernel launches {launches} != {2 * steps} each")
    losses = torch.tensor(run.losses)
    check(bool(torch.isfinite(losses).all()), "non-finite training loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"[train] mean loss of the first 20 steps {first:.5f}, of the last 20 {last:.5f}; "
          f"validation PSNR {run.val_psnrs[-1]:.2f} dB")
    check(last < first, f"the loss did not fall: {first} -> {last}")
    check(run.checkpoint is not None and os.path.exists(run.checkpoint), "no checkpoint")

    reset_launches()
    with quiet():
        rendered = render_trajectory(cfg, run.checkpoint, os.path.join(tmp, "trained"),
                                     num_poses=1, renderer="kernel", device=DEVICE)
    render_launches = read_launches()["fused_mlp_t"]
    check(render_launches > 0 and all(rendered.finite), "trained render did not use the kernel")
    poses, h, w, focal = resolve_render_poses(cfg)
    truth = torch.as_tensor(render_analytic_image(h, w, focal, poses[0], device=dev))
    db = psnr(rendered.first_maps["rgb_fine"], truth)
    print(f"[train] the trained checkpoint rendered at orbit pose 0 (a novel view) through "
          f"the forward kernel ({render_launches} launches): PSNR {db:.2f} dB against the "
          f"analytic scene (floor {PSNR_FLOOR_TRAINED_DB})")
    check(db >= PSNR_FLOOR_TRAINED_DB, f"trained render PSNR {db} < {PSNR_FLOOR_TRAINED_DB}")

    kernel, plain = training_loss_trajectories(cfg, dev)
    rel = float(((kernel - plain).abs() / plain.abs()).max())
    print(f"[train] {TRAJECTORY_STEPS}-step float32 trajectory, kernel path vs plain path: "
          f"loss {float(kernel[0]):.5f} -> {float(kernel[-1]):.5f}, max relative difference "
          f"per step {rel:.3e} (tol {TRAJECTORY_RTOL:g})")
    check(rel <= TRAJECTORY_RTOL, f"kernel vs plain trajectory: {rel} > {TRAJECTORY_RTOL}")
    return {"launches": launches, "render_launches": render_launches, "psnr": db,
            "rays_per_sec": run.rays_per_sec, "checkpoint": run.checkpoint}


def ntc_state(ckpt_path: str) -> dict:
    """A reference .ckpt's step, weights, loss and PSNR as the dict a native
    .ntc holds (the JAX trainer's keys, params in the JAX layout)."""
    import torch

    from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return {"step": int(ckpt["iter"]),
            "params_coarse": convert_torch_state_dict(ckpt["model_coarse_state_dict"]),
            "params_fine": convert_torch_state_dict(ckpt["model_fine_state_dict"]),
            "loss": float(ckpt["loss"]), "psnr": float(ckpt["psnr"])}


def time_training(cfg, dev, on: str) -> dict:
    """Phase 8: the training kernel pair against the plain pair at
    TRAIN_SHAPE, and training-step rays/s on the kernel and plain paths, in
    turns (plain, kernel, kernel, plain)."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset
    from nerf_tpu_torch.engine.train import create_train_state, make_train_loop
    from nerf_tpu_torch.kernels.flex_train import (
        flex_train_bwd, flex_train_fwd, flex_train_plain_bwd, flex_train_plain_fwd,
    )

    times = {}
    model = seeded_model(SEED, opacify=False).to(dev)
    n, s = TRAIN_SHAPE
    pts, dc, params, g = train_case(n, s, model, dev, seed=3)
    for dtype in ("float32", "bfloat16"):
        _, res = flex_train_fwd(pts, dc, params, dtype)
        _, plain_res = flex_train_plain_fwd(pts, dc, params, dtype)
        fns = {
            "fwd": (lambda: flex_train_fwd(pts, dc, params, dtype),
                    lambda: flex_train_plain_fwd(pts, dc, params, dtype)),
            "bwd": (lambda: flex_train_bwd(g, res, params, n, s, dtype),
                    lambda: flex_train_plain_bwd(g, plain_res, params, n, s, dtype)),
        }
        parts = []
        for which, (kernel, plain) in fns.items():
            p1, k1, k2, p2 = (cuda_ms(f, 10) for f in (plain, kernel, kernel, plain))
            times[which, dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            parts.append(f"{which} kernel {k1:.3f} / {k2:.3f}, plain {p1:.3f} / {p2:.3f}")
        print(f"[time] fused_flex_mlp_train ({n}, {s}) {dtype}, ms: {'; '.join(parts)} {on}")
        del res, plain_res

    data = make_synthetic_dataset(num_views=4, height=100, width=100, device=dev)
    store = [torch.as_tensor(a, device=dev) for a in flatten_rays(data, dev)]
    batch = int(cfg.nerf.train.num_random_rays)
    base = render_settings_from_config(cfg, "train", hwf=data.hwf)
    loops = {}
    for dtype in ("float32", "bfloat16"):
        for label, kernel in (("plain", False), ("kernel", True)):
            mc = seeded_model(SEED, opacify=False).train().to(dev)
            mf = seeded_model(SEED + 1, opacify=False).train().to(dev)
            settings = dataclasses.replace(base, use_pallas_train=kernel, compute_dtype=dtype)
            state = create_train_state(mc, mf, optimizer_from_config(cfg))
            loop = make_train_loop(mc, mf, settings, batch, TIMED_STEPS)
            state, _ = loop(state, *store, SEED)      # warm-up
            loops[label, dtype] = (loop, state)
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("float32", "bfloat16"):
        secs = {}
        for label in ("plain", "kernel", "kernel", "plain"):
            loop, state = loops[label, dtype]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = loop(state, *store, SEED)
            metrics.loss.cpu()
            torch.cuda.synchronize()
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        parts = []
        for label, turns in secs.items():
            rates = [batch * TIMED_STEPS / t for t in turns]
            times["step", label, dtype] = sum(rates) / len(rates)
            parts.append(f"{label} {' / '.join(f'{1e3 * t / TIMED_STEPS:.3f}' for t in turns)} "
                         f"ms ({times['step', label, dtype]:,.0f} rays/s)")
        print(f"[time] training step, {batch} rays, {base.num_coarse}+{base.num_fine} samples, "
              f"{dtype}: {'; '.join(parts)} {on}")
    print(f"[time] peak device memory over those training steps: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")
    loop, state = loops["kernel", "bfloat16"]
    profile_steps(lambda: loop(state, *store, SEED)[1].loss.cpu(), TIMED_STEPS,
                  "training step, kernel path bfloat16", on)
    return times


def paper_case(n: int, s: int, model, dev, seed: int):
    """Inputs of the Paper kernels at a render or training pass's shape:
    orbit points, viewdirs, the direction contribution, the packed
    parameters and a random cotangent."""
    import torch

    from nerf_tpu_torch.kernels.paper_t import dir_contribution, pack_params

    pts, vd = orbit_points(n, s, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn(n, s, 4, generator=gen, device=dev)
    return pts, vd, dir_contribution(model, vd).detach(), pack_params(model).detach(), g


def paper_grad_errors(grad, ddc, want_grad, want_ddc, f: int) -> dict:
    """Each Paper gradient leaf's and ddc's largest error, scaled by the
    plain one's largest entry."""
    from nerf_tpu_torch.kernels.paper_t import unpack_params

    errs = {"ddc": float((ddc - want_ddc).abs().max() / want_ddc.abs().max())}
    got_leaves = unpack_params(grad, f)
    for name, leaves in unpack_params(want_grad, f).items():
        for leaf, a, b in zip(("weight", "bias"), got_leaves[name], leaves):
            errs[f"{name}.{leaf}"] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    return errs


def check_paper_kernels(dev) -> dict:
    """Phase 9: the Paper forward kernel and training pair against their
    plain versions at 10 frequencies, and once each at 6, 0 and 16: the forward's
    output and residuals against the plain forward's, the backward against
    the plain backward on the same inputs (the cotangent and the forward
    kernel's residuals), and the bf16 pair alone at PAPER_TRAIN_SHAPES too.
    Returns the worst error of each kernel per dtype
    (residuals and gradients scaled by the plain one's largest entry, per
    residual and per leaf)."""
    import torch

    from nerf_tpu_torch.kernels.paper_t import fused_paper_mlp_t, paper_t_plain
    from nerf_tpu_torch.kernels.paper_train import (
        fused_paper_mlp_train, paper_train_bwd, paper_train_fwd, paper_train_plain_bwd,
        paper_train_plain_fwd, residuals_as_plain,
    )
    from nerf_tpu_torch.models import PaperNeRFModel

    models = {f: PaperNeRFModel(num_encoding_fn_xyz=f, num_encoding_fn_dir=4,
                                generator=torch.Generator().manual_seed(SEED + f)).to(dev)
              for f in PAPER_FREQS}
    tols = (("float32", F32_TOL), ("bfloat16", BF16_TOL))
    fwd_tols = {"float32": F32_TOL, "bfloat16": TC_BF16_FWD_TOL}
    worst = {(k, d): 0.0 for k in ("t", "fwd", "bwd") for d in ("float32", "bfloat16")}
    lines = []
    with torch.inference_mode():
        for f, (n, s) in [(10, shape) for shape in PAPER_CHECK_SHAPES] + [
                (f, (1000, 128)) for f in PAPER_FREQS if f != 10]:
            pts, vd, _, _, _ = paper_case(n, s, models[f], dev, seed=n + s)
            errs = []
            for dtype, tol in tols:
                got = fused_paper_mlp_t(models[f], pts, vd, dtype)
                torch.cuda.synchronize()
                err = float((got - paper_t_plain(models[f], pts, vd, dtype)).abs().max())
                check(got.shape == (n, s, 4) and bool(torch.isfinite(got).all()),
                      f"paper kernel output at ({n}, {s}) {dtype}")
                worst["t", dtype] = max(worst["t", dtype], err)
                errs.append(err)
                check(err <= fwd_tols[dtype],
                      f"paper kernel at ({n}, {s}) F={f} {dtype}: {err} > {fwd_tols[dtype]}")
            lines.append(f"({n}, {s}) F={f} {errs[0]:.2e}/{errs[1]:.2e}")
    print(f"[paper-kernel] fused_paper_mlp_t max |kernel - plain| f32/bf16 (tol {F32_TOL:g}/"
          f"{TC_BF16_FWD_TOL:g}): {', '.join(lines)}")
    lines = []
    with torch.inference_mode():
        # The bf16 instance (paper_wg.cuh's wgmma body) alone at a 400x400
        # frame's four shapes (coarse and fine, a whole chunk and the rest)
        # and at ragged ones: points ending mid-tile, samples that do not
        # divide a consumer's 64 points, so that one slab's dc rows span rays.
        for n, s in PAPER_FRAME_SHAPES + ((777, 48), (333, 100)):
            pts, vd, _, _, _ = paper_case(n, s, models[10], dev, seed=n + s + 1)
            before = (fused_paper_mlp_t.launches, fused_paper_mlp_t.wgmma_launches)
            got = fused_paper_mlp_t(models[10], pts, vd, "bfloat16")
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"paper bf16 kernel output at ({n}, {s})")
            check((fused_paper_mlp_t.launches, fused_paper_mlp_t.wgmma_launches)
                  == (before[0] + 1, before[1] + 1),
                  f"paper bf16 kernel at ({n}, {s}) not one wgmma launch")
            err = max(float((got[i:i + PLAIN_CHUNK] - paper_t_plain(
                models[10], pts[i:i + PLAIN_CHUNK], vd[i:i + PLAIN_CHUNK], "bfloat16")
                             ).abs().max()) for i in range(0, n, PLAIN_CHUNK))
            worst["t", "bfloat16"] = max(worst["t", "bfloat16"], err)
            check(err <= TC_BF16_FWD_TOL, f"paper bf16 kernel at ({n}, {s}): {err}")
            lines.append(f"({n}, {s}) {err:.2e}")
            del pts, vd, got
    print(f"[paper-kernel] fused_paper_mlp_t bf16 (wgmma, one launch each) max |kernel - plain| "
          f"(tol {TC_BF16_FWD_TOL:g}): {', '.join(lines)}")
    with torch.no_grad():
        # The bf16 pair alone at paper_train's own shapes, where wgrad_wg.cuh's
        # persistent body walks whole chunks of many work items.
        for f, (n, s), dtypes in [(10, shape, tols) for shape in TRAIN_CHECK_SHAPES] + [
                (f, (333, 61), tols) for f in PAPER_FREQS if f != 10] + [
                (10, shape, tols[1:]) for shape in PAPER_TRAIN_SHAPES]:
            pts, _, dc, params, g = paper_case(n, s, models[f], dev, seed=n * s)
            parts = []
            for dtype, tol in dtypes:
                wgmma0 = fused_paper_mlp_train.wgmma_bwd_launches
                out, res = paper_train_fwd(pts, dc, params, dtype, f)
                grad, ddc = paper_train_bwd(g, res, params, n, s, dtype, f)
                again = paper_train_bwd(g, res, params, n, s, dtype, f)
                torch.cuda.synchronize()
                check(torch.equal(grad, again[0]) and torch.equal(ddc, again[1]),
                      f"paper backward at ({n}, {s}) {dtype} not bitwise repeatable")
                check(fused_paper_mlp_train.wgmma_bwd_launches - wgmma0
                      == 2 * (dtype == "bfloat16"),
                      f"paper backward at ({n}, {s}) {dtype}: weight gradients on wgmma "
                      f"{fused_paper_mlp_train.wgmma_bwd_launches - wgmma0} of 2 calls")
                want, want_res = paper_train_plain_fwd(pts, dc, params, dtype, f)
                kernel_res = residuals_as_plain(res, n * s, f, dtype)
                want_grad, want_ddc = paper_train_plain_bwd(g, kernel_res, params, n, s, dtype, f)
                check(bool(torch.isfinite(out).all() and torch.isfinite(grad).all()
                           and torch.isfinite(ddc).all()), f"paper training kernels ({n}, {s})")
                f_err = float((out - want).abs().max())
                r_err = max(float((a.float() - b.float()).abs().max()
                                  / b.float().abs().max().clamp(min=1e-30))
                            for a, b in zip(kernel_res, want_res))
                b_name, b_err = max(paper_grad_errors(grad, ddc, want_grad, want_ddc, f).items(),
                                    key=lambda kv: kv[1])
                worst["fwd", dtype] = max(worst["fwd", dtype], f_err)
                worst["bwd", dtype] = max(worst["bwd", dtype], b_err)
                parts.append(f"{dtype[:4]} {f_err:.2e}/{r_err:.2e}/{b_err:.2e} ({b_name})")
                check(f_err <= fwd_tols[dtype],
                      f"paper training forward ({n}, {s}) {dtype}: {f_err}")
                check(r_err <= tol, f"paper training residuals ({n}, {s}) {dtype}: {r_err}")
                check(b_err <= tol, f"paper gradient {b_name} ({n}, {s}) {dtype}: {b_err}")
                del res, want_res, kernel_res, out, want, grad, ddc, again, want_grad, want_ddc
            print(f"[paper-train-kernel] ({n}, {s}) F={f}: {'; '.join(parts)}")
    # Through the autograd entry point: layers_dir.3 ends with a zero gradient.
    model = models[10]
    pts, vd, _, _, _ = paper_case(1024, 64, model, dev, seed=9)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    fused_paper_mlp_train(model, pts, vd, "bfloat16").square().sum().backward()
    dead = float(model.layers_dir[3].weight.grad.abs().max()
                 + model.layers_dir[3].bias.grad.abs().max())
    print(f"[paper-train-kernel] above: forward/13 residuals/28 leaves' and ddc's gradients, "
          f"scaled; tol f32 {F32_TOL:g}, bf16 {TC_BF16_FWD_TOL:g}/{BF16_TOL:g}/"
          f"{BF16_TOL:g}; two backward calls bitwise equal at every shape, each bf16 one's "
          f"weight gradients on wgmma (wgmma_bwd_launches); layers_dir.3 "
          f"gradient after a backward through the kernels: max |g| = {dead} (must be 0)")
    check(dead == 0.0, "layers_dir.3 got a gradient")
    return worst


def paper_config(train_iters: int):
    """configs/lego_paper.yml on the synthetic scene, cut to ``train_iters``
    steps. train()'s own validation renders through the plain path
    (lego_paper.yml's validation section has no use_pallas), at PLAIN_CHUNK
    rays a chunk."""
    cfg = synthetic_train_config(train_iters, base=lego_paper_config)
    cfg.merge_from_list(["nerf.validation.chunksize", PLAIN_CHUNK])
    return cfg


def paper_main_path(cfg, tmp: str, dev) -> dict:
    """Phase 10: train the Paper protocol through ``train_nerf.train``,
    render its checkpoint through ``eval_nerf.render_trajectory`` and the
    forward kernel, and check both against the plain path."""
    import torch

    from nerf_tpu_torch.data import render_analytic_image, resolve_render_poses
    from nerf_tpu_torch.engine.checkpoint import load_models_and_params
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.kernels.paper_t import fused_paper_mlp_t
    from nerf_tpu_torch.train_nerf import train

    reset_launches()
    with quiet():
        run = train(cfg, logdir=os.path.join(tmp, "paper_train"), device=DEVICE)
    counts = read_launches()
    launches = {"fwd": counts["fused_paper_mlp_train_fwd"],
                "bwd": counts["fused_paper_mlp_train_bwd"],
                "wgmma_bwd": counts["fused_paper_mlp_train_wgmma_bwd"]}
    steps = len(run.losses)
    print(f"[paper-train] {steps} steps of {cfg.nerf.train.num_random_rays} rays, 8x256, "
          f"{cfg.nerf.train.compute_dtype}: {launches['fwd']} forward and {launches['bwd']} "
          f"backward kernel launches (expected {2 * steps} each), {launches['wgmma_bwd']} "
          f"with the weight gradients on wgmma; "
          f"{run.rays_per_sec:,.0f} rays/s over {run.seconds:.2f} s")
    check(steps == PAPER_TRAIN_STEPS, f"{steps} Paper steps trained")
    check(launches["fwd"] == 2 * steps and launches["bwd"] == 2 * steps,
          f"Paper training kernel launches {launches} != {2 * steps} each")
    check(launches["wgmma_bwd"] == launches["bwd"]
          or cfg.nerf.train.compute_dtype != "bfloat16",
          f"Paper bf16 backward launches {launches}: not all on the wgmma body")
    losses = torch.tensor(run.losses)
    check(bool(torch.isfinite(losses).all()), "non-finite Paper training loss")
    k = min(20, steps // 2)
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    print(f"[paper-train] mean loss of the first {k} steps {first:.5f}, of the last {k} "
          f"{last:.5f}; validation PSNR {run.val_psnrs[-1]:.2f} dB")
    check(last < first, f"the Paper loss did not fall: {first} -> {last}")
    check(run.checkpoint is not None and os.path.exists(run.checkpoint), "no Paper checkpoint")

    kernel_cfg = cfg.clone()
    kernel_cfg.merge_from_list(["nerf.validation.chunksize", 131072])   # lego_paper.yml's
    poses, h, w, focal = resolve_render_poses(cfg)
    expected = 2 * math.ceil(h * w / 131072)
    reset_launches()
    with quiet():
        rendered = render_trajectory(kernel_cfg, run.checkpoint,
                                     os.path.join(tmp, "paper_kernel"), num_poses=1,
                                     renderer="kernel", device=DEVICE)
    render_launches = read_launches()["fused_paper_mlp_t"]
    check(render_launches == expected and all(rendered.finite),
          f"Paper render: {render_launches} kernel launches, expected {expected}")
    truth = torch.as_tensor(render_analytic_image(h, w, focal, poses[0], device=dev))
    db = psnr(rendered.first_maps["rgb_fine"], truth)
    print(f"[paper-main] the trained checkpoint rendered at orbit pose 0 (a novel view) "
          f"through the forward kernel ({render_launches} launches, expected {expected}): "
          f"PSNR {db:.2f} dB against the analytic scene (floor {PAPER_PSNR_FLOOR_DB})")
    check(db >= PAPER_PSNR_FLOOR_DB, f"Paper render PSNR {db} < {PAPER_PSNR_FLOOR_DB}")

    with quiet():
        plain = render_trajectory(cfg, run.checkpoint, os.path.join(tmp, "paper_plain"),
                                  num_poses=1, renderer="plain", device=DEVICE)
    maps, ref = rendered.first_maps, plain.first_maps
    err = float((maps["rgb_coarse"] - ref["rgb_coarse"]).abs().max())
    fine_err = (maps["rgb_fine"] - ref["rgb_fine"]).abs().amax(dim=-1).reshape(-1)
    outliers = torch.nonzero(fine_err > RENDER_RGB_TOL).flatten()
    print(f"[paper-main] frame 0, kernel path (chunk 131072) vs plain path (chunk "
          f"{PLAIN_CHUNK}): rgb_coarse max |diff| {err:.3e} (tol {RENDER_RGB_TOL:g}); rgb_fine "
          f"max {float(fine_err.max()):.3e}, {len(outliers)} of {fine_err.numel()} pixels over "
          f"{RENDER_RGB_TOL:g} (at most {MAX_RESAMPLE_PIXELS}, each a moved resample)")
    check(err <= RENDER_RGB_TOL, f"Paper rgb_coarse kernel vs plain: {err}")
    check(len(outliers) <= MAX_RESAMPLE_PIXELS, f"{len(outliers)} Paper rgb_fine outliers")
    if len(outliers):
        mc, mf, _ = load_models_and_params(run.checkpoint, cfg, DEVICE)
        check_resample_outliers(cfg, outliers, (h, w, focal), mc, mf, fused_paper_mlp_t)

    kernel, plain_losses = training_loss_trajectories(cfg, dev, family="PaperNeRFModel")
    rel = float(((kernel - plain_losses).abs() / plain_losses.abs()).max())
    print(f"[paper-train] {TRAJECTORY_STEPS}-step float32 trajectory, kernel path vs plain "
          f"path: loss {float(kernel[0]):.5f} -> {float(kernel[-1]):.5f}, max relative "
          f"difference per step {rel:.3e} (tol {TRAJECTORY_RTOL:g})")
    check(rel <= TRAJECTORY_RTOL, f"Paper kernel vs plain trajectory: {rel} > {TRAJECTORY_RTOL}")
    return {"launches": launches, "render_launches": render_launches, "psnr": db,
            "checkpoint": run.checkpoint}


def time_paper(cfg, checkpoint: str, dev, on: str) -> dict:
    """Phase 11: the Paper kernels against their plain versions, frame
    seconds and training rays/s on the kernel and plain paths, in turns
    (plain, kernel, kernel, plain)."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset, resolve_render_poses
    from nerf_tpu_torch.engine.checkpoint import load_models_and_params
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn
    from nerf_tpu_torch.engine.train import create_train_state, make_train_loop
    from nerf_tpu_torch.kernels.paper_t import fused_paper_mlp_t, paper_t_plain
    from nerf_tpu_torch.kernels.paper_train import (
        paper_train_bwd, paper_train_fwd, paper_train_plain_bwd, paper_train_plain_fwd,
    )

    times = {}
    model = seeded_model(SEED, opacify=False, family="PaperNeRFModel").to(dev)
    with torch.inference_mode():
        n, s = KERNEL_CHUNK
        pts, vd, _, _, _ = paper_case(n, s, model, dev, seed=1)
        step = n // (KERNEL_CHUNK[0] // PLAIN_CHUNK)

        def plain_chunked(dtype):
            # The plain version over the same chunk, PLAIN_CHUNK rays at a time
            # (one call at 131072 x 128 would hold ~60 GB of activations).
            for i in range(0, n, step):
                paper_t_plain(model, pts[i:i + step], vd[i:i + step], dtype)

        parts = []
        for dtype in ("float32", "bfloat16"):
            p1 = cuda_ms(lambda: plain_chunked(dtype), 1)
            k1 = cuda_ms(lambda: fused_paper_mlp_t(model, pts, vd, dtype), 2)
            k2 = cuda_ms(lambda: fused_paper_mlp_t(model, pts, vd, dtype), 2)
            p2 = cuda_ms(lambda: plain_chunked(dtype), 1)
            times["t", dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            gflop = 2 * n * s * PAPER_MACS_PER_POINT / 1e9
            parts.append(f"{dtype} kernel {k1:.2f} / {k2:.2f} ({gflop / times['t', dtype][0]:.1f}"
                         f" TFLOP/s), plain {p1:.2f} / {p2:.2f}")
        print(f"[time] fused_paper_mlp_t ({n}, {s}), ms: {'; '.join(parts)} {on}")
        del pts, vd

    with torch.no_grad():
        n, s = TRAIN_SHAPE
        pts, _, dc, params, g = paper_case(n, s, model, dev, seed=3)
        for dtype in ("float32", "bfloat16"):
            _, res = paper_train_fwd(pts, dc, params, dtype, 10)
            _, plain_res = paper_train_plain_fwd(pts, dc, params, dtype, 10)
            fns = {
                "fwd": (lambda: paper_train_fwd(pts, dc, params, dtype, 10),
                        lambda: paper_train_plain_fwd(pts, dc, params, dtype, 10)),
                "bwd": (lambda: paper_train_bwd(g, res, params, n, s, dtype, 10),
                        lambda: paper_train_plain_bwd(g, plain_res, params, n, s, dtype, 10)),
            }
            parts = []
            for which, (kernel, plain) in fns.items():
                p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kernel, kernel, plain))
                times[which, dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
                parts.append(f"{which} kernel {k1:.3f} / {k2:.3f}, plain {p1:.3f} / {p2:.3f}")
            print(f"[time] fused_paper_mlp_train ({n}, {s}) {dtype}, ms: {'; '.join(parts)} {on}")
            del res, plain_res

    mc, mf, _ = load_models_and_params(checkpoint, cfg, DEVICE)
    poses, h, w, focal = resolve_render_poses(cfg)
    pose = torch.as_tensor(poses[1], device=dev)
    base = render_settings_from_config(cfg, "validation", hwf=(h, w, focal))
    renders = {}
    with torch.inference_mode():
        for label, use_kernel, dtype, chunk in (("plain f32", False, "float32", PLAIN_CHUNK),
                                                ("kernel f32", True, "float32", 131072),
                                                ("kernel bf16", True, "bfloat16", 131072)):
            settings = dataclasses.replace(base, use_pallas=use_kernel, compute_dtype=dtype,
                                           chunksize=chunk)
            renders[label] = make_pose_render_fn(mc, mf, settings, h, w, focal)
            renders[label](pose)   # warm-up
        frame = {label: [] for label in renders}
        for label in ("plain f32", "kernel f32", "kernel bf16", "kernel bf16", "kernel f32",
                      "plain f32"):
            frame[label].append(frame_seconds(renders[label], pose))
    for label, secs in frame.items():
        times["frame", label] = sum(secs) / len(secs)
    print(f"[time] {h}x{w} Paper frame, {base.num_coarse}+{base.num_fine} samples, s/frame: "
          + "; ".join(f"{label} {' / '.join(f'{x:.4f}' for x in secs)} "
                      f"({h * w / times['frame', label]:,.0f} rays/s)"
                      for label, secs in frame.items()) + f" {on}")

    data = make_synthetic_dataset(num_views=4, height=100, width=100, device=dev)
    store = [torch.as_tensor(a, device=dev) for a in flatten_rays(data, dev)]
    batch = int(cfg.nerf.train.num_random_rays)
    base = render_settings_from_config(cfg, "train", hwf=data.hwf)
    loops = {}
    for dtype in ("float32", "bfloat16"):
        for label, kernel in (("plain", False), ("kernel", True)):
            mc = seeded_model(SEED, opacify=False, family="PaperNeRFModel").train().to(dev)
            mf = seeded_model(SEED + 1, opacify=False, family="PaperNeRFModel").train().to(dev)
            settings = dataclasses.replace(base, use_pallas_train=kernel, compute_dtype=dtype)
            state = create_train_state(mc, mf, optimizer_from_config(cfg))
            loop = make_train_loop(mc, mf, settings, batch, PAPER_TIMED_STEPS)
            state, _ = loop(state, *store, SEED)      # warm-up
            loops[label, dtype] = (loop, state)
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("float32", "bfloat16"):
        secs = {}
        for label in ("plain", "kernel", "kernel", "plain"):
            loop, state = loops[label, dtype]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = loop(state, *store, SEED)
            metrics.loss.cpu()
            torch.cuda.synchronize()
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        parts = []
        for label, turns in secs.items():
            rates = [batch * PAPER_TIMED_STEPS / t for t in turns]
            times["step", label, dtype] = sum(rates) / len(rates)
            parts.append(f"{label} "
                         f"{' / '.join(f'{1e3 * t / PAPER_TIMED_STEPS:.3f}' for t in turns)} ms "
                         f"({times['step', label, dtype]:,.0f} rays/s)")
        print(f"[time] Paper training step, {batch} rays, {base.num_coarse}+{base.num_fine} "
              f"samples, {dtype}: {'; '.join(parts)} {on}")
    print(f"[time] peak device memory over those Paper training steps: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")
    for label, dtype in (("kernel", "bfloat16"), ("plain", "float32")):
        loop, state = loops[label, dtype]
        profile_steps(lambda: loop(state, *store, SEED)[1].loss.cpu(), PAPER_TIMED_STEPS,
                      f"Paper training step, {label} path {dtype}", on)
    return times


def profile_steps(run, steps: int, what: str, on: str, top_n: int = 4) -> dict:
    """One ``run()`` of ``steps`` steps under ``torch.profiler``: wall time,
    the device's busy share (kernel time over wall; one stream, so kernels do
    not overlap) and the kernels that take the most device time, printed and
    returned per step. The profiler's own cost lengthens the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "self_device_time_total", 0), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Optimizer.")]
    busy = sum(t for _, t, _ in rows) / 1e3          # ms
    launches = sum(c for _, _, c in rows)
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{k.removeprefix('void ').replace('(anonymous namespace)::', '')[:24]} "
                    f"{t / 1e3 / steps:.2f}" for k, t, _ in rows[:top_n])
    print(f"[profile] {what}: {1e3 * wall / steps:.2f} ms/step wall under the profiler, device "
          f"busy {busy / steps:.2f} ms/step ({100 * busy / (1e3 * wall):.1f}%), "
          f"{launches / steps:.0f} launches/step; top ms/step: {top} {on}")
    return {"wall_ms": 1e3 * wall / steps, "busy_ms": busy / steps,
            "busy_share": busy / (1e3 * wall), "launches": launches / steps}


def profile_matmuls(run, what: str, on: str, top_n: int) -> list:
    """One ``run()`` of one step under ``torch.profiler`` with the shapes
    recorded: the ``top_n`` matrix products by device time, each with its
    input shapes, calls and device ms, printed and returned. Recording the
    shapes keeps the ops' inputs alive, so ``run`` is one step: ten steps of
    the 6-scene loop ran the H100 out of memory, and one step leaves ~11 GiB
    held after the profile ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    mms = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.key in ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")),
                 key=lambda e: -e.self_device_time_total)[:top_n]
    rows = []
    for e in mms:
        # (S, M, K) @ (S, K, N) for a bmm; addmm and baddbmm take the bias first
        a, b = e.input_shapes[1:3] if e.key.endswith("addmm") else e.input_shapes[:2]
        flop = 2 * math.prod(a) * b[-1] * e.count
        ms = e.self_device_time_total / 1e3
        rows.append((e.key, e.input_shapes[:3], e.count, ms, flop / ms / 1e9))
    print(f"[profile] {what}, matrix products by device ms: " + "; ".join(
        f"{k} {shapes} x{n} {ms:.2f} ms ({tflops:.2f} TFLOP/s)"
        for k, shapes, n, ms, tflops in rows) + f" {on}")
    return rows


def map_errors(got: dict, want: dict) -> dict:
    """Max |kernel - plain| of each composited map (disparity relative)."""
    errs = {k: float((got[k] - want[k]).abs().max()) for k in ("rgb", "acc", "weights", "depth")}
    errs["disp"] = float(((got["disp"] - want["disp"]).abs()
                          / want["disp"].abs().clamp(min=1e-30)).max())
    return errs


def fmt_errors(errs: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())


def plain_cdf(weights):
    """sample_pdf's zero-prepended CDF of (N, M-1) bin weights: (N, M)."""
    import torch

    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)


def cdf_at(bins, cdf, x):
    """The piecewise-linear CDF (knots ``cdf`` at ``bins``) at depths x: the
    map that sample_pdf's samples invert."""
    import torch

    j = (torch.searchsorted(bins.contiguous(), x.contiguous(), right=True) - 1).clamp(
        0, bins.shape[1] - 2)
    e0, e1 = torch.gather(bins, 1, j), torch.gather(bins, 1, j + 1)
    c0, c1 = torch.gather(cdf, 1, j), torch.gather(cdf, 1, j + 1)
    return c0 + ((x - e0) / (e1 - e0)).clamp(0, 1) * (c1 - c0)


def check_resample(bins, weights, num_samples: int, u) -> dict:
    """Phase 12, #6: the resampling kernel against ``sample_pdf``, det and
    with the uniforms ``u``.

    A cdf that differs by e (the two prefix sums' order) moves a sample by
    e * width / pdf, so in bins of small pdf the two differ by more than
    RESAMPLE_TOL in depth, and by up to the bin where the two put a
    denominator on opposite sides of the 1e-5 guard. Each sample over
    RESAMPLE_TOL must therefore agree in CDF space, to RESAMPLE_CDF_TOL; the
    ones whose plain denominator lies within 1e-6 of the guard are counted
    as guard flips.
    """
    import torch

    from nerf_tpu_torch.kernels.resample import fused_sample_pdf
    from nerf_tpu_torch.ops import sample_pdf

    n, m = bins.shape
    cdf = plain_cdf(weights)
    out = {"err": 0.0, "over": 0, "cdf_err": 0.0}
    parts = []
    for label, kw in (("det", {"det": True}), ("u", {"u": u})):
        got = fused_sample_pdf(bins, weights, num_samples, **kw)
        torch.cuda.synchronize()
        want = sample_pdf(bins, weights, num_samples, **kw)
        check(bool(torch.isfinite(got).all() and (got >= bins[:, :1]).all()
                   and (got <= bins[:, -1:]).all()), f"fused_sample_pdf ({n}, {m}) {label} range")
        uu = u if label == "u" else torch.linspace(0.0, 1.0, num_samples,
                                                   device=u.device).expand(n, num_samples)
        inds = torch.searchsorted(cdf.contiguous(), uu.contiguous(), right=True)
        denom = (torch.gather(cdf, 1, inds.clamp(max=m - 1))
                 - torch.gather(cdf, 1, (inds - 1).clamp(min=0)))
        dx = (got - want).abs()
        du = (cdf_at(bins, cdf, got) - cdf_at(bins, cdf, want)).abs()
        over = dx > RESAMPLE_TOL
        guard = int((over & ((denom - 1e-5).abs() <= 1e-6)).sum())
        du_over = float(du[over].max()) if bool(over.any()) else 0.0
        parts.append(f"{label}: max {float(dx.max()):.2e}, {int(over.sum())} over "
                     f"{RESAMPLE_TOL:g} ({guard} guard flips), in CDF space {du_over:.2e}")
        check(du_over <= RESAMPLE_CDF_TOL, f"fused_sample_pdf ({n}, {m}) {label}: {du_over}")
        out = {"err": max(out["err"], float(dx.max())), "over": out["over"] + int(over.sum()),
               "cdf_err": max(out["cdf_err"], du_over)}
    print(f"[stage-kernel] fused_sample_pdf ({n} rays, M {m} -> {num_samples}), |kernel - plain| "
          f"of {n * num_samples} samples (CDF tol {RESAMPLE_CDF_TOL:g}): {'; '.join(parts)}")
    return out


def check_render_stage_kernels(dev) -> dict:
    """Phase 12: the compositing kernel (#5), the resampling kernel (#6) and
    the whole-stage kernel (#7) against their plain versions at
    STAGE_CHECK_SHAPES, on the flagship's field: #1's output of the opacified
    seeded model at orbit points (and a random field for #5); #6 resamples the
    composited weights of the coarse shape and of the ragged one, det and
    with uniforms that include exactly 1.0, one ray with all-zero weights;
    #7's bf16 maps must equal #5's on #1's bf16 field bitwise. Returns the
    worst error of each kernel and whether every shape was bitwise."""
    import torch

    from nerf_tpu_torch.kernels.composite import fused_volume_render, volume_render_plain
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.kernels.stage import fused_render_stage, render_stage_plain

    model = seeded_model(SEED, opacify=True).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tols = {"float32": MAP_TOLS, "bfloat16": {k: BF16_TOL for k in MAP_TOLS}}
    worst = {"composite": {"float32": 0.0}, "stage": {"float32": 0.0, "bfloat16": 0.0}}
    resample = {"err": 0.0, "over": 0, "cdf_err": 0.0}
    with torch.inference_mode():
        for n, s in STAGE_CHECK_SHAPES:
            pts, vd, z, rd = orbit_rays(n, s, dev, seed=n + s)
            field = fused_mlp_t(model, pts, vd)
            errs = []
            for rf in (field, torch.randn(n, s, 4, generator=gen, device=dev) * 2):
                for white in (False, True):
                    got = fused_volume_render(rf, z, rd, white)
                    torch.cuda.synchronize()
                    errs.append(map_errors(got, volume_render_plain(rf, z, rd, white)))
            e = {k: max(x[k] for x in errs) for k in errs[0]}
            print(f"[stage-kernel] fused_volume_render ({n}, {s}), #1's and a random field: max "
                  f"|kernel - plain| {fmt_errors(e)}")
            check(all(e[k] <= MAP_TOLS[k] for k in e), f"fused_volume_render ({n}, {s}): {e}")
            worst["composite"]["float32"] = max(worst["composite"]["float32"], e["rgb"], e["acc"],
                                                e["weights"], e["depth"])
            parts = []
            for dtype in ("float32", "bfloat16"):
                got = fused_render_stage(model, pts, vd, z, rd, True, dtype)
                torch.cuda.synchronize()
                e = map_errors(got, render_stage_plain(model, pts, vd, z, rd, True, dtype))
                parts.append(f"{dtype} {max(e.values()):.2e} ({max(e, key=e.get)})")
                check(all(e[k] <= tols[dtype][k] for k in e),
                      f"fused_render_stage ({n}, {s}) {dtype}: {e}")
                worst["stage"][dtype] = max(worst["stage"][dtype], e["rgb"], e["acc"],
                                            e["weights"], e["depth"])
            # bf16: #1's tensor-core tile per point and #5's scan per ray.
            want = fused_volume_render(fused_mlp_t(model, pts, vd, "bfloat16"), z, rd, True)
            same = all(torch.equal(got[k], want[k]) for k in want)
            worst["stage bitwise"] = worst.get("stage bitwise", True) and same
            print(f"[stage-kernel] fused_render_stage ({n}, {s}): max |kernel - plain| over the "
                  f"maps (disp relative) {'; '.join(parts)}; bf16 bitwise #5 on #1's field {same}")
            check(same, f"fused_render_stage ({n}, {s}) bf16 differs from #5 on #1's bf16 field")
            if s == 128:
                continue
            # Resample the composited coarse weights' inner bins, as the
            # renderer does: M = S - 1 edges, S new samples.
            weights = volume_render_plain(field, z, rd, True)["weights"][:, 1:-1].clone()
            weights[0] = 0.0
            u = torch.rand(n, s, generator=gen, device=dev)
            u[::101, 0] = 1.0
            r = check_resample(0.5 * (z[:, 1:] + z[:, :-1]), weights, s, u)
            resample = {"err": max(resample["err"], r["err"]), "over": resample["over"] + r["over"],
                        "cdf_err": max(resample["cdf_err"], r["cdf_err"])}
    return {"composite": worst["composite"], "stage": worst["stage"], "resample": resample,
            "stage bitwise": worst["stage bitwise"]}


def stage_a(model, pts, vd, z, rd, s):
    """Chain A's stage: the field through #1, composited by #5."""
    from nerf_tpu_torch.kernels.composite import fused_volume_render
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t

    return fused_volume_render(fused_mlp_t(model, pts, vd, s.compute_dtype), z, rd,
                               s.white_background)


def stage_b(model, pts, vd, z, rd, s):
    """Chain B's stage: the whole stage in one launch of #7."""
    from nerf_tpu_torch.kernels.stage import fused_render_stage

    return fused_render_stage(model, pts, vd, z, rd, s.white_background, s.compute_dtype)


def stage_c(model, pts, vd, z, rd, s):
    """Chain C's stage: the field through #3 on (R, S, 3), plain compositing."""
    from nerf_tpu_torch.kernels.composite import volume_render_plain
    from nerf_tpu_torch.kernels.mlp import fused_flexible_mlp_rays

    return volume_render_plain(fused_flexible_mlp_rays(model, pts, vd, s.compute_dtype), z, rd,
                               s.white_background)


def stage_d(model, pts, vd, z, rd, s):
    """Chain D's stage: the field through #2 on the flattened (R*S, 3) points,
    each with its ray's view direction; plain compositing."""
    from nerf_tpu_torch.kernels.composite import volume_render_plain
    from nerf_tpu_torch.kernels.mlp import fused_flexible_mlp

    r, k = pts.shape[:2]
    field = fused_flexible_mlp(model, pts.reshape(-1, 3),
                               vd[:, None, :].expand(r, k, 3).reshape(-1, 3), s.compute_dtype)
    return volume_render_plain(field.reshape(r, k, 4), z, rd, s.white_background)


# The kernel chains of phases 13 and 14: the stage, whether resampling is #6
# (else the renderer's sample_pdf), and each kernel's launches a chunk.
CHAINS = {
    "A": (stage_a, True, {"fused_mlp_t": 2, "fused_volume_render": 2, "fused_sample_pdf": 1}),
    "B": (stage_b, True, {"fused_render_stage": 2, "fused_sample_pdf": 1}),
    "C": (stage_c, False, {"fused_flexible_mlp_rays": 2}),
    "D": (stage_d, False, {"fused_flexible_mlp": 2}),
}


def chain_parts(name: str):
    """Chain ``name``'s stage function and resampler."""
    from nerf_tpu_torch.kernels.resample import fused_sample_pdf
    from nerf_tpu_torch.ops import sample_pdf

    stage, kernel_resample, _ = CHAINS[name]
    return stage, fused_sample_pdf if kernel_resample else sample_pdf


def render_chain(stage, resample, mc, mf, ro, rd, s):
    """The deterministic render path of ``render_rays`` over a chunk of rays,
    with its stages taken by ``stage`` and its resampling by ``resample``
    (#6 or the renderer's ``sample_pdf``): coarse stage -> resample (det) on
    the coarse weights' inner bins -> sort -> fine stage. Returns both
    stages' maps."""
    import torch

    from nerf_tpu_torch.ops import coarse_z_values

    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    near = torch.full(ro.shape[:1], s.near, dtype=ro.dtype, device=ro.device)
    z = coarse_z_values(near, s.far, s.num_coarse, s.lindisp, dtype=ro.dtype)
    coarse = stage(mc, ro[:, None, :] + rd[:, None, :] * z[..., None], vd, z, rd, s)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_fine = resample(z_mid, coarse["weights"][:, 1:-1], s.num_fine, det=True)
    z_all, _ = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)
    fine = stage(mf, ro[:, None, :] + rd[:, None, :] * z_all[..., None], vd, z_all, rd, s)
    return coarse, fine


def chain_render_fn(name: str, mc, mf, s, h: int, w: int, focal: float):
    """``render(pose34) -> {"rgb_coarse", "rgb_fine"}`` (H, W, 3) through
    ``render_chain`` with chain ``name``'s stage and resampler (``CHAINS``),
    s.chunksize rays at a time, as make_pose_render_fn renders a frame."""
    import torch

    from nerf_tpu_torch.ops import get_ray_bundle

    stage, resample = chain_parts(name)

    def render(pose34):
        ro, rd = get_ray_bundle(h, w, focal, pose34)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        parts = []
        with torch.inference_mode():
            for i in range(0, ro.shape[0], s.chunksize):
                coarse, fine = render_chain(stage, resample, mc, mf, ro[i:i + s.chunksize],
                                            rd[i:i + s.chunksize], s)
                parts.append((coarse["rgb"], fine["rgb"]))
            return {name: torch.cat([p[k] for p in parts]).reshape(h, w, 3)
                    for k, name in enumerate(("rgb_coarse", "rgb_fine"))}

    return render


def check_chain_outliers(stage, name: str, pixels, mc, mf, s, pose, hwf) -> None:
    """At the pixels where a chain's fine rgb differs from the renderer's
    kernel path, run the chain's fine stage again on the renderer's own fine
    depths: there the two must agree to RENDER_RGB_TOL, so that what moved is
    the resampled depths alone (#6's cdf against torch.cumsum's, in bins of
    small pdf; see check_resample)."""
    import torch

    from nerf_tpu_torch.engine.renderer import render_rays
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.ops import (
        coarse_z_values, get_ray_bundle, sample_pdf, volume_render_radiance_field,
    )

    h, w, focal = hwf
    ro, rd = get_ray_bundle(h, w, focal, pose)
    ro, rd = ro.reshape(-1, 3)[pixels], rd.reshape(-1, 3)[pixels]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    with torch.inference_mode():
        coarse = render_rays(mc, None, ro, rd, dataclasses.replace(s, num_fine=0)).coarse
        z = coarse_z_values(torch.full(ro.shape[:1], s.near, device=ro.device), s.far,
                            s.num_coarse, s.lindisp)
        z_fine = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), coarse.weights[:, 1:-1], s.num_fine,
                            det=True)
        z_all, _ = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)
        pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
        want = volume_render_radiance_field(fused_mlp_t(mf, pts, vd, s.compute_dtype), z_all, rd,
                                            white_background=s.white_background).rgb
        err = float((stage(mf, pts, vd, z_all, rd, s)["rgb"] - want).abs().max())
    print(f"[chain]   {name} at those pixels, on the renderer's fine depths: rgb_fine max "
          f"|diff| {err:.3e}")
    check(err <= RENDER_RGB_TOL, f"chain {name} outliers differ on common depths: {err}")


def render_chains(cfg, dev, names) -> dict:
    """Phases 13 and 14: the chains ``names`` of ``CHAINS`` render frame 0 of
    ``cfg``'s orbit, each held against the renderer's kernel path
    (``make_pose_render_fn``, ``use_pallas``) with its launches counted.
    Returns the launches."""
    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn

    mc = seeded_model(SEED, opacify=True).to(dev)
    mf = seeded_model(SEED + 1, opacify=True).to(dev)
    poses, h, w, focal = resolve_render_poses(cfg)
    pose = torch.as_tensor(poses[0], device=dev)
    s = dataclasses.replace(render_settings_from_config(cfg, "validation", hwf=(h, w, focal)),
                            use_pallas=True)
    ref = make_pose_render_fn(mc, mf, s, h, w, focal)(pose)
    chunks = math.ceil(h * w / s.chunksize)
    launches = {}
    for name in names:
        expected = {k: n * chunks for k, n in CHAINS[name][2].items()}
        reset_launches()
        maps = chain_render_fn(name, mc, mf, s, h, w, focal)(pose)
        counts = {k: v for k, v in read_launches().items() if v}
        launches[name] = counts
        coarse = float((maps["rgb_coarse"] - ref["rgb_coarse"]).abs().max())
        fine = (maps["rgb_fine"] - ref["rgb_fine"]).abs().amax(dim=-1)
        outliers = int((fine > RENDER_RGB_TOL).sum())
        print(f"[chain] {name} {h}x{w} at chunk {s.chunksize}: launches {counts}; vs the "
              f"renderer's kernel path, max |diff| rgb_coarse {coarse:.3e}, rgb_fine "
              f"{float(fine.max()):.3e} ({outliers} of {fine.numel()} pixels over "
              f"{RENDER_RGB_TOL:g})")
        check(counts == expected, f"chain {name} launches {counts} != {expected}")
        check(all(bool(torch.isfinite(v).all()) for v in maps.values()), f"chain {name} finite")
        check(coarse <= RENDER_RGB_TOL, f"chain {name} rgb_coarse: {coarse}")
        check(outliers <= MAX_RESAMPLE_PIXELS, f"chain {name}: {outliers} rgb_fine outliers")
        if outliers:
            check_chain_outliers(chain_parts(name)[0], name,
                                 torch.nonzero(fine.reshape(-1) > RENDER_RGB_TOL).flatten(),
                                 mc, mf, s, pose, (h, w, focal))
    return launches


def chain_frame_seconds(cfg, dev, names, on: str, dtype: str = "float32") -> dict:
    """Seconds per 400x400 frame of the renderer's kernel path and of the
    chains ``names`` at compute dtype ``dtype``, in turns (the renderer first
    and last). In bfloat16 each frame is also rendered once with its launches
    counted (each chain's expected ones) and must clear PSNR_FLOOR_DB
    against the renderer's float32 frame."""
    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn

    mc = seeded_model(SEED, opacify=True).to(dev)
    mf = seeded_model(SEED + 1, opacify=True).to(dev)
    poses, h, w, focal = resolve_render_poses(cfg)
    pose = torch.as_tensor(poses[1], device=dev)
    base = dataclasses.replace(render_settings_from_config(cfg, "validation", hwf=(h, w, focal)),
                               use_pallas=True, compute_dtype=dtype)
    renders = {"renderer kernel path": make_pose_render_fn(mc, mf, base, h, w, focal)}
    renders.update({f"chain {name}": chain_render_fn(name, mc, mf, base, h, w, focal)
                    for name in names})
    labels = list(renders)
    with torch.inference_mode():
        for render in renders.values():
            render(pose)   # warm-up
        frame = {label: [] for label in renders}
        for label in labels + labels[::-1]:
            frame[label].append(frame_seconds(renders[label], pose))
    times = {}
    for label, secs in frame.items():
        times["frame", label] = sum(secs) / len(secs)
    short = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    print(f"[time] {h}x{w} frame, {base.num_coarse}+{base.num_fine} samples, {short}, s/frame: "
          + "; ".join(f"{label} {' / '.join(f'{x:.4f}' for x in secs)}"
                      for label, secs in frame.items()) + f" {on}")
    if dtype == "bfloat16":
        with torch.inference_mode():
            ref = make_pose_render_fn(mc, mf, dataclasses.replace(base, compute_dtype="float32"),
                                      h, w, focal)(pose)["rgb_fine"]
            chunks = math.ceil(h * w / base.chunksize)
            parts = []
            for label, render in renders.items():
                reset_launches()
                db = times["psnr", label] = psnr(render(pose)["rgb_fine"], ref)
                counts = {k: v for k, v in read_launches().items() if v}
                parts.append(f"{label} {db:.2f} dB, launches {counts}")
                check(db >= PSNR_FLOOR_DB, f"{label} bf16 frame: PSNR {db} < {PSNR_FLOOR_DB}")
                if label != "renderer kernel path":
                    want = {k: n * chunks for k, n in CHAINS[label.split()[-1]][2].items()}
                    check(counts == want, f"{label} bf16 launches {counts} != {want}")
        print(f"[chain] bf16 frames vs the renderer's f32 frame (floor {PSNR_FLOOR_DB}): "
              + "; ".join(parts))
    return times


def time_render_stage(cfg, dev, on: str) -> dict:
    """Phase 13, times: #5 and #6 against their plain versions at the render
    path's shapes; #7 against its plain version and against #1 + plain
    compositing (the renderer's kernel path) at KERNEL_CHUNK, float32 and
    bfloat16; seconds per 400x400 frame on the renderer's kernel path and
    through chains A and B. Turns alternate (plain first and last)."""
    import torch

    from nerf_tpu_torch.kernels.composite import fused_volume_render, volume_render_plain
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.kernels.resample import fused_sample_pdf
    from nerf_tpu_torch.kernels.stage import fused_render_stage, render_stage_plain
    from nerf_tpu_torch.ops import sample_pdf

    times = {}
    model = seeded_model(SEED, opacify=True).to(dev)
    with torch.inference_mode():
        n, s = KERNEL_CHUNK
        pts, vd, z, rd = orbit_rays(n, s, dev, seed=1)
        rf = fused_mlp_t(model, pts, vd)
        kernel = lambda: fused_volume_render(rf, z, rd, True)   # noqa: E731
        plain = lambda: volume_render_plain(rf, z, rd, True)    # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, r) for f, r in ((plain, 10), (kernel, 50), (kernel, 50),
                                                      (plain, 10)))
        times["composite"] = {"float32": ((k1 + k2) / 2, (p1 + p2) / 2)}
        print(f"[time] fused_volume_render ({n}, {s}): kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms {on}")

        pts_c, vd_c, zc, rd_c = orbit_rays(n, 64, dev, seed=2)
        bins = 0.5 * (zc[:, 1:] + zc[:, :-1])
        weights = volume_render_plain(fused_mlp_t(model, pts_c, vd_c), zc, rd_c,
                                      True)["weights"][:, 1:-1].contiguous()
        kernel = lambda: fused_sample_pdf(bins, weights, 64, det=True)   # noqa: E731
        plain = lambda: sample_pdf(bins, weights, 64, det=True)          # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, r) for f, r in ((plain, 10), (kernel, 50), (kernel, 50),
                                                      (plain, 10)))
        # Near its bound the kernel takes less time than the host takes to
        # enqueue a wrapper call, so its own time comes from the profiler.
        d1, d2 = (kernel_device_ms(kernel, 50, "resample_kernel").get("resample_kernel", 0.0)
                  for _ in range(2))
        check(d1 > 0 and d2 > 0, "the profiler saw no resample_kernel")
        times["resample"] = {"float32": ((d1 + d2) / 2, (p1 + p2) / 2)}
        times["resample events"] = (k1 + k2) / 2
        print(f"[time] fused_sample_pdf ({n} rays, M 63 -> 64, det): kernel device {d1:.4f} / "
              f"{d2:.4f} ms (profiler), wrapper {k1:.4f} / {k2:.4f} ms (events); plain "
              f"{p1:.4f} / {p2:.4f} ms (events) {on}")

        times["stage"] = {}
        for dtype in ("float32", "bfloat16"):
            fns = {
                "plain": lambda: render_stage_plain(model, pts, vd, z, rd, True, dtype),
                "#1 + plain compositing": lambda: volume_render_plain(
                    fused_mlp_t(model, pts, vd, dtype), z, rd, True),
                "#1 + #5": lambda: fused_volume_render(fused_mlp_t(model, pts, vd, dtype), z, rd,
                                                       True),
                "kernel": lambda: fused_render_stage(model, pts, vd, z, rd, True, dtype),
            }
            turns = {}
            for label in ("plain", "#1 + plain compositing", "#1 + #5", "kernel", "kernel",
                          "#1 + #5", "#1 + plain compositing", "plain"):
                turns.setdefault(label, []).append(cuda_ms(fns[label], 2))
            mean = {k: sum(v) / len(v) for k, v in turns.items()}
            times["stage"][dtype] = (mean["kernel"], mean["plain"])
            times["stage unfused", dtype] = mean["#1 + plain compositing"]
            print(f"[time] fused_render_stage ({n}, {s}) {dtype}: "
                  + "; ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)} ms"
                              for k, v in turns.items()) + f" {on}")
        del pts, vd, z, rd, rf, pts_c, vd_c, zc, rd_c, bins, weights

    times.update(chain_frame_seconds(cfg, dev, ("A", "B"), on))
    return times


def check_flexible_kernels(model, dev) -> dict:
    """Phase 14: the ray-major (#3) and point-major (#2) forwards against
    their plain versions at CHECK_SHAPES, float32 and bfloat16 (#2 on the
    flattened points, each with its ray's direction), and #3 against #1 on
    the same inputs. Returns the worst errors."""
    import torch

    from nerf_tpu_torch.kernels.mlp import (
        flexible_mlp_plain, flexible_mlp_rays_plain, fused_flexible_mlp, fused_flexible_mlp_rays,
    )
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t

    tols = {"float32": F32_TOL, "bfloat16": TC_BF16_FWD_TOL}   # bf16 on the tensor cores
    worst = {(k, d): 0.0 for k in ("rays", "points", "rays vs #1") for d in tols}
    bitwise = {d: True for d in tols}    # #3 vs #1: the same tile body on the same dc rows
    with torch.inference_mode():
        for n, s in CHECK_SHAPES:
            pts, vd = orbit_points(n, s, dev, seed=n + s)
            flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
            errs = {}
            for dtype, tol in tols.items():
                rays = fused_flexible_mlp_rays(model, pts, vd, dtype)
                points = fused_flexible_mlp(model, flat_pts, flat_vd, dtype)
                one = fused_mlp_t(model, pts, vd, dtype)
                torch.cuda.synchronize()
                check(rays.shape == (n, s, 4) and points.shape == (n * s, 4)
                      and bool(torch.isfinite(rays).all() and torch.isfinite(points).all()),
                      f"#2/#3 output at ({n}, {s}) {dtype}")
                errs["rays", dtype] = float(
                    (rays - flexible_mlp_rays_plain(model, pts, vd, dtype)).abs().max())
                errs["points", dtype] = float(
                    (points - flexible_mlp_plain(model, flat_pts, flat_vd, dtype)).abs().max())
                errs["rays vs #1", dtype] = float((rays - one).abs().max())
                bitwise[dtype] = bitwise[dtype] and torch.equal(rays, one)
                for k in ("rays", "points"):
                    check(errs[k, dtype] <= tol,
                          f"fused_flexible_mlp{'_rays' * (k == 'rays')} ({n}, {s}) {dtype}: "
                          f"{errs[k, dtype]} > {tol}")
            for key, err in errs.items():
                worst[key] = max(worst[key], err)
            print(f"[flex-kernel] ({n}, {s}): max |kernel - plain| f32 / bf16: #3 "
                  f"{errs['rays', 'float32']:.2e} / {errs['rays', 'bfloat16']:.2e}, #2 "
                  f"{errs['points', 'float32']:.2e} / {errs['points', 'bfloat16']:.2e}; "
                  f"|#3 - #1| {errs['rays vs #1', 'float32']:.2e} / "
                  f"{errs['rays vs #1', 'bfloat16']:.2e}")
    print(f"[flex-kernel] tol #2 and #3 {F32_TOL:g} / {TC_BF16_FWD_TOL:g}; #3 bitwise equal to "
          f"#1 at every shape, f32 / bf16: {bitwise['float32']} / {bitwise['bfloat16']}")
    check(all(bitwise.values()), f"#3 and #1 differ: bitwise {bitwise}")
    worst["bitwise"] = all(bitwise.values())
    return worst


def time_flexible(model, dev, on: str) -> dict:
    """Phase 15: #3 and #2 against their plain versions at KERNEL_CHUNK, with
    #1 in the same turns (plain first and last), float32 and bfloat16."""
    import torch

    from nerf_tpu_torch.kernels.mlp import (
        flexible_mlp_plain, flexible_mlp_rays_plain, fused_flexible_mlp, fused_flexible_mlp_rays,
    )
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t

    times = {}
    with torch.inference_mode():
        n, s = KERNEL_CHUNK
        pts, vd = orbit_points(n, s, dev, seed=1)
        flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
        for dtype in ("float32", "bfloat16"):
            fns = {
                "plain #3": (lambda: flexible_mlp_rays_plain(model, pts, vd, dtype), 1),
                "plain #2": (lambda: flexible_mlp_plain(model, flat_pts, flat_vd, dtype), 1),
                "#3": (lambda: fused_flexible_mlp_rays(model, pts, vd, dtype), 2),
                "#2": (lambda: fused_flexible_mlp(model, flat_pts, flat_vd, dtype), 2),
                "#1": (lambda: fused_mlp_t(model, pts, vd, dtype), 2),
            }
            order = list(fns)
            turns = {}
            for label in order + order[::-1]:
                fn, reps = fns[label]
                turns.setdefault(label, []).append(cuda_ms(fn, reps))
            mean = {k: sum(v) / len(v) for k, v in turns.items()}
            times["rays", dtype] = (mean["#3"], mean["plain #3"])
            times["points", dtype] = (mean["#2"], mean["plain #2"])
            times["#1", dtype] = mean["#1"]
            print(f"[time] ({n}, {s}) {dtype}, ms: "
                  + "; ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)}"
                              for k, v in turns.items()) + f" {on}")
        del pts, vd, flat_pts, flat_vd
    return times


def http(base: str, path: str, data: bytes = None):
    """One request to the server at ``base`` (POST when ``data`` is given):
    (status, content type, body), for an HTTP error too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def decode_png(data: bytes):
    """The (H, W, 3) uint8 image of an 8-bit RGB PNG whose rows are
    unfiltered (what ``nerf_tpu_torch.utils.png`` writes), with zlib."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "a response is not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        pos += 12 + size
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, color = header[:4]
    check(depth == 8 and color == 2, f"PNG depth {depth} color type {color}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows are filtered")
    return rows[:, 1:].reshape(h, w, 3)


@contextlib.contextmanager
def serving(service):
    """Serve ``service`` with the port's HTTP server on 127.0.0.1 at a free
    port from a thread, its request log kept out of the output; yields the
    base URL, and stops the server and its thread on leaving."""
    import threading

    from nerf_tpu_torch.serve_nerf import serve

    with quiet():
        httpd = serve(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}"
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    check(not thread.is_alive(), "the server thread did not stop")


def u8_frame_fn(mc, mf, cfg, hwf):
    """``pose (3|4, 4) -> (H, W, 3) uint8`` through the renderer's kernel path
    in bfloat16 (``make_pose_render_fn(..., output="u8")``), as the server
    renders."""
    import numpy as np
    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn

    settings = dataclasses.replace(render_settings_from_config(cfg, "validation", hwf=hwf),
                                   compute_dtype="bfloat16", use_pallas=True)
    render = make_pose_render_fn(mc, mf, settings, *hwf, output="u8")

    def frame(pose):
        pose = torch.as_tensor(np.asarray(pose, np.float32)[:3, :4], device=DEVICE)
        with torch.inference_mode():
            return render(pose).cpu().numpy()

    return frame


def serve_main_path(cfg, state: dict, dev, on: str) -> dict:
    """Phase 16: the render server on the card. ``state`` (phase 7's trained
    checkpoint as params) is written as a native .ntc and served at bf16
    through ``serve_nerf.RenderService`` over HTTP: /health, /, two GET
    renders and a POST /pose, each PNG bitwise equal to the renderer's u8
    frame of the same pose (4 launches of #1 a frame), a 400 and a 404; the
    median latency of SERVE_RENDERS renders. Then a --logdir service: a
    newer .ntc of other weights lands, and the next request serves them."""
    import numpy as np

    from nerf_tpu_torch.data import pose_spherical
    from nerf_tpu_torch.engine.checkpoint import (
        convert_torch_state_dict, load_models_and_params, save_checkpoint,
    )
    from nerf_tpu_torch.serve_nerf import RenderService

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "run")
        os.makedirs(logdir)
        path = os.path.join(logdir, f"checkpoint{state['step']:05d}.ntc")
        save_checkpoint(path, state)
        service = RenderService(cfg, path, precision="bfloat16", renderer="kernel", device=DEVICE)
        hwf = (service.height, service.width, service.focal)
        chunks = math.ceil(hwf[0] * hwf[1] / service.settings.chunksize)
        pose1 = np.asarray(service.poses[1], np.float32)
        requests = {"/render?frame=0": (None, service.poses[0]),
                    "/render?theta=30&phi=-30&radius=4": (None, pose_spherical(30.0, -30.0, 4.0)),
                    "/pose": (json.dumps({"pose": pose1.tolist()}).encode(), pose1)}
        with serving(service) as base:
            status, ctype, body = http(base, "/health")
            check(status == 200 and json.loads(body)["status"] == "ok", f"/health: {status}")
            status, ctype, body = http(base, "/")
            check(status == 200 and ctype == "text/html" and b"/render?" in body, f"/: {status}")
            reset_launches()
            got = {}
            for route, (data, _) in requests.items():
                status, ctype, body = http(base, route, data)
                check(status == 200 and ctype == "image/png", f"{route}: {status} {body[:200]}")
                got[route] = decode_png(body)
            launches = read_launches()["fused_mlp_t"]
            bad = http(base, "/render?frame=x")[0], http(base, "/pose", b"[1, 2]")[0]
            missing = http(base, "/nope")[0], http(base, "/nope", b"{}")[0]
            times = []
            for i in range(SERVE_RENDERS):
                t0 = time.perf_counter()
                status, _, body = http(base, f"/render?frame={i}")
                times.append(time.perf_counter() - t0)
                check(status == 200, f"/render?frame={i}: {status}")
            health = json.loads(http(base, "/health")[2])
        mc, mf, _ = load_models_and_params(path, cfg, DEVICE)
        reference = u8_frame_fn(mc, mf, cfg, hwf)
        same = {route: bool(np.array_equal(img, reference(pose)))
                for (route, img), (_, pose) in zip(got.items(), requests.values())}
        expected = 2 * chunks * len(requests)
        print(f"[serve] {hwf[0]}x{hwf[1]} bf16 from a .ntc of phase 7's checkpoint (step "
              f"{health['checkpoint_step']}): /health, /; {sum(same.values())} of "
              f"{len(requests)} renders (GET frame, GET orbit, POST /pose) bitwise equal to "
              f"the renderer's u8 frames; fused_mlp_t launches {launches} (expected "
              f"{expected}); bad requests {bad}, unknown routes {missing}")
        check(all(same.values()), f"served frames differ from the renderer's: {same}")
        check(launches == expected, f"server launches {launches} != {expected}")
        check(bad == (400, 400) and missing == (404, 404), f"status codes {bad} {missing}")
        check(health["checkpoint_step"] == state["step"] and health["devices"] == 1,
              f"/health {health}")
        out["latency_s"] = sorted(times)[len(times) // 2]
        out["last_render_s"] = health["last_render_s"]
        print(f"[time] server, {hwf[0]}x{hwf[1]} bf16 frame over HTTP: request latency "
              f"{' / '.join(f'{t:.4f}' for t in times)} s, median {out['latency_s']:.4f} s; "
              f"last_render_s {health['last_render_s']} s; warm-up {health['compile_s']} s {on}")

        # A --logdir service: the newest .ntc is served, and a newer one of
        # other weights (the seeded opacified models) is picked up.
        watch = RenderService(cfg, precision="bfloat16", renderer="kernel", watch_logdir=logdir,
                              device=DEVICE)
        with serving(watch) as base:
            before = json.loads(http(base, "/health")[2])["checkpoint_step"]
            models = [seeded_model(SEED + i, opacify=True) for i in (0, 1)]
            step = state["step"] + 1000
            save_checkpoint(os.path.join(logdir, f"checkpoint{step:05d}.ntc"), {
                "step": step, "params_coarse": convert_torch_state_dict(models[0].state_dict()),
                "params_fine": convert_torch_state_dict(models[1].state_dict())})
            status, _, body = http(base, "/render?frame=0")
            check(status == 200, f"watch /render?frame=0: {status}")
            after = json.loads(http(base, "/health")[2])["checkpoint_step"]
        swapped = decode_png(body)
        want = u8_frame_fn(*(m.to(dev) for m in models), cfg, hwf)(service.poses[0])
        same = bool(np.array_equal(swapped, want))
        print(f"[serve] --logdir service: checkpoint_step {before} -> {after} after a newer "
              f".ntc landed; its frame 0 bitwise equal to the new weights' frame: {same} "
              f"(differs from the old one: {not np.array_equal(swapped, got['/render?frame=0'])})")
        check(before == state["step"] and after == step, f"watch steps {before} -> {after}")
        check(same and not np.array_equal(swapped, got["/render?frame=0"]), "the hot swap")
    return out


def fern_config():
    """``configs/fern.yml``'s values merged over the defaults, in code: the
    LLFF protocol (4x64 FlexibleNeRF, 6/4 encoding, NDC, 4096 rays, 64 + 128
    samples, sigma noise 1, lr 5e-3)."""
    from nerf_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.set_new_allowed(True)
    model = {"type": "FlexibleNeRFModel", "num_layers": 4, "hidden_size": 64,
             "skip_connect_every": 3, "num_encoding_fn_xyz": 6, "num_encoding_fn_dir": 4,
             "use_viewdirs": True}
    pairs = ["dataset.type", "llff", "dataset.basedir", "cache/nerf_llff_data/fern",
             "dataset.no_ndc", False, "dataset.near", 0, "dataset.far", 1,
             "dataset.downsample_factor", 8, "dataset.llffhold", 8]
    for which in ("coarse", "fine"):
        for key, value in model.items():
            pairs += [f"models.{which}.{key}", value]
    validation = {"chunksize": 16384, "perturb": False, "num_coarse": 64, "num_fine": 128,
                  "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False}
    for key, value in validation.items():
        pairs += [f"nerf.validation.{key}", value]
    train = dict(validation, num_random_rays=4096, perturb=True, radiance_field_noise_std=1.0)
    for key, value in train.items():
        pairs += [f"nerf.train.{key}", value]
    pairs += [
        "experiment.id", "fern", "experiment.logdir", "logs", "experiment.randomseed", 34,
        "experiment.train_iters", 250000, "experiment.validate_every", 1000,
        "experiment.save_every", 5000, "experiment.print_every", 100,
        "optimizer.type", "Adam", "optimizer.lr", 5.0e-3,
        "scheduler.lr_decay", 250, "scheduler.lr_decay_factor", 0.1,
    ]
    cfg.merge_from_list(pairs)
    return cfg


def write_py_config(cfg, path: str) -> str:
    """``cfg`` as a Python config file (the card has no YAML reader)."""
    with open(path, "w") as f:
        f.write(f"cfg = {cfg.to_dict()!r}\n")
    return path


def analytic_rgba(h: int, w: int, focal: float, pose, dev):
    """The analytic scene at one pose as a u8 (H, W, 4) RGBA image: colour
    un-premultiplied by the opacity, which is the alpha, so that compositing
    onto white gives the white-background render."""
    import numpy as np
    import torch

    from nerf_tpu_torch.data import analytic_radiance_field
    from nerf_tpu_torch.ops import get_ray_bundle
    from nerf_tpu_torch.ops.sampling import coarse_z_values
    from nerf_tpu_torch.ops.volume import volume_render_radiance_field

    with torch.no_grad():
        c2w = torch.as_tensor(np.asarray(pose, np.float32)[:3, :4], device=dev)
        ro, rd = get_ray_bundle(h, w, focal, c2w)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        rgb, acc = [], []
        for i in range(0, ro.shape[0], 1 << 17):
            o, d = ro[i:i + (1 << 17)], rd[i:i + (1 << 17)]
            z = coarse_z_values(torch.full(o.shape[:1], 2.0, device=dev),
                                torch.full(o.shape[:1], 6.0, device=dev), 128)
            out = volume_render_radiance_field(
                analytic_radiance_field(o[:, None] + d[:, None] * z[..., None]), z, d,
                white_background=False)
            rgb.append(out.rgb)
            acc.append(out.acc)
        rgb, acc = torch.cat(rgb), torch.cat(acc)[:, None]
        color = torch.where(acc > 0, rgb / acc.clamp(min=1e-12), torch.zeros_like(rgb))
        rgba = torch.cat([color.clamp(0, 1), acc.clamp(0, 1)], dim=1)
        return (rgba * 255 + 0.5).to(torch.uint8).reshape(h, w, 4).cpu().numpy()


def write_blender_scene(root: str, dev) -> float:
    """The analytic scene as a blender dataset: ``transforms_{split}.json``
    at lego's camera angle and DISK_SIZE RGBA PNGs whose rows cycle through
    DISK_FILTERS. Returns the seconds it took."""
    import numpy as np

    from nerf_tpu_torch.data import pose_spherical
    from nerf_tpu_torch.utils.png import png_bytes

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    angle = 0.6911112070083618
    focal = 0.5 * DISK_SIZE / math.tan(0.5 * angle)
    for s, (split, n) in enumerate(DISK_VIEWS):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            pose = pose_spherical(-180.0 + 360.0 * (i + s / 3) / n, rng.uniform(-45.0, -15.0), 4.0)
            with open(os.path.join(root, split, f"r_{i}.png"), "wb") as f:
                f.write(png_bytes(analytic_rgba(DISK_SIZE, DISK_SIZE, focal, pose, dev),
                                  filters=DISK_FILTERS))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)
    return time.perf_counter() - t0


def write_llff_scene(root: str, dev) -> None:
    """A forward-facing LLFF scene of the analytic sphere: LLFF_VIEWS RGB
    PNGs under ``images/`` at 8 times LLFF_SIZE (no ``images_8/``, so the
    loader minifies) and ``poses_bounds.npy`` in LLFF's raw [down, right,
    back] layout."""
    import numpy as np

    from nerf_tpu_torch.data import pose_spherical, render_analytic_image
    from nerf_tpu_torch.utils.png import write_png

    h, w = 8 * LLFF_SIZE[0], 8 * LLFF_SIZE[1]
    focal = 0.8 * w
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for i in range(LLFF_VIEWS):
        c2w = pose_spherical(rng.uniform(-8.0, 8.0), rng.uniform(-8.0, 8.0), 4.0)[:3, :4]
        img = render_analytic_image(h, w, focal, c2w, device=dev)
        write_png(os.path.join(root, "images", f"IMG_{i:04d}.png"),
                  (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
        raw = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4],
                              np.array([[h], [w], [focal]])], 1)
        rows.append(np.concatenate([raw.reshape(-1), [2.0, 6.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows).astype(np.float64))


def disk_main_path(dev, on: str, synthetic_rays_per_sec: float, tmp: str = "") -> dict:
    """Phase 17: the flagship protocol from a dataset on disk, through the
    entry points a user calls: ``train_nerf.main`` on a blender dataset
    (native store, #8 on every step, the loss falling), a resume from its
    step-DISK_RESUME_AT ``.ntc`` that must retrace its last steps,
    ``cache_dataset`` to a ``.nrc`` that must hold the same store and give
    the same losses, ``eval_nerf --split test --gif`` through #1, and a short
    LLFF run on the fern protocol. Returns the launches and numbers, and the
    dataset, config and final checkpoint it wrote under ``tmp`` (a temporary
    directory of its own when empty, removed on return)."""
    import numpy as np
    import torch

    from nerf_tpu_torch import cache_dataset, eval_nerf, native, train_nerf
    from nerf_tpu_torch.utils.gif import gif_frame_count

    if not tmp:
        with tempfile.TemporaryDirectory() as tmp:
            return disk_main_path(dev, on, synthetic_rays_per_sec, tmp)
    out = {}
    scene = os.path.join(tmp, "lego")
    write_s = write_blender_scene(scene, dev)
    n_images = sum(n for _, n in DISK_VIEWS)
    cfg = lego_fused_config()
    cfg.merge_from_list(["dataset.basedir", scene, "experiment.logdir", tmp,
                         "experiment.train_iters", DISK_STEPS,
                         "experiment.save_every", DISK_RESUME_AT // 2])
    cfg_py = write_py_config(cfg, os.path.join(tmp, "lego_disk.py"))
    print(f"[disk] wrote {n_images} {DISK_SIZE}x{DISK_SIZE} RGBA PNGs (row filters "
          f"{DISK_FILTERS} cycled) in {write_s:.1f} s")

    captured = {}
    load_dataset = train_nerf.load_dataset

    def capture(*args, **kwargs):
        captured["data"] = load_dataset(*args, **kwargs)
        return captured["data"]

    train_nerf.load_dataset = capture
    reset_launches()
    try:
        with quiet():
            run = train_nerf.main(["--config", cfg_py, "--device", DEVICE, "--overrides",
                                   "experiment.id", "whole"])
    finally:
        train_nerf.load_dataset = load_dataset
    counts = read_launches()
    launches = {"fwd": counts["fused_flex_mlp_train_fwd"],
                "bwd": counts["fused_flex_mlp_train_bwd"]}
    h = DISK_SIZE // 2
    want_rays = DISK_VIEWS[0][1] * h * h
    steps = len(run.losses)
    print(f"[disk] train_nerf on the blender dataset: {run.store_rays:,} rays from the "
          f"{run.store_builder} builder, {steps} steps, {launches['fwd']} forward and "
          f"{launches['bwd']} backward launches of #8 (expected {2 * steps} each)")
    check(run.store_builder == "native", f"store built by {run.store_builder}")
    check(run.store_rays == want_rays, f"store of {run.store_rays} rays != {want_rays}")
    check(steps == DISK_STEPS and launches["fwd"] == 2 * steps
          and launches["bwd"] == 2 * steps, f"{steps} steps, launches {launches}")
    losses = torch.tensor(run.losses)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(bool(torch.isfinite(losses).all()) and last < first,
          f"blender loss did not fall: {first} -> {last}")
    print(f"[disk] mean loss of the first 20 steps {first:.5f}, of the last 20 {last:.5f}; "
          f"validation PSNR {run.val_psnrs[-1]:.2f} dB")
    out.update(launches=launches, rays_per_sec=run.rays_per_sec,
               load_s_per_image=run.load_seconds / n_images, store_s=run.store_seconds)

    ntc = os.path.join(run.logdir, f"checkpoint{DISK_RESUME_AT:05d}.ntc")
    reset_launches()
    with quiet():
        rest = train_nerf.main(["--config", cfg_py, "--device", DEVICE, "--load-checkpoint",
                                ntc, "--overrides", "experiment.id", "resumed"])
    counts = read_launches()
    whole_tail = torch.tensor(run.losses[DISK_RESUME_AT:])
    rest_losses = torch.tensor(rest.losses)
    diff = float((rest_losses - whole_tail).abs().max()) if len(rest.losses) else math.inf
    same = bool(torch.equal(rest_losses, whole_tail))
    print(f"[disk] resumed from {os.path.basename(ntc)}: steps {rest.start_step + 1}-"
          f"{rest.start_step + len(rest.losses)}, {counts['fused_flex_mlp_train_fwd']} + "
          f"{counts['fused_flex_mlp_train_bwd']} launches; losses "
          f"{'bitwise' if same else 'NOT bitwise'} the uninterrupted run's (max |diff| "
          f"{diff:.3e})")
    check(rest.start_step == DISK_RESUME_AT and len(rest.losses) == DISK_STEPS - DISK_RESUME_AT,
          f"resume ran {rest.start_step} + {len(rest.losses)} steps")
    check(same, f"resumed losses differ from the uninterrupted run's by up to {diff}")

    cache = os.path.join(tmp, "cache")
    with quiet():
        nrc = cache_dataset.main(["--datapath", scene, "--type", "blender", "--savedir",
                                  cache, "--half-res", "--blender-white-background",
                                  "--format", "binary"])
    stored = native.load_ray_cache_native(nrc)[:3]
    live = captured["data"]["rays"]
    same_store = all(np.array_equal(a, b) for a, b in zip(stored, live))
    with quiet():
        cached = train_nerf.main(["--config", cfg_py, "--device", DEVICE, "--overrides",
                                  "experiment.id", "cached", "dataset.cachedir", cache,
                                  "experiment.train_iters", str(DISK_CACHE_STEPS)])
    same_losses = cached.losses == run.losses[:DISK_CACHE_STEPS]
    print(f"[disk] cache_dataset --format binary: {os.path.getsize(nrc):,} bytes, store "
          f"{'bitwise' if same_store else 'NOT bitwise'} the live one; the first "
          f"{DISK_CACHE_STEPS} losses from it {'equal' if same_losses else 'DIFFER from'} "
          f"the live run's")
    check(same_store and same_losses and cached.store_builder == "cache",
          "the .nrc store or its losses differ from the live run's")

    final = os.path.join(run.logdir, f"checkpoint{DISK_STEPS:05d}.ntc")
    gif = os.path.join(tmp, "test.gif")
    reset_launches()
    with quiet():
        ev = eval_nerf.main(["--config", cfg_py, "--checkpoint", final, "--savedir",
                             os.path.join(tmp, "test"), "--split", "test", "--gif", gif,
                             "--device", DEVICE])
    n_test = DISK_VIEWS[2][1]
    frame_launches = read_launches()["fused_mlp_t"]
    expected = 2 * math.ceil(h * h / int(cfg.nerf.validation.chunksize)) * n_test
    frames = gif_frame_count(open(gif, "rb").read())
    db = min(ev.psnrs)
    print(f"[disk] eval_nerf --split test --gif: {len(ev.psnrs)} frames through #1 "
          f"({frame_launches} launches, expected {expected}), PSNR against the test PNGs "
          f"on white {', '.join(f'{p:.2f}' for p in ev.psnrs)} dB (floor "
          f"{DISK_PSNR_FLOOR_DB}); the GIF holds {frames} frames")
    check(frame_launches == expected, f"eval launches {frame_launches} != {expected}")
    check(all(ev.finite) and len(ev.psnrs) == n_test and frames == n_test, "eval frames")
    check(db >= DISK_PSNR_FLOOR_DB, f"test-split PSNR {db} < {DISK_PSNR_FLOOR_DB}")
    out.update(render_launches=frame_launches, psnr=db, eval_s=ev.steady_seconds,
               scene=scene, cfg_py=cfg_py, checkpoint=final)

    fern = os.path.join(tmp, "fern")
    write_llff_scene(fern, dev)
    fcfg = fern_config()
    fcfg.merge_from_list(["dataset.basedir", fern, "experiment.logdir", tmp,
                          "experiment.train_iters", LLFF_STEPS,
                          "experiment.save_every", LLFF_STEPS])
    fern_py = write_py_config(fcfg, os.path.join(tmp, "fern.py"))
    reset_launches()
    with quiet():
        frun = train_nerf.main(["--config", fern_py, "--device", DEVICE])
        fev = eval_nerf.main(["--config", fern_py, "--checkpoint", os.path.join(
            frun.logdir, f"checkpoint{LLFF_STEPS:05d}.ntc"), "--savedir",
            os.path.join(tmp, "fern_test"), "--split", "test", "--device", DEVICE])
    counts = read_launches()
    flosses = torch.tensor(frun.losses)
    print(f"[disk] fern protocol on an LLFF scene ({LLFF_VIEWS} views minified to "
          f"{LLFF_SIZE[1]}x{LLFF_SIZE[0]}, NDC): {len(frun.losses)} steps on the plain path "
          f"(#8 launches {counts['fused_flex_mlp_train_fwd']}), loss "
          f"{float(flosses[0]):.5f} -> {float(flosses[-1]):.5f}; --split test "
          f"{len(fev.psnrs)} frames, PSNR {', '.join(f'{p:.2f}' for p in fev.psnrs)} dB")
    check(os.path.isdir(os.path.join(fern, "images_8")), "no images_8/ minified")
    check(len(frun.losses) == LLFF_STEPS and bool(torch.isfinite(flosses).all()),
          "LLFF losses")
    check(counts["fused_flex_mlp_train_fwd"] == 0, "the 4x64 fern model reached #8")
    check(all(fev.finite) and len(fev.psnrs) == len(range(0, LLFF_VIEWS, 8)),
          "LLFF test frames")
    out.update(fern=fern)

    print(f"[time] phase 17: decode + resize {1e3 * out['load_s_per_image']:.1f} ms an "
          f"{DISK_SIZE}x{DISK_SIZE} RGBA image, store build {out['store_s']:.2f} s "
          f"({want_rays:,} rays); training {out['rays_per_sec']:,.0f} rays/s on the blender "
          f"store against {synthetic_rays_per_sec:,.0f} on phase 7's synthetic store; eval "
          f"{out['eval_s']:.4f} s a {h}x{h} test frame (f32) {on}")
    return out


@contextlib.contextmanager
def cached_blender_loads(*modules):
    """Decode each blender dataset once for the entry points of phases 18
    and 19 (phase 17 measures the decode): ``load_blender_data`` memoized by
    its arguments in the modules that call it (phase 18's by default)."""
    from nerf_tpu_torch import data, optimize_poses, train_nerf
    from nerf_tpu_torch.data import eval_poses

    modules = modules or (eval_poses, train_nerf, optimize_poses)
    real = data.load_blender_data
    memo = {}

    def cached(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in memo:
            memo[key] = real(*args, **kwargs)
        return memo[key]

    for m in modules:
        m.load_blender_data = cached
    try:
        yield
    finally:
        for m in modules:
            m.load_blender_data = real


def fine_on_common_depths(mc, mf, ro, rd, s):
    """rgb_fine of the kernel and the plain path at rays (ro, rd), both fine
    passes on the kernel path's resampled depths: the renderer's
    ``sample_pdf`` recorded on the kernel path and replayed on the plain
    one, so the box, the sentinel and the compositing are the renderer's
    own."""
    import torch

    from nerf_tpu_torch.engine import renderer

    real = renderer.sample_pdf
    taken = []

    def record(*args, **kwargs):
        taken.append(real(*args, **kwargs))
        return taken[-1]

    try:
        with torch.inference_mode():
            renderer.sample_pdf = record
            kernel = renderer.render_rays(mc, mf, ro, rd, dataclasses.replace(s, use_pallas=True))
            renderer.sample_pdf = lambda *args, **kwargs: taken.pop(0)
            plain = renderer.render_rays(mc, mf, ro, rd, dataclasses.replace(s, use_pallas=False))
    finally:
        renderer.sample_pdf = real
    return kernel.fine.rgb, plain.fine.rgb


def check_frames(mc, mf, s, poses, hwf, what: str, tag: str = "geometry") -> dict:
    """Phase 5's gates on each pose's frame, kernel path against plain path
    at settings ``s``: coarse rgb within RENDER_RGB_TOL, fine rgb too but at
    up to MAX_RESAMPLE_PIXELS pixels, each of which must agree on common
    depths. Returns the kernel frames' maps and the worst errors."""
    import torch

    from nerf_tpu_torch.engine.renderer import make_pose_render_fn
    from nerf_tpu_torch.ops import get_ray_bundle

    h, w, focal = hwf
    kernel = make_pose_render_fn(mc, mf, dataclasses.replace(s, use_pallas=True), h, w, focal)
    plain = make_pose_render_fn(mc, mf, dataclasses.replace(s, use_pallas=False), h, w, focal)
    worst = {"coarse": 0.0, "fine": 0.0, "outliers": 0, "common": 0.0, "frames": []}
    for pose in poses:
        c2w = torch.as_tensor(pose[:3, :4], dtype=torch.float32, device=DEVICE)
        k, p = kernel(c2w), plain(c2w)
        coarse = float((k["rgb_coarse"] - p["rgb_coarse"]).abs().max())
        fine_err = (k["rgb_fine"] - p["rgb_fine"]).abs().amax(dim=-1).reshape(-1)
        outliers = torch.nonzero(fine_err > RENDER_RGB_TOL).flatten()
        check(coarse <= RENDER_RGB_TOL, f"{what}: rgb_coarse kernel vs plain {coarse}")
        check(len(outliers) <= MAX_RESAMPLE_PIXELS, f"{what}: {len(outliers)} rgb_fine outliers")
        if len(outliers):
            ro, rd = get_ray_bundle(h, w, focal, c2w)
            kf, pf = fine_on_common_depths(mc, mf, ro.reshape(-1, 3)[outliers],
                                           rd.reshape(-1, 3)[outliers], s)
            common = float((kf - pf).abs().max())
            check(common <= RENDER_RGB_TOL, f"{what}: rgb_fine on common depths {common}")
            worst["common"] = max(worst["common"], common)
        worst["coarse"] = max(worst["coarse"], coarse)
        worst["fine"] = max(worst["fine"], float(fine_err.max()))
        worst["outliers"] = max(worst["outliers"], len(outliers))
        worst["frames"].append(k)
    print(f"[{tag}] {what}: {len(poses)} frames, kernel vs plain: rgb_coarse "
          f"{worst['coarse']:.3e}, rgb_fine {worst['fine']:.3e}, {worst['outliers']} pixels a "
          f"frame over {RENDER_RGB_TOL:g} (<= {MAX_RESAMPLE_PIXELS}), {worst['common']:.3e} on "
          f"common depths")
    return worst


def faces_per_edge(faces):
    """How many faces hold each edge of a triangle mesh (2 everywhere on a
    closed one)."""
    import numpy as np

    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1)
    return np.unique(edges, axis=0, return_counts=True)[1]


def mesh_normals(verts, faces):
    """Each vertex's area-weighted sum of its faces' winding normals."""
    import numpy as np

    p0, p1, p2 = (verts[faces[:, k]].astype(np.float64) for k in range(3))
    out = np.zeros((verts.shape[0], 3))
    for k in range(3):
        np.add.at(out, faces[:, k], np.cross(p1 - p0, p2 - p0))
    return out


def analytic_sphere_mesh(dev) -> None:
    """The mesh of the analytic scene's own field (``data/synthetic.py``,
    sigma = 40 (0.8 - r)) at GEO_ISO, through ``engine/geometry.extract_mesh``
    on the card at 256^3: watertight, the baked and the winding normals
    outward, every vertex within a voxel diagonal of the analytic shell."""
    import numpy as np
    import torch

    from nerf_tpu_torch.data import analytic_radiance_field
    from nerf_tpu_torch.engine import geometry

    class AnalyticField(torch.nn.Module):
        use_viewdirs = False
        dim_dir = 0

        def __init__(self):
            super().__init__()
            self.anchor = torch.nn.Parameter(torch.zeros((), device=dev))   # its device

        def forward(self, enc):
            return analytic_radiance_field(enc[..., :3])

    s = geometry.RenderSettings(num_encoding_fn_xyz=0, use_viewdirs=False)
    verts, faces, _, normals = geometry.extract_mesh(AnalyticField(), s, resolution=GEO_RESOLUTION,
                                                     iso=GEO_ISO, chunk=262144,
                                                     with_colors=False)
    per_edge = faces_per_edge(faces)
    baked = float(((normals * verts).sum(axis=1) > 0).mean())
    winding = float(((mesh_normals(verts, faces) * verts).sum(axis=1) > 0).mean())
    r_iso = 0.8 - GEO_ISO / 40.0
    off = float(np.abs(np.linalg.norm(verts, axis=1) - r_iso).max())
    diagonal = 3.0 * math.sqrt(3.0) / (GEO_RESOLUTION - 1)
    print(f"[geometry] the analytic field's mesh at iso {GEO_ISO:g}: {verts.shape[0]:,} "
          f"vertices, every edge in {per_edge.min()}..{per_edge.max()} faces, normals outward "
          f"{100 * baked:.2f}% baked and {100 * winding:.2f}% by the winding (at least "
          f"{100 * GEO_OUTWARD:g}%), vertices at most {off:.2e} off r = {r_iso:.2f} (a voxel "
          f"diagonal {diagonal:.2e})")
    check(verts.shape[0] > 0 and int(per_edge.min()) == 2 == int(per_edge.max()),
          "the analytic mesh is not watertight")
    check(min(baked, winding) >= GEO_OUTWARD, f"analytic mesh normals outward {baked}, {winding}")
    check(off <= diagonal, f"analytic mesh vertices {off} off the shell")


def pose_recovery(dev) -> dict:
    """``tests/test_pose_refinement.py:126-175`` on the card (POSE_GAIN's
    setup): a narrow opacified field renders two cameras, which are
    perturbed by 2 degrees / 0.04 and recovered through
    ``make_pose_opt_loop``. Returns the errors before and after."""
    import numpy as np
    import torch

    from nerf_tpu_torch.data import pose_spherical
    from nerf_tpu_torch.engine import pose_opt
    from nerf_tpu_torch.engine.renderer import RenderSettings, make_pose_render_fn
    from nerf_tpu_torch.models import FlexibleNeRFModel

    h = w = 20
    focal = 18.0
    s = RenderSettings(num_coarse=12, num_fine=12, perturb=False, radiance_field_noise_std=0.0,
                       white_background=False, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    model = FlexibleNeRFModel(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4,
                              num_encoding_fn_dir=2, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(3.0)
        model.fc_alpha.bias.add_(2.0)
    model.to(dev)
    true = torch.tensor(np.stack([pose_spherical(30.0 + 140.0 * i, -30.0, 4.0)[:3, :4]
                                  for i in range(2)]), dtype=torch.float32, device=dev)
    render = make_pose_render_fn(model, model, s, h, w, focal, output="f32")
    images = torch.stack([render(pose) for pose in true])
    noisy = pose_opt.perturb_poses(true, SEED, 2.0, 0.04)
    base = pose_opt.as_homogeneous(noisy)
    state = pose_opt.init_pose_opt_state(2, pose_opt.pose_optimizer(3e-3), dev)
    loop = pose_opt.make_pose_opt_loop(model, model, s, h, w, focal, 48, 40)
    for i in range(4):
        state, losses = loop(state, base, images, i)
    before = pose_opt.pose_errors(noisy, true)
    with torch.no_grad():
        after = pose_opt.pose_errors(pose_opt.twists_to_poses(state.xi, base), true)
    out = {f"{when}_{name}": float(err[name].mean())
           for when, err in (("before", before), ("after", after)) for name in ("rot_deg", "trans")}
    print(f"[geometry] the JAX test's refinement (2 x 32 field, 2 cameras, 160 steps): rotation "
          f"error {out['before_rot_deg']:.4f} -> {out['after_rot_deg']:.4f} deg (gate < "
          f"{POSE_GAIN} x), translation {out['before_trans']:.5f} -> {out['after_trans']:.5f}")
    check(bool(torch.isfinite(losses).all())
          and out["after_rot_deg"] < POSE_GAIN * out["before_rot_deg"]
          and out["after_trans"] < out["before_trans"], "pose refinement did not recover the poses")
    return out


def geometry_main_path(dev, on: str, disk: dict) -> dict:
    """Phase 18: geometry and camera-pose refinement on phase 17's trained
    field and dataset, through the entry points a user calls:
    ``train_nerf --tighten-aabb`` resumed (#8 on the tightened intervals),
    ``eval_nerf --tighten-aabb --split test`` in f32 and bf16 (#1), a
    covering box against no box, ``extract_geometry`` at its defaults, and
    ``optimize_poses``, frozen and ``--joint-train``. Returns the launches
    and times."""
    import copy

    import numpy as np
    import torch

    from nerf_tpu_torch import eval_nerf, extract_geometry, optimize_poses, train_nerf
    from nerf_tpu_torch.config import load_config, render_settings_from_config
    from nerf_tpu_torch.data import load_render_split
    from nerf_tpu_torch.engine import geometry
    from nerf_tpu_torch.engine.checkpoint import load_models_and_params

    tmp = os.path.dirname(disk["scene"])
    cfg_py, ckpt = disk["cfg_py"], disk["checkpoint"]
    cfg = load_config(cfg_py)
    tau = str(GEO_TAU)
    out = {}
    with cached_blender_loads():
        reset_launches()
        with quiet():
            run = train_nerf.main(["--config", cfg_py, "--device", DEVICE, "--load-checkpoint",
                                   ckpt, "--tighten-aabb", tau, "--overrides", "experiment.id",
                                   "tight", "experiment.train_iters",
                                   str(DISK_STEPS + GEO_TIGHT_STEPS)])
        counts = read_launches()
        launches = {"fwd": counts["fused_flex_mlp_train_fwd"],
                    "bwd": counts["fused_flex_mlp_train_bwd"]}
        box = run.aabb
        steps = len(run.losses)
        losses = torch.tensor(run.losses)
        print(f"[geometry] train_nerf --tighten-aabb {tau} from {os.path.basename(ckpt)}: box "
              f"({', '.join(f'{v:.4f}' for v in box)}) by a 64^3 sweep in "
              f"{run.aabb_seconds:.3f} s; {steps} bf16 steps, {launches['fwd']} + "
              f"{launches['bwd']} launches of #8 (expected {2 * steps} each), loss "
              f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}")
        check(run.start_step == DISK_STEPS and steps == GEO_TIGHT_STEPS
              and launches["fwd"] == 2 * steps and launches["bwd"] == 2 * steps,
              f"tightened training: {run.start_step} + {steps} steps, launches {launches}")
        check(bool(torch.isfinite(losses).all()), "tightened training loss not finite")
        lo, hi = np.asarray(box[:3]), np.asarray(box[3:])
        ball = GEO_BALL - GEO_VOXEL
        check(bool(np.all(lo > -1.5) and np.all(hi < 1.5)),
              f"box {box} not strictly inside the sweep cube")
        check(bool(np.all(lo <= -ball) and np.all(hi >= ball)),
              f"box {box} does not hold the sigma > {GEO_TAU} ball less a voxel (r {ball:.4f})")
        out.update(train_launches=launches, sweep64_s=run.aabb_seconds, box=box)

        split = load_render_split(cfg, "test", white_background=True)
        hwf = (split.height, split.width, split.focal)
        n_test = len(split.poses)
        expected = 2 * math.ceil(split.height * split.width
                                 / int(cfg.nerf.validation.chunksize)) * n_test
        evals = {}
        for precision in ("float32", "bfloat16"):
            reset_launches()
            with quiet():
                ev = evals[precision] = eval_nerf.main([
                    "--config", cfg_py, "--checkpoint", ckpt, "--savedir",
                    os.path.join(tmp, f"tight_{precision}"), "--split", "test", "--precision",
                    precision, "--tighten-aabb", tau, "--device", DEVICE])
            frame_launches = read_launches()["fused_mlp_t"]
            print(f"[geometry] eval_nerf --tighten-aabb {tau} --split test --precision "
                  f"{precision}: {frame_launches} launches of #1 (expected {expected}), PSNR "
                  f"{', '.join(f'{p:.2f}' for p in ev.psnrs)} dB (floor {DISK_PSNR_FLOOR_DB}), "
                  f"{ev.steady_seconds:.4f} s a frame against phase 17's untightened f32 "
                  f"{disk['eval_s']:.4f} s {on}")
            check(frame_launches == expected, f"eval launches {frame_launches} != {expected}")
            check(all(ev.finite) and len(ev.psnrs) == n_test
                  and min(ev.psnrs) >= DISK_PSNR_FLOOR_DB, f"tightened {precision} frames")
            out[f"render_launches_{precision}"] = frame_launches
            out[f"frame_s_{precision}"] = ev.steady_seconds
        check(evals["float32"].aabb == box, f"eval's box {evals['float32'].aabb} != train's")

        mc, mf, _ = load_models_and_params(ckpt, cfg, DEVICE)
        s = render_settings_from_config(cfg, "validation", hwf=hwf)
        tight = check_frames(mc, mf, dataclasses.replace(s, aabb=box), split.poses, hwf,
                             f"tightened f32 (box {', '.join(f'{v:.3f}' for v in box)})")
        cli_first = evals["float32"].first_maps["rgb_fine"]
        check(torch.equal(cli_first, tight["frames"][0]["rgb_fine"].cpu()),
              "eval_nerf's first tightened frame differs from the kernel path's")

        cover = geometry.density_aabb(mc, s, tau=1e9, bbox_min=(-10.0,) * 3,
                                      bbox_max=(10.0,) * 3)
        check(cover == (-10.0,) * 3 + (10.0,) * 3, f"covering box {cover}")
        covered = check_frames(mc, mf, dataclasses.replace(s, aabb=cover), split.poses[:1], hwf,
                               "covering box (the sweep bounds [-10, 10]^3), f32")
        free = check_frames(mc, mf, s, split.poses[:1], hwf, "no box, f32")
        diff = {k: float((covered["frames"][0][k] - free["frames"][0][k]).abs().max())
                for k in ("rgb_coarse", "rgb_fine", "depth_fine")}
        print(f"[geometry] covering box vs no box, kernel path: max |diff| "
              + ", ".join(f"{k} {v:.3e}" for k, v in diff.items()))
        check(diff["rgb_coarse"] <= RENDER_RGB_TOL and diff["rgb_fine"] <= RENDER_RGB_TOL,
              f"a covering box changed the frame: {diff}")

        mesh = os.path.join(tmp, "lego_mesh.ply")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            extract_geometry.main(["--config", cfg_py, "--checkpoint", ckpt, "--output", mesh,
                                   "--iso", str(GEO_ISO), "--resolution", str(GEO_RESOLUTION),
                                   "--chunk", "262144", "--device", DEVICE, "--save-grid",
                                   os.path.join(tmp, "lego_grid.npz")])
        for line in buf.getvalue().splitlines():
            print(f"[geometry] extract_geometry: {line.replace(tmp, '<tmp>')} {on}")
        verts, faces, colors, normals = geometry.load_ply(mesh)
        per_edge = faces_per_edge(faces)
        winding = mesh_normals(verts, faces)
        outward = float(((winding * verts).sum(axis=1) > 0).mean())
        baked_out = float(((normals * verts).sum(axis=1) > 0).mean())
        agree = float(((winding * normals).sum(axis=1) > 0).mean())
        radii = np.linalg.norm(verts, axis=1)
        r_lo, r_hi = np.percentile(radii, [1, 99])
        print(f"[geometry] mesh at iso {GEO_ISO:g}: {verts.shape[0]:,} vertices, "
              f"{faces.shape[0]:,} faces, every edge in {per_edge.min()}..{per_edge.max()} "
              f"faces; mesh normals outward (n . v > 0) {100 * outward:.2f}%, baked normals "
              f"{100 * baked_out:.2f}%, agreeing with the mesh's {100 * agree:.2f}%; vertex "
              f"radii {radii.min():.4f} .. {radii.max():.4f}, 1st-99th percentile "
              f"{r_lo:.4f} .. {r_hi:.4f} (band {GEO_RADII[0]} .. {GEO_RADII[1]}; the analytic "
              f"shell r = {0.8 - GEO_ISO / 40.0:.2f})")
        check(verts.shape[0] > 0 and colors is not None and normals is not None, "mesh parts")
        check(int(per_edge.min()) == 2 == int(per_edge.max()), "the mesh is not watertight")
        check(GEO_RADII[0] <= r_lo and r_hi <= GEO_RADII[1], f"vertex radii {r_lo}..{r_hi}")
        analytic_sphere_mesh(dev)

        model = mf if mf is not None else mc
        timed = {}
        for name, make in (("colours", geometry.make_rgb_query_fn),
                           ("normals", geometry.make_normals_query_fn)):
            query = make(model, s, 262144)
            query(verts)   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query(verts)
            timed[name] = time.perf_counter() - t0
        grid_fn = {d: geometry.make_sigma_grid_fn(m, s, GEO_GRID_CHECK, (-1.5,) * 3, (1.5,) * 3,
                                                  262144)
                   for d, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu()))}
        grids = {d: fn() for d, fn in grid_fn.items()}
        some = verts[:GEO_NORMALS_CHECK]
        cpu_normals = geometry.make_normals_query_fn(copy.deepcopy(model).cpu(), s, 262144)(some)
        normal_err = np.abs(normals[:GEO_NORMALS_CHECK] - cpu_normals).max(axis=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = geometry.make_sigma_grid_fn(model, s, GEO_RESOLUTION, (-1.5,) * 3, (1.5,) * 3,
                                           262144)()
        sweep_s = time.perf_counter() - t0
        axis = np.linspace(-1.5, 1.5, GEO_RESOLUTION)
        shell = np.sqrt(axis[:, None, None] ** 2 + axis[None, :, None] ** 2
                        + axis[None, None, :] ** 2)
        profile = [float(full[(shell >= r) & (shell < r + 0.1)].mean())
                   for r in np.arange(0.0, 1.0, 0.1)]
        print("[geometry] mean sigma on shells r = 0.0-0.1, ..., 0.9-1.0: "
              + ", ".join(f"{v:.2f}" for v in profile) + " (analytic 40 (0.8 - r))")
        grid_err = float(np.abs(grids["cuda"] - grids["cpu"]).max())
        grid_max = float(grids["cpu"].max())
        print(f"[geometry] the card's {GEO_GRID_CHECK}^3 grid against the CPU's: max |diff| "
              f"{grid_err:.3e} (tol {GEO_GRID_TOL:g} x the max {grid_max:.2f}); "
              f"{GEO_RESOLUTION}^3 sweep again {sweep_s:.3f} s "
              f"({GEO_RESOLUTION ** 3 / sweep_s / 1e6:.1f} M points/s), max sigma "
              f"{float(full.max()):.2f}; vertex queries on {verts.shape[0]:,} points: colours "
              f"{timed['colours']:.4f} s, normals {timed['normals']:.4f} s {on}")
        print(f"[geometry] the card's baked normals against the CPU's at {len(some):,} "
              f"vertices: max |diff| {float(normal_err.max()):.3e}, 99th percentile "
              f"{float(np.percentile(normal_err, 99)):.3e} (tol {GEO_GRID_TOL:g})")
        check(grid_err <= GEO_GRID_TOL * grid_max, f"card grid vs CPU grid {grid_err}")
        check(float(np.percentile(normal_err, 99)) <= GEO_GRID_TOL,
              f"card normals vs CPU normals {np.percentile(normal_err, 99)}")
        out.update(sweep256_s=sweep_s, queries_s=timed, vertices=verts.shape[0])

        with quiet():
            rep = optimize_poses.main(["--config", cfg_py, "--checkpoint", ckpt, "--device",
                                       DEVICE, *POSE_ARGS, "--save-poses",
                                       os.path.join(tmp, "poses_serial.npz")])
        per_iter = rep["wall_s"] / rep["iters"]
        print(f"[geometry] optimize_poses {' '.join(POSE_ARGS)}: {rep['iters']} iterations, "
              f"loss {rep['initial_loss']:.6f} -> {rep['final_loss']:.6f} (gate < "
              f"{POSE_LOSS_GAIN} x), rotation error {rep['initial_rot_deg_mean']:.4f} -> "
              f"{rep['final_rot_deg_mean']:.4f} deg, translation {rep['initial_trans_mean']:.5f}"
              f" -> {rep['final_trans_mean']:.5f}; {rep['wall_s']} s, {per_iter:.4f} s an "
              f"iteration {on}")
        check(all(math.isfinite(rep[k]) for k in ("final_loss", "final_rot_deg_mean",
                                                  "final_trans_mean"))
              and rep["final_loss"] < POSE_LOSS_GAIN * rep["initial_loss"],
              "pose refinement did not lower the photometric loss")
        recovery = pose_recovery(dev)
        joint = os.path.join(tmp, "joint.ntc")
        with quiet():
            jrep = optimize_poses.main(["--config", cfg_py, "--checkpoint", ckpt, "--device",
                                        DEVICE, "--joint-train", "--iters", str(JOINT_ITERS),
                                        "--steps-per-loop", "5", "--save-checkpoint", joint,
                                        *POSE_ARGS])
            jev = eval_nerf.main(["--config", cfg_py, "--checkpoint", joint, "--savedir",
                                  os.path.join(tmp, "joint_eval"), "--split", "test",
                                  "--num-poses", "1", "--device", DEVICE])
        print(f"[geometry] optimize_poses --joint-train, {jrep['iters']} iterations: loss "
              f"{jrep['initial_loss']:.6f} -> {jrep['final_loss']:.6f}, aligned rotation error "
              f"{jrep['aligned_rot_deg_mean']:.4f} deg; eval_nerf renders its .ntc: PSNR "
              f"{jev.psnrs[0]:.2f} dB")
        check(all(math.isfinite(jrep[k]) for k in ("initial_loss", "final_loss",
                                                   "aligned_rot_deg_mean")),
              "joint training not finite")
        check(jrep.get("saved_checkpoint") == joint and all(jev.finite), "joint checkpoint")
        out.update(pose_s_per_iter=per_iter, pose_wall_s=rep["wall_s"], recovery=recovery,
                   mesh_ply=mesh, grid_npz=os.path.join(tmp, "lego_grid.npz"),
                   poses_npz=os.path.join(tmp, "poses_serial.npz"))
    return out


def scene_pair_cases(family: str, scenes: int, n: int, s: int, f: int, dev, seed: int):
    """Inputs of #8's (``family`` "flex") or #9's ("paper", encoding depth
    ``f``) training pair on ``scenes`` scenes, each with its own seeded
    model, orbit points and cotangent: a list of (pts, dc, params, g)."""
    import torch

    from nerf_tpu_torch import models

    cases = []
    for i in range(scenes):
        if family == "flex":
            cases.append(train_case(n, s, seeded_model(seed + i, opacify=False).to(dev), dev,
                                    seed + i))
        else:
            model = models.PaperNeRFModel(num_encoding_fn_xyz=f, num_encoding_fn_dir=4,
                                          generator=torch.Generator().manual_seed(seed + i))
            pts, _, dc, params, g = paper_case(n, s, model.to(dev), dev, seed + i)
            cases.append((pts, dc, params, g))
    return cases


def scene_pair_fns(family: str, f: int):
    """#8's or #9's (forward over scenes, backward over scenes, single-scene
    forward, single-scene backward), each taking the compute dtype last."""
    from nerf_tpu_torch.kernels import flex_train, paper_train

    if family == "flex":
        return (flex_train.flex_train_fwd_scenes, flex_train.flex_train_bwd_scenes,
                flex_train.flex_train_fwd, flex_train.flex_train_bwd)
    return (lambda *a: paper_train.paper_train_fwd_scenes(*a, f),
            lambda *a: paper_train.paper_train_bwd_scenes(*a, f),
            lambda *a: paper_train.paper_train_fwd(*a, f),
            lambda *a: paper_train.paper_train_bwd(*a, f))


def scene_pair_bitwise(family: str, scenes: int, n: int, s: int, f: int, dtype: str, dev,
                       seed: int) -> bool:
    """#8's or #9's scene-batched pair (``scene_pair_cases``) against a
    single-scene launch on each scene's inputs: the output, the residuals,
    the gradient and ddc bitwise, and all finite."""
    import torch

    cases = scene_pair_cases(family, scenes, n, s, f, dev, seed)
    fwd_scenes, bwd_scenes, fwd, bwd = scene_pair_fns(family, f)
    pts, dc, params, g = (torch.stack(x) for x in zip(*cases))
    out, res = fwd_scenes(pts, dc, params, dtype)
    grad, ddc = bwd_scenes(g, res, params, dtype)
    singles = []
    for p_, d_, w_, g_ in cases:
        o1, r1 = fwd(p_, d_, w_, dtype)
        singles.append((o1, r1[0], *bwd(g_, r1, w_, n, s, dtype)))
    torch.cuda.synchronize()
    # The kernels' residuals are one (S, ...) buffer; the plain version's
    # (CPU) a tuple a scene.
    res = res[0] if out.is_cuda else [r[0] for r in res]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, grad, ddc))
    return finite and all(torch.equal(a[i], b) for i, single in enumerate(singles)
                          for a, b in zip((out, res, grad, ddc), single))


def step_gaps(loss, grads: dict, want_loss, want_grads: dict) -> dict:
    """Scene by scene, a step's losses and gradients (stacked leaves, or a
    list of per-scene modules' gradients) against another step's: the
    largest relative loss gap, the largest gradient gap scaled by each
    leaf's largest entry, and the largest relative L2 distance of a leaf."""
    loss_rel = grad_max = grad_norm = 0.0
    for s in range(len(loss)):
        loss_rel = max(loss_rel, abs(float(loss[s]) - float(want_loss[s])) / float(want_loss[s]))
        for name, want in want_grads.items():
            a, b = grads[name][s], want[s]
            if not float(b.abs().max()):
                continue
            grad_max = max(grad_max, float((a - b).abs().max() / b.abs().max()))
            grad_norm = max(grad_norm, float((a - b).norm() / b.norm()))
    return {"loss": loss_rel, "grad": grad_max, "grad_norm": grad_norm}


def multiscene_kernel_path(dev, on: str, model, spec, settings, batch, draws, scene_gen,
                           plain: dict, stores) -> dict:
    """Phase 19, the scene axis of #8 and #9: the pairs' scene-batched
    launches bitwise the single-scene ones; the 6-scene step with
    ``use_pallas_train`` against the plain batched step (``plain``: its
    losses and gradients on the same state, batch and draws) and against
    the single-scene kernel step, f32 and bf16; a 6-scene PaperNeRF step
    through #9 the same way, against the plain batched PaperNeRF step and
    its single-scene kernel steps; then the kernel loops
    beside the plain loop, in turns. Returns the launches and times."""
    import torch

    from nerf_tpu_torch.engine.renderer import draw_render_randoms
    from nerf_tpu_torch.engine.train import create_train_state, make_train_step
    from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel
    from nerf_tpu_torch.parallel.multiscene import (
        create_multiscene_state, make_multiscene_train_loop, make_multiscene_train_step,
        stack_draws,
    )

    out = {}
    parts = []
    for family, scenes, n, s, f in MS_PAIR_SHAPES:
        for dtype in ("float32", "bfloat16"):
            same = scene_pair_bitwise(family, scenes, n, s, f, dtype, dev, seed=n + s)
            parts.append(f"{'#8' if family == 'flex' else '#9'} {scenes}x({n}, {s}"
                         f"{'' if f == 10 else f', F {f}'}) {SHORT[dtype]} "
                         f"{'bitwise' if same else 'DIFFERS'}")
            check(same, f"scene-batched {family} pair at {scenes}x({n}, {s}) {dtype} is not "
                        "bitwise the single-scene launches")
    print("[multiscene] scene-batched training pairs vs single-scene launches on each scene: "
          + "; ".join(parts))

    def singles(family_model, ks, ro, rd, tgt, state):
        """Each scene's single-scene kernel step from the batched state's start."""
        losses, grads = [], {}
        for s_ in range(ro.shape[0]):
            tc, tf = family_model(), family_model()
            tc.load_state_dict(state.scene_params(s_, "coarse"))
            tf.load_state_dict(state.scene_params(s_, "fine"))
            single = create_train_state(tc, tf, spec)
            single, sm = make_train_step(tc, tf, ks)(single, ro[s_], rd[s_], tgt[s_],
                                                     scene_gen(s_))
            losses.append(float(sm.loss))
            for which, module in (("coarse", tc), ("fine", tf)):
                for name, p in module.named_parameters():
                    grads.setdefault(f"{which}.{name}", []).append(p.grad)
        return losses, grads

    ro, rd, tgt = batch
    flex = lambda: FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        ks = dataclasses.replace(settings, use_pallas_train=True, compute_dtype=dtype)
        state = create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
        start = create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
        reset_launches()
        state, m = make_multiscene_train_step(model, model, ks)(state, ro, rd, tgt, draws=draws)
        launches[dtype] = read_launches()
        grads = {k: v.grad for k, v in state.params.items()}
        vs_plain = step_gaps(m.loss, grads, plain["loss"], plain["grads"])
        single_losses, single_grads = singles(flex, ks, ro, rd, tgt, start)
        vs_single = step_gaps(m.loss, grads, single_losses, single_grads)
        counts = launches[dtype]
        print(f"[multiscene] the {MS_SCENES}-scene step through #8, {dtype}: "
              f"{counts['fused_flex_mlp_train_fwd']} + {counts['fused_flex_mlp_train_bwd']} "
              f"launches (expected 2 + 2); against the plain batched f32 step loss rel "
              f"{vs_plain['loss']:.3e}, gradients {vs_plain['grad']:.3e} of a leaf's largest, "
              f"{vs_plain['grad_norm']:.3e} in norm; against the single-scene kernel step "
              f"loss rel {vs_single['loss']:.3e}, gradients {vs_single['grad']:.3e}")
        others = {k: v for k, v in counts.items() if not k.startswith("fused_flex_mlp_train")}
        check(counts["fused_flex_mlp_train_fwd"] == 2 and counts["fused_flex_mlp_train_bwd"] == 2
              and not any(others.values()), f"kernel multi-scene step {dtype}: {counts}")
        if dtype == "float32":
            check(max(vs_plain["loss"], vs_single["loss"]) <= MS_LOSS_RTOL
                  and max(vs_plain["grad"], vs_single["grad"]) <= MS_GRAD_TOL,
                  f"f32 kernel multi-scene step: {vs_plain}, {vs_single}")
        else:
            check(vs_single["loss"] <= TC_BF16_FWD_TOL and vs_single["grad"] <= BF16_TOL
                  and vs_plain["loss"] <= BF16_TOL and vs_plain["grad_norm"] <= MS_BF16_GRAD_NORM,
                  f"bf16 kernel multi-scene step: {vs_plain}, {vs_single}")
        out[f"step_{dtype}"] = {"vs_plain": vs_plain, "vs_single": vs_single}
        del state, start, grads, single_grads
    out["launches"] = launches

    # PaperNeRF through #9: MS_PAPER_RAYS rays a scene, f32 and bf16, against
    # the plain batched step and the single-scene kernel step, as #8 above.
    paper = lambda: PaperNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
    pmodel = paper()
    b = MS_PAPER_RAYS
    pbatch = (ro[:, :b], rd[:, :b], tgt[:, :b])
    pdraws = stack_draws([draw_render_randoms(scene_gen(s_), b, settings, dev)
                          for s_ in range(MS_SCENES)])
    state = create_multiscene_state(pmodel, pmodel, spec, SEED, MS_SCENES, dev)
    reset_launches()
    state, m = make_multiscene_train_step(pmodel, pmodel, settings)(state, *pbatch, draws=pdraws)
    check(not any(read_launches().values()), "the plain Paper multi-scene step reached a kernel")
    pplain = {"loss": m.loss.clone(), "grads": {k: v.grad.clone() for k, v in state.params.items()}}
    del state
    out["paper_launches"] = {}
    for dtype in ("float32", "bfloat16"):
        ks = dataclasses.replace(settings, use_pallas_train=True, compute_dtype=dtype)
        state = create_multiscene_state(pmodel, pmodel, spec, SEED, MS_SCENES, dev)
        start = create_multiscene_state(pmodel, pmodel, spec, SEED, MS_SCENES, dev)
        reset_launches()
        state, m = make_multiscene_train_step(pmodel, pmodel, ks)(state, *pbatch, draws=pdraws)
        counts = out["paper_launches"][dtype] = read_launches()
        grads = {k: v.grad for k, v in state.params.items()}
        vs_plain = step_gaps(m.loss, grads, pplain["loss"], pplain["grads"])
        single_losses, single_grads = singles(paper, ks, *pbatch, start)
        vs_single = step_gaps(m.loss, grads, single_losses, single_grads)
        print(f"[multiscene] the {MS_SCENES}-scene PaperNeRF step ({b} rays a scene) through "
              f"#9, {dtype}: {counts['fused_paper_mlp_train_fwd']} + "
              f"{counts['fused_paper_mlp_train_bwd']} launches (expected 2 + 2); against the "
              f"plain batched f32 step loss rel {vs_plain['loss']:.3e}, gradients "
              f"{vs_plain['grad']:.3e} of a leaf's largest, {vs_plain['grad_norm']:.3e} in norm; "
              f"against the single-scene kernel step loss rel {vs_single['loss']:.3e}, "
              f"gradients {vs_single['grad']:.3e}")
        others = {k: v for k, v in counts.items() if not k.startswith("fused_paper_mlp_train")}
        check(counts["fused_paper_mlp_train_fwd"] == 2 and counts["fused_paper_mlp_train_bwd"] == 2
              and counts["fused_paper_mlp_train_wgmma_bwd"] == 2 * (dtype == "bfloat16")
              and not any(others.values()), f"Paper kernel multi-scene step {dtype}: {counts}")
        if dtype == "float32":
            check(max(vs_plain["loss"], vs_single["loss"]) <= MS_LOSS_RTOL
                  and max(vs_plain["grad"], vs_single["grad"]) <= MS_GRAD_TOL,
                  f"f32 Paper kernel multi-scene step: {vs_plain}, {vs_single}")
        else:
            check(vs_single["loss"] <= TC_BF16_FWD_TOL and vs_single["grad"] <= BF16_TOL
                  and vs_plain["loss"] <= BF16_TOL and vs_plain["grad_norm"] <= MS_BF16_GRAD_NORM,
                  f"bf16 Paper kernel multi-scene step: {vs_plain}, {vs_single}")
        out[f"paper_step_{dtype}"] = {"vs_plain": vs_plain, "vs_single": vs_single}
        del state, start, grads, single_grads
    del pplain

    # The loops train_multiscene runs, kernel and plain in turns.
    batch_size = ro.shape[1]
    loops = {"plain f32": make_multiscene_train_loop(model, model, settings, batch_size,
                                                     MS_PROFILE_STEPS)}
    for dtype in ("float32", "bfloat16"):
        ks = dataclasses.replace(settings, use_pallas_train=True, compute_dtype=dtype)
        loops[f"#8 {SHORT[dtype]}"] = make_multiscene_train_loop(model, model, ks, batch_size,
                                                              MS_PROFILE_STEPS)
    states = {label: create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
              for label in loops}
    for label, loop in loops.items():
        loop(states[label], *stores, SEED)         # warm-up
    ms = {label: [] for label in loops}
    for label in ("#8 f32", "plain f32", "#8 bf16", "#8 bf16", "plain f32", "#8 f32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = loops[label](states[label], *stores, SEED)
        m.loss.cpu()
        ms[label].append(1e3 * (time.perf_counter() - t0) / MS_PROFILE_STEPS)
    out["loop_ms"] = ms
    out["profile"] = {label: profile_steps(lambda: loops[label](states[label], *stores, SEED),
                                           MS_PROFILE_STEPS, f"{MS_SCENES}-scene {label} loop step",
                                           on, top_n=6)
                      for label in ("#8 f32", "#8 bf16")}
    rays = MS_SCENES * batch_size
    print(f"[time] the {MS_SCENES}-scene loop, ms a step in turns (aggregate rays/s): "
          + "; ".join(f"{label} {' / '.join(f'{x:.2f}' for x in v)} "
                      f"({rays * 1e3 * len(v) / sum(v):,.0f})" for label, v in ms.items())
          + f"; busy share #8 f32 {100 * out['profile']['#8 f32']['busy_share']:.1f}%, "
          f"#8 bf16 {100 * out['profile']['#8 bf16']['busy_share']:.1f}% {on}")
    return out


def multiscene_main_path(dev, on: str, disk: dict, single_rays_per_sec: float) -> dict:
    """Phase 19: the multi-scene workflow on phase 17's field, through the
    entry points a user calls: ``distill_dataset`` (the teacher through #1),
    ``train_multiscene`` at the full lowres protocol and with two groups,
    ``eval_multiscene`` through #1 in f32 and bf16 and ``evaluate_metrics``
    on its PNGs; the batched step against the single-scene step per scene;
    the seven optimizer names through #8, the three other model families,
    ``tiny_nerf`` and a ``convert_checkpoint`` round trip. Returns the
    launches and times."""
    import numpy as np
    import torch

    from nerf_tpu_torch import (
        convert_checkpoint, distill_dataset, eval_multiscene, eval_nerf, evaluate_metrics,
        tiny_nerf, train_multiscene, train_nerf,
    )
    from nerf_tpu_torch.config import load_config, model_from_config, render_settings_from_config
    from nerf_tpu_torch.data import (
        composite_white_background, pose_spherical, spherical_render_poses,
    )
    from nerf_tpu_torch.engine.checkpoint import load_models_and_params
    from nerf_tpu_torch.engine.renderer import (
        RenderSettings, draw_render_randoms, make_pose_render_fn,
    )
    from nerf_tpu_torch.engine.train import (
        create_train_state, fold_seed, make_optimizer, make_train_step,
    )
    from nerf_tpu_torch.models import FlexibleNeRFModel, get_model
    from nerf_tpu_torch.ops import get_ray_bundle
    from nerf_tpu_torch.parallel.multiscene import (
        create_multiscene_state, make_multiscene_train_loop, make_multiscene_train_step,
        sample_multiscene_batch, scene_generators, stack_draws,
    )
    from nerf_tpu_torch.utils.png import read_png

    tmp = os.path.dirname(disk["scene"])
    out = {}
    chunk = int(lego_fused_config().nerf.validation.chunksize)

    def frame_launches(side: int, width: int = 0) -> int:
        return 2 * math.ceil(side * (width or side) / chunk)      # coarse + fine a chunk

    # Distill phase 17's field into a blender set through #1.
    distilled = os.path.join(tmp, "distilled")
    reset_launches()
    with quiet():
        dist = distill_dataset.main([
            "--config", disk["cfg_py"], "--checkpoint", disk["checkpoint"], "--savedir",
            distilled, "--num-train", MS_DISTILL[0], "--num-val", MS_DISTILL[1], "--num-test",
            MS_DISTILL[2], "--size", str(MS_SIZE), "--renderer", "pallas", "--device", DEVICE])
    launches = read_launches()
    views = sum(int(n) for n in MS_DISTILL)
    expected = frame_launches(MS_SIZE) * views
    print(f"[multiscene] distill_dataset --renderer pallas: {dist.views} views of "
          f"{MS_SIZE}x{MS_SIZE} through #1 ({launches['fused_mlp_t']} launches, expected "
          f"{expected})")
    check(dist.views == views and launches["fused_mlp_t"] == expected,
          f"distill: {dist.views} views, {launches['fused_mlp_t']} launches")
    out["distill_launches"] = launches["fused_mlp_t"]
    cfg = load_config(disk["cfg_py"])
    with open(os.path.join(distilled, "transforms_train.json")) as f:
        pose0 = np.asarray(json.load(f)["frames"][0]["transform_matrix"], np.float32)
    focal = 0.5 * MS_SIZE / math.tan(0.5 * distill_dataset.BLENDER_CAMERA_ANGLE_X)
    mc, mf, _ = load_models_and_params(disk["checkpoint"], cfg, DEVICE)
    s_val = render_settings_from_config(cfg, "validation", hwf=(MS_SIZE, MS_SIZE, focal))
    with torch.inference_mode():
        held = check_frames(mc, mf, s_val, [pose0], (MS_SIZE, MS_SIZE, focal),
                            "distilled view 0 (--renderer pallas) vs --renderer xla",
                            tag="multiscene")
    png = read_png(os.path.join(distilled, "train", "r_0.png"))
    check(np.array_equal(png, held["frames"][0]["rgb_u8"].cpu().numpy()),
          "distilled r_0.png is not the kernel path's u8 frame")
    del mc, mf, held

    # The full lowres protocol, six scenes at once.
    ms_dir = os.path.join(tmp, "ms6")
    reset_launches()
    with quiet():
        ms = train_multiscene.main([
            "--num-scenes", str(MS_SCENES), "--size", str(MS_SIZE), "--num-coarse", "64",
            "--num-fine", "64", "--n-xyz", "10", "--batch", "1024", "--iters", str(MS_STEPS),
            "--print-every", str(MS_CALL), "--save-dir", ms_dir, "--device", DEVICE])
    launches = read_launches()
    losses = np.concatenate(ms.losses["blender"])          # (MS_STEPS, S)
    first, last = losses[:20].mean(0), losses[-20:].mean(0)
    steady = sum(ms.call_seconds[1:]), sum(ms.call_steps[1:])
    out["ms_rays_per_sec"] = MS_SCENES * 1024 * steady[1] / steady[0]
    out["ms_s_per_step"] = steady[0] / steady[1]
    print(f"[multiscene] train_multiscene --num-scenes {MS_SCENES} --size {MS_SIZE}, 64+64, "
          f"10/4, 1024 rays a scene, f32, {MS_STEPS} steps: mean loss of the first 20 steps "
          f"-> last 20 per scene {', '.join(f'{a:.4f}->{b:.4f}' for a, b in zip(first, last))}; "
          f"kernel launches {sum(launches.values())} (the plain field, as in JAX)")
    check(np.isfinite(losses).all() and (last < first).all(),
          f"a scene's loss did not fall: {first} -> {last}")
    check(sum(launches.values()) == 0, f"multi-scene training reached a kernel: {launches}")
    check(len(ms.checkpoints) == MS_SCENES, f"exports {ms.checkpoints}")
    synth_py = write_py_config(synthetic_train_config(1), os.path.join(tmp, "synthetic.py"))
    reset_launches()
    expected = 0
    with quiet():
        for ckpt in ms.checkpoints:
            ev = eval_nerf.main(["--config", synth_py, "--checkpoint", ckpt, "--num-poses", "1",
                                 "--savedir", os.path.join(tmp, "ms6_eval",
                                                           os.path.basename(os.path.dirname(ckpt))),
                                 "--device", DEVICE])
            check(all(ev.finite), f"{ckpt} rendered non-finite maps")
            expected += frame_launches(ev.height, ev.width)
    n = read_launches()["fused_mlp_t"]
    print(f"[multiscene] each of the {MS_SCENES} exported .ntc renders a {ev.height}x{ev.width} "
          f"frame in eval_nerf through #1 ({n} launches, expected {expected})")
    check(n == expected, f"eval_nerf of the exports: {n} launches")

    # Scene s of the batched step against the single-scene step, at full width.
    settings = RenderSettings(num_coarse=64, num_fine=64, perturb=True,
                              radiance_field_noise_std=0.2, white_background=True,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    model = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
    spec = make_optimizer("adam", 5e-3, 250.0, 0.1)
    state = create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
    singles = []
    for s in range(MS_SCENES):
        tc = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
        tf = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
        tc.load_state_dict(state.scene_params(s, "coarse"))
        tf.load_state_dict(state.scene_params(s, "fine"))
        singles.append(create_train_state(tc, tf, spec))
    poses = torch.as_tensor(spherical_render_poses(MS_SCENES, phi=-30.0, radius=4.0),
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rays, bundles = [], []
    for s in range(MS_SCENES):
        ro, rd = get_ray_bundle(400, 400, 0.5 * 400 / math.tan(0.3455556), poses[s][:3, :4])
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        pick = torch.randint(400 * 400, (1024,), generator=gen, device=dev)
        rays.append((ro[pick], rd[pick], torch.rand(1024, 3, generator=gen, device=dev)))
        bundles.append((ro, rd, torch.rand(400 * 400, 3, generator=gen, device=dev)))
    ro, rd, tgt = (torch.stack(x) for x in zip(*rays))

    def scene_gen(s):
        return torch.Generator(device=dev).manual_seed(fold_seed(SEED, s))

    draws = stack_draws([draw_render_randoms(scene_gen(s), 1024, settings, dev)
                         for s in range(MS_SCENES)])
    state, m = make_multiscene_train_step(model, model, settings)(state, ro, rd, tgt,
                                                                   draws=draws)
    plain = {"loss": m.loss.clone(), "grads": {k: v.grad.clone() for k, v in state.params.items()}}
    loss_err = grad_err = param_diff = 0.0
    for s, single in enumerate(singles):
        single, sm = make_train_step(single.model_coarse, single.model_fine, settings)(
            single, ro[s], rd[s], tgt[s], scene_gen(s))
        loss_err = max(loss_err, abs(float(m.loss[s]) - float(sm.loss)) / float(sm.loss))
        for which, module in (("coarse", single.model_coarse), ("fine", single.model_fine)):
            for name, p in module.named_parameters():
                stacked = state.params[f"{which}.{name}"]
                scale = max(float(p.grad.abs().max()), 1e-12)
                grad_err = max(grad_err, float((stacked.grad[s] - p.grad).abs().max()) / scale)
                param_diff = max(param_diff, float((stacked[s] - p).detach().abs().max()))
    print(f"[multiscene] batched step vs the single-scene step, {MS_SCENES} scenes at full "
          f"width with each scene's own draws: loss rel {loss_err:.3e} (tol {MS_LOSS_RTOL:g}), "
          f"gradients {grad_err:.3e} of each leaf's largest (tol {MS_GRAD_TOL:g}), parameters "
          f"after Adam max |diff| {param_diff:.3e} (lr 5e-3)")
    check(loss_err <= MS_LOSS_RTOL and grad_err <= MS_GRAD_TOL,
          f"batched vs single-scene step: loss {loss_err}, gradients {grad_err}")

    stores = [torch.stack(x) for x in zip(*bundles)]
    out["kernel"] = multiscene_kernel_path(dev, on, model, spec, settings, (ro, rd, tgt), draws,
                                           scene_gen, plain, stores)
    del plain

    # The loop train_multiscene runs, on 400x400 stores: its wall time, then
    # under the profiler (the device's busy share and its top kernels), then
    # the host's per-scene work of a step alone (generators, batches, draws).
    loop = make_multiscene_train_loop(model, model, settings, 1024, MS_PROFILE_STEPS)
    loop(state, *stores, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = loop(state, *stores, SEED)
    m.loss.cpu()
    out["ms_loop_ms"] = 1e3 * (time.perf_counter() - t0) / MS_PROFILE_STEPS
    out["ms_profile"] = profile_steps(lambda: loop(state, *stores, SEED), MS_PROFILE_STEPS,
                                      f"{MS_SCENES}-scene plain f32 loop step", on, top_n=8)
    one_step = make_multiscene_train_loop(model, model, settings, 1024, 1)
    out["ms_matmuls"] = profile_matmuls(lambda: one_step(state, *stores, SEED),
                                        f"one {MS_SCENES}-scene step", on, top_n=6)

    def per_scene_work():
        for t in range(MS_PROFILE_STEPS):
            gens = scene_generators(SEED, t, MS_SCENES, dev)
            sample_multiscene_batch(gens, *stores, 1024)
            stack_draws([draw_render_randoms(g, 1024, settings, dev) for g in gens])

    per_scene_work()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_scene_work()
    torch.cuda.synchronize()
    out["ms_sampling_ms"] = 1e3 * (time.perf_counter() - t0) / MS_PROFILE_STEPS
    print(f"[multiscene] the {MS_SCENES}-scene loop: {out['ms_loop_ms']:.2f} ms a step "
          f"without the profiler; its per-scene generators, batches and draws alone "
          f"{out['ms_sampling_ms']:.2f} ms a step {on}")
    del state, singles, draws, rays, bundles, stores, ro, rd, tgt

    # Two groups: the distilled set and phase 17's scene | phase 17's LLFF
    # scene, then eval_multiscene on them; each dataset is decoded once.
    with cached_blender_loads(train_multiscene, eval_multiscene):
        two_dir = os.path.join(tmp, "ms2")
        with quiet():
            two = train_multiscene.main([
                "--blender-dirs", distilled, disk["scene"], "--llff-dirs", disk["fern"],
                "--llff-factor", "8", "--iters", str(MS_GROUP_STEPS), "--print-every",
                str(MS_GROUP_STEPS // 2), "--num-coarse", "64", "--num-fine", "64", "--n-xyz", "10",
                "--save-dir", two_dir, "--device", DEVICE])
        group_losses = {tag: np.concatenate(x) for tag, x in two.losses.items()}
        print(f"[multiscene] two groups, {MS_GROUP_STEPS} steps: {two.groups}; last losses "
              + "; ".join(f"{tag} {', '.join(f'{v:.4f}' for v in x[-1])}"
                          for tag, x in group_losses.items()))
        check(two.groups == {"blender": ["distilled", "lego"], "llff": ["fern"]},
              f"groups {two.groups}")
        check(all(np.isfinite(x).all() for x in group_losses.values()), "two-group losses")
        check(len(two.checkpoints) == 3, f"two-group exports {two.checkpoints}")

        # eval_multiscene on the blender group through #1, f32 and bf16.
        frame_s = []
        real_pose_fn = eval_multiscene.make_pose_render_fn

        def timed_pose_fn(*args, **kwargs):
            render = real_pose_fn(*args, **kwargs)

            def timed(pose):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = render(pose)
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
                return img

            return timed

        scenes = ["distilled", "lego"]
        n_val = {"distilled": int(MS_DISTILL[1]), "lego": DISK_VIEWS[1][1]}
        sides = {"distilled": MS_SIZE // 2, "lego": DISK_SIZE // 2}
        expected = sum(n_val[sc] * frame_launches(sides[sc]) for sc in scenes)
        summaries = {}
        eval_multiscene.make_pose_render_fn = timed_pose_fn
        try:
            for precision in ("float32", "bfloat16"):
                reset_launches()
                with quiet():
                    summaries[precision] = eval_multiscene.evaluate(
                        cfg, two_dir, tmp, scenes=scenes, split="val",
                        savedir=os.path.join(tmp, f"ms_eval_{precision}"), precision=precision,
                        renderer="pallas", device=DEVICE)
                out[f"eval_multiscene_launches_{precision}"] = read_launches()["fused_mlp_t"]
        finally:
            eval_multiscene.make_pose_render_fn = real_pose_fn
        for precision, summary in summaries.items():
            got = out[f"eval_multiscene_launches_{precision}"]
            print(f"[multiscene] eval_multiscene --renderer pallas --precision {precision}: "
                  + "; ".join(f"{sc} x{r['num_views']} psnr {r['psnr_mean']} (min {r['psnr_min']}) "
                              f"ssim {r['ssim_mean']}" for sc, r in summary["scenes"].items())
                  + f"; #1 launches {got} (expected {expected})")
            check(got == expected, f"eval_multiscene {precision}: {got} launches")
            check(all(math.isfinite(r["psnr_mean"]) for r in summary["scenes"].values()),
                  "eval_multiscene PSNR")
        out["eval_s_per_frame"] = float(np.median(frame_s))
        # evaluate_metrics on the f32 PNGs against the ground truth as eval loaded it.
        images, _, _, _, i_split = eval_multiscene.load_blender_data(distilled, half_res=True)
        truth = os.path.join(tmp, "distilled_val.npz")
        np.savez(truth, images=composite_white_background(images)[i_split[1]])
        with quiet():
            em = evaluate_metrics.main(["--pred", os.path.join(tmp, "ms_eval_float32",
                                                               "distilled"), "--target", truth])
        want = summaries["float32"]["scenes"]["distilled"]
        d_psnr = abs(em["psnr_mean"] - want["psnr_mean"])
        d_ssim = abs(em["ssim_mean"] - want["ssim_mean"])
        print(f"[multiscene] evaluate_metrics on the written PNGs: psnr {em['psnr_mean']:.3f} ssim "
              f"{em['ssim_mean']:.4f} against eval_multiscene's {want['psnr_mean']} / "
              f"{want['ssim_mean']} (|diff| {d_psnr:.4f} dB, {d_ssim:.5f}; tol {MS_METRIC_TOL}: "
              f"the PNGs hold 8 bits)")
        check(em["num_images"] == n_val["distilled"] and d_psnr <= MS_METRIC_TOL[0]
              and d_ssim <= MS_METRIC_TOL[1], "evaluate_metrics does not reproduce eval_multiscene")

    # The seven optimizer names: 3 steps of train_nerf at lego_fused through #8.
    parts, opt_launches = [], {"fwd": 0, "bwd": 0}
    for name in OPTIMIZER_NAMES:
        ocfg = synthetic_train_config(OPT_STEPS)
        ocfg.merge_from_list(["optimizer.type", name, "dataset.num_views", 4,
                              "dataset.image_size", 100, "experiment.logdir", tmp,
                              "experiment.id", f"opt_{name}", "experiment.validate_every", 100,
                              "experiment.print_every", OPT_STEPS])
        reset_launches()
        with quiet():
            r = train_nerf.main(["--config", write_py_config(ocfg, os.path.join(
                tmp, f"opt_{name}.py")), "--device", DEVICE])
        counts = read_launches()
        for which in opt_launches:
            opt_launches[which] += counts[f"fused_flex_mlp_train_{which}"]
        start = model_from_config(ocfg.models.coarse)
        start.reset_parameters(torch.Generator().manual_seed(int(ocfg.experiment.randomseed)))
        end = torch.load(r.checkpoint, map_location="cpu", weights_only=True)
        moved = max(float((end["model_coarse_state_dict"][k] - v).abs().max())
                    for k, v in start.state_dict().items())
        parts.append(f"{name} loss {r.losses[-1]:.4f} moved {moved:.2e}")
        check(len(r.losses) == OPT_STEPS and all(math.isfinite(x) for x in r.losses)
              and moved > 0, f"{name}: losses {r.losses}, moved {moved}")
        check(counts["fused_flex_mlp_train_fwd"] == 2 * OPT_STEPS
              and counts["fused_flex_mlp_train_bwd"] == 2 * OPT_STEPS, f"{name}: {counts}")
    out["optimizer_launches"] = opt_launches
    print(f"[multiscene] {OPT_STEPS} train_nerf steps at lego_fused through #8 "
          f"({2 * OPT_STEPS} + {2 * OPT_STEPS} launches each): " + "; ".join(parts))

    # The three other families: one plain frame, card against CPU.
    parts = []
    side = 64
    fam_focal = 0.5 * side / math.tan(0.3455556)
    pose = torch.as_tensor(pose_spherical(30.0, -30.0, 4.0)[:3, :4], dtype=torch.float32)
    for name in ("VeryTinyNeRFModel", "MultiHeadNeRFModel", "ReplicateNeRFModel"):
        fam = get_model(name, generator=torch.Generator().manual_seed(SEED))
        n_dir = 6 if name != "ReplicateNeRFModel" else 4
        fs = RenderSettings(num_coarse=64, num_fine=64, perturb=False, white_background=True,
                            num_encoding_fn_xyz=6, num_encoding_fn_dir=n_dir, use_pallas=True,
                            use_pallas_train=True, chunksize=side * side)
        with torch.inference_mode():
            cpu = make_pose_render_fn(fam, fam, fs, side, side, fam_focal)(pose)["rgb_fine"]
            fam.to(dev)
            reset_launches()
            card_maps = make_pose_render_fn(fam, fam, fs, side, side, fam_focal)(pose.to(dev))
            counts = read_launches()
        err = float((card_maps["rgb_fine"].cpu() - cpu).abs().max())
        parts.append(f"{name} {err:.2e}")
        check(err <= FAMILY_TOL and sum(counts.values()) == 0,
              f"{name}: card vs CPU {err}, launches {counts}")
    print(f"[multiscene] the three other families, a {side}x{side} frame on the plain path with "
          f"the kernel flags on (no launch), card vs CPU max |diff| (tol {FAMILY_TOL:g}): "
          + ", ".join(parts))

    # tiny_nerf and a convert_checkpoint round trip.
    with quiet():
        tiny = tiny_nerf.main(["--iters", str(TINY_ITERS), "--size", "64", "--display-every",
                               "100", "--logdir", os.path.join(tmp, "tiny"), "--device", DEVICE])
    psnrs = [p for _, p in tiny.val_psnrs]
    print(f"[multiscene] tiny_nerf {TINY_ITERS} iterations: held-out PSNR "
          f"{' -> '.join(f'{p:.2f}' for p in psnrs)} dB, {tiny.rays_per_sec:,.0f} rays/s {on}")
    check(all(math.isfinite(p) for p in psnrs) and psnrs[-1] > psnrs[0], "tiny_nerf PSNR")
    ckpt = disk["checkpoint"][:-len(".ntc")] + ".ckpt"
    with quiet():
        convert_checkpoint.main(["--input", ckpt, "--output", os.path.join(tmp, "rt.ntc")])
        convert_checkpoint.main(["--input", os.path.join(tmp, "rt.ntc"), "--output",
                                 os.path.join(tmp, "rt.ckpt")])
    a = torch.load(ckpt, map_location="cpu", weights_only=True)
    b = torch.load(os.path.join(tmp, "rt.ckpt"), map_location="cpu", weights_only=True)
    same = all(sorted(a[k]) == sorted(b[k]) and all(torch.equal(a[k][n], b[k][n]) for n in a[k])
               for k in ("model_coarse_state_dict", "model_fine_state_dict"))
    print(f"[multiscene] convert_checkpoint .ckpt -> .ntc -> .ckpt: state dicts "
          f"{'bitwise' if same else 'NOT bitwise'} the original's")
    check(same and b["iter"] == a["iter"], "convert_checkpoint round trip")

    out["distill_s_per_view"] = float(np.median(dist.frame_seconds[1:]))
    out["distill_s_per_view_wall"] = dist.seconds / dist.views
    print(f"[time] phase 19: {MS_SCENES}-scene training {out['ms_s_per_step']:.4f} s a step = "
          f"{out['ms_rays_per_sec']:,.0f} aggregate rays/s (host clock over {steady[1]} steps "
          f"after the first call, each call ending in its metrics' fetch) against phase 8's "
          f"plain f32 single-scene step {single_rays_per_sec:,.0f} rays/s; distill_dataset "
          f"{out['distill_s_per_view']:.4f} s a {MS_SIZE}x{MS_SIZE} view (median; f32 through "
          f"#1, render and fetch), {out['distill_s_per_view_wall']:.4f} s a view of the run's "
          f"wall time (PNG writes overlapping renders); eval_multiscene {out['eval_s_per_frame']:.4f} s a frame "
          f"(median, f32 and bf16, 200x200 and 400x400) {on}")
    return out


# --------------------------------------------------------------------------
# Phase 20: the multi-device layer on the one card. The rank bodies are
# top-level functions: each spawned rank imports this file (not as its
# main) and runs one of them.


def p20_batch(dev, seed: int):
    """A 1024-ray batch of phase 7's synthetic store (20 views of 400x400),
    drawn from a generator seeded with ``seed``: the same on every rank."""
    import numpy as np
    import torch

    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset
    from nerf_tpu_torch.engine.train import sample_ray_batch

    ds = make_synthetic_dataset(num_views=20, height=400, width=400, device=dev)
    store = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in flatten_rays(ds, dev)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return sample_ray_batch(gen, *store, 1024), ds.hwf


def p20_step(mesh, settings, spec, batch, parallel: bool, seed: int):
    """One train step of seeded flagship models, serial or data-parallel
    (on this rank's rows of ``batch``): (state, metrics, launches)."""
    import torch

    from nerf_tpu_torch.engine.train import create_train_state, make_train_step
    from nerf_tpu_torch.parallel.dp import make_parallel_train_step
    from nerf_tpu_torch.parallel.mesh import shard_rows

    mc = seeded_model(SEED, opacify=False).to(mesh.device)
    mf = seeded_model(SEED + 1, opacify=False).to(mesh.device)
    state = create_train_state(mc, mf, spec)
    if parallel:
        step, rows = make_parallel_train_step(mc, mf, settings, mesh), shard_rows(mesh, *batch)
    else:
        step, rows = make_train_step(mc, mf, settings), batch
    reset_launches()
    state, m = step(state, *rows, torch.Generator(device=mesh.device).manual_seed(seed))
    torch.cuda.synchronize()
    counts = read_launches()
    return state, m, (counts["fused_flex_mlp_train_fwd"], counts["fused_flex_mlp_train_bwd"])


def p20_nccl_rank() -> dict:
    """Phase 20(a), on a one-rank NCCL group: ``make_parallel_train_step``
    at lego_fused's train protocol (bf16, #8) against ``make_train_step`` on
    the same batch and generator: the parameters after the step."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, DEVICE)
    cfg = synthetic_train_config(1)
    batch, hwf = p20_batch(mesh.device, SEED)
    settings = render_settings_from_config(cfg, "train", hwf=hwf)
    spec = optimizer_from_config(cfg)
    serial, ms, ls = p20_step(mesh, settings, spec, batch, False, SEED + 7)
    dp, md, ld = p20_step(mesh, settings, spec, batch, True, SEED + 7)
    pairs = list(zip(serial.params, dp.params))
    return {"backend": mesh.backend, "world": mesh.world_size,
            "bitwise": all(torch.equal(a, b) for a, b in pairs),
            "max_diff": max(float((a - b).detach().abs().max()) for a, b in pairs),
            "losses": (float(ms.loss), float(md.loss)), "launches": (ls, ld),
            "allreduce_calls": mesh.allreduce_calls}


def p20_train(mesh, paths: dict) -> dict:
    """Phase 20(b): ``train_nerf.main --num-devices 2 --dist-backend gloo``
    in the ranks' group; this rank's #8 launches, its losses and a digest
    of its final weights (the modules captured as the trainer builds its
    state)."""
    import hashlib

    from nerf_tpu_torch import train_nerf

    captured = {}
    real = train_nerf.create_train_state

    def capture(mc, mf, spec, *args, **kwargs):
        captured["models"] = (mc, mf)
        return real(mc, mf, spec, *args, **kwargs)

    train_nerf.create_train_state = capture
    reset_launches()
    try:
        with quiet():
            run = train_nerf.main(["--config", paths["train_py"], "--device", DEVICE,
                                   "--num-devices", "2", "--dist-backend", "gloo"])
    finally:
        train_nerf.create_train_state = real
    counts = read_launches()
    params = [p.detach().cpu().numpy() for m in captured["models"] for p in m.parameters()]
    return {"losses": run.losses, "rays_per_sec": run.rays_per_sec, "seconds": run.seconds,
            "allreduce_ms": run.allreduce_ms, "bucket_bytes": run.bucket_bytes,
            "world_size": run.world_size, "checkpoint": run.checkpoint,
            "n_params": sum(p.size for p in params),
            "digest": hashlib.sha256(b"".join(p.tobytes() for p in params)).hexdigest(),
            "launches": (counts["fused_flex_mlp_train_fwd"], counts["fused_flex_mlp_train_bwd"])}


def p20_union(mesh) -> dict:
    """Phase 20(b): one data-parallel step (f32 through #8, perturbation and
    sigma noise off) against the serial step on the union batch, on rank 0:
    each leaf's gradient and parameter gap over the serial leaf's largest
    value. SGD, so the parameter gap is the gradient's (Adam's first update
    is lr * sign(g), which turns a rounding in a near-zero gradient into a
    whole step)."""
    import hashlib

    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.engine.train import make_optimizer

    batch, hwf = p20_batch(mesh.device, SEED + 1)
    settings = dataclasses.replace(
        render_settings_from_config(synthetic_train_config(1), "train", hwf=hwf),
        compute_dtype="float32", perturb=False, radiance_field_noise_std=0.0)
    spec = make_optimizer("sgd", 5e-3)
    dp, _, launches = p20_step(mesh, settings, spec, batch, True, SEED)
    out = {"launches": launches, "digest": hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes() for p in dp.params)).hexdigest()}
    if mesh.is_primary:
        serial, _, _ = p20_step(mesh, settings, spec, batch, False, SEED)
        gaps = {"grad": 0.0, "param": 0.0}
        for a, b in zip(dp.params, serial.params):
            gaps["grad"] = max(gaps["grad"], float((a.grad - b.grad).abs().max())
                               / max(float(b.grad.abs().max()), 1e-30))
            gaps["param"] = max(gaps["param"], float((a - b).detach().abs().max())
                                / max(float(b.detach().abs().max()), 1e-30))
        out["gaps"] = gaps
    return out


def p20_frame_gap(sharded: dict, serial: dict) -> dict:
    """A 2-rank frame's maps against the one-rank frame's: bitwise or not,
    phase 4's gates (rgb_coarse's largest gap, rgb_fine's pixels over
    RENDER_RGB_TOL) and the u8 values that differ."""
    fine = (sharded["rgb_fine"] - serial["rgb_fine"]).abs().amax(dim=-1)
    u8 = (sharded["rgb_u8"].int() - serial["rgb_u8"].int()).abs()
    return {"bitwise": all(bool((sharded[k] == serial[k]).all()) for k in serial),
            "coarse": float((sharded["rgb_coarse"] - serial["rgb_coarse"]).abs().max()),
            "fine_over": int((fine > RENDER_RGB_TOL).sum()), "u8_values": int((u8 > 0).sum()),
            "u8_levels": int(u8.max())}


def p20_serve(mesh, paths: dict) -> dict:
    """Phase 20(c): the mesh server in the ranks' group. Rank 0 serves a
    ``--logdir`` service over HTTP from a thread (P20_SERVE_RENDERS GETs,
    /health, then a newer .ntc that must reach both ranks) and stops it;
    rank 1 follows until the stop. Then both ranks render the served poses
    with the sharded renderer's maps, and rank 0 holds them against the
    one-rank frames (phase 16 holds those bitwise to the one-rank server's
    PNGs) and the served PNGs against the sharded frames' u8."""
    import numpy as np
    import torch

    from nerf_tpu_torch.engine.checkpoint import (
        convert_torch_state_dict, load_models_and_params, save_checkpoint,
    )
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn
    from nerf_tpu_torch.parallel.dp import make_parallel_pose_render_fn
    from nerf_tpu_torch.serve_nerf import RenderService

    cfg = lego_fused_config()
    reset_launches()
    with quiet():
        service = RenderService(cfg, precision="bfloat16", renderer="kernel",
                                watch_logdir=paths["serve_logdir"], device=DEVICE, mesh=mesh)
    out, pngs = {}, []
    if mesh.is_primary:
        first_step = service.checkpoint_step
        with serving(service) as base:
            health = json.loads(http(base, "/health")[2])
            for i in range(P20_SERVE_RENDERS):
                t0 = time.perf_counter()
                status, _, body = http(base, f"/render?frame={i}")
                out.setdefault("times", []).append(time.perf_counter() - t0)
                check(status == 200, f"2-rank /render?frame={i}: {status} {body[:200]}")
                pngs.append(decode_png(body))
            models = [seeded_model(SEED + i, opacify=True) for i in (2, 3)]
            step = first_step + 1000
            save_checkpoint(os.path.join(paths["serve_logdir"], f"checkpoint{step:05d}.ntc"), {
                "step": step, "params_coarse": convert_torch_state_dict(models[0].state_dict()),
                "params_fine": convert_torch_state_dict(models[1].state_dict())})
            status, _, body = http(base, "/render?frame=0")
            check(status == 200, f"2-rank reload /render?frame=0: {status}")
            pngs.append(decode_png(body))
            after = json.loads(http(base, "/health")[2])
        service.stop()
        out.update(devices=health["devices"], steps=(first_step, after["checkpoint_step"]),
                   reload_differs=not np.array_equal(pngs[0], pngs[-1]))
    else:
        service.follow()
    out.update(launches=read_launches()["fused_mlp_t"], checkpoint_step=service.checkpoint_step,
               frames=P20_SERVE_RENDERS + 2, chunk=service.settings.chunksize)
    h, w, focal = service.height, service.width, service.focal
    out["hwf"] = (h, w, focal)
    frames = [(paths["serve_ntc"], i) for i in range(P20_SERVE_RENDERS)]
    frames.append((service.checkpoint_path, 0))
    gaps = []
    for path, i in frames:
        mc, mf, _ = load_models_and_params(path, cfg, DEVICE)
        pose = torch.as_tensor(np.asarray(service.poses[i], np.float32)[:3, :4], device=DEVICE)
        with torch.inference_mode():
            sharded = make_parallel_pose_render_fn(mc, mf, service.settings, h, w, focal,
                                                   mesh)(pose)
            if not mesh.is_primary:
                continue
            serial = make_pose_render_fn(mc, mf, service.settings, h, w, focal)(pose)
        gap = p20_frame_gap(sharded, serial)
        gap["served"] = bool(np.array_equal(pngs[len(gaps)], sharded["rgb_u8"].cpu().numpy()))
        gaps.append(gap)
    if mesh.is_primary:
        # The one-rank renderer against itself at another chunk size.
        with torch.inference_mode():
            maps = [make_pose_render_fn(mc, mf, dataclasses.replace(service.settings,
                                                                    chunksize=c),
                                        h, w, focal)(pose) for c in (service.settings.chunksize,
                                                                     math.ceil(h * w / 2))]
        out.update(gaps=gaps, chunk_gap=p20_frame_gap(*maps))
    return out


def p20_poses(mesh, paths: dict) -> dict:
    """Phase 20(e): ``optimize_poses --num-devices 2`` in the ranks' group,
    phase 18's arguments; rank 0 saves the refined twists."""
    from nerf_tpu_torch import optimize_poses

    with quiet():
        rep = optimize_poses.main(["--config", paths["disk_py"], "--checkpoint",
                                   paths["disk_ckpt"], "--device", DEVICE, *POSE_ARGS,
                                   "--num-devices", "2", "--dist-backend", "gloo",
                                   "--save-poses", paths["poses_dp"]])
    return {"report": rep}


def p20_multiscene(mesh, paths: dict) -> dict:
    """Phase 20(f): ``train_multiscene --num-devices 2`` on phase 19's six
    scenes for P20_MS_STEPS steps in the ranks' group; then one
    data-parallel step (each rank's half of every scene's batch and of its
    draws) against the one-device batched step on the union batch, on rank
    0 (phase 19's gates)."""
    import numpy as np
    import torch

    from nerf_tpu_torch import train_multiscene
    from nerf_tpu_torch.data import spherical_render_poses
    from nerf_tpu_torch.engine.renderer import RenderDraws, RenderSettings, draw_render_randoms
    from nerf_tpu_torch.engine.train import fold_seed, make_optimizer
    from nerf_tpu_torch.models import FlexibleNeRFModel
    from nerf_tpu_torch.ops import get_ray_bundle
    from nerf_tpu_torch.parallel.mesh import shard_rows
    from nerf_tpu_torch.parallel.multiscene import (
        create_multiscene_state, make_multiscene_train_step,
        make_parallel_multiscene_train_step, shard_multiscene_stores, stack_draws,
    )

    reset_launches()
    with quiet():
        ms = train_multiscene.main([
            "--num-scenes", str(MS_SCENES), "--size", str(MS_SIZE), "--num-coarse", "64",
            "--num-fine", "64", "--n-xyz", "10", "--batch", "1024", "--iters",
            str(P20_MS_STEPS), "--print-every", str(P20_MS_STEPS // 2), "--device", DEVICE,
            "--num-devices", "2", "--dist-backend", "gloo"])
    out = {"losses": np.concatenate(ms.losses["blender"]), "launches": sum(
        read_launches().values()), "s_per_step": ms.call_seconds[-1] / ms.call_steps[-1]}
    dev = mesh.device
    settings = RenderSettings(num_coarse=64, num_fine=64, perturb=True,
                              radiance_field_noise_std=0.2, white_background=True,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    model = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
    spec = make_optimizer("adam", 5e-3, 250.0, 0.1)
    poses = torch.as_tensor(spherical_render_poses(MS_SCENES, phi=-30.0, radius=4.0),
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rays = []
    for s in range(MS_SCENES):
        ro, rd = get_ray_bundle(400, 400, 0.5 * 400 / math.tan(0.3455556), poses[s][:3, :4])
        pick = torch.randint(400 * 400, (1024,), generator=gen, device=dev)
        rays.append((ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick],
                     torch.rand(1024, 3, generator=gen, device=dev)))
    batch = [torch.stack(x) for x in zip(*rays)]
    draws = stack_draws([draw_render_randoms(
        torch.Generator(device=dev).manual_seed(fold_seed(SEED, s)), 1024, settings, dev)
        for s in range(MS_SCENES)])
    state = create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
    local_draws = RenderDraws(*(None if f is None else shard_rows(mesh, f, axis=1)
                                for f in draws))
    state, m = make_parallel_multiscene_train_step(model, model, settings, mesh)(
        state, *shard_multiscene_stores(mesh, *batch), draws=local_draws)
    if mesh.is_primary:
        ref = create_multiscene_state(model, model, spec, SEED, MS_SCENES, dev)
        ref, rm = make_multiscene_train_step(model, model, settings)(ref, *batch, draws=draws)
        out["loss_err"] = float(((m.loss - rm.loss).abs() / rm.loss).max())
        out["grad_err"] = max(
            float(((state.params[k].grad - p.grad).abs().reshape(MS_SCENES, -1).amax(1)
                   / p.grad.abs().reshape(MS_SCENES, -1).amax(1).clamp_min(1e-12)).max())
            for k, p in ref.params.items())
    return out


def p20_ranks(paths: dict) -> dict:
    """Phase 20(b, c, e, f): the two ranks' work on the shared card, in
    order; each part returns numbers only (no tensors)."""
    import torch

    from nerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, DEVICE, "gloo")
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    parts = {"train": lambda: p20_train(mesh, paths), "union": lambda: p20_union(mesh),
             "serve": lambda: p20_serve(mesh, paths), "poses": lambda: p20_poses(mesh, paths),
             "multiscene": lambda: p20_multiscene(mesh, paths)}
    for name, part in parts.items():
        out[name] = part()
        # The ranks share the card: hand this rank's cached blocks back.
        torch.cuda.empty_cache()
    return out


def multidevice_main_path(on: str, served_state: dict, disk: dict, geo: dict,
                          serve_latency_s: float) -> dict:
    """Phase 20: the multi-device layer on the one card, through the entry
    points a user calls, with every rank's kernels on the card: (a) a
    one-rank NCCL group's data-parallel step bitwise the serial step; (b, c,
    e, f) two ranks sharing the card through gloo: ``train_nerf``, the mesh
    server, ``optimize_poses`` and ``train_multiscene`` with ``--num-devices
    2``; (d) ``extract_geometry --num-devices 2``, which spawns its own two
    ranks. Returns the launches and numbers."""
    import numpy as np

    from nerf_tpu_torch import extract_geometry
    from nerf_tpu_torch.engine.checkpoint import save_checkpoint
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.parallel.distributed import rank_device, run_ranks

    import torch

    t_phase = time.perf_counter()
    tmp = os.path.join(os.path.dirname(disk["scene"]), "multidevice")
    os.makedirs(tmp)
    out = {}
    # The ranks share the card with this process: hand its cached blocks back.
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[multidevice] the card's memory before the ranks start: {free / 2**30:.1f} GiB "
          f"free of {total / 2**30:.1f}")

    # (a) One rank, NCCL.
    a = run_ranks(p20_nccl_rank, 1, backend="nccl", device=DEVICE, timeout_s=P20_TIMEOUT_S,
                  deadline_s=P20_DEADLINE_S)[0]
    print(f"[multidevice] (a) {a['backend']} group of {a['world']} rank: the data-parallel step "
          f"at lego_fused's protocol (bf16, #8 launches {a['launches'][1]}) against the serial "
          f"step (#8 {a['launches'][0]}) on one batch and generator: parameters bitwise equal "
          f"{a['bitwise']} (max |diff| {a['max_diff']:.3e}), loss {a['losses'][0]:.6f} / "
          f"{a['losses'][1]:.6f}, {a['allreduce_calls']} all-reduce")
    check(a["bitwise"] and a["launches"][1] == (2, 2) == a["launches"][0]
          and a["allreduce_calls"] == 1, f"phase 20(a): {a}")
    out["nccl_launches"] = a["launches"][1]

    # (b, c, e, f) Two ranks share the card through gloo.
    cfg = synthetic_train_config(P20_TRAIN_STEPS)
    cfg.merge_from_list(["experiment.logdir", tmp, "experiment.id", "dp"])
    serve_logdir = os.path.join(tmp, "serve")
    os.makedirs(serve_logdir)
    serve_ntc = os.path.join(serve_logdir, f"checkpoint{served_state['step']:05d}.ntc")
    save_checkpoint(serve_ntc, served_state)
    paths = {"train_py": write_py_config(cfg, os.path.join(tmp, "dp.py")),
             "serve_logdir": serve_logdir, "serve_ntc": serve_ntc,
             "disk_py": disk["cfg_py"], "disk_ckpt": disk["checkpoint"],
             "poses_dp": os.path.join(tmp, "poses_dp.npz")}
    t0 = time.perf_counter()
    ranks = run_ranks(p20_ranks, 2, paths, backend="gloo", device=DEVICE,
                      timeout_s=P20_TIMEOUT_S, deadline_s=P20_DEADLINE_S)
    ranks_s = time.perf_counter() - t0
    r0, r1 = ranks
    check(r0["device"] == r1["device"] == str(rank_device(DEVICE, 0)),
          f"rank devices {r0['device']} {r1['device']}")

    tr = [r["train"] for r in ranks]
    steps, batch = len(tr[0]["losses"]), int(cfg.nerf.train.num_random_rays)
    losses = np.asarray(tr[0]["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    logdir = os.path.join(tmp, "dp")
    files = sorted(os.listdir(logdir))
    print(f"[multidevice] (b) train_nerf --num-devices 2 --dist-backend gloo, lego_fused on "
          f"the synthetic scene, {steps} steps of {batch} rays ({batch // 2} a rank): #8 "
          f"launches (fwd, bwd) "
          f"rank 0 {tr[0]['launches']}, rank 1 {tr[1]['launches']} (expected {2 * steps} each); "
          f"mean loss of the first 10 steps {first:.5f}, of the last 10 {last:.5f}; final "
          f"weights' sha256 equal on both ranks {tr[0]['digest'] == tr[1]['digest']}; the "
          f"logdir holds {files}")
    check(steps == P20_TRAIN_STEPS and tr[0]["world_size"] == 2, f"{steps} steps")
    check(all(t["launches"] == (2 * steps, 2 * steps) for t in tr), "#8 launches on the ranks")
    check(last < first and np.isfinite(losses).all(), f"the loss did not fall: {first} {last}")
    check(tr[0]["digest"] == tr[1]["digest"], "the ranks' final weights differ")
    want = [f"checkpoint{steps:05d}.ckpt", f"checkpoint{steps:05d}.ntc", "config.json",
            "images", "metrics.jsonl"]
    check(files == want and tr[1]["checkpoint"] is None, f"logdir {files}")
    reset_launches()
    with quiet():
        ev = render_trajectory(cfg, tr[0]["checkpoint"], os.path.join(tmp, "dp_eval"),
                               num_poses=1, renderer="kernel", device=DEVICE)
    ev_launches = read_launches()["fused_mlp_t"]
    print(f"[multidevice] (b) eval_nerf renders rank 0's checkpoint through #1 "
          f"({ev_launches} launches): finite {all(ev.finite)}")
    check(all(ev.finite) and ev_launches > 0, "eval of the data-parallel checkpoint")
    un = [r["union"] for r in ranks]
    print(f"[multidevice] (b) one data-parallel step (f32, #8 launches per rank "
          f"{un[0]['launches']} / {un[1]['launches']}, no jitter or noise, SGD) against the "
          f"serial step on the union batch of 1024 rays: gradient gap {un[0]['gaps']['grad']:.3e}, "
          f"parameter gap {un[0]['gaps']['param']:.3e} of each leaf's largest (tol "
          f"{P20_DP_TOL:g}); ranks' weights equal {un[0]['digest'] == un[1]['digest']}")
    check(max(un[0]["gaps"].values()) <= P20_DP_TOL and un[0]["digest"] == un[1]["digest"],
          f"DP step vs serial: {un[0]['gaps']}")
    bucket_mb = tr[0]["bucket_bytes"] / 1e6
    print(f"[time] (b) two ranks sharing the card through gloo: {tr[0]['rays_per_sec']:,.0f} "
          f"rays/s over {tr[0]['seconds']:.2f} s of training; the gradient all-reduce "
          f"{tr[0]['allreduce_ms']:.3f} ms a step on rank 0 ({tr[1]['allreduce_ms']:.3f} on "
          f"rank 1; host clock around the synchronized collective, CPU staging included); "
          f"the flat bucket {tr[0]['bucket_bytes']:,} bytes ({bucket_mb:.3f} MB: "
          f"{tr[0]['n_params']:,} parameters + 3 losses, f32) {on}")
    check(tr[0]["bucket_bytes"] == 4 * (tr[0]["n_params"] + 3), "bucket bytes")
    out.update(train_launches=tr[0]["launches"], rays_per_sec=tr[0]["rays_per_sec"],
               allreduce_ms=tr[0]["allreduce_ms"], bucket_bytes=tr[0]["bucket_bytes"])

    sv, follower = r0["serve"], r1["serve"]
    h, w, _ = sv["hwf"]
    per_frame = 2 * math.ceil(math.ceil(h * w / 2) / sv["chunk"])
    latency = sorted(sv["times"])[len(sv["times"]) // 2]
    gaps = sv["gaps"]
    print(f"[multidevice] (c) the mesh server, 2 ranks, {h}x{w} bf16: /health devices "
          f"{sv['devices']}; #1 launches rank 0 {sv['launches']}, rank 1 "
          f"{follower['launches']} (expected {per_frame * sv['frames']} each: warm-up, "
          f"{P20_SERVE_RENDERS} GETs, the reload's GET); --logdir reload: step "
          f"{sv['steps'][0]} -> {sv['steps'][1]} on rank 0, {follower['checkpoint_step']} on "
          f"rank 1; rank 1 left after the stop; every served PNG the sharded frame's u8 "
          f"{all(g['served'] for g in gaps)}")
    print(f"[multidevice] (c) the {len(gaps)} served frames (the last after the reload) "
          f"against the one-rank frames: bitwise {sum(g['bitwise'] for g in gaps)} of "
          f"{len(gaps)}; rgb_coarse max |diff| {max(g['coarse'] for g in gaps):.3e} (tol "
          f"{RENDER_RGB_TOL:g}); rgb_fine pixels over {RENDER_RGB_TOL:g} "
          f"{[g['fine_over'] for g in gaps]} (at most {MAX_RESAMPLE_PIXELS}); u8 values that "
          f"differ {[g['u8_values'] for g in gaps]} of {h * w * 3}, by at most "
          f"{max(g['u8_levels'] for g in gaps)} levels; the one-rank renderer against itself "
          f"at chunk {sv['chunk']} and {math.ceil(h * w / 2)} (a rank's rays in one chunk): "
          f"rgb_coarse {sv['chunk_gap']['coarse']:.3e}, rgb_fine pixels over "
          f"{RENDER_RGB_TOL:g} {sv['chunk_gap']['fine_over']}, u8 values "
          f"{sv['chunk_gap']['u8_values']}")
    check(sv["devices"] == 2 and all(g["served"] for g in gaps), f"(c) served frames {gaps}")
    check(all(g["bitwise"] or (g["coarse"] <= RENDER_RGB_TOL
                               and g["fine_over"] <= MAX_RESAMPLE_PIXELS) for g in gaps),
          f"(c) the 2-rank frames fail phase 4's gates: {gaps}")
    check(sv["reload_differs"], "(c) the frame after the reload shows the old weights")
    check(sv["launches"] == follower["launches"] == per_frame * sv["frames"],
          f"(c) launches {sv['launches']} {follower['launches']}")
    check(follower["checkpoint_step"] == sv["checkpoint_step"] == sv["steps"][1]
          != sv["steps"][0], "(c) the reload did not reach both ranks")
    print(f"[time] (c) 2-rank server request latency "
          f"{' / '.join(f'{t:.4f}' for t in sv['times'])} s, median {latency:.4f} s, against "
          f"phase 16's one-rank median {serve_latency_s:.4f} s {on}")
    out.update(serve_launches=sv["launches"], serve_latency_s=latency)

    # (d) extract_geometry spawns its own two ranks.
    mesh2, grid2 = os.path.join(tmp, "mesh_dp.ply"), os.path.join(tmp, "grid_dp.npz")
    t0 = time.perf_counter()
    extract_geometry.main(["--config", disk["cfg_py"], "--checkpoint", disk["checkpoint"],
                           "--output", mesh2, "--iso", str(GEO_ISO), "--resolution",
                           str(GEO_RESOLUTION), "--chunk", "262144", "--device", DEVICE,
                           "--save-grid", grid2, "--num-devices", "2", "--dist-backend", "gloo",
                           "--dist-timeout", str(P20_TIMEOUT_S)])
    extract_s = time.perf_counter() - t0
    same_grid = bool(np.array_equal(np.load(grid2)["sigma"], np.load(geo["grid_npz"])["sigma"]))
    with open(mesh2, "rb") as f_dp, open(geo["mesh_ply"], "rb") as f_serial:
        same_mesh = f_dp.read() == f_serial.read()
    print(f"[multidevice] (d) extract_geometry --num-devices 2 at {GEO_RESOLUTION}^3 (its own "
          f"2 spawned ranks): grid bitwise phase 18's serial grid {same_grid}, PLY bytes equal "
          f"{same_mesh}; {extract_s:.1f} s of command, spawn included {on}")
    check(same_grid and same_mesh, "(d) the sharded sweep differs from the serial one")

    rep = r0["poses"]["report"]
    xi_dp, xi_serial = (np.load(p)["xi"] for p in (paths["poses_dp"], geo["poses_npz"]))
    xi_err = float(np.abs(xi_dp - xi_serial).max())
    print(f"[multidevice] (e) optimize_poses --num-devices 2, {' '.join(POSE_ARGS)}: "
          f"{rep['iters']} iterations, loss {rep['initial_loss']:.6f} -> "
          f"{rep['final_loss']:.6f}; final twists against phase 18's serial run max |diff| "
          f"{xi_err:.3e} (tol {P20_POSE_TOL:g}); {rep['wall_s']} s {on}")
    check(xi_err <= P20_POSE_TOL, f"(e) twists {xi_err}")

    ms = r0["multiscene"]
    ms_first, ms_last = ms["losses"][:5].mean(0), ms["losses"][-5:].mean(0)
    print(f"[multidevice] (f) train_multiscene --num-devices 2, {MS_SCENES} scenes, "
          f"{P20_MS_STEPS} steps: losses finite {bool(np.isfinite(ms['losses']).all())}, mean "
          f"of the first 5 -> last 5 steps {', '.join(f'{a:.4f}->{b:.4f}' for a, b in zip(ms_first, ms_last))}; "
          f"kernel launches {ms['launches']}; one data-parallel step against the one-device "
          f"batched step: loss rel {ms['loss_err']:.3e} (tol {MS_LOSS_RTOL:g}), gradients "
          f"{ms['grad_err']:.3e} of a leaf's largest (tol {MS_GRAD_TOL:g}); "
          f"{ms['s_per_step']:.4f} s a step {on}")
    check(np.isfinite(ms["losses"]).all() and ms["launches"] == 0, "(f) losses or launches")
    check(ms["loss_err"] <= MS_LOSS_RTOL and ms["grad_err"] <= MS_GRAD_TOL,
          f"(f) DP vs one-device step: {ms['loss_err']} {ms['grad_err']}")
    print(f"[time] phase 20: {time.perf_counter() - t_phase:.1f} s (the two-rank group "
          f"{ranks_s:.1f} s of it) {on}")
    return out


def hash_rays(rays: int, samples: int, depth: float, dev, gen):
    """Points (rays * samples, 3) as a ray's samples lie: each ray a straight
    stretch of length ``depth`` about a point of the cube, neighbours in
    memory near each other, clamped just outside the cube."""
    import torch

    o = (torch.rand(rays, 1, 3, generator=gen, device=dev) * 2 - 1) * 1.5
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device=dev), dim=-1)
    t = torch.linspace(-depth / 2, depth / 2, samples, device=dev)[None, :, None]
    return torch.clamp(o + d * t, -1.6, 1.6).reshape(-1, 3).contiguous()


def hash_atomic_bound(grad, pts, grid):
    """How far two sums of one row's terms in any order can part: 2 n u
    sum |term|, n the row's count of terms, u = 2^-24 (rows no term reaches
    are 0 in both)."""
    import torch

    from nerf_tpu_torch.kernels import hashgrid
    from nerf_tpu_torch.ops import encoding

    absum = hashgrid.hash_encode_plain_bwd(grad.float().abs(), pts, grid)
    count = torch.zeros(grid.num_entries, device=pts.device)
    for level in range(grid.num_levels):
        rows, _ = encoding.hash_corners(pts, grid, level)
        count.index_add_(0, rows.reshape(-1), torch.ones(rows.numel(), device=pts.device))
    return 2 * count[:, None] * 2.0 ** -24 * absum


def hashgrid_main_path(dev, on: str, tmp: str) -> dict:
    """Phase 21: Instant-NGP's hash-grid field and its encoding pair (#10).
    The pair's registers; the pair against the plain version at HASH_SHAPES,
    the forward bitwise and the backward within ``hash_atomic_bound``, in f32
    and bf16; ``train_nerf.train`` at the lego_hashgrid protocol on the
    synthetic scene (2 + 2 launches a step, a falling loss); then a step's
    encodings (coarse and fine, each field its own table) timed each way by
    CUDA events, kernel and plain in turns: the kernel's wrapper, the
    backward's with the fill that zeroes its gradient (timed alone too).
    Not by the profiler: after the earlier phases' profiles its device times
    of these kernels read up to 4x below the events' on an H100. Returns
    what the kernels line takes."""
    import torch

    from nerf_tpu_torch import models
    from nerf_tpu_torch.kernels import _build, hashgrid
    from nerf_tpu_torch.train_nerf import train

    regs = ptxas_summary(_build.library_path().with_suffix(".log").read_text()).split(", ")
    mine = [r for r in regs if r.rsplit(" ", 1)[0].split(" (")[0] in HASH_KERNELS]
    vector = bool(_build.load_library().nerf_hash_encode_vector_red())
    print(f"[hashgrid] registers of #10: {', '.join(mine)}; the backward adds a corner's "
          f"two features with one vector reduction: {vector}")
    check(len(mine) == len(HASH_KERNELS) and not any("(" in r for r in mine),
          f"#10 missing or spilling: {mine}")

    kwargs = {k: v for k, v in HASH_MODEL.items() if k != "type"}
    fields = [models.HashGridNeRFModel(**kwargs, generator=torch.Generator().manual_seed(seed))
              .to(dev) for seed in (SEED, SEED + 1)]
    grid = fields[0].grid
    tables = [f.table.detach() for f in fields]
    gen = torch.Generator(device=dev).manual_seed(20260923)
    worst = {"fwd": {}, "bwd": {}}
    for rays, samples, depth in HASH_SHAPES:
        pts = hash_rays(rays, samples, depth, dev, gen)
        n = pts.shape[0]
        for dtype in ("float32", "bfloat16"):
            got = hashgrid.fused_hash_encode(tables[0], pts, grid, dtype)
            check(torch.equal(got, hashgrid.hash_encode_plain(tables[0], pts, grid, dtype)),
                  f"#10 forward vs plain at {n} points, depth {depth}, {dtype}: not bitwise")
            worst["fwd"][dtype] = 0.0
            grad = torch.randn(n, 2 * grid.num_levels, generator=gen, device=dev).to(
                getattr(torch, dtype))
            grad[::7] = 0       # points whose gradient is 0, as samples past a surface
            dt = hashgrid._backward(grad, pts, grid)
            want = hashgrid.hash_encode_plain_bwd(grad, pts, grid)
            gap, allowed = (dt - want).abs(), hash_atomic_bound(grad, pts, grid)
            over = int((gap > allowed).sum())
            err = float(gap.max())
            worst["bwd"][dtype] = max(worst["bwd"].get(dtype, 0.0), err)
            print(f"[hashgrid] {rays}x{samples} points over depth {depth}, {dtype}: forward "
                  f"bitwise plain; backward max |kernel - plain| {err:.3e}, at most "
                  f"{float((gap / allowed.clamp_min(1e-30)).max()):.3f} of the atomics' order "
                  f"bound, {over} entries over it")
            check(over == 0 and torch.equal(dt == 0, want == 0),
                  f"#10 backward vs plain at {n} points, depth {depth}, {dtype}: {over} over")
    del got, grad, dt, want, gap, allowed

    cfg = synthetic_train_config(HASH_TRAIN_STEPS, lego_hashgrid_config)
    cfg.merge_from_list(["dataset.image_size", 100])
    hashgrid.fused_hash_encode.fwd_launches = hashgrid.fused_hash_encode.bwd_launches = 0
    with quiet():
        run = train(cfg, logdir=os.path.join(tmp, "hashgrid"), device=DEVICE)
    launches = {"fwd": hashgrid.fused_hash_encode.fwd_launches,
                "bwd": hashgrid.fused_hash_encode.bwd_launches}
    steps, frames = len(run.losses), len(run.val_psnrs)
    losses = torch.tensor(run.losses)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"[hashgrid] train_nerf.train, lego_hashgrid protocol on the synthetic scene "
          f"(100x100), {steps} steps of {cfg.nerf.train.num_random_rays} rays, "
          f"{cfg.nerf.train.compute_dtype}: {launches['fwd']} forward and {launches['bwd']} "
          f"backward launches of #10 (expected {2 * steps} + 2 a validation frame and "
          f"{2 * steps}); mean loss of the first 20 steps {first:.5f}, of the last 20 "
          f"{last:.5f}; {run.rays_per_sec:,.0f} rays/s {on}")
    check(steps == HASH_TRAIN_STEPS, f"{steps} steps trained")
    check(launches == {"fwd": 2 * steps + 2 * frames, "bwd": 2 * steps},
          f"#10 launches on the training path {launches}")
    check(bool(torch.isfinite(losses).all()) and last < first,
          f"the hash field's loss did not fall: {first} -> {last}")

    step = [hash_rays(rays, samples, 3.0, dev, gen) for rays, samples, _ in HASH_STEP_SHAPES]
    times = {}
    for dtype in ("float32", "bfloat16"):
        grads = [torch.randn(p.shape[0], 2 * grid.num_levels, generator=gen, device=dev).to(
            getattr(torch, dtype)) for p in step]
        fns = {
            "fwd": (lambda: [hashgrid._forward(t, p, grid, dtype) for t, p in zip(tables, step)],
                    lambda: [hashgrid.hash_encode_plain(t, p, grid, dtype)
                             for t, p in zip(tables, step)]),
            "bwd": (lambda: [hashgrid._backward(g, p, grid) for g, p in zip(grads, step)],
                    lambda: [hashgrid.hash_encode_plain_bwd(g, p, grid)
                             for g, p in zip(grads, step)]),
        }
        parts = []
        for which, (kernel, plain) in fns.items():
            p1, k1, k2, p2 = (cuda_ms(f, reps) for f, reps in
                              ((plain, 3), (kernel, 20), (kernel, 20), (plain, 3)))
            times[which, dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            parts.append(f"{which} kernel {k1:.4f} / {k2:.4f}, plain {p1:.3f} / {p2:.3f}")
        print(f"[time] fused_hash_encode, a step's encodings "
              f"({' + '.join(str(p.shape[0]) for p in step)} points), {dtype}, ms: "
              f"{'; '.join(parts)} {on}")
    times["zero"] = cuda_ms(lambda: [torch.zeros_like(t) for t in tables], 20)
    print(f"[time] the fills that zero a step's two table gradients: {times['zero']:.4f} ms {on}")
    return {"worst": worst, "times": times, "launches": launches, "vector_red": vector,
            "points": sum(p.shape[0] for p in step), "rows": grid.num_entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.kernels import _build
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t, mlp_t_plain

    dev = torch.device(DEVICE)
    # Phase 1: device.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    on = f"({card.removeprefix('NVIDIA ')})"

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = _build.build_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    regs = ptxas_summary(lib.with_suffix(".log").read_text()).split(", ")
    print("[build] registers of the tensor-core instances: "
          + ", ".join(r for r in regs if r.rsplit(" ", 1)[0] in TENSOR_CORE_KERNELS)
          + "; spills (store/load bytes): " + (", ".join(r for r in regs if "(" in r) or "none"))
    for what, names in (("f32 4x128 forwards", F32_FLEX_KERNELS),
                        ("f32 4x128 backward passes", F32_FLEX_BWD_KERNELS),
                        ("f32 Paper kernels", F32_PAPER_KERNELS),
                        ("wgmma weight-gradient pass", WGMMA_BWD_KERNELS)):
        f32_regs = [r for r in regs if r.rsplit(" ", 1)[0].split(" (")[0] in names]
        print(f"[build] registers of the {what}: " + ", ".join(f32_regs))
        check(len(f32_regs) == len(names) and not any("(" in r for r in f32_regs),
              f"{what} missing or spilling: {f32_regs}")
    mma = sass_mma_counts(lib)
    print("[build] HMMA/HGMMA instructions (cuobjdump -sass): "
          + ", ".join(f"{k} {mma.get(k)}" for k in TENSOR_CORE_KERNELS))
    check(all(mma.get(k) for k in TENSOR_CORE_KERNELS), f"no tensor-core instructions: {mma}")

    # Phase 3: kernel vs plain at the render path's shapes.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = seeded_model(SEED, opacify=False).to(dev)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    with torch.inference_mode():
        for n, s in CHECK_SHAPES:
            pts, vd = orbit_points(n, s, dev, seed=n + s)
            errs = {}
            for dtype, tol in (("float32", F32_TOL), ("bfloat16", TC_BF16_FWD_TOL)):
                got = fused_mlp_t(model, pts, vd, dtype)
                torch.cuda.synchronize()
                want = mlp_t_plain(model, pts, vd, dtype)
                torch.cuda.synchronize()
                check(got.shape == (n, s, 4) and bool(torch.isfinite(got).all()),
                      f"kernel output at ({n}, {s}) {dtype}")
                err = errs[dtype] = float((got - want).abs().max())
                worst[dtype] = max(worst[dtype], err)
                check(err <= tol, f"kernel vs plain at ({n}, {s}) {dtype}: {err} > {tol}")
            print(f"[kernel] ({n}, {s}): max |kernel - plain| f32 {errs['float32']:.3e}, bf16 "
                  f"{errs['bfloat16']:.3e} (tol {F32_TOL:g} / {TC_BF16_FWD_TOL:g}), max |plain| "
                  f"{float(want.abs().max()):.3e}")
        # The bf16 instance (flex_wg.cuh's wgmma body) alone at a frame's four
        # shapes and ragged ones, one wgmma launch each.
        lines = []
        for n, s in FRAME_SHAPES + RAGGED_SHAPES:
            pts, vd = orbit_points(n, s, dev, seed=n + s + 1)
            before = (fused_mlp_t.launches, fused_mlp_t.wgmma_launches)
            got = fused_mlp_t(model, pts, vd, "bfloat16")
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"kernel bf16 output at ({n}, {s})")
            check((fused_mlp_t.launches, fused_mlp_t.wgmma_launches) == (before[0] + 1,
                                                                         before[1] + 1),
                  f"kernel bf16 at ({n}, {s}) not one wgmma launch")
            err = float((got - mlp_t_plain(model, pts, vd, "bfloat16")).abs().max())
            worst["bfloat16"] = max(worst["bfloat16"], err)
            check(err <= TC_BF16_FWD_TOL, f"kernel vs plain at ({n}, {s}) bfloat16: {err}")
            lines.append(f"({n}, {s}) {err:.2e}")
            del pts, vd, got
        print(f"[kernel] bf16 (wgmma, one launch each) max |kernel - plain| (tol "
              f"{TC_BF16_FWD_TOL:g}): {', '.join(lines)}")

    # Phase 4: the main path, through the eval entry point.
    cfg = lego_fused_config()
    rays = int(cfg.dataset.height) * int(cfg.dataset.width)
    chunk = int(cfg.nerf.validation.chunksize)
    expected = 2 * math.ceil(rays / chunk) * NUM_POSES   # coarse + fine per chunk
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "lego_fused_seeded.ckpt")
        torch.save({
            "iter": 0,
            "model_coarse_state_dict": seeded_model(SEED, opacify=True).state_dict(),
            "model_fine_state_dict": seeded_model(SEED + 1, opacify=True).state_dict(),
        }, ckpt)

        reset_launches()
        with quiet():
            main_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "kernel"),
                                         num_poses=NUM_POSES, precision="float32",
                                         renderer="kernel", device=DEVICE)
        launches = read_launches()["fused_mlp_t"]
        print(f"[main] {NUM_POSES} frames {main_run.height}x{main_run.width} through "
              f"the kernel: {launches} launches (expected {expected})")
        check(launches == expected, f"kernel launches {launches} != {expected}")
        check(all(main_run.finite), f"non-finite maps: {main_run.finite}")
        pngs = sorted(os.listdir(os.path.join(tmp, "kernel")))
        check(len(pngs) == NUM_POSES, f"PNGs written: {pngs}")
        maps = main_run.first_maps
        check(tuple(maps["rgb_fine"].shape) == (main_run.height, main_run.width, 3),
              f"rgb_fine shape {tuple(maps['rgb_fine'].shape)}")
        print(f"[main] frame 0: acc mean {float(maps['acc_fine'].mean()):.4f}, "
              f"rgb mean {float(maps['rgb_fine'].mean()):.4f}, "
              f"rgb std {float(maps['rgb_fine'].std()):.4f}")

        with quiet():
            plain_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "plain"), num_poses=1,
                                          precision="float32", renderer="plain", device=DEVICE)
        ref = plain_run.first_maps
        err = float((maps["rgb_coarse"] - ref["rgb_coarse"]).abs().max())
        print(f"[main] frame 0 rgb_coarse: max |kernel path - plain path| = {err:.3e} "
              f"(tol {RENDER_RGB_TOL:g})")
        check(err <= RENDER_RGB_TOL, f"rgb_coarse kernel vs plain: {err}")
        fine_err = (maps["rgb_fine"] - ref["rgb_fine"]).abs().amax(dim=-1).reshape(-1)
        outliers = torch.nonzero(fine_err > RENDER_RGB_TOL).flatten()
        print(f"[main] frame 0 rgb_fine: max |kernel path - plain path| = "
              f"{float(fine_err.max()):.3e}; {len(outliers)} of {fine_err.numel()} pixels "
              f"over {RENDER_RGB_TOL:g} (at most {MAX_RESAMPLE_PIXELS}, each a moved resample)")
        check(len(outliers) <= MAX_RESAMPLE_PIXELS, f"{len(outliers)} rgb_fine outliers")
        if len(outliers):
            check_resample_outliers(cfg, outliers, (main_run.height, main_run.width,
                                                    main_run.focal),
                                    seeded_model(SEED, opacify=True).to(dev),
                                    seeded_model(SEED + 1, opacify=True).to(dev), fused_mlp_t)
        print("[main] frame 0 max |kernel path - plain path|: " + ", ".join(
            f"{name} {float((maps[name] - ref[name]).abs().max()):.3e}"
            for name in ("acc_fine", "depth_fine", "disp_fine")))

        reset_launches()
        fused_mlp_t.wgmma_launches = 0
        with quiet():
            bf16_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "bf16"), num_poses=1,
                                         precision="bfloat16", renderer="kernel", device=DEVICE)
        bf16_launches = (fused_mlp_t.launches, fused_mlp_t.wgmma_launches)
        print(f"[main] bf16 frame: {bf16_launches[0]} launches, {bf16_launches[1]} through "
              f"the wgmma body (expected {expected // NUM_POSES} each)")
        check(bf16_launches == (expected // NUM_POSES,) * 2, f"bf16 launches {bf16_launches}")
        db = psnr(bf16_run.first_maps["rgb_fine"], ref["rgb_fine"])
        print(f"[main] frame 0 bf16 kernel path vs f32 plain path: PSNR {db:.2f} dB "
              f"(floor {PSNR_FLOOR_DB})")
        check(db >= PSNR_FLOOR_DB, f"bf16 PSNR {db} < {PSNR_FLOOR_DB}")

    # Phase 5: times on this card. Plain and kernel alternate in turns.
    times = {}
    with torch.inference_mode():
        n, s = KERNEL_CHUNK
        pts, vd = orbit_points(n, s, dev, seed=1)
        parts = []
        for dtype in ("float32", "bfloat16"):
            p1 = cuda_ms(lambda: mlp_t_plain(model, pts, vd, dtype), 2)
            k1 = cuda_ms(lambda: fused_mlp_t(model, pts, vd, dtype), 3)
            k2 = cuda_ms(lambda: fused_mlp_t(model, pts, vd, dtype), 3)
            p2 = cuda_ms(lambda: mlp_t_plain(model, pts, vd, dtype), 2)
            times[dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            gflop = 2 * n * s * MACS_PER_POINT / 1e9
            parts.append(f"{dtype} kernel {k1:.2f} / {k2:.2f} ({gflop / times[dtype][0]:.1f} "
                         f"TFLOP/s), plain {p1:.2f} / {p2:.2f}")
        print(f"[time] fused_mlp_t ({n}, {s}), ms: {'; '.join(parts)} {on}")
        del pts, vd

        mc = seeded_model(SEED, opacify=True).to(dev)
        mf = seeded_model(SEED + 1, opacify=True).to(dev)
        poses, h, w, focal = resolve_render_poses(cfg)
        pose = torch.as_tensor(poses[1], device=dev)
        base = render_settings_from_config(cfg, "validation", hwf=(h, w, focal))
        renders = {}
        for label, use_kernel, dtype in (("plain f32", False, "float32"),
                                         ("kernel f32", True, "float32"),
                                         ("kernel bf16", True, "bfloat16")):
            settings = dataclasses.replace(base, use_pallas=use_kernel, compute_dtype=dtype)
            renders[label] = make_pose_render_fn(mc, mf, settings, h, w, focal)
            renders[label](pose)   # warm-up
        torch.cuda.reset_peak_memory_stats()
        order = ("plain f32", "kernel f32", "kernel bf16", "kernel bf16", "kernel f32",
                 "plain f32")
        frame = {label: [] for label in renders}
        for label in order:
            frame[label].append(frame_seconds(renders[label], pose))
        frame_s = {label: sum(secs) / len(secs) for label, secs in frame.items()}
        print(f"[time] {h}x{w} frame, {base.num_coarse}+{base.num_fine} samples, s/frame: "
              + "; ".join(f"{label} {' / '.join(f'{x:.4f}' for x in secs)} "
                          f"({h * w / frame_s[label]:,.0f} rays/s)"
                          for label, secs in frame.items()) + f" {on}")
        print(f"[time] peak device memory over those frames: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB {on}")

    # Phase 6: the training kernels vs plain, at the training path's shapes.
    with torch.no_grad():
        train_worst = check_training_kernels(model, dev)

    # Phase 7: the training main path, through the train entry point.
    cfg_train = synthetic_train_config(TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_main_path(cfg_train, tmp, dev)
        served_state = ntc_state(trained["checkpoint"])

    # Phase 8: times of the training kernels and of a training step.
    train_times = time_training(cfg_train, dev, on)

    # Phase 9: the Paper kernels vs plain.
    paper_worst = check_paper_kernels(dev)

    # Phases 10 and 11: the Paper main path, then its times.
    cfg_paper = paper_config(PAPER_TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        paper = paper_main_path(cfg_paper, tmp, dev)
        paper_times = time_paper(cfg_paper, paper["checkpoint"], dev, on)

    # Phase 12: the compositing, resampling and whole-stage kernels vs plain.
    stage_worst = check_render_stage_kernels(dev)

    # Phase 13: chains A and B on the flagship render path, then the times.
    chains = render_chains(cfg, dev, ("A", "B"))
    stage_times = time_render_stage(cfg, dev, on)

    # Phase 14: #2 and #3 vs plain, then chains C and D on the render path.
    flex_worst = check_flexible_kernels(model, dev)
    chains.update(render_chains(cfg, dev, ("C", "D")))

    # Phase 15: their times, and the chains' frames beside the renderer's:
    # C and D in f32, then B, C and D in bf16, where #7, #3 and #2 run on
    # the tensor cores.
    flex_times = time_flexible(model, dev, on)
    chain_frame_seconds(cfg, dev, ("C", "D"), on)
    bf16_frames = chain_frame_seconds(cfg, dev, ("B", "C", "D"), on, "bfloat16")

    # Phase 16: the render server on the card, from phase 7's checkpoint.
    served = serve_main_path(cfg, served_state, dev, on)
    print(f"[time] server median request latency {served['latency_s']:.4f} s and last_render_s "
          f"{served['last_render_s']} s against phase 5's bf16 kernel frame "
          f"{frame_s['kernel bf16']:.4f} s {on}")

    # Phase 17: the flagship protocol from a dataset on disk; phase 18:
    # geometry and pose refinement on its field and dataset.
    with tempfile.TemporaryDirectory() as tmp:
        disk = disk_main_path(dev, on, trained["rays_per_sec"], tmp)
        geo = geometry_main_path(dev, on, disk)
        # Phase 19: the multi-scene workflow on the same field and datasets.
        multi = multiscene_main_path(dev, on, disk, train_times["step", "plain", "float32"])
        # Phase 20: the multi-device layer, its ranks on this one card.
        md = multidevice_main_path(on, served_state, disk, geo, served["latency_s"])

    # Phase 21: Instant-NGP's hash-grid field and its encoding pair (#10).
    with tempfile.TemporaryDirectory() as tmp:
        hashed = hashgrid_main_path(dev, on, tmp)

    entries = []

    def entry(name, source, replaces, launches, worst, ms, flops, nbytes, nbytes_bf16=None,
              **extra):
        """One kernel's results; the bf16 fields are null for a kernel that
        has no bf16 variant (no "bfloat16" key in ``worst``). ``nbytes_bf16``:
        the bytes of the bf16 instance where they differ (bf16 residuals and
        weights)."""
        ms_bound, bound_by = bound(flops, nbytes)
        bf16 = "bfloat16" in worst
        bf16_bound = bound(flops, nbytes if nbytes_bf16 is None else nbytes_bf16, BF16_FLOPS)
        entries.append({
            "name": name, "route": "cuda", "source": f"nerf_tpu_torch/csrc/{source}",
            "replaces": f"nerf_tpu/ops/pallas/{replaces}" if replaces else None,
            "launches": launches,
            "max_abs_err": worst["float32"], "max_abs_err_bf16": worst.get("bfloat16"),
            "ms": ms["float32"][0], "plain_ms": ms["float32"][1],
            "bound_ms": ms_bound, "bound_by": bound_by, "library_ms": None,
            "bound_ms_bf16": bf16_bound[0] if bf16 else None,
            "bound_by_bf16": bf16_bound[1] if bf16 else None,
            "ms_bf16": ms["bfloat16"][0] if bf16 else None,
            "plain_ms_bf16": ms["bfloat16"][1] if bf16 else None, **extra,
        })

    # Bytes: each input read once and each output written once, f32
    # residuals; operations: 2 per multiply-add of this run's shapes.
    n, s = KERNEL_CHUNK
    p = n * s
    entry("fused_mlp_t", "mlp_t.cu", "mlp_t.py:164", launches, worst, times,
          2 * p * MACS_PER_POINT, 4 * (3 * p + 64 * n + 82820 + 4 * p),
          disk_launches=disk["render_launches"],
          tightened_launches=geo["render_launches_float32"],
          tightened_launches_bf16=geo["render_launches_bfloat16"],
          distill_launches=multi["distill_launches"],
          multidevice_launches=md["serve_launches"],
          eval_multiscene_launches=multi["eval_multiscene_launches_float32"],
          eval_multiscene_launches_bf16=multi["eval_multiscene_launches_bfloat16"])
    entry("fused_paper_mlp_t", "paper_t.cu", "paper_t.py:177", paper["render_launches"],
          {d: paper_worst["t", d] for d in ("float32", "bfloat16")},
          {d: paper_times["t", d] for d in ("float32", "bfloat16")},
          2 * p * PAPER_MACS_PER_POINT, 4 * (3 * p + 128 * n + 625416 + 4 * p),
          4 * (3 * p + 128 * n + 625416 + 4 * p) + 2 * 623232)
    n, s = TRAIN_SHAPE
    p = n * s
    # The bf16 instances keep bf16 residuals (768 rows a point) and read bf16
    # weights (82,240 forward, 76,800 backward values).
    for which, line in (("fwd", 197), ("bwd", 241)):
        entry(f"fused_flex_mlp_train_{which}", "flex_train.cu", f"train_vjp.py:{line}",
              trained["launches"][which],
              {d: train_worst[which, d] for d in ("float32", "bfloat16")},
              {d: train_times[which, d] for d in ("float32", "bfloat16")},
              2 * p * (MACS_PER_POINT if which == "fwd" else BWD_MACS_PER_POINT),
              4 * (3 * p + 64 * n + 82820 + 4 * p + 767 * p) if which == "fwd"
              else 4 * (4 * p + 767 * p + 74048 + 82820 + 64 * n),
              4 * (3 * p + 64 * n + 82820 + 4 * p) + 2 * (82240 + 768 * p) if which == "fwd"
              else 4 * (4 * p + 82820 + 64 * n) + 2 * (768 * p + 76800),
              disk_launches=disk["launches"][which],
              tightened_launches=geo["train_launches"][which],
              optimizer_launches=multi["optimizer_launches"][which],
              multiscene_launches=multi["kernel"]["launches"]["float32"][
                  f"fused_flex_mlp_train_{which}"],
              multiscene_launches_bf16=multi["kernel"]["launches"]["bfloat16"][
                  f"fused_flex_mlp_train_{which}"],
              multidevice_launches=md["train_launches"][which == "bwd"],
              nccl_launches=md["nccl_launches"][which == "bwd"])
    # The bf16 instances keep bf16 residuals (2,752 rows a point) and read
    # bf16 weights (623,232 forward, 595,968 backward values at F = 10).
    for which, line in (("fwd", 197), ("bwd", 241)):
        entry(f"fused_paper_mlp_train_{which}", "paper_train.cu", f"train_vjp.py:{line}",
              paper["launches"][which],
              {d: paper_worst[which, d] for d in ("float32", "bfloat16")},
              {d: paper_times[which, d] for d in ("float32", "bfloat16")},
              2 * p * (PAPER_MACS_PER_POINT if which == "fwd" else PAPER_BWD_MACS_PER_POINT),
              4 * (3 * p + 128 * n + 625416 + 4 * p + 2751 * p) if which == "fwd"
              else 4 * (4 * p + 2751 * p + 590464 + 625416 + 128 * n),
              4 * (3 * p + 128 * n + 625416 + 4 * p) + 2 * (623232 + 2752 * p) if which == "fwd"
              else 4 * (4 * p + 625416 + 128 * n) + 2 * (2752 * p + 595968),
              multiscene_launches=multi["kernel"]["paper_launches"]["float32"][
                  f"fused_paper_mlp_train_{which}"],
              multiscene_launches_bf16=multi["kernel"]["paper_launches"]["bfloat16"][
                  f"fused_paper_mlp_train_{which}"],
              **({"wgmma_launches": paper["launches"]["wgmma_bwd"]} if which == "bwd" else {}))
    # Phase 12-13's kernels, at the shapes they were timed at (#6: det, so u
    # is one row of S floats); launches from phase 13's chains.
    n, s = KERNEL_CHUNK
    p = n * s
    entry("fused_volume_render", "composite.cu", "composite.py:90",
          chains["A"]["fused_volume_render"], stage_worst["composite"],
          stage_times["composite"], COMPOSITE_OPS_PER_SAMPLE * p, 4 * (6 * p + 9 * n))
    m, s6 = 63, 64
    entry("fused_sample_pdf", "resample.cu", "resample.py:83",
          chains["A"]["fused_sample_pdf"] + chains["B"]["fused_sample_pdf"],
          {"float32": stage_worst["resample"]["err"]}, stage_times["resample"],
          n * (3 * (m - 1) + s6 * (2 * math.ceil(math.log2(m + 1)) + 8)),
          4 * (n * m + n * (m - 1) + s6 + n * s6),
          samples_over_tol=stage_worst["resample"]["over"],
          max_cdf_err=stage_worst["resample"]["cdf_err"],
          wrapper_event_ms=stage_times["resample events"])
    # The bf16 instances of #7 and #2 read bf16 weights (82,240 and 84,288
    # values) and the f32 biases (708 values).
    entry("fused_render_stage", "stage.cu", "stage.py:132", chains["B"]["fused_render_stage"],
          stage_worst["stage"], stage_times["stage"],
          2 * p * MACS_PER_POINT + COMPOSITE_OPS_PER_SAMPLE * p,
          4 * (5 * p + 73 * n + 82820), 4 * (5 * p + 73 * n + 708) + 2 * 82240,
          unfused_ms=stage_times["stage unfused", "float32"],
          unfused_ms_bf16=stage_times["stage unfused", "bfloat16"],
          bitwise_bf16_vs_composite_of_fused_mlp_t=stage_worst["stage bitwise"],
          chain_b_frame_s_bf16=bf16_frames["frame", "chain B"],
          renderer_frame_s_bf16=bf16_frames["frame", "renderer kernel path"])
    # Phase 14-15's kernels at KERNEL_CHUNK; launches from chains C and D. #2
    # reads a direction a point and holds the 27 direction rows of W_dir;
    # the bf16 instances read bf16 weights (84,288 and 82,240 values) and the
    # f32 biases (708 values).
    n, s = KERNEL_CHUNK
    p = n * s
    entry("fused_flexible_mlp", "mlp.cu", "mlp.py:322", chains["D"]["fused_flexible_mlp"],
          {d: flex_worst["points", d] for d in ("float32", "bfloat16")},
          {d: flex_times["points", d] for d in ("float32", "bfloat16")},
          2 * p * (MACS_PER_POINT + 27 * 64), 4 * (3 * p + 3 * p + 84548 + 4 * p),
          4 * (10 * p + 708) + 2 * 84288,
          chain_d_frame_s_bf16=bf16_frames["frame", "chain D"])
    entry("fused_flexible_mlp_rays", "mlp.cu", "mlp.py:257",
          chains["C"]["fused_flexible_mlp_rays"],
          {d: flex_worst["rays", d] for d in ("float32", "bfloat16")},
          {d: flex_times["rays", d] for d in ("float32", "bfloat16")},
          2 * p * MACS_PER_POINT, 4 * (3 * p + 64 * n + 82820 + 4 * p),
          4 * (3 * p + 64 * n + 708 + 4 * p) + 2 * 82240,
          max_abs_diff_vs_fused_mlp_t=max(flex_worst["rays vs #1", d]
                                          for d in ("float32", "bfloat16")),
          bitwise_vs_fused_mlp_t=flex_worst["bitwise"],
          fused_mlp_t_ms=flex_times["#1", "float32"],
          fused_mlp_t_ms_bf16=flex_times["#1", "bfloat16"],
          chain_c_frame_s_bf16=bf16_frames["frame", "chain C"])
    # #10 (no TPU kernel) at a step of ngp_train, the coarse and the fine
    # field's encodings: the points in and the features out (or their
    # gradient in) once, each field's table read once forward. The backward
    # adds only into the rows its points reach, in gradients zeroed by fills
    # that are not #10 (its ms includes them; gradient_zeroing_ms is theirs
    # alone); bytes bind both dtypes (the sums are f32 in both).
    p, rows = hashed["points"], hashed["rows"]
    for which in ("fwd", "bwd"):
        table_bytes = 2 * 8 * rows if which == "fwd" else 0
        extra = {"gradient_zeroing_ms": hashed["times"]["zero"],
                 "vector_red": hashed["vector_red"]} if which == "bwd" else {}
        entry(f"fused_hash_encode_{which}", "hashgrid.cu", None, hashed["launches"][which],
              hashed["worst"][which],
              {d: hashed["times"][which, d] for d in ("float32", "bfloat16")},
              HASH_OPS_PER_POINT * p, p * (12 + 4 * 32) + table_bytes,
              p * (12 + 2 * 32) + table_bytes, **extra)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was not launched on its main path")
    print(f"[device] {card}")   # again, near the end, where a reader of the tail finds it
    print(json.dumps({"kernels": [{k: float(f"{v:.6g}") if type(v) is float else v
                                    for k, v in e.items()} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
