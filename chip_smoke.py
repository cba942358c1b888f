#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Twenty paths, each at full size from fixed seeds:

* the flagship detector's eval forward plus post-processing (PointRCNN,
  configs/models/lyft_models/pointrcnn_dynamic_obj.yaml, 12288 points per
  scan, random weights);
* its training: the train CLI (cli/train.py) at full width and depth, B = 2
  scans of 12288 points with gt sampling and world augmentation, on 16
  synthetic Lyft-sized scans written to a temporary directory;
* its multi-process training: cli/train.py as two processes sharing the
  card (--launcher manual, gloo), a global batch of 4 (2 a process) on the
  same scans, then the evaluation merged by process 0; and SECOND
  (configs/models/lyft_models/second_dynamic_obj.yaml) the same way, each of
  its two processes started by scripts/torch_multihost_train.sh;
* the stacked (ragged) FPS of ops/pointnet2_stack.py on padded batches with
  a count per cloud, at the flagship's width and at 131072 points a cloud;
* the label-free seed path: the PP-score CLI (pre_compute_pp_score) over a
  synthetic multi-traversal dataset written to a temporary directory (5
  traversals of 8 frames and 16 origin frames of ~89.6k points, the
  bench_pipeline.py recipe), then the seed-mask CLI (generate_mask) on those
  scores in groups of 4 frames;
* one self-training round on that dataset's 16 origin scans, through the
  CLIs at the flagship's full width: the seed boxes as label files
  (generate_label_files), a round-0 dataset with its infos and gt
  database, one epoch of cli/train.py (its one-cycle at the rate the
  config's first epoch reaches), cli/test.py on the train split at
  B = 4 (the round-0 result.pkl), then cli/self_train.py for round 1
  (combine_labels, the round dataset, infos, one epoch, train-split
  inference) and once more, when it must skip the finished round; then one
  round with SECOND (configs/models/lyft_models/second_dynamic_obj.yaml)
  the same way;
* the grid detectors PointPillars and SECOND
  (configs/models/lyft_models/{pointpillar,second}_dynamic_obj.yaml) at
  full width: their eval forward plus post-processing at B = 4 on the
  training set's scans sampled to 65536 points, and cli/train.py for 16
  steps each with a resume;
* PV-RCNN (configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml) at full
  width on the grid detectors' scans: its eval forward plus post-processing
  at B = 4 (keypoint FPS of 2048 of 65536 points a scan), and cli/train.py
  for 16 steps at B = 2 with an evaluation after training, a resume and
  cli/test.py on its checkpoint;
* the two-stage voxel detectors SECOND-IoU, Voxel R-CNN and Part-A2
  (configs/models/lyft_models/{second_iou,voxel_rcnn,part_a2}_dynamic_obj.yaml)
  at full width on the same scans: their eval forward plus post-processing
  at B = 4, cli/train.py for 8 steps at each config's batch and
  cli/test.py on its checkpoint;
* KITTI's ten 3-class detector configs (configs/models/kitti_models:
  PointRCNN, PointRCNN-IoU, SECOND, PointPillars, SECOND multi-head, PV-RCNN,
  SECOND-IoU, Part-A2, the anchor-free Part-A2, Voxel R-CNN Car) at full
  width on synthetic scans of Cars, Pedestrians and Cyclists: their eval
  forward plus post-processing at B = 4, and cli/train.py for each at its
  config's batch (8 steps; 10 at PointRCNN-IoU's B = 3) and cli/test.py on
  its checkpoint;
* Waymo's three configs (configs/models/waymo_models/{pv_rcnn,second,PartA2}.yaml)
  at full width on a synthetic processed Waymo tree (tools/synth_infos.py,
  ~180,000 points a frame, no-label-zone points dropped, 131072 sampled),
  through build_dataloader: PV-RCNN's eval forward at the config's B = 2
  (keypoint FPS of 2048 of 131072 points a scan); SECOND's and Part-A2's
  eval forward at B = 2; and for each of the three cli/train.py for 4 steps
  at its config's batch (SECOND's 4, the others' 2) and cli/test.py under
  EVAL_METRIC kitti and waymo;
* the nuScenes CBGS grouped heads
  (configs/models/nuscenes_models/cbgs_{second,pp}_multihead.yaml) fed by
  the nuScenes loader (tools/synth_infos.py: 10 sweeps of ~34,000 points a
  keyframe, CBGS resampling, gt sampling, gt of width 10): eval forward plus
  multi-class NMS at B = 4, a train forward, cli/train.py for one epoch and
  cli/test.py with the SDK-free nuScenes evaluation;
* CaDDN (configs/models/kitti_models/CaDDN{,_deeplab}.yaml: the compact
  image encoder and the DeepLabV3 + ResNet-101 DDN) at full width (384 x
  1248 images, 80 depth bins, a 280 x 376 x 25 voxel grid, 3 classes) on
  synthetic KITTI scans with real-pixel images, through build_dataloader:
  its eval forward plus post-processing at the config's B = 4, and
  cli/train.py for 4 steps and cli/test.py;
* the demo CLI (cli/demo.py) on raw .bin scans with the flagship PointRCNN;
* the nuScenes-Boston PointRCNN
  (configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml, 6144
  points a scan): cli/train.py for 4 steps at B = 2 and cli/test.py;
* the dataset-preparation CLIs on a synthetic nuScenes-schema set of three
  drives (tools/nu_scenes.py, written to a temporary directory): the
  SDK-free Lyft export to KITTI, split_traintest, gather_historical_
  traversals and ransac_planes, then the PP-score CLI on 2 origins;
* the windowed kNN (nearest_k) at the flagship backbone's four kNN shapes,
  B = 4, through modest_tpu_torch/tools/knn_bench.py;
* the label-table gathers (take, take_along_axis) at the DBSCAN gather
  probe's sizes, through modest_tpu_torch/tools/gather_probe.py.

Phases, each printing one JSON line:

1. build the hand-written CUDA kernels from modest_tpu_torch/csrc, one nvcc
   per source, all at once;
2. hold FPS against its plain PyTorch version at every shape the forward
   and a train step give it, on tie-heavy and ragged clouds at SA1 size and
   at the small-cloud kernel's register edges (N = 1, 33, 513, 1023), at
   PV-RCNN's keypoint sampling (65536 → 2048 points at B = 4 and 2, also
   on duplicates and a 1 m grid) and at the edges of the cluster kernel's
   16-point range (N = 32768, 32769, 65535), in the 32-point range past
   65536 points (Waymo's PV-RCNN keypoints, 131072 → 2048 at B = 2; 98304
   at B = 4; N = 65537, 131071; duplicates at 131072) and at the
   nuScenes-Boston backbone's shapes (6144 → 4096 → 1024 → 256 → 64 at
   B = 2 and 4) and KITTI PointRCNN's SA1 (16384 → 4096 at B = 4 and 2);
   indices must be equal; with event and profiler times, the
   cluster size, the points a thread and the time per step; a cloud of
   N <= 65536 must launch as the table had it before the 32-point range;
   then the stacked FPS (stack_fps_vs_plain: ragged batches of counts
   12288 / 9000 / 4096 / 1 → 4096 points, 131072 → 2048 alone and beside
   70000, and 1000 / 513 / 0 → 256 on the small-cloud kernel; one launch a
   call, the indices equal to the plain masked FPS's and none at padding);
3. run the forward + post_process on 4 synthetic scans (the bench.py scene
   recipe) and check the output, the FPS launch count and the stage times;
4. compare the card's final boxes on one scan with the port's own CPU
   forward (>= 98% must match 1:1), and the forward stage by stage with
   the card's decisions handed to the CPU (forward_chain: point and RCNN
   logits and boxes within the matcher's limits plus 1e-4 of their
   magnitude, the proposal layer's RoIs and
   the final NMS's boxes 1:1 >= 98% on the card's inputs); the end-to-end
   match may fall below 98% only where a device's own top-k or NMS
   decision kept another box;
4a. training: write the training set and its infos and gt database
   (train_dataset); run the train CLI for 2 epochs (train: every step's
   losses finite, 3 + 3 FPS launches a step, scans/s after the first two
   steps, the step's stages by CUDA events, peak memory), then resume from
   the epoch-1 checkpoint to 3 epochs (train_resume: it restarts at the
   second epoch); 20 steps on one batch must lower the loss
   (train_overfit); one step's point-head losses and backbone and
   point-head gradients on the card must equal the CPU path's within the
   stated tolerances, and >= 98% of its sampled RoIs (train_card_vs_cpu);
   multi-process training (ddp_train: cli/train.py as 2 processes on the
   card at a global batch of 4 for 2 epochs at ROUND_LR, then
   --eval_after_train on the train scans: every step's losses finite, the
   processes' weights and buffers equal (bound 0), checkpoints written by
   process 0 alone, the merged result.pkl holding each frame once, 3 + 3
   FPS launches a step in each process; global scans/s after two steps,
   data wait, the gradient all-reduce's ms, collectives a step, peak
   memory per process); one step of the 2 processes against one process
   on the whole batch (ddp_step_vs_single: in float64 the losses within
   1e-5 relative, the gradient norm within 1e-4, each parameter's update
   within 1e-3 of its norm; in float32 the point head's losses within 1e-5
   and the rest printed; the processes equal; both FPS kernels equal to the
   plain FPS on each process's rows); the port's process group on NCCL at world size 1, one step
   through its collectives equal bit for bit to the step with no group
   (nccl_world1); after the grid detectors, SECOND as 2 processes, each
   started by scripts/torch_multihost_train.sh with a stub ``python`` first
   on its PATH that runs cli/train.py in this interpreter and records what
   it did (ddp_script: the script's command line, finite losses, gloo, the
   weights equal (bound 0), checkpoints by process 0 alone, each frame
   once in the merged result.pkl, no FPS);
4b. grid detectors, each of PointPillars and SECOND: the forward +
   post_process (grid_forward: scans/s over 8 batches after a warm-up,
   stage ms by CUDA events, peak memory, kept boxes, and SECOND's kept
   voxels, dropped points and active sites per sparse stage), card vs CPU
   with the same weights (grid_card_vs_cpu: one scan's detections 1:1
   >= 98%, the batch's voxel or pillar keys, coords and flags bit-equal,
   one train-mode forward's losses within 1e-3), and cli/train.py for the
   first 4 epochs of the config's schedule, 16 steps at B = 4 (grid_train:
   finite losses, scans/s after two steps, stage split, peak memory), then
   a resume from the epoch-3 checkpoint (grid_train_resume);
4c. PV-RCNN (pv_rcnn_forward: keypoints equal to the plain FPS's, then
   timed forwards: scans/s, stage ms by CUDA events, peak memory, one FPS
   launch a forward; pv_rcnn_card_vs_cpu: one scan's detections 1:1 >= 98%
   or stage by stage with the card's keypoints, ball-query indices and
   RoIs handed to the CPU; pv_rcnn_train: every loss finite, scans/s, stage
   split, the eval-after-train result, one FPS launch a step and a test
   batch; pv_rcnn_train_resume: restarts at epoch 1, then cli/test.py);
4d. the two-stage detectors, each of SECOND-IoU, Voxel R-CNN and Part-A2
   (two_stage_forward: scans/s over timed forwards at B = 4, stage ms by
   CUDA events, peak memory; two_stage_card_vs_cpu: one scan's detections
   1:1 >= 98% or stage by stage with the card's RoIs and voxel-query
   indices handed to the CPU; two_stage_train: 8 steps of cli/train.py,
   every loss finite, then cli/test.py on the training scans); no FPS
   launch (two_stage_kernels); then nuScenes-Boston's PointRCNN
   (nuscenes_boston: 4 train steps and cli/test.py from the shipped dict,
   3 + 3 FPS launches a step and a test batch, no PyYAML loaded);
4d'. KITTI's 3-class configs on 16 synthetic scans of Cars, Pedestrians and
   Cyclists (kitti_dataset, with the 3-class gt database): every model's
   timed eval forwards at B = 4 (kitti_forward: scans/s, stage ms, peak
   memory, the route, FPS launches 3 + 3 a PointRCNN forward and 1 a
   PV-RCNN one, none elsewhere), card vs CPU for the routes this slice
   added (SECOND's grouped head and second_multihead as grid_card_vs_cpu,
   PV-RCNN's as pv_rcnn_card_vs_cpu, PointRCNN and PartA2_free as
   kitti_card_vs_cpu: forward_chain with the card's RoI-aware cells handed
   to the CPU), and for every model cli/train.py at its batch for 8 steps
   (10 at PointRCNN-IoU's B = 3) and cli/test.py on its checkpoint
   (kitti_train: every loss finite, the FPS launches the steps and the test
   batches take, every scan once in the result);
4d''. Waymo (waymo_dataset: the tree, its gt database, both loaders' batch
   shapes, points (2, 131072, 5) and gt (2, M, 8)); PV-RCNN
   (waymo_pv_rcnn_forward: the warm-up's FPS launch at (2, 131072) → 2048
   holds the plain FPS's indices on its own input, then timed forwards
   with exactly one FPS launch each, stage ms, peak memory;
   waymo_voxel_cap: the share of occupied voxels the 16000-voxel cap keeps;
   waymo_pv_rcnn_card_vs_cpu as pv_rcnn_card_vs_cpu; waymo_pv_rcnn_train:
   4 steps of cli/train.py, one FPS launch a step, then cli/test.py under
   EVAL_METRIC kitti and waymo, each table's keys present, one launch a
   test batch); SECOND (grid_forward, grid_card_vs_cpu) and Part-A2
   (two_stage_forward, two_stage_card_vs_cpu) at B = 2, then each trained
   and tested as PV-RCNN (waymo_second_train, waymo_PartA2_train), no FPS
   (waymo_grid);
   then nuScenes (nuscenes_dataset: the tree of 10-sweep keyframes, its gt
   database, both loaders' batch shapes, gt of width 10 and finite) and per
   CBGS head (cbgs_forward: the timed forwards of the test batch with
   10 × 83 multi-class NMS slots a scan, one train forward's finite losses
   on a train batch with its 10-column targets; grid_card_vs_cpu; cbgs_train:
   one epoch of cli/train.py, every loss finite, then cli/test.py with mAP
   and NDS); no FPS launch;
4d'''. CaDDN on 8 synthetic full-density 3-class KITTI scans with real-pixel
   PNGs (caddn_dataset: PNG decode ms an image, a written array read back
   equal, the camera items' shapes, images (384, 1248, 3) and depth maps
   (96, 312), and their depth returns); per dict, the DeepLab DDN
   (ResNet-101) and the compact encoder, at full width and B = 4 from
   build_dataloader: timed eval forwards (caddn_forward: scans/s, stage ms
   by CUDA events from the DDN's backbone, ASPP and head through the
   channel reduce, frustum, lift and sample, BEV collapse, BEV backbone and
   head to the post NMS, peak memory), card vs CPU at B = 1 stage by stage
   (caddn_card_vs_cpu: depth probabilities, lifted cells, the sample and the
   BEV map on the card's inputs, the head as the grid chain's, final boxes
   1:1), cli/train.py for 4 steps at B = 4 and cli/test.py with the KITTI
   table (caddn_train: every loss finite, the depth loss among them, ms a
   step, data wait, peak memory); no FPS launch (caddn_kernels); then
   cli/demo.py on 4 raw .bin scans with the flagship PointRCNN dict and
   random weights (demo: 3 + 3 FPS launches a frame, the first frame's
   indices equal to the plain FPS's, a CaDDN dict refused);
4e. the preparation CLIs (prep: every file written for every frame, PP
   finite in [0, 1], one radius-count launch an origin, and no tqdm,
   PyYAML or PIL loaded on the way);
5. run the PP-score CLI on the card: origins/s, radius-count launches per
   origin, stage split, peak memory; the scores must be finite and rank the
   ephemeral clusters below the ground;
6. run the seed-mask CLI on the card: frames/s, DBSCAN launches, stage
   split, seed boxes (must be > 0);
7. hold the radius count against its plain version at the PP path's shape
   (0 mismatches) with its work-item size and count; the DBSCAN edge and
   propagation kernels against theirs on every group of 4 full-size frames
   of the seed phase, on a tie-chain graph of that size whose one-way tie
   edges matter, and on one with k = 33 and an odd row count (equal rows,
   tie bits, core flags, and labels on every timed call), with both stages'
   kernels (2 and 6 per call), host reads, fix-up rounds and times by CUDA
   events and, kernel by kernel, by torch.profiler; an index outside its
   frame must be reported;
8. card vs CPU on the seed path: the transformed, sorted PP inputs equal,
   PP counts equal on every 4th query tile, and one frame's seed labels
   (>= 99.9% up to the cluster-id permutation) and boxes (1:1, centre
   < 1 cm) equal;
8a. the self-training round (self_train): every stage's outputs, every
   result.pkl frame once, >= 1 fused label a frame on average, finite AP
   and recall, 3 + 3 FPS launches per train step and per test batch, the
   host library built; eval scans/s of cli/test.py at B = 4, the host
   seconds of the AP evaluation, combine_labels frames/s, each stage's
   wall time, peak memory; the second driver call skips the round. Card
   vs CPU (self_train_card_vs_cpu): one scan's detections from the
   round-0 checkpoint 1:1 (>= 98%) and its forward_chain, as in 4 (after
   8 steps the scores are all but tied, so the NMS keeps whichever box its
   device's rounding ranks first), and combine_labels' label text equal
   on every frame except where a box pair's BEV IoU lies within 1e-5 of
   the NMS threshold (such pairs are counted); then the round with SECOND
   (self_train_second: round 0 and cli/self_train.py's round 1 in a work
   dir of its own, every stage's outputs, every result.pkl frame once,
   finite losses in both trainings, >= 1 fused label a frame, no FPS);
9. run tools/knn_bench.py: per shape the certificate, the slot match
   against the dense exact path (>= 99.9% where certified), the dense
   fallbacks and the windowed and dense times; then hold the kNN kernels
   against their plain version on the same windows, at k = w/4 and on
   eightfold duplicate points (packed keys equal);
10. run tools/gather_probe.py (every probe's result checked); then time
   each gather kernel's launch floor (device time on one element) and hold
   both kernels against their plain versions (equal) at the probe's shapes
   and on every branch of take: uniform indices and a band wider than its
   shared window (the read-only path), idx at storage offset 1, sizes that
   are no multiple of 4; with the one PyTorch call for each timed beside
   them (CUDA events and torch.profiler device time); and check that an
   index outside the table is refused in either branch;
11. list the kernels with their launches on the main paths, errors and
   times. Each path's launch counts are set to 0 just before it and read
   just after.

Then the card's name and power limit (nvidia-smi) and, last, the result line.
Any failed check exits non-zero before the result line. Imports torch,
numpy and the repository's modest_tpu_torch package, nothing else.
"""
from __future__ import annotations

import json
import math
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4
N_POINTS = 12288
TIMED_ITERS = 11
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FPS work per point and step: 3 sub, 3 mul, 2 add, 1 min, 1 compare
FPS_OPS_PER_POINT_STEP = 10
# (stage, B, N, npoint) of every FPS call in one forward at B = 4
FPS_PATH_SHAPES = [
    ("backbone_sa1", BATCH, 12288, 4096),
    ("backbone_sa2", BATCH, 4096, 1024),
    ("backbone_sa3", BATCH, 1024, 256),
    ("backbone_sa4", BATCH, 256, 64),
    ("roi_sa1", BATCH * 100, 512, 128),
    ("roi_sa2", BATCH * 100, 128, 32),
]
FPS_EXTRA_SHAPES = [("ragged_n", BATCH, 1000, 100), ("npoint_1", BATCH, 12288, 1),
                    # ties and boundaries of the cluster kernel at SA1 size: duplicates
                    # in different cluster ranks, a 1 m grid, sizes no cluster splits evenly
                    ("dup_ranks", BATCH, 12288, 4096), ("grid_quantised", BATCH, 12288, 4096),
                    ("ragged_12000", BATCH, 12000, 4096), ("ragged_4000", BATCH, 4000, 1024),
                    # the small-cloud kernel's register templates: P = 1, 2, 32, 32 points
                    # a lane
                    ("small_1", BATCH, 1, 1), ("small_33", BATCH * 100, 33, 33),
                    ("small_513", BATCH * 100, 513, 128), ("small_1023", BATCH, 1023, 1023)]
# (stage, B, N, npoint) of every FPS call in one train step at B = 2: the RoI
# tower runs on the B·ROI_PER_IMAGE sampled RoIs
TRAIN_BATCH = 2
TRAIN_ROIS = TRAIN_BATCH * 128
FPS_TRAIN_SHAPES = [
    ("train_sa1", TRAIN_BATCH, 12288, 4096),
    ("train_sa2", TRAIN_BATCH, 4096, 1024),
    ("train_sa3", TRAIN_BATCH, 1024, 256),
    ("train_sa4", TRAIN_BATCH, 256, 64),
    ("train_roi_sa1", TRAIN_ROIS, 512, 128),
    ("train_roi_sa2", TRAIN_ROIS, 128, 32),
]
# the RoI tower of cli/self_train.py's train-split inference, which runs
# cli/test.py at the config's batch (= TRAIN_BATCH) with its test-time
# NMS_POST_MAXSIZE RoIs a scan; its backbone levels are the train rows'
ROUND_ROIS_PER_SCAN = 100
ROUND_ROIS = TRAIN_BATCH * ROUND_ROIS_PER_SCAN
FPS_ROUND_SHAPES = [
    ("round_roi_sa1", ROUND_ROIS, 512, 128),
    ("round_roi_sa2", ROUND_ROIS, 128, 32),
]
# PV-RCNN's keypoint FPS (NUM_KEYPOINTS of a scan's 65536 points) in one eval
# forward at B = 4 and one train step at B = 2; the cluster kernel's 16-point
# range past 32768 points at its edges, and on duplicates in different
# cluster ranks and a 1 m grid at full size
PV_POINTS, PV_KEYPOINTS = 65536, 2048
FPS_PV_SHAPES = [
    ("pv_keypoints", BATCH, PV_POINTS, PV_KEYPOINTS),
    ("train_pv_keypoints", TRAIN_BATCH, PV_POINTS, PV_KEYPOINTS),
    ("pv_dup_ranks", BATCH, PV_POINTS, PV_KEYPOINTS),
    ("pv_grid_quantised", BATCH, PV_POINTS, PV_KEYPOINTS),
    ("n_32768", BATCH, 32768, PV_KEYPOINTS), ("n_32769", BATCH, 32769, PV_KEYPOINTS),
    ("n_65535", BATCH, 65535, PV_KEYPOINTS),
]
# the cluster kernel's 32-point range (points in shared memory) past 65536
# points: Waymo's PV-RCNN keypoints (configs/models/waymo_models/pv_rcnn.yaml,
# 2048 of 131072 points) at its B = 2, a cloud of 98304 at B = 4, the range's
# edges N = 65537 and 131071, and duplicates in different cluster ranks
WIDE_POINTS = 131072
FPS_WIDE_SHAPES = [
    ("waymo_keypoints", TRAIN_BATCH, WIDE_POINTS, PV_KEYPOINTS),
    ("n_98304", BATCH, 98304, PV_KEYPOINTS),
    ("n_65537", TRAIN_BATCH, 65537, PV_KEYPOINTS),
    ("n_131071", TRAIN_BATCH, 131071, PV_KEYPOINTS),
    ("wide_dup_ranks", TRAIN_BATCH, WIDE_POINTS, PV_KEYPOINTS),
]
# nuScenes-Boston's PointRCNN (6144 points a scan): its backbone levels at the
# config's B = 2 and at B = 4; its RoI tower has the flagship's RoI shapes
NUSC_POINTS = 6144
FPS_NUSC_SHAPES = [
    (f"nusc{b}_sa{i + 1}", b, n, npoint) for b in (TRAIN_BATCH, BATCH)
    for i, (n, npoint) in enumerate(((NUSC_POINTS, 4096), (4096, 1024), (1024, 256),
                                     (256, 64)))
]
# KITTI's PointRCNN (16384 points a scan): its SA1 at B = 4 and at the config's
# B = 2; its other levels and its RoI tower have the flagship's shapes
KITTI_POINTS = 16384
FPS_KITTI_SHAPES = [("kitti_sa1", BATCH, KITTI_POINTS, 4096),
                    ("train_kitti_sa1", TRAIN_BATCH, KITTI_POINTS, 4096)]
FPS_SHAPES = (FPS_PATH_SHAPES + FPS_EXTRA_SHAPES + FPS_TRAIN_SHAPES + FPS_ROUND_SHAPES
              + FPS_PV_SHAPES + FPS_WIDE_SHAPES + FPS_NUSC_SHAPES + FPS_KITTI_SHAPES)
# the small-cloud kernel's stages of the path
# the stacked FPS (ops/pointnet2_stack.py::farthest_point_sample_stack): ragged
# batches of (stage, N_max, counts, npoint) at the flagship's width, at the
# largest FPS route (131072 points a cloud, alone and beside a shorter one) and
# at the small-cloud kernel's, with an empty cloud; the padding rows hold
# points far outside the clouds, which an unmasked FPS would take first
FPS_STACK_SHAPES = [("stack_flagship", N_POINTS, (12288, 9000, 4096, 1), 4096),
                    ("stack_wide", 131072, (131072,), 2048),
                    ("stack_wide_ragged", 131072, (131072, 70000), 2048),
                    ("stack_small", 1000, (1000, 513, 0), 256)]
FPS_SMALL_STAGES = ("backbone_sa4", "roi_sa1", "roi_sa2")
FPS_TRAIN_SMALL_STAGES = ("train_sa4", "train_roi_sa1", "train_roi_sa2")
# training: the flagship config file (shipped as a dict), a synthetic set of
# Lyft-sized scans, two epochs at B = 2, the overfit run's steps
FLAGSHIP_CFG = "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml"
TRAIN_SCANS, TRAIN_EPOCHS = 16, 2
OVERFIT_STEPS = 20
# card vs CPU on one train step: the point-head losses within rtol; at most
# this share of the backbone's ball-query slots and max-pool sources picked
# otherwise (PR 7 reading: 0 and 1.7e-6); the card's backbone and point-head
# gradients no further from a float64 run's than this many times the CPU's
# float32 gradients are (reading 0.49: both part from float64 by float32
# rounding, up to 9.2e-3 of a norm on the CPU); the RoI head's inputs hang
# on NMS, so its sampled RoIs are held to the eval's 98%
TRAIN_LOSS_RTOL = 1e-3
MAX_DIFFER_SHARE = 1e-4
TRAIN_GRAD_F64_RATIO = 2.0
MIN_ROI_MATCH = 0.98
KERNEL_SOURCES = ("fps", "radius_count", "dbscan", "knn", "gather", "iou3d")
# the rotated-IoU clip's work a pair (csrc/iou3d.cu's header): 4 edges x 16
# candidates x ~12 float operations; timed over this many calls
IOU_OPS_PER_PAIR = 4 * 16 * 12
IOU_ITERS, IOU_NMS_ITERS = 20, 3
# seed path: the PP dataset (bench_pipeline.py sizes) and the seed-mask groups
PP_TRAVERSALS, PP_FRAMES_PER_TRAVERSAL, PP_ORIGINS = 5, 8, 16
FRAME = {"n_ground": 60000, "n_objects": 12, "n_wall": 20000}  # tools/pipeline_scenes.synth_frame
SEED_GROUP = 4
PP_RADIUS = 0.3
# radius count work per pair test: 3 sub, 3 mul, 2 add, 1 compare, 1 add
RC_OPS_PER_PAIR = 10
CPU_TILE_STRIDE = 4  # the CPU side of the PP card-vs-CPU check counts every 4th query tile
# windowed kNN work per pair: 3 sub, 3 mul, 2 add, the key's and, or
KNN_OPS_PER_PAIR = 10
KNN_ITERS = 10     # timed calls per shape in tools/knn_bench.py
GATHER_ITERS = 10  # timed calls per probe in tools/gather_probe.py
SECTOR_BYTES = 32  # the smallest piece of device memory a read moves
GATHER_WIDE_BAND = 32768  # a band four times take_kernel's 8192-entry shared window
GATHER_FLOOR_REPS = 50  # profiled calls on one element for a gather kernel's launch floor
# the DBSCAN edge stage's and propagation's kernels, each launched once per call
EDGE_KERNELS = ("kth_kernel", "edge_kernel")
PROP_KERNELS = ("init_kernel", "compress_kernel", "union_kernel", "flatten_kernel",
                "fixup_kernel", "border_kernel")
# the edge kernel's tile edges at path size: k past one tie word, rows not a multiple of 4
ODD_GRAPH = {"frames": 3, "n": 49151, "k": 33}
MIN_SLOT_MATCH_PCT = 99.9
# self-training round: one epoch per training, cli/test.py at B = 4 on the
# train split, detections card vs CPU 1:1 at the forward's 98%; combine_labels
# card vs CPU may differ only where a box pair's BEV IoU is this close to the
# NMS threshold
ROUND_EPOCHS = 1
ROUND_EVAL_BATCH = 4
# the round with SECOND (phase self_train_second), from its shipped dict
ROUND_SECOND_CFG = "configs/models/lyft_models/second_dynamic_obj.yaml"
# round 0's cli/train.py runs its one-cycle at the highest rate the first of
# the config's 60 epochs reaches: at the config's 0.01 squeezed into 8 steps,
# half of the trainings on an H100 drove the point logits below -20 or to NaN
# (tools/train_probe.py det_gap --lr 0.01), the fault ROADMAP.md Queue 3
# records; round 1, through cli/self_train.py, keeps the config's rate
ROUND_LR = 1.04e-3
# after its 8 steps the round-0 detector scores its boxes below the config's
# SCORE_THRESH of 0.1 (PR 8 run 1: no detection on the first scan, no RCNN
# recall, no detection among the fused labels), so its
# train-split inference keeps every box the NMS keeps, which gives the fusion
# and the card-vs-CPU checks detections; round 1 keeps the config's threshold
ROUND0_SCORE_THRESH = 0.0
MIN_BOX_MATCH = 0.98
# match_1to1's limits: box centres, sizes (and match_finals' yaw), scores
MATCH_CENTER, MATCH_SIZE, MATCH_SCORE = 1e-2, 2e-3, 5e-4
# PointRCNN card vs CPU with the card's decisions handed to the CPU
# (forward_chain): a stage's logits and box parameters may part by
# MATCH_SCORE and MATCH_SIZE plus this share of their magnitude
FORWARD_RTOL = 1e-4
NMS_IOU_SHELL = 1e-5
# grid detectors: the two Lyft configs (shipped as dicts) at full width on the
# training set's scans sampled to 65536 points, B = 4; a GRID_EPOCHS-epoch
# schedule (16 steps) whose one-cycle peaks at GRID_LR, then a resume for the
# last epoch. GRID_LR is the highest rate the first 4 epochs of the config's
# 60-epoch schedule reach: at the config's 0.003 squeezed into 16 steps,
# SECOND's logits passed -88.72 at step 12 and the focal loss's gradient went
# NaN, the fault ROADMAP.md Queue 3 records for both packages. The random
# head scores an empty BEV cell (the same logit on thousands of anchors, whose
# order among ties is arbitrary on either device) at GRID_EMPTY_LOGIT, below
# SCORE_THRESH's logit (0.1 → -2.197)
GRID_CFGS = {"pointpillar": "configs/models/lyft_models/pointpillar_dynamic_obj.yaml",
             "second": "configs/models/lyft_models/second_dynamic_obj.yaml"}
GRID_BATCH = 4
GRID_EPOCHS = 4
GRID_LR = 4.8e-4
GRID_TIMED_ITERS = 8
GRID_EMPTY_LOGIT = -3.0
# PV-RCNN (configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml, shipped as a
# dict) on the grid phases' scans: PV_TIMED_ITERS timed eval forwards at B = 4;
# cli/train.py for PV_EPOCHS epochs (16 steps at the config's B = 2) whose
# one-cycle peaks at PV_LR, the highest rate the first 2 epochs of the
# config's 60-epoch schedule at 0.01 reach (its stage 1 has the grid heads'
# focal loss, whose gradient goes NaN once a logit passes -88.72 at a rate
# squeezed into 16 steps; ROADMAP.md Queue 3); the class head's empty-cell
# bias as for the grid detectors
PV_CFG = "configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml"
PV_TIMED_ITERS = 4
PV_EPOCHS = 2
PV_LR = 1.15e-3
# the two-stage voxel detectors on the grid phases' scans: TWO_STAGE_TIMED_ITERS
# timed eval forwards at B = 4 each; cli/train.py for 8 steps at the config's
# batch (SECOND-IoU 4: 2 epochs; Voxel R-CNN and Part-A2 2: 1 epoch), the
# one-cycle's peak lowered to the highest rate of the config's first 2 (of
# 60, at 0.003) or first 1 (of 60, at 0.01) epochs, as for the grid
# detectors (the focal-loss NaN, ROADMAP.md Queue 3); then cli/test.py on
# its checkpoint. None of them runs FPS.
TWO_STAGE_CFGS = {"second_iou": "configs/models/lyft_models/second_iou_dynamic_obj.yaml",
                  "voxel_rcnn": "configs/models/lyft_models/voxel_rcnn_dynamic_obj.yaml",
                  "part_a2": "configs/models/lyft_models/part_a2_dynamic_obj.yaml"}
TWO_STAGE_TIMED_ITERS = 3
TWO_STAGE_TRAIN = {"second_iou": (2, 3.46e-4), "voxel_rcnn": (1, 1.04e-3),
                   "part_a2": (1, 1.04e-3)}
# nuScenes-Boston's PointRCNN (6144 points a scan) on the first 8 training
# scans at the config's B = 2: cli/train.py for one epoch of 4 steps at
# ROUND_LR (the highest rate of the config's first epoch: 0.01 over 80
# epochs), then cli/test.py on its checkpoint, from the shipped dict
NUSC_CFG = "configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml"
NUSC_SCANS = 8
# KITTI's 3-class configs (configs/models/kitti_models, shipped as dicts) on
# KITTI_SCANS synthetic scans of Car, Pedestrian and Cyclist objects
# (tools/synth_kitti.py kitti_classes) at full width: per model
# KITTI_TIMED_ITERS timed eval forwards at B = 4 (16384 points a scan for
# PointRCNN, 65536 for the voxel models), and for every model cli/train.py for
# at least KITTI_TRAIN_STEPS steps at the config's batch (whole epochs of the
# KITTI_SCANS scans: 8 at B = 2 and 4, 10 at B = 3), its one-cycle peaking at
# the highest rate the config's first epochs of 80 reach (the focal-loss NaN,
# ROADMAP.md Queue 3), then cli/test.py on its checkpoint over the training
# scans. FPS launches a forward, a train step and a test batch, by model
KITTI_CFG = "configs/models/kitti_models/{}.yaml"
KITTI_SCANS = 16
KITTI_TIMED_ITERS = 5
KITTI_TRAIN_STEPS = 8
KITTI_MODELS = ("pointrcnn", "second", "second_multihead", "pv_rcnn", "PartA2_free",
                "pointpillar", "second_iou", "PartA2", "pointrcnn_iou", "voxel_rcnn_car")
KITTI_FPS = {"pointrcnn": (3, 3), "pointrcnn_iou": (3, 3), "pv_rcnn": (1, 0)}
# nuScenes CBGS heads (configs/models/nuscenes_models/cbgs_{second,pp}_multihead.yaml,
# shipped as dicts) fed by the nuScenes loader: a synthetic tree of
# CBGS_TRAIN_FRAMES train and CBGS_VAL_FRAMES val keyframes of 10 sweeps of
# ~34,000 points (tools/synth_infos.py), its gt database; the shipped configs
# whole (CBGS resampling, gt sampling, 65536 points a scan, gt of width 10) at
# their B = 4; cli/train.py for one epoch at the rate the config's first
# epoch reaches, then cli/test.py with the SDK-free nuScenes evaluation
CBGS_MODELS = ("cbgs_second_multihead", "cbgs_pp_multihead")
CBGS_CFG = "configs/models/nuscenes_models/{}.yaml"
CBGS_BATCH = 4
CBGS_TRAIN_FRAMES, CBGS_VAL_FRAMES = 4, 4
# Waymo (configs/models/waymo_models/{pv_rcnn,second,PartA2}.yaml, shipped as
# dicts) on a synthetic processed Waymo tree (tools/synth_infos.py: ~180,000
# points a frame, ~3 % of them in no-label zones, sampled to 131072 without
# replacement) read at the configs' SAMPLED_INTERVAL of 5: WAYMO_TRAIN_FRAMES
# give 8 train samples (4 steps at the config's B = 2), WAYMO_VAL_FRAMES one
# test batch. PV-RCNN: WAYMO_TIMED_ITERS timed forwards after a warm-up (one
# FPS launch each, (2, 131072) -> 2048), card vs CPU. SECOND and Part-A2:
# timed eval forwards at B = 2 and card vs CPU. Each of the three:
# cli/train.py at the config's batch (PV-RCNN and Part-A2 2, SECOND 4) for
# whole epochs of at least WAYMO_TRAIN_STEPS steps at the rate the config's
# first epochs reach (the focal-loss NaN, ROADMAP.md Queue 3), then
# cli/test.py under EVAL_METRIC kitti and waymo.
WAYMO_CFG = "configs/models/waymo_models/{}.yaml"
WAYMO_BATCH = 2
WAYMO_INTERVAL = 5
WAYMO_TRAIN_FRAMES, WAYMO_VAL_FRAMES = 8 * WAYMO_INTERVAL, 2 * WAYMO_INTERVAL
WAYMO_TIMED_ITERS = 5
WAYMO_TRAIN_STEPS = 4
WAYMO_FPS = {"pv_rcnn": 1}  # cluster-kernel launches a forward, by model
# the dataset-preparation CLIs on tools/nu_scenes.py's drives: 3 drives of 40
# sweeps 2 m apart (~27k points a sweep), the PP CLI on the card for 2 origins
PREP_DRIVES = {"traversals": 3, "frames": 40, "spacing": 2.0, "n_ground": 48000,
               "n_wall": 6000, "n_cars": 4, "car_points": 300}
PREP_PP_ORIGINS = 2
# CaDDN (configs/models/kitti_models/CaDDN{,_deeplab}.yaml, shipped as dicts) on
# CADDN_SCANS synthetic full-density 3-class KITTI scans with real-pixel
# images (tools/synth_kitti.py pixels: 400 x 1200 PNGs, padded and cropped to
# the config's 384 x 1248), at full width (80 LID bins, a 280 x 376 x 25 grid
# of 0.16 m voxels, 3 classes) and the configs' B = 4: CADDN_TIMED_ITERS timed
# eval forwards after a warm-up, card vs CPU at B = 1 stage by stage,
# CADDN_TRAIN_EPOCHS epochs of cli/train.py (4 steps) at the rate the
# config's first epochs reach, then cli/test.py. Card vs CPU limits: the depth
# probabilities within CADDN_PROB_ATOL; at most CADDN_CELL_SHARE of the voxels
# in view of either device lifted into another frustum cell (u0, v0, d0) or
# in/out of view; with the card's frustum and lift the CPU's sample, and with
# the card's sample its BEV map, within CADDN_SAMPLE_RTOL of their largest
# magnitude; the head as the grid chain's (grid_forward_chain's limits)
CADDN_STEMS = ("CaDDN_deeplab", "CaDDN")
CADDN_SCANS = 8
CADDN_BATCH = 4
CADDN_TIMED_ITERS = 4
CADDN_TRAIN_EPOCHS = 2
CADDN_PROB_ATOL = 1e-3
CADDN_CELL_SHARE = 1e-4
CADDN_SAMPLE_RTOL = 1e-5
# cli/demo.py: the flagship PointRCNN dict with random weights on DEMO_FRAMES
# raw .bin scans of the CaDDN tree, 3 + 3 FPS launches a frame
DEMO_FRAMES = 4
# multi-process training: DDP_WORLD processes of cli/train.py sharing the one
# card (gloo), the flagship at a global batch of DDP_BATCH on the train
# phase's scans for DDP_EPOCHS epochs at ROUND_LR, the merged evaluation on
# the same scans; each process is bounded by DDP_TIMEOUT_S
DDP_WORLD, DDP_BATCH, DDP_EPOCHS = 2, 4, 2
DDP_TIMEOUT_S = 600
# SECOND the same way, each process started by scripts/torch_multihost_train.sh
# (phase ddp_script): DDP_SCRIPT_EPOCHS epochs at the rate the config's first
# epochs reach
DDP_SCRIPT_CFG = "configs/models/lyft_models/second_dynamic_obj.yaml"
DDP_SCRIPT_EPOCHS = 2
# one step of DDP_WORLD processes against one process on the whole batch:
# losses within DDP_LOSS_RTOL, the gradient norm within DDP_GRAD_NORM_RTOL,
# each parameter's update within DDP_UPDATE_RTOL of its norm. The step is
# plain SGD, whose update is the clipped gradient: Adam's first update is
# about ±lr for every entry whatever its size, so a float32 rounding apart
# flips near-zero entries by 2·lr, which says nothing of the distributed step.
# The bounds hold the step in float64 (FPS on a float32 copy of the
# coordinates, as the kernel takes): in float32 the two summation orders'
# rounding moves near-ties of the RoI head's decisions (max-pool sources,
# whose backward then routes to another neighbour; sampled RoIs), so on the
# card its classification loss parts by ~1e-3 and its gradients by up to
# half a tensor's norm (on the CPU at 1/16 of the flagship's points the
# float32 gradients are 1.2% apart, float64's 2.8e-14). In float32 the
# point head's losses, upstream of those decisions, are held; the rest is
# printed
DDP_LOSS_RTOL, DDP_GRAD_NORM_RTOL, DDP_UPDATE_RTOL = 1e-5, 1e-4, 1e-3
STARTED = time.monotonic()  # the phase rows' t_s counts from here


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase's row also carries ``t_s``,
    the script's seconds when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - STARTED}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_device_ms(fn, reps: int, kernel):
    """Device time per call of the CUDA kernels whose name holds ``kernel``
    (a string, or a tuple of strings any of which may match; "" for every
    kernel ``fn`` starts) over ``reps`` calls of ``fn``, by
    torch.profiler: the kernel alone,
    without the host time between launches that ``device_ms`` sees when a
    call is shorter than its launch. None when the profiler records no
    device time for it (``device_ms`` stays the kernel's time then)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    total_us = 0.0
    for evt in prof.key_averages():
        if any(name in evt.key for name in names) and evt.device_type.name == "CUDA":
            dev_us = getattr(evt, "self_device_time_total", None)
            total_us += float(dev_us if dev_us is not None else evt.self_cuda_time_total)
    return total_us / 1e3 / reps if total_us > 0 else None


def kernel_launch_device_ms(fn, reps: int, kernel: str, tries: int = 3):
    """Device time per launch of the CUDA kernel whose name holds ``kernel``,
    which each call of ``fn`` launches once: the mean over the launches that
    torch.profiler recorded in ``reps`` calls, profiled again (at most
    ``tries`` windows) while a window recorded fewer than ``reps``. Late in a
    long run of profiled phases a window can lose device records, which
    ``kernel_device_ms``'s sum over ``reps`` calls would read as a shorter
    kernel. None when no window recorded one."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    per_launch = None
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if kernel in evt.key and evt.device_type.name == "CUDA"]
        count, total_us = 0, 0.0
        for evt in evts:
            dev_us = getattr(evt, "self_device_time_total", None)
            total_us += float(dev_us if dev_us is not None else evt.self_cuda_time_total)
            count += evt.count
        if count:
            per_launch = total_us / 1e3 / count
            if count >= reps:
                break
    return per_launch


def fps_bound(b: int, n: int, npoint: int):
    ops = b * max(npoint - 1, 0) * n * FPS_OPS_PER_POINT_STEP
    nbytes = b * n * 3 * 4 + b * npoint * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def legacy_launch(n: int):
    """(cluster, P) of ``csrc/fps.cu``'s launch table for N <= 65536, which
    the 32-point range past it must leave as it is: the cluster by N (none
    below 1024), then the fewest points a thread (1, 2, 4, 8) that keep a
    CTA at 128 threads or fewer, else 8 up to 32768 points and 16 past."""
    def ceil_div(a, b):
        return -(-a // b)

    if n < 1024:
        p = 1
        while p < ceil_div(n, 32):
            p *= 2
        return None, p
    c = 8 if n >= 8192 else 4 if n >= 2048 else 2
    chunk = ceil_div(n, c)
    for p in (1, 2, 4, 8):
        if ceil_div(ceil_div(chunk, p), 32) * 32 <= 128:
            return c, p
    return c, 8 if n <= 32768 else 16


def fps_inputs(torch, dev, scenes):
    """Inputs at the path's shapes: the backbone levels chain FPS on the
    bench scans; the RoI tower gets random clouds of RoI-sized extent; the
    keypoint rows take bench scans of 65536 points."""
    from modest_tpu_torch.ops.fps import furthest_point_sample_plain
    from modest_tpu_torch.tools.scenes import bench_scans

    gen = torch.Generator(device="cpu").manual_seed(1)
    xyz = torch.from_numpy(scenes[..., :3]).to(dev).contiguous()
    pv = torch.from_numpy(bench_scans(BATCH, PV_POINTS, seed=2)[..., :3]).to(dev).contiguous()
    wide = torch.from_numpy(bench_scans(BATCH, WIDE_POINTS, seed=3)[..., :3]).to(dev)
    nusc = {b: torch.from_numpy(bench_scans(b, NUSC_POINTS, seed=4)[..., :3]).to(dev)
            for b in (TRAIN_BATCH, BATCH)}
    kitti = torch.from_numpy(bench_scans(BATCH, KITTI_POINTS, seed=5)[..., :3]).to(dev)
    inputs = {}
    train_xyz = xyz[:TRAIN_BATCH]
    for stage, b, n, npoint in FPS_SHAPES:
        sa1 = inputs.get("backbone_sa1")
        if stage in ("waymo_keypoints", "n_98304", "n_65537", "n_131071"):
            inputs[stage] = wide[:b, :n].contiguous()
        elif stage == "wide_dup_ranks":
            inputs[stage] = torch.cat([wide[:b, :n // 2]] * 2, dim=1).contiguous()
        elif stage in ("kitti_sa1", "train_kitti_sa1"):
            inputs[stage] = kitti[:b].contiguous()
        elif stage.startswith("nusc"):  # the backbone levels chain FPS, as the flagship's
            inputs[stage] = nusc[b].contiguous()
            idx = furthest_point_sample_plain(inputs[stage], npoint).long()
            nusc[b] = torch.gather(nusc[b], 1, idx[..., None].expand(-1, -1, 3))
        elif stage in ("pv_keypoints", "train_pv_keypoints") or stage.startswith("n_"):
            inputs[stage] = pv[:b, :n].contiguous()
        elif stage == "pv_dup_ranks":
            inputs[stage] = torch.cat([pv[:, :n // 2], pv[:, :n // 2]], dim=1).contiguous()
        elif stage == "pv_grid_quantised":
            inputs[stage] = torch.round(pv)
        elif stage.startswith("backbone"):
            inputs[stage] = xyz
            idx = furthest_point_sample_plain(xyz, npoint).long()
            xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3)).contiguous()
        elif stage.startswith("train_sa"):  # the backbone levels of the first 2 scans
            inputs[stage] = train_xyz
            idx = furthest_point_sample_plain(train_xyz, npoint).long()
            train_xyz = torch.gather(train_xyz, 1, idx[..., None].expand(-1, -1, 3)).contiguous()
        elif stage == "npoint_1":
            inputs[stage] = sa1
        elif stage == "dup_ranks":  # point j + N/2 repeats point j
            inputs[stage] = torch.cat([sa1[:, :n // 2], sa1[:, :n // 2]], dim=1).contiguous()
        elif stage == "grid_quantised":
            inputs[stage] = torch.round(sa1)
        elif stage in ("ragged_12000", "ragged_4000"):
            inputs[stage] = sa1[:, :n].contiguous()
        else:
            cloud = (torch.rand(b, n, 3, generator=gen) - 0.5) * torch.tensor([4.0, 2.0, 1.6])
            inputs[stage] = cloud.to(dev).contiguous()
    return inputs


def phase_fps(torch, inputs, card):
    """Returns the rows by stage."""
    from modest_tpu_torch.ops.fps import (cluster_size, furthest_point_sample_cuda,
                                          furthest_point_sample_plain, per_thread)
    from modest_tpu_torch.utils.device import device_ms

    rows = {}
    for stage, b, n, npoint in FPS_SHAPES:
        x = inputs[stage]
        dev = x.device
        got = furthest_point_sample_cuda(x, npoint)
        want = furthest_point_sample_plain(x, npoint)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = device_ms(lambda: furthest_point_sample_cuda(x, npoint), dev, 10)
        kernel_ms = kernel_device_ms(lambda: furthest_point_sample_cuda(x, npoint), 10, "fps_")
        plain_ms = device_ms(lambda: furthest_point_sample_plain(x, npoint), dev, 1)
        bound_ms, bound_by = fps_bound(b, n, npoint)
        launch = (cluster_size(n) or None, per_thread(n))
        row = {"phase": "fps_vs_plain", "stage": stage, "B": b, "N": n, "npoint": npoint,
               "cluster": launch[0], "per_thread": launch[1], "mismatches": mismatches,
               "max_abs_err": max_abs_err, "ms": ms,
               "kernel_device_ms": kernel_ms, "us_per_step": ms * 1e3 / max(npoint - 1, 1),
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "card": card}
        emit(row)
        if mismatches:
            fail(f"fps kernel disagrees with its plain version at {stage}: {mismatches} indices")
        if n <= PV_POINTS and launch != legacy_launch(n):
            fail(f"fps at N = {n} launches (cluster, P) = {launch}, not {legacy_launch(n)}")
        rows[stage] = row
    return rows


def stack_fps_bound(counts, npoint: int):
    """The stacked FPS's bound from the work these counts need: each valid
    point once a step, each valid coordinate read once, the indices
    written once."""
    ops = sum(counts) * max(npoint - 1, 0) * FPS_OPS_PER_POINT_STEP
    nbytes = sum(counts) * 3 * 4 + len(counts) * npoint * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_stack_fps(torch, dev, card):
    """stack_fps_vs_plain: ``farthest_point_sample_stack`` on the card at
    FPS_STACK_SHAPES, its launches counted from 0 over one call (the stacked
    route: one launch for the batch), then held against its plain masked
    version on the same inputs (indices equal, none at a padding row) and
    timed. The clouds are bench scans (the small ones their first points: car
    clusters) cut to their counts. Returns the rows by stage."""
    from modest_tpu_torch.ops.fps import cluster_size, per_thread
    from modest_tpu_torch.ops.pointnet2_stack import (farthest_point_sample_stack,
                                                      farthest_point_sample_stack_plain)
    from modest_tpu_torch.tools.scenes import bench_scans
    from modest_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cpu").manual_seed(6)
    rows = {}
    for stage, n, counts, npoint in FPS_STACK_SHAPES:
        b = len(counts)
        xyz = torch.from_numpy(bench_scans(b, max(n, 3000), seed=7)[:, :n, :3].copy())
        pad = torch.arange(n)[None, :] >= torch.tensor(counts)[:, None]
        far = (torch.rand(b, n, 3, generator=gen) - 0.5) * 1000.0
        xyz = torch.where(pad[..., None], far, xyz).to(dev).contiguous()
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        counts_now = reset_fps_counts()
        got = farthest_point_sample_stack(xyz, cnt, npoint)
        torch.cuda.synchronize()
        launches = dict(counts_now)
        want = farthest_point_sample_stack_plain(xyz, cnt, npoint)
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        at_padding = int((got.long() >= cnt.clamp_min(1).long()[:, None]).sum())
        ms = device_ms(lambda: farthest_point_sample_stack(xyz, cnt, npoint), dev, 10)
        kernel_ms = kernel_device_ms(lambda: farthest_point_sample_stack(xyz, cnt, npoint), 10,
                                     "fps_")
        plain_ms = device_ms(lambda: farthest_point_sample_stack_plain(xyz, cnt, npoint), dev, 1)
        bound_ms, bound_by = stack_fps_bound(counts, npoint)
        kernel = "fps_cluster_kernel" if cluster_size(n) else "fps_warp_kernel"
        row = {"phase": "stack_fps_vs_plain", "stage": stage, "B": b, "N": n,
               "counts": list(counts), "npoint": npoint, "kernel": kernel,
               "cluster": cluster_size(n) or None, "per_thread": per_thread(n),
               "fps_kernel_launches": launches, "mismatches": mismatches,
               "max_abs_err": max_abs_err, "indices_at_padding": at_padding, "ms": ms,
               "kernel_device_ms": kernel_ms, "us_per_step": ms * 1e3 / max(npoint - 1, 1),
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "card": card}
        emit(row)
        if mismatches or at_padding:
            fail(f"stacked fps at {stage}: {mismatches} indices differ from the plain masked "
                 f"version, {at_padding} at padding rows")
        if launches != {"fps_cluster_kernel": 0, "fps_warp_kernel": 0, kernel: 1}:
            fail(f"stacked fps at {stage}: one call launched {launches}, not one {kernel}")
        rows[stage] = row
    return rows


def randomise_bn(torch, model, seed: int) -> None:
    """Batch-norm running statistics away from the identity (mean U(±0.3),
    var U(0.5, 1.5)), from a seeded generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.running_mean.copy_((torch.rand(c, generator=gen) - 0.5) * 0.6)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


def run_path(api, model, cfg, points, on_stage=None):
    out = api.apply_eval(model, cfg, points, on_stage=on_stage)
    return api.post_process(out, cfg)


def check_final(torch, final, b: int, where: str) -> int:
    for key in ("boxes", "scores"):
        if not bool(torch.isfinite(final[key]).all()):
            fail(f"{where}: non-finite {key}")
    if final["boxes"].shape[:2] != final["valid"].shape or final["boxes"].shape[0] != b:
        fail(f"{where}: unexpected output shapes {tuple(final['boxes'].shape)}")
    count = int(final["valid"].sum())
    if count == 0:
        fail(f"{where}: no detections")
    return count


def timed_forwards(torch, api, model, cfg, points, iters, where):
    """``iters`` timed eval forwards + post-processing after one warm-up:
    scans/s, stage ms by CUDA events, peak memory, kept boxes; every run's
    boxes finite. Returns (row, the last final boxes)."""
    from modest_tpu_torch.models.pointrcnn import STAGES

    first = points if torch.is_tensor(points) else points["images"]  # CaDDN: camera inputs
    b, dev = first.shape[0], first.device
    size = ({"points_per_scan": int(points.shape[1])} if torch.is_tensor(points)
            else {"image_shape": list(first.shape[1:3])})
    detections = check_final(torch, run_path(api, model, cfg, points), b, f"{where} forward")
    events = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    stage_ms = {stage: 0.0 for stage in (*getattr(model, "stages", STAGES), "post_nms")}
    forward_ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        t_it = time.perf_counter()
        events.clear()
        mark("start")
        final = run_path(api, model, cfg, points, on_stage=mark)
        mark("post_nms")
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t_it) * 1e3)
        for (_, a), (stage, b_ev) in zip(events, events[1:]):
            stage_ms[stage] += a.elapsed_time(b_ev) / iters
    wall = time.perf_counter() - t0
    forward_ms.sort()
    check_final(torch, final, b, f"{where} timed forward")
    return {"batch": b, **size, "detections": detections,
            "kept_per_scan": final["valid"].sum(1).tolist(),
            "labels_kept": sorted({int(v) for v in final["labels"][final["valid"]].tolist()}),
            "stage_ms": stage_ms, "forward_ms_median": forward_ms[len(forward_ms) // 2],
            "forward_ms_max": forward_ms[-1], "timed_forwards": iters,
            "scans_per_s": b * iters / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, final


def phase_forward(torch, dev, api, model, cfg, scenes, card):
    from modest_tpu_torch.models.pointrcnn import STAGES
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda
    from modest_tpu_torch.ops.iou3d import boxes_overlap_bev_cuda

    points = torch.from_numpy(scenes).to(dev)
    counts = furthest_point_sample_cuda.launches  # per kernel
    counts.update(dict.fromkeys(counts, 0))
    iou_before = boxes_overlap_bev_cuda.launches
    final = run_path(api, model, cfg, points)
    torch.cuda.synchronize()
    kernel_launches = dict(counts)
    iou_launches = boxes_overlap_bev_cuda.launches - iou_before
    if iou_launches == 0:
        fail("one forward's NMS stages never launched the rotated-IoU kernel")
    launches = sum(kernel_launches.values())
    # SA1-3 (N >= 1024) take the cluster kernel; SA4 and the RoI tower the warp kernel
    if kernel_launches != {"fps_cluster_kernel": 3, "fps_warp_kernel": 3}:
        fail(f"one forward launched the fps kernels {kernel_launches} times, not 3 and 3")
    detections = check_final(torch, final, BATCH, "forward on the card")

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    stage_ms = {name: 0.0 for name in (*STAGES, "post_nms")}
    forward_ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        t_it = time.perf_counter()
        events.clear()
        mark("start")
        final = run_path(api, model, cfg, points, on_stage=mark)
        mark("post_nms")
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t_it) * 1e3)
        for (_, a), (name, b) in zip(events, events[1:]):
            stage_ms[name] += a.elapsed_time(b) / TIMED_ITERS
    wall = time.perf_counter() - t0
    forward_ms.sort()
    if sum(counts.values()) != 6 * TIMED_ITERS:
        fail(f"{TIMED_ITERS} forwards launched the fps kernels {counts} times")
    check_final(torch, final, BATCH, "timed forward on the card")
    emit({"phase": "forward", "batch": BATCH, "points_per_scan": N_POINTS,
          "fps_launches_per_forward": launches, "fps_kernel_launches": kernel_launches,
          "iou_launches_per_forward": iou_launches, "detections": detections,
          "stage_ms": stage_ms, "forward_ms_median": forward_ms[len(forward_ms) // 2],
          "forward_ms_max": forward_ms[-1], "timed_forwards": TIMED_ITERS,
          "scans_per_s": BATCH * TIMED_ITERS / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": card})
    return kernel_launches, iou_launches


def match_1to1(np, boxes, scores, rb, rs):
    """Greedy 1:1 match of tests/test_reference_parity_model.py: center
    < 1 cm, sizes < 2e-3, score < 5e-4."""
    used = np.zeros(len(boxes), bool)
    pairs = []
    for j in range(len(rb)):
        d = np.linalg.norm(boxes[:, :3] - rb[j, :3], axis=1)
        ds = np.abs(boxes[:, 3:6] - rb[j, 3:6]).max(axis=1)
        cand = np.flatnonzero((d < MATCH_CENTER) & (ds < MATCH_SIZE)
                              & (np.abs(scores - rs[j]) < MATCH_SCORE) & ~used)
        if len(cand):
            used[cand[0]] = True
            pairs.append((int(cand[0]), j))
    return pairs


def phase_card_vs_cpu(torch, np, api, build_network, model, cfg, scenes, card):
    cpu_model = build_network(cfg, model.num_class, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    chain, got, want = forward_chain(torch, np, model, cpu_model, cfg,
                                     torch.from_numpy(scenes[:1]))
    cpu_s = time.perf_counter() - t0
    match = match_finals(np, got, want)
    emit({"phase": "card_vs_cpu", "points": N_POINTS, **match, **chain,
          "chain_s": cpu_s, "card": card})
    check_chain(chain, match["match_frac"], match["card_detections"] + match["cpu_detections"],
                "card vs CPU")


def match_finals(np, got, want) -> dict:
    """Scan 0's final boxes of two post_process outputs, matched 1:1 with
    ``match_1to1``; a pair whose yaw differs by 2e-3 or more, or whose label
    differs, does not count."""
    def valid(final):
        v = final["valid"][0].cpu().numpy()
        return (final["boxes"][0].cpu().numpy()[v], final["scores"][0].cpu().numpy()[v],
                final["labels"][0].cpu().numpy()[v])

    gb, gs, gl = valid(got)
    wb, ws, wl = valid(want)
    pairs = match_1to1(np, gb, gs, wb, ws)
    bad = 0
    for a, j in pairs:
        dyaw = abs(float(gb[a, 6]) - float(wb[j, 6])) % (2 * np.pi)
        bad += int(min(dyaw, 2 * np.pi - dyaw) >= MATCH_SIZE or gl[a] != wl[j])
    total = max(len(gb), len(wb))
    return {"card_detections": len(gb), "cpu_detections": len(wb), "matched": len(pairs) - bad,
            "match_frac": (len(pairs) - bad) / max(total, 1)}


def match_rois(np, got, want) -> float:
    """1:1 share (``match_1to1``) of two forwards' valid RoIs of scan 0."""
    def valid(out):
        v = out["roi_valid"][0].cpu()
        return out["rois"][0].cpu()[v].numpy(), out["roi_scores"][0].cpu()[v].numpy()

    gb, gs = valid(got)
    wb, ws = valid(want)
    return len(match_1to1(np, gb, gs, wb, ws)) / max(len(gb), len(wb), 1)


def forward_chain(torch, np, card_model, cpu_model, model_cfg, scan, module=None, choices=()):
    """PointRCNN's eval forward on ``scan`` (1, N, C) on the card and on the
    CPU, and stage by stage with the card's decisions handed to the CPU:
    the point logits and decoded boxes (``point_tol_used``: the largest
    |card - CPU| over its limit, MATCH_SCORE or MATCH_SIZE + FORWARD_RTOL *
    |CPU|); the CPU's proposal layer on the card's point outputs against the
    card's RoIs (``proposals_given_card_points``, 1:1); the CPU's RoI pooling
    and head on the card's RoIs against the card's RCNN logits and boxes
    (``rcnn_tol_used``); the CPU's post-processing of the card's RCNN outputs
    against the card's final boxes (``finals_given_card_rcnn``, 1:1). So
    each decision (the top-k cut, both NMS) meets the same inputs on both
    devices. Left to decide on its own values, each device may keep another
    box where a decision's alternatives lie closer than the two devices'
    rounding: after a few training steps the scores are all but tied.
    ``proposals_card_vs_cpu`` and ``finals_given_card_rois`` say whether
    that happened. ``choices`` lists (module, name) of functions whose
    discrete choices the CPU is handed the card's of in that run, the point
    stage included (``decisions_differ`` counts the CPU's own that
    differed): KITTI's PointRCNN hands over its ball queries
    (``ops/pointnet2.py::ball_query_from_dist2``: membership at d² ≈ r²
    follows each device's rounding of the matmul distances), the
    anchor-free Part-A2 its RoI-aware cells, and takes ``module`` its own
    (where its ``proposal_layer`` is looked up). Returns (row, card's final
    boxes, CPU's), on the CPU."""
    import contextlib
    from unittest import mock

    from modest_tpu_torch.models import api, pointrcnn
    from modest_tpu_torch.models.roi_head import proposal_layer

    def used(got, want, keys):
        return max(float(((got[k] - want[k]).abs() / (atol + FORWARD_RTOL * want[k].abs())).max())
                   for k, atol in zip(keys, (MATCH_SCORE, MATCH_SIZE)))

    def patched(wrap):
        stack = contextlib.ExitStack()
        for owner, name in choices:
            stack.enter_context(mock.patch.object(owner, name, wrap(getattr(owner, name))))
        return stack

    card_choices, replay, differ = [], None, [0]

    def recording(real):
        def record(*args):
            result = real(*args)
            card_choices.append(tuple(t.cpu() for t in result))
            return result
        return record

    def replaying(real):
        def choose(*args):
            theirs = next(replay)
            differ[0] += _decisions_differ(real(*args), theirs)
            return theirs
        return choose

    dev = next(card_model.parameters()).device
    with patched(recording):
        out = api.apply_eval(card_model, model_cfg, scan.to(dev))
    got = {k: v.cpu() for k, v in api.post_process(out, model_cfg).items() if v is not None}
    card = {k: v.cpu() for k, v in out.items()}
    cpu = api.apply_eval(cpu_model, model_cfg, scan)
    want = api.post_process(cpu, model_cfg)
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TEST
    rois, roi_scores, _, roi_valid = proposal_layer(
        card["point_boxes_decoded"], card["point_cls_preds"], nms_pre=int(nms.NMS_PRE_MAXSIZE),
        nms_post=int(nms.NMS_POST_MAXSIZE), nms_thresh=float(nms.NMS_THRESH))
    forced = tuple(card[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid"))
    replay = iter(card_choices)
    with mock.patch.object(module or pointrcnn, "proposal_layer", lambda *a, **k: forced), \
            patched(replaying):
        given = api.apply_eval(cpu_model, model_cfg, scan)
    row = {
        "point_tol_used": used(card, given, ("point_cls_preds", "point_boxes_decoded")),
        "proposals_given_card_points": match_rois(
            np, card, {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid}),
        "rcnn_tol_used": used(card, given, ("batch_cls_preds", "batch_box_preds")),
        "finals_given_card_rcnn": match_finals(np, got, api.post_process(card, model_cfg))[
            "match_frac"],
        "proposals_card_vs_cpu": match_rois(np, card, cpu),
        "finals_given_card_rois": match_finals(np, got, api.post_process(given, model_cfg))[
            "match_frac"],
        **({"choices": len(card_choices), "decisions_differ": differ[0]} if choices else {})}
    return row, got, want


def check_chain(chain, match_frac, detections, where, parted=False,
                stage1=("point_tol_used", "proposals_given_card_points")):
    """Fails unless every stage of ``forward_chain`` agrees and the
    end-to-end detections match 1:1 (>= MIN_BOX_MATCH), or part only where
    a device's own decision kept another RoI or another final box
    (``parted`` adds another such decision the caller saw). ``stage1`` names
    the keys of the chain's first stage (``pv_forward_chain``'s differ)."""
    if detections == 0:
        fail(f"{where}: no detection on either device")
    bad = {k: chain[k] for k in (stage1[0], "rcnn_tol_used") if not chain[k] <= 1.0}
    bad.update({k: chain[k] for k in (stage1[1], "finals_given_card_rcnn")
                if chain[k] < MIN_BOX_MATCH})
    if bad:
        fail(f"{where}: with the card's decisions the CPU parts from the card: {bad} "
             f"(limits 1 and {MIN_BOX_MATCH})")
    parted = (parted or chain["proposals_card_vs_cpu"] < 1.0
              or chain["finals_given_card_rois"] < 1.0)
    if match_frac < MIN_BOX_MATCH and not parted:
        fail(f"{where}: {match_frac:.4f} of the final boxes match 1:1 (< {MIN_BOX_MATCH}), yet "
             "each device's decisions kept the same RoIs and final boxes")


def reset_fps_counts():
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda

    counts = furthest_point_sample_cuda.launches
    counts.update(dict.fromkeys(counts, 0))
    return counts


def phase_train_dataset(root, card):
    """A KITTI-format training set of Lyft-sized scans (tools/synth_kitti.py),
    its infos and the gt database that gt sampling reads."""
    import numpy as np

    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
    from modest_tpu_torch.tools.synth_kitti import make_dataset
    from modest_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    boxes = make_dataset(root, n_train=TRAIN_SCANS, n_val=0, seed=0, full_density=True)
    cfg = Config(POINTRCNN_DYNAMIC_OBJ_FULL).DATA_CONFIG
    create_kitti_infos(cfg, ["Dynamic"], root, root, if_val=False)
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    points = [len(np.fromfile(p, np.float32)) // 4
              for p in sorted((root / "training" / "velodyne").iterdir())]
    emit({"phase": "train_dataset", "scans": TRAIN_SCANS, "points_min": min(points),
          "points_max": max(points), "labels_min": min(len(b) for b in boxes.values()),
          "labels_max": max(len(b) for b in boxes.values()),
          "gt_database_objects": sum(len(v) for v in db.values()),
          "seconds": time.perf_counter() - t0, "card": card})


def train_argv(root, out, epochs):
    return ["--cfg_file", str(REPO / FLAGSHIP_CFG), "--data_path", str(root), "--batch_size",
            str(TRAIN_BATCH), "--epochs", str(epochs), "--fix_random_seed", "--output_dir",
            str(out)]


def check_history(np, history, where):
    for rec in history:
        bad = {k: v for k, v in rec["metrics"].items() if not np.isfinite(v)}
        if bad:
            fail(f"{where}: step {rec['step']} has non-finite {bad}")


def phase_train(torch, np, dev, root, card):
    """The train CLI on the card at full width: 2 epochs of 8 steps, then a
    resume from the epoch-1 checkpoint to 3 epochs."""
    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.models.pointrcnn import STAGES

    out = root / "run"
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(train_argv(root, out, TRAIN_EPOCHS), stage_times=True)
    seconds = time.perf_counter() - t0
    launches = dict(counts)
    hist = state.history
    steps = len(hist)
    if steps != TRAIN_SCANS // TRAIN_BATCH * TRAIN_EPOCHS:
        fail(f"train: {steps} steps")
    check_history(np, hist, "train")
    if launches != {"fps_cluster_kernel": 3 * steps, "fps_warp_kernel": 3 * steps}:
        fail(f"train: {steps} steps launched the fps kernels {launches} times, not 3 + 3 a step")
    timed = hist[2:]
    scans_per_s = TRAIN_BATCH * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"])
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    forward_ms = sum(stage_ms[k] for k in STAGES)
    emit({"phase": "train", "batch": TRAIN_BATCH, "points_per_scan": N_POINTS, "steps": steps,
          "epochs": TRAIN_EPOCHS, "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": scans_per_s, "timed_steps": len(timed),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "forward_ms": forward_ms, "stage_ms": stage_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "fps_kernel_launches": launches, "fps_launches_per_step": sum(launches.values()) / steps,
          "cli_seconds": seconds, "card": card})

    # resume: a fresh output dir holding only the epoch-1 checkpoint
    resumed_out = root / "resumed"
    (resumed_out / "ckpt").mkdir(parents=True)
    shutil.copy(out / "ckpt" / "checkpoint_epoch_1.pth", resumed_out / "ckpt")
    counts = reset_fps_counts()
    resumed = train_cli.main(train_argv(root, resumed_out, TRAIN_EPOCHS + 1))
    per_epoch = TRAIN_SCANS // TRAIN_BATCH
    first = resumed.history[0]
    check_history(np, resumed.history, "resumed train")
    emit({"phase": "train_resume", "start_epoch": resumed.start_epoch, "first_epoch": first["epoch"],
          "first_step": first["step"], "steps": len(resumed.history),
          "fps_kernel_launches": dict(counts), "card": card})
    if (resumed.start_epoch, first["epoch"], first["step"], len(resumed.history)) != (
            1, 1, per_epoch, 2 * per_epoch):
        fail(f"resume from epoch 1 restarted at epoch {first['epoch']}, step {first['step']}")
    return launches, steps


def first_batch(torch, root, dev):
    """The train loader's first batch of the synthetic set, on ``dev``."""
    import numpy as np

    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.data.loader import batch_to_device, build_dataloader
    from modest_tpu_torch.utils.config import Config

    cfg = Config(POINTRCNN_DYNAMIC_OBJ_FULL)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    np.random.seed(666)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, TRAIN_BATCH, training=True)
    return cfg, batch_to_device(next(iter(loader)), dev)


def phase_train_overfit(torch, np, dev, root, card):
    """OVERFIT_STEPS optimizer steps on one fixed batch and fixed RoI-sampler
    draws: the loss must fall. The schedule is the flagship's whole run on
    this set (NUM_EPOCHS epochs of TRAIN_SCANS / TRAIN_BATCH steps), so the
    steps are its warm-up. The one-cycle rate squeezed into 20 steps peaks
    by step 8, where the point logits pass -88.7 and the focal loss's
    exp(-x) overflows: its gradient is NaN there, in the JAX package as in
    the port (tools/train_probe.py diverge, tests/test_torch_losses.py)."""
    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.train.state import create_train_state, step_roi_draws, train_step

    cfg, batch = first_batch(torch, root, dev)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=1)
    total = int(cfg.OPTIMIZATION.NUM_EPOCHS) * (TRAIN_SCANS // TRAIN_BATCH)
    state = create_train_state(model, cfg.OPTIMIZATION, total)
    draws = step_roi_draws(cfg.MODEL, TRAIN_BATCH, 0, 666, dev)  # the same sampler draws too
    losses, parts = [], []
    for _ in range(OVERFIT_STEPS):
        metrics = train_step(state, cfg.MODEL, batch["points"], batch["gt_boxes"],
                             roi_draws=draws)
        losses.append(metrics["loss"].item())
        parts.append({k: metrics[k].item() for k in ("point_loss_cls", "point_loss_box",
                                                      "rcnn_loss_cls", "rcnn_loss_reg")})
    last = sum(losses[-5:]) / 5
    emit({"phase": "train_overfit", "steps": OVERFIT_STEPS, "schedule_steps": total,
          "last_lr": state.optimizer.current_lr(), "first_loss": losses[0],
          "last5_mean_loss": last, "losses": losses, "loss_parts": parts, "card": card})
    if not all(np.isfinite(losses)) or not last < losses[0]:
        fail(f"train_overfit: the loss did not fall ({losses[0]} → {last})")


def phase_train_card_vs_cpu(torch, np, dev, root, card):
    """One train step's forward, loss and backward from the same weights,
    batch and RoI draws on the card and on the port's CPU path, and the
    backbone and point head once more on the CPU in float64 with the
    float32 run's point choices (``tools/train_probe.py::grad_gap``)."""
    from modest_tpu_torch.tools.train_probe import grad_gap

    cfg, batch = first_batch(torch, root, torch.device("cpu"))
    t0 = time.perf_counter()
    r = grad_gap(dev, cfg, batch)
    seconds = time.perf_counter() - t0
    card_m, cpu_m = r["card_metrics"], r["cpu_metrics"]
    loss_err = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-12)
                for k in ("point_loss_cls", "point_loss_box")}
    # the backbone's ball queries and max-pools (B scans; the RoI tower's
    # clouds follow the NMS-chosen RoIs, held by the RoI match below)
    queries = [q for q in r["card"]["ball_queries"] if q["shape"][0] == TRAIN_BATCH]
    pools = [q for q in r["card"]["max_pools"] if q["shape"][0] == TRAIN_BATCH]
    slots_differ = sum(q["slots_differ"] for q in queries) / sum(
        np.prod(q["shape"]) for q in queries)
    maxima_differ = sum(q["maxima_from_other_point"] for q in pools) / sum(
        np.prod(q["shape"]) for q in pools)
    gaps = r["grad_rel_err"]
    card64 = gaps["card_vs_float64"]["backbone_point_head"]
    cpu64 = gaps["cpu_vs_float64"]["backbone_point_head"]
    emit({"phase": "train_card_vs_cpu", "point_loss_rel_err": loss_err,
          "loss_rtol": TRAIN_LOSS_RTOL, "backbone_slots_differ_share": slots_differ,
          "backbone_maxima_differ_share": maxima_differ, "share_max": MAX_DIFFER_SHARE,
          "grad_rel_err": gaps, "card_over_cpu_float64_err": card64["max"] / cpu64["max"],
          "ratio_max": TRAIN_GRAD_F64_RATIO, "card_losses": card_m, "cpu_losses": cpu_m,
          "float64_losses": r["float64_metrics"], "float64_neighbours": r["float64"],
          "card_neighbours": r["card"], "sampled_roi_match": r["sampled_roi_match"],
          "roi_match_min": MIN_ROI_MATCH, "seconds": seconds, "card": card})
    if card64["n"] != cpu64["n"] or card64["n"] < 100:
        fail(f"train card vs CPU: {card64['n']} gradients compared")
    if max(loss_err.values()) > TRAIN_LOSS_RTOL:
        fail(f"train card vs CPU: point losses {loss_err}")
    if max(slots_differ, maxima_differ) > MAX_DIFFER_SHARE:
        fail(f"train card vs CPU: {slots_differ} of the backbone's neighbours, {maxima_differ} "
             f"of its max-pool sources differ")
    if card64["max"] > TRAIN_GRAD_F64_RATIO * cpu64["max"]:
        fail(f"train card vs CPU: the card's gradients are {card64['max']} from float64 "
             f"({card64['worst']}), the CPU's {cpu64['max']}")
    if r["sampled_roi_match"] < MIN_ROI_MATCH:
        fail(f"train card vs CPU: {r['sampled_roi_match']:.4f} of the sampled RoIs agree "
             f"(< {MIN_ROI_MATCH})")


def run_ranks(fn_name: str, args_by_rank, root, where: str) -> None:
    """``chip_smoke.<fn_name>(*args)`` in one new interpreter per rank
    (``run_processes``)."""
    run_processes([[sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r}); "
                    f"import chip_smoke; chip_smoke.{fn_name}(*{tuple(args)!r})"]
                   for args in args_by_rank], root, where)


def run_processes(cmds, root, where: str, env=None) -> None:
    """One process per rank running ``cmds[rank]`` from the repository's
    root, all started together; fails the phase when one exits non-zero
    (the others are killed at once) or they have not all ended within
    DDP_TIMEOUT_S. Each rank's output goes to ``root/<where>_rank<r>.log``."""
    procs, logs = [], []
    for rank, cmd in enumerate(cmds):
        logs.append(open(root / f"{where}_rank{rank}.log", "w"))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    deadline = time.time() + DDP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            tail = (root / f"{where}_rank{r}.log").read_text()[-3000:]
            print(f"chip_smoke: {where} rank {r} exited {procs[r].returncode}:\n{tail}",
                  file=sys.stderr, flush=True)
        fail(f"{where}: ranks {bad} failed or did not end within {DDP_TIMEOUT_S} s")


def ddp_shape(world: int):
    """(global batch, epochs) of phase ddp_train with ``world`` processes:
    2 scans a process, as many steps as with DDP_WORLD."""
    return DDP_BATCH // DDP_WORLD * world, DDP_EPOCHS * world // DDP_WORLD


def ddp_train_argv(root, out, port: int, rank: int, world: int):
    batch, epochs = ddp_shape(world)
    return ["--cfg_file", str(REPO / FLAGSHIP_CFG), "--data_path", str(root), "--batch_size",
            str(batch), "--epochs", str(epochs), "--fix_random_seed", "--output_dir",
            str(out), "--eval_after_train", "--launcher", "manual", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", str(world), "--process_id", str(rank),
            "--set", "OPTIMIZATION.LR", str(ROUND_LR), "DATA_CONFIG.DATA_SPLIT.test", "train",
            "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]"]


def ddp_train_rank(rank: int, port: int, root: str, out: str, world: int) -> None:
    """Process ``rank`` of phase ddp_train: cli/train.py with ``--launcher
    manual`` (``train_rank``)."""
    import torch

    torch.set_num_threads(1)  # as torchrun and cli/train.py's --num_devices set each process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_rank(ddp_train_argv(root, out, port, rank, world))


def train_rank(argv) -> None:
    """cli/train.py's ``main`` on ``argv`` (a process of a group, with
    ``--eval_after_train``), the checkpoint writes this process makes
    counted; writes ``<output_dir>/rank<r>.json`` (the command line, its
    steps, FPS launches in training and in the evaluation, checkpoint
    writes, collectives, peak memory, backend) and ``state_rank<r>.pth``
    (its final weights and batch-norm buffers)."""
    import torch
    import torch.distributed as dist

    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.parallel import mesh

    args, _ = train_cli.parse_config(argv)
    out, rank = Path(args.output_dir), args.process_id
    writes, real_save = [], torch.save

    def counted_save(obj, f, *a, **kw):  # the checkpoints this process writes
        writes.append(str(f))
        return real_save(obj, f, *a, **kw)

    counts = reset_fps_counts()
    at_eval, real_eval = {}, train_cli.eval_one_epoch

    def eval_after_train(model, model_cfg, loader, *a, **kw):
        at_eval.update(launches=dict(counts), batches=len(loader), backend=dist.get_backend())
        return real_eval(model, model_cfg, loader, *a, **kw)

    torch.save, train_cli.eval_one_epoch = counted_save, eval_after_train
    mesh.calls.update(dict.fromkeys(mesh.calls, 0))
    torch.cuda.reset_peak_memory_stats()
    try:
        state = train_cli.main(argv, stage_times=True)
    finally:
        torch.save = real_save
    train_launches = at_eval["launches"]
    report = {"rank": rank, "argv": argv, "history": state.history,
              "train_launches": train_launches,
              "eval_launches": {k: counts[k] - train_launches[k] for k in counts},
              "eval_batches": at_eval["batches"], "backend": at_eval["backend"],
              "checkpoint_writes": writes, "collectives": dict(mesh.calls),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               out / f"state_rank{rank}.pth")


def phase_ddp_train(torch, np, root, card, world: int = DDP_WORLD):
    """cli/train.py as ``world`` processes (``--launcher manual``; on the one
    card, gloo; one card each where there are as many, NCCL): the flagship
    whole at full width, 2 scans a process, then ``--eval_after_train`` on
    the train scans, merged by rank 0."""
    from modest_tpu_torch.parallel.multihost import free_port

    batch, epochs = ddp_shape(world)
    out = root / f"ddp_run_{world}"
    out.mkdir()
    port = free_port()
    t0 = time.perf_counter()
    run_ranks("ddp_train_rank", [(r, port, str(root), str(out), world) for r in range(world)],
              root, f"ddp_train_{world}")
    seconds = time.perf_counter() - t0
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    steps = TRAIN_SCANS // batch * epochs
    backend = "gloo" if torch.cuda.device_count() < world else "nccl"
    states = [torch.load(out / f"state_rank{r}.pth") for r in range(world)]
    rank_gap = max(float((states[0][k].double() - s[k].double()).abs().max())
                   for s in states[1:] for k in states[0])
    with open(out / "eval" / f"epoch_{epochs}" / "val" / "result.pkl", "rb") as f:
        frames = [a["frame_id"] for a in pickle.load(f)]
    want_frames = [f"{i:06d}" for i in range(TRAIN_SCANS)]
    hist = reports[0]["history"]
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    per_step = {"fps_cluster_kernel": 3 * steps, "fps_warp_kernel": 3 * steps}
    row = {"phase": "ddp_train", "processes": world, "global_batch": batch,
           "points_per_scan": N_POINTS, "steps": [len(r["history"]) for r in reports],
           "epochs": epochs, "lr": ROUND_LR, "backend": [r["backend"] for r in reports],
           "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
           "global_scans_per_s": batch * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
           "timed_steps": len(timed),
           "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
           "data_wait_ms": [sum(s["data_wait_ms"] for s in r["history"][2:]) / len(timed)
                            for r in reports],
           "stage_ms": stage_ms, "grad_reduce_ms": stage_ms.get("grad_reduce"),
           "collectives_per_step": {k: v / steps for k, v in reports[0]["collectives"].items()},
           "peak_mem_gb": [r["peak_mem_gb"] for r in reports],
           "rank_param_max_abs_diff": rank_gap, "rank_param_bound": 0.0,
           "checkpoint_writes": [len(r["checkpoint_writes"]) for r in reports],
           "ckpt_files": sorted(p.name for p in (out / "ckpt").iterdir()),
           "result_frames": len(frames), "result_unique_frames": len(set(frames)),
           "fps_train_launches": [r["train_launches"] for r in reports],
           "fps_eval_launches": [r["eval_launches"] for r in reports],
           "eval_batches": [r["eval_batches"] for r in reports],
           "seconds": seconds, "card": card}
    emit(row)
    for r in reports:
        if len(r["history"]) != steps:
            fail(f"ddp_train: rank {r['rank']} took {len(r['history'])} steps, not {steps}")
        check_history(np, r["history"], f"ddp_train rank {r['rank']}")
        if r["train_launches"] != per_step:
            fail(f"ddp_train: rank {r['rank']} launched the fps kernels "
                 f"{r['train_launches']} times in {steps} steps, not 3 + 3 a step")
        n = r["eval_batches"]
        if r["eval_launches"] != {"fps_cluster_kernel": 3 * n, "fps_warp_kernel": 3 * n}:
            fail(f"ddp_train: rank {r['rank']}'s {n} eval batches launched {r['eval_launches']}")
        if r["backend"] != backend:  # gloo where the processes share a card
            fail(f"ddp_train: backend {r['backend']}, not {backend}")
    if rank_gap != 0.0:
        fail(f"ddp_train: the processes' weights part by {rank_gap}")
    if row["checkpoint_writes"] != [epochs] + [0] * (world - 1) or row["ckpt_files"] != [
            f"checkpoint_epoch_{e}.pth" for e in range(1, epochs + 1)]:
        fail(f"ddp_train: checkpoint writes {row['checkpoint_writes']}, files {row['ckpt_files']}")
    if frames != want_frames:
        fail(f"ddp_train: the merged result.pkl holds {frames}, not each train frame once")
    return [r["train_launches"] for r in reports], steps, [r["eval_launches"] for r in reports]


def script_rank(argv) -> None:
    """The ``python`` that scripts/torch_multihost_train.sh runs in phase
    ddp_script: checks that the script asked for ``-m
    modest_tpu_torch.cli.train``, then runs ``train_rank`` on the rest of
    the command line."""
    if argv[:2] != ["-m", "modest_tpu_torch.cli.train"]:
        raise SystemExit(f"ddp_script: the launch script ran python {argv[:2]}")
    train_rank(argv[2:])


def phase_ddp_script(torch, np, root, card):
    """ddp_script: SECOND (DDP_SCRIPT_CFG) as DDP_WORLD processes, each
    started by its own copy of scripts/torch_multihost_train.sh as a user
    starts them (process id, count, coordinator, config, then the CLI's
    flags), sharing the card (gloo): a global batch of DDP_BATCH for
    DDP_SCRIPT_EPOCHS epochs at the rate the config's first epochs reach,
    then --eval_after_train on the train scans, merged by rank 0. The
    ``python`` first on the script's PATH is ``script_rank`` on this
    interpreter. Checks: both exit 0 with the script's command line, every
    loss finite, the ranks' weights and buffers equal (bound 0.0), rank 0
    alone writing the checkpoints, the merged result.pkl holding each train
    frame once, the batch-wide sparse batch norms on gloo, no FPS."""
    import os
    import shlex

    from modest_tpu_torch.parallel.multihost import free_port

    cfg = shipped_config(DDP_SCRIPT_CFG, root)
    epochs = DDP_SCRIPT_EPOCHS
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, epochs)
    out, bin_dir = root / "ddp_script", root / "ddp_script_bin"
    out.mkdir()
    bin_dir.mkdir()
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
            "chip_smoke.script_rank(sys.argv[1:])")
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec {shlex.quote(sys.executable)} -c {shlex.quote(code)} "$@"\n')
    shim.chmod(0o755)
    coordinator = f"127.0.0.1:{free_port()}"
    flags = ["--data_path", str(root), "--batch_size", str(DDP_BATCH), "--epochs", str(epochs),
             "--fix_random_seed", "--output_dir", str(out), "--eval_after_train",
             "--set", "OPTIMIZATION.LR", str(lr), "DATA_CONFIG.DATA_SPLIT.test", "train",
             "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]"]
    cfg_file = str(REPO / DDP_SCRIPT_CFG)
    cmds = [["bash", str(REPO / "scripts" / "torch_multihost_train.sh"), str(r), str(DDP_WORLD),
             coordinator, cfg_file, *flags] for r in range(DDP_WORLD)]
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}"}
    t0 = time.perf_counter()
    run_processes(cmds, root, "ddp_script", env)
    seconds = time.perf_counter() - t0
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(DDP_WORLD)]
    states = [torch.load(out / f"state_rank{r}.pth") for r in range(DDP_WORLD)]
    rank_gap = max(float((states[0][k].double() - s[k].double()).abs().max())
                   for s in states[1:] for k in states[0])
    with open(out / "eval" / f"epoch_{epochs}" / "val" / "result.pkl", "rb") as f:
        frames = [a["frame_id"] for a in pickle.load(f)]
    steps = TRAIN_SCANS // DDP_BATCH * epochs
    hist = reports[0]["history"]
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    row = {"phase": "ddp_script", "model": "second", "processes": DDP_WORLD,
           "script": "scripts/torch_multihost_train.sh", "global_batch": DDP_BATCH,
           "steps": [len(r["history"]) for r in reports], "epochs": epochs, "lr": lr,
           "backend": [r["backend"] for r in reports],
           "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
           "global_scans_per_s": DDP_BATCH * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
           "timed_steps": len(timed),
           "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
           "stage_ms": stage_ms, "grad_reduce_ms": stage_ms.get("grad_reduce"),
           "collectives_per_step": {k: v / steps for k, v in reports[0]["collectives"].items()},
           "peak_mem_gb": [r["peak_mem_gb"] for r in reports],
           "rank_param_max_abs_diff": rank_gap, "rank_param_bound": 0.0,
           "checkpoint_writes": [len(r["checkpoint_writes"]) for r in reports],
           "ckpt_files": sorted(p.name for p in (out / "ckpt").iterdir()),
           "result_frames": len(frames), "result_unique_frames": len(set(frames)),
           "eval_batches": [r["eval_batches"] for r in reports],
           "fps_train_launches": [r["train_launches"] for r in reports],
           "fps_eval_launches": [r["eval_launches"] for r in reports],
           "seconds": seconds, "card": card}
    emit(row)
    for r in reports:
        want_argv = ["--cfg_file", cfg_file, "--launcher", "manual", "--coordinator",
                     coordinator, "--num_processes", str(DDP_WORLD), "--process_id",
                     str(r["rank"]), *flags]
        if r["argv"] != want_argv:
            fail(f"ddp_script: rank {r['rank']} ran cli/train.py with {r['argv']}")
        if len(r["history"]) != steps:
            fail(f"ddp_script: rank {r['rank']} took {len(r['history'])} steps, not {steps}")
        check_history(np, r["history"], f"ddp_script rank {r['rank']}")
        if r["backend"] != "gloo":
            fail(f"ddp_script: backend {r['backend']} where the processes share the card")
        if any(r["train_launches"].values()) or any(r["eval_launches"].values()):
            fail(f"ddp_script: SECOND launched the fps kernels {r['train_launches']} in "
                 f"training, {r['eval_launches']} in the evaluation")
    if rank_gap != 0.0:
        fail(f"ddp_script: the processes' weights part by {rank_gap}")
    if row["checkpoint_writes"] != [epochs] + [0] * (DDP_WORLD - 1) or row["ckpt_files"] != [
            f"checkpoint_epoch_{e}.pth" for e in range(1, epochs + 1)]:
        fail(f"ddp_script: checkpoint writes {row['checkpoint_writes']}, files "
             f"{row['ckpt_files']}")
    if frames != [f"{i:06d}" for i in range(TRAIN_SCANS)]:
        fail(f"ddp_script: the merged result.pkl holds {frames}, not each train frame once")


def ddp_batch(torch, root):
    """The train loader's first global batch of DDP_BATCH scans (CPU)."""
    import numpy as np

    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.data.loader import build_dataloader
    from modest_tpu_torch.utils.config import Config

    cfg = Config(POINTRCNN_DYNAMIC_OBJ_FULL)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    np.random.seed(666)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, DDP_BATCH, training=True)
    batch = next(iter(loader))
    return {k: torch.from_numpy(batch[k]) for k in ("points", "gt_boxes")}


def ddp_step(torch, dev, batch, rank: int = 0, world: int = 1, dtype=None):
    """One SGD step of the seed-1 flagship on this process's rows of
    ``batch`` in ``dtype`` (float32 when None; in float64 FPS samples a
    float32 copy of the coordinates); (the weights before, the metrics, the
    state dict after)."""
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.ops import pointnet2
    from modest_tpu_torch.train.state import create_train_state, train_step
    from modest_tpu_torch.utils.config import Config

    dtype = dtype or torch.float32
    cfg = Config(POINTRCNN_DYNAMIC_OBJ_FULL)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=1).to(dtype)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = Config({**cfg.OPTIMIZATION.to_dict(), "OPTIMIZER": "sgd"})
    state = create_train_state(model, opt, int(cfg.OPTIMIZATION.NUM_EPOCHS) * TRAIN_SCANS)
    b = batch["points"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    fps = pointnet2.furthest_point_sample
    pointnet2.furthest_point_sample = lambda xyz, npoint: fps(xyz.float(), npoint)
    try:
        metrics = train_step(state, cfg.MODEL, batch["points"][rows].to(dev, dtype),
                             batch["gt_boxes"][rows].to(dev, dtype))
    finally:
        pointnet2.furthest_point_sample = fps
    return before, {k: float(v.detach()) for k, v in metrics.items()}, model.state_dict()


def ddp_step_rank(rank: int, port: int, batch_file: str, out: str) -> None:
    """Process ``rank`` of phase ddp_step_vs_single: one step on its rows of
    the global batch in a group of DDP_WORLD on the card; writes its metrics
    and state dict to ``out/step_rank<r>.pth``."""
    import torch

    from modest_tpu_torch.parallel.multihost import shutdown, start_process_group

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = start_process_group(f"127.0.0.1:{port}", DDP_WORLD, rank, "cuda")
    batch = torch.load(batch_file)
    b = DDP_BATCH // DDP_WORLD
    fps = fps_levels_vs_plain(torch, batch["points"][rank * b:(rank + 1) * b, :, :3].to(dev))
    steps = {}
    try:
        for dtype in (torch.float32, torch.float64):
            _, metrics, sd = ddp_step(torch, dev, batch, rank, DDP_WORLD, dtype)
            steps[str(dtype)] = {"metrics": metrics, "state": {k: v.cpu() for k, v in sd.items()}}
    finally:
        shutdown()
    torch.save({"steps": steps, "fps": fps}, Path(out) / f"step_rank{rank}.pth")


def fps_levels_vs_plain(torch, xyz):
    """Both FPS kernels against the plain FPS on a process's first batch:
    the backbone's four levels chained on ``xyz`` (B, N, 3), each level's
    indices compared (SA1–SA3 take the cluster kernel, SA4 the warp
    kernel)."""
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda, furthest_point_sample_plain

    rows = []
    for npoint in POINTRCNN_DYNAMIC_OBJ["BACKBONE_3D"]["SA_CONFIG"]["NPOINTS"]:
        before = dict(furthest_point_sample_cuda.launches)
        got = furthest_point_sample_cuda(xyz, npoint).long()
        want = furthest_point_sample_plain(xyz, npoint).long()
        kernel = [k for k, v in furthest_point_sample_cuda.launches.items() if v != before[k]]
        rows.append({"B": xyz.shape[0], "N": xyz.shape[1], "npoint": npoint, "kernel": kernel,
                     "mismatches": int((got != want).sum())})
        xyz = torch.gather(xyz, 1, want[..., None].expand(-1, -1, 3)).contiguous()
    return rows


def phase_ddp_step_vs_single(torch, np, dev, root, card):
    """One step from the same weights: DDP_WORLD processes, each on its rows
    of a global batch of DDP_BATCH with the global batch's RoI draws and
    batch-norm statistics, against one process on the whole batch, in
    float32 and in float64; each process first holds both FPS kernels
    against the plain FPS on its rows (``fps_levels_vs_plain``). Returns the
    FPS rows."""
    from modest_tpu_torch.parallel.multihost import free_port

    batch = ddp_batch(torch, root)
    batch_file = root / "ddp_batch.pth"
    torch.save(batch, batch_file)
    port = free_port()
    run_ranks("ddp_step_rank", [(r, port, str(batch_file), str(root)) for r in range(DDP_WORLD)],
              root, "ddp_step")
    got = [torch.load(root / f"step_rank{r}.pth") for r in range(DDP_WORLD)]
    fps = [g["fps"] for g in got]
    rows = {}
    for dtype in (torch.float32, torch.float64):
        before, want_m, want_sd = ddp_step(torch, dev, batch, dtype=dtype)
        mine = [g["steps"][str(dtype)] for g in got]
        got_m, got_sd = mine[0]["metrics"], mine[0]["state"]
        loss_err = {k: abs(got_m[k] - want_m[k]) / max(abs(want_m[k]), 1e-12)
                    for k in want_m if k != "grad_norm"}
        update_err = {}
        for k, p0 in before.items():
            want_u = want_sd[k].double() - p0.double()
            got_u = got_sd[k].to(dev).double() - p0.double()
            update_err[k] = float((got_u - want_u).norm()) / max(float(want_u.norm()), 1e-30)
        buffers = [k for k in want_sd if k not in before and want_sd[k].dtype.is_floating_point]
        worst = max(update_err, key=update_err.get)
        rows[str(dtype).split(".")[-1]] = {
            "metrics": got_m, "single_metrics": want_m, "loss_rel_err": loss_err,
            "grad_norm_rel_err": abs(got_m["grad_norm"] - want_m["grad_norm"])
            / want_m["grad_norm"],
            "update_rel_err_max": update_err[worst], "update_rel_err_worst": worst,
            "bn_buffer_rel_err_max": max(
                float((got_sd[k].to(dev) - want_sd[k]).norm())
                / max(float(want_sd[k].norm()), 1e-30) for k in buffers),
            "ranks_equal": all(torch.equal(got_sd[k], m["state"][k]) for m in mine[1:]
                               for k in got_sd) and all(m["metrics"] == got_m for m in mine[1:])}
    emit({"phase": "ddp_step_vs_single", "processes": DDP_WORLD, "global_batch": DDP_BATCH,
          "optimizer": "sgd", **rows, "loss_rtol": DDP_LOSS_RTOL,
          "grad_norm_rtol": DDP_GRAD_NORM_RTOL, "update_rtol": DDP_UPDATE_RTOL,
          "bounds_on": "float64 (losses, gradient norm, updates); float32 (the point head's "
                       "losses, upstream of the RoI head's decisions)",
          "fps_vs_plain": fps, "card": card})
    if any(r["mismatches"] for ranks in fps for r in ranks) or {
            k for ranks in fps for r in ranks for k in r["kernel"]} != {"fps_cluster_kernel",
                                                                        "fps_warp_kernel"}:
        fail(f"ddp_step_vs_single: the FPS kernels on the processes' batches: {fps}")
    for name, row in rows.items():
        if not row["ranks_equal"]:
            fail(f"ddp_step_vs_single: the processes' {name} steps differ")
    f32, f64 = rows["float32"], rows["float64"]
    point = {k: f32["loss_rel_err"][k] for k in ("point_loss_cls", "point_loss_box")}
    if max(point.values()) > DDP_LOSS_RTOL:
        fail(f"ddp_step_vs_single: float32 point-head losses part by {point}")
    if max(f64["loss_rel_err"].values()) > DDP_LOSS_RTOL:
        fail(f"ddp_step_vs_single: float64 losses part by {f64['loss_rel_err']}")
    if f64["grad_norm_rel_err"] > DDP_GRAD_NORM_RTOL:
        fail(f"ddp_step_vs_single: gradient norms part by {f64['grad_norm_rel_err']}")
    if f64["update_rel_err_max"] > DDP_UPDATE_RTOL:
        fail(f"ddp_step_vs_single: {f64['update_rel_err_worst']}'s update parts by "
             f"{f64['update_rel_err_max']} of its norm")
    return fps


def phase_nccl_world1(torch, np, dev, root, card):
    """The port's process group on NCCL at world size 1 and one train step
    through its collectives (the loss normalizers' sums, the gradient
    all-reduce, the metrics' sum), against the same step with no group: bit
    for bit. Both run with deterministic algorithms (the backward's
    scatter-adds otherwise add in atomic order), and the step without a
    group runs twice to show the card repeats itself."""
    import torch.distributed as dist

    from modest_tpu_torch.parallel import mesh
    from modest_tpu_torch.parallel.multihost import free_port, shutdown, start_process_group

    batch = {k: v[:TRAIN_BATCH] for k, v in ddp_batch(torch, root).items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, plain_m, plain_sd = ddp_step(torch, dev, batch)
        _, again_m, again_sd = ddp_step(torch, dev, batch)
        start_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
        try:
            backend = dist.get_backend()
            mesh.calls.update(dict.fromkeys(mesh.calls, 0))
            _, group_m, group_sd = ddp_step(torch, dev, batch)
            calls = dict(mesh.calls)
        finally:
            shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
    repeats = plain_m == again_m and all(torch.equal(plain_sd[k], again_sd[k]) for k in plain_sd)
    differ = [k for k in plain_sd if not torch.equal(plain_sd[k], group_sd[k])]
    emit({"phase": "nccl_world1", "backend": backend, "collectives": calls,
          "metrics_equal": group_m == plain_m, "tensors_differ": differ,
          "plain_step_repeats": repeats, "metrics": group_m, "card": card})
    if backend != "nccl" or calls["reduce_gradients"] != 1 or calls["global_sum"] == 0:
        fail(f"nccl_world1: backend {backend}, collectives {calls}")
    if not repeats:
        fail("nccl_world1: the step without a group gave other bits on its second run")
    if differ or group_m != plain_m:
        fail(f"nccl_world1: the step in the group differs at {differ[:5]} "
             f"(metrics equal: {group_m == plain_m})")


def shipped_config(path, root):
    """A shipped config (its dict, no PyYAML) with DATA_PATH ``root``."""
    from modest_tpu_torch.cli.train import load_model_config

    cfg = load_model_config(REPO / path)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    return cfg


def grid_config(name, root):
    """A grid model's (or PV-RCNN's) shipped config on the synthetic set, its
    test split the training scans (no augmentation, 65536 points a scan)."""
    cfg = shipped_config({**GRID_CFGS, **TWO_STAGE_CFGS, "pv_rcnn": PV_CFG}[name], root)
    cfg.DATA_CONFIG.DATA_SPLIT.test = "train"
    cfg.DATA_CONFIG.INFO_PATH.test = ["kitti_infos_train.pkl"]
    return cfg


def grid_batch(torch, cfg, dev, batch_size=GRID_BATCH, training=False):
    """The dataset and its first batch (B = 4 unless asked otherwise, test
    mode unless ``training``) on ``dev``."""
    from modest_tpu_torch.data.loader import batch_to_device, build_dataloader

    ds, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                  training=training)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    return ds, batch_to_device(batch, dev)


def calibrate_grid_model(torch, api, model, cfg, batch):
    """Random weights made to score like a detector: every batch norm's
    running statistics from one train-mode pass over ``batch`` (momentum 1),
    then each class head's (``*conv_cls``) bias moved so that an empty BEV
    cell (a scene with no point in range) scores GRID_EMPTY_LOGIT per anchor
    channel; a model without one (a point head) keeps its bias."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        api.apply_train(model, cfg, batch["points"], batch["gt_boxes"])
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    heads = [m for name, m in model.named_modules() if name.endswith("conv_cls")]
    logits = []
    hooks = [head.register_forward_hook(lambda m, i, out: logits.append(out)) for head in heads]
    api.apply_eval(model, cfg, torch.full_like(batch["points"][:1], -1e4))
    for hook in hooks:
        hook.remove()
    with torch.no_grad():
        for head, out in zip(heads, logits):  # (1, channels, H, W) a head
            head.bias -= out[0].flatten(1).median(dim=1).values - GRID_EMPTY_LOGIT
    model.eval()


def phase_grid_forward(torch, np, api, build_network, name, cfg, ds, batch, card):
    """Eval forward + post-process of one grid model at full width, B = 4:
    scans/s over GRID_TIMED_ITERS batches after a warm-up, stage ms by CUDA
    events, peak memory, kept boxes, and SECOND's voxel counts per scan."""
    from modest_tpu_torch.models.grid_detectors import MAX_VOXELS
    from modest_tpu_torch.models.voxelize import voxel_counts

    dev = batch["points"].device
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0, dataset=ds)
    calibrate_grid_model(torch, api, model, cfg.MODEL, batch)
    points = batch["points"]
    timed, _ = timed_forwards(torch, api, model, cfg.MODEL, points, GRID_TIMED_ITERS,
                              f"{name} on the card")
    row = {"phase": "grid_forward", "model": name, "grid_size": [int(v) for v in ds.grid_size],
           "anchors": int(model.anchors.shape[0]), **timed, "card": card}
    if name == "second":
        in_range, occupied, kept, dropped = voxel_counts(
            points, model.point_cloud_range, model.voxel_size, model.grid_size,
            MAX_VOXELS)
        model.backbone_3d.record_active = True
        run_path(api, model, cfg.MODEL, points)
        model.backbone_3d.record_active = False
        row.update(max_voxels=MAX_VOXELS, points_in_range=in_range.tolist(),
                   occupied_voxels=occupied.tolist(), kept_voxels=kept.tolist(),
                   dropped_points=dropped.tolist(),
                   active_sites={k: v.tolist()
                                 for k, v in model.backbone_3d.active_counts.items()})
    emit(row)
    return model


def grid_forward_chain(torch, np, api, card_model, cpu_model, model_cfg, scan):
    """A grid detector's eval forward and post-processing of ``scan`` (1, N,
    C) on the card and on the CPU, and stage by stage: the dense class,
    box and direction outputs card vs CPU (``dense_tol_used``: the largest
    |card - CPU| over its limit, MATCH_SCORE for logits or MATCH_SIZE for box
    residuals + FORWARD_RTOL * |CPU|, as ``forward_chain``'s); the card's
    post-processing (its NMS, or ``multi_classes_nms``) against the CPU's on
    a CPU copy of the same dense outputs (``finals_given_card_dense``, 1:1);
    the CPU's post-processing of its own dense outputs against that of the
    card's (``cpu_finals_own_dense``: below 1 where the CPU's own rounding
    made its NMS keep other boxes, a decision of its own that parted).
    Returns (row, the card's final boxes, the CPU's own), on the CPU."""
    dev = next(card_model.parameters()).device
    out = api.apply_eval(card_model, model_cfg, scan.to(dev))
    got = {k: v.cpu() for k, v in api.post_process(out, model_cfg).items() if v is not None}
    card = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
    cpu = api.apply_eval(cpu_model, model_cfg, scan.cpu())
    want = api.post_process(cpu, model_cfg)
    given = api.post_process(card, model_cfg)
    limits = (("cls_preds", MATCH_SCORE), ("box_preds", MATCH_SIZE), ("dir_cls_preds", MATCH_SCORE))
    row = {"dense_tol_used": max(
               float(((card[k] - cpu[k]).abs() / (atol + FORWARD_RTOL * cpu[k].abs())).max())
               for k, atol in limits if k in card),
           "finals_given_card_dense": match_finals(np, got, given)["match_frac"],
           "cpu_finals_own_dense": match_finals(np, given, want)["match_frac"]}
    return row, got, want


def check_grid_chain(chain, match_frac, detections, where):
    """Fails unless the dense outputs lie within the chain's limits, the
    card's post-processing keeps the CPU's boxes on the same dense outputs
    (>= MIN_BOX_MATCH), and the end-to-end detections match 1:1 (>=
    MIN_BOX_MATCH) or part only where the CPU's own dense outputs made its
    post-processing keep other boxes (``cpu_finals_own_dense`` < 1)."""
    if detections == 0:
        fail(f"{where}: no detection on either device")
    if not chain["dense_tol_used"] <= 1.0 or chain["finals_given_card_dense"] < MIN_BOX_MATCH:
        fail(f"{where}: with the card's dense outputs the CPU parts from the card: "
             f"dense_tol_used {chain['dense_tol_used']}, finals_given_card_dense "
             f"{chain['finals_given_card_dense']} (limits 1 and {MIN_BOX_MATCH})")
    if match_frac < MIN_BOX_MATCH and chain["cpu_finals_own_dense"] >= 1.0:
        fail(f"{where}: {match_frac:.4f} of the final boxes match 1:1 (< {MIN_BOX_MATCH}), yet "
             "the CPU's post-processing keeps the same boxes of its own dense outputs")


def phase_grid_card_vs_cpu(torch, np, api, build_network, name, cfg, ds, model, batch, card):
    """The same weights on the card and on the CPU: one scan's detections by
    ``grid_forward_chain`` and ``check_grid_chain``, the batch's voxel
    (pillar) keys, coords and validity bit-equal, and one train-mode
    forward's losses on that scan within TRAIN_LOSS_RTOL."""
    from modest_tpu_torch.models.grid_detectors import MAX_VOXELS
    from modest_tpu_torch.models.voxelize import pillar_stats, point_voxel_coords, voxelize_sparse

    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu", dataset=ds)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_model.load_state_dict(state)
    scan = batch["points"][:1]
    t0 = time.perf_counter()
    chain, got, want = grid_forward_chain(torch, np, api, model, cpu_model, cfg.MODEL, scan)
    chain_s = time.perf_counter() - t0
    match = match_finals(np, got, want)

    def voxels(points):
        """(keys, coords, flags) and the mean features of SECOND's voxels or
        the pillars, on the CPU."""
        coords, inside = point_voxel_coords(points, model.point_cloud_range, model.voxel_size,
                                            model.grid_size)
        if model.model_cfg.NAME == "SECONDNet":
            vc, vf, vv, vk = voxelize_sparse(points, inside, coords, MAX_VOXELS,
                                             *model.grid_size)
            return [vk.cpu(), vc.cpu(), vv.cpu()], vf.cpu()
        _, mean, key = pillar_stats(points, inside, coords[..., :2], *model.grid_size[:2])
        return [key.cpu(), coords.cpu(), inside.cpu()], mean.cpu()

    card_keys, card_feats = voxels(batch["points"])
    cpu_keys, cpu_feats = voxels(batch["points"].cpu())
    key_mismatch = sum(int((a != b).sum()) for a, b in zip(card_keys, cpu_keys))
    feat_err = float((card_feats - cpu_feats).abs().max())

    losses = {}
    for where, m in (("card", model), ("cpu", cpu_model)):
        m.load_state_dict({k: v.to(next(m.parameters()).device) for k, v in state.items()})
        dev = next(m.parameters()).device
        out = api.apply_train(m, cfg.MODEL, scan.to(dev), batch["gt_boxes"][:1].to(dev))
        _, metrics = api.compute_loss(out, None, cfg.MODEL, len(cfg.CLASS_NAMES))
        losses[where] = {k: v.item() for k, v in metrics.items()}
        m.eval()
    loss_err = {k: abs(losses["card"][k] - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-12)
                for k in losses["cpu"]}
    emit({"phase": "grid_card_vs_cpu", "model": name, **match, **chain,
          "key_mismatches": key_mismatch,
          "voxel_feature_max_abs_err": feat_err,
          "card_losses": losses["card"], "cpu_losses": losses["cpu"],
          "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL, "chain_s": chain_s,
          "card": card})
    check_grid_chain(chain, match["match_frac"], match["card_detections"] + match["cpu_detections"],
                     f"{name} card vs CPU")
    if key_mismatch:
        fail(f"{name} card vs CPU: {key_mismatch} voxel keys, coords or flags differ")
    if max(loss_err.values()) > TRAIN_LOSS_RTOL:
        fail(f"{name} card vs CPU: train losses {loss_err}")


def phase_grid_train(torch, np, dev, root, name, card):
    """cli/train.py on one grid config at full width, B = 4: GRID_EPOCHS
    epochs (16 steps) at a peak rate of GRID_LR, then a resume from the
    last-but-one epoch's checkpoint."""
    from modest_tpu_torch.cli import train as train_cli

    def argv(out):
        return ["--cfg_file", str(REPO / GRID_CFGS[name]), "--data_path", str(root),
                "--batch_size", str(GRID_BATCH), "--epochs", str(GRID_EPOCHS),
                "--fix_random_seed", "--output_dir", str(out),
                "--set", "OPTIMIZATION.LR", str(GRID_LR)]

    out = root / f"grid_{name}"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(argv(out), stage_times=True)
    seconds = time.perf_counter() - t0
    hist = state.history
    per_epoch = TRAIN_SCANS // GRID_BATCH
    if len(hist) != per_epoch * GRID_EPOCHS:
        fail(f"{name} train: {len(hist)} steps")
    check_history(np, hist, f"{name} train")
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    emit({"phase": "grid_train", "model": name, "batch": GRID_BATCH, "steps": len(hist),
          "epochs": GRID_EPOCHS, "last_lr": state.optimizer.current_lr(),
          "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": GRID_BATCH * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "timed_steps": len(timed),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "forward_ms": sum(stage_ms[k] for k in state.model.stages), "stage_ms": stage_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "cli_seconds": seconds,
          "card": card})

    resumed_out = root / f"grid_{name}_resumed"
    (resumed_out / "ckpt").mkdir(parents=True)
    shutil.copy(out / "ckpt" / f"checkpoint_epoch_{GRID_EPOCHS - 1}.pth", resumed_out / "ckpt")
    torch.cuda.reset_peak_memory_stats(dev)
    resumed = train_cli.main(argv(resumed_out))
    first = resumed.history[0]
    check_history(np, resumed.history, f"{name} resumed train")
    emit({"phase": "grid_train_resume", "model": name, "start_epoch": resumed.start_epoch,
          "first_epoch": first["epoch"], "first_step": first["step"],
          "steps": len(resumed.history),
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": card})
    if (resumed.start_epoch, first["epoch"], first["step"], len(resumed.history)) != (
            GRID_EPOCHS - 1, GRID_EPOCHS - 1, per_epoch * (GRID_EPOCHS - 1), per_epoch):
        fail(f"{name} resume from epoch {GRID_EPOCHS - 1} restarted at epoch {first['epoch']}, "
             f"step {first['step']}")


def phase_grid(torch, np, api, build_network, dev, root, card):
    """PointPillars and SECOND: forward, card vs CPU, training. Their path
    runs no hand kernel (the JAX package runs it outside Pallas): the FPS
    counts, set to 0 before it, must read 0 after it."""
    counts = reset_fps_counts()
    t0 = time.perf_counter()
    for name in GRID_CFGS:
        cfg = grid_config(name, root)
        ds, batch = grid_batch(torch, cfg, dev)
        model = phase_grid_forward(torch, np, api, build_network, name, cfg, ds, batch, card)
        phase_grid_card_vs_cpu(torch, np, api, build_network, name, cfg, ds, model, batch, card)
        del model
        torch.cuda.empty_cache()
        phase_grid_train(torch, np, dev, root, name, card)
        torch.cuda.empty_cache()
    emit({"phase": "grid_kernels", "fps_kernel_launches": dict(counts),
          "seconds": time.perf_counter() - t0, "card": card})
    if any(counts.values()):
        fail(f"the grid detectors launched hand kernels {dict(counts)}")


def pv_forward_chain(torch, np, card_model, cpu_model, model_cfg, scan):
    """``forward_chain`` for PV-RCNN: its eval forward on ``scan`` (1, N, C)
    on the card and on the CPU, then stage by stage with the card's
    decisions handed to the CPU. The keypoints must be equal (FPS takes
    exact differences). The dense head's logits and box residuals
    (``dense_tol_used``, as ``forward_chain``'s point outputs); the CPU's
    proposal layer on the card's dense outputs against the card's RoIs
    (``proposals_given_card_dense``, 1:1); the CPU's VSA and RoI-grid head
    with the card's RoIs and the card's ball-query indices against the
    card's RCNN logits and boxes (``rcnn_tol_used``); the CPU's
    post-processing of the card's RCNN outputs (``finals_given_card_rcnn``).
    A ball query's membership at d² ≈ r² follows each device's rounding of
    |a|² + |b|² − 2ab, so the CPU is handed the card's indices;
    ``ball_slots_differ_share`` says how many of its own it would have
    picked otherwise there. Left to its own decisions the CPU may order its
    RoIs otherwise among all but tied scores (``rois_same_order``), and a
    RoI grid point a rounding away from a keypoint's ball may take another
    neighbour (``own_grid_slots_differ``, counted where the RoIs keep the
    card's order): either lets the final NMS keep another box. Returns
    (row, card's final boxes, CPU's)."""
    from unittest import mock

    from modest_tpu_torch.models import api, pv_rcnn
    from modest_tpu_torch.models.roi_head import proposal_layer
    from modest_tpu_torch.ops import pointnet2_stack

    def used(got, want, keys):
        return max(float(((got[k] - want[k]).abs() / (atol + FORWARD_RTOL * want[k].abs())).max())
                   for k, atol in zip(keys, (MATCH_SCORE, MATCH_SIZE)))

    real = pointnet2_stack.ball_query_masked
    queries = []

    def recording(*args):
        result = real(*args)
        queries.append(tuple(t.cpu() for t in result))
        return result

    dev = next(card_model.parameters()).device
    with mock.patch.object(pointnet2_stack, "ball_query_masked", recording):
        out = api.apply_eval(card_model, model_cfg, scan.to(dev))
    got = {k: v.cpu() for k, v in api.post_process(out, model_cfg).items() if v is not None}
    card = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
    own_queries = []

    def recording_own(*args):
        result = real(*args)
        own_queries.append(result)
        return result

    with mock.patch.object(pointnet2_stack, "ball_query_masked", recording_own):
        cpu = api.apply_eval(cpu_model, model_cfg, scan)
    want = api.post_process(cpu, model_cfg)
    valid = card["roi_valid"][0]
    same_order = bool((valid == cpu["roi_valid"][0]).all()) and float(
        (card["rois"][0][valid] - cpu["rois"][0][valid]).abs().max()) <= MATCH_SIZE
    n_grid = len(model_cfg.ROI_HEAD.ROI_GRID_POOL.POOL_RADIUS)
    vsa_differ = sum(int((a[0] != b[0]).sum()) for a, b in zip(own_queries[:-n_grid],
                                                               queries[:-n_grid]))
    grid_differ = (sum(int((a[0] != b[0]).sum()) for a, b in zip(own_queries[-n_grid:],
                                                                 queries[-n_grid:]))
                   if same_order else None)
    with torch.inference_mode():
        bcls, bbox = cpu_model.generate_predicted_boxes(card["cls_preds"], card["box_preds"],
                                                        card["dir_cls_preds"])
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TEST
    rois, roi_scores, _, roi_valid = proposal_layer(
        bbox, bcls.reshape(1, -1, cpu_model.num_class), nms_pre=int(nms.NMS_PRE_MAXSIZE),
        nms_post=int(nms.NMS_POST_MAXSIZE), nms_thresh=float(nms.NMS_THRESH))
    forced = tuple(card[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid"))
    replay, slots = iter(queries), [0, 0]

    def replaying(*args):
        idx, _ = real(*args)
        card_idx, card_empty = next(replay)
        slots[0] += int((idx != card_idx).sum())
        slots[1] += idx.numel()
        return card_idx, card_empty

    with mock.patch.object(pv_rcnn, "proposal_layer", lambda *a, **k: forced), \
            mock.patch.object(pointnet2_stack, "ball_query_masked", replaying):
        given = api.apply_eval(cpu_model, model_cfg, scan)
    if next(replay, None) is not None:
        fail("pv_rcnn card vs CPU: the CPU ran fewer ball queries than the card")
    row = {
        "keypoints_equal": bool((cpu["keypoints"] == card["keypoints"]).all()),
        "dense_tol_used": used(card, cpu, ("cls_preds", "box_preds")),
        "proposals_given_card_dense": match_rois(
            np, card, {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid}),
        "ball_queries": len(queries), "ball_slots_differ_share": slots[0] / slots[1],
        "own_vsa_slots_differ": vsa_differ, "rois_same_order": same_order,
        "own_grid_slots_differ": grid_differ,
        "rcnn_tol_used": used(card, given, ("batch_cls_preds", "batch_box_preds")),
        "finals_given_card_rcnn": match_finals(np, got, api.post_process(card, model_cfg))[
            "match_frac"],
        "proposals_card_vs_cpu": match_rois(np, card, cpu),
        "finals_given_card_rois": match_finals(np, got, api.post_process(given, model_cfg))[
            "match_frac"]}
    return row, got, want


def phase_pv_forward(torch, np, api, build_network, cfg, ds, batch, card,
                     phase="pv_rcnn_forward", iters=PV_TIMED_ITERS):
    """PV-RCNN's eval forward + post-process at full width (B = 4 scans of
    65536 points on Lyft; Waymo's B = 2 of 131072): a warm-up whose FPS
    launch must pick the plain FPS's indices on the same xyz, then ``iters``
    timed forwards (scans/s, stage ms by CUDA events, peak memory, FPS
    launches: one a forward)."""
    from unittest import mock

    from modest_tpu_torch.ops import pointnet2 as p2
    from modest_tpu_torch.ops.fps import furthest_point_sample_plain

    dev = batch["points"].device
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0, dataset=ds)
    calibrate_grid_model(torch, api, model, cfg.MODEL, batch)
    points = batch["points"]
    b = int(points.shape[0])
    real, launched = p2.furthest_point_sample_cuda, []

    def recording(xyz, npoint):
        idx = real(xyz, npoint)
        launched.append((xyz.clone(), npoint, idx))
        return idx

    with mock.patch.object(p2, "furthest_point_sample_cuda", recording):
        out = api.apply_eval(model, cfg.MODEL, points)
    if len(launched) != 1:
        fail(f"{phase}: the warm-up forward launched FPS {len(launched)} times, not once")
    xyz, npoint, idx = launched[0]
    fps_shape = [*xyz.shape[:2], npoint]
    plain_idx = furthest_point_sample_plain(xyz, npoint)
    index_mismatches = int((idx != plain_idx).sum())
    plain = p2.gather_points(xyz, plain_idx)
    keypoint_mismatches = int((out["keypoints"] != plain).any(-1).sum())
    detections = check_final(torch, api.post_process(out, cfg.MODEL), b,
                             f"{phase} on the card")

    events = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    stage_ms = {stage: 0.0 for stage in (*model.stages, "post_nms")}
    forward_ms = []
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        t_it = time.perf_counter()
        events.clear()
        mark("start")
        final = run_path(api, model, cfg.MODEL, points, on_stage=mark)
        mark("post_nms")
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t_it) * 1e3)
        for (_, a), (stage, b_ev) in zip(events, events[1:]):
            stage_ms[stage] += a.elapsed_time(b_ev) / iters
    wall = time.perf_counter() - t0
    launches = dict(counts)
    forward_ms.sort()
    check_final(torch, final, b, f"{phase} timed forward on the card")
    row = {"phase": phase, "batch": b,
           "points_per_scan": int(points.shape[1]), "grid_size": [int(v) for v in ds.grid_size],
           "keypoints": PV_KEYPOINTS, "fps_shape": fps_shape,
           "fps_index_mismatches": index_mismatches,
           "keypoint_mismatches": keypoint_mismatches,
           "detections": detections, "kept_per_scan": final["valid"].sum(1).tolist(),
           "stage_ms": stage_ms, "forward_ms_median": forward_ms[len(forward_ms) // 2],
           "forward_ms_max": forward_ms[-1], "timed_forwards": iters,
           "scans_per_s": b * iters / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "fps_kernel_launches": launches,
           "fps_launches_per_forward": sum(launches.values()) / iters, "card": card}
    emit(row)
    if index_mismatches or keypoint_mismatches:
        fail(f"{phase}: {index_mismatches} FPS indices and {keypoint_mismatches} keypoints "
             f"differ from the plain FPS's")
    if launches != {"fps_cluster_kernel": iters, "fps_warp_kernel": 0}:
        fail(f"{phase}: {iters} forwards launched the fps kernels {launches} times")
    return model, row


def phase_pv_card_vs_cpu(torch, np, api, build_network, cfg, ds, model, batch, card,
                         phase="pv_rcnn_card_vs_cpu"):
    """One scan's detections card vs CPU with the same weights: 1:1 >=
    MIN_BOX_MATCH, or ``pv_forward_chain`` stage by stage."""
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu", dataset=ds)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    chain, got, want = pv_forward_chain(torch, np, model, cpu_model, cfg.MODEL,
                                        batch["points"][:1].cpu())
    match = match_finals(np, got, want)
    emit({"phase": phase, "points": int(batch["points"].shape[1]), **match,
          **chain, "chain_s": time.perf_counter() - t0, "card": card})
    if not chain["keypoints_equal"]:
        fail(f"{phase}: the keypoints differ")
    check_chain(chain, match["match_frac"], match["card_detections"] + match["cpu_detections"],
                phase, stage1=("dense_tol_used", "proposals_given_card_dense"),
                parted=not chain["rois_same_order"] or bool(chain["own_vsa_slots_differ"])
                or bool(chain["own_grid_slots_differ"]))


def pv_train_argv(root, out, epochs, *flags):
    """cli/train.py's arguments; ``flags`` go before ``--set``, which takes
    the rest of the line."""
    return ["--cfg_file", str(REPO / PV_CFG), "--data_path", str(root), "--epochs", str(epochs),
            "--fix_random_seed", "--output_dir", str(out), *flags, "--set", "OPTIMIZATION.LR",
            str(PV_LR), "DATA_CONFIG.DATA_SPLIT.test", "train", "DATA_CONFIG.INFO_PATH.test",
            "[kitti_infos_train.pkl]"]


def phase_pv_train(torch, np, dev, root, card):
    """cli/train.py on PV-RCNN at full width and the config's B = 2:
    PV_EPOCHS epochs (16 steps) with --eval_after_train on the training
    scans; then a resume from the epoch-1 checkpoint, and cli/test.py on its
    checkpoint. One FPS launch a step and a test batch."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    out = root / "pv_rcnn"
    per_epoch = TRAIN_SCANS // TRAIN_BATCH
    test_batches = -(-TRAIN_SCANS // TRAIN_BATCH)
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(pv_train_argv(root, out, PV_EPOCHS, "--eval_after_train"),
                           stage_times=True)
    seconds = time.perf_counter() - t0
    launches = dict(counts)
    hist = state.history
    if len(hist) != per_epoch * PV_EPOCHS:
        fail(f"pv_rcnn train: {len(hist)} steps")
    check_history(np, hist, "pv_rcnn train")
    with open(out / "eval" / f"epoch_{PV_EPOCHS}" / "val" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    ids = (root / "ImageSets" / "train.txt").read_text().split()
    check_result(np, annos, ids, "pv_rcnn eval after train")
    want = {"fps_cluster_kernel": len(hist) + test_batches, "fps_warp_kernel": 0}
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    emit({"phase": "pv_rcnn_train", "batch": TRAIN_BATCH, "steps": len(hist),
          "epochs": PV_EPOCHS, "lr": PV_LR, "last_lr": state.optimizer.current_lr(),
          "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": TRAIN_BATCH * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "timed_steps": len(timed),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "forward_ms": sum(stage_ms[k] for k in state.model.stages), "stage_ms": stage_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "eval_frames": len(annos), "eval_detections": int(sum(len(a["score"]) for a in annos)),
          "fps_kernel_launches": launches, "fps_launches_expected": want,
          "cli_seconds": seconds, "card": card})
    if launches != want:
        fail(f"pv_rcnn train: {len(hist)} steps and {test_batches} test batches launched the "
             f"fps kernels {launches} times, not {want}")

    resumed_out = root / "pv_rcnn_resumed"
    (resumed_out / "ckpt").mkdir(parents=True)
    shutil.copy(out / "ckpt" / "checkpoint_epoch_1.pth", resumed_out / "ckpt")
    resumed = train_cli.main(pv_train_argv(root, resumed_out, PV_EPOCHS))
    first = resumed.history[0]
    check_history(np, resumed.history, "pv_rcnn resumed train")
    counts = reset_fps_counts()
    annos, _ = test_cli.main(["--cfg_file", str(REPO / PV_CFG), "--ckpt_dir",
                              str(resumed_out / "ckpt"), "--data_path", str(root),
                              "--output_dir", str(resumed_out / "test"), "--batch_size",
                              str(TRAIN_BATCH), "--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
                              "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]"])
    test_launches = dict(counts)
    check_result(np, annos, ids, "pv_rcnn cli/test.py")
    emit({"phase": "pv_rcnn_train_resume", "start_epoch": resumed.start_epoch,
          "first_epoch": first["epoch"], "first_step": first["step"],
          "steps": len(resumed.history), "test_frames": len(annos),
          "test_fps_kernel_launches": test_launches, "card": card})
    if (resumed.start_epoch, first["epoch"], first["step"], len(resumed.history)) != (
            1, 1, per_epoch, per_epoch):
        fail(f"pv_rcnn resume from epoch 1 restarted at epoch {first['epoch']}, "
             f"step {first['step']}")
    if test_launches != {"fps_cluster_kernel": test_batches, "fps_warp_kernel": 0}:
        fail(f"pv_rcnn cli/test.py: {test_batches} batches launched {test_launches}")
    return launches, len(hist), test_batches


def phase_pv_rcnn(torch, np, api, build_network, dev, root, card):
    """PV-RCNN on the grid phases' scans: forward, card vs CPU, training.
    The FPS counts are set to 0 before each path and read after it."""
    cfg = grid_config("pv_rcnn", root)
    ds, batch = grid_batch(torch, cfg, dev)
    model, forward_row = phase_pv_forward(torch, np, api, build_network, cfg, ds, batch, card)
    phase_pv_card_vs_cpu(torch, np, api, build_network, cfg, ds, model, batch, card)
    del model
    torch.cuda.empty_cache()
    train = phase_pv_train(torch, np, dev, root, card)
    torch.cuda.empty_cache()
    return forward_row, train


def _decisions_differ(a, b) -> int:
    """How many of two runs' discrete choices differ: a voxel query's (idx,
    empty) slot by slot, RoI-aware pooling's (scan, RoI, point, cell) tuples
    as sets."""
    import torch

    if len(a) == 2:
        return int((a[0] != b[0]).sum())
    rows = [set(map(tuple, torch.stack(x, dim=-1).tolist())) for x in (a, b)]
    return len(rows[0] ^ rows[1])


def two_stage_forward_chain(torch, np, card_model, cpu_model, model_cfg, scan):
    """``forward_chain`` for the two-stage voxel detectors: the eval forward
    on ``scan`` (1, N, C) on the card and on the CPU, then stage by stage
    with the card's decisions handed to the CPU: the dense head's logits
    and box residuals (``dense_tol_used``); the CPU's proposal layer on the
    card's dense outputs against the card's RoIs
    (``proposals_given_card_dense``, 1:1); the CPU's RoI head on the card's
    RoIs and the card's discrete choices (Voxel R-CNN's voxel-query slots,
    Part-A2's RoI-aware cells) against the card's scores and boxes
    (``rcnn_tol_used``; ``decisions_differ`` counts the CPU's own choices
    that differed there); the CPU's post-processing of the card's RoI-head
    outputs (``finals_given_card_rcnn``). Left to its own decisions the CPU
    may order its RoIs otherwise among all but tied scores
    (``rois_same_order``); its own RoIs differ from the card's by the dense
    head's rounding (``own_rois_max_abs_diff``), which moves the RoI grids,
    so a choice a rounding away from a boundary may go the other way
    (``own_decisions_differ``, where the RoIs keep the card's order) and
    the RoI head's outputs part (``own_rcnn_tol_used``), and the final NMS
    at IoU 0.1 may then keep another box among all but tied scores. Returns
    (row, card's final boxes, CPU's)."""
    import contextlib
    from unittest import mock

    from modest_tpu_torch.models import api, grid_detectors, part_a2, voxel_rcnn

    def used(got, want, keys):
        return max(float(((got[k] - want[k]).abs() / (atol + FORWARD_RTOL * want[k].abs())).max())
                   for k, atol in zip(keys, (MATCH_SCORE, MATCH_SIZE)))

    choices = ((voxel_rcnn, "voxel_query"), (part_a2, "roiaware_cells"))

    def patched(wrap):
        stack = contextlib.ExitStack()
        for module, name in choices:
            stack.enter_context(mock.patch.object(module, name, wrap(getattr(module, name))))
        return stack

    def recorder(into):
        def wrap(real):
            def recording(*args):
                result = real(*args)
                into.append(tuple(t.cpu() for t in result))
                return result
            return recording
        return wrap

    card_choices, own_choices = [], []
    dev = next(card_model.parameters()).device
    with patched(recorder(card_choices)):
        out = api.apply_eval(card_model, model_cfg, scan.to(dev))
    got = {k: v.cpu() for k, v in api.post_process(out, model_cfg).items() if v is not None}
    card = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
    with patched(recorder(own_choices)):
        cpu = api.apply_eval(cpu_model, model_cfg, scan)
    want = api.post_process(cpu, model_cfg)
    valid = card["roi_valid"][0]
    same_valid = bool((valid == cpu["roi_valid"][0]).all())
    rois_diff = float((card["rois"][0][valid] - cpu["rois"][0][valid]).abs().max()) \
        if same_valid else None
    same_order = same_valid and rois_diff <= MATCH_SIZE
    own_differ = (sum(_decisions_differ(a, b) for a, b in zip(own_choices, card_choices))
                  if same_order else None)
    with torch.inference_mode():
        bcls, bbox = cpu_model.generate_predicted_boxes(card["cls_preds"], card["box_preds"],
                                                        card["dir_cls_preds"])
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TEST
    rois, roi_scores, _, roi_valid = grid_detectors.proposal_layer(
        bbox, bcls.reshape(1, -1, cpu_model.num_class), nms_pre=int(nms.NMS_PRE_MAXSIZE),
        nms_post=int(nms.NMS_POST_MAXSIZE), nms_thresh=float(nms.NMS_THRESH))
    forced = tuple(card[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid"))
    replay, differ = iter(card_choices), [0]

    def replaying(real):
        def choose(*args):
            theirs = next(replay)
            differ[0] += _decisions_differ(real(*args), theirs)
            return theirs
        return choose

    with mock.patch.object(grid_detectors, "proposal_layer", lambda *a, **k: forced), \
            patched(replaying):
        given = api.apply_eval(cpu_model, model_cfg, scan)
    if next(replay, None) is not None:
        fail("two-stage card vs CPU: the CPU made fewer choices than the card")
    row = {
        "dense_tol_used": used(card, cpu, ("cls_preds", "box_preds")),
        "proposals_given_card_dense": match_rois(
            np, card, {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid}),
        "choices": len(card_choices), "decisions_differ": differ[0],
        "rcnn_tol_used": used(card, given, ("batch_cls_preds", "batch_box_preds")),
        "finals_given_card_rcnn": match_finals(np, got, api.post_process(card, model_cfg))[
            "match_frac"],
        "proposals_card_vs_cpu": match_rois(np, card, cpu), "rois_same_order": same_order,
        "own_rois_max_abs_diff": rois_diff, "own_decisions_differ": own_differ,
        "own_rcnn_tol_used": used(card, cpu, ("batch_cls_preds", "batch_box_preds"))
        if same_order else None,
        "finals_given_card_rois": match_finals(np, got, api.post_process(given, model_cfg))[
            "match_frac"]}
    return row, got, want


def phase_two_stage_forward(torch, np, api, build_network, name, cfg, ds, batch, card):
    """One two-stage detector's eval forward + post-process at full width,
    B = 4 scans of 65536 points: TWO_STAGE_TIMED_ITERS timed forwards after
    a warm-up (scans/s, stage ms by CUDA events, peak memory, kept boxes),
    then one scan card vs CPU (1:1 >= MIN_BOX_MATCH, or stage by stage by
    ``two_stage_forward_chain``)."""
    dev = batch["points"].device
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0, dataset=ds)
    calibrate_grid_model(torch, api, model, cfg.MODEL, batch)
    points = batch["points"]
    timed, _ = timed_forwards(torch, api, model, cfg.MODEL, points, TWO_STAGE_TIMED_ITERS,
                              f"{name} on the card")
    emit({"phase": "two_stage_forward", "model": name,
          "grid_size": [int(v) for v in ds.grid_size], **timed, "card": card})

    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu", dataset=ds)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    chain, got, want = two_stage_forward_chain(torch, np, model, cpu_model, cfg.MODEL,
                                               points[:1].cpu())
    match = match_finals(np, got, want)
    emit({"phase": "two_stage_card_vs_cpu", "model": name, **match, **chain,
          "chain_s": time.perf_counter() - t0, "card": card})
    # end to end the finals must match unless the CPU's own RoI-head inputs
    # (its RoIs, its choices) already differ from the card's
    check_chain(chain, match["match_frac"], match["card_detections"] + match["cpu_detections"],
                f"{name} card vs CPU", stage1=("dense_tol_used", "proposals_given_card_dense"),
                parted=not chain["rois_same_order"] or bool(chain["own_rois_max_abs_diff"])
                or bool(chain["own_decisions_differ"]))


def phase_two_stage_train(torch, np, dev, root, name, card):
    """cli/train.py on one two-stage config at full width and its batch for 8
    steps (TWO_STAGE_TRAIN: epochs and the lowered peak rate), every loss
    finite; then cli/test.py on its checkpoint over the training scans."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    epochs, lr = TWO_STAGE_TRAIN[name]
    out = root / f"two_stage_{name}"
    split = ["DATA_CONFIG.DATA_SPLIT.test", "train", "DATA_CONFIG.INFO_PATH.test",
             "[kitti_infos_train.pkl]"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", str(REPO / TWO_STAGE_CFGS[name]), "--data_path",
                            str(root), "--epochs", str(epochs), "--fix_random_seed",
                            "--output_dir", str(out), "--set", "OPTIMIZATION.LR", str(lr)],
                           stage_times=True)
    seconds = time.perf_counter() - t0
    hist = state.history
    batch = int(train_cli.load_model_config(REPO / TWO_STAGE_CFGS[name]).OPTIMIZATION
                .BATCH_SIZE_PER_GPU)
    if len(hist) != 8:
        fail(f"{name} train: {len(hist)} steps, not 8")
    check_history(np, hist, f"{name} train")
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    annos, _ = test_cli.main(["--cfg_file", str(REPO / TWO_STAGE_CFGS[name]), "--ckpt_dir",
                              str(out / "ckpt"), "--data_path", str(root), "--output_dir",
                              str(out / "test"), "--set", *split])
    test_s = time.perf_counter() - t0
    ids = (root / "ImageSets" / "train.txt").read_text().split()
    check_result(np, annos, ids, f"{name} cli/test.py")
    emit({"phase": "two_stage_train", "model": name, "batch": batch, "steps": len(hist),
          "epochs": epochs, "lr": lr, "last_lr": state.optimizer.current_lr(),
          "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": batch * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "timed_steps": len(timed),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "forward_ms": sum(stage_ms[k] for k in state.model.stages), "stage_ms": stage_ms,
          "peak_mem_gb": train_peak, "cli_seconds": seconds, "test_seconds": test_s,
          "test_frames": len(annos),
          "test_detections": int(sum(len(a["score"]) for a in annos)), "card": card})


def phase_two_stage(torch, np, api, build_network, dev, root, card):
    """SECOND-IoU, Voxel R-CNN and Part-A2: forward, card vs CPU, training
    and cli/test.py. They run no hand kernel (the JAX package runs them
    outside Pallas): the FPS counts, set to 0 before them, must read 0."""
    counts = reset_fps_counts()
    t0 = time.perf_counter()
    for name in TWO_STAGE_CFGS:
        cfg = grid_config(name, root)
        ds, batch = grid_batch(torch, cfg, dev)
        phase_two_stage_forward(torch, np, api, build_network, name, cfg, ds, batch, card)
        torch.cuda.empty_cache()
        phase_two_stage_train(torch, np, dev, root, name, card)
        torch.cuda.empty_cache()
    emit({"phase": "two_stage_kernels", "fps_kernel_launches": dict(counts),
          "seconds": time.perf_counter() - t0, "card": card})
    if any(counts.values()):
        fail(f"the two-stage detectors launched hand kernels {dict(counts)}")


def phase_nuscenes_boston(torch, np, dev, root, card):
    """The nuScenes-Boston PointRCNN config from its shipped dict (PyYAML not
    loaded): cli/train.py for one epoch of 4 steps at B = 2 on the first
    NUSC_SCANS training scans, sampled to 6144 points, then cli/test.py on
    its checkpoint. FPS launches 3 + 3 per step and test batch, at the
    shapes ``fps_vs_plain`` holds as nusc2_*."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    before = set(sys.modules)
    with open(root / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)[:NUSC_SCANS]
    with open(root / "kitti_infos_nusc.pkl", "wb") as f:
        pickle.dump(infos, f)
    ids = [info["point_cloud"]["lidar_idx"] for info in infos]
    split = ["DATA_CONFIG.INFO_PATH.train", "[kitti_infos_nusc.pkl]",
             "DATA_CONFIG.DATA_SPLIT.test", "train", "DATA_CONFIG.INFO_PATH.test",
             "[kitti_infos_nusc.pkl]"]
    out = root / "nuscenes_boston"
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", str(REPO / NUSC_CFG), "--data_path", str(root),
                            "--epochs", "1", "--fix_random_seed", "--output_dir", str(out),
                            "--set", "OPTIMIZATION.LR", str(ROUND_LR), *split],
                           stage_times=True)
    train_s = time.perf_counter() - t0
    train_launches = dict(counts)
    hist = state.history
    check_history(np, hist, "nuscenes_boston train")
    counts = reset_fps_counts()
    t0 = time.perf_counter()
    annos, _ = test_cli.main(["--cfg_file", str(REPO / NUSC_CFG), "--ckpt_dir",
                              str(out / "ckpt"), "--data_path", str(root), "--output_dir",
                              str(out / "test"), "--set", *split[2:]])
    test_s = time.perf_counter() - t0
    test_launches = dict(counts)
    check_result(np, annos, ids, "nuscenes_boston cli/test.py")
    batch = int(train_cli.load_model_config(REPO / NUSC_CFG).OPTIMIZATION.BATCH_SIZE_PER_GPU)
    test_batches = -(-len(ids) // batch)
    loaded = sorted(m for m in ("yaml",) if m in set(sys.modules) - before)
    emit({"phase": "nuscenes_boston", "points_per_scan": NUSC_POINTS, "steps": len(hist),
          "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[0]["end_s"]) / max(len(hist) - 1, 1),
          "train_seconds": train_s, "test_seconds": test_s, "test_frames": len(annos),
          "test_detections": int(sum(len(a["score"]) for a in annos)),
          "fps_kernel_launches": train_launches, "test_fps_kernel_launches": test_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "modules_loaded": loaded,
          "batch": batch, "card": card})
    if len(hist) != NUSC_SCANS // batch:
        fail(f"nuscenes_boston train: {len(hist)} steps")
    if loaded:
        fail(f"nuscenes_boston loaded {loaded}")
    want = {"fps_cluster_kernel": 3 * len(hist), "fps_warp_kernel": 3 * len(hist)}
    if train_launches != want:
        fail(f"nuscenes_boston train: fps launches {train_launches}, not {want}")
    want = {"fps_cluster_kernel": 3 * test_batches, "fps_warp_kernel": 3 * test_batches}
    if test_launches != want:
        fail(f"nuscenes_boston cli/test.py: fps launches {test_launches}, not {want}")
    return train_launches, len(hist), test_launches, test_batches


def one_cycle_early_lr(opt, epochs: int) -> float:
    """The rate the config's one-cycle reaches after its first ``epochs``
    epochs (of NUM_EPOCHS): it warms from LR / DIV_FACTOR to LR by a cosine
    over PCT_START of the epochs; a smoke that trains ``epochs`` squeezed
    into its steps peaks there."""
    warm = float(opt.PCT_START) * int(opt.NUM_EPOCHS)
    lo = float(opt.LR) / float(opt.DIV_FACTOR)
    return lo + (float(opt.LR) - lo) * (1 - math.cos(math.pi * min(epochs / warm, 1.0))) / 2


def phase_kitti_dataset(root, card):
    """KITTI_SCANS synthetic scans of Car, Pedestrian and Cyclist objects at
    KITTI's sizes (tools/synth_kitti.py ``kitti_classes``), their infos and
    the 3-class gt database."""
    import numpy as np

    from modest_tpu_torch.configs import KITTI_CLASS_NAMES, KITTI_CONFIGS
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
    from modest_tpu_torch.tools.synth_kitti import make_dataset
    from modest_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    boxes = make_dataset(root, n_train=KITTI_SCANS, n_val=0, seed=0, full_density=True,
                         kitti_classes=True)
    create_kitti_infos(Config(KITTI_CONFIGS["second"]).DATA_CONFIG, KITTI_CLASS_NAMES, root,
                       root, if_val=False)
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    emit({"phase": "kitti_dataset", "scans": KITTI_SCANS,
          "objects": sum(len(b) for b in boxes.values()),
          "gt_database_objects": {k: len(v) for k, v in db.items()},
          "seconds": time.perf_counter() - t0, "card": card})
    if set(db) != set(KITTI_CLASS_NAMES):
        fail(f"kitti dataset: the gt database holds {sorted(db)}")


def kitti_config(stem, root):
    """A KITTI config (its shipped dict) on the synthetic set, its test split
    the training scans."""
    cfg = shipped_config(KITTI_CFG.format(stem), root)
    cfg.DATA_CONFIG.DATA_SPLIT.test = "train"
    cfg.DATA_CONFIG.INFO_PATH.test = ["kitti_infos_train.pkl"]
    return cfg


def expected_fps(stem, runs: int) -> dict:
    cluster, warp = KITTI_FPS.get(stem, (0, 0))
    return {"fps_cluster_kernel": cluster * runs, "fps_warp_kernel": warp * runs}


def phase_kitti_forward(torch, np, api, build_network, stem, root, dev, card):
    """One KITTI model at full width, B = 4 of the synthetic scans: the
    timed eval forwards (``timed_forwards``) with their FPS launches, then
    for the routes this slice ports one scan card vs CPU: PointRCNN and
    PartA2_free by ``forward_chain``, PV-RCNN by ``pv_forward_chain``,
    SECOND and its multi-head config by ``phase_grid_card_vs_cpu``."""
    from modest_tpu_torch.models import part_a2
    from modest_tpu_torch.ops import pointnet2 as p2

    cfg = kitti_config(stem, root)
    ds, batch = grid_batch(torch, cfg, dev)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0, dataset=ds)
    if cfg.MODEL.NAME == "PointRCNN":
        # the point heads' random statistics as the flagship's. With the batch's
        # own (calibrate_grid_model) one channel of SA1's first batch norm reads
        # a variance of 0 on these scans (|mean| / std 1.6e4, gain 1/sqrt(eps)):
        # float32 on either device then parts from float64 as far as the two
        # part from each other, past the chain's limits, with every ball query
        # alike (tools/train_probe.py bn_gap, PERF.md §6)
        randomise_bn(torch, model, seed=0)
    else:
        calibrate_grid_model(torch, api, model, cfg.MODEL, batch)
    counts = reset_fps_counts()
    row, _ = timed_forwards(torch, api, model, cfg.MODEL, batch["points"], KITTI_TIMED_ITERS,
                            f"kitti {stem}")
    launches = dict(counts)
    route = ("grouped head" if getattr(model, "use_multihead", False) else
             "anchor-free" if stem == "PartA2_free" else
             "point" if cfg.MODEL.NAME == "PointRCNN" else "one head")
    emit({"phase": "kitti_forward", "model": stem, "route": route,
          "classes": list(cfg.CLASS_NAMES), "anchors": int(getattr(model, "anchors",
                                                                      torch.zeros(0)).shape[0]),
          **row, "fps_kernel_launches": launches, "card": card})
    want = expected_fps(stem, KITTI_TIMED_ITERS + 1)
    if launches != want:
        fail(f"kitti {stem}: {KITTI_TIMED_ITERS + 1} forwards launched fps {launches}, not {want}")
    if stem in ("second", "second_multihead"):
        phase_grid_card_vs_cpu(torch, np, api, build_network, f"kitti_{stem}", cfg, ds, model,
                               batch, card)
    elif stem == "pv_rcnn":
        phase_pv_card_vs_cpu(torch, np, api, build_network, cfg, ds, model, batch, card)
    elif stem in ("pointrcnn", "PartA2_free"):
        cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu", dataset=ds)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        free = stem == "PartA2_free"
        t0 = time.perf_counter()
        chain, got, want_final = forward_chain(
            torch, np, model, cpu_model, cfg.MODEL, batch["points"][:1].cpu(),
            module=part_a2 if free else None,
            choices=((part_a2, "roiaware_cells"),) if free else ((p2, "ball_query_from_dist2"),))
        match = match_finals(np, got, want_final)
        emit({"phase": "kitti_card_vs_cpu", "model": stem, **match, **chain,
              "chain_s": time.perf_counter() - t0, "card": card})
        check_chain(chain, match["match_frac"],
                    match["card_detections"] + match["cpu_detections"],
                    f"kitti {stem} card vs CPU", parted=bool(chain.get("decisions_differ")))
    del model
    torch.cuda.empty_cache()
    return launches


def phase_kitti_train(torch, np, dev, root, stem, card):
    """cli/train.py on one KITTI config at full width and its batch for whole
    epochs of at least KITTI_TRAIN_STEPS steps over the synthetic scans,
    peaking at ``one_cycle_early_lr`` of the smoke's epochs: every loss
    finite, the FPS launches the steps take; then cli/test.py on its
    checkpoint over the training scans at the config's batch, each scan
    once with finite boxes, and its FPS launches. Returns the launches of
    training and of the test, and the steps."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    cfg = kitti_config(stem, root)
    cfg_file = str(REPO / KITTI_CFG.format(stem))
    out = root / f"kitti_{stem}"
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    per_epoch = KITTI_SCANS // batch
    epochs = -(-KITTI_TRAIN_STEPS // per_epoch)
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, epochs)
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", cfg_file, "--data_path", str(root), "--epochs",
                            str(epochs), "--fix_random_seed", "--output_dir", str(out),
                            "--set", "OPTIMIZATION.LR", str(lr)], stage_times=True)
    seconds = time.perf_counter() - t0
    launches = dict(counts)
    hist = state.history
    if len(hist) != epochs * per_epoch:
        fail(f"kitti {stem} train: {len(hist)} steps, not {epochs * per_epoch}")
    check_history(np, hist, f"kitti {stem} train")
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    counts = reset_fps_counts()
    t0 = time.perf_counter()
    annos, _ = test_cli.main(["--cfg_file", cfg_file, "--ckpt_dir", str(out / "ckpt"),
                              "--data_path", str(root), "--output_dir", str(out / "test"),
                              "--workers", "0", "--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
                              "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]"])
    test_s = time.perf_counter() - t0
    test_launches = dict(counts)
    test_batches = -(-KITTI_SCANS // batch)
    check_result(np, annos, (root / "ImageSets" / "train.txt").read_text().split(),
                 f"kitti {stem} cli/test.py")
    emit({"phase": "kitti_train", "model": stem, "batch": batch, "steps": len(hist),
          "epochs": epochs, "lr": lr, "losses": [{"step": r["step"], **r["metrics"]}
                                                 for r in hist],
          "scans_per_s": batch * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "stage_ms": stage_ms, "fps_kernel_launches": launches, "peak_mem_gb": train_peak,
          "cli_seconds": seconds, "test_seconds": test_s, "test_batches": test_batches,
          "test_detections": int(sum(len(a["score"]) for a in annos)),
          "test_fps_kernel_launches": test_launches, "card": card})
    want = expected_fps(stem, len(hist))
    if launches != want:
        fail(f"kitti {stem} train: fps launches {launches}, not {want}")
    if test_launches != expected_fps(stem, test_batches):
        fail(f"kitti {stem} cli/test.py: {test_batches} batches launched fps {test_launches}")
    return launches, test_launches, len(hist)


def phase_nuscenes_dataset(torch, np, root, card):
    """The nuScenes tree (tools/synth_infos.py ``full_density``) under
    ``root``/v1.0-trainval, its gt database, and both loaders of the CBGS
    SECOND dict: CBGS resampling's train samples, the batch shapes (65536
    5-feature points; gt of width 10 with the velocity, no NaN left)."""
    from modest_tpu_torch import configs
    from modest_tpu_torch.data.loader import build_dataloader
    from modest_tpu_torch.tools import synth_infos

    t0 = time.perf_counter()
    tree = root / configs.NUSCENES_DATASET_BASE["VERSION"]
    np.random.seed(0)
    infos = synth_infos.write_nuscenes_tree(tree, CBGS_TRAIN_FRAMES,
                                            rng=np.random.RandomState(0), full_density=True,
                                            n_val=CBGS_VAL_FRAMES)
    db_file = synth_infos.nuscenes_gt_database(tree, configs.NUSCENES_DATASET_BASE,
                                               configs.CBGS_CLASS_NAMES,
                                               "nuscenes_infos_train_10sweeps_withvelo.pkl")
    with open(db_file, "rb") as f:
        db = pickle.load(f)
    written = time.perf_counter() - t0
    cfg = shipped_config(CBGS_CFG.format(CBGS_MODELS[0]), root)
    row = {"phase": "nuscenes_dataset", "train_frames": CBGS_TRAIN_FRAMES,
           "val_frames": CBGS_VAL_FRAMES, "sweeps": len(infos[0]["sweeps"]) + 1,
           "keyframe_points": [(tree / i["lidar_path"]).stat().st_size // 20 for i in infos],
           "gt_per_frame": [len(i["gt_names"]) for i in infos],
           "nan_velocities": int(sum(np.isnan(i["gt_boxes"][:, 7]).sum() for i in infos)),
           "gt_database_objects": {k: len(v) for k, v in db.items()}, "write_s": written}
    for training in (True, False):
        np.random.seed(0)
        t1 = time.perf_counter()
        ds, batch = grid_batch(torch, cfg, "cpu", CBGS_BATCH, training=training)
        mode = "train" if training else "test"
        gt = batch["gt_boxes"].numpy()
        gt = gt[np.abs(gt).sum(-1) > 0]
        row[f"{mode}_samples"] = len(ds)
        row[f"{mode}_batch"] = {"points": list(batch["points"].shape),
                                "gt_boxes": list(batch["gt_boxes"].shape),
                                "classes": sorted({int(c) for c in gt[:, -1]}),
                                "moving": int((np.abs(gt[:, 7:9]).sum(1) > 0).sum()),
                                "seconds": time.perf_counter() - t1}
        if (tuple(batch["points"].shape) != (CBGS_BATCH, 65536, 5)
                or batch["gt_boxes"].shape[-1] != 10 or not np.isfinite(gt).all()):
            fail(f"nuscenes {mode} batch: points {tuple(batch['points'].shape)}, gt "
                 f"{tuple(batch['gt_boxes'].shape)}, finite {bool(np.isfinite(gt).all())}")
    row.update(seconds=time.perf_counter() - t0, card=card)
    emit(row)


def phase_cbgs_train(torch, np, dev, root, stem, card):
    """cli/train.py on one CBGS config, from its dict at its B = 4, for one
    epoch of the loader's resampled train samples, peaking at the rate the
    config's first epoch reaches: every loss finite. Then cli/test.py on its
    checkpoint over the val frames: the SDK-free nuScenes evaluation's
    mAP and NDS and the BEV AP table."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    cfg_file = str(REPO / CBGS_CFG.format(stem))
    cfg = shipped_config(CBGS_CFG.format(stem), root)
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, 1)
    out = root / stem
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", cfg_file, "--data_path", str(root), "--epochs", "1",
                            "--fix_random_seed", "--output_dir", str(out),
                            "--set", "OPTIMIZATION.LR", str(lr)], stage_times=True)
    seconds = time.perf_counter() - t0
    hist = state.history
    if len(hist) < 3:
        fail(f"{stem} train: {len(hist)} steps")
    check_history(np, hist, f"{stem} train")
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    annos, results = test_cli.main(["--cfg_file", cfg_file, "--ckpt_dir", str(out / "ckpt"),
                                    "--data_path", str(root), "--output_dir",
                                    str(out / "test"), "--workers", "0"])
    test_s = time.perf_counter() - t0
    emit({"phase": "cbgs_train", "model": stem, "batch": CBGS_BATCH, "steps": len(hist),
          "lr": lr, "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": CBGS_BATCH * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "stage_ms": stage_ms, "peak_mem_gb": train_peak, "cli_seconds": seconds,
          "test_seconds": test_s, "test_frames": len(annos),
          "test_detections": int(sum(len(a["score"]) for a in annos)),
          "nuscenes_eval": {k: v for k, v in results.items()
                            if k in ("mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE")},
          "card": card})
    if len(annos) != CBGS_VAL_FRAMES or not {"mAP", "NDS"} <= set(results):
        fail(f"{stem} cli/test.py: {len(annos)} frames, results {sorted(results)}")
    if any(a["boxes_lidar"].shape[-1] != 9 or not np.isfinite(a["boxes_lidar"]).all()
           for a in annos):
        fail(f"{stem} cli/test.py: boxes not finite (N, 9)")


def phase_nuscenes_cbgs(torch, np, api, build_network, dev, card):
    """The CBGS grouped heads (10 classes in 6 groups, the 9-code (cos, sin)
    coder, SECOND's on VoxelResBackBone8x) fed by the nuScenes loader:
    KITTI_TIMED_ITERS timed eval forwards + multi-class post-processing of
    the test batch at B = 4 (10 x NMS_POST_MAXSIZE slots a scan), one train
    forward and its losses on a train batch (velocity targets), card vs CPU
    as the grid detectors (``phase_grid_card_vs_cpu``), then cli/train.py
    and cli/test.py (``phase_cbgs_train``). No hand kernel: the FPS counts,
    set to 0 before, must read 0."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nuscenes_"))
    t0 = time.perf_counter()
    try:
        phase_nuscenes_dataset(torch, np, tmp, card)
        counts = reset_fps_counts()
        for stem in CBGS_MODELS:
            cfg = shipped_config(CBGS_CFG.format(stem), tmp)
            ds, batch = grid_batch(torch, cfg, dev, CBGS_BATCH)
            np.random.seed(1)
            _, train_batch = grid_batch(torch, cfg, dev, CBGS_BATCH, training=True)
            model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0,
                                  dataset=ds)
            calibrate_grid_model(torch, api, model, cfg.MODEL, batch)
            row, final = timed_forwards(torch, api, model, cfg.MODEL, batch["points"],
                                        KITTI_TIMED_ITERS, stem)
            out = api.apply_train(model, cfg.MODEL, train_batch["points"],
                                  train_batch["gt_boxes"])
            _, metrics = api.compute_loss(out, train_batch["gt_boxes"], cfg.MODEL,
                                          len(cfg.CLASS_NAMES))
            losses = {k: v.item() for k, v in metrics.items()}
            labels = out["box_cls_labels"]
            model.eval()
            if not all(math.isfinite(v) for v in losses.values()):
                fail(f"{stem}: non-finite train losses {losses}")
            nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
            slots = len(cfg.CLASS_NAMES) * int(nms.NMS_POST_MAXSIZE)
            if final["boxes"].shape[1:] != (slots, 9):
                fail(f"{stem}: final boxes {tuple(final['boxes'].shape)}, not (B, {slots}, 9)")
            emit({"phase": "cbgs_forward", "model": stem,
                  "grid_size": [int(v) for v in ds.grid_size],
                  "anchors": int(model.anchors.shape[0]), "slots_per_scan": slots, **row,
                  "train_losses": losses, "train_box_targets": int(out["box_reg_targets"]
                                                                   .shape[-1]),
                  "train_labels_by_class": torch.bincount(
                      labels.clamp_min(0).flatten(),
                      minlength=len(cfg.CLASS_NAMES) + 1).tolist(),
                  "card": card})
            phase_grid_card_vs_cpu(torch, np, api, build_network, stem, cfg, ds, model, batch,
                                   card)
            del model, out
            torch.cuda.empty_cache()
            phase_cbgs_train(torch, np, dev, tmp, stem, card)
            torch.cuda.empty_cache()
        if any(counts.values()):
            fail(f"the CBGS heads launched hand kernels {dict(counts)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "nuscenes_cbgs_seconds", "seconds": time.perf_counter() - t0, "card": card})


def phase_waymo_dataset(torch, np, root, card):
    """The processed Waymo tree (tools/synth_infos.py ``full_density``), the
    gt database the configs' gt sampling reads (every 10th train frame), and
    both loaders of the PV-RCNN dict: points (2, 131072, 5) with the NLZ
    points dropped, gt (2, M, 8)."""
    from modest_tpu_torch import configs
    from modest_tpu_torch.tools import synth_infos

    t0 = time.perf_counter()
    np.random.seed(0)
    infos = synth_infos.write_waymo_tree(root, WAYMO_TRAIN_FRAMES, rng=np.random.RandomState(0),
                                         full_density=True, n_val=WAYMO_VAL_FRAMES)
    db_file = synth_infos.waymo_gt_database(root, configs.WAYMO_DATASET_BASE,
                                            configs.WAYMO_CLASS_NAMES)
    with open(db_file, "rb") as f:
        db = pickle.load(f)
    written = time.perf_counter() - t0
    cfg = shipped_config(WAYMO_CFG.format("pv_rcnn"), root)
    raw = [np.load(root / "waymo_processed_data" / i["point_cloud"]["lidar_sequence"]
                   / f"{i['point_cloud']['sample_idx']:04d}.npy")
           for i in infos[::WAYMO_INTERVAL]]
    row = {"phase": "waymo_dataset", "train_frames": WAYMO_TRAIN_FRAMES,
           "val_frames": WAYMO_VAL_FRAMES, "sampled_interval": WAYMO_INTERVAL,
           "raw_points": [len(r) for r in raw],
           "points_outside_nlz": [int((r[:, 5] == -1).sum()) for r in raw],
           "gt_per_frame": [len(i["annos"]["name"]) for i in infos[::WAYMO_INTERVAL]],
           "gt_database_objects": {k: len(v) for k, v in db.items()}, "write_s": written}
    for training in (True, False):
        np.random.seed(0)
        t1 = time.perf_counter()
        ds, batch = grid_batch(torch, cfg, "cpu", WAYMO_BATCH, training=training)
        mode = "train" if training else "test"
        row[f"{mode}_samples"] = len(ds)
        row[f"{mode}_batch"] = {"points": list(batch["points"].shape),
                                "gt_boxes": list(batch["gt_boxes"].shape),
                                "seconds": time.perf_counter() - t1}
        if (tuple(batch["points"].shape) != (WAYMO_BATCH, 131072, 5)
                or batch["gt_boxes"].shape[-1] != 8):
            fail(f"waymo {mode} batch: points {tuple(batch['points'].shape)}, gt "
                 f"{tuple(batch['gt_boxes'].shape)}")
    row.update(seconds=time.perf_counter() - t0, card=card)
    emit(row)


def phase_waymo_train(torch, np, dev, root, stem, card):
    """cli/train.py on one Waymo config from its dict at full width and its
    batch for whole epochs of at least WAYMO_TRAIN_STEPS steps, at the rate
    the config's first epochs reach; then cli/test.py on its checkpoint under
    EVAL_METRIC kitti and waymo (``--set``): the R40 AP table and the AP/APH
    LEVEL_1/2 table. FPS launches a step and a test batch: WAYMO_FPS. Returns
    the FPS launches of training, the steps, and the cluster kernel's
    launches in each test."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    cfg_file = str(REPO / WAYMO_CFG.format(stem))
    cfg = shipped_config(WAYMO_CFG.format(stem), root)
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    per_epoch = WAYMO_TRAIN_FRAMES // WAYMO_INTERVAL // batch
    epochs = -(-WAYMO_TRAIN_STEPS // per_epoch)
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, epochs)
    out = root / f"waymo_{stem}"
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", cfg_file, "--data_path", str(root), "--epochs",
                            str(epochs), "--fix_random_seed", "--output_dir", str(out),
                            "--set", "OPTIMIZATION.LR", str(lr)], stage_times=True)
    seconds = time.perf_counter() - t0
    train_launches = dict(counts)
    hist = state.history
    steps = epochs * per_epoch
    if len(hist) != steps:
        fail(f"waymo {stem} train: {len(hist)} steps, not {steps}")
    check_history(np, hist, f"waymo {stem} train")
    timed = hist[2:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    per_forward = WAYMO_FPS.get(stem, 0)
    test_batches = -(-WAYMO_VAL_FRAMES // WAYMO_INTERVAL // batch)
    tests, test_launches = {}, {}
    for metric in ("kitti", "waymo"):
        counts = reset_fps_counts()
        t1 = time.perf_counter()
        annos, results = test_cli.main(["--cfg_file", cfg_file, "--ckpt_dir", str(out / "ckpt"),
                                        "--data_path", str(root), "--output_dir",
                                        str(out / f"test_{metric}"), "--workers", "0",
                                        "--set", "DATA_CONFIG.EVAL_METRIC", metric])
        test_launches[metric] = dict(counts)
        ap = {k: v for k, v in results.items() if k not in ("recall", "sec_per_example",
                                                             "steady_sec_per_example")}
        tests[metric] = {"frames": len(annos), "seconds": time.perf_counter() - t1,
                         "detections": int(sum(len(a["score"]) for a in annos)), "ap": ap}
        want_key = ("Vehicle_bev_iou0.7_R40" if metric == "kitti"
                    else "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/APH")
        if len(annos) != WAYMO_VAL_FRAMES // WAYMO_INTERVAL or want_key not in ap:
            fail(f"waymo {stem} cli/test.py ({metric}): {len(annos)} frames, {sorted(ap)}")
    emit({"phase": f"waymo_{stem}_train", "model": stem, "batch": batch, "steps": len(hist),
          "epochs": epochs, "lr": lr, "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "scans_per_s": batch * len(timed) / (hist[-1]["end_s"] - hist[1]["end_s"]),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[1]["end_s"]) / len(timed),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "forward_ms": sum(stage_ms[k] for k in state.model.stages), "stage_ms": stage_ms,
          "peak_mem_gb": train_peak, "cli_seconds": seconds, "fps_kernel_launches": train_launches,
          "tests": tests, "test_batches": test_batches,
          "test_fps_kernel_launches": test_launches, "card": card})
    want = {"fps_cluster_kernel": per_forward * steps, "fps_warp_kernel": 0}
    if train_launches != want:
        fail(f"waymo {stem} train: {steps} steps launched fps {train_launches}, not {want}")
    for metric, launches in test_launches.items():
        if launches != {"fps_cluster_kernel": per_forward * test_batches, "fps_warp_kernel": 0}:
            fail(f"waymo {stem} cli/test.py ({metric}): {test_batches} batches launched fps "
                 f"{launches}")
    return train_launches, len(hist), {m: n["fps_cluster_kernel"] for m, n in
                                       test_launches.items()}


def phase_waymo(torch, np, api, build_network, dev, card):
    """Waymo's three configs on the synthetic tree: the dataset and loaders;
    PV-RCNN's forward at B = 2 x 131072 (``phase_pv_forward``: one FPS
    launch a forward, its indices equal to the plain FPS's), the share of
    occupied voxels the 16000-voxel cap keeps, card vs CPU, training and
    cli/test.py; then SECOND and Part-A2 at B = 2 with their card vs CPU
    chains, training and cli/test.py (no FPS). Returns the FPS launches of
    PV-RCNN's paths."""
    from modest_tpu_torch.models.grid_detectors import MAX_VOXELS
    from modest_tpu_torch.models.voxelize import voxel_counts

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_waymo_"))
    t0 = time.perf_counter()
    try:
        phase_waymo_dataset(torch, np, tmp, card)
        cfg = shipped_config(WAYMO_CFG.format("pv_rcnn"), tmp)
        ds, batch = grid_batch(torch, cfg, dev, WAYMO_BATCH)
        model, forward_row = phase_pv_forward(torch, np, api, build_network, cfg, ds, batch,
                                              card, phase="waymo_pv_rcnn_forward",
                                              iters=WAYMO_TIMED_ITERS)
        in_range, occupied, kept, dropped = voxel_counts(
            batch["points"], model.point_cloud_range, model.voxel_size, model.grid_size,
            MAX_VOXELS)
        emit({"phase": "waymo_voxel_cap", "max_voxels": MAX_VOXELS,
              "config_max_voxels": dict(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS),
              "grid_size": [int(v) for v in ds.grid_size],
              "points_in_range": in_range.tolist(), "occupied_voxels": occupied.tolist(),
              "kept_voxels": kept.tolist(),
              "kept_share": (kept.double() / occupied.double()).tolist(),
              "dropped_points": dropped.tolist(), "card": card})
        phase_pv_card_vs_cpu(torch, np, api, build_network, cfg, ds, model, batch, card,
                             phase="waymo_pv_rcnn_card_vs_cpu")
        del model
        torch.cuda.empty_cache()
        train = phase_waymo_train(torch, np, dev, tmp, "pv_rcnn", card)
        torch.cuda.empty_cache()
        counts = reset_fps_counts()
        for stem in ("second", "PartA2"):
            cfg = shipped_config(WAYMO_CFG.format(stem), tmp)
            ds, batch = grid_batch(torch, cfg, dev, WAYMO_BATCH)
            if stem == "second":
                model = phase_grid_forward(torch, np, api, build_network, "waymo_second", cfg,
                                           ds, batch, card)
                phase_grid_card_vs_cpu(torch, np, api, build_network, "waymo_second", cfg, ds,
                                       model, batch, card)
                del model
            else:
                phase_two_stage_forward(torch, np, api, build_network, "waymo_PartA2", cfg, ds,
                                        batch, card)
            torch.cuda.empty_cache()
            phase_waymo_train(torch, np, dev, tmp, stem, card)
            torch.cuda.empty_cache()
        emit({"phase": "waymo_grid", "models": ["second", "PartA2"], "batch": WAYMO_BATCH,
              "fps_kernel_launches": dict(counts), "card": card})
        if any(counts.values()):
            fail(f"Waymo SECOND and Part-A2 launched hand kernels {dict(counts)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "waymo_seconds", "seconds": time.perf_counter() - t0, "card": card})
    return forward_row, train


def phase_kitti(torch, np, api, build_network, dev, card):
    """KITTI's 3-class configs: the dataset, then per model its forward (card
    vs CPU for the multi-class and anchor-free routes), its training and
    cli/test.py. Returns by model the FPS launches of the forwards, of the
    trainings and of the tests, and the train steps."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_kitti_"))
    forward_launches, train_launches, test_launches, steps = {}, {}, {}, {}
    t0 = time.perf_counter()
    try:
        phase_kitti_dataset(tmp, card)
        for stem in KITTI_MODELS:
            forward_launches[stem] = phase_kitti_forward(torch, np, api, build_network, stem,
                                                         tmp, dev, card)
            torch.cuda.empty_cache()
            train_launches[stem], test_launches[stem], steps[stem] = phase_kitti_train(
                torch, np, dev, tmp, stem, card)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "kitti_seconds", "seconds": time.perf_counter() - t0, "card": card})
    return forward_launches, train_launches, test_launches, steps


def phase_caddn_dataset(root, card):
    """CADDN_SCANS synthetic full-density 3-class KITTI scans with real-pixel
    images (tools/synth_kitti.py ``pixels``), their infos; the PNG decode time
    an image, a written array read back equal, and the camera items' shapes
    and depth returns from the CaDDN dict's test-mode dataset."""
    import numpy as np

    from modest_tpu_torch.configs import KITTI_CLASS_NAMES, KITTI_CONFIGS
    from modest_tpu_torch.data.kitti_dataset import KittiDataset, create_kitti_infos
    from modest_tpu_torch.tools.synth_kitti import IMG_SHAPE, make_dataset
    from modest_tpu_torch.utils import native
    from modest_tpu_torch.utils.config import Config
    from modest_tpu_torch.utils.png import read_png_rgb, write_png

    t0 = time.perf_counter()
    boxes = make_dataset(root, n_train=CADDN_SCANS, n_val=0, seed=0, full_density=True,
                         kitti_classes=True, pixels=True)
    create_kitti_infos(Config(KITTI_CONFIGS["CaDDN"]).DATA_CONFIG, KITTI_CLASS_NAMES, root, root,
                       if_val=False)
    seconds = time.perf_counter() - t0
    images = sorted((root / "training" / "image_2").iterdir())
    t0 = time.perf_counter()
    decoded = [read_png_rgb(p) for p in images]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    pix = np.random.RandomState(1).randint(0, 256, (*IMG_SHAPE, 3)).astype(np.uint8)
    write_png(root / "written.png", pix)
    round_trip = bool(np.array_equal(read_png_rgb(root / "written.png"), pix))
    cfg = kitti_config("CaDDN", root)
    ds = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    samples = [ds[i] for i in range(len(ds))]
    shapes = {key: sorted({tuple(s[key].shape) for s in samples})
              for key in ("images", "depth_maps", "trans_lidar_to_cam", "trans_cam_to_img")}
    nonzero = [int((s["depth_maps"] > 0).sum()) for s in samples]
    emit({"phase": "caddn_dataset", "scans": CADDN_SCANS,
          "objects": sum(len(b) for b in boxes.values()), "image_shape": list(IMG_SHAPE),
          "decoded_shape": list(decoded[0].shape), "png_decode_ms_per_image": decode_ms,
          "png_host_unfilter": native.available(), "written_array_read_back_equal": round_trip,
          "item_shapes": {k: [list(v) for v in vals] for k, vals in shapes.items()},
          "depth_nonzero_per_map": nonzero, "depth_map_cells": 96 * 312,
          "grid_size": [int(v) for v in ds.grid_size], "seconds": seconds, "card": card})
    if not round_trip:
        fail("caddn dataset: a written PNG reads back other pixels")
    if shapes != {"images": [(384, 1248, 3)], "depth_maps": [(96, 312)],
                  "trans_lidar_to_cam": [(4, 4)], "trans_cam_to_img": [(3, 4)]}:
        fail(f"caddn dataset: item shapes {shapes}")
    if min(nonzero) == 0 or [int(v) for v in ds.grid_size] != [280, 376, 25]:
        fail(f"caddn dataset: depth returns {nonzero}, grid {ds.grid_size}")


def calibrate_caddn(torch, api, model, cfg, inputs, gt_boxes):
    """Random CaDDN weights made to score like a detector: every batch
    norm's running statistics from one train-mode pass over the batch
    (momentum 1, the ASPP's dropout drawn from a seeded generator), then the
    class head's bias moved so that the batch's median logit per anchor
    channel is GRID_EMPTY_LOGIT."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        api.apply_train(model, cfg, inputs, gt_boxes,
                        dropout=torch.Generator(device=gt_boxes.device).manual_seed(0))
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    logits = []
    hook = model.dense_head.conv_cls.register_forward_hook(
        lambda m, i, out: logits.append(out))
    api.apply_eval(model, cfg, inputs)
    hook.remove()
    with torch.no_grad():
        med = logits[0].transpose(0, 1).flatten(1).median(dim=1).values
        model.dense_head.conv_cls.bias -= med - GRID_EMPTY_LOGIT
    model.eval()


def phase_caddn_forward(torch, np, api, build_network, stem, root, dev, card):
    """One CaDDN dict at full width, B = 4 from ``build_dataloader``:
    ``timed_forwards`` (scans/s, stage ms by CUDA events from the DDN's
    backbone, ASPP and head or the compact encoder to the post NMS, peak
    memory). Returns (model, dataset, batch)."""
    from modest_tpu_torch.train.loop import model_inputs

    cfg = kitti_config(stem, root)
    ds, batch = grid_batch(torch, cfg, dev, CADDN_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev, seed=0, dataset=ds)
    calibrate_caddn(torch, api, model, cfg.MODEL, model_inputs(batch, cfg.MODEL),
                    batch["gt_boxes"])
    calibrate_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    inputs = model_inputs(batch, cfg.MODEL, eval_mode=True)
    row, _ = timed_forwards(torch, api, model, cfg.MODEL, inputs, CADDN_TIMED_ITERS,
                            f"caddn {stem}")
    if model.ddn is not None:
        row["aspp_conv_ms"] = aspp_conv_ms(torch, model, inputs["images"])
    emit({"phase": "caddn_forward", "model": stem, "grid_size": [int(v) for v in ds.grid_size],
          "depth_bins": model.num_bins, "anchors": int(model.anchors.shape[0]),
          "voxels_per_scan": int(model.centers.shape[0]),
          "parameters": sum(p.numel() for p in model.parameters()), **row,
          "train_mode_calibration_peak_mem_gb": calibrate_peak, "card": card})
    return model, ds, batch


def aspp_conv_ms(torch, model, images):
    """Each ASPP branch's conv (the 1 x 1, the 3 x 3s at rates 12, 24, 36)
    and the projection on the batch's layer4 map (B, 2048, H/8, W/8), timed
    by CUDA events on cuDNN as PyTorch picks its algorithm and with cuDNN
    off (im2col and a GEMM): which shapes take a slow route. Measures only;
    the DDN runs on cuDNN."""
    from modest_tpu_torch.utils.device import device_ms

    aspp = model.ddn.classifier[0]
    with torch.inference_mode():
        _, y = model.ddn.backbone(images.permute(0, 3, 1, 2))
        outs = [branch(y) for branch in aspp.convs]
        cat = torch.cat([*outs[:-1], outs[-1].expand_as(outs[0])], dim=1)
        convs = [(f"conv{i}_rate{branch[0].dilation[0]}_{tuple(branch[0].kernel_size)}",
                  branch[0], y) for i, branch in enumerate(aspp.convs[:4])]
        convs.append(("project_1x1", aspp.project[0], cat))
        out = {"input_shape": list(y.shape)}
        for name, conv, x in convs:
            on = device_ms(lambda: conv(x), x.device, 3)
            with torch.backends.cudnn.flags(enabled=False):
                off = device_ms(lambda: conv(x), x.device, 3)
            out[name] = {"cudnn_ms": on, "cudnn_off_ms": off}
    return out


def caddn_stages(torch, model, inputs):
    """An eval forward's stage outputs: depth probabilities, the frustum,
    the lift (u, v, depth bin), the sampled voxels, the BEV map and the head's
    outputs (decoded boxes included)."""
    from modest_tpu_torch.models.caddn import sample_frustum

    model.eval()
    with torch.inference_mode():
        feats, logits = model.image_features(inputs["images"])
        frustum = model.frustum(feats, logits)
        lift = model.lift(inputs["trans_lidar_to_cam"], inputs["trans_cam_to_img"])
        vox = sample_frustum(frustum, *lift)
        bev = model.bev_map(vox)
        out = model.head(model.backbone_2d(bev))
        probs = torch.softmax(logits, dim=1)[:, :model.num_bins]
    return {"feats": feats, "probs": probs, "frustum": frustum, "lift": lift, "vox": vox,
            "bev": bev, "out": out}


def lift_cells(torch, frustum_shape, lift):
    """Each voxel's cell (u0, v0, d0) in a frustum of ``frustum_shape`` (B,
    H', W', D, C) as ``sample_frustum`` floors it, and whether it is in view;
    (B, N, 3) and (B, N)."""
    u, v, db = lift
    _, h, w, d, _ = frustum_shape
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (db >= 0) & (db <= d - 1)
    cells = torch.stack([torch.floor(torch.clamp(u, 0.0, w - 1 - 1e-4)),
                         torch.floor(torch.clamp(v, 0.0, h - 1 - 1e-4)),
                         torch.floor(torch.clamp(db, 0.0, d - 1 - 1e-4))], -1)
    return cells, inb


def phase_caddn_card_vs_cpu(torch, np, api, build_network, stem, cfg, ds, model, batch, card):
    """The same weights on the card and on the CPU, one scan (B = 1), stage
    by stage: the depth probabilities; the lift (cells and views that part);
    the sample with the card's frustum and lift handed to the CPU; the BEV
    map from the card's sample; the head from the card's BEV map (the grid
    chain's limits) and the CPU's NMS on the card's dense outputs; the final
    boxes end to end (1:1 >= MIN_BOX_MATCH, or parted only where the CPU's
    own dense outputs made its NMS keep other boxes)."""
    from modest_tpu_torch.models.caddn import sample_frustum
    from modest_tpu_torch.train.loop import model_inputs

    t0 = time.perf_counter()
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu", dataset=ds)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    inputs = {k: v[:1] for k, v in model_inputs(batch, cfg.MODEL, eval_mode=True).items()}
    card_st = caddn_stages(torch, model, inputs)
    cpu_st = caddn_stages(torch, cpu_model, {k: v.cpu() for k, v in inputs.items()})
    to_cpu = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else
                  {kk: vv.cpu() for kk, vv in v.items() if torch.is_tensor(vv)}
                  if isinstance(v, dict) else v.cpu()) for k, v in card_st.items()}

    prob_err = float((to_cpu["probs"] - cpu_st["probs"]).abs().max())
    shape = cpu_st["frustum"].shape
    (c_cells, c_in), (p_cells, p_in) = (lift_cells(torch, shape, to_cpu["lift"]),
                                        lift_cells(torch, shape, cpu_st["lift"]))
    in_view = c_in | p_in
    parted = ((c_cells != p_cells).any(-1) & in_view) | (c_in != p_in)
    cell_share = float(parted.sum()) / max(int(in_view.sum()), 1)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    with torch.inference_mode():
        given_vox = sample_frustum(to_cpu["frustum"], *to_cpu["lift"])
        given_bev = cpu_model.bev_map(to_cpu["vox"])
        given_out = cpu_model.head(cpu_model.backbone_2d(to_cpu["bev"]))
    sample_err, bev_err = rel(given_vox, to_cpu["vox"]), rel(given_bev, to_cpu["bev"])
    feats_err, bev_own_err = rel(to_cpu["feats"], cpu_st["feats"]), rel(to_cpu["bev"],
                                                                         cpu_st["bev"])
    vox_scale = float(cpu_st["vox"].abs().max())
    vox_parted = float(((to_cpu["vox"] - cpu_st["vox"]).abs() > 1e-3 * vox_scale).any(-1)
                       .float().mean())
    limits = (("cls_preds", MATCH_SCORE), ("box_preds", MATCH_SIZE), ("dir_cls_preds", MATCH_SCORE))
    dense_tol = max(float(((to_cpu["out"][k] - given_out[k]).abs()
                           / (atol + FORWARD_RTOL * given_out[k].abs())).max())
                    for k, atol in limits)
    # the same measure on each device's own dense outputs, end to end (reported)
    dense_tol_own = max(float(((to_cpu["out"][k] - cpu_st["out"][k]).abs()
                               / (atol + FORWARD_RTOL * cpu_st["out"][k].abs())).max())
                        for k, atol in limits)
    post = model.model_cfg.POST_PROCESSING
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in api.post_process(card_st["out"], cfg.MODEL).items()
               if v is not None}
        given = api.post_process(to_cpu["out"], cfg.MODEL)
        want = api.post_process(cpu_st["out"], cfg.MODEL)
    chain = {"dense_tol_used": dense_tol,
             "finals_given_card_dense": match_finals(np, got, given)["match_frac"],
             "cpu_finals_own_dense": match_finals(np, given, want)["match_frac"]}
    match = match_finals(np, got, want)
    emit({"phase": "caddn_card_vs_cpu", "model": stem, "depth_prob_max_abs_err": prob_err,
          "depth_prob_atol": CADDN_PROB_ATOL, "lift_cells_parted_share": cell_share,
          "lift_cells_in_view": int(in_view.sum()), "cell_share_limit": CADDN_CELL_SHARE,
          "sample_given_card_rel_err": sample_err, "bev_given_card_rel_err": bev_err,
          "sample_rtol": CADDN_SAMPLE_RTOL, "features_end_to_end_rel_err": feats_err,
          "bev_end_to_end_rel_err": bev_own_err, "voxels_parted_end_to_end_share": vox_parted,
          "score_thresh": float(post.SCORE_THRESH), "dense_tol_end_to_end": dense_tol_own,
          **chain, **match,
          "chain_s": time.perf_counter() - t0, "card": card})
    if prob_err > CADDN_PROB_ATOL or cell_share > CADDN_CELL_SHARE:
        fail(f"caddn {stem} card vs CPU: depth probabilities {prob_err} (limit "
             f"{CADDN_PROB_ATOL}), lift cells parted {cell_share} (limit {CADDN_CELL_SHARE})")
    if sample_err > CADDN_SAMPLE_RTOL or bev_err > CADDN_SAMPLE_RTOL:
        fail(f"caddn {stem} card vs CPU: with the card's inputs the sample parts by "
             f"{sample_err}, the BEV map by {bev_err} (limit {CADDN_SAMPLE_RTOL})")
    check_grid_chain(chain, match["match_frac"], match["card_detections"]
                     + match["cpu_detections"], f"caddn {stem} card vs CPU")


def phase_caddn_train(torch, np, dev, root, stem, card):
    """cli/train.py on one CaDDN dict at full width and its B = 4 for
    CADDN_TRAIN_EPOCHS epochs (4 steps) at the rate the config's first
    epochs reach: every loss finite, the depth loss among them; ms a step,
    data wait, stage split, peak memory. Then cli/test.py on its checkpoint
    over the training scans: every frame once, finite boxes, the KITTI AP
    table's numbers finite."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    cfg = kitti_config(stem, root)
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, CADDN_TRAIN_EPOCHS)
    out = root / f"caddn_{stem}"
    split = ["DATA_CONFIG.DATA_SPLIT.test", "train", "DATA_CONFIG.INFO_PATH.test",
             "[kitti_infos_train.pkl]"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg_file", str(REPO / KITTI_CFG.format(stem)), "--data_path",
                            str(root), "--epochs", str(CADDN_TRAIN_EPOCHS), "--fix_random_seed",
                            "--output_dir", str(out), "--set", "OPTIMIZATION.LR", str(lr)],
                           stage_times=True)
    seconds = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    hist = state.history
    steps = CADDN_SCANS // batch * CADDN_TRAIN_EPOCHS
    if len(hist) != steps:
        fail(f"caddn {stem} train: {len(hist)} steps, not {steps}")
    check_history(np, hist, f"caddn {stem} train")
    if any("depth_loss" not in r["metrics"] for r in hist):
        fail(f"caddn {stem} train: a step without its depth loss")
    timed = hist[1:]
    stage_ms = {k: sum(r["stage_ms"][k] for r in timed) / len(timed) for k in timed[0]["stage_ms"]}
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    annos, result = test_cli.main(["--cfg_file", str(REPO / KITTI_CFG.format(stem)),
                                   "--ckpt_dir", str(out / "ckpt"), "--data_path", str(root),
                                   "--output_dir", str(out / "test"), "--set", *split])
    test_s = time.perf_counter() - t0
    ids = (root / "ImageSets" / "train.txt").read_text().split()
    check_result(np, annos, ids, f"caddn {stem} cli/test.py")
    ap = {k: v for k, v in result.items() if isinstance(v, float) and k not in (
        "sec_per_example", "steady_sec_per_example")}
    emit({"phase": "caddn_train", "model": stem, "batch": batch, "steps": len(hist),
          "epochs": CADDN_TRAIN_EPOCHS, "lr": lr,
          "losses": [{"step": r["step"], **r["metrics"]} for r in hist],
          "timed_steps": len(timed),
          "step_ms_mean": 1e3 * (hist[-1]["end_s"] - hist[0]["end_s"]) / len(timed),
          "scans_per_s": batch * len(timed) / (hist[-1]["end_s"] - hist[0]["end_s"]),
          "data_wait_ms": sum(r["data_wait_ms"] for r in timed) / len(timed),
          "stage_ms": stage_ms, "peak_mem_gb": train_peak, "cli_seconds": seconds,
          "test_seconds": test_s, "test_frames": len(annos),
          "test_sec_per_example": result["sec_per_example"],
          "test_detections": int(sum(len(a["score"]) for a in annos)),
          "test_peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "kitti_ap_keys": len(ap), "kitti_ap_sample": dict(list(ap.items())[:6]),
          "card": card})
    if not ap or not all(np.isfinite(v) for v in ap.values()):
        fail(f"caddn {stem} cli/test.py: the KITTI table holds {ap}")


def phase_demo(torch, np, root, card):
    """cli/demo.py with the flagship PointRCNN dict and random weights on
    DEMO_FRAMES raw .bin scans, without --save_dir (the card's machine has
    no matplotlib): 3 + 3 FPS launches a frame, the first frame's 6 launches
    equal to the plain FPS on their own inputs; then a CaDDN dict must be
    refused (SystemExit). Returns the launches by kernel."""
    import contextlib
    import io
    from unittest import mock

    from modest_tpu_torch.cli import demo as demo_cli
    from modest_tpu_torch.ops import pointnet2 as p2
    from modest_tpu_torch.ops.fps import furthest_point_sample_plain

    scans = root / "demo_scans"
    scans.mkdir()
    for path in sorted((root / "training" / "velodyne").iterdir())[:DEMO_FRAMES]:
        shutil.copy(path, scans)
    real, launched = p2.furthest_point_sample_cuda, []

    def recording(xyz, npoint):
        idx = real(xyz, npoint)
        if len(launched) < 6:
            launched.append((xyz.clone(), npoint, idx))
        return idx

    counts = reset_fps_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(p2, "furthest_point_sample_cuda", recording), \
            contextlib.redirect_stdout(printed):
        results = demo_cli.main(["--cfg_file", str(REPO / FLAGSHIP_CFG), "--data_path",
                                 str(scans)])
    seconds = time.perf_counter() - t0
    launches = dict(counts)
    mismatches = [int((idx != furthest_point_sample_plain(xyz, npoint)).sum())
                  for xyz, npoint, idx in launched]
    try:
        demo_cli.main(["--cfg_file", str(REPO / KITTI_CFG.format("CaDDN")), "--data_path",
                       str(scans)])
        refused = None
    except SystemExit as exc:
        refused = str(exc)
    emit({"phase": "demo", "frames": len(results), "seconds": seconds,
          "detections": [len(r["boxes"]) for r in results],
          "printed_lines": len(printed.getvalue().splitlines()),
          "fps_kernel_launches": launches,
          "first_frame_fps_shapes": [[*xyz.shape[:2], npoint] for xyz, npoint, _ in launched],
          "first_frame_fps_index_mismatches": mismatches, "caddn_refused": refused,
          "card": card})
    want = {"fps_cluster_kernel": 3 * DEMO_FRAMES, "fps_warp_kernel": 3 * DEMO_FRAMES}
    if len(results) != DEMO_FRAMES or launches != want:
        fail(f"demo: {len(results)} frames launched fps {launches}, not {want}")
    if len(launched) != 6 or any(mismatches):
        fail(f"demo: the first frame's FPS indices part from the plain FPS's: {mismatches}")
    if not refused or "lidar-only" not in refused:
        fail(f"demo: a CaDDN dict was not refused ({refused})")
    for r in results:
        if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
            fail(f"demo: non-finite boxes in frame {r['frame_id']}")
    return launches


def phase_caddn(torch, np, api, build_network, dev, card):
    """CaDDN on the card (the dataset, then per dict its forwards, card vs
    CPU and training with cli/test.py; no FPS launch), then the demo CLI on
    the same tree's scans. Returns the demo's FPS launches by kernel."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_caddn_"))
    t0 = time.perf_counter()
    try:
        phase_caddn_dataset(tmp, card)
        counts = reset_fps_counts()
        for stem in CADDN_STEMS:
            model, ds, batch = phase_caddn_forward(torch, np, api, build_network, stem, tmp, dev,
                                                   card)
            phase_caddn_card_vs_cpu(torch, np, api, build_network, stem,
                                    kitti_config(stem, tmp), ds, model, batch, card)
            del model, batch
            torch.cuda.empty_cache()
            phase_caddn_train(torch, np, dev, tmp, stem, card)
            torch.cuda.empty_cache()
        emit({"phase": "caddn_kernels", "fps_kernel_launches": dict(counts), "card": card})
        if any(counts.values()):
            fail(f"CaDDN launched hand kernels {dict(counts)}")
        demo_launches = phase_demo(torch, np, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "caddn_seconds", "seconds": time.perf_counter() - t0, "card": card})
    return demo_launches


def phase_prep(torch, np, dev, card):
    """The dataset-preparation CLIs on tools/nu_scenes.py's drives, in a temp
    dir: the SDK-free Lyft export, split_traintest, gather_historical_
    traversals (PREP_PP_ORIGINS origins) and ransac_planes, then the PP CLI
    on the card for PREP_PP_ORIGINS origins of the export. No module on the
    way may load tqdm, PyYAML or PIL."""
    from modest_tpu_torch.cli import pre_compute_pp_score
    from modest_tpu_torch.ops.radius_count import radius_count_sorted_cuda as rc
    from modest_tpu_torch.preprocessing import (converters, gather_historical_traversals,
                                                ransac_planes, split_traintest)
    from modest_tpu_torch.tools import nu_scenes
    from modest_tpu_torch.utils.kitti_io import load_plane, load_velo_scan

    before = set(sys.modules)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_prep_"))
    try:
        seconds = {}
        t0 = time.perf_counter()
        table_dir, track_list = nu_scenes.write_traversal_tables(tmp / "lyft", seed=0,
                                                                 **PREP_DRIVES)
        n_frames = sum(len(t) for t in track_list)
        store = tmp / "kitti"
        nu_scenes.write_kitti_images(store, n_frames)
        with open(tmp / "tracks.pkl", "wb") as f:
            pickle.dump(track_list, f)
        seconds["write_tables"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        conv = converters.LyftToKittiConverter(store, tmp / "lyft", table_dir, use_sdk="auto")
        conv.convert()
        seconds["lyft_to_kitti"] = time.perf_counter() - t0
        training = store / "training"
        meta = store / "meta_data" / "lyft"
        meta.mkdir(parents=True)
        t0 = time.perf_counter()
        split_traintest.main(["--data_root", str(store), "--track_list_file",
                              str(tmp / "tracks.pkl"), "--save_root", str(meta)])
        seconds["split_traintest"] = time.perf_counter() - t0
        with open(meta / "fw70_2m_valid_train_idx_info.pkl", "rb") as f:
            valid = pickle.load(f)
        parts = -(-len(valid) // PREP_PP_ORIGINS)
        t0 = time.perf_counter()
        gather_historical_traversals.main([
            "--data_root", str(training), "--track_list",
            str(meta / "fw70_2m_train_track_list.pkl"), "--idx_info",
            str(meta / "fw70_2m_valid_train_idx_info.pkl"), "--save_dir",
            str(tmp / "historical"), "--total_part", str(parts)])
        seconds["gather_historical_traversals"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ransac_planes.main(["--calib_dir", str(training / "calib"), "--lidar_dir",
                            str(training / "velodyne"), "--planes_dir", str(training / "planes")])
        seconds["ransac_planes"] = time.perf_counter() - t0
        rc.launches = 0
        t0 = time.perf_counter()
        pre_compute_pp_score.main(pipeline_overrides(store, training, "device=cuda",
                                                     f"total_part={parts}", "part=0"))
        torch.cuda.synchronize()
        seconds["pp_score"] = time.perf_counter() - t0
        launches = rc.launches
        origins = sorted(valid)[:PREP_PP_ORIGINS]
        pp_dir = store / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
        for gid in origins:
            pp = np.load(pp_dir / f"{gid:06d}.npy")
            n = load_velo_scan(training / "velodyne" / f"{gid:06d}.bin").shape[0]
            if pp.shape != (n,) or not np.isfinite(pp).all() or pp.min() < -1e-6 \
                    or pp.max() > 1 + 1e-6:
                fail(f"prep: PP scores of origin {gid}: shape {pp.shape} for {n} points, or out "
                     "of [0, 1]")
        written = {sub: len(list((training / sub).iterdir()))
                   for sub in ("velodyne", "calib", "oxts", "l2e", "label_2", "image_2",
                               "planes")}
        historical = len(list((tmp / "historical").iterdir()))
        plane = load_plane(training / "planes" / "000000.txt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = sorted(m for m in ("tqdm", "yaml", "PIL") if m in set(sys.modules) - before)
    emit({"phase": "prep", "frames": n_frames, "drives": len(track_list),
          "table_reader": type(conv.lyft_ds).__name__, "valid_origins": len(valid),
          "files": written, "historical_origins": historical, "plane": plane.tolist(),
          "pp_origins": len(origins), "radius_count_launches": launches, "seconds": seconds,
          "third_party_loaded": loaded, "card": card})
    if any(v != n_frames for v in written.values()) or historical != len(origins):
        fail(f"prep: files {written}, {historical} historical clouds for {n_frames} frames")
    if launches != len(origins):
        fail(f"prep: {len(origins)} PP origins launched the radius count {launches} times")
    if loaded:
        fail(f"prep: the port loaded {loaded}")
    return launches


def build_kernels(card):
    """One nvcc per source, all started together."""
    from modest_tpu_torch.ops import _build

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for name, lib, seconds in pool.map(one, KERNEL_SOURCES):
            emit({"phase": "build", "kernel": name, "seconds": seconds,
                  "ptxas": [ln for ln in lib.with_suffix(".log").read_text().splitlines()
                            if "registers" in ln or "spill" in ln or "entry function" in ln],
                  "card": card})


def phase_iou_kernel_vs_plain(torch, np, dev, card):
    """csrc/iou3d.cu against its plain twin (ops/iou3d.py::boxes_overlap_bev_plain)
    on the card, bit for bit: tools/iou_cases.py's adversarial, tolerance-band
    and near-coincident box sets and the NMS shapes of the benchmark's cells,
    in float32 and float64, one launch a call, and a stride-0 batch against
    8-value rows. At the NMS shapes (float32) the kernel's ms by CUDA events
    and device ms by torch.profiler, the plain twin's ms and the operation
    bound. Then nms_bev at each cell's NMS load through the kernel and
    through the plain twin: keep sets equal, both timed. Returns the rows."""
    from modest_tpu_torch.ops import iou3d
    from modest_tpu_torch.tools import iou_cases
    from modest_tpu_torch.utils.device import device_ms

    kernel, plain = iou3d.boxes_overlap_bev_cuda, iou3d.boxes_overlap_bev_plain
    rows = []

    def check(case, a, b, timed):
        before = kernel.launches
        got = iou3d.boxes_overlap_bev(a, b)
        want = plain(a, b)
        torch.cuda.synchronize()
        row = {"phase": "iou_kernel_vs_plain", "case": case, "dtype": str(a.dtype)[6:],
               "shape": list(got.shape), "launches": kernel.launches - before,
               "mismatches": int((got != want).sum()),
               "max_abs_err": float((got - want).abs().max())}
        if timed:
            pairs = got.numel()
            nbytes = (a.numel() + b.numel() + pairs) * got.element_size()
            row["ms"] = device_ms(lambda: kernel(a, b), dev, IOU_ITERS)
            row["kernel_device_ms"] = kernel_device_ms(lambda: kernel(a, b), IOU_ITERS,
                                                       "overlap_kernel")
            row["plain_ms"] = device_ms(lambda: plain(a, b), dev, 3)
            row["bound_ms"], row["bound_by"] = bound(pairs * IOU_OPS_PER_PAIR, nbytes)
        emit({**row, "card": card})
        if row["mismatches"] or not torch.equal(got, want) or row["launches"] != 1:
            fail(f"iou kernel vs plain, {case} {a.dtype}: {row['mismatches']} areas differ "
                 f"(max {row['max_abs_err']}), {row['launches']} launches")
        rows.append(row)

    cases = [("adversarial", *[iou_cases.adversarial_boxes()[1]] * 2),
             ("tolerance", *[iou_cases.tolerance_boxes()[1]] * 2),
             ("near_coincident", *[iou_cases.near_coincident_boxes()] * 2)]
    for name, b, kept, block in iou_cases.NMS_SHAPES:
        cases.append((f"nms_{name}", *iou_cases.nms_operands(b, kept, block)))
    for dtype in (torch.float32, torch.float64):
        for case, a, b in cases:
            check(case, torch.as_tensor(a, dtype=dtype, device=dev),
                  torch.as_tensor(b, dtype=dtype, device=dev),
                  timed=case.startswith("nms_") and dtype == torch.float32)
        rng = np.random.RandomState(3)
        anchors = torch.as_tensor(iou_cases.scene_boxes(rng, (300,)), dtype=dtype, device=dev)
        gt = torch.as_tensor(np.concatenate([iou_cases.scene_boxes(rng, (4, 20)),
                                             np.ones((4, 20, 1))], -1), dtype=dtype, device=dev)
        check("stride0_vs_rows_of_8", anchors.expand(4, -1, -1), gt[..., :7], False)

    for cell, b, n, valid, max_keep, thresh in iou_cases.NMS_CELLS:
        boxes, scores = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                         for x in iou_cases.nms_inputs(b, n, valid))

        def nms():
            return iou3d.nms_bev(boxes, scores, thresh, max_keep)

        before = kernel.launches
        got = nms()
        launches = kernel.launches - before
        ms = device_ms(nms, dev, IOU_NMS_ITERS)
        iou3d.boxes_overlap_bev_cuda = plain  # the dispatcher's CUDA branch, for the twin
        try:
            want = nms()
            plain_ms = device_ms(nms, dev, IOU_NMS_ITERS)
        finally:
            iou3d.boxes_overlap_bev_cuda = kernel
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        row = {"phase": "iou_nms_keep_sets", "cell": cell, "batch": b, "candidates": n,
               "valid": valid, "max_keep": max_keep, "thresh": thresh,
               "kept": got[1].sum(1).tolist(), "keep_sets_equal": same,
               "kernel_launches": launches, "nms_ms": ms, "plain_nms_ms": plain_ms}
        emit({**row, "card": card})
        if not same or launches == 0:
            fail(f"nms_bev at {cell}: keep sets equal {same}, {launches} kernel launches")
        rows.append(row)
    return rows


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def pipeline_overrides(root, data_root, *extra):
    return [f"work_dir={root}", f"data_root={data_root}", *extra]


def origin_ids(root):
    with open(Path(root) / "meta_data/lyft/fw70_2m_train_idx.txt") as f:
        return [int(x) for x in f.read().split()]


def phase_pp_score(torch, np, dev, root, data_root, card):
    """The PP CLI on the card: one warm-up origin, then the other origins
    timed on the host clock with the CLI's defaults (2 origins in flight);
    then all origins again, one at a time, with the stage timer."""
    from modest_tpu_torch.cli import pre_compute_pp_score
    from modest_tpu_torch.ops.radius_count import radius_count_sorted_cuda as rc
    from modest_tpu_torch.utils.device import StageTimer
    from modest_tpu_torch.utils.kitti_io import load_velo_scan

    ov = pipeline_overrides(root, data_root, "device=cuda")
    pre_compute_pp_score.main(ov + [f"total_part={PP_ORIGINS}", "part=0"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rc.launches = 0
    t0 = time.perf_counter()
    pre_compute_pp_score.main(ov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rc.launches
    timed = PP_ORIGINS - 1
    if launches != timed:
        fail(f"{timed} PP origins launched the radius-count kernel {launches} times")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    timer = StageTimer(dev)
    t1 = time.perf_counter()
    pre_compute_pp_score.main(ov + [f"data_paths.pp_score_path={root}/pp_staged",
                                    "pipeline_workers=1"], timer=timer)
    staged_wall = time.perf_counter() - t1

    pp_dir = Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
    ground, objects = [], []
    for gid in origin_ids(root):
        pp = np.load(pp_dir / f"{gid:06d}.npy")
        n = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin").shape[0]
        if pp.shape != (n,) or not np.isfinite(pp).all() or pp.min() < -1e-6 or pp.max() > 1 + 1e-6:
            fail(f"PP scores of origin {gid}: shape {pp.shape} for {n} points, or out of [0, 1]")
        n_ground = FRAME["n_ground"]
        ground.append(pp[:n_ground].mean())
        objects.append(pp[n_ground:n_ground + 800 * FRAME["n_objects"]].mean())
        staged = np.load(Path(root) / "pp_staged" / f"{gid:06d}.npy")
        if not np.array_equal(pp, staged):
            fail(f"PP scores of origin {gid} differ between the pipelined and the staged run")
    if not max(objects) < min(ground):
        fail(f"PP does not rank the ephemeral clusters ({objects}) below the ground ({ground})")
    row = {"phase": "pp_score", "origins_timed": timed, "origin_points": n,
           "traversals": PP_TRAVERSALS, "frames_per_traversal": PP_FRAMES_PER_TRAVERSAL,
           "origins_per_s": timed / wall, "wall_s": wall,
           "radius_count_launches": launches, "radius_count_launches_per_origin": launches / timed,
           "stage_ms_per_origin": {k: v / PP_ORIGINS for k, v in timer.ms().items()},
           "staged_origins_per_s": PP_ORIGINS / staged_wall,
           "peak_mem_gb": peak, "pp_ground_mean": float(np.mean(ground)),
           "pp_objects_mean": float(np.mean(objects)), "card": card}
    emit(row)
    return row


def phase_seed_labels(torch, np, dev, root, data_root, card):
    """The seed-mask CLI on the card over the PP scores: one warm-up group,
    then the other group timed with the CLI's defaults; then all frames
    again, one group at a time, with the stage timer."""
    from modest_tpu_torch.cli import generate_mask
    from modest_tpu_torch.ops import dbscan as D
    from modest_tpu_torch.utils.device import StageTimer

    ov = pipeline_overrides(root, data_root, "device=cuda", f"device_batch_frames={SEED_GROUP}")
    generate_mask.main(ov + [f"total_part={PP_ORIGINS // SEED_GROUP}", "part=0"])  # one group
    torch.cuda.synchronize()
    for fn in (D.dbscan_edge_cuda, D.dbscan_prop_cuda):
        fn.launches = fn.calls = 0
    D.dbscan_prop_cuda.rounds = D.dbscan_prop_cuda.ties = D.dbscan_prop_cuda.host_reads = 0
    t0 = time.perf_counter()
    generate_mask.main(ov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dbscan_edge": D.dbscan_edge_cuda.launches,
                "dbscan_prop": D.dbscan_prop_cuda.launches}
    calls = {"dbscan_edge": D.dbscan_edge_cuda.calls, "dbscan_prop": D.dbscan_prop_cuda.calls}
    rounds, ties = D.dbscan_prop_cuda.rounds, D.dbscan_prop_cuda.ties
    host_reads = D.dbscan_prop_cuda.host_reads
    timed = PP_ORIGINS - SEED_GROUP
    groups = timed // SEED_GROUP
    # per group: kth + edge kernels; the propagation's kernels and one host read
    if calls != {"dbscan_edge": groups, "dbscan_prop": groups} or launches != {
            "dbscan_edge": 2 * groups, "dbscan_prop": len(PROP_KERNELS) * groups} \
            or host_reads != groups:
        fail(f"{groups} seed groups called the DBSCAN wrappers {calls} times, launched "
             f"{launches} kernels and read the host {host_reads} times")

    timer = StageTimer(dev)
    t1 = time.perf_counter()
    generate_mask.main(ov + [f"data_paths.seg_save_dst={root}/seg_staged",
                             f"data_paths.bbox_info_save_dst={root}/bbox_staged",
                             "pipeline_workers=1"], timer=timer)
    staged_wall = time.perf_counter() - t1

    seg_dir = Path(root) / "intermediate_results/lyft_seg_pp_score_fw70_2m_r0.3"
    bbox_dir = Path(root) / "intermediate_results/lyft_bbox_pp_score_fw70_2m_r0.3"
    boxes = 0
    for gid in origin_ids(root):
        seg = np.load(seg_dir / f"{gid:06d}.npy")
        with open(bbox_dir / f"{gid:06d}.pkl", "rb") as f:
            objs = pickle.load(f)
        if seg.max() != len(objs) or not np.array_equal(seg, np.load(Path(root) / "seg_staged"
                                                                     / f"{gid:06d}.npy")):
            fail(f"seed masks of frame {gid}: {seg.max()} clusters for {len(objs)} boxes, "
                 f"or the staged run differs")
        for o in objs:
            if not np.isfinite([*o.t, o.l, o.w, o.h, o.ry]).all():
                fail(f"frame {gid}: a non-finite seed box")
        boxes += len(objs)
    if boxes == 0:
        fail("the seed path made no seed boxes")
    row = {"phase": "seed_labels", "frames_timed": timed, "group": SEED_GROUP,
           "frames_per_s": timed / wall, "wall_s": wall, "dbscan_launches": launches,
           "dbscan_calls": calls, "dbscan_fixup_rounds": rounds, "dbscan_tie_edges": ties,
           "dbscan_host_reads": host_reads, "dbscan_fixup_rounds_per_group": rounds / max(groups, 1),
           "stage_ms_per_frame": {k: v / PP_ORIGINS for k, v in timer.ms().items()},
           "staged_frames_per_s": PP_ORIGINS / staged_wall, "seed_boxes": boxes,
           "seed_boxes_per_frame": boxes / PP_ORIGINS, "card": card}
    emit(row)
    return row


def pp_kernel_inputs(torch, dev, data_root, root):
    """The radius count's inputs for the first origin, built by the PP path
    on ``dev``."""
    from modest_tpu_torch.pipeline.pp_score import (FrameCache, TraversalIndex, _cached_pools,
                                                    _sorted_inputs)

    with open(Path(root) / "meta_data/lyft/fw70_2m_train_track_list.pkl", "rb") as f:
        track_list = pickle.load(f)
    with open(Path(root) / "meta_data/lyft/fw70_2m_valid_train_idx_info.pkl", "rb") as f:
        valid_idx = pickle.load(f)
    index = TraversalIndex(data_root, track_list, valid_idx)
    q_pad, coords, n = _cached_pools(index, FrameCache(index._velo, dev), origin_ids(root)[0])
    q_s, t_sorted, lohi, _ = _sorted_inputs(q_pad, *coords, PP_RADIUS)
    return q_s, t_sorted, lohi, n


def phase_radius_count(torch, np, dev, data_root, root, card):
    from modest_tpu_torch.ops.radius_count import (BM, BN, CHUNK_TILES, PAD,
                                                   radius_count_sorted_cuda,
                                                   radius_count_sorted_plain, split_windows)
    from modest_tpu_torch.pipeline.pp_score import radius2
    from modest_tpu_torch.utils.device import device_ms

    q_s, t_sorted, lohi, n = pp_kernel_inputs(torch, dev, data_root, root)
    r2 = radius2(PP_RADIUS)
    got = radius_count_sorted_cuda(q_s, t_sorted, lohi, r2)
    want = radius_count_sorted_plain(q_s, t_sorted, lohi, r2)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    max_abs_err = int((got.long() - want.long()).abs().max())
    ms = device_ms(lambda: radius_count_sorted_cuda(q_s, t_sorted, lohi, r2), dev, 10)
    kernel_ms = kernel_device_ms(lambda: radius_count_sorted_cuda(q_s, t_sorted, lohi, r2), 10,
                                 "radius_count_kernel")
    plain_ms = device_ms(lambda: radius_count_sorted_plain(q_s, t_sorted, lohi, r2), dev, 1)
    t_count, _, m = t_sorted.shape
    nq_total = q_s.shape[1]
    lo, hi = lohi[..., 0].long(), lohi[..., 1].long()
    tiles = hi - lo  # (T, nq) pool tiles per query tile
    pairs = int(tiles.sum()) * BM * BN  # the pair tests the kernel makes
    mixed = (n - 1) // BN if n % BN else None  # the tile that mixes real and pad queries
    mixed_pairs = int(tiles[:, mixed].sum()) * BM * BN if mixed is not None else 0
    # the pair tests the count needs: real queries x real pool points of each
    # window (pads sort to the end of the queries and of each pool)
    real_q = (n - torch.arange(nq_total // BN, device=dev) * BN).clamp(0, BN)
    m_real = (t_sorted[:, 0] < PAD).sum(dim=1, keepdim=True)
    real_pool = (torch.minimum(hi * BM, m_real) - lo * BM).clamp_min(0)
    needed = int((real_q * real_pool).sum())
    nbytes = 3 * nq_total * 4 + t_count * 3 * m * 4 + lohi.numel() * 4 + t_count * nq_total * 4
    bound_ms, bound_by = bound(needed * RC_OPS_PER_PAIR, nbytes)
    row = {"phase": "radius_count_vs_plain", "queries": n, "Nq": nq_total, "T": t_count, "M": m,
           "chunk_tiles": CHUNK_TILES, "work_items": int(split_windows(lohi)[-1]),
           "mismatches": mismatches, "max_abs_err": max_abs_err, "ms": ms,
           "kernel_device_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "pair_tests": pairs, "pair_tests_needed": needed,
           "pad_pair_share": 1 - needed / max(pairs, 1), "mixed_tile_pair_tests": mixed_pairs,
           "mixed_tile_share": mixed_pairs / max(pairs, 1),
           "pair_tests_per_s": pairs / (ms * 1e-3), "card": card}
    emit(row)
    if mismatches:
        fail(f"radius count kernel disagrees with its plain version on {mismatches} counts")
    return row, (q_s, t_sorted, lohi, got, n)


def seed_group_graph(torch, np, dev, data_root, root, index: int = 0):
    """The kNN graph the seed path builds for its group ``index`` of frames."""
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.pipeline.clustering import _knn_graph, _prepare_group
    from modest_tpu_torch.pipeline.seed_labels import _frame_final_mask
    from modest_tpu_torch.utils.kitti_io import load_velo_scan

    cfg = load_pipeline_config("generate_mask", pipeline_overrides(root, data_root))
    pp_dir = Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
    group = []
    for gid in origin_ids(root)[index * SEED_GROUP:(index + 1) * SEED_GROUP]:
        ptc = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin")
        pp = np.load(pp_dir / f"{gid:06d}.npy")
        m = _frame_final_mask(ptc, cfg)
        group.append((ptc[m, :3], pp[m]))
    preps, ns, n_pad, k, kc, w = _prepare_group(group, cfg.graph.n_neighbors, cfg.graph.radius,
                                                1024)
    idx, d2, pb, vb = _knn_graph(preps, n_pad, k, kc, w, cfg.graph.radius, dev)
    return cfg, (idx, d2, pb, vb), ns, n_pad, k, w


def dbscan_case(torch, np, dev, D, name, args, card):
    """One graph through the DBSCAN kernels and their plain twins: edge rows,
    tie bits and core flags equal; labels equal on the first call and on
    every timed call (the atomics' order varies from run to run). Both
    stages timed by CUDA events and, kernel by kernel, by torch.profiler."""
    from modest_tpu_torch.utils.device import device_ms

    edge_before = D.dbscan_edge_cuda.launches
    graph, graph_p = D.dbscan_edge_cuda(*args), D.dbscan_edge_plain(*args)
    edge_launches = D.dbscan_edge_cuda.launches - edge_before
    before = (D.dbscan_prop_cuda.launches, D.dbscan_prop_cuda.rounds, D.dbscan_prop_cuda.ties,
              D.dbscan_prop_cuda.host_reads)
    raw, raw_p = D.dbscan_prop_cuda(graph), D.dbscan_prop_plain(graph_p)
    launches, rounds, ties, host_reads = (after - b for after, b in zip(
        (D.dbscan_prop_cuda.launches, D.dbscan_prop_cuda.rounds, D.dbscan_prop_cuda.ties,
         D.dbscan_prop_cuda.host_reads), before))
    model, pairs, _ = D.dbscan_prop_components_plain(graph_p)
    torch.cuda.synchronize()
    nbr_mm = int((graph.nbr != graph_p.nbr).sum())
    tie_mm = int((graph.tie != graph_p.tie).sum())
    core_mm = int((graph.core != graph_p.core).sum())
    lab_mm = int((raw != raw_p).sum()) + int((model != raw_p).sum())
    outs = []

    def prop():
        outs.append(D.dbscan_prop_cuda(graph))

    prop_ms = device_ms(prop, dev, 10)
    prop_kernel_ms = kernel_device_ms(prop, 10, PROP_KERNELS)
    timed_mm = sum(int((o != raw_p).sum()) for o in outs)
    prop_plain_ms = device_ms(lambda: D.dbscan_prop_plain(graph_p), dev, 1)
    edge_ms = device_ms(lambda: D.dbscan_edge_cuda(*args), dev, 10)
    edge_kernel_ms = {kern: kernel_device_ms(lambda: D.dbscan_edge_cuda(*args), 10, kern)
                      for kern in EDGE_KERNELS}
    edge_plain_ms = device_ms(lambda: D.dbscan_edge_plain(*args), dev, 3)
    b, n = graph.core.shape
    total, k = graph.nbr.shape
    edges = int((graph.nbr >= 0).sum())
    # prop, what the function needs (not what this algorithm reads): the
    # nbr rows of valid points once (core rows to propagate, the others for
    # their border labels), one 4-byte label gather per edge, the initial
    # label table and core and valid flags read once, the labels written once
    valid_rows = int(graph.valid.sum()) * k * 4
    prop_bound = bound(0, valid_rows + 4 * edges + total * (4 + 1 + 1) + 4 * total)
    # edge: idx and d2 rows and pp, valid read once; nbr rows, tie words,
    # core, labels written once
    rows_b = total * k * 4
    edge_bound = bound(0, 2 * rows_b + total * (4 + 1) + rows_b + graph.tie.numel() * 4
                       + total * (1 + 4))
    row = {"phase": "dbscan_vs_plain", "graph": name, "frames": b, "N": n, "k": k,
           "edges": edges, "core": int(graph.core.sum()),
           "tie_edges": int(D.unpack_bits(graph.tie, k).sum()), "core_tie_edges": ties,
           "core_tie_edges_plain": len(pairs),
           "clusters": int(sum(len(np.unique(r[r >= 0])) for r in raw.cpu().numpy())),
           "nbr_mismatches": nbr_mm, "tie_mismatches": tie_mm, "core_mismatches": core_mm,
           "label_mismatches": lab_mm, "timed_calls": len(outs),
           "timed_label_mismatches": timed_mm, "launches_per_call": launches,
           "fixup_rounds": rounds, "host_reads": host_reads, "prop_ms": prop_ms,
           "prop_kernel_device_ms": prop_kernel_ms, "prop_plain_ms": prop_plain_ms,
           "prop_bound_ms": prop_bound[0], "bound_by": "bytes", "library_ms": None,
           "edge_ms": edge_ms, "edge_kernel_device_ms": edge_kernel_ms,
           "edge_plain_ms": edge_plain_ms, "edge_bound_ms": edge_bound[0],
           "edge_launches_per_call": edge_launches, "card": card}
    if name == "tie_chain":  # the one-way tie edges must matter on this graph
        row["core_labels_unlike_undirected"] = undirected_mismatches(torch, D, graph_p, raw_p)
    emit(row)
    if nbr_mm or tie_mm or core_mm or lab_mm or timed_mm:
        fail(f"DBSCAN kernels disagree with their plain versions on {name}: {nbr_mm} edge slots, "
             f"{tie_mm} tie words, {core_mm} core flags, {lab_mm} labels, {timed_mm} labels "
             f"over {len(outs)} timed calls")
    if (edge_launches, launches, host_reads, ties) != (len(EDGE_KERNELS), len(PROP_KERNELS), 1,
                                                       len(pairs)):
        fail(f"DBSCAN on {name}: {edge_launches} edge kernels, {launches} propagation kernels, "
             f"{host_reads} host reads, {ties} core tie edges (plain {len(pairs)})")
    return row


def undirected_mismatches(torch, D, graph, raw) -> int:
    """Core points whose label differs from their undirected component's
    minimum: what a union-find over every edge would have got wrong."""
    b, n = graph.core.shape
    total, k = graph.nbr.shape
    nbr, core = graph.nbr.long(), graph.core.reshape(-1)
    i = torch.arange(total, device=nbr.device)[:, None].expand(total, k)
    cc = (nbr >= 0) & core[:, None] & core[nbr.clamp_min(0)]
    comp = D._component_min(i[cc], nbr[cc], torch.arange(total, device=nbr.device)).reshape(b, n)
    comp = comp - (torch.arange(b, device=nbr.device) * n)[:, None]
    return int(((comp != raw) & graph.core).sum())


def bad_index_case(torch, D, args):
    """A neighbour index outside its frame, on a slot that passes the
    radius gate, is reported by the propagation's host read; the next call
    on the same buffers' shapes starts from clear flags."""
    idx, d2 = args[0].clone(), args[1]
    rows, slots = torch.nonzero(torch.isfinite(d2[0]) & (d2[0] <= args[4]), as_tuple=True)
    idx[0, rows[0], slots[0]] = idx.shape[1]
    try:
        D.dbscan_prop_cuda(D.dbscan_edge_cuda(idx, *args[1:]))
    except RuntimeError as e:
        if "outside its frame" not in str(e):
            raise
    else:
        fail("the DBSCAN kernels accepted a neighbour index outside its frame")
    got = D.dbscan_prop_cuda(D.dbscan_edge_cuda(*args))
    if not torch.equal(got, D.dbscan_prop_plain(D.dbscan_edge_plain(*args))):
        fail("the DBSCAN kernels disagree with their plain versions after a bad index")


def phase_dbscan(torch, np, dev, data_root, root, card):
    """The DBSCAN kernels against their plain twins on the kNN graph of
    every group of the seed phase, on a tie-chain graph of the first
    group's size (tools/tie_graph.py), whose one-way tie edges make the
    directed labels differ from the undirected components, and on a
    tie-chain graph with k = 33 and an odd row count; then an index
    outside its frame must be reported."""
    from modest_tpu_torch.ops import dbscan as D
    from modest_tpu_torch.pipeline.clustering import dbscan_params
    from modest_tpu_torch.tools.tie_graph import tie_chain_graph

    rows = []
    for g in range(PP_ORIGINS // SEED_GROUP):
        cfg, (idx, d2, pb, vb), ns, n_pad, k, w = seed_group_graph(torch, np, dev, data_root,
                                                                   root, g)
        if g == 0:
            n0, k0 = n_pad, k
        params = (*dbscan_params(cfg.graph.radius, cfg.clustering.DBSCAN.eps),
                  cfg.clustering.DBSCAN.min_samples)
        row = dbscan_case(torch, np, dev, D, f"seed_group_{g}", (idx, d2, pb, vb, *params), card)
        rows.append({**row, "in_range_points": ns, "window": w})
    tie = [torch.from_numpy(a).to(dev) for a in tie_chain_graph(SEED_GROUP, n0, k0, seed=0)]
    tie_row = dbscan_case(torch, np, dev, D, "tie_chain", (*tie, *params), card)
    if not tie_row["core_labels_unlike_undirected"]:
        fail("the tie-chain graph's directed labels equal its undirected components")
    odd = [torch.from_numpy(a).to(dev) for a in tie_chain_graph(
        ODD_GRAPH["frames"], ODD_GRAPH["n"], ODD_GRAPH["k"], seed=1)]
    odd_row = dbscan_case(torch, np, dev, D, "k33_odd_rows", (*odd, *params), card)
    bad_index_case(torch, D, (*odd, *params))
    return rows, tie_row, odd_row


def match_centres(np, boxes, ref, tol=1e-2):
    used = np.zeros(len(ref), bool)
    pairs = 0
    for b in boxes:
        d = np.linalg.norm(ref - b, axis=1) if len(ref) else np.zeros(0)
        cand = np.flatnonzero((d < tol) & ~used)
        if len(cand):
            used[cand[np.argmin(d[cand])]] = True
            pairs += 1
    return pairs


def phase_pipeline_card_vs_cpu(torch, np, dev, data_root, root, rc_state, card):
    """Seed path on the card vs the port's CPU run: the PP kernel inputs are
    built again on the CPU and must be equal, the CPU counts every 4th query
    tile with the plain twin, and one frame goes through generate_mask on
    both devices."""
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.ops.radius_count import BN, radius_count_sorted_plain
    from modest_tpu_torch.pipeline.pp_score import radius2
    from modest_tpu_torch.pipeline.seed_labels import generate_mask_for_frame
    from modest_tpu_torch.utils.kitti_io import Calibration, load_velo_scan

    q_s, t_sorted, lohi, got, n = rc_state
    t0 = time.perf_counter()
    c_q, c_t, c_lohi, _ = pp_kernel_inputs(torch, torch.device("cpu"), data_root, root)
    inputs_equal = (torch.equal(c_q, q_s.cpu()) and torch.equal(c_t, t_sorted.cpu())
                    and torch.equal(c_lohi, lohi.cpu()))
    nq = q_s.shape[1] // BN
    tiles = torch.arange(0, nq, CPU_TILE_STRIDE)
    cols = (tiles[:, None] * BN + torch.arange(BN)).reshape(-1)
    want = radius_count_sorted_plain(c_q[:, cols].contiguous(), c_t,
                                      c_lohi[:, tiles].contiguous(), radius2(PP_RADIUS))
    count_mm = int((got.cpu()[:, cols] != want).sum())
    pp_cpu_s = time.perf_counter() - t0

    cfg = load_pipeline_config("generate_mask", pipeline_overrides(root, data_root))
    gid = origin_ids(root)[0]
    ptc = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin")
    pp = np.load(Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3" / f"{gid:06d}.npy")
    calib = Calibration(str(Path(data_root) / "calib" / f"{gid:06d}.txt"))
    lab_g, objs_g = generate_mask_for_frame(ptc, pp, calib, cfg, device="cuda")
    t1 = time.perf_counter()
    lab_c, objs_c = generate_mask_for_frame(ptc, pp, calib, cfg, device="cpu")
    seed_cpu_s = time.perf_counter() - t1
    # labels up to a permutation of the cluster ids: map each card id to the
    # CPU id most of its points carry, one to one
    mapping = {}
    for g in np.unique(lab_g):
        vals, cnt = np.unique(lab_c[lab_g == g], return_counts=True)
        mapping[int(g)] = int(vals[np.argmax(cnt)])
    injective = len(set(mapping.values())) == len(mapping)
    agree = float((np.vectorize(mapping.get)(lab_g) == lab_c).mean()) if injective else 0.0
    centres_g = np.array([o.t for o in objs_g]).reshape(-1, 3)
    centres_c = np.array([o.t for o in objs_c]).reshape(-1, 3)
    matched = match_centres(np, centres_g, centres_c)
    row = {"phase": "pipeline_card_vs_cpu", "origin": gid, "pp_inputs_equal": inputs_equal,
           "pp_count_mismatches": count_mm, "pp_cut": f"CPU counts query tiles i % "
           f"{CPU_TILE_STRIDE} == 0 ({len(tiles)} of {nq} tiles), all {t_sorted.shape[0]} "
           f"traversals", "pp_cpu_s": pp_cpu_s, "seed_points": int(len(lab_g)),
           "label_agreement": agree, "card_boxes": len(objs_g), "cpu_boxes": len(objs_c),
           "boxes_matched": matched, "seed_cpu_s": seed_cpu_s, "card": card}
    emit(row)
    if not inputs_equal or count_mm:
        fail(f"PP card vs CPU: inputs equal {inputs_equal}, {count_mm} count mismatches")
    if agree < 0.999 or matched != len(objs_g) or len(objs_g) != len(objs_c) or not objs_g:
        fail(f"seed card vs CPU: label agreement {agree}, boxes {matched} matched of "
             f"{len(objs_g)} card / {len(objs_c)} CPU")


def round0_test_argv(cfg_file, out, data, device):
    """cli/test.py on a round dataset's TRAIN split, as cli/self_train.py runs
    it, at B = ROUND_EVAL_BATCH and ROUND0_SCORE_THRESH."""
    return ["--cfg_file", cfg_file, "--ckpt_dir", str(out / "ckpt"), "--data_path", str(data),
            "--output_dir", str(out / "eval_train_root"), "--batch_size", str(ROUND_EVAL_BATCH),
            "--device", device, "--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
            "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]",
            "MODEL.POST_PROCESSING.SCORE_THRESH", str(ROUND0_SCORE_THRESH)]


def check_result(np, annos, ids, where):
    got = [a["frame_id"] for a in annos]
    if got != ids:
        fail(f"{where}: result.pkl holds frames {got}, not {ids} once each")
    for a in annos:
        if not (np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()):
            fail(f"{where}: non-finite boxes in frame {a['frame_id']}")


def label_lines(label_dir, ids):
    return {i: (Path(label_dir) / f"{i}.txt").read_text().splitlines() for i in ids}


def fusion_shell_pairs(torch, cfg, det, gen_objs, ptc_rect, pp_score):
    """Pairs that one frame's fusion NMS compares (a box the greedy pass
    keeps against a later candidate, in the CPU run's score order) whose BEV
    IoU (CPU, float32) lies within NMS_IOU_SHELL of the NMS threshold: there
    the card's and the CPU's float32 IoU may fall on either side of it. Up to
    the first such pair both runs keep the same boxes, so a frame whose
    labels differ without one is a fault."""
    from modest_tpu_torch.ops.iou3d import boxes_iou_bev
    from modest_tpu_torch.pipeline.seed_labels import fusion_candidates, objs_to_bev_boxes

    objs = fusion_candidates(det, gen_objs, ptc_rect, pp_score, cfg)
    if not objs:
        return 0
    boxes = torch.from_numpy(objs_to_bev_boxes(objs))
    scores = torch.tensor([o.score for o in objs], dtype=torch.float32)
    order = torch.sort(scores, descending=True, stable=True).indices
    iou = boxes_iou_bev(boxes[order], boxes[order])  # [s, t]: the earlier box clips
    thresh, kept, pairs = cfg.nms.threshold, [], 0
    for t in range(len(objs)):
        col = iou[kept, t]
        pairs += int(((col - thresh).abs() <= NMS_IOU_SHELL).sum())
        if not bool((col > thresh).any()):
            kept.append(t)
    return pairs


def phase_self_train(torch, np, dev, root, data_root, card):
    """One self-training round at the flagship's full width through the CLIs,
    on the pipeline dataset's origin frames: the seed boxes as label files
    (generate_label_files), a round-0 dataset with its infos and gt
    database, one epoch of cli/train.py (at ROUND_LR) and cli/test.py on
    the train split at B = 4 (the round-0 result.pkl); then
    cli/self_train.py --max_iter 1
    (combine, round dataset, infos, train, train-split inference), and a
    second call that must skip the finished round. Returns the FPS launches
    of the driver's round, and of the forwards it made."""
    import os

    from modest_tpu_torch.cli import generate_label_files, self_train
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
    from modest_tpu_torch.utils import native

    if not native.available():
        fail("self_train: the host library did not build, so the eval would take the numpy "
             "matcher")
    root = Path(root)
    device = dev.type
    ids = [f"{g:06d}" for g in origin_ids(root)]
    cfg_file = str(REPO / FLAGSHIP_CFG)
    cfg = train_cli.load_model_config(cfg_file)
    train_batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    post = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE)
    checked = {(b, n, npoint) for _, b, n, npoint in FPS_SHAPES}
    for b in (ROUND_EVAL_BATCH, train_batch):  # round 0's and the driver's test batch
        missing = {(b * post, 512, 128), (b * post, 128, 32)} - checked
        if missing:
            fail(f"self_train: the RoI FPS shapes {sorted(missing)} of a B = {b} test batch "
                 f"are not held against the plain version")
    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    # round 0: the seed boxes as labels, one epoch at ROUND_LR, the train split's detections
    label_dir = root / "intermediate_results/lyft_labels_pp_score_fw70_2m_r0.3_fov"
    timed("label_files", lambda: generate_label_files.main(
        pipeline_overrides(root, data_root, f"device={device}")))
    seed_labels = sum(map(len, label_lines(label_dir, ids).values()))
    round0 = root / "rounds" / "round_0"

    def make_round0():
        self_train.make_round_dataset(root, round0, label_dir)
        create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, round0, round0, if_val=False)

    timed("infos", make_round0)
    out0 = root / "self_training" / "round_0"
    counts = reset_fps_counts()
    state = timed("train", lambda: train_cli.main([
        "--cfg_file", cfg_file, "--data_path", str(round0), "--batch_size", str(train_batch),
        "--epochs", str(ROUND_EPOCHS), "--fix_random_seed", "--output_dir", str(out0),
        "--device", device, "--set", "OPTIMIZATION.LR", str(ROUND_LR)]))
    r0_annos, r0_ret = timed("inference", lambda: test_cli.main(
        round0_test_argv(cfg_file, out0, round0, device)))
    r0_launches = dict(counts)
    r0_forwards = len(state.history) + -(-len(ids) // ROUND_EVAL_BATCH)
    r0_result = out0 / "eval_train_root" / "eval" / f"epoch_{ROUND_EPOCHS}" / "train" / "result.pkl"
    with open(r0_result, "rb") as f:
        check_result(np, pickle.load(f), ids, "round 0")
    check_result(np, r0_annos, ids, "round 0")
    check_history(np, state.history, "round-0 train")

    # round 1 through the driver, then a second call that must skip it
    st_out = root / "self_training"
    st_argv = ["--cfg_file", cfg_file, "--base_data", str(root), "--work_dir", str(root),
               "--seed_result", str(r0_result), "--max_iter", "1", "--epochs", str(ROUND_EPOCHS),
               "--output_root", str(st_out), "--rounds_dir", str(root / "rounds"),
               "--device", device]
    counts = reset_fps_counts()
    t0 = time.perf_counter()
    timings = self_train.main(st_argv)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = dict(counts)
    forwards = len(ids) // train_batch + -(-len(ids) // train_batch)  # train steps, test batches
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    r1_labels = root / "intermediate_results" / "round_1_labels"
    r1_result = st_out / "round_1" / "eval_train" / "result.pkl"
    outputs = [label_dir / f"{i}.txt" for i in ids] + [
        round0 / "kitti_infos_train.pkl", round0 / "kitti_dbinfos_train.pkl",
        out0 / "ckpt" / f"checkpoint_epoch_{ROUND_EPOCHS}.pth", r0_result,
        self_train.token(r1_labels), self_train.token(root / "rounds" / "round_1"),
        root / "rounds" / "round_1" / "kitti_infos_train.pkl",
        st_out / "round_1" / "ckpt" / f"checkpoint_epoch_{ROUND_EPOCHS}.pth", r1_result]
    missing = [str(p) for p in outputs if not p.exists()]
    if missing:
        fail(f"self_train: stage outputs missing: {missing}")
    with open(r1_result, "rb") as f:
        r1_annos = pickle.load(f)
    check_result(np, r1_annos, ids, "round 1")
    fused = label_lines(r1_labels, ids)
    n_fused = sum(map(len, fused.values()))

    stamps = [os.stat(p).st_mtime_ns for p in outputs[-6:]]
    counts = reset_fps_counts()
    again = self_train.main(st_argv)
    resume_ok = (again == {} and stamps == [os.stat(p).st_mtime_ns for p in outputs[-6:]]
                 and not any(counts.values()))

    # AP and recall of round 0; the host eval of round 1's detections, timed
    ap = {k: float(v) for k, v in r0_ret.items() if k.endswith("_R40")}
    rec = r0_ret["recall"]
    recall = {k: v / rec["gt"] for k, v in rec.items() if k != "gt"} if rec.get("gt") else {}
    from modest_tpu_torch.data.kitti_dataset import KittiDataset

    r1_cfg = train_cli.load_model_config(cfg_file)
    r1_cfg.DATA_CONFIG.DATA_SPLIT["test"] = "train"
    r1_cfg.DATA_CONFIG.INFO_PATH["test"] = ["kitti_infos_train.pkl"]
    r1_set = KittiDataset(r1_cfg.DATA_CONFIG, r1_cfg.CLASS_NAMES, training=False,
                          root_path=root / "rounds" / "round_1")
    t0 = time.perf_counter()
    _, r1_ap = r1_set.evaluation(r1_annos, r1_cfg.CLASS_NAMES)
    eval_host_s = time.perf_counter() - t0
    row = {"phase": "self_train", "frames": len(ids), "seed_labels": seed_labels,
           "fused_labels": n_fused, "fused_labels_per_frame": n_fused / len(ids),
           "round0_stage_s": stages, "round1_stage_s": timings.get("round_1"),
           "round1_s": round_s, "round0_train_steps": len(state.history),
           "round0_test_batches": -(-len(ids) // ROUND_EVAL_BATCH),
           "round0_detections": sum(len(a["score"]) for a in r0_annos),
           "round1_detections": sum(len(a["score"]) for a in r1_annos),
           "round0_score_thresh": ROUND0_SCORE_THRESH,
           "eval_batch": ROUND_EVAL_BATCH, "sec_per_example": r0_ret["sec_per_example"],
           "eval_scans_per_s": 1.0 / r0_ret["sec_per_example"],
           "steady_sec_per_example": r0_ret["steady_sec_per_example"],
           "eval_steady_scans_per_s": 1.0 / r0_ret["steady_sec_per_example"],
           "evaluation_host_s": eval_host_s, "round0_ap": ap, "round0_recall": recall,
           "round1_ap": {k: float(v) for k, v in r1_ap.items()},
           "round1_forwards": forwards, "train_batch": train_batch,
           "fps_launches_round0": r0_launches, "fps_launches_round1": launches,
           "fps_launches_resume": dict(counts), "resume_skipped": resume_ok,
           "combine_frames_per_s": len(ids) / timings["round_1"]["combine"],
           "peak_mem_gb": peak, "host_library": native.available(), "card": card}
    emit(row)
    if not resume_ok:
        fail(f"self_train: the second call did not skip round 1 whole ({again})")
    if n_fused < len(ids):
        fail(f"self_train: {n_fused} fused labels over {len(ids)} frames (< 1 a frame)")
    finite = [*ap.values(), *recall.values(), *row["round1_ap"].values()]
    if not ap or not all(np.isfinite(finite)):
        fail(f"self_train: AP {ap} or recall {recall} not finite")
    for got, n, where in ((r0_launches, r0_forwards, "round 0"), (launches, forwards, "round 1")):
        if got != {"fps_cluster_kernel": 3 * n, "fps_warp_kernel": 3 * n}:
            fail(f"self_train {where}: {n} forwards launched the fps kernels {got} times, "
                 f"not 3 + 3 each")
    return launches, forwards, {"annos": r0_annos, "result": r0_result, "out": out0,
                                "data": round0}


def phase_self_train_second(torch, np, dev, root, data_root, card):
    """self_train_second: one self-training round with SECOND
    (ROUND_SECOND_CFG) through the CLIs on the pipeline dataset's origin
    frames, as phase_self_train's with PointRCNN: that phase's seed label
    files, a round-0 dataset with SECOND's infos and gt database, one epoch
    of cli/train.py at the config's batch and the rate its first epoch
    reaches, cli/test.py on the train split at B = ROUND_EVAL_BATCH (round
    0's result.pkl), then cli/self_train.py --max_iter 1 (combine, round
    dataset, infos, one epoch at the config's rate, train-split inference).
    Its work dir links the pipeline's PP scores, seed boxes and metadata and
    holds its own round labels. Reports the files, detections and fused
    labels; every train loss finite (round 1's from its metrics.jsonl),
    no FPS launch."""
    from modest_tpu_torch.cli import self_train
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos

    root = Path(root)
    device = dev.type
    ids = [f"{g:06d}" for g in origin_ids(root)]
    cfg_file = str(REPO / ROUND_SECOND_CFG)
    cfg = train_cli.load_model_config(cfg_file)
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    lr = one_cycle_early_lr(cfg.OPTIMIZATION, ROUND_EPOCHS)
    work = root / "second_round"
    (work / "intermediate_results").mkdir(parents=True)
    (work / "meta_data").symlink_to(root / "meta_data")
    for entry in (root / "intermediate_results").iterdir():
        if not entry.name.startswith("round_"):  # the PointRCNN round's labels stay apart
            (work / "intermediate_results" / entry.name).symlink_to(entry)
    label_dir = root / "intermediate_results/lyft_labels_pp_score_fw70_2m_r0.3_fov"
    rounds = root / "rounds_second"
    round0, out0 = rounds / "round_0", work / "self_training" / "round_0"
    stages = {}
    counts = reset_fps_counts()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return result

    def make_round0():
        self_train.make_round_dataset(root, round0, label_dir)
        create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, round0, round0, if_val=False)

    timed("infos", make_round0)
    state = timed("train", lambda: train_cli.main([
        "--cfg_file", cfg_file, "--data_path", str(round0), "--batch_size", str(batch),
        "--epochs", str(ROUND_EPOCHS), "--fix_random_seed", "--output_dir", str(out0),
        "--device", device, "--set", "OPTIMIZATION.LR", str(lr)]))
    r0_annos, r0_ret = timed("inference", lambda: test_cli.main(
        round0_test_argv(cfg_file, out0, round0, device)))
    r0_result = out0 / "eval_train_root" / "eval" / f"epoch_{ROUND_EPOCHS}" / "train" / "result.pkl"
    with open(r0_result, "rb") as f:
        check_result(np, pickle.load(f), ids, "SECOND round 0")
    check_history(np, state.history, "SECOND round-0 train")

    st_out = work / "self_training"
    t0 = time.perf_counter()
    timings = self_train.main([
        "--cfg_file", cfg_file, "--base_data", str(root), "--work_dir", str(work),
        "--seed_result", str(r0_result), "--max_iter", "1", "--epochs", str(ROUND_EPOCHS),
        "--output_root", str(st_out), "--rounds_dir", str(rounds), "--device", device])
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    r1_labels = work / "intermediate_results" / "round_1_labels"
    r1_result = st_out / "round_1" / "eval_train" / "result.pkl"
    outputs = [round0 / "kitti_infos_train.pkl", round0 / "kitti_dbinfos_train.pkl",
               out0 / "ckpt" / f"checkpoint_epoch_{ROUND_EPOCHS}.pth", r0_result,
               self_train.token(r1_labels), self_train.token(rounds / "round_1"),
               rounds / "round_1" / "kitti_infos_train.pkl",
               rounds / "round_1" / "kitti_dbinfos_train.pkl",
               st_out / "round_1" / "ckpt" / f"checkpoint_epoch_{ROUND_EPOCHS}.pth", r1_result]
    missing = [str(p) for p in outputs if not p.exists()]
    if missing:
        fail(f"self_train_second: stage outputs missing: {missing}")
    with open(r1_result, "rb") as f:
        r1_annos = pickle.load(f)
    check_result(np, r1_annos, ids, "SECOND round 1")
    with open(st_out / "round_1" / "metrics.jsonl") as f:
        r1_steps = [json.loads(line) for line in f]
    r1_losses = [{k: v for k, v in r.items() if k.startswith("train/")} for r in r1_steps]
    n_seed = sum(map(len, label_lines(label_dir, ids).values()))
    n_fused = sum(map(len, label_lines(r1_labels, ids).values()))
    emit({"phase": "self_train_second", "model": "second", "frames": len(ids),
          "train_batch": batch, "round0_lr": lr, "round0_train_steps": len(state.history),
          "round0_losses": [{"step": r["step"], **r["metrics"]} for r in state.history],
          "round1_train_steps": len(r1_steps), "round1_losses": r1_losses,
          "seed_labels": n_seed, "fused_labels": n_fused,
          "fused_labels_per_frame": n_fused / len(ids),
          "round0_detections": sum(len(a["score"]) for a in r0_annos),
          "round1_detections": sum(len(a["score"]) for a in r1_annos),
          "round0_ap": {k: float(v) for k, v in r0_ret.items() if k.endswith("_R40")},
          "files": [str(p.relative_to(root)) for p in outputs],
          "round0_stage_s": stages, "round1_stage_s": timings.get("round_1"),
          "round1_s": round_s, "fps_kernel_launches": dict(counts),
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": card})
    if len(r1_steps) != len(ids) // batch:
        fail(f"self_train_second: round 1 trained {len(r1_steps)} steps, not {len(ids) // batch}")
    bad = [r for r in r1_losses if not all(math.isfinite(v) for v in r.values())]
    if bad:
        fail(f"self_train_second: round 1's train losses not finite: {bad}")
    if n_fused < len(ids):
        fail(f"self_train_second: {n_fused} fused labels over {len(ids)} frames (< 1 a frame)")
    if any(counts.values()):
        fail(f"self_train_second: SECOND's round launched the fps kernels {dict(counts)}")


def phase_self_train_card_vs_cpu(torch, np, root, data_root, round0, card):
    """The round on the card against the port's CPU path: one scan's
    train-split detections (the round-0 checkpoint, the first test batch's
    first scan) and combine_labels on every frame (the driver's round-1
    labels against device=cpu)."""
    from modest_tpu_torch.cli import combine_labels
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.cli.train import load_model_config
    from modest_tpu_torch.data.loader import build_dataloader
    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.train.checkpoint import CheckpointManager
    from modest_tpu_torch.train.loop import _trim_predictions
    from modest_tpu_torch.utils.kitti_io import Calibration, load_velo_scan

    root = Path(root)
    ids = [f"{g:06d}" for g in origin_ids(root)]
    r0_annos = round0["annos"]
    cfg = load_model_config(REPO / FLAGSHIP_CFG)
    cfg.DATA_CONFIG.DATA_PATH = str(round0["data"])
    cfg.DATA_CONFIG.DATA_SPLIT["test"] = "train"
    cfg.DATA_CONFIG.INFO_PATH["test"] = ["kitti_infos_train.pkl"]
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = ROUND0_SCORE_THRESH
    eval_set, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, ROUND_EVAL_BATCH,
                                        training=False)
    t0 = time.perf_counter()
    batch = next(iter(loader))  # the test CLI's first batch: the same seed, the same points
    batch_s = time.perf_counter() - t0
    models = {}
    for where in ("cpu", "cuda"):
        models[where] = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=where)
        CheckpointManager(round0["out"] / "ckpt").restore_model(models[where])
    t0 = time.perf_counter()
    chain, card_final, final = forward_chain(torch, np, models["cuda"], models["cpu"], cfg.MODEL,
                                             torch.from_numpy(batch["points"][:1]))
    chain_s = time.perf_counter() - t0
    one = {k: batch[k][:1] for k in ("frame_id", "calib", "image_shape")}

    def annos(fin):
        return eval_set.generate_prediction_dicts(one, _trim_predictions(fin), cfg.CLASS_NAMES)[0]

    def match(got, want):
        pairs = match_1to1(np, got["boxes_lidar"], got["score"], want["boxes_lidar"],
                           want["score"])
        bad_yaw = sum(min(d, 2 * np.pi - d) >= 2e-3 for d in (
            abs(float(got["boxes_lidar"][a, 6]) - float(want["boxes_lidar"][j, 6]))
            % (2 * np.pi) for a, j in pairs))
        return len(pairs) - bad_yaw, max(len(got["score"]), len(want["score"]))

    want = annos(final)
    got = r0_annos[0]
    matched, total = match(got, want)
    frac = matched / max(total, 1)
    rerun, rerun_total = match(got, annos(card_final))  # the CLI's boxes, the chain's card run

    # combine_labels: the driver's round-1 labels (device=cuda) against device=cpu
    ov = [f"work_dir={root}", "data_paths=fw70_2m", f"data_root={data_root}", "fov_only=true",
          f"det_result_path={round0['result']}"]
    t1 = time.perf_counter()
    combine_labels.main(ov + [f"save_path={root / 'fused_cpu'}", "device=cpu"])
    combine_cpu_s = time.perf_counter() - t1
    card_labels = label_lines(root / "intermediate_results" / "round_1_labels", ids)
    cpu_labels = label_lines(root / "fused_cpu", ids)
    fcfg = load_pipeline_config("combine_labels", ov)
    shell, differ, unexplained = 0, [], []
    for pos, fid in enumerate(ids):
        calib = Calibration(str(Path(data_root) / "calib" / f"{fid}.txt"))
        ptc_rect = calib.project_velo_to_rect(
            load_velo_scan(Path(data_root) / "velodyne" / f"{fid}.bin")[:, :3])
        pp = np.load(Path(fcfg.data_paths.pp_score_path) / f"{fid}.npy")
        with open(Path(fcfg.data_paths.bbox_info_save_dst) / f"{fid}.pkl", "rb") as f:
            gen = pickle.load(f)
        n = fusion_shell_pairs(torch, fcfg, r0_annos[pos], gen, ptc_rect, pp)
        shell += n
        if card_labels[fid] != cpu_labels[fid]:
            differ.append(fid)
            if n == 0:
                unexplained.append(fid)
    emit({"phase": "self_train_card_vs_cpu", "frame": got["frame_id"],
          "card_detections": len(got["score"]), "cpu_detections": len(want["score"]),
          "matched": matched, "match_frac": frac, **chain,
          "cli_vs_card_forward": rerun / max(rerun_total, 1), "chain_s": chain_s,
          "host_batch_s": batch_s, "host_batch_scans": ROUND_EVAL_BATCH,
          "combine_frames": len(ids), "combine_frames_differ": differ,
          "combine_iou_shell": NMS_IOU_SHELL, "combine_shell_pairs": shell,
          "combine_cpu_s": combine_cpu_s, "card": card})
    if got["frame_id"] != want["frame_id"]:
        fail(f"self_train card vs CPU: frame {got['frame_id']} against {want['frame_id']}")
    check_chain(chain, frac, total, f"self_train card vs CPU, frame {got['frame_id']} "
                f"({matched}/{total} boxes 1:1)", parted=rerun < rerun_total)
    if unexplained:
        fail(f"combine_labels card vs CPU: frames {unexplained} differ with no box pair within "
             f"{NMS_IOU_SHELL} of the NMS threshold")


def phase_knn(torch, dev, card):
    """The windowed kNN's path: tools/knn_bench.py at its four shapes, B = 4
    (nearest_k with the dense fallback, the checks, the timed calls)."""
    from modest_tpu_torch.ops import knn
    from modest_tpu_torch.tools import knn_bench

    counts = knn.knn_windows_cuda.launches  # per kernel
    counts.update(dict.fromkeys(counts, 0))
    knn.nearest_k.dense_fallbacks = 0
    rows = knn_bench.run(dev, batch=BATCH, iters=KNN_ITERS)
    torch.cuda.synchronize()
    launches, fallbacks = dict(counts), knn.nearest_k.dense_fallbacks
    # per shape: nearest_k, the checked run, a warm-up and the timed runs;
    # every shape has k <= 32, the select kernel's
    if launches != {"knn_select_kernel": len(rows) * (3 + KNN_ITERS), "knn_rounds_kernel": 0}:
        fail(f"tools/knn_bench.py launched the knn kernels {launches} times over {len(rows)} "
             f"shapes")
    for row in rows:
        emit({"phase": "knn", **row, "card": card})
        if row["certificate"] and row["slot_match_pct"] < MIN_SLOT_MATCH_PCT:
            fail(f"knn {row['tag']}: slot match {row['slot_match_pct']}% < {MIN_SLOT_MATCH_PCT}%")
        if row["dense_fallbacks"] != (0 if row["certificate"] else 1):
            fail(f"knn {row['tag']}: certificate {row['certificate']} but "
                 f"{row['dense_fallbacks']} dense fallbacks")
    return rows, launches, fallbacks


def knn_pairs_needed(torch, args, keys, w: int) -> int:
    """Window pairs an x-sorted scan must reach for these results: those
    whose dx*dx key, masked as the kernel masks it, lies at or below the
    query's k-th key."""
    qx, _, _, xs, _, _, lo = args
    kth = keys[:, -1:] & -w
    cx = xs.reshape(-1)
    lane = torch.arange(w, device=qx.device)
    step = max(1, (1 << 24) // w)  # queries per slice
    needed = 0
    for q0 in range(0, qx.shape[0], step):
        q = torch.arange(q0, min(qx.shape[0], q0 + step), device=qx.device)
        dx = qx[q] - cx[lo[q // 32].long()[:, None] * 128 + lane]
        needed += int((((dx * dx).view(torch.int32) & -w) <= kth[q]).sum())
    return needed


def knn_extra_cases(np):
    """The selection's edge cases at path sizes: k = w / 4 at SA2's shape
    (the k-round kernel) and, at SA1's, a cloud of eightfold duplicates."""
    from modest_tpu_torch.tools import knn_bench

    rng = np.random.RandomState(1)
    xyz = knn_bench.make_cloud(rng, BATCH, 4096)
    q = np.take_along_axis(xyz, rng.choice(4096, (BATCH, 1024, 1)).astype(np.int64), 1)
    dup = np.repeat(knn_bench.make_cloud(rng, BATCH, 12288 // 8), 8, axis=1)
    qd = np.take_along_axis(dup, rng.choice(12288, (BATCH, 4096, 1)).astype(np.int64), 1)
    return [{"tag": "k=w/4 at SA2 1024<-4096 k=256", "m": 1024, "n": 4096, "k": 256,
             "radius": 1.0, "xyz": xyz, "new_xyz": q},
            {"tag": "duplicates x8 at SA1 4096<-12288 k=32", "m": 4096, "n": 12288, "k": 32,
             "radius": 0.5, "xyz": dup, "new_xyz": qd}]


def phase_knn_vs_plain(torch, np, dev, card):
    """The kNN kernels against their plain twin on the window inputs
    nearest_k builds at the four shapes and the two edge cases: packed keys
    equal."""
    from modest_tpu_torch.ops import knn
    from modest_tpu_torch.tools import knn_bench
    from modest_tpu_torch.utils.device import device_ms

    rows = []
    for case in knn_bench.shape_cases(BATCH) + knn_extra_cases(np):
        new_xyz = torch.from_numpy(case["new_xyz"]).to(dev)
        xyz = torch.from_numpy(case["xyz"]).to(dev)
        k, w = case["k"], knn._pick_window(case["n"])
        args = knn.sorted_windows(new_xyz, xyz, w, case["radius"])["args"]
        got = knn.knn_windows_cuda(*args, w=w, k=k, frames=BATCH)
        want = knn.knn_windows_plain(*args, w=w, k=k, frames=BATCH)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        errors = torch.zeros(1, dtype=torch.int32, device=dev)

        def launch():
            return knn.knn_windows_cuda(*args, w=w, k=k, frames=BATCH, errors=errors)

        ms = device_ms(launch, dev, 10)
        kernel_ms = kernel_device_ms(launch, 10, "knn_")
        if int(errors.item()):
            fail(f"knn kernel at {case['tag']}: a window outside its frame")
        plain_ms = device_ms(lambda: knn.knn_windows_plain(*args, w=w, k=k, frames=BATCH), dev, 3)
        bm, bn = BATCH * case["m"], BATCH * case["n"]
        needed = knn_pairs_needed(torch, args, want, w)
        nbytes = 3 * bm * 4 + 3 * bn * 4 + (bm // knn.QC) * 4 + bm * k * 4
        bound_ms, bound_by = bound(needed * KNN_OPS_PER_PAIR, nbytes)
        row = {"phase": "knn_vs_plain", "tag": case["tag"], "B": BATCH, "M": case["m"],
               "N": case["n"], "k": k, "window": w,
               "kernel": "knn_select_kernel" if k <= knn.SELECT_MAX_K else "knn_rounds_kernel",
               "pairs": bm * w, "pairs_needed": needed, "mismatches": mismatches,
               "max_abs_err": max_abs_err, "ms": ms, "kernel_device_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "card": card}
        emit(row)
        if mismatches:
            fail(f"knn kernel disagrees with its plain version at {case['tag']}: "
                 f"{mismatches} keys")
        rows.append(row)
    # a window that leaves its frame is refused, not read, by either kernel
    for k in (32, 256):
        bad = args[-1].clone()
        bad[-1] = 0  # the last chunk belongs to the last frame
        try:
            knn.knn_windows_cuda(*args[:-1], bad, w=w, k=min(k, w), frames=BATCH)
        except ValueError:
            pass
        else:
            fail(f"knn_windows_cuda at k = {k} accepted a window outside its frame")
    return rows


def phase_gather(torch, dev, card):
    """The gathers' path: tools/gather_probe.py at its full size."""
    from modest_tpu_torch.ops import gather
    from modest_tpu_torch.tools import gather_probe

    gather.take_cuda.launches = gather.take_along_axis_cuda.launches = 0
    rows = gather_probe.run(dev, iters=GATHER_ITERS)
    torch.cuda.synchronize()
    launches = {"take": gather.take_cuda.launches,
                "take_along_axis": gather.take_along_axis_cuda.launches}
    for row in rows:
        emit({"phase": "gather_probe", **row, "card": card})
        if not row.get("correct", True):
            fail(f"gather probe {row['probe']} is wrong")
    # take: the small and the full probe, each checked, warmed up and timed;
    # take_along_axis: two tiles, each checked, warmed up and timed
    want = {"take": 2 * (2 + GATHER_ITERS), "take_along_axis": 2 * (2 + GATHER_ITERS)}
    if launches != want:
        fail(f"tools/gather_probe.py launched the gather kernels {launches} times, not {want}")
    return launches


def gather_cases(torch, dev):
    """(kernel, probe, table, idx): the probe's shapes, then take's read-only
    branch at the probe's full size (uniform indices over the whole table,
    and a band wider than the kernel's shared window), all timed."""
    import numpy as np

    from modest_tpu_torch.tools import gather_probe as gp

    idx_h, labels_h, _ = gp.probe_data()
    idx = torch.from_numpy(idx_h).to(dev)
    labels = torch.from_numpy(labels_h).to(dev)
    uniform = np.random.RandomState(1).randint(0, gp.N, size=(gp.N, gp.K)).astype(np.int32)
    wide = gp.probe_data(w=GATHER_WIDE_BAND)[0]
    cases = [("take", "full", labels, idx),
             ("take", "small", labels[:1024].contiguous(), (idx[:256] % 1024).contiguous()),
             ("take", "uniform", labels, torch.from_numpy(uniform).to(dev)),
             ("take", "wide_band", labels, torch.from_numpy(wide).to(dev))]
    for r in (8, 256):
        cases.append(("take_along_axis", f"rows_{r}", labels[:gp.W].repeat(r, 1).contiguous(),
                      (idx[:r] % gp.W).contiguous()))
    return cases


def phase_gather_vs_plain(torch, np, dev, card):
    """Both gather kernels against their plain twins at the probe's shapes and
    on every branch of take (the shared window, the read-only path, an
    unaligned head, a ragged tail), with the one PyTorch call that computes
    each (timed only), and each kernel's launch floor: its device time on
    one element. A row's bound is the byte bound; ``bound_with_floor_ms``
    is the larger of it and the kernel's floor."""
    from modest_tpu_torch.ops import gather
    from modest_tpu_torch.utils.device import device_ms

    floors = {}
    one = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    errors = torch.zeros(1, dtype=torch.int32, device=dev)
    for name in ("take", "take_along_axis"):
        cuda_fn = getattr(gather, f"{name}_cuda")
        tab = one.view(1) if name == "take" else one
        floors[name] = kernel_launch_device_ms(lambda: cuda_fn(tab, one, errors),
                                               GATHER_FLOOR_REPS, f"{name}_kernel")
        emit({"phase": "gather_floor", "kernel": name, "table": list(tab.shape), "idx": [1, 1],
              "reps": GATHER_FLOOR_REPS, "kernel_device_ms": floors[name], "card": card})
    gather.raise_on_errors(errors, "gather_floor")
    cases = gather_cases(torch, dev)
    rows = {}
    for name, probe, tab, ix in cases:
        cuda_fn = getattr(gather, f"{name}_cuda")
        plain_fn = getattr(gather, f"{name}_plain")
        got, want = cuda_fn(tab, ix), plain_fn(tab, ix)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = device_ms(lambda: cuda_fn(tab, ix, errors), dev, 20)
        kernel_ms = kernel_launch_device_ms(lambda: cuda_fn(tab, ix, errors), 20,
                                            f"{name}_kernel")
        gather.raise_on_errors(errors, name)
        plain_ms = device_ms(lambda: plain_fn(tab, ix), dev, 5)
        if name == "take":  # the library call: one index, int32 indices as they are
            def library():
                return tab[ix]
        else:  # torch.gather takes only int64 indices: widened beforehand
            ix64 = ix.long()

            def library():
                return torch.gather(tab, 1, ix64)
        library_ms = device_ms(library, dev, 20)
        # every kernel the call starts, by torch.profiler: device time beside device time
        library_device_ms = kernel_device_ms(library, 20, "")
        # idx read and out written once; of the table, the 32-byte sectors
        # this run's indices touch, each read once
        flat = ix.long() if name == "take" else ix.long() + torch.arange(
            ix.shape[0], device=dev)[:, None] * tab.shape[1]
        table_sectors = int(torch.unique(flat // (SECTOR_BYTES // 4)).numel())
        nbytes = ix.numel() * 4 * 2 + table_sectors * SECTOR_BYTES
        bound_ms, bound_by = bound(0, nbytes)
        row = {"phase": "gather_vs_plain", "kernel": name, "probe": probe,
               "table": list(tab.shape), "idx": list(ix.shape),
               "table_sectors_touched": table_sectors, "mismatches": mismatches,
               "max_abs_err": max_abs_err, "ms": ms, "kernel_device_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "launch_floor_ms": floors[name],
               "bound_with_floor_ms": max(bound_ms, floors[name] or 0.0),
               "library_ms": library_ms, "library_device_ms": library_device_ms, "card": card}
        emit(row)
        if mismatches:
            fail(f"{name} kernel disagrees with its plain version at {probe}: {mismatches}")
        rows[(name, probe)] = row
    # take's edges, bit for bit: idx at storage offset 1 (an unaligned head,
    # then a ragged tail), sizes that are no multiple of 4, one index
    labels, idx, uniform = cases[0][2], cases[0][3], cases[2][3]
    flat = idx.reshape(-1)
    n, k = idx.shape
    edges = {"offset_1": flat[1:1 + (n - 1) * k].view(n - 1, k),
             "odd_size": idx[:1023, :7].contiguous(), "offset_1_three": flat[1:4],
             "one": flat[:1]}
    for probe, ix in edges.items():
        got, want = gather.take_cuda(labels, ix), gather.take_plain(labels, ix)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        emit({"phase": "gather_edges", "kernel": "take", "probe": probe, "idx": list(ix.shape),
              "storage_offset": ix.storage_offset(), "mismatches": mismatches, "card": card})
        if mismatches or got.shape != ix.shape:
            fail(f"take kernel disagrees with its plain version at {probe}: {mismatches}")
    # an out-of-range index is refused, not clamped: in a staged tile, in a
    # tile that gathers through the read-only path, and below 0
    for probe, src, at, value in (("staged", idx, (1, 3), labels.shape[0]),
                                  ("read_only", uniform, (5, 5), labels.shape[0]),
                                  ("negative", idx, (2, 7), -1)):
        bad = src[:64].clone()
        bad[at] = value
        try:
            gather.take_cuda(labels, bad)
        except IndexError:
            pass
        else:
            fail(f"take_cuda accepted an index outside its table ({probe})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (REPO / "modest_tpu_torch").is_dir():
        print(f"chip_smoke: no modest_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES
    from modest_tpu_torch.models import api, build_network
    from modest_tpu_torch.tools.pipeline_scenes import write_synth_dataset
    from modest_tpu_torch.tools.scenes import bench_scans
    from modest_tpu_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    build_kernels(card)

    scenes = bench_scans(BATCH, N_POINTS, seed=0)
    fps_in = fps_inputs(torch, dev, scenes)
    fps_rows = phase_fps(torch, fps_in, card)
    stack_rows = phase_stack_fps(torch, dev, card)
    iou_rows = phase_iou_kernel_vs_plain(torch, np, dev, card)

    cfg = Config(POINTRCNN_DYNAMIC_OBJ)
    model = build_network(cfg, len(POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES), device="cuda", seed=0)
    randomise_bn(torch, model, seed=0)
    fps_launches, iou_forward_launches = phase_forward(torch, dev, api, model, cfg, scenes,
                                                      card)
    phase_card_vs_cpu(torch, np, api, build_network, model, cfg, scenes, card)
    del model
    torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        phase_train_dataset(tmp, card)
        train_launches, train_steps = phase_train(torch, np, dev, tmp, card)
        phase_train_overfit(torch, np, dev, tmp, card)
        phase_train_card_vs_cpu(torch, np, dev, tmp, card)
        torch.cuda.empty_cache()
        ddp_launches, ddp_steps, ddp_eval_launches = phase_ddp_train(torch, np, tmp, card)
        ddp_fps = phase_ddp_step_vs_single(torch, np, dev, tmp, card)
        phase_nccl_world1(torch, np, dev, tmp, card)
        phase_grid(torch, np, api, build_network, dev, tmp, card)
        phase_ddp_script(torch, np, tmp, card)
        pv_row, (pv_train_launches, pv_steps, pv_test_batches) = phase_pv_rcnn(
            torch, np, api, build_network, dev, tmp, card)
        phase_two_stage(torch, np, api, build_network, dev, tmp, card)
        nusc_train_launches, nusc_steps, nusc_test_launches, nusc_test_batches = \
            phase_nuscenes_boston(torch, np, dev, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    kitti_forward_launches, kitti_train_launches, kitti_test_launches, kitti_steps = phase_kitti(
        torch, np, api, build_network, dev, card)
    waymo_row, (waymo_train_launches, waymo_steps, waymo_test_launches) = phase_waymo(
        torch, np, api, build_network, dev, card)
    phase_nuscenes_cbgs(torch, np, api, build_network, dev, card)
    demo_launches = phase_caddn(torch, np, api, build_network, dev, card)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    try:
        t0 = time.perf_counter()
        root, data_root = write_synth_dataset(
            tmp, traversals=PP_TRAVERSALS, frames_per_traversal=PP_FRAMES_PER_TRAVERSAL,
            origins=PP_ORIGINS, seed=0, **FRAME)
        emit({"phase": "pipeline_dataset", "frames": PP_TRAVERSALS * PP_FRAMES_PER_TRAVERSAL
              + PP_ORIGINS, "seconds": time.perf_counter() - t0, "card": card})
        pp_row = phase_pp_score(torch, np, dev, root, data_root, card)
        seed_row = phase_seed_labels(torch, np, dev, root, data_root, card)
        rc_row, rc_state = phase_radius_count(torch, np, dev, data_root, root, card)
        db_rows, tie_row, odd_row = phase_dbscan(torch, np, dev, data_root, root, card)
        phase_pipeline_card_vs_cpu(torch, np, dev, data_root, root, rc_state, card)
        st_launches, st_forwards, round0 = phase_self_train(torch, np, dev, root, data_root, card)
        phase_self_train_card_vs_cpu(torch, np, root, data_root, round0, card)
        phase_self_train_second(torch, np, dev, root, data_root, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    prep_launches = phase_prep(torch, np, dev, card)
    knn_rows, knn_launches, knn_fallbacks = phase_knn(torch, dev, card)
    knn_kernel_rows = phase_knn_vs_plain(torch, np, dev, card)
    knn_path_rows = knn_kernel_rows[:len(knn_rows)]
    gather_launches = phase_gather(torch, dev, card)
    gather_rows = phase_gather_vs_plain(torch, np, dev, card)

    fps_kernels = []
    row_keys = ("B", "N", "npoint", "cluster", "per_thread", "max_abs_err", "ms",
                "kernel_device_ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    for kernel, replaces, stages, train_stages, round_stages, nusc_stages in (
            ("fps_cluster_kernel", "modest_tpu/ops/pallas_fps.py:146",
             ("backbone_sa1", "backbone_sa2", "backbone_sa3"), ("train_sa1", "train_sa2",
                                                                 "train_sa3"), (),
             ("nusc2_sa1", "nusc2_sa2", "nusc2_sa3")),
            ("fps_warp_kernel", "modest_tpu/ops/pallas_fps.py:157", FPS_SMALL_STAGES,
             FPS_TRAIN_SMALL_STAGES, tuple(stage for stage, *_ in FPS_ROUND_SHAPES),
             ("nusc2_sa4",))):
        path = [fps_rows[stage] for stage in stages]
        train_path = [fps_rows[stage] for stage in train_stages]
        # round 0 tests at B = 4 (the path's rows), trains as the train rows; round 1
        # tests at the train batch: the train rows' backbone, the round rows' RoIs
        round_stages = (*stages, *train_stages, *round_stages)
        fps_kernels.append({
            "name": kernel, "route": "cuda", "source": "modest_tpu_torch/csrc/fps.cu",
            "replaces": replaces, "launches": fps_launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "mismatches": sum(r["mismatches"] for r in path),
            "ms": sum(r["ms"] for r in path),
            "kernel_device_ms": None if any(r["kernel_device_ms"] is None for r in path)
            else sum(r["kernel_device_ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_ms"] for r in path), "bound_by": "operations",
            "library_ms": None, "cluster": {r["stage"]: r["cluster"] for r in path},
            "us_per_step": {r["stage"]: r["us_per_step"] for r in path},
            "shapes": f"sum over the FPS calls {', '.join(stages)} of one B=4 forward",
            "train_launches": train_launches[kernel], "train_steps": train_steps,
            "train_max_abs_err": max(r["max_abs_err"] for r in train_path),
            "train_ms": sum(r["ms"] for r in train_path),
            "train_kernel_device_ms": None if any(r["kernel_device_ms"] is None
                                                  for r in train_path)
            else sum(r["kernel_device_ms"] for r in train_path),
            "train_plain_ms": sum(r["plain_ms"] for r in train_path),
            "train_bound_ms": sum(r["bound_ms"] for r in train_path),
            "train_shapes": f"sum over {', '.join(train_stages)} of one B=2 train step",
            "self_train_launches": st_launches[kernel], "self_train_forwards": st_forwards,
            "self_train_max_abs_err": max(fps_rows[stage]["max_abs_err"]
                                          for stage in round_stages),
            "self_train_stages": list(round_stages),
            "self_train_shapes": "launches over cli/self_train.py's round 1: the train steps "
                                 "and the train-split test batches, 3 per forward",
            "pv_rcnn_launches": pv_row["fps_kernel_launches"][kernel],
            "pv_rcnn_forwards": PV_TIMED_ITERS,
            "pv_rcnn_train_launches": pv_train_launches[kernel], "pv_rcnn_train_steps": pv_steps,
            "pv_rcnn_test_batches": pv_test_batches,
            **({stage: {key: fps_rows[stage][key] for key in row_keys}
                for stage in ("pv_keypoints", "train_pv_keypoints", "waymo_keypoints",
                              "n_98304")}
               if kernel == "fps_cluster_kernel" else {}),
            "pv_rcnn_shapes": "keypoint FPS, one call per PV-RCNN forward (B=4) and train step "
                              "(B=2) of 65536 points to 2048; launches over the timed forwards, "
                              "then the train steps and the eval-after-train batches; "
                              "waymo_keypoints (2, 131072 -> 2048): Waymo's PV-RCNN, the "
                              "32-point range past 65536; n_98304 (4, 98304 -> 2048) on no "
                              "path",
            "waymo_launches": waymo_row["fps_kernel_launches"][kernel],
            "waymo_forwards": WAYMO_TIMED_ITERS,
            "waymo_fps_index_mismatches": waymo_row["fps_index_mismatches"],
            "waymo_train_launches": waymo_train_launches[kernel],
            "waymo_train_steps": waymo_steps,
            "waymo_test_launches": waymo_test_launches if kernel == "fps_cluster_kernel"
            else {metric: 0 for metric in waymo_test_launches},
            "waymo_shapes": "Waymo PV-RCNN (configs/models/waymo_models/pv_rcnn.yaml) from the "
                            "loader: one (2, 131072 -> 2048) call per forward, train step and "
                            "test batch (row waymo_keypoints); launches over the timed "
                            "forwards, the train steps and cli/test.py's batch under each "
                            "EVAL_METRIC",
            "nuscenes_boston_train_launches": nusc_train_launches[kernel],
            "nuscenes_boston_train_steps": nusc_steps,
            "nuscenes_boston_test_launches": nusc_test_launches[kernel],
            "nuscenes_boston_test_batches": nusc_test_batches,
            "nuscenes_boston": {stage: {key: fps_rows[stage][key] for key in row_keys}
                                for stage in nusc_stages},
            "nuscenes_boston_shapes": "the 6144-point backbone's calls at the config's B=2 "
                                      "(its RoI tower: train_roi_* and round_roi_*)",
            "kitti_launches": {stem: n[kernel] for stem, n in kitti_forward_launches.items()
                               if n[kernel]},
            "kitti_forwards": KITTI_TIMED_ITERS + 1,
            "kitti_train_launches": {stem: n[kernel] for stem, n in kitti_train_launches.items()
                                     if n[kernel]},
            "kitti_train_steps": {stem: n for stem, n in kitti_steps.items()
                                  if kitti_train_launches[stem][kernel]},
            "kitti_test_launches": {stem: n[kernel] for stem, n in kitti_test_launches.items()
                                    if n[kernel]},
            **({"kitti": {stage: {key: fps_rows[stage][key] for key in row_keys}
                          for stage in ("kitti_sa1", "train_kitti_sa1")}}
               if kernel == "fps_cluster_kernel" else {}),
            "ddp_train_launches": [n[kernel] for n in ddp_launches],
            "ddp_train_steps": ddp_steps,
            "ddp_eval_launches": [n[kernel] for n in ddp_eval_launches],
            "ddp_mismatches": sum(r["mismatches"] for rows in ddp_fps for r in rows
                                  if kernel in r["kernel"]),
            "ddp_shapes": "phase ddp_train: launches of each of the 2 processes sharing the "
                          "card (B=2 of a global 4, the train_* rows' shapes) over its steps, "
                          "then over its batches of the merged eval; ddp_mismatches: the "
                          "indices against the plain FPS on each process's first batch "
                          "(phase ddp_step_vs_single)",
            "demo_launches": demo_launches[kernel], "demo_frames": DEMO_FRAMES,
            "demo_shapes": "cli/demo.py, the flagship PointRCNN at B=1 on raw .bin scans "
                           "sampled to 12288 points; the first frame's calls held against "
                           "the plain FPS (phase demo)",
            "kitti_shapes": "KITTI PointRCNN and PointRCNN-IoU (16384 points: SA1 kitti_sa1 "
                            "at B=4, train_kitti_sa1 at B=2; its other levels and RoI tower "
                            "the flagship's shapes) and KITTI PV-RCNN's keypoints "
                            "(pv_keypoints, train_pv_keypoints); launches over each model's "
                            "timed forwards, its train steps (PointRCNN-IoU at its B=3) and "
                            "its cli/test.py batches over the 16 scans",
            "stack_launches": {stage: r["fps_kernel_launches"][kernel]
                               for stage, r in stack_rows.items() if r["kernel"] == kernel},
            "stack": {stage: {key: r[key] for key in ("counts", *row_keys)}
                      for stage, r in stack_rows.items() if r["kernel"] == kernel},
            "stack_shapes": "ops/pointnet2_stack.py::farthest_point_sample_stack on ragged "
                            "batches (phase stack_fps_vs_plain): one launch a call, each "
                            "call's indices equal to the plain masked FPS's; bound_ms from "
                            "the valid points only"})
    emit({"kernels": [*fps_kernels, {
        "name": "radius_count", "route": "cuda", "source": "modest_tpu_torch/csrc/radius_count.cu",
        "replaces": "modest_tpu/ops/pallas_radius_count.py:81",
        "launches": pp_row["radius_count_launches"], "max_abs_err": rc_row["max_abs_err"],
        "mismatches": rc_row["mismatches"], "ms": rc_row["ms"], "plain_ms": rc_row["plain_ms"],
        "bound_ms": rc_row["bound_ms"], "bound_by": rc_row["bound_by"], "library_ms": None,
        "kernel_device_ms": rc_row["kernel_device_ms"], "chunk_tiles": rc_row["chunk_tiles"],
        "prep_launches": prep_launches,
        "work_items": rc_row["work_items"],
        "shapes": f"one PP origin: {rc_row['queries']} queries, T={rc_row['T']}, "
                  f"M={rc_row['M']}; launches over {pp_row['origins_timed']} origins",
    }, {
        "name": "dbscan_edge", "route": "cuda", "source": "modest_tpu_torch/csrc/dbscan.cu",
        "replaces": "modest_tpu/ops/pallas_dbscan.py:75",
        "launches": seed_row["dbscan_launches"]["dbscan_edge"],
        "calls": seed_row["dbscan_calls"]["dbscan_edge"], "max_abs_err": 0 if not any(
            r["nbr_mismatches"] or r["tie_mismatches"] or r["core_mismatches"]
            for r in (*db_rows, tie_row, odd_row)) else None,
        "mismatches": sum(r["nbr_mismatches"] + r["tie_mismatches"] + r["core_mismatches"]
                          for r in (*db_rows, tie_row, odd_row)),
        "ms": sum(r["edge_ms"] for r in db_rows) / len(db_rows),
        "kernel_device_ms": None if any(v is None for r in db_rows
                                        for v in r["edge_kernel_device_ms"].values())
        else sum(sum(r["edge_kernel_device_ms"].values()) for r in db_rows) / len(db_rows),
        "kernel_device_ms_by_kernel": {kern: [r["edge_kernel_device_ms"][kern] for r in db_rows]
                                       for kern in EDGE_KERNELS},
        "plain_ms": sum(r["edge_plain_ms"] for r in db_rows) / len(db_rows),
        "bound_ms": sum(r["edge_bound_ms"] for r in db_rows) / len(db_rows), "bound_by": "bytes",
        "library_ms": None, "ms_by_group": [r["edge_ms"] for r in db_rows],
        "shapes": f"mean over the {len(db_rows)} seed groups of {db_rows[0]['frames']} frames "
                  f"(N={db_rows[0]['N']}, k={db_rows[0]['k']}); launches and calls over "
                  f"{seed_row['frames_timed']} frames",
    }, {
        "name": "dbscan_prop", "route": "cuda", "source": "modest_tpu_torch/csrc/dbscan.cu",
        "replaces": "modest_tpu/ops/pallas_dbscan.py:117",
        "launches": seed_row["dbscan_launches"]["dbscan_prop"],
        "calls": seed_row["dbscan_calls"]["dbscan_prop"],
        "host_reads": seed_row["dbscan_host_reads"],
        "fixup_rounds": seed_row["dbscan_fixup_rounds"],
        "max_abs_err": 0 if not any(r["label_mismatches"] or r["timed_label_mismatches"]
                                    for r in (*db_rows, tie_row, odd_row)) else None,
        "mismatches": sum(r["label_mismatches"] + r["timed_label_mismatches"]
                          for r in (*db_rows, tie_row, odd_row)),
        "ms": sum(r["prop_ms"] for r in db_rows) / len(db_rows),
        "kernel_device_ms": None if any(r["prop_kernel_device_ms"] is None for r in db_rows)
        else sum(r["prop_kernel_device_ms"] for r in db_rows) / len(db_rows),
        "plain_ms": sum(r["prop_plain_ms"] for r in db_rows) / len(db_rows),
        "bound_ms": sum(r["prop_bound_ms"] for r in db_rows) / len(db_rows),
        "bound_by": "bytes", "library_ms": None,
        "ms_by_group": [r["prop_ms"] for r in db_rows],
        "tie_chain_ms": tie_row["prop_ms"],
        "shapes": f"mean over the {len(db_rows)} seed groups of {db_rows[0]['frames']} frames "
                  f"(N={db_rows[0]['N']}, k={db_rows[0]['k']}); launches, calls, host reads "
                  f"and fix-up rounds over {seed_row['frames_timed']} frames",
    }, {
        "name": "knn", "route": "cuda", "source": "modest_tpu_torch/csrc/knn.cu",
        "replaces": "modest_tpu/ops/pallas_knn.py:99",
        "launches": sum(knn_launches.values()), "launches_by_kernel": knn_launches,
        "dense_fallbacks": knn_fallbacks,
        "max_abs_err": max(r["max_abs_err"] for r in knn_kernel_rows),
        "mismatches": sum(r["mismatches"] for r in knn_kernel_rows),
        "ms": sum(r["ms"] for r in knn_path_rows),
        "kernel_device_ms": None if any(r["kernel_device_ms"] is None for r in knn_path_rows)
        else sum(r["kernel_device_ms"] for r in knn_path_rows),
        "plain_ms": sum(r["plain_ms"] for r in knn_path_rows),
        "bound_ms": sum(r["bound_ms"] for r in knn_path_rows), "bound_by": "operations",
        "library_ms": None, "dense_ms": sum(r["dense_ms"] for r in knn_rows),
        "rounds_kernel_ms": knn_kernel_rows[len(knn_path_rows)]["ms"],
        "shapes": "sum over the 4 shapes of tools/knn_bench.py at B=4 (SA1, SA2, FP0, FP1), "
                  "all knn_select_kernel (k <= 32); launches over its run; knn_rounds_kernel "
                  "(k > 32) held at k = w/4 in phase knn_vs_plain only",
    }, {
        "name": "take", "route": "cuda", "source": "modest_tpu_torch/csrc/gather.cu",
        "replaces": "scripts_dev/gather_probe.py:119", "launches": gather_launches["take"],
        **{key: gather_rows[("take", "full")][key] for key in (
            "max_abs_err", "mismatches", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "launch_floor_ms", "bound_with_floor_ms", "library_ms",
            "library_device_ms")},
        "shapes": "table (131072,), idx (131072, 70); launches over tools/gather_probe.py",
    }, {
        "name": "take_along_axis", "route": "cuda", "source": "modest_tpu_torch/csrc/gather.cu",
        "replaces": "scripts_dev/gather_probe.py:148",
        "launches": gather_launches["take_along_axis"],
        **{key: gather_rows[("take_along_axis", "rows_256")][key] for key in (
            "max_abs_err", "mismatches", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "launch_floor_ms", "bound_with_floor_ms", "library_ms",
            "library_device_ms")},
        "shapes": "tab (256, 4096), idx (256, 70); launches over tools/gather_probe.py",
    }, {
        "name": "iou3d_overlap", "route": "cuda", "source": "modest_tpu_torch/csrc/iou3d.cu",
        "replaces": None, "launches": iou_forward_launches,
        "max_abs_err": max(r["max_abs_err"] for r in iou_rows if "case" in r),
        "mismatches": sum(r["mismatches"] for r in iou_rows if "case" in r),
        **{key: {r["case"]: r[key] for r in iou_rows if "ms" in r} for key in (
            "ms", "kernel_device_ms", "plain_ms", "bound_ms")},
        "bound_by": "operations", "library_ms": None,
        "nms_ms": {r["cell"]: r["nms_ms"] for r in iou_rows if "cell" in r},
        "plain_nms_ms": {r["cell"]: r["plain_nms_ms"] for r in iou_rows if "cell" in r},
        "shapes": "ms by NMS shape (float32, tools/iou_cases.py::NMS_SHAPES); launches over "
                  "one B=4 flagship forward (its proposal and post NMS); nms_ms: nms_bev at "
                  "each cell's NMS load through the kernel, plain_nms_ms through the twin",
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
