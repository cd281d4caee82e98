#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``graphnet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (also printed as the raw
   ``nvidia-smi --query-gpu=name,power.limit`` line);
2. build: compiles every CUDA kernel of the port from
   ``graphnet_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
   build_flash: the registers, shared memory and spills of the flash
   forward, dq and dkv kernels (rows 5a-c), from the ptxas report;
   build_rel: the same for the rel forward, dq and dkv kernels (rows
   6a-c), with their dynamic shared memory at 12 and 24 heads;
   build_edgeconv_bwd: the same for each kernel of the EdgeConv
   backward (row 3); build_edgeconv_fwd: for the EdgeConv forward and
   the fused EdgeConv + kNN (rows 2 and 4), each kernel's registers and
   spills, and at H1 = 128 and 336 its dynamic shared memory and blocks
   an SM;
3. knn: the kNN kernel against its plain PyTorch version on the card,
   for x, y, z (D=3) and x, y, z, t (D=4, TITO's graph): both centre by
   one rule, so indices and edge masks must be identical, and two runs
   the same bits (B=128 at L=128, events of 0, 1 and 5 nodes, B=1 at L =
   16, 128, 512 and 1024, B=2 at L=4096, TITO's B=8 at L=1024, D=4 at
   L=4096, integer grids with exact ties, strided views of 7 feature
   columns, the query itself allowed, k = 1, 12 and 16, an all-masked
   batch, and events whose centre the kernel sums serially; since the
   kernel takes k up to 32, k = 32 at B=128, L=128 for D = 3 and 4, one
   event of 512, events of 20-33 nodes at L=33, the grids with and
   without self, and k = 17 and 24; since the rounds kernel takes k
   past 32 and L past 8192, k = 48 at B=128, L=128 for D = 3 and 4, k =
   33 and 64, the grids at k = 40 with and without self, all masked and
   the serial centre at k = 40, a view at k = 40, one event of 12288
   nodes, two of 9000 (D=4) and one of 8193 at k = 48);
4. edgeconv: the fused EdgeConv forward kernel against its plain version
   (both layer shapes and H1=100, H2=72, add/max/mean, fp32 and bf16,
   k = 8, 1, 3, 12 and 64, events of 0, 1, 2, k and k+1 nodes at L = 48
   and 112, L=512, TITO's B=8, L=1024, H1 = H2 = 256 with max); two
   runs must give the same bits;
   edgeconv_knn: the fused EdgeConv + kNN kernel (``FUSE_CONV_KNN``)
   against its plain version (B=128 at L=128 for H1 = 128 and 336, and
   events of 0, 1, 2, k and k+1 nodes at L = 48 and 112; add and max,
   fp32 and bf16): ``out`` the same bits as the forward kernel's, the
   neighbours those of the plain kNN of that ``out``, the same bits
   twice;
5. edgeconv_bwd: the EdgeConv backward kernel against its plain version
   (both layer shapes and H1=100, H2=72, add/max/mean, fp32 and bf16,
   k = 8, 1, 12 and 64, a 1-node and an all-masked event, L=512 and
   L=4096); two runs must give the same bits;
   edgeconv_bwd_route: under max, the edge the backward routes each
   gradient to against the forward's winner, at planted near-ties and
   exact ties, nothing zeroed (fp32 and bf16, both layer shapes and
   H1=100, H2=72);
6. flash, flash_bwd: the flash-attention forward, dq and dkv kernels
   against their plain versions (head dims 16, 32 and 64, L = 1, 63,
   64, 65, 129, 128, 1000 and 1024, RNN_TITO's 16 heads of 16 at L =
   1024, and the DeepIce path's shapes, 12 heads
   of 32 at L = 768 and 1024 with scale 1 and at L = 769 and 1025 with
   the cls key, and B_d64's, 12 heads of 64 at L = 768 and 769; fp32 and
   bf16, an event with no valid key and one with a single key), and
   whether two runs of each kernel give the same bits;
7. serve: the serving path.  A full-width DynEdge energy model is loaded
   from a JAX-layout ``state_dict.pkl`` (random weights from a seed)
   through ``DeploymentModule`` on the card and answers requests; the
   kernels' launch counts are checked (5 kNN and 4 EdgeConv per
   forward, nothing else) and the answers are held against the same
   module on the CPU, which runs the plain versions.  Then the bfloat16
   mode.  serve_fused: the requests at L <= 128 again with
   ``FUSE_CONV_KNN`` on (1 kNN and 4 fused EdgeConv + kNN launches per
   forward), fp32 and bf16; with it off and on the same graphs and
   latents, bit for bit;
7a. export, export_bf16, export_fused: the serving artifact
   (``graphnet_tpu_torch/deployment/export.py``).  The same DynEdge
   modules exported by ``DeploymentModule.export_serving`` (one
   ``torch.export`` program per (B, L): B = 1, 8, 32 at L = 128 and 512;
   with ``FUSE_CONV_KNN`` on at L = 128) and the serving requests served
   by ``ExportedModel``: each answer within rtol 1e-6 of the live model
   at the artifact's shapes (the same bits expected; the largest
   difference printed, and the difference to the module's own answers
   at its own padding), each program call 5 kNN and 4 EdgeConv launches
   (1 and 4 fused), as the live forward; each program's export seconds
   and bytes, and a request's host ms exported and live.  The fp32
   artifact is also served by a new process that imports only
   ``graphnet_tpu_torch.deployment.export`` and must not import
   ``graphnet_tpu_torch.models.gnn``: the same answers, bit for bit;
7b. train_sqlite: the training example's path
   (``graphnet_tpu_torch.examples.train_dynedge``): the bundled SQLite
   database through ``SQLiteDataset``, ``KNNGraph(Prometheus())``, the
   datamodule's DataLoaders and ``Trainer.fit`` (2 epochs, batch 16, the
   train loader shuffled with a seed drawn anew each run and printed on
   the phase line) of
   the full-width DynEdge with ``FUSE_CONV_KNN`` on: 1 kNN, 4 fused
   EdgeConv + kNN and 4 EdgeConv-backward launches per step, every
   gradient finite and non-zero, step 1 held against the CPU fed the
   card's per-layer adjacency, ``Trainer.predict`` on the validation
   loader;
8. train: the training path.  ``Trainer`` steps of the same model with
   ``LogCoshLoss`` on ``log10(total_energy)`` on the JAX bench's batch
   (B=128, L=128); 5 kNN, 4 EdgeConv-forward and 4 EdgeConv-backward
   launches per step, a finite, non-zero gradient for every parameter,
   and losses and gradients held against the port on the CPU with the
   CPU's adjacency fed to the card; then ``fit`` with validation,
   ``predict`` and the ``state_dict.pkl`` round trip.  Then the
   bfloat16 mode;
8b. train_pipeline, train_pipeline_bf16: the input pipeline of
   ``examples/03_training/08_high_throughput_pipeline.py`` (the
   synthetic database of 512 events made from seed 0 in a temporary
   directory, ``SQLiteDataset`` through the native fetch, the loader's
   two threads and native padding, batches of 32) training the
   full-width DynEdge energy model (the train phase's weights) two
   epochs a route, with ``steps_per_dispatch=4``: P plain; S with
   ``DataLoader(stack_k=4)`` and ``fit(prefetch=4)``, whose losses and
   parameters must equal P's within 1e-5 of each parameter's max; M from
   the store ``materialize`` packs from the loader (its replay without
   shuffling the loader's batches bit for bit) through ``MaterializedLoader(
   stack_k=4)`` and ``prefetch=4``; C through ``CachingLoader(store=
   "device")``, every batch on the card from epoch 1.  5 kNN, 4 EdgeConv
   and 4 EdgeConv-backward launches every step of every route, every
   loss finite, the native padding and SQLite counters risen; in fp32
   step 1 of S held against the CPU fed the card's adjacency.  Printed:
   the ``g++`` version, each route's events/s per epoch, the step ms on
   one batch, the idle share of 5 steps of S with its pipeline running,
   and the loader's host ms for one batch (whole, and its fetch and
   padding through the native and the plain routes); then
   train_pipeline_examples: the two pipeline examples' command lines
   (``materialize_and_replay``; ``high_throughput_pipeline`` one epoch);
9. serve_tito, train_tito: the same two paths for the full-width
   DynEdgeTITO direction model (``VonMisesFisher3DLoss``) at the JAX
   bench's TITO shape, B=8, L=1024: 1 kNN, 4 EdgeConv and 4 flash
   launches per forward, and 4 EdgeConv-backward, 4 dq and 4 dkv more
   per training step; answers, losses and step-1 gradients held
   against the CPU.  Then the bfloat16 modes, against the bfloat16
   model on the CPU; export_tito: the TITO module exported at B = 1 and
   8, L = 1024 and held as in 7a (1 kNN, 4 EdgeConv and 4 flash
   launches a program call);
10. rel_flash, rel_flash_bwd: the relative-bias attention forward, dq
   and dkv kernels against their plain versions (12 heads of 32, L =
   128, 768, 1000 and 1024; at the dkv kernel's tile edges, L = 1, 63,
   65 and 129, and 3 heads of 16 at L = 65; 1 and 24 heads of 32 at
   L = 200; at the dq and forward kernels' 16-query and 16-key tile
   edges, L = 15, 17, 31 and 33 with 12, 3, 1 (of 16) and 24 heads; at
   the forward kernel's head tiles and groups, 9 heads of 32 at L = 16
   and 13 of 16 at L = 48; at head dim 64 12 heads at L = 768 (B=16)
   and 1024, the tile edges and one head past each kernel's head group;
   fp32 and bf16, an event with no pulse and one
   with a single pulse), and whether two runs of each kernel give the
   same bits;
11. serve_deepice, train_deepice: the same two paths for the full-width
   DeepIce direction model at the JAX bench's DeepIce shape, B=16,
   L=768 (serving: 16 events of 100-768 pulses, and a request with
   events of 0 and 1 pulses): 1 rel forward and 15 flash forward
   launches per forward, 1 rel dq, 1 rel dkv and 15 flash dq and dkv
   more per training step; answers and a step on a few of the events
   held against the CPU.  Then the bfloat16 modes, against the bf16
   model on the CPU;
   serve_deepice_d64, train_deepice_d64: the same for the zoo's DeepIce
   B_d64 at full width (hidden 768, 12 heads of 64: the rel kernels at
   head dim 64), built from its model.yml, the same requests and batch,
   2 training steps; export_deepice, export_deepice_bf16: the DeepIce
   modules exported at B = 4 and 16, L = 1024 (the requests' shapes) and
   held as in 7a (1 rel and 15 flash forward launches a program call);
   B_d64 is not exported (its kernels are the same operators at head
   dim 64, and each program would carry its weights, about four times
   the default DeepIce's);
   serve_deepice_chunked, train_deepice_chunked: the zoo's DeepIce B_d32
   (hidden 768, 24 heads of 32) with the rel kernels off
   (``rel_flash="never"``) and its biased block in 4 query tiles
   (``rel_bias_chunks=4``), on both routes of ``rel_bias_cache`` (the
   pair tensor cached once a forward, "always", or rebuilt a tile at a
   time, "never"): the DeepIce requests in fp32 and bf16 and one fp32
   training step on the DeepIce batch, each route held against the
   dense route (``rel_bias_chunks=1``, the same weights) on the card and
   against the CPU on a few events, at serve_deepice's and
   train_deepice's tolerances; 15 flash forward launches a forward (15
   dq and dkv more a step) and none of the rel kernels.  Then each
   route's ms and peak memory (``torch.cuda.max_memory_allocated``)
   serving and training at B=16, L=768 and at B=4, L=3072, beside the
   card's name and power limit: what sets ``rel_bias_cache="auto"``'s
   limit (``models/gnn/icemix.py:REL_CACHE_AUTO_BYTES``);
   curated: the curated ``TestDataset`` over the bundled SQLite
   database feeding the training example's full-width DynEdge through
   ``Trainer.fit`` with the fused EdgeConv + kNN off (rows 1-3, the
   launches of every step and validation forward), step 1 held against
   the CPU as train_sqlite holds it; and whether pandas, pyarrow and
   h5py import on the host (the file conversion needs them; it is held
   on the CPU by the tests, not here);
11b. serve_config: six model files (``SERVE_CONFIGS``: DynEdge energy,
   TITO direction, the zoo's DeepIce B_d32, and the QUESO energy
   (IdentityTask, log10 / pow10), zenith and node-level pulse cleaner),
   each built by ``load_model`` on the card at its full width, its
   random weights carried through a ``state_dict.pkl`` that
   ``save_model`` writes, and served through ``DeploymentModule(
   model.yml, state_dict.pkl)`` on the card and on the CPU: the answers
   within rtol 1e-3 (kNN near-tie flips explained), each launch count of
   the model's path per forward (DynEdge rows 1 and 2, and row 4 with
   ``FUSE_CONV_KNN`` on; TITO rows 1, 2 and 5a; DeepIce rows 5a and 6a);
   serve_zoo: the 11 directories of the pretrained zoo
   (``configs/models/zoo``: 6 QUESO DynEdge models, 5 Kaggle IceMix
   DeepIce models, two with the nested DynEdge) at their published
   widths: the ``graph_definition.yml`` and ``model.yml`` built by
   ``load_model`` on the card, a checkpoint in GraphNeT's key layout with
   random weights ported by the port's porters
   (``utils/weight_port.py``), saved and served through
   ``DeploymentModule(model.yml, state_dict.pkl)`` on the card and on
   the CPU: 8 raw events of 0-700 pulses (the bundled database's pulse
   positions and times, the other columns drawn by name; IceMix keeps
   192) through the graph definition, the answers within rtol 1e-3
   (kNN flips of the DynEdge explained), the launches of each model's
   forward (QUESO 5 kNN and 4 EdgeConv; IceMix one rel launch a biased
   block, one flash launch an unbiased one, and 5 kNN for the nested
   DynEdge), the request's ms and events/s beside the card;
   serving_queue: ``serve_events_parallel`` (8 threads, batches of at
   most 32) over 256 events of 1-512 pulses on the energy model, against
   one direct call (rtol 1e-3, flips explained), with events/s and the
   p50 / p99 latency from submit to answer; deployer: a ``Deployer``
   subclass (``SmokeDeployer``) over 8 ``.npz`` files of events, in one
   process and in 2 spawned workers that each build the module from its
   files: the same answers, bit for bit;
   serve_i3, serve_i3_cleaner, serve_i3_deployer: the zoo's QUESO models
   inside the IceTray chain, on the tests' stand-in for IceTray
   (``tests/tools_torch_icetray``, put on ``sys.path``): an
   IceCube-Upgrade-shaped GCD made from a seed (a sensor at each pulse
   position of the bundled database) and physics frames of 0-700 pulses
   (ZOO_LENGTHS, from ``zoo_raw_pulses``); ``total_neutrino_energy``
   (full width, a ported GraphNeT-layout checkpoint with random
   weights, saved and loaded from its files) through
   ``I3InferenceModule`` on the card and on the CPU: each frame's
   ``I3Double`` within rtol 1e-3 (kNN flips explained), 5 kNN and 4
   EdgeConv launches a frame with pulses and none without, and the host
   ms of one frame's inference at 99, 400 and 700 pulses;
   ``SplitInIcePulses_cleaner`` through ``I3PulseCleanerModule`` (its
   threshold the median of the CPU's probabilities): the per-pulse
   probabilities held the same way, the cleaned pulse maps equal but
   for pulses within 1e-3 of the threshold (counted); ``I3Deployer``
   with both modules over 4 stand-in ``.i3`` files in one process and in
   2 spawned workers: the same written frames, byte for byte;
   serve_backbones: GraphNeT's other five backbones at its default
   widths (``backbone_model``: DynEdgeJINST, ConvNet, ParticleNeT,
   ISeeCube, RNN_TITO), each from a GraphNeT-layout checkpoint ported
   by its porter, saved and served through ``DeploymentModule(
   model.yml, state_dict.pkl)`` on the card and on the CPU: 8 raw events
   of 0-700 pulses (ISeeCube 0-128, within its seq_length) through the
   backbone's graph definition (RNN_TITO's with ``NodeAsDOMTimeSeries``),
   the answers within rtol 1e-3 (latent kNN flips of JINST and
   ParticleNeT explained), the launches of each forward
   (``BACKBONE_LAUNCHES``: RNN_TITO's 4 flash forwards at head dim 16),
   the request's ms and events/s beside the card;
   train_backbones: RNN_TITO (GraphNeT's widths, ``rnn_dropout`` 0.5;
   once more reading its second GRU layer, so the dropout between the
   layers runs),
   DynEdgeTITO (``configs/models/tito_direction_prometheus.yml`` with
   ``dropout_rate`` 0.1), ConvNet and ParticleNeT (their default
   dropouts) with ``deterministic=False`` and random weights, trained
   by ``Trainer`` on batches of 16 events of the bundled database: the
   launches of each step (``TRAIN_BACKBONES``: RNN_TITO's include the
   flash dq and dkv at head dim 16; TITO's attention dropout takes the
   dense path, so its step has no flash launch and its eval forward
   4), every gradient finite and non-zero, the step's ms and peak
   memory, and step 1 held against the CPU fed the card's keep masks
   and kNN graphs (``StepTape``; loss rtol 1e-3, each gradient within
   1e-3 of its max, a true-zero one of the largest, TITO's ambiguous
   entries zeroed);
   train_backbones_resume: TITO with dropout and EMA, 2 epochs unbroken
   against a run cut in its second epoch and resumed from its ``last``
   checkpoint by a new Trainer; train_backbones_remat: the DeepIce
   cell (B=16, L=768, fp32) with and without ``remat``, each step's ms
   and peak memory and the gradients of the two; train_backbones_examples:
   the four training examples' command lines (``--device cuda``, one
   epoch);
11c. edge_rules: the full-width DynEdge energy model (the train
   phase's weights) behind each edge rule, ``KNNEdges``,
   ``RadialEdges`` (``max_neighbours`` 32, radius 0.5 in the detector's
   standardised units), ``MinkowskiKNNEdges`` and ``EuclideanEdges``,
   evaluated by ``StandardModel`` before the backbone: every event of
   the bundled database served through ``DeploymentModule`` on the card
   against the CPU (flips explained, the CPU's graphs fed), the kNN
   launches by k counted exactly (RadialEdges 1 at k = 32 and 4 at k =
   8 a forward, the Minkowski and Euclidean rules' first graph in plain
   PyTorch and 4 kNN launches), and 2 training steps (step 1 against the
   CPU with its graphs fed); ``KNNEdges`` must equal the model without a
   rule bit for bit; train_targets: the full-width DynEdge with the nine
   other heads (their targets the database's truth columns, vertex and
   interaction time drawn from a seed) trained 3 steps and served from
   the port's ``model.yml`` + ``state_dict.pkl`` against the CPU, the
   ``NormalizingFlow`` on log10 E with either transform and the
   ``SphericalFlow`` on the direction trained 3 steps each (each flow's
   ``log_prob`` on 101 targets against the CPU), and the energy model
   trained on ``Uniform`` weights fitted into a copy of the database;
   targets_examples: the two weight fitters' and the flow and multiclass
   examples' command lines (one epoch on the card);
11d. parallel: training across processes
   (``graphnet_tpu_torch.parallel.dryrun``, two processes sharing the
   card over gloo, as NCCL refuses two ranks on one device): one full
   training step through ``Trainer(mesh=..., param_sharding=...)`` of
   the full-width DynEdge under DP and FSDP (B=8, L=64), DP x graph
   (B=4, L=128, and one event of 12288 nodes on the rounds kernel),
   and of the full-width DynEdgeTITO under TP (B=2, L=32; its attention
   and feed-forward layers sharded, the flash kernels on each process's
   4 heads); the shapes are the dry run's and differ from the JAX dry
   run's (its docstring says why); a line a layout with its processes
   and backend, its loss against the one-process step (rtol 1e-5, 1e-4
   on a graph axis), each gradient against the one-process step's
   (within 1e-3 of each parameter's largest, ``dryrun.GRAD_TOL``: a gate
   whose pre-activation lies within fp32 rounding of 0 can be set one
   way on one side and the other way on the other, which moves one
   edge's share of a gradient), the
   launches of rows 1-3 and 5a-c per process and step (DynEdge 5 / 4 /
   4, TITO 4 of each flash kernel), on a graph axis the input
   neighbours of each process's rows equal to the unsharded event's,
   and each process's host seconds of a second step; FSDP's loss DP's;
   parallel_done also prints each layout's collectives as counted in
   each process (``dryrun.CollectiveTape``: DDP's gradient all-reduce
   read from its reducer's buckets, node sharding's all-gathers, all-reduces and
   reduce-scatter; bytes and calls) and the ``CollectiveProfile`` built
   from those counts (DP's gradient all-reduce, the DP x graph step's
   all-gathers) beside ``dynedge_headline_profile`` of the DP model's
   parameters, whose all-reduce bytes the count must equal;
12. times: each kernel, its plain version and its bound (the kNN at
   B=128, L=128 (also at k = 32 and, on the rounds kernel, k = 48), at
   TITO's B=8, L=1024, at B=1, L = 128 and 512 and, on the rounds
   kernel, at B=1, L=12288, with
   its profiled device time, the device work and host time of a call,
   beside an empty kernel's; ``torch.profiler`` must find one device
   kernel a kNN call there and nothing else, also on the unfused
   route's view ``out[..., :3]``; the EdgeConv
   forward also at conv 0's H1=128 and at TITO's shape, and with the
   fused EdgeConv + kNN its profiled device time a launch; the fused
   EdgeConv + kNN also against the forward kernel and kNN kernel it
   replaces, and the DynEdge steps (fp32 and bf16) and
   requests with ``FUSE_CONV_KNN`` off, on, on, off); the flash
   kernels beside the port's dense attention and
   ``F.scaled_dot_product_attention`` at TITO's B=8, H=8, Dh=32 and
   L = 128, 512 and 1024, at the DeepIce path's B=16, H=12 and L = 768
   and 769 with ragged events, and at Dh=64; the rel
   attention beside the port's dense biased path at L = 768, 1536 and
   3072, and at head dim 64 (B_d64) at L = 768; B_d64's serving events/s,
   step ms and peak memory of a step on the kernels and on the dense
   path (fp32, B=16, L=768), and on the kernels at B=8, L=3072 (bf16);
   the flash kernels at B_d64's Block shape (B=16, 12 heads of 64,
   L=769) and at RNN_TITO's (B=8, 16 heads of 16, L=1024), each forward
   also beside SDPA with its efficient and its cuDNN backend forced;
   the EdgeConv backward's device time by launch over one call at
   H1=336; serving events/s and single-event latency; training step ms and
   events/s; device time by kernel for serving and for training; peak
   memory of a training step;
13. a ``kernels`` line with every ported kernel and its row of the
   kernel table in PERF.md (rows 5a-c also at head dim 16: the fp32
   forward's launches from RNN_TITO's serving, the fp32 dq and dkv's
   from its training step, the bf16 ones with ``main_path`` false and
   no launches, as no path runs them yet).

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no such line; it also
exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import importlib
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

# the deployer phase's workers are spawned and unpickle SmokeDeployer
# from this module, so its base class is imported here
from graphnet_tpu_torch.deployment.deployer import Deployer

SEED = 0
K = 8
NB_INPUTS = 4
FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]
FULL_WIDTH = dict(
    layer_sizes=((128, 256), (336, 256), (336, 256), (336, 256)),
    post=(336, 256),
    readout=(128,),
)
# the JAX bench's TITO shape (bench.py:250-291): events, length, heads,
# head dim
TITO_B, TITO_L, TITO_HEADS, TITO_DH = 8, 1024, 8, 32
# RNN_TITO's DynTrans attention at GraphNeT's widths: 256 wide, 16 heads
# of 16 (serve_backbones serves it at TITO_B events, L = TITO_L)
RNN_TITO_HEADS, RNN_TITO_DH = 16, 16
# H100 data sheet, dense rates: bytes/s of HBM, flop/s of the CUDA cores
# in fp32 and of the tensor cores in bf16 (for the bound column)
PEAKS = {
    "SXM": dict(bytes=3.35e12, fp32=67e12, bf16=989e12),
    "PCIe": dict(bytes=2.0e12, fp32=51e12, bf16=756e12),
}
# the flash kernels against their plain versions: each output's error
# over its max within one event, for the forward and for the backward.
# The bf16 forward rounds p against the running max, as the TPU kernel
# does, the plain version against the row's max, so the two differ by
# more than the backward's, which recomputes p from the lse as the plain
# version does
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 5e-3)}
# the share of a bf16 backward output's elements (in the events with two
# or more valid keys) that differ from the plain version at all: the
# same rounding points leave a few in 1e4, a missing bf16 rounding of p
# or ds a large share
FLASH_BWD_DIFFERING = 1e-2
# TITO in bfloat16, card against the same bf16 model on the CPU, at
# about three times the H100's readings: the answers (direction
# components, and kappa as rtol; 3.1e-3 read), and for training the
# step-1 loss (rtol; 1.7e-4 read) and gradients (each parameter's error
# norm over its norm, 1.3e-2 read) with the output gradient zeroed where
# a gate or a max lies within a bf16 rounding (4e-3) of a tie: max
# pooling over 1024 nodes routes every gradient through the top node,
# and bf16 latents reorder near-ties (unmasked, the norms differ by
# up to half)
TITO_BF16_SERVE_TOL = 1e-2
# DeepIce at the JAX bench's shape (bench.py:359-430): events, length
# (the IceMix pulse budget), heads, head dim
ICE_B, ICE_L, ICE_HEADS, ICE_HD = 16, 768, 12, 32
# the length bucket that serves events of 100-768 pulses
# (``batch.DEFAULT_BUCKETS``)
ICE_SERVE_L = 1024
ICE_FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t", "charge",
                "auxiliary"]
# IceCube Kaggle's raw columns (ISeeCube's six features)
ICE_KAGGLE = ["x", "y", "z", "time", "charge", "auxiliary"]
# the rel kernels against their plain versions: each output's error over
# its max within one event, forward and backward.  fp32: both evaluate
# the pair embedding with correctly rounded arguments and 1-2 ulp sines;
# the sums run in another order.  bf16: as the flash kernels'
REL_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 5e-3)}
# head counts one more than a head group of a rel kernel holds at head
# dim 64 (the kernels' kDkvHeads, kDqHeads in fp32 and bf16, fwd_heads
# in fp32 and bf16), so that each kernel runs a last group of one head
REL_HD64_HEADS = (5, 6, 7, 8, 11)
TITO_BF16_TRAIN = dict(loss_rtol=1e-3, grad_tol=3e-2, grad_norm="l2",
                       rel=4e-3)
# DeepIce in bfloat16, card against the same bf16 model on the CPU, at
# about three times the H100's readings: the answers (direction
# components, and kappa as rtol; 5.7e-3 read), and the held step-1 loss
# (rtol; 6.7e-4 read) and gradients (each parameter's error norm over
# its norm; 1.04e-2 read).  The model has no max and no relu gate, so
# nothing is masked.  In fp32 the held step-1 gradients are held within
# 1e-4 of each parameter's max (2.3e-6 read), the loss within 1e-4
ICE_BF16_SERVE_TOL = 2e-2
ICE_BF16_TRAIN = dict(loss_rtol=3e-3, grad_tol=3e-2, grad_norm="l2")
ICE_FP32_TRAIN = dict(loss_rtol=1e-4, grad_tol=1e-4)
# the repository root: the model configs are read from its configs/
ROOT = os.path.dirname(os.path.abspath(__file__))
MODELS = os.path.join(ROOT, "configs", "models")
# the zoo's DeepIce B_d64: hidden 768, 12 heads of 64, depth 12 + 4
# BlockRel, at its full width, built from its file; the rel kernels at
# head dim 64
ICE_D64_FILE = os.path.join(MODELS, "zoo", "kaggle_icemix", "B_d64",
                            "model.yml")
ICE_D64_HIDDEN, ICE_D64_HD = 768, 64
# the chunked DeepIce phases: the zoo's B_d32 (hidden 768, 24 heads of
# 32, depth 12 + 4 BlockRel, n_rel 1) with the rel kernels off and its
# biased block in CHUNKED_CHUNKS query tiles, on each route of
# rel_bias_cache (the pair tensor cached once a forward, or rebuilt a
# tile at a time); held against the same weights on the dense route
# (rel_bias_chunks 1) on the card and against the CPU, at serve_deepice's
# and train_deepice's tolerances.  Then each route's ms and peak memory
# serving and training at CHUNKED_SHAPES (B, L): the second puts several
# GB in the cached tensor
ICE_D32_FILE = os.path.join(MODELS, "zoo", "kaggle_icemix", "B_d32",
                            "model.yml")
CHUNKED_CHUNKS = 4
CHUNKED_ROUTES = ("always", "never")
CHUNKED_SHAPES = ((ICE_B, ICE_L), (4, 3072))
# the queue's and the deployer's model
ENERGY_FILE = os.path.join(MODELS, "dynedge_energy_prometheus.yml")
# the serve_config phase: (label, model file under configs/models); each
# built by load_model, its random weights carried through save_model's
# state_dict.pkl, and served through DeploymentModule(model.yml,
# state_dict.pkl)
SERVE_CONFIGS = (
    ("dynedge_energy", "dynedge_energy_prometheus.yml"),
    ("tito_direction", "tito_direction_prometheus.yml"),
    ("deepice_B_d32", "zoo/kaggle_icemix/B_d32/model.yml"),
    ("queso_total_neutrino_energy", "zoo/queso/total_neutrino_energy/model.yml"),
    ("queso_neutrino_zenith", "zoo/queso/neutrino_zenith/model.yml"),
    ("queso_cleaner", "zoo/queso/SplitInIcePulses_cleaner/model.yml"),
)
# the config models' answers against the same module on the CPU: each
# within rtol 1e-3 (the serving limit of PERF.md section 2), an answer
# smaller than CONFIG_FLOOR times its column's largest within 1e-3 of
# that floor.  A head's affine output is a difference of large latent
# sums, so near 0 (a zenith kappa, |x| + eps) its relative error says
# nothing of the model
CONFIG_RTOL, CONFIG_FLOOR = 1e-3, 1e-2
# the export phases' grids of (batch, length) for DynEdge, and with the
# fused EdgeConv + kNN (which takes L <= 128)
DYNEDGE_GRID = dict(batch_sizes=(1, 8, 32), lengths=(128, 512))
FUSED_GRID = dict(batch_sizes=(1, 8, 32), lengths=(128,))
# the serve_zoo phase: the pretrained zoo's directories under
# configs/models/zoo, each with its launches per forward (names as
# ``names`` in main: kNN, EdgeConv, EdgeConv bwd, flash fwd, dq, dkv, rel
# fwd, dq, dkv, fused EdgeConv + kNN).  QUESO: DynEdge's 5 kNN and 4
# EdgeConv; IceMix: one rel launch a biased block and one flash launch
# an unbiased one (depth_rel - n_rel + depth), and the nested DynEdge's
# 5 kNN (its convs have norm layers: the plain path, as in the JAX
# package)
ZOO_DIR = os.path.join(MODELS, "zoo")
ZOO_LAUNCHES = {
    **{f"queso/{name}": [5, 4, 0, 0, 0, 0, 0, 0, 0, 0] for name in (
        "SplitInIcePulses_cleaner", "neutrino_direction",
        "neutrino_vs_muon_classifier", "neutrino_zenith",
        "total_neutrino_energy", "track_vs_cascade_classifier")},
    "kaggle_icemix/B_d32": [0, 0, 0, 15, 0, 0, 1, 0, 0, 0],
    "kaggle_icemix/B_d64": [0, 0, 0, 15, 0, 0, 1, 0, 0, 0],
    "kaggle_icemix/B_d32_4rel": [0, 0, 0, 12, 0, 0, 4, 0, 0, 0],
    "kaggle_icemix/B+DynEdge_d64": [5, 0, 0, 12, 0, 0, 4, 0, 0, 0],
    "kaggle_icemix/S+DynEdge_d32": [5, 0, 0, 8, 0, 0, 4, 0, 0, 0],
}
# its request: pulses a raw event (IceMix keeps at most 192, so the
# last three are subsampled), and the timed repeats of the request
ZOO_LENGTHS = (0, 1, 26, 99, 150, 250, 400, 700)
ZOO_RUNS = 5
# the serve_backbones phase: GraphNeT's other five backbones at its
# default widths (``backbone_model``), each with its launches a forward
# (as ZOO_LAUNCHES): DynEdgeJINST 5 kNN and 4 EdgeConv; ConvNet one kNN;
# ParticleNeT 1 + 3 kNN (k = 16); ISeeCube none (its biased attention is
# dense, as in the JAX package); RNN_TITO one kNN (x, y, z, t of the
# sensor nodes), 4 EdgeConv (max) and 4 flash forwards at head dim 16
BACKBONE_LAUNCHES = {
    "DynEdgeJINST": [5, 4, 0, 0, 0, 0, 0, 0, 0, 0],
    "ConvNet": [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "ParticleNeT": [4, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "ISeeCube": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "RNNTITO": [1, 4, 0, 4, 0, 0, 0, 0, 0, 0],
}
# ISeeCube's request: events that fit its seq_length of 196, so at most
# 128 pulses (the largest length bucket below it); longer ones raise
ISEECUBE_LENGTHS = (0, 1, 9, 26, 50, 80, 99, 128)
# the serving_queue phase: events of 1-512 pulses, threads, batch cap
QUEUE_EVENTS, QUEUE_THREADS, QUEUE_MAX_BATCH = 256, 8, 32
# the deployer phase: .npz files of events, events a file, workers
DEPLOY_FILES, DEPLOY_EVENTS, DEPLOY_WORKERS = 8, 16, 2
# the serve_i3 phase: the tests' IceTray stand-in, the zoo models it
# serves (QUESO: 5 kNN and 4 EdgeConv a non-empty frame), its stand-in
# .i3 files and workers, the frames whose inference is timed and the
# timed repeats of each
I3_STANDIN = os.path.join(ROOT, "tests", "tools_torch_icetray")
I3_ENERGY = "queso/total_neutrino_energy"
I3_CLEANER = "queso/SplitInIcePulses_cleaner"
I3_FILES, I3_WORKERS = 4, 2
I3_TIMED, I3_RUNS = (99, 400, 700), 5
# its training steps a phase, fewer than the default DeepIce's 3 (each
# step at B=16, L=768 is ~4x the default's flops)
ICE_D64_STEPS = 2
# B_d64 in bfloat16, card against the same bf16 model on the CPU: the
# answers at ICE_BF16_SERVE_TOL (1.0e-2 read), the step-1 gradients at
# ICE_BF16_TRAIN's 3e-2 (1.1e-2 and 1.8e-2 read on 4 and 2 events), the
# held step-1 loss at about three times its reading: 4.0e-3 (2 events)
# and 5.2e-3 (4 events), where bf16 itself moves the loss 2.4e-4 to
# 3.9e-3 from the fp32 one on each device (the default DeepIce 2.0e-3 to
# 5.6e-3: its card and CPU differ by 2.1e-3 to 2.8e-3 against its 3e-3);
# the fp32 phase holds the same model within 1e-4 (1.0e-6 read).
# NVIDIA H100 80GB HBM3, 700 W
ICE_D64_BF16_TRAIN = dict(ICE_BF16_TRAIN, loss_rtol=1.2e-2)
# the parallel phase: graphnet_tpu_torch.parallel.dryrun's layouts, two
# processes on the one card (gloo: NCCL refuses two ranks on one device,
# and gloo carries every collective of the layouts on CUDA tensors;
# tools/collectives_probe.py), each
# layout's launches a process and step: DynEdge 5 kNN, 4 EdgeConv
# forward and 4 backward (on a graph axis too: each process builds the
# whole gathered event's graphs); TITO 1 kNN, 4 EdgeConv (max), 4 of
# each flash kernel on its local heads; graph_long's events of
# PARALLEL_LONG_L nodes run every kNN on the rounds kernel
PARALLEL_LAYOUTS = ("dp", "graph", "graph_long", "fsdp", "tp")
PARALLEL_LONG_L = 12288
PARALLEL_DYNEDGE = dict(knn=5, edgeconv=4, edgeconv_bwd=4, flash_fwd=0,
                        flash_bwd_dq=0, flash_bwd_dkv=0)
PARALLEL_TITO = dict(knn=1, edgeconv=4, edgeconv_bwd=4, flash_fwd=4,
                     flash_bwd_dq=4, flash_bwd_dkv=4)


def kernel_name(mangled):
    """A readable name of a mangled kernel of the port's sources: the
    last name of its nested name (after the namespaces) and its template
    arguments (head dims, float or bf16)."""
    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        pos += len(m.group())
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    if mangled[pos:pos + 1] == "I":
        args, rest = [], mangled[pos + 1:]
        while True:
            t = re.match(r"Li(\d+)E|f|13__nv_bfloat16", rest)
            if not t:
                break
            args.append(t.group(1) or ("float" if t.group() == "f" else "bf16"))
            rest = rest[t.end():]
        if args and rest.startswith("E"):
            name += "<" + ", ".join(args) + ">"
    return name


def ptxas_table(log, match):
    """Per kernel entry of an ``nvcc -Xptxas -v`` log whose mangled name
    contains ``match``: its name, registers, static shared memory, stack
    frame and spill stores and loads (bytes)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            if match in m.group(1):
                cur = {"kernel": kernel_name(m.group(1))}
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(sm.group(1)) if sm else 0)
    return rows


def rel_build_report(build, logs):
    """Rows 6a-c: each rel forward, dq and dkv kernel's registers, spills
    and stack (``ptxas_table``) and its dynamic shared memory at DeepIce's
    12 heads and the zoo's 24 (the libraries' ``*_smem_bytes`` entries)."""
    rows = []
    for lib, kern, entry in (
        ("rel_flash_attention", "rel_fwd_kernel", "rel_fwd_smem_bytes"),
        ("rel_flash_attention_bwd", "rel_dq_kernel", "rel_bwd_dq_smem_bytes"),
        ("rel_flash_attention_bwd", "rel_dkv_", "rel_bwd_dkv_smem_bytes"),
    ):
        smem = getattr(build.load(lib), entry)
        by_dtype = entry == "rel_bwd_dkv_smem_bytes"
        smem.argtypes = [ctypes.c_int] * (3 if by_dtype else 2)
        smem.restype = ctypes.c_int
        for row in ptxas_table(logs[lib], kern):
            args = row["kernel"].split("<")[1].rstrip(">").split(", ")
            hd, bf = int(args[-1]), int("bf16" in args or "mma" in row["kernel"])
            for heads in (ICE_HEADS, 2 * ICE_HEADS):
                row[f"dynamic_smem_bytes_H{heads}"] = (
                    smem(hd, bf, heads) if by_dtype else smem(hd, heads))
            rows.append(row)
    return rows


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events, one call each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_s(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median wall time of ``fn`` in s; ``fn`` ends with its results on
    the host, so the device work lies inside the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def jax_layout_tree(rng, layer_sizes, post, readout):
    """A DynEdge + energy-head parameter tree in the JAX package's layout
    (``{"params": {"backbone": ..., "tasks_0": ...}}``, numpy arrays,
    dense kernels ``[in, out]``), with random weights."""

    def dense(din, dout, bias=True):
        d = {"kernel": rng.standard_normal((din, dout)) / np.sqrt(din)}
        if bias:
            d["bias"] = rng.standard_normal(dout) * 0.1
        return d

    n_global = NB_INPUTS + min(4, NB_INPUTS) + 1
    d = d_skip = NB_INPUTS + n_global
    backbone = {}
    for i, (h1, h2) in enumerate(layer_sizes):
        backbone[f"conv_{i}"] = {
            "conv": {
                "self_dense": dense(d, h1),
                "nbr_dense": dense(d, h1, bias=False),
                "out_kernel": rng.standard_normal((h1, h2)) / np.sqrt(h1),
                "out_bias": rng.standard_normal(h2) * 0.1,
            }
        }
        d = h2
        d_skip += h2
    d = d_skip
    backbone["post_processing"] = {}
    for j, h in enumerate(post):
        backbone["post_processing"][f"dense_{j}"] = dense(d, h)
        d = h
    d *= 4  # min, max, mean, sum pooling
    backbone["readout"] = {}
    for j, h in enumerate(readout):
        backbone["readout"][f"dense_{j}"] = dense(d, h)
        d = h
    tree = {"params": {"backbone": backbone, "tasks_0": {"affine": dense(d, 1)}}}

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return np.asarray(t, dtype=np.float32)

    return f32(tree)


def ragged_coords(torch, rng, B, L, lo, dev, D=3):
    """``[B, L, D]`` float32 coordinates and a mask with lengths drawn
    from ``[lo, L]``."""
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    n = torch.from_numpy(rng.integers(lo, L + 1, B))
    mask = torch.arange(L)[None, :] < n[:, None]
    return x.to(dev), mask.to(dev)


def queso_coords(torch, rng, B, L, dev, D=3):
    """``[B, L, D]`` float32 coordinates and a mask whose lengths follow
    the QUESO training cell's law: a log-normal of median 48 and log-sigma
    1, rounded and clipped to ``[2, L]``; at L = 512 most of a batch's
    slots are padding."""
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    n = np.clip(np.rint(48.0 * np.exp(rng.standard_normal(B))), 2, L)
    mask = torch.arange(L)[None, :] < torch.from_numpy(n.astype(np.int64))[:, None]
    return x.to(dev), mask.to(dev)


def grid_events(torch, rng, dev):
    """Two events of integer grid points in shuffled order (4 x 4 x 4 and
    2 x 2 x 4, L=64): every distance is exact, so many ties are exact and
    only the lower-index rule decides them."""
    g4 = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    g2 = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(4),
                              indexing="ij"), -1)
    x = np.zeros((2, 64, 3), np.float32)
    x[0] = rng.permutation(g4.reshape(-1, 3))
    x[1, :16] = rng.permutation(g2.reshape(-1, 3))
    mask = np.arange(64)[None] < np.array([64, 16])[:, None]
    return torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev)


def tie_centre_events(torch, rng, dev, D):
    """Events whose centre the kernel must sum serially: event 0 holds 4,
    3, -2.5, 2^-22 and two half-ulp terms 2^-51 (values 2^53 apart: the
    float64 sum depends on its order, ``tests/test_torch_ops.py``'s
    ``_tie_event``), event 1 coordinates of ~1e3 beside one of 1e-9 and
    a subnormal, the others ragged normal ones (the parallel sum)."""
    x, mask = ragged_coords(torch, rng, 4, 64, 32, "cpu", D=D)
    x[0], mask[0] = 0.0, False
    for j, v in ((0, 4.0), (1, 2.0 ** -22), (2, 2.0 ** -51), (18, 2.0 ** -51),
                 (5, 3.0), (9, -2.5)):
        x[0, j], mask[0, j] = v, True
    x[1] *= 1e3
    x[1, 3, 0], x[1, 4, D - 1] = 1e-9, 2.0 ** -140
    mask[1, 3:5] = True
    return x.to(dev), mask.to(dev)


def knn_cases(torch, rng, dev):
    """The kNN phase's cases: ``(label, coords, mask, k, exclude_self)``."""
    cases = [("B128_L128_ragged",) + ragged_coords(torch, rng, 128, 128, 64, dev)]
    x, m = ragged_coords(torch, rng, 3, 16, 16, dev)
    m[0, 1:] = False  # 1 node
    m[1, 5:] = False  # 5 nodes
    m[2] = False  # all masked, as a padded request row
    cases.append(("tiny_events_L16", x, m))
    cases.append(("one_event_L1024",) + ragged_coords(torch, rng, 1, 1024, 900, dev))
    cases.append(("B2_L4096",) + ragged_coords(torch, rng, 2, 4096, 3000, dev))
    rng4 = np.random.default_rng(SEED + 3)  # DynEdge's stream stays as it was
    x, m = ragged_coords(torch, rng4, 3, 16, 16, dev, D=4)
    m[0, 1:] = False
    m[2] = False
    cases.append(("xyzt_tiny_events_L16", x, m))
    cases.append(("xyzt_B8_L1024_full",) + ragged_coords(
        torch, rng4, 8, 1024, 1024, dev, D=4))
    cases.append(("xyzt_B8_L1024_ragged",) + ragged_coords(
        torch, rng4, 8, 1024, 2, dev, D=4))
    cases = [c + (K, True) for c in cases]
    # one request's event at the lanes-a-query extremes, exact ties, views
    # of wider features, the query itself allowed, other k, all masked, the
    # serial centre, and D=4 above 48 KB of shared memory
    r = np.random.default_rng(SEED + 12)
    for L in (16, 128, 512):
        cases.append((f"B1_L{L}",) + ragged_coords(torch, r, 1, L, L * 3 // 4, dev)
                     + (K, True))
    g = grid_events(torch, r, dev)
    cases += [("grid_ties_k8",) + g + (K, True), ("grid_ties_k16",) + g + (16, True),
              ("grid_ties_with_self",) + g + (K, False)]
    wide, mw = ragged_coords(torch, r, 16, 128, 64, dev, D=7)
    cases += [("view_0_3_of_7_columns", wide[..., 0:3], mw, K, True),
              ("view_2_5_of_7_columns", wide[..., 2:5], mw, K, True),
              ("xyzt_view_1_5_of_7_columns", wide[..., 1:5], mw, K, True)]
    x, m = ragged_coords(torch, r, 8, 64, 2, dev)
    cases += [("with_self_B8_L64", x, m, K, False), ("k1_B8_L64", x, m, 1, True),
              ("k12_B8_L64", x, m, 12, True), ("k16_B8_L64", x, m, 16, True)]
    x, m = ragged_coords(torch, r, 4, 32, 32, dev)
    cases.append(("all_masked_B4_L32", x, torch.zeros_like(m), K, True))
    for D in (3, 4):
        cases.append((f"serial_centre_D{D}",) + tie_centre_events(torch, r, dev, D)
                     + (3, True))
    cases.append(("xyzt_B1_L4096",) + ragged_coords(torch, r, 1, 4096, 4000, dev, D=4)
                 + (K, True))
    # k = 17-32 (RadialEdges' cap of 32 neighbours): the serving shape
    # for D = 3 and 4, one event of 512, events of 20-33 nodes at L = 33
    # (one key more than k, and fewer), the grids' exact ties, the query
    # allowed, and k = 17 and 24 between
    r32 = np.random.default_rng(SEED + 20)
    for D in (3, 4):
        cases.append((f"k32_B128_L128_D{D}",)
                     + ragged_coords(torch, r32, 128, 128, 40, dev, D=D) + (32, True))
    cases.append(("k32_B1_L512",) + ragged_coords(torch, r32, 1, 512, 512, dev)
                 + (32, True))
    cases.append(("k32_B6_L33",) + ragged_coords(torch, r32, 6, 33, 20, dev)
                 + (32, True))
    cases += [("grid_ties_k32",) + g + (32, True),
              ("grid_ties_k32_with_self",) + g + (32, False)]
    x, m = ragged_coords(torch, r32, 8, 64, 2, dev, D=4)
    cases += [("k17_B8_L64_D4", x, m, 17, True), ("k24_B8_L64_D4", x, m, 24, True)]
    # the rounds kernel (k > 32 or L > 8192): k = 48 at the serving shape
    # for D = 3 and 4, k = 64 and 33, the grids' exact ties at k = 40 with
    # and without self, all masked, the serial centre, a view, and one
    # event of 12288 nodes (B=1), two of 9000 (D=4) and one of 8193 at k
    # = 48
    rr = np.random.default_rng(SEED + 23)
    for D in (3, 4):
        cases.append((f"k48_B128_L128_D{D}",)
                     + ragged_coords(torch, rr, 128, 128, 40, dev, D=D) + (48, True))
    x, m = ragged_coords(torch, rr, 8, 64, 2, dev, D=4)
    cases += [("k64_B8_L64_D4", x, m, 64, True), ("k33_B8_L64_D4", x, m, 33, True)]
    cases += [("grid_ties_k40",) + g + (40, True),
              ("grid_ties_k40_with_self",) + g + (40, False)]
    x, m = ragged_coords(torch, rr, 4, 64, 64, dev)
    cases.append(("all_masked_k40_B4_L64", x, torch.zeros_like(m), 40, True))
    for D in (3, 4):
        cases.append((f"serial_centre_k40_D{D}",) + tie_centre_events(torch, rr, dev, D)
                     + (40, True))
    wide, mw = ragged_coords(torch, rr, 4, 128, 64, dev, D=7)
    cases.append(("view_2_5_of_7_columns_k40", wide[..., 2:5], mw, 40, True))
    cases.append(("B1_L12288",) + ragged_coords(torch, rr, 1, 12288, 12000, dev)
                 + (K, True))
    cases.append(("xyzt_B2_L9000",) + ragged_coords(torch, rr, 2, 9000, 8000, dev, D=4)
                 + (K, True))
    cases.append(("k48_B1_L8193",) + ragged_coords(torch, rr, 1, 8193, 8193, dev)
                 + (48, True))
    return cases


def chosen_d2(torch, x, idx, em):
    """The squared distance of each chosen neighbour, recomputed in
    float64 from the raw coordinates (0 where ``em`` is False)."""
    xd = x.double()
    D = x.shape[-1]
    flat = idx.long().reshape(idx.shape[0], -1, 1).expand(-1, -1, D)
    nb = torch.gather(xd, 1, flat).reshape(*idx.shape, D)
    return torch.where(em, ((nb - xd[:, :, None, :]) ** 2).sum(-1), 0.0)


def check_knn(torch, ops, rng, dev):
    """Phase 3: the kNN kernel against its plain version on the same card
    (both centre by one rule, so indices and edge masks must be
    identical, for D=3 and D=4), the same bits twice.  Returns the
    largest difference of a chosen neighbour's squared distance
    (``chosen_d2``) between the two over all cases, and the report.  One
    device kernel a call is asserted on the times phase's profiles
    (``assert_one_knn_kernel``)."""
    worst, report = 0.0, []
    for label, x, m, k, self_out in knn_cases(torch, rng, dev):
        ik, mk = ops["knn"](x, m, k, self_out)
        again = ops["knn"](x, m, k, self_out)
        ip, mp = ops["knn_plain"](x, m, k, self_out)
        differ = int((mk != mp).sum()) + int(((ik != ip) & (mk | mp)).sum())
        err = float((chosen_d2(torch, x, ik, mk)
                     - chosen_d2(torch, x, ip, mp)).abs().max())
        worst = max(worst, err)
        assert not bool(mk[~m].any()), f"{label}: an edge on an invalid query"
        assert differ == 0, (
            f"{label}: the kernel's graph differs from the plain one in "
            f"{differ} entries (max |d2| difference {err})")
        same = torch.equal(ik, again[0]) and torch.equal(mk, again[1])
        assert same, f"{label}: two runs differ"
        report.append({"case": label, "B": x.shape[0], "L": x.shape[1],
                       "D": x.shape[-1], "k": k, "exclude_self": self_out,
                       "row_stride": x.stride(1), "edges": int(mk.sum()),
                       "entries_differing_from_plain": differ,
                       "max_abs_d2_err": err, "same_bits_twice": same})
    return worst, report


def assert_one_knn_kernel(costs):
    """Each of ``call_costs``' kNN results ``{label: costs}`` launched
    exactly one device activity a call, the kNN kernel: no centring op,
    no copy of the coordinates."""
    for label, c in costs.items():
        assert c["kernels_per_call"] == 1 and len(c["device_work"]) == 1 and (
            "knn_kernel" in c["device_work"][0]), (
            f"{label}: device work of a kNN call: {c['kernels_per_call']} "
            f"activities, {c['device_work']}")


def device_kernels(torch, fn, calls):
    """``[(name, count)]`` of every device activity (kernels, copies,
    memsets) over ``calls`` calls of ``fn`` (``torch.profiler``)."""
    return [(name, count) for _, name, count in profiled_rows(torch, fn, calls)[0]]


def tiny_events(torch, rng, B, L, dev):
    """Coordinates and a mask over ``B`` events at length ``L``: events
    of 0, 1, 2, K and K+1 valid nodes (whole 64-row blocks of the
    EdgeConv kernels are then padding), the others ragged."""
    x, m = ragged_coords(torch, rng, B, L, 2, dev)
    for e, n in enumerate((0, 1, 2, K, K + 1)):
        m[e] = torch.arange(L, device=dev) < n
    return x, m


def check_edgeconv(torch, ops, rng, dev, B=128, L=128,
                   shapes=((128, 256), (336, 256))):
    """Phase 4: the EdgeConv forward kernel against its plain version,
    within 1e-4 (fp32) or 2e-2 of the plain output's max (bf16); every
    case runs twice and must give the same bits.  Cases, as the
    backward's: both DynEdge layer shapes and H1=100, H2=72 (no multiple
    of the kernel's tiles); add, max and mean; bf16 max with the leaky
    slope; k = 1, 3, 12 (no divisor of the 64 rows of a block) and 64;
    events of 0, 1, 2, k and k+1 valid nodes at L = 48 and 112; L=512
    (serving's largest bucket); TITO's B=8, L=1024, H1 = H2 = 256 with
    max."""
    x, m = ragged_coords(torch, rng, B, L, L // 2, dev)
    main = ops["knn_plain"](x, m, K)
    r2 = np.random.default_rng(SEED + 9)  # the later phases' stream stays
    t48 = ops["knn_plain"](*tiny_events(torch, r2, 8, 48, dev), K)
    t112 = ops["knn_plain"](*tiny_events(torch, r2, 8, 112, dev), K)
    g512 = ops["knn_plain"](*ragged_coords(torch, r2, 4, 512, 256, dev), K)
    tito = ops["knn_plain"](*ragged_coords(torch, r2, TITO_B, TITO_L, TITO_L,
                                           dev, D=4), K)
    g_k1 = ops["knn_plain"](*ragged_coords(torch, r2, 8, 64, 32, dev), 1)
    g_k3 = ops["knn_plain"](*ragged_coords(torch, r2, 8, 64, 32, dev), 3)
    g_k12 = ops["knn_plain"](*ragged_coords(torch, r2, 8, 64, 32, dev), 12)
    g_k64 = ops["knn_plain"](*ragged_coords(torch, r2, 2, 96, 70, dev), 64)
    f32, b16 = torch.float32, torch.bfloat16
    cases = []
    for h1, h2 in shapes:
        cases += [(f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "max", 0.01, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, True),
                  (f"B{B}_L{L}", main, h1, h2, b16, "add", 0.0, False),
                  (f"B{B}_L{L}", main, h1, h2, b16, "max", 0.01, False)]
    cases += [(f"B{B}_L{L}", main, 100, 72, f32, "add", 0.0, False),
              (f"B{B}_L{L}", main, 100, 72, f32, "max", 0.01, False),
              (f"B{B}_L{L}", main, 100, 72, b16, "max", 0.01, False),
              ("tiny_events_L48", t48, 128, 256, f32, "add", 0.0, False),
              ("tiny_events_L48", t48, 336, 256, b16, "max", 0.01, False),
              ("tiny_events_L112", t112, 336, 256, f32, "max", 0.01, False),
              ("tiny_events_L112", t112, 128, 256, b16, "add", 0.0, False),
              ("B4_L512", g512, 336, 256, f32, "add", 0.0, False),
              ("B4_L512", g512, 336, 256, b16, "max", 0.01, False),
              (f"tito_B{TITO_B}_L{TITO_L}", tito, 256, 256, f32, "max", 0.01,
               False),
              (f"tito_B{TITO_B}_L{TITO_L}", tito, 256, 256, b16, "max", 0.01,
               False),
              ("k1_B8_L64", g_k1, 100, 72, f32, "max", 0.01, False),
              ("k1_B8_L64", g_k1, 336, 256, b16, "add", 0.0, False),
              ("k3_B8_L64", g_k3, 336, 256, f32, "add", 0.0, False),
              ("k3_B8_L64", g_k3, 100, 72, b16, "max", 0.01, False),
              ("k12_B8_L64", g_k12, 336, 256, f32, "max", 0.01, False),
              ("k12_B8_L64", g_k12, 128, 256, b16, "max", 0.01, False),
              ("k64_B2_L96", g_k64, 128, 256, f32, "add", 0.0, False),
              ("k64_B2_L96", g_k64, 336, 256, b16, "max", 0.01, False)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, (idx, em), h1, h2, dtype, aggr, slope, mean in cases:
        Bc, Lc = idx.shape[:2]
        g = torch.Generator(device=dev).manual_seed(h1 + Lc)
        a = torch.randn(Bc, Lc, h1, device=dev, generator=g)
        b = torch.randn(Bc, Lc, h1, device=dev, generator=g)
        w2 = torch.randn(h1, h2, device=dev, generator=g) / h1 ** 0.5
        b2 = torch.randn(h2, device=dev, generator=g) * 0.1
        args = [a.to(dtype), b.to(dtype), idx, em, w2.to(dtype), b2.to(dtype)]
        ok = ops["edgeconv"](*args, aggr=aggr, slope=slope)
        again = ops["edgeconv"](*args, aggr=aggr, slope=slope)
        op = ops["edgeconv_plain"](*args, aggr=aggr, slope=slope)
        key = str(dtype).replace("torch.", "")
        case = f"{label} H1={h1} H2={h2} k={idx.shape[2]} {key} {aggr}"
        same = torch.equal(ok, again)
        assert same, f"{case}: two runs gave other bits"
        if mean:
            n = em.sum(dim=2, keepdim=True).clamp_min(1)
            ok, op = ok / n, op / n
        err = float((ok - op).abs().max())
        if dtype == torch.float32:
            # fp32 throughout: only the summation order differs
            torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{case}: {m}")
            rel = None
        else:
            # the same bf16 operands, fp32 sums in another order
            rel = err / float(op.abs().max())
            assert rel <= 2e-2, f"{case}: bf16 EdgeConv off by {rel} of max"
        if label.startswith("tiny"):  # no valid edge, no output
            assert not bool(ok[:2].any()), f"{case}: output on a 0/1-node event"
        worst[key] = max(worst[key], err)
        report.append({"case": label, "H1": h1, "H2": h2, "k": idx.shape[2],
                       "dtype": key, "aggr": "mean" if mean else aggr,
                       "slope": slope, "edges": int(em.sum()),
                       "max_abs_err": err, "rel_to_max": rel,
                       "same_bits_twice": same})
    return worst, report


def fused_knn_cases(torch, ops, rng, dev):
    """Conv inputs of the fused EdgeConv + kNN checks: B=128 events at
    L=128 (lengths 64-128) for H1 = 128 and 336, and at L = 48 and 112
    events of 0, 1, 2, k and k+1 valid nodes beside ragged ones; edges
    from the plain kNN of random coordinates."""
    cases = []
    for label, B, L, lo, small in (("B128_L128", 128, 128, 64, False),
                                   ("tiny_events_L48", 8, 48, 2, True),
                                   ("tiny_events_L112", 8, 112, 2, True)):
        x, m = (tiny_events(torch, rng, B, L, dev) if small
                else ragged_coords(torch, rng, B, L, lo, dev))
        idx, em = ops["knn_plain"](x, m, K)
        for h1 in ((128, 336) if not small else (128,)):
            cases.append((label, m, idx, em, h1))
    return cases


def check_edgeconv_knn(torch, ops, rng, dev, H2=256):
    """The fused EdgeConv + kNN kernel (row 4) against its plain version,
    add and max, fp32 and bf16.  ``out``: the same bits as row 2's
    kernel on the same inputs, and within row 2's tolerance of the plain
    conv; ``nem`` equal to the plain kNN of the kernel's ``out``, and
    ``nidx`` equal where ``nem`` holds; no edge in an event of 0 or 1
    valid nodes, or on an invalid node; the same bits twice."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, m, idx, em, h1 in fused_knn_cases(torch, ops, rng, dev):
        B, L = m.shape
        g = torch.Generator(device=dev).manual_seed(h1 + L)
        a = torch.randn(B, L, h1, device=dev, generator=g)
        b = torch.randn(B, L, h1, device=dev, generator=g)
        w2 = torch.randn(h1, H2, device=dev, generator=g) / h1 ** 0.5
        b2 = torch.randn(H2, device=dev, generator=g) * 0.1
        for dtype, aggr, slope in ((torch.float32, "add", 0.0),
                                   (torch.float32, "max", 0.01),
                                   (torch.bfloat16, "add", 0.0),
                                   (torch.bfloat16, "max", 0.01)):
            conv = [t.to(dtype) for t in (a, b)] + [idx, em]
            wb = [w2.to(dtype), b2.to(dtype)]
            kw = dict(aggr=aggr, slope=slope, knn_k=K, sub_lo=0, sub_hi=3)
            out, nidx, nem = ops["edgeconv_knn"](*conv, m, *wb, **kw)
            again = ops["edgeconv_knn"](*conv, m, *wb, **kw)
            row2 = ops["edgeconv"](*conv, *wb, aggr=aggr, slope=slope)
            plain = ops["edgeconv_plain"](*conv, *wb, aggr=aggr, slope=slope)
            ref_i, ref_m = ops["output_knn_plain"](out, m, K, 0, 3)
            key = str(dtype).replace("torch.", "")
            case = f"{label} H1={h1} {key} {aggr}"
            assert torch.equal(out, row2), f"{case}: out differs from row 2's"
            assert torch.equal(nem, ref_m), f"{case}: nem differs"
            assert torch.equal(torch.where(nem, nidx, -1),
                               torch.where(ref_m, ref_i, -1)), (
                f"{case}: nidx differs where nem holds")
            assert not bool(nem[~m].any()), f"{case}: an edge on an invalid node"
            if label.startswith("tiny"):
                assert not bool(nem[:2].any()), f"{case}: an edge of a 0/1-node event"
            same = all(torch.equal(p, q) for p, q in zip((out, nidx, nem), again))
            assert same, f"{case}: two runs differ"
            err = float((out - plain).abs().max())
            rel = err / float(plain.abs().max())
            if dtype == torch.float32:  # row 2's tolerances
                torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
            else:
                assert rel <= 2e-2, f"{case}: bf16 out off by {rel} of max"
            worst[key] = max(worst[key], err)
            report.append({"case": label, "H1": h1, "H2": H2, "dtype": key,
                           "aggr": aggr, "slope": slope, "edges": int(nem.sum()),
                           "out_same_bits_as_row2": True,
                           "out_rel_err_to_plain": rel,
                           "neighbours_equal_plain_knn": True,
                           "same_bits_twice": same})
    return worst, report


def make_requests(rng, Event):
    def events(lengths):
        return [
            Event(x=rng.standard_normal((int(n), NB_INPUTS)).astype(np.float32),
                  features=FEATURES)
            for n in lengths
        ]

    return {
        "one_event": events([57]),
        "seven_with_empty": events([30, 0, 5, 1, 64, 17, 100]),
        "b128_buckets_16_512": events(
            np.concatenate([[16, 512], rng.integers(2, 513, 126)])),
        "b128_L128": events(rng.integers(65, 129, 128)),
    }


def _convs(module):
    """The convs of a module's backbone whose outputs rebuild the kNN
    graph: a DynEdge's DynEdgeConvs (its backbone, or DeepIce's nested
    ``dyn_edge``), DynEdgeJINST's ``conv_add1`` .. 4, ParticleNeT's
    convs; none for the other backbones (their graphs come from the
    input alone, which both devices share, or there is none)."""
    bb = module.model.backbone
    bb = getattr(bb, "dyn_edge", bb)
    kind = type(bb).__name__
    if kind == "DynEdgeJINST":
        return [getattr(bb, f"conv_add{i}") for i in range(1, 5)]
    if kind in ("DynEdge", "ParticleNeT"):
        return [getattr(bb, f"conv_{i}") for i in range(bb.n_convs)]
    return []


def _record(module, store):
    """Hooks keeping each conv's input adjacency, output latents and
    rebuilt adjacency: a DynEdgeConv returns the rebuilt graph; a
    ParticleNeT conv returns latents only, and its input graph stands
    for both (the next conv's input is the graph rebuilt from them)."""

    def hook(mod, args, out):
        if isinstance(out, tuple):
            store.append((args[2], args[3], out[0], out[1], out[2]))
        else:
            store.append((args[1], args[2], out, args[1], args[2]))

    return [c.register_forward_hook(hook) for c in _convs(module)]


def _adjacencies(store):
    """The 5 graphs of a forward: the initial one, then one per conv."""
    return [store[0][:2]] + [s[3:5] for s in store]


def answer(gpu, requests, counters, expect):
    """Every request through ``gpu``, with the counts set to 0 before and
    the launches each request adds checked against ``expect``.  Returns
    the answers and the counts."""
    for c in counters:
        c.launches = 0
    answers = {}
    for label, evs in requests.items():
        before = [c.launches for c in counters]
        answers[label] = gpu(evs)
        rose = [c.launches - b for c, b in zip(counters, before)]
        assert rose == expect, f"{label}: launches rose by {rose}, not {expect}"
    return answers, [c.launches for c in counters]


def serve(torch, gpu, cpu, requests, counters, expect, dev, collate_events,
          column_atol=0.0):
    """Phase 6: the serving path.  Every request goes through ``gpu`` with
    the launch counts checked per forward, then through ``cpu``; events
    that differ beyond rtol 1e-3 must be explained by kNN near-tie
    flips, and with the CPU run's adjacency fed to the card every layer
    and every event must agree within 1e-3.  A model of several columns
    (``column_atol``) is held at rtol 1e-3 plus ``column_atol`` of each
    column's largest magnitude, as a column may pass through 0."""
    store = []
    handles = _record(gpu, store)
    answers, launches = answer(gpu, requests, counters, expect)
    for h in handles:
        h.remove()
    n_conv = len(_convs(gpu))
    rec = {label: store[i * n_conv:(i + 1) * n_conv]
           for i, label in enumerate(requests)}

    report = []
    for label, evs in requests.items():
        store = []
        handles = _record(cpu, store)
        ref = cpu(evs)
        for h in handles:
            h.remove()
        got = answers[label]
        empty = np.array([e.n_pulses == 0 for e in evs])
        kept = np.flatnonzero(~empty)
        assert got.shape == (len(evs), len(gpu.prediction_columns))
        assert np.isnan(got[empty]).all() and np.isfinite(got[kept]).all()
        atol = column_atol * (np.abs(ref[kept]).max(axis=0) if kept.size else 0.0)
        close = np.isclose(got, ref, rtol=1e-3, atol=atol).all(axis=1) | empty
        flip_events = np.zeros(len(evs), bool)
        flips = []
        for (gi, gm), (ci, cm) in zip(_adjacencies(rec[label]),
                                      _adjacencies(store)):
            diff = ((gi.cpu() != ci) & cm) | (gm.cpu() != cm)
            flips.append(int(diff.sum()))
            flip_events[kept[diff.flatten(1).any(1).numpy()[: len(kept)]]] = True
        unexplained = np.flatnonzero(~close & ~flip_events)
        assert unexplained.size == 0, (
            f"{label}: events {unexplained.tolist()} differ from the CPU "
            "with no kNN flip")

        # layer by layer, with the CPU run's adjacency fed to the card
        batch = gpu._pad_batch_size(collate_events(evs, min_pulses=1))
        batch.edges, batch.edge_mask = store[0][0], store[0][1]

        def pre(i):
            def hook(mod, args):
                return (args[0], args[1], store[i][0].to(dev),
                        store[i][1].to(dev))
            return hook

        injected = []
        handles = [c.register_forward_pre_hook(pre(i))
                   for i, c in enumerate(_convs(gpu))]
        handles += _record(gpu, injected)
        with torch.inference_mode():
            pred = torch.cat([p for p, _ in gpu.model(batch.to(dev),
                                                      inference=True)], dim=1)
        for h in handles:
            h.remove()
        pred = pred[: len(kept)].float().cpu().numpy()
        off = ~np.isclose(pred, ref[kept], rtol=1e-3, atol=atol)
        assert not off.any(), (
            f"{label}: prediction with the CPU adjacency: {int(off.sum())} "
            f"entries beyond rtol 1e-3, the largest difference "
            f"{float(np.abs(pred - ref[kept]).max())}")
        layer_err = []
        for g, c in zip(injected, store):
            e = float((g[2].cpu() - c[2]).abs().max()) / max(
                float(c[2].abs().max()), 1e-30)
            assert e <= 1e-3, f"{label}: a layer is off by {e} of its max"
            layer_err.append(e)
        report.append({
            "request": label, "events": len(evs),
            "padded_B": batch.batch_size, "L": batch.max_length,
            "events_beyond_rtol_1e-3": int((~close).sum()),
            "events_with_knn_flips": int(flip_events.sum()),
            "knn_flips_per_graph": flips,
            "layer_rel_err_with_cpu_adjacency": layer_err,
            "max_rel_err": float(np.max(
                np.abs(got[kept] - ref[kept])
                / np.maximum(np.abs(ref[kept]), atol))),
        })
    return answers, launches, report


def fused_graphs_equal(torch, layers, module, requests):
    """Every request through ``module`` with ``FUSE_CONV_KNN`` off and
    on: row 4 centres by row 1's rule and its ``out`` is row 2's bit for
    bit (phase edgeconv_knn), so from the same latents both routes must
    build the same graphs, and then every layer's latents agree too."""
    report = []
    for label, evs in requests.items():
        runs = []
        for on in (False, True):
            layers.FUSE_CONV_KNN = on
            store = []
            handles = _record(module, store)
            answers = module(evs)
            for h in handles:
                h.remove()
            runs.append((answers, _adjacencies(store), [s[2] for s in store]))
        layers.FUSE_CONV_KNN = False
        (a_off, g_off, x_off), (a_on, g_on, x_on) = runs
        for i, ((io, mo), (in_, mn)) in enumerate(zip(g_off, g_on)):
            assert torch.equal(mo, mn) and torch.equal(
                torch.where(mo, io, -1), torch.where(mn, in_, -1)), (
                f"{label}: graph {i} differs with FUSE_CONV_KNN on")
        for i, (p, q) in enumerate(zip(x_off, x_on)):
            assert torch.equal(p, q), f"{label}: conv {i}'s latents differ"
        report.append({"request": label, "graphs_identical": len(g_off),
                       "latents_identical": len(x_off),
                       "answers_identical": bool(np.array_equal(
                           a_off, a_on, equal_nan=True))})
    return report


def serve_bf16(gpu16, requests, answers, counters, expect):
    """The bfloat16 serving mode: finite answers, ``expect`` launches per
    request."""
    out, launches = answer(gpu16, requests, counters, expect)
    report = []
    for label, evs in requests.items():
        empty = np.array([e.n_pulses == 0 for e in evs])
        got = out[label]
        assert np.isfinite(got[~empty]).all() and np.isnan(got[empty]).all()
        ref = answers[label][~empty]
        report.append({"request": label, "max_rel_diff_to_fp32": float(
            np.max(np.abs(got[~empty] - ref) / np.abs(ref)))})
    return launches, report


KNN_SHAPES = (  # label, B, L, D, shortest event, k: row 1's shapes on the path
    ("B128_L128_D3", 128, 128, 3, 65, K),
    ("B8_L1024_D4", TITO_B, TITO_L, 4, TITO_L, K),
    ("B1_L128_D3", 1, 128, 3, 128, K),
    ("B1_L512_D3", 1, 512, 3, 512, K),
    ("B128_L128_D3_k32", 128, 128, 3, 65, 32),  # RadialEdges' graph
    # the rounds kernel: k past 32, and an event past 8192 nodes (the
    # DP x graph step's kNN, on the whole gathered event)
    ("B128_L128_D3_k48", 128, 128, 3, 65, 48),
    ("B1_L12288_D3", 1, PARALLEL_LONG_L, 3, PARALLEL_LONG_L - 288, K),
)
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def knn_bound(m, D, peaks, k=K):
    """Row 1's bound: ~10 flops a valid pair (12 for D=4) against every
    input read and output written once; ``(ms, "bytes" | "operations")``."""
    B, L = m.shape
    n = m.sum(1).double()
    flops = (10.0 if D == 3 else 12.0) * float((n * n).sum())
    nbytes = B * L * (D * 4 + 1) + B * L * k * (4 + 1)
    t_b, t_o = nbytes / peaks["bytes"], flops / peaks["fp32"]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def host_enqueue_ms(torch, fn, calls=100):
    """Host wall time a call of ``fn`` takes to return (CUDA work is only
    enqueued), mean over ``calls`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def launch_floor(torch, build):
    """An empty kernel (one block of 32 threads) on the current stream:
    its profiled device time, its time between CUDA events and the host
    time of its launch.  Built here from ``EMPTY_KERNEL``."""
    src = build.BUILD_DIR / "launch_floor.cu"
    so = build.BUILD_DIR / "liblaunch_floor.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_KERNEL)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(so)).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        assert fn(torch.cuda.current_stream().cuda_stream) == 0

    return {"device_ms": kernel_device_ms(torch, call, "empty_kernel", calls=20),
            "ms": cuda_ms(torch, call), "host_ms": host_enqueue_ms(torch, call)}


def call_costs(torch, fn, match, calls=5):
    """One call of ``fn`` on the card: ms between CUDA events, the
    profiled device time of the kernel named ``match`` and of all the
    call's device work, the device activities it launches, and its host
    time."""
    fn()
    rows = device_kernels(torch, fn, calls=calls)
    return dict(
        ms=cuda_ms(torch, fn),
        device_ms=kernel_device_ms(torch, fn, match),
        device_ms_all_work=device_profile(torch, fn, calls=calls)["device_ms"]
        / calls,
        kernels_per_call=sum(c for _, c in rows) / calls,
        device_work=[name[:60] for name, _ in rows],
        host_ms=host_enqueue_ms(torch, fn),
    )


def knn_times(torch, knn, knn_plain, dev, peaks):
    """Row 1 at ``KNN_SHAPES``, inputs from a fixed seed: ``call_costs``
    of one call, its plain version's ms and its bound."""
    times = {}
    for label, B, L, D, lo, k in KNN_SHAPES:
        x, m = ragged_coords(torch, np.random.default_rng(SEED + 5), B, L, lo,
                             dev, D=D)
        bound, by = knn_bound(m, D, peaks, k)
        times[label] = dict(
            **call_costs(torch, lambda: knn(x, m, k), "knn_kernel"),
            plain_ms=cuda_ms(torch, lambda: knn_plain(x, m, k), runs=5),
            bound_ms=bound, bound_by=by)
    return times


def kernel_times(torch, ops, rng, dev, peaks):
    """Phase 8a: each kernel and its plain version at the serving shape
    (B=128, L=128, k=8; EdgeConv at H1=336, H2=256 and at conv 0's
    H1=128), the kNN also at TITO's (B=8, L=1024, D=4) and a single
    request's (B=1, L = 128 and 512) and the EdgeConv (max, H1 = H2 =
    256) at TITO's, with their bounds."""
    B, L, H1, H2 = 128, 128, 336, 256
    x, m = ragged_coords(torch, rng, B, L, 65, dev)
    idx, em = ops["knn"](x, m, K)
    times = {"knn": knn_times(torch, ops["knn"], ops["knn_plain"], dev, peaks)}
    x4, m4 = ragged_coords(torch, np.random.default_rng(SEED + 5), TITO_B,
                           TITO_L, TITO_L, dev, D=4)
    # row 2 at DynEdge's layers 1-3 (H1=336), its conv 0 (H1=128) and
    # TITO's shape (max)
    graph4 = ops["knn"](x4, m4, K)
    g = torch.Generator(device=dev).manual_seed(1)
    for tag, (gi, ge), h1, h2, aggr in (
        ("", (idx, em), H1, H2, "add"),
        ("_H1_128", (idx, em), 128, H2, "add"),
        (f"_tito_B{TITO_B}_L{TITO_L}", graph4, 256, 256, "max"),
    ):
        Bc, Lc = gi.shape[:2]
        flops = float(ge.sum()) * (2.0 * h1 * h2 + 2 * h1 + 3 * h2)
        for key, dtype, rate in (
            ("edgeconv_fwd", torch.float32, peaks["fp32"]),
            ("edgeconv_fwd_bf16", torch.bfloat16, peaks["bf16"]),
        ):
            a = torch.randn(Bc, Lc, h1, device=dev, generator=g).to(dtype)
            b = torch.randn(Bc, Lc, h1, device=dev, generator=g).to(dtype)
            w2 = (torch.randn(h1, h2, device=dev, generator=g) / h1 ** 0.5).to(dtype)
            b2 = torch.zeros(h2, device=dev, dtype=dtype)
            el = a.element_size()
            nbytes = (2 * Bc * Lc * h1 * el + Bc * Lc * K * 5
                      + (h1 + 1) * h2 * el + Bc * Lc * h2 * 4)
            t_b, t_o = nbytes / peaks["bytes"], flops / rate
            conv = (a, b, gi, ge, w2, b2)
            times[key + tag] = dict(
                ms=cuda_ms(torch, lambda: ops["edgeconv"](*conv, aggr=aggr)),
                device_ms=kernel_device_ms(
                    torch, lambda: ops["edgeconv"](*conv, aggr=aggr),
                    "edgeconv_fwd"),
                plain_ms=cuda_ms(torch, lambda: ops["edgeconv_plain"](
                    *conv, aggr=aggr)),
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
            )
    return times


def dynedge_energy_model(device, compute_dtype=None, **task):
    """The full-width DynEdge energy model of the serving and training
    phases (random weights until a state is loaded)."""
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )

    return StandardModel(
        DynEdge(nb_inputs=NB_INPUTS, compute_dtype=compute_dtype),
        [EnergyReconstruction(hidden_size=128, **task)],
        device=device,
    )


def dynedge_energy_trainable(train_tree, device, compute_dtype=None):
    """:func:`dynedge_energy_model` with ``LogCoshLoss`` on
    ``log10(total_energy)`` and the weights of ``train_tree`` (a JAX-layout
    tree, :func:`trainable_tree`)."""
    import torch

    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
    from graphnet_tpu_torch.utils.jax_params import params_from_jax

    model = dynedge_energy_model(
        device, compute_dtype, loss_function=LogCoshLoss(),
        target_labels=("total_energy",),
        transform_prediction_and_target=torch.log10)
    model.load_state_dict(params_from_jax(train_tree, model.state_dict()))
    return model


def trainable_tree(tree):
    """``tree`` with the energy head's affine kernel made positive and
    scaled by 1e-2.  The random tree's latents reach ~1e4 (sum pooling
    over the nodes), so its head starts deep in the softplus's flat
    side, where every gradient vanishes; the readout's output is
    non-negative (relu), so a small positive kernel starts the head in
    the targets' range instead."""
    head = tree["params"]["tasks_0"]["affine"]
    return {"params": {
        **tree["params"],
        "tasks_0": {"affine": {**head, "kernel": np.abs(head["kernel"]) * 1e-2}},
    }}


def act(torch, x, slope):
    return torch.where(x > 0, x, slope * x)


def zero_ambiguous(torch, a, b, idx, em, w2, b2, g, aggr, slope, rel=1e-5):
    """``g`` with 0 at each (node, channel) where the backward is
    discontinuous within rounding: an edge's second-layer pre-activation
    within ``rel`` of its max from 0 (the gate), or, under max, the top
    two valid edges within that of each other (the argmax).  Two correct
    implementations that sum in another order may decide these either
    way; everywhere else their gradients are continuous.  Returns the
    new ``g`` and the count of entries set to 0."""
    from graphnet_tpu_torch.ops.gather_reduce import gather_neighbors

    z = a.float()[:, :, None, :] + gather_neighbors(b, idx).float()
    msgs = act(torch, z, slope).to(w2.dtype).double()
    pre2 = torch.matmul(msgs, w2.double()) + b2.double()
    thr = rel * float(pre2.abs().max())
    m = em[..., None]
    amb = ((pre2.abs() <= thr) & m).any(dim=2)
    if aggr == "max" and idx.shape[2] > 1:
        top = torch.where(m, act(torch, pre2, slope), -1e30).topk(2, dim=2).values
        amb |= (top[:, :, 0] - top[:, :, 1] <= thr) & (top[:, :, 1] > -1e29)
    return torch.where(amb, 0.0, g), int(amb.sum())


def check_edgeconv_bwd(torch, ops, rng, dev, B=128, L=128,
                       shapes=((128, 256), (336, 256))):
    """Phase 5: the EdgeConv backward kernel against its plain version,
    each of da, db, dW2, db2 within 1e-4 (fp32) or 2e-2 (bf16) of the
    plain output's max |value|; the kernel runs twice and the two runs
    must give the same bits.  Cases: both layer shapes of DynEdge and
    widths that are no multiple of the kernel's tiles (H1=100, H2=72);
    add, max and mean; k = 8, 1, 12 (no divisor of the 64 rows of a
    block) and 64; a 1-node and an all-masked event, L = 512 and 4096;
    QUESO's training shape (B = 512, L = 512, lengths by its cell's law,
    so most blocks hold only padding) in fp32, add and max; fp32 widths
    past the 128-row edge kernel's (H1 > 352)."""
    x, m = ragged_coords(torch, rng, B, L, L // 2, dev)
    main = ops["knn_plain"](x, m, K)
    xt, mt = ragged_coords(torch, rng, 3, 16, 16, dev)
    mt[0, 1:] = False  # 1 node: no edge
    mt[1] = False  # all masked, as a padding row
    mt[2, 5:] = False  # 5 nodes: fewer than k neighbours
    tiny = ops["knn_plain"](xt, mt, K)
    g512 = ops["knn_plain"](*ragged_coords(torch, rng, 1, 512, 400, dev), K)
    g4096 = ops["knn_plain"](*ragged_coords(torch, rng, 1, 4096, 3000, dev), K)
    # k = 1, a k that does not divide the kernel's 64 edge rows (a block
    # then holds 60), and the largest k, one node a block
    g_k1 = ops["knn_plain"](*ragged_coords(torch, rng, 8, 64, 32, dev), 1)
    g_k12 = ops["knn_plain"](*ragged_coords(torch, rng, 8, 64, 32, dev), 12)
    g_k64 = ops["knn_plain"](*ragged_coords(torch, rng, 2, 96, 70, dev), 64)
    g_queso = ops["knn_plain"](*queso_coords(torch, rng, 512, 512, dev), K)
    f32, b16 = torch.float32, torch.bfloat16
    cases = []
    for h1, h2 in shapes:
        cases += [(f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "max", 0.01, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, True),
                  (f"B{B}_L{L}", main, h1, h2, b16, "add", 0.0, False),
                  (f"B{B}_L{L}", main, h1, h2, b16, "max", 0.01, False)]
    cases += [("tiny_events_L16", tiny, 128, 256, f32, "add", 0.0, False),
              ("tiny_events_L16", tiny, 128, 256, f32, "max", 0.01, False),
              ("one_event_L512", g512, 336, 256, f32, "add", 0.0, False),
              ("one_event_L512", g512, 336, 256, b16, "add", 0.0, False),
              ("one_event_L4096", g4096, 336, 256, f32, "add", 0.0, False),
              # widths that are no multiple of the kernel's tiles
              (f"B{B}_L{L}", main, 100, 72, f32, "add", 0.0, False),
              (f"B{B}_L{L}", main, 100, 72, f32, "max", 0.01, False),
              (f"B{B}_L{L}", main, 100, 72, b16, "max", 0.01, False),
              ("k1_B8_L64", g_k1, 100, 72, f32, "max", 0.01, False),
              ("k1_B8_L64", g_k1, 336, 256, b16, "add", 0.0, False),
              ("k12_B8_L64", g_k12, 336, 256, f32, "max", 0.01, False),
              ("k12_B8_L64", g_k12, 100, 72, b16, "add", 0.0, False),
              ("k12_B8_L64", g_k12, 128, 256, b16, "max", 0.01, False),
              ("k64_B2_L96", g_k64, 128, 256, f32, "add", 0.0, False),
              ("k64_B2_L96", g_k64, 336, 256, b16, "max", 0.01, False),
              # fp32 widths past the 128-row edge kernel's (the 64-row
              # kernel)
              ("k12_B8_L64", g_k12, 384, 256, f32, "max", 0.01, False),
              ("k64_B2_L96", g_k64, 360, 136, f32, "add", 0.0, False)]
    for h1, h2 in shapes:
        cases += [("queso_B512_L512", g_queso, h1, h2, f32, "add", 0.0, False),
                  ("queso_B512_L512", g_queso, h1, h2, f32, "max", 0.01, False)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, (idx, em), h1, h2, dtype, aggr, slope, mean in cases:
        Bc, Lc = idx.shape[:2]
        gen = torch.Generator(device=dev).manual_seed(h1 + Lc)
        a = torch.randn(Bc, Lc, h1, device=dev, generator=gen).to(dtype)
        b = torch.randn(Bc, Lc, h1, device=dev, generator=gen).to(dtype)
        w2 = (torch.randn(h1, h2, device=dev, generator=gen) / h1 ** 0.5).to(dtype)
        b2 = (torch.randn(h2, device=dev, generator=gen) * 0.1).to(dtype)
        g = torch.randn(Bc, Lc, h2, device=dev, generator=gen)
        if mean:  # the gradient of add divided by the valid-edge count
            g = g / em.sum(dim=2, keepdim=True).clamp_min(1)
        g, zeroed = zero_ambiguous(torch, a, b, idx, em, w2, b2, g, aggr, slope)
        args = (a, b, idx, em, w2, b2, g)
        got = ops["edgeconv_bwd"](*args, aggr=aggr, slope=slope)
        again = ops["edgeconv_bwd"](*args, aggr=aggr, slope=slope)
        exp = ops["edgeconv_bwd_plain"](*args, aggr=aggr, slope=slope)
        key = str(dtype).replace("torch.", "")
        tol = 1e-4 if dtype == f32 else 2e-2
        rel = {}
        for name, o, e in zip(("da", "db", "dw2", "db2"), got, exp):
            err, scale = float((o - e).abs().max()), float(e.abs().max())
            assert err <= tol * scale, (
                f"{label} H1={h1} {key} {aggr}: {name} off by {err}, more "
                f"than {tol} of its max {scale}")
            rel[name] = err / scale
            worst[key] = max(worst[key], err)
        if label.startswith("tiny"):  # no edge, no gradient
            for t in got[:2]:
                assert not bool(t[0].any()) and not bool(t[1].any())
        same = all(torch.equal(p, q) for p, q in zip(got, again))
        assert same, f"{label} H1={h1} {key} {aggr}: two runs gave other bits"
        report.append({
            "case": label, "H1": h1, "H2": h2, "k": idx.shape[2],
            "dtype": key, "aggr": "mean" if mean else aggr, "slope": slope,
            "edges": int(em.sum()), "g_zeroed_ambiguous": zeroed,
            "rel_err_to_max": rel, "same_bits_twice": same,
        })
    return worst, report


def check_max_routing(torch, ops, rng, dev, B=64, L=16, k=8,
                      shapes=((128, 256), (336, 256), (100, 72)),
                      dtypes=("float32", "bfloat16"), spread=False):
    """Phase: under max aggregation the EdgeConv backward kernel (row 3)
    routes each (node, column) gradient to the edge whose message won in
    the forward kernel (row 2), at planted near-ties and exact ties, with
    nothing zeroed.  Node p of each event (0, or with ``spread`` drawn
    from the whole event, so that it falls in either forward block of a
    128-row backward block and at every rotation of W2's tiles) has k
    private neighbours (nodes p+1..p+k, no other edge is valid), whose b
    rows are one row, each
    neighbour's with a few components moved by one rounding of the dtype
    or not at all (an exact copy), so every column's messages tie or lie
    within roundings of each other.  The output gradient is one-hot in
    one column per event, so db is non-zero only at the routed
    neighbour's row.  The forward kernel run with one valid edge gives
    that edge's own message bits (an edge's message does not depend on
    the others); the winner is the first edge whose message equals their
    max, and the full forward's output must be that max, bit for bit.
    Both dtypes, both DynEdge layer shapes and widths that are no
    multiple of the kernels' tiles."""
    report = []
    ev = torch.arange(B, device=dev)
    for dtype in (getattr(torch, d) for d in dtypes):
        eps = float(torch.finfo(dtype).eps)
        for h1, h2 in shapes:
            gen = torch.Generator(device=dev).manual_seed(
                h1 + h2 + (dtype == torch.bfloat16))
            pos = torch.zeros(B, dtype=torch.long, device=dev)
            if spread:
                pos = torch.from_numpy(rng.integers(0, L - k, B)).to(dev)
            nbr = pos[:, None] + 1 + torch.arange(k, device=dev)[None]
            idx = torch.zeros(B, L, k, dtype=torch.int32, device=dev)
            idx[ev, pos] = nbr.int()
            em = torch.zeros(B, L, k, dtype=torch.bool, device=dev)
            em[ev, pos] = True
            a = torch.randn(B, L, h1, device=dev, generator=gen).to(dtype)
            base = torch.randn(B, 1, h1, device=dev, generator=gen)
            # neighbour e's row: base with about two components moved by
            # one rounding up or down; about a third of the neighbours
            # are exact copies
            step = torch.randint(-1, 2, (B, k, h1), device=dev, generator=gen)
            step *= torch.rand(B, k, h1, device=dev, generator=gen) < 3.0 / h1
            step *= (torch.rand(B, k, 1, device=dev, generator=gen) > 0.33)
            b = torch.zeros(B, L, h1, device=dev)
            b[ev[:, None], nbr] = base * (1 + eps * step)
            b = b.to(dtype)
            w2 = (torch.randn(h1, h2, device=dev, generator=gen) / h1 ** 0.5).to(dtype)
            b2 = (torch.randn(h2, device=dev, generator=gen) * 0.1).to(dtype)
            col = torch.from_numpy(rng.integers(0, h2, B)).to(dev)
            g = torch.zeros(B, L, h2, device=dev)
            g[ev, pos, col] = 1.0
            kw = dict(aggr="max", slope=0.01)
            _, db, _, _ = ops["edgeconv_bwd"](a, b, idx, em, w2, b2, g, **kw)
            nz = db[ev[:, None], nbr].abs().sum(dim=2) > 0  # [B, k]
            assert bool((nz.sum(dim=1) == 1).all()), (
                f"H1={h1} {dtype}: db is not non-zero at exactly one "
                "neighbour of each event")
            routed = nz.int().argmax(dim=1)
            # each edge's own message: B * k events, one valid edge each
            one = torch.eye(k, dtype=torch.bool, device=dev).repeat(B, 1)
            rows, prep = torch.arange(B * k, device=dev), pos.repeat_interleave(k)
            em1 = torch.zeros(B * k, L, k, dtype=torch.bool, device=dev)
            em1[rows, prep] = one
            rep = [t.repeat_interleave(k, dim=0) for t in (a, b, idx)]
            msg = ops["edgeconv"](rep[0], rep[1], rep[2], em1, w2, b2, **kw)
            msg = msg[rows, prep].reshape(B, k, h2)
            del rep, em1
            full = ops["edgeconv"](a, b, idx, em, w2, b2, **kw)[ev, pos]
            assert torch.equal(full, msg.amax(dim=1)), (
                f"H1={h1} {dtype}: the forward's max is not its edges' max")
            vals = msg[ev, :, col]  # [B, k]
            top = vals.amax(dim=1, keepdim=True)
            winner = (vals == top).int().argmax(dim=1)
            second = torch.where(vals == top, -torch.inf, vals).amax(dim=1)
            gap = (top[:, 0] - second) / top[:, 0].abs().clamp_min(1e-30)
            wrong = int((routed != winner).sum())
            assert wrong == 0, (
                f"H1={h1} {dtype}: {wrong} of {B} events route the gradient "
                "to another edge than the forward's winner")
            report.append({
                "dtype": str(dtype).replace("torch.", ""), "H1": h1, "H2": h2,
                "k": k, "events": B, "L": L, "spread": spread,
                "exact_ties_at_max": int(((vals == top).sum(dim=1) > 1).sum()),
                "within_2_eps_of_max": int((gap <= 2 * eps).sum()),
                "routed_to_winner": B - wrong})
    return report


def synthetic_batch(make_batch, rng, B=128, L=128):
    """The JAX bench's training batch, made here by a copy of the recipe
    of ``bench.py``'s ``_synthetic_batch``: lengths L/2..L, xyz from
    N(0, 2^2), a uniform fourth feature, ``total_energy`` =
    |N(200, 100^2)|."""
    events = []
    for _ in range(B):
        n = int(rng.integers(L // 2, L + 1))
        events.append(np.concatenate(
            [rng.standard_normal((n, 3)).astype(np.float32) * 2.0,
             rng.random((n, 1)).astype(np.float32)], axis=1))
    labels = {"total_energy": np.abs(
        rng.standard_normal(B).astype(np.float32) * 100 + 200)}
    return make_batch(events, labels=labels, length=L)


def model_convs(model):
    bb = model.backbone
    return [getattr(bb, f"conv_{i}") for i in range(bb.n_convs)]


def record_adjacency(model, store):
    """Pre-hooks keeping each DynEdgeConv's input adjacency."""

    def hook(mod, args):
        store.append((args[2], args[3]))

    return [c.register_forward_pre_hook(hook) for c in model_convs(model)]


def feed_adjacency(model, graphs, dev):
    """Pre-hooks replacing each DynEdgeConv's input adjacency with
    ``graphs[i]`` (a list the caller refills before each step)."""

    def pre(i):
        def hook(mod, args):
            return (args[0], args[1], graphs[i][0].to(dev),
                    graphs[i][1].to(dev))
        return hook

    return [c.register_forward_pre_hook(pre(i))
            for i, c in enumerate(model_convs(model))]


def run_steps(torch, trainer, batches, counters=(), before_step=None):
    """One ``Trainer.train_step`` per batch.  Per step: the loss, the
    launch counts risen, the parameters whose gradient is not finite or
    is all zero; for step 1 also every gradient and update, on the
    host."""
    model = trainer.model
    out = {"loss": [], "rose": [], "nonfinite": [], "zero": []}
    for s, batch in enumerate(batches):
        if before_step is not None:
            before_step(s)
        counts = [c.launches for c in counters]
        p0 = [p.detach().clone() for p in model.parameters()]
        out["loss"].append(float(trainer.train_step(batch)))
        out["rose"].append([c.launches - n for c, n in zip(counters, counts)])
        named = list(model.named_parameters())
        out["nonfinite"].append([n for n, p in named if p.grad is None
                                 or not bool(torch.isfinite(p.grad).all())])
        out["zero"].append([n for n, p in named
                            if p.grad is not None and not bool(p.grad.any())])
        if s == 0:  # a parameter the loss does not reach: a zero gradient
            out["grads1"] = {n: (torch.zeros_like(p) if p.grad is None
                                 else p.grad).float().cpu()
                             for n, p in named}
            out["update1"] = {n: (p.detach() - q).float().cpu()
                              for (n, p), q in zip(named, p0)}
    return out


def train(torch, make, Trainer, batch, counters, expect, dev, steps=3):
    """Phase 7: the main training path on the card, held against the
    CPU.  ``make(device, compute_dtype)`` builds the model with the
    JAX-layout weights loaded; ``batch`` is on the CPU."""
    cpu_store = []
    cpu_model = make("cpu")
    n_conv = len(model_convs(cpu_model))
    handles = record_adjacency(cpu_model, cpu_store)
    cpu = run_steps(torch, Trainer(cpu_model), [batch] * steps)
    for h in handles:
        h.remove()
    cpu_graphs = [cpu_store[s * n_conv:(s + 1) * n_conv] for s in range(steps)]

    # the main path: no help from the CPU
    gpu_model = make(dev)
    gpu_store = []
    handles = record_adjacency(gpu_model, gpu_store)
    on_card = batch.to(dev)
    for c in counters:
        c.launches = 0
    gpu = run_steps(torch, Trainer(gpu_model), [on_card] * steps, counters)
    launches = [c.launches for c in counters]
    for h in handles:
        h.remove()
    assert all(r == expect for r in gpu["rose"]), gpu["rose"]
    assert not any(gpu["nonfinite"]) and not any(gpu["zero"]), (
        gpu["nonfinite"], gpu["zero"])
    flips = []
    for s in range(steps):
        n = 0
        for (gi, gm), (ci, cm) in zip(gpu_store[s * n_conv:(s + 1) * n_conv],
                                      cpu_graphs[s]):
            n += int((((gi.cpu() != ci) & cm) | (gm.cpu() != cm)).sum())
        flips.append(n)

    # the CPU run's adjacency fed to the card
    fed_model = make(dev)
    graphs = list(cpu_graphs[0])

    def refill(s):
        graphs[:] = cpu_graphs[s]

    handles = feed_adjacency(fed_model, graphs, dev)
    fed_batches = [replace(on_card, edges=cpu_graphs[s][0][0].to(dev),
                           edge_mask=cpu_graphs[s][0][1].to(dev))
                   for s in range(steps)]
    fed = run_steps(torch, Trainer(fed_model), fed_batches, before_step=refill)
    for h in handles:
        h.remove()
    np.testing.assert_allclose(fed["loss"], cpu["loss"], rtol=1e-3,
                               err_msg="losses with the CPU adjacency")
    grad_err, update_err = {}, {}
    for name, gc in cpu["grads1"].items():
        e = float((fed["grads1"][name] - gc).abs().max())
        scale = float(gc.abs().max())
        assert e <= 1e-3 * scale, f"step-1 gradient of {name}: {e} vs max {scale}"
        grad_err[name] = e / scale
        uc = cpu["update1"][name]
        update_err[name] = float((fed["update1"][name] - uc).abs().max())
    worst_u = max(update_err, key=update_err.get)

    # the rest of the user's path: fit with validation, predict, and the
    # state_dict.pkl round trip
    trainer = Trainer(make(dev))
    history = trainer.fit([on_card] * 2, [on_card], max_epochs=2)
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    pred = trainer.predict([on_card])[0]
    assert pred.shape == (batch.batch_size, 1) and np.isfinite(pred).all()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pkl = os.path.join(tmp, "state_dict.pkl")
    trainer.save_state_dict(pkl)
    again = Trainer(make(dev))
    again.load_state_dict(pkl)
    os.remove(pkl)
    os.rmdir(tmp)
    assert np.array_equal(again.predict([on_card])[0], pred), (
        "predictions moved through save_state_dict / load_state_dict")
    return gpu, {
        "steps": steps, "B": batch.batch_size, "L": batch.max_length,
        "losses_card": gpu["loss"], "losses_cpu": cpu["loss"],
        "losses_card_cpu_adjacency": fed["loss"],
        "launches_per_step": gpu["rose"],
        "every_grad_finite_nonzero": True,
        "knn_flips_vs_cpu_per_step": flips,
        "max_grad_rel_err_step1_cpu_adjacency": max(grad_err.values()),
        "worst_grad_param": max(grad_err, key=grad_err.get),
        "max_abs_adam_update_diff_step1": update_err[worst_u],
        "max_abs_adam_update_step1": float(cpu["update1"][worst_u].abs().max()),
        "worst_update_param": worst_u,
        "fit_history": history,
    }, launches


def train_bf16(torch, make, Trainer, batch, counters, expect, dev, loss_fp32,
               steps=3):
    """Phase 7b: bf16 training on the card from the same weights."""
    model = make(dev, "bfloat16")
    on_card = batch.to(dev)
    for c in counters:
        c.launches = 0
    out = run_steps(torch, Trainer(model), [on_card] * steps, counters)
    launches = [c.launches for c in counters]
    assert all(r == expect for r in out["rose"]), out["rose"]
    assert np.isfinite(out["loss"]).all() and not any(out["nonfinite"]), out
    rel = abs(out["loss"][0] - loss_fp32) / abs(loss_fp32)
    assert rel <= 2e-2, f"bf16 step-1 loss off the fp32 one by {rel}"
    return {"losses": out["loss"], "launches_per_step": out["rose"],
            "step1_rel_diff_to_fp32": rel,
            "params_with_all_zero_grad": sorted(set(sum(out["zero"], [])))}, launches


def train_sqlite(torch, build, Trainer, counters, step_expect, fwd_expect,
                 dev, seed, epochs=2, evidence="chiprun_out"):
    """The training example's path on the card: ``build(device, seed)``
    gives the example's datamodule (the bundled SQLite database through
    ``SQLiteDataset``, ``KNNGraph(Prometheus())`` and the DataLoader,
    whose train loader shuffles with ``seed``) and its full-width DynEdge
    energy model; ``Trainer.fit`` runs ``epochs`` epochs with
    validation, with the counts set to 0 just before.  Each step
    launches ``step_expect``, each validation forward ``fwd_expect``;
    every gradient is finite, and non-zero but where the energy head
    saturates: a few Adam steps from a random start can drive every
    event of a batch deep into the head's softplus flat side
    (``sigmoid(0.05 x)`` is 0 in fp32 below x ~ -2000), where every
    gradient is exactly 0.  Such a step must have all gradients 0 and
    the head saturated for every event; step 1 must have none.  Step 1 is
    held against the same model on the CPU, fed the card's per-layer
    adjacency (the fused kernel's ``nidx``, ``nem``) and run with the
    fused kernel off: given one adjacency both routes compute the same
    function, so no kNN near-tie can hide a fault.  If that check fails,
    the step-1 batch, the card's adjacency, both devices' step-1 losses
    and gradients and the per-parameter errors go to
    ``<evidence>/train_sqlite_seed<seed>.pt`` (and the errors to a
    ``.json`` beside it) before the phase raises
    (``tools/train_sqlite_seeds.py`` reads them).  Then
    ``Trainer.predict`` on the validation loader."""
    datamodule, model = build(dev, seed)
    n_conv = len(model_convs(model))
    trainer = Trainer(model)
    store, steps, head = [], [], []
    handles = record_adjacency(model, store)
    handles.append(model.tasks_0.affine.register_forward_hook(
        lambda mod, args, out: head.append(out.detach())))
    train_step = trainer.train_step

    def recording(batch):
        before = [c.launches for c in counters]
        loss = train_step(batch)
        named = list(model.named_parameters())
        x = head[-1].float()
        rec = {"rose": [c.launches - b for c, b in zip(counters, before)],
               "loss": float(loss),
               "head_saturated": bool((torch.sigmoid(0.05 * x) == 0).all()),
               "head_min_max": [float(x.min()), float(x.max())],
               "nonfinite": [n for n, p in named if p.grad is None
                             or not bool(torch.isfinite(p.grad).all())],
               "zero": [n for n, p in named
                        if p.grad is not None and not bool(p.grad.any())]}
        if not steps:
            rec.update(batch=batch,
                       grads={n: p.grad.float().cpu() for n, p in named},
                       graphs=[(i.cpu(), m.cpu()) for i, m in store[:n_conv]])
        steps.append(rec)
        return loss

    trainer.train_step = recording
    train_loader = datamodule.train_dataloader()
    val_loader = datamodule.val_dataloader()
    for c in counters:
        c.launches = 0
    history = trainer.fit(train_loader, val_loader, max_epochs=epochs)
    launches = [c.launches for c in counters]
    for h in handles:
        h.remove()
    rose = [s["rose"] for s in steps]
    assert all(r == step_expect for r in rose), rose
    n_params = len(list(model.parameters()))
    assert not any(s["nonfinite"] for s in steps), [s["nonfinite"] for s in steps]
    assert not steps[0]["zero"], steps[0]["zero"]
    for i, s in enumerate(steps):
        assert not s["zero"] or (s["head_saturated"] and len(s["zero"]) == n_params), (
            f"step {i + 1}: zero gradients {s['zero']} with the head at "
            f"{s['head_min_max']}")
    n_val = epochs * len(list(val_loader))
    assert launches == [len(steps) * s + n_val * f
                        for s, f in zip(step_expect, fwd_expect)], launches

    # step 1 on the CPU with the card's adjacency, the fused kernel off
    from graphnet_tpu_torch.models.components import layers

    first = steps[0]
    fused = layers.FUSE_CONV_KNN
    layers.FUSE_CONV_KNN = False
    try:
        cpu_model = build("cpu", seed)[1]
        graphs = first["graphs"]
        hooks = feed_adjacency(cpu_model, graphs, "cpu")
        batch = replace(first["batch"], edges=graphs[0][0],
                        edge_mask=graphs[0][1])
        cpu = run_steps(torch, Trainer(cpu_model), [batch])
        for h in hooks:
            h.remove()
    finally:
        layers.FUSE_CONV_KNN = fused
    grad_err, grad_abs, failed = {}, {}, []
    for name, gc in cpu["grads1"].items():
        e = float((first["grads"][name] - gc).abs().max())
        scale = float(gc.abs().max())
        grad_err[name] = e / scale if scale else (0.0 if e == 0 else np.inf)
        grad_abs[name] = (e, scale)
        if not e <= 1e-3 * scale:
            failed.append(name)
    loss_err = abs(first["loss"] - cpu["loss"][0]) / abs(cpu["loss"][0])
    if failed or not loss_err <= 1e-3:
        os.makedirs(evidence, exist_ok=True)
        stem = os.path.join(evidence, f"train_sqlite_seed{seed}")
        torch.save({"seed": seed, "batch": first["batch"],
                    "graphs": first["graphs"], "loss_card": first["loss"],
                    "loss_cpu": cpu["loss"][0], "grads_card": first["grads"],
                    "grads_cpu": cpu["grads1"]}, stem + ".pt")
        with open(stem + ".json", "w") as f:
            json.dump({"seed": seed, "loss_rel_err": loss_err,
                       "failed": failed, "grad_rel_err": grad_err,
                       "grad_abs_err_and_max": grad_abs}, f, indent=1)
    assert loss_err <= 1e-3, (
        f"step-1 loss with the card's adjacency: {first['loss']} vs "
        f"{cpu['loss'][0]} (seed {seed})")
    for name in failed:
        e, scale = grad_abs[name]
        raise AssertionError(f"step-1 gradient of {name}: {e} vs max {scale} "
                             f"(seed {seed}; evidence in {evidence})")
    pred = trainer.predict(val_loader)[0]
    assert pred.shape == (len(datamodule.val_dataset), 1), pred.shape
    assert np.isfinite(pred).all()
    return {
        "shuffle_seed": seed,
        "events": {"train": len(datamodule.train_dataset),
                   "val": len(datamodule.val_dataset)},
        "batch_size": train_loader.batch_size, "buckets": train_loader.buckets,
        "padding_efficiency": train_loader.padding_efficiency,
        "steps": len(steps), "epochs": epochs,
        "batch_shapes_step1": list(first["batch"].x.shape),
        "losses_card": [s["loss"] for s in steps],
        "step1_loss_cpu_card_adjacency": cpu["loss"][0],
        "launches_per_step": rose,
        "every_grad_finite": True,
        "steps_all_grads_nonzero": sum(not s["zero"] for s in steps),
        "steps_head_saturated_all_grads_zero": sum(bool(s["zero"]) for s in steps),
        "head_min_max_per_step": [s["head_min_max"] for s in steps],
        "max_grad_rel_err_step1_card_adjacency": max(grad_err.values()),
        "worst_grad_param": max(grad_err, key=grad_err.get),
        "fit_history": history,
        "val_predictions_finite": True,
    }, launches


def sqlite_example(device, seed):
    """The training example's datamodule and full-width DynEdge (batch
    16, ``graphnet_tpu_torch.examples.train_dynedge``) on ``device``, its
    train loader shuffled with ``seed``."""
    from graphnet_tpu_torch.examples import train_dynedge

    return train_dynedge.build(train_dynedge.parse_args(
        ["--device", str(device), "--batch-size", "16", "--seed", str(seed)]))


def curated_example(device, seed):
    """The curated ``TestDataset`` over the bundled SQLite database
    (``KNNGraph(Prometheus())``, batches of 16, the train loader
    shuffled with ``seed``) and the training example's full-width
    DynEdge on ``device``."""
    from graphnet_tpu_torch.datasets.test_dataset import TestDataset
    from graphnet_tpu_torch.models.detector.prometheus import Prometheus
    from graphnet_tpu_torch.models.graphs import KNNGraph

    datamodule = TestDataset(
        KNNGraph(detector=Prometheus()), backend="sqlite",
        train_dataloader_kwargs={"batch_size": 16, "seed": seed},
        validation_dataloader_kwargs={"batch_size": 16})
    return datamodule, sqlite_example(device, seed)[1]


def host_imports():
    """Whether pandas, pyarrow and h5py import on this host (the file
    conversion needs them; training from SQLite does not)."""
    found = {}
    for mod in ("pandas", "pyarrow", "h5py"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    return found


def shuffle_seed():
    """A new shuffle seed for train_sqlite each run, printed on its phase
    line, so that the batches of a run can be drawn again
    (``tools/train_sqlite_seeds.py --seeds``)."""
    return int.from_bytes(os.urandom(4), "little") >> 1


def fused_knn_times(torch, ops, rng, dev, peaks, B=128, L=128, H1=336,
                    H2=256):
    """Row 4 alone against row 2, then row 1 on the view ``out[..., :3]``
    (the unfused route; also that kNN call alone, ``call_costs``), and
    its plain version, at B=128, L=128, H1=336, with its bound: row 2's
    operations plus ~10 per valid pair of the kNN, or every input read
    and output written once."""
    x, m = ragged_coords(torch, rng, B, L, 65, dev)
    idx, em = ops["knn"](x, m, K)
    n = m.sum(1).double()
    flops = (float(em.sum()) * (2.0 * H1 * H2 + 2 * H1 + 3 * H2)
             + 10.0 * float((n * n).sum()))
    g = torch.Generator(device=dev).manual_seed(4)
    times = {}
    for key, dtype, rate in (("edgeconv_knn", torch.float32, peaks["fp32"]),
                             ("edgeconv_knn_bf16", torch.bfloat16, peaks["bf16"])):
        a = torch.randn(B, L, H1, device=dev, generator=g).to(dtype)
        b = torch.randn(B, L, H1, device=dev, generator=g).to(dtype)
        w2 = (torch.randn(H1, H2, device=dev, generator=g) / H1 ** 0.5).to(dtype)
        b2 = torch.zeros(H2, device=dev, dtype=dtype)
        el = a.element_size()
        nbytes = (2 * B * L * H1 * el + B * L * K * 5 + B * L + (H1 + 1) * H2 * el
                  + B * L * H2 * 4 + B * L * K * 5)
        t_b, t_o = nbytes / peaks["bytes"], flops / rate

        def unfused():
            out = ops["edgeconv"](a, b, idx, em, w2, b2)
            return ops["knn"](out[..., :3], m, K)

        fused = cuda_ms(torch, lambda: ops["edgeconv_knn"](a, b, idx, em, m, w2, b2))
        out = ops["edgeconv"](a, b, idx, em, w2, b2)
        times[key + "_unfused_knn_of_out_view"] = call_costs(
            torch, lambda: ops["knn"](out[..., :3], m, K), "knn_kernel")
        times[key] = dict(
            ms=fused,
            device_ms=kernel_device_ms(
                torch, lambda: ops["edgeconv_knn"](a, b, idx, em, m, w2, b2),
                "edgeconv_knn"),
            unfused_ms=cuda_ms(torch, unfused),
            ms_again=cuda_ms(torch, lambda: ops["edgeconv_knn"](
                a, b, idx, em, m, w2, b2)),
            plain_ms=cuda_ms(torch, lambda: ops["edgeconv_knn_plain"](
                a, b, idx, em, m, w2, b2)),
            bound_ms=max(t_b, t_o) * 1e3,
            bound_by="bytes" if t_b >= t_o else "operations",
        )
    return times


def switch_times(torch, layers, fn, timer):
    """``timer(fn)`` with the fused EdgeConv + kNN off, on, on, off."""
    out = {}
    for i, on in enumerate((False, True, True, False)):
        layers.FUSE_CONV_KNN = on
        out[f"{i}_{'on' if on else 'off'}"] = timer(fn)
    layers.FUSE_CONV_KNN = False
    return out


def dynedge_switch_times(torch, layers, gpu, gpu16, serving, single, trainer,
                         trainer16, batch):
    """The DynEdge path with ``FUSE_CONV_KNN`` off, on, on, off: a
    training step's ms (CUDA events; fp32, bf16) on ``batch``, serving
    ``serving`` (host ms; fp32, bf16) and the single event ``single``
    (host p50 ms, fp32)."""
    def step(t):
        return switch_times(torch, layers, lambda: t.train_step(batch),
                            lambda f: cuda_ms(torch, f, runs=20))

    def host(fn, runs=25):
        return switch_times(torch, layers, fn, lambda f: 1e3 * host_s(f, runs=runs))

    return {
        "train_step_ms_fp32_B128_L128": step(trainer),
        "train_step_ms_bf16_B128_L128": step(trainer16),
        "serving_ms_fp32_B128_L128": host(lambda: gpu(serving)),
        "serving_ms_bf16_B128_L128": host(lambda: gpu16(serving)),
        "single_event_p50_ms": host(lambda: gpu(single), runs=41),
    }


def bwd_times(torch, ops, rng, dev, peaks, B=128, L=128,
              shapes=((128, 256), (336, 256)), queso=False):
    """Phase 8b: the backward kernel and its plain version at the
    training shape (``queso``: lengths by the QUESO training cell's law),
    with its bound: 3 products of 2*E*H1*H2 flops over the E valid edges,
    against every input read and output written once; the device time of
    a call (``torch.profiler``, every launch of the call); at H1=336
    also each launch's device time over one call."""
    coords = queso_coords if queso else (
        lambda torch, rng, B, L, dev: ragged_coords(torch, rng, B, L, 65, dev))
    x, m = coords(torch, rng, B, L, dev)
    idx, em = ops["knn"](x, m, K)
    n_edges = float(em.sum())
    gen = torch.Generator(device=dev).manual_seed(2)
    times = {}
    for h1, h2 in shapes:
        for dtype, rate in ((torch.float32, peaks["fp32"]),
                            (torch.bfloat16, peaks["bf16"])):
            a = torch.randn(B, L, h1, device=dev, generator=gen).to(dtype)
            b = torch.randn(B, L, h1, device=dev, generator=gen).to(dtype)
            w2 = (torch.randn(h1, h2, device=dev, generator=gen) / h1 ** 0.5).to(dtype)
            b2 = torch.zeros(h2, device=dev, dtype=dtype)
            g = torch.randn(B, L, h2, device=dev, generator=gen)
            el = a.element_size()
            nbytes = (2 * B * L * h1 * el + B * L * K * 5 + (h1 + 1) * h2 * el
                      + B * L * h2 * 4 + 2 * B * L * h1 * 4 + (h1 + 1) * h2 * 4)
            flops = n_edges * 3 * 2.0 * h1 * h2
            t_b, t_o = nbytes / peaks["bytes"], flops / rate
            args = (a, b, idx, em, w2, b2, g)
            key = f"H1_{h1}_{str(dtype).replace('torch.', '')}"
            times[key] = dict(
                ms=cuda_ms(torch, lambda: ops["edgeconv_bwd"](*args)),
                device_ms=device_profile(
                    torch, lambda: ops["edgeconv_bwd"](*args),
                    calls=5)["device_ms"] / 5,
                plain_ms=cuda_ms(torch, lambda: ops["edgeconv_bwd_plain"](*args)),
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
            )
            if h1 == 336:  # device time of each of the call's launches
                times[f"launches_one_call_{key}"] = device_profile(
                    torch, lambda: ops["edgeconv_bwd"](*args), calls=1)["top"]
    return times


def train_times(torch, trainer, batch, runs=20):
    """Phase 8c: one training step on a batch already on the card: ms
    (CUDA events around the step, median of ``runs`` after warm-up),
    events/s, and the peak device memory of a step."""
    ms = cuda_ms(torch, lambda: trainer.train_step(batch), runs=runs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return {"step_ms": ms, "events_per_s": batch.batch_size / ms * 1e3,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "allocated_before_step_mb": before / 2 ** 20}


def profiled_rows(torch, fn, calls, attempts=3):
    """``([(device ms, name, count)], wall ms)``: the device activities
    over ``calls`` calls of ``fn`` by ``torch.profiler``, longest first,
    and the calls' wall time.  On the H100 (PyTorch 2.11) a session now
    and then records no device activity at all; such a session is run
    again, up to ``attempts`` sessions."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for ev in prof.key_averages():
            # a user annotation (the optimizer's "Optimizer.step#...")
            # spans kernels that are rows of their own
            if ("CUDA" not in str(getattr(ev, "device_type", ""))
                    or getattr(ev, "is_user_annotation", False)):
                continue
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            rows.append((us / 1e3, ev.key, ev.count))
        if rows:
            break
    return sorted(rows, reverse=True), wall_ms


def device_profile(torch, fn, calls=5):
    """Phase 8d: device time by kernel over ``calls`` calls of ``fn``,
    and the share of the wall time the device was idle."""
    rows, wall_ms = profiled_rows(torch, fn, calls)
    device_ms = sum(r[0] for r in rows)
    return {
        "calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": [{"kernel": k[:100], "ms": t, "count": c}
                for t, k, c in rows[:12]],
    }


def kernel_device_ms(torch, fn, match, calls=10):
    """Device time of one launch of the kernel whose name holds ``match``
    (``torch.profiler`` over ``calls`` calls of ``fn``): the kernel alone,
    without the wrapper's host time that one call between CUDA events
    also holds."""
    top = device_profile(torch, fn, calls=calls)["top"]
    return sum(r["ms"] for r in top if match in r["kernel"]) / calls


# ----------------------------------------------------------- flash, TITO


def _key_mask(torch, rng, B, L, dev):
    """A key mask ``[B, L]``: event 0 with no valid key, event 1 with
    one, the others ragged lengths in [L/2, L]."""
    n = torch.from_numpy(rng.integers(L // 2, L + 1, B)).to(dev)
    n[0], n[1] = 0, 1
    return torch.arange(L, device=dev)[None, :] < n[:, None]


def flash_cases(torch, rng, dev):
    """``(label, make, mask)`` for the flash phases, ``make(dtype)`` the
    kernels' arguments ``(q, k, v, mask, scale)`` in ``dtype``: head dims
    16, 32 and 64 at L = 128, 1000 (ragged) and 1024 with ``_key_mask``'s
    events (Dh=32, L=1024 is TITO's shape, B=8, H=8; Dh=16, L=1024
    RNN_TITO's, B=8, H=16), and at the lengths
    that fall at the kernels' 64-row tile edges, 1, 63, 64, 65 and 129
    (at L = 1 no event has more than one key); then the shapes
    of the DeepIce path (B=16, H=12, Dh=32): its unbiased
    ``AttentionRel`` blocks at L = 768 (training) and 1024 (the serving
    bucket), q scaled by Dh^-0.5 and scale 1 as they pass it, and its
    ``Block`` s at L = 769 and 1025 (one row in the last tile) at the
    default scale, with the cls key valid in every event: there event 0
    (no pulse) has the cls key alone and event 1 two keys; and the
    ``B_d64`` path's (Dh=64) at L = 768 and 769 alike."""
    cases = []

    def add(label, q, k, v, mask, scale=None):
        def make(dtype):
            return (*(t.to(dtype) for t in (q, k, v)), mask, scale)
        cases.append((label, make, mask))

    at_1024 = {TITO_DH: TITO_HEADS, RNN_TITO_DH: RNN_TITO_HEADS}
    for dh in (16, 32, 64):
        for L in (1, 63, 64, 65, 129, 128, 1000, 1024):
            B, H = ((TITO_B, at_1024[dh]) if L == TITO_L and dh in at_1024
                    else (4, 4))
            gen = torch.Generator(device=dev).manual_seed(dh * 10000 + L)
            q, k, v = (torch.randn(B, H, L, dh, device=dev, generator=gen)
                       for _ in range(3))
            add(f"Dh{dh}_L{L}_B{B}_H{H}", q, k, v,
                _key_mask(torch, rng, B, L, dev))
    for L, dh in ((ICE_L, ICE_HD), (ICE_SERVE_L, ICE_HD), (ICE_L, 64)):
        for cls in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(
                L + cls + (0 if dh == ICE_HD else dh))
            q, k, v = (torch.randn(ICE_B, ICE_HEADS, L + cls, dh,
                                   device=dev, generator=gen)
                       for _ in range(3))
            mask = _key_mask(torch, rng, ICE_B, L, dev)
            label = f"Dh{dh}_L{L + cls}_B{ICE_B}_H{ICE_HEADS}"
            if cls:
                mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
                add(label + "_Block", q, k, v, mask)
            else:
                add(label + "_AttentionRel", q * dh ** -0.5, k, v, mask, 1.0)
    return cases


def _event_errors(got, exp):
    """Per event (dim 0): (max |got - exp|, max |exp|), fp32 tensors."""
    d = (got.float() - exp.float()).abs().flatten(1).amax(1)
    return d, exp.float().abs().flatten(1).amax(1)


def check_fwd(torch, cases, fwd, plain, names, tol, vi=2):
    """Phase: an attention forward kernel ``fwd`` against its plain
    version ``plain`` on the cases' arguments, each event on its own.
    The outputs (flash: o, lse; rel: o, oe, lse, as ``names``) but lse
    within ``tol`` of the event's max; an event with no valid key has o
    the mean of v (argument ``vi``) over the L keys (the dense formula),
    an event with one key that key's v exactly, on both sides; lse in
    fp32 in both modes, within 1e-4 of max(|lse|, 1) where a key is
    valid and within one fp32 step at 1e5 (-1e5 + log L) where none
    is.  The kernel runs twice and the bits of the two runs are
    compared."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, make, mask in cases:
        n_keys = mask.sum(dim=1)
        keyed = n_keys > 0
        first = mask.int().argmax(dim=1)
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            args = make(dtype)
            got, again, exp = fwd(*args), fwd(*args), plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            assert same, f"{label} {key}: two runs gave other bits"
            o, op, lse, lsep = got[0], exp[0], got[-1], exp[-1]
            assert o.dtype == dtype and all(
                t.dtype == torch.float32 for t in got[1:])
            assert all(bool(torch.isfinite(t.float()).all()) for t in got)
            rel = {}
            for name, t, e in zip(names[:-1], got, exp):
                err, scale = _event_errors(t, e)
                r = err / scale
                assert bool((r <= tol[key][0]).all()), (
                    f"{label} {key}: {name} off by {r.tolist()} of each "
                    "event's max")
                rel[name] = r.tolist()
                worst[key] = max(worst[key], float(err.max()))
            v, no_key = args[vi], []
            for b in torch.nonzero(~keyed).flatten().tolist():
                mean_v = v[b].float().mean(dim=1, keepdim=True)
                no_key.append(float((o[b].float() - mean_v).abs().max())
                              / float(op[b].float().abs().max()))
            assert max(no_key, default=0.0) <= tol[key][0], (
                f"{label} {key}: no-key events off the mean of v by {no_key}")
            for b in torch.nonzero(n_keys == 1).flatten().tolist():
                j = int(first[b])
                vb = v[b, :, j:j + 1].expand_as(o[b])
                assert torch.equal(o[b], vb) and torch.equal(op[b], vb), (
                    f"{label} {key}: event {b}'s o is not its one key's v")
            lerr, lscale = _event_errors(lse[keyed], lsep[keyed])
            lrel = float((lerr / lscale.clamp_min(1.0)).max())
            assert lrel <= 1e-4, f"{label} {key}: lse off by {lrel}"
            d = (lse[~keyed] - lsep[~keyed]).abs()
            merr = float(d.max()) if d.numel() else 0.0
            assert merr <= float(np.spacing(np.float32(1e5))), merr
            report.append({
                "case": label, "dtype": key, "rel_to_event_max": rel,
                "no_key_o_rel_to_mean_v": no_key,
                "o_differing_share": float((o != op).float().mean()),
                "lse_rel_err": lrel, "lse_fully_masked_max_abs_err": merr,
                "same_bits_twice": same})
    return worst, report


def check_bwd(torch, cases, io, names, tol, scale_of=()):
    """Phase: an attention backward's kernels against its plain version,
    each event on its own.  ``io(args)`` gives the kernels' call, the
    plain gradients (``names``) before their last rounding (fp32), both
    from the plain forward and random output gradients, and the dtypes
    the plain version returns them in, which the kernels' must have.
    The errors are taken against the unrounded gradients: against the
    plain version's bf16 ones a last rounding that falls the other way
    alone (two sums of another order on either side of a rounding point)
    is one bf16 step of the element, up to 2^-7 (7.8e-3) of an event's
    max, above the bf16 limit (seen: 1/199 of the max, dk of a two-key
    event of 12 heads of 64 at L = 769).  In the events with two or more
    valid keys each
    gradient lies within ``tol`` of the event's max (``scale_of`` names
    another gradient whose max is the scale: rel's dqb, the gradient of
    a per-row logit offset, is 0 exactly, as the softmax does not see
    the offset, and both sides give rounding noise of sum_j ds, scaled by
    dqt's max, the same ds summed against the O(1) embedding), and in
    bf16 no more than ``FLASH_BWD_DIFFERING`` of the elements of each
    gradient in q's dtype differ at all.  An event with no valid key
    passes no gradient through the logits: every gradient but dv exactly
    0, dv (p = 1/L at every key) within the limit.  In an event with one
    key every query puts p = 1 on it, and the gradients but dv are
    rounding noise (ds = dp - delta), held to the limit of the other
    events' max (at L = 1, where no event has two keys, of the one-key
    events' dv max).  dv is 0 exactly at the masked keys of every event with
    a valid key.  The kernels run twice and the bits of the two runs are
    compared."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, make, mask in cases:
        n_keys = mask.sum(dim=1)
        multi, keyed, one = n_keys >= 2, n_keys > 0, n_keys == 1
        dead = ~mask & keyed[:, None]
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            kernel, exp, dtypes = io(make(dtype))
            got, again = kernel(), kernel()
            by_name = dict(zip(names, exp))
            rel, noise, share = {}, {}, {}
            for name, t, e, want in zip(names, got, exp, dtypes):
                assert t.dtype == want and bool(torch.isfinite(t.float()).all())
                err, scale = _event_errors(t, e)
                if name in scale_of:
                    s = by_name[dict(scale_of)[name]]
                    scale = _event_errors(s, s)[1]
                r = err / scale.clamp_min(1e-30)
                if name == "dv":
                    assert bool((r <= tol[key][1]).all()), (
                        f"{label} {key}: dv off by {r.tolist()} of each "
                        "event's max")
                    assert not bool(t.transpose(1, 2)[dead].any()), (
                        f"{label} {key}: dv of a masked key")
                else:
                    assert bool((r[multi] <= tol[key][1]).all()), (
                        f"{label} {key}: {name} off by {r.tolist()} of each "
                        "event's max")
                    assert not bool(t[~keyed].any()), (
                        f"{label} {key}: {name} of a no-key event is not 0")
                    if bool(one.any()):
                        # at L = 1 no event has two keys: the noise is then
                        # held against the one-key events' dv (p = 1, so
                        # dv is g there)
                        ref = (scale[multi].max() if bool(multi.any()) else
                               by_name["dv"][one].float().abs().max())
                        noise[name] = float(err[one].max() / ref)
                        assert noise[name] <= tol[key][1], (
                            f"{label} {key}: {name} of a one-key event off "
                            f"by {noise[name]} of the other events' max")
                rel[name] = r.tolist()
                if t.dtype == dtype and bool(multi.any()):
                    share[name] = float(
                        (t[multi] != e[multi].to(dtype)).float().mean())
                    assert (dtype == torch.float32
                            or share[name] <= FLASH_BWD_DIFFERING), (
                        f"{label} {key}: {share[name]} of {name} differs "
                        "from the plain version")
                worst[key] = max(worst[key], float(err.max()))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            assert same, f"{label} {key}: two runs gave other bits"
            report.append({"case": label, "dtype": key,
                           "rel_err_to_event_max": rel,
                           "one_key_rel_to_others_max": noise,
                           "differing_share_multi_key": share,
                           "same_bits_twice": same})
    return worst, report


def flash_bwd_io(torch, fa):
    """``check_bwd``'s ``io`` for the flash dq and dkv kernels: from the
    plain forward's o and lse and a random output gradient."""

    def io(args):
        q, k, v, mask, scale = args
        o, lse = fa.flash_attention_plain(*args)
        gen = torch.Generator(device=q.device).manual_seed(q.shape[2])
        g = torch.randn(o.shape, device=q.device, generator=gen).to(q.dtype)
        full = (q, k, v, mask, lse, g, fa.attention_delta(g, o), scale)

        def kernel():
            return (fa.flash_attention_bwd_dq(*full),
                    *fa.flash_attention_bwd_dkv(*full))

        return kernel, fa.flash_attention_bwd_plain(
            q, k, v, mask, o, lse, g, scale,
            out_dtype=torch.float32), (q.dtype,) * 3

    return io


def tito_jax_layout_tree(rng, blocks=4, width=256, ff=2048, post=(336, 256),
                         readout=(256, 128)):
    """The full-width DynEdgeTITO + direction head parameter tree in the
    JAX package's layout (the defaults of ``DynEdgeTITO(nb_inputs=4)``),
    random weights: dense kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    layer norm scales 1 + N(0, 0.1^2)."""

    def dense(din, dout, bias=True):
        d = {"kernel": rng.standard_normal((din, dout)) / np.sqrt(din)}
        if bias:
            d["bias"] = rng.standard_normal(dout) * 0.1
        return d

    def norm(d):
        return {"scale": 1.0 + rng.standard_normal(d) * 0.1,
                "bias": rng.standard_normal(d) * 0.1}

    backbone, d = {}, NB_INPUTS
    for i in range(blocks):
        backbone[f"conv_{i}"] = {
            "conv": {
                "self_dense": dense(d, width),
                "nbr_dense": dense(d, width, bias=False),
                "out_kernel": rng.standard_normal((width, width)) / np.sqrt(width),
                "out_bias": rng.standard_normal(width) * 0.1,
            },
            "norm1": norm(width),
            "transformer": {
                "mha": {"qkv": dense(width, 3 * width), "out": dense(width, width)},
                "norm1": norm(width),
                "linear1": dense(width, ff),
                "linear2": dense(ff, width),
                "norm2": norm(width),
            },
        }
        d = width
    backbone["post_processing"] = {}
    for j, h in enumerate(post):
        backbone["post_processing"][f"dense_{j}"] = dense(d, h)
        d = h
    d += NB_INPUTS + min(4, NB_INPUTS) + 1  # max pooling + global variables
    backbone["readout"] = {}
    for j, h in enumerate(readout):
        backbone["readout"][f"dense_{j}"] = dense(d, h)
        d = h
    tree = {"params": {"backbone": backbone, "tasks_0": {"affine": dense(d, 3)}}}

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return np.asarray(t, dtype=np.float32)

    return f32(tree)


def tito_events(rng, lengths):
    """Event arrays by the JAX bench's TITO recipe (``bench.py:261-270``):
    x, y, z from N(0, 2^2), a uniform fourth feature."""
    return [np.concatenate(
        [rng.standard_normal((int(n), 3)).astype(np.float32) * 2.0,
         rng.random((int(n), 1)).astype(np.float32)], axis=1) for n in lengths]


def unit_vectors(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def input_graph_flips(torch, ops, x, mask, dev):
    """Per event, whether TITO's input graph (kNN over x, y, z, t) differs
    between the card's kernel and the plain version on the CPU; and the
    count of differing edges."""
    ik, mk = ops["knn"](x[..., :4].to(dev), mask.to(dev), K)
    ip, mp = ops["knn_plain"](x[..., :4].cpu(), mask.cpu(), K)
    diff = ((ik.cpu() != ip) & mp) | (mk.cpu() != mp)
    return diff.flatten(1).any(1).numpy(), int(diff.sum())


def serve_direction(torch, gpu, cpu, requests, counters, expect, tol=1e-3,
                    held=None, flips=None):
    """Phase: direction serving (TITO, DeepIce).  Every request goes
    through ``gpu`` with ``expect`` launches per forward; then its held
    events (``held``: request label -> indices; default every event) go
    through ``cpu``, the same model on the CPU (the plain versions), as
    one request.  The unit direction's components agree within ``tol``
    (of the vector's norm, 1) and kappa within rtol ``tol``, except for
    events that ``flips(events)`` (per event, whether the input graph
    differs between card and CPU) explains."""
    answers, launches = answer(gpu, requests, counters, expect)
    report = []
    for label, evs in requests.items():
        got = answers[label]
        empty = np.array([e.n_pulses == 0 for e in evs])
        assert got.shape == (len(evs), 4)
        assert np.isnan(got[empty]).all() and np.isfinite(got[~empty]).all()
        idx = np.arange(len(evs)) if held is None else np.asarray(held[label])
        kept = idx[~empty[idx]]
        sub = [evs[i] for i in kept]
        ref = cpu(sub)
        d_dir = np.abs(got[kept, :3] - ref[:, :3]).max(axis=1)
        d_kappa = np.abs(got[kept, 3] - ref[:, 3]) / np.abs(ref[:, 3])
        beyond = (d_dir > tol) | (d_kappa > tol)
        flipped = np.zeros(len(kept), bool) if flips is None else flips(sub)
        unexplained = np.flatnonzero(beyond & ~flipped)
        assert unexplained.size == 0, (
            f"{label}: events {kept[unexplained].tolist()} differ from the "
            f"CPU beyond {tol} with no kNN flip")
        report.append({
            "request": label, "events": len(evs),
            "held_events": kept.tolist(), f"events_beyond_{tol}": int(beyond.sum()),
            "events_with_input_knn_flips": int(flipped.sum()),
            "max_dir_abs_err": float(d_dir.max()),
            "max_kappa_rel_err": float(d_kappa.max()),
        })
    return launches, report


def mask_ambiguous(torch, model, masks, record, rel=1e-5):
    """Hooks that zero, the same entries on both devices, the output
    gradient wherever TITO's backward is discontinuous within rounding
    (two right implementations may then differ by a whole entry): the
    pre-activation of each (leaky) relu within ``rel`` of its layer's
    max from 0 (the feed-forward's, and the post-processing and readout
    layers'); each EdgeConv's (node,
    channel) whose top two edges or second gate lie within ``rel``
    (``zero_ambiguous``), and each node with a first-layer pre-activation
    ``a_i + b_j`` within ``rel`` of 0; the max pooling's (event, channel)
    whose top two nodes lie within ``rel``.  With ``record`` the masks
    come from this model's forward and are appended to ``masks``; else
    the recorded ones are applied in order.  Returns the hooks."""
    from graphnet_tpu_torch.ops.gather_reduce import gather_neighbors

    bb = model.backbone
    calls, node_mask = [0], [None]

    def apply(out, make_keep):
        i = calls[0]
        calls[0] += 1
        if record:
            with torch.no_grad():
                masks.append(make_keep())
        keep = masks[i].to(out.device, out.dtype)
        out.register_hook(lambda g: g * keep)

    def gate_hook(mod, args, out):  # a dense layer's output
        apply(out, lambda: (out.abs() > rel * out.abs().max()).float())

    def relu_hook(mod, args, out):  # a relu module's input
        pre = args[0]
        apply(out, lambda: (pre.abs() > rel * pre.abs().max()).float())

    def conv_hook(mod, args, out):
        def keep():
            x, idx, em = args
            a, b = mod.linear_terms(x)
            z = a[:, :, None, :] + gather_neighbors(b, idx)
            near0 = ((z.abs() <= rel * z.abs().max()) & em[..., None]).any(dim=(2, 3))
            kept = zero_ambiguous(torch, a, b, idx, em,
                                  mod.out_kernel.to(a.dtype),
                                  mod.out_bias.to(a.dtype), torch.ones_like(out),
                                  "max", 0.01, rel)[0]
            return torch.where(near0[..., None], 0.0, kept)
        apply(out, keep)

    def pool_hook(mod, args, out):
        def keep():
            m = node_mask[0][..., None]
            top = torch.where(m, out, -1e30).topk(2, dim=1).values
            thr = rel * float(out.abs().max())
            amb = (top[:, 0] - top[:, 1] <= thr) & (top[:, 1] > -1e29)
            return (~amb).float()[:, None, :]
        apply(out, keep)

    def grab_mask(mod, args):
        node_mask[0] = args[0].mask

    handles = [bb.register_forward_pre_hook(grab_mask)]
    for i in range(bb.n_convs):
        block = getattr(bb, f"conv_{i}")
        handles.append(block.conv.register_forward_hook(conv_hook))
        handles.append(
            block.transformer.activation.register_forward_hook(relu_hook))
    for mlp in (bb.post_processing, bb.readout):
        for j in range(len(mlp.sizes)):
            handles.append(getattr(mlp, f"dense_{j}").register_forward_hook(gate_hook))
    handles.append(bb.post_processing.register_forward_hook(pool_hook))
    return handles


def _grad_errors(a, b, norm):
    """Per parameter, the step-1 gradient of run ``a`` against run ``b``:
    the error's max over the max (``norm="max"``) or its norm over the
    norm (``"l2"``)."""
    out = {}
    for n, g in b["grads1"].items():
        d = a["grads1"][n] - g
        if norm == "max":
            e, s = float(d.abs().max()), float(g.abs().max())
        else:
            e, s = float(d.norm()), float(g.norm())
        out[n] = e / s if s else (0.0 if e == 0 else float("inf"))
    return out


def train_direction(torch, make, Trainer, batch, counters, expect, dev,
                    dtype=None, steps=3, cpu_steps=3, loss_rtol=1e-3,
                    grad_tol=1e-3, grad_norm="max", held=None, ops=None,
                    rel=1e-5):
    """Phase: direction training (TITO, DeepIce) in ``dtype`` on the
    card: ``steps`` steps on ``batch`` with ``expect`` launches each,
    every gradient finite and non-zero.  Then held against the same
    model on the CPU on ``held``, a few of the events (default the whole
    batch): the losses of the first ``cpu_steps`` steps within
    ``loss_rtol``, and the step-1 gradients within ``grad_tol`` of each
    parameter's max (``grad_norm="max"``) or of its norm (``"l2"``, the
    error's norm).  With ``ops`` (TITO: the kNN kernel and its plain
    version) the step-1 gradients come from one more step on each device
    with the output gradient zeroed where the backward is discontinuous
    within ``rel`` (``mask_ambiguous``: the relu gates, the max
    aggregation and the max pooling, where card and CPU may decide
    otherwise), and when the card's input graph differs from the CPU's
    the comparison feeds the CPU's graph through ``batch.edges`` (TITO's
    graph is static).  DeepIce has no max and no relu gate: nothing is
    masked."""
    for c in counters:
        c.launches = 0
    gpu = run_steps(torch, Trainer(make(dev, dtype)), [batch.to(dev)] * steps,
                    counters)
    launches = [c.launches for c in counters]
    assert all(r == expect for r in gpu["rose"]), gpu["rose"]
    assert not any(gpu["nonfinite"]) and not any(gpu["zero"]), (
        gpu["nonfinite"], gpu["zero"])
    ref = batch if held is None else held
    on_card = ref.to(dev)
    cpu = run_steps(torch, Trainer(make("cpu", dtype)), [ref] * cpu_steps)
    flips = 0
    if ops is not None:
        _, flips = input_graph_flips(torch, ops, ref.x, ref.mask, dev)
    if flips:
        ip, mp = ops["knn_plain"](ref.x[..., :4], ref.mask, K)
        on_card = replace(on_card, edges=ip.to(dev), edge_mask=mp.to(dev))
    card = gpu if held is None and not flips else run_steps(
        torch, Trainer(make(dev, dtype)), [on_card] * cpu_steps)
    np.testing.assert_allclose(card["loss"][:cpu_steps], cpu["loss"],
                               rtol=loss_rtol,
                               err_msg="losses, card against CPU")
    raw = _grad_errors(card, cpu, grad_norm)
    masks, runs = [], {"cpu": cpu, dev: card}
    if ops is not None:
        for device, step_batch in (("cpu", ref), (dev, on_card)):
            model = make(device, dtype)
            handles = mask_ambiguous(torch, model, masks, device == "cpu", rel)
            runs[device] = run_steps(torch, Trainer(model), [step_batch])
            for h in handles:
                h.remove()
    masked = _grad_errors(runs[dev], runs["cpu"], grad_norm)
    other = _grad_errors(runs[dev], runs["cpu"],
                         "l2" if grad_norm == "max" else "max")
    worst = max(masked, key=masked.get)
    assert masked[worst] <= grad_tol, (
        f"step-1 gradients beyond {grad_tol} ({grad_norm}): "
        f"{ {n: e for n, e in masked.items() if e > grad_tol} }")
    return gpu, {
        "steps": steps, "B": batch.batch_size, "L": batch.max_length,
        "losses_card": gpu["loss"], "held_B": ref.batch_size,
        "held_losses_card": card["loss"][:cpu_steps],
        "held_losses_cpu": cpu["loss"],
        "max_loss_rel_err": float(np.max(np.abs(
            np.subtract(card["loss"][:cpu_steps], cpu["loss"]))
            / np.abs(cpu["loss"]))),
        "input_knn_flips": flips, "cpu_graph_fed": bool(flips),
        "launches_per_step": gpu["rose"],
        "every_grad_finite_nonzero": True,
        "n_params": len(masked), "ambiguity_rel": rel if ops else None,
        "ambiguous_entries_zeroed": int(sum(int((m == 0).sum()) for m in masks)),
        "entries_masked_over": int(sum(m.numel() for m in masks)),
        "grad_norm": grad_norm,
        "max_grad_rel_err_step1": masked[worst], "worst_grad_param": worst,
        "max_grad_rel_err_step1_other_norm": max(other.values()),
        "worst_grad_param_other_norm": max(other, key=other.get),
        "grad_rel_err_step1_unmasked": raw if ops else None,
    }, launches


def flash_shapes():
    """``(key, B, H, L, Dh, masked)`` of ``flash_times``: TITO's B=8, H=8,
    Dh=32 at L = 128, 512 and 1024 with every key valid (keys ``L{L}``);
    the DeepIce path's B=16, H=12, Dh=32 at L = 768 (training) and 769
    (its ``Block`` s, one row in the last tile) with ``_key_mask``'s
    ragged events; and Dh=64 at TITO's B, H and L."""
    return ([(f"L{L}", TITO_B, TITO_HEADS, L, TITO_DH, False)
             for L in (128, 512, 1024)]
            + [(f"B{ICE_B}_H{ICE_HEADS}_L{L}_Dh{ICE_HD}", ICE_B, ICE_HEADS, L,
                ICE_HD, True) for L in (ICE_L, ICE_L + 1)]
            + [(f"B{TITO_B}_H{TITO_HEADS}_L{TITO_L}_Dh64", TITO_B, TITO_HEADS,
                TITO_L, 64, False)])


def sdpa_backend_ms(torch, q, k, v, amask):
    """``F.scaled_dot_product_attention``'s forward ms on the same call
    with its efficient and its cuDNN backend forced (None, and the first
    line of the refusal, where a backend does not take the call)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        try:
            with sdpa_kernel(backend):
                out[name] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=amask))
        except RuntimeError as err:
            out[name] = None
            out[f"{name}_refused"] = str(err).strip().splitlines()[0][:200]
    return out


def flash_times(torch, fa, dense_attention, dev, peaks, shapes=None):
    """Phase 8e: the flash kernels, their plain versions, the port's dense
    path and ``F.scaled_dot_product_attention`` (never on the path; an
    additive -1e5 mask, so fully masked rows stay finite) at
    ``flash_shapes()``, with the bounds: forward 4*B*H*L^2*Dh flops, dq 6
    (three products), dkv 8 (four), the whole backward 10 (five
    products), over the dtype's peak, or the bytes of each input read and
    output written once over HBM if larger.  The kernels compute every
    (query, key) pair whatever the mask (a fully masked row takes the
    mean over all L keys), so the flops count all L^2 pairs."""
    import torch.nn.attention
    import torch.nn.functional as F

    choice = getattr(torch, "_fused_sdp_choice", None)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for name, B, H, L, dh, masked in shapes or flash_shapes():
        mask = (_key_mask(torch, rng, B, L, dev) if masked else
                torch.ones(B, L, dtype=torch.bool, device=dev))
        gen = torch.Generator(device=dev).manual_seed(L)
        for dtype, rate in ((torch.float32, peaks["fp32"]),
                            (torch.bfloat16, peaks["bf16"])):
            el = 2 if dtype == torch.bfloat16 else 4
            q, k, v, g = (torch.randn(B, H, L, dh, device=dev, generator=gen)
                          .to(dtype) for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v, mask)
            delta = fa.attention_delta(g, o)
            amask = torch.where(mask, 0.0, -1e5)[:, None, None, :].to(dtype)
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=amask)
            n, row = B * H * L * L * dh, B * H * L * dh * el

            def bound(flops, nbytes):
                t_b, t_o = nbytes / peaks["bytes"], flops / rate
                return dict(bound_ms=max(t_b, t_o) * 1e3,
                            bound_by="bytes" if t_b >= t_o else "operations")

            small = B * L + 2 * B * H * L * 4  # mask, and lse/delta fp32
            key = f"{name}_{str(dtype).replace('torch.', '')}"
            backend = (str(torch.nn.attention.SDPBackend(int(choice(
                q, k, v, amask)))) if choice is not None else "unknown")
            out[key] = {
                "shape": dict(B=B, H=H, L=L, Dh=dh,
                              valid_keys=int(mask.sum())),
                "fwd": dict(
                    ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, mask)),
                    plain_ms=cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, mask)),
                    dense_path_ms=cuda_ms(torch, lambda: dense_attention(q, k, v, mask)),
                    library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=amask)),
                    library_backends_ms=sdpa_backend_ms(torch, q, k, v, amask),
                    **bound(4.0 * n, 4 * row + small)),
                "bwd_dq": dict(
                    ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dq(
                        q, k, v, mask, lse, g, delta)),
                    **bound(6.0 * n, 5 * row + small)),
                "bwd_dkv": dict(
                    ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                        q, k, v, mask, lse, g, delta)),
                    **bound(8.0 * n, 6 * row + small)),
                "bwd_total": dict(
                    plain_ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(
                        q, k, v, mask, o, lse, g)),
                    library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                        o_lib, (qr, kr, vr), g, retain_graph=True)),
                    **bound(10.0 * n, 8 * row + small)),
                "library_fwd_bwd_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qr, kr, vr, attn_mask=amask),
                    (qr, kr, vr), g)),
                "library_backend": backend,
            }
            # the plain backward computes dq, dk and dv in one call
            out[key]["bwd_dq"]["plain_ms"] = out[key]["bwd_total"]["plain_ms"]
            out[key]["bwd_dkv"]["plain_ms"] = out[key]["bwd_total"]["plain_ms"]
            # the kernels' share of the whole backward beside SDPA's
            out[key]["bwd_total"]["ms"] = (out[key]["bwd_dq"]["ms"]
                                           + out[key]["bwd_dkv"]["ms"])
    return out


# ------------------------------------------------ rel attention, DeepIce


def ice_events(rng, lengths):
    """Event arrays by the JAX bench's DeepIce recipe
    (``bench.py:397-408``): x, y, z from N(0, 1), time and charge
    uniform in [0, 1), a 0/1 auxiliary flag."""
    return [np.concatenate(
        [rng.standard_normal((int(n), 3)), rng.random((int(n), 1)),
         rng.random((int(n), 1)), rng.random((int(n), 1)) > 0.5],
        axis=1).astype(np.float32) for n in lengths]


def rel_cases(torch, rng, dev):
    """``(label, make, mask)`` for the rel phases, ``make(dtype)`` the
    core's inputs ``(q, qt, qb, k, v, x0, mask)`` in ``dtype``, with the
    folds ``qt = q @ w``, ``qb = q . b`` in fp32 (the projection
    ``w [e, hd]`` in nn.Linear layout, and ``b``): 12 heads of 32 at
    L = 128, 768 (B=16: DeepIce's shape), 1000 (ragged) and 1024, and 2
    heads of 16 (the kernels' other head dim, one head group) at
    L = 1000; at the dkv kernel's tile edges (32-key blocks, 16-query
    tiles), L = 1, 63, 65 and 129 with 12 heads of 32 and L = 65 with 3
    heads of 16; and at its head groups, one head and the zoo's 24
    (B_d32: two groups in bf16, three in fp32) at L = 200; at the dq
    kernel's 16-query blocks and 16-key tiles, L = 15 (12 heads), 17 (3
    heads), 31 (one head of 16) and 33 (24 heads: two groups in bf16,
    three in fp32); the forward kernel has the dq kernel's 16-query
    blocks and 16-key tiles (so L = 15, 17, 31 and 33 again) and groups
    of at most 12 heads in both dtypes (24 heads: two groups), and two
    cases more: L = 16 (one whole tile, one query block) with 9 heads of
    32 (phase A's second 8-head tile holds one head), and L = 48 (three
    whole tiles) with 13 heads of 16 (two groups of 7 and 6 heads, the
    last group smaller, in every kernel); at head dim 64 (``B_d64``),
    12 heads at L = 768 (B=16) and 1024, the tile edges L = 1, 15, 17,
    33, 63, 65 and 129, and the head groups: 1 head and 24 (L = 200), 4
    (one dkv group), and one head more than a group of each kernel
    holds (``REL_HD64_HEADS``: 5 dkv, 6 dq fp32, 7 dq bf16, 8 forward
    fp32, 11 forward bf16); q scaled by hd^-0.5; ``_key_mask``'s
    events."""
    cases = []
    shapes = ((128, 4, ICE_HEADS, ICE_HD), (ICE_L, ICE_B, ICE_HEADS, ICE_HD),
              (1000, 4, ICE_HEADS, ICE_HD), (1024, 4, ICE_HEADS, ICE_HD),
              (1000, 4, 2, 16),
              (1, 4, ICE_HEADS, ICE_HD), (63, 4, ICE_HEADS, ICE_HD),
              (65, 4, ICE_HEADS, ICE_HD), (129, 4, ICE_HEADS, ICE_HD),
              (65, 4, 3, 16), (200, 4, 1, ICE_HD),
              (200, 4, 2 * ICE_HEADS, ICE_HD),
              (15, 4, ICE_HEADS, ICE_HD), (17, 4, 3, ICE_HD),
              (31, 4, 1, 16), (33, 4, 2 * ICE_HEADS, ICE_HD),
              (16, 4, 9, ICE_HD), (48, 4, 13, 16),
              (ICE_L, ICE_B, ICE_HEADS, 64), (1024, 4, ICE_HEADS, 64),
              *((L, 4, H, 64) for L, H in zip(
                  (1, 15, 17, 33, 63, 65, 129),
                  (ICE_HEADS, *REL_HD64_HEADS, ICE_HEADS))),
              (200, 4, 1, 64), (200, 4, 2 * ICE_HEADS, 64), (48, 4, 4, 64))
    for L, B, H, hd in shapes:
        gen = torch.Generator(device=dev).manual_seed(L + 7 + hd)
        q, k, v = (torch.randn(B, H, L, hd, device=dev, generator=gen)
                   for _ in range(3))
        w = torch.randn(hd, hd, device=dev, generator=gen) / hd ** 0.5
        b = torch.randn(hd, device=dev, generator=gen) * 0.1
        x0 = torch.from_numpy(np.stack(ice_events(rng, [L] * B))).to(dev)
        mask = _key_mask(torch, rng, B, L, dev)

        def make(dtype, q=q * hd ** -0.5, k=k, v=v, w=w, b=b, x0=x0,
                 mask=mask):
            qc, kc, vc = (t.to(dtype) for t in (q, k, v))
            return (qc, qc.float() @ w, qc.float() @ b, kc, vc, x0, mask)

        cases.append((f"L{L}_B{B}_H{H}_hd{hd}", make, mask))
    return cases


def rel_bwd_io(torch, rc, rp):
    """``check_bwd``'s ``io`` for the rel dq and dkv kernels: from the
    plain forward's o, oe and lse and random output gradients."""

    def io(args):
        o, oe, lse = rp.rel_attention_plain(*args)
        gen = torch.Generator(device=o.device).manual_seed(o.shape[2])
        do = torch.randn(o.shape, device=o.device, generator=gen).to(o.dtype)
        doe = torch.randn(oe.shape, device=o.device, generator=gen)
        full = args + (lse, do, doe, rp.rel_attention_delta(do, o, doe, oe))

        def kernel():
            return (*rc.rel_attention_bwd_dq(*full),
                    *rc.rel_attention_bwd_dkv(*full))

        f32 = torch.float32
        return kernel, rp.rel_attention_bwd_plain(*full, out_dtype=f32), (
            o.dtype, f32, f32, o.dtype, o.dtype)

    return io


def ice_jax_layout_tree(rng, model, params_to_jax):
    """The JAX package's parameter tree for ``model`` (a port DeepIce
    model: the layout ``params_to_jax`` writes) with random weights:
    dense kernels N(0, 1/fan_in), biases N(0, 0.1^2), layer norm and
    layer scales 1 + N(0, 0.1^2), the cls token and the aux table
    N(0, 1)."""

    def draw(name, a):
        if name == "kernel":
            return rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
        if name == "bias":
            return rng.standard_normal(a.shape) * 0.1
        if name in ("scale", "gamma_1", "gamma_2"):
            return 1.0 + rng.standard_normal(a.shape) * 0.1
        return rng.standard_normal(a.shape)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else draw(k, v).astype(np.float32) for k, v in t.items()}

    return walk(params_to_jax(model.state_dict()))


def rel_bound(B, H, L, hd, el, peaks, dtype_rate, t_flops, f_flops):
    """The least time of a rel kernel: ``t_flops`` and ``f_flops`` per
    (b, h, i, j) of products in the input dtype (its peak) and in fp32,
    plus hd/2 sin and cos per (b, i, j), counted as one operation each,
    over the fp32 peak; or the bytes of q, k, v (``el`` each), qt and oe
    (fp32), qb, lse, x0, mask and o read or written once, if larger."""
    pairs = float(B) * L * L
    t_o = (pairs * H * t_flops / dtype_rate
           + (pairs * H * f_flops + pairs * hd) / peaks["fp32"])
    nbytes = B * H * L * hd * (4 * el + 2 * 4) + B * H * L * 2 * 4 + B * L * 25
    t_b = nbytes / peaks["bytes"]
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def rel_times(torch, rc, rp, rel_flash_attention, encoder, dense, dev, peaks,
              hd=ICE_HD, shapes=((ICE_L, ICE_B), (1536, ICE_B), (3072, 4))):
    """Phase: the rel kernels and their plain versions at DeepIce's shape
    (B=16, H=12, L=768, head dim ``hd``: 32, and 64 for ``B_d64``;
    full-length events) with their bounds (``rel_bound``: forward 8*hd
    flops per (b, h, i, j), half of them in the input dtype; dq and dkv
    12*hd each), each kernel also by its profiled device time a launch
    (``device_ms``); and the whole biased attention, the folds and the
    forward kernel, beside the port's dense path (``encoder(x0)``
    materialised, then ``dense``) at ``shapes`` (L, B): at hd 32 L = 768,
    1536 (B=16) and 3072 (B=4: at B=16 the dense path's fp32 pair tensor
    alone is 19 GB and its temporaries do not fit)."""
    H = ICE_HEADS
    out = {}
    for L, B in shapes:
        gen = torch.Generator(device=dev).manual_seed(L)
        x0 = torch.from_numpy(np.stack(
            ice_events(np.random.default_rng(L), [L] * B))).to(dev)
        mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            key = f"L{L}_B{B}_{str(dtype).replace('torch.', '')}"
            q, k, v = (torch.randn(B, H, L, hd, device=dev, generator=gen)
                       .to(dtype) for _ in range(3))
            w, b = encoder.projection.weight, encoder.projection.bias
            with torch.no_grad():
                row = {
                    "rel_attention_ms": cuda_ms(torch, lambda: rel_flash_attention(
                        q, k, v, x0, w, b, mask), runs=10),
                    "dense_path_ms": cuda_ms(torch, lambda: dense(
                        q, k, v, mask, encoder(x0).to(dtype)), runs=5, warmup=1),
                }
            if L == ICE_L:
                el = q.element_size()
                rate = peaks["bf16"] if dtype == torch.bfloat16 else peaks["fp32"]
                args = (q, q.float() @ w.detach(), q.float() @ b.detach(),
                        k, v, x0, mask)
                o, oe, lse = rc.rel_attention_fwd(*args)
                do = torch.randn(o.shape, device=dev, generator=gen).to(dtype)
                doe = torch.randn(oe.shape, device=dev, generator=gen)
                full = args + (lse, do, doe, rp.rel_attention_delta(do, o, doe, oe))
                plain_bwd = cuda_ms(torch, lambda: rp.rel_attention_bwd_plain(*full),
                                    runs=5, warmup=1)
                fwd, dq, dkv = (
                    lambda: rc.rel_attention_fwd(*args),
                    lambda: rc.rel_attention_bwd_dq(*full),
                    lambda: rc.rel_attention_bwd_dkv(*full))
                row.update({
                    "fwd": dict(ms=cuda_ms(torch, fwd),
                                device_ms=kernel_device_ms(torch, fwd, "rel_fwd_kernel"),
                                plain_ms=cuda_ms(torch, lambda: rp.rel_attention_plain(
                                    *args), runs=5, warmup=1),
                                **rel_bound(B, H, L, hd, el, peaks, rate, 4 * hd, 4 * hd)),
                    "bwd_dq": dict(ms=cuda_ms(torch, dq),
                                   device_ms=kernel_device_ms(torch, dq, "rel_dq_kernel"),
                                   plain_ms=plain_bwd,
                                   **rel_bound(B, H, L, hd, el, peaks, rate, 6 * hd, 6 * hd)),
                    "bwd_dkv": dict(ms=cuda_ms(torch, dkv),
                                    device_ms=kernel_device_ms(torch, dkv, "rel_dkv_"),
                                    plain_ms=plain_bwd,
                                    **rel_bound(B, H, L, hd, el, peaks, rate, 8 * hd, 4 * hd)),
                })
            if B != ICE_B:
                row["note"] = (f"B={B}: at B={ICE_B} the dense path's fp32 pair "
                               "tensor alone is 19 GB and its temporaries do "
                               "not fit the card")
            out[key] = row
            del q, k, v
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------ serving from files


def chunked_model(device, compute_dtype=None, cache="auto", tree=None):
    """The zoo's B_d32 from its file with ``rel_flash="never"``, its
    biased block in ``CHUNKED_CHUNKS`` query tiles on route ``cache``
    (``rel_bias_cache``), with the JAX-layout ``tree``'s weights."""
    from graphnet_tpu_torch.utils.config import ModelConfig, build
    from graphnet_tpu_torch.utils.jax_params import params_from_jax

    spec = ModelConfig.load(ICE_D32_FILE)
    spec.arguments["backbone"]["__model__"]["arguments"].update(
        compute_dtype=compute_dtype, rel_flash="never",
        rel_bias_chunks=CHUNKED_CHUNKS, rel_bias_cache=cache)
    model = build(spec, seed=SEED, device=device)
    assert not model.backbone.sandwich_0.attn.uses_rel_kernel(ICE_HD)
    if tree is not None:
        model.load_state_dict(params_from_jax(tree, model.state_dict()))
    return model


def set_route(model, route):
    """Switch a :func:`chunked_model` to ``route``: "dense"
    (``rel_bias_chunks`` 1: the pair tensor materialised, one tile), or
    ``CHUNKED_CHUNKS`` tiles on the ``rel_bias_cache`` route "always"
    (cached) or "never" (rebuilt a tile at a time).  Returns it."""
    bb = model.backbone
    bb.rel_bias_chunks = 1 if route == "dense" else CHUNKED_CHUNKS
    for i in range(bb.depth_rel):
        getattr(bb, f"sandwich_{i}").attn.rel_chunks = bb.rel_bias_chunks
    if route != "dense":
        bb.rel_bias_cache = route
    return model


def direction_errors(got, ref):
    """The largest error of the unit direction's components and of
    kappa (relative) over the events."""
    return max(float(np.abs(got[:, :3] - ref[:, :3]).max()),
               float((np.abs(got[:, 3] - ref[:, 3]) / np.abs(ref[:, 3])).max()))


def serve_chunked(torch, module, pkl, requests, held, counters, expect,
                  dtype=None, tol=1e-3):
    """Phase: DeepIce serving on the chunked bias path through ``module``
    (``DeploymentModule``), each route of ``CHUNKED_ROUTES`` with
    ``expect`` launches a forward (counts set to 0 before each route),
    against the dense route on the card on every event and against the
    CPU (the cached route) on the ``held`` events, each within ``tol``
    as in :func:`serve_direction`.  Returns each route's launches and
    the report."""
    gpu = module(chunked_model("cuda", dtype, "always"), pkl)
    cpu = module(chunked_model("cpu", dtype, "always"), pkl, device="cpu")
    ref = {label: cpu([evs[i] for i in held[label]])
           for label, evs in requests.items()}
    del cpu
    set_route(gpu.model, "dense")
    dense, _ = answer(gpu, requests, counters, expect)
    launches, report = {}, []
    for route in CHUNKED_ROUTES:
        set_route(gpu.model, route)
        assert gpu.model.backbone.caches_rel_bias(ICE_B, ICE_SERVE_L) == (
            route == "always")
        answers, launches[route] = answer(gpu, requests, counters, expect)
        for label, evs in requests.items():
            got = answers[label]
            empty = np.array([e.n_pulses == 0 for e in evs])
            assert np.isnan(got[empty]).all() and np.isfinite(got[~empty]).all()
            worst = {"dense": direction_errors(got[~empty], dense[label][~empty]),
                     "cpu": direction_errors(got[held[label]], ref[label])}
            assert max(worst.values()) <= tol, (route, label, worst)
            report.append({"route": route, "request": label,
                           "events": len(evs), "held_events": held[label],
                           "max_err_against_dense_card": worst["dense"],
                           "max_err_against_cpu": worst["cpu"]})
    return launches, report


def train_chunked(torch, Trainer, tree, batch, held, counters, expect, dev,
                  loss_rtol=1e-4, grad_tol=1e-4):
    """Phase: one fp32 training step of DeepIce on the chunked bias path,
    each route of ``CHUNKED_ROUTES`` on ``batch`` with ``expect``
    launches (counts set to 0 before), every gradient finite and
    non-zero; then the step on ``held`` against the dense route on the
    card and against the CPU (the cached route): the loss within
    ``loss_rtol``, each gradient within ``grad_tol`` of its max.  Each
    step starts from ``tree``'s weights."""
    cpu = run_steps(torch, Trainer(chunked_model("cpu", None, "always",
                                                 tree=tree)), [held])
    model = chunked_model(dev, None, "always", tree=tree)
    start = {n: t.clone() for n, t in model.state_dict().items()}

    def step(route, batches, counts=()):
        model.load_state_dict(start)
        return run_steps(torch, Trainer(set_route(model, route)), batches,
                         counts)

    dense = step("dense", [held.to(dev)])
    launches, report = {}, {}
    for route in CHUNKED_ROUTES:
        for c in counters:
            c.launches = 0
        full = step(route, [batch.to(dev)], counters)
        launches[route] = [c.launches for c in counters]
        assert full["rose"] == [expect], full["rose"]
        assert not full["nonfinite"][0] and not full["zero"][0], (
            full["nonfinite"], full["zero"])
        card = step(route, [held.to(dev)])
        row = {"loss_card": full["loss"][0]}
        for against, ref in (("dense_card", dense), ("cpu", cpu)):
            loss_err = abs(card["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
            grads = _grad_errors(card, ref, "max")
            worst = max(grads, key=grads.get)
            assert loss_err <= loss_rtol and grads[worst] <= grad_tol, (
                route, against, loss_err, worst, grads[worst])
            row[f"held_loss_rel_err_{against}"] = loss_err
            row[f"max_grad_rel_err_{against}"] = grads[worst]
            row[f"worst_grad_param_{against}"] = worst
        report[route] = row
    return launches, {"B": batch.batch_size, "L": batch.max_length,
                      "held_B": held.batch_size, "routes": report,
                      "every_grad_finite_nonzero": True}


def chunked_costs(torch, make_batch, Trainer, tree, dev,
                  shapes=CHUNKED_SHAPES, runs=3):
    """Each route's ms (CUDA events, median of ``runs``) and peak memory
    (``torch.cuda.max_memory_allocated`` over one call, and above the
    memory held before it) of a forward under ``no_grad`` and of a
    training step, at each ``(B, L)`` of ``shapes`` in fp32: the dense
    route, and the chunked routes cached and rebuilt.  Also the cached
    pair tensor's bytes."""
    rng = np.random.default_rng(SEED + 30)
    model = chunked_model(dev, None, "always", tree=tree)
    out = {}
    for B, L in shapes:
        arrays = ice_events(rng, [L] * B)
        batch = make_batch(arrays, labels={"direction": unit_vectors(rng, B)},
                           length=L).to(dev)
        row = {"cache_bytes_fp32": B * L * L * ICE_HD * 4}
        for route in ("dense",) + CHUNKED_ROUTES:
            trainer = Trainer(set_route(model, route))

            def serve():
                with torch.no_grad():
                    model(batch)

            for mode, fn in (("serve", serve),
                             ("step", lambda: trainer.train_step(batch))):
                fn()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                row[f"{route}_{mode}"] = {
                    "ms": cuda_ms(torch, fn, runs=runs, warmup=0),
                    "peak_bytes": peak, "peak_above_start_bytes": peak - base}
            del trainer
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        out[f"B{B}_L{L}"] = row
    return out


def calibrate_heads(torch, model, requests, collate_events, peak=2.0):
    """Scale each task head's affine map so that its largest output over
    ``requests`` is ``peak``: with random weights a DynEdge's latents grow
    ~8x a layer (a sum over 8 neighbours), and an unscaled head saturates
    its sigmoid or overflows the QUESO energy head's pow10."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        for task in model.tasks:
            top = max(
                float(task.affine(model.backbone(collate_events(
                    evs, min_pulses=1).to(dev))).abs().max())
                for evs in requests.values())
            task.affine.weight.mul_(peak / top)
            task.affine.bias.mul_(peak / top)


def config_requests(rng, Event, kind, nb_inputs):
    """The requests of a model served from its file: DynEdge (a request
    of 7 events with 0- and 1-pulse ones, and 32 events of 65-128 pulses,
    both at L <= 128 so that FUSE_CONV_KNN engages), TITO (6 events to
    700 pulses) and DeepIce (4 events to 100 pulses: the CPU holds every
    event of a full-width model)."""
    if kind == "DeepIce":
        return {"four_with_empty": [Event(x=a, features=ICE_FEATURES)
                                    for a in ice_events(rng, [0, 1, 60, 100])]}
    if kind == "DynEdgeTITO":
        return {"six_with_empty": [
            Event(x=a, features=FEATURES)
            for a in tito_events(rng, [30, 0, 5, 1, 300, 700])]}
    feats = [f"f{i}" for i in range(nb_inputs)]

    def events(lengths):
        return [Event(x=rng.standard_normal((int(n), nb_inputs)).astype(
            np.float32), features=feats) for n in lengths]

    return {"seven_with_empty": events([30, 0, 5, 1, 64, 17, 100]),
            "b32_L65_128": events(rng.integers(65, 129, 32))}


def _event_rows(out, i):
    """Event i's answer: a row (graph level) or a [n, cols] array."""
    return out[i] if isinstance(out, list) else out[i: i + 1]


def graph_flips(torch, rec_a, rec_b, rows):
    """The events whose kNN graphs differ between two recorded runs of a
    DynEdge (:func:`_record`): ``rows`` maps an event to ``(its row in
    run a, its row in run b, its pulses)``."""
    graphs = list(zip(_adjacencies(rec_a), _adjacencies(rec_b)))
    flipped = set()
    for e, (ia, ib, n) in rows.items():
        for (ga, ma), (gb, mb) in graphs:
            ma_, mb_ = ma[ia, :n].cpu(), mb[ib, :n].cpu()
            same = torch.equal(ma_, mb_) and bool(
                ((ga[ia, :n].cpu().long() == gb[ib, :n].cpu().long())
                 | ~ma_).all())
            if not same:
                flipped.add(e)
                break
    return flipped


def serve_config_dynedge(torch, gpu, cpu, requests, counters, expect):
    """A model served from its file: every request through ``gpu`` with
    ``expect`` launches per forward, then through ``cpu``; each event's
    answers (rows, or per-pulse rows of a node-level head) within
    CONFIG_RTOL of the CPU's unless a kNN graph of the event differs
    between the two (a latent near-tie flip) in the model's DynEdge (its
    backbone, or DeepIce's nested one; a model without one has no
    flips)."""
    store = []
    handles = _record(gpu, store)
    answers, launches = answer(gpu, requests, counters, expect)
    for h in handles:
        h.remove()
    n_conv = len(_convs(gpu))
    report = []
    for r, (label, evs) in enumerate(requests.items()):
        rec = store[r * n_conv:(r + 1) * n_conv]
        cstore = []
        handles = _record(cpu, cstore)
        ref = cpu(evs)
        for h in handles:
            h.remove()
        got = answers[label]
        kept = [i for i, e in enumerate(evs) if e.n_pulses > 0]
        flips = graph_flips(torch, rec, cstore, {
            i: (j, j, evs[i].n_pulses) for j, i in enumerate(kept)}
        ) if n_conv else set()
        worst, beyond, unexplained = 0.0, 0, []
        kept_rows = [_event_rows(ref, i) for i in kept]
        col_max = np.max(np.abs(np.concatenate(kept_rows)), axis=0)
        for i, e in enumerate(evs):
            g, c = _event_rows(got, i), _event_rows(ref, i)
            assert g.shape == c.shape, f"{label}: event {i} {g.shape} {c.shape}"
            if e.n_pulses == 0:
                assert np.isnan(g).all()
                continue
            assert np.isfinite(g).all(), f"{label}: event {i} not finite"
            err = float(np.max(np.abs(g - c) / np.maximum(
                np.abs(c), CONFIG_FLOOR * col_max)))
            worst = max(worst, err)
            if err > CONFIG_RTOL:
                beyond += 1
                if i not in flips:
                    unexplained.append((i, g.tolist()[:4], c.tolist()[:4]))
        assert not unexplained, (
            f"{label}: events differ from the CPU with no kNN flip (event, "
            f"card, CPU; column max {col_max.tolist()}): {unexplained}")
        report.append({"request": label, "events": len(evs),
                       f"events_beyond_rtol_{CONFIG_RTOL}": beyond,
                       "events_with_knn_flips": len(flips),
                       "max_rel_err": worst})
    return answers, launches, report


def serve_config(torch, path, device, rng, counters, names, launch_expect,
                 fused_fwd, layers, tito_flips):
    """Phase serve_config for one model file: built by ``load_model`` on
    ``device``, random weights (:func:`ice_jax_layout_tree`; DynEdge heads
    scaled by :func:`calibrate_heads`) saved with
    ``save_model``, then served through ``DeploymentModule(model.yml,
    state_dict.pkl)`` on ``device`` and on the CPU (:func:`config_requests`)
    with ``launch_expect[backbone]`` launches per forward: DynEdge held by
    :func:`serve_config_dynedge` and served again with FUSE_CONV_KNN on
    (``fused_fwd`` launches), TITO and DeepIce by
    :func:`serve_direction`.  Returns the module on ``device`` and the
    phase's report."""
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.models.graphs.graph_definition import Event
    from graphnet_tpu_torch.utils.config import load_model, save_model
    from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

    model = load_model(path, device=device, seed=SEED)
    assert next(model.parameters()).device.type == torch.device(device).type
    kind = type(model.backbone).__name__
    requests = config_requests(
        rng, Event, kind, getattr(model.backbone, "nb_inputs", None))
    model.load_state_dict(params_from_jax(ice_jax_layout_tree(
        rng, model, params_to_jax), model.state_dict()))
    if kind == "DynEdge":
        calibrate_heads(torch, model, requests, collate_events)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    save_model(model, tmp)
    del model
    pkl = os.path.join(tmp, "state_dict.pkl")
    gpu = DeploymentModule(path, pkl, device=device)
    cpu = DeploymentModule(path, pkl, device="cpu")
    expect = launch_expect[kind]
    extra = {}
    if kind == "DynEdge":
        answers, launches, report = serve_config_dynedge(
            torch, gpu, cpu, requests, counters, expect)
        # the same requests (L <= 128) with the fused EdgeConv + kNN on
        layers.FUSE_CONV_KNN = True
        try:
            fused, launches_f = answer(gpu, requests, counters, fused_fwd)
        finally:
            layers.FUSE_CONV_KNN = False
        extra = {"launches_fused": dict(zip(names, launches_f)),
                 "fused_answers_identical": all(
                     np.array_equal(a, b, equal_nan=True)
                     for k in requests for a, b in zip(fused[k], answers[k]))}
    else:
        launches, report = serve_direction(
            torch, gpu, cpu, requests, counters, expect,
            flips=tito_flips if kind == "DynEdgeTITO" else None)
    for name, n, got in zip(names, expect, launches):
        assert got > 0 or not n, f"{name} was not launched: {launches}"
    shutil.rmtree(tmp)
    return gpu, {"file": os.path.relpath(path, ROOT), "backbone": kind,
                 "columns": gpu.prediction_columns, "requests": report,
                 "launches": {**dict(zip(names, launches)),
                              "forwards": len(requests)}, **extra}


def sqlite_pulse_pool():
    """Every pulse's x, y, z, t in the bundled SQLite database
    (``[n, 4]`` float64): the real pulse geometry the zoo's raw events
    are drawn from."""
    import sqlite3

    from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA

    conn = sqlite3.connect(EXAMPLE_SQLITE_DATA)
    try:
        rows = conn.execute(
            "SELECT sensor_pos_x, sensor_pos_y, sensor_pos_z, t FROM total "
            "ORDER BY event_no").fetchall()
    finally:
        conn.close()
    return np.asarray(rows, np.float64)


def zoo_column(name, xyzt, rng):
    """A raw column of the zoo's IceCube detectors (IceCubeUpgrade's and
    IceCubeKaggle's features) by name: positions from the pool, times
    ``|t| * 1e3 + 1e4``, the rest drawn in their physical ranges."""
    n = len(xyzt)
    for names, col in ((("dom_x", "x"), 0), (("dom_y", "y"), 1),
                       (("dom_z", "z"), 2)):
        if name in names:
            return xyzt[:, col]
    if name in ("dom_time", "time"):
        return np.abs(xyzt[:, 3]) * 1e3 + 1e4
    if name == "charge":
        return rng.gamma(2.0, 1.0, n) + 0.1
    if name == "rde":
        return np.full(n, 1.0)
    if name == "pmt_area":
        return np.full(n, 0.05)
    if name == "string":
        return rng.integers(1, 90, n).astype(np.float64)
    if name == "pmt_number":
        return rng.integers(0, 20, n).astype(np.float64)
    if name == "dom_number":
        return rng.integers(1, 60, n).astype(np.float64)
    if name.startswith("pmt_dir"):
        return rng.normal(0, 0.5, n)
    if name == "dom_type":
        return rng.choice([20.0, 110.0, 130.0], n)
    if name in ("hlc", "auxiliary"):
        return rng.integers(0, 2, n).astype(np.float64)
    raise KeyError(f"no raw column for zoo feature {name!r}")


def zoo_raw_pulses(rng, names, pool, lengths):
    """Raw pulse arrays ``[n, len(names)]`` (float64), one per length:
    ``n`` pulses of the pool drawn without replacement, the other
    columns by :func:`zoo_column`."""
    out = []
    for n in lengths:
        xyzt = pool[rng.choice(len(pool), int(n), replace=False)]
        out.append(np.stack([zoo_column(nm, xyzt, rng) for nm in names],
                            axis=1).reshape(int(n), len(names)))
    return out


def serve_zoo(torch, directory, device, rng, pool, counters, names, expect,
              smi):
    """Phase serve_zoo for one zoo directory: its ``graph_definition.yml``
    and ``model.yml`` built by ``load_model`` (the model on ``device``),
    a checkpoint in GraphNeT's layout with random weights
    (``examples.port_pretrained.graphnet_state_dict``) ported by the
    porter of its backbone (``weight_port.port_state_dict``; DynEdge
    heads then scaled by :func:`calibrate_heads`), saved with
    ``save_model`` and served through ``DeploymentModule(model.yml,
    state_dict.pkl)`` on ``device`` and on the CPU: raw pulses
    (:func:`zoo_raw_pulses`, ZOO_LENGTHS) through the graph definition
    into events, the answers held by :func:`serve_config_dynedge` with
    ``expect`` launches per forward; then ZOO_RUNS timed requests
    (``tools/zoo_times.py`` profiles them)."""
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.examples.port_pretrained import (
        graphnet_state_dict,
    )
    from graphnet_tpu_torch.utils.config import load_model, save_model
    from graphnet_tpu_torch.utils.weight_port import port_state_dict

    model_path = os.path.join(ZOO_DIR, directory, "model.yml")
    graph_definition = load_model(
        os.path.join(ZOO_DIR, directory, "graph_definition.yml"))
    feature_names = list(graph_definition._input_feature_names)
    events = [graph_definition(raw, feature_names) for raw in zoo_raw_pulses(
        rng, feature_names, pool, ZOO_LENGTHS)]
    requests = {"eight_raw": events}
    model = load_model(model_path, device=device, seed=SEED)
    assert next(model.parameters()).device.type == torch.device(device).type
    checkpoint = graphnet_state_dict(model, rng)
    model.load_state_dict(port_state_dict(model, checkpoint))
    kind = type(model.backbone).__name__
    if kind == "DynEdge":
        calibrate_heads(torch, model, requests, collate_events)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    save_model(model, tmp)
    del model
    pkl = os.path.join(tmp, "state_dict.pkl")
    gpu = DeploymentModule(model_path, pkl, device=device)
    cpu = DeploymentModule(model_path, pkl, device="cpu")
    _, launches, report = serve_config_dynedge(
        torch, gpu, cpu, requests, counters, expect)
    for name, n, got in zip(names, expect, launches):
        assert got > 0 or not n, f"{name} was not launched: {launches}"
    seconds = host_s(lambda: gpu(events), runs=ZOO_RUNS, warmup=1)
    shutil.rmtree(tmp)
    return {"model": directory, "backbone": kind,
            "nested_dynedge": hasattr(gpu.model.backbone, "dyn_edge"),
            "checkpoint_keys": len(checkpoint),
            "pulses": list(ZOO_LENGTHS),
            "nodes": [e.n_pulses for e in events],
            "columns": gpu.prediction_columns, "requests": report,
            "launches": {**dict(zip(names, launches)), "forwards": 1},
            "ms_per_request": seconds * 1e3,
            "events_per_s": len(events) / seconds, "card": smi}


def backbone_graph(kind):
    """The graph definition serve_backbones feeds ``kind``: Prometheus
    pulses (x, y, z, t) for the graph networks, RNN_TITO's through
    ``NodeAsDOMTimeSeries`` with a unit charge (the JAX example 05's
    graph); IceCube Kaggle's six columns for ISeeCube."""
    from graphnet_tpu_torch.utils.config import ModelConfig
    from graphnet_tpu_torch.utils.config import build as build_config

    def graph(detector, node_definition=None, names=None):
        nodes = ({"__model__": node_definition} if node_definition
                 else None)
        return build_config(ModelConfig("KNNGraph", {
            "detector": {"__model__": {"class_name": detector,
                                       "arguments": {}}},
            "node_definition": nodes, "input_feature_names": names}))

    if kind == "ISeeCube":
        return graph("IceCubeKaggle", names=ICE_KAGGLE)
    if kind == "RNNTITO":
        return graph("Prometheus", {
            "class_name": "NodeAsDOMTimeSeries", "arguments": dict(
                keys=FEATURES, id_columns=FEATURES[:3], time_column="t",
                charge_column="t_not_a_charge")}, FEATURES)
    return graph("Prometheus", names=FEATURES)


def backbone_model(kind, device):
    """``(StandardModel, graph definition)`` of GraphNeT's ``kind``
    backbone at its default widths, with an ``EnergyReconstruction``
    head, and :func:`backbone_graph`: DynEdgeJINST at
    ``layer_size_scale=4``; ConvNet with 128 intermediate; ParticleNeT
    (64, 64, 64), (128, 128, 128), (256, 256, 256) at k = 16; ISeeCube
    384 wide, 16 blocks of 12 heads, MLP 1536, ``seq_length`` 196;
    RNN_TITO a GRU of 2 x 64, DynTrans 4 x (256, 256) of 16 heads, post
    (336, 256), readout (256, 128).  The batch norms are frozen, as a
    ported checkpoint is served."""
    from graphnet_tpu_torch.models.gnn.convnet import ConvNet
    from graphnet_tpu_torch.models.gnn.dynedge_jinst import DynEdgeJINST
    from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeT
    from graphnet_tpu_torch.models.gnn.rnn_tito import RNNTITO
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.models.transformer.iseecube import ISeeCube
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss

    if kind == "DynEdgeJINST":
        backbone = DynEdgeJINST(nb_inputs=NB_INPUTS, layer_size_scale=4)
    elif kind == "ConvNet":
        backbone = ConvNet(nb_inputs=NB_INPUTS, nb_intermediate=128,
                           frozen_batchnorm=True)
    elif kind == "ParticleNeT":
        backbone = ParticleNeT(
            nb_inputs=NB_INPUTS, nb_neighbours=16,
            dynedge_layer_sizes=((64, 64, 64), (128, 128, 128),
                                 (256, 256, 256)),
            frozen_batchnorm=True)
    elif kind == "ISeeCube":
        backbone = ISeeCube(hidden_dim=384, seq_length=196, num_layers=16,
                            num_heads=12, mlp_dim=1536)
    elif kind == "RNNTITO":
        backbone = RNNTITO(
            nb_inputs=6, time_series_columns=(4, 3), rnn_layers=2,
            rnn_hidden_size=64, n_head=RNN_TITO_HEADS,
            dyntrans_layer_sizes=((256, 256),) * 4,
            post_processing_layer_sizes=(336, 256),
            readout_layer_sizes=(256, 128))
    else:
        raise ValueError(f"no such backbone here: {kind}")
    model = StandardModel(
        backbone=backbone,
        tasks=[EnergyReconstruction(
            hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
            target_labels=("total_energy",))],
        seed=SEED, device=device)
    return model, backbone_graph(kind)


def serve_backbone(torch, kind, device, rng, pool, counters, names, expect,
                   smi):
    """Phase serve_backbones for one backbone (:func:`backbone_model` on
    ``device``): a checkpoint in GraphNeT's layout with random weights
    (``examples.port_pretrained.graphnet_state_dict``) ported by its
    porter (``weight_port.port_state_dict``), saved with ``save_model``
    and served through ``DeploymentModule(model.yml, state_dict.pkl)``
    on ``device`` and on the CPU: 8 raw events (ZOO_LENGTHS pulses of the
    pool; ISeeCube's ISEECUBE_LENGTHS, its other columns by
    :func:`zoo_column`) through the graph definition, the answers held by
    :func:`serve_config_dynedge` (rtol 1e-3, latent kNN flips of JINST
    and ParticleNeT explained) with ``expect`` launches per forward; then
    ZOO_RUNS timed requests."""
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.examples.port_pretrained import (
        graphnet_state_dict,
    )
    from graphnet_tpu_torch.utils.config import save_model
    from graphnet_tpu_torch.utils.weight_port import port_state_dict

    model, gd = backbone_model(kind, device)
    assert next(model.parameters()).device.type == torch.device(device).type
    feature_names = list(gd._input_feature_names)
    if kind == "ISeeCube":
        raws = zoo_raw_pulses(rng, feature_names, pool, ISEECUBE_LENGTHS)
    else:  # Prometheus: the pool's own x, y, z, t
        raws = [pool[rng.choice(len(pool), n, replace=False)]
                for n in ZOO_LENGTHS]
    events = [gd(raw, feature_names) for raw in raws]
    checkpoint = graphnet_state_dict(model, rng)
    model.load_state_dict(port_state_dict(model, checkpoint))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    save_model(model, tmp)
    del model
    path = os.path.join(tmp, "config.yml")
    pkl = os.path.join(tmp, "state_dict.pkl")
    gpu = DeploymentModule(path, pkl, device=device)
    cpu = DeploymentModule(path, pkl, device="cpu")
    _, launches, report = serve_config_dynedge(
        torch, gpu, cpu, {"eight_raw": events}, counters, expect)
    for name, n, got in zip(names, expect, launches):
        assert got > 0 or not n, f"{name} was not launched: {launches}"
    seconds = host_s(lambda: gpu(events), runs=ZOO_RUNS, warmup=1)
    shutil.rmtree(tmp)
    return {"backbone": kind, "checkpoint_keys": len(checkpoint),
            "pulses": [len(r) for r in raws],
            "nodes": [e.n_pulses for e in events],
            "parameters": sum(p.numel() for p in gpu.model.parameters()),
            "requests": report,
            "launches": {**dict(zip(names, launches)), "forwards": 1},
            "ms_per_request": seconds * 1e3,
            "events_per_s": len(events) / seconds, "card": smi}


# the train_backbones phase: GraphNeT's backbones trained with their
# dropout on (deterministic=False) from the bundled database, at
# GraphNeT's widths, with the launches of a training step (and of an
# eval forward where it differs: TITO's attention dropout takes the
# dense path in training, as in the JAX package, and the flash kernels
# in eval).  RNN_TITO's 16 heads of 16 give rows 5b and 5c at head dim 16
# their main path.  "RNNTITO/gru_1" is RNN_TITO reading its second GRU
# layer's state (GraphNeT's reads the first), so NodeRNN's dropout
# between the layers runs.  The module whose knn_graph each backbone
# calls
TRAIN_BACKBONES = {
    "RNNTITO": ([1, 4, 4, 4, 4, 4, 0, 0, 0, 0], None),
    "RNNTITO/gru_1": ([1, 4, 4, 4, 4, 4, 0, 0, 0, 0], None),
    "DynEdgeTITO": ([1, 4, 4, 0, 0, 0, 0, 0, 0, 0],
                    [1, 4, 0, 4, 0, 0, 0, 0, 0, 0]),
    "ConvNet": ([1, 0, 0, 0, 0, 0, 0, 0, 0, 0], None),
    "ParticleNeT": ([4, 0, 0, 0, 0, 0, 0, 0, 0, 0], None),
}
TRAIN_KNN_MODULES = {
    "RNNTITO": "graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito",
    "RNNTITO/gru_1": "graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito",
    "DynEdgeTITO": "graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito",
    "ConvNet": "graphnet_tpu_torch.models.gnn.convnet",
    "ParticleNeT": "graphnet_tpu_torch.models.gnn.particlenet",
}
TITO_FILE = os.path.join(MODELS, "tito_direction_prometheus.yml")
# batch, steps of the card's run, timed steps
TRAIN_BACKBONE_B, TRAIN_BACKBONE_STEPS, TRAIN_BACKBONE_RUNS = 16, 3, 10
# a gradient whose true value is 0 (a bias before a batch norm, or one
# that is exactly 0 on the CPU) is held at this share of the model's
# largest gradient; the CPU may read at most ROUNDING of it there
GRAD_FLOOR, ROUNDING = 1e-3, 1e-5


class StepTape:
    """The random draws of one training step: each keep mask of the
    stochastic layers (through ``stochastic.keep_mask``, the port's one
    mask function) and each kNN graph of ``knn_module``, recorded on one
    device and replayed, in order, on another."""

    def __init__(self, knn_module):
        import importlib

        from graphnet_tpu_torch.models.components import stochastic

        self.stochastic = stochastic
        self.module = importlib.import_module(knn_module)
        self.masks, self.graphs = [], []

    @contextlib.contextmanager
    def _patched(self, keep_mask, knn_graph):
        saved = (self.stochastic.keep_mask, self.module.knn_graph)
        self.stochastic.keep_mask, self.module.knn_graph = keep_mask, knn_graph
        try:
            yield
        finally:
            self.stochastic.keep_mask, self.module.knn_graph = saved

    def record(self):
        real_mask, real_knn = self.stochastic.keep_mask, self.module.knn_graph

        def keep_mask(shape, keep_prob, device):
            m = real_mask(shape, keep_prob, device)
            self.masks.append(m.cpu())
            return m

        def knn_graph(coords, mask, k, exclude_self=True):
            idx, em = real_knn(coords, mask, k, exclude_self)
            self.graphs.append((idx.cpu(), em.cpu()))
            return idx, em

        return self._patched(keep_mask, knn_graph)

    def replay(self):
        n_mask, n_graph = [0], [0]

        def keep_mask(shape, keep_prob, device):
            m = self.masks[n_mask[0]]
            n_mask[0] += 1
            assert tuple(m.shape) == tuple(shape), (m.shape, shape)
            return m.to(device)

        def knn_graph(coords, mask, k, exclude_self=True):
            idx, em = self.graphs[n_graph[0]]
            n_graph[0] += 1
            assert idx.shape[:2] == mask.shape and idx.shape[2] == k
            return idx.to(coords.device), em.to(coords.device)

        return self._patched(keep_mask, knn_graph)


def train_backbone_model(kind, device, tree=None):
    """``(StandardModel, graph definition)`` of ``kind`` at GraphNeT's
    widths with its dropout on (``deterministic=False``): RNN_TITO as
    :func:`backbone_model` builds it with ``rnn_dropout=0.5``;
    DynEdgeTITO from ``configs/models/tito_direction_prometheus.yml``
    with ``dropout_rate=0.1``; ConvNet (``dropout_ratio`` 0.3) and
    ParticleNeT (``dropout_readout`` 0.1) with their default dropouts
    and the batch's batch-norm statistics.  With ``tree``, the JAX-layout
    weights are loaded."""
    import yaml

    from graphnet_tpu_torch.models.gnn.convnet import ConvNet
    from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeT
    from graphnet_tpu_torch.models.gnn.rnn_tito import RNNTITO
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
    from graphnet_tpu_torch.utils.config import (
        TRANSFORM_REGISTRY,
        ModelConfig,
    )
    from graphnet_tpu_torch.utils.config import build as build_config
    from graphnet_tpu_torch.utils.jax_params import params_from_jax

    kind, _, variant = kind.partition("/")
    if kind == "DynEdgeTITO":
        with open(TITO_FILE) as f:
            cfg = yaml.safe_load(f)
        cfg["arguments"]["backbone"]["__model__"]["arguments"].update(
            dropout_rate=0.1, deterministic=False)
        model = build_config(ModelConfig.from_dict(cfg), seed=SEED,
                             device=device)
    else:
        if kind == "RNNTITO":
            backbone = RNNTITO(
                nb_inputs=6, time_series_columns=(4, 3), rnn_layers=2,
                rnn_hidden_size=64, rnn_dropout=0.5, n_head=RNN_TITO_HEADS,
                dyntrans_layer_sizes=((256, 256),) * 4,
                post_processing_layer_sizes=(336, 256),
                readout_layer_sizes=(256, 128), deterministic=False)
            if variant == "gru_1":
                backbone.rnn.final_state_layer = 1
        elif kind == "ConvNet":
            backbone = ConvNet(nb_inputs=NB_INPUTS, nb_intermediate=128,
                               deterministic=False)
        else:
            backbone = ParticleNeT(
                nb_inputs=NB_INPUTS, nb_neighbours=16,
                dynedge_layer_sizes=((64, 64, 64), (128, 128, 128),
                                     (256, 256, 256)),
                deterministic=False)
        model = StandardModel(
            backbone=backbone,
            tasks=[EnergyReconstruction(
                hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
                target_labels=("total_energy",),
                transform_prediction_and_target=TRANSFORM_REGISTRY["log10"])],
            seed=SEED, device=device)
    if tree is not None:
        model.load_state_dict(params_from_jax(tree, model.state_dict()))
    return model, backbone_graph(kind)


def backbone_batches(kind, graph_definition, n):
    """The first ``n`` batches of TRAIN_BACKBONE_B events of the bundled
    database through ``graph_definition`` (on the CPU): the injection
    direction (``training.labels.Direction``) for DynEdgeTITO, the
    energy for the others."""
    from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
    from graphnet_tpu_torch.data.constants import TRUTH
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu_torch.training.labels import Direction

    labels = ({"direction": Direction(azimuth_key="injection_azimuth",
                                      zenith_key="injection_zenith")}
              if kind == "DynEdgeTITO" else None)
    ds = SQLiteDataset(EXAMPLE_SQLITE_DATA, graph_definition,
                       pulsemaps="total", features=FEATURES,
                       truth=TRUTH.PROMETHEUS, truth_table="mc_truth",
                       labels=labels)
    batches = []
    for batch in DataLoader(ds, batch_size=TRAIN_BACKBONE_B):
        batches.append(batch)
        if len(batches) == n:
            break
    return batches


def _unread_params(model):
    """Parameters the loss never reaches: RNN_TITO's GRU layers past the
    one whose state it reads (GraphNeT's first), which are not run."""
    rnn = getattr(model.backbone, "rnn", None)
    if rnn is None:
        return set()
    return {n for n, _ in model.named_parameters()
            for layer in range(rnn.final_state_layer + 1, rnn.num_layers)
            if n.startswith(f"backbone.rnn.gru_{layer}.")}


def _biases_before_batch_norm(model):
    """Names of the biases a batch norm in training takes straight
    (ParticleNeT's EdgeConv denses): the norm subtracts the batch mean,
    so their true gradient is 0 and both devices read rounding."""
    from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeTConv

    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, ParticleNeTConv) and m.add_batchnorm:
            for i in range(len(m.nn_sizes)):
                if not getattr(m, f"bn_{i}").frozen:
                    dense = "self_dense" if i == 0 else f"dense_{i}"
                    names.add(f"{prefix}.{dense}.bias")
    return names


def _step1_grad_errors(a, b, rounding):
    """Per parameter, the step-1 gradient of run ``a`` against run ``b``:
    the error's max over the parameter's max in ``b``.  Those in
    ``rounding`` (true gradient 0) and those exactly 0 in ``b`` are over
    GRAD_FLOOR of ``b``'s largest gradient instead, and returned apart
    with both runs' readings as shares of it; ``b`` must read at most
    ROUNDING there."""
    top = max(float(g.abs().max()) for g in b["grads1"].values())
    errs, floored = {}, {}
    for n, g in b["grads1"].items():
        err = float((a["grads1"][n] - g).abs().max())
        scale = float(g.abs().max())
        if n in rounding or scale == 0.0:
            assert scale <= ROUNDING * top, (n, scale / top)
            floored[n] = {"cpu": scale / top,
                          "card": float(a["grads1"][n].abs().max()) / top,
                          "err": err / (GRAD_FLOOR * top)}
        else:
            errs[n] = err / scale
    return errs, floored


def train_backbone(torch, kind, device, counters, names, smi, rng):
    """Phase train_backbones for one backbone (:func:`train_backbone_model`
    with random JAX-layout weights from ``rng``) on ``device`` from the
    bundled database: TRAIN_BACKBONE_STEPS ``Trainer`` steps with
    TRAIN_BACKBONES' launches each, every gradient finite and non-zero
    (but those of RNN_TITO's unread GRU layer, which is not run); an
    eval forward's launches;
    the step's ms and peak memory.  Then step 1 again on the CPU fed the
    card's keep masks and kNN graphs (:class:`StepTape`): the loss within
    rtol 1e-3 and each gradient within 1e-3 of its max (TITO's with the
    output gradient zeroed where the backward is discontinuous within
    1e-5 on both devices, ``mask_ambiguous``, the card's step run again
    so)."""
    import types

    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    expect, eval_expect = TRAIN_BACKBONES[kind]
    cpu_model, gd = train_backbone_model(kind, "cpu")
    tree = ice_jax_layout_tree(rng, cpu_model, params_to_jax)
    batches = backbone_batches(kind, gd, TRAIN_BACKBONE_STEPS)
    on_card = [b.to(device) for b in batches]

    model, _ = train_backbone_model(kind, device, tree)
    trainer = Trainer(model, seed=SEED)
    tape = StepTape(TRAIN_KNN_MODULES[kind])
    for c in counters:
        c.launches = 0
    with tape.record():
        gpu = run_steps(torch, trainer, on_card[:1], counters)
    rest = run_steps(torch, trainer, on_card[1:], counters)
    launches = [c.launches for c in counters]
    rose = gpu["rose"] + rest["rose"]
    assert all(r == expect for r in rose) or not counters, rose
    nonfinite = sorted(set(sum(gpu["nonfinite"] + rest["nonfinite"], []))
                       - _unread_params(model))
    zero = sorted(set(sum(gpu["zero"] + rest["zero"], [])))
    assert not nonfinite and not zero, (nonfinite, zero)
    eval_rose = None
    if eval_expect is not None:
        counts = [c.launches for c in counters]
        model.eval()
        with torch.no_grad():
            model(on_card[0])
        eval_rose = [c.launches - n for c, n in zip(counters, counts)]
        assert eval_rose == eval_expect or not counters, eval_rose
    timing = (train_times(torch, trainer, on_card[0],
                          runs=TRAIN_BACKBONE_RUNS)
              if torch.device(device).type == "cuda" else {})

    tito = kind.startswith("RNNTITO") or kind == "DynEdgeTITO"
    cpu_model, _ = train_backbone_model(kind, "cpu", tree)
    masks, handles = [], []
    if tito:
        inner = (cpu_model.backbone.dynedge_tito if kind != "DynEdgeTITO"
                 else cpu_model.backbone)
        handles = mask_ambiguous(torch, types.SimpleNamespace(backbone=inner),
                                 masks, True)
    with tape.replay():
        cpu = run_steps(torch, Trainer(cpu_model, seed=SEED), batches[:1])
    for h in handles:
        h.remove()
    card = gpu
    if tito:
        again, _ = train_backbone_model(kind, device, tree)
        inner = (again.backbone.dynedge_tito if kind != "DynEdgeTITO"
                 else again.backbone)
        handles = mask_ambiguous(torch, types.SimpleNamespace(backbone=inner),
                                 masks, False)
        with tape.replay():
            card = run_steps(torch, Trainer(again, seed=SEED), on_card[:1])
        for h in handles:
            h.remove()
    loss_err = abs(card["loss"][0] - cpu["loss"][0]) / abs(cpu["loss"][0])
    assert loss_err <= 1e-3, (card["loss"], cpu["loss"])
    errs, floored = _step1_grad_errors(
        card, cpu, _biases_before_batch_norm(cpu_model))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, {n: e for n, e in errs.items() if e > 1e-3}
    assert all(f["err"] <= 1e-3 for f in floored.values()), floored
    return {
        "backbone": kind, "B": TRAIN_BACKBONE_B,
        "L": [b.max_length for b in batches],
        "events": [b.batch_size for b in batches],
        "parameters": sum(p.numel() for p in model.parameters()),
        "masks_step1": len(tape.masks), "knn_graphs_step1": len(tape.graphs),
        "kept_share_step1": (float(np.mean([m.float().mean()
                                            for m in tape.masks]))
                             if tape.masks else None),
        "losses_card": gpu["loss"] + rest["loss"],
        "loss_step1_cpu": cpu["loss"][0], "loss_rel_err_step1": loss_err,
        "max_grad_rel_err_step1": errs[worst], "worst_grad_param": worst,
        "true_zero_grads_step1": floored,
        "ambiguous_entries_zeroed": int(sum(int((m == 0).sum())
                                            for m in masks)),
        "launches_per_step": dict(zip(names, expect)) if counters else None,
        "launches": dict(zip(names, launches)),
        "launches_per_eval_forward": (dict(zip(names, eval_rose))
                                      if eval_rose and counters else None),
        **timing, "card": smi,
    }


class Preempted(Exception):
    pass


def resume_phase(torch, device, smi, rng, tmp):
    """Resume on ``device``: DynEdgeTITO with dropout 0.1 (from its model
    file) and EMA, 2 epochs of 2 batches unbroken, against a run cut in
    its second epoch (the loader raises) and resumed by a new Trainer
    and model from ``checkpoint_dir``'s ``last``: the losses of epoch 2
    and the parameters (the average swapped in) within 1e-5 of each
    parameter's max, and whether they are the same bits."""
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    cpu_model, gd = train_backbone_model("DynEdgeTITO", "cpu")
    tree = ice_jax_layout_tree(rng, cpu_model, params_to_jax)
    batches = [b.to(device) for b in backbone_batches("DynEdgeTITO", gd, 2)]

    def trainer(name):
        model, _ = train_backbone_model("DynEdgeTITO", device, tree)
        return Trainer(model, seed=SEED, averaging="ema", ema_decay=0.9,
                       checkpoint_dir=os.path.join(tmp, name))

    class CutLoader:
        def __init__(self):
            self.epochs = 0

        def __len__(self):
            return len(batches)

        def __iter__(self):
            self.epochs += 1
            if self.epochs == 2:
                raise Preempted
            return iter(batches)

    whole = trainer("whole")
    h_whole = whole.fit(batches, max_epochs=2)
    cut = trainer("cut")
    try:
        cut.fit(CutLoader(), max_epochs=2)
        raise AssertionError("the cut run was not cut")
    except Preempted:
        pass
    resumed = trainer("cut")
    h_resumed = resumed.fit(batches, max_epochs=2, resume=True)
    assert resumed.step == whole.step == 4
    errs, same = {}, True
    for (n, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        errs[n] = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        same &= bool(torch.equal(a, b))
    worst = max(errs, key=errs.get)
    np.testing.assert_allclose(h_resumed["train_loss"],
                               h_whole["train_loss"][1:], rtol=1e-5)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    return {"losses_unbroken": h_whole["train_loss"],
            "losses_resumed": h_resumed["train_loss"],
            "max_param_rel_err": errs[worst], "worst_param": worst,
            "bit_equal": same, "card": smi}


def remat_phase(torch, make, batch, smi):
    """DeepIce with and without ``remat`` (``make(remat)``, the same
    weights) on ``batch``: each step's ms and peak memory
    (:func:`train_times`), and the first step's gradients of the two
    within 1e-5 of each parameter's max (and whether the same bits)."""
    from graphnet_tpu_torch.training.trainer import Trainer

    out, grads = {}, {}
    for remat in (False, True):
        trainer = Trainer(make(remat))
        trainer.train_step(batch)
        grads[remat] = {n: p.grad.clone()
                        for n, p in trainer.model.named_parameters()}
        out["remat" if remat else "no_remat"] = train_times(
            torch, trainer, batch, runs=5)
        del trainer
        torch.cuda.empty_cache()
    errs = {n: float((g - grads[True][n]).abs().max())
            / max(float(g.abs().max()), 1e-30) for n, g in grads[False].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    assert (out["remat"]["peak_memory_mb"]
            < out["no_remat"]["peak_memory_mb"]), out
    return {**out, "max_grad_rel_err": errs[worst], "worst_grad_param": worst,
            "grads_bit_equal": all(torch.equal(g, grads[True][n])
                                   for n, g in grads[False].items()),
            "card": smi}


def example_clis(torch, device, counters, names, smi, tmp):
    """The four training examples' command lines (``--device``, one
    epoch, in this process), with the launches each run made."""
    import importlib

    report = []
    for name in ("train_tito_direction", "train_deepice",
                 "train_from_config", "train_rnn_tito"):
        example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
        argv = ["--device", str(device), "--max-epochs", "1"]
        if name == "train_from_config":
            argv += ["--output", os.path.join(tmp, name)]
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trainer = example.main(argv)
        seconds = time.perf_counter() - t0
        launches = dict(zip(names, [c.launches for c in counters]))
        assert trainer.step > 0 and next(
            trainer.model.parameters()).device.type == torch.device(
                device).type
        report.append({"example": name, "seconds": seconds,
                       "steps": trainer.step, "launches": launches})
    return {"examples": report, "card": smi}


# ------------------------------------------- the other targets and rules

# RadialEdges' radius in the Prometheus detector's standardised units
# (the bundled events' pulses lie a median 1.0 apart): some of each
# node's 32 nearest lie within it and some beyond
RADIUS = 0.5
# kNN and EdgeConv launches a forward (forward, backward a step) of the
# full-width DynEdge behind each edge rule: the rule's graph first (row
# 1 at k = 32 for RadialEdges, plain PyTorch for the Minkowski and
# Euclidean rules), then the 4 latent rebuilds
RULE_LAUNCHES = {"KNNEdges": 5, "RadialEdges": 5, "MinkowskiKNNEdges": 4,
                 "EuclideanEdges": 4}
TARGET_GRID = 101  # log_prob grid of each flow


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def edge_rules():
    """The four rules of the edge_rules phase, at the JAX defaults
    (``RadialEdges``' ``max_neighbours=32``) but the radius."""
    from graphnet_tpu_torch.models.graphs import edges

    return [edges.KNNEdges(), edges.RadialEdges(radius=RADIUS),
            edges.MinkowskiKNNEdges(), edges.EuclideanEdges()]


def launches_of(names, knn, fwd=True):
    """The launch vector of one DynEdge forward (``fwd``) or step with
    ``knn`` kNN launches."""
    counts = dict(knn=knn, edgeconv=4, edgeconv_bwd=0 if fwd else 4)
    return [counts.get(n, 0) for n in names]


def targets_dataset(path=None, **kwargs):
    """The bundled database through ``KNNGraph(Prometheus())`` with the
    flows' labels: ``log10_energy`` (example 06's) and the injection
    ``direction``."""
    from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
    from graphnet_tpu_torch.data.constants import FEATURES as PF, TRUTH
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu_torch.examples.train_normalizing_flow import Log10Energy
    from graphnet_tpu_torch.models.detector.prometheus import Prometheus
    from graphnet_tpu_torch.models.graphs import KNNGraph
    from graphnet_tpu_torch.training.labels import Direction

    return SQLiteDataset(
        path=path or EXAMPLE_SQLITE_DATA,
        graph_definition=KNNGraph(detector=Prometheus()), pulsemaps="total",
        features=PF.PROMETHEUS, truth=TRUTH.PROMETHEUS, truth_table="mc_truth",
        labels={"log10_energy": Log10Energy(),
                "direction": Direction(azimuth_key="injection_azimuth",
                                       zenith_key="injection_zenith")},
        **kwargs)


def targets_batch(torch, dataset, rng):
    """Every event of ``dataset`` in one batch (the bundled database: 50
    events of 3-99 pulses, L=128), with a ``vertex`` (the injection
    position and a time) and an ``interaction_time`` drawn from ``rng``:
    the database has no interaction time."""
    from graphnet_tpu_torch.data.dataloader import DataLoader

    batch = next(iter(DataLoader(dataset, batch_size=len(dataset))))
    B = batch.batch_size
    t = torch.from_numpy(rng.normal(0.0, 10.0, B).astype(np.float32))
    batch.labels["interaction_time"] = t
    batch.labels["vertex"] = torch.stack(
        [batch.labels[f"injection_position_{c}"].float() for c in "xyz"] + [t], 1)
    return batch


def nine_heads():
    """The nine heads the port gained, each with a loss, on the truth
    columns the database has (track and cascade from the primary lepton
    and hadron; inelasticity from Bjorken y)."""
    from graphnet_tpu_torch.models.task import reconstruction as rec
    from graphnet_tpu_torch.training import loss_functions as lf
    from graphnet_tpu_torch.utils.config import TRANSFORM_REGISTRY

    h = dict(hidden_size=128)
    return [
        rec.AzimuthReconstructionWithKappa(
            loss_function=lf.VonMisesFisher2DLoss(),
            target_labels=("injection_azimuth",), **h),
        rec.AzimuthReconstruction(loss_function=lf.MSELoss(),
                                  target_labels=("injection_azimuth",), **h),
        rec.EnergyReconstructionWithPower(
            loss_function=lf.LogCoshLoss(), target_labels=("total_energy",),
            transform_prediction_and_target=TRANSFORM_REGISTRY["log10"], **h),
        rec.EnergyTCReconstruction(
            loss_function=lf.LogCoshLoss(),
            target_labels=("primary_lepton_1_energy", "primary_hadron_1_energy"),
            **h),
        rec.EnergyReconstructionWithUncertainty(
            loss_function=lf.LogCoshLoss(), target_labels=("total_energy",), **h),
        rec.VertexReconstruction(loss_function=lf.EuclideanDistanceLoss(),
                                 target_labels=("vertex",), **h),
        rec.PositionReconstruction(
            loss_function=lf.EuclideanDistanceLoss(),
            target_labels=tuple(f"injection_position_{c}" for c in "xyz"), **h),
        rec.TimeReconstruction(loss_function=lf.MSELoss(),
                               target_labels=("interaction_time",), **h),
        rec.InelasticityReconstruction(loss_function=lf.MSELoss(),
                                       target_labels=("injection_bjorkeny",), **h),
    ]


def scale_heads(torch, model, batch, peak=1.0):
    """Scale each task head's affine map (a flow's conditioner input is
    layer-normed and needs none) so that its largest output on ``batch``
    is ``peak``: random DynEdge latents grow ~8x a layer and would
    overflow the pow10 head."""
    with torch.inference_mode():
        latents = model.backbone(batch)
        for task in model.tasks:
            top = float(task.affine(latents).abs().max())
            task.affine.weight.mul_(peak / top)
            task.affine.bias.mul_(peak / top)


def target_step(torch, make, Trainer, batch, counters, expect, dev, steps=3,
                lr=1e-3):
    """``steps`` Trainer steps of ``make(dev)`` on ``batch`` with the
    launches of each step checked against ``expect``, every loss and
    gradient finite and the last step's every gradient non-zero (a
    flow's conditioner head starts at zero, so its first step reaches
    that head alone); step 1 held against the CPU with the CPU's graphs
    fed to the card: the loss within rtol 1e-3, each gradient within
    1e-3 of its largest magnitude.  Returns the report, the models of
    step 1 (CPU and fed card) and the CPU's graphs."""
    cpu_model = make("cpu")
    store = []
    handles = record_adjacency(cpu_model, store)
    cpu = run_steps(torch, Trainer(cpu_model), [batch])
    for h in handles:
        h.remove()
    graphs = list(store)

    on_card = batch.to(dev)
    gpu_model = make(dev)
    gpu_store = []
    handles = record_adjacency(gpu_model, gpu_store)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    gpu = run_steps(torch, Trainer(gpu_model, learning_rate=lr),
                    [on_card] * steps, counters)
    sync(torch, dev)
    step_s = (time.perf_counter() - t0) / steps
    launches = [c.launches for c in counters]
    for h in handles:
        h.remove()
    assert all(r == expect for r in gpu["rose"]), (gpu["rose"], expect)
    assert np.isfinite(gpu["loss"]).all() and not any(gpu["nonfinite"]), gpu
    assert not gpu["zero"][-1], f"zero gradients at step {steps}: {gpu['zero'][-1]}"

    fed_model = make(dev)
    handles = feed_adjacency(fed_model, graphs, dev)
    fed_batch = replace(on_card, edges=graphs[0][0].to(dev),
                        edge_mask=graphs[0][1].to(dev))
    fed = run_steps(torch, Trainer(fed_model, learning_rate=lr), [fed_batch])
    for h in handles:
        h.remove()
    np.testing.assert_allclose(fed["loss"], cpu["loss"], rtol=1e-3,
                               err_msg="step-1 loss with the CPU's graphs")
    grad_err = {}
    for name, gc in cpu["grads1"].items():
        e = float((fed["grads1"][name] - gc).abs().max())
        scale = float(gc.abs().max())
        assert e <= 1e-3 * scale, f"step-1 gradient of {name}: {e} vs max {scale}"
        grad_err[name] = e / scale if scale else 0.0
    flips = sum(int((((gi.cpu() != ci) & cm) | (gm.cpu() != cm)).sum())
                for (gi, gm), (ci, cm) in zip(gpu_store, graphs))
    return {
        "B": batch.batch_size, "L": batch.max_length, "steps": steps,
        "losses_card": gpu["loss"], "loss_cpu_step1": cpu["loss"][0],
        "loss_card_cpu_graphs_step1": fed["loss"][0],
        "launches_per_step": gpu["rose"], "step_ms": 1e3 * step_s,
        "zero_grads_step1": len(gpu["zero"][0]),
        "every_grad_finite_nonzero_last_step": True,
        "knn_flips_vs_cpu_step1": flips,
        "max_grad_rel_err_step1_cpu_graphs": max(grad_err.values()),
    }, cpu_model, fed_model, graphs, launches


def rule_model(rule, train_tree, device):
    """The train phase's full-width DynEdge energy model (its weights and
    ``LogCoshLoss`` on ``log10(total_energy)``) with ``rule`` evaluated
    before the backbone."""
    import torch

    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
    from graphnet_tpu_torch.utils.jax_params import params_from_jax

    model = StandardModel(
        DynEdge(nb_inputs=NB_INPUTS),
        [EnergyReconstruction(hidden_size=128, loss_function=LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10)],
        edge_definition=rule, device=device)
    model.load_state_dict(params_from_jax(train_tree, model.state_dict()))
    return model


def edge_rule_phase(torch, rule, train_tree, events, batch, counters, names,
                    dev, collate_events, smi):
    """One rule of the edge_rules phase: the full-width DynEdge energy
    model with ``rule`` served through ``DeploymentModule`` on the card
    against the CPU (``serve``: flips explained, the CPU's graphs fed),
    and trained (``target_step``), the launches of each forward and step
    counted exactly.  ``KNNEdges`` must equal the model without a rule,
    bit for bit, served and trained."""
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
    from graphnet_tpu_torch.training.trainer import Trainer

    kind = type(rule).__name__
    knn = RULE_LAUNCHES[kind]
    longest = sorted(events, key=lambda e: -e.n_pulses)[:16]
    requests = {f"db_all_{len(events)}": events, "db_longest_16": longest}

    def module(device, with_rule=True):
        m = rule_model(rule if with_rule else None, train_tree, device)
        return DeploymentModule(m, m.state_dict(), device=device)

    gpu = module(dev)
    # the main path alone first: the kNN launches by k of its forwards
    by_k = counters[0].launches_by_k
    by_k.clear()
    answer(gpu, requests, counters, launches_of(names, knn))
    n = len(requests)
    expect_k = ({32: n, K: 4 * n} if kind == "RadialEdges"
                else {K: knn * n})
    assert by_k == expect_k, f"{kind}: kNN launches by k {by_k}, not {expect_k}"
    k32 = by_k.get(32, 0)
    answers, _, report = serve(torch, gpu, module("cpu"), requests, counters,
                               launches_of(names, knn), dev, collate_events)
    t0 = time.perf_counter()
    gpu(requests["db_longest_16"])
    sync(torch, dev)
    out = {"rule": kind, "rule_args": {k: v for k, v in vars(rule).items()},
           "card": smi, "requests": report,
           "knn_launches_by_k_serving": {str(k): v for k, v in expect_k.items()},
           "knn_k32_launches_serving": k32,
           "request_ms_longest_16": 1e3 * (time.perf_counter() - t0)}
    step, _, _, _, launches = target_step(
        torch, lambda d: rule_model(rule, train_tree, d), Trainer, batch,
        counters, launches_of(names, knn, fwd=False), dev, steps=2)
    out.update(step=step, launches_step=dict(zip(names, launches)))
    if kind == "KNNEdges":
        plain = module(dev, with_rule=False)
        same = {label: bool(np.array_equal(plain(evs), answers[label],
                                           equal_nan=True))
                for label, evs in requests.items()}
        assert all(same.values()), f"KNNEdges against no rule: {same}"
        on_card = batch.to(dev)
        grads = []
        for with_rule in (True, False):
            m = rule_model(rule if with_rule else None, train_tree, dev)
            loss = m.loss_from_batch(m(on_card), on_card)
            loss.backward()
            grads.append([loss.detach()] + [p.grad for p in m.parameters()])
        assert all(torch.equal(a, b) for a, b in zip(*grads)), (
            "KNNEdges: loss or gradients differ from the model without a rule")
        out["bit_equal_to_no_rule"] = {"answers": same, "loss_and_grads": True}
    return out


def nine_head_model(torch, device, batch, tmp):
    """The full-width DynEdge with the nine heads: built on the CPU from
    the seed, each head scaled to unit peak on ``batch``, then dumped by
    the port as ``model.yml`` + ``state_dict.pkl`` in ``tmp``; returns the
    two paths."""
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.utils.config import save_model_config
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    model = StandardModel(DynEdge(nb_inputs=NB_INPUTS), nine_heads(),
                          seed=SEED, device="cpu")
    scale_heads(torch, model, batch)
    yml, pkl = os.path.join(tmp, "model.yml"), os.path.join(tmp, "state_dict.pkl")
    save_model_config(model, yml)
    with open(pkl, "wb") as f:
        pickle.dump(params_to_jax(model.state_dict()), f)
    return yml, pkl


def flow_grid(torch, flow, batch, kind):
    """``log p`` of every event of ``batch`` at ``TARGET_GRID`` targets,
    ``[TARGET_GRID, B]``: log10 E in [-1, 4] for a NormalizingFlow, unit
    vectors along a spiral over the sphere for a SphericalFlow.  The
    conditioner runs once (``log_prob`` = the density of the conditioner's
    parameters at the target)."""
    from graphnet_tpu_torch.models.normalizing_flow import anchor_directions

    with torch.no_grad():
        B = batch.batch_size
        if kind == "spherical":
            mu, kappa, log_w = flow.mixture_params(batch)
            dirs = torch.from_numpy(anchor_directions(TARGET_GRID)).to(mu.device)
            return torch.stack([flow._log_prob_from_params(
                mu, kappa, log_w, d.expand(B, 3)) for d in dirs]).cpu().numpy()
        raw = flow._raw(batch)
        grid = np.linspace(-1.0, 4.0, TARGET_GRID, dtype=np.float32)
        return torch.stack([-flow._nllh(raw, torch.full(
            (B, 1), float(g), device=raw.device)) for g in grid]).cpu().numpy()


def flow_model(kind, device):
    """``NormalizingFlow`` on log10 E (example 06's, full-width DynEdge),
    with either transform, or ``SphericalFlow`` on the direction."""
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.normalizing_flow import (
        NormalizingFlow,
        SphericalFlow,
    )

    if kind == "spherical":
        return SphericalFlow(DynEdge(nb_inputs=NB_INPUTS), seed=SEED,
                             device=device)
    return NormalizingFlow(DynEdge(nb_inputs=NB_INPUTS), nb_targets=1,
                           target_labels=("log10_energy",), transform=kind,
                           seed=SEED, device=device)


def train_targets(torch, batch, events, counters, names, dev, smi, tmp):
    """The train_targets phase: the nine-head model trained (step 1
    against the CPU) and served from the port's ``model.yml`` +
    ``state_dict.pkl`` through ``DeploymentModule`` against the CPU; the
    three flows trained, each flow's ``log_prob`` on ``TARGET_GRID``
    targets against the CPU; and the energy model trained on ``Uniform``
    weights fitted into a copy of the database.  Yields one report a
    group."""
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.config import load_model
    from graphnet_tpu_torch.utils.jax_params import load_jax_state_dict

    fwd, step = launches_of(names, 5), launches_of(names, 5, fwd=False)
    t0 = time.perf_counter()
    yml, pkl = nine_head_model(torch, "cpu", batch, tmp)

    def make_heads(device):
        m = load_model(yml, device=device)
        m.load_state_dict(load_jax_state_dict(pkl, m.state_dict()))
        return m

    # the random backbone's latents reach ~1e4 (sum pooling), so a step
    # of 1e-3 a parameter moves the pow10 head out of float32's range
    report, _, _, _, _ = target_step(torch, make_heads, Trainer, batch, counters,
                                     step, dev, lr=1e-5)
    gpu = DeploymentModule(yml, pkl, device=dev)
    cpu = DeploymentModule(yml, pkl, device="cpu")
    longest = sorted(events, key=lambda e: -e.n_pulses)[:16]
    requests = {f"db_all_{len(events)}": events, "db_longest_16": longest}
    _, served, rep = serve(torch, gpu, cpu, requests, counters, fwd, dev,
                           collate_events, column_atol=1e-3)
    yield {"group": "nine_heads", "heads": gpu.prediction_columns, "card": smi,
           **report, "served": rep,
           "launches_serving": dict(zip(names, served)),
           "seconds": time.perf_counter() - t0}

    for kind in ("sinh_arcsinh", "spline", "spherical"):
        t0 = time.perf_counter()
        rep, cpu_flow, fed_flow, _, launches = target_step(
            torch, lambda d: flow_model(kind, d), Trainer, batch, counters,
            step, dev)
        # after step 1 on both: the CPU's grid, its graphs fed to the card
        on_card = batch.to(dev)
        grid_graphs = []
        handles = record_adjacency(cpu_flow, grid_graphs)
        ref = flow_grid(torch, cpu_flow, batch, kind)
        for h in handles:
            h.remove()
        handles = feed_adjacency(fed_flow, grid_graphs, dev)
        fed_batch = replace(on_card, edges=grid_graphs[0][0].to(dev),
                            edge_mask=grid_graphs[0][1].to(dev))
        got = flow_grid(torch, fed_flow, fed_batch, kind)
        for h in handles:
            h.remove()
        assert np.isfinite(got).all() and got.shape == (TARGET_GRID, batch.batch_size)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= 1e-3, f"{kind}: log_prob grid off the CPU by {err} of its max"
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            fed_flow.eval()
            if kind == "spherical":
                md = fed_flow.mean_direction(on_card)
                assert torch.allclose(md.norm(dim=1), torch.ones_like(md[:, 0]))
            else:
                draws = fed_flow.sample(on_card, torch.Generator(device=dev)
                                        .manual_seed(SEED), n_samples=16)
                assert draws.shape == (batch.batch_size, 16, 1)
                assert bool(torch.isfinite(draws).all())
        assert [c.launches for c in counters] == fwd
        yield {"group": f"flow_{kind}", "card": smi, **rep,
               "log_prob_grid_rel_err": err, "grid": TARGET_GRID,
               "launches": dict(zip(names, launches)),
               "seconds": time.perf_counter() - t0}

    yield weighted_run(torch, counters, names, dev, smi, tmp, step)


def weighted_run(torch, counters, names, dev, smi, tmp, step):
    """``Uniform`` weights of log10 injection energy fitted into a copy of
    the database, read back through ``loss_weight_table`` /
    ``loss_weight_column`` and weighting the energy head's loss (the
    train phase's model, as a task's ``loss_weight``): a few steps, every
    batch's weights those of the table."""
    import sqlite3

    from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.training.weight_fitting import Uniform

    t0 = time.perf_counter()
    db = os.path.join(tmp, "weighted.db")
    shutil.copy(EXAMPLE_SQLITE_DATA, db)
    table = Uniform(db, truth_table="mc_truth").fit(
        bins=np.arange(0, 5, 0.1), variable="injection_energy",
        transform=np.log10, add_to_database=True)
    col = "injection_energy_uniform_weight"
    fit_s = time.perf_counter() - t0
    ds = targets_dataset(db, loss_weight_table=col, loss_weight_column=col)
    loader = DataLoader(ds, batch_size=16, shuffle=True, seed=SEED)
    with sqlite3.connect(db) as con:
        stored = dict(con.execute(f"select event_no, {col} from {col}").fetchall())
    model = StandardModel(
        DynEdge(nb_inputs=NB_INPUTS),
        [EnergyReconstruction(hidden_size=128, loss_function=LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10,
                              loss_weight=col)], seed=SEED, device=dev)
    first = next(iter(DataLoader(ds, batch_size=len(ds))))
    scale_heads(torch, model, first.to(dev))
    trainer = Trainer(model)
    losses, rose = [], []
    for batch in loader:
        w = batch.labels[col].numpy()
        ids = batch.labels["event_no"].numpy().astype(int)
        assert np.array_equal(w, np.float32([stored[i] for i in ids])), (
            "batch weights differ from the fitted table")
        before = [c.launches for c in counters]
        losses.append(float(trainer.train_step(batch)))
        rose.append([c.launches - b for c, b in zip(counters, before)])
    assert all(r == step for r in rose), rose
    assert np.isfinite(losses).all()
    nonzero = [n for n, p in model.named_parameters()
               if p.grad is not None and bool(p.grad.any())]
    assert len(nonzero) == len(list(model.parameters()))
    return {"group": "weighted_uniform", "card": smi, "weight_column": col,
            "weights_fitted": len(table[col]),
            "weight_range": [float(np.nanmin(table[col])),
                             float(np.nanmax(table[col]))],
            "fit_seconds": fit_s, "steps": len(losses), "losses": losses,
            "launches_per_step": rose,
            "seconds": time.perf_counter() - t0}


def targets_examples(torch, device, counters, names, smi, tmp):
    """The four examples of the other targets on ``device`` (in this
    process): the two weight fitters (into copies in ``tmp``; the bundled
    database left as it was) and the flow and multiclass trainings for
    one epoch, each with 5 kNN launches for each 4 EdgeConv forward
    launches (one DynEdge forward each) and 4 EdgeConv backward launches
    a step."""
    import importlib
    import sqlite3

    from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA

    with sqlite3.connect(EXAMPLE_SQLITE_DATA) as con:
        tables = con.execute("select name from sqlite_master").fetchall()
    report = []
    for name in ("fit_uniform_weights", "fit_bjoern_low_weights",
                 "train_normalizing_flow", "train_multiclass_from_configs"):
        example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        if name.startswith("fit_"):
            table = example.main(["--output", os.path.join(tmp, name + ".db")])
            steps, rows = 0, len(next(iter(table.values())))
            assert np.isfinite(list(table.values())[-1]).all()
        else:
            out = example.main(["--device", str(device), "--max-epochs", "1"])
            trainer = out["trainer"] if isinstance(out, dict) else out
            steps, rows = trainer.step, None
            assert steps > 0
        seconds = time.perf_counter() - t0
        launches = dict(zip(names, [c.launches for c in counters]))
        if steps:
            assert 4 * launches["knn"] == 5 * launches["edgeconv"] and (
                launches["edgeconv_bwd"] == 4 * steps), (name, launches)
        report.append({"example": name, "seconds": seconds, "steps": steps,
                       "rows": rows, "launches": launches})
    with sqlite3.connect(EXAMPLE_SQLITE_DATA) as con:
        assert con.execute("select name from sqlite_master").fetchall() == tables
    return {"examples": report, "card": smi}


# ------------------------------------------------------- the input pipeline

PIPELINE_EVENTS = 512
PIPELINE_B = 32
PIPELINE_K = 4
PIPELINE_EPOCHS = 2


def pipeline_loader(db, stack_k=0):
    """The high-throughput example's loader over the database ``db``:
    ``SQLiteDataset`` with ``KNNGraph(Prometheus())``, batches of 32 from
    the default ``auto:2`` buckets, shuffled from seed 0, two loader
    threads, ``drop_last``, and ``stack_k``."""
    from graphnet_tpu_torch.data.constants import FEATURES as DATA_FEATURES
    from graphnet_tpu_torch.data.constants import TRUTH
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu_torch.models.detector.prometheus import Prometheus
    from graphnet_tpu_torch.models.graphs import KNNGraph

    dataset = SQLiteDataset(
        path=db, graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total", features=DATA_FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS, truth_table="mc_truth")
    return DataLoader(dataset, batch_size=PIPELINE_B, shuffle=True, seed=0,
                      num_workers=2, drop_last=True, stack_k=stack_k)


class EpochRates:
    """A metric logger that keeps each epoch's events/s."""

    def __init__(self):
        self.events_per_s = []

    def log_metrics(self, metrics, step):
        if "events_per_s" in metrics:
            self.events_per_s.append(metrics["events_per_s"])


class OnCard:
    """A loader wrapper that records, for each epoch, whether every
    tensor of each batch it passed on was on ``device`` already."""

    def __init__(self, loader, device):
        self.loader, self.device, self.epochs = loader, device, []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        seen = []
        for batch in self.loader:
            seen.append(all(t.device.type == self.device.type
                            for t in batch.tensors().values()))
            yield batch
        self.epochs.append(seen)


def record_steps(trainer, counters, first=None):
    """Wrap ``trainer.train_step``: per step the launch counts risen and
    the loss (a device tensor, read after the run, so the steps stay
    free of host syncs); with a dict ``first``, step 1's batch, loss,
    gradients and per-layer adjacency go into it."""
    model = trainer.model
    steps, store = [], []
    n_conv = len(model_convs(model))
    handles = record_adjacency(model, store) if first is not None else []
    inner = trainer.train_step

    def recording(batch):
        before = [c.launches for c in counters]
        loss = inner(batch)
        steps.append(([c.launches - b for c, b in zip(counters, before)],
                      loss))
        if handles and len(steps) == 1:
            for h in handles:
                h.remove()
            first.update(
                batch=batch.to("cpu"), loss=float(loss),
                grads={n: p.grad.float().cpu()
                       for n, p in model.named_parameters()},
                graphs=[(i.cpu(), m.cpu()) for i, m in store[:n_conv]])
        return loss

    trainer.train_step = recording
    return steps


def pipeline_route(torch, make, Trainer, loader, counters, dev, dtype,
                   prefetch=0, first=None):
    """``Trainer(steps_per_dispatch=4).fit`` of a new model from
    ``make(dev, dtype)`` over ``loader`` for two epochs, the counts set
    to 0 just before: per step its launches and loss, each epoch's
    events/s, the launches of the run and the final parameters."""
    rates = EpochRates()
    trainer = Trainer(make(dev, dtype), steps_per_dispatch=PIPELINE_K,
                      metric_logger=rates)
    steps = record_steps(trainer, counters, first)
    for c in counters:
        c.launches = 0
    history = trainer.fit(loader, max_epochs=PIPELINE_EPOCHS,
                          prefetch=prefetch)
    launches = [c.launches for c in counters]
    return {
        "losses": [float(loss) for _, loss in steps],
        "rose": [r for r, _ in steps],
        "events_per_s": rates.events_per_s,
        "train_loss": history["train_loss"],
        "launches": launches,
        "params": {n: p.detach().float().cpu()
                   for n, p in trainer.model.named_parameters()},
    }


def group_major(batches):
    """``batches`` in a store's replay order without shuffling: grouped
    by signature, the groups in order of first appearance."""
    groups = {}
    for b in batches:
        groups.setdefault(b.signature(), []).append(b)
    return [b for g in groups.values() for b in g]


def same_bits(torch, a, b):
    """Whether two batches hold the same tensors, bit for bit."""
    ta, tb = a.tensors(), b.tensors()
    return list(ta) == list(tb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(ta.values(), tb.values()))


def unstacked(item):
    """The batches of a loader's item (a StackedBatches or one batch)."""
    return item.unstack() if hasattr(item, "unstack") else [item]


def loader_host_ms(loader):
    """The loader's host work for one batch of 32, in this thread: the
    whole batch as the loader runs it (``_one_batch``: fetch, graph
    build, collate; the native routes), and its two parts with a native
    and a plain route, each function called directly: the batched SQL
    queries through the native fetch and through ``sqlite3``, and the
    padding through the native library and through numpy."""
    from graphnet_tpu_torch.batch import bucket_for_length, pad_events
    from graphnet_tpu_torch.native import native_pad_events

    ds = loader.dataset
    idxs = next(iter(loader._batches()))
    event_nos = [ds._get_event_index(i) for i in idxs]
    queries = [(ds.batch_sql(pm, ds._features, event_nos, ds._selection),
                len(ds._features) + 1) for pm in ds._pulsemaps]
    queries.append((ds.batch_sql(ds._truth_table, ds._truth[1:], event_nos),
                    len(ds._truth)))
    ds._establish_connection(idxs[0])
    for sql, n in queries:
        assert np.array_equal(ds.rows_native(sql, n, len(idxs)),
                              ds.rows_sqlite3(sql, n))
    features, _ = ds.get_batch_arrays(idxs)
    xs = ds._graph_definition.build_x_batched(features)
    L = bucket_for_length(max(len(x) for x in xs), loader.buckets)
    for a, b in zip(native_pad_events(xs, L), pad_events(xs, length=L)):
        assert np.array_equal(a, b)
    ms = {
        "batch_native": host_s(lambda: loader._one_batch(idxs), runs=15) * 1e3,
        "fetch_native": host_s(lambda: [ds.rows_native(sql, n, len(idxs))
                                        for sql, n in queries]) * 1e3,
        "fetch_sqlite3": host_s(lambda: [ds.rows_sqlite3(sql, n)
                                         for sql, n in queries]) * 1e3,
        "pad_native": host_s(lambda: native_pad_events(xs, L)) * 1e3,
        "pad_numpy": host_s(lambda: pad_events(xs, length=L)) * 1e3,
    }
    ds._close_connection()
    # the same batch with the plain parts in place of the native ones
    ms["batch_plain_derived"] = (ms["batch_native"] - ms["fetch_native"]
                                 - ms["pad_native"] + ms["fetch_sqlite3"]
                                 + ms["pad_numpy"])
    return {"B": len(idxs), "L": L, "ms": ms}


def route_s_idle(torch, trainer, loader, dev, calls=5):
    """The device's idle share over ``calls`` steps of route S with its
    pipeline running: one stack taken first (warm-up), then the steps on
    the views of the next stacks, each stack copied by the pipeline's
    producer."""
    from graphnet_tpu_torch.data.prefetch import EpochPipeline

    with EpochPipeline(loader, 1, prefetch=PIPELINE_K, device=dev) as pipe:
        items = pipe.epoch()
        trainer.train_steps(unstacked(next(items)))

        def views():
            for item in items:
                yield from unstacked(item)

        it = views()
        prof = device_profile(torch, lambda: trainer.train_step(next(it)),
                              calls=calls)
        for _ in it:  # the epoch's end marker
            pass
    return prof


ROUTE_S_PROCESS = r"""
import json, pickle, sys
import torch
import chip_smoke as cs
from graphnet_tpu_torch.training.trainer import Trainer
db, tree_pkl, dtypes = sys.argv[1:4]
with open(tree_pkl, "rb") as f:
    tree = pickle.load(f)
dev = torch.device("cuda")
profiles = {}
for dtype in dtypes.split(","):
    trainer = Trainer(cs.dynedge_energy_trainable(
        tree, dev, None if dtype == "float32" else dtype))
    loader = cs.pipeline_loader(db, stack_k=cs.PIPELINE_K)
    profiles[dtype] = cs.route_s_idle(torch, trainer, loader, dev)
print(json.dumps(profiles))
"""


def route_s_idle_process(db, tree, dtypes, tmp):
    """:func:`route_s_idle` of the model with the JAX-layout weights
    ``tree`` in each of ``dtypes``, in one new process, so that this
    process runs no extra profiler session: after extra sessions a later
    one now and then records no device activity at all (the times
    phase's kNN checks failed so once with zoo requests profiled in
    their phase, and once with these steps profiled here)."""
    pkl = os.path.join(tmp, "train_tree.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(tree, f)
    done = subprocess.run(
        [sys.executable, "-c", ROUTE_S_PROCESS, db, pkl, ",".join(dtypes)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def train_pipeline(torch, make, Trainer, counters, expect, dev, tmp, smi,
                   idle, dtype=None):
    """The input pipeline of ``examples/03_training/08_high_throughput_
    pipeline.py`` (the synthetic database of 512 events, seed 0; loader
    threads, native fetch and padding) training the full-width DynEdge
    energy model from ``make(device, dtype)`` two epochs each route:

    * P: ``steps_per_dispatch=4``, no stacking, no prefetch;
    * S: ``DataLoader(stack_k=4)``, ``steps_per_dispatch=4``,
      ``prefetch=4``: the same steps in the same order, so the same
      losses and parameters as P within 1e-5 of each parameter's max;
    * M: ``materialize`` the loader, its replay without shuffling equal
      to the loader's batches bit for bit, then
      ``MaterializedLoader(stack_k=4)`` with ``prefetch=4``;
    * C: ``CachingLoader(store="device")``: from epoch 1 on every
      batch on the card already.

    Every step of every route launches ``expect`` and has a finite loss;
    the native padding and SQLite counters rise.  In fp32 step 1 of S is
    held against the port on the CPU fed the card's adjacency (loss rtol
    1e-3, each gradient within 1e-3 of its max).  ``idle(db, dtype)``
    gives the profile of route S's steps (:func:`route_s_idle_process`
    on the card)."""
    from graphnet_tpu_torch import native
    from graphnet_tpu_torch.data.materialized import (
        MaterializedLoader,
        materialize,
    )
    from graphnet_tpu_torch.data.prefetch import CachingLoader
    from graphnet_tpu_torch.datasets.synthetic import cached_prometheus_db

    db = cached_prometheus_db(PIPELINE_EVENTS, seed=0, cache_dir=tmp)
    native_before = (native.native_pad_events.calls,
                     native.sqlite_fetch_f64.calls)
    first = {} if dtype is None else None
    routes = {}
    routes["P"] = pipeline_route(torch, make, Trainer, pipeline_loader(db),
                                 counters, dev, dtype)
    routes["S"] = pipeline_route(torch, make, Trainer,
                                 pipeline_loader(db, stack_k=PIPELINE_K),
                                 counters, dev, dtype, prefetch=PIPELINE_K,
                                 first=first)
    loader = pipeline_loader(db)
    store = os.path.join(tmp, f"store_{dtype or 'float32'}")
    meta = materialize(loader, store)
    replay = list(MaterializedLoader(store, shuffle=False, device=dev,
                                     to_device=False))
    batches = group_major(list(loader))
    assert len(replay) == len(batches) == meta["n_batches"]
    assert all(same_bits(torch, a, b) for a, b in zip(replay, batches)), (
        "the store's replay differs from the loader's batches")
    routes["M"] = pipeline_route(
        torch, make, Trainer,
        MaterializedLoader(store, stack_k=PIPELINE_K, device=dev),
        counters, dev, dtype, prefetch=PIPELINE_K)
    cache = OnCard(CachingLoader(pipeline_loader(db), store="device",
                                 device=dev), dev)
    routes["C"] = pipeline_route(torch, make, Trainer, cache, counters, dev,
                                 dtype)
    assert len(cache.epochs) == PIPELINE_EPOCHS and all(
        all(e) for e in cache.epochs[1:]), cache.epochs
    native_calls = {
        "native_pad_events": native.native_pad_events.calls - native_before[0],
        "sqlite_fetch_f64": native.sqlite_fetch_f64.calls - native_before[1]}
    assert all(n > 0 for n in native_calls.values()), native_calls

    for key, r in routes.items():
        assert r["rose"] and all(x == expect for x in r["rose"]), (key,
                                                                    r["rose"])
        assert np.isfinite(r["losses"]).all(), (key, r["losses"])
    p, s = routes["P"], routes["S"]
    assert len(p["losses"]) == len(s["losses"])
    np.testing.assert_allclose(s["losses"], p["losses"], rtol=1e-5,
                               err_msg="S's losses against P's")
    param_err = {}
    for name, a in p["params"].items():
        e = float((s["params"][name] - a).abs().max())
        scale = float(a.abs().max())
        assert e <= 1e-5 * scale, f"{name}: S off P by {e} of max {scale}"
        param_err[name] = e / scale if scale else e
    bit_equal = (s["losses"] == p["losses"] and all(
        torch.equal(s["params"][n], a) for n, a in p["params"].items()))

    report = {
        "dtype": dtype or "float32", "card": smi,
        "events": PIPELINE_EVENTS, "batch_size": PIPELINE_B,
        "stack_k": PIPELINE_K, "epochs": PIPELINE_EPOCHS,
        "store_batches": meta["n_batches"],
        "store_groups": len(meta["groups"]),
        "routes": {k: {"steps": len(r["losses"]),
                       "events_per_s_per_epoch": r["events_per_s"],
                       "train_loss": r["train_loss"],
                       "launches": r["launches"]}
                   for k, r in routes.items()},
        "launches_per_step": expect,
        "s_equals_p_bit_for_bit": bit_equal,
        "s_p_max_param_rel_err": max(param_err.values()),
        "replay_equals_loader": True,
        "cache_on_card_from_epoch_1": True,
        "native_calls": native_calls,
    }

    # step 1 of S on the CPU, fed the card's adjacency
    if first is not None:
        cpu_model = make("cpu", None)
        graphs = first["graphs"]
        hooks = feed_adjacency(cpu_model, graphs, "cpu")
        batch = replace(first["batch"], edges=graphs[0][0],
                        edge_mask=graphs[0][1])
        cpu = run_steps(torch, Trainer(cpu_model), [batch])
        for h in hooks:
            h.remove()
        loss_err = abs(first["loss"] - cpu["loss"][0]) / abs(cpu["loss"][0])
        assert loss_err <= 1e-3, (first["loss"], cpu["loss"][0])
        grad_err = {}
        for name, gc in cpu["grads1"].items():
            e = float((first["grads"][name] - gc).abs().max())
            scale = float(gc.abs().max())
            assert e <= 1e-3 * scale, (
                f"step-1 gradient of {name}: {e} vs max {scale}")
            grad_err[name] = e / scale if scale else 0.0
        report.update(step1_loss_card=first["loss"],
                      step1_loss_cpu=cpu["loss"][0],
                      step1_loss_rel_err=loss_err,
                      step1_max_grad_rel_err=max(grad_err.values()),
                      step1_batch_shape=list(first["batch"].x.shape),
                      gxx=native.gxx_version(),
                      loader_host=loader_host_ms(pipeline_loader(db)))

    # step ms on one batch of the pipeline, and the idle share of route S
    first_batch = next(iter(pipeline_loader(db))).to(dev)
    report["step"] = {"B": first_batch.batch_size,
                      "L": first_batch.max_length,
                      **train_times(torch, Trainer(make(dev, dtype)),
                                    first_batch)}
    report["route_s_5_steps"] = idle(db, dtype)
    return report


def pipeline_examples(torch, device, counters, names, smi):
    """The two pipeline examples' command lines on ``device``
    (``materialize_and_replay``; ``high_throughput_pipeline`` for one
    epoch), in this process, with their launches and seconds."""
    from graphnet_tpu_torch.examples import (
        high_throughput_pipeline,
        materialize_and_replay,
    )

    report = []
    for module, argv in (
            (materialize_and_replay, ["--device", str(device)]),
            (high_throughput_pipeline, ["--device", str(device),
                                        "--max-epochs", "1"])):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trainer = module.main(argv)
        seconds = time.perf_counter() - t0
        assert trainer.step > 0
        report.append({"example": module.__name__.rsplit(".", 1)[1],
                       "seconds": seconds, "steps": trainer.step,
                       "launches": dict(zip(names, [c.launches
                                                    for c in counters]))})
    return {"examples": report, "card": smi}


def serving_queue_phase(torch, module, events, counters, expect):
    """``serve_events_parallel`` (QUEUE_THREADS threads, batches of at
    most QUEUE_MAX_BATCH) against one direct call of ``module`` (a
    DynEdge ``DeploymentModule``) on the same events: each answer in its
    place and within CONFIG_RTOL of the direct one unless a kNN graph of
    the event differs between its queue batch and the direct batch; the
    launches of the queue's forwards (``expect`` each).  Then, timed:
    events/s of ``serve_events_parallel`` and each event's latency from
    its submit to its answer through the same queue."""
    from concurrent.futures import ThreadPoolExecutor

    from graphnet_tpu_torch.deployment.serving_queue import (
        ServingQueue,
        serve_events_parallel,
    )

    index = {id(e): i for i, e in enumerate(events)}
    direct_rec = []
    handles = _record(module, direct_rec)
    direct = module(events)
    for h in handles:
        h.remove()
    direct_rows = {i: j for j, i in enumerate(
        i for i, e in enumerate(events) if e.n_pulses > 0)}

    batches = []
    for c in counters:
        c.launches = 0

    def recording(evs):
        rec = []
        handles = _record(module, rec)
        out = module(evs)
        for h in handles:
            h.remove()
        batches.append(([index[id(e)] for e in evs], rec))
        return out

    got = np.stack(serve_events_parallel(
        recording, events, n_workers=QUEUE_THREADS, max_batch=QUEUE_MAX_BATCH))
    launches = [c.launches for c in counters]
    assert launches == [n * len(batches) for n in expect], (
        f"queue: launches {launches} over {len(batches)} forwards, not "
        f"{expect} each")
    flips = set()
    for ids, rec in batches:
        kept = [i for i in ids if events[i].n_pulses > 0]
        flips |= graph_flips(torch, rec, direct_rec, {
            i: (j, direct_rows[i], events[i].n_pulses)
            for j, i in enumerate(kept)})
    assert sorted(i for ids, _ in batches for i in ids) == list(range(len(events)))
    rel = np.abs(got - direct) / np.maximum(
        np.abs(direct), CONFIG_FLOOR * np.abs(direct).max(axis=0))
    close = (rel <= CONFIG_RTOL).all(1)
    unexplained = np.flatnonzero(~close & ~np.isin(np.arange(len(events)),
                                                   list(flips)))
    assert unexplained.size == 0, (
        f"queue: events {unexplained.tolist()} differ from the direct call "
        "with no kNN flip")
    assert np.isfinite(got).all()

    def one_run():
        t0 = time.perf_counter()
        serve_events_parallel(module, events, n_workers=QUEUE_THREADS,
                              max_batch=QUEUE_MAX_BATCH)
        return time.perf_counter() - t0

    walls = [one_run() for _ in range(3)]
    latencies = []
    with ServingQueue(module, max_batch=QUEUE_MAX_BATCH) as sq:
        def timed_submit(e):
            t0 = time.perf_counter()
            fut = sq.submit(e)
            fut.add_done_callback(
                lambda f: latencies.append(time.perf_counter() - t0))
            return fut

        t0 = time.perf_counter()
        with ThreadPoolExecutor(QUEUE_THREADS) as pool:
            futs = list(pool.map(timed_submit, events))
        for f in futs:
            f.result()
        timed_wall = time.perf_counter() - t0
    lat_ms = np.asarray(latencies) * 1e3
    return {
        "events": len(events), "threads": QUEUE_THREADS,
        "max_batch": QUEUE_MAX_BATCH, "forwards": len(batches),
        "batch_sizes": sorted(len(ids) for ids, _ in batches),
        "launches": launches,
        f"events_beyond_rtol_{CONFIG_RTOL}": int((~close).sum()),
        "events_with_knn_flips": len(flips),
        "max_rel_err": float(rel.max()),
        "serve_events_parallel_s": walls,
        "events_per_s": [len(events) / w for w in walls],
        "latency_run_events_per_s": len(events) / timed_wall,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "latency_max_ms": float(lat_ms.max()),
    }


class SmokeDeployer(Deployer):
    """The deployer phase's subclass: each ``.npz`` file of events
    (arrays ``e0``, ``e1``, ...) is served in one call of the first
    module, its answers saved to ``<out_dir>/<file name>.npy``."""

    def __init__(self, modules, n_workers, out_dir):
        super().__init__(modules, n_workers)
        self.out_dir = out_dir

    def _process_files(self, settings):
        from graphnet_tpu_torch.models.graphs.graph_definition import Event

        module = self._modules[0]
        for path in settings:
            with np.load(str(path)) as f:
                events = [Event(x=f[f"e{i}"], features=FEATURES)
                          for i in range(len(f.files))]
            np.save(os.path.join(self.out_dir,
                                 os.path.basename(str(path)) + ".npy"),
                    module(events))


def parallel_phase(nproc=2, device="cuda", layouts=PARALLEL_LAYOUTS,
                   width="full", long_l=PARALLEL_LONG_L):
    """The parallel phase: ``dryrun.launch`` of each layout (one full
    training step through ``Trainer(mesh=..., param_sharding=...)``,
    each against the one-process step), then the checks: every report
    ``ok``, each process's launches in the step as ``PARALLEL_DYNEDGE`` /
    ``PARALLEL_TITO`` (and on graph_long every kNN the rounds kernel's),
    FSDP's loss DP's.  Returns the reports, without the bulky graphs."""
    from graphnet_tpu_torch.parallel import dryrun

    reports = dryrun.launch(nproc, device, ",".join(layouts), width=width,
                            long_l=long_l, timeout=600, threads=2)
    by = {r["layout"]: r for r in reports}
    for r in reports:
        assert r["ok"], f"parallel {r['layout']}: {r}"
        expect = dict(PARALLEL_TITO if r["model"] == "tito"
                      else PARALLEL_DYNEDGE)
        expect["knn_rounds"] = expect["knn"] if r["L"] > 8192 else 0
        for rank, got in enumerate(r["launches_per_rank"]):
            if device == "cuda":
                assert got == expect, (
                    f"parallel {r['layout']} rank {rank}: launches {got}, "
                    f"expected {expect}")
        r["launches_expected_per_rank"] = expect
    if "dp" in by and "fsdp" in by:
        assert abs(by["fsdp"]["loss"] - by["dp"]["loss"]) <= 1e-5 * max(
            1.0, abs(by["dp"]["loss"])), (by["fsdp"]["loss"], by["dp"]["loss"])
    return reports


def collective_profiles(reports):
    """The port's ``CollectiveProfile`` from the parallel phase's counted
    collectives (rank 0's): the DP step's gradient all-reduce (DDP's
    buckets) and the DP x graph step's all-gathers (node sharding's),
    beside ``dynedge_headline_profile`` of the DP model's parameters:
    each process's DDP bytes must be its fp32 gradient, 4 bytes a
    parameter."""
    from dataclasses import asdict

    from graphnet_tpu_torch.parallel.scaling_model import (
        CollectiveProfile,
        dynedge_headline_profile,
    )

    by = {r["layout"]: r for r in reports}
    dp, graph = by["dp"], by["graph"]
    for r in (dp, graph):
        for got in r["collective_bytes_per_rank"]:
            assert got["ddp_grad"] == 4 * r["n_params"], (r["layout"], got)
    counted = CollectiveProfile(
        grad_allreduce_bytes=dp["collective_bytes_per_rank"][0]["ddp_grad"],
        halo_allgather_bytes=graph["collective_bytes_per_rank"][0]["all_gather"])
    headline = dynedge_headline_profile(dp["n_params"])
    return {"n_params_dp": dp["n_params"],
            "graph_shape": [graph["B"], graph["L"]],
            "collective_profile_counted": asdict(counted),
            "collective_profile_headline": asdict(headline),
            "collective_bytes_rank0": {
                r["layout"]: r["collective_bytes_per_rank"][0] for r in reports},
            "collective_calls_rank0": {
                r["layout"]: r["collective_calls_per_rank"][0] for r in reports}}


def deployer_phase(module, rng, tmp):
    """DEPLOY_FILES ``.npz`` files of DEPLOY_EVENTS events each (1-512
    pulses, some files with a 0-pulse event) served by SmokeDeployer in
    one process and by DEPLOY_WORKERS spawned workers (each builds the
    module anew from its model.yml and state_dict.pkl): the same answers,
    bit for bit.  A worker that fails fails the run."""
    files = []
    for i in range(DEPLOY_FILES):
        lengths = rng.integers(1, 513, DEPLOY_EVENTS)
        lengths[0] = 0 if i % 2 else lengths[0]
        path = os.path.join(tmp, f"events_{i}.npz")
        np.savez(path, **{f"e{j}": rng.standard_normal(
            (int(n), NB_INPUTS)).astype(np.float32) for j, n in enumerate(lengths)})
        files.append(path)
    outs, walls = {}, {}
    for n in (1, DEPLOY_WORKERS):
        out = os.path.join(tmp, f"out_{n}")
        os.mkdir(out)
        t0 = time.perf_counter()
        SmokeDeployer([module], n, out).run(files)
        walls[n] = time.perf_counter() - t0
        outs[n] = {name: np.load(os.path.join(out, name))
                   for name in sorted(os.listdir(out))}
    one, many = outs[1], outs[DEPLOY_WORKERS]
    assert sorted(one) == sorted(many) and len(one) == DEPLOY_FILES
    for name in one:
        assert one[name].shape == (DEPLOY_EVENTS, 1)
        assert np.array_equal(one[name], many[name], equal_nan=True), (
            f"{name}: the workers' answers differ from one process's")
    return {"files": DEPLOY_FILES, "events_per_file": DEPLOY_EVENTS,
            "workers": DEPLOY_WORKERS, "identical_files": len(one),
            "one_process_s": walls[1],
            f"{DEPLOY_WORKERS}_workers_s": walls[DEPLOY_WORKERS]}


def i3_standin():
    """The tests' IceTray stand-in (``tests/tools_torch_icetray``: an
    ``icecube`` package and ``I3Tray``) on ``sys.path``, where the
    deployer's spawned workers find it too; returns its frame maker."""
    if I3_STANDIN not in sys.path:
        sys.path.insert(0, I3_STANDIN)
    import i3_standin_frames

    return i3_standin_frames


def i3_standin_off():
    """Takes the stand-in off ``sys.path`` and its modules out of
    ``sys.modules`` (as the tests' ``icetray`` fixture does), so that
    IceTray is absent again for the later phases and their processes."""
    while I3_STANDIN in sys.path:
        sys.path.remove(I3_STANDIN)
    for name in list(sys.modules):
        if name.split(".")[0] in ("icecube", "I3Tray", "i3_standin_frames"):
            del sys.modules[name]


def i3_frames(F, rng, pool, tmp):
    """An IceCube-Upgrade-shaped GCD file (``F.fake_gcd``: a sensor at
    each distinct position of the pulse pool) and one physics frame a
    ZOO_LENGTHS entry: the pulses of :func:`zoo_raw_pulses` on the
    sensors at their positions, with its times and charges.  Returns the
    GCD file's path and the frames."""
    positions = np.unique(pool[:, :3], axis=0)
    gcd, keys = F.fake_gcd(rng, positions)
    sensor = {tuple(p): i for i, p in enumerate(positions)}
    path = os.path.join(tmp, "gcd.i3.gz")
    F.write_i3(path, gcd)
    frames = []
    for raw in zoo_raw_pulses(rng, ["dom_x", "dom_y", "dom_z", "dom_time",
                                    "charge"], pool, ZOO_LENGTHS):
        doms = [sensor[tuple(r[:3])] for r in raw]
        frames.append(F.physics_frame(rng, keys, doms, raw[:, 3], raw[:, 4]))
    return path, frames


def i3_modules(torch, directory, gcd_path, frames, F, device, rng, tmp):
    """A maker of I3 modules serving the zoo directory: the model built
    by ``load_model`` on ``device``, a GraphNeT-layout checkpoint with
    random weights ported into it (as :func:`serve_zoo`), its heads
    scaled by :func:`calibrate_heads` over the frames' events, saved with
    ``save_model``; ``make(cls, device, **kwargs)`` builds ``cls``
    (``I3InferenceModule`` or ``I3PulseCleanerModule``) from those files
    with the directory's graph definition."""
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.data.extractors.icecube import (
        I3FeatureExtractorIceCubeUpgrade,
    )
    from graphnet_tpu_torch.deployment.icecube import I3InferenceModule
    from graphnet_tpu_torch.examples.port_pretrained import (
        graphnet_state_dict,
    )
    from graphnet_tpu_torch.utils.config import load_model, save_model
    from graphnet_tpu_torch.utils.weight_port import port_state_dict

    model_path = os.path.join(ZOO_DIR, directory, "model.yml")
    gd = load_model(os.path.join(ZOO_DIR, directory, "graph_definition.yml"))
    model = load_model(model_path, device=device, seed=SEED)
    model.load_state_dict(port_state_dict(model, graphnet_state_dict(model, rng)))

    out = os.path.join(tmp, directory.replace("/", "_"))
    pkl = os.path.join(out, "state_dict.pkl")

    def make(cls, dev, model_config=model_path, state_dict=pkl, **kwargs):
        m = cls(pulsemap_extractor=I3FeatureExtractorIceCubeUpgrade(F.PULSEMAP),
                model_config=model_config, state_dict=state_dict,
                gcd_file=gcd_path, model_name="queso", device=dev, **kwargs)
        m.set_graph_definition(gd)
        return m

    probe = make(I3InferenceModule, device, model, model.state_dict())
    calibrate_heads(torch, model, {"frames": [probe._event(f) for f in frames]},
                    collate_events)
    save_model(model, out)
    return make


def i3_pulses(frame, F):
    return sum(len(p) for p in frame[F.PULSEMAP].values())


def i3_pass(torch, module, frames, read, F, counters=(), expect=()):
    """Each frame (a copy) through ``read(module, copy)``: its answers,
    each conv's recorded graphs (:func:`_record`) and the frame copies;
    the launches each frame adds must be ``expect`` (none for a frame
    without pulses)."""
    answers, records, outs = [], [], []
    for frame in frames:
        out = copy.deepcopy(frame)
        store = []
        handles = _record(module, store)
        before = [c.launches for c in counters]
        answers.append(read(module, out))
        rose = [c.launches - b for c, b in zip(counters, before)]
        for h in handles:
            h.remove()
        want = list(expect) if i3_pulses(frame, F) else [0] * len(expect)
        assert rose == want, (
            f"a frame of {i3_pulses(frame, F)} pulses launched {rose}, "
            f"not {want}")
        records.append(store)
        outs.append(out)
    return answers, records, outs


def i3_held(torch, got, exp, rec_got, rec_exp, n_pulses):
    """Each frame's answers (an ``I3Double`` row, or a row a pulse)
    within CONFIG_RTOL of the CPU's, as :func:`serve_config_dynedge`
    holds them: an entry beyond it must come with a kNN graph of the
    frame that differs between the devices.  Returns the report and the
    frames with such flips."""
    rows = [np.atleast_2d(g) for g in got], [np.atleast_2d(c) for c in exp]
    col_max = np.max(np.abs(np.concatenate(
        [c for c, n in zip(rows[1], n_pulses) if n])), axis=0)
    worst, beyond, flipped, unexplained = 0.0, 0, set(), []
    for i, (g, c, n) in enumerate(zip(*rows, n_pulses)):
        assert g.shape == c.shape, (i, g.shape, c.shape)
        if not n:
            assert np.isnan(g).all() and np.isnan(c).all()
            continue
        assert np.isfinite(g).all(), f"frame {i}: not finite"
        if graph_flips(torch, rec_got[i], rec_exp[i], {0: (0, 0, n)}):
            flipped.add(i)
        err = float(np.max(np.abs(g - c) / np.maximum(
            np.abs(c), CONFIG_FLOOR * col_max)))
        worst = max(worst, err)
        if err > CONFIG_RTOL:
            beyond += 1
            if i not in flipped:
                unexplained.append((i, n, err))
    assert not unexplained, (
        f"frames differ from the CPU with no kNN flip (frame, pulses, "
        f"error): {unexplained}")
    return {"frames": len(n_pulses), f"frames_beyond_rtol_{CONFIG_RTOL}":
            beyond, "frames_with_knn_flips": len(flipped),
            "max_rel_err": worst}, flipped


def i3_doubles(module, frame):
    assert module(frame) is True
    return np.array([frame[f"queso_{c}"].value
                     for c in module.prediction_columns])


def i3_kept(frame, cleaned, F):
    """Whether each pulse of the frame's pulse map (in its order) is in
    the cleaned map."""
    return np.array([p in cleaned.get(key, ()) for key, pulses in
                     frame[F.PULSEMAP].items() for p in pulses], bool)


def serve_i3(torch, device, rng, pool, counters, names, expect, smi, tmp):
    """Phase serve_i3: the zoo's QUESO models inside the I3 chain, on the
    tests' IceTray stand-in: frames of ZOO_LENGTHS pulses
    (:func:`i3_frames`); ``total_neutrino_energy`` through
    ``I3InferenceModule`` on ``device`` and on the CPU (each frame's
    ``I3Double`` held by :func:`i3_held`, ``expect`` launches a frame
    with pulses, none without); ``SplitInIcePulses_cleaner`` through
    ``I3PulseCleanerModule`` (its threshold the median of the CPU's
    pulse probabilities): the probabilities held the same way, the
    cleaned pulse maps equal but for pulses whose probability lies within
    CONFIG_RTOL of the threshold (counted) or in a frame whose kNN graph
    flipped; ``I3Deployer`` with both modules over I3_FILES files, in one
    process and in I3_WORKERS spawned workers: the same written frames,
    byte for byte; the host ms of one frame's inference.  Returns the
    phase's three reports."""
    from graphnet_tpu_torch.deployment.icecube import (
        I3Deployer,
        I3InferenceModule,
        I3PulseCleanerModule,
    )

    F = i3_standin()
    gcd_path, frames = i3_frames(F, rng, pool, tmp)
    n_pulses = [i3_pulses(f, F) for f in frames]
    make = i3_modules(torch, I3_ENERGY, gcd_path, frames, F, device, rng, tmp)
    gpu, cpu = make(I3InferenceModule, device), make(I3InferenceModule, "cpu")
    for c in counters:
        c.launches = 0
    got, rec_g, _ = i3_pass(torch, gpu, frames, i3_doubles, F, counters, expect)
    launches = [c.launches for c in counters]
    exp, rec_c, _ = i3_pass(torch, cpu, frames, i3_doubles, F)
    held, _ = i3_held(torch, got, exp, rec_g, rec_c, n_pulses)
    ms = {}
    for n in I3_TIMED:
        frame = frames[ZOO_LENGTHS.index(n)]
        copies = [copy.deepcopy(frame) for _ in range(I3_RUNS + 1)]
        ms[f"{n}_pulses"] = 1e3 * host_s(lambda: gpu(copies.pop()),
                                         runs=I3_RUNS, warmup=1)
    energy = {"model": I3_ENERGY, "module": "I3InferenceModule",
              "pulses": n_pulses, "columns": gpu.prediction_columns,
              **held, "launches": dict(zip(names, launches)),
              "frames_with_pulses": sum(1 for n in n_pulses if n),
              "host_ms_per_frame": ms, "card": smi}

    make = i3_modules(torch, I3_CLEANER, gcd_path, frames, F, device, rng, tmp)
    probs = lambda m, f: m.probabilities(f)  # noqa: E731
    pc, rec_cc, _ = i3_pass(torch, make(I3PulseCleanerModule, "cpu",
                                        pulsemap=F.PULSEMAP), frames, probs, F)
    threshold = float(np.median(np.concatenate([p[:, 0] for p in pc])))
    cgpu, ccpu = (make(I3PulseCleanerModule, d, pulsemap=F.PULSEMAP,
                       threshold=threshold) for d in (device, "cpu"))
    for c in counters:
        c.launches = 0
    pg, rec_cg, _ = i3_pass(torch, cgpu, frames, probs, F, counters, expect)
    held_c, flipped = i3_held(torch, pg, pc, rec_cg, rec_cc, n_pulses)
    key = f"{F.PULSEMAP}_queso_cleaned"
    clean = lambda m, f: (m(f), f[key])[1]  # noqa: E731
    cleaned_g, _, _ = i3_pass(torch, cgpu, frames, clean, F, counters, expect)
    launches_c = [c.launches for c in counters]
    cleaned_c, _, _ = i3_pass(torch, ccpu, frames, clean, F)
    tol = CONFIG_RTOL * max(threshold, CONFIG_FLOOR)
    near = differing = in_flips = kept = 0
    for i, (frame, g, c, p) in enumerate(zip(frames, cleaned_g, cleaned_c, pc)):
        kg, kc = i3_kept(frame, g, F), i3_kept(frame, c, F)
        assert np.array_equal(kc, p[:, 0] > threshold), f"frame {i}"
        kept += int(kg.sum())
        diff = kg != kc
        is_near = np.abs(p[:, 0] - threshold) <= tol
        near += int(is_near.sum())
        differing += int(diff.sum())
        bad = diff & ~is_near
        if bad.any():
            assert i in flipped, (
                f"frame {i}: {int(bad.sum())} pulses cleaned apart from the "
                "CPU, none near the threshold and no kNN flip")
            in_flips += int(bad.sum())
    cleaner = {"model": I3_CLEANER, "module": "I3PulseCleanerModule",
               "threshold": threshold, "pulses": n_pulses,
               **{f"probabilities_{k}": v for k, v in held_c.items()},
               "pulses_kept": kept, "pulses_total": sum(n_pulses),
               "pulses_cleaned_apart_from_cpu": differing,
               f"pulses_within_{CONFIG_RTOL}_of_threshold": near,
               "pulses_apart_in_flipped_frames": in_flips,
               "launches": dict(zip(names, launches_c)),
               "forwards": 2 * sum(1 for n in n_pulses if n), "card": smi}

    files = {}
    walls = {}
    for workers in (1, I3_WORKERS):
        paths = []
        for i in range(I3_FILES):
            path = os.path.join(tmp, f"i3_{workers}", f"run{i}.i3.gz")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            F.write_i3(path, [fr for f in frames[i::I3_FILES]
                              for fr in (type(f)("Q"), f)])
            paths.append(path)
        t0 = time.perf_counter()
        I3Deployer([gpu, cgpu], gcd_file=gcd_path, n_workers=workers).run(paths)
        walls[workers] = time.perf_counter() - t0
        files[workers] = [open(p.replace(".i3", "_graphnet_tpu.i3"), "rb").read()
                          for p in paths]
    assert files[1] == files[I3_WORKERS], (
        "the workers wrote other frames than one process")
    written = [f for b in files[1] for f in pickle.loads(b) if f.Stop == "P"]
    assert len(written) == len(frames)
    assert all(f"queso_{gpu.prediction_columns[0]}" in f and key in f
               for f in written)
    deployer = {"files": I3_FILES, "frames": len(written),
                "workers": I3_WORKERS, "modules": 2,
                "identical_files": len(files[1]),
                "one_process_s": walls[1],
                f"{I3_WORKERS}_workers_s": walls[I3_WORKERS]}
    return energy, cleaner, deployer


def export_phase(torch, module, requests, counters, expect, tmp, host=(),
                 nb_inputs=None, **grid):
    """Phases export*: ``module`` exported by ``DeploymentModule.
    export_serving`` into ``tmp`` on its grid (``batch_sizes``,
    ``lengths``) and every request served through ``ExportedModel``.
    Each answer is held within rtol 1e-6 to the live model at the
    artifact's shapes (``ExportedModel``'s padding with the live
    ``Predict`` of the module in each program's place: the same kernels
    in the same order, so the same bits are expected) and compared with
    the module's own answers (its own padding, which may differ: printed).
    Each program call, and each live call at its shapes, adds ``expect``
    launches; the counts are set to 0 before the exported run and read
    after it.  Also each program's export seconds and ``.pt2`` bytes, and
    the host ms of the requests in ``host`` exported and live.  Returns
    ``(answers, launches, report)``."""
    import copy

    from graphnet_tpu_torch.deployment.export import ExportedModel, Predict

    t0 = time.perf_counter()
    meta = module.export_serving(tmp, nb_inputs=nb_inputs, **grid)
    export_s = time.perf_counter() - t0
    served = ExportedModel(tmp)
    load_s = time.perf_counter() - t0 - export_s
    calls = {"exported": 0, "live": 0}

    def counted(fn, kind):
        def run(*args):
            before = [c.launches for c in counters]
            out = fn(*args)
            rose = [c.launches - b for c, b in zip(counters, before)]
            assert rose == expect, (
                f"{kind} program: launches rose by {rose}, not {expect}")
            calls[kind] += 1
            return out
        return run

    checked, live = copy.copy(served), copy.copy(served)
    checked.programs = {key: counted(p, "exported")
                        for key, p in served.programs.items()}
    live_fn = counted(Predict(module.model), "live")
    live.programs = {key: live_fn for key in served.programs}
    for c in counters:
        c.launches = 0
    answers = {label: checked(evs) for label, evs in requests.items()}
    launches = [c.launches for c in counters]
    assert calls["exported"] > 0 and all(
        (n > 0) == (e > 0) for n, e in zip(launches, expect)), launches
    report = []
    for label, evs in requests.items():
        got, ref, own = answers[label], live(evs), module(evs)
        empty = np.array([e.n_pulses == 0 for e in evs])
        assert got.shape == own.shape == (len(evs), len(
            module.prediction_columns))
        assert np.isnan(got[empty]).all() and np.isfinite(got[~empty]).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0.0,
                                   err_msg=f"{label}: artifact against live")
        scale = np.abs(ref[~empty])
        report.append({
            "request": label, "events": len(evs),
            "bit_equal_to_live_at_artifact_shapes": bool(
                np.array_equal(got, ref, equal_nan=True)),
            "max_abs_diff_to_live_at_artifact_shapes": float(
                np.abs(got[~empty] - ref[~empty]).max()),
            "max_rel_diff_to_live_at_artifact_shapes": float(
                (np.abs(got[~empty] - ref[~empty]) / scale).max()),
            "bit_equal_to_deployment_module": bool(
                np.array_equal(got, own, equal_nan=True)),
            "max_rel_diff_to_deployment_module": float(
                (np.abs(got[~empty] - own[~empty]) / np.abs(own[~empty])).max()),
        })
    host_ms = {label: {
        "exported": 1e3 * host_s(lambda: served(requests[label]), runs=11),
        "live": 1e3 * host_s(lambda: module(requests[label]), runs=11)}
        for label in host}
    return answers, launches, {
        "requests": report,
        "program_calls": calls,
        "export_s": export_s, "load_s": load_s,
        "programs": [{"file": s["file"], "export_s": s["seconds"],
                      "bytes": os.path.getsize(os.path.join(tmp, s["file"]))}
                     for s in meta["shapes"]],
        "dtype": meta["dtype"], "device": meta["device"],
        "request_host_ms": host_ms,
    }


FRESH_PROCESS = r"""
import sys
import numpy as np
from graphnet_tpu_torch.deployment.export import ExportedModel
from graphnet_tpu_torch.models.graphs.graph_definition import Event
artifact, requests, out = sys.argv[1:4]
served = ExportedModel(artifact)
with np.load(requests) as f:
    names = sorted(f.files, key=lambda n: (n.split("__")[0], int(n.split("__")[1])))
    events = {}
    for n in names:
        events.setdefault(n.split("__")[0], []).append(
            Event(x=f[n], features=[f"f{i}" for i in range(f[n].shape[1])]))
answers = {label: served(evs) for label, evs in events.items()}
np.savez(out, **answers)
print("imported_model_code=" + ",".join(
    m for m in ("graphnet_tpu_torch.models.gnn",
                "graphnet_tpu_torch.models.standard_model",
                "graphnet_tpu_torch.models.task") if m in sys.modules))
"""


def fresh_process_phase(artifact, requests, answers, tmp):
    """Phase export: the artifact served by a new process that imports
    only ``graphnet_tpu_torch.deployment.export`` (and ``Event``): it
    must not import ``graphnet_tpu_torch.models.gnn`` (nor the
    ``StandardModel`` or the tasks) and must give this process's answers
    bit for bit."""
    reqs = os.path.join(tmp, "requests.npz")
    out = os.path.join(tmp, "fresh_answers.npz")
    np.savez(reqs, **{f"{label}__{i}": e.x for label, evs in requests.items()
                      for i, e in enumerate(evs)})
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-c", FRESH_PROCESS, artifact, reqs, out],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    seconds = time.perf_counter() - t0
    assert done.returncode == 0, done.stderr[-4000:]
    imported = done.stdout.strip().splitlines()[-1].split("=", 1)[1]
    assert imported == "", f"the serving process imported {imported}"
    with np.load(out) as f:
        same = {label: bool(np.array_equal(f[label], answers[label],
                                           equal_nan=True))
                for label in requests}
    assert all(same.values()), f"a fresh process answers otherwise: {same}"
    return {"imported_model_code": [], "answers_bit_equal": same,
            "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from graphnet_tpu_torch.batch import make_batch
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.kernels import build
    from graphnet_tpu_torch.models.components.embedding import SpacetimeEncoder
    from graphnet_tpu_torch.models.components.layers import (
        _dense_rel_attention,
        dense_attention,
    )
    from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
    from graphnet_tpu_torch.models.gnn.icemix import DeepIce
    from graphnet_tpu_torch.models.graphs.graph_definition import Event
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        DirectionReconstructionWithKappa,
    )
    from graphnet_tpu_torch.ops import flash_attention_cuda as fa
    from graphnet_tpu_torch.models.components import layers
    from graphnet_tpu_torch.ops.edgeconv_cuda import (
        BWD_ROUTES,
        fused_edgeconv,
        fused_edgeconv_bwd,
        fused_edgeconv_bwd_plain,
        fused_edgeconv_knn,
        fused_edgeconv_knn_plain,
        fused_edgeconv_plain,
        output_knn_plain,
    )
    from graphnet_tpu_torch.ops.knn import knn_graph_plain
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda
    from graphnet_tpu_torch.ops import rel_flash_attention as rp
    from graphnet_tpu_torch.ops import rel_flash_attention_cuda as rc
    from graphnet_tpu_torch.training.loss_functions import VonMisesFisher3DLoss
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.config import ModelConfig, load_model, save_model
    from graphnet_tpu_torch.utils.config import build as build_config
    from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

    ops = dict(knn=knn_graph_cuda, knn_plain=knn_graph_plain,
               edgeconv=fused_edgeconv, edgeconv_plain=fused_edgeconv_plain,
               edgeconv_bwd=fused_edgeconv_bwd,
               edgeconv_bwd_plain=fused_edgeconv_bwd_plain,
               edgeconv_knn=fused_edgeconv_knn,
               edgeconv_knn_plain=fused_edgeconv_knn_plain,
               output_knn_plain=output_knn_plain)
    counters = (knn_graph_cuda, fused_edgeconv, fused_edgeconv_bwd,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, rc.rel_attention_fwd,
                rc.rel_attention_bwd_dq, rc.rel_attention_bwd_dkv,
                fused_edgeconv_knn)
    names = ("knn", "edgeconv", "edgeconv_bwd", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv", "rel_fwd", "rel_bwd_dq", "rel_bwd_dkv",
             "edgeconv_knn")
    # launches per DynEdge, TITO and DeepIce forward / step; DynEdge with
    # the fused EdgeConv + kNN switched on (L <= 128)
    dynedge_fwd, dynedge_step = [5, 4, 0, 0, 0, 0, 0, 0, 0, 0], [5, 4, 4, 0, 0, 0, 0, 0, 0, 0]
    fused_fwd, fused_step = [1, 0, 0, 0, 0, 0, 0, 0, 0, 4], [1, 0, 4, 0, 0, 0, 0, 0, 0, 4]
    tito_fwd, tito_step = [1, 4, 0, 4, 0, 0, 0, 0, 0, 0], [1, 4, 4, 4, 4, 4, 0, 0, 0, 0]
    ice_fwd, ice_step = [0, 0, 0, 15, 0, 0, 1, 0, 0, 0], [0, 0, 0, 15, 15, 15, 1, 1, 1, 0]
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peaks = PEAKS["PCIe" if "PCIe" in name else "SXM"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_assumed": peaks})

    # 2. build
    t0 = time.perf_counter()
    logs = build.build(["knn", "edgeconv", "edgeconv_knn", "edgeconv_bwd",
                        "flash_attention", "flash_attention_bwd",
                        "rel_flash_attention", "rel_flash_attention_bwd"])
    ptxas = {n: [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l or "Compiling" in l]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "ptxas": ptxas})
    # rows 5a-c: registers, shared memory and spills of each kernel
    flash_ptxas = []
    for lib, kern, entry in (
        ("flash_attention", "flash_fwd_", "flash_fwd_smem_bytes"),
        ("flash_attention_bwd", "flash_dq_", "flash_bwd_dq_smem_bytes"),
        ("flash_attention_bwd", "flash_dkv_", "flash_bwd_dkv_smem_bytes"),
    ):
        smem = getattr(build.load(lib), entry)
        smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
        for row in ptxas_table(logs[lib], kern):
            dh = int(row["kernel"].split("<")[1].rstrip(">"))
            row["dynamic_smem_bytes"] = smem(dh, int("mma" in row["kernel"]))
            flash_ptxas.append(row)
    emit({"phase": "build_flash", "kernels": flash_ptxas})
    emit({"phase": "build_rel", "kernels": rel_build_report(build, logs)})
    # row 3: each kernel of the backward; each edge kernel's dynamic
    # shared memory at DynEdge's H1=336, H2=256, k=8 on its route (the
    # 128-row fp32 kernel, ecf::bwd_edge, is no template)
    smem = build.load("edgeconv_bwd").edgeconv_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    bwd_ptxas = ptxas_table(logs["edgeconv_bwd"], "_Z")
    for row in bwd_ptxas:
        name = row["kernel"]
        if name.startswith("bwd_edge"):
            route = ("bf16" if "bf16" in name else "fp32_rows64"
                     if "<" in name else "fp32_rows128")
            row["route"] = route
            row["dynamic_smem_bytes_H1_336_H2_256_k8"] = smem(
                336, 256, K, BWD_ROUTES.index(route))
    emit({"phase": "build_edgeconv_bwd", "kernels": bwd_ptxas})
    # rows 2 and 4: each kernel's registers and spills, and at H1 = 128
    # and 336 its dynamic shared memory and blocks an SM (row 4 at L=128,
    # D=3)
    fwd_rows = []
    for lib_name, smem_fn, occ_fn, extra in (
        ("edgeconv", "edgeconv_fwd_smem_bytes", "edgeconv_fwd_blocks_per_sm",
         ()),
        ("edgeconv_knn", "edgeconv_knn_smem_bytes",
         "edgeconv_knn_blocks_per_sm", (128, 3)),
    ):
        lib = build.load(lib_name)
        smem, occ = getattr(lib, smem_fn), getattr(lib, occ_fn)
        smem.argtypes = occ.argtypes = [ctypes.c_int] * (2 + len(extra))
        smem.restype, occ.restype = ctypes.c_longlong, ctypes.c_int
        for row in ptxas_table(logs[lib_name], "_Z"):
            bf = int("bf16" in row["kernel"])
            for h1 in (128, 336):
                row[f"dynamic_smem_bytes_H1_{h1}"] = smem(h1, *extra, bf)
                row[f"blocks_per_sm_H1_{h1}"] = occ(h1, *extra, bf)
            fwd_rows.append(row)
    emit({"phase": "build_edgeconv_fwd", "kernels": fwd_rows})

    # 3. kNN kernel vs plain
    t0 = time.perf_counter()
    knn_err, report = check_knn(torch, ops, rng, dev)
    emit({"phase": "knn", "cases": report, "max_abs_d2_err": knn_err,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 4. EdgeConv forward kernel vs plain
    t0 = time.perf_counter()
    ec_err, report = check_edgeconv(torch, ops, rng, dev)
    emit({"phase": "edgeconv", "B": 128, "L": 128, "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 4b. fused EdgeConv + kNN kernel vs plain
    t0 = time.perf_counter()
    eck_err, report = check_edgeconv_knn(torch, ops, rng, dev)
    emit({"phase": "edgeconv_knn", "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 5. EdgeConv backward kernel vs plain
    t0 = time.perf_counter()
    bwd_err, report = check_edgeconv_bwd(torch, ops, rng, dev)
    emit({"phase": "edgeconv_bwd", "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})
    # 5a. row 3's max routing against row 2's winners, near-ties kept
    t0 = time.perf_counter()
    report = check_max_routing(torch, ops, np.random.default_rng(SEED + 9), dev)
    report += check_max_routing(
        torch, ops, np.random.default_rng(SEED + 10), dev, B=512, L=512,
        shapes=((128, 256), (336, 256)), dtypes=("float32",), spread=True)
    emit({"phase": "edgeconv_bwd_route", "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 5b. flash-attention kernels vs plain
    t0 = time.perf_counter()
    cases = flash_cases(torch, np.random.default_rng(SEED + 2), dev)
    # the worst errors of head dims 32 and 64, and of 16, for the kernels
    # line
    by_hd = ([c for c in cases if not c[0].startswith("Dh16_")],
             [c for c in cases if c[0].startswith("Dh16_")])
    (flash_err, report), (flash_err16, report16) = (
        check_fwd(torch, part, fa.flash_attention_fwd,
                  fa.flash_attention_plain, ("o", "lse"), FLASH_TOL)
        for part in by_hd)
    emit({"phase": "flash", "cases": report + report16,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    (flash_bwd_err, report), (flash_bwd_err16, report16) = (
        check_bwd(torch, part, flash_bwd_io(torch, fa), ("dq", "dk", "dv"),
                  FLASH_TOL) for part in by_hd)
    emit({"phase": "flash_bwd", "cases": report + report16,
          "seconds": round(time.perf_counter() - t0, 2)})
    del cases, by_hd

    # 5c. relative-bias attention kernels vs plain
    t0 = time.perf_counter()
    cases = rel_cases(torch, np.random.default_rng(SEED + 6), dev)
    # the worst errors of head dims 16 and 32, and of 64, for the kernels
    # line
    by_hd = ([c for c in cases if not c[0].endswith("_hd64")],
             [c for c in cases if c[0].endswith("_hd64")])
    (rel_err, report), (rel_err64, report64) = (
        check_fwd(torch, part, rc.rel_attention_fwd, rp.rel_attention_plain,
                  ("o", "oe", "lse"), REL_TOL, vi=4) for part in by_hd)
    emit({"phase": "rel_flash", "cases": report + report64,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    (rel_bwd_err, report), (rel_bwd_err64, report64) = (
        check_bwd(torch, part, rel_bwd_io(torch, rc, rp),
                  ("dq", "dqt", "dqb", "dk", "dv"), REL_TOL,
                  scale_of={"dqb": "dqt"}) for part in by_hd)
    emit({"phase": "rel_flash_bwd", "cases": report + report64,
          "seconds": round(time.perf_counter() - t0, 2)})
    del cases, by_hd

    # 6. the serving path through DeploymentModule
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pkl = os.path.join(tmp, "state_dict.pkl")
    tree = jax_layout_tree(rng, **FULL_WIDTH)
    with open(pkl, "wb") as f:
        pickle.dump(tree, f)

    make_model = dynedge_energy_model
    requests = make_requests(rng, Event)
    gpu = DeploymentModule(make_model("cuda"), pkl)
    cpu = DeploymentModule(make_model("cpu"), pkl, device="cpu")
    answers, launches, report = serve(
        torch, gpu, cpu, requests, counters, dynedge_fwd, dev, collate_events)
    emit({"phase": "serve", "dtype": "float32", "requests": report,
          "launches": {**dict(zip(names, launches)), "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})

    t0 = time.perf_counter()
    gpu16 = DeploymentModule(make_model("cuda", "bfloat16"), pkl)
    launches16, report = serve_bf16(gpu16, requests, answers, counters,
                                    dynedge_fwd)
    emit({"phase": "serve_bf16", "requests": report,
          "launches": {**dict(zip(names, launches16)), "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})

    # 6b. the serving requests at L <= 128 with the fused EdgeConv + kNN on
    t0 = time.perf_counter()
    fused_requests = {k: v for k, v in requests.items()
                      if k != "b128_buckets_16_512"}
    layers.FUSE_CONV_KNN = True
    fused_answers, launches_f, report = serve(
        torch, gpu, cpu, fused_requests, counters, fused_fwd, dev,
        collate_events)
    launches_f16, report16 = serve_bf16(gpu16, fused_requests, fused_answers,
                                        counters, fused_fwd)
    layers.FUSE_CONV_KNN = False
    same_graphs = {
        "float32": fused_graphs_equal(torch, layers, gpu, fused_requests),
        "bfloat16": fused_graphs_equal(torch, layers, gpu16, fused_requests)}
    emit({"phase": "serve_fused", "requests": report, "bf16": report16,
          "fuse_off_on_same_graphs": same_graphs,
          "launches": {**dict(zip(names, launches_f)),
                       "forwards": len(fused_requests)},
          "launches_bf16": dict(zip(names, launches_f16)),
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(pkl)
    os.rmdir(tmp)

    # 6c. the serving artifact: the DynEdge forward exported per (B, L)
    # through torch.export and served by ExportedModel, fp32 and bf16,
    # and with the fused EdgeConv + kNN on; the fp32 artifact also served
    # by a new process that imports no model code
    for key, module, grid, expect, reqs, host in (
        ("export", gpu, DYNEDGE_GRID, dynedge_fwd, requests,
         ("one_event", "b128_L128")),
        ("export_bf16", gpu16, DYNEDGE_GRID, dynedge_fwd, requests, ()),
        ("export_fused", gpu, FUSED_GRID, fused_fwd, fused_requests, ()),
    ):
        t0 = time.perf_counter()
        art = tempfile.mkdtemp(prefix="chip_smoke_export_")
        layers.FUSE_CONV_KNN = key == "export_fused"
        try:
            answers_x, launches_x, report = export_phase(
                torch, module, reqs, counters, expect, art, host=host, **grid)
        finally:
            layers.FUSE_CONV_KNN = False
        if key == "export":
            report["fresh_process"] = fresh_process_phase(art, reqs, answers_x,
                                                          art)
        shutil.rmtree(art)
        emit({"phase": key, "card": smi, "grid": grid, **report,
              "launches": dict(zip(names, launches_x)),
              "seconds": round(time.perf_counter() - t0, 2)})

    # 6d. the training example's path (SQLite data, DataLoader,
    # Trainer.fit) with the fused EdgeConv + kNN on
    t0 = time.perf_counter()

    layers.FUSE_CONV_KNN = True
    report, launches_sq = train_sqlite(torch, sqlite_example, Trainer, counters,
                                       fused_step, fused_fwd, dev,
                                       shuffle_seed())
    layers.FUSE_CONV_KNN = False
    emit({"phase": "train_sqlite", "dtype": "float32", **report,
          "launches": dict(zip(names, launches_sq)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7. the training path through Trainer
    train_tree = trainable_tree(tree)

    def make_trainable(device, compute_dtype=None):
        return dynedge_energy_trainable(train_tree, device, compute_dtype)

    t0 = time.perf_counter()
    batch = synthetic_batch(make_batch, np.random.default_rng(SEED))
    gpu_steps, report, launches_t = train(
        torch, make_trainable, Trainer, batch, counters, dynedge_step, dev)
    emit({"phase": "train", "dtype": "float32", **report,
          "launches": dict(zip(names, launches_t)),
          "seconds": round(time.perf_counter() - t0, 2)})

    t0 = time.perf_counter()
    report, launches_t16 = train_bf16(
        torch, make_trainable, Trainer, batch, counters, dynedge_step, dev,
        gpu_steps["loss"][0])
    emit({"phase": "train_bf16", **report,
          "launches": dict(zip(names, launches_t16)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7a. (8b.) the input pipeline: the synthetic database through the native
    # fetch and padding, stack_k, steps_per_dispatch, prefetch, the store
    # and the cache, training the same model in fp32 and bf16
    pipe_tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    t0 = time.perf_counter()
    idle = {}

    def pipeline_idle(db, dtype):  # both dtypes' profiles in one process
        if not idle:
            idle.update(route_s_idle_process(
                db, train_tree, ("float32", "bfloat16"), pipe_tmp))
        return idle[dtype or "float32"]

    report = train_pipeline(torch, make_trainable, Trainer, counters,
                            dynedge_step, dev, pipe_tmp, smi, pipeline_idle)
    emit({"phase": "train_pipeline", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    report = train_pipeline(torch, make_trainable, Trainer, counters,
                            dynedge_step, dev, pipe_tmp, smi, pipeline_idle,
                            "bfloat16")
    emit({"phase": "train_pipeline_bf16", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    report = pipeline_examples(torch, "cuda", counters, names, smi)
    emit({"phase": "train_pipeline_examples", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    shutil.rmtree(pipe_tmp)

    # 7b. TITO direction serving through DeploymentModule, B=8, L=1024
    t0 = time.perf_counter()
    tito_tree = tito_jax_layout_tree(np.random.default_rng(SEED + 1))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tito_pkl = os.path.join(tmp, "state_dict.pkl")
    with open(tito_pkl, "wb") as f:
        pickle.dump(tito_tree, f)

    def make_tito(device, compute_dtype=None):
        return StandardModel(
            DynEdgeTITO(nb_inputs=NB_INPUTS, compute_dtype=compute_dtype),
            [DirectionReconstructionWithKappa(
                hidden_size=128, loss_function=VonMisesFisher3DLoss())],
            device=device,
        )

    trng = np.random.default_rng(SEED + 4)
    tito_requests = {
        "b8_L1024": [Event(x=a, features=FEATURES)
                     for a in tito_events(trng, [TITO_L] * TITO_B)],
        "seven_with_empty": [Event(x=a, features=FEATURES) for a in tito_events(
            trng, [30, 0, 5, 1, 700, 1024, 300])],
    }
    def tito_flips(events):  # per event, whether the input kNN graph differs
        batch = collate_events(events, min_pulses=1)
        return input_graph_flips(torch, ops, batch.x, batch.mask,
                                 dev)[0][: len(events)]

    tito_gpu = DeploymentModule(make_tito("cuda"), tito_pkl)
    tito_cpu = DeploymentModule(make_tito("cpu"), tito_pkl, device="cpu")
    launches_s, report = serve_direction(
        torch, tito_gpu, tito_cpu, tito_requests, counters, tito_fwd,
        flips=tito_flips)
    emit({"phase": "serve_tito", "dtype": "float32", "requests": report,
          "launches": {**dict(zip(names, launches_s)),
                       "forwards": len(tito_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    tito_gpu16 = DeploymentModule(make_tito("cuda", "bfloat16"), tito_pkl)
    tito_cpu16 = DeploymentModule(make_tito("cpu", "bfloat16"), tito_pkl,
                                  device="cpu")
    launches_s16, report = serve_direction(
        torch, tito_gpu16, tito_cpu16, tito_requests, counters, tito_fwd,
        TITO_BF16_SERVE_TOL, flips=tito_flips)
    emit({"phase": "serve_tito_bf16", "requests": report,
          "launches": {**dict(zip(names, launches_s16)),
                       "forwards": len(tito_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(tito_pkl)
    os.rmdir(tmp)

    # 7b'. the TITO serving artifact
    t0 = time.perf_counter()
    art = tempfile.mkdtemp(prefix="chip_smoke_export_")
    tito_grid = dict(batch_sizes=(1, TITO_B), lengths=(TITO_L,))
    _, launches_xt, report = export_phase(
        torch, tito_gpu, tito_requests, counters, tito_fwd, art, **tito_grid)
    shutil.rmtree(art)
    emit({"phase": "export_tito", "card": smi, "grid": tito_grid, **report,
          "launches": dict(zip(names, launches_xt)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7c. TITO training through Trainer, B=8, L=1024
    def make_tito_trainable(device, compute_dtype=None):
        model = make_tito(device, compute_dtype)
        model.load_state_dict(params_from_jax(tito_tree, model.state_dict()))
        return model

    t0 = time.perf_counter()
    tito_batch = make_batch(tito_events(trng, [TITO_L] * TITO_B),
                            labels={"direction": unit_vectors(trng, TITO_B)},
                            length=TITO_L)
    _, report, launches_tt = train_direction(
        torch, make_tito_trainable, Trainer, tito_batch, counters, tito_step,
        dev, ops=ops)
    emit({"phase": "train_tito", "dtype": "float32", **report,
          "launches": dict(zip(names, launches_tt)),
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    _, report, launches_tt16 = train_direction(
        torch, make_tito_trainable, Trainer, tito_batch, counters, tito_step,
        dev, "bfloat16", cpu_steps=1, ops=ops, **TITO_BF16_TRAIN)
    emit({"phase": "train_tito_bf16", **report,
          "launches": dict(zip(names, launches_tt16)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7d. DeepIce direction serving through DeploymentModule: 16 events of
    # 100-768 pulses (bucket 1024), and a request with 0 and 1 pulses
    def make_ice(device, compute_dtype=None):
        return StandardModel(
            DeepIce(n_features=6, compute_dtype=compute_dtype),
            [DirectionReconstructionWithKappa(
                hidden_size=384, loss_function=VonMisesFisher3DLoss())],
            device=device,
        )

    t0 = time.perf_counter()
    ice_tree = ice_jax_layout_tree(np.random.default_rng(SEED + 7),
                                   make_ice("cpu"), params_to_jax)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    ice_pkl = os.path.join(tmp, "state_dict.pkl")
    with open(ice_pkl, "wb") as f:
        pickle.dump(ice_tree, f)
    irng = np.random.default_rng(SEED + 8)
    ice_requests = {
        f"b{ICE_B}_100_{ICE_L}": [
            Event(x=a, features=ICE_FEATURES)
            for a in ice_events(irng, irng.integers(100, ICE_L + 1, ICE_B))],
        "with_0_and_1_pulses": [Event(x=a, features=ICE_FEATURES)
                                for a in ice_events(irng, [0, 1, 300, ICE_L])],
    }
    held = {f"b{ICE_B}_100_{ICE_L}": [0, 1], "with_0_and_1_pulses": [1, 2]}
    ice_gpu = DeploymentModule(make_ice("cuda"), ice_pkl)
    ice_cpu = DeploymentModule(make_ice("cpu"), ice_pkl, device="cpu")
    launches_i, report = serve_direction(torch, ice_gpu, ice_cpu, ice_requests,
                                         counters, ice_fwd, held=held)
    emit({"phase": "serve_deepice", "dtype": "float32", "requests": report,
          "launches": {**dict(zip(names, launches_i)),
                       "forwards": len(ice_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    ice_gpu16 = DeploymentModule(make_ice("cuda", "bfloat16"), ice_pkl)
    ice_cpu16 = DeploymentModule(make_ice("cpu", "bfloat16"), ice_pkl,
                                 device="cpu")
    launches_i16, report = serve_direction(
        torch, ice_gpu16, ice_cpu16, ice_requests, counters, ice_fwd,
        ICE_BF16_SERVE_TOL, held={k: v[:1] for k, v in held.items()})
    emit({"phase": "serve_deepice_bf16", "requests": report,
          "launches": {**dict(zip(names, launches_i16)),
                       "forwards": len(ice_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(ice_pkl)
    os.rmdir(tmp)
    del ice_cpu, ice_cpu16

    # 7d'. the DeepIce serving artifacts, fp32 and bf16, at the requests'
    # shapes (B = 4 and 16 at L = 1024)
    ice_grid = dict(batch_sizes=(4, ICE_B), lengths=(ICE_SERVE_L,))
    for key, module in (("export_deepice", ice_gpu),
                        ("export_deepice_bf16", ice_gpu16)):
        t0 = time.perf_counter()
        art = tempfile.mkdtemp(prefix="chip_smoke_export_")
        _, launches_xi, report = export_phase(
            torch, module, ice_requests, counters, ice_fwd, art,
            nb_inputs=len(ICE_FEATURES), **ice_grid)
        shutil.rmtree(art)
        emit({"phase": key, "card": smi, "grid": ice_grid, **report,
              "launches": dict(zip(names, launches_xi)),
              "seconds": round(time.perf_counter() - t0, 2)})

    # 7e. DeepIce training through Trainer, B=16, L=768
    def make_ice_trainable(device, compute_dtype=None):
        model = make_ice(device, compute_dtype)
        model.load_state_dict(params_from_jax(ice_tree, model.state_dict()))
        return model

    t0 = time.perf_counter()
    ice_arrays = ice_events(irng, [ICE_L] * ICE_B)
    ice_dirs = unit_vectors(irng, ICE_B)
    ice_batch = make_batch(ice_arrays, labels={"direction": ice_dirs},
                           length=ICE_L)

    def held_batch(n):
        return make_batch(ice_arrays[:n], labels={"direction": ice_dirs[:n]},
                          length=ICE_L)

    _, report, launches_it = train_direction(
        torch, make_ice_trainable, Trainer, ice_batch, counters, ice_step, dev,
        cpu_steps=1, held=held_batch(4), **ICE_FP32_TRAIN)
    emit({"phase": "train_deepice", "dtype": "float32", **report,
          "launches": dict(zip(names, launches_it)),
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    _, report, launches_it16 = train_direction(
        torch, make_ice_trainable, Trainer, ice_batch, counters, ice_step, dev,
        "bfloat16", cpu_steps=1, held=held_batch(2), **ICE_BF16_TRAIN)
    emit({"phase": "train_deepice_bf16", **report,
          "launches": dict(zip(names, launches_it16)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7f. DeepIce B_d64 at full width on the rel kernels at head dim 64:
    # serving the DeepIce requests through DeploymentModule, and training
    # steps on the DeepIce batch, fp32 and bf16
    def make_d64(device, compute_dtype=None, rel_flash="auto"):
        spec = ModelConfig.load(ICE_D64_FILE)
        spec.arguments["backbone"]["__model__"]["arguments"].update(
            compute_dtype=compute_dtype, rel_flash=rel_flash)
        model = build_config(spec, seed=SEED, device=device)
        assert model.backbone.hidden_dim == ICE_D64_HIDDEN
        assert model.backbone.sandwich_0.attn.uses_rel_kernel(ICE_D64_HD) == (
            rel_flash != "never")
        return model

    t0 = time.perf_counter()
    d64_tree = ice_jax_layout_tree(np.random.default_rng(SEED + 10),
                                   make_d64("cpu"), params_to_jax)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    d64_pkl = os.path.join(tmp, "state_dict.pkl")
    with open(d64_pkl, "wb") as f:
        pickle.dump(d64_tree, f)
    d64_gpu = DeploymentModule(make_d64("cuda"), d64_pkl)
    d64_cpu = DeploymentModule(make_d64("cpu"), d64_pkl, device="cpu")
    launches_d, report = serve_direction(torch, d64_gpu, d64_cpu, ice_requests,
                                         counters, ice_fwd, held=held)
    emit({"phase": "serve_deepice_d64", "dtype": "float32", "requests": report,
          "launches": {**dict(zip(names, launches_d)),
                       "forwards": len(ice_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    d64_gpu16 = DeploymentModule(make_d64("cuda", "bfloat16"), d64_pkl)
    d64_cpu16 = DeploymentModule(make_d64("cpu", "bfloat16"), d64_pkl,
                                 device="cpu")
    launches_d16, report = serve_direction(
        torch, d64_gpu16, d64_cpu16, ice_requests, counters, ice_fwd,
        ICE_BF16_SERVE_TOL, held={k: v[:1] for k, v in held.items()})
    emit({"phase": "serve_deepice_d64_bf16", "requests": report,
          "launches": {**dict(zip(names, launches_d16)),
                       "forwards": len(ice_requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(d64_pkl)
    os.rmdir(tmp)
    del d64_cpu, d64_cpu16

    def make_d64_trainable(device, compute_dtype=None, rel_flash="auto"):
        model = make_d64(device, compute_dtype, rel_flash)
        model.load_state_dict(params_from_jax(d64_tree, model.state_dict()))
        return model

    t0 = time.perf_counter()
    _, report, launches_dt = train_direction(
        torch, make_d64_trainable, Trainer, ice_batch, counters, ice_step, dev,
        steps=ICE_D64_STEPS, cpu_steps=1, held=held_batch(4), **ICE_FP32_TRAIN)
    emit({"phase": "train_deepice_d64", "dtype": "float32", **report,
          "launches": dict(zip(names, launches_dt)),
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    _, report, launches_dt16 = train_direction(
        torch, make_d64_trainable, Trainer, ice_batch, counters, ice_step, dev,
        "bfloat16", steps=ICE_D64_STEPS, cpu_steps=1, held=held_batch(2),
        **ICE_D64_BF16_TRAIN)
    emit({"phase": "train_deepice_d64_bf16", **report,
          "launches": dict(zip(names, launches_dt16)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7f'. the zoo's DeepIce B_d32 on the chunked bias path (rel kernels
    # off, 4 query tiles), both routes of rel_bias_cache: the DeepIce
    # requests served in fp32 and bf16, one fp32 training step on the
    # DeepIce batch; 15 flash launches a forward, none of the rel kernels
    chunked_fwd, chunked_step = [0, 0, 0, 15, 0, 0, 0, 0, 0, 0], [0, 0, 0, 15, 15, 15, 0, 0, 0, 0]
    t0 = time.perf_counter()
    d32_tree = ice_jax_layout_tree(np.random.default_rng(SEED + 31),
                                   chunked_model("cpu"), params_to_jax)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    d32_pkl = os.path.join(tmp, "state_dict.pkl")
    with open(d32_pkl, "wb") as f:
        pickle.dump(d32_tree, f)
    launches_c, report = serve_chunked(torch, DeploymentModule, d32_pkl,
                                       ice_requests, held, counters,
                                       chunked_fwd)
    t_serve = time.perf_counter()
    launches_c16, report16 = serve_chunked(
        torch, DeploymentModule, d32_pkl, ice_requests,
        {k: v[:1] for k, v in held.items()}, counters, chunked_fwd,
        "bfloat16", ICE_BF16_SERVE_TOL)
    emit({"phase": "serve_deepice_chunked", "card": smi,
          "chunks": CHUNKED_CHUNKS, "requests": {"float32": report,
                                                 "bfloat16": report16},
          "launches": {"float32": {r: dict(zip(names, l))
                                   for r, l in launches_c.items()},
                       "bfloat16": {r: dict(zip(names, l))
                                    for r, l in launches_c16.items()},
                       "forwards_per_route": len(ice_requests)},
          "seconds_fp32": round(t_serve - t0, 2),
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(d32_pkl)
    os.rmdir(tmp)
    t0 = time.perf_counter()
    launches_ct, report = train_chunked(torch, Trainer, d32_tree, ice_batch,
                                        held_batch(1), counters, chunked_step,
                                        dev, **ICE_FP32_TRAIN)
    chunked_report = chunked_costs(torch, make_batch, Trainer, d32_tree, dev)
    emit({"phase": "train_deepice_chunked", "card": smi, "dtype": "float32",
          "chunks": CHUNKED_CHUNKS, **report,
          "launches": {r: dict(zip(names, l)) for r, l in launches_ct.items()},
          "costs_fp32": chunked_report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7f''. the curated TestDataset (SQLite) feeding the training
    # example's full-width DynEdge through Trainer.fit, the fused EdgeConv
    # + kNN off: rows 1-3; step 1 held against the CPU
    t0 = time.perf_counter()
    report, launches_cu = train_sqlite(torch, curated_example, Trainer,
                                       counters, dynedge_step, dynedge_fwd,
                                       dev, shuffle_seed())
    emit({"phase": "curated", "dtype": "float32", "dataset": "TestDataset",
          "backend": "sqlite", **report, "host_imports": host_imports(),
          "launches": dict(zip(names, launches_cu)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7g. models served from their files: load_model on the card, random
    # weights through save_model's state_dict.pkl, DeploymentModule(
    # model.yml, state_dict.pkl) on the card against the same on the CPU
    launch_expect = {"DynEdge": dynedge_fwd, "DynEdgeTITO": tito_fwd,
                     "DeepIce": ice_fwd}
    crng = np.random.default_rng(SEED + 12)
    config_modules = {}
    for label, rel in SERVE_CONFIGS:
        t0 = time.perf_counter()
        config_modules[label], report = serve_config(
            torch, os.path.join(MODELS, rel), "cuda", crng, counters, names,
            launch_expect, fused_fwd, layers, tito_flips)
        emit({"phase": "serve_config", "config": label, **report,
              "seconds": round(time.perf_counter() - t0, 2)})

    # 7g'. the pretrained zoo from its files: GraphNeT-layout checkpoints
    # ported, raw pulses through each graph definition, served on the
    # card against the CPU
    zrng = np.random.default_rng(SEED + 16)
    pool = sqlite_pulse_pool()
    for directory, expect in ZOO_LAUNCHES.items():
        t0 = time.perf_counter()
        report = serve_zoo(torch, directory, "cuda", zrng, pool, counters,
                           names, expect, smi)
        emit({"phase": "serve_zoo", **report,
              "seconds": round(time.perf_counter() - t0, 2)})

    # 7g''. GraphNeT's other five backbones at its default widths from
    # GraphNeT-layout checkpoints, served on the card against the CPU
    brng = np.random.default_rng(SEED + 17)
    backbone_launches = {}
    for kind, expect in BACKBONE_LAUNCHES.items():
        t0 = time.perf_counter()
        report = serve_backbone(torch, kind, "cuda", brng, pool, counters,
                                names, expect, smi)
        backbone_launches[kind] = [report["launches"][n] for n in names]
        emit({"phase": "serve_backbones", **report,
              "seconds": round(time.perf_counter() - t0, 2)})

    # 7g-train. the backbones trained with their dropout on from the
    # bundled database, step 1 held against the CPU fed the card's masks
    # and graphs; resume; DeepIce's remat at its cell's shape; the four
    # training examples' command lines
    trng = np.random.default_rng(SEED + 19)
    train_backbone_launches = {}
    for kind in TRAIN_BACKBONES:
        t0 = time.perf_counter()
        report = train_backbone(torch, kind, "cuda", counters, names, smi,
                                trng)
        train_backbone_launches[kind] = [report["launches"][n] for n in names]
        emit({"phase": "train_backbones", **report,
              "seconds": round(time.perf_counter() - t0, 2)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    report = resume_phase(torch, "cuda", smi, trng, tmp)
    emit({"phase": "train_backbones_resume", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()

    def make_ice_remat(remat):
        model = StandardModel(
            DeepIce(n_features=6, remat=remat),
            [DirectionReconstructionWithKappa(
                hidden_size=384, loss_function=VonMisesFisher3DLoss())],
            device=dev)
        model.load_state_dict(params_from_jax(ice_tree, model.state_dict()))
        return model

    report = remat_phase(torch, make_ice_remat, ice_batch.to(dev), smi)
    emit({"phase": "train_backbones_remat", "B": ICE_B, "L": ICE_L,
          "dtype": "float32", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    report = example_clis(torch, "cuda", counters, names, smi, tmp)
    emit({"phase": "train_backbones_examples", **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    shutil.rmtree(tmp)

    # 7g-targets. the full-width DynEdge behind each edge rule, served and
    # trained; the nine other heads, the three flows and a weighted run
    # on the bundled database; the four examples of those targets
    targets_t0 = time.perf_counter()
    tdata = targets_dataset()
    tevents = [tdata[i] for i in range(len(tdata))]
    tbatch = targets_batch(torch, tdata, np.random.default_rng(SEED + 21))
    rule_k32 = 0
    for rule in edge_rules():
        t0 = time.perf_counter()
        report = edge_rule_phase(torch, rule, train_tree, tevents, tbatch,
                                 counters, names, dev, collate_events, smi)
        rule_k32 += report["knn_k32_launches_serving"]
        emit({"phase": "edge_rules", **report,
              "seconds": round(time.perf_counter() - t0, 2)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    for report in train_targets(torch, tbatch, tevents, counters, names, dev,
                                smi, tmp):
        emit({"phase": "train_targets", **report})
    t0 = time.perf_counter()
    report = targets_examples(torch, "cuda", counters, names, smi, tmp)
    shutil.rmtree(tmp)
    emit({"phase": "targets_examples", **report,
          "seconds": round(time.perf_counter() - t0, 2),
          "targets_phases_seconds": round(time.perf_counter() - targets_t0, 2)})

    # 7h. the micro-batching queue over the energy model from its file
    t0 = time.perf_counter()
    qrng = np.random.default_rng(SEED + 13)
    queue_events = [
        Event(x=qrng.standard_normal((int(n), NB_INPUTS)).astype(np.float32),
              features=FEATURES)
        for n in qrng.integers(1, 513, QUEUE_EVENTS)]
    report = serving_queue_phase(torch, config_modules["dynedge_energy"],
                                 queue_events, counters, dynedge_fwd)
    report["launches"] = dict(zip(names, report["launches"]))
    emit({"phase": "serving_queue", "card": smi, **report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 7i. the deployer: spawned workers, each building the energy model
    # from its model.yml and state_dict.pkl
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    emodel = load_model(ENERGY_FILE, device="cuda", seed=SEED)
    emodel.load_state_dict(params_from_jax(ice_jax_layout_tree(
        np.random.default_rng(SEED + 14), emodel, params_to_jax),
        emodel.state_dict()))
    save_model(emodel, os.path.join(tmp, "model"))
    del emodel
    emodule = DeploymentModule(ENERGY_FILE,
                               os.path.join(tmp, "model", "state_dict.pkl"))
    report = deployer_phase(emodule, np.random.default_rng(SEED + 15), tmp)
    emit({"phase": "deployer", "card": smi, **report,
          "seconds": round(time.perf_counter() - t0, 2)})
    del emodule, config_modules
    shutil.rmtree(tmp)

    # 7i'. IceTray: the QUESO zoo models inside the I3 chain (the tests'
    # stand-in for IceTray): I3InferenceModule and I3PulseCleanerModule
    # on the card against the CPU, I3Deployer with spawned workers
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    i3_energy, i3_cleaner, i3_deployer = serve_i3(
        torch, "cuda", np.random.default_rng(SEED + 23), pool, counters,
        names, ZOO_LAUNCHES[I3_ENERGY], smi, tmp)
    emit({"phase": "serve_i3", **i3_energy})
    emit({"phase": "serve_i3_cleaner", **i3_cleaner})
    emit({"phase": "serve_i3_deployer", **i3_deployer,
          "seconds": round(time.perf_counter() - t0, 2)})
    shutil.rmtree(tmp)
    i3_standin_off()

    # 7j. training across processes: the dry run's layouts, two processes
    # sharing the card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    parallel = parallel_phase()
    for report in parallel:
        emit({"phase": "parallel", "card": smi, **report})
    graph_long = next(r for r in parallel if r["layout"] == "graph_long")
    rounds_launches = sum(l["knn_rounds"] for l in graph_long["launches_per_rank"])
    emit({"phase": "parallel_done", "fsdp_equals_dp": True,
          **collective_profiles(parallel),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 8. times
    t0 = time.perf_counter()
    times = kernel_times(torch, ops, rng, dev, peaks)
    times_bwd = bwd_times(torch, ops, rng, dev, peaks)
    times_bwd_queso = bwd_times(torch, ops, rng, dev, peaks, B=512, L=512,
                                queso=True)
    times_fused = fused_knn_times(torch, ops, rng, dev, peaks)
    assert_one_knn_kernel({**times["knn"], **{
        key: t for key, t in times_fused.items() if key.endswith("_knn_of_out_view")}})
    serving = requests["b128_L128"]
    single = requests["one_event"]
    on_card = batch.to(dev)
    trainer = Trainer(make_trainable(dev))
    trainer16 = Trainer(make_trainable(dev, "bfloat16"))
    tito_on_card = tito_batch.to(dev)
    tito_trainer = Trainer(make_tito_trainable(dev))
    tito_trainer16 = Trainer(make_tito_trainable(dev, "bfloat16"))
    tito_serving = tito_requests["b8_L1024"]
    flash = flash_times(torch, fa, dense_attention, dev, peaks)
    flash_rnn = flash_times(
        torch, fa, dense_attention, dev, peaks,
        shapes=[(f"B{TITO_B}_H{RNN_TITO_HEADS}_L{TITO_L}_Dh{RNN_TITO_DH}",
                 TITO_B, RNN_TITO_HEADS, TITO_L, RNN_TITO_DH, False)])
    rel = rel_times(torch, rc, rp, rc.rel_flash_attention,
                    SpacetimeEncoder(ICE_HD).to(dev), _dense_rel_attention, dev,
                    peaks)
    ice_serving = ice_requests[f"b{ICE_B}_100_{ICE_L}"]
    ice_on_card = ice_batch.to(dev)
    ice_trainer = Trainer(make_ice_trainable(dev))
    ice_trainer16 = Trainer(make_ice_trainable(dev, "bfloat16"))
    rel64 = rel_times(torch, rc, rp, rc.rel_flash_attention,
                      SpacetimeEncoder(64).to(dev), _dense_rel_attention, dev,
                      peaks, hd=64, shapes=((ICE_L, ICE_B),))
    d64_times = {
        f"serving_B{ICE_B}_100_{ICE_L}": {
            "fp32_events_per_s": ICE_B / host_s(lambda: d64_gpu(ice_serving),
                                                runs=5),
            "bf16_events_per_s": ICE_B / host_s(lambda: d64_gpu16(ice_serving),
                                                runs=5),
        },
    }
    del d64_gpu, d64_gpu16
    long_rng = np.random.default_rng(SEED + 11)
    long_batch = make_batch(
        ice_events(long_rng, [3072] * 8),
        labels={"direction": unit_vectors(long_rng, 8)}, length=3072).to(dev)
    # a training step's time and peak device memory on each route, one
    # trainer at a time (the memory allocated before the step holds the
    # run's other models too)
    for key, dtype, route, on in (
            (f"step_kernels_fp32_B{ICE_B}_L{ICE_L}", None, "auto", ice_on_card),
            (f"step_kernels_bf16_B{ICE_B}_L{ICE_L}", "bfloat16", "auto",
             ice_on_card),
            (f"step_dense_fp32_B{ICE_B}_L{ICE_L}", None, "never", ice_on_card),
            ("step_kernels_bf16_B8_L3072", "bfloat16", "auto", long_batch)):
        d64_trainer = Trainer(make_d64_trainable(dev, dtype, route))
        d64_times[key] = train_times(torch, d64_trainer, on, runs=3)
        del d64_trainer
        torch.cuda.empty_cache()
    del long_batch
    emit({
        "phase": "times", "card": smi, "kernels": times,
        "edgeconv_bwd_B128_L128": times_bwd,
        "edgeconv_bwd_B512_L512": times_bwd_queso,
        "serving_B128_L128": {
            "fp32_events_per_s": 128 / host_s(lambda: gpu(serving)),
            "bf16_events_per_s": 128 / host_s(lambda: gpu16(serving)),
            "single_event_p50_ms": 1e3 * host_s(lambda: gpu(single), runs=41),
        },
        "train_step_B128_L128": {"fp32": train_times(torch, trainer, on_card),
                                 "bf16": train_times(torch, trainer16, on_card)},
        "profile_fp32_B128_L128": device_profile(torch, lambda: gpu(serving)),
        "profile_train_fp32_B128_L128": device_profile(
            torch, lambda: trainer.train_step(on_card)),
        "edgeconv_knn_B128_L128_H1_336": times_fused,
        "launch_floor": launch_floor(torch, build),
        "fused_switch_off_on_on_off": dynedge_switch_times(
            torch, layers, gpu, gpu16, serving, single, trainer, trainer16,
            on_card),
        "flash": flash,
        "tito_serving_B8_L1024": {
            "fp32_events_per_s": TITO_B / host_s(lambda: tito_gpu(tito_serving)),
            "bf16_events_per_s": TITO_B / host_s(lambda: tito_gpu16(tito_serving)),
        },
        "tito_train_step_B8_L1024": {
            "fp32": train_times(torch, tito_trainer, tito_on_card),
            "bf16": train_times(torch, tito_trainer16, tito_on_card)},
        "profile_tito_train_fp32_B8_L1024": device_profile(
            torch, lambda: tito_trainer.train_step(tito_on_card)),
        "rel_H12_Dh32": rel,
        f"deepice_serving_B{ICE_B}_100_{ICE_L}": {
            "fp32_events_per_s": ICE_B / host_s(lambda: ice_gpu(ice_serving),
                                                runs=10),
            "bf16_events_per_s": ICE_B / host_s(lambda: ice_gpu16(ice_serving),
                                                runs=10),
        },
        f"deepice_train_step_B{ICE_B}_L{ICE_L}": {
            "fp32": train_times(torch, ice_trainer, ice_on_card, runs=10),
            "bf16": train_times(torch, ice_trainer16, ice_on_card, runs=10)},
        f"profile_deepice_train_fp32_B{ICE_B}_L{ICE_L}": device_profile(
            torch, lambda: ice_trainer.train_step(ice_on_card), calls=3),
        f"profile_deepice_train_bf16_B{ICE_B}_L{ICE_L}": device_profile(
            torch, lambda: ice_trainer16.train_step(ice_on_card), calls=3),
        "rel_H12_Dh64": rel64,
        "deepice_d64": d64_times,
        # rows 5a-c at RNN_TITO's attention shape: 16 heads of 16
        "flash_rnn_tito": flash_rnn,
        # rows 5a-c at B_d64's Block shape: 12 heads of 64, the cls key
        "flash_B_d64": flash_times(
            torch, fa, dense_attention, dev, peaks,
            shapes=[(f"B{ICE_B}_H12_L{ICE_L + 1}_Dh{ICE_D64_HD}", ICE_B, 12,
                     ICE_L + 1, ICE_D64_HD, True)]),
        "seconds": round(time.perf_counter() - t0, 2),
    })

    # 9. the kernels line
    bwd32, bwd16 = times_bwd["H1_336_float32"], times_bwd["H1_336_bfloat16"]

    def row1(shape):
        t = times["knn"][shape]
        return {key: t[key] for key in (
            "ms", "device_ms", "kernels_per_call", "host_ms", "plain_ms",
            "bound_ms", "bound_by")}

    kernels = [
        dict(name="knn", row="1", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=launches[0], launches_per="DynEdge forward: 5 (D=3)",
             launches_serve_i3=i3_energy["launches"]["knn"],
             max_abs_err=knn_err, **row1("B128_L128_D3"), library_ms=None),
        dict(name="knn_xyzt", row="1", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=launches_s[0], launches_per="TITO forward: 1 (D=4)",
             max_abs_err=knn_err, **row1("B8_L1024_D4"), library_ms=None),
        dict(name="knn_k32", row="1", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=rule_k32,
             launches_per="RadialEdges DynEdge forward: 1 at k = 32 (D=3), "
             "then 4 at k = 8",
             max_abs_err=knn_err, **row1("B128_L128_D3_k32"), library_ms=None),
        dict(name="knn_rounds_k48", row="1", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=rounds_launches,
             launches_per="the rounds kernel (k > 32 or L > 8192) on the "
             f"DP x graph step at L = {PARALLEL_LONG_L}: 5 a process, D=3, "
             "k = 8 (no main path asks k > 32 yet)",
             max_abs_err=knn_err, **row1("B128_L128_D3_k48"), library_ms=None),
        dict(name="knn_rounds_L12288", row="1", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=rounds_launches,
             launches_per=f"DP x graph step at L = {PARALLEL_LONG_L}: 5 a "
             "process (each builds the whole gathered event's graph)",
             max_abs_err=knn_err, **row1("B1_L12288_D3"), library_ms=None),
        dict(name="edgeconv_fwd", row="2", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches[1], launches_per="serving forward: 4",
             launches_serve_i3=i3_energy["launches"]["edgeconv"],
             max_abs_err=ec_err["float32"],
             **times["edgeconv_fwd"], library_ms=None),
        dict(name="edgeconv_fwd_bf16", row="2", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches16[1], launches_per="serving forward: 4",
             max_abs_err=ec_err["bfloat16"],
             **times["edgeconv_fwd_bf16"], library_ms=None),
        dict(name="edgeconv_bwd", row="3", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_bwd.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:116",
             launches=launches_t[2], launches_per="training step: 4",
             max_abs_err=bwd_err["float32"], **bwd32, library_ms=None),
        dict(name="edgeconv_bwd_bf16", row="3", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_bwd.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:116",
             launches=launches_t16[2], launches_per="training step: 4",
             max_abs_err=bwd_err["bfloat16"], **bwd16, library_ms=None),
        dict(name="edgeconv_knn", row="4", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_knn.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:414",
             launches=launches_sq[9],
             launches_per="DynEdge forward and step with FUSE_CONV_KNN: 4",
             max_abs_err=eck_err["float32"],
             **times_fused["edgeconv_knn"], library_ms=None),
        dict(name="edgeconv_knn_bf16", row="4", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_knn.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:414",
             launches=launches_f16[9],
             launches_per="serving forward with FUSE_CONV_KNN: 4",
             max_abs_err=eck_err["bfloat16"],
             **times_fused["edgeconv_knn_bf16"], library_ms=None),
    ]
    f32, b16 = flash[f"L{TITO_L}_float32"], flash[f"L{TITO_L}_bfloat16"]
    # the chunked DeepIce phases' launches of rows 5a-c by route (bf16
    # serves only); their forward: 15 a forward, their step 15 each
    chunked = {"": (launches_c, launches_ct), "_bf16": (launches_c16, {})}
    for key, fwd, bwd, t, err, bwd_e in (
        ("", launches_s, launches_tt, f32, flash_err["float32"],
         flash_bwd_err["float32"]),
        ("_bf16", launches_s16, launches_tt16, b16, flash_err["bfloat16"],
         flash_bwd_err["bfloat16"]),
    ):
        lib_bwd = t["bwd_total"]["library_ms"]
        c_fwd, c_step = chunked[key]
        kernels += [
            dict(name="flash_fwd" + key, route="cuda", row="5a",
                 source="graphnet_tpu_torch/csrc/flash_attention.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:71",
                 launches=fwd[3], launches_per="TITO forward: 4",
                 launches_deepice_chunked={r: l[3] for r, l in c_fwd.items()},
                 max_abs_err=err, **t["fwd"]),
            dict(name="flash_bwd_dq" + key, route="cuda", row="5b",
                 source="graphnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:128",
                 launches=bwd[4], launches_per="TITO training step: 4",
                 launches_deepice_chunked={r: l[4] for r, l in c_step.items()},
                 max_abs_err=bwd_e, library_ms=lib_bwd,
                 library_note="SDPA backward: dq, dk and dv in one call",
                 **t["bwd_dq"]),
            dict(name="flash_bwd_dkv" + key, route="cuda", row="5c",
                 source="graphnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:155",
                 launches=bwd[5], launches_per="TITO training step: 4",
                 launches_deepice_chunked={r: l[5] for r, l in c_step.items()},
                 max_abs_err=bwd_e, library_ms=lib_bwd,
                 library_note="SDPA backward: dq, dk and dv in one call",
                 **t["bwd_dkv"]),
        ]
    # rows 5a-c at head dim 16: the fp32 forward on RNN_TITO's serving
    # path, the fp32 backward on its training step (train_backbones); the
    # bf16 kernels have no main path yet (the port's RNN_TITO has no bf16
    # mode), and are held by the flash and flash_bwd phases only
    rnn32 = flash_rnn[f"B{TITO_B}_H{RNN_TITO_HEADS}_L{TITO_L}_Dh{RNN_TITO_DH}"
                      "_float32"]
    rnn16 = flash_rnn[f"B{TITO_B}_H{RNN_TITO_HEADS}_L{TITO_L}_Dh{RNN_TITO_DH}"
                      "_bfloat16"]
    no_path = "none: no main path yet (RNN_TITO runs in fp32 only)"
    rnn_step = train_backbone_launches["RNNTITO"]
    for key, t, err, bwd_e, on_path in (
        ("_hd16", rnn32, flash_err16["float32"], flash_bwd_err16["float32"],
         True),
        ("_hd16_bf16", rnn16, flash_err16["bfloat16"],
         flash_bwd_err16["bfloat16"], False),
    ):
        lib_bwd = t["bwd_total"]["library_ms"]
        kernels += [
            dict(name="flash_fwd" + key, route="cuda", row="5a",
                 source="graphnet_tpu_torch/csrc/flash_attention.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:71",
                 launches=backbone_launches["RNNTITO"][3] if on_path else 0,
                 launches_per=("RNN_TITO forward: 4 (16 heads of 16)"
                               if on_path else no_path),
                 main_path=on_path, max_abs_err=err, **t["fwd"]),
            dict(name="flash_bwd_dq" + key, route="cuda", row="5b",
                 source="graphnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:128",
                 launches=rnn_step[4] if on_path else 0,
                 launches_per=("RNN_TITO training step: 4 (16 heads of 16)"
                               if on_path else no_path),
                 main_path=on_path, max_abs_err=bwd_e, library_ms=lib_bwd,
                 library_note="SDPA backward: dq, dk and dv in one call",
                 **t["bwd_dq"]),
            dict(name="flash_bwd_dkv" + key, route="cuda", row="5c",
                 source="graphnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/flash_attention.py:155",
                 launches=rnn_step[5] if on_path else 0,
                 launches_per=("RNN_TITO training step: 4 (16 heads of 16)"
                               if on_path else no_path),
                 main_path=on_path, max_abs_err=bwd_e, library_ms=lib_bwd,
                 library_note="SDPA backward: dq, dk and dv in one call",
                 **t["bwd_dkv"]),
        ]
    for kern in kernels:
        assert kern["launches"] > 0 or not kern.get("main_path", True), (
            f"{kern['name']} was never launched")
    ice32, ice16 = rel[f"L{ICE_L}_B{ICE_B}_float32"], rel[f"L{ICE_L}_B{ICE_B}_bfloat16"]
    for key, fwd, step, t, err, bwd_e in (
        ("", launches_i, launches_it, ice32, rel_err["float32"],
         rel_bwd_err["float32"]),
        ("_bf16", launches_i16, launches_it16, ice16, rel_err["bfloat16"],
         rel_bwd_err["bfloat16"]),
    ):
        kernels += [
            dict(name="rel_fwd" + key, route="cuda", row="6a",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:314",
                 launches=fwd[6], launches_per="DeepIce forward: 1",
                 max_abs_err=err, library_ms=None,
                 dense_path_ms=t["dense_path_ms"],
                 rel_attention_ms=t["rel_attention_ms"], **t["fwd"]),
            dict(name="rel_bwd_dq" + key, route="cuda", row="6b",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:536",
                 launches=step[7], launches_per="DeepIce training step: 1",
                 max_abs_err=bwd_e, library_ms=None, **t["bwd_dq"]),
            dict(name="rel_bwd_dkv" + key, route="cuda", row="6c",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:619",
                 launches=step[8], launches_per="DeepIce training step: 1",
                 max_abs_err=bwd_e, library_ms=None, **t["bwd_dkv"]),
        ]
    d32, d16 = rel64[f"L{ICE_L}_B{ICE_B}_float32"], rel64[f"L{ICE_L}_B{ICE_B}_bfloat16"]
    for key, fwd, step, t, err, bwd_e in (
        ("_hd64", launches_d, launches_dt, d32, rel_err64["float32"],
         rel_bwd_err64["float32"]),
        ("_hd64_bf16", launches_d16, launches_dt16, d16, rel_err64["bfloat16"],
         rel_bwd_err64["bfloat16"]),
    ):
        kernels += [
            dict(name="rel_fwd" + key, route="cuda", row="6a",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:314",
                 launches=fwd[6], launches_per="DeepIce B_d64 forward: 1",
                 max_abs_err=err, library_ms=None,
                 dense_path_ms=t["dense_path_ms"],
                 rel_attention_ms=t["rel_attention_ms"], **t["fwd"]),
            dict(name="rel_bwd_dq" + key, route="cuda", row="6b",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:536",
                 launches=step[7],
                 launches_per="DeepIce B_d64 training step: 1",
                 max_abs_err=bwd_e, library_ms=None, **t["bwd_dq"]),
            dict(name="rel_bwd_dkv" + key, route="cuda", row="6c",
                 source="graphnet_tpu_torch/csrc/rel_flash_attention_bwd.cu",
                 replaces="graphnet_tpu/ops/rel_flash_attention.py:619",
                 launches=step[8],
                 launches_per="DeepIce B_d64 training step: 1",
                 max_abs_err=bwd_e, library_ms=None, **t["bwd_dkv"]),
        ]
    for kern in kernels:
        assert kern["launches"] > 0 or not kern.get("main_path", True), (
            f"{kern['name']} was never launched")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
