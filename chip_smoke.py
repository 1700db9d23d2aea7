#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pylops_mpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel in ``pylops_mpi_tpu_torch/csrc`` (one nvcc per source, run at
   once);
2. the normal-product kernel against its plain PyTorch version on the
   card, in f32, bf16, f16 and f64, at small shapes that stress its plan
   (ragged and unaligned widths 777, 33 and 1, one tall block, 300 small
   blocks, A one element past an aligned base) and at the main path's
   full shape; each with the plan printed first (stages, rows per stage,
   CTAs, shared memory, registers and local bytes), two calls required
   to be bitwise equal, and at the full shape times for the kernel, the
   plain version and a PyTorch library yardstick;
3. the main path as a user drives it: CGLS on MPIBlockDiag of 32
   4096×4096 MatrixMult blocks (``bench.py:make_problem`` style data made
   on the card from a seeded generator), 50 iterations of the one-sweep
   ``normal=True`` schedule with f32 storage and with bf16 storage, and
   the classic two-sweep schedule with f32 storage; each run must reach
   the known model and must have gone through the kernel; a profile of
   10 iterations gives the kernel's share of device time and the
   device's idle share;
4. a small f64 problem solved on the card and on the CPU, which must
   agree;
5. the tap-stencil kernel against its plain version on the card, for
   every tap set the derivative operators emit (forward and reversed),
   plain, with ``out_pad`` and as a three-piece slab, in f32, f64 and
   bf16 (and f16) at a ragged small shape and in f32 and bf16 at the
   full shape (65536 + 2w, 1024), with kernel, plain, library and bound
   times for the centered-3 set;
6. the derivative operators (first derivative centered-3 with edge,
   centered-5, forward; second derivative centered with edge; gradient)
   applied forward and adjoint on the (65536, 1024) f32 field, each held
   against its local formulation and passing dottest, with one kernel
   launch per axis-0 apply;
7. the second main path as a user drives it: Gradient-regularized
   post-stack CGLS on the (65536, 1024) layered impedance model (50
   iterations, f32), through the tap kernel, and the Laplacian-regularized
   ``poststack_inversion`` beside it; each with iterations per second,
   residual, model error and a profile;
8. multi-dimensional deconvolution at full width: CGLS (50 iterations,
   f32) through the twosided ``MPIMDC`` of nt 1001, 301 frequencies,
   1024 sources and receivers and 64 virtual sources (complex64 G with
   G^H kept), on data from a known model in the operator's row space;
   iterations per second, model error, residual history, one forward and
   one adjoint apply with their FFT and GEMM parts; ``models.mdd``
   beside it;
9. ``examples/reflectivity.py`` at (64, 1024, 1024): FISTA, then ISTA
   (100 iterations, eps 1e-3) for the spiky reflectivity through
   ``MPIBlockDiag`` of local ``Conv1D``, with the step size's
   ``power_iteration`` timed apart from its host draws; iterations per
   second, error, and the spike depths of three traces;
10. small f64 problems on the card and on the CPU, which must agree:
   ISTA/FISTA (soft, hard and half thresholds, complex, with a
   sparsifying transform), ``power_iteration``, ``MPIFredholm1``,
   ``FFT``'s adjoint on half-spectra with imaginary DC and Nyquist bins,
   ``examples/mdd.py``'s ``mdd``, and slice 2's regularized post-stack
   solve; and of slice 5, ``MPIVStack`` and ``MPIHStack`` (batched and
   heterogeneous rows), ``MPIHalo`` with tuple halos,
   ``MPINonStationaryConvolve1D``, and ``examples/lsm.py``'s ``lsm`` (five
   iterations) with its travel-time tables required equal;
11. the stacking operators on slice 1's 32 blocks of 4096x4096:
   ``MPIVStack`` with f32 and bf16 storage, one forward and one adjoint
   apply against the byte bound and the plain product, CGLS (50
   iterations) on the overdetermined (131072 x 4096) system from a known
   model, and ``MPIHStack`` of the same blocks against
   ``MPIVStack(...).H`` and the plain sum;
12. non-stationary deconvolution: CGLS (50 iterations) through
   ``MPINonStationaryConvolve1D`` on a (2048, 16384) field with 32 41-tap
   Ricker filters whose frequency falls with depth, on data from a
   seeded sparse reflectivity; apply times against the byte bound and
   the JAX package's shifted-pass formulation, a profile and the idle
   share;
13. least-squares Kirchhoff migration at full width (``examples/lsm.py``
   widened to a (201, 401) image, 64 x 256 traces of 1800 samples): the
   table build, forward and adjoint applies split into spray, gather,
   Conv1D and other device time, CGLS (50 iterations) that must recover
   both interfaces with a non-increasing cost, peak device memory, and
   ``models.lsm`` end to end.

14. the process group on the card: the main path (f32 and bf16 storage
   with ``normal=True``, classic f32) and the Gradient-regularized
   post-stack CGLS through a group of one rank over NCCL, each x held
   to the no-group run's (bitwise, or 1e-6 relative), timed in pairs
   of alternating order against the same solves with the collectives
   stubbed out (what they do without a group) while the group stays
   up: iterations per second of both, the median and spread of the
   pairs' ratio, collective calls and kernel launches per iteration;
15. two and three ranks sharing the card over gloo (spawned processes,
   exchanges staged through the host), for correctness only: the main
   path at full width (each rank its chunk of the 32 blocks) and the
   post-stack CGLS against phase 14 within 1e-5, a ragged f64 case
   against one CPU process within 1e-10, and every rank's launches of
   the normal kernel and of the tap kernel on received ghost rows;
16. this slice's operators across two to four ranks sharing the card
   over gloo, each configuration first solved with no group here: CGLS
   (10 iterations) through ``MPIVStack`` of the 32 blocks (f32 and bf16
   storage) and ``models.mdd`` at phase 8's width at 2 and 3 ranks, the
   non-stationary deconvolution of phase 12 at 2 and 4, LSM at phase
   13's width at 2 and 3 (forward, adjoint, x after one iteration, and
   five iterations in f64: in f32 they scatter with summation order),
   each rank building only its share of the MDD kernel
   and of the LSM tables (held to about 1/P of one rank's), and a
   ragged f64 case (a 2-D halo grid, ``MPIHStack``, a masked
   ``MPIVStack``, a local operator on a SCATTER vector) against one CPU
   process; per rank collective calls per iteration, bytes received per
   apply and walls per iteration (gloo ranks sharing one card, staged
   through the host: not a multi-card number).
17. slice 8 at full width with no group: ``MPIMatrixMult`` of a 32768 x
   16384 f32 A (2.147 GB, kappa ~ 5.8) and 64 columns, every kind and
   SUMMA schedule held to one ``torch.matmul`` forward and adjoint and
   timed against the FMA bound, bf16 storage, and CGLS (30 iterations)
   to the known model with no rising cost; ``MPIFFTND`` of a 512^3
   complex64 cube (1.074 GB) forward and adjoint against the byte bound,
   its round trip and dottest; the real ``MPIFFT2D`` of a (16384, 8192)
   field against ``torch.fft.rfft2`` with the same scaling and shift;
18. slice 8 across two to four ranks sharing the card over gloo (grids
   (1, 2), (1, 3), (2, 2)), each against the same work with no group:
   CGLS (10 iterations) through ``MPIMatrixMult`` at (4096, 2048, 64)
   f32 with both SUMMA schedules forced, ``auto`` and the block kind,
   each rank holding its tile or rows of A; the bytes a rank receives in
   the SUMMA collectives held to the volume model, and the flat↔tile
   moves beside them; the FFT of a (256, 256, 128) complex64 cube
   forward and adjoint (two transposes an apply, ragged at 3 ranks); a
   ragged f64 case (N=23, K=17, M=10 and a (17, 12, 9) cube) against
   one CPU process.

19. slice 9's solver tiers at full width with no group: on the 32
   blocks of phase 3 with columns scaled by 10^U(-1, 1), normal=True CGLS
   without a preconditioner, with Jacobi and with the exact block-Jacobi
   inverse (each to its own relative tol: iterations, wall, rel_err,
   normal-kernel launches per iteration; the block-Jacobi build and its
   apply against the byte bound and one ``torch.cholesky_solve``);
   ``block_cgls`` of 16 columns against 16 sequential normal=True and
   classic solves (30 iterations, solves/s, column gaps); the pipelined
   and s-step engines against the classic one under a group of one over
   NCCL (iterations to the same tol, x gaps, all_reduce calls per
   iteration, 6 alternating pairs of walls), CGLS on the blocks and CG
   on their Gram blocks plus I; ``MPISparseMatrixMult.from_banded`` at
   2^24 rows (83.9 M nonzeros) forward and adjoint against the byte bound
   and a ``torch.sparse`` CSR mv, the adjoint's run-to-run spread and 30
   damped CGLS iterations; CG on the Laplacian + 0.05 at (2048, 2048)
   without a preconditioner and with a 6-level V-cycle;
20. slice 9 across two and three gloo ranks sharing the card, each
   solve first run with no group here (10 iterations, 8 blocks of
   1024^2 f32, ragged at three ranks): block CGLS, PCGLS with Jacobi and
   with the chunk's block-Jacobi, PCG with block-Jacobi blocks that
   straddle the shards at three ranks, pipelined CGLS normal=True,
   s-step CG (held in f64; the f32 gap is printed: the monomial basis
   carries another summation order into x amplified like 1/residual),
   the sparse CGLS; every x within 1e-5, a ragged f64 case
   within 1e-12 of one CPU process, each rank's all_reduce calls per
   iteration (pipelined 1) and the bytes it receives per preconditioner
   and sparse apply; and the serving pool's packed solve of four
   requests (bucket 4) against the no-group pool within 1e-5 (the daemon
   over a group is phase 24.5's).

21. slice 10, the solve service at a world of one, full width: a
   ``cgls`` family on phase 3's 32 blocks of 4096x4096 f32 (30
   iterations, tol 0) and a ``cg`` family on their Gram blocks plus I
   (50 iterations, tol 1e-3 absolute on the squared residual), buckets
   1, 2, 4, 8, 16. 21.1 the first request of a cold dispatcher thread
   against a warm one, then each bucket prewarmed on the dispatcher
   thread (ms each); 21.2 64 single-RHS requests from 8 submitting
   threads through ``SolveDaemon`` (5 ms window): solves/s, batches,
   mean fill, forced dispatches, p50/p99 of queue wait and of
   end-to-end latency, the ratio to sequential classic ``cgls`` (timed
   after a warm solve), every column within 1e-5 of its sequential
   oracle and every batch bitwise equal to ``block_cgls`` on the same
   padded block; 21.3 16 requests to the ``cg`` family, all
   ``converged`` as their oracles, ``iiter`` within one of the oracles'
   largest; 21.4 a bucket-16 batch with one NaN column: with guards it
   reads ``breakdown`` and the other 15 equal the clean batch bitwise,
   without guards it returns x0 and ``iiter`` 0, and guard-on over
   guard-off wall per iteration in alternating pairs; 21.5 a deadline
   already past fails its tickets with no solve, and after a full warm
   batch a near one dispatches an undersized batch that resolves by its
   deadline; 21.6 ``worker_main`` on a temporary spool in a
   thread: 32 spooled requests and a DRAIN marker, every result banked
   and matching 21.2's oracles.

22. slice 11, the bank of captured loops (``PYLOPS_MPI_TPU_TORCH_AOT=on``
   set in-process): phase 3's CGLS (``normal=True`` f32 and bf16,
   classic, 50 iterations), ``block_cgls`` of 16 columns, phase 7's
   Gradient CGLS and phase 9's FISTA and ISTA (26 iterations: device
   bound), V-cycle PCG on phase 19.5's Laplacian to its tolerance, and
   the pipelined CGLS under a group of one over NCCL (its reductions
   inside the graph); each solved eagerly and then twice through the
   bank: x, ``iiter`` and the costs bitwise equal to the eager run's,
   the kernel launch, path and collective counts equal, one capture and
   none on the second solve; then 4 alternating pairs of walls (iters/s
   with graphs against without, median and range), each way's idle
   share and the kernels' device ms from ``torch.profiler``; the
   profiler's count of normal or tap kernel events in the graph run
   must equal the eager run's (one normal kernel an iteration on the
   ``normal=True`` paths), though only the tail launches from Python
   there; the capture's ms and the bank's bytes. 22.7 phase 21.2's 64 requests
   from 8 threads with the dispatcher's prewarm capturing every bucket:
   every ticket resolves, no capture during the traffic, each batch
   bitwise equal to eager ``block_cgls``; solves/s and p50/p99 beside
   phase 21's. 22.8 two gloo ranks sharing the card with the bank
   armed: each solve runs eagerly with the reason ``gloo``, x within
   1e-5 of the no-group solve. Run it alone with ``graphs_phase(torch,
   pmtt, (nk, sk), here, dev)``.

23. Slice 12, the resilience tier at phase 3's width. 23.1
   ``resilient_solve`` of bf16 storage under ``cgls(normal=True)``,
   ``NITER_23`` iterations with a NaN armed at ``NAN_AT_23``: the bf16
   rung ends ``breakdown`` within 2 iterations and restarts once at f32
   from its last finite iterate, to phase 3's error limit; the launch
   counts by dtype show ``_normal_kernel_stream`` (bf16) then
   ``_normal_kernel`` (f32); the restart's operator rebuild in ms. 23.2
   the same through the graph bank, then a clean guarded bf16 solve of
   the poisoned loop's key: a new capture, bitwise the eager clean
   solve. 23.3 ``refined_solve`` (bf16 inner, f64 wide) converged at
   1e-10 with a narrow share of at least 0.8. 23.4 classic
   ``cgls_segmented`` (48 iterations, epochs of 8, a checkpoint each)
   bitwise the fused ``cgls``, killed at epoch 3 and resumed bitwise;
   ms a checkpoint, iters/s against the fused solve in 4 pairs. 23.5
   ``launch_job`` of two gloo workers on the card (this script with
   ``--resilience-worker``), an f64 segmented CGLS with the shards
   backend; worker 0 SIGSTOPped after its first checkpoint, classified
   ``stale_heartbeat`` within 2 beats + 1 s, the job relaunched at a
   world of one; x within 1e-6 of the no-group solve; the relaunch
   wall. 23.6 the pipelined ``cgls(normal=True)`` under a group of one
   over NCCL and ``fista_guarded`` on phase 9's cube, each with a NaN:
   ``breakdown``, x bitwise the clean solve's of one iteration fewer;
   guard-on over guard-off wall in pairs. Run it alone with
   ``resilience_phase(torch, pmtt, (nk, sk), here, dev)``.

24. Slice 13, the training path. 24.1 the tap kernel's autograd rule at
   slice 2's shape (f32, bf16; a ghost tensor on top, out_pad rows): its
   gradient against autograd through the plain version, and the backward
   launch (the same kernel on the transposed taps) against the plain
   version, one ``conv_transpose2d`` and the byte bound. 24.2
   ``examples/autodiff.py``'s objective on phase 3's blocks and the
   axis-0 ``MPIFirstDerivative`` of the whole vector: 20 steps of gradient
   descent by ``torch.autograd``, each gradient against the hand-written
   one; the tap kernel's forward and backward launches counted from 0
   (the phase's main path); then the same on two gloo ranks sharing the
   card, every gradient against one rank's (the exchange's adjoint sends
   the ghost cotangents home). 24.3 ``cgls_solve`` on
   ``[Op; ε·MPIGradient]`` at (65536, 1024) in f64 (ε a 0-d tensor on the
   card, ``NITER_24`` iterations, damp ``DAMP_24``): the implicit gradient
   against a central difference (1e-3), the forward and backward solve
   walls, then 5 Adam steps of ``fit`` eagerly and through the graph bank,
   whose loss trajectories must agree (ε updated in place under replayed
   graphs). 24.4 ``batched_solve`` of 4 ``MPIBlockDiag`` members built
   from phase 3's blocks (CGLS, 30 iterations): each lane against its own
   ``cgls``, a cache hit on the second call, its wall against the
   sequential solves. 24.5 ``SolveDaemon`` over two gloo ranks sharing the
   card on phase 21.2's families, 32 requests from 4 threads: every result
   within 1e-6 of the one-process daemon's, every batch against the block
   solvers over the same group, rank 0's stats. Run it alone with
   ``autodiff_phase(torch, pmtt, (nk, sk), here, dev)``.

25. Slice 14, the cost model and the tuner at the main path's width. 25.1
   ``python -m pylops_mpi_tpu_torch.tuning --family blockdiag --main-path``
   races the normal kernel (``fused``) against the two sweeps at phase 3's
   32 blocks of 4096^2, f32 and bf16 storage each into its own cache file
   (the key carries the operator's dtype): each trial's best_s, the winner
   must be ``fused``; with ``PYLOPS_MPI_TPU_TORCH_TUNE=on`` and that cache
   the constructor replays the plan with no ``tuning.trial`` event, the
   50-iteration ``cgls(normal=True)`` launches the kernel once an
   iteration (counted from 0 just before it: this slice's main path) and
   its x is bitwise the untuned solve's; a banked ``two_sweep`` plan makes
   the same solve launch it 0 times, x within 1e-6. 25.1b phase 7's
   Gradient-regularized CGLS with its derivatives built under TUNE=on:
   the tap kernel's launches and x as untuned. 25.2 SUMMA at phase 17's
   (32768, 16384, 64) f32 under TUNE=auto: the factory's trials, one for
   each candidate the card lists (grid (1, 1): the default alone), the
   default banked and replayed with no trial. The tuner warms every
   candidate, then times them in rounds of alternating order. 25.3
   ``estimate`` and ``roofline`` against CUDA-event times of the
   block-diagonal forward and normal applies, the (65536, 1024)
   ``MPIGradient``, the SUMMA and the 512^3 c64 ``MPIFFTND``: predicted and measured ms, bound, hbm_pct; no
   block-diagonal or Gradient apply above 1.05 of its roofline. 25.4
   ``CA=auto``: ``off`` with no group; under an NCCL group of one the
   measured alpha, the predicted apply and the pick, the auto solve
   bitwise its named engine's, the two engines in alternating pairs.
   25.5 the main path with ``TELEMETRY=on``, eagerly and through the graph
   bank: one record an iteration, ``resid`` bitwise the cost history, the
   banked history bitwise the eager one; iters/s on over off in pairs.
   25.6 two gloo ranks sharing the card (rank 1 late) dump their traces;
   ``python -m pylops_mpi_tpu_torch.diagnostics aggregate`` is ``ok``, every
   matched collective has ``skew_us``, the late rank is the straggler and
   the critical path names ``solver.cgls``. Run it alone with
   ``tuner_phase(torch, pmtt, (nk, sk), here, dev)``.

26. Slice 15, the bounded-memory resharding planner, the host spill tier
   and the in-place recovery. 26.1 phase 6's (65536, 1024) f32 field on
   3 gloo ranks sharing the card, moved from a ragged axis-0 split to the
   balanced one and from axis 0 to axis 1, each under a 16 MiB budget and
   unbounded: every rank's shard bitwise numpy's cut of the host copy and
   the same both ways, each rank's peak device scratch above its input
   and output (``max_memory_allocated`` after a reset, less what stays
   allocated) within the budget plus ``ROUNDING_26``, the bytes it
   received the plan's pair bytes, as many exchanges as chunks, and a
   budget a byte under ``min_budget`` refused naming it; chunks and ms
   per move.
   26.2 with no group, the main path's block stack (32 x 4096^2 f32,
   2 GiB) ``to_host`` under a 256 MiB budget with overlap on and off and
   back with a host-staged ``to_device``: bitwise, pinned, no device
   scratch over the budget, ``.bytes_d2h``/``.bytes_h2d`` the plan's;
   D2H and H2D GB/s in 3 alternating pairs. 26.3 ``launch_job(inplace=
   True)`` of two gloo workers sharing the card (this script with
   ``--inplace-worker``) on ``cgls_segmented(normal=True)`` over the 32
   blocks (16 a rank), 50 iterations, epochs of 8, worker 1 SIGKILLed
   after its second epoch, in the nap that ends each epoch: the survivor
   catches ``ElasticReconfig``, re-forms to a world of one, rebuilds the
   blocks from the seed, takes ``restore_carry`` and resumes at
   iteration 16, with no checkpoint read, one normal-kernel launch per
   resumed iteration (counted from 0 just before the resumed solve: this
   slice's main path) and phase 3's error to the known model; then the
   same job with ``inplace=False`` (relaunch from the checkpoint); then
   the in-place job again with no nap, worker 1 dying inside its third
   all-reduce of epoch 3 (the survivor's collective raises, and it takes
   the reconfig from there: a ``resilience.peer_lost`` event). The three
   resume iteration 16's carry on a world of one, so their x must be
   bitwise equal. Detection, recovery to the resumed solve, job wall and
   the bank's share of an epoch for each. 26.4 26.3's two-rank
   checkpoint restored on one rank under a 64 KiB budget (under one
   512 KiB vector: each is placed in several chunks, each step's staging
   under the budget), bitwise the unbudgeted restore. Run it alone with
   ``reshard_phase(torch, pmtt, (nk, sk), here, dev)``.

Phases 8, 9, 11-13, 16-18 and 21 (and phase 20's pool case) reach none
of the hand-written kernels (a block solve of ``MPIBlockDiag`` runs a
batched GEMM, bucket 1 runs classic ``cgls``): the
JAX package runs their FFTs, products, thresholds, convolutions, sprays
and gathers outside Pallas, and so does the port (cuFFT, cuBLAS, cuDNN,
``index_add_``/``index_select`` and elementwise PyTorch); their kernel
launch counts are read all the same.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory without the package beside it, it exits non-zero before
printing any result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NBLK, NBLOCK, NITER = 32, 4096, 50
REPS = 20
PAIRS = 6  # phase 14: solves with the group and stubbed, in turns
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SRC = "pylops_mpi_tpu_torch/csrc/normal_matvec.cu"
# phase 2's small shapes: ragged (777), narrow and unaligned widths (33, 1),
# one tall block, 300 small blocks, and A one element past an aligned base
NORMAL_SHAPES = [(3, 1000, 777), (4, 50, 33), (5, 33, 1), (1, 8191, 4096),
                 (300, 64, 48), (3, 1000, 777, 1)]
REPLACES = {"float32": "pylops_mpi_tpu/ops/pallas_kernels.py:222",
            "bfloat16": "pylops_mpi_tpu/ops/pallas_kernels.py:240",
            "float16": "pylops_mpi_tpu/ops/pallas_kernels.py:240",
            "float64": "pylops_mpi_tpu/ops/pallas_kernels.py:222"}
# kernel vs plain version, max |err| over max |plain|: both accumulate at
# f32 (f64 for f64 blocks), in different orders, over n terms
TOL = {"float32": 1e-4, "bfloat16": 1e-4, "float16": 1e-4, "float64": 1e-10}

# the tap-stencil slice: the (nx, nt0) field of the derivative and
# post-stack phases (65,536 traces of 1,024 samples, a 256x256 survey)
NX, NT0 = 65536, 1024
STENCIL_SRC = "pylops_mpi_tpu_torch/csrc/stencil_taps.cu"
STENCIL_REPLACES = "pylops_mpi_tpu/ops/pallas_kernels.py:74"
# tap kernel vs plain version, max |err| over max |plain|. Both sum at f32
# (f64 for f64) and round once; f32/f64 differ only by fused vs separate
# multiply-adds. For bf16/f16 the two f32 sums can round to neighbouring
# values: one bf16 ulp of the largest entry is 2^-7 = 7.8e-3, one f16
# ulp 2^-10 = 9.8e-4.
STENCIL_TOL = {"float32": 1e-6, "float64": 1e-12, "bfloat16": 1e-2,
               "float16": 1e-3}
# every tap set _stencil_spec emits (sampling 1), as offset -> coefficient
TAP_SETS = {
    "first_forward": ({1: 1.0, 0: -1.0}, 1),
    "first_backward": ({0: 1.0, -1: -1.0}, 1),
    "first_centered3": ({1: 0.5, -1: -0.5}, 1),
    "first_centered5": ({-2: 1 / 12, -1: -8 / 12, 1: 8 / 12, 2: -1 / 12}, 2),
    "second_forward": ({0: 1.0, 1: -2.0, 2: 1.0}, 2),
    "second_backward": ({0: 1.0, -1: -2.0, -2: 1.0}, 2),
    "second_centered": ({-1: 1.0, 0: -2.0, 1: 1.0}, 1),
}
EPS_R, DAMP = 0.1, 1e-4
# phase 8: MDD at full width. A twosided MDC of nt = 1001 samples (odd),
# 301 of its 501 one-sided frequencies, 1024 sources and 1024 receivers,
# 64 virtual sources: G is 301 x 1024 x 1024 complex64 (2.5 GB, 5.0 GB with
# G^H kept), the model 1001 x 1024 x 64 f32 (262 MB)
NT_MDD, NFMAX, NS_MDD, NR_MDD, NV_MDD = 1001, 301, 1024, 1024, 64
DT_MDD, DR_MDD = 0.004, 20.0
MDD_ERR_LIMIT = 1e-2
# phase 9: examples/reflectivity.py at post-stack width, a (64, 1024, 1024)
# impedance cube (64 Mi samples, 256 MiB a f32 vector) in 8 blocks of
# 8 x 1024 traces, time last; the example's three interfaces at the same
# relative depths, each moved per trace by up to 16 samples
NY_R, NX_R, NZ_R, NBLK_R = 64, 1024, 1024, 8
INTERFACES = ((20 / 64, 7.0), (35 / 64, 4.5), (50 / 64, 6.0))
JITTER = 16
NITER_SPARSE, EPS_SPARSE = 100, 1e-3
# phase 10: card against CPU in f64, every gap relative to the largest entry
F64_GAP = 1e-9
# phase 11: MPIVStack of slice 1's 32 blocks, (131072 x 4096); stack against
# its plain product (f32 sums in other orders over 4096 terms)
STACK_TOL = 1e-5
# phase 12: non-stationary deconvolution of a (2048, 16384) field (2048
# samples at 2 ms, a 128 x 128 patch of traces, 128 MiB a f32 vector) with
# 32 41-tap Ricker filters at ih = 32 + 64 k, f0 falling from 40 to 10 Hz
NT_NS, NTR_NS, NFILT_NS = 2048, 16384, 32
SPIKE_FRACTION = 0.02
NS_RESID_LIMIT = 0.1
# phase 13: examples/lsm.py widened: a (201, 401) image at 4 m, v0 1000 m/s,
# 64 sources at 10 m and 256 receivers at 20 m depth, 1800 samples at 2 ms,
# interfaces at rows 100 and 167 (the example's relative depths)
NZ_L, NX_L, DX_L, V0_L = 201, 401, 4.0, 1000.0
NS_L, NR_L, NT_L, DT_L = 64, 256, 1800, 0.002
ROWS_L = (100, 167)
# the LSM example at its own size on the card and the CPU: CGLS on it
# amplifies summation order from its sixth iteration on (see
# tests/test_torch_lsm.py), so the f64 comparison runs five
NITER_LSM_F64 = 5
# relative stacked residual ||[d; 0] - [Op; eps G] x|| / ||d|| after 50
# iterations must be below this: a reduced-size run of this phase's
# code, (1024, 1024) f32 on the CPU with seeds 4 and 5, reached 0.1153
# and 0.1149
RESID_LIMIT = 0.15
# phase 16: this slice's operators across ranks sharing the card over gloo,
# at phases 8, 11, 12 and 13's widths, against the same configurations
# solved with no group in this process; each world runs the cases named
NITER_16, NITER_16_LSM = 10, 5
WORLDS_16 = {2: ("vstack", "mdd", "nonstat", "lsm", "f64"),
             3: ("vstack", "mdd", "lsm", "f64"),
             4: ("nonstat", "f64")}  # 2048 samples do not split over 3
TOL_16 = dict(vstack_f32=1e-5, vstack_bf16=1e-4, mdd=1e-5, nonstat=1e-5,
              lsm_forward=1e-5, lsm_adjoint=1e-5, lsm_x1=1e-5,
              # examples/lsm.py's CGLS amplifies summation order (amp up to
              # 1e5 at receivers on grid points; PERF.md §6): at full
              # width in f32 the no-group solve's x after 5 iterations,
              # and its residual norms, differ from a second no-group
              # solve by up to several percent on an H100 (the spray's
              # atomics; PERF.md §6). So the f32 solve's x is printed
              # beside that spread, and the 5 iterations are held in f64,
              # where the same amplification of f64 rounding stays far
              # below this bound
              lsm_x_f64=1e-6, f64=1e-10)


# phases 17-18 (slice 8): the dense matmul and the pencil FFTs. Phase 17
# at full width with no group: A of 32768 x 16384 f32 (2.147 GB; a
# Gaussian A of twice as many rows as columns has kappa ~ 5.8), X of 64
# columns; a 512^3 complex64 cube (1.074 GB); a (16384, 8192) real field
# (537 MB in and out). Phase 18 at (4096, 2048, 64) and a (256, 256, 128)
# complex64 cube (67.1 MB) on 2-4 gloo ranks sharing the card
N_MM, K_MM, M_MM, NITER_MM = 32768, 16384, 64, 30
MM_ERR_LIMIT, MM_BF16_LIMIT, MM_AGREE = 1e-3, 5e-2, 1e-5
FFT3, FFT2, FFT_TOL = (512, 512, 512), (16384, 8192), 1e-5
N_18, K_18, M_18, NITER_18 = 4096, 2048, 64, 10
FFT_18 = (256, 256, 128)
WORLDS_18 = (2, 3, 4)
TOL_18, F64_18 = 1e-5, 1e-12
MM_KINDS = (("gather", "summa", "gather"), ("stat_a", "summa", "stat_a"),
            ("auto", "summa", "auto"), ("block", "block", "auto"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    timed with CUDA events after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(nk, A, X):
    """Kernel vs plain version on the card: (max abs err, max rel err).
    Raises unless two kernel calls give bitwise-equal u and q."""
    import torch
    u, q = nk.normal_matvec(A, X)
    u1, q1 = nk.normal_matvec(A, X)
    torch.cuda.synchronize()
    if not (torch.equal(u, u1) and torch.equal(q, q1)):
        raise RuntimeError(f"normal_matvec {tuple(A.shape)} {A.dtype}: two "
                           "calls differ")
    u0, q0 = nk.normal_matvec_plain(A, X)
    abs_err = max(float((u - u0).abs().max()), float((q - q0).abs().max()))
    rel = max(float((u - u0).abs().max() / u0.abs().max()),
              float((q - q0).abs().max() / q0.abs().max()))
    if not (torch.isfinite(u).all() and torch.isfinite(q).all()):
        raise RuntimeError("kernel produced non-finite values")
    return abs_err, rel


def bound_ms(nblk, m, n, itemsize):
    """Least time for one normal product: A read once plus x read and
    u, q written once, over the memory rate; 4·m·n operations per block
    at the f32 rate (narrow blocks are widened to f32)."""
    xbytes = 4 if itemsize < 8 else 8
    nbytes = nblk * m * n * itemsize + nblk * (2 * n + m) * xbytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * nblk * m * n / (F32_OPS_PER_S / (2 if itemsize == 8 else 1)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_rows(torch, fn):
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``: (wall ms, [(ms, name, count)] sorted by time).
    Only device (kernel) events count; wall time includes the profiler's
    own overhead, so the idle share it implies is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall * 1e3, rows


def profile_run(torch, fn, match=("normal_kernel<", "normal_reduce_kernel<")):
    """:func:`device_rows` summed: (wall ms, device-busy ms, top kernels,
    ms of the kernels whose name holds one of ``match``)."""
    wall, rows = device_rows(torch, fn)
    matched = sum(r[0] for r in rows if any(k in r[1] for k in match))
    top = [(ms, name[:60], n) for ms, name, n in rows[:6]]
    return wall, sum(r[0] for r in rows), top, matched


def make_problem(torch, device, seed=0):
    """bench.py:make_problem on the card: diagonally dominant blocks
    quantized to the bf16 grid (the f32 and bf16 runs solve the same
    system), a known model and its exact data."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((NBLK, NBLOCK, NBLOCK), generator=g, device=device)
    A /= math.sqrt(NBLOCK)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    A = A.to(torch.bfloat16).to(torch.float32)
    xtrue = torch.randn((NBLK, NBLOCK), generator=g, device=device)
    y = torch.bmm(A, xtrue.unsqueeze(-1)).reshape(-1)
    return A, xtrue.reshape(-1), y


def max_rel_err(got, want):
    """max |got - want| over max |want|, in f64 (complex128 where either
    side is complex)."""
    import torch
    dt = (torch.complex128 if got.is_complex() or want.is_complex()
          else torch.float64)
    got, want = got.to(dt), want.to(dt)
    return float((got - want).abs().max() / want.abs().max())


def stencil_taps_check(torch, sk, dev, g, shape_rows, cols, dtypes):
    """Kernel vs plain version for every tap set, forward and reversed,
    as a plain slab, with out_pad, and as a three-piece slab (ghost
    tensor on top, zero rows below); returns the worst relative and
    absolute errors per dtype."""
    worst, worst_abs = {}, {}
    for dt in dtypes:
        name = str(dt).split(".")[1]
        for tp, w in TAP_SETS.values():
            for rev in (False, True):
                taps = sorted(((-d if rev else d), c) for d, c in tp.items())
                slab = torch.randn((shape_rows + 2 * w, cols), generator=g,
                                   device=dev).to(dt)
                ghost = torch.randn((w, cols), generator=g, device=dev).to(dt)
                for sl, kw in ((slab, {}), (slab, dict(out_pad=(2, 1))),
                               (slab[w:-w], dict(top=ghost, bottom=w,
                                                 out_pad=(1, 0)))):
                    y = sk.stencil_taps(sl, taps, w, **kw)
                    torch.cuda.synchronize()
                    y0 = sk.stencil_taps_plain(sl, taps, w, **kw)
                    if y.shape != y0.shape or not bool(torch.isfinite(y).all()):
                        raise RuntimeError(f"stencil_taps[{name}] shape "
                                           f"{tuple(y.shape)} or non-finite")
                    worst[name] = max(worst.get(name, 0.0), max_rel_err(y, y0))
                    worst_abs[name] = max(worst_abs.get(name, 0.0), float(
                        (y.double() - y0.double()).abs().max()))
                del slab, ghost
        ok = worst[name] <= STENCIL_TOL[name]
        print(f"stencil kernel vs plain {name} ({shape_rows}+2w, {cols}), "
              f"{2 * len(TAP_SETS)} tap sets x 3 slab forms: max rel err "
              f"{worst[name]:.3e} (tol {STENCIL_TOL[name]:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"stencil_taps[{name}] disagrees with its plain "
                               f"version: {worst[name]:.3e}")
    return worst, worst_abs


def rand_like(torch, pmtt, y, g):
    """A random vector on the card with the structure of ``y``."""
    if isinstance(y, pmtt.StackedDistributedArray):
        return pmtt.StackedDistributedArray([rand_like(torch, pmtt, d, g)
                                             for d in y.distarrays])
    return pmtt.DistributedArray.to_dist(
        torch.randn(y.global_shape, generator=g, device=y.device,
                    dtype=y.dtype))


def stencil_times(torch, sk, dev, g, dt):
    """Kernel, plain, library (one conv2d) and bound times of the
    centered-3 tap set on the full (NX + 2, NT0) slab."""
    import torch.nn.functional as F
    tp, w = TAP_SETS["first_centered3"]
    taps = sorted(tp.items())
    slab = torch.randn((NX + 2 * w, NT0), generator=g, device=dev).to(dt)
    weight = torch.zeros((1, 1, 2 * w + 1, 1), dtype=dt, device=dev)
    for d, c in taps:
        weight[0, 0, w + d, 0] = c
    lib = F.conv2d(slab.view(1, 1, NX + 2 * w, NT0), weight)
    y = sk.stencil_taps(slab, taps, w)
    lib_err = max_rel_err(y, lib.view(NX, NT0))
    kms = cuda_ms(lambda: sk.stencil_taps(slab, taps, w))
    pms = cuda_ms(lambda: sk.stencil_taps_plain(slab, taps, w))
    lms = cuda_ms(lambda: F.conv2d(slab.view(1, 1, NX + 2 * w, NT0), weight))
    kms2 = cuda_ms(lambda: sk.stencil_taps(slab, taps, w))
    item = slab.element_size()
    t_bytes = (slab.numel() + NX * NT0) * item / HBM_BYTES_PER_S * 1e3
    ops = 2.0 * len(taps) * NX * NT0
    t_ops = ops / (F32_OPS_PER_S / (2 if item == 8 else 1)) * 1e3
    bms, bby = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return dict(kernel_ms=min(kms, kms2), kernel_ms_runs=[kms, kms2],
                plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby,
                library_max_err=lib_err, shape=[NX + 2 * w, NT0],
                taps="first_centered3")


def layered_model(torch, nx, nt0, dev, seed):
    """examples/poststack.py's layered impedance model at (nx, nt0), from
    a seeded generator on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    steps = torch.randn((nx, nt0), generator=g, device=dev,
                        dtype=torch.float64) * 0.03
    return torch.cumsum(steps, dim=1) + 2.0


def gradient_poststack(torch, pmtt, m, wav, niter, dtype):
    """The Gradient-regularized post-stack system on the model ``m``:
    ``(StackOp, data, Op)`` with data ``[Op m; 0]``."""
    nx, nt0 = m.shape
    dev = m.device
    Op = pmtt.models.MPIPoststackLinearModelling(wav, nt0, nx, dtype=dtype,
                                                 device=dev)
    G = pmtt.MPIGradient((nx, nt0), dtype=dtype)
    StackOp = pmtt.MPIStackedVStack([Op, EPS_R * G])
    d = Op.matvec(pmtt.DistributedArray.to_dist(
        m.to(dtype).reshape(-1), local_shapes=Op.local_shapes_m))
    zero = pmtt.StackedDistributedArray([
        pmtt.DistributedArray(global_shape=nx * nt0,
                              local_shapes=G.local_shapes_m, dtype=dtype,
                              device=dev)
        for _ in range(2)])
    return StackOp, pmtt.StackedDistributedArray([d, zero]), Op


def solve_stats(torch, pmtt, Op, m, d, x, cost):
    """Relative data residual, model error and the stacked residual
    ``||[d; 0] - [Op; eps G] x||``, each over ``||d||`` or ``||m||``.
    The model error stays near 1: the layered model's energy is in its
    background and lowest frequencies, which W·D does not see."""
    xv = x.array if hasattr(x, "array") else torch.as_tensor(x).reshape(-1)
    xv = xv.to(m.device)
    if xv.shape != (m.numel(),) or not bool(torch.isfinite(xv).all()):
        raise RuntimeError("non-finite or misshapen solution")
    pred = Op.matvec(pmtt.DistributedArray.to_dist(xv)).array
    dn = torch.linalg.vector_norm(d.double())
    return dict(
        data_residual=float(torch.linalg.vector_norm((pred - d).double()) / dn),
        model_error=float(torch.linalg.vector_norm(xv.double() - m.reshape(-1))
                          / torch.linalg.vector_norm(m)),
        stacked_residual=(None if cost is None
                          else float(cost[-1]) / float(dn)))


def kernel_groups(rows):
    """Device ms of an apply's FFT (cuFFT), GEMM (cuBLAS) and other
    kernels, from :func:`device_rows`."""
    fft = sum(ms for ms, name, _ in rows if "fft" in name.lower())
    gemm = sum(ms for ms, name, _ in rows if "gemm" in name.lower())
    return dict(fft_ms=fft, gemm_ms=gemm,
                other_ms=sum(r[0] for r in rows) - fft - gemm)


def rel_norm(a, b):
    """||a - b|| / ||b|| in f64."""
    import torch
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def solve_walls(torch, kernels, fn, runs):
    """``fn()`` ``runs`` times with the kernel counters set to 0 before
    each: (last result, host seconds of each run, launches of the last
    run per kernel module)."""
    walls = []
    for _ in range(runs):
        for k in kernels:
            k.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls, [k.launches for k in kernels]


def mdd_phase(torch, pmtt, kernels, dev):
    """Phase 8: CGLS through the full-width twosided MDC, with data made
    from a known model, and the user's ``mdd`` beside it."""
    from pylops_mpi_tpu_torch import Partition
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    # per frequency 4 I + a complex Gaussian of unit-variance entries over
    # sqrt(nr): singular values ~2..6, so every kept frequency is well posed
    G = torch.randn((NFMAX, NS_MDD, NR_MDD), generator=g, device=dev,
                    dtype=torch.complex64) / math.sqrt(NR_MDD)
    G.diagonal(dim1=1, dim2=2).add_(4.0)
    Op = pmtt.MPIMDC(G, nt=NT_MDD, nv=NV_MDD, dt=DT_MDD, dr=DR_MDD,
                     twosided=True, saveGt=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if Op.dtype != torch.float32:
        raise RuntimeError(f"MDC operator dtype {Op.dtype}, expected float32")
    # the operator sees 301 of 501 frequencies: the model is made in its
    # row space (Op^H of seeded noise), where CGLS from zero can reach it
    w = pmtt.DistributedArray.to_dist(
        torch.randn(Op.shape[0], generator=g, device=dev),
        partition=Partition.BROADCAST)
    xt = Op.rmatvec(w)
    xt = xt * (math.sqrt(Op.shape[1]) / xt.norm())
    d = Op.matvec(xt)
    if d.dtype != torch.float32 or not bool(torch.isfinite(d.array).all()):
        raise RuntimeError("MDC data not finite f32")
    fwd_ms = cuda_ms(lambda: Op.matvec(xt))
    adj_ms = cuda_ms(lambda: Op.rmatvec(d))
    parts = {}
    for name, fn in (("forward", lambda: Op.matvec(xt)),
                     ("adjoint", lambda: Op.rmatvec(d))):
        wall, rows = device_rows(torch, fn)
        parts[name] = dict(kernel_groups(rows), profile_wall_ms=wall,
                           top=[(ms, n[:60], c) for ms, n, c in rows[:5]])
    print(f"MDC ({NT_MDD}, {NS_MDD}/{NR_MDD}, {NV_MDD}), {NFMAX} frequencies, "
          f"complex64 G with G^H kept, built in {build_s:.2f} s: forward "
          f"{fwd_ms:.3f} ms (FFT {parts['forward']['fft_ms']:.3f}, GEMM "
          f"{parts['forward']['gemm_ms']:.3f}, other "
          f"{parts['forward']['other_ms']:.3f}), adjoint {adj_ms:.3f} ms (FFT "
          f"{parts['adjoint']['fft_ms']:.3f}, GEMM "
          f"{parts['adjoint']['gemm_ms']:.3f}, other "
          f"{parts['adjoint']['other_ms']:.3f}); kernels by time: forward "
          f"{parts['forward']['top']}, adjoint {parts['adjoint']['top']}",
          flush=True)
    x0 = pmtt.DistributedArray(global_shape=Op.shape[1],
                               partition=Partition.BROADCAST,
                               dtype=torch.float32, device=dev)
    pmtt.cgls(Op, d, x0, niter=2, tol=0.0)  # warm-up
    (x, istop, iiter, r1, r2, cost), walls, launches = solve_walls(
        torch, kernels, lambda: pmtt.cgls(Op, d, x0, niter=NITER, tol=0.0), 3)
    c = cost.double().cpu().numpy()
    err = rel_norm(x.array, xt.array)
    wall = min(walls)
    res = dict(iters_per_s=iiter / wall, wall_s=walls, iiter=iiter,
               rel_err=err, residual_history=c.tolist(), forward_ms=fwd_ms,
               adjoint_ms=adj_ms, parts=parts, build_s=build_s,
               kernel_launches=launches)
    print(f"MDD cgls f32: {iiter} iters in {wall:.4f} s (best of {walls}) = "
          f"{iiter / wall:.1f} iters/s; rel err to the true model {err:.3e} "
          f"(limit {MDD_ERR_LIMIT:.0e}); kernel launches (normal, stencil) "
          f"{launches}; residual history {[float('%.4g' % v) for v in c]}",
          flush=True)
    if not err <= MDD_ERR_LIMIT:
        raise RuntimeError(f"MDD: rel err {err:.3e} above {MDD_ERR_LIMIT}")
    # non-increasing, up to f32 rounding once the residual reaches its floor
    if np.any(np.diff(c) > 1e-5 * c[0]):
        raise RuntimeError(f"MDD: residual history increases: {c}")
    wall_ms, busy_ms, top, _ = profile_run(
        torch, lambda: pmtt.cgls(Op, d, x0, niter=10, tol=0.0))
    res.update(profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
               profile_top=top, idle_share=1.0 - busy_ms / wall_ms)
    print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall; top kernels (ms, name, count): {top}",
          flush=True)
    del Op, x, w
    torch.cuda.empty_cache()
    # the user's entry point: operator build, CGLS and the copy to the host
    (minv, _), mwalls, _ = solve_walls(
        torch, kernels, lambda: pmtt.models.mdd(
            G, d.array.view(NT_MDD, NS_MDD, NV_MDD), nt=NT_MDD, nv=NV_MDD,
            dt=DT_MDD, dr=DR_MDD, niter=NITER, tol=0.0), 1)
    merr = rel_norm(torch.from_numpy(minv).reshape(-1), xt.array.cpu())
    res.update(mdd_wall_s=mwalls[0], mdd_rel_err=merr,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"models.mdd: {NITER} iters, operator build and host copy "
          f"included, in {mwalls[0]:.3f} s; rel err {merr:.3e}; peak device "
          f"memory {res['peak_gb']:.2f} GB", flush=True)
    if not merr <= MDD_ERR_LIMIT:
        raise RuntimeError(f"models.mdd: rel err {merr:.3e}")
    del G, d, xt
    torch.cuda.empty_cache()
    return res


def reflectivity_model(torch, dev, seed):
    """The layered impedance cube: examples/reflectivity.py's trace with
    each interface moved per trace by a seeded integer in [-JITTER,
    JITTER]; returns (model, interface depths (n_if, NY_R, NX_R))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.arange(NZ_R, device=dev)
    m = torch.full((NY_R, NX_R, NZ_R), 5.0, device=dev)
    depths = []
    prev = 5.0
    for frac, val in INTERFACES:
        dep = int(frac * NZ_R) + torch.randint(
            -JITTER, JITTER + 1, (NY_R, NX_R), generator=g, device=dev)
        m += (val - prev) * (z >= dep[..., None])
        prev = val
        depths.append(dep)
    return m, torch.stack(depths)


def spikes_found(trace, depths):
    """Each interface at depth k of a step model gives the centered
    derivative's two spikes at k-1 and k: is the strongest recovered
    sample within 8 samples of each interface one of its two?"""
    ok = []
    for k in depths:
        win = trace[k - 8:k + 9].abs()
        ok.append(k - 8 + int(win.argmax()) in (k - 1, k))
    return all(ok)


def reflectivity_phase(torch, pmtt, kernels, dev):
    """Phase 9: FISTA, then ISTA, for the spiky reflectivity of the
    full-width impedance cube through MPIBlockDiag of local Conv1D."""
    from pylops_mpi_tpu_torch.ops.local import Conv1D, FirstDerivative
    f32 = torch.float32
    dims = (NY_R // NBLK_R, NX_R, NZ_R)
    wav = pmtt.models.ricker(np.arange(21) * 0.004, f0=15)[0]
    wavc = len(wav) // 2
    Dop = pmtt.MPIBlockDiag([FirstDerivative(dims, axis=-1, dtype=f32)]
                            * NBLK_R)
    Cop = pmtt.MPIBlockDiag([Conv1D(dims, wav, axis=-1, offset=wavc,
                                    dtype=f32, device=dev)] * NBLK_R)
    m, depths = reflectivity_model(torch, dev, seed=7)
    r = Dop @ pmtt.DistributedArray.to_dist(m.reshape(-1))
    d = Cop @ r
    x0 = r.zeros_like()
    # the step size: power_iteration as fista runs it, its numpy draws of
    # the start vector timed alone
    t0 = time.perf_counter()
    np.random.default_rng(42).random(NY_R * NX_R * NZ_R)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    maxeig, _, piter = pmtt.power_iteration(Cop.H @ Cop, x0, dtype=f32)
    power_s = time.perf_counter() - t0
    res = dict(power_s=power_s, power_draw_s=draw_s, power_iters=piter,
               maxeig=float(maxeig))
    print(f"reflectivity ({NY_R}, {NX_R}, {NZ_R}) f32: power_iteration "
          f"{piter} iterations, lambda_max {maxeig:.6g}, {power_s:.3f} s of "
          f"which the host draws alone take {draw_s:.3f} s", flush=True)
    rt = r.array.view(NY_R, NX_R, NZ_R)
    checked = [(0, 0), (NY_R // 2, NX_R // 2), (NY_R - 1, NX_R - 1)]
    for name, solver in (("fista", pmtt.fista), ("ista", pmtt.ista)):
        # the first call estimates the step size (cached on Cop after it)
        solver(Cop, d, x0=x0, niter=2, eps=EPS_SPARSE, tol=0.0)
        (x, iiter, cost), walls, launches = solve_walls(
            torch, kernels, lambda: solver(Cop, d, x0=x0, niter=NITER_SPARSE,
                                           eps=EPS_SPARSE, tol=0.0), 2)
        wall = min(walls)
        err = rel_norm(x.array, r.array)
        xr = x.array.view(NY_R, NX_R, NZ_R)
        found = all(spikes_found(xr[i, j], depths[:, i, j].tolist())
                    for i, j in checked)
        tr0 = xr[0, 0]
        top3 = sorted(torch.argsort(tr0.abs())[-3:].tolist())
        true_sp = sorted(torch.nonzero(rt[0, 0]).reshape(-1).tolist())
        c = cost.double().cpu().numpy()
        res[name] = dict(iters_per_s=iiter / wall, wall_s=walls, iiter=iiter,
                         rel_err=err, spikes_found=found, top3_trace0=top3,
                         true_spikes_trace0=true_sp, cost_first_last=[
                             float(c[0]), float(c[-1])],
                         kernel_launches=launches)
        print(f"{name} f32, eps {EPS_SPARSE}: {iiter} iters in {wall:.4f} s "
              f"(best of {walls}) = {iiter / wall:.1f} iters/s; rel err to the "
              f"true reflectivity {err:.3e}; trace (0, 0): three strongest "
              f"recovered depths {top3}, true spikes {true_sp}; every "
              f"interface of {len(checked)} traces found: {found}; cost "
              f"{c[0]:.4g} -> {c[-1]:.4g}; kernel launches (normal, stencil) "
              f"{launches}", flush=True)
        if not found or not math.isfinite(err) or c[-1] > c[0]:
            raise RuntimeError(f"{name}: spikes not recovered or cost grew")
        wall_ms, busy_ms, top, _ = profile_run(
            torch, lambda: solver(Cop, d, x0=x0, niter=10, eps=EPS_SPARSE,
                                  tol=0.0))
        res[name].update(profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
                         profile_top=top, idle_share=1.0 - busy_ms / wall_ms)
        print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall; top kernels (ms, name, count): {top}",
              flush=True)
        del x
    del Cop, Dop, m, r, d, x0
    torch.cuda.empty_cache()
    return res


def bytes_bound_ms(nbytes):
    """Least time to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def stacking_phase(torch, pmtt, kernels, dev):
    """Phase 11: MPIVStack of slice 1's 32 blocks of 4096x4096 (f32 and
    bf16 storage): one forward and one adjoint apply timed against the
    byte bound and held against the plain product, CGLS on the
    overdetermined (131072 x 4096) system from a known model, and
    MPIHStack of the same blocks held against MPIVStack(...).H and the
    plain sum."""
    from pylops_mpi_tpu_torch import Partition
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    A, _, _ = make_problem(torch, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    xt = torch.randn(NBLOCK, generator=g, device=dev)
    rows = [MatrixMult(A[i]) for i in range(NBLK)]
    Af = A.view(NBLK * NBLOCK, NBLOCK)
    xm = pmtt.DistributedArray.to_dist(xt, partition=Partition.BROADCAST)
    x0 = pmtt.DistributedArray(global_shape=NBLOCK,
                               partition=Partition.BROADCAST, device=dev)
    res = {}
    for label, cdt, limit in (("f32", None, 1e-4),
                              ("bf16", torch.bfloat16, 1e-3)):
        V = pmtt.MPIVStack(rows, compute_dtype=cdt)
        y = V.matvec(xm)
        z = V.rmatvec(y)
        # the blocks lie on the bf16 grid: both storages hold the same values
        err = max(max_rel_err(y.array, Af @ xt),
                  max_rel_err(z.array, Af.mT @ y.array))
        fwd = cuda_ms(lambda: V.matvec(xm))
        adj = cuda_ms(lambda: V.rmatvec(y))
        bound = bytes_bound_ms(V._batched.numel() * V._batched.element_size()
                               + (NBLOCK + NBLK * NBLOCK) * 4)
        pmtt.cgls(V, y, x0=x0, niter=2, tol=0.0)  # warm-up
        (x, istop, iiter, r1, r2, cost), walls, launches = solve_walls(
            torch, kernels, lambda: pmtt.cgls(V, y, x0=x0, niter=NITER,
                                              tol=0.0), 3)
        rel = rel_norm(x.array, xt)
        wall = min(walls)
        wall_ms, busy_ms, top, _ = profile_run(
            torch, lambda: pmtt.cgls(V, y, x0=x0, niter=10, tol=0.0))
        res[label] = dict(forward_ms=fwd, adjoint_ms=adj, bound_ms=bound,
                          max_err_vs_plain=err, iters_per_s=iiter / wall,
                          wall_s=walls, iiter=iiter, rel_err=rel,
                          kernel_launches=launches, profile_wall_ms=wall_ms,
                          profile_device_ms=busy_ms, profile_top=top,
                          idle_share=1.0 - busy_ms / wall_ms)
        print(f"MPIVStack {NBLK}x{NBLOCK}^2 {label} storage: forward "
              f"{fwd:.3f} ms, adjoint {adj:.3f} ms (byte bound "
              f"{bound:.3f} ms), vs plain product max rel err {err:.2e} "
              f"(tol {STACK_TOL:.0e}); cgls {iiter} iters in {wall:.4f} s "
              f"(best of {walls}) = {iiter / wall:.1f} iters/s, rel_err "
              f"{rel:.3e} (limit {limit:.0e}); kernel launches (normal, "
              f"stencil) {launches}; profile, 10 iterations: device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall; top kernels "
              f"(ms, name, count): {top}", flush=True)
        if not (err <= STACK_TOL and rel <= limit):
            raise RuntimeError(f"MPIVStack {label}: err {err:.3e}, rel_err "
                               f"{rel:.3e}")
        del V, y, z, x
        torch.cuda.empty_cache()
    w = pmtt.DistributedArray.to_dist(
        torch.randn(NBLK * NBLOCK, generator=g, device=dev))
    V = pmtt.MPIVStack(rows)
    H = pmtt.MPIHStack([r.H for r in rows])
    err_h = max_rel_err(H.matvec(w).array, V.H.matvec(w).array)
    del V, H
    torch.cuda.empty_cache()
    # the blocks themselves: the batched adjoint-rows path (one batched
    # product and a sum over the blocks)
    H = pmtt.MPIHStack(rows)
    plain = sum(A[i] @ w.array[i * NBLOCK:(i + 1) * NBLOCK]
                for i in range(NBLK))
    err_p = max_rel_err(H.matvec(w).array, plain)
    hms = cuda_ms(lambda: H.matvec(w))
    res["hstack"] = dict(max_err_vs_vstack_adjoint=err_h,
                         max_err_vs_plain=err_p, forward_ms=hms)
    print(f"MPIHStack of the blocks' adjoints vs MPIVStack(blocks).H: max rel "
          f"err {err_h:.2e}; MPIHStack of the blocks vs the plain sum: "
          f"{err_p:.2e} (tol {STACK_TOL:.0e}), forward {hms:.3f} ms",
          flush=True)
    if not max(err_h, err_p) <= STACK_TOL:
        raise RuntimeError(f"MPIHStack disagrees: {err_h:.3e}, {err_p:.3e}")
    del H, A, Af, rows, w, plain
    torch.cuda.empty_cache()
    return res


def nonstat_filters(pmtt):
    """32 Ricker filters of 41 taps, f0 falling linearly from 40 to 10 Hz
    with depth, at ih = 32 + 64 k."""
    t = np.arange(21) * 0.004
    hs = np.stack([pmtt.models.ricker(t, f)[0]
                   for f in np.linspace(40.0, 10.0, NFILT_NS)])
    return hs, 32 + 64 * np.arange(NFILT_NS)


def nonstat_plain(torch, H, v):
    """The JAX package's formulation of the local forward
    (ops/local.py:736-745) along axis 0: one shifted, weighted pass over
    the (n, traces) field per tap."""
    n, nh = H.shape
    y = torch.zeros((n + nh - 1, v.shape[1]), dtype=v.dtype, device=v.device)
    for j in range(nh):
        y[j:j + n] += H[:, j:j + 1] * v
    return y[nh // 2:nh // 2 + n]


def nonstat_phase(torch, pmtt, kernels, dev):
    """Phase 12: CGLS deconvolution through MPINonStationaryConvolve1D
    on the (2048, 16384) field, data from a seeded sparse reflectivity."""
    from pylops_mpi_tpu_torch.ops.local import NonStationaryConvolve1D
    f32 = torch.float32
    torch.cuda.reset_peak_memory_stats()
    hs, ih = nonstat_filters(pmtt)
    dims = (NT_NS, NTR_NS)
    t0 = time.perf_counter()
    Op = pmtt.MPINonStationaryConvolve1D(dims, hs, ih, axis=0, dtype=f32,
                                         device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(10)
    keep = torch.rand(dims, generator=g, device=dev) < SPIKE_FRACTION
    sign = torch.randint(0, 2, dims, generator=g, device=dev) * 2 - 1
    m = torch.where(keep, sign, 0).to(f32)
    mv = pmtt.DistributedArray.to_dist(m.reshape(-1))
    d = Op.matvec(mv)
    bank = NonStationaryConvolve1D(dims, hs, ih, axis=0, dtype=f32,
                                   device=dev).Hbank
    err = max_rel_err(d.array.view(dims), nonstat_plain(torch, bank, m))
    fwd = cuda_ms(lambda: Op.matvec(mv))
    adj = cuda_ms(lambda: Op.rmatvec(d))
    plain_ms = cuda_ms(lambda: nonstat_plain(torch, bank, m), reps=5)
    nh = hs.shape[1]
    t_bytes = bytes_bound_ms(2 * NT_NS * NTR_NS * 4)
    t_ops = 2.0 * nh * NT_NS * NTR_NS / F32_OPS_PER_S * 1e3
    bound, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    parts = {}
    for name, fn in (("forward", lambda: Op.matvec(mv)),
                     ("adjoint", lambda: Op.rmatvec(d))):
        wall, rows = device_rows(torch, fn)
        parts[name] = dict(profile_wall_ms=wall,
                           device_ms=sum(r[0] for r in rows),
                           top=[(ms, n[:60], c) for ms, n, c in rows[:5]])
    print(f"MPINonStationaryConvolve1D {dims} f32, {NFILT_NS} filters of {nh} "
          f"taps, built in {build_s:.2f} s: forward {fwd:.4f} ms, adjoint "
          f"{adj:.4f} ms (bound {bound:.4f} ms, {bound_by}); the JAX "
          f"package's {nh}-pass formulation {plain_ms:.3f} ms, agrees to "
          f"{err:.2e} (tol {STACK_TOL:.0e}); kernels by time: forward "
          f"{parts['forward']['top']}, adjoint {parts['adjoint']['top']}",
          flush=True)
    if not err <= STACK_TOL:
        raise RuntimeError(f"non-stationary convolution: {err:.3e} from the "
                           "shifted-pass formulation")
    x0 = mv.zeros_like()
    pmtt.cgls(Op, d, x0=x0, niter=2, tol=0.0)  # warm-up
    (x, istop, iiter, r1, r2, cost), walls, launches = solve_walls(
        torch, kernels, lambda: pmtt.cgls(Op, d, x0=x0, niter=NITER, tol=0.0),
        3)
    c = cost.double().cpu().numpy()
    resid = float(c[-1] / c[0])
    wall = min(walls)
    merr = rel_norm(x.array, mv.array)
    wall_ms, busy_ms, top, _ = profile_run(
        torch, lambda: pmtt.cgls(Op, d, x0=x0, niter=10, tol=0.0))
    res = dict(build_s=build_s, forward_ms=fwd, adjoint_ms=adj,
               bound_ms=bound, bound_by=bound_by, plain_ms=plain_ms,
               max_err_vs_plain=err, parts=parts, iters_per_s=iiter / wall,
               wall_s=walls, iiter=iiter, rel_residual=resid, model_error=merr,
               residual_history=c.tolist(), kernel_launches=launches,
               profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
               profile_top=top, idle_share=1.0 - busy_ms / wall_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"non-stationary deconvolution cgls f32: {iiter} iters in "
          f"{wall:.4f} s (best of {walls}) = {iiter / wall:.1f} iters/s; "
          f"relative residual {resid:.4f} (limit {NS_RESID_LIMIT}), model "
          f"error {merr:.3f}; kernel launches (normal, stencil) {launches}; "
          f"profile, 10 iterations: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle {1 - busy_ms / wall_ms:.1%}); top "
          f"kernels (ms, name, count): {top}; peak device memory "
          f"{res['peak_gb']:.2f} GB", flush=True)
    if not resid < NS_RESID_LIMIT or np.any(np.diff(c) > 1e-5 * c[0]):
        raise RuntimeError(f"non-stationary deconvolution: residual {resid} "
                           f"or an increasing history {c}")
    del Op, x, d, mv, m, keep, sign, bank
    torch.cuda.empty_cache()
    return res


def lsm_geometry(pmtt, nz, nx, dx, ns, nr, nt, dt):
    """examples/lsm.py's sampling: sources at 10 m and receivers at 20 m
    depth over linspace(10 dx, (nx - 10) dx), a 21-sample-half Ricker of
    20 Hz centred on its peak."""
    x, z = np.arange(nx) * dx, np.arange(nz) * dx
    srcs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, ns),
                      10 * np.ones(ns)))
    recs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, nr),
                      20 * np.ones(nr)))
    t = np.arange(nt) * dt
    wav = pmtt.models.ricker(t[:21], f0=20)[0]
    return dict(z=z, x=x, t=t, sources=srcs, recs=recs, vel=V0_L, wav=wav,
                wavcenter=len(wav) // 2)


def image_peaks(minv):
    """examples/lsm.py's check: rows that are local maxima of the row
    energy above 0.3 of its largest."""
    e = np.abs(np.asarray(minv)).sum(axis=1)
    return [i for i in range(1, len(e) - 1)
            if e[i] > e[i - 1] and e[i] > e[i + 1] and e[i] > 0.3 * e.max()]


def lsm_groups(rows):
    """Device ms of an LSM apply's spray (``index_add_``: indexFunc),
    gather (``index_select``: the scatter/gather kernel), Conv1D (cuDNN)
    and other kernels."""
    out = dict(spray_ms=0.0, gather_ms=0.0, conv_ms=0.0, other_ms=0.0)
    for ms, name, _ in rows:
        low = name.lower()
        key = ("spray_ms" if "indexfunc" in low or "index_add" in low
               else "gather_ms" if "indexselect" in low
               or "scatter_gather" in low
               else "conv_ms" if any(k in low for k in (
                   "conv", "cudnn", "xmma", "implicit", "winograd"))
               else "other_ms")
        out[key] += ms
    return out


def lsm_phase(torch, pmtt, kernels, dev):
    """Phase 13: least-squares Kirchhoff migration at full width, by
    CGLS through MPILSM, and models.lsm end to end beside it."""
    from pylops_mpi_tpu_torch import Partition
    f32 = torch.float32
    torch.cuda.reset_peak_memory_stats()
    geo = lsm_geometry(pmtt, NZ_L, NX_L, DX_L, NS_L, NR_L, NT_L, DT_L)
    refl = np.zeros((NZ_L, NX_L))
    refl[ROWS_L[0]] = -1.0
    refl[ROWS_L[1]] = 0.5
    t0 = time.perf_counter()
    Op = pmtt.models.MPILSM(**geo, dtype=f32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spray = Op.ops[0].B
    entries = spray.index.numel()
    # entries past the trace carry amp 0; counted a slice of rows at a
    # time (a count over the whole table casts it to int64, 10.6 GB)
    dropped = sum(int(torch.count_nonzero(a == 0))
                  for a in spray.amp.split(NR_L))
    table_gb = entries * (spray.index.element_size()
                          + spray.amp.element_size()) / 1e9
    m = pmtt.DistributedArray.to_dist(
        torch.from_numpy(refl.ravel()).to(dev, f32),
        partition=Partition.BROADCAST)
    d = Op.matvec(m)
    repeat_equal = bool(torch.equal(d.array, Op.matvec(m).array))
    fwd = cuda_ms(lambda: Op.matvec(m), reps=5)
    adj = cuda_ms(lambda: Op.rmatvec(d), reps=5)
    # an apply reads the tables once and its input, and writes its output
    npix, nd = Op.shape[1], Op.shape[0]
    bound = bytes_bound_ms(entries * 8 + (npix + nd) * 4)
    parts = {}
    for name, fn in (("forward", lambda: Op.matvec(m)),
                     ("adjoint", lambda: Op.rmatvec(d))):
        wall, rows = device_rows(torch, fn)
        parts[name] = dict(lsm_groups(rows), profile_wall_ms=wall,
                           top=[(ms, n[:60], c) for ms, n, c in rows[:5]])
    print(f"MPILSM ({NZ_L}, {NX_L}) image, {NS_L} x {NR_L} traces of {NT_L} "
          f"samples f32: tables of {entries} entries ({table_gb:.2f} GB, "
          f"{dropped} dropped past the trace) built in {build_s:.2f} s; "
          f"forward {fwd:.3f} ms (spray {parts['forward']['spray_ms']:.3f}, "
          f"Conv1D {parts['forward']['conv_ms']:.3f}, other "
          f"{parts['forward']['other_ms']:.3f}), adjoint {adj:.3f} ms (gather "
          f"{parts['adjoint']['gather_ms']:.3f}, Conv1D "
          f"{parts['adjoint']['conv_ms']:.3f}, other "
          f"{parts['adjoint']['other_ms']:.3f}); byte bound {bound:.3f} ms; "
          f"two forward applies bitwise equal: {repeat_equal}; kernels by "
          f"time: forward {parts['forward']['top']}, adjoint "
          f"{parts['adjoint']['top']}", flush=True)
    x0 = pmtt.DistributedArray(global_shape=npix,
                               partition=Partition.BROADCAST, device=dev)
    pmtt.cgls(Op, d, x0=x0, niter=2, tol=0.0)  # warm-up
    (x, istop, iiter, r1, r2, cost), walls, launches = solve_walls(
        torch, kernels, lambda: pmtt.cgls(Op, d, x0=x0, niter=NITER, tol=0.0),
        2)
    c = cost.double().cpu().numpy()
    wall = min(walls)
    peaks = image_peaks(x.asarray().reshape(NZ_L, NX_L))
    wall_ms, busy_ms, top, _ = profile_run(
        torch, lambda: pmtt.cgls(Op, d, x0=x0, niter=10, tol=0.0))
    res = dict(build_s=build_s, entries=entries, dropped=dropped,
               table_gb=table_gb, forward_ms=fwd, adjoint_ms=adj,
               bound_ms=bound, bound_by="bytes", parts=parts,
               forward_repeat_bitwise_equal=repeat_equal,
               iters_per_s=iiter / wall, wall_s=walls, iiter=iiter,
               rel_residual=float(c[-1] / c[0]), residual_history=c.tolist(),
               peaks=peaks, kernel_launches=launches,
               profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
               profile_top=top, idle_share=1.0 - busy_ms / wall_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"LSM cgls f32: {iiter} iters in {wall:.4f} s (best of {walls}) = "
          f"{iiter / wall:.2f} iters/s; relative residual "
          f"{res['rel_residual']:.4f}; image row-energy peaks {peaks} (need "
          f"{list(ROWS_L)}); kernel launches (normal, stencil) {launches}; "
          f"profile, 10 iterations: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle {1 - busy_ms / wall_ms:.1%}); top "
          f"kernels (ms, name, count): {top}; peak device memory "
          f"{res['peak_gb']:.2f} GB", flush=True)
    if not set(ROWS_L) <= set(peaks) or np.any(np.diff(c) > 1e-5 * c[0]):
        raise RuntimeError(f"LSM: interfaces {ROWS_L} not among the peaks "
                           f"{peaks}, or the cost increases: {c}")
    del Op, spray, x, d, m, x0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the user's entry point: tables, data, CGLS and the copy to the host
    (minv, _, lcost), lwalls, _ = solve_walls(
        torch, kernels, lambda: pmtt.models.lsm(**geo, refl=refl, niter=NITER,
                                                dtype=f32, device=dev), 1)
    lpeaks = image_peaks(minv)
    res.update(lsm_wall_s=lwalls[0], lsm_peaks=lpeaks,
               lsm_rel_residual=float(lcost[-1] / lcost[0]),
               lsm_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"models.lsm: tables, data and {NITER} iters with the host copy in "
          f"{lwalls[0]:.3f} s; relative residual {res['lsm_rel_residual']:.4f}"
          f"; peaks {lpeaks}; peak device memory {res['lsm_peak_gb']:.2f} GB",
          flush=True)
    if not set(ROWS_L) <= set(lpeaks):
        raise RuntimeError(f"models.lsm: interfaces not recovered: {lpeaks}")
    torch.cuda.empty_cache()
    return res


def max_gap(pairs):
    """Largest :func:`max_rel_err` of (card, CPU) pairs of tensors or
    arrays."""
    import torch
    return max(max_rel_err(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
               for a, b in pairs)


def slice5_card_vs_cpu(torch, pmtt, rng, gaps):
    """Phase 10's problems of slice 5, into ``gaps``: MPIVStack and
    MPIHStack (batched and heterogeneous rows), MPIHalo with tuple halos,
    MPINonStationaryConvolve1D, and examples/lsm.py's lsm with its
    travel-time tables, which must be equal."""
    from pylops_mpi_tpu_torch.ops.local import Diagonal, MatrixMult
    blocks = [rng.standard_normal((10, 7)) for _ in range(8)]
    diag = rng.standard_normal(7)

    def vec(x, dev, partition=pmtt.Partition.SCATTER):
        return pmtt.DistributedArray.to_dist(x, partition=partition,
                                             device=dev)

    for kind in ("batched", "heterogeneous"):
        for name in ("vstack", "hstack"):
            outs, u = [], None
            for dev in ("cuda", "cpu"):
                rows = [MatrixMult(b, device=dev) for b in blocks]
                if kind == "heterogeneous":
                    rows[-1] = Diagonal(diag, device=dev)
                op = (pmtt.MPIVStack(rows) if name == "vstack"
                      else pmtt.MPIHStack([r.H for r in rows]))
                if u is None:
                    u = rng.standard_normal(op.shape[1])
                    v = rng.standard_normal(op.shape[0])
                bc = pmtt.Partition.BROADCAST
                pin, pout = ((bc, pmtt.Partition.SCATTER) if name == "vstack"
                             else (pmtt.Partition.SCATTER, bc))
                outs.append([op.matvec(vec(u, dev, pin)).array,
                             op.rmatvec(vec(v, dev, pout)).array])
            gaps[f"{name}_{kind}"] = max_gap(list(zip(*outs)))
    dims, halo = (6, 7), (1, 2, 0, 3)
    xh = rng.standard_normal(42)
    outs = []
    for dev in ("cuda", "cpu"):
        H = pmtt.MPIHalo(dims, halo)
        y = H.matvec(vec(xh, dev))
        outs.append([y.array, H.rmatvec(y).array])
    gaps["halo_tuple"] = max_gap(list(zip(*outs)))
    hs, ih = rng.standard_normal((8, 5)), np.arange(4, 64, 8)
    xn, yn = rng.standard_normal(320), rng.standard_normal(320)
    outs = []
    for dev in ("cuda", "cpu"):
        op = pmtt.MPINonStationaryConvolve1D((64, 5), hs, ih, axis=0,
                                             dtype=torch.float64, device=dev)
        outs.append([op.matvec(vec(xn, dev)).array,
                     op.rmatvec(vec(yn, dev)).array])
    gaps["nonstatconv"] = max_gap(list(zip(*outs)))
    # examples/lsm.py at its own size
    geo = lsm_geometry(pmtt, 60, 81, 4, 16, 11, 400, 0.002)
    tabs = [pmtt.models.KirchhoffDemigration(**geo, dtype=torch.float64,
                                             device=dev).B
            for dev in ("cuda", "cpu")]
    for name in ("itrav", "amp"):
        if not torch.equal(getattr(tabs[0], name).cpu(),
                           getattr(tabs[1], name)):
            raise RuntimeError(f"LSM {name} table differs between the card "
                               "and the CPU")
    refl = np.zeros((60, 81))
    refl[30], refl[50] = -1.0, 0.5
    sols = [pmtt.models.lsm(**geo, refl=refl, niter=NITER_LSM_F64,
                            dtype=torch.float64, device=dev)
            for dev in ("cuda", "cpu")]
    gaps["lsm_example"] = max_gap(list(zip(*sols)))
    gaps["lsm_tables"] = 0.0


def card_vs_cpu_phase(torch, pmtt):
    """Phase 10: small f64 problems of every path of this slice, and the
    regularized post-stack solve of slice 2, on the card and on the CPU
    from the same numpy inputs."""
    from pylops_mpi_tpu_torch.ops.local import FFT, MatrixMult
    gaps = {}
    rng = np.random.default_rng(11)

    def cplx(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def vec(x, dev, partition=pmtt.Partition.SCATTER):
        return pmtt.DistributedArray.to_dist(x, partition=partition,
                                             device=dev)

    # ISTA / FISTA: soft, hard and half thresholds, a complex case and a
    # sparsifying transform
    blocks = [rng.standard_normal((12, 8)) / math.sqrt(12) for _ in range(8)]
    cblocks = [cplx((12, 8)) / math.sqrt(12) for _ in range(8)]
    qs = [np.linalg.qr(rng.standard_normal((8, 8)))[0] for _ in range(8)]
    xs = np.zeros(64)
    xs[rng.choice(64, 8, replace=False)] = 3 * rng.standard_normal(8)

    def bd(bl, dev):
        return pmtt.MPIBlockDiag([MatrixMult(b, device=dev) for b in bl])

    for name, kind, bl, sop in (
            ("ista", "soft", blocks, None), ("fista", "soft", blocks, None),
            ("ista", "hard", blocks, None), ("fista", "hard", blocks, None),
            ("ista", "half", blocks, None), ("fista", "half", blocks, None),
            ("fista", "soft", cblocks, None), ("fista", "soft", blocks, qs)):
        outs = []
        for dev in ("cuda", "cpu"):
            Op = bd(bl, dev)
            y = Op @ vec(xs.astype(bl[0].dtype), dev)
            x, iiter, cost = getattr(pmtt, name)(
                Op, y, x0=vec(np.zeros(64, dtype=bl[0].dtype), dev),
                niter=40, eps=0.05, tol=0.0, threshkind=kind,
                SOp=None if sop is None else bd(sop, dev))
            outs.append((x.array, cost, iiter))
        if outs[0][2] != outs[1][2]:
            raise RuntimeError(f"{name}/{kind}: iterations differ")
        label = (f"{name}_{kind}" + ("_complex" if bl is cblocks else "")
                 + ("_sop" if sop is not None else ""))
        gaps[label] = max_gap([(outs[0][0], outs[1][0]),
                               (outs[0][1], outs[1][1])])
    # power_iteration on the normal operator
    eig = [pmtt.power_iteration(bd(blocks, dev).H @ bd(blocks, dev),
                                vec(np.zeros(64), dev), niter=50, tol=0.0)[0]
           for dev in ("cuda", "cpu")]
    gaps["power_iteration"] = abs(eig[0] - eig[1]) / abs(eig[1])
    # MPIFredholm1: forward, adjoint and conj, with and without G^H kept
    G = cplx((16, 12, 10))
    m, dd = cplx(16 * 10 * 3), cplx(16 * 12 * 3)
    for save in (False, True):
        outs = []
        for dev in ("cuda", "cpu"):
            F = pmtt.MPIFredholm1(G, nz=3, saveGt=save,
                                  dtype=torch.complex128, device=dev)
            bm, bd_ = (vec(v, dev, pmtt.Partition.BROADCAST) for v in (m, dd))
            outs.append([F.matvec(bm).array, F.rmatvec(bd_).array,
                         F.conj().matvec(bm).array,
                         F.conj().rmatvec(bd_).array])
        gaps[f"fredholm_saveGt_{save}"] = max_gap(list(zip(*outs)))
    # FFT.H on half-spectra with imaginary DC and Nyquist parts
    for nfft in (32, 33):
        op = FFT((nfft, 5), axis=0, real=True, dtype=torch.float64)
        v = cplx(op.shape[0])
        outs = [op.rmatvec(torch.from_numpy(v).to(dev)) for dev in ("cuda",
                                                                     "cpu")]
        gaps[f"fft_adjoint_nfft{nfft}"] = max_gap([outs])
    # examples/mdd.py's problem through models.mdd
    g3 = np.random.default_rng(3)
    ns, nr, nt, nv = 6, 4, 33, 1
    Gt = g3.standard_normal((ns, nr, nt)) * np.exp(
        -0.2 * np.arange(nt))[None, None, :]
    Gf = pmtt.models.kernel_to_frequency(Gt)
    xtrue = g3.standard_normal(nt * nr * nv)
    Op = pmtt.MPIMDC(Gf, nt=nt, nv=nv, device="cpu")
    dmdd = Op.matvec(vec(xtrue, "cpu", pmtt.Partition.BROADCAST)).asarray()
    sols = [pmtt.models.mdd(Gf, dmdd.reshape(nt, ns, nv), nt=nt, nv=nv,
                            niter=200, device=dev)[0] for dev in ("cuda",
                                                                  "cpu")]
    gaps["mdd_example"] = max_gap([sols])
    # slice 2: the Gradient-regularized post-stack solve
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    msmall = layered_model(torch, 64, 128, "cpu", seed=5)
    sols = []
    for dname in ("cuda", "cpu"):
        S, ys, _ = gradient_poststack(torch, pmtt, msmall.to(dname), wav, 30,
                                      torch.float64)
        x, _, _, _, _, cost = pmtt.cgls(S, ys, niter=30, damp=DAMP, tol=0.0)
        sols.append((torch.from_numpy(x.asarray()), cost.cpu()))
    gaps["gradient_poststack"] = max_gap([(sols[0][0], sols[1][0]),
                                          (sols[0][1], sols[1][1])])
    slice5_card_vs_cpu(torch, pmtt, rng, gaps)
    worst = max(gaps, key=gaps.get)
    print(f"card vs CPU in f64 (max rel gap, tol {F64_GAP:.0e}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f"; largest {worst} {gaps[worst]:.3e}", flush=True)
    if not gaps[worst] <= F64_GAP:
        raise RuntimeError(f"card and CPU disagree: {worst} {gaps[worst]:.3e}")
    return gaps


def group_of_one_phase(torch, pmtt, kernels, dev, ref_x):
    """Phase 14: the main path (32x4096^2, normal=True f32 and bf16
    storage, classic f32) and the Gradient-regularized post-stack CGLS
    through a process group of one rank over NCCL. Each x must equal the
    no-group run's (phases 3 and 7): bitwise, or within 1e-6 relative.

    The group's cost is read in pairs: each pair times one solve with
    the group's collectives and one with them stubbed out (they return
    at once, as without a group; the device work is the same), in
    alternating order, so that host drift falls on both sides alike.
    Returns the summary and the group's 10-iteration solutions of the
    two paths, which phase 15's ranks are held against."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.parallel import collectives as co
    A, _, y_t = make_problem(torch, dev)
    y = pmtt.DistributedArray.to_dist(y_t)
    cases = {"normal_f32": (None, True), "normal_bf16": (torch.bfloat16, True),
             "classic_f32": (None, False)}
    ops = {label: pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)],
                                    compute_dtype=cdt)
           for label, (cdt, _) in cases.items()}
    del A
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=4)
    StackOp, ystack, _ = gradient_poststack(torch, pmtt, m, wav, NITER,
                                            torch.float32)
    del m
    grouped = co.initialized

    def solve(label, niter, stub=False):
        co.initialized = (lambda: False) if stub else grouped
        try:
            if label == "gradient":
                return pmtt.cgls(StackOp, ystack, niter=niter, damp=DAMP,
                                 tol=0.0)
            return pmtt.cgls(ops[label], y, niter=niter, tol=0.0,
                             normal=cases[label][1])
        finally:
            co.initialized = grouped

    def timed(label, stub):
        co.reset_counts()
        for k in kernels:
            k.reset_launches()
        t0 = time.perf_counter()
        out = solve(label, NITER, stub)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, out, dict(co.counts), {
            k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}

    def measure():
        res = {}
        for label in list(cases) + ["gradient"]:
            solve(label, 2)  # warm-up, both ways
            solve(label, 2, stub=True)
            torch.cuda.synchronize()
            walls = {False: [], True: []}
            for i in range(PAIRS):
                for stub in ((False, True) if i % 2 == 0 else (True, False)):
                    wall, out, calls, launches = timed(label, stub)
                    walls[stub].append(wall)
                    if stub:
                        x_stub = out[0].array.clone()
                    else:
                        x, iiter, counts = out[0].array.clone(), out[2], calls
                        per_iter = {k: v / iiter for k, v in launches.items()}
            ratios = [g / s for g, s in zip(walls[False], walls[True])]
            res[label] = dict(
                x=x, x_stub=x_stub, iiter=iiter, wall_s=walls[False],
                stub_wall_s=walls[True], pair_ratios=ratios,
                iters_per_s=iiter / float(np.median(walls[False])),
                stub_iters_per_s=iiter / float(np.median(walls[True])),
                collectives_per_iter={k: v / iiter for k, v in counts.items()},
                launches_per_iter=per_iter)
        return res

    def host_ms(fn):
        """The host side of the collectives over one call of ``fn``:
        ``torch.profiler``'s CPU events whose name holds ``allreduce``
        or ``nccl``, as (ms in all, name, count)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as p:
            fn()
            torch.cuda.synchronize()
        return [(e.cpu_time_total / 1e3, e.key[:60], e.count)
                for e in p.key_averages()
                if "allreduce" in e.key.lower() or "nccl" in e.key.lower()]

    def call_us(fn, reps=200):
        """Host microseconds a call of ``fn`` takes, back to back, the
        device drained at the end."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    scalar = torch.ones((), device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_group_")
    mesh = pmtt.parallel.init(backend="nccl",
                              store=dist.FileStore(f"{tmp}/store", 1),
                              rank=0, world_size=1, device=dev)
    try:
        res = measure()
        x10 = {label: solve(label, 10)[0].array.clone()
               for label in ("normal_f32", "gradient")}
        # one reduction of a 0-d tensor, as a CGLS iteration issues 3 to 5
        allreduce_us = call_us(lambda: co.all_reduce(scalar))
        prof = {(label, stub): profile_run(
                    torch, lambda: solve(label, 10, stub), match=("nccl",))
                for label in ("normal_f32", "normal_bf16")
                for stub in (False, True)}
        host = {label: host_ms(lambda: solve(label, 10))
                for label in ("normal_f32", "normal_bf16")}
    finally:
        pmtt.parallel.destroy()
        shutil.rmtree(tmp, ignore_errors=True)
    # without a group the same call returns at once; a small kernel on a
    # 0-d tensor for scale
    nogroup_us = call_us(lambda: co.all_reduce(scalar))
    kernel_us = call_us(lambda: scalar.mul_(1.0))
    summary = dict(backend=mesh.backend, world_size=mesh.size, pairs=PAIRS,
                   all_reduce_us=allreduce_us, nogroup_call_us=nogroup_us,
                   small_kernel_us=kernel_us)
    print(f"group of one (nccl): an all_reduce of a 0-d tensor takes "
          f"{allreduce_us:.1f} us of host time back to back (no group: "
          f"{nogroup_us:.2f} us; a one-element kernel {kernel_us:.1f} us)",
          flush=True)
    for label in ("normal_f32", "normal_bf16"):
        wall, busy, top, nccl = prof[label, False]
        wall0, busy0, _, _ = prof[label, True]
        summary[f"profile_{label}"] = dict(
            wall_ms=wall, device_ms=busy, nccl_ms=nccl, top=top,
            stub_wall_ms=wall0, stub_device_ms=busy0,
            collective_host_ms=host[label])
        print(f"  profile {label}, 10 iterations: with the group device busy "
              f"{busy:.3f} of {wall:.3f} ms wall, NCCL kernels {nccl:.3f} ms;"
              f" collectives stubbed {busy0:.3f} of {wall0:.3f} ms; host "
              f"side of the collectives (ms, name, count): {host[label]}; "
              f"top kernels (ms, name, count): {top}", flush=True)
    for label, g in res.items():
        want = ref_x[label]
        bitwise = bool(torch.equal(g["x"], want))
        rel = max_rel_err(g["x"], want)
        ratios = g["pair_ratios"]
        summary[label] = dict(
            bitwise=bitwise, max_rel_diff=rel,
            stub_bitwise=bool(torch.equal(g["x_stub"], want)),
            iters_per_s=g["iters_per_s"], wall_s=g["wall_s"],
            stub_iters_per_s=g["stub_iters_per_s"],
            stub_wall_s=g["stub_wall_s"], pair_ratios=ratios,
            ratio_median=float(np.median(ratios)),
            ratio_min=min(ratios), ratio_max=max(ratios),
            collectives_per_iter=g["collectives_per_iter"],
            launches_per_iter=g["launches_per_iter"])
        print(f"group of one (nccl) {label}: x {'bitwise equal to' if bitwise else 'differs from'}"
              f" the no-group run (max rel diff {rel:.3e}, limit 1e-6); "
              f"median of {PAIRS} alternating pairs {g['iters_per_s']:.1f} "
              f"iters/s with the group, {g['stub_iters_per_s']:.1f} with "
              f"its collectives stubbed; wall ratio group/stubbed median "
              f"{np.median(ratios):.4f}, range [{min(ratios):.4f}, "
              f"{max(ratios):.4f}]; collectives per iteration "
              f"{g['collectives_per_iter']}; kernel launches per iteration "
              f"{g['launches_per_iter']}", flush=True)
        if not (bitwise or rel <= 1e-6):
            raise RuntimeError(f"group of one: {label} x differs from the "
                               f"no-group run by {rel:.3e}")
        if not summary[label]["stub_bitwise"]:
            raise RuntimeError(f"{label}: the stubbed run differs from "
                               "phase 3/7")
    return summary, x10


def ragged_f64_case(torch, pmtt, dev):
    """Phase 15's ragged f64 case, run alike by a world of ranks and by
    one process without a group: CGLS (normal=True, 20 iterations) on 10
    blocks of 64x64, the Gradient of a (101, 64) field forward and
    adjoint, and the Gradient-regularized post-stack CGLS on it (20
    iterations). Returns the gathered results."""
    f64 = torch.float64
    D = pmtt.DistributedArray
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((64, 64)) / 8 + 4 * np.eye(64)
              for _ in range(10)]
    yb = rng.standard_normal(640)
    Op = pmtt.convert.blockdiag_from_numpy(blocks, device=dev)
    xb = pmtt.cgls(Op, D.to_dist(yb, local_shapes=Op.local_shapes_n,
                                 device=dev), niter=20, tol=0.0,
                   normal=True)[0]
    nx, nt0 = 101, 64
    f = rng.standard_normal(nx * nt0)
    G = pmtt.MPIGradient((nx, nt0), dtype=f64)
    gf = G.matvec(D.to_dist(f, local_shapes=G.local_shapes_m, device=dev))
    ga = G.rmatvec(gf)
    wav = pmtt.models.ricker(np.arange(15) * 0.004, f0=15)[0]
    mm = np.cumsum(rng.standard_normal((nx, nt0)) * 0.03, axis=1) + 2.0
    P = pmtt.models.MPIPoststackLinearModelling(wav, nt0, nx, dtype=f64,
                                                device=dev)
    d = P.matvec(D.to_dist(mm.ravel(), local_shapes=P.local_shapes_m,
                           device=dev))
    zero = pmtt.StackedDistributedArray([
        D(global_shape=nx * nt0, local_shapes=G.local_shapes_m, dtype=f64,
          device=dev) for _ in range(2)])
    xs = pmtt.cgls(pmtt.MPIStackedVStack([P, EPS_R * G]),
                   pmtt.StackedDistributedArray([d, zero]), niter=20,
                   damp=DAMP, tol=0.0)[0]
    return dict(blockdiag_cgls=xb.asarray(), gradient=gf.asarray(),
                gradient_adjoint=ga.asarray(), gradient_cgls=xs.asarray())


def _shared_card_cases(torch, pmtt, dev):
    """What each rank of phase 15 runs; returns this rank's record."""
    from pylops_mpi_tpu_torch.ops import derivatives
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops import stencil_kernels as sk
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.parallel import collectives as co
    r = pmtt.parallel.rank()
    out = dict(rank=r)
    # the main path at full width: each rank keeps its chunk of the blocks
    A, _, y_t = make_problem(torch, dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    y = pmtt.DistributedArray.to_dist(y_t, local_shapes=Op.local_shapes_n)
    nk.reset_launches()
    co.reset_counts()
    x = pmtt.cgls(Op, y, niter=10, tol=0.0, normal=True)[0]
    torch.cuda.synchronize()
    out["main"] = dict(blocks=len(Op.ops), stack=tuple(Op._batched.shape),
                       launches=nk.launches, collectives=dict(co.counts))
    xg = x.asarray()
    out["main"]["x"] = xg if r == 0 else None
    del Op, x, y
    torch.cuda.empty_cache()
    # the post-stack CGLS: the tap kernel on each rank's rows, fed the
    # ghost rows received from its neighbours
    received = [0, 0]
    real = sk.stencil_taps

    def counting(slab, taps, w, out_pad=(0, 0), *, top=0, bottom=0):
        received[0] += 1
        received[1] += isinstance(top, torch.Tensor) or \
            isinstance(bottom, torch.Tensor)
        return real(slab, taps, w, out_pad, top=top, bottom=bottom)

    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=4)
    StackOp, ystack, _ = gradient_poststack(torch, pmtt, m, wav, 10,
                                            torch.float32)
    del m
    sk.stencil_taps = counting
    sk.reset_launches()
    derivatives.paths.clear()
    co.reset_counts()
    try:
        x = pmtt.cgls(StackOp, ystack, niter=10, damp=DAMP, tol=0.0)[0]
        torch.cuda.synchronize()
    finally:
        sk.stencil_taps = real
    out["post"] = dict(launches=sk.launches, calls=received[0],
                       with_received_ghosts=received[1],
                       paths=dict(derivatives.paths),
                       collectives=dict(co.counts),
                       rows=StackOp.ops[1].args[0].local_shapes_m[r][0] // NT0)
    xg = x.asarray()
    out["post"]["x"] = xg if r == 0 else None
    del StackOp, ystack, x
    torch.cuda.empty_cache()
    f64 = ragged_f64_case(torch, pmtt, dev)
    out["f64"] = f64 if r == 0 else None
    return out


def _shared_card_rank(r, n, store_path, out_dir, here, cases, args):
    """A spawned rank of phases 15 and 16: gloo, every rank on card 0,
    running ``cases(torch, pmtt, dev, *args)``."""
    import pickle
    sys.path.insert(0, here)
    import torch
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    dev = torch.device("cuda", 0)
    pmtt.parallel.init(backend="gloo", store=dist.FileStore(store_path, n),
                       rank=r, world_size=n, device=dev)
    try:
        res = cases(torch, pmtt, dev, *args)
    finally:
        pmtt.parallel.destroy()
    with open(f"{out_dir}/rank{r}.pkl", "wb") as f:
        pickle.dump(res, f)


def spawn_shared_card(n, here, cases, args=(), timeout=600):
    """``n`` gloo ranks sharing the card, each running ``cases``; returns
    their records in rank order. A rank that raises, or a world that
    outlives ``timeout`` seconds (its processes are killed), raises."""
    import pickle
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        ctx = mp.spawn(_shared_card_rank,
                       args=(n, f"{tmp}/store", tmp, str(here), cases, args),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise RuntimeError(f"{n} gloo ranks did not finish in "
                                   f"{timeout} s")
        ranks = []
        for r in range(n):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shared_card_phase(torch, pmtt, here, x10, worlds=(2, 3), timeout=600):
    """Phase 15: worlds of two and three ranks sharing the one card over
    gloo (spawned processes; their exchanges staged through the host).
    Correctness only: the main path at full width and the post-stack
    CGLS (10 iterations each) against phase 14's group of one within
    1e-5 relative, and the ragged f64 case against one CPU process
    within 1e-10; the normal kernel and the tap kernel must run on every
    rank, the tap kernel with received ghost rows."""
    cpu = ragged_f64_case(torch, pmtt, torch.device("cpu"))
    want = {"main": x10["normal_f32"].cpu().numpy(),
            "post": x10["gradient"].cpu().numpy()}
    summary = {}
    for n in worlds:
        t0 = time.perf_counter()
        ranks = spawn_shared_card(n, here, _shared_card_cases,
                                  timeout=timeout)
        errs = {}
        for key in ("main", "post"):
            got = ranks[0][key]["x"]
            errs[key] = float(np.abs(got - want[key]).max()
                              / np.abs(want[key]).max())
        got = ranks[0]["f64"]
        errs["f64"] = max(float(np.abs(got[k] - cpu[k]).max()
                                / np.abs(cpu[k]).max()) for k in cpu)
        per_rank = [dict(rank=o["rank"], blocks=o["main"]["blocks"],
                         normal_launches=o["main"]["launches"],
                         rows=o["post"]["rows"],
                         stencil_launches=o["post"]["launches"],
                         stencil_calls_with_received_ghosts=
                         o["post"]["with_received_ghosts"],
                         paths=o["post"]["paths"],
                         main_collectives=o["main"]["collectives"],
                         post_collectives=o["post"]["collectives"])
                    for o in ranks]
        summary[n] = dict(max_rel_err=errs, ranks=per_rank,
                          seconds=time.perf_counter() - t0)
        print(f"{n} ranks on one card (gloo): main path x vs the group of "
              f"one {errs['main']:.3e} (limit 1e-5), post-stack x "
              f"{errs['post']:.3e} (limit 1e-5), ragged f64 vs CPU "
              f"{errs['f64']:.3e} (limit 1e-10); per rank {per_rank}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if errs["main"] > 1e-5 or errs["post"] > 1e-5 or errs["f64"] > 1e-10:
            raise RuntimeError(f"{n} gloo ranks: results disagree: "
                               f"{errs}")
        for o in per_rank:
            if o["normal_launches"] != 10:
                raise RuntimeError(f"gloo: rank {o['rank']} launched the "
                                   f"normal kernel {o['normal_launches']} "
                                   "times in 10 iterations")
            if (o["stencil_launches"] < 20
                    or o["stencil_calls_with_received_ghosts"]
                    != o["stencil_launches"] or o["paths"].get("gather")):
                raise RuntimeError(f"gloo: rank {o['rank']} did not run "
                                   f"the tap kernel on received ghost rows: "
                                   f"{o}")
    return summary


def mdd_kernel_host(torch):
    """Phase 16's MDD kernel, phase 8's law on the host from a seeded CPU
    generator, so that every rank passes the same whole kernel and moves
    only its chunk of the frequencies to the card."""
    g = torch.Generator().manual_seed(16)
    G = torch.randn((NFMAX, NS_MDD, NR_MDD), generator=g,
                    dtype=torch.complex64) / math.sqrt(NR_MDD)
    G.diagonal(dim1=1, dim2=2).add_(4.0)
    return G


def lsm_model():
    refl = np.zeros((NZ_L, NX_L))
    refl[ROWS_L[0]] = -1.0
    refl[ROWS_L[1]] = 0.5
    return refl


def halo_windows(f, dims, halo, grid):
    """What ``MPIHalo(dims, halo, grid)`` gives with a per-axis tuple
    ``halo``, in numpy. ``f`` holds the ranks' blocks (the ceil split,
    ranks in row-major grid order) one after the other, each in C order;
    each rank's output is its block widened by the halo on both sides
    (kept at the grid's edges), zeros outside the field."""
    g = np.zeros(dims)
    cuts = []
    off = 0
    for r in range(int(np.prod(grid))):
        coords = np.unravel_index(r, grid)
        blk = []
        for n_, p_, c in zip(dims, grid, coords):
            bs = -(-n_ // p_)
            blk.append(slice(c * bs, min(c * bs + bs, n_)))
        shape = tuple(b.stop - b.start for b in blk)
        g[tuple(blk)] = np.asarray(f)[off:off + int(np.prod(shape))] \
            .reshape(shape)
        off += int(np.prod(shape))
        cuts.append(blk)
    out = []
    for blk in cuts:
        win, pads = [], []
        for n_, b, h in zip(dims, blk, halo):
            lo, hi = b.start - h, b.stop + h
            win.append(slice(max(lo, 0), min(hi, n_)))
            pads.append((max(-lo, 0), max(hi - n_, 0)))
        out.append(np.pad(g[tuple(win)], pads).ravel())
    return np.concatenate(out)


def slice7_f64_case(torch, pmtt, dev):
    """Phase 16's ragged f64 case, run alike by a world of ranks and by
    one process without a group: MPIHalo on a 2-D grid with a tuple
    halo over an (11, 9) field (ragged blocks), MPIHStack of 7 blocks,
    a masked MPIVStack of the same blocks (mask r % 2) and a local
    operator on a SCATTER vector. Returns the gathered results and this
    rank's group norm of the masked data."""
    from pylops_mpi_tpu_torch.ops.local import FirstDerivative
    D = pmtt.DistributedArray
    bc = pmtt.Partition.BROADCAST
    n = pmtt.parallel.world_size()
    rng = np.random.default_rng(17)
    grid = (2, 2) if n == 4 else (n, 1)
    H = pmtt.MPIHalo((11, 9), (1, 2), grid, None, np.float64)
    f = rng.standard_normal(99)
    y = H.matvec(D.to_dist(f, local_shapes=H.local_dim_sizes, device=dev))
    blocks = [rng.standard_normal((7, 5)) for _ in range(7)]
    Hs = pmtt.convert.hstack_from_numpy(blocks, device=dev)
    hy = Hs.matvec(D.to_dist(rng.standard_normal(35), device=dev))
    hx = Hs.rmatvec(D.to_dist(rng.standard_normal(7), partition=bc,
                              device=dev))
    V = pmtt.convert.vstack_from_numpy(blocks, device=dev,
                                       mask=[r % 2 for r in range(n)])
    vy = V.matvec(D.to_dist(rng.standard_normal(5), partition=bc,
                            device=dev))
    vx = V.rmatvec(vy)
    L = pmtt.asmpilinearoperator(FirstDerivative((10, 9), dtype=torch.float64))
    ly = L.matvec(D.to_dist(rng.standard_normal(90), device=dev))
    lx = L.rmatvec(ly)
    return dict(f=f, halo=y.asarray(), halo_back=H.rmatvec(y).asarray(),
                hstack=hy.asarray(), hstack_adjoint=hx.asarray(),
                masked=vy.asarray(), masked_adjoint=vx.asarray(),
                local=ly.asarray(), local_adjoint=lx.asarray(),
                group_norm=float(vy.norm()), grid=grid)


def _slice7_cases(torch, pmtt, dev, cases, refdir):
    """What each rank of phase 16 runs (``cases`` of "vstack", "mdd",
    "nonstat", "lsm", "f64"); returns this rank's record. Every solve's
    x is held to the no-group solve's, saved by the main process under
    ``refdir``; every rank computes the gap (the gathers are
    collective)."""
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops import stencil_kernels as sk
    from pylops_mpi_tpu_torch.ops.blockdiag import _chunk_ops
    from pylops_mpi_tpu_torch.ops.local import MatrixMult, ShapeOnly
    from pylops_mpi_tpu_torch.parallel import collectives as co
    D = pmtt.DistributedArray
    bc = pmtt.Partition.BROADCAST
    r, n = pmtt.parallel.rank(), pmtt.parallel.world_size()
    out = dict(rank=r)

    def gap(got, name):
        want = np.load(f"{refdir}/{name}.npy").ravel()
        got = np.asarray(got, dtype=np.float64).ravel()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def solve(fn, niter):
        """``fn()``'s result, collective calls per iteration, the wall
        per iteration (gloo ranks sharing one card) and the hand
        kernels' launches (none on this slice's paths)."""
        co.reset_counts()
        for k in (nk, sk):
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(calls_per_iter={k: v / niter for k, v in
                                         co.counts.items()},
                         wall_per_iter_s=(time.perf_counter() - t0) / niter,
                         kernel_launches=[nk.launches, sk.launches])

    def received(fn):
        co.reset_counts()
        fn()
        return dict(co.received)

    if "vstack" in cases:
        A, _, _ = make_problem(torch, dev)
        mine = set(_chunk_ops(list(range(NBLK)), n)[r])
        rows = [MatrixMult(A[i].clone()) if i in mine
                else ShapeOnly(NBLOCK, NBLOCK, dtype=torch.float32)
                for i in range(NBLK)]
        del A
        torch.cuda.empty_cache()
        xt = torch.randn(NBLOCK, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))
        out["vstack"] = {}
        for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
            V = pmtt.MPIVStack(rows, compute_dtype=cdt)
            y = V.matvec(D.to_dist(xt, partition=bc))
            x0 = D(global_shape=NBLOCK, partition=bc, device=dev)
            x, st = solve(lambda: pmtt.cgls(V, y, x0=x0, niter=NITER_16,
                                            tol=0.0)[0], NITER_16)
            out["vstack"][label] = dict(
                blocks=len(V.ops), stack=tuple(V._batched.shape),
                x_gap=gap(x.asarray(), f"vstack_{label}"),
                bytes_per_adjoint=received(lambda: V.rmatvec(y)), **st)
            del V, y, x
        del rows
        torch.cuda.empty_cache()
    if "mdd" in cases:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        G = mdd_kernel_host(torch)
        d = np.load(f"{refdir}/mdd_d.npy")
        (minv, Op), st = solve(lambda: pmtt.models.mdd(
            G, d, NT_MDD, NV_MDD, DT_MDD, DR_MDD, True, NITER_16, tol=0.0,
            device=dev), NITER_16)
        del G
        Fr = Op.args[0].args[0].args[1]
        x0 = D(global_shape=Op.shape[1], partition=bc, device=dev)
        out["mdd"] = dict(
            slices=Fr.G.shape[0],
            G_gb=(Fr.G.numel() + Fr.GT.numel()) * Fr.G.element_size() / 1e9,
            x_gap=gap(minv, "mdd_x"),
            bytes_per_forward=received(lambda: Op.matvec(x0)),
            peak_gb=peak_gb(torch, base), **st)
        del Op, Fr, x0, minv
        torch.cuda.empty_cache()
    if "nonstat" in cases:
        hs, ih = nonstat_filters(pmtt)
        Op = pmtt.MPINonStationaryConvolve1D((NT_NS, NTR_NS), hs, ih, 0,
                                             None, torch.float32, device=dev)
        d = D.to_dist(torch.from_numpy(np.load(f"{refdir}/nonstat_d.npy"))
                      .to(dev))
        x, st = solve(lambda: pmtt.cgls(Op, d, x0=d.zeros_like(),
                                        niter=NITER_16, tol=0.0)[0], NITER_16)
        out["nonstat"] = dict(
            halo=Op.args[1]._base_halo[0], rows=d.local_shape[0] // NTR_NS,
            x_gap=gap(x.asarray(), "nonstat_x"),
            bytes_per_forward=received(lambda: Op.matvec(x)), **st)
        del Op, d, x
        torch.cuda.empty_cache()
    if "lsm" in cases:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        geo = lsm_geometry(pmtt, NZ_L, NX_L, DX_L, NS_L, NR_L, NT_L, DT_L)
        Op = pmtt.models.MPILSM(**geo, dtype=torch.float32, device=dev)
        spray = Op.ops[0].B
        m = D.to_dist(torch.from_numpy(lsm_model().ravel()).to(dev,
                                                               torch.float32),
                      partition=bc)
        d = Op.matvec(m)
        x0 = D(global_shape=Op.shape[1], partition=bc, device=dev)
        x, st = solve(lambda: pmtt.cgls(Op, d, x0=x0, niter=NITER_16_LSM,
                                        tol=0.0)[0], NITER_16_LSM)
        x1 = pmtt.cgls(Op, d, x0=x0, niter=1, tol=0.0)[0]
        dref = D.to_dist(torch.from_numpy(np.load(f"{refdir}/lsm_d.npy"))
                         .to(dev), local_shapes=Op.local_shapes_n)
        out["lsm"] = dict(
            sources=spray.index.shape[0] // NR_L,
            table_gb=spray.index.numel() * (spray.index.element_size()
                                            + spray.amp.element_size()) / 1e9,
            forward_gap=gap(d.asarray(), "lsm_d"),
            adjoint_gap=gap(Op.rmatvec(dref).asarray(), "lsm_xa"),
            x1_gap=gap(x1.asarray(), "lsm_x1"),
            x_gap=gap(x.asarray(), "lsm_x"),
            bytes_per_adjoint=received(lambda: Op.rmatvec(d)),
            peak_gb=peak_gb(torch, base), **st)
        del Op, spray, m, d, x, x1, x0, dref
        torch.cuda.empty_cache()
        out["lsm"]["x_f64_gap"] = gap(lsm_f64_solve(torch, pmtt, dev),
                                      "lsm_x_f64")
        torch.cuda.empty_cache()
    if "f64" in cases:
        out["f64"] = slice7_f64_case(torch, pmtt, dev)
    return out


def slice7_references(torch, pmtt, dev, refdir):
    """Phase 16's configurations solved here with no group, saved under
    ``refdir``; returns one rank's MDD kernel share and LSM table size
    and peak memory, against which the ranks' are held."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    D = pmtt.DistributedArray
    bc = pmtt.Partition.BROADCAST
    one = {}
    A, _, _ = make_problem(torch, dev)
    rows = [MatrixMult(A[i]) for i in range(NBLK)]
    xt = torch.randn(NBLOCK, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        V = pmtt.MPIVStack(rows, compute_dtype=cdt)
        y = V.matvec(D.to_dist(xt, partition=bc))
        x = pmtt.cgls(V, y, x0=D(global_shape=NBLOCK, partition=bc,
                                 device=dev), niter=NITER_16, tol=0.0)[0]
        np.save(f"{refdir}/vstack_{label}.npy", x.asarray())
        del V, y, x
    del A, rows
    torch.cuda.empty_cache()
    # MDD: data from a known model in the operator's row space (phase 8)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    G = mdd_kernel_host(torch)
    Op = pmtt.MPIMDC(G, nt=NT_MDD, nv=NV_MDD, dt=DT_MDD, dr=DR_MDD,
                     twosided=True, saveGt=True, device=dev)
    Fr = Op.args[0].args[0].args[1]
    one["mdd_G_gb"] = ((Fr.G.numel() + Fr.GT.numel())
                       * Fr.G.element_size() / 1e9)
    g = torch.Generator(device=dev).manual_seed(6)
    w = D.to_dist(torch.randn(Op.shape[0], generator=g, device=dev),
                  partition=bc)
    xm = Op.rmatvec(w)
    xm = xm * (math.sqrt(Op.shape[1]) / xm.norm())
    d = Op.matvec(xm).array.view(NT_MDD, NS_MDD, NV_MDD)
    np.save(f"{refdir}/mdd_d.npy", d.cpu().numpy())
    del Op, Fr, w, xm
    torch.cuda.empty_cache()
    minv = pmtt.models.mdd(G, d, NT_MDD, NV_MDD, DT_MDD, DR_MDD, True,
                           NITER_16, tol=0.0, device=dev)[0]
    np.save(f"{refdir}/mdd_x.npy", minv)
    one["mdd_peak_gb"] = peak_gb(torch, base)
    del G, d, minv
    torch.cuda.empty_cache()
    # non-stationary deconvolution of phase 12's sparse reflectivity
    hs, ih = nonstat_filters(pmtt)
    Op = pmtt.MPINonStationaryConvolve1D((NT_NS, NTR_NS), hs, ih, 0, None,
                                         torch.float32, device=dev)
    gn = torch.Generator(device=dev).manual_seed(10)
    dims = (NT_NS, NTR_NS)
    keep = torch.rand(dims, generator=gn, device=dev) < SPIKE_FRACTION
    sign = torch.randint(0, 2, dims, generator=gn, device=dev) * 2 - 1
    mv = D.to_dist(torch.where(keep, sign, 0).to(torch.float32).reshape(-1))
    d = Op.matvec(mv)
    np.save(f"{refdir}/nonstat_d.npy", d.array.cpu().numpy())
    x = pmtt.cgls(Op, d, x0=d.zeros_like(), niter=NITER_16, tol=0.0)[0]
    np.save(f"{refdir}/nonstat_x.npy", x.asarray())
    del Op, keep, sign, mv, d, x
    torch.cuda.empty_cache()
    # LSM at phase 13's width
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    geo = lsm_geometry(pmtt, NZ_L, NX_L, DX_L, NS_L, NR_L, NT_L, DT_L)
    Op = pmtt.models.MPILSM(**geo, dtype=torch.float32, device=dev)
    spray = Op.ops[0].B
    one["lsm_table_gb"] = spray.index.numel() * (
        spray.index.element_size() + spray.amp.element_size()) / 1e9
    m = D.to_dist(torch.from_numpy(lsm_model().ravel()).to(dev, torch.float32),
                  partition=bc)
    d = Op.matvec(m)
    np.save(f"{refdir}/lsm_d.npy", d.asarray())
    np.save(f"{refdir}/lsm_xa.npy", Op.rmatvec(d).asarray())
    # the spray's atomics add in no fixed order: a second solve gives the
    # spread of x from one no-group run to the next
    xs = [pmtt.cgls(Op, d, x0=D(global_shape=Op.shape[1], partition=bc,
                                device=dev), niter=NITER_16_LSM,
                    tol=0.0)[0].asarray() for _ in range(2)]
    np.save(f"{refdir}/lsm_x.npy", xs[0])
    np.save(f"{refdir}/lsm_x1.npy", pmtt.cgls(
        Op, d, x0=D(global_shape=Op.shape[1], partition=bc, device=dev),
        niter=1, tol=0.0)[0].asarray())
    one["lsm_x_repeat_gap"] = float(np.linalg.norm(xs[1] - xs[0])
                                    / np.linalg.norm(xs[0]))
    one["lsm_peak_gb"] = peak_gb(torch, base)
    del Op, spray, m, d
    torch.cuda.empty_cache()
    np.save(f"{refdir}/lsm_x_f64.npy", lsm_f64_solve(torch, pmtt, dev))
    torch.cuda.empty_cache()
    return one


def lsm_f64_solve(torch, pmtt, dev):
    """Phase 16's LSM in f64 at the same width: x after the same CGLS
    iterations, gathered (each rank builds its own batch's tables)."""
    f64 = torch.float64
    geo = lsm_geometry(pmtt, NZ_L, NX_L, DX_L, NS_L, NR_L, NT_L, DT_L)
    Op = pmtt.models.MPILSM(**geo, dtype=f64, device=dev)
    bc = pmtt.Partition.BROADCAST
    m = pmtt.DistributedArray.to_dist(
        torch.from_numpy(lsm_model().ravel()).to(dev, f64), partition=bc)
    x0 = pmtt.DistributedArray(global_shape=Op.shape[1], partition=bc,
                               dtype=f64, device=dev)
    return pmtt.cgls(Op, Op.matvec(m), x0=x0, niter=NITER_16_LSM,
                     tol=0.0)[0].asarray()


def f64_gaps(got, cpu):
    """Phase 16's ragged f64 case of a world of ``n`` ranks against one
    CPU process: the halo against :func:`halo_windows` (the world of one
    has one block), the crop against the field, the rest against the
    no-group run."""

    def rel(a, b):
        return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())

    gaps = dict(halo=rel(got["halo"], halo_windows(
        got["f"], (11, 9), (1, 2), got["grid"])),
        halo_back=rel(got["halo_back"], got["f"]))
    for k in ("hstack", "hstack_adjoint", "masked", "masked_adjoint",
              "local", "local_adjoint"):
        gaps[k] = rel(got[k], cpu[k])
    return gaps


def share(total, parts):
    """The largest rank's share of ``total`` items split over ``parts``
    ranks (the balanced split)."""
    return -(-total // parts) / total


def peak_gb(torch, base):
    """Device memory allocated at its peak since the last reset, above
    ``base`` bytes, in GB."""
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def slice7_phase(torch, pmtt, here, dev, timeout=600):
    """Phase 16: this slice's operators across ranks sharing the card over
    gloo, at full width, against the same configurations solved with no
    group in this process (:func:`slice7_references`): MPIVStack CGLS on
    phase 11's stack (f32 and bf16 storage), MDD at phase 8's width,
    the non-stationary deconvolution of phase 12 and LSM at phase 13's
    width (five iterations, held in f64), and a ragged f64 case against
    one CPU process; each rank's share of the MDD kernel and of the LSM
    tables and its peak memory against one rank's; collective calls per
    iteration, bytes received per apply and walls per iteration, the
    walls those of gloo ranks sharing one card through the host."""
    import shutil
    import tempfile
    from pylops_mpi_tpu_torch.ops.blockdiag import _chunk_ops
    refdir = tempfile.mkdtemp(prefix="chip_smoke_slice7_")
    try:
        t0 = time.perf_counter()
        one = slice7_references(torch, pmtt, dev, refdir)
        torch.cuda.empty_cache()
        cpu = slice7_f64_case(torch, pmtt, torch.device("cpu"))
        print(f"16. no-group references in {time.perf_counter() - t0:.1f} "
              f"s: one rank holds {one['mdd_G_gb']:.3f} GB of MDD kernel "
              f"(G and G^H; MDD peak {one['mdd_peak_gb']:.3f} GB), "
              f"{one['lsm_table_gb']:.3f} GB of LSM tables, LSM "
              f"peak {one['lsm_peak_gb']:.3f} GB; LSM x after "
              f"{NITER_16_LSM} iterations differs from a second no-group "
              f"solve by {one['lsm_x_repeat_gap']:.3e}", flush=True)
        summary = dict(one_rank=one)
        for n, cases in WORLDS_16.items():
            t0 = time.perf_counter()
            ranks = spawn_shared_card(n, here, _slice7_cases,
                                      (cases, refdir), timeout)
            o0 = ranks[0]
            gaps = {}
            for case in ("vstack", "mdd", "nonstat", "lsm"):
                if case not in cases:
                    continue
                if case == "vstack":
                    for label in ("f32", "bf16"):
                        gaps[f"vstack_{label}"] = o0["vstack"][label]["x_gap"]
                elif case != "lsm":
                    gaps[case] = o0[case]["x_gap"]
            spread = {}
            if "lsm" in cases:
                for k in ("forward", "adjoint", "x1", "x_f64"):
                    gaps[f"lsm_{k}"] = o0["lsm"][f"{k}_gap"]
                spread = dict(lsm_x_gap=o0["lsm"]["x_gap"],
                              no_group_repeat_gap=one["lsm_x_repeat_gap"])
            f64 = {}
            if "f64" in cases:
                f64 = f64_gaps(o0["f64"], cpu)
                gaps["f64"] = max(f64.values())
                mask = [q % 2 for q in range(n)]
                for o in ranks:
                    rows = [b for q in range(n) if mask[q] == mask[o["rank"]]
                            for b in _chunk_ops(list(range(7)), n)[q]]
                    want = np.linalg.norm(np.concatenate(
                        [cpu["masked"][7 * b:7 * b + 7] for b in rows]))
                    g = abs(o["f64"]["group_norm"] - want) / want
                    gaps["f64"] = max(gaps["f64"], g)
            per_rank = []
            for o in ranks:
                rec = dict(rank=o["rank"])
                for case in ("vstack", "mdd", "nonstat", "lsm"):
                    if case in o:
                        v = o[case]
                        rec[case] = ({k: {kk: vv for kk, vv in v[k].items()
                                          if kk != "x_gap"}
                                      for k in v} if case == "vstack"
                                     else {k: vv for k, vv in v.items()
                                           if not k.endswith("_gap")})
                per_rank.append(rec)
            secs = time.perf_counter() - t0
            summary[n] = dict(cases=list(cases), gaps=gaps, f64=f64,
                              lsm_x_spread=spread, ranks=per_rank,
                              seconds=secs)
            print(f"16. {n} ranks on one card (gloo, staged through the "
                  f"host): gaps to the no-group solves {gaps} (limits "
                  f"{ {k: TOL_16[k] for k in gaps} }); LSM x after "
                  f"{NITER_16_LSM} iterations, not held (see TOL_16): "
                  f"{spread}; per rank (calls per "
                  f"iteration, bytes received per apply, and walls per "
                  f"iteration of gloo ranks sharing one card through the "
                  f"host, not a multi-card number) {per_rank}; "
                  f"{secs:.1f} s", flush=True)
            bad = {k: v for k, v in gaps.items() if not v <= TOL_16[k]}
            if bad:
                raise RuntimeError(f"phase 16, {n} ranks: results disagree: "
                                   f"{bad}")
            for rec in per_rank:
                if "mdd" in rec and rec["mdd"]["G_gb"] > \
                        1.01 * one["mdd_G_gb"] * share(NFMAX, n):
                    raise RuntimeError(f"phase 16: rank {rec['rank']} holds "
                                       f"{rec['mdd']['G_gb']:.3f} GB of MDD "
                                       "kernel, more than its share")
                if "lsm" in rec and (
                        rec["lsm"]["table_gb"] > 1.01 * one["lsm_table_gb"]
                        * share(NS_L, n)
                        or rec["lsm"]["peak_gb"] > one["lsm_peak_gb"]
                        * (share(NS_L, n) + 0.1)):
                    raise RuntimeError(f"phase 16: rank {rec['rank']}'s LSM "
                                       f"tables or peak memory exceed its "
                                       f"share: {rec['lsm']}")
        return summary
    finally:
        shutil.rmtree(refdir, ignore_errors=True)


def matmul_bound_ms(N, K, M, itemsize=4):
    """Least time of ``A (N, K) @ X (K, M)``: the larger of 2·N·K·M
    operations at the f32 rate and A, X and Y moved once at the memory
    rate; and which bounds it."""
    t_ops = 2.0 * N * K * M / F32_OPS_PER_S * 1e3
    t_bytes = bytes_bound_ms((N * K + K * M + N * M) * itemsize)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_solve(torch, fn, runs=2):
    """``fn()``'s result and the walls (s) of ``runs`` synchronized
    calls."""
    walls, res = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return res, walls


def matmul_fft_phase(torch, pmtt, kernels, dev):
    """Phase 17: slice 8 at full width with no group. MPIMatrixMult
    (SUMMA, its two forced schedules, block and auto: one GEMM each at a
    world of one) forward and adjoint, held to one another and timed
    against the FMA bound and one torch.matmul; bf16 storage; CGLS (30
    iterations) to the known model. MPIFFTND on a 512^3 complex64 cube
    (forward, adjoint, round trip, dottest) and the real MPIFFT2D
    against torch.fft.rfft2 with the same scaling and shift."""
    D = pmtt.DistributedArray
    f32 = torch.float32
    res = {}
    for k in kernels:
        k.reset_launches()
    g = torch.Generator(device=dev).manual_seed(17)
    A = torch.randn((N_MM, K_MM), generator=g, device=dev)
    A /= math.sqrt(N_MM)
    xt = torch.randn(K_MM * M_MM, generator=g, device=dev)
    v = torch.randn(N_MM * M_MM, generator=g, device=dev)
    x, vd = D.to_dist(xt), D.to_dist(v)
    ops = {label: pmtt.MPIMatrixMult(A, M_MM, kind=kind, schedule=sch)
           for label, kind, sch in MM_KINDS}
    ys = {k: op.matvec(x).array for k, op in ops.items()}
    xas = {k: op.rmatvec(vd).array for k, op in ops.items()}
    Xm, Vm = xt.view(K_MM, M_MM), v.view(N_MM, M_MM)
    want_y, want_xa = (A @ Xm).reshape(-1), (A.mT @ Vm).reshape(-1)
    agree = {k: max(max_rel_err(ys[k], want_y), max_rel_err(xas[k], want_xa))
             for k in ops}
    bound, by = matmul_bound_ms(N_MM, K_MM, M_MM)
    mm = dict(shape=(N_MM, K_MM, M_MM), bound_ms=bound, bound_by=by,
              bytes_bound_ms=bytes_bound_ms(4 * (N_MM * K_MM + K_MM * M_MM
                                                 + N_MM * M_MM)),
              agree_with_matmul=agree, schedule_auto=ops["auto"].schedule,
              library_matvec_ms=cuda_ms(lambda: A @ Xm),
              library_rmatvec_ms=cuda_ms(lambda: A.mT @ Vm))
    for k, op in ops.items():
        mm[k] = dict(matvec_ms=cuda_ms(lambda op=op: op.matvec(x)),
                     rmatvec_ms=cuda_ms(lambda op=op: op.rmatvec(vd)))
    del ys, xas
    print(f"17. MPIMatrixMult ({N_MM}, {K_MM}, {M_MM}) f32, no group: "
          f"kinds vs one torch.matmul {agree} (limit {MM_AGREE}); auto "
          f"picks {mm['schedule_auto']}; ms (matvec, rmatvec): "
          + ", ".join(f"{k} {mm[k]['matvec_ms']:.3f}/{mm[k]['rmatvec_ms']:.3f}"
                      for k in ops)
          + f"; torch.matmul {mm['library_matvec_ms']:.3f}/"
          f"{mm['library_rmatvec_ms']:.3f}; bound {bound:.3f} ms "
          f"({by}; bytes {mm['bytes_bound_ms']:.3f})", flush=True)
    bad = {k: e for k, e in agree.items() if not e <= MM_AGREE}
    if bad:
        raise RuntimeError(f"phase 17: MPIMatrixMult kinds disagree: {bad}")
    y = ops["auto"].matvec(x)
    x0 = D(global_shape=K_MM * M_MM, dtype=f32, device=dev)
    for label, op in (("f32", ops["auto"]),
                      ("bf16", pmtt.MPIMatrixMult(
                          A, M_MM, compute_dtype=torch.bfloat16))):
        out, walls = timed_solve(torch, lambda op=op: pmtt.cgls(
            op, y, x0=x0, niter=NITER_MM, tol=0.0))
        cost = np.asarray(torch.as_tensor(out[5]).cpu(), dtype=np.float64)
        err = rel_norm(out[0].array, xt)
        rise = bool(np.any(np.diff(cost) > 1e-6 * cost[0]))
        run = dict(iters_per_s=NITER_MM / min(walls), wall_s=walls,
                   rel_err=err, cost_rises=rise, cost=cost.tolist())
        if label == "bf16":
            run.update(matvec_ms=cuda_ms(lambda op=op: op.matvec(x)),
                       rmatvec_ms=cuda_ms(lambda op=op: op.rmatvec(vd)),
                       A_dtype=str(op.A.dtype))
        mm["cgls_" + label] = run
        limit = MM_ERR_LIMIT if label == "f32" else MM_BF16_LIMIT
        print(f"17. CGLS through MPIMatrixMult ({label} storage): "
              f"{NITER_MM} iterations in {min(walls):.4f} s = "
              f"{run['iters_per_s']:.1f} iters/s (walls {walls}), rel_err "
              f"{err:.3e} (limit {limit:.0e}), cost rises: {rise}"
              + (f"; matvec {run['matvec_ms']:.3f} ms, rmatvec "
                 f"{run['rmatvec_ms']:.3f} ms" if label == "bf16" else ""),
              flush=True)
        if not err <= limit or rise:
            raise RuntimeError(f"phase 17: CGLS ({label}) missed: {run}")
        del op, out
    res["matrixmult"] = mm
    del ops, A, x, vd, y, x0, xt, v, Xm, Vm, want_y, want_xa
    torch.cuda.empty_cache()
    # the 512^3 complex64 cube
    F = pmtt.MPIFFTND(FFT3, axes=(0, 1, 2), dtype=torch.complex64)
    n3 = int(np.prod(FFT3))
    c = torch.randn(n3, generator=g, device=dev, dtype=torch.complex64)
    w = torch.randn(n3, generator=g, device=dev, dtype=torch.complex64)
    cd, wd = D.to_dist(c), D.to_dist(w)
    y3 = F.matvec(cd)
    lib = torch.fft.fftn(c.view(FFT3))
    fwd_err = max_rel_err(y3.array, lib.reshape(-1))
    del lib
    trip = max_rel_err(F.rmatvec(y3).array / F._scale, c)
    dot = pmtt.dottest(F, cd, wd, rtol=FFT_TOL)
    cube_bound = bytes_bound_ms(2 * n3 * 8)
    fft = dict(dims=FFT3, forward_err=fwd_err, round_trip_err=trip,
               dottest=dot, bound_ms=cube_bound, bound_by="bytes",
               matvec_ms=cuda_ms(lambda: F.matvec(cd)),
               rmatvec_ms=cuda_ms(lambda: F.rmatvec(wd)),
               library_ms=cuda_ms(lambda: torch.fft.fftn(c.view(FFT3))))
    print(f"17. MPIFFTND {FFT3} complex64: forward vs torch.fft.fftn "
          f"{fwd_err:.3e}, round trip {trip:.3e} (limit {FFT_TOL:.0e}), "
          f"dottest {dot}; matvec {fft['matvec_ms']:.3f} ms, rmatvec "
          f"{fft['rmatvec_ms']:.3f} ms, fftn {fft['library_ms']:.3f} ms, "
          f"bound {cube_bound:.3f} ms (bytes)", flush=True)
    if not (fwd_err <= FFT_TOL and trip <= FFT_TOL and dot):
        raise RuntimeError(f"phase 17: MPIFFTND missed: {fft}")
    res["fftnd"] = fft
    del F, c, w, cd, wd, y3
    torch.cuda.empty_cache()
    # the real 2-D transform against rfft2 with the same scaling and shift
    F2 = pmtt.MPIFFT2D(FFT2, real=True, dtype=f32,
                       fftshift_after=(True, False))
    xr = torch.randn(FFT2, generator=g, device=dev)
    xd = D.to_dist(xr.reshape(-1))

    def plain():
        p = torch.fft.rfft2(xr)
        hi = 1 + (FFT2[1] - 1) // 2
        fac = torch.ones(p.shape[1], device=dev)
        fac[1:hi] = math.sqrt(2.0)
        return torch.fft.fftshift(p * fac, dim=0).reshape(-1)

    y2 = F2.matvec(xd)
    err2 = max_rel_err(y2.array, plain())
    nin = xr.numel() * 4
    nout = y2.array.numel() * 8
    f2 = dict(dims=FFT2, err=err2, matvec_ms=cuda_ms(lambda: F2.matvec(xd)),
              rmatvec_ms=cuda_ms(lambda: F2.rmatvec(y2)),
              plain_ms=cuda_ms(plain), bound_ms=bytes_bound_ms(nin + nout),
              bound_by="bytes")
    print(f"17. MPIFFT2D {FFT2} real f32, fftshift_after=(True, False): vs "
          f"rfft2 with the same scaling and shift {err2:.3e} (limit "
          f"{FFT_TOL:.0e}); matvec {f2['matvec_ms']:.3f} ms, rmatvec "
          f"{f2['rmatvec_ms']:.3f} ms, plain {f2['plain_ms']:.3f} ms, bound "
          f"{f2['bound_ms']:.3f} ms (bytes)", flush=True)
    if not err2 <= FFT_TOL:
        raise RuntimeError(f"phase 17: MPIFFT2D missed: {f2}")
    res["fft2d"] = f2
    res["kernel_launches"] = [k.launches for k in kernels]
    del F2, xr, xd, y2
    torch.cuda.empty_cache()
    return res


def summa_problem():
    """Phase 18's matrix and model, from a seeded host generator: every
    rank passes the whole A and keeps its rows or tile."""
    rng = np.random.default_rng(18)
    A = (rng.standard_normal((N_18, K_18)) / math.sqrt(N_18)).astype(
        np.float32)
    return A, rng.standard_normal(K_18 * M_18).astype(np.float32)


def fft18_inputs():
    rng = np.random.default_rng(19)
    n = int(np.prod(FFT_18))
    c = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    w = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    return c, w


def slice8_f64_case(torch, pmtt, dev):
    """Phase 18's ragged f64 case, run alike by a world of ranks and by
    one process without a group: MPIMatrixMult (N, K, M) = (23, 17, 10)
    of every kind and schedule on the default grid ((2, 2) at four
    ranks) and SUMMA on a (P, 1) grid, and the FFTs of a (17, 12, 9)
    complex cube and a real (17, 10) field with shifts, forward and
    adjoint. Returns the gathered results."""
    D = pmtt.DistributedArray
    n = pmtt.parallel.world_size()
    rng = np.random.default_rng(23)
    A = rng.standard_normal((23, 17))
    x, v = rng.standard_normal(170), rng.standard_normal(230)
    out = {}
    for label, kind, sch in MM_KINDS + (("gather_p1", "summa", "gather"),
                                        ("stat_a_p1", "summa", "stat_a")):
        op = pmtt.MPIMatrixMult(A, 10, kind=kind, schedule=sch,
                                grid=(n, 1) if label.endswith("p1") else None,
                                device=dev)
        out["mm_" + label] = op.matvec(D.to_dist(x, device=dev)).asarray()
        out["mm_adj_" + label] = op.rmatvec(D.to_dist(v, device=dev)) \
            .asarray()
    for label, F in (("cube", pmtt.MPIFFTND((17, 12, 9), axes=(0, 1, 2))),
                     ("real", pmtt.MPIFFT2D((17, 10), real=True,
                                            dtype=torch.float64,
                                            fftshift_after=(True, False)))):
        m = rng.standard_normal(F.shape[1])
        if not F.real:
            m = m + 1j * rng.standard_normal(F.shape[1])
        d = rng.standard_normal(F.shape[0]) \
            + 1j * rng.standard_normal(F.shape[0])
        out["fft_" + label] = F.matvec(D.to_dist(
            m, local_shapes=F.model_local_shapes, device=dev)).asarray()
        out["fft_adj_" + label] = F.rmatvec(D.to_dist(
            d, local_shapes=F.data_local_shapes, device=dev)).asarray()
    return out


def _slice8_cases(torch, pmtt, dev, refdir):
    """What each rank of phase 18 runs; returns this rank's record: per
    kind and schedule the x gap of 10 CGLS iterations to the no-group
    solve, the collectives and bytes of one forward and one adjoint
    apply, the bytes of A it holds and the wall per iteration; the same
    for the FFT's applies; and the ragged f64 case."""
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops import stencil_kernels as sk
    from pylops_mpi_tpu_torch.parallel import collectives as co
    D = pmtt.DistributedArray
    r = pmtt.parallel.rank()
    out = dict(rank=r)
    for k in (nk, sk):
        k.reset_launches()

    def gap(got, name):
        want = np.load(f"{refdir}/{name}.npy").ravel()
        got = np.asarray(got).ravel()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def calls(fn):
        co.reset_counts()
        fn()
        return dict(co.counts), dict(co.received)

    A, xt = summa_problem()
    x = D.to_dist(torch.from_numpy(xt).to(dev))
    y = D.to_dist(torch.from_numpy(np.load(f"{refdir}/mm_y.npy")).to(dev))
    x0 = D(global_shape=K_18 * M_18, dtype=torch.float32, device=dev)
    for label, kind, sch in MM_KINDS:
        op = pmtt.MPIMatrixMult(A, M_18, kind=kind, schedule=sch,
                                device=dev)
        fwd, adj = calls(lambda: op.matvec(x)), calls(lambda: op.rmatvec(y))
        xs, walls = timed_solve(torch, lambda: pmtt.cgls(
            op, y, x0=x0, niter=NITER_18, tol=0.0)[0], runs=1)
        out["mm_" + label] = dict(
            x_gap=gap(xs.asarray(), "mm_x_" + label), forward=fwd,
            adjoint=adj, A_bytes=op.A.numel() * op.A.element_size(),
            A_shape=tuple(op.A.shape), grid=getattr(op, "grid", None),
            schedule=getattr(op, "schedule", None),
            wall_per_iter_s=walls[0] / NITER_18)
        del op, xs
    c, w = fft18_inputs()
    F = pmtt.MPIFFTND(FFT_18, axes=(0, 1, 2), dtype=torch.complex64)
    cd = D.to_dist(torch.from_numpy(c).to(dev),
                   local_shapes=F.model_local_shapes)
    wd = D.to_dist(torch.from_numpy(w).to(dev),
                   local_shapes=F.data_local_shapes)
    fwd, adj = calls(lambda: F.matvec(cd)), calls(lambda: F.rmatvec(wd))
    y3, wf = timed_solve(torch, lambda: F.matvec(cd))
    xa, wa = timed_solve(torch, lambda: F.rmatvec(wd))
    out["fft"] = dict(forward_gap=gap(y3.asarray(), "fft_y"),
                      adjoint_gap=gap(xa.asarray(), "fft_xa"),
                      rows=(F.model_local_shapes[r][0] // (FFT_18[1]
                                                          * FFT_18[2])),
                      forward=fwd, adjoint=adj, forward_wall_s=min(wf),
                      adjoint_wall_s=min(wa))
    out["f64"] = slice8_f64_case(torch, pmtt, dev)
    out["kernel_launches"] = [nk.launches, sk.launches]
    return out


def slice8_ranks_phase(torch, pmtt, here, dev, timeout=600):
    """Phase 18: slice 8 across 2-4 gloo ranks sharing the card (grids
    (1, 2), (1, 3), (2, 2)), against the same work with no group in this
    process: CGLS (10 iterations) through MPIMatrixMult at (4096, 2048,
    64) f32 with both SUMMA schedules forced, ``auto`` and the block
    kind, each rank's share of A, and the bytes each apply receives
    against the volume model; the FFT of a (256, 256, 128) complex64
    cube forward and adjoint; a ragged f64 case against one CPU
    process."""
    import shutil
    import tempfile
    from pylops_mpi_tpu_torch.ops.matrixmult import summa_comm_volume
    D = pmtt.DistributedArray
    refdir = tempfile.mkdtemp(prefix="chip_smoke_slice8_")
    try:
        t0 = time.perf_counter()
        A, xt = summa_problem()
        op = pmtt.MPIMatrixMult(A, M_18, device=dev)
        y = op.matvec(D.to_dist(torch.from_numpy(xt).to(dev)))
        np.save(f"{refdir}/mm_y.npy", y.asarray())
        x0 = D(global_shape=K_18 * M_18, dtype=torch.float32, device=dev)
        for label, kind, sch in MM_KINDS:
            op = pmtt.MPIMatrixMult(A, M_18, kind=kind, schedule=sch,
                                    device=dev)
            np.save(f"{refdir}/mm_x_{label}.npy", pmtt.cgls(
                op, y, x0=x0, niter=NITER_18, tol=0.0)[0].asarray())
        c, w = fft18_inputs()
        F = pmtt.MPIFFTND(FFT_18, axes=(0, 1, 2), dtype=torch.complex64)
        np.save(f"{refdir}/fft_y.npy", F.matvec(D.to_dist(
            torch.from_numpy(c).to(dev))).asarray())
        np.save(f"{refdir}/fft_xa.npy", F.rmatvec(D.to_dist(
            torch.from_numpy(w).to(dev))).asarray())
        cpu = slice8_f64_case(torch, pmtt, torch.device("cpu"))
        whole = A.nbytes
        del op, y, x0, F
        torch.cuda.empty_cache()
        print(f"18. no-group references in {time.perf_counter() - t0:.1f} s",
              flush=True)
        summary = {}
        for n in WORLDS_18:
            t0 = time.perf_counter()
            ranks = spawn_shared_card(n, here, _slice8_cases, (refdir,),
                                      timeout)
            o0 = ranks[0]
            gaps = {k: o0["mm_" + k]["x_gap"] for k, _, _ in MM_KINDS}
            gaps["fft_forward"] = o0["fft"]["forward_gap"]
            gaps["fft_adjoint"] = o0["fft"]["adjoint_gap"]
            f64 = max(float(np.abs(o0["f64"][k] - cpu[k]).max()
                            / np.abs(cpu[k]).max()) for k in cpu)
            grid = o0["mm_gather"]["grid"]
            vol = summa_comm_volume(N_18, K_18, M_18, grid)
            per_rank = []
            for o in ranks:
                rec = dict(rank=o["rank"], fft=o["fft"],
                           kernel_launches=o["kernel_launches"])
                for label, _, _ in MM_KINDS:
                    v = {k: vv for k, vv in o["mm_" + label].items()
                         if k != "x_gap"}
                    v["A_share"] = v["A_bytes"] / whole
                    if label != "block":
                        got = v["forward"][1]
                        v["kernel_bytes"] = (got.get("all_gather", 0)
                                             + got.get("reduce_scatter", 0))
                        v["model_bytes"] = 4 * vol[v["schedule"]]
                    rec["mm_" + label] = v
                per_rank.append(rec)
            secs = time.perf_counter() - t0
            summary[n] = dict(grid=grid, gaps=gaps, f64=f64,
                              model_elements=vol, ranks=per_rank,
                              seconds=secs)
            print(f"18. {n} ranks on one card (gloo, staged through the "
                  f"host), grid {grid}: gaps to the no-group solves and "
                  f"applies {gaps} (limit {TOL_18:.0e}), ragged f64 vs CPU "
                  f"{f64:.3e} (limit {F64_18:.0e}); volume model "
                  f"(elements per forward, adjoint all-reduce) {vol}; per "
                  f"rank (collectives and bytes received per apply, A "
                  f"share, walls of gloo ranks sharing one card through "
                  f"the host, not a multi-card number) {per_rank}; "
                  f"{secs:.1f} s", flush=True)
            bad = {k: v for k, v in gaps.items() if not v <= TOL_18}
            if bad or not f64 <= F64_18:
                raise RuntimeError(f"phase 18, {n} ranks: results disagree: "
                                   f"{bad}, f64 {f64}")
            for rec in per_rank:
                for label, _, _ in MM_KINDS:
                    v = rec["mm_" + label]
                    if label == "block":
                        rows = -(-N_18 // n) if rec["rank"] < N_18 % n \
                            else N_18 // n
                        want = (rows, K_18)
                    else:  # the tile of the padded matrix
                        want = (-(-N_18 // v["grid"][0]),
                                -(-K_18 // v["grid"][1]))
                    if v["A_shape"] != want or v["A_share"] > 1.01 / n:
                        raise RuntimeError(
                            f"phase 18: rank {rec['rank']} holds A of "
                            f"{v['A_shape']} ({v['A_share']:.4f} of it), "
                            f"not its {want}")
                    if label != "block" and \
                            v["kernel_bytes"] != v["model_bytes"]:
                        raise RuntimeError(
                            f"phase 18: rank {rec['rank']} {label} "
                            f"received {v['kernel_bytes']} B in the SUMMA "
                            f"collectives, the model says "
                            f"{v['model_bytes']}")
        return summary
    finally:
        shutil.rmtree(refdir, ignore_errors=True)


# phases 19-20 (slice 9): the solver tiers. Phase 19 at a world of one on
# phase 3's 32 blocks of 4096x4096 f32: the preconditioner race (columns
# scaled by 10^U(-SPREAD_19, SPREAD_19), so the normal system's condition
# grows by up to 10^(4·SPREAD_19)), block CGLS against sequential solves,
# the CA engines under a group of one over NCCL, the banded sparse matrix
# of N_SP rows (offsets -2..2: 83.9 M nonzeros, 1.007 GB of int32/int32/
# f32 triplets), and V-cycle PCG on the Laplacian of bench.py's
# _precond_race_row at VC_DIMS. Phase 20: gloo ranks sharing the card at
# a reduced size, each configuration first solved with no group here
SPREAD_19, RTOL_19, CAP_19 = 1.0, 1e-3, 3000
NITER_19, K_19, BLOCK_GAP_19 = 30, 16, 1e-5
# the CA engines: iterations to RTOL_CA, then all_reduce counts and
# alternating pairs of walls over NITER_CA iterations (tol 0; short of
# the f32 machine floor on these systems, so every engine runs them all)
RTOL_CA, CAP_CA, NITER_CA = 1e-4, 500, 8
N_SP, SP_NITER, SP_DAMP = 1 << 24, 30, 1e-3
VC_DIMS, VC_LEVELS, VC_EPS, VC_RTOL, VC_CAP = (2048, 2048), 6, 0.05, 1e-4, 2000
NBLK_20, NSPD_20, M_20, K_20, NITER_20 = 8, 6, 1024, 4, 10
# the SPD blocks' shift: AᵢᵀAᵢ + SHIFT_20·I has a condition number near 5,
# so that s-step's monomial basis (conditioned like its s-th power) keeps
# f32 rounding of another summation order below TOL_20
SHIFT_20 = 4.0
N_SP_20, WORLDS_20, TOL_20, F64_20 = 1 << 18, (2, 3), 1e-5, 1e-12
# phase 21 (slice 10): the solve service on phase 3's blocks. The cg
# family's tol is absolute on the squared residual: 1e-3 against
# |y|^2 ~ 1.3e5 (a relative residual of ~9e-5), where f32 CG on the
# Gram blocks + I (condition ~3) converges well above its floor
NITER_21, NITER_CG_21, TOL_CG_21 = 30, 50, 1e-3
BUCKETS_21, WINDOW_21, REQ_21, THREADS_21 = (1, 2, 4, 8, 16), 0.005, 64, 8
SEQ_21, SPOOL_21, GAP_21, PAIRS_21, DUE_21 = 16, 32, 1e-5, 6, 1.5


def lap_op(torch, pmtt, dims, eps, dtype):
    """The Dirichlet 5-point Laplacian plus ``eps`` on the ``dims`` grid
    (``bench.py:_precond_race_row``) as a port operator: every rank
    gathers, applies and keeps its rows."""
    ny, nx = dims

    class Lap(pmtt.MPILinearOperator):
        accepts_block = True

        def __init__(self):
            super().__init__(shape=(ny * nx, ny * nx), dtype=dtype)

        def _matvec(self, x):
            g = x._global()
            t = g.reshape((ny, nx) + tuple(g.shape[1:]))
            p = torch.nn.functional.pad(
                t.movedim((0, 1), (-2, -1)), (1, 1, 1, 1)).movedim(
                    (-2, -1), (0, 1))
            out = (4.0 * t - p[:-2, 1:-1] - p[2:, 1:-1]
                   - p[1:-1, :-2] - p[1:-1, 2:])
            flat = (eps * g + out.reshape(g.shape)).to(g.dtype)
            return pmtt.DistributedArray._wrap(
                x._shard_of(flat).contiguous(), x)

        _rmatvec = _matvec

    return Lap()


def banded(n, seed):
    """A diagonally dominant banded matrix of ``n`` rows, offsets -2..2
    (f32 bands from a seeded host generator)."""
    rng = np.random.default_rng(seed)
    offsets = (-2, -1, 0, 1, 2)
    bands = [(rng.standard_normal(n - abs(o)) * 0.5).astype(np.float32)
             if o else (4.0 + rng.random(n)).astype(np.float32)
             for o in offsets]
    return offsets, bands


def sparse_bound_ms(nnz, n, itemsize=4):
    """Least time of one sparse apply: each triplet (int32 row, int32
    column, value) read once, x read and y written once."""
    return bytes_bound_ms(nnz * (8 + itemsize) + 2 * n * itemsize)


def set_ca(mode):
    import os
    os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = mode


def precond_race(torch, pmtt, nk, A, xtrue, dev):
    """Phase 19.1: normal=True CGLS on the column-scaled blocks, without
    a preconditioner, with Jacobi (diag(AᵀA)) and with the exact
    block-Jacobi inverse; each arm's tol relative to its own kold0."""
    D = pmtt.DistributedArray
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    g = torch.Generator(device=dev).manual_seed(19)
    scale = 10.0 ** ((torch.rand((NBLK, 1, NBLOCK), generator=g,
                                 device=dev) * 2 - 1) * SPREAD_19)
    As = A * scale
    y = D.to_dist(torch.bmm(As, xtrue.view(NBLK, NBLOCK, 1)).reshape(-1))
    Op = pmtt.MPIBlockDiag([MatrixMult(As[i]) for i in range(NBLK)])
    del As
    g0 = Op.rmatvec(y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    MB = pmtt.BlockJacobiPrecond.from_block_diag(Op, normal=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    MJ = pmtt.JacobiPrecond((Op._batched ** 2).sum(dim=1).reshape(-1))
    out = dict(spread=SPREAD_19, rtol=RTOL_19, cap=CAP_19,
               block_jacobi_build_s=build_s, block_jacobi_clamped=MB.clamped)
    for label, M in (("none", None), ("jacobi", MJ), ("block_jacobi", MB)):
        z0 = g0 if M is None else M.matvec(g0)
        tol = RTOL_19 ** 2 * float(g0.dot(z0))
        pmtt.cgls(Op, y, niter=2, tol=0.0, normal=True, M=M)  # warm-up
        sol, walls = timed_solve(torch, lambda: pmtt.cgls(
            Op, y, niter=CAP_19, tol=tol, normal=True, M=M), runs=1)
        x, iiter, wall = sol[0], sol[2], walls[0]
        rel = float(torch.linalg.vector_norm(x.array - xtrue)
                    / torch.linalg.vector_norm(xtrue))
        nk.reset_launches()
        pmtt.cgls(Op, y, niter=10, tol=0.0, normal=True, M=M)
        torch.cuda.synchronize()
        lpi = nk.launches / 10
        out[label] = dict(iters=iiter, wall_s=wall, rel_err=rel, tol=tol,
                          iters_per_s=iiter / wall, launches_per_iter=lpi)
        print(f"19.1 PCGLS normal=True, M={label}: {iiter} iterations to "
              f"rtol {RTOL_19:.0e} (cap {CAP_19}) in {wall:.4f} s, rel_err "
              f"{rel:.3e}, normal-kernel launches per iteration {lpi:.2f}",
              flush=True)
        if not np.isfinite(rel) or lpi != 1.0:
            raise RuntimeError(f"19.1 {label}: rel_err {rel}, {lpi} normal "
                               "launches an iteration (want 1)")
    if out["block_jacobi"]["iters"] > 5 or out["block_jacobi"]["rel_err"] \
            > 1e-2:
        raise RuntimeError(f"19.1 the exact block-Jacobi arm took "
                           f"{out['block_jacobi']}: the seam is wrong")
    rb = g0.array.reshape(NBLK, NBLOCK, 1)
    apply_ms = cuda_ms(lambda: MB.matvec(g0))
    lib_ms = cuda_ms(lambda: torch.cholesky_solve(rb, MB._chol))
    bound = bytes_bound_ms(2 * MB._chol.numel() * 4)
    out.update(block_jacobi_apply_ms=apply_ms, cholesky_solve_ms=lib_ms,
               block_jacobi_bound_ms=bound)
    print(f"19.1 block-Jacobi: build (Gram einsum {2 * NBLK * NBLOCK ** 3 / 1e12:.2f}"
          f" TFLOP, symmetrize, Cholesky, triangular inverse) {build_s:.3f} "
          f"s, {MB.clamped} blocks clamped; apply (two batched products "
          f"with the inverse factors) {apply_ms:.3f} ms against the byte "
          f"bound {bound:.3f} ms (the factors read twice); the library's "
          f"torch.cholesky_solve {lib_ms:.3f} ms", flush=True)
    del Op, MB, MJ, g0, y
    torch.cuda.empty_cache()
    return out


def block_race(torch, pmtt, A, dev):
    """Phase 19.2: block_cgls of K_19 columns against K_19 sequential
    normal=True and classic cgls, NITER_19 iterations each
    (``bench.py:_batched_race_row`` at full width)."""
    D = pmtt.DistributedArray
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    g = torch.Generator(device=dev).manual_seed(192)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    Y = torch.randn((NBLK * NBLOCK, K_19), generator=g, device=dev)
    yb = D.to_dist(Y)
    ys = [D.to_dist(Y[:, j].contiguous()) for j in range(K_19)]
    pmtt.block_cgls(Op, yb, niter=2, tol=0.0)
    for normal in (True, False):
        pmtt.cgls(Op, ys[0], niter=2, tol=0.0, normal=normal)
    xb, wb = timed_solve(torch, lambda: pmtt.block_cgls(
        Op, yb, niter=NITER_19, tol=0.0)[0], runs=2)
    seq = {}
    for label, normal in (("normal", True), ("classic", False)):
        xs, ws = timed_solve(torch, lambda: [pmtt.cgls(
            Op, yj, niter=NITER_19, tol=0.0, normal=normal)[0]
            for yj in ys], runs=2)
        gap = max(float(torch.linalg.vector_norm(xb.array[:, j] - x.array)
                        / torch.linalg.vector_norm(x.array))
                  for j, x in enumerate(xs))
        seq[label] = dict(wall_s=ws, solves_per_s=K_19 / min(ws), gap=gap)
    out = dict(K=K_19, niter=NITER_19, block_wall_s=wb,
               block_solves_per_s=K_19 / min(wb), sequential=seq,
               speedup_vs_normal=min(seq["normal"]["wall_s"]) / min(wb),
               speedup_vs_classic=min(seq["classic"]["wall_s"]) / min(wb))
    print(f"19.2 block_cgls K={K_19}, {NITER_19} iterations: "
          f"{out['block_solves_per_s']:.1f} solves/s (walls {wb}); 16 "
          f"sequential cgls normal=True {seq['normal']['solves_per_s']:.1f} "
          f"solves/s, classic {seq['classic']['solves_per_s']:.1f}; max "
          f"column gap to classic x {seq['classic']['gap']:.3e} (limit "
          f"{BLOCK_GAP_19:.0e}), to normal=True x {seq['normal']['gap']:.3e}",
          flush=True)
    if not seq["classic"]["gap"] <= BLOCK_GAP_19:
        raise RuntimeError(f"19.2 block vs sequential classic gap "
                           f"{seq['classic']['gap']:.3e}")
    del Op, Y, yb, ys, xb
    torch.cuda.empty_cache()
    return out


def ca_race(torch, pmtt, nk, A, xtrue, dev):
    """Phase 19.3: the CA engines against the classic engine under a
    group of one over NCCL: iterations to the same tol, the x gap, and
    over NITER_CA iterations (tol 0) all_reduce calls per iteration and
    PAIRS alternating pairs of walls."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    D = pmtt.DistributedArray
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.solvers import ca
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    G = torch.bmm(A.transpose(1, 2), A)
    G.diagonal(dim1=1, dim2=2).add_(1.0)
    S = pmtt.MPIBlockDiag([MatrixMult(G[i]) for i in range(NBLK)])
    del G
    xt = xtrue.view(NBLK, NBLOCK, 1)
    y = D.to_dist(torch.bmm(A, xt).reshape(-1))
    ysp = D.to_dist(torch.bmm(S._batched, xt).reshape(-1))
    k0 = {"cgls": float(Op.rmatvec(y).norm() ** 2),
          "cg": float(ysp.norm() ** 2)}
    fams = {"cgls_normal": ("cgls", True, ("off", "pipelined")),
            "cgls_classic": ("cgls", False, ("off", "pipelined")),
            "cg": ("cg", None, ("off", "pipelined", "sstep"))}

    def solve(fam, mode, niter, tol):
        solver, normal, _ = fams[fam]
        set_ca(mode)
        if solver == "cg":
            x, it, _ = pmtt.cg(S, ysp, niter=niter, tol=tol)
        else:
            x, _, it, _, _, _ = pmtt.cgls(Op, y, niter=niter, tol=tol,
                                          normal=normal)
        return x, it

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ca_")
    pmtt.parallel.init(backend="nccl", store=dist.FileStore(f"{tmp}/store", 1),
                       rank=0, world_size=1, device=dev)
    out = dict(pairs=PAIRS, rtol=RTOL_CA, s=None)
    try:
        from pylops_mpi_tpu_torch.utils.deps import ca_s_default
        out["s"] = ca_s_default()
        for fam, (solver, normal, modes) in fams.items():
            tol = RTOL_CA ** 2 * k0[solver]
            rec = {}
            for mode in modes:
                solve(fam, mode, 2, 0.0)  # warm-up
                ca.clear_fallback()
                x, it = solve(fam, mode, CAP_CA, tol)
                fb = ca.last_fallback()
                co.reset_counts()
                solve(fam, mode, 0, 0.0)  # the setup's reductions alone
                setup = co.counts["all_reduce"]
                co.reset_counts()
                nk.reset_launches()
                _, itc = solve(fam, mode, NITER_CA, 0.0)
                torch.cuda.synchronize()
                calls = co.counts["all_reduce"]
                rec[mode] = dict(
                    iters=it, x=x.array.clone(), fallback=fb,
                    all_reduce=calls, setup_all_reduce=setup,
                    count_iters=itc, all_reduce_per_iter=calls / itc,
                    loop_all_reduce_per_iter=(calls - setup) / itc,
                    normal_launches_per_iter=nk.launches / itc)
            # walls per iteration, in alternating order
            walls = {m: [] for m in modes}
            for i in range(PAIRS):
                order = modes if i % 2 == 0 else modes[::-1]
                for mode in order:
                    walls[mode].append(timed_solve(
                        torch, lambda: solve(fam, mode, NITER_CA, 0.0),
                        runs=1)[1][0] / rec[mode]["count_iters"])
            base = rec["off"]["x"]
            for mode in modes:
                r = rec[mode]
                r["gap"] = float(torch.linalg.vector_norm(r.pop("x") - base)
                                 / torch.linalg.vector_norm(base))
                r["wall_s"] = walls[mode]
                if mode != "off":
                    ratios = [a / b for a, b in zip(walls["off"],
                                                    walls[mode])]
                    r.update(ratio_classic_over=ratios,
                             ratio_median=float(np.median(ratios)),
                             ratio_min=min(ratios), ratio_max=max(ratios))
                print(f"19.3 {fam} {mode}: {r['iters']} iterations to rtol "
                      f"{RTOL_CA:.0e} (classic {rec['off']['iters']}), x gap "
                      f"to classic {r['gap']:.3e}; over {r['count_iters']} "
                      f"iterations (group of one, nccl) {r['all_reduce']} "
                      f"all_reduce = {r['all_reduce_per_iter']:.3f} an "
                      f"iteration, {r['loop_all_reduce_per_iter']:.3f} after "
                      f"the setup's {r['setup_all_reduce']}; normal-kernel "
                      f"launches per iteration "
                      f"{r['normal_launches_per_iter']:.3f}; s-step fallback "
                      f"{r['fallback']}; median wall "
                      f"{np.median(walls[mode]) * 1e3:.3f} ms an iteration"
                      + (f"; wall ratio classic/{mode} median "
                         f"{r['ratio_median']:.4f} range "
                         f"[{r['ratio_min']:.4f}, {r['ratio_max']:.4f}]"
                         if mode != "off" else ""), flush=True)
                if not (np.isfinite(r["gap"]) and r["gap"] <= 1e-3):
                    raise RuntimeError(f"19.3 {fam} {mode}: x gap "
                                       f"{r['gap']:.3e} to the classic x")
            if rec["pipelined"]["loop_all_reduce_per_iter"] != 1.0:
                raise RuntimeError(f"19.3 {fam}: pipelined took "
                                   f"{rec['pipelined']['loop_all_reduce_per_iter']}"
                                   " all_reduce an iteration")
            out[fam] = rec
    finally:
        set_ca("off")
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA", None)
        pmtt.parallel.destroy()
        shutil.rmtree(tmp, ignore_errors=True)
    del Op, S, y, ysp
    torch.cuda.empty_cache()
    return out


def sparse_race(torch, pmtt, dev):
    """Phase 19.4: the banded sparse matrix of N_SP rows: forward and
    adjoint against the byte bound and one torch.sparse CSR mv, the
    adjoint's run-to-run spread, and SP_NITER damped CGLS iterations."""
    D = pmtt.DistributedArray
    t0 = time.perf_counter()
    offsets, bands = banded(N_SP, 194)
    Sp = pmtt.MPISparseMatrixMult.from_banded(offsets, bands, (N_SP, N_SP),
                                              device=dev)
    build = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(194)
    xt = torch.randn(N_SP, generator=g, device=dev)
    x = D.to_dist(xt)
    y = Sp.matvec(x)
    # the same matrix as one library CSR tensor (the forward's rows)
    csr = Sp._rows_csr(torch.float32)
    lib = torch.mv(csr, xt)
    fw_gap = float((y.array - lib).abs().max() / lib.abs().max())

    def spread(fn):
        runs = [fn().array.clone() for _ in range(5)]
        return max(float((a - runs[0]).abs().max() / runs[0].abs().max())
                   for a in runs[1:])

    fw_spread = spread(lambda: Sp.matvec(x))
    adj_spread = spread(lambda: Sp.rmatvec(y))
    fw_ms = cuda_ms(lambda: Sp.matvec(x))
    ad_ms = cuda_ms(lambda: Sp.rmatvec(y))
    lib_ms = cuda_ms(lambda: torch.mv(csr, xt))
    bound = sparse_bound_ms(Sp.nnz, N_SP)
    pmtt.cgls(Sp, y, niter=2, damp=SP_DAMP, tol=0.0)
    xs, ws = timed_solve(torch, lambda: pmtt.cgls(
        Sp, y, niter=SP_NITER, damp=SP_DAMP, tol=0.0)[0], runs=2)
    rel = float(torch.linalg.vector_norm(xs.array - xt)
                / torch.linalg.vector_norm(xt))
    out = dict(N=N_SP, nnz=Sp.nnz, triplet_bytes=Sp.nnz * 12,
               host_build_s=build, forward_ms=fw_ms, adjoint_ms=ad_ms,
               csr_mv_ms=lib_ms, bound_ms=bound, forward_gap_to_mv=fw_gap,
               forward_run_to_run=fw_spread, adjoint_run_to_run=adj_spread,
               cgls_iters_per_s=SP_NITER / min(ws),
               cgls_wall_s=ws, cgls_rel_err=rel)
    print(f"19.4 sparse banded N={N_SP}, nnz {Sp.nnz} ({Sp.nnz * 12 / 1e9:.3f}"
          f" GB of triplets, host build {build:.1f} s): forward {fw_ms:.3f} "
          f"ms, adjoint {ad_ms:.3f} ms, byte bound {bound:.3f} ms, one "
          f"torch.sparse CSR mv {lib_ms:.3f} ms (forward gap to it "
          f"{fw_gap:.2e}); run-to-run spread of 5 calls: forward "
          f"{fw_spread:.2e}, adjoint {adj_spread:.2e}; CGLS "
          f"{SP_NITER} iterations (damp {SP_DAMP}) "
          f"{out['cgls_iters_per_s']:.1f} iters/s, rel_err {rel:.3e}",
          flush=True)
    if not (fw_gap <= 1e-5 and adj_spread <= 1e-5 and rel <= 1e-3):
        raise RuntimeError(f"19.4 sparse: gap {fw_gap}, spread "
                           f"{adj_spread}, rel_err {rel}")
    del Sp, csr, x, y, xs
    torch.cuda.empty_cache()
    return out


def vcycle_race(torch, pmtt, dev):
    """Phase 19.5: CG on the Laplacian + eps at VC_DIMS without a
    preconditioner and with the VC_LEVELS-level V-cycle, each to its own
    relative tol."""
    D = pmtt.DistributedArray
    Lop = lap_op(torch, pmtt, VC_DIMS, VC_EPS, torch.float32)
    n = VC_DIMS[0] * VC_DIMS[1]
    g = torch.Generator(device=dev).manual_seed(195)
    xt = torch.randn(n, generator=g, device=dev)
    y = Lop.matvec(D.to_dist(xt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V = pmtt.VCyclePrecond(lambda d: lap_op(torch, pmtt, d, VC_EPS,
                                            torch.float32),
                           VC_DIMS, levels=VC_LEVELS, device=dev)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    out = dict(dims=VC_DIMS, eps=VC_EPS, levels=V.level_dims, rtol=VC_RTOL,
               build_s=build, coarse="cholesky" if V._chol_c is not None
               else "pinv")
    for label, M in (("none", None), ("vcycle", V)):
        z0 = y if M is None else M.matvec(y)
        tol = VC_RTOL ** 2 * float(y.dot(z0))
        pmtt.cg(Lop, y, niter=2, tol=0.0, M=M)
        (x, it, _), ws = timed_solve(torch, lambda: pmtt.cg(
            Lop, y, niter=VC_CAP, tol=tol, M=M), runs=1)
        rel = float(torch.linalg.vector_norm(x.array - xt)
                    / torch.linalg.vector_norm(xt))
        out[label] = dict(iters=it, wall_s=ws[0], rel_err=rel)
        print(f"19.5 CG on the Laplacian + {VC_EPS} at {VC_DIMS}, M={label}:"
              f" {it} iterations to rtol {VC_RTOL:.0e} in {ws[0]:.4f} s, "
              f"rel_err {rel:.3e}", flush=True)
    print(f"19.5 V-cycle levels {V.level_dims}, built in {build:.2f} s "
          f"(coarse {out['coarse']})", flush=True)
    if not out["vcycle"]["iters"] < out["none"]["iters"] \
            or out["vcycle"]["rel_err"] > 1e-3:
        raise RuntimeError(f"19.5 the V-cycle did not help: {out}")
    del V, Lop, y
    torch.cuda.empty_cache()
    return out


def solver_tiers_phase(torch, pmtt, kernels, dev):
    """Phase 19: slice 9's tiers at a world of one, full width."""
    nk = kernels[0]
    A, xtrue, _ = make_problem(torch, dev)
    res = {}
    for name, fn in (("precond", lambda: precond_race(torch, pmtt, nk, A,
                                                      xtrue, dev)),
                     ("block", lambda: block_race(torch, pmtt, A, dev)),
                     ("ca", lambda: ca_race(torch, pmtt, nk, A, xtrue, dev))):
        t0 = time.perf_counter()
        res[name] = fn()
        print(f"19 {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    del A, xtrue
    torch.cuda.empty_cache()
    for name, fn in (("sparse", sparse_race), ("vcycle", vcycle_race)):
        t0 = time.perf_counter()
        res[name] = fn(torch, pmtt, dev)
        print(f"19 {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------- phase 20
def tiers20_problem(torch, pmtt, dev):
    """Phase 20's operators and data, made alike on every rank and in the
    parent: NBLK_20 f32 blocks of M_20 (make_problem's style, from a
    device generator), the SPD operator of the first NSPD_20 Gram blocks
    plus SHIFT_20·I, its block-Jacobi blocks of 1.5·M_20 (they straddle the shards
    of three ranks), and a banded sparse matrix of N_SP_20 rows."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    g = torch.Generator(device=dev).manual_seed(20)
    A = torch.randn((NBLK_20, M_20, M_20), generator=g, device=dev)
    A = A / math.sqrt(M_20)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    G = torch.bmm(A[:NSPD_20].transpose(1, 2), A[:NSPD_20])
    G.diagonal(dim1=1, dim2=2).add_(SHIFT_20)
    dense = torch.block_diag(*G)
    b = 3 * M_20 // 2
    bj = torch.stack([dense[i:i + b, i:i + b]
                      for i in range(0, NSPD_20 * M_20, b)])
    del dense
    Y = torch.randn((NBLK_20 * M_20, K_20), generator=g, device=dev)
    ysp = torch.randn(NSPD_20 * M_20, generator=g, device=dev)
    offsets, bands = banded(N_SP_20, 20)
    return dict(
        Op=pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK_20)]),
        S=pmtt.MPIBlockDiag([MatrixMult(G[i]) for i in range(NSPD_20)]),
        S64=pmtt.MPIBlockDiag([MatrixMult(G[i].double())
                               for i in range(NSPD_20)]),
        bj=bj, Y=Y, ysp=ysp, djac=(A ** 2).sum(dim=1).reshape(-1),
        Sp=pmtt.MPISparseMatrixMult.from_banded(
            offsets, bands, (N_SP_20, N_SP_20), device=dev),
        xsp=torch.randn(N_SP_20, generator=g, device=dev))


def tiers20_f64_case(torch, pmtt, dev):
    """Phase 20's ragged f64 case, run alike by a world of ranks and by
    one CPU process: 10 blocks of (24, 16) (ragged over 3 ranks) through
    block CGLS, PCGLS with Jacobi, pipelined CGLS, and a sparse CGLS."""
    D = pmtt.DistributedArray
    rng = np.random.default_rng(201)
    blocks = [rng.standard_normal((24, 16)) / 4 + 2 * np.eye(24, 16)
              for _ in range(10)]
    Op = pmtt.convert.blockdiag_from_numpy(blocks, device=dev)
    Y = rng.standard_normal((240, 3))
    y = rng.standard_normal(240)
    A = rng.standard_normal((37, 29)) * (rng.random((37, 29)) < 0.2)
    A[np.arange(29), np.arange(29)] += 2.0
    ysp = rng.standard_normal(37)
    yb = D.to_dist(Y, local_shapes=[(s[0], 3) for s in Op.local_shapes_n],
                   device=dev)
    yd = D.to_dist(y, local_shapes=Op.local_shapes_n, device=dev)
    d = np.concatenate([np.sum(b ** 2, axis=0) for b in blocks])
    M = pmtt.JacobiPrecond(d, device=dev)
    out = {"block_cgls": pmtt.block_cgls(Op, yb, niter=NITER_20,
                                         tol=0.0)[0].asarray(),
           "pcgls": pmtt.cgls(Op, yd, niter=NITER_20, tol=0.0,
                              M=M)[0].asarray()}
    set_ca("pipelined")
    try:
        out["pipelined"] = pmtt.cgls(Op, yd, niter=NITER_20, damp=0.2,
                                     tol=0.0)[0].asarray()
    finally:
        set_ca("off")
    Sp = pmtt.MPISparseMatrixMult.from_dense(A, device=dev)
    out["sparse"] = pmtt.cgls(Sp, D.to_dist(ysp, device=dev), niter=NITER_20,
                              damp=0.1, tol=0.0)[0].asarray()
    return out


def _tiers20_solves(torch, pmtt, p, dev):
    """The f32 solves of phase 20, on the problem ``p``: {name: (x on the
    host, all_reduce calls, iterations)}; with a group, each rank's
    vectors follow the operators' splits."""
    import os
    D = pmtt.DistributedArray
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.solvers import ca
    Op, S, Sp = p["Op"], p["S"], p["Sp"]
    K = p["Y"].shape[1]
    yb = D.to_dist(p["Y"], local_shapes=[(s[0], K) for s in Op.local_shapes_n])
    y = D.to_dist(p["Y"][:, 0].contiguous(), local_shapes=Op.local_shapes_n)
    ysp = D.to_dist(p["ysp"], local_shapes=S.local_shapes_n)
    MJ = pmtt.JacobiPrecond(p["djac"])
    MB = pmtt.BlockJacobiPrecond.from_block_diag(Op, normal=True)
    MS = pmtt.BlockJacobiPrecond(p["bj"])
    yspar = Sp.matvec(D.to_dist(p["xsp"]))
    out = {}

    def run(name, fn):
        co.reset_counts()
        x, it = fn()
        torch.cuda.synchronize()
        out[name] = (x.asarray(), co.counts["all_reduce"], it)

    run("block_cgls", lambda: (lambda o: (o[0], o[2]))(
        pmtt.block_cgls(Op, yb, niter=NITER_20, tol=0.0)))
    run("pcgls_jacobi", lambda: (lambda o: (o[0], o[2]))(
        pmtt.cgls(Op, y, niter=NITER_20, tol=0.0, M=MJ)))
    run("pcgls_block", lambda: (lambda o: (o[0], o[2]))(
        pmtt.cgls(Op, y, niter=NITER_20, tol=0.0, normal=True, M=MB)))
    run("pcg_straddle", lambda: pmtt.cg(S, ysp, niter=NITER_20, tol=0.0,
                                        M=MS)[:2])
    try:
        set_ca("pipelined")
        run("pipelined_normal", lambda: (lambda o: (o[0], o[2]))(
            pmtt.cgls(Op, y, niter=NITER_20, tol=0.0, normal=True)))
        set_ca("sstep")
        ca.clear_fallback()
        run("sstep_cg", lambda: pmtt.cg(S, ysp, niter=NITER_20, tol=0.0)[:2])
        S64 = p["S64"]
        y64 = D.to_dist(p["ysp"].double(), local_shapes=S64.local_shapes_n)
        run("sstep_cg_f64", lambda: pmtt.cg(S64, y64, niter=NITER_20,
                                            tol=0.0)[:2])
        out["sstep_fallback"] = ca.last_fallback()
    finally:
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA", None)
    run("sparse_cgls", lambda: (lambda o: (o[0], o[2]))(
        pmtt.cgls(Sp, yspar, niter=NITER_20, damp=SP_DAMP, tol=0.0)))
    # the serving pool, SPMD: every rank packs the same K_20 requests
    # into the bucket of 4 (a zero-padded block_cgls)
    pool = pmtt.serving.WarmPool(buckets=(1, 2, 4))
    pool.register(pmtt.serving.FamilySpec("f20", Op, solver="cgls",
                                          niter=NITER_20))
    co.reset_counts()
    res = pool.solve("f20", p["Y"].cpu().numpy())
    if res.bucket != 4:
        raise RuntimeError(f"phase 20: the pool packed into {res.bucket}")
    out["pool"] = (res.x, co.counts["all_reduce"], res.iiter)
    # the bytes this rank receives in one apply of each
    moved = {}
    g = Op.rmatvec(y)
    xsp = D.to_dist(p["xsp"])
    for name, fn in (("jacobi", lambda: MJ.matvec(g)),
                     ("block_jacobi_chunk", lambda: MB.matvec(g)),
                     ("block_jacobi_straddle", lambda: MS.matvec(ysp)),
                     ("sparse_forward", lambda: Sp.matvec(xsp)),
                     ("sparse_adjoint", lambda: Sp.rmatvec(yspar))):
        co.reset_counts()
        fn()
        torch.cuda.synchronize()
        moved[name] = (dict(co.counts), dict(co.received))
    out["moved"] = moved
    return out


def _tiers20_rank(torch, pmtt, dev, refdir):
    """What each rank of phase 20 runs: the f32 solves against the
    no-group ones (saved in ``refdir``), their all_reduce calls, the
    bytes of each apply, and the ragged f64 case."""
    r = pmtt.parallel.rank()
    p = tiers20_problem(torch, pmtt, dev)
    solves = _tiers20_solves(torch, pmtt, p, dev)
    out = dict(rank=r, gaps={}, all_reduce={}, moved=solves.pop("moved"),
               sstep_fallback=solves.pop("sstep_fallback"))
    for name, (x, calls, it) in solves.items():
        want = np.load(f"{refdir}/{name}.npy")
        out["gaps"][name] = float(np.linalg.norm(x - want)
                                  / np.linalg.norm(want))
        out["all_reduce"][name] = (calls, it)
    f64 = tiers20_f64_case(torch, pmtt, dev)
    out["f64"] = f64 if r == 0 else None
    return out


def slice9_ranks_phase(torch, pmtt, here, dev, timeout=600):
    """Phase 20: the solver tiers across two and three gloo ranks sharing
    the card, against the same solves with no group in this process:
    every x within TOL_20, the ragged f64 case within F64_20 of one CPU
    process, each rank's all_reduce calls per iteration (pipelined 1,
    s-step 1 an outer step) and the bytes it receives per
    preconditioner and sparse apply."""
    import shutil
    import tempfile
    refdir = tempfile.mkdtemp(prefix="chip_smoke_slice9_")
    try:
        t0 = time.perf_counter()
        p = tiers20_problem(torch, pmtt, dev)
        ref = _tiers20_solves(torch, pmtt, p, dev)
        del p
        for name, v in ref.items():
            if name not in ("moved", "sstep_fallback"):
                np.save(f"{refdir}/{name}.npy", v[0])
        cpu = tiers20_f64_case(torch, pmtt, torch.device("cpu"))
        torch.cuda.empty_cache()
        print(f"20. no-group references in {time.perf_counter() - t0:.1f} s "
              f"(s-step fallback {ref['sstep_fallback']})", flush=True)
        summary = {}
        setup = {"block_cgls": 2, "pcgls_jacobi": 2, "pcgls_block": 2,
                 "pcg_straddle": 1, "pipelined_normal": 1, "sstep_cg": 1,
                 "sstep_cg_f64": 1, "sparse_cgls": 3, "pool": 2}
        for n in WORLDS_20:
            t0 = time.perf_counter()
            ranks = spawn_shared_card(n, here, _tiers20_rank, (refdir,),
                                      timeout)
            f64 = max(float(np.abs(ranks[0]["f64"][k] - cpu[k]).max()
                            / np.abs(cpu[k]).max()) for k in cpu)
            per_rank = []
            for o in ranks:
                per_iter = {k: (c - setup[k]) / it
                            for k, (c, it) in o["all_reduce"].items()}
                per_rank.append(dict(rank=o["rank"], gaps=o["gaps"],
                                     all_reduce=o["all_reduce"],
                                     all_reduce_per_iter=per_iter,
                                     moved=o["moved"],
                                     sstep_fallback=o["sstep_fallback"]))
            secs = time.perf_counter() - t0
            summary[n] = dict(f64=f64, ranks=per_rank, seconds=secs)
            print(f"20. {n} ranks on one card (gloo, staged through the "
                  f"host): ragged f64 vs CPU {f64:.3e} (limit "
                  f"{F64_20:.0e}); per rank (x gaps to the no-group solves, "
                  f"limit {TOL_20:.0e}; all_reduce calls per iteration after "
                  f"the setup's; collectives and bytes received per apply) "
                  f"{per_rank}; {secs:.1f} s", flush=True)
            if not f64 <= F64_20:
                raise RuntimeError(f"phase 20, {n} ranks: f64 gap {f64}")
            for rec in per_rank:
                # f32 s-step is printed, not held: its coordinate
                # recurrences take the Gram tile's rounding (here another
                # summation order) to x amplified like 1/residual, so it
                # is held in f64
                bad = {k: v for k, v in rec["gaps"].items()
                       if k != "sstep_cg" and not v <= TOL_20}
                if bad:
                    raise RuntimeError(f"phase 20, {n} ranks, rank "
                                       f"{rec['rank']}: gaps {bad}")
                pi = rec["all_reduce_per_iter"]
                if pi["pipelined_normal"] != 1.0:
                    raise RuntimeError(f"phase 20: rank {rec['rank']} took "
                                       f"{pi['pipelined_normal']} all_reduce "
                                       "an iteration in pipelined CGLS")
                # one Gram reduction an outer step of s iterations (one
                # more where every lane froze at the machine floor)
                calls, it = rec["all_reduce"]["sstep_cg_f64"]
                if rec["sstep_fallback"] is None and \
                        calls - setup["sstep_cg"] > -(-it // 4) + 1:
                    raise RuntimeError(f"phase 20: rank {rec['rank']} took "
                                       f"{calls - 1} s-step Gram reductions "
                                       f"in {it} iterations")
        return summary
    finally:
        shutil.rmtree(refdir, ignore_errors=True)

# ---------------------------------------------------------------- phase 21
def cold_first_request():
    """Phase 21.1's cold start, run in a fresh process
    (``python3 -c "import chip_smoke; chip_smoke.cold_first_request()"``):
    phase 3's blocks made with elementwise work only, a ``cgls`` family,
    a daemon started without prewarm, then one request (the process's
    first solve: cuBLAS handle and workspace, algorithm choice, lazy
    module loading, allocator growth) and a second one (warm). Prints
    one JSON line of the two latencies in seconds."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((NBLK, NBLOCK, NBLOCK), generator=g, device=dev)
    A /= math.sqrt(NBLOCK)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    torch.cuda.synchronize()
    pool = pmtt.serving.WarmPool(buckets=BUCKETS_21)
    pool.register(pmtt.serving.FamilySpec(
        "cgls", pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)]),
        solver="cgls", niter=NITER_21))
    ys = np.random.default_rng(21).standard_normal(
        (NBLK * NBLOCK, 2)).astype(np.float32)
    d = pmtt.serving.SolveDaemon(pool, window_s=0.0).start()
    lat = []
    for j in range(2):
        t0 = time.perf_counter()
        d.submit("cgls", ys[:, j]).wait(timeout=600)
        lat.append(time.perf_counter() - t0)
    if not d.drain(timeout=60):
        raise RuntimeError("21.1: the cold daemon did not drain")
    print(json.dumps({"cold_s": lat[0], "warm_s": lat[1],
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def _submit_threads(d, fam, cols, threads):
    """Submit ``cols[j]`` from ``threads`` threads, round robin; returns
    the tickets in request order and each submit's monotonic time."""
    import threading
    tickets, t_sub = [None] * len(cols), [0.0] * len(cols)

    def submitter(i):
        for j in range(i, len(cols), threads):
            t_sub[j] = time.monotonic()
            tickets[j] = d.submit(fam, cols[j])

    ths = [threading.Thread(target=submitter, args=(i,))
           for i in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    if any(t.is_alive() for t in ths) or any(t is None for t in tickets):
        raise RuntimeError("21: a submitting thread did not finish")
    return tickets, t_sub


def _gap(x, want):
    return float(np.linalg.norm(x - want) / np.linalg.norm(want))


def service_phase(torch, pmtt, here, dev):
    """Phase 21: the solve service at a world of one on phase 3's blocks
    (module docstring, 21). Every ticket must resolve (``Ticket.wait``
    raises a batch's error, which ends the phase), every check holds or
    the phase raises."""
    import os
    import shutil
    import tempfile
    import threading
    D = pmtt.DistributedArray
    sv = pmtt.serving
    from pylops_mpi_tpu_torch.diagnostics.metrics import quantiles
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    out = {}
    t0 = time.perf_counter()
    cold = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.cold_first_request()"],
        cwd=str(here), capture_output=True, text=True, timeout=300,
        check=True)
    out["cold"] = json.loads(cold.stdout.strip().splitlines()[-1])
    print(f"21.1 first request in a fresh process (no prewarm, bucket 1, "
          f"cgls {NITER_21} iterations): cold {out['cold']['cold_s'] * 1e3:.1f}"
          f" ms, the next one warm {out['cold']['warm_s'] * 1e3:.1f} ms "
          f"({time.perf_counter() - t0:.1f} s with the process)", flush=True)

    A, _, _ = make_problem(torch, dev)
    G = torch.bmm(A.transpose(1, 2), A)
    G.diagonal(dim1=1, dim2=2).add_(1.0)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    S = pmtt.MPIBlockDiag([MatrixMult(G[i]) for i in range(NBLK)])
    del G
    N = NBLK * NBLOCK
    pool = sv.WarmPool(buckets=BUCKETS_21)
    pool.register(sv.FamilySpec("cgls", Op, solver="cgls", niter=NITER_21))
    pool.register(sv.FamilySpec("cg", S, solver="cg", niter=NITER_CG_21,
                                tol=TOL_CG_21))
    records = []  # every packed solve: (family, Y, outcome)
    real_solve = pool.solve

    def spy(name, Y):
        res = real_solve(name, Y)
        records.append((name, np.array(Y, copy=True), res))
        return res

    pool.solve = spy
    rng = np.random.default_rng(2110)
    Y = rng.standard_normal((N, REQ_21)).astype(np.float32)
    cols = [np.ascontiguousarray(Y[:, j]) for j in range(REQ_21)]

    # sequential classic cgls: the oracles, the first SEQ_21 timed after
    # one warm solve
    ys = [D.to_dist(c, device=dev) for c in cols]
    pmtt.cgls(Op, ys[0], niter=NITER_21, tol=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oracles = [pmtt.cgls(Op, ys[j], niter=NITER_21, tol=0.0)[0].asarray()
               for j in range(SEQ_21)]
    seq_wall = time.perf_counter() - t0
    oracles += [pmtt.cgls(Op, ys[j], niter=NITER_21, tol=0.0)[0].asarray()
                for j in range(SEQ_21, REQ_21)]
    del ys
    out["sequential"] = dict(solves=SEQ_21, wall_s=seq_wall,
                             solves_per_s=SEQ_21 / seq_wall)

    # 21.1 prewarm on the dispatcher thread
    d = sv.SolveDaemon(pool, window_s=WINDOW_21).start(prewarm=True)
    out["prewarm_ms"] = {f"{f}/{b}": v * 1e3
                         for (f, b), v in sorted(pool.prewarm_s.items())}
    t0 = time.perf_counter()
    d.submit("cgls", cols[0]).wait(timeout=600)
    out["first_after_prewarm_s"] = time.perf_counter() - t0
    print(f"21.1 prewarm on the dispatcher thread, ms per family/bucket: "
          f"{ {k: round(v, 1) for k, v in out['prewarm_ms'].items()} }; "
          f"first request after it (bucket 1) "
          f"{out['first_after_prewarm_s'] * 1e3:.1f} ms", flush=True)

    # 21.2 REQ_21 requests from THREADS_21 submitting threads
    first = len(records)
    tickets, t_sub = _submit_threads(d, "cgls", cols, THREADS_21)
    res = [t.wait(timeout=600) for t in tickets]
    st = d.stats()
    if not d.drain(timeout=120):
        raise RuntimeError("21.2: the daemon did not drain")
    ends = [t + r["wait_s"] for t, r in zip(t_sub, res)]
    wall = max(ends) - min(t_sub)
    gaps = [_gap(r["x"], o) for r, o in zip(res, oracles)]
    batches = records[first:]
    bitwise = []
    for name, Yb, o in batches:
        k = Yb.shape[1]
        Yp = np.concatenate([Yb, np.zeros((N, o.bucket - k), Yb.dtype)], 1)
        xb = pmtt.block_cgls(Op, D.to_dist(Yp, device=dev),
                             niter=NITER_21, tol=0.0)[0].asarray()
        bitwise.append(bool(np.array_equal(xb[:, :k], o.x))
                       and not np.any(xb[:, k:]))
    fills = [o.k / o.bucket for _, _, o in batches]
    q50, q99 = quantiles([r["queue_s"] for r in res])
    e50, e99 = quantiles([r["wait_s"] for r in res])
    svc = REQ_21 / wall
    out["service"] = dict(
        requests=REQ_21, threads=THREADS_21, window_ms=WINDOW_21 * 1e3,
        wall_s=wall, solves_per_s=svc,
        solve_basis_solves_per_s=REQ_21 / sum(o.wall_s for *_, o in batches),
        batches=len(batches), fill_mean=sum(fills) / len(fills),
        forced=st["forced"], failed=st["failed"],
        fills=[o.k for _, _, o in batches],
        queue_p50_ms=q50 * 1e3, queue_p99_ms=q99 * 1e3,
        latency_p50_ms=e50 * 1e3, latency_p99_ms=e99 * 1e3,
        ratio_to_sequential=svc / out["sequential"]["solves_per_s"],
        max_gap=max(gaps), bitwise_batches=bitwise)
    o2 = out["service"]
    print(f"21.2 {REQ_21} requests from {THREADS_21} threads, window "
          f"{WINDOW_21 * 1e3:.0f} ms: {svc:.1f} solves/s over {wall:.3f} s "
          f"({o2['solve_basis_solves_per_s']:.1f} on the solve walls), "
          f"{o2['batches']} batches (fills {o2['fills']}), mean fill "
          f"{o2['fill_mean']:.3f}, "
          f"forced {st['forced']}, failed {st['failed']}; queue wait p50 "
          f"{q50 * 1e3:.2f} ms p99 {q99 * 1e3:.2f} ms; end-to-end p50 "
          f"{e50 * 1e3:.1f} ms p99 {e99 * 1e3:.1f} ms; sequential classic "
          f"cgls {out['sequential']['solves_per_s']:.1f} solves/s, ratio "
          f"{o2['ratio_to_sequential']:.2f}x; max column gap to the "
          f"oracles {max(gaps):.3e} (limit {GAP_21:.0e}); batches bitwise "
          f"equal to block_cgls on the padded block: {bitwise}", flush=True)
    if st["failed"] or not all(bitwise) or not max(gaps) <= GAP_21:
        raise RuntimeError(f"21.2 failed: {o2}")

    # 21.3 the cg family: one batch of 16
    Ycg = rng.standard_normal((N, 16)).astype(np.float32)
    cg_or = []
    for j in range(16):
        x, it, cost = pmtt.cg(S, D.to_dist(Ycg[:, j].copy(), device=dev),
                              niter=NITER_CG_21, tol=TOL_CG_21)
        cg_or.append((x.asarray(), it, float(cost[-1]) ** 2))
    d = sv.SolveDaemon(pool, window_s=0.5).start()
    res = [t.wait(timeout=600) for t in
           [d.submit("cg", Ycg[:, j].copy()) for j in range(16)]]
    d.drain(timeout=120)
    its = [it for _, it, _ in cg_or]
    cgap = max(_gap(r["x"], o[0]) for r, o in zip(res, cg_or))
    out["cg"] = dict(tol=TOL_CG_21, oracle_iters=its,
                     oracle_converged=all(k < TOL_CG_21 for *_, k in cg_or),
                     statuses=sorted({r["status"] for r in res}),
                     batch_k=[r["batch_k"] for r in res][0],
                     iiter=res[0]["iiter"], max_gap=cgap)
    print(f"21.3 cg family (tol {TOL_CG_21:g} absolute on the squared "
          f"residual, |y|^2 ~ {N:.3g}): one batch of "
          f"{out['cg']['batch_k']}, statuses {out['cg']['statuses']}, iiter "
          f"{out['cg']['iiter']} against the oracles' {min(its)}-{max(its)}, "
          f"max gap {cgap:.3e}", flush=True)
    if not (out["cg"]["oracle_converged"] and out["cg"]["statuses"] ==
            ["converged"] and abs(res[0]["iiter"] - max(its)) <= 1
            and out["cg"]["batch_k"] == 16 and cgap <= GAP_21):
        raise RuntimeError(f"21.3 failed: {out['cg']}")

    # 21.4 a poisoned column, guards on and off; guard cost in pairs
    Yc = Y[:, :16].copy()
    Yn = Yc.copy()
    Yn[7, 1] = np.nan
    os.environ["PYLOPS_MPI_TPU_TORCH_GUARDS"] = "on"
    try:
        clean = pool.solve("cgls", Yc)
        pois = pool.solve("cgls", Yn)
    finally:
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_GUARDS")
    off = pool.solve("cgls", Yn)
    healthy = [j for j in range(16) if j != 1]
    same = bool(np.array_equal(pois.x[:, healthy], clean.x[:, healthy]))
    pairs = []
    for i in range(PAIRS_21):
        walls = {}
        for guards in (("on", "off") if i % 2 == 0 else ("off", "on")):
            if guards == "on":
                os.environ["PYLOPS_MPI_TPU_TORCH_GUARDS"] = "on"
            try:
                o = pool.solve("cgls", Yc)
            finally:
                os.environ.pop("PYLOPS_MPI_TPU_TORCH_GUARDS", None)
            walls[guards] = o.wall_s / o.iiter
        pairs.append(walls["on"] / walls["off"])
    pairs.sort()
    out["guards"] = dict(
        on_statuses=pois.statuses, healthy_bitwise=same,
        off_statuses=off.statuses, off_iiter=off.iiter,
        off_x_is_x0=bool(not np.any(off.x)),
        ratio_median=pairs[len(pairs) // 2], ratio_range=[pairs[0],
                                                          pairs[-1]])
    print(f"21.4 bucket-16 batch with a NaN in column 1: guards on -> "
          f"column 1 {pois.statuses[1]}, the others {sorted(set(pois.statuses[:1] + pois.statuses[2:]))} "
          f"and bitwise equal to the clean batch: {same}; guards off -> "
          f"iiter {off.iiter}, x is x0 (zeros): {out['guards']['off_x_is_x0']}"
          f", statuses {sorted(set(off.statuses))}; guard-on over guard-off "
          f"wall per iteration, {PAIRS_21} alternating pairs: median "
          f"{out['guards']['ratio_median']:.4f}, range "
          f"{pairs[0]:.4f}-{pairs[-1]:.4f}", flush=True)
    if not (pois.statuses[1] == "breakdown" and same and off.iiter == 0
            and out["guards"]["off_x_is_x0"]
            and off.statuses[1] == "breakdown"):
        raise RuntimeError(f"21.4 failed: {out['guards']}")

    # 21.5 deadlines: one already past; then, after a full warm batch
    # has set the dispatcher's solve-wall estimate (its margin is 1.5x
    # that estimate + 10 ms), three requests due in DUE_21 s with a 30 s
    # window, which must go out undersized and resolve by their deadline
    d = sv.SolveDaemon(pool, window_s=30.0).start(prewarm=True)
    n0 = len(records)
    t = d.submit("cgls", cols[0], deadline_ts=time.time() - 5.0)
    try:
        t.wait(timeout=120)
        missed = None
    except RuntimeError as e:  # the failure this step requires
        missed = str(e)
    skipped_solves = len(records) - n0
    for t in [d.submit("cgls", cols[j]) for j in range(16)]:
        t.wait(timeout=120)
    warm_wall = records[-1][2].wall_s
    forced0 = d.stats()["forced"]  # the missed batch was forced too
    due = time.time() + DUE_21
    near = [d.submit("cgls", cols[j], deadline_ts=due) for j in range(3)]
    res = [t.wait(timeout=120) for t in near]
    late = time.time() - due  # read after the waits: an upper bound
    st = d.stats()
    d.drain(timeout=120)
    fgap = max(_gap(r["x"], oracles[j]) for j, r in enumerate(res))
    out["deadline"] = dict(missed=missed, solves_for_missed=skipped_solves,
                           warm_wall_s=warm_wall,
                           forced=st["forced"] - forced0,
                           resolved_before_deadline_s=-late,
                           forced_wall_s=records[-1][2].wall_s,
                           batch_k=res[0]["batch_k"],
                           bucket=res[0]["bucket"], max_gap=fgap)
    print(f"21.5 a deadline 5 s past: ticket failed ({missed!r}) after "
          f"{skipped_solves} solves; after a warm batch of 16 (wall "
          f"{warm_wall * 1e3:.1f} ms), 3 requests due in {DUE_21} s with a "
          f"30 s window: forced {st['forced'] - forced0}, dispatched as "
          f"{res[0]['batch_k']} in bucket {res[0]['bucket']} (wall "
          f"{records[-1][2].wall_s * 1e3:.1f} ms), resolved "
          f"{-late * 1e3:.1f} ms before the deadline, max gap {fgap:.3e}",
          flush=True)
    if not (missed and "window exhausted" in missed and skipped_solves == 0
            and st["forced"] - forced0 == 1 and late <= 0.0
            and res[0]["batch_k"] == 3 and fgap <= GAP_21):
        raise RuntimeError(f"21.5 failed: {out['deadline']}")

    # 21.6 worker_main on a temporary spool, in a thread
    root = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    try:
        for j in range(SPOOL_21):
            sv.spool.enqueue(root, "cgls", cols[j], request_id=f"r{j:02d}")
        sv.spool.request_drain(root)
        got = []
        th = threading.Thread(target=lambda: got.append(sv.worker_main(
            root, pool, prewarm=False, window_s=WINDOW_21)))
        t0 = time.perf_counter()
        th.start()
        th.join(timeout=600)
        wwall = time.perf_counter() - t0
        if th.is_alive():
            raise RuntimeError("21.6: worker_main did not return")
        banked = [sv.spool.read_result(root, f"r{j:02d}")
                  for j in range(SPOOL_21)]
        wgap = max(_gap(b["x"], oracles[j]) for j, b in enumerate(banked))
        out["worker"] = dict(returned=got, banked=len(
            sv.spool.result_ids(root)), wall_s=wwall, max_gap=wgap,
            pending=sv.spool.pending_count(root),
            failed=len(os.listdir(os.path.join(root, "failed"))))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"21.6 worker_main on a spool of {SPOOL_21} requests and a DRAIN "
          f"marker: returned {got}, {out['worker']['banked']} results "
          f"banked, {out['worker']['failed']} failed, in {wwall:.3f} s, max "
          f"gap to 21.2's oracles {wgap:.3e}", flush=True)
    if not (got == [SPOOL_21] and out["worker"]["banked"] == SPOOL_21
            and out["worker"]["failed"] == 0 and wgap <= GAP_21):
        raise RuntimeError(f"21.6 failed: {out['worker']}")
    del pool, Op, S, A
    torch.cuda.empty_cache()
    return out


# phase 22 (slice 11): each fused loop through the bank of captured CUDA
# graphs (PYLOPS_MPI_TPU_TORCH_AOT=on, set in-process) against the same
# solve run eagerly. NITER_22 is not a multiple of 8, so every path runs
# an eager tail; PAIRS_22 alternating pairs of walls per path
NITER_22, PAIRS_22, K_22, GLOO_22 = 50, 4, 16, 2
PROFILES_22 = 3
# the device-bound paths (the Gradient CGLS ~16.5 ms an iteration,
# FISTA/ISTA 7.5-10.7 ms) run fewer iterations, also not a multiple of 8
NITER_SLOW_22 = 26
GLOO_N_22, GLOO_M_22, GLOO_TOL_22 = 8, 512, 1e-5


def set_aot(on):
    import os
    os.environ["PYLOPS_MPI_TPU_TORCH_AOT"] = "on" if on else "off"


def _flat_out(torch, out):
    """A solver's outputs as a flat list: the tensors of its vectors, its
    tensors and its Python numbers."""
    items = []
    for v in out if isinstance(out, tuple) else (out,):
        if hasattr(v, "distarrays"):
            items += [d.array for d in v.distarrays]
        elif hasattr(v, "array") and isinstance(v.array, torch.Tensor):
            items.append(v.array)
        elif isinstance(v, (list, tuple)):
            items += list(v)
        else:
            items.append(v)
    return items


def _bitwise(torch, a, b):
    if len(a) != len(b):
        return False
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            if not (isinstance(v, torch.Tensor) and u.dtype == v.dtype
                    and u.shape == v.shape and torch.equal(u, v)):
                return False
        elif u != v:
            return False
    return True


def _counts22(kernels):
    """The launch, path and collective counts a solve leaves."""
    from pylops_mpi_tpu_torch.ops import derivatives
    from pylops_mpi_tpu_torch.parallel import collectives as co
    nk, sk = kernels
    return dict(normal=nk.launches, stencil=sk.launches,
                collectives=dict(co.counts), paths=dict(derivatives.paths))


def _reset22(kernels):
    from pylops_mpi_tpu_torch.ops import derivatives
    from pylops_mpi_tpu_torch.parallel import collectives as co
    for k in kernels:
        k.reset_launches()
    co.reset_counts()
    derivatives.paths.clear()


def graph_path(torch, pmtt, kernels, label, solve, it_index,
               match=("normal_kernel<", "normal_reduce_kernel<"),
               counter="normal", per_iter=None):
    """One path of phase 22: ``solve()`` eagerly, then twice through the
    bank (the first captures, the second must capture nothing), each
    banked result bitwise equal to the eager one with the same launch,
    path and collective counts; then PAIRS_22 alternating pairs of walls
    and a profile of each way (idle share; device ms of the kernels whose
    name holds one of ``match``). The profiler also counts the kernel
    events named ``match[0]`` in the graph run and in the eager run: the
    graph run's count must equal the eager run's and, given
    ``per_iter``, that many an iteration; the wrapper's count
    ``counter`` is printed beside them. A replay runs no Python, so no
    wrapper counts its launches; only the iterations outside full
    segments (the tail) launch from Python in the graph run, so the rest
    of its count ran inside the replays. ``it_index``: where the
    iteration count sits in the flat outputs."""
    from pylops_mpi_tpu_torch.aot import graphs, store

    def run(on):
        set_aot(on)
        _reset22(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _flat_out(torch, solve())
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out, _counts22(kernels)

    def events(rows):
        return sum(n for _, name, n in rows if match[0] in name)

    _, eager, ce = run(False)
    c0 = graphs.capture_count()
    with graphs.recording_keys() as keys:
        _, first, c1 = run(True)
    caps = graphs.capture_count() - c0
    entries = [store.mem_get(k) for k in dict.fromkeys(keys)]
    cap_ms = [e.ms for e in entries]
    _, second, c2 = run(True)
    recaptured = graphs.capture_count() - c0 - caps
    iters = int(eager[it_index])
    res = dict(iiter=iters, captures=caps, capture_ms=cap_ms,
               recaptured=recaptured, counts=ce,
               counts_equal=(c1 == ce and c2 == ce),
               bitwise=(_bitwise(torch, first, eager)
                        and _bitwise(torch, second, eager)))
    if not (res["bitwise"] and res["counts_equal"] and caps >= 1
            and recaptured == 0):
        raise RuntimeError(f"22 {label}: the graph run differs from the "
                           f"eager run: {res}, counts {c1} {c2}")
    walls = {False: [], True: []}
    for i in range(PAIRS_22):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            walls[on].append(run(on)[0])
    ratios = [e / g for e, g in zip(walls[False], walls[True])]
    res.update(eager_wall_s=walls[False], graph_wall_s=walls[True],
               eager_iters_per_s=[iters / w for w in walls[False]],
               graph_iters_per_s=[iters / w for w in walls[True]],
               speedup=ratios, speedup_median=float(np.median(ratios)),
               bank_bytes=graphs.bank_bytes())
    # a profile may miss a kernel record (the pipelined path's graph run
    # once counted 50 of its 51; the Gradient CGLS's eager and graph runs
    # 54 of the wrapper's 55 in three pairs of one run, 55 in another), so
    # the gate holds the two profiles to each other, not to the wrapper:
    # up to PROFILES_22 pairs, every pair's counts kept and printed, the
    # gate held on the last
    want = None if per_iter is None else per_iter * iters
    res["profiled_events"] = []
    for _ in range(PROFILES_22):
        for on, name in ((False, "eager"), (True, "graph")):
            set_aot(on)
            _reset22(kernels)
            r0 = graphs.stats().get("replays", 0)
            wall_ms, rows = device_rows(torch, solve)
            res[f"{name}_idle_share"] = 1.0 - sum(r[0] for r in rows) / wall_ms
            res[f"{name}_kernel_ms"] = sum(r[0] for r in rows
                                           if any(k in r[1] for k in match))
            res[f"{name}_kernel_events"] = events(rows)
            res[f"{name}_wrapper_count"] = _counts22(kernels)[counter]
            res[f"{name}_replays"] = graphs.stats().get("replays", 0) - r0
            res[f"{name}_profile_top"] = [(ms, n[:60], c)
                                          for ms, n, c in rows[:6]]
        res["profiled_events"].append((res["eager_kernel_events"],
                                       res["graph_kernel_events"]))
        if res["graph_kernel_events"] == res["eager_kernel_events"] \
                and want in (None, res["graph_kernel_events"]):
            break
    set_aot(False)
    if not (res["graph_kernel_events"] == res["eager_kernel_events"]
            and want in (None, res["graph_kernel_events"])
            and res["graph_replays"] >= 1):
        raise RuntimeError(
            f"22 {label}: kernel events {match[0]} in the profiles: graph "
            f"run {res['graph_kernel_events']}, eager run "
            f"{res['eager_kernel_events']} (pairs {res['profiled_events']})"
            f", {want} wanted; the eager wrapper counted "
            f"{ce[counter]}; replays {res['graph_replays']}")
    gi, ei = res["graph_iters_per_s"], res["eager_iters_per_s"]
    print(f"22 {label}: {iters} iterations, graph vs eager bitwise equal "
          f"(x, iiter, costs) with equal counts {ce}; {caps} capture(s) of "
          f"{[round(m, 1) for m in cap_ms]} ms, none on the second solve; "
          f"iters/s graph median {np.median(gi):.1f} ({min(gi):.1f}-"
          f"{max(gi):.1f}) vs eager {np.median(ei):.1f} ({min(ei):.1f}-"
          f"{max(ei):.1f}), pair ratios {[round(r, 3) for r in ratios]}; "
          f"idle share graph {res['graph_idle_share']:.1%} vs eager "
          f"{res['eager_idle_share']:.1%}; matched kernels' device ms in "
          f"the graph run {res['graph_kernel_ms']:.3f}; {match[0]} events "
          f"in the profiles: graph run {res['graph_kernel_events']}, eager "
          f"run {res['eager_kernel_events']} (eager, graph pairs profiled "
          f"{res['profiled_events']}), the wrapper's {ce[counter]}; the "
          f"graph run's replays {res['graph_replays']};"
          f" bank {res['bank_bytes'] / 2**20:.1f} MiB", flush=True)
    return res


def _gloo22_problem(torch, pmtt, dev):
    """Phase 22's gloo problem, made alike in the parent and every rank:
    GLOO_N_22 f32 blocks of GLOO_M_22 and one right-hand side."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    g = torch.Generator(device=dev).manual_seed(22)
    A = torch.randn((GLOO_N_22, GLOO_M_22, GLOO_M_22), generator=g,
                    device=dev) / math.sqrt(GLOO_M_22)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    y = torch.randn(GLOO_N_22 * GLOO_M_22, generator=g, device=dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(GLOO_N_22)])
    return Op, pmtt.DistributedArray.to_dist(y,
                                             local_shapes=Op.local_shapes_n)


def _gloo22_cases(torch, pmtt, dev):
    """What each gloo rank of phase 22 runs: the knob on, a normal=True
    CGLS that must run eagerly with the reason ``gloo``."""
    from pylops_mpi_tpu_torch.aot import graphs
    set_aot(True)
    graphs.reset_capture_count()
    Op, y = _gloo22_problem(torch, pmtt, dev)
    x = pmtt.cgls(Op, y, niter=NITER_22, tol=0.0, normal=True)[0].asarray()
    return dict(rank=pmtt.parallel.rank(), x=x, stats=graphs.stats())


def _service22(torch, pmtt, dev, A, eager21):
    """22.7: phase 21.2's REQ_21 requests from THREADS_21 threads with
    the bank armed: prewarm captures each bucket on the dispatcher
    thread, every ticket resolves and every batch equals block_cgls (run
    eagerly) on its padded block bitwise."""
    D = pmtt.DistributedArray
    sv = pmtt.serving
    from pylops_mpi_tpu_torch.aot import graphs
    from pylops_mpi_tpu_torch.diagnostics.metrics import quantiles
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    N = NBLK * NBLOCK
    pool = sv.WarmPool(buckets=BUCKETS_21)
    pool.register(sv.FamilySpec("cgls", Op, solver="cgls", niter=NITER_21))
    records = []
    real_solve = pool.solve

    def spy(name, Y):
        res = real_solve(name, Y)
        records.append((np.array(Y, copy=True), res))
        return res

    pool.solve = spy
    Y = np.random.default_rng(2110).standard_normal(
        (N, REQ_21)).astype(np.float32)
    cols = [np.ascontiguousarray(Y[:, j]) for j in range(REQ_21)]
    set_aot(True)
    c0 = graphs.capture_count()
    d = sv.SolveDaemon(pool, window_s=WINDOW_21).start(prewarm=True)
    captures = graphs.capture_count() - c0
    first = len(records)  # after the prewarm solves
    tickets, t_sub = _submit_threads(d, "cgls", cols, THREADS_21)
    res = [t.wait(timeout=600) for t in tickets]
    st = d.stats()
    if not d.drain(timeout=120):
        raise RuntimeError("22.7: the daemon did not drain")
    traffic_captures = graphs.capture_count() - c0 - captures
    ends = [t + r["wait_s"] for t, r in zip(t_sub, res)]
    wall = max(ends) - min(t_sub)
    batches = records[first:]
    set_aot(False)
    bitwise = []
    for Yb, o in batches:
        k = Yb.shape[1]
        Yp = np.concatenate([Yb, np.zeros((N, o.bucket - k), Yb.dtype)], 1)
        xb = pmtt.block_cgls(Op, D.to_dist(Yp, device=dev),
                             niter=NITER_21, tol=0.0)[0].asarray()
        bitwise.append(bool(np.array_equal(xb[:, :k], o.x)))
    q50, q99 = quantiles([r["queue_s"] for r in res])
    e50, e99 = quantiles([r["wait_s"] for r in res])
    out = dict(requests=REQ_21, solves_per_s=REQ_21 / wall, wall_s=wall,
               captures=captures, traffic_captures=traffic_captures,
               prewarm_ms={f"{f}/{b}": v * 1e3
                           for (f, b), v in sorted(pool.prewarm_s.items())},
               batches=len(batches), fills=[o.k for _, o in batches],
               queue_p50_ms=q50 * 1e3, queue_p99_ms=q99 * 1e3,
               latency_p50_ms=e50 * 1e3, latency_p99_ms=e99 * 1e3,
               failed=st["failed"], bitwise_batches=bitwise,
               bank_bytes=graphs.bank_bytes())
    e = (eager21 or {}).get("service", {})
    print(f"22.7 service, {REQ_21} requests from {THREADS_21} threads with "
          f"the bank: {out['solves_per_s']:.1f} solves/s (phase 21 eager "
          f"{e.get('solves_per_s', float('nan')):.1f}); queue wait p50 "
          f"{q50 * 1e3:.2f} ms p99 {q99 * 1e3:.2f} ms (phase 21: "
          f"{e.get('queue_p50_ms', float('nan')):.2f} / "
          f"{e.get('queue_p99_ms', float('nan')):.2f}); end-to-end p50 "
          f"{e50 * 1e3:.1f} p99 {e99 * 1e3:.1f} ms (phase 21: "
          f"{e.get('latency_p50_ms', float('nan')):.1f} / "
          f"{e.get('latency_p99_ms', float('nan')):.1f}); prewarm captures "
          f"{captures}, ms per bucket "
          f"{ {k: round(v, 1) for k, v in out['prewarm_ms'].items()} }; "
          f"batches {out['fills']}, each bitwise equal to eager block_cgls: "
          f"{bitwise}", flush=True)
    if st["failed"] or not all(bitwise) or captures < 1 \
            or traffic_captures:
        raise RuntimeError(f"22.7 failed: {out}")
    return out


def graphs_phase(torch, pmtt, kernels, here, dev, eager21=None):
    """Phase 22: every fused loop of this slice through the bank of
    captured CUDA graphs at full width (module docstring, 22)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from pylops_mpi_tpu_torch import aot
    from pylops_mpi_tpu_torch.aot import graphs
    from pylops_mpi_tpu_torch.ops.local import Conv1D, MatrixMult
    D = pmtt.DistributedArray
    f32 = torch.float32
    res = {}
    aot.clear_memory()
    graphs.reset_capture_count()

    def done():
        aot.clear_memory()
        torch.cuda.empty_cache()

    # slice 1: normal=True f32 and bf16 storage, classic; block_cgls K=16
    A, _, y_t = make_problem(torch, dev)
    y = D.to_dist(y_t)
    for label, cdt, normal in (("normal_f32", None, True),
                               ("normal_bf16", torch.bfloat16, True),
                               ("classic_f32", None, False)):
        Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)],
                               compute_dtype=cdt)
        res[label] = graph_path(
            torch, pmtt, kernels, f"cgls {label} 32x4096^2",
            lambda: pmtt.cgls(Op, y, niter=NITER_22, tol=0.0, normal=normal),
            2, per_iter=1 if normal else None)
        del Op
        done()
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    g = torch.Generator(device=dev).manual_seed(221)
    yb = D.to_dist(torch.randn((NBLK * NBLOCK, K_22), generator=g,
                               device=dev))
    res["block_cgls"] = graph_path(
        torch, pmtt, kernels, f"block_cgls K={K_22}",
        lambda: pmtt.block_cgls(Op, yb, niter=NITER_22, tol=0.0), 2)
    del Op, yb
    done()

    # the Gradient-regularized post-stack CGLS through the tap kernel
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=4)
    StackOp, ystack, _ = gradient_poststack(torch, pmtt, m, wav,
                                            NITER_SLOW_22, f32)
    del m
    res["gradient_cgls"] = graph_path(
        torch, pmtt, kernels, f"gradient-regularized CGLS ({NX}, {NT0})",
        lambda: pmtt.cgls(StackOp, ystack, niter=NITER_SLOW_22, damp=DAMP,
                          tol=0.0), 2, match=("taps_kernel<",),
        counter="stencil")
    if res["gradient_cgls"]["graph_kernel_events"] <= 0:
        raise RuntimeError("22 gradient: no tap kernel in the graph run")
    del StackOp, ystack
    done()

    # FISTA and ISTA on the reflectivity cube (the step size computed once)
    dims = (NY_R // NBLK_R, NX_R, NZ_R)
    wavr = pmtt.models.ricker(np.arange(21) * 0.004, f0=15)[0]
    Cop = pmtt.MPIBlockDiag([Conv1D(dims, wavr, axis=-1, offset=len(wavr)
                                    // 2, dtype=f32, device=dev)] * NBLK_R)
    mr, _ = reflectivity_model(torch, dev, seed=7)
    d = Cop @ D.to_dist(mr.reshape(-1))
    x0 = d.zeros_like()
    alpha = 1.0 / abs(pmtt.power_iteration(Cop.H @ Cop, x0, dtype=f32)[0])
    for name, solver in (("fista", pmtt.fista), ("ista", pmtt.ista)):
        res[name] = graph_path(
            torch, pmtt, kernels, f"{name} ({NY_R}, {NX_R}, {NZ_R})",
            lambda: solver(Cop, d, x0=x0, niter=NITER_SLOW_22,
                           eps=EPS_SPARSE, alpha=alpha, tol=0.0), 1)
    del Cop, mr, d, x0
    done()

    # V-cycle PCG on the Laplacian (phase 19.5), to its tolerance
    Lop = lap_op(torch, pmtt, VC_DIMS, VC_EPS, f32)
    gv = torch.Generator(device=dev).manual_seed(195)
    yv = Lop.matvec(D.to_dist(torch.randn(VC_DIMS[0] * VC_DIMS[1],
                                          generator=gv, device=dev)))
    V = pmtt.VCyclePrecond(lambda dd: lap_op(torch, pmtt, dd, VC_EPS, f32),
                           VC_DIMS, levels=VC_LEVELS, device=dev)
    tol = VC_RTOL ** 2 * float(yv.dot(V.matvec(yv)))
    res["vcycle_pcg"] = graph_path(
        torch, pmtt, kernels, f"V-cycle PCG {VC_DIMS}",
        lambda: pmtt.cg(Lop, yv, niter=VC_CAP, tol=tol, M=V), 1)
    del Lop, yv, V
    done()

    # the pipelined CGLS under a group of one over NCCL: reductions inside
    # the graph
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    pmtt.parallel.init(backend="nccl", store=dist.FileStore(f"{tmp}/store", 1),
                       rank=0, world_size=1, device=dev)
    try:
        set_ca("pipelined")
        Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
        res["pipelined_nccl"] = graph_path(
            torch, pmtt, kernels, "pipelined CGLS normal=True, group of one "
            "over NCCL", lambda: pmtt.cgls(Op, y, niter=NITER_22, tol=0.0,
                                           normal=True), 2)
        if not res["pipelined_nccl"]["counts"]["collectives"].get(
                "all_reduce"):
            raise RuntimeError("22 pipelined: no all_reduce under the group")
        del Op
    finally:
        set_ca("off")
        done()
        pmtt.parallel.destroy()
        shutil.rmtree(tmp, ignore_errors=True)

    # the service with prewarm capturing (phase 21.2's traffic)
    res["service"] = _service22(torch, pmtt, dev, A, eager21)
    del A, y
    done()

    # two gloo ranks sharing the card: eager with the reason gloo
    Op, yg = _gloo22_problem(torch, pmtt, dev)
    set_aot(False)
    xg = pmtt.cgls(Op, yg, niter=NITER_22, tol=0.0, normal=True)[0].asarray()
    del Op, yg
    ranks = spawn_shared_card(GLOO_22, here, _gloo22_cases)
    gaps = [float(np.linalg.norm(r["x"] - xg) / np.linalg.norm(xg))
            for r in ranks]
    reasons = [r["stats"] for r in ranks]
    res["gloo"] = dict(ranks=GLOO_22, gaps=gaps, stats=reasons)
    print(f"22.8 {GLOO_22} gloo ranks sharing the card with the bank armed: "
          f"stats per rank {reasons}; x gap to the no-group solve "
          f"{max(gaps):.3e} (limit {GLOO_TOL_22:.0e})", flush=True)
    if not all(r.get("eager.gloo") == 1 and not r.get("captures")
               for r in reasons) or not max(gaps) <= GLOO_TOL_22:
        raise RuntimeError(f"22.8 gloo ranks: {res['gloo']}")
    done()
    return res


# ------------------------------------------------------------ phase 23
NITER_23 = 60        # 23.1/23.2: bf16 to the NaN, then f32 from there
NAN_AT_23 = 10
ERR_LIMIT_23 = 1e-4  # phase 3's f32 error limit
REFINE_TOL_23, NARROW_MIN_23 = 1e-10, 0.8
SEG_NITER_23, SEG_EPOCH_23, SEG_KILL_23, PAIRS_23 = 48, 8, 3, 4
HB_23, SLEEP_23 = 1.0, 0.5   # 23.5: beat interval, first attempt's nap
NITER_CA_23, NITER_FISTA_23, NAN_FISTA_23 = 30, 20, 5


class _Kill(Exception):
    pass


def _sync(torch):
    torch.cuda.synchronize()


def _ms_since(torch, t0):
    _sync(torch)
    return (time.perf_counter() - t0) * 1e3


def resilient_part(torch, pmtt, nk, A, xtrue, y, aot):
    """23.1 (eager) / 23.2 (through the bank): ``resilient_solve`` of
    bf16 storage under ``cgls(normal=True)``, NaN at NAN_AT_23, the
    restart at f32. Returns the record, the factory's operators and x."""
    from pylops_mpi_tpu_torch.ops import _precision as prec
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.resilience import faults
    ops, builds = {}, []

    def make_op(cdt):
        if str(cdt) not in ops:
            t0 = time.perf_counter()
            ops[str(cdt)] = pmtt.MPIBlockDiag(
                [MatrixMult(A[i]) for i in range(A.shape[0])],
                compute_dtype=cdt)
            builds.append(_ms_since(torch, t0))
        return ops[str(cdt)]

    set_aot(aot)
    prec.set_precision("bf16")  # the first rung: the policy's bf16
    try:
        nk.reset_launches()
        faults.arm("nan", NAN_AT_23)
        t0 = time.perf_counter()
        res = pmtt.resilient_solve(make_op, y, solver="cgls", niter=NITER_23,
                                   tol=0.0, normal=True)
        wall = _ms_since(torch, t0)
        by = dict(nk.launches_by_dtype)
    finally:
        prec.set_precision(None)
        faults.disarm()
        set_aot(False)
    att = res.attempts
    err = rel_norm(res.x.array, xtrue)
    rec = dict(attempts=att, restarts=res.restarts, status=res.status,
               iiter=res.iiter, rel_err=err, wall_ms=wall, build_ms=builds,
               rebuild_ms=builds[1] if len(builds) > 1 else None,
               launches_by_dtype=by)
    ok = (res.restarts == 1 and len(att) == 2
          and att[0]["compute_dtype"] == "bfloat16"
          and att[0]["status"] == "breakdown"
          and NAN_AT_23 <= att[0]["iiter"] <= NAN_AT_23 + 2
          and att[1]["compute_dtype"] == "float32"
          and by.get("bfloat16", 0) >= att[0]["iiter"] > 0
          and by.get("float32", 0) >= att[1]["iiter"] > 0
          and err <= ERR_LIMIT_23)
    print(f"23.{2 if aot else 1} resilient_solve cgls(normal=True) "
          f"{'graph bank on' if aot else 'eager'}: attempts {att}, restarts "
          f"{res.restarts}, rel err {err:.3e} (limit {ERR_LIMIT_23:.0e}), "
          f"{res.iiter} iterations in {wall:.1f} ms; normal-kernel launches "
          f"by dtype {by} (bfloat16 = _normal_kernel_stream, float32 = "
          f"_normal_kernel); operator builds {[round(b, 2) for b in builds]} "
          f"ms, the restart's rebuild {rec['rebuild_ms']:.2f} ms",
          flush=True)
    if not ok:
        raise RuntimeError(f"23.{2 if aot else 1}: {rec}")
    return rec, ops, res.x.array.clone()


def refined_part(torch, pmtt, nk, A, y):
    """23.3: ``refined_solve`` of cgls(normal=True), bf16 inner solves and
    f64 wide applies, to tol 1e-10."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    A64 = A.double()

    def make_op(dt):
        if dt == torch.float64:
            return pmtt.MPIBlockDiag([MatrixMult(A64[i])
                                      for i in range(A.shape[0])])
        return pmtt.MPIBlockDiag([MatrixMult(A[i])
                                  for i in range(A.shape[0])],
                                 compute_dtype=dt)

    nk.reset_launches()
    t0 = time.perf_counter()
    res = pmtt.resilience.refined_solve(
        make_op, y, solver="cgls", niter=200, tol=REFINE_TOL_23,
        inner_dtype=torch.bfloat16, inner_niter=50, inner_tol=1e-4,
        max_passes=10, normal=True)
    wall = _ms_since(torch, t0)
    rec = dict(status=res.status, passes=res.passes, inner_iters=res.iiter,
               narrow_frac=res.narrow_frac, residuals=res.residuals,
               attempts=[a["compute_dtype"] for a in res.attempts],
               wall_ms=wall, launches_by_dtype=dict(nk.launches_by_dtype))
    print(f"23.3 refined_solve cgls(normal=True), bf16 inner, f64 wide: "
          f"{res.status} at tol {REFINE_TOL_23:.0e} in {res.passes} passes, "
          f"{res.iiter} inner iterations, narrow share {res.narrow_frac:.4f} "
          f"(min {NARROW_MIN_23}), residuals {res.residuals}, inner dtypes "
          f"{rec['attempts']}, {wall:.1f} ms wall; normal-kernel launches "
          f"by dtype {rec['launches_by_dtype']}", flush=True)
    if res.status != "converged" or res.narrow_frac < NARROW_MIN_23:
        raise RuntimeError(f"23.3: {rec}")
    del A64
    return rec


def segmented_part(torch, pmtt, A, y):
    """23.4: classic ``cgls_segmented``, bitwise the fused solve, killed
    at an epoch and resumed bitwise from its checkpoint; ms per
    checkpoint and iters/s against the fused solve in pairs."""
    import shutil
    import tempfile
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.utils import checkpoint as ck
    seg = pmtt.solvers.segmented.cgls_segmented
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(A.shape[0])])
    kw = dict(niter=SEG_NITER_23, tol=0.0)
    fused = pmtt.cgls(Op, y, **kw)
    ref = seg(Op, y, epoch=SEG_EPOCH_23, **kw)
    same = (torch.equal(ref.x.array, fused[0].array)
            and torch.equal(ref.cost, fused[5]))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seg_")
    path = f"{tmp}/carry.ckpt"
    saves = []
    orig = ck.save_fused_carry

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        orig(*a, **k)
        saves.append(_ms_since(torch, t0))

    def kill(info):
        if info["epoch"] == SEG_KILL_23:
            raise _Kill

    ck.save_fused_carry = timed_save
    try:
        try:
            seg(Op, y, epoch=SEG_EPOCH_23, checkpoint_path=path,
                on_epoch=kill, **kw)
        except _Kill:
            pass
        res = seg(Op, y, epoch=SEG_EPOCH_23, checkpoint_path=path, **kw)
    finally:
        ck.save_fused_carry = orig
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = (torch.equal(res.x.array, ref.x.array)
               and torch.equal(res.cost, ref.cost) and res.iiter == ref.iiter)
    walls = {"fused": [], "segmented": []}
    for i in range(PAIRS_23):
        for name in (("fused", "segmented") if i % 2 == 0
                     else ("segmented", "fused")):
            t0 = time.perf_counter()
            if name == "fused":
                pmtt.cgls(Op, y, **kw)
            else:
                seg(Op, y, epoch=SEG_EPOCH_23, **kw)
            walls[name].append(_ms_since(torch, t0) / 1e3)
    ips = {k: [SEG_NITER_23 / w for w in v] for k, v in walls.items()}
    ratios = [s / f for s, f in zip(ips["segmented"], ips["fused"])]
    rec = dict(bitwise_fused=same, bitwise_resumed=resumed,
               resumed_epochs=res.epochs, checkpoint_ms=saves,
               ms_per_checkpoint=float(np.mean(saves)), iters_per_s=ips,
               segmented_over_fused=ratios)
    print(f"23.4 cgls_segmented classic, {SEG_NITER_23} iterations, epoch "
          f"{SEG_EPOCH_23}: x and cost bitwise the fused solve's: {same}; "
          f"killed at epoch {SEG_KILL_23}, resumed ({res.epochs} epochs) "
          f"bitwise: {resumed}; {float(np.mean(saves)):.2f} ms per "
          f"checkpoint ({[round(v, 2) for v in saves]}); iters/s fused "
          f"{[round(v, 1) for v in ips['fused']]}, segmented "
          f"{[round(v, 1) for v in ips['segmented']]}, segmented/fused "
          f"{[round(v, 4) for v in ratios]}", flush=True)
    if not (same and resumed):
        raise RuntimeError(f"23.4: {rec}")
    del Op
    return rec


def resilience_problem(torch, pmtt, dev, nblk, nblock):
    """23.5's f64 problem: phase 3's seeded blocks (made on the card in
    every process alike) widened to f64, this rank's chunk only."""
    from pylops_mpi_tpu_torch.ops.blockdiag import _chunk_ops
    from pylops_mpi_tpu_torch.ops.local import MatrixMult, ShapeOnly
    from pylops_mpi_tpu_torch.parallel.mesh import rank, world_size
    g = torch.Generator(device=dev).manual_seed(5)
    A = torch.randn((nblk, nblock, nblock), generator=g, device=dev)
    A /= math.sqrt(nblock)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    xt = torch.randn((nblk, nblock), generator=g, device=dev)
    y = torch.bmm(A, xt.unsqueeze(-1)).reshape(-1).double()
    mine = set(_chunk_ops(list(range(nblk)), world_size())[rank()])
    ops = [MatrixMult(A[i].double()) if i in mine
           else ShapeOnly(nblock, nblock, dtype=torch.float64)
           for i in range(nblk)]
    del A
    return pmtt.MPIBlockDiag(ops), pmtt.DistributedArray.to_dist(y)


def resilience_worker(args):
    """23.5's supervised worker (``chip_smoke.py --resilience-worker
    CKPT OUT MARK DEVICE NBLK NBLOCK``): join the attempt's gloo group
    on the card, run the segmented f64 CGLS with the shards backend from
    its checkpoint, write rank 0's x, leave with ``os._exit`` (a group
    whose peer died would hang its shutdown)."""
    import os
    ckpt, out, mark, device = args[:4]
    nblk, nblock = int(args[4]), int(args[5])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.resilience import elastic
    cfg = elastic.elastic_initialize(backend="gloo", device=device)
    Op, y = resilience_problem(torch, pmtt, torch.device(device), nblk,
                               nblock)

    def on_epoch(info):
        with open(mark, "w") as f:
            f.write(str(info["epoch"]))
        if cfg.attempt == 0:
            time.sleep(SLEEP_23)

    res = pmtt.cgls_segmented(Op, y, niter=SEG_NITER_23, tol=0.0,
                              epoch=SEG_EPOCH_23, checkpoint_path=ckpt,
                              backend="shards", on_epoch=on_epoch)
    x = res.x.asarray()
    if pmtt.parallel.rank() == 0:
        np.save(out, x)
    print(f"worker attempt {cfg.attempt} world {cfg.num_processes or 1}: "
          f"{res.iiter} iterations, {res.epochs} epochs here", flush=True)
    sys.stdout.flush()
    os._exit(0)


def supervised_part(torch, pmtt, here, dev):
    """23.5: ``launch_job`` of two gloo workers sharing the card; worker 0
    SIGSTOPped once its first checkpoint lands; the stale heartbeat
    classified and the job relaunched on a world of one, which resumes
    from the shards checkpoint; x held against the no-group solve."""
    import os
    import shutil
    import signal
    import tempfile
    from pylops_mpi_tpu_torch.resilience.supervisor import launch_job
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sup_")
    out, mark = f"{tmp}/x.npy", f"{tmp}/mark"
    stopped, relaunched = {}, {}

    def on_poll(attempt, workers):
        if attempt == 0 and not stopped and os.path.exists(mark):
            workers[0].proc.send_signal(signal.SIGSTOP)
            stopped["t"] = time.monotonic()

    def on_relaunch(attempt, failure):
        relaunched["t"] = time.monotonic()

    argv = [str(here / "chip_smoke.py"), "--resilience-worker",
            f"{tmp}/carry", out, mark, str(dev), str(NBLK), str(NBLOCK)]
    try:
        t0 = time.monotonic()
        r = launch_job(argv, 2, heartbeat_interval=HB_23, stale_factor=2.0,
                       grace_s=300.0, job_timeout_s=900, on_poll=on_poll,
                       on_relaunch=on_relaunch, logdir=f"{tmp}/logs")
        t_end = time.monotonic()
        if not r.ok:
            raise RuntimeError(f"23.5: the job failed: {r.failures} "
                               f"{r.outputs}")
        x = np.load(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    f = r.failures[0] if r.failures else None
    import re
    m = re.search(r"no heartbeat for ([\d.]+)s", f.detail) if f else None
    age = float(m.group(1)) if m else None
    Op, y = resilience_problem(torch, pmtt, dev, NBLK, NBLOCK)
    ref = pmtt.cgls_segmented(Op, y, niter=SEG_NITER_23, tol=0.0,
                              epoch=SEG_EPOCH_23)
    xr = ref.x.array.cpu().numpy()
    gap = float(np.abs(x - xr).max() / np.abs(xr).max())
    rec = dict(attempts=r.attempts, world_size=r.world_size,
               failure=f.as_dict() if f else None, beat_age_s=age,
               detect_after_stop_s=(relaunched["t"] - stopped["t"]
                                    if stopped and relaunched else None),
               relaunch_wall_s=t_end - relaunched.get("t", t_end),
               job_wall_s=t_end - t0, gap=gap)
    print(f"23.5 launch_job, 2 gloo workers on the card, f64 "
          f"cgls_segmented ({NBLK}x{NBLOCK}^2) with the shards backend: "
          f"worker 0 SIGSTOPped after its first checkpoint; failure "
          f"{rec['failure']}; beat age {age} s (limit {2 * HB_23 + 1} s); "
          f"relaunched at world {r.world_size} in attempt {r.attempts}; "
          f"relaunch wall {rec['relaunch_wall_s']:.2f} s (job "
          f"{rec['job_wall_s']:.2f} s); resumed x against the no-group "
          f"solve {gap:.3e} (limit 1e-6)", flush=True)
    if not (f and f.kind == "stale_heartbeat" and f.slot == 0
            and age is not None and age <= 2 * HB_23 + 1.0
            and r.attempts == 2 and r.world_size == 1 and gap <= 1e-6):
        raise RuntimeError(f"23.5: {rec}")
    del Op, y, ref
    return rec


def guarded_ca_part(torch, pmtt, A, y, dev):
    """23.6: pipelined cgls(normal=True) under a group of one over NCCL,
    and fista_guarded at phase 9's width, each with a NaN: breakdown, x
    the clean solve's of one iteration fewer, bitwise; guard-on over
    guard-off wall of the pipelined engine in pairs."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from pylops_mpi_tpu_torch.ops.local import Conv1D, MatrixMult
    from pylops_mpi_tpu_torch.resilience import faults, status
    out = {}
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(A.shape[0])])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ca23_")
    set_ca("pipelined")
    pmtt.parallel.init(backend="nccl", store=dist.FileStore(f"{tmp}/store", 1),
                       rank=0, world_size=1, device=dev)
    try:
        faults.arm("nan", NAN_AT_23)
        x, iiter, _, _, _, code = pmtt.cgls_guarded(
            Op, y, niter=NITER_CA_23, tol=0.0, normal=True)
        clean = pmtt.cgls_guarded(Op, y, niter=iiter - 1, tol=0.0,
                                  normal=True)[0]
        held = torch.equal(x.array, clean.array)
        walls = {True: [], False: []}
        for i in range(PAIRS_23):
            for g in ((True, False) if i % 2 == 0 else (False, True)):
                t0 = time.perf_counter()
                pmtt.cgls(Op, y, niter=NITER_CA_23, tol=0.0, normal=True,
                          guards=g)
                walls[g].append(_ms_since(torch, t0))
    finally:
        faults.disarm()
        set_ca("off")
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA", None)
        pmtt.parallel.destroy()
        shutil.rmtree(tmp, ignore_errors=True)
    ratios = [a / b for a, b in zip(walls[True], walls[False])]
    out["pipelined_cgls_normal"] = dict(
        status=status.status_name(code), iiter=iiter, x_held=held,
        guard_on_ms=walls[True], guard_off_ms=walls[False],
        on_over_off=ratios)
    print(f"23.6 pipelined cgls(normal=True), group of one over NCCL, NaN at "
          f"{NAN_AT_23}: {status.status_name(code)} at iteration {iiter}, x "
          f"bitwise the clean solve's of {iiter - 1} iterations: {held}; "
          f"{NITER_CA_23} iterations guard on {[round(v, 2) for v in walls[True]]}"
          f" ms, off {[round(v, 2) for v in walls[False]]} ms, on/off "
          f"{[round(v, 4) for v in ratios]}", flush=True)
    if code != status.BREAKDOWN or not held:
        raise RuntimeError(f"23.6 pipelined: {out}")
    del Op
    torch.cuda.empty_cache()
    # fista_guarded on phase 9's cube
    f32 = torch.float32
    dims = (NY_R // NBLK_R, NX_R, NZ_R)
    wav = pmtt.models.ricker(np.arange(21) * 0.004, f0=15)[0]
    Cop = pmtt.MPIBlockDiag([Conv1D(dims, wav, axis=-1, offset=len(wav) // 2,
                                    dtype=f32, device=dev)] * NBLK_R)
    m, _ = reflectivity_model(torch, dev, seed=7)
    d = Cop @ pmtt.DistributedArray.to_dist(m.reshape(-1))
    x0 = d.zeros_like()
    kw = dict(eps=EPS_SPARSE, tol=0.0)
    pmtt.fista(Cop, d, x0=x0, niter=1, **kw)  # the cached step size
    faults.arm("nan", NAN_FISTA_23)
    try:
        x, iiter, _, code = pmtt.solvers.fista_guarded(
            Cop, d, x0, niter=NITER_FISTA_23, **kw)
    finally:
        faults.disarm()
    clean = pmtt.solvers.fista_guarded(Cop, d, x0, niter=iiter - 1, **kw)[0]
    held = torch.equal(x.array, clean.array) and \
        bool(torch.isfinite(x.array).all())
    out["fista"] = dict(status=status.status_name(code), iiter=iiter,
                        x_held=held, shape=[NY_R, NX_R, NZ_R])
    print(f"23.6 fista_guarded ({NY_R}, {NX_R}, {NZ_R}) f32, NaN at "
          f"{NAN_FISTA_23}: {status.status_name(code)} at iteration {iiter}, "
          f"x bitwise the clean solve's of {iiter - 1} iterations: {held}",
          flush=True)
    if code != status.BREAKDOWN or not held:
        raise RuntimeError(f"23.6 fista: {out}")
    del Cop, d, x0, m
    torch.cuda.empty_cache()
    return out


def resilience_phase(torch, pmtt, kernels, here, dev):
    """Phase 23: the resilience tier at phase 3's width (23.1-23.6)."""
    from pylops_mpi_tpu_torch.aot import graphs
    from pylops_mpi_tpu_torch.resilience import faults
    nk = kernels[0]
    A, xtrue, y_t = make_problem(torch, dev)
    y = pmtt.DistributedArray.to_dist(y_t)
    res = {}
    t = time.perf_counter()
    res["resilient_eager"], _, x_eager = resilient_part(
        torch, pmtt, nk, A, xtrue, y, aot=False)
    torch.cuda.empty_cache()
    graphs.reset_capture_count()
    res["resilient_graphs"], ops, x_graph = resilient_part(
        torch, pmtt, nk, A, xtrue, y, aot=True)
    # a clean solve of the poisoned bf16 loop's key, but for the fault:
    # it must capture anew and equal the eager clean solve bitwise
    bf16 = ops["None"]
    faults.disarm()
    set_aot(True)
    try:
        before = graphs.capture_count()
        xc = pmtt.cgls_guarded(bf16, y, niter=NITER_23, tol=0.0,
                               normal=True)[0].array.clone()
        captured = graphs.capture_count() - before
    finally:
        set_aot(False)
    xe = pmtt.cgls_guarded(bf16, y, niter=NITER_23, tol=0.0,
                           normal=True)[0].array
    clean_same = torch.equal(xc, xe)
    graph_same = torch.equal(x_graph, x_eager)
    res["resilient_graphs"].update(clean_captures=captured,
                                   clean_bitwise_eager=clean_same,
                                   bitwise_eager_resilient=graph_same,
                                   bank=graphs.stats())
    print(f"23.2 clean bf16 guarded solve of the poisoned key: "
          f"{captured} new captures, bitwise the eager clean solve: "
          f"{clean_same}; the banked resilient_solve bitwise the eager one: "
          f"{graph_same}; bank stats {graphs.stats()}", flush=True)
    if captured < 1 or not clean_same or not graph_same:
        raise RuntimeError("23.2: the clean solve replayed the poisoned graph "
                           "or differs from the eager one")
    del ops, bf16, xc, xe
    pmtt.aot.store.clear_memory()
    torch.cuda.empty_cache()
    res["refined"] = refined_part(torch, pmtt, nk, A, y)
    torch.cuda.empty_cache()
    res["segmented"] = segmented_part(torch, pmtt, A, y)
    torch.cuda.empty_cache()
    res["guarded_ca"] = guarded_ca_part(torch, pmtt, A, y, dev)
    del A, xtrue, y_t, y
    torch.cuda.empty_cache()
    res["supervised"] = supervised_part(torch, pmtt, here, dev)
    res["wall_s"] = time.perf_counter() - t
    return res


# ------------------------------------------------------------ phase 24
# 24.2: examples/autodiff.py's objective at slice 1's width, gradient
# descent by torch.autograd (the step is stable below 2/||AᵀA + 0.1DᵀD||,
# ~0.055 for blocks randn/sqrt(n) + 4I); autograd against the hand-written
# gradient, and two gloo ranks against one, as relative norms (f32)
STEPS_24, LR_24, GRAD_TOL_24, RANKS_TOL_24 = 20, 0.02, 1e-5, 1e-5
# 24.3: the learned regularizer at slice 2's full width in f64: damp 0.1
# and 100 iterations converge the stacked system (the implicit gradient
# met the finite difference to 6e-7 at (64, 1024) on the CPU); central
# difference step, the bound 1e-3 of |fd| (examples/learned_regularization
# .py:74 bounds by 1e-3·max(1, |fd|), which at this |fd| of ~2e-2 would
# let a gradient 5% off pass), 5 Adam steps
EPS_24, DAMP_24, NITER_24, NOISE_24 = 0.1, 0.1, 100, 0.02
FD_H_24, FD_TOL_24, ADAM_STEPS_24, ADAM_LR_24 = 1e-4, 1e-3, 5, 0.01
TRAJ_TOL_24 = 1e-12   # eager and graph-bank fit, loss by loss
# 24.4: a family of 4 members built from slice 1's blocks (A + s I)
SHIFTS_24, NITER_B24, LANE_TOL_24 = (0.0, 0.5, 1.0, 1.5), 30, 1e-4
# 24.5: phase 21.2's families on two gloo ranks sharing the card
REQ_24, THREADS_24, WINDOW_24, GAP_24, BUCKETS_24 = 32, 4, 0.005, 1e-6, \
    (1, 2, 4, 8, 16)


def card_name() -> str:
    """``name, power.limit`` of the card, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def tap_grad_part(torch, sk, dev, g, card):
    """24.1: the tap kernel's autograd rule at slice 2's shape against
    autograd through the plain version (f32, bf16; a ghost tensor on top,
    zero rows below, out_pad rows), and the backward launch's times: the
    kernel on the transposed taps, the plain version, one cuDNN
    ``conv_transpose2d`` and the byte bound."""
    import torch.nn.functional as F
    tp, w = TAP_SETS["first_centered3"]
    taps = sorted(tp.items())
    flipped = [(-d, c) for d, c in taps]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        slab = torch.randn((NX, NT0), generator=g, device=dev).to(dt)
        top = torch.randn((w, NT0), generator=g, device=dev).to(dt)
        slab.requires_grad_(True)
        top.requires_grad_(True)
        y = sk.stencil_taps(slab, taps, w, (1, 1), top=top, bottom=w)
        gy = torch.randn(tuple(y.shape), generator=g, device=dev).to(dt)
        got = torch.autograd.grad(y, (slab, top), gy)
        yp = sk.stencil_taps_plain(slab, taps, w, (1, 1), top=top, bottom=w)
        want = torch.autograd.grad(yp, (slab, top), gy)
        torch.cuda.synchronize()
        err = max(max_rel_err(a, b) for a, b in zip(got, want))
        abs_err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            raise RuntimeError(f"24.1 {name}: non-finite gradient")
        ok = err <= STENCIL_TOL[name]
        print(f"24.1 tap rule's gradient vs autograd through the plain "
              f"version {name} ({NX}, {NT0}), ghost on top: max rel err "
              f"{err:.3e} (tol {STENCIL_TOL[name]:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"24.1 stencil backward[{name}]: {err:.3e}")
        core = gy[1:1 + NX].contiguous()
        weight = torch.zeros((1, 1, 2 * w + 1, 1), dtype=dt, device=dev)
        for d, c in taps:
            weight[0, 0, w + d, 0] = c

        def kernel():
            return sk._launch(core, flipped, w, (0, 0), 2 * w, 2 * w,
                              backward=True)

        def library():
            return F.conv_transpose2d(core.view(1, 1, NX, NT0), weight)

        lib_err = max_rel_err(library().view(NX + 2 * w, NT0), kernel())
        kms = cuda_ms(kernel)
        pms = cuda_ms(lambda: sk.stencil_taps_plain(core, flipped, w,
                                                    top=2 * w, bottom=2 * w))
        lms = cuda_ms(library)
        item = core.element_size()
        t_bytes = (NX + NX + 2 * w) * NT0 * item / HBM_BYTES_PER_S * 1e3
        t_ops = (2.0 * len(taps) * (NX + 2 * w) * NT0
                 / (F32_OPS_PER_S / (2 if item == 8 else 1)) * 1e3)
        bms, bby = ((t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations"))
        out[name] = dict(max_err=err, max_abs_err=abs_err,
                         tol=STENCIL_TOL[name], ms=kms, plain_ms=pms,
                         library_ms=lms, library_max_err=lib_err,
                         bound_ms=bms, bound_by=bby,
                         shape=[NX, NT0], taps="first_centered3 transposed")
        print(f"  backward launch {name} ({NX} -> {NX + 2 * w}, {NT0}) on "
              f"{card}: kernel {kms:.4f} ms, plain {pms:.4f} ms, library "
              f"(conv_transpose2d) {lms:.4f} ms (agrees to {lib_err:.1e}), "
              f"bound {bms:.4f} ms ({bby})", flush=True)
        del slab, top, y, gy, got, yp, want, core
        torch.cuda.empty_cache()
    return out


def ad24_objective(torch, pmtt, dev):
    """24.2: ``examples/autodiff.py``'s objective ``0.5||Ax − y||² +
    0.05||Dx||²`` on slice 1's blocks with the axis-0 first derivative of
    the whole N-vector, ``STEPS_24`` steps of gradient descent by
    ``torch.autograd``; each gradient against the hand-written ``Aᵀ(Ax −
    y) + 0.1·DᵀD x`` (``rmatvec``). Returns this rank's shards of the
    gradients and of the last x, the gaps, the objectives and the wall."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    D = pmtt.DistributedArray
    A, _, y_t = make_problem(torch, dev)
    Aop = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    N = NBLK * NBLOCK
    Dop = pmtt.MPIFirstDerivative((N,), dtype=torch.float32)
    r0 = pmtt.parallel.rank()
    lo = sum(s[0] for s in Aop.local_shapes_n[:r0])
    dy = D.to_dist(y_t, local_shapes=Aop.local_shapes_n)
    del y_t

    def objective(x):
        r = Aop.matvec(x) - dy
        d = Dop.matvec(x)
        return 0.5 * r.dot(r) + 0.05 * d.dot(d)

    x = D.to_dist(torch.zeros(N, device=dev), local_shapes=Aop.local_shapes_m)
    grads, gaps, objs = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS_24):
        x.array.requires_grad_(True)
        obj = objective(x)
        (gr,) = torch.autograd.grad(obj, x.array)
        with torch.no_grad():
            xx = D._wrap(x.array.detach(), x)
            hand = (Aop.rmatvec(Aop.matvec(xx) - dy).array
                    + 0.1 * Dop.rmatvec(Dop.matvec(xx)).array)
            num = torch.linalg.vector_norm((gr - hand).double()) ** 2
            den = torch.linalg.vector_norm(hand.double()) ** 2
            num, den = (pmtt.parallel.collectives.all_reduce(v.reshape(1))
                        for v in (num, den))
        gaps.append(float(torch.sqrt(num / den)))
        grads.append(gr.detach().cpu().numpy())
        objs.append(float(obj.detach()))
        x = D._wrap((x.array - LR_24 * gr).detach(), x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(grads=grads, x=x.array.cpu().numpy(), gaps=gaps, objs=objs,
                wall_s=wall, offset=lo)


def _ad24_rank(torch, pmtt, dev):
    """A gloo rank of 24.2: the objective's gradients over the group,
    with this rank's stencil launches (forward and backward) and ghost
    exchanges (forward and adjoint)."""
    from pylops_mpi_tpu_torch.ops import stencil_kernels as sk
    from pylops_mpi_tpu_torch.parallel import collectives as co
    sk.reset_launches()
    co.reset_counts()
    out = ad24_objective(torch, pmtt, dev)
    out.update(rank=pmtt.parallel.rank(), launches=sk.launches,
               launches_bwd=sk.launches_bwd,
               halo=co.counts["halo_exchange"],
               halo_adjoint=co.counts["halo_exchange_adjoint"])
    return out


def learned_reg_part(torch, pmtt, dev, card):
    """24.3: ``examples/learned_regularization.py``'s seam at slice 2's
    full width in f64: ``cgls_solve`` on ``[Op; ε·MPIGradient]`` (ε a 0-d
    tensor on the card), the implicit gradient of a model loss against a
    central finite difference, then ``fit`` (Adam, in place) eagerly and
    through the graph bank, whose loss trajectories must agree."""
    import os
    from pylops_mpi_tpu_torch.aot import graphs, store
    from pylops_mpi_tpu_torch.autodiff import cgls_solve, fit
    f64 = torch.float64
    D = pmtt.DistributedArray
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=24)
    Op = pmtt.models.MPIPoststackLinearModelling(wav, NT0, NX, dtype=f64,
                                                 device=dev)
    G = pmtt.MPIGradient((NX, NT0), dtype=f64)
    d = Op.matvec(D.to_dist(m.reshape(-1), local_shapes=Op.local_shapes_m))
    gn = torch.Generator(device=dev).manual_seed(2424)
    noise = torch.randn(d.array.shape, generator=gn, device=dev, dtype=f64)
    d = D._wrap(d.array + NOISE_24 * torch.linalg.vector_norm(d.array)
                / math.sqrt(d.array.numel()) * noise, d)
    zero = pmtt.StackedDistributedArray([
        D(global_shape=NX * NT0, local_shapes=G.local_shapes_m, dtype=f64,
          device=dev) for _ in range(2)])
    y = pmtt.StackedDistributedArray([d, zero])
    target = (m - m.mean(dim=1, keepdim=True)).reshape(-1)
    tn = torch.sum(target ** 2)
    del m, noise
    eps = torch.tensor(EPS_24, dtype=f64, device=dev, requires_grad=True)
    S = pmtt.MPIStackedVStack([Op, eps * G])

    def loss(params=None):
        x = cgls_solve(S, y, niter=NITER_24, damp=DAMP_24, tol=0.0)
        return torch.sum((x.array - target) ** 2) / tn

    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L = loss()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (gr,) = torch.autograd.grad(L, eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        eps.add_(FD_H_24)
        lp = float(loss())
        eps.sub_(2 * FD_H_24)
        lm = float(loss())
        eps.fill_(EPS_24)
    fd = (lp - lm) / (2 * FD_H_24)
    gv = float(gr)
    gap = abs(gv - fd)
    out.update(loss=float(L.detach()), grad=gv, fd=fd, fd_h=FD_H_24,
               gap_rel=gap / abs(fd), forward_s=t1 - t0,
               backward_s=t2 - t1, niter=NITER_24, damp=DAMP_24, eps=EPS_24)
    print(f"24.3 learned regularizer ({NX}, {NT0}) f64, cgls_solve niter "
          f"{NITER_24}, damp {DAMP_24}, eps {EPS_24} on the card: loss "
          f"{float(L.detach()):.9e}, implicit dL/deps {gv:+.9e}, central difference "
          f"(h {FD_H_24:.0e}) {fd:+.9e}, gap {gap:.3e} = {gap / abs(fd):.3e} "
          f"of |fd| (limit {FD_TOL_24:.0e} of |fd|); wall on {card}: "
          f"forward "
          f"solve {1e3 * (t1 - t0):.1f} ms, backward solve "
          f"{1e3 * (t2 - t1):.1f} ms", flush=True)
    if not gap <= FD_TOL_24 * abs(fd):
        raise RuntimeError(f"24.3: implicit gradient {gv} vs finite "
                           f"difference {fd}")
    trajectories = {}
    before = os.environ.get("PYLOPS_MPI_TPU_TORCH_AOT")
    try:
        for label, aot in (("eager", "off"), ("graphs", "on")):
            os.environ["PYLOPS_MPI_TPU_TORCH_AOT"] = aot
            with torch.no_grad():
                eps.fill_(EPS_24)
            graphs.reset_capture_count()
            s0 = dict(graphs.stats())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, losses = fit(loss, [eps], steps=ADAM_STEPS_24, lr=ADAM_LR_24)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s1 = graphs.stats()
            trajectories[label] = dict(
                losses=losses.tolist(), eps=float(eps.detach()), wall_s=wall,
                captures=graphs.capture_count(),
                replays=s1.get("replays", 0) - s0.get("replays", 0))
            print(f"24.3 fit, {ADAM_STEPS_24} Adam steps (lr {ADAM_LR_24}, "
                  f"eps updated in place) with PYLOPS_MPI_TPU_TORCH_AOT={aot}:"
                  f" losses {losses.tolist()}, eps -> {float(eps.detach()):.9f}"
                  f", {wall:.2f} s on {card}, captures {graphs.capture_count()}, replays "
                  f"{trajectories[label]['replays']}", flush=True)
            if not losses[-1] < losses[0]:
                raise RuntimeError(f"24.3 fit ({label}): the loss did not "
                                   f"fall: {losses}")
    finally:
        if before is None:
            os.environ.pop("PYLOPS_MPI_TPU_TORCH_AOT", None)
        else:
            os.environ["PYLOPS_MPI_TPU_TORCH_AOT"] = before
        store.clear_memory()
    le = np.asarray(trajectories["eager"]["losses"])
    lg = np.asarray(trajectories["graphs"]["losses"])
    traj = float(np.max(np.abs(le - lg) / np.abs(le)))
    out.update(fit=trajectories, trajectory_gap=traj,
               trajectory_bitwise=bool(np.array_equal(le, lg)))
    print(f"24.3 eager vs graph-bank trajectories: max rel gap {traj:.3e} "
          f"(limit {TRAJ_TOL_24:.0e}), bitwise {np.array_equal(le, lg)}",
          flush=True)
    if not traj <= TRAJ_TOL_24 or trajectories["graphs"]["captures"] < 1:
        raise RuntimeError("24.3: the graph bank's fit left the eager one "
                           f"({traj}) or captured nothing")
    del S, Op, G, y, d, target
    torch.cuda.empty_cache()
    return out


def batched_part(torch, pmtt, dev, card):
    """24.4: ``batched_solve`` of a family of MPIBlockDiag members built
    from slice 1's blocks (``A + s I``, exact data of one model), CGLS f32
    ``NITER_B24`` iterations, each lane against its own ``cgls``; the
    second call must hit the family cache; its wall against the members'
    sequential solves."""
    import os
    from pylops_mpi_tpu_torch.diagnostics import metrics
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.solvers import block as blk
    D = pmtt.DistributedArray
    A, xtrue, _ = make_problem(torch, dev)
    ops, ys = [], []
    for s in SHIFTS_24:
        As = A.clone()
        As.diagonal(dim1=1, dim2=2).add_(s)
        ops.append(pmtt.MPIBlockDiag([MatrixMult(As[i]) for i in range(NBLK)]))
        ys.append(ops[-1].matvec(D.to_dist(xtrue)))
        del As
    del A
    torch.cuda.empty_cache()
    idx = list(range(len(SHIFTS_24)))
    before = os.environ.get("PYLOPS_MPI_TPU_TORCH_METRICS")
    os.environ["PYLOPS_MPI_TPU_TORCH_METRICS"] = "on"
    try:
        metrics.clear_metrics()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = blk.batched_solve(lambda b: ops[b], idx, ys, solver="cgls",
                                    niter=NITER_B24, tol=0.0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        c = metrics.snapshot()["counters"]
    finally:
        if before is None:
            os.environ.pop("PYLOPS_MPI_TPU_TORCH_METRICS", None)
        else:
            os.environ["PYLOPS_MPI_TPU_TORCH_METRICS"] = before
        metrics.clear_metrics()
    info = blk.batched_cache_info()
    hit, miss = c.get("solver.batched.cache.hit", 0), \
        c.get("solver.batched.cache.miss", 0)
    pmtt.cgls(ops[0], ys[0], niter=2, tol=0.0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [pmtt.cgls(op, yv, niter=NITER_B24, tol=0.0)[0].array
            for op, yv in zip(ops, ys)]
    torch.cuda.synchronize()
    seq = time.perf_counter() - t0
    gaps = [rel_norm(res.xs[b].array, solo[b]) for b in idx]
    errs = [rel_norm(res.xs[b].array, xtrue) for b in idx]
    out = dict(members=len(idx), niter=NITER_B24, lane_gaps=gaps,
               lane_rel_err=errs, iiter=res.iiter.tolist(),
               walls_s=walls, sequential_s=seq, speedup=seq / walls[1],
               cache=dict(hit=hit, miss=miss, **info))
    print(f"24.4 batched_solve of {len(idx)} MPIBlockDiag members "
          f"({NBLK} x {NBLOCK}^2 f32, shifts {SHIFTS_24}), cgls "
          f"{NITER_B24} iterations: lanes vs their own cgls {gaps} (limit "
          f"{LANE_TOL_24:.0e}), rel err to the model {errs}; cache hit "
          f"{hit}, miss {miss}, {info}; wall on {card} {walls[0]:.3f} s "
          f"(first), "
          f"{walls[1]:.3f} s (cached) against {seq:.3f} s for "
          f"{len(idx)} sequential cgls ({seq / walls[1]:.2f}x)", flush=True)
    if max(gaps) > LANE_TOL_24 or hit != 1 or miss != 1:
        raise RuntimeError(f"24.4: lanes {gaps}, cache hit {hit} miss {miss}")
    del ops, ys, res, solo
    blk._BATCHED_CACHE.clear()
    torch.cuda.empty_cache()
    return out


def daemon24_pool(torch, pmtt, dev, log=None):
    """Phase 21's two families on phase 3's blocks (each rank of a group
    its chunk), the pool's packed solves recorded in ``log``."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    sv = pmtt.serving
    A, _, _ = make_problem(torch, dev)
    G = torch.bmm(A.transpose(1, 2), A)
    G.diagonal(dim1=1, dim2=2).add_(1.0)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    S = pmtt.MPIBlockDiag([MatrixMult(G[i]) for i in range(NBLK)])
    del A, G
    torch.cuda.empty_cache()
    pool = sv.WarmPool(buckets=BUCKETS_24)
    pool.register(sv.FamilySpec("cgls", Op, solver="cgls", niter=NITER_21))
    pool.register(sv.FamilySpec("cg", S, solver="cg", niter=NITER_CG_21,
                                tol=TOL_CG_21))
    if log is not None:
        real = pool.solve

        def spy(name, Y):
            res = real(name, Y)
            log.append((name, np.array(Y, copy=True), res.x))
            return res

        pool.solve = spy
    return pool


def daemon24_requests():
    rng = np.random.default_rng(2450)
    N = NBLK * NBLOCK
    return [("cgls" if j % 4 else "cg",
             rng.standard_normal(N).astype(np.float32))
            for j in range(REQ_24)]


def daemon24_serve(torch, pmtt, pool):
    """Rank 0 (or one process): ``REQ_24`` requests from ``THREADS_24``
    threads through ``SolveDaemon``; the results in request order and
    the stats."""
    import threading
    reqs = daemon24_requests()
    d = pmtt.serving.SolveDaemon(pool, window_s=WINDOW_24).start()
    results = [None] * len(reqs)

    def client(t):
        for j in range(t, len(reqs), THREADS_24):
            fam, y = reqs[j]
            results[j] = d.submit(fam, y).wait(timeout=600)["x"]

    ths = [threading.Thread(target=client, args=(t,))
           for t in range(THREADS_24)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    st = d.stats()
    if not d.drain(timeout=120) or any(r is None for r in results):
        raise RuntimeError("24.5: the daemon did not resolve every request")
    st["wall_s"] = wall
    return results, st


def _daemon24_rank(torch, pmtt, dev):
    """A gloo rank of 24.5: rank 0 serves, rank 1 follows; then every
    batch the rank solved again by ``block_cgls``/``block_cg`` over the
    same group."""
    from pylops_mpi_tpu_torch.solvers.block import block_cg, block_cgls
    r = pmtt.parallel.rank()
    log = []
    pool = daemon24_pool(torch, pmtt, dev, log)
    out = dict(rank=r)
    if r == 0:
        out["results"], out["stats"] = daemon24_serve(torch, pmtt, pool)
    else:
        out["followed"] = pmtt.serving.SolveDaemon(pool).follow()
    gaps = []
    for name, Y, x in log:
        spec = pool.family(name)
        k = Y.shape[1]
        bucket = min(b for b in BUCKETS_24 if b >= k)
        Yp = np.concatenate([Y, np.zeros((Y.shape[0], bucket - k),
                                         Y.dtype)], axis=1)
        yb = pmtt.DistributedArray.to_dist(
            Yp, local_shapes=[(s[0], bucket)
                              for s in spec.operator.local_shapes_n],
            device=dev)
        if spec.solver == "cg":
            xb = block_cg(spec.operator, yb, niter=spec.niter,
                          tol=spec.tol)[0]
        else:
            xb = block_cgls(spec.operator, yb, niter=spec.niter,
                            tol=spec.tol)[0]
        gaps.append(float(np.abs(xb.asarray()[:, :k] - x).max()
                          / np.abs(x).max()))
    out["batches"] = [(name, Y.shape[1]) for name, Y, _ in log]
    out["batch_gaps"] = gaps
    return out


def daemon_group_part(torch, pmtt, here, dev, card):
    """24.5: the daemon over two gloo ranks sharing the card against the
    one-process daemon here, on phase 21.2's families."""
    pool = daemon24_pool(torch, pmtt, dev)
    one, one_st = daemon24_serve(torch, pmtt, pool)
    del pool
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r0, r1 = spawn_shared_card(2, here, _daemon24_rank)
    secs = time.perf_counter() - t0
    gaps = [_gap(a, b) for a, b in zip(r0["results"], one)]
    bgap = max(r0["batch_gaps"] + r1["batch_gaps"])
    out = dict(requests=REQ_24, threads=THREADS_24, one_process=one_st,
               rank0_stats=r0["stats"], followed=r1["followed"],
               batches=r0["batches"], max_gap=max(gaps),
               max_batch_gap=bgap, seconds=secs)
    print(f"24.5 SolveDaemon over 2 gloo ranks sharing the card, {REQ_24} "
          f"requests from {THREADS_24} threads on phase 21.2's families: "
          f"results vs the one-process daemon max rel gap {max(gaps):.3e} "
          f"(limit {GAP_24:.0e}); every batch vs block_cgls/block_cg over "
          f"the group max rel gap {bgap:.3e}; rank 1 followed "
          f"{r1['followed']} batches (rank 0 formed {r0['stats']['batches']});"
          f" rank 0 stats {r0['stats']}; one-process stats {one_st} (on "
          f"{card}); {secs:.1f} s with the spawn", flush=True)
    if (max(gaps) > GAP_24 or bgap > GAP_24
            or r1["followed"] != r0["stats"]["batches"]
            or r0["batches"] != r1["batches"]):
        raise RuntimeError("24.5: the daemon over the group disagrees")
    return out


def autodiff_phase(torch, pmtt, kernels, here, dev):
    """Phase 24 (module docstring): the training path. 24.2 is its main
    path: the tap kernel's counts are set to 0 just before it and read
    just after."""
    nk, sk = kernels
    card = card_name() if dev.type == "cuda" else "cpu"
    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(24)
    t = time.perf_counter()
    out["tap_grad"] = tap_grad_part(torch, sk, dev, g, card)
    print(f"24.1 in {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    sk.reset_launches()
    nk.reset_launches()
    one = ad24_objective(torch, pmtt, dev)
    launches, launches_bwd = sk.launches, sk.launches_bwd
    if nk.launches:
        raise RuntimeError("24.2 launched the normal kernel")
    if launches_bwd != STEPS_24 or launches != 3 * STEPS_24:
        raise RuntimeError(f"24.2: {launches} forward and {launches_bwd} "
                           f"backward stencil launches in {STEPS_24} steps")
    worst = max(one["gaps"])
    print(f"24.2 examples/autodiff.py's objective, {NBLK} x {NBLOCK}^2 f32 "
          f"+ MPIFirstDerivative over {NBLK * NBLOCK}, {STEPS_24} steps of "
          f"gradient descent (lr {LR_24}) by torch.autograd: objective "
          f"{one['objs'][0]:.6e} -> {one['objs'][-1]:.6e}; each gradient vs "
          f"the hand-written one max rel gap {worst:.3e} (limit "
          f"{GRAD_TOL_24:.0e}); stencil launches {launches} forward, "
          f"{launches_bwd} backward; {one['wall_s']:.3f} s on {card}",
          flush=True)
    if worst > GRAD_TOL_24 or not one["objs"][-1] < one["objs"][0]:
        raise RuntimeError(f"24.2: gradient gap {worst} or no descent")
    ranks = spawn_shared_card(2, here, _ad24_rank)
    rgaps = []
    for step in range(STEPS_24):
        got = np.concatenate([o["grads"][step] for o in ranks])
        rgaps.append(float(np.linalg.norm(got - one["grads"][step])
                           / np.linalg.norm(one["grads"][step])))
    xgap = float(np.linalg.norm(np.concatenate([o["x"] for o in ranks])
                                - one["x"]) / np.linalg.norm(one["x"]))
    out["objective"] = dict(
        steps=STEPS_24, lr=LR_24, objs=one["objs"], max_grad_gap=worst,
        wall_s=one["wall_s"], launches=launches, launches_bwd=launches_bwd,
        two_ranks=dict(max_grad_gap=max(rgaps), x_gap=xgap,
                       launches=[o["launches"] for o in ranks],
                       launches_bwd=[o["launches_bwd"] for o in ranks],
                       halo=[o["halo"] for o in ranks],
                       halo_adjoint=[o["halo_adjoint"] for o in ranks],
                       hand_gap=max(max(o["gaps"]) for o in ranks)))
    print(f"24.2 on 2 gloo ranks sharing the card: gradients vs one rank "
          f"max rel gap {max(rgaps):.3e} (limit {RANKS_TOL_24:.0e}), last x "
          f"{xgap:.3e}; per rank stencil launches "
          f"{out['objective']['two_ranks']['launches']} forward, "
          f"{out['objective']['two_ranks']['launches_bwd']} backward, ghost "
          f"exchanges {out['objective']['two_ranks']['halo']}, their "
          f"adjoints {out['objective']['two_ranks']['halo_adjoint']}; "
          f"{time.perf_counter() - t:.1f} s for 24.2", flush=True)
    if max(rgaps) > RANKS_TOL_24 or any(
            o["launches_bwd"] != STEPS_24 or o["halo_adjoint"] != STEPS_24
            for o in ranks):
        raise RuntimeError("24.2: the two-rank gradients disagree or missed "
                           "the kernel's backward or the exchange's adjoint")
    del one, ranks
    torch.cuda.empty_cache()

    t = time.perf_counter()
    out["learned_regularizer"] = learned_reg_part(torch, pmtt, dev, card)
    print(f"24.3 in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["batched"] = batched_part(torch, pmtt, dev, card)
    print(f"24.4 in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["daemon_group"] = daemon_group_part(torch, pmtt, here, dev, card)
    print(f"24.5 in {time.perf_counter() - t:.1f} s", flush=True)
    return out


# phase 25 (slice 14): the cost model and the tuner at the main path's
# width. The tuner's CLI races the normal kernel against the two sweeps
# at slice 1's 32 blocks of 4096^2 (its --main-path shapes), each storage
# into a cache file of its own (the key carries the operator's dtype);
# SUMMA at phase 17's (32768, 16384, 64) f32 under TUNE=auto; the cost
# model against the card (no share of the roofline above SHARE_25 for
# the block-diagonal and Gradient applies); CA=auto; telemetry; two gloo
# ranks' traces aggregated
NITER_25, PAIRS_25, XTOL_25, SHARE_25 = 50, 4, 1e-6, 1.05
NITER_AGG_25, LATE_25, REPS_25 = 10, 0.25, 20
TUNE_ARGS_25 = ["--main-path"]  # the CLI's widths (a rehearsal: --quick)
_TUNE_KNOBS = ("TUNE", "TUNE_CACHE", "TUNE_BUDGET", "TUNE_TOPK",
               "TUNE_MARGIN", "TRACE", "TELEMETRY", "CA", "AOT",
               "REDUCE_STALL")


def set_knob(name, value):
    """``PYLOPS_MPI_TPU_TORCH_<name>`` set (``None``: unset)."""
    import os
    key = "PYLOPS_MPI_TPU_TORCH_" + name
    if value is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = str(value)


def tune_cli(here, dev, storage, out):
    """``python -m pylops_mpi_tpu_torch.tuning --family blockdiag`` at
    the main path's width with ``storage``, banked into ``out``: its JSON
    summary (the last line of its output)."""
    import os
    env = {k: v for k, v in os.environ.items()
           if not any(k == "PYLOPS_MPI_TPU_TORCH_" + n for n in _TUNE_KNOBS)}
    cmd = [sys.executable, "-m", "pylops_mpi_tpu_torch.tuning", "--family",
           "blockdiag", *TUNE_ARGS_25, "--storage", storage, "--device",
           dev.type, "--out", out]
    r = subprocess.run(cmd, cwd=str(here), env=env, capture_output=True,
                       text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"25.1: the tuner's CLI failed ({r.returncode}):"
                           f" {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _events(trace, name):
    return [e for e in trace.get_events() if e["name"] == name]


def _tuned_op(torch, pmtt, A, cdt):
    """The main path's operator built under the current knobs, and the
    tuning events its construction recorded."""
    from pylops_mpi_tpu_torch.diagnostics import trace
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.tuning import cache as tcache
    tcache.clear_memory()  # read the plan from the file
    set_knob("TRACE", "spans")
    trace.clear_events()
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(A.shape[0])],
                           compute_dtype=cdt)
    ev = dict(trials=len(_events(trace, "tuning.trial")),
              plans=[e["args"] for e in _events(trace, "tuning.plan")])
    set_knob("TRACE", None)
    trace.clear_events()
    return Op, ev


def tuner_race_part(torch, pmtt, nk, here, dev, tmp):
    """25.1 (module docstring): the CLI's race in both storages, the
    replay with no trial, the tuned solve through the kernel bitwise the
    untuned one, and a banked two-sweep plan that keeps the kernel out."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.tuning import cache as tcache
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    A, xtrue, y_t = make_problem(torch, dev)
    y = pmtt.DistributedArray.to_dist(y_t)
    out = {}
    for storage, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        name = "float32" if cdt is None else "bfloat16"
        path = f"{tmp}/plans_{storage}.json"
        t0 = time.perf_counter()
        summary = tune_cli(here, dev, storage, path)
        cli_s = time.perf_counter() - t0
        plan = summary["plans"][0]
        trials = {t["params"]["normal_path"]: t
                  for t in plan.get("trials", ())}
        if set(trials) != {"fused", "two_sweep"} or not all(
                t["ok"] for t in trials.values()):
            raise RuntimeError(f"25.1 {storage}: a trial failed: {plan}")
        ratio = trials["two_sweep"]["best_s"] / trials["fused"]["best_s"]
        print(f"25.1 tuner CLI, blockdiag {storage} storage: key "
              f"{plan['key']}; trials best_s fused "
              f"{trials['fused']['best_s'] * 1e3:.4f} ms (warm-up "
              f"{trials['fused']['compile_s'] * 1e3:.1f} ms), two_sweep "
              f"{trials['two_sweep']['best_s'] * 1e3:.4f} ms (warm-up "
              f"{trials['two_sweep']['compile_s'] * 1e3:.1f} ms): two_sweep "
              f"/ fused {ratio:.3f}; banked {plan['params']} "
              f"[{plan['provenance']}]; CLI {cli_s:.1f} s", flush=True)
        if plan["params"] != {"normal_path": "fused"}:
            raise RuntimeError(f"25.1 {storage}: the tuner banked "
                               f"{plan['params']}, not the kernel")
        # the untuned solve (tuning off: nothing consulted)
        set_knob("TUNE", None)
        Op0 = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)],
                                compute_dtype=cdt)
        x_off = pmtt.cgls(Op0, y, niter=NITER_25, tol=0.0,
                          normal=True)[0].array.clone()
        del Op0
        # the replay: the constructor reads the banked plan, no trial
        set_knob("TUNE", "on")
        set_knob("TUNE_CACHE", path)
        Op, ev = _tuned_op(torch, pmtt, A, cdt)
        prov = ev["plans"][-1] if ev["plans"] else {}
        if ev["trials"] or prov.get("provenance") != "tuned" \
                or not prov.get("replay") or Op._normal_path != "fused":
            raise RuntimeError(f"25.1 {storage}: the replay ran {ev}")
        nk.reset_launches()
        t0 = time.perf_counter()
        x, _, iiter, _, _, _ = pmtt.cgls(Op, y, niter=NITER_25, tol=0.0,
                                         normal=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nk.launches
        xt = x.array.clone()
        bitwise = torch.equal(xt, x_off)
        err = rel_norm(xt, xtrue)
        if storage == "f32":
            out["x10"] = pmtt.cgls(Op, y, niter=NITER_AGG_25, tol=0.0,
                                   normal=True)[0].array.clone()
        del Op, x
        # a banked two_sweep plan for the same key keeps the kernel out
        path2 = f"{tmp}/two_sweep_{storage}.json"
        tcache.store(prov["key"], {"params": {"normal_path": "two_sweep"},
                                   "provenance": "tuned"}, path=path2)
        set_knob("TUNE_CACHE", path2)
        Op2, ev2 = _tuned_op(torch, pmtt, A, cdt)
        nk.reset_launches()
        x2 = pmtt.cgls(Op2, y, niter=NITER_25, tol=0.0,
                       normal=True)[0].array.clone()
        torch.cuda.synchronize()
        launches2, gap2 = nk.launches, rel_norm(x2, xt)
        path_two = Op2._normal_path
        del Op2
        set_knob("TUNE", None)
        set_knob("TUNE_CACHE", None)
        tcache.clear_memory()
        tplan.reset_applied()
        out[storage] = dict(
            key=plan["key"], cli_s=cli_s, trials={
                k: {f: t.get(f) for f in ("best_s", "mean_s", "compile_s")}
                for k, t in trials.items()},
            two_sweep_over_fused=ratio, banked=plan["params"],
            replay_trials=ev["trials"], replay=prov, iiter=iiter,
            launches=launches, bitwise_untuned=bitwise, rel_err=err,
            iters_per_s=iiter / wall, two_sweep_path=path_two,
            two_sweep_launches=launches2, two_sweep_gap=gap2,
            two_sweep_trials=ev2["trials"], dtype=name)
        print(f"25.1 {storage}: TUNE=on replays {prov.get('params')} "
              f"[{prov.get('provenance')}] with {ev['trials']} trials; "
              f"{NITER_25}-iteration cgls(normal=True) launches the kernel "
              f"{launches} times ({iiter} iterations, {iiter / wall:.1f} "
              f"iters/s), x {'bitwise' if bitwise else 'NOT bitwise'} the "
              f"untuned solve's, rel_err {err:.3e}; a banked two_sweep "
              f"plan: path {path_two}, {launches2} launches, x within "
              f"{gap2:.3e} (limit {XTOL_25:.0e})", flush=True)
        if launches != iiter or iiter != NITER_25 or not bitwise:
            raise RuntimeError(f"25.1 {storage}: tuned solve {out[storage]}")
        if launches2 or path_two != "two_sweep" or gap2 > XTOL_25:
            raise RuntimeError(f"25.1 {storage}: two_sweep {out[storage]}")
    del A
    torch.cuda.empty_cache()
    return out


def gradient_tuned_part(torch, pmtt, sk, dev, tmp):
    """25.1b: phase 7's Gradient-regularized CGLS with its derivative
    operators built under TUNE=on (an empty cache: the seed's overlap
    off, recorded): the tap kernel launches as untuned, x bitwise."""
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=4)
    res = {}
    for mode in ("off", "on"):
        set_knob("TUNE", None if mode == "off" else "on")
        set_knob("TUNE_CACHE", f"{tmp}/empty.json" if mode == "on" else None)
        StackOp, ystack, _ = gradient_poststack(torch, pmtt, m, wav, NITER,
                                                torch.float32)
        sk.reset_launches()
        x = pmtt.cgls(StackOp, ystack, niter=NITER, tol=0.0)[0]
        torch.cuda.synchronize()
        derivs = StackOp.ops[1].args[0].Op.ops if hasattr(
            StackOp.ops[1], "args") else []
        res[mode] = dict(x=x.array.clone(), launches=sk.launches,
                         overlap=[getattr(d, "overlap", None)
                                  for d in derivs])
        del StackOp, ystack, x
    set_knob("TUNE", None)
    set_knob("TUNE_CACHE", None)
    bitwise = torch.equal(res["on"]["x"], res["off"]["x"])
    out = dict(launches_tuned=res["on"]["launches"],
               launches_untuned=res["off"]["launches"], bitwise=bitwise,
               overlap_recorded=res["on"]["overlap"])
    print(f"25.1b Gradient-regularized CGLS ({NX}, {NT0}) f32, {NITER} "
          f"iterations under TUNE=on: the derivatives record overlap "
          f"{res['on']['overlap']}; tap kernel launches {out['launches_tuned']}"
          f" (untuned {out['launches_untuned']}); x "
          f"{'bitwise' if bitwise else 'NOT bitwise'} the untuned solve's",
          flush=True)
    if not bitwise or out["launches_tuned"] != out["launches_untuned"] \
            or not out["launches_tuned"]:
        raise RuntimeError(f"25.1b: {out}")
    return out


def summa_tuned_part(torch, pmtt, dev, tmp):
    """25.2: SUMMA at (N_MM, K_MM, M_MM) f32 under TUNE=auto: the
    factory times each candidate the card lists (on a 1×1 grid the
    default alone: every schedule runs the same GEMM), the default is
    banked, and a second construction replays it with no trial."""
    from pylops_mpi_tpu_torch.diagnostics import trace
    from pylops_mpi_tpu_torch.tuning import cache as tcache
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    from pylops_mpi_tpu_torch.tuning import space as tspace
    g = torch.Generator(device=dev).manual_seed(25)
    A = torch.randn((N_MM, K_MM), generator=g, device=dev)
    A /= math.sqrt(N_MM)
    set_knob("TUNE", "auto")
    set_knob("TUNE_CACHE", f"{tmp}/summa.json")
    set_knob("TRACE", "spans")
    out = {}
    try:
        for run in ("measure", "replay"):
            tcache.clear_memory()
            trace.clear_events()
            t0 = time.perf_counter()
            op = pmtt.MPIMatrixMult(A, M_MM, kind="summa")
            build_s = time.perf_counter() - t0
            trials = [e["args"] for e in _events(trace, "tuning.trial")]
            plans = [e["args"] for e in _events(trace, "tuning.plan")]
            out[run] = dict(build_s=build_s, trials=trials, plan=plans[-1],
                            schedule=op.schedule, overlap=op.overlap,
                            grid=op.grid)
            del op
    finally:
        for k in ("TUNE", "TUNE_CACHE", "TRACE"):
            set_knob(k, None)
        tcache.clear_memory()
        trace.clear_events()
    del A
    torch.cuda.empty_cache()
    m, r = out["measure"], out["replay"]
    sp = tspace.space_for("matrixmult")
    platform, chip = tplan._chip_kind(dev)
    ctx = {"op": "matrixmult", "shape": (N_MM, K_MM, M_MM),
           "platform": platform, "chip": chip,
           "extra": {"grid": tuple(m["grid"])}}
    cands, dflt = tspace.candidates(sp, ctx), tspace.default_params(sp, ctx)
    print(f"25.2 the {platform} candidates on grid {m['grid']}: {cands} "
          f"(default {dflt})", flush=True)
    for t in m["trials"]:
        print(f"25.2 SUMMA ({N_MM}, {K_MM}, {M_MM}) f32 grid {m['grid']}: "
              f"candidate {t['params']} best_s "
              f"{(t['best_s'] or 0) * 1e3:.4f} ms (warm-up "
              f"{(t['compile_s'] or 0) * 1e3:.1f} ms) ok {t['ok']}",
              flush=True)
    print(f"25.2 banked {m['plan']['params']} [{m['plan']['provenance']}] "
          f"in {m['build_s']:.2f} s of construction; the replay "
          f"{r['plan']['params']} [{r['plan']['provenance']}] with "
          f"{len(r['trials'])} trials in {r['build_s']:.3f} s", flush=True)
    if not m["trials"] or not all(t["ok"] for t in m["trials"]) \
            or m["plan"]["provenance"] != "tuned" or r["trials"] \
            or r["plan"]["provenance"] != "tuned" \
            or r["plan"]["params"] != m["plan"]["params"] \
            or r["schedule"] != m["plan"]["params"]["schedule"] \
            or sorted(map(str, (t["params"] for t in m["trials"]))) \
            != sorted(map(str, cands)) \
            or (tuple(m["grid"]) == (1, 1)
                and m["plan"]["params"] != dflt):
        raise RuntimeError(f"25.2: {out}")
    return out


def roofline_part(torch, pmtt, dev):
    """25.3: ``estimate`` and ``roofline`` against CUDA-event times of the
    main path's applies; the block-diagonal and Gradient applies may not
    read faster than SHARE_25 of their prediction."""
    from pylops_mpi_tpu_torch.diagnostics import costmodel as cm
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    peaks = cm.device_peaks(dev)
    g = torch.Generator(device=dev).manual_seed(26)
    rows = {}

    def row(label, op, direction, apply, gated):
        cost = cm.estimate(op, direction)
        rf = cm.roofline(cost, peaks)
        ms = cuda_ms(apply, REPS_25)
        meas = cm.roofline(cost, peaks, measured_s=ms / 1e3)
        pred = rf["predicted_s"] * 1e3
        rows[label] = dict(direction=direction, predicted_ms=pred,
                           measured_ms=ms, bound=rf["bound"],
                           components_ms={k: v * 1e3 for k, v in
                                          rf["components_s"].items()},
                           share=pred / ms, hbm_pct=meas.get("hbm_pct"),
                           regime=meas.get("regime"), gated=gated,
                           flops=cost.flops, hbm_bytes=cost.hbm_bytes)
        print(f"25.3 {label} ({direction}): predicted {pred:.4f} ms "
              f"({rf['bound']}-bound), measured {ms:.4f} ms, share of the "
              f"roofline {pred / ms:.3f}{' (gated)' if gated else ''}, "
              f"hbm_pct {meas.get('hbm_pct')} ({meas.get('regime')})",
              flush=True)

    A, _, y_t = make_problem(torch, dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    x = pmtt.DistributedArray.to_dist(torch.randn(NBLK * NBLOCK,
                                                  generator=g, device=dev))
    bd = f"MPIBlockDiag {NBLK}x{NBLOCK}^2 f32"
    row(bd, Op, "forward", lambda: Op.matvec(x), True)
    row(bd + " normal", Op, "normal", lambda: Op.normal_matvec(x), True)
    del Op, x
    G = pmtt.MPIGradient((NX, NT0), dtype=torch.float32)
    xg = pmtt.DistributedArray.to_dist(torch.randn(NX * NT0, generator=g,
                                                   device=dev))
    row(f"MPIGradient ({NX}, {NT0}) f32", G, "forward",
        lambda: G.matvec(xg), True)
    del G, xg
    A = torch.randn((N_MM, K_MM), generator=g, device=dev)
    S = pmtt.MPIMatrixMult(A, M_MM, kind="summa")
    xs = pmtt.DistributedArray.to_dist(torch.randn(K_MM * M_MM, generator=g,
                                                   device=dev))
    row(f"SUMMA ({N_MM}, {K_MM}, {M_MM}) f32", S, "forward",
        lambda: S.matvec(xs), False)
    del S, A, xs
    torch.cuda.empty_cache()
    F = pmtt.MPIFFTND(FFT3, axes=(0, 1, 2), dtype=torch.complex64)
    c = pmtt.DistributedArray.to_dist(torch.randn(
        int(np.prod(FFT3)), generator=g, device=dev, dtype=torch.complex64))
    row(f"MPIFFTND {FFT3} c64", F, "forward", lambda: F.matvec(c), False)
    del F, c
    torch.cuda.empty_cache()
    over = {k: r["share"] for k, r in rows.items()
            if r["gated"] and r["share"] > SHARE_25}
    if over:
        raise RuntimeError(f"25.3: applies above {SHARE_25} of their "
                           f"roofline: {over}")
    return dict(peaks={k: v for k, v in peaks.items()
                       if k != "allreduce_latency_s"}, rows=rows)


def ca_auto_part(torch, pmtt, dev, tmp):
    """25.4: CA=auto resolves off with no group (no reduction issued);
    under an NCCL group of one it reads the measured α against the
    apply's roofline; the auto solve is bitwise its named engine's, and
    the pick and the other engine are timed in alternating pairs."""
    import torch.distributed as dist
    from pylops_mpi_tpu_torch.diagnostics import costmodel as cm
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.solvers import ca
    A, _, y_t = make_problem(torch, dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    y = pmtt.DistributedArray.to_dist(y_t)
    set_knob("CA", "auto")
    nogroup = ca.resolve_mode(Op, "cgls")
    pmtt.parallel.init(backend="nccl", store=dist.FileStore(
        f"{tmp}/store25", 1), rank=0, world_size=1, device=dev)
    try:
        alpha = cm.measure_allreduce_latency()
        peaks = cm.device_peaks(dev)
        pred = cm.roofline(cm.estimate(Op), peaks)["predicted_s"]
        pick = ca.resolve_mode(Op, "cgls")
        other = "off" if pick == "pipelined" else "pipelined"

        def solve(mode):
            set_knob("CA", mode)
            t0 = time.perf_counter()
            out = pmtt.cgls(Op, y, niter=NITER_25, tol=0.0, normal=True)
            torch.cuda.synchronize()
            return out[0].array.clone(), out[2], time.perf_counter() - t0

        x_auto, it_auto, _ = solve("auto")
        x_named, _, _ = solve(pick)
        solve(other)
        walls = {pick: [], other: []}
        for i in range(PAIRS_25):
            for mode in ((pick, other) if i % 2 == 0 else (other, pick)):
                walls[mode].append(solve(mode)[2])
    finally:
        set_knob("CA", None)
        pmtt.parallel.destroy()
    del Op
    torch.cuda.empty_cache()
    bitwise = torch.equal(x_auto, x_named)
    ratios = [a / b for a, b in zip(walls[other], walls[pick])]
    out = dict(nogroup=nogroup, alpha_s=alpha,
               reductions=ca.classic_reductions_per_iter("cgls"),
               predicted_apply_s=pred, pick=pick, other=other,
               bitwise=bitwise, walls_s=walls, other_over_pick=ratios,
               iters_per_s={k: NITER_25 / float(np.median(v))
                            for k, v in walls.items()})
    print(f"25.4 CA=auto: no group -> {nogroup}; NCCL group of one: alpha "
          f"{alpha * 1e6:.1f} us (measured), {out['reductions']} "
          f"reductions an iteration = {out['reductions'] * alpha * 1e3:.4f} "
          f"ms against 0.25 x the predicted apply {pred * 1e3:.4f} ms -> "
          f"{pick}; the auto solve {'bitwise' if bitwise else 'NOT bitwise'}"
          f" the {pick} engine's; iters/s {pick} "
          f"{out['iters_per_s'][pick]:.1f}, {other} "
          f"{out['iters_per_s'][other]:.1f}; {other}/{pick} wall ratios "
          f"{[round(r, 4) for r in ratios]}", flush=True)
    if nogroup != "off" or pick == "sstep" or not bitwise \
            or it_auto != NITER_25:
        raise RuntimeError(f"25.4: {out}")
    return out


def telemetry_part(torch, pmtt, dev):
    """25.5: the main path's CGLS with TELEMETRY=on, eagerly and through
    the graph bank: one record an iteration, ``resid`` bitwise the cost
    history, the banked history bitwise the eager one; iters/s with
    telemetry on over off in alternating pairs (not gated)."""
    from pylops_mpi_tpu_torch.aot import graphs, store
    from pylops_mpi_tpu_torch.diagnostics import telemetry
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    A, _, y_t = make_problem(torch, dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    y = pmtt.DistributedArray.to_dist(y_t)

    def solve(tel, aot):
        set_knob("TELEMETRY", "on" if tel else "off")
        set_aot(aot)
        telemetry.clear_history()
        t0 = time.perf_counter()
        out = pmtt.cgls(Op, y, niter=NITER_25, tol=0.0, normal=True)
        torch.cuda.synchronize()
        return out, telemetry.history("cgls"), time.perf_counter() - t0

    res = {}
    try:
        store.clear_memory()
        graphs.reset_capture_count()
        eager, h_eager, _ = solve(True, False)
        solve(True, True)  # the capture
        banked, h_banked, _ = solve(True, True)
        cost = torch.as_tensor(eager[5]).double().cpu().numpy()
        resid = np.asarray([s["resid"] for s in h_eager])
        res.update(
            records=len(h_eager), iiter=[s["iiter"] for s in h_eager][:3],
            resid_bitwise_cost=bool(np.array_equal(resid, cost[1:])),
            banked_bitwise_eager=h_banked == h_eager,
            x_banked_bitwise=torch.equal(banked[0].array, eager[0].array),
            captures=graphs.stats().get("captures", 0))
        for aot in (False, True):
            walls = {True: [], False: []}
            solve(False, aot)  # with telemetry off: its own capture
            for i in range(PAIRS_25):
                for tel in ((True, False) if i % 2 == 0 else (False, True)):
                    walls[tel].append(solve(tel, aot)[2])
            res["graphs" if aot else "eager"] = dict(
                ratios_on_over_off=[
                    (NITER_25 / a) / (NITER_25 / b)
                    for a, b in zip(walls[True], walls[False])],
                iters_per_s_on=NITER_25 / float(np.median(walls[True])),
                iters_per_s_off=NITER_25 / float(np.median(walls[False])))
    finally:
        set_knob("TELEMETRY", None)
        set_aot(False)
        store.clear_memory()
        telemetry.clear_history()
    del Op
    torch.cuda.empty_cache()
    for mode in ("eager", "graphs"):
        r = res[mode]
        print(f"25.5 telemetry {mode}: iters/s on {r['iters_per_s_on']:.1f},"
              f" off {r['iters_per_s_off']:.1f}; on/off in pairs "
              f"{[round(v, 4) for v in r['ratios_on_over_off']]}", flush=True)
    print(f"25.5 {res['records']} records for {NITER_25} iterations "
          f"(iiter {res['iiter']}...), resid bitwise the cost history: "
          f"{res['resid_bitwise_cost']}; banked history bitwise the eager "
          f"one: {res['banked_bitwise_eager']} (x bitwise: "
          f"{res['x_banked_bitwise']}), captures {res['captures']}",
          flush=True)
    if res["records"] != NITER_25 or not res["resid_bitwise_cost"] \
            or not res["banked_bitwise_eager"] \
            or not res["x_banked_bitwise"]:
        raise RuntimeError(f"25.5: {res}")
    return res


def _agg25_rank(torch, pmtt, dev, out_dir):
    """A spawned rank of 25.6: the main path's CGLS (NITER_AGG_25
    iterations, its chunk of the blocks) with the span tracer and the
    metrics on; rank 1 late by LATE_25 s; the trace and the metrics
    snapshot dumped into ``out_dir``."""
    import os
    os.environ["PYLOPS_MPI_TPU_TORCH_TRACE"] = "spans"
    os.environ["PYLOPS_MPI_TPU_TORCH_METRICS"] = "on"
    from pylops_mpi_tpu_torch.diagnostics import metrics, trace
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    A, _, y_t = make_problem(torch, dev)
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)])
    del A
    y = pmtt.DistributedArray.to_dist(y_t)
    y.norm()
    y.dot(y)
    r = pmtt.parallel.rank()
    if r == 1:
        time.sleep(LATE_25)
    trace.clear_events()
    nk.reset_launches()
    x = pmtt.cgls(Op, y, niter=NITER_AGG_25, tol=0.0, normal=True)[0]
    torch.cuda.synchronize()
    trace.dump(f"{out_dir}/trace.rank{r}.jsonl")
    metrics.write_snapshot(f"{out_dir}/rank{r}.metrics.json")
    return dict(launches=nk.launches, x=x.asarray())


def aggregate_part(torch, here, dev, tmp, x10):
    """25.6: two gloo ranks sharing the card dump their traces; the
    aggregator's CLI merges them (``ok``), every matched collective has
    ``skew_us``, the late rank is the straggler, and the critical path
    names ``solver.cgls``."""
    import os
    out_dir = f"{tmp}/traces25"
    os.makedirs(out_dir, exist_ok=True)
    ranks = spawn_shared_card(2, here, _agg25_rank, (out_dir,))
    gap = max(rel_norm(torch.as_tensor(r["x"]).to(x10.device), x10)
              for r in ranks)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYLOPS_MPI_TPU")}
    cmd = [sys.executable, "-m", "pylops_mpi_tpu_torch.diagnostics",
           "aggregate", out_dir, "--out", f"{tmp}/merged25.json",
           "--summary-out", f"{tmp}/summary25.json"]
    r = subprocess.run(cmd, cwd=str(here), env=env, capture_output=True,
                       text=True, timeout=300)
    if r.returncode:
        raise RuntimeError(f"25.6: aggregate failed: {r.stderr[-2000:]}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    with open(f"{tmp}/summary25.json") as f:
        full = json.load(f)
    colls = full["collectives"]
    worst = max(colls, key=lambda c: c["skew_us"]) if colls else {}
    skewed = sorted(c["skew_us"] for c in colls)
    out = dict(ok=last["ok"], ranks=last["ranks"],
               n_collectives_matched=last["n_collectives_matched"],
               offsets_us=last["offsets_us"], max_skew=worst,
               median_skew_us=skewed[len(skewed) // 2] if skewed else None,
               critical_path=[c["solver"] for c in last["critical_path"]],
               all_skewed=all("skew_us" in c for c in colls),
               launches=[o["launches"] for o in ranks], x_gap=gap)
    print(f"25.6 two gloo ranks sharing the card (rank 1 late by "
          f"{LATE_25} s): aggregate ok {out['ok']}, "
          f"{out['n_collectives_matched']} collectives matched, offsets "
          f"{out['offsets_us']} us, max skew {worst.get('skew_us')} us at "
          f"{worst.get('name')} seq {worst.get('seq')} (straggler rank "
          f"{worst.get('straggler_rank')}), median skew "
          f"{out['median_skew_us']} us; critical paths "
          f"{out['critical_path']}; normal kernel launches per rank "
          f"{out['launches']}; x within {gap:.3e} of the no-group solve",
          flush=True)
    if not (out["ok"] and out["n_collectives_matched"] and out["all_skewed"]
            and "solver.cgls" in out["critical_path"]
            and worst.get("straggler_rank") == 1
            and out["launches"] == [NITER_AGG_25] * 2 and gap <= 1e-5):
        raise RuntimeError(f"25.6: {out}")
    return out


def tuner_phase(torch, pmtt, kernels, here, dev):
    """Phase 25 (module docstring): the cost model and the tuner. 25.1 is
    its main path: the normal kernel's counts are set to 0 just before
    the tuned solve and read just after."""
    import shutil
    import tempfile
    nk, sk = kernels
    card = card_name() if dev.type == "cuda" else "cpu"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    res = {"card": card}
    try:
        for name, fn in (
                ("race", lambda: tuner_race_part(torch, pmtt, nk, here, dev,
                                                 tmp)),
                ("gradient", lambda: gradient_tuned_part(torch, pmtt, sk,
                                                         dev, tmp)),
                ("summa", lambda: summa_tuned_part(torch, pmtt, dev, tmp)),
                ("roofline", lambda: roofline_part(torch, pmtt, dev)),
                ("ca_auto", lambda: ca_auto_part(torch, pmtt, dev, tmp)),
                ("telemetry", lambda: telemetry_part(torch, pmtt, dev)),
                ("aggregate", lambda: aggregate_part(
                    torch, here, dev, tmp, res["race"]["x10"]))):
            t = time.perf_counter()
            res[name] = fn()
            print(f"25 {name} in {time.perf_counter() - t:.1f} s on {card}",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["race"].pop("x10", None)
    return res


# ------------------------------------------------------------ phase 26
# 26.1: phase 6's field (65536 x 1024 f32, 256 MiB) over 3 gloo ranks
# sharing the card, moved under a 16 MiB budget and unbounded
SHAPE_26, RANKS_26, BUDGET_26 = (NX, NT0), 3, 16 << 20
# the caching allocator counts whole blocks: a large block is not split
# when less than 1 MiB would be left, so each device tensor live in a
# chunk (at most 4: its carves and one H2D temporary) may count up to
# 1 MiB over its bytes
ROUNDING_26 = 4 << 20
# 26.2: the main path's block stack (NBLK x NBLOCK^2 f32, 2 GiB)
SPILL_BUDGET_26, PAIRS_26 = 256 << 20, 3
# 26.3: cgls_segmented(normal=True) by two gloo workers sharing the card
NITER_26, EPOCH_26, KILL_AT_26, HB_26, SLEEP_26 = 50, 8, 2, 0.5, 1.5
ERR_LIMIT_26 = 1e-4                  # phase 3's f32 error limit
# 26.4: under one vector of the carry (32 x 4096 f32, 512 KiB), so that
# every vector is placed in several chunks
RESTORE_BUDGET_26 = "64k"


def _ragged_26(n, rows):
    """26.1's ragged axis-0 split: the last rank holds half the rows."""
    base = [rows // (2 * (n - 1))] * (n - 1)
    return base + [rows - sum(base)]


def _field_26(torch, dev):
    g = torch.Generator(device=dev).manual_seed(26)
    return torch.randn(SHAPE_26, generator=g, device=dev)


def _reshard_rank_26(torch, pmtt, dev):
    """A rank of 26.1: each move under the budget and unbounded, its
    shard against the host's numpy cut, its peak device scratch, the
    bytes it received, its wall time."""
    from pylops_mpi_tpu_torch.parallel import collectives, reshard as rs
    from pylops_mpi_tpu_torch.parallel.partition import local_split
    n = pmtt.parallel.world_size()
    r = pmtt.parallel.rank()
    full = _field_26(torch, dev)
    host = full.cpu().numpy()
    rag = [(k, SHAPE_26[1]) for k in _ragged_26(n, SHAPE_26[0])]
    srcs = {"ragged_to_balanced": pmtt.DistributedArray.to_dist(
                full, local_shapes=rag),
            "axis0_to_axis1": pmtt.DistributedArray.to_dist(full)}
    del full
    torch.cuda.empty_cache()
    out = {}
    for name, x in srcs.items():
        axis = 0 if name == "ragged_to_balanced" else 1
        new = local_split(SHAPE_26, n, pmtt.Partition.SCATTER, axis)
        off = sum(s[axis] for s in new[:r])
        sl = [slice(None)] * 2
        sl[axis] = slice(off, off + new[r][axis])
        want = host[tuple(sl)]
        res = {}
        results = []
        for label, budget in (("budget", BUDGET_26), ("unbounded", None)):
            collectives.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            y = rs.reshard(x, axis=axis,
                           local_shapes=None, budget=budget, spill="off")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            scratch = torch.cuda.max_memory_allocated() - \
                torch.cuda.memory_allocated()
            plan = rs.plan_reshard(SHAPE_26, 4, rs._layout_of(x),
                                   rs._layout_of(y), budget=budget,
                                   spill="off")
            B = rs._pair_bytes(x.size * 4, plan.src, plan.dst,
                               plan.move_axis, SHAPE_26, 4)
            B[range(min(B.shape)), range(min(B.shape))] = 0.0
            res[label] = dict(
                chunks=plan.chunks, ms=ms, peak_scratch=int(scratch),
                plan_scratch=plan.peak_scratch, kind=plan.kind,
                received=int(collectives.received[plan.kind]),
                plan_received=int(round(B[:, r].sum())),
                exchanges=int(collectives.counts[plan.kind]),
                numpy_equal=bool(np.array_equal(y.array.cpu().numpy(),
                                                want)))
            results.append(y.array)
        res["budget_equals_unbounded"] = bool(torch.equal(*results))
        try:
            rs.reshard(x, axis=axis, budget=plan.min_budget - 1,
                       spill="off")
            res["refused"] = None
        except rs.ReshardError as e:
            res["refused"] = [e.min_budget, str(e)]
        res["min_budget"] = plan.min_budget
        out[name] = res
        del results, y
        torch.cuda.empty_cache()
    return out


def reshard_part(torch, pmtt, here):
    """26.1 (module docstring)."""
    t = time.perf_counter()
    ranks = spawn_shared_card(RANKS_26, here, _reshard_rank_26)
    rec = {"ranks": ranks, "wall_s": time.perf_counter() - t}
    for name in ranks[0]:
        for label in ("budget", "unbounded"):
            rows = [rk[name][label] for rk in ranks]
            print(f"26.1 {name} {SHAPE_26} f32 over {RANKS_26} gloo ranks, "
                  f"{label} ({BUDGET_26 if label == 'budget' else 'none'} "
                  f"B): {rows[0]['chunks']} chunks of {rows[0]['kind']}, "
                  f"ms per rank {[round(x['ms'], 1) for x in rows]}, peak "
                  f"device scratch {[x['peak_scratch'] for x in rows]} B "
                  f"(plan {rows[0]['plan_scratch']} B), received "
                  f"{[x['received'] for x in rows]} B (plan "
                  f"{[x['plan_received'] for x in rows]})", flush=True)
            for x in rows:
                ok = (x["numpy_equal"] and x["received"] == x["plan_received"]
                      and x["exchanges"] == x["chunks"])
                if label == "budget":
                    ok = ok and x["peak_scratch"] <= BUDGET_26 + ROUNDING_26
                if not ok:
                    raise RuntimeError(f"26.1 {name} {label}: {x}")
        for rk in ranks:
            res = rk[name]
            mb = res["min_budget"]
            if not (res["budget_equals_unbounded"] and res["refused"]
                    and res["refused"][0] == mb
                    and f"at least {mb}" in res["refused"][1]):
                raise RuntimeError(f"26.1 {name}: {res}")
        print(f"26.1 {name}: budgeted and unbounded bitwise equal on every "
              f"rank and to numpy's cut; a budget a byte under min_budget "
              f"refused naming it ({ranks[0][name]['min_budget']} B)",
              flush=True)
    return rec


def spill_part(torch, pmtt, dev):
    """26.2 (module docstring): the block stack to host RAM and back."""
    import os
    from pylops_mpi_tpu_torch.diagnostics import metrics
    from pylops_mpi_tpu_torch.parallel import reshard as rs, spill
    os.environ["PYLOPS_MPI_TPU_TORCH_METRICS"] = "on"
    A, _, _ = make_problem(torch, dev)
    x = pmtt.DistributedArray.to_dist(A)
    nbytes = A.numel() * A.element_size()
    lay = rs._layout_of(x)
    p_out = rs.plan_reshard(x.global_shape, 4, lay, lay,
                            budget=SPILL_BUDGET_26, spill="on", dst_host=True)
    p_in = rs.plan_reshard(x.global_shape, 4, rs.Layout.replicated(1), lay,
                           budget=SPILL_BUDGET_26, spill="on", src_host=True,
                           dst_host=False)
    runs = {"on": [], "off": []}
    order = [ov for _ in range(PAIRS_26) for ov in (("on", "off")
                                                   if _ % 2 == 0
                                                   else ("off", "on"))]
    try:
        for ov in order:
            metrics.clear_metrics()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            h = x.to_host(budget=SPILL_BUDGET_26, overlap=ov)
            t_out = time.perf_counter() - t0
            s_out = torch.cuda.max_memory_allocated() - base
            d2h = metrics.snapshot()["counters"].get(
                "collective.reshard.bytes_d2h", 0)
            pinned = bool(h.local.is_pinned())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            back = h.to_device(budget=SPILL_BUDGET_26, spill="on",
                               overlap=ov)
            t_in = time.perf_counter() - t0
            s_in = torch.cuda.max_memory_allocated() - \
                torch.cuda.memory_allocated()
            h2d = metrics.snapshot()["counters"].get(
                "collective.reshard.bytes_h2d", 0)
            same = bool(torch.equal(back.array, A))
            pinned = pinned or dev.type != "cuda"  # pinned from a card
            runs[ov].append(dict(d2h_gbps=nbytes / t_out / 1e9,
                                 h2d_gbps=nbytes / t_in / 1e9,
                                 d2h_s=t_out, h2d_s=t_in,
                                 scratch_out=int(s_out),
                                 scratch_in=int(s_in), bytes_d2h=d2h,
                                 bytes_h2d=h2d, bitwise=same,
                                 pinned=pinned))
            del h, back
            if not (same and pinned and s_out <= SPILL_BUDGET_26
                    and s_in <= SPILL_BUDGET_26
                    and d2h == p_out.nbytes_d2h
                    and h2d == p_in.nbytes_h2d):
                raise RuntimeError(f"26.2 overlap {ov}: {runs[ov][-1]}")
    finally:
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_METRICS", None)
    ratio = [a["d2h_s"] / b["d2h_s"] for a, b in zip(runs["on"], runs["off"])]
    for ov in ("on", "off"):
        r = runs[ov]
        print(f"26.2 block stack {tuple(A.shape)} f32 ({nbytes} B), "
              f"budget {SPILL_BUDGET_26} B, {p_out.chunks} chunks, overlap "
              f"{ov}: D2H GB/s {[round(x['d2h_gbps'], 2) for x in r]}, H2D "
              f"GB/s {[round(x['h2d_gbps'], 2) for x in r]}, peak device "
              f"scratch {[x['scratch_out'] for x in r]} / "
              f"{[x['scratch_in'] for x in r]} B, bytes d2h/h2d "
              f"{r[0]['bytes_d2h']}/{r[0]['bytes_h2d']} (plan "
              f"{p_out.nbytes_d2h}/{p_in.nbytes_h2d}), round trip bitwise, "
              f"host buffer pinned", flush=True)
    print(f"26.2 to_host on/off wall ratio over {PAIRS_26} alternating "
          f"pairs: {[round(v, 3) for v in ratio]}", flush=True)
    del x, A
    torch.cuda.empty_cache()
    return dict(runs=runs, on_off_ratio=ratio, chunks=p_out.chunks,
                plan_d2h=p_out.nbytes_d2h, plan_h2d=p_in.nbytes_h2d)


def inplace_problem(torch, pmtt, dev, nblk, nblock):
    """26.3's problem: phase 3's seeded blocks, known model and data
    (made on the card in every process alike), this rank's chunk of the
    blocks only."""
    from pylops_mpi_tpu_torch.ops.blockdiag import _chunk_ops
    from pylops_mpi_tpu_torch.ops.local import MatrixMult, ShapeOnly
    from pylops_mpi_tpu_torch.parallel.mesh import rank, world_size
    global NBLK, NBLOCK
    NBLK, NBLOCK = nblk, nblock
    A, xtrue, y = make_problem(torch, dev)
    mine = set(_chunk_ops(list(range(nblk)), world_size())[rank()])
    ops = [MatrixMult(A[i].clone()) if i in mine
           else ShapeOnly(nblock, nblock, dtype=torch.float32)
           for i in range(nblk)]
    del A
    torch.cuda.empty_cache()
    return pmtt.MPIBlockDiag(ops), pmtt.DistributedArray.to_dist(y), xtrue


def inplace_worker(args):
    """26.3's supervised worker (``chip_smoke.py --inplace-worker CKPT OUT
    MARK DEVICE NBLK NBLOCK KILL``): join the attempt's gloo group on the
    card; run ``cgls_segmented(normal=True)`` with the shards backend
    (resuming from CKPT when it exists), timing each epoch and each
    carry bank; on ``ElasticReconfig`` recover in place (re-form to a
    world of one, rebuild the blocks, ``restore_carry``, resume). KILL
    ``nap``: every epoch ends in a nap of SLEEP_26 s, in which the
    supervisor's hook kills worker 1; ``mid``: no nap, and worker 1 of
    the first attempt SIGKILLs itself as it enters its third all-reduce
    after epoch KILL_AT_26 (MARK.killed holds the time). The resumed
    solve is this slice's main path: the normal kernel's count is set to
    0 just before it and read just after. The last process writes OUT
    (JSON) and its x (OUT.x.npy); every process leaves with
    ``os._exit``."""
    import os
    import signal
    ckpt, out, mark, device = args[:4]
    nblk, nblock, kill = int(args[4]), int(args[5]), args[6]
    t_start = time.time()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.diagnostics import trace
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.resilience import elastic
    dev = torch.device(device)
    cfg = elastic.elastic_initialize(backend="gloo", device=dev)
    rec = {"t_start": t_start, "attempt": cfg.attempt, "bank_ms": [],
           "epoch_end": []}
    bank = elastic.bank_carry

    def timed_bank(tag, carry):
        t0 = time.perf_counter()
        bank(tag, carry)
        rec["bank_ms"].append((time.perf_counter() - t0) * 1e3)

    elastic.bank_carry = timed_bank
    from pylops_mpi_tpu_torch.utils import checkpoint as ckpt_mod
    load = ckpt_mod.load_fused_carry

    def timed_load(*a, **k):
        out = load(*a, **k)
        rec["t_resume"] = time.time()  # the relaunch's state in place
        rec["resumed_from"] = int(out["iiter"])
        return out

    ckpt_mod.load_fused_carry = timed_load
    Op, y, xtrue = inplace_problem(torch, pmtt, dev, nblk, nblock)
    box = {"s": SLEEP_26 if (cfg.num_processes or 1) > 1
           and kill == "nap" else 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def die_in_third_all_reduce():
        import torch.distributed as dist
        real, calls = dist.all_reduce, [0]

        def all_reduce(*a, **k):
            calls[0] += 1
            if calls[0] >= 3:
                with open(mark + ".killed", "w") as f:
                    f.write(repr(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            return real(*a, **k)

        dist.all_reduce = all_reduce

    def on_epoch(info):
        sync()
        rec["epoch_end"].append(time.time())
        with open(mark, "w") as f:
            f.write(str(info["epoch"]))
        if (kill == "mid" and info["epoch"] == KILL_AT_26
                and cfg.attempt == 0 and pmtt.parallel.rank() == 1):
            die_in_third_all_reduce()
        time.sleep(box["s"])

    solve = dict(niter=NITER_26, tol=0.0, epoch=EPOCH_26, normal=True,
                 checkpoint_path=ckpt, backend="shards", on_epoch=on_epoch)
    how = "relaunch" if cfg.attempt else "fresh"
    nk.reset_launches()
    try:
        res = pmtt.cgls_segmented(Op, y, **solve)
    except elastic.ElasticReconfig as rc:
        rec["t_catch"] = time.time()
        rec["epochs_before"] = len(rec["epoch_end"])
        rec["bank_ms_before"], rec["bank_ms"] = rec["bank_ms"], []
        rec["epoch_end"] = []
        cfg = elastic.apply_reconfig(rc.config)
        box["s"] = 0.0
        try:
            mesh = elastic.reform_mesh(cfg, device=dev)
            del Op, y
            torch.cuda.empty_cache()
            Op, y, xtrue = inplace_problem(torch, pmtt, dev, nblk, nblock)
            state = elastic.restore_carry("cgls", mesh)
            rec["resumed_from"] = int(state["iiter"])
            solve.update(checkpoint_path=ckpt + ".inplace")
            rec["t_resume"] = time.time()
            nk.reset_launches()
            res = pmtt.cgls_segmented(Op, y, resume=False,
                                      resume_state=state, **solve)
            sync()
            how = "inplace"
        except Exception as exc:  # a refusal: the relaunch ladder
            print(f"ELASTIC INPLACE FALLBACK: {type(exc).__name__}: {exc}",
                  flush=True)
            trace.event("resilience.inplace_fallback", cat="resilience",
                        error=type(exc).__name__, detail=str(exc))
            sys.stdout.flush()
            os._exit(5)
    launches = nk.launches
    x = res.x.array
    if pmtt.parallel.rank() == 0:
        err = float(torch.linalg.vector_norm(x - xtrue)
                    / torch.linalg.vector_norm(xtrue))
        loads = sum(1 for e in trace.get_events()
                    if e["name"] == "checkpoint.load")
        rec.update(how=how, iiter=int(res.iiter), launches=int(launches),
                   epochs=int(res.epochs), rel_err=err,
                   finite=bool(torch.isfinite(x).all()),
                   checkpoint_loads=loads,
                   peer_lost=sum(1 for e in trace.get_events()
                                 if e["name"] == "resilience.peer_lost"),
                   t_end=time.time())
        np.save(out + ".x.npy", x.cpu().numpy())
        with open(out, "w") as f:
            json.dump(rec, f)
    print(f"INPLACE WORKER {how} attempt {cfg.attempt}: {res.iiter} "
          f"iterations, {launches} normal-kernel launches", flush=True)
    sys.stdout.flush()
    os._exit(0)


def _inplace_job(torch, here, dev, tmp, inplace, kill="nap"):
    """One 26.3 job: two gloo workers; worker 1 SIGKILLed once its
    KILL_AT_26-th epoch is saved (``nap``: by the supervisor's hook, in
    the worker's nap; ``mid``: by itself, inside a collective of the next
    epoch); the record of the process that finished, its x, and the
    supervisor's times (wall clock)."""
    import os
    import signal
    from pylops_mpi_tpu_torch.resilience.supervisor import launch_job
    tag = ("inplace" if inplace else "relaunch") + (
        "_mid" if kill == "mid" else "")
    out, mark = f"{tmp}/{tag}.json", f"{tmp}/{tag}.mark"
    times = {}

    def on_poll(attempt, workers):
        if kill == "mid" and "kill" not in times \
                and os.path.exists(mark + ".killed"):
            try:
                with open(mark + ".killed") as f:
                    times["kill"] = float(f.read())
            except (OSError, ValueError):
                pass  # a torn write: the next poll reads it whole
        if kill == "nap" and "kill" not in times and os.path.exists(mark):
            try:
                with open(mark) as f:
                    epoch = int(f.read() or 0)
            except (OSError, ValueError):
                epoch = 0
            if epoch >= KILL_AT_26:
                for w in workers:
                    if w.slot == 1 and w.alive():
                        w.proc.send_signal(signal.SIGKILL)
                        times["kill"] = time.time()
        if ("kill" in times and "detect" not in times and inplace
                and any(os.path.exists(w.reconfig_path) for w in workers
                        if w.reconfig_path)):
            times["detect"] = time.time()

    def on_relaunch(attempt, failure):
        times.setdefault("detect", time.time())

    argv = [str(here / "chip_smoke.py"), "--inplace-worker",
            f"{tmp}/{tag}.carry", out, mark, str(dev), str(NBLK),
            str(NBLOCK), kill]
    t0 = time.time()
    r = launch_job(argv, 2, heartbeat_interval=HB_26, stale_factor=4.0,
                   grace_s=300.0, job_timeout_s=600, on_poll=on_poll,
                   on_relaunch=on_relaunch, inplace=inplace,
                   logdir=f"{tmp}/{tag}.logs",
                   env={"PYLOPS_MPI_TPU_TORCH_TRACE": "spans"})
    t_end = time.time()
    if not r.ok or not os.path.exists(out):
        raise RuntimeError(f"26.3 {tag}: the job failed: {r.failures} "
                           f"{r.outputs}")
    with open(out) as f:
        w = json.load(f)
    x = np.load(out + ".x.npy")
    ends = w["epoch_end"]
    back = times["detect"]
    t_resume = w.get("t_resume", w["t_start"])
    # the resumed epochs' lengths (the first from the state in place)
    epoch_s = [b - a for a, b in zip([t_resume] + ends[:-1], ends)]
    bank = w["bank_ms"]
    share = (float(np.mean(bank)) / (1e3 * float(np.mean(epoch_s)))
             if bank and epoch_s else 0.0)
    rec = dict(how=w["how"], attempts=r.attempts, world_size=r.world_size,
               failures=[f.as_dict() for f in r.failures],
               detection_s=times["detect"] - times["kill"],
               to_resume_start_s=t_resume - back,
               to_first_resumed_epoch_s=(ends[0] - back) if ends else None,
               job_wall_s=t_end - t0, rel_err=w["rel_err"],
               finite=w["finite"], iiter=w["iiter"], launches=w["launches"],
               resumed_from=w.get("resumed_from", 0),
               checkpoint_loads=w["checkpoint_loads"],
               peer_lost=w["peer_lost"], x=x, bank_ms=bank,
               bank_ms_two_ranks=w.get("bank_ms_before", []),
               epoch_s=epoch_s, bank_share=share, epochs_after=w["epochs"],
               outputs_tail=r.outputs.get(0, "")[-400:])
    return rec


def inplace_part(torch, pmtt, here, dev, tmp):
    """26.3 (module docstring): the in-place recovery on the main path
    with the kill in the worker's nap, the same job with the checkpoint
    relaunch, and the in-place recovery with worker 1 dying inside a
    collective mid-epoch. All three resume the carry of iteration 16 on a
    world of one, so their x must be bitwise equal."""
    res = {}
    for tag, inplace, kill in (("inplace", True, "nap"),
                               ("relaunch", False, "nap"),
                               ("inplace_mid", True, "mid")):
        res[tag] = _inplace_job(torch, here, dev, tmp, inplace, kill)
    ip, rl, mid = res["inplace"], res["relaunch"], res["inplace_mid"]
    xs = {tag: r.pop("x") for tag, r in res.items()}
    same = {tag: bool(np.array_equal(xs[tag], xs["relaunch"]))
            for tag in ("inplace", "inplace_mid")}
    diff = {tag: float(np.max(np.abs(xs[tag] - xs["relaunch"])))
            for tag in same}
    resume_at = KILL_AT_26 * EPOCH_26
    print(f"26.3 launch_job, 2 gloo workers on the card, cgls_segmented("
          f"normal=True) {NBLK}x{NBLOCK}^2 f32, {NITER_26} iterations, epochs "
          f"of {EPOCH_26}, worker 1 SIGKILLed after epoch {KILL_AT_26} (in "
          f"its {SLEEP_26} s nap; inplace_mid: inside its third all-reduce "
          f"of the next epoch, no nap):", flush=True)
    for tag, r in res.items():
        det = r["detection_s"]
        print(f"  {tag}: finished by '{r['how']}' in {r['attempts']} "
              f"attempts at world {r['world_size']}; detection "
              f"{det:.3f} s; to the resumed solve's start "
              f"{r['to_resume_start_s']:.3f} s, to its first epoch "
              f"{r['to_first_resumed_epoch_s']} s; job wall "
              f"{r['job_wall_s']:.2f} s; rel_err {r['rel_err']:.3e} (limit "
              f"{ERR_LIMIT_26:.0e}); checkpoint reads {r['checkpoint_loads']}"
              f"; peer-lost events {r['peer_lost']}; resumed at iteration "
              f"{r['resumed_from']}, {r['launches']} normal-kernel launches "
              f"after; bank ms per epoch "
              f"{[round(v, 2) for v in r['bank_ms']]} (two ranks: "
              f"{[round(v, 2) for v in r['bank_ms_two_ranks']]}), "
              f"{r['bank_share']:.2%} of an epoch", flush=True)
    print(f"26.3 x bitwise the relaunch's: {same} (max abs diff {diff})",
          flush=True)
    for tag, r, want_lost in (("in place", ip, 0), ("mid-epoch", mid, 1)):
        resumed = r["iiter"] - r["resumed_from"]
        if not (r["how"] == "inplace" and r["attempts"] == 2
                and r["world_size"] == 1 and r["checkpoint_loads"] == 0
                and r["resumed_from"] == resume_at
                and r["launches"] == resumed and resumed > 0
                and (r["peer_lost"] >= 1) == bool(want_lost)
                and r["rel_err"] <= ERR_LIMIT_26 and r["finite"]):
            raise RuntimeError(f"26.3 {tag}: {r}")
    if not (rl["how"] == "relaunch" and rl["attempts"] == 2
            and rl["checkpoint_loads"] >= 1
            and rl["resumed_from"] == resume_at
            and rl["rel_err"] <= ERR_LIMIT_26 and rl["finite"]):
        raise RuntimeError(f"26.3 relaunch: {rl}")
    if not all(same.values()):
        raise RuntimeError(f"26.3: x not bitwise the relaunch's: {diff}")
    res["bitwise_relaunch"] = same
    return res


def restore_part(torch, pmtt, tmp, dev):
    """26.4: 26.3's two-rank checkpoint restored on one rank under
    ``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET``, bitwise the unbudgeted
    restore."""
    import os
    from pylops_mpi_tpu_torch.utils import checkpoint as ckpt
    path = f"{tmp}/inplace.carry"
    t0 = time.perf_counter()
    plain = ckpt.load_fused_carry(path, "cgls", device=dev)
    t_plain = time.perf_counter() - t0
    from pylops_mpi_tpu_torch.diagnostics import trace
    env = {"PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET": RESTORE_BUDGET_26,
           "PYLOPS_MPI_TPU_TORCH_TRACE": "spans"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    trace.clear_events()
    try:
        budget = pmtt.parallel.reshard.reshard_budget()
        t0 = time.perf_counter()
        got = ckpt.load_fused_carry(path, "cgls", device=dev)
        t_budget = time.perf_counter() - t0
        steps = [e["args"] for e in trace.get_events()
                 if e["name"] == "collective.reshard.step"]
        spans = [e["args"] for e in trace.get_events()
                 if e["name"] == "collective.reshard"]
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
        trace.clear_events()
    same = {}
    for k, v in plain.items():
        if isinstance(v, pmtt.DistributedArray):
            same[k] = bool(torch.equal(v.array, got[k].array)
                           and v.local_shapes == got[k].local_shapes)
    chunks = [int(a.get("chunks", 0)) for a in spans]
    print(f"26.4 26.3's 2-rank checkpoint on one rank: budgeted "
          f"({RESTORE_BUDGET_26}) restore bitwise the unbudgeted: {same}; "
          f"{len(spans)} placements in {chunks} chunks ({len(steps)} steps, "
          f"largest staging {max([a.get('scratch_bytes', 0) for a in steps], default=0)}"
          f" B); {t_budget * 1e3:.1f} ms against {t_plain * 1e3:.1f} ms",
          flush=True)
    if not same or not all(same.values()):
        raise RuntimeError(f"26.4: {same}")
    # every vector streamed in several chunks, each under the budget
    if not (len(spans) == len(same) and chunks and min(chunks) > 1
            and all(a.get("scratch_bytes", 0) <= budget for a in steps)):
        raise RuntimeError(f"26.4: placements {spans}")
    return dict(bitwise=same, ms=t_budget * 1e3, plain_ms=t_plain * 1e3,
                chunks=chunks, steps=len(steps))


def reshard_phase(torch, pmtt, kernels, here, dev):
    """Phase 26 (module docstring): slice 15 on the card. 26.3 is its main
    path, in the survivor's process."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reshard_")
    res = {}
    try:
        for name, fn in (
                ("reshard", lambda: reshard_part(torch, pmtt, here)),
                ("spill", lambda: spill_part(torch, pmtt, dev)),
                ("inplace", lambda: inplace_part(torch, pmtt, here, dev,
                                                 tmp)),
                ("restore", lambda: restore_part(torch, pmtt, tmp, dev))):
            t = time.perf_counter()
            res[name] = fn()
            res[name + "_s"] = time.perf_counter() - t
            print(f"26 {name} in {res[name + '_s']:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "pylops_mpi_tpu_torch" / "__init__.py").is_file():
        log("chip_smoke.py: the package pylops_mpi_tpu_torch is not beside "
            "this script; run it from the root of the repository")
        return 2
    sys.path.insert(0, str(here))
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke.py: torch.cuda.is_available() is False; this script "
            "runs the port on a CUDA device only")
        return 3

    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops import _build
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    if Path(pmtt.__file__).resolve().parent != here / "pylops_mpi_tpu_torch":
        raise RuntimeError(f"imported {pmtt.__file__}, not the checkout's "
                           "package")
    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, out in _build.BUILD_LOGS.items():
        log(f"--- nvcc {name}.cu ---\n{out}")

    # 2. kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(1)
    stats = {}
    plans = {}
    for spec in NORMAL_SHAPES + [(NBLK, NBLOCK, NBLOCK)]:
        for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
            nblk, m, n, off = spec if len(spec) == 4 else spec + (0,)
            shape = (nblk, m, n)
            if dt == torch.float64 and m == NBLOCK:
                continue  # f64 is a correctness path only
            name = str(dt).split(".")[1]
            xdt = torch.float64 if dt == torch.float64 else torch.float32
            # off > 0: A is a view that many elements past an aligned base
            A = torch.randn(nblk * m * n + off, generator=g, device=dev) \
                .to(dt)[off:].view(shape)
            X = torch.randn((nblk, n), generator=g, device=dev, dtype=xdt)
            p = nk.device_plan(nblk, m, n, dt, torch.cuda.current_device())
            info = nk.kernel_info(dt, p.kc, p.smem_bytes)
            plans[f"{name} {spec}"] = dict(
                kc=p.kc, stages=p.stages, rows_per_stage=p.rows_per_stage,
                stage_bytes=p.stage_bytes, ctas=p.ctas,
                ctas_per_sm=p.ctas_per_sm, smem_bytes=p.smem_bytes,
                registers=info["registers"], local_bytes=info["local_bytes"],
                resident_ctas_per_sm=info["ctas_per_sm"])
            print(f"plan {name} {shape}: {p.stages} stages of "
                  f"{p.rows_per_stage} rows ({p.stage_bytes} B), {p.ctas} CTAs "
                  f"({p.ctas_per_sm}/SM), {p.smem_bytes} B shared, kc {p.kc}, "
                  f"{info['registers']} registers, {info['local_bytes']} B "
                  f"local", flush=True)
            abs_err, rel = compare(nk, A, X)
            ok = rel <= TOL[name]
            print(f"kernel vs plain {name} {shape}{' +%d' % off if off else ''}"
                  f": max rel err {rel:.3e} (tol {TOL[name]:.0e}), two calls "
                  f"bitwise equal, {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"normal_matvec[{name}] {shape} disagrees "
                                   f"with its plain version: {rel:.3e}")
            if shape[1] != NBLOCK:
                continue
            Xc = X.unsqueeze(-1).to(dt)
            At = A.transpose(1, 2)

            def library(A=A, Xc=Xc, At=At):
                return torch.bmm(At, torch.bmm(A, Xc))

            kms = cuda_ms(lambda: nk.normal_matvec(A, X))
            pms = cuda_ms(lambda: nk.normal_matvec_plain(A, X))
            lms = cuda_ms(library)
            kms2 = cuda_ms(lambda: nk.normal_matvec(A, X))
            bms, bby = bound_ms(*shape, A.element_size())
            stats[name] = dict(shape=list(shape), max_abs_err=abs_err,
                               max_err=rel, tol=TOL[name], ms=min(kms, kms2),
                               kernel_ms_runs=[kms, kms2], plain_ms=pms,
                               library_ms=lms, bound_ms=bms, bound_by=bby)
            print(f"  {name}: kernel {kms:.3f}/{kms2:.3f} ms, plain {pms:.3f} "
                  f"ms, library {lms:.3f} ms, bound {bms:.3f} ms ({bby})",
                  flush=True)
            del A, X, Xc, At
            torch.cuda.empty_cache()

    # 3. the main path
    A, xtrue, y_t = make_problem(torch, dev)
    y = pmtt.DistributedArray.to_dist(y_t)
    runs = {}
    ref_x = {}  # each path's x, for phase 14
    for label, cdt, normal, limit in [
            ("normal_f32", None, True, 1e-4),
            ("normal_bf16", torch.bfloat16, True, 1e-3),
            ("classic_f32", None, False, 1e-4)]:
        Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)],
                               compute_dtype=cdt)
        pmtt.cgls(Op, y, niter=2, tol=0.0, normal=normal)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):  # host-clock noise: keep the fastest of three
            nk.reset_launches()
            t0 = time.perf_counter()
            x, istop, iiter, r1, r2, cost = pmtt.cgls(
                Op, y, niter=NITER, tol=0.0, normal=normal)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = nk.launches
            if normal and launches < iiter:
                raise RuntimeError(f"{label}: {launches} kernel launches for "
                                   f"{iiter} iterations: the path missed the "
                                   "kernel")
        wall = min(walls)
        xv = x.array
        if xv.shape != xtrue.shape or not bool(torch.isfinite(xv).all()):
            raise RuntimeError(f"{label}: non-finite or misshapen solution")
        rel_err = float(torch.linalg.vector_norm(xv - xtrue)
                        / torch.linalg.vector_norm(xtrue))
        ref_x[label] = xv.clone()
        runs[label] = dict(rel_err=rel_err, iiter=iiter, istop=istop,
                           iters_per_s=iiter / wall, wall_s=walls,
                           launches=launches)
        print(f"cgls {label}: rel_err {rel_err:.3e} (limit {limit:.0e}), "
              f"{iiter} iters in {wall:.4f} s (best of {walls}) = "
              f"{iiter / wall:.1f} iters/s, "
              f"normal kernel launches {launches}", flush=True)
        if rel_err > limit:
            raise RuntimeError(f"{label}: rel_err {rel_err:.3e} > {limit:.0e}")
        if not normal and launches != 0:
            raise RuntimeError(f"{label}: classic path launched the kernel")
        wall_ms, busy_ms, top, kern_ms = profile_run(
            torch, lambda: pmtt.cgls(Op, y, niter=10, tol=0.0, normal=normal))
        runs[label].update(profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
                           profile_top=top, profile_kernel_ms=kern_ms,
                           kernel_share=kern_ms / busy_ms,
                           idle_share=1.0 - busy_ms / wall_ms)
        print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall (idle {1 - busy_ms / wall_ms:.1%}); "
              f"normal kernel {kern_ms:.3f} ms = {kern_ms / busy_ms:.1%} of "
              f"device time; top kernels (ms, name, count): {top}",
              flush=True)
        del Op, x
        torch.cuda.empty_cache()
    del A
    torch.cuda.empty_cache()

    # 4. a small problem on the card against the same on the CPU
    gen = torch.Generator().manual_seed(2)
    blocks = [torch.randn(64, 48, generator=gen, dtype=torch.float64)
              for _ in range(8)]
    yb = torch.randn(8 * 64, generator=gen, dtype=torch.float64)
    sols = []
    for d in ("cuda", "cpu"):
        Op = pmtt.MPIBlockDiag([MatrixMult(b, device=d) for b in blocks])
        yy = pmtt.DistributedArray.to_dist(yb, device=d)
        sols.append(pmtt.cgls(Op, yy, niter=20, tol=0.0, normal=True)[0]
                    .asarray())
    small = float(abs(sols[0] - sols[1]).max() / abs(sols[1]).max())
    print(f"small f64 problem, card vs CPU: max rel diff {small:.3e} "
          "(tol 1e-9)", flush=True)
    if not small <= 1e-9:
        raise RuntimeError(f"card and CPU disagree: {small:.3e}")

    from pylops_mpi_tpu_torch.ops import stencil_kernels as sk

    # 5. the tap-stencil kernel against its plain version
    t5 = time.perf_counter()
    sworst, sabs = stencil_taps_check(
        torch, sk, dev, g, 1003, 777,
        (torch.float32, torch.float64, torch.bfloat16, torch.float16))
    fworst, fabs = stencil_taps_check(torch, sk, dev, g, NX, NT0,
                                      (torch.float32, torch.bfloat16))
    sstats = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        st = stencil_times(torch, sk, dev, g, dt)
        st.update(max_err=max(sworst[name], fworst[name]),
                  max_abs_err=max(sabs[name], fabs[name]),
                  tol=STENCIL_TOL[name])
        sstats[name] = st
        print(f"  stencil_taps {name} {st['shape']}: kernel "
              f"{st['kernel_ms_runs'][0]:.4f}/{st['kernel_ms_runs'][1]:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms, library (conv2d) "
              f"{st['library_ms']:.4f} ms (agrees to {st['library_max_err']:.1e}), "
              f"bound {st['bound_ms']:.4f} ms ({st['bound_by']})", flush=True)
        torch.cuda.empty_cache()
    print(f"phase 5 in {time.perf_counter() - t5:.1f} s", flush=True)

    # 6. the derivative operators on the full field
    t6 = time.perf_counter()
    f32 = torch.float32
    gx = torch.Generator(device=dev).manual_seed(3)
    xf = pmtt.DistributedArray.to_dist(
        torch.randn(NX * NT0, generator=gx, device=dev))
    deriv = {}
    for label, op in [
            ("MPIFirstDerivative centered-3 edge",
             pmtt.MPIFirstDerivative((NX, NT0), edge=True, dtype=f32)),
            ("MPIFirstDerivative centered-5",
             pmtt.MPIFirstDerivative((NX, NT0), order=5, dtype=f32)),
            ("MPIFirstDerivative forward",
             pmtt.MPIFirstDerivative((NX, NT0), kind="forward", dtype=f32)),
            ("MPISecondDerivative centered edge",
             pmtt.MPISecondDerivative((NX, NT0), edge=True, dtype=f32)),
            ("MPIGradient", pmtt.MPIGradient((NX, NT0), dtype=f32))]:
        sk.reset_launches()
        y = op.matvec(xf)
        torch.cuda.synchronize()
        after_fwd = sk.launches
        xa = op.rmatvec(y)
        torch.cuda.synchronize()
        after_adj = sk.launches
        if (after_fwd, after_adj) != (1, 2):
            raise RuntimeError(f"{label}: {after_fwd} stencil launches for the "
                               f"forward and {after_adj} after the adjoint; "
                               "expected one per axis-0 apply")
        if isinstance(op, pmtt.MPIGradient):
            locs = [c._local_op() for c in op.Op.ops]
            pairs = [(d.array, lo._matvec(xf.array))
                     for d, lo in zip(y.distarrays, locs)]
            ref = sum(lo._rmatvec(d.array) for lo, d in zip(locs, y.distarrays))
        else:
            lo = op._local_op()
            pairs = [(y.array, lo._matvec(xf.array))]
            ref = lo._rmatvec(y.array)
        err = max([max_rel_err(a, b) for a, b in pairs]
                  + [max_rel_err(xa.array, ref)])
        u = rand_like(torch, pmtt, xf, gx)
        passed = pmtt.dottest(op, u=u, v=rand_like(torch, pmtt, op.matvec(u), gx),
                              rtol=1e-4)
        deriv[label] = dict(max_rel_err_vs_local=err, dottest=passed,
                            launches=[after_fwd, after_adj - after_fwd])
        print(f"{label} on ({NX}, {NT0}) f32: forward/adjoint vs local "
              f"operator max rel err {err:.2e} (tol 1e-5), dottest "
              f"{'passed' if passed else 'FAILED'}, stencil launches "
              f"{after_fwd} + {after_adj - after_fwd}", flush=True)
        if err > 1e-5 or not passed:
            raise RuntimeError(f"{label} disagrees with its local operator or "
                               "fails the dot test")
        del op, y, xa, pairs, ref, u
        torch.cuda.empty_cache()
    del xf
    print(f"phase 6 in {time.perf_counter() - t6:.1f} s", flush=True)

    # 7. the Gradient-regularized post-stack inversion (the main path of
    # the tap kernel) and the Laplacian-regularized pipeline beside it
    t7 = time.perf_counter()
    wav = pmtt.models.ricker(np.arange(31) * 0.004, f0=15)[0]
    m = layered_model(torch, NX, NT0, dev, seed=4)
    StackOp, ystack, Op = gradient_poststack(torch, pmtt, m, wav, NITER, f32)
    d = ystack[0].array
    pmtt.cgls(StackOp, ystack, niter=2, damp=DAMP, tol=0.0)  # warm-up
    torch.cuda.synchronize()
    post = {}
    walls = []
    for _ in range(3):  # host-clock noise: keep the fastest of three
        sk.reset_launches()
        nk.reset_launches()
        t0 = time.perf_counter()
        x, istop, iiter, r1, r2, cost = pmtt.cgls(StackOp, ystack,
                                                  niter=NITER, damp=DAMP,
                                                  tol=0.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        slaunch = sk.launches
    if slaunch < 2 * iiter:
        raise RuntimeError(f"gradient solve: {slaunch} stencil launches for "
                           f"{iiter} iterations: the path missed the kernel")
    c = cost.double().cpu().numpy()
    if np.any(np.diff(c) > 1e-5 * c[:-1]):
        raise RuntimeError(f"gradient solve: cost history increases: {c}")
    st = solve_stats(torch, pmtt, Op, m, d, x, c)
    ref_x["gradient"] = x.array.clone()
    wall = min(walls)
    post["gradient_cgls"] = dict(iters_per_s=iiter / wall, wall_s=walls,
                                 iiter=iiter, stencil_launches=slaunch,
                                 launches_per_iter=slaunch / iiter,
                                 normal_launches=nk.launches, **st)
    print(f"gradient-regularized CGLS ({NX}, {NT0}) f32, eps {EPS_R}: "
          f"{iiter} iters in {wall:.4f} s (best of {walls}) = "
          f"{iiter / wall:.1f} iters/s; stencil launches {slaunch} "
          f"({slaunch / iiter:.2f}/iter); data residual "
          f"{st['data_residual']:.3e}, model error {st['model_error']:.3e}, "
          f"stacked residual {st['stacked_residual']:.4f} (limit "
          f"{RESID_LIMIT})", flush=True)
    if not st["stacked_residual"] <= RESID_LIMIT:
        raise RuntimeError(f"gradient solve: residual {st['stacked_residual']:.4f}"
                           f" above {RESID_LIMIT}")
    wall_ms, busy_ms, top, _ = profile_run(
        torch, lambda: pmtt.cgls(StackOp, ystack, niter=10, damp=DAMP, tol=0.0))
    post["gradient_cgls"].update(profile_wall_ms=wall_ms,
                                 profile_device_ms=busy_ms, profile_top=top)
    print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall; top kernels (ms, name, count): {top}",
          flush=True)
    del x, StackOp, ystack
    torch.cuda.empty_cache()

    dimg = d.view(NX, NT0)
    walls = []
    for _ in range(3):
        sk.reset_launches()
        t0 = time.perf_counter()
        xi, _ = pmtt.models.poststack_inversion(dimg, wav, niter=NITER,
                                                epsR=EPS_R, damp=DAMP,
                                                dtype=f32)
        walls.append(time.perf_counter() - t0)
    if sk.launches != 0:
        raise RuntimeError("the Laplacian pipeline launched the stencil kernel")
    st = solve_stats(torch, pmtt, Op, m, d, xi, None)
    wall = min(walls)
    post["laplacian_poststack_inversion"] = dict(
        iters_per_s=NITER / wall, wall_s=walls, stencil_launches=0, **st)
    print(f"poststack_inversion (Laplacian, eps {EPS_R}) ({NX}, {NT0}) f32: "
          f"{NITER} iters, operator build and host copy included, in "
          f"{wall:.4f} s (best of {walls}) = {NITER / wall:.1f} iters/s; data "
          f"residual {st['data_residual']:.3e}, model error "
          f"{st['model_error']:.3e}; stencil launches 0", flush=True)
    wall_ms, busy_ms, top, _ = profile_run(
        torch, lambda: pmtt.models.poststack_inversion(
            dimg, wav, niter=10, epsR=EPS_R, damp=DAMP, dtype=f32))
    post["laplacian_poststack_inversion"].update(
        profile_wall_ms=wall_ms, profile_device_ms=busy_ms, profile_top=top)
    print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall; top kernels (ms, name, count): {top}",
          flush=True)
    del xi, dimg, d, m, Op
    torch.cuda.empty_cache()
    print(f"phase 7 in {time.perf_counter() - t7:.1f} s", flush=True)

    # 8-10. this slice's paths: MDD at full width, the sparse-spike
    # reflectivity inversion, and small f64 problems on the card and the CPU
    kernel_mods = (nk, sk)
    t8 = time.perf_counter()
    mdd_res = mdd_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 8 in {time.perf_counter() - t8:.1f} s", flush=True)
    t9 = time.perf_counter()
    refl = reflectivity_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 9 in {time.perf_counter() - t9:.1f} s", flush=True)
    t10 = time.perf_counter()
    gaps = card_vs_cpu_phase(torch, pmtt)
    print(f"phase 10 in {time.perf_counter() - t10:.1f} s", flush=True)

    # 11-13. slice 5's paths: the stacking operators on slice 1's blocks,
    # non-stationary deconvolution, least-squares migration at full width
    t11 = time.perf_counter()
    stack_res = stacking_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 11 in {time.perf_counter() - t11:.1f} s", flush=True)
    t12 = time.perf_counter()
    ns_res = nonstat_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 12 in {time.perf_counter() - t12:.1f} s", flush=True)
    t13 = time.perf_counter()
    lsm_res = lsm_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 13 in {time.perf_counter() - t13:.1f} s", flush=True)

    # 14-15. this slice's process group: a group of one rank over NCCL on
    # the card, then two and three ranks sharing the card over gloo
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    group1, x10 = group_of_one_phase(torch, pmtt, kernel_mods, dev, ref_x)
    del ref_x
    torch.cuda.empty_cache()
    print(f"phase 14 in {time.perf_counter() - t14:.1f} s", flush=True)
    t15 = time.perf_counter()
    shared = shared_card_phase(torch, pmtt, here, x10)
    print(f"phase 15 in {time.perf_counter() - t15:.1f} s", flush=True)
    del x10

    # 16. this slice: the stacks, MDD, non-stationary deconvolution and
    # LSM across two to four ranks sharing the card over gloo
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    slice7 = slice7_phase(torch, pmtt, here, dev)
    print(f"phase 16 in {time.perf_counter() - t16:.1f} s", flush=True)

    # 17-18. slice 8: the dense matmul and the pencil FFTs at full width
    # with no group, then across two to four gloo ranks on the card
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    slice8 = matmul_fft_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 17 in {time.perf_counter() - t17:.1f} s", flush=True)
    t18 = time.perf_counter()
    slice8_ranks = slice8_ranks_phase(torch, pmtt, here, dev)
    print(f"phase 18 in {time.perf_counter() - t18:.1f} s", flush=True)

    # 19-20. slice 9: the solver tiers at full width with no group (the CA
    # engines under a group of one), then across two and three gloo ranks
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    slice9 = solver_tiers_phase(torch, pmtt, kernel_mods, dev)
    print(f"phase 19 in {time.perf_counter() - t19:.1f} s", flush=True)
    t20 = time.perf_counter()
    slice9_ranks = slice9_ranks_phase(torch, pmtt, here, dev)
    print(f"phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)

    # 21. slice 10: the solve service at full width, a world of one
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    slice10 = service_phase(torch, pmtt, here, dev)
    print(f"phase 21 in {time.perf_counter() - t21:.1f} s", flush=True)

    # 22. slice 11: every fused loop through the bank of captured graphs
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    slice11 = graphs_phase(torch, pmtt, kernel_mods, here, dev, slice10)
    print(f"phase 22 in {time.perf_counter() - t22:.1f} s", flush=True)

    # 23. slice 12: the resilience tier at phase 3's width
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    slice12 = resilience_phase(torch, pmtt, kernel_mods, here, dev)
    print(f"phase 23 in {time.perf_counter() - t23:.1f} s", flush=True)

    # 24. slice 13: the training path (24.2 is its main path: the tap
    # kernel forward and backward through torch.autograd)
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    slice13 = autodiff_phase(torch, pmtt, kernel_mods, here, dev)
    print(f"phase 24 in {time.perf_counter() - t24:.1f} s", flush=True)

    # 25. slice 14: the cost model and the tuner at the main path's width
    t25 = time.perf_counter()
    slice14 = tuner_phase(torch, pmtt, kernel_mods, here, dev)
    print(f"phase 25 in {time.perf_counter() - t25:.1f} s", flush=True)

    # 26. slice 15: the resharding planner, the spill tier and the
    # in-place recovery (26.3 is its main path, in the survivor)
    torch.cuda.empty_cache()
    t26 = time.perf_counter()
    slice15 = reshard_phase(torch, pmtt, kernel_mods, here, dev)
    print(f"phase 26 in {time.perf_counter() - t26:.1f} s", flush=True)

    kernels = []
    for name, run in (("float32", "normal_f32"), ("bfloat16", "normal_bf16")):
        s = stats[name]
        r = runs[run]
        kernels.append(dict(
            name=f"normal_matvec[{name}]", route="cuda", source=SRC,
            replaces=REPLACES[name], launches=r["launches"],
            launches_per_iter=r["launches"] / r["iiter"],
            # phase 15 runs the f32 main path only
            shared_card_launches_per_rank={
                n: [o["normal_launches"] for o in v["ranks"]]
                for n, v in shared.items()} if name == "float32" else None,
            max_abs_err=s["max_abs_err"], max_err=s["max_err"], tol=s["tol"],
            ms=s["ms"], kernel_ms=s["ms"], kernel_ms_runs=s["kernel_ms_runs"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shape=s["shape"], dtype=name,
            # phase 22: the same path through the bank of captured graphs
            # (50 iterations): the kernel's events in the profile of the
            # graph run, and that run's replays of 8 iterations
            graph_launches=slice11[run]["graph_kernel_events"],
            graph_replays=slice11[run]["graph_replays"],
            # phase 23.1: resilient_solve's rung at this dtype (bf16 to
            # the NaN, f32 after the restart)
            resilience_launches=slice12["resilient_eager"][
                "launches_by_dtype"].get(name, 0),
            # phase 25.1: the tuned solve (the banked plan replayed),
            # counted from 0 just before it, and the same solve under a
            # banked two_sweep plan (0)
            tuned_launches=slice14["race"][
                "f32" if name == "float32" else "bf16"]["launches"],
            two_sweep_plan_launches=slice14["race"][
                "f32" if name == "float32" else "bf16"][
                    "two_sweep_launches"],
            # phase 26.3: the survivor's resumed cgls_segmented(normal=
            # True) after the in-place recovery (f32), counted from 0 just
            # before it, and the iterations it ran
            inplace_launches=(slice15["inplace"]["inplace"]["launches"]
                              if name == "float32" else None),
            inplace_resumed_iters=(
                slice15["inplace"]["inplace"]["iiter"]
                - slice15["inplace"]["inplace"]["resumed_from"]
                if name == "float32" else None)))
    # slice 9's paths through the normal kernel (f32 storage): PCGLS
    # normal=True per arm (10 iterations, counts reset just before) and
    # pipelined CGLS normal=True (its setup applies the kernel once)
    kernels[0]["slice9_launches_per_iter"] = dict(
        {f"pcgls_normal_{k}": slice9["precond"][k]["launches_per_iter"]
         for k in ("none", "jacobi", "block_jacobi")},
        pipelined_cgls_normal=slice9["ca"]["cgls_normal"]["pipelined"][
            "normal_launches_per_iter"])
    gr, gr22 = post["gradient_cgls"], slice11["gradient_cgls"]
    for name in ("float32", "bfloat16"):
        st = sstats[name]
        kernels.append(dict(
            name=f"stencil_taps[{name}]", route="cuda", source=STENCIL_SRC,
            replaces=STENCIL_REPLACES, launches=gr["stencil_launches"],
            launches_per_iter=gr["launches_per_iter"],
            shared_card_launches_per_rank={
                n: [o["stencil_launches"] for o in v["ranks"]]
                for n, v in shared.items()} if name == "float32" else None,
            main_path_dtype="float32", max_abs_err=st["max_abs_err"],
            max_err=st["max_err"], tol=st["tol"], ms=st["kernel_ms"],
            kernel_ms=st["kernel_ms"], kernel_ms_runs=st["kernel_ms_runs"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"],
            shape=st["shape"], dtype=name,
            # phase 22's Gradient CGLS through the bank (NITER_SLOW_22),
            # counted as for the normal kernel
            graph_launches=(gr22["graph_kernel_events"]
                            if name == "float32" else None),
            graph_replays=(gr22["graph_replays"]
                           if name == "float32" else None),
            # phase 25.1b: the Gradient-regularized CGLS under TUNE=on
            tuned_launches=(slice14["gradient"]["launches_tuned"]
                            if name == "float32" else None)))
    # phase 24: the tap kernel on the transposed taps, the backward of its
    # autograd rule; launches in 24.2's gradient descent (f32)
    ad = slice13["objective"]
    for name in ("float32", "bfloat16"):
        st = slice13["tap_grad"][name]
        kernels.append(dict(
            name=f"stencil_taps_backward[{name}]", route="cuda",
            source=STENCIL_SRC, replaces=STENCIL_REPLACES,
            launches=ad["launches_bwd"],
            launches_per_step=ad["launches_bwd"] / ad["steps"],
            shared_card_launches_per_rank=(ad["two_ranks"]["launches_bwd"]
                                           if name == "float32" else None),
            main_path_dtype="float32", max_abs_err=st["max_abs_err"],
            max_err=st["max_err"], tol=st["tol"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"],
            shape=st["shape"], dtype=name))
    print(json.dumps({"card": card, "runs": runs,
                      "float16_kernel": stats["float16"],
                      "normal_plans": plans,
                      "stencil_small_max_err": sworst, "derivatives": deriv,
                      "poststack": post, "mdd": mdd_res,
                      "reflectivity": refl, "card_vs_cpu_f64": gaps,
                      "stacking": stack_res, "nonstationary": ns_res,
                      "lsm": lsm_res, "group_of_one": group1,
                      "shared_card": shared, "slice7_ranks": slice7,
                      "slice8": slice8, "slice8_ranks": slice8_ranks,
                      "slice9": slice9, "slice9_ranks": slice9_ranks,
                      "slice10": slice10, "slice11": slice11,
                      "slice12": slice12, "slice13": slice13,
                      "slice14": slice14, "slice15": slice15}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--resilience-worker":
        resilience_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--inplace-worker":
        inplace_worker(sys.argv[2:])
    sys.exit(main())
