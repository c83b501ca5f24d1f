#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--out RECORD.json] [--kernels-only | --lm-only]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device — the card's name and power limit (a CUDA device is required);
2. build  — ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``
   (the ptxas report is printed);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, at the main paths' shapes, with times from CUDA events beside the
   bound (bytes over 3.35 TB/s or operations over the peak of the dtype;
   a complex multiply-add counts 8 flops) and a cuSPARSE CSR product
   (``A @ x``) as the library yardstick of each SpMV:

   * real: ``ell_gather`` on the Hubbard(12,6) operator at n_b = 1 and 512
     and on SpinChainXXZ(24,12) at n_b = 64, ``cheb_dia`` on the Hubbard
     DIA form at n_b = 512, each in fp64 (≤ 1e-13 relative to max|y|) and
     fp32 (≤ 1e-5); ``ell_gather`` on RoadNet(48000) at n_b = 64 in fp64;
   * complex: ``ell_gather`` and ``cheb_dia`` on Exciton(L=30) at n_b = 1
     and 384 in complex128 (bit-equal required) and complex64 (≤ 1e-5),
     ``cheb_dia`` on TopIns(40) at n_b = 384 in complex128;
   * the bundle widths of the vertical layer: ``cheb_dia`` at Hubbard
     n_b = 128 (fp64; the layouts phase's pillar 1 × 4) and on the
     Exciton(L=30) pillar 1 × 4 one-shard operator padded to D_pad =
     680,944 at n_b = 96 (complex128; the layouts phase's split at the
     pillar solve's bundle width); ``ell_gather`` and its epilogue entry
     on the RoadNet pillar 1 × 8 solve's one-shard RCM operator at
     n_b = 8 and on the four shard blocks of the HubNet(48000) panel
     4 × 2 solve's commvol operator (with their halo rows) at n_b = 32,
     fp64;
   * the 8-shard solves' blocks, one launch for all 8 row shards (the
     engines' grouped launch), on HubNet(48000) and RoadNet(48000) at
     n_b = 64 in fp64: the compressed cyclic split-phase step's local
     block on the shards' rows and its halo block with the epilogue on
     the halo buffer (from the local block's accumulator), and the
     depth-3 s-step filter's step 0 on the extended blocks ``[P, R + G,
     64]`` (whole, with and without the epilogue, and split: the local
     block on the strided owned rows, then the rest); each bit-equal to
     its plain version (``ref.ell_grouped_ref``), to the padded blocks'
     plain version shard by shard and to 8 launches of one shard each
     (prepared beforehand), timed beside both, its bound (the epilogue's
     w1 read once with x where it is x's leading rows) and cuSPARSE's
     ``A @ x`` over the whole operator.

   The DIA step's bound counts the compact operator its kernel reads,
   once (the earlier formula, which counted the dense dvals, is kept
   beside it as ``bound_ms_dense``). Each case also prints the slab width
   the rule chose (``kernels/plan.py``), the bytes of its schedule with x
   read once and the effective bytes (ms × 3.35 TB/s). Sweeps of forced
   slab widths (Hubbard n_b = 512 fp64, the step and the ELL product;
   Exciton n_b = 384 complex128, the step; each held to the plain version)
   are what ``plan.SLAB_ROW_BYTES`` is set from, and the filter's
   ``Y.add_(T, alpha=mu)`` is timed at both steps' shapes;
   The epilogue entry of ``ell_gather`` (``ell_gather_cheb``: the
   product and the Chebyshev step's ``2a·y + 2b·w1 − w2`` in one launch)
   is held bit for bit to its plain version in fp64 and complex128 at
   Hubbard n_b = 512, RoadNet n_b = 64 and Exciton n_b = 384 (complex64
   ≤ 1e-5), against the same cuSPARSE product;
4. engines — the horizontal layer on the card: Hubbard(12,6) in fp64 at
   n_b = 512 and Exciton(L=30) in complex128 at n_b = 384 at P = 4 row
   shards, and RoadNet(48000) in fp64 at n_b = 64 at P = 8 (the P = 8
   solve's shape), each of the eight halo engines (a2a plain and split-phase;
   compressed cyclic and matching, plain, split-phase and pipelined)
   with its SpMV, fused step and exchange timed, held bit for bit to the
   a2a engine (and that one to the same engine from the plain versions
   on the card), the split-phase steps repeated; its bytes equal to the
   prediction (a2a ``P·P·L·n_b·S``, compressed ``P·H·n_b·S``); L, H,
   Σ n_vc, χ and the halo share printed. Then TSQR of a random
   [853,776 × 512] block at P = 4 (‖V − QR‖/‖V‖ ≤ 1e-13, ‖QᵀQ − I‖ ≤
   1e-12, |diag R| equal to the one-shard QR's to 1e-10) and a degree-32
   filter at P = 4 against the one-shard DIA route (≤ 1e-10 of max|Y|).
   The exchange on one card is a device copy, not a network transfer.
   Then the s-step filter (``make_sstep_cheb``): RoadNet(48000) at P = 8
   (fp64, n_b = 64, degree 16) and Exciton(L=30) at P = 4 (complex128,
   n_b = 384, degree 8), at s = 2 and 3, through a2a, compressed-cyclic
   with and without overlap and compressed-matching, kernels on: each
   filter bit-equal to the s = 1 filter through the same engine (the
   fused step), s = 3 on RoadNet and s = 2 on Exciton through a2a also to
   the same s-step filter from the plain versions on the card; its bytes
   and calls equal to ``P·sstep_collectives`` of ``comm_plan(sstep=s)``;
   the filter's ms, exchanges and launches beside the s = 1 filter's;
5. layouts — the vertical layer at P = 4 shards in the layouts stack
   4 × 1, panel 2 × 2 and pillar 1 × 4, on Hubbard(12,6) (fp64,
   N_s = 512) and Exciton(L=30) (complex128, N_s = 384), the filter's
   engine compressed-matching plain (kernels on): for each layout and
   each redistribution ``impl`` (explicit, gspmd), ``to_panel``, one
   fused filter step over every bundle and ``to_stack``, timed; the
   reassembled step bit-equal to the same step at full width through the
   N_row-shard engine (at 1 × 4 the one-shard DIA step on the operator
   padded to D_pad), and that one to the same engine from the plain
   versions; the round trip bit-exact; the redistribution's bytes equal to Eqs. 17–18
   (``N_s·D_pad·(1 − 1/N_col)·S``), the step's halo bytes over the
   bundles to ``N_col · N_row·H·n_c·S``; peak memory. Then one outer
   iteration of the Exciton solve twice from one seeded block, held bit
   for bit, its SHA-256 printed (to compare runs);
6. plan — the χ-driven planner on the card's own machine model:

   * the fit: ``launch/dryrun.py::fit_machine`` on Hubbard(12,6), fp64,
     N_s = 512, P = 4 (the layouts phase's operator and splits 4 × 1,
     2 × 2, 1 × 4; the a2a step, kernels on, at full and tiny width; b_m
     from a 1 GiB copy), each sample measured beside the fitted model's
     time; it fails if b_c is not finite or κ ≤ 0. The fit is written
     beside the ``--out`` record (``chiprun_out/`` without one);
   * rankings against measurement: ``plan_layout`` with the fit on
     Hubbard(12,6) (fp64, N_s = 512) and Exciton(L=30) (complex128,
     N_s = 384) at P = 4 over the three splits, equal rows, kernel axis
     on; for each split the layouts phase's candidate (compressed
     matching, no overlap; a2a at 1 × 4) predicted as one card runs it
     (``P·t_iter`` a step, ``P·t_redist`` a redistribution) beside the
     layouts phase's measured step and redistributions; each plan's best
     three and its host seconds;
   * sampled against exact: HubNet(48000) at P = 8, the exact χ₁, χ₂, χ₃
     beside ``estimate_comm``'s centre and ``ChiBand`` at the default
     fraction and at 0.25;

   * the sampled planner: ``plan_layout(plan_mode="sampled")`` of
     HubNet(48000) at P = 8 with the fit (the sampled χ and commvol
     descent), its best three and host seconds;

   the ``--layout auto`` solve this fit drives runs among the solves;
   after the solves, ``plan_layout``'s s ∈ {1, 3} stack candidates at
   P = 8 for HubNet and RoadNet with the fit, each one card's predicted
   step (``P·t_iter`` at the solve's mean degree) beside the measured
   wall per filter step of the s = 1 and s = 3 solves;
7. solves — ``repro_torch.launch.solve`` in-process, kernels on, each with
   the launch counts set to 0 just before it and read just after, every
   returned pair re-checked on the host against a scipy CSR of the port's
   own generator (‖A·x − θ·x‖ ≤ 1e-8):

   * Hubbard(10,5, U=25, ranpot=1) (D = 63,504; the earlier phases'
     (12,6) took 397 s here) at N_s = 512, fp64, τ just below the
     spectrum, tol cut to 5e-9 and n_target to 8; both kernels must
     launch;
   * Exciton(L=20) (the exciton200 config cut to one card, and from the
     earlier phases' L = 30 to keep the run inside its time limit: D =
     206,763) at N_s = 384, complex128, τ just below the spectrum,
     n_target cut to 8 (its depth); both kernels must launch;
   * Exciton(L=20) in the pillar layout 1 × 4 (the exciton200 config's
     production layout, paper Table 4) at N_s = 384, n_target cut from
     the config's 100 to 8 (the stack solve's; 16 until the service
     phase came in):
     ``cheb_dia`` (the bundles' steps) and ``ell_gather`` must launch, the
     epilogue entry must not; every eigenvalue the stack solve returned
     (at least 8) equal to one of its own to 1e-9, with multiplicity;
     those of its lowest 8 that the stack solve stepped over (FD stops
     once 8 pairs of the window have converged) are printed;
   * RoadNet(48000) (the roadnet48k config's matrix) at N_s = 64,
     n_target = 16, fp64, τ just above the spectrum: no DIA form, so the
     ELL kernel and its epilogue entry must launch and the DIA kernel
     must not;
   * the same RoadNet solve at 8 row shards (``--n-row 8 --spmv-comm
     compressed --spmv-overlap``: the split-phase cyclic engine), its
     eigenvalues equal to the one-shard solve's to 1e-9;
   * on every ELL-route solve, ``ell_gather_cheb`` launched once a fused
     step for all the row shards of each bundle: ``N_col · Σ (degree −
     1)`` launches;
   * that solve with the s-step filter (``--spmv-sstep 3``): its
     iterations, degrees and eigenvalues equal to the 8-shard solve's bit
     for bit;
   * HubNet(48000) (the hubnet48k config's matrix) at 8 row shards with
     the matching rounds (``--spmv-schedule matching``), N_s = 64,
     n_target = 16, τ 0.1 above its largest eigenvalue (``eigsh``), and
     that solve with ``--spmv-sstep 3``, equal to it bit for bit in
     iterations, degrees and eigenvalues;
   * the same HubNet solve in the panel layout 4 × 2 on the planned
     commvol row map (``--spmv-balance commvol``, D_pad = 72,000): the
     ELL kernel and its epilogue entry must launch, the DIA kernel must
     not; its eigenvalues equal to the 8-shard solve's to 1e-9;
   * the same HubNet solve with ``--layout auto --n-row 8 --plan-mode
     auto --spmv-sstep 3 --machine <the plan phase's fit>``: the
     planner's report, which must list ``+s3`` candidates (the s-step
     axis needs the exact pattern pass; ``auto`` takes it at this size),
     and the split, layout, engine and depth it ran; the ELL kernel and
     its epilogue entry must launch, the DIA kernel must not; its
     eigenvalues equal to the 8-shard solve's to 1e-9;
   * the RoadNet solve in the pillar layout 1 × 8 on the RCM row map
     (``--spmv-reorder rcm``): the ELL route with no halo in the filter;
     its eigenvalues equal to the one-shard solve's to 1e-9;
7b. ranks — one process per shard (``repro_torch.core.ranks``): three
   solves, each first in one process on the card through the CLI, then on
   4 gloo ranks sharing the card, one ``python -m torch.distributed.run
   --standalone --nproc-per-node 4 chip_smoke.py --ranks-worker SPEC``
   launch for all (the kernels built before it, so the ranks only load
   them; it starts before phase 7, its ranks import and make their CUDA
   contexts there and wait idle for SPEC), each rank its own shard's
   rows and its own bundle, every
   collective a ``torch.distributed`` call staged through pinned host
   memory (gloo, host-staged, 4 ranks on one card: not a network):
   RoadNet(48000) stack 4 × 1 with the compressed cyclic split-phase
   engine and panel 2 × 2 (``ell_gather`` and ``ell_gather_cheb`` on
   every rank), Hubbard(10,5) pillar 1 × 4 (``cheb_dia`` on every rank's
   bundle), each at the solves phase's N_s, dtype and target and its
   n_target but the Hubbard pillar's, cut 8 → 4 for the phase's 90 s
   (its stack level on the compressed matching rounds: they move 2.4×
   fewer bytes than a2a over gloo's loopback TCP). The launch starts
   first; the one-process solves run beside the ranks.
   Checks: eigenvalues within 1e-9 of the one-process solve's,
   iterations within one, the host residual ≤ 1e-8; each rank's
   launches of its route's step kernel equal to Σ(degree − 1) of its own
   bundle's filters, ``ell_gather`` on every rank; where the degrees
   agree, the bytes and calls summed over the ranks equal to the one
   process's; and, first, one fused step of each rank at the
   RoadNet(48000) P = 4 shape (n_b = 64, fp64; compressed split-phase
   and a2a) and one s-step filter (degree 9, s = 3, compressed cyclic
   split-phase) bit-equal to the one-process grouped launches' rows. In
   the same launch: RoadNet(48000) stack 4 × 1 with the s = 3 filter
   (compressed cyclic split-phase, N_s = 64, n_target 16), held as the
   others are and, where its path is the one process's, each rank's
   launches of every kernel equal to the one process's (one grouped
   launch for 4 shards is one launch a rank); then the service on the 4
   ranks: the two ``SVC_REQUESTS`` on RoadNet(48000), planned by rank 0
   over 4 shards (the builtin ``h100-1card``) through a plan cache,
   batched and supervised (checkpoints every ``SVC_CKPT_INTERVAL``
   iterations written by rank 0, a fault on every rank at
   ``SVC_FAULT_AT``), against the one-process service over 4 shards run
   beside it: the same planned cell, one restart, each request's
   eigenvalues to 1e-9 with its iterations and degrees equal, the host
   residual ≤ 1e-8; then request "b" alone on the ranks with the same
   cache: a hit, no planner call, bit-equal to "b" batched. One line
   gives each run's wall, its halo exchange ms a step, its
   redistribution ms and its staged bytes;
8. service — the eigensolve service (``repro_torch.service``) on the
   roadnet48k config at full width, RoadNet(48000), fp64, N_s = 64 a
   request, two requests ("a": n_target 16, seed 11; "b": n_target 8,
   seed 22; τ the RoadNet solves', tol 1e-10), planned by the service
   over 8 shards with the plan phase's fit and the kernels, through one
   plan cache:

   * run 1, the Python API: both requests batched into one panel, a
     supervised drain with a checkpoint every 20 iterations (each
     ≈ 49 MB) and a fault injected once at iteration 30, which the
     supervisor restores from iteration 20;
   * runs 2 and 3: each request alone through ``python -m
     repro_torch.launch.solve --serve`` (in process), no checkpoints;
   * checks: one restart; each request's eigenvalues, residuals,
     iterations, SpMVs and degrees equal to its solo run's bit for bit;
     the planner called once over the three drains and hit at least
     twice; every returned pair's host residual ≤ 1e-8; request "a"'s
     eigenvalues equal to the RoadNet solve's to 1e-9; ``ell_gather_cheb``
     launched in every run, the batch's launches fewer than the solo
     runs' together and equal to what the histories predict (per
     iteration, the larger pending degree less one, times the solo runs'
     launches a fused step, the replayed iterations 20–29 twice);
   * the planned cell's filter operator through ``ell_gather`` and its
     epilogue entry at the batch's bundle width (128 / N_col), held
     bit for bit to the plain versions, against cuSPARSE (kernel cases);
9. analysis — the static communication checks (``repro_torch.analysis``)
   on the card, kernels on, each engine's collectives and contractions
   recorded in order (``CommTrace``):

   * census cells, one FD macro-iteration each (TSQR, the redistribution,
     a degree-8 filter, the way back, the Gram all-reduce) at full width:
     Hubbard(12,6) fp64, N_s = 512, panel 2 × 2, a2a; HubNet(48000),
     N_s = 64, stack 8 × 1, compressed-matching split-phase, at s = 1 and
     s = 3; RoadNet(48000), N_s = 64, pillar 1 × 8 on the RCM map (stack
     terms only). Each must attribute every collective to a predicted
     term, with none missing, and launch the kernels (the record's
     launches per cell, and the kernels' own counts over the cells for
     ``ell_gather`` and ``ell_gather_cheb``); each logs its predicted
     terms beside the measured multiset;
   * the split-phase proof of the six engine combos (kernels off and on),
     the s-step groups, and the round-pipeline proof on SpinChainXXZ(10,5)
     over 4 shards and on the HubNet(48000) operator over 8 shards at
     n_b = 64: every split-phase engine must pass on a real side stream;
     the kernelized engines bit-equal to the plain ones;
   * the negative controls, which must be caught: the plain engines fail
     (B), ``pipeline=False`` fails (c), an exchange started after the
     local blocks fails (A), an engine that drops its wait is a race, a
     planted ``psum`` is unattributed and a skipped Gram is missing;
10. lm — the LM serving path (``repro_torch.models``), which has no
    kernel of its own (plain torch ops, TF32 off):

   * card against CPU: each of the ten SMOKE configs through the port on
     the card and on the CPU, fp32, the same weights and batch: prefill
     of two 128-token prompts and 3 greedy decode steps, every logit and
     decode-state leaf within 1e-4 of its largest magnitude (the
     encoder, hubert, its prefill and encoder forward);
   * the six archs one card holds (qwen3-0.6b, internvl2-1b,
     granite-moe-3b-a800m, hymba-1.5b, rwkv6-1.6b, hubert-xlarge) at
     full width and depth in bf16, random weights from a seed, through
     ``make_prefill_step`` / ``make_decode_step``: B = 2, a 512-token
     prompt (internvl2: patches and tokens, as ``make_batch`` builds
     it; hymba: 2,040 tokens, so its 2,048-deep sliding-window rings
     wrap during decode), 16 greedy decode steps; hubert the encoder
     forward over 512 frames. Prefill ms and decode ms per token (CUDA
     events, after a warm call) and the peak device memory, each beside
     the card's name and power limit. Each decodable one then, in fp32
     (TF32 off): the last decode step's logits against the last position
     of one forward of the grown sequence, within 2e-3 (absolute and
     relative; the MoE at a capacity that drops no token). RWKV6 runs its
     per-token WKV there and is held in fp64, its fp32 difference
     recorded: at full depth with random weights it amplifies fp32
     rounding about twofold a layer; the chunked WKV's prefill against
     the per-token one is recorded too;
   * the four it cannot hold (nemotron-4-15b, qwen2.5-32b,
     deepseek-67b, arctic-480b) at full width with depth cut to 2
     layers, in bf16: the same run, its logits finite and of the right
     shapes;
11. train — the LM training path (``make_train_step``: autograd through
    the loss, the port's AdamW; ``launch/train.py::train``), no kernel of
    its own:

   * card against CPU: each of the ten SMOKE configs, fp32, the same
     weights and batch, two train steps on the CPU, each also taken on
     the card from the CPU's state before it: loss and grad norm within
     1e-4 (relative), every updated parameter within 1e-4 of its leaf's
     largest magnitude, except elements whose gradient lies below 1e-3 of
     the leaf's largest (Adam's ``g / (|g| + eps)`` flips with rounding
     there), held to 2·lr (two free-running steps amplify fp32 rounding
     on the zero-init leaves past that, in the reference too);
   * qwen3-0.6b at full width and depth in bf16, fp32 moments, B = 2 ×
     512 tokens of ``TokenPipeline``, 10 steps through ``train(smoke=
     False, opt_overrides={"lr": 3e-3})``: every loss finite, the mean of
     the last three below the first; then step ms (CUDA events, the
     model warm), tokens/s and the peak device memory;
   * granite-moe-3b-a800m (32 layers, 40 experts, top-8) at full width
     and depth in bf16 with int8 moments (the quantized path arctic-480b's
     config uses; arctic cannot train on one card) through
     ``make_train_step``, 4 steps: losses finite, each moment's (codes,
     scales) of the reference's per-leaf shape; step ms and peak memory;
   * the exact resume: qwen3-0.6b SMOKE through ``train`` on the card,
     a 10-step run against a 7-step run resumed to 10, the parameters
     bit-equal, under ``torch.use_deterministic_algorithms``;
12. dryrun — the dry-run on one card (``python -m repro_torch.launch.dryrun``,
    in process), the launch counts set to 0 before it and read after:

   * ``--eigen roadnet48k --layout panel --spmv-comm compressed
     --spmv-schedule matching --plan --verify`` over the 4 × 2 grid: the
     plan fields at the production mesh (256 chips), then one
     macro-iteration (TSQR, the redistribution, a degree-32 filter, the
     way back) of RoadNet(48000) in fp32 with the kernels, counted by the
     op census and timed; every collective attributed, each kind's bytes
     equal to the planner's prediction for the grid;
   * ``--eigen hubbard16 --layout stack`` on one shard, the config's
     Hubbard(16,8) cut to (12,6) for the grid: the ``cheb_dia`` route;
   * ``--arch qwen3-0.6b --shape train_4k`` and ``--arch arctic-480b
     --shape decode_32k``: the steps counted on the meta device (no card
     memory), their per-chip placement on the 16 × 16 mesh;
   * ``examples/torch_quickstart.py`` on the card;
   * each kernel's census bytes for one launch (RoadNet(48000) at
     n_b = 64 through ``ell_gather`` and its epilogue entry, also with
     w1 = x, Hubbard(8,4)'s DIA form through ``cheb_dia``) equal to this
     script's bound bytes for that launch; every record field finite; each eigen cell's measured ms
     printed beside its roofline ``t_memory_s`` and their ratio.

The last two lines of standard output are the card's ``nvidia-smi`` name
and power limit, then ``{"ok": true, "device": {...}}``; the line before
them is the ``kernels`` record (both kernels and the epilogue entry,
each with its launches on the solves and the service's three runs, by
run, and its dtype cases).
``--kernels-only`` stops after phase 3 and prints no result line (for
tuning the kernels; the full run is the check); ``--lm-only`` runs phases
10 and 11 alone, with no kernel build and no result line;
``--dryrun-only`` runs the build and phase 12 alone, with no result line;
``--ranks-only`` the build and phase 7b alone (its targets from ``eigsh``
as the solves phase takes them), with no result line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# outside the tensor cores; a complex dtype at the peak of its planes' type
PEAK_FLOPS = {"float64": 33.5e12, "float32": 67e12, "complex128": 33.5e12,
              "complex64": 67e12}
TOL = {"float64": 1e-13, "float32": 1e-5, "complex128": 1e-13,
       "complex64": 1e-5}
BITWISE = ("complex128",)  # held bit for bit to the plain version
HUBBARD = dict(n_sites=12, n_fermions=6, U=25.0, ranpot=1.0)
SPIN = dict(n_sites=24, n_up=12)
N_SEARCH = 512
# the Hubbard solve's depth, cut from 16 to 8 to keep the whole run
# inside its time limit once the plan phase came in (N_s stays 512)
N_TARGET = 8
MAX_ITERS = 80  # 54 needed at the tolerance below
# the Hubbard solve's tolerance, cut from 1e-10 to keep the whole run
# inside its time limit once the vertical layer's solves came in (at
# (12,6) the residuals halved an iteration: 5 fewer iterations of
# ~13.6 s); the host re-check stays at 1e-8
CUT_TOL = 5e-9
# the exciton200 config cut to one card (L = 200 -> 30), its N_s and N_t
EXCITON = dict(L=30)
# the solves' operators, cut further to keep the whole run inside its
# time limit once the dryrun phase came in (a run of 990 s on one host
# passed the limit on another): Hubbard (12,6) -> (10,5), Exciton L = 30
# -> 20; the solve phase 759.3 s -> 167.2 s (H100 80GB HBM3 at 700 W)
HUBBARD_SOLVE = dict(HUBBARD, n_sites=10, n_fermions=5)
EXCITON_SOLVE = dict(L=20)
# the Exciton stack solve's depth, cut from 16 to 8 to make room for the
# plan phase
EX_STACK_N_TARGET = 8
# the pillar solve's depth, cut from the config's 100 to 16 to make room
# for the s-step solves (194 iterations, 313.925 s at 100), then to the
# stack solve's 8 for the service phase (121 iterations, 219.307 s at 16)
EX_N_SEARCH, EX_N_TARGET = 384, EX_STACK_N_TARGET
EX_MAX_ITERS = 300
TOPINS = dict(Lx=40)  # D = 256,000
# the roadnet48k config's matrix and N_s, N_t
ROADNET = dict(n=48000, w=2, m=1200, k=4)
RN_N_SEARCH, RN_N_TARGET = 64, 16
RN_MAX_ITERS = 400  # ~150 needed at the upper edge
# the hubnet48k config's matrix and N_s, N_t
HUBNET = dict(n=48000, w=2, h=5, m=512, k=4)
HN_N_SEARCH, HN_N_TARGET, HN_MAX_ITERS = 64, 16, 400
# the s-step solves' depth and shards
SSTEP, SSTEP_P = 3, 8
# the vertical layer's solves: (n_row, n_col) of their grids
EX_PILLAR, HN_PANEL, RN_PILLAR = (1, 4), (4, 2), (1, 8)
# bundle widths n_c = N_s / N_col of those solves, and of the layouts
# phase's Hubbard pillar 1 x 4, timed in the kernel phase
BUNDLE_NB = dict(hubbard=N_SEARCH // 4, exciton=EX_N_SEARCH // EX_PILLAR[1],
                 hubnet=HN_N_SEARCH // HN_PANEL[1],
                 roadnet=RN_N_SEARCH // RN_PILLAR[1])
# the service phase: two requests (id, n_target, seed) on the roadnet48k
# config over 8 shards; a checkpoint every 20 iterations and one fault at
# iteration 30
SVC_REQUESTS = (("a", RN_N_TARGET, 11), ("b", 8, 22))
SVC_SHARDS, SVC_CKPT_INTERVAL, SVC_FAULT_AT = 8, 20, 30
# the ranks phase: 4 gloo ranks sharing the card, its three grids, the
# Hubbard pillar's n_target, cut from the solves phase's 8 to 4 for the
# phase's 90 s (at 8 the phase took 108.5 s; at 4 the solve still took
# 54 iterations, H100 80GB HBM3 at 700 W), the reps of its timed halo
# exchange and the launch's time limit
RANKS_WORLD = 4
RANKS_STACK, RANKS_PANEL, RANKS_PILLAR = (4, 1), (2, 2), (1, 4)
RANKS_HUBBARD_N_TARGET = 4
RANKS_EXCHANGE_REPS = 20
RANKS_TIMEOUT_S = 420
# how long a rank started ahead of the phase waits for its spec
RANKS_WAIT_S = 900
# the ranks phase's s-step check: one filter of this degree at s = SSTEP
RANKS_SSTEP_DEGREE = 9
# the analysis phase's census filter degree
ANALYSIS_DEGREE = 8
# the dryrun phase: its eigen cells (the reference's tests/test_analysis.py
# cell with --plan, and the hubbard16 stack cell, its Hubbard(16,8) cut to
# the kernel phase's (12,6) for a grid of one shard), its LM cells, and the
# example it runs on the card
DRYRUN_EIGEN = {
    "roadnet48k": ["--eigen", "roadnet48k", "--layout", "panel",
                   "--spmv-comm", "compressed", "--spmv-schedule",
                   "matching", "--plan", "--verify", "--grid", "4x2"],
    "hubbard16": ["--eigen", "hubbard16", "--layout", "stack", "--verify",
                  "--grid", "1x1", "--grid-params", "n_sites=12,n_fermions=6"],
}
DRYRUN_LM = (("qwen3-0.6b", "train_4k"), ("arctic-480b", "decode_32k"))
DRYRUN_EXAMPLE = "examples/torch_quickstart.py"
# the census-bytes launches: n_b, and Hubbard(8,4)'s DIA form for cheb_dia
DRYRUN_NB, DRYRUN_DIA = 64, dict(n_sites=8, n_fermions=4, U=4.0, ranpot=1.0)
# the LM phase: the six archs one card holds whole, at full width and
# depth; the four it cannot hold, at full width with depth cut to
# LM_CUT_LAYERS (arctic-480b: 2 x 13.6 B parameters, 55 GB in bf16)
LM_FULL = ("qwen3-0.6b", "internvl2-1b", "granite-moe-3b-a800m",
           "hymba-1.5b", "rwkv6-1.6b", "hubert-xlarge")
LM_CUT = ("nemotron-4-15b", "qwen2.5-32b", "deepseek-67b", "arctic-480b")
LM_CUT_LAYERS = 2
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 512, 16
# hymba's prompt: its 2,048-deep sliding-window rings wrap during decode
LM_HYMBA_PROMPT = 2040
LM_CONSISTENCY_TOL = 2e-3  # tests/test_models.py's rtol = atol
# the SMOKE configs, card against CPU
LM_CPU_PROMPT, LM_CPU_STEPS, LM_CPU_TOL = 128, 3, 1e-4
# the train phase: the SMOKE configs card against CPU (steps, tolerance,
# the small-grad share of Adam's first step); qwen3-0.6b at full size
# through train() (its lr that of the reference's loss-decrease test),
# then timed steps; granite-moe with int8 moments; the exact resume
TRAIN_CPU_STEPS, TRAIN_CPU_TOL, TRAIN_SMALL_GRAD = 2, 1e-4, 1e-3
TRAIN_SEQ_BATCH = (512, 2)
TRAIN_QWEN_STEPS, TRAIN_QWEN_LR, TRAIN_TIMED_STEPS = 10, 3e-3, 3
TRAIN_GRANITE_STEPS = 4
TRAIN_RESUME = (7, 10)  # stop after, resume to
# forced slab widths timed at Hubbard n_b = 512 (fp64) and Exciton
# n_b = 384 (complex128)
SLAB_SWEEP = {"cheb_dia": (4, 8, 16, 32, 64, 128, N_SEARCH),
              "ell_gather": (32, 128, N_SEARCH),
              "cheb_dia complex": (4, 8, 16, 32, 64, EX_N_SEARCH)}
REPLACES = {
    "ell_gather": "src/repro/kernels/ell_gather.py:172",
    # the same Pallas kernel, with the step's epilogue that XLA fuses
    # around it (src/repro/core/spmv.py:1092-1097)
    "ell_gather_cheb": "src/repro/kernels/ell_gather.py:172",
    "cheb_dia": "src/repro/kernels/cheb_dia.py:125",
}
SOURCES = {
    "ell_gather": "src/repro_torch/kernels/csrc/ell_gather.cu",
    "ell_gather_cheb": "src/repro_torch/kernels/csrc/ell_gather.cu",
    "cheb_dia": "src/repro_torch/kernels/csrc/cheb_dia.cu",
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_bound_bytes(cpe, R: int, Rx: int, nb: int, S: int,
                    epilogue: bool, y0: bool = False,
                    w1_is_x: bool = False) -> float:
    """Bytes of an ELL launch's bound on ``cpe.P`` shards of ``R`` rows
    (one for one block): the operator as the kernel reads it (row
    pointers, an int32 column and a value an entry), each shard's x
    [Rx, nb], y0 [R, nb] when the launch starts from one, with the
    epilogue w1 (unless ``w1_is_x``: it is x's leading rows, the same
    memory, read once) and w2 [R, nb], and y [R, nb], each once."""
    from repro_torch.kernels import plan

    P = cpe.P
    blocks = (1 + (1 if y0 else 0)
              + ((1 if w1_is_x else 2) if epilogue else 0))
    return (plan.ell_bytes_per_row(cpe) * P * R
            + P * (Rx + blocks * R) * nb * S)


def dia_bound_bytes(cp, nb: int, S: int) -> float:
    """Bytes of a DIA step's bound: x (= w1), w2 and y [R, nb] once, and
    the compact operator its kernel reads, once."""
    return 3 * cp.R * nb * S + cp.bytes_per_row * cp.R


def compare(name, case, dtype, kernel, plain, n_bytes, n_ops, library=None,
            reps=(10, 3), slab=None, extra=None, bitwise_dtypes=BITWISE):
    """Run the kernel and its plain version on the same inputs, hold them
    to the tolerance (bit for bit in ``bitwise_dtypes``), time both (and
    the library call). ``slab`` is the rule's (c, modelled bytes) for the
    launch; ``extra`` is added to the record."""
    import torch

    y = kernel()
    y_ref = plain()
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    rel = err / scale if scale else err
    bitwise = bool(torch.equal(y, y_ref))
    finite = bool(torch.isfinite(y).all())
    del y, y_ref
    ms = time_ms(kernel, reps[0])
    plain_ms = time_ms(plain, reps[1])
    lib_ms, lib_note = None, None
    if library is not None:
        try:
            lib_ms = time_ms(library, reps[0])
        except RuntimeError as e:  # no such library call for this dtype
            lib_note = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
            torch.cuda.synchronize()
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    c, model = slab if slab is not None else (None, None)
    rec = dict(name=name, case=case, dtype=dtype, max_abs_err=err,
               max_rel_err=rel, bitwise=bitwise, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, tol=TOL[dtype], slab=c,
               model_bytes=model, effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S,
               **(extra or {}))
    if lib_note:
        rec["library_note"] = lib_note
    log(f"[kernels] {name} {case} {dtype}: max|err|={err:.3e} "
        f"rel={rel:.3e} bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
        f"bound_ms={b_ms:.4f} ({b_by}) slab={c} "
        f"model_GB={model if model is None else round(model / 1e9, 3)} "
        f"effective_GB={rec['effective_bytes'] / 1e9:.3f}"
        + "".join(f" {k}={v:.4f}" for k, v in (extra or {}).items())
        + (f" library: {lib_note}" if lib_note else ""))
    if not finite or not rel <= TOL[dtype]:
        raise SmokeFailure(f"{name} {case} {dtype} disagrees with its plain "
                           f"version: rel {rel:.3e} > {TOL[dtype]:.0e}")
    if dtype in bitwise_dtypes and not bitwise:
        raise SmokeFailure(f"{name} {case} {dtype} is not bit-equal to its "
                           f"plain version (max|err| {err:.3e})")
    torch.cuda.empty_cache()
    return rec


def csr_library(cols, vals, n_cols=None):
    """cuSPARSE CSR of the same operator, ``[R, n_cols]`` (default
    square; the yardstick, not the port)."""
    import torch

    R = cols.shape[0]
    nz = vals != 0
    crow = torch.zeros(R + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(nz.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols[nz].to(torch.int64), vals[nz],
                                   size=(R, n_cols or R))


def ell_slab(cp, nb, S, c=None):
    """The ELL kernel's slab width (the rule's unless ``c``) and the bytes
    of its schedule, over the padding-free form ``cp``."""
    from repro_torch.kernels import plan
    from repro_torch.kernels.ell_gather import slab_for

    c = slab_for(nb, c)
    return c, plan.model_bytes(cp.R, nb, S, c, plan.ell_bytes_per_row(cp),
                               streams=1)


def dia_slab(dia, nb, S, c=None):
    """The DIA kernel's slab width (the rule's unless ``c``) and the bytes
    of its schedule."""
    from repro_torch.kernels import plan
    from repro_torch.kernels.cheb_dia import slab_for

    c = slab_for(dia.compact.dtype, dia.span, nb, c)
    return c, plan.model_bytes(dia.compact.R, nb, S, c,
                               dia.compact.bytes_per_row)


def slab_sweep(records: list, name: str, launch, want, n_bytes,
               model, case=f"Hubbard n_b={N_SEARCH}", dtype="float64",
               widths=None) -> None:
    """Time ``launch(c)`` at each forced slab width (``SLAB_SWEEP[name]``
    unless ``widths``), each result held to the plain version's ``want``
    bit for bit."""
    import torch

    for c in widths or SLAB_SWEEP[name]:
        y = launch(c)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(y, want))
        del y
        ms = time_ms(lambda: launch(c), 5)
        b_ms, _ = bound_ms(n_bytes, 0.0, dtype)
        rec = dict(name=name, case=f"sweep {case} c={c}",
                   dtype=dtype, slab=c, ms=ms, bitwise=bitwise,
                   bound_ms=b_ms, share_of_bound=b_ms / ms,
                   model_bytes=model(c),
                   effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S)
        records.append(rec)
        log(f"[sweep] {name} {case} {dtype} c={c}: ms={ms:.4f} bitwise={bitwise} "
            f"model_GB={rec['model_bytes'] / 1e9:.3f} "
            f"effective_GB={rec['effective_bytes'] / 1e9:.3f} "
            f"share_of_bound={b_ms / ms:.3f}")
        if not bitwise:
            raise SmokeFailure(f"{name} at slab width {c} differs from its "
                               "plain version")


def time_add(records: list, case: str, x, w2, dtype: str) -> None:
    """The filter's ``Y += mu_k·T_k``, one torch call a step."""
    ms = time_ms(lambda: x.add_(w2, alpha=1e-30), 5)
    b_ms, _ = bound_ms(3 * x.numel() * x.element_size(), 0.0, dtype)
    records.append(dict(name="Y.add_", case=case, dtype=dtype, ms=ms,
                        bound_ms=b_ms, share_of_bound=b_ms / ms))
    log(f"[kernels] Y.add_(T, alpha=mu) {case} {dtype}: ms={ms:.4f} "
        f"bound_ms={b_ms:.4f}")


def ell_case(records: list, label: str, cols, vals, nb: int, dtype: str,
             gen, sweep: bool = False, cheb: bool = False,
             Rx: int | None = None, bitwise: tuple = BITWISE) -> None:
    """``ell_gather`` against its plain version on ``x [Rx, nb]`` (``Rx``
    defaults to the R rows of ``cols``; a shard's block of a P-shard
    operator reads ``[x_p ‖ halo]``, ``R + H`` rows); ``sweep`` times the
    forced slab widths of ``SLAB_SWEEP``; ``cheb`` also holds the epilogue
    entry (``ell_gather_cheb``, ``2a·A·x + 2b·w1 − w2`` with w1, w2
    blocks of their own) to its plain version, bit for bit in fp64 and
    complex128, against the same cuSPARSE product. ``bitwise`` names the
    dtypes in which the product, too, must be bit-equal."""
    import torch

    from repro_torch.kernels import plan, ref
    from repro_torch.kernels.ell_gather import ell_gather_spmv as k_ell

    tdt = getattr(torch, dtype)
    S = tdt.itemsize
    nnz = int((vals != 0).sum())
    R = cols.shape[0]
    Rx = R if Rx is None else Rx
    cpe = plan.compact_ell(cols, vals)  # built once, as make_spmv does
    A = csr_library(cols, vals, Rx)
    x = torch.randn((Rx, nb), generator=gen, device="cuda",
                    dtype=torch.complex128 if tdt.is_complex
                    else torch.float64).to(tdt)
    flops = (8.0 if tdt.is_complex else 2.0) * nnz * nb
    n_bytes = ell_bound_bytes(cpe, R, Rx, nb, S, epilogue=False)
    records.append(compare(
        "ell_gather", f"{label} n_b={nb}", dtype,
        lambda: k_ell(cols, vals, x, compact=cpe),
        lambda: ref.ell_spmv_ref(cols, vals, x), n_bytes, flops,
        library=lambda: A @ x, slab=ell_slab(cpe, nb, S),
        bitwise_dtypes=bitwise))
    if cheb:
        w1, w2 = (torch.randn((R, nb), generator=gen, device="cuda",
                              dtype=torch.complex128 if tdt.is_complex
                              else torch.float64).to(tdt) for _ in range(2))
        a, b = 0.013, -0.4
        cheb_bytes = ell_bound_bytes(cpe, R, Rx, nb, S, epilogue=True)
        epi_flops = (8.0 if tdt.is_complex else 4.0) * R * nb
        records.append(compare(
            "ell_gather_cheb", f"{label} n_b={nb}", dtype,
            lambda: k_ell(cols, vals, x, compact=cpe, epilogue=(w1, w2, a, b)),
            lambda: ref.cheb_epilogue(ref.ell_spmv_ref(cols, vals, x), w1, w2,
                                      a, b),
            cheb_bytes, flops + epi_flops,
            library=lambda: A @ x, slab=ell_slab(cpe, nb, S),
            bitwise_dtypes=("float64", "complex128")))
        del w1, w2
    if sweep:
        want = ref.ell_spmv_ref(cols, vals, x)
        slab_sweep(records, "ell_gather",
                   lambda c: k_ell(cols, vals, x, compact=cpe, slab=c),
                   want, n_bytes, lambda c: ell_slab(cpe, nb, S, c)[1],
                   case=f"{label} n_b={nb}", dtype=dtype)
        del want
    del x, A, cpe


def dia_case(records: list, label: str, dia, nb: int, dtype: str, gen,
             sweep: str | None = None, add: bool = False) -> None:
    """``cheb_dia`` against its plain version on ``x = w1, w2 [R, nb]``;
    ``sweep`` names the forced slab widths to time, ``add`` times the
    filter's ``Y.add_`` at the same shape."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cheb_dia import cheb_dia as k_dia

    tdt = getattr(torch, dtype)
    S = tdt.itemsize
    cp = dia.compact
    R = cp.R
    x, w2 = (torch.randn((R, nb), generator=gen, device="cuda",
                         dtype=torch.complex128 if tdt.is_complex
                         else torch.float64).to(tdt) for _ in range(2))
    # the earlier formula counted dense dvals
    n_bytes = dia_bound_bytes(cp, nb, S)
    dense_ms, _ = bound_ms(3 * R * nb * S + dia.dvals.numel() * S, 0.0, dtype)
    flops = ((8.0 * cp.nnz + 8.0 * R) if tdt.is_complex
             else (2.0 * cp.nnz + 4.0 * R)) * nb

    def step(c=None):
        return k_dia(dia.offsets, dia.dvals, x, x, w2, 0.013, -0.4,
                     compact=cp, span=dia.span, slab=c)

    def plain():
        return ref.cheb_dia_ref(dia.offsets, dia.dvals, x, x, w2, 0.013, -0.4)

    records.append(compare(
        "cheb_dia", f"{label} n_b={nb}", dtype, step, plain, n_bytes, flops,
        reps=(5, 2), slab=dia_slab(dia, nb, S),
        extra=dict(bound_ms_dense=dense_ms)))
    if sweep:
        want = plain()
        slab_sweep(records, "cheb_dia", step, want, n_bytes,
                   lambda c: dia_slab(dia, nb, S, c)[1],
                   case=f"{label} n_b={nb}", dtype=dtype,
                   widths=SLAB_SWEEP[sweep])
        del want
    if add:
        time_add(records, f"{label} n_b={nb}", x, w2, dtype)
    del x, w2
    torch.cuda.empty_cache()


def log_dia(mat, dtype: str, dia) -> None:
    cp = dia.compact
    log(f"[kernels] {mat.describe()} {dtype}: DIA form, "
        f"{len(dia.offsets)} diagonals, span {dia.span}; compact "
        f"{cp.nnz} entries, {cp.bytes_per_row:.2f} B a row, at most "
        f"{cp.max_row} in a row, "
        f"{0 if cp.table is None else len(cp.table)} table values")


def phase_kernels(records: list) -> None:
    """The Hubbard path's cases (both kernels, fp64 and fp32, with the
    slab sweeps and ``Y.add_`` in fp64) and SpinChainXXZ(24,12)'s ELL
    product (paper Table 5, scattered rank jumps)."""
    import torch

    from repro_torch.core import build_dist_ell
    from repro_torch.kernels import ops
    from repro_torch.matrices import Hubbard, SpinChainXXZ

    gen = torch.Generator(device="cuda").manual_seed(2024)
    for fam, params, nbs in ((Hubbard, HUBBARD, (N_SEARCH, 1)),
                             (SpinChainXXZ, SPIN, (64,))):
        t0 = time.perf_counter()
        mat = fam(**params)
        ell64 = build_dist_ell(mat, 1, dtype="float64", device="cuda")
        log(f"[kernels] {mat.describe()}: ELL R={ell64.R} W={ell64.W} "
            f"span={ell64.span} built in {time.perf_counter() - t0:.2f} s")
        for dtype in ("float64", "float32"):
            vals = ell64.vals[0].to(getattr(torch, dtype))
            main = fam is Hubbard and dtype == "float64"
            for nb in nbs:
                ell_case(records, fam.name, ell64.cols[0], vals, nb, dtype,
                         gen, sweep=main and nb == N_SEARCH,
                         cheb=fam is Hubbard and nb == N_SEARCH)
            if fam is Hubbard:
                dia = ops.plan_dia(ell64.cols[0], vals, ell64.R, device="cuda")
                if dia is None or len(dia.offsets) > ops.DIA_MAX_DIAGS:
                    raise SmokeFailure("Hubbard(12,6) has no DIA form")
                log_dia(mat, dtype, dia)
                dia_case(records, "Hubbard", dia, N_SEARCH, dtype, gen,
                         sweep="cheb_dia" if main else None, add=main)
                if main:  # the pillar 1 x 4 bundles of the layouts phase
                    dia_case(records, "Hubbard", dia, BUNDLE_NB["hubbard"],
                             dtype, gen)
                del dia
            del vals
            torch.cuda.empty_cache()
        del ell64


def phase_kernels_families(records: list) -> None:
    """The cases of the families added after the Hubbard path: the ELL
    route of RoadNet(48000) in fp64 at N_s, Exciton(L=30) in complex128
    and complex64 on both kernels, TopIns(40)'s step in complex128; and
    the vertical layer's bundles on the operators its solves build: the
    pillar 1 × 8 RoadNet operator on the RCM map (one shard, n_b = 8),
    the four shards of the panel-level HubNet operator on the commvol map
    (R = 18,000 and the matching engine's halo rows, n_b = 32), each
    through ``ell_gather`` and its epilogue entry, and the pillar 1 × 4
    Exciton operator (one shard padded to P = 4's D_pad, a zero pad row)
    through ``cheb_dia`` at n_b = 96."""
    import torch

    from repro_torch.core import build_dist_ell, plan_rowmap
    from repro_torch.kernels import ops
    from repro_torch.matrices import Exciton, HubNet, RoadNet, TopIns

    gen = torch.Generator(device="cuda").manual_seed(2025)
    t0 = time.perf_counter()
    mat = RoadNet(**ROADNET)
    ell = build_dist_ell(mat, 1, dtype="float64", device="cuda")
    cols, vals = ell.cols[0], ell.vals[0]
    log(f"[kernels] {mat.describe()}: ELL R={ell.R} W={ell.W} span={ell.span}"
        f", DIA form: {ops.plan_dia(cols, vals, ell.R) is not None}; "
        f"built in {time.perf_counter() - t0:.2f} s")
    ell_case(records, "RoadNet", cols, vals, RN_N_SEARCH, "float64", gen,
             cheb=True)
    del cols, vals, ell
    # the pillar 1 x 8 solve's filter operator: one shard on the RCM map
    rm = plan_rowmap(mat, RN_PILLAR[0] * RN_PILLAR[1], reorder="rcm")
    ell = build_dist_ell(mat, RN_PILLAR[0], dtype="float64", rowmap=rm,
                         device="cuda")
    cols, vals = ell.cols[0], ell.vals[0]
    log(f"[kernels] {mat.describe()} on the {rm.describe()}: ELL "
        f"R={ell.R} W={ell.W} span={ell.span}, DIA form: "
        f"{ops.plan_dia(cols, vals, ell.R) is not None}")
    ell_case(records, "RoadNet rcm pillar 1x8", cols, vals,
             BUNDLE_NB["roadnet"], "float64", gen, cheb=True)
    del cols, vals, ell
    # the panel 4 x 2 solve's filter operator: the N_row = 4 level of the
    # commvol map, each shard's block against [x_p ‖ halo] (the matching
    # engine, plain)
    mat = HubNet(**HUBNET)
    rm = plan_rowmap(mat, HN_PANEL[0] * HN_PANEL[1], balance="commvol")
    ell = build_dist_ell(mat, HN_PANEL[0], dtype="float64", rowmap=rm,
                         device="cuda")
    nplan = ell.neighbor_plan(schedule="matching")
    log(f"[kernels] {mat.describe()} on the {rm.describe()}: level "
        f"{ell.P} shards, R={ell.R} W={ell.W} H={nplan.H}")
    for p in range(ell.P):
        ell_case(records, f"HubNet commvol panel 4x2 shard {p}",
                 nplan.cols_nbr[p], ell.vals[p], BUNDLE_NB["hubnet"],
                 "float64", gen, cheb=True, Rx=ell.R + nplan.H)
    del ell, nplan

    for fam, params, label, dtypes, nbs_ell, nbs_dia in (
            (Exciton, EXCITON, "Exciton", ("complex128", "complex64"),
             (1, EX_N_SEARCH), (1, EX_N_SEARCH)),
            (TopIns, TOPINS, "TopIns", ("complex128",), (), (EX_N_SEARCH,))):
        t0 = time.perf_counter()
        mat = fam(**params)
        ell = build_dist_ell(mat, 1, dtype="complex128", device="cuda")
        log(f"[kernels] {mat.describe()}: ELL R={ell.R} W={ell.W} "
            f"span={ell.span} built in {time.perf_counter() - t0:.2f} s")
        for dtype in dtypes:
            vals = ell.vals[0].to(getattr(torch, dtype))
            for nb in nbs_ell:
                ell_case(records, label, ell.cols[0], vals, nb, dtype, gen,
                         cheb=nb == EX_N_SEARCH)
            dia = ops.plan_dia(ell.cols[0], vals, ell.R, device="cuda")
            if dia is None:
                raise SmokeFailure(f"{mat.describe()} has no DIA form")
            log_dia(mat, dtype, dia)
            for nb in nbs_dia:
                main = (fam is Exciton and dtype == "complex128"
                        and nb == EX_N_SEARCH)
                dia_case(records, label, dia, nb, dtype, gen,
                         sweep="cheb_dia complex" if main else None,
                         add=main)
            del vals, dia
        del ell
        torch.cuda.empty_cache()
    # the pillar 1 x 4 solve's filter operator: one shard padded to the
    # stack level's D_pad (P = 4), its last row a zero pad row
    mat = Exciton(**EXCITON)
    P = EX_PILLAR[0] * EX_PILLAR[1]
    ell = build_dist_ell(mat, EX_PILLAR[0], dtype="complex128",
                         d_pad=-(-mat.D // P) * P, device="cuda")
    dia = ops.plan_dia(ell.cols[0], ell.vals[0], ell.R, device="cuda")
    if dia is None:
        raise SmokeFailure(f"{mat.describe()} padded to D_pad={ell.D_pad} "
                           "has no DIA form")
    log_dia(mat, "complex128", dia)
    dia_case(records, f"Exciton pillar 1x4 D_pad={ell.D_pad}", dia,
             BUNDLE_NB["exciton"], "complex128", gen)
    del ell, dia
    torch.cuda.empty_cache()


def grouped_case(records: list, label: str, cols, vals, x, y0, epilogue,
                 library) -> None:
    """One launch of the ELL kernel for all P row shards of the block
    ``cols/vals [P, R, W]`` (``ell_gather.EllLaunch`` on the shards'
    stacked form, as the engines launch it) on the views ``x [P, Rx, nb]``
    and ``y0`` (or None), with ``epilogue = (w1, w2, alpha, beta)`` or
    None, into a fresh ``[P, R, nb]``: held bit for bit to its plain
    version (``ref.ell_grouped_ref``), to the padded block's plain version
    shard by shard (``ref.ell_spmv_acc_ref`` on ``cols/vals[p]``, which
    does not read the compact form) and to P launches of one shard each
    (one ``EllLaunch`` a shard, built beforehand as the engines held the
    shards' compact forms, on contiguous copies of the shards' operands),
    each timed, beside the bound of the stacked form (w1 counted once with
    x when it is x's leading rows) and ``library`` (cuSPARSE ``A @ x``
    over the whole operator). Launches made here are comparisons, outside
    the main path's counts."""
    import torch

    from repro_torch.kernels import plan, ref
    from repro_torch.kernels.ell_gather import EllLaunch

    P, R, _ = cols.shape
    Rx, nb = x.shape[1], x.shape[2]
    S = x.element_size()
    name = "ell_gather" if epilogue is None else "ell_gather_cheb"
    cp = plan.compact_ell_grouped(cols, vals)  # built once, as _block does
    launch = EllLaunch(cp)
    out, outs = x.new_empty((P, R, nb)), x.new_empty((P, R, nb))
    shards = [(EllLaunch(plan.compact_ell(cols[p], vals[p])),
               x[p].contiguous()[None],
               None if y0 is None else y0[p].contiguous()[None],
               None if epilogue is None else (
                   epilogue[0][p].contiguous()[None],
                   epilogue[1][p].contiguous()[None], epilogue[2],
                   epilogue[3]))
              for p in range(P)]

    def per_shard():  # into outs[p], each a contiguous [R, nb]
        for p, (lp, xp, y0p, epi) in enumerate(shards):
            lp(xp, y0p, out=outs[p:p + 1], epilogue=epi)

    def padded():  # the padded blocks, shard by shard
        ys = []
        for p in range(P):
            acc = (y0[p].clone() if y0 is not None else
                   torch.zeros((R, nb), dtype=x.dtype, device=x.device))
            y = ref.ell_spmv_acc_ref(acc, cols[p], vals[p], x[p])
            if epilogue is not None:
                y = ref.cheb_epilogue(y, epilogue[0][p], epilogue[1][p],
                                      epilogue[2], epilogue[3])
            ys.append(y)
        return torch.stack(ys)

    per_shard()
    want = launch(x, y0, out=out, epilogue=epilogue).clone()
    pad = padded()
    torch.cuda.synchronize()
    same = bool(torch.equal(outs, want))
    same_pad = bool(torch.equal(pad, want))
    del pad
    per_ms = time_ms(per_shard, 10)
    w1_is_x = epilogue is not None and (
        epilogue[0].data_ptr() == x.data_ptr()
        and epilogue[0].stride() == x.stride())
    n_bytes = ell_bound_bytes(cp, R, Rx, nb, S, epilogue is not None,
                              y0 is not None, w1_is_x)
    nnz = cp.cols.numel()
    flops = 2.0 * nnz * nb + (4.0 * P * R * nb if epilogue else 0.0)
    rec = compare(
        name, f"{label} n_b={nb} grouped P={P}", "float64",
        lambda: launch(x, y0, out=out, epilogue=epilogue),
        lambda: ref.ell_grouped_ref(cp, x, y0, epilogue), n_bytes, flops,
        library=library, bitwise_dtypes=("float64",),
        extra=dict(per_shard_ms=per_ms, launches_before=P,
                   tile_max=float(cp.tile_max), max_row=float(cp.max_row)))
    rec["bitwise_to_per_shard"] = same
    rec["bitwise_to_padded"] = same_pad
    rec["w1_is_x"] = w1_is_x
    rec["x_shard_stride"] = x.stride(0)
    records.append(rec)
    log(f"[kernels] {name} {label} grouped P={P}: bitwise to {P} per-shard "
        f"launches {same}, to the padded blocks' plain version {same_pad}; "
        f"{rec['ms']:.4f} ms against {per_ms:.4f} ms of the {P} launches "
        f"(x shard stride {x.stride(0)}, contiguous {x.is_contiguous()}, "
        f"w1 is x {w1_is_x})")
    if not same:
        raise SmokeFailure(f"{name} {label}: the grouped launch differs from "
                           f"the {P} per-shard launches")
    if not same_pad:
        raise SmokeFailure(f"{name} {label}: the grouped launch differs from "
                           "the padded blocks' plain version")
    del shards, out, outs, want
    torch.cuda.empty_cache()


def phase_kernels_grouped(records: list) -> None:
    """The 8-shard solves' blocks, one launch for all shards, at their own
    shape (n_b = 64, fp64), on RoadNet(48000) and HubNet(48000): the
    split-phase step of the compressed cyclic engine (the local block on
    the shards' rows, then the halo block with the epilogue on the halo
    buffer, from the local block's accumulator) and the depth-3 s-step
    filter's step 0 (the whole ``[R + G, W_0]`` block on the extended
    blocks with and without the epilogue, and its split: the local block
    on the owned rows ``w1e[:, :R]`` into ``y[:, :R]``, strided views of
    ``[P, R + G, nb]``, then the rest on the whole block with the
    epilogue), each against the plain version, the per-shard launches and
    cuSPARSE ``A @ x`` over the whole operator."""
    import torch

    from repro_torch.core import build_dist_ell, build_sstep_ell
    from repro_torch.kernels import plan
    from repro_torch.kernels.ell_gather import EllLaunch
    from repro_torch.matrices import HubNet, RoadNet

    gen = torch.Generator(device="cuda").manual_seed(2029)
    a, b = 0.013, -0.4
    for fam, params, label, nb in ((HubNet, HUBNET, "HubNet", HN_N_SEARCH),
                                   (RoadNet, ROADNET, "RoadNet",
                                    RN_N_SEARCH)):
        t0 = time.perf_counter()
        mat = fam(**params)
        P = SSTEP_P
        ell = build_dist_ell(mat, P, dtype="float64", split_halo=True,
                             device="cuda")
        nplan = ell.neighbor_plan(split_halo=True, schedule="cyclic")
        cl, vl, _, vh = ell.split()
        sell = build_sstep_ell(mat, P, SSTEP, dtype="float64",
                               d_pad=ell.D_pad, split_halo=True,
                               device="cuda")
        R, G, H = ell.R, sell.G, nplan.H
        log(f"[kernels] {mat.describe()} P={P}: R={R} H={H} (cyclic) "
            f"W_local={cl.shape[2]} W_halo={vh.shape[2]}; s={SSTEP}: G={G} "
            f"widths {[int(c.shape[2]) for c, _ in sell.steps]}; built in "
            f"{time.perf_counter() - t0:.2f} s")
        # cuSPARSE over the whole operator (its one-shard block), x [D, nb]
        one = build_dist_ell(mat, 1, dtype="float64", device="cuda")
        A = csr_library(one.cols[0], one.vals[0])
        xa = torch.randn((one.D_pad, nb), generator=gen, device="cuda",
                         dtype=torch.float64)
        del one

        def lib():
            return A @ xa

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float64)

        # the split step: x = w1 the shards' rows, the halo [P, H, nb]
        xs, w2, halo = randn(P, R, nb), randn(P, R, nb), randn(P, H, nb)
        acc = xs.new_empty((P, R, nb))
        grouped_case(records, f"{label} split local", cl, vl, xs, None, None,
                     lib)
        EllLaunch(plan.compact_ell_grouped(cl, vl))(xs, out=acc)
        grouped_case(records, f"{label} split halo", nplan.cols_halo_nbr, vh,
                     halo, acc, (xs, w2, a, b), lib)
        del xs, w2, halo, acc
        # the s-step filter's step 0 on the extended blocks [P, R + G, nb]
        cols0, vals0 = sell.steps[0]
        w1e, w2e = randn(P, R + G, nb), randn(P, R + G, nb)
        grouped_case(records, f"{label} s={SSTEP} step 0", cols0, vals0, w1e,
                     None, None, lib)
        grouped_case(records, f"{label} s={SSTEP} step 0", cols0, vals0, w1e,
                     None, (w1e, w2e, a, b), lib)
        lc, lv, pc, pv = sell.split()
        y = w1e.new_zeros((P, R + G, nb))
        grouped_case(records, f"{label} s={SSTEP} step 0 local", lc, lv,
                     w1e[:, :R], None, None, lib)
        EllLaunch(plan.compact_ell_grouped(lc, lv))(w1e[:, :R], out=y[:, :R])
        grouped_case(records, f"{label} s={SSTEP} step 0 post", pc, pv, w1e,
                     y, (w1e, w2e, a, b), lib)
        del A, xa, w1e, w2e, y, ell, sell, nplan
        torch.cuda.empty_cache()


# ------------------------------------------------------------- engines --

#: (comm, schedule, overlap, pipeline) of the horizontal layer's engines
ENGINES = (("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "cyclic", False, True),
           ("compressed", "cyclic", True, False),
           ("compressed", "cyclic", True, True),
           ("compressed", "matching", False, True),
           ("compressed", "matching", True, False),
           ("compressed", "matching", True, True))
ENG_P = 4  # row shards of the engines phase
ENG_REPS = 3  # timed calls of each engine (after one warm-up)
ENG_LOOP = 5  # repeated split-phase steps held bit-equal (side stream)
FILTER_DEGREE = 32


def engine_name(comm, sched, ov, pipe) -> str:
    if comm == "a2a":
        return "a2a-overlap" if ov else "a2a"
    return f"compressed-{sched}" + ("" if not ov else
                                    "-pipelined" if pipe else "-overlap")


def engines_case(label: str, mat, dtype: str, nb: int, gen,
                 P: int = ENG_P, reps: int = ENG_REPS) -> dict:
    """Every engine of ``mat`` at ``P`` shards, kernels on: SpMV and
    fused step bit-equal to the a2a engine, and that one bit-equal to the
    same engine built from the plain versions on the card; the bytes each
    exchange recorded equal to the prediction (a2a ``P·P·L·n_b·S``,
    compressed ``P·H·n_b·S``); times of the SpMV, the step and the
    exchange alone (CUDA events), peak memory."""
    import numpy as np
    import torch

    from repro_torch.core import (ShardGroup, build_dist_ell, chi_from_nvc,
                                  make_fused_cheb_step, make_spmv)

    t0 = time.perf_counter()
    ell = build_dist_ell(mat, P, dtype=dtype, split_halo=True, device="cuda")
    H = {s: ell.neighbor_plan(split_halo=True, schedule=s).H
         for s in ("cyclic", "matching")}
    host_s = time.perf_counter() - t0
    S = ell.vals.element_size()
    chi = chi_from_nvc(ell.n_vc, ell.rowmap.block_sizes(), ell.D)
    cl, _, ch, _ = ell.split()
    info = dict(case=label, P=P, D=ell.D, D_pad=ell.D_pad, R=ell.R, n_b=nb,
                dtype=dtype, L=ell.L, H_cyclic=H["cyclic"],
                H_matching=H["matching"], sum_n_vc=int(ell.n_vc.sum()),
                n_vc=[int(v) for v in ell.n_vc], chi1=chi.chi1, chi2=chi.chi2,
                chi3=chi.chi3, imbalance=chi.imbalance,
                halo_nnz_fraction=ell.halo_nnz_fraction, W=ell.W,
                W_loc=int(cl.shape[2]), W_halo=int(ch.shape[2]),
                host_build_s=host_s)
    log(f"[engines] {label}: P={P} R={ell.R} D_pad={ell.D_pad} W={ell.W} "
        f"(local {info['W_loc']}, halo {info['W_halo']}) L={ell.L} "
        f"H cyclic/matching={H['cyclic']}/{H['matching']} "
        f"sum n_vc={info['sum_n_vc']} chi1={chi.chi1:.4f} "
        f"chi2={chi.chi2:.4f} chi3={chi.chi3:.4f} "
        f"halo_nnz_fraction={ell.halo_nnz_fraction:.4f}; host build "
        f"{host_s:.2f} s")
    tdt = getattr(torch, dtype)
    x, w2 = (torch.randn((ell.D_pad, nb), generator=gen, device="cuda",
                         dtype=torch.complex128 if tdt.is_complex
                         else torch.float64).to(tdt) for _ in range(2))
    x[ell.D:] = 0
    w2[ell.D:] = 0
    a, b = 0.013, -0.4

    # the a2a engine built from the plain versions, on the card
    gp = ShardGroup(P, "cuda")
    spmv_p = make_spmv(ell, group=gp)
    step_p = make_fused_cheb_step(ell, group=gp)
    y_plain = spmv_p(x)
    s_plain = step_p(x, w2, a, b)
    plain_ms = time_ms(lambda: step_p(x, w2, a, b), 1, warmup=0)
    torch.cuda.synchronize()
    del spmv_p, step_p
    torch.cuda.empty_cache()
    base, rows = None, []
    for comm, sched, ov, pipe in ENGINES:
        name = engine_name(comm, sched, ov, pipe)
        torch.cuda.reset_peak_memory_stats()
        g = ShardGroup(P, "cuda")
        kw = dict(group=g, use_kernel=True, overlap=ov, comm=comm,
                  schedule=sched, pipeline=pipe)
        spmv = make_spmv(ell, **kw)
        step = make_fused_cheb_step(ell, **kw)
        y = spmv(x)
        kind = "all_to_all" if comm == "a2a" else "ppermute"
        moved = g.bytes[kind]
        want = (P * P * ell.L if comm == "a2a" else P * H[sched]) * nb * S
        s_ = step(x, w2, a, b)
        torch.cuda.synchronize()
        if base is None:
            if not (torch.equal(y, y_plain) and torch.equal(s_, s_plain)):
                raise SmokeFailure(f"engines {label}: the a2a engine differs "
                                   "from its plain version")
            base = (y, s_)
            del y_plain, s_plain
        bitwise = bool(torch.equal(y, base[0]) and torch.equal(s_, base[1]))
        loop_ok = True
        if ov:  # the side stream, again and again
            for _ in range(ENG_LOOP):
                loop_ok &= bool(torch.equal(step(x, w2, a, b), base[1]))
        del y, s_
        spmv_ms = time_ms(lambda: spmv(x), reps)
        step_ms = time_ms(lambda: step(x, w2, a, b), reps)
        ex_ms = time_ms(lambda: spmv.exchange(x), reps)
        peak = torch.cuda.max_memory_allocated()
        rec = dict(engine=name, bytes_moved=moved, bytes_predicted=want,
                   spmv_ms=spmv_ms, step_ms=step_ms, exchange_ms=ex_ms,
                   bitwise=bitwise, loop_bitwise=loop_ok,
                   max_memory_allocated=peak,
                   H=ell.P * ell.L if comm == "a2a" else H[sched])
        rows.append(rec)
        log(f"[engines] {label} {name}: step_ms={step_ms:.4f} "
            f"spmv_ms={spmv_ms:.4f} exchange_ms={ex_ms:.4f} (device copies "
            f"between shards on one card) bytes {moved} (predicted {want}) "
            f"bitwise={bitwise} loop_bitwise={loop_ok} "
            f"max_memory_allocated={peak} B")
        if moved != want:
            raise SmokeFailure(f"engines {label} {name}: moved {moved} B, "
                               f"predicted {want} B")
        if not (bitwise and loop_ok):
            raise SmokeFailure(f"engines {label} {name}: differs from the "
                               "a2a engine")
        del spmv, step, g
        torch.cuda.empty_cache()
    info.update(engines=rows, plain_step_ms=plain_ms)
    log(f"[engines] {label}: the a2a step from the plain versions "
        f"{plain_ms:.4f} ms")
    del x, w2, base, ell
    torch.cuda.empty_cache()
    return info


def tsqr_and_filter_case(gen) -> dict:
    """On Hubbard(12,6) at P = ``ENG_P``: TSQR of a random [D, 512] block
    against the one-shard QR, and one Chebyshev filter of degree
    ``FILTER_DEGREE`` through the a2a split-phase engine against the
    one-shard DIA route on the same block."""
    import torch

    from repro_torch.core import (ShardGroup, build_dist_ell, build_filter,
                                  chebyshev_filter, make_fused_cheb_step,
                                  make_spmv, make_tsqr, scale_params)
    from repro_torch.matrices import Hubbard

    mat = Hubbard(**HUBBARD)
    D = mat.D
    out = {}
    V = torch.randn((D, N_SEARCH), generator=gen, device="cuda",
                    dtype=torch.float64)
    g = ShardGroup(ENG_P, "cuda")
    tsqr = make_tsqr(g)
    Q, R = tsqr(V)
    torch.cuda.synchronize()
    nV = torch.linalg.norm(V)
    res = float(torch.linalg.norm(V - Q @ R) / nV)
    orth = float((Q.T @ Q - torch.eye(N_SEARCH, device="cuda",
                                      dtype=torch.float64)).abs().max())
    Q1, R1 = torch.linalg.qr(V)
    d, d1 = R.diagonal().abs(), R1.diagonal().abs()
    diag = float(((d - d1).abs() / d1).max())
    ms = time_ms(lambda: tsqr(V), 2)
    ms1 = time_ms(lambda: torch.linalg.qr(V), 2)
    del Q, R, Q1, R1
    torch.cuda.empty_cache()
    out["tsqr"] = dict(P=ENG_P, rows=D, cols=N_SEARCH, residual=res,
                       orthogonality=orth, diag_R_rel=diag, ms=ms,
                       qr_one_shard_ms=ms1, ppermute_bytes=g.bytes["ppermute"])
    log(f"[engines] TSQR Hubbard P={ENG_P} [{D} x {N_SEARCH}] fp64: "
        f"||V-QR||/||V||={res:.3e} ||Q^T Q - I||={orth:.3e} |diag R| vs "
        f"one-shard QR rel {diag:.3e}; {ms:.4f} ms (one-shard QR "
        f"{ms1:.4f} ms)")
    if not (res <= 1e-13 and orth <= 1e-12 and diag <= 1e-10):
        raise SmokeFailure("TSQR at P = 4 fails its checks")

    lam = mat.spectral_bounds_hint()  # encloses the spectrum
    alpha, beta = scale_params(*lam)
    poly = build_filter((lam[0], lam[0] + 0.1 * (lam[1] - lam[0])), lam,
                        degree=FILTER_DEGREE)
    ell1 = build_dist_ell(mat, 1, device="cuda")
    one = chebyshev_filter(make_spmv(ell1, use_kernel=True), poly.mu, alpha,
                           beta, V, fused_step=make_fused_cheb_step(
                               ell1, use_kernel=True))
    del ell1
    ell4 = build_dist_ell(mat, ENG_P, split_halo=True, device="cuda")
    kw = dict(group=g, use_kernel=True, overlap=True)
    four = chebyshev_filter(make_spmv(ell4, **kw), poly.mu, alpha, beta, V,
                            fused_step=make_fused_cheb_step(ell4, **kw))
    torch.cuda.synchronize()
    rel = float((four - one).abs().max() / one.abs().max())
    out["filter"] = dict(degree=FILTER_DEGREE, P=ENG_P, engine="a2a-overlap",
                         max_rel_to_max_Y=rel)
    log(f"[engines] Chebyshev filter degree {FILTER_DEGREE}, Hubbard "
        f"P={ENG_P} a2a-overlap vs P=1 DIA route: max|dY|/max|Y| = "
        f"{rel:.3e}")
    del one, four, ell4, V
    torch.cuda.empty_cache()
    if not rel <= 1e-10:
        raise SmokeFailure(f"filter at P = {ENG_P} differs from P = 1 by "
                           f"{rel:.3e}")
    return out


#: (comm, schedule, overlap) of the s-step filter's engines phase
SSTEP_ENGINES = (("a2a", "cyclic", False), ("compressed", "cyclic", False),
                 ("compressed", "cyclic", True),
                 ("compressed", "matching", False))
# timed filters of each cell (after the checked one): RoadNet's take
# ~10 ms and spread, Exciton's ~150 ms
SSTEP_REPS = dict(RoadNet=10, Exciton=3)


def sstep_filters_case(label: str, mat, dtype: str, nb: int, P: int,
                       degree: int, plain_s: int, gen) -> dict:
    """The s-step filter on ``mat`` at ``P`` shards, kernels on: for each
    engine of ``SSTEP_ENGINES`` the s = 1 filter (``chebyshev_filter``
    with the fused step) and the s = 2 and 3 filters
    (``make_sstep_cheb``) from one seeded block, each s-step filter
    bit-equal to the s = 1 one, its bytes and calls equal to ``P·
    sstep_collectives`` of ``comm_plan(sstep=s)``; the a2a filter at
    ``s = plain_s`` also bit-equal to the same filter from the plain
    versions on the card. Times (CUDA events), exchanges, launches and
    peak memory of each filter."""
    import numpy as np
    import torch

    from repro_torch.core import (ShardGroup, build_dist_ell, build_filter,
                                  build_sstep_ell, chebyshev_filter,
                                  make_fused_cheb_step, make_spmv,
                                  make_sstep_cheb, scale_params)
    from repro_torch.core.planner import comm_plan
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    ell = build_dist_ell(mat, P, dtype=dtype, split_halo=True, device="cuda")
    sells = {s: build_sstep_ell(mat, P, s, dtype=dtype, split_halo=True,
                                device="cuda") for s in (2, 3)}
    plans = {s: comm_plan(mat, P, sstep=s, d_pad=ell.D_pad) for s in sells}
    host_s = time.perf_counter() - t0
    for s, sell in sells.items():
        if not (plans[s].L == sell.L and np.array_equal(
                plans[s].pair_counts, sell.pair_counts)
                and plans[s].ghost_cum == sell.ghost_cum):
            raise SmokeFailure(f"s-step {label} s={s}: comm_plan predicts "
                               "other volumes than the built operator's")
    S = ell.vals.element_size()
    info = dict(case=label, P=P, n_b=nb, dtype=dtype, degree=degree,
                D_pad=ell.D_pad, R=ell.R, L1=ell.L, host_build_s=host_s,
                ops={s: dict(G=sell.G, L=sell.L, ghost_cum=sell.ghost_cum,
                             widths=[int(c.shape[2]) for c, _ in sell.steps],
                             work_factor=plans[s].sstep_work_factor())
                     for s, sell in sells.items()}, rows=[])
    log(f"[sstep] {label}: P={P} R={ell.R} L(s=1)={ell.L}; "
        + "; ".join(f"s={s} G={o['G']} L={o['L']} widths {o['widths']} "
                    f"ghost_cum {o['ghost_cum']} work factor "
                    f"{o['work_factor']:.4f}" for s, o in info["ops"].items())
        + f"; host build {host_s:.2f} s")
    tdt = ell.vals.dtype
    V = torch.randn((ell.D_pad, nb), generator=gen, device="cuda",
                    dtype=torch.complex128 if tdt.is_complex
                    else torch.float64).to(tdt)
    V[ell.D:] = 0
    lam = mat.spectral_bounds_hint()
    alpha, beta = scale_params(*lam)
    poly = build_filter((lam[0], lam[0] + 0.1 * (lam[1] - lam[0])), lam,
                        degree=degree)
    mu = poly.mu

    def measured(fn, g):
        """One filter: its result, launches and the group's counts."""
        g.reset_counts()
        before = dict(build.launches)
        torch.cuda.reset_peak_memory_stats()
        Y = fn()
        torch.cuda.synchronize()
        launches = sum(build.launches[k] - before[k] for k in before)
        return Y, launches, dict(g.bytes), dict(g.calls)

    for comm, sched, ov in SSTEP_ENGINES:
        kw = dict(overlap=ov, comm=comm, schedule=sched)
        name = engine_name(comm, sched, ov, False)
        g1 = ShardGroup(P, "cuda")
        spmv = make_spmv(ell, group=g1, use_kernel=True, pipeline=False, **kw)
        step = make_fused_cheb_step(ell, group=g1, use_kernel=True,
                                    pipeline=False, **kw)

        def one():
            return chebyshev_filter(spmv, mu, alpha, beta, V, fused_step=step)

        Y1, launches1, _, _ = measured(one, g1)
        ms1 = time_ms(one, SSTEP_REPS[label], warmup=0)
        row = dict(engine=name, s1_ms=ms1, s1_launches=launches1,
                   s1_exchanges=degree, cells=[])
        kind = "all_to_all" if comm == "a2a" else "ppermute"
        for s, sell in sells.items():
            g = ShardGroup(P, "cuda")
            f = make_sstep_cheb(sell, group=g, use_kernel=True, **kw)
            Y, launches, nbytes, ncalls = measured(
                lambda: f(V, mu, alpha, beta), g)
            peak = torch.cuda.max_memory_allocated()
            bitwise = bool(torch.equal(Y, Y1))
            terms = plans[s].sstep_collectives(comm, sched, nb, S, degree)
            want_bytes = P * sum(b * c for _, b, c in terms)
            want_calls = sum(c for _, _, c in terms)
            plain_ok = None
            if comm == "a2a" and s == plain_s:
                fp = make_sstep_cheb(sell, group=ShardGroup(P, "cuda"), **kw)
                plain_ok = bool(torch.equal(Y, fp(V, mu, alpha, beta)))
                torch.cuda.synchronize()
                del fp
            del Y
            ms = time_ms(lambda: f(V, mu, alpha, beta), SSTEP_REPS[label],
                         warmup=0)
            cell = dict(s=s, kind=f.kind, ms=ms, ratio_to_s1=ms / ms1,
                        launches=launches, exchanges=sell.n_groups(degree),
                        bytes=nbytes[kind], bytes_predicted=want_bytes,
                        calls=ncalls[kind], calls_predicted=want_calls,
                        bitwise_to_s1=bitwise, bitwise_to_plain=plain_ok,
                        max_memory_allocated=peak)
            row["cells"].append(cell)
            log(f"[sstep] {label} {f.kind} degree {degree}: filter "
                f"{ms:.4f} ms (s=1 {ms1:.4f} ms, ratio {ms / ms1:.3f}), "
                f"exchanges {cell['exchanges']} (s=1 {degree}), launches "
                f"{launches} (s=1 {launches1}), bytes {nbytes[kind]} "
                f"(predicted {want_bytes}), calls {ncalls[kind]} (predicted "
                f"{want_calls}), bitwise to s=1 {bitwise}"
                + ("" if plain_ok is None else
                   f", to the plain versions {plain_ok}")
                + f", max_memory_allocated {peak} B")
            where = f"s-step {label} {f.kind}"
            if not bitwise:
                raise SmokeFailure(f"{where}: differs from the s = 1 filter")
            if plain_ok is False:
                raise SmokeFailure(f"{where}: differs from its plain version")
            if nbytes[kind] != want_bytes or ncalls[kind] != want_calls:
                raise SmokeFailure(f"{where}: bytes/calls {nbytes[kind]}/"
                                   f"{ncalls[kind]}, predicted {want_bytes}/"
                                   f"{want_calls}")
            del f, g
            torch.cuda.empty_cache()
        info["rows"].append(row)
        del Y1, spmv, step, g1
        torch.cuda.empty_cache()
    del V, ell, sells
    torch.cuda.empty_cache()
    return info


def phase_engines() -> dict:
    """The eight engines on Hubbard(12,6) (fp64, n_b = 512) and
    Exciton(L=30) (complex128, n_b = 384) at P = 4 and on RoadNet(48000)
    (fp64, n_b = 64) at P = 8, then TSQR and the filter at P = 4."""
    import torch

    from repro_torch.matrices import Exciton, Hubbard, RoadNet

    gen = torch.Generator(device="cuda").manual_seed(2026)
    out = dict(cases=[
        engines_case("Hubbard", Hubbard(**HUBBARD), "float64", N_SEARCH, gen),
        engines_case("Exciton", Exciton(**EXCITON), "complex128",
                     EX_N_SEARCH, gen),
        engines_case("RoadNet", RoadNet(**ROADNET), "float64", RN_N_SEARCH,
                     gen, P=8, reps=50)])
    out.update(tsqr_and_filter_case(gen))
    out["sstep"] = [
        sstep_filters_case("RoadNet", RoadNet(**ROADNET), "float64",
                           RN_N_SEARCH, SSTEP_P, 16, 3, gen),
        sstep_filters_case("Exciton", Exciton(**EXCITON), "complex128",
                           EX_N_SEARCH, ENG_P, 8, 2, gen)]
    return out


# ------------------------------------------------------------- layouts --

LAYOUT_P = 4  # shards of the layouts phase
#: (n_row, n_col) of its layouts: stack 4 x 1, panel 2 x 2, pillar 1 x 4
LAYOUT_SPLITS = ((4, 1), (2, 2), (1, 4))
LAYOUT_ENGINE = dict(comm="compressed", schedule="matching")
LAYOUT_REPS = 3


def layouts_case(label: str, mat, dtype: str, N_s: int, gen) -> dict:
    """The vertical layer on ``mat`` at ``LAYOUT_P`` shards: for each
    layout of ``LAYOUT_SPLITS`` and each redistribution ``impl``, the
    block ``x [D_pad, N_s]`` (and ``w2``) to the panel layout, one fused
    filter step over every bundle through the N_row-shard engine, the
    result back to the stack layout; held bit for bit to the same step at
    full width through that engine, and that one to the same engine built
    from the plain versions on the same operator and inputs (at 1 × 4 the
    one-shard operator padded to D_pad, which the pillar solve builds);
    the round trip to ``x``; the bytes of
    the redistribution and of the step's halo exchange to their
    predictions; each part timed (CUDA events), peak memory."""
    import torch

    from repro_torch.core import (ShardGroup, build_dist_ell, layout_on_grid,
                                  make_fused_cheb_step, make_redistribute,
                                  redistribution_volume)

    P = LAYOUT_P
    t0 = time.perf_counter()
    ell_stack = build_dist_ell(mat, P, dtype=dtype, device="cuda")
    D, D_pad = ell_stack.D, ell_stack.D_pad
    S = ell_stack.vals.element_size()
    tdt = ell_stack.vals.dtype
    x, w2 = (torch.randn((D_pad, N_s), generator=gen, device="cuda",
                         dtype=torch.complex128 if tdt.is_complex
                         else torch.float64).to(tdt) for _ in range(2))
    x[D:] = 0
    w2[D:] = 0
    a, b = 0.013, -0.4
    rows = []
    for n_row, n_col in LAYOUT_SPLITS:
        name = "stack" if n_col == 1 else "pillar" if n_row == 1 else "panel"
        layout = layout_on_grid(name, n_row, n_col)
        ell = (ell_stack if n_row == P else
               build_dist_ell(mat, n_row, dtype=dtype, d_pad=D_pad,
                              device="cuda"))
        H = (ell.neighbor_plan(schedule=LAYOUT_ENGINE["schedule"]).H
             if ell.P > 1 else 0)
        n_c = N_s // n_col
        # the full-width step through the same N_row-shard engine, and the
        # same engine from the plain versions
        full = make_fused_cheb_step(ell, group=ShardGroup(n_row, "cuda"),
                                    use_kernel=True, **LAYOUT_ENGINE)
        want = full(x, w2, a, b)
        plain = make_fused_cheb_step(ell, group=ShardGroup(n_row, "cuda"),
                                     **LAYOUT_ENGINE)(x, w2, a, b)
        torch.cuda.synchronize()
        full_vs_plain = bool(torch.equal(want, plain))
        log(f"[layouts] {label} {n_row} shards, full width {N_s}: "
            f"{full.kind} step vs the plain versions bitwise={full_vs_plain}")
        del plain
        if not full_vs_plain:
            raise SmokeFailure(f"layouts {label}: the {n_row}-shard "
                               f"{full.kind} step differs from its plain "
                               "version")
        want_redist = int(redistribution_volume(D_pad, N_s, P, n_col,
                                                S)["bytes_total"])
        want_halo = n_col * n_row * H * n_c * S
        for impl in ("explicit", "gspmd"):
            torch.cuda.reset_peak_memory_stats()
            grid = layout.shards("cuda")
            step = make_fused_cheb_step(ell, group=grid.panel,
                                        use_kernel=True, **LAYOUT_ENGINE)
            to_panel, to_stack = make_redistribute(grid.stack, n_col, impl)
            # [n_col, D_pad, n_c]; at n_col = 1 a view of the block
            xp = to_panel(x)
            redist = grid.stack.bytes["redistribute"]
            w2p = to_panel(w2)

            def filt():
                return [step(xj, w2j, a, b) for xj, w2j in zip(xp, w2p)]

            halo0 = dict(grid.panel.bytes)
            yp = filt()
            halo = sum(grid.panel.bytes[k] - halo0[k]
                       for k in ("all_to_all", "ppermute"))
            y, back = to_stack(yp), to_stack(xp)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(y, want))
            round_trip = bool(torch.equal(back, x))
            del y, back
            to_panel_ms = time_ms(lambda: to_panel(x), LAYOUT_REPS)
            step_ms = time_ms(filt, LAYOUT_REPS)
            to_stack_ms = time_ms(lambda: to_stack(yp), LAYOUT_REPS)
            peak = torch.cuda.max_memory_allocated()
            rec = dict(layout=layout.describe(), impl=impl, n_c=n_c,
                       route=step.kind, redistribute_bytes=redist,
                       redistribute_bytes_predicted=want_redist,
                       halo_bytes=halo, halo_bytes_predicted=want_halo,
                       to_panel_ms=to_panel_ms, step_ms=step_ms,
                       to_stack_ms=to_stack_ms, bitwise=bitwise,
                       full_width_vs_plain=full_vs_plain,
                       round_trip=round_trip, max_memory_allocated=peak)
            rows.append(rec)
            log(f"[layouts] {label} {layout.describe()} {impl}: bundles of "
                f"{n_c} ({step.kind}) to_panel_ms={to_panel_ms:.4f} "
                f"step_ms={step_ms:.4f} to_stack_ms={to_stack_ms:.4f} "
                f"redistribute bytes {redist} (predicted {want_redist}) "
                f"halo bytes {halo} (predicted {want_halo}) "
                f"bitwise={bitwise} round_trip={round_trip} "
                f"max_memory_allocated={peak} B")
            where = f"layouts {label} {layout.describe()} {impl}"
            if not bitwise:
                raise SmokeFailure(f"{where}: differs from the full-width "
                                   "step")
            if not round_trip:
                raise SmokeFailure(f"{where}: the round trip is not exact")
            if redist != want_redist or halo != want_halo:
                raise SmokeFailure(f"{where}: bytes {redist}/{halo}, "
                                   f"predicted {want_redist}/{want_halo}")
            del xp, w2p, yp, step, grid
            torch.cuda.empty_cache()
        del want, full
        if ell is not ell_stack:
            del ell
        torch.cuda.empty_cache()
    info = dict(case=label, P=P, D=D, D_pad=D_pad, N_s=N_s, dtype=dtype,
                engine="compressed-matching", rows=rows,
                build_s=time.perf_counter() - t0)
    del x, w2, ell_stack
    torch.cuda.empty_cache()
    return info


def phase_layouts() -> dict:
    """The layouts stack 4 x 1, panel 2 x 2 and pillar 1 x 4 on
    Hubbard(12,6) (fp64, N_s = 512) and Exciton(L=30) (complex128,
    N_s = 384)."""
    import torch

    from repro_torch.matrices import Exciton, Hubbard

    gen = torch.Generator(device="cuda").manual_seed(2027)
    return dict(cases=[
        layouts_case("Hubbard", Hubbard(**HUBBARD), "float64", N_SEARCH, gen),
        layouts_case("Exciton", Exciton(**EXCITON), "complex128",
                     EX_N_SEARCH, gen)])


def determinism_case() -> dict:
    """One outer iteration of the Exciton solve (``orthogonalize``,
    ``ritz``, a degree-16 filter, kernels on) twice from the same seeded
    block: the two must be bit-equal; the SHA-256 of the outputs is
    printed so that two runs (two processes, two cards) can be compared."""
    import hashlib

    import torch

    from repro_torch.core import (FDConfig, FilterDiag, build_filter,
                                  chebyshev_filter, scale_params)
    from repro_torch.matrices import Exciton

    mat = Exciton(**EXCITON)
    fd = FilterDiag(mat, FDConfig(n_search=EX_N_SEARCH, layout="stack",
                                  spmv_kernel=True), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2028)
    V0 = torch.randn((fd.D_pad, EX_N_SEARCH), generator=gen, device="cuda",
                     dtype=torch.float64).to(fd.dtype)
    lam = mat.spectral_bounds_hint()
    alpha, beta = scale_params(*lam)
    poly = build_filter((lam[0], lam[0] + 0.1 * (lam[1] - lam[0])), lam,
                        degree=16)

    def iteration() -> list:
        Q = fd.orthogonalize(V0)
        theta, Y, res, VY = fd.ritz(Q)
        out = chebyshev_filter(fd.spmv, poly.mu, alpha, beta, VY,
                               fused_step=fd.fused_step)
        torch.cuda.synchronize()
        return [Q, theta, Y, res, VY, out]

    first = iteration()
    digest = hashlib.sha256()
    for t in first:
        digest.update(t.cpu().numpy().tobytes())
    second = iteration()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    del first, second, fd, V0
    torch.cuda.empty_cache()
    rec = dict(case="Exciton(L=30) c128 N_s=384, one outer iteration",
               bitwise=dict(zip(("Q", "theta", "Y", "res", "VY", "filter"),
                                same)),
               sha256=digest.hexdigest())
    log(f"[determinism] {rec['case']}: twice bit-equal {rec['bitwise']}; "
        f"sha256 {rec['sha256']}")
    if not all(same):
        raise SmokeFailure(f"one outer iteration is not deterministic on "
                           f"the card: {rec['bitwise']}")
    return rec


FIT_REPS = 10  # timed steps of each fit sample (after one warm-up)


def phase_plan(layouts: dict, fit_path: str) -> dict:
    """The fit on the card, the rankings it gives beside the layouts
    phase's measured times, and the sampled χ beside the exact one."""
    import math

    from repro_torch.core.planner import comm_plan, plan_layout
    from repro_torch.core.sketch import estimate_comm
    from repro_torch.launch.dryrun import fit_machine
    from repro_torch.matrices import Exciton, HubNet, Hubbard

    t0 = time.perf_counter()
    fit, samples = fit_machine(Hubbard(**HUBBARD), fit_path,
                               n_devices=LAYOUT_P, n_search=N_SEARCH,
                               reps=FIT_REPS, device="cuda")
    rec = dict(fit=dict(name=fit.name, b_m=fit.b_m, b_c=fit.b_c,
                        kappa=fit.kappa, alpha=fit.alpha, path=fit_path,
                        seconds=time.perf_counter() - t0),
               samples=samples, rankings=[], sampled=[])
    log(f"[plan] fit in {rec['fit']['seconds']:.1f} s: b_m "
        f"{fit.b_m / 1e9:.1f} GB/s (measured), b_c {fit.b_c / 1e9:.2f} GB/s, "
        f"kappa {fit.kappa:.4f}, alpha {fit.alpha * 1e6:.2f} us -> {fit_path}")
    if not math.isfinite(fit.b_c) or fit.kappa <= 0:
        raise SmokeFailure(f"the fit prices communication as free or the "
                           f"vectors as free: b_c={fit.b_c}, "
                           f"kappa={fit.kappa}")
    measured = {c["case"]: {r["layout"]: r for r in c["rows"]
                            if r["impl"] == "explicit"}
                for c in layouts["cases"]}
    for label, mat, N_s in (("Hubbard", Hubbard(**HUBBARD), N_SEARCH),
                            ("Exciton", Exciton(**EXCITON), EX_N_SEARCH)):
        P = LAYOUT_P
        t0 = time.perf_counter()
        plan = plan_layout(mat, P, n_search=N_s, machine=fit,
                           splits=LAYOUT_SPLITS, balance=("rows",),
                           kernel=(True,), d_pad=-(-mat.D // P) * P)
        host_s = time.perf_counter() - t0
        rows = []
        for n_row, n_col in LAYOUT_SPLITS:
            comm = "compressed" if n_row > 1 else "a2a"
            c = next(c for c in plan.candidates
                     if (c.n_row, c.n_col) == (n_row, n_col)
                     and c.comm == comm and not c.overlap
                     and c.schedule == ("matching" if n_row > 1
                                        else "cyclic"))
            m = measured[label][f"{c.layout}({n_row}x{n_col})"]
            row = dict(candidate=c.describe(), step_ms_predicted=P * c.t_iter
                       * 1e3, redist_ms_predicted=P * c.t_redist * 1e3,
                       step_ms_measured=m["step_ms"],
                       redist_ms_measured=(m["to_panel_ms"]
                                           + m["to_stack_ms"]) / 2)
            rows.append(row)
            log(f"[plan] {label} {row['candidate']}: a step predicted "
                f"{row['step_ms_predicted']:.4f} ms, measured "
                f"{row['step_ms_measured']:.4f} ms; a redistribution "
                f"predicted {row['redist_ms_predicted']:.4f} ms, measured "
                f"{row['redist_ms_measured']:.4f} ms")
        best = [dict(candidate=c.describe(), t_pass_ms=c.t_pass * 1e3)
                for c in plan.candidates[:3]]
        log(f"[plan] {label} best three of {len(plan.candidates)} "
            f"(planned in {host_s:.3f} s on the host): "
            + "; ".join(f"{b['candidate']} t_pass {b['t_pass_ms']:.3f} ms"
                        for b in best))
        rec["rankings"].append(dict(case=label, P=P, N_s=N_s,
                                    host_seconds=host_s, best=best,
                                    rows=rows))
    mat = HubNet(**HUBNET)
    t0 = time.perf_counter()
    exact = comm_plan(mat, 8).chi
    exact_s = time.perf_counter() - t0
    for fraction in (None, 0.25):
        t0 = time.perf_counter()
        est = estimate_comm(mat, 8, fraction=fraction, seed=0)
        r = dict(fraction=est.fraction, sampled_rows=est.sampled_rows,
                 host_seconds=time.perf_counter() - t0,
                 exact_host_seconds=exact_s,
                 exact=[exact.chi1, exact.chi2, exact.chi3],
                 sampled=[est.chi.chi1, est.chi.chi2, est.chi.chi3],
                 band=[est.band.chi1, est.band.chi2, est.band.chi3],
                 band_contains_exact=est.band.contains(exact))
        rec["sampled"].append(r)
        log(f"[plan] HubNet(48000) P=8 chi1/chi2/chi3: exact "
            f"{r['exact']} ({exact_s:.3f} s); sampled at fraction "
            f"{r['fraction']:.4g} ({r['sampled_rows']} rows, "
            f"{r['host_seconds']:.3f} s) {r['sampled']}, band {r['band']} "
            f"(level {est.band.level}), contains the exact "
            f"{r['band_contains_exact']}")
    # the sampled planner (sampled chi, the coarsened commvol descent),
    # which the auto solve no longer takes: its s-step axis needs the
    # exact pattern pass
    t0 = time.perf_counter()
    plan = plan_layout(mat, 8, n_search=HN_N_SEARCH, machine=fit,
                       kernel=(True,), plan_mode="sampled",
                       d_pad=-(-mat.D // 8) * 8)
    rec["sampled_plan"] = dict(
        host_seconds=time.perf_counter() - t0,
        best=[dict(candidate=c.describe(), t_pass_ms=c.t_pass * 1e3)
              for c in plan.candidates[:3]])
    log(f"[plan] HubNet(48000) P=8 sampled plan_layout in "
        f"{rec['sampled_plan']['host_seconds']:.3f} s on the host, best "
        "three: " + "; ".join(f"{b['candidate']} t_pass {b['t_pass_ms']:.3f}"
                              f" ms" for b in rec["sampled_plan"]["best"]))
    return rec


def sstep_plan_case(fit_path: str, solves: dict) -> dict:
    """``plan_layout``'s s ∈ {1, 3} stack candidates at P = 8 for HubNet
    and RoadNet under the plan phase's fit, each at its solve's mean
    filter degree: one card's predicted step (``P·t_iter``) beside the
    measured wall per filter step of the s = 1 and s = 3 solves (the
    whole solve's wall over its filter steps)."""
    import numpy as np

    from repro_torch.core import perf_model as pm
    from repro_torch.core.planner import plan_layout
    from repro_torch.matrices import HubNet, RoadNet

    fit = pm.resolve_machine(fit_path)
    P = SSTEP_P
    out = []
    for label, fam, params, n_s, s1, s3, comm in (
            ("HubNet", HubNet, HUBNET, HN_N_SEARCH, "hubnet_p8", "hubnet_s3",
             ("compressed", "matching", False)),
            ("RoadNet", RoadNet, ROADNET, RN_N_SEARCH, "roadnet_p8",
             "roadnet_s3", ("compressed", "cyclic", True))):
        mat = fam(**params)
        degree = int(round(np.mean(solves[s1]["degrees"])))
        t0 = time.perf_counter()
        plan = plan_layout(mat, P, n_search=n_s, machine=fit,
                           splits=[(P, 1)], balance=("rows",),
                           kernel=(True,), sstep=(1, SSTEP), degree=degree,
                           d_pad=-(-mat.D // P) * P)
        host_s = time.perf_counter() - t0
        rows = []
        for c in plan.candidates:
            rows.append(dict(candidate=c.describe(), sstep=c.sstep,
                             t_iter_ms=c.t_iter * 1e3,
                             card_step_ms=P * c.t_iter * 1e3))
        log(f"[plan] {label} P={P} s in {{1, {SSTEP}}} at degree {degree} "
            f"({host_s:.3f} s on the host): " + "; ".join(
                f"{r['candidate']} t_iter {r['t_iter_ms']:.4f} ms"
                for r in rows))
        comm_, sched, ov = comm
        pick = {}
        for s, solve in ((1, s1), (SSTEP, s3)):
            # the solve's engine; the planner has no overlap at s > 1
            c = next(c for c in plan.candidates
                     if c.sstep == s and c.comm == comm_
                     and c.schedule == sched and c.overlap == (ov and s == 1))
            steps = sum(solves[solve]["degrees"])
            pick[s] = dict(solve=solve, candidate=c.describe(),
                           card_step_ms_predicted=P * c.t_iter * 1e3,
                           wall_per_step_ms=solves[solve]["wall_s"] / steps
                           * 1e3, filter_steps=steps)
        pred = pick[SSTEP]["card_step_ms_predicted"] / pick[1][
            "card_step_ms_predicted"]
        meas = pick[SSTEP]["wall_per_step_ms"] / pick[1]["wall_per_step_ms"]
        for s in (1, SSTEP):
            r = pick[s]
            log(f"[plan] {label} {r['candidate']} ({r['solve']}): a step "
                f"predicted {r['card_step_ms_predicted']:.4f} ms, measured "
                f"{r['wall_per_step_ms']:.4f} ms a filter step (the solve's "
                f"wall over its {r['filter_steps']} filter steps)")
        log(f"[plan] {label} s={SSTEP} / s=1: predicted {pred:.3f}, "
            f"measured {meas:.3f}")
        out.append(dict(case=label, P=P, degree=degree, host_seconds=host_s,
                        candidates=rows, picks=pick, ratio_predicted=pred,
                        ratio_measured=meas))
    return out


def host_operator(fam, params: dict, which: str):
    """The family's scipy CSR and the host eigsh estimate of its lowest
    (``which="SA"``) or highest (``"LA"``) eigenvalue, a Ritz value (so
    ``estimate − 0.1`` lies below the spectrum, ``+ 0.1`` above it, while
    it is within 0.1). ARPACK starts from a seeded vector and the estimate
    is rounded to 1e-6, so the targets, and with them the solves' paths,
    are the same from run to run (an unseeded start, drawn from ARPACK's
    own seed that persists from call to call, moved the Exciton target in
    its 16th digit between runs, and with it the solve's converged
    count)."""
    import numpy as np
    import scipy.sparse.linalg as sla

    t0 = time.perf_counter()
    A = fam(**params).build_csr().to_scipy()
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    lam = float(sla.eigsh(A, k=1, which=which, tol=1e-4, ncv=64, v0=v0,
                          return_eigenvectors=False)[0])
    lam = round(lam, 6)
    log(f"[solve] {fam.__name__} host CSR + eigsh {which} {lam:.6f} in "
        f"{time.perf_counter() - t0:.2f} s")
    return A, lam


def run_solve(label: str, family: str, params: dict, A, *, n_search: int,
              n_target: int, target: float, max_iters: int,
              launched: dict, dtype: str = "float64", tol: float = 1e-10,
              layout: str = "stack", engine: tuple = ()) -> dict:
    """One solve through the CLI, its launch counts set to 0 just before
    and read just after (``launched`` maps each kernel to whether it must
    launch), every returned pair re-checked on the host against ``A``.
    ``layout`` is the filter's layout (``--layout``), ``engine`` holds the
    CLI's grid, engine and row-map flags (``--n-row``, ``--n-col`` ...)."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import solve as cli

    import contextlib

    argv = ["--family", family,
            "--params", ",".join(f"{k}={v:g}" for k, v in params.items()),
            "--n-search", str(n_search), "--n-target", str(n_target),
            "--target", repr(target), "--tol", repr(tol),
            "--max-iters", str(max_iters), "--layout", layout,
            "--dtype", dtype, "--spmv-kernel", "--device", "cuda",
            *engine]
    log(f"[solve {label}] python -m repro_torch.launch.solve " + " ".join(argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    printed = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    degrees = [h.get("degree") for h in res.history if "degree" in h]
    late = res.history[-1].get("unconverged", [])
    ex = res.exchange
    log(f"[solve {label}] wall {wall:.3f} s, iterations {res.iterations}, "
        f"converged {res.n_converged}/{n_target}, degrees {degrees}, "
        f"max_memory_allocated {peak} B, launches {launches}, filter "
        f"{ex['filter_engine']} (depth {ex['sstep']}) with "
        f"{ex['filter_exchanges']} halo exchanges; the "
        f"window's unconverged (theta, residual) at the stop: {late}")
    if res.n_converged < n_target:
        raise SmokeFailure(f"{label} solve converged {res.n_converged} < "
                           f"{n_target}")
    for k, must in launched.items():
        if must and launches[k] <= 0:
            raise SmokeFailure(f"kernel {k} was never launched on the "
                               f"{label} path")
        if not must and launches[k] != 0:
            raise SmokeFailure(f"kernel {k} launched {launches[k]} times on "
                               f"the {label} path, which should not take it")
    if launched.get("ell_gather_cheb"):
        # each fused step of a bundle's filter is one epilogue launch for
        # all its row shards: N_col launches a step
        ex = res.exchange
        n_col = ex["P"] // (ex["panel"]["P"] if ex["panel"] else ex["P"])
        want = n_col * sum(d - 1 for d in degrees)
        log(f"[solve {label}] ell_gather_cheb launches "
            f"{launches['ell_gather_cheb']}, {n_col} bundle(s) × "
            f"{want // max(n_col, 1)} fused steps")
        if launches["ell_gather_cheb"] != want:
            raise SmokeFailure(f"{label}: ell_gather_cheb launched "
                               f"{launches['ell_gather_cheb']} times, not one "
                               f"a fused step of each of {n_col} bundles "
                               f"({want})")
    X, theta = res.eigenvectors, res.eigenvalues
    if not (np.isfinite(theta).all() and np.isfinite(X).all()
            and X.shape == (A.shape[0], len(theta))
            and len(theta) >= n_target):
        raise SmokeFailure(f"{label}: bad result: eigenvalues {theta.shape}, "
                           f"vectors {X.shape}")
    resid = np.linalg.norm(A @ X - X * theta, axis=0)
    log(f"[solve {label}] host re-check: max ||A x - theta x|| = "
        f"{resid.max():.3e} over {len(theta)} pairs; eigenvalues "
        f"{theta.min():.12f} .. {theta.max():.12f}")
    if not (resid <= 1e-8).all():
        raise SmokeFailure(f"{label}: host residual {resid.max():.3e} > 1e-8")
    log(f"[solve {label}] {res.exchange['layout']}: redistributions "
        f"{res.redistributions} in {res.redist_time:.3f} s, bytes "
        f"{res.exchange['bytes']}"
        + (f"; panel level {res.exchange['panel']['bytes']}"
           if res.exchange["panel"] else ""))
    return dict(wall_s=wall, iterations=res.iterations,
                n_converged=res.n_converged, degrees=degrees,
                redistributions=res.redistributions,
                redist_time_s=res.redist_time,
                total_spmvs=res.total_spmvs, max_memory_allocated=peak,
                launches=launches, host_residual_max=float(resid.max()),
                eigenvalues=[float(t) for t in theta], target=target,
                unconverged_at_stop=late,
                dtype=str(X.dtype), exchange=res.exchange,
                filter_exchanges=ex["filter_exchanges"],
                eigenvalues_hex=[float(t).hex() for t in theta],
                argv=" ".join(argv), printed=printed.getvalue())


class _Tee:
    """A stream that writes to ``out`` and keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def getvalue(self) -> str:
        """What was written, without the per-iteration ``[fd]`` lines."""
        return "".join(line for line in "".join(self.parts).splitlines(True)
                       if not line.startswith("[fd]"))


def closest(values, target: float, n: int):
    """The ``n`` of ``values`` closest to ``target``, sorted."""
    import numpy as np

    v = np.asarray(values)
    return np.sort(v[np.argsort(np.abs(v - target))[:n]])


def agree(out: dict, label: str, other: str, n: int, tol: float = 1e-9):
    """Hold solve ``label``'s ``n`` eigenvalues closest to its target to
    those of solve ``other`` (the same target), to ``tol``."""
    import numpy as np

    t = out[label]["target"]
    dev = float(np.abs(closest(out[label]["eigenvalues"], t, n)
                       - closest(out[other]["eigenvalues"], t, n)).max())
    out[label][f"max_dev_from_{other}"] = dev
    log(f"[solve {label}] eigenvalues vs the {other} solve: max |d| = "
        f"{dev:.3e}")
    if not dev <= tol:
        raise SmokeFailure(f"{label} differs from {other} by {dev:.3e}")


def agree_returned(out: dict, label: str, other: str, n: int,
                   tol: float = 1e-9):
    """Hold every eigenvalue that solve ``label`` returned (at least
    ``n``) to one that solve ``other`` returned, to ``tol``, counted with
    multiplicity: the pairs both returned agree. FD stops once ``n``
    Ritz pairs inside the target window have converged, so the returned
    set may step over a pair of the window that converges later; those of
    ``other``'s ``n`` closest to the target that ``label`` did not
    return are logged and recorded as ``not_returned``."""
    import numpy as np

    a = np.sort(out[label]["eigenvalues"])
    b = np.sort(out[other]["eigenvalues"])
    dev = float(max(np.abs(b - v).min() for v in a))
    short = [float(v) for v in a if (np.abs(a - v) <= tol).sum()
             > (np.abs(b - v) <= tol).sum()]
    want = closest(b, out[label]["target"], n)
    missed = sorted({float(v) for v in want if (np.abs(a - v) <= tol).sum()
                     < (np.abs(want - v) <= tol).sum()})
    # each stepped-over value beside the nearest pair of the window that
    # had not converged when the solve stopped
    late = out[label].get("unconverged_at_stop", [])
    near = [min(late, key=lambda tr: abs(tr[0] - v)) if late else None
            for v in missed]
    out[label][f"max_dev_from_{other}"] = dev
    out[label]["not_returned"] = [dict(value=v, unconverged_at_stop=tr)
                                  for v, tr in zip(missed, near)]
    log(f"[solve {label}] its {len(a)} eigenvalues vs the {other} solve's: "
        f"max |d| = {dev:.3e}; of {other}'s {n} closest to the target not "
        f"returned (each beside the nearest unconverged (theta, residual) "
        f"of the window at the stop): {list(zip(missed, near))}")
    if len(a) < n or not dev <= tol or short:
        raise SmokeFailure(f"{label} differs from {other}: {len(a)} values, "
                           f"max |d| {dev:.3e}, multiplicities {short}")


def agree_bitwise(out: dict, label: str, other: str) -> None:
    """Hold solve ``label`` (the s-step filter) to solve ``other`` (its
    s = 1 partner, from the same draws): the same iterations and filter
    degrees, and the same eigenvalues bit for bit."""
    a, b = out[label], out[other]
    same = dict(iterations=a["iterations"] == b["iterations"],
                degrees=a["degrees"] == b["degrees"],
                eigenvalues=a["eigenvalues_hex"] == b["eigenvalues_hex"])
    a[f"bitwise_to_{other}"] = same
    log(f"[solve {label}] vs {other}: {same}; wall {a['wall_s']:.3f} / "
        f"{b['wall_s']:.3f} s, launches {a['launches']} / {b['launches']}, "
        f"filter exchanges {a['filter_exchanges']} / "
        f"{b['filter_exchanges']}, max_memory_allocated "
        f"{a['max_memory_allocated']} / {b['max_memory_allocated']} B")
    if not all(same.values()):
        raise SmokeFailure(f"{label} differs from {other}: {same}")


def grid(n_row_col) -> tuple:
    """The CLI's grid flags of ``(n_row, n_col)``."""
    return ("--n-row", str(n_row_col[0]), "--n-col", str(n_row_col[1]))


def phase_solves(fit_path: str) -> dict:
    from repro_torch.matrices import Exciton, HubNet, Hubbard, RoadNet

    both = dict(ell_gather=True, ell_gather_cheb=False, cheb_dia=True)
    ell_route = dict(ell_gather=True, ell_gather_cheb=True, cheb_dia=False)
    out = {}
    # a Ritz value from above: τ = estimate − 0.1 lies below the spectrum
    # as long as the estimate is within 0.1 of the lowest eigenvalue
    A, lam = host_operator(Hubbard, HUBBARD_SOLVE, "SA")
    out["hubbard"] = run_solve(
        "hubbard", "Hubbard", HUBBARD_SOLVE, A, n_search=N_SEARCH,
        n_target=N_TARGET, target=lam - 0.1, max_iters=MAX_ITERS,
        launched=both, tol=CUT_TOL)
    out["hubbard"]["eigsh_lower_edge"] = lam
    del A
    A, lam = host_operator(Exciton, EXCITON_SOLVE, "SA")
    out["exciton"] = run_solve(
        "exciton", "Exciton", EXCITON_SOLVE, A, n_search=EX_N_SEARCH,
        n_target=EX_STACK_N_TARGET, target=lam - 0.1, max_iters=EX_MAX_ITERS,
        launched=both)
    out["exciton"]["eigsh_lower_edge"] = lam
    # the vertical layer: the exciton200 config's pillar layout, its N_t
    out["exciton_pillar"] = run_solve(
        "exciton_pillar", "Exciton", EXCITON_SOLVE, A, n_search=EX_N_SEARCH,
        n_target=EX_N_TARGET, target=lam - 0.1, max_iters=EX_MAX_ITERS,
        launched=both, layout="pillar", engine=grid(EX_PILLAR))
    agree_returned(out, "exciton", "exciton_pillar", EX_STACK_N_TARGET)
    del A
    # the upper edge: the lowest eigenvalues of a 48,000-node Laplacian lie
    # within 1e-5 of 0 and hold every filter degree at its 200,000 cap
    A, lam = host_operator(RoadNet, ROADNET, "LA")
    out["roadnet"] = run_solve(
        "roadnet", "RoadNet", ROADNET, A, n_search=RN_N_SEARCH,
        n_target=RN_N_TARGET, target=lam + 0.1, max_iters=RN_MAX_ITERS,
        launched=ell_route)
    out["roadnet"]["eigsh_upper_edge"] = lam
    # the horizontal layer: 8 row shards on the card, the same draws
    out["roadnet_p8"] = run_solve(
        "roadnet_p8", "RoadNet", ROADNET, A, n_search=RN_N_SEARCH,
        n_target=RN_N_TARGET, target=lam + 0.1, max_iters=RN_MAX_ITERS,
        launched=ell_route, engine=("--n-row", "8", "--spmv-comm",
                                    "compressed", "--spmv-overlap"))
    agree(out, "roadnet_p8", "roadnet", RN_N_TARGET)
    # the s-step filter on the same engine, from the same draws
    out["roadnet_s3"] = run_solve(
        "roadnet_s3", "RoadNet", ROADNET, A, n_search=RN_N_SEARCH,
        n_target=RN_N_TARGET, target=lam + 0.1, max_iters=RN_MAX_ITERS,
        launched=ell_route, engine=("--n-row", str(SSTEP_P), "--spmv-comm",
                                    "compressed", "--spmv-overlap",
                                    "--spmv-sstep", str(SSTEP)))
    agree_bitwise(out, "roadnet_s3", "roadnet_p8")
    # the pillar 1 x 8 on the RCM map: no halo in the filter
    out["roadnet_pillar"] = run_solve(
        "roadnet_pillar", "RoadNet", ROADNET, A, n_search=RN_N_SEARCH,
        n_target=RN_N_TARGET, target=lam + 0.1, max_iters=RN_MAX_ITERS,
        launched=ell_route, layout="pillar",
        engine=grid(RN_PILLAR) + ("--spmv-reorder", "rcm"))
    agree(out, "roadnet_pillar", "roadnet", RN_N_TARGET)
    del A
    A, lam = host_operator(HubNet, HUBNET, "LA")
    out["hubnet_p8"] = run_solve(
        "hubnet_p8", "HubNet", HUBNET, A, n_search=HN_N_SEARCH,
        n_target=HN_N_TARGET, target=lam + 0.1, max_iters=HN_MAX_ITERS,
        launched=ell_route, engine=("--n-row", "8", "--spmv-comm",
                                    "compressed", "--spmv-schedule",
                                    "matching"))
    out["hubnet_p8"]["eigsh_upper_edge"] = lam
    out["hubnet_s3"] = run_solve(
        "hubnet_s3", "HubNet", HUBNET, A, n_search=HN_N_SEARCH,
        n_target=HN_N_TARGET, target=lam + 0.1, max_iters=HN_MAX_ITERS,
        launched=ell_route, engine=("--n-row", str(SSTEP_P), "--spmv-comm",
                                    "compressed", "--spmv-schedule",
                                    "matching", "--spmv-sstep", str(SSTEP)))
    agree_bitwise(out, "hubnet_s3", "hubnet_p8")
    # the panel 4 x 2 on the commvol map (D_pad 72,000)
    out["hubnet_panel"] = run_solve(
        "hubnet_panel", "HubNet", HUBNET, A, n_search=HN_N_SEARCH,
        n_target=HN_N_TARGET, target=lam + 0.1, max_iters=HN_MAX_ITERS,
        launched=ell_route, layout="panel",
        engine=grid(HN_PANEL) + ("--spmv-comm", "compressed",
                                 "--spmv-schedule", "matching",
                                 "--spmv-balance", "commvol"))
    agree(out, "hubnet_panel", "hubnet_p8", HN_N_TARGET)
    # the planner's choice on the card's fitted model (the plan phase),
    # the s-step axis in the ranking (exact pattern passes: plan mode auto
    # at this size; the sampled planner runs in the plan phase)
    out["hubnet_auto"] = run_solve(
        "hubnet_auto", "HubNet", HUBNET, A, n_search=HN_N_SEARCH,
        n_target=HN_N_TARGET, target=lam + 0.1, max_iters=HN_MAX_ITERS,
        launched=ell_route, layout="auto",
        engine=("--n-row", "8", "--plan-mode", "auto", "--spmv-sstep",
                str(SSTEP), "--machine", fit_path))
    ran = out["hubnet_auto"]["exchange"]
    printed = out["hubnet_auto"]["printed"]
    s_cands = [line.split()[0] for line in printed.splitlines()
               if f"+s{SSTEP}(" in line.split(" ", 1)[0]]
    chosen = [line for line in printed.splitlines()
              if line.startswith("[auto]")]
    out["hubnet_auto"]["sstep_candidates"] = s_cands
    log(f"[solve hubnet_auto] the planner ran {ran['layout']} with the "
        f"{ran['filter_engine']} filter (depth {ran['sstep']}); {chosen}; "
        f"+s{SSTEP} candidates in its report: {s_cands}")
    if not s_cands:
        raise SmokeFailure(f"the auto solve's plan lists no +s{SSTEP} "
                           "candidate")
    agree(out, "hubnet_auto", "hubnet_p8", HN_N_TARGET)
    return out


# ---------------------------------------------------------------------------
# phase 8: one process per shard (the ranks phase)
# ---------------------------------------------------------------------------

def ranks_cases(solves: dict) -> list:
    """The ranks phase's solves, each at its config's N_s, n_target and
    dtype and at the solves phase's target: a label, the family and its
    parameters, the grid ``(n_row, n_col)``, the layout, the engine flags
    and the solve's knobs."""
    rn = dict(family="RoadNet", params=ROADNET, n_search=RN_N_SEARCH,
              n_target=RN_N_TARGET, target=solves["roadnet"]["target"],
              max_iters=RN_MAX_ITERS, tol=1e-10)
    return [
        dict(rn, label="roadnet_stack", grid=RANKS_STACK, layout="stack",
             engine=["--spmv-comm", "compressed", "--spmv-overlap"]),
        dict(rn, label="roadnet_panel", grid=RANKS_PANEL, layout="panel",
             engine=[]),
        # the s-step filter on ranks: one depth-3 exchange of
        # torch.distributed calls per 3 steps
        dict(rn, label="roadnet_sstep", grid=RANKS_STACK, layout="stack",
             engine=["--spmv-comm", "compressed", "--spmv-overlap",
                     "--spmv-sstep", str(SSTEP)]),
        # the compressed matching rounds at the stack level (the pillar's
        # filter has no halo): at P = 4 they move 23,940 rows a shard
        # where a2a pads to 4 × 14,112, and on ranks every byte crosses
        # gloo's loopback TCP
        dict(label="hubbard_pillar", family="Hubbard", params=HUBBARD_SOLVE,
             n_search=N_SEARCH, n_target=RANKS_HUBBARD_N_TARGET,
             target=solves["hubbard"]["target"], max_iters=MAX_ITERS,
             tol=CUT_TOL, grid=RANKS_PILLAR, layout="pillar",
             engine=["--spmv-comm", "compressed", "--spmv-schedule",
                     "matching"]),
    ]


def ranks_argv(case: dict) -> list:
    """The CLI's flags of a ranks-phase case (without ``--backend``)."""
    return ["--family", case["family"],
            "--params", ",".join(f"{k}={v:g}"
                                 for k, v in case["params"].items()),
            "--n-search", str(case["n_search"]),
            "--n-target", str(case["n_target"]),
            "--target", repr(case["target"]), "--tol", repr(case["tol"]),
            "--max-iters", str(case["max_iters"]),
            "--layout", case["layout"], "--dtype", "float64",
            "--spmv-kernel", "--device", "cuda", *grid(case["grid"]),
            *case["engine"]]


def ranks_step_check(dev, rank: int) -> dict:
    """One fused step at the RoadNet(48000) P = 4 shape (n_b = 64, fp64),
    kernels on, through the compressed cyclic split-phase engine and the
    a2a engine, and one s-step filter (degree 9, s = 3, compressed cyclic
    split-phase): this rank's rows against the one-process grouped
    launches' on the same card, bit for bit."""
    import torch

    from repro_torch.core import (ShardGroup, build_dist_ell,
                                  build_sstep_ell, make_fused_cheb_step,
                                  make_sstep_cheb)
    from repro_torch.core.ranks import RankLink
    from repro_torch.matrices import RoadNet

    P = RANKS_WORLD
    host = build_dist_ell(RoadNet(**ROADNET), P, device="cpu")
    ell1 = host.held_by(ShardGroup(P, dev))  # all P shards on the card
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((ell1.D_pad, RN_N_SEARCH), generator=g, device=dev,
                    dtype=torch.float64)
    w2 = torch.randn(x.shape, generator=g, device=dev, dtype=torch.float64)
    rows = slice(rank * ell1.R, (rank + 1) * ell1.R)
    out = {}
    for name, kw in (("compressed-cyclic-overlap",
                      dict(overlap=True, comm="compressed", pipeline=False)),
                     ("a2a", dict(overlap=False, comm="a2a"))):
        g1 = ShardGroup(P, dev)
        gr = ShardGroup(P, dev, link=RankLink(range(P), None, dev, "gloo"))
        f1 = make_fused_cheb_step(ell1, group=g1, use_kernel=True, **kw)
        fr = make_fused_cheb_step(host.held_by(gr), group=gr,
                                  use_kernel=True, **kw)
        y1 = f1(x, w2, 0.37, -0.21)
        yr = fr(x[rows].contiguous(), w2[rows].contiguous(), 0.37, -0.21)
        torch.cuda.synchronize()
        out[name] = dict(bitwise=bool(torch.equal(y1[rows], yr)),
                         staged=gr.link.staged,
                         bytes=dict(gr.bytes), one_bytes=dict(g1.bytes))
    # one s-step filter of degree RANKS_SSTEP_DEGREE at s = SSTEP
    # (compressed cyclic, split phase): this rank's rows against the one
    # process's on the same card
    shost = build_sstep_ell(RoadNet(**ROADNET), P, SSTEP, split_halo=True,
                            d_pad=host.D_pad, device="cpu")
    g1 = ShardGroup(P, dev)
    gr = ShardGroup(P, dev, link=RankLink(range(P), None, dev, "gloo"))
    kw = dict(use_kernel=True, overlap=True, comm="compressed",
              schedule="cyclic")
    a1 = make_sstep_cheb(shost.held_by(g1), group=g1, **kw)
    ar = make_sstep_cheb(shost.held_by(gr), group=gr, **kw)
    mu = [1.0 / (k + 1) for k in range(RANKS_SSTEP_DEGREE + 1)]
    y1 = a1(x, mu, 0.37, -0.21)
    yr = ar(x[rows].contiguous(), mu, 0.37, -0.21)
    torch.cuda.synchronize()
    out[ar.kind] = dict(bitwise=bool(torch.equal(y1[rows], yr)),
                        staged=gr.link.staged, bytes=dict(gr.bytes),
                        one_bytes=dict(g1.bytes))
    return out


def ranks_worker(spec_path: str) -> int:
    """One rank of the ranks phase, under ``python -m
    torch.distributed.run``: the step check, then the phase's solves
    through the CLI's own pieces (``launch/solve.py``: its config, its
    ``solve``, its summary on rank 0), each with this rank's launch
    counts set to 0 just before it and read just after; writes
    ``ranks_<rank>.json`` beside the spec."""
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.ranks import init_ranks
    from repro_torch.kernels import build
    from repro_torch.launch import solve as cli
    from repro_torch.matrices import get_family

    # started ahead of the phase: import, load the kernels and make this
    # process's CUDA context, then wait for the phase's spec
    build.load()
    torch.zeros(1, device="cuda")
    deadline = time.perf_counter() + RANKS_WAIT_S
    while not os.path.exists(spec_path):
        if time.perf_counter() > deadline:
            print(f"no spec at {spec_path} in {RANKS_WAIT_S} s", flush=True)
            return 2
        time.sleep(0.2)
    with open(spec_path) as f:
        spec = json.load(f)
    dev = init_ranks("gloo", "cuda", share_card=True)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.barrier()
    t_go = time.perf_counter()
    rec = dict(rank=rank, device=str(dev), step=ranks_step_check(dev, rank),
               solves={})
    for case in spec["cases"]:
        label, grid_ = case["label"], case["grid"]
        args = cli.build_parser().parse_args(
            ranks_argv(case) + ["--backend", "gloo", "--share-card"])
        fd = cli.config_from_args(args)
        mat = get_family(case["family"], **case["params"])
        dist.barrier()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        solver, res = cli.solve(mat, fd, dev, grid_[0], grid_[1], None,
                                False, ranks=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.launches)
        # the halo exchange of one filter step alone, every rank at once
        # (the s = 1 exchange of the grid; an s-step filter's are counted
        # in its exchange summary)
        xb = torch.randn((solver.ell_panel.R * solver.grid.panel.n_loc,
                          fd.n_search // grid_[1]), device=dev,
                         dtype=solver.dtype)
        dist.barrier()
        t1 = time.perf_counter()
        for _ in range(RANKS_EXCHANGE_REPS):
            solver.spmv_panel.exchange(xb)
        torch.cuda.synchronize()
        ex_ms = (time.perf_counter() - t1) * 1e3 / RANKS_EXCHANGE_REPS
        ex = res.exchange  # the counts at the solve's end, summed
        degrees = [h.get("degree") for h in res.history if "degree" in h]
        r = dict(wall_s=wall, launches=launches, degrees=degrees,
                 iterations=res.iterations, n_converged=res.n_converged,
                 eigenvalues=[float(t) for t in res.eigenvalues],
                 exchange_ms_a_step=ex_ms, exchange=ex,
                 redistributions=res.redistributions,
                 redist_time_s=res.redist_time, solve_s=res.wall_time,
                 max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        if rank == 0:  # the eigenvectors go to the parent's host check
            cli.report(args, fd, solver, res, wall)
            np.save(os.path.join(os.path.dirname(spec_path),
                                 f"vectors_{label}.npy"), res.eigenvectors)
        rec["solves"][label] = r
        del solver, res
    if spec.get("service"):
        rec["service"] = ranks_service(spec["service"], dev, rank,
                                       os.path.dirname(spec_path))
    rec["work_s"] = time.perf_counter() - t_go
    with open(os.path.join(os.path.dirname(spec_path),
                           f"ranks_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def _svc_request_kw(target: float) -> dict:
    """The service requests' common fields: the roadnet48k config's
    matrix and N_s at the solves' target."""
    return dict(family="RoadNet", params=ROADNET, n_search=RN_N_SEARCH,
                target=target, tol=1e-10, max_iters=RN_MAX_ITERS)


def _svc_record(results: dict, out_dir: str | None, tag: str) -> dict:
    """Each request's numbers (and, with ``out_dir``, its eigenvectors
    saved there for the host check)."""
    import numpy as np

    out = {}
    for rid, res in sorted(results.items()):
        out[rid] = dict(
            iterations=res.iterations, n_converged=res.n_converged,
            degrees=[h.get("degree") for h in res.history if "degree" in h],
            eigenvalues=[float(t) for t in res.eigenvalues],
            eigenvalues_hex=[float(t).hex() for t in res.eigenvalues],
            residuals_hex=[float(r).hex() for r in res.residuals],
            exchange=res.exchange)
        if out_dir is not None:
            np.save(os.path.join(out_dir, f"svc_{tag}_{rid}.npy"),
                    res.eigenvectors)
    return out


def ranks_service(spec: dict, dev, rank: int, work: str) -> dict:
    """The ranks phase's service on this rank: the requests planned by
    rank 0 over the world's shards through a plan cache, batched and
    supervised (checkpoints every ``SVC_CKPT_INTERVAL`` iterations, a
    fault on every rank at ``SVC_FAULT_AT``), then request "b" alone with
    the same cache (a hit, no planner call); the launch counts set to 0
    just before each drain and read just after."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.runtime import SupervisorConfig
    from repro_torch.service import EigenService, PlanCache, SolveRequest

    cache = PlanCache(spec["cache"])
    kw = _svc_request_kw(spec["target"])
    svc = EigenService(n_shards=RANKS_WORLD, device=dev, spmv_kernel=True,
                       plan_cache=cache, ckpt_root=spec["ckpt"],
                       supervisor_cfg=SupervisorConfig(
                           checkpoint_interval=SVC_CKPT_INTERVAL,
                           max_restarts=1), ranks=True)
    for rid, n_target, seed in SVC_REQUESTS:
        svc.submit(SolveRequest(rid, n_target=n_target, seed=seed, **kw))
    faults = []

    def fault_hook(step):
        if step == SVC_FAULT_AT and not faults:
            faults.append(step)
            raise RuntimeError(f"fault injected at iteration {step}")

    dist.barrier()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    results = svc.drain(fault_hook=fault_hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(batched=_svc_record(results, work if rank == 0 else None,
                                   "batched"),
               wall_s=wall, launches=dict(build.launches),
               restarts=svc.restarts, faults=faults, cell=svc.groups[0]["cell"],
               width=svc.groups[0]["width"])
    first = (cache.hits, cache.misses, cache.plan_calls)
    alone = EigenService(n_shards=RANKS_WORLD, device=dev, spmv_kernel=True,
                         plan_cache=cache, ranks=True)
    rid, n_target, seed = SVC_REQUESTS[1]
    alone.submit(SolveRequest(rid, n_target=n_target, seed=seed, **kw))
    dist.barrier()
    build.reset_launches()
    t0 = time.perf_counter()
    results = alone.drain()
    torch.cuda.synchronize()
    out.update(solo=_svc_record(results, None, "solo"),
               solo_wall_s=time.perf_counter() - t0,
               solo_launches=dict(build.launches),
               cache_first=first,
               cache_second=(cache.hits, cache.misses, cache.plan_calls))
    if rank == 0:
        print(f"[plan-cache] hits={cache.hits} misses={cache.misses} "
              f"plan_calls={cache.plan_calls} (rank 0, after the second "
              "drain)", flush=True)
    return out


class RanksLaunch:
    """The ranks phase's ``torch.distributed.run`` launch, started ahead of
    the phase (the kernels built, so the ranks only load them): its ranks
    import, load the kernels and make their CUDA contexts, then wait,
    idle, until :meth:`go` writes the phase's spec. Its output goes to a
    file in the phase's work directory. :meth:`stop` ends every process
    it started."""

    def __init__(self, out_dir: str):
        import shutil

        self.work = os.path.join(out_dir, "ranks_phase")
        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        self.spec = os.path.join(self.work, "spec.json")
        self.log_path = os.path.join(self.work, "launch.log")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(RANKS_WORLD),
               os.path.abspath(__file__), "--ranks-worker", self.spec]
        log("[ranks] started ahead of the phase: " + " ".join(cmd))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self._out = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, stdout=self._out,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=env, start_new_session=True)

    def go(self, spec: dict) -> None:
        """Hand the ranks the phase's spec (written whole, then moved into
        place)."""
        with open(self.spec + ".tmp", "w") as f:
            json.dump(spec, f)
        os.replace(self.spec + ".tmp", self.spec)

    def wait(self, timeout: float) -> str:
        """Wait for the launch to end; its output."""
        self.proc.wait(timeout=timeout)
        self._out.close()
        with open(self.log_path) as f:
            return f.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
        self._out.close()


def phase_ranks(solves: dict, out_dir: str,
                launch: RanksLaunch | None = None) -> dict:
    """The phase's solves and service on ``RANKS_WORLD`` gloo ranks sharing
    the card (``python -m torch.distributed.run``, one launch for all,
    started ahead of the phase when ``launch`` is given), held to the
    same in one process on the card (through the CLI, as the solves
    phase runs them; module docstring). The one-process solves run here
    while the ranks run theirs, so each wall is taken beside the other's
    load."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.matrices import get_family

    both = dict(ell_gather=True, ell_gather_cheb=False, cheb_dia=True)
    ell_route = dict(ell_gather=True, ell_gather_cheb=True, cheb_dia=False)
    cases = ranks_cases(solves)
    t_phase = time.perf_counter()
    launch = launch if launch is not None else RanksLaunch(out_dir)
    work = launch.work
    svc_spec = dict(target=solves["roadnet"]["target"],
                    cache=os.path.join(work, "plan_cache.json"),
                    ckpt=os.path.join(work, "service_ckpt"))
    launch.go(dict(cases=cases, service=svc_spec))
    proc = launch.proc
    try:
        one, host = {}, {}
        for c in cases:
            if c["family"] not in host:
                host[c["family"]] = get_family(
                    c["family"], **c["params"]).build_csr().to_scipy()
            one[c["label"]] = run_solve(
                c["label"] + "_one", c["family"], c["params"],
                host[c["family"]], n_search=c["n_search"],
                n_target=c["n_target"], target=c["target"],
                max_iters=c["max_iters"], tol=c["tol"],
                launched=both if c["family"] == "Hubbard" else ell_route,
                layout=c["layout"],
                engine=grid(c["grid"]) + tuple(c["engine"]))
        one_svc = ranks_service_one(svc_spec["target"])
        torch.cuda.empty_cache()  # the ranks share this card
        printed = launch.wait(RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"the ranks launch passed {RANKS_TIMEOUT_S} s")
    finally:
        launch.stop()  # stop every process the launch started
    launch_s = time.perf_counter() - t_phase
    tail = "\n".join(printed.splitlines()[-40:])
    log(f"[ranks] launch exit {proc.returncode} in {launch_s:.1f} s; its "
        f"output's tail:\n{tail}")
    if proc.returncode != 0:
        lines = printed.splitlines()
        first = next((i for i, ln in enumerate(lines) if "Traceback" in ln),
                     max(len(lines) - 60, 0))
        log("[ranks] the first traceback:\n" + "\n".join(lines[first:first
                                                              + 60]))
        raise SmokeFailure(f"the ranks launch exited {proc.returncode}")
    recs = []
    for r in range(RANKS_WORLD):
        with open(os.path.join(work, f"ranks_{r}.json")) as f:
            recs.append(json.load(f))
    for c in cases:  # the host check of rank 0's eigenvectors
        lead = recs[0]["solves"][c["label"]]
        X = np.load(os.path.join(work, f"vectors_{c['label']}.npy"))
        theta = np.asarray(lead["eigenvalues"])
        resid = np.linalg.norm(host[c["family"]] @ X - X * theta, axis=0)
        lead.update(host_residual_max=float(resid.max()),
                    finite=bool(np.isfinite(X).all()
                                and np.isfinite(theta).all()),
                    vectors=list(X.shape))
    for rid, req in recs[0]["service"]["batched"].items():
        X = np.load(os.path.join(work, f"svc_batched_{rid}.npy"))
        theta = np.asarray(req["eigenvalues"])
        resid = np.linalg.norm(host["RoadNet"] @ X - X * theta, axis=0)
        req.update(host_residual_max=float(resid.max()),
                   finite=bool(np.isfinite(X).all()
                               and np.isfinite(theta).all()),
                   vectors=list(X.shape))
    del host
    shutil.rmtree(work, ignore_errors=True)
    out = dict(one=one, launch_s=launch_s, step={}, runs={},
               work_s=[r["work_s"] for r in recs],
               service=ranks_service_check(recs, one_svc))
    for r in recs:
        for name, s in r["step"].items():
            out["step"].setdefault(name, []).append(s["bitwise"])
            if not s["bitwise"]:
                raise SmokeFailure(f"rank {r['rank']}'s {name} step differs "
                                   "from the one-process grouped launch")
    for c in cases:
        label, family, grid_ = c["label"], c["family"], c["grid"]
        per = [r["solves"][label] for r in recs]
        lead, ref = per[0], one[label]
        n_t, t = c["n_target"], c["target"]
        dev = float(np.abs(closest(lead["eigenvalues"], t, n_t)
                           - closest(ref["eigenvalues"], t, n_t)).max())
        # what each rank's own degrees predict: a fused step of its one
        # bundle is one epilogue (ELL) or DIA launch
        steps = [sum(d - 1 for d in p["degrees"]) for p in per]
        kernel = "cheb_dia" if family == "Hubbard" else "ell_gather_cheb"
        other = "ell_gather_cheb" if family == "Hubbard" else "cheb_dia"
        launches_ok = all(
            p["launches"][kernel] == s and p["launches"]["ell_gather"] > 0
            and p["launches"][other] == 0 for p, s in zip(per, steps))
        same_path = (lead["degrees"] == ref["degrees"]
                     and lead["iterations"] == ref["iterations"])
        if grid_[1] == 1 and same_path:
            # a stack grid: one grouped launch for 4 shards is one launch
            # on each rank, kernel by kernel
            launches_ok = launches_ok and all(
                p["launches"] == ref["launches"] for p in per)
        ex, ex1 = lead["exchange"], ref["exchange"]
        bytes_ok = (ex["bytes"] == ex1["bytes"] and ex["calls"] == ex1["calls"]
                    and (ex["panel"] is None) == (ex1["panel"] is None)
                    and (ex["panel"] is None
                         or (ex["panel"]["bytes"], ex["panel"]["calls"])
                         == (ex1["panel"]["bytes"], ex1["panel"]["calls"])))
        run = dict(
            grid=list(grid_), wall_s=[p["wall_s"] for p in per],
            one_launches=ref["launches"], sstep=ex["sstep"],
            filter_exchanges=ex["filter_exchanges"],
            solve_s=[p["solve_s"] for p in per],
            one_wall_s=ref["wall_s"],
            exchange_ms_a_step=lead["exchange_ms_a_step"],
            redistributions=lead["redistributions"],
            redist_ms_each=(1e3 * lead["redist_time_s"]
                            / max(lead["redistributions"], 1)),
            staged_bytes=ex["ranks"]["staged"], iterations=lead["iterations"],
            one_iterations=ref["iterations"], degrees_equal=same_path,
            max_dev_from_one=dev, host_residual_max=lead["host_residual_max"],
            launches_by_rank=[p["launches"] for p in per],
            steps_by_rank=steps, bytes=ex["bytes"], one_bytes=ex1["bytes"],
            panel=ex["panel"], one_panel=ex1["panel"],
            max_memory_allocated=[p["max_memory_allocated"] for p in per])
        out["runs"][label] = run
        log(f"[ranks {label}] {ex['layout']} on {RANKS_WORLD} ranks: "
            f"iterations {lead['iterations']} (one process "
            f"{ref['iterations']}), eigenvalues max |d| {dev:.3e}, host "
            f"residual {lead['host_residual_max']:.3e}, launches by rank "
            f"{run['launches_by_rank']} against {kernel} {steps}, bytes "
            f"{ex['bytes']} (one process {ex1['bytes']})")
        if not (dev <= 1e-9 and abs(lead["iterations"] - ref["iterations"])
                <= 1 and lead["host_residual_max"] <= 1e-8 and lead["finite"]
                and lead["vectors"][1] == len(lead["eigenvalues"])):
            raise SmokeFailure(f"ranks {label}: eigenvalues {dev:.3e}, "
                               f"iterations {lead['iterations']} against "
                               f"{ref['iterations']}, host residual "
                               f"{lead['host_residual_max']:.3e}")
        if not launches_ok:
            raise SmokeFailure(f"ranks {label}: launches "
                               f"{run['launches_by_rank']}, {kernel} should "
                               f"be {steps} (one process "
                               f"{ref['launches']})")
        if same_path and not bytes_ok:
            raise SmokeFailure(f"ranks {label}: bytes summed over the ranks "
                               f"{ex['bytes']} / panel {ex['panel']} differ "
                               f"from the one process's {ex1['bytes']} / "
                               f"{ex1['panel']}")
        if not same_path:
            log(f"[ranks {label}] degrees or iterations differ from the one "
                "process's, so the bytes are not compared")
    out["seconds"] = time.perf_counter() - t_phase
    sv = out["service"]
    log("[ranks] gloo, host-staged, 4 ranks on one card: not a network: "
        + "; ".join(f"{k} wall {max(v['wall_s']):.3f} s (one process "
                    f"{v['one_wall_s']:.3f} s), exchange "
                    f"{v['exchange_ms_a_step']:.3f} ms a step, "
                    f"redistribution {v['redist_ms_each']:.3f} ms each, "
                    f"staged {v['staged_bytes']} B"
                    for k, v in out["runs"].items())
        + f"; service batched {max(sv['wall_s']):.3f} s (one process "
        f"{sv['one_wall_s']:.3f} s), b alone {max(sv['solo_wall_s']):.3f} "
        f"s, staged {sv['staged_bytes']} B"
        + f"; the ranks' work {max(out['work_s']):.1f} s, the launch "
        f"{launch_s:.1f} s, phase {out['seconds']:.1f} s")
    return out


def ranks_service_one(target: float) -> dict:
    """The one-process counterpart of the ranks' service: both requests
    batched over ``RANKS_WORLD`` shards on the card, planned with the
    same machine model (the builtin ``h100-1card``), unsupervised."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.service import EigenService, SolveRequest

    svc = EigenService(n_shards=RANKS_WORLD, device="cuda", spmv_kernel=True)
    kw = _svc_request_kw(target)
    for rid, n_target, seed in SVC_REQUESTS:
        svc.submit(SolveRequest(rid, n_target=n_target, seed=seed, **kw))
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    results = svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[ranks service one] {svc.groups[0]['cell']}: wall {wall:.3f} s, "
        f"launches {dict(build.launches)}")
    return dict(requests=_svc_record(results, None, "one"), wall_s=wall,
                cell=svc.groups[0]["cell"], launches=dict(build.launches))


def ranks_service_check(recs: list, one: dict) -> dict:
    """The ranks' service held to the one process's: the same planned
    cell, one restart (the fault on every rank), each request's
    eigenvalues to 1e-9 with its iterations and degrees equal, its host
    residual ≤ 1e-8 (rank 0's eigenvectors), every rank's results alike,
    request "b" alone bit-equal to it batched, the second drain a cache
    hit with no planner call, and the batched drain's step kernel on
    every rank."""
    import numpy as np

    per = [r["service"] for r in recs]
    lead = per[0]
    out = dict(cell=lead["cell"], one_cell=one["cell"],
               restarts=lead["restarts"], wall_s=[p["wall_s"] for p in per],
               solo_wall_s=[p["solo_wall_s"] for p in per],
               one_wall_s=one["wall_s"],
               launches_by_rank=[p["launches"] for p in per],
               solo_launches_by_rank=[p["solo_launches"] for p in per],
               one_launches=one["launches"],
               cache_first=lead["cache_first"],
               cache_second=lead["cache_second"], requests={})
    if lead["cell"] != one["cell"]:
        raise SmokeFailure(f"ranks service: planned {lead['cell']}, the one "
                           f"process {one['cell']}")
    if lead["restarts"] != 1 or lead["faults"] != [SVC_FAULT_AT]:
        raise SmokeFailure(f"ranks service: {lead['restarts']} restarts "
                           f"(faults {lead['faults']}), expected one")
    first, second = tuple(lead["cache_first"]), tuple(lead["cache_second"])
    # rank 0's cache: one miss and one planner call in the batched drain,
    # then a hit and no further call in the second
    if not (first[1:] == (1, 1) and second == (first[0] + 1, 1, 1)):
        raise SmokeFailure(f"ranks service: cache (hits, misses, "
                           f"plan_calls) {first} then {second}")
    for rid, req in lead["batched"].items():
        want = one["requests"][rid]
        d = float(np.abs(np.sort(req["eigenvalues"])
                         - np.sort(want["eigenvalues"])).max())
        same = (req["iterations"] == want["iterations"]
                and req["degrees"] == want["degrees"])
        alike = all(p["batched"][rid]["eigenvalues_hex"]
                    == req["eigenvalues_hex"] for p in per)
        out["requests"][rid] = dict(
            iterations=req["iterations"], one_iterations=want["iterations"],
            max_dev_from_one=d, host_residual_max=req["host_residual_max"],
            degrees_equal=same)
        log(f"[ranks service {rid}] iterations {req['iterations']} (one "
            f"process {want['iterations']}), eigenvalues max |d| {d:.3e}, "
            f"host residual {req['host_residual_max']:.3e}")
        if not (d <= 1e-9 and same and alike and req["finite"]
                and req["host_residual_max"] <= 1e-8
                and req["vectors"][1] == len(req["eigenvalues"])):
            raise SmokeFailure(f"ranks service {rid}: max |d| {d:.3e}, "
                               f"iterations/degrees equal {same}, ranks "
                               f"alike {alike}, host residual "
                               f"{req['host_residual_max']:.3e}")
    rid = SVC_REQUESTS[1][0]
    b, solo = lead["batched"][rid], lead["solo"][rid]
    bitwise = {k: b[k] == solo[k] for k in ("eigenvalues_hex",
                                           "residuals_hex", "iterations",
                                           "degrees")}
    out["b_alone_bitwise"] = bitwise
    if not all(bitwise.values()):
        raise SmokeFailure(f"ranks service: b batched differs from b "
                           f"alone: {bitwise}")
    if not all(p["launches"]["ell_gather"] > 0
               and p["launches"]["ell_gather_cheb"] > 0
               and p["launches"]["cheb_dia"] == 0 for p in per):
        raise SmokeFailure(f"ranks service: launches {out['launches_by_rank']}")
    # the bytes staged through the host, summed over the ranks, by the
    # batched drain's end
    out["staged_bytes"] = max(r["exchange"]["ranks"]["staged"]
                              for r in lead["batched"].values())
    return out


def _service_run(label: str, results: dict, A, launches: dict,
                 wall: float) -> dict:
    """One service run's record: each request's result host-checked
    (every returned pair ‖A·x − θ·x‖ ≤ 1e-8), the launches, the wall."""
    import numpy as np

    out = dict(wall_s=wall, launches=launches, requests={})
    for rid, res in sorted(results.items()):
        X, theta = res.eigenvectors, res.eigenvalues
        if not (np.isfinite(theta).all() and np.isfinite(X).all()
                and X.shape == (A.shape[0], len(theta))):
            raise SmokeFailure(f"service {label} {rid}: bad result "
                               f"{theta.shape}, {X.shape}")
        resid = np.linalg.norm(A @ X - X * theta, axis=0)
        if not (resid <= 1e-8).all():
            raise SmokeFailure(f"service {label} {rid}: host residual "
                               f"{resid.max():.3e} > 1e-8")
        out["requests"][rid] = dict(
            iterations=res.iterations, n_converged=res.n_converged,
            total_spmvs=res.total_spmvs,
            degrees=[h.get("degree") for h in res.history
                     if "degree" in h],
            eigenvalues=[float(t) for t in theta],
            eigenvalues_hex=[float(t).hex() for t in theta],
            residuals_hex=[float(r).hex() for r in res.residuals],
            host_residual_max=float(resid.max()),
            exchange=res.exchange)
    log(f"[service {label}] wall {wall:.3f} s, launches {launches}; "
        + "; ".join(f"{rid}: {r['iterations']} iterations, "
                    f"{r['n_converged']} converged, host residual "
                    f"{r['host_residual_max']:.3e}"
                    for rid, r in out["requests"].items()))
    return out


def phase_service(records: list, fit_path: str, solves: dict,
                  out_dir: str) -> dict:
    """The eigensolve service on the roadnet48k config (phase 8): a
    batched, supervised drain with an injected fault, then each request
    alone through the CLI's ``--serve``, all through one plan cache."""
    import contextlib
    import re
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import build_dist_ell
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import build
    from repro_torch.launch import solve as cli
    from repro_torch.matrices import RoadNet
    from repro_torch.runtime import SupervisorConfig
    from repro_torch.service import EigenService, PlanCache, SolveRequest

    target = solves["roadnet"]["target"]
    mat = RoadNet(**ROADNET)
    A = mat.build_csr().to_scipy()
    cache_path = os.path.join(out_dir, "service_plan_cache.json")
    ckpt_root = os.path.join(out_dir, "service_ckpt")
    for path in (cache_path, cache_path + ".lock"):
        if os.path.exists(path):
            os.remove(path)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    request = dict(family="RoadNet", params=ROADNET, n_search=RN_N_SEARCH,
                   target=target, tol=1e-10, max_iters=RN_MAX_ITERS)

    # run 1: both requests in one panel, supervised, one injected fault
    cache = PlanCache(cache_path)
    svc = EigenService(n_shards=SVC_SHARDS, device="cuda", spmv_kernel=True,
                       plan_cache=cache, machine=pm.load_machine(fit_path),
                       ckpt_root=ckpt_root, service_seed=0,
                       supervisor_cfg=SupervisorConfig(
                           checkpoint_interval=SVC_CKPT_INTERVAL,
                           max_restarts=1))
    for rid, n_target, seed in SVC_REQUESTS:
        svc.submit(SolveRequest(rid, n_target=n_target, seed=seed,
                                **request))
    faults = []

    def fault_hook(step):
        if step == SVC_FAULT_AT and not faults:
            faults.append(step)
            raise RuntimeError(f"fault injected at iteration {step}")

    log(f"[service] batched drain of {[r[0] for r in SVC_REQUESTS]} over "
        f"{SVC_SHARDS} shards, checkpoints every {SVC_CKPT_INTERVAL} "
        f"iterations in {ckpt_root}, a fault at iteration {SVC_FAULT_AT}")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    results = svc.drain(fault_hook=fault_hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = {"service_batched": _service_run(
        "batched", results, A, dict(build.launches), wall)}
    group = svc.groups[0]
    best = next(iter(svc.plans.values())).best
    log(f"[service batched] planned cell {group['cell']} "
        f"(spmv_overlap={best.overlap}, spmv_comm={best.comm}, "
        f"spmv_schedule={best.schedule}, spmv_balance={best.balance}), "
        f"block width {group['width']}, bundle width "
        f"{group['bundle_width']}, restarts {svc.restarts}, faults {faults}")
    if svc.restarts != 1 or faults != [SVC_FAULT_AT]:
        raise SmokeFailure(f"the faulted drain restarted {svc.restarts} "
                           f"times (faults {faults}), expected once")
    plan_calls, hits = cache.plan_calls, cache.hits

    # runs 2 and 3: each request alone through the CLI's --serve
    for rid, n_target, seed in SVC_REQUESTS:
        spec_path = os.path.join(out_dir, f"service_request_{rid}.json")
        with open(spec_path, "w") as f:
            json.dump({"requests": [dict(req_id=rid, n_target=n_target,
                                         seed=seed, **request)],
                       "service_seed": 0}, f)
        argv = ["--serve", spec_path, "--plan-cache", cache_path,
                "--n-row", str(SVC_SHARDS), "--machine", fit_path,
                "--spmv-kernel", "--device", "cuda"]
        log(f"[service solo {rid}] python -m repro_torch.launch.solve "
            + " ".join(argv))
        torch.cuda.synchronize()
        build.reset_launches()
        printed = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[f"service_solo_{rid}"] = _service_run(
            f"solo {rid}", res, A, dict(build.launches), wall)
        counts = re.search(r"\[plan-cache\] hits=(\d+) misses=(\d+) "
                           r"plan_calls=(\d+)", printed.getvalue())
        if counts is None:
            raise SmokeFailure(f"service solo {rid}: no plan-cache counts")
        hits += int(counts.group(1))
        plan_calls += int(counts.group(3))

    # each request bit-equal to its solo run
    batched = runs["service_batched"]
    for rid, _, _ in SVC_REQUESTS:
        b = batched["requests"][rid]
        s = runs[f"service_solo_{rid}"]["requests"][rid]
        same = {k: b[k] == s[k] for k in ("eigenvalues_hex", "residuals_hex",
                                          "iterations", "total_spmvs",
                                          "degrees")}
        b["bitwise_to_solo"] = same
        log(f"[service] {rid} batched vs solo: {same}")
        if not all(same.values()):
            raise SmokeFailure(f"service request {rid}: batched differs "
                               f"from solo: {same}")
    log(f"[service] plan cache over the three drains: plan_calls "
        f"{plan_calls}, hits {hits}")
    if plan_calls != 1 or hits < 2:
        raise SmokeFailure(f"the plan cache planned {plan_calls} times and "
                           f"hit {hits} times over three drains")
    # request "a" is the RoadNet solve's problem: the same eigenvalues
    want = closest(solves["roadnet"]["eigenvalues"], target, RN_N_TARGET)
    got = closest(batched["requests"]["a"]["eigenvalues"], target,
                  RN_N_TARGET)
    dev = float(np.abs(got - want).max())
    batched["requests"]["a"]["max_dev_from_roadnet"] = dev
    log(f"[service] a vs the roadnet solve: max |d| = {dev:.3e}")
    if not dev <= 1e-9:
        raise SmokeFailure(f"service request a differs from the roadnet "
                           f"solve by {dev:.3e}")
    # one shared sweep: launches of the larger pending degree
    for label, r in runs.items():
        if r["launches"]["ell_gather_cheb"] <= 0:
            raise SmokeFailure(f"{label}: ell_gather_cheb was never launched")
    per_step = set()
    for rid, _, _ in SVC_REQUESTS:
        r = runs[f"service_solo_{rid}"]
        steps = sum(d - 1 for d in r["requests"][rid]["degrees"])
        per_step.add(r["launches"]["ell_gather_cheb"] / steps)
    if len(per_step) != 1 or not float(next(iter(per_step))).is_integer():
        raise SmokeFailure(f"the solo runs launch ell_gather_cheb "
                           f"{per_step} times a fused step")
    per_step = int(next(iter(per_step)))
    degs = [batched["requests"][rid]["degrees"] for rid, _, _ in SVC_REQUESTS]
    n_max = [max(d[i] for d in degs if i < len(d))
             for i in range(max(map(len, degs)))]
    replayed = range(SVC_CKPT_INTERVAL, SVC_FAULT_AT)
    predicted = per_step * (sum(n - 1 for n in n_max)
                            + sum(n_max[i] - 1 for i in replayed))
    launched = batched["launches"]["ell_gather_cheb"]
    solo_sum = sum(runs[f"service_solo_{rid}"]["launches"]["ell_gather_cheb"]
                   for rid, _, _ in SVC_REQUESTS)
    solo_wall = sum(runs[f"service_solo_{rid}"]["wall_s"]
                    for rid, _, _ in SVC_REQUESTS)
    log(f"[service] batched ell_gather_cheb launches {launched}, predicted "
        f"{predicted} ({per_step} a fused step), solo runs {solo_sum}; "
        f"batched wall {batched['wall_s']:.3f} s against the solo walls' "
        f"sum {solo_wall:.3f} s")
    if launched != predicted or not launched < solo_sum:
        raise SmokeFailure(f"the batched drain launched ell_gather_cheb "
                           f"{launched} times, predicted {predicted}, solo "
                           f"runs {solo_sum}")

    # the planned cell's filter operator at the batch's bundle width
    gen = torch.Generator(device="cuda").manual_seed(2031)
    n_b = group["bundle_width"]
    ell = build_dist_ell(mat, best.n_row, dtype="float64",
                         d_pad=-(-mat.D // SVC_SHARDS) * SVC_SHARDS,
                         rowmap=best.rowmap, device="cuda")
    label = f"RoadNet service {group['cell']}"
    if ell.P == 1:
        ell_case(records, label, ell.cols[0], ell.vals[0], n_b, "float64",
                 gen, cheb=True, bitwise=("float64",))
    else:
        nplan = ell.neighbor_plan(schedule=best.schedule)
        for p in range(ell.P):
            ell_case(records, f"{label} shard {p}", nplan.cols_nbr[p],
                     ell.vals[p], n_b, "float64", gen, cheb=True,
                     Rx=ell.R + nplan.H, bitwise=("float64",))
    del ell
    torch.cuda.empty_cache()
    # the checkpoints are the run's scratch: their size, then gone
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(ckpt_root) for f in fs)
    log(f"[service] checkpoints left in {ckpt_root}: {ckpt_bytes} B "
        "(removed)")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return dict(cell=group["cell"], width=group["width"],
                checkpoint_bytes_kept=ckpt_bytes,
                bundle_width=n_b, restarts=svc.restarts,
                plan_calls=plan_calls, hits=hits,
                ell_gather_cheb_predicted=predicted,
                ell_gather_cheb_per_step=per_step, runs=runs)


def census_cell(records: list, label: str, matrix, **kw) -> list:
    """One census cell on the card, kernels on (``run_census_cell``): its
    predicted terms beside the measured multiset; its errors."""
    import torch

    from repro_torch.analysis import run_census_cell

    t0 = time.perf_counter()
    rep = run_census_cell(matrix, use_kernel=True, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    errors = list(rep.errors)
    if rep.launches <= 0:
        errors.append(f"[{rep.cell}] no kernel launched")
    log(f"[analysis] census {label} in {seconds:.2f} s, {rep.launches} "
        f"launches in the record:\n" + rep.describe())
    for e in errors[len(rep.errors):]:
        log(f"[analysis]   ERROR: {e}")
    records.append(dict(
        matrix=label, cell=rep.cell, ok=not errors, seconds=seconds,
        launches=rep.launches,
        predicted=[(t.label, t.kind, t.bytes, t.count)
                   for t in rep.expected],
        measured=[(c.name, c.kind, c.bytes, c.mult) for c in rep.measured],
        errors=errors))
    return errors


def phase_analysis() -> dict:
    """The static communication checks on the card, kernels on (phase 9):
    the census cells, the proofs and their negative controls."""
    import torch

    from repro_torch.analysis import extra_psum, run_census_cell, skip_gram
    from repro_torch.analysis.check_comm import (ProofOperator,
                                                 check_kernel_parity,
                                                 check_overlap,
                                                 check_pipeline)
    from repro_torch.core import plan_rowmap
    from repro_torch.kernels import build
    from repro_torch.matrices import HubNet, Hubbard, RoadNet, SpinChainXXZ

    dev = torch.device("cuda", torch.cuda.current_device())
    build.reset_launches()
    cells: list = []
    errors = census_cell(cells, "Hubbard(12,6)", Hubbard(**HUBBARD),
                         P_total=LAYOUT_P, layout="panel", comm="a2a",
                         n_s=N_SEARCH, degree=ANALYSIS_DEGREE)
    hubnet = HubNet(**HUBNET)
    for s in (1, SSTEP):
        errors += census_cell(cells, "HubNet(48000)", hubnet, P_total=SSTEP_P,
                              layout="stack", comm="compressed",
                              schedule="matching", overlap=True,
                              n_s=HN_N_SEARCH, degree=ANALYSIS_DEGREE,
                              sstep=s)
    roadnet = RoadNet(**ROADNET)
    errors += census_cell(cells, "RoadNet(48000)", roadnet,
                          P_total=RN_PILLAR[1], layout="pillar",
                          n_s=RN_N_SEARCH, degree=ANALYSIS_DEGREE,
                          rowmap=plan_rowmap(roadnet, RN_PILLAR[1],
                                             reorder="rcm"))
    del roadnet
    # the kernels' own counts, not the record's: each was launched
    census_launches = dict(build.launches)
    for name in ("ell_gather", "ell_gather_cheb"):
        if census_launches.get(name, 0) <= 0:
            errors.append(f"the census cells launched {name} no time")
    # the proofs, kernels off and on, on a real side stream; the plain
    # engines' (B), pipeline=False's (c), the late start's (A) and the
    # dropped wait's failures are checked inside
    t0 = time.perf_counter()
    proof_errors = []
    for op, depths in ((ProofOperator(dev), (2, SSTEP)),
                       (ProofOperator(dev, hubnet, P=SSTEP_P, n_b=HN_N_SEARCH,
                                      label="HubNet(48000)"), (SSTEP,))):
        proof_errors += check_overlap(dev, op, depths)
        proof_errors += check_pipeline(dev, op)
    proof_errors += check_kernel_parity(dev)
    torch.cuda.synchronize()
    proof_s = time.perf_counter() - t0
    # the census's planted controls: an extra psum, a skipped Gram
    spin = SpinChainXXZ(10, 5)
    controls = {}
    for name, wrap, want in (("extra psum", extra_psum, "unattributed"),
                             ("skipped Gram", skip_gram, "missing")):
        rep = run_census_cell(spin, P_total=8, comm="a2a", use_kernel=True,
                              device="cuda", wrap=wrap)
        caught = any(want in e for e in rep.errors)
        controls[name] = dict(caught=caught, errors=rep.errors)
        log(f"[analysis] control {name}: "
            f"{'caught (' + want + ')' if caught else 'NOT CAUGHT'}")
        if not caught:
            proof_errors.append(f"the planted {name} was not reported "
                                f"{want}")
    errors += proof_errors
    rec = dict(census=cells, census_launches=census_launches,
               proof_seconds=proof_s, proof_errors=proof_errors,
               controls=controls)
    if errors:
        raise SmokeFailure(f"analysis: {len(errors)} error(s): {errors[:3]}")
    return rec


def _lm_inputs(cfg, batch: dict) -> dict:
    """What prefill takes of a ``make_batch`` batch: the tokens, with a
    VLM's patches, or an audio model's frames and mask."""
    if cfg.family in ("vlm", "audio"):
        return {k: v for k, v in batch.items() if k != "labels"}
    return {"tokens": batch["tokens"]}


def _lm_serve(cfg, model, inputs: dict, prompt: int, n_decode: int,
              capacity_factor: float | None = None):
    """Prefill, then ``n_decode`` greedy steps. With ``capacity_factor``
    prefill runs ``backbone_with_state`` at that MoE capacity (the
    consistency check), else through ``make_prefill_step``. Returns
    (prefill logits, each step's logits, the tokens fed, prefill ms,
    decode ms per token), the times from CUDA events."""
    import torch

    from repro_torch.models import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tfm

    max_len = prompt + n_decode
    if capacity_factor is None:
        prefill = make_prefill_step(cfg, max_len)
    else:
        def prefill(m, b):
            with torch.no_grad():
                return tfm.backbone_with_state(m, cfg, b, max_len,
                                               capacity_factor=capacity_factor)
    step = make_decode_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, state = prefill(model, inputs)
    ev[1].record()
    tok = logits.argmax(-1)
    toks, steps = [], []
    for pos in range(prompt, prompt + n_decode):
        toks.append(tok)
        lg, state = step(model, state, tok, pos)
        steps.append(lg)
        tok = lg.argmax(-1)
    ev[2].record()
    torch.cuda.synchronize()
    del state
    return (logits, steps, toks, ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / max(n_decode, 1))


def _lm_full_forward(cfg, model, inputs: dict, toks: list,
                     capacity_factor: float):
    """Last-position logits of one forward of the prompt and the decoded
    tokens."""
    import torch

    from repro_torch.models import transformer as tfm

    grown = dict(inputs, tokens=torch.cat(
        [inputs["tokens"], torch.stack(toks, dim=1).to(
            inputs["tokens"].dtype)], dim=1))
    with torch.no_grad():
        x, positions, _, _ = tfm.embed_batch(model, cfg, grown)
        h, _ = tfm.backbone(model, cfg, x, positions,
                            capacity_factor=capacity_factor)
        return h[:, -1] @ tfm.lm_head_table(model, cfg).T


def _rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def lm_case(arch: str, smi: str, seed: int, dev) -> dict:
    """One arch at full width in bf16: prefill of ``LM_BATCH`` prompts,
    ``LM_DECODE`` greedy decode steps (an encoder: its forward alone),
    timed, with the peak device memory; for a decodable arch of full
    depth, the consistency of decode with the full forward
    (``_lm_consistency``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_batch
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    cut = arch in LM_CUT
    if cut:
        cfg = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    prompt = LM_HYMBA_PROMPT if arch == "hymba-1.5b" else LM_PROMPT
    n_decode = 0 if cfg.encoder_only else LM_DECODE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, dev).requires_grad_(False)
    inputs = _lm_inputs(cfg, make_batch(cfg, LM_BATCH, prompt, key=seed,
                                        device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = dict(arch=arch, family=cfg.family, n_layers=cfg.n_layers,
               depth_cut=(f"{get_config(arch).n_layers} -> {cfg.n_layers} "
                          "layers" if cut else None),
               d_model=cfg.d_model, batch=LM_BATCH, prompt=prompt,
               decode_steps=n_decode, dtype=cfg.dtype,
               n_params=sum(p.numel() for p in model.parameters()),
               init_s=init_s)
    if cfg.encoder_only:
        def forward():
            with torch.no_grad():
                x, positions, _, _ = tfm.embed_batch(model, cfg, inputs)
                h, _ = tfm.backbone(model, cfg, x, positions, causal=False)
                return h @ tfm.lm_head_table(model, cfg).T
        forward()  # warm
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = forward()
        ev[1].record()
        torch.cuda.synchronize()
        rec.update(prefill_ms=ev[0].elapsed_time(ev[1]), decode_ms=None)
        ok = (tuple(out.shape) == (LM_BATCH, prompt, cfg.vocab)
              and bool(torch.isfinite(out).all()))
    else:
        _lm_serve(cfg, model, inputs, prompt, 1)  # warm
        torch.cuda.reset_peak_memory_stats()
        logits, steps, _, pre_ms, dec_ms = _lm_serve(cfg, model, inputs,
                                                     prompt, n_decode)
        rec.update(prefill_ms=pre_ms, decode_ms=dec_ms)
        ok = all(tuple(t.shape) == (LM_BATCH, cfg.vocab)
                 and bool(torch.isfinite(t).all())
                 for t in [logits] + steps)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["finite_and_shaped"] = ok
    log(f"[lm] {arch}: {cfg.family}, {cfg.n_layers} layers"
        + (f" (depth cut {rec['depth_cut']})" if cut else "")
        + f", d_model {cfg.d_model}, {rec['n_params'] / 1e9:.3f} B params, "
        f"{cfg.dtype}, B = {LM_BATCH}, prompt {prompt}: prefill "
        f"{rec['prefill_ms']:.3f} ms"
        + (f", decode {rec['decode_ms']:.3f} ms/token over {n_decode}"
           if n_decode else " (encoder forward)")
        + f", peak {rec['peak_gb']:.2f} GB, init {init_s:.2f} s; {smi}")
    if not ok:
        raise SmokeFailure(f"lm {arch}: logits not finite or misshapen")
    if not cut and n_decode:
        rec["consistency"] = _lm_consistency(arch, cfg, model, inputs, prompt,
                                             n_decode)
    del model, inputs
    torch.cuda.empty_cache()
    return rec


def _lm_consistency(arch: str, cfg, model, inputs: dict, prompt: int,
                    n_decode: int) -> dict:
    """The last of ``n_decode`` greedy decode steps against the last
    position of one forward of the grown sequence, TF32 off, within
    ``LM_CONSISTENCY_TOL`` (absolute and relative), in fp32. An MoE runs
    at a capacity that drops no token, under which dispatch equals
    decode's per-token experts. RWKV6 runs the per-token WKV throughout
    (decode's recurrence; the chunked form, measured against it, is not
    exact once a chunk's decay passes its e^30 clamp) and is held in fp64:
    at full depth and random weights it amplifies fp32 rounding about
    twofold a layer, so its fp32 difference is recorded beside it."""
    import dataclasses

    import torch

    from repro_torch.models import make_prefill_step

    t0 = time.perf_counter()
    cf = cfg.n_experts / cfg.top_k if cfg.n_experts else 1.25
    ssm = cfg.family == "ssm"
    ccfg = dataclasses.replace(cfg, ssm_chunk=0) if ssm else cfg
    out = dict(capacity_factor=cf, wkv="per-token" if ssm else None,
               gated="float64" if ssm else "float32")
    for dt in (torch.float32, torch.float64) if ssm else (torch.float32,):
        model.to(dt)
        x = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in inputs.items()}
        logits, steps, toks, _, _ = _lm_serve(ccfg, model, x, prompt,
                                              n_decode, capacity_factor=cf)
        full = _lm_full_forward(ccfg, model, x, toks, cf)
        diff = (steps[-1] - full).abs()
        name = str(dt).removeprefix("torch.")
        out[name] = dict(max_abs=float(diff.max()),
                         rel=_rel_err(steps[-1], full),
                         ok=bool((diff <= LM_CONSISTENCY_TOL
                                  * (1 + full.abs())).all()))
        log(f"[lm] {arch}: {name} decode step {n_decode} against the full "
            f"forward of {prompt + n_decode} positions: max |Δ| "
            f"{out[name]['max_abs']:.3e} (rel {out[name]['rel']:.3e}; tol "
            f"{LM_CONSISTENCY_TOL} abs + rel"
            + ("" if name == out["gated"] else ", recorded, not gated") + ")"
            + (f", MoE capacity factor {cf}" if cfg.n_experts else "")
            + (", per-token WKV" if ssm else ""))
        if ssm and dt == torch.float32:
            chunked, _ = make_prefill_step(cfg, prompt + n_decode)(model, x)
            out["chunked_vs_scan_rel"] = _rel_err(chunked, logits)
            log(f"[lm] {arch}: float32 prefill logits, chunked WKV (chunk "
                f"{cfg.ssm_chunk}) against the per-token WKV: rel "
                f"{out['chunked_vs_scan_rel']:.3e} (recorded, not gated)")
    out["ok"] = out[out["gated"]]["ok"]
    out["seconds"] = time.perf_counter() - t0
    if not out["ok"]:
        raise SmokeFailure(f"lm {arch}: decode differs from the full forward "
                           f"by {out[out['gated']]['max_abs']}")
    return out


def lm_card_against_cpu(arch: str, dev) -> dict:
    """A SMOKE config through the port on the card and on the CPU, fp32,
    the same weights and batch: prefill and ``LM_CPU_STEPS`` decode steps
    (the CPU's greedy tokens fed to both), logits and decode-state leaves
    to ``LM_CPU_TOL`` of their largest magnitude; an encoder's forward."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (init_params, make_batch,
                                    make_decode_step, make_prefill_step)
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0),
                      "cpu").requires_grad_(False)
    card = copy.deepcopy(cpu).to(dev)
    inputs = _lm_inputs(cfg, make_batch(cfg, 2, LM_CPU_PROMPT, device="cpu"))
    on_card = {k: v.to(dev) for k, v in inputs.items()}
    errs = []
    if cfg.encoder_only:
        with torch.no_grad():
            outs = []
            for m, b in ((cpu, inputs), (card, on_card)):
                x, positions, _, _ = tfm.embed_batch(m, cfg, b)
                outs.append(tfm.backbone(m, cfg, x, positions,
                                         causal=False)[0])
        errs.append(_rel_err(outs[1].cpu(), outs[0]))
    max_len = LM_CPU_PROMPT + LM_CPU_STEPS
    pre = make_prefill_step(cfg, max_len)
    lc, sc = pre(cpu, inputs)
    lg, sg = pre(card, on_card)
    errs.append(_rel_err(lg.cpu(), lc))
    if not cfg.encoder_only:
        step = make_decode_step(cfg)
        tok = lc.argmax(-1)
        for pos in range(LM_CPU_PROMPT, max_len):
            lc, sc = step(cpu, sc, tok, pos)
            lg, sg = step(card, sg, tok.to(dev), pos)
            errs.append(_rel_err(lg.cpu(), lc))
            tok = lc.argmax(-1)
    for seg_c, seg_g in zip(sc, sg):
        errs += [_rel_err(seg_g[k].cpu(), seg_c[k]) for k in seg_c]
    err = max(errs)
    return dict(arch=arch, family=cfg.family, max_rel_err=err,
                ok=err <= LM_CPU_TOL)


def phase_lm(smi: str) -> dict:
    """The LM serving path on the card (phase 10): the ten SMOKE configs
    against the CPU, then the ten archs at full width in bf16, the four
    too large for one card cut to ``LM_CUT_LAYERS`` layers."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    against_cpu = []
    for arch in LM_FULL + LM_CUT:
        r = lm_card_against_cpu(arch, dev)
        against_cpu.append(r)
        log(f"[lm] {arch} SMOKE, card against CPU, fp32, prefill + "
            f"{LM_CPU_STEPS} decode steps: max rel err {r['max_rel_err']:.3e}"
            f" (tol {LM_CPU_TOL})")
    bad = [r["arch"] for r in against_cpu if not r["ok"]]
    if bad:
        raise SmokeFailure(f"lm: card differs from the CPU on {bad}")
    cpu_s = time.perf_counter() - t0
    cases = [lm_case(arch, smi, seed, dev) for seed, arch in
             enumerate(LM_FULL + LM_CUT)]
    torch.cuda.empty_cache()
    return dict(against_cpu=against_cpu, against_cpu_seconds=cpu_s,
                cases=cases)

def _leaf_values(tree) -> list:
    """The leaves of a parameter or gradient tree, each as one tensor."""
    from repro_torch.optim import adamw

    return [adamw.value(leaf) for _, leaf in adamw.tree_paths(tree)]


def train_card_against_cpu(arch: str, dev) -> dict:
    """A SMOKE config through ``make_train_step`` on the CPU for
    ``TRAIN_CPU_STEPS`` steps, fp32, each step also taken on the card from
    the CPU's parameters and moments before it, on the same batch: loss
    and grad norm to ``TRAIN_CPU_TOL`` (relative), every parameter to
    ``TRAIN_CPU_TOL`` of its leaf's max, except the elements whose
    gradient in that step lay below ``TRAIN_SMALL_GRAD`` of the leaf's max
    (Adam's ``g / (|g| + eps)`` flips with rounding there), held to 2·lr.
    Each step starts from the CPU's state because two free-running Adam
    steps amplify fp32 rounding on the zero-init leaves beyond the
    tolerance, in the reference as well (``tests/test_torch_train.py::
    test_two_adam_steps_amplify_a_one_ulp_change``)."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, make_batch
    from repro_torch.models.steps import grad_tree, make_train_step, param_tree
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    ocfg = adamw.AdamWConfig(moment_dtype="float32", warmup_steps=2,
                             total_steps=10)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, 2, LM_CPU_PROMPT, device="cpu")
    on_card = {k: v.to(dev) for k, v in batch.items()}
    state = adamw.init_state(ocfg, param_tree(cpu))
    step = make_train_step(cfg, ocfg)
    metric_err, param_err, n_small = 0.0, 0.0, 0
    for _ in range(TRAIN_CPU_STEPS):
        card = copy.deepcopy(cpu).to(dev)
        card_state = adamw.tree_map(lambda t: t.to(dev, copy=True), state)
        cpu, state, mc = step(cpu, state, batch)
        card, card_state, mg = step(card, card_state, on_card)
        for k in ("loss", "grad_norm"):
            metric_err = max(metric_err, abs(float(mg[k]) - float(mc[k]))
                             / max(abs(float(mc[k])), 1e-30))
        lr = float(mc["lr"])
        for p, q, g in zip(_leaf_values(param_tree(cpu)),
                           _leaf_values(param_tree(card)),
                           _leaf_values(grad_tree(param_tree(cpu)))):
            err = (q.detach().cpu() - p.detach()).abs()
            scale = float(p.detach().abs().max().clamp_min(1e-30))
            small = g.abs() < TRAIN_SMALL_GRAD * g.abs().max()
            if (~small).any():
                param_err = max(param_err, float(err[~small].max()) / scale)
            n_small += int((small & (err > TRAIN_CPU_TOL * scale)).sum())
            if bool((err[small] > 2 * lr).any()):
                param_err = float("inf")
    return dict(arch=arch, family=cfg.family, metric_rel_err=metric_err,
                param_rel_err=param_err, small_grad_beyond_tol=n_small,
                ok=max(metric_err, param_err) <= TRAIN_CPU_TOL)


def _timed_train_steps(step, model, state, pipe, start: int, n: int):
    """``n`` steps on ``pipe``'s batches ``start``, ``start + 1``, ...,
    each timed with CUDA events (its batch made before); returns (model,
    state, each step's ms, losses)."""
    import torch

    seq, batch = TRAIN_SEQ_BATCH
    ms, losses = [], []
    for i in range(start, start + n):
        b = pipe.batch(i, batch, seq)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        model, state, m = step(model, state, b)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
    return model, state, ms, losses


def train_qwen_full(smi: str, dev) -> dict:
    """qwen3-0.6b at full width and depth in bf16 through ``train``, then
    ``TRAIN_TIMED_STEPS`` timed steps of the same model and optimizer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import train
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw

    arch = "qwen3-0.6b"
    seq, batch = TRAIN_SEQ_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, losses = train(arch, steps=TRAIN_QWEN_STEPS, batch=batch,
                                 seq=seq, smoke=False, log_every=1,
                                 opt_overrides={"lr": TRAIN_QWEN_LR},
                                 device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cfg = get_config(arch)
    ocfg = adamw.AdamWConfig(moment_dtype=cfg.optimizer_dtype,
                             warmup_steps=10, total_steps=TRAIN_QWEN_STEPS,
                             lr=TRAIN_QWEN_LR)
    model, state, ms, more = _timed_train_steps(
        make_train_step(cfg, ocfg), model, state,
        TokenPipeline(cfg, device=dev), TRAIN_QWEN_STEPS, TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    first, last3 = losses[0], sum(losses[-3:]) / 3
    finite = all(map(math.isfinite, losses + more))
    rec = dict(arch=arch, dtype=cfg.dtype, moments=cfg.optimizer_dtype,
               n_params=n_params, batch=batch, seq=seq, losses=losses,
               timed_losses=more, train_s=train_s, step_ms=ms,
               tokens_per_s=batch * seq / (min(ms) / 1e3), peak_gb=peak,
               ok=finite and last3 < first)
    log(f"[train] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, {cfg.dtype}, "
        f"{cfg.optimizer_dtype} moments, B = {batch} x {seq} tokens: "
        f"{TRAIN_QWEN_STEPS} steps through train() in {train_s:.2f} s, "
        f"loss {first:.4f} -> {losses[-1]:.4f} (last three {last3:.4f}); "
        f"step {min(ms):.3f} ms (min of {', '.join(f'{x:.3f}' for x in ms)}"
        f"), {rec['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB; {smi}")
    del model, state
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SmokeFailure(f"train {arch}: losses not finite or not falling "
                           f"({losses})")
    return rec


def _q8_shape(shape) -> tuple:
    """The reference's int8 moment of a leaf: (codes, scales) shapes."""
    n_blocks = -(-math.prod(shape) // 256)
    return (n_blocks, 256), (n_blocks, 1)


def train_granite_int8(smi: str, dev) -> dict:
    """granite-moe-3b-a800m at full width and depth in bf16 with int8
    moments through ``make_train_step``: ``TRAIN_GRANITE_STEPS`` steps,
    the first a warm one, the others timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.steps import (init_train_state, make_train_step,
                                          param_tree)
    from repro_torch.optim import adamw

    arch = "granite-moe-3b-a800m"
    seq, batch = TRAIN_SEQ_BATCH
    cfg = get_config(arch)
    ocfg = adamw.AdamWConfig(moment_dtype="int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state = init_train_state(
        cfg, ocfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    paths = adamw.tree_paths(param_tree(model))
    n = sum(math.prod(leaf.shape) for _, leaf in paths)
    moment_bytes = 2 * sum(
        math.prod(c) + 4 * math.prod(s)
        for c, s in (_q8_shape(leaf.shape) for _, leaf in paths))
    step = make_train_step(cfg, ocfg)
    pipe = TokenPipeline(cfg, device=dev)
    model, state, warm_ms, warm = _timed_train_steps(step, model, state,
                                                     pipe, 0, 1)
    model, state, ms, losses = _timed_train_steps(
        step, model, state, pipe, 1, TRAIN_GRANITE_STEPS - 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad_shapes = []
    for path, leaf in paths:
        want = _q8_shape(leaf.shape)
        for mom in ("m", "v"):
            codes, scales = adamw.tree_at(state[mom], path)
            got = ((tuple(codes.shape), codes.dtype),
                   (tuple(scales.shape), scales.dtype))
            if got != ((want[0], torch.int8), (want[1], torch.float32)):
                bad_shapes.append((mom, path, got))
    losses = warm + losses
    rec = dict(arch=arch, dtype=cfg.dtype, moments="int8", n_params=n,
               reckoned_gb=dict(params=2 * n / 1e9, grads=2 * n / 1e9,
                                moments=moment_bytes / 1e9),
               batch=batch, seq=seq, init_s=init_s, losses=losses,
               warm_ms=warm_ms[0], step_ms=ms,
               tokens_per_s=batch * seq / (min(ms) / 1e3), peak_gb=peak,
               leaves=len(paths), bad_shapes=[str(b) for b in bad_shapes],
               ok=all(map(math.isfinite, losses)) and not bad_shapes)
    log(f"[train] {arch}: {cfg.n_layers} layers, {cfg.n_experts} experts "
        f"top-{cfg.top_k}, {n / 1e9:.3f} B params, {cfg.dtype}, int8 "
        f"moments ({len(paths)} leaves, codes and scales of the "
        f"reference's shapes: {not bad_shapes}); reckoned params "
        f"{2 * n / 1e9:.2f} + grads {2 * n / 1e9:.2f} + moments "
        f"{moment_bytes / 1e9:.2f} GB; B = {batch} x {seq} tokens: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; warm step "
        f"{warm_ms[0]:.3f} ms, step {min(ms):.3f} ms (min of "
        f"{', '.join(f'{x:.3f}' for x in ms)}), {rec['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak:.2f} GB, init {init_s:.2f} s; {smi}")
    del model, state
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SmokeFailure(f"train {arch}: losses {losses}, moment shapes "
                           f"{bad_shapes[:3]}")
    return rec


def train_exact_resume(dev, out_dir: str) -> dict:
    """qwen3-0.6b SMOKE through ``train`` on the card under deterministic
    algorithms: ``TRAIN_RESUME[1]`` steps straight against
    ``TRAIN_RESUME[0]`` steps resumed to ``TRAIN_RESUME[1]`` from the
    checkpoint; the parameters must be bit-equal."""
    import shutil

    import torch

    from repro_torch.launch.train import train
    from repro_torch.models.steps import param_tree

    stop, end = TRAIN_RESUME
    ck = os.path.join(out_dir, "train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        kw = dict(batch=2, seq=32, log_every=100, device=dev)
        full, _, _ = train("qwen3-0.6b", steps=end, **kw)
        train("qwen3-0.6b", steps=stop, ckpt_dir=ck, **kw)
        res, state, losses = train("qwen3-0.6b", steps=end, ckpt_dir=ck, **kw)
    except RuntimeError as e:  # an op with no deterministic form says so
        raise SmokeFailure(f"train: exact resume under deterministic "
                           f"algorithms: {e}") from e
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(ck, ignore_errors=True)
    a = _leaf_values(param_tree(full))
    b = _leaf_values(param_tree(res))
    n_diff = sum(int((x != y).sum()) for x, y in zip(a, b))
    rec = dict(steps=end, stopped_after=stop, resumed_steps=len(losses),
               elements_differing=n_diff, seconds=time.perf_counter() - t0,
               ok=n_diff == 0 and len(losses) == end - stop
               and int(state["step"]) == end)
    log(f"[train] exact resume (qwen3-0.6b SMOKE, deterministic algorithms):"
        f" {end} steps against {stop} + {len(losses)} resumed, "
        f"{n_diff} parameter elements differ, {rec['seconds']:.2f} s")
    if not rec["ok"]:
        raise SmokeFailure(f"train: the resumed run differs in {n_diff} "
                           "parameter elements")
    return rec


def phase_train(smi: str, out_dir: str) -> dict:
    """The LM training path on the card (phase 11): the ten SMOKE configs
    against the CPU, qwen3-0.6b and granite-moe-3b-a800m at full size, and
    the exact resume."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    against_cpu = []
    for arch in LM_FULL + LM_CUT:
        r = train_card_against_cpu(arch, dev)
        against_cpu.append(r)
        log(f"[train] {arch} SMOKE, card against CPU, fp32, "
            f"{TRAIN_CPU_STEPS} train steps, each from the CPU's state: "
            f"loss/grad-norm rel err {r['metric_rel_err']:.3e}, parameters "
            f"{r['param_rel_err']:.3e} (tol {TRAIN_CPU_TOL}; "
            f"{r['small_grad_beyond_tol']} small-grad elements beyond it, "
            "within 2·lr)")
    bad = [r["arch"] for r in against_cpu if not r["ok"]]
    if bad:
        raise SmokeFailure(f"train: card differs from the CPU on {bad}")
    cpu_s = time.perf_counter() - t0
    rec = dict(against_cpu=against_cpu, against_cpu_seconds=cpu_s,
               qwen3=train_qwen_full(smi, dev),
               granite_int8=train_granite_int8(smi, dev),
               resume=train_exact_resume(dev, out_dir))
    torch.cuda.empty_cache()
    return rec


def _finite_fields(rec, where: str) -> None:
    """Every number in ``rec`` (nested) must be finite."""
    if isinstance(rec, dict):
        for k, v in rec.items():
            _finite_fields(v, f"{where}.{k}")
    elif isinstance(rec, (list, tuple)):
        for i, v in enumerate(rec):
            _finite_fields(v, f"{where}[{i}]")
    elif isinstance(rec, float) and not math.isfinite(rec):
        raise SmokeFailure(f"{where} = {rec} is not finite")


def census_launches() -> list:
    """One launch of each kernel under the op census, its counted bytes
    against this script's bound bytes for that launch (``ell_case``,
    ``dia_case``): RoadNet(48000) at n_b = 64 through ``ell_gather`` and
    its epilogue entry (w1 a block of its own, and w1 = x), Hubbard(8,4)'s
    DIA form through ``cheb_dia``, fp64. These launches are comparisons, outside the main path's counts."""
    import torch

    from repro_torch.core.spmv import build_dist_ell
    from repro_torch.kernels import ops, plan
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.matrices import Hubbard, RoadNet

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    ell = build_dist_ell(RoadNet(**ROADNET).build_csr(), 1, dtype="float64",
                         device="cuda")
    cols, vals = ell.cols[0], ell.vals[0]
    cpe = plan.compact_ell(cols, vals)
    R, nb, S = cols.shape[0], DRYRUN_NB, 8
    x, w1, w2 = (torch.randn((R, nb), generator=gen, device="cuda",
                             dtype=torch.float64) for _ in range(3))
    hub = build_dist_ell(Hubbard(**DRYRUN_DIA).build_csr(), 1,
                         dtype="float64", device="cuda")
    dia = ops.plan_dia(hub.cols[0], hub.vals[0], hub.R, device="cuda")
    cp, span = dia.compact, dia.span  # built once, outside the census
    xd, w2d = (torch.randn((hub.R, nb), generator=gen, device="cuda",
                           dtype=torch.float64) for _ in range(2))
    cases = (
        ("ell_gather", "", lambda: ops.ell_spmv(cols, vals, x, compact=cpe),
         ell_bound_bytes(cpe, R, R, nb, S, epilogue=False)),
        ("ell_gather_cheb", "", lambda: ops.ell_spmv(
            cols, vals, x, compact=cpe, epilogue=(w1, w2, 0.013, -0.4)),
         ell_bound_bytes(cpe, R, R, nb, S, epilogue=True)),
        ("ell_gather_cheb", " (w1 = x)", lambda: ops.ell_spmv(
            cols, vals, x, compact=cpe, epilogue=(x, w2, 0.013, -0.4)),
         ell_bound_bytes(cpe, R, R, nb, S, epilogue=True, w1_is_x=True)),
        ("cheb_dia", "", lambda: ops.cheb_dia(
            dia.offsets, dia.dvals, xd, xd, w2d, 0.013, -0.4, compact=cp,
            span=span), dia_bound_bytes(cp, nb, S)),
    )
    for name, note, launch, want in cases:
        _, c = count_ops(launch)
        torch.cuda.synchronize()
        got = c.kernels.get(name, {})
        rec = dict(name=name + note, calls=got.get("calls"),
                   census_bytes=got.get("bytes"), bound_bytes=want, ops=c.ops)
        log(f"[dryrun] census of one {name}{note} launch: "
            f"{rec['census_bytes']} B against the bound's {want} B "
            f"({c.ops} op)")
        if got.get("calls") != 1 or c.ops != 1 or not math.isclose(
                got["bytes"], want, rel_tol=1e-12):
            raise SmokeFailure(f"the census of one {name}{note} launch "
                               f"({got}, {c.ops} ops) is not its bound's "
                               f"{want} B")
        out.append(rec)
    return out


def phase_dryrun(smi: str) -> dict:
    """Phase 12: the dry-run cells through the CLI's entry point, the
    example on the card, the census of one launch of each kernel."""
    import importlib.util

    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun

    t_start = time.perf_counter()
    out: dict = {"cells": {}, "nvidia_smi": smi}
    build.reset_launches()
    for name, argv in DRYRUN_EIGEN.items():
        t0 = time.perf_counter()
        try:
            (rec,) = dryrun.main(argv)
        except SystemExit as e:
            raise SmokeFailure(f"dryrun {name}: --verify failed (exit "
                               f"{e.code})") from None
        rec["seconds"] = time.perf_counter() - t0
        if not (rec.get("verify_ok") and rec["verify_errors"] == []):
            raise SmokeFailure(f"dryrun {name}: verify_ok is false: "
                               f"{rec.get('verify_errors')}")
        if not rec["grid_coll_match"]:
            raise SmokeFailure(
                f"dryrun {name}: the grid's collective bytes "
                f"{rec['grid_coll_bytes']} are not the planner's "
                f"{rec['grid_coll_pred_bytes']}")
        _finite_fields(rec, f"dryrun[{name}]")
        t_mem = rec["grid_roofline"]["t_memory_s"] * 1e3
        log(f"[dryrun] {name} {rec['grid_layout']} on {smi}: measured "
            f"{rec['grid_ms']:.3f} ms a macro-iteration, roofline t_memory "
            f"{t_mem:.3f} ms, ratio {rec['grid_ms'] / t_mem:.3f} "
            f"(counted {rec['grid_hbm_bytes']:.4e} B, "
            f"{rec['grid_flops']:.4e} flops; kernels {rec['grid_kernels']}; "
            f"{rec['seconds']:.1f} s)")
        out["cells"][name] = rec
    for arch, shape in DRYRUN_LM:
        t0 = time.perf_counter()
        (rec,) = dryrun.main(["--arch", arch, "--shape", shape])
        rec["seconds"] = time.perf_counter() - t0
        if rec["status"] != "ok":
            raise SmokeFailure(f"dryrun {arch} x {shape}: {rec}")
        _finite_fields({k: v for k, v in rec.items() if v is not None},
                       f"dryrun[{arch}]")
        log(f"[dryrun] {arch} x {shape}: {rec['ops']} ops counted on the "
            f"meta device, {rec['flops_per_chip']:.4e} flops and "
            f"{rec['hbm_bytes_per_chip']:.4e} B a chip of 256; "
            f"{rec['seconds']:.1f} s")
        out["cells"][f"{arch}/{shape}"] = rec
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", os.path.join(ROOT, DRYRUN_EXAMPLE))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cuda"])
    out["example_seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["launches"] = dict(build.launches)
    for k in ("ell_gather", "ell_gather_cheb", "cheb_dia"):
        if not out["launches"][k]:
            raise SmokeFailure(f"the dryrun phase launched no {k}: "
                               f"{out['launches']}")
    log(f"[dryrun] launches {out['launches']}; the example "
        f"{out['example_seconds']:.1f} s")
    out["census"] = census_launches()
    out["seconds"] = time.perf_counter() - t_start
    return out


def run_lm_phases(smi: str, out_dir: str) -> tuple:
    """Phases 10 (lm) and 11 (train), each timed."""
    t0 = time.perf_counter()
    lm = phase_lm(smi)
    lm["seconds"] = time.perf_counter() - t0
    log(f"[lm] phase {lm['seconds']:.1f} s")
    t0 = time.perf_counter()
    train = phase_train(smi, out_dir)
    train["seconds"] = time.perf_counter() - t0
    log(f"[train] phase {train['seconds']:.1f} s")
    return lm, train


def write_record(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: the smoke run needs one card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(f"{SRC}/repro_torch not found: run chip_smoke.py "
                           "from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out_dir = (os.path.dirname(os.path.abspath(args.out)) if args.out
               else os.path.join(ROOT, "chiprun_out"))
    os.makedirs(out_dir, exist_ok=True)
    if args.lm_only:
        lm, train = run_lm_phases(smi, out_dir)
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi), lm=lm,
                                        train=train))
        return 0

    build.load()
    log(f"[build] {build.build_seconds:.2f} s\n{build.build_log}")
    if args.ranks_only:
        from repro_torch.matrices import Hubbard, RoadNet

        targets = dict(roadnet=dict(target=host_operator(
            RoadNet, ROADNET, "LA")[1] + 0.1), hubbard=dict(
            target=host_operator(Hubbard, HUBBARD_SOLVE, "SA")[1] - 0.1))
        ranks = phase_ranks(targets, out_dir)
        log(f"[ranks] phase {ranks['seconds']:.1f} s")
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi),
                                        build_seconds=build.build_seconds,
                                        ranks=ranks))
        return 0
    if args.dryrun_only:
        dry = phase_dryrun(smi)
        log(f"[dryrun] phase {dry['seconds']:.1f} s")
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi),
                                        build_seconds=build.build_seconds,
                                        dryrun=dry))
        return 0

    t0 = time.perf_counter()
    records: list = []
    phase_kernels(records)
    phase_kernels_families(records)
    phase_kernels_grouped(records)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi),
                                        build_seconds=build.build_seconds,
                                        checks=records))
        return 0

    t0 = time.perf_counter()
    engines = phase_engines()
    log(f"[engines] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    layouts = phase_layouts()
    layouts["determinism"] = determinism_case()
    log(f"[layouts] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fit_path = os.path.join(out_dir, "machine_fit_h100.json")
    plan = phase_plan(layouts, fit_path)
    log(f"[plan] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the ranks' launch starts here: its processes import and make their
    # CUDA contexts during the first solves, then wait idle for the phase
    ranks_launch = RanksLaunch(out_dir)
    try:
        solves = phase_solves(fit_path)
        log(f"[solve] phase {time.perf_counter() - t0:.1f} s")
        ranks = phase_ranks(solves, out_dir, ranks_launch)
    finally:
        ranks_launch.stop()
    log(f"[ranks] phase {ranks['seconds']:.1f} s")
    t0 = time.perf_counter()
    plan["sstep"] = sstep_plan_case(fit_path, solves)
    log(f"[plan] s-step against the solves {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    service = phase_service(records, fit_path, solves, out_dir)
    log(f"[service] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    analysis = phase_analysis()
    analysis["seconds"] = time.perf_counter() - t0
    log(f"[analysis] phase {analysis['seconds']:.1f} s")
    lm, train = run_lm_phases(smi, out_dir)
    dry = phase_dryrun(smi)
    log(f"[dryrun] phase {dry['seconds']:.1f} s")
    main_case = f"Hubbard n_b={N_SEARCH}"  # the shape of the filter's steps
    line = []
    for k in ("ell_gather", "ell_gather_cheb", "cheb_dia"):
        r = next(r for r in records if r["name"] == k
                 and r["case"] == main_case and r["dtype"] == "float64")
        cases = [dict(case=c["case"], dtype=c["dtype"], ms=c["ms"],
                      plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                      bound_by=c["bound_by"], library_ms=c["library_ms"],
                      max_abs_err=c["max_abs_err"], bitwise=c["bitwise"])
                 for c in records
                 if c["name"] == k and not c["case"].startswith("sweep")]
        by_solve = {s: v["launches"][k]
                    for s, v in {**solves, **service["runs"]}.items()}
        by_solve["dryrun"] = dry["launches"][k]
        for label, rr in ranks["runs"].items():  # summed over the ranks
            by_solve[f"ranks_{label}"] = sum(
                n[k] for n in rr["launches_by_rank"])
        for label, key in (("batched", "launches_by_rank"),
                           ("b_alone", "solo_launches_by_rank")):
            by_solve[f"ranks_service_{label}"] = sum(
                n[k] for n in ranks["service"][key])
        line.append(dict(
            name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
            launches=sum(by_solve.values()), launches_by_solve=by_solve,
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            dtypes=sorted({c["dtype"] for c in cases}), cases=cases))
    if args.out:
        write_record(args.out, dict(device=dict(name=name, count=count,
                                                nvidia_smi=smi),
                                    build_seconds=build.build_seconds,
                                    checks=records, engines=engines,
                                    layouts=layouts, plan=plan,
                                    solves=solves, ranks=ranks,
                                    service=service,
                                    analysis=analysis, lm=lm, train=train,
                                    dryrun=dry, kernels=line))
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s from the device "
        "check to the result")
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the full record (every check, the solves) here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase (no result line)")
    ap.add_argument("--lm-only", action="store_true",
                    help="run the device check and the LM phases (serving, "
                         "then training) alone (no kernel build, no result "
                         "line)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run the device check, the build and the dryrun "
                         "phase alone (no result line)")
    ap.add_argument("--ranks-only", action="store_true",
                    help="run the device check, the build and the ranks "
                         "phase alone (its targets from eigsh; no result "
                         "line)")
    ap.add_argument("--ranks-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)  # one rank of the ranks phase
    args = ap.parse_args(argv)
    if args.ranks_worker:
        return ranks_worker(args.ranks_worker)
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
