#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Usage, from the root of a checkout::

    python3 chip_smoke.py

Phases (each one raises on failure, so the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the port's CUDA kernels from ``two_pass_lanczos_tpu_torch/csrc``;
   print the registers and spills ``ptxas`` reports for every instance of
   the persistent kernels (K2, K4, K5, K6's instances of those three, K3,
   K9 and K10, those with the phase timer too) and of the matvecs whose
   node rows are warp rows (K1/K8 in f32 and f64, K7) and their block-row
   references, their
   cooperative grids (resident blocks per SM x SMs) and one digest of the
   SASS of each source's kernels (``ops/_build.sass_digests``);
3. K1, the KKT matvec, against its plain PyTorch version on the headline
   instance ``generate_mcf_instance(500_000, rho=3, instance_id=1)``
   (m = 500,000 arcs, p = 1,155 nodes, n = 501,155);
4. K2, pass one, against the plain ``pass_one_scan`` at k = 20;
5. K3, pass two, against the plain ``pass_two_scan`` on K2's decomposition,
   and bitwise that plain pass two run on K1's matvec (the two launches a
   step that K3 replaced);
6. the main path ``FusedKKTSolver.solve(b, k=500, f="inv")`` with ``b`` on
   the card, with the launch counters reset just before it: K2 and K3 once
   each, 2k - 1 = 999 matvec phases inside them (``kkt_matvec_in_pass``)
   and nothing else, no K1 launch; x must be finite, pass two must
   regenerate pass one's v_s bit for bit, and a small instance must agree
   with the CPU f64 oracle;
7. wall times of k = 500 and k = 1000 solves, of the one-pass, callback
   (never stopping, chunk 64) and compensated solves at k = 500, and of
   each kernel, beside the plain PyTorch versions on the same card; K2 and
   K3 per pass and per step beside the per-step launches they replaced
   (``pass_one_steps_cuda``, k steps in one call), timed by events and as
   one CUDA-graph replay, which shows what the launches alone cost; K4
   and K5's chunk loop (chunks of 64, one read back each) per pass and per
   step beside the per-step launches
   with the basis rows and in the same chunk loop, in turns; K6 (the
   compensated K2 instance) beside the compensated per-step launches, in
   turns; the phase
   split of a K2, a compensated K2, a K4, a K5 (chunks of 64) and a K3 step
   (the passes' phase timer, ``ops/kkt_fused.phase_clock``: every resident
   block's time in each phase of 8 steps from k/2, max, median and mean
   over the blocks; a block's node rows end with its slowest row warp),
   which checks that the timer changes no bit;
7b. the fused solver on ``generate_mcf_instance(5_000_000, rho=3,
   instance_id=1)``: K2, K4 (every basis row too) and K5 (chunks of 7)
   bitwise the per-step launches and K3 bitwise the plain pass two on K1's
   matvec at k = 20, K6's instances of K2, K4 and K5 bitwise the
   compensated per-step launches at k = 20 and 500; ``solve(b, k=500)``
   through K2
   and K3 only, x finite, the median of 3 solves, K2 and K3 per pass and per
   step, and the phase split;
7c. the warp rows (``kkt_node_row_warp``: one warp a node row) of K1, K8
   in f32 and f64 and K7 at e = 1 and 0.3, each bitwise its block-row
   reference entry point (``kkt_matvec_blockrows_cuda``,
   ``kkt_shard_matvec_blockrows_cuda``: one block a node row, the kernel
   they replaced) on the headline, at 5M and on the node walk's edge cases
   (a hub past 4·256 entries, loops, degree-0 nodes); K1, K8 f64 and K7
   and their references timed in turns at both sizes;
8. K4, pass one with the basis (one cooperative launch): alpha, beta,
   ||b||, steps, the final state and every basis row bitwise the per-step
   launches at k = 20 and 500, alpha, beta
   and steps bitwise K2's at k = 500, basis row s-1 bitwise pass one's and
   pass two's v_s, the basis within 1e-5 of the plain
   ``pass_one_scan(emit_basis=True)`` at k = 20, rows past a breakdown
   zero, and the main path ``solve(b, 500, method="one_pass")`` with the
   counters reset: K4 once, 500 matvec phases inside it, no K1 launch, x
   within rel 1e-4 of the two-pass x;
9. K5, the resumable pass one (one cooperative launch a chunk): alpha,
   beta, ||b||, steps, the live flag and the state bitwise the per-step
   launches at k = 20 (chunks of 7) and 500 (chunks of 64),
   ``pass_one_chunked(b, 500, chunk=64)`` bitwise K2's, a callback stop
   at s = 100 after at most 128 matvec phases with K2's alpha prefix,
   agreement with the plain ``pass_one_chunk_scan`` at k = 20, chunk 8,
   and the main path ``solve(b, 500, callback=...)`` with the counters
   reset: K5 8 times, K3 once, 999 matvec phases, no K1 launch;
10. K6, the compensated instances of K2, K4 and K5 (one cooperative launch
    each, a chunk for K5): alpha, beta, ||b||, steps, the state, K4's rows
    and K5's state after its chunks bitwise the compensated per-step
    launches at k = 20 (chunks of 7) and 500 (chunks of 64); within rtol
    1e-5 of the plain f64-dot pass one at k = 20 and at most 0.25x plain
    K2's distance from it, alpha strictly closer than plain K2's to the f64
    oracle at k = 6 on the instance of the JAX package's test (m = 1200, p
    = 300), chunked and one-pass bitwise the monolithic run at k = 500, and
    the main path ``FusedKKTSolver(..., compensated=True).solve(b, 500)``
    with the counters reset: K6 once, K3 once, 999 matvec phases, no K1
    launch;
11. K13, the error-free transformations: exact values on the card;
12. K8, the matvec of the generic KKT operators (``make_kkt_operator``):
    the f32 instance against the plain ``kkt_matvec`` on the headline (arc
    part bitwise, node part within 2·deg·ε·Σ|x|), the f64 instance against
    the plain f64 matvec with the ε of f64, the operator that
    ``operator_from_jax``'s NumPy path builds giving the same y, and the
    time of a cuSPARSE CSR SpMV of the assembled A as the yardstick;
13. the generic two-pass path ``solve_fAb(op, b, k=500, f="inv")`` on the
    headline with the counters reset just before it: K8 launched exactly
    2k - 1 = 999 times and no plain matvec; x finite; the basis that
    ``lanczos_pass_two_with_basis`` regenerates bitwise
    ``lanczos_standard``'s at k = 500; ``solve_fAb``'s x and the host
    path's (``lanczos_two_pass``) x bitwise pass two of their own y (the
    f32 solve of T_500 e₁ on the card and on the host), each y within
    10·κ(T)·ε of the f64 solve of the same α, β, and the gap between the
    two x within ‖V‖₂·‖Δy‖ plus pass two's f32 rounding; α, β at k = 20
    within rtol 1e-4 of the fused K2; a small instance against the CPU f64
    oracle; the launches of ``lanczos_two_pass`` and of ``lanczos``
    (one-pass, a 1.0 GB basis) counted;
14. f64 and the other operators on the card: ``lanczos_two_pass`` on a
    ``DiagonalOperator`` against the analytic x ({inv, exp, z²} at 1e-3 /
    1e-12), the two-pass basis bitwise on an f64 KKT of m = 200,000, and a
    ``SparseOperator`` (``kkt_sorted_coo``) whose pass two regenerates pass
    one's basis bitwise; then the medians of 5 generic two-pass and one-pass
    k = 500 solves and K8's time beside the plain version's and cuSPARSE's;
    then K15, the CSR SpMV of the sparse operators, on the headline's
    assembled f32 matrix: ``solve_fAb(SparseOperator, b, k=500)`` with
    exactly 2k - 1 = 999 K15 launches and nothing else, the same bits twice,
    the basis replayed bitwise at k = 500, α at k = 20 within rtol 1e-4 of
    K8's; y the same bits twice and within 2·(deg+2)·ε·(|A|·|x|)
    (``ops/spmv.row_sum_bound``) of the plain version on the card; its device time warm and cold-L2 beside its
    bound, the plain version's, cuSPARSE's CSR SpMV's, and the medians of 5
    generic two-pass solves on it;
15. K11, the double-float matvec (``DFKKTOperator``), on the headline with
    f64 costs: arc part bitwise its plain version in both planes, node part
    within 8·(deg+1)·2⁻⁴⁸·Σ|x|, rel 1e-13 of K8's f64 instance, the pair
    instance (x and y as (hi, lo) pairs, the layout K9 and K10 gather
    from) bitwise the planar one, and the time of both beside the plain
    version's and a cuSPARSE f64 CSR SpMV's;
16. K9 and K10, the double-float passes (each one persistent cooperative
    launch), and the df main path ``DFFusedKKTSolver(d64, u, v,
    p).solve(b64, k=500, f="inv")`` with b on the card and the counters
    reset: K9 and K10 once each with 2k - 1 = 999 K11 phases inside them
    (``df_kkt_matvec_in_pass``), no K11 launch and no plain df op; x
    finite; pass two's hi and lo v_s bitwise pass one's; K9's α, β (hi and
    lo), ‖b‖, steps and final state and K10's x and state bitwise the
    per-step launches they replaced at k = 20 and k = 500; α, β at k = 20
    within 1e-11·max|α| of the f64 generic pass one (K8 f64) and of the
    plain df pass one; a small instance against the CPU f64 oracle;
    max|Δα| against the f64 run at k = 100/200/500; the medians of 5 df
    solves on K9/K10 and on the per-step launches (the same x bit for
    bit), K9 and K10 per pass and per step beside the per-step launches,
    and their phase split (which checks that the timer changes no bit);
    the generic ``solve_fAb_df`` with ``DFKKTOperator`` on the planar and on
    the pair K11 in turns (the same x bit for bit);
16b. K9 and K10 on the 5M-arc instance: bitwise the per-step launches at
    k = 20; ``solve(b64, k=500)`` through K9 and K10 only, x finite, the
    median of 3 solves, K9 and K10 per pass and per step, the phase split;
17. K7, one shard's matvec, and the f32 sharded main path
    ``ShardedFusedKKTSolver(d, u, v, p, make_mesh(1)).solve(b, k=500,
    f="inv")`` on a one-rank NCCL group, at the headline and at the
    distributed tier's own size ``generate_mcf_instance(5_000_000, rho=3,
    instance_id=1)`` (m = 5,000,000, p = 3,651): one shard bitwise K1, four
    shards in one process with arc parts bitwise K1's slices and node
    partials folding to K1's node part within 2·deg·ε·Σ|x|, K7 against its
    plain version; with the counters reset, 2k - 1 = 999 K7 launches and
    nothing else, no plain shard matvec, x finite, pass two's v_s bitwise
    pass one's, α, β at k = 20 within rtol 2e-4 of K2; medians of 5 (3 at
    5M) solves, and of one-pass and callback (chunk 64) solves at the
    headline; K7's time beside a cuSPARSE CSR SpMV of the shard's A. The
    999 products are K7's step instances (k of pass one's, k - 1 of pass
    two's), with k of each of the fused step's ``node_fold``,
    ``orthogonalise``, ``norm`` and ``advance`` and k - 1 ``two_nodes``
    (``sharded_step.STEP_KERNELS``, reset with ``LAUNCHES``);
17b. each kernel of the fused step (K7's two step instances and
    ``csrc/shard_step.cu``'s five) on rank 0's shard of the 5M instance
    over four cards (~1.25M arcs and p), against its plain version
    (``sharded_step.PlainStepKernels``) on copies of the same inputs:
    every vector and 0-d output bitwise, the block partials and dot shares
    within 64·eps·Σ|term|, K7's node partial within phase 17's bound;
    then timed cold-L2 and warm beside the core scans' PyTorch operations
    that computed the same function;
18. K12, one shard's df matvec on (hi, lo) pairs, and the df sharded main
    path ``DFShardedFusedKKTSolver(d64, u, v, p, mesh).solve(b64, k=500)``
    on the same group at both sizes: one shard bitwise both K11 instances
    in both planes, four
    shards folding within 8·(deg+1)·2⁻⁴⁸·Σ|x|; 999 K12 launches and nothing
    else, no plain df op, x finite, hi and lo v_s bitwise, α, β at k = 20
    within 1e-11·max|α| of ``DFFusedKKTSolver``; medians of 3 df solves;
    K12's time beside a cuSPARSE f64 CSR SpMV;
19. K14, the probes (``two_pass_lanczos_tpu_torch.probes``: gather, stream,
    stages, pipeline), their main path ``probes.run`` at both sizes with the
    counters reset: every variant checked against its plain version
    (``probe_stages`` full and ``probe_pipeline`` full bitwise K7, every
    pipeline mode (full, arc_only, stream_only, no_gather, alu 4/16/64)
    with both stores and every ring shape of its sweep bitwise its
    ``probe_stages`` twin, the stage ``node_sorted``'s y_n bitwise K7's,
    every gather tier bitwise ``tab[idx]``, the cluster tier at least on
    x_n, and on x_a where the card holds its cluster, ``probe_stream``
    bitwise) and timed warm and cold-L2; ``full``'s time beside K7's from
    the same run; the cluster tier's shapes and the tables it could not
    run, with the reason; K7's stage split at each size, which says
    whether its node blocks' x_a gather or its arc stream bounds it and
    what the gather costs beyond a contiguous read (``node_sorted``);
    K14d's split (``probes.pipeline_split``: the ring's T × S × store
    sweep with its blocks per SM, its node and arc kernels concurrent and
    serialised, its arc stream's share of the bound, and for each ALU
    chain whether the ring is nearer max(stream, ALU) or their sum); K13
    beside a launch of an empty kernel, each alone and one of each in one
    CUDA graph, by the same timer;
20. the row-sharded ``ShardedSparseOperator`` on the same one-rank NCCL
    group, on the headline's f32 KKT triplets: ``solve_fAb(b, k=500,
    f="inv")`` with 999 asynchronous gathers and owned SpMVs and exactly
    999 K15 launches (one rank owns every column, so no remote part), x
    finite, pass two's v_s bitwise pass one's, α, β at k = 20
    within rtol 1e-4 of the generic ``SparseOperator`` solve; device events
    per step; medians of 5 solves beside the generic two-pass solve; a
    small f64 instance within rel 1e-9 of one device;
21. the fused tier's capability methods on the headline solver, each
    driven with the counters reset: ``slq_trace("inv", k=50,
    num_probes=16, key=0)`` (16 K2 launches and nothing else, every
    probe's alpha, beta, steps and ||z|| bitwise ``pass_one_cuda`` alone,
    the samples at k = 20 within rtol 2e-3 of the f64 plain pass on the
    CPU), the same on the compensated solver with 4 probes (4 K6 launches,
    bitwise alone), ``slq_trace_adaptive(batch=8, max_probes=32)`` (its
    probe count and relative stderr printed), ``estimate_interval()`` (K8
    only, cached, holding every Ritz value of K2's k = 500 decomposition
    of b, reproduced by its two ``eigsh`` runs, whose restarts are
    printed), ``slq_spectral_density`` on 201 points over the interval (8
    K2 launches, mass within 0.05 of 1), ``chebyshev_fAb(b, exp(t/rho),
    degree=100)`` with rho the interval's radius (exactly 100 K1 launches,
    within 2e-4·max|y| of the f64 plain expansion on the CPU, and the
    generic ``chebyshev_fAb`` on ``make_kkt_operator`` (100 K8 launches)
    within the same of it), and the median of 3 calls of each method;
22. reorthogonalisation and block Lanczos on the headline's f32
    ``make_kkt_operator`` (K8), each driven with the counters reset:
    ``solve_fAb(b, k=500, method="one_pass", reorth=True)`` (exactly 500
    K8 launches; the basis's max|VᵀV − I| in f64 at most 1e-4 and 100×
    below the plain one-pass basis's, which is above 1e-2; α, β at k = 20
    within rtol 1e-4 of the CPU f64 run; the same bits with TF32 on),
    ``reorth="selective"`` (500 K8 launches, its sweeps counted; at a k
    where none fires, bitwise the plain one-pass solve),
    ``solve_fAb_block`` with p = 4, k = 100, one- and two-pass (p K8
    launches a step and pass: 400 and 800; the two within rtol 1e-4; the
    replay drift printed and gated at 1e-12; the same bits with TF32 on;
    m = 500 within 1e-4 of the CPU f64 run), and medians of 3 beside the
    plain one-pass solve;
23. the sharded tiers' capability methods on the one-rank NCCL group,
    each driven with the counters reset and held against its single-card
    twin on the same probes, v0 or coefficients: the row-sharded
    operator's ``eigsh`` (LA and SA), SLQ methods, ``solve_fAb_block``,
    ``estimate_interval``, ``chebyshev_fAb`` and ``solve_fAb(reorth=True)``
    (K15 alone), the arc-sharded solver's SLQ methods (k fused pass-one
    steps a probe, a probe bitwise a solve's pass one), ``estimate_interval``
    (K8 only, the fused solver's interval, cached) and ``chebyshev_fAb``
    (``degree`` K7 launches; whether it is bitwise the fused K1 expansion
    is printed), and medians of 3 of every method;
24. the experiment CLIs (``python -m two_pass_lanczos_tpu_torch.
    experiments.<name>``) and the measurement tools (``...tools.<name>``)
    on the card, each writing the header of the JAX CLI's published run
    under ``results/`` into a temporary directory: ``tradeoff`` on the
    headline (K2, K3 and K4 once a solve; the one-pass device peak from k
    = 100 to 1000 within 10 % of 900·n·4 bytes, the two-pass peak flat),
    also with ``--isolate`` (4 workers) and ``--backend pallas`` (K8);
    ``scalability`` (one-pass less two-pass within 10 % of k·n·4 bytes at
    each n); ``stability`` in f64 (within 10× of the published CPU f64
    errors) and in df at k = 200; ``orthogonality`` (``basis_drift_fro``
    exactly 0); ``certificate_study``, ``reorth_study``,
    ``dense_tradeoff``; ``tools.sol_bench`` (K7, 0 < sol_fraction_ideal ≤
    1.05) and ``tools.scaling_bench --processes 1`` on NCCL; its wall
    time printed;
25. complex Hermitian operators and the twin of ``__graft_entry__.py``:
    the Hofstadter magnetic Laplacian on a periodic 1024 × 1024 lattice
    (flux 1/64, Landau gauge, ``models.hofstadter_triplets``; n =
    1,048,576, nnz = 5,242,880, complex128) shifted by 0.5 (κ ≤ 17), f =
    inv: the generic ``solve_fAb(SparseOperator, b, k=500)`` launches
    exactly 999 K15 (c128) and nothing else, replays its basis bit for bit
    (``basis_drift_fro`` 0) and
    gives the same bits in two runs, its residual at most 1e-10, α and β
    at k = 20 within 1e-11·max|α| of the CPU run, the one-pass solve at k
    = 200 within 1e-12 of it; the row-sharded ``ShardedSparseOperator``
    on a one-rank NCCL group within 1e-12 of it (999 K15 launches), and
    its ``eigsh(nev=2, which="LA")`` pairs with ‖Hu − θu‖ ≤ 1e-7; medians
    of 3 of the single-card and row-sharded complex solves beside phase
    20's real one; K15's c128 time warm and cold-L2 beside its bound, the
    plain version's and cuSPARSE's; then ``entry()`` (exactly 31 K8
    launches, x within 1e-3 of the f64 CPU solve) and
    ``dryrun_multichip(1)`` (every leg's check, its K7, K8, K12 and K15
    launches counted).

Every kernel's entry of the JSON line carries its launches on its main
path, plus those of phases 21–23's paths (``capability_launches``, per
path: K1's in the fused Chebyshev expansion, K2's and K6's in the SLQ
methods, K8's under ``estimate_interval``, the generic expansion, the
reorthogonalised and block solves and the arc-sharded interval, K7's in
the arc-sharded expansion, the fused step's kernels (K7's pass-one
instance among them) in the arc-sharded SLQ methods, K15's in the
row-sharded methods), of phase 24's
(``tool_launches``: K1, K2, K3 and K4 under ``tradeoff`` and
``scalability``, K8 under ``tradeoff --backend pallas``, K7 in
``sol_bench``'s graphs) and of phase 25's (``entry_launches``: K8 under
``entry()``, K7, K8, K12 and K15 under ``dryrun_multichip(1)``). K15's
entry (``csr_spmv``, which replaces no TPU kernel) is the headline's
assembled f32 KKT matrix of phase 14, with its ``cold_ms`` and phase 25's
Hofstadter times (``hofstadter``: c128, warm and cold, plain, cuSPARSE,
bound). On the solve
path K1 launches 0 times, since K2-K6 launch no K1; its entry also carries
``in_pass_matvecs``, the matvec phases its routines ran inside K2 and K3
on the main path, K4 in the one-pass solve, K5 in the callback solve and
K6 in the compensated solve,
and ``in_pass_us``, the phase timer's µs of one such phase a step in K2,
K6's K2 instance, K4, K5 and K3, from the step's start to the slowest
block's first barrier: the
node and arc rows with the elementwise work fused into them, in K2
w -= beta_prev v_prev and <v, w>, in K3 the update of v_next and x; K11's
likewise: 0 launches, and its phases inside K9 and K10; K4's, K5's and
K6's entries carry their own ``in_pass_matvecs`` and ``step_us``, their
``ms`` over k, and K6's ``steps_ms``, the compensated per-step launches'
time in the same run; K1's, K8's (its f64 instance) and K7's carry
``warp_rows_ms`` and ``blockrows_ms``, phase 7c's times of the kernel and
of its block-row reference at the headline and at 5M; K11's ``ms`` is its pair instance's, its
``planar_ms`` the planar instance's; K13's carries phase 19's
``graph_ms``, ``empty_launch_ms`` and ``with_empty_launch_ms``, its
launch beside an empty kernel's),
its max_abs_err against its plain version,
its time
(``ms``), the plain version's (``plain_ms``), ``bound_ms`` (the larger of
the bytes the function must move, each input read once and each output
written once,
over 3.35 TB/s and its f32 operations (a double-float operation counted as
the f32 operations it is made of) over 67 TFLOP/s, the H100 SXM's
peaks, counted from this run's shapes and steps; ``bound_by`` names the
larger) and ``library_ms``, the time of one PyTorch call that computes the
same function (cuSPARSE SpMV for the matvecs), or null. A single call
(K1, K8, K13, their plain versions, cuSPARSE) is timed as device time:
200 calls captured in one CUDA graph and replayed, so the host's launch
cost is not in it. A pass (K2-K6 and their plain
versions) is timed by CUDA events around the whole pass, idle gaps
between its launches included. The K14 rows (and their plain and library
calls) take the cold-L2 time, a 128 MB write before each call inside the
graph, its own time subtracted: warm, the headline's inputs come from L2
and the HBM bound would not hold. The launches of K14 are the kernels
phase 19's timing graphs ran, once per replay. The script fails if any
kernel's ``ms`` is below its ``bound_ms``.

The line before the last is that JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it prints no result and exits 2.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = {"arcs": 500_000, "rho": 3, "instance_id": 1}
#: the distributed tier's size, BASELINE.json's ">= 5M arcs" netgen KKT
BIG = {"arcs": 5_000_000, "rho": 3, "instance_id": 1}
K = 500
K_LONG = 1000
K_CHECK = 20
CHUNK = 64
STOP_AT = 100
M_F64 = 200_000  # arcs of phase 14's f64 KKT
K_F64 = 100
#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
#: outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
PASS_ONE_CU = "two_pass_lanczos_tpu_torch/csrc/lanczos_pass_one.cu"
KERNELS = {
    "kkt_matvec": ("two_pass_lanczos_tpu_torch/csrc/kkt_matvec.cu",
                   "two_pass_lanczos_tpu/ops/kkt_fused.py:924"),
    "lanczos_pass_one": (PASS_ONE_CU,
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:581"),
    "lanczos_pass_two": ("two_pass_lanczos_tpu_torch/csrc/lanczos_pass_two.cu",
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:841"),
    "lanczos_pass_one_basis": (PASS_ONE_CU,
                               "two_pass_lanczos_tpu/ops/kkt_fused.py:752"),
    "lanczos_pass_one_chunk": (PASS_ONE_CU,
                               "two_pass_lanczos_tpu/ops/kkt_fused.py:647"),
    "lanczos_pass_one_comp": (PASS_ONE_CU,
                              "two_pass_lanczos_tpu/ops/kkt_fused.py:567"),
    "eft_check": ("two_pass_lanczos_tpu_torch/csrc/eft_check.cu",
                  "tests/test_fused_df.py:274"),
    "kkt_operator_matvec": ("two_pass_lanczos_tpu_torch/csrc/kkt_matvec.cu",
                            "two_pass_lanczos_tpu/ops/spmv_pallas.py:52"),
    "df_kkt_matvec": ("two_pass_lanczos_tpu_torch/csrc/df_kkt_matvec.cu",
                      "two_pass_lanczos_tpu/ops/kkt_fused_df.py:673"),
    "df_lanczos_pass_one": (
        "two_pass_lanczos_tpu_torch/csrc/df_lanczos_pass_one.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused_df.py:381"),
    "df_lanczos_pass_two": (
        "two_pass_lanczos_tpu_torch/csrc/df_lanczos_pass_two.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused_df.py:486"),
    "kkt_streaming_matvec": (
        "two_pass_lanczos_tpu_torch/csrc/kkt_shard_matvec.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused.py:937"),
    "df_kkt_streaming_matvec": (
        "two_pass_lanczos_tpu_torch/csrc/df_kkt_shard_matvec.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused_df.py:602"),
    # K14, the Pallas probes (each replaces several; the first is named)
    "probe_gather": ("two_pass_lanczos_tpu_torch/csrc/probe_gather.cu",
                     "scripts/probe_gather.py:41"),
    "probe_stream": ("two_pass_lanczos_tpu_torch/csrc/probe_stream.cu",
                     "scripts/probe/stream_blocks.py:44"),
    "probe_stages": ("two_pass_lanczos_tpu_torch/csrc/probe_stages.cu",
                     "scripts/probe/stream_stages.py:98"),
    "probe_pipeline": ("two_pass_lanczos_tpu_torch/csrc/probe_pipeline.cu",
                       "scripts/probe/stream_manual.py:194"),
    # K15 replaces no TPU kernel: the JAX coo_spmv is XLA's
    "csr_spmv": ("two_pass_lanczos_tpu_torch/csrc/csr_spmv.cu", None),
    # the arc-sharded solver's fused step: K7's step instances, and the
    # kernels after the folds, which replace XLA's step around K7
    "kkt_shard_matvec_step_one": (
        "two_pass_lanczos_tpu_torch/csrc/kkt_shard_matvec.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused.py:937"),
    "kkt_shard_matvec_step_two": (
        "two_pass_lanczos_tpu_torch/csrc/kkt_shard_matvec.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused.py:937"),
    **{name: ("two_pass_lanczos_tpu_torch/csrc/shard_step.cu", None)
       for name in ("shard_step_node_fold", "shard_step_orthogonalise",
                    "shard_step_norm", "shard_step_advance",
                    "shard_step_two_nodes")},
}
#: the probe variant whose numbers stand in the ``kernels`` line
PROBE_MAIN = {"probe_gather": ("gather", "arc_u/ldg/int32"),
              "probe_stream": ("stream", "soa/256x1"),
              "probe_stages": ("stages", "full"),
              "probe_pipeline": ("pipeline", "pipeline")}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls,
    after one warm-up call, by CUDA events."""
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


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, its replay timed by CUDA events, over ``reps``. The
    host's launch cost is not in it; the graph's gaps between kernels
    are."""
    import torch
    side = torch.cuda.Stream()  # warm up off the default stream, then capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = event_ms(graph.replay, 3) / reps
    del graph
    return ms


def roofline_ms(nbytes: float, flops: float):
    """(ms, what binds): the larger of bytes over the HBM rate and f32
    operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(m: int, n: int, steps: int, k: int) -> dict:
    """``(bound ms, what binds)`` of each kernel's function on an instance
    of m arcs and n = m + p unknowns, for passes of ``steps`` steps with
    k-long coefficient arrays.

    Bytes: each input read once and each output written once (f32 values,
    int32 indices); what a kernel reads again (the node-sorted incidence
    CSR that its layout builds from u and v, a pass's per-step state)
    belongs to its design, not to the function. Operations: f32, per step
    one matvec (3 per arc row, 2 per incidence entry) and the recurrence's
    vector work. The double-float kernels move (hi, lo) pairs, 8 bytes a
    value, and count the f32 operations of their error-free
    transformations (``csrc/df_common.cuh``: df_prod 6, df_add2 11,
    df_axpy 17, df_scale 9): a df matvec 28 per arc row and 11 per
    incidence entry, 50 per arc; a df pass-one step 76 per unknown (two
    axpys fused with a product and a fold, one scale), a pass-two step 60.
    """
    from two_pass_lanczos_tpu_torch.observability import df_kkt_matvec_bytes
    mv_in = 12 * m                   # d, u, v
    mv_flops = 5 * m
    p1_bytes = mv_in + 4 * n + 8 * k  # + b; alpha, beta out
    p1_flops = steps * (mv_flops + 9 * n)
    matvec = roofline_ms(mv_in + 8 * n, mv_flops)  # + x in, y out
    df_mv_flops = 50 * m
    # d, u, v, b pairs in; alpha, beta pairs and the ||b|| pair out
    df_p1_bytes = 16 * m + 8 * n + 16 * k + 8
    return {
        "kkt_matvec": matvec,
        "lanczos_pass_one": roofline_ms(p1_bytes, p1_flops),
        # + x out, y in
        "lanczos_pass_two": roofline_ms(p1_bytes + 4 * n + 4 * k,
                                        steps * (mv_flops + 7 * n)),
        # + the (steps, n) basis out
        "lanczos_pass_one_basis": roofline_ms(p1_bytes + 4 * steps * n,
                                              p1_flops),
        "lanczos_pass_one_chunk": roofline_ms(p1_bytes, p1_flops),
        "lanczos_pass_one_comp": roofline_ms(
            p1_bytes, steps * (mv_flops + 31 * n)),
        # (2, 128) in, (6, 128) out
        "eft_check": roofline_ms(32 * 128, 30 * 128),
        "kkt_operator_matvec": matvec,
        "df_kkt_matvec": roofline_ms(
            df_kkt_matvec_bytes(m, n - m), df_mv_flops),
        "df_lanczos_pass_one": roofline_ms(
            df_p1_bytes, steps * (df_mv_flops + 76 * n)),
        # + the x pair out, the y pair in
        "df_lanczos_pass_two": roofline_ms(
            df_p1_bytes + 8 * n + 8 * k, steps * (df_mv_flops + 60 * n)),
        # one shard's matvec (the whole instance on one rank) computes the
        # same function: its y_a and node partial are the matvec's y
        "kkt_streaming_matvec": matvec,
        "df_kkt_streaming_matvec": roofline_ms(
            df_kkt_matvec_bytes(m, n - m), df_mv_flops),
        # K14 at the variants of PROBE_MAIN: x_n[u] (an int32 index in, an
        # f32 out per arc, the table once); the arc stream (20 bytes and 4
        # operations an arc); K7's function for the stage and pipeline
        # probes
        "probe_gather": roofline_ms(8 * m + 4 * (n - m), 0),
        "probe_stream": roofline_ms(20 * m, 4 * m),
        "probe_stages": matvec,
        "probe_pipeline": matvec,
        # K15 on the assembled f32 KKT matrix: 5 nonzeros an arc (D's, E's
        # and Eᵀ's)
        "csr_spmv": csr_spmv_bound(5 * m, n, n, 4, False),
        # the fused sharded step, a launch on rank 0's shard of the instance
        # over STEP_RANKS cards, one row of y
        **step_bounds(-(-m // STEP_RANKS), n - m, STEP_RANKS, 1),
    }


def timed_split(lay, b, solver, dec, y_full, x_ref) -> dict:
    """K2, K6's K2 instance, K4, K5 (chunks of CHUNK) and K3 once more on
    ``dec``'s run, with the phase timer: every resident block stamps each
    phase end of TIMED_STEPS steps from step K // 2 (the node rows' end is
    the latest of the block's warps, stamped with no barrier). Checks that
    the timer changed no bit (against ``dec``, an untimed compensated run,
    K4's untimed decomposition, state and final basis row and K3's
    ``x_ref``), prints the split and returns ``phase_split`` of each
    pass."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        PassOneBuffers,
        pass_one_basis_cuda,
        pass_one_chunk_cuda,
        pass_one_cuda,
        pass_two_cuda,
        phase_clock,
        phase_split,
    )
    dev = b.device
    k = dec.k_max
    clk = {name: phase_clock(name, dev) for name in (
        "lanczos_pass_one", "lanczos_pass_one_comp", "lanczos_pass_one_basis",
        "lanczos_pass_one_chunk", "lanczos_pass_two")}
    dec_t = pass_one_cuda(lay, b, k, solver.tol, solver.ztol,
                          phase_clock=clk["lanczos_pass_one"])
    dec_c = pass_one_cuda(lay, b, k, solver.tol, solver.ztol,
                          compensated=True)
    dec_ct = pass_one_cuda(lay, b, k, solver.tol, solver.ztol,
                           compensated=True,
                           phase_clock=clk["lanczos_pass_one_comp"])
    st4, st4_t = (torch.empty(2, lay.n, device=dev) for _ in range(2))
    dec4, basis = pass_one_basis_cuda(lay, b, k, solver.tol, solver.ztol,
                                      state=st4)
    last = basis[dec4.steps() - 1].clone()
    del basis
    dec4_t, basis_t = pass_one_basis_cuda(
        lay, b, k, solver.tol, solver.ztol, state=st4_t,
        phase_clock=clk["lanczos_pass_one_basis"])
    last_t = basis_t[dec4_t.steps() - 1].clone()
    del basis_t
    bufs5 = PassOneBuffers.alloc(lay, k, persistent=True)
    for j0 in range(0, k, CHUNK):
        pass_one_chunk_cuda(lay, bufs5, b, j0, min(CHUNK, k - j0),
                            solver.tol, solver.ztol,
                            phase_clock=clk["lanczos_pass_one_chunk"])
    x_t = pass_two_cuda(lay, b, dec, y_full, solver.ztol,
                        phase_clock=clk["lanczos_pass_two"])
    torch.cuda.synchronize()
    check(torch.equal(dec_t.alphas, dec.alphas)
          and torch.equal(dec_ct.alphas, dec_c.alphas)
          and torch.equal(dec_ct.betas, dec_c.betas)
          and torch.equal(dec4_t.alphas, dec4.alphas)
          and torch.equal(dec4_t.betas, dec4.betas)
          and torch.equal(st4_t, st4) and torch.equal(last_t, last)
          and torch.equal(bufs5.alphas, dec.alphas)
          and torch.equal(bufs5.betas, dec.betas)
          and torch.equal(x_t, x_ref), "the phase timer changed the passes")
    check(all(bool((c > 0).all()) for c in clk.values()),
          "the phase timer left a stamp unwritten")
    split = {name: phase_split(c, name) for name, c in clk.items()}
    print_split(split, k // 2, clk["lanczos_pass_one"].shape[1])
    return split


def print_split(split: dict, first: int, blocks: int) -> None:
    """Print ``phase_split`` of each pass in ``split`` (name -> split)."""
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import PHASES, TIMED_STEPS
    for name, got in split.items():
        print(f"    {name} phase split, us a step (steps {first}.."
              f"{first + TIMED_STEPS - 1}, {blocks} blocks; max / "
              f"median / mean over blocks; timer tick <= {got['tick_ns']} "
              f"ns):")
        for ph in (*PHASES[name], "matvec phase", "step"):
            print(f"      {ph:>18}: {got[ph]['max_us']:8.3f} "
                  f"{got[ph]['median_us']:8.3f} {got[ph]['mean_us']:8.3f}")


def df_routes(sdf, b2, k: int) -> None:
    """K9 and K10, then the per-step launches they replaced, on one (2, n)
    b and one seeded y (zero beyond steps_taken). Fails unless the two
    routes' coefficients, ||b||, steps, final states and x agree bit for
    bit."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_pass_one_cuda,
        df_pass_one_steps_cuda,
        df_pass_two_cuda,
        df_pass_two_steps_cuda,
    )
    out = []
    for one, two in ((df_pass_one_cuda, df_pass_two_cuda),
                     (df_pass_one_steps_cuda, df_pass_two_steps_cuda)):
        st1 = torch.empty(2, 2, sdf.n, device=b2.device)
        c = one(sdf.layout, sdf.d2, b2, k, sdf.tol, sdf.ztol, state=st1)
        if not out:
            y = np.random.default_rng(k).standard_normal((2, k))
            y[:, int(c[5][0]):] = 0.0
            y2 = torch.from_numpy(y.astype(np.float32)).to(b2.device)
        st2 = torch.empty_like(st1)
        out.append((c, st1, two(sdf.layout, sdf.d2, b2, c, y2, sdf.ztol,
                                state=st2), st2))
    torch.cuda.synchronize()
    (c, st1, x2, st2), (cr, st1r, x2r, st2r) = out
    check(all(torch.equal(a, r) for a, r in zip(c, cr))
          and torch.equal(st1, st1r),
          f"K9's alpha, beta, ||b||, steps or state differ from the per-step "
          f"launches at k={k}")
    check(torch.equal(x2, x2r) and torch.equal(st2, st2r),
          f"K10's x or state differs from the per-step launches at k={k}")


def df_timed_split(sdf, b2, coeffs, y2, x2_ref) -> dict:
    """K9 and K10 once more on ``coeffs``' run with the phase timer; checks
    that the timer changed no bit, prints the split and returns
    ``phase_split`` of each pass."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        phase_clock,
        phase_split,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_pass_one_cuda,
        df_pass_two_cuda,
    )
    dev = b2.device
    k = int(coeffs[0].shape[0])
    clk1 = phase_clock("df_lanczos_pass_one", dev)
    clk2 = phase_clock("df_lanczos_pass_two", dev)
    c_t = df_pass_one_cuda(sdf.layout, sdf.d2, b2, k, sdf.tol, sdf.ztol,
                           phase_clock=clk1)
    x_t = df_pass_two_cuda(sdf.layout, sdf.d2, b2, coeffs, y2, sdf.ztol,
                           phase_clock=clk2)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(c_t, coeffs))
          and torch.equal(x_t, x2_ref), "the phase timer changed K9 or K10")
    check(bool((clk1 > 0).all()) and bool((clk2 > 0).all()),
          "the phase timer left a stamp of K9 or K10 unwritten")
    split = {"df_lanczos_pass_one": phase_split(clk1, "df_lanczos_pass_one"),
             "df_lanczos_pass_two": phase_split(clk2, "df_lanczos_pass_two")}
    print_split(split, k // 2, clk1.shape[1])
    return split


def generic_df_routes(dfop, b64) -> dict:
    """Host seconds of ``solve_fAb_df(dfop, b64, k=K)`` with
    ``DFKKTOperator.matvec_df`` on the planar K11 (its x stacked into
    planes, y split back) and on the pair K11 (as the operator runs it),
    three of each in turns; checks that both give the same x bit for
    bit."""
    import torch
    from two_pass_lanczos_tpu_torch import DFKKTOperator, solve_fAb_df
    from two_pass_lanczos_tpu_torch.ops.df import DF
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_kkt_matvec_cuda,
    )

    def planar_matvec(self, x):
        y2 = df_kkt_matvec_cuda(self.layout, self.d2,
                                torch.stack([x.hi, x.lo]))
        return DF(y2[0], y2[1])

    pair_matvec = DFKKTOperator.matvec_df
    out, xs = {"planar": [], "pair": []}, {}
    try:
        for _ in range(3):
            for route, fn in (("planar", planar_matvec),
                              ("pair", pair_matvec)):
                DFKKTOperator.matvec_df = fn
                ts = wall_s(lambda: xs.__setitem__(
                    route, solve_fAb_df(dfop, b64, k=K, f="inv")), 1)
                out[route] += ts
    finally:
        DFKKTOperator.matvec_df = pair_matvec
    check(torch.equal(xs["planar"], xs["pair"]),
          "solve_fAb_df differs between the planar and the pair K11")
    return out


def df_y(coeffs, k: int):
    """The (2, k) hi/lo y of a df solve (f = inv) from pass one's coeffs,
    as ``DFFusedKKTSolver.solve`` forms it."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
    c = [t.double().cpu().numpy() for t in coeffs]
    steps = int(c[5][0])
    y = np.zeros(k)
    y[:steps] = host_f_tk_solve((c[0] + c[1])[:steps],
                                (c[2] + c[3])[:steps - 1], "inv") * (
                                    c[4][0] + c[4][1])
    y_h = y.astype(np.float32)
    y_l = (y - y_h.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.stack([y_h, y_l])).to(coeffs[0].device)


def df_big_phase(card, dev, big) -> None:
    """Phase 16b: K9 and K10 on the 5M-arc instance, whose df state and
    layout leave the L2: bitwise their per-step launches at k = K_CHECK;
    ``DFFusedKKTSolver.solve(b64, k=K)`` through K9 and K10 only, x
    finite, the median of 3 solves, K9 and K10 per pass and per step, and
    their phase split."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch import DFFusedKKTSolver
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )
    sdf = DFFusedKKTSolver(big.quad_costs, big.arc_u, big.arc_v,
                           big.num_nodes, device=dev)
    b64 = torch.from_numpy(np.random.default_rng(16).standard_normal(sdf.n)
                           ).to(dev)
    b2 = sdf.pack(b64)
    df_routes(sdf, b2, K_CHECK)
    torch.cuda.empty_cache()
    reset_launches()
    x, (_, _, steps) = sdf.solve(b64, k=K, f="inv")
    torch.cuda.synchronize()
    got = {name: c for name, c in LAUNCHES.items() if c}
    check(got == {"df_lanczos_pass_one": 1, "df_lanczos_pass_two": 1,
                  "df_kkt_matvec_in_pass": 2 * K - 1},
          f"5M df launches {got}")
    check(bool(torch.isfinite(x).all()), "5M df x is not finite")
    coeffs = sdf.pass_one(b2, K)
    y2 = df_y(coeffs, K)
    x2 = sdf.pass_two(b2, coeffs, y2[0], y2[1])
    k9 = event_ms(lambda: sdf.pass_one(b2, K), 3)
    k10 = event_ms(lambda: sdf.pass_two(b2, coeffs, y2[0], y2[1]), 3)
    t = wall_s(lambda: sdf.solve(b64, k=K, f="inv"), 3)
    print(f"[16b] 5M df solver on {card}: m={sdf.layout.m} p={sdf.layout.p}:"
          f" K9's alpha, beta (hi, lo), ||b||, steps and state and K10's x "
          f"and state bitwise the per-step launches at k={K_CHECK}; "
          f"solve(k={K}) launches {got}, steps {steps}")
    print(f"    df solve k={K}: {runs(t)}")
    print(f"    K9 {k9:.4f} ms a pass, {1e3 * k9 / K:.3f} us a step; K10 "
          f"{k10:.4f} ms a pass, {1e3 * k10 / max(steps - 1, 1):.3f} us a "
          f"step")
    df_timed_split(sdf, b2, coeffs, y2, x2)


#: the persistent kernels' instances, by a part of their mangled names (the
#: df pass one's first: it contains pass one's name)
PERSISTENT_INSTANCES = (
    ("df_pass_one_persistent_kernelINS_10PhaseClock", "K9 (timer build)"),
    ("df_pass_one_persistent_kernelINS_7NoClock", "K9"),
    ("df_pass_two_persistent_kernelINS_10PhaseClock", "K10 (timer build)"),
    ("df_pass_two_persistent_kernelINS_7NoClock", "K10"),
    ("pass_one_persistent_kernelILb0ELb0ELb0E", "K2"),
    ("pass_one_persistent_kernelILb1ELb0ELb0E", "K4"),
    ("pass_one_persistent_kernelILb0ELb1ELb0E", "K5"),
    ("pass_one_persistent_kernelILb0ELb0ELb1E", "K6 (K2's instance)"),
    ("pass_one_persistent_kernelILb1ELb0ELb1E", "K6 (K4's instance)"),
    ("pass_one_persistent_kernelILb0ELb1ELb1E", "K6 (K5's instance)"),
    ("pass_two_persistent_kernel", "K3"),
    # the matvecs whose node rows are warp rows, and their block-row
    # references (the length prefix keeps the df kernels out)
    ("17kkt_matvec_kernelIfLb0E", "K1/K8 f32"),
    ("17kkt_matvec_kernelIdLb0E", "K8 f64"),
    ("17kkt_matvec_kernelIfLb1E", "K1/K8 f32 block-row reference"),
    ("17kkt_matvec_kernelIdLb1E", "K8 f64 block-row reference"),
    ("23kkt_shard_matvec_kernelILb0E", "K7"),
    ("23kkt_shard_matvec_kernelILb1E", "K7 block-row reference"))


def persistent_instance(mangled: str) -> str:
    """The kernel a persistent instance's (or a matvec's) mangled name is,
    or the name."""
    return next((label for part, label in PERSISTENT_INSTANCES
                 if part in mangled), mangled)


def k2_routes(lay, b, k: int, tol: float, ztol: float,
              compensated: bool = False):
    """K2 (compensated: K6's K2 instance), one cooperative launch, and the
    per-step launches it replaced with the same comp, on one b. Fails
    unless alpha, beta, ||b||, steps and the final (v_prev, v_curr) agree
    bit for bit; returns K2's decomposition."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        PassOneBuffers,
        pass_one_cuda,
        pass_one_steps_cuda,
    )
    name = "K6's K2 instance" if compensated else "K2"
    state = torch.empty(2, lay.n, device=b.device)
    dec = pass_one_cuda(lay, b, k, tol, ztol, state=state,
                        compensated=compensated)
    ref = PassOneBuffers.alloc(lay, k)
    pass_one_steps_cuda(lay, ref, b, 0, k, tol, ztol, compensated=compensated)
    torch.cuda.synchronize()
    check(dec.steps() == int(ref.steps[0])
          and torch.equal(dec.alphas, ref.alphas)
          and torch.equal(dec.betas, ref.betas)
          and torch.equal(dec.b_norm.reshape(1), ref.bnorm)
          and torch.equal(state, ref.state),
          f"{name}'s alpha, beta, ||b||, steps or state differ from the "
          f"per-step launches at k={k}")
    return dec


def k4_routes(lay, b, k: int, tol: float, ztol: float,
              compensated: bool = False):
    """K4 (compensated: K6's K4 instance), one cooperative launch, and the
    per-step launches it replaced with the same comp, with their basis
    rows, on one b. Fails unless alpha, beta, ||b||, steps, the final
    (v_prev, v_curr) and every basis row agree bit for bit; returns K4's
    decomposition, basis and state."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        PassOneBuffers,
        pass_one_basis_cuda,
        pass_one_steps_cuda,
    )
    name = "K6's K4 instance" if compensated else "K4"
    state = torch.empty(2, lay.n, device=b.device)
    dec, basis = pass_one_basis_cuda(lay, b, k, tol, ztol,
                                     compensated=compensated, state=state)
    ref = PassOneBuffers.alloc(lay, k)
    rows = torch.zeros_like(basis)
    pass_one_steps_cuda(lay, ref, b, 0, k, tol, ztol, basis=rows,
                        compensated=compensated)
    torch.cuda.synchronize()
    check(dec.steps() == int(ref.steps[0])
          and torch.equal(dec.alphas, ref.alphas)
          and torch.equal(dec.betas, ref.betas)
          and torch.equal(dec.b_norm.reshape(1), ref.bnorm)
          and torch.equal(state, ref.state),
          f"{name}'s alpha, beta, ||b||, steps or state differ from the "
          f"per-step launches at k={k}")
    check(torch.equal(basis, rows),
          f"{name}'s basis rows differ from the per-step launches' at k={k}")
    return dec, basis, state


def k5_routes(lay, b, k: int, chunk: int, tol: float, ztol: float,
              compensated: bool = False):
    """K5 (compensated: K6's K5 instance), one cooperative launch a chunk
    of ``chunk`` steps on one set of carried buffers, and the per-step
    launches it replaced with the same comp in the same chunks. Fails
    unless alpha, beta, ||b||, steps, the live flag and the (v_prev,
    v_curr) after each chunk agree bit for bit; returns K5's buffers."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        PassOneBuffers,
        pass_one_chunk_cuda,
        pass_one_steps_cuda,
    )
    name = "K6's K5 instance" if compensated else "K5"
    bufs = PassOneBuffers.alloc(lay, k, persistent=True)
    ref = PassOneBuffers.alloc(lay, k)
    for j0 in range(0, k, chunk):
        c = min(chunk, k - j0)
        pass_one_chunk_cuda(lay, bufs, b, j0, c, tol, ztol, compensated)
        pass_one_steps_cuda(lay, ref, b, j0, c, tol, ztol,
                            compensated=compensated)
        if compensated:  # K6's state after each chunk
            torch.cuda.synchronize()
            check(torch.equal(bufs.state, ref.state)
                  and torch.equal(bufs.steps, ref.steps),
                  f"{name}'s state differs from the per-step launches' "
                  f"after chunk [{j0}, {j0 + c}) at k={k}")
    torch.cuda.synchronize()
    check(all(torch.equal(getattr(bufs, f), getattr(ref, f))
              for f in ("alphas", "betas", "bnorm", "steps", "state"))
          and torch.equal(bufs.flags[:1], ref.flags),
          f"{name}'s alpha, beta, ||b||, steps, live flag or state differ "
          f"from the per-step launches at k={k}, chunk {chunk}")
    return bufs


def comp_routes(lay, b, k: int, chunk: int, tol: float, ztol: float) -> None:
    """K6's instances of K2, K4 and K5 (chunks of ``chunk``), each bitwise
    the compensated per-step launches at k steps."""
    k2_routes(lay, b, k, tol, ztol, compensated=True)
    k4_routes(lay, b, k, tol, ztol, compensated=True)
    k5_routes(lay, b, k, chunk, tol, ztol, compensated=True)


def fused_big_phase(card, dev, big) -> None:
    """Phase 7b: the fused two-pass solver on the 5M-arc instance, whose
    layout (100 MB) and (n,) vectors leave the L2. At k = K_CHECK, K2, K4
    (with its basis) and K5 (chunks of 7) bitwise the per-step launches they
    replaced and K3 bitwise the plain pass two on K1's matvec; K6's
    instances of K2, K4 and K5 bitwise the compensated per-step launches at
    k = K_CHECK (chunks of 7) and K (chunks of CHUNK); at k = K, the solve
    through K2 and K3 only, their times and K6's per pass and per step, the
    phase split, and the median of 3 solves."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch import FusedKKTSolver, padded_f_e1
    from two_pass_lanczos_tpu_torch.algorithms.core import pass_two_scan
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        kkt_matvec_cuda,
        pass_one_cuda,
        pass_two_cuda,
        reset_launches,
    )
    s = FusedKKTSolver(big.quad_costs, big.arc_u, big.arc_v, big.num_nodes,
                       device=dev)
    lay, n = s.layout, s.n
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(dev)

    def y_of(dec):
        keep = torch.arange(dec.k_max, device=dev) < dec.steps_taken
        return torch.where(keep, padded_f_e1(dec, "inv") * dec.b_norm, 0.0)

    st, st_ref = torch.empty(2, n, device=dev), torch.empty(2, n, device=dev)
    dec = k2_routes(lay, b, K_CHECK, s.tol, s.ztol)
    y = y_of(dec)
    x3 = pass_two_cuda(lay, b, dec, y, s.ztol, state=st)
    x3_ref, _ = pass_two_scan(lambda z: kkt_matvec_cuda(lay, z), b, dec, y,
                              state=st_ref)
    torch.cuda.synchronize()
    check(torch.equal(x3, x3_ref) and torch.equal(st, st_ref),
          f"5M: K3 differs from pass two on K1's matvec at k={K_CHECK}")
    k4_routes(lay, b, K_CHECK, s.tol, s.ztol)
    k5_routes(lay, b, K_CHECK, 7, s.tol, s.ztol)
    comp_routes(lay, b, K_CHECK, 7, s.tol, s.ztol)
    comp_routes(lay, b, K, CHUNK, s.tol, s.ztol)
    torch.cuda.empty_cache()
    reset_launches()
    x, dec = s.solve(b, k=K, f="inv", raw=True)
    torch.cuda.synchronize()
    got = {name: c for name, c in LAUNCHES.items() if c}
    check(got == {"lanczos_pass_one": 1, "lanczos_pass_two": 1,
                  "kkt_matvec_in_pass": 2 * K - 1}, f"5M launches {got}")
    check(bool(torch.isfinite(x).all()), "5M x is not finite")
    steps = dec.steps()
    y = y_of(dec)
    k2 = event_ms(lambda: pass_one_cuda(lay, b, K, s.tol, s.ztol), 3)
    k3 = event_ms(lambda: pass_two_cuda(lay, b, dec, y, s.ztol), 3)
    k6 = event_ms(lambda: pass_one_cuda(lay, b, K, s.tol, s.ztol,
                                        compensated=True), 3)
    t = wall_s(lambda: s.solve(b, k=K, f="inv", raw=True), 3)
    print(f"[7b] 5M fused solver on {card}: m={lay.m} p={lay.p}: K2, K4 (its "
          f"basis rows too) and K5 (chunks of 7) bitwise the per-step "
          f"launches and K3 bitwise pass two on K1's matvec at k={K_CHECK}; "
          f"K6's K2, K4 (rows too) and K5 (chunks of 7 and {CHUNK}) "
          f"instances bitwise the compensated per-step launches at "
          f"k={K_CHECK} and {K}; solve(k={K}) launches {got}, steps {steps}")
    print(f"    solve k={K}: {runs(t)}")
    print(f"    K2 {k2:.4f} ms a pass, {1e3 * k2 / K:.3f} us a step; K3 "
          f"{k3:.4f} ms a pass, {1e3 * k3 / max(steps - 1, 1):.3f} us a "
          f"step; K6 (K2's instance) {k6:.4f} ms a pass, "
          f"{1e3 * k6 / K:.3f} us a step")
    timed_split(lay, b, s, dec, y, pass_two_cuda(lay, b, dec, y, s.ztol))


def walk_cases():
    """The node walk's edge cases of the CPU tests (``tests/torch_cases.py``
    ``NODE_WALK_CASES``), made from the same seed: ``(name, d, u, v, p)``
    of a hub past 4·256 entries, of loops (u == v: a node's + and - entry
    of one arc) and of degree-0 nodes."""
    import numpy as np

    def random_kkt(rng, m, p):
        u = rng.integers(0, p, m).astype(np.int32)
        v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
        return rng.uniform(1.0, 3.0, m).astype(np.float32), u, v, p

    rng = np.random.default_rng(42)
    m, p = 1500, 100
    u = np.where(rng.random(m) < 0.8, 0, rng.integers(0, p, m)).astype(
        np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    hub = ("wide_hub", rng.uniform(0.5, 4.0, m).astype(np.float32), u, v, p)
    d, u, v, p = random_kkt(np.random.default_rng(42), 700, 300)
    v[::7] = u[::7]
    loops = ("self_loop", d, u, v, p)
    rng = np.random.default_rng(42)
    m, p = 50, 40
    u = rng.integers(0, 10, m).astype(np.int32)  # only nodes 0..9 as tails
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    zero = ("degree_zero", rng.uniform(1.0, 2.0, m).astype(np.float32), u, v,
            p)
    return [hub, loops, zero]


def warp_rows_phase(card, dev, sizes) -> dict:
    """Phase 7c: K1, K8 (f32 and f64) and K7 (e = 1, the solver's and
    ``sol_bench``'s, and e = 0.3) bitwise their block-row reference entry
    points (the kernel with one block a node row that their warp rows
    replaced) on each ``(label, instance)`` of ``sizes`` and on the walk's
    edge cases; on ``sizes``, each kernel and its reference timed as device
    time in turns (kernel, reference, reference, kernel). Returns
    ``{label: {kernel: {"ms": t, "blockrows_ms": t}}}``."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        KKTLayout,
        kkt_matvec_blockrows_cuda,
        kkt_matvec_cuda,
        kkt_shard_matvec_blockrows_cuda,
        kkt_shard_matvec_cuda,
    )
    from two_pass_lanczos_tpu_torch.ops.spmv_kernel import (
        kkt_operator_matvec_cuda,
    )
    pairs = {
        "K1": (kkt_matvec_cuda, kkt_matvec_blockrows_cuda, np.float32),
        "K8 f32": (kkt_operator_matvec_cuda, kkt_matvec_blockrows_cuda,
                   np.float32),
        "K8 f64": (kkt_operator_matvec_cuda, kkt_matvec_blockrows_cuda,
                   np.float64),
        "K7": (kkt_shard_matvec_cuda, kkt_shard_matvec_blockrows_cuda,
               np.float32),
        "K7 e=0.3": (lambda lay, x: kkt_shard_matvec_cuda(lay, x, 0.3),
                     lambda lay, x: kkt_shard_matvec_blockrows_cuda(
                         lay, x, 0.3), np.float32)}
    timed = ("K1", "K8 f64", "K7")
    cases = [(label, inst.quad_costs, inst.arc_u, inst.arc_v,
              inst.num_nodes) for label, inst in sizes] + walk_cases()
    out = {}
    for label, d, u, v, p in cases:
        rng = np.random.default_rng(3)
        x = rng.standard_normal(len(d) + p)
        lays = {dt: KKTLayout.build(d, u, v, p, dev, dtype=dt)
                for dt in (np.float32, np.float64)}
        for name, (run, ref, dt) in pairs.items():
            lay = lays[dt]
            xd = torch.from_numpy(x.astype(dt)).to(dev)
            y, y_ref = run(lay, xd), ref(lay, xd)
            torch.cuda.synchronize()
            bits = torch.int64 if dt == np.float64 else torch.int32
            check(torch.equal(y.view(bits), y_ref.view(bits)),
                  f"{label}: {name}'s warp rows differ from its block rows")
            if label in dict(sizes) and name in timed:
                got = {"ms": [], "blockrows_ms": []}
                for key in ("ms", "blockrows_ms", "blockrows_ms", "ms"):
                    fn = run if key == "ms" else ref
                    got[key].append(device_ms(lambda: fn(lay, xd), 200))
                out.setdefault(label, {})[name] = {
                    key: statistics.mean(t) for key, t in got.items()}
        del lays
        torch.cuda.empty_cache()
    print(f"[7c] warp rows on {card}: K1, K8 (f32, f64) and K7 (e = 1, 0.3) "
          f"bitwise their block-row references on "
          + ", ".join(c[0] for c in cases))
    for label, got in out.items():
        print(f"    {label}: " + "; ".join(
            f"{name} {t['ms']:.5f} ms (block rows {t['blockrows_ms']:.5f})"
            for name, t in got.items()) + " (device time, in turns)")
    return out


def wall_s(fn, reps: int) -> list:
    """Host seconds of each of ``reps`` calls, each ending in a sync."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def node_bound(lay, x, eps):
    """2·deg·eps·Σ|x_a| per node: two summation orders of one node sum."""
    import torch
    m = lay.m
    absum = torch.zeros(lay.p, dtype=x.dtype, device=x.device)
    absum.index_add_(0, lay.u, x[:m].abs()).index_add_(0, lay.v, x[:m].abs())
    return 2 * (lay.ptr[1:] - lay.ptr[:-1]).to(x.dtype) * eps * absum


def df_node_bound(lay, x2):
    """8·(deg+1)·2⁻⁴⁸·Σ|x_a| (f64) per node: two compensated folds of one
    node sum (each df_add2 errs by <= 3·2⁻⁴⁸·(|a| + |b|))."""
    import torch
    m = lay.m
    xa = (x2[0, :m].double() + x2[1, :m].double()).abs()
    absum = torch.zeros(lay.p, dtype=torch.float64, device=x2.device)
    absum.index_add_(0, lay.u, xa).index_add_(0, lay.v, xa)
    return 8 * ((lay.ptr[1:] - lay.ptr[:-1]).double() + 1) * 2.0 ** -48 * absum


def shard_slices(m: int, n_shards: int):
    """The JAX package's contiguous arc split, as slices."""
    import numpy as np
    return [slice(int(ix[0]), int(ix[-1]) + 1)
            for ix in np.array_split(np.arange(m), n_shards)]


def runs(ts) -> str:
    return (f"median {statistics.median(ts):.4f} s "
            f"(runs {', '.join(f'{t:.4f}' for t in ts)})")


def sharded_f32_phase(card, dev, mesh, sizes) -> dict:
    """Phase 17: K7 against K1 and its plain version, and the f32 sharded
    main path on ``mesh``, for each ``(label, instance)`` of ``sizes``.
    Returns per label K7's launches, error, times and bound."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_last_vector
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        KKTLayout,
        kkt_matvec_cuda,
        kkt_shard_matvec,
        kkt_shard_matvec_cuda,
        pass_one_cuda,
        scaled_y,
    )
    from two_pass_lanczos_tpu_torch.parallel import (
        ShardedFusedKKTSolver,
        fused_sharded,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    eps = torch.finfo(torch.float32).eps
    out = {}
    for label, ins in sizes:
        m, p = ins.num_arcs, ins.num_nodes
        n = m + p
        rng = np.random.default_rng(17)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        whole = KKTLayout.build(ins.quad_costs, ins.arc_u, ins.arc_v, p, dev)
        y1 = kkt_matvec_cuda(whole, x)
        y7 = kkt_shard_matvec_cuda(whole, x)
        bound = node_bound(whole, x, eps)
        check(torch.equal(y7, y1), f"{label}: one-shard K7 is not bitwise K1")
        fold = None
        for sl in shard_slices(m, 4):
            lay = KKTLayout.build(ins.quad_costs[sl], ins.arc_u[sl],
                                  ins.arc_v[sl], p, dev)
            yl = kkt_shard_matvec_cuda(lay, torch.cat([x[sl], x[m:]]))
            check(torch.equal(yl[:lay.m], y1[sl]),
                  f"{label}: K7 shard arc part is not K1's slice")
            fold = yl[lay.m:] if fold is None else fold + yl[lay.m:]
            del lay, yl
        check(bool(((fold - y1[m:]).abs() <= bound).all()),
              f"{label}: four K7 partials fold outside 2·deg·eps·Σ|x|")
        # the plain version on the card is a reference (index_add_), never
        # the solver's path there
        y_pl = kkt_shard_matvec(whole, x)
        torch.cuda.synchronize()
        check(torch.equal(y_pl[:m], y7[:m])
              and bool(((y_pl[m:] - y7[m:]).abs() <= bound).all()),
              f"{label}: K7 differs from its plain version")
        err = float((y7 - y_pl).abs().max())
        arrays = KKTArrays(quad_costs=ins.quad_costs, arc_u=ins.arc_u,
                           arc_v=ins.arc_v, num_nodes=p, num_arcs=m)
        coo = kkt_sorted_coo(arrays, dtype=np.float32, device=dev)
        a_csr = torch.sparse_csr_tensor(coo.indptr, coo.cols, coo.vals,
                                        size=(n, n))
        del coo
        rel_lib = float(torch.linalg.norm(torch.mv(a_csr, x) - y7)
                        / torch.linalg.norm(y7))
        check(rel_lib < 1e-6, f"{label}: cuSPARSE rel {rel_lib:.3e} vs K7")
        ms = device_ms(lambda: kkt_shard_matvec_cuda(whole, x), 200)
        plain_ms = device_ms(lambda: kkt_shard_matvec(whole, x), 200)
        lib_ms = device_ms(lambda: torch.mv(a_csr, x), 200)
        del a_csr

        # the main path, through K7 only
        solver = ShardedFusedKKTSolver(ins.quad_costs, ins.arc_u, ins.arc_v,
                                       p, mesh)
        plain_calls = []
        plain_orig = fused_sharded.kkt_shard_matvec

        def counted(*args, **kw):
            plain_calls.append(1)
            return plain_orig(*args, **kw)

        fused_sharded.kkt_shard_matvec = counted
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_main, dec_main = solver.solve(b, k=K, f="inv")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        rows = row_counts()
        fused_sharded.kkt_shard_matvec = plain_orig
        check(launches["kkt_streaming_matvec"] == 2 * K - 1
              and sum(launches.values()) == 2 * K - 1 and not plain_calls,
              f"{label}: sharded launches {launches}, plain calls "
              f"{len(plain_calls)}")
        check(rows == {**fused_pass_one(K), "kkt_shard_matvec_step_two":
                       K - 1, "shard_step_two_nodes": K - 1},
              f"{label}: the fused step's launches {rows}")
        check(x_main.shape == (n,) and bool(np.isfinite(x_main).all()),
              f"{label}: sharded x not a finite (n,) array")
        bl = solver.pack(b)
        st1 = torch.empty(2, solver.n_local, device=dev)
        st2 = torch.empty(2, solver.n_local, device=dev)
        dec1 = solver.pass_one(bl, K, state=st1)
        solver.pass_two(bl, dec1, scaled_y(dec1, "inv", K), state=st2)
        torch.cuda.synchronize()
        steps = dec1.steps()
        check(torch.equal(dec1.alphas, dec_main.alphas)
              and torch.equal(dec1.betas, dec_main.betas),
              f"{label}: sharded pass one not bitwise reproducible")
        check(torch.equal(pass_one_last_vector(dec1, st1), st2[1]),
              f"{label}: sharded pass two's v_{steps} differs from pass one's")
        d20 = solver.pass_one(bl, K_CHECK)
        k2 = pass_one_cuda(whole, b, K_CHECK, solver.tol, solver.ztol)
        np.testing.assert_allclose(d20.alphas.cpu().numpy(),
                                   k2.alphas.cpu().numpy(), rtol=2e-4)
        np.testing.assert_allclose(d20.betas.cpu().numpy(),
                                   k2.betas.cpu().numpy(), rtol=2e-4)
        rel20 = float(((d20.alphas - k2.alphas).abs()
                       / k2.alphas.abs()).max())
        print(f"[17] {label} (m={m}, p={p}, n={n}): K7 one shard bitwise K1"
              f", four shards' arc parts bitwise and partials within bound, "
              f"vs plain max_abs_err {err:.3e}; cuSPARSE rel {rel_lib:.3e}; "
              f"sharded solve(k={K}) on a one-rank "
              f"{torch.distributed.get_backend(mesh.group)} group first call "
              f"{first_s:.4f} s, steps {steps}, launches {rows}, plain "
              f"calls {len(plain_calls)}; pass two's v_{steps} bitwise pass "
              f"one's; alpha, beta at k={K_CHECK} vs K2 max rel {rel20:.3e}")
        t_solve = wall_s(lambda: solver.solve(b, k=K, f="inv", raw=True),
                         5 if label == "headline" else 3)
        print(f"     on {card}: K7 {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"cuSPARSE CSR SpMV {lib_ms:.5f} ms, bound "
              f"{roofline_ms(20 * m + 8 * p, 5 * m)[0]:.5f} ms; sharded "
              f"two-pass solve k={K}: {runs(t_solve)}")
        if label == "headline":
            t_one = wall_s(lambda: solver.solve(
                b, k=K, f="inv", method="one_pass", raw=True), 5)
            t_cb = wall_s(lambda: solver.solve(
                b, k=K, f="inv", raw=True, callback=lambda *a: True,
                callback_chunk=CHUNK), 5)
            print(f"     sharded one-pass solve k={K}: {runs(t_one)}; "
                  f"callback (never stops, chunk {CHUNK}): {runs(t_cb)}")
        out[label] = {"launches": rows.get("kkt_streaming_matvec", 0),
                      "step_launches": rows,
                      "err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound": roofline_ms(20 * m + 8 * p, 5 * m)}
        del solver, whole, bl, st1, st2
    return out


#: the arc-sharded solver's fused step: K7's two step instances, then
#: ``csrc/shard_step.cu``'s five kernels (each a row of the kernels line)
STEP_ROWS = ("kkt_shard_matvec_step_one", "kkt_shard_matvec_step_two",
             "shard_step_node_fold", "shard_step_orthogonalise",
             "shard_step_norm", "shard_step_advance", "shard_step_two_nodes")
#: the ranks of the fused step's phase: the 4-card cell's shard
STEP_RANKS = 4


def step_bounds(m: int, p: int, ranks: int, nf: int) -> dict:
    """``(bound ms, what binds)`` of each fused-step kernel's function, a
    launch over a shard of m arcs and p nodes gathered from ``ranks`` cards,
    nf rows of y: each input read once and each output written once (f32
    values, int32 indices; the (ranks, 16) share buffers and the state
    slots counted, the 0-d scalars not), and f32 operations (a matvec's 5
    an arc, as K7's bound counts it, 2 a dot or a scaled add's term)."""
    n = m + p
    parts, quads = -(-m // 256), -(-m // 1024)
    shares = 4 * 16 * (ranks + 1)  # a gathered arc group and a node group
    return {
        # K7's 20 B an arc less y_a, with v_prev_a read and w_a written;
        # the node partial and the block partials written
        "kkt_shard_matvec_step_one": roofline_ms(
            24 * m + 8 * p + 4 * parts, 9 * m),
        # ... with v_prev_a read, v_next_a written and x_a read and written
        # for each row of y
        "kkt_shard_matvec_step_two": roofline_ms(
            24 * m + 8 * m * nf + 8 * p, (10 + 2 * nf) * m),
        # g, v_prev_n, v_n and K7's partials read; w_n and two groups written
        "shard_step_node_fold": roofline_ms(
            4 * ranks * p + 12 * p + 4 * parts + 2 * 64,
            (ranks + 3) * p + parts),
        # w and v read, w written, the block partials written
        "shard_step_orthogonalise": roofline_ms(
            12 * n + 4 * quads + shares, 4 * n),
        "shard_step_norm": roofline_ms(4 * p + 4 * quads + 2 * 64,
                                       2 * p + quads),
        # w read and written (an advancing step, no basis row)
        "shard_step_advance": roofline_ms(8 * n + shares, n),
        "shard_step_two_nodes": roofline_ms(
            4 * ranks * p + 12 * p + 8 * p * nf,
            (ranks + 4) * p + 2 * p * nf),
    }


def shard_step_phase(card, dev, big, timed: bool = True) -> dict:
    """Phase 17b: each kernel of the arc-sharded solver's fused step on
    rank 0's shard of the 5M-arc instance split over ``STEP_RANKS`` cards
    (the 4-card cell's shard, ~1.25M arcs and p), against its plain version
    (``sharded_step.PlainStepKernels``) on copies of the same inputs. The
    gathered share groups and node shares are multiples of 1/64, whose sums
    are exact in any order, so every vector and 0-d output is held bitwise;
    the block partials and dot shares, which sum in another order, within
    64·eps·Σ|term|, and K7's node partial within 2·deg·eps·Σ|x| (phase 17's
    bound). ``advance`` is driven advancing with a basis row and not
    executing; ``two_matvec`` and ``two_nodes`` active with nf = 1 and 2 and
    inactive. Then timed: ``ms`` a launch cold-L2 and ``warm_ms``, 50
    launches in one CUDA graph (``probes.bench.Timer``), as are
    ``library_ms``, the PyTorch operations of the core scans that computed
    the same function (cuSPARSE's CSR SpMV of the shard for the matvecs);
    ``plain_ms`` the plain version's, which reads its flags on the host
    (CUDA events, warm). Returns each kernel's row values."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import KKTLayout
    from two_pass_lanczos_tpu_torch.parallel.sharded_step import (
        CudaStepKernels,
        PlainStepKernels,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    f32, eps = torch.float32, torch.finfo(torch.float32).eps
    ranks = STEP_RANKS
    sl = shard_slices(big.num_arcs, ranks)[0]
    p = big.num_nodes
    lay = KKTLayout.build(big.quad_costs[sl], big.arc_u[sl], big.arc_v[sl],
                          p, dev)
    m, n = lay.m, lay.n
    parts, quads = -(-m // 256), -(-m // 1024)
    gen = torch.Generator().manual_seed(29)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def dyadic(*shape, low=-64):
        return (torch.randint(low, 65, shape, generator=gen).to(f32)
                / 64).to(dev)

    def slot(beta_prev, done, steps, b_norm=1.5):
        t = torch.tensor([beta_prev, 0.0, 0.0, b_norm], dtype=f32)
        t = t.view(torch.int32)
        t[1], t[2] = done, steps
        return t.to(dev)

    card_k, plain_k = (PlainStepKernels(), PlainStepKernels()) \
        if dev.type != "cuda" else (CudaStepKernels(), PlainStepKernels())
    errs, notes = {}, []

    def both(name, launch, bufs):
        """``launch(kernels, bufs)`` on copies for the card's kernels and
        the plain ones: (the card's buffers, the plain ones)."""
        got = {key: t.clone() for key, t in bufs.items()}
        want = {key: t.clone() for key, t in bufs.items()}
        launch(card_k, got)
        launch(plain_k, want)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return got, want

    def same(name, got, want, keys):
        for key in keys:
            check(torch.equal(got[key], want[key]),
                  f"{name}: {key} is not its plain version's bits (max "
                  f"diff {float((got[key] - want[key]).abs().max()):.3e})")
        errs.setdefault(name, 0.0)

    def near(name, what, got, want, scale):
        gap = (got.double() - want.double()).abs()
        bound = 64 * eps * scale.double()
        check(bool((gap <= bound).all()),
              f"{name}: {what} past 64·eps·Σ|term| of its plain version "
              f"(max gap {float(gap.max()):.3e})")
        errs[name] = max(errs.get(name, 0.0), float(gap.max()))
        share = float((gap / bound.clamp_min(1e-300)).max())
        notes.append(f"{name} {what} {share:.3f} of its bound")

    def blocks(t, size):
        pad = (-t.numel()) % size
        return torch.cat([t, t.new_zeros(pad)]).view(-1, size).sum(1)

    vp, v, w0 = normal(n), normal(n), normal(n)
    base = {"vp": vp, "v": v, "w": w0, "s": torch.zeros(p, device=dev),
            "partials": torch.zeros(parts, device=dev),
            "scal": dyadic(4, 16), "st": slot(0.75, 0, 3),
            "after": slot(0.0, 0, 0), "g_nodes": normal(ranks, p),
            "g_alpha": dyadic(ranks, 16), "g_beta2": dyadic(ranks, 16, low=1),
            "alpha": torch.zeros((), device=dev),
            "beta": torch.zeros((), device=dev),
            "basis": torch.zeros(n, device=dev)}
    k_limit = 500

    def one_matvec(kern, b):
        kern("one_matvec", lay, b["vp"], b["v"], b["w"], b["s"],
             b["partials"], b["st"])

    got, want = both("one_matvec", one_matvec, base)
    same("kkt_shard_matvec_step_one", got, want, ["w"])
    check(bool(((got["s"] - want["s"]).abs() <= node_bound(lay, v, eps))
               .all()), "step one's node partial past K7's bound")
    near("kkt_shard_matvec_step_one", "block partials", got["partials"],
         want["partials"], blocks((v[:m] * want["w"][:m]).abs(), 256))
    errs["kkt_shard_matvec_step_one"] = max(
        errs["kkt_shard_matvec_step_one"],
        float((got["s"] - want["s"]).abs().max()))
    w1 = want["w"]  # w_a from K7, w_n from node_fold below

    def node_fold(kern, b):
        kern("node_fold", b["g_nodes"], ranks, m, p, b["vp"], b["v"],
             b["w"], b["partials"], parts, b["st"], b["scal"])

    fold_in = dict(base, w=w1, partials=normal(parts))
    got, want = both("node_fold", node_fold, fold_in)
    same("shard_step_node_fold", got, want, ["w"])
    near("shard_step_node_fold", "alpha's arc part",
         got["scal"][0].double().sum(), want["scal"][0].double().sum(),
         fold_in["partials"].abs().double().sum())
    near("shard_step_node_fold", "<v_n, w_n>",
         got["scal"][1].double().sum(), want["scal"][1].double().sum(),
         (v[m:] * want["w"][m:]).abs().double().sum())

    def orthogonalise(kern, b):
        kern("orthogonalise", b["g_alpha"], ranks, m, p, b["v"], b["w"],
             b["partials"], b["st"], k_limit, b["alpha"], b["scal"])

    orth_in = dict(base, w=want["w"])
    got, want = both("orthogonalise", orthogonalise, orth_in)
    same("shard_step_orthogonalise", got, want, ["w", "alpha"])
    near("shard_step_orthogonalise", "block partials", got["partials"][:quads],
         want["partials"][:quads],
         blocks((want["w"][:m] * want["w"][:m]).abs(), 1024))
    w2 = want["w"]

    def norm(kern, b):
        kern("norm", m, p, b["w"], b["partials"], quads, b["scal"])

    norm_in = dict(base, w=w2, partials=normal(parts).abs())
    got, want = both("norm", norm, norm_in)
    near("shard_step_norm", "beta^2's arc part",
         got["scal"][2].double().sum(), want["scal"][2].double().sum(),
         norm_in["partials"][:quads].double().sum())
    near("shard_step_norm", "<w_n, w_n>", got["scal"][3].double().sum(),
         want["scal"][3].double().sum(),
         (w2[m:] * w2[m:]).double().sum())

    def advance(kern, b, limit=k_limit, basis=True):
        kern("advance", b["g_beta2"], ranks, m, p, b["vp"], b["v"], b["w"],
             b["basis"] if basis else None, b["st"], b["after"], limit,
             1e-6, b["beta"], b["scal"])

    adv_in = dict(base, w=w2, scal=dyadic(4, 16, low=1))
    everything = ["vp", "v", "w", "basis", "after", "beta"]
    got, want = both("advance", advance, adv_in)
    same("shard_step_advance", got, want, everything)
    check(float(want["beta"]) > 0 and int(want["after"][2]) == 4,
          "advance did not advance")
    got, want = both("advance", lambda kern, b: advance(kern, b, 3), adv_in)
    same("shard_step_advance", got, want, everything)
    check(float(want["beta"]) == 0 and torch.equal(want["w"], v),
          "a step past the limit moved on")

    k = 8
    two = {"vp": vp, "v": v, "vn": torch.zeros(n, device=dev),
           "s": torch.zeros(p, device=dev),
           "alphas": normal(k), "betas": normal(k).abs() + 0.5,
           "steps": torch.tensor(k, dtype=torch.int32, device=dev),
           "g_nodes": normal(ranks, p)}

    def two_matvec(kern, b, step):
        y = b["y"]
        kern("two_matvec", lay, b["vp"], b["v"], b["vn"], b["s"],
             b["alphas"], b["betas"], b["steps"], y, y.shape[0], k, step,
             b["x"])

    def two_nodes(kern, b, step):
        y = b["y"]
        kern("two_nodes", b["g_nodes"], ranks, m, p, b["vp"], b["v"],
             b["vn"], b["alphas"], b["betas"], b["steps"], y, y.shape[0], k,
             step, b["x"])

    for nf in (1, 2):
        two_in = dict(two, y=normal(nf, k), x=normal(nf, n))
        for step in (3, k - 1):  # active, then inactive
            got, want = both("two_matvec",
                             lambda kern, b: two_matvec(kern, b, step),
                             two_in)
            same("kkt_shard_matvec_step_two", got, want, ["vn", "x", "v"])
            check(bool(((got["s"] - want["s"]).abs()
                        <= node_bound(lay, v, eps)).all()),
                  "step two's node partial past K7's bound")
            errs["kkt_shard_matvec_step_two"] = max(
                errs["kkt_shard_matvec_step_two"],
                float((got["s"] - want["s"]).abs().max()))
            nodes_in = dict(two_in, vn=want["vn"], x=want["x"])
            got, want = both("two_nodes",
                             lambda kern, b: two_nodes(kern, b, step),
                             nodes_in)
            same("shard_step_two_nodes", got, want, ["vn", "x", "v"])
    print(f"[17b] the fused step's kernels on rank 0's shard of {ranks} "
          f"(m={m}, p={p}): every vector and 0-d output bitwise its plain "
          f"version's; " + "; ".join(notes))
    out = {name: {"err": errs[name]} for name in STEP_ROWS}
    if not timed:
        return out

    from two_pass_lanczos_tpu_torch.probes.bench import Timer

    timer = Timer(dev, reps=50)
    arrays = KKTArrays(quad_costs=big.quad_costs[sl], arc_u=big.arc_u[sl],
                       arc_v=big.arc_v[sl], num_nodes=p, num_arcs=m)
    coo = kkt_sorted_coo(arrays, dtype=np.float32, device=dev)
    a_csr = torch.sparse_csr_tensor(coo.indptr, coo.cols, coo.vals,
                                    size=(n, n))
    del coo
    b = dict(base, w=w2.clone(), partials=normal(parts).abs(),
             scal=dyadic(4, 16, low=1))
    t2 = dict(two, y=normal(1, k), x=normal(1, n))
    beta_t, alpha_t = torch.tensor(0.75, device=dev), torch.tensor(
        0.25, device=dev)
    inv_t = torch.tensor(0.5, device=dev)
    adv_t = torch.tensor(True, device=dev)

    def fold(g):
        acc = g[0]
        for r in range(1, ranks):
            acc = acc + g[r]
        return acc

    def lib_one():
        y = torch.mv(a_csr, b["v"])
        wa = y[:m] - beta_t * b["vp"][:m]
        torch.dot(b["v"][:m], wa)

    def lib_two():
        y = torch.mv(a_csr, t2["v"])
        vn = ((y[:m] - beta_t * t2["vp"][:m]) - alpha_t * t2["v"][:m]) * inv_t
        t2["x"][:, :m] += t2["y"][:, 4:5] * vn

    def lib_node_fold():
        wn = fold(b["g_nodes"]) - beta_t * b["vp"][m:]
        torch.dot(b["v"][m:], wn) + b["partials"].sum()

    def lib_orthogonalise():
        a = fold(b["g_alpha"]).sum() + b["scal"][1].sum()
        b["w"].sub_(a * b["v"])
        torch.dot(b["w"][:m], b["w"][:m])

    def lib_norm():
        torch.dot(b["w"][m:], b["w"][m:]) + b["partials"][:quads].sum()

    def lib_advance():
        beta = torch.sqrt(fold(b["g_beta2"]).sum() + b["scal"][3].sum())
        inv = torch.where(adv_t, 1.0 / beta, torch.zeros_like(beta))
        v_next = b["w"] * inv
        torch.where(adv_t, b["v"], b["vp"])
        torch.where(adv_t, v_next, b["v"])

    def lib_two_nodes():
        vn = ((fold(t2["g_nodes"]) - beta_t * t2["vp"][m:])
              - alpha_t * t2["v"][m:]) * inv_t
        t2["x"][:, m:] += t2["y"][:, 4:5] * vn

    runs = {
        "kkt_shard_matvec_step_one": (lambda kern: one_matvec(kern, b),
                                      lib_one),
        "kkt_shard_matvec_step_two": (lambda kern: two_matvec(kern, t2, 3),
                                      lib_two),
        "shard_step_node_fold": (lambda kern: node_fold(kern, b),
                                 lib_node_fold),
        "shard_step_orthogonalise": (lambda kern: orthogonalise(kern, b),
                                     lib_orthogonalise),
        "shard_step_norm": (lambda kern: norm(kern, b), lib_norm),
        "shard_step_advance": (lambda kern: advance(kern, b, basis=False),
                               lib_advance),
        "shard_step_two_nodes": (lambda kern: two_nodes(kern, t2, 3),
                                 lib_two_nodes),
    }
    bounds = step_bounds(m, p, ranks, 1)
    for name, (launch, lib) in runs.items():
        b["w"].copy_(w2)
        row = out[name]
        row["ms"] = timer.cold(lambda: launch(card_k)) / 1e3
        row["warm_ms"] = timer.warm(lambda: launch(card_k)) / 1e3
        row["plain_ms"] = event_ms(lambda: launch(plain_k), 10)
        row["library_ms"] = timer.cold(lib) / 1e3
        row["bound"] = bounds[name]
        print(f"     {name}: {row['ms']:.5f} ms cold-L2, {row['warm_ms']:.5f}"
              f" warm, plain {row['plain_ms']:.5f}, library (the scans' "
              f"operations) {row['library_ms']:.5f} ms cold, bound "
              f"{row['bound'][0]:.5f} ms ({row['bound'][1]}) on {card}")
    del a_csr, lay
    return out


def sharded_df_phase(card, dev, mesh, sizes) -> dict:
    """Phase 18: K12 against K11 and its plain version, and the df sharded
    main path on ``mesh``, for each ``(label, instance, operator or
    None)`` of ``sizes`` (an operator with its plain tables is compared
    with its plain version). Returns per label K12's numbers."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, DFKKTOperator
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.observability import df_kkt_matvec_bytes
    from two_pass_lanczos_tpu_torch.ops.df import DF, df_add, df_from_f64
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_kkt_matvec_cuda,
        df_kkt_matvec_pairs_cuda,
        df_kkt_shard_matvec_cuda,
        df_pass_one_last_vector,
    )
    from two_pass_lanczos_tpu_torch.parallel import DFShardedFusedKKTSolver
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    out = {}
    for label, ins, op in sizes:
        m, p = ins.num_arcs, ins.num_nodes
        n = m + p
        rng = np.random.default_rng(18)
        x64 = torch.from_numpy(rng.standard_normal(n)).to(dev)
        xdf = df_from_f64(x64 * (1.0 + 1e-9 * x64))  # a lo plane that is not 0
        x2 = torch.stack([xdf.hi, xdf.lo])
        b64 = torch.from_numpy(rng.standard_normal(n)).to(dev)
        whole = op or DFKKTOperator(ins.quad_costs, ins.arc_u, ins.arc_v, p,
                                    device=dev)
        lay = whole.layout
        xp = x2.T.contiguous()  # K12 takes (hi, lo) pairs
        y11 = df_kkt_matvec_cuda(lay, whole.d2, x2)
        y11p = df_kkt_matvec_pairs_cuda(lay, whole.d2, xp)
        y12 = df_kkt_shard_matvec_cuda(lay, whole.d2, xp)
        bound = df_node_bound(lay, x2)
        check(torch.equal(y12, y11p) and torch.equal(y12.T, y11),
              f"{label}: one-shard K12 is not bitwise both K11 instances")
        acc = None
        for sl in shard_slices(m, 4):
            sop = DFKKTOperator(ins.quad_costs[sl], ins.arc_u[sl],
                                ins.arc_v[sl], p, device=dev)
            yl = df_kkt_shard_matvec_cuda(sop.layout, sop.d2,
                                          torch.cat([xp[sl], xp[m:]]))
            ms_ = sop.layout.m
            check(torch.equal(yl[:ms_], y11p[sl]),
                  f"{label}: K12 shard arc part is not K11's slice")
            part = DF(yl[ms_:, 0], yl[ms_:, 1])
            acc = part if acc is None else df_add(acc, part)
            del sop, yl
        folded = acc.hi.double() + acc.lo.double()
        want = y11[0, m:].double() + y11[1, m:].double()
        check(bool(((folded - want).abs() <= bound).all()),
              f"{label}: four K12 partials fold outside "
              "8·(deg+1)·2^-48·Σ|x|")
        err, plain_ms = None, None
        if op is not None:
            y_pl = op.plain_matvec_df(xdf)
            torch.cuda.synchronize()
            check(torch.equal(y12[:m, 0], y_pl.hi[:m])
                  and torch.equal(y12[:m, 1], y_pl.lo[:m]),
                  f"{label}: K12 arc part differs from its plain version")
            y12_64 = y12[:, 0].double() + y12[:, 1].double()
            pl_64 = y_pl.hi.double() + y_pl.lo.double()
            check(bool(((y12_64[m:] - pl_64[m:]).abs() <= bound).all()),
                  f"{label}: K12 node part outside the bound of its plain "
                  "version")
            err = float((y12_64 - pl_64).abs().max())
            plain_ms = device_ms(lambda: op.plain_matvec_df(xdf), 20)
        arrays = KKTArrays(quad_costs=ins.quad_costs, arc_u=ins.arc_u,
                           arc_v=ins.arc_v, num_nodes=p, num_arcs=m)
        coo = kkt_sorted_coo(arrays, device=dev)
        a_csr = torch.sparse_csr_tensor(coo.indptr, coo.cols, coo.vals,
                                        size=(n, n))
        del coo
        x_sp = x2[0].double() + x2[1].double()
        y64 = y12[:, 0].double() + y12[:, 1].double()
        rel_lib = float(torch.linalg.norm(torch.mv(a_csr, x_sp) - y64)
                        / torch.linalg.norm(y64))
        check(rel_lib < 1e-13, f"{label}: cuSPARSE f64 rel {rel_lib:.3e}")
        ms = device_ms(lambda: df_kkt_shard_matvec_cuda(lay, whole.d2, xp),
                       200)
        lib_ms = device_ms(lambda: torch.mv(a_csr, x_sp), 200)
        del a_csr

        # the df main path, through K12 only
        s = DFShardedFusedKKTSolver(ins.quad_costs, ins.arc_u, ins.arc_v, p,
                                    mesh)
        plain_df = []
        plain_orig = DFKKTOperator.plain_matvec_df

        def counted(*args, **kw):
            plain_df.append(1)
            return plain_orig(*args, **kw)

        DFKKTOperator.plain_matvec_df = counted
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_df, (al, _, steps) = s.solve(b64, k=K, f="inv")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        DFKKTOperator.plain_matvec_df = plain_orig
        check(launches["df_kkt_streaming_matvec"] == 2 * K - 1
              and sum(launches.values()) == 2 * K - 1 and not plain_df,
              f"{label}: df sharded launches {launches}, plain df calls "
              f"{len(plain_df)}")
        check(x_df.shape == (n,) and x_df.dtype == np.float64
              and bool(np.isfinite(x_df).all()),
              f"{label}: df sharded x not a finite f64 (n,) array")
        b2 = s.pack(b64)
        st1 = torch.empty(2, 2, s.n_local, device=dev)
        st2 = torch.empty(2, 2, s.n_local, device=dev)
        coeffs = s.pass_one(b2, K, state=st1)
        zero = torch.zeros(K, device=dev)
        s.pass_two(b2, coeffs, zero, zero, state=st2)
        torch.cuda.synchronize()
        a_rep = (coeffs[0].double() + coeffs[1].double()).cpu().numpy()
        check(int(coeffs[5][0]) == steps and np.array_equal(a_rep[:steps], al),
              f"{label}: df sharded pass one not bitwise reproducible")
        check(torch.equal(df_pass_one_last_vector(coeffs, st1), st2[1]),
              f"{label}: df sharded pass two's v_{steps} differs from pass "
              "one's (hi or lo)")
        c20 = s.pass_one(b2, K_CHECK)
        r20 = DFFusedKKTSolver(ins.quad_costs, ins.arc_u, ins.arc_v, p,
                               device=dev).pass_one(b64, K_CHECK)

        def f64(c, i):
            return (c[i].double() + c[i + 1].double()).cpu().numpy()

        atol = 1e-11 * float(np.abs(f64(r20, 0)).max())
        da = float(np.abs(f64(c20, 0) - f64(r20, 0)).max())
        db = float(np.abs(f64(c20, 2)[:K_CHECK - 1]
                          - f64(r20, 2)[:K_CHECK - 1]).max())
        check(int(c20[5][0]) == int(r20[5][0]) == K_CHECK
              and max(da, db) <= atol,
              f"{label}: df sharded alpha/beta at k={K_CHECK} {da:.3e}/"
              f"{db:.3e} from K9, above 1e-11·max|alpha| = {atol:.3e}")
        print(f"[18] {label} (m={m}, p={p}): K12 one shard bitwise both K11 "
              f"instances in hi and lo, four shards' arc parts bitwise and df "
              f"partials within"
              f" bound" + (f", vs plain max_abs_err {err:.3e}" if op else "")
              + f"; cuSPARSE f64 rel {rel_lib:.3e}; df sharded solve(k={K}) "
              f"first call {first_s:.4f} s, steps {steps}, launches "
              f"{launches}, plain df calls {len(plain_df)}; hi and lo "
              f"v_{steps} bitwise across passes; alpha, beta at k={K_CHECK} "
              f"vs K9 {da:.3e} / {db:.3e} <= {atol:.3e}")
        t_df = wall_s(lambda: s.solve(b64, k=K, f="inv"), 3)
        bnd = roofline_ms(df_kkt_matvec_bytes(m, p), 50 * m)
        print(f"     on {card}: K12 {ms:.5f} ms"
              + (f", plain {plain_ms:.5f} ms" if op else "")
              + f", cuSPARSE f64 CSR SpMV {lib_ms:.5f} ms, bound "
              f"{bnd[0]:.5f} ms; df sharded two-pass solve k={K}: "
              f"{runs(t_df)}")
        out[label] = {"launches": launches["df_kkt_streaming_matvec"],
                      "err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound": bnd}
        del s, whole, b2, st1, st2
    return out


def _pct(share: float) -> str:
    return f"{100 * share:.1f} %"


def probes_phase(card, dev, sizes) -> tuple:
    """Phase 19: the K14 probes' main path, ``probes.run`` of every probe on
    each ``(label, instance)`` of ``sizes``, with the counters reset just
    before it. Each run checks its variants against their plain versions
    (``probe_stages`` full and ``probe_pipeline`` full bitwise K7, every
    ``probe_pipeline`` mode, store and ring shape bitwise its
    ``probe_stages`` twin, every gather bitwise ``tab[idx]``,
    ``probe_stream`` bitwise its plain version) and raises on a failure. Prints a summary, K7's stage split and K14d's
    split (``probes.pipeline_split``), writes every record to
    ``chiprun_out/probes.json`` and returns, per kernel, the cold-L2
    numbers of its ``PROBE_MAIN`` variant at the first size, and its plain
    version's, timed cold alike; and the ms of a K13 launch, of an empty
    launch and of one of each, each by the same timer's CUDA graph."""
    import numpy as np
    import torch
    from two_pass_lanczos_tpu_torch import probes
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        KKTLayout,
        eft_check_cuda,
        empty_launch_cuda,
        kkt_shard_matvec,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.probes.gather import gather_plain
    from two_pass_lanczos_tpu_torch.probes.stream import stream_plain
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    inputs = {}
    for label, ins in sizes:
        m, p = ins.num_arcs, ins.num_nodes
        lay = KKTLayout.build(ins.quad_costs, ins.arc_u, ins.arc_v, p, dev)
        x = torch.from_numpy(np.random.default_rng(19).standard_normal(
            m + p).astype(np.float32)).to(dev)
        coo = kkt_sorted_coo(KKTArrays(
            quad_costs=ins.quad_costs, arc_u=ins.arc_u, arc_v=ins.arc_v,
            num_nodes=p, num_arcs=m), dtype=np.float32, device=dev)
        a_csr = torch.sparse_csr_tensor(coo.indptr, coo.cols, coo.vals,
                                        size=(m + p, m + p))
        inputs[label] = (lay, x, a_csr)
        del coo

    # the main path: the probes' own entry point, every probe at each size
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = {label: {name: probes.run(name, lay, x, a_csr=a_csr)
                    for name in probes.RUNS}
            for label, (lay, x, a_csr) in inputs.items()}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(all(launches[name] > 0 for name in PROBE_MAIN),
          f"probe launches {launches}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "probes.json").write_text(json.dumps(
        {"card": card, "records": recs}, indent=1))
    # the stage probe's checks run inside probes.run (it raises on a
    # failure); the cluster tier must have gathered, bitwise, at least x_n
    for label, by in recs.items():
        ran = {r["variant"] for r in by["gather"] if "not_run" not in r}
        check("arc_u/cluster/int32" in ran,
              f"{label}: the cluster tier did not run on x_n")
        check({"full", "node_sorted", "k7"} <= {
            r["variant"] for r in by["stages"]}, f"{label}: stage records")
    print(f"[19] K14 probes at {', '.join(inputs)} in {run_s:.1f} s: every "
          f"variant checked (stages full and pipeline full bitwise K7, "
          f"every pipeline mode and store bitwise its K14c twin, "
          f"node_sorted's y_n bitwise K7's, gathers of every tier bitwise "
          f"tab[idx], stream bitwise its plain version); launches "
          f"{ {k: launches[k] for k in PROBE_MAIN} }; records in "
          f"chiprun_out/probes.json")

    def line(r):
        if "not_run" in r:
            return f"{r['variant']}: not run: {r['not_run']}"
        lib = (f", index_select {r['library_us']:.3f} us"
               if "library_us" in r else "")
        shape = (f", clusters of {r['cluster']} x {r['slice_entries']} "
                 f"floats, {r['active_clusters']} resident"
                 if "cluster" in r else "")
        return (f"{r['variant']}: {r['us']:.3f} us ({_pct(r['share'])} of "
                f"bound, {r['gbps']:.0f} GB/s), cold {r['us_cold']:.3f} us "
                f"({_pct(r['share_cold'])}){lib}{shape}")

    for label, by in recs.items():
        lay = inputs[label][0]
        print(f"     {label} (m={lay.m}, p={lay.p}) on {card}:")
        for r in by["gather"]:
            if not r["variant"].startswith("sweep"):
                print("       gather " + line(r))
        sweep = {}
        for r in by["gather"]:
            if r["variant"].startswith("sweep"):
                size, mode, idx = r["variant"][5:].split("/")
                sweep.setdefault(size, []).append(
                    f"{mode}/{idx} not run" if "not_run" in r else
                    f"{mode}/{idx} {r['us']:.2f} (cold {r['us_cold']:.2f})")
        for size, cells in sweep.items():
            print(f"       gather sweep, table {size}: " + "; ".join(cells)
                  + " us")
        streams = sorted(by["stream"], key=lambda r: r["us"])
        shown = streams[:2] + [r for r in streams if r["variant"] in (
            "soa/256x1", "aos/256x1", "copy_d2d")] + streams[-1:]
        for r in {r["variant"]: r for r in shown}.values():
            print("       stream " + line(r))
        pipe = {r["variant"]: r for r in by["pipeline"]}
        for variant, r in pipe.items():
            if not variant.startswith("sweep/full/"):
                continue
            arc = pipe[variant.replace("/full/", "/arc_only/")]
            print(f"       pipeline {variant[11:]} ({r['blocks_per_sm']}/SM, "
                  f"{r['smem_bytes']} B): full {r['us']:.3f} us, cold "
                  f"{r['us_cold']:.3f}; arc_only {arc['us']:.3f}, cold "
                  f"{arc['us_cold']:.3f}")
        for variant, r in pipe.items():
            if not variant.startswith("sweep/"):
                print("       pipeline " + line(r))
        print("       K14d:")
        for row in probes.pipeline_split(by["pipeline"], lay.m,
                                         lay.p).splitlines():
            print("         " + row)
        stage = {r["variant"]: r for r in by["stages"]}
        print(f"       stages full {stage['full']['us']:.3f} us, cold "
              f"{stage['full']['us_cold']:.3f} us beside K7's "
              f"{stage['k7']['us']:.3f} us, cold "
              f"{stage['k7']['us_cold']:.3f} us in the same run")
        for r in by["gather"]:
            if "not_run" in r and r["variant"].startswith("sweep"):
                print(f"       gather {line(r)}")
        print("       K7 stage split:")
        for row in probes.stage_split(by["stages"]).splitlines():
            print("         " + row)

    # the kernels line: cold-L2 times, which the HBM bound holds (warm, the
    # headline's 10 MB come from the 50 MB L2)
    head, (lay, x, _) = next(iter(recs.values())), next(iter(inputs.values()))
    m = lay.m
    plain = {"probe_gather": lambda: gather_plain(x[m:], lay.u),
             "probe_stream": lambda: stream_plain(lay.d, lay.u, lay.v, x[:m]),
             "probe_stages": lambda: kkt_shard_matvec(lay, x),
             "probe_pipeline": lambda: kkt_shard_matvec(lay, x)}
    cusparse = next(r for r in head["stages"] if r["variant"] == "cusparse")
    timer = probes.Timer(dev)
    out = {}
    for name, (probe, variant) in PROBE_MAIN.items():
        r = next(r for r in head[probe] if r["variant"] == variant)
        lib = r.get("library_us_cold", None if probe == "stream"
                    else cusparse["us_cold"])
        out[name] = {"launches": launches[name], "err": r["max_abs_err"],
                     "ms": r["us_cold"] / 1e3,
                     "plain_ms": timer.cold(plain[name]) / 1e3,
                     "library_ms": None if lib is None else lib / 1e3}
    # K13 beside a launch of a kernel that does nothing, by the same timer:
    # each alone, and one of each a call in the same CUDA graph
    ea = torch.full((128,), 1.0 + 2.0 ** -12, device=dev)
    eb = torch.full((128,), 2.0 ** -30, device=dev)
    floor = {"eft_check": timer.warm(lambda: eft_check_cuda(ea, eb)) / 1e3,
             "empty": timer.warm(lambda: empty_launch_cuda(dev)) / 1e3,
             "both": timer.warm(lambda: (eft_check_cuda(ea, eb),
                                         empty_launch_cuda(dev))) / 1e3}
    print(f"     K13 {floor['eft_check']:.6f} ms a launch, an empty launch "
          f"{floor['empty']:.6f} ms, one of each in one graph "
          f"{floor['both']:.6f} ms ({card})")
    return out, floor


#: the capability phase (21): SLQ probes and steps, density probes and grid
#: points, the adaptive loop's batch and cap, the Chebyshev degree, and the
#: seed of every keyed call
SLQ_K, SLQ_PROBES, DOS_PROBES, DOS_POINTS = 50, 16, 8, 201
ADAPT_BATCH, ADAPT_MAX, CHEB_DEGREE, SEED = 8, 32, 100, 0


def capability_phase(card, dev, inst, solver, solver_c, b) -> dict:
    """21. The fused tier's capability methods on the headline: SLQ (K2 a
    probe, K6 a probe on the compensated solver), the spectral density,
    the cached interval (eigsh over K8) and Chebyshev f(A)·b (K1 a degree),
    each driven with the counters reset just before it. Returns each
    path's launches per kernel and the median times."""
    import numpy as np
    import torch

    from two_pass_lanczos_tpu_torch import make_kkt_operator, slq, spectrum
    from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
        chebyshev_coefficients,
        chebyshev_fAb,
        chebyshev_scan,
        interval_from_extremes,
    )
    from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
    from two_pass_lanczos_tpu_torch.devices import cpu_generator
    from two_pass_lanczos_tpu_torch.eigen import eigsh
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import pass_one_cuda
    from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

    lay, n = solver.layout, solver.n

    def same_as_solo(slv, dec, probes, k, what):
        for i in range(probes.shape[0]):
            solo = pass_one_cuda(lay, probes[i].contiguous(), k, slv.tol,
                                 slv.ztol, compensated=slv.compensated)
            check(torch.equal(dec.alphas[i], solo.alphas)
                  and torch.equal(dec.betas[i], solo.betas)
                  and torch.equal(dec.b_norm[i], solo.b_norm)
                  and torch.equal(dec.steps_taken[i], solo.steps_taken),
                  f"{what}: probe {i} differs from pass_one_cuda alone")

    paths = {}
    # SLQ: tr A^-1 by 16 Rademacher probes, k = 50
    res, got = driven(lambda: solver.slq_trace(
        "inv", k=SLQ_K, num_probes=SLQ_PROBES, key=SEED))
    check(got == {"lanczos_pass_one": SLQ_PROBES,
                  "kkt_matvec_in_pass": SLQ_PROBES * SLQ_K},
          f"slq_trace launches {got}")
    paths["slq_trace"] = got
    samples = res.samples.cpu().numpy()
    check(res.samples.is_cuda and np.all(np.isfinite(samples)),
          "slq_trace samples not finite on the card")
    probes = slq._draw_probes(SEED, SLQ_PROBES, n, torch.float32,
                              "rademacher").to(dev)
    same_as_solo(solver, solver._slq_pass_one(probes, SLQ_K), probes, SLQ_K,
                 "K2 in _slq_pass_one")
    # k = 20 against the f64 plain pass on the CPU, same probes
    t = torch.from_numpy
    d64 = t(np.asarray(inst.quad_costs, np.float64))
    u_, v_ = t(np.asarray(inst.arc_u)), t(np.asarray(inst.arc_v))
    p_ = int(inst.num_nodes)

    def mv64(x):
        return kkt_matvec(d64, u_, v_, p_, x)

    q20 = slq.batched_quadratic_form(
        solver._slq_pass_one(probes, K_CHECK), "inv").cpu().double().numpy()
    probes64 = probes.cpu().double()
    ref20 = slq.batched_quadratic_form(slq.stack_decompositions(
        [pass_one_scan(mv64, z, K_CHECK)[0] for z in probes64]),
        "inv").numpy()
    rel20 = float(np.max(np.abs(q20 - ref20) / np.abs(ref20)))
    check(rel20 <= 2e-3, f"SLQ samples at k={K_CHECK}: max rel {rel20:.3e} "
                         "from the f64 plain pass, above 2e-3")
    # compensated: K6 a probe, bitwise each alone
    res_c, got = driven(lambda: solver_c.slq_trace(
        "inv", k=SLQ_K, num_probes=4, key=SEED))
    check(got == {"lanczos_pass_one_comp": 4, "kkt_matvec_in_pass": 4 * SLQ_K},
          f"compensated slq_trace launches {got}")
    paths["slq_trace_compensated"] = got
    same_as_solo(solver_c, solver_c._slq_pass_one(probes[:4], SLQ_K),
                 probes[:4], SLQ_K, "K6 in _slq_pass_one")
    res_a, got = driven(lambda: solver.slq_trace_adaptive(
        "inv", k=SLQ_K, batch=ADAPT_BATCH, max_probes=ADAPT_MAX, key=SEED))
    m_a = int(res_a.samples.shape[0])
    check(got == {"lanczos_pass_one": m_a, "kkt_matvec_in_pass": m_a * SLQ_K},
          f"slq_trace_adaptive launches {got}")
    paths["slq_trace_adaptive"] = got
    rel_se = float(res_a.stderr) / abs(float(res_a.estimate))
    print(f"[21] slq_trace('inv', k={SLQ_K}, num_probes={SLQ_PROBES}, "
          f"key={SEED}): estimate {float(res.estimate):.6e} +- "
          f"{float(res.stderr):.3e}, launches {paths['slq_trace']}; every "
          f"probe's alpha, beta, steps and ||z|| bitwise K2 alone; at "
          f"k={K_CHECK} max rel {rel20:.3e} from the CPU f64 plain pass "
          f"(<= 2e-3); compensated (4 probes) {paths['slq_trace_compensated']}"
          f", bitwise K6 alone; adaptive (batch {ADAPT_BATCH}, max "
          f"{ADAPT_MAX}): {m_a} probes, rel stderr {rel_se:.4f}, estimate "
          f"{float(res_a.estimate):.6e}")

    # the interval: eigsh over K8, cached
    iv, got = driven(solver.estimate_interval)
    check(set(got) == {"kkt_operator_matvec"}, f"interval launches {got}")
    paths["estimate_interval"] = got
    _, again = driven(solver.estimate_interval)
    check(solver.estimate_interval() is iv and not again,
          f"estimate_interval not cached (second call launched {again})")
    theta = spectrum.ritz_values(solver.pass_one(b, K))
    check(iv[0] <= theta.min() and theta.max() <= iv[1],
          f"interval {iv} does not hold the k={K} Ritz values "
          f"[{theta.min():.6e}, {theta.max():.6e}]")
    op = make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, dtype=torch.float32, device=dev)
    gen = cpu_generator(0)
    runs_ = [eigsh(op, nev=1, which=w, tol=1e-3, ncv=20, key=gen)
             for w in ("LA", "SA")]
    check(interval_from_extremes(*runs_, 0.05) == iv,
          "the interval's two eigsh runs do not reproduce it")
    print(f"     estimate_interval(): [{iv[0]:.6e}, {iv[1]:.6e}], "
          f"{got['kkt_operator_matvec']} K8 launches and nothing else; "
          f"eigsh LA {runs_[0].restarts} restarts, SA {runs_[1].restarts} "
          f"(converged {runs_[0].converged}, {runs_[1].converged}); cached; "
          f"holds K2's k={K} Ritz values [{theta.min():.6e}, "
          f"{theta.max():.6e}]")

    # the density on 201 points over the interval
    grid = np.linspace(iv[0], iv[1], DOS_POINTS)
    phi, got = driven(lambda: solver.slq_spectral_density(
        grid, k=SLQ_K, num_probes=DOS_PROBES, key=SEED))
    check(got == {"lanczos_pass_one": DOS_PROBES,
                  "kkt_matvec_in_pass": DOS_PROBES * SLQ_K},
          f"slq_spectral_density launches {got}")
    paths["slq_spectral_density"] = got
    mass = float(np.trapezoid(phi.cpu().double().numpy(), grid))
    check(abs(mass - 1.0) <= 0.05, f"density mass {mass:.4f}, not 1 +- 0.05")
    print(f"     slq_spectral_density({DOS_POINTS} points, k={SLQ_K}, "
          f"num_probes={DOS_PROBES}): mass {mass:.6f}, launches {got}")

    # Chebyshev f(A)·b with f = exp(t/rho), rho the interval's radius, which
    # stays finite on the interval (exp of the headline's spectrum would
    # overflow f32, and inv is singular inside it)
    rho = 0.5 * (iv[1] - iv[0])

    def f_cheb(t_):
        return np.exp(t_ / rho)

    y, got = driven(lambda: solver.chebyshev_fAb(
        b, f_cheb, degree=CHEB_DEGREE, interval=iv, raw=True))
    check(got == {"kkt_matvec": CHEB_DEGREE}, f"chebyshev_fAb launches {got}")
    paths["chebyshev_fAb"] = got
    cs = torch.from_numpy(chebyshev_coefficients(f_cheb, iv, CHEB_DEGREE))
    scale = torch.tensor([2.0 / (iv[1] - iv[0]),
                          (iv[1] + iv[0]) / (iv[1] - iv[0])],
                         dtype=torch.float64)
    y64 = chebyshev_scan(mv64, b.cpu().double(), cs, scale).numpy()
    ymax = float(np.abs(y64).max())
    err_cpu = float(np.abs(y.cpu().double().numpy() - y64).max())
    check(np.all(np.isfinite(y64)) and err_cpu <= 2e-4 * ymax,
          f"chebyshev_fAb {err_cpu:.3e} from the f64 plain expansion, above "
          f"2e-4·max|y| = {2e-4 * ymax:.3e}")
    y_gen, got = driven(lambda: chebyshev_fAb(
        op, b, f_cheb, degree=CHEB_DEGREE, interval=iv))
    check(got == {"kkt_operator_matvec": CHEB_DEGREE},
          f"generic chebyshev_fAb launches {got}")
    paths["chebyshev_fAb_generic"] = got
    err_gen = float((y_gen - y).abs().max())
    check(err_gen <= 2e-4 * ymax, f"generic chebyshev_fAb (K8) {err_gen:.3e} "
                                  f"from the fused one (K1)")
    print(f"     chebyshev_fAb(b, f=exp(t/{rho:.6e}), degree={CHEB_DEGREE}) "
          f"on the interval: max|y - y_f64| {err_cpu:.3e} <= 2e-4·max|y| "
          f"{2e-4 * ymax:.3e}; launches {paths['chebyshev_fAb']}; the "
          f"generic one on make_kkt_operator {err_gen:.3e} from it, "
          f"launches {got}")

    # times: the median of 3 calls, each ending in a sync
    def fresh_interval():
        solver._interval_cache = None
        return solver.estimate_interval()

    timed = {
        "slq_trace": lambda: solver.slq_trace(
            "inv", k=SLQ_K, num_probes=SLQ_PROBES, key=SEED),
        "slq_spectral_density": lambda: solver.slq_spectral_density(
            grid, k=SLQ_K, num_probes=DOS_PROBES, key=SEED),
        "slq_trace_adaptive": lambda: solver.slq_trace_adaptive(
            "inv", k=SLQ_K, batch=ADAPT_BATCH, max_probes=ADAPT_MAX,
            key=SEED),
        "estimate_interval": fresh_interval,
        "chebyshev_fAb": lambda: solver.chebyshev_fAb(
            b, f_cheb, degree=CHEB_DEGREE, interval=iv, raw=True),
    }
    times = {name: wall_s(fn, 3) for name, fn in timed.items()}
    check(solver.estimate_interval() == iv, "the interval is not reproducible")
    print(f"     on {card}: " + "; ".join(
        f"{name} {runs(ts)}" for name, ts in times.items())
        + " (estimate_interval uncached: the operator's layout build and "
        "both eigsh runs)")
    return {"paths": paths, "times": times}



def reset_counts() -> None:
    """Reset ``LAUNCHES`` and ``sharded_step.STEP_KERNELS``."""
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import reset_launches
    from two_pass_lanczos_tpu_torch.parallel.sharded_step import STEP_KERNELS
    reset_launches()
    for name in STEP_KERNELS:
        STEP_KERNELS[name] = 0


def row_counts() -> dict:
    """The launches since :func:`reset_counts` by row of the kernels line:
    ``LAUNCHES`` and ``STEP_KERNELS``, K7's step instances apart from its
    plain one (a pass-one step ends in one ``advance``, a pass-two step in
    one ``two_nodes``, each after one of K7's step launches)."""
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES
    from two_pass_lanczos_tpu_torch.parallel.sharded_step import STEP_KERNELS
    got = {**LAUNCHES, **STEP_KERNELS}
    got["kkt_shard_matvec_step_one"] = STEP_KERNELS["shard_step_advance"]
    got["kkt_shard_matvec_step_two"] = STEP_KERNELS["shard_step_two_nodes"]
    got["kkt_streaming_matvec"] -= (got["kkt_shard_matvec_step_one"]
                                    + got["kkt_shard_matvec_step_two"])
    return {name: c for name, c in got.items() if c}


def fused_pass_one(steps: int) -> dict:
    """:func:`row_counts` of ``steps`` steps of the fused sharded pass one."""
    return {name: steps for name in (
        "kkt_shard_matvec_step_one", "shard_step_node_fold",
        "shard_step_orthogonalise", "shard_step_norm", "shard_step_advance")}


def driven(fn):
    """Run ``fn`` with the launch counters reset just before it: (its
    result, the launches it made, by :func:`row_counts`)."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, row_counts()


def tf32_same(fn) -> bool:
    """Whether ``fn()`` gives the same bits with TF32 on as off (the
    script runs with it off)."""
    import torch
    off = fn()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.equal(on, off)


def ortho_defect(basis, steps: int) -> float:
    """max|VᵀV − I| of the first ``steps`` rows, in f64, column block by
    column block (the f64 copy of a whole basis would take 2 GB)."""
    import torch
    v = basis[:steps]
    gram = torch.zeros((steps, steps), dtype=torch.float64,
                       device=basis.device)
    for c in range(0, v.shape[1], 65536):
        blk = v[:, c:c + 65536].double()
        gram += blk @ blk.T
    eye = torch.eye(steps, dtype=torch.float64, device=basis.device)
    return float((gram - eye).abs().max())


def rel_err(x, ref) -> float:
    import torch
    x, ref = torch.as_tensor(x).double().cpu(), torch.as_tensor(
        ref).double().cpu()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


#: phase 22: the block width and steps, and the k of the TF32 checks
BLOCK_P, BLOCK_K, TF32_K = 4, 100, 100


def reorth_block_phase(card, dev, inst, b) -> dict:
    """22. The generic tier's reorthogonalised one-pass solves and block
    Lanczos on the headline's f32 ``make_kkt_operator`` (K8), each driven
    with the counters reset: ``solve_fAb(..., k=500, method="one_pass",
    reorth=True)`` exactly 500 K8 launches, the orthogonality defect of
    its basis against the plain one-pass basis, α and β at k = 20 within
    rtol 1e-4 of the CPU f64 run, the same bits with TF32 on;
    ``reorth="selective"`` its sweeps counted at k = 500 and, at a k where
    none fires, bitwise the plain one-pass solve; ``solve_fAb_block`` (p =
    4, k = 100) one- and two-pass, p K8 launches a step and pass, the two
    within rtol 1e-4, the replay drift printed and gated at 1e-12, a small
    instance within 1e-4 of the CPU f64 solve; medians of 3 beside the
    plain one-pass solve."""
    import numpy as np
    import torch

    from two_pass_lanczos_tpu_torch import (
        make_kkt_operator,
        solve_fAb,
        solve_fAb_block,
    )
    from two_pass_lanczos_tpu_torch.algorithms.block import (
        block_pass_one,
        block_pass_two,
    )
    from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
    from two_pass_lanczos_tpu_torch.algorithms.reorth import (
        pass_one_scan_reorth,
        pass_one_scan_selective,
    )
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )
    from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

    t_phase = time.perf_counter()
    op = make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, dtype=torch.float32, device=dev)
    n, paths = op.shape[0], {}

    def reorth_solve(mode, k=K):
        return solve_fAb(op, b, k=k, f="inv", method="one_pass",
                         reorth=mode)

    x_r, got = driven(lambda: reorth_solve(True))
    check(got == {"kkt_operator_matvec": K}, f"reorth launches {got}")
    check(bool(torch.isfinite(x_r).all()), "reorth x not finite")
    paths["reorth"] = got
    dec_r, basis_r = pass_one_scan_reorth(op.matvec, b, K)
    steps = dec_r.steps()
    d_r = ortho_defect(basis_r, steps)
    del basis_r
    dec_p, basis_p = pass_one_scan(op.matvec, b, K, emit_basis=True)
    d_p = ortho_defect(basis_p, dec_p.steps())
    del basis_p
    check(steps == K and d_p > 1e-2 and d_r <= 1e-4 and 100 * d_r <= d_p,
          f"orthogonality defect: reorth {d_r:.3e}, plain {d_p:.3e}, "
          f"steps {steps}")
    t = torch.from_numpy
    d64 = t(np.asarray(inst.quad_costs, np.float64))
    u_, v_ = t(np.asarray(inst.arc_u)), t(np.asarray(inst.arc_v))
    p_ = int(inst.num_nodes)

    def mv64(x):
        return kkt_matvec(d64, u_, v_, p_, x)

    dec20, _ = pass_one_scan_reorth(op.matvec, b, K_CHECK)
    ref20, _ = pass_one_scan_reorth(mv64, b.cpu().double(), K_CHECK)
    np.testing.assert_allclose(dec20.alphas.cpu().numpy(),
                               ref20.alphas.numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec20.betas.cpu().numpy(),
                               ref20.betas.numpy(), rtol=1e-4)
    a20 = float(((dec20.alphas.cpu().double() - ref20.alphas).abs()
                 / ref20.alphas.abs()).max())
    check(tf32_same(lambda: reorth_solve(True, TF32_K)),
          "reorth x changed with TF32 on")
    print(f"[22] solve_fAb(make_kkt_operator, b, k={K}, f='inv', "
          f"method='one_pass', reorth=True): launches {got}; "
          f"max|VᵀV - I| in f64: reorthogonalised {d_r:.3e}, plain one-pass "
          f"{d_p:.3e} ({d_p / d_r:.3g}x); alpha, beta at k={K_CHECK} max rel "
          f"{a20:.3e} from the CPU f64 run (<= 1e-4); the same bits with "
          f"TF32 on (k={TF32_K})")

    x_s, got = driven(lambda: reorth_solve("selective"))
    check(got == {"kkt_operator_matvec": K}, f"selective launches {got}")
    check(bool(torch.isfinite(x_s).all()), "selective x not finite")
    paths["reorth_selective"] = got
    dec_s, basis_s, nre = pass_one_scan_selective(op.matvec, b, K)
    d_s = ortho_defect(basis_s, dec_s.steps())
    del basis_s
    quiet = None
    for k0 in (50, 30, 20, 10, 5):
        if int(pass_one_scan_selective(op.matvec, b, k0)[2]) == 0:
            quiet = k0
            break
    check(quiet is not None, "the selective run sweeps from step 5 on")
    check(torch.equal(reorth_solve("selective", quiet),
                      solve_fAb(op, b, k=quiet, f="inv", method="one_pass")),
          f"selective without a sweep (k={quiet}) is not the plain solve")
    print(f"     reorth='selective': {int(nre)} of {K} steps swept "
          f"(reorth_steps), defect {d_s:.3e}, launches {got}; at k={quiet} "
          f"no sweep fires and x is bitwise the plain one-pass solve's")

    bb = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (n, BLOCK_P)).astype(np.float32)).to(dev)
    x1, got1 = driven(lambda: solve_fAb_block(op, bb, BLOCK_K, "inv"))
    x2, got2 = driven(lambda: solve_fAb_block(op, bb, BLOCK_K, "inv",
                                              method="two_pass"))
    check(got1 == {"kkt_operator_matvec": BLOCK_P * BLOCK_K}
          and got2 == {"kkt_operator_matvec": 2 * BLOCK_P * BLOCK_K},
          f"block launches {got1}, {got2}")
    paths["solve_fAb_block_one_pass"] = got1
    paths["solve_fAb_block_two_pass"] = got2
    check(bool(torch.isfinite(x1).all() and torch.isfinite(x2).all()),
          "block x not finite")
    rel12 = rel_err(x2, x1)
    check(rel12 <= 1e-4, f"block two-pass {rel12:.3e} from one-pass")
    dec_b, basis1 = block_pass_one(op.matvec, bb, BLOCK_K)
    _, basis2 = block_pass_two(
        op.matvec, bb, dec_b, torch.zeros((BLOCK_K, BLOCK_P, BLOCK_P),
                                          device=dev), emit_basis=True)
    drift = float((basis1 - basis2).abs().max())
    del basis1, basis2
    check(int(dec_b.steps_taken) == BLOCK_K and drift <= 1e-12,
          f"block replay drift {drift:.3e}, steps {int(dec_b.steps_taken)}")
    check(tf32_same(lambda: solve_fAb_block(op, bb, BLOCK_K, "inv")),
          "block x changed with TF32 on")
    small = generate_mcf_instance(500, rho=3, instance_id=1)
    ops = {dt: make_kkt_operator(small.quad_costs, small.arc_u, small.arc_v,
                                 small.num_nodes, dtype=dt, device=dv)
           for dt, dv in ((torch.float32, dev), (torch.float64, "cpu"))}
    bs = np.random.default_rng(5).standard_normal((ops[torch.float64].shape[
        0], BLOCK_P))
    rel_small = {m: rel_err(
        solve_fAb_block(ops[torch.float32], bs.astype(np.float32), 10, "inv",
                        method=m),
        solve_fAb_block(ops[torch.float64], bs, 10, "inv", method=m))
        for m in ("one_pass", "two_pass")}
    check(max(rel_small.values()) <= 1e-4,
          f"small block solves against the CPU f64 run: {rel_small}")
    print(f"     solve_fAb_block(p={BLOCK_P}, k={BLOCK_K}): one-pass "
          f"launches {got1}, two-pass {got2} (p K8 launches a step and "
          f"pass, {int(dec_b.steps_taken)} steps); two-pass {rel12:.3e} from "
          f"one-pass; replay drift max|V1 - V2| = {drift:.3e}; the same bits "
          f"with TF32 on; m=500 k=10 against the CPU f64 run: "
          + ", ".join(f"{m} {r:.3e}" for m, r in rel_small.items()))

    timed = {
        "reorth": lambda: reorth_solve(True),
        "reorth_selective": lambda: reorth_solve("selective"),
        "solve_fAb_block_one_pass": lambda: solve_fAb_block(
            op, bb, BLOCK_K, "inv"),
        "solve_fAb_block_two_pass": lambda: solve_fAb_block(
            op, bb, BLOCK_K, "inv", method="two_pass"),
        "one_pass_plain": lambda: solve_fAb(op, b, k=K, f="inv",
                                            method="one_pass"),
    }
    times = {name: wall_s(fn, 3) for name, fn in timed.items()}
    wall = time.perf_counter() - t_phase
    print(f"     on {card}: " + "; ".join(
        f"{name} {runs(ts)}" for name, ts in times.items())
        + f"; phase 22 wall {wall:.1f} s")
    return {"paths": paths, "times": times}


#: phase 23: the probes of the sharded SLQ, and eigsh's tolerance and cap
SH_PROBES, EIG_TOL, EIG_MAXITER = 8, 1e-5, 100


def sharded_capability_phase(card, dev, mesh, inst, solver, b) -> dict:
    """23. The sharded tiers' capability methods on ``mesh`` (a one-rank
    NCCL group), each driven with the counters reset and held against its
    single-card twin on the same probes, ``v0`` or coefficients. The
    row-sharded ``ShardedSparseOperator`` (f32 KKT triplets, no port
    kernel): ``eigsh(nev=2)`` LA and SA against ``eigen.eigsh`` on
    ``make_kkt_operator`` (both converged; LA's values, and SA's smallest,
    within 2·tol·scale, the scale the spectral radius),
    the SLQ methods against the generic ones (samples rtol 2e-3, density
    5e-3), ``solve_fAb_block`` (k = 10 within rel 1e-4 of the generic one;
    k = 100 finite), ``estimate_interval`` (rtol 1e-2), ``chebyshev_fAb``
    (2e-4·max|y|) and ``solve_fAb(reorth=True)`` (k = 20, rel 1e-4).
    The arc-sharded ``ShardedFusedKKTSolver``: SLQ on K7 (k launches a
    probe, samples within rtol 2e-3 of the fused solver's K2, a probe
    bitwise a solve's pass one), the density, the adaptive loop, the
    cached interval (K8 only, the fused solver's), ``chebyshev_fAb``
    (``degree`` K7 launches, against the fused K1 expansion). Medians of 3
    for every method."""
    import numpy as np
    import torch

    from two_pass_lanczos_tpu_torch import (
        chebyshev_fAb,
        eigsh,
        estimate_interval,
        make_kkt_operator,
        slq_spectral_density,
        slq_trace,
        slq_trace_adaptive,
        solve_fAb,
        solve_fAb_block,
    )
    from two_pass_lanczos_tpu_torch import slq
    from two_pass_lanczos_tpu_torch.parallel import (
        ShardedFusedKKTSolver,
        ShardedSparseOperator,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    t_phase = time.perf_counter()
    arrays = KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, mesh,
                                                dtype=np.float32)
    op = make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, dtype=torch.float32, device=dev)
    n, paths, lines = op.shape[0], {}, []

    def k15_only(got, what):
        """K15 and no other port kernel; the path's launches recorded."""
        check(set(got) == {"csr_spmv"},
              f"{what} launched {got}, not K15 alone")
        paths[what.replace(" ", "_")] = got

    v0 = np.random.default_rng(23).standard_normal(n).astype(np.float32)
    # eigsh's own scale: its convergence test is resid <= tol·max|θ| over
    # every Ritz value, ~ the spectral radius (the cached interval's end)
    iv = solver.estimate_interval()
    scale = max(abs(iv[0]), abs(iv[1]))
    eig = {}
    for which in ("LA", "SA"):
        r_sh, got = driven(lambda: sop.eigsh(
            nev=2, which=which, tol=EIG_TOL, ncv=20, maxiter=EIG_MAXITER,
            v0=v0))
        k15_only(got, f"sharded eigsh {which}")
        r_1 = eigsh(op, nev=2, which=which, tol=EIG_TOL, ncv=20,
                    maxiter=EIG_MAXITER, v0=v0)
        # LA: two separated extremes, compared pair by pair. SA: the KKT's
        # low end is a cluster of eigenvalues within ~0.03 of 0, far inside
        # tol·scale, so only the smallest Ritz value is pinned down
        pairs = slice(None) if which == "LA" else slice(0, 1)
        gap = float(np.abs(r_sh.eigenvalues[pairs]
                           - r_1.eigenvalues[pairs]).max())
        check(r_sh.converged and r_1.converged
              and gap <= 2 * EIG_TOL * scale,
              f"eigsh {which}: sharded {r_sh.eigenvalues} "
              f"({r_sh.converged}), single card {r_1.eigenvalues} "
              f"({r_1.converged}), 2·tol·scale {2 * EIG_TOL * scale:.3e}")
        eig[which] = (r_sh, gap)
    lines.append(
        f"eigsh(nev=2, tol={EIG_TOL:g}, 2·tol·scale "
        f"{2 * EIG_TOL * scale:.3e}): " + "; ".join(
            f"{w} {r.eigenvalues} ({r.restarts} restarts, {gap:.3e} from "
            f"the single-card eigsh on K8)" for w, (r, gap) in eig.items()))

    res, got = driven(lambda: sop.slq_trace("inv", k=SLQ_K,
                                            num_probes=SH_PROBES, key=SEED))
    k15_only(got, "sharded slq_trace")
    ref = slq_trace(op, "inv", k=SLQ_K, num_probes=SH_PROBES, key=SEED)
    np.testing.assert_allclose(res.samples.cpu().numpy(),
                               ref.samples.cpu().numpy(), rtol=2e-3)
    grid = np.linspace(iv[0], iv[1], DOS_POINTS)
    phi, got = driven(lambda: sop.slq_spectral_density(
        grid, k=SLQ_K, num_probes=SH_PROBES, key=SEED))
    k15_only(got, "sharded slq_spectral_density")
    phi1 = slq_spectral_density(op, grid, k=SLQ_K, num_probes=SH_PROBES,
                                key=SEED).cpu().numpy()
    np.testing.assert_allclose(phi.cpu().numpy(), phi1, rtol=5e-3,
                               atol=5e-4 * phi1.max())
    res_a, got = driven(lambda: sop.slq_trace_adaptive(
        "inv", k=SLQ_K, batch=4, max_probes=SH_PROBES, key=SEED))
    k15_only(got, "sharded slq_trace_adaptive")
    ref_a = slq_trace_adaptive(op, "inv", k=SLQ_K, batch=4,
                               max_probes=SH_PROBES, key=SEED)
    np.testing.assert_allclose(res_a.samples.numpy(), ref_a.samples.numpy(),
                               rtol=2e-3)
    lines.append(f"slq_trace(k={SLQ_K}, {SH_PROBES} probes) "
                 f"{float(res.estimate):.6e}, samples within rtol 2e-3 of "
                 f"the generic ones (K8); density and adaptive "
                 f"({res_a.samples.shape[0]} probes) likewise")

    bb = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (n, BLOCK_P)).astype(np.float32)).to(dev)
    x10, got = driven(lambda: sop.solve_fAb_block(bb, k=10, f="inv"))
    k15_only(got, "sharded solve_fAb_block")
    rel_blk = rel_err(x10, solve_fAb_block(op, bb, 10, "inv"))
    check(rel_blk <= 1e-4, f"sharded block k=10 {rel_blk:.3e} from generic")
    x100 = sop.solve_fAb_block(bb, k=BLOCK_K, f="inv")
    check(bool(np.isfinite(x100).all()) and sop._last_block_steps == BLOCK_K,
          f"sharded block k={BLOCK_K}: steps {sop._last_block_steps}")
    lines.append(f"solve_fAb_block(p={BLOCK_P}) k=10 {rel_blk:.3e} from the "
                 f"generic one (Householder QR), k={BLOCK_K} finite with "
                 f"{sop._last_block_steps} steps (CholeskyQR2)")

    iv_sh, got = driven(sop.estimate_interval)
    k15_only(got, "sharded estimate_interval")
    iv_1 = estimate_interval(op)
    np.testing.assert_allclose(iv_sh, iv_1, rtol=1e-2)
    rho = 0.5 * (iv[1] - iv[0])

    def f_cheb(t_):
        return np.exp(t_ / rho)

    y_sh, got = driven(lambda: sop.chebyshev_fAb(
        b, f_cheb, degree=CHEB_DEGREE, interval=iv))
    k15_only(got, "sharded chebyshev_fAb")
    y_1 = chebyshev_fAb(op, b, f_cheb, degree=CHEB_DEGREE,
                        interval=iv).cpu().numpy()
    err_c = float(np.abs(y_sh - y_1).max())
    check(err_c <= 2e-4 * float(np.abs(y_1).max()),
          f"sharded chebyshev {err_c:.3e} from the generic one")
    xr, got = driven(lambda: sop.solve_fAb(b, k=K_CHECK, f="inv",
                                           method="one_pass", reorth=True))
    k15_only(got, "sharded reorth")
    rel_r = rel_err(xr[0], solve_fAb(op, b, k=K_CHECK, f="inv",
                                     method="one_pass", reorth=True))
    check(rel_r <= 1e-4, f"sharded reorth k={K_CHECK} {rel_r:.3e}")
    lines.append(f"estimate_interval [{iv_sh[0]:.6e}, {iv_sh[1]:.6e}] "
                 f"(single card [{iv_1[0]:.6e}, {iv_1[1]:.6e}]); "
                 f"chebyshev_fAb(degree={CHEB_DEGREE}) {err_c:.3e} from the "
                 f"generic one; solve_fAb(k={K_CHECK}, reorth=True) "
                 f"{rel_r:.3e} from the generic one")
    print(f"[23] ShardedSparseOperator on a one-rank "
          f"{torch.distributed.get_backend(mesh.group)} group, K15 alone "
          f"launched: " + "; ".join(lines))

    sh = ShardedFusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, mesh)
    res, got = driven(lambda: sh.slq_trace("inv", k=SLQ_K,
                                           num_probes=SH_PROBES, key=SEED))
    check(got == fused_pass_one(SH_PROBES * SLQ_K),
          f"fused sharded slq_trace launches {got}")
    paths["slq_trace_sharded"] = got
    ref = solver.slq_trace("inv", k=SLQ_K, num_probes=SH_PROBES, key=SEED)
    np.testing.assert_allclose(res.samples.cpu().numpy(),
                               ref.samples.cpu().numpy(), rtol=2e-3)
    z = slq._draw_probes(SEED, SH_PROBES, n, torch.float32, "rademacher")
    dec = sh._slq_pass_one(z, SLQ_K)
    solo = sh.pass_one(z[SH_PROBES - 1], SLQ_K)
    check(torch.equal(dec.alphas[-1], solo.alphas)
          and torch.equal(dec.betas[-1], solo.betas),
          "a sharded SLQ probe is not bitwise a solve's pass one")
    phi, got = driven(lambda: sh.slq_spectral_density(
        grid, k=SLQ_K, num_probes=SH_PROBES, key=SEED))
    check(got == fused_pass_one(SH_PROBES * SLQ_K),
          f"fused sharded density launches {got}")
    paths["slq_spectral_density_sharded"] = got
    phi1 = solver.slq_spectral_density(grid, k=SLQ_K, num_probes=SH_PROBES,
                                       key=SEED).cpu().numpy()
    np.testing.assert_allclose(phi.cpu().numpy(), phi1, rtol=5e-3,
                               atol=5e-4 * phi1.max())
    res_a, got = driven(lambda: sh.slq_trace_adaptive(
        "inv", k=SLQ_K, batch=4, max_probes=SH_PROBES, key=SEED))
    m_a = int(res_a.samples.shape[0])
    check(got == fused_pass_one(m_a * SLQ_K),
          f"fused sharded adaptive launches {got}")
    paths["slq_trace_adaptive_sharded"] = got
    iv_f, got = driven(sh.estimate_interval)
    check(set(got) == {"kkt_operator_matvec"} and iv_f == iv
          and sh.estimate_interval() is iv_f,
          f"fused sharded interval {iv_f} ({got}), the fused one {iv}")
    paths["estimate_interval_sharded"] = got
    y, got = driven(lambda: sh.chebyshev_fAb(
        b, f_cheb, degree=CHEB_DEGREE, interval=iv, raw=True))
    check(got == {"kkt_streaming_matvec": CHEB_DEGREE},
          f"fused sharded chebyshev launches {got}")
    paths["chebyshev_fAb_sharded"] = got
    y_f = solver.chebyshev_fAb(b, f_cheb, degree=CHEB_DEGREE, interval=iv,
                               raw=True)
    y_cat = torch.cat(y)
    err_f = float((y_cat - y_f).abs().max())
    check(err_f <= 2e-4 * float(y_f.abs().max()),
          f"fused sharded chebyshev {err_f:.3e} from the fused one")
    print(f"     ShardedFusedKKTSolver: slq_trace launches "
          f"{paths['slq_trace_sharded']}, samples within rtol 2e-3 of K2's, "
          f"a probe bitwise a solve's pass one; density "
          f"{paths['slq_spectral_density_sharded']}; adaptive ({m_a} "
          f"probes) {paths['slq_trace_adaptive_sharded']}; "
          f"estimate_interval {paths['estimate_interval_sharded']}, the "
          f"fused solver's interval, cached; chebyshev_fAb "
          f"{paths['chebyshev_fAb_sharded']}, {err_f:.3e} from the fused "
          f"K1 expansion, bitwise: {bool(torch.equal(y_cat, y_f))}")

    def fresh(s):
        s._interval_cache = None
        return s.estimate_interval()

    timed = {
        "sparse_eigsh_LA": lambda: sop.eigsh(
            nev=2, which="LA", tol=EIG_TOL, ncv=20, maxiter=EIG_MAXITER,
            v0=v0),
        "sparse_eigsh_SA": lambda: sop.eigsh(
            nev=2, which="SA", tol=EIG_TOL, ncv=20, maxiter=EIG_MAXITER,
            v0=v0),
        "sparse_slq_trace": lambda: sop.slq_trace(
            "inv", k=SLQ_K, num_probes=SH_PROBES, key=SEED),
        "sparse_slq_spectral_density": lambda: sop.slq_spectral_density(
            grid, k=SLQ_K, num_probes=SH_PROBES, key=SEED),
        "sparse_slq_trace_adaptive": lambda: sop.slq_trace_adaptive(
            "inv", k=SLQ_K, batch=4, max_probes=SH_PROBES, key=SEED),
        "sparse_solve_fAb_block": lambda: sop.solve_fAb_block(
            bb, k=BLOCK_K, f="inv", raw=True),
        "sparse_estimate_interval": sop.estimate_interval,
        "sparse_chebyshev_fAb": lambda: sop.chebyshev_fAb(
            b, f_cheb, degree=CHEB_DEGREE, interval=iv, raw=True),
        "sparse_reorth": lambda: sop.solve_fAb(
            b, k=K, f="inv", method="one_pass", reorth=True, raw=True),
        "fused_slq_trace": lambda: sh.slq_trace(
            "inv", k=SLQ_K, num_probes=SH_PROBES, key=SEED),
        "fused_slq_spectral_density": lambda: sh.slq_spectral_density(
            grid, k=SLQ_K, num_probes=SH_PROBES, key=SEED),
        "fused_slq_trace_adaptive": lambda: sh.slq_trace_adaptive(
            "inv", k=SLQ_K, batch=4, max_probes=SH_PROBES, key=SEED),
        "fused_estimate_interval": lambda: fresh(sh),
        "fused_chebyshev_fAb": lambda: sh.chebyshev_fAb(
            b, f_cheb, degree=CHEB_DEGREE, interval=iv, raw=True),
    }
    times = {name: wall_s(fn, 3) for name, fn in timed.items()}
    wall = time.perf_counter() - t_phase
    print(f"     on {card}: " + "; ".join(
        f"{name} {runs(ts)}" for name, ts in times.items())
        + f"; phase 23 wall {wall:.1f} s")
    del sop, sh, op
    return {"paths": paths, "times": times}


def k15_times(dev, a, x, a_csr) -> dict:
    """K15 on ``a`` (a SortedCOO on the card) and x: checked (the same bits
    twice, within ``row_sum_bound`` of the plain version on the card), then
    timed as device time warm (200 calls in one CUDA graph) and cold (a 128
    MB write evicts the L2 before each call, its own time taken out), beside
    the plain version and cuSPARSE's CSR SpMV (``torch.mv`` of ``a_csr``),
    and its bound (``csr_spmv_bound``)."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.spmv import (
        coo_spmv,
        coo_spmv_plain,
        row_sum_bound,
    )
    from two_pass_lanczos_tpu_torch.probes.bench import Timer
    y = coo_spmv(a, x)
    again = coo_spmv(a, x)
    y_plain = coo_spmv_plain(a, x)
    torch.cuda.synchronize()
    check(torch.equal(y, again), "K15 gave other bits on a second call")
    gap = (y - y_plain).abs().double()
    check(bool((gap <= row_sum_bound(a, x)).all()),
          f"K15 past the bound of the plain sum: max gap {float(gap.max()):.3e}")
    rel_lib = float(torch.linalg.norm(torch.mv(a_csr, x) - y)
                    / torch.linalg.norm(y))
    cold = Timer(dev, reps=50).cold(lambda: coo_spmv(a, x)) / 1e3
    return {"err": float(gap.max()), "rel_lib": rel_lib,
            "ms": device_ms(lambda: coo_spmv(a, x), 200), "cold_ms": cold,
            "plain_ms": device_ms(lambda: coo_spmv_plain(a, x), 200),
            "library_ms": device_ms(lambda: torch.mv(a_csr, x), 200),
            "bound": csr_spmv_bound(a.nnz, *a.shape, x.element_size(),
                                    a.vals.is_complex())}


def csr_spmv_bound(nnz: int, n_rows: int, n_cols: int, width: int,
                   is_complex: bool):
    """(bound ms, what binds) of y = A·x over ``nnz`` nonzeros of
    ``width``-byte values: a value and a 4-byte column index a nonzero, a
    4-byte row pointer a row, x read and y written once; 2 operations a
    nonzero, 8 for complex values."""
    nbytes = (width + 4) * nnz + 4 * (n_rows + 1) + width * (n_rows + n_cols)
    return roofline_ms(nbytes, (8 if is_complex else 2) * nnz)


def sparse_phase(card, dev, mesh, inst) -> list:
    """Phase 20: the row-sharded ``ShardedSparseOperator`` on ``mesh`` (a
    one-rank NCCL group), on the f32 KKT triplets of ``inst``, with b on the
    card and the counters reset: ``solve_fAb(b, k=500, f="inv")`` issues
    one asynchronous gather and one owned SpMV a matvec and launches K15
    (the fixed-order CSR SpMV) once a matvec and no other port kernel, x is
    finite, pass
    two's v_s is bitwise pass one's, α, β at k = 20 within rtol 1e-4 of the
    generic ``solve_fAb`` tier on a ``SparseOperator`` of the same matrix;
    device kernels per step counted by the profiler; medians of 5 solves
    beside the generic two-pass solve; and a small f64 instance within rel
    1e-9 of the single-device generic solve. Returns the row-sharded
    solve's times."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.algorithms.core import (
        pass_one_last_vector,
        pass_one_scan,
        pass_two_scan,
    )
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
        scaled_y,
    )
    from two_pass_lanczos_tpu_torch.parallel import ShardedSparseOperator
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        record_collectives,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    def arrays_of(ins):
        return KKTArrays(quad_costs=ins.quad_costs, arc_u=ins.arc_u,
                         arc_v=ins.arc_v, num_nodes=ins.num_nodes,
                         num_arcs=ins.num_arcs)

    arrays = arrays_of(inst)
    n = arrays.n
    t0 = time.perf_counter()
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, mesh,
                                                dtype=np.float32)
    build_s = time.perf_counter() - t0
    b = torch.from_numpy(np.random.default_rng(20).standard_normal(n)
                         .astype(np.float32)).to(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_collectives() as log:
        x, dec = sop.solve_fAb(b, k=K, f="inv")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    starts = log.events.count("all-gather-start")
    owned = log.events.count("owned-spmv")
    # one rank owns every column: the owned part alone, one K15 a matvec
    check(sop.remote.nnz == 0
          and {k_: v_ for k_, v_ in launches.items() if v_}
          == {"csr_spmv": 2 * K - 1},
          f"the row-sharded solve launched {launches}, not {2 * K - 1} K15")
    check(starts == owned == 2 * K - 1,
          f"{starts} gathers and {owned} owned SpMVs, not {2 * K - 1}")
    check(x.shape == (n,) and bool(np.isfinite(x).all()),
          "row-sharded x not a finite (n,) array")
    bl = sop._prepare_b(b)
    st1 = torch.empty(2, bl.shape[0], device=dev)
    st2 = torch.empty_like(st1)
    dec1, _ = pass_one_scan(sop._matvec, bl, K, state=st1, dot=sop._dot)
    pass_two_scan(sop._matvec, bl, dec1, scaled_y(dec1, "inv", K), state=st2)
    torch.cuda.synchronize()
    steps = dec1.steps()
    check(torch.equal(dec1.alphas, dec.alphas)
          and torch.equal(dec1.betas, dec.betas),
          "row-sharded pass one not bitwise reproducible")
    check(torch.equal(pass_one_last_vector(dec1, st1), st2[1]),
          f"row-sharded pass two's v_{steps} differs from pass one's")
    op = tpl.SparseOperator(kkt_sorted_coo(arrays, dtype=np.float32,
                                           device=dev))
    _, d20 = sop.solve_fAb(b, k=K_CHECK, f="inv")
    g20 = tpl.lanczos_pass_one(op, b, K_CHECK)
    np.testing.assert_allclose(d20.alphas.cpu().numpy(),
                               g20.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(d20.betas.cpu().numpy(),
                               g20.betas.cpu().numpy(), rtol=1e-4)
    rel20 = float(((d20.alphas - g20.alphas).abs()
                   / g20.alphas.abs()).max())
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sop.solve_fAb(b, k=K_CHECK, f="inv", raw=True)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    nccl = sum("nccl" in name.lower() for name in dev_events)
    per_step = len(dev_events) / (2 * K_CHECK - 1)
    t_sh = wall_s(lambda: sop.solve_fAb(b, k=K, f="inv", raw=True), 5)
    t_gen = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv"), 5)
    small = arrays_of(generate_mcf_instance(500, rho=3, instance_id=1))
    s64 = ShardedSparseOperator.from_kkt_arrays(small, mesh)
    b64 = np.random.default_rng(42).standard_normal(small.n)
    x64, _ = s64.solve_fAb(b64, k=25, f="inv")
    x1 = tpl.solve_fAb(tpl.SparseOperator(kkt_sorted_coo(small, device=dev)),
                       torch.from_numpy(b64).to(dev), k=25,
                       f="inv").cpu().numpy()
    rel64 = float(np.linalg.norm(x64 - x1) / np.linalg.norm(x1))
    check(rel64 < 1e-9, f"row-sharded f64 rel {rel64:.3e} vs one device")
    print(f"[20] ShardedSparseOperator (n={n}, rows_per "
          f"{sop.part.rows_per}, nnz {int(sop.nnz_per_device.sum())}) on a "
          f"one-rank {torch.distributed.get_backend(mesh.group)} group, "
          f"built in {build_s:.3f} s: solve_fAb(k={K}, f='inv') first call "
          f"{first_s:.4f} s, steps {steps}, {starts} async gathers and "
          f"{owned} owned SpMVs, K15 launches "
          f"{launches['csr_spmv']} and no other kernel; pass two's v_{steps} bitwise pass "
          f"one's; alpha, beta at k={K_CHECK} vs the generic SparseOperator "
          f"max rel {rel20:.3e}; {per_step:.1f} device events per matvec "
          f"step ({nccl} NCCL kernels in {2 * K_CHECK - 1} steps, traced); "
          f"f64 m=500 vs one device rel {rel64:.3e}")
    print(f"     on {card}: row-sharded two-pass solve k={K}: {runs(t_sh)}; "
          f"generic two-pass solve_fAb(SparseOperator) k={K}: {runs(t_gen)}")
    del sop, op, s64
    return t_sh


#: phase 24: the published CSVs (the JAX package's runs) whose headers the
#: port's CLIs must write, and the floor of the accuracy comparison
RESULTS = ROOT / "results"
PUBLISHED_HEADER = {
    "tradeoff": "tradeoff_arcs500k_rho3.csv",
    "scalability": "scalability_k500_rho3.csv",
    "stability": "accuracy_inv_well-conditioned.csv",
    "orthogonality": "orthogonality_inv_ill-conditioned.csv",
    "certificate_study": "error_certificate_inv_well-conditioned.csv",
    "reorth_study": "reorth_inv_ill-conditioned_f32.csv",
    "dense_tradeoff": "dense_tradeoff.csv",
}
ACC_FLOOR = 1e-14


def read_csv(path):
    import csv
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def run_cli(module: str, argv: list, out_path=None):
    """``main(argv)`` of a CLI of the port in this process, its stdout
    captured (its JSON lines are not this script's); returns (the CSV's
    header and rows, or None; the captured stdout)."""
    import contextlib
    import importlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(
            f"two_pass_lanczos_tpu_torch.{module}").main(argv)
    check(rc == 0, f"{module} {' '.join(argv)} exited {rc}")
    return (read_csv(out_path) if out_path is not None else None,
            buf.getvalue())


def same_header(name: str, header) -> None:
    want, _ = read_csv(RESULTS / PUBLISHED_HEADER[name])
    check(header == want, f"{name} wrote {header}, the JAX CLI {want}")


def within_10x(got: float, published: float) -> bool:
    ratio = max(got, ACC_FLOOR) / max(published, ACC_FLOOR)
    return 0.1 <= ratio <= 10.0


def tools_phase(card, dev, inst, k7) -> dict:
    """24. The experiment CLIs and the measurement tools on the card, each
    in this process (the ``--isolate`` workers and the scaling bench's rank
    in processes of their own) into a temporary directory, every CSV with
    the header of the JAX CLI's published run under ``results/``:
    ``tradeoff`` on the headline (``--backend fused``, k 100, 550, 1000,
    3 repeats; K2, K3 and K4 exactly once a solve; the one-pass device peak
    from k = 100 to 1000 within 10 % of 900·n·4 bytes, the two-pass peak
    flat to 1 % of that), with ``--isolate`` at two k (4 worker processes,
    4 rows) and with ``--backend pallas`` at k = 20 (K8 only);
    ``scalability`` at 100k, 300k, 500k arcs, k = 500 (both variants at
    every n, one-pass less two-pass within 10 % of k·n·4 bytes);
    ``stability``, four scenarios in f64 at the published size and k grid
    (each error within 10× of the published CPU f64 run's, both floored at
    1e-14; the one-pass/two-pass deviation ≤ 1e-10) and ``--precision df``
    at k = 200 (inv/ill, exp/well; the criterion of
    ``test_df_accuracy_tracks_f64_oracle``); ``orthogonality`` (inv/ill, k
    20–200 by 60: ``basis_drift_fro`` exactly 0, the losses at most 10×
    the published ones below 1e-8, above 1e-8 where those are);
    ``certificate_study``, ``reorth_study`` and ``dense_tradeoff`` at small
    sizes; ``tools.sol_bench`` at 500k and 5M arcs (0 <
    ``sol_fraction_ideal`` ≤ 1.05, K7's seconds per matvec beside phase
    17's); ``tools.scaling_bench --processes 1`` on a one-rank NCCL group
    (the record schema, ``meaningful`` false)."""
    import tempfile

    from two_pass_lanczos_tpu_torch.tools.sol_bench import record

    t_phase = time.perf_counter()
    m, p = inst.num_arcs, inst.num_nodes
    n = m + p
    paths = {}
    head = ["--arcs", str(m), "--rho", "3", "--instance-id", "1"]
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)

        def out(name):
            return ["--output", str(tmp / f"{name}.csv")]

        # tradeoff: K2 and K3 (two-pass), K4 (one-pass), K1 once for b
        argv = [*head, "--backend", "fused", "--k-start", "100",
                "--k-end", "1000", "--k-step", "450", "--repeats", "3",
                *out("tradeoff")]
        ((header, rows), _), paths["tradeoff"] = driven(
            lambda: run_cli("experiments.tradeoff", argv,
                            tmp / "tradeoff.csv"))
        same_header("tradeoff", header)
        solves = 3 * (1 + 3)
        check(paths["tradeoff"] == {
            "lanczos_pass_one": solves, "lanczos_pass_two": solves,
            "lanczos_pass_one_basis": solves, "kkt_matvec": 1,
            # a two-pass solve's 2k - 1 phases, a one-pass solve's k
            "kkt_matvec_in_pass": 4 * sum(3 * k - 1 for k in (100, 550,
                                                              1000))},
            f"tradeoff launches {paths['tradeoff']}")
        peak = {(r["variant"], int(r["k"])): 1024 * int(r["device_peak_kb"])
                for r in rows}
        slope = peak[("standard", 1000)] - peak[("standard", 100)]
        basis = 900 * n * 4
        flat = max(v for (var, _), v in peak.items() if var == "two-pass") \
            - min(v for (var, _), v in peak.items() if var == "two-pass")
        print(f"[24] on {card}: tradeoff (fused, headline) device peak, "
              f"MB: " + ", ".join(f"{var} k={k} {v / 1e6:.1f}"
                                  for (var, k), v in sorted(peak.items()))
              + f"; one-pass k=100 -> 1000 +{slope / 1e6:.1f} MB against "
              f"900·n·4 = {basis / 1e6:.1f} MB ({slope / basis:.4f}x); "
              f"two-pass spread {flat / 1e6:.3f} MB")
        print("     tradeoff times (median of 3, min): " + "; ".join(
            f"{r['variant']} k={r['k']} {float(r['time_s']):.4f} s "
            f"({float(r['time_min_s']):.4f})" for r in rows))
        check(abs(slope - basis) <= 0.1 * basis,
              f"one-pass peak slope {slope} B, expected {basis} B ± 10 %")
        check(flat < 0.01 * basis, f"two-pass peak spread {flat} B")

        t0 = time.perf_counter()
        argv = [*head, "--backend", "fused", "--k-start", "100",
                "--k-end", "550", "--k-step", "450", "--isolate",
                *out("isolated")]
        (header, rows), _ = run_cli("experiments.tradeoff", argv,
                                    tmp / "isolated.csv")
        same_header("tradeoff", header)
        check(sorted((r["variant"], r["k"]) for r in rows) == [
            ("standard", "100"), ("standard", "550"), ("two-pass", "100"),
            ("two-pass", "550")], f"isolated rows {rows}")
        print(f"     tradeoff --isolate (4 workers) in "
              f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                  f"{r['variant']} k={r['k']} {float(r['time_s']):.4f} s, "
                  f"peak {int(r['device_peak_kb']) / 1e3:.1f} MB"
                  for r in rows))

        argv = [*head, "--backend", "pallas", "--k-start", "20",
                "--k-end", "20", *out("pallas")]
        ((header, rows), _), paths["tradeoff_pallas"] = driven(
            lambda: run_cli("experiments.tradeoff", argv,
                            tmp / "pallas.csv"))
        # b = A·x_true, then per variant a warm and a timed solve: 20
        # matvecs one-pass, 39 two-pass
        check(paths["tradeoff_pallas"] == {
            "kkt_operator_matvec": 1 + 2 * 20 + 2 * 39},
            f"tradeoff --backend pallas launches {paths['tradeoff_pallas']}")

        argv = ["--arcs-start", "100000", "--arcs-end", "500000",
                "--arcs-step", "200000", "--k", str(K), "--backend",
                "fused", *out("scalability")]
        ((header, rows), _), paths["scalability"] = driven(
            lambda: run_cli("experiments.scalability", argv,
                            tmp / "scalability.csv"))
        same_header("scalability", header)
        check(paths["scalability"].get("lanczos_pass_one") == 6
              and paths["scalability"].get("lanczos_pass_two") == 6
              and paths["scalability"].get("lanczos_pass_one_basis") == 6,
              f"scalability launches {paths['scalability']}")
        by_n = {}
        for r in rows:
            by_n.setdefault(int(r["n"]), {})[r["variant"]] = \
                1024 * int(r["device_peak_kb"])
        check(len(by_n) == 3 and all(set(v) == {"standard", "two-pass"}
                                     for v in by_n.values()),
              f"scalability rows {rows}")
        for nn, v in sorted(by_n.items()):
            gap = v["standard"] - v["two-pass"]
            check(abs(gap - K * nn * 4) <= 0.1 * K * nn * 4,
                  f"scalability n={nn}: one-pass less two-pass {gap} B")
        print("     scalability (fused, k=500): " + "; ".join(
            f"n={nn} two-pass {v['two-pass'] / 1e6:.1f} MB, one-pass "
            f"+{(v['standard'] - v['two-pass']) / (K * nn * 4):.4f}·k·n·4"
            for nn, v in sorted(by_n.items())) + "; times " + ", ".join(
            f"{r['variant']} n={r['n']} {float(r['time_s']):.4f} s"
            for r in rows))

        # stability in f64 on the card against the published CPU f64 runs
        worst = {}
        for f, sc in (("exp", "well"), ("exp", "ill"), ("inv", "well"),
                      ("inv", "ill")):
            name = f"accuracy_{f}_{sc}-conditioned"
            (header, rows), _ = run_cli("experiments.stability", [
                "--function", f, "--scenario", f"{sc}-conditioned",
                *out(name)], tmp / f"{name}.csv")
            same_header("stability", header)
            _, pub = read_csv(RESULTS / f"{name}.csv")
            pub = {r["k"]: r for r in pub}
            check(len(rows) == 20 and all(r["k"] in pub for r in rows),
                  f"{name}: k grid {[r['k'] for r in rows]}")
            ratios = []
            for r in rows:
                for col in ("relative_error_standard",
                            "relative_error_two_pass"):
                    got, want = float(r[col]), float(pub[r["k"]][col])
                    check(within_10x(got, want),
                          f"{name} k={r['k']} {col}: {got:.3e} against the "
                          f"published {want:.3e}")
                    ratios.append(max(got, ACC_FLOOR) / max(want, ACC_FLOOR))
                dev_ = float(r["relative_solution_deviation"])
                check(dev_ <= 1e-10, f"{name} k={r['k']} deviation {dev_}")
            worst[name] = (min(ratios), max(ratios), max(
                float(r["relative_solution_deviation"]) for r in rows),
                float(rows[-1]["relative_error_two_pass"]))
        print("     stability f64 on the card against the published CPU "
              "f64 (min, max error ratio; max deviation; error at k=200): "
              + "; ".join(f"{nm[9:]} {a:.3g}, {b:.3g}; {d:.2e}; {e:.3e}"
                          for nm, (a, b, d, e) in worst.items()))
        for f, sc in (("inv", "ill"), ("exp", "well")):
            name = f"accuracy_{f}_{sc}-conditioned"
            (header, rows), _ = run_cli("experiments.stability", [
                "--function", f, "--scenario", f"{sc}-conditioned",
                "--k-min", "200", "--k-max", "200", "--precision", "df",
                *out(name + "_df")], tmp / f"{name}_df.csv")
            _, pub = read_csv(RESULTS / f"{name}.csv")
            e_df = float(rows[0]["relative_error_two_pass"])
            e_64 = float(next(r for r in pub if r["k"] == "200")[
                "relative_error_two_pass"])
            dev_ = float(rows[0]["relative_solution_deviation"])
            print(f"     stability --precision df {f}/{sc} k=200: error "
                  f"{e_df:.3e} (published f64 {e_64:.3e}), deviation "
                  f"{dev_:.2e}")
            check(e_df <= 10 * max(e_64, ACC_FLOOR) and dev_ < 1e-12,
                  f"df {name}: {e_df} against {e_64}, deviation {dev_}")

        name = "orthogonality_inv_ill-conditioned"
        (header, rows), _ = run_cli("experiments.orthogonality", [
            "--function", "inv", "--scenario", "ill-conditioned",
            "--k-min", "20", "--k-max", "200", "--k-step", "60", *out(name)],
            tmp / f"{name}.csv")
        same_header("orthogonality", header)
        _, pub = read_csv(RESULTS / f"{name}.csv")
        pub = {r["k"]: r for r in pub}
        for r in rows:
            check(float(r["basis_drift_fro"]) == 0.0,
                  f"basis_drift_fro {r['basis_drift_fro']} at k={r['k']}")
            # the loss grows from the recurrence's rounding: the JAX CPU
            # run's dots sum with ~10x the error of the port's, so below
            # 1e-8 the card may only be up to 10x LESS orthogonal than it
            for col in ("ortho_loss_standard", "ortho_loss_regenerated"):
                got, want = float(r[col]), float(pub[r["k"]][col])
                check(0 < got <= 10 * max(want, ACC_FLOOR) if want < 1e-8
                      else got > 1e-8,
                      f"{name} k={r['k']} {col}: {got:.3e} against the "
                      f"published {want:.3e}")
        print("     orthogonality inv/ill (f64, card | published): " + "; ".join(
            f"k={r['k']} {float(r['ortho_loss_standard']):.3e} | "
            f"{float(pub[r['k']]['ortho_loss_standard']):.3e}, drift "
            f"{r['basis_drift_fro']}" for r in rows))

        for name, module, argv in (
                ("certificate_study", "experiments.certificate_study",
                 ["--size", "500", "--k", "40"]),
                ("reorth_study", "experiments.reorth_study",
                 ["--function", "inv", "--scenario", "ill-conditioned",
                  "--size", "500", "--k-min", "20", "--k-max", "60"]),
                ("dense_tradeoff", "experiments.dense_tradeoff",
                 ["--size", "2000", "--k-start", "20", "--k-end", "40",
                  "--k-step", "20"])):
            t0 = time.perf_counter()
            (header, rows), _ = run_cli(module, [*argv, *out(name)],
                                        tmp / f"{name}.csv")
            same_header(name, header)
            check(rows, f"{name} wrote no row")
            print(f"     {name} {' '.join(argv)}: {len(rows)} rows in "
                  f"{time.perf_counter() - t0:.1f} s")

    # the K7 speed-of-light record at both sizes
    sol, paths["sol_bench"] = driven(lambda: [
        record(arcs, 3, 5, 64, None, dev) for arcs in (m, BIG["arcs"])])
    for rec, label in zip(sol, ("headline", "5M")):
        frac = rec["sol_fraction_ideal"]
        print(f"     sol_bench {rec['metric']}: "
              f"{1e3 * rec['seconds_per_matvec']:.5f} ms a matvec (the "
              f"kernels line's K7: {k7[label]['ms']:.5f} ms), "
              f"sol_fraction_ideal {frac:.4f}, layout "
              f"{rec['sol_fraction_layout']:.4f}, pad_ratio "
              f"{rec['pad_ratio']:.4f}, {rec['effective_gb_per_s']:.1f} "
              f"GB/s, hi {rec['timing']['hi']}, card {rec['card']}")
        check(0 < frac <= 1.05, f"sol_fraction_ideal {frac}")

    t0 = time.perf_counter()
    _, text = run_cli("tools.scaling_bench", [
        "--processes", "1", "--arcs", "100000", "--k", "50", "--reps", "1"])
    recs = [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{"metric"')]
    check(sorted(r["metric"] for r in recs) == [
        "scaling_fused_nproc1", "scaling_generic_nproc1"]
          and all(r["seconds_per_step"] > 0 and r["nnz_per_s"] > 0
                  and r["ndev"] == 1 and r["meaningful"] is False
                  and r["device"] == "cuda" for r in recs),
          f"scaling_bench records {recs}")
    print(f"     scaling_bench --processes 1 (NCCL, one rank) in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{r['metric']} {1e3 * r['seconds_per_step']:.4f} ms a step"
              for r in recs))
    wall = time.perf_counter() - t_phase
    print(f"     phase 24 wall {wall:.1f} s")
    return {"paths": paths, "wall": wall}


#: phase 25: the Hofstadter lattice's side, flux denominator and shift
HOF_SIDE, HOF_FLUX, HOF_SHIFT = 1024, 64, 0.5
#: its solve steps: the one-pass solve's, and eigsh's tolerance and cap
#: (those of tests/test_eigen_sharded.py's complex test)
HOF_K_ONE, HOF_EIG_TOL, HOF_EIG_MAXITER = 200, 1e-9, 200


def complex_phase(card, dev, t_real) -> dict:
    """Phase 25, first half: the complex Hermitian sparse tiers at the
    size of a lattice user's run (the module docstring lists the checks).
    ``t_real`` are phase 20's real row-sharded solve times. Returns the
    times."""
    import numpy as np
    import torch
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.models import hofstadter_triplets
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.ops.spmv import csr_from_triplets
    from two_pass_lanczos_tpu_torch.parallel import (
        ShardedSparseOperator,
        make_mesh,
    )

    t_phase = time.perf_counter()
    n, rows, cols, vals = hofstadter_triplets(HOF_SIDE, HOF_FLUX, HOF_SHIFT)
    coo = csr_from_triplets(n, n, rows, cols, vals, device="cpu")
    op = tpl.SparseOperator(coo, device=dev)
    rng = np.random.default_rng(25)
    b_np = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = torch.from_numpy(b_np).to(dev)
    build_s = time.perf_counter() - t_phase
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = tpl.solve_fAb(op, b, k=K, f="inv")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: v for k, v in LAUNCHES.items() if v}
    check(launched == {"csr_spmv": 2 * K - 1},
          f"the complex sparse solve launched {launched}, not {2 * K - 1} "
          f"K15")
    check(x.dtype == torch.complex128 and x.shape == (n,)
          and bool(torch.isfinite(torch.view_as_real(x)).all()),
          "complex x not a finite complex128 (n,) tensor")
    resid = float(torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b))
    check(resid <= 1e-10, f"complex solve residual {resid:.3e} > 1e-10")
    x_again = tpl.solve_fAb(op, b, k=K, f="inv")
    check(torch.equal(x, x_again), "two complex solves differ in their bits")
    dec, v1 = tpl.lanczos_standard(op, b, K)
    steps = dec.steps()
    _, v2 = tpl.lanczos_pass_two_with_basis(
        op, b, dec, torch.ones(K, dtype=b.dtype, device=dev))
    drift = float(torch.linalg.norm(v1[:steps] - v2[:steps]) ** 2)
    check(drift == 0.0 and torch.equal(v1[:steps], v2[:steps]),
          f"complex basis_drift_fro {drift:.3e}, not 0")
    del v1, v2
    d20 = tpl.lanczos_pass_one(op, b, K_CHECK)
    d20b = tpl.lanczos_pass_one(op, b, K_CHECK)
    check(torch.equal(d20.alphas, d20b.alphas)
          and torch.equal(d20.betas, d20b.betas),
          "complex pass one not bitwise reproducible")
    c20 = tpl.lanczos_pass_one(tpl.SparseOperator(coo, device="cpu"),
                               torch.from_numpy(b_np), K_CHECK)
    a_cpu = c20.alphas.numpy()
    scale = float(np.abs(a_cpu).max())
    gap = max(float(np.abs(d20.alphas.cpu().numpy() - a_cpu).max()),
              float(np.abs(d20.betas.cpu().numpy()
                           - c20.betas.numpy()).max()))
    check(gap <= 1e-11 * scale, f"complex alpha, beta at k={K_CHECK} "
                                f"{gap:.3e} from the CPU run")
    x1 = tpl.solve_fAb(op, b, k=HOF_K_ONE, f="inv", method="one_pass")
    rel_one = float(torch.linalg.norm(x1 - x) / torch.linalg.norm(x))
    check(rel_one <= 1e-12, f"complex one-pass k={HOF_K_ONE} rel "
                            f"{rel_one:.3e} from the two-pass solve")
    del x1
    torch.cuda.empty_cache()

    formed = not torch.distributed.is_initialized()
    mesh = make_mesh(1, device=dev)
    t0 = time.perf_counter()
    sop = ShardedSparseOperator(n, rows, cols, vals, mesh)
    sop_build_s = time.perf_counter() - t0
    reset_launches()
    xs, dec_s = sop.solve_fAb(b, k=K, f="inv")
    torch.cuda.synchronize()
    got_sh = {k: v for k, v in LAUNCHES.items() if v}
    check(sop.remote.nnz == 0 and got_sh == {"csr_spmv": 2 * K - 1},
          f"the complex row-sharded solve launched {got_sh}, not "
          f"{2 * K - 1} K15")
    x_np = x.cpu().numpy()
    rel_sh = float(np.linalg.norm(xs - x_np) / np.linalg.norm(x_np))
    check(xs.dtype == np.complex128 and rel_sh <= 1e-12,
          f"complex row-sharded x rel {rel_sh:.3e} from one card")
    t0 = time.perf_counter()
    eig = sop.eigsh(nev=2, which="LA", tol=HOF_EIG_TOL,
                    maxiter=HOF_EIG_MAXITER)
    eig_s = time.perf_counter() - t0
    eig_res = []
    for theta, u in zip(eig.eigenvalues, eig.eigenvectors):
        ut = torch.from_numpy(u).to(dev)
        eig_res.append(float(torch.linalg.norm(op.matvec(ut) - theta * ut)))
    check(eig.converged and max(eig_res) <= 1e-7,
          f"complex row-sharded eigsh: converged {eig.converged}, "
          f"residuals {eig_res}")
    t_one = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv"), 3)
    t_sh = wall_s(lambda: sop.solve_fAb(b, k=K, f="inv", raw=True), 3)
    del sop
    a_csr = torch.sparse_csr_tensor(op.mat.indptr, op.mat.cols, op.mat.vals,
                                    size=(n, n))
    k15 = k15_times(dev, op.mat, b, a_csr)
    del a_csr
    if formed:
        torch.distributed.destroy_process_group()
    print(f"[25] complex Hermitian sparse tiers: Hofstadter H + "
          f"{HOF_SHIFT}I on the periodic {HOF_SIDE}x{HOF_SIDE} lattice, "
          f"flux 1/{HOF_FLUX} (n={n}, nnz {coo.nnz}, complex128), built "
          f"in {build_s:.2f} s (row-sharded operator {sop_build_s:.2f} s); "
          f"solve_fAb(k={K}, f='inv') first call {first_s:.3f} s, "
          f"{2 * K - 1} K15 launches and nothing else, residual "
          f"{resid:.3e}, the same bits twice, "
          f"basis_drift_fro {drift} over {steps} steps; alpha, beta at "
          f"k={K_CHECK} max {gap:.3e} from the CPU run (max|alpha| "
          f"{scale:.3f}); one-pass k={HOF_K_ONE} rel {rel_one:.3e}; "
          f"row-sharded (one-rank NCCL) rel {rel_sh:.3e}, eigsh LA "
          f"{[float(t) for t in eig.eigenvalues]} residuals "
          f"{[f'{r:.2e}' for r in eig_res]} after {eig.restarts} restarts "
          f"in {eig_s:.2f} s")
    print(f"     on {card}: single-card complex two-pass solve k={K}: "
          f"{runs(t_one)}; row-sharded complex k={K}: {runs(t_sh)}; "
          f"phase 20's real f32 row-sharded k={K} (n=501155): "
          f"{runs(t_real)}; K15 (c128) device time {k15['ms']:.5f} ms warm, "
          f"{k15['cold_ms']:.5f} ms cold-L2, bound {k15['bound'][0]:.5f} ms, "
          f"plain {k15['plain_ms']:.5f} ms, cuSPARSE {k15['library_ms']:.5f} "
          f"ms (rel {k15['rel_lib']:.3e}); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"single_s": t_one, "sharded_s": t_sh, "k15": k15}


def entry_phase(card, dev) -> dict:
    """Phase 25, second half: ``entry()`` on the card (exactly 31 K8
    launches, x within 1e-3 of the f64 CPU solve) and
    ``dryrun_multichip(1)`` (every leg's check holds). Returns each path's
    launches, counters reset before it."""
    import numpy as np
    import torch
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.entry import (
        _tiny_kkt,
        dryrun_multichip,
        entry,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )

    forward, args = entry(device=dev)
    check(all(t.device.type == "cuda" for t in args), "entry()'s args off "
                                                      "the card")
    reset_launches()
    x = forward(*args)
    torch.cuda.synchronize()
    k8 = {k: v for k, v in LAUNCHES.items() if v}
    check(k8 == {"kkt_operator_matvec": 31},
          f"entry()'s forward launched {k8}, not 31 K8")
    d, u, v, p, b = _tiny_kkt()
    x64 = tpl.solve_fAb(tpl.KKTOperator(d.astype(np.float64), u, v, p,
                                        device="cpu"),
                        torch.from_numpy(b.astype(np.float64)), k=16,
                        f="inv").numpy()
    rel = float(np.linalg.norm(x.cpu().numpy() - x64) / np.linalg.norm(x64))
    check(rel <= 1e-3, f"entry() x rel {rel:.3e} from the f64 CPU solve")
    reset_counts()
    t0 = time.perf_counter()
    dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry = row_counts()
    for names, label in ((("kkt_streaming_matvec",
                           "kkt_shard_matvec_step_one"), "K7"),
                         (("df_kkt_streaming_matvec",), "K12"),
                         (("kkt_operator_matvec",), "K8"),
                         (("csr_spmv",), "K15")):
        check(sum(dry.get(name, 0) for name in names) > 0,
              f"dryrun_multichip(1) launched no {label}: {dry}")
    print(f"     entry() on {card}: forward x {tuple(x.shape)} "
          f"{str(x.dtype).split('.')[-1]}, K8 launches 31, rel {rel:.3e} "
          f"from the f64 CPU solve; dryrun_multichip(1) ok in {dry_s:.2f} s, "
          f"launches {dry}")
    return {"entry": k8, "dryrun_multichip": dry}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    if not (ROOT / "two_pass_lanczos_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: two_pass_lanczos_tpu_torch/ not found beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from two_pass_lanczos_tpu_torch import (
        FusedKKTSolver,
        generate_mcf_instance,
        padded_f_e1,
    )
    from two_pass_lanczos_tpu_torch.algorithms.core import (
        LanczosDecomposition,
        dot_f64,
        pass_one_chunk_scan,
        pass_one_last_vector,
        pass_one_scan,
        pass_two_scan,
    )
    from two_pass_lanczos_tpu_torch.ops import _build
    from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        PassOneBuffers,
        eft_check_cuda,
        kkt_matvec_cuda,
        pass_one_basis_cuda,
        pass_one_chunk_cuda,
        pass_one_cuda,
        pass_one_steps_cuda,
        pass_two_cuda,
        persistent_grid,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    # ptxas -v: one "Compiling entry" line per kernel instance, then its
    # spill and register lines; print a summary and any kernel that spills
    entries, regs, spills = 0, [], []
    name = ""
    for line in _build.build_log().splitlines():
        stores = re.search(r"(\d+) bytes spill stores", line)
        used = re.search(r"Used (\d+) registers", line)
        if "Compiling entry" in line:
            entries += 1
            name = line.split("'")[1] if "'" in line else line.strip()
        elif used:
            regs.append(int(used.group(1)))
        elif stores and int(stores.group(1)):
            spills.append(f"{name}: {line.strip()}")
        if (persistent_instance(name) != name
                and (used or "spill stores" in line)):
            print(f"    ptxas {persistent_instance(name)}: {line.strip()}")
    print(f"    ptxas: {entries} kernel instances, registers <= "
          f"{max(regs, default=0)} a thread, {len(spills)} with spills")
    for line in spills:
        print("    spills: " + line)
    grids = persistent_grid()
    print("    cooperative grids: " + ", ".join(
        f"{k_} {per_sm} blocks/SM x {sms} SMs = {per_sm * sms} blocks of 256"
        for k_, (per_sm, sms) in grids.items()))
    # one digest of the SASS of each source's kernels (those of namespace
    # tpl itself, the templates K1 and K8, as "tpl"): equal digests, equal
    # machine code (_build.sass_digests compares two builds kernel by kernel)
    sass = {}
    for key, digest in sorted(_build.sass_digests().items()):
        src = re.search(r"\{(\w+)_cu\}", key)
        sass.setdefault(src.group(1) if src else "tpl", []).append(digest)
    print("    sass digests: " + (", ".join(
        f"{src} ({len(d)}) "
        + hashlib.sha256("".join(d).encode()).hexdigest()[:12]
        for src, d in sass.items()) or "no cuobjdump"))

    # the headline instance, on the card
    inst = generate_mcf_instance(**HEADLINE)
    t0 = time.perf_counter()
    solver = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                            inst.num_nodes, device=dev)
    lay = solver.layout
    n = solver.n
    print(f"    headline m={lay.m} p={lay.p} n={n}; layout build + upload "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    def plain_mv(x):
        return kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)

    # 3. K1 against the plain matvec
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    y = kkt_matvec_cuda(lay, x)
    y_ref = plain_mv(x)
    torch.cuda.synchronize()
    m = lay.m
    check(torch.equal(y[:m], y_ref[:m]),
          "K1 arc part differs from the plain version's rounding")
    # node sums in two orders: |diff| <= 2·deg·eps·Σ|terms| per node
    absum = torch.zeros(lay.p, device=dev)
    absum.index_add_(0, lay.u, x[:m].abs()).index_add_(0, lay.v, x[:m].abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).float()
    bound = 2 * deg * torch.finfo(torch.float32).eps * absum
    node_err = (y[m:] - y_ref[m:]).abs()
    check(bool((node_err <= bound).all()), "K1 node part outside 2·deg·eps·Σ|x|")
    check(torch.equal(kkt_matvec_cuda(lay, x), y), "K1 not bitwise reproducible")
    err_k1 = float((y - y_ref).abs().max())
    print(f"[3] K1 ok: arc part bitwise equal, node max|err| "
          f"{float(node_err.max()):.3e} (bound min "
          f"{float(bound[deg > 0].min()):.3e}), max_abs_err {err_k1:.3e}")

    # 4. K2 against the plain pass one, k = 20
    dec = pass_one_cuda(lay, b, K_CHECK, solver.tol, solver.ztol)
    ref, _ = pass_one_scan(plain_mv, b, K_CHECK)
    torch.cuda.synchronize()
    check(dec.steps() == ref.steps() == K_CHECK,
          f"K2 steps {dec.steps()} vs plain {ref.steps()}")
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(dec.b_norm), float(ref.b_norm), rtol=1e-6)
    err_k2 = max(float((dec.alphas - ref.alphas).abs().max()),
                 float((dec.betas - ref.betas).abs().max()))
    print(f"[4] K2 ok at k={K_CHECK}: alpha, beta within rtol 1e-4, "
          f"max_abs_err {err_k2:.3e}, |alpha| max "
          f"{float(ref.alphas.abs().max()):.3e}")

    # 5. K3 against the plain pass two on the same decomposition
    y20 = padded_f_e1(dec, "inv") * dec.b_norm
    x3 = pass_two_cuda(lay, b, dec, y20, solver.ztol)
    x3_ref, _ = pass_two_scan(plain_mv, b, dec, y20)
    x3_k1, _ = pass_two_scan(lambda z: kkt_matvec_cuda(lay, z), b, dec, y20)
    torch.cuda.synchronize()
    rel3 = float(torch.linalg.norm(x3 - x3_ref) / torch.linalg.norm(x3_ref))
    check(rel3 < 1e-5, f"K3 rel {rel3:.3e} >= 1e-5")
    check(torch.equal(x3, x3_k1), "K3 differs from pass two on K1's matvec")
    err_k3 = float((x3 - x3_ref).abs().max())
    print(f"[5] K3 ok: rel {rel3:.3e} < 1e-5, max_abs_err {err_k3:.3e}; "
          f"bitwise the plain pass two on K1's matvec")

    # 6. the main path, through the kernels only
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_main, dec_main = solver.solve(b, k=K, f="inv", raw=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_launches = {name: c for name, c in LAUNCHES.items() if c}
    check(main_launches == {"lanczos_pass_one": 1, "lanczos_pass_two": 1,
                            "kkt_matvec_in_pass": 2 * K - 1},
          f"launches {main_launches}")
    # K1 launched no time: its routines ran as the passes' matvec phases,
    # which K1's row reports apart (``in_pass_matvecs``)
    launches = {name: LAUNCHES[name] for name in
                ("kkt_matvec", "lanczos_pass_one", "lanczos_pass_two")}
    in_pass_matvecs = LAUNCHES["kkt_matvec_in_pass"]
    check(tuple(x_main.shape) == (n,) and x_main.is_cuda, "x shape/device")
    check(bool(torch.isfinite(x_main).all()), "x is not finite")
    steps = dec_main.steps()
    print(f"[6] solve(k={K}, f='inv') first call {first_s:.4f} s, "
          f"steps_taken {steps}, launches {main_launches}")
    st1 = torch.empty(2, n, device=dev)
    st2 = torch.empty(2, n, device=dev)
    dec1 = solver.pass_one(b, K, state=st1)
    check(torch.equal(dec1.alphas, dec_main.alphas)
          and torch.equal(dec1.betas, dec_main.betas),
          "pass one not bitwise reproducible")
    keep = torch.arange(K, device=dev) < dec1.steps_taken
    y_full = torch.where(keep, padded_f_e1(dec1, "inv") * dec1.b_norm, 0.0)
    x_rep = solver.pass_two(b, dec1, y_full, state=st2)
    st_k1 = torch.empty(2, n, device=dev)
    x_k1, _ = pass_two_scan(lambda z: kkt_matvec_cuda(lay, z), b, dec1,
                            y_full, state=st_k1)
    torch.cuda.synchronize()
    check(torch.equal(pass_one_last_vector(dec1, st1), st2[1]),
          f"pass two's v_{steps} differs from pass one's")
    check(torch.equal(x_rep, x_k1) and torch.equal(st2, st_k1),
          f"K3's x or state at k={K} differs from pass two on K1's matvec")
    resid = float(torch.linalg.norm(solver.matvec(x_main) - b)
                  / torch.linalg.norm(b))
    print(f"    bitwise replay ok: pass two's v_{steps} == pass one's "
          f"(n={n}); K3's x and state bitwise pass two on K1's matvec; "
          f"x repeat bitwise equal: {torch.equal(x_rep, x_main)}; "
          f"||Ax-b||/||b|| = {resid:.4e}")
    # small instance: the card's solve against the CPU f64 plain oracle
    srng = np.random.default_rng(42)
    sm_, sp = 700, 300
    su = srng.integers(0, sp, sm_).astype(np.int32)
    sv = ((su + 1 + srng.integers(0, sp - 1, sm_)) % sp).astype(np.int32)
    sd = srng.uniform(1.0, 3.0, sm_).astype(np.float32)
    sb = srng.standard_normal(sm_ + sp)
    xs, _ = FusedKKTSolver(sd, su, sv, sp, device=dev).solve(
        sb.astype(np.float32), k=25, f="inv")
    t64 = torch.from_numpy
    sdec, _ = pass_one_scan(
        lambda v: kkt_matvec(t64(sd.astype(np.float64)), t64(su), t64(sv), sp, v),
        t64(sb), 25)
    sy = padded_f_e1(sdec, "inv") * sdec.b_norm
    xs_ref, _ = pass_two_scan(
        lambda v: kkt_matvec(t64(sd.astype(np.float64)), t64(su), t64(sv), sp, v),
        t64(sb), sdec, sy)
    rel_small = float(np.linalg.norm(xs - xs_ref.numpy())
                      / np.linalg.norm(xs_ref.numpy()))
    check(rel_small < 1e-4, f"small-instance rel {rel_small:.3e} vs f64 oracle")
    print(f"    small instance (m=700, p=300, k=25) vs CPU f64 oracle: "
          f"rel {rel_small:.3e} < 1e-4")
    solver_c = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                              inst.num_nodes, device=dev, compensated=True)

    # 7. timings (the Lanczos state is L2-resident in a real pass, so the
    #    kernels are timed warm, back to back)
    def solve_k(k):
        return lambda: solver.solve(b, k=k, f="inv", raw=True)

    def plain_solve():
        d_, _ = pass_one_scan(plain_mv, b, K)
        yy = torch.where(torch.arange(K, device=dev) < d_.steps_taken,
                         padded_f_e1(d_, "inv") * d_.b_norm, 0.0)
        return pass_two_scan(plain_mv, b, d_, yy)

    def never_stop(s_, v_, t_):
        return True

    def plain_chunked(k, chunk):
        carry = None
        for j0 in range(0, k, chunk):
            _, _, carry = pass_one_chunk_scan(plain_mv, b, min(chunk, k - j0),
                                              carry, k)
            int(carry.steps)  # the per-chunk read back, as the solver does
        return carry

    ea = torch.full((128,), 1.0 + 2.0 ** -12, device=dev)
    eb = torch.full((128,), 2.0 ** -30, device=dev)
    t_plain1 = wall_s(plain_solve, 1)
    t500 = wall_s(solve_k(K), 5)
    t1000 = wall_s(solve_k(K_LONG), 3)
    t_one = wall_s(lambda: solver.solve(b, k=K, f="inv", method="one_pass",
                                        raw=True), 5)
    t_cb = wall_s(lambda: solver.solve(b, k=K, f="inv", raw=True,
                                       callback=never_stop,
                                       callback_chunk=CHUNK), 5)
    t_comp = wall_s(lambda: solver_c.solve(b, k=K, f="inv", raw=True), 5)
    t_plain2 = wall_s(plain_solve, 1)
    ms = {
        "kkt_matvec": device_ms(lambda: kkt_matvec_cuda(lay, x), 200),
        "lanczos_pass_one": event_ms(
            lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol), 3),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_cuda(lay, b, dec1, y_full, solver.ztol), 3),
        "lanczos_pass_one_basis": event_ms(
            lambda: pass_one_basis_cuda(lay, b, K, solver.tol, solver.ztol), 3),
        "lanczos_pass_one_chunk": event_ms(
            lambda: solver.pass_one_chunked(b, K, chunk=CHUNK), 3),
        "lanczos_pass_one_comp": event_ms(
            lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol,
                                  compensated=True), 3),
        "eft_check": device_ms(lambda: eft_check_cuda(ea, eb), 200),
    }
    plain_ms = {
        "kkt_matvec": device_ms(lambda: plain_mv(x), 200),
        "lanczos_pass_one": event_ms(lambda: pass_one_scan(plain_mv, b, K), 1),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_scan(plain_mv, b, dec1, y_full), 1),
        "lanczos_pass_one_basis": event_ms(
            lambda: pass_one_scan(plain_mv, b, K, emit_basis=True), 1),
        "lanczos_pass_one_chunk": event_ms(lambda: plain_chunked(K, CHUNK), 1),
        "lanczos_pass_one_comp": event_ms(
            lambda: pass_one_scan(plain_mv, b, K, dot=dot_f64), 1),
        "eft_check": device_ms(lambda: eft_check_plain(ea, eb), 200),
    }
    k1_call_ms = event_ms(lambda: kkt_matvec_cuda(lay, x), 200)
    # the per-step launches K2, K4 and K5 replaced (pass_one_steps_cuda):
    # K steps from b in one call; with K4's basis rows; and in K5's chunks,
    # each followed by the chunk's one read back, as pass_one_chunked does
    bufs6 = PassOneBuffers.alloc(lay, K)

    def six_launch():
        pass_one_steps_cuda(lay, bufs6, b, 0, K, solver.tol, solver.ztol)

    def six_launch_basis():
        pass_one_steps_cuda(lay, PassOneBuffers.alloc(lay, K), b, 0, K,
                            solver.tol, solver.ztol,
                            basis=torch.zeros(K, n, device=dev))

    def chunk_loop(run, bufs):
        for j0 in range(0, K, CHUNK):
            c = min(CHUNK, K - j0)
            run(lay, bufs, b, j0, c, solver.tol, solver.ztol)
            torch.cat([bufs.alphas[j0:j0 + c], bufs.betas[j0:j0 + c],
                       bufs.steps.float(), bufs.flags[:1].float(),
                       bufs.bnorm]).cpu()

    six_ms = event_ms(six_launch, 3)
    six_graph_ms = device_ms(six_launch, 1)
    check(torch.equal(bufs6.alphas, dec1.alphas)
          and torch.equal(bufs6.betas, dec1.betas),
          "the per-step launches differ from K2")
    # K4, K5's chunk loop, K6 (its K2 instance), and the per-step launches
    # of each, in turns (route, reference, reference, route): the means of
    # both turns
    k4_ms = {"K4": [], "per-step": []}
    k5_ms = {"K5": [], "per-step": []}
    k6_ms = {"K6": [], "per-step": []}
    k5_bufs = PassOneBuffers.alloc(lay, K, persistent=True)
    bufs6c = PassOneBuffers.alloc(lay, K)

    def six_launch_comp():
        pass_one_steps_cuda(lay, bufs6c, b, 0, K, solver.tol, solver.ztol,
                            compensated=True)

    for turn in (0, 1):
        for route in ("K4", "per-step") if turn == 0 else ("per-step", "K4"):
            k4_ms[route].append(event_ms(
                six_launch_basis if route == "per-step" else
                lambda: pass_one_basis_cuda(lay, b, K, solver.tol,
                                            solver.ztol), 3))
        for route in ("K5", "per-step") if turn == 0 else ("per-step", "K5"):
            k5_ms[route].append(event_ms(
                (lambda: chunk_loop(pass_one_chunk_cuda, k5_bufs))
                if route == "K5" else
                (lambda: chunk_loop(pass_one_steps_cuda, bufs6)), 3))
        for route in ("K6", "per-step") if turn == 0 else ("per-step", "K6"):
            k6_ms[route].append(event_ms(
                six_launch_comp if route == "per-step" else
                lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol,
                                      compensated=True), 3))
    k4_ms = {route: statistics.mean(t) for route, t in k4_ms.items()}
    k5_ms = {route: statistics.mean(t) for route, t in k5_ms.items()}
    k6_ms = {route: statistics.mean(t) for route, t in k6_ms.items()}
    check(torch.equal(k5_bufs.alphas, dec1.alphas),
          "K5's timed chunks differ from K2")
    dec6c = pass_one_cuda(lay, b, K, solver.tol, solver.ztol,
                          compensated=True)
    torch.cuda.synchronize()
    check(torch.equal(bufs6c.alphas, dec6c.alphas)
          and torch.equal(bufs6c.betas, dec6c.betas),
          "K6's timed per-step launches differ from K6")

    print(f"[7] on {card}:")
    print(f"    solve k={K}: {runs(t500)}")
    print(f"    solve k={K_LONG}: {runs(t1000)}")
    print(f"    one-pass solve k={K}: {runs(t_one)}")
    print(f"    callback solve k={K} (never stops, chunk {CHUNK}): "
          f"{runs(t_cb)}")
    print(f"    compensated two-pass solve k={K}: {runs(t_comp)}")
    print(f"    plain PyTorch solve k={K} on the card: "
          f"{', '.join(f'{t:.4f}' for t in t_plain1 + t_plain2)} s")
    for name in ms:
        print(f"    {name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms")
    print(f"    kkt_matvec per call from Python (CUDA events, 200 calls): "
          f"{k1_call_ms:.4f} ms")
    print(f"    K2, one cooperative launch: {ms['lanczos_pass_one']:.4f} ms a "
          f"pass, {1e3 * ms['lanczos_pass_one'] / K:.3f} us a step; the "
          f"per-step launches ({K} steps in one call): {six_ms:.4f} ms a pass, "
          f"{1e3 * six_ms / K:.3f} us a step, as one CUDA-graph replay "
          f"{six_graph_ms:.4f} ms, {1e3 * six_graph_ms / K:.3f} us a step")
    print(f"    K3, one cooperative launch: {ms['lanczos_pass_two']:.4f} ms a "
          f"pass, {1e3 * ms['lanczos_pass_two'] / max(steps - 1, 1):.3f} us "
          f"a step ({steps - 1} steps)")
    for route, t in k4_ms.items():
        label = ("K4, one cooperative launch" if route == "K4" else
                 "the per-step launches with the basis rows")
        print(f"    {label}: {t:.4f} ms a pass, {1e3 * t / K:.3f} us a step "
              f"(each call zeroes its 1.0 GB basis)")
    print(f"    K5's chunk loop (chunks of {CHUNK}, one cooperative launch "
          f"and one read back each): {k5_ms['K5']:.4f} ms a pass, "
          f"{1e3 * k5_ms['K5'] / K:.3f} us a step; the per-step launches in "
          f"the same loop: {k5_ms['per-step']:.4f} ms a pass, "
          f"{1e3 * k5_ms['per-step'] / K:.3f} us a step; the whole "
          f"pass_one_chunked {ms['lanczos_pass_one_chunk']:.4f} ms")
    for route, t in k6_ms.items():
        label = ("K6 (the compensated K2 instance), one cooperative launch"
                 if route == "K6" else "the compensated per-step launches")
        print(f"    {label}: {t:.4f} ms a pass, {1e3 * t / K:.3f} us a step "
              f"(in turns)")
    split = timed_split(lay, b, solver, dec1, y_full, x_rep)
    in_pass_us = {name: got["matvec phase"]["max_us"]
                  for name, got in split.items()}

    # 7b. the fused solver at 5M arcs
    t0 = time.perf_counter()
    big = generate_mcf_instance(**BIG)
    print(f"     5M instance m={big.num_arcs} p={big.num_nodes} generated in "
          f"{time.perf_counter() - t0:.3f} s")
    fused_big_phase(card, dev, big)
    torch.cuda.empty_cache()
    # 7c. the warp rows of K1, K8 and K7 against their block-row references
    rows_ms = warp_rows_phase(card, dev, [("headline", inst), ("5M", big)])

    # 8. K4: pass one with the basis, bitwise the per-step launches it
    #    replaced (every row), K2 and both passes' v_steps
    dec4, basis, _ = k4_routes(lay, b, K, solver.tol, solver.ztol)
    check(torch.equal(dec4.alphas, dec1.alphas)
          and torch.equal(dec4.betas, dec1.betas)
          and dec4.steps() == dec1.steps(), "K4 alpha/beta/steps differ from K2")
    check(torch.equal(basis[steps - 1], pass_one_last_vector(dec1, st1))
          and torch.equal(basis[steps - 1], st2[1]),
          f"K4 basis row {steps - 1} is not pass one's and pass two's v_{steps}")
    del basis
    dec4s, basis_s, _ = k4_routes(lay, b, K_CHECK, solver.tol, solver.ztol)
    ref4, basis_ref = pass_one_scan(plain_mv, b, K_CHECK, emit_basis=True)
    torch.cuda.synchronize()
    rel4 = float(torch.linalg.norm(basis_s - basis_ref)
                 / torch.linalg.norm(basis_ref))
    check(rel4 <= 1e-5, f"K4 basis rel {rel4:.3e} > 1e-5 at k={K_CHECK}")
    np.testing.assert_allclose(dec4s.alphas.cpu().numpy(),
                               ref4.alphas.cpu().numpy(), rtol=1e-4)
    err_k4 = max(float((basis_s - basis_ref).abs().max()),
                 float((dec4s.alphas - ref4.alphas).abs().max()),
                 float((dec4s.betas - ref4.betas).abs().max()))
    # a breakdown: all arcs share their endpoints, the Krylov space is tiny
    bm, bp = 130, 130
    bsolver = FusedKKTSolver(np.full(bm, 2.0, np.float32),
                             np.zeros(bm, np.int32), np.ones(bm, np.int32),
                             bp, device=dev)
    bb_ = torch.zeros(bm + bp, device=dev)
    bb_[0] = 1.0
    decb, basis_b = bsolver.pass_one_with_basis(bb_, 12)
    sb_ = decb.steps()
    check(0 < sb_ < 12 and bool((basis_b[sb_:] == 0).all())
          and bool(torch.isfinite(basis_b).all()),
          f"K4 rows past the breakdown at {sb_} are not zero")
    reset_launches()
    x_one, dec_one = solver.solve(b, k=K, f="inv", method="one_pass", raw=True)
    torch.cuda.synchronize()
    one_launches = {name: c for name, c in LAUNCHES.items() if c}
    check(one_launches == {"lanczos_pass_one_basis": 1,
                           "kkt_matvec_in_pass": K},
          f"one-pass launches {one_launches}")
    launches["lanczos_pass_one_basis"] = 1
    in_pass = {"lanczos_pass_one_basis": K}
    rel_one = float(torch.linalg.norm(x_one - x_main)
                    / torch.linalg.norm(x_main))
    check(rel_one <= 1e-4, f"one-pass x rel {rel_one:.3e} > 1e-4 vs two-pass")
    # x = V_k·y stays full f32 when the caller allows TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    x_tf32, _ = solver.solve(b, k=K, f="inv", method="one_pass", raw=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(x_tf32, x_one), "one-pass x changed under allow_tf32")
    print(f"[8] K4 ok: alpha, beta, ||b||, steps, state and every basis row "
          f"bitwise the per-step launches at k={K_CHECK} and {K}; alpha, "
          f"beta, steps bitwise K2's at "
          f"k={K}; basis row {steps - 1} bitwise v_{steps} of both passes; "
          f"basis rel {rel4:.3e} vs plain at k={K_CHECK}; rows past the "
          f"breakdown at step {sb_} zero; one-pass x vs two-pass x rel "
          f"{rel_one:.3e}, bitwise the same under allow_tf32; one-pass "
          f"launches {one_launches}")

    # 9. K5: the resumable pass one, bitwise the per-step launches it
    #    replaced, in chunks of 7 at k = K_CHECK and of CHUNK at k = K
    k5_routes(lay, b, K_CHECK, 7, solver.tol, solver.ztol)
    k5_routes(lay, b, K, CHUNK, solver.tol, solver.ztol)
    dec5 = solver.pass_one_chunked(b, K, chunk=CHUNK)
    check(torch.equal(dec5.alphas, dec1.alphas)
          and torch.equal(dec5.betas, dec1.betas)
          and dec5.steps() == dec1.steps(), "K5 alpha/beta/steps differ from K2")
    reset_launches()
    dec_stop = solver.pass_one_chunked(
        b, K, callback=lambda s_, v_, t_: s_ < STOP_AT, chunk=CHUNK)
    stop_mv = LAUNCHES["kkt_matvec_in_pass"]
    bound = -(-STOP_AT // CHUNK) * CHUNK
    check(dec_stop.steps() == STOP_AT, f"stopped at {dec_stop.steps()}")
    check(stop_mv <= bound and LAUNCHES["kkt_matvec"] == 0,
          f"{stop_mv} pass-one matvecs > {bound}, or a K1 launch")
    check(torch.equal(dec_stop.alphas[:STOP_AT], dec1.alphas[:STOP_AT])
          and bool((dec_stop.alphas[STOP_AT:] == 0).all()),
          "K5 alpha prefix differs from K2's")
    dec5s = solver.pass_one_chunked(b, K_CHECK, chunk=8)
    carry = None
    a5, b5 = [], []
    for j0 in range(0, K_CHECK, 8):
        a_, b_, carry = pass_one_chunk_scan(plain_mv, b, 8, carry, K_CHECK)
        a5.append(a_[:K_CHECK - j0])
        b5.append(b_[:K_CHECK - j0])
    a5, b5 = torch.cat(a5), torch.cat(b5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dec5s.alphas.cpu().numpy(), a5.cpu().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(dec5s.betas.cpu().numpy(), b5.cpu().numpy(),
                               rtol=1e-4)
    err_k5 = max(float((dec5s.alphas - a5).abs().max()),
                 float((dec5s.betas - b5).abs().max()))
    reset_launches()
    x_cb, dec_cb = solver.solve(b, k=K, f="inv", raw=True,
                                callback=never_stop, callback_chunk=CHUNK)
    torch.cuda.synchronize()
    cb_launches = {name: c for name, c in LAUNCHES.items() if c}
    check(cb_launches == {"lanczos_pass_one_chunk": -(-K // CHUNK),
                          "lanczos_pass_two": 1,
                          "kkt_matvec_in_pass": 2 * K - 1},
          f"callback solve launches {cb_launches}")
    launches["lanczos_pass_one_chunk"] = -(-K // CHUNK)
    in_pass["lanczos_pass_one_chunk"] = K
    rel_cb = float(torch.linalg.norm(x_cb - x_main) / torch.linalg.norm(x_main))
    check(rel_cb <= 1e-6, f"callback solve x rel {rel_cb:.3e} vs two-pass")
    print(f"[9] K5 ok: alpha, beta, ||b||, steps, live flag and state "
          f"bitwise the per-step launches at k={K_CHECK} (chunks of 7) and "
          f"k={K} (chunks of {CHUNK}); chunk {CHUNK} bitwise K2 at k={K}; "
          f"stop at {STOP_AT} after {stop_mv} <= {bound} matvecs, alpha "
          f"prefix bitwise; rtol 1e-4 vs plain at k={K_CHECK}, chunk 8 "
          f"(max_abs_err {err_k5:.3e}); never-stopping callback solve x vs "
          f"two-pass x rel {rel_cb:.3e} (bitwise: "
          f"{torch.equal(x_cb, x_main)}); launches {cb_launches}")

    # 10. K6: the compensated instances of K2, K4 and K5, bitwise the
    #     compensated per-step launches, and the compensated main path
    comp_routes(lay, b, K_CHECK, 7, solver.tol, solver.ztol)
    comp_routes(lay, b, K, CHUNK, solver.tol, solver.ztol)
    reset_launches()
    sc = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                        inst.num_nodes, device=dev, compensated=True)
    launches["eft_check"] = LAUNCHES["eft_check"]
    check(launches["eft_check"] == 1, f"launches {dict(LAUNCHES)}")
    reset_launches()
    x_c, dec_c = sc.solve(b, k=K, f="inv", raw=True)
    torch.cuda.synchronize()
    comp_launches = {name: c for name, c in LAUNCHES.items() if c}
    check(comp_launches == {"lanczos_pass_one_comp": 1, "lanczos_pass_two": 1,
                            "kkt_matvec_in_pass": 2 * K - 1}
          and LAUNCHES["kkt_matvec"] == 0,
          f"compensated solve launches {comp_launches}")
    launches["lanczos_pass_one_comp"] = 1
    in_pass["lanczos_pass_one_comp"] = K
    check(bool(torch.isfinite(x_c).all()), "compensated x is not finite")
    dec6 = sc.pass_one(b, K_CHECK)
    ref6, _ = pass_one_scan(plain_mv, b, K_CHECK, dot=dot_f64)
    torch.cuda.synchronize()
    rtol6 = float(((dec6.alphas - ref6.alphas).abs()
                   / ref6.alphas.abs()).max())
    np.testing.assert_allclose(dec6.alphas.cpu().numpy(),
                               ref6.alphas.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(dec6.betas.cpu().numpy(),
                               ref6.betas.cpu().numpy(), rtol=1e-5)
    err_k6 = max(float((dec6.alphas - ref6.alphas).abs().max()),
                 float((dec6.betas - ref6.betas).abs().max()))
    # rtol 1e-5 alone would pass an uncompensated build (plain K2 sits ~2e-7
    # relative from the f64-dot version): the compensated kernel must sit
    # well inside plain K2's own distance from it, measured here
    err_k2_f64 = max(float((dec.alphas - ref6.alphas).abs().max()),
                     float((dec.betas - ref6.betas).abs().max()))
    check(err_k2_f64 > 0 and err_k6 <= 0.25 * err_k2_f64,
          f"compensated max_abs_err {err_k6:.3e} vs the f64-dot version is "
          f"not <= 0.25x plain K2's {err_k2_f64:.3e} at k={K_CHECK}")
    # the instance of tests/test_fused.py::test_compensated_alphas_closer_to_f64
    # (m=1200, p=300, seed 42): at k=6 the f32 vector updates, which no
    # reduction compensates, are of the same size as the dot errors, so
    # the comparison is instance-dependent; this one is the JAX test's
    k6 = 6
    crng = np.random.default_rng(42)
    cm, cp = 1200, 300
    cu = crng.integers(0, cp, cm).astype(np.int32)
    cv = ((cu + 1 + crng.integers(0, cp - 1, cm)) % cp).astype(np.int32)
    cd = crng.uniform(1.0, 3.0, cm).astype(np.float32)
    cb32 = crng.standard_normal(cm + cp).astype(np.float32)
    o64, _ = pass_one_scan(  # the CPU f64 oracle on the same f32 inputs
        lambda v: kkt_matvec(t64(cd.astype(np.float64)), t64(cu), t64(cv), cp, v),
        t64(cb32.astype(np.float64)), k6)
    a64 = o64.alphas.numpy()
    a_p = FusedKKTSolver(cd, cu, cv, cp, device=dev).pass_one(cb32, k6)
    a_c = FusedKKTSolver(cd, cu, cv, cp, device=dev,
                         compensated=True).pass_one(cb32, k6)
    err_p = float(np.abs(a_p.alphas.cpu().numpy().astype(np.float64) - a64).max())
    err_c = float(np.abs(a_c.alphas.cpu().numpy().astype(np.float64) - a64).max())
    check(err_c < err_p, f"compensated alpha err {err_c:.3e} not below "
          f"plain K2's {err_p:.3e}")
    reset_launches()
    dec_cc = sc.pass_one_chunked(b, K, chunk=CHUNK)
    dec_c1, basis_c = sc.pass_one_with_basis(b, K)
    torch.cuda.synchronize()
    other_launches = {name: c for name, c in LAUNCHES.items() if c}
    check(other_launches == {"lanczos_pass_one_comp": -(-K // CHUNK) + 1,
                             "kkt_matvec_in_pass": 2 * K},
          f"compensated chunked and one-pass launches {other_launches}")
    for name, dd in (("chunked", dec_cc), ("one-pass", dec_c1)):
        check(torch.equal(dd.alphas, dec_c.alphas)
              and torch.equal(dd.betas, dec_c.betas),
              f"compensated {name} differs from compensated monolithic")
    del basis_c
    print(f"[10] K6 ok: its K2, K4 (rows too) and K5 instances bitwise the "
          f"compensated per-step launches at k={K_CHECK} (chunks of 7) and "
          f"{K} (chunks of {CHUNK}); solve launches {comp_launches}, no K1; "
          f"chunked (chunk {CHUNK}) and one-pass launches {other_launches}; "
          f"rtol {rtol6:.3e} <= 1e-5 "
          f"vs plain f64-dot pass one at k={K_CHECK} (max_abs_err "
          f"{err_k6:.3e} <= 0.25x plain K2's {err_k2_f64:.3e}); m={cm}, "
          f"p={cp}, k={k6}: max|alpha - alpha_f64| compensated {err_c:.3e} "
          f"< plain K2 {err_p:.3e}; chunked and one-pass bitwise the "
          f"monolithic compensated run at k={K}")

    # 11. K13: the error-free transformations, exact on the card
    got = eft_check_cuda(ea, eb)
    exact = torch.tensor([1.0 + 2.0 ** -12, 2.0 ** -30, 1.0 + 2.0 ** -11,
                          2.0 ** -24, 1.0 + 2.0 ** -12, 2.0 ** -30],
                         device=dev)[:, None].expand(6, 128)
    torch.cuda.synchronize()
    check(torch.equal(got, exact), f"EFT values not exact: {got[:, 0]}")
    check(torch.equal(eft_check_plain(ea, eb), exact), "EFT twin not exact")
    err_k13 = float((got - exact).abs().max())
    print("[11] K13 ok: two_sum, two_prod, df_add2 exact on the card")

    # 12. K8: the generic KKT operators' matvec
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.convert import operator_from_jax
    from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops import spmv_kernel
    from two_pass_lanczos_tpu_torch.testing import (
        check_reconstruction_stability,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    arrays = KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dtype=torch.float32)  # card, K8
    check(isinstance(op, tpl.CudaKKTOperator) and op.device.type == "cuda"
          and op.dtype == torch.float32, f"make_kkt_operator gave {op!r}")
    op64 = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                                 inst.num_nodes, dtype=torch.float64)
    lay8, lay64 = op.layout, op64.layout

    y8 = op.matvec(x)
    y8_ref = kkt_matvec(lay8.d, lay8.u, lay8.v, lay8.p, x)
    torch.cuda.synchronize()
    check(torch.equal(y8, y), "K8 f32 differs from K1 on the same x")
    check(torch.equal(y8[:m], y8_ref[:m]), "K8 f32 arc part not bitwise")
    check(bool(((y8[m:] - y8_ref[m:]).abs()
                <= node_bound(lay8, x, torch.finfo(torch.float32).eps)).all()),
          "K8 f32 node part outside 2·deg·eps·Σ|x|")
    check(torch.equal(op.matvec(x), y8), "K8 f32 not bitwise reproducible")
    err_k8 = float((y8 - y8_ref).abs().max())
    x64 = x.double()
    y64 = op64.matvec(x64)
    y64_ref = kkt_matvec(lay64.d, lay64.u, lay64.v, lay64.p, x64)
    torch.cuda.synchronize()
    check(y64.dtype == torch.float64 and torch.equal(y64[:m], y64_ref[:m]),
          "K8 f64 arc part not bitwise")
    check(bool(((y64[m:] - y64_ref[m:]).abs()
                <= node_bound(lay64, x64,
                              torch.finfo(torch.float64).eps)).all()),
          "K8 f64 node part outside 2·deg·eps·Σ|x|")
    err_k8_64 = float((y64 - y64_ref).abs().max())

    # a PallasKKTOperator's fields, as operator_from_jax reads them (NumPy)
    pal = type("PallasKKTOperator", (), {})()
    m_pad = -(-m // 2048) * 2048  # the TPU kernel's padding, dropped again
    pal.d_pad = np.zeros(m_pad, np.float32)
    pal.d_pad[:m] = inst.quad_costs
    pal.u_pad = np.zeros(m_pad, np.int32)
    pal.u_pad[:m] = inst.arc_u
    pal.v_pad = np.zeros(m_pad, np.int32)
    pal.v_pad[:m] = inst.arc_v
    pal.num_arcs, pal.num_nodes = m, inst.num_nodes
    op_conv = operator_from_jax(pal)
    check(isinstance(op_conv, tpl.CudaKKTOperator)
          and torch.equal(op_conv.matvec(x), y8),
          "operator_from_jax's CudaKKTOperator differs from the KKT operator")
    coo32 = kkt_sorted_coo(arrays, dtype=np.float32)
    a_csr = torch.sparse_csr_tensor(coo32.indptr, coo32.cols, coo32.vals,
                                    size=(n, n))
    y_lib = torch.mv(a_csr, x)
    torch.cuda.synchronize()
    rel_lib = float(torch.linalg.norm(y_lib - y8) / torch.linalg.norm(y8))
    check(rel_lib < 1e-6, f"cuSPARSE SpMV rel {rel_lib:.3e} vs K8")
    print(f"[12] K8 ok: f32 bitwise K1 and arc part bitwise plain, node part "
          f"within bound, max_abs_err {err_k8:.3e}; f64 arc part bitwise, "
          f"node part within bound, max_abs_err {err_k8_64:.3e}; the "
          f"converted Pallas operator gives the same y; cuSPARSE CSR SpMV "
          f"(nnz {coo32.nnz}) rel {rel_lib:.3e}")

    # 13. the generic two-pass path on the headline, through K8 only
    plain_calls = []
    plain_mv_orig = spmv_kernel.kkt_matvec

    def counted_plain(*args):
        plain_calls.append(1)
        return plain_mv_orig(*args)

    spmv_kernel.kkt_matvec = counted_plain  # the operators' only plain route
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_gen = tpl.solve_fAb(op, b, k=K, f="inv")
    torch.cuda.synchronize()
    gen_first = time.perf_counter() - t0
    launches["kkt_operator_matvec"] = LAUNCHES["kkt_operator_matvec"]
    gen_launches = dict(LAUNCHES)
    check(LAUNCHES["kkt_operator_matvec"] == 2 * K - 1
          and sum(gen_launches.values()) == 2 * K - 1 and not plain_calls,
          f"generic launches {gen_launches}, plain calls {len(plain_calls)}")
    check(tuple(x_gen.shape) == (n,) and bool(torch.isfinite(x_gen).all()),
          "generic x not finite")
    reset_launches()
    x_host = tpl.lanczos_two_pass(op, b, K, tpl.make_inv_solver())
    torch.cuda.synchronize()
    host_launches = LAUNCHES["kkt_operator_matvec"]
    reset_launches()
    x_gen1 = tpl.lanczos(op, b, K, tpl.make_inv_solver())
    torch.cuda.synchronize()
    one_launches = LAUNCHES["kkt_operator_matvec"]
    spmv_kernel.kkt_matvec = plain_mv_orig
    check(host_launches == 2 * K - 1 and one_launches == K and not plain_calls,
          f"host path {host_launches}, one-pass {one_launches} launches")
    rel_host = float(torch.linalg.norm(x_host - x_gen)
                     / torch.linalg.norm(x_gen))
    rel_gen1 = float(torch.linalg.norm(x_gen1 - x_gen)
                     / torch.linalg.norm(x_gen))
    rel_fused = float(torch.linalg.norm(x_gen - x_main)
                      / torch.linalg.norm(x_main))
    dec_s, basis_s = tpl.lanczos_standard(op, b, K)
    steps_g = dec_s.steps()
    _, regen = tpl.lanczos_pass_two_with_basis(
        op, b, dec_s, torch.ones(K, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(regen[:steps_g], basis_s[:steps_g]),
          "generic pass two's basis differs from lanczos_standard's")
    del regen
    # x_gen and x_host are pass two over this one basis and differ only in
    # y = f(T_500)·e1·‖b‖, solved in f32 on the card (solve_fAb) and on the
    # host (make_inv_solver): hold each y to the f64 solve of the same α, β
    # and the x gap to what the y gap can make of it through the basis
    dec_p = tpl.lanczos_pass_one(op, b, K)
    check(steps_g == K and torch.equal(dec_p.alphas, dec_s.alphas)
          and torch.equal(dec_p.betas, dec_s.betas),
          "pass one's alpha, beta differ with and without the basis")
    y_gen = (padded_f_e1(dec_p, "inv") * dec_p.b_norm).to(b.dtype)
    al_, be_ = dec_p.alphas_valid(), dec_p.betas_valid()
    y_host = (torch.as_tensor(tpl.make_inv_solver()(al_, be_)).to(dev)
              * dec_p.b_norm)
    check(torch.equal(tpl.lanczos_pass_two(op, b, dec_p, y_gen), x_gen)
          and torch.equal(tpl.lanczos_pass_two(op, b, dec_p, y_host), x_host),
          "an x is not pass two of its own y")
    # the card's solve code is right: in f64 it gives the host's f64 answer
    # to within 10·κ(T)·ε64 ...
    bn_ = float(dec_p.b_norm)
    y_f64 = host_f_tk_solve(al_, be_, "inv") * bn_
    dec_p64 = LanczosDecomposition(
        alphas=dec_p.alphas.double(), betas=dec_p.betas.double(),
        steps_taken=dec_p.steps_taken, b_norm=dec_p.b_norm.double())
    y_card64 = (padded_f_e1(dec_p64, "inv") * dec_p64.b_norm).cpu().numpy()
    tk = np.diag(al_.astype(np.float64)) + np.diag(be_, 1) + np.diag(be_, -1)
    lam_t = np.abs(np.linalg.eigvalsh(tk))
    kappa = float(lam_t.max() / lam_t.min())
    eps32 = float(np.finfo(np.float32).eps)
    eps64 = float(np.finfo(np.float64).eps)
    rel_card64 = float(np.linalg.norm(y_card64 - y_f64) / np.linalg.norm(y_f64))
    check(rel_card64 <= 10 * kappa * eps64,
          f"padded_f_e1 in f64 on the card rel {rel_card64:.3e} from the "
          f"host's f64 solve, above 10·κ·ε64 = {10 * kappa * eps64:.3e}")
    # ... and each f32 y solves T y = ‖b‖e1 to a backward error of 10·ε32,
    # so its distance from the f64 answer is the f32 rounding of an
    # ill-conditioned solve
    tnorm = float(np.linalg.norm(tk, 2))
    rhs = np.zeros(K)
    rhs[0] = bn_
    back_y, rel_y = {}, {}
    for name, yy in (("card", y_gen), ("host", y_host)):
        y_ = yy.double().cpu().numpy()
        back_y[name] = float(np.linalg.norm(tk @ y_ - rhs)
                             / (tnorm * np.linalg.norm(y_)))
        rel_y[name] = float(np.linalg.norm(y_ - y_f64) / np.linalg.norm(y_f64))
    check(max(back_y.values()) <= 10 * eps32,
          f"f32 solves of T_{K} with backward errors {back_y} above 10·ε32")
    vd = basis_s.double()
    gram = vd @ vd.T
    v_norm = float(torch.linalg.eigvalsh(gram).max().sqrt())
    orth_loss = float((gram - torch.eye(K, dtype=gram.dtype, device=dev))
                      .abs().max())
    col = gram.diagonal().sqrt()
    del vd, gram, basis_s
    dy = float(torch.linalg.norm(y_gen.double() - y_host.double()))
    slack = (K + 1) * eps32 * float((y_gen.double().abs() * col).sum()
                                    + (y_host.double().abs() * col).sum())
    gap = float(torch.linalg.norm(x_gen.double() - x_host.double()))
    check(gap <= 1.001 * (v_norm * dy + slack),
          f"x gap {gap:.4e} above ‖V‖₂·‖Δy‖ + rounding = "
          f"{v_norm * dy:.4e} + {slack:.4e}")
    rel_alpha_fused = float((dec_main.alphas - dec_p.alphas).abs().max()
                            / dec_p.alphas.abs().max())
    dec_g = tpl.lanczos_pass_one(op, b, K_CHECK)
    np.testing.assert_allclose(dec_g.alphas.cpu().numpy(),
                               dec.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec_g.betas.cpu().numpy(),
                               dec.betas.cpu().numpy(), rtol=1e-4)
    sop = tpl.make_kkt_operator(sd, su, sv, sp)
    xs_gen = tpl.lanczos_two_pass(sop, sb.astype(np.float32), 25,
                                  tpl.make_inv_solver()).cpu().numpy()
    rel_small_gen = float(np.linalg.norm(xs_gen - xs_ref.numpy())
                          / np.linalg.norm(xs_ref.numpy()))
    check(rel_small_gen < 1e-4,
          f"generic small-instance rel {rel_small_gen:.3e} vs f64 oracle")
    print(f"[13] generic solve_fAb(k={K}, f='inv') first call "
          f"{gen_first:.4f} s, launches {gen_launches}, plain matvecs "
          f"{len(plain_calls)}; basis of lanczos_pass_two_with_basis bitwise "
          f"lanczos_standard's, rows 0..{steps_g - 1} (n={n}); alpha, beta "
          f"within rtol 1e-4 of K2 at k={K_CHECK}; x vs host path rel "
          f"{rel_host:.3e}, vs generic one-pass rel {rel_gen1:.3e}, vs the "
          f"fused solve rel {rel_fused:.3e}; lanczos_two_pass {host_launches}"
          f" and lanczos {one_launches} K8 launches; small instance vs CPU "
          f"f64 oracle rel {rel_small_gen:.3e}")
    print(f"     both x are pass two of their own y, bitwise; kappa(T_{K}) "
          f"{kappa:.4e}; padded_f_e1 in f64 on the card vs the host's f64 "
          f"solve rel {rel_card64:.3e} <= 10·kappa·eps64 "
          f"{10 * kappa * eps64:.3e}; f32 y backward error card "
          f"{back_y['card']:.3e}, host {back_y['host']:.3e} <= 10·eps32; "
          f"f32 y vs the f64 solve: card rel {rel_y['card']:.3e}, host rel "
          f"{rel_y['host']:.3e}; x gap {gap:.4e} <= "
          f"||V||_2 {v_norm:.4f} x ||dy|| {dy:.4e} + rounding {slack:.3e} "
          f"(gap / bound {gap / (v_norm * dy + slack):.4f}); "
          f"max|V V^T - I| {orth_loss:.3e}; fused vs generic alpha at k={K} "
          f"max rel {rel_alpha_fused:.3e}")

    # 14. f64 and the other operators on the card
    eigs = np.arange(1.0, 101.0)
    db = np.random.default_rng(12345).standard_normal(100)
    dop = tpl.DiagonalOperator(eigs)
    rel_diag = {}
    for name, f_tk, fx, tol in (
            ("inv", tpl.make_inv_solver(), 1.0 / eigs, 1e-3),
            ("exp", tpl.make_exp_solver(), np.exp(eigs), 1e-3),
            ("z2", tpl.make_poly_solver([0.0, 0.0, 1.0]), eigs ** 2, 1e-12)):
        xd_ = tpl.lanczos_two_pass(dop, db, 30, f_tk).cpu().numpy()
        rel_diag[name] = float(np.linalg.norm(xd_ - fx * db)
                               / np.linalg.norm(fx * db))
        check(rel_diag[name] < tol,
              f"f64 diagonal {name}: rel {rel_diag[name]:.3e} >= {tol}")
    frng = np.random.default_rng(42)
    fm, fp = M_F64, 2_000
    fu = frng.integers(0, fp, fm).astype(np.int32)
    fv = ((fu + 1 + frng.integers(0, fp - 1, fm)) % fp).astype(np.int32)
    fd = frng.uniform(1.0, 3.0, fm)
    fop = tpl.make_kkt_operator(fd, fu, fv, fp, dtype=torch.float64)
    fb = torch.from_numpy(frng.standard_normal(fm + fp)).to(dev)
    reset_launches()
    dec_f, basis_f = tpl.lanczos_standard(fop, fb, K_F64)
    _, regen_f = tpl.lanczos_pass_two_with_basis(
        fop, fb, dec_f, torch.ones(K_F64, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    check(LAUNCHES["kkt_operator_matvec"] == 2 * K_F64 - 1,
          f"f64 launches {dict(LAUNCHES)}")
    check(torch.equal(regen_f, basis_f), "f64 KKT basis not replayed bitwise")
    del basis_f, regen_f
    small = KKTArrays(quad_costs=sd.astype(np.float64), arc_u=su, arc_v=sv,
                      num_nodes=sp, num_arcs=sm_)
    spop = tpl.SparseOperator(kkt_sorted_coo(small))
    sp_b = torch.from_numpy(sb).to(dev)
    drift = check_reconstruction_stability(spop, sp_b, 30).value
    check(drift == 0.0, f"SparseOperator basis drift {drift} != 0")
    check(torch.equal(spop.matvec(sp_b), spop.matvec(sp_b)),
          "SparseOperator matvec not reproducible")
    print(f"[14] f64 DiagonalOperator two-pass vs analytic: "
          + ", ".join(f"{k_} rel {v_:.3e}" for k_, v_ in rel_diag.items())
          + f"; f64 KKT m={fm}, p={fp}, k={K_F64}: basis bitwise; "
          f"SparseOperator (nnz {spop.mat.nnz}) drift {drift} at k=30")

    t_gen = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv"), 5)
    t_gen1 = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv",
                                          method="one_pass"), 5)
    t_host = wall_s(lambda: tpl.lanczos_two_pass(op, b, K,
                                                 tpl.make_inv_solver()), 3)
    ms["kkt_operator_matvec"] = device_ms(lambda: op.matvec(x), 200)
    plain_ms["kkt_operator_matvec"] = device_ms(lambda: plain_mv(x), 200)
    lib_ms = device_ms(lambda: torch.mv(a_csr, x), 200)
    ms_k8_64 = device_ms(lambda: op64.matvec(x64), 200)
    k8_call_ms = event_ms(lambda: op.matvec(x), 200)
    lib_call_ms = event_ms(lambda: torch.mv(a_csr, x), 200)
    print(f"    on {card}: generic two-pass solve_fAb k={K}: {runs(t_gen)}")
    print(f"    generic one-pass solve_fAb k={K}: {runs(t_gen1)}")
    print(f"    generic lanczos_two_pass (host path) k={K}: {runs(t_host)}")
    print(f"    kkt_operator_matvec device time: kernel "
          f"{ms['kkt_operator_matvec']:.5f} ms (f64 {ms_k8_64:.5f} ms), "
          f"plain {plain_ms['kkt_operator_matvec']:.5f} ms, cuSPARSE CSR "
          f"SpMV {lib_ms:.5f} ms; per call from Python (CUDA events): "
          f"kernel {k8_call_ms:.4f} ms, cuSPARSE {lib_call_ms:.4f} ms")

    # 14, continued. K15, the CSR SpMV of the sparse operators, on the
    # headline's assembled f32 matrix: the generic solve on a SparseOperator
    spop32 = tpl.SparseOperator(coo32)
    reset_launches()
    x15 = tpl.solve_fAb(spop32, b, k=K, f="inv")
    torch.cuda.synchronize()
    got15 = {k_: v_ for k_, v_ in LAUNCHES.items() if v_}
    check(got15 == {"csr_spmv": 2 * K - 1},
          f"the SparseOperator solve launched {got15}, not {2 * K - 1} K15")
    launches["csr_spmv"] = got15["csr_spmv"]
    check(tuple(x15.shape) == (n,) and bool(torch.isfinite(x15).all())
          and torch.equal(x15, tpl.solve_fAb(spop32, b, k=K, f="inv")),
          "the SparseOperator solve's x not finite or not the same bits twice")
    dec15, v15 = tpl.lanczos_standard(spop32, b, K)
    _, regen15 = tpl.lanczos_pass_two_with_basis(
        spop32, b, dec15, torch.ones(K, dtype=b.dtype, device=dev))
    steps15 = dec15.steps()
    check(torch.equal(v15[:steps15], regen15[:steps15]),
          f"SparseOperator basis not replayed bitwise at k={K}")
    del v15, regen15
    a15 = tpl.lanczos_pass_one(spop32, b, K_CHECK).alphas.cpu().numpy()
    a8 = tpl.lanczos_pass_one(op, b, K_CHECK).alphas.cpu().numpy()
    np.testing.assert_allclose(a15, a8, rtol=1e-4)
    k15 = k15_times(dev, coo32, x, a_csr)
    ms["csr_spmv"], plain_ms["csr_spmv"] = k15["ms"], k15["plain_ms"]
    t_sp = wall_s(lambda: tpl.solve_fAb(spop32, b, k=K, f="inv"), 5)
    print(f"[14] K15 (csr_spmv) on the headline's f32 SortedCOO (nnz "
          f"{coo32.nnz}, {coo32.blocks.numel() - 1} row blocks): "
          f"solve_fAb(SparseOperator, k={K}) {got15['csr_spmv']} K15 "
          f"launches and nothing else, the same bits twice, the basis "
          f"replayed bitwise over {steps15} steps, alpha at k={K_CHECK} "
          f"within rtol 1e-4 of K8's (max rel "
          f"{float(np.abs(a15 - a8).max() / np.abs(a8).max()):.3e}); y "
          f"within the plain sum's bound (max gap {k15['err']:.3e}), "
          f"cuSPARSE rel {k15['rel_lib']:.3e}")
    print(f"    on {card}: K15 device time {k15['ms']:.5f} ms warm, "
          f"{k15['cold_ms']:.5f} ms cold-L2, bound {k15['bound'][0]:.5f} ms "
          f"({k15['bound'][1]}); plain (gather, multiply, segment_reduce) "
          f"{k15['plain_ms']:.5f} ms; cuSPARSE CSR SpMV "
          f"{k15['library_ms']:.5f} ms; generic two-pass "
          f"solve_fAb(SparseOperator) k={K}: {runs(t_sp)}")
    del spop32

    # 15. K11: the double-float matvec on the headline, f64 costs
    from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, DFKKTOperator
    from two_pass_lanczos_tpu_torch.algorithms.df import lanczos_pass_one_df
    from two_pass_lanczos_tpu_torch.ops import kkt_fused_df
    from two_pass_lanczos_tpu_torch.ops.df import DF, df_from_f64
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_kkt_matvec_cuda,
        df_kkt_matvec_pairs_cuda,
        df_pass_one_last_vector,
    )

    dfop = DFKKTOperator.from_f64(inst.quad_costs, inst.arc_u, inst.arc_v,
                                  inst.num_nodes, device=dev)
    check(torch.equal(dfop.d2[0], lay64.d.float())
          and bool((dfop.d2[1] != 0).any()),
          "the df costs are not the exact split of the f64 costs")
    dlay = dfop.layout
    xdf = df_from_f64(x64 * (1.0 + 1e-9 * x64))  # a lo plane that is not 0
    x2 = torch.stack([xdf.hi, xdf.lo])
    x_sp = x2[0].double() + x2[1].double()
    y2 = df_kkt_matvec_cuda(dlay, dfop.d2, x2)
    y2_ref = dfop.plain_matvec_df(xdf)
    torch.cuda.synchronize()
    check(torch.equal(y2[0, :m], y2_ref.hi[:m])
          and torch.equal(y2[1, :m], y2_ref.lo[:m]),
          "K11 arc part differs from the plain version's rounding")
    y_df = y2[0].double() + y2[1].double()
    y_df_ref = y2_ref.hi.double() + y2_ref.lo.double()
    # two compensated folds of a node sum, the plain version's final
    # df_sub one more: 8·(deg+1)·2^-48·Σ|x|
    bound_df = df_node_bound(dlay, x2)
    node_err_df = (y_df[m:] - y_df_ref[m:]).abs()
    check(bool((node_err_df <= bound_df).all()),
          "K11 node part outside 8·(deg+1)·2^-48·Σ|x|")
    check(torch.equal(df_kkt_matvec_cuda(dlay, dfop.d2, x2), y2),
          "K11 not bitwise reproducible")
    # the pair instance: the same values as (hi, lo) pairs, bit for bit
    xp = x2.T.contiguous()
    yp = df_kkt_matvec_pairs_cuda(dlay, dfop.d2, xp)
    torch.cuda.synchronize()
    check(torch.equal(yp.T, y2), "the pair K11 is not bitwise the planar K11")
    y_k8 = op64.matvec(x_sp)
    rel_k8 = float(torch.linalg.norm(y_df - y_k8) / torch.linalg.norm(y_k8))
    check(rel_k8 < 1e-13, f"K11 vs K8 f64 rel {rel_k8:.3e} >= 1e-13")
    err_k11 = float((y_df - y_df_ref).abs().max())
    coo64 = kkt_sorted_coo(arrays)
    a_csr64 = torch.sparse_csr_tensor(coo64.indptr, coo64.cols, coo64.vals,
                                      size=(n, n))
    rel_lib64 = float(torch.linalg.norm(torch.mv(a_csr64, x_sp) - y_k8)
                      / torch.linalg.norm(y_k8))
    check(rel_lib64 < 1e-13, f"cuSPARSE f64 SpMV rel {rel_lib64:.3e} vs K8")
    print(f"[15] K11 ok: arc part bitwise the plain version in hi and lo, "
          f"the pair instance bitwise the planar one, "
          f"node part max|err| {float(node_err_df.max()):.3e} within "
          f"8·(deg+1)·2^-48·Σ|x| (min over nodes {float(bound_df.min()):.3e})"
          f", max_abs_err {err_k11:.3e}; vs K8 f64 rel {rel_k8:.3e}; "
          f"cuSPARSE f64 CSR SpMV rel {rel_lib64:.3e}")

    # 16. K9 and K10: the df main path, through the kernels only
    plain_df = []
    patched = [(DFKKTOperator, "plain_matvec_df"),
               (kkt_fused_df, "_pass_one_df"), (kkt_fused_df, "_pass_two_df")]
    originals = [getattr(o, a) for o, a in patched]

    def counted_df(fn):
        def wrapper(*args, **kw):
            plain_df.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper

    sdf = DFFusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, device=dev)
    b64 = b.double()
    for (o, a), fn in zip(patched, originals):
        setattr(o, a, counted_df(fn))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_df, (al_df, be_df, steps_df) = sdf.solve(b64, k=K, f="inv")
    torch.cuda.synchronize()
    df_first = time.perf_counter() - t0
    df_launches = dict(LAUNCHES)
    for (o, a), fn in zip(patched, originals):
        setattr(o, a, fn)
    for name in ("df_kkt_matvec", "df_lanczos_pass_one",
                 "df_lanczos_pass_two"):
        launches[name] = df_launches[name]
    # K11 launched no time: its rows ran as the phases of K9 and K10, which
    # K11's row reports apart (``in_pass_matvecs``)
    df_in_pass_matvecs = df_launches["df_kkt_matvec_in_pass"]
    check(df_launches["df_lanczos_pass_one"] == 1
          and df_launches["df_lanczos_pass_two"] == 1
          and df_launches["df_kkt_matvec"] == 0
          and df_in_pass_matvecs == 2 * K - 1
          and sum(df_launches.values()) == 2 * K + 1 and not plain_df,
          f"df launches {df_launches}, plain df calls {plain_df}")
    check(tuple(x_df.shape) == (n,) and x_df.dtype == torch.float64
          and x_df.is_cuda and bool(torch.isfinite(x_df).all()),
          "df x not a finite f64 (n,) tensor on the card")
    b2 = sdf.pack(b64)
    st1 = torch.empty(2, 2, n, device=dev)
    st2 = torch.empty(2, 2, n, device=dev)
    coeffs = sdf.pass_one(b2, K, state=st1)
    a_rep = (coeffs[0].double() + coeffs[1].double()).cpu().numpy()
    check(int(coeffs[5][0]) == steps_df
          and np.array_equal(a_rep[:steps_df], al_df),
          "df pass one not bitwise reproducible")
    y2_solve = df_y(coeffs, K)
    y_h, y_l = y2_solve
    x2_rep = sdf.pass_two(b2, coeffs, y_h, y_l, state=st2)
    torch.cuda.synchronize()
    check(torch.equal(df_pass_one_last_vector(coeffs, st1), st2[1]),
          f"df pass two's v_{steps_df} differs from pass one's (hi or lo)")
    check(torch.equal(sdf.unpack64(x2_rep), x_df), "df x not reproducible")
    # K9 and K10 bitwise the per-step launches they replaced
    for kk in (K_CHECK, K):
        df_routes(sdf, b2, kk)
    # k = 20 against the f64 generic pass one (K8 f64) and the plain df one
    dec64_20 = tpl.lanczos_pass_one(op64, b64, K_CHECK)
    c20 = sdf.pass_one(b2, K_CHECK)
    a20 = (c20[0].double() + c20[1].double()).cpu().numpy()
    b20 = (c20[2].double() + c20[3].double()).cpu().numpy()
    atol20 = 1e-11 * float(dec64_20.alphas.abs().max())
    da64 = float(np.abs(a20 - dec64_20.alphas.cpu().numpy()).max())
    db64 = float(np.abs(b20[:K_CHECK - 1]
                        - dec64_20.betas.cpu().numpy()[:K_CHECK - 1]).max())
    check(int(c20[5][0]) == K_CHECK and max(da64, db64) <= atol20,
          f"df alpha/beta at k={K_CHECK} {da64:.3e}/{db64:.3e} from f64, "
          f"above 1e-11·max|alpha| = {atol20:.3e}")
    ref20 = lanczos_pass_one_df(dfop, b64, K_CHECK)
    ra20 = (ref20.alphas.hi.double() + ref20.alphas.lo.double()).cpu().numpy()
    rb20 = (ref20.betas.hi.double() + ref20.betas.lo.double()).cpu().numpy()
    err_k9 = max(float(np.abs(a20 - ra20).max()),
                 float(np.abs(b20 - rb20).max()))
    check(err_k9 <= atol20, f"K9 vs plain df pass one {err_k9:.3e} > "
          f"{atol20:.3e} at k={K_CHECK}")
    y20 = host_f_tk_solve(a20, b20[:K_CHECK - 1], "inv") * float(
        c20[4][0].double() + c20[4][1].double())
    y20h = torch.from_numpy(y20.astype(np.float32)).to(dev)
    y20l = torch.from_numpy((y20 - y20.astype(np.float32).astype(np.float64))
                            .astype(np.float32)).to(dev)
    x20 = sdf.unpack64(sdf.pass_two(b2, c20, y20h, y20l))
    dec20 = kkt_fused_df.DFDecomposition(
        alphas=DF(c20[0], c20[1]), betas=DF(c20[2], c20[3]),
        steps_taken=c20[5].reshape(()), b_norm=DF(c20[4][0], c20[4][1]))
    x20_ref, _, _ = kkt_fused_df._pass_two_df(
        dfop, DF(b2[0], b2[1]), dec20, DF(y20h, y20l), False)
    x20_ref = x20_ref.hi.double() + x20_ref.lo.double()
    rel_k10 = float(torch.linalg.norm(x20 - x20_ref)
                    / torch.linalg.norm(x20_ref))
    check(rel_k10 < 1e-12, f"K10 vs plain df pass two rel {rel_k10:.3e}")
    err_k10 = float((x20 - x20_ref).abs().max())
    # the small instance against the CPU f64 oracle
    xs_df, _ = DFFusedKKTSolver(sd.astype(np.float64), su, sv, sp,
                                device=dev).solve(sb, k=25, f="inv")
    rel_small_df = float(np.linalg.norm(xs_df.cpu().numpy() - xs_ref.numpy())
                         / np.linalg.norm(xs_ref.numpy()))
    check(rel_small_df < 1e-9,
          f"df small-instance rel {rel_small_df:.3e} vs f64 oracle")
    # how far df and f32 drift from an f64 run over the headline's steps
    a64_k = tpl.lanczos_pass_one(op64, b64, K).alphas.cpu().numpy()
    a32_k = dec1.alphas.double().cpu().numpy()
    drift = {kk: (float(np.abs(al_df[:kk] - a64_k[:kk]).max()),
                  float(np.abs(a32_k[:kk] - a64_k[:kk]).max()))
             for kk in (100, 200, K)}
    scale_a = float(np.abs(a64_k).max())

    def onset(a, tol):
        """The first step whose alpha sits more than tol·max|alpha_f64|
        from the f64 run's, or None."""
        far = np.nonzero(np.abs(a[:steps_df] - a64_k[:steps_df])
                         > tol * scale_a)[0]
        return int(far[0]) + 1 if len(far) else None
    print(f"[16] df solve(k={K}, f='inv') first call {df_first:.4f} s, "
          f"steps_taken {steps_df}, launches "
          f"{ {k_: c for k_, c in df_launches.items() if c} }, plain df "
          f"calls {len(plain_df)}; pass two's v_{steps_df} bitwise pass "
          f"one's in hi and lo (n={n}); K9's alpha, beta (hi, lo), ||b||, "
          f"steps and state and K10's x and state bitwise the per-step "
          f"launches at k={K_CHECK} and k={K}; alpha, beta at k={K_CHECK} "
          f"vs f64 (K8) "
          f"{da64:.3e} / {db64:.3e} <= 1e-11·max|alpha| {atol20:.3e}; K9 vs "
          f"plain df {err_k9:.3e}; K10 vs plain df rel {rel_k10:.3e}; small "
          f"instance vs CPU f64 oracle rel {rel_small_df:.3e}")
    print(f"     max|alpha - alpha_f64| (max|alpha_f64| {scale_a:.6e}): "
          + "; ".join(f"k<={kk}: df {d_:.3e}, f32 K2 {f_:.3e}"
                      for kk, (d_, f_) in drift.items()))
    print("     first step with |alpha - alpha_f64| > tol·max|alpha_f64|: "
          + "; ".join(f"tol {tol:g}: df {onset(al_df, tol)}, f32 K2 "
                      f"{onset(a32_k, tol)}" for tol in (1e-12, 1e-6, 1e-2)))

    t_df = wall_s(lambda: sdf.solve(b64, k=K, f="inv"), 5)
    # the same solve on the per-step launches K9 and K10 replaced: the
    # solver's passes pointed at the reference routes for these runs only
    swapped = [(kkt_fused_df, "df_pass_one_cuda",
                kkt_fused_df.df_pass_one_steps_cuda),
               (kkt_fused_df, "df_pass_two_cuda",
                kkt_fused_df.df_pass_two_steps_cuda)]
    kept = [getattr(o, a) for o, a, _ in swapped]
    for o, a, fn in swapped:
        setattr(o, a, fn)
    try:
        x_steps, _ = sdf.solve(b64, k=K, f="inv")
        t_df_steps = wall_s(lambda: sdf.solve(b64, k=K, f="inv"), 5)
    finally:
        for (o, a, _), fn in zip(swapped, kept):
            setattr(o, a, fn)
    check(torch.equal(x_steps, x_df),
          "the df solve on the per-step launches differs from K9/K10's")
    # K11's ms is the pair instance's (the layout of the rows inside K9 and
    # K10), planar_ms the planar one's (DFKKTOperator, the references)
    ms["df_kkt_matvec"] = device_ms(
        lambda: df_kkt_matvec_pairs_cuda(dlay, dfop.d2, xp), 200)
    k11_planar_ms = device_ms(
        lambda: df_kkt_matvec_cuda(dlay, dfop.d2, x2), 200)
    plain_ms["df_kkt_matvec"] = device_ms(
        lambda: dfop.plain_matvec_df(xdf), 20)
    lib64_ms = device_ms(lambda: torch.mv(a_csr64, x_sp), 200)
    ms["df_lanczos_pass_one"] = event_ms(lambda: sdf.pass_one(b2, K), 3)
    ms["df_lanczos_pass_two"] = event_ms(
        lambda: sdf.pass_two(b2, coeffs, y_h, y_l), 3)
    steps_route_ms = {
        "df_lanczos_pass_one": event_ms(
            lambda: kkt_fused_df.df_pass_one_steps_cuda(
                sdf.layout, sdf.d2, b2, K, sdf.tol, sdf.ztol), 3),
        "df_lanczos_pass_two": event_ms(
            lambda: kkt_fused_df.df_pass_two_steps_cuda(
                sdf.layout, sdf.d2, b2, coeffs, y2_solve, sdf.ztol), 3)}
    dec_k = kkt_fused_df.DFDecomposition(
        alphas=DF(coeffs[0], coeffs[1]), betas=DF(coeffs[2], coeffs[3]),
        steps_taken=coeffs[5].reshape(()),
        b_norm=DF(coeffs[4][0], coeffs[4][1]))
    bdf = DF(b2[0], b2[1])
    plain_ms["df_lanczos_pass_one"] = event_ms(
        lambda: kkt_fused_df._pass_one_df(dfop, bdf, K, False), 1)
    plain_ms["df_lanczos_pass_two"] = event_ms(
        lambda: kkt_fused_df._pass_two_df(dfop, bdf, dec_k, DF(y_h, y_l),
                                          False), 1)
    print(f"    on {card}: df two-pass solve k={K}: {runs(t_df)}; on the "
          f"per-step launches K9 and K10 replaced: {runs(t_df_steps)}")
    for name in ("df_kkt_matvec", "df_lanczos_pass_one",
                 "df_lanczos_pass_two"):
        print(f"    {name}: kernel {ms[name]:.5f} ms, plain "
              f"{plain_ms[name]:.5f} ms")
    print(f"    df_kkt_matvec: pair instance {ms['df_kkt_matvec']:.5f} ms, "
          f"planar instance {k11_planar_ms:.5f} ms")
    t_gen_df = generic_df_routes(dfop, b64)
    print(f"    generic df solve_fAb_df k={K}, DFKKTOperator on "
          + "; on ".join(f"the {route} K11: {runs(ts)}"
                         for route, ts in t_gen_df.items()))
    for name, label, nsteps in (("df_lanczos_pass_one", "K9", K),
                                ("df_lanczos_pass_two", "K10",
                                 max(steps_df - 1, 1))):
        print(f"    {label}, one cooperative launch: {ms[name]:.4f} ms a "
              f"pass, {1e3 * ms[name] / nsteps:.3f} us a step; the per-step "
              f"launches: {steps_route_ms[name]:.4f} ms a pass, "
              f"{1e3 * steps_route_ms[name] / nsteps:.3f} us a step")
    print(f"    cuSPARSE f64 CSR SpMV (nnz {coo64.nnz}) {lib64_ms:.5f} ms")
    df_split = df_timed_split(sdf, b2, coeffs, y2_solve, x2_rep)
    df_in_pass_us = {name: got["matvec phase"]["max_us"]
                     for name, got in df_split.items()}
    df_big_phase(card, dev, big)

    # 17-18. the sharded solvers on a one-rank NCCL group (NCCL refuses
    #        two ranks on one card), at the headline and at 5M arcs
    from two_pass_lanczos_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device=dev)
    check(mesh.size == 1 and mesh.backend == "nccl"
          and torch.distributed.get_backend(mesh.group) == "nccl",
          f"mesh {mesh}")
    k7 = sharded_f32_phase(card, dev, mesh, [("headline", inst), ("5M", big)])
    k_step = shard_step_phase(card, dev, big)
    k12 = sharded_df_phase(card, dev, mesh, [("headline", inst, dfop),
                                             ("5M", big, None)])
    # 19. the K14 probes; 20. the row-sharded operator on the same group
    k14, k13_floor = probes_phase(card, dev,
                                  [("headline", inst), ("5M", big)])
    t_real = sparse_phase(card, dev, mesh, inst)
    # 21. the capability methods of the fused tier; 22. reorthogonalisation
    #     and block Lanczos on K8; 23. the sharded tiers' capability methods
    #     on the same one-rank group
    t21 = time.perf_counter()
    cap = capability_phase(card, dev, inst, solver, solver_c, b)
    print(f"     phase 21 wall {time.perf_counter() - t21:.1f} s")
    p22 = reorth_block_phase(card, dev, inst, b)
    p23 = sharded_capability_phase(card, dev, mesh, inst, solver, b)
    torch.distributed.destroy_process_group()
    # 24. the experiment CLIs and the measurement tools
    p24 = tools_phase(card, dev, inst, k7)
    # 25. complex Hermitian operators in the sparse tiers; the twin of
    #     __graft_entry__.py
    c25 = complex_phase(card, dev, t_real)
    p25 = entry_phase(card, dev)
    for extra in (p22, p23):
        cap["paths"].update(extra["paths"])
    for name, got in (("kkt_streaming_matvec", k7["headline"]),
                      ("df_kkt_streaming_matvec", k12["headline"]),
                      *k14.items()):
        launches[name] = got["launches"]
        ms[name], plain_ms[name] = got["ms"], got["plain_ms"]

    bounds = kernel_bounds(m, n, steps, K)
    for name in ("df_lanczos_pass_one", "df_lanczos_pass_two"):
        bounds[name] = kernel_bounds(m, n, steps_df, K)[name]
    # the fused sharded step: its launches on phase 17's headline main path,
    # the rest phase 17b's at the 4-card cell's shard
    for name in STEP_ROWS:
        got = k_step[name]
        launches[name] = k7["headline"]["step_launches"].get(name, 0)
        ms[name], plain_ms[name] = got["ms"], got["plain_ms"]
        bounds[name] = got["bound"]
    library = {"kkt_matvec": lib_ms, "kkt_operator_matvec": lib_ms,
               "df_kkt_matvec": lib64_ms,
               "kkt_streaming_matvec": k7["headline"]["library_ms"],
               "df_kkt_streaming_matvec": k12["headline"]["library_ms"],
               **{name: got["library_ms"] for name, got in k14.items()},
               "csr_spmv": k15["library_ms"],
               **{name: k_step[name]["library_ms"] for name in STEP_ROWS}}
    errs = {**{name: got["err"] for name, got in k14.items()},
            "kkt_matvec": err_k1, "lanczos_pass_one": err_k2,
            "lanczos_pass_two": err_k3, "lanczos_pass_one_basis": err_k4,
            "lanczos_pass_one_chunk": err_k5, "lanczos_pass_one_comp": err_k6,
            "eft_check": err_k13, "kkt_operator_matvec": err_k8,
            "df_kkt_matvec": err_k11, "df_lanczos_pass_one": err_k9,
            "df_lanczos_pass_two": err_k10,
            "kkt_streaming_matvec": k7["headline"]["err"],
            "df_kkt_streaming_matvec": k12["headline"]["err"],
            "csr_spmv": k15["err"],
            **{name: k_step[name]["err"] for name in STEP_ROWS}}
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errs[name],
             "ms": ms[name], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "library_ms": library.get(name)}
            for name, (src, rep) in KERNELS.items()]
    k1_row = next(r for r in rows if r["name"] == "kkt_matvec")
    # K1's rows ran as phases inside K2 and K3 (the main path), K4 (the
    # one-pass solve), K5 (the callback solve's pass one) and K6 (the
    # compensated solve's)
    k1_row["in_pass_matvecs"] = in_pass_matvecs + sum(in_pass.values())
    k1_row["in_pass_us"] = in_pass_us
    for r in rows:
        if r["name"] in in_pass:
            r["in_pass_matvecs"] = in_pass[r["name"]]
            r["step_us"] = 1e3 * r["ms"] / K
    # K1, K8 and K7 beside their block-row references (phase 7c), in turns
    for r in rows:
        name = {"kkt_matvec": "K1", "kkt_operator_matvec": "K8 f64",
                "kkt_streaming_matvec": "K7"}.get(r["name"])
        if name:
            r["blockrows_ms"] = {label: got[name]["blockrows_ms"]
                                 for label, got in rows_ms.items()}
            r["warp_rows_ms"] = {label: got[name]["ms"]
                                 for label, got in rows_ms.items()}
    # the fused step's rows: warm beside cold, at the 4-card cell's shard
    for r in rows:
        if r["name"] in STEP_ROWS:
            r["warm_ms"] = k_step[r["name"]]["warm_ms"]
            r["shard"] = "rank 0 of 4 at 5M"
    # K13 beside an empty launch (phase 19's timer): its launch floor
    k13_row = next(r for r in rows if r["name"] == "eft_check")
    k13_row["graph_ms"] = k13_floor["eft_check"]
    k13_row["empty_launch_ms"] = k13_floor["empty"]
    k13_row["with_empty_launch_ms"] = k13_floor["both"]
    # K6 beside the compensated per-step launches it replaced, in turns
    next(r for r in rows if r["name"] == "lanczos_pass_one_comp")[
        "steps_ms"] = k6_ms["per-step"]
    # K15 cold-L2 at the headline, and on phase 25's Hofstadter Laplacian
    k15_row = next(r for r in rows if r["name"] == "csr_spmv")
    k15_row["cold_ms"] = k15["cold_ms"]
    k15_row["hofstadter"] = {key: c25["k15"][key] for key in
                             ("ms", "cold_ms", "plain_ms", "library_ms")}
    k15_row["hofstadter"]["bound_ms"] = c25["k15"]["bound"][0]
    k11_row = next(r for r in rows if r["name"] == "df_kkt_matvec")
    k11_row["in_pass_matvecs"] = df_in_pass_matvecs
    k11_row["in_pass_us"] = df_in_pass_us
    k11_row["planar_ms"] = k11_planar_ms
    # the capability paths' launches (phases 21-23), each path driven with
    # the counters reset: K1 in the fused Chebyshev expansion, K2 and K6 in
    # the SLQ methods, K8 under eigsh, the generic expansion, the
    # reorthogonalised and block solves, K7 in the arc-sharded SLQ methods
    # and expansion
    for r in rows:
        extra = {path: got[r["name"]] for path, got in cap["paths"].items()
                 if r["name"] in got}
        if extra:
            r["capability_launches"] = extra
            r["launches"] += sum(extra.values())
    # phase 24's paths: K1, K2, K3 and K4 under tradeoff and scalability
    # (fused), K8 under tradeoff --backend pallas, K7 in sol_bench's graphs
    # (each captured launch once, however often its graph replays)
    for r in rows:
        extra = {path: got[r["name"]] for path, got in p24["paths"].items()
                 if r["name"] in got}
        if extra:
            r["tool_launches"] = extra
            r["launches"] += sum(extra.values())
    # phase 25's paths: K8 under entry(), K7, K8 and K12 under
    # dryrun_multichip(1)
    for r in rows:
        extra = {path: got[r["name"]] for path, got in p25.items()
                 if r["name"] in got}
        if extra:
            r["entry_launches"] = extra
            r["launches"] += sum(extra.values())
    below = [r["name"] for r in rows if r["ms"] < r["bound_ms"]]
    check(not below, f"timed below their bound (a bound of the wrong "
                     f"memory level): {below}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
