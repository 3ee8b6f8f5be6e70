#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--out FILE] [--only large_fit|multi_mid|figures|
                                               sessions|fabric|store|serve|
                                               obs|dist|shard|lm|moe|mla|
                                               ssm|hybrid|encdec|train|
                                               consensus|launch|dryrun]

Runs from the root of a checkout, on a machine with one CUDA card, the
CUDA toolkit and ninja; it builds the hand kernels itself into
``build/repro_torch_kernels/``.  Every phase prints one JSON line, and
any failure raises and exits non-zero:

1. the card (name and power limit, as nvidia-smi gives them);
2. the kernel build: its seconds, and registers / shared / local memory
   of every kernel as the compiler left them (a Gram kernel with local
   memory fails); then the analysis gate (``repro_torch.analysis``): the
   launch audit of ``kernels/launch.py`` held against the built
   extension (``kernel_info`` and ``qp_multi_shape``) and the card's
   limits, the sources' constants and coverage, the dispatch audit of
   the entry points, the launch guard (one Gram launch per fit and per
   sweep compile, none for a factored fit, one ``gemm_rows`` launch per
   served batch, the extension loaded once) and the lint, one
   ``analysis`` record with its findings (any fails) and seconds;
3. each kernel against its plain PyTorch version on the card, in the
   paper regime (B=20 problems, N=60, D=11: the quickstart's shapes; the
   tiled Gram kernel on two 24-row panels across the diagonal) and the
   large regime (B=2, N=20000, D=257: benchmarks/bench_scale.py's
   large_fit; the tiled Gram kernel on one 3352-row streamed panel), with
   the error, the kernel's ms, the plain version's ms, the bound's ms and
   one library call's ms where there is one (an einsum for the Gram
   kernels, a broadcast ``torch.mul`` for the prescale's scaled half,
   in Z's own layout; the error at most 3e-5
   (f32) or 1e-2 (bf16) of the plain result's largest magnitude, and for
   the QP kernels less than the plain solve moves lam from its warm
   start); the square K must be bitwise symmetric, a tiled panel must
   equal the same rows of the square kernel's K bitwise, and the
   prescale the plain one exactly; the bf16 multi solve is timed on K
   converted to bf16 beforehand, as a bf16 plan holds it (the
   conversion is timed as a record of its own), must give the same bits
   from the f32 K the wrapper converts, and every multi solve the same
   bits on a second launch (in the paper regime also its device time
   replayed from a CUDA graph, without the host's launch cost); in the
   large regime both Gram
   kernels must take at most twice their bound and the square one less
   time than its einsum (the panel's ratio to its einsum is printed);
4. the main path: the quickstart (DTSVM and DSVM, V=10, T=2, N=60,
   p=10, 60 ADMM iterations of 100 QP iterations) through
   ``repro_torch.quickstart.main(device="cuda")`` for every QP engine,
   and for pallas_fused_multi under two budgets (8-row streamed panels;
   a tile that does not bind, so one square launch), each against the
   same on the CPU (risk gap <= 1e-3), the budgeted ones also within 1e-3 of
   the dense card run's risks (K is bitwise the dense K, L only within
   rounding; whether the risks came out equal is reported), with the
   kernel launch counts set to 0 just before each run's fits and read
   just after: each must equal what the config implies;
5. the large fit (V=2, T=1, N=20000, p=256, 2 ADMM iterations of 10 QP
   iterations, pallas_fused_multi in f32 and bf16; each card fit run
   FIT_REPS times, with the median, least and largest wall printed)
   against the same fit on the CPU (once); then the same f32 fit
   streamed under
   ``PlanBudget(max_elems=2**27)`` (K bitwise the dense K, state within
   the f32 tolerance of the dense card fit, a lower peak of device
   memory) and with ``qp_operator="factored"`` (no K, state within the
   same tolerance, peak under 1.5 GB), launch counts kept the same way;
   then one partial ``Plan.replan`` at the same widths (V=2, T=2: one
   node's coupling off rebuilds 2 of 4 K slices), its peak device memory
   printed and the rebuilt slices ``torch.equal`` to a fresh build;
6. a torch.profiler trace of each quickstart engine and of one budgeted
   run, at PROFILE_ITERS of the quickstart's 60 ADMM iterations: device
   busy share and kernel launches (a trace without ``record_function``
   blocks records the CUDA activity alone and sums its raw events, here
   and in every later phase);
7. the paper's figures through ``repro_torch.figures``: the five golden
   regimes of ``tests/golden/fig{2..6}.json`` (within the fixtures'
   ATOL = 0.015), then each figure once at its paper regime (the widths
   of the reference's ``run(fast=False)``, seed 0; Fig. 2 per network
   with ``fista`` and ``pallas_fused_multi``), each run on the card and
   on the CPU (the CPU runs, and the CPU sweeps below, in one child
   process started with the phase, beside its card runs; its seconds
   and the phase's wait for it are printed) (every
   network-average risk within one test sample,
   1/n_test), its launches counted from 0 just before the card run and
   read just after (one square Gram build per fit, sweep and CSVM fit;
   one multi launch per ADMM iteration of a ``pallas_fused_multi`` fit
   or sweep), with its wall and its derived metric (e.g. Fig. 2's
   target-task transfer gain); then Fig. 3's paper grid (16 configs)
   as one sweep and as the serial loop of its 16 fits, per engine, with
   both walls, both launch counts, their risks within 1/n_test, the
   sweep's final states within 1e-4 of each leaf's largest magnitude of
   the same sweep on the CPU (its risks within 1/n_test), and a profiler
   trace of each sweep; the kernels at these paths' own operands, each
   against its plain version as in phase 3: the square Gram kernel at
   the sweep's build (one Z shared by 16 configs' a, S*V*T = 320
   problems, and bitwise the K the sweep kept) and at CSVM's pooled
   build (one a over T = 2 tasks of V*N = 400 rows), the multi solve at
   the operands of the sweep's second ADMM iteration (320 problems, the
   shared Z folded in);
8. the online sessions of Fig. 7 through ``repro_torch.figures.
   fig7_online`` (an ``OnlineSession`` per run, its replans, and the
   replay of its event log, which must equal the live session bitwise):
   the golden regime of ``tests/golden/fig7.json`` (within ATOL of the
   fixture) and the paper regime (V=6, T=3, N=40, 30 ADMM iterations a
   stage, 1800 test samples, seed 0) with ``fista`` and
   ``pallas_fused_multi``, each on the card and on the CPU (every
   network-average risk within 1/n_test), with each stage's wall, the
   derived gains, and the launches counted from 0 just before the card
   run and read just after: one build of the changed K slices per
   stage, live and replay (10, fixed by the protocol, which replans
   four times), whose problems must sum to the slices ``plan_stats``
   says the session and its replay computed, and with
   ``pallas_fused_multi`` one multi launch per ADMM iteration of each;
   a profiler trace of one paper stage per engine;
   then the other plan modes through the same replans at the paper
   regime: under a binding ``PlanBudget`` (the changed slices streamed
   through the tiled kernel) and the factored operator (L-only
   replans, no square Gram launch, no K), each state within RTOL_FIT
   f32 of the dense session's, and bf16 (state within RTOL_FIT bf16 of
   the same session on the CPU); every mode's risks within 0.05 of
   the dense f32 session's; then the
   kernels at a session's own operands: the square Gram kernel at a
   partial replan's ``Z[changed]``, ``a[changed]`` (bitwise the slices the
   new plan kept, every other slice ``torch.equal`` to the old plan's,
   which is left as it was) and the multi solve of one session step,
   each against its plain version;
9. the communication fabric (``repro_torch.net``, the ``"async"``
   backend): (a) Fig. 7's node-churn variant through
   ``fig7_online.churn_marks`` (a lossy int8 fabric with error
   feedback, drops, partial activation and bounded staleness; a crash, a
   recovery and a leave; its event log replayed bitwise and the final
   alive mask checked inside), the golden regime within ATOL of
   ``tests/golden/fig7_churn.json`` and the paper regime per engine
   within 1/n_test of the same run on the CPU, launches counted as in
   phase 8 (the node events replan nothing); (b) BENCH_comms' error
   feedback point (``benchmarks/bench_comms.py``: V=6, T=2, 40/200
   samples, 60 ADMM iterations of 100 QP iterations) on the card and
   the CPU: int8 with and without error feedback at identical bytes per
   round, error feedback no worse in risk and closer to the float32
   solution, each fit's counters equal to the CPU's and its risks within
   a stated bound of them; then the exchange's general path (a delay
   ring, a binding token bucket, drops) with ``pallas_fused`` under a
   binding budget against the same fit on the CPU, its step, tiled Gram
   and prescale launches counted; (c) the identity
   fabric at phase 5's large fit (V=2, T=1, N=20000, p=256,
   ``pallas_fused_multi``): the async fit ``torch.equal`` to the vmap
   fit on the same plan, FIT_REPS walls of each and their peak device
   memory; (d) a torch.profiler trace of one paper stage on the vmap
   backend, the identity (buffer) fabric and the churn (mailbox)
   fabric: launches per round and the device's busy share; then the
   Gram kernel at the churn session's compile and the multi solve at
   one of its rounds, against their plain versions;
10. the store (``repro_torch.store``): tests/test_store.py's five
   in-process configs (vmap dense and under a binding budget; the async
   fabric's identity, lossy and stale/error-feedback wires, the last with
   Fig. 7's churn events) at Fig. 7's size, 15 ADMM iterations a stage
   with ``pallas_fused_multi``: each session saved to disk after stage 1,
   and again with stage 2's membership events pending, restored with
   ``load_session(device="cuda")`` and continued through stage 5,
   ``torch.equal`` to the uninterrupted run in state, risk history and
   fabric state; its event log saved, loaded and replayed, bitwise; a
   snapshot the CPU port wrote in the same run restored on the card,
   refused with ``SchemaError`` without ``check_fingerprint=False``
   where the two plans' fingerprints differ, and continued within 1/n_test
   in risk of the same session continued on the CPU (and, where the wire
   does not quantize, within RTOL_FIT f32 in state); then a session at
   the large fit's widths saved after one ADMM iteration, restored and
   continued one more, ``torch.equal`` to the uninterrupted two, with the
   seconds of the save, the restore and one plan fingerprint and the
   file's bytes;
11. serving (``repro_torch.serve``): the quickstart's fitted DTSVM
   (V=10, T=2, p=10) and the large fit's model (p=256) each served for
   1 s by 4 closed-loop clients (``benchmarks/bench_serve.py``'s load) at
   a 1 ms window, then held to the bucket contract (rows 0-7 through
   ``gemm_rows`` bitwise ``decide_rows`` in buckets 8 to 1024, at row
   offsets 0 and 3, in batches of 1, 7, 33 and 1000 rows, in a view
   X[3:] of a larger tensor and where X starts 4 bytes past 16), with
   ``gemm_rows`` against its plain version at 1024 rows and timed there
   and at 8 rows (the launch floor; CUDA events and a CUDA graph) beside
   ``torch.addmm``, and whether ``addmm`` keeps the contract printed; the
   same holds and times at the paper's MNIST width (K = 20 hyperplanes,
   the quickstart's V*T, over p = 784 = 28 x 28 features, seeded random
   weights), and at rows past the 1024 features a lane group holds
   (K = 20 over p = 2000, float4 loads; K = 2 over p = 1027, scalar);
   then a Fig. 7 session's model served for 3 s at
   each window of 0 and 1 ms, its next stage run and published
   (``publish_session``) mid-stream; every answer is checked bitwise
   against ``decide_rows`` of the model that answered it, with p50/p99
   latency, requests/s, rows per batch, pad ratio and the kernel's
   launches;
12. observability (``repro_torch.obs``): (a) the quickstart's DTSVM
   (V=10, T=2, N=60, p=10, 60 ADMM iterations of 100 QP iterations) per
   engine (fista, pg, pallas_fused, pallas_fused_multi and the factored
   operator), OBS_REPS fits each with telemetry off and on in turns:
   the state ``torch.equal`` on and off, the kernel launches the same,
   the streams within the bounds of OBS_RTOL / OBS_ATOL / OBS_FRAC_GAP
   of the same fit on the CPU port (the largest gaps printed), the
   engine's spans recorded, and its loop run under
   ``torch.cuda.set_sync_debug_mode("warn")`` with as many warnings on
   as off; the median walls on and off, and a profiler trace of the
   multi engine's fit on and off; (b) the large fit (V=2, T=1, N=20000,
   p=256, ``pallas_fused_multi`` f32, 2 x 10 iterations) on and off,
   ``torch.equal``, its streams and walls; (e) ``obs.timeit`` of its
   ``Plan.run``, whose best time may not be below the device time of
   the same call (CUDA events while a spin kernel holds the card, so no
   host gap counts); (c) Fig. 7's churn session (``churn_marks``, the
   multi engine) with telemetry on the card and the CPU: the fabric's
   ``bytes_round``, ``staleness`` and ``nodes_alive`` equal, the other
   streams within OBS_WIRE_REL of each stream's largest value over the
   int8 wire and within (a)'s bounds over a float32 wire with the same
   drops, schedule, staleness limit and node events; the int8 session
   saved after stage 2, restored on the card and continued, its
   ``telemetry_`` and state equal to the uninterrupted session's;
   (d) ``python -m repro_torch.obs demo`` in a
   subprocess on the card, its trace valid and holding the engine's
   spans, its registry loaded and rendered;
13. the ``"shard_map"`` backend (``repro_torch.core.dtsvm_dist``): one
   rank per network node, every rank a spawned process on the card in one
   gloo world (``repro_torch.dist.World``), building its node's K and
   running its QP engine there, the neighbor sums collectives through
   pinned host buffers: (a) the paper regime of
   ``examples/dtsvm_decentralized.py`` (V=8, T=2, p=10, 5/60 samples a
   task, a random graph of degree 0.7, C=0.01, 25 ADMM x 80 QP
   iterations, 600 test points) on 8 ranks with ``graph`` and with
   ``ring`` (over ``graph.ring(8)``), under ``fista``, ``pallas_fused``
   and ``pallas_fused_multi``, each held to the ``vmap`` fit on the card
   (state within 1e-5, every risk within 1/600; whether it came out
   bitwise is printed), DIST_REPS fits each side with the median wall;
   (c) a 5-round history with telemetry on 8 ranks against ``vmap``'s
   (history within 1/600, streams within phase 12's bounds); (b) the
   large fit (V=2, T=1, N=20000, p=256, 2 x 10 iterations, multi f32)
   on 2 ranks, DIST_REPS fits against the ``vmap`` fit within RTOL_FIT,
   then once under ``PlanBudget(max_elems=2**27)`` (the tiled kernel in
   the ranks); each rank's device, launch counts (counted from 0 just
   before a case's fits and read just after, each equal to what the
   config implies for one node), peak device memory, neighbor sums and
   host copies per ADMM iteration, and the worlds' start times; then a
   rank that dies must make the world raise and leave no rank alive;
14. the ``"sample_shard"`` backend (``repro_torch.dist.sample``: every
   node's samples split over the ranks of a world, each building its row
   panel of K with one prescale and the tiled Gram kernel) and the
   device-tiled sweep (``SweepPlan.run_sharded``: each rank compiling its
   configs' sub-sweep), every rank a spawned process on the card: (a) the
   large fit (V=2, T=1, N=20000, p=256, 2 x 10 iterations) on 4 ranks
   with fista/gather, fista/psum and pg/gather, DIST_REPS fits dense and
   one under ``PlanBudget(max_elems=2**27)`` (2 tiled panels a rank), each
   against the ``vmap`` fit on the card within RTOL_FIT with both walls,
   each rank's peak device memory under vmap's, its launches (the
   prescale and its panels, nothing else) and its collectives per ADMM
   iteration with their share of the wall; then the tiled kernel at a
   rank's panel (rows 5000-9999 of the gathered Z) against its plain
   version and bitwise those rows of the square K; (b)
   tests/test_scale.py's regime (V=3, T=2, N=64, p=10, 5 x 50
   iterations) on 4 ranks: a fit with a risk history (state within 1e-5
   of ``vmap``'s, history within 1/32), ``psum`` (within the reference's
   2e-5), telemetry on and off (``torch.equal``; streams within phase
   12's bounds of vmap's); (c) Fig. 3's paper grid (16 eps configs,
   V=10, 60 x 100 iterations, seed 0) as a sweep, 1-D on 4 ranks and
   2-D on 2 rows of 10 (``graph``), with ``fista`` and
   ``pallas_fused_multi``, against the single-host sweep on the card
   (states within 1e-5 of each leaf's largest magnitude, or of 1 where
   it is smaller; every network-average risk within 1/n_test), each
   rank's Gram and QP launches counted; then the square Gram and the
   multi kernels at a 1-D rank's operands against their plain versions;
   (d) tests/test_dist.py's regime (V=4, 4 configs, 5 x 20 iterations)
   over a ring, 2-D on 2 rows of 4, with ``pallas_fused``, within 1e-5 of
   the single-host sweep; (e) a sample rank that dies makes the fit raise
   and leaves no rank alive;
15. the dense decoder's serving path (``repro_torch.launch.serve``) at
   Gemma-2 2B's full published width (26 layers, d_model 2304, 8 heads
   over 4 KV heads of 256, d_ff 9216 GeGLU, vocab 256000, softcaps 50 and
   30, local (4096) and global layers alternating), fp32 weights from
   ``init_params`` with a seeded generator: (a) bf16 compute,
   ``generate`` at batch 4, a 512-token prompt and 32 new tokens, its
   wall and tokens/s, then the prefill step (median of 3) and the decode
   step per token alone (CUDA events), one of each traced (device busy
   share and launches), and the peak device memory; the
   path launches none of the hand kernels (its ``launches_by_path``
   entry is zeros); (b) fp32 compute, decode's logits at steps 1, 8 and
   32 against a prefill over the prompt and the tokens generated so far
   (max abs diff <= 1e-3, equal argmax); (c) long mode, fp32, batch 1, a
   4608-token prompt (over the 4096 window, not a multiple of it: its
   prefill takes ``_flash_sdpa`` and the ring wraps) and 16 new tokens,
   (b)'s check at steps 1 and 16;
16. the mixture-of-experts serving path at Phi-3.5-MoE's full published
   width (d_model 4096, 32 heads over 8 KV heads of 128, 16 experts of
   d_ff 6400, top-2, SwiGLU, vocab 32064, untied head), depth cut from 32
   layers to MOE_LAYERS = 8 (the whole model is 168 GB in fp32), fp32
   weights from ``init_params`` with a seeded generator, built once for
   three parts: (a) bf16 compute at the published capacity factor 1.25,
   ``generate`` at batch 4, a 512-token prompt and 32 new tokens, its
   wall and tokens/s, the prefill step (median of 3) and the decode step
   per token (CUDA events), one decode step traced (device busy share
   and launches), the peak device memory; no hand kernel launched (its
   ``launches_by_path["lm_moe"]`` is zeros); (b) fp32 compute at a
   dropless capacity (8.0 = E / K), decode's logits at steps 1, 8 and 32
   against a prefill over the prompt and the tokens so far (max abs diff
   <= 1e-3, equal argmax); (c) the drop rule at (a)'s 4 x 512-token
   prefill: layer 0's ``ln2`` input routed (product, softmax, stable
   top-k) and dispatched on the card, its picks equal to a stable sort of
   its own probabilities on the host and its kept mask equal to the
   reference's rule (the halving loop, capacity by Python's ``round``,
   the exclusive cumsum in token-major, k-minor order) computed in numpy
   from the card's picks, with the share of assignments dropped (some
   must be);
17. DeepSeek-V2's multi-head latent attention at full published width
   (d_model 5120, 128 heads with q_lora 1536, kv_lora 512, nope 128, rope
   64 and v 128; 160 routed experts of d_ff 1536, top-6, 2 shared; the
   first layer dense with d_ff 12288; vocab 102400, untied head), depth
   cut from 60 layers to DSV2_LAYERS = 3 (the dense layer and two MoE
   layers, 37.3 GB of fp32 weights; all 60 are ~943 GB), fp32 weights
   from ``init_params`` with a seeded generator, built once: (a) bf16 at
   the published capacity factor 1.25, ``generate`` at batch 4, a
   512-token prompt and 32 new tokens, its wall and tokens/s, the prefill
   step (median of 3) and the decode step per token (CUDA events), one
   decode step traced (busy share, launches, and the device ms of the
   kernels inside the MLA blocks against the MoE layers), the peak, and
   the bytes of the stacked latent cache beside those of expanded K/V
   caches of its shape; no hand kernel launched (its
   ``launches_by_path["lm_mla"]`` is zeros); (b) fp32 at a dropless
   capacity (27.0 >= E / K), batch 2, decode's logits at steps 1, 8 and
   32 against a prefill over the prompt and the tokens so far (max abs
   diff <= 1e-3, equal argmax); (c) fp32, batch 1, a 2560-token prompt
   (its MLA prefill takes ``_flash_sdpa`` with v's head dim below q's) and
   16 new tokens, (b)'s check at steps 1 and 16 against the 2576-slot
   latent cache;
18. Mamba2's state-space serving path at mamba2-130m's full published
   size, nothing cut (24 layers, d_model 768, d_inner 1536, 24 SSM heads
   of 64, d_state 128, 1 group, conv width 4, chunk 256, vocab 50288 with
   a tied head: 128,989,632 parameters, the config's count plus the final
   norm and, per layer, ``conv_b`` and the heads' third vector, less the
   second norm it books), fp32 weights from ``init_params`` with a seeded
   generator: (a) bf16, ``generate`` at batch 4, a 512-token prompt and
   32 new tokens, its wall and tokens/s, the prefill step (median of 3)
   and the decode step per token (CUDA events), one decode step traced
   (busy share, launches, the device ms inside the 24 mamba blocks), the
   peak, and the stacked cache (``h`` (24, 4, 24, 64, 128) fp32 and
   ``conv`` (24, 4, 3, 1792) bf16) with its bytes; no hand kernel
   launched (its ``launches_by_path["lm_ssm"]`` is zeros); (b) fp32,
   batch 2, decode's logits at steps 1, 8 and 32 against a prefill over
   the prompt and the tokens so far (max abs diff <= 1e-3, equal
   argmax); (c) fp32, batch 1, (b)'s check after a 4100-token prompt (16
   whole chunks and a 4-token tail padded with dt = 0; every layer's SSD
   over 17 chunks) at steps 1 and 16, and after a 2-token prompt (one
   chunk of 2, shorter than the conv window) at steps 1 and 8; (d) bf16,
   batch 1, a 32768-token prefill (128 chunks), its ms (median of 3) and
   peak, its cache's bytes a batch row those of (a); (e) the module's
   CLI (``serve.main``) with no ``--device``, at full size: its tokens
   on the card;
19. Zamba2's hybrid serving path at zamba2-1.2b's full published size,
   nothing cut (38 Mamba2 layers at d_model 2048, d_inner 4096, 64 SSM
   heads of 64, d_state 64, 1 group, conv width 4, chunk 256; one
   weight-tied shared block, MHA with 32 heads over 32 KV heads of 64,
   d_ff 8192 SwiGLU, after layers 5, 11, 17, 23, 29 and 35; vocab 32000
   with a tied head), fp32 weights from ``init_params`` with a seeded
   generator: (a) bf16, ``generate`` at batch 4, a 512-token prompt and
   32 new tokens, its wall and tokens/s, the prefill step (median of 3)
   and the decode step per token (CUDA events), one decode step traced
   (busy share, launches, the device ms inside the 38 mamba blocks
   against the 6 shared-block calls), the peak, the uniform cache's
   bytes by entry (``h`` (38, 4, 64, 64, 64) fp32, ``conv`` (38, 4, 3,
   4224), ``k``/``v`` (38, 4, 545, 32, 64), ``pos`` (38, 545)) and those
   of the 32 unflagged layers' KV slots, which no step reads; no hand
   kernel launched (its ``launches_by_path["lm_hybrid"]`` is zeros);
   (b) fp32, batch 2, decode's logits at steps 1, 8 and 32 against a
   prefill over the prompt and the tokens so far (max abs diff <= 1e-3,
   equal argmax); (c) long mode, fp32, batch 1, (b)'s check at steps 1
   and 16 of 16 new tokens after a 4610- and a 4608-token prompt, both
   over the 4096 window and not multiples of it, so the shared block's
   ring wraps: 4610 is 18 chunks and a 2-token padded tail, and not a
   multiple of the 512-query block, so its attention takes the plain
   schedule; 4608 takes ``_flash_sdpa`` (each prompt's schedule and
   SSD lengths checked); (d) the module's CLI (``serve.main``) with no ``--device``, at
   full size: its tokens on the card; (e) the model's parameter count
   equal to 1,104,937,856, the reference's leaf count, with one
   ``shared_attn`` module (the tied block);
20. Whisper's encoder-decoder serving path at whisper-small's full
   published size, nothing cut (12 encoder and 12 decoder layers,
   d_model 768, 12 heads of 64 (MHA), d_ff 3072 with an ungated
   tanh-GELU, vocab 51872 with a tied head, 1500 stub frames; the
   decoder's position table at whisper's published 448 positions), fp32
   weights from ``init_params`` with a seeded generator: (a) bf16,
   ``generate`` at batch 4, a 224-token prompt and 224 new tokens, which
   fill the table, its wall and tokens/s, the encoder alone over 4 x 1500
   frames and the whole prefill step (each the median of 3) and the
   decode step per token (CUDA events), one decode step traced (busy
   share, launches, the device ms of the 12 cross-attention blocks
   against the rest), the peak, the cache's bytes by entry (``k``/``v``
   (12, 4, 448, 12, 64), ``xk``/``xv`` (12, 4, 1500, 12, 64), ``pos``
   (12, 448)) and those of ``xk``/``xv``, which no decode step rewrites
   (held ``torch.equal`` across the traced step); no hand kernel
   launched (its ``launches_by_path["lm_encdec"]`` is zeros); (b) fp32,
   batch 2, the same frames, decode's logits at steps 1, 8 and 32
   against a prefill over the prompt and the tokens so far (max abs diff
   <= 1e-3, equal argmax); (c) the module's CLI (``serve.main``) with no
   ``--device``, at full size: its tokens on the card; (d) the model's
   parameter count at the 448-row table equal to 239,562,240, the
   reference's leaf count;
21. the allreduce train step (``repro_torch.train.steps.
   make_train_step``: ``forward_train``, the loss, AdamW) at qwen2-0.5b's
   full published size (24 layers, d_model 896, 14 heads over 2 KV heads
   of 64, d_ff 4864, vocab 151936, tied head, QKV bias), fp32 weights
   from ``make_train_state`` with a seeded generator, bf16 compute, the
   config's ``remat``: (a) train_4k's 4096 tokens at batch 8 (the
   reference's 256 cut to 8) in 4 microbatches, on one fixed batch of
   next-token targets, 1 warm-up and 2 timed steps: every step's loss
   (finite, and the third below the first) and grad_norm, the upper
   median of the timed steps' ms (CUDA events), tokens/s, 6 N tokens / time as model TFLOP/s
   with N the parameter count printed, the peak; one more step traced
   (busy share, launches); no hand kernel launched (its
   ``launches_by_path["lm_train"]`` is zeros); (b) fp32, full width cut
   to 2 layers, batch 1 x 256 tokens: the loss, every gradient leaf,
   ``grad_norm`` and the parameters after one step on the card against
   the same on the CPU (the bounds at TRAIN_RTOL); (c) (a)'s first step
   again from the same seed with ``chunked_ce``: its loss within
   TRAIN_CHUNKED_RTOL of (a)'s, its peak beside (a)'s;
22. the ADMM-consensus trainer (``repro_torch.train.steps.
   make_consensus_train_step`` over ``repro_torch.core.consensus``: R
   replicas on the card as a leading axis of every state leaf, each
   replica's forward and backward on its rows of the batch, its clip,
   the ring exchange by two rolls of the replica axis, the dual, AdamW)
   at qwen2-0.5b's full published size, fp32 weights from
   ``make_consensus_train_state`` with a seeded generator, bf16 compute,
   remat: (a) R = 4, eta 0.05, every step, the chunked loss (CONS), 8 x
   4096 tokens (2 rows a replica), the replicas desynchronized by a
   seeded (1 + 0.05 N(0, 1))
   factor, 1 warm-up and 2 timed steps: every step's loss (finite, the
   third below the first), replica 0's grad_norm and gap (the step's,
   which must equal the per-replica gaps' first) and the gaps' max over
   the replicas, the median step ms (CUDA events), tokens/s, model
   TFLOP/s (6 N tokens / time, N one replica's parameters), the state's
   and the peak GB; the round (``consensus_exchange``, inside its
   ``consensus_round`` profiler range) timed alone on the live stacks
   with CUDA events beside its bytes' bound; no hand kernel launched
   (``launches_by_path["lm_consensus"]`` is zeros); (b) fp32, full width
   cut to 2 layers, R = 2, batch 2 x 256: one step on the card and the
   CPU from the same state, the loss, grad_norm and gap within
   TRAIN_RTOL, the dual and both moments per leaf within
   TRAIN_GRAD_TOL, the parameters in lr units; (c) tests/test_dist.py's
   regime on reduced qwen2: 10 steps at eta 0.1, lr 3e-3 (the loss and
   replica 0's gap fall), then every=4 for 3 steps (``step == 3``);
   every phase prints its seconds;
23. the training CLI (``repro_torch.launch.train.main``, the module's
   ``python -m repro_torch.launch.train``) as the reference's end-to-end
   example drives it (examples/train_lm_consensus.py): (a) mamba2-130m at
   its full published size (24 layers, d_model 768, vocab 50288, fp32
   weights from the CLI's seeded generator, bf16 compute), ``--trainer
   admm --mesh 4x2`` (R = 4 replicas; the model axis printed as unused),
   batch 8, seq 256, every step logged, 6 steps with ``--ckpt-every
   1000`` (one save, the reference's tree), then a resume to 8: every
   step's line, the median step ms (CUDA events), tokens/s, the state's
   and the peak GB, the file's bytes, the save's seconds (the host copy
   and the file) and the restore's (the file and the re-seat), the
   host's RSS (its peak over the phase, sampled); gates: every number
   finite, ``latest_step`` 6 then 8, ``resumed from step 6`` printed,
   the re-seated state ``torch.equal`` to the saved one leaf by leaf,
   the resumed steps' losses within LAUNCH_LOSS_RTOL of the saved state
   continued in process over the stream's first two batches, no hand
   kernel launched (``launches_by_path["lm_launch"]`` is zeros); (b)
   fp32 (the config patch), reduced mamba2-130m ``--mesh 2x1`` and
   reduced qwen2-0.5b under allreduce: the card writes step 2, the card
   and the CPU each resume a copy to step 4, the two files held to phase
   22(b)'s bounds; the phase prints its seconds;
24. the one-card dry run (``repro_torch.launch.dryrun``: each step run
   once on fake tensors, no storage and no kernel, for its peak bytes,
   FLOPs and bytes accessed): (a) two mamba2-130m configurations at full
   size, phase 18(d)'s bf16 prefill of 1 x 32768 and phase 23's ADMM
   trainer (R = 4, batch 8, seq 256), each traced on fake ``cuda``
   tensors, then the same step run once for real from seeded weights
   (after ``gc.collect()``, ``empty_cache()`` and
   ``reset_peak_memory_stats()``, nothing else of the phase held) and
   once more under the dry run's byte tracker on the real tensors: the
   predicted, the tracked and the measured peak (``max_memory_allocated``
   above what was held before), the predicted over the measured, the
   counted and the analytic FLOPs (``launch/costs.py``), ``trace_s``, the
   step's ms (CUDA events) and the seconds; gate: predicted / measured
   within DRYRUN_PEAK_BAND; then the budget ``fits`` reads
   (``dryrun.budget``): the card's memory and what the process holds
   outside the allocator beside ``mesh``'s constants, and the card's
   usable bytes beside the CPU's; (b) the module's CLI (``dryrun.main``,
   no ``--device``) at ``--shape decode_32k --mesh 1x1`` for all ten
   archs at full size, a line a record (status, argument and peak GB,
   usable GB, fits on the card and on the CPU's budget, counted over
   analytic FLOPs, ``trace_s``); gates: no ``error`` record, a skip
   exactly where ``shape_applicable`` says, ``fits`` false for
   DRYRUN_OVER_CARD (their fp32 parameters alone pass the card) and
   true for mamba2-130m, each record's ``fits`` the one the CPU's
   budget gives; no hand kernel launched
   (``launches_by_path["lm_dryrun"]`` is zeros); the phase prints its
   seconds;
25. the ``kernels`` line (with ``launches_by_path["shard"]``, phase 14's
   launches counted in the ranks), the card line, and the result line.

``--only`` runs one part and prints no result line, to compare two
trees' ``src/`` under one script (a copy of this file at each tree's
root): ``large_fit`` phase 5's large fits, ``multi_mid`` the multi
solve at N between the paper's and the large fit's (B in {2, 20, 300},
N in {328, 329, 515, 1000}, 100 iterations with the fold), each against
its plain version and timed, ``figures`` phase 7, ``sessions`` phase 8,
``fabric`` phase 9, ``store`` phase 10, ``serve`` phase 11, ``obs``
phase 12, ``dist`` phase 13, ``shard`` phase 14, ``lm`` phase 15,
``moe`` phase 16, ``mla`` phase 17, ``ssm`` phase 18, ``hybrid`` phase
19, ``encdec`` phase 20, ``train`` phase 21, ``consensus`` phase 22,
``launch`` phase 23, ``dryrun`` phase 24.

Without a CUDA device, or without the rest of the repository beside it,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (repro_torch.launch.mesh: NVIDIA data sheet, at the 700 W
# limit): HBM3 bytes/s and fp32 FLOP/s outside the tensor cores (the
# port's fp32 never uses TF32)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as FP32_FLOP_S  # noqa: E402,E501

# the H100's L2 cache, which a K read every QP iteration must fit to be
# read from HBM once
L2_BYTES = 50e6

# (name in the kernels line, source, the TPU kernel it replaces)
KERNELS = {
    "weighted_gram": ("src/repro_torch/kernels/csrc/gram.cu",
                      "src/repro/kernels/gram.py:77"),
    "weighted_gram_tiled": ("src/repro_torch/kernels/csrc/gram.cu",
                            "src/repro/kernels/gram.py:121"),
    # the `zia = zi * a` of the TPU kernel's body (_gram_kernel), once
    # per build, into the feature-major operands of both Gram kernels
    "gram_prescale": ("src/repro_torch/kernels/csrc/gram.cu",
                      "src/repro/kernels/gram.py:70"),
    "qp_pg_step": ("src/repro_torch/kernels/csrc/qp_step.cu",
                   "src/repro/kernels/qp_step.py:76"),
    "qp_pg_multi": ("src/repro_torch/kernels/csrc/qp_multi.cu",
                    "src/repro/kernels/qp_step.py:238"),
    # no TPU kernel: the reference's jitted X @ Wf.T + bf, which XLA
    # lowers; the port needs a fixed order of the sum (the bucket contract)
    "gemm_rows": ("src/repro_torch/kernels/csrc/rows.cu",
                  "src/repro/serve/model.py:124"),
}
# the quickstart's engine runs: (label, SolverConfig overrides)
ENGINE_RUNS = [
    ("fista", {"qp_solver": "fista"}),
    ("pg", {"qp_solver": "pg"}),
    ("pallas_fused", {"qp_solver": "pallas_fused"}),
    ("pallas_fused_multi/f32", {"qp_solver": "pallas_fused_multi"}),
    ("pallas_fused_multi/bf16", {"qp_solver": "pallas_fused_multi",
                                 "qp_precision": "bf16"}),
]
# the quickstart's budgeted runs: (label, PlanBudget(tile=...), Gram panels
# per fit at N=60: 8-row panels, the last clamped; None: a tile that does
# not bind builds the square K with the square kernel)
BUDGET_RUNS = [("pallas_fused_multi/f32/tile(8,128)", (8, 128), 8),
               ("pallas_fused_multi/f32/tile(64,128)", (64, 128), None)]
LARGE_FIT = dict(V=2, T=1, N=20000, p=256, iters=2, qp_iters=10)
LARGE_BUDGET = 2 ** 27      # bench_scale's max_elems: 3352-row panels
# the partial replan: the large fit's widths at two tasks per node
REPLAN_FIT = dict(V=2, T=2, N=20000, p=256)
FACTORED_PEAK_BYTES = 1.5e9
# card fits of each large configuration: one fit's wall moves with host
# noise by more than a kernel's gain, so the median of several is printed
FIT_REPS = 5
# the dense bf16 large fit's peak device memory when K was converted to
# bf16 in every solve (PERF.md, section 5): the bf16 plan's K takes the
# place of the solve's temporary, so its peak must stay within
# PEAK_MARGIN_BYTES of that figure
PER_SOLVE_CONVERSION_PEAK_BYTES = 6_518_774_272
PEAK_MARGIN_BYTES = 0.1e9
# phase 6 traces this many of the quickstart's 60 ADMM iterations
PROFILE_ITERS = 10
# --only multi_mid: the multi solve where K leaves a CTA's shared memory
MID = dict(batches=(2, 20, 300), Ns=(328, 329, 515, 1000), D=11,
           iters=100, reps=50)
# panels: the tiled Gram kernel's rows [start, start + M): two 24-row
# panels of N=60 that the diagonal crosses, and the large fit's last
# (clamped) streamed panel, which starts inside a 128-row tile
REGIMES = {"paper": dict(B=20, N=60, D=11, iters=100, reps=200,
                         panels=((36, 24), (20, 24))),
           "large": dict(B=2, N=20000, D=257, iters=10, reps=5,
                         panels=((16648, 3352),))}
# a kernel's largest error against its plain version, relative to the
# plain result's largest magnitude (no floor: lam lies in [0, 0.02] in the
# large regime, and an absolute limit there would pass a kernel that
# returned its warm start)
RTOL = {"f32": 3e-5, "bf16": 1e-2}
# the large fit on the card against the same fit on the CPU, relative to
# each state leaf's largest magnitude: besides the kernels, two ADMM
# iterations of cuBLAS products stand against the CPU's
RTOL_FIT = {"f32": 1e-4, "bf16": 1e-2}

# the figures phase: Fig. 2 (and the sweep against its serial loop) on
# these engines; a golden regime within the fixtures' ATOL
# (tests/test_golden_figures.py)
FIG2_ENGINES = ("fista", "pallas_fused_multi")
GOLDEN_ATOL = 0.015

# the sessions phase: Fig. 7's paper regime (benchmarks/fig7_online.py
# run(fast=False), cut to seed 0), per engine; a bf16 (or factored)
# session's risks within the bound tests/test_engine.py holds bf16 to
FIG7_PAPER = dict(stage_iters=30, n_test=1800, qp_iters=100, seed=0)
FIG7_ENGINES = ("fista", "pallas_fused_multi")
MODE_RISK_GAP = 0.05

# the fabric phase: BENCH_comms' error-feedback point
# (benchmarks/bench_comms.py run(fast=False): V=6, 40/200 samples per task
# over a random graph of degree 0.8, 1800 test samples, 60 ADMM
# iterations of 100 QP iterations)
COMMS = dict(V=6, n_per_task=(40, 200), degree=0.8, n_test=1800, iters=60,
             qp_iters=100)
# the exchange's general path (delay ring, token bucket) on that data
GENERAL_FABRIC = dict(iters=30, qp_iters=50)

# the store phase: tests/test_store.py's five in-process configs, each at
# Fig. 7's size (benchmarks/fig7_online.py: V=6, T=3, p=10, 10/10/40
# samples a node, 1800 test samples, seed 0) through its five stages, cut
# to the reference's fast regime of 15 ADMM iterations a stage, with the
# multi engine; the stale-ef config also takes the churn variant's node
# events.  A CPU-written snapshot continues on the card within the
# sessions' limits: risks within 1/n_test of the same session continued on
# the CPU, and, where the wire does not quantize, state within RTOL_FIT
# f32 of each leaf's largest magnitude (over a quantizing wire one
# last-bit difference can move a code, as phase 9's int8 fits show)
STORE_FIG7 = dict(stage_iters=15, n_test=1800, qp_iters=100, seed=0,
                  qp_solver="pallas_fused_multi")
QUANTIZED_STORE_CONFIGS = ("async-lossy", "async-stale-ef")
# the serve phase: bench_serve.py's closed-loop load (4 clients, 1-16 rows
# a request, 3 s a batching window) on a Fig. 7 session's model with a
# hot swap to its next stage mid-stream, then 1 s each on the quickstart's
# and the large fit's models; rows 0-7 held bitwise across these buckets
SERVE = dict(clients=4, max_rows=16, stream_s=3.0, model_s=1.0,
             windows=(0.0, 1.0), buckets=(8, 16, 32, 256, 1024))
# the serving product's contract over batches that are no bucket, and the
# paper's MNIST width (V, T, p): the quickstart's V*T = 20 hyperplanes over
# 28 x 28 features
SERVE_ROWS_BATCHES = (1, 7, 33, 1000)
SERVE_MNIST = (10, 2, 784)
# (V, T, p) of models whose rows run past the 1024 features that a lane
# group of rows.cu holds in registers: float4 loads (p % 4 == 0) and scalar
SERVE_WIDE = ((10, 2, 2000), (1, 2, 1027))
# the obs phase: the quickstart's DTSVM per engine with telemetry on and
# off; the card's streams against the same fit's on the CPU port: the
# residual streams within OBS_RTOL of each value plus OBS_ATOL of the
# stream's largest value, the box-face fraction within OBS_FRAC_GAP, the
# fabric's counting streams exactly
OBS_ENGINES = [("fista", {"qp_solver": "fista"}),
               ("pg", {"qp_solver": "pg"}),
               ("pallas_fused", {"qp_solver": "pallas_fused"}),
               ("pallas_fused_multi", {"qp_solver": "pallas_fused_multi"}),
               ("factored", {"qp_solver": "pallas_fused_multi",
                             "qp_operator": "factored"})]
OBS_RTOL, OBS_ATOL, OBS_FRAC_GAP = 1e-3, 1e-5, 0.01
# card fits with telemetry off and on, in turns, per engine and at the
# large fit: fewer than FIT_REPS to keep the whole script near its aim
OBS_REPS = 3
OBS_EXACT = ("bytes_round", "staleness", "nodes_alive")
# Fig. 7's churn wire is int8 with error feedback: a last-bit difference
# between the card's and the CPU's state can move an int8 code, and the
# moved code carries into every later round (phase 9's risks hold to
# 1/n_test for the same reason); over it the residual streams are held to
# OBS_WIRE_REL of the stream's largest value, and the same protocol over
# a float32 wire (drops, partial schedule, staleness, the same node
# events) to (a)'s bounds
OBS_WIRE_REL = 1e-2

# phase 13: examples/dtsvm_decentralized.py's paper regime, one rank a node
DIST_PAPER = dict(V=8, T=2, p=10, n=(5, 60), degree=0.7, C=0.01, iters=25,
                  qp_iters=80, n_test=600)
DIST_ENGINES = ("fista", "pallas_fused", "pallas_fused_multi")
DIST_REPS = 3
# the reference's bar for this backend (tests/test_api.py:137-141): state
DIST_STATE_TOL = 1e-5
DIST_HISTORY = 5

# phase 14: the sample_shard backend and the device-tiled sweep.  (a) the
# large fit (bench_scale.py:265) on SHARD_RANKS ranks per (label, engine,
# reduce), dense and under LARGE_BUDGET; (b) tests/test_scale.py:236-278's
# regime, whose psum bar is the reference's own (:270-275); (c) Fig. 3's
# grid as a sweep, 1-D over SHARD_RANKS ranks and 2-D over SWEEP_ROWS_2D
# rows of V ranks, per engine; (d) tests/test_dist.py:118-150's regime over
# a ring, 2-D over 2 rows of 4 ranks
SHARD_RANKS = 4
SHARD_LARGE_RUNS = (("fista/gather", "fista", "gather"),
                    ("fista/psum", "fista", "psum"),
                    ("pg/gather", "pg", "gather"))
SHARD_SCALE = dict(V=3, T=2, N=64, p=10, degree=0.8, iters=5, qp_iters=50,
                   n_test=32)
SHARD_PSUM_TOL = 2e-5
SWEEP_ENGINES = ("fista", "pallas_fused_multi")
SWEEP_ROWS_2D = 2
SWEEP_RING = dict(V=4, T=2, p=6, n=6, iters=5, qp_iters=20,
                  qp_solver="pallas_fused")
SWEEP_RING_CFGS = (dict(C=0.02), dict(eps2=3.0), dict(eta2=0.7),
                   dict(C=0.1))

# phase 15: the dense decoder's serving path at Gemma-2 2B's full width.
# (a) bf16 generate; (b) fp32 decode against prefill at LM_STEPS; (c) long
# mode at LM_LONG, fp32, decode against prefill at its steps
LM_ARCH = "gemma2-2b"
LM_SERVE = dict(batch=4, prompt=512, gen=32)
LM_STEPS = (1, 8, 32)
LM_LONG = dict(batch=1, prompt=4608, gen=16, steps=(1, 16))
LM_TOL = 1e-3

# phase 16: the mixture-of-experts serving path at Phi-3.5-MoE's full
# width, depth cut from 32 layers to MOE_LAYERS (the whole model is 168 GB
# in fp32).  (a) bf16 generate at the published capacity factor; (b) fp32
# decode against prefill at a dropless capacity (E / K = 16 / 2 = 8) at
# LM_STEPS; (c) the drop rule on the card at (a)'s 4 x 512-token prefill
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8

# phase 17: DeepSeek-V2's multi-head latent attention at full width, depth
# cut from 60 layers to DSV2_LAYERS (the dense leading layer and two MoE
# layers: 37.3 GB of fp32 weights; all 60 are ~943 GB).  (a) bf16 generate
# at the published capacity factor; (b) fp32 decode against prefill at a
# dropless capacity (MLA_DROPLESS >= E / K = 160 / 6) at LM_STEPS; (c) the
# same after MLA_LONG's prompt, whose prefill takes _flash_sdpa with v's
# head dim (128) below q's and k's (192)
MLA_ARCH = "deepseek-v2-236b"
DSV2_LAYERS = 3
MLA_DROPLESS = 27.0
MLA_LONG = dict(batch=1, prompt=2560, gen=16, steps=(1, 16))

# phase 18: Mamba2's state-space serving path at mamba2-130m's full size,
# nothing cut.  (a) bf16 generate at lm's serving shape; (b) fp32 decode
# against prefill at LM_STEPS; (c) fp32 after SSM_PROMPTS' prompts: 16
# whole chunks and a 4-token tail, and 2 tokens (shorter than the conv
# window); (d) a bf16 prefill of SSM_PREFILL tokens (128 chunks; long_500k's
# 524288 would need ~13 GB a layer for the intra-chunk L matrices alone)
SSM_ARCH = "mamba2-130m"
SSM_PROMPTS = (dict(prompt=4100, gen=16, steps=(1, 16)),
               dict(prompt=2, gen=8, steps=(1, 8)))
SSM_PREFILL = 32768
# phase 19: Zamba2's hybrid serving path at zamba2-1.2b's full published
# size, nothing cut.  (a) bf16 generate at lm's serving shape; (b) fp32
# decode against prefill at LM_STEPS; (c) long mode after HYBRID_LONG's
# prompts, both over the 4096 window and not multiples of it, so the
# shared block's ring wraps: 4610 (18 chunks and a 2-token padded tail;
# not a multiple of the 512-query block, so attention takes the plain
# schedule) and 4608 (18 whole chunks; the flash schedule); (d) the CLI;
# (e) the parameter count, the reference's leaf count with one tied
# shared block after HYBRID_FLAGGED
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PARAMS = 1_104_937_856
HYBRID_FLAGGED = (5, 11, 17, 23, 29, 35)
HYBRID_LONG = (dict(prompt=4610, gen=16, steps=(1, 16), flash=False),
               dict(prompt=4608, gen=16, steps=(1, 16), flash=True))
# phase 20: Whisper's encoder-decoder serving path at whisper-small's full
# published size, nothing cut, with whisper's published 448-position
# decoder context as the table's rows.  (a) bf16 generate at ENCDEC_SERVE,
# whose prompt and new tokens fill the table, over 1500 stub frames a row;
# (b) fp32 decode against prefill at LM_STEPS; (c) the CLI; (d) the
# parameter count, the reference's leaf count at the 448-row table
ENCDEC_ARCH = "whisper-small"
ENCDEC_ROWS = 448
ENCDEC_SERVE = dict(batch=4, prompt=224, gen=224)
ENCDEC_PARAMS = 239_562_240
# phase 21: the allreduce train step at qwen2-0.5b's full published size,
# nothing cut but the batch: train_4k's 4096 tokens a row at a batch of 8
# (the reference's global batch of 256 cut to 8, which one card steps
# through in seconds) in 4 microbatches, the config's remat, bf16
# compute.  (a) 1 warm-up and 2 timed steps on one fixed batch (a third
# cost 8-10 s of the script's time budget); (b) fp32
# parity at full width cut to 2 layers, batch 1 x 256 tokens, one step on
# the card against the same step on the CPU; (c) (a)'s first step with
# the chunked loss, its loss within TRAIN_CHUNKED_RTOL of (a)'s
TRAIN_ARCH = "qwen2-0.5b"
TRAIN = dict(batch=8, seq=4096, microbatch=4, warmup=1, steps=2)
TRAIN_PARITY = dict(layers=2, batch=1, seq=256)
TRAIN_LR = 3e-4
# card against CPU, fp32: the loss and grad_norm within rtol 1e-5, each
# gradient leaf within 1e-4 of its largest magnitude (the bounds of
# tests/test_torch_train.py), the parameters after the step within 2 lr
# (Adam's first step divides each gradient by its own magnitude: an
# element whose gradient lies within the two devices' noise steps by
# +lr or -lr in either) and at most 1e-3 of them past lr / 100
TRAIN_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_FAR_FRACTION = 1e-3
# (c): one bf16 rounding of the loss (2 ** -8 of it)
TRAIN_CHUNKED_RTOL = 2.0 ** -8
# phase 22: the ADMM-consensus trainer at qwen2-0.5b's full published
# size, R = 4 replicas on the card (the reference's data mesh axis as a
# leading replica axis), bf16 compute, the config's remat.  (a) one fixed
# batch of 8 x 4096 tokens, 2 rows a replica (phase 21's microbatch), the
# replicas desynchronized by a seeded (1 + 0.05 N(0, 1)) factor (the
# reference's tests/test_dist.py:68-72), 1 warm-up and 2 timed steps (as
# phase 21's);
# (b) fp32 parity at full width cut to 2 layers, R = 2, batch 2 x 256, one
# step on the card against the same step on the CPU from the same state
# (phase 21's bounds; the dual and the moments, gradient-derived, to the
# gradients'); (c) tests/test_dist.py:48-113's regime on reduced qwen2
# (its bf16 compute): R = 4, eta 0.1, lr 3e-3, 8 x 64 tokens, 10 steps
# (the loss and replica 0's gap fall), then every=4 for 3 steps at lr
# 1e-3 on 4 x 32 (``step == 3``)
# (a) runs with the chunked loss: unchunked it peaks at 65.2 GB allocated
# alone, and inside the whole script the allocator's cache (17.4 GiB
# reserved but free) left no room for the logits' 4.64 GiB gradient
CONS = dict(replicas=4, batch=8, seq=4096, warmup=1, steps=2, eta=0.05,
            every=1, chunked_ce=True)
CONS_PARITY = dict(layers=2, replicas=2, batch=2, seq=256, eta=0.05)
CONS_REGIME = dict(replicas=4, eta=0.1, lr=3e-3, batch=8, seq=64, steps=10,
                   every=4, every_lr=1e-3, every_batch=4, every_seq=32,
                   every_steps=3)
CONS_ROUND_REPS = 3
# phase 23: the training CLI (``repro_torch.launch.train.main``) as the
# reference's end-to-end example runs it (examples/train_lm_consensus.py:
# mamba2-130m at its full published size, ``--trainer admm --mesh 4x2``,
# batch 8, seq 256): LAUNCH["steps"] steps and one save (ckpt_every past
# them), then a resume to LAUNCH["resume"]; the resumed steps' losses
# within LAUNCH_LOSS_RTOL of an in-process continuation of the saved state
# over the same batches (the stream's first two: a resume restarts the
# data key).  (b) card against CPU from one card-written file, fp32 (the
# config patch of tests/test_torch_launch_train.py), for each run of
# LAUNCH_PARITY_RUNS at LAUNCH_PARITY's sizes: the card writes ``write``,
# the card and the CPU each resume to ``resume``, the two files held to
# phase 22(b)'s bounds
LAUNCH = dict(arch="mamba2-130m", mesh="4x2", replicas=4, batch=8, seq=256,
              steps=6, resume=8, ckpt_every=1000, eta=0.05, seed=0)
LAUNCH_LOSS_RTOL = 1e-3
LAUNCH_PARITY = dict(batch=4, seq=32, write=2, resume=4)
LAUNCH_PARITY_RUNS = (
    ("mamba2-130m/admm", ["--arch", "mamba2-130m", "--trainer", "admm",
                          "--mesh", "2x1"]),
    ("qwen2-0.5b/allreduce", ["--arch", "qwen2-0.5b"]))
# phase 24: the one-card dry run.  (a) mamba2-130m at full size in two
# configurations, (name, step kind, batch, seq, mode, replicas): phase
# 18(d)'s bf16 prefill and phase 23's ADMM trainer (the reference
# example's R = 4, batch 8, seq 256), each traced on fake cuda tensors and
# run for real; the predicted peak over the measured within
# DRYRUN_PEAK_BAND.  (b) the module's CLI over every arch at full size at
# DRYRUN_CLI; DRYRUN_OVER_CARD's fp32 parameters alone pass 80 GB
DRYRUN_ARCH = "mamba2-130m"
DRYRUN_CASES = (("prefill/1x32768", "prefill", 1, 32768, "allreduce", 1),
                ("admm/R4/8x256", "train", 8, 256, "admm", 4))
DRYRUN_PEAK_BAND = (0.85, 1.05)
DRYRUN_CLI = ["--arch", "all", "--shape", "decode_32k", "--mesh", "1x1"]
DRYRUN_OVER_CARD = ("qwen2.5-32b", "deepseek-v2-236b",
                    "phi3.5-moe-42b-a6.6b")
# the figures phase's CPU runs go to one process started with the phase,
# with this many torch threads, beside its card runs
FIGURES_CPU_THREADS = 3

RECORDS = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (CUDA
    events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn) -> float:
    """Device time of one call of ``fn``: a spin kernel holds the card
    while the host enqueues the call, so the events between its launches
    see no host gap (``fn`` must not synchronize)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s at the H100's clock
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def burst_ms(fn, reps: int = 100) -> float:
    """Mean device time of one of ``reps`` back-to-back calls of ``fn``,
    all enqueued while a spin kernel holds the card (``device_ms``): the
    call's device time and the card's own gap between launches, without
    the host's enqueue or a graph replay's launch."""
    fn()
    return device_ms(lambda: [fn() for _ in range(reps)]) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``'s launches, captured once in a CUDA
    graph and replayed ``reps`` times: at the paper's sizes a kernel takes
    less time than the host needs to launch it, so ``cuda_ms`` of the
    wrapper measures the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def tflop_s(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_speed(kernel: str, rec: dict, beat_library: bool) -> None:
    """A large-regime Gram kernel must take at most twice its bound, and
    where ``beat_library`` less time than its einsum in the same run.
    Only gates the design clears by a wide margin: the panel and its
    einsum are at par, so their ratio is printed and not gated."""
    if not rec["ms"] <= 2 * rec["bound_ms"]:
        raise AssertionError(f"{kernel} takes more than twice its bound: "
                             f"{rec}")
    if beat_library and not rec["ms"] < rec["library_ms"]:
        raise AssertionError(f"{kernel} is not faster than its einsum: "
                             f"{rec}")


def max_err(got, want, rtol):
    """(largest error, largest magnitude of ``want``, within ``rtol`` of
    that magnitude)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, scale, err <= rtol * scale


def moved(want, lam0, hi) -> float:
    """How far the plain solve moved lam from its clipped warm start.  The
    check of a QP kernel must allow less than this, or a kernel that did
    nothing would pass it."""
    return float((want - torch.minimum(lam0.clamp_min(0.0), hi)).abs().max())


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version on the card
# ---------------------------------------------------------------------------
def regime_inputs(name: str, dev):
    """Operands at a regime's shapes.  Paper: the quickstart's own DTSVM
    invariants.  Large: bench_scale's large_fit data (seeded)."""
    from repro_torch.engine import invariants
    from repro_torch.core import dtsvm
    from repro_torch import quickstart

    r = REGIMES[name]
    if name == "paper":
        data, adj = quickstart.data_and_graph()
        prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], adj,
                                  C=0.01, device=dev)
        inv = invariants.compute_invariants(prob)
        Z, a, hi = (inv.Z.reshape(r["B"], r["N"], r["D"]),
                    inv.a.reshape(r["B"], r["D"]),
                    inv.hi.reshape(r["B"], r["N"]))
    else:
        rng = np.random.default_rng(0)
        Z = torch.from_numpy(rng.normal(size=(r["B"], r["N"], r["D"]))
                             .astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(0.05, 0.5, size=(r["B"], r["D"]))
                             .astype(np.float32)).to(dev)
        hi = torch.full((r["B"], r["N"]), 0.02, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = 1.0 + 0.1 * torch.randn(hi.shape, generator=gen, device=dev)
    lam0 = hi * torch.rand(hi.shape, generator=gen, device=dev)
    return Z, a, q, hi, lam0


def check_kernels(dev) -> dict:
    from repro_torch.kernels import gram as gram_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qp_step as qp_kernel
    from repro_torch.core import qp

    cases = {k: [] for k in KERNELS}
    for regime, r in REGIMES.items():
        B, N, D, iters, reps = r["B"], r["N"], r["D"], r["iters"], r["reps"]
        Z, a, q, hi, lam0 = regime_inputs(regime, dev)
        Z = Z.contiguous()
        shape = {"regime": regime, "B": B, "N": N, "D": D}

        # the operands of both Gram kernels: Z feature-major, unscaled and
        # scaled by a (exact: a transpose and one fp32 multiply)
        Zs = gram_kernel.prescale(Z, a)
        Zs_plain = ref.gram_prescale(Z, a)
        same = torch.equal(Zs, Zs_plain)
        err = float((Zs - Zs_plain).abs().max())
        b_ms, b_by = bound(4 * (B * N * D + B * D + 2 * B * N * D),
                           B * N * D)
        ms = cuda_ms(lambda: gram_kernel.prescale(Z, a), reps)
        # the library call: one broadcast torch.mul computes the same
        # zi * a, in Z's own layout and without the unscaled copy
        rec = dict(shape, max_abs_err=err, exact=same,
                   scratch_bytes=Zs.untyped_storage().nbytes(), ms=ms,
                   plain_ms=cuda_ms(lambda: ref.gram_prescale(Z, a), reps),
                   library_ms=cuda_ms(lambda: torch.mul(Z, a[:, None, :]),
                                      reps),
                   bound_ms=b_ms, bound_by=b_by,
                   tflop_s=tflop_s(B * N * D, ms))
        del Zs_plain
        emit({"kernel_check": "gram_prescale", **rec})
        if not same:
            raise AssertionError(f"gram_prescale disagrees: {rec}")
        cases["gram_prescale"].append(rec)

        # the weighted Gram build
        K = ops.weighted_gram(Z, a)
        K_plain = ref.weighted_gram(Z, a)
        torch.cuda.synchronize()
        err, scale, ok = max_err(K, K_plain, RTOL["f32"])
        symmetric = torch.equal(K, K.transpose(-1, -2))
        # K is symmetric: the function needs N(N+1)/2 dot products of
        # length D per problem, and the scaling of Z by a
        flops = B * N * (N + 1) * D + B * N * D
        b_ms, b_by = bound(4 * (B * N * D + B * D + B * N * N), flops)
        ms = cuda_ms(lambda: ops.weighted_gram(Z, a), reps)
        rec = dict(shape, max_abs_err=err, max_abs_plain=scale,
                   rtol=RTOL["f32"], bitwise_symmetric=symmetric, ms=ms,
                   plain_ms=cuda_ms(lambda: ref.weighted_gram(Z, a), reps),
                   library_ms=cuda_ms(lambda: torch.einsum(
                       "bnd,bd,bmd->bnm", Z, a, Z), reps),
                   bound_ms=b_ms, bound_by=b_by, tflop_s=tflop_s(flops, ms))
        del K_plain
        emit({"kernel_check": "weighted_gram", **rec})
        if not (ok and symmetric):
            raise AssertionError(f"weighted_gram disagrees: {rec}")
        if regime == "large":
            check_speed("weighted_gram", rec, beat_library=True)
        cases["weighted_gram"].append(rec)

        # the tiled Gram kernel: row panels of the prescaled Z into a
        # preallocated buffer
        for start, M in r["panels"]:
            Zm = Z[:, start:start + M]
            panel = torch.empty((B, M, N), device=dev)
            run = lambda: gram_kernel.weighted_gram_tiled(Zs, start, panel)
            run()
            panel_plain = ref.weighted_gram_rows(Zm, a, Z)
            torch.cuda.synchronize()
            err, scale, ok = max_err(panel, panel_plain, RTOL["f32"])
            same_rows = torch.equal(panel, K[:, start:start + M])
            # the yardstick of earlier runs: a rectangular M x N block,
            # 2*B*M*N*D FLOPs, and the scaling of its rows by a
            flops = 2 * B * M * N * D + B * M * D
            b_ms, b_by = bound(
                4 * (B * M * D + B * N * D + B * D + B * M * N), flops)
            ms = cuda_ms(run, reps)
            lib_ms = cuda_ms(lambda: torch.einsum("bnd,bd,bmd->bnm", Zm, a,
                                                  Z), reps)
            rec = dict(shape, M=M, row_start=start, max_abs_err=err,
                       max_abs_plain=scale, rtol=RTOL["f32"],
                       bitwise_square_rows=same_rows, ms=ms,
                       plain_ms=cuda_ms(
                           lambda: ref.weighted_gram_rows(Zm, a, Z), reps),
                       library_ms=lib_ms, vs_library=ms / lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       tflop_s=tflop_s(flops, ms))
            del panel, panel_plain
            emit({"kernel_check": "weighted_gram_tiled", **rec})
            if not (ok and same_rows):
                raise AssertionError(f"weighted_gram_tiled disagrees: {rec}")
            if regime == "large":
                check_speed("weighted_gram_tiled", rec, beat_library=False)
            cases["weighted_gram_tiled"].append(rec)
        del Zs

        gamma = 1.0 / qp.gershgorin_lipschitz(K)

        # one fused PG step
        out = ops.qp_pg_step(lam0, K, q, hi, gamma)
        out_plain = ref.qp_pg_step(lam0, K, q, hi, gamma)
        torch.cuda.synchronize()
        err, scale, ok = max_err(out, out_plain, RTOL["f32"])
        lam_moved = moved(out_plain, lam0, hi)
        ok = ok and RTOL["f32"] * scale < lam_moved
        b_ms, b_by = bound(4 * (B * N * N + 4 * B * N + B),
                           2 * B * N * N + 5 * B * N)
        rec = dict(shape, max_abs_err=err, max_abs_plain=scale,
                   rtol=RTOL["f32"], moved_from_warm_start=lam_moved,
                   ms=cuda_ms(lambda: ops.qp_pg_step(lam0, K, q, hi, gamma),
                              reps * 4),
                   plain_ms=cuda_ms(
                       lambda: ref.qp_pg_step(lam0, K, q, hi, gamma),
                       reps * 4),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit({"kernel_check": "qp_pg_step", **rec})
        if not ok:
            raise AssertionError(f"qp_pg_step disagrees: {rec}")
        cases["qp_pg_step"].append(rec)

        # a bf16 plan's K: converted once per plan (engine/plan.py), so
        # the bf16 solve is timed on it; 4 + 2 bytes per element moved
        K16 = K.to(torch.bfloat16)
        b_ms, b_by = bound(6 * B * N * N, 0)
        emit({"conversion": "K to bf16", **shape,
              "ms": cuda_ms(lambda: K.to(torch.bfloat16), reps),
              "bound_ms": b_ms, "bound_by": b_by})

        # the fused multi-iteration solve, f32 and bf16, with and without
        # the zl fold; bf16 on the converted K, and checked once more on
        # the f32 K, which the wrapper converts (the same bits)
        for precision in ("f32", "bf16"):
            Kp = K16 if precision == "bf16" else K
            for fold in (False, True):
                Zf = Z if fold else None
                run = lambda: ops.qp_pg_multi(lam0, Kp, q, hi, gamma,
                                              iters=iters, Z=Zf,
                                              precision=precision)
                run_f32_k = lambda: ops.qp_pg_multi(lam0, K, q, hi, gamma,
                                                    iters=iters, Z=Zf,
                                                    precision=precision)
                run_plain = lambda: ref.qp_pg_multi(
                    lam0, K, q, hi, gamma, iters=iters, Z=Zf,
                    precision=precision)
                got, want = run(), run_plain()
                repeat, from_f32_k = run(), run_f32_k()
                torch.cuda.synchronize()
                pairs = zip(got, want) if fold else [(got, want)]
                errs = [max_err(g, w, RTOL[precision]) for g, w in pairs]
                outs = lambda o: o if fold else (o,)
                repeatable = all(torch.equal(a, b) for a, b in
                                 zip(outs(got), outs(repeat)))
                same_from_f32_k = all(torch.equal(a, b) for a, b in
                                      zip(outs(got), outs(from_f32_k)))
                lam_moved = moved(want[0] if fold else want, lam0, hi)
                discriminates = RTOL[precision] * errs[0][1] < lam_moved
                # K in the product's type, read from HBM once per
                # iteration where it does not fit in the L2, else once
                k_bytes = (2 if precision == "bf16" else 4) * B * N * N
                k_reads = iters if k_bytes > L2_BYTES else 1
                b_ms, b_by = bound(
                    k_reads * k_bytes + 4 * (4 * B * N + B
                                             + (B * N * D + B * D if fold
                                                else 0)),
                    iters * (2 * B * N * N + 5 * B * N)
                    + (2 * B * N * D if fold else 0))
                launch = qp_kernel.qp_multi_shape(B, N, precision=precision,
                                                  fold=fold)
                rec = dict(shape, precision=precision, fold=fold,
                           iters=iters, launch=launch,
                           max_abs_err=max(e[0] for e in errs),
                           max_abs_plain=errs[0][1],
                           zl_max_abs_err=errs[1][0] if fold else None,
                           zl_max_abs_plain=errs[1][1] if fold else None,
                           rtol=RTOL[precision],
                           moved_from_warm_start=lam_moved,
                           repeatable=repeatable,
                           same_from_f32_K=same_from_f32_k,
                           ms=cuda_ms(run, max(reps // 2, 3)),
                           plain_ms=cuda_ms(run_plain, max(reps // 20, 2),
                                            warmup=1),
                           library_ms=None, bound_ms=b_ms, bound_by=b_by)
                if precision == "bf16":
                    # the call with an f32 K, converted inside every
                    # solve (a direct caller's)
                    rec["ms_f32_K"] = cuda_ms(run_f32_k, max(reps // 2, 3))
                if regime == "paper":
                    rec["graph_ms"] = graph_ms(run, reps)
                emit({"kernel_check": "qp_pg_multi", **rec})
                if not (discriminates and all(e[2] for e in errs)
                        and repeatable and same_from_f32_k):
                    raise AssertionError(f"qp_pg_multi disagrees: {rec}")
                cases["qp_pg_multi"].append(rec)
        del K, K16
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------
def risk_gap(a: dict, b: dict) -> float:
    return max(abs(x - y) for k in ("dtsvm", "dsvm")
               for x, y in zip(a[k], b[k]))


def expected_launches(qp_solver: str, fits: int, iters: int,
                      qp_iters: int, panels=None,
                      factored: bool = False) -> dict:
    """The launches of each kernel that ``fits`` fits must make: the
    square Gram once per fit, or with a budget that binds the tiled Gram
    ``panels`` times per fit (every problem of a fit in each launch); the
    prescale once per fit (once per build, square or streamed); the step
    kernel qp_iters times per ADMM iteration
    with ``pallas_fused``; the multi kernel once per ADMM iteration with
    ``pallas_fused_multi``, unless the factored operator replaces it."""
    squares = fits if panels is None else 0
    tiled = 0 if panels is None else fits * panels
    return {"weighted_gram": squares, "weighted_gram_tiled": tiled,
            "gram_prescale": fits,
            "qp_pg_step": (fits * iters * qp_iters
                           if qp_solver == "pallas_fused" else 0),
            "qp_pg_multi": (fits * iters if qp_solver == "pallas_fused_multi"
                            and not factored else 0)}


def check_launches(path: str, launches: dict, want: dict) -> None:
    """Each kernel's launches on ``path`` must be ``want``'s; a kernel
    ``want`` does not name must not have launched."""
    want = {k: want.get(k, 0) for k in launches}
    emit({"path_launches": path, "launches": launches, "expected": want})
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches}, "
                             f"expected {want}")


def main_path(by_path: dict) -> None:
    """The quickstart per engine, then under each budget; each run's
    launches are counted from 0 just before its fits on the card and read
    just after."""
    from repro_torch import quickstart
    from repro_torch.engine.invariants import PlanBudget
    from repro_torch.kernels import ops

    runs = [(label, kw, None, None) for label, kw in ENGINE_RUNS]
    runs += [(label, {"qp_solver": "pallas_fused_multi",
                      "budget": PlanBudget(tile=tile)}, panels,
              "pallas_fused_multi/f32") for label, tile, panels in BUDGET_RUNS]
    risks = {}
    for label, kw, panels, dense_label in runs:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        gpu = quickstart.main(device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[f"quickstart/{label}"] = launches = ops.launch_counts()
        risks[label] = gpu
        cpu = quickstart.main(device="cpu", **kw)
        gap = risk_gap(gpu, cpu)
        rec = {"quickstart": label, "wall_s": wall, "risks_cuda": gpu,
               "risks_cpu": cpu, "risk_gap": gap}
        if dense_label is not None:
            # K is bitwise the dense K; L only within rounding (the panels'
            # row sums may reduce in another order), so the risks are held
            # to the CPU gap and their equality is reported
            dense = risks[dense_label]
            rec["risks_equal_dense_cuda"] = (gpu["dtsvm"] == dense["dtsvm"]
                                             and gpu["dsvm"] == dense["dsvm"])
            rec["risk_gap_dense_cuda"] = dense_gap = risk_gap(gpu, dense)
        emit(rec)
        # DTSVM and DSVM: two fits of quickstart.main's config
        check_launches(f"quickstart/{label}", launches, expected_launches(
            kw["qp_solver"], fits=2, iters=60, qp_iters=100, panels=panels))
        if not gap <= 1e-3:
            raise AssertionError(f"{label}: risks on the card differ from "
                                 f"the CPU by {gap}")
        if dense_label is not None and not dense_gap <= 1e-3:
            raise AssertionError(f"{label}: risks differ from the dense "
                                 f"run's on the card by {dense_gap}: {gpu} "
                                 f"vs {risks[dense_label]}")
        if not gpu["dtsvm"][0] < gpu["dsvm"][0]:
            raise AssertionError(f"{label}: no transfer gain {gpu}")


def _fit_on_card(cfg, X, y, adj, by_path, path):
    """FIT_REPS DTSVM fits through the API on the card, their launches
    counted from 0 just before the first and read just after the last.
    Returns (the last fit's state, the fits' wall seconds, peak device
    bytes over them)."""
    from repro_torch.api import DTSVM
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fit_s = []
    for _ in range(FIT_REPS):
        t0 = time.perf_counter()
        st = DTSVM(cfg, device="cuda").fit(X, y, adj=adj).state_
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
    by_path[path] = ops.launch_counts()
    return st, fit_s, torch.cuda.max_memory_allocated()


def _walls(fit_s) -> dict:
    return {"fit_s": fit_s, "fit_s_median": float(np.median(fit_s)),
            "fit_s_min": min(fit_s), "fit_s_max": max(fit_s)}


def _state_errs(got, want, rtol):
    """Per leaf: (largest error, largest magnitude of ``want``, within)."""
    return {name: max_err(g.cpu(), w.cpu(), rtol)
            for name, g, w in zip(want._fields, got, want)}


def large_data():
    """The large fit's data (bench_scale's widths, seeded) and graph."""
    from repro_torch.core import graph

    V, T, N, p = (LARGE_FIT[k] for k in ("V", "T", "N", "p"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.sign(rng.normal(size=(V, T, N))).astype(np.float32)
    y = np.where(y == 0, 1.0, y).astype(np.float32)
    return X, y, graph.make_graph("ring", V, seed=0)


def large_fit(by_path: dict) -> None:
    """The large fit: dense per precision against the CPU (the only path
    that takes the multi kernel's cooperative grid), then the streamed and
    the factored f32 fits against the dense card fit."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import dtsvm
    from repro_torch.engine import invariants, plan
    from repro_torch.engine.invariants import PlanBudget

    V, T, N, p = (LARGE_FIT[k] for k in ("V", "T", "N", "p"))
    X, y, adj = large_data()
    base = SolverConfig(C=0.01, iters=LARGE_FIT["iters"],
                        qp_iters=LARGE_FIT["qp_iters"],
                        qp_solver="pallas_fused_multi")
    expect = dict(fits=FIT_REPS, iters=LARGE_FIT["iters"],
                  qp_iters=LARGE_FIT["qp_iters"])
    dense = {}
    for precision in ("f32", "bf16"):
        cfg = base.replace(qp_precision=precision)
        path = f"large_fit/{precision}"
        st, fit_s, peak = _fit_on_card(cfg, X, y, adj, by_path, path)
        dense[precision] = (st, peak)
        finite = all(bool(torch.isfinite(t).all()) for t in st)
        cpu = DTSVM(cfg, device="cpu").fit(X, y, adj=adj).state_
        errs = _state_errs(st, cpu, RTOL_FIT[precision])
        conversion = ({"per_solve_conversion_peak_mem_bytes":
                       PER_SOLVE_CONVERSION_PEAK_BYTES}
                      if precision == "bf16" else {})
        emit({"large_fit": precision, **LARGE_FIT, **_walls(fit_s),
              "peak_mem_bytes": peak, **conversion,
              "finite": finite,
              "vs_cpu_max_abs_err": {k: e[0] for k, e in errs.items()},
              "cpu_max_abs": {k: e[1] for k, e in errs.items()},
              "rtol": RTOL_FIT[precision]})
        check_launches(path, by_path[path], expected_launches(
            "pallas_fused_multi", **expect))
        if not finite:
            raise AssertionError("the large fit's state is not finite")
        if not all(e[2] for e in errs.values()):
            raise AssertionError(f"large fit on the card differs from the "
                                 f"CPU: {errs}")
        if conversion and not (abs(peak - PER_SOLVE_CONVERSION_PEAK_BYTES)
                               <= PEAK_MARGIN_BYTES):
            raise AssertionError(f"the bf16 fit peaked at {peak} bytes, not "
                                 f"within {PEAK_MARGIN_BYTES} of "
                                 f"{PER_SOLVE_CONVERSION_PEAK_BYTES}")
        del cpu

    # the large-n path: streamed and factored, against the dense card fit
    budget = PlanBudget(max_elems=LARGE_BUDGET)
    chunk = budget.row_chunk(V * T, N)
    panels = len(invariants._row_starts(N, chunk))
    st_dense, peak_dense = dense["f32"]
    init = dtsvm.init_state(DTSVM(base).make_problem(X, y, adj=adj,
                                                     device="cpu"))
    for label, kw in (("budget", {"budget": budget}),
                      ("factored", {"budget": budget,
                                    "qp_operator": "factored"})):
        path = f"large_fit/f32/{label}"
        st, fit_s, peak = _fit_on_card(base.replace(**kw), X, y, adj,
                                       by_path, path)
        errs = _state_errs(st, st_dense, RTOL_FIT["f32"])
        # the tolerance must be below how far the dense fit moved the
        # leaves it moves (alpha stays 0 at T=1: no task coupling)
        moved_by = {name: float((w.cpu() - i).abs().max())
                    for name, w, i in zip(st_dense._fields, st_dense, init)}
        discriminates = all(RTOL_FIT["f32"] * errs[k][1] < moved_by[k]
                            for k in ("r", "lam"))
        limit = peak_dense if label == "budget" else FACTORED_PEAK_BYTES
        emit({"large_fit": f"f32/{label}", **LARGE_FIT,
              "max_elems": LARGE_BUDGET, "row_chunk": chunk,
              "panels": panels, **_walls(fit_s), "peak_mem_bytes": peak,
              "peak_limit_bytes": limit,
              "dense_peak_mem_bytes": peak_dense,
              "vs_dense_cuda_max_abs_err": {k: e[0] for k, e in
                                            errs.items()},
              "dense_cuda_max_abs": {k: e[1] for k, e in errs.items()},
              "dense_moved_from_init": moved_by, "rtol": RTOL_FIT["f32"]})
        check_launches(path, by_path[path], expected_launches(
            "pallas_fused_multi", panels=panels,
            factored=label == "factored", **expect))
        if not (all(e[2] for e in errs.values()) and discriminates):
            raise AssertionError(f"large {label} fit differs from the dense "
                                 f"card fit: {errs}")
        if not peak < limit:
            raise AssertionError(f"large {label} fit peaked at {peak} bytes "
                                 f"of device memory, limit {limit}")
        del st
    del dense, st_dense

    # the invariants themselves, outside the counted fits: the streamed K
    # is the dense K bitwise; the factored plan holds no K
    prob = DTSVM(base).make_problem(X, y, adj=adj, device="cuda")
    inv_dense = invariants.compute_invariants(prob)
    inv_streamed = invariants.compute_invariants(prob, budget=budget)
    same_k = torch.equal(inv_streamed.K, inv_dense.K)
    L_dense = inv_dense.L
    l_err = max_err(inv_streamed.L, L_dense, RTOL_FIT["f32"])
    del inv_dense, inv_streamed
    torch.cuda.empty_cache()
    factored = plan.compile_problem(prob, base, budget=budget,
                                    qp_operator="factored")
    lf_err = max_err(factored.inv.L, L_dense, RTOL_FIT["f32"])
    emit({"large_invariants": "f32", "streamed_K_equal_dense": same_k,
          "streamed_L_max_abs_err": l_err[0],
          "factored_L_max_abs_err": lf_err[0], "L_max_abs": l_err[1],
          "factored_K_is_None": factored.inv.K is None})
    if not (same_k and l_err[2] and lf_err[2]
            and factored.inv.K is None):
        raise AssertionError("the streamed or factored invariants differ "
                             "from the dense ones")
    del factored, prob
    torch.cuda.empty_cache()


def large_replan(by_path: dict) -> None:
    """One partial ``Plan.replan`` at the large fit's widths (N=20000,
    p=256): its peak device memory, its launches, and the rebuilt K slices
    against a fresh build.

    At the large fit's V=2, T=1 no membership change leaves one of the two
    problems' ``a`` as it was: each node is the other's only neighbour,
    and with one task the coupling count is 0 whatever ``couple`` says.
    So the replan runs at V=2, T=2, where switching node 1's task coupling
    off changes ``a`` for its two problems and node 0's two K slices carry
    over.  The old plan's K is not written into (a caller may still hold
    the old plan), as in the reference."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import graph
    from repro_torch.engine import invariants, plan
    from repro_torch.kernels import ops

    V, T, N, p = (REPLAN_FIT[k] for k in ("V", "T", "N", "p"))
    rng = np.random.default_rng(1)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.where(rng.normal(size=(V, T, N)) >= 0, 1.0, -1.0).astype(
        np.float32)
    cfg = SolverConfig(C=0.01, qp_solver="pallas_fused_multi")
    prob = DTSVM(cfg).make_problem(X, y, adj=graph.make_graph("ring", V,
                                                              seed=0),
                                   device="cuda")
    old = plan.compile_problem(prob, cfg)
    couple = torch.ones_like(prob.couple)
    couple[1] = 0.0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    path = "large_replan/f32"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    new = old.replan(couple=couple)
    torch.cuda.synchronize()
    replan_s = time.perf_counter() - t0
    by_path[path] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    changed = (new.inv.a != old.inv.a).any(-1)
    n = int(changed.sum())
    fresh = invariants.compute_invariants(new.prob)
    rebuilt_equal = all(torch.equal(new.inv.K[v, t], fresh.K[v, t])
                        for v, t in changed.nonzero().tolist())
    kept_equal = all(torch.equal(new.inv.K[v, t], old.inv.K[v, t])
                     for v, t in (~changed).nonzero().tolist())
    old_untouched = not any(torch.equal(new.inv.K[v, t], old.inv.K[v, t])
                            for v, t in changed.nonzero().tolist())
    l_err = max_err(new.inv.L, fresh.L, RTOL_FIT["f32"])
    k_bytes = 4 * V * T * N * N
    emit({"large_replan": "f32", **REPLAN_FIT, "changed_problems": n,
          "replan_s": replan_s, "held_before_bytes": held,
          "peak_mem_bytes": peak, "peak_over_held_bytes": peak - held,
          "k_bytes": k_bytes, "stats": new.stats,
          "rebuilt_K_equal_fresh": rebuilt_equal,
          "kept_K_equal_old": kept_equal,
          "old_K_untouched": old_untouched, "L_max_abs_err": l_err[0]})
    check_launches(path, by_path[path], expected_launches(
        "pallas_fused_multi", fits=1, iters=0, qp_iters=0))
    if not (n == V * T // 2 and rebuilt_equal and kept_equal
            and old_untouched and l_err[2]):
        raise AssertionError("the partial replan's K or L differs from a "
                             "fresh build, or it rebuilt other slices")
    del old, new, fresh, prob
    torch.cuda.empty_cache()


def multi_mid(dev) -> None:
    """``--only multi_mid``: the multi solve with the fold, f32 and on a
    bf16 K, at MID's shapes, each against its plain version (the phase 3
    tolerance) and timed on CUDA events."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0)
    for B in MID["batches"]:
        for N in MID["Ns"]:
            Z = torch.from_numpy(rng.normal(size=(B, N, MID["D"]))
                                 .astype(np.float32)).to(dev)
            a = torch.from_numpy(rng.uniform(0.05, 0.5, size=(B, MID["D"]))
                                 .astype(np.float32)).to(dev)
            hi = torch.full((B, N), 0.02, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            q = 1.0 + 0.1 * torch.randn(hi.shape, generator=gen, device=dev)
            lam0 = hi * torch.rand(hi.shape, generator=gen, device=dev)
            K = ops.weighted_gram(Z, a)
            gamma = 1.0 / K.abs().sum(-1).amax(-1)
            for precision in ("f32", "bf16"):
                Kp = K.to(torch.bfloat16) if precision == "bf16" else K
                run = lambda: ops.qp_pg_multi(lam0, Kp, q, hi, gamma,
                                              iters=MID["iters"], Z=Z,
                                              precision=precision)
                got = run()
                want = ref.qp_pg_multi(lam0, K, q, hi, gamma,
                                       iters=MID["iters"], Z=Z,
                                       precision=precision)
                torch.cuda.synchronize()
                errs = [max_err(g, w, RTOL[precision])
                        for g, w in zip(got, want)]
                lam_moved = moved(want[0], lam0, hi)
                rec = {"multi_mid": precision, "B": B, "N": N,
                       "iters": MID["iters"],
                       "max_abs_err": max(e[0] for e in errs),
                       "max_abs_plain": errs[0][1],
                       "moved_from_warm_start": lam_moved,
                       "ms": cuda_ms(run, MID["reps"])}
                emit(rec)
                if not (all(e[2] for e in errs)
                        and RTOL[precision] * errs[0][1] < lam_moved):
                    raise AssertionError(f"qp_pg_multi disagrees: {rec}")
            del K, Kp
    torch.cuda.empty_cache()


#: the hand kernels by a fragment of their device names, as the profiler
#: lists them
# the span taxonomy (repro_torch/obs/spans.py) and the demo's own span
SPAN_NAMES = {"invariant_build", "plan_compile", "plan_replan",
              "scan_execute", "store_snapshot", "store_restore",
              "serve_batch", "demo_fit"}
PROFILED = {"weighted_gram": "gram_kernel",
            "weighted_gram_tiled": "gram_tiled_kernel",
            "gram_prescale": "gram_prescale_kernel",
            "qp_pg_step": "qp_step_kernel", "qp_pg_multi": "qp_multi_"}


def _trace_device(label: str, fn) -> dict:
    """Trace one call of ``fn`` with torch.profiler's CUDA activity alone
    and sum its device records from the raw events: the busy share, the
    launches, the five kernels of most device time and each hand
    kernel's launches.  ``key_averages`` over the CPU and CUDA activity
    took 233 s for the quarter of a million launches of a train step and
    up to 31 s for a fista sweep; the raw events take seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or \
                ev.is_user_annotation():
            continue
        ns, n = by_name.get(ev.name(), (0, 0))
        by_name[ev.name()] = (ns + ev.duration_ns(), n + 1)
    per_kernel = {k: sum(n for name, (_, n) in by_name.items()
                         if frag in name) for k, frag in PROFILED.items()}
    top = sorted(((ns, name[:80], n) for name, (ns, n) in by_name.items()),
                 reverse=True)
    busy_ns = sum(ns for ns, _ in by_name.values())
    emit({"profile": label, "traced_wall_s": wall,
          "summary_s": time.perf_counter() - t0,
          "device_busy_s": busy_ns / 1e9,
          "device_busy_share": busy_ns / 1e9 / wall,
          "device_launches": sum(n for _, n in by_name.values()),
          "our_kernels": per_kernel,
          "top": [{"name": name, "calls": n, "device_ms": ns / 1e6}
                  for ns, name, n in top[:5]]})
    return per_kernel


def _profile(label: str, fn, blocks=()) -> dict:
    """Trace one call of ``fn`` with torch.profiler: print its device busy
    share and launches, and where ``blocks`` names ``record_function``
    ranges that ``fn`` opens, the device ms of the kernels launched inside
    each; return the launches of each hand kernel.  Without ``blocks``
    the CUDA activity alone is traced (:func:`_trace_device`)."""
    from torch.profiler import ProfilerActivity, profile

    if not blocks:
        return _trace_device(label, fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    busy_us, launches = 0.0, 0
    per_kernel = {k: 0 for k in PROFILED}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a span is a record_function range: the profiler lists its
        # device-side projection, which is no kernel
        if (getattr(ev, "is_user_annotation", False) or ev.key in SPAN_NAMES
                or ev.key in blocks):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        busy_us += dev_us
        launches += ev.count
        top.append((dev_us, ev.key[:80], ev.count))
        for k, frag in PROFILED.items():
            if frag in ev.key:
                per_kernel[k] += ev.count
    top.sort(reverse=True)
    block_us = {name: 0.0 for name in blocks}
    block_calls = {name: 0 for name in blocks}
    if blocks:
        for ev in prof.events():
            # a range's total counts the kernels its child ops launched
            if ev.name in blocks and \
                    ev.device_type == torch.autograd.DeviceType.CPU:
                block_us[ev.name] += ev.device_time_total
                block_calls[ev.name] += 1
    extra = {"block_device_ms": {k: v / 1e3 for k, v in block_us.items()},
             "block_calls": block_calls} if blocks else {}
    emit({"profile": label, "traced_wall_s": wall, **extra,
          "summary_s": time.perf_counter() - t0,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "device_launches": launches, "our_kernels": per_kernel,
          "top": [{"name": n, "calls": c, "device_ms": t / 1e3}
                  for t, n, c in top[:5]]})
    return per_kernel


def profile_engines(seen: dict) -> None:
    """Trace each quickstart engine and the 8-row budgeted run; adds the
    launches of each hand kernel the profiler saw to ``seen``."""
    from repro_torch import quickstart
    from repro_torch.engine.invariants import PlanBudget

    label, tile, _ = BUDGET_RUNS[0]
    runs = ENGINE_RUNS + [(label, {"qp_solver": "pallas_fused_multi",
                                   "budget": PlanBudget(tile=tile)})]
    for label, kw in runs:
        per_kernel = _profile(label, lambda: quickstart.main(
            device="cuda", iters=PROFILE_ITERS, **kw))
        for k in seen:
            seen[k] += per_kernel[k]


# ---------------------------------------------------------------------------
# phase 7: the paper's figures
# ---------------------------------------------------------------------------
def fixture(name: str) -> dict:
    with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
        return json.load(f)


def figure_launches(name: str, regime: dict) -> dict:
    """The launches a figure's runner must make at ``regime``: a square
    Gram build (and its prescale) per fit, per sweep and per CSVM fit
    (every task in one); per ADMM iteration of a fit or a sweep one multi
    launch with ``pallas_fused_multi``, ``qp_iters`` step launches with
    ``pallas_fused``, none with ``fista``."""
    # (fits, sweeps, CSVM fits) per seed, and for Fig. 5 per scenario
    fits, sweeps, csvms = {"fig2": (2, 0, 1), "fig3": (0, 1, 1),
                           "fig4": (0, 1, 0), "fig5": (0, 1, 1),
                           "fig6": (0, 1, 0)}[name]
    reps = len(regime["seeds"]) * len(regime.get("pos_fracs", [0]))
    loops = reps * (fits + sweeps) * regime["iters"]
    solver = regime.get("qp_solver", "fista")
    builds = reps * (fits + sweeps + csvms)
    return {"weighted_gram": builds, "weighted_gram_tiled": 0,
            "gram_prescale": builds,
            "qp_pg_step": (loops * regime.get("qp_iters", 100)
                           if solver == "pallas_fused" else 0),
            "qp_pg_multi": loops if solver == "pallas_fused_multi" else 0}


def network_averages(name: str, out: dict) -> dict:
    """A figure's outputs as network-average risks: Fig. 6's per-node
    risks averaged over the nodes; every other output is one already."""
    if name == "fig6":
        return {k: np.asarray(v).mean(-1) for k, v in out.items()}
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def derived(name: str, out: dict) -> dict:
    """The figure's claim as numbers (its benchmark's ``emit`` line)."""
    if name == "fig2":
        t, d = out["dtsvm_curve"][-1], out["dsvm_curve"][-1]
        return {"dtsvm_t1": float(t[0]), "dsvm_t1": float(d[0]),
                "csvm_t1": float(out["csvm"][0]),
                "transfer_gain": float(d[0] - t[0])}
    if name in ("fig3", "fig4"):
        t1 = {tuple(row[:2]): row[2] for row in out["grid"]}
        best, worst = min(t1, key=t1.get), max(t1, key=t1.get)
        rec = {"best": list(best), "best_risk": float(t1[best]),
               "worst": list(worst), "worst_risk": float(t1[worst]),
               "tuning_range": float(t1[worst] - t1[best])}
        if name == "fig3":
            rec["csvm_t1"] = float(out["csvm"][0])
        return rec
    if name == "fig5":
        pf, t, d, c = min(out["scenarios"])        # the most unbalanced
        return {"pos_frac": pf, "dtsvm": t, "dsvm": d, "csvm": c,
                "gain_vs_csvm": c - t}
    left, right = np.asarray(out["left_dsvm"]), np.asarray(out["right_mixed"])
    return {"left_dsvm": float(left.mean()),
            "right_mixed": float(right.mean()),
            "dsvm_only_nodes_gain": float(left[:, 3:].mean()
                                          - right[:, 3:].mean())}


def figure_runs() -> list:
    """(label, figure, regime, held to the fixture): the five golden
    regimes, then each figure once at its paper regime (the widths of the
    reference's ``run(fast=False)``, one seed; Fig. 2 per network and per
    engine)."""
    from repro_torch.figures import (fig2_convergence, fig3_eps_sweep,
                                     fig4_c_sweep, fig5_unbalanced,
                                     fig6_mixed, golden)

    runs = [(f"golden/{n}", n, fixture(n)["regime"], True)
            for n in golden.FIGURES
            if n not in ("fig7", "fig7_churn")]     # phases 8 and 9
    for net, V, deg, n_tgt in fig2_convergence.NETS:
        for solver in FIG2_ENGINES:
            runs.append((f"paper/fig2/{net}/{solver}", "fig2",
                         dict(V=V, deg=deg, n_tgt=n_tgt, n_src=800,
                              seeds=[0], iters=fig2_convergence.ITERS,
                              n_test=1800, qp_solver=solver), False))
    runs += [
        ("paper/fig3", "fig3", dict(eps_grid=list(fig3_eps_sweep.EPS_GRID),
                                    seeds=[0], iters=fig3_eps_sweep.ITERS),
         False),
        ("paper/fig4", "fig4", dict(c_grid=list(fig4_c_sweep.C_GRID),
                                    e2_grid=list(fig4_c_sweep.E2_GRID),
                                    seeds=[0], iters=fig4_c_sweep.ITERS),
         False),
        ("paper/fig5", "fig5", dict(pos_fracs=list(fig5_unbalanced.POS_FRACS),
                                    seeds=[0], iters=fig5_unbalanced.ITERS),
         False),
        ("paper/fig6", "fig6", dict(seeds=[0], iters=fig6_mixed.ITERS),
         False)]
    return runs


def _fig3_sweep_setup():
    """Fig. 3's paper grid as ``sweep_vs_serial`` runs it: the config
    keys and dicts, the iterations and the data."""
    from repro_torch.figures import common, fig3_eps_sweep

    grid = fig3_eps_sweep.EPS_GRID
    keys = [(e1, e2) for e1 in grid for e2 in grid]
    cfgs = [dict(eps1=e1, eps2=e2) for e1, e2 in keys]
    data, A = common.build(10, [50, 400], degree=0.8667, seed=0)
    return keys, cfgs, fig3_eps_sweep.ITERS, 100, data, A


def figures_cpu_main(out: str) -> int:
    """``--figures-cpu OUT``: the CPU side of the figures phase (each
    run of ``figure_runs`` and Fig. 3's sweep per engine), pickled to
    OUT with each one's wall.  The script runs it in a process of its
    own, without the card, beside the phase's card runs."""
    import pickle

    torch.set_num_threads(FIGURES_CPU_THREADS)
    from repro_torch.figures import common, golden

    t_start = time.perf_counter()
    res = {"runs": {}, "sweeps": {}}
    for label, name, regime, _ in figure_runs():
        t0 = time.perf_counter()
        got = golden.outputs(name, regime, device="cpu")
        res["runs"][label] = (got, time.perf_counter() - t0)
    _, cfgs, iters, qp_iters, data, A = _fig3_sweep_setup()
    for solver in FIG2_ENGINES:
        t0 = time.perf_counter()
        cpu, _ = common.run_sweep(data, A, cfgs, iters, qp_iters=qp_iters,
                                  qp_solver=solver, device="cpu")
        res["sweeps"][solver] = ({"states": cpu.states,
                                  "final_risks": np.asarray(
                                      cpu.final_risks())},
                                 time.perf_counter() - t0)
    res["seconds"] = time.perf_counter() - t_start
    with open(out + ".part", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".part", out)
    return 0


class FiguresCpu:
    """The figures phase's CPU runs in a child process (``--figures-cpu``,
    no card visible to it), started with the phase so that they run
    beside its card runs; ``result`` waits for them."""

    live = []

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="figures_cpu_")
        self.out = os.path.join(self.dir, "cpu.pkl")
        self.err = open(os.path.join(self.dir, "stderr.txt"), "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--figures-cpu",
             self.out], stdout=subprocess.DEVNULL, stderr=self.err, env=env)
        FiguresCpu.live.append(self)

    def result(self) -> dict:
        import pickle
        import shutil

        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=900)
        wait_s = time.perf_counter() - t0
        self.err.close()
        with open(self.err.name) as f:
            err = f.read()
        if rc != 0:
            raise AssertionError(f"the figures' CPU process exited {rc}: "
                                 f"{err[-2000:]}")
        with open(self.out, "rb") as f:
            res = pickle.load(f)
        shutil.rmtree(self.dir, ignore_errors=True)
        FiguresCpu.live.remove(self)
        res["wait_s"] = wait_s
        res["since_start_s"] = time.perf_counter() - self.t0
        return res

    @classmethod
    def stop_all(cls) -> None:
        for job in cls.live:
            if job.proc.poll() is None:
                job.proc.kill()
                job.proc.wait()
        cls.live.clear()


def figures(by_path: dict, seen: dict, cases: dict) -> None:
    """Each figure run on the card and on the CPU: the card within one
    test sample (1/n_test) of the CPU in every network-average risk, a
    golden regime within ATOL of its fixture, its launches as
    ``figure_launches`` says.  Then Fig. 3's paper grid as one sweep and
    as a serial loop of the same fits, per engine.  The CPU runs come
    from a ``FiguresCpu`` child started first, which runs them beside
    the card runs (not beside phases 2-6: their host-bound readings
    moved with it there)."""
    from repro_torch.figures import golden
    from repro_torch.kernels import ops

    cpu_job = FiguresCpu()
    cards = []
    for label, name, regime, golden_run in figure_runs():
        path = f"figures/{label}"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card = golden.outputs(name, regime, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[path] = ops.launch_counts()
        cards.append((label, name, regime, golden_run, card, wall))
    cpu_res = cpu_job.result()
    emit({"figures_cpu": {
        "process_s": cpu_res["seconds"],
        "runs_s": sum(w for _, w in cpu_res["runs"].values()),
        "sweeps_s": sum(w for _, w in cpu_res["sweeps"].values()),
        "wait_s": cpu_res["wait_s"],
        "started_s_before_result": cpu_res["since_start_s"],
        "threads": FIGURES_CPU_THREADS}})
    for label, name, regime, golden_run, card, wall in cards:
        path = f"figures/{label}"
        launches = by_path[path]
        cpu, cpu_wall = cpu_res["runs"][label]
        n_test = regime.get("n_test", 1800)
        card_avg, cpu_avg = (network_averages(name, o) for o in (card, cpu))
        gap_cpu = max(float(np.abs(card_avg[k] - cpu_avg[k]).max())
                      for k in card_avg)
        rec = {"figure": label, **regime,
               "wall_s": wall, "cpu_wall_s": cpu_wall,
               "derived": derived(name, card),
               "derived_cpu": derived(name, cpu),
               "gap_to_cpu": gap_cpu, "limit_to_cpu": 1.0 / n_test}
        if name == "fig6":
            rec["per_node_gap_to_cpu"] = max(
                float(np.abs(np.asarray(card[k]) - np.asarray(cpu[k])).max())
                for k in card)
        if golden_run:
            want = fixture(name)["outputs"]
            rec["gap_to_fixture"] = max(
                float(np.abs(np.asarray(card[k], np.float64)
                             - np.asarray(want[k], np.float64)).max())
                for k in want)
            rec["limit_to_fixture"] = GOLDEN_ATOL
        emit(rec)
        check_launches(path, launches, figure_launches(name, regime))
        if not gap_cpu <= 1.0 / n_test + 1e-6:
            raise AssertionError(f"{label}: the card's risks differ from the "
                                 f"CPU's by {gap_cpu} > 1/{n_test}")
        if golden_run and not rec["gap_to_fixture"] <= GOLDEN_ATOL:
            raise AssertionError(f"{label}: {rec['gap_to_fixture']} from the "
                                 f"fixture, beyond {GOLDEN_ATOL}")
    sweep_vs_serial(by_path, seen, cases, cpu_res["sweeps"])


@contextlib.contextmanager
def captured(module, name: str):
    """Record the arguments of every call of ``module.name`` made while the
    block runs: the operands a path hands a kernel's wrapper, so that the
    kernel can be held against its plain version on exactly those."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def hold_gram(label: str, Z, a, cases: dict, built=None) -> None:
    """The square Gram kernel at a path's own operands (a Z shared by a
    stack of ``a``, or one ``a`` over a stack of Z) against its plain
    version on the operands broadcast to each other, at RTOL; ``built``,
    the K the path kept, must be this call's bits."""
    from repro_torch.kernels import ops, ref

    K = ops.weighted_gram(Z, a)
    Zb = ops.broadcast_z(Z, a)
    ab = a.expand(Zb.shape[:-2] + a.shape[-1:])
    K_plain = ref.weighted_gram(Zb, ab)
    torch.cuda.synchronize()
    err, scale, ok = max_err(K, K_plain, RTOL["f32"])
    B, (N, D) = Zb[..., 0, 0].numel(), Zb.shape[-2:]
    flops = B * N * (N + 1) * D + B * N * D
    b_ms, b_by = bound(4 * (Z.numel() + a.numel() + B * N * N), flops)
    rec = {"regime": label, "B": B, "N": N, "D": D,
           "z_shape": list(Z.shape), "a_shape": list(a.shape),
           "max_abs_err": err, "max_abs_plain": scale, "rtol": RTOL["f32"],
           "ms": cuda_ms(lambda: ops.weighted_gram(Z, a), 50),
           "plain_ms": cuda_ms(lambda: ref.weighted_gram(Zb, ab), 50),
           "library_ms": cuda_ms(lambda: torch.einsum(
               "...nd,...d,...md->...nm", Zb, ab, Zb), 50),
           "bound_ms": b_ms, "bound_by": b_by}
    if built is not None:
        rec["equals_built_k"] = torch.equal(K, built)
        ok = ok and rec["equals_built_k"]
    emit({"kernel_check": "weighted_gram", **rec})
    if not ok:
        raise AssertionError(f"weighted_gram disagrees at {label}: {rec}")
    cases["weighted_gram"].append(rec)


def hold_multi(label: str, args: tuple, kw: dict, cases: dict) -> None:
    """The multi solve at one call's own operands (``args``, ``kw`` as the
    path passed them: a shared Z is broadcast only for the plain
    version) against its plain version at RTOL, with the moved guard."""
    from repro_torch.kernels import ops, ref

    lam0, K, q, hi, gamma = args
    iters, Z = kw["iters"], kw.get("Z")
    precision = kw.get("precision", "f32")
    Zb = None if Z is None else ops.broadcast_z(Z, lam0)
    run = lambda: ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                                  precision=precision)
    run_plain = lambda: ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters,
                                        Z=Zb, precision=precision)
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    outs = lambda o: o if Z is not None else (o,)
    errs = [max_err(g, w, RTOL[precision])
            for g, w in zip(outs(got), outs(want))]
    lam_moved = moved(outs(want)[0], lam0, hi)
    B, N = lam0[..., 0].numel(), lam0.shape[-1]
    k_bytes = (2 if precision == "bf16" else 4) * B * N * N
    k_reads = iters if k_bytes > L2_BYTES else 1
    fold_bytes = 0 if Z is None else 4 * (Z.numel() + B * Z.shape[-1])
    b_ms, b_by = bound(
        k_reads * k_bytes + 4 * (4 * B * N + B) + fold_bytes,
        iters * (2 * B * N * N + 5 * B * N)
        + (0 if Z is None else 2 * B * N * Z.shape[-1]))
    rec = {"regime": label, "B": B, "N": N, "iters": iters,
           "precision": precision, "fold": Z is not None,
           "z_shape": None if Z is None else list(Z.shape),
           "max_abs_err": max(e[0] for e in errs),
           "max_abs_plain": errs[0][1],
           "zl_max_abs_err": errs[1][0] if Z is not None else None,
           "zl_max_abs_plain": errs[1][1] if Z is not None else None,
           "rtol": RTOL[precision], "moved_from_warm_start": lam_moved,
           "ms": cuda_ms(run, 20), "plain_ms": cuda_ms(run_plain, 5),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"kernel_check": "qp_pg_multi", **rec})
    if not (all(e[2] for e in errs)
            and RTOL[precision] * errs[0][1] < lam_moved):
        raise AssertionError(f"qp_pg_multi disagrees at {label}: {rec}")
    cases["qp_pg_multi"].append(rec)


def sweep_vs_serial(by_path: dict, seen: dict, cases: dict,
                    cpu_sweeps: dict) -> None:
    """Fig. 3's paper grid (16 eps configs, V=10, 60 ADMM iterations of
    100 QP iterations, seed 0) as one sweep and as the serial loop of its
    16 fits, per engine, both on the card: the walls, the launches (the
    sweep: one Gram build, one multi launch per iteration), the final
    risks within one test sample of each other; the card sweep's final
    states within RTOL_FIT of the same sweep on the CPU, its risks within
    one test sample; then the kernels at these paths' own operands (the
    sweep's build and its second multi solve, and CSVM's pooled build
    on the same data) against their plain versions, and a torch.profiler
    trace of each sweep.  ``cpu_sweeps`` holds the CPU sweep per engine
    (``figures_cpu_main``)."""
    from repro_torch.figures import common
    from repro_torch.kernels import ops

    keys, cfgs, iters, qp_iters, data, A = _fig3_sweep_setup()
    n_test = data["X_test"].shape[1]
    for solver in FIG2_ENGINES:
        multi = solver == "pallas_fused_multi"
        ops.reset_launch_counts()
        with captured(ops, "weighted_gram") as gram_calls, \
                captured(ops, "qp_pg_multi") as multi_calls:
            res, sweep_s = common.run_sweep(data, A, cfgs, iters,
                                            qp_iters=qp_iters,
                                            qp_solver=solver, device="cuda")
        by_path[f"figures/sweep/fig3/{solver}"] = sweep_n = \
            ops.launch_counts()
        ops.reset_launch_counts()
        serial_s, serial = [], []
        for e1, e2 in keys:
            _, hist, dt, _ = common.run_dtsvm(data, A, iters, eps1=e1,
                                              eps2=e2, qp_iters=qp_iters,
                                              qp_solver=solver,
                                              device="cuda")
            serial_s.append(dt)
            serial.append(hist[-1])
        by_path[f"figures/serial/fig3/{solver}"] = serial_n = \
            ops.launch_counts()
        cpu, cpu_sweep_s = cpu_sweeps[solver]
        states = _state_errs(res.states, cpu["states"], RTOL_FIT["f32"])
        gap = float(np.abs(res.final_risks() - np.stack(serial)).max())
        gap_cpu = float(np.abs(res.final_risks()
                               - cpu["final_risks"]).max())
        emit({"sweep_vs_serial": f"fig3/{solver}", "configs": len(cfgs),
              "V": 10, "iters": iters, "qp_iters": qp_iters,
              "sweep_wall_s": sweep_s, "serial_wall_s": sum(serial_s),
              "serial_over_sweep": sum(serial_s) / sweep_s,
              "serial_fit_s_median": float(np.median(serial_s)),
              "cpu_sweep_wall_s": cpu_sweep_s,
              "risk_gap": gap, "limit": 1.0 / n_test,
              "risk_gap_to_cpu": gap_cpu,
              "state_errs_to_cpu": states, "state_rtol": RTOL_FIT["f32"]})
        check_launches(f"figures/sweep/fig3/{solver}", sweep_n, {
            "weighted_gram": 1, "weighted_gram_tiled": 0,
            "gram_prescale": 1, "qp_pg_step": 0,
            "qp_pg_multi": iters if multi else 0})
        check_launches(f"figures/serial/fig3/{solver}", serial_n, {
            "weighted_gram": len(cfgs), "weighted_gram_tiled": 0,
            "gram_prescale": len(cfgs), "qp_pg_step": 0,
            "qp_pg_multi": len(cfgs) * iters if multi else 0})
        if not gap <= 1.0 / n_test + 1e-6:
            raise AssertionError(f"fig3 sweep ({solver}) differs from its "
                                 f"serial fits by {gap}")
        if not gap_cpu <= 1.0 / n_test + 1e-6:
            raise AssertionError(f"fig3 sweep ({solver}): the card's risks "
                                 f"differ from the CPU's by {gap_cpu}")
        if not all(ok for _, _, ok in states.values()):
            raise AssertionError(f"fig3 sweep ({solver}): the card's states "
                                 f"differ from the CPU's: {states}")
        if multi:
            (Z, a), _ = gram_calls[0]
            hold_gram("fig3_sweep", Z, a, cases, built=res.plan.inv.K)
            args, kw = multi_calls[1]
            hold_multi("fig3_sweep/iteration_2", args, kw, cases)
        per_kernel = _profile(f"fig3 sweep/{solver}", lambda: common.run_sweep(
            data, A, cfgs, iters, qp_iters=qp_iters, qp_solver=solver,
            device="cuda"))
        for k in seen:
            seen[k] += per_kernel[k]
    with captured(ops, "weighted_gram") as gram_calls:
        common.run_csvm_per_task(data, device="cuda")
    (Z, a), _ = gram_calls[0]
    hold_gram("fig3_csvm", Z, a, cases)


# ---------------------------------------------------------------------------
# phase 8: the online sessions of Fig. 7
# ---------------------------------------------------------------------------
def _session_run(path: str, by_path: dict, stage_iters: int,
                 runner=None, **kw):
    """``fig7_online.stage_marks`` (or ``runner``, e.g. ``churn_marks``)
    on the card, its launches counted from 0 just before and read just
    after, and the problems of each square Gram launch.  Returns (marks,
    info, launches, Gram problems, wall)."""
    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops

    runner = runner or fig7_online.stage_marks
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with captured(ops, "weighted_gram") as grams:
        marks, info = runner(stage_iters, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path[path] = launches = ops.launch_counts()
    problems = [int(np.prod(torch.broadcast_shapes(Z.shape[:-2],
                                                   a.shape[:-1])))
                for (Z, a), _ in grams]
    return marks, info, launches, problems, wall


def _marks_gap(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max())
               for k in b)


def session_launches(info: dict, problems: list, builds: int,
                     stage_iters: int, qp_solver: str, panels=None,
                     factored: bool = False) -> dict:
    """The launches a Fig. 7 session and its replay must make: one build
    of the changed K slices per compile and per replan that changed an
    ``a`` row (``builds``, each one prescale and one square launch, or
    ``panels`` tiled launches under a binding budget; the factored
    operator's L-only build one tiled launch, its panel all 40 rows);
    one multi launch per ADMM iteration with ``pallas_fused_multi``.
    The square launches' problems must sum to the slices ``plan_stats``
    counts."""
    stats = info["plan_stats"]["gram_slices_computed"] + \
        info["replay_plan_stats"]["gram_slices_computed"]
    if panels is None and not factored and sum(problems) != stats:
        raise AssertionError(f"the square Gram launches built "
                             f"{sum(problems)} problems, plan_stats "
                             f"counts {stats}")
    squares = 0 if (panels or factored) else builds
    tiled = builds * (panels or 1) if (panels or factored) else 0
    iters = 2 * 5 * stage_iters        # five stages, live and replay
    return {"weighted_gram": squares, "weighted_gram_tiled": tiled,
            "gram_prescale": builds, "qp_pg_step": 0,
            "qp_pg_multi": iters if qp_solver == "pallas_fused_multi"
            and not factored else 0}


def check_replans(label: str, info: dict) -> None:
    """Fig. 7's protocol replans the live session and its replay once per
    stage switch."""
    from repro_torch.figures import fig7_online

    want = len(fig7_online.STAGES) - 1
    for key in ("plan_stats", "replay_plan_stats"):
        if info[key]["replans"] != want:
            raise AssertionError(f"{label}: {key} counts "
                                 f"{info[key]['replans']} replans, the "
                                 f"protocol makes {want}")


def sessions(by_path: dict, seen: dict, cases: dict) -> None:
    """Fig. 7's golden regime and paper regime per engine, card against
    CPU; the other plan modes through the paper regime's replans; the
    kernels at a partial replan's and a session step's own operands."""
    from repro_torch.engine.invariants import PlanBudget
    from repro_torch.figures import fig7_online

    phase_t0 = time.perf_counter()
    regime = fixture("fig7")["regime"]
    runs = [("golden/fig7", regime, {})]
    runs += [(f"paper/fig7/{engine}", FIG7_PAPER, {"qp_solver": engine})
             for engine in FIG7_ENGINES]
    # one build of the changed K slices per stage (the compile, then four
    # replans that each change an ``a`` row), live and replay: fixed by
    # the protocol, not read from the run
    builds = 2 * len(fig7_online.STAGES)
    for label, reg, kw in runs:
        r = dict(reg)
        stage_iters = r.pop("stage_iters")
        path = f"sessions/{label}"
        marks, info, launches, problems, wall = _session_run(
            path, by_path, stage_iters, **r, **kw)
        t0 = time.perf_counter()
        cpu, cpu_info = fig7_online.stage_marks(stage_iters, device="cpu",
                                                **r, **kw)
        cpu_wall = time.perf_counter() - t0
        gap_cpu = _marks_gap(marks, cpu)
        rec = {"session": label, **reg, **kw, "wall_s": wall,
               "stage_s": info["stage_s"], "replay_s": info["replay_s"],
               "cpu_wall_s": cpu_wall, "cpu_stage_s": cpu_info["stage_s"],
               "replay_bitwise": True, "plan_stats": info["plan_stats"],
               "gram_launch_problems": problems,
               "derived": fig7_online.derived(marks),
               "derived_cpu": fig7_online.derived(cpu),
               "gap_to_cpu": gap_cpu, "limit_to_cpu": 1.0 / r["n_test"]}
        if label.startswith("golden"):
            rec["gap_to_fixture"] = _marks_gap(marks,
                                               fixture("fig7")["outputs"])
            rec["limit_to_fixture"] = GOLDEN_ATOL
        emit(rec)
        check_replans(label, info)
        check_launches(path, launches, session_launches(
            info, problems, builds, stage_iters,
            kw.get("qp_solver", "fista")))
        if not gap_cpu <= 1.0 / r["n_test"] + 1e-6:
            raise AssertionError(f"{label}: the card's risks differ from the "
                                 f"CPU's by {gap_cpu} > 1/{r['n_test']}")
        if "gap_to_fixture" in rec and \
                not rec["gap_to_fixture"] <= GOLDEN_ATOL:
            raise AssertionError(f"{label}: {rec['gap_to_fixture']} from the "
                                 f"fixture, beyond {GOLDEN_ATOL}")
        if label.startswith("paper"):
            trace_stage(kw["qp_solver"], seen)
        if kw.get("qp_solver") == "pallas_fused_multi":
            dense = (marks, info["session"].state)    # the modes' yardstick

    # the other plan modes of the multi engine, through the same replans
    r = dict(FIG7_PAPER)
    stage_iters = r.pop("stage_iters")
    base = {"qp_solver": "pallas_fused_multi"}
    budget = PlanBudget(tile=(8, 128))             # 8-row panels of N=40
    modes = [("budget", {"budget": budget}, budget.row_chunk(1, 40)),
             ("bf16", {"qp_precision": "bf16"}, None),
             ("factored", {"qp_operator": "factored"}, None)]
    for label, kw, chunk in modes:
        path = f"sessions/paper/fig7/pallas_fused_multi/{label}"
        marks, info, launches, problems, wall = _session_run(
            path, by_path, stage_iters, **r, **base, **kw)
        sess = info["session"]
        errs = _state_errs(sess.state, dense[1], RTOL_FIT["f32"])
        if label == "bf16":
            # bf16 is held as phase 5 holds it: against the same session
            # on the CPU, within the bf16 tolerance
            _, cpu_info = fig7_online.stage_marks(stage_iters, device="cpu",
                                                  **r, **base, **kw)
            held = _state_errs(sess.state, cpu_info["session"].state,
                               RTOL_FIT["bf16"])
            against = "the same session on the CPU"
        else:
            held, against = errs, "the dense f32 session"
        rec = {"session": f"paper/fig7/pallas_fused_multi/{label}",
               "wall_s": wall, "stage_s": info["stage_s"],
               "replay_s": info["replay_s"], "replay_bitwise": True,
               "plan_stats": info["plan_stats"],
               "derived": fig7_online.derived(marks),
               "risk_gap_to_f32": _marks_gap(marks, dense[0]),
               "state_errs_to_f32": {k: e[0] for k, e in errs.items()},
               "f32_max_abs": {k: e[1] for k, e in errs.items()},
               "state_equal_f32": all(torch.equal(a, b) for a, b in
                                      zip(sess.state, dense[1])),
               "plan_has_K": sess._plan.inv.K is not None,
               "held_against": against,
               "held_errs": {k: e[0] for k, e in held.items()},
               "held_max_abs": {k: e[1] for k, e in held.items()},
               "held_rtol": RTOL_FIT["bf16" if label == "bf16" else "f32"]}
        emit(rec)
        check_replans(label, info)
        panels = None if chunk is None else -(-40 // chunk)
        check_launches(path, launches, session_launches(
            info, problems, builds, stage_iters, "pallas_fused_multi",
            panels=panels, factored=label == "factored"))
        if not all(e[2] for e in held.values()):
            raise AssertionError(f"the {label} session differs from "
                                 f"{against}: {held}")
        if not rec["risk_gap_to_f32"] <= MODE_RISK_GAP:
            raise AssertionError(f"the {label} session's risks are "
                                 f"{rec['risk_gap_to_f32']} from f32's")
        if rec["plan_has_K"] == (label == "factored"):
            raise AssertionError(f"the {label} session's plan has K: "
                                 f"{rec['plan_has_K']}")
    session_operands(cases)
    emit({"phase": "sessions", "seconds": time.perf_counter() - phase_t0})


def trace_stage(engine: str, seen: dict) -> None:
    """A torch.profiler trace of one paper-regime stage (stage 2: its
    replan of all 18 slices and its 30 ADMM iterations), the unit an
    online user waits for; adds the hand kernels' launches to ``seen``.
    One stage, not the whole run: the profiler's summary of the fista
    run's 290k launches took 128 s (measured on one H100)."""
    from repro_torch.figures import fig7_online

    r = dict(FIG7_PAPER)
    stage_iters = r.pop("stage_iters")
    sess = fig7_online.make_session(device="cuda", qp_solver=engine, **r)
    for i, (_, tasks, couple) in enumerate(fig7_online.STAGES[:2]):
        fig7_online.enter_stage(sess, tasks, couple)
        if i == 0:
            sess.run(stage_iters)
    per_kernel = _profile(f"fig7 stage 2/{engine}",
                          lambda: sess.run(stage_iters))
    for k in seen:
        seen[k] += per_kernel[k]


def session_operands(cases: dict) -> None:
    """The kernels at a session's own operands: the last stage's partial
    replan (Task 2 leaves: 12 of 18 slices change) builds K from
    ``Z[changed]``, ``a[changed]``, held against the plain version and
    bitwise the slices the new plan kept, the untouched slices
    ``torch.equal`` to the old plan's, which the replan leaves as it
    was; and the multi solve of the stage's second step.  The leaving
    task's slices weigh its bias by 1/1e-6 (U's floor), so the Gram
    kernel is also held per problem, at RTOL of that problem's largest
    magnitude."""
    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops, ref

    sess = fig7_online.make_session(device="cuda", n_test=100,
                                    qp_solver="pallas_fused_multi")
    for _, tasks, couple in fig7_online.STAGES[:-1]:
        fig7_online.enter_stage(sess, tasks, couple)
        sess.run(2)
    old = sess._plan
    old_K = old.inv.K.clone()
    fig7_online.enter_stage(sess, *fig7_online.STAGES[-1][1:])
    with captured(ops, "weighted_gram") as grams, \
            captured(ops, "qp_pg_multi") as multis:
        sess.run(2)
    new = sess._plan
    changed = (new.inv.a != old.inv.a).any(-1)
    n = int(changed.sum())
    (Z, a), _ = grams[0]
    K_plain = ref.weighted_gram(Z, a)
    per_problem = ((new.inv.K[changed] - K_plain).abs().amax((-2, -1))
                   / K_plain.abs().amax((-2, -1)))
    rec = {"session_replan": "fig7/s5_t2_leaves", "changed_problems": n,
           "problems": changed.numel(), "gram_calls": len(grams),
           "z_shape": list(Z.shape),
           "max_rel_err_per_problem": float(per_problem.max()),
           "rtol": RTOL["f32"],
           "kept_K_equal_old": torch.equal(new.inv.K[~changed],
                                           old.inv.K[~changed]),
           "old_K_untouched": torch.equal(old.inv.K, old_K)}
    emit(rec)
    if not (len(grams) == 1 and 0 < n < changed.numel()
            and Z.shape[0] == a.shape[0] == n and rec["kept_K_equal_old"]
            and rec["old_K_untouched"]
            and rec["max_rel_err_per_problem"] <= RTOL["f32"]):
        raise AssertionError(f"the partial replan is not what it should "
                             f"be: {rec}")
    hold_gram("fig7_replan", Z, a, cases, built=new.inv.K[changed])
    args, kw = multis[1]
    hold_multi("fig7_session/step_2", args, kw, cases)


# ---------------------------------------------------------------------------
# phase 9: the communication fabric
# ---------------------------------------------------------------------------
def fabric(by_path: dict, seen: dict, cases: dict) -> None:
    """Fig. 7's churn variant (golden regime and paper regime per engine,
    card against CPU), BENCH_comms' error-feedback point, the identity
    fabric at the large fit, a trace of one paper stage per exchange
    mode, and the kernels at a churn session's own operands."""
    from repro_torch.figures import fig7_online

    phase_t0 = time.perf_counter()
    runs = [("golden/fig7_churn", fixture("fig7_churn")["regime"], {})]
    runs += [(f"paper/fig7_churn/{engine}", FIG7_PAPER,
              {"qp_solver": engine}) for engine in FIG7_ENGINES]
    # as phase 8: one build of the changed K slices per stage, live and
    # replay; a node event changes no task mask and so replans nothing
    builds = 2 * len(fig7_online.STAGES)
    for label, reg, kw in runs:
        r = dict(reg)
        stage_iters = r.pop("stage_iters")
        path = f"fabric/{label}"
        marks, info, launches, problems, wall = _session_run(
            path, by_path, stage_iters, runner=fig7_online.churn_marks,
            **r, **kw)
        t0 = time.perf_counter()
        cpu, cpu_info = fig7_online.churn_marks(stage_iters, device="cpu",
                                                **r, **kw)
        cpu_wall = time.perf_counter() - t0
        gap_cpu = _marks_gap(marks, cpu)
        rep, cpu_rep = info["net_report"], cpu_info["net_report"]
        rec = {"churn": label, **reg, **kw, "wall_s": wall,
               "stage_s": info["stage_s"], "replay_s": info["replay_s"],
               "cpu_wall_s": cpu_wall, "cpu_stage_s": cpu_info["stage_s"],
               "replay_bitwise": True,
               "alive": info["session"].node_status["alive"].tolist(),
               "marks": {k: v.tolist() for k, v in marks.items()},
               "derived": fig7_online.derived(marks),
               "derived_cpu": fig7_online.derived(cpu),
               "gap_to_cpu": gap_cpu, "limit_to_cpu": 1.0 / r["n_test"],
               "bytes_per_round": rep["bytes_per_round"],
               "msgs_sent": rep["msgs_sent"],
               "delivery_rate": rep["delivery_rate"],
               "warmfill_msgs": rep["warmfill_msgs"],
               "max_silence": rep["max_silence"],
               "counters_equal_cpu": all(
                   rep[k] == cpu_rep[k] for k in
                   ("msgs_sent", "msgs_delivered", "bytes_sent",
                    "warmfill_msgs", "max_silence", "stale_edges"))}
        if label.startswith("golden"):
            rec["gap_to_fixture"] = _marks_gap(
                marks, fixture("fig7_churn")["outputs"])
            rec["limit_to_fixture"] = GOLDEN_ATOL
        emit(rec)
        check_replans(label, info)
        check_launches(path, launches, session_launches(
            info, problems, builds, stage_iters,
            kw.get("qp_solver", "fista")))
        if not gap_cpu <= 1.0 / r["n_test"] + 1e-6:
            raise AssertionError(f"{label}: the card's risks differ from the "
                                 f"CPU's by {gap_cpu} > 1/{r['n_test']}")
        if "gap_to_fixture" in rec and \
                not rec["gap_to_fixture"] <= GOLDEN_ATOL:
            raise AssertionError(f"{label}: {rec['gap_to_fixture']} from the "
                                 f"fixture, beyond {GOLDEN_ATOL}")
    comms_error_feedback(by_path)
    general_fabric(by_path)
    identity_large(by_path)
    trace_exchange(seen)
    fabric_operands(cases)
    emit({"phase": "fabric", "seconds": time.perf_counter() - phase_t0})


def comms_error_feedback(by_path: dict) -> None:
    """BENCH_comms' error-feedback point on the card and on the CPU:
    float32 (vmap), int8 and int8 with error feedback; each card fit's
    risks within 1/n_test of the CPU's, its counters and bytes equal;
    the two int8 fits at identical bytes per round, error feedback no
    worse in risk and closer to the float32 solution (the assertions of
    bench_comms.py)."""
    from repro_torch.api import DTSVM, LinkPolicy, NetConfig, SolverConfig
    from repro_torch.figures.common import build
    from repro_torch.kernels import ops

    data, A = build(COMMS["V"], list(COMMS["n_per_task"]),
                    degree=COMMS["degree"], seed=0, n_test=COMMS["n_test"])
    cfg = SolverConfig(C=0.01, eps2=1.0, iters=COMMS["iters"],
                       qp_iters=COMMS["qp_iters"])
    nets = (("float32", None),
            ("int8", NetConfig(policy=LinkPolicy(quant="int8"))),
            ("int8+ef", NetConfig(policy=LinkPolicy(quant="int8"),
                                  error_feedback=True)))
    fits = {"cuda": {}, "cpu": {}}
    for dev in ("cuda", "cpu"):
        for label, net in nets:
            if dev == "cuda":
                ops.reset_launch_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = DTSVM(cfg.replace(net=net), device=dev).fit(
                data["X"], data["y"], mask=data["mask"], adj=A)
            if dev == "cuda":
                torch.cuda.synchronize()
                by_path[f"fabric/comms/{label}"] = ops.launch_counts()
            wall = time.perf_counter() - t0
            fits[dev][label] = (fit, fit.risks(data["X_test"],
                                               data["y_test"]).cpu(), wall)
    counters = ("bytes_per_round", "bytes_sent", "msgs_sent",
                "msgs_delivered")
    recs = {}
    for label, net in nets:
        rec = {"comms": label}
        for dev in ("cuda", "cpu"):
            fit, risks, wall = fits[dev][label]
            base_fit, base_risks, _ = fits[dev]["float32"]
            rep = fit.net_report_ or {}
            rec[dev] = {
                "wall_s": wall, "mode": rep.get("mode", "vmap"),
                **{k: rep[k] for k in counters if k in rep},
                "final_risks_mean": risks.mean(0).tolist(),
                "max_abs_risk_delta_vs_float32": float(
                    (risks - base_risks).abs().max()),
                "solution_gap_vs_float32": float(
                    (fit.state_.r - base_fit.state_.r).abs().mean())}
        errs = _state_errs(fits["cuda"][label][0].state_,
                           fits["cpu"][label][0].state_, RTOL_FIT["f32"])
        rec["state_rel_errs_to_cpu"] = {
            k: e[0] / max(e[1], 1e-30) for k, e in errs.items()}
        rec["risk_gap_to_cpu"] = float(
            (fits["cuda"][label][1] - fits["cpu"][label][1]).abs().max())
        rec["counters_equal_cpu"] = all(rec["cuda"].get(k) ==
                                        rec["cpu"].get(k) for k in counters)
        recs[label] = rec
    # an int8 code rounds x / scale to an integer, so a last-bit
    # difference between the card's products and the CPU's can move a
    # mailbox entry by a whole step (max|x| / 127) and the run goes on
    # from there: the int8 fits are held to the CPU within the int8
    # wire's own effect on the risks (the CPU's int8-vs-float32 delta),
    # the float32 fit within 1/n_test
    wire = recs["int8"]["cpu"]["max_abs_risk_delta_vs_float32"]
    for label, rec in recs.items():
        rec["limit_to_cpu"] = (1.0 / COMMS["n_test"] if label == "float32"
                               else max(1.0 / COMMS["n_test"], wire))
        emit(rec)
    for label, rec in recs.items():
        if not rec["counters_equal_cpu"]:
            raise AssertionError(f"{label}: the card's counters differ from "
                                 f"the CPU's: {rec}")
        if not rec["risk_gap_to_cpu"] <= rec["limit_to_cpu"] + 1e-6:
            raise AssertionError(f"{label}: the card's risks differ from the "
                                 f"CPU's by {rec['risk_gap_to_cpu']}")
    ef, plain = recs["int8+ef"]["cuda"], recs["int8"]["cuda"]
    if ef["bytes_per_round"] != plain["bytes_per_round"]:
        raise AssertionError(f"error feedback changed the bytes per round: "
                             f"{ef} vs {plain}")
    if not (ef["max_abs_risk_delta_vs_float32"]
            <= plain["max_abs_risk_delta_vs_float32"]
            and ef["solution_gap_vs_float32"]
            < plain["solution_gap_vs_float32"]):
        raise AssertionError(f"error feedback is worse than plain int8: "
                             f"{ef} vs {plain}")


def general_fabric(by_path: dict) -> None:
    """The exchange's general path on the card, with the step kernel and
    the tiled Gram: BENCH_comms' data over links with a one-round delay
    (the delay ring), a token bucket that binds (bandwidth 3/4 of a
    round's bundle), drops and a partial schedule, ``pallas_fused`` under
    a binding ``PlanBudget(tile=(8, 128))``.  Launches are counted from 0
    just before the card fit and read just after; the state is held
    within RTOL_FIT of the same fit on the CPU, the risks within
    1/n_test, the counters equal."""
    from repro_torch.api import DTSVM, LinkPolicy, NetConfig, SolverConfig
    from repro_torch.engine.invariants import PlanBudget
    from repro_torch.figures.common import build
    from repro_torch.kernels import ops
    from repro_torch.net.policies import bytes_per_message

    data, A = build(COMMS["V"], list(COMMS["n_per_task"]),
                    degree=COMMS["degree"], seed=0, n_test=COMMS["n_test"])
    _, T, N, p = data["X"].shape
    iters, qp_iters = GENERAL_FABRIC["iters"], GENERAL_FABRIC["qp_iters"]
    budget = PlanBudget(tile=(8, 128))
    bw = 0.75 * T * bytes_per_message("float32", 2 * p + 2)
    cfg = SolverConfig(C=0.01, eps2=1.0, iters=iters, qp_iters=qp_iters,
                       qp_solver="pallas_fused", budget=budget,
                       net=NetConfig(policy=LinkPolicy(delay=1, bandwidth=bw,
                                                       drop=0.1),
                                     schedule="partial:0.9", seed=3))
    path = "fabric/general/pallas_fused"
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = DTSVM(cfg, device="cuda").fit(data["X"], data["y"],
                                         mask=data["mask"], adj=A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path[path] = launches = ops.launch_counts()
    cpu = DTSVM(cfg, device="cpu").fit(data["X"], data["y"],
                                       mask=data["mask"], adj=A)
    errs = _state_errs(card.state_, cpu.state_, RTOL_FIT["f32"])
    risks = [f.risks(data["X_test"], data["y_test"]).cpu()
             for f in (card, cpu)]
    counters = ("bytes_per_round", "bytes_sent", "msgs_sent",
                "msgs_delivered", "delivery_rate", "max_silence")
    rep, cpu_rep = card.net_report_, cpu.net_report_
    rec = {"general_fabric": path, "N": N, "T": T, "D": 2 * p + 2,
           "edges": rep["edges"],
           "iters": iters, "qp_iters": qp_iters, "bandwidth": bw,
           "wall_s": wall, "mode": rep["mode"],
           **{k: rep[k] for k in counters},
           "state_errs_to_cpu": {k: e[0] for k, e in errs.items()},
           "risk_gap_to_cpu": float((risks[0] - risks[1]).abs().max()),
           "limit_to_cpu": 1.0 / COMMS["n_test"],
           "counters_equal_cpu": all(rep[k] == cpu_rep[k]
                                     for k in counters)}
    emit(rec)
    check_launches(path, launches, expected_launches(
        "pallas_fused", fits=1, iters=iters, qp_iters=qp_iters,
        panels=-(-N // budget.row_chunk(1, N))))
    # the bucket refills 3/4 of a bundle a round and holds at most one:
    # no edge sends in two rounds running, so at most ceil(iters / 2)
    # bundles an edge; the drops lose some of them
    if not (rep["mode"] == "mailbox" and rep["delivery_rate"] < 1.0
            and rep["msgs_sent"] <= rep["edges"] * T * -(-iters // 2)):
        raise AssertionError(f"the general fabric did not bind: {rec}")
    if not (rec["counters_equal_cpu"] and all(e[2] for e in errs.values())
            and rec["risk_gap_to_cpu"] <= rec["limit_to_cpu"] + 1e-6):
        raise AssertionError(f"the general fabric on the card differs from "
                             f"the CPU: {rec}")


def identity_large(by_path: dict) -> None:
    """The identity fabric at phase 5's large fit: the async backend and
    the vmap backend run one compiled plan FIT_REPS times each; the
    async state must be ``torch.equal`` to the vmap state."""
    from repro_torch.api import NetConfig, backends
    from repro_torch.core import dtsvm, graph
    from repro_torch.engine import plan as plan_lib
    from repro_torch.kernels import ops

    V, T, N, p = (LARGE_FIT[k] for k in ("V", "T", "N", "p"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.sign(rng.normal(size=(V, T, N))).astype(np.float32)
    y = np.where(y == 0, 1.0, y).astype(np.float32)
    prob = dtsvm.make_problem(X, y, adj=graph.make_graph("ring", V),
                              C=0.01, device="cuda")
    kw = dict(qp_iters=LARGE_FIT["qp_iters"], qp_solver="pallas_fused_multi")
    torch.cuda.empty_cache()
    plan = plan_lib.compile_problem(prob, **kw)
    states, rec = {}, {"identity_large": {k: LARGE_FIT[k] for k in
                                          ("V", "T", "N", "p", "iters",
                                           "qp_iters")}}
    for backend, extra in (("vmap", {}), ("async", {"net": NetConfig()})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        fit_s = []
        for _ in range(FIT_REPS):
            t0 = time.perf_counter()
            st, _ = backends.run(prob, LARGE_FIT["iters"], backend=backend,
                                 plan=plan, **kw, **extra)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
        by_path[f"fabric/large/{backend}"] = ops.launch_counts()
        states[backend] = st
        rec[backend] = {**_walls(fit_s),
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "launches": by_path[f"fabric/large/{backend}"]}
    rec["async_equal_vmap"] = all(torch.equal(a, b) for a, b in
                                  zip(states["async"], states["vmap"]))
    emit(rec)
    if not rec["async_equal_vmap"]:
        raise AssertionError("the identity fabric's large fit is not the "
                             "vmap fit")
    want = FIT_REPS * LARGE_FIT["iters"]
    for backend in ("vmap", "async"):
        if rec[backend]["launches"]["qp_pg_multi"] != want:
            raise AssertionError(f"{backend}: {rec[backend]['launches']}, "
                                 f"expected {want} multi launches")
    del plan, states
    torch.cuda.empty_cache()


def trace_exchange(seen: dict) -> None:
    """Launches per round and the busy share of one paper stage (stage 2,
    30 rounds, ``pallas_fused_multi``) on the vmap backend, on the
    identity fabric (buffer mode) and on the churn fabric (mailbox mode,
    a node down): the exchange's own cost is the difference."""
    from repro_torch.figures import fig7_online
    from repro_torch.net import NetConfig

    r = dict(FIG7_PAPER)
    stage_iters = r.pop("stage_iters")
    per_round = {}
    for label, net in (("vmap", None), ("buffer", NetConfig()),
                       ("mailbox", fig7_online.churn_net(r["seed"]))):
        sess = fig7_online.make_session(device="cuda",
                                        qp_solver="pallas_fused_multi",
                                        net=net, **r)
        for i, ((_, tasks, couple), event) in enumerate(
                zip(fig7_online.STAGES[:2], fig7_online.CHURN_EVENTS)):
            fig7_online.enter_stage(sess, tasks, couple)
            if label == "mailbox" and event is not None:
                getattr(sess, f"node_{event[0]}")(event[1])   # the crash
            if i == 0:
                sess.run(stage_iters)
        per_kernel = _profile(f"fig7 stage 2/{label}",
                              lambda: sess.run(stage_iters))
        prof = RECORDS[-1]
        for k in seen:
            seen[k] += per_kernel[k]
        per_round[label] = prof["device_launches"] / stage_iters
        if label != "vmap" and sess._net_fabric.mode != label:
            raise AssertionError(f"the {label} session ran a "
                                 f"{sess._net_fabric.mode} fabric")
    emit({"exchange_launches_per_round": per_round,
          "fabric_overhead_per_round": {
              k: per_round[k] - per_round["vmap"]
              for k in ("buffer", "mailbox")}})


def fabric_operands(cases: dict) -> None:
    """The kernels at a churn session's own operands: the Gram build of
    its compile (18 problems of N = 40) and the multi solve of its round
    3 (absolute), node 3 down, each against its plain version."""
    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops

    sess = fig7_online.make_session(
        device="cuda", n_test=100, qp_solver="pallas_fused_multi",
        net=fig7_online.churn_net(0))
    with captured(ops, "weighted_gram") as grams:
        sess.run(2)
    sess.node_crash(3)
    with captured(ops, "qp_pg_multi") as multis:
        sess.run(2)
    (Z, a), _ = grams[0]
    hold_gram("fig7_churn_compile", Z, a, cases, built=sess._plan.inv.K)
    args, kw = multis[1]
    hold_multi("fig7_churn/round_3", args, kw, cases)


# ---------------------------------------------------------------------------
# phase 10: the store (snapshots, restores, event logs)
# ---------------------------------------------------------------------------
def store_configs() -> dict:
    """tests/test_store.py's five in-process configs, as config fields."""
    from repro_torch.engine.invariants import PlanBudget
    from repro_torch.net import LinkPolicy, NetConfig

    return {
        "vmap-dense": {},
        "vmap-budgeted": {"budget": PlanBudget(max_elems=256)},
        "async-identity": {"net": NetConfig()},
        "async-lossy": {"net": NetConfig(
            policy=LinkPolicy(drop=0.25, delay=1, quant="int16"),
            schedule="partial:0.75", seed=3)},
        "async-stale-ef": {"net": NetConfig(
            policy=LinkPolicy(drop=0.2, quant="int8"),
            schedule="partial:0.75", seed=3, stale_limit=2,
            error_feedback=True)},
    }


def _stage_events(sess, stage: int, churn: bool) -> None:
    """Fig. 7's membership events of ``stage``, with ``churn`` the churn
    variant's node event too."""
    from repro_torch.figures import fig7_online

    _, tasks, couple = fig7_online.STAGES[stage]
    fig7_online.enter_stage(sess, tasks, couple)
    event = fig7_online.CHURN_EVENTS[stage]
    if churn and event is not None:
        getattr(sess, f"node_{event[0]}")(event[1])


def _advance(sess, stages, churn: bool, iters: int, pending: bool = False):
    """Each of ``stages``: its events, then ``iters`` ADMM iterations.
    ``pending``: the first stage's events were applied before a snapshot,
    so only its run is left."""
    for n, stage in enumerate(stages):
        if not (pending and n == 0):
            _stage_events(sess, stage, churn)
        sess.run(iters)
    return sess


def _store_equal(a, b) -> bool:
    """Bitwise: state, iteration, risk history, fabric state and byte
    series."""
    same = (a.iteration == b.iteration and len(a.history) == len(b.history)
            and all(torch.equal(x, z) for x, z in zip(a.state, b.state))
            and all(np.array_equal(x, z)
                    for x, z in zip(a.history, b.history))
            and (a._net_state is None) == (b._net_state is None))
    if same and a._net_state is not None:
        same = (all(torch.equal(x, z)
                    for x, z in zip(a._net_state, b._net_state))
                and np.array_equal(np.asarray(a._net_series),
                                   np.asarray(b._net_series)))
    return bool(same)


def _session_marks(sess) -> dict:
    """Each run's final (T,) network-average risks, by stage."""
    return {i: h.mean(1)[-1] for i, h in enumerate(sess.history)}


def store(by_path: dict, seen: dict, cases: dict) -> None:
    """Phase 10: each of the five configs on the card through disk: saved
    after stage 1 (and again with stage 2's events pending), restored with
    ``load_session(device="cuda")`` and continued, ``torch.equal`` to the
    uninterrupted run; its event log saved, loaded and replayed, bitwise;
    a snapshot the CPU port wrote restored on the card (refused without
    ``check_fingerprint=False`` where the fingerprints differ) and
    continued against the same session continued on the CPU.  Then the
    large fit's save, restore and continue."""
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops
    from repro_torch.store import (EventLog, SchemaError, load_session,
                                   replay, save_session)

    phase_t0 = time.perf_counter()
    r = dict(STORE_FIG7)
    iters = r.pop("stage_iters")
    stages = range(len(fig7_online.STAGES))
    with tempfile.TemporaryDirectory() as tmp:
        for name, fields in store_configs().items():
            churn = name == "async-stale-ef"

            def make(dev, log=None):
                return fig7_online.make_session(device=dev, log=log, **r,
                                                **fields)

            path = os.path.join(tmp, f"{name}.msgpack")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            log = EventLog()
            ref = _advance(make("cuda", log), stages, churn, iters)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0

            twin = _advance(make("cuda"), stages[:1], churn, iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_session(path, twin)
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
            t0 = time.perf_counter()
            back = load_session(path, device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            equal = _store_equal(_advance(back, stages[1:], churn, iters),
                                 ref)

            twin = _advance(make("cuda"), stages[:1], churn, iters)
            _stage_events(twin, 1, churn)
            save_session(path, twin)
            back = load_session(path, device="cuda")
            equal_pending = back._masks_dirty and _store_equal(
                _advance(back, stages[1:], churn, iters, pending=True), ref)

            log_path = os.path.join(tmp, f"{name}.events")
            log.save(log_path)
            t0 = time.perf_counter()
            twin = replay(EventLog.load(log_path), device="cuda")
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
            equal_replay = _store_equal(twin, ref)

            # a snapshot the CPU port wrote, continued on the card
            cpu = _advance(make("cpu"), stages[:1], churn, iters)
            cpu_path = os.path.join(tmp, f"{name}.cpu.msgpack")
            save_session(cpu_path, cpu)
            cross = load_session(cpu_path, device="cuda",
                                 check_fingerprint=False)
            fp_differ = (cross._plan.fingerprint()
                         != checkpoint.load(cpu_path)["plan"]["fingerprint"])
            try:
                load_session(cpu_path, device="cuda")
                refused = False
            except SchemaError:
                refused = True
            _advance(cross, stages[1:], churn, iters)
            torch.cuda.synchronize()
            by_path[f"store/{name}"] = launches = ops.launch_counts()
            _advance(cpu, stages[1:], churn, iters)
            gap = _marks_gap(_session_marks(cross), _session_marks(cpu))
            errs = _state_errs(cross.state, cpu.state, RTOL_FIT["f32"])
            state_held = name not in QUANTIZED_STORE_CONFIGS
            rec = {"store": name, **{k: v for k, v in r.items()},
                   "stage_iters": iters, "churn_events": churn,
                   "uninterrupted_s": ref_s, "save_s": save_s,
                   "restore_s": restore_s, "replay_s": replay_s,
                   "file_bytes": nbytes, "equal_after_restore": equal,
                   "equal_with_pending_events": equal_pending,
                   "replay_from_disk_equal": equal_replay,
                   "cpu_fingerprint_differs": fp_differ,
                   "refused_without_flag": refused,
                   "cpu_snapshot_risk_gap": gap,
                   "limit": 1.0 / r["n_test"],
                   "cpu_snapshot_state_errs": {k: e[0]
                                               for k, e in errs.items()},
                   "cpu_max_abs": {k: e[1] for k, e in errs.items()},
                   "state_held_to_rtol": (RTOL_FIT["f32"] if state_held
                                          else None),
                   "launches": launches}
            emit(rec)
            if not (equal and equal_pending and equal_replay):
                raise AssertionError(f"store/{name}: a restored or replayed "
                                     f"session left the uninterrupted run")
            if refused != fp_differ:
                raise AssertionError(f"store/{name}: fingerprints differ "
                                     f"{fp_differ}, restore refused "
                                     f"{refused}")
            if not gap <= 1.0 / r["n_test"] + 1e-6:
                raise AssertionError(f"store/{name}: the CPU snapshot "
                                     f"continued on the card is {gap} from "
                                     f"the CPU's risks")
            if state_held and not all(e[2] for e in errs.values()):
                raise AssertionError(f"store/{name}: the CPU snapshot "
                                     f"continued on the card differs from "
                                     f"the CPU's state: {errs}")
            if not (launches["qp_pg_multi"] and launches["gram_prescale"]):
                raise AssertionError(f"store/{name}: the kernels did not "
                                     f"launch: {launches}")
        store_large(by_path, tmp)
    emit({"phase": "store", "seconds": time.perf_counter() - phase_t0})


def store_large(by_path: dict, tmp: str) -> None:
    """A session at the large fit's widths: one ADMM iteration, saved,
    restored on the card and continued one more, ``torch.equal`` to two
    uninterrupted iterations; the seconds of the save, the restore and
    one fingerprint (K, 3.2 GB, copied to the host and hashed), and the
    file's bytes."""
    from repro_torch.api import OnlineSession, SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.store import load_session, save_session

    X, y, adj = large_data()
    cfg = SolverConfig(C=0.01, qp_iters=LARGE_FIT["qp_iters"],
                       qp_solver="pallas_fused_multi")
    path = os.path.join(tmp, "large_fit.msgpack")
    ops.reset_launch_counts()
    ref = OnlineSession(X, y, adj=adj, config=cfg, device="cuda")
    ref.run(2)
    twin = OnlineSession(X, y, adj=adj, config=cfg, device="cuda")
    twin.run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin._plan.fingerprint()
    fingerprint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_session(path, twin)
    save_s = time.perf_counter() - t0
    del twin
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back = load_session(path, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    back.run(1)
    torch.cuda.synchronize()
    by_path["store/large_fit"] = launches = ops.launch_counts()
    equal = all(torch.equal(a, b) for a, b in zip(back.state, ref.state))
    emit({"store": "large_fit", **LARGE_FIT, "qp_solver": cfg.qp_solver,
          "save_s": save_s, "restore_s": restore_s,
          "fingerprint_s": fingerprint_s, "file_bytes": os.path.getsize(path),
          "k_bytes": back._plan.inv.K.numel() * 4,
          "equal_after_restore": equal, "launches": launches})
    if not equal:
        raise AssertionError("store/large_fit: the restored session left "
                             "the uninterrupted run")


# ---------------------------------------------------------------------------
# phase 11: serving (the predict server and the gemm_rows kernel)
# ---------------------------------------------------------------------------
def hold_rows(label: str, regime: str, model, cases: dict) -> None:
    """The bucket contract on the card: rows 0-7 through ``gemm_rows`` in
    every bucket of SERVE, at offsets 0 and 3 with random rows beside
    them, in batches of SERVE_ROWS_BATCHES rows (the first min(M, 8)), in
    rows [3, 11) of a view X[3:] of a larger tensor and where X starts 4
    bytes past 16, bitwise ``decide_rows``; whether ``torch.addmm`` keeps
    it in the buckets (printed, never used); and the kernel against its
    plain version at the largest bucket, timed there and at the smallest
    (the launch floor) beside ``addmm``, with its bound at each: ``ms``
    over wrapper calls, ``graph_ms`` over graph replays, ``device_ms``
    over a burst of launches the card runs back to back."""
    from repro_torch.kernels import ops, ref

    Wf, bf = model.flat()
    K, p = Wf.shape
    dev = Wf.device
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8, p, generator=gen, device=dev)
    want = torch.from_numpy(model.decide_rows(x.cpu().numpy())).to(dev)
    lib_want = torch.addmm(bf, x, Wf.T)
    same, lib_same = [], []
    for bucket in SERVE["buckets"]:
        for off in (0, 3):
            if off + 8 > bucket:
                continue
            X = torch.randn(bucket, p, generator=gen, device=dev)
            X[off:off + 8] = x
            same.append(torch.equal(ops.gemm_rows(Wf, bf, X)[off:off + 8],
                                    want))
            lib_same.append(torch.equal(
                torch.addmm(bf, X, Wf.T)[off:off + 8], lib_want))
    batches = []
    for M in SERVE_ROWS_BATCHES:
        n = min(M, 8)
        X = torch.randn(M, p, generator=gen, device=dev)
        X[:n] = x[:n]
        batches.append(torch.equal(ops.gemm_rows(Wf, bf, X)[:n], want[:n]))
    big = torch.randn(SERVE["buckets"][-1] + 3, p, generator=gen,
                      device=dev)
    big[3:11] = x
    view = torch.equal(ops.gemm_rows(Wf, bf, big[3:])[:8], want)
    flat = torch.randn(1 + 64 * p, generator=gen, device=dev)
    shifted = flat[1:].view(64, p)
    shifted[:8] = x
    off16 = torch.equal(ops.gemm_rows(Wf, bf, shifted)[:8], want)
    M = SERVE["buckets"][-1]
    X = torch.randn(M, p, generator=gen, device=dev)
    got, plain = ops.gemm_rows(Wf, bf, X), ref.gemm_rows(Wf, bf, X)
    torch.cuda.synchronize()
    err, scale, ok = max_err(got, plain, RTOL["f32"])
    b_ms, b_by = bound(4 * (M * p + K * p + K + M * K), 2 * M * K * p)
    m8 = SERVE["buckets"][0]
    X8 = X[:m8].clone()
    b8_ms, _ = bound(4 * (m8 * p + K * p + K + m8 * K), 2 * m8 * K * p)
    rec = {"regime": regime, "model": label, "M": M, "K": K, "p": p,
           "max_abs_err": err,
           "max_abs_plain": scale, "rtol": RTOL["f32"],
           "bucket_contract": all(same) and all(batches) and view and off16,
           "cases": len(same) + len(batches) + 2,
           "contract_buckets": all(same),
           "contract_batches": dict(zip(SERVE_ROWS_BATCHES, batches)),
           "contract_view": view, "contract_off16": off16,
           "addmm_keeps_contract": all(lib_same),
           "addmm_max_abs_diff": float(
               (torch.addmm(bf, X, Wf.T) - got).abs().max()),
           "ms": cuda_ms(lambda: ops.gemm_rows(Wf, bf, X), 200),
           "graph_ms": graph_ms(lambda: ops.gemm_rows(Wf, bf, X), 200),
           "plain_ms": cuda_ms(lambda: ref.gemm_rows(Wf, bf, X), 10),
           "library_ms": cuda_ms(lambda: torch.addmm(bf, X, Wf.T), 200),
           "library_graph_ms": graph_ms(lambda: torch.addmm(bf, X, Wf.T),
                                        200),
           "bound_ms": b_ms, "bound_by": b_by,
           "m8_ms": cuda_ms(lambda: ops.gemm_rows(Wf, bf, X8), 200),
           "m8_graph_ms": graph_ms(lambda: ops.gemm_rows(Wf, bf, X8), 200),
           "m8_library_ms": cuda_ms(lambda: torch.addmm(bf, X8, Wf.T), 200),
           "m8_library_graph_ms": graph_ms(
               lambda: torch.addmm(bf, X8, Wf.T), 200),
           "m8_bound_ms": b8_ms,
           "device_ms": burst_ms(lambda: ops.gemm_rows(Wf, bf, X)),
           "library_device_ms": burst_ms(lambda: torch.addmm(bf, X, Wf.T)),
           "m8_device_ms": burst_ms(lambda: ops.gemm_rows(Wf, bf, X8)),
           "m8_library_device_ms": burst_ms(
               lambda: torch.addmm(bf, X8, Wf.T))}
    emit({"kernel_check": "gemm_rows", **rec})
    if not (ok and rec["bucket_contract"]):
        raise AssertionError(f"gemm_rows at {label}: {rec}")
    cases["gemm_rows"].append(rec)


def rows_model(dev, shape):
    """A served model of V x T hyperplanes over P features, weights and
    biases from a generator on the card seeded with P: SERVE_MNIST is the
    paper's MNIST width, the quickstart's V*T = 20 hyperplanes over p = 784
    = 28 x 28 features."""
    from repro_torch.serve import PredictModel

    V, T, P = shape
    gen = torch.Generator(device=dev).manual_seed(P)
    return PredictModel(
        W=torch.randn(V, T, P, generator=gen, device=dev) / P ** 0.5,
        b=torch.randn(V, T, generator=gen, device=dev))


def _serve_load(srv, shape, duration_s: float, seed: int, swap=None):
    """bench_serve.py's closed-loop clients against ``srv`` for
    ``duration_s``: each of SERVE["clients"] threads submits 1 to
    max_rows random rows for a random (node, task) and waits for the
    answer.  ``swap``, if given, runs in this thread at half time.
    Returns the responses ``(x, v, t, out, t_submit, t_answer)`` and the
    swap's (start, end) on the same clock."""
    import threading

    V, T, P = shape
    stop_at = time.perf_counter() + duration_s
    out = [[] for _ in range(SERVE["clients"])]
    errs = []

    def client(i):
        rng = np.random.default_rng(seed * 101 + i)
        try:
            while time.perf_counter() < stop_at:
                x = rng.normal(size=(int(rng.integers(
                    1, SERVE["max_rows"] + 1)), P)).astype(np.float32)
                v, t = int(rng.integers(V)), int(rng.integers(T))
                t0 = time.perf_counter()
                got = srv.predict(x, node=v, task=t)
                out[i].append((x, v, t, got, t0, time.perf_counter()))
        except Exception as e:          # raised below, in this thread
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE["clients"])]
    for th in threads:
        th.start()
    swapped = None
    if swap is not None:
        time.sleep(duration_s / 2)
        t0 = time.perf_counter()
        swap()
        swapped = (t0, time.perf_counter())
    for th in threads:
        th.join(duration_s + 60)
    if errs or any(th.is_alive() for th in threads):
        raise AssertionError(f"a serve client failed: {errs[:3]}")
    return [r for rs in out for r in rs], swapped


def _check_responses(responses, old, new=None, swapped=None) -> dict:
    """Every response bitwise ``decide_rows`` of the model that answered
    it: ``old`` before the swap began, ``new`` once it had ended, either
    in between."""
    T = old.shape[1]
    counts = {"old": 0, "new": 0}
    for x, v, t, got, t0, t1 in responses:
        col = v * T + t
        if swapped is None or t1 < swapped[0]:
            ok = np.array_equal(got, old.decide_rows(x)[:, col])
            counts["old"] += 1
        elif t0 > swapped[1]:
            ok = np.array_equal(got, new.decide_rows(x)[:, col])
            counts["new"] += 1
        else:
            ok = any(np.array_equal(got, m.decide_rows(x)[:, col])
                     for m in (old, new))
        if not ok:
            raise AssertionError(f"a served answer is not decide_rows' "
                                 f"bits: node {v}, task {t}, {len(x)} rows")
    return counts


def _serve_record(label: str, window_ms: float, srv, launches: dict,
                  responses, counts: dict, stream_s: float) -> dict:
    from repro_torch.obs import spans

    stats = srv.stats()
    # each batch's host span: concatenate and pad the rows, copy them to
    # the card, one launch, copy the answers back, resolve the futures
    batch_us = [e["dur"] for e in spans.iter_spans()
                if e["name"] == "serve_batch"]
    batch_spans = len(batch_us)
    rec = {"serve": label, "window_ms": window_ms, "stream_s": stream_s,
           **{k: stats[k] for k in ("requests", "rows", "batches",
                                    "rows_per_batch", "pad_ratio", "p50_ms",
                                    "p99_ms", "rps", "devices")},
           "batch_span_us_p50": float(np.median(batch_us)),
           "batch_span_us_p99": float(np.percentile(batch_us, 99)),
           "responses_checked": len(responses), "bitwise": True,
           "checked_by_model": counts, "serve_batch_spans": batch_spans,
           "gemm_rows_launched": launches["gemm_rows"] > 0,
           "launches": launches}
    emit(rec)
    if not (launches["gemm_rows"] >= stats["batches"] > 0
            and len(responses) == stats["requests"]
            and batch_spans == stats["batches"]):
        raise AssertionError(f"serve/{label}: launches, requests or spans "
                             f"disagree with the server's stats: {rec}")
    return rec


def serve(by_path: dict, seen: dict, cases: dict) -> None:
    """Phase 11: the quickstart's fitted DTSVM and the large fit's model,
    each held to the bucket contract (and ``gemm_rows`` to its plain
    version) and served for SERVE["model_s"]; then a Fig. 7 session's
    model served at each batching window for SERVE["stream_s"], its next
    stage run and published mid-stream; every answer bitwise
    ``decide_rows``."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops
    from repro_torch.obs import spans
    from repro_torch.serve import PredictModel, PredictServer
    from repro_torch.store import restore_session, snapshot_session

    phase_t0 = time.perf_counter()
    data, adj = quickstart.data_and_graph()
    large_X, large_y, large_adj = large_data()
    fits = [("quickstart", "paper", lambda: DTSVM(SolverConfig(
        C=0.01, eps1=1.0, eps2=1.0, iters=60, qp_iters=100,
        qp_solver="pallas_fused_multi"), device="cuda").fit(
        data["X"], data["y"], mask=data["mask"], adj=adj)),
        ("large_fit", "large", lambda: DTSVM(SolverConfig(
            C=0.01, iters=LARGE_FIT["iters"],
            qp_iters=LARGE_FIT["qp_iters"],
            qp_solver="pallas_fused_multi"), device="cuda").fit(
            large_X, large_y, adj=large_adj))]
    for label, regime, fit in fits:
        ops.reset_launch_counts()
        spans.clear_spans()
        model = PredictModel.from_solver(fit())
        with PredictServer(model, window_ms=1.0) as srv:
            responses, _ = _serve_load(srv, model.shape, SERVE["model_s"],
                                       seed=1)
            torch.cuda.synchronize()
            by_path[f"serve/{label}"] = launches = ops.launch_counts()
            counts = _check_responses(responses, model)
            _serve_record(label, 1.0, srv, launches, responses, counts,
                          SERVE["model_s"])
        hold_rows(label, regime, model, cases)
    hold_rows("mnist", "mnist", rows_model(torch.device("cuda"),
                                           SERVE_MNIST), cases)
    for shape in SERVE_WIDE:
        hold_rows(f"wide_p{shape[2]}", "wide",
                  rows_model(torch.device("cuda"), shape), cases)

    r = dict(STORE_FIG7)
    iters = r.pop("stage_iters")
    sess = _advance(fig7_online.make_session(device="cuda", **r), range(1),
                    False, iters)
    stage1 = snapshot_session(sess)
    for window in SERVE["windows"]:
        label = f"fig7/window{window:g}"
        sess = restore_session(stage1, device="cuda")
        old = PredictModel.from_session(sess)

        def next_stage():
            _advance(sess, range(1, 2), False, iters)
            srv.publish_session(sess)

        ops.reset_launch_counts()
        spans.clear_spans()
        with PredictServer(old, window_ms=window) as srv:
            responses, swapped = _serve_load(srv, old.shape,
                                             SERVE["stream_s"], seed=2,
                                             swap=next_stage)
            torch.cuda.synchronize()
            by_path[f"serve/{label}"] = launches = ops.launch_counts()
            new = PredictModel.from_session(sess)
            counts = _check_responses(responses, old, new, swapped)
            rec = _serve_record(label, window, srv, launches, responses,
                                counts, SERVE["stream_s"])
        if not (counts["old"] and counts["new"]):
            raise AssertionError(f"serve/{label}: the hot swap did not split "
                                 f"the stream: {rec}")
    emit({"phase": "serve", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 12: observability (telemetry streams, spans, registry, timeit)
# ---------------------------------------------------------------------------
def _stream_gaps(got: dict, want: dict) -> dict:
    """Per stream: (largest gap, whether it is within the phase's bounds).
    The residual streams are held to OBS_RTOL of each value plus OBS_ATOL
    of the stream's largest value, the box-face fraction to
    OBS_FRAC_GAP, the fabric's counting streams exactly."""
    out = {}
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        gap = float(np.abs(g - w).max(initial=0.0))
        if k in OBS_EXACT:
            ok = g.shape == w.shape and bool(np.array_equal(g, w))
        elif k == "qp_active_frac":
            ok = g.shape == w.shape and gap <= OBS_FRAC_GAP
        else:
            limit = (OBS_RTOL * np.abs(w)
                     + OBS_ATOL * float(np.abs(w).max(initial=0.0)))
            ok = g.shape == w.shape and bool((np.abs(g - w) <= limit).all())
        out[k] = (gap, ok)
    return out


def _check_streams(label: str, got: dict, want: dict,
                   wire_rel: float = None) -> dict:
    """Raise unless ``got`` holds ``want``'s streams within the phase's
    bounds (with ``wire_rel``: the residual streams within that share of
    each stream's largest value instead); returns the largest gaps."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: streams {sorted(got)} against "
                             f"{sorted(want)}")
    gaps = _stream_gaps(got, want)
    if wire_rel is not None:
        gaps = {k: (g, ok if k in OBS_EXACT or k == "qp_active_frac" else
                    g <= wire_rel * float(np.abs(want[k]).max()))
                for k, (g, ok) in gaps.items()}
    bad = {k: g for k, (g, ok) in gaps.items() if not ok}
    if bad:
        raise AssertionError(f"{label}: streams leave the CPU port's "
                             f"bounds: {bad}")
    return {k: g for k, (g, _) in gaps.items()}


def _summary(streams: dict) -> dict:
    """First and last value of each stream (max over a trailing axis)."""
    from repro_torch.obs import summarize

    return {k: {"first": s["first"], "last": s["last"]}
            for k, s in summarize(streams).items()}


def _sync_warnings(fn) -> list:
    """Synchronizing CUDA calls ``fn`` makes: torch's sync-debug mode
    warns on each; returns the caller's file:line of each warning."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchronizing" in str(w.message)]


def _on_off_fits(cfg, X, y, mask, adj, path: str, by_path: dict) -> dict:
    """OBS_REPS DTSVM fits on the card with telemetry off and on, in
    turns; each fit's launches counted from 0 just before it and read
    just after.  Returns the last states, the on fit's streams and spans,
    the walls and both launch totals."""
    from repro_torch import obs
    from repro_torch.api import DTSVM
    from repro_torch.kernels import ops

    out = {"wall": {False: [], True: []},
           "launches": {False: None, True: None}}
    for _ in range(OBS_REPS):
        for on in (False, True):
            obs.clear_spans()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = DTSVM(cfg.replace(telemetry=on), device="cuda").fit(
                X, y, mask=mask, adj=adj)
            torch.cuda.synchronize()
            out["wall"][on].append(time.perf_counter() - t0)
            n = ops.launch_counts()
            tot = out["launches"][on]
            out["launches"][on] = (n if tot is None else
                                   {k: tot[k] + v for k, v in n.items()})
            out[on] = fit
            if on:
                out["spans"] = [e["name"] for e in obs.iter_spans()]
    by_path[path] = out["launches"][True]
    if out["launches"][True] != out["launches"][False]:
        raise AssertionError(f"{path}: kernel launches with telemetry "
                             f"{out['launches'][True]} differ from without "
                             f"{out['launches'][False]}")
    if not all(torch.equal(a, b) for a, b in zip(out[True].state_,
                                                 out[False].state_)):
        raise AssertionError(f"{path}: telemetry changed the state")
    return out


def obs_quickstart(by_path: dict) -> None:
    """(a) The quickstart's DTSVM per engine with telemetry on and off."""
    from repro_torch import obs, quickstart
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import dtsvm
    from repro_torch.engine import plan as engine_plan

    data, adj = quickstart.data_and_graph()
    X, y, mask = data["X"], data["y"], data["mask"]
    base = SolverConfig(C=0.01, eps1=1.0, eps2=1.0, iters=60, qp_iters=100)
    _sync_warnings(lambda: None)    # the mode's first switch warns itself
    for label, kw in OBS_ENGINES:
        cfg = base.replace(**kw)
        runs = _on_off_fits(cfg, X, y, mask, adj, f"obs/quickstart/{label}",
                            by_path)
        got = runs[True].telemetry_
        cpu = DTSVM(cfg.replace(telemetry=True), device="cpu").fit(
            X, y, mask=mask, adj=adj).telemetry_
        gaps = _check_streams(f"obs/quickstart/{label}", got, cpu)
        # the loop alone under the sync-debug mode, off then on, after one
        # warm iteration of each (first calls may sync once to set up);
        # the streams' one copy to the host comes after the loop
        plan = engine_plan.compile_problem(dtsvm.make_problem(
            X, y, mask, adj, C=0.01, device="cuda"), cfg)
        syncs = {}
        for tel in (None, obs.Telemetry()):
            plan.run(iters=1, telemetry=tel)
        for on in (False, True):
            tel = obs.Telemetry() if on else None
            syncs[on] = _sync_warnings(
                lambda: plan.run(iters=cfg.iters, telemetry=tel))
        rec = {"obs": "quickstart", "engine": label, "reps": OBS_REPS,
               "fit_s_off": runs["wall"][False],
               "fit_s_on": runs["wall"][True],
               "fit_s_median_off": float(np.median(runs["wall"][False])),
               "fit_s_median_on": float(np.median(runs["wall"][True])),
               "launches": runs["launches"][True],
               "spans_per_fit": len(runs["spans"]), "spans": runs["spans"],
               "state_equal_on_off": True,
               "stream_gaps_vs_cpu": gaps,
               "sync_warnings_loop_off": len(syncs[False]),
               "sync_warnings_loop_on": len(syncs[True]),
               "sync_sites": sorted(set(syncs[False] + syncs[True])),
               "streams": _summary(got)}
        rec["on_over_off"] = rec["fit_s_median_on"] / rec["fit_s_median_off"]
        emit(rec)
        if kw.get("qp_operator") == "factored":
            # L through discarded row panels: tiled launches, no K, no
            # multi solve (the factored matvec is plain torch)
            n = runs["launches"][True]
            if not (n["weighted_gram_tiled"] and n["gram_prescale"]) or \
                    n["weighted_gram"] or n["qp_pg_multi"]:
                raise AssertionError(f"obs/quickstart/{label}: launches {n}")
        else:
            check_launches(f"obs/quickstart/{label}",
                           runs["launches"][True], expected_launches(
                               kw["qp_solver"], fits=OBS_REPS,
                               iters=cfg.iters, qp_iters=cfg.qp_iters))
        if len(syncs[True]) > len(syncs[False]):
            raise AssertionError(f"obs/quickstart/{label}: telemetry adds "
                                 f"synchronizations to the loop: {syncs}")
        missing = {"invariant_build", "plan_compile",
                   "scan_execute"} - set(runs["spans"])
        if missing:
            raise AssertionError(f"obs/quickstart/{label}: no {missing} "
                                 f"span in a fit")


def obs_profile(seen: dict) -> None:
    """Launches and busy share of one multi-engine quickstart fit with
    telemetry off and on (the collector's own launches)."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, SolverConfig

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(C=0.01, iters=60, qp_iters=100,
                       qp_solver="pallas_fused_multi")
    for on in (False, True):
        per_kernel = _profile(
            f"obs/quickstart/pallas_fused_multi/telemetry={on}",
            lambda: DTSVM(cfg.replace(telemetry=on), device="cuda").fit(
                data["X"], data["y"], mask=data["mask"], adj=adj))
        for k in seen:
            seen[k] += per_kernel[k]


def obs_large(by_path: dict) -> None:
    """(b) The large fit with telemetry on and off; (e) ``timeit`` of its
    ``Plan.run`` against CUDA events around the same call."""
    from repro_torch import obs
    from repro_torch.api import SolverConfig
    from repro_torch.core import dtsvm
    from repro_torch.engine import plan as engine_plan

    X, y, adj = large_data()
    cfg = SolverConfig(C=0.01, iters=LARGE_FIT["iters"],
                       qp_iters=LARGE_FIT["qp_iters"],
                       qp_solver="pallas_fused_multi")
    runs = _on_off_fits(cfg, X, y, None, adj, "obs/large_fit", by_path)
    emit({"obs": "large_fit", **LARGE_FIT, "reps": OBS_REPS,
          "fit_s_off": runs["wall"][False], "fit_s_on": runs["wall"][True],
          "fit_s_median_off": float(np.median(runs["wall"][False])),
          "fit_s_median_on": float(np.median(runs["wall"][True])),
          "state_equal_on_off": True, "launches": runs["launches"][True],
          "streams": {k: v.tolist() for k, v in
                      runs[True].telemetry_.items()}})

    plan = engine_plan.compile_problem(
        dtsvm.make_problem(X, y, None, adj, C=0.01, device="cuda"), cfg)
    timing = obs.timeit(plan.run, iters=cfg.iters, repeats=5, warmup=1)
    event_ms = [device_ms(lambda: plan.run(iters=cfg.iters))
                for _ in range(5)]
    rec = {"obs": "timeit", "call": "Plan.run(iters=2), large fit",
           "best_s": timing.best_s, "mean_s": timing.mean_s,
           "times_s": timing.times_s, "device_ms": event_ms}
    emit(rec)
    if not timing.best_s * 1e3 >= min(event_ms):
        raise AssertionError(f"timeit reports less than the card's time "
                             f"for the same call: {rec}")


def obs_churn(by_path: dict) -> None:
    """(c) Fig. 7's churn session with telemetry on the card and the CPU,
    over its int8 wire and over a float32 one, then snapshot -> restore
    -> continue on the card."""
    import tempfile

    from repro_torch.figures import fig7_online
    from repro_torch.kernels import ops
    from repro_torch.net import LinkPolicy
    from repro_torch.store import load_session, save_session

    r = dict(FIG7_PAPER)
    iters = r.pop("stage_iters")
    kw = dict(r, qp_solver="pallas_fused_multi", telemetry=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, info = fig7_online.churn_marks(iters, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["obs/fig7_churn"] = launches = ops.launch_counts()
    card = info["session"]
    _, cpu_info = fig7_online.churn_marks(iters, device="cpu", **kw)
    gaps = _check_streams("obs/fig7_churn", card.telemetry_,
                          cpu_info["session"].telemetry_,
                          wire_rel=OBS_WIRE_REL)

    stages = range(len(fig7_online.STAGES))
    net = fig7_online.churn_net(r["seed"])
    f32_net = dataclasses.replace(net, policy=LinkPolicy(
        drop=net.policy.drop), error_feedback=False)
    f32 = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        f32[dev] = _advance(fig7_online.make_session(
            device=dev, net=f32_net, **kw), stages, True, iters)
        if dev == "cuda":
            by_path["obs/fig7_churn_f32_wire"] = ops.launch_counts()
    f32_gaps = _check_streams("obs/fig7_churn_f32_wire",
                              f32["cuda"].telemetry_, f32["cpu"].telemetry_)
    twin = _advance(fig7_online.make_session(
        device="cuda", net=fig7_online.churn_net(r["seed"]), **kw),
        stages[:2], True, iters)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "churn.msgpack")
        save_session(path, twin)
        back = _advance(load_session(path, device="cuda"), stages[2:], True,
                        iters)
    restored = (set(back.telemetry_) == set(card.telemetry_)
                and all(np.array_equal(back.telemetry_[k], v)
                        for k, v in card.telemetry_.items())
                and all(torch.equal(a, b)
                        for a, b in zip(back.state, card.state)))
    emit({"obs": "fig7_churn", **FIG7_PAPER, "wall_s": wall,
          "stage_s": info["stage_s"], "launches": launches,
          "stream_gaps_vs_cpu": gaps, "wire_rel": OBS_WIRE_REL,
          "stream_maxima": {k: float(np.abs(v).max())
                            for k, v in card.telemetry_.items()},
          "f32_wire_stream_gaps_vs_cpu": f32_gaps,
          "shapes": {k: list(v.shape) for k, v in card.telemetry_.items()},
          "nodes_alive": card.telemetry_["nodes_alive"].tolist()[::iters],
          "restored_streams_equal": restored,
          "streams": _summary(card.telemetry_)})
    if not restored:
        raise AssertionError("obs/fig7_churn: the restored session's "
                             "telemetry or state left the uninterrupted "
                             "session's")


def obs_demo() -> None:
    """(d) ``python -m repro_torch.obs demo`` in a subprocess on the card:
    its trace validates and holds the engine's spans, its registry loads
    and renders."""
    import tempfile

    from repro_torch import obs

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        metrics = os.path.join(tmp, "metrics.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "demo", "--iters",
             "5", "--trace", trace, "--registry", metrics],
            capture_output=True, text=True, env=env, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"obs demo failed: {proc.stdout}"
                                 f"{proc.stderr}")
        with open(trace) as f:
            tree = json.load(f)
        obs.validate_chrome_trace(tree)
        names = [e["name"] for e in tree["traceEvents"]]
        reg = obs.MetricsRegistry.load(metrics)
        rendered = reg.render()
    emit({"obs": "demo", "wall_s": wall, "spans": names,
          "sections": reg.sections(),
          "telemetry": reg.get("telemetry")["primal_residual"],
          "stdout_head": proc.stdout.splitlines()[0]})
    missing = {"invariant_build", "plan_compile", "scan_execute"} - set(names)
    if missing or "on cuda" not in proc.stdout or "[telemetry]" not in \
            rendered:
        raise AssertionError(f"obs demo: spans {names}, missing {missing}; "
                             f"stdout {proc.stdout[:200]}")


def observability(by_path: dict, seen: dict, cases: dict) -> None:
    """Phase 12: telemetry on the card (bitwise invisible, no added
    synchronization, streams within bounds of the CPU port's), the demo
    CLI, and ``timeit``."""
    phase_t0 = time.perf_counter()
    obs_quickstart(by_path)
    obs_profile(seen)
    obs_large(by_path)
    obs_churn(by_path)
    obs_demo()
    emit({"phase": "obs", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 13: the shard_map backend, one rank per node on the card
# ---------------------------------------------------------------------------
def _dist_case(label: str, world, fit, by_path: dict, want: dict,
               nbr_sums: int) -> dict:
    """``want["reps"]`` fits through ``fit()`` on ``world``, the ranks'
    counters set to 0 just before and read just after: every rank on the
    card, with ``want``'s launches and ``nbr_sums`` neighbor sums.
    Returns the last fit, the walls and the ranks' records."""
    from repro_torch.core import dtsvm_dist

    dtsvm_dist.world_stats(world, reset=True)
    walls = []
    for _ in range(want.pop("reps")):
        t0 = time.perf_counter()
        m = fit()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ranks = dtsvm_dist.world_stats(world)
    by_path[label] = {k: sum(r["launches"][k] for r in ranks)
                      for k in ranks[0]["launches"]}
    want = {k: want.get(k, 0) for k in ranks[0]["launches"]}
    for r in ranks:
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"{label}: rank {r['rank']} ran on "
                                 f"{r['device']}")
        if r["launches"] != want or r["nbr_sums"] != nbr_sums:
            raise AssertionError(
                f"{label}: rank {r['rank']} made {r['launches']} launches "
                f"and {r['nbr_sums']} neighbor sums, expected {want} and "
                f"{nbr_sums}")
    return {"fit": m, "walls": walls, "launches_per_rank": want,
            "ranks": [{k: r[k] for k in ("rank", "device", "launches",
                                         "peak_mem_bytes", "nbr_sums",
                                         "host_copies")} for r in ranks]}


def _vmap_walls(fit) -> tuple:
    walls = []
    for _ in range(DIST_REPS):
        t0 = time.perf_counter()
        m = fit()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return m, walls


def dist_paper(by_path: dict) -> None:
    """(a) the paper regime per topology and engine, (c) a history with
    telemetry, on one world of 8 ranks."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import dtsvm_dist, graph
    from repro_torch.data import synthetic

    cfg0 = DIST_PAPER
    V, T = cfg0["V"], cfg0["T"]
    n = np.zeros((V, T), int)
    n[:, 0], n[:, 1] = cfg0["n"]
    data = synthetic.make_multitask_data(
        V=V, T=T, p=cfg0["p"], n_train=n, n_test=cfg0["n_test"],
        relatedness=0.9, seed=0)
    X, y, mask = data["X"], data["y"], data["mask"]
    Xte, yte = data["X_test"], data["y_test"]
    base = SolverConfig(C=cfg0["C"], iters=cfg0["iters"],
                        qp_iters=cfg0["qp_iters"])
    risk_tol = 1.0 / cfg0["n_test"]
    world = dtsvm_dist.make_node_world(V, "cuda")
    try:
        emit({"dist": "world", "ranks": V, "start_s": world.start_seconds,
              "devices": world.devices})
        graphs = {"graph": graph.make_graph("random", V, cfg0["degree"]),
                  "ring": graph.ring(V)}
        for topology, adj in graphs.items():
            for engine in DIST_ENGINES:
                label = f"dist/{topology}/{engine}"
                cfg = base.replace(qp_solver=engine)
                fit = lambda c: DTSVM(c, device="cuda").fit(  # noqa: E731
                    X, y, mask=mask, adj=adj)
                ref, ref_walls = _vmap_walls(lambda: fit(cfg))
                want = dict(expected_launches(
                    engine, fits=DIST_REPS, iters=cfg.iters,
                    qp_iters=cfg.qp_iters), reps=DIST_REPS)
                out = _dist_case(label, world, lambda: fit(cfg.replace(
                    backend="shard_map", backend_options={
                        "topology": topology, "world": world})),
                    by_path, want, 2 * DIST_REPS * cfg.iters)
                m = out["fit"]
                err = max(float((a - b).abs().max())
                          for a, b in zip(m.state_, ref.state_))
                risk_gap = float((m.risks(Xte, yte)
                                  - ref.risks(Xte, yte)).abs().max())
                rounds = DIST_REPS * cfg.iters
                emit({"dist": label, **cfg0, "reps": DIST_REPS,
                      "fit_s": out["walls"],
                      "fit_s_median": float(np.median(out["walls"])),
                      "vmap_fit_s": ref_walls,
                      "vmap_fit_s_median": float(np.median(ref_walls)),
                      "vs_vmap_max_abs_err": err,
                      "bitwise_vmap": all(torch.equal(a, b) for a, b in
                                          zip(m.state_, ref.state_)),
                      "risk_gap": risk_gap,
                      "launches_per_rank": out["launches_per_rank"],
                      "nbr_sums_per_iter": out["ranks"][0]["nbr_sums"]
                      / rounds,
                      "host_copies_per_iter": out["ranks"][0]["host_copies"]
                      / rounds,
                      "ranks": out["ranks"]})
                if not (err < DIST_STATE_TOL and risk_gap <= risk_tol):
                    raise AssertionError(f"{label}: state {err} or risks "
                                         f"{risk_gap} off the vmap fit")

        # (c) a history with telemetry, held to vmap's
        adj = graphs["graph"]
        cfg = base.replace(qp_solver="pallas_fused_multi",
                           iters=DIST_HISTORY, telemetry=True)
        ref = DTSVM(cfg, device="cuda").fit(X, y, mask=mask, adj=adj,
                                            X_test=Xte, y_test=yte)
        want = dict(expected_launches("pallas_fused_multi", fits=1,
                                      iters=DIST_HISTORY,
                                      qp_iters=cfg.qp_iters), reps=1)
        out = _dist_case("dist/history", world, lambda: DTSVM(cfg.replace(
            backend="shard_map", backend_options={"world": world}),
            device="cuda").fit(X, y, mask=mask, adj=adj, X_test=Xte,
                               y_test=yte), by_path, want, 2 * DIST_HISTORY)
        m = out["fit"]
        hist_gap = float((m.history_ - ref.history_).abs().max())
        gaps = _check_streams("dist/history", m.telemetry_, ref.telemetry_)
        emit({"dist": "history", "rounds": DIST_HISTORY,
              "history_shape": list(m.history_.shape),
              "history_gap": hist_gap, "stream_gaps": gaps,
              "fit_s": out["walls"], "ranks": out["ranks"]})
        if not (tuple(m.history_.shape) == (DIST_HISTORY, V, T)
                and hist_gap <= risk_tol):
            raise AssertionError(f"dist history off vmap's: {hist_gap}")
    finally:
        world.close()


def dist_large(by_path: dict) -> None:
    """(b) the large fit on 2 ranks, dense and budgeted, against the vmap
    fit; then a rank that dies."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import dtsvm_dist
    from repro_torch.dist import RankError
    from repro_torch.engine import invariants
    from repro_torch.engine.invariants import PlanBudget

    V, T, N = (LARGE_FIT[k] for k in ("V", "T", "N"))
    X, y, adj = large_data()
    cfg = SolverConfig(C=0.01, iters=LARGE_FIT["iters"],
                       qp_iters=LARGE_FIT["qp_iters"],
                       qp_solver="pallas_fused_multi")
    torch.cuda.empty_cache()
    ref, ref_walls = _vmap_walls(
        lambda: DTSVM(cfg, device="cuda").fit(X, y, adj=adj))
    world = dtsvm_dist.make_node_world(V, "cuda")
    try:
        emit({"dist": "world", "ranks": V, "start_s": world.start_seconds,
              "devices": world.devices})
        budget = PlanBudget(max_elems=LARGE_BUDGET)
        chunk = budget.row_chunk(T, N)           # one node's batch: T
        panels = len(invariants._row_starts(N, chunk))
        expect = dict(iters=cfg.iters, qp_iters=cfg.qp_iters)
        for label, reps, kw, pan in (
                ("dist/large_fit", DIST_REPS, {}, None),
                ("dist/large_fit/budget", 1, {"budget": budget}, panels)):
            dcfg = cfg.replace(backend="shard_map",
                               backend_options={"world": world}, **kw)
            want = dict(expected_launches("pallas_fused_multi", fits=reps,
                                          panels=pan, **expect), reps=reps)
            out = _dist_case(label, world, lambda: DTSVM(
                dcfg, device="cuda").fit(X, y, adj=adj), by_path, want,
                2 * reps * cfg.iters)
            errs = _state_errs(out["fit"].state_, ref.state_,
                               RTOL_FIT["f32"])
            emit({"dist": label, **LARGE_FIT, "reps": reps,
                  "row_chunk": chunk if pan else None, "panels": pan,
                  "fit_s": out["walls"],
                  "fit_s_median": float(np.median(out["walls"])),
                  "vmap_fit_s": ref_walls,
                  "vmap_fit_s_median": float(np.median(ref_walls)),
                  "vs_vmap_max_abs_err": {k: e[0] for k, e in errs.items()},
                  "vmap_max_abs": {k: e[1] for k, e in errs.items()},
                  "bitwise_vmap": all(torch.equal(a, b) for a, b in
                                      zip(out["fit"].state_, ref.state_)),
                  "rtol": RTOL_FIT["f32"], "ranks": out["ranks"]})
            if not all(e[2] for e in errs.values()):
                raise AssertionError(f"{label} off the vmap fit: {errs}")
        # a rank that dies: the world raises and no rank stays alive
        try:
            world.run(os._exit, [(3,)] * V)
        except RankError as e:
            died = str(e)
        else:
            raise AssertionError("a world whose ranks died did not raise")
        alive = sum(p.is_alive() for p in world._procs)
        emit({"dist": "rank_died", "error": died, "closed": world.closed,
              "ranks_alive": alive})
        if not (world.closed and alive == 0):
            raise AssertionError("a failed world left ranks running")
    finally:
        world.close()


def dist(by_path: dict) -> None:
    """Phase 13: the shard_map backend on the card."""
    phase_t0 = time.perf_counter()
    dist_paper(by_path)
    dist_large(by_path)
    emit({"phase": "dist", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 14: the sample_shard backend and the device-tiled sweep
# ---------------------------------------------------------------------------
def _rank_case(label: str, world, fit, reps: int, by_path: dict,
               want: dict) -> tuple:
    """``reps`` calls of ``fit()`` on ``world``, the ranks' counters set
    to 0 just before and read just after: every rank on the card, each
    with ``want``'s launches (a kernel it does not name: none), all of
    them added to ``by_path["shard"]``.  Returns the last result, the
    walls and the ranks' records."""
    from repro_torch.dist.collectives import world_stats

    world_stats(world, reset=True)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ranks = world_stats(world)
    want = {k: want.get(k, 0) for k in ranks[0]["launches"]}
    total = by_path.setdefault("shard", dict.fromkeys(want, 0))
    for r in ranks:
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"{label}: rank {r['rank']} ran on "
                                 f"{r['device']}")
        if r["launches"] != want:
            raise AssertionError(f"{label}: rank {r['rank']} made "
                                 f"{r['launches']} launches, expected "
                                 f"{want}")
        for k, n in r["launches"].items():
            total[k] += n
    keep = ("rank", "device", "launches", "peak_mem_bytes", "all_gathers",
            "all_reduces", "nbr_sums", "host_copies", "collective_s")
    return out, walls, [{k: r[k] for k in keep} for r in ranks]


def _collectives(ranks: list, rounds: int, builds: int,
                 walls: list) -> dict:
    """Rank 0's collectives per ADMM iteration (the builds' own taken
    out: one all-gather of Z and one max-reduce of L per build) and every
    rank's collective seconds as a share of the walls."""
    r0 = ranks[0]
    return {
        "all_gathers_per_iter": (r0["all_gathers"] - builds) / rounds,
        "all_reduces_per_iter": (r0["all_reduces"] - builds) / rounds,
        "collective_share_of_wall": [r["collective_s"] / sum(walls)
                                     for r in ranks]}


def hold_panel(label: str, Z, a, row0: int, M: int, cases: dict) -> None:
    """The tiled Gram kernel at a sample rank's own panel (rows [row0,
    row0 + M) of the whole gathered Z) against its plain version, and
    bitwise those rows of the square kernel's K."""
    from repro_torch.kernels import gram as gram_kernel
    from repro_torch.kernels import ops, ref

    B, N, D = Z.shape
    Zs = gram_kernel.prescale(Z, a)
    panel = torch.empty((B, M, N), device=Z.device)
    run = lambda: gram_kernel.weighted_gram_tiled(Zs, row0, panel)
    run()
    Zm = Z[:, row0:row0 + M]
    plain = ref.weighted_gram_rows(Zm, a, Z)
    torch.cuda.synchronize()
    err, scale, ok = max_err(panel, plain, RTOL["f32"])
    del plain
    K = ops.weighted_gram(Z, a)
    same_rows = torch.equal(panel, K[:, row0:row0 + M])
    del K
    flops = 2 * B * M * N * D + B * M * D
    b_ms, b_by = bound(4 * (B * M * D + B * N * D + B * D + B * M * N),
                       flops)
    rec = {"regime": label, "B": B, "N": N, "D": D, "M": M,
           "row_start": row0, "max_abs_err": err, "max_abs_plain": scale,
           "rtol": RTOL["f32"], "bitwise_square_rows": same_rows,
           "ms": cuda_ms(run, 5),
           "plain_ms": cuda_ms(lambda: ref.weighted_gram_rows(Zm, a, Z), 5),
           "library_ms": cuda_ms(lambda: torch.einsum(
               "bnd,bd,bmd->bnm", Zm, a, Z), 5),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"kernel_check": "weighted_gram_tiled", **rec})
    if not (ok and same_rows):
        raise AssertionError(f"weighted_gram_tiled disagrees at {label}: "
                             f"{rec}")
    cases["weighted_gram_tiled"].append(rec)


def shard_large(by_path: dict, world, cases: dict) -> None:
    """(a) the large fit through sample_shard on the world's ranks, per
    engine and reduction, dense (DIST_REPS fits) and under LARGE_BUDGET
    (one), against the vmap fit on the card; then the tiled kernel at a
    rank's panel."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import dtsvm as core
    from repro_torch.engine import invariants
    from repro_torch.engine.invariants import PlanBudget

    V, T, N = (LARGE_FIT[k] for k in ("V", "T", "N"))
    S = world.size
    Nl = N // S
    X, y, adj = large_data()
    budget = PlanBudget(max_elems=LARGE_BUDGET)
    chunk = budget.row_chunk(V * T, Nl, cols=N)
    panels = len(invariants._row_starts(Nl, chunk))
    for label, solver, reduce in SHARD_LARGE_RUNS:
        cfg = SolverConfig(C=0.01, iters=LARGE_FIT["iters"],
                           qp_iters=LARGE_FIT["qp_iters"], qp_solver=solver)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_walls = _vmap_walls(
            lambda: DTSVM(cfg, device="cuda").fit(X, y, adj=adj))
        vmap_peak = torch.cuda.max_memory_allocated()
        for sub, reps, kw, pan in (("dense", DIST_REPS, {}, 1),
                                   ("budget", 1, {"budget": budget},
                                    panels)):
            scfg = cfg.replace(backend="sample_shard", backend_options={
                "world": world, "reduce": reduce}, **kw)
            path = f"shard/large/{label}/{sub}"
            m, walls, ranks = _rank_case(
                path, world, lambda: DTSVM(scfg, device="cuda").fit(
                    X, y, adj=adj), reps, by_path,
                {"gram_prescale": reps, "weighted_gram_tiled": reps * pan})
            errs = _state_errs(m.state_, ref.state_, RTOL_FIT["f32"])
            peaks = [r["peak_mem_bytes"] for r in ranks]
            emit({"shard": path, **LARGE_FIT, "ranks_n": S,
                  "rows_per_rank": Nl, "reduce": reduce,
                  "row_chunk": chunk if sub == "budget" else None,
                  "panels_per_rank": pan, "reps": reps, "fit_s": walls,
                  "fit_s_median": float(np.median(walls)),
                  "vmap_fit_s": ref_walls,
                  "vmap_fit_s_median": float(np.median(ref_walls)),
                  "vs_vmap_max_abs_err": {k: e[0] for k, e in errs.items()},
                  "vmap_max_abs": {k: e[1] for k, e in errs.items()},
                  "bitwise_vmap": all(torch.equal(a, b) for a, b in
                                      zip(m.state_, ref.state_)),
                  "rtol": RTOL_FIT["f32"], "peak_mem_bytes_per_rank": peaks,
                  "vmap_peak_mem_bytes": vmap_peak,
                  **_collectives(ranks, reps * cfg.iters, reps, walls),
                  "ranks": ranks})
            if not all(e[2] for e in errs.values()):
                raise AssertionError(f"{path} off the vmap fit: {errs}")
            if not max(peaks) < vmap_peak:
                raise AssertionError(f"{path}: a rank's peak {max(peaks)} "
                                     f"is not under vmap's {vmap_peak}")
        del ref, m
    # the tiled kernel at rank 1's operands: its rows of the gathered Z
    prob = core.make_problem(X, y, adj=adj, C=0.01, device="cuda")
    Z, a = invariants.compute_z(prob), invariants._masks_part(prob)[3]
    hold_panel("shard/large/rank1_panel", Z.reshape(V * T, N, -1),
               a.reshape(V * T, -1), Nl, Nl, cases)


def shard_scale(by_path: dict, world) -> None:
    """(b) tests/test_scale.py's regime on the world's ranks: gather with
    a risk history, psum, and telemetry on and off, against vmap on the
    card."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import graph
    from repro_torch.data import synthetic

    c = SHARD_SCALE
    V, T, N = c["V"], c["T"], c["N"]
    data = synthetic.make_multitask_data(
        V=V, T=T, p=c["p"], n_train=np.full((V, T), N, int),
        n_test=c["n_test"], seed=0)
    A = graph.make_graph("random", V, degree=c["degree"], seed=0)
    X, y, mask = data["X"], data["y"], data["mask"]
    Xte, yte = data["X_test"], data["y_test"]
    base = SolverConfig(C=0.01, iters=c["iters"], qp_iters=c["qp_iters"])
    shard = lambda **o: base.replace(backend="sample_shard",  # noqa: E731
                                     backend_options={"world": world, **o})
    fit = lambda cfg, **kw: DTSVM(cfg, device="cuda").fit(  # noqa: E731
        X, y, mask=mask, adj=A, **kw)
    ref = fit(base, X_test=Xte, y_test=yte)
    want = {"gram_prescale": 1, "weighted_gram_tiled": 1}
    m, walls, ranks = _rank_case("shard/scale/gather", world, lambda: fit(
        shard(), X_test=Xte, y_test=yte), 1, by_path, want)
    err = max(float((a - b).abs().max()) for a, b in zip(m.state_,
                                                          ref.state_))
    hist_gap = float((m.history_ - ref.history_).abs().max())
    p, _, _ = _rank_case("shard/scale/psum", world, lambda: fit(
        shard(reduce="psum")), 1, by_path, want)
    psum_err = max(float((a - b).abs().max()) for a, b in zip(p.state_,
                                                               ref.state_))
    tel_cfg = shard().replace(telemetry=True)
    on, on_walls, on_ranks = _rank_case("shard/scale/telemetry", world,
                                        lambda: fit(tel_cfg), 1, by_path,
                                        want)
    off, off_walls, _ = _rank_case("shard/scale/no_telemetry", world,
                                   lambda: fit(shard()), 1, by_path, want)
    gaps = _check_streams("shard/scale", on.telemetry_,
                          fit(base.replace(telemetry=True)).telemetry_)
    rec = {"shard": "scale", **c, "ranks_n": world.size,
           "fit_s_history": walls, "vs_vmap_max_abs_err": err,
           "bitwise_vmap": all(torch.equal(a, b) for a, b in
                               zip(m.state_, ref.state_)),
           "history_shape": list(m.history_.shape),
           "history_gap": hist_gap, "risk_limit": 1.0 / c["n_test"],
           "psum_vs_vmap_max_abs_err": psum_err, "psum_tol": SHARD_PSUM_TOL,
           "telemetry_on_off_equal": all(torch.equal(a, b) for a, b in
                                         zip(on.state_, off.state_)),
           "telemetry_s": on_walls, "no_telemetry_s": off_walls,
           "stream_gaps_to_vmap": gaps,
           **_collectives(ranks, c["iters"], 1, walls),
           "telemetry_all_reduces_per_iter":
               (on_ranks[0]["all_reduces"] - 1) / c["iters"],
           "ranks": ranks}
    emit(rec)
    if not (err < DIST_STATE_TOL and hist_gap <= 1.0 / c["n_test"]
            and tuple(m.history_.shape) == (c["iters"], V, T)
            and psum_err < SHARD_PSUM_TOL
            and rec["telemetry_on_off_equal"]):
        raise AssertionError(f"shard/scale off its bars: {rec}")


def _sweep_state_errs(got, want) -> dict:
    """Per leaf: (largest error, largest magnitude of ``want``, within
    DIST_STATE_TOL of that magnitude, or of 1 where it is smaller)."""
    out = {}
    for name, g, w in zip(want._fields, got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        out[name] = (err, scale, err <= DIST_STATE_TOL * max(scale, 1.0))
    return out


def shard_sweep(by_path: dict, world1d, world2d, cases: dict) -> None:
    """(c) Fig. 3's paper grid as a device-tiled sweep, 1-D on
    ``world1d`` and 2-D on ``world2d``, per engine, against the
    single-host sweep on the card; then the kernels at a 1-D rank's
    operands."""
    from repro_torch.api import sweep_fit
    from repro_torch.core import dtsvm as core
    from repro_torch.engine import compile_sweep
    from repro_torch.figures import common, fig3_eps_sweep
    from repro_torch.kernels import ops

    grid = fig3_eps_sweep.EPS_GRID
    cfgs = [dict(eps1=e1, eps2=e2) for e1 in grid for e2 in grid]
    iters, qp_iters = fig3_eps_sweep.ITERS, 100
    data, A = common.build(10, [50, 400], degree=0.8667, seed=0)
    V, n_test = data["X"].shape[0], data["X_test"].shape[1]
    X, y, mask = common._on_device(data, torch.device("cuda"))
    for solver in SWEEP_ENGINES:
        base = common.solver_config(iters=iters, qp_iters=qp_iters,
                                    qp_solver=solver)
        one, one_s = common.run_sweep(data, A, cfgs, iters,
                                      qp_iters=qp_iters, qp_solver=solver,
                                      with_history=False, device="cuda")
        one_risks = one.risks(data["X_test"], data["y_test"])
        for layout, world, options in (
                ("1d", world1d, {"world": world1d}),
                ("2d", world2d, {"world": world2d, "node_axis": "nodes"})):
            rows = world.size if layout == "1d" else len(world.groups)
            per_rank = len(cfgs) // rows
            want = {"weighted_gram": 1, "gram_prescale": 1,
                    "qp_pg_multi": (iters if solver == "pallas_fused_multi"
                                    else 0)}
            path = f"shard/sweep/fig3/{layout}/{solver}"
            res, walls, ranks = _rank_case(path, world, lambda: sweep_fit(
                X, y, cfgs, mask=mask, adj=A, base=base,
                backend="shard_map", backend_options=options,
                device="cuda"), 1, by_path, want)
            errs = _sweep_state_errs(res.states, one.states)
            gap = float((res.risks(data["X_test"], data["y_test"])
                         - one_risks).abs().mean(-2).max())
            emit({"shard": path, "configs": len(cfgs), "V": V,
                  "iters": iters, "qp_iters": qp_iters, "ranks_n": world.size,
                  "configs_per_rank": per_rank,
                  "nodes_per_rank": 1 if layout == "2d" else V,
                  "wall_s": walls[0], "single_host_wall_s": one_s,
                  "state_errs": errs, "state_tol": DIST_STATE_TOL,
                  "bitwise_single_host": all(torch.equal(a, b) for a, b in
                                             zip(res.states, one.states)),
                  "global_risk_gap": gap, "limit": 1.0 / n_test,
                  "nbr_sums_per_iter": ranks[0]["nbr_sums"] / iters,
                  "collective_share_of_wall": [
                      r["collective_s"] / walls[0] for r in ranks],
                  "peak_mem_bytes_per_rank": [r["peak_mem_bytes"]
                                              for r in ranks],
                  "ranks": ranks})
            if not (all(e[2] for e in errs.values())
                    and gap <= 1.0 / n_test + 1e-6):
                raise AssertionError(f"{path} off the single-host sweep: "
                                     f"{errs}, risk gap {gap}")
    # the kernels at rank 0's operands of the 1-D sweep: its configs' K
    # over the shared Z, and one multi solve of its step
    prob = core.make_problem(X, y, mask, A, C=common.C, device="cuda")
    sub = compile_sweep(prob, cfgs[:len(cfgs) // world1d.size],
                        qp_iters=qp_iters, qp_solver="pallas_fused_multi")
    hold_gram("shard/sweep_rank0", sub.inv.Z, sub.inv.a, cases,
              built=sub.inv.K)
    with captured(ops, "qp_pg_multi") as calls:
        sub.step(sub.init_state())
    args, kw = calls[0]
    hold_multi("shard/sweep_rank0/iteration_1", args, kw, cases)


def shard_ring(by_path: dict, world) -> None:
    """(d) tests/test_dist.py's regime over a ring, 2-D on ``world``
    (2 rows of 4 ranks), with pallas_fused, against the single-host
    sweep on the card."""
    from repro_torch.core import dtsvm as core
    from repro_torch.core import graph
    from repro_torch.data import synthetic
    from repro_torch.engine import compile_sweep

    c = SWEEP_RING
    V, T = c["V"], c["T"]
    data = synthetic.make_multitask_data(
        V=V, T=T, p=c["p"], n_train=np.full((V, T), c["n"], int),
        n_test=20, seed=0)
    prob = core.make_problem(data["X"], data["y"], data["mask"],
                             graph.ring(V), device="cuda")
    splan = compile_sweep(prob, list(SWEEP_RING_CFGS),
                          qp_iters=c["qp_iters"], qp_solver=c["qp_solver"])
    own, _ = splan.run(iters=c["iters"])
    per_rank = len(SWEEP_RING_CFGS) // len(world.groups)
    st, walls, ranks = _rank_case(
        "shard/sweep/ring", world, lambda: splan.run_sharded(
            c["iters"], world=world, node_axis="nodes", topology="ring"),
        1, by_path, {"weighted_gram": 1, "gram_prescale": 1,
                     "qp_pg_step": c["iters"] * c["qp_iters"]})
    err = max(float((a - b).abs().max()) for a, b in zip(st, own))
    emit({"shard": "sweep/ring", **c, "configs": len(SWEEP_RING_CFGS),
          "ranks_n": world.size, "configs_per_rank": per_rank,
          "wall_s": walls[0], "vs_single_host_max_abs_err": err,
          "bitwise_single_host": all(torch.equal(a, b)
                                     for a, b in zip(st, own)),
          "nbr_sums_per_iter": ranks[0]["nbr_sums"] / c["iters"],
          "ranks": ranks})
    if not err < DIST_STATE_TOL:
        raise AssertionError(f"shard/sweep/ring off the single-host sweep "
                             f"by {err}")


def shard_dies(world) -> None:
    """(e) a sample rank that dies: the fit raises, no rank stays alive."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.dist import RankError

    c = SHARD_SCALE
    rng = np.random.default_rng(0)
    X = rng.normal(size=(c["V"], c["T"], c["N"], c["p"])).astype(np.float32)
    y = np.sign(rng.normal(size=X.shape[:3])).astype(np.float32)
    world._procs[1].kill()
    world._procs[1].join()
    try:
        DTSVM(SolverConfig(iters=1, qp_iters=5, backend="sample_shard",
                           backend_options={"world": world}),
              device="cuda").fit(X, y)
    except RankError as e:
        died = str(e)
    else:
        raise AssertionError("a fit on a world with a dead rank did not "
                             "raise")
    alive = sum(p.is_alive() for p in world._procs)
    emit({"shard": "rank_died", "error": died, "closed": world.closed,
          "ranks_alive": alive})
    if not (world.closed and alive == 0):
        raise AssertionError("a failed world left ranks running")


def shard(by_path: dict, cases: dict) -> None:
    """Phase 14: the sample_shard backend and the device-tiled sweep on
    the card, on three worlds: SHARD_RANKS ranks (the sample fits and
    the 1-D sweep), SWEEP_ROWS_2D rows of 10 (Fig. 3's 2-D sweep) and 2
    rows of 4 (the ring)."""
    from repro_torch.dist import World
    from repro_torch.dist import sharding

    phase_t0 = time.perf_counter()
    starts = {}
    with World(SHARD_RANKS, device="cuda") as world:
        starts[f"{SHARD_RANKS}"] = world.start_seconds
        shard_large(by_path, world, cases)
        shard_scale(by_path, world)
        with sharding.make_sweep_world(16, 10, n_sweep=SWEEP_ROWS_2D,
                                       device="cuda") as world2d:
            starts[f"{SWEEP_ROWS_2D}x10"] = world2d.start_seconds
            shard_sweep(by_path, world, world2d, cases)
        shard_dies(world)
    with sharding.make_sweep_world(len(SWEEP_RING_CFGS), SWEEP_RING["V"],
                                   n_sweep=2, device="cuda") as world8:
        starts["2x4"] = world8.start_seconds
        shard_ring(by_path, world8)
    emit({"phase": "shard", "world_start_s": starts,
          "launches": by_path.get("shard"),
          "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 15: the dense decoder's serving path at Gemma-2 2B's full width
def _decode_vs_prefill(net, cfg, prompts, gen: int, at, long_mode: bool,
                       label: str, extra=None) -> list:
    """Greedy decode ``gen`` tokens after ``prompts``; at each step in
    ``at``, decode's logits against a prefill over the prompt and the
    tokens generated so far (max abs diff <= LM_TOL, equal argmax).
    ``extra`` joins every prefill's batch (whisper's ``frames``)."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.train import steps

    prefill = steps.make_prefill_step(cfg, long_mode)
    decode = steps.make_decode_step(cfg, long_mode)
    B, S = prompts.shape
    extra = extra or {}
    logits, cache = prefill(net, {"tokens": prompts, **extra})
    cache = serve_lib._grow_cache(cfg, cache, B, S + gen, long_mode)
    seq, idx, out = prompts, S, []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for step in range(1, gen + 1):
        seq = torch.cat([seq, tok], dim=1)
        logits, cache, idx = decode(net, tok, cache, idx)
        if step in at:
            full, _ = prefill(net, {"tokens": seq, **extra})
            err = float((logits - full).abs().max())
            same = bool(torch.equal(logits.argmax(-1), full.argmax(-1)))
            out.append({"step": step, "positions": S + step,
                        "max_abs_diff": err, "argmax_equal": same,
                        "max_abs_logit": float(full.abs().max())})
            if not (err <= LM_TOL and same):
                raise AssertionError(
                    f"{label}: decode at step {step} differs from a prefill "
                    f"over {S + step} tokens by {err} (argmax equal: {same})")
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return out


def _timed_steps(net, cfg, prompts, gen: int, extra=None) -> tuple:
    """The prefill step's ms (3 runs) and the decode step's ms a token
    over ``gen`` greedy tokens, by CUDA events; returns them with the
    last cache, token and position.  The cache holds S + gen + 1 slots,
    so that the step a caller traces next, at position S + gen, has a
    slot of its own (MLA's decode raises past its cache; a global GQA
    layer's would overwrite position 0).  ``extra`` joins the prefill's
    batch (whisper's ``frames``)."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.train import steps

    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    B, S = prompts.shape
    pre_ms = []
    for _ in range(3):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        logits, cache = prefill(net, {"tokens": prompts, **(extra or {})})
        ev1.record()
        torch.cuda.synchronize()
        pre_ms.append(ev0.elapsed_time(ev1))
    cache = serve_lib._grow_cache(cfg, cache, B, S + gen + 1, False)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    idx = S
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(gen):
        logits, cache, idx = decode(net, tok, cache, idx)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    ev1.record()
    torch.cuda.synchronize()
    return pre_ms, ev0.elapsed_time(ev1) / gen, logits, cache, tok, idx


def lm_serve(by_path: dict) -> None:
    """Phase 15: Gemma-2 2B at full width through ``generate`` (bf16),
    then decode against prefill in fp32, in normal and long mode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    emit({"lm": "init", "arch": cfg.name, "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    # the config's count leaves out the final norm's d_model scales
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count()} + {cfg.d_model}")

    # (a) bf16 generate at the serving shape
    a = LM_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    serve_lib.generate(cfg, net, prompts[:, :64], 2)    # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_serve"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n)
    # one step of each under the profiler: device busy share and launches
    # (the loop is eager Python: a launch per op of every layer)
    for label, fn in (("lm prefill step", lambda: prefill(
            net, {"tokens": prompts})), ("lm decode step", lambda: decode(
                net, tok, cache, idx))):
        if any(_profile(label, fn).values()):
            raise AssertionError(f"{label}: the profiler saw hand kernels")
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm": "serve/bf16", "arch": cfg.name, "batch": B, "prompt": S,
          "gen": n, "wall_s": wall, "tokens_per_s": B * n / wall,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "peak_gb": peak, "launches": launches,
          "tokens_ok": ok_toks, "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_serve: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_serve launched hand kernels: {launches}")
    del cache, logits

    # (b) fp32: decode against prefill after the 512-token prompt
    cfg32 = cfg.replace(compute_dtype="float32")
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts, max(LM_STEPS),
                                LM_STEPS, False, "lm/fp32")
    emit({"lm": "decode_vs_prefill/fp32", "batch": B, "prompt": S,
          "checks": checks, "tol": LM_TOL,
          "seconds": time.perf_counter() - t0})

    # (c) long mode: the prompt over the window, the ring wrapping
    c = LM_LONG
    long_prompt = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]),
                                generator=gen, dtype=torch.int32,
                                device="cuda")
    flash_calls = []
    real_flash = attention._flash_sdpa

    def counting_flash(*args, **kw):
        flash_calls.append(args[0].shape[1])
        return real_flash(*args, **kw)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    attention._flash_sdpa = counting_flash
    try:
        checks = _decode_vs_prefill(net, cfg32, long_prompt, c["gen"],
                                    c["steps"], True, "lm/long")
    finally:
        attention._flash_sdpa = real_flash
    cache_len = min(c["prompt"], cfg.long_context_window)
    emit({"lm": "decode_vs_prefill/long", "batch": c["batch"],
          "prompt": c["prompt"], "window": cfg.long_context_window,
          "cache_len": cache_len, "checks": checks, "tol": LM_TOL,
          "flash_prefill_layers": flash_calls.count(c["prompt"]),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    if flash_calls.count(c["prompt"]) != cfg.num_layers:
        raise AssertionError(f"lm/long: the {c['prompt']}-token prefill "
                             f"took _flash_sdpa in "
                             f"{flash_calls.count(c['prompt'])} of "
                             f"{cfg.num_layers} layers")
    del net
    torch.cuda.empty_cache()
    emit({"phase": "lm", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 16: the mixture-of-experts serving path at Phi-3.5-MoE's full width
def host_kept(picks: np.ndarray, num_experts: int,
              capacity_factor: float) -> tuple:
    """The reference's drop rule (``repro/models/moe.py:95-104`` and
    ``_dispatch_group``) in numpy, from a (T, K) array of picks: its
    halving loop for the groups, the capacity by Python's ``round``, the
    exclusive cumsum over the token-major, k-minor flattening.  Returns
    (groups, capacity, kept mask (G, Tg*K))."""
    T, K = picks.shape
    G = 32
    while T % G != 0 or T // G < 1:
        G //= 2
        if G <= 1:
            G = 1
            break
    Tg = T // G
    cap = int(max(1, round(Tg * K / num_experts * capacity_factor)))
    cap = min(Tg, max(cap, min(Tg, 8)))
    flat = picks.reshape(G, Tg * K)
    onehot = (flat[..., None] == np.arange(num_experts)).astype(np.int64)
    pos = np.cumsum(onehot, axis=1) - onehot
    pos = np.take_along_axis(pos, flat[..., None], axis=2)[..., 0]
    return G, cap, pos < cap


def lm_moe(by_path: dict) -> None:
    """Phase 16: Phi-3.5-MoE at full width (MOE_LAYERS layers) through
    ``generate`` (bf16, capacity factor 1.25), decode against prefill in
    fp32 at a dropless capacity, and the drop rule on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    emit({"lm_moe": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "published_layers": get_config(MOE_ARCH).num_layers,
          "experts": cfg.num_experts, "top_k": cfg.moe_top_k,
          "expert_d_ff": cfg.moe_d_ff, "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    # the config's count leaves out the final norm's d_model scales
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count()} + {cfg.d_model}")

    # (a) bf16 generate at the serving shape, the published capacity
    a = LM_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    serve_lib.generate(cfg, net, prompts[:, :64], 2)    # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_moe"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n)
    decode = steps.make_decode_step(cfg)
    if any(_profile("lm_moe decode step",
                    lambda: decode(net, tok, cache, idx)).values()):
        raise AssertionError("lm_moe decode step: the profiler saw hand "
                             "kernels")
    traced = RECORDS[-1]
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm_moe": "serve/bf16", "arch": cfg.name, "batch": B, "prompt": S,
          "gen": n, "capacity_factor": cfg.moe_capacity_factor,
          "wall_s": wall, "tokens_per_s": B * n / wall,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "decode_device_busy_share": traced["device_busy_share"],
          "decode_device_launches": traced["device_launches"],
          "peak_gb": peak, "launches": launches,
          "tokens_ok": ok_toks, "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_moe: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_moe launched hand kernels: {launches}")
    del cache, logits

    # (b) fp32 at a dropless capacity: decode against prefill
    dropless = cfg.num_experts / cfg.moe_top_k
    cfg32 = cfg.replace(compute_dtype="float32",
                        moe_capacity_factor=dropless)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts, max(LM_STEPS),
                                LM_STEPS, False, "lm_moe/fp32")
    emit({"lm_moe": "decode_vs_prefill/fp32", "batch": B, "prompt": S,
          "capacity_factor": dropless, "checks": checks, "tol": LM_TOL,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    # (c) the drop rule at (a)'s prefill: layer 0's ln2 input, routed and
    # dispatched on the card, its kept mask against the reference's rule
    # computed on the host from the card's own picks
    seen = []
    real_apply = moe.moe_apply

    def capture(p, x, *args, **kw):
        if not seen:
            seen.append((p, x))
        return real_apply(p, x, *args, **kw)

    moe.moe_apply = capture
    try:
        steps.make_prefill_step(cfg)(net, {"tokens": prompts})
    finally:
        moe.moe_apply = real_apply
    p, x = seen[0]
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1)
    G = moe.groups(T)
    cap = moe.capacity(T // G, cfg, cfg.moe_capacity_factor)
    with torch.no_grad():
        probs, _, gate_i = moe.route(p, xt, cfg)
        _, _, _, keep = moe._dispatch_group(
            xt.reshape(G, T // G, -1), gate_i.reshape(G, T // G, -1),
            cfg.num_experts, cap)
    picks, kept = gate_i.cpu().numpy(), keep.cpu().numpy()
    probs = probs.cpu().numpy()
    hG, hcap, hkept = host_kept(picks, cfg.num_experts,
                                cfg.moe_capacity_factor)
    K = cfg.moe_top_k
    stable = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    top = -np.sort(-probs, axis=-1)
    rec = {"lm_moe": "drop_rule", "tokens": T, "layer": 0,
           "capacity_factor": cfg.moe_capacity_factor, "groups": G,
           "capacity": cap, "host_groups": hG, "host_capacity": hcap,
           "assignments": int(kept.size),
           "dropped": int((~kept).sum()),
           "dropped_share": float((~kept).mean()),
           "kept_equal_host_rule": bool(np.array_equal(kept, hkept)),
           "picks_equal_host_stable_sort": bool(np.array_equal(picks,
                                                               stable)),
           "tokens_with_tied_probs_in_top_k_plus_1": int(
               (np.diff(top[:, :K + 1], axis=-1) == 0).any(-1).sum())}
    emit(rec)
    if not (rec["kept_equal_host_rule"] and rec["picks_equal_host_stable_sort"]
            and (G, cap) == (hG, hcap) and rec["dropped"] > 0):
        raise AssertionError(f"lm_moe: the drop rule on the card differs "
                             f"from the reference's, or drops nothing: {rec}")
    del net, seen, p, x, xt
    torch.cuda.empty_cache()
    emit({"phase": "lm_moe", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 17: DeepSeek-V2's multi-head latent attention at full width
def _cache_bytes(cache: dict, names) -> int:
    layers = [cache["layers"], *cache.get("dense", ())]
    return sum(c[n].numel() * c[n].element_size() for c in layers
               for n in names)


def _expanded_kv_bytes(cfg, cache: dict) -> int:
    """The bytes of expanded per-head K/V caches of the latent cache's
    shape (its layers, batch and slots), read from meta tensors."""
    layers = [cache["layers"]["ckv"], *(c["ckv"][None]
                                        for c in cache.get("dense", ()))]
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    total = 0
    for ckv in layers:
        L, B, Sc = ckv.shape[:3]
        for dim in (qk, cfg.v_head_dim):
            t = torch.empty((L, B, Sc, cfg.num_heads, dim), dtype=ckv.dtype,
                            device="meta")
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def _ranges(targets):
    """Wrap each ``(module, attr, range name)`` function in a
    ``record_function`` range while the block runs."""
    real = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrapped(fn, name):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    for (mod, attr, fn), (_, _, name) in zip(real, targets):
        setattr(mod, attr, wrapped(fn, name))
    try:
        yield
    finally:
        for mod, attr, fn in real:
            setattr(mod, attr, fn)


def lm_mla(by_path: dict) -> None:
    """Phase 17: DeepSeek-V2 at full width (DSV2_LAYERS layers) through
    ``generate`` (bf16, capacity factor 1.25), then decode against prefill
    in fp32 at a dropless capacity, after a 512- and a 2560-token
    prompt."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    published = get_config(MLA_ARCH)
    cfg = published.replace(num_layers=DSV2_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    emit({"lm_mla": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "published_layers": published.num_layers,
          "reduced": {"num_layers": [published.num_layers, cfg.num_layers]},
          "dense_layers": len(net.dense_layers), "moe_layers": len(net.layers),
          "heads": cfg.num_heads, "q_lora": cfg.q_lora_rank,
          "kv_lora": cfg.kv_lora_rank, "nope": cfg.qk_nope_head_dim,
          "rope": cfg.qk_rope_head_dim, "v_head": cfg.v_head_dim,
          "experts": cfg.num_experts, "top_k": cfg.moe_top_k,
          "params": n_params, "param_count_cfg": cfg.param_count(),
          "published_params_gb": published.param_count() * 4 / 1e9,
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    # the config's count leaves out the final norm's d_model scales and
    # each layer's two latent norms
    norms = cfg.d_model + cfg.num_layers * (cfg.q_lora_rank
                                            + cfg.kv_lora_rank)
    if n_params != cfg.param_count() + norms:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count()} + {norms}")

    # (a) bf16 generate at the serving shape, the published capacity
    a = LM_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    serve_lib.generate(cfg, net, prompts[:, :64], 2)    # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_mla"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n)
    decode = steps.make_decode_step(cfg)
    blocks = ("mla_block", "moe_layer")
    with _ranges([(attention, "mla_decode", "mla_block"),
                  (moe, "moe_apply", "moe_layer")]):
        if any(_profile("lm_mla decode step",
                        lambda: decode(net, tok, cache, idx),
                        blocks).values()):
            raise AssertionError("lm_mla decode step: the profiler saw hand "
                                 "kernels")
    traced = RECORDS[-1]
    latent = _cache_bytes(cache, ("ckv", "kr"))
    expanded = _expanded_kv_bytes(cfg, cache)
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm_mla": "serve/bf16", "arch": cfg.name, "batch": B, "prompt": S,
          "gen": n, "capacity_factor": cfg.moe_capacity_factor,
          "wall_s": wall, "tokens_per_s": B * n / wall,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "decode_device_busy_share": traced["device_busy_share"],
          "decode_device_launches": traced["device_launches"],
          "decode_device_ms": traced["device_busy_s"] * 1e3,
          "decode_mla_blocks_device_ms":
              traced["block_device_ms"]["mla_block"],
          "decode_moe_layers_device_ms":
              traced["block_device_ms"]["moe_layer"],
          "decode_block_calls": traced["block_calls"],
          "cache_slots": int(cache["layers"]["pos"].shape[-1]),
          "latent_cache_bytes": latent,
          "pos_bytes": _cache_bytes(cache, ("pos",)),
          "expanded_kv_cache_bytes": expanded,
          "expanded_over_latent": expanded / latent,
          "peak_gb": peak, "launches": launches,
          "tokens_ok": ok_toks, "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_mla: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_mla launched hand kernels: {launches}")
    if traced["block_calls"] != {"mla_block": cfg.num_layers,
                                 "moe_layer": len(net.layers)}:
        raise AssertionError(f"lm_mla: the traced decode step ran "
                             f"{traced['block_calls']} blocks")
    del cache, logits

    # (b) fp32 at a dropless capacity: decode against prefill
    if not MLA_DROPLESS >= cfg.num_experts / cfg.moe_top_k:
        raise AssertionError(f"{MLA_DROPLESS} is not dropless")
    cfg32 = cfg.replace(compute_dtype="float32",
                        moe_capacity_factor=MLA_DROPLESS)
    B32 = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts[:B32], max(LM_STEPS),
                                LM_STEPS, False, "lm_mla/fp32")
    emit({"lm_mla": "decode_vs_prefill/fp32", "batch": B32, "prompt": S,
          "capacity_factor": MLA_DROPLESS, "checks": checks, "tol": LM_TOL,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    # (c) a prompt over the chunk threshold: MLA prefill takes _flash_sdpa
    # with v narrower than q and k; decode reads the 2576-slot cache
    c = MLA_LONG
    long_prompt = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]),
                                generator=gen, dtype=torch.int32,
                                device="cuda")
    flash_calls = []
    real_flash = attention._flash_sdpa

    def counting_flash(q, k, v, *args, **kw):
        flash_calls.append((q.shape[1], q.shape[-1], v.shape[-1]))
        return real_flash(q, k, v, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    attention._flash_sdpa = counting_flash
    try:
        checks = _decode_vs_prefill(net, cfg32, long_prompt, c["gen"],
                                    c["steps"], False, "lm_mla/long")
    finally:
        attention._flash_sdpa = real_flash
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    want_call = (c["prompt"], qk, cfg.v_head_dim)
    emit({"lm_mla": "decode_vs_prefill/long", "batch": c["batch"],
          "prompt": c["prompt"], "cache_slots": c["prompt"] + c["gen"],
          "capacity_factor": MLA_DROPLESS, "checks": checks, "tol": LM_TOL,
          "flash_prefill_layers": flash_calls.count(want_call),
          "flash_calls": sorted(set(flash_calls)),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    if flash_calls.count(want_call) != cfg.num_layers:
        raise AssertionError(f"lm_mla/long: the {c['prompt']}-token prefill "
                             f"took _flash_sdpa with Dv {cfg.v_head_dim} in "
                             f"{flash_calls.count(want_call)} of "
                             f"{cfg.num_layers} layers")
    del net
    torch.cuda.empty_cache()
    emit({"phase": "lm_mla", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 18: Mamba2's state-space serving path at mamba2-130m's full size
def lm_ssm(by_path: dict) -> None:
    """Phase 18: mamba2-130m at full size through ``generate`` (bf16),
    then decode against prefill in fp32 after a 512-, a 4100- and a
    2-token prompt, then a 32768-token bf16 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    # the config's count leaves out the final norm's d_model scales, and
    # per layer it books a second norm (d_model) that a mamba layer lacks,
    # and neither conv_b (conv_ch) nor the third H-wide vector
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    extra = cfg.d_model + cfg.num_layers * (conv_ch + cfg.ssm_nheads
                                            - cfg.d_model)
    emit({"lm_ssm": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_heads": cfg.ssm_nheads, "head_dim": cfg.ssm_head_dim,
          "d_state": cfg.ssm_state, "groups": cfg.ssm_ngroups,
          "conv": cfg.ssm_conv, "chunk": cfg.ssm_chunk,
          "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings,
          "params": n_params, "param_count_cfg": cfg.param_count(),
          "param_count_extra": extra, "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    if n_params != cfg.param_count() + extra:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count()} + {extra}")

    def cache_shapes(cache, B):
        got = {k: (tuple(v.shape), str(v.dtype)) for k, v in
               cache["layers"].items()}
        want = {"h": ((cfg.num_layers, B, cfg.ssm_nheads, cfg.ssm_head_dim,
                       cfg.ssm_state), "torch.float32"),
                "conv": ((cfg.num_layers, B, cfg.ssm_conv - 1, conv_ch),
                         "torch.bfloat16")}
        if got != want or set(cache) != {"layers"}:
            raise AssertionError(f"lm_ssm: the cache holds {got}, not "
                                 f"{want}")
        return {k: _cache_bytes(cache, (k,)) for k in want}

    # (a) bf16 generate at the serving shape
    a = LM_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    serve_lib.generate(cfg, net, prompts[:, :64], 2)    # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_ssm"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n)
    cache_bytes = cache_shapes(cache, B)
    decode = steps.make_decode_step(cfg)
    with _ranges([(ssm, "mamba_decode", "mamba_block")]):
        if any(_profile("lm_ssm decode step",
                        lambda: decode(net, tok, cache, idx),
                        ("mamba_block",)).values()):
            raise AssertionError("lm_ssm decode step: the profiler saw hand "
                                 "kernels")
    traced = RECORDS[-1]
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm_ssm": "serve/bf16", "arch": cfg.name, "batch": B, "prompt": S,
          "gen": n, "wall_s": wall, "tokens_per_s": B * n / wall,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "decode_device_busy_share": traced["device_busy_share"],
          "decode_device_launches": traced["device_launches"],
          "decode_device_ms": traced["device_busy_s"] * 1e3,
          "decode_mamba_blocks_device_ms":
              traced["block_device_ms"]["mamba_block"],
          "decode_block_calls": traced["block_calls"],
          "cache_bytes": cache_bytes, "peak_gb": peak, "launches": launches,
          "tokens_ok": ok_toks, "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_ssm: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_ssm launched hand kernels: {launches}")
    if traced["block_calls"] != {"mamba_block": cfg.num_layers}:
        raise AssertionError(f"lm_ssm: the traced decode step ran "
                             f"{traced['block_calls']} blocks")
    del cache, logits

    # (b) fp32: decode against prefill after the 512-token prompt
    cfg32 = cfg.replace(compute_dtype="float32")
    B32 = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts[:B32], max(LM_STEPS),
                                LM_STEPS, False, "lm_ssm/fp32")
    emit({"lm_ssm": "decode_vs_prefill/fp32", "batch": B32, "prompt": S,
          "checks": checks, "tol": LM_TOL,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    # (c) fp32, batch 1: a padded tail, and a prompt shorter than the
    # conv window; every SSD call's (padded length, chunk) recorded
    ssd_calls = []
    real_ssd = ssm.ssd_chunked

    def counting_ssd(x, *args, **kw):
        ssd_calls.append((x.shape[1], args[4]))
        return real_ssd(x, *args, **kw)

    for c in SSM_PROMPTS:
        prompt = torch.randint(0, cfg.vocab_size, (1, c["prompt"]),
                               generator=gen, dtype=torch.int32,
                               device="cuda")
        chunk = min(cfg.ssm_chunk, c["prompt"])
        want_call = (-(-c["prompt"] // chunk) * chunk, chunk)
        ssd_calls.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ssm.ssd_chunked = counting_ssd
        try:
            checks = _decode_vs_prefill(net, cfg32, prompt, c["gen"],
                                        c["steps"], False,
                                        f"lm_ssm/prompt{c['prompt']}")
        finally:
            ssm.ssd_chunked = real_ssd
        emit({"lm_ssm": f"decode_vs_prefill/prompt{c['prompt']}",
              "batch": 1, "prompt": c["prompt"], "chunk": chunk,
              "padded": want_call[0], "chunks": want_call[0] // chunk,
              "checks": checks, "tol": LM_TOL,
              "prompt_ssd_calls": ssd_calls[:cfg.num_layers],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - t0})
        # the prompt's prefill runs first, one SSD call a layer
        if ssd_calls[:cfg.num_layers] != [want_call] * cfg.num_layers:
            raise AssertionError(f"lm_ssm: the {c['prompt']}-token prefill "
                                 f"ran SSD over {ssd_calls[:cfg.num_layers]}"
                                 f", not {want_call} in each layer")

    # (d) bf16, batch 1: a long prefill; the cache a batch row of (a)'s
    prefill = steps.make_prefill_step(cfg)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, SSM_PREFILL),
                                generator=gen, dtype=torch.int32,
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    long_ms = []
    for _ in range(3):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        logits, cache = prefill(net, {"tokens": long_prompt})
        ev1.record()
        torch.cuda.synchronize()
        long_ms.append(ev0.elapsed_time(ev1))
    long_bytes = cache_shapes(cache, 1)
    emit({"lm_ssm": "prefill/bf16", "batch": 1, "prompt": SSM_PREFILL,
          "chunks": SSM_PREFILL // cfg.ssm_chunk,
          "prefill_ms": sorted(long_ms)[1], "prefill_ms_all": long_ms,
          "tokens_per_s": SSM_PREFILL * 1e3 / sorted(long_ms)[1],
          "cache_bytes": long_bytes,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("lm_ssm: the long prefill's logits are not "
                             "finite")
    if {k: v * B for k, v in long_bytes.items()} != cache_bytes:
        raise AssertionError(f"lm_ssm: a {SSM_PREFILL}-token cache holds "
                             f"{long_bytes} a row, the {S}-token one "
                             f"{cache_bytes} for {B}")
    del net, cache, logits
    torch.cuda.empty_cache()

    # (e) the module's CLI with no --device: full size, on the card
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        toks = serve_lib.main(["--arch", SSM_ARCH, "--batch", "2",
                               "--prompt-len", "64", "--gen", "4"])
    emit({"lm_ssm": "cli", "argv": f"--arch {SSM_ARCH} --batch 2 "
          "--prompt-len 64 --gen 4", "device": str(toks.device),
          "printed": out.getvalue().strip(),
          "seconds": time.perf_counter() - t0})
    if toks.device.type != "cuda" or tuple(toks.shape) != (2, 4) or \
            "generated (2, 4) on cuda" not in out.getvalue():
        raise AssertionError(f"lm_ssm: the CLI gave {tuple(toks.shape)} on "
                             f"{toks.device}: {out.getvalue()!r}")
    del toks
    torch.cuda.empty_cache()
    emit({"phase": "lm_ssm", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 19: Zamba2's hybrid serving path at zamba2-1.2b's full size
def lm_hybrid(by_path: dict) -> None:
    """Phase 19: zamba2-1.2b at full size through ``generate`` (bf16),
    then decode against prefill in fp32 after a 512-token prompt and, in
    long mode, after a 4610-token one, then the module's CLI."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import attention, ssm, transformer
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    # (e) the parameter count: one tied block, not one a flagged layer
    n_params = sum(p.numel() for p in net.parameters())
    n_shared = sum(1 for name, _ in net.named_modules()
                   if name.split(".")[-1] == "shared_attn")
    shared_params = sum(p.numel() for p in net.shared_attn.parameters())
    flagged = transformer.shared_attn_layers(cfg)
    emit({"lm_hybrid": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_heads": cfg.ssm_nheads, "head_dim": cfg.ssm_head_dim,
          "d_state": cfg.ssm_state, "groups": cfg.ssm_ngroups,
          "conv": cfg.ssm_conv, "chunk": cfg.ssm_chunk,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "attn_head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings,
          "shared_after": list(flagged), "shared_modules": n_shared,
          "shared_params": shared_params, "params": n_params,
          "params_reference": HYBRID_PARAMS,
          "params_equal": n_params == HYBRID_PARAMS,
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    if n_params != HYBRID_PARAMS or n_shared != 1:
        raise AssertionError(f"lm_hybrid: {n_params} parameters in "
                             f"{n_shared} shared blocks, the reference "
                             f"holds {HYBRID_PARAMS} in one")
    if flagged != HYBRID_FLAGGED:
        raise AssertionError(f"lm_hybrid: the shared block follows layers "
                             f"{flagged}")

    def cache_bytes(cache, B, slots):
        got = {k: (tuple(v.shape), str(v.dtype)) for k, v in
               cache["layers"].items()}
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        kv = ((L, B, slots, K, hd), "torch.bfloat16")
        want = {"h": ((L, B, cfg.ssm_nheads, cfg.ssm_head_dim,
                       cfg.ssm_state), "torch.float32"),
                "conv": ((L, B, cfg.ssm_conv - 1, conv_ch),
                         "torch.bfloat16"),
                "k": kv, "v": kv, "pos": ((L, slots), "torch.int32")}
        if got != want or set(cache) != {"layers"}:
            raise AssertionError(f"lm_hybrid: the cache holds {got}, not "
                                 f"{want}")
        return {k: _cache_bytes(cache, (k,)) for k in want}

    # (a) bf16 generate at the serving shape
    a = LM_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    serve_lib.generate(cfg, net, prompts[:, :64], 2)    # first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_hybrid"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n)
    slots = S + n + 1
    by_entry = cache_bytes(cache, B, slots)
    unread = cfg.num_layers - len(flagged)
    unread_kv = (by_entry["k"] + by_entry["v"]) * unread // cfg.num_layers
    decode = steps.make_decode_step(cfg)
    blocks = ("mamba_block", "shared_block")
    # the stack's only attention blocks are the shared block's calls
    with _ranges([(ssm, "mamba_decode", "mamba_block"),
                  (transformer, "_attn_block_decode", "shared_block")]):
        if any(_profile("lm_hybrid decode step",
                        lambda: decode(net, tok, cache, idx),
                        blocks).values()):
            raise AssertionError("lm_hybrid decode step: the profiler saw "
                                 "hand kernels")
    traced = RECORDS[-1]
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm_hybrid": "serve/bf16", "arch": cfg.name, "batch": B,
          "prompt": S, "gen": n, "wall_s": wall,
          "tokens_per_s": B * n / wall,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "decode_device_busy_share": traced["device_busy_share"],
          "decode_device_launches": traced["device_launches"],
          "decode_device_ms": traced["device_busy_s"] * 1e3,
          "decode_mamba_blocks_device_ms":
              traced["block_device_ms"]["mamba_block"],
          "decode_shared_blocks_device_ms":
              traced["block_device_ms"]["shared_block"],
          "decode_block_calls": traced["block_calls"],
          "cache_slots": slots, "cache_bytes": by_entry,
          "cache_bytes_total": sum(by_entry.values()),
          "unread_kv_layers": unread, "unread_kv_bytes": unread_kv,
          "peak_gb": peak, "launches": launches, "tokens_ok": ok_toks,
          "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_hybrid: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_hybrid launched hand kernels: {launches}")
    want_calls = {"mamba_block": cfg.num_layers, "shared_block": len(flagged)}
    if traced["block_calls"] != want_calls:
        raise AssertionError(f"lm_hybrid: the traced decode step ran "
                             f"{traced['block_calls']}, not {want_calls}")
    del cache, logits

    # (b) fp32: decode against prefill after the 512-token prompt
    cfg32 = cfg.replace(compute_dtype="float32")
    B32 = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts[:B32], max(LM_STEPS),
                                LM_STEPS, False, "lm_hybrid/fp32")
    emit({"lm_hybrid": "decode_vs_prefill/fp32", "batch": B32, "prompt": S,
          "checks": checks, "tol": LM_TOL,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    # (c) long mode, fp32, batch 1: the shared block's ring wraps; each
    # prompt's attention schedule and SSD calls (padded length, chunk)
    # recorded
    calls = {"flash": [], "plain": [], "ssd": []}
    real = (attention._flash_sdpa, attention._sdpa, ssm.ssd_chunked)

    def counting(name, fn):
        def call(x, *args, **kw):
            calls[name].append((x.shape[1], args[4]) if name == "ssd"
                               else x.shape[1])
            return fn(x, *args, **kw)
        return call

    chunk = cfg.ssm_chunk
    for c in HYBRID_LONG:
        S_long = c["prompt"]
        prompt = torch.randint(0, cfg.vocab_size, (1, S_long), generator=gen,
                               dtype=torch.int32, device="cuda")
        want_ssd = (-(-S_long // chunk) * chunk, chunk)
        for v in calls.values():
            v.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (attention._flash_sdpa, attention._sdpa,
         ssm.ssd_chunked) = (counting("flash", real[0]),
                             counting("plain", real[1]),
                             counting("ssd", real[2]))
        try:
            checks = _decode_vs_prefill(net, cfg32, prompt, c["gen"],
                                        c["steps"], True,
                                        f"lm_hybrid/long{S_long}")
        finally:
            attention._flash_sdpa, attention._sdpa, ssm.ssd_chunked = real
        cache_len = transformer.required_cache_len(cfg, S_long, True)
        # the prompt's prefill: one attention call a shared block
        took = {k: calls[k].count(S_long) for k in ("flash", "plain")}
        emit({"lm_hybrid": f"decode_vs_prefill/long{S_long}", "batch": 1,
              "prompt": S_long, "window": cfg.long_context_window,
              "cache_len": cache_len, "checks": checks, "tol": LM_TOL,
              "prompt_attention_calls": took, "padded": want_ssd[0],
              "chunks": want_ssd[0] // chunk,
              "prompt_ssd_calls": calls["ssd"][:cfg.num_layers],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - t0})
        if cache_len != cfg.long_context_window:
            raise AssertionError(f"lm_hybrid/long{S_long}: {cache_len} "
                                 f"slots, not the "
                                 f"{cfg.long_context_window}-slot ring")
        want_took = {"flash": len(flagged) if c["flash"] else 0,
                     "plain": 0 if c["flash"] else len(flagged)}
        if took != want_took:
            raise AssertionError(f"lm_hybrid/long{S_long}: the prompt's "
                                 f"shared blocks took {took}, not "
                                 f"{want_took}")
        if calls["ssd"][:cfg.num_layers] != [want_ssd] * cfg.num_layers:
            raise AssertionError(f"lm_hybrid/long{S_long}: the prefill ran "
                                 f"SSD over {calls['ssd'][:cfg.num_layers]}"
                                 f", not {want_ssd} in each layer")
    del net
    torch.cuda.empty_cache()

    # (d) the module's CLI with no --device: full size, on the card
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        toks = serve_lib.main(["--arch", HYBRID_ARCH, "--batch", "2",
                               "--prompt-len", "64", "--gen", "4"])
    emit({"lm_hybrid": "cli", "argv": f"--arch {HYBRID_ARCH} --batch 2 "
          "--prompt-len 64 --gen 4", "device": str(toks.device),
          "printed": out.getvalue().strip(),
          "seconds": time.perf_counter() - t0})
    if toks.device.type != "cuda" or tuple(toks.shape) != (2, 4) or \
            "generated (2, 4) on cuda" not in out.getvalue():
        raise AssertionError(f"lm_hybrid: the CLI gave {tuple(toks.shape)} "
                             f"on {toks.device}: {out.getvalue()!r}")
    del toks
    torch.cuda.empty_cache()
    emit({"phase": "lm_hybrid", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 20: Whisper's encoder-decoder serving path at whisper-small's full
# size
def lm_encdec(by_path: dict) -> None:
    """Phase 20: whisper-small at full size with a 448-row decoder table
    through ``generate`` (bf16) over 1500 stub frames a row, the encoder
    and the prefill timed apart, then decode against prefill in fp32, the
    module's CLI and the parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import transformer
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import torch_dtype
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    a = ENCDEC_SERVE
    B, S, n = a["batch"], a["prompt"], a["gen"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model_lib.init_params(
        cfg, gen, InputShape("serve", ENCDEC_ROWS, B, "prefill"),
        device="cuda")
    torch.cuda.synchronize()
    # (d) the parameter count at the 448-row table
    n_params = sum(p.numel() for p in net.parameters())
    emit({"lm_encdec": "init", "arch": cfg.name,
          "decoder_layers": cfg.num_layers,
          "encoder_layers": cfg.num_encoder_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "act": cfg.act,
          "gated": cfg.gated_mlp, "vocab": cfg.vocab_size,
          "tied": cfg.tie_embeddings, "frames": cfg.encoder_seq,
          "pos_dec_rows": net.pos_dec.shape[0], "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "params_reference": ENCDEC_PARAMS,
          "params_equal": n_params == ENCDEC_PARAMS,
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    if n_params != ENCDEC_PARAMS or net.pos_dec.shape[0] != ENCDEC_ROWS:
        raise AssertionError(f"lm_encdec: {n_params} parameters with a "
                             f"{net.pos_dec.shape[0]}-row table, the "
                             f"reference holds {ENCDEC_PARAMS} at "
                             f"{ENCDEC_ROWS}")

    def cache_bytes(cache, slots):
        got = {k: (tuple(v.shape), str(v.dtype)) for k, v in
               cache["layers"].items()}
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kv = ((L, B, slots, K, hd), "torch.bfloat16")
        xkv = ((L, B, cfg.encoder_seq, K, hd), "torch.bfloat16")
        want = {"k": kv, "v": kv, "pos": ((L, slots), "torch.int32"),
                "xk": xkv, "xv": xkv}
        if got != want or set(cache) != {"layers"}:
            raise AssertionError(f"lm_encdec: the cache holds {got}, not "
                                 f"{want}")
        return {k: _cache_bytes(cache, (k,)) for k in want}

    # (a) bf16 generate: the prompt and the new tokens fill the table
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                         dtype=torch_dtype(cfg.compute_dtype), device="cuda")
    extra = {"frames": frames}
    serve_lib.generate(cfg, net, prompts[:, :16], 2, extra=extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, net, prompts, n, extra=extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["lm_encdec"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    enc_ms = []
    for _ in range(3):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        enc_out = transformer._encode(net, frames, cfg)
        ev1.record()
        torch.cuda.synchronize()
        enc_ms.append(ev0.elapsed_time(ev1))
    del enc_out
    # generate's n - 1 decode steps; the cache then holds the table's rows
    pre_ms, decode_ms, logits, cache, tok, idx = _timed_steps(
        net, cfg, prompts, n - 1, extra)
    slots = S + n
    by_entry = cache_bytes(cache, slots)
    cross_before = [cache["layers"][k].clone() for k in ("xk", "xv")]
    decode = steps.make_decode_step(cfg)
    with _ranges([(transformer, "_cross_block", "cross_block")]):
        if any(_profile("lm_encdec decode step",
                        lambda: decode(net, tok, cache, idx),
                        ("cross_block",)).values()):
            raise AssertionError("lm_encdec decode step: the profiler saw "
                                 "hand kernels")
    traced = RECORDS[-1]
    cross_kept = all(torch.equal(cache["layers"][k], t) for k, t in
                     zip(("xk", "xv"), cross_before))
    del cross_before
    cross_ms = traced["block_device_ms"]["cross_block"]
    ok_toks = (toks.shape == (B, n) and int(toks.min()) >= 0
               and int(toks.max()) < cfg.vocab_size)
    emit({"lm_encdec": "serve/bf16", "arch": cfg.name, "batch": B,
          "prompt": S, "gen": n, "frames": cfg.encoder_seq,
          "wall_s": wall, "tokens_per_s": B * n / wall,
          "encoder_ms": sorted(enc_ms)[1], "encoder_ms_all": enc_ms,
          "prefill_ms": sorted(pre_ms)[1], "prefill_ms_all": pre_ms,
          "decode_ms_per_token": decode_ms,
          "decode_tokens_per_s": B * 1e3 / decode_ms,
          "decode_traced_at": idx,
          "decode_device_busy_share": traced["device_busy_share"],
          "decode_device_launches": traced["device_launches"],
          "decode_device_ms": traced["device_busy_s"] * 1e3,
          "decode_cross_blocks_device_ms": cross_ms,
          "decode_rest_device_ms": traced["device_busy_s"] * 1e3 - cross_ms,
          "decode_block_calls": traced["block_calls"],
          "cache_slots": slots, "cache_bytes": by_entry,
          "cache_bytes_total": sum(by_entry.values()),
          "not_rewritten_by_decode_bytes": by_entry["xk"] + by_entry["xv"],
          "cross_cache_unchanged_by_decode": cross_kept,
          "peak_gb": peak, "launches": launches, "tokens_ok": ok_toks,
          "sample": toks[0, :8].tolist()})
    if not ok_toks or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_encdec: tokens {tuple(toks.shape)} or "
                             f"logits out of range")
    if any(launches.values()):
        raise AssertionError(f"lm_encdec launched hand kernels: {launches}")
    if traced["block_calls"] != {"cross_block": cfg.num_layers}:
        raise AssertionError(f"lm_encdec: the traced decode step ran "
                             f"{traced['block_calls']} cross blocks, not "
                             f"{cfg.num_layers}")
    if not cross_kept:
        raise AssertionError("lm_encdec: a decode step rewrote xk/xv")
    del cache, logits

    # (b) fp32, batch 2, the same frames: decode against prefill
    cfg32 = cfg.replace(compute_dtype="float32")
    B32 = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checks = _decode_vs_prefill(net, cfg32, prompts[:B32], max(LM_STEPS),
                                LM_STEPS, False, "lm_encdec/fp32",
                                extra={"frames": frames[:B32]})
    emit({"lm_encdec": "decode_vs_prefill/fp32", "batch": B32, "prompt": S,
          "checks": checks, "tol": LM_TOL,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    del net, frames, extra
    torch.cuda.empty_cache()

    # (c) the module's CLI with no --device: full size, on the card
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        toks = serve_lib.main(["--arch", ENCDEC_ARCH, "--batch", "2",
                               "--prompt-len", "64", "--gen", "4"])
    emit({"lm_encdec": "cli", "argv": f"--arch {ENCDEC_ARCH} --batch 2 "
          "--prompt-len 64 --gen 4", "device": str(toks.device),
          "printed": out.getvalue().strip(),
          "seconds": time.perf_counter() - t0})
    if toks.device.type != "cuda" or tuple(toks.shape) != (2, 4) or \
            "generated (2, 4) on cuda" not in out.getvalue():
        raise AssertionError(f"lm_encdec: the CLI gave {tuple(toks.shape)} "
                             f"on {toks.device}: {out.getvalue()!r}")
    del toks
    torch.cuda.empty_cache()
    emit({"phase": "lm_encdec", "seconds": time.perf_counter() - phase_t0})


def _train_batch(vocab: int, B: int, S: int, gen) -> dict:
    """B rows of S tokens and their next-token targets, cut from one
    seeded stream of S + 1 (the reference's ``token_batch`` layout), on
    the generator's device."""
    stream = torch.randint(0, vocab, (B, S + 1), generator=gen,
                           dtype=torch.int32, device=gen.device)
    return {"tokens": stream[:, :-1], "targets": stream[:, 1:]}


def _train_parity(cfg) -> dict:
    """Phase 21 (b): one fp32 train step at full width cut to
    TRAIN_PARITY's layers, on the card and on the CPU from the same
    weights and batch: the loss and every gradient leaf (a forward and
    backward before the step), then the step's loss, grad_norm and
    parameters."""
    import copy

    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.train import steps

    p = TRAIN_PARITY
    cfg32 = cfg.replace(num_layers=p["layers"], compute_dtype="float32")
    nets = {"cpu": model_lib.init_params(cfg32, 1, device="cpu")}
    nets["cuda"] = copy.deepcopy(nets["cpu"]).to("cuda")
    batch = _train_batch(cfg.vocab_size, p["batch"], p["seq"],
                         torch.Generator().manual_seed(2))
    batches = {"cpu": batch, "cuda": {k: v.to("cuda")
                                      for k, v in batch.items()}}
    out = {}
    for dev in ("cpu", "cuda"):
        net = nets[dev]
        _, loss = transformer.forward_train(net, batches[dev], cfg32)
        loss.backward()
        grads = {n: q.grad.detach().cpu()
                 for n, q in transformer.named_leaves(net).items()}
        net.zero_grad(set_to_none=True)
        state = {"params": net, "opt": steps.make_optimizer(TRAIN_LR).init(
            transformer.named_leaves(net))}
        _, m = steps.make_train_step(cfg32, lr=TRAIN_LR)(state,
                                                         batches[dev])
        out[dev] = (float(loss.detach()), grads, float(m["loss"]),
                    float(m["grad_norm"]))
    (loss_c, g_c, sl_c, gn_c), (loss_g, g_g, sl_g, gn_g) = (
        out["cpu"], out["cuda"])
    grad_errs = {n: float((g_g[n] - g).abs().max()
                          / max(float(g.abs().max()), 1e-30))
                 for n, g in g_c.items()}
    worst = max(grad_errs, key=grad_errs.get)
    d = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                   for a, b in zip(nets["cuda"].parameters(),
                                   nets["cpu"].parameters(), strict=True)])
    rec = {"layers": p["layers"], "batch": p["batch"], "seq": p["seq"],
           "loss": {"cuda": loss_g, "cpu": loss_c},
           "step_loss": {"cuda": sl_g, "cpu": sl_c},
           "grad_norm": {"cuda": gn_g, "cpu": gn_c},
           "grad_leaves": len(grad_errs),
           "grad_max_rel_err": grad_errs[worst], "grad_worst_leaf": worst,
           "param_max_diff_lr": float(d.max()) / TRAIN_LR,
           "param_frac_past_lr_100": float((d > TRAIN_LR / 100).double()
                                           .mean()),
           "tol": {"rtol": TRAIN_RTOL, "grad": TRAIN_GRAD_TOL,
                   "param_lr": 2, "far_fraction": TRAIN_FAR_FRACTION}}
    ok = (abs(loss_g - loss_c) <= TRAIN_RTOL * abs(loss_c)
          and abs(sl_g - sl_c) <= TRAIN_RTOL * abs(sl_c)
          and abs(gn_g - gn_c) <= TRAIN_RTOL * abs(gn_c)
          and grad_errs[worst] <= TRAIN_GRAD_TOL
          and rec["param_max_diff_lr"] <= 2
          and rec["param_frac_past_lr_100"] <= TRAIN_FAR_FRACTION)
    rec["ok"] = ok
    if not ok:
        emit({"lm_train": "parity/fp32", **rec})
        raise AssertionError(f"lm_train: the fp32 step on the card is out "
                             f"of bounds of the CPU's: {rec}")
    return rec


def lm_train(by_path: dict) -> None:
    """Phase 21: qwen2-0.5b at full size through the allreduce train step
    (bf16, remat, microbatches) on one fixed batch, then fp32 parity with
    the CPU at 2 layers, then the chunked loss."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    a = TRAIN
    B, S, mb = a["batch"], a["seq"], a["microbatch"]
    tokens = B * S

    def fresh(c):
        """The train state and the batch, drawn from seed 0 in order."""
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = steps.make_train_state(c, gen, lr=TRAIN_LR, device="cuda")
        return state, _train_batch(c.vocab_size, B, S, gen)

    def timed(step, state, batch):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        state, m = step(state, batch)
        ev1.record()
        ev1.synchronize()
        return state, m, ev0.elapsed_time(ev1)

    # (a) the full-size step on one fixed batch
    t0 = time.perf_counter()
    state, batch = fresh(cfg)
    torch.cuda.synchronize()
    net = state["params"]
    n_params = sum(q.numel() for q in net.parameters())
    emit({"lm_train": "init", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "tied": cfg.tie_embeddings, "qkv_bias": cfg.qkv_bias,
          "remat": cfg.remat, "compute_dtype": cfg.compute_dtype,
          "params": n_params, "param_count_cfg": cfg.param_count(),
          "init_s": time.perf_counter() - t0,
          "state_gb": torch.cuda.memory_allocated() / 1e9})
    if not cfg.remat:
        raise AssertionError("lm_train: the config's remat is off")
    step = steps.make_train_step(cfg, lr=TRAIN_LR, microbatch=mb)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, ms = [], [], []
    for _ in range(a["warmup"] + a["steps"]):
        state, m, t = timed(step, state, batch)
        ms.append(t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    by_path["lm_train"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sorted(ms[a["warmup"]:])[a["steps"] // 2]
    seen = _trace_device("lm_train step", lambda: step(state, batch))
    traced = RECORDS[-1]
    falls = losses[-1] < losses[0]
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    emit({"lm_train": "steps/bf16", "batch": B, "seq": S,
          "microbatch": mb, "global_batch_reference": 256,
          "tokens_per_step": tokens, "losses": losses, "grad_norms": norms,
          "first_step_ms": ms[0], "step_ms": step_ms,
          "step_ms_timed": ms[a["warmup"]:],
          "tokens_per_s": tokens / (step_ms / 1e3),
          "model_tflop_s": tflop_s(6 * n_params * tokens, step_ms),
          "model_flops_per_step": 6 * n_params * tokens,
          "params": n_params, "peak_gb": peak,
          "device_busy_share": traced["device_busy_share"],
          "device_launches": traced["device_launches"],
          "device_busy_ms": traced["device_busy_s"] * 1e3,
          "launches": launches, "loss_falls": falls})
    if not finite or not falls:
        raise AssertionError(f"lm_train: losses {losses}, grad norms "
                             f"{norms}")
    if any(launches.values()) or any(seen.values()):
        raise AssertionError(f"lm_train launched hand kernels: {launches} "
                             f"{seen}")
    first_batch = batch["tokens"].clone()
    # no empty_cache before (c): its step reuses the blocks (a)'s steps
    # left in the allocator's cache
    del state, net, step, batch, m

    # (b) fp32 parity with the CPU at full width, 2 layers
    t0 = time.perf_counter()
    rec = _train_parity(cfg)
    emit({"lm_train": "parity/fp32", **rec,
          "seconds": time.perf_counter() - t0})

    # (c) (a)'s first step with the chunked loss
    cfgc = cfg.replace(chunked_ce=True)
    state, batch = fresh(cfgc)
    if not torch.equal(batch["tokens"], first_batch):
        raise AssertionError("lm_train: (c) drew another batch than (a)")
    torch.cuda.reset_peak_memory_stats()
    stepc = steps.make_train_step(cfgc, lr=TRAIN_LR, microbatch=mb)
    state, m, t = timed(stepc, state, batch)
    loss_c = float(m["loss"])
    gap = abs(loss_c - losses[0])
    emit({"lm_train": "chunked_ce/bf16", "loss": loss_c,
          "loss_unchunked": losses[0], "abs_diff": gap,
          "rtol": TRAIN_CHUNKED_RTOL, "grad_norm": float(m["grad_norm"]),
          "grad_norm_unchunked": norms[0], "first_step_ms": t,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "peak_gb_unchunked": peak})
    if not gap <= TRAIN_CHUNKED_RTOL * abs(losses[0]):
        raise AssertionError(f"lm_train: the chunked loss {loss_c} is "
                             f"{gap} off the full loss {losses[0]}")
    del state, batch, m, stepc
    torch.cuda.empty_cache()
    emit({"phase": "lm_train", "seconds": time.perf_counter() - phase_t0})


def _desync(state, gen) -> None:
    """Scale every replica's parameters by (1 + 0.05 N(0, 1)), drawn per
    element from ``gen`` in leaf order (tests/test_dist.py:68-72)."""
    with torch.no_grad():
        for p in state.params.values():
            p.mul_(torch.randn(p.shape, generator=gen, device=p.device)
                   .mul_(0.05).add_(1.0))


def _cons_parity(cfg) -> dict:
    """Phase 22 (b): one fp32 consensus step at full width cut to
    CONS_PARITY's layers on the card and on the CPU from the same stacked
    state and batch: the loss, grad_norm and gap, the dual, both moments
    (mu is (1 - b1) x the augmented gradient after one step) per leaf and
    the parameters."""
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.train import steps

    p = CONS_PARITY
    R = p["replicas"]
    cfg32 = cfg.replace(num_layers=p["layers"], compute_dtype="float32")
    # drawn on the card and copied to the host: the CPU's share of the
    # phase is its step alone
    gen = torch.Generator(device="cuda").manual_seed(1)
    card = steps.make_consensus_train_state(cfg32, gen, R, lr=TRAIN_LR,
                                            device="cuda")
    _desync(card, gen)
    move = lambda m: {n: t.cpu() for n, t in m.items()}
    cpu = card._replace(params=move(card.params), dual=move(card.dual),
                        opt=card.opt._replace(step=card.opt.step.cpu(),
                                              mu=move(card.opt.mu),
                                              nu=move(card.opt.nu)),
                        step=card.step.clone())
    batch = _train_batch(cfg.vocab_size, p["batch"], p["seq"], gen)
    step = steps.make_consensus_train_step(
        cfg32, R, ConsensusConfig(eta=p["eta"]), lr=TRAIN_LR)
    out = {}
    for dev, st in (("cuda", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        st, m = step(st, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (st, {k: float(v) for k, v in m.items()},
                    time.perf_counter() - t0)
    (sg, mg, sec_g), (sc, mc, sec_c) = out["cuda"], out["cpu"]

    def leaf_err(a, b):
        # the CPU's leaves copied to the card, compared there
        errs = {}
        for n, t in b.items():
            t = t.to(a[n].device)
            errs[n] = float((a[n] - t).abs().max()
                            / max(float(t.abs().max()), 1e-30))
        worst = max(errs, key=errs.get)
        return errs[worst], worst
    d = torch.cat([(sg.params[n] - t.to(sg.params[n].device)).abs()
                   .reshape(-1) for n, t in sc.params.items()])
    rec = {"layers": p["layers"], "replicas": R, "batch": p["batch"],
           "seq": p["seq"], "eta": p["eta"],
           "metrics": {"cuda": mg, "cpu": mc},
           "step_s": {"cuda": sec_g, "cpu": sec_c},
           "param_max_diff_lr": float(d.max()) / TRAIN_LR,
           "param_frac_past_lr_100": float((d > TRAIN_LR / 100).double()
                                           .mean()),
           "tol": {"rtol": TRAIN_RTOL, "grad": TRAIN_GRAD_TOL,
                   "param_lr": 2, "far_fraction": TRAIN_FAR_FRACTION}}
    for part, a, b in (("dual", sg.dual, sc.dual),
                       ("mu", sg.opt.mu, sc.opt.mu),
                       ("nu", sg.opt.nu, sc.opt.nu)):
        rec[part + "_max_rel_err"], rec[part + "_worst_leaf"] = leaf_err(a, b)
    ok = (all(abs(mg[k] - mc[k]) <= TRAIN_RTOL * abs(mc[k]) for k in mc)
          and all(rec[part + "_max_rel_err"] <= TRAIN_GRAD_TOL
                  for part in ("dual", "mu", "nu"))
          and rec["param_max_diff_lr"] <= 2
          and rec["param_frac_past_lr_100"] <= TRAIN_FAR_FRACTION
          and torch.equal(sg.opt.step.cpu(), sc.opt.step)
          and int(sg.step) == int(sc.step) == 1)
    rec["ok"] = ok
    if not ok:
        emit({"lm_consensus": "parity/fp32", **rec})
        raise AssertionError(f"lm_consensus: the fp32 step on the card is "
                             f"out of bounds of the CPU's: {rec}")
    return rec


def _cons_regime() -> dict:
    """Phase 22 (c): tests/test_dist.py:48-113 on the card."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.train import steps

    c = CONS_REGIME
    R = c["replicas"]
    rcfg = get_reduced_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = steps.make_consensus_train_state(rcfg, gen, R, lr=c["lr"],
                                             device="cuda")
    _desync(state, gen)
    batch = _train_batch(rcfg.vocab_size, c["batch"], c["seq"], gen)
    step = steps.make_consensus_train_step(
        rcfg, R, consensus_lib.ConsensusConfig(eta=c["eta"], every=1),
        lr=c["lr"])
    losses, gaps = [], []
    for _ in range(c["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gaps.append(float(m["consensus_gap"]))
    state = steps.make_consensus_train_state(rcfg, gen, R, lr=c["every_lr"],
                                             device="cuda")
    batch = _train_batch(rcfg.vocab_size, c["every_batch"], c["every_seq"],
                         gen)
    step = steps.make_consensus_train_step(
        rcfg, R, consensus_lib.ConsensusConfig(eta=c["eta"],
                                               every=c["every"]),
        lr=c["every_lr"])
    for _ in range(c["every_steps"]):
        state, _ = step(state, batch)
    rec = {"arch": rcfg.name, "layers": rcfg.num_layers,
           "d_model": rcfg.d_model, "compute_dtype": rcfg.compute_dtype,
           "losses": losses, "gaps": gaps, "every": c["every"],
           "every_final_step": int(state.step),
           "every_opt_steps": state.opt.step.tolist()}
    if not (losses[-1] < losses[0] and gaps[-1] < gaps[0]
            and all(np.isfinite(losses + gaps))
            and int(state.step) == c["every_steps"]):
        emit({"lm_consensus": "regime", **rec})
        raise AssertionError(f"lm_consensus: the reference's regime "
                             f"failed: {rec}")
    return rec


def lm_consensus(by_path: dict) -> None:
    """Phase 22: qwen2-0.5b at full size through the ADMM-consensus train
    step (R = 4 replicas on the card, bf16, remat) on one fixed batch,
    the round timed alone, then fp32 parity with the CPU at 2 layers,
    then the reference's test regime."""
    from repro_torch.configs import get_config
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.kernels import ops
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    a = CONS
    cfg = get_config(TRAIN_ARCH).replace(chunked_ce=a["chunked_ce"])
    R, B, S = a["replicas"], a["batch"], a["seq"]
    tokens = B * S
    if not cfg.remat:
        raise AssertionError("lm_consensus: the config's remat is off")

    # (a) the full-size step on one fixed batch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = steps.make_consensus_train_state(cfg, gen, R, lr=TRAIN_LR,
                                             device="cuda")
    _desync(state, gen)
    batch = _train_batch(cfg.vocab_size, B, S, gen)
    torch.cuda.synchronize()
    n_params = sum(p[0].numel() for p in state.params.values())
    state_gb = torch.cuda.memory_allocated() / 1e9
    gaps0 = consensus_lib.consensus_gap(state.params)
    emit({"lm_consensus": "init", "arch": cfg.name, "replicas": R,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params_per_replica": n_params,
          "state_leaves": len(state.params),
          "init_s": time.perf_counter() - t0, "state_gb": state_gb,
          "gap_max_init": float(gaps0.max())})
    ccfg = consensus_lib.ConsensusConfig(eta=a["eta"], every=a["every"])
    step = steps.make_consensus_train_step(cfg, R, ccfg, lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, gaps, gap_max, ms = [], [], [], [], []
    for _ in range(a["warmup"] + a["steps"]):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        state, m = step(state, batch)
        ev1.record()
        ev1.synchronize()
        ms.append(ev0.elapsed_time(ev1))
        per_replica = consensus_lib.consensus_gap(state.params)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        gaps.append(float(m["consensus_gap"]))
        gap_max.append(float(per_replica.max()))
        if gaps[-1] != float(per_replica[0]):
            raise AssertionError("lm_consensus: the step's gap is not "
                                 "replica 0's")
    by_path["lm_consensus"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the round alone, as the step runs it, on the live stacks and a
    # gradient stack (the dual's entries are replaced, not written)
    grads = {n: torch.randn(p.shape, generator=gen, device="cuda")
             for n, p in state.params.items()}
    round_ms = []
    for _ in range(CONS_ROUND_REPS):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        steps.consensus_exchange(dict(grads), state.params,
                                 dict(state.dual), state.step, ccfg)
        ev1.record()
        ev1.synchronize()
        round_ms.append(ev0.elapsed_time(ev1))
    # each leaf of p, g and beta read once, g and beta written once
    round_bytes = 5 * 4 * R * n_params
    del grads
    step_ms = sorted(ms[a["warmup"]:])[a["steps"] // 2]
    falls = losses[-1] < losses[0]
    finite = all(np.isfinite(losses + norms + gaps + gap_max))
    emit({"lm_consensus": "steps/bf16", "replicas": R, "batch": B,
          "seq": S, "rows_per_replica": B // R, "eta": a["eta"],
          "every": a["every"], "lr": TRAIN_LR, "tokens_per_step": tokens,
          "losses": losses, "grad_norms_replica0": norms,
          "gaps_replica0": gaps, "gaps_max_v": gap_max,
          "first_step_ms": ms[0], "step_ms": step_ms,
          "step_ms_timed": ms[a["warmup"]:],
          "tokens_per_s": tokens / (step_ms / 1e3),
          "model_tflop_s": tflop_s(6 * n_params * tokens, step_ms),
          "params_per_replica": n_params, "state_gb": state_gb,
          "peak_gb": peak, "chunked_ce": cfg.chunked_ce,
          "round_device_ms": sorted(round_ms)[CONS_ROUND_REPS // 2],
          "round_device_ms_all": round_ms,
          "round_bytes": round_bytes,
          "round_bound_ms": 1e3 * round_bytes / HBM_BYTES_S,
          "launches": launches, "loss_falls": falls})
    if not finite or not falls:
        raise AssertionError(f"lm_consensus: losses {losses}, grad norms "
                             f"{norms}, gaps {gaps} / {gap_max}")
    if any(launches.values()):
        raise AssertionError(f"lm_consensus launched hand kernels: "
                             f"{launches}")
    del state, step, batch, m, per_replica
    torch.cuda.empty_cache()

    # (b) fp32 parity with the CPU at full width, 2 layers
    t0 = time.perf_counter()
    rec = _cons_parity(get_config(TRAIN_ARCH))
    emit({"lm_consensus": "parity/fp32", **rec,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # (c) the reference's test regime
    t0 = time.perf_counter()
    rec = _cons_regime()
    emit({"lm_consensus": "regime", **rec,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    emit({"phase": "lm_consensus",
          "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 23: the training CLI
@contextlib.contextmanager
def _patched(*triples):
    """``(object, attribute, value)`` set for the block, then restored."""
    from unittest import mock

    with contextlib.ExitStack() as stack:
        for obj, name, value in triples:
            stack.enter_context(mock.patch.object(obj, name, value))
        yield


class _RssPeak:
    """The process's largest resident set while the block runs, sampled
    from /proc/self/status every 20 ms by a thread."""

    def __enter__(self):
        import threading

        self.peak, self._stop = self.now(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def now() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())


def _cli(argv, on_restore=None) -> dict:
    """``launch.train.main(argv)`` with its stdout caught, each step's
    metrics and CUDA-event ms (on the card) caught at the step function,
    and the seconds of each save (the host copy of the state and the
    file) and of the restore (the file and the re-seat); ``on_restore``
    sees the state just re-seated."""
    from repro_torch import convert
    from repro_torch.launch import train

    rec = {"metrics": [], "step_ms": [], "save_s": [], "to_numpy_s": [],
           "restore_s": [], "reseat_s": []}
    real = {k: getattr(train, k) for k in ("save_step", "restore_latest")}
    to_numpy = convert.train_state_to_numpy
    make_step = train.steps_lib.make_consensus_train_step
    make_train = train.steps_lib.make_train_step
    reseat = convert.restore_train_state_

    def timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec[key].append(time.perf_counter() - t0)
            return out
        return call

    def wrap(make):
        def factory(*a, **k):
            fn = make(*a, **k)

            def step(state, batch):
                card = batch["tokens"].is_cuda
                if card:
                    ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
                    ev0.record()
                state, m = fn(state, batch)
                if card:
                    ev1.record()
                    ev1.synchronize()
                    rec["step_ms"].append(ev0.elapsed_time(ev1))
                rec["metrics"].append({k: float(v) for k, v in m.items()})
                return state, m
            return step
        return factory

    def restore(state, tree):
        t0 = time.perf_counter()
        state = reseat(state, tree)
        rec["reseat_s"].append(time.perf_counter() - t0)
        if on_restore is not None:
            on_restore(state)
        return state

    out = io.StringIO()
    with _patched((train, "save_step", timed("save_s", real["save_step"])),
                  (train, "restore_latest",
                   timed("restore_s", real["restore_latest"])),
                  (convert, "train_state_to_numpy",
                   timed("to_numpy_s", to_numpy)),
                  (train.steps_lib, "make_consensus_train_step",
                   wrap(make_step)),
                  (train.steps_lib, "make_train_step", wrap(make_train)),
                  (convert, "restore_train_state_", restore)), \
            contextlib.redirect_stdout(out):
        rec["state"] = train.main(argv)
    rec["lines"] = out.getvalue().splitlines()
    return rec


def _state_tensors(state):
    """Every tensor of a train state by a name, allreduce or consensus."""
    if isinstance(state, dict):
        from repro_torch.models import transformer
        params = transformer.named_leaves(state["params"])
        opt = state["opt"]
        parts = {"params": params, "mu": opt.mu, "nu": opt.nu}
        out = {"opt.step": opt.step}
    else:
        parts = {"params": state.params, "mu": state.opt.mu,
                 "nu": state.opt.nu, "dual": state.dual}
        out = {"opt.step": state.opt.step, "step": state.step}
    for part, m in parts.items():
        out.update({f"{part}/{n}": t for n, t in m.items()})
    return out


def _file_bounds(a_path: str, b_path: str, steps_taken: int) -> dict:
    """Two train-state checkpoint files (the card's ``a``, the CPU's
    ``b``) held to phase 22(b)'s bounds: the same tree and step counters,
    the gradient-derived leaves (moments, dual) within TRAIN_GRAD_TOL of
    each leaf's largest magnitude, the parameters within 2 lr a step and
    at most TRAIN_FAR_FRACTION of them past lr / 100."""
    from repro_torch.checkpoint import load

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, path + (i,))
        else:
            yield path, np.asarray(tree)

    a, b = list(walk(load(a_path))), list(walk(load(b_path)))
    same_tree = [(p, x.dtype, x.shape) for p, x in a] == \
        [(p, x.dtype, x.shape) for p, x in b]
    consensus = isinstance(a[0][0][0], int)
    errs, diffs, steps_equal = {}, [], True
    for (path, x), (_, y) in zip(a, b):
        kind = ({0: "params", 2: "dual", 3: "step"}.get(path[0])
                if consensus else
                ("params" if path[0] == "params" else None)) \
            or {0: "step", 1: "mu", 2: "nu"}[path[1]]
        if kind == "step":
            steps_equal &= bool(np.array_equal(x, y))
        elif kind == "params":
            diffs.append(np.abs(x.astype(np.float64) - y).reshape(-1))
        else:
            err = float(np.abs(x.astype(np.float64) - y).max()
                        / max(float(np.abs(y).max()), 1e-30))
            errs[kind] = max(errs.get(kind, 0.0), err)
    d = np.concatenate(diffs)
    rec = {"same_tree": same_tree, "steps_equal": steps_equal,
           "leaves": len(a), "max_rel_err": errs,
           "param_max_diff_lr": float(d.max()) / TRAIN_LR,
           "param_frac_past_lr_100": float((d > TRAIN_LR / 100).mean())}
    rec["ok"] = (same_tree and steps_equal
                 and all(e <= TRAIN_GRAD_TOL for e in errs.values())
                 and rec["param_max_diff_lr"] <= 2 * steps_taken
                 and rec["param_frac_past_lr_100"] <= TRAIN_FAR_FRACTION)
    return rec


def _launch_parity(tmp: str) -> None:
    """Phase 23 (b): per LAUNCH_PARITY_RUNS, fp32, the card writes step
    ``write``; the card and the CPU each resume a copy to ``resume``."""
    import shutil

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train

    p = LAUNCH_PARITY
    fp32 = lambda arch: get_reduced_config(arch).replace(
        compute_dtype="float32")
    for label, args in LAUNCH_PARITY_RUNS:
        t0 = time.perf_counter()
        base = [*args, "--reduced", "--batch", str(p["batch"]), "--seq",
                str(p["seq"]), "--log-every", "1", "--ckpt-every", "1000"]
        root = os.path.join(tmp, label.replace("/", "_"))
        runs = {}
        with _patched((train, "get_reduced_config", fp32)):
            _cli([*base, "--steps", str(p["write"]), "--ckpt-dir",
                  os.path.join(root, "written"), "--device", "cuda"])
            for dev in ("cuda", "cpu"):
                d = os.path.join(root, dev)
                shutil.copytree(os.path.join(root, "written"), d)
                runs[dev] = _cli([*base, "--steps", str(p["resume"]),
                                  "--ckpt-dir", d, "--device", dev])
        files = [os.path.join(root, dev, f"ckpt_{p['resume']:08d}.msgpack")
                 for dev in ("cuda", "cpu")]
        rec = _file_bounds(*files, p["resume"] - p["write"])
        mg, mc = runs["cuda"]["metrics"], runs["cpu"]["metrics"]
        metrics_ok = len(mg) == len(mc) == p["resume"] - p["write"] and all(
            abs(g[k] - c[k]) <= TRAIN_RTOL * abs(c[k])
            for g, c in zip(mg, mc) for k in c)
        resumed = all(f"resumed from step {p['write']}" in runs[dev]["lines"]
                      for dev in runs)
        rec.update({"lm_launch": f"parity/fp32/{label}", **p,
                    "metrics": {"cuda": mg, "cpu": mc},
                    "metrics_ok": metrics_ok, "resumed": resumed,
                    "tol": {"rtol": TRAIN_RTOL, "grad": TRAIN_GRAD_TOL,
                            "param_lr_per_step": 2,
                            "far_fraction": TRAIN_FAR_FRACTION},
                    "seconds": time.perf_counter() - t0})
        emit(rec)
        if not (rec["ok"] and metrics_ok and resumed):
            raise AssertionError(f"lm_launch: the card's resume of "
                                 f"{label} is out of bounds of the CPU's")


def lm_launch(by_path: dict) -> None:
    """Phase 23: the training CLI at the reference example's full size
    with one save and a resume, then card against CPU from one file."""
    import resource
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.train import steps

    phase_t0 = time.perf_counter()
    a = LAUNCH
    cfg = get_config(a["arch"])
    B, S = a["batch"], a["seq"]
    tmp = tempfile.mkdtemp(prefix="lm_launch_")
    try:
        d = os.path.join(tmp, "ckpt")
        # the example's argv (examples/train_lm_consensus.py), logging
        # every step, and a checkpoint directory
        argv = ["--arch", a["arch"], "--trainer", "admm", "--mesh",
                a["mesh"], "--batch", str(B), "--seq", str(S),
                "--log-every", "1", "--ckpt-dir", d, "--ckpt-every",
                str(a["ckpt_every"]), "--seed", str(a["seed"])]
        rss0 = _RssPeak.now()
        free_gb = shutil.disk_usage(tmp).free / 1e9
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            run1 = _cli([*argv, "--steps", str(a["steps"])])
            run1_s = time.perf_counter() - t0
            state1 = run1.pop("state")
            torch.cuda.synchronize()
            state_gb = torch.cuda.memory_allocated() / 1e9
            latest1 = checkpoint.latest_step(d)
            path6 = os.path.join(d, f"ckpt_{a['steps']:08d}.msgpack")
            file_bytes = os.path.getsize(path6)
            saved = _state_tensors(state1)
            checked = {}

            def same_as_saved(st):
                got = _state_tensors(st)
                checked["names"] = sorted(got) == sorted(saved)
                checked["bitwise"] = checked["names"] and all(
                    t.dtype == saved[n].dtype
                    and torch.equal(t, saved[n].to(t.device))
                    for n, t in got.items())

            t0 = time.perf_counter()
            run2 = _cli([*argv, "--steps", str(a["resume"])],
                        on_restore=same_as_saved)
            run2_s = time.perf_counter() - t0
            del run2["state"]
        by_path["lm_launch"] = launches = ops.launch_counts()
        latest2 = checkpoint.latest_step(d)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the saved state continued in process over the stream's first
        # two batches (the resume restarts the data key at seed + 1)
        step = steps.make_consensus_train_step(
            cfg, a["replicas"], ConsensusConfig(eta=a["eta"], every=1),
            lr=TRAIN_LR)
        stream = token_stream(a["seed"] + 1, cfg.vocab_size, B, S,
                              device="cuda")
        cont = []
        for _ in range(a["resume"] - a["steps"]):
            state1, m = step(state1, next(stream))
            cont.append({k: float(v) for k, v in m.items()})
        del state1, step, m
        resumed = [m["loss"] for m in run2["metrics"]]
        loss_gap = max(abs(r - c["loss"]) / abs(c["loss"])
                       for r, c in zip(resumed, cont))
        n_params = sum(t.numel() for n, t in saved.items()
                       if n.startswith("params/")) // a["replicas"]
        del saved
        torch.cuda.empty_cache()

        step_ms = float(np.median(run1["step_ms"]))
        metrics = [v for r in (run1, run2) for m in r["metrics"]
                   for v in m.values()]
        numbers = [step_ms, state_gb, peak_gb, *run1["save_s"],
                   *run1["to_numpy_s"], *run2["restore_s"],
                   *run2["reseat_s"], *run2["save_s"]]
        rec = {"lm_launch": "example/admm", "arch": cfg.name,
               "argv": argv, "replicas": a["replicas"],
               "model_axis_unused": any("unused" in line
                                        for line in run1["lines"]),
               "params_per_replica": n_params,
               "param_count_cfg": cfg.param_count(),
               "steps": a["steps"], "resume_to": a["resume"],
               "lines_run1": run1["lines"], "lines_run2": run2["lines"],
               "metrics_run1": run1["metrics"],
               "metrics_run2": run2["metrics"],
               "continuation_in_process": cont,
               "loss_max_rel_gap": loss_gap, "loss_rtol": LAUNCH_LOSS_RTOL,
               "step_ms": step_ms, "step_ms_all": run1["step_ms"],
               "step_ms_resumed": run2["step_ms"],
               "tokens_per_step": B * S,
               "tokens_per_s": B * S / (step_ms / 1e3),
               "state_gb": state_gb, "peak_gb": peak_gb,
               "file_bytes": file_bytes,
               "save_s": [x + y for x, y in zip(run1["to_numpy_s"],
                                                run1["save_s"])],
               "save_host_copy_s": run1["to_numpy_s"],
               "save_file_s": run1["save_s"],
               "restore_s": [x + y for x, y in zip(run2["restore_s"],
                                                   run2["reseat_s"])],
               "restore_file_s": run2["restore_s"],
               "restore_reseat_s": run2["reseat_s"],
               "resume_save_s": run2["save_s"],
               "run1_s": run1_s, "run2_s": run2_s,
               "tmp_free_gb_before": free_gb,
               "host_rss_gb_before": rss0 / 1e9,
               "host_rss_peak_gb": rss.peak / 1e9,
               "host_maxrss_gb_process": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
               "latest_step": [latest1, latest2],
               "restored_bitwise": checked.get("bitwise", False),
               "launches": launches}
        emit(rec)
        gates = {
            "finite": bool(np.all(np.isfinite(metrics + numbers))),
            "latest": [latest1, latest2] == [a["steps"], a["resume"]],
            "resumed": f"resumed from step {a['steps']}" in run2["lines"],
            "one_save_then_one": len(run1["save_s"]) == 1
            and len(run2["save_s"]) == 1,
            "restored_bitwise": rec["restored_bitwise"],
            "continuation": loss_gap <= LAUNCH_LOSS_RTOL,
            "no_hand_kernel": not any(launches.values())}
        if not all(gates.values()):
            raise AssertionError(f"lm_launch: gates failed: {gates}")

        # (b) card against CPU from one card-written file, fp32
        _launch_parity(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "lm_launch", "seconds": time.perf_counter() - phase_t0})


# ---------------------------------------------------------------------------
# phase 24: the one-card dry run
def _dryrun_real(cfg, shape, mode: str, replicas: int) -> dict:
    """The step ``dryrun.build`` traces, made from seeded weights and
    inputs on the card and run once for real: its peak above what was
    held before (``max_memory_allocated``), the state's and inputs' bytes
    and the step's ms; then once more under the dry run's byte tracker on
    the real tensors (its peak, from the same arguments again)."""
    import gc

    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    long_mode = model_lib.use_long_mode(cfg, shape)

    def fresh():
        inputs = model_lib.make_inputs(cfg, shape, gen, device="cuda")
        if mode == "admm":
            state = steps.make_consensus_train_state(
                cfg, gen, replicas, shape, device="cuda")
            return (steps.make_consensus_train_step(
                cfg, replicas, long_mode=long_mode), (state, inputs))
        params = model_lib.init_params(cfg, gen, shape, device="cuda")
        return steps.make_prefill_step(cfg, long_mode), (params, inputs)

    step, args = fresh()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args_bytes = torch.cuda.memory_allocated() - held
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    out = step(*args)
    ev1.record()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - held
    finite = bool(all(torch.isfinite(t).all() for t in (
        [out[1]["loss"]] if mode == "admm" else [out[0]])))
    del step, args, out
    step, args = fresh()
    gc.collect()
    torch.cuda.synchronize()
    tracked = dryrun.measure(step, args, "cuda")
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    return {"held_gb": held / 1e9, "real_args_bytes": args_bytes,
            "measured_peak_bytes": measured, "step_ms": ev0.elapsed_time(ev1),
            "finite": finite, "tracked_real": tracked}


def lm_dryrun(by_path: dict) -> None:
    """Phase 24: the dry run's peaks held to the card's, then its CLI over
    every arch at decode_32k."""
    import tempfile

    from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                     shape_applicable)
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import costs, dryrun, mesh
    from repro_torch.models import model as model_lib

    phase_t0 = time.perf_counter()
    ops.reset_launch_counts()
    cfg = get_config(DRYRUN_ARCH)
    ratios = {}
    for name, kind, B, S, mode, R in DRYRUN_CASES:
        t0 = time.perf_counter()
        shape = InputShape(name, S, B, kind)
        pred = dryrun.trace(cfg, shape, mode, R, "cuda")
        real = _dryrun_real(cfg, shape, mode, R)
        ac = costs.step_costs(cfg, shape,
                              long_mode=model_lib.use_long_mode(cfg, shape))
        ratio = pred["peak_bytes"] / real["measured_peak_bytes"]
        ratios[name] = ratio
        tr = real.pop("tracked_real")
        emit({"lm_dryrun": name, "arch": cfg.name, "batch": B, "seq": S,
              "mode": mode, "replicas": R,
              "predicted_peak_gb": pred["peak_bytes"] / 1e9,
              "predicted_args_gb": pred["argument_size_in_bytes"] / 1e9,
              "tracked_real_peak_gb": tr["peak_bytes"] / 1e9,
              "tracked_real_args_gb": tr["argument_size_in_bytes"] / 1e9,
              "measured_peak_gb": real["measured_peak_bytes"] / 1e9,
              "real_args_gb": real["real_args_bytes"] / 1e9,
              "held_before_gb": real["held_gb"],
              "predicted_over_measured": ratio,
              "band": DRYRUN_PEAK_BAND,
              "flops_counted": pred["flops"],
              "flops_tracked_real": tr["flops"],
              "flops_analytic": ac.flops,
              "counted_over_analytic": pred["flops"] / ac.flops,
              "bytes_accessed": pred["bytes_accessed"],
              "trace_s": pred["seconds"],
              "tracked_real_s": tr["seconds"],
              "step_ms": real["step_ms"], "finite": real["finite"],
              "seconds": time.perf_counter() - t0})
        if not real["finite"]:
            raise AssertionError(f"lm_dryrun: {name}'s real step is not "
                                 f"finite")
    # the budget fits reads, after real steps (the context, cuBLAS loaded)
    free, total = torch.cuda.mem_get_info()
    cpu_usable = dryrun.budget(torch.device("cpu"))[1]
    emit({"lm_dryrun": "budget", "total_bytes": total,
          "mesh_hbm_bytes": mesh.HBM_BYTES,
          "outside_allocator_bytes":
              total - free - torch.cuda.memory_reserved(),
          "mesh_context_bytes": mesh.CONTEXT_BYTES,
          "mesh_cublas_workspace_bytes": mesh.CUBLAS_WORKSPACE_BYTES,
          "usable_bytes": dryrun.budget(torch.device("cuda"))[1],
          "cpu_usable_bytes": cpu_usable})

    # (b) the CLI at full size, every arch, on the card (no --device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lm_dryrun_") as tmp:
        path = os.path.join(tmp, "dryrun.jsonl")
        out = io.StringIO()
        failed = None
        try:
            with contextlib.redirect_stdout(out):
                dryrun.main([*DRYRUN_CLI, "--out", path])
        except SystemExit as e:
            failed = str(e)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    cli_s = time.perf_counter() - t0
    shape = SHAPES["decode_32k"]
    wrong = []
    for rec in recs:
        line = {"lm_dryrun": "cli", "arch": rec["arch"],
                "shape": rec["shape"], "mesh": rec["mesh"],
                "status": rec["status"]}
        if rec["status"] == "ok":
            mem = rec["memory"]
            line.update({
                "argument_gb": mem["argument_size_in_bytes"] / 1e9,
                "peak_gb": mem["peak_bytes"] / 1e9,
                "device_gb": mem["device_bytes"] / 1e9,
                "usable_gb": mem["usable_bytes"] / 1e9,
                "fits": mem["fits"],
                "cpu_fits": mem["peak_bytes"] <= cpu_usable,
                "counted_over_analytic": rec["flops"]
                / rec["analytic"]["flops"],
                "trace_s": rec["trace_s"]})
        else:
            line["why"] = rec.get("reason") or rec.get("error")
        emit(line)
        applicable = shape_applicable(get_config(rec["arch"]), shape)[0]
        if rec["status"] != ("ok" if applicable else "skipped"):
            wrong.append((rec["arch"], rec["status"]))
        elif rec["status"] == "ok":
            want = rec["arch"] not in DRYRUN_OVER_CARD
            mem = rec["memory"]
            if rec["arch"] in DRYRUN_OVER_CARD + (DRYRUN_ARCH,) and \
                    mem["fits"] != want:
                wrong.append((rec["arch"], "fits", mem["fits"]))
            if mem["fits"] != (mem["peak_bytes"] <= cpu_usable):
                wrong.append((rec["arch"], "cpu_fits", mem["fits"]))
    by_path["lm_dryrun"] = launches = ops.launch_counts()
    emit({"lm_dryrun": "cli/summary", "argv": DRYRUN_CLI,
          "records": len(recs), "seconds": cli_s, "exit": failed,
          "lines": out.getvalue().splitlines(), "launches": launches})
    gates = {
        "band": all(DRYRUN_PEAK_BAND[0] <= r <= DRYRUN_PEAK_BAND[1]
                    for r in ratios.values()),
        "cli_exit": failed is None,
        "every_arch": sorted(r["arch"] for r in recs) == sorted(ARCHS),
        "statuses_and_fits": not wrong,
        "no_hand_kernel": not any(launches.values())}
    emit({"phase": "lm_dryrun", "seconds": time.perf_counter() - phase_t0})
    if not all(gates.values()):
        raise AssertionError(f"lm_dryrun: gates failed: {gates}; "
                             f"ratios {ratios}; wrong {wrong}; {failed}")


# ---------------------------------------------------------------------------
# phase 2 (continued): the analysis gate on the card
def analysis_gate(ext, dev) -> None:
    """The launch audit held against the built extension (kernel_info's
    static shared bytes and threads, qp_multi_shape at every multi shape,
    f32 and bf16, with and without the fold, and every audited launch
    against the card's limits), the sources' constants and coverage, the
    dispatch audit of the entry points and the launch guard on the card;
    any finding raises."""
    from repro_torch.analysis import launch_audit, linter
    from repro_torch.analysis.dispatch_audit import (audit_entry_points,
                                                     launch_guard)

    t0 = time.perf_counter()
    lint = linter.lint_paths([os.path.join(ROOT, "src", "repro_torch")])
    findings, record = launch_audit.audit_extension(ext, dev)
    findings += launch_audit.audit_constants()
    findings += launch_audit.audit_call_sites()
    findings += audit_entry_points(dev)
    findings += launch_guard(dev)
    findings += [f for f in lint if not f.suppressed]
    emit({"analysis": {
        **record,
        "lint_suppressed": sum(f.suppressed for f in lint),
        "findings": [f.to_dict() for f in findings],
        "seconds": time.perf_counter() - t0}})
    if findings:
        raise AssertionError(f"the analysis gate found {len(findings)} "
                             f"finding(s): {findings[:5]}")


def _timed_phase(name: str, fn, *args):
    """``fn(*args)`` and a ``phase`` record of its seconds, for the phases
    that print none of their own."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": name, "seconds": time.perf_counter() - t0})
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def write_records(out) -> None:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(RECORDS, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every record to this JSON file")
    ap.add_argument("--only", choices=("large_fit", "multi_mid", "figures",
                                       "sessions", "fabric", "store",
                                       "serve", "obs", "dist", "shard",
                                       "lm", "moe", "mla", "ssm",
                                       "hybrid", "encdec", "train",
                                       "consensus", "launch", "dryrun"),
                    help="run only this part, and print no result line")
    ap.add_argument("--figures-cpu", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.figures_cpu:
        return figures_cpu_main(args.figures_cpu)
    try:
        return run(args)
    finally:
        FiguresCpu.stop_all()
        write_records(args.out)     # a failed phase's records too


def run(args) -> int:
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    from repro_torch import device as device_lib
    from repro_torch.kernels import build

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for fp32 matmuls")
    dev = device_lib.resolve("cuda")
    smi = nvidia_smi()
    name, limit = (s.strip() for s in smi.split(",", 1))
    emit({"card": name, "power_limit": limit,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    if args.only:
        build.extension()           # built before any timed region
        if args.only == "large_fit":
            large_fit({})
        elif args.only == "dist":
            dist({})
        elif args.only == "shard":
            shard({}, {k: [] for k in KERNELS})
        elif args.only == "lm":
            lm_serve({})
        elif args.only == "moe":
            lm_moe({})
        elif args.only == "mla":
            lm_mla({})
        elif args.only == "ssm":
            lm_ssm({})
        elif args.only == "hybrid":
            lm_hybrid({})
        elif args.only == "encdec":
            lm_encdec({})
        elif args.only == "train":
            lm_train({})
        elif args.only == "consensus":
            lm_consensus({})
        elif args.only == "launch":
            lm_launch({})
        elif args.only == "dryrun":
            lm_dryrun({})
        elif args.only in ("figures", "sessions", "fabric", "store",
                           "serve", "obs"):
            run = {"figures": figures, "sessions": sessions,
                   "fabric": fabric, "store": store,
                   "serve": serve, "obs": observability}[args.only]
            run({}, {k: 0 for k in PROFILED}, {k: [] for k in KERNELS})
        else:
            multi_mid(dev)
        return 0

    ext = build.extension()
    info = [{"kernel": k, "registers": r, "static_shared_bytes": s,
             "local_bytes": loc, "max_threads": m}
            for k, r, s, loc, m in ext.kernel_info()]
    emit({"build_s": build.build_seconds, "kernel_info": info})
    spills = [i for i in info if i["kernel"].startswith("gram")
              and i["local_bytes"]]
    if spills:
        raise AssertionError(f"Gram kernels with local memory: {spills}")
    analysis_gate(ext, dev)

    cases = _timed_phase("kernels", check_kernels, dev)
    by_path = {}
    _timed_phase("main_path", main_path, by_path)
    _timed_phase("large_fit", large_fit, by_path)
    _timed_phase("large_replan", large_replan, by_path)
    traced = {k: 0 for k in PROFILED}
    _timed_phase("profile_engines", profile_engines, traced)
    _timed_phase("figures", figures, by_path, traced, cases)
    sessions(by_path, traced, cases)
    fabric(by_path, traced, cases)
    store(by_path, traced, cases)
    serve(by_path, traced, cases)
    observability(by_path, traced, cases)
    dist(by_path)
    shard(by_path, cases)
    lm_serve(by_path)
    lm_moe(by_path)
    lm_mla(by_path)
    lm_ssm(by_path)
    lm_hybrid(by_path)
    lm_encdec(by_path)
    lm_train(by_path)
    lm_consensus(by_path)
    lm_launch(by_path)
    lm_dryrun(by_path)
    if not all(traced.values()):
        raise AssertionError(f"the profiler saw none of some kernels: "
                             f"{traced}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 came on during the run")

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        large = [c for c in cases[kname] if c["regime"] == "large"
                 and c.get("precision", "f32") == "f32"
                 and c.get("fold", True)][0]
        per_path = {path: n[kname] for path, n in by_path.items()}
        if not sum(per_path.values()) > 0:
            raise AssertionError(f"{kname} never launched on the main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "profiler_launches": traced.get(kname),
            "max_abs_err": large["max_abs_err"],
            "ms": large["ms"], "plain_ms": large["plain_ms"],
            "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
            "library_ms": large["library_ms"], "cases": cases[kname]})
    emit({"script": "wall", "seconds": time.perf_counter() - script_t0})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
