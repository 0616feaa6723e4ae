#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: FedNL's round
with the paper's six compressors, FedNL-LS and FedNL-PP, the LM zoo's
inference for every family (dense granite-3-2b; moe, ssm, hybrid, vlm and
encdec, the dense chatglm3-6b, nemotron-4-15b and yi-34b, and mixtral-8x22b
with its long_500k ring decode, in the zoo phase), sweeps (solve_many's
batched groups),
sessions (open_session, FNLS1 checkpoints), the wire stack (codecs, frames,
the loopback and TCP star masters) and the topologies above it (trees of
stars, async aggregation, elastic membership, TCP process trees, obs),
the serving engine with its gateway (FedNLServer, GatewayServer), the
sharded backend over torch.distributed, LM training (every family at
full width: at full depth but llava-next-mistral-7b's 12 of 32 layers and
the depth cuts of the configs that do not fit one card, with flash
attention's hand-written backward), and the roofline of every
full-width run
(repro_torch.roofline: counted flops and bytes, mfu).

    python3 chip_smoke.py [--phases train,zoo]

Runs from the root of a checkout; imports ``repro_torch`` from ``src/`` and
nothing of ``repro`` or JAX.  Each phase prints one JSON line; any failure
raises, and the script exits non-zero without the final line.  Without
``--phases`` every phase runs, in the order below; with it the card, the
build and the named phases (PHASES' names: each is the "phase" of its
lines) with those they need (PHASE_NEEDS), a line naming them, and for a
phase that only compares with another's numbers the parts it skipped; no
kernels line, which needs them all.  An unknown name exits 2.  The CPU
side of each card-versus-CPU check at full width (lm, each zoo family's
(a), each train cell's (b)) runs in one spawned CPU process (CpuSide: the
card's params handed over as CUDA IPC handles and copied into the
worker's own memory, the batch beside them; its threads all cores but
CPU_SIDE_SPARE_CORES, this process's the rest meanwhile) while the card
goes on with that cell, and is held to the same bounds before the cell
ends; FedNL's CPU runs of phases 4, 10 (c) and 11 (c), (d) queue in the
same worker and are checked at the end of phase 4, after phase 11 and
after phase 12.  The run line gives each phase's seconds.

  1 card     name, count, power limit (nvidia-smi), torch and CUDA versions
  2 build    nvcc of every kernel source, in parallel; seconds and ptxas report
  3 kernels  each kernel against its plain PyTorch version on the card, at the
             shapes of the main paths: SYRK within 1e-13 of max(|Z|^T|h||Z|),
             TopK bit-exact (u_hat bit patterns and sent) on the first rounds'
             corrections, near-ties, the keys-in-device-memory path and edge k;
             RandSeqK bit-exact on the round's real draws, s = 0, s = T-1, a
             wrapping window, k = 1 and k = T; TopLEK exact (u_hat bits and
             kept) on the all-zero round-0 correction, the round-1 correction,
             near-ties, a dyadic fixture, k = 1, k = T and every memory path,
             but for rows where alpha_m* lies within 1e-12 of k/T or unif of p
             (counted; none allowed on the dyadic fixture); flash attention
             within one bf16 ulp (the ulp taken at no less than 2**-14) at
             granite's 32k layer shape, B = 4, a 4096 window, S = 1000, a
             5-token prompt, non-causal 64 x 256, dh = 128,
             recurrentgemma-2b's 32k layer (dh = 256, H = 10, Kv = 1, causal
             window 2048) and the 32k layers of chatglm3-6b, nemotron-4-15b
             and yi-34b (dh = 128, H/Kv = 32/2, 48/8, 56/8, causal, no
             window) and mixtral-8x22b (H/Kv 48/8, causal window 4096)
             (the wgmma route) and bf16 at dh = 32 (the SIMT
             route), and within 2e-5 in f32 (the SIMT route, dh 64 and
             256) and at one layer of the probe's backbone call (B 512, S
             16, H 32, Kv 8, dh 64, causal) and at S 64, B 64, both on the
             packed grid; each fixture's route checked, and each wgmma
             fixture's grid (flash_fwd_grid on the host equal to the
             launcher's; packed at those two only); SYRK at the probe's (8,
             64, 2,048) and TopLEK at its (8, 2,098,176) with k 16,384 on
             the spread route (memory path 3): Gaussian rows, dyadic rows
             (exact, and the index form), the all-zero correction, near-ties
             and k = 1, and k 32,768 on path 2 (the plan worked out on the
             host, toplek_plan_for, equal to the kernel's at every fixture's
             shape, and its blocks a client, toplek_spread_for); the threefry
             kernel bit-exact in f32 and f64 at (142, 45451), T = 1, one
             client, 1,000 clients at T = 3,000 and 300 at T = 4,097 (a
             head or a tail outside the aligned runs on every row); TopK by
             keys bit-exact on the round's real uniforms, forced ties at the
             k-th key, k = 1 and k = T
  4 main     repro_torch.api.solve on w8a (Option B, hess0="exact") on the
             card, seven paths, the launch counts set to 0 before each and
             read after it: TopK and TopLEK (tol 1e-12, <= 50 rounds),
             RandSeqK, RandK and Natural (30 rounds), FedNL-LS with TopK (tol
             1e-12, <= 50 rounds), FedNL-PP with TopK and tau = 71 (50
             rounds); launch counts, the grad norm falls, and the first 3
             rounds' grad norms (PP: models), sent_bits, LS's steps and PP's
             clients against the same spec on the CPU (plain versions; the
             same threefry draws); then a9a and phishing (OTHER_DATASETS,
             the synthetic generator at their published shapes) with TopK,
             TopLEK (tol 1e-12, <= 50 rounds) and RandSeqK (30 rounds), the
             same checks, rounds, bits a round and ms a round
  5 lm       granite-3-2b at full width: 2 layers (depth cut) on the card
             against the same params on the CPU, prefill B = 2, S = 512 and 4
             decode steps, within LOGIT_ULPS bf16 ulps of the logit scale;
             then 40 layers from seed 0 on the card: make_prefill_step at
             B = 1, S = 32,768 (the repo's prefill_32k shape, its global batch
             of 32 cut to 1), exactly 40 flash launches, all on the wgmma
             route; lm_prefill of a
             5-token prompt against 5 decode steps; ServeEngine with the
             launcher's defaults (6 requests, batch 4, 12 new tokens,
             max_len 128), no kernel launch, the same tokens on a second
             engine and from the launcher
  zoo        (after phase 7, once granite-3-2b's params are freed)
             granite-moe-1b-a400m, mamba2-2.7b, recurrentgemma-2b,
             llava-next-mistral-7b, seamless-m4t-large-v2, chatglm3-6b,
             nemotron-4-15b, yi-34b and mixtral-8x22b at full width, each
             freed before the next: (a) the same params, drawn on the card
             and copied to the CPU, on both at a depth cut (2 layers; hybrid
             3, so that one is
             attention; encdec 2 + 2), prefill at B = 2, S = 512 (vlm: and
             576 image embeddings; encdec: a 512-frame source) and 4 decode
             steps within LOGIT_ULPS, no argmax differing away from a near
             tie; moe: each layer's moe_apply on the CPU's router input,
             routing differing only at near ties, and the end-to-end rows
             held until their routing differs; each checked once its CPU
             side is in, those still out in the train phase between its
             cells; (b) make_prefill_step at
             full depth from seed 0 at prefill_32k (B = 1; vlm 576 + 32,192,
             encdec source and tokens 32,768; yi-34b at 28 of its 60
             layers and mixtral-8x22b at 6 of its 56, ZOO_DEPTHS, the
             deepest within zoo_param_budget): exactly the flash launches
             and routes of ZOO_FLASH_ROUTES and nothing else, ms, tokens/s,
             peak memory (at most PEAK_BYTES_MAX); (c) at (b)'s depth,
             prefill against 5 decode steps within
             depth_logit_ulps (DEPTH_LOGIT_ULPS, grown past 40 layers in
             proportion to depth; moe exempt: capacity makes them different
             functions; vlm without image embeddings; encdec with a
             zero source, whose cross K/V equal the zero cache's); (d)
             ServeEngine with the launcher's defaults twice and the
             launcher, the same tokens, no kernel launch (nemotron-4-15b,
             yi-34b and mixtral-8x22b: the engines at 20, 18 and 4 layers,
             the deepest whose f32 params and the engine's bf16 copy fit
             the budget; their launcher, which serves full depth, not run);
             (e) mixtral-8x22b (LONG_ARCHS) at the long_500k shape: from a
             full 4,096-slot ring cache at pos 524,283, every leaf a seeded
             numpy draw (long_500k_inputs), 4 decode steps on the card
             against the CPU at (a)'s cut (logits and the written slots
             within LOGIT_ULPS, the row held until its routing differs; pos
             exact; step s writes slot (524,283 + s) % 4,096 and no other),
             and the ms a step at (d)'s depth; seconds each
  6 times    CUDA-event medians of each kernel, its plain version (at a
             model's 32k flash layer one pair: 40-70 times the kernel's) and
             its library yardstick at the main paths' shapes, beside the card's
             least time: bytes, or the operations the function needs (threefry:
             the least integer instructions its function needs per element
             over the two integer pipes, 64 a clock per SM each at
             nvidia-smi's highest SM clock, each instantiation's SASS main
             loop per pipe and element (cuobjdump) printed beside, also at
             the star's one-client draw (1, 45,451), also as device time in a
             CUDA graph, with the launcher's cut of both; flash:
             QK^T and three bf16 P.V products over the visible pairs on the
             bf16 tensor cores; the dh-256 wgmma kernel at recurrentgemma's
             layer, with ptxas's report of its instantiations, and the dh-128
             one at llava-next-mistral-7b's, each beside SDPA given the
             window as a boolean mask, and at chatglm3-6b's, nemotron-4-15b's
             and yi-34b's causal layers beside SDPA(is_causal, enable_gqa),
             and at mixtral-8x22b's windowed one beside SDPA's boolean mask);
             SYRK's ptxas report, dynamic shared
             memory,
             SASS instruction counts (DMMA, LDGSTS) and the L2 bytes its tile
             schedule stages; SYRK, TopK, RandSeqK and TopLEK at a9a's and
             phishing's round shapes, each against its plain version first
             (fednl_round_times); SYRK, TopLEK and flash at the probe's
             shapes (probe_kernel_times)
  7 trace    one round each of the TopK, RandK and PP paths under
             torch.cuda.set_sync_debug_mode("error") (no host sync: the
             Cholesky solve checks nothing); torch.profiler over 3 rounds of
             the TopK, TopLEK, RandK, Natural and PP paths and over one 32k
             prefill: device time by kernel and the device's busy share of the
             wall time (SYRK's ms per TopK round beside it); the host's ms per
             round for the key split, the clients' keys and draws, and their
             upload
  probe      examples/torch_fednl_probe.py at granite-3-2b's full width and
             depth, on the lm phase's params (seed 0's drawn without it):
             (a) the backbone's mean-pooled features of the example's 8
             clients x 64 samples of 16 tokens, exactly probe_flash_launches
             (40) flash launches on the wgmma route and nothing else, finite;
             at the lm phase's 2-layer cut of the same params the card
             against the CPU worker within PROBE_FEATURE_ULPS bf16 ulps of
             the feature scale, checked once the worker's side is in (in the
             zoo or the train phase, as the zoo's (a)); (b) FedNL (Option B, TopLEK at k = 8d, tol
             1e-13, <= 100 rounds) on them at d = 2,048 on the card: rounds,
             grad norm, accuracy, ms a round, the launches (SYRK rounds + 2,
             TopLEK rounds + 1, nothing else), one round's host syncs under
             set_sync_debug_mode("warn"): none (each would be named by the
             line that asked for it; an empty step counted first as the
             control), one round profiled; (c) its first 3 rounds against the CPU's on
             the card's z (grad norms within TRAJECTORY_RTOL, sent_bits
             exact but for phase 3's TopLEK boundary allowance)
  train      LM training, every family: (a) the
             forward's training instantiation and the two backward kernels
             (flash_attention_bwd.cu) against their plain versions at every
             route's fixtures (forward and backward: bf16 wgmma at head_dim
             64/128/256, SIMT at 16/32; f32 SIMT; GQA, windows, Sq != Sk,
             Sq off the tiles, rows with no visible key, C4's offsets, at
             head_dim 256 Kv 1 and 2), each fixture's backward route reported and
             its launches counted: O rounded equal to the inference output
             bit for bit, dq, dk, dv within BWD_CARD_ULPS bf16 ulps (f32:
             BWD_F32_RTOL) of scale and, bf16, rounded otherwise than the
             plain backward in at most BWD_DIFFER_SHARE of their nonzero
             elements, while the control (P and dS rounded to bf16 once,
             SDPA's function) must exceed that share; two runs the same
             bits; ptxas's
             registers and spills of the wgmma backward's instantiations (0
             spills, no wgmma warning); then at granite-3-2b's training layer
             (B 2, S 4,096, H 32, Kv 8, dh 64, causal), recurrentgemma-2b's
             (H 10, Kv 1, dh 256, causal window 2048; the dkdv kernel's
             cluster split and waves), seamless-m4t-large-v2's (H 16, Kv 16,
             dh 64, non-causal), llava-next-mistral-7b's (S 576 + 4,096,
             H 32, Kv 8, dh 128, causal window 4096), the dense configs'
             (DENSE_TRAIN_LAYER: H/Kv 32/2, 48/8, 56/8, dh 128, causal, no
             window) and mixtral-8x22b's (H 48, Kv 8, dh 128, causal window
             4096, which S 4,096 does not reach past), each held as the
             fixtures and timed
             beside the plain versions and SDPA's forward and backward (the
             window as a boolean mask, the kv heads repeated), with the
             bounds on the tensor cores and the CUDA cores, the 13-product
             floor and the products the kernels run; then for each of
             TRAIN_CELLS (granite-3-2b, recurrentgemma-2b,
             granite-moe-1b-a400m, mamba2-2.7b, seamless-m4t-large-v2,
             llava-next-mistral-7b, chatglm3-6b, nemotron-4-15b, yi-34b,
             mixtral-8x22b), each freed before the next: (b) full
             width at 2 layers (recurrentgemma-2b: 3, one of them
             attention; seamless: 2 encoder and 2 decoder layers;
             mixtral-8x22b: 1, as AdamW's state at 2 does not fit), B 1, S
             512 (llava: after 576 image embeddings; seamless: a 512-frame
             source; moe: S 64, the first seed whose routing on the card
             and the CPU agrees before each row's first difference, a near
             tie, for half its labels, the rest masked, with both runs'
             routing tables): the loss and every leaf's gradient on the
             card against the CPU (1e-3, 2e-2 relative L2; the CPU's in
             the worker during (c), checked after it), the launches of
             expected_train_launches on the wgmma route, and a train step
             run twice from one state, bit for bit; (c) full width and
             depth (llava: 12 of its 32 layers; the dense configs at
             DENSE_TRAIN_LAYERS and mixtral-8x22b at MIXTRAL_TRAIN_LAYERS,
             the deepest whose peak fits 80 GB): 6 steps
             (the cells after the first two: 4, for the run's time) of
             make_train_step (accum 2, B 4,
             S 4,096, remat "full", AdamW lr 1e-3) with exactly
             expected_train_launches' flash launches
             a step (granite-3-2b 160 + 80 + 80, recurrentgemma-2b 32 + 16
             + 16, granite-moe 96 + 48 + 48, mamba2 none, seamless 288 +
             144 + 144, llava 48 + 24 + 24, 4 + 2 + 2 a layer for the dense
             configs), all on the wgmma route, and
             nothing else, the loss falling, ms per step, tokens/s, peak
             memory under 80 GB, the last step profiled by kind of kernel
             (the flash backward's share), AdamW's update timed alone; (d)
             the training launcher, --reduced --steps 30: the loss falls by
             more than 0.5
  mesh       the mesh layer (after train): (a) granite-3-2b at full width
             and depth through launch/train.py's main with --mesh 1x1
             (DTensor params and AdamW state, each attention's flash
             launches through local_map), (c)'s seed, batches, accum,
             remat and 6 steps: the losses and final params bit for bit
             (c)'s, 160 + 80 + 80 flash launches a step all on the wgmma
             route, ms a step and peak memory beside (c)'s; (b) meanwhile,
             in three spawned fake worlds of 256 or 512 ranks
             (launch.dryrun.FakeWorld), the dry run's records of
             granite-3-2b's train_4k and prefill_32k on 16 x 16 with their
             probes (status ok), the FedNL dry run on both meshes (per-rank
             collective bytes equal to fednl_shard's closed form) and
             granite-3-2b's train_4k at B 4 counted on a 1 x 1 mesh (no
             collective bytes; its product flops equal to the roofline
             phase's plain count, checked there), and beside them the
             roofline phase's meta counts; one line a record: per-rank
             flops, bytes, collective bytes by kind, the three terms on the
             datasheet's ceilings and on this card's measured peak and HBM
             rate (the collective term at the datasheet's NVLink rate), the
             useful fraction
  8 sweep   solve_many of the README's grid at w8a's full shape: 4 seeds x
             {topk, randseqk, natural}, 50 rounds, planned as one batched
             group of 12 specs; the launch counts set to 0 before it and read
             after it: SYRK once a round on 1,704 clients (and at init and in
             the warm-up round), select_topk, select_randseqk and
             threefry_uniform (f64, Natural) once a round each; each spec
             against its own solve() on the card (sent_bits exact every
             round, grad norms within TRAJECTORY_RTOL where >= 1e-10, and
             whether it is bitwise, and op by op where it parts); the
             group's ms per round beside the sum of the 12 solves', peak
             memory, one batched round under
             set_sync_debug_mode("error") and 3 under torch.profiler; then a
             2-spec FedNL-LS group (seeds 0 and 1, TopK, 10 rounds) against
             its solves (ls_steps exact above the Armijo test's rounding
             band, grad norm 1e-7)
  9 session  open_session on w8a TopK: step(3), save, run to 10; the FNLS1
             file restored and run to 10; both equal solve(rounds=10) on the
             card bit for bit (x, grad norms, f, bits); the file round-trips
             byte for byte through load_state and save_state
 10 star     the wire stack: (a) star-loopback at w8a's whole shape, TopK 10
             rounds and TopLEK 3, against the card's local solve, the launch
             counts set to 0 before each and read after: SYRK 142 a round and
             142 at init, the index form of TopK (TopLEK) 142 a round, nothing
             else; grad norms within 1e-8 * norm + 1e-16 where >= 1e-12;
             sent_bits exact, measured payload bits = the analytic bits, frame
             bytes = the wire model; ms per round; (e) a star session: host
             syncs counted over round 2 (set_sync_debug_mode "warn"), saved at
             round 3, stepped and restored runs bit for bit the uninterrupted
             run, the third round traced; (b) each codec's one-row encode at T = 45,451 on the card
             against the CPU's bytes (TopLEK with phase 3's boundary
             allowance); (c) FedNL-PP with RandK over loopback, tau 71,
             FaultSpec(drop_prob=0.2) resampled, 10 rounds: exact launches
             (SYRK, and threefry and TopK by keys' index form three times per
             participant: encode, own decode, the master's PRG replay), the
             participants, drops and bits exactly the CPU run's, its models
             within 1e-8; (d) star-tcp with 8 client processes at w8a's
             per-client width, 5 rounds: bits and bytes exactly loopback's at
             that shape, every child exits 0; the index forms timed at the
             star's one-client shape against their plain and dense forms
 11 topology the topologies at w8a's whole shape, each part's launch counts
             set to 0 before it and read after: (a) an exact tree (fanout 4,
             depth 3: 20 aggregators), TopK, stepped 3, saved and run to 10,
             bit for bit phase 10's flat star (grad norms, f, x, bits, frame
             bytes) with its launches (SYRK 142 a round + 142, the TopK index
             form 142 a round); (a') RandK, 3 rounds, tree and flat star bit
             for bit, threefry and TopK by keys' index form 5 (tree) and 3
             (flat) times per leaf a round; (b) combine="sum" (fanout 12,
             depth 2): x within 1e-12 of the flat star, bits exact, the
             root's AGG bytes; (c) async: staleness 0 bit for bit the flat
             star (5 rounds); staleness 2, max_delay 3, 20 rounds: two card
             runs bit for bit, participants and bits the CPU run's, grad
             norms within 1e-8 * norm + 1e-16, launches one per assignment;
             (d) elastic, clients 130-141 join at round 2 and 0-11 leave at
             round 5: participants and bits the CPU run's, the round-2 delta
             12 uplinks + 12 * T * 64 bits, H_global after the leaves bitwise
             a fresh mean of the survivors' mirrors; (f) the (a), (c) and (d)
             sessions restored from FNLS1 by replay, bit for bit; (e)
             star-tcp: a process tree of 2 aggregators of 4 clients at w8a's
             per-client width, 5 rounds, bit for bit the loopback tree, exit
             codes 0, no cluster live after; (g) obs: a tree round and a
             flat-star round under a live recorder, bit for bit the run
             without it, one comm.hop span per aggregator, UPLINK and AGG
             bytes received against the measured frames, hop times by tree
             level, a profiled tree round
 12 serve    the FedNL serving engine and its gateway at w8a's whole shape,
             on the card: (a) the README grid and a TopLEK tenant (tol
             1e-12) through one FedNLServer(ServeConfig(max_resident=8,
             admit_per_tick=4, max_group=8)), half submitted, 5 ticks, then
             the rest, so that memory pressure spills and resumes tenants;
             the launch counts set to 0 before it and read after it: SYRK =
             admissions (resumes included) + batched rounds, each selection
             kernel and threefry dtype once per tick whose chunk holds its
             branch; each tenant against its own solve() (sent_bits exact,
             TopLEK with phase 3's boundary allowance; grad norms within
             TRAJECTORY_RTOL where >= 1e-10; whether it is bitwise); the
             engine's stats(); (b) one TopK spec alone and in groups of 2, 4
             and 8, against its solve() and across the sizes; (c) evicted at
             round 3 to FNLS1 and resumed in a fresh engine, bit for bit the
             tenant served alone, the file round-tripping byte for byte; (d)
             a star-loopback TopK tenant and a FedNL-PP tenant (tau 71)
             beside a batch group, each bit for bit its own session, exact
             launch counts; (e) a GatewayServer on 127.0.0.1 with the engine
             on the card: a GatewayClient submits 4 specs and streams their
             records (= the reports' bit for bit, each within (a)'s bounds of
             its solve), bad submissions refused naming the field, METRICS
             returning engine.* series, tick latencies; (f) ms per tick and
             tenant-rounds per second of an 8-slot group beside phase 8's
             group, a profiled tick, the state stack and unstack
 13 sharded the sharded backend at w8a's whole shape on a world of one (this
             process, NCCL on the card), each part's launch counts set to 0
             before it and read after: (a) dense_psum, TopK, 10 rounds,
             against the card's local solve: grad norms within 1e-8 * norm
             + 1e-16 where >= 1e-12, sent_elems and the three bit counts
             exact, SYRK once a round (+ the warm-up round and init) and
             select_topk once a round (+ warm-up), nothing else; (b)
             sparse_allgather the same through select_topk_idx, also
             against the CPU run of the port; a round of each under
             set_sync_debug_mode("error"), H^2 - H^1's support equal to
             the CPU's (round 0 changes nothing under hess0="exact"), 3
             rounds of each under torch.profiler; (c) RandSeqK and RandK
             under sparse_allgather, 3 rounds, against the CPU: every
             client's index set every round, bits, grad norms, launches
             (RandK: f32 threefry and TopK by keys' index form once a
             round); (d) a sparse_allgather session stepped 3, saved,
             restored, run to 10, bit for bit (b)'s run, its FNLS1 file
             byte-stable and resumed on the CPU; select_topk_idx at (142, T)
             against its plain version, timed; ms per round beside local's;
             sharded_uplink_bits and each collective's bytes per rank (at a
             world of one a copy on the card: the port's path, not a
             network)
  roofline   the full-width runs measured above, counted (repro_torch.roofline,
             the steps from repro_torch.launch.specs.build_dryrun): the
             datasheet's ceilings (H100_SXM bf16, H100_SXM_FP64) and this
             card's measured ones (measure_machine: an 8192 GEMM and a copy,
             bf16 and f64); the train phase's ten train steps (train_4k
             cut to B 4, accum 2; llava at 12 layers, the dense configs at
             DENSE_TRAIN_LAYERS, mixtral-8x22b at MIXTRAL_TRAIN_LAYERS) and
             the 32k prefills of granite-3-2b and the zoo's nine configs
             (prefill_32k cut to B 1; yi-34b and mixtral-8x22b at the zoo's
             28 and 6 layers; prefill's model flops 2 N_active D), each
             counted on meta in
             ROOFLINE_WORKERS spawned processes
             (during the mesh phase, after its timed steps, beside the fake
             worlds); step_cost refuses CUDA tensors (an argument, and a
             tensor made inside the step), granite-3-2b's 2-layer full-width
             train step (B 1, S 512) counts the same flops and bytes on meta
             and on the CPU, and phase 7's w8a TopK round is counted on the
             CPU with the real data; one line a run: flops, bytes, model
             flops (6 N D, 2 N D; the round: the packed Hessians' products),
             useful fraction, the three terms on each machine (the round's on
             the FP64 ones), the dominant term, the measured seconds and
             peak memory, mfu = model flops / (seconds x peak), at most
             ROOFLINE_SHARE_MAX on every machine, and the compute term's
             share of the seconds (reported: the plain program's products
             count every S**2 attention pair, which flash skips)
Every 32k prefill and train step takes its shape from
``repro_torch.launch.specs.SHAPES``, its global batch cut to CUT_BATCH.
Phase 3 also checks a window without causality through
``models.layers.chunked_attention`` (S = 2,048, q_chunk 512, window 300:
one launch per query chunk on its key slice) on both flash routes, bf16 at
head_dim 128 and 256 on wgmma and f32 at head_dim 32 on SIMT, against the
plain version on the same chunks and offsets.
Then the kernels line, the run's seconds, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA's data sheet for the H100 SXM at 700 W (dense): the least time the
# card could take is max(bytes / HBM rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12  # FP64 on the tensor cores
CUDA_CORE_32BIT_OPS = 67e12  # 32-bit ops outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # bf16 on the tensor cores
# exp2 on the MUFU pipe: 16 results per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132 SMs at
# the 1,980 MHz boost clock of the H100 SXM
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
# the integer work TopK's function needs per key: the f32 key, four radix
# passes of a digit, a compare and a count, and the final compare
SELECT_OPS_PER_KEY = 14
# the least 32-bit integer instructions threefry's function needs per
# element: 20 rounds of an add, a rotation and a xor; the key added to the
# counter and 5 key injections, two adds each (their k + i is per client,
# not per element): 32 adds, in 27 instructions, as IADD3 joins the key's
# and each injection's add to x0 but the last with x0's next add; and the
# float from the words: f32 a xor and one IMAD.HI ((s >> 9) + 0x3F800000,
# the or's bits being clear), f64 three (two IMAD.HI, one IMAD).  Only the
# xors (f32 21: the rounds' and the words'; f64 20) need the INT32 pipe: a
# rotation by r is also IMAD.WIDE by 2^r on the FMA pipe, its two halves
# ORed by the xor's LOP3, and a two-input add is also an IMAD.
THREEFRY_INT_INSTRS_PER_ELEM = {"float32": 20 + 20 + 27 + 2, "float64": 20 + 20 + 27 + 3}
THREEFRY_XORS_PER_ELEM = {"float32": 21, "float64": 20}
# Hopper's integer pipes, each 64 instructions a clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0: 32-bit integer add, shift, bitwise, compare: 64): the INT32 pipe
# takes adds, logic, shifts, funnel shifts, compares and selects; IMAD and
# its aliases (IMAD.MOV, IMAD.SHL, IMAD.IADD, which the compiler uses to
# spread integer work) go to the FMA pipe's heavy half; sm_90's VIADD (an
# add of an immediate) shares the INT32 pipe (scripts/threefry_probe.py's
# rates: VIADD and LOP3 together 59.7 a clock a SM, H100 80GB HBM3)
INT32_PIPE_PER_SM_CLOCK = 64
INT_ALU_OPCODES = frozenset({"IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                             "ISETP", "LEA", "SEL", "PRMT", "IABS", "IMNMX", "FLO", "POPC",
                             "BREV", "BMSK", "SGXT", "ICMP"})
INT_FMA_OPCODES = frozenset({"IMAD", "IMUL", "IDP"})
PP_TAU = 71  # FedNL-PP's participants per round at w8a: half the 142 clients
# phase 4 also solves these with TopK, TopLEK and RandSeqK, and phase 6 times
# the round's kernels at their shapes (the synthetic generator at the
# published (d, clients, n_i): a9a (124, 142, 229), phishing (69, 142, 77))
OTHER_DATASETS = ("a9a", "phishing")

SYRK_TOL = 1e-13  # of max(|Z|^T |h| |Z|): FP64 sums of n_i = 348 terms, any order
TRAJECTORY_RTOL = 1e-8  # card vs CPU grad norms over the first 3 rounds
MAIN_CPU_ROUNDS = 3  # phase 4: the rounds of each path's CPU run
TOPLEK_BOUNDARY = 1e-12  # TopLEK's allowed difference: alpha_m* this near k/T, or unif near p
DRAW_REPS = 200  # host draw timing: rounds of draws averaged
TIMED_REPS = 21  # event pairs per function; the median is reported
CALLS_PER_EVENT = 10
FLASH_TIMED_REPS = 5  # at the 32k prefill shape: one call per event pair
FLASH_PLAIN_REPS = 1  # ... of the plain version at a model's 32k layer (0.5-2 s a call)
FLASH_F32_ATOL = 2e-5  # f32 flash against its plain version (the JAX package's own bound)
# card vs CPU logits of the 2-layer cut, in bf16 ulps of the logit scale (the
# largest |logit|): bf16 activations rounded after differently ordered sums
LOGIT_ULPS = 4
# the 40-layer prefill against 40-layer sequential decode on the card: the same
# rounding differences, compounded over 40 residual updates
DEPTH_LOGIT_ULPS = 8
DEPTH_LAYERS = 40  # ... at granite's depth; the zoo's deeper models scale it


def depth_logit_ulps(n_layers: int) -> float:
    """The prefill-against-decode bound at ``n_layers``: DEPTH_LOGIT_ULPS at
    40 layers or fewer, growing with depth past them, as the rounding
    differences add up one residual update a layer (scripts/
    depth_drift_probe.py, mamba2-2.7b on an H100: 1.0, 2.0, 3.4, 6.3, 8.6,
    9.0 ulps at 2, 8, 16, 32, 48, 64 layers; its card and CPU prefills of
    one prompt, one function, differ by 16.7)."""
    return DEPTH_LOGIT_ULPS * max(1.0, n_layers / DEPTH_LAYERS)
LM_CUT_LAYERS = 2  # the card-vs-CPU check's depth cut (granite has 40)
# the repo's shapes (repro_torch.launch.specs.SHAPES) as one card runs them:
# prefill_32k's global batch of 32 and train_4k's of 256 cut to these
# (long_500k's is 1)
CUT_BATCH = {"prefill_32k": 1, "train_4k": 4, "long_500k": 1}
BY_PREFILL = "the lm and zoo phases: host clock around one synchronised 32k prefill"
ONE_CARD = {"data": 1, "model": 1}  # the mesh axes of one card (build_dryrun)
SWEEP_ROUNDS = 50  # the README's sweep: ExperimentSpec(..., rounds=50).grid(...)
SWEEP_GN_FLOOR = 1e-10  # group vs solve() grad norms compared where the solve's is above
LS_GROUP_ROUNDS = 10
# FedNL-LS's Armijo test is decided by rounding below this grad norm
# (ROADMAP C6): the group's ls_steps are held exact to its solve()'s above it
LS_EXACT_FLOOR = 1e-7
SESSION_ROUNDS, SESSION_SAVE_AT = 10, 3
STAR_ROUNDS = 10  # phase 10: star-loopback TopK at w8a, and its local solve
STAR_LEK_ROUNDS = 3  # phase 10: the star-loopback TopLEK path
STAR_GN_FLOOR = 1e-12  # star vs local grad norms compared where local's is above
# ... within TRAJECTORY_RTOL * norm + STAR_GN_ATOL: a star client's one-client
# batch and the local round's 142-client batch give the GEMVs of the oracles
# other last bits (cuBLAS picks by batch), and once Newton's convergence is
# quadratic, an ulp of x stays an absolute error of ~1e-20..1e-16 in the grad
# norm while the norm itself shrinks toward 1e-14
STAR_GN_ATOL = 1e-16
STAR_PP_DROP = 0.2  # phase 10 (c): FaultSpec(drop_prob=...) of the PP star
TCP_SHAPE = (301, 8, 348)  # phase 10 (d): w8a's d and n_i, 8 clients (DataSpec.shape order)
TCP_ROUNDS = 5
# phase 11: the topologies at w8a
TREE_ROUNDS = 10  # (a) the exact tree, TopK; (b) the sum tree
TREE_RANDK_ROUNDS = 3  # (a') the exact tree, RandK
ASYNC_SYNC_ROUNDS = 5  # (c) staleness 0 against the flat star
ASYNC_ROUNDS = 20  # (c) staleness 2, max_delay 3
ELASTIC_ROUNDS = 10  # (d)
ELASTIC_JOIN_AT, ELASTIC_LEAVE_AT = 2, 5
ELASTIC_JOINERS, ELASTIC_LEAVERS = range(130, 142), range(0, 12)
SUM_TREE_RTOL = SUM_TREE_ATOL = 1e-12  # (b) x against the flat star (the reference's bound)
# phase 12: the serving engine and its gateway at w8a
SERVE_ROUNDS = 50  # (a) the README grid's rounds
SERVE_CONFIG = {"max_resident": 8, "admit_per_tick": 4, "max_group": 8}  # (a): pressure
SERVE_EARLY, SERVE_EARLY_TICKS = 6, 5  # (a) tenants submitted first, ticks before the rest
GROUP_SIZES, GROUP_ROUNDS = (1, 2, 4, 8), 10  # (b)
EVICT_ROUNDS, EVICT_AT = 10, 3  # (c)
SOLO_STAR_ROUNDS, SOLO_PP_ROUNDS = 3, 5  # (d)
GATEWAY_ROUNDS = 20  # (e)
TICK_REPS = 10  # (f) ticks timed of an 8-slot group
# the roofline phase: full-width steps counted on meta in spawned processes
ROOFLINE_WORKERS = 6
ROOFLINE_SHARE_MAX = 1.05  # mfu: model flops over a measured time at peak
# phase 13: the sharded backend at w8a, a world of one
SHARDED_ROUNDS = 10  # (a) dense_psum, (b) sparse_allgather, (d) the session
SHARDED_RANDOM_ROUNDS = 3  # (c) RandSeqK and RandK under sparse_allgather


def shape_of(name: str):
    """``name``'s ShapeSpec from ``repro_torch.launch.specs.SHAPES`` with its
    global batch cut to ``CUT_BATCH[name]``, as ``build_dryrun``'s
    ``batch_override`` cuts it."""
    from repro_torch.launch.specs import SHAPES

    return dataclasses.replace(SHAPES[name], batch=CUT_BATCH[name])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# the phases in the order a run without --phases runs them all; each name is
# the "phase" of its lines
PHASES = ("kernels", "main", "lm", "times", "trace", "probe", "zoo", "train", "mesh", "sweep",
          "session", "star", "topology", "serve", "sharded", "roofline")
# what a phase cannot run without: selecting it runs these too.  A phase that
# only compares with another's numbers runs without it and names the parts
# it skipped (the selection line's skipped_parts)
PHASE_NEEDS = {"times": ("kernels",), "trace": ("kernels", "main"), "topology": ("star",)}


def select_phases(argv: list[str] | None) -> tuple[str, ...]:
    """The phases ``--phases a,b`` selects with those they need, in PHASES'
    order; all of them without the option.  An unknown name exits 2."""
    import argparse

    parser = argparse.ArgumentParser(prog="chip_smoke.py", description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", help="comma-separated, of: " + ", ".join(PHASES))
    names = parser.parse_args(argv).phases
    if names is None:
        return PHASES
    chosen = {name.strip() for name in names.split(",") if name.strip()}
    unknown = sorted(chosen - set(PHASES))
    if unknown or not chosen:
        parser.error(f"unknown phase {', '.join(unknown) or '(none given)'}; "
                     f"choose from {', '.join(PHASES)}")
    todo = list(chosen)
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in chosen:
                chosen.add(need)
                todo.append(need)
    return tuple(name for name in PHASES if name in chosen)


# the CPU worker leaves these cores to the driving process, whose host-bound
# work (mamba2-2.7b's ~10^5 launches a step, the FedNL rounds) it overlaps.
# A card's tensors reach the worker as CUDA IPC handles, and it copies them
# to its own memory (hold_on_host): a host copy in shared memory first
# faulted its pages in at ~0.4 GB/s on the H100's host (nemotron-4-15b's
# 7.9 GB cut: 20.6 s), where a copy to a process's own memory runs at the
# card's copy rate
CPU_SIDE_SPARE_CORES = 1


def _cpu_side_init(threads: int) -> None:
    import torch

    torch.set_num_threads(threads)


_HELD: dict = {}  # in the worker: its host copies, by key, between one job and the next


def hold_on_host(key: str, tree) -> float:
    """CpuSide job: a host copy of ``tree`` (nested dicts of tensors; a
    card's cross as CUDA IPC handles, a host's in shared memory) in this
    process's own memory, kept under ``key`` for the next job; the handles
    released before it returns.  Returns its seconds."""
    import torch

    t0 = time.perf_counter()

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else \
            t.detach().to("cpu", copy=True)

    _HELD[key] = copy(tree)
    del tree
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
    return time.perf_counter() - t0


_LAST_RUN: list = [None]  # in the worker: the thread of the CPU side started last


def start_run(fn, key: str, *args) -> None:
    """CpuSide job: ``fn(key, *args)`` started in a thread of this process
    that first waits for the one started before it, so that one CPU side
    computes at a time while hand-overs and take-backs go on beside it;
    returns at once.  collect_run(key) waits for it."""
    import threading

    before, box = _LAST_RUN[0], {}

    def run():
        if before is not None:
            before.join()
        try:
            box["out"] = fn(key, *args)
        except BaseException as err:  # noqa: BLE001 -- raised again by collect_run
            box["err"] = err

    thread = threading.Thread(target=run, name=f"cpu-side {key}", daemon=True)
    thread.start()
    _LAST_RUN[0] = thread
    _HELD[key + "/run"] = (thread, box)


def run_done(key: str) -> bool:
    """CpuSide job: whether the CPU side started under ``key`` has ended."""
    return not _HELD[key + "/run"][0].is_alive()


def collect_run(key: str):
    """CpuSide job: the result of the CPU side started under ``key``, once
    it has ended; what it raised, raised again."""
    thread, box = _HELD.pop(key + "/run")
    thread.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def put_held(key: str, tree) -> float:
    """CpuSide job: the tree held under ``key`` (taken) copied into
    ``tree``'s tensors, leaf by leaf in sorted-key order, for the caller to
    read (a card's through CUDA IPC).  Returns its seconds."""
    import torch

    t0 = time.perf_counter()
    for (_, dst), (_, src) in zip(_named(tree), _named(_HELD.pop(key)), strict=True):
        dst.copy_(src)
    del tree
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
    return time.perf_counter() - t0


class CpuJob:
    """A job handed to CpuSide's worker."""

    def __init__(self, name: str, threads: int, future):
        self.name, self.threads, self.future = name, threads, future
        self.t_submit = time.perf_counter()

    def result(self):
        """(the job's result, {job, threads, seconds from submit to result,
        seconds the caller waited}); raises what the job raised."""
        t0 = time.perf_counter()
        out = self.future.result()
        now = time.perf_counter()
        return out, {"job": self.name, "threads": self.threads,
                     "submit_to_result_s": now - self.t_submit, "waited_s": now - t0}


class CpuRun:
    """A CPU side started in CpuSide's worker's run chain (start_run)."""

    def __init__(self, side, name: str, key: str):
        self.side, self.name, self.key = side, name, key
        self.t_start = time.perf_counter()

    def done(self) -> bool:
        return self.side.submit(run_done, self.key).future.result()

    def result(self):
        """(its result, {job, threads, seconds from start to result, seconds
        the caller waited}); raises what it raised."""
        t0 = time.perf_counter()
        out = self.side.submit(collect_run, self.key).future.result()
        now = time.perf_counter()
        return out, {"job": self.name, "threads": self.side.threads,
                     "submit_to_result_s": now - self.t_start, "waited_s": now - t0}


class CpuSide:
    """One spawned CPU process that computes the CPU side of the card-versus-
    CPU checks while the caller goes on with the card.  ``submit`` hands it
    a job (a module-level function; tensors in shared memory cross as
    handles, results come back the same way) and returns its CpuJob; jobs
    run one at a time in the order submitted (FedNL's CPU runs queue so).
    An LM cell's CPU side is ``start``-ed instead: it computes in a thread
    of the worker after the one started before it, one at a time (the
    largest holds tens of GB on the host), while the worker takes the next
    cell's hand-over and the last one's take-back.  ``threads``: the
    worker's torch threads."""

    def __init__(self, threads: int | None = None):
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
        self.threads = threads or max(1, (cores or 1) - CPU_SIDE_SPARE_CORES)
        self._pool = None

    def submit(self, fn, *args) -> CpuJob:
        from concurrent.futures import ProcessPoolExecutor

        import torch.multiprocessing as tmp

        if self._pool is None:
            self._pool = ProcessPoolExecutor(1, mp_context=tmp.get_context("spawn"),
                                             initializer=_cpu_side_init, initargs=(self.threads,))
        return CpuJob(fn.__name__, self.threads, self._pool.submit(fn, *args))

    @contextlib.contextmanager
    def same_threads(self):
        """This process's torch threads those of the worker meanwhile: the
        moe's routing recomputed here is then the worker's (a matmul's bits
        on the CPU follow its thread count)."""
        import torch

        threads = torch.get_num_threads()
        torch.set_num_threads(self.threads)
        try:
            yield
        finally:
            torch.set_num_threads(threads)

    def start(self, fn, key: str, *args) -> CpuRun:
        """``fn(key, *args)`` (a CPU side that reads what was handed over
        under ``key``) started in the worker after the CPU sides started
        before it; hand-overs and take-backs still go through meanwhile."""
        self.submit(start_run, fn, key, *args).future.result()
        return CpuRun(self, fn.__name__, key)

    def hand_over(self, key: str, tree) -> float:
        """The worker's own host copy of ``tree`` under ``key`` (hold_on_host),
        waited for: the caller may then free or change ``tree``.  Returns the
        seconds this took."""
        import torch

        t0 = time.perf_counter()
        self.submit(hold_on_host, key, tree).result()
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()  # the worker has let go of the card's blocks
        return time.perf_counter() - t0

    def take_back(self, key: str, tree) -> float:
        """The tree the worker holds under ``key`` copied into ``tree``'s
        tensors (put_held), waited for.  Returns the seconds this took."""
        import torch

        t0 = time.perf_counter()
        self.submit(put_held, key, tree).result()
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()
        return time.perf_counter() - t0

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def solve_cpu_side(spec, z=None):
    """CpuSide job: ``solve(spec, z=z, device="cpu")``, its report without
    the PP diagnostic's closure (the checks read the card run's)."""
    from repro_torch.api import solve

    rep = solve(spec, z=z, device="cpu")
    rep.final_grad_norm_fn = None
    return rep


def lm_cpu_side(key: str, cut, toks) -> dict:
    """CpuSide job: the lm phase's depth cut on the CPU, on the params held
    under ``key``: the prefill's logits of ``toks`` (B, S) and those of 4
    decode steps on its first tokens."""
    import torch

    from repro_torch.models import init_decode_cache, lm_decode_step, lm_prefill

    t0 = time.perf_counter()
    params = _HELD.pop(key)
    prefill = lm_prefill(params, cut, torch.as_tensor(toks))
    cache, decode = init_decode_cache(cut, toks.shape[0], 8, "cpu"), []
    for s in range(4):
        logits, cache = lm_decode_step(params, cut, cache, torch.as_tensor(toks[:, s : s + 1]))
        decode.append(logits)
    return {"prefill": prefill, "decode": decode, "seconds": time.perf_counter() - t0}


def decode_recorded(step, params, cache, tokens, dev) -> tuple[list, list, dict]:
    """One decode step a column of ``tokens`` (numpy or a CPU tensor, (B,
    n)) on ``dev``, each step's moe_apply inputs recorded: the logits and
    the calls of each step (on the CPU), and the cache after them."""
    import torch

    logits, calls = [], []
    for s in range(tokens.shape[1]):
        with record_router_inputs() as rec:
            lg, cache = step(params, cache, torch.as_tensor(tokens[:, s : s + 1]).to(dev))
        logits.append(lg.cpu())
        calls.append(rec)
    return logits, calls, cache


def moe_module_outputs(cut, params, calls) -> list:
    """Each layer's moe_apply of ``params`` on ``calls[layer]`` (a run's
    router inputs, layer by layer), on their device."""
    from repro_torch.models import lm as tlm
    from repro_torch.models.moe import moe_apply

    m, layers = cut.moe, tlm._layers(params["blocks"], cut.n_layers)
    return [moe_apply(h, layer["moe"], n_experts=m.n_experts, top_k=m.top_k,
                      capacity_factor=m.capacity_factor, activation=cut.activation)
            for h, layer in zip(calls[: cut.n_layers], layers)]


def zoo_cpu_side(key: str, cut, batch: dict, long: bool = False) -> dict:
    """CpuSide job: the zoo's (a) on the CPU, on the params held under
    ``key``: ``batch``'s prefill logits and those of 4 decode steps on its
    first tokens, with every moe_apply's input recorded
    (record_router_inputs) in each; the moe's each layer's moe_apply
    output in the prefill (what moe_module_outputs gives on its input, not
    computed again); with ``long``, the LONG_STEPS decode steps from
    long_500k_inputs' cache, and that cache after them."""
    from repro_torch.models import encdec as ted
    from repro_torch.models import lm as tlm
    from repro_torch.train import make_prefill_step, make_serve_step

    t0 = time.perf_counter()
    params = _HELD.pop(key)
    module = [] if cut.family == "moe" else None
    with record_router_inputs(module) as prefill_calls:
        prefill = make_prefill_step(cut)(params, batch)
    if cut.family == "encdec":
        cache = ted.init_encdec_cache(cut, 2, 8, 16, "cpu")
    else:
        cache = tlm.init_decode_cache(cut, 2, 8, "cpu")
    step = make_serve_step(cut)
    decode, decode_calls, _ = decode_recorded(step, params, cache, batch["tokens"][:, :4], "cpu")
    out = {"prefill": prefill, "prefill_calls": prefill_calls, "decode": decode,
           "decode_calls": decode_calls}
    if module is not None:
        out["moe_module"] = module
    if long:
        cache, tokens = long_500k_inputs(cut)
        out["long_decode"], out["long_decode_calls"], out["long_cache"] = decode_recorded(
            step, params, cache, tokens, "cpu")
    return {**out, "seconds": time.perf_counter() - t0}


def train_cpu_side(key: str, cut, batch: dict) -> dict:
    """CpuSide job: the train depth cut's loss and gradient on the CPU, on
    the params held under ``key``, every activation kept (remat "none": the
    same numbers as remat "full" on the CPU, tests/test_torch_train.py, a
    quarter less work).  Returns the loss; the gradient stays held under
    ``key + "/grads"`` for put_held."""
    import torch

    from repro_torch.train.step import batch_to, loss_for, value_and_grad

    t0 = time.perf_counter()
    loss, _HELD[key + "/grads"] = value_and_grad(
        loss_for(dataclasses.replace(cut, remat_policy="none")), _HELD.pop(key),
        [batch_to(batch, torch.device("cpu"))])
    return {"loss": loss, "seconds": time.perf_counter() - t0}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out.splitlines()[0]


def host_memory() -> dict:
    """The host's total and available memory in bytes (/proc/meminfo): what
    the CPU worker's host copies leave."""
    info = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            name, value = ln.split(":", 1)
            if name in ("MemTotal", "MemAvailable"):
                info[name] = int(value.split()[0]) * 1024
    return {"total": info.get("MemTotal"), "available": info.get("MemAvailable")}


def near_tie_rows(n_rows: int, t: int, seed: int) -> np.ndarray:
    """f64 entries, pairwise distinct, that collide in groups of four when
    rounded to f32 keys (the fixture of tests/test_kernels.py, batched)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_rows, -(-t // 4))).astype(np.float32).astype(np.float64)
    eps = np.array([0.0, 1e-12, 2.5e-12, -1e-12])
    u = (base[:, :, None] * (1.0 + eps)).reshape(n_rows, -1)[:, :t]
    return rng.permuted(u, axis=1)


def dyadic_rows(n_rows: int, t: int, seed: int) -> np.ndarray:
    """Entries +-2**-e, e in [0, 10], many exact ties: every sum of their
    squares is exact in any order (tests/test_torch_kernels.py's fixture)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 11, size=(n_rows, t))
    return np.where(rng.random((n_rows, t)) < 0.5, -1.0, 1.0) * np.ldexp(1.0, -e)


def toplek_near_boundary(u: np.ndarray, k: int, unif: float) -> bool:
    """Row u is TopLEK's allowed case of difference: alpha_m* (or alpha_m*-1)
    within TOPLEK_BOUNDARY of delta = k/T, or unif within it of p, with the
    prefix energies summed exactly rounded (math.fsum)."""
    t = u.shape[0]
    delta = k / t
    order = np.lexsort((np.arange(t), -np.abs(u).astype(np.float32)))[:k]
    total = math.fsum(u * u)
    if total == 0:
        return False
    sq = u[order] ** 2
    alphas = np.array([math.fsum(sq[: m + 1]) / total for m in range(k)])
    m_star = min(int(np.sum(alphas < delta)) + 1, k)
    hi = alphas[m_star - 1]
    lo = alphas[m_star - 2] if m_star > 1 else 0.0
    p = min(max((hi - delta) / (hi - lo), 0.0), 1.0) if hi > lo else 0.0
    return min(abs(hi - delta), abs(lo - delta), abs(unif - p)) <= TOPLEK_BOUNDARY


def launch_counts(ops) -> dict[str, int]:
    """Each kernel's launches since the last reset; threefry's also by dtype
    (``threefry_uniform_float32``/``_float64``), as its wrapper counts them."""
    by_dtype = ops.threefry.threefry_uniform_cuda.dtype_launches
    return {**ops.launch_counts(), **{f"threefry_uniform_{k}": v for k, v in by_dtype.items()}}


def bits_equal(a, b) -> bool:
    """Bit-for-bit equality of two float64 tensors (+0.0 and -0.0 differ)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def median_ms(fns: dict, reps: int = TIMED_REPS, calls: int = CALLS_PER_EVENT) -> dict[str, float]:
    """Device ms per call of each function: CUDA events around ``calls``
    back-to-back calls (so the queue runs ahead of the host and the host's
    launch cost hides behind the device's work where it can), median over
    ``reps`` such pairs, the functions in turns."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {
        name: statistics.median(s.elapsed_time(e) for s, e in pairs) / calls
        for name, pairs in events.items()
    }


def graph_median_ms(fns: dict, reps: int = TIMED_REPS,
                    calls: int = CALLS_PER_EVENT) -> dict[str, float]:
    """Device ms per call of each function with no host time in it:
    ``calls`` calls captured in one CUDA graph a function, CUDA events
    around a replay, the median over ``reps`` replays, the graphs in turns
    (for a kernel shorter than its wrapper's launch cost on the host, which
    :func:`median_ms` would time instead)."""
    import torch

    graphs, side = {}, torch.cuda.Stream()
    for name, fn in fns.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], capture_error_mode="thread_local"):
            for _ in range(calls):
                fn()
    per_replay = median_ms({name: g.replay for name, g in graphs.items()}, reps, calls=1)
    return {name: ms / calls for name, ms in per_replay.items()}


def fednl_round_counts(n_clients: int, n_i: int, d: int, k: int) -> dict:
    """(bytes, operations, the operations' rate) of each kernel of a FedNL
    round at (clients, n_i, d) and k: SYRK, TopK, RandSeqK, TopLEK, in that
    order: each input read once, each output written once, and the least
    operations of its function."""
    t_len = d * (d + 1) // 2
    elems = n_clients * t_len
    p2 = 1 << (k - 1).bit_length()
    sort_stages = p2.bit_length() * (p2.bit_length() - 1) // 2
    return {
        "hessian_syrk_packed": (  # z, hw read, H written
            (n_clients * n_i * d + n_clients * n_i + elems) * 8,
            2 * n_i * t_len * n_clients, FP64_TENSOR_FLOPS),
        "select_topk": (
            elems * 8 * 2 + n_clients * 4,  # u read, u_hat written, sent
            SELECT_OPS_PER_KEY * elems, CUDA_CORE_32BIT_OPS),
        "select_randseqk": (
            n_clients * (k + t_len) * 8 + n_clients * (8 + 4),  # window read, u_hat written, s, sent
            3 * elems,  # subtract, wrap, compare per entry
            CUDA_CORE_32BIT_OPS),
        "select_toplek": (
            elems * 8 * 2 + n_clients * (8 + 4),  # u read, u_hat written, unif, sent
            SELECT_OPS_PER_KEY * elems + n_clients * (p2 // 2) * sort_stages * 2,
            CUDA_CORE_32BIT_OPS),
    }


def fednl_round_bounds(n_clients: int, n_i: int, d: int, k: int) -> dict:
    """(ms, by) the least time of each kernel of a FedNL round at (clients,
    n_i, d) and k (fednl_round_counts)."""
    return {name: bound(*counts)
            for name, counts in fednl_round_counts(n_clients, n_i, d, k).items()}


def fednl_round_times(dataset: str, dev) -> dict:
    """The round's four kernels at ``dataset``'s shape (OTHER_DATASETS: the
    synthetic generator at its published shape, k = 8d, seed 0): SYRK on
    random curvature weights, TopK, RandSeqK and TopLEK on the second
    round's correction with that round's draws; each against its plain
    version (SYRK within SYRK_TOL of its scale; TopK and RandSeqK bit for
    bit; TopLEK bit for bit but for rows at its boundary, each near it),
    then timed beside its plain version and its library call, with its
    bound."""
    import torch

    from repro_torch import prng
    from repro_torch.api import DataSpec, ExperimentSpec
    from repro_torch.compressors.select import randseqk_window_mask, rank_keys
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.kernels.compressor_select import (
        select_randseqk_cuda, select_randseqk_plain, select_topk_cuda, select_topk_plain,
        select_toplek_cuda, select_toplek_plain)
    from repro_torch.kernels.hessian_syrk import (hessian_syrk_packed_cuda,
                                                  hessian_syrk_packed_plain)
    from repro_torch.objectives.logreg import logreg_oracles_packed

    spec = ExperimentSpec(data=DataSpec(dataset=dataset))
    cfg = spec.fednl_config()
    z = torch.as_tensor(spec.data.build(), dtype=torch.float64, device=dev).contiguous()
    n_clients, n_i, d = z.shape
    t_len, k = d * (d + 1) // 2, cfg.k_for(d)
    sigma = np.random.default_rng(0).uniform(0.0, 1.0, size=(n_clients, n_i))
    hw = torch.as_tensor(sigma * (1.0 - sigma) / n_i, dtype=torch.float64, device=dev)
    state0 = fednl_init(z, cfg)
    state1, _ = make_fednl_round(z, cfg)(state0)
    delta = (logreg_oracles_packed(z, state1.x, cfg.lam)[2] - state1.h_local).contiguous()
    key = prng.split(prng.split(state0.key, 2)[0], 2)[1]  # round 1's draws
    round_keys = prng.split(key, n_clients)
    s_round = torch.as_tensor(prng.randint(round_keys, 0, t_len), device=dev)
    unif = torch.as_tensor(prng.uniform(round_keys), device=dev)

    h_kernel = hessian_syrk_packed_cuda(z, hw, cfg.lam)
    scale = hessian_syrk_packed_plain(z.abs(), hw.abs(), 0.0).abs().max().item()
    syrk_err = (h_kernel - hessian_syrk_packed_plain(z, hw, cfg.lam)).abs().max().item()
    check(syrk_err <= SYRK_TOL * scale, f"SYRK at {dataset}: {syrk_err} > {SYRK_TOL} * {scale}")
    for name, kern, plain, args in (
            ("TopK", select_topk_cuda, select_topk_plain, (k,)),
            ("RandSeqK", select_randseqk_cuda, select_randseqk_plain, (k, s_round))):
        (got, sent), (want, sent_want) = kern(delta, *args), plain(delta, *args)
        check(bits_equal(got, want) and torch.equal(sent, sent_want),
              f"{name} at {dataset}: differs from the plain version")
    (got, sent), (want, sent_want) = (select_toplek_cuda(delta, k, unif),
                                      select_toplek_plain(delta, k, unif))
    differ = (~torch.all(got.view(torch.int64) == want.view(torch.int64), dim=-1)) | (
        sent != sent_want)
    rows = differ.nonzero().flatten().tolist()
    u_host, unif_host = delta.cpu().numpy(), unif.cpu().numpy()
    for r in rows:
        check(abs(int(sent[r]) - int(sent_want[r])) == 1
              and toplek_near_boundary(u_host[r], k, float(unif_host[r])),
              f"TopLEK at {dataset}: row {r} differs away from the boundary")
    keys = rank_keys(delta)
    zs = hw[..., None] * z
    window = randseqk_window_mask(t_len, k, s_round)
    zeros = torch.zeros_like(delta)
    ms = {
        "hessian_syrk_packed": median_ms({
            "kernel": lambda: hessian_syrk_packed_cuda(z, hw, cfg.lam),
            "plain": lambda: hessian_syrk_packed_plain(z, hw, cfg.lam),
            "library": lambda: torch.bmm(z.mT, zs)}),
        "select_topk": median_ms({
            "kernel": lambda: select_topk_cuda(delta, k),
            "plain": lambda: select_topk_plain(delta, k),
            "library": lambda: torch.topk(keys, k, dim=-1)}),
        "select_randseqk": median_ms({
            "kernel": lambda: select_randseqk_cuda(delta, k, s_round),
            "plain": lambda: select_randseqk_plain(delta, k, s_round),
            "library": lambda: torch.where(window, delta, zeros)}),
        "select_toplek": median_ms({
            "kernel": lambda: select_toplek_cuda(delta, k, unif),
            "plain": lambda: select_toplek_plain(delta, k, unif),
            "ranking_only": lambda: torch.topk(keys, k, dim=-1)}),
    }
    bounds = fednl_round_bounds(n_clients, n_i, d, k)
    out = {"dataset": dataset, "shape": [n_clients, n_i, d], "t": t_len, "k": k,
           "syrk_rel_err": syrk_err / scale, "toplek_boundary_rows": len(rows),
           **{name: {**ms[name], "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
              for name in ms}}
    emit({"phase": "times", "part": "round_shape", **out,
          "note": f"ms per call: median over {TIMED_REPS} event pairs around {CALLS_PER_EVENT} "
                  "back-to-back calls, in turns; TopK, RandSeqK and TopLEK on round 1's "
                  "correction and draws; library calls as at w8a's shape"})
    return out


def trace(step, n: int, unit: str, marks: tuple[str, ...] = ()) -> dict:
    """Device time by kernel over ``n`` calls of ``step`` (warmed up by the
    caller), and the device's busy share of the host's wall time over the
    window (the profiler's own host cost included, so the share is a floor);
    for each of ``marks``, the launches a call of each kernel whose name
    holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        return {f"{unit}s": n, "device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        f"{unit}s": n,
        f"wall_ms_per_{unit}": wall_us / n / 1e3,
        f"device_ms_per_{unit}": device_us / n / 1e3,
        "device_busy_share": device_us / wall_us,
        f"kernel_launches_per_{unit}": sum(e.count for e in kernels) / n,
        "top_kernels": [
            {"name": e.key[:90], f"ms_per_{unit}": e.self_device_time_total / n / 1e3,
             f"calls_per_{unit}": e.count / n}
            for e in top
        ],
        **({"launches_by_mark": {mark: {e.key[:90]: e.count / n for e in kernels if mark in e.key}
                                 for mark in marks}} if marks else {}),
    }


def trace_rounds(round_fn, state, rounds: int, marks: tuple[str, ...] = ()) -> dict:
    """``trace`` over ``rounds`` FedNL rounds after one warm-up round."""
    box = [round_fn(state)[0]]

    def step():
        box[0] = round_fn(box[0])[0]

    return trace(step, rounds, "round", marks)


def bound(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def syrk_build_facts(build, report: str | None) -> dict:
    """The SYRK kernel as built: ptxas's registers, spills and shared memory
    (from this run's build; "not measured" when the library was built before
    the run), its dynamic shared memory, and the instructions its SASS holds
    (cuobjdump beside nvcc): DMMA, the tensor-core FP64 product; LDGSTS, the
    cp.async copy; DFMA, a product on the FP64 pipes."""
    import ctypes

    facts = {"dynamic_smem_bytes": build.function(
        "hessian_syrk", "syrk_packed_smem_bytes", (), restype=ctypes.c_int)()}
    if report is None:
        facts["ptxas"] = "not measured (library built before this run)"
    else:
        facts["ptxas"] = [ln.strip() for ln in report.splitlines()
                          if "registers" in ln or "spill" in ln or "smem" in ln]
    sass = cuobjdump_sass(build, "hessian_syrk")
    if sass is None:
        facts["sass"] = "not measured (no cuobjdump beside nvcc)"
        return facts
    ops = [ln.split(";")[0].split("*/")[-1].strip() for ln in sass.splitlines() if "/*" in ln]
    opcode = [op.split()[1] if op.startswith("@") else op.split()[0] for op in ops if op]
    facts["sass"] = {name: sum(o.startswith(name) for o in opcode)
                     for name in ("DMMA", "LDGSTS", "DFMA", "DMUL")}
    facts["sass"]["dmma_shapes"] = sorted({o for o in opcode if o.startswith("DMMA")})
    return facts


def cuobjdump_sass(build, name: str) -> str | None:
    """The SASS listing of ``csrc/<name>.cu``'s library (cuobjdump beside
    nvcc), or None where there is no cuobjdump."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        return None
    return subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def sass_functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump -sass's listing split by kernel: mangled name -> its lines."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def sass_loops(lines: list[str]) -> dict:
    """One kernel's SASS lines: the opcodes (mnemonics without their
    modifiers) of the whole kernel and of each innermost loop, the
    instructions from a branch target to a branch back to it that enclose
    no other such branch; and beside the loops, each loop's stores with
    their modifiers (``STG.E.128``: their width)."""
    instrs, mnemonics, at_addr, labels = [], [], {}, {}
    for line in lines:
        label = re.match(r"\s*\.(L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(instrs)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if not m:
            continue
        text = m.group(2).strip()
        if text.startswith("@"):  # a predicate guard
            text = text.split(None, 1)[1]
        target = re.search(r"\(\.(L_x_\d+)\)|\b0x([0-9a-f]+)\s*$", text)
        at_addr[int(m.group(1), 16)] = len(instrs)
        instrs.append((text.split()[0].split(".")[0],
                       None if target is None else target.group(1) or int(target.group(2), 16)))
        mnemonics.append(text.split()[0])
    back = []
    for i, (op, target) in enumerate(instrs):
        lo = labels.get(target) if isinstance(target, str) else at_addr.get(target)
        if op in ("BRA", "JMP") and lo is not None and lo <= i:
            back.append((lo, i))
    loops, loop_stores = [], []
    for lo, hi in back:
        if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in back):
            counts: dict[str, int] = {}
            for op, _ in instrs[lo:hi + 1]:
                counts[op] = counts.get(op, 0) + 1
            loops.append({"instructions": hi - lo + 1, "opcodes": counts})
            stores: dict[str, int] = {}
            for mnemonic in mnemonics[lo:hi + 1]:
                if mnemonic.split(".")[0] == "STG":
                    stores[mnemonic] = stores.get(mnemonic, 0) + 1
            loop_stores.append(stores)
    total: dict[str, int] = {}
    for op, _ in instrs:
        total[op] = total.get(op, 0) + 1
    return {"instructions": len(instrs), "opcodes": total, "loops": loops,
            "loop_stores": loop_stores}


def store_bits(mnemonic: str) -> int:
    """The bits one SASS store writes a thread: ``STG.E.128`` 128,
    ``STG.E.64`` 64, ``STG.E.U8`` 8, ``STG.E.U16`` 16, ``STG.E`` 32."""
    mods = mnemonic.split(".")[1:]
    for mod, bits in (("128", 128), ("64", 64), ("U16", 16), ("S16", 16), ("U8", 8), ("S8", 8)):
        if mod in mods:
            return bits
    return 32


def threefry_sass_facts(build) -> dict | None:
    """The threefry kernels as compiled (:func:`threefry_loop_facts` of the
    built library's SASS); None where no cuobjdump is at hand."""
    sass = cuobjdump_sass(build, "threefry")
    return None if sass is None else threefry_loop_facts(sass)


def threefry_loop_facts(sass: str) -> dict:
    """Each threefry kernel instantiation as compiled: the integer
    instructions on each integer pipe of its main loop, per element, and
    the whole kernel's.  The main loop is the one loop that holds the
    kernel's widest store (``STG.E.128`` over a tail loop's ``STG.E``); its
    elements a trip are its stores' bits over the element's (two 16-byte
    stores of doubles: 4).  A tail loop stores only narrower, and its counts
    are listed apart.  Keyed by dtype for the instantiation with the most
    counters a thread (``Li4E`` in the mangled name), ``float32_counters_1``
    for another, ``float32_small`` for the small route's kernel."""
    found = []
    for name, lines in sass_functions(sass).items():
        if not re.search(r"threefry_uniform_(small_)?kernel", name):
            continue
        elem_bits = 64 if "ILb1E" in name else 32
        dtype = ("float64" if elem_bits == 64 else "float32") + (
            "_small" if "small_kernel" in name else "")
        counters = re.search(r"ILb[01]ELi(\d+)E", name)
        facts = sass_loops(lines)
        storing = [(lp, st) for lp, st in zip(facts["loops"], facts["loop_stores"]) if st]
        check(bool(storing), f"threefry SASS: no loop stores in {name}")
        widest = max(store_bits(m) for _, st in storing for m in st)
        main = [(lp, st) for lp, st in storing if any(store_bits(m) == widest for m in st)]
        check(len(main) == 1, f"threefry SASS: {len(main)} loops hold the widest store in {name}")
        (loop, stores), tails = main[0], [lp for lp, st in storing if (lp, st) != main[0]]
        elements = sum(n * store_bits(m) // elem_bits for m, n in stores.items())
        ops, kernel_ops = loop["opcodes"], facts["opcodes"]
        found.append((dtype, int(counters.group(1)) if counters else 1, {
            "function": name, "loop": loop, "stores": stores, "elements_per_trip": elements,
            "int_alu_per_elem": sum(ops.get(o, 0) for o in INT_ALU_OPCODES) / elements,
            "int_fma_per_elem": sum(ops.get(o, 0) for o in INT_FMA_OPCODES) / elements,
            "tail_loops": tails,
            "kernel_instructions": facts["instructions"],
            "kernel_int_alu": sum(kernel_ops.get(o, 0) for o in INT_ALU_OPCODES),
            "kernel_int_fma": sum(kernel_ops.get(o, 0) for o in INT_FMA_OPCODES)}))
    most = {dtype: max(c for d, c, _ in found if d == dtype) for dtype, _, _ in found}
    out = {dtype if counters == most[dtype] else f"{dtype}_counters_{counters}": facts
           for dtype, counters, facts in found}
    check({"float32", "float64"} <= set(out), f"threefry SASS: kernels {sorted(out)}")
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def host_draw_ms(prng, upload_draws, n_clients: int, t: int, device) -> dict:
    """Host ms per round of the PRNG work a round does, averaged over
    DRAW_REPS rounds: split(key), which every compressor's round does; the
    clients' keys split(sub, n_clients) and the draws, which a random
    compressor's round adds; and the draws' pinned upload (enqueued, not
    waited for)."""
    import torch

    key = prng.prng_key(0)
    t0 = time.perf_counter()
    for _ in range(DRAW_REPS):
        key, sub = prng.split(key, 2)
    out = {"n_clients": n_clients, "reps": DRAW_REPS,
           "key_split_ms_per_round": (time.perf_counter() - t0) / DRAW_REPS * 1e3}
    for name, draw in (("toplek", prng.uniform), ("randseqk", lambda ks: prng.randint(ks, 0, t))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DRAW_REPS):
            draws = draw(prng.split(sub, n_clients))
        t1 = time.perf_counter()
        for _ in range(DRAW_REPS):
            upload_draws(draws, device)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = {
            "client_keys_and_draws_ms_per_round": (t1 - t0) / DRAW_REPS * 1e3,
            "upload_ms_per_round": (t2 - t1) / DRAW_REPS * 1e3,
        }
    return out


def flash_inputs(dev, b, sq, sk, h, kv, dh, dtype, seed):
    """q (b, sq, h, dh), k and v (b, sk, kv, dh): standard normal draws of a
    torch generator on the card, rounded to ``dtype``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


def check_flash(dev, tfa) -> tuple[dict, float]:
    """The flash kernel against its plain version on the card: bf16 within
    one bf16 ulp (taken at no less than BF16_ULP_FLOOR), f32 within
    FLASH_F32_ATOL.  Returns the per-case report and the largest absolute
    error over the bf16 cases."""
    import torch

    from repro_torch.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    seq = shape_of("prefill_32k").seq
    probe_cfg, probe_seq = get_config(PROBE_ARCH), probe_example().SEQ
    cases = {  # name: (b, sq, sk, h, kv, dh, causal, window, dtype)
        "granite_32k_layer": (1, seq, seq, 32, 8, 64, True, None, bf16),
        "b4_s4096": (4, 4096, 4096, 32, 8, 64, True, None, bf16),
        "s8192_window4096": (1, 8192, 8192, 32, 8, 64, True, 4096, bf16),
        "s1000_padding": (1, 1000, 1000, 32, 8, 64, True, None, bf16),
        "prompt_sq5": (1, 5, 5, 32, 8, 64, True, None, bf16),
        "noncausal_64x256": (1, 64, 256, 32, 8, 64, False, None, bf16),
        "dh128_window200": (2, 777, 777, 8, 2, 128, True, 200, bf16),
        "dh32_simt_route": (2, 1000, 1000, 8, 2, 32, True, 300, bf16),
        # recurrentgemma-2b's attention layer at its 32k prefill: the wgmma route
        "recurrentgemma_32k_layer_dh256": (1, seq, seq, 10, 1, 256, True, 2048, bf16),
        # the 32k layers of the zoo's configs cut in depth: head_dim 128,
        # causal, no window (the dense ones) or mixtral-8x22b's window 4,096
        **{f"{arch}_32k_layer": (1, seq, seq, c.n_heads, c.n_kv, c.head_dim, True, c.window, bf16)
           for arch, c in ((a, get_config(a)) for a in ZOO_DEPTHS)},
        "dh256_kv2_window300_s1000": (2, 1000, 1000, 8, 2, 256, True, 300, bf16),
        # one layer of the probe's backbone call: its clients' samples at its
        # sequence, under one 64-query tile
        "probe_backbone_layer": (PROBE_CLIENTS * PROBE_SAMPLES, probe_seq, probe_seq,
                                 probe_cfg.n_heads, probe_cfg.n_kv, probe_cfg.head_dim, True,
                                 probe_cfg.window, bf16),
        "f32_s2048": (2, 2048, 2048, 32, 8, 64, True, None, f32),
        "f32_dh256_simt_window2048": (1, 4096, 4096, 10, 1, 256, True, 2048, f32),
        # the packed grid at S 64: two sequences a block
        "s64_b64_packed": (64, 64, 64, 32, 8, 64, True, None, bf16),
    }
    # the fixtures that take the packed grid (tfa.flash_fwd_grid); the rest
    # keep the grid of (query tile, head, batch row)
    packed_cases = {"probe_backbone_layer", "s64_b64_packed"}
    report, max_err = {}, 0.0
    for seed, (name, (b, sq, sk, h, kv, dh, causal, window, dtype)) in enumerate(cases.items()):
        q, k, v = flash_inputs(dev, b, sq, sk, h, kv, dh, dtype, 100 + seed)
        routes = dict(tfa.flash_attention_cuda.route_launches)
        got = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        route = tfa.flash_route(dtype, dh)
        routes[route] += 1
        check(tfa.flash_attention_cuda.route_launches == routes, f"flash {name}: not one {route} launch")
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == dtype, f"flash {name}: {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash {name}: output not finite")
        err = float((got.float() - want.float()).abs().max())
        row = {"shape": [b, sq, sk, h, kv, dh], "causal": causal, "window": window,
               "dtype": str(dtype), "route": route, "max_abs_err": err}
        if route == "wgmma":
            plan = tfa.flash_fwd_grid(b, sq, sk, h, dh)
            check(plan == tfa.flash_fwd_grid_on_card(b, sq, sk, h, dh),
                  f"flash {name}: host grid {plan} vs the launcher's")
            check(plan["packed"] == (name in packed_cases), f"flash {name}: grid {plan}")
            row.update(grid=list(plan["grid"]), packed=plan["packed"])
        if dtype == f32:
            check(err <= FLASH_F32_ATOL, f"flash {name}: f32 error {err} > {FLASH_F32_ATOL}")
        else:
            ulps = tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR)
            pure = tfa.bf16_ulps(got, want)
            row.update(max_ulps=float(ulps.max()), ulp_floor=tfa.BF16_ULP_FLOOR,
                       beyond_1_ulp_without_floor=int((pure > 1).sum()),
                       differing=int((got != want).sum()), elements=got.numel())
            check(float(ulps.max()) <= 1.0, f"flash {name}: {float(ulps.max())} bf16 ulps")
            max_err = max(max_err, err)
        report[name] = row
        del q, k, v, got, want
    # a window without causality through models.layers.chunked_attention
    # (ROADMAP C4): one launch per query chunk on the reference's key slice
    # of the chunk, its offsets passed to the kernel, against the plain
    # version on the same chunks and offsets
    from repro_torch.models import layers

    chunked = {  # name: (b, s, h, kv, dh, dtype)
        "noncausal_window300_qchunk512_wgmma": (1, 2048, 8, 2, 128, bf16),
        "noncausal_window300_qchunk512_wgmma_dh256": (1, 2048, 10, 1, 256, bf16),
        "noncausal_window300_qchunk512_simt_f32": (2, 2048, 8, 2, 32, f32),
    }
    for seed, (name, (b, s, h, kv, dh, dtype)) in enumerate(chunked.items()):
        q, k, v = flash_inputs(dev, b, s, s, h, kv, dh, dtype, 200 + seed)
        slices = layers.window_slices(s, s, 300, 512)
        route = tfa.flash_route(dtype, dh)
        routes = dict(tfa.flash_attention_cuda.route_launches)
        got = layers.chunked_attention(q, k, v, causal=False, window=300, q_chunk=512)
        routes[route] += len(slices)
        check(tfa.flash_attention_cuda.route_launches == routes,
              f"flash {name}: not {len(slices)} {route} launches")
        want = torch.cat([
            tfa.flash_attention_plain(q[:, q0:q0 + n], k[:, k0:k0 + span], v[:, k0:k0 + span],
                                      causal=False, window=300, q_offset=q0, k_offset=k0)
            for q0, n, k0, span in slices], dim=1)
        torch.cuda.synchronize()
        check(got.shape == q.shape and bool(torch.isfinite(got).all()), f"flash {name}: output")
        err = float((got.float() - want.float()).abs().max())
        row = {"shape": [b, s, s, h, kv, dh], "causal": False, "window": 300, "q_chunk": 512,
               "slices": [list(sl) for sl in slices], "dtype": str(dtype), "route": route,
               "launches": len(slices), "max_abs_err": err}
        if dtype == f32:
            check(err <= FLASH_F32_ATOL, f"flash {name}: f32 error {err} > {FLASH_F32_ATOL}")
        else:
            ulps = tfa.bf16_ulps(got, want, tfa.BF16_ULP_FLOOR)
            row.update(max_ulps=float(ulps.max()), ulp_floor=tfa.BF16_ULP_FLOOR)
            check(float(ulps.max()) <= 1.0, f"flash {name}: {float(ulps.max())} bf16 ulps")
            max_err = max(max_err, err)
        report[name] = row
        del q, k, v, got, want
    return report, max_err


def zoo_layer_kernel(arch: str | None, window: int | None) -> str:
    """The kernels line's name of flash at a 32k layer of ZOO_DEPTHS' ``arch``
    (None: the name's stem): head_dim 128, causal, with or without a window."""
    stem = f"flash_attention_dh128_{'causal' if window is None else 'window'}"
    return stem if arch is None else f"{stem}_{arch.replace('-', '_').replace('.', '_')}"


def flash_layer(dev, tfa, h: int, kv: int, dh: int, window: int | None, seed: int) -> dict:
    """Flash at one model's 32k attention layer (B 1, prefill_32k's S, causal,
    with ``window`` or none), bf16: the kernel and SDPA (without a window:
    is_causal and enable_gqa; with one: the causal window as a boolean (S,
    S) mask and the kv heads repeated), as CUDA-event medians of
    FLASH_TIMED_REPS pairs around one call, in turns, and the plain version
    over FLASH_PLAIN_REPS pairs; the bound (QK^T and three bf16 P.V products
    over the visible pairs on the tensor cores, or the bytes)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    seq = shape_of("prefill_32k").seq
    q, k, v = flash_inputs(dev, 1, seq, seq, h, kv, dh, torch.bfloat16, seed)
    fns = {"kernel": lambda: tfa.flash_attention_cuda(q, k, v, causal=True, window=window)}
    qt = q.transpose(1, 2)
    if window is None:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        sdpa_kw = {"is_causal": True, "enable_gqa": h != kv}
        library = {"backends": "flash, memory-efficient",
                   "call": f"is_causal=True, enable_gqa={h != kv}"}
    else:
        pos = torch.arange(seq, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kt, vt = (t.transpose(1, 2).repeat_interleave(h // kv, dim=1).contiguous() for t in (k, v))
        sdpa_kw = {"attn_mask": band}
        library = {"backends": "flash, memory-efficient",
                   "mask": f"boolean (S, S) causal window {window}, kv heads repeated"}
    try:  # the yardstick only: the port never calls SDPA
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            torch.cuda.synchronize()
        fns["library"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
    except RuntimeError as err:
        library["not_given"] = str(err).splitlines()[0][:300]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        ms = median_ms(fns, reps=FLASH_TIMED_REPS, calls=1)
    ms.update(median_ms({"plain": lambda: tfa.flash_attention_plain(
        q, k, v, causal=True, window=window)}, reps=FLASH_PLAIN_REPS, calls=1))
    visible = tfa.visible_pairs(seq, seq, True, window) * h
    flops = 2 * dh * visible  # QK^T, and again each P.V product
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return {
        "ms": ms, "shape": [1, seq, h, kv, dh], "causal": True, "window": window,
        "dtype": "bfloat16", "route": tfa.flash_route(torch.bfloat16, dh),
        "bound": bound(nbytes, 4 * flops, BF16_TENSOR_FLOPS),
        "bound_parts_ms": {
            "qk_bf16_tensor": flops / BF16_TENSOR_FLOPS * 1e3,
            "pv_three_bf16_products_tensor": 3 * flops / BF16_TENSOR_FLOPS * 1e3,
            "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "exp_mufu": visible / MUFU_EXP_PER_S * 1e3,
        },
        "visible_pairs": visible, "library": library,
    }


def bf16_ulp_at(scale: float) -> float:
    """The bf16 spacing at magnitude ``scale``: 2**(e - 8) for [2**(e-1), 2**e)."""
    return 2.0 ** (math.frexp(scale)[1] - 8)


def logit_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the logit scale (the largest |want|)."""
    return float((got.float() - want.float()).abs().max()) / bf16_ulp_at(
        float(want.float().abs().max()))


def argmax_rows(got, want, ulps: int) -> tuple[int, int, float]:
    """Rows of (rows, vocab) logits whose argmax agrees, rows whose argmax
    differs where the reference's top-2 margin is at least ``ulps`` bf16 ulps
    of the logit scale (none allowed: a greedy token may differ only at a
    near tie), and the smallest top-2 margin of the reference."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    top2 = w.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = g.argmax(-1) == w.argmax(-1)
    tol = ulps * bf16_ulp_at(float(w.abs().max()))
    return int(same.sum()), int((~same & (margin >= tol)).sum()), float(margin.min())


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def lm_phase(dev, ops, cpu_side: CpuSide) -> dict:
    """granite-3-2b at full width: the 2-layer card-vs-CPU check (its CPU
    side in ``cpu_side``'s worker while the card goes on), the 40-layer
    prefill, prefill against decode, and the serving engine.  Returns what
    the later phases need."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import init_decode_cache, init_lm_params, lm_decode_step, lm_prefill
    from repro_torch.models.lm import padded_vocab
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.train import make_prefill_step

    full = get_config("granite-3-2b")
    vp = padded_vocab(full)
    rng = np.random.default_rng(13)
    no_launch = {name: 0 for name in ops.launch_counts()}

    # 1 the same params on the card and on the CPU, 2 layers: the CPU's run
    # in the worker, checked once the rest of this phase has run on the card
    cut = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)
    p_card = tree_to(init_lm_params(0, cut, "cpu"), dev)
    toks = rng.integers(0, full.vocab, size=(2, 512))
    hand_over_s = cpu_side.hand_over("lm", p_card)
    job = cpu_side.start(lm_cpu_side, "lm", cut, toks)
    card = lm_prefill(p_card, cut, torch.as_tensor(toks, device=dev)).cpu()
    c_card, card_decode = init_decode_cache(cut, 2, 8, dev), []
    for s in range(4):
        t = toks[:, s : s + 1]
        lg_card, c_card = lm_decode_step(p_card, cut, c_card, torch.as_tensor(t, device=dev))
        card_decode.append(lg_card.cpu())
    del p_card, c_card

    def check_cut() -> None:
        host, worker = job.result()
        prefill_ulps = logit_ulps(card, host["prefill"])
        check(prefill_ulps <= LOGIT_ULPS, f"lm 2-layer prefill: card vs CPU {prefill_ulps} ulps")
        argmax = [argmax_rows(card, host["prefill"], LOGIT_ULPS)]
        decode_ulps = []
        for lg_card, lg_cpu in zip(card_decode, host["decode"]):
            decode_ulps.append(logit_ulps(lg_card, lg_cpu))
            argmax.append(argmax_rows(lg_card, lg_cpu, LOGIT_ULPS))
        check(max(decode_ulps) <= LOGIT_ULPS, f"lm 2-layer decode: card vs CPU {decode_ulps} ulps")
        check(all(bad == 0 for _, bad, _ in argmax),
              f"lm 2-layer: an argmax differs away from a near tie: {argmax}")
        emit({
            "phase": "lm", "part": "card_vs_cpu", "arch": full.name,
            "cut": f"n_layers {LM_CUT_LAYERS} of {full.n_layers}; full width",
            "prefill_batch_seq": [2, 512], "prefill_logit_ulps": prefill_ulps,
            "prefill_logit_scale": float(host["prefill"].float().abs().max()),
            "decode_logit_ulps": decode_ulps,
            "argmax_same_of_2": [a for a, _, _ in argmax],
            "min_top2_margin": [m for _, _, m in argmax], "tol_ulps": LOGIT_ULPS,
            "bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "cpu_side": {**worker, "cpu_s": host["seconds"], "hand_over_s": hand_over_s},
        })

    # 2 forty layers, initialised on the card
    t0 = time.perf_counter()
    params = init_lm_params(0, full, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill_step(full)
    shape = shape_of("prefill_32k")
    batch = {"tokens": torch.as_tensor(rng.integers(0, full.vocab, size=(shape.batch, shape.seq)),
                                       device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = dict(ops.flash_attention_mod.flash_attention_cuda.route_launches)
    check(launches == {**no_launch, "flash_attention": full.n_layers},
          f"32k prefill launches {launches}, want {full.n_layers} flash launches")
    check(routes == {"wgmma": full.n_layers, "simt": 0},
          f"32k prefill flash routes {routes}, want all {full.n_layers} on wgmma")
    check(logits.shape == (shape.batch, vp) and bool(torch.isfinite(logits).all()),
          "32k prefill logits")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit({
        "phase": "lm", "part": "prefill_32k", "arch": full.name, "n_layers": full.n_layers,
        "params": n_params, "param_bytes_f32": n_params * 4, "init_s": init_s,
        "batch_seq": [shape.batch, shape.seq],
        "cut": f"global batch 32 of prefill_32k cut to {shape.batch}",
        "first_call_ms": first_s * 1e3, "ms": steady_s * 1e3,
        "tokens_per_s": shape.batch * shape.seq / steady_s, "max_memory_allocated": peak,
        "launches": launches, "flash_routes": routes,
        "logit_scale": float(logits.float().abs().max()),
    })

    # prefill (the kernel) against sequential decode (plain einsum), 40 layers
    prompt = torch.as_tensor(rng.integers(0, full.vocab, size=(1, 5)), device=dev)
    want = lm_prefill(params, full, prompt)
    cache = init_decode_cache(full, 1, 8, dev)
    for s in range(5):
        got, cache = lm_decode_step(params, full, cache, prompt[:, s : s + 1])
    got = got[:, 0]
    depth_ulps = logit_ulps(got, want)
    same, bad, margin = argmax_rows(got, want, DEPTH_LOGIT_ULPS)
    check(depth_ulps <= DEPTH_LOGIT_ULPS, f"prefill vs decode: {depth_ulps} ulps")
    check(bad == 0, f"prefill vs decode: argmax differs at top-2 margin {margin}")
    emit({"phase": "lm", "part": "prefill_vs_decode", "prompt_len": 5,
          "logit_ulps": depth_ulps, "tol_ulps": DEPTH_LOGIT_ULPS, "argmax_same": bool(same),
          "top2_margin": margin})
    del cache, got, want

    # the serving engine with the launcher's defaults
    def requests():
        return [Request(prompt=[(r * 7 + i) % full.vocab for i in range(5)], max_new_tokens=12)
                for r in range(6)]

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(params, full, batch_size=4, max_len=128, device=dev)
        for r in requests():
            engine.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine_launches = ops.launch_counts()
        check(engine_launches == no_launch, f"serving launched kernels: {engine_launches}")
        check(len(done) == 6 and all(r.done and len(r.generated) == 12 for r in done),
              "serving: not every request done with 12 tokens")
        runs.append({"tokens": [r.generated for r in done], "wall_s": wall, "steps": engine.steps,
                     "peak": torch.cuda.max_memory_allocated()})
        del engine
    check(runs[0]["tokens"] == runs[1]["tokens"], "serving: a second engine gave other tokens")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launched = serve_launcher.main(["--arch", full.name, "--device", str(dev)])
    check([r.generated for r in launched] == runs[0]["tokens"],
          "the launcher's tokens differ from the engine's (same seed, same card)")
    total = sum(len(t) for t in runs[0]["tokens"])
    emit({
        "phase": "lm", "part": "serve", "requests": 6, "batch": 4, "new_tokens": 12,
        "max_len": 128, "steps": runs[0]["steps"], "tokens": total,
        "wall_s": [r["wall_s"] for r in runs],
        "ms_per_step": [r["wall_s"] / r["steps"] * 1e3 for r in runs],
        "tokens_per_s": [total / r["wall_s"] for r in runs],
        "max_memory_allocated": [r["peak"] for r in runs], "launches": no_launch,
        "first_tokens": runs[0]["tokens"][:2], "launcher": out.getvalue().strip().splitlines()[0],
    })
    check_cut()
    return {"cfg": full, "params": params, "prefill": prefill, "batch": batch, "launches": launches,
            "flash_routes": routes, "ms": steady_s * 1e3, "max_memory_allocated": peak}


# the probe phase: examples/torch_fednl_probe.py at granite-3-2b's full
# width, FedNL at d = d_model = 2,048 on the backbone's features
PROBE_ARCH = "granite-3-2b"
PROBE_CLIENTS, PROBE_SAMPLES = 8, 64  # the reference example's defaults
PROBE_CPU_ROUNDS = 3  # (c): the card's first rounds against the CPU's on the card's z
# (a): the features on the card against the CPU at the lm phase's depth cut,
# in bf16 ulps of the feature scale (the largest |feature|), the lm phase's
# bound on its logits
PROBE_FEATURE_ULPS = LOGIT_ULPS


@functools.cache
def probe_example():
    """``examples/torch_fednl_probe.py`` as a module: the probe phase drives
    the example's own functions."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_fednl_probe", ROOT / "examples" / "torch_fednl_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def probe_flash_launches(cfg) -> int:
    """The flash launches of one backbone call of the probe: one for each
    attention call of a forward through the blocks (granite-3-2b: 40)."""
    return train_attention_calls(cfg)


def probe_dims(cfg) -> dict:
    """The probe's FedNL problem at ``cfg``'s width: the example's clients and
    samples, d = d_model, T = d (d + 1) / 2 and the example spec's k."""
    d = cfg.d_model
    k = probe_example().probe_spec().fednl_config().k_for(d)
    return {"clients": PROBE_CLIENTS, "n_i": PROBE_SAMPLES, "d": d, "t": d * (d + 1) // 2, "k": k}


def probe_kernel_inputs(dev, cfg) -> dict:
    """Seeded inputs of the probe's three kernels at ``cfg``'s width: SYRK's z
    (unit rows, as the probe's features) and curvature weights, TopLEK's rows
    (standard normal, a dense correction) and Bernoulli uniforms, and flash's
    q, k, v at one backbone call's layer (B clients x samples, S the
    example's sequence, the config's heads)."""
    import torch

    dims, seq = probe_dims(cfg), probe_example().SEQ
    n, n_i, d, t = dims["clients"], dims["n_i"], dims["d"], dims["t"]
    rng = np.random.default_rng(20)
    feats = rng.standard_normal((n * n_i, d))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    sigma = rng.uniform(0.0, 1.0, size=(n, n_i))
    return {
        "z": torch.as_tensor(feats.reshape(n, n_i, d), device=dev),
        "hw": torch.as_tensor(sigma * (1.0 - sigma) / n_i, device=dev),
        "u": torch.as_tensor(rng.standard_normal((n, t)), device=dev),
        "unif": torch.as_tensor(rng.uniform(size=n), device=dev),
        "qkv": flash_inputs(dev, n * n_i, seq, seq, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                            torch.bfloat16, 21),
        **dims,
    }


def probe_kernel_times(dev, tfa, probe_in: dict, lam: float) -> dict:
    """The probe's three kernels at its shapes (probe_kernel_inputs, held
    against their plain versions in phase 3): each timed beside its plain
    version and its library call (SYRK: torch.bmm; TopLEK: torch.topk on
    the f32 keys, the ranking only; flash: SDPA is_causal, enable_gqa), with
    its bound."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.compressors.select import rank_keys
    from repro_torch.kernels.compressor_select import (select_toplek_cuda, select_toplek_plain,
                                                       toplek_memory_path, toplek_spread)
    from repro_torch.kernels.hessian_syrk import (hessian_syrk_packed_cuda,
                                                  hessian_syrk_packed_plain)

    z, hw, u, unif, k = (probe_in[name] for name in ("z", "hw", "u", "unif", "k"))
    zs, keys = hw[..., None] * z, rank_keys(u)
    q, kk, v = probe_in["qkv"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    b, seq, h, dh = q.shape
    ms = {
        "hessian_syrk_packed": median_ms({
            "kernel": lambda: hessian_syrk_packed_cuda(z, hw, lam),
            "plain": lambda: hessian_syrk_packed_plain(z, hw, lam),
            "library": lambda: torch.bmm(z.mT, zs)}),
        "select_toplek": median_ms({
            "kernel": lambda: select_toplek_cuda(u, k, unif),
            "plain": lambda: select_toplek_plain(u, k, unif),
            "ranking_only": lambda: torch.topk(keys, k, dim=-1)}),
    }
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        ms["flash_attention"] = median_ms({
            "kernel": lambda: tfa.flash_attention_cuda(q, kk, v, causal=True),
            "plain": lambda: tfa.flash_attention_plain(q, kk, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=h != kk.shape[2])})
    bounds = fednl_round_bounds(probe_in["clients"], probe_in["n_i"], probe_in["d"], k)
    visible = tfa.visible_pairs(seq, seq, True, None) * h * b
    flops = 2 * dh * visible  # QK^T, and again each P.V product
    nbytes = (2 * q.numel() + kk.numel() + v.numel()) * q.element_size()
    bounds["flash_attention"] = bound(nbytes, 4 * flops, BF16_TENSOR_FLOPS)
    shapes = {"hessian_syrk_packed": list(z.shape), "select_toplek": list(u.shape),
              "flash_attention": [b, seq, h, kk.shape[2], dh]}
    out = {name: {**ms[name], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                  "shape": shapes[name]} for name in ms}
    # the routes timed: TopLEK's memory path (3: the spread route, two CUDA
    # kernels a call), flash's grid (packed: 128 / S sequences a block)
    out["select_toplek"].update(memory_path=toplek_memory_path(u.shape[1], k, dev),
                                blocks_a_client=toplek_spread(u.shape[0], dev))
    plan = tfa.flash_fwd_grid_on_card(b, seq, seq, h, dh)
    out["flash_attention"].update(grid=list(plan["grid"]), packed=plan["packed"])
    counts = fednl_round_counts(probe_in["clients"], probe_in["n_i"], probe_in["d"], k)
    emit({"phase": "times", "part": "probe_shapes", "k": k,
          "counts": {name: counts[name] for name in ("hessian_syrk_packed", "select_toplek")},
          "flash_visible_pairs": visible, **out,
          "note": f"ms per call: median over {TIMED_REPS} event pairs around {CALLS_PER_EVENT} "
                  "back-to-back calls, in turns; TopLEK has no library call: ranking_only = "
                  "torch.topk on the f32 keys; flash library = SDPA(is_causal, enable_gqa) on "
                  "the flash or memory-efficient backend, p rounded to bf16"})
    return out


def probe_cpu_side(key: str, cut, tokens) -> dict:
    """CpuSide job: the probe's backbone features at the depth cut ``cut`` on
    the CPU, on the params held under ``key``."""
    t0 = time.perf_counter()
    feats = probe_example().backbone_features(_HELD.pop(key), cut, tokens)
    return {"feats": feats, "seconds": time.perf_counter() - t0}


def count_syncs_at(step) -> tuple[int, dict]:
    """``count_syncs``, and where each sync was asked for: the warnings by
    the innermost frame of this repository on the stack when each was
    raised, the innermost frame outside it, and the message."""
    import traceback

    import torch

    sites: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith(
            os.sep + "warnings.py")]
        ours = [f for f in frames if f.filename.startswith(str(ROOT))
                and not f.name.startswith(("count_syncs", "<lambda>"))]
        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} ({f.name})" for f in ours[-1:]]
        if frames and (not ours or frames[-1] is not ours[-1]):
            where.append(f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno} "
                         f"({frames[-1].name})")
        site = (" via ".join(where) or f"{filename}:{lineno}") + f": {str(message)[:120]}"
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(sites.values()), sites


def probe_phase(dev, ops, tfa, lm: dict | None, cpu_side: CpuSide) -> dict:
    """The probe at granite-3-2b's full width and depth (d = 2,048), through
    the example's functions: (a) the features of one backbone call on the
    card (exactly probe_flash_launches' flash launches, all wgmma, nothing
    else) and, at the lm phase's 2-layer cut of the same params, against the
    CPU worker's within PROBE_FEATURE_ULPS; (b) FedNL on them on the card to
    tol 1e-13 or 100 rounds: rounds, grad norm, accuracy, ms a round,
    launches, one round without a host sync (each would be named by the
    line that asked for it), one round profiled; (c) its first
    PROBE_CPU_ROUNDS rounds against the CPU's on the card's z, in the
    worker.  ``lm``: the lm phase's result, whose params it reuses (else
    seed 0's are drawn).  Returns what the kernels line needs, and
    ``finish``, which checks (a)'s cut once ``job``, its CPU side, is in."""
    import torch

    from repro_torch.api import solve
    from repro_torch.configs import get_config
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.kernels.compressor_select import toplek_memory_path
    from repro_torch.models import init_lm_params

    probe = probe_example()
    full = get_config(PROBE_ARCH)
    params = lm["params"] if lm is not None else init_lm_params(0, full, dev)
    dims = probe_dims(full)
    labels, tokens = probe.probe_data(full, dims["clients"], dims["n_i"])
    no_launch = {name: 0 for name in ops.launch_counts()}

    # (a) the depth cut's CPU side first, in the worker, then the card
    cut = dataclasses.replace(full, n_layers=LM_CUT_LAYERS)

    def first_layers(tree):
        return ({name: first_layers(leaf) for name, leaf in tree.items()}
                if isinstance(tree, dict) else tree[:LM_CUT_LAYERS])

    p_cut = {**params, "blocks": first_layers(params["blocks"])}
    hand_over_s = cpu_side.hand_over("probe", p_cut)
    job = cpu_side.start(probe_cpu_side, "probe", cut, tokens)
    card_cut = probe.backbone_features(p_cut, cut, tokens).cpu()
    del p_cut

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    routes0 = dict(tfa.flash_attention_cuda.route_launches)
    t0 = time.perf_counter()
    feats = probe.backbone_features(params, full, tokens)
    torch.cuda.synchronize()
    features_ms = (time.perf_counter() - t0) * 1e3
    feature_launches = ops.launch_counts()
    routes = {r: n - routes0[r] for r, n in tfa.flash_attention_cuda.route_launches.items()}
    want_flash = probe_flash_launches(full)
    check(feature_launches == {**no_launch, "flash_attention": want_flash},
          f"probe backbone launches {feature_launches}, want {want_flash} flash launches")
    check(routes == {"wgmma": want_flash, "simt": 0}, f"probe backbone flash routes {routes}")
    n_total = dims["clients"] * dims["n_i"]
    check(feats.shape == (n_total, full.d_model) and feats.dtype == torch.float64
          and bool(torch.isfinite(feats).all()), "probe features not finite or misshapen")
    feats, z = probe.probe_problem(feats.cpu().numpy(), labels, dims["clients"], dims["n_i"])
    check(z.shape == (dims["clients"], dims["n_i"], dims["d"]), f"probe z {z.shape}")

    # (b) FedNL on the features, on the card; (c)'s CPU rounds queued first
    spec = probe.probe_spec()
    cpu_job = cpu_side.submit(solve_cpu_side, spec.replace(rounds=PROBE_CPU_ROUNDS, tol=0.0), z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = solve(spec, z=z)
    launches = ops.launch_counts()
    want = {**no_launch, "select_toplek": rep.rounds + 1, "hessian_syrk_packed": rep.rounds + 2}
    check(launches == want, f"probe solve launches {launches}, want {want} "
                            f"for {rep.rounds} rounds + warm-up (+ init)")
    gn = rep.grad_norms
    check(bool(np.all(np.isfinite(gn))) and bool(np.all(np.isfinite(rep.x))), "probe: not finite")
    check(gn[-1] <= spec.tol or rep.rounds == spec.rounds, f"probe stopped at {rep.rounds}")
    check(gn[-1] < gn[0] * 1e-6, f"probe grad norms {gn[0]} -> {gn[-1]}")
    accuracy = probe.probe_accuracy(feats, labels, rep.x)
    check(0.5 < accuracy <= 1.0, f"probe accuracy {accuracy}")
    solve_peak = torch.cuda.max_memory_allocated()

    # one round: its launches, its host syncs (none), where its device time goes
    cfg = spec.fednl_config()
    z_card = torch.as_tensor(z, device=dev)
    round_fn = make_fednl_round(z_card, cfg)
    state = round_fn(fednl_init(z_card, cfg))[0]  # the warm-up: caches filled
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    # the control: the counting alone (the first switch of the debug mode in
    # a process warns once, and is no sync)
    empty_syncs, empty_sites = count_syncs_at(lambda: None)
    syncs, sync_sites = count_syncs_at(lambda: round_fn(state))
    torch.cuda.synchronize()
    check(syncs == 0, f"probe round: {syncs} host syncs: {sync_sites}")
    round_launches = {name: n for name, n in ops.launch_counts().items() if n}
    check(round_launches == {"hessian_syrk_packed": 1, "select_toplek": 1},
          f"probe round launches {round_launches}")
    traced = trace_rounds(round_fn, state, 1, marks=("toplek",))
    del state, round_fn, z_card
    # TopLEK's CUDA kernels a call, as the profile saw them: two on the
    # spread route (path 3), one on the others
    toplek_path = toplek_memory_path(dims["t"], dims["k"], dev)
    toplek_kernels = traced.get("launches_by_mark", {}).get("toplek")
    toplek_a_call = ("not measured (no device events)" if toplek_kernels is None
                     else sum(toplek_kernels.values()) / round_launches["select_toplek"])
    if toplek_kernels is not None:
        want_kernels = 2 if toplek_path == 3 else 1
        check(toplek_a_call == want_kernels and len(toplek_kernels) == want_kernels,
              f"probe round: TopLEK's CUDA kernels {toplek_kernels} on path {toplek_path}, "
              f"want {want_kernels} a call")

    # (c) the first rounds against the CPU's
    rep_cpu, worker = cpu_job.result()
    r = PROBE_CPU_ROUNDS
    rel = np.abs(gn[:r] - rep_cpu.grad_norms) / rep_cpu.grad_norms
    check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"probe card vs CPU grad norms: {rel}")
    differ = [i for i in range(r) if rep.sent_bits[i] != rep_cpu.sent_bits[i]]
    for i in differ:  # phase 3's boundary allowance: a kept count one off a client
        d_elems = abs(rep.records[i].sent_elems - rep_cpu.records[i].sent_elems)
        check(0 < d_elems <= dims["clients"], f"probe round {i}: sent_elems differ by {d_elems}")

    out = {
        "phase": "probe", "arch": full.name, "n_layers": full.n_layers, **dims,
        "features": {"batch_seq": [n_total, probe.SEQ], "ms": features_ms,
                     "launches": feature_launches, "flash_routes": routes},
        "solve": {"rounds": rep.rounds, "final_grad_norm": float(gn[-1]), "tol": spec.tol,
                  "accuracy": accuracy, "ms_per_round": rep.wall_time_s / rep.rounds * 1e3,
                  "init_time_s": rep.init_time_s, "wall_time_s": rep.wall_time_s,
                  "sent_bits_per_round": float(np.mean(rep.sent_bits)),
                  "launches": launches, "max_memory_allocated": solve_peak},
        "round": {"launches": round_launches, "host_syncs": syncs, "sync_sites": sync_sites,
                  "empty_step_syncs": empty_syncs, "empty_step_sites": empty_sites,
                  "toplek_memory_path": toplek_path, "toplek_cuda_kernels_a_call": toplek_a_call,
                  **traced},
        "card_vs_cpu_rounds": {"rounds": r, "grad_norms": gn[:r].tolist(),
                               "cpu_grad_norms": rep_cpu.grad_norms.tolist(),
                               "rel_err": rel.tolist(), "rtol": TRAJECTORY_RTOL,
                               "sent_bits": rep.sent_bits[:r].tolist(),
                               "cpu_sent_bits": rep_cpu.sent_bits.tolist(),
                               "boundary_rounds": differ, "cpu_side": worker},
    }
    emit(out)

    def finish() -> None:
        """(a)'s depth cut against the CPU worker's, once its CPU side is in."""
        host, cut_worker = job.result()
        scale = float(host["feats"].abs().max())
        ulps = float((card_cut - host["feats"]).abs().max()) / bf16_ulp_at(scale)
        check(ulps <= PROBE_FEATURE_ULPS, f"probe 2-layer features: card vs CPU {ulps} ulps")
        emit({"phase": "probe", "part": "features_card_vs_cpu", "arch": full.name,
              "cut": f"n_layers {LM_CUT_LAYERS} of {full.n_layers}; full width",
              "batch_seq": [n_total, probe.SEQ], "max_ulps": ulps,
              "tol_ulps": PROBE_FEATURE_ULPS, "feature_scale": scale,
              "cpu_side": {**cut_worker, "cpu_s": host["seconds"], "hand_over_s": hand_over_s}})

    return {"solve_launches": launches, "feature_launches": feature_launches, "emitted": out,
            "job": job, "finish": finish}


# phase zoo: each family's full-width config, its 32k prefill's flash
# launches by route: attention layers x launches a layer
ZOO_FLASH_ROUTES = {
    "granite-moe-1b-a400m": {"wgmma": 24, "simt": 0},
    "mamba2-2.7b": {"wgmma": 0, "simt": 0},  # no attention
    "recurrentgemma-2b": {"wgmma": 8, "simt": 0},  # layers i % 3 == 2 of 26, head_dim 256
    "llava-next-mistral-7b": {"wgmma": 32, "simt": 0},
    "seamless-m4t-large-v2": {"wgmma": 72, "simt": 0},  # 24 encoder + 24 self + 24 cross
    # the dense configs granite-3-2b does not cover, head_dim 128 causal
    # without a window, at ZOO_DEPTHS' prefill depth
    "chatglm3-6b": {"wgmma": 28, "simt": 0},  # H 32, Kv 2; rotary on half the head dims
    "nemotron-4-15b": {"wgmma": 32, "simt": 0},  # H 48, Kv 8; squared ReLU, untied 256k head
    "yi-34b": {"wgmma": 28, "simt": 0},  # H 56, Kv 8, d_model 7168: 28 of its 60 layers
    # H 48, Kv 8, causal window 4,096; 8 experts top-2 of d_ff 16,384: at
    # ZOO_DEPTHS' prefill depth, 6 of its 56 layers
    "mixtral-8x22b": {"wgmma": 6, "simt": 0},
}
# the depths at which the zoo runs the configs that do not fit the card
# whole: (b) and (c) at the first, (d) at the second (ServeEngine holds a
# bf16 copy of its params beside the caller's f32 ones).  Each is the
# config's depth or the deepest cut whose f32 params (for (d): and the bf16
# copy) fit the config's budget, zoo_param_budget: 80 GB less what a 32k
# prefill adds above its params (the bf16 embedding and head, a layer's
# bf16 weights, its activations at S 32,768; phase line b's
# max_memory_allocated - memory_allocated_before)
ZOO_PARAM_BYTES_MAX = 67e9
ZOO_DEPTHS = {  # arch: (layers of (b) and (c), layers of (d))
    "chatglm3-6b": (28, 28),  # full depth: 23.9 GB f32, 35.9 GB with the engine's copy
    "nemotron-4-15b": (32, 20),  # 62.5 GB; the engine at 20 of 32 layers: 65.7 GB
    "yi-34b": (28, 18),  # 66.2 GB at 28 of 60 layers; the engine at 18: 65.8 GB
    # 10.0 GB of f32 params a layer (8 experts of 3 x 6,144 x 16,384) and
    # 1.6 GB beside them: 61.7 GB at 6 of 56 layers; the engine at 4: 62.5 GB
    "mixtral-8x22b": (6, 4),
}
# the moe's own budget: its 32k prefill holds more above its params than a
# dense one -- at B 1, S 32,768 each of the 8 experts takes a queue of 1.25
# x 32,768 x 2 / 8 = 10,240 rows (moe.py's capacity), so the experts' three
# (8, 10,240, 16,384) bf16 products and the combine's f32 values.  Measured
# (scripts/train_depth_probe.py --prefill mixtral-8x22b:1,2,5,6, NVIDIA H100
# 80GB HBM3, 700.00 W): 13.49 GB above the params at 1 layer, 13.89 GB at
# 2, 5 and 6 (peak 75.67 GB at 6); less 1.5 GB for earlier phases' tensors
# (0.8-1.4 GB at the zoo's prefills).  The engine at 5 layers held 77.65 GB
MIXTRAL_PREFILL_PEAK_ABOVE = 13.89e9
ZOO_PARAM_BUDGET = {"mixtral-8x22b": 80e9 - MIXTRAL_PREFILL_PEAK_ABOVE - 1.5e9}  # 64.6 GB


def zoo_param_budget(arch: str) -> float:
    """The bytes of params (and ServeEngine's copy) the zoo's cuts of
    ``arch`` may hold: ZOO_PARAM_BUDGET's, or ZOO_PARAM_BYTES_MAX."""
    return ZOO_PARAM_BUDGET.get(arch, ZOO_PARAM_BYTES_MAX)


def zoo_param_bytes(cfg, n_layers: int, engine: bool) -> int:
    """The bytes of ``cfg``'s f32 params at ``n_layers`` (counted on meta)
    and, with ``engine``, of ServeEngine's bf16 copy beside them."""
    from repro_torch.models.lm import cast_for_compute, init_lm_params

    params = init_lm_params(0, dataclasses.replace(cfg, n_layers=n_layers), "meta")
    trees = [params, cast_for_compute(params)] if engine else [params]
    return sum(t.numel() * t.element_size() for tree in trees for t in _leaves(tree))


@contextlib.contextmanager
def record_router_inputs(outputs: list | None = None):
    """Record (on the CPU) the argument of every ``moe_apply`` call of the
    port's LM code, in call order (and its result into ``outputs``)."""
    from repro_torch.models import lm as tlm

    calls, orig = [], tlm.moe_apply

    def rec(x, *a, **kw):
        calls.append(x.detach().to("cpu", copy=True))
        out = orig(x, *a, **kw)
        if outputs is not None:
            outputs.append(out.detach().to("cpu", copy=True))
        return out

    tlm.moe_apply = rec
    try:
        yield calls
    finally:
        tlm.moe_apply = orig


def route_table(h, router, cfg):
    """Per token of h (B, S, D): its experts (sorted), their kept flags and
    the router's probabilities, as the port's dispatch computes them on h's
    device; returned on the CPU."""
    import torch

    from repro_torch.models.moe import moe_dispatch

    m = cfg.moe
    t = h.shape[0] * h.shape[1]
    r = moe_dispatch(h, router, n_experts=m.n_experts, top_k=m.top_k,
                     capacity_factor=m.capacity_factor)
    experts = torch.empty(t * m.top_k, dtype=torch.long, device=h.device)
    kept = torch.empty(t * m.top_k, dtype=torch.bool, device=h.device)
    experts[r["order"]], kept[r["order"]] = r["se"], r["keep"]
    experts, kept = experts.reshape(t, m.top_k), kept.reshape(t, m.top_k)
    idx = experts.argsort(dim=-1)
    probs = torch.softmax(h.reshape(t, -1).float() @ router.float(), dim=-1)
    return experts.gather(-1, idx).cpu(), kept.gather(-1, idx).cpu(), probs.cpu()


def routing_differences(card, host, pos0: int, first: dict):
    """Compare two runs' route tables of one call (tokens of B rows of S
    positions from ``pos0``): a token may route otherwise only at a near tie
    (the host's k-th and (k+1)-th probabilities within twice the runs' largest
    probability difference) and a kept flag may differ only where some
    assignment flipped (the capacity queues shift).  Rows past their first
    difference (``first``: batch row -> position) are not compared.  Returns
    the updated ``first``, the call's counts and its differing tokens (a
    (B, S) mask)."""
    import torch

    (ec, kc, pc, b, s), (eh, kh, ph, _, _) = card, host
    k = ec.shape[1]
    pos = pos0 + torch.arange(b * s) % s
    row = torch.arange(b * s) // s
    live = torch.tensor([int(p) < first.get(int(r), 1 << 30) for r, p in zip(row, pos)])
    counts = {"tokens": int(live.sum()), "flipped": 0, "queue_shifted": 0}
    if not bool(live.any()):
        return first, counts, torch.zeros((b, s), dtype=torch.bool)
    delta = float((pc - ph).abs()[live].max())
    top = ph.sort(dim=-1, descending=True).values
    margin = top[:, k - 1] - top[:, k]
    flipped = live & (ec != eh).any(-1)
    shifted = live & ~flipped & (kc != kh).any(-1)
    worst = float(margin[flipped].max()) if bool(flipped.any()) else 0.0
    check(worst <= 2 * delta, f"moe: a token routes otherwise at margin {worst} > 2 x {delta}")
    check(not bool(shifted.any()) or bool(flipped.any()),
          "moe: a kept flag differs with no assignment flipped")
    first = dict(first)
    for t in torch.nonzero(flipped | shifted).flatten().tolist():
        first[int(row[t])] = min(first.get(int(row[t]), int(pos[t])), int(pos[t]))
    counts.update(flipped=int(flipped.sum()), queue_shifted=int(shifted.sum()),
                  max_prob_diff=delta)
    return first, counts, (flipped | shifted).reshape(b, s)


def moe_routes(calls_card, calls_host, cfg, routers, pos0: int, first: dict):
    """``routing_differences`` over one run's calls (call c is layer c %
    n_layers)."""
    counts = []
    for c, (hc, hh) in enumerate(zip(calls_card, calls_host)):
        router = routers[c % cfg.n_layers]
        card = (*route_table(hc, router, cfg), *hc.shape[:2])
        host = (*route_table(hh, router, cfg), *hh.shape[:2])
        first, n, _ = routing_differences(card, host, pos0, first)
        counts.append(n)
    return first, counts


def moe_module_check(cut, p_card, routers, calls_host, module_host, dev) -> dict:
    """Each layer's ``moe_apply`` on the card against the CPU's
    (``module_host``, moe_module_outputs in the worker) on the same input
    (the CPU run's router input): routing by the near-tie rule (the CPU's
    from ``routers``, the routers' host copy), and the output rows of tokens
    routed alike within LOGIT_ULPS of the output's scale."""
    report = []
    outs = moe_module_outputs(cut, p_card, [h.to(dev) for h in calls_host])
    for layer, (h, out, want) in enumerate(zip(calls_host, outs, module_host)):
        got = out.cpu()
        card = (*route_table(h.to(dev), routers[layer].to(dev), cut), *h.shape[:2])
        host = (*route_table(h, routers[layer], cut), *h.shape[:2])
        _, counts, differing = routing_differences(card, host, 0, {})
        err = float((got.float() - want.float()).abs()[~differing].max())
        ulps = err / bf16_ulp_at(float(want.float().abs().max()))
        check(ulps <= LOGIT_ULPS, f"moe layer {layer}: card vs CPU on one input {ulps} ulps")
        report.append({"layer": layer, "tokens": h.shape[0] * h.shape[1], **counts,
                       "output_ulps": ulps})
    return {"per_layer": report}


def zoo_inputs(cfg, batch: int, seq: int, rng, dev) -> dict:
    """A prefill batch of ``seq`` positions: tokens, and for vlm 576 image
    embeddings in front of seq - 576 tokens, for encdec a source of ``seq``
    frames (numpy draws)."""
    import torch

    n_img = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, size=(batch, seq - n_img)), device=dev)}
    if n_img:
        out["img_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, n_img, cfg.d_model), dtype=np.float32), device=dev)
    if cfg.family == "encdec":
        out["src_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32), device=dev)
    return out


def zoo_cut(arch: str):
    """``arch``'s zoo depth cut: 2 layers (hybrid 3, so that one is
    attention; encdec 2 + 2) at full width."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    encdec = full.family == "encdec"
    return dataclasses.replace(full, n_layers=3 if full.family == "hybrid" else LM_CUT_LAYERS,
                               encoder_layers=LM_CUT_LAYERS if encdec else 0)


def zoo_cut_batch(cut, rng):
    """(a)'s prefill batch, B 2, S 512 (vlm: after its images; encdec: a
    512-frame source), the first draw of the family's rng."""
    return zoo_inputs(cut, 2, 512 + (cut.n_frontend_tokens if cut.family == "vlm" else 0), rng,
                      "cpu")


# (e): the reference's long_500k shape (launch.specs.SHAPES: B 1, S 524,288)
# decoded from a full ring cache: LONG_STEPS steps from position LONG_POS,
# the last at the shape's last position but one
LONG_ARCHS = ("mixtral-8x22b",)  # the sliding-window config's ring past its wrap
LONG_POS, LONG_STEPS, LONG_SEED = 524_283, 4, 23


def long_500k_inputs(cfg, device="cpu") -> tuple[dict, np.ndarray]:
    """``cfg``'s decode cache at long_500k (B 1; attention's k and v a ring
    of its window, cache_window) at pos LONG_POS, every leaf a numpy
    standard-normal draw from LONG_SEED (rounded to the leaf's dtype, so a
    card's and a host's copies hold the same bits), on ``device``; and the
    LONG_STEPS tokens (1, LONG_STEPS) to decode from it, drawn after."""
    import torch

    from repro_torch.models.lm import init_decode_cache

    shape = shape_of("long_500k")
    zeros = init_decode_cache(cfg, shape.batch, shape.seq, "cpu")
    rng = np.random.default_rng(LONG_SEED)
    cache = {"pos": LONG_POS}
    for key in sorted(k for k in zeros if k != "pos"):
        draw = torch.as_tensor(rng.standard_normal(zeros[key].shape, dtype=np.float32))
        cache[key] = draw.to(zeros[key].dtype).to(device)
    return cache, rng.integers(0, cfg.vocab, size=(shape.batch, LONG_STEPS))


def zoo_hand_over(arch: str, dev, cpu_side: CpuSide) -> dict:
    """(a)'s CPU side started early: the depth cut's params drawn on the
    card from seed 0 (the same bits each draw), their cast_for_compute copy
    handed over to ``cpu_side``'s worker, the card's freed, and zoo_cpu_side
    started on the batch (B 2, S 512) and, for LONG_ARCHS, the long_500k
    decode."""
    import torch

    from repro_torch.models import encdec as ted
    from repro_torch.models import lm as tlm

    cut = zoo_cut(arch)
    init = ted.init_encdec_params if cut.family == "encdec" else tlm.init_lm_params
    cast = tlm.cast_for_compute(init(0, cut, dev))
    key = f"zoo/{arch}"  # the worker's keys: the train phase's cut of arch is another
    hand_over_s = cpu_side.hand_over(key, cast)
    del cast
    torch.cuda.empty_cache()
    job = cpu_side.start(zoo_cpu_side, key, cut, zoo_cut_batch(cut, np.random.default_rng(17)),
                         arch in LONG_ARCHS)
    return {"job": job, "hand_over_s": hand_over_s}


def long_decode_check(cut, card: tuple, host_out: dict, routers) -> dict:
    """(e) at the depth cut: the card's LONG_STEPS decode steps from
    long_500k_inputs' ring cache (``card``: their logits, router inputs and
    the cache after them, on the CPU) against the worker's from the same
    bits: pos exact; on both, step s wrote slot (LONG_POS + s) % window of
    every layer's k and v and changed no other slot; the logits and the
    written slots within LOGIT_ULPS (moe: the row held until its routing
    differs, routing_differences)."""
    start, _ = long_500k_inputs(cut)
    logits, calls, cache = card
    window = start["k"].shape[2]
    slots = [(LONG_POS + s) % window for s in range(LONG_STEPS)]
    pos = (cache["pos"], host_out["long_cache"]["pos"])
    check(pos == (LONG_POS + LONG_STEPS,) * 2, f"long_500k decode: pos {pos}")
    first, routing, logit_err = {}, [], []
    for s in range(LONG_STEPS):
        if cut.family == "moe":
            first, counts = moe_routes(calls[s], host_out["long_decode_calls"][s], cut, routers,
                                       LONG_POS + s, first)
            routing.append(counts)
        if 0 not in first:  # B 1: its one row
            logit_err.append(logit_ulps(logits[s], host_out["long_decode"][s]))
    check(all(u <= LOGIT_ULPS for u in logit_err), f"long_500k decode: logits {logit_err} ulps")
    held = [slot for s, slot in enumerate(slots) if LONG_POS + s < first.get(0, 1 << 62)]
    slot_err = {}
    for key in ("k", "v"):
        for side, got in (("card", cache[key]), ("cpu", host_out["long_cache"][key])):
            changed = (got != start[key]).any(-1).any(-1).any(1)  # (layers, window)
            check(all(sorted(row.nonzero().flatten().tolist()) == sorted(slots) for row in changed),
                  f"long_500k decode: {side}'s {key} changed slots other than {slots}")
        if held:
            err = logit_ulps(cache[key][:, :, held], host_out["long_cache"][key][:, :, held])
            check(err <= LOGIT_ULPS, f"long_500k decode: {key} slots {err} ulps")
            slot_err[key] = err
    return {"pos": [LONG_POS, pos[0]], "window": window, "slots_written": slots,
            "slots_held": held, "logit_ulps": logit_err, "cache_slot_ulps": slot_err,
            "tol_ulps": LOGIT_ULPS, **({"routing": routing} if routing else {})}


def zoo_family(arch: str, dev, ops, cpu_side: CpuSide, started: dict | None = None) -> dict:
    """One family at full width: (a) card against CPU on a depth cut (the
    CPU's run in ``cpu_side``'s worker, ``started`` before the phase or here
    (zoo_hand_over); held to its bounds by the returned "finish", once the
    worker's run, the returned "job", is in), (b) the 32k prefill at full
    depth, (c) prefill against sequential decode, (d) the serving engine
    and the launcher, (e) for LONG_ARCHS the long_500k decode from a full
    ring cache: card against CPU at (a)'s cut (checked in "finish") and its
    ms a step at (d)'s depth.  A config of ZOO_DEPTHS runs (b) and (c) at
    its first depth, (d) and (e)'s timing at its second, and the launcher
    only at full depth.  Returns its kernel facts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import encdec as ted
    from repro_torch.models import lm as tlm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.train import make_prefill_step, make_serve_step

    t_family = time.perf_counter()
    full = get_config(arch)
    encdec = full.family == "encdec"
    init = ted.init_encdec_params if encdec else tlm.init_lm_params
    init_cache = ((lambda c, b, n, d: ted.init_encdec_cache(c, b, n, 16, d)) if encdec
                  else tlm.init_decode_cache)
    rng = np.random.default_rng(17)
    no_launch = {name: 0 for name in ops.launch_counts()}
    prefill_layers, engine_layers = ZOO_DEPTHS.get(arch, (full.n_layers, full.n_layers))
    deep = dataclasses.replace(full, n_layers=prefill_layers)
    served = dataclasses.replace(full, n_layers=engine_layers)
    budget, budget_max = {}, zoo_param_budget(arch)  # the bytes each cut holds, against its budget
    if arch in ZOO_DEPTHS:
        budget = {"prefill": zoo_param_bytes(full, prefill_layers, False),
                  "engine": zoo_param_bytes(full, engine_layers, True),
                  "engine_full_depth": zoo_param_bytes(full, full.n_layers, True),
                  "budget": budget_max}
        check(budget["prefill"] <= budget_max and budget["engine"] <= budget_max,
              f"{arch}: the zoo's cuts hold {budget}, above {budget_max}")

    def depth_cut(n_layers: int, engine: bool) -> str | None:
        if n_layers == full.n_layers:
            return None
        held = budget["engine" if engine else "prefill"]
        return (f"n_layers {n_layers} of {full.n_layers}: the deepest cut whose f32 params"
                + (" and ServeEngine's bf16 copy" if engine else "")
                + f" ({held / 1e9:.1f} GB) fit {budget_max / 1e9:.1f} GB of the card's 80")

    # (a) the same params on the card and on the CPU, depth cut: drawn on
    # the card (a host draw of nemotron-4-15b's 3.9 B takes tens of
    # seconds); the CPU holds them as the forward computes with them, the
    # matrices cast to bf16 once (cast_for_compute: the same logits bit for
    # bit, tests/test_torch_lm.py, test_torch_zoo.py, test_torch_encdec.py),
    # so that half the bytes cross and no step casts them again
    # its CPU side started (zoo_hand_over) here, or before the phase
    started = started or zoo_hand_over(arch, dev, cpu_side)
    job, hand_over_s = started["job"], started["hand_over_s"]
    cut = zoo_cut(arch)
    batch = zoo_cut_batch(cut, rng)  # the job's batch: the same first draw
    p_card = init(0, cut, dev)  # the same bits as the worker's copy
    moe, long = full.family == "moe", arch in LONG_ARCHS
    routers = p_card["blocks"]["moe"]["router"].cpu() if moe else None  # f32 in either copy
    prefill = make_prefill_step(cut)
    with record_router_inputs() as calls_card:
        card = prefill(p_card, {k: v.to(dev) for k, v in batch.items()}).cpu()
    step = make_serve_step(cut)
    card_decode, card_decode_calls, _ = decode_recorded(step, p_card, init_cache(cut, 2, 8, dev),
                                                        batch["tokens"][:, :4], dev)
    if long:  # (e) at the cut: the long_500k ring, its first slots past the wrap
        cache, tokens = long_500k_inputs(cut, device=dev)
        *card_long, cache = decode_recorded(step, p_card, cache, tokens, dev)
        card_long.append({k: v.cpu() if torch.is_tensor(v) else v for k, v in cache.items()})
        del cache
    del p_card
    card_side_s = time.perf_counter() - t_family
    part_a: dict = {"phase": "zoo", "part": "a_card_vs_cpu", "arch": arch, "family": full.family,
                    "cut": f"n_layers {cut.n_layers} of {full.n_layers}"
                           + (f", encoder_layers {cut.encoder_layers} of {full.encoder_layers}"
                              if encdec else "") + "; full width",
                    "prefill_batch": {k: list(v.shape) for k, v in batch.items()},
                    "params": "drawn on the card from seed 0; the CPU's: their cast_for_compute "
                              "copy (the matrices in bf16, as every use casts them)"}
    long_timing: dict = {}

    def check_cut() -> None:
        """(a)'s checks on the worker's CPU run (and (e)'s at the cut)."""
        host_out, worker = job.result()
        host, calls_host = host_out["prefill"], host_out["prefill_calls"]
        first: dict = {}
        if moe:  # each layer's moe_apply on the card again: the cut redrawn, the same bits
            p_card = init(0, cut, dev)
            part_a["moe_module"] = moe_module_check(cut, p_card, routers, calls_host,
                                                    host_out["moe_module"], dev)
            del p_card
            torch.cuda.empty_cache()
            first, counts = moe_routes(calls_card, calls_host, cut, routers, 0, first)
            part_a["prefill_routing"] = counts
        held = [b for b in range(2) if b not in first]
        prefill_ulps = logit_ulps(card[held], host[held]) if held else None
        check(prefill_ulps is None or prefill_ulps <= LOGIT_ULPS,
              f"{arch} cut prefill: card vs CPU {prefill_ulps} ulps")
        argmax = [argmax_rows(card[held], host[held], LOGIT_ULPS)] if held else []
        decode_ulps, held_rows, first = [], [], {}
        for s, (lg_card, lg_cpu) in enumerate(zip(card_decode, host_out["decode"])):
            if moe:
                first, counts = moe_routes(card_decode_calls[s], host_out["decode_calls"][s], cut,
                                           routers, s, first)
                part_a.setdefault("decode_routing", []).append(counts)
            rows = [b for b in range(2) if b not in first]
            held_rows.append(rows)
            if rows:
                decode_ulps.append(logit_ulps(lg_card[rows], lg_cpu[rows]))
                argmax.append(argmax_rows(lg_card[rows], lg_cpu[rows], LOGIT_ULPS))
        check(all(u <= LOGIT_ULPS for u in decode_ulps), f"{arch} cut decode: {decode_ulps} ulps")
        check(all(bad == 0 for _, bad, _ in argmax),
              f"{arch} cut: an argmax differs away from a near tie: {argmax}")
        part_a.update(prefill_logit_ulps=prefill_ulps, decode_logit_ulps=decode_ulps,
                      tol_ulps=LOGIT_ULPS, argmax_same=[a for a, _, _ in argmax],
                      min_top2_margin=[m for _, _, m in argmax],
                      seconds=time.perf_counter() - t_family,
                      cpu_side={**worker, "cpu_s": host_out["seconds"],
                                "card_side_s": card_side_s, "hand_over_s": hand_over_s})
        if moe:
            part_a.update(rows_held_prefill=held, rows_held_decode=held_rows,
                          note="moe: a batch row is held to the bound until its routing differs "
                               "between the card and the CPU, which is allowed only at a near tie "
                               "(or a capacity queue it shifts); moe_module holds each layer's "
                               "moe_apply on one input")
        emit(part_a)
        if long:
            emit({"phase": "zoo", "part": "e_long_500k_decode", "arch": arch,
                  "shape": "long_500k (B 1, S 524,288): the ring cache of its window, full",
                  "cut": part_a["cut"], **long_decode_check(cut, card_long, host_out, routers),
                  "timed": long_timing})

    def finish() -> None:
        # the moe's routing recomputed here as the worker computed it
        with cpu_side.same_threads() if moe else contextlib.nullcontext():
            check_cut()

    # (b) full depth (or ZOO_DEPTHS' cut) from seed 0 on the card:
    # the 32k prefill
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init(0, deep, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill_step(deep)
    shape = shape_of("prefill_32k")
    big = zoo_inputs(deep, shape.batch, shape.seq, rng, dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()  # the params, the inputs, earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, big)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = dict(ops.flash_attention_mod.flash_attention_cuda.route_launches)
    want_routes = ZOO_FLASH_ROUTES[arch]
    check(launches == {**no_launch, "flash_attention": sum(want_routes.values())},
          f"{arch} 32k prefill launches {launches}")
    check(routes == want_routes, f"{arch} 32k prefill flash routes {routes}, want {want_routes}")
    check(logits.shape == (shape.batch, tlm.padded_vocab(full))
          and bool(torch.isfinite(logits).all()),
          f"{arch} 32k prefill logits")
    peak = torch.cuda.max_memory_allocated()
    check(peak <= PEAK_BYTES_MAX, f"{arch} 32k prefill: peak {peak} > {PEAK_BYTES_MAX}")
    t0 = time.perf_counter()
    prefill(params, big)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit({"phase": "zoo", "part": "b_prefill_32k", "arch": arch, "n_layers": deep.n_layers,
          "encoder_layers": full.encoder_layers, "params": n_params,
          "param_bytes_f32": n_params * 4, "init_s": init_s,
          "inputs": {k: list(v.shape) for k, v in big.items()},
          "cut": "; ".join(filter(None, (
              depth_cut(prefill_layers, False),
              f"global batch 32 of prefill_32k cut to {shape.batch}"))),
          "first_call_ms": first_s * 1e3,
          "ms": steady_s * 1e3, "tokens_per_s": shape.batch * shape.seq / steady_s,
          "max_memory_allocated": peak, "memory_allocated_before": before,
          "peak_above_before": peak - before, "peak_bytes_max": PEAK_BYTES_MAX,
          "launches": launches, "flash_routes": routes,
          "logit_scale": float(logits.float().abs().max())})
    del big, logits

    # (c) prefill (the kernels) against sequential decode of a 5-token prompt
    prompt = torch.as_tensor(rng.integers(0, full.vocab, size=(1, 5)), device=dev)
    part_c = {"phase": "zoo", "part": "c_prefill_vs_decode", "arch": arch, "prompt_len": 5,
              "n_layers": deep.n_layers}
    if moe:
        m = full.moe
        cap = max(1, int(m.capacity_factor * 5 * m.top_k / m.n_experts))
        part_c["exempt"] = (
            "the reference's capacity rule makes them different functions: a 5-token prefill "
            f"has capacity max(1, int({m.capacity_factor} x 5 x {m.top_k} / {m.n_experts})) = "
            f"{cap} per expert and drops assignments ({5 * m.top_k} on {m.n_experts} experts), "
            "a one-token decode step drops none")
    else:
        pre = {"tokens": prompt}
        if encdec:  # decoding reads the zero cross K/V: the K/V of an all-zero source
            pre["src_embeds"] = torch.zeros((1, 16, full.d_model), device=dev)
        want = prefill(params, pre)  # vlm without image embeddings
        cache = init_cache(deep, 1, 8, dev)
        serve_step = make_serve_step(deep)
        for s in range(5):
            got, cache = serve_step(params, cache, prompt[:, s : s + 1])
        got = got[:, 0]
        depth_ulps = logit_ulps(got, want)
        tol = depth_logit_ulps(deep.n_layers)
        same, bad, margin = argmax_rows(got, want, tol)
        check(depth_ulps <= tol, f"{arch} prefill vs decode: {depth_ulps} ulps > {tol}")
        check(bad == 0, f"{arch} prefill vs decode: argmax differs at top-2 margin {margin}")
        part_c.update(logit_ulps=depth_ulps, tol_ulps=tol, argmax_same=bool(same),
                      top2_margin=margin)
        if encdec:
            part_c["note"] = ("src_embeds of 16 zero frames: the encoder's output is then 0, and "
                              "so are the cross K/V, which decoding reads from the zero cache")
        del cache, got, want
    emit(part_c)

    # (d) the serving engine with the launcher's defaults; the launcher
    if engine_layers != prefill_layers:  # another cut: drawn anew from seed 0
        del params
        torch.cuda.empty_cache()
        params = init(0, served, dev)

    def requests():
        return [Request(prompt=[(r * 7 + i) % full.vocab for i in range(5)], max_new_tokens=12)
                for r in range(6)]

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(params, served, batch_size=4, max_len=128, device=dev)
        for r in requests():
            engine.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(ops.launch_counts() == no_launch, f"{arch} serving launched {ops.launch_counts()}")
        check(len(done) == 6 and all(r.done and len(r.generated) == 12 for r in done),
              f"{arch} serving: not every request done with 12 tokens")
        runs.append({"tokens": [r.generated for r in done], "wall_s": wall, "steps": engine.steps,
                     "peak": torch.cuda.max_memory_allocated()})
        del engine
    check(runs[0]["tokens"] == runs[1]["tokens"], f"{arch} serving: a second engine gave other tokens")
    if long:  # (e) timed at (d)'s depth on ServeEngine's bf16 copy of the params
        cast = tlm.cast_for_compute(params)
        del params
        cache, tokens = long_500k_inputs(served, device=dev)
        step, wall = make_serve_step(served), []
        ops.reset_launch_counts()
        for s in range(LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = step(cast, cache, torch.as_tensor(tokens[:, s : s + 1], device=dev))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        check(ops.launch_counts() == no_launch and cache["pos"] == LONG_POS + LONG_STEPS,
              f"{arch} long_500k decode: launches {ops.launch_counts()}, pos {cache['pos']}")
        long_timing.update(n_layers=served.n_layers, params="ServeEngine's: cast_for_compute",
                           batch=1, ring_slots=int(cache["k"].shape[2]), first_pos=LONG_POS,
                           ms_per_step=[w * 1e3 for w in wall],
                           ms=statistics.median(wall[1:]) * 1e3,
                           ms_note="median of steps 2.. (host clock, synchronised)",
                           **({"cut": depth_cut(engine_layers, True)}
                              if engine_layers != full.n_layers else {}))
        del cast, cache
    else:
        del params
    torch.cuda.empty_cache()
    if engine_layers == full.n_layers:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launched = serve_launcher.main(["--arch", arch, "--device", str(dev)])
        check([r.generated for r in launched] == runs[0]["tokens"],
              f"{arch}: the launcher's tokens differ from the engine's (same seed, same card)")
        del launched
        launcher = out.getvalue().strip().splitlines()[0]
    else:  # the launcher serves the config at full depth
        launcher = (f"not run: it serves all {full.n_layers} layers, whose f32 params and "
                    f"ServeEngine's bf16 copy take {budget['engine_full_depth'] / 1e9:.1f} GB "
                    "of the card's 80")
    total = sum(len(t) for t in runs[0]["tokens"])
    seconds = time.perf_counter() - t_family
    emit({"phase": "zoo", "part": "d_serve", "arch": arch, "requests": 6, "batch": 4,
          "new_tokens": 12, "max_len": 128, "n_layers": served.n_layers,
          **({"cut": depth_cut(engine_layers, True)} if engine_layers != full.n_layers else {}),
          "steps": runs[0]["steps"], "tokens": total,
          "ms_per_step": [r["wall_s"] / r["steps"] * 1e3 for r in runs],
          "tokens_per_s": [total / r["wall_s"] for r in runs],
          "max_memory_allocated": [r["peak"] for r in runs], "launches": no_launch,
          "first_tokens": runs[0]["tokens"][:2], "launcher": launcher,
          "family_seconds": seconds, **({"param_bytes": budget} if budget else {})})
    torch.cuda.empty_cache()
    return {"routes": routes, "launches": launches, "seconds": seconds, "ms": steady_s * 1e3,
            "max_memory_allocated": peak, "n_layers": deep.n_layers, "job": job,
            "finish": finish}


# phase train: LM training at every family's full width
TRAIN_LAYER = (2, 4096, 32, 8, 64)  # a microbatch of train_4k at granite's layer: B, S, H, Kv, dh
RG_TRAIN_LAYER = (2, 4096, 10, 1, 256)  # ... at recurrentgemma-2b's attention layer
RG_WINDOW = 2048  # recurrentgemma-2b's local window (causal)
# seamless-m4t-large-v2's encoder self-attention (non-causal, MHA; its cross
# attention has the same shapes at train_4k), and llava-next-mistral-7b's
# layer: 576 image positions before the 4,096 tokens, causal window 4,096
SEAMLESS_TRAIN_LAYER = (2, 4096, 16, 16, 64)
LLAVA_TRAIN_LAYER, LLAVA_WINDOW = (2, 576 + 4096, 32, 8, 128), 4096
LLAVA_TRAIN_LAYERS = 12  # llava's full-width train step: 12 of its 32 layers
# the dense configs' full-width train steps (accum 2, B 4, S 4,096): each the
# deepest cut whose peak fits PEAK_BYTES_MAX (peak_train_bytes).  Their f32
# params, grads, m and v at n layers, counted on meta (16 bytes a param),
# and the peak a step reached there (scripts/train_depth_probe.py, H100):
CHATGLM_TRAIN_LAYERS = 17  # 0.266 + 0.204 n B params: 59.7 GB of state (95.6 whole); peak 78.6
NEMOTRON_TRAIN_LAYERS = 1  # 3.146 + 0.390 n B: 56.6 GB (250.1 whole); peak 74.1, 2 layers > 80
YI_TRAIN_LAYERS = 5  # 0.918 + 0.558 n B: 59.3 GB (550.2 whole); peak 73.6
# mixtral-8x22b: 0.403 + 2.504 n B params: 46.5 GB of state at 1 layer
# (9,002.6 whole); peak 60.03 (the probe, NVIDIA H100 80GB HBM3, 700.00 W);
# at 2 layers the state alone is 86.6 GB (the probe ran out of memory)
MIXTRAL_TRAIN_LAYERS = 1
# what a step held above that state at n layers, base + per_layer * n bytes:
# fitted to the probe's peaks at 15 and 17 layers (chatglm3-6b) and 4 and 5
# (yi-34b) -- the accumulation's second gradient of each stacked leaf and
# the layers' saved inputs grow with n; nemotron-4-15b ran at 1 layer only,
# and its 256k embedding's and head's gradients dominate: its per-layer
# term is left at 0, a lower bound (the probe ran out of memory at 2 layers
# with 80.49 GB asked for)
TRAIN_PEAK_ABOVE_STATE = {"chatglm3-6b": (1_180_436_480, 1_041_793_024),
                          "nemotron-4-15b": (17_574_505_984, 0),
                          "yi-34b": (1_935_117_312, 2_468_569_088),
                          # at 1 layer only, its per-layer term 0 as nemotron's
                          "mixtral-8x22b": (13_521_871_360, 0)}
DENSE_TRAIN_LAYERS = {"chatglm3-6b": CHATGLM_TRAIN_LAYERS, "nemotron-4-15b": NEMOTRON_TRAIN_LAYERS,
                      "yi-34b": YI_TRAIN_LAYERS}
# their training layers (B 2, S 4,096, H, Kv, dh 128), causal without a window:
# query-head groups of 16, 6 and 7
DENSE_TRAIN_LAYER = {"chatglm3-6b": (2, 4096, 32, 2, 128), "nemotron-4-15b": (2, 4096, 48, 8, 128),
                     "yi-34b": (2, 4096, 56, 8, 128)}
# mixtral-8x22b's training layer: H 48, Kv 8, dh 128, causal window 4,096,
# which at S 4,096 leaves every causal pair visible (the windowed kernel)
MIXTRAL_TRAIN_LAYER, MIXTRAL_WINDOW = (2, 4096, 48, 8, 128), 4096
# train_4k (S 4,096) at its batch cut to 4 (CUT_BATCH), in 2 microbatches of
# 2; 6 steps (the cells this phase gained last, 4: the run's 1,200 s)
TRAIN_ACCUM, TRAIN_STEPS, TRAIN_STEPS_SHORT = 2, 6, 4
# the card-vs-CPU depth cut, B 1: granite 2 layers; recurrentgemma 3, since
# its (rglru, rglru, attn) pattern puts no attention layer in the first 2
TRAIN_CUT_LAYERS, RG_CUT_LAYERS, TRAIN_CUT_SEQ = 2, 3, 512
# the train phase's cells in order: (arch, depth cut's layers (encdec: of the
# encoder and of the decoder), full-width run's layers (None: all), steps)
TRAIN_CELLS = (
    ("granite-3-2b", TRAIN_CUT_LAYERS, None, TRAIN_STEPS),
    ("recurrentgemma-2b", RG_CUT_LAYERS, None, TRAIN_STEPS),
    ("granite-moe-1b-a400m", 2, None, TRAIN_STEPS_SHORT),
    ("mamba2-2.7b", 2, None, TRAIN_STEPS_SHORT),
    ("seamless-m4t-large-v2", 2, None, TRAIN_STEPS_SHORT),
    # its f32 params, grads, m and v at 32 layers (~114 GB) do not fit one card
    ("llava-next-mistral-7b", 2, LLAVA_TRAIN_LAYERS, TRAIN_STEPS_SHORT),
    # half-dim rotary, Kv 2; squared ReLU and an untied 256k head; 56 heads
    # at d_model 7,168: at DENSE_TRAIN_LAYERS' cuts
    ("chatglm3-6b", 2, CHATGLM_TRAIN_LAYERS, TRAIN_STEPS_SHORT),
    ("nemotron-4-15b", 2, NEMOTRON_TRAIN_LAYERS, TRAIN_STEPS_SHORT),
    ("yi-34b", 2, YI_TRAIN_LAYERS, TRAIN_STEPS_SHORT),
    # 10 GB of f32 params a layer: AdamW's state at 2 layers (86.6 GB) does
    # not fit the card, so the depth cut, whose step runs twice, is 1 layer
    ("mixtral-8x22b", 1, MIXTRAL_TRAIN_LAYERS, TRAIN_STEPS_SHORT),
)
# AdamW's lr in a cell's steps: 1e-3 but where named.  C11: chatglm3-6b's
# synthetic stream has no unigram signal (its vocab 65,024 is coprime to
# the chain's multiplier, so each token's successor is a permutation of the
# vocab: tests/test_torch_train.py), and at lr 1e-3 its full-width loss rises
# over 6 steps at 2 and 17 layers, with the kernels and the plain backward
# alike, with full rotary, Kv 8 or an untied head alike
# (scripts/train_probe.py); at 3e-4 it falls
TRAIN_LR = {"chatglm3-6b": 3e-4}
# the moe depth cut: B 1, S MOE_CUT_SEQ, the first of MOE_HELD_SEEDS seeds
# whose labels before the first routing difference are MOE_HELD_SHARE of its
# own; at S 512 on an H100 no seed of 16 came near (a first difference
# within 6-162 tokens: the card's and the CPU's bf16 roundings part the
# router's probabilities by up to 1e-3 at layer 0 and 3e-3 at layer 1, and
# a token's 8th and 9th experts lie that close at ~0.7% of layer 0's tokens
# and ~2.7% of layer 1's)
MOE_CUT_SEQ, MOE_HELD_SEEDS, MOE_HELD_SHARE = 64, 32, 0.5
PEAK_BYTES_MAX = 80e9  # a full-width train step's peak device memory
BWD_CARD_ULPS = 2  # backward kernels against the plain backward, bf16: ulps of each gradient's scale
BWD_F32_RTOL = 1e-5  # ... f32: of each gradient's scale
# card against CPU at the depth cut: the CPU tests' per-family bounds against the
# reference (bf16 compute rounded at other places)
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 1e-3, 2e-2
BWD_FIXTURES = {  # name: (b, sq, sk, h, kv, dh, causal, window, q_offset, k_offset, dtype)
    "bf16_dh64_kv8_causal": (2, 777, 777, 32, 8, 64, True, None, 0, 0, "bf16"),
    "bf16_dh128_kv2_window": (1, 600, 600, 8, 2, 128, True, 200, 0, 0, "bf16"),
    "bf16_dh256_kv1_window": (1, 500, 500, 10, 1, 256, True, 128, 0, 0, "bf16"),
    "bf16_dh32_noncausal_cross": (2, 300, 170, 8, 2, 32, False, None, 0, 0, "bf16"),
    "bf16_dh16_kv4": (1, 256, 256, 4, 4, 16, True, None, 0, 0, "bf16"),
    "bf16_dh64_rows_with_no_key": (1, 300, 300, 8, 2, 64, True, None, 0, 40, "bf16"),
    "f32_dh64_causal": (2, 500, 500, 8, 2, 64, True, None, 0, 0, "f32"),
    "f32_dh256_window": (1, 300, 300, 4, 1, 256, True, 100, 0, 0, "f32"),
    "f32_dh32_noncausal": (1, 200, 330, 4, 2, 32, False, None, 0, 0, "f32"),
    # C4: a window without causality on a query chunk and its key slice
    "bf16_dh128_c4_offsets": (1, 512, 811, 8, 2, 128, False, 300, 1024, 725, "bf16"),
    "f32_dh64_c4_offsets": (1, 512, 811, 8, 2, 64, False, 300, 1024, 725, "f32"),
    # the wgmma backward's edges: Sq != Sk without causality, a window, Sq not
    # a multiple of its 128-query (dq) or 64-query (dk/dv) tiles
    "bf16_dh64_noncausal_cross": (2, 400, 700, 16, 4, 64, False, None, 0, 0, "bf16"),
    "bf16_dh64_kv8_window": (1, 900, 900, 32, 8, 64, True, 256, 0, 0, "bf16"),
    "bf16_dh128_sq_not_tile": (2, 333, 333, 8, 2, 128, True, None, 0, 0, "bf16"),
    # ... at head_dim 256 (64-query dq blocks, each key tile's (query head,
    # query tile) pairs split over a dkdv cluster): Sq != Sk without causality at Kv 2, Sq off the
    # tiles under a window at Kv 1, C4's offsets, rows with no visible key
    "bf16_dh256_noncausal_cross_kv2": (2, 400, 700, 10, 2, 256, False, None, 0, 0, "bf16"),
    "bf16_dh256_sq_not_tile_kv1": (2, 333, 333, 10, 1, 256, True, 128, 0, 0, "bf16"),
    "bf16_dh256_c4_offsets": (1, 512, 811, 10, 2, 256, False, 300, 1024, 725, "bf16"),
    "bf16_dh256_rows_with_no_key": (1, 300, 300, 8, 2, 256, True, None, 0, 40, "bf16"),
    # the training layers first run here: seamless's MHA (H = Kv) without
    # causality, and llava's window below S with S off the 64-query tiles
    "bf16_dh64_mha_noncausal": (2, 500, 500, 16, 16, 64, False, None, 0, 0, "bf16"),
    "bf16_dh128_window_below_s_off_tiles": (1, 1000, 1000, 32, 8, 128, True, 300, 0, 0, "bf16"),
    # the dense configs' groups, causal without a window, S off the tiles:
    # chatglm3-6b's 16 query heads a kv head, yi-34b's 7
    "bf16_dh128_group16_sq_not_tile": (1, 333, 333, 32, 2, 128, True, None, 0, 0, "bf16"),
    "bf16_dh128_group7_sq_not_tile": (2, 461, 461, 14, 2, 128, True, None, 0, 0, "bf16"),
}


def ulps_of_scale(got, want) -> float:
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err / bf16_ulp_at(scale) if scale > 0 else err


def bwd_against_plain(tfa, q, k, v, do, kw: dict, name: str) -> dict:
    """The training forward and the backward kernels against their plain
    versions on the same inputs (the backward's on the kernel's own O and
    lse): the forward's O rounded is the inference kernel's output bit for
    bit, its f32 O and lse within 1e-5 of scale; dq, dk, dv within
    BWD_CARD_ULPS (bf16) or BWD_F32_RTOL (f32) of scale; bf16: each
    gradient's differ share (tfa.differ_share against the plain backward)
    at most tfa.BWD_DIFFER_SHARE, and the control's (the plain backward
    with P and dS rounded to bf16 once) above it, or the check cannot tell
    the split products from one rounding; a second backward
    the same bits (no atomics); both backward kernels on flash_bwd_route's
    route."""
    import torch

    o, lse = tfa.flash_attention_train_cuda(q, k, v, **kw)
    kernels = (tfa.flash_attention_bwd_dq_cuda, tfa.flash_attention_bwd_dkdv_cuda)
    before = [dict(fn.route_launches) for fn in kernels]
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    route = tfa.flash_bwd_route(q.dtype, q.shape[3])
    for fn, was in zip(kernels, before):
        ran = {r: fn.route_launches[r] - was[r] for r in was}
        check(ran == {"wgmma": 0, "simt": 0, route: 2},
              f"flash bwd {name}: {fn.__name__} ran {ran}, want 2 on {route}")
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    control = (tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, round_p_ds=True, **kw)
               if q.dtype == torch.bfloat16 else None)
    o_plain, lse_plain = tfa.flash_attention_train_plain(q, k, v, **kw)
    inference = tfa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    check(torch.equal(o.to(q.dtype), inference),
          f"flash bwd {name}: the training forward's O does not round to the inference output")
    finite = torch.isfinite(lse_plain)
    check(torch.equal(torch.isfinite(lse), finite), f"flash bwd {name}: lse's +inf rows differ")
    lse_err = float((lse[finite] - lse_plain[finite]).abs().max()) if bool(finite.any()) else 0.0
    lse_scale = float(lse_plain[finite].abs().max()) if bool(finite.any()) else 0.0
    o_err = float((o - o_plain).abs().max())
    check(lse_err <= 1e-5 * max(1.0, lse_scale), f"flash bwd {name}: lse error {lse_err}")
    check(o_err <= 1e-5 * float(o_plain.abs().max()), f"flash bwd {name}: f32 O error {o_err}")
    row = {"shape": [q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]],
           "causal": kw["causal"], "window": kw.get("window"),
           "offsets": [kw.get("q_offset", 0), kw.get("k_offset", 0)], "dtype": str(q.dtype),
           "forward_route": tfa.flash_route(q.dtype, q.shape[3]), "backward_route": route,
           "o_f32_max_abs_err": o_err, "lse_max_abs_err": lse_err,
           "rows_with_no_key": int((~finite).sum())}
    for gname, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        check(g.dtype == w.dtype == q.dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"flash bwd {name}: {gname} {g.dtype} {tuple(g.shape)}")
        check(torch.equal(g, g2), f"flash bwd {name}: {gname} differs between two runs")
        row[f"{gname}_max_abs_err"] = float((g.float() - w.float()).abs().max())
        if q.dtype == torch.bfloat16:
            ulps = ulps_of_scale(g, w)
            check(ulps <= BWD_CARD_ULPS, f"flash bwd {name}: {gname} {ulps} bf16 ulps of scale")
            row[f"{gname}_ulps_of_scale"] = ulps
            share = tfa.differ_share(g, w)
            c = control[("dq", "dk", "dv").index(gname)]
            row[f"{gname}_differ_share"] = share
            row[f"{gname}_control_differ_share"] = tfa.differ_share(c, w)
            row[f"{gname}_control_ulps_of_scale"] = ulps_of_scale(c, w)
            check(share <= tfa.BWD_DIFFER_SHARE,
                  f"flash bwd {name}: {gname} differs from the plain backward in {share}")
            check(row[f"{gname}_control_differ_share"] > tfa.BWD_DIFFER_SHARE,
                  f"flash bwd {name}: {gname}'s control (P and dS rounded once) differs in "
                  f"only {row[f'{gname}_control_differ_share']}")
        else:
            rel = row[f"{gname}_max_abs_err"] / float(w.abs().max())
            check(rel <= BWD_F32_RTOL, f"flash bwd {name}: {gname} {rel} of scale")
            row[f"{gname}_rel_of_scale"] = rel
    return row


def bwd_layer(dev, tfa, label: str, layer: tuple, window, seed: int,
              causal: bool = True) -> dict:
    """The backward kernels at one training layer (B, S, H, Kv, dh;
    ``causal``, ``window``): held as the fixtures, then timed (CUDA-event
    medians of FLASH_TIMED_REPS pairs around one call) beside the training
    and inference forwards, the plain versions and SDPA's forward and
    backward (with a window: the window as a boolean (S, S) mask and the kv
    heads repeated), with the bounds."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, kv, dh = layer
    q, k, v = flash_inputs(dev, b, s, s, h, kv, dh, torch.bfloat16, seed)
    do = flash_inputs(dev, b, s, s, h, kv, dh, torch.bfloat16, seed + 1)[0]
    kw = {"causal": causal, "window": window}
    checked = bwd_against_plain(tfa, q, k, v, do, kw, label)
    o, lse = tfa.flash_attention_train_cuda(q, k, v, **kw)
    _, dsum = tfa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, **kw)
    qt = q.transpose(1, 2).detach().requires_grad_()
    if window is None:
        kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (k, v))
        sdpa_kw = {"is_causal": causal, "enable_gqa": h != kv}
        call = (f"F.scaled_dot_product_attention(is_causal={causal}, enable_gqa={h != kv}) "
                "in bf16")
    else:
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kt, vt = (t.transpose(1, 2).repeat_interleave(h // kv, dim=1).detach().requires_grad_()
                  for t in (k, v))
        sdpa_kw = {"attn_mask": band}
        call = (f"F.scaled_dot_product_attention(attn_mask=boolean (S, S) causal window "
                f"{window}) in bf16, the kv heads repeated")
    dot = do.transpose(1, 2)
    fns = {
        "train_forward": lambda: tfa.flash_attention_train_cuda(q, k, v, **kw),
        "inference_forward": lambda: tfa.flash_attention_cuda(q, k, v, **kw),
        "bwd_dq": lambda: tfa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, **kw),
        "bwd_dkdv": lambda: tfa.flash_attention_bwd_dkdv_cuda(q, k, v, lse, do, dsum, **kw),
        "plain_train_forward": lambda: tfa.flash_attention_train_plain(q, k, v, **kw),
        "plain_backward": lambda: tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
    }
    library = {"backends": "flash, memory-efficient",
               "call": f"{call}; rounds p to bf16: another function"}
    try:  # the yardstick only: the port never calls SDPA
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            out_t = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            torch.autograd.grad(out_t, (qt, kt, vt), dot, retain_graph=True)
            torch.cuda.synchronize()
        fns["sdpa_forward"] = lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), **sdpa_kw)
        fns["sdpa_backward"] = lambda: torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                                           retain_graph=True)
    except RuntimeError as err:
        library["not_given"] = str(err).splitlines()[0][:300]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        ms = median_ms(fns, reps=FLASH_TIMED_REPS, calls=1)
    pairs = tfa.visible_pairs(s, s, causal, window) * h * b
    prod = 2 * dh * pairs  # the FLOP of one head_dim product over the visible pairs
    el, n_q, n_kv, n_row = q.element_size(), q.numel(), k.numel(), lse.numel()
    dq_bytes = (3 * n_q + 2 * n_kv) * el + 4 * (n_q + 2 * n_row)  # q k v do dq; o lse D
    dkdv_bytes = (2 * n_q + 4 * n_kv) * el + 4 * 2 * n_row  # q do k v dk dv; lse D
    pair_bytes = (3 * n_q + 4 * n_kv) * el + 4 * (n_q + n_row)
    fwd_bytes = (n_q + 2 * n_kv) * el + 4 * (n_q + n_row)  # q k v; O f32 and lse
    bounds = {  # (ms, by): the least time for each function's work
        # P and dS in three bf16 parts (split_bf16x3): S, dP one product, dQ three
        "bwd_dq": bound(dq_bytes, 5 * prod, BF16_TENSOR_FLOPS),
        "bwd_dkdv": bound(dkdv_bytes, 8 * prod, BF16_TENSOR_FLOPS),  # S, dP; dV, dK three each
        "backward": bound(pair_bytes, 11 * prod, BF16_TENSOR_FLOPS),
        "train_forward": bound(fwd_bytes, 4 * prod, BF16_TENSOR_FLOPS),  # QK^T, 3 P.V products
    }
    cuda_cores = {"bwd_dq": 3 * prod / CUDA_CORE_32BIT_OPS * 1e3,  # S, dP, dQ in f32 FMA
                  "bwd_dkdv": 4 * prod / CUDA_CORE_32BIT_OPS * 1e3,  # S, dP, dV, dK
                  "backward": 5 * prod / CUDA_CORE_32BIT_OPS * 1e3}
    route = tfa.flash_bwd_route(q.dtype, dh)
    # the products each kernel of the route runs over the visible pairs: on
    # the tensor cores S, dP and three a split product (dq: dQ; dkdv: dV,
    # dK), and at head_dim 256 S and dP twice in dq (both consumers) and S
    # twice in dkdv (the role split); on the CUDA cores S, dP and one f32
    # product each
    if route == "wgmma":
        do_products = {"bwd_dq": 7, "bwd_dkdv": 9} if dh == 256 else {"bwd_dq": 5, "bwd_dkdv": 8}
    else:
        do_products = {"bwd_dq": 3, "bwd_dkdv": 4}
    exps = 4 if route == "wgmma" and dh == 256 else 2  # p computed per pair, both kernels
    floors = {  # the route's own floor: its products at the rate of their pipe
        "two_kernel_products_ms": 13 * prod / BF16_TENSOR_FLOPS * 1e3,
        "design_products_ms": sum(do_products.values()) * prod
        / (BF16_TENSOR_FLOPS if route == "wgmma" else CUDA_CORE_32BIT_OPS) * 1e3,
        "exp_mufu_ms": exps * pairs / MUFU_EXP_PER_S * 1e3,
    }
    grid = tfa.flash_bwd_dkdv_grid(b, s, kv) if route == "wgmma" and dh == 256 else None
    out = {"check": checked, "ms": ms, "visible_pairs": pairs, "bound": bounds,
           "bound_cuda_cores_ms": cuda_cores, "library": library, "backward_route": route,
           "kernels_do_products": do_products, "floors": floors, "dkdv_grid": grid}
    emit({"phase": "train", "part": f"a_flash_bwd_{label}", "shape": list(layer), "causal": causal,
          "window": window, "dtype": "bfloat16", **out,
          "note": "ms per call: CUDA-event medians, the functions in turns; bound: the bf16 "
                  "products of each function on the tensor cores (P and dS in three bf16 "
                  "parts) at 989 TFLOP/s, or its bytes; bound_cuda_cores_ms: the f32 FMA "
                  "products of the function at 67 TFLOP/s; floors: the 13 bf16 products of "
                  "two kernels that each recompute S and dP, the products the route's "
                  "kernels run (kernels_do_products), and their exponentials on the MUFU "
                  "pipe"})
    del q, k, v, do, o, lse, dsum, qt, kt, vt, dot, fns
    torch.cuda.empty_cache()
    out["layer"] = out.pop("check")
    return out


def flash_bwd_phase(dev, tfa, bwd_report: str | None) -> dict:
    """The backward kernels against the plain backward at every route's
    fixtures, then at granite-3-2b's training layer (TRAIN_LAYER, causal)
    and recurrentgemma-2b's (RG_TRAIN_LAYER, causal window RG_WINDOW), each
    held as the fixtures and timed (bwd_layer); and ptxas's registers and
    spills of the wgmma instantiations (from ``bwd_report``, nvcc's output
    for flash_attention_bwd.cu in this run): no spill and no wgmma
    warning."""
    import torch

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    from repro_torch.kernels import build

    report = {}
    for seed, (name, spec) in enumerate(BWD_FIXTURES.items()):
        b, sq, sk, h, kv, dh, causal, window, q_off, k_off, dt = spec
        q, k, v = flash_inputs(dev, b, sq, sk, h, kv, dh, dtypes[dt], 400 + seed)
        do = flash_inputs(dev, b, sq, sk, h, kv, dh, dtypes[dt], 500 + seed)[0]
        kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
        report[name] = bwd_against_plain(tfa, q, k, v, do, kw, name)
        del q, k, v, do
    ptxas = ({fn: lines for fn, lines in build.ptxas_entries(bwd_report).items()
              if "flash_bwd" in fn and "wgmma" in fn} if bwd_report is not None
             else "not measured (library built before this run)")
    if bwd_report is not None:
        check(sum("ILi256E" in fn for fn in ptxas) == 2,
              f"ptxas: not two head_dim-256 wgmma backward instantiations: {sorted(ptxas)}")
        for fn, lines in ptxas.items():
            check(any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in lines)
                  and not any("warning" in ln for ln in lines), f"ptxas {fn}: {lines}")
    emit({"phase": "train", "part": "a_flash_bwd_fixtures", "fixtures": report,
          "tol": {"bf16_ulps_of_scale": BWD_CARD_ULPS, "f32_rel_of_scale": BWD_F32_RTOL,
                  "bf16_differ_share": tfa.BWD_DIFFER_SHARE},
          "routes": {name: row["backward_route"] for name, row in report.items()},
          "ptxas_wgmma": ptxas})
    granite = bwd_layer(dev, tfa, "granite_training_layer", TRAIN_LAYER, None, 700)
    rg = bwd_layer(dev, tfa, "recurrentgemma_training_layer", RG_TRAIN_LAYER, RG_WINDOW, 710)
    seamless = bwd_layer(dev, tfa, "seamless_training_layer", SEAMLESS_TRAIN_LAYER, None, 720,
                         causal=False)
    llava = bwd_layer(dev, tfa, "llava_training_layer", LLAVA_TRAIN_LAYER, LLAVA_WINDOW, 730)
    dense = {arch: bwd_layer(dev, tfa, f"{arch}_training_layer", layer, None, 740 + 10 * i)
             for i, (arch, layer) in enumerate(DENSE_TRAIN_LAYER.items())}
    mixtral = bwd_layer(dev, tfa, "mixtral-8x22b_training_layer", MIXTRAL_TRAIN_LAYER,
                        MIXTRAL_WINDOW, 790)
    return {"fixtures": report, "ptxas_wgmma": ptxas, **granite, "rg": rg, "seamless": seamless,
            "llava": llava, "dense": dense, "mixtral": mixtral}


def train_attention_calls(cfg) -> int:
    """The attention calls of one forward of ``cfg``'s training loss: a
    decoder's attention layers (a hybrid's pattern's "attn" layers; none
    for ssm), or an encoder-decoder's encoder self-attentions, decoder
    self-attentions and cross-attentions."""
    from repro_torch.models.lm import layer_types

    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else int((layer_types(cfg) == 0).sum())


def expected_train_launches(cfg, accum: int) -> dict:
    """The flash launches of one train step of ``cfg`` over ``accum``
    microbatches: a microbatch runs the training forward of each attention
    call twice where its layer is recomputed in the backward (remat "full",
    or "dots", which keeps only matrix products; an encoder-decoder's layers
    always), once under "none", and each backward kernel once."""
    calls = train_attention_calls(cfg) * accum
    recomputed = cfg.family == "encdec" or cfg.remat_policy != "none"
    return {"flash_attention_train": (2 if recomputed else 1) * calls,
            "flash_attention_bwd_dq": calls, "flash_attention_bwd_dkdv": calls}


def train_state_bytes(cfg, n_layers: int) -> int:
    """The f32 params, grads, m and v of ``cfg`` at ``n_layers`` (counted on
    meta): 16 bytes a param."""
    from repro_torch.models.lm import init_lm_params

    params = init_lm_params(0, dataclasses.replace(cfg, n_layers=n_layers), "meta")
    return 4 * sum(t.numel() * t.element_size() for t in _leaves(params))


def peak_train_bytes(cfg, n_layers: int) -> int:
    """A dense config's full-width train step's peak at ``n_layers``: its
    state and what a step held above it (TRAIN_PEAK_ABOVE_STATE)."""
    base, per_layer = TRAIN_PEAK_ABOVE_STATE[cfg.name]
    return train_state_bytes(cfg, n_layers) + base + per_layer * n_layers


def init_params(cfg, device):
    """Seed-0 params of ``cfg`` on ``device`` (encdec: init_encdec_params)."""
    from repro_torch.models import init_encdec_params, init_lm_params

    return (init_encdec_params if cfg.family == "encdec" else init_lm_params)(0, cfg, device)


def routing_report(tables, first: dict) -> list:
    """Per layer, the two runs' routing tables (route_table on each run's
    device): digests of the tokens before each row's first difference
    (equal), each run's tokens per expert and kept assignments, and the
    first differing tokens' experts on both sides."""
    import hashlib

    import torch

    out = []
    for layer, (card, host) in enumerate(tables):
        (ec, kc, _, b, s), (eh, kh, _, _, _) = card, host
        pos, row = torch.arange(b * s) % s, torch.arange(b * s) // s
        held = torch.tensor([int(p) < first.get(int(r), 1 << 30) for r, p in zip(row, pos)])
        differ = torch.nonzero((ec != eh).any(-1) | (kc != kh).any(-1)).flatten().tolist()

        def digest(e, kept):
            return hashlib.sha256(e[held].numpy().tobytes() + kept[held].numpy().tobytes()
                                  ).hexdigest()[:16]

        out.append({
            "layer": layer, "held_tokens": int(held.sum()),
            "sha256_16": {"card": digest(ec, kc), "cpu": digest(eh, kh)},
            "tokens_per_expert": {"card": torch.bincount(ec.flatten()).tolist(),
                                  "cpu": torch.bincount(eh.flatten()).tolist()},
            "kept": {"card": int(kc.sum()), "cpu": int(kh.sum())},
            "differing_tokens": len(differ),
            "first_differing": [{"token": t, "card": ec[t].tolist(), "cpu": eh[t].tolist(),
                                 "card_kept": kc[t].tolist(), "cpu_kept": kh[t].tolist()}
                                for t in differ[:4]]})
    return out


def moe_held_batch(cut, p_card, p_cpu, dev) -> tuple[dict, dict]:
    """The moe depth cut's batch, B 1, S MOE_CUT_SEQ: seeds in order, each
    batch's loss run on the card and on the CPU with every moe_apply's input
    recorded and each run's routing of it computed on its own device
    (route_table); a token may route otherwise only at a near tie, and a
    kept flag differ only where an assignment flipped (routing_differences).
    The first seed whose labels before each row's first routing difference
    are at least MOE_HELD_SHARE of the row is taken, its labels from that
    difference on masked (-1), as the CPU tests hold the port against the
    reference: the loss and every gradient are then of tokens routed alike
    on both devices (causal attention, and capacity queues filled in token
    order)."""
    import torch

    from repro_torch.models import lm as tlm
    from repro_torch.train import synthetic_batch
    from repro_torch.train.step import batch_to, loss_for

    routers = [(c["moe"]["router"], h["moe"]["router"]) for c, h in
               zip(tlm._layers(p_card["blocks"], cut.n_layers),
                   tlm._layers(p_cpu["blocks"], cut.n_layers))]
    tried = []
    for seed in range(MOE_HELD_SEEDS):
        batch = synthetic_batch(cut, 1, MOE_CUT_SEQ, seed=seed)
        runs = []
        for params, where in ((p_card, dev), (p_cpu, torch.device("cpu"))):
            with record_router_inputs() as calls, torch.no_grad():
                loss_for(cut)(params, batch_to(batch, where))
            runs.append(calls)
        first, counts, tables = {}, [], []
        for (hc, hh), (rc, rh) in zip(zip(*runs), routers):
            card = (*route_table(hc.to(dev), rc, cut), *hc.shape[:2])
            host = (*route_table(hh, rh, cut), *hh.shape[:2])
            first, n, _ = routing_differences(card, host, 0, first)
            counts.append(n)
            tables.append((card, host))
        labels = batch["labels"].copy()
        for row, pos in first.items():
            labels[row, pos:] = -1
        share = float((labels >= 0).sum() / (batch["labels"] >= 0).sum())
        tried.append({"seed": seed, "first_difference": first, "held_share": share,
                      "per_layer": counts})
        if share >= MOE_HELD_SHARE:
            return dict(batch, labels=labels), {
                "seed": seed, "tried": tried, "held_share": share,
                "routing_tables": routing_report(tables, first)}
    check(False, f"moe depth cut: no seed of {MOE_HELD_SEEDS} holds {MOE_HELD_SHARE} of its "
          f"labels before a routing difference: {tried}")


def train_cut_config(arch: str, n_layers: int):
    """``arch`` at full width and ``n_layers`` layers (encdec: as many
    encoder and decoder layers), accumulation 1: the train depth cut."""
    from repro_torch.configs import get_config

    full_cfg = get_config(arch)
    return dataclasses.replace(full_cfg, n_layers=n_layers, accum_steps=1,
                               **({"encoder_layers": n_layers} if full_cfg.family == "encdec"
                                  else {}))


def train_cut_hand_over(dev, cpu_side: CpuSide, arch: str, n_layers: int) -> dict:
    """The depth cut's params drawn on the card from seed 0 (init_params
    draws the same bits every time) and handed over to ``cpu_side``'s
    worker, and its batch (B 1, S TRAIN_CUT_SEQ; vlm: after its images;
    encdec: a source of as many frames; moe: moe_held_batch's, S
    MOE_CUT_SEQ, which reads a host copy, cast_for_compute's: the same
    losses bit for bit, half the bytes, no cast at each use); the card's
    copy freed."""
    import torch

    from repro_torch.models.lm import cast_for_compute
    from repro_torch.train import synthetic_batch

    cut = train_cut_config(arch, n_layers)
    p_card = init_params(cut, dev)
    batch, moe = synthetic_batch(cut, 1, TRAIN_CUT_SEQ, seed=0), None
    if cut.family == "moe":
        with cpu_side.same_threads():
            batch, moe = moe_held_batch(cut, p_card, tree_to(cast_for_compute(p_card), "cpu"),
                                        dev)
    hand_over_s = cpu_side.hand_over(f"train/{arch}", p_card)
    del p_card
    torch.cuda.empty_cache()
    return {"cut": cut, "batch": batch, "moe": moe, "hand_over_s": hand_over_s}


def train_depth_cut(dev, ops, cpu_side: CpuSide, arch: str, n_layers: int, handed: dict,
                    job: CpuRun):
    """``arch``'s depth cut (``handed``: train_cut_hand_over's) on the card:
    the loss and every leaf's gradient from the same params, the launches
    those of expected_train_launches, each on the wgmma route, and one train
    step run twice from one state, bit for bit (the params drawn again for
    the second: a second copy on the card does not fit beside
    nemotron-4-15b's AdamW state).  ``job`` is the worker's CPU run of the
    same loss (train_cpu_side, a CpuRun).  Returns the function that collects it and
    holds the card against it (the loss and each leaf's gradient within
    TRAIN_LOSS_RTOL and TRAIN_GRAD_REL_L2) and returns the cut's facts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map
    from repro_torch.train.step import batch_to, loss_for, value_and_grad

    full_cfg = get_config(arch)
    cut, batch, moe = handed["cut"], handed["batch"], handed["moe"]
    want = expected_train_launches(cut, 1)
    check(want["flash_attention_bwd_dq"] > 0 or cut.family == "ssm",
          f"train depth cut {arch}: {n_layers} layers hold no attention layer")
    p_card = init_params(cut, dev)
    fwd = ops.flash_attention_mod
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_card, g_card = value_and_grad(loss_for(cut), p_card, [batch_to(batch, dev)])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = {name: n for name, n in ops.launch_counts().items() if n}
    routes = tuple(dict(fn.route_launches) for fn in (
        fwd.flash_attention_train_cuda, fwd.flash_attention_bwd_dq_cuda,
        fwd.flash_attention_bwd_dkdv_cuda))
    check(launched == {name: n for name, n in want.items() if n}
          and routes == tuple({"wgmma": want[name], "simt": 0} for name in want),
          f"train depth cut {arch}: launches {launched}, routes {routes}, want {want}")
    norm_card = float(global_norm(g_card))
    g_card = tree_map(lambda g: g.cpu(), g_card)  # the card's room goes to (c)
    step = make_train_step(cut, AdamWConfig(lr=TRAIN_LR.get(arch, 1e-3)))
    first = None
    for run in range(2):
        if run:  # the same state again: the same draw
            del p_card
            torch.cuda.empty_cache()
            p_card = init_params(cut, dev)
        new, opt, m = step(p_card, adamw_init(p_card), batch)  # in place, into p_card
        del opt
        if run == 0:
            first = (m["loss"], m["grad_norm"], [t.cpu() for t in tree_leaves(new)])
            del new
    l1, n1, a = first
    same = (torch.equal(l1, m["loss"]) and torch.equal(n1, m["grad_norm"])
            and all(torch.equal(x.to(dev), y) for x, y in zip(a, tree_leaves(new))))
    check(same, f"train depth cut {arch}: two steps from one state differ on the card")
    del p_card, new, a, first
    torch.cuda.empty_cache()
    layers = (f"n_layers {n_layers} of {full_cfg.n_layers}" if cut.family != "encdec" else
              f"encoder_layers and n_layers {n_layers} of {full_cfg.encoder_layers} and "
              f"{full_cfg.n_layers}")

    def finish() -> dict:
        host, worker = job.result()
        loss_cpu = host["loss"]
        # the CPU's gradient onto the card, where the norms are taken in f64
        g_cpu = tree_map(lambda g: torch.empty(g.shape, dtype=g.dtype, device=dev), g_card)
        take_back_s = cpu_side.take_back(f"train/{arch}/grads", g_cpu)
        loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
        check(loss_rel <= TRAIN_LOSS_RTOL, f"train depth cut {arch}: loss {float(loss_card)} "
              f"vs CPU {float(loss_cpu)}")
        rel = {}
        for (path, gc), (_, gh) in zip(_named(g_card), _named(g_cpu)):
            check(bool(torch.isfinite(gc).all()), f"train depth cut {arch}: {path} not finite")
            gc, gh = gc.to(dev).double(), gh.double()  # the norms on the card, in f64
            rel[path] = float(torch.linalg.norm(gc - gh) / torch.linalg.norm(gh))
            check(rel[path] <= TRAIN_GRAD_REL_L2,
                  f"train depth cut {arch}: {path} rel L2 {rel[path]}")
        norm_cpu = float(global_norm(g_cpu))
        del g_cpu
        torch.cuda.empty_cache()
        check(abs(norm_card - norm_cpu) <= TRAIN_GRAD_REL_L2 * norm_cpu,
              f"train depth cut {arch}: grad norm {norm_card} vs CPU {norm_cpu}")
        out = {"arch": arch, "cut": f"{layers}; full width",
               "attention_calls": train_attention_calls(cut), "card_launches": launched,
               "batch_seq": list(np.shape(batch["tokens"])),
               "inputs": {k: list(np.shape(v)) for k, v in batch.items()},
               "loss_card": float(loss_card), "loss_cpu": float(loss_cpu), "loss_rel": loss_rel,
               "grad_norm_card": norm_card, "grad_norm_cpu": norm_cpu,
               "worst_leaf_rel_l2": max(rel.items(), key=lambda kv: kv[1]),
               "leaves": len(rel), "tol": {"loss_rel": TRAIN_LOSS_RTOL,
                                           "grad_rel_l2": TRAIN_GRAD_REL_L2},
               "card_forward_backward_s": card_s, "cpu_forward_backward_s": host["seconds"],
               "cpu_side": {**worker, "hand_over_s": handed["hand_over_s"],
                            "take_back_s": take_back_s},
               "step_twice_bitwise": True, "step_loss": float(l1), "step_grad_norm": float(n1)}
        if moe is not None:
            out["moe_held_batch"] = moe
        emit({"phase": "train", "part": "b_depth_cut_card_vs_cpu", **out})
        return out

    return finish


def _named(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, keys sorted (jax.tree.leaves order)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _named(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _kernel_split(prof, n_steps: int) -> dict:
    """Device ms per step by kind of kernel, summed from the profile's raw
    device events (building the profiler's event tree for key_averages
    took ~18 s at mamba2-2.7b's ~10^5 launches a step)."""
    import torch

    kinds = {"flash_forward": ("flash_fwd",), "flash_backward": ("flash_bwd",),
             "matmuls": ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_")}
    split = {kind: 0.0 for kind in (*kinds, "other")}
    by_name: dict[str, list[int]] = {}  # kernel name: [ns, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            total = by_name.setdefault(e.name(), [0, 0])
            total[0] += e.duration_ns()
            total[1] += 1
    for name, (ns, _) in by_name.items():
        kind = next((k for k, marks in kinds.items() if any(m in name for m in marks)), "other")
        split[kind] += ns / n_steps / 1e6
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    return {"device_ms_per_step": split, "device_ms_total": sum(split.values()),
            "top_kernels": [{"name": name[:90], "ms_per_step": ns / n_steps / 1e6,
                             "calls_per_step": count / n_steps}
                            for name, (ns, count) in top]}


def train_full(dev, ops, arch: str, steps: int, n_layers: int | None = None,
               keep_final: bool = False) -> dict:
    """``arch`` at full width and depth (``n_layers``: a depth cut at full
    width): ``steps`` steps of make_train_step (accum TRAIN_ACCUM, remat
    "full", AdamW at TRAIN_LR's lr) on synthetic_token_stream at train_4k's S and
    cut batch (vlm: after 576 image positions; encdec: a source of S
    frames); the launch counts set to 0 before each step and read after it
    (expected_train_launches, all on the wgmma route, and nothing else);
    the loss falling, peak memory under PEAK_BYTES_MAX; the last step
    profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update, make_train_step,
                                   synthetic_token_stream)
    from repro_torch.train.optimizer import tree_map

    published = get_config(arch)
    full = dataclasses.replace(published, accum_steps=TRAIN_ACCUM,
                               **({"n_layers": n_layers} if n_layers else {}))
    check(full.remat_policy == "full", f"{arch}'s remat policy {full.remat_policy}")
    no_launch = {name: 0 for name in ops.launch_counts()}
    per_step = expected_train_launches(full, TRAIN_ACCUM)
    want = {**no_launch, **per_step}
    fwd = ops.flash_attention_mod
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(full, dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    allocated_after_init = torch.cuda.memory_allocated()
    lr = TRAIN_LR.get(arch, 1e-3)
    step = make_train_step(full, AdamWConfig(lr=lr))
    shape = shape_of("train_4k")
    stream = synthetic_token_stream(full, shape.batch, shape.seq)
    batches = [next(stream) for _ in range(steps)]  # set-up: numpy, before the clock
    losses, norms, wall, counts = [], [], [], []
    prof = None
    for i, batch in enumerate(batches):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        profiled = i == steps - 1
        # the device's kernels only: host ops as well took ~90 s to gather at
        # mamba2-2.7b's ~10^5 launches a step
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof_i:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        if profiled:
            prof = prof_i
        launched = ops.launch_counts()
        routes = (dict(fwd.flash_attention_train_cuda.route_launches),
                  dict(fwd.flash_attention_cuda.route_launches))
        check(launched == want, f"{arch} train step {i}: launches {launched}, want {want}")
        check(routes == ({"wgmma": want["flash_attention_train"], "simt": 0},
                         {"wgmma": 0, "simt": 0}), f"{arch} train step {i}: flash routes {routes}")
        bwd_routes = (dict(fwd.flash_attention_bwd_dq_cuda.route_launches),
                      dict(fwd.flash_attention_bwd_dkdv_cuda.route_launches))
        check(bwd_routes == ({"wgmma": want["flash_attention_bwd_dq"], "simt": 0},
                             {"wgmma": want["flash_attention_bwd_dkdv"], "simt": 0}),
              f"{arch} train step {i}: flash backward routes {bwd_routes}")
        counts.append(launched)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    # the mesh phase holds its run to these, bit for bit (before AdamW's timing moves them)
    final = tree_map(lambda p: p.cpu(), params) if keep_final else None
    check(all(math.isfinite(x) for x in losses + norms),
          f"{arch} train: losses {losses}, norms {norms}")
    check(losses[-1] < losses[0], f"{arch} train: the loss did not fall: {losses}")
    check(peak <= PEAK_BYTES_MAX, f"{arch} train: peak memory {peak} bytes")
    timed = wall[1:-1]  # after the first step, before the profiled one
    ms = statistics.median(timed) * 1e3
    tokens = shape.batch * shape.seq
    # positions a row runs through: vlm's images before its tokens, encdec's
    # source frames beside them
    extra = (full.n_frontend_tokens if full.family == "vlm" else
             shape.seq if full.family == "encdec" else 0)
    t0 = time.perf_counter()
    split = _kernel_split(prof, 1)
    check(split["device_ms_total"] > 0, f"{arch} train: the profiled step shows no device time")
    split["gather_s"] = time.perf_counter() - t0
    # AdamW alone at full width: CUDA events around one update (zero grads)
    grads = tree_map(torch.zeros_like, params)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    adamw_update(params, grads, opt, AdamWConfig(lr=lr))
    end.record()
    torch.cuda.synchronize()
    adamw_ms = start.elapsed_time(end)
    n_params = sum(t.numel() for t in _leaves(params))
    device_ms = split["device_ms_total"]
    cut = f"train_4k's global batch of 256 cut to {shape.batch}"
    if n_layers:
        cut += f"; n_layers {n_layers} of {published.n_layers} at full width"
    out = {"arch": full.name, "n_layers": full.n_layers, "encoder_layers": full.encoder_layers,
           "attention_calls": train_attention_calls(full), "params": n_params,
           "f32_params_grads_m_v_bytes": 4 * 4 * n_params,
           "batch_seq": [shape.batch, shape.seq], "positions_per_row": shape.seq + extra,
           "accum_steps": TRAIN_ACCUM,
           "microbatch": shape.batch // TRAIN_ACCUM, "remat_policy": full.remat_policy,
           "cut": cut, "steps": steps, "lr": lr,
           "init_s": init_s, "losses": losses, "grad_norms": norms, "wall_s": wall,
           "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
           "positions_per_s": shape.batch * (shape.seq + extra) / (ms / 1e3),
           "ms_per_step_note": f"median of steps 2..{steps - 1} (host clock, synchronised); "
                               "tokens: the labelled tokens, B x S",
           "launches_want_per_step": per_step,
           "launches_per_step": counts[0], "launches_total": {
               name: sum(c[name] for c in counts) for name in counts[0]},
           "flash_train_routes_per_step": {"wgmma": want["flash_attention_train"], "simt": 0},
           "flash_bwd_routes_per_step": {
               "dq": {"wgmma": want["flash_attention_bwd_dq"], "simt": 0},
               "dkdv": {"wgmma": want["flash_attention_bwd_dkdv"], "simt": 0}},
           "max_memory_allocated": peak, "allocated_after_init": allocated_after_init,
           "profiled_step": split, "adamw_update_ms": adamw_ms,
           "flash_backward_share_of_device_ms": split["device_ms_per_step"]["flash_backward"]
           / device_ms if device_ms else None}
    emit({"phase": "train", "part": "c_full_width", **out})
    if keep_final:
        out["final_params"] = final
    del params, opt, grads, batches, prof
    return out


def train_hand_overs(dev, cpu_side: CpuSide) -> dict:
    """Every train cell's depth cut handed over (train_cut_hand_over) and its
    CPU side started, in TRAIN_CELLS' order: arch -> (handed, CpuRun)."""
    out = {}
    for arch, cut_layers, _, _ in TRAIN_CELLS:
        handed = train_cut_hand_over(dev, cpu_side, arch, cut_layers)
        out[arch] = (handed, cpu_side.start(train_cpu_side, f"train/{arch}", handed["cut"],
                                            handed["batch"]))
    return out


def train_phase(dev, ops, tfa, bwd_report: str | None, cpu_side: CpuSide,
                started: dict | None = None, unchecked: list | None = None) -> dict:
    """LM training: (a) the backward kernels, then for each of TRAIN_CELLS,
    each freed on the card before the next, (b) the depth cut card against
    CPU (the CPU's side in ``cpu_side``'s worker, ``started`` before the
    phase (train_hand_overs) or at its start, checked once it is in and the
    cell's (c) has run) and (c) full width and depth (or the cell's depth
    cut), (d) the launcher.  ``unchecked``: (name, CpuRun, finish) of checks
    whose CPU sides the worker computes before the cells' (the zoo's),
    finished as theirs are."""
    import torch

    from repro_torch.launch import train as train_launcher

    t_phase = time.perf_counter()
    bwd = flash_bwd_phase(dev, tfa, bwd_report)
    # every cut's params to the worker first, then every cut's CPU run
    # queued: the worker computes them one after another while the card
    # runs the cells, each cell's CPU run checked as soon as it is in and
    # the cell's card work is done
    started = started or train_hand_overs(dev, cpu_side)
    cells, cell_s, cuts, unchecked = {}, {}, {}, list(unchecked or [])
    for arch, cut_layers, full_layers, steps in TRAIN_CELLS:
        t0 = time.perf_counter()
        handed, job = started.pop(arch)
        unchecked.append((arch, job, train_depth_cut(dev, ops, cpu_side, arch, cut_layers,
                                                     handed, job)))
        full = train_full(dev, ops, arch, steps, n_layers=full_layers,
                          keep_final=arch == "granite-3-2b")
        torch.cuda.empty_cache()
        cells[arch] = {"full": full}
        # the checks whose CPU sides are in, in order; after the last cell, all
        while unchecked and (arch == TRAIN_CELLS[-1][0] or unchecked[0][1].done()):
            done, _, finish = unchecked.pop(0)
            cuts[done] = finish()
        cell_s[arch] = time.perf_counter() - t0
    for arch, cell in cells.items():
        cell["cut"] = cuts[arch]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, losses = train_launcher.main(["--arch", "granite-3-2b", "--reduced", "--steps", "30",
                                         "--batch", "8", "--seq", "32", "--lr", "1e-3",
                                         "--device", str(dev)])
    check(losses[-1] < losses[0] - 0.5, f"train launcher: the loss fell {losses[0] - losses[-1]}")
    emit({"phase": "train", "part": "d_launcher", "argv": "--arch granite-3-2b --reduced "
          "--steps 30 --batch 8 --seq 32 --lr 1e-3", "first_loss": losses[0],
          "last_loss": losses[-1], "printed": out.getvalue().strip().splitlines()[-1]})
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train", "seconds": seconds, "cell_seconds": cell_s})
    return {"bwd": bwd, "cells": cells, "full": cells["granite-3-2b"]["full"],
            "rg_full": cells["recurrentgemma-2b"]["full"], "seconds": seconds}


MESH_RECORDS = (("granite-3-2b", "train_4k"), ("granite-3-2b", "prefill_32k"))
MESH_ONE_CARD_BATCH = CUT_BATCH["train_4k"]


def mesh_world_records(jobs, fednl: bool) -> dict:
    """In a fake world (launch.dryrun.FakeWorld): each (arch, shape) of
    ``jobs`` through the dry run's run_one with its probes, on 16 x 16 or
    2 x 16 x 16 as the world's size says, and the FedNL dry run when
    ``fednl``; each with its seconds."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import run_fednl_dryrun, run_one

    multi_pod = dist.get_world_size() == 512
    out = {"records": [], "fednl": None}
    for arch, shape in jobs:
        t0 = time.perf_counter()
        rec = run_one(arch, shape, multi_pod, verbose=False)
        out["records"].append({**rec, "seconds": time.perf_counter() - t0})
    if fednl:
        t0 = time.perf_counter()
        out["fednl"] = {"records": run_fednl_dryrun(multi_pod),
                        "seconds": time.perf_counter() - t0}
    return out


def mesh_one_card_count(arch: str, accum: int, batch: int) -> dict:
    """In a fake world: ``arch``'s train_4k step (accum ``accum``, batch
    ``batch``) counted on a 1 x 1 mesh (rank 0), as the roofline phase
    counts it with no mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _register_mesh_axes, _with_out_layout
    from repro_torch.launch.specs import build_dryrun

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), accum_steps=accum)
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    _register_mesh_axes(mesh)
    spec = build_dryrun(cfg, "train_4k", mesh, batch_override=batch)
    cost = rl.step_cost(_with_out_layout(spec), *spec.args)
    return {"flops": cost.flops, "bytes": cost.bytes, "coll": dict(cost.coll),
            "note": spec.note, "seconds": time.perf_counter() - t0}


def mesh_line(rec: dict, machines: list) -> dict:
    """One dry-run record's line: status, per-rank flops, bytes and
    collective bytes by kind, the three terms on each machine, the useful
    fraction."""
    r = rec.get("roofline", {})
    coll = rec.get("collectives", {})
    total = float(sum(coll.values()))
    terms = {}
    for m in machines:
        t = {"compute_s": r["flops"] / m.peak_flops, "memory_s": r["hbm_bytes"] / m.hbm_bw,
             "collective_s": total / m.ici_bw}
        terms[m.name] = {**t, "dominant": max(t, key=t.get).removesuffix("_s")}
    return {"phase": "mesh", "part": "b_dry_run", "arch": rec["arch"], "shape": rec["shape"],
            "mesh": rec["mesh"], "status": rec["status"], "flops_per_rank": r.get("flops"),
            "hbm_bytes_per_rank": r.get("hbm_bytes"), "collective_bytes_per_rank": coll,
            "terms": terms, "useful_fraction": r.get("useful_fraction"),
            "model_flops_per_rank": r.get("model_flops"), "note": rec.get("note"),
            "memory_analysis": rec.get("memory_analysis"), "meta_step_s": rec.get("meta_step_s"),
            "seconds": rec.get("seconds")}


def mesh_phase(dev, ops, train: dict | None, skipped: dict) -> dict:
    """The mesh layer on the card: (a) granite-3-2b at full width and depth
    through launch/train.py's main with ``--mesh 1x1`` (params and AdamW's
    state DTensors, each attention's flash launches through local_map),
    the train phase's seed, batches, accumulation, remat and steps: the
    losses and final params bit for bit the unsharded run's, the flash
    launches of expected_train_launches a step, all on the wgmma route, ms
    a step and peak memory beside the unsharded run's; meanwhile (b) in
    three spawned fake worlds (launch.dryrun.FakeWorld) the dry run's
    records of MESH_RECORDS on 16 x 16 with their probes, the FedNL dry run
    on both meshes (per-rank collective bytes equal to the closed form) and
    granite-3-2b's cut train_4k step counted on a 1 x 1 mesh (its product
    flops checked against the roofline phase's plain count there); one
    line a record, with the three terms on the datasheet's ceilings and on
    this card's measured peak and HBM rate (the collective term at the
    datasheet's NVLink rate: one card measures no link)."""
    import multiprocessing
    import threading
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch import roofline as rl
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_launcher

    t_phase = time.perf_counter()
    world_out: dict = {}

    def in_world(key, multi_pod, calls):
        try:
            with dryrun.FakeWorld(multi_pod) as world:
                world_out[key] = [world.call(fn, *args) for fn, args in calls]
        except Exception as err:  # noqa: BLE001 -- checked below
            world_out[key] = err

    t_worlds = time.perf_counter()
    plans = {
        "train": (False, [(mesh_world_records, (MESH_RECORDS[:1], False))]),
        "prefill": (False, [(mesh_world_records, (MESH_RECORDS[1:], True)),
                            (mesh_one_card_count, ("granite-3-2b", TRAIN_ACCUM,
                                                   MESH_ONE_CARD_BATCH))]),
        "multi_pod": (True, [(mesh_world_records, ((), True))]),
    }
    workers = [threading.Thread(target=in_world, args=(key, mp, calls))
               for key, (mp, calls) in plans.items()]
    for w in workers:
        w.start()

    # (a) the 1 x 1 mesh on the card
    launched = ms = peak = None
    if train is None:
        skipped["mesh"] = ["(a) --mesh 1x1 against the unsharded run: the train phase did not run"]
    else:
        base = train["full"]
        full_params = base.pop("final_params")
        steps, shape = base["steps"], base["batch_seq"]
        want = {name: n * steps for name, n in base["launches_want_per_step"].items()}
        fwd = ops.flash_attention_mod
        for fn in (fwd.flash_attention_train_cuda, fwd.flash_attention_cuda,
                   fwd.flash_attention_bwd_dq_cuda, fwd.flash_attention_bwd_dkdv_cuda):
            fn.route_launches.update({k: 0 for k in fn.route_launches})
        wall = []
        real_step = train_launcher.make_train_step

        def timed_step(*args, **kw):
            step = real_step(*args, **kw)

            def run(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
                return out

            return run

        argv = ["--arch", "granite-3-2b", "--steps", str(steps), "--batch", str(shape[0]), "--seq",
                str(shape[1]), "--lr", "1e-3", "--accum", str(TRAIN_ACCUM), "--mesh", "1x1",
                "--device", str(dev)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        train_launcher.make_train_step = timed_step
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                params, losses = train_launcher.main(argv)
        finally:
            train_launcher.make_train_step = real_step
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(launched == want, f"mesh 1x1: launches {launched}, want {want}")
        routes = {name: dict(fn.route_launches) for name, fn in (
            ("train", fwd.flash_attention_train_cuda), ("inference", fwd.flash_attention_cuda),
            ("dq", fwd.flash_attention_bwd_dq_cuda), ("dkdv", fwd.flash_attention_bwd_dkdv_cuda))}
        check(routes == {"train": {"wgmma": want["flash_attention_train"], "simt": 0},
                         "inference": {"wgmma": 0, "simt": 0},
                         "dq": {"wgmma": want["flash_attention_bwd_dq"], "simt": 0},
                         "dkdv": {"wgmma": want["flash_attention_bwd_dkdv"], "simt": 0}},
              f"mesh 1x1: flash routes {routes}")
        check(losses == base["losses"], f"mesh 1x1 losses {losses} != unsharded {base['losses']}")
        unsharded = dict(_named(full_params))
        check(sorted(unsharded) == sorted(path for path, _ in _named(params)),
              "mesh 1x1: the final params' leaves differ from the unsharded run's")
        differ = [path for path, g in _named(params) if not torch.equal(g.cpu(), unsharded[path])]
        check(not differ, f"mesh 1x1: final params differ from the unsharded run's: {differ[:5]}")
        del params, full_params
        torch.cuda.empty_cache()
        ms = statistics.median(wall[1:]) * 1e3
        emit({"phase": "mesh", "part": "a_train_1x1", "arch": "granite-3-2b",
              "argv": " ".join(argv), "losses": losses, "losses_bitwise": True,
              "final_params_bitwise": True, "launches": launched,
              "launches_per_step": {k: v // steps for k, v in launched.items()},
              "flash_routes": routes, "wall_s": wall, "ms_per_step": ms,
              "ms_per_step_note": f"median of steps 2..{steps} (host clock, synchronised)",
              "max_memory_allocated": peak, "unsharded": {
                  "ms_per_step": base["ms_per_step"],
                  "max_memory_allocated": base["max_memory_allocated"]},
              "unsharded_pr26": {"ms_per_step": 1337.2, "max_memory_gb": 54.25,
                                 "card": "NVIDIA H100 80GB HBM3, 700.00 W"}})

    # (b) the dry run, collected; meanwhile, the card idle, the roofline
    # phase's meta counts in spawned processes beside the fake worlds
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=ROOFLINE_WORKERS, mp_context=spawn) as pool:
        futures = [pool.submit(count_on_meta, *run) for run in ROOFLINE_RUNS]
        link = rl.H100_SXM.ici_bw  # one card measures no link: the datasheet's NVLink rate
        bf16 = [rl.H100_SXM, dataclasses.replace(rl.measure_machine(dev, dtype=torch.bfloat16),
                                                 ici_bw=link)]
        fp64 = [rl.H100_SXM_FP64,
                dataclasses.replace(rl.measure_machine(dev, dtype=torch.float64), ici_bw=link)]
        for w in workers:
            w.join()
        worlds_s = time.perf_counter() - t_worlds
        for key, val in world_out.items():
            check(not isinstance(val, Exception),
                  f"mesh phase: the {key} fake world failed: {val}")
        records = world_out["train"][0]["records"] + world_out["prefill"][0]["records"]
        fednl = (world_out["prefill"][0]["fednl"]["records"]
                 + world_out["multi_pod"][0]["fednl"]["records"])
        one_card = world_out["prefill"][1]
        for rec in records:
            check(rec["status"] == "ok", f"mesh dry run {rec['arch']} {rec['shape']}: {rec}")
            emit(mesh_line(rec, bf16))
        for rec in fednl:
            check(rec["status"] == "ok", f"mesh dry run {rec['arch']} {rec['mesh']}: {rec}")
            got = {k: v for k, v in rec["collectives"].items() if v}
            check(got == {k: v for k, v in rec["closed_form"].items() if v},
                  f"{rec['arch']} {rec['mesh']}: collectives {got} != {rec['closed_form']}")
            emit({**mesh_line({**rec, "note": "w8a's d 301, n_i 348, 16 clients a data shard"},
                              fp64),
                  "closed_form": rec["closed_form"], "collectives_equal_closed_form": True})
        check(sum(one_card["coll"].values()) == 0,
              f"the 1 x 1 mesh's train step moved collective bytes: {one_card['coll']}")
        emit({"phase": "mesh", "part": "b_one_card_count", "arch": "granite-3-2b",
              "shape": f"train_4k, B {MESH_ONE_CARD_BATCH}, accum {TRAIN_ACCUM}", **one_card,
              "note": "its product flops are checked against the roofline phase's plain count"})
        t0 = time.perf_counter()
        counts = [f.result() for f in futures]
        counts_waited_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    emit({"phase": "mesh", "seconds": seconds, "fake_worlds_s": worlds_s,
          "roofline_counts_waited_s": counts_waited_s,
          "machines": [dataclasses.asdict(m) for m in bf16 + fp64]})
    return {"launches": launched, "ms_per_step": ms, "max_memory_allocated": peak,
            "one_card": one_card, "roofline_counts": counts, "seconds": seconds}


def _reports_bitwise(got, want) -> bool:
    """Two RunReports of one spec agree bit for bit: grad norms, f, x, bits."""
    return (
        got.rounds == want.rounds
        and [g.hex() for g in got.grad_norms] == [g.hex() for g in want.grad_norms]
        and [r.f for r in got.records] == [r.f for r in want.records]
        and bool(np.array_equal(got.x, want.x))
        and list(got.sent_bits) == list(want.sent_bits)
        and list(got.sent_bits_wire) == list(want.sent_bits_wire)
    )


def _group_against_solves(label: str, rep, specs, z_np, solve) -> dict:
    """Each spec of a batched group against its own solve() on the card:
    sent_bits exact every round, grad norms within TRAJECTORY_RTOL where the
    solve's is >= SWEEP_GN_FLOOR, ls_steps exact; whether each is bitwise."""
    out = {"bitwise": [], "max_rel_gn": 0.0, "max_rel_x": 0.0, "seq_ms_per_round": []}
    for spec, got in zip(specs, rep.reports):
        want = solve(spec, z=z_np)
        name = f"{label} seed={spec.seed} {spec.compressor.name}"
        check(got.extras.get("sweep_batched") is True, f"{name}: not batched")
        check(got.rounds == want.rounds == spec.rounds, f"{name}: rounds {got.rounds}")
        check(list(got.sent_bits) == list(want.sent_bits), f"{name}: sent_bits differ")
        check(bool(np.all(np.isfinite(got.x))) and got.x.shape == want.x.shape, f"{name}: x")
        live = want.grad_norms >= SWEEP_GN_FLOOR
        rel = np.abs(got.grad_norms[live] - want.grad_norms[live]) / want.grad_norms[live]
        check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{name}: grad norms differ: {rel.max()}")
        if spec.algorithm == "fednl-ls":
            # exact above the Armijo test's rounding band (ROADMAP C6)
            band = want.grad_norms < LS_EXACT_FLOOR
            differ = [r for r in range(want.rounds) if got.ls_steps[r] != want.ls_steps[r]]
            check(all(band[r] for r in differ), f"{name}: ls_steps differ at rounds {differ}")
            out.setdefault("ls_steps_differ_in_band", []).append(differ)
        out["bitwise"].append(_reports_bitwise(got, want))
        out["max_rel_gn"] = max(out["max_rel_gn"], float(rel.max()) if rel.size else 0.0)
        out["max_rel_x"] = max(out["max_rel_x"], float(
            np.max(np.abs(got.x - want.x)) / np.max(np.abs(want.x))))
        out["seq_ms_per_round"].append(want.wall_time_s / want.rounds * 1e3)
    return out


def where_group_parts(group, z) -> dict:
    """Where a batched group parts, bit for bit, from the sequential rounds:
    spec by spec, the group's state after init and after each of two rounds
    against the sequential round's, then each op of the round from the same
    inputs (the sequential run's state) as the batched round computes it,
    against the op on the spec's lone tensors as its own round computes it:
    the client oracles (f, grad, the SYRK rows), the clients' Frobenius
    norms, the means over clients, the grad norm, the master's Cholesky
    factor and solve."""
    import torch

    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.core.fednl_batch import _aligned, _client_frob_norms, batch_oracles
    from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, unpack_triu
    from repro_torch.objectives.logreg import logreg_oracles_packed

    n, _, d = z.shape
    specs = group.specs
    lam = specs[0].lam
    count = len(specs)
    out = {"specs": [f"seed={spec.seed} {spec.compressor.name}" for spec in specs]}
    seq = [fednl_init(z, spec.fednl_config(), seed=spec.seed) for spec in specs]
    out["init_h_local"] = [bits_equal(group.state.h_local[s], seq[s].h_local) for s in range(count)]
    rounds = [make_fednl_round(z, spec.fednl_config()) for spec in specs]
    state = group.state
    for r in range(2):
        state, _ = group.round_fn(state)
        seq = [rounds[s](seq[s])[0] for s in range(count)]
        out[f"round{r}_x"] = [bits_equal(state.x[s], seq[s].x) for s in range(count)]
        out[f"round{r}_h_global"] = [bits_equal(state.h_global[s], seq[s].h_global)
                                     for s in range(count)]
    f_b, grad_b, hess_b = batch_oracles(z, torch.stack([st.x for st in seq]), lam, True)
    delta_b = hess_b - torch.stack([st.h_local for st in seq]).view(count * n, -1)
    one = [logreg_oracles_packed(z, st.x, lam) for st in seq]  # lone tensors, as solve() has
    g_lone = [torch.mean(o[1], dim=0) for o in one]
    grads = torch.stack(g_lone)
    eye = torch.eye(d, dtype=torch.float64, device=z.device)
    h_lone = [unpack_triu(st.h_global, d) + lam * eye for st in seq]
    h = torch.stack(h_lone)
    h_local = torch.stack([st.h_local for st in seq])
    checks = {
        "oracle_f": lambda s: bits_equal(f_b[s], one[s][0]),
        "oracle_grad": lambda s: bits_equal(grad_b[s], one[s][1]),
        "oracle_syrk_rows": lambda s: bits_equal(hess_b[s * n:(s + 1) * n], one[s][2]),
        "client_frob_norms": lambda s: bits_equal(
            _client_frob_norms(delta_b, count, d)[s],
            frob_norm_from_packed(one[s][2] - seq[s].h_local, d)),
        "mean_grad_over_clients": lambda s: bits_equal(
            torch.mean(grad_b, dim=1)[s], torch.mean(one[s][1], dim=0)),
        "mean_f_over_clients": lambda s: bits_equal(
            torch.mean(_aligned(f_b), dim=1)[s], torch.mean(one[s][0])),
        "mean_h_over_clients": lambda s: bits_equal(
            torch.mean(h_local, dim=1)[s], torch.mean(seq[s].h_local, dim=0)),
        "grad_norm": lambda s: bits_equal(
            torch.linalg.vector_norm(_aligned(grads), dim=-1)[s],
            torch.linalg.vector_norm(g_lone[s])),
        "cholesky_factor": lambda s: bits_equal(
            torch.linalg.cholesky_ex(h)[0][s], torch.linalg.cholesky_ex(h_lone[s])[0]),
        "cholesky_solve": lambda s: bits_equal(
            cholesky_solve(h, grads)[s], cholesky_solve(h_lone[s], g_lone[s])),
    }
    for name, fn in checks.items():
        out[name] = [fn(s) for s in range(count)]
    return out


def slot_alignment(z, x, h_local, lam: float, count: int = 12) -> dict:
    """Whether an op of the batched round gives a spec bits that depend on
    its slot: one spec's inputs stacked in ``count`` slots, each slot's
    result against slot 0's and against the op on the lone tensor (a fresh
    allocation, as in the spec's own round), on the stacked rows as they lie
    ("raw": a spec's block starts s * size elements in) and as
    ``fednl_batch._aligned`` lays them (each block on a 32-byte boundary).
    Returns, per op, the slots that differ."""
    import torch

    from repro_torch.core.fednl_batch import _aligned, _client_frob_norms
    from repro_torch.linalg import cholesky_solve, frob_norm_from_packed, unpack_triu
    from repro_torch.objectives.logreg import _matvec, _softplus, logreg_oracles_packed

    n, _, d = z.shape
    f_c, g_c, hess = logreg_oracles_packed(z, x, lam)
    g = torch.mean(g_c, dim=0)
    delta = hess - h_local
    soft = _softplus(-_matvec(z, x))
    h = unpack_triu(torch.mean(h_local, dim=0), d) + lam * torch.eye(
        d, dtype=torch.float64, device=z.device)

    def stack(v):
        return v.repeat(count, *([1] * v.ndim))

    ops = {  # name: (raw, aligned or None, lone)
        f"mean_over_clients ({count}, {n})": (
            lambda: torch.mean(stack(f_c), dim=1),
            lambda: torch.mean(_aligned(stack(f_c)), dim=1), torch.mean(f_c)),
        f"mean_over_samples ({count}, {n}, {soft.shape[-1]})": (
            lambda: torch.mean(stack(soft), dim=-1),
            lambda: torch.mean(_aligned(stack(soft)), dim=-1), torch.mean(soft, dim=-1)),
        f"sum_of_squares ({count}, {d})": (
            lambda: torch.sum(stack(x * x), dim=-1),
            lambda: torch.sum(_aligned(stack(x * x)), dim=-1), torch.sum(x * x)),
        f"vector_norm ({count}, {d})": (
            lambda: torch.linalg.vector_norm(stack(g), dim=-1),
            lambda: torch.linalg.vector_norm(_aligned(stack(g)), dim=-1),
            torch.linalg.vector_norm(g)),
        f"client_frob_norms ({count} x {n}, {delta.shape[-1]})": (
            lambda: frob_norm_from_packed(stack(delta).view(count * n, -1), d).view(count, n),
            lambda: _client_frob_norms(stack(delta).view(count * n, -1), count, d),
            frob_norm_from_packed(delta, d)),
        f"mean_over_clients_of_grads ({count}, {n}, {d})": (
            lambda: torch.mean(stack(g_c), dim=1), None, g),
        f"cholesky_factor ({count}, {d}, {d})": (
            lambda: torch.linalg.cholesky_ex(stack(h))[0], None, torch.linalg.cholesky_ex(h)[0]),
        f"cholesky_solve ({count}, {d}, {d})": (
            lambda: cholesky_solve(stack(h), stack(g)), None, cholesky_solve(h, g)),
    }
    out = {}
    for name, (raw_fn, aligned_fn, lone) in ops.items():
        row = {}
        for layout, fn in (("raw", raw_fn), ("aligned", aligned_fn)):
            if fn is None:
                continue
            got = fn()
            row[f"{layout}_slots_not_slot0"] = [
                s for s in range(count) if not bits_equal(got[s], got[0])]
            row[f"{layout}_slots_not_lone"] = [
                s for s in range(count) if not bits_equal(got[s], lone)]
        out[name] = row
    return out


def sweep_phase(ops) -> dict:
    """Phase 8: the README's 4 seeds x {topk, randseqk, natural} grid at w8a
    through solve_many, one batched group; then a 2-spec FedNL-LS group."""
    import torch

    from repro_torch.api import DataSpec, ExperimentSpec, solve, solve_many
    from repro_torch.api.batch import make_group, plan_sweep

    base = ExperimentSpec(data=DataSpec(dataset="w8a", seed=0), rounds=SWEEP_ROUNDS)
    sweep = base.grid(seed=range(4), compressor=["topk", "randseqk", "natural"])
    specs = sweep.specs()
    plans, _ = plan_sweep(specs, sweep.batch)
    check([(p.kind, len(p.indices)) for p in plans] == [("batch", 12)],
          f"the README grid plans as {[(p.kind, p.indices) for p in plans]}")
    z_np = base.data.build()
    n_clients = z_np.shape[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = solve_many(sweep)
    launches = launch_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update(select_topk=SWEEP_ROUNDS + 1, select_randseqk=SWEEP_ROUNDS + 1,
                threefry_uniform=SWEEP_ROUNDS + 1, threefry_uniform_float64=SWEEP_ROUNDS + 1,
                hessian_syrk_packed=SWEEP_ROUNDS + 2)
    check(launches == want, f"sweep launches {launches}, want {want}")
    check(len(rep.log) == 1 and rep.log[0].startswith("batched 12 specs as one group")
          and f"{12 * n_clients} clients a SYRK launch" in rep.log[0], f"sweep log {rep.log}")
    check(rep.extras["batched_specs"] == 12, f"sweep extras {rep.extras}")
    group_ms = rep.reports[0].extras["batch_wall_time_s"] / SWEEP_ROUNDS * 1e3
    against = _group_against_solves("sweep", rep, specs, z_np, solve)

    # one batched round without a host sync, and 3 under the profiler
    z = torch.as_tensor(z_np, dtype=torch.float64, device="cuda").contiguous()
    group = make_group(specs, z)
    warm, _ = group.round_fn(group.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        group.round_fn(warm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    group_trace = trace_rounds(group.round_fn, group.state, 3)
    slots = slot_alignment(z, warm.x[0], warm.h_local[0], specs[0].lam)
    parts = where_group_parts(group, z)
    emit({"phase": "sweep", "part": "where_the_group_parts", "slot_alignment": slots,
          "bitwise_by_op": parts})
    by_slot = {name: row["aligned_slots_not_slot0"] for name, row in slots.items()
               if row.get("aligned_slots_not_slot0")}
    check(not by_slot, f"rows laid from 32-byte boundaries still differ by slot: {by_slot}")
    # TopK draws nothing, so its four seeds compute one trajectory: in
    # slots 0-3 of the group they must agree bit for bit
    topk = [r for spec, r in zip(specs, rep.reports) if spec.compressor.name == "topk"]
    check(len(topk) == 4 and all(_reports_bitwise(r, topk[0]) for r in topk),
          "the group's TopK specs differ by slot")
    del group, warm, z

    ls_specs = base.replace(algorithm="fednl-ls", rounds=LS_GROUP_ROUNDS).grid(seed=[0, 1]).specs()
    ops.reset_launch_counts()
    rep_ls = solve_many(ls_specs)
    ls_launches = launch_counts(ops)
    check(rep_ls.extras["batched_specs"] == 2, f"LS group log {rep_ls.log}")
    check(ls_launches["hessian_syrk_packed"] == LS_GROUP_ROUNDS + 2
          and ls_launches["select_topk"] == LS_GROUP_ROUNDS + 1, f"LS launches {ls_launches}")
    ls_against = _group_against_solves("ls", rep_ls, ls_specs, z_np, solve)
    check(_reports_bitwise(rep_ls.reports[1], rep_ls.reports[0]),
          "the LS group's two TopK specs differ by slot")

    out = {
        "phase": "sweep", "grid": "w8a seed=range(4) x compressor=[topk, randseqk, natural]",
        "specs": len(specs), "rounds": SWEEP_ROUNDS, "clients_per_syrk_launch": 12 * n_clients,
        "log": rep.log, "launches": launches,
        "group_ms_per_round": group_ms,
        "sequential_ms_per_round_sum": sum(against["seq_ms_per_round"]),
        "sequential_ms_per_round": against["seq_ms_per_round"],
        "group_init_s": rep.reports[0].extras["batch_init_time_s"],
        "peak_memory_bytes": peak,
        "bitwise_vs_solve": against["bitwise"],
        "max_rel_grad_norm_vs_solve": against["max_rel_gn"],
        "max_rel_x_vs_solve": against["max_rel_x"],
        "final_grad_norms": [r.grad_norms[-1] for r in rep.reports],
        "one_round_without_host_sync": True,
        "topk_slots_bitwise_equal": True,
        "trace": group_trace,
        "ls_group": {
            "specs": 2, "rounds": LS_GROUP_ROUNDS, "log": rep_ls.log, "launches": ls_launches,
            "bitwise_vs_solve": ls_against["bitwise"],
            "max_rel_grad_norm_vs_solve": ls_against["max_rel_gn"],
            "ls_steps": [list(map(int, r.ls_steps)) for r in rep_ls.reports],
            "ls_steps_differ_in_band": ls_against["ls_steps_differ_in_band"],
            "slots_bitwise_equal": True,
            "grad_norms": [list(r.grad_norms) for r in rep_ls.reports],
            "group_ms_per_round": rep_ls.reports[0].extras["batch_wall_time_s"]
            / LS_GROUP_ROUNDS * 1e3,
            "sequential_ms_per_round_sum": sum(ls_against["seq_ms_per_round"]),
        },
    }
    emit(out)
    return launches, out


def session_phase() -> dict:
    """Phase 9: a w8a TopK session stepped 3 rounds, saved, run to 10, and
    restored from its FNLS1 file and run to 10: both equal solve(rounds=10)
    on the card bit for bit; the file round-trips byte for byte."""
    from repro_torch.api import (
        DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=SESSION_ROUNDS)
    z_np = spec.data.build()
    want = solve(spec, z=z_np)
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path, again = where / "w8a_topk.fnlsess", where / "w8a_topk_again.fnlsess"
    with open_session(spec, z=z_np) as s:
        s.step(SESSION_SAVE_AT)
        s.save(path)
        stepped = s.run()
    with open_session(spec, z=z_np, restore=path) as s:
        check(s.round == SESSION_SAVE_AT, f"restored at round {s.round}")
        resumed = s.run()
    check(_reports_bitwise(stepped, want), "session step(3) + run != solve(rounds=10)")
    check(_reports_bitwise(resumed, want), "restored session != solve(rounds=10)")
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "FNLS1 load -> save changed the bytes")
    out = {
        "phase": "session", "spec": "w8a topk rounds=10", "saved_at": SESSION_SAVE_AT,
        "stepped_bitwise_vs_solve": True, "restored_bitwise_vs_solve": True,
        "fnls1_bytes": path.stat().st_size, "fnls1_round_trip_byte_identical": True,
        "grad_norms": list(want.grad_norms), "device": want.extras["device"],
    }
    path.unlink()
    again.unlink()
    emit(out)
    return out


def count_syncs(step) -> int:
    """Host syncs that ``step()`` makes, as torch.cuda.set_sync_debug_mode
    ("warn") reports them (one warning a synchronizing call)."""
    return count_syncs_at(step)[0]


def _rel(got, want, floor: float) -> np.ndarray:
    got, want = np.asarray(got), np.asarray(want)
    keep = want >= floor
    return np.abs(got[keep] - want[keep]) / want[keep]


def _norms_close(got, want) -> bool:
    """Grad norms within TRAJECTORY_RTOL * norm + STAR_GN_ATOL where the
    reference norm is at least STAR_GN_FLOOR."""
    got, want = np.asarray(got), np.asarray(want)
    keep = want >= STAR_GN_FLOOR
    return bool(np.all(np.abs(got[keep] - want[keep])
                       <= TRAJECTORY_RTOL * want[keep] + STAR_GN_ATOL))


def star_phase(ops, dev, cpu_side: CpuSide) -> dict:
    """Phase 10: the wire stack on the card.  (a) star-loopback at w8a's
    whole shape, TopK (10 rounds) and TopLEK (3), against the card's local
    solve; launches, syncs and ms per round; (b) each codec's one-row encode
    on the card against the CPU's bytes; (c) FedNL-PP with RandK over
    loopback, tau 71, 20% dropout resampled, against the same run on the
    CPU; (d) star-tcp with 8 client processes at w8a's per-client width
    against loopback at that shape; (e) a star session saved at round 3 and
    restored.  (c)'s CPU run goes to ``cpu_side``'s worker at the start;
    out["finish"] checks (c) against it.  Returns what the kernels line
    needs."""
    import torch

    from repro_torch import prng
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, FaultSpec, open_session, solve)
    from repro_torch.comm import wire
    from repro_torch.comm.star import run_star_master
    from repro_torch.compressors import get_compressor
    from repro_torch.kernels import compressor_select as tcs
    from repro_torch.launch.multiproc import ClientCluster
    from repro_torch.linalg import triu_size

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=STAR_ROUNDS)
    star_spec = spec.replace(backend="star-loopback")
    z_np = spec.data.build()
    n_clients, n_i, d = z_np.shape
    t_len, k = triu_size(d), spec.fednl_config().k_for(d)
    out: dict = {}
    # (c)'s spec, its CPU run queued in the worker from the start
    pp_spec = ExperimentSpec(
        data=DataSpec(dataset="w8a"), algorithm="fednl-pp", tau=PP_TAU, rounds=STAR_ROUNDS,
        compressor=CompressorSpec("randk"), fault=FaultSpec(drop_prob=STAR_PP_DROP),
        on_dropout="resample", backend="star-loopback",
    )
    pp_job = cpu_side.submit(solve_cpu_side, pp_spec, z_np)

    # (a) star-loopback, TopK and TopLEK, each with the counts set to 0 before it
    def star_path(label, path_spec, per_client_round):
        local = solve(path_spec, z=z_np, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rep = solve(path_spec.replace(backend="star-loopback"), z=z_np, device=dev)
        launches = launch_counts(ops)
        rounds = path_spec.rounds
        want = {name: 0 for name in launches}
        want["hessian_syrk_packed"] = n_clients * (rounds + 1)
        want[per_client_round] = n_clients * rounds
        check(launches == want, f"{label}: launches {launches}, want {want}")
        check(rep.rounds == rounds and bool(np.all(np.isfinite(rep.grad_norms))),
              f"{label}: grad norms {rep.grad_norms}")
        rel = _rel(rep.grad_norms, local.grad_norms, STAR_GN_FLOOR)
        check(_norms_close(rep.grad_norms, local.grad_norms),
              f"{label}: star vs local grad norms differ: {rel}")
        check(list(rep.sent_bits) == list(local.sent_bits),
              f"{label}: sent_bits {rep.sent_bits} vs local {local.sent_bits}")
        check(list(rep.extras["measured_payload_bits"]) == list(rep.sent_bits_payload),
              f"{label}: measured payload bits differ from the analytic bits")
        check(list(8 * rep.extras["measured_frame_bytes"]) == list(local.sent_bits_wire),
              f"{label}: measured frames differ from the wire model")
        emit({
            "phase": "star", "part": "a", "path": label, "device": rep.extras["device"],
            "rounds": rounds, "clients": n_clients, "launches": launches,
            "grad_norms": rep.grad_norms.tolist(), "local_grad_norms": local.grad_norms.tolist(),
            "rel_err_above_floor": rel.tolist(), "floor": STAR_GN_FLOOR,
            "abs_err": np.abs(rep.grad_norms - local.grad_norms).tolist(),
            "rtol": TRAJECTORY_RTOL, "atol": STAR_GN_ATOL,
            "bitwise_vs_local": bool(np.array_equal(rep.grad_norms, local.grad_norms)),
            "sent_bits": rep.sent_bits.tolist(),
            "measured_frame_bytes": rep.extras["measured_frame_bytes"].tolist(),
            "init_time_s": rep.init_time_s, "ms_per_round": rep.wall_time_s / rounds * 1e3,
            "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
        })
        return rep, launches

    topk_rep, out["topk_launches"] = star_path(
        f"w8a star-loopback topk rounds={STAR_ROUNDS}", spec, "select_topk_idx")
    _, out["toplek_launches"] = star_path(
        f"w8a star-loopback toplek rounds={STAR_LEK_ROUNDS}",
        spec.replace(compressor=CompressorSpec("toplek"), rounds=STAR_LEK_ROUNDS),
        "select_toplek_idx")

    # (e) a session: syncs counted in round 2, saved at round 3, restored
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path = where / "w8a_star.fnlsess"
    with open_session(star_spec, z=z_np, device=dev) as s:
        s.step(1)
        syncs = count_syncs(lambda: s.step(1))
        star_trace = trace(lambda: s.step(1), 1, "round")
        s.step(SESSION_SAVE_AT - s.round)
        s.save(path)
        stepped = s.run()
    with open_session(star_spec, z=z_np, restore=path, device=dev) as s:
        check(s.round == SESSION_SAVE_AT, f"star session restored at round {s.round}")
        resumed = s.run()
    for label, rep in (("stepped", stepped), ("restored", resumed)):
        check(_reports_bitwise(rep, topk_rep), f"star session {label} != the uninterrupted run")
        check(list(rep.extras["measured_frame_bytes"]) ==
              list(topk_rep.extras["measured_frame_bytes"]), f"star session {label}: frames")
    emit({"phase": "star", "part": "e", "spec": f"w8a star-loopback topk rounds={STAR_ROUNDS}",
          "saved_at": SESSION_SAVE_AT, "stepped_bitwise": True, "restored_bitwise": True,
          "fnls1_bytes": path.stat().st_size,
          "host_syncs_per_round": syncs, "host_syncs_per_client_round": syncs / n_clients,
          "trace_third_round": star_trace,
          "note": "syncs: set_sync_debug_mode('warn') warnings over round 2 of the "
                  "session; every uplink leaves the card as bytes; the third round under "
                  "torch.profiler"})
    path.unlink()
    out["syncs_per_round"] = syncs

    # (b) each codec's one-row encode on the card against the CPU's
    rng = np.random.default_rng(10)
    rows = {
        "heavy_tailed": rng.standard_normal(t_len) * np.exp(rng.uniform(-20, 0, t_len)),
        "kept_zeros": np.where(rng.uniform(size=t_len) < 0.97, 0.0, rng.standard_normal(t_len)),
        "near_ties": near_tie_rows(1, t_len, 11)[0],
    }
    key = prng.split_one(prng.split(prng.prng_key(0), 2)[1], n_clients, 0)
    unif = float(prng.uniform(key))
    codecs = {}
    for name in ("identity", "topk", "randk", "randseqk", "toplek", "natural"):
        comp = get_compressor(name, t_len, k)
        card, cpu = wire.make_codec(comp, t_len, dev), wire.make_codec(comp, t_len, "cpu")
        boundary = 0
        for row_name, u in rows.items():
            got = card.encode(key, torch.as_tensor(u, device=dev))
            want = cpu.encode(key, torch.as_tensor(u))
            if name == "toplek" and got.sent_elems != want.sent_elems:
                check(abs(got.sent_elems - want.sent_elems) == 1
                      and toplek_near_boundary(u, k, unif),
                      f"codec toplek {row_name}: kept {got.sent_elems} vs {want.sent_elems}")
                boundary += 1
                continue
            check(got.data == want.data and got.bits == want.bits,
                  f"codec {name} {row_name}: card bytes differ from the CPU's")
            dec = card.decode(got.data, got.sent_elems)
            check(bits_equal(dec.cpu(), cpu.decode(want.data, want.sent_elems)),
                  f"codec {name} {row_name}: decodes differ")
        codecs[name] = {"rows": sorted(rows), "bytes_equal": True, "boundary_rows": boundary,
                        "bits_heavy_tailed": cpu.encode(key, torch.as_tensor(rows["heavy_tailed"])).bits}
    emit({"phase": "star", "part": "b", "codecs": codecs, "T": t_len, "k": k,
          "boundary_tol": TOPLEK_BOUNDARY})

    # (c) FedNL-PP over loopback: RandK, tau 71, 20% dropout resampled
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pp = solve(pp_spec, z=z_np, device=dev)
    pp_launches = launch_counts(ops)
    contributions = sum(len(p) for p in pp.participants)
    want = {name: 0 for name in pp_launches}
    # a participant: SYRK, and threefry + TopK by keys three times (its
    # encode, the decode of its own message, the master's decode)
    want.update(hessian_syrk_packed=n_clients + contributions,
                threefry_uniform=3 * contributions, threefry_uniform_float32=3 * contributions,
                select_topk_by_keys_idx=3 * contributions)
    check(pp_launches == want, f"PP star launches {pp_launches}, want {want}")
    check(sum(len(x) for x in pp.dropped) > 0, "PP star: no client dropped")
    pp_line = {"phase": "star", "part": "c", "spec": f"w8a fednl-pp randk tau={PP_TAU} drop_prob="
               f"{STAR_PP_DROP} resample rounds={STAR_ROUNDS}", "launches": pp_launches,
               "contributions": contributions, "drops": sum(len(x) for x in pp.dropped),
               "final_grad_norm": pp.final_grad_norm,
               "ms_per_round": pp.wall_time_s / pp.rounds * 1e3}

    def finish_c() -> None:
        """(c) against the worker's CPU run, once it is in (the caller's
        choice: it queues behind nothing, so the later the less it waits)."""
        pp_cpu, worker = pp_job.result()
        check(pp.participants == pp_cpu.participants,
              "PP star: participants differ from the CPU's")
        check(pp.dropped == pp_cpu.dropped, "PP star: drops differ from the CPU's")
        check(list(pp.sent_bits) == list(pp_cpu.sent_bits),
              "PP star: sent_bits differ from the CPU's")
        xh, xh_cpu = np.asarray(pp.x_hist), np.asarray(pp_cpu.x_hist)
        pp_rel = np.linalg.norm(xh - xh_cpu, axis=1) / np.linalg.norm(xh_cpu, axis=1)
        check(bool(np.all(pp_rel <= TRAJECTORY_RTOL)),
              f"PP star: card vs CPU models differ {pp_rel}")
        emit({**pp_line, "participants_exact": True, "x_rel_err_vs_cpu": pp_rel.tolist(),
              "cpu_side": worker})

    out["by_keys_idx_launches"] = pp_launches
    out["finish"] = finish_c

    # (d) star-tcp: 8 client processes at w8a's per-client width
    tcp_spec = ExperimentSpec(data=DataSpec(dataset="w8a", shape=TCP_SHAPE), rounds=TCP_ROUNDS)
    cfg = tcp_spec.fednl_config()
    t0 = time.perf_counter()
    cluster = ClientCluster("w8a", TCP_SHAPE, tcp_spec.seed, cfg=cfg, device=str(dev),
                            data_seed=tcp_spec.data.seed)
    spawn_s = time.perf_counter() - t0
    try:
        tcp = run_star_master(cluster.conns, cluster.d, cfg, rounds=TCP_ROUNDS, device=dev)
    finally:
        cluster.close(join_timeout=120)
    check(cluster.exit_codes() == [0] * TCP_SHAPE[1], f"TCP clients' exit codes {cluster.exit_codes()}")
    loop = solve(tcp_spec.replace(backend="star-loopback"), device=dev)
    check(list(tcp.sent_bits) == list(loop.sent_bits), "TCP vs loopback: sent_bits")
    check(list(tcp.measured_payload_bits) == list(loop.extras["measured_payload_bits"]),
          "TCP vs loopback: measured payload bits")
    check(list(tcp.measured_frame_bytes) == list(loop.extras["measured_frame_bytes"]),
          "TCP vs loopback: frame bytes")
    tcp_rel = _rel(tcp.grad_norms, loop.grad_norms, STAR_GN_FLOOR)
    check(_norms_close(tcp.grad_norms, loop.grad_norms), f"TCP vs loopback grad norms {tcp_rel}")
    emit({"phase": "star", "part": "d", "spec": f"star-tcp w8a shape={TCP_SHAPE} topk "
          f"rounds={TCP_ROUNDS}", "client_processes": TCP_SHAPE[1], "exit_codes": cluster.exit_codes(),
          "spawn_and_accept_s": spawn_s, "ms_per_round": tcp.wall_time_s / TCP_ROUNDS * 1e3,
          "loopback_ms_per_round": loop.wall_time_s / loop.rounds * 1e3,
          "grad_norms": tcp.grad_norms.tolist(), "rel_err_vs_loopback": tcp_rel.tolist(),
          "bitwise_vs_loopback": bool(np.array_equal(tcp.grad_norms, loop.grad_norms)),
          "measured_frame_bytes": tcp.measured_frame_bytes.tolist()})

    # the index forms at the star path's shape, one client, against their plain versions
    u1 = torch.as_tensor(rows["heavy_tailed"][None], device=dev).contiguous()
    keys1 = torch.as_tensor(rng.uniform(size=(1, t_len)).astype(np.float32), device=dev)
    unif1 = torch.tensor([unif], dtype=torch.float64, device=dev)
    idx_err = {}
    for name, kern, plain in (
        ("select_topk_idx", lambda: tcs.select_topk_idx_cuda(u1, k),
         lambda: tcs.select_topk_idx_plain(u1, k)),
        ("select_topk_by_keys_idx", lambda: tcs.select_topk_by_keys_idx_cuda(u1, keys1, k),
         lambda: tcs.select_topk_by_keys_idx_plain(u1, keys1, k)),
        ("select_toplek_idx", lambda: tcs.select_toplek_idx_cuda(u1, k, unif1),
         lambda: tcs.select_toplek_idx_plain(u1, k, unif1)),
    ):
        got, want = kern(), plain()
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"{name}: sent or idx differ from the plain version at (1, {t_len})")
        check(bits_equal(got[0], want[0]), f"{name}: u_hat differs from the plain version")
        idx_err[name] = (got[0] - want[0]).abs().max().item()
    ukeys = u1.abs().float()
    idx_ms = {
        "select_topk_idx": median_ms({
            "kernel": lambda: tcs.select_topk_idx_cuda(u1, k),
            "plain": lambda: tcs.select_topk_idx_plain(u1, k),
            "dense_form": lambda: tcs.select_topk_cuda(u1, k),
            "library": lambda: torch.topk(ukeys, k, dim=-1)}),
        "select_topk_by_keys_idx": median_ms({
            "kernel": lambda: tcs.select_topk_by_keys_idx_cuda(u1, keys1, k),
            "plain": lambda: tcs.select_topk_by_keys_idx_plain(u1, keys1, k),
            "dense_form": lambda: tcs.select_topk_by_keys_cuda(u1, keys1, k),
            "library": lambda: torch.topk(keys1, k, dim=-1)}),
        "select_toplek_idx": median_ms({
            "kernel": lambda: tcs.select_toplek_idx_cuda(u1, k, unif1),
            "plain": lambda: tcs.select_toplek_idx_plain(u1, k, unif1),
            "dense_form": lambda: tcs.select_toplek_cuda(u1, k, unif1)}),
    }
    kept1 = int(tcs.select_toplek_idx_cuda(u1, k, unif1)[1])
    p2 = 1 << (k - 1).bit_length()
    sort_ops = p2.bit_length() * (p2.bit_length() - 1) // 2 * (p2 // 2) * 2
    idx_bound = {  # u read, u_hat written, idx written, sent (and keys / unif read)
        "select_topk_idx": bound(t_len * 16 + k * 4 + 4, SELECT_OPS_PER_KEY * t_len,
                                 CUDA_CORE_32BIT_OPS),
        "select_topk_by_keys_idx": bound(t_len * 4 + k * 8 + t_len * 8 + k * 4 + 4,
                                         SELECT_OPS_PER_KEY * t_len, CUDA_CORE_32BIT_OPS),
        "select_toplek_idx": bound(t_len * 16 + 8 + kept1 * 4 + 4,
                                   SELECT_OPS_PER_KEY * t_len + 2 * sort_ops, CUDA_CORE_32BIT_OPS),
    }
    emit({"phase": "star", "part": "index_forms", "shape": [1, t_len], "k": k,
          "times_ms": idx_ms, "bound_ms": idx_bound, "max_abs_err": idx_err,
          "note": f"ms per call at the star path's one-client shape: median over {TIMED_REPS} "
                  f"event pairs around {CALLS_PER_EVENT} calls; dense_form = the same kernel "
                  "without the index output; library = torch.topk on the same f32 keys "
                  "(TopLEK has none)"})
    out.update(idx_ms=idx_ms, idx_bound=idx_bound, idx_err=idx_err, topk_rep=topk_rep, z_np=z_np)
    return out


def _tree_levels(topo, n_clients: int) -> tuple[int, int]:
    """(root subtrees, aggregators in all) of a resolved tree."""
    shape = topo.resolve(n_clients)

    def count(sub) -> int:
        return 1 + sum(count(c) for c in sub if isinstance(c, tuple))

    return len(shape), sum(count(sub) for sub in shape)


def _agg_root_bytes(measured: int, n_leaves: int, n_root_aggs: int) -> int:
    """The bytes of the exact tree's AGG frames at the root in one round: a
    32-byte header and a 4-byte count per frame, and per leaf entry a
    24-byte head and the leaf's payload (its frame less the 32-byte header)."""
    return 36 * n_root_aggs + measured - 8 * n_leaves


def topology_phase(ops, dev, star: dict, cpu_side: CpuSide) -> tuple[dict, list]:
    """Phase 11: the tree of stars, bounded-staleness async aggregation and
    elastic membership on the card at w8a, through solve and open_session on
    star-loopback and star-tcp.  (a) the exact tree (fanout 4, depth 3: 20
    aggregators), TopK 10 rounds, bit for bit the flat star of phase 10 with
    its launch counts; (a') the same tree with RandK, 3 rounds, against the
    flat star's RandK; (b) combine="sum" (fanout 12, depth 2) within 1e-12 of
    the flat star's x, bits exact; (c) async: staleness 0 bit for bit the
    flat star, then staleness 2 over 20 rounds twice on the card and once on
    the CPU; (d) elastic: 12 joins at round 2, 12 leaves at round 5, against
    the CPU; (e) a TCP process tree of 2 aggregators of 4 clients each against
    the loopback tree; (f) sessions restored by replay; (g) obs: hop spans,
    frame counters and a profiled tree round.  (c)'s and (d)'s CPU runs go to
    ``cpu_side``'s worker at the start.  Returns the launch counts, and the
    functions that check (c) and (d) against the CPU runs."""
    import torch

    from repro_torch import obs
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, MembershipEvent, MembershipSpec,
        TopologySpec, open_session, solve)
    from repro_torch.comm.topology import make_master
    from repro_torch.launch.multiproc import ClientCluster, TreeClientCluster

    t_phase = time.perf_counter()
    z_np = star["z_np"]
    n_clients, _, d = z_np.shape
    base = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=TREE_ROUNDS, backend="star-loopback")
    flat = star["topk_rep"]  # phase 10's flat star-loopback TopK run, 10 rounds
    exact = TopologySpec(kind="tree", fanout=4, depth=3, combine="exact")
    n_root, n_aggs = _tree_levels(exact, n_clients)
    out: dict = {}
    # (c)'s and (d)'s specs, their CPU runs queued in the worker from the start
    async_topo = TopologySpec(mode="async", staleness=2, max_delay=3, schedule_seed=0)
    async_spec = base.replace(topology=async_topo, rounds=ASYNC_ROUNDS)
    events = tuple([MembershipEvent(ELASTIC_JOIN_AT, "join", c) for c in ELASTIC_JOINERS]
                   + [MembershipEvent(ELASTIC_LEAVE_AT, "leave", c) for c in ELASTIC_LEAVERS])
    el_spec = base.replace(membership=MembershipSpec(events=events), rounds=ELASTIC_ROUNDS)
    cpu_jobs = {"async": cpu_side.submit(solve_cpu_side, async_spec, z_np),
                "elastic": cpu_side.submit(solve_cpu_side, el_spec, z_np)}
    finish: list = []  # (c)'s and (d)'s checks against the CPU runs, for the caller
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)

    def reset():
        torch.cuda.synchronize()
        ops.reset_launch_counts()

    def zero_but(**want) -> dict:
        got = launch_counts(ops)
        return {name: want.get(name, 0) for name in got}

    def frames_bitwise(got, want) -> bool:
        return (list(got.extras["measured_frame_bytes"]) == list(want.extras["measured_frame_bytes"])
                and list(got.extras["measured_payload_bits"])
                == list(want.extras["measured_payload_bits"]))

    # (a) the exact tree, TopK, as a session stepped 3, saved, run to 10
    tree_spec = base.replace(topology=exact)
    tree_path = where / "w8a_tree.fnlsess"
    reset()
    with open_session(tree_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(tree_path)
        tree = s.run()
    launches = launch_counts(ops)
    want = zero_but(hessian_syrk_packed=n_clients * (TREE_ROUNDS + 1),
                    select_topk_idx=n_clients * TREE_ROUNDS)
    check(launches == want, f"exact tree: launches {launches}, want {want}")
    check(_reports_bitwise(tree, flat) and frames_bitwise(tree, flat),
          "exact tree != the flat star bit for bit")
    measured = [int(b) for b in tree.extras["measured_frame_bytes"]]
    root_bytes = [_agg_root_bytes(b, n_clients, n_root) for b in measured]
    emit({"phase": "topology", "part": "a", "spec": f"w8a star-loopback topk tree fanout=4 "
          f"depth=3 exact rounds={TREE_ROUNDS}", "root_subtrees": n_root, "aggregators": n_aggs,
          "device": tree.extras["device"], "launches": launches, "bitwise_vs_flat_star": True,
          "grad_norms": tree.grad_norms.tolist(), "sent_bits": tree.sent_bits.tolist(),
          "measured_frame_bytes": measured, "root_agg_frame_bytes": root_bytes,
          "init_time_s": tree.init_time_s, "ms_per_round": tree.wall_time_s / tree.rounds * 1e3,
          "flat_star_ms_per_round": flat.wall_time_s / flat.rounds * 1e3})
    out["tree_topk"] = launches

    # (a') the same tree with RandK: every hop decodes each leaf's message
    rk_spec = base.replace(compressor=CompressorSpec("randk"), rounds=TREE_RANDK_ROUNDS)
    reset()
    rk_flat = solve(rk_spec, z=z_np, device=dev)
    flat_rk = launch_counts(ops)
    reset()
    rk_tree = solve(rk_spec.replace(topology=exact), z=z_np, device=dev)
    tree_rk = launch_counts(ops)
    hops = 3  # the aggregators above a leaf (depth - 1) and the root
    per_leaf = 2 + hops  # encode, the leaf's own decode, each hop's decode
    for label, got, times in (("flat", flat_rk, 3), ("tree", tree_rk, per_leaf)):
        uses = times * n_clients * TREE_RANDK_ROUNDS
        want = zero_but(hessian_syrk_packed=n_clients * (TREE_RANDK_ROUNDS + 1),
                        threefry_uniform=uses, threefry_uniform_float32=uses,
                        select_topk_by_keys_idx=uses)
        check(got == want, f"randk {label}: launches {got}, want {want}")
    check(_reports_bitwise(rk_tree, rk_flat) and frames_bitwise(rk_tree, rk_flat),
          "exact tree RandK != the flat star bit for bit")
    emit({"phase": "topology", "part": "a_randk", "spec": f"w8a star-loopback randk tree "
          f"fanout=4 depth=3 exact rounds={TREE_RANDK_ROUNDS}", "bitwise_vs_flat_star": True,
          "launches": tree_rk, "flat_star_launches": flat_rk,
          "decodes_per_leaf_round": {"tree": 1 + hops, "flat": 2},
          "ms_per_round": rk_tree.wall_time_s / rk_tree.rounds * 1e3,
          "flat_star_ms_per_round": rk_flat.wall_time_s / rk_flat.rounds * 1e3})
    out["tree_randk"] = tree_rk

    # (b) combine="sum": 12 subtrees, one dense sum each; root bytes counted
    sum_topo = TopologySpec(kind="tree", fanout=12, depth=2, combine="sum")
    reset()
    with open_session(base.replace(topology=sum_topo), z=z_np, device=dev) as s:
        rec = obs.enable()
        s.step(TREE_ROUNDS)
        obs.disable()
        summed = s.report()
    sum_launches = launch_counts(ops)
    check(sum_launches == zero_but(hessian_syrk_packed=n_clients * (TREE_ROUNDS + 1),
                                   select_topk_idx=n_clients * TREE_ROUNDS),
          f"sum tree launches {sum_launches}")
    x_err = np.abs(summed.x - flat.x)
    check(bool(np.all(x_err <= SUM_TREE_ATOL + SUM_TREE_RTOL * np.abs(flat.x))),
          f"sum tree x vs the flat star: {x_err.max()}")
    check(list(summed.sent_bits) == list(flat.sent_bits), "sum tree sent_bits")
    sum_root = rec.value("comm.bytes.recv", type="AGG")
    emit({"phase": "topology", "part": "b", "spec": f"w8a star-loopback topk tree fanout=12 "
          f"depth=2 sum rounds={TREE_ROUNDS}", "x_max_abs_err_vs_flat": float(x_err.max()),
          "rtol": SUM_TREE_RTOL, "atol": SUM_TREE_ATOL, "sent_bits_exact": True,
          "bitwise_vs_flat_star": bool(np.array_equal(summed.x, flat.x)),
          "root_agg_frame_bytes_per_round": sum_root / TREE_ROUNDS,
          "exact_tree_root_agg_frame_bytes_per_round": statistics.mean(root_bytes),
          "leaf_frame_bytes_per_round": statistics.mean(measured),
          "ms_per_round": summed.wall_time_s / summed.rounds * 1e3})

    # (c) async: staleness 0 is the flat star; staleness 2 twice on the card, once on the CPU
    reset()
    sync0 = solve(base.replace(topology=TopologySpec(mode="async"), rounds=ASYNC_SYNC_ROUNDS),
                  z=z_np, device=dev)
    check([g.hex() for g in sync0.grad_norms] == [g.hex() for g in flat.grad_norms[:ASYNC_SYNC_ROUNDS]]
          and [r.f for r in sync0.records] == [r.f for r in flat.records[:ASYNC_SYNC_ROUNDS]]
          and list(sync0.sent_bits) == list(flat.sent_bits[:ASYNC_SYNC_ROUNDS])
          and list(sync0.extras["measured_frame_bytes"])
          == list(flat.extras["measured_frame_bytes"][:ASYNC_SYNC_ROUNDS]),
          "async staleness 0 != the flat star")
    async_path = where / "w8a_async.fnlsess"
    reset()
    with open_session(async_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(async_path)
        async1 = s.run()
        in_flight = len(s._handle._master._inflight)
    async_launches = launch_counts(ops)
    async2 = solve(async_spec, z=z_np, device=dev)
    parts = [r.participants for r in async1.records]
    assigned = sum(len(p) for p in parts)
    check(_reports_bitwise(async1, async2) and frames_bitwise(async1, async2),
          "two async runs on the card differ")
    # a client computes (SYRK, then its encode) once per ROUND assignment;
    # every assignment has arrived or is still in flight at the end
    assignments = assigned + in_flight
    want = zero_but(hessian_syrk_packed=n_clients + assignments, select_topk_idx=assignments)
    check(async_launches == want, f"async launches {async_launches}, want {want}")

    def finish_c() -> None:
        async_cpu, worker = cpu_jobs["async"].result()
        check(parts == [r.participants for r in async_cpu.records],
              "async participants != the CPU's")
        check(list(async1.sent_bits) == list(async_cpu.sent_bits), "async sent_bits != the CPU's")
        rel = _rel(async1.grad_norms, async_cpu.grad_norms, STAR_GN_FLOOR)
        check(_norms_close(async1.grad_norms, async_cpu.grad_norms),
              f"async grad norms vs the CPU: {rel}")
        emit({"phase": "topology", "part": "c", "spec": f"w8a star-loopback topk async "
              f"staleness=2 max_delay=3 schedule_seed=0 rounds={ASYNC_ROUNDS}",
              "staleness0_bitwise_vs_flat_star": True, "two_card_runs_bitwise": True,
              "participants_exact_vs_cpu": True, "participants_per_round": [len(p) for p in parts],
              "arrivals": assigned, "in_flight_at_end": in_flight, "launches": async_launches,
              "grad_norms": async1.grad_norms.tolist(), "rel_err_vs_cpu": rel.tolist(),
              "ms_per_round": async1.wall_time_s / async1.rounds * 1e3, "cpu_side": worker})

    finish.append(finish_c)
    out["async"] = async_launches

    # (d) elastic: clients 130-141 join at round 2, 0-11 leave at round 5
    el_path = where / "w8a_elastic.fnlsess"
    leave_checks = []
    reset()
    with open_session(el_spec, z=z_np, device=dev) as s:
        master = s._handle._master
        apply_events = master._apply_events

        def checked(r, x):
            ev = apply_events(r, x)
            if ev["left"]:
                fresh = torch.mean(torch.stack([master._mirrors[c].clone() for c in master.order]),
                                   dim=0)
                leave_checks.append((r, bits_equal(master.h_global, fresh)))
            return ev

        master._apply_events = checked
        s.step(SESSION_SAVE_AT)
        s.save(el_path)
        elastic = s.run()
    el_launches = launch_counts(ops)
    check(leave_checks == [(ELASTIC_LEAVE_AT, True)],
          f"H_global after the leaves != a fresh mean of the survivors' mirrors: {leave_checks}")
    el_parts = [r.participants for r in elastic.records]
    t_len = d * (d + 1) // 2
    active_before = n_clients - len(ELASTIC_JOINERS)
    per_up = elastic.records[1].sent_bits_payload // active_before
    delta = elastic.records[2].sent_bits_payload - elastic.records[1].sent_bits_payload
    want_delta = len(ELASTIC_JOINERS) * (per_up + t_len * 64)
    check(delta == want_delta, f"elastic round-2 delta {delta}, want {want_delta}")
    rounds_active = sum(len(p) for p in el_parts)
    want = zero_but(hessian_syrk_packed=active_before + len(ELASTIC_JOINERS) + rounds_active,
                    select_topk_idx=rounds_active)
    check(el_launches == want, f"elastic launches {el_launches}, want {want}")

    def finish_d() -> None:
        el_cpu, worker = cpu_jobs["elastic"].result()
        check(el_parts == [r.participants for r in el_cpu.records],
              "elastic participants != the CPU's")
        check(list(elastic.sent_bits) == list(el_cpu.sent_bits), "elastic sent_bits != the CPU's")
        rel = _rel(elastic.grad_norms, el_cpu.grad_norms, STAR_GN_FLOOR)
        check(_norms_close(elastic.grad_norms, el_cpu.grad_norms),
              f"elastic grad norms vs the CPU: {rel}")
        emit({"phase": "topology", "part": "d", "spec": f"w8a star-loopback topk membership: "
              f"{len(ELASTIC_JOINERS)} join at round {ELASTIC_JOIN_AT}, {len(ELASTIC_LEAVERS)} "
              f"leave at round {ELASTIC_LEAVE_AT}, rounds={ELASTIC_ROUNDS}",
              "participants_per_round": [len(p) for p in el_parts],
              "participants_exact_vs_cpu": True, "sent_bits_exact_vs_cpu": True,
              "round2_delta_bits": delta, "round2_delta_want": want_delta,
              "leave_h_global_bitwise_fresh_mean": True, "launches": el_launches,
              "grad_norms": elastic.grad_norms.tolist(), "rel_err_vs_cpu": rel.tolist(),
              "ms_per_round": elastic.wall_time_s / elastic.rounds * 1e3, "cpu_side": worker})

    finish.append(finish_d)
    out["elastic"] = el_launches

    # (f) the three sessions restored from their FNLS1 files by replay
    restored = {}
    for label, spec, path, want_rep in (("tree", tree_spec, tree_path, tree),
                                        ("async", async_spec, async_path, async1),
                                        ("elastic", el_spec, el_path, elastic)):
        with open_session(spec, z=z_np, restore=path, device=dev) as s:
            check(s.round == SESSION_SAVE_AT, f"{label} session restored at round {s.round}")
            rep = s.run()
        check(_reports_bitwise(rep, want_rep) and frames_bitwise(rep, want_rep)
              and [r.participants for r in rep.records] == [r.participants for r in want_rep.records],
              f"{label} session restored != the uninterrupted run")
        restored[label] = {"fnls1_bytes": path.stat().st_size, "restored_bitwise": True,
                           "init_and_replay_s": rep.init_time_s}
        path.unlink()
    emit({"phase": "topology", "part": "f", "saved_at": SESSION_SAVE_AT, "sessions": restored})

    # (e) a TCP process tree: 2 aggregator processes of 4 client processes each
    tcp_topo = TopologySpec(kind="tree", fanout=2, depth=2)
    tcp_spec = ExperimentSpec(data=DataSpec(dataset="w8a", shape=TCP_SHAPE), rounds=TCP_ROUNDS,
                              topology=tcp_topo)
    cfg = tcp_spec.fednl_config()
    live_before = ClientCluster.live_count()
    t0 = time.perf_counter()
    cluster = TreeClientCluster("w8a", TCP_SHAPE, tcp_spec.seed, tcp_topo, cfg=cfg,
                                device=str(dev), data_seed=tcp_spec.data.seed)
    spawn_s = time.perf_counter() - t0
    try:
        master = make_master(cluster.conns, cluster.d, cfg, topology=tcp_topo,
                             n_clients=cluster.n_clients, device=dev)
        master.init_handshake()
        t1 = time.perf_counter()
        tcp_m = [master.step_round(r) for r in range(TCP_ROUNDS)]
        tcp_s = time.perf_counter() - t1
        master.stop()
        tcp_x = master.x.cpu().numpy()
    finally:
        cluster.close(join_timeout=120)
    codes = cluster.exit_codes()
    check(codes == [0, 0], f"TCP tree aggregators' exit codes {codes}")
    check(ClientCluster.live_count() == live_before == 0, "a cluster is still live")
    loop = solve(tcp_spec.replace(backend="star-loopback"), device=dev)
    check([float(m["grad_norm"]).hex() for m in tcp_m] == [g.hex() for g in loop.grad_norms]
          and [m["sent_bits"] for m in tcp_m] == list(loop.sent_bits)
          and [m["measured_frame_bytes"] for m in tcp_m] == list(loop.extras["measured_frame_bytes"])
          and bool(np.array_equal(tcp_x, loop.x)), "TCP tree != the loopback tree bit for bit")
    emit({"phase": "topology", "part": "e", "spec": f"star-tcp w8a shape={TCP_SHAPE} topk tree "
          f"fanout=2 depth=2 rounds={TCP_ROUNDS}", "aggregator_processes": 2,
          "client_processes": TCP_SHAPE[1], "aggregator_exit_codes": codes,
          "live_clusters_after": ClientCluster.live_count(), "bitwise_vs_loopback_tree": True,
          "spawn_and_connect_s": spawn_s, "ms_per_round": tcp_s / TCP_ROUNDS * 1e3,
          "loopback_ms_per_round": loop.wall_time_s / loop.rounds * 1e3,
          "grad_norms": loop.grad_norms.tolist()})

    # (g) obs: a tree round and a flat-star round under a live recorder
    def obs_round(spec, want_rep):
        with open_session(spec, z=z_np, device=dev) as s:
            s.step(1)
            rec = obs.enable()
            s.step(1)
            obs.disable()
            third = trace(lambda: s.step(1), 1, "round")
            rep = s.report()
        check([g.hex() for g in rep.grad_norms] == [g.hex() for g in want_rep.grad_norms[:3]]
              and list(rep.extras["measured_frame_bytes"])
              == list(want_rep.extras["measured_frame_bytes"][:3]),
              "a round under the recorder differs from the run without it")
        return rec, rep, third

    rec_t, rep_t, tree_trace = obs_round(tree_spec, tree)
    hops = rec_t.spans("comm.hop")
    check(len(hops) == n_aggs and sorted(h.labels["node"] for h in hops if h.depth == 1)
          == list(range(n_root)), f"comm.hop spans: {len(hops)}, want {n_aggs}")
    measured1 = int(rep_t.extras["measured_frame_bytes"][1])
    check(rec_t.value("comm.bytes.recv", type="UPLINK") == measured1,
          "UPLINK bytes received != the measured frame bytes")
    # each leaf's entry crosses depth - 1 = 2 AGG hops (sub-aggregator -> root
    # subtree aggregator -> root)
    want_agg = 36 * n_aggs + 2 * (measured1 - 8 * n_clients)
    check(rec_t.value("comm.bytes.recv", type="AGG") == want_agg,
          f"AGG bytes {rec_t.value('comm.bytes.recv', type='AGG')}, want {want_agg}")
    round_span = rec_t.spans("comm.round")
    check(len(round_span) == 1, "one comm.round span")
    by_level = {}
    for h in hops:
        by_level.setdefault(h.depth, []).append(h.dur_s * 1e3)
    rec_s, _, _ = obs_round(base, flat)
    check(rec_s.value("comm.bytes.recv", type="UPLINK")
          == int(flat.extras["measured_frame_bytes"][1]), "flat star UPLINK bytes")
    emit({"phase": "topology", "part": "g", "obs_on_bitwise_vs_off": True,
          "tree": {"hop_spans": len(hops), "round_ms": round_span[0].dur_s * 1e3,
                   "hop_ms_by_level": {f"level_{lvl}": {"count": len(v), "mean": statistics.mean(v),
                                                       "max": max(v), "sum": sum(v)}
                                       for lvl, v in sorted(by_level.items())},
                   "uplink_bytes_recv": measured1,
                   "agg_bytes_recv": rec_t.value("comm.bytes.recv", type="AGG"),
                   "agg_bytes_recv_want": want_agg,
                   "root_agg_frame_bytes": _agg_root_bytes(measured1, n_clients, n_root),
                   "frames_recv": {k: v for k, v in rec_t.snapshot()["counters"].items()
                                   if k.startswith("comm.frames.recv")},
                   "trace_third_round": tree_trace},
          "flat_star": {"round_ms": rec_s.spans("comm.round")[0].dur_s * 1e3,
                        "uplink_bytes_recv": rec_s.value("comm.bytes.recv", type="UPLINK")},
          "note": "hop spans: fan-down, the children's collection and the reply of each "
                  "aggregator, nested (level 2 inside level 1 inside the root's comm.round); "
                  "the tree session's third round under torch.profiler"})
    emit({"phase": "topology", "seconds": time.perf_counter() - t_phase})
    return out, finish


def _records_bitwise(got, want) -> bool:
    """Two RunReports agree record for record bit for bit (floats by their
    hex, PP models and participants too) and in their final x."""
    def key(r):
        return ([None if v is None else float(v).hex() for v in (r.grad_norm, r.f, r.l)],
                r.sent_elems, r.sent_bits, r.sent_bits_payload, r.sent_bits_wire, r.ls_steps,
                r.participants, None if r.x is None else np.asarray(r.x).tobytes())
    return (got.rounds == want.rounds and [key(r) for r in got.records] == [key(r) for r in want.records]
            and bool(np.array_equal(got.x, want.x)))


def _tenant_against_solve(name: str, got, want, n_clients: int) -> dict:
    """A served tenant against its own solve() on the card: the same rounds,
    sent_bits exact every round (TopLEK: phase 3's boundary allowance, a
    round's kept count may differ by one a client), grad norms within
    TRAJECTORY_RTOL where the solve's is >= SWEEP_GN_FLOOR."""
    check(got.rounds == want.rounds, f"{name}: {got.rounds} rounds, its solve {want.rounds}")
    check(bool(np.all(np.isfinite(got.x))) and got.x.shape == want.x.shape, f"{name}: x")
    differ = [r for r in range(want.rounds) if got.sent_bits[r] != want.sent_bits[r]]
    if name.endswith("toplek"):
        for r in differ:
            d_elems = abs(got.records[r].sent_elems - want.records[r].sent_elems)
            check(0 < d_elems <= n_clients, f"{name}: round {r} sent_elems differ by {d_elems}")
    else:
        check(not differ, f"{name}: sent_bits differ at rounds {differ}")
    rel = _rel(got.grad_norms, want.grad_norms, SWEEP_GN_FLOOR)
    check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{name}: grad norms differ: {rel.max()}")
    return {"bitwise": _records_bitwise(got, want),
            "max_rel_grad_norm": float(rel.max()) if rel.size else 0.0,
            "boundary_rounds": differ}


def serve_phase(ops, dev, sweep: dict | None) -> dict:
    """Phase 12: the FedNL serving engine and its gateway at w8a's whole
    shape, on the card: (a) the README grid and a TopLEK tenant through one
    engine under memory pressure, exact launch counts, each tenant against
    its solve(); (b) one TopK spec in groups of 1, 2, 4 and 8; (c) evict at
    round 3 and resume in a fresh engine; (d) a star-loopback and a FedNL-PP
    tenant beside a batch group, each its own session bit for bit; (e) the
    gateway over TCP on 127.0.0.1; (f) where an 8-slot tick's time goes."""
    import threading

    import torch

    from repro_torch import obs
    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)
    from repro_torch.comm.protocol import Frame, MsgType
    from repro_torch.core.fednl_batch import BatchRoundTable
    from repro_torch.gateway import GatewayClient, GatewayConfig, GatewayError, GatewayServer
    from repro_torch.gateway import protocol as gwp
    from repro_torch.serve_fednl import FedNLServer, ServeConfig
    from repro_torch.serve_fednl.scheduler import stack_states, unstack_state

    base = ExperimentSpec(data=DataSpec(dataset="w8a", seed=0), rounds=SERVE_ROUNDS)
    specs = list(base.grid(seed=range(4), compressor=["topk", "randseqk", "natural"]).specs())
    specs.append(base.replace(compressor=CompressorSpec("toplek"), tol=1e-12))
    z_np = base.data.build()
    n_clients = z_np.shape[0]
    solves: dict = {}

    def solve_of(spec):
        if spec not in solves:
            solves[spec] = solve(spec, z=z_np)
        return solves[spec]

    def label(spec) -> str:
        return f"seed={spec.seed} {spec.compressor.name}"

    out: dict = {"phase": "serve"}

    # (a) the batched lane under memory pressure; each batched round's chunk
    # recorded (its branches, its padded slots) to reckon the launches
    chunks: list[tuple[set, int]] = []
    table_tick = BatchRoundTable.tick

    def recording_tick(self, comp_idx, state_b):
        chunks.append(({self.branch_keys[i][0] for i in comp_idx}, len(comp_idx)))
        return table_tick(self, comp_idx, state_b)

    BatchRoundTable.tick = recording_tick
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with FedNLServer(ServeConfig(**SERVE_CONFIG)) as srv:
            handles = [srv.submit(spec) for spec in specs[:SERVE_EARLY]]
            for _ in range(SERVE_EARLY_TICKS):
                srv.tick()
            handles += [srv.submit(spec) for spec in specs[SERVE_EARLY:]]
            srv.serve_until_idle(max_ticks=2000)
            stats = srv.stats()
            reports = [h.result() for h in handles]
    finally:
        BatchRoundTable.tick = table_tick
    serve_s = time.perf_counter() - t0
    launches = launch_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    check(len(chunks) == stats["batch_launches"], f"chunks {len(chunks)} vs {stats}")
    admissions = sum(stats["admissions_by_class"].values())
    want = {name: 0 for name in launches}
    want["hessian_syrk_packed"] = admissions + stats["batch_launches"]
    for comp, kernel in (("topk", "select_topk"), ("randseqk", "select_randseqk"),
                         ("toplek", "select_toplek"), ("natural", "threefry_uniform_float64")):
        want[kernel] = sum(comp in branches for branches, _ in chunks)
    want["threefry_uniform"] = want["threefry_uniform_float64"]
    check(launches == want, f"serve launches {launches}, want {want}")
    check(stats["spills"] > 0 and stats["resumes"] == stats["spills"]
          and stats["finished"] == len(specs), f"serve stats {stats}")
    against = {label(spec): _tenant_against_solve(f"serve {label(spec)}", got, solve_of(spec),
                                                  n_clients)
               for spec, got in zip(specs, reports)}
    live = sum(r.rounds for r in reports)
    padded = sum(n for _, n in chunks)
    check(abs(stats["batch_occupancy"] - live / padded) < 1e-12, "occupancy")
    emit({"phase": "serve", "part": "stats", "stats": stats})
    out["batched"] = {
        "tenants": [label(spec) for spec in specs], "config": SERVE_CONFIG,
        "submitted_first": SERVE_EARLY, "ticks_before_the_rest": SERVE_EARLY_TICKS,
        "launches": launches, "admissions": admissions, "slot_rounds_live": live,
        "slot_rounds_padded": padded, "serve_s": serve_s, "peak_memory_bytes": peak,
        "bitwise_vs_solve": {k: v["bitwise"] for k, v in against.items()},
        "max_rel_grad_norm_vs_solve": max(v["max_rel_grad_norm"] for v in against.values()),
        "toplek_boundary_rounds": against[label(specs[-1])]["boundary_rounds"],
        "rounds": [r.rounds for r in reports],
        "final_grad_norms": [r.grad_norms[-1] for r in reports],
    }
    emit({"phase": "serve", "part": "a_batched", **out["batched"]})
    del reports, handles

    # (b) one TopK spec served alone (bucket 1) and in groups of 2, 4 and 8
    target = base.replace(rounds=GROUP_ROUNDS)
    partners = [base.replace(rounds=GROUP_ROUNDS, seed=s, compressor=CompressorSpec(c))
                for s, c in ((1, "randseqk"), (2, "natural"), (3, "topk"), (4, "randseqk"),
                             (5, "natural"), (6, "topk"), (7, "randseqk"))]
    by_size = {}
    for size in GROUP_SIZES:
        with FedNLServer(ServeConfig(max_resident=8, admit_per_tick=8, max_group=8)) as srv:
            hs = [srv.submit(spec) for spec in [target] + partners[:size - 1]]
            srv.serve_until_idle()
            check(srv.stats()["batch_occupancy"] == 1.0, f"group of {size}: padded")
            by_size[size] = hs[0].result()
    want_b = solve_of(target)
    sizes = {}
    for size, got in by_size.items():
        row = _tenant_against_solve(f"group of {size} topk", got, want_b, n_clients)
        row["bitwise_vs_alone"] = _records_bitwise(got, by_size[1])
        row["bitwise_vs_group_of_2"] = _records_bitwise(got, by_size[2])
        rel_alone = _rel(got.grad_norms, by_size[1].grad_norms, 0.0)
        row["max_rel_grad_norm_vs_alone"] = float(rel_alone.max())
        sizes[size] = row
    out["group_size"] = {"spec": "w8a topk seed=0 rounds=10", "by_slots": sizes}
    emit({"phase": "serve", "part": "b_group_size", **out["group_size"]})

    # (c) evicted at round 3 to FNLS1, resumed alone in a fresh engine
    spec_c = base.replace(rounds=EVICT_ROUNDS, seed=5, compressor=CompressorSpec("randseqk"))
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    with FedNLServer() as srv:
        h = srv.submit(spec_c)
        srv.serve_until_idle()
        alone = h.result()
    with FedNLServer(ServeConfig(spill_dir=where / "serve_spills")) as srv:
        h = srv.submit(spec_c)
        for _ in range(EVICT_AT):
            srv.tick()
        path = srv.evict(h.id)
    again = where / "serve_evicted_again.fnlsess"
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "serve: FNLS1 load -> save changed the bytes")
    with FedNLServer() as srv:
        h = srv.resume(path)
        check(h.round == EVICT_AT, f"resumed at round {h.round}")
        srv.serve_until_idle()
        resumed = h.result()
    check(_records_bitwise(resumed, alone), "serve: evicted and resumed != served alone")
    out["spill_resume"] = {"spec": label(spec_c), "evicted_at": EVICT_AT,
                           "fnls1_bytes": path.stat().st_size, "round_trip_byte_identical": True,
                           "resumed_bitwise_vs_alone": True}
    for f in (path, again):
        f.unlink()
    (where / "serve_spills").rmdir()
    emit({"phase": "serve", "part": "c_spill_resume", **out["spill_resume"]})

    # (d) the solo lane beside a batch group, launch counts set to 0 before
    star = base.replace(rounds=SOLO_STAR_ROUNDS, backend="star-loopback")
    pp = base.replace(algorithm="fednl-pp", tau=PP_TAU, rounds=SOLO_PP_ROUNDS)
    pair = [base.replace(rounds=SOLO_STAR_ROUNDS, seed=s) for s in (0, 1)]
    ops.reset_launch_counts()
    with FedNLServer() as srv:
        hs = [srv.submit(spec) for spec in [star, pp] + pair]
        check([h._tenant.lane for h in hs] == ["solo", "solo", "batch", "batch"], "lanes")
        srv.serve_until_idle()
        st_d = srv.stats()
        served = [h.result() for h in hs]
    solo_launches = launch_counts(ops)
    want = {name: 0 for name in solo_launches}
    want["hessian_syrk_packed"] = (n_clients * (SOLO_STAR_ROUNDS + 1)  # star: init + a round
                                   + SOLO_PP_ROUNDS + 2  # PP: init, warm-up, rounds
                                   + len(pair) + st_d["batch_launches"])
    want["select_topk_idx"] = n_clients * SOLO_STAR_ROUNDS
    want["select_topk"] = SOLO_PP_ROUNDS + 1 + st_d["batch_launches"]
    check(solo_launches == want, f"solo lane launches {solo_launches}, want {want}")
    for spec, got in zip((star, pp), served[:2]):
        with open_session(spec, z=z_np) as sess:
            mine = sess.run()
        check(_records_bitwise(got, mine), f"serve solo {spec.backend} {spec.algorithm}: "
                                           "not its session bit for bit")
    for spec, got in zip(pair, served[2:]):
        _tenant_against_solve(f"solo-lane neighbour {label(spec)}", got, solve_of(spec), n_clients)
    out["solo_lane"] = {"tenants": ["star-loopback topk 3 rounds",
                                    f"fednl-pp topk tau={PP_TAU} 5 rounds",
                                    "2 batched topk 3 rounds"],
                        "launches": solo_launches, "bitwise_vs_session": True}
    emit({"phase": "serve", "part": "d_solo_lane", **out["solo_lane"]})

    # (e) the gateway: a port server on 127.0.0.1 with the engine on the card
    gw_specs = [base.replace(rounds=GATEWAY_ROUNDS, seed=s, compressor=CompressorSpec(c))
                for s, c in ((0, "topk"), (1, "randseqk"), (2, "natural"), (3, "topk"))]
    rec = obs.enable(span_capacity=4096)
    server = GatewayServer(GatewayConfig(port=0, serve=ServeConfig(**SERVE_CONFIG)))
    ready, addr = threading.Event(), {}

    def announce(host, port):
        addr.update(host=host, port=port)
        ready.set()

    thread = threading.Thread(target=server.run, kwargs={"ready": announce}, daemon=True)
    thread.start()
    try:
        check(ready.wait(60), "gateway did not bind")
        with GatewayClient(addr["host"], addr["port"]) as gwc:
            hs = [gwc.submit(spec) for spec in gw_specs]
            streamed, drops = {}, 0
            for h in hs:
                with GatewayClient(addr["host"], addr["port"]) as observer:
                    streamed[h.id] = list(observer.stream(h.id))
                    drops += observer.stream_drops
            results = [gwc.result(h.id) for h in hs]
            refused = {}
            try:
                gwc.submit(gw_specs[0], priority="platinum")
            except GatewayError as exc:
                refused["priority"] = exc.field
            raw = json.loads(gwp.pack_submit(gw_specs[0])[4:].decode())
            raw["spec"]["data"]["warp"] = 1
            try:
                gwc._rpc(Frame(type=MsgType.SUBMIT, payload=gwp._pack(
                    {k: raw[k] for k in ("spec_wire_version", "spec", "until", "tenant_id",
                                         "options")})))
            except GatewayError as exc:
                refused["unknown_field"] = exc.field
            metrics = gwc.metrics()
        latencies = server.tick_latencies()
    finally:
        server.request_stop()
        thread.join(60)
        obs.disable()
    check(not thread.is_alive(), "the gateway's thread did not stop")
    check(refused == {"priority": "options.priority", "unknown_field": "data.warp"},
          f"bad submissions refused as {refused}")
    check(drops == 0, f"{drops} records dropped")
    for spec, h, got in zip(gw_specs, hs, results):
        check(_records_bitwise(dataclasses.replace(got, records=streamed[h.id]), got),
              f"gateway {label(spec)}: streamed records != the report's")
        _tenant_against_solve(f"gateway {label(spec)}", got, solve_of(spec), n_clients)
    series = sorted({k.split("{")[0] for kind in ("counters", "histograms", "gauges")
                     for k in metrics["metrics"].get(kind, {}) if k.startswith("engine.")})
    check(metrics["enabled"] and "engine.rounds" in series and "engine.tick" in series,
          f"METRICS series {series}")
    lat_ms = np.asarray(latencies) * 1e3
    out["gateway"] = {
        "tenants": [label(spec) for spec in gw_specs], "rounds": GATEWAY_ROUNDS,
        "streamed_equal_reports": True, "refused_fields": refused, "engine_series": series,
        "ticks": len(latencies), "tick_ms_p50": float(np.percentile(lat_ms, 50)),
        "tick_ms_p99": float(np.percentile(lat_ms, 99)), "spans_recorded": len(rec.spans()),
    }
    emit({"phase": "serve", "part": "e_gateway", **out["gateway"]})

    # (f) where an 8-slot tick's time goes: the first 8 tenants of (a), no
    # pressure, host clock around synchronised ticks, then one profiled tick
    with FedNLServer(ServeConfig(max_resident=8, admit_per_tick=8, max_group=8)) as srv:
        for spec in specs[:8]:
            srv.submit(spec)
        srv.tick()  # admission and the first round
        srv.tick()
        tick_s = []
        for _ in range(TICK_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            srv.tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t1)
        prof = trace(srv.tick, 1, "tick")
        states = [t.state for t in srv._tenants.values() if t.status == "running"]
        check(len(states) == 8, f"{len(states)} resident")
        stack_ms = median_ms({"stack": lambda: stack_states(states)}, reps=5, calls=1)["stack"]
        stacked = stack_states(states)
        t1 = time.perf_counter()
        for _ in range(TICK_REPS):
            [unstack_state(stacked, i) for i in range(8)]
        unstack_ms = (time.perf_counter() - t1) / TICK_REPS * 1e3
        del stacked, states
    ms_tick = statistics.median(tick_s) * 1e3
    per_slot_ms = prof.get("device_ms_per_tick", float("nan")) / 8
    out["tick"] = {
        "slots": 8, "ms_per_tick_median": ms_tick, "ms_per_tick": [t * 1e3 for t in tick_s],
        "tenant_rounds_per_s": 8 / (ms_tick / 1e3),
        **({"sweep_group_ms_per_round_12_specs": sweep["group_ms_per_round"],
            "sweep_spec_rounds_per_s": 12 / (sweep["group_ms_per_round"] / 1e3),
            "sum_of_12_solves_ms_per_round": sweep["sequential_ms_per_round_sum"]}
           if sweep is not None else {"sweep": "not run"}),
        "stack_8_states_device_ms": stack_ms, "unstack_8_states_host_ms": unstack_ms,
        "stack_bytes": 2 * 8 * n_clients * z_np.shape[-1] * (z_np.shape[-1] + 1) // 2 * 8,
        "occupancy_a": stats["batch_occupancy"], "pad_slot_rounds_a": padded - live,
        "pad_device_ms_a_reckoned": (padded - live) * per_slot_ms,
        "profiled_tick": prof,
    }
    emit({"phase": "serve", "part": "f_tick", **out["tick"]})
    out["launches"] = launches
    return out


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def sharded_phase(ops, dev, local_ms_per_round: float | None) -> dict:
    """Phase 13: the sharded backend at w8a's whole shape on a world of one
    (NCCL on the card, rank 0 in this process).  (a) dense_psum, TopK, 10
    rounds, against the card's local solve; (b) sparse_allgather through
    the index form against the CPU run of the port, and the support of
    H^2 - H^1 against the CPU's; each with exact launch counts and a round
    under set_sync_debug_mode("error"); (c) RandSeqK and RandK under
    sparse_allgather, 3 rounds, against the CPU run: every client's index
    set every round, bits, grad norms; (d) a sparse_allgather session
    stepped 3, saved, restored and run to 10, bit for bit (b)'s run, its
    FNLS1 file resumed on the CPU; then the index form timed at (142, T).
    Returns each part's launches and the batched index form's figures."""
    import torch
    import torch.distributed

    from repro_torch.api import (
        CompressorSpec, DataSpec, ExperimentSpec, load_state, open_session, save_state, solve)
    from repro_torch.api.accounting import sharded_uplink_bits
    from repro_torch.distributed import (
        make_sharded_fednl_round, shard_problem, sharded_fednl_init, world_of_one)
    from repro_torch.kernels import compressor_select as tcs
    from repro_torch.linalg import triu_size
    from repro_torch.objectives.logreg import logreg_oracles_packed

    t_phase = time.perf_counter()
    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=SHARDED_ROUNDS,
                          backend="sharded", devices=1)
    z_np = spec.data.build()
    n_clients, n_i, d = z_np.shape
    cfg = spec.fednl_config()
    t_len, k = triu_size(d), cfg.k_for(d)
    cpu = torch.device("cpu")
    out: dict = {"launches": {}}

    def counted(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, launch_counts(ops)

    def expected(launches, per_round: tuple, rounds: int, syrk: int) -> dict:
        want = {name: 0 for name in launches}
        want.update({name: rounds for name in per_round})
        want["hessian_syrk_packed"] = syrk
        return want

    def bits_of(rep) -> dict:
        return {col: [getattr(r, col) for r in rep.records]
                for col in ("sent_elems", "sent_bits", "sent_bits_payload", "sent_bits_wire")}

    # (a), (b): solve() on the card, the counts set to 0 before each
    local = solve(spec.replace(backend="local"), z=z_np, device=dev)
    reps = {}
    for agg, kernel in (("dense_psum", "select_topk"), ("sparse_allgather", "select_topk_idx")):
        path_spec = spec.replace(aggregate=agg)
        rep, launches = counted(lambda: solve(path_spec, z=z_np, device=dev))
        # every round and the warm-up round; SYRK also at init
        want = expected(launches, (kernel,), SHARDED_ROUNDS + 1, SHARDED_ROUNDS + 2)
        check(launches == want, f"sharded {agg}: launches {launches}, want {want}")
        check(rep.rounds == SHARDED_ROUNDS and bool(np.all(np.isfinite(rep.grad_norms))),
              f"sharded {agg}: grad norms {rep.grad_norms}")
        check(rep.extras == {"devices": 1, "aggregate": agg, "device": local.extras["device"]},
              f"sharded {agg}: extras {rep.extras}")
        against = {"local_card": local}
        if agg == "sparse_allgather":
            against["sharded_cpu"] = solve(path_spec, z=z_np, device="cpu")
        rel = {}
        for name, ref in against.items():
            rel[name] = _rel(rep.grad_norms, ref.grad_norms, STAR_GN_FLOOR).tolist()
            check(_norms_close(rep.grad_norms, ref.grad_norms),
                  f"sharded {agg} vs {name}: grad norms differ {rel[name]}")
            check(bits_of(rep) == bits_of(ref), f"sharded {agg} vs {name}: bits differ")
        reps[agg] = rep
        out["launches"][agg] = launches
        emit({"phase": "sharded", "part": "a" if agg == "dense_psum" else "b",
              "spec": f"w8a sharded {agg} topk rounds={SHARDED_ROUNDS} devices=1",
              "device": rep.extras["device"], "launches": launches,
              "grad_norms": rep.grad_norms.tolist(), "rel_err_above_floor": rel,
              "floor": STAR_GN_FLOOR, "rtol": TRAJECTORY_RTOL, "atol": STAR_GN_ATOL,
              "bits_exact_vs": sorted(against), "sent_bits": rep.sent_bits.tolist(),
              "bitwise_vs_local": bool(np.array_equal(rep.grad_norms, local.grad_norms)),
              "init_time_s": rep.init_time_s, "ms_per_round": rep.wall_time_s / rep.rounds * 1e3,
              "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
              "phase4_local_ms_per_round": local_ms_per_round})

    # function-level rounds on a device: the states (for the messages'
    # supports) and the metrics
    world_of_one(dev)

    def rounds_on(device, agg: str, comp_cfg, rounds: int):
        z = shard_problem(z_np, device=device)
        st = sharded_fednl_init(z, comp_cfg, seed=spec.seed)
        round_fn = make_sharded_fednl_round(z, comp_cfg, aggregate=agg)
        states, metrics = [st], []
        for _ in range(rounds):
            st, m = round_fn(st)
            states.append(st)
            metrics.append(m)
        return round_fn, states, metrics

    # round 1 (the second: round 0's corrections are 0 under hess0="exact")
    # under set_sync_debug_mode("error"); sparse_allgather's H^2 - H^1 support
    syncs = {}
    for agg in ("dense_psum", "sparse_allgather"):
        round_fn, states, _ = rounds_on(dev, agg, cfg, 1)  # round 0 also builds NCCL's communicator
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st2, _ = round_fn(states[-1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs[agg] = 0
        if agg == "sparse_allgather":
            card_support = (st2.h_global != states[1].h_global).cpu()
            x1, h1 = states[1].x, states[1].h_local
        emit({"phase": "trace", "path": f"sharded {agg} topk (world of one)",
              **trace_rounds(round_fn, st2, 3)})
        del round_fn, states, st2
    _, cpu_states, _ = rounds_on(cpu, "sparse_allgather", cfg, 2)
    cpu_support = cpu_states[2].h_global != cpu_states[1].h_global
    del cpu_states
    check(bool(card_support.any()) and torch.equal(card_support, cpu_support),
          "sparse_allgather: the support of H^2 - H^1 differs from the CPU's")
    emit({"phase": "sharded", "part": "syncs_and_support", "host_syncs_per_round": syncs,
          "sync_debug_mode": "error", "support_h2_minus_h1": int(card_support.sum()),
          "support_equal_to_cpu": True})

    # (c) RandSeqK and RandK under sparse_allgather, card against CPU
    for comp, per_round in (("randseqk", ("select_randseqk",)),
                            ("randk", ("threefry_uniform", "threefry_uniform_float32",
                                       "select_topk_by_keys_idx"))):
        comp_cfg = spec.replace(compressor=CompressorSpec(comp)).fednl_config()
        (_, card_st, card_m), launches = counted(
            lambda: rounds_on(dev, "sparse_allgather", comp_cfg, SHARDED_RANDOM_ROUNDS))
        want = expected(launches, per_round, SHARDED_RANDOM_ROUNDS, SHARDED_RANDOM_ROUNDS + 1)
        check(launches == want, f"sharded {comp}: launches {launches}, want {want}")
        _, cpu_st, cpu_m = rounds_on(cpu, "sparse_allgather", comp_cfg, SHARDED_RANDOM_ROUNDS)
        sets = 0
        for r in range(1, SHARDED_RANDOM_ROUNDS):  # round 0 sends zeros
            card_sets = (card_st[r + 1].h_local != card_st[r].h_local).cpu()
            check(torch.equal(card_sets, cpu_st[r + 1].h_local != cpu_st[r].h_local),
                  f"sharded {comp} round {r}: the clients' index sets differ from the CPU's")
            sets += int(card_sets.sum())
        for col in ("sent_elems", "sent_bits", "sent_bits_payload", "sent_bits_wire"):
            check([int(getattr(m, col)) for m in card_m] == [int(getattr(m, col)) for m in cpu_m],
                  f"sharded {comp}: {col} differ from the CPU's")
        gn = np.array([float(m.grad_norm) for m in card_m])
        gn_cpu = np.array([float(m.grad_norm) for m in cpu_m])
        check(_norms_close(gn, gn_cpu), f"sharded {comp}: grad norms {gn} vs CPU {gn_cpu}")
        out["launches"][f"sparse_allgather_{comp}"] = launches
        emit({"phase": "sharded", "part": "c", "compressor": comp, "rounds": SHARDED_RANDOM_ROUNDS,
              "launches": launches, "index_sets_exact": True, "entries_sent": sets,
              "grad_norms": gn.tolist(), "cpu_grad_norms": gn_cpu.tolist(),
              "sent_bits": [int(m.sent_bits) for m in card_m]})
        del card_st, cpu_st

    # (d) a session: step 3, save, restore, run to 10; the file on the CPU
    sparse_spec = spec.replace(aggregate="sparse_allgather")
    where = ROOT / "build" / "chip_smoke"
    where.mkdir(parents=True, exist_ok=True)
    path, again = where / "w8a_sharded.fnlsess", where / "w8a_sharded_again.fnlsess"
    with open_session(sparse_spec, z=z_np, device=dev) as s:
        s.step(SESSION_SAVE_AT)
        s.save(path)
        stepped = s.run()
    with open_session(sparse_spec, z=z_np, restore=path, device=dev) as s:
        check(s.round == SESSION_SAVE_AT, f"sharded session restored at round {s.round}")
        resumed = s.run()
    for label, got in (("stepped", stepped), ("restored", resumed)):
        check(_records_bitwise(got, reps["sparse_allgather"]),
              f"sharded session {label} != the uninterrupted run")
    save_state(load_state(path), again)
    check(path.read_bytes() == again.read_bytes(), "sharded FNLS1 load -> save changed the bytes")
    with open_session(sparse_spec, z=z_np, restore=path, device="cpu") as s:
        (cpu_rec,) = s.step(1)
    card_rec = reps["sparse_allgather"].records[SESSION_SAVE_AT]
    check(cpu_rec.sent_bits == card_rec.sent_bits
          and _norms_close([cpu_rec.grad_norm], [card_rec.grad_norm]),
          f"sharded FNLS1 on the CPU: round {SESSION_SAVE_AT} {cpu_rec} vs {card_rec}")
    emit({"phase": "sharded", "part": "d", "saved_at": SESSION_SAVE_AT,
          "stepped_bitwise": True, "restored_bitwise": True, "fnls1_bytes": path.stat().st_size,
          "fnls1_round_trip_byte_identical": True,
          "cpu_resumed_round": {"grad_norm": cpu_rec.grad_norm, "card": card_rec.grad_norm}})
    path.unlink()
    again.unlink()

    # the index form at the sparse path's shape: all the clients' round-1 corrections
    u = (logreg_oracles_packed(shard_problem(z_np, device=dev), x1, cfg.lam)[2] - h1).contiguous()
    got, want = tcs.select_topk_idx_cuda(u, k), tcs.select_topk_idx_plain(u, k)
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          f"select_topk_idx: sent or idx differ from the plain version at ({n_clients}, {t_len})")
    check(bits_equal(got[0], want[0]), "select_topk_idx: u_hat differs at the sharded shape")
    keys = u.abs().float()
    ms = median_ms({
        "kernel": lambda: tcs.select_topk_idx_cuda(u, k),
        "plain": lambda: tcs.select_topk_idx_plain(u, k),
        "dense_form": lambda: tcs.select_topk_cuda(u, k),
        "library": lambda: torch.topk(keys, k, dim=-1),
    })
    bnd = bound(u.numel() * 16 + n_clients * (k * 4 + 4), SELECT_OPS_PER_KEY * u.numel(),
                CUDA_CORE_32BIT_OPS)
    out["idx_batched"] = {"shape": [n_clients, t_len], "k": k,
                          "max_abs_err": (got[0] - want[0]).abs().max().item(), **ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1]}
    del u, keys, got, want, x1, h1
    emit({"phase": "sharded", "part": "index_form_batched", **out["idx_batched"],
          "note": f"ms per call: median over {TIMED_REPS} event pairs around {CALLS_PER_EVENT} "
                  "calls; dense_form = select_topk on the same rows; library = torch.topk on "
                  "the same f32 keys"})

    collective_bytes = {  # per rank per round
        "dense_psum": {"all_reduce_f64": (t_len + d + 2) * 8, "all_reduce_i64": 3 * 8},
        "sparse_allgather": {"all_gather_idx_i32": n_clients * k * 4,
                             "all_gather_vals_f64": n_clients * k * 8,
                             "all_reduce_f64": (d + 2) * 8, "all_reduce_i64": 3 * 8},
    }
    emit({"phase": "sharded", "part": "summary",
          "ms_per_round": {agg: r.wall_time_s / r.rounds * 1e3 for agg, r in reps.items()},
          "local_ms_per_round": local.wall_time_s / local.rounds * 1e3,
          "phase4_local_ms_per_round": local_ms_per_round,
          "sharded_uplink_bits": {agg: sharded_uplink_bits(agg, t_len, k, n_clients)
                                  for agg in collective_bytes},
          "collective_bytes_per_rank": collective_bytes,
          "seconds": time.perf_counter() - t_phase,
          "note": "a world of one: each collective is a copy on the card, so the phase "
                  "measures the port's path, not a network"})
    torch.distributed.destroy_process_group()  # the world of one ends with the phase
    return out


# the roofline phase's meta counts, longest first: (arch, shape, accum_steps, n_layers)
ROOFLINE_RUNS = (
    ("yi-34b", "train_4k", TRAIN_ACCUM, YI_TRAIN_LAYERS),  # the train phase's cuts
    ("chatglm3-6b", "train_4k", TRAIN_ACCUM, CHATGLM_TRAIN_LAYERS),
    ("nemotron-4-15b", "train_4k", TRAIN_ACCUM, NEMOTRON_TRAIN_LAYERS),
    ("mamba2-2.7b", "train_4k", TRAIN_ACCUM, None),
    ("seamless-m4t-large-v2", "train_4k", TRAIN_ACCUM, None),
    ("seamless-m4t-large-v2", "prefill_32k", None, None),
    ("granite-moe-1b-a400m", "train_4k", TRAIN_ACCUM, None),
    ("granite-3-2b", "train_4k", TRAIN_ACCUM, None),
    ("mamba2-2.7b", "prefill_32k", None, None),
    ("llava-next-mistral-7b", "train_4k", TRAIN_ACCUM, LLAVA_TRAIN_LAYERS),
    ("llava-next-mistral-7b", "prefill_32k", None, None),
    ("granite-3-2b", "prefill_32k", None, None),
    ("chatglm3-6b", "prefill_32k", None, None),
    ("nemotron-4-15b", "prefill_32k", None, None),
    ("yi-34b", "prefill_32k", None, ZOO_DEPTHS["yi-34b"][0]),  # the zoo's cut
    ("mixtral-8x22b", "train_4k", TRAIN_ACCUM, MIXTRAL_TRAIN_LAYERS),
    ("mixtral-8x22b", "prefill_32k", None, ZOO_DEPTHS["mixtral-8x22b"][0]),
    ("recurrentgemma-2b", "train_4k", TRAIN_ACCUM, None),
    ("granite-moe-1b-a400m", "prefill_32k", None, None),
    ("recurrentgemma-2b", "prefill_32k", None, None),
)


def count_on_meta(arch: str, shape_name: str, accum: int | None,
                  n_layers: int | None) -> dict:
    """One full-width step counted on meta (run in a spawned process): the
    step ``build_dryrun`` gives for ``arch`` at ``shape_name`` with its
    batch cut as this script runs it (train_4k: accum_steps ``accum``, and
    ``n_layers`` where the train or the zoo phase cut the depth, as it
    measured it), its ``step_cost`` and 6 N D or 2 N D."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import build_dryrun

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if accum is not None:
        cfg = dataclasses.replace(cfg, accum_steps=accum)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = shape_of(shape_name)
    spec = build_dryrun(cfg, shape_name, ONE_CARD, batch_override=shape.batch)
    cost = rl.step_cost(spec.step_fn, *spec.args)
    params = spec.args[0]
    return {"arch": arch, "shape": shape_name, "batch_seq": [shape.batch, shape.seq],
            "n_layers": cfg.n_layers, "note": spec.note, "cost": dataclasses.asdict(cost),
            "params": rl.count_params(params), "active_params": rl.active_params(cfg, params),
            "model_flops": rl.model_flops_global(cfg, params, tokens=shape.batch * shape.seq,
                                                 kind=shape.kind),
            "count_s": time.perf_counter() - t0}


def roofline_line(run: str, cost: dict, model_flops: float, measured_s: float,
                  peak_mem: float, machines: list) -> dict:
    """One run's roofline on each machine (the first the datasheet's, whose
    terms name the dominant one), its mfu (model flops over the measured
    time at each machine's peak), held at most ROOFLINE_SHARE_MAX, and the
    compute and memory terms' shares of the measured time, reported, not
    held: they count the plain program's work (all S**2 attention pairs,
    the logits' unfused bytes), which the card's kernels do not do, so
    neither is a floor of the card's time."""
    from repro_torch import roofline as rl

    step = rl.StepCost(**cost)
    terms, shares = {}, {}
    for machine in machines:
        r = rl.analyze(step, chips=1, model_flops_global=model_flops, machine=machine,
                       peak_mem_bytes=peak_mem)
        terms[machine.name] = {"compute_s": r.compute_s, "memory_s": r.memory_s,
                               "collective_s": r.collective_s, "dominant": r.dominant}
        shares[machine.name] = {"mfu": model_flops / (measured_s * machine.peak_flops),
                                "compute_share": r.compute_s / measured_s}
        mfu = shares[machine.name]["mfu"]
        check(0 <= mfu <= ROOFLINE_SHARE_MAX,
              f"roofline {run}: mfu {mfu} on {machine.name} above {ROOFLINE_SHARE_MAX}")
        if machine is machines[0]:
            first = r
    return {"phase": "roofline", "run": run, **first.as_dict(), "terms": terms,
            "measured_s": measured_s, **shares[machines[0].name], "shares": shares,
            "memory_term_over_measured": first.memory_s / measured_s,
            "flops_by_op": cost["flops_by_op"], "aten_ops": cost["ops"]}


def roofline_phase(dev, smi: str, measured: dict, mesh: dict | None, skipped: dict) -> None:
    """The roofline of every full-width run measured before it, from counts
    alone (the times are the earlier phases'; the meta counts of
    ROOFLINE_RUNS the mesh phase's): the machines (datasheet and measured
    on this card); checks that a CUDA tensor makes ``step_cost`` raise,
    that granite-3-2b's 2-layer full-width train step (B 1, S
    TRAIN_CUT_SEQ) counts the same on meta and on the CPU, and counts
    phase 7's w8a TopK round on the CPU with the real data; then one line
    a run."""
    import torch

    from repro_torch import roofline as rl
    from repro_torch.api import DataSpec, ExperimentSpec
    from repro_torch.configs import get_config
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.linalg import triu_size
    from repro_torch.models import init_lm_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step, synthetic_batch

    t_phase = time.perf_counter()
    bf16 = [rl.H100_SXM, rl.measure_machine(dev, dtype=torch.bfloat16)]
    fp64 = [rl.H100_SXM_FP64, rl.measure_machine(dev, dtype=torch.float64)]
    emit({"phase": "roofline", "part": "machines", "nvidia_smi": smi,
          "datasheet": [dataclasses.asdict(m) for m in (bf16[0], fp64[0])],
          "measured": [dataclasses.asdict(m) for m in (bf16[1], fp64[1])],
          "note": "measured: the best (8192, 8192) product and copy of 2 x 8192**2 "
                  "elements on this card, CUDA events"})

    refused = []
    for fn, args in ((torch.mul, (torch.ones(4, device=dev), 2.0)),
                     (lambda: torch.ones(4, device=dev) * 2, ())):
        try:
            rl.step_cost(fn, *args)
        except ValueError as err:
            refused.append(str(err)[:120])
    check(len(refused) == 2, f"step_cost counted CUDA tensors: {refused}")

    cut = dataclasses.replace(get_config("granite-3-2b"), n_layers=TRAIN_CUT_LAYERS,
                              accum_steps=1)
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_batch(cut, 1, TRAIN_CUT_SEQ, seed=0).items()}
    step = make_train_step(cut, AdamWConfig(lr=1e-3))
    counts = {}
    for where in ("meta", "cpu"):
        params = init_lm_params(0, cut, where)
        on = {k: v.to(where) for k, v in batch.items()}
        t0 = time.perf_counter()
        counts[where] = (rl.step_cost(step, params, adamw_init(params), on),
                         time.perf_counter() - t0)
        del params
    (meta, meta_s), (cpu, cpu_s) = counts["meta"], counts["cpu"]
    check(meta.flops == cpu.flops and meta.bytes == cpu.bytes,
          f"the 2-layer train step: meta {meta.flops} flops, {meta.bytes} bytes; CPU "
          f"{cpu.flops}, {cpu.bytes}")
    emit({"phase": "roofline", "part": "meta_equals_cpu", "arch": cut.name,
          "cut": f"n_layers {TRAIN_CUT_LAYERS}; full width", "batch_seq": [1, TRAIN_CUT_SEQ],
          "flops": meta.flops, "bytes": meta.bytes, "flops_equal": True, "bytes_equal": True,
          "aten_ops": {"meta": meta.ops, "cpu": cpu.ops}, "meta_s": meta_s, "cpu_s": cpu_s,
          "cuda_refused": refused,
          "note": "aten ops differ by the CPU's lift_fresh of torch.tensor(scalar) in AdamW, "
                  "which moves no bytes"})

    spec = ExperimentSpec(data=DataSpec(dataset="w8a"))
    cfg = spec.fednl_config()
    z = torch.as_tensor(spec.data.build(), dtype=torch.float64)
    n_clients, n_i, d = z.shape
    t0 = time.perf_counter()
    round_cost = rl.step_cost(make_fednl_round(z, cfg), fednl_init(z, cfg))
    round_s = time.perf_counter() - t0

    if mesh is not None:
        results = mesh["roofline_counts"]
        granite_train = next(r for r in results if r["arch"] == "granite-3-2b"
                             and r["shape"] == "train_4k")
        mesh_one_card = mesh["one_card"]
        check(mesh_one_card["flops"] == granite_train["cost"]["flops"],
              f"granite-3-2b train_4k: the 1 x 1 mesh's flops {mesh_one_card['flops']} != the "
              f"plain count's {granite_train['cost']['flops']}")
        emit({"phase": "roofline", "part": "mesh_one_card_equals_plain", "arch": "granite-3-2b",
              "flops": mesh_one_card["flops"], "flops_equal": True,
              "bytes": {"mesh_1x1": mesh_one_card["bytes"],
                        "plain": granite_train["cost"]["bytes"]}})
    else:  # the counts the mesh phase would have made beside its fake worlds
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        skipped.setdefault("roofline", []).append(
            "the 1 x 1 mesh's count against the plain one: the mesh phase did not run")
        runs = [run for run in ROOFLINE_RUNS if run[:2] in measured]
        with ProcessPoolExecutor(ROOFLINE_WORKERS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(count_on_meta, *zip(*runs))) if runs else []
    for res in results:
        arch, shape_name = res["arch"], res["shape"]
        if (arch, shape_name) not in measured:
            skipped.setdefault("roofline", []).append(
                f"{arch} {shape_name}: the phase that times it did not run")
            continue
        meas = measured[(arch, shape_name)]
        check(meas.get("n_layers", res["n_layers"]) == res["n_layers"],
              f"roofline {arch} {shape_name}: counted {res['n_layers']} layers, measured "
              f"{meas.get('n_layers')}")
        line = roofline_line(f"{arch} {shape_name}", res["cost"], res["model_flops"],
                             meas["ms"] / 1e3, meas["max_memory_allocated"], bf16)
        line.update(counted_on="meta", batch_seq=res["batch_seq"], note=res["note"],
                    n_layers=res["n_layers"],
                    params=res["params"], active_params=res["active_params"],
                    measured_by=meas["by"], count_s=res["count_s"])
        emit(line)
    if "round" not in measured:
        skipped.setdefault("roofline", []).append("w8a topk round: the trace phase did not run")
        emit({"phase": "roofline", "seconds": time.perf_counter() - t_phase})
        return
    # the round: model flops are the packed Hessians' products, what SYRK must do
    hess_flops = 2.0 * n_clients * n_i * triu_size(d)
    line = roofline_line("w8a topk round", dataclasses.asdict(round_cost), hess_flops,
                         measured["round"]["device_ms"] / 1e3, float("nan"), fp64)
    wall_s = measured["round"]["wall_ms"] / 1e3
    line.update(counted_on="cpu", shape=[n_clients, n_i, d], count_s=round_s,
                measured_by="phase 7: device ms per TopK round under torch.profiler",
                wall_s=wall_s, mfu_wall=hess_flops / (wall_s * fp64[0].peak_flops),
                model_flops_note="2 n n_i d(d+1)/2: the packed Hessians' products")
    emit(line)
    emit({"phase": "roofline", "seconds": time.perf_counter() - t_phase})


def main(argv: list[str] | None = None) -> int:
    run = select_phases(argv)  # an unknown name exits 2 here
    import torch

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, solve
    from repro_torch.compressors.core import upload_draws
    from repro_torch.compressors.select import randseqk_window_mask, rank_keys
    from repro_torch.configs import get_config
    from repro_torch.core.fednl import fednl_init, make_fednl_round
    from repro_torch.core.fednl_pp import fednl_pp_init, make_fednl_pp_round
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.compressor_select import (
        keys_in_shared_memory,
        select_topk_by_keys_cuda,
        select_topk_by_keys_plain,
        select_randseqk_cuda,
        select_randseqk_plain,
        select_topk_cuda,
        select_topk_plain,
        select_toplek_cuda,
        select_toplek_idx_cuda,
        select_toplek_idx_plain,
        select_toplek_plain,
        smem_optin,
        toplek_memory_path,
        toplek_plan,
        toplek_plan_for,
        toplek_spread,
        toplek_spread_for,
    )
    from repro_torch.kernels.hessian_syrk import (
        hessian_syrk_packed_cuda,
        hessian_syrk_packed_plain,
        syrk_l2_bytes,
        syrk_schedule,
    )
    from repro_torch.kernels.threefry import (
        threefry_launch_plan,
        threefry_uniform_cuda,
        threefry_uniform_plain,
    )
    from repro_torch.linalg import triu_size
    from repro_torch.models import cast_for_compute, init_decode_cache, lm_decode_step
    from repro_torch.objectives.logreg import logreg_oracles_packed

    dev = torch.device("cuda")
    t_run = time.perf_counter()
    phase_s: dict[str, float] = {}  # each phase's seconds, the build's and the card's too
    t_mark = [t_run]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    skipped: dict[str, list[str]] = {}  # phase: its parts skipped for want of another phase
    measured: dict = {}  # the full-width runs' times for the roofline phase
    cpu_side = CpuSide()  # the card-versus-CPU checks' CPU sides, off the critical path

    # --- 1 card ------------------------------------------------------------
    smi = nvidia_smi_line()
    emit({
        "phase": "card",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    if run != PHASES:
        emit({"phase": "selection", "phases": list(run)})
    mark("card")

    # --- 2 build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "built": sorted(reports),
        "ptxas": {
            name: [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
            for name, rep in reports.items()
        },
    })
    mark("build")

    # --- 3 kernels against their plain versions, w8a shapes ---------------
    spec = ExperimentSpec(data=DataSpec(dataset="w8a"), rounds=50, tol=1e-12)
    cfg = spec.fednl_config()
    z = torch.as_tensor(spec.data.build(), dtype=torch.float64, device=dev).contiguous()
    n_clients, n_i, d = z.shape
    t_len, k = triu_size(d), cfg.k_for(d)
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0.0, 1.0, size=(n_clients, n_i))
    hw = torch.as_tensor(sigma * (1.0 - sigma) / n_i, dtype=torch.float64, device=dev)
    if "kernels" in run:
        h_kernel = hessian_syrk_packed_cuda(z, hw, cfg.lam)
        h_plain = hessian_syrk_packed_plain(z, hw, cfg.lam)
        scale = hessian_syrk_packed_plain(z.abs(), hw.abs(), 0.0).abs().max().item()
        syrk_err = (h_kernel - h_plain).abs().max().item()
        check(h_kernel.shape == (n_clients, t_len), f"SYRK shape {tuple(h_kernel.shape)}")
        check(bool(torch.isfinite(h_kernel).all()), "SYRK output not finite")
        check(syrk_err <= SYRK_TOL * scale, f"SYRK error {syrk_err} > {SYRK_TOL} * {scale}")
        # the shared-z form of the sweep's group: 12 specs' hw on one z, client c
        # reading z[c mod 142]; against the plain version, and bit for bit against
        # the first form on z repeated
        hw_group = torch.as_tensor(
            rng.uniform(0.0, 0.25, size=(12 * n_clients, n_i)) / n_i, dtype=torch.float64, device=dev)
        h_group = hessian_syrk_packed_cuda(z, hw_group, cfg.lam)
        h_group_plain = hessian_syrk_packed_plain(z, hw_group, cfg.lam)
        group_scale = hessian_syrk_packed_plain(z.abs(), hw_group.abs(), 0.0).abs().max().item()
        syrk_group_err = (h_group - h_group_plain).abs().max().item()
        check(syrk_group_err <= SYRK_TOL * group_scale,
              f"SYRK shared-z error {syrk_group_err} > {SYRK_TOL} * {group_scale}")
        h_repeated = hessian_syrk_packed_cuda(z.repeat(12, 1, 1), hw_group, cfg.lam)
        check(bits_equal(h_group, h_repeated), "SYRK shared z differs from z repeated")
        del hw_group, h_group, h_group_plain, h_repeated
        # the probe phase's shapes: SYRK at (8, 64, 2,048), TopLEK at (8,
        # 2,098,176) with k 16,384 below, flash at a backbone layer (check_flash)
        probe_in = probe_kernel_inputs(dev, get_config(PROBE_ARCH))
        pz, phw, plam = probe_in["z"], probe_in["hw"], cfg.lam
        h_probe = hessian_syrk_packed_cuda(pz, phw, plam)
        probe_scale = hessian_syrk_packed_plain(pz.abs(), phw.abs(), 0.0).abs().max().item()
        probe_syrk_err = (h_probe - hessian_syrk_packed_plain(pz, phw, plam)).abs().max().item()
        check(h_probe.shape == (probe_in["clients"], probe_in["t"])
              and bool(torch.isfinite(h_probe).all()), "SYRK at the probe's shape")
        check(probe_syrk_err <= SYRK_TOL * probe_scale,
              f"SYRK at the probe's shape: {probe_syrk_err} > {SYRK_TOL} * {probe_scale}")
        del h_probe

        state0 = fednl_init(z, cfg)
        state1, _ = make_fednl_round(z, cfg)(state0)
        delta0 = logreg_oracles_packed(z, state0.x, cfg.lam)[2] - state0.h_local
        delta1 = logreg_oracles_packed(z, state1.x, cfg.lam)[2] - state1.h_local
        d350 = triu_size(350)
        topk_cases = {
            "round0_delta": (delta0, k),
            "round1_delta": (delta1, k),
            "near_ties": (torch.as_tensor(near_tie_rows(n_clients, t_len, 1), device=dev), k),
            "keys_in_device_memory": (
                torch.as_tensor(near_tie_rows(8, d350, 2), device=dev), 8 * 350
            ),
            "k_is_1": (torch.as_tensor(near_tie_rows(4, 257, 3), device=dev), 1),
            "k_is_T": (torch.as_tensor(near_tie_rows(4, 130, 4), device=dev), 130),
        }
        topk_err = 0.0
        for name, (u, kk) in topk_cases.items():
            u = u.contiguous()
            got, sent = select_topk_cuda(u, kk)
            want, sent_want = select_topk_plain(u, kk)
            check(bits_equal(got, want), f"TopK {name}: u_hat differs from the plain version")
            check(torch.equal(sent, sent_want), f"TopK {name}: sent differs")
            check(int((got != 0).sum(-1).max()) <= kk, f"TopK {name}: more than k kept")
            topk_err = max(topk_err, (got - want).abs().max().item())
        check(keys_in_shared_memory(t_len, dev), "w8a keys should fit shared memory")
        check(not keys_in_shared_memory(d350, dev), "d=350 keys should not fit shared memory")

        # the draws of the main path's first two rounds (seed 0), as the round makes them
        round_keys, key = [], state0.key
        for _ in range(2):
            key, sub = prng.split(key, 2)
            round_keys.append(prng.split(sub, n_clients))
        wide = rng.standard_normal((4, 70000))
        randseqk_cases = {  # name: (u, k, s)
            "round0_draws": (delta1, k, prng.randint(round_keys[0], 0, t_len)),
            "round1_draws": (delta1, k, prng.randint(round_keys[1], 0, t_len)),
            "s_is_0": (delta1, k, np.zeros(n_clients, dtype=np.int64)),
            "s_is_T_minus_1": (delta1, k, np.full(n_clients, t_len - 1, dtype=np.int64)),
            "wrapping": (delta1, k, t_len - 1 - rng.integers(0, k, size=n_clients)),
            "k_is_1": (delta1, 1, rng.integers(0, t_len, size=n_clients)),
            "k_is_T": (delta1, t_len, rng.integers(0, t_len, size=n_clients)),
            "long_rows": (torch.as_tensor(wide, device=dev), 4096, np.array([0, 69999, 65000, 123])),
        }
        randseqk_err = 0.0
        for name, (u, kk, s_np) in randseqk_cases.items():
            u = u.contiguous()
            s = torch.as_tensor(s_np, dtype=torch.int64, device=dev)
            got, sent = select_randseqk_cuda(u, kk, s)
            want, sent_want = select_randseqk_plain(u, kk, s)
            check(bits_equal(got, want), f"RandSeqK {name}: u_hat differs from the plain version")
            check(torch.equal(sent, sent_want), f"RandSeqK {name}: sent differs")
            randseqk_err = max(randseqk_err, (got - want).abs().max().item())

        probe_rng = np.random.default_rng(25)  # the probe-T fixtures' uniforms
        toplek_cases = {  # name: (u, k, unif, exact)
            "round0_delta": (delta0, k, prng.uniform(round_keys[0]), True),
            "round1_delta": (delta1, k, prng.uniform(round_keys[1]), False),
            "near_ties": (near_tie_rows(n_clients, t_len, 5), k, rng.uniform(size=n_clients), False),
            "dyadic": (dyadic_rows(n_clients, t_len, 6), k, rng.uniform(size=n_clients), True),
            "k_is_1": (near_tie_rows(8, t_len, 7), 1, rng.uniform(size=8), False),
            "k_is_T": (dyadic_rows(4, t_len, 8), t_len, rng.uniform(size=4), True),
            "k_is_T_small": (near_tie_rows(4, 130, 9), 130, rng.uniform(size=4), False),
            "keys_in_device_memory": (dyadic_rows(8, d350, 10), 8 * 350, rng.uniform(size=8), True),
            # the probe's (8, 2,098,176) rows at k 16,384: the spread route
            # (memory path 3); k 32,768 keeps path 2
            "probe_d2048_normal": (probe_in["u"], probe_in["k"], probe_in["unif"].cpu().numpy(),
                                   False),
            "probe_d2048_dyadic": (dyadic_rows(probe_in["clients"], probe_in["t"], 22), probe_in["k"],
                                   np.random.default_rng(23).uniform(size=probe_in["clients"]),
                                   True),
            "probe_d2048_zero": (torch.zeros_like(probe_in["u"]), probe_in["k"],
                                 probe_rng.uniform(size=probe_in["clients"]), True),
            "probe_d2048_near_ties": (near_tie_rows(probe_in["clients"], probe_in["t"], 24),
                                      probe_in["k"], probe_rng.uniform(size=probe_in["clients"]),
                                      False),
            "probe_d2048_k_is_1": (probe_in["u"], 1, probe_rng.uniform(size=probe_in["clients"]),
                                   False),
            "probe_d2048_k_32768_path_2": (probe_in["u"], 2 * probe_in["k"],
                                           probe_rng.uniform(size=probe_in["clients"]), False),
        }
        toplek_err, toplek_boundary, toplek_kept, toplek_case_err = 0.0, {}, {}, {}
        toplek_case_path, toplek_idx_checked = {}, []
        for name, (u, kk, unif_np, exact) in toplek_cases.items():
            u = torch.as_tensor(u, dtype=torch.float64, device=dev).contiguous()
            unif = torch.as_tensor(unif_np, dtype=torch.float64, device=dev)
            toplek_case_path[name] = toplek_memory_path(u.shape[1], kk, dev)
            got, sent = select_toplek_cuda(u, kk, unif)
            want, sent_want = select_toplek_plain(u, kk, unif)
            if name.startswith("probe_d2048") and exact:
                # the index form on the spread route: the dense form's u_hat
                # and kept, and the plain version's indices
                got_i, sent_i, idx_i = select_toplek_idx_cuda(u, kk, unif)
                _, _, idx_want = select_toplek_idx_plain(u, kk, unif)
                torch.cuda.synchronize()
                check(bits_equal(got_i, got) and torch.equal(sent_i, sent)
                      and torch.equal(idx_i, idx_want), f"TopLEK {name}: the index form differs")
                toplek_idx_checked.append(name)
                del got_i, sent_i, idx_i, idx_want
            torch.cuda.synchronize()
            check(sent.dtype == torch.int32, f"TopLEK {name}: sent dtype {sent.dtype}")
            differ = (~torch.all(got.view(torch.int64) == want.view(torch.int64), dim=-1)) | (
                sent != sent_want
            )
            rows = differ.nonzero().flatten().tolist()
            check(not (exact and rows), f"TopLEK {name}: rows {rows} differ on an exact fixture")
            u_host = u.cpu().numpy()
            for r in rows:
                check(abs(int(sent[r]) - int(sent_want[r])) == 1,
                      f"TopLEK {name}: row {r} kept {int(sent[r])} vs {int(sent_want[r])}")
                check(toplek_near_boundary(u_host[r], kk, float(unif_np[r])),
                      f"TopLEK {name}: row {r} differs away from the boundary")
            same = ~differ
            if bool(same.any()):
                toplek_case_err[name] = (got[same] - want[same]).abs().max().item()
                toplek_err = max(toplek_err, toplek_case_err[name])
            check(int((got != 0).sum(-1).max()) <= kk, f"TopLEK {name}: more than k kept")
            toplek_boundary[name] = len(rows)
            toplek_kept[name] = [int(sent.min()), int(sent.max())]
        check(toplek_kept["round0_delta"] == [0, 0] and toplek_kept["probe_d2048_zero"] == [0, 0],
              "TopLEK keeps nothing of an all-zero correction")
        check(all(path == 3 for name, path in toplek_case_path.items()
                  if name.startswith("probe_d2048") and not name.endswith("path_2"))
              and toplek_case_path["probe_d2048_k_32768_path_2"] == 2,
              f"TopLEK at the probe's T: memory paths {toplek_case_path}")
        plan_cases = {"w8a": (t_len, k), "k_is_T": (t_len, t_len),
                      "keys_in_device_memory": (d350, 8 * 350),
                      "probe_d2048": (probe_in["t"], probe_in["k"]),
                      "probe_d2048_k_32768": (probe_in["t"], 2 * probe_in["k"])}
        toplek_paths = {name: toplek_memory_path(tt, kk, dev) for name, (tt, kk) in plan_cases.items()}
        check(toplek_paths == {"w8a": 0, "k_is_T": 2, "keys_in_device_memory": 3, "probe_d2048": 3,
                               "probe_d2048_k_32768": 2},
              f"TopLEK memory paths {toplek_paths}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        spread = toplek_spread(probe_in["clients"], dev)
        check(spread == toplek_spread_for(probe_in["clients"], sms),
              f"TopLEK spread {spread} vs the host's {toplek_spread_for(probe_in['clients'], sms)}")
        # the plan worked out on the host (the CPU tests read it) is the kernel's
        optin = smem_optin(dev)
        for name, (tt, kk) in plan_cases.items():
            check(toplek_plan_for(tt, kk, optin) == toplek_plan(tt, kk, dev),
                  f"TopLEK {name}: host plan {toplek_plan_for(tt, kk, optin)} vs the kernel's "
                  f"{toplek_plan(tt, kk, dev)} at opt-in {optin}")
        torch.cuda.synchronize()
        emit({
            "phase": "kernels",
            "hessian_syrk_packed": {
                "max_abs_err": syrk_err, "scale": scale, "rel_err": syrk_err / scale,
                "tol": SYRK_TOL,
                "shared_z": {"clients": 12 * n_clients, "z_clients": n_clients,
                             "max_abs_err": syrk_group_err, "rel_err": syrk_group_err / group_scale,
                             "bit_exact_vs_z_repeated": True},
            },
            "select_topk": {
                "cases": sorted(topk_cases), "bit_exact": True, "max_abs_err": topk_err,
                "round0_delta_nonzero": int((delta0 != 0).sum()),
                "round1_delta_nonzero": int((delta1 != 0).sum()),
            },
            "select_randseqk": {
                "cases": sorted(randseqk_cases), "bit_exact": True, "max_abs_err": randseqk_err,
            },
            "select_toplek": {
                "cases": sorted(toplek_cases), "max_abs_err_exact_rows": toplek_err,
                "boundary_rows": toplek_boundary, "boundary_tol": TOPLEK_BOUNDARY,
                "kept_min_max": toplek_kept, "memory_paths": toplek_paths,
                "plans": {name: list(toplek_plan_for(tt, kk, optin))
                          for name, (tt, kk) in plan_cases.items()},
                "case_memory_paths": toplek_case_path, "index_form_checked": toplek_idx_checked,
                "shared_memory_per_block_optin": optin,
            },
            "probe_shapes": {
                "hessian_syrk_packed": {"shape": list(pz.shape), "max_abs_err": probe_syrk_err,
                                        "rel_err": probe_syrk_err / probe_scale, "tol": SYRK_TOL},
                "select_toplek": {"shape": [probe_in["clients"], probe_in["t"]], "k": probe_in["k"],
                                  "memory_path": toplek_paths["probe_d2048"],
                                  "blocks_a_client": spread, "sms": sms,
                                  "cases": sorted(n for n in toplek_cases
                                                  if n.startswith("probe_d2048"))},
            },
        })

        # the threefry kernel: the round's real client keys, T = 1, one client
        def keys_on_card(keys_np):
            return torch.as_tensor(np.ascontiguousarray(keys_np).view(np.int32), device=dev)

        wide_keys = prng.split(prng.prng_key(7), 1000)
        threefry_cases = {  # name: (keys, t)
            "w8a_round0": (round_keys[0], t_len),
            "w8a_round1": (round_keys[1], t_len),
            "t_is_1": (round_keys[0], 1),
            "one_client": (round_keys[1][:1], t_len),
            "many_clients_t_3000": (wide_keys, 3000),
            # T = 4097 odd: every row's aligned runs leave a head or a tail (f32
            # up to 3 elements, f64 one) to the kernel's tail loop
            "edge_every_row_t_4097": (wide_keys[:300], 4097),
        }
        threefry_report, threefry_err = {}, {torch.float32: 0.0, torch.float64: 0.0}
        for name, (keys_np, tt) in threefry_cases.items():
            kt = keys_on_card(keys_np)
            for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
                got = threefry_uniform_cuda(kt, tt, dtype)
                want = threefry_uniform_plain(kt, tt, dtype)
                torch.cuda.synchronize()
                check(got.shape == (keys_np.shape[0], tt) and got.dtype == dtype,
                      f"threefry {name}: {tuple(got.shape)} {got.dtype}")
                check(torch.equal(got.view(bits), want.view(bits)),
                      f"threefry {name} {dtype}: differs from the plain version")
                check(bool((got >= 0).all()) and bool((got < 1).all()), f"threefry {name}: out of [0, 1)")
                threefry_err[dtype] = max(threefry_err[dtype], (got - want).abs().max().item())
            threefry_report[name] = [keys_np.shape[0], tt]
        # against the host generator too, on two clients of the round
        host = prng.uniform(round_keys[0][:2], (t_len,), np.float32)
        card = threefry_uniform_cuda(keys_on_card(round_keys[0][:2]), t_len, torch.float32).cpu().numpy()
        check(np.array_equal(host.view(np.int32), card.view(np.int32)), "threefry vs prng.uniform")

        # TopK by keys: the round's real uniforms, ties at the k-th key, k = 1, k = T
        unif0 = threefry_uniform_cuda(keys_on_card(round_keys[0]), t_len, torch.float32)
        tie_keys = torch.as_tensor(
            (rng.integers(0, 16, size=(n_clients, t_len)) / 16).astype(np.float32), device=dev)
        by_keys_cases = {  # name: (u, keys, k)
            "round0_uniforms": (delta1, unif0, k),
            "ties_at_kth_key": (delta1, tie_keys, k),
            "k_is_1": (delta1, unif0, 1),
            "k_is_T": (delta1, unif0, t_len),
            "keys_in_device_memory": (
                torch.as_tensor(rng.standard_normal((4, d350)), device=dev),
                threefry_uniform_cuda(keys_on_card(round_keys[1][:4]), d350, torch.float32), 8 * 350),
        }
        tk = tie_keys.cpu().numpy()
        kth = -np.sort(-tk, axis=1)[:, k - 1]
        check(bool(np.all((tk == kth[:, None]).sum(1) > k - (tk > kth[:, None]).sum(1))),
              "the tie fixture has no tie across the k-th key")
        by_keys_err = 0.0
        for name, (u, keys, kk) in by_keys_cases.items():
            got, sent = select_topk_by_keys_cuda(u.contiguous(), keys.contiguous(), kk)
            want, sent_want = select_topk_by_keys_plain(u, keys, kk)
            check(bits_equal(got, want), f"TopK by keys {name}: u_hat differs from the plain version")
            check(torch.equal(sent, sent_want), f"TopK by keys {name}: sent differs")
            by_keys_err = max(by_keys_err, (got - want).abs().max().item())
        torch.cuda.synchronize()
        emit({
            "phase": "kernels",
            "threefry_uniform": {"cases": threefry_report, "dtypes": ["float32", "float64"],
                                 "bit_exact": True, "host_generator_bit_exact": True},
            "select_topk_by_keys": {"cases": sorted(by_keys_cases), "bit_exact": True,
                                    "max_abs_err": by_keys_err},
        })

        # the sweep's shapes (phase 8): a branch's 4 specs x 142 rows of the
        # group's (12 * 142, T) delta, as the round takes them -- a slice at the
        # branch's offset (the group is ordered by branch) or gathered by
        # index_select (any other order) -- and the threefry uniforms of the 568
        # clients of 4 specs (seeds 0-3, round 0, the keys split as the round
        # splits them)
        tie_block = torch.as_tensor(near_tie_rows(n_clients, t_len, 12), device=dev)
        group_rows = torch.cat([(delta1 if s % 2 == 0 else tie_block) * (1.0 + s / 8)
                                for s in range(12)])
        per_branch = 4 * n_clients
        branch_rows = {f"rows_{lo}_to_{lo + per_branch}": group_rows[lo:lo + per_branch]
                       for lo in range(0, 12 * n_clients, per_branch)}
        gathered = (np.arange(1, 12, 3)[:, None] * n_clients + np.arange(n_clients)).reshape(-1)
        branch_rows["index_select_specs_1_4_7_10"] = group_rows.index_select(
            0, torch.as_tensor(gathered, device=dev))
        spec_keys = np.stack([prng.prng_key(s) for s in range(4)])
        sweep_keys = prng.split(prng.split(spec_keys, 2)[:, 1], n_clients).reshape(-1, 2)
        sweep_starts = torch.as_tensor(prng.randint(sweep_keys, 0, t_len), dtype=torch.int64, device=dev)
        for name, u in branch_rows.items():
            check(u.shape == (per_branch, t_len), f"sweep rows {name}: {tuple(u.shape)}")
            got, sent = select_topk_cuda(u, k)
            want, sent_want = select_topk_plain(u, k)
            check(bits_equal(got, want) and torch.equal(sent, sent_want),
                  f"TopK at the sweep's {name}: differs from the plain version")
            topk_err = max(topk_err, (got - want).abs().max().item())
            got, sent = select_randseqk_cuda(u, k, sweep_starts)
            want, sent_want = select_randseqk_plain(u, k, sweep_starts)
            check(bits_equal(got, want) and torch.equal(sent, sent_want),
                  f"RandSeqK at the sweep's {name}: differs from the plain version")
            randseqk_err = max(randseqk_err, (got - want).abs().max().item())
        kt = keys_on_card(sweep_keys)
        for dtype, bits in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
            got = threefry_uniform_cuda(kt, t_len, dtype)
            want = threefry_uniform_plain(kt, t_len, dtype)
            check(got.shape == (per_branch, t_len) and torch.equal(got.view(bits), want.view(bits)),
                  f"threefry at the sweep's 568 clients {dtype}: differs from the plain version")
            threefry_err[dtype] = max(threefry_err[dtype], (got - want).abs().max().item())
        torch.cuda.synchronize()
        emit({
            "phase": "kernels", "sweep_shapes": {
                "rows": {name: list(u.shape) for name, u in branch_rows.items()},
                "select_topk_bit_exact": True, "select_randseqk_bit_exact": True,
                "threefry_uniform": {"clients": per_branch, "t": t_len,
                                     "dtypes": ["float32", "float64"], "bit_exact": True},
            },
        })
        del tie_block, group_rows, branch_rows, u, got, want
        del state0, state1, delta0, h_plain, tie_keys, wide_keys
        flash_report, flash_err = check_flash(dev, tfa)
        emit({"phase": "kernels", "flash_attention": flash_report})
        mark("kernels")

    # While the worker computes (phases 4 to train, and 10 to 12), this
    # process keeps CPU_SIDE_SPARE_CORES threads: the two together use the
    # cores once, and neither's parallel loops wait on the other's threads
    host_threads = torch.get_num_threads()

    def share_cores(on: bool) -> None:
        torch.set_num_threads(min(CPU_SIDE_SPARE_CORES, host_threads) if on else host_threads)

    share_cores(True)

    # --- 4 the main paths, the launch counts set to 0 before each ---------
    if "main" in run:
        def main_path(label: str, path_spec, per_round: tuple[str, ...]):
            """solve(path_spec) on the card: each kernel of ``per_round`` launched
            once a round and once in the warm-up round, SYRK also once at init;
            the first MAIN_CPU_ROUNDS rounds against the same spec on the CPU
            (cpu_jobs[label], the worker's run)."""
            cpu_rounds = MAIN_CPU_ROUNDS
            pp = path_spec.algorithm == "fednl-pp"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            rep = solve(path_spec)
            launches = launch_counts(ops)
            path_d = path_spec.data.dims()[0]
            check(rep.x.shape == (path_d,) and bool(np.all(np.isfinite(rep.x))),
                  f"{label}: x not finite")
            want = {name: 0 for name in launches}
            want.update({name: rep.rounds + 1 for name in per_round})
            want["hessian_syrk_packed"] = rep.rounds + 2
            check(launches == want,
                  f"{label}: launches {launches}, want {want} for {rep.rounds} rounds + warm-up (+ init)")
            rep_cpu, worker = cpu_jobs.pop(label).result()
            check(list(rep.sent_bits[:cpu_rounds]) == list(rep_cpu.sent_bits),
                  f"{label}: sent_bits {rep.sent_bits[:cpu_rounds]} vs CPU {rep_cpu.sent_bits}")
            out = {
                "phase": "main", "path": label, "device": rep.extras["device"],
                "shape_d_clients_n_i": list(path_spec.data.dims()), "rounds": rep.rounds,
                "sent_bits": rep.sent_bits.tolist(), "cpu_sent_bits_3": rep_cpu.sent_bits.tolist(),
                "bits_per_round": float(np.mean(rep.sent_bits)),
            }
            if pp:
                xh, xh_cpu = rep.x_hist, rep_cpu.x_hist  # each round's model, norm-wise
                rel = np.linalg.norm(xh[:cpu_rounds] - xh_cpu, axis=1) / np.linalg.norm(xh_cpu, axis=1)
                check(bool(np.all(np.isfinite(xh))), f"{label}: models not finite")
                check(float(rel.max()) <= TRAJECTORY_RTOL, f"{label}: card vs CPU models differ: {rel.max()}")
                check(rep.participants[:cpu_rounds] == rep_cpu.participants,
                      f"{label}: the chosen clients differ from the CPU run's")
                check(all(len(set(p)) == path_spec.tau for p in rep.participants),
                      f"{label}: not {path_spec.tau} distinct clients a round")
                out.update(final_grad_norm=rep.final_grad_norm, x_rel_err_3=rel.tolist(),
                           participants_round0=rep.participants[0][:8], tau=rep.extras["tau"])
            else:
                gn = rep.grad_norms
                check(rep.rounds >= 3 and bool(np.all(np.isfinite(gn))), f"{label}: grad norms {gn}")
                check(gn[-1] < gn[0], f"{label}: grad norm did not fall: {gn[0]} -> {gn[-1]}")
                rel = np.abs(gn[:cpu_rounds] - rep_cpu.grad_norms) / rep_cpu.grad_norms
                check(bool(np.all(rel <= TRAJECTORY_RTOL)), f"{label}: card vs CPU grad norms differ: {rel}")
                out.update(grad_norms=gn.tolist(), cpu_grad_norms_3=rep_cpu.grad_norms.tolist(),
                           cpu_rel_err_3=rel.tolist())
                if path_spec.algorithm == "fednl-ls":
                    check(list(rep.ls_steps[:cpu_rounds]) == list(rep_cpu.ls_steps),
                          f"{label}: ls_steps {rep.ls_steps[:cpu_rounds]} vs CPU {rep_cpu.ls_steps}")
                    out.update(ls_steps=rep.ls_steps.tolist())
            out.update(
                init_time_s=rep.init_time_s, wall_time_s=rep.wall_time_s,
                ms_per_round=rep.wall_time_s / rep.rounds * 1e3,
                max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
                cpu_side=worker,
            )
            emit(out)
            return rep, launches

        toplek_spec = spec.replace(compressor=CompressorSpec("toplek"))
        randseqk_spec = spec.replace(compressor=CompressorSpec("randseqk"), rounds=30, tol=0.0)
        randk_spec = spec.replace(compressor=CompressorSpec("randk"), rounds=30, tol=0.0)
        natural_spec = spec.replace(compressor=CompressorSpec("natural"), rounds=30, tol=0.0)
        ls_spec = spec.replace(algorithm="fednl-ls")
        pp_spec = spec.replace(algorithm="fednl-pp", tau=PP_TAU, rounds=50, tol=0.0)
        paths = {  # label: (spec, the kernels it launches once a round)
            "w8a topk option B hess0=exact rounds<=50 tol=1e-12": (spec, ("select_topk",)),
            "w8a toplek option B hess0=exact rounds<=50 tol=1e-12": (toplek_spec,
                                                                     ("select_toplek",)),
            "w8a randseqk option B hess0=exact rounds=30": (randseqk_spec, ("select_randseqk",)),
            "w8a randk option B hess0=exact rounds=30": (
                randk_spec, ("threefry_uniform", "threefry_uniform_float32", "select_topk_by_keys")),
            "w8a natural option B hess0=exact rounds=30": (
                natural_spec, ("threefry_uniform", "threefry_uniform_float64")),
            "w8a fednl-ls topk option B hess0=exact rounds<=50 tol=1e-12": (ls_spec,
                                                                            ("select_topk",)),
            f"w8a fednl-pp topk tau={PP_TAU} option B hess0=exact rounds=50": (pp_spec,
                                                                              ("select_topk",)),
        }
        # the paper's other two datasets (the synthetic generator at their
        # published shapes): TopK, TopLEK and RandSeqK, with w8a's checks
        for dataset in OTHER_DATASETS:
            ds_spec = spec.replace(data=DataSpec(dataset=dataset))
            paths.update({
                f"{dataset} topk option B hess0=exact rounds<=50 tol=1e-12": (
                    ds_spec, ("select_topk",)),
                f"{dataset} toplek option B hess0=exact rounds<=50 tol=1e-12": (
                    ds_spec.replace(compressor=CompressorSpec("toplek")), ("select_toplek",)),
                f"{dataset} randseqk option B hess0=exact rounds=30": (
                    ds_spec.replace(compressor=CompressorSpec("randseqk"), rounds=30, tol=0.0),
                    ("select_randseqk",)),
            })
        # every path's CPU run queued in the worker first, in path order
        cpu_jobs = {label: cpu_side.submit(solve_cpu_side,
                                           path_spec.replace(rounds=MAIN_CPU_ROUNDS, tol=0.0))
                    for label, (path_spec, _) in paths.items()}
        ran = {label: main_path(label, path_spec, per_round)
               for label, (path_spec, per_round) in paths.items()}
        (rep, launches), (rep_le, launches_le), (rep_rs, launches_rs), (rep_rk, launches_rk), \
            (rep_nat, launches_nat), (rep_ls, launches_ls), (rep_pp, launches_pp) = \
            list(ran.values())[:7]
        check(rep.grad_norms[-1] <= rep.grad_norms[0] * 1e-6, f"TopK grad norms {rep.grad_norms}")
        check(rep_rs.rounds == 30, f"RandSeqK ran {rep_rs.rounds} rounds")
        check(rep_rk.rounds == rep_nat.rounds == 30, "RandK and Natural run 30 rounds")
        check(rep_pp.rounds == 50, f"PP ran {rep_pp.rounds} rounds")
        check(rep_pp.final_grad_norm < rep.grad_norms[0],
              f"PP: grad norm {rep_pp.final_grad_norm} not below the start's {rep.grad_norms[0]}")
        other_launches = {}
        for dataset in OTHER_DATASETS:
            for name in ("topk", "toplek", "randseqk"):
                label = next(lb for lb in ran if lb.startswith(f"{dataset} {name} "))
                ds_rep, other_launches[(dataset, name)] = ran[label]
                check(name != "randseqk" or ds_rep.rounds == 30,
                      f"{dataset} RandSeqK ran {ds_rep.rounds} rounds")
        mark("main")

    # --- 5 the LM path: granite-3-2b, the launch counts set to 0 before each -
    lm = None
    if "lm" in run:
        lm = lm_phase(dev, ops, cpu_side)
        flash_launches = lm["launches"]["flash_attention"]
        flash_routes = lm["flash_routes"]
        measured[("granite-3-2b", "prefill_32k")] = {
            "ms": lm["ms"], "by": BY_PREFILL, "max_memory_allocated": lm["max_memory_allocated"]}
        mark("lm")

    # --- 6 times at the main paths' shapes -------------------------------------
    if "times" in run:
        zs = hw[..., None] * z
        keys = rank_keys(delta1)
        syrk_ms = median_ms({
            "kernel": lambda: hessian_syrk_packed_cuda(z, hw, cfg.lam),
            "plain": lambda: hessian_syrk_packed_plain(z, hw, cfg.lam),
            "library": lambda: torch.bmm(z.mT, zs),
        })
        topk_ms = median_ms({
            "kernel": lambda: select_topk_cuda(delta1, k),
            "plain": lambda: select_topk_plain(delta1, k),
            "library": lambda: torch.topk(keys, k, dim=-1),
        })
        s_round = torch.as_tensor(prng.randint(round_keys[1], 0, t_len), device=dev)
        window = randseqk_window_mask(t_len, k, s_round)
        zeros = torch.zeros_like(delta1)
        randseqk_ms = median_ms({
            "kernel": lambda: select_randseqk_cuda(delta1, k, s_round),
            "plain": lambda: select_randseqk_plain(delta1, k, s_round),
            "library": lambda: torch.where(window, delta1, zeros),
        })
        unif_round = torch.as_tensor(prng.uniform(round_keys[1]), device=dev)
        toplek_ms = median_ms({
            "kernel": lambda: select_toplek_cuda(delta1, k, unif_round),
            "plain": lambda: select_toplek_plain(delta1, k, unif_round),
            "ranking_only": lambda: torch.topk(keys, k, dim=-1),
        })
        keys_round = keys_on_card(round_keys[1])
        threefry_ms = {
            name: median_ms({
                "kernel": lambda dt=dt: threefry_uniform_cuda(keys_round, t_len, dt),
                "plain": lambda dt=dt: threefry_uniform_plain(keys_round, t_len, dt),
                "library": lambda dt=dt: torch.rand((n_clients, t_len), dtype=dt, device=dev),
            })
            for name, dt in (("float32", torch.float32), ("float64", torch.float64))
        }
        # the star's one-client draw (2,130 launches in phase 10's PP RandK and
        # phase 11's tree RandK), and the kernel's device time at both shapes
        keys_one = keys_on_card(round_keys[1][:1])
        threefry_one_ms = {
            name: median_ms({
                "kernel": lambda dt=dt: threefry_uniform_cuda(keys_one, t_len, dt),
                "plain": lambda dt=dt: threefry_uniform_plain(keys_one, t_len, dt),
                "library": lambda dt=dt: torch.rand((1, t_len), dtype=dt, device=dev),
            })
            for name, dt in (("float32", torch.float32), ("float64", torch.float64))
        }
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            graphed = graph_median_ms({
                "round": lambda dt=dt: threefry_uniform_cuda(keys_round, t_len, dt),
                "one_client": lambda dt=dt: threefry_uniform_cuda(keys_one, t_len, dt)})
            threefry_ms[name]["kernel_graph"] = graphed["round"]
            threefry_one_ms[name]["kernel_graph"] = graphed["one_client"]
        threefry_plans = {
            f"{name}_{dt}": threefry_launch_plan(n, t_len, getattr(torch, dt), dev)
            for name, n in (("w8a_round", n_clients), ("one_client", 1))
            for dt in ("float32", "float64")}
        unif_keys = threefry_uniform_cuda(keys_round, t_len, torch.float32)
        by_keys_ms = median_ms({
            "kernel": lambda: select_topk_by_keys_cuda(delta1, unif_keys, k),
            "plain": lambda: select_topk_by_keys_plain(delta1, unif_keys, k),
            "library": lambda: torch.topk(unif_keys, k, dim=-1),
        })
        seq = shape_of("prefill_32k").seq
        fq, fk, fv = flash_inputs(dev, 1, seq, seq, 32, 8, 64, torch.bfloat16, 100)
        qt, kt, vt = (t.transpose(1, 2) for t in (fq, fk, fv))
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            flash_ms = median_ms({
                "kernel": lambda: tfa.flash_attention_cuda(fq, fk, fv, causal=True),
                "plain": lambda: tfa.flash_attention_plain(fq, fk, fv, causal=True),
                "library": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
            }, reps=FLASH_TIMED_REPS, calls=1)
        # the (query, key) pairs that the causal mask leaves visible, over the heads
        visible = tfa.visible_pairs(seq, seq, True, None) * fq.shape[2]
        product_flops = 2 * fq.shape[3] * visible  # QK^T, and again each P.V product
        flash_bytes = (2 * fq.numel() + fk.numel() + fv.numel()) * fq.element_size()
        flash_parts = {  # ms
            "qk_bf16_tensor": product_flops / BF16_TENSOR_FLOPS * 1e3,
            "pv_three_bf16_products_tensor": 3 * product_flops / BF16_TENSOR_FLOPS * 1e3,
            "bytes": flash_bytes / HBM_BYTES_PER_S * 1e3,
            "exp_mufu": visible / MUFU_EXP_PER_S * 1e3,
            "f32_pipe_pv_reckoning": (product_flops / BF16_TENSOR_FLOPS
                                      + product_flops / CUDA_CORE_32BIT_OPS) * 1e3,
            "all_bf16_p_rounded": 2 * product_flops / BF16_TENSOR_FLOPS * 1e3,
        }
        flash_bound = bound(flash_bytes, 4 * product_flops, BF16_TENSOR_FLOPS)
        del fq, fk, fv, qt, kt, vt
        # head_dim 256 at recurrentgemma-2b's layer and 128 at llava-next-mistral-
        # 7b's (both the wgmma route), each beside SDPA given the causal window as
        # a boolean mask
        flash256 = flash_layer(dev, tfa, 10, 1, 256, 2048, 101)
        flash128 = flash_layer(dev, tfa, 32, 8, 128, 4096, 102)
        # head_dim 128 at the layers of the zoo's configs cut in depth: causal
        # without a window beside SDPA(is_causal, enable_gqa), and mixtral-
        # 8x22b's causal window 4,096 beside SDPA given it as a boolean mask
        dense_cfgs = {arch: get_config(arch) for arch in ZOO_DEPTHS}
        flash_dense = {arch: flash_layer(dev, tfa, c.n_heads, c.n_kv, c.head_dim, c.window,
                                         103 + i)
                       for i, (arch, c) in enumerate(dense_cfgs.items())}
        if "flash_attention" in reports:
            flash256["ptxas"] = {fn: lines for fn, lines in build.ptxas_entries(
                reports["flash_attention"]).items() if "flash_fwd_wgmma_kernelILi256E" in fn}
        else:
            flash256["ptxas"] = "not measured (library built before this run)"
        syrk_bound, topk_bound, randseqk_bound, toplek_bound = fednl_round_bounds(
            n_clients, n_i, d, k).values()
        draws = n_clients * t_len
        # threefry's least time: its stores, or the integer instructions its
        # function needs per element on the busier of the two integer pipes,
        # 64 a clock per SM each at the card's highest SM clock: half of them,
        # as only the xors, fewer than half, must go to the INT32 pipe.  The
        # kernel's own SASS counts are printed beside it.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock_hz = sm_clock_hz()
        int_pipe_per_s = INT32_PIPE_PER_SM_CLOCK * sms * clock_hz
        threefry_bound, threefry_parts, threefry_one_bound = {}, {}, {}
        for name, size in (("float32", 4), ("float64", 8)):
            busier_pipe = max(THREEFRY_XORS_PER_ELEM[name], THREEFRY_INT_INSTRS_PER_ELEM[name] / 2)
            nbytes = n_clients * 8 + draws * size
            threefry_bound[name] = bound(nbytes, busier_pipe * draws, int_pipe_per_s)
            threefry_one_bound[name] = bound(8 + t_len * size, busier_pipe * t_len, int_pipe_per_s)
            threefry_parts[name] = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                                    "operations": busier_pipe * draws / int_pipe_per_s * 1e3,
                                    "busier_pipe_ops_per_elem": busier_pipe}
        threefry_sass = threefry_sass_facts(build)
        by_keys_bound = bound(
            # keys read, the k kept entries of u read, u_hat written, sent
            draws * 4 + n_clients * k * 8 + draws * 8 + n_clients * 4,
            SELECT_OPS_PER_KEY * draws,
            CUDA_CORE_32BIT_OPS,
        )
        syrk_ops = 2 * n_i * t_len * n_clients
        syrk_sched = syrk_schedule(d)
        syrk_tiles = sum(len(w) for *_, warps in syrk_sched for w in warps)
        syrk_l2 = syrk_l2_bytes(n_clients, n_i, d)
        emit({
            "phase": "times", "part": "hessian_syrk_packed", "shape": [n_clients, n_i, d],
            **syrk_build_facts(build, reports.get("hessian_syrk")),
            "blocks_per_client": len(syrk_sched), "dmma_tiles_per_client": syrk_tiles,
            # a block holds its slot until its busiest warp ends
            "busiest_warp_tiles_per_client": sum(max(map(len, w)) for *_, w in syrk_sched),
            "scheduled_over_exact_ops": syrk_tiles * 16 * 8 / t_len,
            "l2_bytes_reckoned": syrk_l2,
            "tflop_per_s_exact_triangle": syrk_ops / syrk_ms["kernel"] / 1e9,
            "l2_tb_per_s_implied": syrk_l2 / syrk_ms["kernel"] / 1e9,
            "bound_ms": syrk_bound[0], "bound_by": syrk_bound[1],
            "note": "l2_bytes_reckoned: Z's columns and hw that the schedule's blocks "
                    "stage (kernels/hessian_syrk.py:syrk_l2_bytes)",
        })
        emit({"phase": "times", "hessian_syrk_packed": syrk_ms, "select_topk": topk_ms,
              "select_randseqk": randseqk_ms, "select_toplek": toplek_ms,
              "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                      f"{CALLS_PER_EVENT} back-to-back calls, the three in turns; "
                      "randseqk library = torch.where on a precomputed window mask; "
                      "toplek has no library call: ranking_only = torch.topk on the "
                      "f32 keys, the ranking part only"})
        emit({"phase": "times", "threefry_uniform": threefry_ms, "select_topk_by_keys": by_keys_ms,
              "shape": [n_clients, t_len], "k": k,
              "threefry_uniform_one_client": threefry_one_ms, "threefry_plans": threefry_plans,
              "bound_ms": {"threefry_float32": threefry_bound["float32"],
                           "threefry_float64": threefry_bound["float64"],
                           "threefry_one_client_float32": threefry_one_bound["float32"],
                           "threefry_one_client_float64": threefry_one_bound["float64"],
                           "select_topk_by_keys": by_keys_bound},
              "threefry_bound_parts_ms": threefry_parts,
              "threefry_sass": threefry_sass or "not measured (no cuobjdump beside nvcc)",
              "int_pipe": {"per_sm_clock": INT32_PIPE_PER_SM_CLOCK, "sms": sms,
                           "sm_clock_hz": clock_hz, "ops_per_s": int_pipe_per_s},
              "note": f"ms per call: median over {TIMED_REPS} event pairs around "
                      f"{CALLS_PER_EVENT} back-to-back calls, the three in turns; threefry "
                      "library = torch.rand of the same shape and type (another generator, "
                      "timed only); TopK by keys library = torch.topk on the same f32 keys; "
                      "threefry's bound: its stores, or the least integer instructions its "
                      f"function needs per element ({THREEFRY_INT_INSTRS_PER_ELEM}) over the two "
                      "integer pipes (INT32; IMAD on the FMA pipe), 64 a clock per SM each; "
                      "threefry_sass: each instantiation's main loop as compiled, per element "
                      "and pipe; kernel_graph: the same calls in a CUDA graph (device time, no "
                      "host time); threefry_plans: counters a thread, elements a run, tiles a "
                      "row, tiles, tail slots, blocks, resident blocks a SM, small route"})
        emit({"phase": "times", "flash_attention": flash_ms,
              "shape": [1, seq, 32, 8, 64], "causal": True, "dtype": "bfloat16",
              "route": tfa.flash_route(torch.bfloat16, 64),
              "bound_ms": flash_bound[0], "bound_by": flash_bound[1],
              "bound_parts_ms": flash_parts, "visible_pairs": visible,
              "note": f"ms per call: median over {FLASH_TIMED_REPS} event pairs around one call, "
                      "the three in turns; bound = (QK^T + 3 P.V bf16 products) at 989 TFLOP/s; "
                      "library = F.scaled_dot_product_attention(is_causal, enable_gqa) on the "
                      "flash or memory-efficient backend, which rounds p to bf16 for P.V: the "
                      "same function at lower precision"})
        for name, arch, layer in (
                ("flash_attention_dh256", None, flash256), ("flash_attention_dh128", None, flash128),
                *((zoo_layer_kernel(None, layer["window"]), arch, layer)
                  for arch, layer in flash_dense.items())):
            library = ("SDPA with the window as a boolean mask over all S x S pairs, the kv heads "
                       "repeated beforehand" if layer["window"] else
                       "F.scaled_dot_product_attention(is_causal, enable_gqa) on the flash or "
                       "memory-efficient backend")
            emit({"phase": "times", **({"layer": arch} if arch else {}), name: layer["ms"],
                  **{key: val for key, val in layer.items() if key not in ("ms", "bound")},
                  "bound_ms": layer["bound"][0], "bound_by": layer["bound"][1],
                  "note": f"ms per call: kernel and library the median over {FLASH_TIMED_REPS} event "
                          f"pairs around one call, in turns; plain over {FLASH_PLAIN_REPS} after a "
                          "warm-up; bound as the head_dim-64 row: (QK^T + 3 P.V bf16 products) over "
                          f"the visible pairs at 989 TFLOP/s; library = {library}, p rounded to "
                          "bf16"})
        # the round's kernels at a9a's and phishing's shapes (phase 4's paths)
        round_times = {dataset: fednl_round_times(dataset, dev) for dataset in OTHER_DATASETS}
        probe_times = probe_kernel_times(dev, tfa, probe_in, plam)
        mark("times")

    # --- 7 no host sync in a round; where the time goes (torch.profiler) ----
    if "trace" in run:
        pp_cfg = pp_spec.fednl_config()
        rounds_of = {  # path: (round function, initial state)
            "topk": (make_fednl_round(z, cfg), fednl_init(z, cfg)),
            "randk": (make_fednl_round(z, randk_spec.fednl_config()),
                      fednl_init(z, randk_spec.fednl_config())),
            "fednl-pp topk": (make_fednl_pp_round(z, pp_cfg, PP_TAU), fednl_pp_init(z, pp_cfg)),
        }
        for path, (round_fn, state) in rounds_of.items():
            warm, _ = round_fn(state)  # fills the caches (index tensors, kernels) first
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, m = round_fn(warm)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            emit({"phase": "trace", "path": path, "sync_debug_mode": "error",
                  "one_round_without_host_sync": True, "sent_bits": int(m.sent_bits)})
        topk_trace = trace_rounds(*rounds_of["topk"], 3)
        syrk_rows = [k for k in topk_trace.get("top_kernels", []) if "syrk" in k["name"]]
        emit({"phase": "trace", "path": "topk", **topk_trace,
              "syrk_ms_per_round": syrk_rows[0]["ms_per_round"] if syrk_rows else "not measured"})
        toplek_cfg = toplek_spec.fednl_config()
        emit({"phase": "trace", "path": "toplek",
              **trace_rounds(make_fednl_round(z, toplek_cfg), fednl_init(z, toplek_cfg), 3)})
        emit({"phase": "trace", "path": "randk", **trace_rounds(*rounds_of["randk"], 3)})
        natural_cfg = natural_spec.fednl_config()
        emit({"phase": "trace", "path": "natural",
              **trace_rounds(make_fednl_round(z, natural_cfg), fednl_init(z, natural_cfg), 3)})
        emit({"phase": "trace", "path": f"fednl-pp topk tau={PP_TAU}",
              **trace_rounds(*rounds_of["fednl-pp topk"], 3)})
        del rounds_of
        emit({"phase": "draws", **host_draw_ms(prng, upload_draws, n_clients, t_len, dev)})
        if lm is not None:
            emit({"phase": "trace", "path": "granite-3-2b prefill_32k (B=1)",
                  **trace(lambda: lm["prefill"](lm["params"], lm["batch"]), 1, "prefill")})
            serve_params = cast_for_compute(lm["params"])  # as the ServeEngine holds them
            decode = {"cache": init_decode_cache(lm["cfg"], 4, 128, dev)}
            step_tokens = torch.zeros((4, 1), dtype=torch.int64, device=dev)

            def decode_step():
                _, decode["cache"] = lm_decode_step(serve_params, lm["cfg"], decode["cache"],
                                                    step_tokens)

            decode_step()  # warm-up
            emit({"phase": "trace", "path": "granite-3-2b decode step (B=4, max_len 128)",
                  **trace(decode_step, 8, "step")})
            del serve_params, decode
        else:
            skipped["trace"] = ["granite-3-2b's prefill and decode traces: the lm phase did "
                                "not run"]
        measured["round"] = {"device_ms": topk_trace.get("device_ms_per_round"),
                             "wall_ms": rep.wall_time_s / rep.rounds * 1e3}
        check(measured["round"]["device_ms"] is not None, "phase 7 measured no device time")
        mark("trace")

    # --- probe: FedNL on granite-3-2b's full-width features, d = 2,048 -------
    # (before the zoo, while the lm phase's params are still on the card)
    # (a)'s depth cut is checked once its CPU side is in: in the zoo or the
    # train phase, between their cells, else at once
    probe, unchecked = None, []
    if "probe" in run:
        if lm is None:
            skipped["probe"] = ["the lm phase's params: the probe drew seed 0's itself"]
        probe = probe_phase(dev, ops, tfa, lm, cpu_side)
        unchecked.append(("probe", probe["job"], probe["finish"]))
        if "zoo" not in run and "train" not in run:
            unchecked.pop()[2]()
        mark("probe")
    lm = None  # granite's params freed before the zoo's

    # --- zoo: the moe, ssm, hybrid, vlm and encdec families and the dense
    # configs granite-3-2b does not cover; after granite's params are freed
    # The CPU sides of the zoo's and the train phase's depth cuts all start
    # here, in that order, one after another in the worker while the card
    # runs both phases: the train cells' CPU sides are most of the two
    # phases' CPU work, and would else wait for the train phase
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo_started = ({arch: zoo_hand_over(arch, dev, cpu_side) for arch in ZOO_FLASH_ROUTES}
                   if "zoo" in run else {})
    train_started = train_hand_overs(dev, cpu_side) if "train" in run and "zoo" in run else None
    hand_overs_s = time.perf_counter() - t0
    # (name, CpuRun, finish) of each card-vs-CPU check whose CPU side is still out
    zoo_unchecked: list = unchecked
    if "zoo" in run:
        t_zoo = time.perf_counter()
        zoo = {}
        for arch in ZOO_FLASH_ROUTES:  # each freed after it
            zoo[arch] = zoo_family(arch, dev, ops, cpu_side, zoo_started.pop(arch))
            zoo_unchecked.append((f"zoo/{arch}", zoo[arch]["job"], zoo[arch]["finish"]))
            while zoo_unchecked and zoo_unchecked[0][1].done():
                zoo_unchecked.pop(0)[2]()
        if "train" not in run:
            while zoo_unchecked:
                zoo_unchecked.pop(0)[2]()
        emit({"phase": "zoo", "seconds": time.perf_counter() - t_zoo,
              "family_seconds": {arch: z["seconds"] for arch, z in zoo.items()},
              "hand_overs_s": hand_overs_s, "host": host_memory(),
              "checked_in_the_train_phase": [name for name, _, _ in zoo_unchecked]})
        measured.update({(arch, "prefill_32k"): {
            "ms": z["ms"], "by": BY_PREFILL, "n_layers": z["n_layers"],
            "max_memory_allocated": z["max_memory_allocated"]} for arch, z in zoo.items()})
        mark("zoo")

    # --- train: LM training at every family's full width ---------------------
    train = None
    if "train" in run:
        train = train_phase(dev, ops, tfa, reports.get("flash_attention_bwd"), cpu_side,
                            train_started, zoo_unchecked)
        for cell in train["cells"].values():
            measured[(cell["full"]["arch"], "train_4k")] = {
                "ms": cell["full"]["ms_per_step"], "n_layers": cell["full"]["n_layers"],
                "max_memory_allocated": cell["full"]["max_memory_allocated"],
                "by": "the train phase: median host-clock ms per synchronised step"}
        mark("train")

    share_cores(False)

    # --- mesh: --mesh 1x1 on the card, the dry run in fake worlds ------------
    mesh = None
    if "mesh" in run:
        mesh = mesh_phase(dev, ops, train, skipped)
        mark("mesh")

    # --- 8 sweeps: the README's grid as one batched group ------------------
    sweep = None
    if "sweep" in run:
        sweep_launches, sweep = sweep_phase(ops)
        mark("sweep")

    # --- 9 sessions: step, save, restore ------------------------------------
    if "session" in run:
        session_phase()
        mark("session")

    share_cores(True)

    # --- 10 the wire stack: star-loopback, codecs, PP with faults, TCP -------
    # The CPU runs of (c) here and of the topologies' (c) and (d) queue in
    # the worker; each is checked as late as the selected phases allow: (c)
    # after the topology phase, theirs after the serve phase
    topo_finish: list = []
    if "star" in run:
        star = star_phase(ops, dev, cpu_side)
        star_finish = star.pop("finish")
        if "topology" not in run:
            star_finish()
        mark("star")

    # --- 11 topologies: trees of stars, async, elastic, TCP tree, obs --------
    if "topology" in run:
        topo, topo_finish = topology_phase(ops, dev, star, cpu_side)
        del star["z_np"], star["topk_rep"]
        star_finish()
        if "serve" not in run:
            while topo_finish:
                topo_finish.pop(0)()
        mark("topology")

    # --- 12 the serving engine and its gateway ------------------------------
    if "serve" in run:
        t_serve = time.perf_counter()
        if sweep is None:
            skipped["serve"] = ["(a)'s comparison with the sweep group's ms per round: the "
                                "sweep phase did not run"]
        serve = serve_phase(ops, dev, sweep)
        emit({"phase": "serve", "seconds": time.perf_counter() - t_serve})
        while topo_finish:
            topo_finish.pop(0)()
        mark("serve")

    share_cores(False)

    # --- 13 the sharded backend: a world of one on NCCL --------------------
    if "sharded" in run:
        if "main" not in run:
            skipped["sharded"] = ["phase4_local_ms_per_round: the main phase did not run"]
        sharded = sharded_phase(
            ops, dev, rep.wall_time_s / rep.rounds * 1e3 if "main" in run else None)
        mark("sharded")

    # --- roofline: every full-width run above, counted -----------------------
    if "roofline" in run:
        roofline_phase(dev, smi, measured, mesh, skipped)
        mark("roofline")
    cpu_side.close()

    if run == PHASES:
        kernels = [
            {
                "name": "hessian_syrk_packed", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/hessian_syrk.cu",
                "replaces": "src/repro/kernels/hessian_syrk.py:64",
                "launches": launches["hessian_syrk_packed"], "max_abs_err": syrk_err,
                "sweep_launches": sweep_launches["hessian_syrk_packed"],
                "ms": syrk_ms["kernel"], "plain_ms": syrk_ms["plain"],
                "bound_ms": syrk_bound[0], "bound_by": syrk_bound[1],
                "library_ms": syrk_ms["library"],
            },
            {
                "name": "select_topk", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
                "replaces": "src/repro/kernels/compressor_select.py:67",
                "launches": launches["select_topk"], "max_abs_err": topk_err,
                "sweep_launches": sweep_launches["select_topk"],
                "ms": topk_ms["kernel"], "plain_ms": topk_ms["plain"],
                "bound_ms": topk_bound[0], "bound_by": topk_bound[1],
                "library_ms": topk_ms["library"],
            },
            {
                "name": "select_randseqk", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
                "replaces": "src/repro/kernels/compressor_select.py:87",
                "launches": launches_rs["select_randseqk"], "max_abs_err": randseqk_err,
                "sweep_launches": sweep_launches["select_randseqk"],
                "ms": randseqk_ms["kernel"], "plain_ms": randseqk_ms["plain"],
                "bound_ms": randseqk_bound[0], "bound_by": randseqk_bound[1],
                "library_ms": randseqk_ms["library"],
            },
            {
                "name": "select_toplek", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
                "replaces": "src/repro/kernels/compressor_select.py:106",
                "launches": launches_le["select_toplek"], "max_abs_err": toplek_err,
                "sweep_launches": sweep_launches["select_toplek"],
                "ms": toplek_ms["kernel"], "plain_ms": toplek_ms["plain"],
                "bound_ms": toplek_bound[0], "bound_by": toplek_bound[1],
                "library_ms": None,
            },
            {
                "name": "threefry_uniform_float32", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/threefry.cu",
                "replaces": "src/repro/compressors/core.py:106 (jax.random.uniform on the "
                            "device; not a Pallas kernel)",
                "launches": launches_rk["threefry_uniform_float32"],
                "max_abs_err": threefry_err[torch.float32],
                "sweep_launches": sweep_launches["threefry_uniform_float32"],
                "ms": threefry_ms["float32"]["kernel"], "plain_ms": threefry_ms["float32"]["plain"],
                "bound_ms": threefry_bound["float32"][0], "bound_by": threefry_bound["float32"][1],
                "library_ms": threefry_ms["float32"]["library"],
                "graph_ms": threefry_ms["float32"]["kernel_graph"],
                "one_client_ms": threefry_one_ms["float32"]["kernel"],
                "one_client_graph_ms": threefry_one_ms["float32"]["kernel_graph"],
                "one_client_bound_ms": threefry_one_bound["float32"][0],
                "one_client_plain_ms": threefry_one_ms["float32"]["plain"],
                "one_client_library_ms": threefry_one_ms["float32"]["library"],
            },
            {
                "name": "threefry_uniform_float64", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/threefry.cu",
                "replaces": "src/repro/compressors/core.py:161 (jax.random.bernoulli's uniform on "
                            "the device; not a Pallas kernel)",
                "launches": launches_nat["threefry_uniform_float64"],
                "max_abs_err": threefry_err[torch.float64],
                "sweep_launches": sweep_launches["threefry_uniform_float64"],
                "ms": threefry_ms["float64"]["kernel"], "plain_ms": threefry_ms["float64"]["plain"],
                "bound_ms": threefry_bound["float64"][0], "bound_by": threefry_bound["float64"][1],
                "library_ms": threefry_ms["float64"]["library"],
                "graph_ms": threefry_ms["float64"]["kernel_graph"],
                "one_client_ms": threefry_one_ms["float64"]["kernel"],
                "one_client_graph_ms": threefry_one_ms["float64"]["kernel_graph"],
                "one_client_bound_ms": threefry_one_bound["float64"][0],
                "one_client_plain_ms": threefry_one_ms["float64"]["plain"],
                "one_client_library_ms": threefry_one_ms["float64"]["library"],
            },
            {
                "name": "select_topk_by_keys", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
                "replaces": "src/repro/compressors/core.py:107 (randk's lax.top_k: the selection "
                            "of src/repro/kernels/compressor_select.py:67 on RandK's keys)",
                "launches": launches_rk["select_topk_by_keys"], "max_abs_err": by_keys_err,
                "sweep_launches": sweep_launches["select_topk_by_keys"],
                "ms": by_keys_ms["kernel"], "plain_ms": by_keys_ms["plain"],
                "bound_ms": by_keys_bound[0], "bound_by": by_keys_bound[1],
                "library_ms": by_keys_ms["library"],
            },
            {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:95",
                "kernels": {"wgmma": "flash_fwd_wgmma_kernel (bf16, head_dim 64, 128 and 256)",
                            "simt": "flash_fwd_kernel (f32; bf16 at head_dim 16 and 32)"},
                "prefill_32k_routes": flash_routes,
                "launches": flash_launches, "max_abs_err": flash_err,
                "sweep_launches": sweep_launches["flash_attention"],
                "ms": flash_ms["kernel"], "plain_ms": flash_ms["plain"],
                "bound_ms": flash_bound[0], "bound_by": flash_bound[1],
                "library_ms": flash_ms["library"],
                "zoo_routes": {arch: z["routes"] for arch, z in zoo.items()},
            },
            *({
                "name": f"flash_attention_dh{dh}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": f"src/repro/kernels/flash_attention.py:95 (at head_dim {dh})",
                "kernels": {"wgmma": f"flash_fwd_wgmma_kernel, DH = {dh} (bf16)",
                            "simt": f"flash_fwd_kernel, DH = {dh} (f32)"},
                "layer": arch, "launches": zoo[arch]["routes"]["wgmma"],
                "max_abs_err": flash_report[fixture]["max_abs_err"],
                "ms": layer["ms"]["kernel"], "plain_ms": layer["ms"]["plain"],
                "bound_ms": layer["bound"][0], "bound_by": layer["bound"][1],
                "library_ms": layer["ms"].get("library"),
            } for dh, arch, fixture, layer in (
                (256, "recurrentgemma-2b", "recurrentgemma_32k_layer_dh256", flash256),
                (128, "llava-next-mistral-7b", "dh128_window200", flash128))),
            *({
                "name": zoo_layer_kernel(arch, layer["window"]),
                "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:95 (at head_dim 128, causal, "
                            + ("no window)" if layer["window"] is None else
                               f"window {layer['window']})"),
                "kernels": {"wgmma": "flash_fwd_wgmma_kernel, DH = 128 (bf16)"},
                "layer": f"{arch}: S {layer['shape'][1]}, H {layer['shape'][2]}, "
                         f"Kv {layer['shape'][3]}, dh 128, causal"
                         + (f" window {layer['window']}" if layer["window"] else ""),
                "launches": zoo[arch]["routes"]["wgmma"], "prefill_layers": zoo[arch]["n_layers"],
                "max_abs_err": flash_report[f"{arch}_32k_layer"]["max_abs_err"],
                "ms": layer["ms"]["kernel"], "plain_ms": layer["ms"]["plain"],
                "bound_ms": layer["bound"][0], "bound_by": layer["bound"][1],
                "library_ms": layer["ms"].get("library"),
            } for arch, layer in flash_dense.items()),
        ]
        tl = train["bwd"]  # granite-3-2b's training layer (TRAIN_LAYER), the train phase
        pair = {"ms": tl["ms"]["bwd_dq"] + tl["ms"]["bwd_dkdv"], "bound_ms": tl["bound"]["backward"][0],
                "bound_cuda_cores_ms": tl["bound_cuda_cores_ms"]["backward"],
                "plain_ms": tl["ms"]["plain_backward"],
                "sdpa_backward_ms": tl["ms"].get("sdpa_backward"),
                "two_kernel_floor_ms": tl["floors"]["two_kernel_products_ms"]}
        for name, key, kernel, err in (
                ("flash_attention_train", "train_forward",
                 "flash_fwd_wgmma_kernel<64, *, true> (bf16, head_dim 64/128/256) and "
                 "flash_fwd_kernel<*, *, *, true> (f32; bf16 at 16 and 32)", "o_f32_max_abs_err"),
                ("flash_attention_bwd_dq", "bwd_dq",
                 {"wgmma": "flash_bwd_dq_wgmma_kernel (bf16, head_dim 64/128/256)",
                  "simt": "flash_bwd_dq_kernel (f32; bf16 at 16 and 32)"}, "dq_max_abs_err"),
                ("flash_attention_bwd_dkdv", "bwd_dkdv",
                 {"wgmma": "flash_bwd_dkdv_wgmma_kernel (bf16, head_dim 64/128/256)",
                  "simt": "flash_bwd_dkdv_kernel (f32; bf16 at 16 and 32)"},
                 "dk_max_abs_err")):
            forward = name == "flash_attention_train"
            kernels.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention"
                          + (".cu" if forward else "_bwd.cu"),
                "replaces": "src/repro/kernels/flash_attention.py:95 (its forward, writing O in f32 "
                            "and the row lse for the backward)" if forward else
                            "src/repro/models/layers.py:135 (XLA's derivative of chunked_attention, "
                            "the jnp twin of src/repro/kernels/flash_attention.py:95; not a Pallas "
                            "kernel)",
                "kernels": kernel, "layer": "granite-3-2b training, B 2, S 4096, H 32, Kv 8, dh 64",
                "launches": train["full"]["launches_total"][name],
                "launches_per_step": train["full"]["launches_per_step"][name],
                "launches_per_step_by_arch": {
                    arch: cell["full"]["launches_per_step"][name]
                    for arch, cell in train["cells"].items()},
                "max_abs_err": tl["layer"][err],
                "ms": tl["ms"][key],
                "plain_ms": tl["ms"]["plain_train_forward" if forward else "plain_backward"],
                "bound_ms": tl["bound"][key][0], "bound_by": tl["bound"][key][1],
                "library_ms": tl["ms"].get("sdpa_forward") if forward else None,
                **({} if forward else {"bound_cuda_cores_ms": tl["bound_cuda_cores_ms"][key],
                                       "layer_route": tl["backward_route"],
                                       "backward_pair": pair}),
            })
        rg = tl["rg"]  # recurrentgemma-2b's training layer (RG_TRAIN_LAYER), the train phase
        rg_pair = {"ms": rg["ms"]["bwd_dq"] + rg["ms"]["bwd_dkdv"],
                   "bound_ms": rg["bound"]["backward"][0],
                   "bound_cuda_cores_ms": rg["bound_cuda_cores_ms"]["backward"],
                   "plain_ms": rg["ms"]["plain_backward"],
                   "sdpa_backward_ms": rg["ms"].get("sdpa_backward"),
                   "two_kernel_floor_ms": rg["floors"]["two_kernel_products_ms"],
                   "design_floor_ms": rg["floors"]["design_products_ms"]}
        for name, key, kernel, err in (
                ("flash_attention_bwd_dq", "bwd_dq", "flash_bwd_dq_wgmma_kernel<256> (64 queries a "
                 "block; both consumers compute S and dP, each sums half of dq's columns)",
                 "dq_max_abs_err"),
                ("flash_attention_bwd_dkdv", "bwd_dkdv", "flash_bwd_dkdv_wgmma_kernel<256> (64 keys "
                 "a block; one consumer sums dv, the other dk; each key tile's (query head, query tile) "
                 "pairs split over a cluster of dkdv_split blocks, the partial sums added in rank "
                 "order)", "dk_max_abs_err")):
            kernels.append({
                "name": f"{name}_dh256", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                "replaces": "src/repro/models/layers.py:135 (XLA's derivative of chunked_attention "
                            "at head_dim 256; not a Pallas kernel)",
                "kernels": kernel,
                "layer": "recurrentgemma-2b training, B 2, S 4096, H 10, Kv 1, dh 256, causal "
                         "window 2048",
                "launches": train["rg_full"]["launches_total"][name],
                "launches_per_step": train["rg_full"]["launches_per_step"][name],
                "max_abs_err": rg["layer"][err], "ms": rg["ms"][key],
                "plain_ms": rg["ms"]["plain_backward"],
                "bound_ms": rg["bound"][key][0], "bound_by": rg["bound"][key][1],
                "library_ms": None, "bound_cuda_cores_ms": rg["bound_cuda_cores_ms"][key],
                "layer_route": rg["backward_route"], "kernels_do_products": rg["kernels_do_products"],
                "dkdv_grid": rg["dkdv_grid"], "backward_pair": rg_pair,
            })
        # the training layers first run by this phase's cells: seamless's
        # non-causal MHA (encoder self and cross attention) at head_dim 64 and
        # llava's causal window at head_dim 128, each with its cell's launches
        for layer, arch, suffix, desc in (
                (train["bwd"]["seamless"], "seamless-m4t-large-v2", "dh64_mha_noncausal",
                 "seamless-m4t-large-v2 training, B 2, S 4096, H 16, Kv 16, dh 64, non-causal"),
                (train["bwd"]["llava"], "llava-next-mistral-7b", "dh128_window",
                 "llava-next-mistral-7b training, B 2, S 576 + 4096, H 32, Kv 8, dh 128, causal "
                 "window 4096"),
                *((train["bwd"]["dense"][arch], arch,
                   f"dh128_causal_{arch.replace('-', '_').replace('.', '_')}",
                   f"{arch} training, B {b}, S {s}, H {h}, Kv {kv}, dh {dh}, causal, at "
                   f"{DENSE_TRAIN_LAYERS[arch]} layers")
                  for arch, (b, s, h, kv, dh) in DENSE_TRAIN_LAYER.items()),
                (train["bwd"]["mixtral"], "mixtral-8x22b", "dh128_window_mixtral_8x22b",
                 "mixtral-8x22b training, B 2, S 4096, H 48, Kv 8, dh 128, causal window 4096 "
                 f"(every causal pair at S 4096), at {MIXTRAL_TRAIN_LAYERS} layer")):
            cell = train["cells"][arch]["full"]
            for name, key, err in (("flash_attention_train", "train_forward", "o_f32_max_abs_err"),
                                   ("flash_attention_bwd_dq", "bwd_dq", "dq_max_abs_err"),
                                   ("flash_attention_bwd_dkdv", "bwd_dkdv", "dk_max_abs_err")):
                forward = name == "flash_attention_train"
                kernels.append({
                    "name": f"{name}_{suffix}", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention"
                              + (".cu" if forward else "_bwd.cu"),
                    "replaces": "src/repro/kernels/flash_attention.py:95 (its forward, writing O in "
                                "f32 and the row lse)" if forward else
                                "src/repro/models/layers.py:135 (XLA's derivative of "
                                "chunked_attention; not a Pallas kernel)",
                    "layer": desc, "launches": cell["launches_total"][name],
                    "launches_per_step": cell["launches_per_step"][name],
                    "max_abs_err": layer["layer"][err], "ms": layer["ms"][key],
                    "plain_ms": layer["ms"]["plain_train_forward" if forward else "plain_backward"],
                    "bound_ms": layer["bound"][key][0], "bound_by": layer["bound"][key][1],
                    "library_ms": layer["ms"].get("sdpa_forward") if forward else None,
                    **({} if forward else {
                        "layer_route": layer["backward_route"],
                        "backward_pair": {
                            "ms": layer["ms"]["bwd_dq"] + layer["ms"]["bwd_dkdv"],
                            "bound_ms": layer["bound"]["backward"][0],
                            "plain_ms": layer["ms"]["plain_backward"],
                            "sdpa_backward_ms": layer["ms"].get("sdpa_backward"),
                            "two_kernel_floor_ms": layer["floors"]["two_kernel_products_ms"]}}),
                })
        for name, launched, replaces in (
            ("select_topk_idx", star["topk_launches"]["select_topk_idx"],
             "src/repro/kernels/compressor_select.py:67 (select_topk_pallas's selection, with the "
             "index output of src/repro/compressors/core.py:184 topk_sparse)"),
            ("select_topk_by_keys_idx", star["by_keys_idx_launches"]["select_topk_by_keys_idx"],
             "src/repro/compressors/core.py:189 (randk_sparse's lax.top_k, and the RandK codec's "
             "PRG replay, src/repro/comm/wire.py:184)"),
            ("select_toplek_idx", star["toplek_launches"]["select_toplek_idx"],
             "src/repro/kernels/compressor_select.py:106 (select_toplek_pallas, with the index "
             "output of src/repro/compressors/core.py:204 toplek_sparse)"),
        ):
            times = star["idx_ms"][name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compressor_select.cu",
                "replaces": replaces, "launches": launched, "max_abs_err": star["idx_err"][name],
                "ms": times["kernel"], "plain_ms": times["plain"], "dense_form_ms": times["dense_form"],
                "bound_ms": star["idx_bound"][name][0], "bound_by": star["idx_bound"][name][1],
                "library_ms": times.get("library"),
            })
        # the probe phase's kernels at its shapes: its solve's SYRK and TopLEK
        # launches, its backbone call's flash launches; phase 3's errors there
        # and phase 6's times
        pe = probe["emitted"]
        for name, launched, err, replaces in (
                ("hessian_syrk_packed", probe["solve_launches"]["hessian_syrk_packed"],
                 probe_syrk_err, "src/repro/kernels/hessian_syrk.py:64"),
                ("select_toplek", probe["solve_launches"]["select_toplek"],
                 toplek_case_err["probe_d2048_normal"], "src/repro/kernels/compressor_select.py:106"),
                ("flash_attention", probe["feature_launches"]["flash_attention"],
                 flash_report["probe_backbone_layer"]["max_abs_err"],
                 "src/repro/kernels/flash_attention.py:95")):
            times = probe_times[name]
            kernels.append({
                "name": f"{name}_probe", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + {
                    "hessian_syrk_packed": "hessian_syrk.cu", "select_toplek": "compressor_select.cu",
                    "flash_attention": "flash_attention.cu"}[name],
                "replaces": f"{replaces} (at the probe's shape: {pe['clients']} clients x "
                            f"{pe['n_i']} samples, d {pe['d']}, granite-3-2b's features)",
                "shape": times["shape"], "launches": launched, "max_abs_err": err,
                "ms": times["kernel"], "plain_ms": times["plain"],
                "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
                "library_ms": times.get("library"),
                **({"ranking_only_ms": times["ranking_only"],
                    "memory_path": toplek_paths["probe_d2048"],
                    "blocks_a_client": times["blocks_a_client"],
                    "cuda_kernels_a_call": pe["round"]["toplek_cuda_kernels_a_call"]}
                   if name == "select_toplek" else {}),
                **({"grid": times["grid"], "packed": times["packed"]}
                   if name == "flash_attention" else {}),
            })
        for entry in kernels:  # the star path's launches of the kernels it shares
            if entry["name"] in ("hessian_syrk_packed", "threefry_uniform_float32"):
                entry["star_launches"] = {
                    "topk": star["topk_launches"].get(entry["name"], 0),
                    "pp_randk": star["by_keys_idx_launches"].get(entry["name"], 0),
                }
        for entry in kernels:  # phase 11's launches, each part's counts set to 0 before it
            entry["topology_launches"] = {part: counts.get(entry["name"], 0)
                                          for part, counts in topo.items()}
        for entry in kernels:  # phase 12 (a): the engine under pressure, counts set to 0 before it
            entry["serve_launches"] = serve["launches"].get(entry["name"], 0)
        for entry in kernels:  # the zoo's 32k prefills, the counts set to 0 before each
            if not entry["name"].endswith(("_dh256", "_dh128", "_dh64_mha_noncausal",
                                           "_dh128_window")) and "_causal_" not in entry["name"]:
                entry["zoo_launches"] = {arch: z["launches"].get(entry["name"], 0)
                                         for arch, z in zoo.items()}
        for entry in kernels:  # the mesh phase's --mesh 1x1 run, the counts set to 0 before it
            entry["mesh_launches"] = mesh["launches"].get(entry["name"], 0)
        for entry in kernels:  # phase 13: each sharded path, its counts set to 0 before it
            entry["sharded_launches"] = {part: counts.get(entry["name"], 0)
                                         for part, counts in sharded["launches"].items()}
            if entry["name"] == "select_topk_idx":  # the sparse path's (142, T) shape
                entry["sharded_shape"] = sharded["idx_batched"]
        for entry in kernels:  # phase 4's a9a and phishing paths; phase 6's times there
            if entry["name"] in round_times[OTHER_DATASETS[0]]:
                entry["other_datasets"] = {dataset: {
                    **round_times[dataset][entry["name"]],
                    "launches": {path: counts.get(entry["name"], 0)
                                 for (ds, path), counts in other_launches.items() if ds == dataset},
                    "shape": round_times[dataset]["shape"]} for dataset in OTHER_DATASETS}
        emit({"kernels": kernels})
    else:
        emit({"phase": "selection", "ran": list(run), "not_run": [p for p in PHASES if p not in run],
              "skipped_parts": skipped,
              "note": "a partial run (--phases): no kernels line, which needs every phase"})
    emit({"phase": "run", "seconds": time.perf_counter() - t_run, "phase_seconds": phase_s})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
