#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: it builds the kernels from
``src/repro_torch/kernels/csrc``, serves randomly initialised tinyllama-1.1b
at full width and full depth, trains it at full width and depth for a few
steps, runs the paper's kernels and the scan kernel at their real shapes,
serves zamba2-7b and xlstm-1.3b, granite-moe-3b-a800m, deepseek-v3-671b
(MLA, depth cut), llama-3.2-vision-11b (one group) and seamless-m4t-medium
at full width, runs the Ara vector engine (one lane, lane-partitioned
and clustered) on the differential grid and the paper's Listing-1 matmul,
runs the fault-tolerance slice: the serving fault registry and its
load gate on tinyllama-1.1b, and training that checkpoints and resumes,
trains the other five families at full width, and drives the main
path's measurement scripts (the quickstart's twin for every arch, the
kernel bench, the multi-precision sweep, long-context attention to
32768 tokens with its gates, the engine's throughput), and the
multi-device machinery with the mesh held as tensor dimensions on the
card (ring matmuls, the GPipe pipeline, the int8 compressed all-reduce,
granite-moe-3b-a800m trained on a (2, 4) mesh through the expert-parallel
route, deepseek-v3-671b served on a (1, 4) mesh), and the dry run: the
count of a step's FLOPs, bytes and collectives and its roofline, held
against the measured step, and the mesh over processes (tinyllama-1.1b
trained data-parallel on NCCL at the machine's card count, the process
route's cases on 4 gloo ranks of its CPU, tinyllama-1.1b tensor-parallel
and FSDP and granite-moe-3b-a800m data- and expert-tensor-parallel on
ranks sharing the card through gloo). Without
a CUDA device, or in a directory that lacks the package, it exits
non-zero and prints no result. Phases, one JSON line each:

1. ``env``     the card's name and power limit, torch / CUDA / nvcc versions.
2. ``build``   compiles the kernels (seconds, registers and spills per kernel).
3. ``kernels`` every kernel against its plain PyTorch version on the card,
               at the serving shape (8,2048)@(2048,32000), at 128^3, at a
               small shape with 16-wide blocks and at ragged shapes, at the
               paper's 256^3 and 512^3, at (129,77,93), at M = 16 and 17
               (the skinny / tiled boundary) and at tinyllama-1.1b's MLP
               projection (8192,2048)@(2048,5632), bf16 and f32 (fp64
               references), and the logits head at shapes its default
               blocks do not tile; ``matmul_int8`` exact (int32, shift 7,
               saturated int8) at each of those shapes and at the two SSM
               models' int8 heads and the projection; asserts that all
               four matmul routes (``kernels.matmul.kernel_route``) and
               both int8 routes (``kernel_route_int8``) ran; then times
               kernel, plain version and ``torch.matmul`` at the head
               shape, 256^3, 512^3 and the projection, and ``matmul_int8``
               beside ``torch._int_mm`` (or its refusal) at the three int8
               heads, 256^3, 512^3 and the projection, each with its route.
4. ``attention`` the three blockwise-attention kernels (forward, dQ,
               dK/dV) against their plain versions on the card: at the
               training shape (B 4, H 32, S 2048, D 64, bf16, causal), at
               the ragged and small-block shapes of the CPU tests, with
               fully dead rows, in float32, bfloat16, float16 and float64;
               at zamba2-7b's serving-oracle shape (1, 32, 136, head_dim
               112) in float32 and bfloat16; the public autograd path
               against the CPU's; bfloat16 at (2,8,2048,64) with a dead
               batch, at (1,4,2048,64) with blocks 128 x 64 and at
               (1,4,1024,128), float16 at (1,4,2048,64), where the
               tensor-core tiles split differently, and at
               head_dim 45 (staged element by element); two
               launches of each kernel bit-equal; at the family train
               steps' shapes (phases 22-26) in bf16 and float32: the
               vision cross layer (2,32,2048,1600,128) and the audio one
               (2,16,2048,512,64), non-causal, the vision case with dead
               keys and a dead batch row (zeros in out, dq, dk, dv),
               zamba2-7b's shared block (2,32,2048,2048,112) and head_dim
               128 (2,32,2048,2048,128), causal; then times
               kernels, plain versions, bounds and
               ``F.scaled_dot_product_attention`` as a yardstick, and the
               forward at zamba2-7b's oracle shape, and the three bf16
               kernels at the four train shapes beside SDPA's forward and
               backward. A line
               ``attention_ptxas`` before it gives the registers and spills
               of every specialisation of the three kernels (none may
               spill on the tensor cores at 64 head columns), and
               ``attention_ptxas_bwd_dp128`` the backward kernels' 128-
               column specialisations, where head_dim 112 and 128 run
               (printed, not gated).
5. ``serve``   tinyllama-1.1b, 8 slots, 16 requests, degrade ladder down to
               the int8 logits head; checks states, tokens, events and that
               the int8 kernel was launched once per int8 step.
6. ``serve_exact`` the same model in float32, depth cut to 4 layers, against
               a greedy full-forward oracle (tokens equal, logits within
               1e-3); the cached decode path at full depth against the full
               forward in float64 (logits within 1e-3, tokens equal), with
               the float32 runs held to that witness; and the bf16
               logits-head route through ``matmul``. The full forward (no
               cache) goes through the attention kernel here; the oracle's
               launches of it are counted from 0.
7. ``train``   tinyllama-1.1b unreduced (bf16 compute, fp32 parameters,
               ``remat="full"``), batch 4 x 2048 of ``SyntheticLM``, 4 steps
               of the port's train step through the attention kernels:
               loss, grad norm, learning rate, changed parameters and the
               exact launch counts per step (2L forward, L dQ, L dK/dV).
8. ``train_exact`` one train step's loss and gradients, kernel route
               against the route forced off: at full width and 2 layers in
               float32, and at full width and depth in float64.
9. ``paper_kernels`` the paper's DAXPY (float64, n 256; float32, n 2^26)
               and DCONV (GoogLeNet layer 1, float32 and bf16 -> f32
               through a Policy) through ``ops.axpy`` / ``ops.conv2d``,
               their launches counted; every case against the plain
               version (bf16 at 2^26, the benchmark's 2^20, an lmul 8
               case, unaligned addresses, float64 and bf16 convolutions,
               the CPU tests' shapes, GoogLeNet's 3x3 layer, 3x3 at 256
               and 512 channels); every
               convolution bit-equal to its plain version, with the
               kernel route it took (compile-time taps or general); the
               contract's ValueErrors on CUDA tensors; times: ``axpy``
               against ``torch.add(y, x, alpha=a)`` in five alternating
               turns at each size, the convolutions against ``F.conv2d``
               with cuDNN's TF32 off.
10. ``ssm_kernel`` ``ops.ssm_scan`` at one layer of zamba2-7b (BH 448, S
               2048, N 64, P 64, chunk 256) and of xlstm-1.3b (BH 16, N
               512, P 1025), float32 and bfloat16, against its plain
               version and the model's ``chunked_linear_attention``; the
               benchmark's shape, S equal to and below the chunk, ragged
               N and P, float64, N 2048 at chunk 256, a chunk of 1024;
               ``S % chunk != 0`` and a chunk past the block's shared
               memory raise; times at both layers in float32 and bfloat16
               (no library call computes this function).
11. ``serve_ssm`` zamba2-7b unreduced (81 layers, d_model 3584) on 8 slots
               with 16 requests, and xlstm-1.3b unreduced (48 layers) on 2
               slots with 4, each through the degrade ladder down to the
               int8 head; checks as in phase 5.
12. ``serve_ssm_exact`` phase 6's first half for each of the two, depth
               cut (zamba2-7b 7 layers: one group, the shared block, one
               tail layer; xlstm-1.3b 4): float32 against the greedy
               full-forward oracle (tokens equal, logits within 1e-3);
               zamba2-7b's oracle runs its shared attention through the
               attention kernel at head_dim 112.
13. ``vector_engine`` the Ara vector engine (``core.vector_engine.
               ReferenceEngine``, which builds no CUDA kernel): the 21-cell
               SEW x LMUL differential grid, 20 programs a cell, in float32
               and float64 against the copied numpy oracle
               (``testing.differential``, ``diff.TOL``), and in float32,
               float64 and int32 (the integer cells) against the same
               engine on the CPU, bit for bit; Listing-1 at n = 64 bit-equal
               to the CPU run, and three Listing-1 programs batched with
               three grid programs, also bit-equal (groups of three replay
               CUDA graphs); Listing-1 at n = 256 on 16 lanes' VLMAX
               (1024 elements) in float64 against numpy's ``A @ B + C``
               (1e-12 of its largest entry), timed, with its scoreboard and
               closed-form cycles; the demo's masked argmax against
               ``np.argmax``; and what a CUDA graph of a group shape costs
               and saves (Listing-1 n = 64 eager and replayed on one
               runner, bit-equal: capture seconds a graph over the seconds
               a replay saves, the repeats at which a capture pays, beside
               ``staging.GRAPH_MIN_REPEATS``). Prints wall
               seconds, rows/s and programs/s on the card, and the same
               grid's seconds on the host CPU.
14. ``vector_engine_lanes`` the lane-partitioned ``LaneEngine`` (2 lanes)
               and the ``ClusterEngine`` at (2,2), (2,4) and (4,2) on the
               grid, 5 programs a cell, in float32, float64 and int32, each
               bit-equal to the card's ReferenceEngine on the same batch and
               to the same engine on the CPU (programs/s beside the
               ReferenceEngine's); Listing-1 at n = 128
               (``LANE_LISTING_N``) on 16 lanes in float64 through a flat
               16-lane LaneEngine and a 4 x 4 ClusterEngine, bit-equal to
               the card's ReferenceEngine result at that size (wall s,
               rows/s, cross-lane folds by unit); the scoreboard of phase
               13's n = 256 at 1 and 4 clusters beside the closed form;
               ``benchmarks/torch_scaleout.py``'s ``--verify`` at 2x2 and
               4x2 on the card.
15. ``serve_moe`` granite-moe-3b-a800m unreduced (32 layers of 40 routed
               experts, top 8, in a table padded to 48; vocabulary 49155)
               in float32, 8 slots, 16 requests asking for 18-32 tokens,
               through all three rungs (int8 head, bf16, the model's
               float32); checks as in phase 5. Its int8 head
               (8,1536)@(1536,49155) takes whole-dimension blocks; phase 3
               checks and times ``matmul_int8`` there.
16. ``serve_moe_exact`` the same tree at 2 layers, float32, capacity
               factor 8.0 (no token dropped): the engine's greedy tokens
               equal to the full-forward oracle's, cached logits within
               1e-3; the oracle's attention through ``flash_fwd``.
17. ``serve_mla`` deepseek-v3-671b at full width, 1 dense + 1 MoE layer
               (256 routed experts and a shared one) and the MTP module,
               bf16 as configured (29.8 GB): the serve steps' prefill and
               absorbed decode against the no-cache forward, float32
               compute the witness; a from-zero prefill of 2048 tokens (the
               triangular q-block loop) against the same without the hint;
               ``_mla_triangular`` against ``mla_chunked`` at S 2048;
               ``lm_loss`` with its MTP term; peak memory; then the engine
               (``serve_mla_engine``) as in phase 5 with 8 new tokens, its
               int8 head (8,7168)@(7168,129280).
18. ``serve_cross`` llama-3.2-vision-11b (one group: 5 self layers and a
               cross layer, gate set to 0.5; float32) and
               seamless-m4t-medium (12 + 12 layers; float64): prefill and 4
               decode steps through ``make_prefill_step`` /
               ``make_decode_step`` against the no-cache forward (1e-3),
               the cross layers through ``flash_fwd``'s non-causal mode,
               its launches counted; the forward kernel against its plain
               version at the cross shapes (2,32,Sq,1600,128) and
               (2,16,Sq,512,64), Sq 128 and 1, bf16 and f32, with dead
               rows; times at both in bf16 beside the plain version and
               ``F.scaled_dot_product_attention``; and float32 held at
               one self and one cross layer (vision) and one encoder and
               one decoder layer (audio), cached logits within 1e-3 of the
               largest logit of the no-cache forward's.
19. ``serve_faults`` every class of ``serving.faults.REGISTRY`` through
               ``verify`` on tinyllama-1.1b at full width, depth cut to 4
               layers, float32 (installed by ``faults.use_fixture``):
               detected by its code, recovered from with the survivors'
               greedy tokens equal to the full-forward oracle's (its
               attention through ``flash_fwd``, counted), and damage on
               the legacy engine; a token that flips is printed with its
               top-2 logit gap beside the cached-versus-full gap, and fails.
20. ``serving_load`` ``benchmarks/torch_serving_load.py``'s ``bench`` at the
               reference's traffic (120 ticks, 0.5 arrivals a tick, 4
               slots, ``max_seq`` 32, ladder at 2.0 / 4.0) on tinyllama-1.1b
               at full width and depth in its configured precision: zero
               undetected escapes, both rungs in the faulted phase, one
               ``matmul_int8`` launch per int8 decode step; goodput and
               P50/P99 latency in ticks and seconds, every counter.
21. ``train_restart`` the trainer on tinyllama-1.1b at full width, 1 layer,
               batch 4 x 2048 (fp32 parameters, bf16 compute, full remat):
               6 steps straight saving every 3, and 3 + 3 through a
               checkpoint, the resumed state equal to the straight one bit
               for bit (or, if two straight runs differ, within their gap,
               which is printed); ``ft.elastic.recover`` onto the card; a
               ``save(blocking=False)`` then one more in-place step
               restores the values before that step; the seconds the loop
               blocks in ``save`` beside the writer's; the attention
               kernels' launches. Checkpoints under ``tempfile.mkdtemp()``,
               deleted afterwards.
22-26. ``train_moe`` (granite-moe-3b-a800m, 16 of 32 layers), ``train_mla``
               (deepseek-v3-671b: 1 dense + 1 MoE layer with 32 of 256
               routed experts, and the MTP module; bf16 parameters and
               moments; 2 x 2048), ``train_hybrid`` (zamba2-7b, 12 of 81
               layers: the shared block twice), ``train_ssm`` (xlstm-1.3b,
               48 layers) and ``train_cross`` (llama-3.2-vision-11b,
               one group, gate 0.5; seamless-m4t-medium, 12 + 12 layers;
               stub ``frontend_emb`` in the batch): full width, the
               config's dtypes, full remat, AdamW, 3 steps at 4 x 2048
               of ``SyntheticLM``: each step's loss and grad norm finite,
               the learning rate ``adamw.schedule``'s, the embedding, the
               first and last layer and the router, gate, shared block or
               MTP module moved, and the attention kernels' launches
               exactly ``train_launches`` (full remat: the forward twice a
               layer; MLA, the mLSTM and Mamba2 layers and the audio
               encoder take none); step ms, tokens/s, peak memory,
               ``reduced`` and seconds. Then one step's loss and gradients
               at 2 layers or fewer (zamba2-7b: 6, its first shared block;
               vision: one self and one cross layer): float32, kernel route
               against the route forced off, at the configured init and
               with the attention projections at the width's fan-in;
               float64 kernel route against plain; deepseek-v3 and
               xlstm-1.3b float32 against float64.
27. ``quickstart`` ``examples/torch_quickstart.py``'s ``run`` for each of
               the ten archs on the card (reduced config, batch 2 x 32):
               its five lines, finite loss, grad norm and aux, the logits'
               shape, and the attention kernels' launches exactly
               ``quickstart_launches`` (a forward and a train step; none
               for xlstm-1.3b).
28. ``kernel_bench`` ``benchmarks/torch_kernel_bench.py``'s rows at the
               reference's shapes (matmul 256^3 f32, axpy 2^20 f32,
               GoogLeNet-1 f32, attention (1,8,1024,64) bf16 causal with
               256 x 256 blocks, the scan (8,4096,64) f32): each kernel
               against its plain version first (``BENCH_TOL``: phases 3,
               4, 9 and 10's tolerances; the conv bit-equal), then the
               rows, every ``_cuda`` row's launches equal to its calls
               (3) and each kernel launched once more (the warm call);
               ``_plain`` and ``_library`` rows beside them.
29. ``multiprecision`` ``benchmarks/torch_multiprecision.py``'s rows (the
               Ara model, the scoreboard, and ``ops.matmul`` at f32, bf16
               and f16 and ``ops.matmul_int8`` at 256 and 512, every
               kernel row ``source=cuda``): each product against its
               plain version (f32 at ACC_TOL, bf16 / f16 within one step
               of the plain product of the narrowed operands and within
               3e-2 / 0.5 of the f32 product, int8 exact); launches
               4 a row (warm + 3).
30. ``attention_long`` ``benchmarks/torch_attention_long.py``'s full sweep
               (1, 4, S, 64) bf16 causal, S 1024-32768, through the
               quadratic, blockwise and kernel paths, and its four gates
               (gate 3 in its card form: kernel >= blockwise fwd+bwd
               tokens/s at 32768; gate 4: the reduced tinyllama-1.1b's
               train step at 32768 tokens, f32, head_dim 16, through the
               kernels); each part's attention launches exact. The kernel
               path's output and q/k/v gradients against its kernels'
               plain versions (a group at a time) at every swept S, at
               ATT_TOL's bf16 limits; the three kernels at gate 4's shape
               (1, 4, 32768, 16) f32 causal against theirs at ACC_TOL.
31. ``engine_throughput`` ``benchmarks/torch_engine_throughput.py``'s
               ``bench`` on the card: uncached one runner build a program,
               cached, batched and each sweep one, the lint pass none;
               programs/s and the cached_batched/uncached ratio beside the
               reference's 10x bar (printed, not gated).
32. ``mesh_chaining`` ``core.chaining``'s ``all_gather_matmul`` at groups
               1, 2, 4, 8 and ``matmul_reduce_scatter`` on a (1, 8) mesh at
               (8192,2048)@(2048,5632): float32 against a float64 product,
               bf16 against the float32 product of the narrowed operands;
               ppermute counts exact; times beside ``torch.matmul``.
33. ``mesh_pipeline`` ``pipeline_loss`` on tinyllama-1.1b at full width, 4
               stages of 2 layers, 8 microbatches of 1 x 2048, bf16,
               forward and backward, against the layers in sequence
               (output bit-equal or within a bf16 step, gradients within
               ``PIPE_GRAD_TOL``); B3-B5 launches exact (M x S x 2 each)
               and held against their plain versions at the geometry
               the pipeline launched them at, (1, 32, 2048, 64), bf16 and
               float32; ``bubble_fraction(4, 8)`` beside the times.
34. ``mesh_compression`` ``compressed_psum`` on a (4, 1) mesh over
               tinyllama-1.1b's gradient tree (full width, 2 layers): mean
               within the reference's bound, residual below |g|max / 100,
               int8 wire bytes beside the f32 ring's.
35. ``mesh_train`` one full-width MoE layer through ``moe_ep_shard_map``
               on (2, 4) against ``moe_dense_dispatch`` (2048 tokens,
               capacity factor 16); the mesh step's loss and gradients
               against the one-device step's (1 MoE layer, float32, 8 x
               2048 tokens, capacity factor 5: no drops), and a planted
               misrouting that must fail that limit; then
               granite-moe-3b-a800m (4 layers) through
               ``Trainer(mesh=make_mesh(2, 4))``, 2 steps at 8 x 2048 on
               the expert-parallel route (3 all_to_all a chunk a MoE layer
               a pass), B3-B5 launches exact and held against their plain
               versions at the geometry the step launched them at, (8, 32,
               2048, 64), bf16 and float32; tokens/s and peak memory
               beside the one-device step at 4 x 2048 (another batch: no
               speed comparison).
36. ``mesh_serve`` deepseek-v3-671b at phase 17's cut on a (1, 4) mesh:
               prefill (MLA lane-local) and 4 decode steps against the
               same steps without a mesh (within bf16's own rounding), and
               ``ServingEngine(ctx=...)``'s greedy tokens equal to the
               engine's without a mesh.
37. ``dryrun`` the dry run (``launch/dryrun.py``, counted on ``meta``
               tensors for the card's routes): llama3-8b and
               granite-moe-3b-a800m ``train_4k``, deepseek-v3-671b
               ``prefill_32k`` at 4 of its 61 layers and tinyllama-1.1b
               ``decode_32k`` on the (16, 16) production mesh, each
               roofline row with its ``trace_s``, ``count_short`` and
               collective bytes by kind, one all-reduce derived per lookup
               into a vocab-sharded table, and the report twin's table
               over them; phase 7's tinyllama-1.1b train step counted on
               ``meta`` and on the card: FLOPs and bytes equal, and equal
               to ``DRYRUN_TRAIN_COUNT``, B3-B5's counted calls equal to their
               launches; the step's
               measured ms above ``compute_s`` and ``memory_s``, beside
               ``achievable_step_s`` and ``mfu_bound``; the measured peak
               memory beside the estimate.
38. ``mesh_processes`` the mesh over processes, spawned after
               ``free_memory()``: tinyllama-1.1b as phase 7 trains it, 3
               steps through ``Trainer(mesh=make_process_mesh(n, 1,
               device="cuda"))`` at n = ``torch.cuda.device_count()``
               NCCL ranks (each rank its block of the 4 x 2048 batch, one
               gradient pmean a leaf): at one rank losses and parameters
               bit-equal to phase 7's one-device step, B3-B5 44 / 22 / 22
               a step on every rank, ms a step, tokens/s and peak memory
               beside phase 7's, the collectives, the NCCL version and
               backend, NCCL's events in ``torch.profiler``; then every
               case of ``tests/torch_process_cases.py`` on 4 gloo ranks of
               the CPU but ``CARD_CASES`` (``tp_train``, ``fsdp_train``,
               ``moe_train``, ``mla_train``, ``mla_fsdp``,
               ``mla_fsdp_serve``, ``ep_train``, ``ep_serve``,
               ``moe_micro``, ``families_fsdp``), whose routes phases
               39-45 run on the card
               (``mesh_processes_gloo``).
               Only this process prints; a rank that fails fails the
               phase.
39. ``mesh_tensor_parallel`` tensor parallelism over processes, spawned
               after ``free_memory()``: at m = 4 (m = 2 cut since phase
               44, ``reduced``), m ranks on the
               one card in a gloo group (``make_process_mesh(1, m,
               backend="gloo")``; NCCL refuses two ranks on one card)
               train tinyllama-1.1b as phase 7 does but cut to 2 of its
               22 layers (``MESH_LAYERS``), 2 steps through ``Trainer``,
               each rank its blocks of every leaf: the first loss
               against the one-device step's (run first, at the same
               depth), and on conditioned parameters one step's loss
               and grad norm, each rank's blocks against the same slices
               of its result, B3-B5 4 / 2 / 2
               a step on every rank at 32 / m heads a launch (held
               against their plain versions there), the all-reduce bytes
               summed over the ranks equal to ``count_step``'s, a float32
               witness of 2 conditioned layers step by step; ms a step
               and peak GB a rank, the group's backend.
40. ``mesh_fsdp`` the same with ``fsdp=True`` on (4, 1) and (2, 2) ranks
               sharing the card: FSDP over ``data`` (and tensor
               parallelism over ``model``), held as phase 39 and against
               the same one-device steps, the gathers and
               reduce-scatters against ``count_step``'s.
41. ``mesh_moe`` granite-moe-3b-a800m (full width, 2 of 32 layers, as
               phase 7 trains: 4 x 2048, one dispatch group of 8192
               tokens) on (4, 1) and (2, 2) ranks sharing the card
               through gloo, 2 steps through ``Trainer``: the one-hot
               dispatch and the Switch aux loss over the global batch
               (the ranks gather each other's per-expert counts), the
               experts' FFN split over ``model``; the first loss, ce and
               aux and a conditioned grad norm against the one-device
               step's (run first), a float32 witness of 2 layers (a step
               at capacity factor 0.5 whose drops are each rank's
               block's, then one step; where each rank's routes agree
               with the one-device step's; a step with a flipped route
               held on the flipped share and a gap of 3e-5), B3-B5 4 / 2
               / 2 a rank-step at 1 x 32 rows x heads (held against
               their plain versions there), the dropped pairs against
               the one-device step's, the bytes by kind against
               ``count_step``'s; ms a step and peak GB a rank. On (2, 2)
               the Trainer runs in 2 micro-batches (each rank's its
               block of the global one), against a one-device trainer
               in 2 (drops by micro-batch and data block, the bytes
               against ``count_step(grad_accum=2)``'s, B3-B5 8 / 4 / 4 a
               rank-step at 1 x 16), the witness takes the
               expert-parallel route (the gate lowered to its 4 x 1024
               tokens) against the stacked route's step, each rank's
               drops its device's, and one step at 16 x 2048 in 2
               micro-batches takes the route at the reference's own gate
               in each (``mesh_moe_ep``): each rank's FFN blocks of the
               48 padded experts re-laid as blocks of the experts by an
               all-to-all, 3 all_to_all a MoE layer a pass a micro-batch
               and the re-lay's 3, the bytes against ``count_step``'s,
               B3-B5 8 / 4 / 4 a rank-step at 4 x 16 rows x heads (held
               against their plain versions there), the payloads the
               counts leave out, peak GB a rank.
42. ``mesh_mla`` deepseek-v3-671b with ``fsdp=False`` (full width, 1
               dense + 1 MoE layer of 8 routed experts, MTP, bf16
               parameters and moments, 2 x 2048) on (1, 4) ranks sharing
               the card: MLA's heads, the routed experts and the vocab
               split over ``model``, 2 steps through ``Trainer``; held as
               phase 41 (the mtp loss too, the witness at vocab 32000
               without MTP), B3-B5 1 / 1 / 1 a rank-step (the MTP
               module's GQA layer at 2 x 32 rows x heads), and a float32
               prefill and two absorbed decode steps on the rank's blocks
               against the one-device steps and ``count_step``'s bytes;
               the one-device steps run here after the spawn.
43. ``mesh_mla_fsdp`` deepseek-v3-671b as configured (``fsdp=True``; phase
               42's width and cut) on (2, 2) ranks sharing the card:
               every embed dimension over data, each MoE layer, the dense
               layer and the MTP module gathering their leaves (of the
               expert tables the rank's experts) where they run, the
               experts, heads and vocab over ``model``; held as phase 42,
               to phase 42's one-device record, the bytes against
               ``count_step``'s with FSDP, B3-B5 1 / 1 / 1 a rank-step at
               1 x 64 rows x heads; its witness on the
               expert-parallel route against the stacked route's step,
               and one step on the route at 4 x 1024 in 2 micro-batches,
               the gate lowered to a micro-batch's 2048 tokens
               (``mesh_mla_fsdp_ep``): each rank's held experts the
               block the reference's spec gives it, the bytes against
               ``count_step``'s (FSDP's gathers once a micro-batch),
               B3-B5 2 / 2 / 2 a rank-step at 1 x 64 rows x heads and
               1024 tokens, held against their plain versions there.
               Phases 39-47 share their spawn
               (``run_card_ranks``): one world of 4 ranks that runs (1,
               4), both FSDP meshes, both MoE meshes, the MLA mesh, the
               MoE FSDP mesh, phase 44's (4, 1), phase 46's (1, 4) and
               phase 47's (1, 4) and (2, 2) in turn.
44. ``mesh_families_fsdp`` the SSM, hybrid, vision and encoder-decoder
               families under FSDP on (4, 1) ranks sharing the card:
               xlstm-1.3b (1 layer), zamba2-7b (2 layers, the shared block
               after each, read twice and gathered once a forward),
               llama-3.2-vision-11b (1 self + 1 cross layer) and
               seamless-m4t-medium (1 encoder + 1 decoder layer), full
               width, ``fsdp=True``, one step at 4 x 2048 (one row a
               rank): loss and ce against the one-device step (run in the
               parent before the spawn), the bytes against
               ``count_step``'s, B3-B5 at the path's geometries against
               their plain versions, zamba2-7b's blocks against the
               one-device result and its prefill (4 x 64) and one decode
               step against the one-device logits; seconds of the step
               and peak GB a rank.
45. ``mesh_engine_fsdp`` the ``ServingEngine`` under FSDP over processes,
               at the end of the jobs of the one world of 4 that hold its
               models' blocks (no spawn or job of its own): one scheduler
               on every rank, each data rank its block of the slot pool,
               float32 compute, greedy: tinyllama-1.1b (phase 40's 2
               layers, its one-device result) on (4, 1), 4 slots, 4
               requests of 16-64 prompt tokens, 6 new tokens; zamba2-7b
               (phase 44's cut) on (4, 1), 4 slots, 4 requests, 3 new
               tokens; deepseek-v3-671b as configured (phase 43's cut,
               bf16 parameters) on (2, 2), 2 slots, 2 requests of 64
               tokens, 3 new tokens. Held: every rank's tokens
               identical; against the one-device engines (run in the
               parent before the spawn) the tokens equal, or where they
               part the one-device top-two margin within twice the
               step's float32 gap; each step's bytes by kind against
               ``count_step``'s serve step of its shape; no gathered leaf
               alive between steps. Recorded: peak GB a rank, ms a
               prefill and a decode step (host clock).
46. ``mesh_ssm_tp`` the SSM and hybrid blocks under the model axis on
               (1, 4) ranks sharing the card, a job of the one world of
               4: xlstm-1.3b and zamba2-7b at phase 44's cut,
               full width, ``fsdp=False``, one step at 4 x 2048, each
               rank its blocks of every ``d_inner`` leaf as the
               reference's rules lay them and its heads (the fused
               projection and Mamba2's conv weights all-gathered over
               model and sliced, the norm's sum of squares all-reduced,
               mLSTM's q, k, v reduce-scattered by heads), zamba2-7b's
               shared block on the dense tensor-parallel route: loss and
               ce against phase 44's one-device steps, zamba2-7b's blocks
               against the same slices of its one-device result, the
               bytes by kind against ``count_step``'s, B3-B5 at the
               rank's geometry (4 x 8 of 32 heads, 2048, 112) against
               their plain versions there, and zamba2-7b's float32
               prefill (4 x 64) and one decode step against the float64
               witness and ``count_step``'s bytes; ms a step, a prefill
               and a decode and peak GB a rank.
47. ``mesh_cross_tp`` the vision and encoder-decoder cross layers under the
               model axis, the last two jobs of the one world of 4:
               llama-3.2-vision-11b (1 self + 1 cross layer) on (1, 4)
               and seamless-m4t-medium (1 encoder + 1 decoder layer) on
               (2, 2), whose vocab of 256,206 4 ranks do not divide,
               full width, ``fsdp=False``, one step at 4 x 2048 and a
               second timed only, each rank its heads, kv heads and FFN
               columns of every layer (the cross layers' too, the tanh
               gate after the all-reduce; the encoder's output whole on
               every rank), as phase 46 holds its models: loss and ce
               against phase 44's one-device steps, a float64 witness at
               2 x 1024 against one device's, the bytes by kind against
               ``count_step``'s, B3-B5 at the rank's geometries (the
               vision model's 4 x 8 of 32 heads at (2048, 2048, 128)
               causal and (2048, 1600, 128) non-causal; the audio model's
               2 x 8 of 16 heads) against their plain versions there, and
               a float32 prefill (4 x 64, the frontend's embeddings) and
               one decode step against one device's float64 logits and
               ``count_step``'s bytes; ms a step, a prefill and a decode
               and peak GB a rank.

Then one line ``{"kernels": [...]}`` (one row per TPU kernel: launch counts
of the serving phases 5, 6, 11, 15, 17 and 20 for the matmul kernels, of
phases 7, 21 and 22-26, the oracles of 6, 12, 16 and 19, phase 17's loss
and phase 18's serve steps for the forward attention kernel, of phases 7,
21 and 22-26 for the backward ones, of phases 9-10 for axpy, conv and the
scan, and of phases 27-30 for the kernels they launch: each path's count
in ``launches_by_path``, keyed ``quickstart <arch>``, ``kernel_bench``,
``multiprecision``, ``attention_long rows`` and ``attention_long gate
1`` / ``2`` / ``4``, phases 33 and 35's ``mesh_pipeline`` and
``mesh_train``, phase 37's counted step, ``dryrun``, phase 38's
NCCL step summed over its ranks, ``mesh_processes``, and phases 39-47's
steps summed over their ranks, ``mesh_tensor_parallel (1, m)``,
``mesh_fsdp (d, m)``, ``mesh_moe (d, m)``, ``mesh_moe_ep (2, 2)``,
``mesh_mla (1, 4)``, ``mesh_mla_fsdp (2, 2)``, ``mesh_mla_fsdp_ep (2,
2)``, phase 44's ``mesh_families_fsdp <arch>``, phase 45's
``mesh_engine_fsdp <arch>``, phase 46's ``mesh_ssm_tp <arch>`` and phase
47's ``mesh_cross_tp <arch>``; error,
times and bound per
kernel), one line with the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failed check raises: nothing is caught and passed
over.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from benchmarks.torch_timing import hold_the_card  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.ara import AraConfig  # noqa: E402
from repro_torch.core import chaining, compat, isa, staging  # noqa: E402
from repro_torch.core.compat import PartitionSpec as PS  # noqa: E402
from repro_torch.core import perfmodel as pm  # noqa: E402
from repro_torch.core.precision import (PEAK_BYTES_PER_S,  # noqa: E402
                                        PEAKS_FLOPS, Policy, torch_dtype)
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import axpy as ax  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import conv as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import (moe_dense_dispatch,  # noqa: E402
                                    moe_ep_shard_map, moe_template)
from repro_torch.models.sharding import (MeshCtx,  # noqa: E402
                                         NamedSharding, held_experts,
                                         shard_params, tensor_parallel)
from repro_torch.models.layers import (abstract_params,  # noqa: E402
                                       init_params, tree_leaves,
                                       tree_map, tree_size_bytes,
                                       value_and_grad)
from repro_torch.models.ssm import chunked_linear_attention  # noqa: E402
from repro_torch.models.transformer import (dense_block,  # noqa: E402
                                            forward, init_cache, lm_loss,
                                            model_template)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import (compressed_psum,  # noqa: E402
                                           init_residuals)
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step, make_train_step,
                                    train_state_specs)
from repro_torch.core.cluster import ClusterEngine  # noqa: E402
from repro_torch.core.vector_engine import (LaneEngine,  # noqa: E402
                                            ReferenceEngine, make_lane_mesh,
                                            simulate_timing)
from repro_torch.serving import (DegradeLadder, Request,  # noqa: E402
                                 ServingEngine, State)
from repro_torch.testing import differential as diff  # noqa: E402
from repro_torch.ft import elastic  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.train.pipeline import (bubble_fraction,  # noqa: E402
                                        pipeline_apply, pipeline_loss)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

PATH_SHAPE = (8, 2048, 32000)      # (slots, d_model, vocab) of tinyllama-1.1b
# tinyllama-1.1b's MLP up-projection at train batch 4 x 2048 tokens
LARGE_SHAPE = (8192, 2048, 5632)
SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
TRAIN_ATT = (4, 32, 2048, 64)      # (batch, heads, seq, head_dim) in training
# (batch, heads, Sq, Sk, head_dim) of zamba2-7b's shared attention in the
# serving oracle, whose prompts of 32-128 tokens grow by up to 8
ZAMBA_ATT = (1, 32, 136, 136, 112)
ATT_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
MOE_ARCH, MLA_ARCH = "granite-moe-3b-a800m", "deepseek-v3-671b"
VISION_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "seamless-m4t-medium"
DEV = "cuda"                       # every tensor of this script lives here
RECORD: dict = {}                  # phase 7's numbers, for phase 38


def free_memory():
    """Collect unreachable objects first (a reference cycle can hold tensors
    that no name reaches), then return the allocator's cached blocks."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


_T0: list = []                    # main()'s start on the host clock


def emit(phase: str, **fields):
    """One JSON line; in a run of :func:`main`, with ``t_s``, the seconds
    since it started (where the run's time goes)."""
    t = {"t_s": time.perf_counter() - _T0[0]} if _T0 else {}
    print(json.dumps({"phase": phase, **fields, **t}), flush=True)


def time_ms(fn, warmup: int = 3, reps: int = 20, inner: int = 10) -> float:
    """Device ms per call of ``fn``: the median over ``reps`` batches of the
    time of ``inner`` back-to-back calls between two CUDA events, over
    ``inner``. The host needs tens of microseconds per call — as long as the
    kernels timed here run — so each batch is enqueued while the card is
    held busy (``benchmarks.torch_timing.hold_the_card``): the events then
    bracket device work only, not the card waiting for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        hold_the_card(DEV)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(m: int, k: int, n: int, in_bytes: int, out_bytes: int,
             peak_ops: float):
    """Least time the card could take: each input read once and the output
    written once over the memory rate, or the 2*m*k*n operations over the
    peak rate for the operand type — whichever is larger (the kernel's own
    count, ``kernels.matmul.work``)."""
    flops, nbytes = mm.work(m, k, n, in_bytes, out_bytes)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_release=release.group(1) if release else None,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    seconds = time.perf_counter() - t0
    mm_lib = build.load("matmul")
    assert mm_lib.repro_matmul and mm_lib.repro_matmul_int8
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log").read_text()
        for name, body in re.findall(
                r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*:\s*"
                r"Compiling|\Z)", log, flags=re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            ptxas.append({"kernel": name[:60],
                          "registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": int(spill.group(1))
                          if spill else None})
    emit("build", seconds=seconds,
         libraries=[os.path.basename(str(p)) for p in libs.values()],
         ptxas=ptxas)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


ACC_TOL = 3e-5        # fp32 accumulation order, as a share of max|ref|
BF16_ULP = 2.0 ** -7  # one step of a bfloat16 result, relative to the value
F16_ULP = 2.0 ** -10  # ... of a float16 result


def _check_float(name, got, ref, rel, results, acc=ACC_TOL, atol=0.0,
                 **detail):
    """|got - ref| <= rel * |ref| + acc * max|ref| + atol elementwise.

    Both sides multiply the same operands exactly and accumulate in fp32, so
    they differ by summation order only: ACC_TOL of the largest result
    (readings are 6e-8 to 1.3e-6 of it). A dropped k row or a wrongly
    unpacked lane moves a result by about 1/sqrt(K) of the scale, hundreds
    of times the allowance. ``rel`` is for a narrow output alone, where the two fp32
    sums may round to neighbouring narrow values: one step of that type."""
    equal = got.dtype == ref.dtype and torch.equal(got, ref)
    ref = ref.to(torch.float64)
    scale = float(ref.abs().max())
    err = (got.to(torch.float64) - ref).abs()
    ok = bool((err <= rel * ref.abs() + acc * scale + atol).all())
    results.append({"check": name, "max_err": float(err.max()),
                    "ref_max": scale, "rel_tol": rel,
                    "abs_tol": acc * scale + atol, "equal": equal, **detail})
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {results[-1]}")


def _check_exact(name, got, ref, results, **detail):
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        bad = int((got.to(torch.int64) != ref.to(torch.int64)).sum())
        raise AssertionError(f"{name}: {bad} elements differ from the plain "
                             f"version (must be exact)")
    results.append({"check": name, "max_err": 0, "tol": 0, **detail})


ROUTES_RAN: set = set()   # matmul routes taken by the checks of phase 3
INT8_ROUTES_RAN: set = set()   # ... and matmul_int8 routes


def _route(m, k, n, dt):
    route = mm.kernel_route(m, k, n, dt)
    ROUTES_RAN.add(route)
    return route


def _route_int8(m, k, n):
    route = mm.kernel_route_int8(m, k, n)
    INT8_ROUTES_RAN.add(route)
    return route


def check_int8(ai, bi, tag, blocks, results):
    """matmul_int8 exact against its plain version: int32, shift 7 with an
    int32 output, shift 7 saturated to int8; the route it took."""
    route = _route_int8(ai.shape[0], ai.shape[1], bi.shape[1])
    for kw in ({}, {"shift": 7}, {"shift": 7, "out_dtype": torch.int8}):
        got = mm.matmul_int8(ai, bi, **kw, **blocks)
        _check_exact(f"matmul_int8 {kw or 'int32'} {tag}", got,
                     mm.matmul_int8_plain(ai, bi, **kw), results,
                     route=route)


def check_shape(m, k, n, blocks, seed, results):
    dev = DEV
    tag = f"{m}x{k}x{n}"
    r = np.random.RandomState(seed)
    a32 = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(dev)
    # float32: against an fp64 product — true fp32 products, no TF32
    _route(m, k, n, torch.float32)
    got = mm.matmul(a32, b32, **blocks)
    _check_float(f"matmul f32 {tag}", got, a32.double() @ b32.double(), 0.0,
                 results)
    _check_float(f"matmul f32 vs plain {tag}", got, mm.matmul_plain(a32, b32),
                 0.0, results)
    for dt, ulp in ((torch.bfloat16, BF16_ULP), (torch.float16, F16_ULP)):
        a, b = a32.to(dt), b32.to(dt)
        short = str(dt).replace("torch.", "")
        _route(m, k, n, dt)
        got = mm.matmul(a, b, out_dtype=torch.float32, **blocks)
        _check_float(f"matmul {short}->f32 {tag}", got,
                     mm.matmul_plain(a, b, out_dtype=torch.float32), 0.0,
                     results)
        _check_float(f"matmul {short}->f32 vs fp64 {tag}", got,
                     a.double() @ b.double(), 0.0, results)
        got = mm.matmul(a, b, **blocks)           # narrow output
        assert got.dtype == dt
        _check_float(f"matmul {short}->{short} {tag}", got,
                     mm.matmul_plain(a, b), ulp, results)
    lo, hi = (-64, 64) if k <= 128 else (-128, 128)
    ai = torch.from_numpy(r.randint(lo, hi, (m, k)).astype(np.int8)).to(dev)
    bi = torch.from_numpy(r.randint(lo, hi, (k, n)).astype(np.int8)).to(dev)
    check_int8(ai, bi, tag, blocks, results)
    torch.cuda.synchronize()


def _int8_operands(m, k, n, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    ai = torch.randint(-128, 128, (m, k), generator=gen, device=DEV,
                       dtype=torch.int8)
    bi = torch.randint(-128, 128, (k, n), generator=gen, device=DEV,
                       dtype=torch.int8)
    return ai, bi


def int8_shapes():
    """(name, (M, K, N)) of matmul_int8 where it runs or is measured: the
    three served models' int8 heads (slots, d_model, vocab), the paper's
    int8 MATMUL squares (``benchmarks/multiprecision.py``) and
    LARGE_SHAPE, where the tiled route is bound by operations."""
    heads = [("tinyllama-1.1b head", PATH_SHAPE)]
    for arch, slots in [a[:2] for a in SSM_SERVE] + [(MOE_ARCH, 8),
                                                    (MLA_ARCH, 8)]:
        cfg = get_config(arch)
        heads.append((f"{arch} head", (slots, cfg.d_model, cfg.vocab_size)))
    return heads + [("256^3", (256, 256, 256)), ("512^3", (512, 512, 512)),
                    ("projection", LARGE_SHAPE)]


def int8_library_ms(ai, bi, **kw):
    """``torch._int_mm`` on the same operands, the one library call for
    this function: (ms, None), or (None, its refusal) where it does not
    take the shape (few rows). Only a yardstick: the port never calls it."""
    if not hasattr(torch, "_int_mm"):
        return None, "this torch build has no _int_mm"
    try:
        torch._int_mm(ai, bi)
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return time_ms(lambda: torch._int_mm(ai, bi), **kw), None


def head_blocks(m, k, n):
    """The blocks ``ops.lm_head`` gives the kernels for an (m,k)@(k,n) head:
    the defaults where they tile it, whole dimensions where not."""
    return {} if ops._block_tiles(m, k, n) else {"bm": m, "bn": n, "bk": k}


def time_matmul_int8(name, m, k, n, seed):
    """Kernel, plain version and ``torch._int_mm`` at one shape, int32
    output, operands from randint(-128, 128), with the bound and route;
    the kernel at the blocks ``ops.lm_head`` would give it."""
    ai, bi = _int8_operands(m, k, n, seed)
    blocks = head_blocks(m, k, n)
    bnd, by = bound_ms(m, k, n, 1, 4, PEAKS_FLOPS["int8"])
    big = m * k * n > 1e10
    kw = dict(warmup=2, reps=5, inner=3) if big else {}
    library_ms, note = int8_library_ms(ai, bi, **kw)
    return {"name": name, "shape": [m, k, n], "dtype": "int8->int32",
            "route": mm.kernel_route_int8(m, k, n),
            "blocks": blocks,
            "ms": time_ms(lambda: mm.matmul_int8(ai, bi, **blocks), **kw),
            "plain_ms": time_ms(lambda: mm.matmul_int8_plain(ai, bi), **kw),
            "library_ms": library_ms, "library_note": note,
            "bound_ms": bnd, "bound_by": by}


def check_ragged_head(results):
    """The logits head at shapes the default blocks do not tile (200 rows;
    a vocabulary of 31900): on the card these too go through the kernels,
    one launch each, and agree with the plain pipeline on the same inputs."""
    m, k, n = PATH_SHAPE
    r = np.random.RandomState(8)
    w = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(DEV) * 0.02
    for rows, cols in ((200, n), (8, 31900)):
        x = torch.from_numpy(r.randn(rows, 1, k).astype(np.float32)).to(DEV)
        wc = w[:, :cols].contiguous()
        tag = f"{rows}x{k}x{cols}"
        for dt in ("bfloat16", "float16", "int8"):
            assert ops.lm_head_route(rows, k, cols, dt, device=x.device) \
                == f"cuda-{dt}"
            assert ops.lm_head_route(rows, k, cols, dt) == "einsum-fallback"
        before = dict(mm.LAUNCHES)
        got = ops.lm_head(x, wc, compute_dtype="bfloat16")
        assert mm.LAUNCHES == {**before, "matmul": before["matmul"] + 1}
        _check_float(f"lm_head bfloat16 ragged {tag}", got[:, 0],
                     mm.matmul_plain(x[:, 0].bfloat16(), wc.bfloat16(),
                                     out_dtype=torch.float32), 0.0, results)
        before = dict(mm.LAUNCHES)
        got = ops.lm_head(x, wc, compute_dtype="int8")
        assert mm.LAUNCHES == {**before,
                               "matmul_int8": before["matmul_int8"] + 1}
        sx = x.abs().max() / 127.0 + 1e-8
        sw = wc.abs().max() / 127.0 + 1e-8
        qx = torch.round(x[:, 0] / sx).clamp(-127, 127).to(torch.int8)
        qw = torch.round(wc / sw).clamp(-127, 127).to(torch.int8)
        want = mm.matmul_int8_plain(qx, qw).float() * (sx * sw)
        if not torch.equal(got[:, 0], want):
            raise AssertionError(f"lm_head int8 ragged {tag}: differs from "
                                 f"the plain pipeline (must be exact)")
        results.append({"check": f"lm_head int8 ragged {tag}", "max_err": 0,
                        "tol": 0})
    torch.cuda.synchronize()


def check_large(results):
    """tinyllama-1.1b's MLP projection at train batch 4 x 2048, bf16 and
    f32, against the plain version and an fp64 product (the tiled routes
    at a size where they are bound by operations)."""
    m, k, n = LARGE_SHAPE
    tag = f"{m}x{k}x{n}"
    gen = torch.Generator(device=DEV).manual_seed(11)
    a32 = torch.randn((m, k), generator=gen, device=DEV)
    b32 = torch.randn((k, n), generator=gen, device=DEV)
    want64 = a32.to(torch.bfloat16).double() @ b32.to(torch.bfloat16).double()
    a, b = a32.bfloat16(), b32.bfloat16()
    assert _route(m, k, n, torch.bfloat16) == "tiled_mma"
    got = mm.matmul(a, b, out_dtype=torch.float32)
    _check_float(f"matmul bfloat16->f32 {tag}", got,
                 mm.matmul_plain(a, b, out_dtype=torch.float32), 0.0,
                 results)
    _check_float(f"matmul bfloat16->f32 vs fp64 {tag}", got, want64, 0.0,
                 results)
    _check_float(f"matmul bfloat16->bfloat16 {tag}", mm.matmul(a, b),
                 mm.matmul_plain(a, b), BF16_ULP, results)
    del want64, got
    assert _route(m, k, n, torch.float32) == "tiled_fma"
    got = mm.matmul(a32, b32)
    _check_float(f"matmul f32 vs fp64 {tag}", got, a32.double() @ b32.double(),
                 0.0, results)
    torch.cuda.synchronize()


def time_matmul(m, k, n, dt, seed):
    """Kernel, plain version and ``torch.matmul`` at one shape, fp32 out
    for narrow operands (the head's form), with the bound and the route."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=DEV).to(dt)
    b = torch.randn((k, n), generator=gen, device=DEV).to(dt)
    short = str(dt).replace("torch.", "")
    out_dt = torch.float32
    bnd, by = bound_ms(m, k, n, a.element_size(), 4, PEAKS_FLOPS[short])
    big = m * k * n > 1e10
    kw = dict(warmup=2, reps=5, inner=3) if big else {}
    return {"shape": [m, k, n], "dtype": f"{short}->float32",
            "route": mm.kernel_route(m, k, n, dt),
            "ms": time_ms(lambda: mm.matmul(a, b, out_dtype=out_dt), **kw),
            "plain_ms": time_ms(lambda: mm.matmul_plain(
                a, b, out_dtype=out_dt), **kw),
            "library_ms": time_ms(lambda: torch.matmul(a, b), **kw),
            "bound_ms": bnd, "bound_by": by}


def phase_kernels():
    results: list = []
    ROUTES_RAN.clear()
    INT8_ROUTES_RAN.clear()
    check_ragged_head(results)
    check_shape(*PATH_SHAPE, {}, 0, results)
    check_shape(128, 128, 128, {}, 1, results)
    check_shape(32, 48, 64, {"bm": 16, "bn": 16, "bk": 16}, 2, results)
    check_shape(5, 77, 93, {}, 3, results)      # ragged: element-wise loads
    check_shape(16, 100, 80, {}, 4, results)    # ragged: part-filled tile
    check_shape(24, 4224, 256, {}, 5, results)  # several K chunks, 3 row tiles
    check_shape(8, 2627, 256, {"bk": 1}, 6, results)  # K chunks, ragged end
    # the paper's square MATMUL sizes (the tiled routes), a ragged tiled
    # shape, and both sides of the skinny / tiled boundary
    check_shape(256, 256, 256, {}, 12, results)
    check_shape(512, 512, 512, {}, 13, results)
    check_shape(129, 77, 93, {"bm": 129, "bn": 93, "bk": 77}, 14, results)
    check_shape(16, 2048, 1000, {"bn": 1000}, 15, results)
    check_shape(17, 2048, 1000, {"bn": 1000}, 16, results)
    check_large(results)
    # matmul_int8 at the other served models' heads (granite-moe-3b-a800m's
    # odd vocabulary of 49155 takes whole-dimension blocks, as lm_head
    # gives them) and the projection shape, full int8 range
    for i, (name, (m, k, n)) in enumerate(int8_shapes()):
        if name.startswith(("zamba2", "xlstm", MOE_ARCH, MLA_ARCH,
                            "projection")):
            ai, bi = _int8_operands(m, k, n, 40 + i)
            check_int8(ai, bi, f"{m}x{k}x{n}", head_blocks(m, k, n), results)
            del ai, bi
    torch.cuda.synchronize()
    assert ROUTES_RAN == set(mm.ROUTES), ROUTES_RAN
    assert INT8_ROUTES_RAN == set(mm.ROUTES_INT8), INT8_ROUTES_RAN

    # times at the serving shape
    m, k, n = PATH_SHAPE
    r = np.random.RandomState(7)
    a32 = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(DEV)
    b32 = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(DEV)
    timed = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        a, b = a32.to(dt), b32.to(dt)
        short = str(dt).replace("torch.", "")
        bnd, by = bound_ms(m, k, n, a.element_size(), 4, PEAKS_FLOPS[short])
        timed[short] = {
            "ms": time_ms(lambda: mm.matmul(a, b, out_dtype=torch.float32)),
            "plain_ms": time_ms(lambda: mm.matmul_plain(
                a, b, out_dtype=torch.float32)),
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "bound_ms": bnd, "bound_by": by}
    # the whole logits head as the engine calls it: quantizes x AND the
    # whole unembedding on every call, then the kernel, then dequantizes
    x = a32.to(torch.bfloat16)[:, None, :]
    w = b32.to(torch.bfloat16)
    timed["lm_head_int8_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="int8"))
    timed["lm_head_bfloat16_ms"] = time_ms(
        lambda: ops.lm_head(x, w, compute_dtype="bfloat16"))
    timed["plain_head_bfloat16_ms"] = time_ms(lambda: x @ w)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        timed[str(dt).replace("torch.", "")]["route"] = mm.kernel_route(
            m, k, n, dt)
    # matmul at the paper's square sizes and at a size bound by operations
    timed["shapes"] = [time_matmul(sz, sz, sz, dt, 20 + sz)
                       for sz in (256, 512)
                       for dt in (torch.float32, torch.bfloat16,
                                  torch.float16)]
    timed["shapes"] += [time_matmul(*LARGE_SHAPE, dt, 30)
                        for dt in (torch.bfloat16, torch.float32)]
    # matmul_int8 at the heads, the paper's squares and the projection
    timed["int8_shapes"] = [time_matmul_int8(name, *shape, 50 + i)
                            for i, (name, shape) in enumerate(int8_shapes())]
    timed["int8"] = timed["int8_shapes"][0]           # the serving shape
    emit("kernels", shape=list(PATH_SHAPE), routes=sorted(ROUTES_RAN),
         int8_routes=sorted(INT8_ROUTES_RAN), checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 4: the attention kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


# Tolerances of a kernel against its plain version on the same inputs, as
# (rel, share of max|ref|). float32: summation order only (ACC_TOL).
# bfloat16 / float16: the outputs are narrow, and p (forward; dK/dV) and ds
# (backward) are rounded to the narrow type from fp32 values that the two
# sides compute in different summation orders, so a rounding may fall on
# either side of a tie: one step of the output type, relative to the value
# and to the largest value. float64: 1e-12 of the largest value.
ATT_TOL = {torch.float32: (0.0, ACC_TOL),
           torch.bfloat16: (BF16_ULP, BF16_ULP / 2),
           torch.float16: (F16_ULP, F16_ULP / 2),
           torch.float64: (0.0, 1e-12)}


def _att_inputs(b, h, sq, sk, d, dtype, seed, p_valid=1.0, dead=False):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s_, d), generator=gen, device=DEV,
                           dtype=torch.float64).to(dtype)
               for s_ in (sq, sk, sk))
    kv_valid = torch.rand((b, sk), generator=gen, device=DEV) < p_valid
    if dead:
        kv_valid[0] = False                   # batch 0: every row dead
    dout = torch.randn((b, h, sq, d), generator=gen, device=DEV,
                       dtype=torch.float64).to(dtype)
    return q, k, v, kv_valid, dout


def _plain_by_group(fn, *args, **geom):
    """The plain attention version ``fn`` on one group (batch x head) of
    the flat operands at a time, its results concatenated: the plain
    backward holds (Sq, Sk) fp32 matrices, 4 GiB a group at 32768 keys."""
    parts = [fn(*(a[g:g + 1] for a in args), **geom)
             for g in range(args[0].shape[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def check_attention_fwd(tag, b, h, sq, sk, d, dtype, causal, bq, bk, seed,
                        results, p_valid=0.9, dead=False):
    """The forward kernel against its plain version (a group at a time) on
    the same padded, flattened operands: output, lse (dead rows alike) and
    the probe exactly. Returns the operands, the kernel's outputs and the
    plain ones."""
    q, k, v, kv_valid, dout = _att_inputs(b, h, sq, sk, d, dtype, seed,
                                          p_valid, dead)
    qf, kf, vf, kvm, bq, bk = att._prepare(q, k, v, kv_valid, bq, bk)
    geom = dict(causal=causal, bq=bq, bk=bk)
    out, lse, probe = att.flash_fwd(qf, kf, vf, kvm, **geom)
    p_out, p_lse, p_probe = _plain_by_group(att.flash_fwd_plain, qf, kf, vf,
                                            kvm, **geom)
    torch.cuda.synchronize()
    rel, acc = ATT_TOL[dtype]
    short = str(dtype).replace("torch.", "")
    name = f"{tag} {short}{' causal' if causal else ''}"
    assert out.dtype == dtype and lse.dtype == p_lse.dtype
    _check_float(f"flash_fwd out {name}", out, p_out, rel, results, acc)
    dead_rows = p_lse <= att.NEG_INF * 0.5
    if not torch.equal(lse <= att.NEG_INF * 0.5, dead_rows):
        raise AssertionError(f"flash_fwd lse {name}: dead rows differ")
    # lse is fp32 (fp64) whatever the operands: summation order only
    lse_acc = 1e-12 if dtype == torch.float64 else ACC_TOL
    _check_float(f"flash_fwd lse {name}", lse[~dead_rows], p_lse[~dead_rows],
                 0.0, results, lse_acc)
    _check_exact(f"flash_fwd probe {name}", probe, p_probe, results)
    return dict(q=q, k=k, v=v, kv_valid=kv_valid, dout=dout, qf=qf, kf=kf,
                vf=vf, kvm=kvm, out=out, lse=lse, probe=probe, p_out=p_out,
                p_lse=p_lse, geom=geom, name=name)


def check_attention(tag, b, h, sq, sk, d, dtype, causal, bq, bk, seed,
                    results, p_valid=0.9, dead=False):
    """Forward, dQ and dK/dV kernels against their plain versions (a group
    at a time) on the same padded, flattened operands; the probe exactly.
    Returns the operands and the kernels' outputs."""
    f = check_attention_fwd(tag, b, h, sq, sk, d, dtype, causal, bq, bk,
                            seed, results, p_valid, dead)
    qf, kf, vf, kvm, geom = (f[n] for n in ("qf", "kf", "vf", "kvm", "geom"))
    rel, acc = ATT_TOL[dtype]
    name, p_lse = f["name"], f["p_lse"]
    doutf = torch.nn.functional.pad(
        f["dout"], (0, 0, 0, qf.shape[1] - sq)).reshape(qf.shape).contiguous()
    delta = (doutf.to(p_lse.dtype) * f["p_out"].to(p_lse.dtype)).sum(-1)
    args = (qf, kf, vf, kvm, doutf, p_lse, delta)
    dq = att.flash_bwd_dq(*args, **geom)
    dk, dv = att.flash_bwd_dkv(*args, **geom)
    torch.cuda.synchronize()
    _check_float(f"flash_bwd_dq {name}", dq,
                 _plain_by_group(att.flash_bwd_dq_plain, *args, **geom), rel,
                 results, acc)
    p_dk, p_dv = _plain_by_group(att.flash_bwd_dkv_plain, *args, **geom)
    _check_float(f"flash_bwd_dkv dk {name}", dk, p_dk, rel, results, acc)
    _check_float(f"flash_bwd_dkv dv {name}", dv, p_dv, rel, results, acc)
    if dead:
        g0 = h                              # batch 0 holds groups 0..h-1
        for what, t in (("out", f["out"]), ("dq", dq), ("dk", dk),
                        ("dv", dv)):
            if float(t[:g0].abs().max()) != 0.0:
                raise AssertionError(f"{name}: dead rows give non-zero {what}")
        results.append({"check": f"dead rows zero {name}", "max_err": 0,
                        "tol": 0})
    return dict(f, doutf=doutf, delta=delta, n=qf.shape[1] // geom["bq"])


def check_attention_autograd(results):
    """The public path with autograd (padding, flattening, the Function's
    backward) on the card against the same on CPU tensors, where the plain
    versions run: out and the three grads, fp32 and fp64."""
    for dtype in (torch.float32, torch.float64):
        q, k, v, kv_valid, dout = _att_inputs(2, 2, 45, 45, 16, dtype, 31,
                                              p_valid=0.9)
        got, want = [], []
        for dev, dst in ((DEV, got), ("cpu", want)):
            args = [t.detach().to(dev).requires_grad_(True)
                    for t in (q, k, v)]
            o = att.flash_attention(*args, kv_valid=kv_valid.to(dev),
                                    causal=True, bq=16, bk=8)
            dst.extend([o, *torch.autograd.grad(o, args, dout.to(dev))])
        short = str(dtype).replace("torch.", "")
        rel, acc = ATT_TOL[dtype]
        for what, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
            _check_float(f"flash_attention autograd {what} {short}",
                         a.detach(), b_.detach().to(DEV), rel, results, acc)


def check_deterministic(ops_, results):
    """Two launches of each kernel on the same bf16 inputs are bit-equal:
    every output element has one writer, no atomics."""
    fwd = (ops_["qf"], ops_["kf"], ops_["vf"], ops_["kvm"])
    bwd = fwd + (ops_["doutf"], ops_["lse"], ops_["delta"])

    def run():
        return (*att.flash_fwd(*fwd, **ops_["geom"]),
                att.flash_bwd_dq(*bwd, **ops_["geom"]),
                *att.flash_bwd_dkv(*bwd, **ops_["geom"]))
    first, second = run(), run()
    torch.cuda.synchronize()
    for what, a, b_ in zip(("out", "lse", "probe", "dq", "dk", "dv"), first,
                           second):
        if not torch.equal(a, b_):
            raise AssertionError(f"two launches give different {what}")
        results.append({"check": f"two launches bit-equal {what} bfloat16",
                        "max_err": 0, "tol": 0})


_MANGLED_TYPE = {"13__nv_bfloat16": "bfloat16", "6__half": "float16",
                 "f": "float32", "d": "float64"}


def attention_ptxas(log=None):
    """Registers and spills of every specialisation of the forward and the
    two backward kernels, from what ``ptxas -v`` wrote into the attention
    library's build log (or into ``log``)."""
    if log is None:
        log = build.library_path("attention").with_suffix(".log").read_text()
    rows = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*:\s*"
            r"Compiling|\Z)", log, flags=re.S):
        m = re.search(r"(flash_fwd|flash_bwd_dkv|flash_bwd_dq)_(mma|kernel)I"
                      r"(13__nv_bfloat16|6__half|f|d)[fd]?Li(\d+)E", name)
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        rows.append({
            "kernel": m.group(1), "dtype": _MANGLED_TYPE[m.group(3)],
            "head_cols": int(m.group(4)),
            "units": "tensor cores" if m.group(2) == "mma" else "CUDA cores",
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None,
            "spill_load_bytes": int(spill.group(2)) if spill else None})
    return rows


def att_bound(op: str, b, h, s, d, elt: int, dtype: str = "bfloat16",
              sk=None, causal=True):
    """Least time for one call at (b, h, s queries, ``sk`` keys (default
    s), d): the bytes of its inputs and outputs once over the memory rate,
    or its products over the peak rate for ``dtype`` (bf16: the tensor
    cores; float32: the CUDA cores, TF32 being off). The products and
    bytes are the kernel's own count (``kernels.attention.work``: the
    (query, key) pairs this input needs, the causal triangle's S(S+1)/2 a
    head or, without the causal term, the whole Sq x Sk rectangle), which
    the dry run (phase 37) counts too."""
    flops, nbytes = att.work(op, b * h, s, s if sk is None else sk, d, elt,
                             causal)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAKS_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# (tag, (batch, heads, Sq, Sk, head_dim), causal, dead) where the train
# steps of phases 22-26 run the three kernels: the vision and audio cross
# layers (non-causal; the vision case also checked with dead keys and a
# dead batch row), zamba2-7b's shared block (head_dim 112 in the kernels' 128
# columns) and head_dim 128 (the vision self layers, deepseek-v3's MTP
# layer), causal
TRAIN_SHAPES = (
    ("vision cross", (2, 32, 2048, 1600, 128), False, True),
    ("audio cross", (2, 16, 2048, 512, 64), False, False),
    ("zamba2 shared", (2, 32, 2048, 2048, 112), True, False),
    ("d128", (2, 32, 2048, 2048, 128), True, False),
)
SHAPE_TIMING = dict(warmup=2, reps=10, inner=5)
SHAPE_HEAVY = dict(warmup=1, reps=3, inner=2)   # the plain versions


def time_attention(f, shape, causal, results, timing=SHAPE_TIMING,
                   heavy=SHAPE_HEAVY):
    """Device ms of the three bf16 kernels on the operands ``f`` of
    :func:`check_attention` at ``shape`` (batch, heads, Sq, Sk, head_dim),
    beside their plain versions (timed with ``heavy``), their bounds and
    F.scaled_dot_product_attention's forward and backward (dQ, dK, dV
    together; no key mask), each with its largest error in ``results``."""
    b, h, sq, sk, d = shape
    qf, kf, vf, kvm, geom = (f[n] for n in ("qf", "kf", "vf", "kvm", "geom"))
    bwd = (qf, kf, vf, kvm, f["doutf"], f["lse"], f["delta"])
    errs = {r["check"]: r["max_err"] for r in results}
    sdpa = F.scaled_dot_product_attention
    q4, k4, v4 = (f[x].detach().requires_grad_(True) for x in "qkv")
    lib_fwd = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), **timing)
    o4 = sdpa(q4, k4, v4, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), f["dout"], retain_graph=True), **timing)
    row = {"shape": list(shape), "causal": causal, "dtype": "bfloat16",
           "blocks": [geom["bq"], geom["bk"]],
           "library_note": "F.scaled_dot_product_attention, no key mask: "
                           "forward; backward (dQ, dK, dV together)"}
    for name, fn, plain, err in (
            ("flash_fwd", lambda: att.flash_fwd(qf, kf, vf, kvm, **geom),
             lambda: att.flash_fwd_plain(qf, kf, vf, kvm, **geom),
             errs[f"flash_fwd out {f['name']}"]),
            ("flash_bwd_dq", lambda: att.flash_bwd_dq(*bwd, **geom),
             lambda: att.flash_bwd_dq_plain(*bwd, **geom),
             errs[f"flash_bwd_dq {f['name']}"]),
            ("flash_bwd_dkv", lambda: att.flash_bwd_dkv(*bwd, **geom),
             lambda: att.flash_bwd_dkv_plain(*bwd, **geom),
             max(errs[f"flash_bwd_dkv dk {f['name']}"],
                 errs[f"flash_bwd_dkv dv {f['name']}"]))):
        bnd, by = att_bound(name, b, h, sq, d, 2, sk=sk, causal=causal)
        row[name] = {"ms": time_ms(fn, **timing),
                     "plain_ms": time_ms(plain, **heavy),
                     "library_ms": lib_fwd if name == "flash_fwd"
                     else lib_bwd,
                     "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    return row


def check_train_shapes(results):
    """The forward, dQ and dK/dV against their plain versions at
    TRAIN_SHAPES in bfloat16 and float32 (dead rows zero in out, dq, dk and
    dv where the shape has them); the bf16 kernels timed on operands with
    every key live, as the train step gives them (its frontend memory has
    no mask), so that the bound's full rectangle is the work timed; where
    the shape's check has dead keys, those operands are checked too.
    Returns {tag: times}."""
    timed = {}
    for i, (tag, shape, causal, dead) in enumerate(TRAIN_SHAPES):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            f = check_attention(f"{tag} {shape}", *shape, dtype, causal, 128,
                                128, 80 + 2 * i + j, results,
                                p_valid=0.9 if dead else 1.0, dead=dead)
            if dtype == torch.bfloat16 and dead:
                del f
                free_memory()
                f = check_attention(f"{tag} live {shape}", *shape, dtype,
                                    causal, 128, 128, 90 + i, results,
                                    p_valid=1.0)
            if dtype == torch.bfloat16:
                timed[tag] = time_attention(f, shape, causal, results)
            del f
            free_memory()
    return timed


def phase_attention():
    ptxas = attention_ptxas()
    emit("attention_ptxas", kernels=ptxas)
    # the forward and both backward kernels, bf16 and f16 each
    mma64 = [r for r in ptxas
             if r["units"] == "tensor cores" and r["head_cols"] == 64]
    if len(mma64) != 6 or any(r["spill_store_bytes"] != 0
                              or r["spill_load_bytes"] != 0 for r in mma64):
        raise AssertionError(f"tensor-core kernels at 64 head columns: "
                             f"missing or spilling {mma64}")
    # head_dim 112 and 128 both run in the 128-column specialisation
    emit("attention_ptxas_bwd_dp128", head_dims=[112, 128], kernels=[
        r for r in ptxas
        if r["kernel"] != "flash_fwd" and r["head_cols"] == 128])
    results: list = []
    b, h, s, d = TRAIN_ATT
    ops_ = check_attention("train", b, h, s, s, d, torch.bfloat16, True,
                           128, 128, 10, results, p_valid=1.0)
    n = ops_["n"]
    if int(ops_["probe"].sum()) != b * h * n * (n + 1) // 2:
        raise AssertionError("causal probe does not sum to G*n(n+1)/2")
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for i, (sq, sk, bq, bk, causal) in enumerate((
                (64, 64, 16, 16, True), (64, 64, 16, 16, False),
                (48, 80, 16, 16, False), (33, 33, 16, 8, True),
                (33, 33, 16, 8, False), (130, 70, 32, 32, False),
                (7, 128, 32, 32, False), (20, 20, 32, 32, True))):
            check_attention(f"{sq}x{sk} b{bq}x{bk}", 2, 2, sq, sk, 16, dtype,
                            causal, bq, bk, 20 + i, results)
        check_attention("dead 32x32 b8x8", 2, 2, 32, 32, 8, dtype, False, 8,
                        8, 30, results, dead=True)
        check_attention("d128 256x256 b128x64", 1, 2, 256, 256, 128, dtype,
                        True, 128, 64, 31, results)
    check_attention("f16 256x256 b32x128", 1, 2, 256, 256, 64,
                    torch.float16, True, 32, 128, 32, results)
    check_attention("train f32", 1, 4, s, s, d, torch.float32, True, 128, 128,
                    33, results, p_valid=1.0)
    # zamba2-7b's shared attention as the serving oracle's full forward
    # gives it: (1, 32, S, 112), the kernel's 128 head columns of which 16
    # are zero, the default 128x128 blocks over a ragged tail
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        check_attention(f"zamba2 {ZAMBA_ATT}", *ZAMBA_ATT, dtype, True, 128,
                        128, 34 + i, results, p_valid=1.0)
    check_attention_autograd(results)
    # bfloat16 / float16 geometries where the backward's tensor-core tiles
    # (64 rows a block, streamed tiles of 64 or 32) split differently
    check_attention("dead (2,8,2048,64)", 2, 8, s, s, d, torch.bfloat16, True,
                    128, 128, 40, results, p_valid=0.9, dead=True)
    check_attention("(1,4,2048,64) b128x64", 1, 4, s, s, d, torch.bfloat16,
                    True, 128, 64, 41, results)
    check_attention("(1,4,1024,128)", 1, 4, 1024, 1024, 128, torch.bfloat16,
                    True, 128, 128, 42, results)
    check_attention("f16 (1,4,2048,64)", 1, 4, s, s, d, torch.float16, True,
                    128, 128, 43, results)
    # a head width that is not a multiple of 8: staged element by element
    check_attention("d45 100x100 b32x32", 1, 2, 100, 100, 45, torch.bfloat16,
                    True, 32, 32, 44, results)
    check_deterministic(ops_, results)
    train_shapes = check_train_shapes(results)

    # times at the training shape (the kernels over 20 batches of 10)
    heavy = dict(warmup=2, reps=5, inner=3)
    row = time_attention(ops_, (b, h, s, s, d), True, results, timing={},
                         heavy=heavy)
    timed = {name: row[name]
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    timed["library_note"] = ("F.scaled_dot_product_attention(is_causal=True)"
                             " on (4,32,2048,64) bf16: forward, and its "
                             "backward (dQ, dK, dV together) for both "
                             "backward rows")
    sdpa = F.scaled_dot_product_attention
    # the forward at zamba2-7b's oracle shape, where its shared attention
    # runs (head_dim 112 in the kernel's 128 columns)
    zb, zh, zsq, zsk, zd = ZAMBA_ATT
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        q, k, v, kv_valid, _ = _att_inputs(zb, zh, zsq, zsk, zd, dtype, 36,
                                           p_valid=1.0)
        qz, kz, vz, kvz, zbq, zbk = att._prepare(q, k, v, kv_valid, 128, 128)
        zgeom = dict(causal=True, bq=zbq, bk=zbk)
        bnd, by = att_bound("flash_fwd", zb, zh, zsq, zd,
                            q.element_size(), short)
        timed[f"flash_fwd_zamba2_{short}"] = {
            "shape": list(ZAMBA_ATT), "blocks": [zbq, zbk],
            "ms": time_ms(lambda: att.flash_fwd(qz, kz, vz, kvz, **zgeom)),
            "plain_ms": time_ms(lambda: att.flash_fwd_plain(
                qz, kz, vz, kvz, **zgeom), **heavy),
            "library_ms": time_ms(lambda: sdpa(q, k, v, is_causal=True)),
            "bound_ms": bnd, "bound_by": by}
    timed["train_shapes"] = train_shapes
    emit("attention", shape=list(TRAIN_ATT), dtype="bfloat16", causal=True,
         blocks=row["blocks"], n_checks=len(results),
         checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 5 (and 11): serve a model at full width through the degrade ladder
# ---------------------------------------------------------------------------


def make_requests(cfg, rng, n, max_new, spread=0):
    """``n`` requests of 32-128 prompt tokens; request ``i`` asks for
    ``max_new - spread * (7 - i % 8)`` new tokens."""
    reqs = []
    for i in range(n):
        plen = int(rng.randint(32, 129))
        reqs.append(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=plen).astype(np.int32),
            max_new_tokens=max_new - spread * (7 - i % 8)))
    return reqs


def phase_serve(cfg, params, slots=8, n_requests=16, phase="serve",
                max_new=32, spread=0):
    """Serve ``n_requests`` of 32-128 prompt tokens and ``max_new`` new
    tokens on ``slots`` slots through the degrade ladder (pressure 2 ->
    int8 head, then 1 -> bf16), after a warm-up on a throw-away engine; the
    matmul counts are set to 0 right before the path and returned right
    after. With ``spread``, the requests ask for 2 ... ``max_new`` tokens
    in steps of ``spread`` (see :func:`make_requests`), so that the last
    ones finish one by one and the pressure falls below 1: the model's own
    precision (rung ``fp32``) then serves too, and must."""
    # warm-up on a throw-away engine held at the int8 rung: first-call costs
    # (library handles, allocator growth) stay out of the timed run
    warm = ServingEngine(cfg, params, slots=slots, max_seq=512, device=DEV,
                         degrade=DegradeLadder(bf16_at=0.0, int8_at=0.0))
    for r in make_requests(cfg, np.random.RandomState(1), 2, 4):
        warm.submit(r)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    engine = ServingEngine(cfg, params, slots=slots, max_seq=512, device=DEV,
                           degrade=DegradeLadder(bf16_at=1.0, int8_at=2.0))
    reqs = make_requests(cfg, np.random.RandomState(0), n_requests, max_new,
                         spread)
    mm.reset_launches()            # the serving path starts here
    t0 = time.perf_counter()
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mm.LAUNCHES)   # read right after the serving path

    assert all(r.state == State.DONE for r in reqs), \
        [(r.uid, r.state.value, r.finish_reason) for r in reqs]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert not engine.events, engine.events
    assert not any(key.startswith("I_") for key in engine.counters)
    n_int8 = engine.counters["degraded_steps_int8"]
    assert n_int8 > 0 and engine.counters["degraded_steps_bf16"] > 0, \
        dict(engine.counters)
    assert launches["matmul_int8"] == n_int8, (launches, n_int8)
    if spread:
        assert "decode_fp32" in engine.timers, dict(engine.timers)
    for key, t in engine.cache.items():
        if key != "lengths":
            assert bool(torch.isfinite(t).all()), key

    new_tokens = sum(len(r.out_tokens) for r in reqs)
    decode = {k[len("decode_"):]: {"steps": c, "mean_ms": 1e3 * s / c}
              for k, (c, s) in engine.timers.items()
              if k.startswith("decode_")}
    prefill = {int(k[len("prefill_"):]): 1e3 * s / c
               for k, (c, s) in engine.timers.items()
               if k.startswith("prefill_")}
    steps = [(c, s) for k, (c, s) in engine.timers.items()
             if k.startswith("decode_")]
    emit(phase, arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         compute_dtype=cfg.compute_dtype,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         param_bytes=tree_size_bytes(params),
         cache_bytes=tree_size_bytes(engine.cache), slots=slots, max_seq=512,
         requests=len(reqs), new_tokens=new_tokens, wall_s=wall,
         tokens_per_s=new_tokens / wall, ticks=engine.tick,
         decode_steps=decode,
         decode_steps_per_s=sum(c for c, _ in steps) / sum(
             s for _, s in steps),
         prefill_ms_by_prompt_len=dict(sorted(prefill.items())),
         counters=dict(engine.counters),
         matmul_int8_launches=launches["matmul_int8"],
         head_route=ops.lm_head_route(slots, cfg.d_model, cfg.vocab_size,
                                      "int8", device=DEV),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


# ---------------------------------------------------------------------------
# phase 6: float32 against the full-forward oracle; the bf16 head route
# ---------------------------------------------------------------------------


@torch.inference_mode()
def oracle_tokens(cfg, params, prompt, n):
    """Greedy continuation by repeated full forward (no KV cache)."""
    toks = [int(t) for t in prompt]
    for _ in range(n):
        lg, _, _ = forward(cfg, params, torch.tensor([toks], device=DEV,
                                                     dtype=torch.int32))
        toks.append(int(torch.argmax(lg[0, -1])))
    return toks[len(prompt):]


EXACT_LAYERS = 4
DEPTHS = (1, 2, 4, 8, 16, 22)      # where the rounding drift is read
FP64_TOL = 1e-3                    # cached step against full forward, float64
WITNESS_FACTOR = 8.0               # cached fp32 error over the oracle's own
WITNESS_SLACK = 1e-5


def _cut(cfg, params, n_layers, dtype):
    """The first ``n_layers`` layers of the model, computing in ``dtype``."""
    return (dataclasses.replace(cfg, compute_dtype=dtype, n_layers=n_layers),
            dict(params, layers=tree_map(lambda a: a[:n_layers],
                                         params["layers"])))


def _cached_and_full(cfg, params, prompt, nxt=None):
    """Last-position logits over the same tokens, from the cached path and
    from the full forward: (prefill, full), (one decode step, full), and
    the token that was decoded: ``nxt`` (1,1), or the prefill's best."""
    dt = params["embed"].dtype
    toks = torch.tensor(prompt[None, :], device=DEV, dtype=torch.int32)
    cache = init_cache(cfg, 1, 512, cache_dtype=dt, device=DEV)
    lg_p, _, cache = forward(cfg, params, toks, cache=cache)
    full_p, _, _ = forward(cfg, params, toks)
    if nxt is None:
        nxt = torch.argmax(lg_p[:, -1:], dim=-1).to(torch.int32)
    lg_d, _, cache = forward(cfg, params, nxt, cache=cache)
    full_d, _, _ = forward(cfg, params, torch.cat([toks, nxt], dim=1))
    for lg in (lg_p, lg_d, full_p, full_d):
        assert lg.dtype == dt and torch.isfinite(lg).all()
    return (lg_p[0, -1], full_p[0, -1]), (lg_d[0, -1], full_d[0, -1]), nxt


def _gap(a, b):
    return float((a.double() - b.double()).abs().max())


def _greedy_cached(cfg, params, prompt, n):
    """Greedy continuation through the KV cache: prefill, then n-1 steps."""
    toks = torch.tensor(prompt[None, :], device=DEV, dtype=torch.int32)
    cache = init_cache(cfg, 1, 512, cache_dtype=params["embed"].dtype,
                       device=DEV)
    out = []
    for _ in range(n):
        lg, _, cache = forward(cfg, params, toks, cache=cache)
        toks = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        out.append(int(toks))
    return out


def full_depth_witness(cfg, params, prompts):
    """The cached decode path at full width and FULL depth, with float64 as
    the witness.

    A randomly initialised stack is chaotic: a rounding difference grows by
    orders of magnitude on the way up (``drift`` lines show it by depth), so
    that in float32 the cached step and the full forward, one function in
    two summation orders, end up further apart at 22 layers than the two
    best tokens are. The comparison that holds is made in float64, where the
    same code leaves room for that growth: cached and full logits within
    FP64_TOL and greedy tokens equal, at every depth up to the full one.
    The float32 runs are then held to the float64 full forward at every
    depth: the cached step may be no further from it than WITNESS_FACTOR
    times the float32 full forward is, the oracle's own rounding error
    (plus WITNESS_SLACK, a few float32 steps of the largest logit)."""
    params64 = tree_map(lambda a: a.double(), params)
    by_depth = []
    for n in DEPTHS:
        c32, p32 = _cut(cfg, params, n, "float32")
        c64, p64 = _cut(cfg, params64, n, "float64")
        (pc64, pf64), (dc64, df64), nxt = _cached_and_full(c64, p64,
                                                           prompts[0])
        # float32 decodes the token float64 chose: the same inputs throughout
        (pc32, pf32), (dc32, df32), _ = _cached_and_full(c32, p32, prompts[0],
                                                         nxt)
        row = {"n_layers": n,
               "fp32_cached_vs_full": [_gap(pc32, pf32), _gap(dc32, df32)],
               "fp64_cached_vs_full": [_gap(pc64, pf64), _gap(dc64, df64)],
               "fp32_full_vs_fp64": [_gap(pf32, pf64), _gap(df32, df64)],
               "fp32_cached_vs_fp64": [_gap(pc32, pf64), _gap(dc32, df64)],
               "logit_max": float(pf64.abs().max()),
               "top2_gap": float(torch.topk(df64, 2).values.diff().abs())}
        by_depth.append(row)
        emit("drift", **row)
    for row in by_depth:
        assert max(row["fp64_cached_vs_full"]) < FP64_TOL, row
        for cached, oracle in zip(row["fp32_cached_vs_fp64"],
                                  row["fp32_full_vs_fp64"]):
            assert cached <= WITNESS_FACTOR * oracle + WITNESS_SLACK, row
    assert by_depth[-1]["n_layers"] == cfg.n_layers
    c64, p64 = _cut(cfg, params64, cfg.n_layers, "float64")
    for prompt in prompts:
        got = _greedy_cached(c64, p64, prompt, 8)
        want = oracle_tokens(c64, p64, prompt, 8)
        assert got == want, (got, want)
    return by_depth


def _attention_layers(cfg, n_layers):
    """Attention blocks one forward of the first ``n_layers`` layers runs:
    every layer of the dense family, the shared block after each whole group
    of ``attn_every`` Mamba2 layers of the hybrid family, none in the ssm
    family."""
    return {"dense": n_layers, "moe": n_layers, "ssm": 0,
            "hybrid": n_layers // max(cfg.attn_every, 1)}[cfg.family]


@torch.inference_mode()
def phase_serve_exact(cfg, params, n_layers=EXACT_LAYERS, full_depth=True,
                      phase="serve_exact"):
    """float32 at full width, depth cut to ``n_layers``. The engine's tokens
    are held to the greedy full-forward oracle, where float32 rounding
    cannot yet flip a token, and the cached path's logits to within 1e-3 of
    the full forward's. The oracle's full forward runs its attention through
    ``flash_fwd``: that count is set to 0 right before the oracle and
    returned, read right after it. With ``full_depth``, the cached path at
    full depth is held by :func:`full_depth_witness` and the bf16
    logits-head route is checked."""
    cfg32, cut = _cut(cfg, params, n_layers, "float32")
    engine = ServingEngine(cfg32, cut, slots=8, max_seq=512, degrade=None,
                           device=DEV)
    reqs = make_requests(cfg32, np.random.RandomState(2), 2, 8)
    for r in reqs:
        assert engine.submit(r) is None
    engine.run_to_completion()
    assert all(r.state == State.DONE for r in reqs)
    assert engine.counters["degraded_steps"] == 0 and not engine.events
    del engine
    att.reset_launches()           # the oracle's path starts here
    for r in reqs:
        want = oracle_tokens(cfg32, cut, r.prompt, 8)
        assert r.out_tokens == want, (cfg.name, r.uid, r.out_tokens, want)
    flash = att.LAUNCHES["flash_fwd"]    # read right after the oracle
    # 8 full forwards per request
    assert flash == 2 * 8 * _attention_layers(cfg, n_layers), flash

    # logits of the cached steps against the full forward's last position
    (pc, pf), (dc, df), _ = _cached_and_full(cfg32, cut, reqs[0].prompt)
    err_prefill, err_decode = _gap(pc, pf), _gap(dc, df)
    assert err_prefill < 1e-3 and err_decode < 1e-3, (err_prefill, err_decode)
    fields = dict(arch=cfg.name, n_layers=n_layers, requests=len(reqs),
                  new_tokens=16, tokens_equal_oracle=True,
                  logits_err_prefill=err_prefill,
                  logits_err_decode=err_decode, logits_tol=1e-3,
                  flash_fwd_launches=flash, head_dim=cfg.resolved_head_dim)
    if not full_depth:
        emit(phase, **fields)
        return flash
    by_depth = full_depth_witness(cfg, params, [r.prompt for r in reqs])
    assert mm.LAUNCHES["matmul"] == 0     # float32 serving launches no kernel

    # the public bf16 logits-head route, which goes through `matmul`
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=DEV)
    w = params["unembed"]
    before = mm.LAUNCHES["matmul"]
    out = ops.lm_head(x, w, compute_dtype="bfloat16")
    ref = torch.einsum("bsd,dv->bsv", x, w)
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert out.dtype == torch.float32 and out.shape == (8, 1, cfg.vocab_size)
    assert rel < 0.05, rel
    assert mm.LAUNCHES["matmul"] == before + 1, mm.LAUNCHES
    emit(phase, **fields, full_depth_layers=cfg.n_layers,
         fp64_tol=FP64_TOL, witness_factor=WITNESS_FACTOR,
         witness_slack=WITNESS_SLACK,
         fp64_tokens_equal_oracle=True,
         fp64_cached_vs_full=by_depth[-1]["fp64_cached_vs_full"],
         fp32_cached_vs_full=by_depth[-1]["fp32_cached_vs_full"],
         lm_head_bf16_route=ops.lm_head_route(8, cfg.d_model, cfg.vocab_size,
                                              "bfloat16"),
         lm_head_bf16_rel_err=rel, lm_head_bf16_tol=0.05,
         matmul_launches=mm.LAUNCHES["matmul"])
    return flash


# ---------------------------------------------------------------------------
# phase 7: train tinyllama-1.1b at full width and depth
# ---------------------------------------------------------------------------


TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048   # TinyLlama's context length


def _train_cfgs():
    """The model as configured (fp32 parameters, bf16 compute, full remat,
    attention route "auto" = the kernels on the card) and the optimizer as
    ``launch/train.py`` builds it for this many steps."""
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat, cfg.attn_flash) \
        == ("float32", "bfloat16", "full", "auto"), cfg
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1),
                          decay_steps=TRAIN_STEPS)
    return cfg, opt


def phase_train(att_timed):
    cfg, opt = _train_cfgs()
    L = cfg.n_layers
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                         device=DEV)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step_fn = make_train_step(cfg, opt).step_fn
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device(source.batch(i), DEV) for i in range(TRAIN_STEPS)]
    probe = {"embed": params["embed"][:4, :8].clone(),
             "wq": params["layers"]["attn"]["wq"][L - 1, :8, 0, :8].clone()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    att.reset_launches()           # the training path starts here
    rows, per_step = [], []
    for i, batch in enumerate(batches):
        before = dict(att.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        counts = {k: att.LAUNCHES[k] - before[k] for k in att.LAUNCHES}
        per_step.append(counts)
        rows.append({"step": i + 1, "ms": ms, **m, "launches": counts})
        emit("train_step", **rows[-1])
    launches = dict(att.LAUNCHES)  # read right after the training path
    peak = torch.cuda.max_memory_allocated()

    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    for counts in per_step:
        assert counts == want, (counts, want)
    for r in rows:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]), r
        assert r["grad_norm"] > 0, r
        lr = float(adamw.schedule(opt, r["step"]))
        assert r["lr"] == lr, (r["lr"], lr)
    assert abs(rows[0]["loss"] - np.log(cfg.vocab_size)) < 1.0, rows[0]
    assert len({r["loss"] for r in rows}) == len(rows), rows
    p = state["params"]
    assert not torch.equal(p["embed"][:4, :8], probe["embed"])
    assert not torch.equal(p["layers"]["attn"]["wq"][L - 1, :8, 0, :8],
                           probe["wq"])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))

    steady = [r["ms"] for r in rows[1:]]    # the first step is the warm-up
    step_ms = statistics.mean(steady)
    kernel_ms = sum(want[k] * att_timed[k]["ms"] for k in want)
    RECORD["train"] = {"losses": [r["loss"] for r in rows],
                       "steady_step_ms": step_ms,
                       "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                       / (step_ms / 1e3), "peak_gb": peak / 1e9}
    emit("train", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         remat=cfg.remat, losses=[r["loss"] for r in rows],
         step_ms=[r["ms"] for r in rows], steady_step_ms=step_ms,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         launches_per_step=want, launches_total=launches,
         attention_kernels_ms_per_step=kernel_ms,
         attention_kernels_share=kernel_ms / step_ms,
         max_memory_allocated=peak)
    return launches


# ---------------------------------------------------------------------------
# phase 8: one train step, kernel route against the route forced off
# ---------------------------------------------------------------------------


FP32_LOSS_TOL = 1e-5   # fp32, 2 layers: summation order only
FP32_GRAD_TOL = 1e-4   # ... of max|grad| of each parameter
# float64 at the configured init: the reference's init law takes the fan-in
# of a (d, heads, head_dim) projection from the heads axis (wk, wv std 0.5,
# wq 0.18, wo 0.125, where 1/sqrt(2048) = 0.022 would be the model width's),
# so the random stack is chaotic: the serving witness (phase serve_exact)
# reads 6e-4 between two summation orders of the float64 forward at 22
# layers, and the gradient norm at init is ~1e16. The loss is held to the
# witness's own limit (FP64_TOL) at every depth; the gradients only at 2
# layers, where float64 still resolves them; deeper, their gap is printed.
FP64_GRAD_TOL = 1e-9
TRAIN_DEPTHS = (2, 8, 22)
# float64 at full depth with the attention projections rescaled to the
# model width's fan-in (1/sqrt(2048)), a stack that is not chaotic: loss
# and gradients must then agree as float64 rounding allows, with ~1e10
# room for amplification over 22 layers
CONDITIONED_TOL = 1e-6


def _loss_and_grads(cfg, params, batch, flash):
    cfg = dataclasses.replace(cfg, attn_flash=flash)
    before = dict(att.LAUNCHES)
    (loss, _), grads = value_and_grad(
        lambda p, b: lm_loss(cfg, p, b))(params, batch)
    torch.cuda.synchronize()
    return loss, grads, {k: att.LAUNCHES[k] - before[k] for k in before}


def _route_gap(cfg, params, batch):
    """Loss and gradients on the kernel route ("auto" on the card) and on
    the route forced off; the kernel route's launch counts are exactly
    :func:`train_launches`.
    Returns the loss gap and the largest gradient gap as a share of
    max|grad| of its parameter."""
    l_on, g_on, n_on = _loss_and_grads(cfg, params, batch, "auto")
    l_off, g_off, n_off = _loss_and_grads(cfg, params, batch, "off")
    L = cfg.n_layers
    assert n_on == train_launches(cfg), (n_on, train_launches(cfg))
    assert not any(n_off.values()), n_off
    worst = 0.0
    for a, b_ in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert a.dtype == b_.dtype and bool(torch.isfinite(a).all())
        scale = float(b_.abs().max())
        worst = max(worst, float((a - b_).abs().max()) / max(scale, 1e-30))
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in tree_leaves(g_off))))
    return {"n_layers": L, "loss": float(l_on),
            "loss_gap": abs(float(l_on) - float(l_off)),
            "grad_gap_of_max": worst, "grad_norm": gnorm}


def _bf16_route_gap(cfg, params, batch):
    """The largest gradient gap, as a share of its leaf's largest entry,
    of the kernel route in bfloat16 compute from the float32 route forced
    off, on the same float32 parameters: what a lower-precision route
    reads."""
    c16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _, g16, _ = _loss_and_grads(c16, params, batch, "auto")
    _, g32, _ = _loss_and_grads(cfg, params, batch, "off")
    return {"grad_gap_of_max": max(
        float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
        for a, b_ in zip(tree_leaves(g16), tree_leaves(g32)))}


def _conditioned(params, cfg):
    """The same parameters with the projections of every GQA attention
    block (a dict holding wq, wk, wv and wo: self, cross, shared, encoder
    and MTP layers) rescaled to the model width's fan-in, 1/sqrt(d_model),
    instead of the init law's 1/sqrt(heads) (wq, wk, wv) and
    1/sqrt(head_dim) (wo); every other leaf as it was."""
    d = cfg.d_model

    def scaled(k, w):
        if k in ("wq", "wk", "wv"):
            return w * (w.shape[-2] / d) ** 0.5
        return w * (1.0 / w.shape[-3]) ** 0.5 if k == "wo" else w

    def walk(t):
        if not isinstance(t, dict):
            return t
        if {"wq", "wk", "wv", "wo"} <= t.keys():
            return {k: scaled(k, w) for k, w in t.items()}
        return {k: walk(v) for k, v in t.items()}
    return walk(params)


def phase_train_exact():
    cfg, _ = _train_cfgs()
    source = SyntheticLM(DataConfig(seq_len=256, global_batch=2,
                                    vocab_size=cfg.vocab_size, seed=1))
    batch = to_device(source.batch(0), DEV)
    c32 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(1)
    p32 = init_params(model_template(c32), gen, device=DEV)
    fp32 = _route_gap(c32, p32, batch)
    del p32
    assert fp32["loss_gap"] <= FP32_LOSS_TOL, fp32
    assert fp32["grad_gap_of_max"] <= FP32_GRAD_TOL, fp32

    c64 = dataclasses.replace(cfg, param_dtype="float64",
                              compute_dtype="float64")
    p64 = init_params(model_template(c64), gen, dtype="float64", device=DEV)
    short = {k: v[:1, :128] for k, v in batch.items()}
    by_depth = []
    for n in TRAIN_DEPTHS:
        cn, pn = _cut(c64, p64, n, "float64")
        row = _route_gap(cn, pn, short)
        by_depth.append(row)
        emit("train_drift", init="configured", **row)
    cond = _route_gap(c64, _conditioned(p64, c64), short)
    emit("train_drift", init="conditioned", **cond)
    del p64
    for row in by_depth:
        assert row["loss_gap"] <= FP64_TOL, row
    assert by_depth[0]["grad_gap_of_max"] <= FP64_GRAD_TOL, by_depth[0]
    assert by_depth[-1]["n_layers"] == cfg.n_layers
    assert cond["loss_gap"] <= CONDITIONED_TOL, cond
    assert cond["grad_gap_of_max"] <= CONDITIONED_TOL, cond
    emit("train_exact", fp32={"batch": [2, 256], **fp32,
                              "loss_tol": FP32_LOSS_TOL,
                              "grad_tol": FP32_GRAD_TOL},
         fp64_configured=by_depth, fp64_loss_tol=FP64_TOL,
         fp64_grad_tol_2_layers=FP64_GRAD_TOL,
         fp64_conditioned={"batch": [1, 128], **cond,
                           "tol": CONDITIONED_TOL})


# ---------------------------------------------------------------------------
# phase 9: the paper's kernels (axpy, conv2d_direct) against their plain
# versions, on the card
# ---------------------------------------------------------------------------


AXPY_SOURCE = "src/repro_torch/kernels/csrc/axpy.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv.cu"
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
AXPY_N = 1 << 26                   # 768 MB moved in f32, far past the L2
GOOGLENET_L1 = (3, 118, 118, 64, 7, 7)   # (C, H, W, OC, KH, KW), pre-padded
# GoogLeNet's 3x3 convolution (conv2/3x3: 64 -> 192 channels at 56 x 56)
GOOGLENET_3X3 = (64, 58, 58, 192, 3, 3)
# tolerances of a kernel against its plain version, elementwise
# |got - ref| <= rtol * |ref| + atol: float32 at the CPU tests' own
# (tests/test_kernels.py: _tol for axpy, 2e-4 for conv, 3e-4 for the scan),
# a narrow output within one step of its type, float64 within 1e-12 of
# the largest value
AXPY_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (BF16_ULP, 0.0)}
CONV_TOL = (2e-4, 2e-4)
SSM_TOL = (3e-4, 3e-4)
FP64_REL = 1e-12


def _check_close(name, got, ref, rtol, atol, results):
    """The tests' form, |got - ref| <= rtol * |ref| + atol elementwise, on a
    result of the plain version's dtype and shape."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} against "
                             f"{ref.dtype}{tuple(ref.shape)}")
    _check_float(name, got, ref, rtol, results, acc=0.0, atol=atol)


def _check_conv(name, got, ref, x, w, results, tol=CONV_TOL, exact=True):
    """A convolution of x, w against a plain version: the tolerance check,
    the kernel route that ran (``conv.kernel_route``: compile-time taps or
    general) and, where ``exact`` (the plain version on the same operands),
    bit-equality: both sum each output's taps in the order c -> kr -> t
    with the same roundings."""
    _check_close(name, got, ref, *tol, results)
    results[-1]["route"] = cv.kernel_route(x, w)
    if exact and not results[-1]["equal"]:
        raise AssertionError(f"{name}: not bit-equal to the plain version: "
                             f"{results[-1]}")


def _raises_value_error(name, fn, results):
    try:
        fn()
    except ValueError as e:
        results.append({"check": name, "raised": str(e)[:120]})
        return
    raise AssertionError(f"{name}: no ValueError")


def _randn(shape, dtype, seed, scale=1.0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=DEV,
                        dtype=torch.float32) * scale).to(dtype)


def _axpy_tol(dtype, ref):
    if dtype == torch.float64:
        return 0.0, FP64_REL * float(ref.abs().max())
    return AXPY_TOL[dtype]


def _conv_tol(out_dtype, ref):
    if out_dtype == torch.float64:
        return 0.0, FP64_REL * float(ref.abs().max())
    if out_dtype == torch.bfloat16:
        return BF16_ULP, CONV_TOL[1]
    return CONV_TOL


def paper_bound(kind, shape, elt):
    """Least time for one call: the bytes of inputs and outputs once over
    the memory rate, or the operations over the float32 CUDA-core rate
    (these kernels multiply on the CUDA cores in fp32 or fp64; fp64 is
    taken at the fp32 rate, which flatters it). The operations and bytes
    are the kernel's own count (``kernels.axpy.work``,
    ``kernels.conv.work``)."""
    flops, nbytes = ax.work(shape[0], elt) if kind == "axpy" \
        else cv.work(*shape, elt, elt)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAKS_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


AXPY_TURNS = 5


def axpy_turns(xs, ys, alpha=2.5, turns=AXPY_TURNS):
    """``axpy`` and ``torch.add(y, x, alpha=a)`` (a: alpha rounded to x's
    dtype, so both compute one function) timed in alternating turns, the
    kernel first in even turns: {"axpy": [ms, ...], "torch.add": [...]}."""
    a = float(torch.tensor(alpha, dtype=xs.dtype))
    fns = {"axpy": lambda: ax.axpy(alpha, xs, ys),
           "torch.add": lambda: torch.add(ys, xs, alpha=a)}
    out = {name: [] for name in fns}
    for t in range(turns):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            out[name].append(time_ms(fns[name]))
    return out


def phase_paper_kernels():
    """The paper's DAXPY and DCONV through the public kernel API
    (``ops.axpy``, ``ops.conv2d``) — their path: counts set to 0 before it
    and read after it — then every case against the plain version, the
    contract's ValueErrors on CUDA tensors, and the times."""
    results: list = []
    torch.backends.cudnn.allow_tf32 = False   # F.conv2d is timed below
    x32, y32 = _randn((AXPY_N,), torch.float32, 40), \
        _randn((AXPY_N,), torch.float32, 41)
    xg = _randn(GOOGLENET_L1[:3], torch.float32, 42)
    wg = _randn((GOOGLENET_L1[3], GOOGLENET_L1[0]) + GOOGLENET_L1[4:],
                torch.float32, 43, 0.2)
    x64, y64 = _randn((256,), torch.float64, 44), _randn((256,),
                                                          torch.float64, 45)
    bf16 = Policy(compute_dtype="bfloat16")
    # the path: the paper's kernels as a user calls them
    ax.reset_launches()
    cv.reset_launches()
    path = {
        "daxpy_f64_256": ops.axpy(2.5, x64, y64),
        "axpy_f32_2^26": ops.axpy(2.5, x32, y32),
        "dconv_f32": ops.conv2d(xg, wg),
        "dconv_bf16_to_f32": ops.conv2d(xg, wg, policy=bf16,
                                        out_dtype=torch.float32),
    }
    torch.cuda.synchronize()
    launches = {"axpy": ax.LAUNCHES["axpy"],
                "conv2d_direct": cv.LAUNCHES["conv2d_direct"]}
    assert launches == {"axpy": 2, "conv2d_direct": 2}, launches
    ref = ax.axpy_plain(2.5, x64, y64)
    _check_close("path daxpy f64 256", path["daxpy_f64_256"], ref,
                 *_axpy_tol(torch.float64, ref), results)
    _check_close("path axpy f32 2^26", path["axpy_f32_2^26"],
                 ax.axpy_plain(2.5, x32, y32), *AXPY_TOL[torch.float32],
                 results)
    ref = cv.conv2d_plain(xg, wg)
    _check_conv("path dconv f32 googlenet1", path["dconv_f32"], ref, xg, wg,
                results)
    _check_conv("path dconv f32 vs fp64", path["dconv_f32"],
                cv.conv2d_plain(xg.double(), wg.double()).float(), xg, wg,
                results, exact=False)
    ref = cv.conv2d_plain(xg.bfloat16(), wg.bfloat16(),
                          out_dtype=torch.float32)
    _check_conv("path dconv bf16->f32 googlenet1",
                path["dconv_bf16_to_f32"], ref, xg.bfloat16(), wg.bfloat16(),
                results)
    del path

    # axpy: sizes, dtypes, lmul, an address that is not 16-byte aligned
    for i, (n, dt, block, lmul, offset) in enumerate((
            (AXPY_N, torch.bfloat16, 64 * 1024, 1, 0),
            (1 << 20, torch.float32, 64 * 1024, 1, 0),
            (256, torch.float64, 64 * 1024, 1, 0),
            (4096, torch.float32, 512, 8, 0),
            (1000, torch.float32, 8, 1, 1),
            (1000, torch.bfloat16, 8, 1, 3),
            (12345, torch.float16, 5, 1, 0))):
        xs = _randn((n + offset,), dt, 50 + i)[offset:]
        ys = _randn((n + offset,), dt, 60 + i)[offset:]
        got = ax.axpy(-1.75, xs, ys, block=block, lmul=lmul)
        ref = ax.axpy_plain(-1.75, xs, ys)
        tol = (F16_ULP, 0.0) if dt == torch.float16 else _axpy_tol(dt, ref)
        short = str(dt).replace("torch.", "")
        _check_close(f"axpy {short} n={n} lmul={lmul} offset={offset}", got,
                     ref, *tol, results)
    # conv: GoogLeNet layer 1 in float64 and to a bf16 output; the CPU
    # tests' shapes and GoogLeNet's 3x3 layer (both kernel routes)
    for dt, out_dt in ((torch.float64, None), (torch.bfloat16, None)):
        got = cv.conv2d_direct(xg.to(dt), wg.to(dt), out_dtype=out_dt)
        ref = cv.conv2d_plain(xg.to(dt), wg.to(dt), out_dtype=out_dt)
        short = str(dt).replace("torch.", "")
        _check_conv(f"conv {short} googlenet1", got, ref, xg.to(dt),
                    wg.to(dt), results, tol=_conv_tol(ref.dtype, ref))
    for i, (c, h, w, oc, kh_, kw_) in enumerate(((1, 8, 16, 2, 3, 3),
                                                (3, 12, 20, 4, 7, 7),
                                                (3, 10, 118, 8, 7, 7),
                                                (5, 9, 33, 3, 2, 5),
                                                GOOGLENET_3X3)):
        xr = _randn((c, h, w), torch.float32, 70 + i)
        wr = _randn((oc, c, kh_, kw_), torch.float32, 80 + i, 0.2)
        _check_conv(f"conv f32 {(c, h, w, oc, kh_, kw_)}",
                    cv.conv2d_direct(xr, wr), cv.conv2d_plain(xr, wr), xr,
                    wr, results)
    # 3x3 at many channels, pre-padded (ResNet's last stage at 7x7, VGG's
    # 512 channels at 14x14): the taps route's staging does not fit a block,
    # the general kernel runs them (float64 at 512 x 16 x 16 fits neither)
    for i, (c, h, w, dt) in enumerate(((512, 9, 9, torch.float32),
                                       (512, 16, 16, torch.float32),
                                       (512, 9, 9, torch.float64),
                                       (256, 16, 16, torch.float64))):
        xr = _randn((c, h, w), dt, 100 + i)
        wr = _randn((c, c, 3, 3), dt, 110 + i, 0.05)
        short = str(dt).replace("torch.", "")
        ref = cv.conv2d_plain(xr, wr)
        _check_conv(f"conv {short} {(c, h, w, c, 3, 3)}",
                    cv.conv2d_direct(xr, wr), ref, xr, wr, results,
                    tol=_conv_tol(dt, ref))
        if results[-1]["route"] != "general":
            raise AssertionError(f"{results[-1]['check']}: route "
                                 f"{results[-1]['route']}, not general")
    routes = {r["route"] for r in results if "route" in r}
    if routes != {"taps", "general"}:
        raise AssertionError(f"conv routes exercised: {routes}")
    _raises_value_error("conv channels disagree", lambda: ops.conv2d(
        xg, wg[:, :2].contiguous()), results)
    # 256 channels of 3 rows of width 512 exceed the block's shared memory
    _raises_value_error("conv input rows beyond shared memory",
                        lambda: ops.conv2d(
                            torch.zeros((256, 3, 512), device=DEV),
                            torch.zeros((1, 256, 3, 3), device=DEV)),
                        results)
    _raises_value_error("axpy n not a multiple of block", lambda: ops.axpy(
        1.0, x64[:100], y64[:100], block=64), results)
    torch.cuda.synchronize()

    # times
    timed = {}
    heavy = dict(warmup=2, reps=5, inner=3)
    for key, xs, ys in (("f32_2^26", x32, y32),
                        ("bf16_2^26", x32.bfloat16(), y32.bfloat16()),
                        ("f32_2^20", x32[:1 << 20], y32[:1 << 20]),
                        ("f64_256", x64, y64)):
        bnd, by = paper_bound("axpy", xs.shape, xs.element_size())
        turns = axpy_turns(xs, ys)
        timed[f"axpy_{key}"] = {
            "ms": statistics.median(turns["axpy"]),
            "plain_ms": time_ms(lambda: ax.axpy_plain(2.5, xs, ys)),
            "library_ms": statistics.median(turns["torch.add"]),
            "bound_ms": bnd, "bound_by": by, "turns": turns}
    for key, dt, kw in (("f32", torch.float32, {}),
                        ("bf16_to_f32", torch.bfloat16,
                         {"out_dtype": torch.float32}),
                        ("f64", torch.float64, {})):
        xs, ws = xg.to(dt), wg.to(dt)
        bnd, by = paper_bound("conv", GOOGLENET_L1, xs.element_size())
        lib_x, lib_w = xs[None].to(kw.get("out_dtype", dt)), \
            ws.to(kw.get("out_dtype", dt))
        timed[f"conv_googlenet1_{key}"] = {
            "ms": time_ms(lambda: cv.conv2d_direct(xs, ws, **kw)),
            "plain_ms": time_ms(lambda: cv.conv2d_plain(xs, ws, **kw),
                                **heavy),
            "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                lib_x, lib_w)),
            "bound_ms": bnd, "bound_by": by,
            "route": cv.kernel_route(xs, ws)}
    c, h, w, oc, kh_, kw_ = GOOGLENET_3X3
    xs, ws = _randn((c, h, w), torch.float32, 90), \
        _randn((oc, c, kh_, kw_), torch.float32, 91, 0.05)
    bnd, by = paper_bound("conv", GOOGLENET_3X3, 4)
    timed["conv_googlenet_3x3_f32"] = {
        "shape": list(GOOGLENET_3X3),
        "ms": time_ms(lambda: cv.conv2d_direct(xs, ws)),
        "plain_ms": time_ms(lambda: cv.conv2d_plain(xs, ws), **heavy),
        "library_ms": time_ms(lambda: torch.nn.functional.conv2d(xs[None],
                                                                 ws)),
        "bound_ms": bnd, "bound_by": by, "route": cv.kernel_route(xs, ws)}
    timed["library_note"] = ("axpy: torch.add(y, x, alpha=a); conv: "
                             "F.conv2d on (1,C,H,W) with cuDNN TF32 off "
                             "(bf16 row: on the same values in f32)")
    emit("paper_kernels", launches=launches, n_checks=len(results),
         checks=results, timed=timed,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return results, timed, launches


# ---------------------------------------------------------------------------
# phase 10: the scan kernel against its plain version and the model's
# chunked_linear_attention, at the SSM layers' shapes
# ---------------------------------------------------------------------------


def _ssm_layer_shapes():
    """(name, BH, S, N, P, chunk) of one layer of each served SSM model at
    batch 4 and 2048 tokens, from its config: zamba2-7b's Mamba2 heads
    (d_inner / head_dim, state N, head_dim P) and xlstm-1.3b's mLSTM heads
    (d_qk / heads, d_inner / heads + the ones column)."""
    z, x = get_config("zamba2-7b"), get_config("xlstm-1.3b")
    zd = z.ssm.expansion * z.d_model
    xd = x.ssm.expansion * x.d_model
    xqk = int(xd * x.ssm.qk_dim_factor)
    return (("zamba2-7b", 4 * (zd // z.ssm.head_dim), 2048, z.ssm.state_dim,
             z.ssm.head_dim, z.ssm.chunk_size),
            ("xlstm-1.3b", 4 * x.n_heads, 2048, xqk // x.n_heads,
             xd // x.n_heads + 1, x.ssm.chunk_size))


def _ssm_inputs(bh, s, n, p, dtype, seed):
    """The CPU tests' statistics: q, v ~ N(0,1), k ~ 0.3 N(0,1),
    log_decay in (-0.5, 0], scale in [0, 1); log_decay and scale float32."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((bh, s, n), generator=gen, device=DEV).to(dtype)
    k = (torch.randn((bh, s, n), generator=gen, device=DEV) * 0.3).to(dtype)
    v = torch.randn((bh, s, p), generator=gen, device=DEV).to(dtype)
    ld = -torch.rand((bh, s), generator=gen, device=DEV) * 0.5
    sc = torch.rand((bh, s), generator=gen, device=DEV)
    return q, k, v, ld, sc


def _as_model(t, b, h):
    """(B*H, S, ...) -> (B, S, H, ...), the model's layout."""
    return t.reshape((b, h) + t.shape[1:]).transpose(1, 2)


def ssm_bound(bh, s, n, p, chunk, elt):
    """Least time for one call: inputs and output once over the memory
    rate, or the products the causal chunked form needs over the float32
    CUDA-core rate (the reference does every product in fp32): per (bh,
    chunk of c) q.k^T and w.v over the c(c+1)/2 causal pairs, q.state and
    the state update over c x N x P, 2 operations a multiply-add: the
    kernel's own count, ``kernels.ssm_scan.work``."""
    flops, nbytes = ss.work(bh, s, n, p, chunk, elt)
    t_ops = flops / PEAKS_FLOPS["float32"]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_ssm_kernel():
    results: list = []
    layers = _ssm_layer_shapes()
    f32_inputs = {}
    # the path: ops.ssm_scan at both layers' shapes, float32 and bfloat16
    ss.reset_launches()
    outs = {}
    for name, bh, s, n, p, chunk in layers:
        for dt in (torch.float32, torch.bfloat16):
            args = _ssm_inputs(bh, s, n, p, dt, 90)
            if dt == torch.float32:
                f32_inputs[name] = args
            outs[(name, dt)] = (ops.ssm_scan(*args, chunk=chunk), args)
    torch.cuda.synchronize()
    launches = {"ssm_scan": ss.LAUNCHES["ssm_scan"]}
    assert launches["ssm_scan"] == 2 * len(layers), launches
    for (name, dt), (got, args) in outs.items():
        bh, s, n, p, chunk = next(row[1:] for row in layers
                                  if row[0] == name)
        short = str(dt).replace("torch.", "")
        tag = f"{name} ({bh},{s},{n},{p}) c{chunk} {short}"
        ref = ss.ssm_scan_plain(*args, chunk=chunk)
        if dt == torch.float32:
            _check_close(f"ssm_scan {tag}", got, ref, *SSM_TOL, results)
            # the model's core on the same numbers, in its (B,S,H,.) layout
            b, h = 4, bh // 4
            y_model, _ = chunked_linear_attention(
                *(_as_model(t, b, h) for t in args), chunk=chunk)
            y_model = y_model.transpose(1, 2).reshape(bh, s, p)
            _check_close(f"ssm_scan vs chunked_linear_attention {tag}", got,
                         y_model.contiguous(), *SSM_TOL, results)
        else:
            _check_close(f"ssm_scan {tag}", got, ref, BF16_ULP, 1e-5
                         * float(ref.float().abs().max()), results)
    del outs
    # the kernel_bench shape, S equal to the chunk, S below the default
    # chunk, ragged N and P, float64
    for i, (bh, s, n, p, chunk, dt) in enumerate((
            (8, 4096, 64, 64, 128, torch.float32),
            (6, 256, 64, 64, 256, torch.float32),
            (5, 100, 40, 70, 128, torch.float32),
            (3, 96, 33, 65, 32, torch.float32),
            (2, 32, 8, 8, 8, torch.float32),
            (4, 512, 64, 130, 128, torch.float64),
            (2, 256, 512, 33, 128, torch.float64))):
        args = _ssm_inputs(bh, s, n, p, dt, 100 + i)
        got = ss.ssm_scan(*args, chunk=chunk)
        ref = ss.ssm_scan_plain(*args, chunk=chunk)
        tol = SSM_TOL if dt == torch.float32 \
            else (0.0, FP64_REL * float(ref.abs().max()))
        short = str(dt).replace("torch.", "")
        _check_close(f"ssm_scan ({bh},{s},{n},{p}) c{chunk} {short}", got,
                     ref, *tol, results)
    args = _ssm_inputs(2, 300, 8, 8, torch.float32, 120)
    _raises_value_error("ssm_scan S % chunk != 0", lambda: ops.ssm_scan(
        *args, chunk=128), results)
    # shared memory: a state of N 2048 at chunk 256 is staged in slices, so
    # it runs; so does a chunk of 1024 where P fits one column tile (the
    # scores stream a tile of keys at a time); where P spans several tiles,
    # the scores of all the chunk's keys stay resident, and a chunk of 1024
    # exceeds the block
    for i, (bh, s, n, p, chunk) in enumerate(((1, 256, 2048, 8, 256),
                                              (1, 1024, 8, 8, 1024))):
        args = _ssm_inputs(bh, s, n, p, torch.float32, 121 + i)
        _check_close(f"ssm_scan ({bh},{s},{n},{p}) c{chunk} float32",
                     ss.ssm_scan(*args, chunk=chunk),
                     ss.ssm_scan_plain(*args, chunk=chunk), *SSM_TOL, results)
    args = _ssm_inputs(1, 1024, 8, 72, torch.float32, 123)
    _raises_value_error("ssm_scan chunk beyond shared memory",
                        lambda: ops.ssm_scan(*args, chunk=1024), results)
    torch.cuda.synchronize()

    timed = {}
    heavy = dict(warmup=1, reps=5, inner=2)
    for name, bh, s, n, p, chunk in layers:
        for dt in (torch.float32, torch.bfloat16):
            args = f32_inputs[name] if dt == torch.float32 \
                else _ssm_inputs(bh, s, n, p, dt, 90)
            key = name if dt == torch.float32 else f"{name} bfloat16"
            bnd, by = ssm_bound(bh, s, n, p, chunk, args[0].element_size())
            timed[key] = {
                "shape": [bh, s, n, p], "chunk": chunk,
                "dtype": str(dt).replace("torch.", ""),
                "ms": time_ms(lambda: ss.ssm_scan(*args, chunk=chunk),
                              **heavy),
                "plain_ms": time_ms(lambda: ss.ssm_scan_plain(
                    *args, chunk=chunk), **heavy),
                "library_ms": None, "bound_ms": bnd, "bound_by": by}
    timed["library_note"] = ("null: no single PyTorch call computes the "
                             "chunked decayed linear attention")
    emit("ssm_kernel", launches=launches, n_checks=len(results),
         checks=results, timed=timed)
    return results, timed, launches


# ---------------------------------------------------------------------------
# phases 11-12: serve zamba2-7b and xlstm-1.3b at full width
# ---------------------------------------------------------------------------


# (arch, slots, requests): 16 requests over 8 slots and 4 over 2 both start
# at pressure 2 (int8 head) and end at 1 (bf16 compute)
SSM_SERVE = (("zamba2-7b", 8, 16), ("xlstm-1.3b", 2, 4))
SSM_EXACT_LAYERS = {"zamba2-7b": 7, "xlstm-1.3b": 4}


def run_ssm_serving():
    """Both SSM-family models at full width: serve, then the exact check on
    the same random parameters; each tree is freed before the next."""
    out = {}
    for arch, slots, n_requests in SSM_SERVE:
        # what earlier phases still hold: nothing of any size
        emit("serve_ssm_start", arch=arch,
             memory_allocated=torch.cuda.memory_allocated())
        cfg = get_config(arch)
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = init_params(model_template(cfg), gen, device=DEV)
        launches = phase_serve(cfg, params, slots, n_requests, "serve_ssm")
        # zamba2-7b: one group of 6 Mamba2 layers, the shared block and one
        # tail layer; xlstm-1.3b: 4 layers
        flash = phase_serve_exact(cfg, params, SSM_EXACT_LAYERS[arch],
                                  full_depth=False, phase="serve_ssm_exact")
        out[arch] = {"matmul_int8": launches["matmul_int8"],
                     "flash_fwd": flash}
        del params
        free_memory()
    return out


# ---------------------------------------------------------------------------
# phases 15-18: the mixture-of-experts, MLA, vision and encoder-decoder
# families at full width
# ---------------------------------------------------------------------------

MOE_EXACT_LAYERS = 2
EXACT_CAPACITY = 8.0      # no token dropped: cached and full forwards agree
CROSS_GATE = 0.5          # the reference initialises the gate to zero
# (batch, heads, Sq, Sk, head_dim) of the cross layers in phase 18: the
# vision model's 1600 patch embeddings, the audio encoder's 512 frames; Sq
# is the prompt in a prefill and 1 in a decode step
CROSS_ATT = {VISION_ARCH: (2, 32, 128, 1600, 128),
             AUDIO_ARCH: (2, 16, 128, 512, 64)}


def with_capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def run_moe_serving(cfg):
    """Phases 15-16, granite-moe-3b-a800m at full width and depth in
    float32 (``cfg``): serve through all three rungs of the ladder, then
    the exact check at 2 layers with capacity factor 8.0 (no drops, so the
    cached path and the full forward route alike), on one random tree."""
    emit("serve_moe_start", arch=cfg.name,
         memory_allocated=torch.cuda.memory_allocated())
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=DEV)
    launches = phase_serve(cfg, params, 8, 16, "serve_moe", spread=2)
    flash = phase_serve_exact(with_capacity(cfg, EXACT_CAPACITY), params,
                              MOE_EXACT_LAYERS, full_depth=False,
                              phase="serve_moe_exact")
    del params
    free_memory()
    return {"matmul_int8": launches["matmul_int8"], "flash_fwd": flash}


def _logit_gap(a, b):
    """max |a - b| over max |b|, in float64."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def check_mla_triangular(cfg, s_len, results):
    """``_mla_triangular`` (two q blocks of 1024 when S = 2048) against one
    ``mla_chunked`` call over all keys, on the same bf16 inputs at the
    model's widths: the same online softmax, another split of the rows."""
    m = cfg.mla
    gen = torch.Generator(device=DEV).manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(
            torch.bfloat16)
    qn = rnd(1, s_len, cfg.n_heads, m.qk_nope_head_dim)
    qr = rnd(1, s_len, cfg.n_heads, m.qk_rope_head_dim)
    ckv, ckr = rnd(1, s_len, m.kv_lora_rank), rnd(1, s_len,
                                                 m.qk_rope_head_dim)
    wkv = rnd(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim,
              scale=m.kv_lora_rank ** -0.5)
    pos = torch.arange(s_len, device=DEV, dtype=torch.int32)[None, :]
    tri = attn_mod._mla_triangular(cfg, qn, qr, ckv, ckr, wkv, pos)
    whole = attn_mod.mla_chunked(
        cfg, qn, qr, ckv, ckr, wkv, pos,
        torch.ones((1, s_len), dtype=torch.bool, device=DEV))
    _check_float(f"mla _mla_triangular vs mla_chunked S={s_len} bfloat16",
                 tri, whole, BF16_ULP, results, BF16_ULP / 2)


@torch.inference_mode()
def phase_serve_mla(cfg, params, prompt=64, steps=4, tri_len=2048):
    """Phase 17, deepseek-v3-671b at full width, 1 dense + 1 MoE layer,
    bf16 parameters and compute (``cfg``, capacity factor 8.0 where a
    cached path is held to the full forward): the serve steps' prefill and
    the absorbed decode against the no-cache forward, with float32 compute
    as the witness (as :func:`full_depth_witness`: the bf16 cached logits
    no further from float32's than WITNESS_FACTOR times bf16's own full
    forward, plus 1e-3 of the largest logit); a from-zero prefill of
    ``tri_len`` tokens that fills its cache (the triangular q-block loop in
    both layers) against the same prompt without the hint, within the
    witness's largest gap; ``_mla_triangular`` against ``mla_chunked`` at
    S = ``tri_len``; ``lm_loss`` with its MTP term, finite; then the engine
    at 8 slots through the ladder (the int8 head at (8,7168)@(7168,129280)).
    Returns the launches of each path."""
    results, gaps = [], {}
    exact = with_capacity(cfg, EXACT_CAPACITY)
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen,
                         device=DEV, dtype=torch.int32)
    t0 = time.perf_counter()
    lg, cache = make_prefill_step(exact, None, prompt + steps)(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    assert cache["c_kv"].shape == (1, 2, prompt + steps,
                                   cfg.mla.kv_lora_rank)
    decode = make_decode_step(exact)
    cached, seq, decode_s = [lg], toks, 0.0
    for _ in range(steps):
        nxt = torch.argmax(cached[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, {"tokens": nxt})
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        cached.append(lg)
    # the no-cache forward over the whole sequence gives every prefix's
    # last logits (causal, and no token dropped at capacity factor 8); in
    # float32 compute it is the witness of bf16's own rounding
    full, _, _ = forward(exact, params, seq)
    full32, _, _ = forward(dataclasses.replace(exact, compute_dtype="float32"),
                           params, seq)
    gaps.update(cached_vs_full32=[], full_vs_full32=[])
    for i, lg in enumerate(cached):
        at = prompt - 1 + i
        assert torch.isfinite(lg).all() and torch.isfinite(full[:, at]).all()
        gaps["cached_vs_full32"].append(_logit_gap(lg, full32[:, at]))
        gaps["full_vs_full32"].append(_logit_gap(full[:, at], full32[:, at]))
    for cached_gap, oracle_gap in zip(gaps["cached_vs_full32"],
                                      gaps["full_vs_full32"]):
        assert cached_gap <= WITNESS_FACTOR * oracle_gap + 1e-3, gaps
    del full, full32

    long = torch.randint(0, cfg.vocab_size, (1, tri_len), generator=gen,
                         device=DEV, dtype=torch.int32)
    calls = []
    tri = attn_mod._mla_triangular
    attn_mod._mla_triangular = lambda *a, **k: calls.append(1) or tri(*a, **k)
    try:
        t0 = time.perf_counter()
        hinted, _ = make_prefill_step(exact, None, tri_len)(
            params, {"tokens": long})
        torch.cuda.synchronize()
        hint_ms = 1e3 * (time.perf_counter() - t0)
        assert len(calls) == cfg.n_layers, calls      # every MLA layer
        cache = init_cache(exact, 1, tri_len, device=DEV)
        plain, _, _ = forward(exact, params, long, cache=cache)  # no hint
        plain = plain[:, -1]
        assert len(calls) == cfg.n_layers, calls      # mla_chunked only
    finally:
        attn_mod._mla_triangular = tri
    # the same arithmetic per query row, split into other row blocks, where
    # a rounding may fall the other way: held to what all of bf16's
    # roundings move the logits by (the witness above), plus the slack
    gaps["hint_vs_no_hint"] = _logit_gap(hinted, plain)
    hint_tol = max(gaps["full_vs_full32"]) + 1e-3
    assert gaps["hint_vs_no_hint"] <= hint_tol, gaps
    check_mla_triangular(cfg, tri_len, results)
    free_memory()

    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    att.reset_launches()             # the loss's path starts here
    total, metrics = lm_loss(cfg, params, batch)
    loss_flash = att.LAUNCHES["flash_fwd"]       # read right after it
    assert loss_flash == 1, att.LAUNCHES          # the MTP layer's GQA
    for key in ("ce", "aux", "mtp"):
        assert bool(torch.isfinite(metrics[key])), metrics
    emit("serve_mla", arch=cfg.name, n_layers=cfg.n_layers,
         n_dense_layers=cfg.moe.n_dense_layers, compute_dtype=cfg.compute_dtype,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         param_bytes=tree_size_bytes(params), prompt=prompt, steps=steps,
         prefill_ms=prefill_ms, decode_ms=1e3 * decode_s / steps,
         from_zero_prefill_len=tri_len, from_zero_prefill_ms=hint_ms,
         triangular_calls=len(calls), rel_gaps=gaps,
         witness_factor=WITNESS_FACTOR, hint_rel_tol=hint_tol,
         loss={k: float(v) for k, v in metrics.items()},
         loss_total=float(total), loss_flash_fwd_launches=loss_flash,
         checks=results,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    launches = phase_serve(cfg, params, 8, 16, "serve_mla_engine", max_new=8)
    return {"matmul_int8": launches["matmul_int8"], "flash_fwd": loss_flash}


def run_mla_serving(cfg):
    emit("serve_mla_start", arch=cfg.name,
         memory_allocated=torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen,
                         dtype=torch_dtype(cfg.param_dtype), device=DEV)
    emit("serve_mla_params", param_bytes=tree_size_bytes(params),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    out = phase_serve_mla(cfg, params)
    del params
    free_memory()
    return out


def check_cross_kernel(arch, results):
    """The forward kernel in its non-causal mode at ``arch``'s cross shape,
    against its plain version: bf16 and f32 with every memory row valid
    (as the model calls it), bf16 with some invalid and batch 0 dead, at
    Sq = prompt and Sq = 1 (one-row query blocks); then the times of the
    bf16 calls beside the plain version and F.scaled_dot_product_attention
    on the same operands."""
    b, h, sq, sk, d = CROSS_ATT[arch]
    timed = {}
    for i, rows in enumerate((sq, 1)):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            f = check_attention_fwd(f"cross {arch} ({b},{h},{rows},{sk},{d})",
                                    b, h, rows, sk, d, dtype, False, 128, 128,
                                    60 + 4 * i + j, results, p_valid=1.0)
            if dtype == torch.bfloat16:
                kw = dict(zip(("qf", "kf", "vf", "kvm"),
                              (f[n] for n in ("qf", "kf", "vf", "kvm"))))
                bnd, by = att_bound("flash_fwd", b, h, rows, d, 2, sk=sk,
                                    causal=False)
                timed[f"sq{rows}"] = {
                    "shape": [b, h, rows, sk, d], "dtype": "bfloat16",
                    "causal": False, "blocks": [f["geom"]["bq"],
                                                f["geom"]["bk"]],
                    "max_abs_err": float((f["out"].double()
                                          - f["p_out"].double()).abs().max()),
                    "ms": time_ms(lambda: att.flash_fwd(**kw, **f["geom"])),
                    "plain_ms": time_ms(lambda: att.flash_fwd_plain(
                        **kw, **f["geom"]), warmup=2, reps=5, inner=3),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        f["q"], f["k"], f["v"])),
                    "bound_ms": bnd, "bound_by": by}
        check_attention_fwd(f"cross {arch} dead ({b},{h},{rows},{sk},{d})",
                            b, h, rows, sk, d, torch.bfloat16, False, 128,
                            128, 70 + i, results, p_valid=0.9, dead=True)
    torch.cuda.synchronize()
    return timed


def _cross_layers(cfg):
    """Cross-attention calls in one forward: the vision model's cross
    blocks, every decoder layer of the encoder-decoder model."""
    return cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" \
        else cfg.n_layers


@torch.inference_mode()
def serve_cross_steps(cfg, params, prompt=128, steps=4, tol=None):
    """The serve steps of one frontend model: ``make_prefill_step`` into a
    cache of ``prompt + steps`` rows, then ``steps`` greedy
    ``make_decode_step`` calls, the frontend in every batch, each step's
    logits against the no-cache forward's at that position (held within
    ``tol`` where given, else only printed). The cross layers run through
    the kernel's non-causal mode: its launches are counted from 0 right
    before the steps and read right after them. Returns (launches, fields
    to print)."""
    dt = params["embed"].dtype
    b = CROSS_ATT[cfg.name][0]
    gen = torch.Generator(device=DEV).manual_seed(4)
    fe = torch.randn((b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
                     generator=gen, device=DEV, dtype=torch.float32).to(dt)
    toks = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                         device=DEV, dtype=torch.int32)
    prefill = make_prefill_step(cfg, None, prompt + steps, cache_dtype=dt)
    decode = make_decode_step(cfg)
    att.reset_launches()           # the serving path starts here
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": toks, "frontend_emb": fe})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cached, seq, decode_s = [lg], toks, 0.0
    for _ in range(steps):
        nxt = torch.argmax(cached[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, {"tokens": nxt, "frontend_emb": fe})
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        cached.append(lg)
    flash = att.LAUNCHES["flash_fwd"]     # read right after the path
    assert flash == _cross_layers(cfg) * (1 + steps), (flash, cfg.name)
    full, _, _ = forward(cfg, params, seq, frontend_emb=fe)
    gaps, tokens_equal = [], True
    for i, lg in enumerate(cached):
        at = prompt - 1 + i
        assert lg.dtype == dt and torch.isfinite(lg).all()
        gaps.append(_gap(lg, full[:, at]))
        tokens_equal &= bool(torch.equal(torch.argmax(lg, -1),
                                         torch.argmax(full[:, at], -1)))
    if tol is not None:
        assert max(gaps) < tol, (cfg.name, cfg.compute_dtype, gaps)
    return flash, {"compute_dtype": cfg.compute_dtype, "batch": b,
                   "prompt": prompt, "steps": steps, "prefill_ms": prefill_ms,
                   "decode_ms": 1e3 * decode_s / steps, "logits_err": gaps,
                   "logits_tol": tol, "logit_max": float(full.abs().max()),
                   "greedy_tokens_equal": tokens_equal,
                   "flash_fwd_launches": flash}


# where serve_cross holds float32 (4 layers or fewer: the random stack is
# chaotic deeper): one self layer and its cross layer; one encoder and one
# decoder layer. Cached logits against the full forward's within
# CROSS_FP32_TOL of the largest logit (serve_exact holds the dense model to
# 1e-3 absolute; the vision cut's prefill reads 1.9e-3 absolute, and at
# 2 + 2 layers the audio model's 9.6e-3 of 3.79: the init law's attention
# projections amplify float32 rounding from the first layers on).
CROSS_FP32_CUT = {VISION_ARCH: (("n_layers", 1), ("cross_attn_every", 1)),
                  AUDIO_ARCH: (("n_layers", 1), ("n_encoder_layers", 1))}
CROSS_FP32_TOL = 1e-3


def _cut_stacks(cfg, params):
    """The first layers of each stacked tree that ``cfg``'s depths keep."""
    keep = {"layers": cfg.n_layers,
            "cross_layers": cfg.n_layers // max(cfg.cross_attn_every, 1),
            "enc_layers": cfg.n_encoder_layers}
    return {k: tree_map(lambda a, n=keep[k]: a[:n], v) if k in keep else v
            for k, v in params.items()}


def phase_serve_cross(cfg, params):
    """Phase 18 for one frontend model at full width (``params`` float32):
    the forward kernel against its plain version at the model's cross
    shape (:func:`check_cross_kernel`); the serve steps in float64 held to
    the no-cache forward within FP64_TOL; the same steps in float32 and in
    bfloat16 (the configured compute, timed), their gaps printed: the
    random stack is chaotic (see :func:`full_depth_witness`), so that in
    float32 one summation order against another moves the vision model's
    logits by far more than 1e-3; and float32 held within CROSS_FP32_TOL
    at the depth CROSS_FP32_CUT keeps. Returns ({run: launches}, checks,
    times)."""
    results = []
    timed = check_cross_kernel(cfg.name, results)
    launches, runs = {}, {}
    for dtype, tol in (("float64", FP64_TOL), ("float32", None),
                       ("bfloat16", None)):
        run_cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        cast = tree_map(lambda a: a.to(torch_dtype(dtype)), params)
        launches[dtype], runs[dtype] = serve_cross_steps(run_cfg, cast,
                                                         tol=tol)
        del cast
        free_memory()
    cut_cfg = dataclasses.replace(_replace(cfg, CROSS_FP32_CUT[cfg.name]),
                                  compute_dtype="float32")
    held = "float32, " + ", ".join(f"{k} {v}"
                                   for k, v in CROSS_FP32_CUT[cfg.name])
    launches[held], runs[held] = serve_cross_steps(
        cut_cfg, _cut_stacks(cut_cfg, params))
    runs[held].update(cut=dict(CROSS_FP32_CUT[cfg.name]),
                      logits_rel_tol=CROSS_FP32_TOL)
    emit("serve_cross", arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, n_encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model,
         param_count=sum(t.numel() for t in tree_leaves(params)),
         cross_gate=(float(params["cross_layers"]["attn"]["gate"][0])
                     if "cross_layers" in params else None),
         runs=runs, n_checks=len(results), checks=results, timed=timed,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    held = runs[held]
    assert max(held["logits_err"]) <= CROSS_FP32_TOL * held["logit_max"], \
        held
    return launches, results, timed


def serving_cfgs():
    """The configurations of phases 15-18, at full width:
    granite-moe-3b-a800m at full depth in float32; deepseek-v3-671b cut to
    1 dense + 1 MoE layer (and its MTP module), bf16 as configured;
    llama-3.2-vision-11b cut to one group (5 self layers and a cross
    layer); seamless-m4t-medium at full depth (12 + 12 layers)."""
    ds = get_config(MLA_ARCH)
    vision = get_config(VISION_ARCH)
    return {
        MOE_ARCH: dataclasses.replace(get_config(MOE_ARCH),
                                      compute_dtype="float32"),
        MLA_ARCH: dataclasses.replace(
            ds, n_layers=2, moe=dataclasses.replace(ds.moe,
                                                    n_dense_layers=1)),
        VISION_ARCH: dataclasses.replace(vision,
                                         n_layers=vision.cross_attn_every),
        AUDIO_ARCH: get_config(AUDIO_ARCH)}


def run_cross_serving(cfgs):
    """Phase 18 for each config of ``cfgs``, each tree freed before the
    next; float32 parameters from seed 0, the vision model's gate set to
    CROSS_GATE."""
    out = {}
    for cfg in cfgs:
        emit("serve_cross_start", arch=cfg.name,
             memory_allocated=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = init_params(model_template(cfg), gen, device=DEV)
        if "cross_layers" in params:
            params["cross_layers"]["attn"]["gate"].fill_(CROSS_GATE)
        out[cfg.name] = phase_serve_cross(cfg, params)
        del params
        free_memory()
    return out


# ---------------------------------------------------------------------------
# phase 13: the Ara vector engine (no CUDA kernel of its own)
# ---------------------------------------------------------------------------

ENGINE_GRID_N = 20          # programs per SEW x LMUL cell: 420 a dtype
ENGINE_CHECK_N = 64         # Listing-1 held bit for bit to the CPU run
ENGINE_N = 256              # Listing-1 at the paper's marquee size ...
ENGINE_LANES = 16           # ... on 16 lanes' VLMAX (1024 DP elements)
ENGINE_REL = 1e-12          # against numpy's A @ B + C (another order)


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (any NaN matches any NaN: CPU and card
    may spell a generated NaN differently)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ua, ub = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    if a.dtype.kind == "f":
        return bool(np.all((ua == ub) | (np.isnan(a) & np.isnan(b))))
    return bool(np.array_equal(ua, ub))


def _engine_results_equal(card, cpu):
    """``run_many`` results of two engines, bit for bit."""
    (m1, s1), (m2, s2) = card, cpu
    return len(m1) == len(m2) and all(
        _same_bits(a, b) for a, b in zip(m1, m2)) and all(
        _same_bits(np.array([x[k] for k in sorted(x)]),
                   np.array([y[k] for k in sorted(y)]))
        for x, y in zip(s1, s2))


def _engine_grid(dtype, device, results):
    """The 21-cell SEW x LMUL grid (integer cells only for int32 storage):
    the engine on ``device`` against the numpy oracle at ``diff.TOL``
    (float storage) and against the same engine on the CPU at tol=0."""
    cfg = AraConfig(lanes=2)
    card = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                           device=device)
    cpu = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                          device="cpu")
    win = diff.grid_window(diff.VLMAX64)
    cells = [c for c in diff.cells(ENGINE_GRID_N)
             if dtype != torch.int32 or c[0] in isa.INT_SEWS]
    ran, clock = [], [0.0]

    def card_batch(progs, mems, srs):
        t0 = time.perf_counter()
        out = card.run_many(progs, mems, srs, window=win)
        clock[0] += time.perf_counter() - t0
        ran.append((progs, mems, srs, out))
        return out

    name = str(dtype).replace("torch.", "")
    if dtype == torch.int32:
        # the oracle keeps a float scalar file where int32 storage
        # truncates it on entry, so int32 is held to the CPU run alone
        for sew, lmul, seeds in cells:
            batch = [diff.random_program(np.random.RandomState(seed), sew,
                                         lmul) for seed in seeds]
            card_batch([b[0] for b in batch], [b[1] for b in batch],
                       [dict(b[2]) for b in batch])
        checked = sum(len(r[0]) for r in ran)
    else:
        storage = np.float64 if dtype == torch.float64 else np.float32
        checked = diff.run_cells(
            card_batch, diff.oracle_batch(diff.VLMAX64, storage=storage),
            cells, label=f"vector_engine {name} vs oracle")
    t0 = time.perf_counter()
    same = all(_engine_results_equal(
        out, cpu.run_many(progs, mems, srs, window=win))
        for progs, mems, srs, out in ran)
    cpu_s = time.perf_counter() - t0
    if not same:
        raise AssertionError(f"vector_engine grid {name}: the card's "
                             "results differ from the CPU run's")
    rows = sum(len(staging.encode_program(p, diff.VLMAX64))
               for progs, *_ in ran for p in progs)
    results.append({"name": f"grid {name}", "programs": checked,
                    "cells": len(cells), "oracle": dtype != torch.int32,
                    "bit_equal_to_cpu": same})
    return {"programs": checked, "rows": rows, "card_s": clock[0],
            "programs_per_s": checked / clock[0],
            "rows_per_s": rows / clock[0], "cpu_s": cpu_s}


def _listing1(n, cfg, seed):
    rng = np.random.RandomState(seed)
    a, b, c = rng.randn(n, n), rng.randn(n, n), rng.randn(n, n)
    mem = np.concatenate([a.ravel(), b.ravel(), c.ravel()])
    prog = isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                              vlmax=cfg.vlmax_dp)
    return prog, mem, a @ b + c


def _graph_break_even(cfg, prog, mem, device):
    """One program run with CUDA graphs and then eagerly on one runner
    (bit-equal): the capture seconds a graph, the seconds a replayed group
    saves against its eager branch, and their ratio, the repeats a group
    shape needs in one call before its capture pays."""
    eng = ReferenceEngine(cfg, cache=staging.TraceCache(), device=device)
    eng.run(prog, mem)                                  # build, warm up
    runner, = eng.cache._fns.values()
    inner, stat = runner._graphs, {"graphs": 0, "replays": 0, "s": 0.0}

    def timed_graphs(c, groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs = inner(c, groups)
        torch.cuda.synchronize()
        stat["s"] += time.perf_counter() - t0
        stat["graphs"] += len(graphs)
        stat["replays"] += sum((key, end - start, nf) in graphs
                               for _, start, end, key, nf in groups)
        return graphs

    runner._graphs = timed_graphs
    t0 = time.perf_counter()
    replayed = eng.run(prog, mem)
    graph_s = time.perf_counter() - t0
    runner.graphs = False
    t0 = time.perf_counter()
    eager = eng.run(prog, mem)
    eager_s = time.perf_counter() - t0
    if not _engine_results_equal(([replayed[0]], [replayed[1]]),
                                 ([eager[0]], [eager[1]])):
        raise AssertionError("vector_engine: replayed graphs differ from "
                             "the eager run")
    capture = stat["s"] / stat["graphs"]
    saved = (eager_s - (graph_s - stat["s"])) / stat["replays"]
    return {"rows": len(prog), "graphs": stat["graphs"],
            "replays": stat["replays"], "graph_s": graph_s,
            "eager_s": eager_s, "capture_ms_per_graph": 1e3 * capture,
            "saved_ms_per_replay": 1e3 * saved,
            "break_even_repeats": capture / saved,
            "min_repeats": staging.GRAPH_MIN_REPEATS}


def phase_vector_engine(smi, device=DEV):
    """Phase 13: the staged ReferenceEngine on the card (float64 storage
    unless named): the grid in float32, float64 and int32; Listing-1 at
    n = 64 bit-equal to the CPU run; Listing-1 at n = 256 on 16 lanes'
    VLMAX against numpy, timed, with its scoreboard cycles; a batch mixing
    Listing-1 and grid programs bit-equal to the CPU run; the demo's
    masked argmax. Wall seconds on the host clock (each call ends in the
    one copy of its results to the host). Returns (results, timed, the
    n = 256 program and its scoreboard cycles, for phase 14)."""
    results, timed = [], {}
    for dtype in (torch.float32, torch.float64, torch.int32):
        timed[f"grid_{str(dtype).replace('torch.', '')}"] = _engine_grid(
            dtype, device, results)

    cfg = AraConfig(lanes=4)
    prog, mem, _ = _listing1(ENGINE_CHECK_N, cfg, 1)
    t0 = time.perf_counter()
    card = ReferenceEngine(cfg, device=device).run(prog, mem)
    card_s = time.perf_counter() - t0
    cpu = ReferenceEngine(cfg, device="cpu").run(prog, mem)
    if not (_same_bits(card[0], cpu[0])
            and _engine_results_equal(([card[0]], [card[1]]),
                                      ([cpu[0]], [cpu[1]]))):
        raise AssertionError("vector_engine Listing-1 n=64: the card's "
                             "result differs from the CPU run's")
    results.append({"name": f"listing1 n={ENGINE_CHECK_N} lanes=4",
                    "bit_equal_to_cpu": True})
    timed["listing1_64"] = {"rows": len(prog), "card_s": card_s,
                            "rows_per_s": len(prog) / card_s}
    timed["graph_break_even"] = _graph_break_even(cfg, prog, mem, device)

    # one batch of three Listing-1 programs beside three grid programs:
    # the rows the three share recur as groups of 3 (replayed graphs)
    # while the grid programs run beside them
    cfg = AraConfig(lanes=2)
    batch = [_listing1(16, cfg, seed) for seed in range(3)]
    refs = [b[2] for b in batch]
    batch += [diff.random_program(np.random.RandomState(seed), sew, 2,
                                  vlmax64=cfg.vlmax_dp)
              for seed, sew in ((0, 32), (1, 16), (2, 64))]
    progs, mems = [b[0] for b in batch], [b[1] for b in batch]
    srs = [{0: 0.5}] * len(batch)
    got = ReferenceEngine(cfg, device=device).run_many(progs, mems, srs)
    if not _engine_results_equal(got, ReferenceEngine(
            cfg, device="cpu").run_many(progs, mems, srs)):
        raise AssertionError("vector_engine mixed batch: the card's results "
                             "differ from the CPU run's")
    for out, ref in zip(got[0], refs):
        err = np.abs(out[2 * 256:].reshape(16, 16) - ref).max()
        if not err <= ENGINE_REL * np.abs(ref).max():
            raise AssertionError(f"vector_engine mixed batch: Listing-1 "
                                 f"error {err:.3e}")
    results.append({"name": "mixed batch: 3 x listing1 n=16, 3 grid programs",
                    "bit_equal_to_cpu": True})

    cfg = AraConfig(lanes=ENGINE_LANES)
    n = ENGINE_N
    prog, mem, ref = _listing1(n, cfg, 0)
    t0 = time.perf_counter()
    staging.pack_tables([staging.encode_program(prog, cfg.vlmax_dp)])
    encode_s = time.perf_counter() - t0      # the host's share of the run
    eng = ReferenceEngine(cfg, device=device)
    t0 = time.perf_counter()
    out, _ = eng.run(prog, mem)
    wall = time.perf_counter() - t0
    err = float(np.abs(out[2 * n * n:].reshape(n, n) - ref).max()
                / np.abs(ref).max())
    if not err <= ENGINE_REL:
        raise AssertionError(f"vector_engine Listing-1 n={n}: error "
                             f"{err:.3e} relative to max |A B + C| "
                             f"exceeds {ENGINE_REL}")
    tr = simulate_timing(prog, cfg)
    results.append({"name": f"listing1 n={n} lanes={ENGINE_LANES}",
                    "max_rel_err": err})
    timed["listing1_256"] = {
        "n": n, "lanes": ENGINE_LANES, "vlmax": cfg.vlmax_dp,
        "rows": len(prog), "wall_s": wall, "rows_per_s": len(prog) / wall,
        "encode_s": encode_s,
        "max_rel_err": err, "scoreboard_cycles": tr.cycles,
        "closed_form_cycles": pm.matmul_cycles(cfg, n),
        "unit_busy": tr.unit_busy}

    vl = 32
    rng = np.random.RandomState(0)
    vals = rng.randn(vl)
    vals[vl // 3] = vals[2 * vl // 3] = vals.max() + 1.0   # tie
    mem2 = np.zeros(4 * vl + 64)
    mem2[:vl] = vals
    mem2[vl:2 * vl] = np.arange(vl, dtype=float)
    amax = [isa.VSETVL(vl, 32, 1), isa.VLD(4, 0)] \
        + isa.argmax_program(4, vl, sd=0, huge_sreg=1)
    _, s = ReferenceEngine(AraConfig(lanes=4), device=device).run(
        amax, mem2, sregs={1: float(vl + 9)})
    if int(s[0]) != int(np.argmax(vals)):
        raise AssertionError(f"vector_engine argmax {int(s[0])} != "
                             f"numpy's {int(np.argmax(vals))}")
    results.append({"name": f"masked argmax vl={vl}", "argmax": int(s[0])})
    emit("vector_engine", gpu=smi, n_checks=len(results), checks=results,
         timed=timed)
    return results, timed, (prog, tr.cycles)


# ---------------------------------------------------------------------------
# phase 14: the lane-partitioned and clustered Ara engines (no CUDA kernel)
# ---------------------------------------------------------------------------

LANE_GRID_N = 5             # programs per SEW x LMUL cell: 105 a dtype
LANE_TOPOLOGIES = (("lane", 2), ("cluster", 2, 2), ("cluster", 2, 4),
                   ("cluster", 4, 2))
LISTING_TOPOLOGIES = (("lane", 16), ("cluster", 4, 4))
# phase 14's Listing-1 size on those topologies (phase 13 runs the paper's
# n = 256 on the ReferenceEngine: 213,505 rows, ~18 s an engine; 128 is a
# quarter of the rows, the same program shape at 16 lanes' VLMAX)
LANE_LISTING_N = 128


def _topology_name(t):
    return f"lane{t[1]}" if t[0] == "lane" else f"cluster{t[1]}x{t[2]}"


def _lane_engine(topology, cfg, dtype, device, **kw):
    if topology[0] == "lane":
        return LaneEngine(cfg, make_lane_mesh(topology[1]), dtype=dtype,
                          device=device, **kw)
    return ClusterEngine(cfg, topology[1], topology[2], dtype=dtype,
                         device=device, **kw)


def _lanes_grid(dtype, device, results):
    """The grid (integer cells only for int32 storage), one batch a cell
    through the card's ReferenceEngine and each topology on the card and
    on the CPU: every result bit-equal to the ReferenceEngine's and to the
    CPU run's. Card seconds per engine on the host clock."""
    cfg = AraConfig(lanes=2)
    win = diff.grid_window(diff.VLMAX64)
    ref = ReferenceEngine(cfg, vlmax=diff.VLMAX64, dtype=dtype,
                          cache=staging.TraceCache(), device=device)
    engines = {_topology_name(t): tuple(
        _lane_engine(t, cfg, dtype, dev, vlmax=diff.VLMAX64,
                     cache=staging.TraceCache()) for dev in (device, "cpu"))
        for t in LANE_TOPOLOGIES}
    clock = dict.fromkeys(["ref", *engines], 0.0)
    name, programs = str(dtype).replace("torch.", ""), 0
    for sew, lmul, seeds in diff.cells(LANE_GRID_N):
        if dtype == torch.int32 and sew not in isa.INT_SEWS:
            continue
        batch = [diff.random_program(np.random.RandomState(seed), sew, lmul)
                 for seed in seeds]
        args = [b[0] for b in batch], [b[1] for b in batch]
        t0 = time.perf_counter()
        want = ref.run_many(*args, [dict(b[2]) for b in batch], window=win)
        clock["ref"] += time.perf_counter() - t0
        for eng, (card, cpu) in engines.items():
            t0 = time.perf_counter()
            got = card.run_many(*args, [dict(b[2]) for b in batch],
                                window=win)
            clock[eng] += time.perf_counter() - t0
            if not _engine_results_equal(got, want):
                raise AssertionError(
                    f"vector_engine_lanes grid {name} {eng} sew={sew} "
                    f"lmul={lmul}: differs from the ReferenceEngine")
            if not _engine_results_equal(got, cpu.run_many(
                    *args, [dict(b[2]) for b in batch], window=win)):
                raise AssertionError(
                    f"vector_engine_lanes grid {name} {eng} sew={sew} "
                    f"lmul={lmul}: the card differs from the CPU run")
        programs += len(batch)
    out = {"programs": programs,
           "ref_programs_per_s": programs / clock["ref"]}
    for eng, (card, _) in engines.items():
        st = card.cache.stats
        if st.compiles != 1:
            raise AssertionError(f"vector_engine_lanes grid {name} {eng}: "
                                 f"{st.compiles} runners, not one")
        out[eng] = {"programs_per_s": programs / clock[eng],
                    "vs_ref": clock["ref"] / clock[eng],
                    "folds": dict(st.folds),
                    "fold_stages": dict(st.fold_stages)}
        results.append({"name": f"grid {name} {eng}", "programs": programs,
                        "bit_equal_to_reference_and_cpu": True})
    return out


def _load_script(rel):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(
        "_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_vector_engine_lanes(smi, listing, device=DEV):
    """Phase 14: the LaneEngine and ClusterEngine on the card. ``listing``
    is phase 13's Listing-1 program at n = 256 on 16 lanes' VLMAX and its
    scoreboard cycles at one cluster (beside which the scoreboard times it
    at 4); the engines run Listing-1 at ``LANE_LISTING_N``, bit-equal to
    the ReferenceEngine's result there, float64."""
    results, timed = [], {}
    for dtype in (torch.float32, torch.float64, torch.int32):
        timed[f"grid_{str(dtype).replace('torch.', '')}"] = _lanes_grid(
            dtype, device, results)

    cfg, n = AraConfig(lanes=ENGINE_LANES), LANE_LISTING_N
    prog, mem, _ = _listing1(n, cfg, 0)
    want, _ = ReferenceEngine(cfg, device=device).run(prog, mem)
    # the host's encode of a program at this VLMAX is phase 13's
    # ``encode_s`` (the same work): not timed here
    for topology in LISTING_TOPOLOGIES:
        eng = _lane_engine(topology, cfg, torch.float64, device,
                           cache=staging.TraceCache())
        t0 = time.perf_counter()
        out, _ = eng.run(prog, mem)
        wall = time.perf_counter() - t0
        name = _topology_name(topology)
        if not _same_bits(out, want):
            raise AssertionError(f"vector_engine_lanes Listing-1 n={n} "
                                 f"{name}: differs from the ReferenceEngine")
        st = eng.cache.stats
        results.append({"name": f"listing1 n={n} {name}",
                        "bit_equal_to_reference": True})
        timed[f"listing1_{n}_{name}"] = {
            "n": n, "lanes": eng.lanes, "vlmax": eng.vlmax, "rows": len(prog),
            "wall_s": wall, "rows_per_s": len(prog) / wall,
            "folds": dict(st.folds),
            "fold_stages": dict(st.fold_stages)}

    prog256, cycles = listing
    timed["cycles_listing1_256"] = {
        f"clusters_{c}": {"scoreboard": cycles if c == 1 else simulate_timing(
            prog256, cfg, clusters=c).cycles,
            "closed_form": pm.matmul_cycles(cfg, ENGINE_N, clusters=c)}
        for c in (1, 4)}

    scaleout = _load_script("benchmarks/torch_scaleout.py")
    timed["scaleout_verify"] = scaleout.run_verify([(2, 2), (4, 2)],
                                                   device=device)
    results.append({"name": "torch_scaleout --verify 2x2,4x2",
                    "bit_exact": True})
    emit("vector_engine_lanes", gpu=smi, n_checks=len(results),
         checks=results, timed=timed)
    return results, timed


# ---------------------------------------------------------------------------
# phase 19: the serving fault registry on the card, at full width
# ---------------------------------------------------------------------------


def _flip_report(cfg, params, prompt, out):
    """Where ``out`` (an engine's greedy tokens) first leaves the oracle's:
    the oracle's top-2 logit gap at that token beside the gap between the
    cached path's logits and the full forward's over the same prefix."""
    want = faults.oracle(prompt, len(out))
    i = next(j for j, (a, b) in enumerate(zip(out, want)) if a != b)
    prefix = np.concatenate([np.asarray(prompt, np.int32),
                             np.asarray(want[:i], np.int32)])
    if i == 0:
        (cached, full), _, _ = _cached_and_full(cfg, params, prefix)
    else:
        nxt = torch.tensor([[int(prefix[-1])]], device=DEV, dtype=torch.int32)
        _, (cached, full), _ = _cached_and_full(cfg, params, prefix[:-1], nxt)
    return {"index": i, "got": out[i], "want": want[i],
            "top2_gap": float(torch.topk(full.double(), 2).values.diff()
                              .abs()),
            "cached_vs_full": _gap(cached, full)}


@torch.inference_mode()
def phase_serve_faults(cfg, params, n_layers=EXACT_LAYERS):
    """Every class of ``serving.faults.REGISTRY`` through ``verify`` on the
    card: tinyllama-1.1b at full width, depth cut to ``n_layers``, float32,
    where ``serve_exact`` holds the engine's greedy tokens equal to the
    oracle's. Each class must be detected by its code, recovered from with
    the survivors equal to the oracle, and do damage to the legacy engine.
    Where a survivor's token differs from the oracle's, the flip is printed
    (:func:`_flip_report`) and the phase fails. The oracle's full forwards
    run their attention through ``flash_fwd``: that count is set to 0 right
    before the registry and returned, read right after it."""
    cfg32, cut = _cut(cfg, params, n_layers, "float32")
    faults.use_fixture(cfg32, cut)
    mismatches = []
    matches = faults._matches_oracle

    def recording(req):
        ok = matches(req)
        if not ok and req.out_tokens:
            mismatches.append((np.array(req.prompt), list(req.out_tokens)))
        return ok
    faults._matches_oracle = recording
    reports = []
    att.reset_launches()           # the registry's path starts here
    t0 = time.perf_counter()
    try:
        for fault in faults.REGISTRY:
            mismatches.clear()
            t1 = time.perf_counter()
            try:
                rep = faults.verify(fault)
            except AssertionError:
                emit("serve_faults_flip", fault=fault.name,
                     flips=[_flip_report(cfg32, cut, p, o)
                            for p, o in mismatches])
                raise
            rep["seconds"] = time.perf_counter() - t1
            reports.append(rep)
            emit("serve_faults_class", **rep)
    finally:
        faults._matches_oracle = matches
        # drop the installed fixture: its views hold the model's storage
        faults._installed.clear()
        faults._oracle_cached.cache_clear()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flash = att.LAUNCHES["flash_fwd"]    # read right after the registry
    per_forward = _attention_layers(cfg, n_layers)
    assert len(reports) == 10 and flash > 0 and flash % per_forward == 0, \
        (len(reports), flash)
    emit("serve_faults", arch=cfg.name, n_layers=n_layers,
         d_model=cfg.d_model, compute_dtype="float32", classes=len(reports),
         detected_recovered_nonvacuous=[r["name"] for r in reports],
         seconds=seconds, flash_fwd_launches=flash,
         oracle_forwards=flash // per_forward)
    return flash


# ---------------------------------------------------------------------------
# phase 20: the load gate (benchmarks/torch_serving_load.py) on the card
# ---------------------------------------------------------------------------


LOAD = dict(duration=120, rate=0.5, slots=4, max_seq=32, seed=0)


def phase_serving_load(cfg, params):
    """``torch_serving_load.bench`` at the reference's traffic (``LOAD``,
    the degrade ladder armed at 2.0 / 4.0) on tinyllama-1.1b at full width
    and depth in its configured precision. Zero undetected escapes, both
    rungs in the faulted phase, and one ``matmul_int8`` launch per int8
    decode step: that count is set to 0 right before the benchmark and
    returned, read right after it."""
    load = _load_script("benchmarks/torch_serving_load.py")
    mm.reset_launches()            # the load's path starts here
    res = load.bench(**LOAD, fixture=(cfg, params))
    torch.cuda.synchronize()
    launches = dict(mm.LAUNCHES)   # read right after the load
    clean, faulted = res["clean"], res["faulted"]
    assert faulted["undetected_escapes"] == 0, faulted["missing_detections"]
    assert faulted["injections"] > 0, faulted
    assert faulted["degraded_steps_bf16"] > 0, faulted
    assert faulted["degraded_steps_int8"] > 0, faulted
    int8_steps = clean["degraded_steps_int8"] + faulted["degraded_steps_int8"]
    assert launches["matmul_int8"] == int8_steps, (launches, int8_steps)
    assert res["config"]["backend"].startswith(DEV), res["config"]
    for phase in ("clean", "faulted"):
        row = {k: v for k, v in res[phase].items()
               if k != "missing_detections"}
        emit("serving_load", load_phase=phase, **row)
    emit("serving_load_config", arch=cfg.name, n_layers=cfg.n_layers,
         compute_dtype=cfg.compute_dtype, **res["config"],
         matmul_int8_launches=launches["matmul_int8"])
    return launches["matmul_int8"]


# ---------------------------------------------------------------------------
# phase 21: training that checkpoints and resumes, on the card
# ---------------------------------------------------------------------------


RESTART_LAYERS = 1        # its checks do not read depth (2 until PR 32)
RESTART_STEPS, RESTART_AT = 6, 3


def _leaf_gaps(a, b):
    """{leaf path: (bit-equal, max |a - b|)} over two states, the leaves in
    the checkpoint's order."""
    out = {}
    for (path, x), (path_y, y) in zip(ckpt._flatten(a), ckpt._flatten(b)):
        assert path == path_y and x.dtype == y.dtype \
            and x.shape == y.shape, (path, path_y)
        same = torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))
        out["/".join(path)] = (same, 0.0 if same else
                               float((x.double() - y.double()).abs().max()))
    return out


def phase_train_restart():
    """The trainer's checkpoint/restart on the card: tinyllama-1.1b at full
    width, depth cut to ``RESTART_LAYERS``, as configured (fp32
    parameters, bf16 compute, full remat), batch 4 x 2048 of
    ``SyntheticLM``, a learning-rate schedule that does not depend on
    ``steps``. Run A takes ``RESTART_STEPS`` steps straight, saving every
    ``RESTART_AT``; run B stops at ``RESTART_AT`` in a second directory;
    run C asks for ``RESTART_STEPS`` on B's directory and must resume at
    ``RESTART_AT`` and end on A's state bit for bit. A second straight run
    (A2) shows whether a straight run repeats itself on the card: if it
    does not, the leaves where it differs are printed and C is held, leaf
    by leaf, to that measured gap. Then ``ft.elastic.recover`` must return
    A's saved state bit for bit, and a ``save(blocking=False)`` followed by
    one more in-place step must restore the values before that step. The
    attention kernels' counts are set to 0 before run A and returned, read
    after the last step. The checkpoints live in a temporary directory,
    deleted at the end."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=RESTART_LAYERS)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) \
        == ("float32", "bfloat16", "full"), cfg
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=2, decay_steps=60)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)

    def trainer(ckpt_dir, steps):
        return Trainer(cfg, opt, data,
                       TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                     ckpt_every=RESTART_AT, log_every=1),
                       device=DEV)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    dir_a, dir_b, dir_d = (os.path.join(root, n) for n in "abd")
    runs = {}
    try:
        att.reset_launches()       # the restart's path starts here
        for name, d, steps in (("A", dir_a, RESTART_STEPS),
                               ("A2", None, RESTART_STEPS),
                               ("B", dir_b, RESTART_AT)):
            tr = trainer(d, steps)
            t0 = time.perf_counter()
            step, state = tr.run()
            runs[name] = {"tr": tr, "state": state, "step": step,
                          "wall_s": time.perf_counter() - t0}
        del runs["B"]["state"]
        tr_c = trainer(dir_b, RESTART_STEPS)
        start, _ = tr_c.restore_or_init()
        assert start == RESTART_AT, start
        t0 = time.perf_counter()
        step_c, state_c = tr_c.run()
        runs["C"] = {"tr": tr_c, "step": step_c,
                     "wall_s": time.perf_counter() - t0}
        assert step_c == runs["A"]["step"] == RESTART_STEPS
        assert ckpt.latest_steps(dir_a) == [RESTART_AT, RESTART_STEPS]
        assert ckpt.latest_steps(dir_b) == [RESTART_AT, RESTART_STEPS]
        state_a = runs["A"]["state"]
        for r in runs.values():
            assert all(np.isfinite(m["loss"]) for m in r["tr"].metrics_log)

        repeat = _leaf_gaps(runs["A2"].pop("state"), state_a)
        resumed = _leaf_gaps(state_c, state_a)
        del state_c
        straight_repeats = all(same for same, _ in repeat.values())
        if not straight_repeats:
            emit("train_restart_straight_runs_differ",
                 leaves={p: g for p, (same, g) in repeat.items()
                         if not same})
        for path, (same, gap) in resumed.items():
            if straight_repeats:
                assert same, (path, gap)
            else:
                assert gap <= repeat[path][1], (path, gap, repeat[path][1])

        built = []
        step_r, state_r = elastic.recover(dir_a, DEV, lambda: built.append(1))
        assert step_r == RESTART_STEPS and not built
        assert all(same for same, _ in _leaf_gaps(state_r, state_a).values())

        # save without waiting for the disk, then one more in-place step
        batch = to_device(runs["A"]["tr"].source.batch(RESTART_STEPS), DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer = ckpt.save(dir_d, RESTART_STEPS, state_a, blocking=False)
        block_s = time.perf_counter() - t0
        state_a, _ = runs["A"]["tr"].step_fn(state_a, batch)
        torch.cuda.synchronize()
        writer.join()
        write_s = time.perf_counter() - t0
        stepped = _leaf_gaps(state_a, state_r)
        assert not stepped["params/embed"][0], "the step changed nothing"
        _, state_d = ckpt.restore(dir_d, device=DEV)
        assert all(same for same, _ in _leaf_gaps(state_d, state_r).values())
        ckpt_bytes = sum(os.path.getsize(os.path.join(dir_d, s, f))
                         for s in os.listdir(dir_d)
                         for f in os.listdir(os.path.join(dir_d, s)))
        del state_a, state_r, state_d
        torch.cuda.synchronize()
        launches = dict(att.LAUNCHES)   # read right after the last step
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_steps = 2 * RESTART_STEPS + RESTART_AT + (RESTART_STEPS - RESTART_AT) + 1
    L = RESTART_LAYERS
    want = {"flash_fwd": 2 * L * n_steps, "flash_bwd_dq": L * n_steps,
            "flash_bwd_dkv": L * n_steps}
    assert launches == want, (launches, want)
    step_ms = {n: [1e3 * t for t in r["tr"].monitor.times]
               for n, r in runs.items()}
    emit("train_restart", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=RESTART_STEPS,
         resumed_at=RESTART_AT, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat,
         straight_runs_bit_equal=straight_repeats,
         resumed_bit_equal=all(s for s, _ in resumed.values()),
         resumed_max_gap=max(g for _, g in resumed.values()),
         leaves=len(resumed), recover_bit_equal=True,
         nonblocking_save_immune=True,
         losses={n: [m["loss"] for m in r["tr"].metrics_log]
                 for n, r in runs.items()},
         step_ms=step_ms,
         steady_step_ms=statistics.median(
             t for n in ("A", "A2") for t in step_ms[n][1:]),
         run_wall_s={n: r["wall_s"] for n, r in runs.items()},
         save_block_ms=1e3 * block_s, save_write_s=write_s,
         checkpoint_bytes=ckpt_bytes, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phases 22-26: train the other families at full width
# ---------------------------------------------------------------------------


def train_launches(cfg):
    """Launches of each attention kernel in one train step of ``cfg``
    (one forward and backward of ``lm_loss`` without a cache), from the
    code: each attention call of a layer under ``remat="full"`` runs the
    forward twice (again when the backward recomputes the layer) and each
    backward kernel once. The kernel takes the causal self-attention of the
    dense, moe (GQA), vlm and audio decoder layers and of the hybrid
    family's shared block (after each whole group of ``attn_every`` Mamba2
    layers), and the cross layers (non-causal); not MLA, not the mLSTM and
    Mamba2 layers, not the audio encoder (non-causal self-attention, which
    the reference routes through its kernel only when triangular). The MTP
    layer (GQA) runs outside the layer loop, without remat: once each."""
    fam, n = cfg.family, cfg.n_layers
    remat = 2 if cfg.remat == "full" else 1
    layers = {"dense": n, "moe": 0 if cfg.use_mla else n, "ssm": 0,
              "hybrid": n // max(cfg.attn_every, 1),
              "vlm": n + n // max(cfg.cross_attn_every, 1),
              "audio": 2 * n}[fam]
    once = 1 if cfg.mtp_depth else 0
    return {"flash_fwd": remat * layers + once,
            "flash_bwd_dq": layers + once, "flash_bwd_dkv": layers + once}


@dataclasses.dataclass(frozen=True)
class FamilyRun:
    """One family's train phase: the configuration ``arch`` cut by
    ``cut`` (depth, and the routed experts for deepseek-v3), trained on
    ``batch`` sequences of TRAIN_SEQ tokens a step; ``exact`` cuts it for
    the exactness checks (float32 and float64); ``fp64_route``: the float64
    kernel route against the plain route fits the card (else float32 is
    held against float64, the route forced on in both)."""
    phase: str
    arch: str
    cut: tuple
    batch: int
    exact: tuple
    fp64_route: bool = True


def _replace(cfg, cut):
    """``cfg`` with the fields of ``cut`` ((name, value) pairs; "moe."
    names replace fields of ``cfg.moe``)."""
    top = {k: v for k, v in cut if not k.startswith("moe.")}
    moe = {k[4:]: v for k, v in cut if k.startswith("moe.")}
    if moe:
        top["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **top)


FAMILY_STEPS = 3
FAMILY_RUNS = (
    # 16 of 32 layers: the state of all 32 (63 GB) leaves no room for the
    # step's activations
    FamilyRun("train_moe", MOE_ARCH, (("n_layers", 16),), 4,
              (("n_layers", 2),)),
    # 1 dense + 1 MoE layer (MLA) and the MTP module, 32 of 256 routed
    # experts: one MoE layer's 256 experts alone are 11.3 G parameters;
    # 2 x 2048: the triangular MLA loop keeps fp32 scores of 128 heads
    FamilyRun("train_mla", MLA_ARCH,
              (("n_layers", 2), ("moe.n_dense_layers", 1),
               ("moe.n_experts", 32)), 2,
              (("n_layers", 2), ("moe.n_dense_layers", 1),
               ("moe.n_experts", 8)), fp64_route=False),
    # 12 of 81 layers: two groups of 6 Mamba2 layers, each closed by the
    # shared block; the exactness cut is one group (the least depth that
    # reaches the shared block)
    FamilyRun("train_hybrid", "zamba2-7b", (("n_layers", 12),), 4,
              (("n_layers", 6),)),
    FamilyRun("train_ssm", "xlstm-1.3b", (), 4, (("n_layers", 2),),
              fp64_route=False),
    # one group: 5 self layers and the cross layer; the exactness cut is
    # one self layer and its cross layer
    FamilyRun("train_cross", VISION_ARCH, (("n_layers", 5),), 4,
              (("n_layers", 1), ("cross_attn_every", 1))),
    FamilyRun("train_cross", AUDIO_ARCH, (), 4,
              (("n_layers", 1), ("n_encoder_layers", 1))),
)
# the float32 step against float64 (route forced on in both), where no
# float64 kernel route is held (deepseek-v3, xlstm-1.3b): the loss gap as a
# share of the float64 loss, the gradients' as a share of each float64
# leaf's largest entry, at the exactness cut. Measured on the card:
# deepseek-v3 4.4e-7 and 2.6e-3 (its MTP loss alone is ~620 at init),
# xlstm-1.3b 1.2e-7 and 4.2e-4 (the mLSTM normaliser, as in
# tests/test_torch_train_families.py)
PRECISION_LOSS_TOL = 1e-5
PRECISION_GRAD_TOL = 5e-3
# the float32 route gap at the configured init of a stack that the
# conditioned check also holds (all but the mixture-of-experts families,
# which are held to FP32_GRAD_TOL there): the init's attention projections
# amplify rounding (vision, 1 self + 1 cross layer: 3.84e-4 of a leaf's
# largest gradient, the same in every run; float64's route gap 1.9e-12
# there; zamba2-7b and seamless-m4t-medium 2.0e-5 and 2.1e-5). A bfloat16
# kernel route against the float32 plain route (``bf16_route``) must read
# above it, so that the limit would fail a lower-precision route
INIT_GRAD_TOL = 1e-3


def _family_batch(cfg, b, s, seed, step=0):
    """``SyntheticLM``'s batch ``step`` on the card, with stub frontend
    embeddings (float32, from ``seed``) for the vision and encoder-decoder
    models, as the reference's tests pass them."""
    batch = to_device(SyntheticLM(DataConfig(
        seq_len=s, global_batch=b, vocab_size=cfg.vocab_size,
        seed=seed)).batch(step), DEV)
    if cfg.frontend_seq:
        gen = torch.Generator(device=DEV).manual_seed(seed + 100 + step)
        batch["frontend_emb"] = torch.randn(
            (b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
            generator=gen, device=DEV)
    return batch


def _family_params(cfg, seed, dtype=None):
    """Parameters on the card from ``seed`` (the config's own dtype unless
    ``dtype``), the vision cross gate set to CROSS_GATE: at its initial
    zero a cross layer adds nothing and passes back a zero gradient."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(model_template(cfg), gen,
                         dtype=dtype or cfg.param_dtype, device=DEV)
    if "cross_layers" in params:
        params["cross_layers"]["attn"]["gate"].fill_(CROSS_GATE)
    return params


def _probe_paths(cfg):
    """(name, path, layer index or None) of the leaves whose moves a train
    phase asserts: the first and last layer of the stack, and the router,
    gate, shared block and MTP module where the family has them."""
    fam, last = cfg.family, cfg.n_layers - 1
    if fam == "moe":
        first = (("dense_layers", "attn", "wq_a", 0) if cfg.use_mla
                 else ("layers", "attn", "wq", 0))
        wq = "wq_a" if cfg.use_mla else "wq"
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        out = [("first layer", first[:-1], first[-1]),
               ("last layer", ("layers", "attn", wq), n_moe - 1),
               ("router", ("layers", "moe", "router"), n_moe - 1)]
        if cfg.mtp_depth:
            out.append(("mtp", ("mtp", "proj"), None))
        return out
    if fam in ("ssm", "hybrid"):
        out = [("first layer", ("layers", "mix", "out_proj"), 0),
               ("last layer", ("layers", "mix", "out_proj"), last)]
        if fam == "hybrid":
            out.append(("shared block", ("shared_attn", "attn", "wq"), None))
        return out
    if fam == "vlm":
        return [("first layer", ("layers", "attn", "wq"), 0),
                ("last layer", ("layers", "attn", "wq"), last),
                ("cross layer", ("cross_layers", "attn", "wq"), 0),
                ("gate", ("cross_layers", "attn", "gate"), 0)]
    return [("first layer", ("enc_layers", "attn", "wq"), 0),
            ("last layer", ("layers", "attn", "wq"), last),
            ("cross attention", ("layers", "xattn", "wq"), last)]


def _probe(params, path, index, rows):
    """A copy of a few entries of one leaf: ``rows`` of the embedding, else
    the first 4096 of layer ``index`` (or of the whole leaf)."""
    t = params
    for k in path:
        t = t[k]
    if path == ("embed",):
        return t[rows].clone()
    if index is not None:
        t = t[index]
    return t.reshape(-1)[:4096].clone()


def _precision_gap(c32, c64, seed, batch):
    """Loss and gradients in float32 and in float64 (the route forced on,
    ``auto``, in both) from the same parameters, drawn in float32 from
    ``seed``: the loss gap and the largest gradient gap as a share of its
    float64 leaf's largest entry. The float32 gradients wait on the host
    while float64 runs, and the float32 tree is freed once widened, so that
    deepseek-v3's float64 tree (32 GB) fits beside its gradients."""
    params = _family_params(c32, seed, dtype="float32")
    l32, g32, n32 = _loss_and_grads(c32, params, batch, "auto")
    g32 = tree_map(lambda g: g.cpu(), g32)
    p64 = tree_map(lambda a: a.double(), params)
    del params
    free_memory()
    l64, g64, n64 = _loss_and_grads(c64, p64, batch, "auto")
    del p64
    assert n32 == n64 == train_launches(c32), (n32, n64)
    worst = 0.0
    for a, b_ in zip(tree_leaves(g32), tree_leaves(g64)):
        assert bool(torch.isfinite(b_).all())
        scale = float(b_.abs().max())
        gap = float((a.to(DEV).double() - b_).abs().max())
        worst = max(worst, gap / max(scale, 1e-30))
    del g64
    return {"n_layers": c32.n_layers, "loss": float(l32),
            "loss_fp64": float(l64), "loss_gap": abs(float(l32) - float(l64)),
            "grad_gap_of_max": worst}


def family_exactness(run, full):
    """One train step's loss and gradients at the exactness cut of ``run``
    at full width, batch 2 x 256: float32, kernel route against the route
    forced off (exact launch counts), at the configured init and, but for
    the mixture-of-experts families, with the attention projections
    conditioned (:func:`_conditioned`) and beside the bfloat16 kernel
    route's gap (:func:`_bf16_route_gap`); float64 at the configured init,
    kernel route against plain; or, where no kernel runs or the float64
    tree does not fit beside two sets of gradients, float32 against
    float64. Returns the gaps; :func:`assert_exact` holds them.

    The configured init amplifies rounding through the attention
    projections (the vision cut: 3.8e-4 of a leaf's largest gradient
    between the routes in float32, 1.9e-12 in float64, the same ratio as
    their unit roundings), hence the conditioned check. A router takes
    none: there the two routes' roundings tip near-ties of its top-k
    (granite-moe-3b-a800m conditioned: 5.8e-2 of a leaf's largest
    gradient), a discrete step that is not the kernel's."""
    cut = _replace(full, run.exact)
    c32 = dataclasses.replace(cut, compute_dtype="float32")
    c64 = dataclasses.replace(cut, compute_dtype="float64")
    batch = _family_batch(cut, 2, 256, seed=1)
    out = {"cut": dict(run.exact), "batch": [2, 256]}
    if any(train_launches(c32).values()):
        params = _family_params(c32, 1, dtype="float32")
        out["fp32"] = _route_gap(c32, params, batch)
        if not c32.is_moe:
            out["fp32_conditioned"] = _route_gap(
                c32, _conditioned(params, c32), batch)
            out["bf16_route"] = _bf16_route_gap(c32, params, batch)
        del params
        free_memory()
    if run.fp64_route:
        p64 = _family_params(c64, 1, dtype="float64")
        out["fp64"] = _route_gap(c64, p64, batch)
        del p64
    else:
        out["fp32_vs_fp64"] = _precision_gap(c32, c64, 1, batch)
    free_memory()
    return out


def assert_exact(out):
    """The float32 route gap with conditioned projections within
    FP32_LOSS_TOL / FP32_GRAD_TOL (of each leaf's largest entry); at the
    configured init within FP32_LOSS_TOL and, where the conditioned check
    also holds the stack, INIT_GRAD_TOL (which the bfloat16 route must
    exceed), else FP32_GRAD_TOL; the float64 route gap within FP64_TOL /
    FP64_GRAD_TOL; float32 against float64 within PRECISION_LOSS_TOL (of
    the loss) / PRECISION_GRAD_TOL."""
    if "fp32" in out:
        grad_tol = FP32_GRAD_TOL
        if "fp32_conditioned" in out:
            grad_tol = INIT_GRAD_TOL
            assert out["bf16_route"]["grad_gap_of_max"] > INIT_GRAD_TOL, out
            assert out["fp32_conditioned"]["loss_gap"] <= FP32_LOSS_TOL, out
            assert out["fp32_conditioned"]["grad_gap_of_max"] \
                <= FP32_GRAD_TOL, out
        assert out["fp32"]["loss_gap"] <= FP32_LOSS_TOL, out
        assert out["fp32"]["grad_gap_of_max"] <= grad_tol, (grad_tol, out)
    if "fp64" in out:
        assert out["fp64"]["loss_gap"] <= FP64_TOL, out
        assert out["fp64"]["grad_gap_of_max"] <= FP64_GRAD_TOL, out
    if "fp32_vs_fp64" in out:
        gap = out["fp32_vs_fp64"]
        assert gap["loss_gap"] <= PRECISION_LOSS_TOL * abs(gap["loss_fp64"]), \
            out
        assert gap["grad_gap_of_max"] <= PRECISION_GRAD_TOL, out


def phase_train_family(run):
    """Phases 22-26, one family at full width: ``FAMILY_STEPS`` steps of
    the port's train step (the config's own dtypes: fp32 parameters and
    bf16 compute, deepseek-v3 bf16 parameters and bf16 moments; full remat;
    AdamW), each step's loss and grad norm finite, the learning rate
    ``adamw.schedule``'s, the probed leaves moved, and the attention
    kernels' launches exactly :func:`train_launches`; then
    :func:`family_exactness`. The launch counts are set to 0 before the
    first step and returned, read after the last."""
    t0 = time.perf_counter()
    full = get_config(run.arch)
    cfg = _replace(full, run.cut)
    assert (cfg.compute_dtype, cfg.remat, cfg.attn_flash) \
        == ("bfloat16", "full", "auto"), cfg
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=60,
                          moment_dtype=cfg.opt_state_dtype)
    emit(f"{run.phase}_start", arch=cfg.name,
         memory_allocated=torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    params = _family_params(cfg, 0)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step_fn = make_train_step(cfg, opt).step_fn
    batches = [_family_batch(cfg, run.batch, TRAIN_SEQ, 0, i)
               for i in range(FAMILY_STEPS)]
    probes = [("embedding", ("embed",), None)] + _probe_paths(cfg)
    want = train_launches(cfg)
    torch.cuda.synchronize()

    att.reset_launches()           # this family's training path starts here
    rows = []
    for i, batch in enumerate(batches):
        toks = batch["tokens"][0, :8].long()
        before = [_probe(state["params"], path, j, toks)
                  for _, path, j in probes]
        launched = dict(att.LAUNCHES)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        moved = {name: not torch.equal(_probe(state["params"], path, j, toks),
                                       b_)
                 for (name, path, j), b_ in zip(probes, before)}
        counts = {k: att.LAUNCHES[k] - launched[k] for k in att.LAUNCHES}
        rows.append({"step": i + 1, "ms": ms,
                     **{k: float(v) for k, v in metrics.items()},
                     "launches": counts, "moved": moved})
        emit(f"{run.phase}_step", arch=cfg.name, **rows[-1])
    launches = dict(att.LAUNCHES)  # read right after the training path
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = tree_size_bytes(state["params"]) \
        + tree_size_bytes(state["opt"])
    del state, params, batches, step_fn
    free_memory()
    exact = family_exactness(run, full)
    steady = [r["ms"] for r in rows[1:]]    # the first step is the warm-up
    step_ms = statistics.mean(steady)
    reduced = {k: v for k, v in run.cut}
    emit(run.phase, arch=cfg.name, family=cfg.family, reduced=reduced,
         n_layers=cfg.n_layers, d_model=cfg.d_model, param_count=n_params,
         state_bytes=state_bytes, batch=run.batch, seq_len=TRAIN_SEQ,
         steps=FAMILY_STEPS, param_dtype=cfg.param_dtype,
         moment_dtype=opt.moment_dtype, compute_dtype=cfg.compute_dtype,
         remat=cfg.remat, losses=[r["loss"] for r in rows],
         grad_norms=[r["grad_norm"] for r in rows],
         step_ms=[r["ms"] for r in rows], steady_step_ms=step_ms,
         tokens_per_s=run.batch * TRAIN_SEQ / (step_ms / 1e3),
         max_memory_allocated=peak, launches_per_step=want,
         launches_total=launches, exact=exact,
         fp32_loss_tol=FP32_LOSS_TOL, fp32_grad_tol=FP32_GRAD_TOL,
         init_grad_tol=INIT_GRAD_TOL, fp64_loss_tol=FP64_TOL,
         fp64_grad_tol=FP64_GRAD_TOL,
         precision_loss_tol=PRECISION_LOSS_TOL,
         precision_grad_tol=PRECISION_GRAD_TOL,
         seconds=time.perf_counter() - t0)
    for r in rows:
        assert r["launches"] == want, (r["launches"], want)
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r
        assert r["grad_norm"] > 0, r
        # on the card, as the step computes it
        lr = adamw.schedule(opt, torch.tensor(r["step"], dtype=torch.int32,
                                              device=DEV))
        assert r["lr"] == float(lr), (r, float(lr))
        assert all(r["moved"].values()), r
    assert len({r["loss"] for r in rows}) == len(rows), rows
    assert_exact(exact)
    return launches


def run_family_training():
    """Phases 22-26 in turn, each tree freed before the next. Returns
    {"<phase> <arch>": launches}."""
    return {f"{r.phase} {r.arch}": phase_train_family(r) for r in FAMILY_RUNS}


# ---------------------------------------------------------------------------
# phases 27-31: the main path's measurement surface (the quickstart's twin,
# the kernel bench, the multi-precision sweep, long-context attention and
# the engine's throughput), each through its script's own entry points
# ---------------------------------------------------------------------------


def quickstart_launches(cfg):
    """Launches of each attention kernel in the quickstart on ``cfg`` (the
    reduced config, ``remat="none"``): one forward without a cache (the
    layers' attention, not the MTP layer) and one train step
    (:func:`train_launches`)."""
    want = train_launches(cfg)
    once = 1 if cfg.mtp_depth else 0
    return {**want, "flash_fwd": 2 * want["flash_fwd"] - once}


def phase_quickstart():
    """Phase 27: ``examples/torch_quickstart.py``'s ``run`` for every arch
    on the card: its five lines, finite loss and grad norm, the logits'
    shape, and the attention kernels' launches exactly
    :func:`quickstart_launches` (set to 0 before each arch, read after).
    Returns {"quickstart <arch>": launches}."""
    from repro_torch.configs import ARCH_NAMES, reduced
    qs = _load_script("examples/torch_quickstart.py")
    by_path = {}
    for arch in ARCH_NAMES:
        lines = []
        att.reset_launches()       # this arch's quickstart starts here
        t0 = time.perf_counter()
        res = qs.run(arch, DEV, emit=lines.append)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(att.LAUNCHES)  # read right after it
        cfg = reduced(get_config(arch))
        want = quickstart_launches(cfg)
        emit("quickstart", arch=arch, lines=lines, seconds=seconds,
             launches=launches, want=want,
             **{k: res[k] for k in ("loss", "grad_norm", "aux",
                                    "logits_shape", "reduced_params_mb")})
        assert len(lines) == 5 and lines[0].startswith(f"{arch}:"), lines
        assert res["logits_shape"] == (2, 32, cfg.vocab_size), res
        assert all(np.isfinite(res[k]) for k in ("loss", "grad_norm",
                                                 "aux")), res
        assert res["grad_norm"] > 0, res
        assert launches == want, (arch, launches, want)
        by_path[f"quickstart {arch}"] = launches
    free_memory()
    return by_path


KERNEL_MODULES = (mm, att, ax, cv, ss)


def reset_all_launches():
    for mod in KERNEL_MODULES:
        mod.reset_launches()


def read_all_launches():
    return {k: v for mod in KERNEL_MODULES for k, v in mod.LAUNCHES.items()}


# kernel_bench's rows against their plain versions: the tolerances of
# phases 3, 4, 9 and 10 for the same kernels and dtypes
BENCH_TOL = {"matmul256_f32": ("float", 0.0, ACC_TOL),
             "axpy_1M_f32": ("close",) + AXPY_TOL[torch.float32],
             "conv_googlenet1_f32": ("conv",),
             "attention_1k_bf16": ("float",) + ATT_TOL[torch.bfloat16],
             "ssm_scan_4k_f32": ("close",) + SSM_TOL}


def phase_kernel_bench():
    """Phase 28: ``benchmarks/torch_kernel_bench.py`` on the card. Each
    case's kernel against its plain version first (tolerances
    ``BENCH_TOL``; those launches are not the path's); then its ``rows``
    with every launch count set to 0 before and read after: each ``_cuda``
    row's launches equal its calls, and each kernel launched once more
    than that (the warm call). Returns (checks, rows, launches)."""
    kb = _load_script("benchmarks/torch_kernel_bench.py")
    cases = kb.cases(DEV)
    results = []
    with torch.no_grad():
        for c in cases:
            got, want = c.kernel(), c.plain()
            torch.cuda.synchronize()
            kind, *tol = BENCH_TOL[c.name]
            name = f"kernel_bench {c.name}"
            if kind == "float":
                _check_float(name, got, want, tol[0], results, tol[1])
            elif kind == "close":
                _check_close(name, got, want, *tol, results)
            else:
                _check_conv(name, got, want, *c.operands, results)
    reset_all_launches()           # the bench's path starts here
    rows = kb.rows(DEV, cases)
    torch.cuda.synchronize()
    launches = read_all_launches()  # read right after it
    kernel_rows = [r for r in rows if r["source"] == "cuda"]
    assert len(kernel_rows) == len(cases), rows
    assert not any(r["source"] == "plain_cpu" for r in rows), rows
    for r, c in zip(kernel_rows, cases):
        assert r["kernel"] == f"{c.name}_cuda", (r, c.name)
        assert r["launches"] == r["calls"] == kb.ITERS, r
        assert launches[c.counter[1]] == kb.ITERS + 1, (launches, c.name)
    emit("kernel_bench", rows=rows, checks=results, launches=launches)
    return results, rows, launches


def phase_multiprecision():
    """Phase 29: ``benchmarks/torch_multiprecision.py`` on the card: every
    kernel row's product against its plain version (fp32 at ACC_TOL; bf16
    and f16 within one step of the narrow output of the plain product of
    the same narrowed operands, and within ``tests/test_multiprecision``'s
    3e-2 / 0.5 of the fp32 product; int8 exact), then ``main``'s rows with
    the counts set to 0 before and read after: ``ops.matmul`` launched
    ITERS + 1 times a float row and ``ops.matmul_int8`` a int8 row, every
    kernel row ``source=cuda``. Returns (checks, rows, launches)."""
    mp = _load_script("benchmarks/torch_multiprecision.py")
    rng = np.random.RandomState(0)
    results = []
    sizes = (256, 512)
    with torch.no_grad():
        for n in sizes:
            a32, b32, a8, b8 = mp.kernel_operands(n, rng, DEV)
            calls = mp.kernel_calls(a32, b32, a8, b8)
            want32 = mm.matmul_plain(a32, b32)
            _check_float(f"multiprecision float32 {n}", calls["float32"](),
                         want32, 0.0, results)
            for name, ulp in (("bfloat16", BF16_ULP), ("float16", F16_ULP)):
                dt = torch_dtype(name)
                got = calls[name]()
                _check_float(f"multiprecision {name} {n}", got,
                             mm.matmul_plain(a32.to(dt), b32.to(dt)), ulp,
                             results)
                err = float((got.float() - want32).abs().sub(
                    3e-2 * want32.abs()).max())
                results.append({"check": f"multiprecision {name} {n} vs "
                                f"float32", "max_excess": err, "rtol": 3e-2,
                                "atol": 0.5})
                assert err <= 0.5, results[-1]
            _check_exact(f"multiprecision int8 {n}", calls["int8"](),
                         mm.matmul_int8_plain(a8, b8), results)
    rows = []
    mm.reset_launches()            # the sweep's path starts here
    mp.main(lambda table, row: rows.append(row), device=DEV)
    torch.cuda.synchronize()
    launches = dict(mm.LAUNCHES)   # read right after it
    kernel_rows = [r for r in rows if r["source"] not in ("perfmodel",
                                                           "scoreboard")]
    assert {r["source"] for r in kernel_rows} == {"cuda"}, kernel_rows
    assert len(kernel_rows) == 4 * len(sizes), kernel_rows
    per_call = mp.ITERS + 1
    assert launches == {"matmul": 3 * len(sizes) * per_call,
                        "matmul_int8": len(sizes) * per_call}, launches
    emit("multiprecision", rows=rows, checks=results, launches=launches)
    return results, rows, launches


ATT_LONG = dict(b=1, h=4, d=64, chunk=1024, budget_mb=1024)  # the defaults


def check_long_path(al, s, results):
    """The rows' kernel path at ``s`` (``chunked_attention`` with the kernel
    route on, (1, s, 4, 64) bf16 causal, every key live) against the plain
    versions of its three kernels on the same operands, run a group at a
    time: the output and the gradients of q, k and v for one random dO,
    at ATT_TOL's bfloat16 limits."""
    b, h, d = ATT_LONG["b"], ATT_LONG["h"], ATT_LONG["d"]
    rng = np.random.default_rng(s)
    q, k, v, pos, valid = al._inputs(rng, b, s, h, d, torch.bfloat16, DEV)
    dout = torch.from_numpy(rng.standard_normal((b, s, h, d))).to(
        DEV, torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = al._path_fn("kernel", pos, valid, s, ATT_LONG["chunk"])(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    qf, kf, vf, kvm, bq, bk = att._prepare(
        *(t.transpose(1, 2) for t in (q, k, v)), valid, al.KERNEL_BLOCK,
        al.KERNEL_BLOCK)
    assert qf.shape[1] == s, "the sweep's lengths are block multiples"
    geom = dict(causal=True, bq=bq, bk=bk)
    p_out, p_lse, _ = _plain_by_group(att.flash_fwd_plain, qf, kf, vf, kvm,
                                      **geom)
    doutf = dout.transpose(1, 2).reshape(qf.shape).contiguous()
    delta = (doutf.float() * p_out.float()).sum(-1)
    args = (qf, kf, vf, kvm, doutf, p_lse, delta)
    p_dq = _plain_by_group(att.flash_bwd_dq_plain, *args, **geom)
    p_dk, p_dv = _plain_by_group(att.flash_bwd_dkv_plain, *args, **geom)
    torch.cuda.synchronize()
    rel, acc = ATT_TOL[torch.bfloat16]
    for what, got, want in (("out", out, p_out), ("dq", grads[0], p_dq),
                            ("dk", grads[1], p_dk), ("dv", grads[2], p_dv)):
        _check_float(f"attention_long kernel path {what} seq {s}",
                     got.detach(), want.reshape(b, h, s, d).transpose(1, 2),
                     rel, results, acc)


def phase_attention_long():
    """Phase 30: ``benchmarks/torch_attention_long.py`` on the card, its
    full sweep (``FULL_SEQS`` to 32768) and all four gates, gate 3 in its
    card form (kernel >= blockwise fwd+bwd tokens/s at the largest seq).
    The rows' kernel path is held against its kernels' plain versions at
    every swept seq (:func:`check_long_path`), and the three kernels at
    gate 4's shape, (1, 4, 32768, 16) f32 causal with 128 x 128 blocks
    (the CUDA-core route), against theirs at ACC_TOL
    (:func:`check_attention`); those launches are not the path's.
    Each part's attention launches are set to 0 before it and read after:
    the rows' kernel path 3 forwards and 3 forward+backwards a seq (one
    warm call and 2 timed), gate 1 one forward and backward a case, gate 2
    one forward, gate 4 :func:`train_launches` of the reduced model.
    Returns ({part: launches}, rows, gates)."""
    al = _load_script("benchmarks/torch_attention_long.py")
    from repro_torch.configs import reduced
    lines, by_part, seconds, gates, checks = [], {}, {}, {}, []

    def part(name, fn):
        att.reset_launches()       # this part's path starts here
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        by_part[name] = dict(att.LAUNCHES)   # read right after it
        seconds[name] = time.perf_counter() - t0
        return out

    rows, ceiling = part("rows", lambda: al.bench_rows(
        al.FULL_SEQS, emit=lines.append, device=DEV, **ATT_LONG))
    free_memory()
    for s in al.FULL_SEQS:
        check_long_path(al, s, checks)
        free_memory()
    gates["backward_matches_ref"] = part(
        "gate 1", lambda: al.gate_backward_matches_ref(lines.append, DEV))
    gates["causal_skip"] = part(
        "gate 2", lambda: al.gate_causal_skip(lines.append, DEV))
    gate_seq = al.FULL_SEQS[-1]
    gates["throughput"] = al.gate_blockwise_beats_quadratic(
        rows, gate_seq, lines.append, DEV)
    train_seq = 4 * ceiling
    tiny = reduced(get_config("tinyllama-1.1b"))
    check_attention("attention_long gate 4", 1, tiny.n_heads, train_seq,
                    train_seq, tiny.head_dim, torch.float32, True,
                    al.KERNEL_BLOCK, al.KERNEL_BLOCK, 47, checks,
                    p_valid=1.0)
    free_memory()
    gates["long_train_step"] = part(
        "gate 4", lambda: al.gate_long_train_step(train_seq, lines.append,
                                                  DEV))
    free_memory()
    emit("attention_long", rows=rows, gates=gates, lines=lines,
         checks=checks, quadratic_ceiling=ceiling, gate_seq=gate_seq,
         train_seq=train_seq, launches=by_part, seconds=seconds, **ATT_LONG)
    assert all(gates.values()), gates
    assert any(ln.startswith("attention_gate,gate=throughput,seq=")
               and "fast=kernel,slow=blockwise" in ln for ln in lines), lines
    assert not any("skipped" in r for r in rows if r["path"] != "quadratic"), \
        rows
    n = len(al.FULL_SEQS)
    tl = train_launches(tiny)
    want = {"rows": (6 * n, 3 * n, 3 * n), "gate 1": (4, 4, 4),
            "gate 2": (1, 0, 0), "gate 4": tuple(tl.values())}
    for name, (f, dq, dkv) in want.items():
        got = by_part[name]
        assert (got["flash_fwd"], got["flash_bwd_dq"],
                got["flash_bwd_dkv"]) == (f, dq, dkv), (name, got)
    return {f"attention_long {k}": c for k, c in by_part.items()}, rows, \
        gates


ENGINE_BAR = 10.0     # the reference CI's --min-speedup


def phase_engine_throughput():
    """Phase 31: ``benchmarks/torch_engine_throughput.py``'s ``bench`` on
    the card at its defaults. Its counters: uncached builds one runner a
    program, cached and batched one, the lint pass none, each SEW=8 and
    mask sweep one; the rates and the cached_batched/uncached ratio beside
    the reference's bar (printed, not gated: the port builds a runner
    where the reference compiles with XLA)."""
    et = _load_script("benchmarks/torch_engine_throughput.py")
    res = et.bench(device=DEV)
    cfg = res["config"]
    assert res["uncached"]["compiles"] == cfg["uncached_n"], res
    for path in ("cached", "cached_batched", "lint_overhead"):
        assert res[path]["compiles"] == 1, (path, res[path])
    for sweep in ("int8_cells", "mask_cells"):
        assert res[sweep] and all(r["compiles"] == 1
                                  for r in res[sweep].values()), res[sweep]
    assert cfg["backend"] == "cuda", cfg
    ratio = res["speedup_cached_batched_vs_uncached"]
    emit("engine_throughput", **res, reference_bar=ENGINE_BAR,
         meets_reference_bar=ratio >= ENGINE_BAR)
    return res


# ---------------------------------------------------------------------------
# phases 32-36: the multi-device machinery, the mesh held as tensor
# dimensions on the one card (core/compat.py)
# ---------------------------------------------------------------------------


_ATT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@contextlib.contextmanager
def att_geometries():
    """Inside the block, each attention kernel's wrapper records the
    geometry of its every call, ``(kernel, (G, Sq, Sk, D, dtype, causal,
    bq, bk))``, into the set this yields, then runs as before (its launch
    count is its own)."""
    seen, orig = set(), {n: getattr(att, n) for n in _ATT_KERNELS}

    def recorder(name):
        def call(qf, kf, *args, causal, bq, bk):
            g, sq, d = qf.shape
            seen.add((name, (g, sq, kf.shape[1], d, qf.dtype, causal, bq,
                             bk)))
            return orig[name](qf, kf, *args, causal=causal, bq=bq, bk=bk)
        return call
    for n in _ATT_KERNELS:
        setattr(att, n, recorder(n))
    try:
        yield seen
    finally:
        for n, fn in orig.items():
            setattr(att, n, fn)


def check_path_attention(tag, seen, b, h, seed, results):
    """The forward, dQ and dK/dV kernels against their plain versions (as
    :func:`check_attention`) at every geometry a path launched them at
    (``seen``, from :func:`att_geometries`; each of the three must have run
    there): in the path's dtype at ATT_TOL and, for a narrow path, in
    float32 at ACC_TOL, every key live as on the path. ``b`` x ``h`` is the
    path's (batch, heads), whose product must be the geometry's G; the
    check's own padded, flattened operands and blocks must be the path's.
    Returns the geometries checked."""
    geos = sorted({g for _, g in seen}, key=str)
    assert geos and {(n, g) for g in geos for n in _ATT_KERNELS} == seen, \
        seen
    for i, (g, sq, sk, d, dtype, causal, bq, bk) in enumerate(geos):
        assert g == b * h, (g, b, h)
        for dt in dict.fromkeys((dtype, torch.float32)):
            f = check_attention(f"{tag} {(b, h, sq, sk, d)}", b, h, sq, sk,
                                d, dt, causal, bq, bk, seed + i, results,
                                p_valid=1.0)
            got = (*f["qf"].shape[:2], f["kf"].shape[1], f["qf"].shape[2],
                   f["geom"]["causal"], f["geom"]["bq"], f["geom"]["bk"])
            assert got == (g, sq, sk, d, causal, bq, bk), (got, geos[i])
            del f
            free_memory()
    return [[g, sq, sk, d, str(dt)[6:], causal, bq, bk]
            for g, sq, sk, d, dt, causal, bq, bk in geos]


MESH_GROUPS = (1, 2, 4, 8)
MESH_TIMING = dict(warmup=1, reps=3, inner=1)   # one call is 8 GEMMs' work


def phase_mesh_chaining(smi):
    """Phase 32: ``core.chaining``'s ring matmuls on a (1, 8) mesh at
    tinyllama-1.1b's MLP projection (8192,2048)@(2048,5632):
    ``all_gather_matmul`` at groups 1, 2, 4 and 8 and
    ``matmul_reduce_scatter``, in float32 against one float64 product
    (ACC_TOL of its largest entry) and in bfloat16 against the float32
    product of the narrowed operands (one bf16 step plus ACC_TOL); the
    ppermute counts exactly ``(group - 1) + 8/group`` and 8. Each device of
    the all-gather computes the whole product, so a call does 8 GEMMs'
    work on one card. Times beside one ``torch.matmul`` (printed, not
    gated)."""
    t0 = time.perf_counter()
    m, k, n = LARGE_SHAPE
    mesh = make_mesh(1, 8)
    gen = torch.Generator(device=DEV).manual_seed(32)
    x = torch.randn((m, k), generator=gen, device=DEV)
    w = torch.randn((k, n), generator=gen, device=DEV)
    assert not torch.backends.cuda.matmul.allow_tf32
    results, rows = [], {}
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        if dt == torch.float32:
            ref, rel = (xd.double() @ wd.double()), 0.0
        else:
            ref, rel = xd.float() @ wd.float(), BF16_ULP
        name = str(dt)[6:]
        for g in MESH_GROUPS + ("rs",):
            if g == "rs":
                fn = lambda: chaining.matmul_reduce_scatter(xd, wd, mesh,
                                                            "model")
                hops = 8
            else:
                fn = lambda g=g: chaining.all_gather_matmul(
                    xd, wd, mesh, "model", group=g)
                hops = (g - 1) + 8 // g
            compat.reset_counts()
            y = fn()
            counts = compat.read_counts()
            assert counts["ppermute"]["calls"] == hops, (g, counts)
            _check_float(f"mesh {name} group {g}", y, ref, rel, results)
            del y
            rows[f"{name} {g}"] = {"ms": time_ms(fn, **MESH_TIMING),
                                   "ppermutes": hops,
                                   "ppermute_bytes": counts["ppermute"]
                                   ["bytes"]}
        rows[f"{name} torch.matmul"] = {"ms": time_ms(
            lambda: torch.matmul(xd, wd), **MESH_TIMING)}
        del ref
    emit("mesh_chaining", gpu=smi, shape=[m, k, n], mesh=[1, 8],
         checks=results, times=rows, seconds=time.perf_counter() - t0)


PIPE_STAGES, PIPE_MICRO, PIPE_LAYERS = 4, 8, 2   # stages x layers a stage
PIPE_GRAD_TOL = 1e-4   # f32 sums of 8 microbatches' gradients, their order


def phase_mesh_pipeline(smi):
    """Phase 33: ``train.pipeline`` on tinyllama-1.1b at full width, 4
    stages of 2 ``dense_block`` layers (8 layers, fp32 parameters, bf16
    compute), M = 8 microbatches of 1 x 2048: ``pipeline_loss`` forward and
    backward against the same layers applied to each microbatch in
    sequence — the output bit-equal (or within one bf16 step), the
    gradients within PIPE_GRAD_TOL of each leaf's largest (their f32 sums
    over the microbatches run in another order) — and the attention
    kernels' launches exactly M x S x 2 each (the port skips inactive
    stages: ``pipeline.py``). ``bubble_fraction(4, 8)`` beside the
    forward and backward's seconds, the two timed in turns (sequential,
    pipeline, pipeline, sequential) after a first, untimed call of each:
    one card runs the stages one after another, so the bubble costs
    nothing here and the times read the schedule's overhead only. Then the
    three kernels against their plain versions at the geometry the
    pipeline launched them at, (1, 32, 2048, 64) causal, in bfloat16 and
    float32 (:func:`check_path_attention`). Returns the launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=PIPE_STAGES * PIPE_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(33)
    params = init_params(model_template(cfg), gen, device=DEV)
    stages = tree_map(lambda a: a.reshape((PIPE_STAGES, PIPE_LAYERS)
                                          + a.shape[1:]), params["layers"])
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, TRAIN_SEQ),
                         generator=gen, device=DEV)
    x = params["embed"][toks].to(torch.bfloat16)
    c = torch.randn(x.shape, generator=gen, device=DEV)
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=DEV)[None]
    mesh = staging.Mesh(("pod",), (PIPE_STAGES,))

    def stage_fn(p, h):
        for j in range(PIPE_LAYERS):
            h = dense_block(cfg, tree_map(lambda a: a[j], p), h, pos)[0]
        return h

    def loss_fn(out, target):
        return torch.mean(out.float() * target)

    def grads(run):
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), stages)
        loss = run(leaves)
        return loss.detach(), torch.autograd.grad(
            loss, list(tree_leaves(leaves)))

    def piped(leaves):
        return pipeline_loss(stage_fn, loss_fn, leaves, x, c, mesh, "pod")

    def sequential(leaves):
        outs = []
        for i in range(PIPE_MICRO):
            h = x[i]
            for s in range(PIPE_STAGES):
                h = stage_fn(tree_map(lambda a: a[s], leaves), h)
            outs.append(h)
        return loss_fn(torch.stack(outs), c)

    with torch.no_grad():
        y_pipe = pipeline_apply(stage_fn, stages, x, mesh, "pod")
        y_seq = torch.stack([
            functools.reduce(lambda h, s: stage_fn(
                tree_map(lambda a: a[s], stages), h),
                range(PIPE_STAGES), x[i]) for i in range(PIPE_MICRO)])
    out_equal = torch.equal(y_pipe, y_seq)
    out_gap = float((y_pipe.float() - y_seq.float()).abs().max())
    assert out_equal or bool(((y_pipe.float() - y_seq.float()).abs()
                              <= BF16_ULP * y_seq.float().abs()).all()), \
        out_gap
    del y_pipe, y_seq
    att.reset_launches()            # the pipeline's path starts here
    compat.reset_counts()
    with att_geometries() as seen:
        loss_p, g_pipe = grads(piped)
    launches = dict(att.LAUNCHES)   # read right after it
    counts = compat.read_counts()
    loss_s, g_seq = grads(sequential)
    secs = {"pipeline": [], "sequential": []}
    for name in ("sequential", "pipeline", "pipeline", "sequential"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads(piped if name == "pipeline" else sequential)
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t1)
    each = PIPE_MICRO * PIPE_STAGES * PIPE_LAYERS
    assert launches == {"flash_fwd": each, "flash_bwd_dq": each,
                        "flash_bwd_dkv": each}, launches
    assert counts["ppermute"]["calls"] == PIPE_MICRO + PIPE_STAGES - 1
    assert counts["psum"]["calls"] == 1
    assert float(loss_p) == float(loss_s) or abs(float(loss_p - loss_s)) \
        <= 1e-6 * abs(float(loss_s)), (float(loss_p), float(loss_s))
    gaps = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(g_pipe, g_seq)]
    assert max(gaps) <= PIPE_GRAD_TOL, gaps
    del params, stages, g_pipe, g_seq, x, c
    free_memory()
    att_checks = []
    geos = check_path_attention("mesh_pipeline", seen, 1, cfg.n_heads, 330,
                                att_checks)
    emit("mesh_pipeline", gpu=smi, arch=cfg.name, stages=PIPE_STAGES,
         layers_per_stage=PIPE_LAYERS, micro=PIPE_MICRO,
         micro_shape=[1, TRAIN_SEQ, cfg.d_model], output_bit_equal=out_equal,
         output_max_gap=out_gap, loss=float(loss_p),
         loss_sequential=float(loss_s), grad_max_rel_gap=max(gaps),
         grad_tol=PIPE_GRAD_TOL, launches=launches, collectives=counts,
         bubble_fraction=bubble_fraction(PIPE_STAGES, PIPE_MICRO),
         fwd_bwd_s_in_turns=secs,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         attention_geometries=geos, attention_checks=att_checks,
         seconds=time.perf_counter() - t0)
    return launches


COMP_DEVICES, COMP_LAYERS = 4, 2


def phase_mesh_compression(smi):
    """Phase 34: ``optim.compression.compressed_psum`` on a (4, 1) mesh
    over the gradient tree of tinyllama-1.1b at full width and 2 layers
    (fp32; each of the 4 data devices its own 1 x 2048 batch of
    ``SyntheticLM``): per leaf, the mean within the reference's bound
    (tests/test_substrate.py: 0.05 of the true mean's largest + 0.05),
    the error-feedback residual below |g|max / 100; the wire bytes counted
    (int8 all_to_all and all_gather, the scale's pmax) beside the f32 ring
    all-reduce's 2 (n-1)/n x 4 bytes an element a device."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=COMP_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(34)
    params = init_params(model_template(cfg), gen, device=DEV)
    trees = []
    for d in range(COMP_DEVICES):
        batch = _family_batch(cfg, 1, TRAIN_SEQ, 34, d)
        (_, _), g = value_and_grad(lambda p, b: lm_loss(cfg, p, b))(
            params, batch)
        trees.append(g)
    stacked = tree_map(lambda *gs: torch.stack(gs), *trees)
    del trees
    mesh = make_mesh(COMP_DEVICES, 1)

    def device_fn(g, r):
        return compressed_psum(g, r, mesh, ("data",))

    spec = tree_map(lambda _: PS("data"), stacked)
    compat.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mean, resid = compat.shard_map(
        device_fn, mesh=mesh, in_specs=(spec, spec),
        out_specs=(tree_map(lambda _: PS(None), stacked), spec))(
            stacked, init_residuals(stacked))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    counts = compat.read_counts()
    worst = {"mean_err_over_bound": 0.0, "residual_over_bound": 0.0}
    n_elems = 0
    for g, mg, r in zip(tree_leaves(stacked), tree_leaves(mean),
                        tree_leaves(resid)):
        true = g.mean(dim=0)
        err = float((mg[0] - true).abs().max())
        bound = 0.05 * float(true.abs().max()) + 0.05
        worst["mean_err_over_bound"] = max(worst["mean_err_over_bound"],
                                           err / bound)
        worst["residual_over_bound"] = max(
            worst["residual_over_bound"],
            float(r.abs().max()) / (float(g.abs().max()) / 100))
        n_elems += true.numel()
    assert worst["mean_err_over_bound"] < 1, worst
    assert worst["residual_over_bound"] < 1, worst
    wire = sum(v["bytes"] for k, v in counts.items() if k != "shard_map")
    ring_f32 = 2 * (COMP_DEVICES - 1) / COMP_DEVICES * 4 * n_elems \
        * COMP_DEVICES
    n_leaves = len(list(tree_leaves(stacked)))
    assert counts["all_to_all"]["calls"] == n_leaves, counts
    assert counts["all_gather"]["calls"] == 2 * n_leaves, counts
    emit("mesh_compression", gpu=smi, arch=cfg.name, n_layers=COMP_LAYERS,
         mesh=[COMP_DEVICES, 1], leaves=n_leaves, elements=n_elems,
         worst=worst, collectives=counts, wire_bytes=wire,
         f32_ring_bytes=ring_f32, ring_over_wire=ring_f32 / wire, ms=ms,
         seconds=time.perf_counter() - t0)
    del params, stacked, mean, resid
    free_memory()


# 4 of 32 layers and 2 steps (8 and 3 before phases 41 and 43 took the
# expert-parallel route): its checks read neither depth nor a third step
MESH_TRAIN = dict(data=2, model=4, batch=8, layers=4, steps=2)
EP_LAYER_TOKENS, EP_LAYER_CF = 2048, 16.0
# the mesh step's gradients against the one-device step's: one MoE layer
# (a deeper stack's roundings tip near-ties of the next router's top-k, a
# discrete step that is not the dispatch's: phase 22-26's finding), float32,
# at a capacity factor where neither route can drop a token
EP_GRAD_LAYERS, EP_GRAD_CF = 1, 5.0


def _ce_and_grads(cfg, params, batch, ctx=None):
    """The cross-entropy and its gradients. The aux term is left out: the
    mesh takes it per device and averages (as the reference does), the one
    device over every token, so the two differ by design."""
    (ce, metrics), grads = value_and_grad(
        lambda p, b: (lambda _, m: (m["ce"], m))(
            *lm_loss(cfg, p, b, ctx=ctx)))(params, batch)
    torch.cuda.synchronize()
    return float(ce), float(metrics["aux"]), grads


def _grad_gap(got, want):
    """The largest gap of a leaf as a share of that leaf's largest entry."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


@contextlib.contextmanager
def misrouted_replies():
    """A planted fault: every third ``all_to_all`` (a chunk's third, the
    experts' replies) hands each device the replies meant for the device
    on the neighbouring lane."""
    orig, calls = compat.all_to_all, [0]

    def call(x, axis, split_axis, concat_axis, tiled=False):
        y = orig(x, axis, split_axis, concat_axis, tiled=tiled)
        calls[0] += 1
        return torch.roll(y, 1, dims=y.dim() - 3) if calls[0] % 3 == 0 \
            else y
    compat.all_to_all = call
    try:
        yield
    finally:
        compat.all_to_all = orig


def ep_grad_check(full, ctx):
    """The mesh train step's loss and gradients (``lm_loss`` with ``ctx``:
    the expert-parallel route, forward and backward) against the
    one-device step's (the one-hot dispatch, in groups of 64 tokens with
    ``DENSE_PATH_MAX_TOKENS`` lowered) on the same parameters and batch:
    ``full`` cut to EP_GRAD_LAYERS, float32, capacity factor EP_GRAD_CF, 8
    x 2048 tokens. At that factor neither route drops a token (asserted
    from the capacities), so both compute the same function and differ by
    summation order only: the cross-entropy within FP32_LOSS_TOL and every
    leaf's gradient within FP32_GRAD_TOL of its largest entry. The same
    mesh step with its replies misrouted (:func:`misrouted_replies`) must
    exceed that limit."""
    cfg = dataclasses.replace(
        full, n_layers=EP_GRAD_LAYERS, compute_dtype="float32",
        moe=dataclasses.replace(full.moe, capacity_factor=EP_GRAD_CF))
    m, lanes = cfg.moe, ctx.n_lanes
    tokens = MESH_TRAIN["batch"] * TRAIN_SEQ
    chunk = min(moe_mod.EP_CHUNK_TOKENS,
                tokens // (MESH_TRAIN["data"] * lanes))
    cap_send = max(int(chunk * m.top_k * m.capacity_factor / lanes), m.top_k)
    cap_local = max(int(lanes * cap_send * 2
                        / (m.n_experts_padded // lanes)), 1)
    cap_group = max(int(64 * m.top_k * m.capacity_factor / m.n_experts),
                    m.top_k)
    # a device sends a lane at most chunk x top_k rows; an expert takes at
    # most one row a token of each lane's chunk; a group of 64 at most 64
    assert cap_send >= chunk * m.top_k and cap_local >= lanes * chunk \
        and cap_group >= 64, (cap_send, cap_local, cap_group)
    gen = torch.Generator(device=DEV).manual_seed(351)
    params = init_params(model_template(cfg), gen, device=DEV)
    batch = _family_batch(cfg, MESH_TRAIN["batch"], TRAIN_SEQ, 351)
    torch.cuda.reset_peak_memory_stats()
    compat.reset_counts()
    ce_mesh, aux_mesh, g_mesh = _ce_and_grads(cfg, params, batch, ctx)
    a2a = compat.read_counts()["all_to_all"]["calls"]
    passes = 2 if cfg.remat == "full" else 1
    assert a2a == 3 * cfg.n_layers * passes, a2a
    peak = torch.cuda.max_memory_allocated()
    with misrouted_replies():
        ce_bad, _, g_bad = _ce_and_grads(cfg, params, batch, ctx)
    lowered = moe_mod.DENSE_PATH_MAX_TOKENS
    moe_mod.DENSE_PATH_MAX_TOKENS = tokens // 2     # groups of 64
    try:
        ce_one, aux_one, g_one = _ce_and_grads(cfg, params, batch)
    finally:
        moe_mod.DENSE_PATH_MAX_TOKENS = lowered
    fault = {"ce_gap": abs(ce_bad - ce_one),
             "grad_gap_of_max": _grad_gap(g_bad, g_one)}
    out = {"n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
           "tokens": tokens, "capacity_factor": EP_GRAD_CF,
           "cap_send": cap_send, "cap_local": cap_local,
           "cap_group_of_64": cap_group, "ce": ce_one,
           "ce_gap": abs(ce_mesh - ce_one),
           "grad_gap_of_max": _grad_gap(g_mesh, g_one),
           "aux_mesh": aux_mesh, "aux_one_device": aux_one,
           "loss_tol": FP32_LOSS_TOL, "grad_tol": FP32_GRAD_TOL,
           "misrouted": fault, "max_memory_allocated": peak}
    assert out["ce_gap"] <= FP32_LOSS_TOL, out
    assert out["grad_gap_of_max"] <= FP32_GRAD_TOL, out
    assert fault["grad_gap_of_max"] > FP32_GRAD_TOL, out
    del params, g_mesh, g_bad, g_one
    free_memory()
    return out


def phase_mesh_train(smi):
    """Phase 35: granite-moe-3b-a800m at full width, ``MESH_TRAIN``'s 4 of
    32 layers (once 16: the state of all 32 leaves no room; halved twice
    since for the run's time: the checks do not read depth),
    through ``Trainer(mesh=make_mesh(2, 4))`` — the path ``launch/train.py
    --data 2 --model 4`` takes — 2 AdamW steps at 8 x 2048 = 16,384 tokens,
    the
    least that takes the expert-parallel route (48 padded experts over 4
    lanes, 2048 tokens a device in one chunk): finite losses, the
    attention kernels' launches exactly ``train_launches`` a step, and the
    EP route witnessed by exactly 3 all_to_all a chunk a MoE layer a pass
    (full remat: two passes a step). Then 2 steps of the one-device step
    at PR 22's 4 x 2048 on the same state, for tokens/s and peak memory
    beside it. Before them, one MoE layer at full width: ``moe_ep_shard_map``
    on (2, 4) at 2048 tokens and capacity factor 16 (float32) against
    ``moe_dense_dispatch``, within the reference's own bound
    (tests/test_moe.py: 1e-3 of the largest + 1e-4; aux within 0.3), and
    the mesh step's loss and gradients against the one-device step's
    (:func:`ep_grad_check`). Last, the three attention kernels against
    their plain versions at the geometry the mesh step launched them at,
    (8, 32 padded heads, 2048, 64) causal, in bfloat16 and float32
    (:func:`check_path_attention`). Returns the training path's
    launches."""
    t0 = time.perf_counter()
    full = get_config(MOE_ARCH)
    lay = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=EP_LAYER_CF))
    gen = torch.Generator(device=DEV).manual_seed(35)
    p = init_params(moe_template(lay), gen, device=DEV)
    x = torch.randn((EP_LAYER_TOKENS, lay.d_model), generator=gen,
                    device=DEV)
    ctx = MeshCtx(mesh=make_mesh(MESH_TRAIN["data"], MESH_TRAIN["model"]))
    compat.reset_counts()
    y_ep, aux_ep = moe_ep_shard_map(lay, p, x, ctx)
    layer_counts = compat.read_counts()
    y_d, aux_d = moe_dense_dispatch(lay, p, x)
    scale = float(y_d.abs().max())
    layer_err = float((y_ep - y_d).abs().max())
    assert layer_err < 1e-3 * scale + 1e-4, (layer_err, scale)
    assert abs(float(aux_ep) - float(aux_d)) < 0.3, (aux_ep, aux_d)
    assert layer_counts["all_to_all"]["calls"] == 3, layer_counts
    del p, x, y_ep, y_d
    free_memory()
    ep_grad = ep_grad_check(full, ctx)

    cfg = dataclasses.replace(full, n_layers=MESH_TRAIN["layers"])
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=60)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=MESH_TRAIN["batch"],
                      vocab_size=cfg.vocab_size)
    trainer = Trainer(cfg, opt, data,
                      TrainerConfig(steps=MESH_TRAIN["steps"], log_every=1),
                      mesh=ctx.mesh, device=DEV)
    stamps, rows = [], []

    def on_step(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        rows.append(m)

    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()            # the mesh training path starts here
    compat.reset_counts()
    stamps.append(time.perf_counter())
    with att_geometries() as seen:
        _, state = trainer.run(on_step=on_step)
    launches = dict(att.LAUNCHES)   # read right after it
    counts = compat.read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = MESH_TRAIN["steps"]
    per_step = train_launches(cfg)
    assert launches == {k: steps * v for k, v in per_step.items()}, \
        (launches, per_step)
    passes = 2 if cfg.remat == "full" else 1
    tokens_dev = MESH_TRAIN["batch"] * TRAIN_SEQ // (
        MESH_TRAIN["data"] * MESH_TRAIN["model"])
    chunks = -(-tokens_dev // moe_mod.EP_CHUNK_TOKENS)
    want_a2a = 3 * chunks * cfg.n_layers * passes * steps
    assert counts["all_to_all"]["calls"] == want_a2a, (counts, want_a2a)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows), rows
    mesh_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    # the one-device step at PR 22's shape, on the trained state
    one = make_train_step(cfg, opt).step_fn
    batches = [_family_batch(cfg, 4, TRAIN_SEQ, 35, i) for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    one_ms = []
    for b in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = one(state, b)
        float(m["loss"])
        one_ms.append(1e3 * (time.perf_counter() - t1))
    one_peak = torch.cuda.max_memory_allocated()
    mesh_steady = statistics.mean(mesh_ms[1:])
    one_steady = statistics.mean(one_ms[1:])
    del trainer, state, batches, one
    free_memory()
    att_checks = []
    geos = check_path_attention("mesh_train", seen, MESH_TRAIN["batch"],
                                cfg.n_heads_padded, 350, att_checks)
    emit("mesh_train", gpu=smi, arch=cfg.name, mesh=[MESH_TRAIN["data"],
                                                      MESH_TRAIN["model"]],
         reduced={"n_layers": cfg.n_layers}, d_model=cfg.d_model,
         experts_padded=cfg.moe.n_experts_padded, batch=MESH_TRAIN["batch"],
         seq_len=TRAIN_SEQ, tokens_per_device=tokens_dev,
         ep_chunks_per_layer=chunks, steps=steps,
         losses=[r["loss"] for r in rows],
         grad_norms=[r["grad_norm"] for r in rows],
         aux=[r["aux"] for r in rows], step_ms=mesh_ms,
         steady_step_ms=mesh_steady,
         tokens_per_s=MESH_TRAIN["batch"] * TRAIN_SEQ / (mesh_steady / 1e3),
         max_memory_allocated=peak, launches=launches,
         launches_per_step=per_step, collectives=counts,
         one_device={"batch": 4, "step_ms": one_ms, "steady_step_ms":
                     one_steady, "tokens_per_s": 4 * TRAIN_SEQ
                     / (one_steady / 1e3), "max_memory_allocated": one_peak,
                     "note": "another batch than the mesh step's (4 x 2048 "
                             "against 8 x 2048): not a speed comparison"},
         ep_layer={"tokens": EP_LAYER_TOKENS, "capacity_factor": EP_LAYER_CF,
                   "max_err": layer_err, "scale": scale,
                   "aux": [float(aux_ep), float(aux_d)],
                   "collectives": layer_counts},
         ep_grad=ep_grad, attention_geometries=geos,
         attention_checks=att_checks, seconds=time.perf_counter() - t0)
    return launches


MESH_SERVE_LANES, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = 4, 64, 4


def phase_mesh_serve(smi, cfg):
    """Phase 36: deepseek-v3-671b at PR 20's cut (1 dense + 1 MoE layer,
    bf16: ``cfg``) on a (1, 4) mesh: ``make_prefill_step`` (MLA's
    lane-local route: one shard_map a layer, 128 heads 32 a lane; the
    all-reduces of the split outputs after ``wo`` and the experts counted,
    as a process mesh's ranks run them) and 4 ``make_decode_step`` calls
    with the mesh against the
    same steps without it on the same inputs, each logit gap within
    bf16's own rounding (the bf16 forward's gap to float32 compute, the
    witness, + 1e-3 of the largest logit), timed in turns (mesh, plain,
    plain, mesh; ms per run); then ``ServingEngine(ctx=...)`` on 4
    requests of 32-40 prompt tokens and 4 new tokens, 2 slots, greedy, at
    the configured precision: every request done, one lane-local prefill
    per request, and the tokens of the same engine without a mesh."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen,
                         dtype=torch_dtype(cfg.param_dtype), device=DEV)
    ctx = MeshCtx(mesh=make_mesh(1, MESH_SERVE_LANES))
    toks = torch.randint(0, cfg.vocab_size, (2, MESH_SERVE_PROMPT),
                         generator=gen, device=DEV, dtype=torch.int32)
    n_max = MESH_SERVE_PROMPT + MESH_SERVE_STEPS
    with torch.no_grad():
        full, _, _ = forward(cfg, params, toks)
        full32, _, _ = forward(dataclasses.replace(
            cfg, compute_dtype="float32"), params, toks)
        witness = _logit_gap(full[:, -1], full32[:, -1])
        del full, full32
        runs, ms = {}, {}
        # in turns: the first mesh run feeds its greedy tokens to the rest
        for turn, name in enumerate(("mesh", "plain", "plain", "mesh")):
            c = ctx if name == "mesh" else None
            compat.reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = make_prefill_step(cfg, c, n_max)(
                params, {"tokens": toks})
            torch.cuda.synchronize()
            ms.setdefault(f"{name}_prefill", []).append(
                1e3 * (time.perf_counter() - t1))
            if c is not None:
                # beside the lane-local shard_maps, the all-reduces of the
                # heads' and the experts' split outputs, counted as a
                # process mesh's ranks run them
                n_moe = cfg.n_layers - cfg.moe.n_dense_layers
                assert dict(compat.CALLS) == {
                    "shard_map": cfg.n_layers,
                    "psum": cfg.n_layers + n_moe}, dict(compat.CALLS)
            out = [lg]
            dec = make_decode_step(cfg, c)
            t1 = time.perf_counter()
            for i in range(MESH_SERVE_STEPS):
                nxt = torch.argmax(runs["mesh"][i] if turn else out[-1],
                                   dim=-1).to(torch.int32)
                lg, cache = dec(params, cache, {"tokens": nxt[:, None]})
                out.append(lg)
            torch.cuda.synchronize()
            ms.setdefault(f"{name}_decode", []).append(
                1e3 * (time.perf_counter() - t1) / MESH_SERVE_STEPS)
            runs.setdefault(name, out)
            del cache
    gaps = [_logit_gap(a, b) for a, b in zip(runs["mesh"], runs["plain"])]
    assert max(gaps) <= witness + 1e-3, (gaps, witness)
    del runs

    tokens = {}
    for name, c in (("mesh", ctx), ("plain", None)):
        eng = ServingEngine(cfg, params, slots=2, max_seq=64, ctx=c,
                            degrade=None, device=DEV)
        reqs = make_requests(cfg, np.random.RandomState(36), 4, 4)
        for r in reqs:
            r.prompt = r.prompt[:40]       # within max_seq with 4 new
            assert eng.submit(r) is None
        compat.reset_counts()
        eng.run_to_completion()
        assert all(r.state == State.DONE and len(r.out_tokens) == 4
                   for r in reqs), [(r.uid, r.state.value) for r in reqs]
        if c is not None:       # one lane-local prefill a request
            assert compat.CALLS["shard_map"] == cfg.n_layers * len(reqs), \
                dict(compat.CALLS)
        tokens[name] = {r.uid: [int(t) for t in r.out_tokens] for r in reqs}
        del eng
    assert tokens["mesh"] == tokens["plain"], tokens
    emit("mesh_serve", gpu=smi, arch=cfg.name, n_layers=cfg.n_layers,
         mesh=[1, MESH_SERVE_LANES], compute_dtype=cfg.compute_dtype,
         prompt=MESH_SERVE_PROMPT, steps=MESH_SERVE_STEPS, rel_gaps=gaps,
         witness=witness, ms=ms, engine_tokens=tokens["mesh"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0)
    del params
    free_memory()


def run_mesh(smi):
    """Phases 32-36. Returns the attention kernels' launches by path."""
    phase_mesh_chaining(smi)
    free_memory()
    pipe = phase_mesh_pipeline(smi)
    phase_mesh_compression(smi)
    train = phase_mesh_train(smi)
    phase_mesh_serve(smi, serving_cfgs()[MLA_ARCH])
    return {"mesh_pipeline": pipe, "mesh_train": train}


# ---------------------------------------------------------------------------
# phase 37: the dry run (the count of a step, its roofline)
# ---------------------------------------------------------------------------


# (arch, shape, overrides) on the (16, 16) production mesh, counted on meta
# tensors: deepseek-v3-671b's prefill at 4 of its 61 layers (its 3 dense
# layers and one MoE layer): the 32k prompt's lane-local MLA loop, a few
# hundred chunk bodies a layer, dominates the count's host time
DRYRUN_CELLS = (("llama3-8b", "train_4k", None),
                ("granite-moe-3b-a800m", "train_4k", None),
                ("deepseek-v3-671b", "prefill_32k", {"n_layers": 4}),
                ("tinyllama-1.1b", "decode_32k", None))
DRYRUN_STEPS = 3
# the one-device train step's count (FLOPs, bytes), unmoved since it was
# first counted: one device has no collective, so no rule of the mesh
# count may touch it
DRYRUN_TRAIN_COUNT = ("7.0880e+13", "4.8344e+11")


def dryrun_lookups(arch, shape, over):
    """The all-reduces a cell's step derives for its lookups into the
    embedding table: one per lookup in the forward (the tokens, and in a
    train step with MTP the labels) where the production mesh's ``model``
    axis shards the table's vocab rows, none where it does not divide
    them."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dryrun.cell_config(get_config(arch), SHAPES[shape], over)
    mesh = make_production_mesh()
    if cfg.vocab_size % dict(zip(mesh.axis_names, mesh.sizes))["model"]:
        return 0
    return 1 + int(bool(cfg.mtp_depth) and SHAPES[shape].kind == "train")


def phase_dryrun(smi):
    """Phase 37. (a) ``launch.dryrun.run_cell`` for DRYRUN_CELLS on
    ``pod16x16`` (meta tensors, the card's routes), each roofline row, its
    ``trace_s``, ``count_short`` and collective bytes by kind, and the
    lookups' all-reduces, exactly :func:`dryrun_lookups` (one per lookup
    into the vocab-sharded table in the tensor-parallel cells); then
    ``launch/report.py``'s table over them. (b)
    tinyllama-1.1b's train step as phase 7 runs it (4 x 2048, bf16
    compute, full remat, one device) counted on ``meta`` for the card
    (``target="cuda"``) and on the card itself: FLOPs and bytes equal,
    and equal to DRYRUN_TRAIN_COUNT, and each attention kernel's counted
    calls equal to its launches in that step. (c) The step timed without
    the count (host clock to a synchronise, mean of steps 2-3) beside the
    roofline's terms, which must lie below it; the measured peak memory
    beside the estimate.
    Returns the attention kernels' launches of the counted step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import roofline
    from repro_torch.core.step_analysis import analyze
    from repro_torch.launch import dryrun, report
    from repro_torch.models.transformer import input_specs

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    try:
        for arch, shape, over in DRYRUN_CELLS:
            r = dryrun.run_cell(arch, shape, False, out_dir, overrides=over)
            rl = r["roofline"]
            detail = rl["detail"]
            lookups = dryrun_lookups(arch, shape, over)
            emit("dryrun_cell", arch=arch, shape=shape, mesh=r["mesh"],
                 reduced=over, trace_s=r["trace_s"],
                 **{k: rl[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "bottleneck",
                                       "achievable_step_s", "mfu_bound",
                                       "useful_ratio", "hlo_flops_per_dev",
                                       "hlo_bytes_per_dev",
                                       "coll_bytes_per_dev")},
                 collective_by_kind=detail["collective_by_kind"],
                 lookup_all_reduces=detail["lookups"],
                 lookups_expected=lookups,
                 count_short=r["count_short"],
                 kernels=detail["kernels"],
                 memory_analysis=r["memory_analysis"],
                 fits_h100_80g=r["fits_h100_80g"])
            assert rl["compute_s"] > 0 and rl["memory_s"] > 0, r
            assert detail["lookups"] == lookups, (arch, shape, detail)
            if (arch, shape) in (("tinyllama-1.1b", "decode_32k"),
                                 ("deepseek-v3-671b", "prefill_32k")):
                assert lookups == 1, (arch, shape)  # tensor-parallel cells
        with contextlib.redirect_stdout(io.StringIO()) as table:
            report.main(["--dir", out_dir])
        print(table.getvalue(), end="", flush=True)
        rows = report.load_all(out_dir)
        assert len(rows) == len(DRYRUN_CELLS), rows
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cells_s = time.perf_counter() - t0

    cfg, opt = _train_cfgs()
    shape = ShapeConfig("train_4x2048", TRAIN_SEQ, TRAIN_BATCH, "train")
    bundle = make_train_step(cfg, opt)
    meta = analyze(bundle.step_fn, bundle.abstract_state,
                   input_specs(cfg, shape), target="cuda",
                   params=bundle.abstract_state["params"])
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                         device=DEV)
    state = {"params": params, "opt": adamw.init(opt, params)}
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device(source.batch(i), DEV) for i in range(DRYRUN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for batch in batches:
        t1 = time.perf_counter()
        state, _ = bundle.step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    peak = torch.cuda.max_memory_allocated()
    att.reset_launches()               # the counted step starts here
    card = analyze(bundle.step_fn, state, batches[0],
                   params=state["params"])
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)      # read right after it
    del state, params
    free_memory()

    calls = {k: v["calls"] for k, v in card.kernels.items()}
    assert (card.flops, card.bytes_accessed) == (meta.flops,
                                                 meta.bytes_accessed), \
        (card.flops, meta.flops, card.bytes_accessed, meta.bytes_accessed)
    assert (f"{meta.flops:.4e}", f"{meta.bytes_accessed:.4e}") == \
        DRYRUN_TRAIN_COUNT, (meta.flops, meta.bytes_accessed)
    assert card.kernels == meta.kernels, (card.kernels, meta.kernels)
    assert calls == launches and launches == train_launches(cfg), \
        (calls, launches)
    rl = roofline.build(cfg, shape, "1x1", 1, meta)
    measured = statistics.mean(step_ms[1:])     # the first is the warm-up
    assert rl.compute_s * 1e3 < measured and rl.memory_s * 1e3 < measured, \
        (rl, measured)
    emit("dryrun", card=smi, cells=len(DRYRUN_CELLS), cells_s=cells_s,
         arch=cfg.name, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat,
         flops=meta.flops, bytes=meta.bytes_accessed,
         card_flops=card.flops, card_bytes=card.bytes_accessed,
         counted_ops=meta.ops, kernels=meta.kernels, launches=launches,
         step_ms=step_ms, measured_step_ms=measured,
         compute_ms=rl.compute_s * 1e3, memory_ms=rl.memory_s * 1e3,
         achievable_step_ms=rl.achievable_step_s * 1e3,
         bottleneck=rl.bottleneck, mfu_bound=rl.mfu_bound,
         useful_ratio=rl.useful_ratio,
         mfu_measured=rl.model_flops_total / (
             PEAKS_FLOPS[cfg.compute_dtype] * measured / 1e3),
         peak_gb=peak / 1e9, peak_gb_est=meta.peak_bytes_est / 1e9,
         argument_gb=meta.argument_bytes / 1e9,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# phase 38: the mesh over processes
# ---------------------------------------------------------------------------


PROC_STEPS = 3
PROC_LOSS_REL = 1e-3      # at two ranks or more: another summation order
PROC_TIMEOUT_S = 600      # a rank still running then fails the phase
# the CPU cases that phase 38 leaves to the card: phases 41 and 42 run
# the CPU cases whose routes phases 39-44 run on this machine at full
# width: the dense family's tensor-parallel and FSDP steps, the MoE and
# MLA steps over processes, the MoE family under FSDP, the
# expert-parallel route's steps (phases 41 and 43; on this
# machine's CPU they took ~36 s, ~35 s, ~20 s, ~25 s and ~20 s, which the
# run's time cannot hold; the CPU tests hold them at every commit), the
# MoE step in micro-batches (phases 41 and 43's (2,2) steps; ~25 s) and
# the other families under FSDP (phase 44's (4,1) steps)
CARD_CASES = ("tp_train", "fsdp_train", "moe_train", "mla_train",
              "mla_fsdp", "mla_fsdp_serve", "ep_train", "ep_serve",
              "moe_micro", "families_fsdp")


def _process_cases():
    """``tests/torch_process_cases.py``: the CPU cases, and ``run_ranks``,
    which spawns the ranks of both halves of phase 38."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_process_cases
    return torch_process_cases


def _nccl_profile(step_fn, state, batch):
    """One more step of ``step_fn`` under ``torch.profiler``: the events
    whose name says NCCL, with their calls and device microseconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    return {e.key: {"calls": e.count, "device_us": getattr(
        e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)}
        for e in prof.key_averages() if "nccl" in e.key.lower()}


def _dp_rank(rank, world, store, out_path):
    """A rank of phase 38's NCCL data-parallel step (module level: it is
    pickled by ``spawn``); rank 0 writes the results to ``out_path``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(world, 1, device="cuda",
                             init_method=f"file://{store}", rank=rank,
                             world_size=world, timeout_s=PROC_TIMEOUT_S)
    cfg, opt = _train_cfgs()
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    trainer = Trainer(cfg, opt, data,
                      TrainerConfig(steps=PROC_STEPS, log_every=1),
                      mesh=mesh, device=DEV)
    stamps, rows, peaks = [], [], []

    def on_step(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        rows.append(m)
        if len(rows) == 1:      # the first step's, with the state's init
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()            # the data-parallel path starts here
    compat.reset_counts()
    stamps.append(time.perf_counter())
    _, state = trainer.run(on_step=on_step)
    launches = dict(att.LAUNCHES)   # read right after it
    counts = compat.read_counts(reduce=True)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    every = [None] * world
    dist.all_gather_object(every, (launches, peak, peaks[0]))
    params = [t.cpu() for t in tree_leaves(state["params"])] \
        if rank == 0 else None
    batch = to_device(trainer.batch(PROC_STEPS), DEV)
    prof = _nccl_profile(trainer.step_fn, state, batch)
    del state, trainer, batch
    free_memory()
    if rank == 0:
        # phase 7's one-device step on the same state and batches
        gen = torch.Generator(device=DEV).manual_seed(0)
        p = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                        device=DEV)
        one = {"params": p, "opt": adamw.init(opt, p)}
        step_fn = make_train_step(cfg, opt).step_fn
        source = SyntheticLM(data)
        torch.cuda.reset_peak_memory_stats()
        one_losses, one_ms = [], []
        for i in range(PROC_STEPS):
            b = to_device(source.batch(i), DEV)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            one, m = step_fn(one, b)
            one_losses.append(float(m["loss"]))
            one_ms.append(1e3 * (time.perf_counter() - t1))
        one_peak = torch.cuda.max_memory_allocated()
        same = [torch.equal(a, b.cpu()) for a, b in
                zip(params, tree_leaves(one["params"]))]
        gap = max(float((a.double() - b.cpu().double()).abs().max())
                  for a, b in zip(params, tree_leaves(one["params"])))
        out = {"world": world, "backend": dist.get_backend(),
               "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
               "losses": [r["loss"] for r in rows],
               "grad_norms": [r["grad_norm"] for r in rows],
               "one_device_losses": one_losses, "step_ms": step_ms,
               "steady_step_ms": statistics.mean(step_ms[1:]),
               "one_device_step_ms": one_ms,
               "one_device_steady_step_ms": statistics.mean(one_ms[1:]),
               "one_device_peak_gb": one_peak / 1e9,
               "launches_by_rank": [e[0] for e in every],
               "peak_gb_by_rank": [e[1] / 1e9 for e in every],
               "first_step_peak_gb_by_rank": [e[2] / 1e9 for e in every],
               "collectives": counts, "params_bit_equal": all(same),
               "leaves_bit_equal": sum(same), "leaves": len(same),
               "params_max_gap": gap, "profile": prof}
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier(device_ids=[mesh.device.index])
    dist.destroy_process_group()


def phase_mesh_processes(smi):
    """Phase 38: the mesh over processes (``launch/mesh.py::
    make_process_mesh``, ``core/compat.py``'s process route). (a) NCCL at
    ``torch.cuda.device_count()`` ranks, spawned: tinyllama-1.1b as phase 7
    trains it (full width and depth, 4 x 2048 global, bf16 compute, full
    remat) for 3 steps through ``Trainer(mesh=make_process_mesh(n, 1,
    device="cuda"))``, the path ``torchrun ... -m repro_torch.launch.train
    --data n --model 1`` takes: each rank its block of the batch, one
    gradient pmean a leaf. At one rank the losses and the final parameters
    are bit-equal to phase 7's one-device step on the same state and
    batches (run on rank 0 after it), at more the losses within
    PROC_LOSS_REL; B3-B5 launch exactly ``train_launches`` a step on every
    rank (the returned count sums the ranks); ms a step, tokens/s and peak
    memory beside phase 7's; the collectives by kind (bytes summed over
    the ranks); the NCCL version and the backend the group reports; what
    ``torch.profiler`` shows of NCCL in one more step; the peak memory
    of steps 2-3 and, apart, of the first (with the state's init). (b)
    gloo on the CPU at 4 ranks: every case of
    ``tests/torch_process_cases.py`` but ``CARD_CASES`` (the collectives,
    each body against the stacked route, the data-parallel step on
    reduced tinyllama-1.1b against the one-device step), held by its
    ``check``. Returns the NCCL path's attention launches, summed over
    the ranks."""
    t0 = time.perf_counter()
    free_memory()
    pc = _process_cases()
    world = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="mesh_processes_")
    try:
        out_path = os.path.join(tmp, "dp.json")
        pc.run_ranks(_dp_rank, world, (world, os.path.join(tmp, "store"),
                                       out_path), PROC_TIMEOUT_S)
        with open(out_path) as f:
            dp = json.load(f)
        nccl_s = time.perf_counter() - t0
        cfg, _ = _train_cfgs()
        per_step = train_launches(cfg)
        # every rank runs the whole model on its block of the batch
        for r in dp["launches_by_rank"]:
            assert r == {k: PROC_STEPS * v for k, v in per_step.items()}, \
                (dp["launches_by_rank"], per_step)
        launches = {k: sum(r[k] for r in dp["launches_by_rank"])
                    for k in per_step}
        assert all(np.isfinite(x) for x in dp["losses"]), dp
        phase7 = RECORD.get("train", {})
        if world == 1:
            assert dp["losses"] == dp["one_device_losses"], dp
            assert dp["params_bit_equal"], dp
            if phase7:
                assert dp["one_device_losses"] == \
                    phase7["losses"][:PROC_STEPS], (dp, phase7)
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                dp["losses"], dp["one_device_losses"]))
            assert rel < PROC_LOSS_REL, dp
        pmean = dp["collectives"]["pmean"]      # a leaf and the metrics
        assert pmean["calls"] == PROC_STEPS * (dp["leaves"] + 1), dp
        emit("mesh_processes", gpu=smi, arch=cfg.name, ranks=world,
             backend=dp["backend"], nccl_version=dp["nccl_version"],
             batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=PROC_STEPS,
             losses=dp["losses"], grad_norms=dp["grad_norms"],
             one_device_losses=dp["one_device_losses"],
             params_bit_equal=dp["params_bit_equal"],
             params_max_gap=dp["params_max_gap"],
             step_ms=dp["step_ms"], steady_step_ms=dp["steady_step_ms"],
             tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
             / (dp["steady_step_ms"] / 1e3),
             peak_gb_by_rank=dp["peak_gb_by_rank"],
             first_step_peak_gb_by_rank=dp["first_step_peak_gb_by_rank"],
             one_device_steady_step_ms=dp["one_device_steady_step_ms"],
             one_device_peak_gb=dp["one_device_peak_gb"], phase7=phase7,
             launches=launches, launches_per_step=per_step,
             collectives=dp["collectives"], profile=dp["profile"],
             seconds=nccl_s)

        t1 = time.perf_counter()
        gloo_dir = os.path.join(tmp, "gloo")
        os.makedirs(gloo_dir)
        cases = [c for c in pc.CASES if c not in CARD_CASES]
        res = pc.spawn(gloo_dir, cases=cases, timeout_s=PROC_TIMEOUT_S)
        errs = {name: pc.check(name, res[name]) for name in cases}
        emit("mesh_processes_gloo", ranks=pc.WORLD, backend="gloo",
             torch=torch.__version__, cases=cases, max_err=errs,
             tolerances=pc.TOL, seconds=time.perf_counter() - t1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 39: tensor parallelism over processes
# ---------------------------------------------------------------------------


# the model axis: (1, m) ranks sharing the one card; (1, 2) is cut since
# phase 44 (its time pays for phase 44's job; a model axis of 2 stays held
# by the (2, 2) jobs of phases 40, 41 and 43)
TP_MODELS = (4,)
TP_STEPS = 2
TP_LOSS_REL = 2e-3        # bf16 compute: the partial sums' own rounding
# ... and the grad norm's, held where the gradients are resolvable: at the
# configured init the stack is chaotic (phase 8: two summation orders of
# the float64 step at 22 layers read gradients 1.33 of their max apart),
# so it is held on the conditioned parameters (``_conditioned``)
TP_GRAD_REL = 2e-2
TP_FP32_LAYERS = 2        # the float32 witness, full width
# ... its sequences (x TRAIN_BATCH rows, or MLA_BATCH): half of
# TRAIN_SEQ, since PR 32 for every witness (deepseek-v3's since PR 31)
WITNESS_SEQ = 1024
TP_FP32_REL = 1e-5
TP_TIMEOUT_S = 600


MESH_LAYERS = 2           # phases 39-40: the depth their checks need


def _mesh_cfgs():
    """Phase 7's model and optimizer (:func:`_train_cfgs`) cut to
    ``MESH_LAYERS`` of tinyllama-1.1b's 22 layers: what phases 39 and 40
    train (their checks do not depend on depth; the run's time does)."""
    cfg, opt = _train_cfgs()
    return dataclasses.replace(cfg, n_layers=MESH_LAYERS), opt


def _tp_one_device(cfg, opt, data):
    """The one-device trainer's steps (phase 7's state and batches):
    (metrics log, final state)."""
    one = Trainer(cfg, opt, data, TrainerConfig(steps=TP_STEPS, log_every=1),
                  device=DEV)
    _, state = one.run()
    return one.metrics_log, state


def _conditioned_blocks(cfg, tr, mesh):
    """The seeded init of ``cfg`` (phase 7's), ``_conditioned``, and the
    rank's blocks of it: (global parameters, blocks)."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    whole = _conditioned(init_params(model_template(cfg), gen,
                                     dtype=cfg.param_dtype, device=DEV), cfg)
    return whole, shard_params(whole, tr.state_specs["params"], mesh)


def _logged_step(step_fn, state, batch):
    """``step_fn(state, batch)`` with its one-hot dispatches recorded:
    (state, metrics, the ``moe.DISPATCH_LOG`` list)."""
    log = moe_mod.DISPATCH_LOG = []
    try:
        state, m = step_fn(state, batch)
    finally:
        moe_mod.DISPATCH_LOG = None
    return state, m, log


def _on_rank0(tree, specs, mesh):
    """``tree``'s blocks (``specs``: the sanitized global specs) gathered
    leaf by leaf to rank 0 (every rank takes part): the whole tree on rank
    0, None on the others. A leaf that no axis cuts is rank 0's own block;
    the blocks of the others go through the host to rank 0 alone (gloo's
    ``gather`` over the ranks that tile the leaf with it), where an
    all-gather (``gather_params``) moves every block to every rank."""
    import torch.distributed as dist

    def leaf(x, spec):
        entries = tuple(spec) + (None,) * (x.dim() - len(spec))
        axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and any(
            a in compat.entry_axes(e) for e in entries))
        if not axes:
            return x.clone() if mesh.rank == 0 else None
        group, ranks = mesh.group(axes)
        if 0 not in ranks:
            return None
        block = x.detach().cpu().contiguous()
        parts = [torch.empty_like(block) for _ in ranks] \
            if mesh.rank == 0 else None
        dist.gather(block, parts, dst=0, group=group)
        if mesh.rank != 0:
            return None
        shape = [k * math.prod(mesh.shape[a] for a in compat.entry_axes(e))
                 for k, e in zip(block.shape, entries)]
        out = block.new_empty(shape)
        for r, part in zip(ranks, parts):
            out[NamedSharding(mesh, spec).block_index(shape, r)] = part
        return out.to(x.device)
    return tree_map(leaf, tree, specs)


def _routes(mesh, log, one_log):
    """A MoE witness step's routes and drops, on rank 0 (None elsewhere;
    every rank takes part): each rank's dropped pairs, the (token, expert)
    pairs of its routes that the one-device step (``one_log``, rank 0's)
    did not choose for the same tokens, the one-device step's drops, its
    drops by data block and its pairs (over its MoE layers)."""
    import torch.distributed as dist
    pc = _process_cases()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (moe_mod.dropped_pairs(log),
                                   mesh.block(("data",)),
                                   [d.ids.cpu() for d in log]))
    if mesh.rank != 0:
        return None
    n = mesh.shape["data"]
    return {"drops_by_rank": [e[0] for e in every],
            "flips_by_rank": [sum(pc.route_flips(ids, d.ids.reshape(
                n, -1, d.ids.shape[-1])[block]) for ids, d in zip(
                    mine, one_log)) for _, block, mine in every],
            "drops_one": moe_mod.dropped_pairs(one_log),
            "pairs_one": sum(d.pairs for d in one_log),
            "drops_one_by_block": pc.drops_by_block(one_log, n)}


def _ep_routes(mesh, log, stacked_log):
    """A MoE witness step's routes and drops on the expert-parallel route,
    on rank 0 (None elsewhere; every rank takes part): each rank's dropped
    pairs (its own pairs without a send slot and the rows it received
    without an expert slot), those of its device on the stacked route
    (``stacked_log``, rank 0's), the (token, expert) pairs of each rank's
    routes that its device there did not choose for the same tokens, and
    the stacked step's drops and pairs."""
    import torch.distributed as dist
    pc = _process_cases()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (moe_mod.dropped_pairs(log),
                                   mesh.block(mesh.axis_names),
                                   [d.ids.cpu() for d in log]))
    if mesh.rank != 0:
        return None
    by_device = pc.ep_drops(stacked_log)
    return {"drops_by_rank": [e[0] for e in every],
            "drops_by_device": [by_device.get(dev, 0) for _, dev, _ in every],
            "flips_by_rank": [sum(pc.route_flips(ids, d.ids) for ids, d in zip(
                mine, [d for d in stacked_log if d.device == dev]))
                for _, dev, mine in every],
            "drops_one": moe_mod.dropped_pairs(stacked_log),
            "pairs_one": sum(d.pairs for d in stacked_log)}


class _Clock:
    """The host seconds of each part of a run, each ending in a
    synchronise: ``took(name)`` closes the part begun at the last call (or
    at construction)."""

    def __init__(self):
        self.seconds, self.t0 = {}, time.perf_counter()

    def took(self, part):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.seconds[part], self.t0 = t1 - self.t0, t1


# rank 0's one-device witness steps from the initial state, by their
# inputs (the config but its fsdp, which one device ignores, and the
# batch): a later job of the same spawn on the same inputs is held to them
_WITNESS_ONE: dict = {}


def _tp_fp32_witness(mesh, opt, fsdp=False, cfg=None, batch=None,
                     drop_capacity=None, steps=None, stacked=False):
    """``TP_FP32_LAYERS`` layers of tinyllama-1.1b (or of ``cfg``) at full
    width in float32 compute (TF32 off) from ``_conditioned`` parameters
    (at the configured init, two summation orders of this step read
    gradients 3e-3 of their largest apart: the 4-rank split's partial sums
    do), ``steps`` (default ``TP_STEPS``) tensor-parallel steps of
    ``batch`` (default ``TRAIN_BATCH``) x ``WITNESS_SEQ``, each
    held against the one-device step from the same parameters (gathered to
    rank 0, which runs it; at the initial state rank 0 keeps the init the
    blocks were cut from, and takes the one-device step from
    ``_WITNESS_ONE`` where an earlier job ran it): per step both steps'
    loss and grad norm, and the seconds of each part.
    For a MoE model, per step also each rank's routes and drops against the
    one-device step's (:func:`_routes`); with ``drop_capacity``, first one
    more step from the same initial state at that capacity factor, whose
    one group drops pairs (its row first, ``capacity_factor`` set). With
    ``stacked`` (a MoE model on (d, m), m > 1) the witness
    takes the expert-parallel route (``DENSE_PATH_MAX_TOKENS`` lowered to
    its tokens) and rank 0 runs the stacked route's step on a mesh of the
    same shape in place of the one-device step, whose per-lane capacities
    and per-device aux loss are the route's (the routes and drops by
    device: :func:`_ep_routes`)."""
    cfg = cfg or _mesh_cfgs()[0]
    cfg = dataclasses.replace(cfg, n_layers=TP_FP32_LAYERS,
                              compute_dtype="float32", fsdp=fsdp)
    data = DataConfig(seq_len=WITNESS_SEQ,
                      global_batch=batch or TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=TP_STEPS), mesh=mesh,
                 device=DEV)

    def initial():
        """The initial state's blocks, and on rank 0 the whole state (the
        init the blocks were cut from: no gather)."""
        whole, blocks = _conditioned_blocks(cfg, tr, mesh)
        whole = None if mesh.rank else {"params": whole,
                                         "opt": adamw.init(opt, whole)}
        free_memory()
        return {"params": blocks, "opt": adamw.init(opt, blocks)}, whole
    runs = [(cfg, i, tr.step_fn) for i in range(steps or TP_STEPS)]
    if drop_capacity is not None:
        drop = with_capacity(cfg, drop_capacity)
        runs.insert(0, (drop, 0, Trainer(drop, opt, data, TrainerConfig(
            steps=1), mesh=mesh, device=DEV).step_fn))
    rows, state = [], None
    gate = _process_cases().ep_gate(data.global_batch * WITNESS_SEQ) \
        if stacked else contextlib.nullcontext()
    ref_ctx = MeshCtx(mesh=make_mesh(*mesh.sizes), batch_axes=("data",)) \
        if stacked else None
    with gate:
        for c, i, step_fn in runs:
            clock = _Clock()
            if i == 0:      # the drop step too starts from the initial state
                state = None
                state, whole = initial()
            else:
                # the one-device step's loss, grad norm and routes read its
                # parameters alone (the update, which would read the moments,
                # is not kept): the ranks' parameters beside fresh moments
                whole = _on_rank0(state["params"], tr.state_specs["params"],
                                  mesh)
                whole = None if mesh.rank else {"params": whole,
                                                 "opt": adamw.init(opt, whole)}
            clock.took("state")
            state, m, log = _logged_step(step_fn, state,
                                         to_device(tr.batch(i), DEV))
            free_memory()
            row = {"tp": {k: float(m[k]) for k in ("loss", "grad_norm")}}
            clock.took("step")
            one_log = []
            if mesh.rank == 0:
                key = repr((dataclasses.replace(c, fsdp=False), opt,
                            data)) if i == 0 and not stacked else None
                if key not in _WITNESS_ONE:
                    # the step returns the whole state it updated: not kept
                    m1, one_log = _logged_step(
                        make_train_step(c, opt, ref_ctx).step_fn, whole,
                        to_device(tr.source.batch(i), DEV))[1:]
                    m1 = {k: float(m1[k]) for k in ("loss", "grad_norm")}
                    if key is not None:
                        _WITNESS_ONE[key] = m1, one_log
                else:
                    m1, one_log = _WITNESS_ONE[key]
                row["one"] = m1
            clock.took("one_device")
            if cfg.is_moe:
                routes = (_ep_routes if stacked else _routes)(mesh, log,
                                                              one_log)
                if routes is not None:
                    row.update(routes, capacity_factor=c.moe.capacity_factor)
            del whole, log, one_log
            free_memory()
            clock.took("routes")
            rows.append(dict(row, seconds=clock.seconds))
    del state
    free_memory()
    return rows


def _conditioned_tp_step(mesh, opt, cfg, batch=None):
    """One tensor-parallel step of ``cfg`` from ``_conditioned`` parameters
    (the seeded init of :func:`_conditioned_blocks`), on every rank: its
    loss, grad norm and ms (host clock, the init not counted). The
    one-device step from the same parameters is
    :func:`_conditioned_one_step`'s (``batch`` rows, ``TRAIN_BATCH`` by
    default)."""
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=batch or TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=1), mesh=mesh,
                 device=DEV)
    whole, blocks = _conditioned_blocks(cfg, tr, mesh)
    del whole
    free_memory()
    state = {"params": blocks, "opt": adamw.init(opt, blocks)}
    batch = to_device(tr.batch(0), DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = tr.step_fn(state, batch)
    out = {k: float(m[k]) for k in ("loss", "grad_norm")}   # waits for it
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    del blocks, state, tr
    free_memory()
    return out


def _conditioned_one_step(cfg, opt, batch=None):
    """The one-device step of ``cfg`` from the same ``_conditioned``
    parameters and batch as :func:`_conditioned_tp_step`'s: its loss and
    grad norm."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    whole = _conditioned(init_params(model_template(cfg), gen,
                                     dtype=cfg.param_dtype, device=DEV), cfg)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=batch or TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    _, m1 = make_train_step(cfg, opt).step_fn(
        {"params": whole, "opt": adamw.init(opt, whole)},
        to_device(SyntheticLM(data).batch(0), DEV))
    del whole
    free_memory()
    return {k: float(m1[k]) for k in ("loss", "grad_norm")}


def _tp_conditioned(mesh, opt, fsdp=False, cfg=None):
    """One tensor-parallel (with ``fsdp``, FSDP) step of tinyllama-1.1b as
    phases 39-40 train it (bf16 compute, ``MESH_LAYERS``, batch 0), or of
    ``cfg``, from ``_conditioned`` parameters, where the gradients are
    resolvable, and the one-device step from the same state (rank 0,
    before it): both steps' loss and grad norm."""
    cfg = dataclasses.replace(cfg or _mesh_cfgs()[0], fsdp=fsdp)
    out = {}
    if mesh.rank == 0:
        out["one"] = _conditioned_one_step(cfg, opt)
    mesh.barrier()
    out["tp"] = _conditioned_tp_step(mesh, opt, cfg)
    return out


def _tp_job(mesh, one_path, fsdp=False):
    """Phase 39's (or with ``fsdp``, phase 40's) work on one mesh, on every
    rank: tinyllama-1.1b as phases 39-40 train it (:func:`_mesh_cfgs`,
    with ``fsdp=True``) through ``Trainer(mesh=mesh)``, its blocks then
    held against the same slices of the one-device result (``one_path``,
    memory-mapped); then the float32 and conditioned witnesses. Returns
    the results on rank 0, None on the others."""
    import torch.distributed as dist
    cfg, opt = _mesh_cfgs()
    cfg = dataclasses.replace(cfg, fsdp=fsdp)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=TP_STEPS, log_every=1),
                 mesh=mesh, device=DEV)
    stamps = []

    def on_step(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()            # the tensor-parallel path starts here
    compat.reset_counts()
    with att_geometries() as seen:
        stamps.append(time.perf_counter())
        _, state = tr.run(on_step=on_step)
    launches = dict(att.LAUNCHES)   # read right after it
    counts = (compat.read_counts(reduce=True),
              compat.read_counts(reduce=True, backward=True))
    peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    tp_log = tr.metrics_log
    mine = shard_params(torch.load(one_path, mmap=True, weights_only=True),
                        tr.state_specs["params"], mesh)
    gaps = []
    for got, want in zip(tree_leaves(state["params"]),
                         tree_leaves(mine)):
        gap = (got.cpu().double() - want.double()).abs()
        gaps.append((float(gap.max()), float(gap.mean()),
                     float(want.abs().max())))
    shapes = [list(t.shape) for t in tree_leaves(state["params"])]
    del state, tr, mine
    free_memory()
    fp32 = _tp_fp32_witness(mesh, opt, fsdp)
    conditioned = _tp_conditioned(mesh, opt, fsdp)
    geos = sorted([n, g, sq, sk, dd, str(dt)[6:], c, bq, bk]
                  for n, (g, sq, sk, dd, dt, c, bq, bk) in seen)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (launches, peak, gaps, geos, step_ms))
    if mesh.rank != 0:
        return None
    return {"backend": dist.get_backend(), "log": tp_log, "fp32": fp32,
            "conditioned": conditioned,
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "gaps_by_rank": [e[2] for e in every],
            "geometries_by_rank": [e[3] for e in every],
            "step_ms_by_rank": [e[4] for e in every],
            "weight_decay": opt.weight_decay, "shapes": shapes,
            "collectives": counts}


def _card_rank(rank, world, store, jobs, one_path):
    """A rank of phases 39-46 (module level: ``spawn`` pickles it): for
    each ``(kind, shape, out_path)`` of ``jobs`` in turn, in one process
    group, a ``make_process_mesh(*shape, backend="gloo")`` on the card the
    ranks share and its job: "tp" and "fsdp" phases 39-40's
    (:func:`_tp_job`), "moe" phase 41's (:func:`_moe_job`), "mla" and
    "mla_fsdp" phases 42-43's (:func:`_mla_job`), "fsdp_families" phase
    44's (:func:`_families_job`, which reads the one-device record's
    ``FAMILY_ONE_FILE`` beside ``out_path``), "ssm_tp" phase 46's
    (:func:`_ssm_tp_job`, which reads it too), "cross_tp" phase 47's
    (:func:`_cross_tp_job`, the model of its mesh); after the job that holds a
    model of ``ENGINE_FSDP_CARD``, phase 45's engine of it
    (:func:`_engine_fsdp_job`, under ``"engine"``). Rank 0 writes
    each job's results, with the seconds it took, to its ``out_path``. One
    process runs every job of its world: its warm-up (10-14 s in its first
    step on the card) is paid once."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, shape, out_path in jobs:
        t0 = time.perf_counter()
        mesh = make_process_mesh(*shape, device="cuda:0", backend="gloo",
                                 init_method=f"file://{store}", rank=rank,
                                 world_size=world, timeout_s=TP_TIMEOUT_S)
        if kind == "fsdp_families":
            out = _families_job(mesh, out_path)
        elif kind == "ssm_tp":
            out = _ssm_tp_job(mesh, out_path)
        elif kind == "cross_tp":
            out = _cross_tp_job(mesh, out_path)
        elif kind == "moe":
            out = _moe_job(mesh)
        elif kind in ("mla", "mla_fsdp"):
            out = _mla_job(mesh, out_path, fsdp=kind == "mla_fsdp")
        else:
            out = _tp_job(mesh, one_path, fsdp=kind == "fsdp")
        seconds = time.perf_counter() - t0
        # phase 45: the engine of the model whose blocks this job holds
        arch = next((a for a, j, _ in ENGINE_FSDP_CARD
                     if j == (kind, tuple(shape))), None)
        engine = None if arch is None else _engine_fsdp_job(
            arch, mesh, out_path, one_path)
        if rank == 0:
            out.update(world=world, seconds=seconds)
            if engine is not None:
                out["engine"] = engine
            with open(out_path, "w") as f:
                json.dump(out, f)
        mesh.barrier()
        free_memory()
    dist.destroy_process_group()


# the jobs of phases 39-44, 46 and 47 by world size (phase 45's engines run
# at the end of three of them, ``ENGINE_FSDP_CARD``): each world's ranks
# are spawned once and run its jobs in this order (one world of 4 since
# phase 44: the (1, 2) job of phase 39 and its spawn are cut)
CARD_JOBS = ((4, (("tp", (1, 4)), ("fsdp", (4, 1)), ("fsdp", (2, 2)),
                  ("moe", (4, 1)), ("moe", (2, 2)), ("mla", (1, 4)),
                  ("mla_fsdp", (2, 2)), ("fsdp_families", (4, 1)),
                  ("ssm_tp", (1, 4)), ("cross_tp", (1, 4)),
                  ("cross_tp", (2, 2)))),)


def run_card_ranks(tmp, one_path, card_jobs=CARD_JOBS) -> dict:
    """Spawns each world of ``card_jobs`` once (:func:`_card_rank`) with
    ``one_path`` (:func:`one_device_record`'s parameters) under ``tmp``:
    ``{(kind, shape): rank 0's results}``."""
    pc = _process_cases()
    out = {}
    for i, (world, jobs) in enumerate(card_jobs):
        paths = [(kind, shape, os.path.join(
            tmp, f"{kind}{shape[0]}x{shape[1]}.json")) for kind, shape in jobs]
        pc.run_ranks(_card_rank, world, (world, os.path.join(
            tmp, f"store{i}"), paths, one_path), TP_TIMEOUT_S * len(jobs))
        for kind, shape, path in paths:
            with open(path) as f:
                out[kind, shape] = json.load(f)
    return out


def _param_bound(lrs, wd, pmax) -> float:
    """The most two AdamW runs from one state can differ in a parameter
    after steps at learning rates ``lrs``: each step moves it by at most
    ``lr (|m_hat| / sqrt(v_hat) + wd |p|)``, and ``|m_hat| / sqrt(v_hat)``
    is at most 1.0004 over the first two steps (b1 0.9, b2 0.95, by
    Cauchy-Schwarz), so a wrong block (another slice of the init) is far
    above it."""
    return 2 * sum(lrs) * (1.001 + wd * pmax)


def one_device_record(tmp):
    """The one-device steps that phases 39 and 40 hold their ranks
    against: ``TP_STEPS`` of phase 7's model cut to ``MESH_LAYERS``
    (:func:`_mesh_cfgs`) from phase 7's seed and batches: (metrics log,
    the path of its parameters on the host under ``tmp``, seconds)."""
    t0 = time.perf_counter()
    cfg, opt = _mesh_cfgs()
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    one, state = _tp_one_device(cfg, opt, data)
    one_path = os.path.join(tmp, "one_device_params.pt")
    torch.save(tree_map(lambda t: t.cpu(), state["params"]), one_path)
    del state
    free_memory()
    return one, one_path, time.perf_counter() - t0


def phase_mesh_tensor_parallel(smi, one_device=None, spawned=None):
    """Phase 39: tensor parallelism over processes (``train/step.py``'s
    tensor-parallel step: each rank its blocks of every leaf by the
    reference's specs, Megatron's ``copy_to`` / ``reduce_from`` around the
    column- and row-split products, the vocab-split lookup and
    cross-entropy). At each m of ``TP_MODELS``, m ranks spawned on the one
    card in a gloo group (NCCL refuses two ranks on one card;
    ``tools/torch_gloo_cuda_probe.py`` shows what gloo takes on CUDA
    tensors): tinyllama-1.1b as phase 7 trains it (full width, 4 x 2048,
    bf16 compute, full remat), cut to ``MESH_LAYERS`` layers, on (1, m)
    for ``TP_STEPS`` steps through ``Trainer(mesh=make_process_mesh(1, m,
    backend="gloo"))``, from phase 7's seed and batches. Held: the first
    step's loss within ``TP_LOSS_REL`` of the one-device step's (run here
    first, its parameters saved to the host for the ranks to
    memory-map; the grad norms are recorded: at this
    init two summation orders of the same step disagree, phase 8), and on
    ``_conditioned`` parameters one step's loss and grad norm within
    ``TP_LOSS_REL`` and ``TP_GRAD_REL``;
    each rank's blocks within ``_param_bound`` of the same slices of the
    one-device result; B3-B5 ``train_launches`` a step on every rank, at
    ``32 / m`` heads a launch, each held against its plain version at the
    geometry the path launched it at; the collectives' bytes by kind,
    summed over the ranks, equal to ``count_step``'s for the cell on (1,
    m) times m (less the grad norm's scalar all-reduce); a float32 witness
    (2 layers, full width, TF32 off, conditioned) step by step within
    ``TP_FP32_REL``.
    Recorded: ms a step and peak GB on each rank (the ranks share one card
    and its host: no scaling figure), the backend the group reports.
    ``one_device``: :func:`one_device_record`'s result (made here where
    None); ``spawned``: :func:`run_card_ranks`'s results (its own spawns
    here where None). Returns the launches by path, summed over the
    ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    free_memory()
    pc = _process_cases()
    cfg, opt = _mesh_cfgs()
    per_step = train_launches(cfg)
    by_path, results = {}, []
    tmp = tempfile.mkdtemp(prefix="mesh_tensor_parallel_")
    try:
        one, one_path, one_s = one_device or one_device_record(tmp)
        spawned = spawned or run_card_ranks(
            tmp, one_path, [(m, (("tp", (1, m)),)) for m in TP_MODELS])
        for m in TP_MODELS:
            r = spawned["tp", (1, m)]
            spawn_s = r["seconds"]
            assert r["backend"] == "gloo", r["backend"]
            want = {k: TP_STEPS * v for k, v in per_step.items()}
            assert all(x == want for x in r["launches_by_rank"]), r
            launches = {k: sum(x[k] for x in r["launches_by_rank"])
                        for k in per_step}
            heads = cfg.n_heads_padded // m
            seen = {(n, (g, sq, sk, d, getattr(torch, dt), c, bq, bk))
                    for rank_geos in r["geometries_by_rank"]
                    for n, g, sq, sk, d, dt, c, bq, bk in rank_geos}
            geometries = check_path_attention(
                f"tensor_parallel (1, {m})", seen, TRAIN_BATCH, heads,
                390 + m, results)
            tp = r["log"]
            loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(tp, one)]
            grad_rel = [abs(a["grad_norm"] - b["grad_norm"])
                        / abs(b["grad_norm"]) for a, b in zip(tp, one)]
            assert loss_rel[0] <= TP_LOSS_REL, (loss_rel, tp, one)
            cond = r["conditioned"]
            cond_rel = {k: abs(cond["tp"][k] - cond["one"][k])
                        / abs(cond["one"][k]) for k in ("loss", "grad_norm")}
            assert cond_rel["loss"] <= TP_LOSS_REL, cond
            assert cond_rel["grad_norm"] <= TP_GRAD_REL, cond
            lrs = [x["lr"] for x in one]
            worst = 0.0
            for gaps in r["gaps_by_rank"]:
                for mx, _, pmax in gaps:
                    bound = _param_bound(lrs, r["weight_decay"], pmax)
                    assert mx <= bound, (mx, bound, gaps)
                    worst = max(worst, mx / bound)
            fp32_rel = [max(abs(row["tp"][k] - row["one"][k])
                            / abs(row["one"][k])
                            for k in ("loss", "grad_norm"))
                        for row in r["fp32"]]
            assert max(fp32_rel) <= TP_FP32_REL, r["fp32"]
            st = dryrun.count_step(
                cfg, ShapeConfig("train_4x2048", TRAIN_SEQ, TRAIN_BATCH,
                                 "train"), make_mesh(1, m), target="cuda")
            got = pc.by_kind(r["collectives"])
            assert set(got) == {"all-reduce"} == set(
                st.collective_by_kind), (got, st.collective_by_kind)
            step_bytes = got["all-reduce"] / TP_STEPS - pc.norm_bytes(1, m)
            want_bytes = m * st.collective_by_kind["all-reduce"]
            assert abs(step_bytes - want_bytes) <= m, (step_bytes,
                                                       want_bytes)
            steady = [statistics.mean(x[1:]) for x in r["step_ms_by_rank"]]
            emit("mesh_tensor_parallel", gpu=smi, arch=cfg.name,
                 mesh=[1, m], ranks=m, backend=r["backend"],
                 batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TP_STEPS,
                 losses=[x["loss"] for x in tp],
                 one_device_losses=[x["loss"] for x in one],
                 grad_norms=[x["grad_norm"] for x in tp],
                 one_device_grad_norms=[x["grad_norm"] for x in one],
                 loss_rel=loss_rel, grad_norm_rel=grad_rel,
                 conditioned=cond, conditioned_rel=cond_rel,
                 params_worst_over_bound=worst, fp32_witness=r["fp32"],
                 fp32_rel=fp32_rel, launches=launches,
                 launches_per_rank_step=per_step, geometries=geometries,
                 heads_per_launch=heads,
                 collectives=r["collectives"],
                 all_reduce_bytes_per_step=step_bytes,
                 count_step_all_reduce_bytes=want_bytes,
                 step_ms_by_rank=r["step_ms_by_rank"],
                 steady_step_ms_by_rank=steady,
                 peak_gb_by_rank=r["peak_gb_by_rank"],
                 n_layers=cfg.n_layers,
                 reduced={"n_layers": cfg.n_layers, "meshes_cut": [[1, 2]]},
                 block_shapes=r["shapes"], one_device_seconds=one_s,
                 seconds=spawn_s)
            by_path[f"mesh_tensor_parallel (1, {m})"] = launches
            free_memory()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


# ---------------------------------------------------------------------------
# phase 40: FSDP over processes
# ---------------------------------------------------------------------------


FSDP_CARD_MESHES = ((4, 1), (2, 2))   # (data, model): ranks on the one card
FSDP_GRAD_REL = 5e-3      # the conditioned grad norm (phase 39's 5.8e-4)
FSDP_FP32_REL = 1e-6      # the float32 witness, each step from one state


def phase_mesh_fsdp(smi, one_device=None, spawned=None):
    """Phase 40: FSDP over processes (``train/step.py``'s FSDP step: each
    rank its block of every leaf by the reference's specs with
    ``fsdp=True``, every embed dimension over data; each leaf gathered at
    its use inside a layer, again by the checkpoint's recompute for the
    backward, its gradient reduce-scattered, ``core.compat.gather_from``).
    On each mesh of ``FSDP_CARD_MESHES`` its ranks spawned on the one card
    in a gloo group, as phase 39's: tinyllama-1.1b as phase 7 trains it
    (full width, ``MESH_LAYERS`` layers, 4 x 2048, bf16 compute, full
    remat) with
    ``fsdp=True``, ``TP_STEPS`` steps from phase 7's state and batches.
    Held: the first step's loss within ``TP_LOSS_REL`` of the one-device
    step's; on ``_conditioned`` parameters one step's loss and grad norm
    within ``TP_LOSS_REL`` and ``FSDP_GRAD_REL``; each rank's blocks within
    ``_param_bound`` of the same slices of the one-device result; B3-B5
    ``train_launches`` a step on every rank, at the rank's rows and heads,
    each held against its plain version at the geometry the path launched
    it at; the bytes by kind, summed over the ranks, equal to
    ``count_step``'s for the cell on the mesh times the ranks (the
    all-reduces less the loss metrics' mean and the grad norm's scalar);
    a float32 witness (2 layers, full width, TF32 off, conditioned) step
    by step within ``FSDP_FP32_REL``. Recorded: ms a step (gloo's host
    staging and the shared host: no speed figure) and peak GB on each
    rank. ``one_device``: :func:`one_device_record`'s result (made here
    where None); ``spawned``: :func:`run_card_ranks`'s results (one spawn
    of its own here where None). Returns the launches by path, summed
    over the ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    free_memory()
    pc = _process_cases()
    cfg, opt = _mesh_cfgs()
    cfg = dataclasses.replace(cfg, fsdp=True)
    per_step = train_launches(cfg)
    by_path, results = {}, []
    tmp = tempfile.mkdtemp(prefix="mesh_fsdp_")
    try:
        one, one_path, one_s = one_device or one_device_record(tmp)
        n = math.prod(FSDP_CARD_MESHES[0])
        spawned = spawned or run_card_ranks(tmp, one_path, [
            (n, tuple(("fsdp", x) for x in FSDP_CARD_MESHES))])
        for d, m in FSDP_CARD_MESHES:
            r = spawned["fsdp", (d, m)]
            spawn_s = r["seconds"]
            assert r["backend"] == "gloo", r["backend"]
            want = {k: TP_STEPS * v for k, v in per_step.items()}
            assert all(x == want for x in r["launches_by_rank"]), r
            launches = {k: sum(x[k] for x in r["launches_by_rank"])
                        for k in per_step}
            rows, heads = TRAIN_BATCH // d, cfg.n_heads_padded // m
            seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
                    for rank_geos in r["geometries_by_rank"]
                    for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
            geometries = check_path_attention(
                f"fsdp ({d}, {m})", seen, rows, heads, 400 + n, results)
            got_log = r["log"]
            loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(got_log, one)]
            grad_rel = [abs(a["grad_norm"] - b["grad_norm"])
                        / abs(b["grad_norm"]) for a, b in zip(got_log, one)]
            assert loss_rel[0] <= TP_LOSS_REL, (loss_rel, got_log, one)
            cond = r["conditioned"]
            cond_rel = {k: abs(cond["tp"][k] - cond["one"][k])
                        / abs(cond["one"][k]) for k in ("loss", "grad_norm")}
            assert cond_rel["loss"] <= TP_LOSS_REL, cond
            assert cond_rel["grad_norm"] <= FSDP_GRAD_REL, cond
            lrs = [x["lr"] for x in one]
            worst = 0.0
            for gaps in r["gaps_by_rank"]:
                for mx, _, pmax in gaps:
                    bound = _param_bound(lrs, r["weight_decay"], pmax)
                    assert mx <= bound, (mx, bound, gaps)
                    worst = max(worst, mx / bound)
            fp32_rel = [max(abs(row["tp"][k] - row["one"][k])
                            / abs(row["one"][k])
                            for k in ("loss", "grad_norm"))
                        for row in r["fp32"]]
            assert max(fp32_rel) <= FSDP_FP32_REL, r["fp32"]
            st = dryrun.count_step(
                cfg, ShapeConfig("train_4x2048", TRAIN_SEQ, TRAIN_BATCH,
                                 "train"), make_mesh(d, m), target="cuda")
            got = {k: v / TP_STEPS for k, v in pc.by_kind(
                r["collectives"]).items()}
            got["all-reduce"] -= pc.fsdp_extra(d, m)
            want_bytes = {k: n * v for k, v in st.collective_by_kind.items()}
            want_bytes.setdefault("all-reduce", 0)
            assert set(got) == set(want_bytes) and all(
                abs(got[k] - want_bytes[k]) <= n for k in got), (
                    got, want_bytes)
            steady = [statistics.mean(x[1:]) for x in r["step_ms_by_rank"]]
            emit("mesh_fsdp", gpu=smi, arch=cfg.name, mesh=[d, m], ranks=n,
                 backend=r["backend"], batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                 steps=TP_STEPS, losses=[x["loss"] for x in got_log],
                 one_device_losses=[x["loss"] for x in one],
                 grad_norms=[x["grad_norm"] for x in got_log],
                 one_device_grad_norms=[x["grad_norm"] for x in one],
                 loss_rel=loss_rel, grad_norm_rel=grad_rel,
                 conditioned=cond, conditioned_rel=cond_rel,
                 params_worst_over_bound=worst, fp32_witness=r["fp32"],
                 fp32_rel=fp32_rel, launches=launches,
                 launches_per_rank_step=per_step, geometries=geometries,
                 rows_per_launch=rows, heads_per_launch=heads,
                 collectives=r["collectives"], bytes_per_step=got,
                 count_step_bytes=want_bytes,
                 step_ms_by_rank=r["step_ms_by_rank"],
                 steady_step_ms_by_rank=steady,
                 peak_gb_by_rank=r["peak_gb_by_rank"],
                 n_layers=cfg.n_layers,
                 block_shapes=r["shapes"], one_device_seconds=one_s,
                 seconds=spawn_s)
            by_path[f"mesh_fsdp ({d}, {m})"] = launches
            free_memory()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


# ---------------------------------------------------------------------------
# phase 41: the MoE train step over processes
# ---------------------------------------------------------------------------


MOE_MESH_LAYERS = 2       # of granite-moe-3b-a800m's 32
MOE_CARD_MESHES = ((4, 1), (2, 2))    # (data, model): ranks on the one card
# the first step's loss, ce and aux against the one-device step's: on (4,1)
# each rank runs the one-device step's products on its rows (another GEMM
# height), on (2,2) the model axis splits the partial sums (bf16)
MOE_LOSS_REL = {(4, 1): 1e-4, (2, 2): TP_LOSS_REL}
# the micro-batches of each mesh's Trainer run: on (2,2) two of 2 x 2048,
# one row a rank, each micro-batch one dispatch group of 4096 tokens (the
# ranks' strips their blocks of it, ``train.step.micro_major``)
MOE_ACCUM = {(4, 1): 1, (2, 2): 2}
# the float32 witness's step at a capacity factor whose one group drops
# pairs (from the initial state, where the routes agree); the share of a
# step's (token, expert) pairs whose route may flip between a rank's
# router product and the one-device step's (a near-tie rounded another
# way), and the loss and grad-norm gap of a step with such a flip, in
# place of TP_FP32_REL. Read: granite (4,1)'s third step flips 1 pair of
# its 131,072 (7.6e-6) at a gap of 9.8e-6; the CPU case on (4,1) with the
# ranks' router input rounded to bfloat16 (a fault) flips 1 pair of its
# 1,024 (9.8e-4) at a gap of 6.8e-4
DROP_CAPACITY = 0.5
# phase 41's witnesses: the drop step and one step from the initial state
# (the step after it, from the gathered state, is phase 42's second
# witness step's check, and the CPU cases' in float64): paid for the
# micro-batch steps of phases 41 and 43
MOE_WITNESS_STEPS = 1
FLIP_SHARE = 2.5e-5
FLIP_REL = 3e-5


def check_witness(rows, d, m):
    """A MoE float32 witness (:func:`_tp_fp32_witness` with a drop step)
    on (d, m): each step whose ranks' routes all agree with the one-device
    step's is held within ``TP_FP32_REL`` (loss and grad norm), each
    rank's drops equal to the
    one-device step's drops of its data block (the ranks of a data
    coordinate route the same tokens) and their sum to its drops (on the
    expert-parallel route, each rank's drops those of its device on the
    stacked route); a step
    with flipped routes is held to at most ``FLIP_SHARE`` of its pairs
    flipped and within ``FLIP_REL``; the drop step's routes agree and it
    drops pairs (above 0); some regular step's routes agree. Returns the
    gaps and the flipped pairs a step."""
    rel, flips = [], []
    for row in rows:
        gap = max(abs(row["tp"][k] - row["one"][k]) / abs(row["one"][k])
                  for k in ("loss", "grad_norm"))
        n = sum(row["flips_by_rank"])
        rel.append(gap)
        flips.append(n)
        if n:
            assert n <= FLIP_SHARE * row["pairs_one"] \
                and gap <= FLIP_REL, row
            continue
        assert gap <= TP_FP32_REL, row
        if "drops_by_device" in row:    # the expert-parallel route's
            assert row["drops_by_rank"] == row["drops_by_device"] \
                and sum(row["drops_by_rank"]) == row["drops_one"], row
            continue
        by_data = [row["drops_by_rank"][i:i + m] for i in range(0, d * m, m)]
        assert [b[0] for b in by_data] == row["drops_one_by_block"] \
            and all(b == b[:1] * m for b in by_data), row
        assert sum(row["drops_one_by_block"]) == row["drops_one"], row
    drop = rows[0]
    assert drop["capacity_factor"] == DROP_CAPACITY and flips[0] == 0 \
        and drop["drops_one"] > 0, drop
    assert 0 in flips[1:], flips
    return rel, flips


# phase 41's expert-parallel step: 16 x TRAIN_SEQ in EP_ACCUM micro-batches
# of 16,384 global tokens, the reference's own gate (nothing lowered): 48
# padded experts over 2 lanes on (2,2), 4096 tokens a rank a micro-batch
# in one chunk
EP_BATCH = 16
EP_ACCUM = 2


def _ep_step(mesh, cfg, opt, rows, gate=None, grad_accum=1, seq=None):
    """One train step of ``cfg`` through ``Trainer(mesh=mesh)`` at ``rows``
    x ``seq`` (default ``TRAIN_SEQ``) global tokens in ``grad_accum``
    micro-batches, each on the expert-parallel route (``gate``:
    ``DENSE_PATH_MAX_TOKENS`` lowered to it; None: the reference's own),
    counted by :func:`_moe_run`, with the payloads that ``compat``'s
    counts leave out recorded (the process cases' ``uncounted_recorder``).
    On rank 0: its metrics, and by rank the attention kernels' launches
    and geometries, peak bytes, ms, drops, those payloads, and the rank's
    experts (``held_experts``) beside the block of the experts that the
    reference's spec gives it (where the model axis splits the experts);
    the collectives (forward, backward) summed over the ranks. None on the
    others."""
    import torch.distributed as dist
    from repro_torch.train.step import make_train_state_abstract
    pc = _process_cases()
    seq = seq or TRAIN_SEQ
    data = DataConfig(seq_len=seq, global_batch=rows,
                      vocab_size=cfg.vocab_size, seed=0)
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=1, log_every=1,
                                               grad_accum=grad_accum),
                 mesh=mesh, device=DEV)
    experts = None
    if cfg.moe.expert_parallel:
        table = make_train_state_abstract(cfg, opt)["params"]["layers"][
            "moe"]["w_gate"].shape
        spec = tr.state_specs["params"]["layers"]["moe"]["w_gate"]
        block = NamedSharding(mesh, spec).block_index(table)[1]
        held = held_experts(cfg, tensor_parallel(cfg, tr.ctx))
        experts = [[held.start, held.stop], [block.start, block.stop]]
    with pc.ep_gate(gate or moe_mod.DENSE_PATH_MAX_TOKENS), \
            pc.uncounted_recorder() as uncounted:
        assert moe_mod.ep_route(cfg, tr.ctx, rows * seq // grad_accum), (
            cfg, rows, seq, grad_accum)
        log, launches, seen, counts, peak, step_ms, drops = _moe_run(tr)
    del tr
    free_memory()
    geos = sorted([n, g, sq, sk, d, str(dt)[6:], c, bq, bk]
                  for n, (g, sq, sk, d, dt, c, bq, bk) in seen)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (launches, peak, geos, step_ms, drops,
                                   dict(uncounted), experts))
    if mesh.rank != 0:
        return None
    return {"log": log, "collectives": counts,
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "geometries_by_rank": [e[2] for e in every],
            "step_ms_by_rank": [e[3] for e in every],
            "drops_by_rank": [e[4] for e in every],
            "uncounted_by_rank": [e[5] for e in every],
            "experts_by_rank": [e[6] for e in every]}


def _hold_ep(smi, phase, r, cfg, shape, rows, gate, seed, results,
             grad_accum=1, seq=None):
    """The checks of an expert-parallel step (:func:`_ep_step`'s rank-0
    results ``r``) of ``cfg`` on ``shape`` at ``rows`` x ``seq`` (default
    ``TRAIN_SEQ``) in ``grad_accum`` micro-batches (``gate``: as there),
    and its line: a finite loss; B3-B5 ``train_launches`` a micro-batch
    on every rank, at the geometry of the rank's rows of a micro-batch
    and its heads, each held against its plain version there; 3
    ``all_to_all`` a chunk a MoE layer a pass a micro-batch, and the
    re-lay's 3 a MoE layer a pass a micro-batch where the model axis
    splits the experts' FFN (their backward: 2 a chunk and 3 a layer);
    the bytes by kind summed over the ranks equal to
    ``count_step``'s for the cell at the same gate in as many
    micro-batches times the ranks (the all-reduces less the grad norm's
    scalar and the loss metrics' mean; in micro-batches the batch's
    micro-major all-gathers among them); each rank's experts the block
    the reference's spec gives it; the payloads the counts leave out,
    the same calls on every rank, a micro-batch (the EP body's output
    gathered over model in the forward and again in a checkpoint's
    recompute where the recompute runs past it, which it ends once its
    saved tensors are back: granite's does not, deepseek's shared expert
    does; its tokens' gradient gathered once; the router's gradient
    summed over model once). Returns the launches by path, summed over
    the ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    pc = _process_cases()
    seq = seq or TRAIN_SEQ
    d, m = shape
    n = d * m
    per_step = {k: grad_accum * v for k, v in train_launches(cfg).items()}
    assert all(x == per_step for x in r["launches_by_rank"]), r
    launches = {k: sum(x[k] for x in r["launches_by_rank"])
                for k in per_step}
    assert all(np.isfinite(x["loss"]) for x in r["log"]), r["log"]
    seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
            for rank_geos in r["geometries_by_rank"]
            for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
    rows_rank, heads = rows // d // grad_accum, cfg.n_heads_padded // m
    geometries = check_path_attention(f"{phase} {shape}", seen, rows_rank,
                                      heads, seed, results)
    passes = 2 if cfg.remat == "full" else 1
    n_moe = (cfg.n_layers - cfg.moe.n_dense_layers) * grad_accum
    chunks = -(-(rows * seq // grad_accum // n) // moe_mod.EP_CHUNK_TOKENS)
    relay = 0 if cfg.moe.expert_parallel else 3
    fwd, bwd = r["collectives"]
    assert fwd["all_to_all"]["calls"] == (3 * chunks + relay) * n_moe \
        * passes and bwd["all_to_all"]["calls"] == (2 * chunks + relay) \
        * n_moe, (fwd, bwd)
    with pc.ep_gate(gate or moe_mod.DENSE_PATH_MAX_TOKENS):
        st = dryrun.count_step(cfg, ShapeConfig("train", seq, rows, "train"),
                               make_mesh(d, m), target="cuda",
                               grad_accum=grad_accum)
    got = pc.by_kind(r["collectives"])
    metrics = 4 if cfg.mtp_depth else 3
    got["all-reduce"] -= pc.fsdp_extra(d, m, metrics) if cfg.fsdp \
        else pc.norm_bytes(d, m) + pc.metric_bytes(metrics, 4, d) * m
    want = {k: n * v for k, v in st.collective_by_kind.items()}
    assert set(got) == set(want) and all(
        abs(got[k] - want[k]) <= n for k in got), (got, want)
    if cfg.moe.expert_parallel:
        # (held experts, the spec's block) by rank, the blocks tiling them
        assert all(held == block for held, block in r["experts_by_rank"]) \
            and sorted(e[0] for e in r["experts_by_rank"])[::d] == [
                [i * cfg.moe.n_experts // m, (i + 1) * cfg.moe.n_experts
                 // m] for i in range(m)], r["experts_by_rank"]
    unc = r["uncounted_by_rank"]
    calls = [{k: v[0] for k, v in u.items()} for u in unc]
    assert all(c == calls[0] for c in calls) and calls[0]["all_reduce"] \
        == n_moe and 2 * n_moe <= calls[0]["all_gather"] \
        <= (passes + 1) * n_moe, unc
    emit(phase, gpu=smi, arch=cfg.name, mesh=list(shape), ranks=n,
         n_layers=cfg.n_layers, batch=rows, seq_len=seq,
         grad_accum=grad_accum, tokens=rows * seq,
         micro_batch_tokens=rows * seq // grad_accum,
         tokens_per_rank=rows * seq // n,
         reduced={**({"DENSE_PATH_MAX_TOKENS": gate} if gate else {}),
                  **({"seq_len": seq} if seq != TRAIN_SEQ else {})},
         log=r["log"], drops_by_rank=r["drops_by_rank"],
         experts_by_rank=r["experts_by_rank"], launches=launches,
         launches_per_rank_step=per_step, geometries=geometries,
         rows_per_launch=rows_rank, heads_per_launch=heads,
         collectives=r["collectives"], bytes_per_step=got,
         count_step_bytes=want, uncounted_by_rank=unc,
         step_ms_by_rank=r["step_ms_by_rank"],
         peak_gb_by_rank=r["peak_gb_by_rank"])
    return {f"{phase} {shape}": launches}


def _moe_mesh_cfgs():
    """granite-moe-3b-a800m as configured (fp32 parameters, bf16 compute,
    full remat, the attention kernels on the card) cut to
    ``MOE_MESH_LAYERS`` layers, and phase 7's optimizer."""
    cfg = get_config(MOE_ARCH)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat, cfg.attn_flash,
            cfg.moe.expert_parallel) == ("float32", "bfloat16", "full",
                                         "auto", False), cfg
    _, opt = _train_cfgs()
    return dataclasses.replace(cfg, n_layers=MOE_MESH_LAYERS), opt


def _moe_run(tr, micro=None, blocks=0):
    """``tr.run`` with the attention kernels' launches and geometries, the
    collectives and the peak memory counted from 0, and the pairs each
    step's dispatches dropped: (metrics log, launches, geometries seen,
    collectives (forward, backward), peak bytes, ms a step, drops a
    step). ``micro``: a list to which each step appends its drops by
    micro-batch (``tr``'s ``grad_accum`` of them; with ``blocks``, each
    micro-batch's by data block, ``drops_by_block``, where each dispatch
    is one group)."""
    pc = _process_cases()
    stamps, drops, log = [], [], []
    n = tr.tcfg.grad_accum

    def on_step(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        drops.append(moe_mod.dropped_pairs(log))
        if micro is not None:
            micro.append([pc.drops_by_block(part, blocks) if blocks
                          else moe_mod.dropped_pairs(part)
                          for part in pc.micro_strips(log, n)])
        log.clear()

    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()            # the path starts here
    compat.reset_counts()
    moe_mod.DISPATCH_LOG = log
    try:
        with att_geometries() as seen:
            stamps.append(time.perf_counter())
            _, state = tr.run(on_step=on_step)
    finally:
        moe_mod.DISPATCH_LOG = None
    launches = dict(att.LAUNCHES)   # read right after it
    process = compat.is_process_mesh(tr.mesh)
    counts = (compat.read_counts(reduce=process),
              compat.read_counts(reduce=process, backward=True))
    del state
    return (tr.metrics_log, launches, seen, counts,
            torch.cuda.max_memory_allocated(),
            [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])], drops)


def _moe_job(mesh):
    """Phase 41's work on one mesh, on every rank: granite-moe-3b-a800m as
    :func:`_moe_mesh_cfgs` gives it through ``Trainer(mesh=mesh)`` in
    ``MOE_ACCUM`` micro-batches (:func:`_moe_run`), then the float32
    witness (at ``model > 1`` on the expert-parallel route, against the
    stacked route's step), the conditioned step and, at ``model > 1``,
    one step on the expert-parallel route at ``EP_BATCH`` x ``TRAIN_SEQ``
    tokens in ``EP_ACCUM`` micro-batches (:func:`_ep_step`). Returns the
    results on rank 0, None on the others."""
    import torch.distributed as dist
    clock = _Clock()
    cfg, opt = _moe_mesh_cfgs()
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    accum = MOE_ACCUM[mesh.sizes]
    tr = Trainer(cfg, opt, data, TrainerConfig(steps=TP_STEPS, log_every=1,
                                               grad_accum=accum),
                 mesh=mesh, device=DEV)
    micro = []
    log, launches, seen, counts, peak, step_ms, drops = _moe_run(tr, micro)
    del tr
    free_memory()
    clock.took("train")
    ep = mesh.shape["model"] > 1
    fp32 = _tp_fp32_witness(mesh, opt, cfg=cfg, drop_capacity=DROP_CAPACITY,
                            steps=MOE_WITNESS_STEPS, stacked=ep)
    clock.took("witness")
    conditioned = _tp_conditioned(mesh, opt, cfg=cfg)
    clock.took("conditioned")
    ep = _ep_step(mesh, cfg, opt, EP_BATCH, grad_accum=EP_ACCUM) if ep \
        else None
    clock.took("ep")
    geos = sorted([n, g, sq, sk, d, str(dt)[6:], c, bq, bk]
                  for n, (g, sq, sk, d, dt, c, bq, bk) in seen)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (launches, peak, geos, step_ms, drops,
                                   micro))
    if mesh.rank != 0:
        return None
    return {"backend": dist.get_backend(), "log": log, "fp32": fp32,
            "conditioned": conditioned, "ep": ep, "grad_accum": accum,
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "geometries_by_rank": [e[2] for e in every],
            "step_ms_by_rank": [e[3] for e in every],
            "drops_by_rank": [e[4] for e in every],
            "micro_drops_by_rank": [e[5] for e in every],
            "collectives": counts, "part_s": clock.seconds}


def phase_mesh_moe(smi, spawned=None):
    """Phase 41: the MoE family's train step over processes
    (``models/moe.py``'s one-hot dispatch with its group and Switch aux
    loss over the global batch: each rank gathers the others' per-expert
    counts and claims its slots after theirs; at ``model > 1`` each
    expert's FFN split over the ranks between Megatron's ``copy_to`` /
    ``reduce_from``). granite-moe-3b-a800m at full width (d_model 1536, 32
    padded heads of 64, 8 kv heads, 40 experts padded to 48, top 8,
    expert FFN 512, vocab 49155, so the table whole on every rank),
    ``MOE_MESH_LAYERS`` of its 32 layers, as phase 7 trains (fp32
    parameters, bf16 compute, full remat, AdamW, 4 x 2048: one dispatch
    group of 8192 tokens, capacity 2048): the one-device trainer first (``TP_STEPS`` steps), then on each
    mesh of ``MOE_CARD_MESHES`` its ranks spawned on the one card in a
    gloo group, as phase 39's, ``TP_STEPS`` steps through
    ``Trainer(mesh=make_process_mesh(d, m, backend="gloo"))``. Held: the
    first step's loss, ce and aux within ``MOE_LOSS_REL``; on
    ``_conditioned`` parameters one step's loss within ``TP_LOSS_REL`` and
    grad norm within ``TP_GRAD_REL``; a float32 witness
    (``TP_FP32_LAYERS`` layers, TF32 off, conditioned) step by step
    (:func:`check_witness`: within ``TP_FP32_REL`` where every rank's
    routes agree with the one-device step's, else within ``FLIP_SHARE``
    flipped pairs and ``FLIP_REL``, and a step at ``DROP_CAPACITY`` from the
    initial state whose
    drops are above 0 and each rank's block's); B3-B5 ``train_launches`` a
    step on every rank
    at 1 x 32 (4,1) and 1 x 16 (2,2, a micro-batch) rows x heads a
    launch, each held
    against its plain version at the geometry the path launched it at;
    the pairs each step's dispatches dropped, summed over the data ranks
    (the ranks of a data coordinate route the same tokens), equal to the
    one-device step's, and recorded by rank; the bytes by kind summed over
    the ranks equal to ``count_step``'s for the cell times the ranks (the
    all-reduces less the loss metrics' mean and the grad norm's scalar).
    On (2, 2) the Trainer runs in ``MOE_ACCUM`` micro-batches (each
    rank's its block of the global micro-batch), held against the
    one-device trainer in as many (the first step's loss, ce and aux;
    each rank's drops in each micro-batch those of its data block; the
    bytes against ``count_step(grad_accum=)``'s; B3-B5 at a micro-batch's
    rows), the witness runs on the expert-parallel route against the
    stacked route's step, and one step at ``EP_BATCH`` x ``TRAIN_SEQ`` in
    ``EP_ACCUM`` micro-batches takes the route at the reference's own
    gate in each (:func:`_hold_ep`).
    Recorded: ms a step and peak GB a rank (the ranks share one card and
    its host: no scaling figure), beside the card's name and power limit.
    ``spawned``: :func:`run_card_ranks`'s results (one spawn of its own
    here, before the one-device trainer, where None). Returns the launches
    by path, summed over the ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    free_memory()
    pc = _process_cases()
    cfg, opt = _moe_mesh_cfgs()
    per_step = train_launches(cfg)
    assert per_step == {"flash_fwd": 2 * MOE_MESH_LAYERS,
                        "flash_bwd_dq": MOE_MESH_LAYERS,
                        "flash_bwd_dkv": MOE_MESH_LAYERS}, per_step
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    by_path, results = {}, []
    tmp = tempfile.mkdtemp(prefix="mesh_moe_")
    try:
        n = math.prod(MOE_CARD_MESHES[0])
        spawned = spawned or run_card_ranks(tmp, None, [
            (n, tuple(("moe", x) for x in MOE_CARD_MESHES))])
        free_memory()
        t0 = time.perf_counter()
        one, one_launches, _, _, one_peak, one_ms, one_drops = _moe_run(
            Trainer(cfg, opt, data, TrainerConfig(steps=TP_STEPS,
                                                  log_every=1), device=DEV))
        assert one_launches == {k: TP_STEPS * v
                                for k, v in per_step.items()}, one_launches
        emit("mesh_moe_one_device", gpu=smi, arch=cfg.name,
             n_layers=cfg.n_layers, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
             log=one, drops=one_drops, step_ms=one_ms,
             peak_gb=one_peak / 1e9, seconds=time.perf_counter() - t0)
        free_memory()
        # the one-device trainer in the micro-batches of a mesh's run, the
        # drops of each micro-batch by the mesh's data blocks
        accum_runs = {}
        for d, m in MOE_CARD_MESHES:
            accum = MOE_ACCUM[d, m]
            if accum == 1:
                continue
            t0, micro = time.perf_counter(), []
            got = _moe_run(Trainer(cfg, opt, data, TrainerConfig(
                steps=TP_STEPS, log_every=1, grad_accum=accum),
                device=DEV), micro, blocks=d)
            assert got[1] == {k: accum * TP_STEPS * v
                              for k, v in per_step.items()}, got[1]
            accum_runs[d, m] = {"log": got[0], "micro": micro,
                                "step_ms": got[5], "peak_gb": got[4] / 1e9}
            emit("mesh_moe_one_device_accum", gpu=smi, arch=cfg.name,
                 n_layers=cfg.n_layers, batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, grad_accum=accum, log=got[0],
                 drops=got[6], drops_by_micro_and_block=micro,
                 step_ms=got[5], peak_gb=got[4] / 1e9,
                 seconds=time.perf_counter() - t0)
            free_memory()
        for d, m in MOE_CARD_MESHES:
            r = spawned["moe", (d, m)]
            spawn_s = r["seconds"]
            accum = MOE_ACCUM[d, m]
            assert r["backend"] == "gloo" and r["grad_accum"] == accum, r
            want = {k: TP_STEPS * accum * v for k, v in per_step.items()}
            assert all(x == want for x in r["launches_by_rank"]), r
            launches = {k: sum(x[k] for x in r["launches_by_rank"])
                        for k in per_step}
            rows, heads = TRAIN_BATCH // d // accum, cfg.n_heads_padded // m
            seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
                    for rank_geos in r["geometries_by_rank"]
                    for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
            geometries = check_path_attention(
                f"mesh_moe ({d}, {m})", seen, rows, heads, 410 + n, results)
            got_log = r["log"]
            ref_run = accum_runs[d, m] if accum > 1 else None
            ref_log = ref_run["log"] if ref_run else one
            rel = {k: abs(got_log[0][k] - ref_log[0][k]) / abs(ref_log[0][k])
                   for k in ("loss", "ce", "aux")}
            assert max(rel.values()) <= MOE_LOSS_REL[d, m], (rel, got_log,
                                                             ref_log)
            cond = r["conditioned"]
            cond_rel = {k: abs(cond["tp"][k] - cond["one"][k])
                        / abs(cond["one"][k]) for k in ("loss", "grad_norm")}
            assert cond_rel["loss"] <= TP_LOSS_REL, cond
            assert cond_rel["grad_norm"] <= TP_GRAD_REL, cond
            fp32_rel, flips = check_witness(r["fp32"], d, m)
            # the ranks of one data coordinate route the same tokens
            by_data = [r["drops_by_rank"][i:i + m] for i in range(0, n, m)]
            assert all(b == b[:1] * m for b in by_data), r["drops_by_rank"]
            drops = [sum(b[0][i] for b in by_data) for i in range(TP_STEPS)]
            if ref_run:
                # each rank's drops of each micro-batch: the one-device
                # step's of its data block of that micro-batch
                micro = r["micro_drops_by_rank"]
                assert all(micro[rank][i] == [b[rank // m] for b in blocks]
                           for rank in range(n)
                           for i, blocks in enumerate(ref_run["micro"])), (
                    micro, ref_run["micro"])
                assert drops == [sum(map(sum, x)) for x in ref_run["micro"]]
            else:
                assert drops == one_drops, (drops, one_drops,
                                            r["drops_by_rank"])
            st = dryrun.count_step(
                cfg, ShapeConfig("train_4x2048", TRAIN_SEQ, TRAIN_BATCH,
                                 "train"), make_mesh(d, m), target="cuda",
                grad_accum=accum)
            got = {k: v / TP_STEPS for k, v in pc.by_kind(
                r["collectives"]).items()}
            got["all-reduce"] -= pc.norm_bytes(d, m) \
                + pc.metric_bytes(3, 4, d) * m
            want_bytes = {k: n * v for k, v in st.collective_by_kind.items()}
            assert set(got) == set(want_bytes) and all(
                abs(got[k] - want_bytes[k]) <= n for k in got), (
                    got, want_bytes)
            steady = [statistics.mean(x[1:]) for x in r["step_ms_by_rank"]]
            emit("mesh_moe", gpu=smi, arch=cfg.name, mesh=[d, m], ranks=n,
                 backend=r["backend"], n_layers=cfg.n_layers,
                 batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TP_STEPS,
                 grad_accum=accum, log=got_log, one_device_log=ref_log,
                 first_step_rel=rel,
                 micro_drops_by_rank=r["micro_drops_by_rank"],
                 conditioned=cond, conditioned_rel=cond_rel,
                 fp32_witness=r["fp32"], fp32_rel=fp32_rel,
                 fp32_flips=flips, fp32_limit=TP_FP32_REL,
                 flip_share_limit=FLIP_SHARE, flip_rel_limit=FLIP_REL,
                 witness_reduced={"steps": MOE_WITNESS_STEPS, **(
                     {"DENSE_PATH_MAX_TOKENS": TRAIN_BATCH * WITNESS_SEQ}
                     if m > 1 else {})},
                 drops_by_rank=r["drops_by_rank"], drops=drops,
                 one_device_drops=one_drops, launches=launches,
                 launches_per_rank_step={k: accum * v
                                         for k, v in per_step.items()},
                 geometries=geometries,
                 rows_per_launch=rows, heads_per_launch=heads,
                 collectives=r["collectives"], bytes_per_step=got,
                 count_step_bytes=want_bytes,
                 step_ms_by_rank=r["step_ms_by_rank"],
                 steady_step_ms_by_rank=steady,
                 peak_gb_by_rank=r["peak_gb_by_rank"],
                 one_device_step_ms=ref_run["step_ms"] if ref_run
                 else one_ms, one_device_peak_gb=ref_run["peak_gb"]
                 if ref_run else one_peak / 1e9, part_seconds=r["part_s"],
                 seconds=spawn_s)
            by_path[f"mesh_moe ({d}, {m})"] = launches
            if r["ep"] is not None:
                by_path.update(_hold_ep(smi, "mesh_moe_ep", r["ep"], cfg,
                                        (d, m), EP_BATCH, None, 415, results,
                                        grad_accum=EP_ACCUM))
            free_memory()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("mesh_moe_done", seconds=time.perf_counter() - t_phase)
    return by_path


# ---------------------------------------------------------------------------
# phase 42: MLA under the model axis over processes
# ---------------------------------------------------------------------------


MLA_MESH = (1, 4)         # (data, model): ranks on the one card
MLA_FSDP_MESH = (2, 2)    # phase 43's: FSDP over data, the model axis too
# deepseek-v3-671b at full width cut as phase 22's exactness cut: 1 dense +
# 1 MoE layer of 61, 8 of 256 routed experts (one MoE layer's 256 are 11.3
# G parameters), the MTP module kept; FSDP off (the config's is on; phase
# 43 keeps it)
MLA_CUT = (("n_layers", 2), ("moe.n_dense_layers", 1), ("moe.n_experts", 8),
           ("fsdp", False))
MLA_BATCH = 2             # x TRAIN_SEQ, as phase 22 trains deepseek-v3
# the float32 witness's further cut, so that its one-device step (rank 0:
# fp32 parameters, gradients and two moments, 16 bytes a parameter) fits
# beside the four ranks' blocks: vocab 32000 of 129280, no MTP module
# (sequences of ``WITNESS_SEQ``, as every witness)
MLA_WITNESS_CUT = (("vocab_size", 32000), ("mtp_depth", 0),
                   ("param_dtype", "float32"))
# phase 43's train steps: the first step's loss, drops and launches are
# held (a second step at capacity 1.25 holds nothing more: no pair drops);
# the conditioned step, the same FSDP step after the first, gives the
# steady ms a step
MLA_FSDP_STEPS = 1
# phase 43's witness: its drop step and one step from the initial state
# (the step after it, from the gathered state, is phase 42's second
# witness step's check; FSDP's update of the blocks is held in float64 on
# the CPU): a float32 step under FSDP moves ~6 GB through gloo
MLA_FSDP_WITNESS_STEPS = 1
MLA_SERVE = dict(prompt=64, steps=2)   # two prompts, float32 compute
# phase 43's expert-parallel step: 4 x 1024 in 2 micro-batches of 2048
# tokens (one row a rank), the gate lowered to a micro-batch's tokens
MLA_EP = dict(batch=4, seq=1024, grad_accum=2)
MLA_EP_GATE = MLA_EP["batch"] * MLA_EP["seq"] // MLA_EP["grad_accum"]


def _mla_mesh_cfgs(fsdp=False):
    """deepseek-v3-671b as configured (bf16 parameters and moments, bf16
    compute, full remat, the attention kernels on the card, experts on the
    model axis) cut by ``MLA_CUT`` (with ``fsdp``, but its FSDP off: the
    config's own FSDP on), and phase 22's optimizer with the config's
    moment dtype."""
    cfg = _replace(get_config(MLA_ARCH), MLA_CUT)
    assert (cfg.param_dtype, cfg.opt_state_dtype, cfg.compute_dtype,
            cfg.remat, cfg.attn_flash, cfg.moe.expert_parallel) == (
        "bfloat16", "bfloat16", "bfloat16", "full", "auto", True), cfg
    if fsdp:
        assert get_config(MLA_ARCH).fsdp
        cfg = dataclasses.replace(cfg, fsdp=True)
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=60,
                          moment_dtype=cfg.opt_state_dtype)
    return cfg, opt


def _mla_serve(cfg, mesh=None):
    """A prefill of two prompts of ``MLA_SERVE["prompt"]`` tokens (from a
    seed) and ``MLA_SERVE["steps"]`` absorbed decode steps of ``cfg`` in
    float32 compute with a float32 cache, from the seeded init:
    on ``mesh`` with the rank's blocks (every rank takes part; each data
    rank its rows of the prompts: one under FSDP on (2,2)), else on one
    device. Returns (the last logits of each step, whole, on the host;
    each step's collectives, summed over the ranks, or None)."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",)) if mesh else None
    rows = slice(None)
    if mesh is not None:
        n = 2 // mesh.shape["data"]
        rows = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, dtype=cfg.param_dtype,
                         device=DEV)
    if mesh is not None:
        params = shard_params(params, train_state_specs(cfg, ctx)["params"],
                              mesh)
        free_memory()
    r = np.random.RandomState(42)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(
        2, MLA_SERVE["prompt"]))[rows]).to(DEV)
    steps = [torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 1))
                              [rows]).to(DEV)
             for _ in range(MLA_SERVE["steps"])]

    def counts():
        return (compat.read_counts(reduce=True),
                compat.read_counts(reduce=True, backward=True)) \
            if mesh else None
    outs, coll = [], []
    with torch.no_grad():
        compat.reset_counts()
        logits, cache = make_prefill_step(
            cfg, ctx, MLA_SERVE["prompt"] + MLA_SERVE["steps"],
            cache_dtype=torch.float32)(params, {"tokens": toks})
        outs.append(logits.cpu())
        coll.append(counts())
        dec = make_decode_step(cfg, ctx)
        for tok in steps:
            compat.reset_counts()
            logits, cache = dec(params, cache, {"tokens": tok})
            outs.append(logits.cpu())
            coll.append(counts())
    del params, cache
    free_memory()
    return outs, coll


def _mla_job(mesh, out_path, fsdp=False):
    """Phase 42's work on (1,4) (with ``fsdp``, phase 43's on (2,2)), on
    every rank: deepseek-v3-671b as :func:`_mla_mesh_cfgs` gives it
    through ``Trainer(mesh=mesh)`` (:func:`_moe_run`), then the float32
    witness at ``MLA_WITNESS_CUT`` with its drop step (with ``fsdp`` on
    the expert-parallel route, against the stacked route's step), one
    step from ``_conditioned`` parameters, the serve steps
    (:func:`_mla_serve`) and, with ``fsdp``, one step on the
    expert-parallel route at ``MLA_EP``'s tokens in its micro-batches,
    the gate lowered to a micro-batch's (:func:`_ep_step`).
    The one-device steps run in the parent afterwards
    (:func:`mla_one_device_record`). Returns the results on rank 0 (the
    serve logits saved beside ``out_path``, the seconds of each part),
    None on the others."""
    import torch.distributed as dist
    clock = _Clock()
    cfg, opt = _mla_mesh_cfgs(fsdp)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=MLA_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    tr = Trainer(cfg, opt, data, TrainerConfig(
        steps=MLA_FSDP_STEPS if fsdp else TP_STEPS, log_every=1), mesh=mesh,
        device=DEV)
    local = tr.bundle.abstract_state
    n_params = sum(t.numel() for t in tree_leaves(local["params"]))
    state_bytes = tree_size_bytes(local["params"]) \
        + tree_size_bytes(local["opt"])
    log, launches, seen, counts, peak, step_ms, drops = _moe_run(tr)
    del tr
    free_memory()
    clock.took("train")
    wcfg = _replace(cfg, MLA_WITNESS_CUT)
    torch.cuda.reset_peak_memory_stats()
    fp32 = _tp_fp32_witness(mesh, dataclasses.replace(
        opt, moment_dtype="float32"), fsdp, cfg=wcfg, batch=MLA_BATCH,
        drop_capacity=DROP_CAPACITY,
        steps=MLA_FSDP_WITNESS_STEPS if fsdp else TP_STEPS, stacked=fsdp)
    witness_peak = torch.cuda.max_memory_allocated()
    clock.took("witness")
    conditioned = _conditioned_tp_step(mesh, opt, cfg, MLA_BATCH)
    clock.took("conditioned")
    serve, serve_counts = _mla_serve(cfg, mesh)
    clock.took("serve")
    ep = _ep_step(mesh, cfg, opt, MLA_EP["batch"], MLA_EP_GATE,
                  MLA_EP["grad_accum"], MLA_EP["seq"]) if fsdp else None
    clock.took("ep")
    geos = sorted([n, g, sq, sk, d, str(dt)[6:], c, bq, bk]
                  for n, (g, sq, sk, d, dt, c, bq, bk) in seen)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (launches, peak, geos, step_ms, drops,
                                   n_params, state_bytes, witness_peak))
    if mesh.rank != 0:
        return None
    torch.save(serve, out_path + ".serve.pt")
    return {"backend": dist.get_backend(), "log": log, "fp32": fp32,
            "conditioned": conditioned, "ep": ep,
            "serve_collectives": serve_counts,
            "serve_path": out_path + ".serve.pt",
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "geometries_by_rank": [e[2] for e in every],
            "step_ms_by_rank": [e[3] for e in every],
            "drops_by_rank": [e[4] for e in every],
            "params_by_rank": [e[5] for e in every],
            "state_gb_by_rank": [e[6] / 1e9 for e in every],
            "witness_peak_gb_by_rank": [e[7] / 1e9 for e in every],
            "collectives": counts, "part_s": clock.seconds}


def mla_one_device_record(smi):
    """The one-device side of phases 42 and 43 (one device ignores
    ``fsdp``, so the two phases' configs, seeds and batches give the same
    steps): the trainer's ``TP_STEPS`` steps of :func:`_mla_mesh_cfgs`'s
    model (their attention launches, drops, ms a step and peak), the
    step from ``_conditioned`` parameters and the serve steps
    (:func:`_mla_serve`)."""
    cfg, opt = _mla_mesh_cfgs()
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=MLA_BATCH,
                      vocab_size=cfg.vocab_size, seed=0)
    free_memory()
    t0 = time.perf_counter()
    one_tr = Trainer(cfg, opt, data, TrainerConfig(
        steps=TP_STEPS, log_every=1), device=DEV)
    params = sum(t.numel() for t in tree_leaves(
        one_tr.bundle.abstract_state["params"]))
    log, launches, _, _, peak, step_ms, drops = _moe_run(one_tr)
    del one_tr
    free_memory()
    out = {"log": log, "launches": launches, "peak_gb": peak / 1e9,
           "step_ms": step_ms, "drops": drops, "params": params,
           "conditioned": _conditioned_one_step(cfg, opt, MLA_BATCH),
           "serve": _mla_serve(cfg)[0]}
    emit("mesh_mla_one_device", gpu=smi, arch=cfg.name,
         n_layers=cfg.n_layers, batch=MLA_BATCH, seq_len=TRAIN_SEQ,
         params=params, log=log, drops=drops, step_ms=step_ms,
         peak_gb=peak / 1e9, seconds=time.perf_counter() - t0)
    return out


def _hold_mla_job(smi, phase, mesh_shape, r, one, fsdp):
    """Phase 42's (with ``fsdp``, phase 43's) checks of its job's results
    ``r`` (rank 0's, :func:`_mla_job`) against the one-device record
    ``one`` (:func:`mla_one_device_record`), and its line. Returns the
    launches by path, summed over the ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    pc = _process_cases()
    cfg, _ = _mla_mesh_cfgs(fsdp)
    d, m = mesh_shape
    n = d * m
    steps = MLA_FSDP_STEPS if fsdp else TP_STEPS
    per_step = train_launches(cfg)
    assert per_step == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}, per_step
    assert one["launches"] == {k: TP_STEPS * v
                               for k, v in per_step.items()}, one
    serve = torch.load(r["serve_path"], weights_only=True)
    assert r["backend"] == "gloo", r["backend"]
    want = {k: steps * v for k, v in per_step.items()}
    assert all(x == want for x in r["launches_by_rank"]), r
    launches = {k: sum(x[k] for x in r["launches_by_rank"])
                for k in per_step}
    rows, heads = MLA_BATCH // d, cfg.n_heads_padded // m
    seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
            for rank_geos in r["geometries_by_rank"]
            for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
    results = []
    geometries = check_path_attention(f"{phase} {mesh_shape}", seen, rows,
                                      heads, 430 if fsdp else 420, results)
    got_log, one_log = r["log"], one["log"]
    rel = {k: abs(got_log[0][k] - one_log[0][k]) / abs(one_log[0][k])
           for k in ("loss", "ce", "aux", "mtp")}
    assert max(rel.values()) <= TP_LOSS_REL, (rel, got_log, one_log)
    cond = {"tp": r["conditioned"], "one": one["conditioned"]}
    cond_rel = {k: abs(cond["tp"][k] - cond["one"][k])
                / abs(cond["one"][k]) for k in ("loss", "grad_norm")}
    assert cond_rel["loss"] <= TP_LOSS_REL, cond
    assert cond_rel["grad_norm"] <= TP_GRAD_REL, cond
    fp32_rel, flips = check_witness(r["fp32"], d, m)
    by_data = [r["drops_by_rank"][i:i + m] for i in range(0, n, m)]
    assert all(b == b[:1] * m for b in by_data), r["drops_by_rank"]
    drops = [sum(b[0][i] for b in by_data) for i in range(steps)]
    assert drops == one["drops"][:steps], (drops, one["drops"],
                                           r["drops_by_rank"])
    # the train step's bytes by kind against the count of the same cell,
    # less the grad norm's scalar (over every rank that holds a block)
    # and the loss metrics' mean
    st = dryrun.count_step(
        cfg, ShapeConfig("train_2x2048", TRAIN_SEQ, MLA_BATCH, "train"),
        make_mesh(d, m), target="cuda")
    got = {k: v / steps for k, v in pc.by_kind(
        r["collectives"]).items()}
    got["all-reduce"] -= pc.fsdp_extra(d, m, 4) if fsdp \
        else pc.norm_bytes(d, m) + pc.metric_bytes(4, 4, d) * m
    want_bytes = {k: n * v for k, v in st.collective_by_kind.items()}
    assert set(got) == set(want_bytes) and all(
        abs(got[k] - want_bytes[k]) <= n for k in got), (got, want_bytes)
    # the serve steps: logits against the one-device steps', bytes
    # against the count of the same steps, beside the last logits'
    # all-gathers
    scfg = dataclasses.replace(cfg, compute_dtype="float32")
    serve_rel = [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(serve, one["serve"])]
    assert max(serve_rel) <= TP_FP32_REL, serve_rel
    gathered = pc.fsdp_logit_bytes(scfg, mesh_shape, 2)
    serve_bytes = []
    for i, c in enumerate(r["serve_collectives"]):
        kind = "prefill" if i == 0 else "decode"
        sst = dryrun.count_step(scfg, ShapeConfig(
            kind, MLA_SERVE["prompt"], 2, kind), make_mesh(d, m),
            target="cuda")
        sgot = pc.by_kind(c)
        swant = {k: n * v for k, v in sst.collective_by_kind.items()}
        swant["all-gather"] = swant.get("all-gather", 0) + gathered
        assert set(sgot) == set(swant) and all(
            abs(sgot[k] - swant[k]) <= n for k in sgot), (i, sgot, swant)
        serve_bytes.append(sgot)
    by_path = {f"{phase} {mesh_shape}": launches}
    if r["ep"] is not None:
        by_path.update(_hold_ep(smi, f"{phase}_ep", r["ep"], cfg, mesh_shape,
                                MLA_EP["batch"], MLA_EP_GATE, 435, results,
                                grad_accum=MLA_EP["grad_accum"],
                                seq=MLA_EP["seq"]))
    # a step after the first: the train's own, or the conditioned step
    steady = [statistics.mean(x[1:]) for x in r["step_ms_by_rank"]] \
        if steps > 1 else [cond["tp"]["step_ms"]]
    emit(phase, gpu=smi, arch=cfg.name, mesh=list(mesh_shape), ranks=n,
         backend=r["backend"], fsdp=cfg.fsdp,
         reduced={k: v for k, v in MLA_CUT if k != "fsdp" or not fsdp},
         n_layers=cfg.n_layers, batch=MLA_BATCH, seq_len=TRAIN_SEQ,
         steps=steps, log=got_log, one_device_log=one_log,
         first_step_rel=rel, conditioned=cond, conditioned_rel=cond_rel,
         fp32_witness=r["fp32"], fp32_rel=fp32_rel, fp32_flips=flips,
         fp32_limit=TP_FP32_REL,
         witness_cut={**dict(MLA_WITNESS_CUT), "seq_len": WITNESS_SEQ,
                      **({"DENSE_PATH_MAX_TOKENS": MLA_BATCH * WITNESS_SEQ}
                         if fsdp else {})},
         witness_peak_gb_by_rank=r["witness_peak_gb_by_rank"],
         drops_by_rank=r["drops_by_rank"], drops=drops,
         one_device_drops=one["drops"], launches=launches,
         launches_per_rank_step=per_step, geometries=geometries,
         rows_per_launch=rows, heads_per_launch=heads,
         collectives=r["collectives"], bytes_per_step=got,
         count_step_bytes=want_bytes, serve_rel=serve_rel,
         serve_bytes=serve_bytes, serve=MLA_SERVE,
         step_ms_by_rank=r["step_ms_by_rank"],
         steady_step_ms_by_rank=steady,
         peak_gb_by_rank=r["peak_gb_by_rank"],
         params_by_rank=r["params_by_rank"],
         state_gb_by_rank=r["state_gb_by_rank"],
         one_device_params=one["params"],
         one_device_step_ms=one["step_ms"],
         one_device_peak_gb=one["peak_gb"], part_seconds=r["part_s"],
         seconds=r["seconds"])
    return by_path


def _mla_phase(smi, phase, mesh_shape, spawned, one, fsdp):
    """Phases 42-43: the job's ranks (spawned here where ``spawned`` is
    None), the one-device record (made here where ``one`` is None), then
    :func:`_hold_mla_job`."""
    t_phase = time.perf_counter()
    free_memory()
    kind = "mla_fsdp" if fsdp else "mla"
    tmp = tempfile.mkdtemp(prefix=f"mesh_{kind}_")
    try:
        spawned = spawned or run_card_ranks(tmp, None, [
            (math.prod(mesh_shape), ((kind, mesh_shape),))])
        one = one or mla_one_device_record(smi)
        by_path = _hold_mla_job(smi, phase, mesh_shape,
                                spawned[kind, mesh_shape], one, fsdp)
        free_memory()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(f"{phase}_done", seconds=time.perf_counter() - t_phase)
    return by_path


def phase_mesh_mla(smi, spawned=None, one=None):
    """Phase 42: MLA under the model axis over processes
    (``models/attention.py::mla_attention(tp=)``: each rank its heads of
    ``wq_b`` / ``wkv_b`` / ``wo``, the latent projections whole, Megatron's
    ``copy_to`` on ``q_lat``, ``c_kv``, ``k_rope`` and ``reduce_from``
    after ``wo``; the routed experts split over model in the one-hot
    dispatch, between ``copy_to`` on the tokens and their gates and
    ``reduce_from`` on the combined output; the vocab-split lookup and
    cross-entropy, the MTP module's too). deepseek-v3-671b at full width
    (d_model 7168, 128 heads, MLA 1536/512/128/64/128, vocab 129280 split
    4 ways, dense d_ff 18432, expert d_ff 2048, top 8, a shared expert)
    cut by ``MLA_CUT`` (1 dense + 1 MoE layer, 8 routed experts, MTP 1,
    FSDP off), bf16 parameters and moments, bf16 compute, full remat,
    2 x 2048: its 4 ranks spawned on the one card in a gloo group with
    phases 39-41's, ``TP_STEPS`` steps through ``Trainer(mesh=
    make_process_mesh(1, 4, backend="gloo"))``; then here the one-device
    trainer (``one``: :func:`mla_one_device_record`, made here where
    None). Held: the first step's loss, ce, aux and mtp within
    ``TP_LOSS_REL``; on ``_conditioned`` parameters one step's loss within
    ``TP_LOSS_REL`` and grad norm within ``TP_GRAD_REL``; a float32 witness
    at ``MLA_WITNESS_CUT`` step by step (:func:`check_witness`: within
    ``TP_FP32_REL`` where the routes agree, a step at ``DROP_CAPACITY``
    whose drops are above 0 and each rank's those of its block); B3-B5
    (the MTP module's GQA layer) ``train_launches`` a step on every rank at
    2 x 32 rows x heads a launch, each held against its plain version at
    the geometry the path launched it at; the drops summed over the data
    ranks equal to the one-device step's; the train step's bytes by kind
    summed over the ranks equal to ``count_step``'s for the cell times the
    ranks (the all-reduces less the grad norm's scalar); a prefill of 2 x
    64 and two absorbed decode steps in float32 compute on the rank's
    blocks within ``TP_FP32_REL`` of the one-device steps' largest logit,
    their bytes equal to ``count_step``'s for prefill and decode (beside
    the last logits' all-gather). Recorded: ms a step, peak GB, parameters
    and state GB a rank (the ranks share one card and its host: no scaling
    figure), beside the card's name and power limit. ``spawned``:
    :func:`run_card_ranks`'s results (one spawn of its own here where
    None). Returns the launches by path, summed over the ranks."""
    return _mla_phase(smi, "mesh_mla", MLA_MESH, spawned, one, fsdp=False)


def phase_mesh_mla_fsdp(smi, spawned=None, one=None):
    """Phase 43: the MoE family under FSDP over processes
    (``models/transformer.py::forward`` gathering each MoE layer's leaves,
    the live rows of its expert tables, inside the function its checkpoint
    wraps, the MTP module its own under ``Fsdp.regather``, the lookup's
    table and the head's leaf shared with it). deepseek-v3-671b as
    configured (``fsdp=True``) at phase 42's full width and cut
    (``MLA_CUT`` but its FSDP), bf16 parameters and moments, bf16 compute,
    full remat, 2 x 2048, on ``MLA_FSDP_MESH`` (2,2): every embed
    dimension (and q_lora / kv_lora where embed leaves them) over data,
    the experts, MLA's heads, the FFN columns and the vocab over model;
    its 4 ranks in the one world of 4, after phase 42's. Held to phase
    42's one-device record (``one``: the same steps, one device ignoring
    ``fsdp``), as phase 42 holds its job: the first step's loss, ce, aux
    and mtp; the conditioned step's loss and grad norm; the float32
    witness (FSDP on) with its drop step; B3-B5 a rank-step at 1 x 64
    rows x heads against their plain versions; the drops; the train
    step's and the serve steps' bytes by kind against ``count_step``'s
    with ``fsdp=True`` (the gathers, the recompute's gathers and the
    reduce-scatters; the all-reduces less the grad norm's scalar over
    every rank and the loss metrics' mean; the serve steps' two logits
    all-gathers); the prefill and two absorbed decode steps (each data
    rank its prompt) against the one-device logits; one step on the
    expert-parallel route at ``MLA_EP`` (4 x 1024 in two micro-batches,
    the gate lowered to a micro-batch's 2048 tokens, FSDP's gathers once
    a micro-batch), B3-B5 held at its geometry. Recorded: ms a step,
    peak and state GB a rank, beside the card's name and power limit.
    Returns the launches by path, summed over the ranks."""
    return _mla_phase(smi, "mesh_mla_fsdp", MLA_FSDP_MESH, spawned, one,
                      fsdp=True)


# ---------------------------------------------------------------------------
# phase 44: the SSM, hybrid, vision and encoder-decoder families under FSDP
# ---------------------------------------------------------------------------


FAMILY_FSDP_MESH = (4, 1)   # (data, model): ranks on the one card
# each family at full width with fsdp=True, cut to the least depth that
# runs each of its block kinds
FAMILY_FSDP_CUTS = (
    ("xlstm-1.3b", (("n_layers", 1),)),
    # two Mamba2 layers, each closing a group: the shared block read twice
    ("zamba2-7b", (("n_layers", 2), ("attn_every", 1))),
    (VISION_ARCH, (("n_layers", 1), ("cross_attn_every", 1))),
    (AUDIO_ARCH, (("n_layers", 1), ("n_encoder_layers", 1))),
)
FAMILY_FSDP_BATCH = 4      # x TRAIN_SEQ: one row a rank
# zamba2-7b's serve steps: 4 prompts of 64 tokens (one a rank), one decode
# step, float32 compute and cache, with float64 on one device as the
# witness: the ranks' logits (another GEMM shape: one row a rank) may be no
# further from float64's than WITNESS_FACTOR times the one-device float32
# logits are, plus SERVE_SLACK of the largest logit
FAMILY_FSDP_SERVE = dict(batch=4, prompt=64)
SERVE_SLACK = 1e-6
FAMILY_ONE_FILE = "families_one_device_zamba2.pt"


def _families_fsdp_cfgs():
    """Each family of ``FAMILY_FSDP_CUTS`` as configured (fp32 parameters
    and moments, bf16 compute, full remat, the attention kernels on the
    card) with ``fsdp=True``, and phase 22's optimizer."""
    out = []
    for arch, cut in FAMILY_FSDP_CUTS:
        cfg = _replace(get_config(arch), cut + (("fsdp", True),))
        assert (cfg.compute_dtype, cfg.remat, cfg.attn_flash) == (
            "bfloat16", "full", "auto"), cfg
        out.append((cfg, adamw.OptConfig(peak_lr=3e-4, warmup_steps=1,
                                         decay_steps=60,
                                         moment_dtype=cfg.opt_state_dtype)))
    return out


def _family_fsdp_serve(cfg, mesh=None, dtype="float32", times=None):
    """``cfg``'s prefill of ``FAMILY_FSDP_SERVE``'s prompts (from a seed;
    with the frontend's embeddings, from a seed, where the model takes
    them) and one decode step in ``dtype`` (compute, parameters and cache;
    the seeded float32 init, cast), from the seeded init: on ``mesh`` under
    FSDP (each data rank its prompt, the weights gathered a block at a
    time, the shared block once a step) or, with ``fsdp=False``,
    tensor-parallel (every rank the whole batch), else on one device.
    Returns (the last logits of each step, whole, on the host; each step's
    collectives, summed over the ranks, or None); ``times``: a list that
    takes each step's ms."""
    params = _family_params(cfg, 0)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype)
    params = tree_map(lambda t: t.to(torch_dtype(dtype)), params)
    b, s = FAMILY_FSDP_SERVE["batch"], FAMILY_FSDP_SERVE["prompt"]
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",)) if mesh else None
    rows = slice(None)
    if mesh is not None:
        if cfg.fsdp:
            n = b // mesh.shape["data"]
            rows = slice(mesh.coord("data") * n,
                         (mesh.coord("data") + 1) * n)
        params = shard_params(params, train_state_specs(cfg, ctx)["params"],
                              mesh)
        free_memory()
    r = np.random.RandomState(44)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, s))[
        rows]).to(DEV)
    nxt = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(b, 1))[
        rows]).to(DEV)
    front = {}
    if cfg.frontend_seq:
        gen = torch.Generator(device=DEV).manual_seed(44)
        front["frontend_emb"] = torch.randn(
            (b, cfg.frontend_seq, cfg.frontend_dim or cfg.d_model),
            generator=gen, device=DEV)[rows].to(torch_dtype(dtype))

    def counts():
        return (compat.read_counts(reduce=True),
                compat.read_counts(reduce=True, backward=True)) \
            if mesh else None
    outs, coll = [], []
    times = [] if times is None else times

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    with torch.no_grad():
        compat.reset_counts()
        logits, cache = timed(make_prefill_step(
            cfg, ctx, s + 1, cache_dtype=torch_dtype(dtype)), params,
            {"tokens": toks, **front})
        outs.append(logits.cpu())
        coll.append(counts())
        compat.reset_counts()
        logits, cache = timed(make_decode_step(cfg, ctx), params, cache,
                              {"tokens": nxt, **front})
        outs.append(logits.cpu())
        coll.append(counts())
    del params, cache, front
    free_memory()
    return outs, coll


def families_one_device_record(tmp):
    """The one-device steps that phase 44 holds its ranks against, run
    before the spawn: one step of each family of :func:`_families_fsdp_cfgs`
    (FSDP ignored on one device) from the seeded init and batch (its
    metrics), zamba2-7b's parameters after it saved under ``tmp``
    (``FAMILY_ONE_FILE``, for the ranks to memory-map), and zamba2-7b's
    serve steps (:func:`_family_fsdp_serve`) in float32 and, the witness,
    float64. Each tree is freed before the next."""
    t0 = time.perf_counter()
    steps, serve = {}, None
    for cfg, opt in _families_fsdp_cfgs():
        t1 = time.perf_counter()
        params = _family_params(cfg, 0)
        state = {"params": params, "opt": adamw.init(opt, params)}
        batch = _family_batch(cfg, FAMILY_FSDP_BATCH, TRAIN_SEQ, 0)
        state, m = make_train_step(cfg, opt).step_fn(state, batch)
        steps[cfg.name] = dict({k: float(v) for k, v in m.items()},
                               seconds=time.perf_counter() - t1)
        if cfg.family == "hybrid":
            torch.save(tree_map(lambda t: t.cpu(), state["params"]),
                       os.path.join(tmp, FAMILY_ONE_FILE))
        del state, params, batch
        free_memory()
        if cfg.family == "hybrid":
            serve = {dt: _family_fsdp_serve(cfg, dtype=dt)[0]
                     for dt in ("float32", "float64")}
    return {"steps": steps, "serve": serve,
            "seconds": time.perf_counter() - t0}


def _families_job(mesh, out_path):
    """Phase 44's work on (4,1), on every rank: each family of
    :func:`_families_fsdp_cfgs` in turn, the rank's blocks of the seeded
    init (``shard_params``), one train step on its row of the seeded
    batch with the attention kernels' geometries recorded; zamba2-7b's
    blocks after it against the same slices of the one-device result
    (``FAMILY_ONE_FILE`` beside ``out_path``, memory-mapped) and its serve
    steps (:func:`_family_fsdp_serve`, the logits saved beside
    ``out_path``). Returns the results on rank 0, None on the others."""
    import torch.distributed as dist
    one_path = os.path.join(os.path.dirname(out_path), FAMILY_ONE_FILE)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    n = FAMILY_FSDP_BATCH // mesh.shape["data"]
    mine = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    out = {}
    for cfg, opt in _families_fsdp_cfgs():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        specs = train_state_specs(cfg, ctx)["params"]
        blocks = shard_params(_family_params(cfg, 0), specs, mesh)
        free_memory()
        state = {"params": blocks, "opt": adamw.init(opt, blocks)}
        batch = {k: v[mine] for k, v in _family_batch(
            cfg, FAMILY_FSDP_BATCH, TRAIN_SEQ, 0).items()}
        step_fn = make_train_step(cfg, opt, ctx).step_fn
        torch.cuda.synchronize()
        att.reset_launches()        # this family's FSDP path starts here
        compat.reset_counts()
        with att_geometries() as seen:
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            metrics = {k: float(v) for k, v in m.items()}
            step_s = time.perf_counter() - t1
        launches = dict(att.LAUNCHES)   # read right after it
        counts = (compat.read_counts(reduce=True),
                  compat.read_counts(reduce=True, backward=True))
        peak = torch.cuda.max_memory_allocated()
        state_gb = (tree_size_bytes(state["params"])
                    + tree_size_bytes(state["opt"])) / 1e9
        gaps, serve = None, None
        if cfg.family == "hybrid":
            want = shard_params(torch.load(one_path, mmap=True,
                                           weights_only=True), specs, mesh)
            gaps = []
            for got, w in zip(tree_leaves(state["params"]),
                              tree_leaves(want)):
                gap = (got.cpu().double() - w.double()).abs()
                gaps.append((float(gap.max()), float(w.abs().max())))
            del want
        del state, blocks, batch, step_fn
        free_memory()
        if cfg.family == "hybrid":
            serve = _family_fsdp_serve(cfg, mesh)
        geos = sorted([k, g, sq, sk, dd, str(dt)[6:], c, bq, bk]
                      for k, (g, sq, sk, dd, dt, c, bq, bk) in seen)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (launches, peak, geos, step_s, gaps,
                                       state_gb))
        if serve is not None and mesh.rank == 0:
            torch.save(serve[0], out_path + ".serve.pt")
            serve = {"path": out_path + ".serve.pt", "collectives": serve[1]}
        out[cfg.name] = {
            "metrics": metrics, "collectives": counts, "serve": serve,
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "geometries_by_rank": [e[2] for e in every],
            "step_s_by_rank": [e[3] for e in every],
            "gaps_by_rank": [e[4] for e in every],
            "state_gb_by_rank": [e[5] for e in every],
            "weight_decay": opt.weight_decay,
            "seconds": time.perf_counter() - t0}
    if mesh.rank != 0:
        return None
    return {"families": out, "backend": dist.get_backend()}


def phase_mesh_families_fsdp(smi, spawned=None, one=None):
    """Phase 44: the SSM, hybrid, vision and encoder-decoder families under
    FSDP over processes (``models/transformer.py::forward`` gathering the
    mix layers', the cross layers' and the encoder layers' leaves where
    they run, the hybrid family's shared block once a forward for every
    group that reads it, ``models.sharding.Reused``). Each family of
    ``FAMILY_FSDP_CUTS`` at full width with ``fsdp=True`` (bf16 compute,
    full remat), its depth cut to the least that runs each of its block
    kinds, one step at ``FAMILY_FSDP_BATCH`` x ``TRAIN_SEQ`` on
    ``FAMILY_FSDP_MESH`` (4,1): one row a rank, the last job of the one
    world of 4. Held: the step's loss and ce within ``TP_LOSS_REL`` of
    the one-device step on the same state and batch (``one``:
    :func:`families_one_device_record`, made here where None); B3-B5
    ``train_launches`` on every rank, each held against its plain version
    at the geometry the path launched it at; the bytes by kind, summed
    over the ranks, equal to ``count_step``'s for the cell times the
    ranks (the all-reduces less the loss metrics' mean and the grad
    norm's scalar); zamba2-7b's blocks within ``_param_bound`` of the
    same slices of the one-device result, and its prefill of 4 x 64 and
    one decode step in float32 no further from the one-device float64
    logits than ``WITNESS_FACTOR`` times the one-device float32 logits
    are (plus ``SERVE_SLACK``), their bytes the count's beside the
    logits' gather over data. Each family's line is emitted before its
    checks fail the phase. Recorded: the seconds of the step and the peak
    GB on each rank.
    ``spawned``: :func:`run_card_ranks`'s results (its own spawn here
    where None). Returns the launches by path, summed over the ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    free_memory()
    pc = _process_cases()
    d, m = FAMILY_FSDP_MESH
    n = d * m
    tmp = tempfile.mkdtemp(prefix="mesh_families_fsdp_")
    by_path, results = {}, []
    try:
        one = one or families_one_device_record(tmp)
        spawned = spawned or run_card_ranks(tmp, None, [
            (n, (("fsdp_families", FAMILY_FSDP_MESH),))])
        job = spawned["fsdp_families", FAMILY_FSDP_MESH]
        assert job["backend"] == "gloo", job["backend"]
        failed = []
        for i, (cfg, _) in enumerate(_families_fsdp_cfgs()):
            r = job["families"][cfg.name]
            want_m = one["steps"][cfg.name]
            checks = {}     # what is held: True where it holds
            rel = {k: abs(r["metrics"][k] - want_m[k]) / abs(want_m[k])
                   for k in ("loss", "ce")}
            checks["loss"] = max(rel.values()) <= TP_LOSS_REL
            per_step = train_launches(cfg)
            checks["launches"] = all(x == per_step
                                     for x in r["launches_by_rank"])
            launches = {k: sum(x[k] for x in r["launches_by_rank"])
                        for k in per_step}
            geometries = []
            if any(per_step.values()):
                seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
                        for rank_geos in r["geometries_by_rank"]
                        for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
                geometries = check_path_attention(
                    f"families_fsdp {cfg.name}", seen, FAMILY_FSDP_BATCH // d,
                    cfg.n_heads_padded // m, 440 + 10 * i, results)
            st = dryrun.count_step(cfg, ShapeConfig(
                "train", TRAIN_SEQ, FAMILY_FSDP_BATCH, "train"),
                make_mesh(d, m), target="cuda")
            got = pc.by_kind(r["collectives"])
            got["all-reduce"] = got.get("all-reduce", 0) \
                - pc.fsdp_extra(d, m)
            want_bytes = {k: n * v for k, v in st.collective_by_kind.items()}
            want_bytes.setdefault("all-reduce", 0)
            checks["bytes"] = set(got) == set(want_bytes) and all(
                abs(got[k] - want_bytes[k]) <= n for k in got)
            extra = {}
            if cfg.family == "hybrid":
                lrs, worst = [want_m["lr"]], 0.0
                for gaps in r["gaps_by_rank"]:
                    for mx, pmax in gaps:
                        worst = max(worst, mx / _param_bound(
                            lrs, r["weight_decay"], pmax))
                checks["params"] = worst <= 1.0
                outs = torch.load(r["serve"]["path"], weights_only=True)
                coll = r["serve"]["collectives"]
                one32, one64 = one["serve"]["float32"], one["serve"]["float64"]

                def rel_gap(a, b):
                    return _gap(a, b) / float(b.abs().max())
                serve_gaps = {
                    "ranks_vs_one_f32": [rel_gap(a, b)
                                         for a, b in zip(outs, one32)],
                    "ranks_vs_f64": [rel_gap(a, b)
                                     for a, b in zip(outs, one64)],
                    "one_f32_vs_f64": [rel_gap(a, b)
                                       for a, b in zip(one32, one64)]}
                checks["serve"] = all(
                    g <= WITNESS_FACTOR * w + SERVE_SLACK for g, w in zip(
                        serve_gaps["ranks_vs_f64"],
                        serve_gaps["one_f32_vs_f64"]))
                f32 = dataclasses.replace(cfg, compute_dtype="float32")
                sv = FAMILY_FSDP_SERVE
                serve_bytes, serve_want = [], []
                for kind, c in zip(("prefill", "decode"), coll):
                    cs = dryrun.count_step(f32, ShapeConfig(
                        kind, sv["prompt"], sv["batch"], kind),
                        make_mesh(d, m), target="cuda")
                    got_s = pc.by_kind(c)
                    want_s = {k: n * v
                              for k, v in cs.collective_by_kind.items()}
                    want_s["all-gather"] = want_s.get("all-gather", 0) \
                        + pc.fsdp_logit_bytes(f32, FAMILY_FSDP_MESH,
                                              sv["batch"])
                    serve_bytes.append(got_s)
                    serve_want.append(want_s)
                checks["serve bytes"] = all(
                    set(a) == set(b) and all(abs(a[k] - b[k]) <= n
                                             for k in a)
                    for a, b in zip(serve_bytes, serve_want))
                extra = dict(params_worst_over_bound=worst,
                             serve_gaps=serve_gaps,
                             witness_factor=WITNESS_FACTOR,
                             serve_slack=SERVE_SLACK,
                             serve_bytes=serve_bytes,
                             serve_count_bytes=serve_want)
            n_params = sum(math.prod(t.shape) for t in tree_leaves(
                abstract_params(model_template(cfg))))
            emit("mesh_families_fsdp", gpu=smi, arch=cfg.name,
                 family=cfg.family, mesh=[d, m], ranks=n,
                 reduced={k: v for k, v in FAMILY_FSDP_CUTS[i][1]},
                 param_count=n_params, batch=FAMILY_FSDP_BATCH,
                 seq_len=TRAIN_SEQ, compute_dtype=cfg.compute_dtype,
                 remat=cfg.remat, checks=checks, metrics=r["metrics"],
                 one_device_metrics=want_m, rel=rel, launches=launches,
                 launches_per_rank_step=per_step, geometries=geometries,
                 bytes_per_step=got, count_step_bytes=want_bytes,
                 gb_per_step=sum(want_bytes.values()) / 1e9,
                 step_s_by_rank=r["step_s_by_rank"],
                 peak_gb_by_rank=r["peak_gb_by_rank"],
                 state_gb_by_rank=r["state_gb_by_rank"],
                 job_seconds=r["seconds"], **extra)
            failed += [f"{cfg.name}: {k}" for k, ok in checks.items()
                       if not ok]
            by_path[f"mesh_families_fsdp {cfg.name}"] = launches
            free_memory()
        emit("mesh_families_fsdp_done", gpu=smi, failed=failed,
             one_device_seconds=one["seconds"], seconds=job["seconds"])
        assert not failed, failed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


# ---------------------------------------------------------------------------
# phase 45: the serving engine under FSDP over processes
# ---------------------------------------------------------------------------

# each engine runs at the end of the job of the one world of 4 that holds
# its model's blocks (``CARD_JOBS``; no spawn or job of its own): (arch, its
# job, the requests' settings: how many, the slots, the new tokens, the
# prompts' lengths from a seed, low to high); float32 compute and cache:
# at full width one device's own float32 logits sit ~5e-4 of the largest
# from float64 (phase 44)
ENGINE_FSDP_CARD = (
    ("tinyllama-1.1b", ("fsdp", (4, 1)),
     dict(requests=4, slots=4, max_new=6, prompt=(16, 64))),
    ("zamba2-7b", ("fsdp_families", FAMILY_FSDP_MESH),
     dict(requests=4, slots=4, max_new=3, prompt=(16, 64))),
    (MLA_ARCH, ("mla_fsdp", MLA_FSDP_MESH),
     dict(requests=2, slots=2, max_new=3, prompt=(64, 64))),
)


def _engine_card_cfg(arch):
    """Phase 45's config of ``arch``, at float32 compute, with
    ``fsdp=True``: tinyllama-1.1b as phase 40 trains it, zamba2-7b at
    phase 44's cut, deepseek-v3-671b as configured at ``MLA_CUT`` (bf16
    parameters)."""
    if arch == "tinyllama-1.1b":
        cfg = dataclasses.replace(_mesh_cfgs()[0], fsdp=True)
    elif arch == MLA_ARCH:
        cfg = _mla_mesh_cfgs(fsdp=True)[0]
    else:
        cfg = next(c for c, _ in _families_fsdp_cfgs() if c.name == arch)
    return dataclasses.replace(cfg, compute_dtype="float32")


def _engine_card_model(arch, one_path=None):
    """:func:`_engine_card_cfg` of ``arch`` and its whole parameters on the
    card: tinyllama-1.1b's as phase 40's job holds them (the one-device
    result at ``one_path``, float32), zamba2-7b's and deepseek-v3-671b's
    the seeded inits of phases 44 and 43's serve steps."""
    cfg = _engine_card_cfg(arch)
    if arch == "tinyllama-1.1b":
        params = tree_map(lambda t: t.to(DEV),
                          torch.load(one_path, weights_only=True))
    elif arch == MLA_ARCH:
        params = init_params(model_template(cfg),
                             torch.Generator(device=DEV).manual_seed(0),
                             dtype=cfg.param_dtype, device=DEV)
    else:
        params = _family_params(cfg, 0)
    return cfg, params


def _engine_card_run(cfg, params, ctx, spec, refs=()):
    """``spec``'s requests (prompts from a seed) through a recorded
    ``ServingEngine`` of ``params`` on ``ctx`` (None: one device), greedy,
    to completion (``tests/torch_process_cases.py::RecordedEngine``:
    each step's collectives, the gathered leaves of ``refs`` alive before
    it, its last logits). Returns (a JSON-able record: tokens by uid,
    states, steps, timers, the gathered leaves alive at the end, the
    shapes of each parameter tree the engine keeps; the logits)."""
    pc = _process_cases()
    lo, hi = spec["prompt"]
    eng = pc.RecordedEngine(cfg, params, slots=spec["slots"],
                            max_seq=hi + spec["max_new"], ctx=ctx,
                            device=DEV, refs=refs, keep_logits=True)
    r = np.random.RandomState(45)
    for uid in range(spec["requests"]):
        plen = int(r.randint(lo, hi + 1))
        eng.submit(Request(uid=uid, prompt=r.randint(
            0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=spec["max_new"]))
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"tokens": {str(q.uid): [int(t) for t in q.out_tokens]
                       for q in done},
            "states": {str(q.uid): q.state.value for q in done},
            "prompts": [len(q.prompt) for q in done],
            "record": eng.record, "timers": eng.timers, "seconds": seconds,
            "alive_end": sum(ref() is not None for ref in refs),
            "gathered": len(refs),
            "trees": [[list(t.shape) for t in tree_leaves(tree)]
                      for tree in eng._params_by_dtype.values()]}, eng.logits


def engine_one_device_record(one_path):
    """The one-device engines that phase 45 holds its ranks against, run in
    the parent before the spawn: each of ``ENGINE_FSDP_CARD`` on its
    whole parameters (:func:`_engine_card_model`): {arch: (record,
    logits)}, each tree freed before the next."""
    out = {}
    for arch, _, spec in ENGINE_FSDP_CARD:
        cfg, params = _engine_card_model(arch, one_path)
        out[arch] = _engine_card_run(cfg, params, None, spec)
        del params
        free_memory()
    return out


def _engine_fsdp_job(arch, mesh, out_path, one_path=None):
    """Phase 45's engine of ``arch`` on ``mesh``, on every rank, at the end
    of the job that holds its blocks: the rank's blocks of
    :func:`_engine_card_model`'s parameters (``shard_params``), every
    rank given the same requests, the kernels' counts set to 0 just
    before and read just after, the peak memory. Returns on rank 0 every
    rank's record (rank 0's logits saved beside ``out_path``), None on the
    others."""
    import torch.distributed as dist
    pc = _process_cases()
    spec = next(s for a, _, s in ENGINE_FSDP_CARD if a == arch)
    cfg, whole = _engine_card_model(arch, one_path)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    blocks = shard_params(whole, train_state_specs(cfg, ctx)["params"], mesh)
    del whole
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()            # the engine's path starts here
    with pc.gathered_leaves() as refs:
        rec, logits = _engine_card_run(cfg, blocks, ctx, spec, refs)
    rec["launches"] = read_all_launches()   # read right after it
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["blocks"] = [list(t.shape) for t in tree_leaves(blocks)]
    del blocks
    free_memory()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rec)
    if mesh.rank != 0:
        return None
    torch.save(logits, out_path + ".engine.pt")
    return {"ranks": every, "logits_path": out_path + ".engine.pt"}


def engine_parting(steps, got, want):
    """The first device step at which the ranks' greedy choice (logits
    ``got``, rank 0's) parts from the one-device engine's (``want``) in a
    row the step reads (a prefill's one row, a decode's active slots),
    with the one-device logits' top-two margin there and the largest gap
    between the two logits of that step (None where they never part);
    and the gap of every step, relative to its largest logit."""
    gaps, part = [], None
    for i, (s, a, b) in enumerate(zip(steps, got, want)):
        gap = float((a - b).abs().max())
        gaps.append(gap / float(b.abs().max()))
        rows = [0] if s["kind"] == "prefill" else s["active"]
        for row in rows:
            if part is None and int(a[row].argmax()) != int(b[row].argmax()):
                top = b[row].topk(2).values
                part = {"step": i, "kind": s["kind"], "row": row,
                        "margin": float(top[0] - top[1]), "gap": gap}
        if part is not None:
            break
    return part, gaps


def _mean_ms(timers, kind):
    calls = sum(c for k, (c, _) in timers.items() if k.startswith(kind))
    secs = sum(t for k, (_, t) in timers.items() if k.startswith(kind))
    return 1e3 * secs / calls if calls else None


def phase_mesh_engine_fsdp(smi, spawned=None, one=None):
    """Phase 45: the ``ServingEngine`` under FSDP over processes
    (``serving/engine.py``: one scheduler on every rank, each data rank
    its block of ``slots / d`` rows of the KV pool; a decode step runs
    each rank's rows, its weights gathered a layer at a time, and samples
    every slot from the logits gathered whole; a prefill runs the one
    prompt on every rank, whose owner keeps the cache row). Each engine of
    ``ENGINE_FSDP_CARD`` ran at the end of the job of the one world of 4
    that holds its model's blocks (``spawned``: :func:`run_card_ranks`'s
    results), float32 compute, greedy. Held: every rank's tokens
    identical and every request done; against the one-device engine's
    (``one``: :func:`engine_one_device_record`) the tokens equal, or,
    where they part, the one-device logits' top-two margin at that step
    no more than twice the largest gap between the ranks' and the
    one-device logits of that step (a margin moves by at most twice the
    largest gap); each step's bytes by kind, summed over the ranks,
    against ``count_step``'s serve step of the same shape
    (``tests/torch_process_cases.py::engine_bytes_want``: the config
    stored in float32, the compute dtype the engine casts its blocks to
    before the gathers); between steps no gathered leaf alive and only
    the rank's blocks held. Recorded: peak GB a rank, ms a prefill and a
    decode step (host clock; gloo stages every collective through the
    host). Each engine's line is emitted before its checks fail the
    phase. ``spawned`` and ``one`` where None: the three jobs and their
    one-device records run here. Returns the launches by path, summed
    over the ranks."""
    from repro_torch.launch import dryrun
    pc = _process_cases()
    by_path, failed = {}, []
    tmp = None
    try:
        if spawned is None:
            tmp = tempfile.mkdtemp(prefix="mesh_engine_fsdp_")
            one_path = one_device_record(tmp)[1]
            families_one_device_record(tmp)     # the families job reads it
            one = one or engine_one_device_record(one_path)
            spawned = run_card_ranks(tmp, one_path, [
                (4, tuple(job for _, job, _ in ENGINE_FSDP_CARD))])
        for arch, job, spec in ENGINE_FSDP_CARD:
            r = spawned[job]["engine"]
            d, m = job[1]
            n = d * m
            cfg = dataclasses.replace(_engine_card_cfg(arch),
                                      param_dtype="float32")
            ranks = r["ranks"]
            want_rec, want_logits = one[arch]
            checks = {}
            toks = ranks[0]["tokens"]
            checks["ranks agree"] = all(x["tokens"] == toks for x in ranks)
            checks["done"] = len(toks) == spec["requests"] and all(
                set(x["states"].values()) == {"done"} for x in ranks)
            steps = [s for s in ranks[0]["record"] if s["kind"] != "audit"]
            part, gaps = engine_parting(
                steps, torch.load(r["logits_path"], weights_only=True),
                want_logits)
            checks["tokens"] = toks == want_rec["tokens"] or (
                part is not None and part["margin"] <= 2 * part["gap"])
            mesh = make_mesh(d, m)

            @functools.lru_cache(maxsize=None)
            def count(c, shape, mesh=mesh):
                return dryrun.count_step(c, shape, mesh, target="cuda")
            by_step, bytes_ok = {}, True
            for kind, shape, mode, got in pc.engine_step_bytes(ranks):
                want = pc.engine_bytes_want(cfg, (d, m), kind, shape, count)
                ok = set(got) == set(want) and all(abs(got[k] - want[k]) <= n
                                                   for k in got)
                bytes_ok = bytes_ok and ok
                by_step.setdefault(f"{kind} {list(shape)}",
                                   {"bytes": got, "count_step_bytes": want})
            checks["bytes"] = bytes_ok
            checks["blocks only"] = all(
                x["gathered"] > 0 and x["alive_end"] == 0
                and not any(s["alive_before"] for s in x["record"])
                and all(t == x["blocks"] for t in x["trees"]) for x in ranks)
            launches = {}
            for x in ranks:
                for k, v in x["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            gathered_gb = {k: v["bytes"].get("all-gather", 0) / 1e9
                           for k, v in by_step.items()}
            emit("mesh_engine_fsdp", gpu=smi, arch=arch, mesh=[d, m], ranks=n,
                 n_layers=cfg.n_layers, compute_dtype=cfg.compute_dtype,
                 requests=spec["requests"], slots=spec["slots"],
                 max_new=spec["max_new"], prompts=ranks[0]["prompts"],
                 checks=checks, tokens_equal=toks == want_rec["tokens"],
                 parting=part, rel_gap_by_step=gaps, bytes_by_step=by_step,
                 all_gather_gb_by_step=gathered_gb,
                 peak_gb_by_rank=[x["peak_gb"] for x in ranks],
                 prefill_ms_by_rank=[_mean_ms(x["timers"], "prefill")
                                     for x in ranks],
                 decode_ms_by_rank=[_mean_ms(x["timers"], "decode")
                                    for x in ranks],
                 one_device_prefill_ms=_mean_ms(want_rec["timers"], "prefill"),
                 one_device_decode_ms=_mean_ms(want_rec["timers"], "decode"),
                 engine_s_by_rank=[x["seconds"] for x in ranks],
                 ticks=len([s for s in steps if s["kind"] == "decode"]),
                 launches=launches)
            failed += [f"{arch}: {k}" for k, ok in checks.items() if not ok]
            by_path[f"mesh_engine_fsdp {arch}"] = launches
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    emit("mesh_engine_fsdp_done", gpu=smi, failed=failed)
    assert not failed, failed
    return by_path


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 46: the SSM and hybrid blocks under the model axis over processes
# ---------------------------------------------------------------------------

SSM_TP_MESH = (1, 4)      # (data, model): ranks on the one card
# the float64 witness of each model's step (rows x tokens; the attention
# kernels off: the path holds them in bf16): in bf16 the full-width
# gradients are rounding-limited (the mLSTM normaliser's most: the ranks'
# grad norm may part from one device's by a factor), in float64 the ranks'
# step is one device's within SSM_TP_F64_REL. Phase 47's too: the vision
# model's one-device float64 step holds 47.6 GB of parameters, gradients
# and moments (1.49 G parameters) before its activations at these rows
SSM_TP_WITNESS = (2, 1024)
SSM_TP_F64_REL = 1e-9


def _f64_witness(cfg, opt, ctx=None):
    """``cfg``'s float64 step (attention kernels off) at ``SSM_TP_WITNESS``
    from the seeded init on ``ctx``'s ranks (their blocks, each data rank
    its rows of the batch) or on one device: the metrics."""
    cfg = dataclasses.replace(cfg, compute_dtype="float64",
                              param_dtype="float64", attn_flash="off")
    params = _family_params(cfg, 0)
    batch = _family_batch(cfg, *SSM_TP_WITNESS, 0)
    if ctx is not None:
        params = shard_params(params, train_state_specs(cfg, ctx)["params"],
                              ctx.mesh)
        n = SSM_TP_WITNESS[0] // ctx.mesh.shape["data"]
        k = ctx.mesh.coord("data")
        batch = {key: v[k * n:(k + 1) * n] for key, v in batch.items()}
    free_memory()
    state = {"params": params, "opt": adamw.init(opt, params)}
    _, m = make_train_step(cfg, opt, ctx).step_fn(state, batch)
    out = {k: float(v) for k, v in m.items()}
    del state, params, batch
    free_memory()
    return out


def _ssm_tp_cfgs():
    """Phase 44's xlstm-1.3b and zamba2-7b (:func:`_families_fsdp_cfgs`:
    full width, its depth cut, bf16 compute, full remat) with
    ``fsdp=False``, and its optimizer: one device runs them as phase 44's
    one-device record does."""
    return [(dataclasses.replace(cfg, fsdp=False), opt)
            for cfg, opt in _families_fsdp_cfgs()
            if cfg.family in ("ssm", "hybrid")]


def _tp_family_job(mesh, out_path, cfgs):
    """Phases 46-47's work on a tensor-parallel mesh, on every rank: each
    config of ``cfgs`` in turn, the rank's blocks of the seeded init, one
    train step on its data block of the seeded batch (phase 44's) with the
    attention kernels' geometries recorded (and a second one, timed only),
    then its float64 witness (:func:`_f64_witness`); zamba2-7b's blocks
    after it against the same slices of the one-device result
    (``FAMILY_ONE_FILE`` beside ``out_path``); the serve steps of every
    model but xlstm-1.3b (:func:`_family_fsdp_serve`, every rank the whole
    batch; the logits saved beside ``out_path``). Returns the results on
    rank 0, None on the others."""
    import torch.distributed as dist
    one_path = os.path.join(os.path.dirname(out_path), FAMILY_ONE_FILE)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    n = FAMILY_FSDP_BATCH // mesh.shape["data"]
    mine = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    out = {}
    for cfg, opt in cfgs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        specs = train_state_specs(cfg, ctx)["params"]
        blocks = shard_params(_family_params(cfg, 0), specs, mesh)
        free_memory()
        state = {"params": blocks, "opt": adamw.init(opt, blocks)}
        batch = {k: v[mine] for k, v in _family_batch(
            cfg, FAMILY_FSDP_BATCH, TRAIN_SEQ, 0).items()}
        step_fn = make_train_step(cfg, opt, ctx).step_fn
        torch.cuda.synchronize()
        att.reset_launches()        # this family's path starts here
        compat.reset_counts()
        with att_geometries() as seen:
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            metrics = {k: float(v) for k, v in m.items()}
            step_s = time.perf_counter() - t1
        launches = dict(att.LAUNCHES)   # read right after it
        counts = (compat.read_counts(reduce=True),
                  compat.read_counts(reduce=True, backward=True))
        peak = torch.cuda.max_memory_allocated()
        state_gb = (tree_size_bytes(state["params"])
                    + tree_size_bytes(state["opt"])) / 1e9
        gaps, serve, serve_ms = None, None, []
        if cfg.family == "hybrid":
            want = shard_params(torch.load(one_path, mmap=True,
                                           weights_only=True), specs, mesh)
            gaps = []
            for got, w in zip(tree_leaves(state["params"]),
                              tree_leaves(want)):
                gap = (got.cpu().double() - w.double()).abs()
                gaps.append((float(gap.max()), float(w.abs().max())))
            del want
        # a second step, timed only: the first pays the process's warm-up
        # of this model's path
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        warm_s = time.perf_counter() - t1
        del state, blocks, batch, step_fn, m
        free_memory()
        if cfg.family != "ssm":
            serve = _family_fsdp_serve(cfg, mesh, times=serve_ms)
        witness = _f64_witness(cfg, opt, ctx)
        geos = sorted([k, g, sq, sk, dd, str(dt)[6:], c, bq, bk]
                      for k, (g, sq, sk, dd, dt, c, bq, bk) in seen)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (launches, peak, geos, step_s, gaps,
                                       serve_ms, warm_s, state_gb))
        if serve is not None and mesh.rank == 0:
            path = f"{out_path}.{cfg.name}.serve.pt"
            torch.save(serve[0], path)
            serve = {"path": path, "collectives": serve[1]}
        out[cfg.name] = {
            "metrics": metrics, "collectives": counts, "serve": serve,
            "witness": witness,
            "launches_by_rank": [e[0] for e in every],
            "peak_gb_by_rank": [e[1] / 1e9 for e in every],
            "geometries_by_rank": [e[2] for e in every],
            "step_s_by_rank": [e[3] for e in every],
            "warm_step_s_by_rank": [e[6] for e in every],
            "gaps_by_rank": [e[4] for e in every],
            "serve_ms_by_rank": [e[5] for e in every],
            "state_gb_by_rank": [e[7] for e in every],
            "weight_decay": opt.weight_decay,
            "seconds": time.perf_counter() - t0}
    if mesh.rank != 0:
        return None
    return {"families": out, "backend": dist.get_backend()}


def _ssm_tp_job(mesh, out_path):
    """Phase 46's work on (1,4), on every rank: :func:`_tp_family_job` of
    :func:`_ssm_tp_cfgs`."""
    return _tp_family_job(mesh, out_path, _ssm_tp_cfgs())


def _hold_tp_family(smi, phase, cfg, opt, r, want_m, one_serve, mesh_shape,
                    cut, seed, results):
    """Phases 46-47's checks of one model's job results ``r`` (rank 0's,
    from :func:`_tp_family_job`) on ``mesh_shape``: loss and ce within
    ``TP_LOSS_REL`` of the one-device step (``want_m``), the float64
    witness within ``SSM_TP_F64_REL`` of one device's in loss, ce and grad
    norm, B3-B5 ``train_launches`` on every rank, each held against its
    plain version at the geometry the path launched it at (``seed`` its
    draws), the bytes by kind, summed over the ranks, ``count_step``'s for
    the cell times the ranks (the all-reduces less the grad norm's scalar
    and, over data, the loss metrics' mean), zamba2-7b's blocks within
    ``_param_bound`` of the one-device result, and the serve steps' float32
    logits no further from the one-device float64 logits than
    ``WITNESS_FACTOR`` times the one-device float32 logits are (plus
    ``SERVE_SLACK``; ``one_serve``: those two by dtype), their bytes the
    count's (times ``data``: every rank serves the whole batch, which the
    count splits over data) beside the last logits' gather over model.
    Emits the model's line (``phase``, with its ``checks``) and returns
    (the names of the failed checks, the launches summed over the
    ranks)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    pc = _process_cases()
    d, m = mesh_shape
    n = d * m
    checks = {}     # what is held: True where it holds
    rel = {k: abs(r["metrics"][k] - want_m[k]) / abs(want_m[k])
           for k in ("loss", "ce")}
    checks["loss"] = max(rel.values()) <= TP_LOSS_REL
    wit_one = _f64_witness(cfg, opt)
    rel64 = {k: abs(r["witness"][k] - wit_one[k]) / abs(wit_one[k])
             for k in ("loss", "ce", "grad_norm")}
    checks["float64 witness"] = max(rel64.values()) <= SSM_TP_F64_REL
    per_step = train_launches(cfg)
    checks["launches"] = all(x == per_step for x in r["launches_by_rank"])
    launches = {k: sum(x[k] for x in r["launches_by_rank"])
                for k in per_step}
    geometries = []
    if any(per_step.values()):
        seen = {(k, (g, sq, sk, dd, getattr(torch, dt), c, bq, bk))
                for rank_geos in r["geometries_by_rank"]
                for k, g, sq, sk, dd, dt, c, bq, bk in rank_geos}
        geometries = check_path_attention(
            f"{phase} {cfg.name}", seen, FAMILY_FSDP_BATCH // d,
            cfg.n_heads_padded // m, seed, results)
    st = dryrun.count_step(cfg, ShapeConfig(
        "train", TRAIN_SEQ, FAMILY_FSDP_BATCH, "train"),
        make_mesh(d, m), target="cuda")
    got = pc.by_kind(r["collectives"])
    got["all-reduce"] = got.get("all-reduce", 0) \
        - pc.ssm_extra(d, m, itemsize=4)
    want_bytes = {k: n * v for k, v in st.collective_by_kind.items()}
    checks["bytes"] = set(got) == set(want_bytes) and all(
        abs(got[k] - want_bytes[k]) <= n for k in got)
    checks["count whole"] = not st.count_short
    extra = {}
    if r["gaps_by_rank"][0] is not None:
        lrs, worst = [want_m["lr"]], 0.0
        for gaps in r["gaps_by_rank"]:
            for mx, pmax in gaps:
                worst = max(worst, mx / _param_bound(
                    lrs, r["weight_decay"], pmax))
        checks["params"] = worst <= 1.0
        extra["params_worst_over_bound"] = worst
    if r["serve"] is not None:
        outs = torch.load(r["serve"]["path"], weights_only=True)
        coll = r["serve"]["collectives"]
        one32, one64 = one_serve["float32"], one_serve["float64"]

        def rel_gap(a, b):
            return _gap(a, b) / float(b.abs().max())
        serve_gaps = {
            "ranks_vs_one_f32": [rel_gap(a, b) for a, b in zip(outs, one32)],
            "ranks_vs_f64": [rel_gap(a, b) for a, b in zip(outs, one64)],
            "one_f32_vs_f64": [rel_gap(a, b) for a, b in zip(one32, one64)]}
        checks["serve"] = all(
            g <= WITNESS_FACTOR * w + SERVE_SLACK for g, w in zip(
                serve_gaps["ranks_vs_f64"], serve_gaps["one_f32_vs_f64"]))
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        sv = FAMILY_FSDP_SERVE
        # the last position's logits, vocab blocks over model (each rank
        # the whole batch)
        gathered = 0 if cfg.vocab_size % m else d * m * (m - 1) \
            * sv["batch"] * (cfg.vocab_size // m) * 4
        serve_bytes, serve_want = [], []
        for kind, c in zip(("prefill", "decode"), coll):
            cs = dryrun.count_step(f32, ShapeConfig(
                kind, sv["prompt"], sv["batch"], kind),
                make_mesh(d, m), target="cuda")
            got_s = pc.by_kind(c)
            want_s = {k: d * n * v for k, v in cs.collective_by_kind.items()}
            if gathered:
                want_s["all-gather"] = want_s.get("all-gather", 0) \
                    + gathered
            serve_bytes.append(got_s)
            serve_want.append(want_s)
        checks["serve bytes"] = all(
            set(a) == set(b) and all(abs(a[k] - b[k]) <= n for k in a)
            for a, b in zip(serve_bytes, serve_want))
        ms = r["serve_ms_by_rank"]
        extra.update(serve_gaps=serve_gaps, witness_factor=WITNESS_FACTOR,
                     serve_slack=SERVE_SLACK, serve_bytes=serve_bytes,
                     serve_count_bytes=serve_want,
                     prefill_ms_by_rank=[x[0] for x in ms],
                     decode_ms_by_rank=[x[1] for x in ms],
                     serve_shape=[sv["batch"], sv["prompt"]])
    n_params = sum(math.prod(t.shape) for t in tree_leaves(
        abstract_params(model_template(cfg))))
    emit(phase, gpu=smi, arch=cfg.name, family=cfg.family, mesh=[d, m],
         ranks=n, reduced={k: v for k, v in cut}, param_count=n_params,
         batch=FAMILY_FSDP_BATCH, seq_len=TRAIN_SEQ,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat, checks=checks,
         metrics=r["metrics"], one_device_metrics=want_m, rel=rel,
         witness=dict(shape=list(SSM_TP_WITNESS), metrics=r["witness"],
                      one_device=wit_one, rel=rel64),
         launches=launches, launches_per_rank_step=per_step,
         geometries=geometries, bytes_per_step=got,
         count_step_bytes=want_bytes,
         gb_per_step=sum(want_bytes.values()) / 1e9,
         step_ms_by_rank=[1e3 * x for x in r["step_s_by_rank"]],
         warm_step_ms_by_rank=[1e3 * x for x in r["warm_step_s_by_rank"]],
         peak_gb_by_rank=r["peak_gb_by_rank"],
         state_gb_by_rank=r["state_gb_by_rank"],
         job_seconds=r["seconds"], **extra)
    return [f"{cfg.name}: {k}" for k, ok in checks.items() if not ok], \
        launches


def phase_mesh_ssm_tp(smi, spawned=None, one=None):
    """Phase 46: the SSM and hybrid blocks under the model axis over
    processes (``models/ssm.py`` with ``models.sharding.InnerSplit``: each
    rank its blocks of every ``d_inner`` leaf as the reference's rules lay
    them and its heads, the fused projections re-laid onto them on the
    activations; zamba2-7b's shared block on the dense tensor-parallel
    route). xlstm-1.3b and zamba2-7b at phase 44's cut (:func:`_ssm_tp_cfgs`,
    full width, ``fsdp=False``), one step at ``FAMILY_FSDP_BATCH`` x
    ``TRAIN_SEQ`` on ``SSM_TP_MESH`` (1,4), a job of the one world of 4,
    held by :func:`_hold_tp_family` against phase 44's one-device step on
    the same state and batch (``one``: :func:`families_one_device_record`,
    made here where None; B3-B5 at 4 rows x 8 of 32 heads; zamba2-7b's
    serve steps against its float32 and float64 serve records). Each
    family's line is emitted before its checks fail the phase. Recorded:
    ms of the step, of a second step (timed only: the first pays the
    processes' warm-up of the model's path), of the prefill and the
    decode, and peak GB, on each rank. ``spawned``:
    :func:`run_card_ranks`'s results (its own spawn here where None).
    Returns the launches by path, summed over the ranks."""
    free_memory()
    d, m = SSM_TP_MESH
    tmp = tempfile.mkdtemp(prefix="mesh_ssm_tp_")
    by_path, results = {}, []
    try:
        one = one or families_one_device_record(tmp)
        spawned = spawned or run_card_ranks(tmp, None, [
            (d * m, (("ssm_tp", SSM_TP_MESH),))])
        job = spawned["ssm_tp", SSM_TP_MESH]
        assert job["backend"] == "gloo", job["backend"]
        failed = []
        for i, (cfg, opt) in enumerate(_ssm_tp_cfgs()):
            bad, launches = _hold_tp_family(
                smi, "mesh_ssm_tp", cfg, opt, job["families"][cfg.name],
                one["steps"][cfg.name], one["serve"], SSM_TP_MESH,
                dict(FAMILY_FSDP_CUTS)[cfg.name], 460 + 10 * i, results)
            failed += bad
            by_path[f"mesh_ssm_tp {cfg.name}"] = launches
            free_memory()
        emit("mesh_ssm_tp_done", gpu=smi, failed=failed,
             seconds=job["seconds"])
        assert not failed, failed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


# ---------------------------------------------------------------------------
# phase 47: the vision and encoder-decoder cross layers under the model axis
# over processes
# ---------------------------------------------------------------------------

# each model at phase 44's cut with fsdp=False on its mesh (data, model) of
# ranks sharing the one card, a job each of the one world of 4: the vision
# model on (1,4) (8 of its 32 heads and 8 kv heads a rank: 2 kv heads); the
# audio model on (2,2), since 4 ranks do not divide its vocab of 256,206
# (each rank would hold the table, the head and 4 x 2048 x 256,206 float32
# logits whole, 8.4 GB a rank before the cross-entropy's copies), 2 do
# (128,103 a rank, 2 rows a data rank)
CROSS_TP_CARD = ((VISION_ARCH, (1, 4)), (AUDIO_ARCH, (2, 2)))


def _cross_tp_cfgs(mesh_shape=None):
    """Phase 44's llama-3.2-vision-11b and seamless-m4t-medium
    (:func:`_families_fsdp_cfgs`) with ``fsdp=False``, and its optimizer,
    in ``CROSS_TP_CARD``'s order: those of ``mesh_shape`` alone where
    given."""
    meshes = dict(CROSS_TP_CARD)
    return [(dataclasses.replace(cfg, fsdp=False), opt)
            for cfg, opt in _families_fsdp_cfgs()
            if cfg.name in meshes and mesh_shape in (None, meshes[cfg.name])]


def _cross_tp_job(mesh, out_path):
    """Phase 47's work on ``mesh``, on every rank: :func:`_tp_family_job`
    of the model of ``CROSS_TP_CARD`` that runs on that mesh's shape."""
    return _tp_family_job(mesh, out_path, _cross_tp_cfgs(
        (mesh.shape["data"], mesh.shape["model"])))


def phase_mesh_cross_tp(smi, spawned=None, one=None):
    """Phase 47: the vision and encoder-decoder cross layers under the
    model axis over processes (``models.attention.cross_attention(tp=)``:
    each rank its block of the heads and kv heads, ``copy_to`` at each
    projection's input, the tanh gate after the all-reduce; the audio
    encoder on the rank's heads and FFN columns, its output whole on every
    rank). Each model of ``CROSS_TP_CARD`` at phase 44's cut (full width,
    ``fsdp=False``, bf16 compute, full remat), one step at
    ``FAMILY_FSDP_BATCH`` x ``TRAIN_SEQ`` on its mesh (the vision model's
    (1,4), the audio model's (2,2)), jobs of the one world of 4, held by
    :func:`_hold_tp_family` against phase 44's one-device step on the same
    state and batch (``one``: :func:`families_one_device_record`, made
    here where None): B3-B5 at the vision model's 4 rows x 8 of 32 heads
    ((2048, 2048, 128) causal, (2048, 1600, 128) non-causal) and the audio
    model's 2 rows x 8 of 16 heads; the float32 prefill of 4 x 64 with the
    frontend's embeddings and one decode step against one device's
    float32 and float64 serve steps, made here after the spawn. Each
    model's line is emitted before its checks fail the phase. ``spawned``:
    :func:`run_card_ranks`'s results (its own spawn here where None).
    Returns the launches by path, summed over the ranks."""
    free_memory()
    tmp = tempfile.mkdtemp(prefix="mesh_cross_tp_")
    by_path, results = {}, []
    try:
        one = one or families_one_device_record(tmp)
        spawned = spawned or run_card_ranks(tmp, None, [
            (4, tuple(("cross_tp", s) for _, s in CROSS_TP_CARD))])
        failed, seconds = [], {}
        for i, (cfg, opt) in enumerate(_cross_tp_cfgs()):
            shape = dict(CROSS_TP_CARD)[cfg.name]
            job = spawned["cross_tp", shape]
            assert job["backend"] == "gloo", job["backend"]
            one_serve = {dt: _family_fsdp_serve(cfg, dtype=dt)[0]
                         for dt in ("float32", "float64")}
            free_memory()
            bad, launches = _hold_tp_family(
                smi, "mesh_cross_tp", cfg, opt, job["families"][cfg.name],
                one["steps"][cfg.name], one_serve, shape,
                dict(FAMILY_FSDP_CUTS)[cfg.name], 470 + 10 * i, results)
            failed += bad
            seconds[cfg.name] = job["seconds"]
            by_path[f"mesh_cross_tp {cfg.name}"] = launches
            del one_serve
            free_memory()
        emit("mesh_cross_tp_done", gpu=smi, failed=failed, seconds=seconds)
        assert not failed, failed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_path


def kernels_line(results, timed, launches, serve_flash, att_results,
                 att_timed, att_launches, paper, ssm, ssm_serving,
                 moe_serving, mla_serving, cross_serving, faults_flash,
                 load_int8, restart_launches, family_launches, surface):
    """One row per TPU kernel. ``launches`` / ``att_launches`` are the
    counts read after the tinyllama serving and training paths,
    ``serve_flash`` the forward kernel's count in tinyllama's serving
    oracle, ``paper`` and ``ssm`` the (checks, times, counts) of phases
    9-10, ``ssm_serving``, ``moe_serving`` and ``mla_serving`` the counts
    read after each of those serving paths, ``cross_serving`` phase 18's
    (launches, checks, times) per model, ``faults_flash``, ``load_int8``
    and ``restart_launches`` the counts of phases 19-21, ``family_launches``
    those of phases 22-26 by phase and model: rows 2-5 add what those paths
    launched (the int8 head; the oracles' attention, zamba2-7b's shared
    block at head_dim 112, the MTP layer's, and the cross layers' in the
    kernel's non-causal mode; the restarted training's and the families'
    training's three attention kernels). ``surface`` holds phases 27-31's
    counts by path (the quickstart per arch, ``kernel_bench``,
    ``multiprecision``, ``attention_long``'s rows and gates), phases 33
    and 35's (``mesh_pipeline``, ``mesh_train``), phase 37's counted
    step (``dryrun``), phase 38's NCCL step, summed over its ranks
    (``mesh_processes``), and phases 39-47's steps and engines, summed
    over their ranks: every row adds those that launched it."""
    def err_of(check, res=results):
        return next(r["max_err"] for r in res if r["check"] == check)
    tag = "x".join(map(str, PATH_SHAPE))
    bf16, int8 = timed["bfloat16"], timed["int8"]
    rows = [
        {"name": "matmul", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/matmul.py:74",
         "launches": launches["matmul"],
         "max_abs_err": err_of(f"matmul bfloat16->f32 {tag}"),
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
         "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
         "library_ms": bf16["library_ms"], "shape": list(PATH_SHAPE),
         "dtype": "bfloat16->float32", "kernel_route": bf16["route"],
         "routes_checked": sorted(ROUTES_RAN), "shapes": timed["shapes"]},
        {"name": "matmul_int8", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/matmul.py:137",
         "launches": launches["matmul_int8"],
         "max_abs_err": err_of(f"matmul_int8 int32 {tag}"),
         "ms": int8["ms"], "plain_ms": int8["plain_ms"],
         "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
         "library_ms": int8["library_ms"],
         "library_note": int8["library_note"], "shape": list(PATH_SHAPE),
         "dtype": "int8->int32", "kernel_route": int8["route"],
         "routes_checked": sorted(INT8_ROUTES_RAN),
         "shapes": timed["int8_shapes"]},
    ]
    checks = {"flash_fwd": "flash_fwd out train bfloat16 causal",
              "flash_bwd_dq": "flash_bwd_dq train bfloat16 causal",
              "flash_bwd_dkv": "flash_bwd_dkv dk train bfloat16 causal"}
    replaces = {"flash_fwd": "src/repro/kernels/attention.py:131",
                "flash_bwd_dq": "src/repro/kernels/attention.py:276",
                "flash_bwd_dkv": "src/repro/kernels/attention.py:293"}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t = att_timed[name]
        err = err_of(checks[name], att_results)
        if name == "flash_bwd_dkv":
            err = max(err, err_of("flash_bwd_dkv dv train bfloat16 causal",
                                  att_results))
        rows.append({"name": name, "route": "cuda", "source": ATT_SOURCE,
                     "replaces": replaces[name],
                     "launches": att_launches[name], "max_abs_err": err,
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": list(TRAIN_ATT),
                     "dtype": "bfloat16, causal"})
    # rows 2-3 run on more than one path: each path's count, set to 0 just
    # before it and read just after, and their sum
    restart = f"train_restart tinyllama-1.1b ({RESTART_LAYERS} layers)"
    rows[1]["launches_by_path"] = {
        "serve tinyllama-1.1b": launches["matmul_int8"],
        **{f"serve {a}": v["matmul_int8"] for a, v in ssm_serving.items()},
        f"serve_moe {MOE_ARCH}": moe_serving["matmul_int8"],
        f"serve_mla engine {MLA_ARCH}": mla_serving["matmul_int8"],
        "serving_load tinyllama-1.1b": load_int8}
    rows[2]["launches_by_path"] = {
        "train tinyllama-1.1b": att_launches["flash_fwd"],
        restart: restart_launches["flash_fwd"],
        f"serve_faults oracle tinyllama-1.1b ({EXACT_LAYERS} layers)":
            faults_flash,
        "serve_exact oracle tinyllama-1.1b": serve_flash,
        **{f"serve_exact oracle {a}": v["flash_fwd"]
           for a, v in ssm_serving.items()},
        f"serve_moe_exact oracle {MOE_ARCH}": moe_serving["flash_fwd"],
        f"serve_mla lm_loss (MTP layer) {MLA_ARCH}": mla_serving["flash_fwd"],
        **{f"serve_cross {a} {dt} (non-causal)": n
           for a, v in cross_serving.items() for dt, n in v[0].items()}}
    for row in rows[3:5]:
        row["launches_by_path"] = {
            "train tinyllama-1.1b": att_launches[row["name"]],
            restart: restart_launches[row["name"]]}
    for row in rows[2:5]:
        row["launches_by_path"].update(
            {path: n[row["name"]] for path, n in family_launches.items()})
    rows[0]["launches_by_path"] = {"serve tinyllama-1.1b": launches["matmul"]}
    # the forward also at zamba2-7b's oracle shape (its own times and bound)
    rows[2]["zamba2_oracle"] = {
        dt: {k: att_timed[f"flash_fwd_zamba2_{dt}"][k]
             for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
        for dt in ("float32", "bfloat16")}
    # the non-causal mode at the cross layers' shapes (Sq = prompt and 1)
    rows[2]["cross_shapes"] = {a: v[2] for a, v in cross_serving.items()}
    # the three kernels at the family train steps' shapes (phase attention)
    for row in rows[2:5]:
        row["train_shapes"] = {
            tag: {"shape": t["shape"], "causal": t["causal"],
                  **t[row["name"]]}
            for tag, t in att_timed["train_shapes"].items()}
    p_res, p_timed, p_launches = paper
    for name, key, check, shape in (
            ("axpy", "axpy_f32_2^26", "path axpy f32 2^26", [AXPY_N]),
            ("conv2d_direct", "conv_googlenet1_f32",
             "path dconv f32 googlenet1", list(GOOGLENET_L1))):
        t = p_timed[key]
        rows.append({"name": name, "route": "cuda",
                     "source": AXPY_SOURCE if name == "axpy" else CONV_SOURCE,
                     "replaces": "src/repro/kernels/axpy.py:38"
                     if name == "axpy" else "src/repro/kernels/conv.py:50",
                     "launches": p_launches[name],
                     "max_abs_err": err_of(check, p_res),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": shape,
                     "dtype": "float32"})
        if name == "axpy":     # the turns against torch.add, every size
            rows[-1]["turns"] = {k_[5:]: {**v_["turns"],
                                          "bound_ms": v_["bound_ms"]}
                                 for k_, v_ in p_timed.items()
                                 if k_.startswith("axpy_")}
    s_res, s_timed, s_launches = ssm
    t = s_timed["zamba2-7b"]
    bh, s_, n, p = t["shape"]
    rows.append({"name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE,
                 "replaces": "src/repro/kernels/ssm_scan.py:67",
                 "launches": s_launches["ssm_scan"],
                 "max_abs_err": err_of(
                     f"ssm_scan zamba2-7b ({bh},{s_},{n},{p}) c{t['chunk']} "
                     f"float32", s_res),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "shape": t["shape"],
                 "dtype": f"float32, chunk {t['chunk']}",
                 "layers": {k_: {f: v_[f] for f in ("shape", "dtype", "ms",
                                                     "plain_ms", "bound_ms")}
                            for k_, v_ in s_timed.items()
                            if isinstance(v_, dict)}})
    # phases 27-31: each kernel's count on each path that launched it
    rows[5]["launches_by_path"] = {"paper_kernels": p_launches["axpy"]}
    rows[6]["launches_by_path"] = {
        "paper_kernels": p_launches["conv2d_direct"]}
    rows[7]["launches_by_path"] = {"ssm_kernel": s_launches["ssm_scan"]}
    for path, counts in surface.items():
        for row in rows:
            if counts.get(row["name"]):
                row["launches_by_path"][path] = counts[row["name"]]
    for row in rows:
        row["launches"] = sum(row["launches_by_path"].values())
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched "
                                 f"{row['name']}: {rows}")
    return {"kernels": rows}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    _T0.append(t_start)
    smi = phase_env()
    phase_build()
    results, timed = phase_kernels()
    att_results, att_timed = phase_attention()

    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_template(cfg), gen, device=DEV)
    phase_serve(cfg, params)          # sets the matmul counts to 0 first
    serve_flash = phase_serve_exact(cfg, params)
    launches = dict(mm.LAUNCHES)      # read right after the serving path
    faults_flash = phase_serve_faults(cfg, params)  # each sets its counts
    load_int8 = phase_serving_load(cfg, params)     # to 0 first
    del params
    free_memory()

    att_launches = phase_train(att_timed)   # sets its counts to 0 first
    free_memory()
    phase_train_exact()
    free_memory()
    restart_launches = phase_train_restart()    # sets its counts to 0 first
    free_memory()
    family_launches = run_family_training()     # each sets its counts to 0

    paper = phase_paper_kernels()           # each sets its counts to 0 first
    ssm = phase_ssm_kernel()
    free_memory()
    ssm_serving = run_ssm_serving()
    free_memory()
    cfgs = serving_cfgs()
    moe_serving = run_moe_serving(cfgs[MOE_ARCH])
    mla_serving = run_mla_serving(cfgs[MLA_ARCH])
    cross_serving = run_cross_serving([cfgs[VISION_ARCH], cfgs[AUDIO_ARCH]])
    _, _, listing = phase_vector_engine(smi)
    phase_vector_engine_lanes(smi, listing)
    free_memory()
    surface = phase_quickstart()            # each sets its counts to 0 first
    surface["kernel_bench"] = phase_kernel_bench()[2]
    surface["multiprecision"] = phase_multiprecision()[2]
    free_memory()
    surface.update(phase_attention_long()[0])
    free_memory()
    phase_engine_throughput()
    free_memory()
    surface.update(run_mesh(smi))           # each sets its counts to 0 first
    free_memory()
    surface["dryrun"] = phase_dryrun(smi)   # sets its counts to 0 first
    free_memory()
    surface["mesh_processes"] = phase_mesh_processes(smi)  # fresh processes
    free_memory()
    tmp = tempfile.mkdtemp(prefix="one_device_")
    try:
        one = one_device_record(tmp)       # phases 39 and 40 hold to it
        free_memory()
        fam_one = families_one_device_record(tmp)   # phases 44, 46-47
        free_memory()
        eng_one = engine_one_device_record(one[1])  # phase 45 holds to it
        free_memory()
        spawned = run_card_ranks(tmp, one[1])   # phases 39-47's ranks
        surface.update(phase_mesh_tensor_parallel(smi, one, spawned))
        free_memory()
        surface.update(phase_mesh_fsdp(smi, one, spawned))
        free_memory()
        surface.update(phase_mesh_moe(smi, spawned))
        free_memory()
        mla_one = mla_one_device_record(smi)    # phases 42 and 43 hold to it
        surface.update(phase_mesh_mla(smi, spawned, mla_one))
        free_memory()
        surface.update(phase_mesh_mla_fsdp(smi, spawned, mla_one))
        free_memory()
        surface.update(phase_mesh_families_fsdp(smi, spawned, fam_one))
        free_memory()
        surface.update(phase_mesh_engine_fsdp(smi, spawned, eng_one))
        free_memory()
        surface.update(phase_mesh_ssm_tp(smi, spawned, fam_one))
        free_memory()
        surface.update(phase_mesh_cross_tp(smi, spawned, fam_one))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps(kernels_line(results, timed, launches, serve_flash,
                                  att_results, att_timed, att_launches, paper,
                                  ssm, ssm_serving, moe_serving, mla_serving,
                                  cross_serving, faults_flash, load_int8,
                                  restart_launches, family_launches,
                                  surface)),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
