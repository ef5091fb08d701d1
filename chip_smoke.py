"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), require CUDA,
   turn TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (every ``femnist_cnn`` leaf of >= 64
   elements at N_b = 16 clients, the whole (16, 6,603,710) update matrix,
   and ragged widths; for STC also ``stc_topk.adversarial_rows``, 8193
   and 20001 wide), and time kernel, plain version and — where one
   PyTorch call computes the same function — that call (median of CUDA
   events over 20 runs; K2 also by device time); K3b also with its int8
   output (the sequential int8 stage's q), equal to the plain version's;
   K3a's max and scale (one launch) bit for bit on edge rows (NaN, +-inf,
   -0.0, subnormals, below 1e-12; ``rowmax_rows``) at every leaf, at the
   sequential stage's (1, 6,422,528) and on views whose rows start off a
   16-byte boundary, eagerly and in 3 replays of a captured launch
   (``check_rowmax``), timed by CUDA events, device and graph time beside
   ``vector_norm(inf)``'s, also at (1, 6,422,528) and (1, 620,756,992);
   K1's routes of several blocks or tiers (``check_k1_routes``: the tree at
   fanout 0 and 3, the sharded route on 2 and 4 shards of the card at
   fanout 0 and 2) bit for bit their plain versions, eagerly and in 3
   graph replays, with no padded (rows, D) copy, at (16, 6,603,710) (a
   tier of 2 groups of 8, then one combining launch of the 2 partials) and
   (10, 1,000,003); the grouped launch at 2 groups of 8 and 10 rows padded
   to 12 in groups of 3 at D = 1,000,003; the first tier timed beside
   ``einsum("gf,gfd->gd")``, the second tier timed on its own;
   K2 and K3a / K3b on the federated round's largest row, glm4-9b's
   embedding leaf as one (1, 620,756,992) row (``check_embed_row``);
3b. print the three flash-attention kernels' resources at D = 64, 128,
   192 and 256 (``FLASH_DIMS``: the template instances that a main path
   runs) as the runtime reads them
   (``cudaFuncGetAttributes``: registers, local memory = spills and stack,
   dynamic shared memory; CTAs per SM) and the count of TF32 tensor-core
   instructions (``HMMA``) in each one's SASS, from ``cuobjdump`` where the
   toolkit has it (each must have some); hold the kernels (forward, dQ,
   dK/dV) against their plain versions at the LoRA path's shape (BH = 4
   clients x 4 sequences x 32 heads = 512, S = 512, D = 128, causal), at
   (512, 512, 192 / 256, causal), at phase 4m's main-path shapes (96,
   1024, 192), (16, 512, 256) and (48, 448, 64), causal, at (3, 200, 72 /
   160 / 200, causal) and (2, 130, 128 / 192 / 256, not causal), at
   ragged S in {1, 63, 200} x D in {20, 64}, causal and not, and at the
   edges of the 8-warp pair kernels' head-dim split above D 128
   (``FLASH_PAIR_EDGES``: D 129, 130, 136, 193, 255 x S 1, 65, 520 x BH 1,
   133, causal and not); forward within 1e-5, gradients within 1e-4 at
   unit-scale inputs; print each instance's grid at its timed shape and
   threads a CTA; time each instance at
   ``FLASH_TIMED``'s shape (whisper's (48, 448, 64) for DP 64, (512, 512,
   D) for the others), causal, next to its plain version and fp32 ``scaled_dot_product_attention`` (its
   forward for the forward kernel, its backward — forward + backward minus
   forward — for the two backward kernels); bound each on the tensor cores
   in 3xTF32 (the units the kernels run on) and, beside it, on the fp32
   CUDA cores; the D 192 and 256 instances are timed the same way at
   phase 4m's main-path shapes too (``FLASH_ZOO_TIMED``: (96, 1024, 192)
   and (16, 512, 256)), into their rows' ``at_main_path``;
3c. print the WKV6 kernel's (K8) resources at hd 64 and its ``HMMA``
   count, as phase 3b; hold it against its plain version at the
   ``rwkv6-1.6b`` prefill shape (16 x 512 tokens, 32 heads of 64) and two
   small shapes, within 1e-4 of each output's scale, under extreme decay
   (log w = -e^6, every third step -e^-8: finite, within 3e-2), and
   through ``time_mix``'s padding at a ragged length (200 tokens, full
   width) against the model's own ``wkv6_chunked``; bound it with its
   products on the 3xTF32 tensor cores and, beside that, all on the fp32
   CUDA cores; the dense STC (K4) and the dense int8 quantize / dequantize
   (K5) against theirs at the ``bench_compression`` size 2^20 and a ragged
   1,000,003, and K4 on the adversarial rows, one a segment (STC masks,
   signs and counts bitwise, values within 1 ulp; q, scales and
   dequantized values bitwise); K5 also on ``check_k5_edges``'s cases
   (lengths 1 to 1,000,003, f32 / bf16 / f16, data 16-byte aligned or one
   element past, zero / subnormal / tie / NaN / inf tiles); print K5's
   resources (registers, spills, static shared memory, CTAs per SM) and
   its CTAs at 2^20 against the SMs; time each as in phase 3, and
   K4/K5 and ``torch.mul(q, s)`` also by device time (``torch.profiler``,
   20 calls), the host's launch path left out, and K5 and ``torch.mul``
   by CUDA-graph replay (``graph_ms``);
4. drive the main path through the public entry points: ``init`` + ``run``
   on ``femnist_cnn`` / ``femnist`` at full width, 3 rounds of 10 clients,
   ``execution="batched"``, ``aggregation_kernel=True``, once per
   ``client.compression`` in none / stc / int8, with the kernel launch
   counters set to 0 just before each run and read just after; on the card
   a fused round runs as one CUDA graph a bucket (round 0 eager, round 1
   captured, round 2 replayed: ``core/batched.py::CapturedRound``), and
   the counters count each replay's launches (phase 4p compares);
4b. drive the LoRA path the same way: GLM-4-9B at its published width cut
   to 2 layers (f32, 1.65 B base parameters, attention projections drawn
   at the published models' scale: ``glm4_2layer``), ``make_tiny_lm``
   sequences of 512 tokens, ``finetune="lora"`` rank 8 / alpha 16 on the
   attention projections, 8 clients, 4 per round, batch 4, 2 rounds, once
   with the flash flag on and once off; the flash kernels must launch in
   the first run only and the final adapters of the two runs agree within
   1e-4; then LoRA beyond the batched engine, flash on: the sequential
   engine (its client step one CUDA graph, K6/K7 inside it: 1 capture, 0
   recaptures, counts printed) and the async engine (2 aggregations of
   4, uniform speeds: the degenerate case) held against the batched
   flash-on run within max(1e-4, 2 x how far that run moves from a
   1e-7-perturbed start; the async run's waves train through the
   cohort program captured (one CUDA graph a bucket, K6/K7 inside), and
   3 aggregations of it beside an eager twin (``eager_rounds``): wall per
   aggregation, peak
   GiB allocated and reserved, cohort captures and replays, adapters
   within the same bar), and batched LoRA with STC and with int8; round
   walls and peak memory (under 70 GB) of each;
4c. drive the RWKV6 serving path at full width and depth:
   ``rwkv6-1.6b`` (24 layers, bf16 activations, f32 parameters, 1.6 B
   parameters from seed 0) through ``make_prefill_step`` at 16 x 512
   tokens, three times (24 K8 launches each); then the serving CLI's
   decode at batch 16 through ``make_serve_step`` (32 prompt positions
   stepped in, 32 greedy tokens) as one CUDA graph for every position
   beside its eager twin (``capture=False``; :func:`serve_ab`: ms a step
   and tokens/s of both, captures / recaptures / replays, greedy tokens
   equal, logits within 1e-4 of their scale, peak memory, the busy share
   of two replayed steps under ``torch.profiler``), then the serving CLI
   ``repro_torch.launch.serve.main([... "--full"])`` captured and eager
   (``eager_serving``), its greedy tokens equal;
4d. drive the compression API path as ``benchmarks/bench_compression.py``
   drives the reference's: dense STC, quantize, dequantize of 2^20 f32;
4e. drive the default path, phase 4's configuration with the default
   ``execution="sequential"``: every client's stages in turn (the local
   steps and the evaluation as CUDA graphs, one a shapes key:
   ``core/local_train.py::ClientStep``, ``EvalStep``; the compression
   stage with error feedback on K2 or K3a+K3b, one ``(1, n)`` row a
   compressed leaf), then ``Server.aggregation`` on K1; the counters as in
   phase 4 (K1 3 launches, K2 only under stc, K3 only under int8), each
   step captured once a key and never again (``step_counts``); the
   ``none`` run again under ``deterministic_cudnn``, beside its eager twin
   (``eager_sequential``; :func:`sequential_ab`): final params bit for
   bit, round walls and CPU of rounds 1-2, peak; the ``none`` run's final
   params (cuDNN's default mode, as users run) against phase 4's batched
   ``none`` params, printed against 1e-4 and held within max(1e-4, twice
   how far phase 4's run moves from three inits perturbed by a relative
   1e-7: ``conditioning_gap``; 3 rounds of 10 clients amplify f32 rounding
   past 1e-4 on the card and the CPU alike); then the stage on one client's
   round-0 update
   on the card against the same stage on the CPU, bit for bit
   (``check_sequential_stage``);
4f. drive the rest of the batched engine on phase 4's configuration,
   every run under ``deterministic_cudnn``: (a) the staged path
   (``round_fusion="off"``) for none / stc / int8, its cohort program one
   CUDA graph a bucket (1 capture, 2 replays in 3 rounds), each beside its
   eager twin (``eager_rounds``; :func:`staged_ab`: final params and
   launches bit for bit, round walls, CPU of rounds 1-2, peak), (b)
   hierarchical FedAvg, fused, fanout 0, under stc, (c) the deferred round
   sync (``tracking.round_sync=False``) under int8; launch counts K1 3 a
   run flat and 6 under the tree (one grouped launch a tier, 2 tiers), K2
   or K3 18; dispatches and host syncs a round as the reference counts
   them (staged: 2 / 1 none, 3 / 2 stc, 3 / 1 int8; fused 1 / 1); final
   params against phase 4's run of the same mode, printed against 1e-4
   and held within max(1e-4, 2 x ``conditioning_gap`` of that mode), and
   each path's distance from the fused run of its mode under the same
   deterministic cuDNN (``SPREAD``: staged and deferred bit for bit, the
   tree printed); then
   ``compress_stacked`` (two rounds) and ``aggregate_stacked`` (flat and
   tree) on one stacked cohort update on the card against the CPU, bit
   for bit (``check_staged_stages``);
4g. drive phase 4's configuration under faults (``FAULTS_4G``: dropout
   0.2, crash 0.1, straggler 0.2 x 4, NaN uploads 0.1, a fixed seed; the
   norm bound 100x above the largest update norm of phase 4's round-0
   cohort, printed): fused stc, staged int8, hierarchical stc, sequential
   none, each round's dropped / crashed / straggled / rejected /
   reselections / survivors equal to a host replay of the selection RNG
   and ``FaultInjector.plan`` (``host_accounting``), one program built and
   one host sync a fused round, steady round walls printed against the
   same mode's fault-free run; then ``round_deadline=1e-12``: no client
   survives and the params stay bit for bit at their init; then, in a
   child process in deterministic mode (``--resume-check``), an all-zero
   ``faults`` block against none (bit for bit, same counters and
   launches) and kill-and-resume of fused stc with dropout and sequential
   int8 with crashes (EF device tier cut to 8 rows; 3 rounds, killed after
   2), final params and the step-3 checkpoint bit for bit, with the
   checkpoint's bytes and save and load seconds; in the same child,
   captured fused none / stc / int8 rounds and the EF-growth case (below)
   bit for bit their eager runs;
4p. (after 4g) the captured round (``run_captured``): each captured
   femnist run of phases 4, 4f and 4g (fused none / stc / int8,
   hierarchical stc, faulty stc under ``FAULTS_4G``, deferred int8)
   beside its eager twin (``capture=False``): 1 capture and 2 replays in
   3 rounds, no recapture, 1 dispatch and 1 host sync a round, launches
   counted through the replays equal to the eager run's, round walls and
   main-thread CPU seconds of rounds 1-2 (the CPU spins through a round's
   one sync, so a blocking round's CPU is about its wall; deferred int8's
   wall is its submission) and peak memory of both;
   final params within max(1e-4, 2 x the mode's 1e-7-perturbed reach);
   the EF-growth case (clients 0-9 twice, 10-19, 20-29: the store grows
   16 -> 32 rows in round 2 and that round recaptures once) against its
   eager twin; replays run under ``set_sync_debug_mode("error")``; then
   ``repro_torch.analysis.contracts.check_contracts()`` on the card;
4h. drive the paper's other two models through ``init({"dataset": ...})``
   and ``run`` at their published widths on their datasets' defaults
   (``shakespeare_lstm``: embed 8, 2 x LSTM 256, vocab 80, sequences of
   80; ``cifar_resnet18``: 11.2 M parameters, GroupNorm): batched fused
   under none and stc and sequential under none, 3 rounds of 10 clients,
   1 local epoch, launch counts as phase 4's, steady round walls and peak
   memory printed, ``shakespeare_lstm``'s batched none also beside its
   eager twin (``capture=False``: its launch-bound step loop is where
   the captured round shows most) and its sequential none beside its
   eager twin as in phase 4e (:func:`sequential_ab`); then each model's batched run on the
   card against the CPU (1 round of 2 clients, the ResNet's of 1,
   evaluation off): params and train losses within max(1e-4, 2 x how far
   the card's run moves from six 1e-7-perturbed inits), the card's runs
   under cuDNN's deterministic algorithms (``deterministic_cudnn``: with
   the defaults the ResNet's card run moved from run to run by half that
   reach, and the check passed or failed by the draw);
4i. drive the async engine (FedBuff on the virtual clock) on phase 4's
   femnist configuration, K 5 of 10 in flight, speeds pinned 1x / 4x
   alternating, K1 on: stc for 6 aggregations with a checkpoint every 2,
   its resume from step 2 in a fresh trainer (6 aggregations, history[:2]
   verbatim), ``FedBuffServer`` under int8, stc under ``FAULTS_4G`` with
   retries, and the degenerate case (K = 10 in flight, uniform speeds, 3
   aggregations) against phase 4's fused stc run at phase 5's bar; K1 one
   launch an aggregation, no fused round program; waves, buckets, the
   cohort program's captures and replays, staleness and the wall per
   aggregation printed; the stc run again with the measured wall pinned
   (``pinned_wall``) under ``deterministic_cudnn``, captured and eager
   (:func:`async_ab`): params, virtual clocks and staleness bit for bit,
   1 capture a bucket, walls a wave and CPU of both;
4j. drive the sharded cohort (``resources.distributed="data"``) on phase
   4's configuration: (a) on the default devices (the one card, 1 shard)
   fused none / stc / int8 (and, in phase 4g's deterministic child, fused
   stc on 1 shard bit for bit the unsharded run); (b) on 2 and 4 shards of
   the card (``set_devices([cuda:0] * k)``): fused stc, hierarchical stc
   at ``aggregation_fanout=2``, staged int8, fused stc under phase 4g's
   faults, and fused stc at 20 clients a round (bucket 32, beside an
   unsharded run of it); each against the unsharded run of its mode,
   printed against 1e-4 and held within max(1e-4, 2 x that run's
   1e-7-perturbed reach), round walls beside the unsharded ones; K1 once
   a card a round for all its shards (flat, or one tier of the tree), K2 /
   K3 once a leaf a shard a round; (c) the sharded routes of K1-K3 at (16,
   6,603,710) over 2 and 4 shards against the unsharded kernels (K2 / K3
   bit for bit, K1 at fanout 0 and 2 within 1e-6 relative), timed beside
   their plain versions (K1 also by graph ms) and bounded;
4k. drive remote training (``run_remote``): (a) femnist_cnn with 8
   client services (``start_client``: threads of this process, sockets on
   127.0.0.1), 4 a round, 3 rounds, through ``start_server().run()``;
   final params against the ``init(); run()`` sequential run of the same
   configuration at phase 4e's bar, train losses within 1e-3; K1 once a
   round on the server; the services' shared client step and the server's
   eval step captured once a key, never recaptured (counts printed; the
   handlers take turns on the card under its lock); then 2 rounds under ``aggregation_topology=
   "hierarchical"`` (one grouped K1 a round); (b) registry, tracker, 4
   clients and the server as ``python -m repro_torch.launch.service``
   processes on the card (2 rounds; the tracker's series, the devices
   each names, the registry and tracker without CUDA, every child ended);
   (c) the remote and sequential round walls, the transport's bytes and
   latency a round, and the host costs of one 26.4 MB message (``dumps``,
   send and receive, ``loads``, to the card and back);
4l. (run right after 4b, while the card holds nothing else) drive LLM
   training (``run_llm_training``): first the unembedding at
   glm4-9b's width (B 2, S 512) as the port computed it before (a bf16
   product cast to f32) and now (``einsum_f32``), timed and held against
   the f32 product of the bf16 operands; then (a) ``python -m
   repro_torch.launch.train``'s ``main`` on ``glm4-9b`` at its published
   width (d 4096, 32 q over 2 KV heads, FFN 13696, vocab 151552; bf16
   activations over f32 parameters) cut to 2 layers, 6 steps of 2 x 512
   tokens, flash on, then off, its ``TrainStep`` one CUDA graph (step 1
   eager, step 2 captured, later steps replayed; the state updated in
   place): finite losses, moved params, step walls, tokens/s, peak
   memory, K6 twice a layer a step (remat recomputes the forward) and K7a
   / K7b once, counted through the replays; the flash-on run beside its
   eager twin under ``deterministic_cudnn`` (:func:`train_ab`: losses and
   final params bit for bit, steady s a step, peak GiB allocated and
   reserved); the step-1 loss flash on vs off within
   max(1e-4, 2 x the flash-on run's reach from a 1e-7-perturbed init);
   (b) ``qwen3-moe-30b-a3b`` (128 experts, top 8, FFN 768 an expert, 2
   layers) 4 steps, with the aux a step and the share of assignments each
   layer drops at capacity; (c) three steps each of ``internlm2-20b`` (G
   6) and ``phi3-medium-14b`` (G 4); (d) the cross-pod federated round on
   (a)'s model, 2 pods x 2 local steps of 2 x 512 tokens, SGD lr 0.05 /
   momentum 0.9 (0 under int8_sync: its per-pod residual), flash on, 2
   rounds each of none / stc (0.01) / int8 / int8_sync: pods bit for bit
   equal, finite losses, K2 once a leaf a round under stc, K3a and K3b
   under int8, round walls and peak memory;
4m. (run right after 4l) drive the rest of the model zoo at published
   width, bf16 activations over f32 params from seed 0 on the card
   (``ZOO``: the cuts and shapes): ``nemotron-4-340b`` (1 of 96 layers,
   51.4 GB of params: serve only), ``paligemma-3b`` (all 18 layers, 256
   frames ahead of the tokens), ``deepseek-v2-lite-16b`` (2 of 27 layers:
   one dense0, one MoE of 64 experts, top 6, 2 shared), ``recurrentgemma-
   9b`` (3 of 38 layers, one (rglru, rglru, local_attn) period, S 4096 past
   the 2048 window) and ``whisper-small`` (nothing cut): three prefills
   through ``make_prefill_step`` and 8 greedy decode steps through
   ``make_serve_step`` from position S against a zero cache (a ring of
   2048 slots for local attention), the captured step beside its eager
   twin as in phase 4c (:func:`serve_ab`), then 4 train steps of
   ``launch.train.main`` (its SGD, momentum 0.9; its ``TrainStep``
   captured at step 2; not nemotron) from a
   well-conditioned redraw of the init (``well_conditioned_``: at the
   default init these archs' gradients explode with depth, in the
   reference too: ``tests/test_torch_zoo_init.py``), flash on;
   finite logits and
   losses, moved params, steady prefill / decode / step walls, tokens a
   second, peak memory, the flash launches each makes (K6 at D 192 in
   nemotron's prefill, K6/K7 at D 256 in paligemma's, at D 64 in
   whisper's decoder; none for MLA and local attention, as in the
   reference) and the MoE layer's dropped share at capacity 1.25;
4n. (run right after 4l, before 4m) drive a MoE ``transformer_lm`` through
   the batched engine: ``qwen3-moe-30b-a3b`` at published width cut to 2
   layers (``qwen3_moe_2layer``: 128 experts top 8, f32) with phase 4b's
   configuration (``lm512``, 4 of 8 clients, batch 4 x 512, 2 rounds, LoRA
   rank 8 on attention, ``aggregation_kernel``) through ``init``/``run``,
   once flash on and once off: each client's step runs under
   ``torch.func.vmap``, the MoE dispatch batched over the cohort; finite
   losses and adapters, K1 once a round, K6/K7 launched with the flag on
   and not with it off, peak memory under 70 GiB, round walls, the share
   of assignments dropped at capacity 1.25; the adapters of the two runs
   within 1e-4;
4o. run ``repro_torch.launch.dryrun`` for every arch id at ``train_4k``
   on the (16, 16) mesh (fake tensors: the card's allocated and peak
   memory must not move), print each record's roofline on H100 constants;
   then time a reduced ``glm4-9b`` train step (bf16 activations, B 8 x
   1024), its ``TrainStep`` captured and an eager twin (6 steps each),
   on the card beside its counted FLOPs, ``model_flops`` and its one-card
   roofline;
5. run the same port for 2 rounds of 4 clients from one set of injected
   parameters on the card and on the CPU and compare them, once per
   engine: train losses within 1e-4; parameters printed against 1e-4 and
   held within max(1e-4, twice the larger of how far the card's run moves
   from three 1e-7-perturbed inits (``conditioning_gap``) and how far the
   CPU's own run moves at half its thread count).  Max pooling and ReLU
   turn any rounding difference into a gap of 1e-5 to 3e-4 in either
   engine, the CPU's thread count included, so 1e-4 alone measures which
   roundings the host and the libraries happened to pick;
5b. the same for ``tiny_lm`` LoRA with the flash flag on, under the
   batched and the sequential engine;
5c. RWKV6 agreement on the card, at full width and depth in f32: the
   no-grad prefill (K8) against the grad-mode forward (``wkv6_chunked``,
   nothing recorded), and stepwise decode against the full-sequence
   forward (B 2, 64 tokens), end to end beside a 1e-7 perturbation probe
   (the random-init model's conditioning), and layer by layer on the same
   inputs (bar 1e-4 of the output's scale); then K8 and the f32 exact form
   against the same forward with its recurrence in float64
   (``float64_recurrence``): per token over tokens >= 16 (bar: K8 within
   max(2 x the exact form's gap, 1e-2 x max |logit|); the first tokens
   carry the model's conditioning) and over all tokens (printed), and per
   layer on the same input (bar: K8 within 1.5 x the exact form's
   distance); the reduced ``rwkv6-1.6b``
   prefill and the reduced ``rwkv6-1.6b`` and ``glm4-9b`` decode on the
   card against the CPU (1e-4);
5d. the reduced ``glm4-9b`` and ``qwen3-moe-30b-a3b`` 3 train steps and
   the reduced ``glm4-9b`` 2 federated rounds under stc, flash on, on the
   card and on the CPU from the same well-conditioned params and batches:
   params within max(1e-4, 2 x how far the card's run moves from a
   1e-7-perturbed init); then one batched round of the reduced
   ``qwen3-moe-30b-a3b`` as a ``transformer_lm`` without LoRA (4 of 8
   ``tiny_lm`` clients) on the card and on the CPU, at the same bar;
5e. the reduced ``nemotron-4-340b``, ``paligemma-3b``,
   ``deepseek-v2-lite-16b``, ``recurrentgemma-9b`` (2 layers, and 3 with
   local attention over 80 tokens) and ``whisper-small`` (a random
   ``enc_kv``) on the card and on the CPU from the same well-conditioned
   params and inputs, flash on: forward logits, 8 stepwise decode steps
   and one train step's params within max(1e-4, 2 x how far the card's
   run moves from a 1e-7-perturbed init);
6. print the script's time, the kernel table as one JSON line, then the
   result line.

The kernel comparisons of phase 3/3b/3c happen before the counters are
reset, so the ``launches`` reported are those of the main-path runs alone
(K1-K3 from phase 4, K1's tree route from phase 4f's hierarchical run,
the flash kernels from the flash-on run of phase 4b, K8 from phase 4c,
K4/K5 from phase 4d); K1-K3 also carry ``launches_sequential``, from phase
4e, ``launches_models``, from phase 4h, and ``launches_async``, from phase
4i, and K1-K3 and K1's tree ``launches_faults``, from phase 4g, and
``launches_sharded``, from phase 4j (a) and (b); K1 and K1's tree
``launches_remote``, from phase 4k (a); K6/K7 ``launches_train``, from
phase 4l (a)-(c)'s flash-on runs, and K2/K3 ``launches_fed``, from phase
4l (d); K1 and the DP 128 flash rows ``launches_moe``, from phase 4n's
flash-on run.  K6/K7 have a row a template instance that a main path runs:
``flash_fwd`` / ``flash_dq`` / ``flash_dkv`` (DP 128, D 65-128),
``flash_*_d64`` (launches: phase 4m's whisper-small decoder, D 64),
``flash_fwd_d192`` (phase 4m's nemotron-4-340b prefill) and
``flash_*_d256`` (phase 4m's paligemma-3b); K7 at D 192 has no main path
on one card (nemotron cannot train there), so its phase 3b measurements
sit in the DP 128 rows under ``"d192"``.

``python3 chip_smoke.py --profile`` instead profiles one steady-state round
per compression mode and engine (phases 4 and 4e), one steady round of each
phase-4h model, batched and sequential, under none, one steady LoRA round
of phase 4b's configuration,
and one ``rwkv6-1.6b`` prefill and 8 decode steps of phase 4c's
configuration (the captured serve step's replays, then its eager twin's
steps), with ``torch.profiler`` (device time by operator and the
device's busy share); ``--profile rwkv6`` profiles the last alone, and
``--profile paligemma`` one steady ``paligemma-3b`` prefill and train step
of phase 4m's configuration alone (:func:`profile_zoo`), with the flash
kernels' share.

``python3 chip_smoke.py --cards`` instead runs the sharded cohort over
two or more distinct cards, one shard a card (:func:`cards_check`).
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
N_BUCKET = 16                  # 10 selected clients -> power-of-two bucket
REPS = 20
T_START = time.perf_counter()


def phase(name):
    print(f"\n=== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sdpa_ms(q, k, v, do, heads=32):
    """The flash kernels' library yardstick: fp32 SDPA, causal, on
    (BH / heads sequences, heads, S, D) views of (BH, S, D) q, k, v, dO ->
    (forward ms, backward ms = forward + backward minus forward)."""
    import torch.nn.functional as F

    s, d = q.shape[1:]
    sq, sk, sv = (t.detach().view(-1, heads, s, d).clone().requires_grad_()
                  for t in (q, k, v))
    sdo = do.view(-1, heads, s, d)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        torch.autograd.grad(out, (sq, sk, sv), sdo)
    f = cuda_ms(fwd)
    return f, cuda_ms(fwd_bwd) - f


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """Least time the card could take: (ms, "bytes" | "operations")."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def ulps(a, b):
    """Elementwise |a - b| in units of the last place of max(|a|, |b|)."""
    a64, b64 = a.double(), b.double()
    ref = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
    return ((a64 - b64).abs() / spacing.double().clamp_min(1e-45)).max().item()


# ---------------------------------------------------------------------------
def main():
    phase("1. device")
    if not torch.cuda.is_available():
        print("CUDA is not available; chip_smoke.py needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))

    import repro_torch
    from repro_torch.kernels import (
        attention, build, fedavg_agg, ops, quant, rwkv6_scan, stc_topk,
    )

    phase("2. build")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in secs.items()})})")

    phase("3. kernels against their plain versions")
    kernels = check_kernels(dev, fedavg_agg, stc_topk, quant)
    next(r for r in kernels if r["name"] == "int8_rowmax")["at_rows"][
        f"1x{EMBED_ROW}"] = check_embed_row(dev, stc_topk, quant)

    phase("3b. flash-attention kernels against their plain versions")
    flash_rows = check_flash(dev, attention, build)

    phase("3c. WKV6, dense STC and dense int8 kernels against their plain "
          "versions")
    new_rows = check_new_kernels(dev, rwkv6_scan, stc_topk, quant,
                                 build)

    phase("4. the main path: femnist_cnn through init/run")
    repro_torch.set_device(None)          # the default: CUDA
    launches = {k: 0 for k in ops.launch_counts()}
    fused = {}                            # mode -> final params (CPU)
    for mode in ("none", "stc", "int8"):
        used, fused[mode] = run_slice(repro_torch, ops, mode)
        for k, v in used.items():
            launches[k] += v
    batched_none = fused["none"]
    for row in kernels:
        row["launches"] = launches[row["counter"]]

    phase("4b. the LoRA path: GLM-4-9B (2 layers) at full width through "
          "init/run")
    on = run_lora(repro_torch, ops, flash_on=True)
    off = run_lora(repro_torch, ops, flash_on=False)
    diff = max_param_diff(on["params"], off["params"])
    print(f"[lora] flash on vs off: max |adapter diff| {diff:.3g} "
          f"(bar 1e-4)")
    require(diff <= 1e-4, f"flash on vs off adapters differ by {diff}")
    lora_engines(repro_torch, ops, on, smi)
    for row in flash_rows:      # the D 128 instances: the LoRA path's
        if row["head_dim"] == 128:
            row["launches"] = on["launches"][row["counter"]]

    # phase 4l runs here, while the card holds nothing else: later phases
    # keep the RWKV6 params (5.97 GiB, for 5c) and more, and the federated
    # round needs ~64 GiB of the card's 79.18
    dryruns = start_dryruns()       # phase 4o's, on the CPU meanwhile
    phase("4l. LLM training: launch/train at full width (glm4-9b, "
          "qwen3-moe-30b-a3b, internlm2-20b, phi3-medium-14b; 2 layers) and "
          "the cross-pod federated round")
    train_launches, fed_launches = run_llm_training(repro_torch, ops, dev,
                                                    smi)
    for row in kernels + flash_rows:
        if row["name"] in train_launches:
            row["launches_train"] = train_launches[row["name"]]
        if row["name"] in fed_launches:
            row["launches_fed"] = fed_launches[row["name"]]

    phase("4n. a MoE transformer_lm in the batched engine: "
          "qwen3-moe-30b-a3b at published width (2 layers), LoRA, through "
          "init/run, flash on and off")
    moe_launches = run_moe_lm(repro_torch, ops, smi)
    for row in kernels + flash_rows:
        # K1 and the D 128 flash instance: the MoE cohort's launches
        if row.get("counter") == "fedavg_agg" or (
                row.get("head_dim") == 128 and "counter" in row):
            row["launches_moe"] = moe_launches[row["counter"]]

    phase("4o. the dry run: every arch id at train_4k on the (16, 16) mesh "
          "with no device memory; one reduced glm4-9b step against its "
          "roofline")
    run_dryrun_phase(dev, smi, dryruns)

    phase("4m. the rest of the model zoo at published width: "
          "nemotron-4-340b (1 layer, serve), paligemma-3b, "
          "deepseek-v2-lite-16b (2 layers), recurrentgemma-9b (3 layers), "
          "whisper-small: prefill, decode, train")
    zoo = run_zoo(repro_torch, ops, dev, smi)
    for row in flash_rows:
        # DP 64, 192 and 256: their zoo runs are their main path
        # (whisper's decoder, nemotron's prefill, paligemma's prefill and
        # train steps); no zoo arch runs DP 128
        if row["head_dim"] != 128:
            row["launches"] = zoo[row["head_dim"]][row["counter"]]
        del row["counter"]
    # K7 at D 192 has no main path on one card (nemotron-4-340b cannot
    # train at its width there: params and grads alone exceed 80 GB); its
    # phase 3b row goes into its kernel's D 128 row as "d192"
    for name in ("flash_dq", "flash_dkv"):
        row = next(r for r in flash_rows if r["name"] == f"{name}_d192")
        flash_rows.remove(row)
        next(r for r in flash_rows if r["name"] == name)["d192"] = row
    require(all(r["launches"] > 0 for r in flash_rows),
            f"a flash instance was not launched on its main path: "
            f"{[(r['name'], r['launches']) for r in flash_rows]}")
    kernels += flash_rows

    phase("4c. the RWKV6 serving path: rwkv6-1.6b at full width and depth")
    served, rwkv_params = run_rwkv6(repro_torch, ops, dev, smi)

    phase("4d. the compression API path: dense STC and int8 of 2^20 f32")
    api = run_compression_api(ops, dev)
    for row in new_rows:
        row["launches"] = (served if row["counter"] == "wkv6"
                           else api)[row["counter"]]
        del row["counter"]
    kernels += new_rows

    phase("4e. the default path: femnist_cnn through init/run, execution "
          "sequential")
    from repro_torch.core.config import Config
    from repro_torch.models.small import femnist_cnn
    repro_torch.set_device(None)
    seq = {k: 0 for k in ops.launch_counts()}
    for mode in ("none", "stc", "int8"):
        used, params = run_slice(repro_torch, ops, mode,
                                 execution="sequential")
        if mode == "none":              # the A/B under deterministic cuDNN
            sequential_ab(repro_torch, ops, smi)
        for k, v in used.items():
            seq[k] += v
        if mode == "none":
            diff = max_diff(params, batched_none)
            init = femnist_cnn().init(torch.Generator().manual_seed(
                Config().seed))         # phase 4's init
            gap = conditioning_gap(repro_torch,
                                   femnist_config("none", "batched"), init,
                                   batched_none)
            gaps = {"none": gap}        # phase 4f reuses it
            bar = max(1e-4, 2 * gap)
            print(f"[sequential none] final params vs phase 4's batched "
                  f"none: max |diff| {diff:.4g} ({'within' if diff <= 1e-4 else 'above'}"
                  f" 1e-4); phase 4 from 1e-7-perturbed inits moves them "
                  f"up to {gap:.4g}; bar max(1e-4, 2 x that) = {bar:.4g}")
            require(diff <= bar, f"sequential vs batched none: {diff} > "
                    f"{bar}")
    for row in kernels:          # K1-K3, the rows of phase 3
        if row.get("counter") in seq and row["counter"] != "fedavg_agg_tree":
            row["launches_sequential"] = seq[row["counter"]]
    check_sequential_stage(repro_torch, dev)

    phase("4f. the rest of the batched engine: femnist_cnn staged "
          "(round_fusion off), hierarchical and deferred (round_sync off)")
    tree_launches = run_batched_paths(repro_torch, ops, fused, gaps, init,
                                      smi)
    for row in kernels:
        if row.get("counter") == "fedavg_agg_tree":
            row["launches"] = tree_launches
    check_staged_stages(repro_torch, dev)

    phase("4g. faults, round deadline and checkpoint/resume: femnist_cnn "
          "through init/run")
    faulty = run_faults(repro_torch, ops, dev, smi)
    for row in kernels:          # K1-K3 and the K1 tree, the rows of phase 3
        if row.get("counter") in faulty:
            row["launches_faults"] = faulty[row["counter"]]
    check_resume(smi)

    phase("4p. the captured round: phase 4's femnist_cnn fused rounds as "
          "one CUDA graph a bucket against eager rounds")
    run_captured(repro_torch, ops, smi, gaps, init)

    phase("4h. the paper's other models: shakespeare_lstm and "
          "cifar_resnet18 through init/run")
    models = run_models(repro_torch, ops, smi)

    phase("4i. the async engine: femnist_cnn FedBuff through init and the "
          "Trainer")
    asynced = run_async(repro_torch, ops, smi, fused, gaps, init)
    for row in kernels:          # K1-K3, the rows of phase 3
        if row.get("counter") in models:
            row["launches_models"] = models[row["counter"]]
            row["launches_async"] = asynced[row["counter"]]

    phase("4j. the sharded cohort: femnist_cnn through init/run with "
          "resources.distributed='data', 1, 2 and 4 shards of the card")
    sharded = run_sharded(repro_torch, ops, smi, fused, gaps, init)
    check_sharded_routes(dev, fedavg_agg, stc_topk, quant, smi)
    for row in kernels:          # K1-K3 and the K1 tree, the rows of phase 3
        if row.get("counter") in sharded:
            row["launches_sharded"] = sharded[row["counter"]]

    phase("4k. remote training: femnist_cnn through start_client / "
          "start_server and as the service CLI's processes")
    remote = run_remote(repro_torch, ops, smi)
    for row in kernels:          # K1 and the K1 tree, the rows of phase 3
        if row.get("counter") in remote:
            row["launches_remote"] = remote[row["counter"]]
        row.pop("counter", None)

    phase("5. card against CPU")
    for execution in ("batched", "sequential"):
        card_vs_cpu(repro_torch, execution)

    phase("5b. card against CPU: tiny_lm LoRA, flash on, batched and "
          "sequential")
    for execution in ("batched", "sequential"):
        lora_card_vs_cpu(repro_torch, execution)

    phase("5c. RWKV6 agreement: K8 vs wkv6_chunked and decode vs forward at "
          "full width; reduced decode card vs CPU")
    rwkv6_agreement(rwkv_params, dev)
    del rwkv_params

    phase("5d. card against CPU: reduced glm4-9b and qwen3-moe-30b-a3b "
          "train steps, reduced glm4-9b federated rounds under stc, a "
          "reduced qwen3-moe-30b-a3b batched round")
    llm_card_vs_cpu(smi)
    moe_round_card_vs_cpu(smi)

    phase("5e. card against CPU: the reduced zoo (nemotron-4-340b, "
          "paligemma-3b, deepseek-v2-lite-16b, recurrentgemma-9b at 2 and 3 "
          "layers, whisper-small): forward, decode, a train step")
    zoo_card_vs_cpu(smi)

    phase("6. result")
    print(f"chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
def max_param_diff(a, b):
    from repro_torch.utils.tree import tree_leaves
    return max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def flash_bound(bh, s, d, causal, kernel):
    """Least time of one flash kernel: operations for the (query, key)
    pairs this causal mask keeps, bytes for each input read once and each
    output written once.  -> ((ms, by) on the tensor cores in 3xTF32, the
    units the kernels run on: three TF32 products per fp32-accurate one;
    (ms, by) on the fp32 CUDA cores)."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mat, row = 4 * bh * s * d, 4 * bh * s
    ops_per_pair, nbytes = {
        "flash_fwd": (4 * d, 4 * mat + row),          # q k v -> o, lse
        "flash_dq": (6 * d, 5 * mat + 2 * row),        # q k v dO lse delta -> dq
        "flash_dkv": (8 * d, 6 * mat + 2 * row),       # ... -> dk, dv
    }[kernel]
    return (bound(nbytes, ops_per_pair * pairs, TF32_OPS_PER_S / 3),
            bound(nbytes, ops_per_pair * pairs))


def hmma_counts(build, lib, kernels):
    """{"<kernel><DP>": count} of TF32 tensor-core instructions (``HMMA``)
    in the SASS of each template instance of ``kernels`` (a regex
    alternation of kernel names) in library ``lib``; None without
    ``cuobjdump``."""
    import re
    import shutil

    cuobjdump = next((c for c in (
        os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
        shutil.which("cuobjdump") or "") if c and os.path.isfile(c)), None)
    if cuobjdump is None:
        return None
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", str(build.library_path(lib))],
        capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(rf"Function : \S*?({kernels})ILi(\d+)E", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
            counts[cur] = 0
        elif cur and "HMMA" in line:
            counts[cur] += 1
    print(f"HMMA instructions in the SASS of {lib} (HMMA.1688.F32.TF32): "
          + json.dumps(counts, sort_keys=True))
    return counts


def print_resources(name, r, what):
    print(f"{name} at {what}: {r['registers']} registers, "
          f"{r['spill_bytes']} bytes of local memory (spills), "
          f"{r['smem_bytes']} bytes of dynamic shared memory, "
          f"{r['ctas_per_sm']} CTAs per SM")


#: head dims of the flash kernels' template instances that a main path
#: runs: 64 (D 33-64, whisper-small's decoder), 128 (D 65-128, the LoRA
#: and GLM-4 paths), 192 (Nemotron-4) and 256 (PaliGemma); phase 3b
#: reports and times each
FLASH_DIMS = (64, 128, 192, 256)

#: each instance's timed shape in phase 3b, (BH, S, D, causal, heads): its
#: main path's (whisper-small's 4 sequences x 12 heads of 448 tokens) or
#: the LoRA path's (4 clients x 4 sequences x 32 heads = 512, S = 512)
FLASH_TIMED = {64: (48, 448, 64, True, 12), 128: (512, 512, 128, True, 32),
               192: (512, 512, 192, True, 32),
               256: (512, 512, 256, True, 32)}

#: the D 192 / 256 instances' launches on phase 4m's main path happen at
#: other shapes than ``FLASH_TIMED``'s: nemotron-4-340b's prefill (96 heads
#: of 1024 tokens) and paligemma-3b's (2 x 8 heads of 256 frames + 256
#: tokens); phase 3b times them there too (the row's ``at_main_path``)
FLASH_ZOO_TIMED = {192: (96, 1024, 192, True, 96),
                   256: (16, 512, 256, True, 8)}

#: the edges of the pair kernels' head-dim split (phase 3b and the card
#: test): D 129 / 136 (DP 192, a ragged second half), 130 (4-byte copies),
#: 193 / 255 (DP 256, a ragged half); S 1, 65 (a second, one-row tile) and
#: 520; BH 1 and 133 (more CTAs than SMs); causal and not
FLASH_PAIR_EDGES = [(bh, s, d, c) for d in (129, 130, 136, 193, 255)
                    for bh, s in ((3, 1), (1, 65), (133, 65), (2, 520))
                    for c in (True, False)]


def flash_instance(d):
    """Head dim of the template instance that ``flash_attn.cu``'s
    ``dp_for`` runs at head dim ``d``."""
    return next(x for x in (16, 32, 64, 128, 192, 256) if d <= x)


def flash_symbol(name, r):
    """The CUDA kernel behind counter ``name`` at an instance whose
    resources are ``r``: above D 128 all three run the 8-warp pair
    kernels."""
    return f"{name}_pair_kernel" if r["threads"] == 256 else f"{name}_kernel"


def flash_build_report(attention, build):
    """Print the three flash kernels' resources at each of ``FLASH_DIMS``
    and the TF32 tensor-core instructions (``HMMA``) in each one's SASS;
    -> {d: {kernel: resources and HMMA count}}."""
    info = {d: attention.kernel_info(d) for d in FLASH_DIMS}
    for d in FLASH_DIMS:
        for name, r in info[d].items():
            print_resources(name, r, f"D {d}")
            print(f"    {flash_symbol(name, r)}<{d}>: {r['threads']} threads "
                  f"a CTA, grid (BH, ceil(S / 64), {r['grid_z']})")
    counts = hmma_counts(build, "flash_attn",
                         "flash_(?:fwd|dq|dkv)(?:_pair)?_kernel")
    if counts is None:
        print("HMMA count: not available (no cuobjdump in the toolkit)")
        return info
    for d in FLASH_DIMS:
        for name, r in info[d].items():
            n = counts.get(f"{flash_symbol(name, r)}<{d}>", 0)
            require(n > 0, f"{name} at D {d}: no tensor-core instruction in "
                    f"its SASS")
            info[d][name]["hmma"] = n
    return info


def flash_row_name(name, d):
    """The kernel line's name of one template instance: the DP 128 instance
    keeps the kernel's name, the others carry their head dim."""
    return name if d == 128 else f"{name}_d{d}"


def check_flash(dev, attention, build):
    """K6/K7a/K7b: their resources, then held against their plain
    versions (at every main path's shape among the cases), then timed at
    ``FLASH_TIMED``'s shape for each D of ``FLASH_DIMS``.  -> one row a
    kernel and template instance."""
    resources = flash_build_report(attention, build)
    gen = torch.Generator(device=dev).manual_seed(4321)

    def qkv(bh, s, d):
        return [torch.randn((bh, s, d), generator=gen, device=dev)
                for _ in range(4)]

    mains = [FLASH_TIMED[d] for d in FLASH_DIMS]
    # the zoo's main-path shapes (phase 4m): nemotron-4-340b's prefill, 96
    # heads of 1024 tokens at D 192; paligemma-3b's 2 x 8 heads of 256
    # frames + 256 tokens at D 256; whisper-small's decoder (the D 64 main)
    cases = [m[:4] for m in mains] + [(96, 1024, 192, True),
                                      (16, 512, 256, True)] + [
        (3, 200, 72, True), (2, 130, 128, False),
                     (3, 200, 160, True), (2, 130, 192, False),
                     (3, 200, 200, True), (2, 130, 256, False)] + [
        (3, s, d, c) for s in (1, 63, 200) for d in (20, 64)
        for c in (True, False)] + FLASH_PAIR_EDGES
    errs = {}
    for bh, s, d, causal in cases:
        q, k, v, do = qkv(bh, s, d)
        o, lse = attention.flash_fwd(q, k, v, causal)
        po, plse = attention.flash_fwd_plain(q, k, v, causal)
        delta = (do * o).sum(dim=-1)
        dq = attention.flash_dq(q, k, v, do, lse, delta, causal)
        dk, dv = attention.flash_dkv(q, k, v, do, lse, delta, causal)
        pdq = attention.flash_dq_plain(q, k, v, do, lse, delta, causal)
        pdk, pdv = attention.flash_dkv_plain(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        e = {"flash_fwd": max((o - po).abs().max().item(),
                              (lse - plse).abs().max().item()),
             "flash_dq": (dq - pdq).abs().max().item(),
             "flash_dkv": max((dk - pdk).abs().max().item(),
                              (dv - pdv).abs().max().item())}
        print(f"flash (BH {bh}, S {s}, D {d}, causal {causal}): max abs err "
              + ", ".join(f"{n} {x:.3g}" for n, x in e.items()))
        require(e["flash_fwd"] <= 1e-5, f"flash_fwd err {e['flash_fwd']}")
        require(e["flash_dq"] <= 1e-4, f"flash_dq err {e['flash_dq']}")
        require(e["flash_dkv"] <= 1e-4, f"flash_dkv err {e['flash_dkv']}")
        if flash_instance(d) not in FLASH_DIMS:
            continue       # the DP 16 / 32 instances: checked, no row
        for n, x in e.items():
            key = flash_row_name(n, flash_instance(d))
            errs[key] = max(errs.get(key, 0.0), x)

    def timed_at(bh, s, d, causal, heads):
        """The three kernels, their plain versions and SDPA at one shape
        -> {kernel: measurements}."""
        q, k, v, do = qkv(bh, s, d)
        o, lse = attention.flash_fwd(q, k, v, causal)
        delta = (do * o).sum(dim=-1)
        sdpa_f, sdpa_b = sdpa_ms(q, k, v, do, heads)
        timed = {
            "flash_fwd": (lambda: attention.flash_fwd(q, k, v, causal),
                          lambda: attention.flash_fwd_plain(q, k, v, causal),
                          sdpa_f),
            "flash_dq": (
                lambda: attention.flash_dq(q, k, v, do, lse, delta, causal),
                lambda: attention.flash_dq_plain(q, k, v, do, lse, delta,
                                                 causal),
                sdpa_b),
            "flash_dkv": (
                lambda: attention.flash_dkv(q, k, v, do, lse, delta, causal),
                lambda: attention.flash_dkv_plain(q, k, v, do, lse, delta,
                                                  causal),
                sdpa_b),
        }
        out = {}
        for name, (kern, plain, lib_ms) in timed.items():
            (b, by), (b_cc, by_cc) = flash_bound(bh, s, d, causal, name)
            out[name] = dict(shape=[bh, s, d], ms=cuda_ms(kern),
                             plain_ms=cuda_ms(plain), bound_ms=b,
                             bound_by=by, library_ms=lib_ms)
            r = out[name]
            print(f"{flash_row_name(name, d):16s} {r['shape']} causal: "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms "
                  f"({'forward' if name == 'flash_fwd' else 'backward, dq+dk+dv'}"
                  f"), bound {b:.4f} ms ({by}, 3xTF32 tensor cores; "
                  f"{b_cc:.4f} ms ({by_cc}) on the fp32 CUDA cores)")
        del q, k, v, do, o, lse, delta
        return out

    replaces = {"flash_fwd": "src/repro/kernels/attention.py:60",
                "flash_dq": "src/repro/kernels/attention.py:151",
                "flash_dkv": "src/repro/kernels/attention.py:176"}
    rows = []
    for bh, s, d, causal, heads in mains:
        got = timed_at(bh, s, d, causal, heads)
        zoo = (timed_at(*FLASH_ZOO_TIMED[d]) if d in FLASH_ZOO_TIMED
               else None)
        for name, m in got.items():
            key = flash_row_name(name, d)
            r = resources[d][name]
            grid = [bh, -(-s // 64), r["grid_z"]]
            print(f"{key:16s} grid {grid} of {r['threads']} threads, "
                  f"{r['registers']} registers, {r['spill_bytes']} spill "
                  f"bytes, {r['smem_bytes']} bytes of shared memory, "
                  f"{r['ctas_per_sm']} CTAs per SM")
            rows.append(dict(
                name=key, counter=name, head_dim=d, route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attn.cu",
                replaces=replaces[name], max_abs_err=errs[key], **m,
                grid=grid, **r))
            if zoo is not None:
                rows[-1]["at_main_path"] = zoo[name]
    return rows


# ---------------------------------------------------------------------------
def wkv6_bound(B, T, H, hd):
    """Least time of one WKV6 call: bytes for r, k, v, log w, y (B, T, H,
    hd), u and both states; operations per (sequence, head, 64-step chunk)
    as the exact form needs them (the TPU kernel's work, whatever
    implements it), an exponential counted as one.  -> ((ms, by) with the
    three products on the tensor cores in 3xTF32 — the units the kernel
    runs them on — and the rest on the fp32 CUDA cores; (ms, by) all on
    the fp32 CUDA cores)."""
    L = 64
    pairs = L * (L - 1) // 2
    products = (2 * L * hd * hd           # (r exp(cwx)) @ S
                + L * (L + 1) * hd        # scores @ v, diagonal included
                + 2 * L * hd * hd)        # k_dec^T @ v
    per_chunk = (2 * L * hd               # cumsum, cw - log w
                 + 5 * pairs * hd         # gates: sub, exp, 2 mul, add
                 + 3 * L * hd             # bonus r u k
                 + 5 * L * hd             # r exp(cwx), k exp(cw_L - cw)
                 + L * hd                 # inter + intra
                 + 3 * hd * hd            # state decay
                 + products)
    n = B * H * (T // L)
    nbytes = 4 * (5 * B * T * H * hd + 2 * B * H * hd * hd + H * hd)
    seconds = n * (products / (TF32_OPS_PER_S / 3)
                   + (per_chunk - products) / FP32_OPS_PER_S)
    return bound(nbytes, seconds, 1.0), bound(nbytes, n * per_chunk)


WKV_SEED = 5678
WKV_MAIN = (16, 512, 32, 64)    # B, T, H, hd of one rwkv6-1.6b prefill layer


def wkv_inputs(gen, B, T, H, hd):
    """K8's inputs in phase 3c (and ``scripts/bench_kernels.py``): unit
    normal r, k, v and state, 0.3 u, and the model's decays, log w =
    -exp(clamp(N(0, 1) - 0.6, -8, 6)), drawn on ``gen``'s device."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    r, k, v = randn(B, T, H, hd), randn(B, T, H, hd), randn(B, T, H, hd)
    logw = -torch.exp(torch.clamp(randn(B, T, H, hd) - 0.6, -8.0, 6.0))
    return r, k, v, logw, 0.3 * randn(H, hd), randn(B, H, hd, hd)


def scaled_err(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    e = (got.double() - want.double()).abs().max().item()
    return e, e / max(1.0, want.abs().max().item())


def device_ms(fn, n=REPS):
    """Device time of one call of ``fn``: the CUDA kernels' time summed by
    ``torch.profiler`` over ``n`` calls (after a warm-up), divided by n —
    the launch path on the host left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # now and then a session records no kernel at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            break
    require(us > 0, "device_ms: the profiler saw no device time")
    return us / 1e3 / n


def graph_ms(fn, calls=20, reps=REPS):
    """Milliseconds a call of ``fn`` takes on the device with no host in
    the way: ``calls`` calls captured in one CUDA graph, the median over
    ``reps`` replays (CUDA events) divided by ``calls``.  Launch gaps on the
    device count; the host's dispatch does not."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def same_bits(a, b):
    """Bit for bit, except that any NaN equals any NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def check_dense_quant(quant, x, what):
    """K5a and K5b on ``x`` against their plain versions: scales and the
    dequantized values bit for bit (NaN as NaN), q bit for bit wherever the
    plain round trip gives a number and the padding q = 0; K5b also from a
    q one byte past a 16-byte boundary.  -> whether q was also bit for bit
    where the round trip gives NaN (tiles with NaN or inf)."""
    n = x.numel()
    q, s = quant.quantize(x)
    pq, ps = quant.quantize_plain(x)
    require(same_bits(s, ps), f"int8 quantize {what}: scales differ")
    plain = quant.dequantize_plain(pq, ps, x.shape)
    num = torch.ones(q.numel(), dtype=torch.bool, device=x.device)
    num[:n] = ~torch.isnan(plain.reshape(-1))
    require(torch.equal(q.view(-1)[num], pq.view(-1)[num]),
            f"int8 quantize {what}: q not bitwise")
    require(not q.view(-1)[n:].any(), f"int8 quantize {what}: padding q")
    want = quant.dequantize_plain(q, s, x.shape)
    require(same_bits(quant.dequantize(q, s, x.shape), want),
            f"int8 dequantize {what}: not bitwise")
    buf = torch.zeros(q.numel() + 16, dtype=torch.int8, device=x.device)
    qv = buf[1:1 + q.numel()].view(q.shape)
    qv.copy_(q)
    require(qv.data_ptr() % 16, "k5 case: q view alignment")
    require(same_bits(quant.dequantize(qv, s, x.shape), want),
            f"int8 dequantize {what}, q misaligned: not bitwise")
    return bool(torch.equal(q, pq))


def check_k5_edges(dev, quant):
    """Phase 3c's K5 cases: lengths around one vector and one tile, a
    ragged run of tiles, and the full sizes 10,007, 2^20 and 1,000,003 with
    ``quant.edge_tiles`` (zeros, subnormals, half-integer quotients, NaN,
    inf) as their first six tiles where they fit; each in f32, bf16 and
    f16, at an allocation's start and one element past it."""
    edges = quant.edge_tiles().to(dev)
    cases, nan_q = 0, True
    for n in (1, 15, 16, 17, 8191, 8192, 8193, 3 * 8192 + 5, 10007,
              2 ** 20, 1000003):
        base = torch.randn((n,), generator=torch.Generator(device=dev)
                           .manual_seed(n), device=dev)
        if n >= edges.numel():
            base[:edges.numel()] = edges
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for offset in (0, 1):
                buf = torch.zeros(n + offset, dtype=dtype, device=dev)
                buf[offset:].copy_(base)
                x = buf[offset:]
                require(bool(x.data_ptr() % 16) == bool(offset),
                        "k5 case: view alignment")
                nan_q &= check_dense_quant(
                    quant, x, f"({n}, {dtype}, offset {offset})")
                cases += 1
    torch.cuda.synchronize()
    print(f"dense int8: {cases} cases (lengths 1 .. 1,000,003 x f32/bf16/f16 "
          f"x aligned / one element past; zero, subnormal, tie, NaN, inf "
          f"tiles in the full sizes): scales, dequantized values and q "
          f"bitwise (NaN as NaN; q also on the NaN/inf tiles: {nan_q}); K5b "
          f"also from a misaligned q")


def check_new_kernels(dev, rwkv6_scan, stc_topk, quant, build):
    """K8 (WKV6), K4 (dense STC), K5a/K5b (dense quantize / dequantize)
    against their plain versions, then timed at the main path's shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.layers import init_params

    gen = torch.Generator(device=dev).manual_seed(WKV_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    main = WKV_MAIN
    k8_err = 0.0
    for shape in (main, (2, 192, 3, 16), (3, 128, 1, 64)):
        args = wkv_inputs(gen, *shape)
        y, st = rwkv6_scan.wkv6(*args)
        py, ps = rwkv6_scan.wkv6_plain(*args)
        torch.cuda.synchronize()
        (ey, ry), (es, rs) = scaled_err(y, py), scaled_err(st, ps)
        print(f"wkv6 {shape}: max abs err y {ey:.3g} (max |y| "
              f"{py.abs().max().item():.4g}), sT {es:.3g}; scaled "
              f"{max(ry, rs):.3g} (bar 1e-4 of max(1, max |out|))")
        require(max(ry, rs) <= 1e-4, f"wkv6 {shape}: scaled err "
                f"{max(ry, rs)}")
        k8_err = max(k8_err, ey, es)
    # extreme decay: log w at the clip, every third step near 0.  f32 cw
    # loses the small steps' digits (both add it serially, so they round
    # it alike); the bar is ROADMAP's WKV6 caveat, 3e-2
    for shape in ((4, 256, 4, 64), (2, 192, 3, 16)):
        r, k, v, logw, u, s0 = wkv_inputs(gen, *shape)
        logw = torch.full_like(logw, -float(np.exp(6.0)))
        logw[:, ::3] = -float(np.exp(-8.0))
        y, st = rwkv6_scan.wkv6(r, k, v, logw, u, s0)
        py, ps = rwkv6_scan.wkv6_plain(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        (ey, ry), (es, rs) = scaled_err(y, py), scaled_err(st, ps)
        fin = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        print(f"wkv6 {shape}, log w -e^6 / -e^-8: finite {fin}; max abs err "
              f"y {ey:.3g}, sT {es:.3g}; scaled {max(ry, rs):.3g} (bar 3e-2)")
        require(fin and max(ry, rs) <= 3e-2,
                f"wkv6 extreme decay {shape}: finite {fin}, scaled err "
                f"{max(ry, rs)}")
    # a ragged length through time_mix's padding (200 -> 256 steps) at
    # full width, f32: K8 against the model's own wkv6_chunked
    cfg = get_arch("rwkv6-1.6b")
    tp = init_params(rwkv_mod.rwkv_defs(cfg)["time"],
                     torch.Generator().manual_seed(3), dev)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = randn(4, 200, cfg.d_model)
    x_prev, s0 = randn(4, cfg.d_model), randn(4, H, hd, hd)
    with torch.no_grad():
        ko, _, ks = rwkv_mod.time_mix(cfg, tp, x, x_prev, s0, use_kernel=True)
        co, _, cs = rwkv_mod.time_mix(cfg, tp, x, x_prev, s0,
                                      use_kernel=False)
    torch.cuda.synchronize()
    (eo, ro), (es, rs) = scaled_err(ko, co), scaled_err(ks, cs)
    print(f"time_mix (4, 200, 2048), K8 vs wkv6_chunked: max abs err out "
          f"{eo:.3g}, sT {es:.3g}; scaled {max(ro, rs):.3g} (bar 1e-4)")
    require(max(ro, rs) <= 1e-4, f"time_mix K8 vs chunked {max(ro, rs)}")
    del tp, x, ko, co

    errs = {"stc_dense": 0.0, "int8_quantize": 0.0, "int8_dequantize": 0.0}
    for n in (2 ** 20, 1000003):
        x = randn(n) * 0.37
        o, p = stc_topk.stc_compress(x, 0.01), stc_topk.stc_dense_plain(x)
        q, sc = quant.quantize(x)
        pq, psc = quant.quantize_plain(x)
        d = quant.dequantize(q, sc, x.shape)
        pd = quant.dequantize_plain(q, sc, x.shape)
        torch.cuda.synchronize()
        require(torch.equal(o != 0, p != 0), f"stc_dense ({n}): masks differ")
        require(torch.equal(torch.sign(o), torch.sign(p)),
                f"stc_dense ({n}): signs differ")
        require(torch.count_nonzero(o) == torch.count_nonzero(p),
                f"stc_dense ({n}): nnz differ")
        u = ulps(o, p)
        require(u <= 1.0, f"stc_dense ({n}): values differ by {u} ulp > 1")
        require(torch.equal(q, pq), f"int8 quantize ({n}): q not bitwise")
        require(torch.equal(sc.view(torch.int32), psc.view(torch.int32)),
                f"int8 quantize ({n}): scales not bitwise")
        require(torch.equal(d.view(torch.int32), pd.view(torch.int32)),
                f"int8 dequantize ({n}): not bitwise")
        errs["stc_dense"] = max(errs["stc_dense"], (o - p).abs().max().item())
        errs["int8_quantize"] = max(
            errs["int8_quantize"], (sc - psc).abs().max().item(),
            (q.int() - pq.int()).abs().max().item())
        errs["int8_dequantize"] = max(errs["int8_dequantize"],
                                      (d - pd).abs().max().item())
        print(f"dense ({n}): stc masks+signs+nnz bitwise, values <= {u:.3g} "
              f"ulp (nnz {int(torch.count_nonzero(o))}); quantize q+scales "
              f"and dequantize bitwise")
    check_k5_edges(dev, quant)
    x = torch.cat([stc_topk.adversarial_rows(stc_topk.SEG).reshape(-1),
                   torch.tensor([5.0])]).to(dev)
    o, p = stc_topk.stc_compress(x, 0.01), stc_topk.stc_dense_plain(x)
    torch.cuda.synchronize()
    u = check_stc(o, p, "stc_dense adversarial")
    require(torch.count_nonzero(o) == torch.count_nonzero(p),
            "stc_dense adversarial: nnz differ")
    errs["stc_dense"] = max(errs["stc_dense"], (o - p).abs().max().item())
    print(f"dense adversarial ({x.numel()}: one case a segment, then one "
          f"element): stc masks+signs+nnz bitwise, values <= {u:.3g} ulp")

    resources = rwkv6_scan.kernel_info(64)
    print_resources("wkv6", resources, "hd 64")
    counts = hmma_counts(build, "wkv6", "wkv6_kernel")
    if counts is None:
        print("HMMA count: not available (no cuobjdump in the toolkit)")
    else:
        resources["hmma"] = counts.get("wkv6_kernel<64>", 0)
        require(resources["hmma"] > 0,
                "wkv6: no tensor-core instruction in its SASS")
    rows = []
    args = wkv_inputs(gen, *main)
    (b, by), (b_cc, by_cc) = wkv6_bound(*main)
    rows.append(dict(
        name="wkv6", counter="wkv6", route="cuda",
        source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:30",
        shape=list(main), max_abs_err=k8_err,
        ms=cuda_ms(lambda: rwkv6_scan.wkv6(*args)),
        plain_ms=cuda_ms(lambda: rwkv6_scan.wkv6_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=None,
        **resources))
    print(f"wkv6 bound {b:.4f} ms ({by}; products on the 3xTF32 tensor "
          f"cores), {b_cc:.4f} ms ({by_cc}) all on the fp32 CUDA cores")
    del args
    n = 2 ** 20
    x = randn(n) * 0.37
    b, by = stc_bound(x.view(1, n), stc_topk, counts=False)
    rows.append(dict(
        name="stc_dense", counter="stc_dense", route="cuda",
        source="src/repro_torch/kernels/csrc/stc_topk.cu",
        replaces="src/repro/kernels/stc_topk.py:65",
        shape=[n], max_abs_err=errs["stc_dense"],
        ms=cuda_ms(lambda: stc_topk.stc_compress(x, 0.01)),
        device_ms=device_ms(lambda: stc_topk.stc_compress(x, 0.01)),
        plain_ms=cuda_ms(lambda: stc_topk.stc_dense_plain(x, 0.01)),
        bound_ms=b, bound_by=by, library_ms=None))
    q, sc = quant.quantize(x)
    tiles = sc.shape[0]
    k5_res = {"int8_quantize": quant.kernel_info("quantize"),
              "int8_dequantize": quant.kernel_info("dequantize")}
    for name, r in k5_res.items():
        print(f"{name}: {r['registers']} registers, {r['spill_bytes']} bytes "
              f"of local memory (spills), {r['smem_bytes']} bytes of static "
              f"shared memory, {r['ctas_per_sm']} CTAs per SM")
    print(f"{tiles} tiles at 2^20 = {tiles} K5a CTAs and "
          f"{tiles * quant.TILE // 16 // 256} K5b CTAs on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")
    b, by = bound(4 * n + q.numel() + 4 * tiles, 6 * n)
    rows.append(dict(
        name="int8_quantize", counter="int8_quantize", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:36",
        shape=[n], max_abs_err=errs["int8_quantize"],
        ms=cuda_ms(lambda: quant.quantize(x)),
        device_ms=device_ms(lambda: quant.quantize(x)),
        graph_ms=graph_ms(lambda: quant.quantize(x)),
        plain_ms=cuda_ms(lambda: quant.quantize_plain(x)),
        bound_ms=b, bound_by=by, library_ms=None,
        **k5_res["int8_quantize"]))
    b, by = bound(n + 4 * tiles + 4 * n, 2 * n)
    q2 = q.view(tiles, quant.TILE)
    rows.append(dict(
        name="int8_dequantize", counter="int8_dequantize", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:44",
        shape=[n], max_abs_err=errs["int8_dequantize"],
        ms=cuda_ms(lambda: quant.dequantize(q, sc, x.shape)),
        device_ms=device_ms(lambda: quant.dequantize(q, sc, x.shape)),
        graph_ms=graph_ms(lambda: quant.dequantize(q, sc, x.shape)),
        plain_ms=cuda_ms(lambda: quant.dequantize_plain(q, sc, x.shape)),
        bound_ms=b, bound_by=by,
        # q * s broadcast over the tiles (int8 * f32 promotes to f32)
        library_ms=cuda_ms(lambda: torch.mul(q2, sc)),
        library_device_ms=device_ms(lambda: torch.mul(q2, sc)),
        library_graph_ms=graph_ms(lambda: torch.mul(q2, sc)),
        **k5_res["int8_dequantize"]))
    for r in rows:
        print(f"{r['name']:16s} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if "device_ms" in r:
            lib = r.get("library_device_ms")
            print(f"{'':16s} device time (torch.profiler, {REPS} calls): "
                  f"kernel {r['device_ms']:.4f} ms, library "
                  f"{'-' if lib is None else format(lib, '.4f')} ms")
        if "graph_ms" in r:
            lib = r.get("library_graph_ms")
            print(f"{'':16s} CUDA-graph replay (20 calls a graph): kernel "
                  f"{r['graph_ms']:.4f} ms, library "
                  f"{'-' if lib is None else format(lib, '.4f')} ms")
    return rows


RWKV_BATCH, RWKV_PROMPT, RWKV_GEN = 16, 512, 32
RWKV_SERVE_PROMPT = 32          # the serving CLI's default prompt length


#: replayed decode steps profiled after a serving A/B's timed block
PROFILED_STEPS = 2


@contextlib.contextmanager
def eager_serving():
    """``launch.serve`` makes its serve step eagerly (``capture=False``):
    the eager side of the serving CLI's A/B."""
    from repro_torch.launch import serve
    from repro_torch.models.model import make_serve_step

    serve.make_serve_step = functools.partial(make_serve_step,
                                              capture=False)
    try:
        yield
    finally:
        serve.make_serve_step = make_serve_step


def serve_ab(model, params, B, prompt, gen, tag, smi, tok0=None, start=0):
    """Greedy serving of ``model`` through the captured serve step (the
    default on the card) and, first, its eager twin (``capture=False``),
    each from a zero cache: ``prompt`` (B, P) stepped in at positions
    ``start``.. (P may be 0), then ``gen`` greedy tokens (the first from
    ``tok0`` when P is 0).  Calls 1 and 2 (the captured step's warm-up and
    capture) are timed alone; the greedy steps after them as one block,
    synchronized only at its ends.  The captured step then serves
    ``PROFILED_STEPS`` more under ``torch.profiler`` (the device's busy
    share of a replayed step).  Requires: the same greedy tokens, every
    step's logits within 1e-4 of the eager logits' scale (phase 5c's
    decode bar; whether bit for bit is printed), 1 capture, 0 recaptures,
    one eager call and a replay for every later call.  -> figures."""
    from repro_torch.models.model import make_serve_step

    P = 0 if prompt is None else prompt.shape[1]
    calls = P + gen
    require(calls > 2, f"[{tag}] serving A/B needs a timed block")
    length = start + calls + PROFILED_STEPS
    device = (tok0 if prompt is None else prompt).device
    out = {}
    for capture in (False, True):
        step = make_serve_step(model, capture=capture)
        gc.collect()
        torch.cuda.empty_cache()
        cache = model.init_cache(B, length, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, toks, first = [], [], []
        tok = tok0
        t_block = None
        for i in range(calls):
            if i == 2:
                torch.cuda.synchronize()
                t_block = time.perf_counter()
            elif i < 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            inp = prompt[:, i:i + 1] if i < P else tok
            lg, cache = step(params, cache, inp, start + i)
            if i >= P - 1:
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                if i >= P:
                    toks.append(tok)
            logits.append(lg)
            if i < 2:
                torch.cuda.synchronize()
                first.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        block = (time.perf_counter() - t_block) / (calls - 2)
        rec = {"first_ms": [round(w * 1e3, 3) for w in first],
               "ms": block * 1e3, "peak": torch.cuda.max_memory_allocated()
               / 2**30, "tokens": torch.cat(toks, dim=1),
               "counts": (step.eager_steps, step.captures, step.recaptures,
                          step.replays)}
        if capture:
            want = out[False]["logits"]
            rec["bitwise"] = all(torch.equal(a, b)
                                 for a, b in zip(logits, want))
            rec["diff"] = max((a - b).abs().max().item()
                              for a, b in zip(logits, want))
            rec["scale"] = max(1.0, max(b.abs().max().item() for b in want))
            rec["finite"] = all(bool(torch.isfinite(a).all())
                                for a in logits)
            del out[False]["logits"]

            def more(first=start + calls):
                t = tok
                for j in range(PROFILED_STEPS):
                    lg, _ = step(params, cache, t, first + j)
                    t = torch.argmax(lg[:, -1], dim=-1)[:, None]
            wall, busy = profile_window(
                more, f"{tag}] {PROFILED_STEPS} replayed decode steps",
                detail=False)
            rec["busy"] = busy / wall if wall > 0 else 0.0
            rec["counts"] = (step.eager_steps, step.captures,
                             step.recaptures, step.replays)
        else:
            rec["logits"] = logits
        out[capture] = rec
        del step, cache, logits
    cap, eag = out[True], out[False]
    n = calls + PROFILED_STEPS
    same = torch.equal(cap["tokens"], eag["tokens"])
    print(f"[{tag}] decode B {B} from position {start} ({P} prompt steps, "
          f"{gen} greedy): captured {cap['ms']:.3f} ms a step "
          f"({B / cap['ms'] * 1e3:.1f} tokens/s), eager {eag['ms']:.3f} ms "
          f"({B / eag['ms'] * 1e3:.1f} tokens/s), captured / eager "
          f"{cap['ms'] / eag['ms']:.3f} (steps 3-{calls}); calls 1-2 ms "
          f"captured {cap['first_ms']} (warm-up, capture), eager "
          f"{eag['first_ms']}; captured step: eager calls, captures, "
          f"recaptures, replays {cap['counts']}; greedy tokens equal "
          f"{same}; logits max |diff| {cap['diff']:.4g} (bitwise "
          f"{cap['bitwise']}; bar 1e-4 x {cap['scale']:.4g}); peak GiB "
          f"captured {cap['peak']:.2f}, eager {eag['peak']:.2f}; busy share "
          f"of a replayed step {100 * cap['busy']:.1f}% ({smi})")
    require(cap["finite"], f"[{tag}] captured decode logits not finite")
    require(same, f"[{tag}] captured greedy tokens differ from the eager "
            f"step's")
    require(cap["diff"] <= 1e-4 * cap["scale"],
            f"[{tag}] captured vs eager logits {cap['diff']} > 1e-4 x "
            f"{cap['scale']}")
    require(cap["counts"] == (1, 1, 0, n - 1),
            f"[{tag}] captured step counts {cap['counts']}, expected "
            f"(1, 1, 0, {n - 1})")
    require(eag["counts"] == (calls, 0, 0, 0),
            f"[{tag}] eager step counts {eag['counts']}")
    return out


def run_rwkv6(repro_torch, ops, dev, smi):
    """Phase 4c: ``rwkv6-1.6b`` as published — 24 layers, d_model 2048,
    bf16 activations over f32 parameters — prefilled through
    ``make_prefill_step`` and decoded through ``make_serve_step`` (captured
    beside its eager twin, :func:`serve_ab`) and the serving CLI (captured
    and eager).  Returns the launch counts of the run and the parameters
    (for phase 5c)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, make_prefill_step
    from repro_torch.utils.tree import tree_leaves

    repro_torch.set_device(None)
    release(repro_torch)
    cfg = get_arch("rwkv6-1.6b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[rwkv6] {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params:,} parameters ({cfg.param_dtype} params, {cfg.dtype} "
          f"activations), init {time.perf_counter() - t0:.2f} s")
    require(1.5e9 < n_params < 1.7e9, f"[rwkv6] {n_params} parameters")
    tokens = torch.randint(0, cfg.vocab, (RWKV_BATCH, RWKV_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    prefill = make_prefill_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after_prefill = ops.launch_counts()
    print(f"[rwkv6] prefill {RWKV_BATCH} x {RWKV_PROMPT} tokens: wall ms "
          f"{[round(w * 1e3, 3) for w in walls]} (the first carries first "
          f"use), {RWKV_BATCH * RWKV_PROMPT / min(walls[1:]):.1f} tokens/s; "
          f"peak device memory {peak:.2f} GiB; launches {after_prefill}")
    require(after_prefill["wkv6"] == 3 * cfg.n_layers,
            f"[rwkv6] {after_prefill['wkv6']} K8 launches in 3 prefills, "
            f"expected {3 * cfg.n_layers}")
    require(tuple(logits.shape) == (RWKV_BATCH, RWKV_PROMPT, cfg.vocab)
            and bool(torch.isfinite(logits).all()), "[rwkv6] prefill logits")
    del logits

    # the CLI's serving at batch 16 through make_serve_step: prefill by
    # stepping the decoder over the prompt, then greedy decode; the
    # captured step (one CUDA graph for every position) beside its eager
    # twin
    ab = serve_ab(model, params, RWKV_BATCH, tokens[:, :RWKV_SERVE_PROMPT],
                  RWKV_GEN, "rwkv6", smi)
    gen = ab[True]["tokens"]
    require(bool(((gen >= 0) & (gen < cfg.vocab)).all()), "[rwkv6] tokens")
    print(f"[rwkv6] greedy decode {RWKV_GEN} tokens x batch {RWKV_BATCH}, "
          f"captured: sample {gen[0, :8].tolist()}")

    # the serving CLI itself (its own init from --seed), captured and eager
    cli = {}
    for capture in (True, False):
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if not capture:
                stack.enter_context(eager_serving())
            cli[capture] = serve.main([
                "--arch", "rwkv6-1.6b", "--full", "--batch",
                str(RWKV_BATCH), "--prompt-len", str(RWKV_SERVE_PROMPT),
                "--gen", str(RWKV_GEN)])
        torch.cuda.synchronize()
        print(f"[rwkv6] serve.main --full, "
              f"{'captured' if capture else 'eager'}: "
              f"{time.perf_counter() - t0:.2f} s with its init")
        require(cli[capture].shape == (RWKV_BATCH, RWKV_GEN),
                "[rwkv6] CLI tokens")
    require(np.array_equal(cli[True], cli[False]),
            "[rwkv6] serve.main's greedy tokens captured vs eager differ")
    used = ops.launch_counts()
    print(f"[rwkv6] serve.main --full: greedy tokens captured = eager; "
          f"launches over the phase {used}")
    require(used["wkv6"] == after_prefill["wkv6"],
            "[rwkv6] decode launched K8 (the decode step is the O(1) "
            "recurrence)")
    release(repro_torch)
    return used, params


def run_compression_api(ops, dev):
    """Phase 4d: ``bench_compression.py``'s calls of the dense kernels on a
    2^20 f32 vector: STC at 1%, quantize, dequantize, the round trip's
    relative error."""
    x = torch.randn((1 << 20,), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    ops.reset_launch_counts()
    stc = ops.stc_compress(x, 0.01)
    q, s = ops.quantize(x)
    xd = ops.dequantize(q, s, x.shape)
    torch.cuda.synchronize()
    used = ops.launch_counts()
    rel = ((xd - x).abs().max() / x.abs().max()).item()
    kept = int(torch.count_nonzero(stc))
    print(f"[api] stc kept {kept} of {x.numel()} ({kept / x.numel():.4%}); "
          f"int8 round trip rel err {rel:.4g} (bound 0.51/127 = "
          f"{0.51 / 127:.4g}); launches {used}")
    require(rel <= 0.51 / 127, f"[api] int8 round trip rel err {rel}")
    require(abs(kept / x.numel() - 0.01) < 1e-3, f"[api] stc kept {kept}")
    for k in ("stc_dense", "int8_quantize", "int8_dequantize"):
        require(used[k] == 1, f"[api] {k} launched {used[k]} times")
    return used


@contextlib.contextmanager
def float64_recurrence(rwkv_mod):
    """The model's grad-mode recurrence (``wkv6_chunked``) run in float64
    on float64 copies of its inputs, its outputs cast back to f32: the
    witness of phase 5c and ``scripts/bench_kernels.py --kernel wkv6``."""
    exact = rwkv_mod.wkv6_chunked

    def f64(*args):
        return tuple(t.float() for t in exact(*(a.double() for a in args)))
    rwkv_mod.wkv6_chunked = f64
    try:
        yield
    finally:
        rwkv_mod.wkv6_chunked = exact


F64_FROM = 16      # phase 5c's float64 bar holds the tokens from this one on


def worst_token(gap, start=0):
    """(max, sequence, token) of a (batch, tokens) gap from token
    ``start`` on."""
    g = gap[:, start:]
    s, t = divmod(int(g.argmax()), g.shape[1])
    return g.max().item(), s, t + start


def rwkv6_agreement(params, dev):
    """Phase 5c.  At full width and depth the random-init model amplifies
    f32 rounding differences over its 24 layers (how far, the probe shows:
    the logits moved by a 1e-7 relative perturbation of the embedding), most
    at the first tokens, so the end-to-end gaps are printed beside that
    probe, with a sanity bar of a tenth of the largest logit, and the bars
    hold the kernel against a float64 witness (the same forward with its
    recurrence in float64): per token, over the tokens from ``F64_FROM``
    on, K8 within max(2 x the f32 exact form's gap, 1e-2 x the largest
    logit); and each layer alone: every layer gets the same input (the
    chunked forward's hidden state) through K8, through ``wkv6_chunked``
    and through 64 decode steps, within 1e-4 of the layer output's scale of
    one another, and K8 within 1.5 x the exact form's distance from the
    layer with its recurrence in float64."""
    from repro_torch.configs import get_arch
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import (
        Model, make_prefill_step, make_serve_step,
    )

    f32 = Model(dataclasses.replace(get_arch("rwkv6-1.6b"),
                                    dtype="float32"))
    cfg = f32.cfg
    toks = torch.randint(0, cfg.vocab, (2, 500),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    perturbed = dict(params, embed=params["embed"] * (1.0 + 1e-7))
    with torch.no_grad():
        k8, _ = f32.forward(params, toks)
    with torch.enable_grad():
        chunked, _ = f32.forward(params, toks)
        probe, _ = f32.forward(perturbed, toks)
        with float64_recurrence(rwkv_mod):
            witness, _ = f32.forward(params, toks)
    require(not chunked.requires_grad, "[5c] the grad-mode forward recorded")
    e2e = (k8 - chunked).abs().max().item()
    pr = (probe - chunked).abs().max().item()
    print(f"[5c] rwkv6-1.6b f32, B 2 x 500 tokens, end to end: logits K8 "
          f"(no_grad) vs wkv6_chunked (grad mode) max |diff| {e2e:.4g}; "
          f"wkv6_chunked vs itself from a 1e-7-perturbed embedding "
          f"{pr:.4g} (max |logit| {k8.abs().max().item():.4g})")
    require(bool(torch.isfinite(k8).all())
            and e2e <= 0.1 * k8.abs().max().item(),
            f"[5c] K8 vs chunked logits differ by {e2e}")
    big = witness.abs().max().item()
    gaps = {tag: (a - witness).abs().amax(-1)          # (batch, tokens)
            for tag, a in (("K8", k8), ("wkv6_chunked", chunked))}
    tail = {tag: worst_token(g, F64_FROM) for tag, g in gaps.items()}
    for tag, g in gaps.items():
        v, sq, t = tail[tag]
        va, sa, ta = worst_token(g)
        print(f"[5c] end to end vs the float64 recurrence, {tag}: tokens >= "
              f"{F64_FROM} {v:.4g} (sequence {sq}, token {t}); all tokens "
              f"{va:.4g} (sequence {sa}, token {ta})")
    bar = max(2 * tail["wkv6_chunked"][0], 1e-2 * big)
    print(f"[5c] float64 bar, tokens >= {F64_FROM}: K8 {tail['K8'][0]:.4g} "
          f"<= max(2 x {tail['wkv6_chunked'][0]:.4g}, 1e-2 x max |logit| "
          f"{big:.4g}) = {bar:.4g}")
    require(tail["K8"][0] <= bar,
            f"[5c] K8 vs float64 over tokens >= {F64_FROM}: "
            f"{tail['K8'][0]} > {bar}")
    del k8, chunked, probe, perturbed, witness, gaps

    S = 64
    full = make_prefill_step(f32)(params, {"tokens": toks[:, :S]})
    step = make_serve_step(f32)
    cache = f32.init_cache(2, S)
    outs = []
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec = (torch.stack(outs, 1) - full).abs().max().item()
    print(f"[5c] rwkv6-1.6b f32, B 2 x {S} tokens, end to end: stepwise "
          f"decode vs forward max |diff| {dec:.4g} (the reference's bar "
          f"0.05 {'met' if dec <= 0.05 else 'NOT met: see the probe'})")
    del full, cache, outs

    # layer by layer, each on the chunked forward's hidden state
    seg = tfm.segments(cfg)[0]
    x = params["embed"][toks].to(torch.float32)
    positions = torch.arange(x.shape[1], device=dev)[None, :]
    caches = f32.init_cache(2, S)["segments"][0]
    worst = {"k8": 0.0, "decode": 0.0, "k8_f64": 0.0, "chunked_f64": 0.0}

    def scaled(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())
    with torch.no_grad():
        for li in range(seg.count):
            p = tfm._layer(params["segments"][0], li)
            a = tfm._apply_layer(cfg, seg, p, x, positions)[0]      # K8
            with torch.enable_grad():
                b = tfm._apply_layer(cfg, seg, p, x, positions)[0]  # chunked
                with float64_recurrence(rwkv_mod):
                    w = tfm._apply_layer(cfg, seg, p, x, positions)[0]
            worst["k8"] = max(worst["k8"], scaled(a, b))
            worst["k8_f64"] = max(worst["k8_f64"], scaled(a, w))
            worst["chunked_f64"] = max(worst["chunked_f64"], scaled(b, w))
            c = tfm._layer(caches, li)
            d = torch.cat([tfm._decode_layer(cfg, seg, p, x[:, t:t + 1], c,
                                             t, False) for t in range(S)],
                          dim=1)
            worst["decode"] = max(worst["decode"], scaled(d, b[:, :S]))
            x = b
    print(f"[5c] rwkv6-1.6b f32, each of {seg.count} layers on the same "
          f"input: K8 vs wkv6_chunked {worst['k8']:.3g}, {S} decode steps "
          f"vs the chunked forward {worst['decode']:.3g} (of the layer "
          f"output's scale; bar 1e-4)")
    require(worst["k8"] <= 1e-4, f"[5c] layer K8 vs chunked {worst['k8']}")
    require(worst["decode"] <= 1e-4,
            f"[5c] layer decode vs forward {worst['decode']}")
    print(f"[5c] each layer on the same input against the layer with its "
          f"recurrence in float64: K8 {worst['k8_f64']:.4g}, wkv6_chunked "
          f"{worst['chunked_f64']:.4g} (bar: K8 <= 1.5 x wkv6_chunked = "
          f"{1.5 * worst['chunked_f64']:.4g})")
    require(worst["k8_f64"] <= 1.5 * worst["chunked_f64"],
            f"[5c] layer K8 vs float64 {worst['k8_f64']} > 1.5 x "
            f"{worst['chunked_f64']}")
    del x, caches

    from repro_torch import convert
    for arch in ("rwkv6-1.6b", "glm4-9b"):
        model = Model(get_arch(arch, reduced=True))
        p_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        p_gpu = convert.params_from_jax(convert.params_to_numpy(p_cpu), dev)
        tk = torch.from_numpy(np.random.RandomState(1).randint(
            0, model.cfg.vocab, (2, 70)))
        pre = 0.0
        if arch == "rwkv6-1.6b":         # the K8 path; GLM-4's prefill at
            # the default init sits on near-tied attention scores (a 1e-7
            # perturbation moves its logits by ~1e-4): decode only
            got = make_prefill_step(model)(p_gpu, {"tokens": tk.to(dev)})
            want = make_prefill_step(model)(p_cpu, {"tokens": tk})
            pre = ((got.cpu() - want).abs()
                   - 1e-4 * want.abs()).max().item()
        step = make_serve_step(model)
        c_gpu = model.init_cache(2, 16, device=dev)
        c_cpu = model.init_cache(2, 16, device="cpu")
        dec = 0.0
        for t in range(12):
            lg, c_gpu = step(p_gpu, c_gpu, tk[:, t:t + 1].to(dev), t)
            lc, c_cpu = step(p_cpu, c_cpu, tk[:, t:t + 1], t)
            dec = max(dec, (lg.cpu() - lc).abs().max().item())
        print(f"[5c] reduced {arch} card vs CPU: prefill logits within "
              f"1e-4 + 1e-4 |x| (excess {pre:.3g}; rwkv6 only), 12 decode "
              f"steps max |diff| {dec:.3g} (bar 1e-4)")
        require(pre <= 1e-4, f"[5c] {arch} prefill card vs CPU")
        require(dec <= 1e-4, f"[5c] {arch} decode card vs CPU {dec}")


# ---------------------------------------------------------------------------
def femnist_shapes():
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_flatten, tree_paths

    p = femnist_cnn().init(torch.Generator().manual_seed(0), "cpu")
    sizes = [t.numel() for t in tree_flatten(p)[0]]
    return list(zip(tree_paths(p), sizes))


def update_rows(gen, n, d):
    """(n, d) update-like rows on ``gen``'s device: unit normal times a
    per-client scale, the last of more than 9 rows all zero (a padded
    client)."""
    x = torch.randn((n, d), generator=gen, device=gen.device)
    x *= torch.rand((n, 1), generator=gen, device=gen.device) * 0.1 + 1e-3
    if n > 9:
        x[-1] = 0.0
    return x.contiguous()


def check_kernels(dev, fedavg_agg, stc_topk, quant):
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(n, d):
        return update_rows(gen, n, d)

    leaves = [(name, s) for name, s in femnist_shapes() if s >= 64]
    d_total = sum(s for _, s in femnist_shapes())
    print("compressed leaves (>= 64 elements):", leaves, "D =", d_total)
    ragged = [(7, 20001), (3, 8193), (1, 63)]
    shapes = [(N_BUCKET, s) for _, s in leaves] + ragged
    errs = {"fedavg_agg": 0.0, "stc": 0.0, "rowmax": 0.0, "qdq": 0.0}

    # K1: the whole update matrix (scalar path: D % 4 != 0), a leaf with
    # D % 4 == 0 (float4 path), ragged widths
    for n, d in [(N_BUCKET, d_total), (N_BUCKET, 6422528), *ragged]:
        u = rand(n, d)
        w = torch.rand((n,), generator=gen, device=dev)
        w /= w.sum()
        k = fedavg_agg.fedavg_aggregate(u, w)
        p = fedavg_agg.fedavg_plain(u, w)
        torch.cuda.synchronize()
        rel = ((k - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
        errs["fedavg_agg"] = max(errs["fedavg_agg"], (k - p).abs().max().item())
        require(rel <= 1e-6, f"fedavg_agg ({n}, {d}): rel err {rel} > 1e-6")
        print(f"fedavg_agg ({n}, {d}): max rel err {rel:.3g}")
    errs["fedavg_agg_tree"] = check_tree(gen, d_total, fedavg_agg)
    for n, d in shapes:
        x = rand(n, d)
        ko, kn = stc_topk.stc_compress_batched(x, 0.01)
        po, pn = stc_topk.stc_plain(x, 0.01)
        torch.cuda.synchronize()
        require(torch.equal(ko != 0, po != 0), f"stc ({n}, {d}): masks differ")
        require(torch.equal(kn, pn), f"stc ({n}, {d}): nnz differ")
        u = ulps(ko, po) if ko.numel() else 0.0
        require(u <= 1.0, f"stc ({n}, {d}): values differ by {u} ulp > 1")
        errs["stc"] = max(errs["stc"], (ko - po).abs().max().item())
        km = quant.rowmax(x)
        pm = quant.rowmax_plain(x)
        s = quant.int8_scale(pm)
        check_rowmax(quant, rowmax_rows(gen, n, d), f"({n}, {d})")
        kq = quant.qdq(x, s)
        kq2, ki = quant.qdq(x, s, with_q=True)     # the int8 q as well
        pq, pi = quant.qdq_plain(x, s, with_q=True)
        torch.cuda.synchronize()
        require(torch.equal(km.view(torch.int32), pm.view(torch.int32)),
                f"int8 rowmax ({n}, {d}): not bitwise equal")
        require(torch.equal(kq.view(torch.int32), pq.view(torch.int32))
                and torch.equal(kq2.view(torch.int32), pq.view(torch.int32)),
                f"int8 qdq ({n}, {d}): not bitwise equal")
        require(ki.dtype == torch.int8 and torch.equal(ki, pi),
                f"int8 qdq ({n}, {d}): int8 q not equal")
        errs["rowmax"] = max(errs["rowmax"], (km - pm).abs().max().item())
        errs["qdq"] = max(errs["qdq"], (kq - pq).abs().max().item())
        print(f"stc/int8 ({n}, {d}): masks+nnz bitwise, values <= {u:.3g} "
              f"ulp; rowmax+qdq bitwise, qdq's int8 q equal")
    for n, d, off in ((1, 6422528, 0), (5, 20002, 1), (6, 4099, 3)):
        # the sequential stage's (1, n) row; rows of a view that starts
        # off a 16-byte boundary (every row a plan of its own)
        x = rowmax_rows(gen, n, d + off).reshape(-1)[off:off + n * d]
        check_rowmax(quant, x.view(n, d), f"({n}, {d}) at element {off}")
    for d in (8193, 20001):
        x = stc_topk.adversarial_rows(d).to(dev)
        ko, kn = stc_topk.stc_compress_batched(x, 0.01)
        po, pn = stc_topk.stc_plain(x, 0.01)
        torch.cuda.synchronize()
        u = check_stc(ko, po, f"stc adversarial (7, {d})")
        require(torch.equal(kn, pn), f"stc adversarial (7, {d}): nnz differ")
        errs["stc"] = max(errs["stc"], (ko - po).abs().max().item())
        print(f"stc adversarial rows (7, {d}): masks+signs+nnz bitwise, "
              f"values <= {u:.3g} ulp (nnz {kn.int().tolist()})")

    # timings at the main path's largest shapes
    rows = []
    n, d = N_BUCKET, d_total
    u = rand(n, d)
    w = torch.rand((n,), generator=gen, device=dev)
    w /= w.sum()
    b, by = bound(4 * n * d + 4 * n + 4 * d, 2 * n * d)
    rows.append(dict(
        name="fedavg_agg", counter="fedavg_agg", route="cuda",
        source="src/repro_torch/kernels/csrc/fedavg_agg.cu",
        replaces="src/repro/kernels/fedavg_agg.py:114",
        shape=[n, d], max_abs_err=errs["fedavg_agg"],
        ms=cuda_ms(lambda: fedavg_agg.fedavg_aggregate(u, w)),
        plain_ms=cuda_ms(lambda: fedavg_agg.fedavg_plain(u, w)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: w @ u)))
    g = 2                             # the tree's first tier: 2 groups of 8
    b, by = bound(4 * n * d + 4 * n + 4 * g * d, 2 * n * d)
    rows.append(dict(
        name="fedavg_agg_tree", counter="fedavg_agg_tree", route="cuda",
        source="src/repro_torch/kernels/csrc/fedavg_agg.cu",
        replaces="src/repro/kernels/fedavg_agg.py:114",
        shape=[g, n // g, d], max_abs_err=errs["fedavg_agg_tree"],
        ms=cuda_ms(lambda: fedavg_agg.fedavg_aggregate_grouped(u, w, g)),
        plain_ms=cuda_ms(lambda: fedavg_agg.fedavg_grouped_plain(u, w, g)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.einsum(
            "gf,gfd->gd", w.view(g, -1), u.view(g, -1, d))),
        second_tier=tree_second_tier(fedavg_agg, u, w)))
    del u

    n, d = N_BUCKET, 6422528          # fc1/w, the dominant leaf
    x = rand(n, d)
    b, by = stc_bound(x, stc_topk)
    rows.append(dict(
        name="stc_batched", counter="stc_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/stc_topk.cu",
        replaces="src/repro/kernels/stc_topk.py:118",
        shape=[n, d], max_abs_err=errs["stc"],
        ms=cuda_ms(lambda: stc_topk.stc_compress_batched(x, 0.01)),
        device_ms=device_ms(lambda: stc_topk.stc_compress_batched(x, 0.01)),
        plain_ms=cuda_ms(lambda: stc_topk.stc_plain(x, 0.01)),
        bound_ms=b, bound_by=by, library_ms=None))
    rows.append(dict(
        name="int8_rowmax", counter="int8_rowmax", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:106",
        shape=[n, d], max_abs_err=errs["rowmax"], **k3a_times(quant, x),
        at_rows={"1x6422528": k3a_times(quant, x[0:1])}))
    s = quant.int8_scale(quant.rowmax_plain(x))
    zp = torch.zeros((n,), dtype=torch.int32, device=dev)
    b, by = bound(8 * n * d + 4 * n, 5 * n * d)
    rows.append(dict(
        name="int8_qdq", counter="int8_qdq", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:117",
        shape=[n, d], max_abs_err=errs["qdq"],
        ms=cuda_ms(lambda: quant.qdq(x, s)),
        plain_ms=cuda_ms(lambda: quant.qdq_plain(x, s)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.fake_quantize_per_channel_affine(
            x, s, zp, 0, -127, 127))))
    del x
    print(f"K3a at (1, 6422528), the sequential stage's fc1/w row: "
          f"{json.dumps(rows[-2]['at_rows'])}")
    print(f"K1 tree's second tier (2 partials, the route's combining "
          f"launch): {json.dumps(rows[1]['second_tier'])}")
    for r in rows:
        print(f"{r['name']:12s} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; device time {r['device_ms']:.4f} ms"
                 if "device_ms" in r else "")
              + (f", graph {r['graph_ms']:.4f} ms; library device "
                 f"{r['library_device_ms']:.4f}, graph "
                 f"{r['library_graph_ms']:.4f} ms"
                 if "library_device_ms" in r else ""))
    return rows


def k3a_times(quant, x):
    """K3a (``quant.rowmax``, the max and scale launch) on ``x``: CUDA-event,
    device and graph ms beside its plain version, ``vector_norm(inf)``'s
    CUDA-event, device and graph ms and the bound (reads x, writes m and
    the scale)."""
    n, d = x.shape
    b, by = bound(4 * n * d + 8 * n, 2 * n * d)

    def lib():
        return torch.linalg.vector_norm(x, float("inf"), dim=1)
    return dict(ms=cuda_ms(lambda: quant.rowmax(x)),
                device_ms=device_ms(lambda: quant.rowmax(x)),
                graph_ms=graph_ms(lambda: quant.rowmax(x)),
                plain_ms=cuda_ms(lambda: quant.rowmax_plain(x), reps=5),
                bound_ms=b, bound_by=by, library_ms=cuda_ms(lib),
                library_device_ms=device_ms(lib),
                library_graph_ms=graph_ms(lib))


def tree_second_tier(fedavg_agg, u, w):
    """The hierarchical route's second tier at (16, D), fanout 0, as the
    route calls it: its 2 first-tier partials summed at weight 1 in one
    combining launch (no padded rows) -> CUDA-event, device and graph ms
    beside the bound (2 rows read, one written) and the plain version."""
    parts = fedavg_agg.fedavg_aggregate_grouped(u, w, 2)
    d = parts.shape[1]
    b, by = bound(3 * 4 * d + 8, 2 * 2 * d)
    ones = torch.ones((2,), dtype=torch.float32, device=u.device)

    def tier():       # 2 rows, fanout 1: one tier of one group of 8 rows
        return fedavg_agg.fedavg_aggregate_tree(parts, ones, fanout=1)
    got = tier()
    torch.cuda.synchronize()
    require(same_bits(got, fedavg_agg.fedavg_plain(parts, ones)),
            "K1 tree second tier: not bitwise its plain version")
    return dict(ms=cuda_ms(tier), device_ms=device_ms(tier),
                graph_ms=graph_ms(tier),
                plain_ms=cuda_ms(lambda: fedavg_agg.fedavg_plain(parts, ones)),
                bound_ms=b, bound_by=by)


def rowmax_rows(gen, n, d):
    """K3a's edge rows on ``gen``'s device: ``update_rows``, then, where
    there are rows for them, a NaN row, a +-inf row, an all -0.0 row, a
    subnormal-only row and a row whose one non-zero lies below 1e-12."""
    x = update_rows(gen, n, d)
    dev = gen.device
    if n > 1:
        x[1, d // 3] = float("nan")
    if n > 2:
        x[2, d // 2] = float("inf")
        x[2, (2 * d) // 3] = float("-inf")
    if n > 3:
        x[3] = -0.0
    if n > 4:
        k = torch.randint(1, 2 ** 23, (d,), generator=gen, device=dev)
        sign = torch.randint(0, 2, (d,), generator=gen, device=dev) * 2 - 1
        x[4] = (k * sign).to(torch.float32) * 2.0 ** -149
    if n > 5:
        x[5] = 0.0
        x[5, d - 1] = 3e-13
    return x


def check_rowmax(quant, x, what):
    """K3a's max and scale (``quant.rowmax_scale``, one launch) against
    ``rowmax_plain`` and ``int8_scale``, bit for bit (any NaN equal to any
    NaN): eagerly, then captured in a CUDA graph and replayed three times
    on new data (x times 2, 0.5, 3), each replay against the plain version
    on its data: a row's arrival counter that did not reset would leave
    the row's max and scale unwritten."""
    def plain(t):
        pm = quant.rowmax_plain(t)
        return pm, quant.int8_scale(pm)
    m, s = quant.rowmax_scale(x)
    pm, ps = plain(x)
    torch.cuda.synchronize()
    require(same_bits(m, pm) and same_bits(s, ps),
            f"int8 rowmax {what}: max or scale not bitwise the plain version")
    static = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gm, gs = quant.rowmax_scale(static)
    for i, f in enumerate((2.0, 0.5, 3.0)):
        torch.mul(x, f, out=static)
        graph.replay()
        pm, ps = plain(static)
        torch.cuda.synchronize()
        require(same_bits(gm, pm) and same_bits(gs, ps),
                f"int8 rowmax {what}: replay {i + 1} of the captured launch "
                f"not bitwise the plain version")
    del graph, static
    print(f"int8 rowmax {what}: max and scale bitwise, eagerly and in 3 "
          f"replays of a captured launch")


def k1_routes(fedavg_agg, dev, ks=(2, 4), fanouts=(0, 2)):
    """K1's routes of more than one row block or tier, each with its plain
    version: the tree at fanout 0 and 3, and the sharded route over k
    shards of ``dev`` (one launch for them all) at ``fanouts``, on the
    row blocks as the round gives them."""
    from repro_torch.core.batched import build_client_mesh

    routes = [(f"tree fanout {f}",
               functools.partial(fedavg_agg.fedavg_aggregate_tree, fanout=f),
               functools.partial(fedavg_agg.fedavg_tree_plain, fanout=f))
              for f in (0, 3)]
    for k in ks:
        mesh = build_client_mesh([dev] * k)
        for f in fanouts:
            routes.append((
                f"sharded k={k} fanout {f}",
                lambda u, w, m=mesh, f=f: fedavg_agg.fedavg_aggregate_sharded(
                    list(u.tensor_split(m.size)), w, m, fanout=f),
                lambda u, w, k=k, f=f: fedavg_agg.fedavg_sharded_plain(
                    u, w, k, f)))
    return routes


def check_k1_routes(fedavg_agg, u, w, what):
    """Every route of ``k1_routes`` on (N, D) ``u``: bit for bit its plain
    version, within 1e-6 relative of flat K1, with a peak allocation under
    4 rows of D (its tier outputs and result: no padded (rows, D) copy),
    and, captured in a CUDA graph, bit for bit its plain version in three
    replays on new data (u times 2, 0.5, 3) -> the largest |route - flat|."""
    d = u.shape[1]
    flat = fedavg_agg.fedavg_aggregate(u, w)
    worst = 0.0
    for name, route, plain in k1_routes(fedavg_agg, u.device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = route(u, w)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        require(same_bits(out, plain(u, w)), f"K1 {name} {what}: not "
                f"bitwise its plain version")
        rel = ((out - flat).abs().max()
               / flat.abs().max().clamp_min(1e-30)).item()
        require(rel <= 1e-6, f"K1 {name} {what}: {rel} relative from flat")
        require(peak < 4 * 4 * d, f"K1 {name} {what}: {peak} bytes "
                f"allocated, 4 rows of D would be {16 * d}: a padded copy")
        worst = max(worst, (out - flat).abs().max().item())
        static = u.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gout = route(static, w)
        for i, f in enumerate((2.0, 0.5, 3.0)):
            torch.mul(u, f, out=static)
            graph.replay()
            want = plain(static, w)
            torch.cuda.synchronize()
            require(same_bits(gout, want), f"K1 {name} {what}: replay "
                    f"{i + 1} of the captured route not bitwise its plain "
                    f"version")
        del graph, static
        print(f"K1 {name} {what}: bitwise its plain version (eagerly and "
              f"in 3 graph replays), {rel:.3g} relative from flat K1, peak "
              f"allocation {peak} bytes ({peak / (4 * d):.2f} rows of D)")
    return worst


def check_tree(gen, d_total, fedavg_agg):
    """K1's routes of more than one launch or block (``check_k1_routes``:
    the hierarchical tree, the sharded route on k shards of the card) at
    the whole femnist update matrix (16 rows: a tier of 2 groups of 8, then
    one combining launch of the 2 partials) and at a ragged (10,
    1,000,003) (the scalar path; a last group of 2 real rows); then the
    grouped launch itself against its plain version, bit for bit: 2 groups
    of 8 of the femnist matrix, and 10 rows padded to 12 with zero rows in
    groups of 3 at D = 1,000,003 -> the largest |grouped - plain|."""
    worst = 0.0
    for n, d in ((N_BUCKET, d_total), (10, 1000003)):
        u = update_rows(gen, n, d)
        w = torch.rand((n,), generator=gen, device=gen.device)
        w /= w.sum()
        check_k1_routes(fedavg_agg, u, w, f"({n}, {d})")
    for n, d, g in ((N_BUCKET, d_total, 2), (10, 1000003, 4)):
        u = update_rows(gen, n, d)
        w = torch.rand((n,), generator=gen, device=gen.device)
        w /= w.sum()
        rows = -(-n // g) * g
        u = torch.nn.functional.pad(u, (0, 0, 0, rows - n))
        w = torch.nn.functional.pad(w, (0, rows - n))
        k = fedavg_agg.fedavg_aggregate_grouped(u, w, g)
        p = fedavg_agg.fedavg_grouped_plain(u, w, g)
        torch.cuda.synchronize()
        require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
                f"fedavg_agg grouped ({n}, {d}, groups {g}): not bitwise "
                f"equal to its plain version")
        worst = max(worst, (k - p).abs().max().item())
        print(f"fedavg_agg grouped ({n} rows, D {d}, {g} groups): bitwise "
              f"equal to its plain version")
    return worst


def stc_bound(x, stc_topk, counts=True):
    """Least time of STC on an (N, D) matrix: bytes to read x and write the
    output (and, with ``counts``, the N kept counts: K2, not K4);
    operations per real element abs + max + 16 x (compare, add) + the final
    compare and add, and an add per kept element.
    -> (ms, "bytes" | "operations")."""
    n, d = x.shape
    kept = int(stc_topk.stc_compress_batched(x, 0.01)[1].sum().item())
    return bound(8 * n * d + 4 * n * counts, 36 * n * d + 2 * kept)


def check_stc(out, plain, what):
    """STC masks and signs bitwise, values within 1 ulp -> the ulps."""
    require(torch.equal(out != 0, plain != 0), f"{what}: masks differ")
    require(torch.equal(torch.sign(out), torch.sign(plain)),
            f"{what}: signs differ")
    u = ulps(out, plain) if out.numel() else 0.0
    require(u <= 1.0, f"{what}: values differ by {u} ulp > 1")
    return u


# ---------------------------------------------------------------------------
def femnist_config(mode, execution, rounds=3, clients=10):
    """Phases 4 and 4e: femnist_cnn at its published width, 10 clients a
    round (phase 4j also 20), 1 local epoch, K1 on."""
    return {"model": "femnist_cnn", "dataset": "femnist",
            "resources": {"execution": execution,
                          "aggregation_kernel": True},
            "client": {"local_epochs": 1, "compression": mode},
            "server": {"rounds": rounds, "clients_per_round": clients}}


#: phase 4h: the paper's other two models -> their datasets (the models
#: are the datasets' defaults: ``init`` is given the dataset alone)
M3_MODELS = {"shakespeare_lstm": "shakespeare", "cifar_resnet18": "cifar10"}
#: phase 4h's card-vs-CPU runs (rounds, clients a round): cut from phase
#: 5's 2 x 4 to 1 x 2 (the CPU side of either took over half a minute),
#: the ResNet's to 1 x 1 (its CPU side of 1 x 2 took 115 s)
M3_CPU_CUT = {"shakespeare_lstm": (1, 2), "cifar_resnet18": (1, 1)}


def model_config(model, mode, execution, rounds=3, clients=10):
    """Phase 4h: ``model`` at its published width on its dataset's
    defaults, 10 clients a round, 1 local epoch (cut as in phase 4), K1
    on."""
    return {"dataset": M3_MODELS[model],
            "resources": {"execution": execution,
                          "aggregation_kernel": True},
            "client": {"local_epochs": 1, "compression": mode},
            "server": {"rounds": rounds, "clients_per_round": clients}}


def conditioning_gap(repro_torch, cfg, init, final, seeds=(1, 2, 3),
                     final_losses=None):
    """``cfg`` run on the card from ``init`` perturbed by a relative 1e-7
    (f32 rounding's size), once a seed -> the largest max |param diff|
    from ``final``, the params of the unperturbed run: how far rounding
    alone moves this run.  Given ``final_losses`` (that run's train losses)
    -> (that gap, the largest |train_loss diff| from them)."""
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.utils.tree import tree_leaves, tree_map

    worst = worst_loss = 0.0
    for seed in seeds:
        repro_torch.reset()
        repro_torch.set_device(None)
        repro_torch.init(cfg)
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        gen = torch.Generator().manual_seed(seed)
        trainer.server.params = tree_map(
            lambda t: (t.cpu() * (1 + 1e-7 * torch.randn(
                t.shape, generator=gen))).to(trainer.device), init)
        res = trainer.run()
        out = tree_leaves(res["params"])
        worst = max(worst, max_diff([t.cpu() for t in out], final))
        if final_losses is not None:
            worst_loss = max([worst_loss] + [
                abs(h["train_loss"] - f)
                for h, f in zip(res["history"], final_losses)])
    repro_torch.reset()
    return worst if final_losses is None else (worst, worst_loss)


WALLS = {}    # run tag -> steady round walls (rounds 1-2), for phase 4g
#: run tag -> the figures phase 4p compares: CUDA-graph captures and
#: replays, main-thread CPU seconds of rounds 1-2, peak GiB, launches,
#: params
RUNS = {}


@contextlib.contextmanager
def round_starts(marks):
    """Append the main thread's CPU time (``time.thread_time``) to
    ``marks`` as each synchronous round starts (``Trainer.
    _dispatch_round``): a round's host CPU is the difference to the next
    mark."""
    from repro_torch.core.rounds import Trainer

    dispatch = Trainer._dispatch_round

    def timed(self, round_id):
        marks.append(time.thread_time())
        return dispatch(self, round_id)

    Trainer._dispatch_round = timed
    try:
        yield
    finally:
        Trainer._dispatch_round = dispatch


def run_slice(repro_torch, ops, mode, execution="batched", resources=None,
              tracking=None, tag=None, k1="fedavg_agg", per_round=None,
              faults=None, history=None, model="femnist_cnn", clients=10,
              shards=None):
    """femnist_cnn (phases 4, 4e, 4f and 4g) or another model on its
    dataset's defaults (``model_config``, phase 4h) through ``init``/``run``
    -> (launch counts of the run, final params on the CPU).  ``resources``
    and ``tracking`` override the configuration's; ``k1`` is the FedAvg kernel's counter
    that must count one launch a tier a round (``fedavg_agg``: flat, one
    tier; ``fedavg_agg_tree``: two tiers), the other none; ``per_round``
    the dispatches and host syncs a round (default: the fused round's one
    each, none for the sequential engine); ``faults`` the ``cfg.faults``
    block (a round no client survives has a NaN ``train_loss``);
    ``history``, a list, receives the run's history; ``clients`` the
    cohort a round; ``shards`` (phase 4j) the client mesh's size under
    ``resources.distributed="data"``: the sharded K1 route launches once
    (flat, or one tier of the tree) a card a round."""
    from repro_torch.core import batched

    rounds = 3
    tag = tag or (mode if execution == "batched" else f"{execution} {mode}")
    cfg = (femnist_config(mode, execution, rounds, clients)
           if model == "femnist_cnn"
           else model_config(model, mode, execution, rounds))
    cfg["resources"].update(resources or {})
    if tracking:
        cfg["tracking"] = tracking
    if faults:
        cfg["faults"] = faults
    repro_torch.reset()
    repro_torch.init(cfg)
    d0, h0 = batched.dispatch_count(), batched.host_sync_count()
    c0, r0 = batched.round_capture_count(), batched.round_replay_count()
    cc0, cr0 = batched.cohort_capture_count(), batched.cohort_replay_count()
    gc.collect()                                     # earlier runs' cycles
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30    # earlier phases' tensors
    ops.reset_launch_counts()
    starts = []                   # main-thread CPU s at each round's start
    t0 = time.perf_counter()
    with round_starts(starts):
        res = repro_torch.run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    starts.append(time.thread_time())
    cpu = [round(b - a, 4) for a, b in zip(starts[1:-1], starts[2:])]
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    used = ops.launch_counts()
    hist = res["history"]
    captures = batched.round_capture_count() - c0
    replays = batched.round_replay_count() - r0
    cohort = (batched.cohort_capture_count() - cc0,
              batched.cohort_replay_count() - cr0)
    print(f"[{tag}] launches {used} (counted through {replays} CUDA-graph "
          f"replays of the round and {cohort[1]} of the cohort program; "
          f"{captures} and {cohort[0]} capture(s))")
    engine = repro_torch.core.api._ctx.trainer.engine
    mesh = None if engine is None else engine.mesh
    require((None if mesh is None else mesh.size) == shards,
            f"[{tag}] client mesh {mesh}, expected {shards} shards")
    # the sharded route: one launch a run of shards on one card (flat, or
    # the one tier of each shard's tree); unsharded: one a tier
    from repro_torch.kernels.fedavg_agg import shard_runs
    tiers = (len(shard_runs(mesh.devices)) if shards
             else 2 if k1 == "fedavg_agg_tree" else 1)
    for k in ("fedavg_agg", "fedavg_agg_tree"):
        want_k1 = rounds * tiers if k == k1 else 0
        require(used[k] == want_k1, f"[{tag}] {k} launched {used[k]} "
                f"times, expected {want_k1}")
    want = {"none": (), "stc": ("stc_batched",),
            "int8": ("int8_rowmax", "int8_qdq")}[mode]
    for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
        if k in want:
            require(used[k] > 0, f"[{tag}] {k} never launched")
        else:
            require(used[k] == 0, f"[{tag}] {k} launched outside its mode")
    # the fused round: one dispatch and one host sync a round; the
    # sequential engine never enters the batched one
    if per_round is None:
        per_round = (1, 1) if execution == "batched" else (0, 0)
    for what, count, n in (("dispatches", batched.dispatch_count(), d0),
                           ("host syncs", batched.host_sync_count(), h0)):
        want_n = rounds * per_round[what == "host syncs"]
        require(count - n == want_n, f"[{tag}] {what} {count - n} != "
                f"{want_n}")
    for h in hist:
        require((math.isfinite(h["train_loss"]) or h.get("survivors") == 0)
                and math.isfinite(h["loss"]),
                f"[{tag}] non-finite loss in {h}")
    if history is not None:
        history.extend(hist)
    from repro_torch.models.registry import get_model
    from repro_torch.utils.tree import tree_leaves
    ref_shapes = [t.shape for t in tree_leaves(
        get_model(model).init(torch.Generator().manual_seed(0), "cpu"))]
    out = tree_leaves(res["params"])
    require([t.shape for t in out] == ref_shapes, f"[{tag}] param shapes")
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"[{tag}] non-finite params")
    walls = [h["wall_time"] for h in hist]
    WALLS[tag] = walls[1:]
    RUNS[tag] = {"captures": captures, "replays": replays, "cpu": cpu,
                 "cohort": cohort, "peak": peak, "launches": used,
                 "params": [t.cpu() for t in out]}
    if execution == "sequential":
        trainer = repro_torch.core.api._ctx.trainer
        RUNS[tag]["steps"] = steps = step_counts(
            trainer.client(trainer.fed_data.client_ids[0]),
            evaluated=trainer.cfg.server.test_every > 0)
        print(f"[{tag}] sequential steps: {steps}")
        if sequential_captured():
            require(all(c["keys"] >= 1 and c["captures"] == c["keys"]
                        and c["recaptures"] == 0 for c in steps.values()),
                    f"[{tag}] steps {steps}: expected 1 capture a key, 0 "
                    f"recaptures")
        else:
            require(all(c["captures"] == 0 for c in steps.values()),
                    f"[{tag}] captured under eager_sequential: {steps}")
    print(f"[{tag}] round wall s: round0 {walls[0]:.4f} "
          f"(first-use setup included), later {[round(x, 4) for x in walls[1:]]};"
          f" run total {total:.3f} s; main-thread CPU s of rounds 1-2 {cpu}; "
          f"peak device memory {peak:.2f} GiB "
          f"above the {held:.2f} GiB held before the run")
    print(f"[{tag}] train_loss {[round(h['train_loss'], 5) for h in hist]}"
          f" test loss {[round(h['loss'], 5) for h in hist]} test acc "
          f"{[round(h['accuracy'], 4) for h in hist]} comm_up "
          f"{[h['comm_up_bytes'] for h in hist]}")
    repro_torch.reset()
    return used, RUNS[tag]["params"]


def step_counts(client, evaluated=True):
    """The sequential engine's cached client step that ``client`` (a
    ``core/client.py::Client``) trained with and, where the run evaluated
    (``evaluated``), its model's eval step (``core/local_train.py``: one
    CUDA graph a shapes key) -> {"client" / "eval": {keys, captures,
    recaptures, replays, eager_steps}} (eager_steps: the warm-ups of the
    graphed steps).  Each step must be a cache hit: a miss would make a
    new, empty step."""
    from repro_torch.core import local_train as lt

    factories = ((lt.make_client_step, lt.make_eval_step) if evaluated
                 else (lt.make_client_step,))
    sizes = [f.cache_info().currsize for f in factories]
    steps = {"client": lt.make_client_step(client.model, client.optimizer,
                                           client.cfg.proximal_mu,
                                           client.cfg.max_grad_norm)}
    if evaluated:
        steps["eval"] = lt.make_eval_step(client.model)
    now = [f.cache_info().currsize for f in factories]
    require(now == sizes, f"the client's steps were not cached: cache "
            f"sizes {sizes} -> {now}")
    return {name: {"keys": len(st.keys()), "captures": st.captures,
                   "recaptures": st.recaptures, "replays": st.replays,
                   "eager_steps": st.eager_steps}
            for name, st in steps.items()}


def sequential_captured():
    """Whether the sequential steps run as CUDA graphs on the card (not
    inside :func:`eager_sequential`)."""
    from repro_torch.core import local_train as lt

    return "cuda" in lt._GraphedStep.graph_device_types


@contextlib.contextmanager
def eager_sequential():
    """Every sequential client and eval step runs eagerly inside (no
    device type runs them as a graph): the eager side of phases 4e's and
    4h's A/B."""
    from repro_torch.core import local_train as lt

    kept = lt._GraphedStep.graph_device_types
    lt._GraphedStep.graph_device_types = ()
    try:
        yield
    finally:
        lt._GraphedStep.graph_device_types = kept


def sequential_ab(repro_torch, ops, smi, model="femnist_cnn"):
    """Phases 4e and 4h: ``model``'s sequential none run (3 rounds of 10
    clients) with its client and eval steps captured (one CUDA graph a
    shapes key) beside its eager twin (``eager_sequential``), both under
    :func:`deterministic_cudnn`: final params bit for bit, 1 capture a key
    and 0 recaptures of each step, none in the twin (:func:`run_slice`
    holds the counts); round walls and
    main-thread CPU s of rounds 1-2 and peak GiB of both.  The replays run
    under ``set_sync_debug_mode("error")``: a host sync in one raises.
    -> (launch counts, final params on the CPU) of the captured run."""
    tag = ("sequential none" if model == "femnist_cnn"
           else f"{model} sequential none") + " deterministic"
    eager = f"eager {tag}"
    with deterministic_cudnn():
        used, params = run_slice(repro_torch, ops, "none",
                                 execution="sequential", tag=tag,
                                 model=model)
        with eager_sequential():
            run_slice(repro_torch, ops, "none", execution="sequential",
                      tag=eager, model=model)
    cap, eag = RUNS[tag], RUNS[eager]   # run_slice checked their counts
    same = same_bits_tree(cap["params"], eag["params"])
    print(f"[captured {tag}] client step {cap['steps']['client']}, eval "
          f"step {cap['steps']['eval']}; round walls 1-2 "
          f"{[round(x, 4) for x in WALLS[tag]]} s captured, "
          f"{[round(x, 4) for x in WALLS[eager]]} s eager; main-thread CPU "
          f"s of rounds 1-2 {cap['cpu']} / {eag['cpu']}; peak "
          f"{cap['peak']:.2f} / {eag['peak']:.2f} GiB; final params bit for "
          f"bit the eager twin's: {same} ({smi})")
    require(same, f"[{tag}] captured and eager final params differ")
    return used, params


#: phase 4f's paths against the fused round of their mode, both under
#: deterministic cuDNN: tag -> max |param diff| (ROADMAP queue 3's
#: femnist spread item)
SPREAD = {}


def run_batched_paths(repro_torch, ops, fused, gaps, init, smi):
    """Phase 4f, every run under :func:`deterministic_cudnn`: phase 4's
    configuration (a) on the staged path (``round_fusion="off"``) for none
    / stc / int8, its cohort program captured (one CUDA graph a bucket),
    each beside its eager twin (``eager_rounds``): final params and
    launches equal bit for bit, 1 capture and 2 replays of the cohort in 3
    rounds, none in the twin, round walls and main-thread CPU s of rounds
    1-2 and peak of both; (b) hierarchical, fused, fanout 0 (stc) and (c)
    with ``tracking.round_sync=False`` (int8).  Launch counts: K1 3 a run
    flat, 6 under the tree (two tiers, one grouped launch each), K2 or K3
    18 (6 leaves x 3 rounds).  Final params against phase 4's run of the
    same mode (``fused``), printed against 1e-4 and held within max(1e-4,
    2 x how far phase 4's run of that mode moves from 1e-7-perturbed
    inits; ``gaps`` caches it); and each path's distance from the fused
    run of its mode under the same deterministic cuDNN (``SPREAD``): the
    staged and the deferred runs bit for bit (they run the fused round's
    arithmetic), the tree printed (its sums run in another order; 2.39e-3
    after 3 stc rounds, PERF.md).  -> the tree run's grouped K1
    launches."""
    runs = [("staged none", "none", {"round_fusion": "off"}, "fedavg_agg",
             (2, 1)),
            ("staged stc", "stc", {"round_fusion": "off"}, "fedavg_agg",
             (3, 2)),
            ("staged int8", "int8", {"round_fusion": "off"}, "fedavg_agg",
             (3, 1)),
            ("hierarchical stc", "stc",
             {"aggregation_topology": "hierarchical"}, "fedavg_agg_tree",
             (1, 1)),
            ("deferred int8", "int8", {}, "fedavg_agg", (1, 1))]
    tree_launches = None
    with deterministic_cudnn():
        for mode in ("none", "stc", "int8"):
            run_slice(repro_torch, ops, mode,
                      tag=f"fused {mode} deterministic")
        for tag, mode, res, k1, per_round in runs:
            kw = dict(resources=res, k1=k1, per_round=per_round,
                      tracking={"round_sync": False}
                      if tag.startswith("deferred") else None)
            used, params = run_slice(repro_torch, ops, mode, tag=tag, **kw)
            for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
                require(used[k] in (0, 18), f"[{tag}] {k} launched "
                        f"{used[k]} times, expected 18 (6 leaves x 3 "
                        f"rounds) or 0")
            if k1 == "fedavg_agg_tree":
                tree_launches = used[k1]
            if mode not in gaps:
                gaps[mode] = conditioning_gap(
                    repro_torch, femnist_config(mode, "batched"), init,
                    fused[mode])
            diff = max_diff(params, fused[mode])
            bar = max(1e-4, 2 * gaps[mode])
            print(f"[{tag}] final params vs phase 4's fused {mode}: max "
                  f"|diff| {diff:.4g} ({'within' if diff <= 1e-4 else 'above'}"
                  f" 1e-4); phase 4's {mode} run from 1e-7-perturbed inits "
                  f"moves up to {gaps[mode]:.4g}; bar max(1e-4, 2 x that) = "
                  f"{bar:.4g}")
            require(diff <= bar, f"[{tag}] vs fused {mode}: {diff} > {bar}")
            det = RUNS[f"fused {mode} deterministic"]["params"]
            SPREAD[tag] = max_diff(params, det)
            same = same_bits_tree(params, det)
            print(f"[{tag}] vs the fused {mode} run, both under "
                  f"deterministic cuDNN: max |diff| {SPREAD[tag]:.4g}, bit "
                  f"for bit {same} ({smi})")
            # the staged stages and the deferred sync run the fused
            # round's arithmetic; the tree sums in another order
            require(same or tag.startswith("hierarchical"),
                    f"[{tag}] differs from the fused {mode} run under "
                    f"deterministic cuDNN by {SPREAD[tag]}")
            if tag.startswith("staged"):
                staged_ab(repro_torch, ops, tag, mode, kw, smi)
    return tree_launches


def staged_ab(repro_torch, ops, tag, mode, kw, smi):
    """Phase 4f: the staged run ``tag`` (its cohort program captured)
    against its eager twin (``eager_rounds``), under the caller's
    deterministic cuDNN."""
    eager = f"eager {tag}"
    with eager_rounds():
        run_slice(repro_torch, ops, mode, tag=eager, **kw)
    cap, eag = RUNS[tag], RUNS[eager]
    same = same_bits_tree(cap["params"], eag["params"])
    print(f"[captured {tag}] cohort program {cap['cohort'][0]} capture(s), "
          f"{cap['cohort'][1]} replays in 3 rounds (eager twin "
          f"{eag['cohort']}); round walls 1-2 "
          f"{[round(x, 4) for x in WALLS[tag]]} s captured, "
          f"{[round(x, 4) for x in WALLS[eager]]} s eager; main-thread CPU "
          f"s of rounds 1-2 {cap['cpu']} / {eag['cpu']}; peak "
          f"{cap['peak']:.2f} / {eag['peak']:.2f} GiB; final params bit for "
          f"bit the eager twin's: {same} ({smi})")
    require(cap["cohort"] == (1, 2) and eag["cohort"] == (0, 0),
            f"[{tag}] cohort captures, replays {cap['cohort']} (eager "
            f"{eag['cohort']}), expected (1, 2) and (0, 0)")
    require(cap["launches"] == eag["launches"],
            f"[{tag}] launches {cap['launches']} != the eager run's "
            f"{eag['launches']}")
    require(same, f"[{tag}] captured and eager final params differ")


def check_staged_stages(repro_torch, dev):
    """The staged path's compression and aggregation stages on the card
    against the same stages on the CPU, bit for bit, on one fixed stacked
    cohort update: phase 4's round-0 cohort of 10 clients (16 rows)
    trained on the card from seed 0.  For STC and int8, two rounds of
    ``compress_stacked`` (the second corrects by the first's residual):
    the sent values, the residual rows, the STC counts and the wire bytes;
    then ``aggregate_stacked`` flat (K1) and hierarchical (the grouped
    K1).  Called by ``tests/test_torch_cuda.py`` too."""
    from repro_torch.core import api
    from repro_torch.core.batched import BatchedExecutor
    from repro_torch.core.rounds import Trainer
    from repro_torch.utils.tree import tree_leaves, tree_map

    repro_torch.reset()
    repro_torch.set_device(dev)
    repro_torch.init(femnist_config("none", "batched"))
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    params = ctx.model.init(torch.Generator().manual_seed(ctx.config.seed),
                            dev)
    clients = [trainer.client(c) for c in trainer.server.selection(
        ctx.fed_data.client_ids, 0)]
    st = trainer.engine.run_cohort_stacked(clients, params, 0)
    cpu = torch.device("cpu")
    for mode in ("stc", "int8"):
        out = []
        for where in (dev, cpu):
            engine = BatchedExecutor(ctx.model, where)
            s = dict(st, updates=tree_map(lambda t: t.to(where),
                                          st["updates"]))
            got = []
            for _ in range(2):
                c = engine.compress_stacked(s, clients, mode, 0.01)
                got += [tree_leaves(c["updates"]),
                        engine._ef.gather([x.client_id for x in clients]),
                        [t for t in c["nnz"] if t is not None],
                        engine.per_client_payload_bytes(c)]
            got += [tree_leaves(engine.aggregate_stacked(
                        c, use_kernel=True)),
                    tree_leaves(engine.aggregate_stacked(
                        c, use_kernel=True, topology="hierarchical"))]
            out.append(got)
        card, host = out
        names = ["sent", "residual", "nnz", "bytes"] * 2 + ["delta flat",
                                                             "delta tree"]
        for name, a, b in zip(names, card, host):
            ok = a == b if name == "bytes" else (
                len(a) == len(b) and same_bits_tree(a, b))
            require(ok, f"staged {mode}: {name} differ between card and CPU")
        print(f"[staged stages {mode}] 10 clients, 2 rounds of "
              f"compress_stacked + aggregate_stacked (flat and tree): card "
              f"= CPU bit for bit (sent, residual, "
              f"{'nnz, ' if mode == 'stc' else ''}bytes, deltas); bytes "
              f"{sum(card[7])}")
    repro_torch.set_device(None)
    repro_torch.reset()


FAULTS_4G = {"dropout_prob": 0.2, "crash_prob": 0.1, "straggler_prob": 0.2,
             "straggler_slowdown": 4.0, "nan_update_prob": 0.1, "seed": 20}
#: phase 4g's faults block (its norm bound included) and final params of
#: each run by tag, for phase 4j
FAULTY = {}


def update_norm_bound(repro_torch, dev):
    """Phase 4g's ``faults.max_update_norm``: 100 x the largest L2 norm of
    a sent update row of phase 4's round-0 cohort (10 clients from seed 0,
    trained on the card; for stc and int8 after the compression stage, each
    with an empty EF store) -> (bound, {mode: largest norm})."""
    from repro_torch.core import api
    from repro_torch.core.batched import BatchedExecutor
    from repro_torch.core.rounds import Trainer
    from repro_torch.utils.tree import tree_leaves

    repro_torch.reset()
    repro_torch.set_device(dev)
    repro_torch.init(femnist_config("none", "batched"))
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    params = ctx.model.init(torch.Generator().manual_seed(ctx.config.seed),
                            dev)
    clients = [trainer.client(c) for c in trainer.server.selection(
        ctx.fed_data.client_ids, 0)]
    st = trainer.engine.run_cohort_stacked(clients, params, 0)
    norms = {}
    for mode in ("none", "stc", "int8"):
        s = st if mode == "none" else BatchedExecutor(
            ctx.model, dev).compress_stacked(st, clients, mode, 0.01)
        flat = torch.cat([t.reshape(t.shape[0], -1)
                          for t in tree_leaves(s["updates"])], 1)
        norms[mode] = float(torch.linalg.vector_norm(
            flat[: len(clients)], dim=1).max())
    repro_torch.set_device(None)
    repro_torch.reset()
    return 100.0 * max(norms.values()), norms


def nested(cfg):
    """``femnist_config``'s flat ``dataset`` key in its section, as
    ``Config.make`` takes it (``init`` folds it itself)."""
    out = {k: v for k, v in cfg.items() if k != "dataset"}
    out["data"] = dict(cfg.get("data", {}), dataset=cfg["dataset"])
    return out


def host_accounting(cfg, rounds, ids):
    """The fault accounting a run of ``cfg`` must report, from the host
    alone: each round's cohort replayed from the selection RNG (``cfg.seed``;
    the cohort re-drawn while fewer than ``min_clients_per_round`` would
    survive dropout and crash) and ``FaultInjector.plan`` of each (client,
    round).  NaN-injected survivors are the only rejections: the norm bound
    sits far above every update."""
    from repro_torch.core.config import Config
    from repro_torch.core.server import Server
    from repro_torch.simulation.heterogeneity import FaultInjector

    c = Config.make(nested(cfg))
    server = Server(None, c)
    inj = FaultInjector(c.faults)
    out = []
    for r in range(rounds):
        sel, resel = server.selection(ids, r), 0
        floor = min(c.faults.min_clients_per_round, len(sel))
        while sum(not inj.plan(x, r).fails for x in sel) < floor:
            resel += 1
            sel = server.selection(ids, r)
        plans = [inj.plan(x, r) for x in sel]
        row = {"clients": len(sel), "reselections": resel,
               "dropped": sum(p.dropout for p in plans),
               "crashed": sum(p.crash for p in plans),
               "straggled": sum(p.straggler for p in plans),
               "rejected": sum(p.nan_update for p in plans),
               "deadline_missed": 0}
        row["survivors"] = (row["clients"] - row["dropped"] - row["crashed"]
                            - row["rejected"])
        out.append(row)
    return out


def run_faults(repro_torch, ops, dev, smi):
    """Phase 4g: phase 4's configuration under ``FAULTS_4G`` (dropout 0.2,
    crash 0.1, straggler 0.2 x 4, NaN uploads 0.1, fixed seed) and a norm
    bound 100x above phase 4's update norms, through ``init``/``run``: (1)
    fused stc, (2) staged int8, (3) hierarchical stc, (4) sequential none,
    each round's accounting equal to the host's replay
    (``host_accounting``), finite params, the fused runs building one
    program and syncing once a round; then (5) ``round_deadline=1e-12``
    (none; the staged path): every client misses, none survives, and the
    params stay bit for bit at their init.  Steady round walls are printed
    against the same mode's run of phase 4, 4e or 4f.  -> the kernels'
    launches over the five runs."""
    from repro_torch.core import batched
    from repro_torch.core.config import Config
    from repro_torch.data.fed_data import build_federated_data
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_leaves

    bound, norms = update_norm_bound(repro_torch, dev)
    print(f"[faults] max_update_norm {bound:.6g} = 100 x the largest update "
          f"norm of phase 4's round-0 cohort (none {norms['none']:.6g}, stc "
          f"{norms['stc']:.6g}, int8 {norms['int8']:.6g}): margin 100x")
    faults = dict(FAULTS_4G, max_update_norm=bound)
    ids = build_federated_data(Config.make(nested(
        femnist_config("none", "batched"))).data).client_ids
    runs = [("faults fused stc", "stc", "batched", {}, "fedavg_agg",
             (1, 1), "stc"),
            ("faults staged int8", "int8", "batched",
             {"round_fusion": "off"}, "fedavg_agg", (3, 1), "staged int8"),
            ("faults hierarchical stc", "stc", "batched",
             {"aggregation_topology": "hierarchical"}, "fedavg_agg_tree",
             (1, 1), "hierarchical stc"),
            ("faults sequential none", "none", "sequential", {},
             "fedavg_agg", None, "sequential none")]
    total = {k: 0 for k in ops.launch_counts()}
    seen = set()
    FAULTY["faults"] = faults
    for tag, mode, execution, res, k1, per_round, base in runs:
        hist = []
        b0 = batched.round_trace_count()
        used, FAULTY[tag] = run_slice(
            repro_torch, ops, mode, execution=execution, resources=res,
            tag=tag, k1=k1, per_round=per_round, faults=faults, history=hist)
        for k, v in used.items():
            total[k] += v
        if per_round == (1, 1):       # fused: one program for every round
            built = batched.round_trace_count() - b0
            require(built == 1, f"[{tag}] {built} round programs built, "
                    f"expected 1 (a fault pattern is a tensor input)")
        cfg = femnist_config(mode, execution)
        cfg["resources"].update(res)
        cfg["faults"] = faults
        want = host_accounting(cfg, 3, ids)
        got = [{k: h[k] for k in want[0]} for h in hist]
        print(f"[{tag}] accounting per round {got}")
        require(got == want, f"[{tag}] fault accounting {got} != the host's "
                f"plans {want}")
        steady = np.mean(WALLS[tag]) / np.mean(WALLS[base])
        print(f"[{tag}] steady round walls {WALLS[tag]} s against "
              f"{WALLS[base]} s of the fault-free {base} run: x{steady:.4f} "
              f"({smi})")
        seen |= {k for h in got for k in ("dropped", "crashed", "straggled",
                                          "rejected", "reselections") if h[k]}
    print(f"[faults] fault kinds seen over the four runs: {sorted(seen)}")
    require({"dropped", "crashed", "straggled", "rejected"} <= seen,
            f"[faults] a fault kind never occurred: {sorted(seen)}")

    tag = "faults deadline 1e-12"
    hist = []
    init = [t.cpu() for t in tree_leaves(femnist_cnn().init(
        torch.Generator().manual_seed(Config().seed), dev))]
    used, params = run_slice(repro_torch, ops, "none",
                             resources={"round_deadline": 1e-12}, tag=tag,
                             per_round=(2, 1), history=hist)
    for k, v in used.items():
        total[k] += v
    require(all(h["deadline_missed"] == h["clients"] and h["survivors"] == 0
                for h in hist), f"[{tag}] some client met the deadline")
    require(same_bits_tree(params, init),
            f"[{tag}] params moved without survivors")
    print(f"[{tag}] every client missed every round, no survivor; params "
          f"bit for bit at their init")
    out = {k: total[k] for k in ("fedavg_agg", "fedavg_agg_tree",
                                 "stc_batched", "int8_rowmax", "int8_qdq")}
    print(f"[faults] launches of phase 4g: {out} ({smi})")
    return out


#: phase 4p: each captured run of phases 4, 4f and 4g beside its eager
#: twin: (tag of the captured run, mode, run_slice keywords)
CAPTURE_CASES = [
    ("none", "none", {}), ("stc", "stc", {}), ("int8", "int8", {}),
    ("hierarchical stc", "stc",
     {"resources": {"aggregation_topology": "hierarchical"},
      "k1": "fedavg_agg_tree"}),
    ("faults fused stc", "stc", {}),
    ("deferred int8", "int8", {"tracking": {"round_sync": False}}),
]


@contextlib.contextmanager
def eager_rounds():
    """Every ``BatchedExecutor`` made inside runs its fused rounds eagerly
    (its ``capture=False``): the eager side of phase 4p's A/B."""
    from repro_torch.core import batched

    init = batched.BatchedExecutor.__init__
    batched.BatchedExecutor.__init__ = functools.partialmethod(
        init, capture=False)
    try:
        yield
    finally:
        batched.BatchedExecutor.__init__ = init


def ef_growth_rounds(repro_torch, capture):
    """Phase 4p's EF-growth case: phase 4's fused stc round through one
    executor, femnist clients 0-9 twice (the eager warm-up, the capture),
    then 10-19 (the store grows from 16 to 32 rows: new storage, a
    recapture) and 20-29 (it fits: a replay).  -> (final params on the
    CPU, captures, replays)."""
    from repro_torch.core import api, batched
    from repro_torch.core.rounds import Trainer
    from repro_torch.utils.tree import tree_leaves

    repro_torch.reset()
    repro_torch.set_device(None)
    repro_torch.init(femnist_config("stc", "batched"))
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    engine = batched.BatchedExecutor(ctx.model, trainer.device,
                                     capture=capture)
    ids = ctx.fed_data.client_ids
    params = ctx.model.init(torch.Generator().manual_seed(ctx.config.seed),
                            trainer.device)
    n0 = batched.round_capture_count(), batched.round_replay_count()
    allocs = []
    for r, lo in enumerate((0, 0, 10, 20)):
        cohort = [trainer.client(c) for c in ids[lo:lo + 10]]
        _, params, _ = engine.run_round_fused(
            cohort, params, r, method="stc",
            stc_sparsity=ctx.config.client.stc_sparsity, use_kernel=True)
        allocs.append(engine._ef.alloc)
    torch.cuda.synchronize()
    out = [t.cpu() for t in tree_leaves(params)]
    counts = (batched.round_capture_count() - n0[0],
              batched.round_replay_count() - n0[1])
    require(allocs == [16, 16, 32, 32], f"[EF growth] store rows {allocs}, "
            f"expected [16, 16, 32, 32]")
    repro_torch.reset()
    return out, counts


def run_captured(repro_torch, ops, smi, gaps, init):
    """Phase 4p: the fused round as one CUDA graph a bucket.  Each captured
    run of phases 4, 4f and 4g (``CAPTURE_CASES``: fused none / stc /
    int8, hierarchical stc, faulty stc, deferred int8; 3 rounds) beside
    its eager twin (``eager_rounds``): captures, recaptures and replays,
    dispatches and host syncs a round (``run_slice`` holds them to 1 / 1),
    launches counted through the replays (equal to the eager run's), round
    walls and main-thread CPU seconds of rounds 1-2, and peak GiB; final
    params within max(1e-4, 2 x the mode's 1e-7-perturbed reach), as in
    4e and 4f.  Then the EF-growth case (``ef_growth_rounds``: one
    recapture, within the same bar of its eager twin) and
    ``check_contracts()`` on the card.  Bit-for-bit equality of captured
    and eager rounds is checked in the deterministic ``--resume-check``
    child.  -> the faulty run's reach, for phase 4j."""
    from repro_torch.analysis.contracts import check_contracts

    gaps["faults stc"] = conditioning_gap(
        repro_torch, dict(femnist_config("stc", "batched"),
                          faults=FAULTY["faults"]),
        init, FAULTY["faults fused stc"], seeds=(1, 2))
    for tag, mode, kw in CAPTURE_CASES:
        kw = dict(kw)
        if tag.startswith("faults"):
            kw["faults"] = FAULTY["faults"]
        eager = f"eager {tag}"
        with eager_rounds():
            run_slice(repro_torch, ops, mode, tag=eager, **kw)
        cap, eag = RUNS[tag], RUNS[eager]
        require((cap["captures"], cap["replays"]) == (1, 2),
                f"[{tag}] {cap['captures']} capture(s), {cap['replays']} "
                f"replay(s) in 3 rounds, expected 1 and 2")
        require((eag["captures"], eag["replays"]) == (0, 0),
                f"[{eager}] captured {eag['captures']} times")
        require(cap["launches"] == eag["launches"],
                f"[{tag}] launches {cap['launches']} != the eager run's "
                f"{eag['launches']}")
        gap = gaps["faults stc" if tag.startswith("faults") else mode]
        diff = max_diff(cap["params"], eag["params"])
        bar = max(1e-4, 2 * gap)
        print(f"[captured {tag}] 1 capture, 0 recaptures, 2 replays (rounds "
              f"1-2), 1 dispatch and 1 host sync a round; round walls 1-2 "
              f"{[round(x, 4) for x in WALLS[tag]]} s captured, "
              f"{[round(x, 4) for x in WALLS[eager]]} s eager; main-thread "
              f"CPU s of rounds 1-2 {cap['cpu']} / {eag['cpu']}; peak "
              f"{cap['peak']:.2f} / {eag['peak']:.2f} GiB; final params max "
              f"|diff| {diff:.4g}, reach {gap:.4g}, bar {bar:.4g} ({smi})")
        require(diff <= bar, f"[{tag}] captured vs eager {diff} > {bar}")

    got, counts = ef_growth_rounds(repro_torch, True)
    want, eager_counts = ef_growth_rounds(repro_torch, False)
    diff = max_diff(got, want)
    bar = max(1e-4, 2 * gaps["stc"])
    print(f"[captured EF growth] captures, replays {counts} (eager "
          f"{eager_counts}): the store's growth at round 2 recaptured once; "
          f"final params vs eager max |diff| {diff:.4g}, bar {bar:.4g}")
    require(counts == (2, 3) and eager_counts == (0, 0),
            f"[EF growth] captures, replays {counts}, expected (2, 3)")
    require(diff <= bar, f"[EF growth] captured vs eager {diff} > {bar}")

    repro_torch.set_device(None)
    report = check_contracts()
    print(report.format())
    require(report.ok, "check_contracts() failed on the card")
    return gaps["faults stc"]


def run_models(repro_torch, ops, smi):
    """Phase 4h: the paper's other two models at their published widths on
    their datasets' defaults (``model_config``): ``shakespeare_lstm``
    (embed 8, 2 x LSTM 256, vocab 80, sequences of 80) and
    ``cifar_resnet18`` (11.2 M parameters), each batched fused under none
    and stc and sequential under none (3 rounds of 10 clients, launch
    counts as phase 4's), then the batched run on the card against the CPU
    at phase 5's bar (``card_vs_cpu``).  -> K1-K3's launches over the six
    runs."""
    import functools

    from repro_torch.data import synthetic

    # each init builds its federation from the generator: generate each
    # dataset once for the phase (12,000 Markov sequences take ~10 s)
    for name in M3_MODELS.values():
        synthetic.DATASETS[name] = functools.lru_cache(maxsize=None)(
            synthetic.DATASETS[name])
    total = {k: 0 for k in ops.launch_counts()}
    for model in M3_MODELS:
        for mode, execution in (("none", "batched"), ("stc", "batched"),
                                ("none", "sequential")):
            tag = (f"{model} {mode}" if execution == "batched"
                   else f"{model} sequential {mode}")
            if model == "shakespeare_lstm" and execution == "sequential":
                # the launch-bound step loop, captured against eager
                used, _ = sequential_ab(repro_torch, ops, smi, model)
            else:
                used, _ = run_slice(repro_torch, ops, mode,
                                    execution=execution, tag=tag,
                                    model=model)
            for k, v in used.items():
                total[k] += v
        if model == "shakespeare_lstm":
            # the launch-bound step loop, captured and eager in one call
            eager = f"{model} eager none"
            with eager_rounds():
                run_slice(repro_torch, ops, "none", tag=eager, model=model)
            print(f"[{model}] batched none, rounds 1-2 (capture, replay): "
                  f"{WALLS[f'{model} none']} s and main-thread CPU "
                  f"{RUNS[f'{model} none']['cpu']} s captured, "
                  f"{WALLS[eager]} s and {RUNS[eager]['cpu']} s eager "
                  f"({smi})")
        print(f"[{model}] steady round walls s (rounds 1-2): "
              + "; ".join(f"{t}: {WALLS[t]}" for t in WALLS
                          if t.startswith(model)) + f" ({smi})")
        card_vs_cpu(repro_torch, "batched", model=model)
    out = {k: total[k] for k in ("fedavg_agg", "stc_batched", "int8_rowmax",
                                 "int8_qdq")}
    print(f"[models] launches of phase 4h: {out} ({smi})")
    return out


#: phase 4i: FedBuff on femnist_cnn, K 5 of 10 in flight, K1 on
ASYNC_4I = {"execution": "async", "buffer_size": 5, "max_concurrency": 10,
            "aggregation_kernel": True}


def async_trainer(repro_torch, mode, rounds=6, resources=None,
                  server_cls=None, faults=None, ckpt=None,
                  speeds=(1.0, 4.0)):
    """Phase 4i's trainer: ``init`` with phase 4's femnist configuration
    under ``ASYNC_4I``, then the ``Trainer`` ``run()`` would build, with
    ``server_cls`` as ``register_server`` would give it and, under
    ``speeds``, the device classes pinned alternately over the sorted
    clients (the hash-based assignment is process-randomized)."""
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.core.server import Server

    cfg = femnist_config(mode, "async", rounds)
    cfg["resources"].update(ASYNC_4I, **(resources or {}))
    cfg["system_heterogeneity"] = {"enabled": speeds is not None}
    if faults:
        cfg["faults"] = faults
    if ckpt:
        cfg["checkpoint"] = ckpt
    repro_torch.reset()
    repro_torch.set_device(None)
    repro_torch.init(cfg)
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker,
                      server=(server_cls or Server)(ctx.model, ctx.config,
                                                    ctx.fed_data.test))
    for i, cid in enumerate(sorted(ctx.fed_data.client_ids)):
        if speeds is not None:
            trainer.het.assignment[cid] = speeds[i % len(speeds)]
    return trainer


def run_async_case(ops, trainer, tag, mode, smi, resume_step=None):
    """One phase-4i run (``trainer.run()``, or ``resume(step)``) with the
    launch counters set to 0 just before and read just after -> (launches,
    history, final params on the CPU)."""
    from repro_torch.core import batched
    from repro_torch.utils.tree import tree_leaves

    waves = []
    orig = trainer._run_batched

    def spy(selected, payload, round_id, **kw):
        waves.append(len(selected))
        return orig(selected, payload, round_id, **kw)

    trainer._run_batched = spy
    b0 = batched.round_trace_count()
    n0 = batched.cohort_capture_count(), batched.cohort_replay_count()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = (trainer.run() if resume_step is None
           else trainer.resume(step=resume_step))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    used = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    hist = res["history"]
    new = len(hist) - (resume_step or 0)
    want = {"none": (), "stc": ("stc_batched",),
            "int8": ("int8_rowmax", "int8_qdq")}[mode]
    print(f"[{tag}] launches {used}")
    require(used["fedavg_agg"] == new, f"[{tag}] K1 launched "
            f"{used['fedavg_agg']} times for {new} aggregations")
    for k in ("fedavg_agg_tree", "stc_batched", "int8_rowmax", "int8_qdq"):
        require((used[k] > 0) == (k in want), f"[{tag}] {k} launched "
                f"{used[k]} times under {mode}")
    require(batched.round_trace_count() == b0,
            f"[{tag}] an async wave built a fused round program")
    out = [t.cpu() for t in tree_leaves(res["params"])]
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"[{tag}] non-finite params")
    require(all(math.isfinite(h["train_loss"]) and math.isfinite(h["loss"])
                for h in hist), f"[{tag}] non-finite loss")
    buckets = sorted({batched.bucket_pow2(n) for n in waves})
    print(f"[{tag}] {len(hist)} aggregations ({new} in this call); "
          f"{len(waves)} waves of {waves} clients, buckets {buckets}; 0 "
          f"round programs built (waves train on the staged path); cohort "
          f"program {batched.cohort_capture_count() - n0[0]} capture(s), "
          f"{batched.cohort_replay_count() - n0[1]} replays; "
          f"staleness mean {[h['staleness_mean'] for h in hist[-new:]]} "
          f"max {[h['staleness_max'] for h in hist[-new:]]}; virtual time "
          f"{hist[-1]['virtual_time']:.4g} s")
    walls = [h["wall_time"] for h in hist[-new:]]
    print(f"[{tag}] wall per aggregation s: {[round(w, 4) for w in walls]}"
          f" (first carries first use); run total {total:.3f} s; peak "
          f"device memory {peak:.2f} GiB above the {held:.2f} GiB held "
          f"before the run ({smi})")
    return used, hist, out


@contextlib.contextmanager
def pinned_wall():
    """Every cohort's measured training time (``run_cohort_stacked``'s
    ``st["wall"]``) pinned to 1e-4 s a local step inside, as
    ``tests/test_torch_async.py::_pin_wall`` pins it: the async engine's
    virtual clock no longer reads the host's clock, so two runs see the
    same waves."""
    from repro_torch.core import batched

    orig = batched.BatchedExecutor.run_cohort_stacked

    def fixed_wall(self, clients, params, round_id):
        st = orig(self, clients, params, round_id)
        st["wall"] = float(st["n_steps"].sum()) * 1e-4
        return st

    batched.BatchedExecutor.run_cohort_stacked = fixed_wall
    try:
        yield
    finally:
        batched.BatchedExecutor.run_cohort_stacked = orig


def async_ab(repro_torch, ops, smi):
    """Phase 4i: run (a)'s configuration (stc, 1x / 4x speeds) with the
    wall pinned (:func:`pinned_wall`) and cuDNN deterministic, its waves'
    cohort programs captured (one CUDA graph a bucket, one pool) and in
    an eager twin (``eager_rounds``): final params, virtual clocks and
    staleness bit for bit, 1 capture a bucket and 0 recaptures; wall per
    aggregation and main-thread CPU s a wave of both."""
    from repro_torch.core import batched

    out = {}
    with deterministic_cudnn(), pinned_wall():
        for captured in (True, False):
            tag = f"async stc pinned {'captured' if captured else 'eager'}"
            with (contextlib.nullcontext() if captured else eager_rounds()):
                trainer = async_trainer(repro_torch, "stc")
            n0 = (batched.cohort_capture_count(),
                  batched.cohort_replay_count())
            cpu0 = time.thread_time()
            used, hist, params = run_async_case(ops, trainer, tag, "stc",
                                                smi)
            cpu = time.thread_time() - cpu0
            counts = (batched.cohort_capture_count() - n0[0],
                      batched.cohort_replay_count() - n0[1])
            out[captured] = (hist, params, counts, cpu, len(
                trainer.engine._cohorts), len(trainer.engine._warm), used)
            del trainer
    (hist, params, counts, cpu, keys, warm, used), \
        (ehist, eparams, ecounts, ecpu, _, _, eused) = out[True], out[False]
    same = same_bits_tree(params, eparams)
    clocks = [h["virtual_time"] for h in hist] == \
        [h["virtual_time"] for h in ehist]
    print(f"[async stc pinned] cohort program: {counts[0]} capture(s) over "
          f"{keys} buckets ({warm} warmed up), {counts[1]} replays (eager "
          f"twin {ecounts}); wall per aggregation s "
          f"{[round(h['wall_time'], 4) for h in hist]} captured, "
          f"{[round(h['wall_time'], 4) for h in ehist]} eager; main-thread "
          f"CPU s of the run {cpu:.3f} / {ecpu:.3f}; final params bit for "
          f"bit the eager twin's: {same}; virtual clocks equal: {clocks} "
          f"({smi})")
    require(counts[0] == keys and keys >= 1 and ecounts == (0, 0)
            and counts[1] > 0, f"[async stc pinned] captures, replays "
                               f"{counts} over {keys} buckets, eager "
                               f"{ecounts}")
    require(used == eused, f"[async stc pinned] launches {used} != the "
            f"eager twin's {eused}")
    require(same and clocks, "[async stc pinned] captured and eager runs "
            "differ")


def run_async(repro_torch, ops, smi, fused, gaps, init):
    """Phase 4i: the async engine on phase 4's femnist configuration,
    ``ASYNC_4I`` (K 5, 10 in flight, 6 aggregations, speeds 1x / 4x
    alternating): (a) stc with a checkpoint every 2 aggregations, (b) its
    resume from step 2 in a fresh trainer (6 aggregations, the first 2
    history entries verbatim), (c) ``FedBuffServer`` under int8, (d) stc
    under ``FAULTS_4G`` with retries, (e) the degenerate case (K = in
    flight = 10 a wave, uniform speeds, 3 aggregations) against phase 4's
    fused stc run at phase 5's bar.  -> K1-K3's launches over the five
    runs."""
    import shutil
    import tempfile

    from repro_torch.core.strategies import FedBuffServer

    total = {k: 0 for k in ops.launch_counts()}

    def add(used):
        for k, v in used.items():
            total[k] += v

    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        ck = {"every": 2, "dir": ck_dir}
        used, hist_a, _ = run_async_case(
            ops, async_trainer(repro_torch, "stc", ckpt=ck), "async stc",
            "stc", smi)
        add(used)
        require(max(h["staleness_max"] for h in hist_a) > 0,
                "[async stc] 1x / 4x speeds gave no stale update")
        used, hist_b, _ = run_async_case(
            ops, async_trainer(repro_torch, "stc", ckpt=ck),
            "async stc resume", "stc", smi, resume_step=2)
        add(used)
        require(len(hist_b) == 6 and hist_b[:2] == hist_a[:2],
                "[async stc resume] history after resume from step 2")
        print("[async stc resume] 6 aggregations, history[:2] verbatim")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    used, _, _ = run_async_case(
        ops, async_trainer(repro_torch, "int8", server_cls=FedBuffServer),
        "async fedbuff int8", "int8", smi)
    add(used)

    used, hist, _ = run_async_case(
        ops, async_trainer(repro_torch, "stc", faults=FAULTS_4G),
        "async faults stc", "stc", smi)
    add(used)
    counts = {k: sum(h[k] for h in hist) for k in (
        "dropped", "crashed", "straggled", "rejected", "retried", "gave_up")}
    print(f"[async faults stc] over 6 aggregations: {counts}")
    require(counts["retried"] > 0 and counts["dropped"] + counts["crashed"]
            + counts["rejected"] > 0, "[async faults stc] no failure retried")

    async_ab(repro_torch, ops, smi)

    used, _, params = run_async_case(
        ops, async_trainer(repro_torch, "stc", rounds=3, speeds=None,
                           resources={"buffer_size": 10}),
        "async degenerate stc", "stc", smi)
    add(used)
    diff = max_diff(params, fused["stc"])
    bar = max(1e-4, 2 * gaps["stc"])
    print(f"[async degenerate stc] final params vs phase 4's fused stc: max "
          f"|diff| {diff:.4g} ({'within' if diff <= 1e-4 else 'above'} "
          f"1e-4); phase 4's stc run from 1e-7-perturbed inits moves up to "
          f"{gaps['stc']:.4g}; bar max(1e-4, 2 x that) = {bar:.4g}")
    require(diff <= bar, f"[async degenerate stc] vs fused stc: {diff} > "
            f"{bar}")
    repro_torch.reset()
    out = {k: total[k] for k in ("fedavg_agg", "stc_batched", "int8_rowmax",
                                 "int8_qdq")}
    print(f"[async] launches of phase 4i: {out} ({smi})")
    return out


# ---------------------------------------------------------------------------
SHARDED_ROUTES = ("fedavg_agg", "fedavg_agg_tree", "stc_batched",
                  "int8_rowmax", "int8_qdq")


def run_sharded(repro_torch, ops, smi, fused, gaps, init):
    """Phase 4j: the sharded cohort (``resources.distributed="data"``) on
    phase 4's femnist configuration.  (a) the default devices (the one
    card: 1 shard), fused none / stc / int8; (b) ``set_devices([cuda:0] *
    k)`` for k = 2 and 4: fused stc, hierarchical stc at
    ``aggregation_fanout=2``, staged int8, fused stc under phase 4g's
    faults, and fused stc at 20 clients a round (bucket 32) beside an
    unsharded run of it.  Each run's final params against the unsharded
    run of its mode, printed against 1e-4 and held within max(1e-4, 2 x
    that unsharded run's 1e-7-perturbed reach); its steady round walls
    beside the unsharded run's.  K1 launches once (flat, or one tier of
    the tree) a card a round, for all its shards; K2 / K3 once a
    compressed leaf a shard a round.  -> the launches of the phase."""
    total = {k: 0 for k in SHARDED_ROUTES}
    faults = FAULTY["faults"]

    def run(tag, mode, vs, walls, base, reach, shards, **kw):
        used, params = run_slice(
            repro_torch, ops, mode, tag=tag, shards=shards,
            resources=dict(kw.pop("resources", {}), distributed="data"),
            **kw)
        for k in SHARDED_ROUTES:
            total[k] += used[k]
        leaves = 3 * shards * sum(          # rounds x shards x leaves
            1 for _, size in femnist_shapes() if size >= 64)
        for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
            require(used[k] in (0, leaves), f"[{tag}] {k} launched "
                    f"{used[k]} times, expected {leaves} or 0")
        diff = max_diff(params, base)
        bar = max(1e-4, 2 * reach)
        print(f"[{tag}] final params vs the unsharded {vs}: max |diff| "
              f"{diff:.4g} ({'within' if diff <= 1e-4 else 'above'} 1e-4); "
              f"that run from 1e-7-perturbed inits moves up to {reach:.4g}; "
              f"bar {bar:.4g}; steady round walls {WALLS[tag]} s against "
              f"{WALLS[walls]} s of the unsharded {walls} run ({smi})")
        require(diff <= bar, f"[{tag}] vs unsharded: {diff} > {bar}")

    repro_torch.set_devices(None)        # the default: every CUDA device
    require(repro_torch.get_devices() == [torch.device("cuda", 0)],
            f"default devices {repro_torch.get_devices()}")
    for mode in ("none", "stc", "int8"):
        run(f"sharded 1 {mode}", mode, f"fused {mode} run of phase 4", mode,
            fused[mode], gaps[mode], 1)

    tag20 = "stc 20 clients"
    _, base20 = run_slice(repro_torch, ops, "stc", tag=tag20, clients=20)
    reach20 = conditioning_gap(
        repro_torch, femnist_config("stc", "batched", clients=20), init,
        base20, seeds=(1, 2))
    base_faulty = FAULTY["faults fused stc"]
    reach_faulty = gaps["faults stc"]          # phase 4p's
    try:
        for k in (2, 4):
            repro_torch.set_devices([torch.device("cuda", 0)] * k)
            p4 = "fused stc run of phase 4"
            run(f"sharded {k} stc", "stc", p4, "stc", fused["stc"],
                gaps["stc"], k)
            run(f"sharded {k} hierarchical stc fanout 2", "stc", p4,
                "hierarchical stc", fused["stc"], gaps["stc"], k,
                resources={"aggregation_topology": "hierarchical",
                           "aggregation_fanout": 2}, k1="fedavg_agg_tree")
            run(f"sharded {k} staged int8", "int8",
                "fused int8 run of phase 4", "staged int8", fused["int8"],
                gaps["int8"], k, resources={"round_fusion": "off"},
                per_round=(3, 1))
            run(f"sharded {k} faults stc", "stc",
                "faults fused stc run of phase 4g", "faults fused stc",
                base_faulty, reach_faulty, k, faults=faults)
            run(f"sharded {k} stc 20 clients", "stc", f"{tag20} run", tag20,
                base20, reach20, k, clients=20)
    finally:
        repro_torch.set_devices(None)
    print(f"[sharded] launches of phase 4j (a) and (b): {total} ({smi})")
    return total


def check_sharded_routes(dev, fedavg_agg, stc_topk, quant, smi):
    """Phase 4j (c): the sharded routes of K1-K3 at the whole femnist update
    matrix (16, 6,603,710) f32 over k = 2 and 4 shards of the one card,
    against the unsharded kernels: K2 (out, nnz) and K3 (sent, scale) bit
    for bit, K1 at fanout 0 and 2 within 1e-6 relative of flat K1, given
    the whole matrix or its k row blocks.  Each route timed on the row
    blocks, as the round calls it (median of CUDA events, through the
    wrapper; the whole-matrix form adds the gather of the results), beside
    its plain version and the unsharded kernel (K1 also by graph ms;
    ``scripts/bench_kernels.py --kernel fedavg`` gives device ms), and
    bounded: K1's flat bytes (one launch for the card's k shards: no
    partial crosses a card); K2 / K3 those of the unsharded call."""
    from repro_torch.core.batched import build_client_mesh

    gen = torch.Generator(device=dev).manual_seed(4321)
    n, d = N_BUCKET, sum(s for _, s in femnist_shapes())
    x = update_rows(gen, n, d)
    w = torch.rand((n,), generator=gen, device=dev)
    w /= w.sum()
    flat = fedavg_agg.fedavg_aggregate(x, w)
    so, sn = stc_topk.stc_compress_batched(x, 0.01)
    qs, qsc = quant.int8_roundtrip_batched(x)
    base_ms = {"fedavg_agg": cuda_ms(lambda: fedavg_agg.fedavg_aggregate(x, w)),
               "fedavg_agg graph": graph_ms(
                   lambda: fedavg_agg.fedavg_aggregate(x, w)),
               "stc": cuda_ms(lambda: stc_topk.stc_compress_batched(x, 0.01)),
               "int8": cuda_ms(lambda: quant.int8_roundtrip_batched(x))}
    stc_b = stc_bound(x, stc_topk)
    int8_b = bound(4 * n * d + 4 * n + 8 * n * d + 4 * n, 7 * n * d)
    rows = []
    for k in (2, 4):
        mesh = build_client_mesh([dev] * k)
        blocks = list(x.chunk(k))      # the round's row blocks, one a shard
        for fanout in (0, 2):
            out = fedavg_agg.fedavg_aggregate_sharded(x, w, mesh,
                                                      fanout=fanout)
            require(torch.equal(out, fedavg_agg.fedavg_aggregate_sharded(
                blocks, w, mesh, fanout=fanout)), f"K1 sharded k={k}: "
                f"row blocks and the whole matrix differ")
            torch.cuda.synchronize()
            rel = ((out - flat).abs().max()
                   / flat.abs().max().clamp_min(1e-30)).item()
            require(rel <= 1e-6, f"K1 sharded k={k} fanout {fanout}: rel "
                    f"{rel} > 1e-6 from flat K1")
            # one launch for the card's k shards: flat K1's bytes, no
            # partial crosses a card
            b, by = bound(4 * n * d + 4 * n + 4 * d, 2 * n * d)

            def route():
                return fedavg_agg.fedavg_aggregate_sharded(
                    blocks, w, mesh, fanout=fanout)
            rows.append(dict(
                route=f"K1 sharded k={k} fanout {fanout}", rel=rel,
                ms=cuda_ms(route), graph_ms=graph_ms(route),
                plain_ms=cuda_ms(lambda: fedavg_agg.fedavg_sharded_plain(
                    x, w, k, fanout)),
                unsharded_ms=base_ms["fedavg_agg"], bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: w @ x)))
        o, nn = stc_topk.stc_compress_batched_sharded(x, 0.01, mesh)
        s, sc = quant.int8_roundtrip_batched_sharded(x, mesh)
        lo, ln = stc_topk.stc_compress_batched_sharded(blocks, 0.01, mesh)
        ls, lsc = quant.int8_roundtrip_batched_sharded(blocks, mesh)
        torch.cuda.synchronize()
        require(same_bits_tree([o, nn, s, sc], [so, sn, qs, qsc])
                and same_bits_tree([torch.cat(t) for t in (lo, ln, ls, lsc)],
                                   [so, sn, qs, qsc]),
                f"K2/K3 sharded k={k}: not bit for bit the unsharded kernels")
        rows.append(dict(
            route=f"K2 sharded k={k}", rel=0.0,
            ms=cuda_ms(lambda: stc_topk.stc_compress_batched_sharded(
                blocks, 0.01, mesh)),
            plain_ms=cuda_ms(lambda: [stc_topk.stc_plain(p, 0.01)
                                      for p in x.chunk(k)], reps=3),
            unsharded_ms=base_ms["stc"], bound_ms=stc_b[0],
            bound_by=stc_b[1], library_ms=None))
        rows.append(dict(
            route=f"K3 sharded k={k}", rel=0.0,
            ms=cuda_ms(lambda: quant.int8_roundtrip_batched_sharded(
                blocks, mesh)),
            plain_ms=cuda_ms(lambda: [
                quant.qdq_plain(p, quant.int8_scale(quant.rowmax_plain(p)))
                for p in x.chunk(k)]),
            unsharded_ms=base_ms["int8"], bound_ms=int8_b[0],
            bound_by=int8_b[1], library_ms=None))
    for r in rows:
        print(f"{r['route']} ({n}, {d}): route {r['ms']:.4f} ms"
              + (f" (graph {r['graph_ms']:.4f})" if "graph_ms" in r else "")
              + f", plain {r['plain_ms']:.4f} ms, unsharded kernel "
              f"{r['unsharded_ms']:.4f} ms, library "
              f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{'bitwise' if r['rel'] == 0.0 else format(r['rel'], '.3g') + ' rel'}"
              f" against the unsharded kernel ({smi})")
    print(f"flat K1 beside the K1 rows: graph {base_ms['fedavg_agg graph']:.4f}"
          f" ms ({smi})")
    return rows


def check_resume(smi):
    """Phase 4g's deterministic half, in a child process
    (``chip_smoke.py --resume-check``) that sets
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, ``torch.use_deterministic_algorithms
    (True)`` and ``cudnn.deterministic``: an all-zero ``faults`` block
    against no block (bit for bit, same counters and launches), captured
    rounds against eager ones (phase 4p's bit-for-bit rule), and
    kill-and-resume (``resume_check``)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--resume-check"], capture_output=True, text=True,
                         env=env, timeout=600)
    print(out.stdout, end="")
    if out.returncode != 0:
        print(out.stderr[-8000:], file=sys.stderr)
    require(out.returncode == 0, f"--resume-check exited {out.returncode}")
    print(f"[resume] child process took {time.perf_counter() - t0:.1f} s "
          f"({smi})")


def resume_check():
    """The child of :func:`check_resume`, deterministic throughout.

    (a) Phase 4's fused stc configuration with no ``faults`` block and with
    an all-zero one: params bit for bit, the same program builds,
    dispatches, host syncs and launches; fused none / stc / int8 rounds
    captured (the default on the card) and eager (``eager_rounds``), and
    the EF-growth case (``ef_growth_rounds``) both ways: bit for bit, with
    the same counters.  (b) Kill-and-resume for fused
    stc with dropout and sequential int8 with crashes, the EF store's device
    tier cut to 8 rows (some rows sit on the host tier when saved): run A
    trains 3 rounds through ``init``/``run`` with a checkpoint every round;
    run B trains 2 rounds and saves; a fresh ``Trainer`` resumes B.  A's and
    the resumed run's final params and step-3 checkpoints must be equal bit
    for bit.  Prints the step-2 checkpoint's bytes and its save and load
    seconds."""
    import shutil

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.checkpoint import store
    from repro_torch.core import api, batched
    from repro_torch.core.batched import BatchedExecutor
    from repro_torch.core.rounds import Trainer
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    quiet = {"tracking": {"enabled": False}}

    def counted_run(cfg):
        repro_torch.reset()
        repro_torch.init(cfg)
        ops.reset_launch_counts()
        n0 = (batched.round_trace_count(), batched.dispatch_count(),
              batched.host_sync_count())
        res = repro_torch.run()
        torch.cuda.synchronize()
        n1 = (batched.round_trace_count(), batched.dispatch_count(),
              batched.host_sync_count())
        return ([t.cpu() for t in tree_leaves(res["params"])],
                [b - a for a, b in zip(n0, n1)], ops.launch_counts())

    cfg = dict(femnist_config("stc", "batched"), **quiet)
    p0, n0, l0 = counted_run(cfg)
    p1, n1, l1 = counted_run(dict(cfg, faults={
        "dropout_prob": 0.0, "crash_prob": 0.0, "straggler_prob": 0.0,
        "nan_update_prob": 0.0, "max_update_norm": 0.0, "seed": 7}))
    require(same_bits_tree(p0, p1), "all-zero faults block: params differ "
            "from the run with no faults block")
    require(n0 == n1 and l0 == l1, f"all-zero faults block: builds, "
            f"dispatches, syncs {n1} launches {l1} != {n0} {l0}")
    print(f"[resume] fused stc, deterministic: an all-zero faults block = "
          f"no faults block bit for bit; builds, dispatches, host syncs "
          f"{n0}; launches {l0}")
    # phase 4p's bit-for-bit rule: a captured round is the eager round
    for mode in ("none", "stc", "int8"):
        mcfg = dict(femnist_config(mode, "batched"), **quiet)
        got = (p0, n0, l0) if mode == "stc" else counted_run(mcfg)
        with eager_rounds():
            want = counted_run(mcfg)
        require(same_bits_tree(got[0], want[0]) and got[1:] == want[1:],
                f"[captured {mode}] captured and eager rounds differ: "
                f"{got[1:]} vs {want[1:]}")
    got, counts = ef_growth_rounds(repro_torch, True)
    want, _ = ef_growth_rounds(repro_torch, False)
    require(same_bits_tree(got, want) and counts == (2, 3),
            f"[captured EF growth] differs from eager ({counts})")
    print("[captured] fused none / stc / int8 and the EF-growth case, "
          "deterministic: captured = eager bit for bit, with the same "
          "builds, dispatches, host syncs and launches")
    # phase 4j's k = 1 rule: the sharded cohort on the default devices
    # (the one card, 1 shard) is the unsharded run bit for bit
    repro_torch.set_devices(None)
    p2, n2, l2 = counted_run(dict(cfg, resources=dict(
        cfg["resources"], distributed="data")))
    require(len(repro_torch.get_devices()) == 1, "more than one card")
    require(same_bits_tree(p0, p2), "distributed='data' on 1 shard: params "
            "differ from the unsharded run")
    require(n0 == n2 and l0 == l2, f"distributed='data' on 1 shard: builds, "
            f"dispatches, syncs {n2} launches {l2} != {n0} {l0}")
    print(f"[sharded 1] fused stc, deterministic: distributed='data' on the "
          f"default devices (1 shard) = unsharded bit for bit; builds, "
          f"dispatches, host syncs {n2}; launches equal")

    BatchedExecutor.EF_MAX_CLIENTS = 8
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    cases = [("fused stc, dropout", "batched", "stc",
              {"dropout_prob": 0.3, "seed": 5}),
             ("sequential int8, crash", "sequential", "int8",
              {"crash_prob": 0.3, "seed": 2})]
    try:
        for tag, execution, mode, faults in cases:
            shutil.rmtree(root, ignore_errors=True)
            base = dict(femnist_config(mode, execution, rounds=3),
                        faults=faults, **quiet)

            def config(name):
                return dict(base, checkpoint={
                    "every": 1, "dir": os.path.join(root, name)})

            repro_torch.reset()
            repro_torch.init(config("A"))
            ra = repro_torch.run()
            repro_torch.reset()
            repro_torch.init(config("B"))
            ctx = api._ctx
            tb = Trainer(ctx.config, ctx.model, ctx.fed_data,
                         tracker=ctx.tracker)
            tb.server.params = ctx.model.init(
                torch.Generator().manual_seed(ctx.config.seed), tb.device)
            for r in range(2):                 # ... killed after round 2
                tb.run_round(r)
            t0 = time.perf_counter()
            tb.save_checkpoint(2)
            save_s = time.perf_counter() - t0
            spilled = (len(tb.engine._ef.spilled_ids())
                       if tb.engine is not None else 0)
            nbytes = os.path.getsize(store._path(config("B")["checkpoint"]
                                                 ["dir"], 2))
            t0 = time.perf_counter()
            store.load_checkpoint(config("B")["checkpoint"]["dir"], 2)
            load_s = time.perf_counter() - t0
            del tb
            repro_torch.reset()
            repro_torch.init(config("B"))
            ctx = api._ctx
            rc = Trainer(ctx.config, ctx.model, ctx.fed_data,
                         tracker=ctx.tracker).resume()
            final = same_bits_tree(tree_leaves(ra["params"]),
                                   tree_leaves(rc["params"]))
            cka = store.load_checkpoint(config("A")["checkpoint"]["dir"], 3)
            ckb = store.load_checkpoint(config("B")["checkpoint"]["dir"], 3)
            step3 = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                        for a, b in zip(tree_leaves(cka["server"]["params"]),
                                        tree_leaves(ckb["server"]["params"])))
            print(f"[resume] {tag}: final params bit for bit {final}, step-3 "
                  f"checkpoint params bit for bit {step3}; step-2 checkpoint "
                  f"{nbytes} bytes ({nbytes / 2**20:.1f} MiB), save "
                  f"{save_s:.3f} s, load {load_s:.3f} s; EF rows on the host "
                  f"tier when saved: {spilled} ({smi})")
            require(final and step3, f"[resume] {tag}: the resumed run "
                    f"differs from the uninterrupted one")
            require(execution == "sequential" or spilled > 0,
                    f"[resume] {tag}: no EF row on the host tier")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        repro_torch.reset()


def same_bits_tree(a, b):
    """Leaf lists of equal dtypes, compared bit for bit on the CPU."""
    return all(x.dtype == y.dtype and torch.equal(
        x.cpu().view(torch.int32) if x.dtype == torch.float32 else x.cpu(),
        y.cpu().view(torch.int32) if y.dtype == torch.float32 else y.cpu())
        for x, y in zip(a, b))


def check_sequential_stage(repro_torch, dev):
    """The sequential compression stage with error feedback on the card
    against the same stage on the CPU, bit for bit, on one client's round-0
    update of phase 4e's configuration (femnist_cnn from seed 0, the
    update computed on the card): for STC the kept counts, the sent values
    and the residual; for int8 q, the scale, the sent values and the
    residual.  Called by ``tests/test_torch_cuda.py`` too."""
    from repro_torch.core import api
    from repro_torch.core import compression as comp
    from repro_torch.core.rounds import Trainer
    from repro_torch.utils.tree import tree_leaves, tree_map

    repro_torch.reset()
    repro_torch.set_device(dev)
    repro_torch.init({"model": "femnist_cnn", "dataset": "femnist",
                      "client": {"local_epochs": 1},
                      "server": {"clients_per_round": 10}})
    ctx = api._ctx
    trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                      tracker=ctx.tracker)
    params = ctx.model.init(torch.Generator().manual_seed(ctx.config.seed),
                            dev)
    cid = trainer.server.selection(ctx.fed_data.client_ids, 0)[0]
    update = trainer.client(cid).train(params, 0)["update"]
    for mode in ("stc", "int8"):
        out = []
        for where in (dev, torch.device("cpu")):
            u = tree_map(lambda t: t.to(where), update)
            c, r = comp.compress_with_feedback(u, comp.zero_residual(u),
                                               mode, 0.01)
            leaves = tree_leaves(c)
            out.append((
                [x.kind for x in leaves],
                [x.data for x in leaves],
                [x.nnz if mode == "stc" else x.scale
                 for x in leaves if x.kind == mode],
                tree_leaves(comp.decompress(c)), tree_leaves(r),
                comp.payload_bytes(c)))
        card, cpu = out
        require(card[0] == cpu[0], f"stage {mode}: leaf kinds differ")
        for i, what in ((1, "data (STC sent / int8 q)"),
                        (2, "nnz" if mode == "stc" else "scale"),
                        (3, "sent"), (4, "residual")):
            require(same_bits_tree(card[i], cpu[i]),
                    f"stage {mode}: {what} differ between card and CPU")
        require(card[5] == cpu[5], f"stage {mode}: payload bytes differ")
        print(f"[stage {mode}] client {cid} round 0: {card[0].count(mode)} "
              f"compressed leaves, card = CPU bit for bit (data, "
              f"{'nnz' if mode == 'stc' else 'q, scale'}, sent, residual); "
              f"payload {card[5]} bytes")
    repro_torch.set_device(None)
    repro_torch.reset()


def remote_config(clients, per_round, rounds, topology="flat"):
    """Phase 4k: femnist_cnn at its published width, ``clients`` client
    services of phase 4's 360 samples each (``data_amount`` scaled from
    the dataset's 100 clients to ``clients``), ``per_round`` a round, 1
    local epoch, K1 on; ``execution="sequential"`` is the engine of the
    ``init(); run()`` twin that the remote run is held against."""
    return {"model": "femnist_cnn", "task_id": "chip_remote",
            "data": {"dataset": "femnist", "num_clients": clients,
                     "data_amount": clients / 100},
            "resources": {"execution": "sequential",
                          "aggregation_kernel": True,
                          "aggregation_topology": topology},
            "client": {"local_epochs": 1},
            "server": {"rounds": rounds, "clients_per_round": per_round}}


def remote_run(repro_torch, ops, cfg, n_clients):
    """``cfg`` through ``start_client`` x ``n_clients`` (threads of this
    process, sockets on 127.0.0.1) and ``start_server().run()`` -> (launch
    counts of the run, final params on the CPU, history, host-clock walls
    of each round with its ``synchronize``, the server's transport stats).
    """
    from repro_torch.deploy import Registry
    from repro_torch.utils.tree import tree_leaves

    repro_torch.reset()
    repro_torch.init(cfg)
    registry = Registry()
    clients, server = [], None
    try:
        for i in range(n_clients):
            clients.append(repro_torch.start_client(
                {"client_id": f"client_{i:04d}", "registry": registry}))
        server = repro_torch.start_server({"registry": registry})
        devices = {str(c.device) for c in clients} | {str(server.device)}
        require(all(d.startswith("cuda") for d in devices),
                f"remote services on {devices}, expected the card")
        walls, run_round = [], server.run_round

        def timed(r):                  # run() calls it once a round
            t0 = time.perf_counter()
            out = run_round(r)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out

        server.run_round = timed
        ops.reset_launch_counts()
        hist = server.run()
        torch.cuda.synchronize()
        used = ops.launch_counts()
    finally:
        if server is not None:
            server.stop()
        for c in clients:
            c.stop()
    out = tree_leaves(server.server.params)
    require(all(t.device.type == "cuda" and bool(torch.isfinite(t).all())
                for t in out), "remote params off the card or not finite")
    stats = [t.stats for t in server.transports.values()]
    # the client services share the model, and with it the client step;
    # the server's evaluation runs the eval step
    steps = step_counts(clients[0].client)
    require(all(c["keys"] >= 1 and c["captures"] == c["keys"]
                and c["recaptures"] == 0 for c in steps.values()),
            f"[remote] steps {steps}: expected 1 capture a key, 0 "
            f"recaptures")
    repro_torch.reset()
    return used, [t.cpu() for t in out], hist, walls, stats, steps


class Service:
    """One ``python -m repro_torch.launch.service`` child process; a thread
    reads its output lines (stderr merged) into a queue."""

    def __init__(self, *args):
        import queue
        import threading

        self.args = args
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.launch.service",
             *args], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        self.out, self.lines = [], queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.out.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, prefix, timeout):
        """The first output line starting with ``prefix``; fails after
        ``timeout`` seconds or when the child exits first."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            require(left > 0, f"{self.args[0]}: no {prefix!r} line in "
                    f"{timeout} s:\n{''.join(self.out)[-3000:]}")
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                continue
            if line is None:           # the child closed its output
                raise AssertionError(
                    f"{self.args[0]} exited with {self.proc.wait()} before "
                    f"a {prefix!r} line:\n{''.join(self.out)[-3000:]}")
            if line.startswith(prefix):
                return line.strip()

    def stop(self, timeout=60):
        """Interrupt a serving child and wait for it -> its stop line."""
        self.proc.send_signal(signal.SIGINT)
        line = self.wait_for("stopped", timeout)
        require(self.proc.wait(timeout) == 0,
                f"{self.args[0]} exited with {self.proc.returncode}")
        return line

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def run_topology(smi):
    """Phase 4k (b): registry, tracker, 4 clients and the server as
    ``python -m repro_torch.launch.service`` processes on the one card
    (femnist_cnn, 4 a round, 2 rounds, K1 on) -> the server's result."""
    from repro_torch.launch.service import RemoteTracker, _parse_addr

    gc.collect()
    torch.cuda.empty_cache()           # the children need the card too
    cfg = json.dumps(remote_config(4, 4, 2))
    children = []
    try:
        addr = {}
        for role in ("registry", "tracker"):
            children.append(Service(role))
            line = children[-1].wait_for(f"{role} listening on ", 120)
            addr[role] = line.split()[3]
            print(f"[topology] {line}")
        clients = [Service("client", "--client-id", f"client_{i:04d}",
                           "--registry", addr["registry"], "--config", cfg)
                   for i in range(4)]
        children += clients
        for c in clients:
            line = c.wait_for("client ", 300)
            print(f"[topology] {line}")
            require("(device: cuda" in line, f"client not on the card: "
                    f"{line}")
        t0 = time.perf_counter()
        server = Service("server", "--registry", addr["registry"],
                         "--tracker", addr["tracker"], "--config", cfg,
                         "--rounds", "2")
        children.append(server)
        result = json.loads(server.wait_for("{", 600))
        require(server.proc.wait(120) == 0,
                f"server exited with {server.proc.returncode}")
        wall = time.perf_counter() - t0
        print(f"[topology] server: {result} ({wall:.1f} s from its start "
              f"to its exit, CUDA context, data and 2 rounds)")
        require(result["rounds"] == 2
                and math.isfinite(result["final"]["accuracy"]),
                f"server result {result}")
        require(result["device"].startswith("cuda"),
                f"server not on the card: {result}")
        tracker = RemoteTracker(_parse_addr(addr["tracker"]))
        series = tracker.round_series("chip_remote", "accuracy")
        tracker.close()
        print(f"[topology] tracker round_series accuracy {series}")
        require(len(series) == 2, f"tracker has {len(series)} rounds")
        for c in clients:                  # before the registry they leave
            require("cuda initialized: True" in c.stop(),
                    f"{c.args[:3]} never initialized CUDA")
        for role, child in zip(("registry", "tracker"), children):
            line = child.stop()
            print(f"[topology] {role} {line}")
            require("cuda initialized: False" in line,
                    f"the {role} initialized CUDA")
    finally:
        for child in children:
            child.kill()
    require(all(c.proc.returncode is not None for c in children),
            "a service child is still running")
    print(f"[topology] {len(children)} children ended, exit codes "
          f"{[c.proc.returncode for c in children]} ({smi})")
    return result


def wire_costs(params, dev):
    """Host costs of one train request carrying ``params`` (a tree of
    numpy arrays) on the remote path, each the median of 3 runs, in
    seconds: ``serialize.dumps``, its send and ``transport._recv_msg``
    over a local socket pair, ``serialize.loads``, the params onto ``dev``
    (one copy a leaf, synchronized) and back to numpy -> (costs, message
    bytes)."""
    import socket
    import threading

    from repro_torch.comm import serialize
    from repro_torch.comm.transport import _recv_msg, _send_msg
    from repro_torch.core.remote import _to_device, _to_numpy

    wire = {"method": "train", "payload": {
        "payload": {"params": params, "payload_bytes": 0}, "round_id": 0}}
    msg = serialize.dumps(wire)

    def transfer():
        a, b = socket.socketpair()
        try:
            th = threading.Thread(target=_send_msg, args=(a, msg))
            th.start()
            got = _recv_msg(b)
            th.join(timeout=60)
        finally:
            a.close()
            b.close()
        require(got == msg, "a received message differs from the sent one")

    def to_device():
        out = _to_device(params, dev)
        torch.cuda.synchronize()
        return out

    on_dev = to_device()
    steps = {"dumps": lambda: serialize.dumps(wire),
             "send + _recv_msg": transfer,
             "loads": lambda: serialize.loads(msg),
             "to device": to_device,
             "to numpy": lambda: _to_numpy(on_dev)}
    costs = {}
    for name, fn in steps.items():
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        costs[name] = float(np.median(secs))
    return costs, len(msg)


def run_remote(repro_torch, ops, smi):
    """Phase 4k: remote training (``start_client`` / ``start_server``, the
    service CLI).  (a) In process: femnist_cnn, 8 client services, 4 a
    round, 3 rounds; its final params against the ``init(); run()``
    sequential run of the same configuration, printed against 1e-4 and
    held within max(1e-4, 2 x that run's 1e-7-perturbed reach); K1 once a
    round on the server; then 2 rounds under ``aggregation_topology=
    "hierarchical"`` (4 rows pad to one group of 8: one grouped K1 a
    round).  (b) The service topology's processes (``run_topology``).
    (c) Round walls, transport bytes and latency a round, and the host
    costs of one 26.4 MB message (``wire_costs``).  -> {K1 counter:
    launches}."""
    from repro_torch.core.config import Config
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_leaves, tree_map

    rounds = 3
    cfg = remote_config(8, 4, rounds)
    repro_torch.reset()
    repro_torch.init(cfg)
    seq = repro_torch.run()
    torch.cuda.synchronize()
    seq_final = [t.cpu() for t in tree_leaves(seq["params"])]
    seq_walls = [h["wall_time"] for h in seq["history"]]
    repro_torch.reset()

    used, final, hist, walls, stats, steps = remote_run(repro_torch, ops,
                                                        cfg, 8)
    print(f"[remote] launches {used}")
    print(f"[remote] the client services' shared client step and the "
          f"server's eval step, captured: {steps}")
    for k, v in used.items():
        want = rounds if k == "fedavg_agg" else 0
        require(v == want, f"[remote] {k} launched {v} times, expected "
                f"{want}")
    require(len(hist) == rounds and all(
        math.isfinite(h["train_loss"]) and math.isfinite(h["accuracy"])
        for h in hist), f"[remote] history {hist}")
    loss_gap = max(abs(a["train_loss"] - b["train_loss"])
                   for a, b in zip(hist, seq["history"]))
    require(loss_gap <= 1e-3, f"[remote] train losses {loss_gap} from the "
            f"sequential run's")
    diff = max_diff(final, seq_final)
    init = femnist_cnn().init(torch.Generator().manual_seed(Config().seed))
    gap = conditioning_gap(repro_torch, cfg, init, seq_final)
    bar = max(1e-4, 2 * gap)
    print(f"[remote] final params vs the sequential run: max |diff| "
          f"{diff:.4g} ({'within' if diff <= 1e-4 else 'above'} 1e-4); the "
          f"sequential run from 1e-7-perturbed inits moves them up to "
          f"{gap:.4g}; bar max(1e-4, 2 x that) = {bar:.4g}; train losses "
          f"within {loss_gap:.3g} (bar 1e-3)")
    require(diff <= bar, f"remote vs sequential: {diff} > {bar}")

    tree_used, _, tree_hist, _, _, _ = remote_run(
        repro_torch, ops, remote_config(8, 4, 2, "hierarchical"), 8)
    print(f"[remote hierarchical] launches {tree_used}")
    for k, v in tree_used.items():
        want = 2 if k == "fedavg_agg_tree" else 0
        require(v == want, f"[remote hierarchical] {k} launched {v} "
                f"times, expected {want}")
    require(all(math.isfinite(h["accuracy"]) for h in tree_hist),
            f"[remote hierarchical] history {tree_hist}")

    # (c) figures
    per = {k: sum(getattr(s, k) for s in stats) / rounds
           for k in ("requests", "bytes_sent", "bytes_received",
                     "total_latency")}
    print(f"[remote] steady round wall s (rounds 1-2, evaluation "
          f"included): {[round(w, 4) for w in walls[1:]]}, round 0 "
          f"{walls[0]:.4f}; fan-out ('round_time') "
          f"{[round(h['round_time'], 4) for h in hist]}; the sequential "
          f"run's wall_time (evaluation excluded) "
          f"{[round(w, 4) for w in seq_walls[1:]]}, round 0 "
          f"{seq_walls[0]:.4f} ({smi})")
    print(f"[remote] transport a round: {per['requests']:.0f} requests, "
          f"{per['bytes_sent']:.0f} bytes sent, {per['bytes_received']:.0f} "
          f"received, total_latency {per['total_latency']:.4f} s (summed "
          f"over the clients' concurrent requests); history comm_down "
          f"{hist[-1]['comm_down_bytes']}, comm_up {hist[-1]['comm_up_bytes']}")
    costs, nbytes = wire_costs(
        tree_map(lambda t: t.cpu().numpy(), seq["params"]),
        repro_torch.get_device())
    print(f"[remote] host costs of one {nbytes / 1e6:.1f} MB train request "
          f"(median of 3, s): "
          f"{ {k: round(v, 4) for k, v in costs.items()} } ({smi})")

    run_topology(smi)
    return {"fedavg_agg": used["fedavg_agg"],
            "fedavg_agg_tree": tree_used["fedavg_agg_tree"]}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (``cudnn.deterministic``, no
    benchmark search), as phase 4g's ``--resume-check`` child runs: the
    card's run of a model repeats bit for bit.  With the defaults a
    ``cifar_resnet18`` round's train loss moved 6.9e-4 to 9.1e-4 from one
    card run to the next (PERF.md, PR 30), half its 1e-7-perturbed reach,
    so phase 4h's card-vs-CPU bar compared two draws of that noise."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags


def card_vs_cpu(repro_torch, execution, model="femnist_cnn"):
    """Phase 5 (femnist_cnn) and phase 4h's card-vs-CPU runs (the other
    models, ``M3_CPU_CUT``'s rounds and clients, evaluation off; their
    card run and its perturbed runs under :func:`deterministic_cudnn`)."""
    from repro_torch import convert
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models.registry import get_model
    from repro_torch.utils.tree import tree_leaves

    p0 = convert.params_to_numpy(
        get_model(model).init(torch.Generator().manual_seed(7), "cpu"))
    femnist = model == "femnist_cnn"
    if femnist:
        cfg = {"model": "femnist_cnn", "dataset": "femnist",
               "resources": {"execution": execution},
               "client": {"local_epochs": 1},
               "server": {"rounds": 2, "clients_per_round": 4}}
    else:
        cfg = model_config(model, "none", execution, *M3_CPU_CUT[model])
        cfg["server"]["test_every"] = 0
        execution = f"{model} {execution}"
    threads = torch.get_num_threads()
    out = {}
    runs = [("cuda", threads), ("cpu", threads)]
    if femnist:       # phase 5 also reads the CPU's own thread-count reach
        runs.append(("cpu/2", max(1, threads // 2)))
    for device, n in runs:
        torch.set_num_threads(n)
        repro_torch.reset()
        repro_torch.set_device(device.split("/")[0])
        repro_torch.init(cfg)
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = convert.params_from_jax(p0)
        t0 = time.perf_counter()
        with (deterministic_cudnn() if device == "cuda" and not femnist
              else contextlib.nullcontext()):
            res = trainer.run()
        out[device] = (res, time.perf_counter() - t0)
    torch.set_num_threads(threads)
    repro_torch.set_device(None)
    repro_torch.reset()

    def params(device):
        return [t.cpu() for t in tree_leaves(out[device][0]["params"])]

    card = params("cuda")
    diff = max_diff(card, params("cpu"))
    card_losses = [h["train_loss"] for h in out["cuda"][0]["history"]]
    lossdiff = max(abs(a - b["train_loss"]) for a, b in zip(
        card_losses, out["cpu"][0]["history"]))
    # the run's own sensitivity to rounding: 2 rounds of 6 steps through
    # max pooling and ReLU move 1.4e-5 to 2.6e-4 from a 1e-7 perturbation
    # or from another CPU thread count, in either engine (PERF.md, PR 18)
    init = convert.params_from_jax(p0, torch.device("cpu"))
    if femnist:
        cpu_reach = max_diff(params("cpu/2"), params("cpu"))
        gap = conditioning_gap(repro_torch, cfg, init, card)
        loss_bar = 1e-4
        reach = (f"the CPU at {max(1, threads // 2)} threads instead of "
                 f"{threads} {cpu_reach:.4g}")
    else:
        # the other models: the same rule for the train losses too (a
        # ResNet round moves its loss by ~1e-3 from 1e-7-perturbed inits,
        # and the card's run lands 1.5-1.7x that reach from the CPU's:
        # six perturbed runs, not three, so the reach is not undersampled)
        cpu_reach = 0.0
        with deterministic_cudnn():
            gap, loss_gap = conditioning_gap(repro_torch, cfg, init, card,
                                             seeds=(1, 2, 3, 4, 5, 6),
                                             final_losses=card_losses)
        loss_bar = max(1e-4, 2 * loss_gap)
        reach = f"their train losses up to {loss_gap:.4g}"
    bar = max(1e-4, 2 * max(gap, cpu_reach))
    print(f"[{execution}] card vs CPU after {cfg['server']['rounds']} "
          f"rounds of {cfg['server']['clients_per_round']} clients: max "
          f"|param diff| "
          f"{diff:.4g} ({'within' if diff <= 1e-4 else 'above'} 1e-4; bar "
          f"{bar:.4g}), max |train_loss diff| {lossdiff:.3g} ("
          f"{'within' if lossdiff <= 1e-4 else 'above'} 1e-4; bar "
          f"{loss_bar:.4g}); the card from 1e-7-perturbed inits moves up to "
          f"{gap:.4g}, {reach}; run s: "
          + ", ".join(f"{d} {t:.2f}" for d, (_, t) in out.items()))
    require(lossdiff <= loss_bar, f"[{execution}] card vs CPU train_loss "
            f"diff {lossdiff} > {loss_bar}")
    require(diff <= bar, f"[{execution}] card vs CPU param diff {diff} "
            f"> {bar}")


def max_diff(a, b):
    """Largest |a - b| over two leaf lists on the CPU."""
    return max((x - y).abs().max().item() for x, y in zip(a, b))


LORA_SEQ_LEN = 512
LORA_CLIENT = {"local_epochs": 1, "finetune": "lora", "lora_rank": 8,
               "lora_alpha": 16.0, "lora_targets": ("attn",),
               "compression": "none"}


def glm4_2layer(published_scale=True):
    """GLM-4-9B at its published width, depth cut 40 -> 2, f32.

    ``published_scale``: draw the attention projections with std
    1/sqrt(fan-in over the contracted dims) — wq, wk, wv 1/sqrt(d_model),
    wo 1/sqrt(H * hd) — as trained models of this shape are scaled.  The
    repo's default init (the reference's) takes the head count as the
    fan-in of the (d, H, hd) leaves: q and k 11x larger at this width,
    attention scores of std ~128, a hard argmax under which LoRA training
    is chaotic (flash on and off then land 5.8e-3 apart, and a
    1e-7-perturbed start moves the run 3.7e-3: PERF.md §6)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.llm import transformer_lm
    from repro_torch.models.small import FLModel

    arch = dataclasses.replace(get_arch("glm4-9b"), n_layers=2,
                               dtype="float32", max_seq_len=LORA_SEQ_LEN)
    model = transformer_lm(arch, name="glm4-9b-2l")
    if not published_scale:
        return dataclasses.replace(model, name="glm4-9b-2l-default-init")

    class PublishedScale(FLModel):
        def init(self, gen, device=None):
            p = super().init(gen, device)
            for seg in p["segments"]:
                a = seg["attn"]
                _, d, h, _ = a["wq"].shape          # (layers, d, H, hd)
                kv = a["wk"].shape[2]
                a["wq"].mul_(math.sqrt(h / d))
                a["wk"].mul_(math.sqrt(kv / d))
                a["wv"].mul_(math.sqrt(kv / d))
                a["wo"].mul_(1.0 / math.sqrt(h))
            return p

    return PublishedScale(model.name, model.defs, model.apply,
                          model.num_classes, model.input_shape,
                          model.is_sequence)


def lora_config(model, rounds=2, execution="batched", compression="none"):
    """Phase 4b's configuration (registers ``model`` and the dataset).
    Evaluation is off: one full-vocabulary evaluation batch (256 x 512
    tokens x 151,552 logits) would need 79 GB."""
    import repro_torch
    from repro_torch.data.synthetic import make_tiny_lm

    repro_torch.register_model(model)
    repro_torch.register_dataset(
        lambda seed=0: make_tiny_lm(n_seqs=140, seq_len=LORA_SEQ_LEN,
                                    vocab=1024, seed=seed), name="lm512")
    return {"model": model.name, "dataset": "lm512",
            "data": {"num_clients": 8, "batch_size": 4},
            "server": {"rounds": rounds, "clients_per_round": 4,
                       "test_every": 0},
            "client": dict(LORA_CLIENT, compression=compression),
            "resources": {"execution": execution,
                          "aggregation_kernel": True}}


def run_lora(repro_torch, ops, flash_on, execution="batched",
             compression="none", perturb=None, eager=False, rounds=2):
    """Phase 4b's configuration through ``init``/``run`` (``perturb``: a
    relative 1e-7-sized perturbation of the adapters' start, from that
    seed, and ``Trainer.run`` instead of ``run``; ``eager``: the batched
    executor's round and cohort programs eager, ``eager_rounds``;
    ``rounds``: rounds, or aggregations under async) -> the
    final adapters, the launch counts, the round walls, the peak GiB
    allocated and reserved and the cohort program's captures and
    replays."""
    from repro_torch.core import api, batched
    from repro_torch.core.rounds import Trainer
    from repro_torch.models import attention as mattn
    from repro_torch.models.lora import adapter_param_count
    from repro_torch.utils.tree import tree_leaves, tree_map

    tag = (f"[lora flash {'on' if flash_on else 'off'}"
           + ("" if execution == "batched" else f" {execution}")
           + (" eager" if eager else "")
           + ("" if compression == "none" else f" {compression}")
           + ("" if perturb is None else f" perturbed {perturb}") + "]")
    release(repro_torch)
    cfg = lora_config(glm4_2layer(), rounds, execution=execution,
                      compression=compression)
    repro_torch.init(cfg)
    run = repro_torch.run
    if perturb is not None:
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        gen = torch.Generator().manual_seed(perturb)
        trainer.server.params = tree_map(
            lambda t: t * (1 + 1e-7 * torch.randn(
                t.shape, generator=gen).to(t.device)),
            trainer.model.init(torch.Generator().manual_seed(
                ctx.config.seed), trainer.device))
        run = trainer.run
    mattn.set_flash_attention(flash_on)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    n0 = batched.cohort_capture_count(), batched.cohort_replay_count()
    t0 = time.perf_counter()
    try:
        with eager_rounds() if eager else contextlib.nullcontext():
            res = run()
        torch.cuda.synchronize()
    finally:
        mattn.set_flash_attention(None)
    total = time.perf_counter() - t0
    used = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    cohort = (batched.cohort_capture_count() - n0[0],
              batched.cohort_replay_count() - n0[1])
    hist = res["history"]
    print(f"{tag} launches {used}")
    if execution == "sequential":
        trainer = api._ctx.trainer
        steps = step_counts(trainer.client(trainer.fed_data.client_ids[0]),
                            evaluated=trainer.cfg.server.test_every > 0)
        print(f"{tag} sequential client step, captured (evaluation off): "
              f"{steps['client']}")
        require(steps["client"]["captures"] == steps["client"]["keys"] == 1
                and steps["client"]["recaptures"] == 0,
                f"{tag} client step {steps['client']}: expected 1 key, 1 "
                f"capture, 0 recaptures")
    rounds = cfg["server"]["rounds"]
    require(used["fedavg_agg"] == rounds, f"{tag} fedavg_agg launched "
            f"{used['fedavg_agg']} times, expected {rounds}")
    want = {"none": (), "stc": ("stc_batched",),
            "int8": ("int8_rowmax", "int8_qdq")}[compression]
    for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
        require((used[k] > 0) == (k in want), f"{tag} {k} launched "
                f"{used[k]} times under {compression}")
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        if flash_on:
            require(used[k] > 0, f"{tag} {k} never launched")
        else:
            require(used[k] == 0, f"{tag} {k} launched with the flag off")
    for h in hist:
        require(math.isfinite(h["train_loss"]), f"{tag} non-finite loss {h}")
    out = tree_leaves(res["params"])
    n = sum(t.numel() for t in out)
    want = adapter_param_count(repro_torch.core.api._ctx.model,
                               LORA_CLIENT["lora_rank"],
                               LORA_CLIENT["lora_targets"])
    require(n == want, f"{tag} {n} trained parameters, expected the "
            f"{want} adapter elements")
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"{tag} non-finite adapters")
    walls = [h["wall_time"] for h in hist]
    print(f"{tag} round wall s {[round(w, 4) for w in walls]} (round 0 "
          f"includes first use); run total {total:.3f} s (base init "
          f"included); peak device memory {peak:.2f} GiB allocated, "
          f"{reserved:.2f} reserved; cohort program {cohort[0]} "
          f"capture(s), {cohort[1]} replays")
    require(peak < 70, f"{tag} peak device memory {peak:.2f} GiB >= 70")
    print(f"{tag} train_loss {[round(h['train_loss'], 6) for h in hist]} "
          f"comm_up {[h['comm_up_bytes'] for h in hist]}")
    release(repro_torch)
    return {"params": res["params"], "launches": used, "walls": walls,
            "peak": peak, "reserved": reserved, "cohort": cohort}


def lora_engines(repro_torch, ops, batched_on, smi):
    """Phase 4b beyond the batched engine: the flash-on configuration
    through the sequential engine (its client step captured, K6/K7
    without vmap) and the async engine (2 aggregations of 4, uniform speeds: the
    degenerate case), held against the batched flash-on run
    (``batched_on``) within max(1e-4, 2 x how far that run moves from a
    1e-7-perturbed start); then batched LoRA with STC
    and with int8 (K2 / K3 on the adapter leaves), finite and with their
    launches."""
    reach = max_param_diff(run_lora(repro_torch, ops, True, perturb=1)[
        "params"], batched_on["params"])
    bar = max(1e-4, 2 * reach)
    for execution in ("sequential", "async"):
        out = run_lora(repro_torch, ops, True, execution=execution)
        diff = max_param_diff(out["params"], batched_on["params"])
        print(f"[lora flash on {execution}] adapters vs the batched flash-on "
              f"run: max |diff| {diff:.4g} ({'within' if diff <= 1e-4 else 'above'}"
              f" 1e-4); the batched run from a 1e-7-perturbed start moves "
              f"{reach:.4g}; bar {bar:.4g} ({smi})")
        require(diff <= bar, f"[lora {execution}] vs batched: {diff} > "
                f"{bar}")
    # the async waves' cohort program (K6 / K7 inside) captured against
    # eager over 3 aggregations (wave 1 the warm-up, wave 2 the capture,
    # wave 3 a replay): wall per aggregation, peak allocated and reserved
    out, eager = (run_lora(repro_torch, ops, True, execution="async",
                           eager=e, rounds=3) for e in (False, True))
    diff = max_param_diff(out["params"], eager["params"])
    print(f"[lora flash on async] captured / eager: wall per aggregation s "
          f"{[round(w, 4) for w in out['walls']]} / "
          f"{[round(w, 4) for w in eager['walls']]} (the first carries "
          f"first use); peak GiB allocated {out['peak']:.2f} / "
          f"{eager['peak']:.2f}, reserved {out['reserved']:.2f} / "
          f"{eager['reserved']:.2f}; cohort program captures, replays "
          f"{out['cohort']} / {eager['cohort']}; adapters max |diff| "
          f"{diff:.4g} (bar {bar:.4g}) ({smi})")
    require(out["cohort"] == (1, 2) and eager["cohort"] == (0, 0),
            f"[lora async] cohort captures, replays {out['cohort']}, eager "
            f"{eager['cohort']}, expected (1, 2) and (0, 0)")
    require(diff <= bar, f"[lora async] captured vs eager: {diff} > {bar}")
    for compression in ("stc", "int8"):
        run_lora(repro_torch, ops, True, compression=compression)
    lora_step_memory(repro_torch, smi)


def lora_step_memory(repro_torch, smi):
    """Phase 4b: what the sequential engine's cached steps keep on the card
    for a large model.  Phase 4b's configuration, flash on, sequential,
    with evaluation on at 8 sequences a test batch, through ``init``/``run``
    (a client-step key and an eval-step key; the peak beside the same run's
    eager twin's, ``eager_sequential``); then one client's local run at
    batch size 2 through the same client step (a second key, its graph in
    the first one's memory pool).  The memory the cached steps hold (static
    buffers, graph pools) is what dropping them frees, allocated and
    reserved, after the run and after the second key."""
    from repro_torch.core import api
    from repro_torch.core import local_train as lt
    from repro_torch.models import attention as mattn

    def held():
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated() / 2**30,
                torch.cuda.memory_reserved() / 2**30)

    peaks = {}
    mattn.set_flash_attention(True)
    try:
        for captured in (False, True):
            release(repro_torch)
            cfg = lora_config(glm4_2layer(), execution="sequential")
            cfg["server"]["test_every"] = 1
            cfg["data"]["test_batch_size"] = 8
            repro_torch.init(cfg)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with (contextlib.nullcontext() if captured
                  else eager_sequential()):
                res = repro_torch.run()
            torch.cuda.synchronize()
            peaks[captured] = (torch.cuda.max_memory_allocated()
                               - base) / 2**30
            require(all(np.isfinite(h["loss"]) for h in res["history"]),
                    f"[lora step memory] evaluation not finite: "
                    f"{res['history']}")
        trainer = api._ctx.trainer
        client = trainer.client(trainer.fed_data.client_ids[0])
        one_key = step_counts(client)
        after_run = held()
        lt.local_train(client.model, trainer.server.params, client.data.x,
                       client.data.y, epochs=1, batch_size=2,
                       optimizer=client.optimizer)
        two_keys = step_counts(client)
        after_key = held()
        lt.make_client_step.cache_clear()
        lt.make_eval_step.cache_clear()
        dropped = held()
    finally:
        mattn.set_flash_attention(None)
    release(repro_torch)
    require(one_key["client"]["keys"] == 1 and one_key["eval"]["keys"] == 1
            and two_keys["client"]["keys"] == 2
            and all(c["captures"] == c["keys"] for c in two_keys.values()),
            f"[lora step memory] steps {one_key} -> {two_keys}")
    gib = [[round(a - b, 4) for a, b in zip(h, dropped)]
           for h in (after_run, after_key)]
    print(f"[lora step memory] sequential, evaluation on: peak "
          f"{peaks[True]:.4f} GiB captured, {peaks[False]:.4f} GiB eager; "
          f"the cached steps hold (allocated, reserved) {gib[0]} GiB with a "
          f"client-step and an eval-step key, {gib[1]} GiB with a second "
          f"client-step key (batch size 2); steps {two_keys} ({smi})")


def release(repro_torch):
    """Drop the previous run's trainer and programs (and with them its
    6.6 GB base) before the next full-width run."""
    import gc
    repro_torch.reset()
    gc.collect()
    torch.cuda.empty_cache()


def lora_card_vs_cpu(repro_torch, execution="batched"):
    """``tiny_lm`` LoRA, flash on, 2 rounds of 4 clients on the card and on
    the CPU, under ``execution``.  Base and adapters are drawn from the CPU
    generator, so both runs start from the same parameters."""
    from repro_torch.models import attention as mattn

    cfg = {"model": "tiny_lm", "dataset": "tiny_lm",
           "data": {"num_clients": 8, "batch_size": 32},
           "server": {"rounds": 2, "clients_per_round": 4},
           "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
                      "lora_rank": 4, "lora_alpha": 8.0,
                      "lora_targets": ("attn",)},
           "resources": {"execution": execution}}
    out = {}
    mattn.set_flash_attention(True)
    try:
        for device in ("cuda", "cpu"):
            repro_torch.reset()
            repro_torch.set_device(device)
            repro_torch.init(cfg)
            out[device] = repro_torch.run()
    finally:
        mattn.set_flash_attention(None)
        repro_torch.set_device(None)
        repro_torch.reset()
    diff = max_param_diff(out["cuda"]["params"], out["cpu"]["params"])
    print(f"tiny_lm LoRA {execution} card vs CPU after 2 rounds (flash on): "
          f"max |adapter diff| {diff:.3g} (bar 1e-4)")
    require(diff <= 1e-4, f"LoRA card vs CPU adapter diff {diff} > 1e-4")


# ---------------------------------------------------------------------------
# Phase 4l: LLM training (launch/train and the federated round), phase 5d
# ---------------------------------------------------------------------------

LLM_CUT = ["--full", "--layers", "2", "--batch", "2", "--seq", "512"]
LLM_TOKENS = 2 * 512                  # a step's tokens: batch x seq
LLM_LAYERS = 2
EMBED_ROW = 151552 * 4096             # glm4-9b's embedding leaf: 620,756,992


def sample(params, n=4096):
    """The first ``n`` elements of every leaf, on the host: enough to see
    that the params moved without holding a second copy of them."""
    from repro_torch.utils.tree import tree_leaves
    return [t.detach().reshape(-1)[:n].float().cpu()
            for t in tree_leaves(params)]


def perturbed(params, seed):
    """``params`` times 1 + 1e-7 N(0, 1) (f32 rounding's size), drawn on
    the CPU from ``seed`` so that a card and a CPU run see the same."""
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)).to(t.device, t.dtype), params)


def run_train(ops, arch, steps, flash_on, perturb=None, keep=False,
              cut=None, redraw=None, capture=True):
    """``repro_torch.launch.train.main`` at ``arch``'s published width cut
    to 2 layers (``LLM_CUT``, or ``cut``), ``steps`` steps, flash on or
    off, on the card, its ``TrainStep`` captured (step 1 eager, step 2
    captured, later steps replayed; ``capture=False``: every step eager).
    Each step is timed between two ``synchronize()`` and its metrics read;
    ``perturb``: the init times 1 + 1e-7 N(0, 1) from that seed;
    ``redraw``: ``redraw(model, params)`` redraws the init in place before
    the first step; ``keep``: keep the final params -> dict(losses, walls,
    metrics, launches, peak and reserved GiB, the step's counts, first /
    last param samples[, params])."""
    from repro_torch.launch import train
    from repro_torch.models import attention as mattn

    rec = {"walls": [], "metrics": []}
    real = train.TrainStep

    class Timed(real):
        def __init__(self, model, opt, remat=True):
            super().__init__(model, opt, remat, capture=capture)

        def __call__(self, state, batch):
            if "first" not in rec:
                if redraw is not None:
                    redraw(self.model, state.params)
                if perturb is not None:
                    state = dataclasses.replace(
                        state, params=perturbed(state.params, perturb))
                rec["first"] = sample(state.params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = super().__call__(state, batch)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
            rec["last"] = sample(state.params)
            rec["counts"] = {k: getattr(self, k) for k in (
                "eager_steps", "captures", "recaptures", "replays")}
            if keep:
                rec["params"] = state.params
            return state, metrics

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec["held"] = torch.cuda.memory_allocated() / 2**30
    ops.reset_launch_counts()
    train.TrainStep = Timed
    mattn.set_flash_attention(flash_on)
    try:
        rec["losses"] = train.main(["--arch", arch, *(cut or LLM_CUT),
                                    "--steps", str(steps), "--log-every",
                                    "1"])
    finally:
        train.TrainStep = real
        mattn.set_flash_attention(None)
    rec["launches"] = ops.launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated() / 2**30
    rec["reserved"] = torch.cuda.max_memory_reserved() / 2**30
    want = ({"eager_steps": 1, "captures": 1, "recaptures": 0,
             "replays": steps - 1} if capture and steps > 1 else
            {"eager_steps": steps, "captures": 0, "recaptures": 0,
             "replays": 0})
    require(rec["counts"] == want, f"[train {arch}] step counts "
            f"{rec['counts']}, expected {want}")
    return rec


def train_ab(cap, eager, smi):
    """Phase 4l (a): the captured glm4-9b flash-on run against its eager
    twin (both under deterministic cuDNN): losses and final params bit for
    bit; steady s a step and peak GiB above what the run found held."""
    from repro_torch.utils.tree import tree_leaves

    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(tree_leaves(cap.pop("params")),
                               tree_leaves(eager.pop("params"))))
    walls = [float(np.mean(steady_walls(r))) for r in (cap, eager)]
    print(f"[train glm4-9b flash on] captured / eager: steady "
          f"{walls[0]:.5f} / {walls[1]:.5f} s a step (x{walls[0] / walls[1]:.3f}"
          f"); peak GiB allocated above the held "
          f"{cap['peak'] - cap['held']:.2f} / "
          f"{eager['peak'] - eager['held']:.2f}, reserved "
          f"{cap['reserved']:.2f} / {eager['reserved']:.2f}; losses equal "
          f"{cap['losses'] == eager['losses']}; final params bit for bit "
          f"{same}; step counts {cap['counts']} / {eager['counts']} ({smi})")
    require(same and cap["losses"] == eager["losses"],
            "[train glm4-9b] the captured run differs from its eager twin")


def steady_walls(rec):
    """A train run's steady step walls: after the warm-up and, where the
    step was captured, after the capturing step."""
    walls = rec["walls"]
    skip = 2 if rec["counts"]["captures"] else 1
    return walls[skip:] or walls[-1:]


def report_train(rec, arch, flash_on, smi):
    """Print a train run's losses, step walls, tokens/s, peak memory and
    flash launches; require finite losses, moved params and the flash
    launches remat gives: K6 twice a layer a step (the forward, then the
    backward's recompute), K7a and K7b once a layer a step."""
    tag = f"[train {arch} flash {'on' if flash_on else 'off'}]"
    steps = len(rec["losses"])
    walls = rec["walls"]
    steady = steady_walls(rec)
    wall = float(np.mean(steady))
    used = {k: rec["launches"][k] for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")}
    print(f"{tag} losses {[round(x, 6) for x in rec['losses']]}; step wall "
          f"s {[round(w, 4) for w in walls]} (step 1 includes first use"
          f"{'' if walls[1:] else '; the only step'}; step counts "
          f"{rec['counts']}); steady {wall:.4f} s a step, "
          f"{LLM_TOKENS / wall:.1f} tokens/s; peak device memory "
          f"{rec['peak']:.2f} GiB allocated, {rec['reserved']:.2f} reserved; "
          f"launches {used} ({smi})")
    require(all(math.isfinite(x) for x in rec["losses"]),
            f"{tag} non-finite loss {rec['losses']}")
    require(any(not torch.equal(a, b) for a, b in zip(rec["first"],
                                                      rec["last"])),
            f"{tag} the params did not move")
    want = ({"flash_fwd": 2 * LLM_LAYERS * steps,
             "flash_dq": LLM_LAYERS * steps,
             "flash_dkv": LLM_LAYERS * steps} if flash_on
            else dict.fromkeys(used, 0))
    require(used == want, f"{tag} flash launches {used}, expected {want}")
    require(rec["peak"] < 76, f"{tag} peak device memory "
            f"{rec['peak']:.2f} GiB")


def unembed_timing(dev, smi):
    """The unembedding at glm4-9b's width (B 2, S 512, d 4096, V 151,552),
    bf16 activations over the f32 weight, as the port computed it before
    (bf16 product, then cast) and now (``einsum_f32``: one bf16 GEMM with
    an f32 output), each against the product of the upcast operands."""
    from repro_torch.models.layers import einsum_f32

    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((2, 512, 4096), generator=gen, device=dev).bfloat16()
    w = torch.randn((4096, 151552), generator=gen, device=dev) * 0.02

    def old():
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype)).to(
            torch.float32)

    def new():
        return einsum_f32("bsd,dv->bsv", x, w.to(x.dtype))
    want = torch.einsum("bsd,dv->bsv", x.float(), w.bfloat16().float())
    scale = want.abs().max().item()
    gaps = {f.__name__: (f() - want).abs().max().item() / scale
            for f in (old, new)}
    times = {f.__name__: cuda_ms(f) for f in (old, new, old, new)}
    del want
    print(f"[unembed] glm4-9b width, B 2, S 512: before (bf16 product, then "
          f"f32) {times['old']:.4f} ms, {gaps['old']:.3g} of max |logit| "
          f"{scale:.3g} from the f32 product of the bf16 operands; now "
          f"(einsum_f32: one bf16 GEMM with an f32 output, aten::bmm.dtype) "
          f"{times['new']:.4f} ms, {gaps['new']:.3g} ({smi})")
    require(gaps["new"] <= 1e-5, f"einsum_f32 unembed {gaps['new']} > 1e-5")


def moe_dropped(params, arch, dev, layers=LLM_LAYERS, shape=(2, 512)):
    """The share of (token, expert) assignments each MoE layer drops at
    capacity in a no-grad forward of ``params`` (``arch`` at ``layers``
    layers) on the run's first batch of ``shape``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    tokens = next(synthetic_lm_batches(cfg.vocab, *shape, 0, dev))["tokens"]
    return moe_drop_share(lambda t: Model(cfg).forward(params, t), tokens)


def run_fed(ops, dev, smi):
    """Phase 4l (d): the federated round on (a)'s model (glm4-9b, 2
    layers), P 2 pods x E 2 local steps of 2 x 512 tokens, SGD lr 0.05
    with momentum 0.9 (0 under int8_sync), flash on, 2 rounds under each
    of none / stc (0.01) / int8 / int8_sync -> the K2 / K3 launches under
    stc / int8."""
    from repro_torch.configs import get_arch
    from repro_torch.core import federated as fed
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import Model, init_train_state
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=LLM_LAYERS)
    model = Model(cfg)
    P, E, B, S = 2, 2, 2, 512
    n_leaves = len(tree_leaves(model.defs()))
    out = {}
    for mode in ("none", "stc", "int8", "int8_sync"):
        tag = f"[fed {mode}]"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # int8_sync carries a residual a pod (13.2 GB more): at momentum
        # 0.9 its round peaked at 74.66 GiB (PERF.md, PR 24), so it runs
        # at momentum 0, the first of the planned memory cuts
        opt = sgd(0.05, momentum=0.0 if mode == "int8_sync" else 0.9)
        state = init_train_state(model, opt, torch.Generator(
            device=dev).manual_seed(0), dev)
        fcfg = fed.FedRoundConfig(local_steps=E, compression=mode,
                                  stc_sparsity=0.01)
        f = fed.init_fed_state(state, P, fcfg)
        first = sample(state.params)
        del state
        step = fed.make_fed_round_step(model, opt, fcfg, P)
        data = synthetic_lm_batches(cfg.vocab, P * E * B, S, 0, dev)
        walls, losses = [], []
        ops.reset_launch_counts()
        mattn.set_flash_attention(True)
        try:
            for _ in range(2):
                batch = {"tokens": next(data)["tokens"].view(P, E, B, S)}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f, metrics = step(f, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(metrics["local_losses"].tolist())
        finally:
            mattn.set_flash_attention(None)
        used = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaves = tree_leaves(f.train.params)
        synced = all(torch.equal(t[0], t[1]) for t in leaves)
        moved = any(not torch.equal(a, b[0].reshape(-1)[:4096].float().cpu())
                    for a, b in zip(first, leaves))
        print(f"{tag} local losses a round {[[round(x, 6) for x in r] for r in losses]}; "
              f"round wall s {[round(w, 4) for w in walls]} ({P * E} steps "
              f"+ the sync; round 1 includes first use), "
              f"{P * E * B * S / walls[-1]:.1f} tokens/s in round 2; peak "
              f"device memory {peak:.2f} GiB (target < 70); pods bit for "
              f"bit equal {synced}; launches "
              f"{ {k: v for k, v in used.items() if v} } ({smi})")
        require(all(math.isfinite(x) for r in losses for x in r),
                f"{tag} non-finite loss {losses}")
        require(synced, f"{tag} the pods ended unequal")
        require(moved, f"{tag} the params did not move")
        require(peak < 76, f"{tag} peak device memory {peak:.2f} GiB")
        want = {"stc_batched": 2 * n_leaves if mode == "stc" else 0,
                "int8_rowmax": 2 * n_leaves if mode == "int8" else 0,
                "int8_qdq": 2 * n_leaves if mode == "int8" else 0,
                "flash_fwd": 2 * P * E * 2 * LLM_LAYERS}
        got = {k: used[k] for k in want}
        require(got == want, f"{tag} launches {got}, expected {want}")
        out[mode] = used
        del f, step, leaves
    return {k: out["stc"][k] if k == "stc_batched" else out["int8"][k]
            for k in ("stc_batched", "int8_rowmax", "int8_qdq")}


def run_llm_training(repro_torch, ops, dev, smi):
    """Phase 4l -> the flash launches of (a)-(c)'s flash-on runs and the
    K2 / K3 launches of (d)."""
    release(repro_torch)
    repro_torch.set_device(None)
    print(f"[4l] device memory allocated at the start: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    unembed_timing(dev, smi)
    train_launches = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 0)

    def count(rec):
        for k in train_launches:
            train_launches[k] += rec["launches"][k]

    # (a) glm4-9b, flash on (captured, and its eager twin: bit for bit)
    # and off, and the step-1 loss's rounding reach
    with deterministic_cudnn():
        on = run_train(ops, "glm4-9b", 6, True, keep=True)
        report_train(on, "glm4-9b", True, smi)
        count(on)
        eager = run_train(ops, "glm4-9b", 6, True, keep=True, capture=False)
    train_ab(on, eager, smi)
    off = run_train(ops, "glm4-9b", 6, False)
    report_train(off, "glm4-9b", False, smi)
    probe = run_train(ops, "glm4-9b", 1, True, perturb=1)
    reach = abs(probe["losses"][0] - on["losses"][0])
    gap = abs(on["losses"][0] - off["losses"][0])
    bar = max(1e-4, 2 * reach)
    print(f"[train glm4-9b] step-1 loss flash on {on['losses'][0]:.6f}, off "
          f"{off['losses'][0]:.6f}: gap {gap:.4g}; flash on from a "
          f"1e-7-perturbed init moves it {reach:.4g} (bf16 activations); "
          f"bar max(1e-4, 2 x that) = {bar:.4g} ({smi})")
    require(gap <= bar, f"[train glm4-9b] flash on vs off at step 1: {gap} "
            f"> {bar}")
    del on, off, probe
    # (b) qwen3-moe-30b-a3b: 128 experts, top 8, FFN 768 an expert
    moe = run_train(ops, "qwen3-moe-30b-a3b", 4, True, keep=True)
    report_train(moe, "qwen3-moe-30b-a3b", True, smi)
    count(moe)
    shares = moe_dropped(moe.pop("params"), "qwen3-moe-30b-a3b", dev)
    print(f"[train qwen3-moe-30b-a3b] aux a step "
          f"{[round(m['aux'], 6) for m in moe['metrics']]}; dropped share "
          f"of (token, expert) assignments a layer at capacity 1.25, final "
          f"params, first batch: {[round(s, 4) for s in shares]}")
    require(len(shares) == LLM_LAYERS and all(0 <= s < 1 for s in shares),
            f"[train qwen3] dropped shares {shares}")
    require(all(m["aux"] > 0 for m in moe["metrics"]),
            "[train qwen3] aux is not positive")
    del moe
    # (c) three steps of each other dense arch (warm-up, capture, replay):
    # G = 6 and G = 4
    for arch in ("internlm2-20b", "phi3-medium-14b"):
        rec = run_train(ops, arch, 3, True)
        report_train(rec, arch, True, smi)
        count(rec)
    # (d) the cross-pod federated round
    fed_launches = run_fed(ops, dev, smi)
    release(repro_torch)
    return train_launches, fed_launches


def check_embed_row(dev, stc_topk, quant):
    """Phase 3: K2 and K3a / K3b on the federated round's largest row,
    glm4-9b's embedding leaf as one (1, 620,756,992) row, against their
    plain versions (STC masks, signs and nnz bitwise, values within 1 ulp;
    int8 bitwise), each timed beside its plain version; K3a as phase 3's
    row (``k3a_times``) -> K3a's times."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    x = update_rows(gen, 1, EMBED_ROW)
    what = f"(1, {EMBED_ROW})"
    ko, kn = stc_topk.stc_compress_batched(x, 0.01)
    po, pn = stc_topk.stc_plain(x, 0.01)
    torch.cuda.synchronize()
    require(torch.equal(kn.to(pn.dtype), pn), f"stc {what}: nnz differ")
    u = check_stc(ko, po, f"stc {what}")
    del ko, po
    km, ks = quant.rowmax_scale(x)
    pm = quant.rowmax_plain(x)
    s = quant.int8_scale(pm)
    require(torch.equal(km.view(torch.int32), pm.view(torch.int32))
            and torch.equal(ks.view(torch.int32), s.view(torch.int32)),
            f"int8 rowmax {what}: max or scale not bitwise equal")
    kq, ki = quant.qdq(x, s, with_q=True)
    pq, pi = quant.qdq_plain(x, s, with_q=True)
    torch.cuda.synchronize()
    require(torch.equal(kq.view(torch.int32), pq.view(torch.int32))
            and torch.equal(ki, pi), f"int8 qdq {what}: not bitwise equal")
    del kq, ki, pq, pi
    ms = {"K2": cuda_ms(lambda: stc_topk.stc_compress_batched(x, 0.01),
                        reps=5, warmup=1),
          "K2 plain": cuda_ms(lambda: stc_topk.stc_plain(x, 0.01), reps=3,
                              warmup=1),
          "K3b": cuda_ms(lambda: quant.qdq(x, s), reps=5, warmup=1),
          "K3b plain": cuda_ms(lambda: quant.qdq_plain(x, s), reps=3,
                               warmup=1)}
    k3a = k3a_times(quant, x)
    print(f"stc/int8 {what} (glm4-9b's embedding as one row): masks, signs "
          f"and nnz ({int(kn[0])}) bitwise, values <= {u:.3g} ulp; rowmax "
          f"and qdq (with its int8 q) bitwise; ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; K3a {json.dumps(k3a)}")
    del x
    return k3a


def well_conditioned(model, seed):
    """``model``'s params drawn on the CPU from ``seed`` at a
    well-conditioned scale (matrices std 1/sqrt(d_model), vectors 0.1), as
    ``tests/test_torch_train.py`` draws them: the default init saturates
    the softmax and makes a few steps chaotic."""
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    gen = torch.Generator().manual_seed(seed)
    defs, treedef = tree_flatten(model.defs())
    d = model.cfg.d_model
    out = []
    for p in defs:
        lead = 1 if p.axes and p.axes[0] == "layers" else 0
        std = d ** -0.5 if len(p.shape) - lead >= 2 else 0.1
        out.append(torch.randn(p.shape, generator=gen) * std)
    return tree_unflatten(treedef, out)


def llm_card_vs_cpu(smi):
    """Phase 5d: the reduced glm4-9b and qwen3-moe-30b-a3b train 3 steps
    (SGD lr 0.05, momentum 0.9, 2 x 32 tokens, flash on: K6/K7 on the
    card, their plain versions on the CPU), and the reduced glm4-9b runs 2
    federated rounds under stc (P 2, E 2), on the card and on the CPU from
    the same params and batches; params within max(1e-4, 2 x how far the
    card's run moves from a 1e-7-perturbed init)."""
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.core import federated as fed
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import Model, TrainState, make_train_step
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_leaves, tree_map

    def run(case, device, params):
        arch, kind = case
        cfg = get_arch(arch, reduced=True)
        model, opt = Model(cfg), sgd(0.05, momentum=0.9)
        p = tree_map(lambda t: t.to(device), params)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=device))
        if kind == "train":
            step = make_train_step(model, opt)
            data = synthetic_lm_batches(cfg.vocab, 2, 32, 3, device)
            for _ in range(3):
                state, _ = step(state, next(data))
            return [t.cpu() for t in tree_leaves(state.params)]
        fcfg = fed.FedRoundConfig(local_steps=2, compression="stc",
                                  stc_sparsity=0.01)
        f = fed.init_fed_state(state, 2, fcfg)
        step = fed.make_fed_round_step(model, opt, fcfg, 2)
        data = synthetic_lm_batches(cfg.vocab, 8, 32, 3, device)
        for _ in range(2):
            f, _ = step(f, {"tokens": next(data)["tokens"].view(2, 2, 2, 32)})
        return [t[0].cpu() for t in tree_leaves(f.train.params)]

    repro_torch.set_device(None)
    mattn.set_flash_attention(True)
    try:
        for case in (("glm4-9b", "train"), ("qwen3-moe-30b-a3b", "train"),
                     ("glm4-9b", "fed stc")):
            params = well_conditioned(Model(get_arch(case[0], reduced=True)),
                                      11)
            card = run(case, "cuda", params)
            cpu = run(case, "cpu", params)
            reach = max_diff(run(case, "cuda", perturbed(params, 1)), card)
            diff = max_diff(card, cpu)
            bar = max(1e-4, 2 * reach)
            print(f"[5d {case[0]} {case[1]}] card vs CPU: max |param diff| "
                  f"{diff:.4g} ({'within' if diff <= 1e-4 else 'above'} "
                  f"1e-4); the card from a 1e-7-perturbed init moves "
                  f"{reach:.4g}; bar {bar:.4g} ({smi})")
            require(diff <= bar, f"[5d {case}] card vs CPU {diff} > {bar}")
    finally:
        mattn.set_flash_attention(None)


# ---------------------------------------------------------------------------
# Phase 4n: a MoE transformer_lm in the batched engine; phase 4o: the dry run
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"


def qwen3_moe_2layer():
    """Qwen3-30B-A3B at its published width (d_model 2048, 32 / 4 heads of
    128, 128 experts top 8 of FFN 768, vocab 151,936), depth cut 48 -> 2,
    f32, as a ``transformer_lm`` (its QK-norm keeps the default init's
    attention unsaturated)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.llm import transformer_lm

    arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=2,
                               dtype="float32", max_seq_len=LORA_SEQ_LEN)
    return transformer_lm(arch, name="qwen3-moe-2l")


def moe_drop_share(forward, tokens):
    """The share of (token, expert) assignments each MoE layer drops at
    capacity in a no-grad ``forward(tokens)``."""
    from repro_torch.models import moe as moe_mod

    shares = []
    real = moe_mod._dispatch_local

    def spy(cfg, x_flat, top_w, top_ids, C):
        buf, meta = real(cfg, x_flat, top_w, top_ids, C)
        shares.append(1.0 - meta[-1].float().mean().item())
        return buf, meta
    moe_mod._dispatch_local = spy
    try:
        with torch.no_grad():
            forward(tokens)
    finally:
        moe_mod._dispatch_local = real
    return shares


def run_moe_lora(repro_torch, ops, flash_on, smi):
    """Phase 4n: ``qwen3_moe_2layer`` through ``init``/``run`` with phase
    4b's configuration (``lm512``: 4 of 8 clients a round, batch 4 x 512
    tokens, 2 rounds, LoRA rank 8 on attention, ``aggregation_kernel``),
    batched: every client's step under ``torch.func.vmap``, the MoE
    dispatch batched over the cohort.  -> the final adapters, the launch
    counts and the drop shares."""
    tag = f"[4n moe lora flash {'on' if flash_on else 'off'}]"
    from repro_torch.models import attention as mattn
    from repro_torch.models.lora import adapter_param_count
    from repro_torch.utils.tree import tree_leaves

    release(repro_torch)
    model = qwen3_moe_2layer()
    cfg = lora_config(model)
    repro_torch.init(cfg)
    mattn.set_flash_attention(flash_on)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = repro_torch.run()
        torch.cuda.synchronize()
    finally:
        mattn.set_flash_attention(None)
    total = time.perf_counter() - t0
    used = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = res["history"]
    walls = [h["wall_time"] for h in hist]
    rounds = cfg["server"]["rounds"]
    print(f"{tag} round wall s {[round(w, 4) for w in walls]} (round 0 "
          f"includes first use); run total {total:.3f} s (base init "
          f"included); peak device memory {peak:.2f} GiB; train_loss "
          f"{[round(h['train_loss'], 6) for h in hist]}; launches "
          f"{ {k: v for k, v in used.items() if v} } ({smi})")
    require(used["fedavg_agg"] == rounds, f"{tag} fedavg_agg launched "
            f"{used['fedavg_agg']} times, expected {rounds}")
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        require((used[k] > 0) == flash_on, f"{tag} {k} launched {used[k]} "
                f"times with the flag {'on' if flash_on else 'off'}")
    for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
        require(used[k] == 0, f"{tag} {k} launched without compression")
    require(all(math.isfinite(h["train_loss"]) for h in hist),
            f"{tag} non-finite loss")
    out = tree_leaves(res["params"])
    want = adapter_param_count(repro_torch.core.api._ctx.model,
                               LORA_CLIENT["lora_rank"],
                               LORA_CLIENT["lora_targets"])
    require(sum(t.numel() for t in out) == want,
            f"{tag} trained parameters are not the {want} adapter elements")
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"{tag} non-finite adapters")
    require(peak < 70, f"{tag} peak device memory {peak:.2f} GiB >= 70")
    shares = None
    if flash_on:
        # the drop share on the run's own data: the trained model (the
        # frozen base merged with the final adapters) on the first
        # client's first batch
        ctx = repro_torch.core.api._ctx
        cid = sorted(ctx.fed_data.clients)[0]
        tokens = torch.as_tensor(ctx.fed_data.clients[cid].x[:4],
                                 device=ctx.trainer.device)
        shares = moe_drop_share(
            lambda t: ctx.trainer.model.apply(res["params"], t), tokens)
        print(f"{tag} share of (token, expert) assignments dropped at "
              f"capacity 1.25 a layer, final params, 4 x 512 tokens: "
              f"{[round(x, 4) for x in shares]}")
        require(len(shares) == 2 and all(0 <= x < 1 for x in shares),
                f"{tag} drop shares {shares}")
    release(repro_torch)
    return {"params": [t.cpu() for t in out], "launches": used,
            "walls": walls, "peak": peak, "shares": shares}


def run_moe_lm(repro_torch, ops, smi):
    """Phase 4n: the MoE LoRA run flash on and off; the adapters within
    phase 4b's 1e-4.  -> the flash-on run's launch counts."""
    on = run_moe_lora(repro_torch, ops, True, smi)
    off = run_moe_lora(repro_torch, ops, False, smi)
    diff = max_param_diff(on["params"], off["params"])
    print(f"[4n moe lora] flash on vs off: max |adapter diff| {diff:.3g} "
          f"(bar 1e-4)")
    require(diff <= 1e-4, f"[4n] flash on vs off adapters differ by {diff}")
    return on["launches"]


def start_dryruns():
    """Start phase 4o's dry runs: ``python -m repro_torch.launch.dryrun``
    for every arch id at its train shape (train_4k on the (16, 16) mesh,
    fsdp_tp), one child process an arch, all at once, at the lowest CPU
    priority and with no card visible (they trace fake tensors on the
    CPU, so they run beside the card-bound phases 4l and 4n).  ->
    (processes, output directory, start time); an exit handler kills any
    child still running."""
    import atexit
    import tempfile

    from repro_torch.configs import list_archs

    out = tempfile.mkdtemp(prefix="dryrun-")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--out", out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(19))
        for arch in list_archs()}

    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return procs, out, time.perf_counter()


def run_dryrun_phase(dev, smi, started):
    """Phase 4o: collect the dry runs ``start_dryruns`` started (each
    record must say CUDA stayed uninitialized, and this process's device
    memory must not move meanwhile); then a reduced glm4-9b train step
    (bf16 activations), its ``TrainStep`` captured and an eager twin, 6
    steps each, timed on the card beside its counted FLOPs,
    ``model_flops`` and its roofline on one H100."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models.model import Model, TrainStep, init_train_state
    from repro_torch.optim import sgd

    procs, out, t0 = started
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    waited = time.perf_counter()
    try:
        logs = {a: p.communicate(timeout=300)[0] for a, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    waited = time.perf_counter() - waited
    for arch, p in procs.items():
        require(p.returncode == 0 and "[OK]" in logs[arch],
                f"[4o] the dry run of {arch} failed: {logs[arch][-2000:]}")
        path = os.path.join(
            out, f"{arch}__train_4k__single__train__fsdp_tp.json")
        with open(path) as f:
            rec = json.load(f)
        os.remove(path)
        rl = rec["roofline"]
        print(f"[4o dryrun {arch}] train_4k on {rec['mesh_shape']}: traced "
              f"depths {rec['traced_depths']} in {rec['trace_s']:.2f} s; "
              f"per device {rec['per_device_bytes']['total'] / 2**30:.3f} "
              f"GiB held; {rl['flops']:.4g} FLOPs, {rl['hbm_bytes']:.4g} "
              f"HBM bytes, {rl['collective_bytes']:.4g} collective bytes a "
              f"device; compute {rl['compute_s']:.4g} s, memory "
              f"{rl['memory_s']:.4g} s, collective {rl['collective_s']:.4g} "
              f"s: {rl['dominant']}-bound; model_flops / counted "
              f"{rl['useful_compute_ratio']:.3f}")
        require(rl["flops"] > 0 and rl["hbm_bytes"] > 0
                and rec["collectives"]["total_bytes"] > 0
                and rl["dominant"] in ("compute", "memory", "collective")
                and rec["device"] == {"cuda_initialized": False,
                                      "bytes_allocated": 0},
                f"[4o] {arch}: record {rl} {rec['device']}")
    os.rmdir(out)
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    print(f"[4o] the dry run of {len(procs)} arch ids, one process each "
          f"without the card, took {wall:.1f} s from their start (beside "
          f"phases 4l and 4n), {waited:.1f} s of it waited for here; this "
          f"process's device memory allocated {before} -> {after} bytes, "
          f"peak {peak}")
    require(after == before and peak == before,
            f"[4o] device memory moved: {before} -> {after}, peak {peak}")

    cfg = dataclasses.replace(get_arch("glm4-9b", reduced=True),
                              dtype="bfloat16")
    shape = InputShape("step", 1024, 8, "train")
    model = Model(cfg)
    counts = dryrun.trace_step(model, shape, "train")
    mf = roofline.model_flops(cfg, shape, text_len=model.text_len(shape))
    rl = roofline.Roofline(flops=counts["flops"],
                           hbm_bytes=counts["hbm_bytes"],
                           collective_bytes=0.0, chips=1, model_flops=mf)
    opt = sgd(0.01, momentum=0.9)
    runs = {}
    for captured in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(model, opt, torch.Generator(
            device=dev).manual_seed(0), dev)
        held = torch.cuda.memory_allocated()
        step = TrainStep(model, opt, remat=True, capture=captured)
        data = synthetic_lm_batches(cfg.vocab, 8, 1024, 0, dev)
        walls, losses = [], []
        for _ in range(6):
            batch = next(data)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            losses.append(float(metrics["loss"]))
        runs[captured] = {
            "walls": walls, "losses": losses,
            "steady": float(np.median(walls[3 if captured else 2:])),
            "peak": (torch.cuda.max_memory_allocated() - held) / 2**30,
            "reserved": torch.cuda.max_memory_reserved() / 2**30,
            "counts": (step.eager_steps, step.captures, step.recaptures,
                       step.replays)}
        del state, step
    cap, eag = runs[True], runs[False]
    steady = cap["steady"]
    print(f"[4o step] reduced glm4-9b (d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, bf16 activations), B 8 x 1024, remat, "
          f"TrainStep captured (warm-up, capture, 4 replays: counts "
          f"{cap['counts']}): step wall s {[round(w, 5) for w in cap['walls']]}"
          f", median of 4-6 {steady:.5f} s; its eager twin "
          f"{[round(w, 5) for w in eag['walls']]}, median of 3-6 "
          f"{eag['steady']:.5f} s (captured / eager x"
          f"{steady / eag['steady']:.3f}); peak GiB above the state "
          f"{cap['peak']:.3f} / {eag['peak']:.3f}, reserved "
          f"{cap['reserved']:.3f} / {eag['reserved']:.3f}; losses equal "
          f"{cap['losses'] == eag['losses']}; counted "
          f"{counts['flops']:.4g} FLOPs and {counts['hbm_bytes']:.4g} HBM "
          f"bytes (fake-tensor trace, {counts['ops']} ops), model_flops "
          f"{mf:.4g}; roofline on one {roofline.CARD}: compute "
          f"{rl.compute_s * 1e3:.4f} ms, memory {rl.memory_s * 1e3:.4f} ms "
          f"({rl.dominant}-bound), {rl.bound_s * 1e3:.4f} ms = "
          f"{100 * rl.bound_s / steady:.2f}% of the captured step, "
          f"{100 * rl.bound_s / eag['steady']:.2f}% of the eager ({smi})")
    require(all(math.isfinite(x) for x in cap["losses"] + eag["losses"]),
            "[4o step] loss")
    require(cap["counts"] == (1, 1, 0, 5) and eag["counts"] == (6, 0, 0, 0),
            f"[4o step] counts {cap['counts']} / {eag['counts']}")
    return wall


def moe_round_card_vs_cpu(smi, card="cuda"):
    """Phase 5d: one batched round of the reduced qwen3-moe-30b-a3b as a
    ``transformer_lm`` without LoRA (4 of 8 ``tiny_lm`` clients, flash on:
    K6/K7 on the card, their plain versions on the CPU), on the card and on
    the CPU from the same params; params within max(1e-4, 2 x how far the
    card's round moves from a 1e-7-perturbed start)."""
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models import attention as mattn
    from repro_torch.models.llm import transformer_lm
    from repro_torch.models.model import Model
    from repro_torch.utils.tree import tree_leaves, tree_map

    arch = get_arch(MOE_ARCH, reduced=True)
    model = transformer_lm(arch)
    cfg = {"model": model.name, "dataset": "tiny_lm",
           "data": {"num_clients": 8, "batch_size": 32},
           "server": {"rounds": 1, "clients_per_round": 4},
           "client": {"local_epochs": 1, "lr": 0.1},
           "resources": {"execution": "batched"}}
    params = well_conditioned(Model(arch), 12)

    def run(device, start):
        repro_torch.reset()
        repro_torch.set_device(device)
        repro_torch.register_model(model)
        repro_torch.init(cfg)
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = tree_map(lambda t: t.to(device), start)
        try:
            res = trainer.run()
        finally:
            repro_torch.set_device(None)
            repro_torch.reset()
        return [t.cpu() for t in tree_leaves(res["params"])]

    mattn.set_flash_attention(True)
    try:
        got = run(card, params)
        cpu = run("cpu", params)
        reach = max_diff(run(card, perturbed(params, 1)), got)
    finally:
        mattn.set_flash_attention(None)
    diff = max_diff(got, cpu)
    bar = max(1e-4, 2 * reach)
    print(f"[5d {MOE_ARCH} batched round] card vs CPU: max |param diff| "
          f"{diff:.4g} ({'within' if diff <= 1e-4 else 'above'} 1e-4); the "
          f"card from a 1e-7-perturbed start moves {reach:.4g}; bar "
          f"{bar:.4g} ({smi})")
    require(diff <= bar, f"[5d moe round] card vs CPU {diff} > {bar}")


# ---------------------------------------------------------------------------
# Phase 4m: the rest of the model zoo at published width, phase 5e
# ---------------------------------------------------------------------------

#: phase 4m: arch -> (layers (None: all), serve batch, serve length, decode
#: steps, train (batch, seq) or None); the cuts are listed in PERF.md §4
ZOO = {
    # 96 -> 1 layer: 51.4 GB of f32 params; training (params + grads >
    # 100 GB) does not fit one card
    "nemotron-4-340b": (1, 1, 1024, 8, None),
    # all 18 layers; 256 frames ahead of 256 text tokens
    "paligemma-3b": (None, 2, 256, 8, (2, 256)),
    # 27 -> 2 layers: one dense0, one MoE (64 experts, top 6, 2 shared)
    "deepseek-v2-lite-16b": (2, 2, 512, 8, (2, 512)),
    # 38 -> 3 layers: one period (rglru, rglru, local_attn); S 4096 is
    # past the 2048 window
    "recurrentgemma-9b": (3, 1, 4096, 8, (1, 4096)),
    # nothing cut: 12 + 12 layers, 1500 frames; 448 decoder tokens
    "whisper-small": (None, 4, 448, 8, (4, 448)),
}


def zoo_cfg(arch):
    from repro_torch.configs import get_arch
    layers = ZOO[arch][0]
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def flash_layers(cfg):
    """Layers whose attention the flash kernels take: global causal
    attention with v's head dim equal to q's (not MLA, not windowed, not
    the encoder's bidirectional or the cross attention)."""
    return sum(1 for m in cfg.layer_pattern if m == "attn")


def zoo_inputs(cfg, B, S, gen, dev):
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev)}
    if cfg.family in ("vlm", "audio"):
        batch["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model),
                                      generator=gen, device=dev).bfloat16()
    return batch


def serve_zoo(ops, arch, dev, smi):
    """Phase 4m's serving half of ``arch``: params from seed 0 on the card,
    three prefills (``make_prefill_step``, flash on; the first carries first
    use), then greedy decode steps from position S on through the captured
    serve step beside its eager twin (:func:`serve_ab`), each against a
    zero cache of S + steps + ``PROFILED_STEPS`` (RecurrentGemma's local
    attention: a ring of 2048 slots, past its wrap) -> (flash launches,
    peak GiB)."""
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import Model, make_prefill_step
    from repro_torch.utils.tree import tree_leaves

    _, B, S, steps, _ = ZOO[arch]
    cfg = zoo_cfg(arch)
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    batch = zoo_inputs(cfg, B, S, gen, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prefill = make_prefill_step(model)
    ops.reset_launch_counts()
    mattn.set_flash_attention(True)
    try:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        positions = S + (cfg.n_frames if cfg.family == "vlm" else 0)
        require(tuple(logits.shape) == (B, positions, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"[4m {arch}] prefill logits {tuple(logits.shape)} finite "
                f"{bool(torch.isfinite(logits).all())}")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        del logits
        peak = torch.cuda.max_memory_allocated() / 2**30
        # greedy decode from position S on a zero cache: the captured
        # step beside its eager twin
        ab = serve_ab(model, params, B, None, steps, f"4m {arch}", smi,
                      tok0=tok, start=S)
    finally:
        mattn.set_flash_attention(None)
    used = {k: ops.launch_counts()[k] for k in ("flash_fwd", "flash_dq",
                                                "flash_dkv")}
    want = {"flash_fwd": 3 * flash_layers(cfg), "flash_dq": 0,
            "flash_dkv": 0}
    require(used == want, f"[4m {arch}] serve launches {used}, expected "
            f"{want}")
    pre = float(np.mean(walls[1:]))
    dec = {c: ab[c]["ms"] for c in ab}
    peak = max(peak, ab[True]["peak"], ab[False]["peak"])
    print(f"[4m {arch} serve] {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"params; prefill B {B} x {positions} positions: walls ms "
          f"{[round(w * 1e3, 3) for w in walls]}, steady {pre * 1e3:.3f} ms "
          f"({B * positions / pre:.1f} tokens/s); decode from position {S}: "
          f"steady {dec[True]:.3f} ms a step captured, {dec[False]:.3f} "
          f"eager; peak {peak:.2f} GiB (captured decode "
          f"{ab[True]['peak']:.2f}); launches {used} ({smi})")
    require(peak < 76, f"[4m {arch}] serve peak {peak:.2f} GiB")
    del params, batch
    return used, peak


def train_zoo(ops, arch, smi, steps=4):
    """Phase 4m's training half of ``arch``: ``launch.train.main`` at its
    published width (``--full``, the layer cut of ``ZOO``), ``steps``
    SGD steps, flash on (``run_train``) -> (flash launches, the run's
    record: its final params for the MoE's drop share)."""
    layers, _, _, _, (B, S) = ZOO[arch]
    cfg = zoo_cfg(arch)
    cut = ["--full", "--batch", str(B), "--seq", str(S)]
    if layers:
        cut += ["--layers", str(layers)]
    rec = run_train(ops, arch, steps, True, keep=cfg.moe is not None,
                    cut=cut, redraw=well_conditioned_)
    positions = B * (S + (cfg.n_frames if cfg.family == "vlm" else 0))
    walls = rec["walls"]
    wall = float(np.mean(steady_walls(rec)))
    used = {k: rec["launches"][k] for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")}
    n = flash_layers(cfg)
    want = {"flash_fwd": 2 * n * steps, "flash_dq": n * steps,
            "flash_dkv": n * steps}
    tag = f"[4m {arch} train]"
    print(f"{tag} losses {[round(x, 6) for x in rec['losses']]}; step wall "
          f"s {[round(w, 4) for w in walls]} (step 1 includes first use, "
          f"step 2 the capture; counts {rec['counts']}); "
          f"steady {wall:.4f} s a step, {positions / wall:.1f} positions/s "
          f"(B {B} x {positions // B}); peak {rec['peak']:.2f} GiB; launches "
          f"{used} ({smi})")
    require(all(math.isfinite(x) for x in rec["losses"]),
            f"{tag} non-finite loss {rec['losses']}")
    require(any(not torch.equal(a, b) for a, b in zip(rec["first"],
                                                      rec["last"])),
            f"{tag} the params did not move")
    require(used == want, f"{tag} flash launches {used}, expected {want}")
    require(rec["peak"] < 76, f"{tag} peak {rec['peak']:.2f} GiB")
    return used, rec


def well_conditioned_(model, params, seed=0):
    """Redraw ``params`` in place on their device at a well-conditioned
    scale, as ``well_conditioned`` draws on the CPU (matrices std
    1/sqrt(d_model), vectors 0.1).  At the default init the trained zoo
    archs' gradients grow by orders of magnitude with depth and are not
    determined by float32 params, in the reference as in the port
    (``tests/test_torch_zoo_init.py``): launch.train's SGD reached NaN by
    its second step."""
    from repro_torch.utils.tree import tree_leaves
    gen = torch.Generator(device=tree_leaves(params)[0].device)
    gen.manual_seed(seed)
    d = model.cfg.d_model
    with torch.no_grad():
        for pd, t in zip(tree_leaves(model.defs()), tree_leaves(params)):
            lead = 1 if pd.axes and pd.axes[0] == "layers" else 0
            std = d ** -0.5 if len(pd.shape) - lead >= 2 else 0.1
            t.normal_(0.0, std, generator=gen)


def run_zoo(repro_torch, ops, dev, smi):
    """Phase 4m -> {head dim of the flash template instance: flash launches
    of the archs that run it (the instance ``flash_instance`` picks for
    the arch's head dim)}: 64 whisper's, 192 nemotron's, 256
    paligemma's."""
    release(repro_torch)
    repro_torch.set_device(None)
    out = {d: dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 0)
           for d in FLASH_DIMS}
    for arch, spec in ZOO.items():
        used, _ = serve_zoo(ops, arch, dev, smi)
        if spec[4] is not None:
            tused, rec = train_zoo(ops, arch, smi)
            used = {k: used[k] + tused[k] for k in used}
            if "params" in rec:
                shares = moe_dropped(rec.pop("params"), arch, dev,
                                     zoo_cfg(arch).n_layers, spec[4])
                print(f"[4m {arch}] dropped share of (token, expert) "
                      f"assignments a MoE layer at capacity 1.25, final "
                      f"params, first batch: {[round(x, 4) for x in shares]}")
                require(len(shares) == 1 and all(0 <= x < 1 for x in shares),
                        f"[4m {arch}] dropped shares {shares}")
            del rec
        cfg = zoo_cfg(arch)
        if flash_layers(cfg):
            dp = flash_instance(cfg.resolved_head_dim)
            require(dp in out, f"[4m {arch}] flash instance {dp} has no row")
            out[dp] = {k: out[dp][k] + used[k] for k in used}
        gc.collect()
        torch.cuda.empty_cache()
    release(repro_torch)
    return out


def zoo_card_vs_cpu(smi, card="cuda"):
    """Phase 5e: each new arch at ``reduced()`` size (f32; RecurrentGemma
    also at 3 layers, with its window 64 and a sequence of 80, so that
    ``local_attn`` is present and banded), flash on, from the same
    well-conditioned params and inputs on the card and on the CPU: the
    forward's logits, 8 stepwise decode steps' logits (cache 16; Whisper's
    ``enc_kv`` random) and one SGD-momentum train step's params, each
    within max(1e-4, 2 x how far the card's run moves from a
    1e-7-perturbed init)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import (
        Model, TrainState, make_prefill_step, make_serve_step,
        make_train_step,
    )
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_leaves, tree_map

    def run(cfg, device, params, inputs, enc_kv):
        model, opt = Model(cfg), sgd(0.05, momentum=0.9)
        p = tree_map(lambda t: t.to(device), params)
        batch = {k: v.to(device) for k, v in inputs.items()}
        logits = make_prefill_step(model)(p, batch)
        cache = model.init_cache(2, 16, device=device)
        if enc_kv is not None:
            cache["enc_kv"] = {k: v.to(device) for k, v in enc_kv.items()}
        serve, steps = make_serve_step(model), []
        for t in range(8):
            lg, cache = serve(p, cache, batch["tokens"][:, t:t + 1], t)
            steps.append(lg)
        state = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32,
                                                       device=device))
        state, _ = make_train_step(model, opt)(state, batch)
        return {"forward": [logits.cpu()],
                "decode": [torch.cat(steps, 1).cpu()],
                "train": [t.cpu() for t in tree_leaves(state.params)]}

    mattn.set_flash_attention(True)
    try:
        for arch, layers in (("nemotron-4-340b", 0), ("paligemma-3b", 0),
                             ("deepseek-v2-lite-16b", 0),
                             ("recurrentgemma-9b", 0),
                             ("recurrentgemma-9b", 3), ("whisper-small", 0)):
            cfg = get_arch(arch, reduced=True)
            if layers:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            params = well_conditioned(Model(cfg), 11)
            gen = torch.Generator().manual_seed(12)
            S = 80 if layers else 24
            inputs = {"tokens": torch.randint(0, cfg.vocab, (2, S),
                                              generator=gen)}
            if cfg.family in ("vlm", "audio"):
                inputs["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                               generator=gen)
            enc_kv = None
            if cfg.encoder_layers:
                spec = Model(cfg).cache_specs(2, 16)["enc_kv"]
                enc_kv = {k: torch.randn(v.shape, generator=gen)
                          for k, v in spec.items()}
            card_out = run(cfg, card, params, inputs, enc_kv)
            cpu = run(cfg, "cpu", params, inputs, enc_kv)
            probe = run(cfg, card, perturbed(params, 1), inputs, enc_kv)
            tag = f"[5e {cfg.name}{f' {layers} layers' if layers else ''}]"
            for what in ("forward", "decode", "train"):
                diff = max_diff(card_out[what], cpu[what])
                reach = max_diff(probe[what], card_out[what])
                bar = max(1e-4, 2 * reach)
                print(f"{tag} {what}: card vs CPU max |diff| {diff:.4g} "
                      f"({'within' if diff <= 1e-4 else 'above'} 1e-4); the "
                      f"card from a 1e-7-perturbed init moves {reach:.4g}; "
                      f"bar {bar:.4g} ({smi})")
                require(diff <= bar, f"{tag} {what}: card vs CPU {diff} > "
                        f"{bar}")
    finally:
        mattn.set_flash_attention(None)


def profile_rounds(repro_torch):
    """``--profile``: one steady-state round per compression mode and
    engine (phase 4's and 4e's configurations), and one
    of phase 4b's LoRA configuration with the flash flag on, under
    ``torch.profiler`` — device time by operator and the device's busy
    share of the round's wall time (evaluation off, so the round is the
    training round alone)."""
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models import attention as mattn

    repro_torch.set_device(None)
    runs = []
    for execution in ("batched", "sequential"):
        for mode in ("none", "stc", "int8"):
            cfg = femnist_config(mode, execution)
            cfg["server"]["test_every"] = 0
            runs.append((mode if execution == "batched"
                         else f"{execution} {mode}", cfg))
        for model in M3_MODELS:
            cfg = model_config(model, "none", execution)
            cfg["server"]["test_every"] = 0
            runs.append((f"{model} {execution} none", cfg))
    runs.append(("lora flash on", None))
    for tag, cfg in runs:
        repro_torch.reset()
        repro_torch.init(cfg or lora_config(glm4_2layer(), rounds=3))
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = trainer.model.init(
            torch.Generator().manual_seed(0), trainer.device)
        mattn.set_flash_attention(cfg is None)
        try:
            profile_round(trainer, tag)
        finally:
            mattn.set_flash_attention(None)
    repro_torch.reset()


def profile_round(trainer, tag):
    for r in range(2):                       # warm-up rounds
        trainer.run_round(r)
    profile_window(lambda: trainer.run_round(2), f"{tag}] profiled round")


def profile_window(fn, tag, detail=True):
    """Run ``fn`` once under ``torch.profiler``; print its wall time, the
    device's busy share of it and (``detail``) the top device and host
    entries -> (wall ms, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side entries (kernels, copies, memsets) carry the device
    # time; operator entries would count it a second time
    on_dev = [e for e in rows
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_dev) / 1e3
    print(f"[{tag}: wall {wall * 1e3:.2f} ms, device "
          f"busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{sum(e.count for e in on_dev)} device entries (kernels, copies, "
          f"memsets)")
    if not detail:
        return wall * 1e3, busy
    for e in sorted(on_dev, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    flash = [e for e in on_dev if "flash_" in e.key]
    if flash:
        ms = sum(dev_us(e) for e in flash) / 1e3
        print(f"    flash kernels: {ms:.3f} ms in "
              f"{sum(e.count for e in flash)} launches "
              f"({100 * ms / busy:.1f}% of the device busy time, "
              f"{100 * ms / (wall * 1e3):.1f}% of the wall)")
        for e in sorted(flash, key=dev_us, reverse=True):
            print(f"      {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{100 * dev_us(e) / 1e3 / busy:5.1f}% of busy  "
                  f"{e.key[:70]}")
    cpu = sorted(rows, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    print(f"[{tag}: top host self time:")
    for e in cpu:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    return wall * 1e3, busy


def profile_rwkv6():
    """``--profile``: one ``rwkv6-1.6b`` prefill (16 x 512 tokens) and 8
    decode steps at batch 16, phase 4c's configuration, after one warm-up
    of each; the decode steps through the captured serve step (8 replays)
    and through its eager twin."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import (
        Model, make_prefill_step, make_serve_step,
    )

    model = Model(get_arch("rwkv6-1.6b"))
    params = model.init(torch.Generator().manual_seed(0))
    dev = params["embed"].device
    tokens = torch.randint(0, model.cfg.vocab, (RWKV_BATCH, RWKV_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    prefill = make_prefill_step(model)
    prefill(params, {"tokens": tokens})
    profile_window(lambda: prefill(params, {"tokens": tokens}),
                   f"rwkv6] prefill {RWKV_BATCH} x {RWKV_PROMPT}")
    for capture in (True, False):
        # the captured step (the default on the card: call 1 eager, call 2
        # captured, then replays) beside its eager twin
        step = make_serve_step(model, capture=capture)
        cache = model.init_cache(RWKV_BATCH, RWKV_SERVE_PROMPT + 16)

        def decode(first):
            for i in range(8):
                step(params, cache, tokens[:, i:i + 1], first + i)
        decode(0)
        profile_window(lambda: decode(8),
                       f"rwkv6] 8 decode steps at batch {RWKV_BATCH}, "
                       f"{'captured (replays)' if capture else 'eager'}")
        del step, cache


def profile_zoo(arch):
    """``--profile paligemma``: one steady prefill and one steady train step
    of ``arch`` at phase 4m's configuration (``ZOO``: params from seed 0,
    flash on; the train step through ``launch.train.main`` from the
    well-conditioned redraw), each after warm-up calls, under
    ``torch.profiler``: device time by kernel, the flash kernels' (K6 /
    K7a / K7b) share and the busy share."""
    from repro_torch.launch import train
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import Model, make_prefill_step

    dev = torch.device("cuda", 0)
    layers, B, S, _, (tb, ts) = ZOO[arch]
    cfg = zoo_cfg(arch)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    batch = zoo_inputs(cfg, B, S, gen, dev)
    prefill = make_prefill_step(model)
    real = train.TrainStep
    done = []

    class Profiled(real):
        def __call__(self, state, batch):
            if not done:
                well_conditioned_(self.model, state.params)
            done.append(1)
            if len(done) < 3:      # the warm-up step and the capture
                return super().__call__(state, batch)
            out = []
            profile_window(lambda: out.append(
                super(Profiled, self).__call__(state, batch)),
                f"{arch}] train step (replayed) B {tb} x {ts} tokens")
            return out[0]

    positions = S + (cfg.n_frames if cfg.family == "vlm" else 0)
    mattn.set_flash_attention(True)
    train.TrainStep = Profiled
    try:
        for _ in range(2):
            prefill(params, batch)
        profile_window(lambda: prefill(params, batch),
                       f"{arch}] prefill B {B} x {positions} positions")
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        cut = ["--full", "--batch", str(tb), "--seq", str(ts)]
        if layers:
            cut += ["--layers", str(layers)]
        train.main(["--arch", arch, *cut, "--steps", "3", "--log-every",
                    "1"])
    finally:
        train.TrainStep = real
        mattn.set_flash_attention(None)


def cards_ms(fn, reps=REPS, warmup=3):
    """Median host time of ``fn`` in milliseconds, every card synchronized
    before and after each call (the work spans cards, so one card's
    events would miss the others')."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cards_check():
    """``--cards``: the sharded cohort over distinct cards, one shard a
    card (the largest power-of-two count of the cards, at least 2).

    (a) The sharded routes of K1-K3 at (16, 6,603,710) f32 with each row
    block on its own card: bit for bit the same route over as many shards
    of the first card, K1 (fanout 0 and 2) within 1e-6 relative of flat
    K1, K2 / K3 bit for bit the unsharded kernels, each output block on
    its card; timed on the host clock beside the one-card route.  (b)
    Phase 4j's femnist runs on the default devices (every card): fused
    stc, hierarchical stc at fanout 2, staged int8 and fused stc under
    ``FAULTS_4G``, each against the unsharded run of its mode on the
    first card within max(1e-4, 2 x that run's 1e-7-perturbed reach), and
    printed against the same shards on the first card alone.  (c)
    ``tiny_lm`` LoRA with the flash flag on (K6 / K7 on every card),
    batched, against its unsharded run (1e-4).  Every card must have held
    the run's tensors."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.exit("--cards needs two or more CUDA cards")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.core.batched import build_client_mesh
    from repro_torch.core.config import Config
    from repro_torch.kernels import build, fedavg_agg, ops, quant, stc_topk
    from repro_torch.models import attention as mattn
    from repro_torch.models.small import femnist_cnn

    secs = build.build_all()
    print(f"built {sorted(secs)}")
    repro_torch.set_devices(None)
    cards = build_client_mesh()          # every card: the default devices
    k = cards.size
    dev = cards.devices[0]
    one = build_client_mesh([dev] * k)
    print(f"[cards] {k} shards on {[str(d) for d in cards.devices]}")

    phase(f"cards (a). the sharded routes, one row block a card, k = {k}")
    gen = torch.Generator(device=dev).manual_seed(4321)
    n, d = N_BUCKET, sum(sz for _, sz in femnist_shapes())
    x = update_rows(gen, n, d)
    w = torch.rand((n,), generator=gen, device=dev)
    w /= w.sum()
    mine = list(x.chunk(k))
    spread = [b.to(c) for b, c in zip(mine, cards.devices)]
    flat = fedavg_agg.fedavg_aggregate(x, w)
    for fanout in (0, 2):
        got = fedavg_agg.fedavg_aggregate_sharded(spread, w, cards,
                                                  fanout=fanout)
        want = fedavg_agg.fedavg_aggregate_sharded(mine, w, one,
                                                   fanout=fanout)
        rel = ((got - flat).abs().max()
               / flat.abs().max().clamp_min(1e-30)).item()
        require(got.device == dev and torch.equal(got, want),
                f"K1 sharded fanout {fanout}: the cards' route differs from "
                f"the one-card route")
        require(rel <= 1e-6, f"K1 sharded fanout {fanout}: rel {rel}")
        print(f"K1 sharded k={k} fanout {fanout}: one card a shard = one "
              f"card for all, bit for bit; {rel:.3g} relative from flat K1; "
              f"{cards_ms(lambda: fedavg_agg.fedavg_aggregate_sharded(spread, w, cards, fanout=fanout)):.4f}"
              f" ms over the cards, {cards_ms(lambda: fedavg_agg.fedavg_aggregate_sharded(mine, w, one, fanout=fanout)):.4f}"
              f" ms on one card (host clock; {smi})")
    base = [*stc_topk.stc_compress_batched(x, 0.01),
            *quant.int8_roundtrip_batched(x)]
    for name, fn in (
            ("K2", lambda b, m: stc_topk.stc_compress_batched_sharded(
                b, 0.01, m)),
            ("K3", lambda b, m: quant.int8_roundtrip_batched_sharded(b, m))):
        out, aux = fn(spread, cards)
        require([t.device for t in out] == list(cards.devices),
                f"{name} sharded: output blocks off their cards")
        got = [torch.cat([t.to(dev) for t in out]),
               torch.cat([t.to(dev) for t in aux])]
        require(same_bits_tree(got, base[:2] if name == "K2" else base[2:]),
                f"{name} sharded over the cards: not bit for bit the "
                f"unsharded kernel")
        print(f"{name} sharded k={k}: bit for bit the unsharded kernel; "
              f"{cards_ms(lambda: fn(spread, cards)):.4f} ms over the cards,"
              f" {cards_ms(lambda: fn(mine, one)):.4f} ms on one card (host "
              f"clock; {smi})")
    del x, mine, spread, base

    phase(f"cards (b). femnist_cnn through init/run, distributed='data' "
          f"over {k} cards")
    init = femnist_cnn().init(torch.Generator().manual_seed(Config().seed))
    faults = dict(FAULTS_4G,
                  max_update_norm=update_norm_bound(repro_torch, dev)[0])
    repro_torch.set_device(None)
    bases = {}
    for tag, mode, kw in (("stc", "stc", {}), ("int8", "int8", {}),
                          ("faults stc", "stc", {"faults": faults})):
        _, params = run_slice(repro_torch, ops, mode, tag=f"unsharded {tag}",
                              **kw)
        cfg = femnist_config(mode, "batched")
        if "faults" in kw:
            cfg["faults"] = faults
        bases[tag] = (params, conditioning_gap(repro_torch, cfg, init, params,
                                               seeds=(1, 2)))
    runs = (("fused stc", "stc", "stc", {}, {}),
            ("hierarchical stc fanout 2", "stc", "stc",
             {"resources": {"aggregation_topology": "hierarchical",
                            "aggregation_fanout": 2},
              "k1": "fedavg_agg_tree"}, {}),
            ("staged int8", "int8", "int8",
             {"resources": {"round_fusion": "off"}, "per_round": (3, 1)}, {}),
            ("faults stc", "stc", "faults stc", {}, {"faults": faults}))
    try:
        for tag, mode, vs, kw, extra in runs:
            got = {}
            for where, devices in (("cards", None), ("one card", [dev] * k)):
                repro_torch.set_devices(devices)
                _, got[where] = run_slice(
                    repro_torch, ops, mode, tag=f"{where} {k} {tag}",
                    shards=k, resources=dict(kw.get("resources", {}),
                                             distributed="data"),
                    **{a: b for a, b in kw.items() if a != "resources"},
                    **extra)
            params, reach = bases[vs]
            diff = max_diff(got["cards"], params)
            bar = max(1e-4, 2 * reach)
            print(f"[cards {k} {tag}] final params vs the unsharded {vs} "
                  f"run: max |diff| {diff:.4g} "
                  f"({'within' if diff <= 1e-4 else 'above'} 1e-4; its "
                  f"1e-7-perturbed reach {reach:.4g}; bar {bar:.4g}); vs "
                  f"the same {k} shards on one card "
                  f"{max_diff(got['cards'], got['one card']):.4g}; round "
                  f"walls {WALLS[f'cards {k} {tag}']} s over the cards, "
                  f"{WALLS[f'one card {k} {tag}']} s on one card ({smi})")
            require(diff <= bar, f"[cards {tag}] {diff} > {bar}")
    finally:
        repro_torch.set_devices(None)

    phase(f"cards (c). tiny_lm LoRA, flash on, batched over {k} cards")
    lora = {"model": "tiny_lm", "dataset": "tiny_lm",
            "data": {"num_clients": 8, "batch_size": 32},
            "server": {"rounds": 2, "clients_per_round": 4},
            "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
                       "lora_rank": 4, "lora_alpha": 8.0,
                       "lora_targets": ("attn",)}}
    out = {}
    mattn.set_flash_attention(True)
    try:
        for dist in ("none", "data"):
            repro_torch.reset()
            repro_torch.init(dict(lora, resources={
                "execution": "batched", "distributed": dist}))
            ops.reset_launch_counts()
            out[dist] = repro_torch.run()
            used = ops.launch_counts()
            require(used["flash_fwd"] > 0, f"LoRA {dist}: no flash launch")
    finally:
        mattn.set_flash_attention(None)
        repro_torch.reset()
    diff = max_param_diff(out["data"]["params"], out["none"]["params"])
    print(f"[cards {k} LoRA flash] adapters vs unsharded: max |diff| "
          f"{diff:.3g} (bar 1e-4); flash launches of the sharded run "
          f"{ {c: v for c, v in used.items() if c.startswith('flash')} }")
    require(diff <= 1e-4, f"LoRA over the cards: {diff} > 1e-4")
    held = [torch.cuda.max_memory_allocated(i) / 2**30 for i in range(k)]
    print(f"[cards] peak memory a card, GiB: {[round(h, 2) for h in held]}")
    require(all(h > 0 for h in held), "a card held no tensor")
    print(f"chip_smoke.py --cards took {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"ok": True, "cards": k}))


if __name__ == "__main__":
    if sys.argv[1:] in (["--profile"], ["--profile", "rwkv6"],
                        ["--profile", "paligemma"]):
        if not torch.cuda.is_available():
            sys.exit("CUDA is not available; --profile needs a CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import repro_torch as _rt
        from repro_torch.kernels import build as _build
        _build.build_all()
        if sys.argv[2:] == ["paligemma"]:
            profile_zoo("paligemma-3b")
        else:
            if sys.argv[2:] != ["rwkv6"]:
                profile_rounds(_rt)
            profile_rwkv6()
    elif sys.argv[1:] == ["--resume-check"]:
        if not torch.cuda.is_available():
            sys.exit("CUDA is not available; --resume-check needs a CUDA "
                     "card")
        resume_check()
    elif sys.argv[1:] == ["--cards"]:
        cards_check()
    elif sys.argv[1:]:
        sys.exit(f"usage: python3 chip_smoke.py [--profile [rwkv6 | "
                 f"paligemma] | "
                 f"--resume-check | --cards]; got {sys.argv[1:]}")
    else:
        main()
