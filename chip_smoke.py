#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main paths — plan gemma-2b onto 128x10 crossbars, alone
and through a persistent ``CrossbarPool`` with plane codecs, then serve it
from the packed bits and from int8 planes, each generation's decode one
CUDA graph (held to the eager per-token loop, greedy and sampled), and
run the serving-throughput benchmark; plan yi-6b and serve it the same
ways — at each model's full width with the depth cut to 1 layer; then the
paper's planner figures on its models' published shapes, held to the
reference's integers; train internlm2-1.8b at full width (2 layers) with
checkpoints, a resume and redeploy pricing; the accuracy halves of
Figs. 9/10 and accuracy_e2e on a trained LM, held to the reference's;
gemma-2b planned and served under the offset_binary encoding; the
pool-wear, plane-codec and redeploy-delta benchmarks, held to the
reference's numbers; and gemma-2b planned through a pool with stuck cells,
served from the fault-leveled bits and from drifted operands, and scrubbed
and repaired after a fault storm; gemma-2b served by the
continuous-batching engine, every dispatch a CUDA graph; and yi-6b and
gemma-2b split over tensor-parallel shards, deployed over per-shard pools
and served by fleets of engine replicas under chaos; and qwen2-moe-a2.7b
(1 layer) planned and served from its bits with every expert stack one
grouped kernel launch; deepseek-v2-236b (1 layer) with MLA; hymba-1.5b
(2 layers), attention beside Mamba heads with meta tokens and
sliding-window ring caches; xlstm-350m (8 layers), the recurrent mLSTM
and sLSTM blocks with no attention; seamless-m4t-medium (2 + 2 layers),
the encoder-decoder with a cross-attention cache;
and internvl2-76b (1 layer) behind its 256-position patch-embedding
prefix; then counts gemma-2b's decode_32k dry-run cell on the host and
holds the count to the card — and holds each hand-written kernel against
its plain PyTorch version on the card.
Phases (one line each, any failed check exits 1):

  1. card + build: name and power limit, the kernels built from csrc/;
  2. B1 (Hamming pricing) == its plain version, exactly;
  3. B2 (packed CIM matmul) vs its plain version at gemma-2b's shapes and
     yi-6b's f32 LM head (M = 4, K = 4096, N = 64000), within
     |d| <= 2 * eps_f32 * K * (|x| @ |w|) (the two sum K products in
     different orders, each within K * eps of exact), bf16 x on its
     tensor-core kernel and f32 x on its FMA kernel;
     B4 (the zero-tile skipping twin) == B2 bit for bit on synthetic
     operands with 0-90% zero tiles, with and without permuted plane_ids,
     on both kernels;
     B5 (int8-plane matmul, both modes, cols 10 and 16, M from 1 to 300)
     vs its plain version, same bound, bf16 fused_dequant on its
     tensor-core kernel and the rest on its FMA kernel;
     B3 (flash attention) vs its plain version at yi-6b's and gemma-2b's
     serve shapes and a 2048-token prefill of each, causal / bidir /
     swa(256), scalar and per-row offsets and valid lengths, f32 (FMA
     kernel) within 2e-5 (abs + rel) and bf16 (tensor-core kernel) within
     one bf16 ulp more; and at the reduced configs' head dims 16, 20 and 32
     (f32, S = 64), where a bf16 call raises;
     B6 (bitslice) == its plain version bit for bit on [4, 4096, 11008]
     weights with planted .5 ties, aligned and at a 4-byte offset, on
     ragged N, and on stacks of more than 65535 rows and layers;
     B2/B4 with plane_ids that are not a permutation give all-NaN on the
     tensor-core kernel (after phase 4b, on planned operands);
  4. plan: build_deployment on the card, B1 launches > 0, and one stacked
     tensor planned again on the CPU with an identical report and w_hat;
     plan-pool: the same model through a CrossbarPool with the const_rle
     codec, its wear and endurance horizon; the pool's state and wear after
     segments/0/attn/wk equal a CPU pool's;
  5. serve: generate with fp, cim-dense and cim-packed weights; B2 launches
     over one packed generate == 7 * layers * gen; then cim-packed
     const_rle (B4, tokens == raw-packed of the same plan) and cim-planes_int8
     (planes built by B6, one launch per operand dict; B5), each launching
     7 * layers * gen times with no plain-version call;
     col_perm_rle at 1 layer (B4 with plane_ids, 7 * gen launches);
     every generate runs B3 once per layer in its prefill, on the
     tensor-core kernel (B3_tc), and every bf16 matmul on the tensor-core
     kernel of B2, B4 or B5 (B2_tc, B4_tc, B5_tc).  Every variant is
     served through the decode loop's CUDA graph (``loop="scan"``) and the
     eager per-token loop (``loop="python"``): the same tokens bit for bit,
     and the same launches, counted for the graph from the kernel nodes
     of the captured graph and from the wrappers' counts during the
     capture, each times the replays (the profiler's kernel records no
     more than these), for the eager loop by the wrappers;
     sampled: gemma cim-packed, seed 0, the same tokens through both
     loops, and the first step's Gumbel noise on the card equal to the
     CPU's bit for bit;
  5a. serve-throughput: ``benchmarks_torch.serving_throughput.run`` at
     gemma-2b's full width (1 layer, batch 4, prompt 32, gen 16, greedy):
     fp / cim-dense / cim-planes_int8 / cim-packed through both loops,
     passes interleaved, best of 5; the device-busy share of one traced
     generate per loop for cim-packed and cim-planes_int8;
  5b. yi-6b: plan at full width (1 layer), CPU re-plan of
     segments/0/attn/wk; B6 planes of every planned tensor == the route
     before B6 (q = round(|w_hat| / scale)); serve fp, cim-dense,
     cim-packed and cim-planes_int8 with (7 * layers + 1) * gen B2 / B5
     launches (the +1: the planned LM head, whose f32 activations take the
     FMA kernels), B3 = layers per prefill, graph and eager loop alike;
  5c. figures: the paper's planner figures (fig5-fig8, fig9's and fig10's
     transition sweeps) and planner_throughput's gemma-2b-scale plan on the
     card at the size of benchmarks_torch/golden/reference.json, every
     integer equal to the reference's and every speedup the same float; B1
     launches > 0, nothing else, no plain-version call; the planner's CPU
     plan identical to the card's; B1 timed at the figures' pair shape;
     bool-oracle: the planner's impl="bool" oracle (bool planes, per-chain
     loops, the step-by-step stucking walk; plain torch, no kernel and no
     plain-version call) on the card at BOOL_PLAN (gemma-2b x1, 750k
     weights a tensor), stateless (planner_throughput.run: packed, bool and
     the CPU's packed plan, reports and w_hat bytes identical) and through a
     persistent lpt pool each (reports, w_hat bytes, pool state and wear
     identical); both walls printed;
  5d. train: launch.train's loop at internlm2-1.8b's full width (2 layers,
     bf16 on f32 masters, lm task, batch 8 x 128, 8 steps, checkpoints and
     redeploy pricing every 4): losses finite and falling, each within
     2e-3 of the reference's (golden "trainer", the same cell on XLA:CPU),
     the bf16 step-1 loss between 1e-6 and 4e-4 of the f32 loss of the same
     params (so the step computes in bf16, close to f32), the redeploy log
     of the reference's structure for head/w and the MLP stack, B1 > 0, B3
     0, blockwise_attention once a layer a step and no other plain version;
     then again from the step-4 checkpoint, bit-identical to the straight
     run under deterministic algorithms; one step traced;
  5e. accuracy: the reference's trained-LM setting (reduced internlm2, 120
     steps, copy task) trained on the card from the reference's key and
     batches, its losses within 1e-3 of the reference's; fig9's p sweep,
     fig10's column sweep and accuracy_e2e on the reference's weights
     (golden npz: every prediction, total and speedup equal, the probes
     within 1e-5, logit KL also within 5% of the reference's) and on the card-trained weights (accuracies within
     0.01 / 0.02, speedups within 1%); B3 = 272 on the FMA kernel at head
     dim 16, B1 > 0, no plain-version call;
  5f. offset-binary: gemma-2b at full width (1 layer) planned with
     ``CrossbarSpec(encoding="offset_binary")`` (p_stuck 0.5, min_size
     4096), its totals beside the sign_magnitude plan's; served dense,
     packed (B2), packed const_rle (B4) and planes_int8 (B6 builds on
     w_hat - offset, B5 serves) through the graph and the eager loop with
     the serve gates above (launches 7 * layers * gen, tokens equal across
     loops, const_rle == raw-packed, prefill logits within dense's bound,
     no plain-version call); no packed sign bit set; B6's integers ==
     round((w_hat - offset) / scale) on every planned tensor;
  5g. bench-extra: benchmarks_torch.pool_wear (3 deployments, the
     reference's drift stds), plane_compression (the golden's caps, gen 4)
     and redeploy_delta, each on the card: every pool_wear integer and
     float, every plane_compression transition and byte count and every
     redeploy_delta integer on the reference's weights equal to the
     golden file's; tokens_match_dense for every codec (served through
     B2/B4; whether the tokens equal the reference's is printed, not
     gated); the card's own redeploy chain's speedups within 1% of the
     reference's; B1/B2/B4 counted, no plain-version call;
  5h. faults: gemma-2b at full width (1 layer) through a 32-crossbar pool
     with stuck cells (1e-3 each way, 25% hotspots at 8x, PRNGKey(42)),
     planned with leveling none and fault beside a fault-free plan; a CPU
     pool with the same faults gives the same damage matrices, assignment,
     state, wear, achieved_read and w_hat up to segments/0/attn/wk; the
     fault-leveled plan served packed (B2) and planes_int8 (B6, B5) through
     the serve gates, the shadow-batch KL of each plan printed; drifted
     operands (stuck 1e-3, drift 0.05, IR 0.1) in one prefill on B2's FMA
     kernel with gains (B2_gain = 7 x layers, no plain-version call), each
     drifted layer matmul within B2's bound of densify_operands @ x; an
     integrity deployment (2 spare columns, 65536 tiles a round) stormed
     (2e-7 flips, 2e-8 stuck) and scrubbed to a clean cycle: detected,
     reads restored, repair <= 0.5x a full reprogram, B1 > 0, the rebuilt
     packed deployment serving the pre-storm tokens; fault_tolerance and
     integrity_scrub on the card equal to the golden file (integers; float64
     KLs within 5%);
  5i. engine: the reduced f32 gemma-2b's parity cell on the card against
     the golden file (the parity trace through dense and packed, fused and
     split: streams equal, a departure only at the reference's near ties;
     stats and shapes equal; run_overcommit's integers, the hot redeploy's
     and the engine scrub's counters equal); then gemma-2b at full width
     (ENGINE_LAYERS = 1 layer, bf16) planned as phase serve plans it and
     served by the engine (8 slots, page 16, chunk 32, quantum 8) dense, packed (B2),
     const_rle through a pool (B4) and planes_int8 (B6 builds, B5 serves),
     fused and split, on a 16-request chat trace (prompts 8-96, gen 2-64,
     every fourth request sampled) with every arrival at 0.0: each stream
     equal to the request's solo generate and fused equal to split, a
     departure allowed only where the top-2 gap (logits + Gumbel noise for
     a sampled request) is below 2e-2 of the largest |logit|; every
     dispatch a replayed CUDA graph whose kernel nodes are 7 x layers
     CIM launches a decode step and a chunk stage, and B3 x layers a chunk
     stage (per-row offsets and lengths, tensor cores), the wrappers
     counting each graph's warm-up and capture, no plain-version call;
     B2/B4/B5 at every bucketed M and B3 at every (C, pages) bucket within
     their bounds of the plain versions; run_overcommit at full width in
     swap and recompute mode (all complete, preemptions >= 1, swap-ins >=
     1 with swap), its streams equal to a roomy pool's; then
     engine_throughput.run at full width (static, split, fused, best of 3
     interleaved; latency and TTFT percentiles; graphs and their memory;
     the device-busy share of one traced fused and one static pass);
  5j. tp-fleet: tensor parallelism and the fleet, yi-6b and gemma-2b at
     full width with the depth cut to TP_LAYERS = 1.  tp_generate of yi-6b
     (bf16, packed) at n = 1, 2, 4 (plan_tp shards
     attention and MLP at each: 8 q / 1 KV head and K slices 1024 / 2752 at
     4) and planes_int8 at n = 2, gemma-2b packed and const_rle at n = 2
     (MQA attention replicated, its reason printed; the MLP's column shards
     on B4, its row shards on B2), each through the serve gates (graph ==
     eager loop, launches exact: a matmul once a shard of its component a
     step) and equal to solo generation, departures only at near ties;
     B2 / B5 on K- and N-sliced yi operands, B4 on an N-sliced const_rle
     one, B3 at yi's local heads, each within its bound of its plain
     version; Engine(tp=2) on yi-6b packed, fused and split, a 16-request
     trace: streams equal to solo, fused equal to split, every dispatch a
     graph replay with exact node counts; gemma-2b planned over 2
     per-shard pools (build_sharded_deployment) with every report and w_hat
     equal to the unsharded plan's and the summed wear equal to the
     unsharded pool's, then a ShardedScrub storm on two integrity pools
     scrubbed and repaired with the pre-storm tp=2 tokens; fleets of
     gemma-2b packed replicas on the card (kill 1 of 4 with and without
     host state, a 2 s stall hedged, admission past a 4-deep queue, 2
     replicas x 2 shards with a crash): every admitted request completed,
     streams equal to solo (near ties aside), a replica alive, launches
     from each engine's graph nodes x replays; fleet_tolerance at the
     reference's reduced settings, every wall-clock-free field equal to
     the golden file;
  5k. moe: qwen2-moe-a2.7b at published width (d_model 2048, 16 heads, 60
     routed experts allocated as 64 + 4 shared, top-4, d_expert 1408, vocab
     151936, untied head), depth cut 24 -> 1: one stateless plan (the
     [1, 64, 2048, 1408] expert stacks and the [1, 2048, 60] router planned
     whole; the router re-planned on the CPU, report and w_hat equal)
     served fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves),
     then a const_rle plan through one pool served raw-packed (B2) and
     const_rle (B4, tokens == raw-packed), each through the serve gates:
     (11 x layers + 1) x gen CIM launches a generate (each expert stack's
     three matmuls ONE grouped launch each), 10 x layers x gen on the
     tensor cores, B3 = layers, prefill logits within dense's bound; peak
     memory printed.  Then the grouped B2, B4 (~50% zero tiles) and B5 at
     the expert shapes (G 64, M 8 and 11, K x N 2048 x 1408 and 1408 x
     2048, bf16 and f32 x): one launch each, within the bound of the plain
     version, bit-equal to 64 single launches on the same launch plan, B4
     == B2; timed (bf16, wi_gate's shape) beside 64 single launches,
     torch.bmm on dense bf16 weights and the byte bound;
     moe-sharded: the sharded MoE dispatch (models.moe.set_moe_distribution)
     at MOE_MESHES, both EP (16 of the 64 experts a shard, the shared GLU's
     5632 -> 1408): fp and dense served through the serve gates (the
     decode one CUDA graph, its nodes counted, B3 = layers, no CIM
     launch) with the f32 prefill logits equal to the unsharded prefill of
     each data shard's rows alone within F32_LOGIT_RTOL of the largest
     logit, and the bf16 tokens equal to the unsharded generate of each data
     shard's rows but at near ties (tp-fleet's rule); a packed deployment
     under a mesh raises ValueError (ROADMAP C.15); the decode graph's node
     count beside the unsharded one's;
  5l. mla: deepseek-v2-236b at published width (d_model 5120, 128 heads,
     MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128, 160 routed
     experts + 2 shared, top-6, d_expert 1536, vocab 102400, untied head),
     depth cut 60 -> 1 (MLA_LAYERS): the SWS sort kernel on one
     [1, 160, 5120, 1536] expert stack == torch.sort(stable=True) bit for
     bit, timed; a const_rle plan through one pool served raw-packed (B2)
     and const_rle (B4, tokens == raw-packed); one stateless plan (each
     tensor's bytes in flight printed, the expert stacks' at most
     PLAN_BYTES_PER_WEIGHT; wkv_a re-planned on the CPU, report and w_hat
     equal) served fp, dense, packed (B2) and planes_int8 (B6 builds, B5
     serves; the f32 originals freed first), each through the serve gates:
     (11 x layers + 1) x gen CIM launches a generate (MLA's wq_a, wq_b,
     wkv_a and wo, the router, the shared GLU's 3, each expert stack's 3 as
     ONE grouped launch), 10 x layers x gen on the tensor cores, no B3 (the
     prefill's attention is blockwise_attention, once a layer, as the
     reference's); prefill logits within dense's bound (bf16: the rows
     whose last token kept its experts); the fp generate under MLA_MESH
     (expert-TP: 160 % 3 != 0, d_expert 1536 -> 512 and the shared 3072 ->
     1024 a shard) through the serve gates, as in moe-sharded; whether the
     batched @ copies an expert-TP shard's strided view (torch.profiler's
     op records of one call, timed against a contiguous copy); then the
     grouped B2, B4 and B5 at G 160, M 8, K x N 5120 x 1536 and 1536 x
     5120;
  5m. hymba: hymba-1.5b at published width (d_model 1600, 25 heads over 5
     KV heads at head dim 64, d_ff 5504, vocab 32001, untied head, SSM
     state 16, conv 4, expand 2, chunk 16, window 1024, 128 meta tokens),
     depth cut 32 -> 2 (HYMBA_LAYERS: one hymba_global layer, one
     hymba_swa; min_size HYMBA_MIN_SIZE): a const_rle plan through one pool served raw-packed (B2)
     and const_rle (B4, tokens == raw-packed); one stateless plan served
     fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves), each
     through the serve gates: (11 x layers + 1) x gen CIM launches a
     generate (attention's 4, the Mamba projections' 4, the MLP's 3 a
     layer; the head), 11 x layers x gen on the tensor cores, B3 = B3_tc =
     layers at D = 64 a prefill, no blockwise_attention; prefill logits of
     packed and planes_int8 within dense's bound; then a packed generate
     of a 1024-token prompt (1,152 positions with the meta tokens: the swa
     mask at the published window, the ring roll and wrap) through the
     serve gates, its last decode logits within 2e-2 of forward's largest
     over the whole sequence.  B2 / B4 / B5 at the Mamba projections'
     x_proj [3200, 132] and dt_proj [100, 3200] (the kernels' non-vec
     branches) run with the kernel checks of phase 3, B3 at hymba's layout
     with phase 3's B3 cases;
  5n. xlstm: xlstm-350m at published width (d_model 1024, 4 heads, mLSTM
     inner width 2048 at head dim 512, sLSTM head dim 256, conv 4, chunk
     256, vocab 50304, untied head), depth cut 24 -> 8 (XLSTM_LAYERS: seven
     mlstm layers and one slstm): a const_rle plan through one pool served
     raw-packed (B2) and const_rle (B4, tokens == raw-packed); one
     stateless plan served fp, dense, packed (B2) and planes_int8 (B6
     builds, B5 serves), each through the serve gates: (6 x mlstm + 2 x
     slstm + 1) x gen CIM launches a generate, all but the f32 head's on
     the tensor cores, no B3 and no blockwise_attention; ``r`` and the conv
     taps served dense; f32 prefill logits of packed and planes_int8 within
     dense's bound; then a packed generate of a 300-token prompt (two
     mLSTM chunks, the second padded) through the serve gates, and the
     decode after it and after a 2-token prompt (shorter than the conv:
     ROADMAP C.13) against forward at every decoded position, in f32 within
     1e-3 of forward's largest logit.  The bf16 logit comparisons are
     printed beside 2e-2, not held: the random-weight xLSTM amplifies one
     bf16 rounding ~30x, so any two bf16 computations that round at
     different points part by more.  B2 / B4 / B5 at w_if [1024, 8] (the
     narrowest N served) and wq [2048, 2048], M 4 and 128, run with the
     kernel checks of phase 3;
  5o. seamless: seamless-m4t-medium at published width (d_model 1024, 16
     heads over 16 KV heads at D 64, d_ff 4096, vocab 256206, untied head;
     the audio frontend stubbed by make_batch's src_embeds, 32 frames),
     depth cut 12 + 12 -> 2 + 2 (SEAMLESS_LAYERS, both stacks): a
     const_rle plan through one pool served raw-packed (B2) and const_rle
     (B4, tokens == raw-packed); one stateless plan served fp, dense,
     packed (B2) and planes_int8 (B6 builds, B5 serves), each through the
     serve gates: a prefill 1 + 7 x enc + 11 x dec + 1 CIM launches
     (src_proj, the encoder's 7 a layer, the decoder's self 4 + cross 4 +
     MLP 3, the head), each decode step 9 x dec + 1 (the cross K/V
     cached), all but the f32 head's on the tensor cores; B3 = B3_tc = enc
     (bidir) + dec (causal) a prefill at D = 64; the cross-attention's
     blockwise_attention once a decoder layer a prefill (the reference's
     direct call) the only plain call; f32 prefill logits of packed and
     planes_int8 within 1e-3 of dense's largest and the packed decode
     against forward at every decoded position within 1e-3 of forward's
     largest (bf16 printed: at 12 + 12 layers the bf16 packed / int8 vs
     dense gap crossed 2e-2, dense's bf16 w_hat amplified through 24
     random layers).  B2 / B4 / B5 at the f32 head [1024, 256206] (N % 4 = 2,
     the non-vec branch) and the MLP's [1024, 4096] and [4096, 1024], M 4
     and 128, and B3 bidir at D = 64 with a group of 1, run with the
     kernel checks of phase 3;
  5p. internvl2: internvl2-76b at published width (d_model 8192, 64 heads
     over 8 KV heads at D 128, d_ff 28672, vocab 128256, untied head, 256
     prefix positions of patch embeddings), depth cut 80 -> 1
     (INTERNVL2_LAYERS): one stateless plan (the head 1.05 G weights)
     served fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves)
     on a 256 + 32-position prompt, each through the serve gates: (7 x
     layers + 1) x gen CIM launches, 7 x layers x gen on the tensor cores,
     B3 = B3_tc = layers at D = 128; prefill logits within dense's bound;
     the packed decode against forward (f32 held, bf16 printed); the pool
     plan and const_rle are phase seamless's (the time limit).  B2 / B4 /
     B5 at the MLP's [8192, 28672] and [28672, 8192] and the f32 head
     [8192, 128256], M 4 and 1152, and B3 at its layout, run with the
     kernel checks of phase 3;
  5q. dryrun: ``launch.dryrun.count_cell`` counts gemma-2b ``decode_32k``
     on the (16, 16) mesh on the host (one device's share: 8 rows, the TP
     plan's shard, all 18 layers; fake tensors, no card) in a thread beside
     the kernels' build; the count's bytes are held from below (every
     parameter and the whole cache read once; the attention's batched
     matmuls read the cache in f32 and write and read the scores); then
     the phase builds that share's inputs on the card (f32 params, bf16
     cache) and times the step (median of 20, CUDA events; one step
     traced): the counted argument bytes == the rise in memory_allocated
     within 512 bytes a tensor, the step no faster than 0.95 x max(compute,
     memory) of the count, as many all-reduces a step at the gate as
     counted, no kernel launched and no plain version called; the roofline
     fraction and the peaks printed;
  6. kernels: time, bound (the bf16 tensor-core rate for the tensor-core
     paths, the f32 rate for the FMA kernels), plain-version and library
     times; B2, B3 and B5 on both paths, B2 with plane gains at decode (f32
     x); B3 also at hymba-1.5b's D = 64 (``d64_serve``: B 4, S 160;
     ``d64_2048``: B 1, S 2048) beside bf16 SDPA; B6 at yi-6b's wi_gate and
     head.

The line before the last is the kernels' JSON record (B1's launches are
those of the gemma-2b plan and the figures, train, accuracy, offset-binary,
bench-extra, faults, engine, tp-fleet, moe, mla, hymba and xlstm phases; B2's, B4's and B5's
those of gemma's packed, const_rle and planes_int8 generates plus the
offset-binary, bench-extra, faults, engine, tp-fleet, moe, mla, hymba, xlstm, seamless and
internvl2 phases' (B2's
``launches_gain`` those with plane gains; the engines' from their graphs'
nodes x replays plus each capture's warm-up run; ``launches_moe`` the moe
phase's, and ``grouped_m8`` / ``grouped_m11`` the grouped launch's times
at the expert shapes; ``launches_mla`` and ``grouped_g160_m8`` the mla
phase's; ``launches_hymba`` the hymba phase's; ``launches_xlstm``,
``launches_seamless`` and ``launches_internvl2`` on every TPU kernel's row
those phases', and ``xlstm_shapes``, ``seamless_shapes`` and
``internvl2_shapes`` on B2's, B4's and B5's the cases and max |d| of their
checks at those models' shapes); the
``sws_sort`` row is the
planner's sort helper (no TPU kernel), its launches the mla phase's plans';
B3's those of yi-6b's generate and the accuracy, offset-binary, bench-extra,
faults, engine, tp-fleet, moe, hymba, xlstm, seamless and internvl2 phases
(``launches_hymba`` / ``launches_hymba_tc`` the hymba phase's, at D = 64;
the xlstm phase's 0; ``launches_seamless_tc`` the seamless phase's);
B6's yi-6b's, the offset-binary, the faults, the engine, the tp-fleet, the
moe, the mla, the hymba, the xlstm, the seamless and the internvl2
deployments');
the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py`` (needs one CUDA card; fails without one).

``python3 chip_smoke.py --ab OTHER_ROOT`` instead compares two trees of the
port on one card, in turns (OTHER, this, this, OTHER), one process each:
B2 bf16 decode at gemma-2b's wi_gate, B6 on the B6_TIMED shapes and the
wall of a yi-6b planes_int8 deployment (``--ab-time ROOT`` is one turn).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAYERS, BATCH, PROMPT, GEN, P_STUCK = 1, 4, 32, 16, 0.5  # LAYERS: gemma-2b's depth cut
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores (B2/B4's, B3's and B5's bf16 paths)
B2_BOUND_C = 2.0
CHECK_TENSOR = "segments/0/attn/wk"
CODEC = "const_rle"  # the pool plan's codec; col_perm_rle runs at COLPERM_LAYERS
COLPERM_LAYERS = 1  # bounds the host greedy of plan_col_order
ZERO_SHARES = (0.0, 0.25, 0.5, 0.75, 0.9)  # zero-tile shares of the synthetic B4 operands
QUANT_MSE_RTOL = 1e-6
F32_LOGIT_RTOL = 1e-3  # f32 prefill, packed vs dense: sums of <= 16384 terms reordered
BF16_LOGIT_RTOL = 0.02  # bf16 prefill: dense rounds w_hat to bf16, packed keeps it exact
YI_LAYERS = 1
B3_WINDOW = 256
B3_SMALL = {  # (B, Hq, Hkv, D) of the reduced configs, f32; internlm2's is the accuracy phase's
    "internlm2/yi reduced": (8, 4, 2, 16), "phi3 reduced": (8, 4, 2, 20),
    "gemma reduced": (8, 4, 1, 32)}
B3_LONG = 2048  # the long-prefill check and timing length
# hymba-1.5b's attention at its serve shape: 25 query heads over 5 KV heads at D = 64, its
# window, and the prefill length of a served prompt (128 meta tokens + PROMPT)
B3_HYMBA = dict(layout=(BATCH, 25, 5, 64), window=1024, s=128 + PROMPT)
B3_SEAMLESS = (BATCH, 16, 16, 64)  # seamless-m4t-medium: MHA (a GQA group of 1) at D = 64
B3_INTERNVL2 = (BATCH, 64, 8, 128)  # internvl2-76b at S = 256 prefix positions + PROMPT
B6_CASES = (  # (shape, element offset of w): the vector path, then the element path
    ((4, 4096, 11008), 0), ((4, 4096, 11008), 1), ((7, 333), 0), ((5, 1), 0),
    ((3, 64, 96), 1), ((2, 33000, 16), 0), ((65537, 1, 5), 0),
)
B6_TIMED = ((4, 4096, 11008), (4096, 64000))  # yi-6b's stacked wi_gate (4 layers), its head
# the trainer at internlm2-1.8b's full width, depth cut 24 -> 2 (phase train)
TRAIN = dict(layers=2, steps=8, batch=8, seq=128, lr=3e-4, remat="none", ckpt_every=4,
             redeploy_every=4, log_every=1, task="lm", seed=0)
# each step's loss against the reference's (golden "trainer": the same cell on XLA:CPU); bf16
# rounding placed differently (XLA keeps fused elementwise chains in f32), measured up to 5.8e-4
TRAIN_GOLDEN_RTOL = 2e-3
# the bf16 step-1 loss against the f32 loss of the same params and batch (measured 7.9e-5): at
# most TRAIN_F32_RTOL, and at least TRAIN_BF16_MIN_REL, which a path left in f32 would not reach
TRAIN_F32_RTOL, TRAIN_BF16_MIN_REL = 4e-4, 1e-6
TRAIN_DISK_BYTES = 24e9  # free space the phase needs: 3 checkpoints of ~6.1 GB at once
REDEPLOY_KEYS = {"step", "tensor", "transitions_natural", "transitions_sws", "chain_stale_sws",
                 "chain_fresh_sws", "chain_pool", "stale_sort_speedup", "sws_delta_speedup",
                 "n_bits", "pool_max_cell_writes", "pool_total_writes"}
# the accuracy phase on the card-trained weights, against the reference's
ACC_LOSS_RTOL = 1e-3  # 120 training losses (measured on the CPU: 6e-6)
ACC_FP_ABS, ACC_SWEEP_ABS, ACC_SPEEDUP_RTOL = 0.01, 0.02, 0.01
ACC_PROBE_ABS = 1e-5  # top-1 agreement and logit KL on the reference's weights
ACC_KL_RTOL = 0.05  # logit KL there also relative to the golden's (measured 1.3%): 0 cannot pass
# redeploy_delta on the card's own chain (its trained LM and 20 further steps) against the
# reference's speedups, as the accuracy phase holds the card-trained sweeps
REDEPLOY_SPEEDUP_RTOL = 0.01
# phase faults (gemma-2b x LAYERS): the pool's stuck cells, the drifted operands, and an
# integrity deployment scrubbed after a storm sized for ~4.4G planned cells (~880 flipped
# bits, ~90 new stuck cells: the reference benchmark's 2e-3 / 2e-4 would dirty most tiles)
FAULT_MODEL = dict(stuck0=1e-3, stuck1=1e-3, hotspot_fraction=0.25, hotspot_mult=8.0)
FAULT_SEED = 42
DRIFT_MODEL = dict(stuck0=1e-3, stuck1=1e-3, drift_sigma=0.05, ir_alpha=0.1)
INTEGRITY_CFG = dict(spare_cols=2, scrub_tiles=65536)  # ~53 rounds a clean cycle at 4 layers
STORM_SEED = 1729
STORM_RATES = dict(corrupt_rate=2e-7, stuck_rate=2e-8)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


SECTIONS: list = []  # (name, seconds) of main's sections, summed up by the last phase line


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds kept in SECTIONS under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    SECTIONS.append((name, time.perf_counter() - t0))
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float | None:
    """Device time of one ``fn()`` in ms: for each kernel it launches (once a
    call), its mean time under torch.profiler (CUPTI), summed; the host's
    gaps between launches, which ``cuda_ms`` includes when the host is the
    slower side, are left out.  A mean per recorded launch, so a dropped
    record does not bias it; None when no device record came back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = [e.self_device_time_total / e.count for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA") and e.count
                  and getattr(e, "self_device_time_total", 0) > 0]
    return sum(per_kernel) / 1e3 if per_kernel else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def trace(run, top: int = 6) -> str:
    """Profile one ``run()``: device busy share of its wall time and the
    kernels with the most device time (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op also reports its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    head = "; ".join(f"{name[:60]} x{n} {ms:.3f} ms" for ms, n, name in rows[:top])
    return (f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%); top: {head or 'no device time seen'}")


def ptxas_summary(logs: dict) -> str:
    """Registers and spills per source from ``nvcc --ptxas-options=-v`` output."""
    import re

    parts = []
    for name, log in sorted(logs.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            parts.append(f"{name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                         f"max spill stores {max(spills, default=0)} B")
    return "; ".join(parts) or "n/a"


def plain_fns():
    """Every plain version a kernel wrapper could fall back to (counted)."""
    from repro_torch.kernels.bitslice import ref as bs_ref
    from repro_torch.kernels.cim_matmul import ref as cim_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.hamming import ref as ham_ref
    from repro_torch.models import attention

    return (cim_ref.cim_matmul, cim_ref.cim_matmul_packed, cim_ref.unpack_weights,
            fa_ref.flash_attention, bs_ref.bitslice_planes, attention.blockwise_attention,
            ham_ref.hamming_pairs)


def reset_counts() -> None:
    from repro_torch.kernels.bitslice import ops as bs_ops
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hamming import ops as ham_ops

    ham_ops.price_pairs.launches = 0
    for ops in (cim_ops, fa_ops, bs_ops):
        ops.reset_launches()
    for fn in plain_fns():
        fn.calls = 0


def counts() -> dict:
    """Kernel launches by kernel, and plain-version calls, since the reset."""
    from repro_torch.kernels.bitslice import ops as bs_ops
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hamming import ops as ham_ops

    return {"B1": ham_ops.price_pairs.launches, **cim_ops.LAUNCHES, **fa_ops.LAUNCHES,
            **bs_ops.LAUNCHES, "plain": sum(fn.calls for fn in plain_fns())}


# the port's kernels by the symbol the profiler records or a graph's node
# list names (demangled or mangled), and the counters each launch adds to;
# B2 and B4 are one template, told apart by its fourth argument (kSkip); the
# FMA kernel's sixth (kGain) marks B2 with plane gains
KERNEL_SYMBOLS = (
    ("cim_packed_tc_kernel", {"false": ("B2", "B2_tc"), "true": ("B4", "B4_tc")}),
    ("cim_packed_kernel", {"false": ("B2",), "true": ("B4",)}),
    ("cim_planes_tc_kernel", ("B5", "B5_tc")),
    ("cim_planes_kernel", ("B5",)),
    ("fa_tc_kernel", ("B3", "B3_tc")),
    ("flash_attention_kernel", ("B3",)),
    ("bitslice_kernel", ("B6",)),
    ("hamming_pairs_kernel", ("B1",)),
)


def _template_args(name: str) -> list[str]:
    """A kernel symbol's template arguments, demangled ("<10, 1, true, false,
    false>") or mangled ("ILi10ELi1ELb1ELb0ELb0EE")."""
    import re

    m = re.search(r"<([^<>]*)>", name)
    if m:
        return [a.strip() for a in m.group(1).split(",")]
    m = re.search(r"I((?:L[a-z]+\d+E)+)E", name)
    if not m:
        return []
    return [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([a-z]+)(\d+)E", m.group(1))]


def kernel_counters(name: str) -> tuple[str, ...]:
    """The counters a kernel record of ``name`` adds to (none for a kernel
    that is not the port's, such as cuBLAS's or the split-K reduce)."""
    import re

    for symbol, keys in KERNEL_SYMBOLS:
        if re.search(rf"(^|[^A-Za-z0-9_]|\d){symbol}(<|I|\(|$)", name):
            if isinstance(keys, dict):
                args = _template_args(name)
                if len(args) <= 3 or args[3] not in keys:
                    return ()
                gain = symbol == "cim_packed_kernel" and len(args) > 5 and args[5] == "true"
                return keys[args[3]] + (("B2_gain",) if gain else ())
            return keys
    return ()


def executed_counts(run) -> dict | None:
    """The port's kernels the card executed in one ``run()``, by counter,
    from torch.profiler's kernel records: graph-replayed kernels are
    recorded one by one, though no wrapper runs for them.  None when the
    profiler recorded no kernel at all.

    The profiler can lose a record: late in a long process it kept 27 of a
    gemma prefill's 28 CIM records in every profile of one generate, with
    or without 0.1 s of idle window around the run.  It never adds one, so
    a serve gate holds these counts only as an upper bound; the exact
    count is the graph's node list's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    got, seen = {}, False
    executed_counts.cim = {}  # the CIM kernels' records by symbol, for a failure message
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        seen = True
        if "cim_" in e.key:
            executed_counts.cim[e.key[:120]] = e.count
        for k in kernel_counters(e.key):
            got[k] = got.get(k, 0) + e.count
    return got if seen else None


COUNT_NOTES: list[str] = []  # profiler records a serve gate found missing
NODE_LIST = {"graphs": 0, "nodes": 0, "s": 0.0}  # node lists read by the serve gates


def overhead_note(ovh: dict) -> str:
    """integrity_scrub's scrub overhead as a phase line prints it: the
    tok/s ratio, each trial's wall time off / on with its scrub rounds, and
    one round alone."""
    trials = ", ".join(f"{1e3 * a:.2f}/{1e3 * b:.2f} ms ({r})" for a, b, r in
                       zip(ovh["walls_off_s"], ovh["walls_on_s"], ovh["rounds_per_trial"]))
    return (f"scrub overhead {ovh['throughput_ratio']:.4f}x tok/s (trials off/on (rounds): "
            f"{trials}; a round alone {1e3 * ovh['round_s']:.3f} ms)")


def graph_counts(decode) -> dict:
    """The port's kernels in a captured decode graph (``CudaGraphCall``),
    by counter: one per kernel node of the graph's node list, which a
    replay runs each once."""
    got = {}
    t0 = time.perf_counter()
    labels = decode.node_labels()
    NODE_LIST["s"] += time.perf_counter() - t0
    NODE_LIST["graphs"] += 1
    NODE_LIST["nodes"] += len(labels)
    for node in labels:
        # a label holds the kernel's parameters too (kilobytes): a substring
        # test first keeps the symbol regexes off the other kernels' nodes
        if any(symbol in node for symbol, _ in KERNEL_SYMBOLS):
            for k in kernel_counters(node):
                got[k] = got.get(k, 0) + 1
    if not labels:
        fail("a decode graph's node list holds no node")
    return got


def served(label, cfg, params, batch, gen, kernel, want, want_tc=0, make=None, expect=None,
           blockwise=0):
    """Serve through the CUDA graph (``loop="scan"``) and through the eager
    per-token loop (``loop="python"``); tok/s of each is the best of 3
    timed passes.  Fails unless both give the same tokens and each
    generate launched ``kernel`` ``want`` times (None: no CIM kernel),
    ``want_tc`` of them on its tensor-core kernel, B3 once per layer (on
    the tensor-core kernel in bf16 compute), nothing else, and no plain
    version was called.

    Counted three ways, each exactly: the eager loop by the wrappers'
    counters; the graph by the prefill's wrappers plus the kernel nodes of
    the captured graph times the replays, and by the wrappers' counts
    during the capture times the replays (the generator's set-up runs the
    decode twice, warm-up and capture, plus one prefill; a timed run counts
    its prefill only).  The kernels the profiler saw the card execute in
    one graph generate may be fewer (it can lose a record), never more or
    others.  Returns the graph's tokens, tok/s, timed run and counts.

    ``make(loop)`` builds the generator instead of ``serve.make_generator``
    (a tensor-parallel one), and ``expect`` replaces the launches a
    generate must make (every kernel counter, B3 included).  ``blockwise``
    is the number of ``blockwise_attention`` calls a prefill makes by
    design (MLA's prefill attention, the reference's own, not a fallback):
    the only plain-version calls allowed."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import attention

    def plain_ok(c):
        """No plain-version call but the prefill's by-design attention."""
        bw = attention.blockwise_attention.calls
        return bw == blockwise and c["plain"] == bw

    if make is None:
        def make(loop):
            return serve.make_generator(cfg, params, batch, gen_len=gen, loop=loop)

    reset_counts()
    timed = make("scan")
    c_setup = counts()
    plain_setup = plain_ok(c_setup)
    reset_counts()
    replays = timed.decode.replays
    toks, dt = timed()
    c_eager = counts()
    plain_eager = plain_ok(c_eager)
    replays = timed.decode.replays - replays
    twice = {k: c_setup[k] - c_eager[k] for k in c_setup}
    if any(v % 2 for v in twice.values()) or not (plain_setup and plain_eager):
        fail(f"{label} graph set-up launched {c_setup}, a timed run {c_eager}: not one prefill "
             f"plus two decodes")
    from_capture = {k: c_eager[k] + twice[k] // 2 * replays for k in c_setup if k != "plain"}
    nodes = graph_counts(timed.decode)
    from_graph = {k: c_eager[k] + nodes.get(k, 0) * replays for k in from_capture}
    executed = executed_counts(timed)
    b = batch["tokens"].shape[0]
    tps = b * gen / dt
    for _ in range(2):
        tps = max(tps, b * gen / timed()[1])
    if toks.shape != (b, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{label} tokens malformed: shape {tuple(toks.shape)}")
    if expect is None:
        expect = {"B3": cfg.n_layers, **({kernel: want} if kernel else {}),
                  **({f"{kernel}_tc": want_tc} if want_tc else {})}
        if cfg.dtype == "bfloat16":
            expect["B3_tc"] = cfg.n_layers
    nonzero = lambda c: {k: v for k, v in c.items() if k != "plain" and v}  # noqa: E731
    if nonzero(from_capture) != expect:
        fail(f"{label} graph launched {from_capture} by its capture x {replays} replay(s) "
             f"(want {expect}, nothing else)")
    if nonzero(from_graph) != expect:
        fail(f"{label} graph holds {nonzero(nodes)} kernel nodes of the port's, run {replays} "
             f"time(s) after a prefill of {nonzero(c_eager)}: {nonzero(from_graph)} (want {expect}, "
             f"nothing else)")
    if executed is None:
        COUNT_NOTES.append(f"{label}: the profiler recorded no kernel")
    else:
        over = {k: v for k, v in nonzero(executed).items() if v > expect.get(k, 0)}
        if over:
            fail(f"{label} card executed {over} in one graph generate (want {expect}, nothing "
                 f"else; CIM records {getattr(executed_counts, 'cim', {})})")
        if nonzero(executed) != expect:
            COUNT_NOTES.append(f"{label}: the profiler recorded {nonzero(executed)} of "
                               f"{expect}")

    eager = make("python")
    reset_counts()
    toks_py, dt_py = eager()
    c_py = counts()
    if nonzero(c_py) != expect or not plain_ok(c_py):
        fail(f"{label} eager generate launched {c_py} (want {expect}, nothing else, no "
             f"plain-version call)")
    if not torch.equal(toks, toks_py):
        fail(f"{label} graph tokens differ from the eager loop's")
    tps_py = max(b * gen / dt_py, b * gen / eager()[1])
    say(f"phase serve-loops: {label}: graph {tps:.1f} tok/s, eager loop {tps_py:.1f} tok/s; "
        f"tokens identical; launches equal by the graph's nodes, by the capture x {replays} "
        f"replay(s) and by the eager wrappers")
    return toks, tps, timed, {**from_graph, "plain": 0}


def sampled_phase(dev, cfg, params, batch, tok_greedy) -> None:
    """Sampled decode (seed 0) of ``params`` through the graph and the eager
    loop: the same tokens (one graph generate traced); the same on the
    reduced gemma-2b (f32), whose flat logits let the noise move tokens;
    and the first sampled step's Gumbel noise on the card equal to the
    CPU's bit for bit."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import api

    def both_loops(cfg_, params_, batch_, label):
        runs = {loop: serve.make_generator(cfg_, params_, batch_, gen_len=GEN, greedy=False,
                                           seed=0, loop=loop) for loop in serve.LOOPS}
        toks_ = {loop: run()[0] for loop, run in runs.items()}
        if not torch.equal(toks_["scan"], toks_["python"]):
            fail(f"sampled tokens of the graph differ from the eager loop's ({label})")
        return toks_, runs["scan"]

    toks, graph = both_loops(cfg, params, batch, "gemma cim-packed")
    say(f"phase trace: sampled cim-packed generate: {trace(graph)}")
    del graph
    small = get_arch("gemma-2b", reduced=True)
    p_small = api.init(prng.PRNGKey(0), small, device=dev)
    b_small = api.make_batch(small, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    toks_small, _ = both_loops(small, p_small, b_small, "reduced gemma")
    greedy_small = serve.generate(small, p_small, b_small, gen_len=GEN)[0]
    # the first pick (after the prefill) splits PRNGKey(0) once and draws
    # the noise from the second half
    _, sub = prng.split(prng.PRNGKey(0)).unbind(-2)
    shape = (batch["tokens"].shape[0], cfg.vocab_size)
    g_card = prng.gumbel(sub.to(dev), shape).cpu()
    g_cpu = prng.gumbel(sub, shape)
    if not torch.equal(g_card.view(torch.int32), g_cpu.view(torch.int32)):
        n = int((g_card.view(torch.int32) != g_cpu.view(torch.int32)).sum())
        fail(f"the card's Gumbel noise differs from the CPU's in {n} of {g_cpu.numel()} values")
    say(f"phase sampled: seed 0, graph and eager loop give the same tokens: gemma cim-packed "
        f"{tuple(toks['scan'].shape)} (agreement with greedy "
        f"{(toks['scan'] == tok_greedy).float().mean().item():.3f}), reduced gemma (agreement "
        f"with greedy {(toks_small['scan'] == greedy_small).float().mean().item():.3f}); the "
        f"first step's Gumbel noise {shape} on the card == the CPU's, bit for bit")


def throughput_phase(dev) -> None:
    """``benchmarks_torch.serving_throughput.run`` at gemma-2b's full width
    (LAYERS layers, batch BATCH, prompt PROMPT, gen GEN, greedy): every
    variant through both loops, interleaved, best of 5; the device-busy
    share of one traced generate per loop for cim-packed and
    cim-planes_int8.  Fails unless both loops give the same tokens."""
    from benchmarks_torch import serving_throughput

    t0 = time.perf_counter()
    res = serving_throughput.run("gemma-2b", reduced=False, layers=LAYERS, batch=BATCH,
                                 prompt_len=PROMPT, gen=GEN, p_stuck=P_STUCK, repeats=5,
                                 device=dev)
    if not all(res["tokens_equal_across_loops"].values()):
        fail(f"serving_throughput: loops give other tokens: {res['tokens_equal_across_loops']}")
    for name, by_loop in res["tok_s"].items():
        say(f"phase serve-throughput: gemma-2b x{LAYERS} {name}: "
            + ", ".join(f"{loop} {tps:.1f} tok/s" for loop, tps in by_loop.items())
            + f" (graph / eager {res['graph_over_python_tok_s'][name]:.2f}x)")
    for name, by_loop in res["device_busy"].items():
        say(f"phase serve-throughput: {name} one traced generate: " + "; ".join(
            f"{loop} wall {b['wall_ms']:.2f} ms, device {b['device_ms']:.2f} ms "
            f"({100 * b['busy']:.1f}% busy)" for loop, b in by_loop.items()))
    t = res["weight_bytes_per_decode_step"]
    say(f"phase serve-throughput: weight bytes a decode step: dense f32 {t['dense_f32']:,}, "
        f"int8 planes {t['planes_int8']:,}, packed {t['packed']:,} (int8 / packed "
        f"{t['int8_over_packed']:.2f}x); token agreement with dense "
        f"{res['token_agreement_vs_dense']}; {res['timing']}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def logit_check(cfg, p_dense, p_x, batch, label):
    """bf16 and f32 prefill logits of ``p_x`` within a share of the largest
    dense logit of the dense deployment's."""
    import torch

    from repro_torch.models import api

    with torch.inference_mode():
        for dtype_name, rtol in (("bfloat16", BF16_LOGIT_RTOL), ("float32", F32_LOGIT_RTOL)):
            c_ = dataclasses.replace(cfg, dtype=dtype_name)
            ld, _ = api.prefill(p_dense, c_, batch)
            lp, _ = api.prefill(p_x, c_, batch)
            if not (torch.isfinite(ld).all() and torch.isfinite(lp).all()):
                fail(f"non-finite {dtype_name} prefill logits")
            d = (lp - ld).abs().max().item()
            bound = rtol * ld.abs().max().item()
            say(f"phase logits: {cfg.name} {dtype_name} prefill {label} vs dense max |d| "
                f"{d:.4e} (bound {rtol:g} * max|logit| = {bound:.4e})")
            if d > bound:
                fail(f"{dtype_name} prefill logits of {label} and dense differ by {d:.4e}")


def same_report(a, b, what):
    """Two TensorReports are equal (quant_mse, a float mean summed in
    another order, within QUANT_MSE_RTOL)."""
    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    for field in a:
        same = (abs(a[field] - b[field]) <= QUANT_MSE_RTOL * abs(a[field])
                if field == "quant_mse" else a[field] == b[field])
        if not same:
            fail(f"CPU plan of {what} differs in {field}: {a[field]} vs {b[field]}")


def deploy_int8(params, plan):
    """``deploy_params(materialize="planes_int8")`` with the counts read
    around it: B6 must build every operand dict, once each, and nothing
    else may launch or fall back.  Prints the deployment's wall time."""
    import torch

    from repro_torch.core import planner

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_int8 = planner.deploy_params(params, plan, materialize="planes_int8")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    c = counts()
    n_ops = sum(1 for _ in _operand_dicts(p_int8))
    got = {k: v for k, v in c.items() if k != "plain" and v}
    if got != {"B6": n_ops} or c["plain"]:
        fail(f"planes_int8 deployment launched {c} (want B6 = {n_ops} operand dicts, nothing "
             f"else, no plain-version call)")
    say(f"phase deploy-int8: deploy_params(materialize='planes_int8') wall {wall_ms:.2f} ms "
        f"(synchronized), {c['B6']} B6 launches")
    return p_int8, c


def bound(nbytes, flops, rate=F32_FLOPS):
    """Least time in ms for moving ``nbytes`` through HBM and doing the
    function's ``flops`` at ``rate`` (the f32 FMA rate for the FMA kernels,
    the bf16 tensor-core rate for the tensor-core paths), and which of the
    two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_attention(dev) -> dict:
    """B3, causal, at yi-6b's, gemma-2b's and hymba-1.5b's serve prefill
    shapes (hymba: B 4, S 160 = 128 meta + 32, D = 64) and a 2048-token
    prefill of each: the bf16 tensor-core kernel (the main path) and the
    f32 FMA kernel, the plain version, SDPA on the bf16 and on the f32
    inputs (timed as a yardstick only) and each path's bound (q, k, v, o
    bytes; 4 * D FLOPs per visible pair at the bf16 tensor-core rate or the
    f32 rate).  Also the host time of one bf16 call's TMA descriptor
    encoding.  Returns the record at yi-6b's serve shape, with hymba's two
    under ``d64_serve`` and ``d64_2048``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    records, lines = {}, []
    for name, layout, serve_s in (("yi-6b", (BATCH, 32, 4, 128), PROMPT),
                                  ("gemma-2b", (BATCH, 8, 1, 256), PROMPT),
                                  ("hymba-1.5b", B3_HYMBA["layout"], B3_HYMBA["s"])):
        for s in (serve_s, B3_LONG):
            lay = layout if s == serve_s else (1,) + layout[1:]
            b, hq, _, d = lay
            q, k, v, _, _ = attention_inputs(dev, lay, s, False, torch.bfloat16, seed=s + d)
            if (name, s) == ("yi-6b", PROMPT):
                say(f"phase kernels: B3 TMA descriptor encoding (3 maps, host) "
                    f"{fa_ops.encode_us(q, k, v):.3f} us a call")
            ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, kind="causal"))
            qf, kf, vf = q.float(), k.float(), v.float()
            ms_f32 = cuda_ms(lambda: fa_ops.flash_attention(qf, kf, vf, kind="causal"))
            plain = cuda_ms(lambda: fa_ref.flash_attention(q, k, v, kind="causal"), reps=5)
            library = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            library_f32 = cuda_ms(lambda: F.scaled_dot_product_attention(
                qf, kf, vf, is_causal=True, enable_gqa=True))
            flops = 4 * d * hq * live_pairs(b, s, s, "causal", s, 0, None)
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            bnd, by = bound(nbytes, flops, BF16_TC_FLOPS)
            bnd32, by32 = bound(2 * nbytes, flops)
            dev_tc = device_ms(lambda: fa_ops.flash_attention(q, k, v, kind="causal"))
            dev_lib = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            records[(name, s)] = dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=bnd,
                                      bound_by=by)
            lines.append(f"{name} B={b} S={s}: bf16 tensor cores {ms:.4f} ms (device only "
                         f"{fmt_ms(dev_tc)}; bound {bnd:.4f} by {by}), f32 FMA {ms_f32:.4f} ms "
                         f"(bound {bnd32:.4f} by {by32}), plain {plain:.4f}, SDPA bf16 "
                         f"{library:.4f} (device only {fmt_ms(dev_lib)}), SDPA f32 "
                         f"{library_f32:.4f}")
            del q, k, v, qf, kf, vf
    say("phase kernels: B3 causal: " + "; ".join(lines))
    torch.cuda.empty_cache()
    return {**records[("yi-6b", PROMPT)], "d64_serve": records[("hymba-1.5b", B3_HYMBA["s"])],
            "d64_2048": records[("hymba-1.5b", B3_LONG)]}


def time_bitslice(dev) -> dict:
    """B6 at cols 10 on the B6_TIMED shapes: kernel, plain version and the
    byte bound ((4 + cols) bytes a weight).  Returns the first shape's
    record."""
    import torch

    from repro_torch.kernels.bitslice import ops as bs_ops
    from repro_torch.kernels.bitslice import ref as bs_ref

    records = []
    for shape in B6_TIMED:
        g = torch.Generator(device=dev).manual_seed(11)
        w = torch.randn(shape, device=dev, generator=g) * 0.05
        inv = torch.tensor(4096.0, device=dev)
        ms = cuda_ms(lambda: bs_ops.bitslice_planes(w, inv, 10), reps=10)
        plain = cuda_ms(lambda: bs_ref.bitslice_planes(w, inv, 10), reps=3, warmup=1)
        bnd, by = bound(w.numel() * (4 + 10), 0)
        say(f"phase kernels: B6 {list(shape)} cols 10: {ms:.4f} ms ({100 * bnd / ms:.1f}% of the "
            f"bound {bnd:.4f} by {by}; plain {plain:.4f}; no single torch call)")
        records.append(dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by))
        del w
        torch.cuda.empty_cache()
    return records[0]


def attention_inputs(dev, layout, s, per_row, dtype, seed):
    """q, k, v, kv_valid_len, q_offset for one B3 case.  ``layout`` is
    (B, Hq, Hkv, D).  Scalar cases: Sk = Sq, q at positions from 0.  Per-row
    cases: a cache view of Sq + 64 slots, row b live to a random extent
    kvl_b >= Sq with its queries the last Sq positions, so every row sees
    at least one key under every mask."""
    import torch

    b, hq, hkv, d = layout
    g = torch.Generator(device=dev).manual_seed(seed)
    sk = s + 64 if per_row else s
    q = torch.randn(b, hq, s, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, hkv, sk, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, hkv, sk, d, device=dev, generator=g).to(dtype)
    if per_row:
        kvl = torch.randint(s, sk + 1, (b,), device=dev, generator=g, dtype=torch.int32)
        return q, k, v, kvl, kvl - s
    return q, k, v, sk, 0


def live_pairs(b, s, sk, kind, kvl, off, window):
    """Visible (q, k) pairs of one B3 call summed over the batch (the work
    this run's data needs), from the same mask as the plain version."""
    import torch

    kvl_t = torch.as_tensor(kvl).reshape(-1).expand(b).cpu()
    off_t = torch.as_tensor(off).reshape(-1).expand(b).cpu()
    qp = off_t[:, None, None] + torch.arange(s)[None, :, None]
    kp = torch.arange(sk)[None, None, :]
    mask = kp < kvl_t[:, None, None]
    if kind != "bidir":
        mask = mask & (kp <= qp)
        if kind == "swa":
            mask = mask & (kp > qp - window)
    return int(mask.sum())


def check_b3(dev):
    """B3 against its plain version in every case (bf16 on the tensor-core
    kernel, f32 on the FMA kernel, which the launch counts must show), at
    yi-6b's, gemma-2b's, hymba-1.5b's, seamless-m4t-medium's and
    internvl2-76b's serve shapes (hymba: D = 64, 25 query heads over 5 KV
    heads, S = 160, swa at its window 1024; seamless: D = 64, 16 heads over
    16, a GQA group of 1; internvl2: D = 128, 64 over 8, S = 288) and a
    2048-token prefill of each; returns the max |d| and the number of
    cases."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    layouts = {"yi-6b": ((4, 32, 4, 128), PROMPT, B3_WINDOW),
               "gemma-2b": ((4, 8, 1, 256), PROMPT, B3_WINDOW),
               "hymba-1.5b": (B3_HYMBA["layout"], B3_HYMBA["s"], B3_HYMBA["window"]),
               "seamless-m4t-medium": (B3_SEAMLESS, PROMPT, B3_WINDOW),
               "internvl2-76b": (B3_INTERNVL2, 256 + PROMPT, B3_WINDOW)}
    worst, n = 0.0, 0
    for name, (layout, serve_s, swa_window) in layouts.items():
        for s in (serve_s, B3_LONG):
            lay = layout if s == serve_s else (1,) + layout[1:]
            errs = []
            for kind in ("causal", "bidir", "swa"):
                window = swa_window if kind == "swa" else None
                for per_row in (False, True):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v, kvl, off = attention_inputs(dev, lay, s, per_row, dtype, seed=n)
                        fa_ops.reset_launches()
                        got = fa_ops.flash_attention(q, k, v, kvl, kind=kind, window=window,
                                                     q_offset=off)
                        path = dict(fa_ops.LAUNCHES)
                        want = fa_ref.flash_attention(q, k, v, kvl, kind=kind, window=window,
                                                      q_offset=off)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs()
                        tag = (f"{kind} {'per-row' if per_row else 'scalar'} "
                               f"{str(dtype).split('.')[-1]}")
                        if path != {"B3": 1, "B3_tc": int(dtype == torch.bfloat16)}:
                            fail(f"B3 {name} S={s} {tag} took the wrong kernel: {path}")
                        if got.shape != want.shape or got.dtype != dtype or not bool(
                                (err <= fa_ref.attention_bound(want)).all()):
                            fail(f"B3 outside its tolerance on {name} B={lay[0]} S={s} {tag}: "
                                 f"max |d| {err.max().item():.3e}")
                        errs.append(f"{tag} {err.max().item():.2e}")
                        worst = max(worst, err.max().item())
                        n += 1
                        del q, k, v, got, want, err
            say(f"phase B3: {name} layout (B {lay[0]}, Hq {lay[1]}, Hkv {lay[2]}, D {lay[3]}) "
                f"S={s}: max |d| " + "; ".join(errs))
    # the reduced configs' head dims on the f32 FMA kernel, at the accuracy
    # phase's evaluation shape (S = 64); the tensor-core kernel refuses them
    for name, lay in B3_SMALL.items():
        errs = []
        for kind in ("causal", "bidir", "swa"):
            window = 16 if kind == "swa" else None
            for per_row in (False, True):
                q, k, v, kvl, off = attention_inputs(dev, lay, 64, per_row, torch.float32, seed=n)
                fa_ops.reset_launches()
                got = fa_ops.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
                path = dict(fa_ops.LAUNCHES)
                want = fa_ref.flash_attention(q, k, v, kvl, kind=kind, window=window, q_offset=off)
                torch.cuda.synchronize()
                err = (got - want).abs()
                tag = f"{kind} {'per-row' if per_row else 'scalar'} float32"
                if path != {"B3": 1, "B3_tc": 0}:
                    fail(f"B3 {name} {tag} took the wrong kernel: {path}")
                if got.shape != want.shape or not bool((err <= fa_ref.attention_bound(want)).all()):
                    fail(f"B3 outside its tolerance on {name} D={lay[3]} {tag}: max |d| "
                         f"{err.max().item():.3e}")
                errs.append(f"{tag} {err.max().item():.2e}")
                worst = max(worst, err.max().item())
                n += 1
        q = torch.zeros(1, lay[1], 8, lay[3], device=dev, dtype=torch.bfloat16)
        fa_ops.reset_launches()
        try:
            fa_ops.flash_attention(q, q[:, :lay[2]], q[:, :lay[2]])
            fail(f"B3 took a bf16 call at head dim {lay[3]}")
        except ValueError:
            pass
        if fa_ops.LAUNCHES["B3"]:
            fail(f"B3 launched on a refused bf16 call at head dim {lay[3]}")
        say(f"phase B3: {name} layout (B {lay[0]}, Hq {lay[1]}, Hkv {lay[2]}, D {lay[3]}) S=64 on "
            f"the FMA kernel: max |d| " + "; ".join(errs) + "; a bf16 call at this D raises")
    torch.cuda.empty_cache()
    return worst, n


def check_b6(dev) -> None:
    """B6 == its plain version bit for bit on every B6_CASES shape, in one
    launch each."""
    import torch

    from repro_torch.kernels.bitslice import ops as bs_ops
    from repro_torch.kernels.bitslice import ref as bs_ref

    inv = torch.tensor(4096.0, device=dev)  # a power of two keeps the planted ties exact
    n6 = 0
    for shape, offset in B6_CASES:
        numel = torch.Size(shape).numel()
        # offset 1: a contiguous view 4 bytes past a 16-byte boundary
        w6 = tied_weights(dev, (numel + offset,), 4096.0, seed=6 + n6)[offset:].view(shape)
        bs_ops.reset_launches()
        got6 = bs_ops.bitslice_planes(w6, inv, 10)
        launched = bs_ops.LAUNCHES["B6"]
        want6 = bs_ref.bitslice_planes(w6, inv, 10)
        torch.cuda.synchronize()
        if launched != 1 or got6.shape != want6.shape or not torch.equal(got6, want6):
            fail(f"B6 differs from its plain version on {list(shape)} weights (offset "
                 f"{offset}) with .5 ties (launches {launched})")
        n6 += 1
        del w6, got6, want6
    torch.cuda.empty_cache()
    shapes = ", ".join(f"{list(sh)}" + (" at a 4-byte offset" if o else "") for sh, o in B6_CASES)
    say(f"phase B6: {n6} cases, f32 {shapes}, with 1/7 planted .5 ties, -0.0 and values past "
        f"1023: bit-equal to its plain version, one launch each")


def check_ids_nan(dev, p_rle) -> None:
    """Plane ids that are not a permutation of range(10) give all-NaN from
    B2 and B4 on the tensor-core kernel (bf16 x), split K included, on
    layer 0's planned wi_gate and wo."""
    import torch

    from repro_torch.kernels.cim_matmul import ops as cim_ops

    g = torch.Generator(device=dev).manual_seed(17)
    n_nan = 0
    for bad in ([0, 1, 2, 5, 4, 5, 6, 7, 8, 9], [0, 1, 2, 10, 4, 5, 6, 7, 8, 9]):
        ids = torch.tensor(bad, dtype=torch.int32, device=dev)
        for path in ("mlp/wi_gate", "mlp/wo"):
            a, b = path.split("/")
            op = {k: v[0] for k, v in p_rle["segments"][0][a][b].items()}
            args = (op["planes_packed"], op["sign_packed"], op["scale"])
            for m in (1, 4, 128):
                x = torch.randn(m, op["kdim"].shape[-2], device=dev, generator=g).to(torch.bfloat16)
                y2 = cim_ops.cim_matmul_packed(x, *args, plane_ids=ids)
                y4 = cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"], plane_ids=ids)
                torch.cuda.synchronize()
                if not (bool(torch.isnan(y2).all()) and bool(torch.isnan(y4).all())):
                    fail(f"B2/B4 bf16 with plane_ids {bad} on planned {path} at M={m} gave "
                         f"numbers, not NaN")
                n_nan += 1
    say(f"phase B2/B4-ids: plane_ids with a repeated or an out-of-range id give all-NaN "
        f"from B2 and B4 on the tensor-core kernel ({n_nan} cases: planned wi_gate and wo, "
        f"M in {{1, 4, 128}})")


def tied_weights(dev, shape, inv, seed):
    """Random weights with exact .5 ties of |w| * inv (inv a power of two),
    a share past the top level, and -0.0 cells."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, device=dev, generator=g) * 0.05
    flat = w.view(-1)
    idx = torch.randint(0, flat.numel(), (flat.numel() // 7,), device=dev, generator=g)
    half = torch.randint(0, 1100, idx.shape, device=dev, generator=g).float() + 0.5
    sign = torch.where(torch.rand(idx.shape, device=dev, generator=g) < 0.5, -1.0, 1.0)
    flat[idx] = sign * half / inv
    flat[:16] = -0.0
    return w


def _at(tree, name):
    """The leaf of a params tree at a '/'-joined planner name."""
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def yi_phases(dev) -> dict:
    """yi-6b at its published width with the depth cut to YI_LAYERS: plan on
    the card (and one tensor again on the CPU), B6's planes of every planned
    tensor against the route before it, then serve fp, cim-dense, cim-packed
    and cim-planes_int8.  Returns the main path's B3 (B3_tc) / B6 launch
    counts."""
    import torch

    from repro_torch import prng, tree
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, simulator
    from repro_torch.launch import serve
    from repro_torch.models import api

    full = get_arch("yi-6b")
    cfg = dataclasses.replace(full, n_layers=YI_LAYERS)
    say(f"phase yi-plan: yi-6b d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
        f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} act={cfg.act} "
        f"rope_theta={cfg.rope_theta:g} untied head; depth cut {full.n_layers} -> {YI_LAYERS} "
        f"layers (the only cut), p_stuck={P_STUCK}")
    t_init = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_init = sum(w.numel() for w in tree.leaves(params))
    say(f"phase init: yi-6b x{YI_LAYERS} layers {n_init / 1e6:.1f}M params from the reference's key in "
        f"{time.perf_counter() - t_init:.2f} s")
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    c = counts()
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final})")
    tot = plan.totals()
    say(f"phase yi-plan: {len(plan.reports)} tensors in {plan_s:.2f} s; sws "
        f"{tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; B1 launches {c['B1']}")
    if c["B1"] <= 0 or any(c[k] for k in c if k not in ("B1", "plain")) or c["plain"]:
        fail(f"yi-6b plan launched {c}")
    if "head/w" not in plan.reports:
        fail("yi-6b's untied head/w was not planned")

    key = planner.tensor_keys(params, pcfg)[CHECK_TENSOR]
    w_cpu = dict(planner.iter_weights(params, pcfg))[CHECK_TENSOR].cpu()
    t0 = time.perf_counter()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=CHECK_TENSOR)
    cpu_s = time.perf_counter() - t0
    same_report(plan.reports[CHECK_TENSOR], r_cpu, f"yi-6b {CHECK_TENSOR}")
    if plan.deployed[CHECK_TENSOR].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of yi-6b {CHECK_TENSOR} deploys other w_hat bytes")
    say(f"phase yi-plan-cpu: {CHECK_TENSOR} {list(w_cpu.shape)} planned on the CPU in "
        f"{cpu_s:.2f} s: report equal, w_hat bytes identical")
    del w_cpu, w_hat_cpu

    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    want = (7 * YI_LAYERS + 1) * GEN  # + the planned LM head, once per forward
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    _, tps_fp, _, _ = served("yi-6b fp", cfg, params, batch, GEN, None, 0)
    tok_dense, tps_dense, _, _ = served("yi-6b dense", cfg, p_dense, batch, GEN, None, 0)
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    # bf16 activations on the tensor-core kernel; the planned head's f32
    # activations on the FMA kernel (GEN launches)
    tok_packed, tps_packed, timed_packed, c = served("yi-6b packed", cfg, p_packed, batch, GEN,
                                                     "B2", want, want_tc=want - GEN)
    b3_launches, b3_tc = c["B3"], c["B3_tc"]
    say(f"phase yi-serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16; tok/s fp "
        f"{tps_fp:.1f} cim-dense {tps_dense:.1f} cim-packed {tps_packed:.1f}; packed/dense "
        f"token agreement {(tok_packed == tok_dense).float().mean().item():.3f}; B2 launches "
        f"{c['B2']} (want (7 * {YI_LAYERS} + 1) * {GEN} = {want}), on tensor cores {c['B2_tc']} "
        f"(want {want - GEN}); B3 launches {b3_launches} "
        f"(want {YI_LAYERS}, every variant); plain-version calls 0")
    say(f"phase trace: yi-6b cim-packed generate: {trace(timed_packed)}")
    logit_check(cfg, p_dense, p_packed, batch, "packed")
    del timed_packed

    p_int8, c6 = deploy_int8(params, plan)
    say(f"phase trace: yi-6b planes_int8 deployment: "
        f"{trace(lambda: planner.deploy_params(params, plan, materialize='planes_int8'))}")
    n_eq = 0
    for name, w_hat in plan.deployed.items():
        op = _at(p_int8, name)
        if not isinstance(op, dict):
            continue  # served dense (the norm gains)
        # the route before B6: q = round(|w_hat| / scale), sign from signbit
        w32 = w_hat.to(torch.float32)
        scale = torch.tensor(plan.reports[name].scale, dtype=torch.float32, device=dev)
        q = torch.clamp(torch.round(w32.abs() / scale), 0, 2**spec.cols - 1).to(torch.int32)
        sign = torch.where(torch.signbit(w32), -1, 1).to(torch.int8)
        old = simulator.int8_plane_operands(q, sign, scale, 0.0, spec.cols)["splanes"]
        if not torch.equal(old, op["splanes"]):
            fail(f"B6 planes of yi-6b {name} differ from q = round(|w_hat| / scale)")
        n_eq += 1
        del w32, q, sign, old
    int8_gb = sum(v["splanes"].numel() for v in _operand_dicts(p_int8)) / 1e9
    say(f"phase yi-B6: planes of all {n_eq} planned matmul tensors built by {c6['B6']} B6 "
        f"launches ({int8_gb:.2f} GB) equal the route before B6 bit for bit")
    # bf16 activations on the tensor-core kernel; the planned head's f32
    # activations on the FMA kernel (GEN launches)
    tok_int8, tps_int8, timed_int8, c = served("yi-6b planes_int8", cfg, p_int8, batch, GEN,
                                               "B5", want, want_tc=want - GEN)
    # packed and int8 planes both compute on the exact deployed weights;
    # dense rounds them to bf16, which flips yi's near-tied random logits
    say(f"phase yi-serve-int8: cim-planes_int8 {tps_int8:.1f} tok/s; token agreement with "
        f"dense {(tok_int8 == tok_dense).float().mean().item():.3f}, with packed "
        f"{(tok_int8 == tok_packed).float().mean().item():.3f}; B5 launches {c['B5']} "
        f"(want {want}), on tensor cores {c['B5_tc']} (want {want - GEN}); B3 launches "
        f"{c['B3']}, on tensor cores {c['B3_tc']}; plain-version calls 0")
    say(f"phase trace: yi-6b cim-planes_int8 generate: {trace(timed_int8)}")
    logit_check(cfg, p_dense, p_int8, batch, "planes_int8")
    # in float32 compute all three serve the same weights (dense no longer
    # rounds w_hat to bf16): tokens part only where logits nearly tie
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t32 = {label: serve.generate(cfg32, p, batch, gen_len=GEN)[0]
           for label, p in (("dense", p_dense), ("packed", p_packed), ("planes_int8", p_int8))}
    say(f"phase yi-serve-f32: float32 compute, token agreement with dense: packed "
        f"{(t32['packed'] == t32['dense']).float().mean().item():.3f}, planes_int8 "
        f"{(t32['planes_int8'] == t32['dense']).float().mean().item():.3f}")
    return {"B3": b3_launches, "B3_tc": b3_tc, "B6": c6["B6"]}


def first_difference(got, want, path="") -> str | None:
    """The first path at which two JSON-like trees differ, or None."""
    if isinstance(want, dict) and isinstance(got, dict):
        if set(got) != set(want):
            return f"{path or '/'}: keys {sorted(got)} vs {sorted(want)}"
        for k in want:
            d = first_difference(got[k], want[k], f"{path}/{k}")
            if d:
                return d
        return None
    if type(got) is not type(want) or got != want:
        return f"{path}: {got!r} vs the reference's {want!r}"
    return None


def figures_phase(dev) -> dict:
    """The paper's planner figures on the card, held to the reference.

    Runs fig5-fig8, fig9's and fig10's transition sweeps and the planner
    throughput's card plan at the golden file's size with the counts zeroed
    just before and read just after (B1 must launch, nothing else, no plain
    version); every integer must equal ``benchmarks_torch/golden/reference.json``
    and every speedup be the same float.  Then the planner's CPU plan must
    be identical to the card's.  Returns the counts and the phase's wall."""
    import torch

    from benchmarks_torch import (fig5_sws_single, fig6_strides, fig7_greedy, fig8_stucking,
                                  fig9_p_sweep, fig10_columns, planner_throughput)
    from repro_torch.kernels.hamming import ops as ham_ops
    from repro_torch.kernels.hamming import ref as ham_ref

    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    me, seed, pl = gold["max_elems"], gold["seed"], gold["planner"]
    say(f"phase figures: reference {gold['backend']} jax {gold['jax_version']}, max_elems "
        f"{me} ({gold['sweep_max_elems']} for fig9/fig10), seed {seed}; planner "
        f"{pl['layers']} layers at {pl['max_elems']}, p {pl['p_stuck']}")
    parts = {
        "fig5": lambda: fig5_sws_single.run(max_elems=me, seed=seed, device=dev),
        "fig6": lambda: fig6_strides.run(max_elems=me, seed=seed, device=dev),
        "fig7": lambda: fig7_greedy.run(max_elems=me, seed=seed, device=dev),
        "fig8": lambda: fig8_stucking.run(max_elems=me, seed=seed, device=dev),
        "fig9": lambda: fig9_p_sweep.transitions_sweep(max_elems=me, seed=seed, device=dev),
        "fig10": lambda: fig10_columns.transitions_sweep(max_elems=me, seed=seed, device=dev),
    }
    t_phase = time.perf_counter()
    reset_counts()
    res, walls = {}, {}
    for name, fn in parts.items():
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        diff = first_difference(json.loads(json.dumps(res[name])), gold[name])
        if diff:
            fail(f"{name} on the card differs from the reference at {diff}")
    params = planner_throughput.gemma_scale_params(max_elems=pl["max_elems"],
                                                   layers=pl["layers"], device=dev)
    plan, t_card = planner_throughput.plan(params, pl["p_stuck"], dev)
    c = counts()
    if c["B1"] <= 0 or any(c[k] for k in c if k not in ("B1", "plain")) or c["plain"]:
        fail(f"figures launched {c} (want B1 only, no plain-version call)")
    diff = first_difference(json.loads(json.dumps(planner_throughput.plan_record(plan))),
                            {k: pl[k] for k in ("totals", "reports", "w_hat_sha256")})
    if diff:
        fail(f"planner_throughput's card plan differs from the reference at {diff}")
    params_cpu = {n: {k: w.cpu() for k, w in l.items()} for n, l in params.items()}
    plan_cpu, t_cpu = planner_throughput.plan(params_cpu, pl["p_stuck"], "cpu")
    if not planner_throughput.same_plans(plan, plan_cpu):
        fail("planner_throughput's CPU plan differs from its card plan")
    del params, params_cpu, plan, plan_cpu
    torch.cuda.empty_cache()

    say("phase figures: " + "; ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; every integer and speedup equal to the reference's; B1 launches {c['B1']}, "
        f"plain-version calls 0")
    for m, r in res["fig5"].items():
        say(f"  fig5 {m}: {r['n_sections']} sections, {r['transitions_unsorted']} -> "
            f"{r['transitions_sws']} transitions, speedup {r['speedup']:.4f}x")
    say("\n".join(fig5_sws_single.paper_check(res["fig5"])))
    for m, r in res["fig6"].items():
        ls = "  ".join(f"L={l}:{v['speedup']:.3f}x" for l, v in r["strideL"].items())
        say(f"  fig6 {m}: strideL[{ls}]  stride1 {r['stride1']['speedup']:.3f}x "
            f"(stride-1 over stride-L=4: "
            f"{r['stride1']['speedup'] / r['strideL']['4']['speedup']:.3f}x)")
    for m, r in res["fig7"].items():
        say(f"  fig7 {m}: {r['n_jobs']} jobs, unsorted {r['speedup_unsorted']:.3f}x greedy "
            f"{r['speedup_greedy']:.3f}x (ideal {r['ideal']:g}x)")
    for m, r in res["fig8"].items():
        say(f"  fig8 {m}: {r['transitions_p1']} -> {r['transitions_p']} transitions, saves "
            f"{r['speedup_pct']:.2f}%")
    say(fig8_stucking.PAPER_BAND)
    for m, r in res["fig9"].items():
        say(f"  fig9 {m}: " + "  ".join(f"p={p}:{v:.3f}x" for p, v in r["speedup_vs_p1"].items()))
    for m, e in res["fig10"].items():
        say(f"  fig10 {m}: " + "  ".join(f"{k}:{v['speedup_p1_over_p']:.3f}x"
                                         for k, v in e.items()))
    tot = pl["totals"]
    say(f"phase figures-planner: gemma-2b x{pl['layers']} layers, {len(pl['reports'])} tensors: "
        f"card plan {t_card:.2f} s, CPU plan {t_cpu:.2f} s ({t_cpu / t_card:.2f}x); totals, "
        f"report integers and w_hat digests equal to the reference's, CPU plan identical; "
        f"sws {tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x")

    # B1 at the widest pair shape the figures send it (fig6/fig7, 128x10: 1536 weights a
    # crossbar, 192 packed words x 10 columns a section)
    t = 1 << 16
    g = torch.Generator(device=dev).manual_seed(1)
    a, b = (torch.randint(0, 256, (t, 192, 10), dtype=torch.uint8, device=dev, generator=g)
            for _ in range(2))
    ms = cuda_ms(lambda: ham_ops.price_pairs(a, b))
    plain = cuda_ms(lambda: ham_ref.hamming_pairs(a, b), reps=5)
    bnd = (2 * a.numel() + 4 * t) / HBM_BYTES_PER_S * 1e3
    if not torch.equal(ham_ops.price_pairs(a, b), ham_ref.hamming_pairs(a, b)):
        fail("B1 differs from its plain version at the figures' pair shape")
    say(f"phase figures-B1: T={t} pairs of [192, 10] bytes: {ms:.4f} ms (bound {bnd:.4f} by "
        f"bytes, {100 * bnd / ms:.1f}%), plain {plain:.4f} ms")
    del a, b
    wall = time.perf_counter() - t_phase
    say(f"phase figures: wall {wall:.1f} s")
    figures_breakdown(dev)
    return {"B1": c["B1"] + bool_oracle_check(dev), "wall_s": wall}


BOOL_PLAN = dict(max_elems=750_000, layers=1)  # the bool oracle's size: gemma-2b x1, 7 tensors


def bool_oracle_check(dev) -> int:
    """The planner's and the pool's ``impl="bool"`` oracle on the card at
    BOOL_PLAN: ``planner_throughput.run`` (the packed plan, the bool plan
    and the CPU's packed plan, reports and w_hat bytes identical; both
    walls), then the same weights streamed through one persistent lpt pool
    per impl (reports, w_hat bytes, pool state, wear and stats identical).
    The bool runs launch no kernel and call no plain version.  Returns the
    packed plans' B1 launches."""
    import numpy as np
    import torch

    from benchmarks_torch import planner_throughput
    from repro_torch.core import planner, pool
    from repro_torch.kernels.sws_sort import ops as sort_ops

    t0 = time.perf_counter()
    reset_counts()
    r = planner_throughput.run(**BOOL_PLAN, device=dev)
    b1 = counts()["B1"]
    if not (r["bool_exact"] and r["bit_exact"]):
        fail(f"the bool oracle's plan differs from the packed plan (bool_exact "
             f"{r['bool_exact']}, bit_exact {r['bit_exact']})")
    params = planner_throughput.gemma_scale_params(**BOOL_PLAN, device=dev)
    plans, pools, walls = {}, {}, {}
    for impl in ("packed", "bool"):
        cfg = planner.PlannerConfig(p_stuck=0.5, min_size=1024, impl=impl, pool_leveling="lpt")
        pools[impl] = pool.CrossbarPool(planner_throughput.SPEC, cfg.crossbars, device=dev)
        reset_counts()
        sorts = sort_ops.LAUNCHES["SORT"]
        t1 = time.perf_counter()
        plans[impl] = planner.build_deployment(params, planner_throughput.SPEC, cfg,
                                               pool=pools[impl], device=dev)
        torch.cuda.synchronize()
        walls[impl] = time.perf_counter() - t1
        c = counts()
        if impl == "bool" and (any(c.values()) or sort_ops.LAUNCHES["SORT"] != sorts):
            fail(f"the bool oracle's pool plan launched {c} (want no kernel, no plain version)")
        b1 += c["B1"] if impl == "packed" else 0
    a, b = pools["packed"], pools["bool"]
    if not (planner_throughput.same_plans(plans["packed"], plans["bool"])
            and np.array_equal(a.wear, b.wear) and np.array_equal(a.state, b.state)
            and a.stats() == b.stats()):
        fail("the bool oracle's pool walk differs from the packed one")
    say(f"phase bool-oracle: gemma-2b x{r['layers']} at {r['max_elems']} weights a tensor "
        f"({r['n_tensors']} tensors, {r['n_elements'] / 1e6:.2f}M weights, p_stuck "
        f"{r['p_stuck']}): stateless packed {r['time_packed_s']:.3f} s, bool "
        f"{r['time_bool_s']:.3f} s ({r['speedup']:.2f}x), the CPU's packed "
        f"{r['time_cpu_s']:.3f} s: reports and w_hat bytes identical; through one lpt pool "
        f"each: packed {walls['packed']:.3f} s, bool {walls['bool']:.3f} s: reports, w_hat "
        f"bytes, pool state and wear identical (total writes {a.stats().total_writes}); the "
        f"bool runs launched no kernel; {time.perf_counter() - t0:.1f} s")
    del params, plans, pools
    torch.cuda.empty_cache()
    return b1


def figures_breakdown(dev) -> None:
    """Where fig7's time goes on its largest model (vit-base, 78M weights at
    the 2M cap): drawing the weights, building the sorted planes, pricing
    the jobs (B1) and the lockstep speedups, each synchronized; then one
    traced run for the device's busy share and top kernels."""
    import torch

    from benchmarks_torch import common, fig7_greedy
    from repro_torch.core import schedule

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ws, t_draw = timed(lambda: [w for _, w in common.model_weights("vit-base", device=dev)])
    n = sum(w.numel() for w in ws)
    del ws
    planes, t_planes = timed(lambda: common.model_planes("vit-base", cols=fig7_greedy.COLS,
                                                         device=dev))
    chains = schedule.stride_1_chains(planes.shape[0], fig7_greedy.THREADS)
    jobs, t_price = timed(lambda: schedule.schedule_job_costs(planes, chains))
    _, t_lock = timed(lambda: [schedule.lockstep_speedup(jobs, fig7_greedy.THREADS, sort_jobs=s)
                               for s in (False, True)])
    del planes, jobs
    torch.cuda.empty_cache()
    say(f"phase figures-time: fig7 vit-base ({n} weights): draw {t_draw:.3f} s "
        f"({n / t_draw / 1e6:.1f} M normals/s), sorted planes {t_planes:.3f} s (the draw "
        f"included), B1 pricing {1e3 * t_price:.2f} ms ({len(chains)} chains), lockstep "
        f"{1e3 * t_lock:.2f} ms")
    say(f"phase trace: fig7 vit-base: "
        f"{trace(lambda: fig7_greedy.run(['vit-base'], device=dev))}")


def train_phase(dev) -> dict:
    """The trainer at internlm2-1.8b's full width (depth 2): ``launch.train``'s
    loop for 8 steps with checkpoints and redeploy pricing every 4, each
    loss held to the reference's, then again from the step-4 checkpoint.  Deterministic algorithms are on for
    the phase, and the resumed run's losses and final params must equal the
    straight run's bit for bit.  Returns the B1 launches and the numbers
    PERF.md records."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch import prng, tree
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api, attention

    root = Path(tempfile.mkdtemp(prefix="repro_train_ckpt_"))
    free = shutil.disk_usage(root).free
    say(f"phase train: checkpoints under {root}, {free / 1e9:.1f} GB free")
    if free < TRAIN_DISK_BYTES:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"phase train needs {TRAIN_DISK_BYTES / 1e9:.0f} GB free for its checkpoints, "
             f"{free / 1e9:.1f} GB there")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        loop = train_cli.build_loop("internlm2-1.8b", ckpt_dir=str(root), device=dev, **TRAIN)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = loop.cfg
        n_params = sum(p.numel() for p in tree.leaves(loop.params))
        say(f"phase train: internlm2-1.8b d_model={cfg.d_model} heads={cfg.n_heads} "
            f"kv={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
            f"vocab={cfg.vocab_size} {cfg.dtype} compute on f32 masters; depth cut 24 -> "
            f"{cfg.n_layers} (the only cut); {n_params / 1e6:.1f}M params; init {init_s:.2f} s; "
            f"{TRAIN['task']} task, batch {TRAIN['batch']}, seq {TRAIN['seq']}, lr {TRAIN['lr']}, "
            f"{TRAIN['steps']} steps, remat {TRAIN['remat']}")
        # the redeploy pricing timed, its peak memory apart from training's
        priced = []  # (step, seconds, peak bytes) of each pricing
        peaks: list[int] = []  # training's peak before each pricing
        price = loop._price_redeploy

        def timed_price(step):
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            price(step)
            torch.cuda.synchronize()
            priced.append((step, time.perf_counter() - t1, torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

        loop._price_redeploy = timed_price
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = loop.run()
        wall = time.perf_counter() - t0
        c = counts()
        peak_train = max(peaks + [torch.cuda.max_memory_allocated()])
        peak = max([peak_train] + [p for _, _, p in priced])
        log = res["metrics_log"]
        for r in log:
            say(f"  step {r['step']}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
                f"lr {r['lr']:.3e} wall_s {r['wall_s']:.4f}")
        losses = [r["loss"] for r in log]
        tokens = TRAIN["batch"] * TRAIN["seq"]
        later = [r["wall_s"] for r in log[1:]]
        tps = tokens * len(later) / sum(later)
        ck = loop.ckpt.timings
        say(f"phase train: {len(log)} steps in {wall:.2f} s (checkpoints and pricing included); "
            f"{tps:.1f} tokens/s after step 1 (step wall {sum(later) / len(later):.4f} s), "
            f"step 1 {log[0]['wall_s']:.3f} s; peak CUDA memory {peak / 1e9:.2f} GB (training "
            f"{peak_train / 1e9:.2f} GB, redeploy pricing {priced[-1][2] / 1e9:.2f} GB); redeploy "
            f"pricing " + ", ".join(f"step {st} {sec:.2f} s" for st, sec, _ in priced) + "; "
            f"checkpoints: " + "; ".join(
                f"step {t['step']} {t['bytes'] / 1e9:.2f} GB host copy {t['host_copy_s']:.2f} s "
                f"write {t.get('write_s', float('nan')):.2f} s" for t in ck))
        want_blockwise = cfg.n_layers * TRAIN["steps"]
        if not all(map(math.isfinite, losses)) or len(losses) != TRAIN["steps"]:
            fail(f"train losses {losses}")
        if not losses[-1] < losses[0]:
            fail(f"the step-{TRAIN['steps']} loss {losses[-1]} is not below step 1's {losses[0]}")
        gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
        gold = gold["trainer"]
        if any(gold[k] != TRAIN[k] for k in ("layers", "batch", "seq", "lr", "remat", "task",
                                             "seed")) or gold["total_steps"] != TRAIN["steps"]:
            fail(f"the golden trainer entry is another cell: {gold}")
        rels = [abs(a - b) / b for a, b in zip(losses, gold["losses"])]
        say(f"phase train: losses against the reference's (XLA:CPU, {len(gold['losses'])} steps, "
            f"{gold['compile_seconds_cpu']:.1f} s compile + "
            f"{sum(gold['step_seconds_cpu']):.1f} s of CPU steps): rel " + " ".join(
                f"{i + 1}:{r:.2e}" for i, r in enumerate(rels))
            + f" (bound {TRAIN_GOLDEN_RTOL:g})")
        if not rels or max(rels) > TRAIN_GOLDEN_RTOL:
            fail("the card's losses are outside their bf16 bound of the reference's")
        other_plain = c["plain"] - attention.blockwise_attention.calls
        if (c["B1"] <= 0 or c["B3"] or other_plain
                or attention.blockwise_attention.calls != want_blockwise
                or any(c[k] for k in c if k not in ("B1", "plain"))):
            fail(f"train launched {c}, blockwise_attention {attention.blockwise_attention.calls} "
                 f"times (want B1 > 0, B3 0, blockwise_attention {want_blockwise}, no other "
                 f"kernel or plain-version call)")
        rlog = res["redeploy_log"]
        if [(r["step"], r["tensor"]) for r in rlog] != [(8, "head/w"),
                                                         (8, "segments/0/mlp/wi_gate")]:
            fail(f"redeploy log {[(r['step'], r['tensor']) for r in rlog]}")
        for r in rlog:
            if set(r) != REDEPLOY_KEYS or not 0 < r["transitions_sws"] <= r["n_bits"]:
                fail(f"redeploy record {r}")
            say(f"  redeploy step {r['step']} {r['tensor']}: in place {r['transitions_natural']} "
                f"(sws {r['transitions_sws']}) of {r['n_bits']} bits; chains stale "
                f"{r['chain_stale_sws']} fresh {r['chain_fresh_sws']} pool {r['chain_pool']} "
                f"(stale-sort streaming {r['stale_sort_speedup']:.4f}x); pool max cell "
                f"{r['pool_max_cell_writes']} writes, total {r['pool_total_writes']}")
        say(f"phase train: B1 launches {c['B1']}, B3 0, blockwise_attention (the training "
            f"attention, not a fallback) {want_blockwise}, no other plain-version call")

        # the bf16 step-1 loss against the f32 loss of the initial params
        params0 = api.init(prng.PRNGKey(TRAIN["seed"]), cfg, device=dev)
        batch0 = loop.dataset.batch_at(0)
        with torch.no_grad():
            l32 = float(steps_mod.loss_fn(params0, dataclasses.replace(cfg, dtype="float32"),
                                          batch0)[0])
        d32 = abs(losses[0] - l32) / l32
        say(f"phase train: step-1 loss {losses[0]:.6f} (bf16) vs {l32:.6f} (f32, same params "
            f"and batch): rel {d32:.2e} (bounds {TRAIN_BF16_MIN_REL:g} to {TRAIN_F32_RTOL:g})")
        if not TRAIN_BF16_MIN_REL <= d32 <= TRAIN_F32_RTOL:
            fail("the bf16 step-1 loss is outside its bounds of the f32 loss: too far, or so "
                 "close that the step did not compute in bf16")

        # one traced step at full width (from the params after step 8)
        batch8 = loop.dataset.batch_at(TRAIN["steps"])
        say(f"phase trace: full-width train step: "
            f"{trace(lambda: loop.train_step(loop.params, loop.opt_state, batch8), top=8)}")
        del params0

        # again from the step-4 checkpoint
        shutil.rmtree(root / f"step_{TRAIN['steps']:08d}")
        params8 = loop.params
        del loop
        torch.cuda.empty_cache()
        loop2 = train_cli.build_loop("internlm2-1.8b", ckpt_dir=str(root), device=dev, **TRAIN)
        if loop2.start_step != TRAIN["ckpt_every"]:
            fail(f"the resumed run starts at step {loop2.start_step}, not {TRAIN['ckpt_every']}")
        log2 = loop2.run()["metrics_log"]
        got, want = [r["loss"] for r in log2], losses[TRAIN["ckpt_every"]:]
        same = got == want and all(torch.equal(a, b) for a, b in
                                   zip(tree.leaves(loop2.params), tree.leaves(params8)))
        say(f"phase train-resume: from step {loop2.start_step}: steps "
            f"{[r['step'] for r in log2]} losses {['%.6f' % x for x in got]}; losses and final "
            f"params bit-identical to the straight run's (deterministic algorithms): {same}")
        if [r["step"] for r in log2] != list(range(TRAIN["ckpt_every"] + 1, TRAIN["steps"] + 1)) \
                or not same:
            fail("the resumed run does not replay the straight run bit for bit")
        del loop2, params8
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"B1": c["B1"], "tokens_per_s": tps, "peak_gb": peak / 1e9,
            "step_s": sum(later) / len(later)}


def accuracy_phase(dev) -> dict:
    """The reference's trained-LM setting on the card: train reduced internlm2
    (120 steps, copy task, remat full) from the reference's key and batches,
    then fig9's p sweep, fig10's column sweep and accuracy_e2e, each on the
    reference's weights (golden npz; held to the reference exactly) and on
    the card-trained weights (within stated tolerances)."""
    import torch

    from benchmarks_torch import accuracy_e2e, fig9_p_sweep, fig10_columns, trained_lm
    from repro_torch.models import attention

    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    gold = gold["accuracy"]
    reset_counts()
    t0 = time.perf_counter()
    losses = trained_lm.train_losses(device=dev)
    train_s = time.perf_counter() - t0
    c_train = counts()
    blockwise_train = attention.blockwise_attention.calls
    rel = max(abs(a - b) / b for a, b in zip(losses, gold["train_losses"]))
    say(f"phase accuracy: reduced internlm2 trained on the card in {train_s:.2f} s "
        f"({trained_lm.STEPS} steps): loss " + " ".join(
            f"{i + 1}:{losses[i]:.4f}" for i in (0, 9, 29, 59, 89, 119))
        + f"; max rel to the reference's {rel:.2e} (bound {ACC_LOSS_RTOL:g})")
    if rel > ACC_LOSS_RTOL:
        fail("the card's 120 training losses are outside their bound of the reference's")
    # remat "full": each step's forward and its recompute run blockwise_attention per layer
    want_bw = 2 * 2 * trained_lm.STEPS
    if c_train["B3"] or blockwise_train != want_bw or c_train["plain"] != want_bw:
        fail(f"training launched {c_train}, blockwise_attention {blockwise_train} (want B3 0, "
             f"blockwise_attention {want_bw}, no other plain-version call)")

    lms = {"reference weights": trained_lm.reference_lm(device=dev),
           "card-trained": trained_lm.get_trained_lm(device=dev)}
    reset_counts()
    t0 = time.perf_counter()
    out = {}
    for label, lm in lms.items():
        recs = {"fig9": {}, "fig10": {}, "e2e": {}}
        res = {"fig9": fig9_p_sweep.accuracy_sweep(device=dev, lm=lm, record=recs["fig9"]),
               "fig10": fig10_columns.accuracy_sweep(device=dev, lm=lm, record=recs["fig10"]),
               "e2e": accuracy_e2e.run(device=dev, lm=lm, record=recs["e2e"])}
        out[label] = res
        e2e, ge = res["e2e"], gold["e2e"]
        if label == "reference weights":
            for fig in ("fig9", "fig10", "e2e"):
                diffs = trained_lm.golden_differences(recs[fig], gold[f"{fig}_evals"])
                if diffs:
                    fail(f"{fig} on the reference's weights: " + "; ".join(diffs[:5]))
            for fig in ("fig9", "fig10"):
                d = first_difference(json.loads(json.dumps(res[fig])), gold[fig])
                if d:
                    fail(f"{fig} accuracy sweep on the reference's weights differs at {d}")
            for k in ("top1_agreement", "logit_kl"):
                if abs(e2e[k] - ge[k]) > ACC_PROBE_ABS:
                    fail(f"e2e {k} {e2e[k]} vs the reference's {ge[k]}")
            kl_rel = abs(e2e["logit_kl"] - ge["logit_kl"]) / ge["logit_kl"]
            say(f"phase accuracy ({label}): logit KL {e2e['logit_kl']:.6e} vs the reference's "
                f"{ge['logit_kl']:.6e}: rel {kl_rel:.2e} (bound {ACC_KL_RTOL:g})")
            if not kl_rel <= ACC_KL_RTOL:
                fail("e2e logit KL is outside its relative bound of the reference's")
            rest = {k: v for k, v in e2e.items() if k not in ("top1_agreement", "logit_kl")}
            d = first_difference(json.loads(json.dumps(rest)),
                                 {k: v for k, v in ge.items() if k in rest})
            if d:
                fail(f"accuracy_e2e on the reference's weights differs at {d}")
        else:
            r9, g9 = res["fig9"], gold["fig9"]
            bad = abs(r9["fp_accuracy"] - g9["fp_accuracy"]) > ACC_FP_ABS
            for p, r in r9["per_p"].items():
                w = g9["per_p"][p]
                bad |= abs(r["accuracy"] - w["accuracy"]) > ACC_SWEEP_ABS
                bad |= abs(r["total_speedup"] / w["total_speedup"] - 1) > ACC_SPEEDUP_RTOL
            for cols, r in res["fig10"]["per_cols"].items():
                bad |= abs(r["accuracy"] - gold["fig10"]["per_cols"][cols]["accuracy"]) > \
                    ACC_SWEEP_ABS
            bad |= abs(e2e["accuracy_cim"] - ge["accuracy_cim"]) > ACC_SWEEP_ABS
            bad |= abs(e2e["total_speedup"] / ge["total_speedup"] - 1) > ACC_SPEEDUP_RTOL
            if bad:
                fail(f"the card-trained sweeps are outside their bounds of the reference's: {res}")
        say(f"phase accuracy ({label}): fp {res['fig9']['fp_accuracy']:.6f}; fig9 " + "  ".join(
            f"p={p}: acc {r['accuracy']:.6f} speedup {r['total_speedup']:.6f}x"
            for p, r in res["fig9"]["per_p"].items()))
        say(f"phase accuracy ({label}): fig10 " + "  ".join(
            f"cols={c}: {r['accuracy']:.6f}" for c, r in res["fig10"]["per_cols"].items()))
        say(f"phase accuracy ({label}): e2e p=0.5 128x10: fp {e2e['accuracy_fp']:.6f} cim "
            f"{e2e['accuracy_cim']:.6f} (drop {e2e['accuracy_drop_pct']:+.4f}%), top1 agreement "
            f"{e2e['top1_agreement']:.6f}, logit KL {e2e['logit_kl']:.4e}, sws "
            f"{e2e['sws_speedup']:.6f}x total {e2e['total_speedup']:.6f}x")
        say(f"phase accuracy ({label}):" + accuracy_e2e.paper_check(e2e)[1])
    sweep_s = time.perf_counter() - t0
    c = counts()
    # B3 per eval_accuracy: 4 batches x 2 layers; per weight set 6 (fig9) + 8 (fig10) + 2
    # (e2e) evaluations, and e2e's probes 4 forwards of 2 layers
    want_b3 = len(lms) * ((6 + 8 + 2) * 4 * 2 + 4 * 2)
    if c["B3"] != want_b3 or c["B3_tc"] or c["B1"] <= 0 or c["plain"] or any(
            c[k] for k in c if k not in ("B1", "B3", "B3_tc", "plain")):
        fail(f"the accuracy sweeps launched {c} (want B3 {want_b3} on the FMA kernel, B1 > 0, "
             f"nothing else, no plain-version call)")
    say(f"phase accuracy: sweeps on both weight sets in {sweep_s:.2f} s; B3 launches {c['B3']} "
        f"(predicted {want_b3}), B1 {c['B1']}, plain-version calls 0; the reference's weights "
        f"give the reference's predictions, totals and speedups exactly")
    return {"B1": c["B1"], "B3": c["B3"]}



def offset_binary_phase(dev, sm_totals: dict) -> dict:
    """gemma-2b at its published width (LAYERS layers), planned stateless
    with ``CrossbarSpec(encoding="offset_binary")`` and served dense, packed
    (B2), packed const_rle (B4) and planes_int8 (B6 builds, B5 serves),
    each through the decode graph and the eager loop (``served``'s gates).
    Fails unless packed and int8 prefill logits lie within dense's bound,
    const_rle tokens equal raw-packed tokens, and B6's integers equal
    ``round((w_hat - offset) / scale)`` on every planned tensor.  Returns
    the main path's launch counts."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, simulator
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=LAYERS)
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    spec = planner.CrossbarSpec(rows=128, cols=10, encoding="offset_binary")
    pcfg = planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    c_plan = counts()
    if c_plan["B1"] <= 0 or any(c_plan[k] for k in c_plan if k not in ("B1", "plain")) \
            or c_plan["plain"]:
        fail(f"offset_binary plan launched {c_plan}")
    tot = plan.totals()
    say(f"phase offset-binary: gemma-2b x{LAYERS} layers, {len(plan.reports)} tensors planned "
        f"offset_binary (p_stuck {P_STUCK}, min_size {pcfg.min_size}) in {plan_s:.2f} s, B1 "
        f"launches {c_plan['B1']}: transitions {tot['transitions_baseline']} -> "
        f"{tot['transitions_sws']} -> {tot['transitions_final']}, sws {tot['sws_speedup']:.4f}x "
        f"total {tot['total_speedup']:.4f}x; sign_magnitude: {sm_totals['transitions_baseline']} "
        f"-> {sm_totals['transitions_sws']} -> {sm_totals['transitions_final']}, sws "
        f"{sm_totals['sws_speedup']:.4f}x total {sm_totals['total_speedup']:.4f}x")

    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    want = 7 * LAYERS * GEN
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    p_rle = planner.deploy_params(params, plan, materialize="packed", codec=CODEC)
    if any(bool(d["sign_packed"].any()) for d in _operand_dicts(p_packed)):
        fail("offset_binary packed operands carry a negative sign bit")
    tok_dense, tps_dense, _, _ = served("offset_binary dense", cfg, p_dense, batch, GEN, None, 0)
    tok_packed, tps_packed, _, c2 = served("offset_binary packed", cfg, p_packed, batch, GEN,
                                           "B2", want, want_tc=want)
    tok_rle, tps_rle, _, c4 = served(f"offset_binary packed {CODEC}", cfg, p_rle, batch, GEN,
                                     "B4", want, want_tc=want)
    if not torch.equal(tok_rle, tok_packed):
        fail(f"offset_binary {CODEC} tokens differ from raw-packed tokens")
    logit_check(cfg, p_dense, p_packed, batch, "offset_binary packed")
    logit_check(cfg, p_dense, p_rle, batch, f"offset_binary packed {CODEC}")
    del p_rle
    torch.cuda.empty_cache()

    p_int8, c6 = deploy_int8(params, plan)
    n_eq = 0
    for name, w_hat in plan.deployed.items():
        op = _at(p_int8, name)
        if not isinstance(op, dict):
            continue  # served dense (the norm gains)
        r = plan.reports[name]
        scale = torch.tensor(r.scale, dtype=torch.float32, device=dev)
        offset = torch.tensor(r.offset, dtype=torch.float32, device=dev)
        q = torch.clamp(torch.round((w_hat.to(torch.float32) - offset) / scale), 0,
                        2**spec.cols - 1).to(torch.int32)
        old = simulator.int8_plane_operands(q, torch.ones_like(q, dtype=torch.int8), scale,
                                            offset, spec.cols)["splanes"]
        if not torch.equal(old, op["splanes"]):
            fail(f"B6 planes of offset_binary {name} differ from round((w_hat - offset) / scale)")
        n_eq += 1
        del q, old
    say(f"phase offset-binary-B6: planes of all {n_eq} planned matmul tensors, built by "
        f"{c6['B6']} B6 launches on w_hat - offset, equal round((w_hat - offset) / scale) bit "
        f"for bit")
    tok_int8, tps_int8, _, c5 = served("offset_binary planes_int8", cfg, p_int8, batch, GEN, "B5",
                                       want, want_tc=want)
    logit_check(cfg, p_dense, p_int8, batch, "offset_binary planes_int8")
    agree = {label: (t == tok_dense).float().mean().item()
             for label, t in (("packed", tok_packed), ("planes_int8", tok_int8))}
    say(f"phase offset-binary: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16; tok/s "
        f"dense {tps_dense:.1f}, packed {tps_packed:.1f}, packed {CODEC} {tps_rle:.1f}, "
        f"planes_int8 {tps_int8:.1f}; token agreement with dense {agree}; B2 {c2['B2']} (tc "
        f"{c2['B2_tc']}), B4 {c4['B4']} (tc {c4['B4_tc']}), B5 {c5['B5']} (tc {c5['B5_tc']}), "
        f"want {want} each; B6 {c6['B6']}; plain-version calls 0; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del p_int8, p_dense, p_packed, plan, params
    torch.cuda.empty_cache()
    return {"B1": c_plan["B1"], "B2": c2["B2"], "B2_tc": c2["B2_tc"], "B4": c4["B4"],
            "B4_tc": c4["B4_tc"], "B5": c5["B5"], "B5_tc": c5["B5_tc"], "B6": c6["B6"],
            "B3": c2["B3"] + c4["B3"] + c5["B3"], "B3_tc": c2["B3_tc"] + c4["B3_tc"] + c5["B3_tc"]}


def bench_extra_phase(dev) -> dict:
    """The port's pool_wear, plane_compression and redeploy_delta on the
    card, held to the reference (golden file): pool_wear at the golden's
    deployments with the reference's drift stds, every integer and float
    equal; plane_compression at the golden's caps, every transition and
    byte count equal and tokens_match_dense for every codec (served through
    B2/B4); redeploy_delta on the reference's weights (every integer equal)
    and on the card's own chain (speedups within REDEPLOY_SPEEDUP_RTOL).
    Returns the launch counts."""
    import torch

    from benchmarks_torch import plane_compression, pool_wear, redeploy_delta
    from repro_torch.models import attention

    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    t_phase = time.perf_counter()
    out = {k: 0 for k in ("B1", "B2", "B2_tc", "B3", "B3_tc", "B4", "B4_tc")}

    def tally(c, label, allowed):
        if c["plain"] or any(c[k] for k in c if k not in allowed and k != "plain"):
            fail(f"{label} launched {c} (want only {sorted(allowed)}, no plain-version call)")
        for k in out:
            out[k] += c.get(k, 0)

    gp = gold["pool_wear"]
    reset_counts()
    t0 = time.perf_counter()
    rp = pool_wear.run(deployments=gp["deployments"], p_stuck=gp["p_stuck"], seed=gp["seed"],
                       stds=gp["stds"], device=dev)
    pw_s = time.perf_counter() - t0
    c = counts()
    tally(c, "pool_wear", {"B1"})
    for lev, want in gp["levelings"].items():
        got = {k: v for k, v in rp["levelings"][lev].items() if k != "seconds"}
        d = first_difference(json.loads(json.dumps(got)), want)
        if d:
            fail(f"pool_wear {lev} on the card differs from the reference at {d}")
    if rp["max_wear_reduction_lpt_vs_none"] != gp["max_wear_reduction_lpt_vs_none"]:
        fail("pool_wear's LPT max-wear reduction differs from the reference's")
    say(f"phase bench-extra: pool_wear {gp['deployments']} deployments x 4 levelings in "
        f"{pw_s:.2f} s (B1 {c['B1']}), the reference's drift stds: " + "; ".join(
            f"{lev} max {r['max_cell_writes']} mean {r['mean_cell_writes']:.4f} total "
            f"{r['total_writes']} imbalance {r['crossbar_imbalance']:.4f}"
            for lev, r in rp["levelings"].items())
        + f"; LPT / none {rp['max_wear_reduction_lpt_vs_none']:.4f}x; all equal to the "
        f"reference's")

    gc = gold["plane_compression"]
    cfg_c = gc["config"]
    reset_counts()
    t0 = time.perf_counter()
    rc = plane_compression.run(list(gc["models"]), cfg_c["codecs"], max_elems=cfg_c["max_elems"],
                               l_crossbars=cfg_c["l_crossbars"], seed=gc["seed"], gen=gc["gen"],
                               device=dev)
    torch.cuda.synchronize()
    pc_s = time.perf_counter() - t0
    c = counts()
    tally(c, "plane_compression", {"B1", "B2", "B2_tc", "B3", "B4", "B4_tc"})
    if c["B1"] <= 0 or c["B2"] <= 0 or c["B4"] <= 0 or c["B3"] <= 0:
        fail(f"plane_compression launched {c} (want B1, B2, B3 and B4)")
    d = first_difference(json.loads(json.dumps(rc["models"])), gc["models"])
    if d:
        fail(f"plane_compression on the card differs from the reference at {d}")
    srv, gsrv = rc["serving"]["codecs"], gc["serving"]["codecs"]
    byte_keys = ("plane_bytes", "sign_bytes", "meta_bytes", "total_bytes", "n_weights")
    for codec, want in gsrv.items():
        if {k: srv[codec][k] for k in byte_keys} != {k: want[k] for k in byte_keys}:
            fail(f"plane_compression serving bytes of {codec} differ from the reference's")
        if not srv[codec]["tokens_match_dense"]:
            fail(f"plane_compression: {codec} tokens differ from dense on the card")
    same_tokens = {codec: srv[codec]["tokens"] == want["tokens"] for codec, want in gsrv.items()}
    say(f"phase bench-extra: plane_compression {list(gc['models'])} at max_elems "
        f"{cfg_c['max_elems']} in {pc_s:.2f} s (B1 {c['B1']}, B2 {c['B2']}, B4 {c['B4']}, B3 "
        f"{c['B3']}): " + "; ".join(
            f"{m} {codec} {r['transitions']} ({r['transition_reduction_vs_raw']:.4f}x) "
            f"{r['total_bytes']} B" for m, e in rc["models"].items()
            for codec, r in e["codecs"].items())
        + f"; all equal to the reference's; serving bytes equal, tokens_match_dense for every "
        f"codec; tokens equal to the reference's: dense "
        f"{rc['serving']['tokens_dense'] == gc['serving']['tokens_dense']}, {same_tokens} "
        f"(not a gate)")

    gr = gold["redeploy_delta"]
    reset_counts()
    t0 = time.perf_counter()
    rr = redeploy_delta.run(device=dev, reference_weights=True)
    c = counts()
    tally(c, "redeploy_delta (reference weights)", {"B1"})
    if rr["tensors"] != gr["tensors"] or list(rr["tensors"]) != list(gr["tensors"]):
        fail(f"redeploy_delta on the reference's weights differs: {rr['tensors']}")
    reset_counts()
    own = redeploy_delta.run(device=dev)
    c_own = counts()
    # the further steps' forwards run blockwise_attention (autograd), remat
    # "full" twice a layer a step
    bw = attention.blockwise_attention.calls
    tally({**c_own, "plain": c_own["plain"] - bw}, "redeploy_delta (own chain)", {"B1"})
    rd_s = time.perf_counter() - t0
    worst = 0.0
    for name, want in gr["tensors"].items():
        got = own["tensors"][name]
        for k in ("stale_sort_speedup", "fresh_sort_speedup"):
            worst = max(worst, abs(got[k] / want[k] - 1))
    if not worst <= REDEPLOY_SPEEDUP_RTOL:
        fail(f"redeploy_delta's own chain: speedups {worst:.3e} from the reference's (bound "
             f"{REDEPLOY_SPEEDUP_RTOL:g}): {own['tensors']}")
    say(f"phase bench-extra: redeploy_delta in {rd_s:.2f} s: on the reference's weights every "
        f"integer equal ({', '.join(gr['tensors'])}); the card's own chain (trained here, 20 "
        f"steps more, blockwise_attention {bw}) speedups within {worst:.3e} of the reference's "
        f"(bound {REDEPLOY_SPEEDUP_RTOL:g}): " + "; ".join(
            f"{n} stale {r['stale_sort_speedup']:.4f}x fresh {r['fresh_sort_speedup']:.4f}x"
            for n, r in own["tensors"].items()))
    say(f"phase bench-extra: launches {out}; phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return out


def _drifted(p_packed, model, dev):
    """The packed deployment with ``nonideal.perturb_operands(op_i, model,
    fold_in(PRNGKey(7), i))`` applied to its i-th operand dict."""
    from repro_torch import prng
    from repro_torch.core import nonideal

    key, count = prng.PRNGKey(7, device=dev), [0]

    def walk(t):
        if isinstance(t, dict) and "planes_packed" in t:
            count[0] += 1
            return nonideal.perturb_operands(t, model, prng.fold_in(key, count[0] - 1))
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(p_packed), count[0]


def _tensor_bytes(obj) -> dict:
    """Bytes of the tensors and numpy arrays an object's fields hold, by
    where they live ("host" or the device's type)."""
    import numpy as np
    import torch

    out: dict = {}
    items = obj.values() if isinstance(obj, dict) else vars(obj).values()
    for v in items:
        if isinstance(v, torch.Tensor):
            where = "host" if v.device.type == "cpu" else v.device.type
            out[where] = out.get(where, 0) + v.numel() * v.element_size()
        elif isinstance(v, np.ndarray):
            out["host"] = out.get("host", 0) + v.nbytes
    return out


def faults_phase(dev) -> dict:
    """Faults and integrity at gemma-2b's published width (LAYERS layers).

    (a) plan through a 32-crossbar pool with stuck cells (FAULT_MODEL,
    ``PRNGKey(42)``), leveling ``none`` and ``fault``, beside a fault-free
    plan; a CPU pool with the same faults plans the same tensors up to
    CHECK_TENSOR with the same damage matrices, assignment, state, wear,
    ``achieved_read`` and ``w_hat`` bytes.  (b) the fault-leveled plan
    served packed (B2) and planes_int8 (B6 builds, B5 serves) through the
    serve gates; shadow-batch KL against fp and the recovery printed.  (c)
    drifted operands (DRIFT_MODEL): one prefill on B2's FMA kernel with
    gains, and each drifted operand within B2's bound of its densified
    weights.  (d) an integrity-enabled deployment (INTEGRITY_CFG), a storm
    (STORM_RATES), scrub to a clean cycle: detected, reads restored, repair
    <= 0.5x a full reprogram, the rebuilt packed deployment serving the
    pre-storm tokens.  (e) ``benchmarks_torch.fault_tolerance`` and
    ``integrity_scrub`` held to the golden file.  Returns the launches."""
    import torch

    from benchmarks_torch import common, fault_tolerance, integrity_scrub
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import integrity, nonideal, planner, pool, simulator
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.cim_matmul import ref as cim_ref
    from repro_torch.launch import serve
    from repro_torch.models import api

    t_phase = time.perf_counter()
    out = {k: 0 for k in ("B1", "B2", "B2_tc", "B2_gain", "B3", "B3_tc", "B5", "B5_tc", "B6")}

    def tally(c, label, allowed):
        if c["plain"] or any(c[k] for k in c if k not in allowed and k != "plain"):
            fail(f"{label} launched {c} (want only {sorted(allowed)}, no plain-version call)")
        for k in out:
            out[k] += c.get(k, 0)

    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=LAYERS)
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    model = nonideal.FaultModel(**FAULT_MODEL)

    # --- (a) fault-aware planning, held to a CPU pool ------------------------
    damage_log = {"s": 0.0, "calls": 0, "record": None}
    damage_matrix = nonideal.damage_matrix

    def timed_damage(packed, chains, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = damage_matrix(packed, chains, state)
        damage_log["s"] += time.perf_counter() - t0
        damage_log["calls"] += 1
        if damage_log["record"] is not None:
            damage_log["record"].append(d)
        return d

    def recording(xb, keep):
        """``xb.program`` keeping CHECK_TENSOR's assignment and read."""
        program = xb.program

        def run(*a, **kw):
            rep = program(*a, **kw)
            if kw.get("name") == CHECK_TENSOR:
                keep["assignment"] = rep.assignment.copy()
                keep["read"] = rep.achieved_read.cpu()
                keep["state"], keep["wear"] = xb.state, xb.wear.copy()
            return rep

        xb.program = run

    nonideal.damage_matrix = timed_damage
    try:
        plans, pools, seconds, snaps = {}, {}, {}, {}
        for label, leveling, faulted in (("clean", "none", False), ("none", "none", True),
                                         ("fault", "fault", True)):
            xb = pool.CrossbarPool(spec, 2 * pcfg.crossbars, leveling=leveling, device=dev)
            if faulted:
                xb.inject_faults(model, prng.PRNGKey(FAULT_SEED))
            snaps[label] = {}
            recording(xb, snaps[label])
            damage_log["record"] = [] if label == "fault" else None
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[label] = planner.build_deployment(params, spec, pcfg, pool=xb, device=dev)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
            c = counts()
            tally(c, f"{label} fault plan", {"B1"})
            if c["B1"] <= 0:
                fail(f"{label} fault plan launched no B1")
            pools[label] = xb
            if label == "fault":
                card_damage = damage_log["record"]
        damage_s, damage_calls = damage_log["s"], damage_log["calls"]

        # the CPU pool: same faults, the same tensors up to CHECK_TENSOR
        cpu_pool = pool.CrossbarPool(spec, 2 * pcfg.crossbars, leveling="fault", device="cpu")
        cpu_pool.inject_faults(model, prng.PRNGKey(FAULT_SEED))
        cpu_snap = {}
        recording(cpu_pool, cpu_snap)
        damage_log["record"] = []
        keys = planner.tensor_keys(params, pcfg)
        weights = dict(planner.iter_weights(params, pcfg))
        names = list(weights)
        for name in names[: names.index(CHECK_TENSOR) + 1]:
            r_cpu, w_hat_cpu = planner.analyze_tensor(weights[name].cpu(), spec, pcfg, keys[name],
                                                      name=name, pool=cpu_pool)
        cpu_damage = damage_log["record"]
    finally:
        nonideal.damage_matrix = damage_matrix
    fstate = pools["fault"].faults
    if not (torch.equal(fstate.stuck0.cpu(), cpu_pool.faults.stuck0)
            and torch.equal(fstate.stuck1.cpu(), cpu_pool.faults.stuck1)):
        fail("the card's fault masks differ from the CPU's")
    n_up = len(cpu_damage)
    if n_up == 0 or any(not (a == b).all() for a, b in zip(card_damage[:n_up], cpu_damage)):
        fail(f"the card's damage matrices up to {CHECK_TENSOR} differ from the CPU's")
    snap = snaps["fault"]
    same_report(plans["fault"].reports[CHECK_TENSOR], r_cpu, f"{CHECK_TENSOR} (faulty pool)")
    if (snap["assignment"].tolist() != cpu_snap["assignment"].tolist()
            or not torch.equal(snap["read"], cpu_snap["read"])
            or snap["state"].tobytes() != cpu_snap["state"].tobytes()
            or not (snap["wear"] == cpu_snap["wear"]).all()
            or plans["fault"].deployed[CHECK_TENSOR].cpu().numpy().tobytes()
            != w_hat_cpu.numpy().tobytes()):
        fail(f"the CPU faulty pool after {CHECK_TENSOR} differs from the card's (assignment, "
             f"achieved_read, state, wear or w_hat)")
    del weights
    cells = fstate.fault_cells()
    say(f"phase faults: gemma-2b x{LAYERS}, a {2 * pcfg.crossbars}-crossbar pool with "
        f"{FAULT_MODEL} from PRNGKey({FAULT_SEED}): {int(cells.sum())} stuck cells (worst "
        f"crossbar {int(cells.max())}), {int(fstate.hot.sum())} hotspots; plans in "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; damage_matrix {damage_calls} calls in {damage_s:.2f} s (synchronized)")
    for label in plans:
        t, st = plans[label].totals(), pools[label].stats()
        say(f"phase faults: {label}: transitions {t['transitions_baseline']} -> "
            f"{t['transitions_sws']} -> {t['transitions_final']}, total {t['total_speedup']:.4f}x; "
            f"wear max {st.max_cell_writes} mean {st.mean_cell_writes:.4f} total "
            f"{st.total_writes}; crossbars used {int((pools[label].wear_totals() > 0).sum())}")
    say(f"phase faults-cpu: {CHECK_TENSOR} through a CPU pool with the same faults: "
        f"{n_up} damage matrices, the assignment {snap['assignment'].tolist()}, achieved_read, "
        f"state, wear and w_hat bytes identical to the card's")

    # --- (b) the fault-leveled deployment served ---------------------------------
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    want = 7 * LAYERS * GEN
    p_dense = planner.deploy_params(params, plans["fault"], materialize="dense")
    p_packed = planner.deploy_params(params, plans["fault"], materialize="packed")
    _, tps_dense, _, _ = served("fault-leveled dense", cfg, p_dense, batch, GEN, None, 0)
    tok_packed, tps_packed, _, c2 = served("fault-leveled packed", cfg, p_packed, batch, GEN, "B2",
                                           want, want_tc=want)
    tally(c2, "fault-leveled packed", {"B2", "B2_tc", "B3", "B3_tc"})
    logit_check(cfg, p_dense, p_packed, batch, "fault-leveled packed")
    p_int8, c6 = deploy_int8(params, plans["fault"])
    tally(c6, "fault-leveled int8 deployment", {"B6"})
    tok_int8, tps_int8, _, c5 = served("fault-leveled planes_int8", cfg, p_int8, batch, GEN, "B5",
                                       want, want_tc=want)
    tally(c5, "fault-leveled planes_int8", {"B5", "B5_tc", "B3", "B3_tc"})
    logit_check(cfg, p_dense, p_int8, batch, "fault-leveled planes_int8")
    del p_int8, p_dense
    torch.cuda.empty_cache()
    shadow = api.make_batch(cfg, prng.PRNGKey(0), 2, 16, device=dev)
    f = lambda p, b: api.forward(p, cfg, b)[0]  # noqa: E731
    kl = {}
    with torch.inference_mode():
        for label, plan in plans.items():
            p_hat = planner.deploy_params(params, plan, materialize="dense")
            kl[label] = common.logit_kl_f64(f, params, p_hat, shadow)
            del p_hat
    degradation = kl["none"] - kl["clean"]
    recovery = (kl["none"] - kl["fault"]) / degradation if degradation > 0 else 1.0
    say(f"phase faults-serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16; tok/s dense "
        f"{tps_dense:.1f}, packed {tps_packed:.1f}, planes_int8 {tps_int8:.1f}; B2 {c2['B2']} "
        f"(tc {c2['B2_tc']}), B5 {c5['B5']} (tc {c5['B5_tc']}), want {want} each; B6 {c6['B6']}; "
        f"shadow-batch (2 x 16) logit KL vs fp (float64, bf16 forward): clean {kl['clean']:.6e}, "
        f"none {kl['none']:.6e}, fault {kl['fault']:.6e}; remapping recovers "
        f"{100 * recovery:.1f}% (printed, not gated: random weights)")

    # --- (c) drifted operands on B2's FMA kernel with gains ----------------------
    drift = nonideal.FaultModel(**DRIFT_MODEL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_drift, n_ops = _drifted(p_packed, drift, dev)
    torch.cuda.synchronize()
    perturb_s = time.perf_counter() - t0
    del p_packed
    reset_counts()
    with torch.inference_mode():
        logits, _ = api.prefill(p_drift, cfg, batch)
    torch.cuda.synchronize()
    c = counts()
    expect = {"B2": 7 * LAYERS, "B2_gain": 7 * LAYERS, "B3": LAYERS, "B3_tc": LAYERS}
    if {k: v for k, v in c.items() if v and k != "plain"} != expect or c["plain"]:
        fail(f"drifted prefill launched {c} (want {expect}, no plain-version call)")
    if not bool(torch.isfinite(logits).all()):
        fail("drifted prefill logits are not finite")
    tally(c, "drifted prefill", set(expect))
    eps = torch.finfo(torch.float32).eps
    g = torch.Generator(device=dev).manual_seed(5)
    worst, n_checked = 0.0, 0
    for op in _operand_dicts(p_drift):
        for i in range(op["planes_packed"].shape[0]):
            op_i = {k: v[i] for k, v in op.items()}
            k_dim = op_i["kdim"].shape[-2]
            x = torch.randn(BATCH * PROMPT, k_dim, device=dev, generator=g)
            reset_counts()
            got = simulator.cim_linear(x, op_i)
            c_i = counts()
            if c_i["B2"] != 1 or c_i["B2_gain"] != 1 or c_i["plain"]:
                fail(f"a drifted operand's matmul launched {c_i}")
            tally(c_i, "drifted operand check", {"B2", "B2_gain"})
            w = simulator.densify_operands(op_i)
            want_y = x @ w
            err = (got - want_y).abs()
            bnd = B2_BOUND_C * eps * k_dim * (x.abs() @ w.abs())
            if not bool((err <= bnd).all()):
                fail(f"a drifted operand's B2 result is outside {B2_BOUND_C}*eps*K*(|x|@|w|) of "
                     f"densify_operands @ x: max err {err.max().item():.3e}")
            worst = max(worst, (err / bnd.clamp_min(1e-30)).max().item())
            n_checked += 1
            del w, want_y, x
    say(f"phase faults-drift: {n_ops} operand dicts perturbed ({DRIFT_MODEL}, key fold_in("
        f"PRNGKey(7), i)) in {perturb_s:.2f} s; one prefill: B2 {c['B2']} all with gains "
        f"(B2_gain {c['B2_gain']}), B3 {c['B3']}, no plain-version call; {n_checked} drifted "
        f"layer matmuls (M {BATCH * PROMPT}) within {worst:.3f} of B2's bound of "
        f"densify_operands @ x")
    del p_drift, logits
    torch.cuda.empty_cache()

    # --- (d) integrity: register, storm, scrub, rebuild --------------------------
    xb = pool.CrossbarPool(spec, 2 * pcfg.crossbars, leveling="lpt", device=dev)
    mgr = xb.enable_integrity(integrity.IntegrityConfig(**INTEGRITY_CFG))
    reg = {"s": 0.0}
    register = mgr.register

    def timed_register(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = register(*a, **kw)
        torch.cuda.synchronize()
        reg["s"] += time.perf_counter() - t0
        return rec

    mgr.register = timed_register
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan_i = planner.build_deployment(params, spec, pcfg, pool=xb, device=dev)
    torch.cuda.synchronize()
    plan_i_s = time.perf_counter() - t0
    tally(counts(), "integrity plan", {"B1"})
    rec_bytes: dict = {}
    for rec in mgr.tensors.values():
        for where, n in list(_tensor_bytes(rec).items()) + list(_tensor_bytes(rec.aux).items()):
            rec_bytes[where] = rec_bytes.get(where, 0) + n
    p_clean = planner.deploy_params(params, plan_i, materialize="packed")
    reset_counts()
    # the eager loop: every wrapper call below is a launch (a graph's capture
    # counts calls that record, not launch)
    tok_clean, _ = serve.generate(cfg, p_clean, batch, gen_len=GEN, loop="python")
    c = counts()
    tally(c, "pre-storm generate", {"B2", "B2_tc", "B3", "B3_tc"})
    del p_clean
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = mgr.storm(prng.PRNGKey(STORM_SEED), **STORM_RATES)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t0
    if mgr.verify_all():
        fail("the storm changed no read")
    reset_counts()
    t0 = time.perf_counter()
    rep = mgr.scrub_until_clean()
    torch.cuda.synchronize()
    scrub_s = time.perf_counter() - t0
    c_scrub = counts()
    tally(c_scrub, "scrub", {"B1"})
    full = mgr.transitions_full_affected()
    if rep.detections < 1 or not mgr.clean or not mgr.verify_all():
        fail(f"the scrub did not detect and repair the storm: {rep.to_dict()}, clean {mgr.clean}")
    if rep.repair_transitions > 0.5 * full:
        fail(f"repair cost {rep.repair_transitions} transitions > 0.5 x {full} (full reprogram)")
    if c_scrub["B1"] <= 0:
        fail("the repairs were priced without B1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_rep = planner.deploy_params(params, mgr.rebuild_plan(plan_i), materialize="packed")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    reset_counts()
    tok_rep, _ = serve.generate(cfg, p_rep, batch, gen_len=GEN, loop="python")
    tally(counts(), "post-repair generate", {"B2", "B2_tc", "B3", "B3_tc"})
    if not torch.equal(tok_rep, tok_clean):
        fail("the repaired deployment serves other tokens than the pre-storm deployment")
    say(f"phase faults-integrity: {len(mgr.tensors)} tensors, {mgr.total_tiles} tiles "
        f"({INTEGRITY_CFG}), planned and registered in {plan_i_s:.2f} s (register {reg['s']:.2f} "
        f"s); records hold {', '.join(f'{w} {n / 1e9:.3f} GB' for w, n in sorted(rec_bytes.items()))}; "
        f"storm {STORM_RATES} in {storm_s:.2f} s: {st['corrupted_bits']} bits corrupted, "
        f"{st['new_stuck_cells']} new stuck cells; scrub in {scrub_s:.2f} s: {rep.to_dict()}; "
        f"B1 {c_scrub['B1']}; repair {rep.repair_transitions} transitions vs {full} full "
        f"reprogram ({rep.repair_transitions / max(full, 1):.5f}x); rebuild_plan + packed "
        f"deploy {rebuild_s:.2f} s; repaired tokens == pre-storm tokens; reads restored")
    del p_rep, plan_i, mgr, xb, plans, pools, params
    torch.cuda.empty_cache()

    # --- (e) the two benchmarks, held to the golden file ---------------------------
    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    gf, gi = gold["fault_tolerance"], gold["integrity_scrub"]
    reset_counts()
    t0 = time.perf_counter()
    rf = fault_tolerance.run(rates=tuple(gf["rates"]), ref_rate=gf["ref_rate"], device=dev)
    ft_s = time.perf_counter() - t0
    tally(counts(), "fault_tolerance", {"B1", "B3"})
    worst_kl = 0.0
    for g_row, w_row in zip(rf["fault_curve"], gf["fault_curve"], strict=True):
        for k in ("rate", "stuck_cells", "hotspots"):
            if g_row.get(k) != w_row.get(k):
                fail(f"fault_tolerance {k} at rate {w_row['rate']}: {g_row.get(k)} vs "
                     f"{w_row.get(k)}")
        for lev in ("none", "fault"):
            rel = abs(g_row[f"kl_{lev}_f64"] / w_row[f"kl_{lev}_f64"] - 1)
            worst_kl = max(worst_kl, rel)
    d = first_difference(json.loads(json.dumps(rf["deploys"])), gf["deploys"]) or \
        first_difference(json.loads(json.dumps(rf["endurance"])), gf["endurance"])
    if d:
        fail(f"fault_tolerance on the card differs from the reference at {d}")
    reset_counts()
    t0 = time.perf_counter()
    ri = integrity_scrub.run(n_requests=gi["n_requests"], kl_rates=tuple(gi["kl_rates"]),
                             device=dev)
    is_s = time.perf_counter() - t0
    tally(counts(), "integrity_scrub", {"B1", "B3"})
    sr, gsr = dict(ri["storm_repair"]), dict(gi["storm_repair"])
    degraded = (sr.pop("streams_degraded_by_storm"), gsr.pop("streams_degraded_by_storm"))
    d = first_difference(json.loads(json.dumps(sr)), gsr)
    if d or integrity_scrub.check(ri):
        fail(f"integrity_scrub's storm and repair on the card differs from the reference at {d} "
             f"or fails its gates: {integrity_scrub.check(ri)}")
    for g_row, w_row in zip(ri["tolerated_kl"], gi["tolerated_kl"], strict=True):
        if (g_row["stuck_rate"], g_row["tolerated"], g_row["remaps"]) != \
                (w_row["stuck_rate"], w_row["tolerated"], w_row["remaps"]):
            fail(f"integrity_scrub tolerated-fault counters differ at {w_row['stuck_rate']}")
        worst_kl = max(worst_kl, abs(g_row["kl_f64"] / w_row["kl_f64"] - 1))
    if not worst_kl <= ACC_KL_RTOL:
        fail(f"the benchmarks' float64 logit KLs are {worst_kl:.3e} from the reference's (bound "
             f"{ACC_KL_RTOL:g})")
    say(f"phase faults-bench: fault_tolerance in {ft_s:.2f} s (stuck cells "
        f"{[r.get('stuck_cells', 0) for r in rf['fault_curve']]}, recovery "
        f"{100 * rf['recovery_at_ref']:.2f}% vs the reference's {100 * gf['recovery_at_ref']:.2f}%, "
        f"horizons {rf['endurance']['horizons']}), every deployment's wear and deployed bytes "
        f"equal to the reference's; integrity_scrub in {is_s:.2f} s: storm {sr['corrupted_bits']} "
        f"bits + {sr['new_stuck_cells']} stuck -> {sr['detections']} detections, "
        f"{sr['repair_transitions']} repair transitions ({100 * sr['repair_cost_ratio']:.2f}% of "
        f"a full reprogram), post-repair parity {sr['post_repair_parity']}, every counter equal "
        f"to the reference's; streams degraded by the storm {degraded[0]} (reference "
        f"{degraded[1]}, not a gate); float64 KLs within {worst_kl:.2e} of the reference's "
        f"(bound {ACC_KL_RTOL:g}); {overhead_note(ri['overhead'])}")
    say(f"phase faults: launches {out}; phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return out


# phase engine: gemma-2b x LAYERS (bf16) served by the continuous-batching
# engine, and the reduced f32 gemma-2b's parity cell held to the golden file
ENGINE_CFG = dict(max_slots=8, page_size=16, max_seq_len=160, prefill_chunk=32, decode_quantum=8)
ENGINE_TRACE = dict(n_requests=16, min_prompt=8, max_prompt=96, min_gen=2, max_gen=64, seed=0,
                    sample_every=4)
ENGINE_PASSES = 3
ENGINE_LAYERS = 1  # depth of phase engine's gemma-2b: the run's time limit bounds it
ENGINE_M = (1, 2, 4, 8, 16, 32, 64, 128, 256)  # the CIM kernels' bucketed row counts
ENGINE_CHUNKS = (1, 2, 4, 8, 16, 32)  # B3's bucketed query widths (the fused chunk stage)
ENGINE_PAGES = (1, 2, 4, 8, 13)  # page buckets of ENGINE_CFG (max_pages 13)


def engine_expect(name, layers, kernel) -> dict:
    """The port's kernels one replay of an engine graph ``name`` runs: 7
    planned matmuls a layer for each decode step and for the chunk stage
    (``kernel`` each, on its tensor-core kernel in bf16; none for dense),
    B3 once a layer for the chunk stage, on the tensor-core kernel."""
    kind, q = name[0], name[1] if name[0] != "prefill" else 0
    steps_ = {"decode": q, "prefill": 1, "fused": q + 1}[kind]
    out = {}
    if kernel:
        out = {kernel: 7 * layers * steps_, f"{kernel}_tc": 7 * layers * steps_}
    if kind != "decode":
        out.update(B3=layers, B3_tc=layers)
    return out


class PerRowB3:
    """While active, counts B3 wrapper calls with per-row (tensor)
    ``q_offset`` and ``kv_valid_len`` and those without."""

    def __enter__(self):
        import torch

        from repro_torch.kernels.flash_attention import ops as fa_ops

        self.rows = self.other = 0
        self._fa, self._orig = fa_ops, fa_ops.flash_attention

        def wrapped(q, k, v, kv_valid_len=None, **kw):
            if (isinstance(kw.get("q_offset"), torch.Tensor)
                    and isinstance(kv_valid_len, torch.Tensor)):
                self.rows += 1
            else:
                self.other += 1
            return self._orig(q, k, v, kv_valid_len, **kw)

        fa_ops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        self._fa.flash_attention = self._orig


def hold_engine_graphs(label, engines, c, rows, expect) -> tuple:
    """Hold the launches of ``engines`` (every engine a run built, dropped
    ones included) while the wrappers counted ``c`` and ``rows``
    (``PerRowB3``) watched B3: each engine's dispatches all replays of its
    graphs, each graph's kernel nodes ``expect(name)``'s (read from its node
    list), the wrappers' counts those of each capture's warm-up and capture
    (twice the graphs' nodes), every B3 call with per-row offsets and
    lengths, no plain-version call.  Returns (launches: node counts x
    replays + the warm-ups the wrappers counted, graphs, replays, graph pool
    bytes, seconds spent counting)."""
    t_count = time.perf_counter()
    nonzero = lambda d: {k: v for k, v in d.items() if k != "plain" and v}  # noqa: E731
    graphs, replays, pool_bytes, from_nodes, once = 0, 0, 0, {}, {}
    for i, eng in enumerate(engines):
        dispatches = sum(eng.stats[k] for k in ("decode_dispatches", "prefill_dispatches",
                                                "fused_dispatches"))
        mine = 0
        for (name, _), g in eng._graphs.items():
            want = expect(name)
            got = graph_counts(g)
            if nonzero(got) != want:
                fail(f"engine {label} #{i} graph {name} holds {nonzero(got)} of the port's "
                     f"kernels (want {want})")
            mine += g.replays
            for k, v in want.items():
                from_nodes[k] = from_nodes.get(k, 0) + v * g.replays
                once[k] = once.get(k, 0) + v
        gs = eng.graph_stats
        if mine != dispatches or len(eng._graphs) != gs["captured"] - gs["dropped"]:
            fail(f"engine {label} #{i}: {dispatches} dispatches but {mine} graph replays of "
                 f"{len(eng._graphs)} graphs ({gs['captured']} captured, {gs['dropped']} "
                 f"dropped)")
        graphs, replays, pool_bytes = graphs + len(eng._graphs), replays + mine, \
            pool_bytes + gs["pool_bytes"]
    if nonzero(c) != {k: 2 * v for k, v in once.items() if v} or c["plain"]:
        fail(f"engine {label}: the wrappers counted {c} during the captures (want twice "
             f"{once}: warm-up and capture; no plain-version call)")
    if rows.other or rows.rows != 2 * once.get("B3", 0):
        fail(f"engine {label}: B3 called {rows.rows} times with per-row offsets and lengths, "
             f"{rows.other} times without")
    launches = {k: from_nodes[k] + c[k] - once[k] for k in from_nodes}
    return launches, graphs, replays, pool_bytes, time.perf_counter() - t_count


def engine_serve(label, cfg, params, reqs, kernel, fused, gates, tp=1, expect=None, **ecfg):
    """Serve ``reqs`` (arrivals at 0, synthetic clock) through a new engine
    on the card and hold its launches (``hold_engine_graphs``).  ``tp``
    shards the engine (``Engine(tp=...)``), ``expect(name)`` replaces
    ``engine_expect``.  Returns (streams, engine, launches)."""
    import torch

    from benchmarks_torch import engine_throughput as et
    from repro_torch.launch.engine import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(fused=fused, **{**ENGINE_CFG, **ecfg}), tp=tp)
    if expect is None:
        def expect(name):
            return engine_expect(name, cfg.n_layers, kernel)

    reset_counts()
    t0 = time.perf_counter()
    with PerRowB3() as rows:
        streams = et.serve_parity(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, graphs, _, _, t_count = hold_engine_graphs(label, [eng], counts(), rows, expect)
    dispatches = sum(eng.stats[k] for k in ("decode_dispatches", "prefill_dispatches",
                                            "fused_dispatches"))
    gs = eng.graph_stats
    gates.append(f"{label}: {len(reqs)} requests, {eng.stats['tokens_emitted']} tokens in "
                 f"{wall:.2f} s ({dispatches} dispatches, {graphs} graphs captured in "
                 f"{gs['capture_s']:.2f} s, graph pool {gs['pool_bytes'] / 1e9:.3f} GB; launch "
                 f"counting {t_count:.2f} s)")
    return streams, eng, launches


def engine_gaps(cfg, params, reqs, streams):
    """rid -> the steps of that request's stream where a departure is
    allowed (computed at first use, i.e. only for a stream that departs):
    the top-2 gap of the teacher-forced logits (plus the step's Gumbel
    noise, the solo key schedule, for a sampled request) below
    BF16_LOGIT_RTOL of the largest |logit|."""
    import functools

    import torch

    from repro_torch import prng
    from repro_torch.models import api

    by_rid, dev = {r.rid: r for r in reqs}, params["embed"]["table"].device

    @functools.cache
    def near(rid) -> list[bool]:
        r, toks = by_rid[rid], streams[rid]
        with torch.inference_mode():
            seq = torch.tensor([list(r.prompt) + toks[:-1]], dtype=torch.int64, device=dev)
            rows = api.forward(params, cfg, {"tokens": seq})[0][0][r.prompt.size - 1:].float()
            bound = BF16_LOGIT_RTOL * rows.abs().amax(-1)
            if not r.greedy:
                key, noise = prng.PRNGKey(r.seed, device=dev), []
                for _ in toks:
                    key, sub = prng.split(key).unbind(-2)
                    noise.append(prng.gumbel(sub, (rows.shape[-1],)))
                rows = rows + torch.stack(noise)
            top = rows.topk(2, dim=-1).values
            return ((top[:, 0] - top[:, 1]) < bound).cpu().tolist()

    return near


def same_streams(got, want, near, what) -> int:
    """``got`` == ``want`` per request, or the first difference at a step
    ``near(rid)`` allows (then the rest is not compared); the departures."""
    departures = 0
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        d = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        if len(g) != len(w) or d >= len(w) or not near(rid)[d]:
            fail(f"engine {what}: request {rid} departs at step {d} of {len(w)} outside a near "
                 f"tie ({g[:d + 3]} vs {w[:d + 3]})")
        departures += 1
    return departures


def check_engine_kernels(dev, p_packed, p_rle, p_int8) -> float:
    """B2, B4 and B5 on layer 0's planned wi_gate at every bucketed row count
    of the engine (bf16 x, the tensor-core kernels), B3 at every chunk
    width against every page bucket's view with per-row offsets and
    lengths: each within its bound of its plain version.  Returns max |d|
    by kernel."""
    import torch

    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.cim_matmul import ref as cim_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.core import simulator

    eps = torch.finfo(torch.float32).eps
    g = torch.Generator(device=dev).manual_seed(23)
    layer0 = lambda p: {k: v[0] for k, v in p["segments"][0]["mlp"]["wi_gate"].items()}  # noqa
    ops = {"B2": layer0(p_packed), "B4": layer0(p_rle), "B5": layer0(p_int8)}
    w_abs = {"B2": simulator.densify_operands(ops["B2"]).abs(),
             "B4": simulator.densify_operands(ops["B4"]).abs()}
    sp = ops["B5"]["splanes"].float()
    pw = (2.0 ** torch.arange(sp.shape[0], device=dev))[:, None, None]
    w_abs["B5"] = (sp * pw).sum(0).abs() * ops["B5"]["scale"]
    del sp
    worst, lines = {}, []
    k = ops["B2"]["kdim"].shape[-2]
    for kern, op in ops.items():
        errs = []
        for m in ENGINE_M:
            x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
            cim_ops.reset_launches()
            if kern == "B5":
                got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode="fused_dequant")
                want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], "fused_dequant")
            else:
                args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
                kw = {"plane_ids": op.get("plane_ids")}
                if kern == "B4":
                    kw["tile_nz"] = op["plane_tile_nz"]
                got = cim_ops.cim_matmul_packed(*args, **kw)
                want = cim_ref.cim_matmul_packed(*args, plane_ids=op.get("plane_ids"))
            path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
            if path != {kern: 1, f"{kern}_tc": 1}:
                fail(f"{kern} at M={m} took the wrong kernel: {path}")
            torch.cuda.synchronize()
            err = (got - want).abs()
            bnd = B2_BOUND_C * eps * k * (x.float().abs() @ w_abs[kern])
            if not bool((err <= bnd).all()):
                fail(f"{kern} outside its bound at the engine's M={m}: max |d| "
                     f"{err.max().item():.3e}")
            errs.append(err.max().item())
        worst[kern] = max(errs)
        lines.append(f"{kern} max |d| {max(errs):.3e}")
    del w_abs
    errs = []
    for c in ENGINE_CHUNKS:
        for pages in ENGINE_PAGES:
            sk = pages * ENGINE_CFG["page_size"]
            if sk < c:
                continue
            b = ENGINE_CFG["max_slots"]
            q = torch.randn(b, 8, c, 256, device=dev, generator=g).to(torch.bfloat16)
            kk = torch.randn(b, 1, sk, 256, device=dev, generator=g).to(torch.bfloat16)
            vv = torch.randn(b, 1, sk, 256, device=dev, generator=g).to(torch.bfloat16)
            start = torch.randint(0, sk - c + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            ct = torch.randint(1, c + 1, (b,), device=dev, generator=g, dtype=torch.int32)
            kvl = start + ct
            fa_ops.reset_launches()
            got = fa_ops.flash_attention(q, kk, vv, kvl, kind="causal", q_offset=start)
            if dict(fa_ops.LAUNCHES) != {"B3": 1, "B3_tc": 1}:
                fail(f"B3 at C={c} Sk={sk} took the wrong kernel: {fa_ops.LAUNCHES}")
            want = fa_ref.flash_attention(q, kk, vv, kvl, kind="causal", q_offset=start)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if not bool((err <= fa_ref.attention_bound(want)).all()):
                fail(f"B3 outside its tolerance at the engine's C={c} Sk={sk} (per-row "
                     f"offsets and lengths): max |d| {err.max().item():.3e}")
            errs.append(err.max().item())
    worst["B3"] = max(errs)
    say(f"phase engine-kernels: B2/B4/B5 on layer 0's wi_gate at M in {ENGINE_M} (bf16, "
        f"tensor cores) within {B2_BOUND_C}*eps*K*(|x|@|w|): " + ", ".join(lines)
        + f"; B3 at C in {ENGINE_CHUNKS} x Sk in pages {ENGINE_PAGES} x "
        f"{ENGINE_CFG['page_size']} (B {ENGINE_CFG['max_slots']}, per-row offsets and "
        f"lengths, bf16 tensor cores) within {fa_ref.TOL:g}: max |d| {max(errs):.3e}")
    torch.cuda.empty_cache()
    return worst


def engine_golden_phase(dev) -> dict:
    """The reduced f32 gemma-2b on the card against the golden file: the
    parity trace through dense and packed, fused and split (streams equal,
    a departure only at the reference's near ties; every stat and shape
    equal), run_overcommit's integers, and the hot redeploy's and the
    engine scrub's counters.  Returns the wrappers' counts (eager launches
    and graph captures; no plain-version call)."""
    import torch

    from benchmarks_torch import engine_throughput as et
    from benchmarks_torch import fault_tolerance as ft
    from benchmarks_torch import integrity_scrub as isc
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models import api

    t0 = time.perf_counter()
    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    ge = gold["engine"]
    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(prng.PRNGKey(ge["seed"]), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(**et.PARITY_PLAN), device=dev)
    reset_counts()
    trace = et.make_trace(cfg, **et.PARITY_TRACE)
    departures = 0
    for mat, fused in et.PARITY_VARIANTS:
        key = f"{mat}/{'fused' if fused else 'split'}"
        want = ge["variants"][key]
        eng = Engine(cfg, planner.deploy_params(params, plan, materialize=mat),
                     EngineConfig(fused=fused, **et.PARITY_ENGINE))
        streams = et.serve_parity(eng, et.parity_requests(trace))
        ties = want["near_ties"]
        departures += same_streams(streams, {int(r): t for r, t in want["tokens"].items()},
                                   lambda rid: [i in ties[str(rid)]
                                                for i in range(len(want["tokens"][str(rid)]))],
                                   f"reduced {key} vs the golden file")
        stats = {k: v for k, v in eng.stats.items() if k != "compiled_variants"}
        if stats != want["stats"] or sorted(map(list, eng._shapes_seen)) != want["shapes"]:
            fail(f"engine reduced {key}: stats {stats} / shapes differ from the golden file's "
                 f"{want['stats']}")
    for mode, want in ge["overcommit"].items():
        oc = et.run_overcommit(cfg, params, preempt=mode)
        got = {k: oc[k] for k in et.OVERCOMMIT_INTS}
        if got != want:
            fail(f"engine reduced overcommit {mode}: {got} (golden {want})")
    pcfg = planner.PlannerConfig(p_stuck=0.5, min_size=1024)
    rd = ft.run_hot_redeploy(cfg, params, api.init(prng.PRNGKey(1), cfg, device=dev), pcfg=pcfg,
                             device=dev)
    want = {k: gold["fault_tolerance"]["redeploy"][k] for k in ft.REDEPLOY_KEYS}
    if {k: rd[k] for k in ft.REDEPLOY_KEYS} != want or not rd["stream_parity"]:
        fail(f"hot redeploy on the card {rd} (golden {want}; stream parity by admission epoch)")
    esc = isc.run_engine_scrub(cfg, params, pcfg=pcfg, device=dev)
    want = {k: gold["integrity_scrub"]["engine_scrub"][k] for k in isc.ENGINE_SCRUB_KEYS}
    if {k: esc[k] for k in isc.ENGINE_SCRUB_KEYS} != want:
        fail(f"engine scrub on the card {esc} (golden {want})")
    ovh = isc.run_scrub_overhead(cfg, params, pcfg=pcfg, device=dev)
    want = {k: gold["integrity_scrub"]["overhead"][k] for k in isc.OVERHEAD_KEYS}
    if {k: ovh[k] for k in isc.OVERHEAD_KEYS} != want:
        fail(f"scrub overhead on the card {ovh} (golden {want})")
    c = counts()
    if c["plain"]:
        fail(f"engine reduced phase called a plain version: {c}")
    say(f"phase engine-golden: reduced gemma-2b f32: {len(et.PARITY_VARIANTS)} variants x "
        f"{len(trace)} requests equal to the golden streams ({departures} departures at near "
        f"ties), stats and shapes equal; overcommit swap/recompute integers equal; hot redeploy "
        f"{ {k: rd[k] for k in ('completed', 'hot_swaps', 'epochs_retired')} } equal, stream "
        f"parity by admission epoch True (the reference's rule gives False: ROADMAP C.8); "
        f"engine scrub {esc['scrub_rounds']} rounds, {esc['scrub_detections']} detections, "
        f"{esc['scrub_repairs']} repairs, {esc['scrub_refreshes']} refreshes equal; "
        f"{overhead_note(ovh)}; launches {c}; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, plan
    torch.cuda.empty_cache()
    return c


def engine_phase(dev) -> dict:
    """gemma-2b at full width (ENGINE_LAYERS layers, bf16), planned as phase
    serve plans it, served by the continuous-batching engine four ways (dense,
    packed on B2, const_rle through a pool on B4, planes_int8 built by B6 and
    served by B5), fused and split, on ENGINE_TRACE with every arrival at
    0.0: streams equal to solo generation and fused equal to split (a
    departure only where the top-2 gap is below the bf16 serve bound),
    every dispatch a replayed CUDA graph with exact launches; the packed
    deployment over-committed (swap and recompute) against a roomy pool;
    the reduced f32 parity cell against the golden file; then
    ``engine_throughput.run`` at full width.  Returns the phase's launches."""
    import torch

    from benchmarks_torch import engine_throughput as et
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.launch import serve
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k, v in c.items():
            if k != "plain":
                totals[k] = totals.get(k, 0) + v

    add({"B1": engine_golden_phase(dev)["B1"]})  # its plans' and repairs' pricing
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=ENGINE_LAYERS)
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    spec = planner.CrossbarSpec()
    reset_counts()
    plan = planner.build_deployment(params, spec, planner.PlannerConfig(p_stuck=P_STUCK),
                                    device=dev)
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    pool_plan = planner.build_deployment(params, spec, pcfg_pool,
                                         pool=pool.CrossbarPool(spec, pcfg_pool.crossbars,
                                                                device=dev), device=dev)
    add(counts())
    p_int8, c6 = deploy_int8(params, plan)
    add(c6)
    deployments = {
        "dense": (planner.deploy_params(params, plan, materialize="dense"), None),
        "packed": (planner.deploy_params(params, plan, materialize="packed"), "B2"),
        f"packed {CODEC}": (planner.deploy_params(params, pool_plan, materialize="packed",
                                                  codec=CODEC), "B4"),
        "planes_int8": (p_int8, "B5"),
    }
    del plan, pool_plan
    kern_err = check_engine_kernels(dev, deployments["packed"][0],
                                    deployments[f"packed {CODEC}"][0], p_int8)
    requests = et.parity_requests(et.make_trace(cfg, **ENGINE_TRACE))
    gates, departures, stats, secs = [], {}, {}, {}
    say(f"phase engine: plans, deployments and kernel checks "
        f"{time.perf_counter() - t_phase:.1f} s after the phase started")
    for label, (p, kernel) in deployments.items():
        runs, t_dep, nodes0 = {}, time.perf_counter(), NODE_LIST["s"]
        for fused in (True, False):
            mode = "fused" if fused else "split"
            runs[mode], eng, launches = engine_serve(f"{label} {mode}", cfg, p, requests, kernel,
                                                     fused, gates)
            add(launches)
            stats[f"{label} {mode}"] = {k: eng.stats[k] for k in (
                "fused_dispatches", "prefill_dispatches", "decode_dispatches", "tokens_overrun",
                "decode_rows_padded")}
            del eng
        solo, t_solo = {}, time.perf_counter()
        for r in requests:
            prompt = torch.tensor(r.prompt[None].astype("int64"), device=dev)
            toks, _ = serve.generate(cfg, p, {"tokens": prompt}, gen_len=r.max_new_tokens,
                                     greedy=r.greedy, seed=r.seed, loop="python")
            solo[r.rid] = toks[0].tolist()
        t_solo = time.perf_counter() - t_solo
        near = engine_gaps(cfg, p, requests, solo)
        departures[label] = (same_streams(runs["fused"], solo, near, f"{label} fused vs solo"),
                             same_streams(runs["split"], solo, near, f"{label} split vs solo"),
                             same_streams(runs["split"], runs["fused"],
                                          engine_gaps(cfg, p, requests, runs["fused"]),
                                          f"{label} split vs fused"))
        secs[label] = (f"{time.perf_counter() - t_dep:.1f} s (node lists "
                       f"{NODE_LIST['s'] - nodes0:.1f} s, solo generates {t_solo:.1f} s)")
        torch.cuda.empty_cache()
    for line in gates:
        say(f"phase engine: {line}")
    say("phase engine: departures at near ties (fused vs solo, split vs solo, split vs fused): "
        + "; ".join(f"{k} {v}" for k, v in departures.items())
        + f"; dispatch counts {stats}; seconds {secs}")

    # the packed deployment over-committed, against the same burst on a roomy pool
    t_part = time.perf_counter()
    p_packed = deployments["packed"][0]
    for label in ("dense", f"packed {CODEC}", "planes_int8"):
        deployments.pop(label)
    del p_int8
    torch.cuda.empty_cache()
    ocs = {mode: et.run_overcommit(cfg, p_packed, preempt=mode) for mode in ("swap", "recompute")}
    roomy = Engine(cfg, p_packed, EngineConfig(max_slots=4, page_size=16, max_seq_len=81,
                                               prefill_chunk=16, decode_quantum=16))
    reqs = et.overcommit_requests(cfg)
    want = et.serve_parity(roomy, reqs)
    near = engine_gaps(cfg, p_packed, reqs, want)
    for mode, oc in ocs.items():
        if oc["completed"] != oc["n_requests"] or oc["preemptions"] < 1 or (
                mode == "swap" and oc["swap_ins"] < 1):
            fail(f"engine overcommit {mode}: {oc}")
        d = same_streams({int(k): v for k, v in oc["tokens"].items()}, want, near,
                         f"overcommit {mode} vs a roomy pool")
        say(f"phase engine-overcommit: {mode}: {oc['completed']}/{oc['n_requests']} completed on "
            f"{oc['usable_blocks']} blocks ({oc['blocks_per_request_true']} a request), "
            f"{oc['preemptions']} preemptions, {oc['swap_ins']} swap-ins, {oc['readmissions']} "
            f"readmissions, {oc['tok_s']:.1f} tok/s; streams equal to the roomy pool's "
            f"({d} departures at near ties)")
    del roomy
    say(f"phase engine-overcommit: {time.perf_counter() - t_part:.1f} s")

    t_part = time.perf_counter()
    res = et.run("gemma-2b", reduced=False, layers=ENGINE_LAYERS, params=p_packed,
                 passes=ENGINE_PASSES,
                 overcommit=False, device=dev, rate=500.0, page_size=ENGINE_CFG["page_size"],
                 prefill_chunk=ENGINE_CFG["prefill_chunk"],
                 decode_quantum=ENGINE_CFG["decode_quantum"], max_slots=ENGINE_CFG["max_slots"],
                 **ENGINE_TRACE)
    for name in ("static", "engine_split", "engine"):
        r = res[name]
        say(f"phase engine-throughput: gemma-2b x{ENGINE_LAYERS} packed {name}: "
            f"{r['tok_s']:.1f} tok/s, "
            f"latency p50 {r['p50_latency_ms']:.1f} / p95 {r['p95_latency_ms']:.1f} ms, TTFT p50 "
            f"{r['p50_ttft_ms']:.1f} / p95 {r['p95_ttft_ms']:.1f} ms"
            + (f"; dispatches fused {r['fused_dispatches']}, prefill {r['prefill_dispatches']}, "
               f"decode {r['decode_dispatches']}, overrun {r['tokens_overrun']}; graphs "
               f"{r['graphs']['captured']} captured in {r['graphs']['capture_s']:.2f} s, graph pool "
               f"{r['graphs']['pool_bytes'] / 1e9:.3f} GB"
               if name != "static" else ""))
    for name, b in res["device_busy"].items():
        say(f"phase engine-throughput: one traced {name} pass: wall {b['wall_ms']:.2f} ms, device "
            f"{b['device_ms']:.2f} ms ({100 * b['busy']:.1f}% busy); top: "
            + "; ".join(f"{t['kernel'][:60]} x{t['count']} {t['ms']:.3f} ms" for t in b["top"]))
    say(f"phase engine-throughput: fused / static {res['speedup_tok_s']:.2f}x tok/s, fused / "
        f"split {res['fused_vs_split_tok_s']:.2f}x, static / fused p50 latency "
        f"{res['p50_latency_ratio']:.2f}x (best of {ENGINE_PASSES}, interleaved); "
        f"{time.perf_counter() - t_part:.1f} s")
    del p_packed, deployments, params
    torch.cuda.empty_cache()
    say(f"phase engine: {time.perf_counter() - t_phase:.1f} s; launches {totals}; max |d| at the "
        f"engine's shapes {kern_err}")
    return {**totals, "err": kern_err}


TP_COUNTS = (1, 2, 4)  # yi-6b's tp_generate shard counts
TP_LAYERS = 1  # depth of phase tp-fleet's yi-6b and gemma-2b: the run's time limit bounds it
TP_ENGINE_TRACE = dict(n_requests=16, min_prompt=8, max_prompt=96, min_gen=2, max_gen=64, seed=0,
                       sample_every=4)
TP_STORM = dict(corrupt_rate=5e-6, stuck_rate=1e-7)  # on two tensors of each shard pool
TP_M = (4, 128)  # decode and prefill rows of the serve batch


def tp_step_launches(plan, kernel) -> dict:
    """CIM launches one TP decode step (or prefill) makes a layer: every
    matmul once a shard of its component (a replicated component once);
    under a flagged codec (``kernel`` B4) the column shards keep their
    zero-tile flags and launch B4, the row shards (K-sliced) drop them and
    launch B2."""
    a = plan.n if plan.attn else 1
    m = plan.n if plan.mlp else 1
    if kernel != "B4":
        return {kernel: 4 * a + 3 * m}
    out = {"B4": (3 * a if plan.attn else 4) + (2 * m if plan.mlp else 3)}
    rows = (a if plan.attn else 0) + (m if plan.mlp else 0)
    if rows:
        out["B2"] = rows
    return out


def tp_generate_expect(cfg, plan, kernel, gen, head) -> dict:
    """A TP generate's launches: the layers' matmuls on the tensor-core
    kernels every step (prefill included), the planned f32 head on the FMA
    kernel once a step, B3 once a layer a shard of the attention."""
    a = plan.n if plan.attn else 1
    out = {"B3": a * cfg.n_layers, "B3_tc": a * cfg.n_layers}
    for k, v in tp_step_launches(plan, kernel).items():
        out[k] = v * cfg.n_layers * gen
        out[f"{k}_tc"] = v * cfg.n_layers * gen
    if head:
        out[kernel] += gen
    return out


def tp_engine_expect(name, cfg, plan, kernel, head) -> dict:
    """``engine_expect`` for a TP engine graph."""
    kind, q = name[0], name[1] if name[0] != "prefill" else 0
    steps_ = {"decode": q, "prefill": 1, "fused": q + 1}[kind]
    a = plan.n if plan.attn else 1
    out = {}
    for k, v in tp_step_launches(plan, kernel).items():
        out[k] = v * cfg.n_layers * steps_
        out[f"{k}_tc"] = v * cfg.n_layers * steps_
    if head:
        out[kernel] += steps_
    if kind != "decode":
        out.update(B3=a * cfg.n_layers, B3_tc=a * cfg.n_layers)
    return out


def tp_departures(cfg, params, batch, got, want, what) -> int:
    """Greedy batch streams ``got`` == ``want`` row by row, or the first
    difference at a step whose teacher-forced top-2 logit gap (of ``want``)
    is below BF16_LOGIT_RTOL of the largest |logit|; the departures."""
    import torch

    from repro_torch.models import api

    if torch.equal(got, want):
        return 0
    with torch.inference_mode():
        seq = torch.cat([batch["tokens"].long(), want[:, :-1].long()], dim=1)
        rows = api.forward(params, cfg, {"tokens": seq})[0][:, batch["tokens"].shape[1] - 1:]
        rows = rows.float()
        top = rows.topk(2, dim=-1).values
        near = ((top[..., 0] - top[..., 1]) < BF16_LOGIT_RTOL * rows.abs().amax(-1)).cpu()
    departures = 0
    for r in range(want.shape[0]):
        diff = (got[r] != want[r]).nonzero()
        if not len(diff):
            continue
        d = int(diff[0])
        if not bool(near[r, d]):
            fail(f"{what}: row {r} departs from solo generation at step {d} outside a near tie "
                 f"({got[r, :d + 3].tolist()} vs {want[r, :d + 3].tolist()})")
        departures += 1
    return departures


def check_tp_kernels(dev, ycfg, plan4, y_packed, y_int8) -> dict:
    """B2 and B5 on K-sliced (row-parallel) and N-sliced (column-parallel)
    shard operands of yi-6b layer 0, B4 on an N-sliced const_rle operand,
    at the serve batch's decode and prefill rows (bf16 x, tensor cores),
    and B3 at yi's local heads at n = 4 (8 q heads, 1 KV head, D = 128):
    each within its bound of its plain version.  Returns max |d| by
    kernel."""
    import torch

    from repro_torch.core import planes, simulator
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.cim_matmul import ref as cim_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.parallel import tp

    eps = torch.finfo(torch.float32).eps
    g = torch.Generator(device=dev).manual_seed(31)
    layer0 = lambda p, sub, leaf: {k: v[0] for k, v in p["segments"][0][sub][leaf].items()}  # noqa
    shard = lambda op, axis, n: simulator.shard_operands(op, axis=axis, index=n - 1, n=n)  # noqa
    wo, wi = layer0(y_packed, "mlp", "wo"), layer0(y_packed, "mlp", "wi_gate")
    cases = {
        "B2 K-sliced mlp/wo": ("B2", shard(wo, -2, 4)),
        "B2 N-sliced mlp/wi_gate": ("B2", shard(wi, -1, 4)),
        "B2 K-sliced attn/wo": ("B2", shard(layer0(y_packed, "attn", "wo"), -2, 4)),
        "B4 N-sliced const_rle mlp/wi_gate": (
            "B4", shard(planes.encode_operands(wi, "const_rle"), -1, 4)),
        "B5 K-sliced mlp/wo": ("B5", shard(layer0(y_int8, "mlp", "wo"), -2, 2)),
        "B5 N-sliced mlp/wi_gate": ("B5", shard(layer0(y_int8, "mlp", "wi_gate"), -1, 2)),
    }
    worst, lines = {}, []
    for label, (kern, op) in cases.items():
        op = {k: v.contiguous() for k, v in op.items()}
        if kern == "B5":
            sp = op["splanes"].float()
            pw = (2.0 ** torch.arange(sp.shape[0], device=dev))[:, None, None]
            w_abs = (sp * pw).sum(0).abs() * op["scale"]
            k = sp.shape[-2]
            del sp
        else:
            w_abs = simulator.densify_operands(op).abs()
            k = op["kdim"].shape[-2]
        err_max = 0.0
        for m in TP_M:
            x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
            cim_ops.reset_launches()
            if kern == "B5":
                got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode="fused_dequant")
                want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], "fused_dequant")
            else:
                args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
                kw = {"tile_nz": op["plane_tile_nz"]} if kern == "B4" else {}
                got = cim_ops.cim_matmul_packed(*args, **kw)
                want = cim_ref.cim_matmul_packed(*args)
            path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
            if path != {kern: 1, f"{kern}_tc": 1}:
                fail(f"{label} at M={m} took the wrong kernel: {path}")
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not bool((err <= B2_BOUND_C * eps * k * (x.float().abs() @ w_abs)).all()):
                fail(f"{label} outside its bound at M={m}: max |d| {err.max().item():.3e}")
            err_max = max(err_max, err.max().item())
        worst[kern] = max(worst.get(kern, 0.0), err_max)
        lines.append(f"{label} K={k} N={w_abs.shape[-1]} max |d| {err_max:.3e}")
        del w_abs
    loc = tp.local_config(ycfg, plan4)
    errs = []
    for s in (PROMPT, 2048):
        b = BATCH if s == PROMPT else 1
        q = torch.randn(b, loc.n_heads, s, loc.head_dim, device=dev, generator=g).to(torch.bfloat16)
        kv = [torch.randn(b, loc.n_kv_heads, s, loc.head_dim, device=dev, generator=g).to(
            torch.bfloat16) for _ in range(2)]
        fa_ops.reset_launches()
        got = fa_ops.flash_attention(q, *kv, kind="causal")
        if dict(fa_ops.LAUNCHES) != {"B3": 1, "B3_tc": 1}:
            fail(f"B3 at yi's local heads took the wrong kernel: {fa_ops.LAUNCHES}")
        want = fa_ref.flash_attention(q, *kv, kind="causal")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if not bool((err <= fa_ref.attention_bound(want)).all()):
            fail(f"B3 at yi's local heads (S={s}) outside its tolerance: max |d| "
                 f"{err.max().item():.3e}")
        errs.append(err.max().item())
    worst["B3"] = max(errs)
    say(f"phase tp-kernels: shard-shape operands at M in {TP_M} (bf16, tensor cores) within "
        f"{B2_BOUND_C}*eps*K*(|x|@|w|): " + "; ".join(lines)
        + f"; B3 at yi's local heads ({loc.n_heads} q, {loc.n_kv_heads} KV, D {loc.head_dim}; "
        f"B {BATCH} x S {PROMPT} and B 1 x S 2048, causal) within {fa_ref.TOL:g}: max |d| "
        f"{max(errs):.3e}")
    return worst


def tp_fleet_phase(dev) -> dict:
    """Tensor-parallel replicas and the fleet on the card: tp_generate of
    yi-6b (TP_LAYERS layers, bf16, packed) at n = 1, 2, 4 and planes_int8 at
    n = 2, gemma-2b (TP_LAYERS) packed and const_rle at n = 2 (attention
    replicated, MLP sharded),
    each through the serve gates and equal to solo generation (near ties
    aside); the kernels at shard shapes; Engine(tp=2) on yi-6b packed;
    fleets of gemma-2b packed replicas on the card (kill one of 4 both
    ways, a hedged stall, admission, 2 replicas of 2 shards); the sharded
    deployment over 2 pools against the unsharded one and a ShardedScrub
    storm; fleet_tolerance at the reference's reduced settings against the
    golden file.  Returns the phase's launches and max |d|."""
    import torch

    from benchmarks_torch import engine_throughput as et
    from benchmarks_torch import fleet_tolerance as ftl
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner
    from repro_torch.core.integrity import IntegrityConfig
    from repro_torch.core.pool import CrossbarPool
    from repro_torch.launch import fleet as fleet_mod
    from repro_torch.launch import serve
    from repro_torch.launch.fleet import FaultInjector, Fleet, FleetConfig
    from repro_torch.models import api
    from repro_torch.parallel import tp

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k, v in c.items():
            if k != "plain":
                totals[k] = totals.get(k, 0) + v

    # --- yi-6b: tp_generate at n = 1, 2, 4 (packed), planes_int8 at n = 2
    ycfg = dataclasses.replace(get_arch("yi-6b"), n_layers=TP_LAYERS)
    yparams = api.init(prng.PRNGKey(0), ycfg, device=dev)
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    yplan = planner.build_deployment(yparams, spec, pcfg, device=dev)
    add(counts())
    y_packed = planner.deploy_params(yparams, yplan, materialize="packed")
    batch = api.make_batch(ycfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    lines = []
    for label, p, kernel, counts_ in (("packed", y_packed, "B2", TP_COUNTS),
                                      ("planes_int8", None, "B5", (2,))):
        if p is None:
            p, c6 = deploy_int8(yparams, yplan)
            add(c6)
            y_int8 = p
        with torch.inference_mode():
            solo = serve.generate(ycfg, p, batch, gen_len=GEN)[0]
        for n in counts_:
            plan = tp.plan_tp(ycfg, n, packed=True)
            if not (plan.attn and plan.mlp):
                fail(f"yi-6b at n={n}: plan_tp replicated a component: {plan.reasons}")
            toks, tps, timed, c = served(
                f"yi-6b {label} tp={n}", ycfg, p, batch, GEN, None, 0,
                make=lambda loop, n=n, p=p: tp.make_tp_generator(
                    ycfg, p, batch, n=n, gen_len=GEN, loop=loop),
                expect=tp_generate_expect(ycfg, plan, kernel, GEN, head=True))
            add(c)
            say(f"phase trace: yi-6b {label} tp={n} generate: {trace(timed)}")
            d = tp_departures(ycfg, p, batch, toks, solo, f"yi-6b {label} tp={n}")
            lines.append(f"yi-6b {label} n={n}: {tps:.1f} tok/s, {d} departures at near ties, "
                         f"{c[kernel]} {kernel} launches")
    say("phase tp-generate: " + "; ".join(lines))
    plan4, plan2 = tp.plan_tp(ycfg, 4, packed=True), tp.plan_tp(ycfg, 2, packed=True)
    errs = check_tp_kernels(dev, ycfg, plan4, y_packed, y_int8)
    del y_int8, yplan, yparams
    torch.cuda.empty_cache()
    say(f"phase tp-fleet: yi-6b tp_generate and shard-shape kernels "
        f"{time.perf_counter() - t_phase:.1f} s after the phase started")

    # --- Engine(tp=2) on yi-6b packed -------------------------------------
    t_part = time.perf_counter()
    requests = et.parity_requests(et.make_trace(ycfg, **TP_ENGINE_TRACE))
    gates, runs, mem = [], {}, {}
    for fused in (True, False):
        mode = "fused" if fused else "split"
        runs[mode], eng, launches = engine_serve(
            f"yi-6b packed tp=2 {mode}", ycfg, y_packed, requests, "B2", fused, gates, tp=2,
            expect=lambda name: tp_engine_expect(name, ycfg, plan2, "B2", head=True))
        add(launches)
        mem[mode] = eng.graph_stats["pool_bytes"]
        del eng
    solo = {}
    for r in requests:
        prompt = torch.tensor(r.prompt[None].astype("int64"), device=dev)
        toks, _ = serve.generate(ycfg, y_packed, {"tokens": prompt}, gen_len=r.max_new_tokens,
                                 greedy=r.greedy, seed=r.seed, loop="python")
        solo[r.rid] = toks[0].tolist()
    near = engine_gaps(ycfg, y_packed, requests, solo)
    deps = (same_streams(runs["fused"], solo, near, "tp=2 fused vs solo"),
            same_streams(runs["split"], solo, near, "tp=2 split vs solo"),
            same_streams(runs["split"], runs["fused"],
                         engine_gaps(ycfg, y_packed, requests, runs["fused"]),
                         "tp=2 split vs fused"))
    for line in gates:
        say(f"phase tp-engine: {line}")
    say(f"phase tp-engine: departures at near ties (fused vs solo, split vs solo, split vs "
        f"fused) {deps}; {time.perf_counter() - t_part:.1f} s")
    del y_packed
    torch.cuda.empty_cache()

    # --- gemma-2b: the sharded deployment, tp_generate at n = 2 ------------
    t_part = time.perf_counter()
    gcfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=TP_LAYERS)
    gparams = api.init(prng.PRNGKey(0), gcfg, device=dev)

    class Pristine(CrossbarPool):
        """Per-tensor pristine accounting: content reset before each program."""

        def program(self, *args, **kwargs):
            self.reset()
            return super().program(*args, **kwargs)

    reset_counts()
    solo_pool = Pristine(spec, pcfg.crossbars, device=dev)
    uplan = planner.build_deployment(gparams, spec, pcfg, pool=solo_pool, device=dev)
    splan, spools, owner = tp.build_sharded_deployment(
        gparams, spec, pcfg, 2, pools=[Pristine(spec, pcfg.crossbars, device=dev)
                                       for _ in range(2)])
    c = counts()
    add(c)
    for name, rep in uplan.reports.items():
        if dataclasses.asdict(splan.reports[name]) != dataclasses.asdict(rep):
            fail(f"sharded deployment: {name}'s report differs from the unsharded plan's")
        if not torch.equal(splan.deployed[name], uplan.deployed[name]):
            fail(f"sharded deployment: {name}'s w_hat differs from the unsharded plan's")
    wear = [int(q.wear.sum()) for q in spools]
    if sum(wear) != int(solo_pool.wear.sum()) or c["plain"] or not c["B1"]:
        fail(f"sharded deployment: shard pools' wear {wear} against the unsharded pool's "
             f"{int(solo_pool.wear.sum())} (launches {c})")
    say(f"phase tp-deploy: gemma-2b x{TP_LAYERS} over 2 pools: {len(owner)} tensors "
        f"({sum(1 for v in owner.values() if v == 0)} / {sum(1 for v in owner.values() if v)}), "
        f"every report and w_hat equal to the unsharded plan's; summed wear {sum(wear)} = "
        f"{wear} = the unsharded pool's; B1 {c['B1']}; {time.perf_counter() - t_part:.1f} s")
    g_packed = planner.deploy_params(gparams, uplan, materialize="packed")
    g_rle = planner.deploy_params(gparams, uplan, materialize="packed", codec="const_rle")
    gbatch = api.make_batch(gcfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    with torch.inference_mode():
        gsolo = serve.generate(gcfg, g_packed, gbatch, gen_len=GEN)[0]
    gplan = tp.plan_tp(gcfg, 2, packed=True)
    if gplan.attn or not gplan.mlp:
        fail(f"gemma-2b at n=2: attention should replicate and the MLP shard: {gplan}")
    lines = [f"plan_tp(gemma-2b, 2): attention replicated ({gplan.reasons['attn']}), MLP "
             f"sharded"]
    for label, p, kernel in (("packed", g_packed, "B2"), ("packed const_rle", g_rle, "B4")):
        toks, tps, _, c = served(
            f"gemma-2b {label} tp=2", gcfg, p, gbatch, GEN, None, 0,
            make=lambda loop, p=p: tp.make_tp_generator(gcfg, p, gbatch, n=2, gen_len=GEN,
                                                        loop=loop),
            expect=tp_generate_expect(gcfg, gplan, kernel, GEN, head=False))
        add(c)
        d = tp_departures(gcfg, g_packed, gbatch, toks, gsolo, f"gemma-2b {label} tp=2")
        lines.append(f"{label} {tps:.1f} tok/s, {d} departures, launches "
                     f"{ {k: v for k, v in c.items() if v and k != 'plain'} }")
    say("phase tp-generate: gemma-2b: " + "; ".join(lines))
    del g_rle, uplan, splan, spools, solo_pool

    # --- the ShardedScrub storm on two integrity pools --------------------------
    t_part = time.perf_counter()
    reset_counts()
    ipools = [CrossbarPool(spec, pcfg.crossbars, leveling="lpt", device=dev) for _ in range(2)]
    mgrs = [q.enable_integrity(IntegrityConfig(spare_cols=2, scrub_tiles=1 << 20))
            for q in ipools]
    iplan, ipools, iowner = tp.build_sharded_deployment(gparams, spec, pcfg, 2, pools=ipools)
    p_clean = planner.deploy_params(gparams, iplan, materialize="packed")
    pre = tp.tp_generate(gcfg, p_clean, gbatch, n=2, gen_len=GEN)[0]
    storms = [m.storm(prng.PRNGKey(STORM_SEED + i), tensors=sorted(m.tensors)[:2], **TP_STORM)
              for i, m in enumerate(mgrs)]
    scrub = tp.ShardedScrub(mgrs)
    rounds, det, rep = 0, 0, 0
    while not all(m.clean for m in mgrs):
        r = scrub.scrub_round()
        rounds, det = rounds + 1, det + r.detections
        rep += r.rewrites + r.remaps + r.migrations
        if rounds > 200:
            fail(f"ShardedScrub did not converge in 200 rounds (pending {scrub.pending_faults()})")
    if not det or not rep or scrub.pending_faults() or not scrub.verify_all():
        fail(f"ShardedScrub: {det} detections, {rep} repairs, pending "
             f"{scrub.pending_faults()} after {rounds} rounds")
    p_rep = planner.deploy_params(gparams, scrub.rebuild_plan(iplan), materialize="packed")
    post = tp.tp_generate(gcfg, p_rep, gbatch, n=2, gen_len=GEN)[0]
    if not torch.equal(post, pre):
        fail("ShardedScrub: tokens after the repair differ from the pre-storm tokens")
    c = counts()
    add({"B1": c["B1"]})
    say(f"phase tp-scrub: storm {storms} on 2 tensors of each shard pool; {rounds} rounds, "
        f"{det} detections, {rep} repairs, pending 0, reads verified; repaired tp=2 tokens == "
        f"pre-storm tokens; B1 {c['B1']}; {time.perf_counter() - t_part:.1f} s")
    del mgrs, ipools, iplan, p_clean, p_rep, scrub
    torch.cuda.empty_cache()

    # --- fleets of gemma-2b packed replicas on the one card -----------------
    t_part = time.perf_counter()
    solo_cache = {}

    def solo_of(req):
        key = (req.prompt.tobytes(), req.max_new_tokens, req.greedy, req.seed)
        if key not in solo_cache:
            prompt = torch.tensor(req.prompt[None].astype("int64"), device=dev)
            toks, _ = serve.generate(gcfg, g_packed, {"tokens": prompt},
                                     gen_len=req.max_new_tokens, greedy=req.greedy,
                                     seed=req.seed, loop="python")
            solo_cache[key] = toks[0].tolist()
        return solo_cache[key]

    def fleet_run(label, fcfg, reqs, injector=None):
        """Run a fleet on the card; every engine it builds (restored ones
        included) is recorded, and all of them are held together by
        ``hold_engine_graphs``."""
        built, base = [], fleet_mod.Engine

        class Recorded(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                built.append(self)

        plan = tp.plan_tp(gcfg, fcfg.shards_per_replica, packed=True)

        def expect(name):
            if fcfg.shards_per_replica == 1:
                return engine_expect(name, gcfg.n_layers, "B2")
            return tp_engine_expect(name, gcfg, plan, "B2", head=False)

        reset_counts()
        fleet_mod.Engine = Recorded
        try:
            fleet = Fleet(gcfg, g_packed, fcfg, ftl.ECFG, injector=injector)
            setup = counts()  # preparing the shared tree
            reset_counts()
            t0 = time.perf_counter()
            with PerRowB3() as rows:
                results = fleet.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fleet_mod.Engine = base
        if setup["plain"]:
            fail(f"fleet {label}: building the replicas called a plain version: {setup}")
        got, graphs, replays, pool_bytes, t_count = hold_engine_graphs(
            f"fleet {label}", built, counts(), rows, expect)
        add(setup)
        add(got)
        ok = [x for x in results if x.status == "ok"]
        stats = fleet.stats
        if len(ok) != stats["admitted"] or any(x.status == "timeout" for x in results):
            fail(f"fleet {label}: {len(ok)}/{stats['admitted']} admitted requests completed")
        if not any(r.state == "live" for r in fleet.replicas):
            fail(f"fleet {label}: no replica survived")
        want_streams = {x.rid: solo_of(fleet.requests[x.rid]) for x in ok}
        deps = same_streams({x.rid: list(map(int, x.tokens)) for x in ok}, want_streams,
                            engine_gaps(gcfg, g_packed, [fleet.requests[x.rid] for x in ok],
                                        want_streams), f"fleet {label} vs solo")
        toks = sum(len(x.tokens) for x in ok)
        say(f"phase tp-fleet: {label}: {len(ok)}/{stats['admitted']} admitted completed "
            f"({stats['shed']} shed, {stats['degraded']} degraded), {toks / wall:.1f} tok/s, "
            f"wall {wall:.2f} s, hedges {stats['hedges']}, cancels {stats['cancels']}, failovers "
            f"{stats['failovers']}, restarts {stats['restarts']}, retries {stats['retries']}, "
            f"crashes {stats['crashes']}, survivors "
            f"{sum(r.state == 'live' for r in fleet.replicas)}; {deps} departures at near ties; "
            f"{len(built)} engines, {graphs} graphs ({replays} replays = their dispatches), graph "
            f"pools {pool_bytes / 1e9:.3f} GB; launches {got} (counting {t_count:.2f} s)")
        return fleet

    chaos = ftl._trace(gcfg, 16, seed=1, gen_lo=8, gen_hi=16)  # one trace: its solos once
    for lose in (True, False):
        inj = FaultInjector()
        inj.crash(0, at_step=2, lose_state=lose)
        fleet_run(f"kill 1 of 4 (lose_state={lose})",
                  FleetConfig(n_replicas=4, max_queue=64, hedge=False), chaos, inj)
    inj = FaultInjector()
    inj.stall(0, at_step=2, duration_s=2.0)
    fleet_run("stall 2 s on 1 of 4 (hedged)",
              FleetConfig(n_replicas=4, max_queue=64, hedge=True, hedge_stall_s=0.15), chaos, inj)
    fleet_run("admission (1 replica, queue 4)",
              FleetConfig(n_replicas=1, max_queue=4, degrade_cap=4, hedge=False),
              ftl._trace(gcfg, 8, seed=3))
    inj = FaultInjector()
    inj.crash(1, at_step=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # one card: the shards are emulated in turn
        fleet_run("2 replicas x 2 shards (crash 1)",
                  FleetConfig(n_replicas=2, shards_per_replica=2, max_queue=32, hedge=False),
                  ftl._trace(gcfg, 8, seed=4), inj)
    say(f"phase tp-fleet: fleets {time.perf_counter() - t_part:.1f} s ({len(solo_cache)} solo "
        f"generates)")
    del g_packed, gparams
    torch.cuda.empty_cache()

    # --- fleet_tolerance at the reference's reduced settings ---------------------
    t_part = time.perf_counter()
    gold = json.loads((ROOT / "benchmarks_torch" / "golden" / "reference.json").read_text())
    reset_counts()
    res = ftl.run(seed=gold["fleet_tolerance"]["seed"], device=dev)
    c = counts()
    failures = ftl.check(res)
    got = ftl.wall_free(res)
    bad = [s for s in ftl.WALL_FREE if got[s] != gold["fleet_tolerance"][s]]
    if failures or bad or c["plain"]:
        fail(f"fleet_tolerance on the card: gates {failures}, sections differing from the "
             f"golden file {bad}, launches {c}")
    kt, st = res["kill_trace"], res["stall_trace"]
    say(f"phase tp-fleet-bench: fleet_tolerance (reduced gemma-2b, f32): every wall-clock-free "
        f"field equal to the golden file ({', '.join(ftl.WALL_FREE)}); scaling tok/s "
        + ", ".join(f"{r['n_replicas']}: {r['tok_s']:.1f}" for r in res["scaling"])
        + "; TP tok/s (emulated, overhead only) "
        + ", ".join(f"{r['n_shards']}: {r['tok_s_per_replica']:.1f}" for r in res["tp_scaling"])
        + f"; kill {kt['completed']}/{kt['admitted']}, stall {st['completed']}/{st['admitted']} "
        f"({st['hedges']} hedges, wall {st['wall_s']:.2f} s); {time.perf_counter() - t_part:.1f} s")
    say(f"phase tp-fleet: {time.perf_counter() - t_phase:.1f} s; launches {totals}; max |d| at "
        f"shard shapes {errs}")
    return {**totals, "err": errs}


MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 1  # depth cut 24 -> 1, the only cut
MOE_M = (8, 11)  # expert-buffer rows: decode capacity (t = 4) and prefill capacity (t = 128)
MOE_SHAPES = ((2048, 1408), (1408, 2048))  # K x N of wi_gate / wi_up, and of wo
MOE_ROUTER = "segments/0/moe/router"  # the tensor re-planned on the CPU


def moe_prefill(cfg, params, batch) -> dict:
    """bf16 and f32 prefill logits of ``params`` and the experts every MoE
    layer routed each prompt token to (``moe._route``'s top-k, recorded)."""
    import torch

    from repro_torch.models import api, moe

    out = {}
    real = moe._route
    for dtype_name in ("bfloat16", "float32"):
        picks = []

        def record(*args):
            got = real(*args)
            picks.append(torch.sort(got[1], dim=-1).values)
            return got

        moe._route = record
        try:
            with torch.inference_mode():
                logits, _ = api.prefill(params, dataclasses.replace(cfg, dtype=dtype_name), batch)
        finally:
            moe._route = real
        if not torch.isfinite(logits).all():
            fail(f"non-finite {dtype_name} prefill logits")
        out[dtype_name] = (logits, picks)
    return out


def moe_logit_check(got: dict, want: dict, label: str, gate: tuple, arch=MOE_ARCH,
                    kept_rows=False) -> None:
    """Prefill logits of two deployments (``moe_prefill``), with the tokens
    whose expert set differs in any layer.  ``gate`` names the compute
    dtypes held to the bound (F32_LOGIT_RTOL / BF16_LOGIT_RTOL of the
    largest |logit|); the others are printed.  A MoE layer's routing is
    discrete: dense rounds w_hat to bf16 in bf16 compute, and a token whose
    top-k set flips takes other experts' outputs, so bf16 against dense is
    printed with its flips, and the bf16 gate compares two deployments that
    both compute on the exact w_hat.  With ``kept_rows`` (a one-layer model,
    where a token's routing reaches no other token's logits) the gate holds
    the rows whose last token, the one a prefill's logits come from, kept
    its experts in both; a flipped row is printed."""
    import torch

    for dtype_name, rtol in (("bfloat16", BF16_LOGIT_RTOL), ("float32", F32_LOGIT_RTOL)):
        (lg, pg), (lw, pw) = got[dtype_name], want[dtype_name]
        d_rows = (lg - lw).abs().amax(dim=tuple(range(1, lg.ndim)))  # (B,)
        d = d_rows.max().item()
        lim = rtol * lw.abs().max().item()
        flips = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(pg, pw))
        b_, s_ = lg.shape[0], len(pw[0]) // lg.shape[0]
        last = torch.arange(b_, device=d_rows.device) * s_ + s_ - 1
        flipped = torch.zeros(b_, dtype=torch.bool, device=d_rows.device)
        for a, b in zip(pg, pw):
            flipped |= (a[last] != b[last]).any(dim=-1).to(d_rows.device)
        held = dtype_name in gate
        d_held = d_rows[~flipped].max().item() if kept_rows and not flipped.all() else d
        say(f"phase logits: {arch} {dtype_name} prefill {label} max |d| {d:.4e}"
            + (f" ({d_held:.4e} over the {int((~flipped).sum())} of {b_} rows whose last token "
               f"kept its experts)" if kept_rows else "")
            + f" (bound {rtol:g} * max|logit| = {lim:.4e}{'' if held else ', printed'}); tokens "
            f"whose expert set differs, summed over layers: {flips} of {sum(len(a) for a in pw)}")
        if held and (d_held > lim or (kept_rows and flipped.all())):
            fail(f"{dtype_name} prefill logits of {label} differ by {d_held:.4e}")


MOE_MESHES = ((1, 4), (2, 4))  # (data, model): EP, 16 of the 64 allocated experts a shard
MLA_MESH = (1, 3)  # expert-TP: 160 % 3 != 0, d_expert 1536 -> 512 a shard


def mesh_line(cfg, shape) -> str:
    """How a (data, model) mesh splits a MoE config."""
    m, n = cfg.moe, shape[-1]
    shared = m.n_shared * m.d_expert
    split = (f"EP, {m.n_alloc // n} of the {m.n_alloc} allocated experts a shard"
             if m.n_alloc % n == 0 else
             f"expert-TP ({m.n_alloc} % {n} != 0), d_expert {m.d_expert} -> {m.d_expert // n}")
    return f"(data {shape[0]}, model {n}): {split}, shared GLU {shared} -> {shared // n} a shard"


def f32_prefill(cfg, params, batch):
    """The float32 prefill logits of ``params`` (f32 compute)."""
    import torch

    from repro_torch.models import api

    with torch.inference_mode():
        return api.prefill(params, dataclasses.replace(cfg, dtype="float32"), batch)[0].float()


def sharded_served(label, cfg, params, batch, shape, want=None, blockwise=0):
    """Serve ``params`` under the (data, model) ``shape`` mesh through the
    serve gates (graph and eager loop, launches from the graph's nodes: B3 =
    layers a prefill, or MLA's ``blockwise`` attention, no CIM kernel), and
    hold it to the unsharded path on each data shard's rows alone: the f32
    prefill logits within F32_LOGIT_RTOL of the largest logit (the data
    shards are row-independent but for the capacity, which each takes from
    its own rows), and the bf16 tokens equal but at near ties
    (``tp_departures``).  ``want``: the unsharded tokens of the whole batch
    where there is one data shard.  Returns (tokens, tok/s, counts, the
    decode graph's node count, the logit |d|, departures)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    rows = BATCH // shape[0]
    parts = [{"tokens": batch["tokens"][i * rows:(i + 1) * rows]} for i in range(shape[0])]
    plain = torch.cat([f32_prefill(cfg, params, b) for b in parts])
    if want is None or shape[0] > 1:
        want = torch.cat([serve.generate(cfg, params, b, gen_len=GEN)[0] for b in parts])
    what = f"{label} under the {shape} mesh"
    moe.set_moe_distribution(make_mesh(shape, ("data", "model")))
    try:
        got = f32_prefill(cfg, params, batch)
        toks, tps, timed, c = served(what, cfg, params, batch, GEN, None, 0,
                                     expect={} if blockwise else None, blockwise=blockwise)
        nodes = len(timed.decode.node_labels())
    finally:
        moe.set_moe_distribution(None)
    d = (got - plain).abs().max().item()
    lim = F32_LOGIT_RTOL * plain.abs().max().item()
    if not d <= lim:
        fail(f"{what}: f32 prefill logits depart from the unsharded prefill of each data "
             f"shard's rows by {d:.4e} (bound {lim:.4e})")
    dep = sum(tp_departures(cfg, params, b, toks[i * rows:(i + 1) * rows],
                            want[i * rows:(i + 1) * rows], what) for i, b in enumerate(parts))
    say(f"phase moe-sharded: {what} {mesh_line(cfg, shape)}: f32 prefill logits vs the "
        f"unsharded prefill of each data shard's rows max |d| {d:.4e} (bound {lim:.4e}); bf16 "
        f"tokens vs the unsharded generate of each data shard's rows: {dep} near-tie "
        f"departure(s) of {toks.shape[0]} rows; decode one CUDA graph of {nodes} nodes, "
        f"{timed.decode.replays} replays; graph {tps:.1f} tok/s")
    return toks, tps, c, nodes, d, dep


def moe_sharded_phase(dev, cfg, params, p_dense, p_packed, batch, toks, fp_nodes, add) -> dict:
    """Phase moe's sharded half: fp and dense at every mesh of MOE_MESHES
    (``sharded_served``), and the packed deployment refused under a mesh
    (ROADMAP C.15: the reference's shard_map refuses operand dicts)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe

    t0 = time.perf_counter()
    out = {}
    for shape in MOE_MESHES:
        for name, p in (("fp", params), ("dense", p_dense)):
            got = sharded_served(f"{MOE_ARCH} {name}", cfg, p, batch, shape,
                                 want=toks[name])
            add(got[2])
            out[f"{name} {shape}"] = got
    moe.set_moe_distribution(make_mesh(MOE_MESHES[0], ("data", "model")))
    try:
        api.prefill(p_packed, cfg, batch)
    except ValueError as e:
        refusal = str(e)
    else:
        fail(f"{MOE_ARCH}: a packed deployment served under a mesh (the sharded dispatch takes "
             f"dense weights, ROADMAP C.15)")
    finally:
        moe.set_moe_distribution(None)
    say(f"phase moe-sharded: packed deployment under the {MOE_MESHES[0]} mesh refused: "
        f"{refusal}")
    say(f"phase moe-sharded: {time.perf_counter() - t0:.1f} s; decode graph nodes: unsharded fp "
        f"{fp_nodes}, " + ", ".join(f"{k_} {v[3]}" for k_, v in out.items())
        + "; max f32 logit |d| " + f"{max(v[4] for v in out.values()):.4e}; near-tie departures "
        + ", ".join(f"{k_} {v[5]}" for k_, v in out.items()))
    return out


def check_expert_tp_views(dev) -> None:
    """The batched ``@`` copies no expert-TP shard's strided view: MLA's
    wi_gate [160, 5120, 1536] sliced to 512 columns and wo [160, 1536, 5120]
    to 512 rows (bf16, M 8 a group): torch.profiler's
    op records of one ``layers.linear`` call (a copy shows as aten::copy_,
    aten::clone or aten::contiguous) and its time against the same product
    on a contiguous copy of the view.  The sharded dispatch slices its
    shards per call and relies on this, so a copy fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers

    g_, k, n = 160, 5120, 1536
    nl = n // MLA_MESH[-1]
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    w = torch.randn(g_, k, n, device=dev, dtype=bf, generator=gen)
    wo = torch.randn(g_, n, k, device=dev, dtype=bf, generator=gen)
    cases = {"wi_gate[..., :512]": (torch.randn(g_, 8, k, device=dev, dtype=bf, generator=gen),
                                    w[..., :nl]),
             "wo[:, :512]": (torch.randn(g_, 8, nl, device=dev, dtype=bf, generator=gen),
                             wo[:, :nl])}
    for name, (x, view) in cases.items():
        layers.linear(view, x, bf)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y = layers.linear(view, x, bf)
            torch.cuda.synchronize()
        copies = sum(e.count for e in prof.key_averages()
                     if e.key in ("aten::copy_", "aten::clone", "aten::contiguous"))
        dense = view.contiguous()
        if not torch.equal(y, layers.linear(dense, x, bf)):
            fail(f"the batched @ on the strided {name} view differs from it on a copy")
        ms_view = cuda_ms(lambda: layers.linear(view, x, bf))
        ms_dense = cuda_ms(lambda: layers.linear(dense, x, bf))
        say(f"phase mla-views: {name} {list(view.shape)} strides {list(view.stride())}: copy "
            f"ops a call {copies}; {ms_view:.4f} ms on the view, {ms_dense:.4f} ms on a "
            f"contiguous copy")
        if copies:
            fail(f"the batched @ copies the strided expert-TP view {name} on every call "
                 f"({copies} copy ops); cut contiguous shards once instead")
        del dense
    del w, wo, cases
    torch.cuda.empty_cache()


def moe_stacks(dev, g_, k, n, seed):
    """Expert stacks of one matmul (G = ``g_``, a config's n_alloc):
    packed operands with every tile live, the same with about half of the
    (plane, 128-row) tiles zero (const_rle flags), int8 planes, and the
    dense bf16 weights of the first (``torch.bmm``'s operand)."""
    import torch

    from repro_torch.core import planes, simulator

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(0, 1024, (g_, k, n), dtype=torch.int32, device=dev, generator=gen)
    s = torch.where(torch.rand(g_, k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
    scale = 0.02 / 1023 * (1 + torch.arange(g_, dtype=torch.float32, device=dev) / g_)
    zero = torch.zeros(g_, device=dev)
    packed = simulator.packed_operands(q, s, scale, zero, 10)
    rle = dict(packed)
    dead = torch.rand(g_, 10, -(-k // 128), device=dev, generator=gen) < 0.5
    rows = dead.repeat_interleave(16, dim=-1)[..., : packed["planes_packed"].shape[-2]]
    rle["planes_packed"] = packed["planes_packed"] * (~rows)[..., None]
    rle = planes.encode_operands(rle, "const_rle")
    int8 = simulator.int8_plane_operands(q, s, scale, 0.0, 10)
    dense = (q.float() * s.float() * scale[:, None, None]).to(torch.bfloat16)
    return packed, rle, int8, dense


def check_moe_kernels(dev, g_=64, shapes=MOE_SHAPES, ms=MOE_M, label="moe-kernels") -> dict:
    """The grouped launches at a MoE config's expert shapes (G ``g_``, M in
    ``ms``, K x N in ``shapes``, bf16 and f32 x; qwen2-moe-a2.7b's by
    default): B2, B4 (about 50% zero tiles) and B5 each ONE launch, within
    2 * eps * K * (|x| @ |w|) of its plain version, equal to G single
    launches bit for bit where both take the same launch plan (else within
    twice the bound), B4 == B2 on the same bits.  Then, bf16 x at M in
    ``ms`` on the first shape (wi_gate's): the grouped launch, the same work
    as G single launches, the plain version and ``torch.bmm`` on dense bf16
    [G, K, N] weights, timed, beside the byte bound.  Returns max |d| by
    kernel and the timing records."""
    import torch

    from repro_torch.core import planes
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.cim_matmul import ref as cim_ref

    t0 = time.perf_counter()
    eps = torch.finfo(torch.float32).eps
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {"B2": 0.0, "B4": 0.0, "B5": 0.0}
    n_cases, n_same = 0, 0
    records = {}

    def packed_call(op, flags):
        def call(x, i=None):
            pick = (lambda v: v) if i is None else (lambda v: v[i])
            return cim_ops.cim_matmul_packed(
                x if i is None else x[i], pick(op["planes_packed"]), pick(op["sign_packed"]),
                pick(op["scale"]), tile_nz=pick(op["plane_tile_nz"]) if flags else None)
        return call

    def planes_call(op):
        def call(x, i=None):
            if i is None:
                return cim_ops.cim_matmul(x, op["splanes"], op["scale"])
            return cim_ops.cim_matmul(x[i], op["splanes"][i], op["scale"][i])
        return call

    for k, n in shapes:
        packed, rle, int8, dense = moe_stacks(dev, g_, k, n, k + n)
        w_abs = {"B2": cim_ref.unpack_weights(packed["planes_packed"], packed["sign_packed"], k)
                 .abs() * packed["scale"][:, None, None],
                 "B4": cim_ref.unpack_weights(rle["planes_packed"], rle["sign_packed"], k)
                 .abs() * rle["scale"][:, None, None]}
        w_abs["B5"] = w_abs["B2"]
        kernels = {"B2": (packed_call(packed, False), lambda x: cim_ref.cim_matmul_packed(
                       x, packed["planes_packed"], packed["sign_packed"], packed["scale"])),
                   "B4": (packed_call(rle, True), lambda x: cim_ref.cim_matmul_packed(
                       x, rle["planes_packed"], rle["sign_packed"], rle["scale"])),
                   "B5": (planes_call(int8), lambda x: cim_ref.cim_matmul(
                       x, int8["splanes"], int8["scale"]))}
        for m in ms:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(g_, m, k, device=dev, generator=gen).to(dtype)
                tc = dtype == torch.bfloat16
                for name, (call, plain) in kernels.items():
                    reset_counts()
                    got = call(x)
                    c = counts()
                    want_c = {name: 1, **({f"{name}_tc": 1} if tc else {})}
                    if {k_: v for k_, v in c.items() if v} != want_c:
                        fail(f"grouped {name} {dtype} M={m} K={k} N={n} launched {c} "
                             f"(want {want_c}: one launch for {g_} experts)")
                    single = torch.stack([call(x, i) for i in range(g_)])
                    want = plain(x)
                    torch.cuda.synchronize()
                    lim = B2_BOUND_C * eps * k * (x.float().abs() @ w_abs[name])
                    d = (got - want).abs()
                    if got.shape != (g_, m, n) or not bool((d <= lim).all()):
                        fail(f"grouped {name} {dtype} M={m} K={k} N={n} outside the bound of its "
                             f"plain version: max |d| {d.max().item():.3e}")
                    if name == "B5":
                        plan = (lambda gr: cim_ops.tc_launch_plan(m, k, n, 10, sms, gr)) if tc \
                            else (lambda gr: cim_ops.launch_plan(m, k, n, sms, 4, gr))
                    else:
                        plan = (lambda gr: cim_ops.tc_packed_launch_plan(m, k, n, sms, gr)) if tc \
                            else (lambda gr: cim_ops.launch_plan(m, k, n, sms, groups=gr))
                    same = plan(1) == plan(g_)
                    if same and not torch.equal(got, single):
                        fail(f"grouped {name} {dtype} M={m} K={k} N={n} differs from {g_} single "
                             f"launches on the same plan {plan(1)}")
                    if not same and not bool(((got - single).abs() <= 2 * lim).all()):
                        fail(f"grouped {name} {dtype} M={m} K={k} N={n} outside twice the bound "
                             f"of {g_} single launches (plans {plan(g_)} / {plan(1)})")
                    if name == "B4":
                        b2 = cim_ops.cim_matmul_packed(x, rle["planes_packed"],
                                                       rle["sign_packed"], rle["scale"])
                        if not torch.equal(got, b2):
                            fail(f"grouped B4 differs from grouped B2 on the same bits at M={m}")
                        del b2
                    err[name] = max(err[name], d.max().item())
                    n_cases += 1
                    n_same += int(same)
                del x
        if (k, n) == shapes[0]:
            # timings: bf16 x, the main path's dtype
            for m in ms:
                x = torch.randn(g_, m, k, device=dev, generator=gen).to(torch.bfloat16)
                x_bytes, out_bytes, flops = g_ * m * k * 2, g_ * m * n * 4, 2 * g_ * m * k * n
                library = cuda_ms(lambda: torch.bmm(x, dense))
                for name, (call, plain) in kernels.items():
                    t_ms = cuda_ms(lambda: call(x))
                    singles = cuda_ms(lambda: [call(x, i) for i in range(g_)], reps=5)
                    plain_ms = cuda_ms(lambda: plain(x), reps=2, warmup=1)
                    if name == "B2":
                        w_bytes = g_ * 11 * (k // 8) * n
                    elif name == "B4":
                        w_bytes = sum(planes.operand_payload_bytes(
                            {f: rle[f][i] for f in ("planes_packed", "sign_packed",
                                                    "plane_tile_nz")})["total_bytes"]
                            for i in range(g_))
                    else:
                        w_bytes = g_ * 10 * k * n
                    b, by = bound(x_bytes + w_bytes + out_bytes, flops, BF16_TC_FLOPS)
                    records[f"{name} M={m}"] = dict(ms=t_ms, single_ms=singles, plain_ms=plain_ms,
                                                    library_ms=library, bound_ms=b, bound_by=by,
                                                    weight_bytes=w_bytes)
                    say(f"phase {label}: grouped {name} bf16 G={g_} M={m} K={k} N={n}: "
                        f"{t_ms:.4f} ms (bound {b:.4f} by {by}, weight bytes {w_bytes:,}); {g_} "
                        f"single launches {singles:.4f} ms; plain {plain_ms:.4f} ms; torch.bmm on "
                        f"dense bf16 {library:.4f} ms")
                del x
        del packed, rle, int8, dense, w_abs, kernels
        torch.cuda.empty_cache()
    say(f"phase {label}: {n_cases} grouped cases (B2, B4 at ~50% zero tiles, B5; G {g_}, M in "
        f"{ms}, K x N in {shapes}, bf16 and f32 x), each one launch, within "
        f"{B2_BOUND_C}*eps*K*(|x|@|w|) of its plain version, bit-equal to {g_} single launches in "
        f"the {n_same} cases on the same launch plan (the rest within twice the bound), B4 == B2; "
        f"max |d| {err}; {time.perf_counter() - t0:.1f} s")
    return {"err": err, "records": records}


def moe_phase(dev) -> dict:
    """qwen2-moe-a2.7b at its published width with the depth cut to
    MOE_LAYERS: one stateless plan (the router re-planned on the CPU) served
    fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves), then a
    const_rle plan through one pool served raw-packed (B2) and const_rle
    (B4), every variant through the serve gates: the routed experts' three
    matmuls ONE grouped launch each, (11 x layers + 1) x gen CIM launches a
    generate, 10 x layers x gen of them on the tensor cores (the router's and
    the head's f32 x take the FMA kernels).  Then the grouped kernels at the
    expert shapes (check_moe_kernels).  Returns the phase's launches, max
    |d| and the grouped timings."""
    import torch

    from repro_torch import prng, tree
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    m = cfg.moe
    say(f"phase moe-plan: {MOE_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"kv={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} vocab={cfg.vocab_size} "
        f"{m.n_routed} routed experts (allocated {m.n_alloc}) + {m.n_shared} shared, "
        f"top-{m.top_k}, "
        f"d_expert={m.d_expert}, capacity factor {m.capacity_factor}, untied head; depth cut "
        f"{full.n_layers} -> {MOE_LAYERS} layers (the only cut), p_stuck={P_STUCK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {MOE_ARCH} x{MOE_LAYERS} {api.param_count(params) / 1e6:.1f}M params "
        f"({api.active_param_count(params, cfg) / 1e6:.1f}M active a token: top-{m.top_k} of "
        f"{m.n_alloc} routed) from "
        f"the reference's key in {time.perf_counter() - t0:.2f} s")
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    init_peak = torch.cuda.max_memory_allocated()
    reset_counts()
    plan, plan_s, per_weight, plan_peak = plan_tracked(params, spec, pcfg, dev)
    c = counts()
    add(c)
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final}); "
            f"{per_weight[name]:.2f} B a weight in flight")
    tot = plan.totals()
    n_planned = sum(r.n_weights for r in plan.reports.values())
    say(f"phase moe-plan: {len(plan.reports)} tensors ({n_planned / 1e9:.3f}G weights) in "
        f"{plan_s:.2f} s; sws {tot['sws_speedup']:.4f}x total "
        f"{tot['total_speedup']:.4f}x; B1 launches {c['B1']}; peak CUDA memory "
        f"{max(init_peak, plan_peak) / 1e9:.2f} GB (the plan's {plan_peak / 1e9:.2f}); bytes in "
        f"flight a weight on the expert stacks: " + ", ".join(
            f"{k_} {v:.2f}" for k_, v in per_weight.items() if "/moe/w" in k_))
    if c["B1"] <= 0 or any(c[k_] for k_ in c if k_ not in ("B1", "plain")) or c["plain"]:
        fail(f"{MOE_ARCH} plan launched {c}")
    stacks = [f"segments/0/moe/{w}" for w in ("router", "wi_gate", "wi_up", "wo")]
    if not set(stacks) <= set(plan.reports) or "head/w" not in plan.reports:
        fail(f"{MOE_ARCH}: the router, the expert stacks or the head were not planned")
    key = planner.tensor_keys(params, pcfg)[MOE_ROUTER]
    w_cpu = dict(planner.iter_weights(params, pcfg))[MOE_ROUTER].cpu()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=MOE_ROUTER)
    same_report(plan.reports[MOE_ROUTER], r_cpu, f"{MOE_ARCH} {MOE_ROUTER}")
    if plan.deployed[MOE_ROUTER].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of {MOE_ARCH} {MOE_ROUTER} deploys other w_hat bytes")
    say(f"phase moe-plan-cpu: {MOE_ROUTER} {list(w_cpu.shape)} planned on the CPU: report "
        f"equal, w_hat bytes identical")

    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    # per forward: q, k, v, o, the router, the shared GLU's 3 and the routed
    # experts' 3 (one grouped launch each) a layer, and the planned head
    want = (11 * MOE_LAYERS + 1) * GEN
    want_tc = 10 * MOE_LAYERS * GEN  # the router's and the head's f32 x take the FMA kernels
    say(f"phase moe-serve: launch formula per generate: (11 x {MOE_LAYERS} + 1) x {GEN} = {want} "
        f"CIM launches (q, k, v, o, router, shared wi_gate / wi_up / wo, and the expert stacks' "
        f"wi_gate / wi_up / wo as one grouped launch each, a layer; the head), 10 x {MOE_LAYERS} "
        f"x {GEN} = {want_tc} on the tensor cores; B3 = {MOE_LAYERS} a prefill")
    tps, toks = {}, {}
    toks["fp"], tps["fp"], timed, c = served(f"{MOE_ARCH} fp", cfg, params, batch, GEN, None, 0)
    add(c)
    fp_nodes = len(timed.decode.node_labels())
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    toks["dense"], tps["dense"], _, c = served(f"{MOE_ARCH} dense", cfg, p_dense, batch, GEN,
                                               None, 0)
    add(c)
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    op = p_packed["segments"][0]["moe"]["wi_gate"]
    say(f"phase moe-deploy: segments/0/moe/wi_gate operands: planes "
        f"{list(op['planes_packed'].shape)}, scale {list(op['scale'].shape)} (layer, expert)")
    toks["packed"], tps["packed"], timed, c = served(f"{MOE_ARCH} packed", cfg, p_packed, batch,
                                                     GEN, "B2", want, want_tc=want_tc)
    add(c)
    say(f"phase trace: {MOE_ARCH} cim-packed generate: {trace(timed)}")
    pf = {"dense": moe_prefill(cfg, p_dense, batch), "packed": moe_prefill(cfg, p_packed, batch)}
    moe_logit_check(pf["packed"], pf["dense"], "packed vs dense", ("float32",))
    moe_sharded_phase(dev, cfg, params, p_dense, p_packed, batch, toks, fp_nodes, add)
    del timed, p_packed, op
    torch.cuda.empty_cache()
    p_int8, c6 = deploy_int8(params, plan)
    add(c6)
    int8_gb = sum(v["splanes"].numel() for v in _operand_dicts(p_int8)) / 1e9
    toks["planes_int8"], tps["planes_int8"], timed, c = served(
        f"{MOE_ARCH} planes_int8", cfg, p_int8, batch, GEN, "B5", want, want_tc=want_tc)
    add(c)
    say(f"phase trace: {MOE_ARCH} cim-planes_int8 generate: {trace(timed)}")
    pf["planes_int8"] = moe_prefill(cfg, p_int8, batch)
    moe_logit_check(pf["planes_int8"], pf["dense"], "planes_int8 vs dense", ("float32",))
    moe_logit_check(pf["planes_int8"], pf["packed"], "planes_int8 vs packed (both exact w_hat)",
                    ("bfloat16", "float32"))
    del pf
    say(f"phase moe-serve: {int8_gb:.2f} GB of int8 planes built by {c6['B6']} B6 launches; peak "
        f"CUDA memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del timed, p_int8, p_dense, plan
    torch.cuda.empty_cache()

    # const_rle through one persistent pool: the same bits served raw (B2) and flagged (B4)
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    pool_plan = planner.build_deployment(params, spec, pcfg_pool, pool=xbars, device=dev)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    c = counts()
    add(c)
    stats = xbars.stats()
    ptot = pool_plan.totals()
    say(f"phase moe-plan-pool: {len(pool_plan.reports)} tensors through a "
        f"{xbars.n_crossbars}-crossbar pool, codec {CODEC}, in {pool_s:.2f} s; sws "
        f"{ptot['sws_speedup']:.4f}x total {ptot['total_speedup']:.4f}x; B1 launches {c['B1']}; "
        f"pool wear max cell {stats.max_cell_writes}, total {stats.total_writes}")
    if c["B1"] <= 0 or any(c[k_] for k_ in c if k_ not in ("B1", "plain")) or c["plain"]:
        fail(f"{MOE_ARCH} pool plan launched {c}")
    if stats.total_writes != sum(r.transitions_final for r in pool_plan.reports.values()):
        fail("pool wear does not sum to the programmed transitions")
    p_raw = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    experts = p_rle["segments"][0]["moe"]["wi_gate"]
    live = int(experts["plane_tile_nz"].sum())
    flags = experts["plane_tile_nz"]
    say(f"phase moe-deploy: {CODEC} expert stack segments/0/moe/wi_gate: per-expert tile flags "
        f"{list(flags.shape)}, live tiles {live}/{flags.numel()}")
    toks["raw_pool"], tps["packed (pool plan)"], _, c = served(
        f"{MOE_ARCH} packed (pool plan)", cfg, p_raw, batch, GEN, "B2", want, want_tc=want_tc)
    add(c)
    toks["rle"], tps[f"packed {CODEC}"], _, c = served(
        f"{MOE_ARCH} packed {CODEC}", cfg, p_rle, batch, GEN, "B4", want, want_tc=want_tc)
    add(c)
    if not torch.equal(toks["rle"], toks["raw_pool"]):
        fail(f"{MOE_ARCH} {CODEC} tokens differ from raw-packed tokens of the same plan")
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase moe-serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16, graph tok/s "
        + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; {CODEC} tokens == raw-packed tokens; token agreement with dense {agree}; peak CUDA "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del p_raw, p_rle, experts, flags, pool_plan, params, xbars
    torch.cuda.empty_cache()

    kern = check_moe_kernels(dev)
    say(f"phase moe: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return {**totals, "err": kern["err"], "records": kern["records"]}


MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 1  # depth cut 60 -> 1, the only cut: one layer's three 1.26 G-weight stacks
MLA_M = (8,)  # expert-buffer rows: capacity 8 at decode (t = 4) and at prefill (t = 128)
MLA_SHAPES = ((5120, 1536), (1536, 5120))  # K x N of wi_gate / wi_up, and of wo
MLA_CHECK = "segments/0/mla/wkv_a"  # the tensor re-planned on the CPU
MLA_STACK = "segments/0/moe/wi_gate"  # the stack the sort kernel is held on
PLAN_BYTES_PER_WEIGHT = 24  # the planner's bytes in flight a weight on a full-width stack


def plan_tracked(params, spec, pcfg, dev, **kw):
    """``build_deployment`` with each tensor's bytes in flight: the peak
    CUDA memory while it is planned, less what was allocated when it began
    (its ``w_hat`` included), over its weights.  Returns (plan, seconds,
    bytes a weight by tensor, the plan's peak CUDA memory in bytes)."""
    import torch

    from repro_torch.core import planner

    peaks, cur = {}, {}

    def close():
        if cur:
            torch.cuda.synchronize()
            peaks[cur["name"]] = (torch.cuda.max_memory_allocated(), cur["base"])

    def progress(name):
        close()
        torch.cuda.synchronize()
        cur.update(name=name, base=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, progress=progress, device=dev, **kw)
    close()
    plan_s = time.perf_counter() - t0
    per_weight = {name: (peak - base) / plan.reports[name].n_weights
                  for name, (peak, base) in peaks.items()}
    return plan, plan_s, per_weight, max(peak for peak, _ in peaks.values())


def check_sort(w, encoding="sign_magnitude") -> dict:
    """The SWS sort kernel on one full stack (flat, ``w``'s own bytes)
    against its plain version (``torch.sort(stable=True)`` of the padded
    keys) on the card, bit for bit (random weights tie often: 1.26 G floats
    share far fewer values), then both timed beside ``torch.sort`` alone
    (the keys made beforehand) and the byte bound (w read, the int32
    permutation written)."""
    import torch

    from repro_torch.kernels.sws_sort import ops as sort_ops
    from repro_torch.kernels.sws_sort import ref as sort_ref

    flat = w.reshape(-1)
    n = flat.shape[0]
    n_total = n + (-n) % 128
    launches = sort_ops.LAUNCHES["SORT"]
    got = sort_ops.sws_argsort(flat, n_total, encoding)
    if sort_ops.LAUNCHES["SORT"] != launches + 1:
        fail("sws_argsort on a CUDA tensor did not launch its kernel")
    want = sort_ref.sws_argsort(flat, n_total, encoding)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"the SWS sort kernel differs from torch.sort(stable=True) in "
             f"{int((got != want).sum())} of {n_total} slots")
    del want
    ties = n - int(torch.unique(flat.abs()).numel())
    ms = cuda_ms(lambda: sort_ops.sws_argsort(flat, n_total, encoding), reps=3, warmup=1)
    plain_ms = cuda_ms(lambda: sort_ref.sws_argsort(flat, n_total, encoding), reps=3, warmup=1)
    key = sort_ref.sort_key(torch.nn.functional.pad(flat, (0, n_total - n)), encoding)
    library_ms = cuda_ms(lambda: torch.sort(key, stable=True), reps=3, warmup=1)
    del key, got
    torch.cuda.empty_cache()
    b, by = bound(4 * n + 4 * n_total, 0)
    say(f"phase mla-sort: the SWS sort kernel on {MLA_STACK} ({n:,} weights, {ties:,} of them "
        f"tied with another |w|): permutation == torch.sort(stable=True)'s bit for bit; "
        f"{ms:.4f} ms (bound {b:.4f} by {by}), plain {plain_ms:.4f} ms, torch.sort of the keys "
        f"{library_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b, bound_by=by)


def mla_phase(dev) -> dict:
    """deepseek-v2-236b at its published width with the depth cut to
    MLA_LAYERS: the SWS sort kernel held on one expert stack; a const_rle
    plan through one pool served raw-packed (B2) and const_rle (B4); one
    stateless plan (each tensor's bytes in flight printed, the expert
    stacks held to PLAN_BYTES_PER_WEIGHT; MLA_CHECK re-planned on the CPU)
    served fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves,
    after the f32 originals are freed), every variant through the serve
    gates: MLA's four planned projections, the router, the shared GLU's
    three and the expert stacks' three matmuls (ONE grouped launch each) a
    layer, and the head: (11 x layers + 1) x gen CIM launches a generate,
    10 x layers x gen on the tensor cores, no B3 (MLA's prefill attention
    is ``blockwise_attention``, once a layer a prefill, as the reference's
    is); prefill logits within dense's bound.  Then the grouped kernels at
    G 160 and the expert shapes (check_moe_kernels).  Returns the phase's
    launches, max |d|, the grouped timings and the sort's record."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.kernels.sws_sort import ops as sort_ops
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    m, a = cfg.moe, cfg.mla
    say(f"phase mla-plan: {MLA_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} MLA q_lora "
        f"{a.q_lora_rank} kv_lora {a.kv_lora_rank} nope {a.qk_nope_head_dim} rope "
        f"{a.qk_rope_head_dim} v {a.v_head_dim}, vocab={cfg.vocab_size}, {m.n_routed} routed "
        f"experts + {m.n_shared} shared, top-{m.top_k}, d_expert={m.d_expert}, untied head; "
        f"depth cut {full.n_layers} -> {MLA_LAYERS} (the only cut), p_stuck={P_STUCK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {MLA_ARCH} x{MLA_LAYERS} {api.param_count(params) / 1e9:.3f}G params "
        f"({api.active_param_count(params, cfg) / 1e9:.3f}G active a token) from the reference's "
        f"key in {time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    sort_rec = check_sort(dict(planner.iter_weights(params, planner.PlannerConfig()))[MLA_STACK])
    spec = planner.CrossbarSpec()
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    # per forward: MLA's wq_a, wq_b, wkv_a and wo (wk_b / wv_b stay dense w_hat), the router,
    # the shared GLU's 3 and the routed experts' 3 (one grouped launch each) a layer; the head
    want = (11 * MLA_LAYERS + 1) * GEN
    want_tc = 10 * MLA_LAYERS * GEN  # the router's and the head's f32 x take the FMA kernels
    say(f"phase mla-serve: launch formula per generate: (11 x {MLA_LAYERS} + 1) x {GEN} = {want} "
        f"CIM launches (wq_a, wq_b, wkv_a, wo, router, shared wi_gate / wi_up / wo, and the "
        f"expert stacks' wi_gate / wi_up / wo as one grouped launch each, a layer; the head), "
        f"10 x {MLA_LAYERS} x {GEN} = {want_tc} on the tensor cores; no B3, blockwise_attention "
        f"{MLA_LAYERS} a prefill")

    def serve_mla(label, p, kernel):
        exp = {kernel: want, f"{kernel}_tc": want_tc} if kernel else {}
        out = served(f"{MLA_ARCH} {label}", cfg, p, batch, GEN, kernel, want, want_tc=want_tc,
                     expect=exp, blockwise=MLA_LAYERS)
        add(out[3])
        say(f"phase mla-memory: after {label}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return out

    def plan_line(label, plan, plan_s, per_weight, peak, c, gate):
        tot = plan.totals()
        n_planned = sum(r.n_weights for r in plan.reports.values())
        stacks = {k_: v for k_, v in per_weight.items() if "/moe/w" in k_}
        say(f"phase {label}: {len(plan.reports)} tensors ({n_planned / 1e9:.3f}G weights) in "
            f"{plan_s:.2f} s; sws {tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; "
            f"B1 {c['B1']}, SORT {c['SORT']}; peak CUDA memory {peak / 1e9:.2f} GB; bytes in "
            f"flight a weight: " + ", ".join(f"{k_} {v:.2f}" for k_, v in stacks.items())
            + f" (all tensors: max {max(per_weight.values()):.2f})")
        if c["B1"] <= 0 or c["SORT"] != len(plan.reports) or any(
                c[k_] for k_ in c if k_ not in ("B1", "SORT", "plain")) or c["plain"]:
            fail(f"{MLA_ARCH} {label} launched {c} (want B1 > 0, one SORT a tensor)")
        over = {k_: v for k_, v in stacks.items() if v > PLAN_BYTES_PER_WEIGHT}
        if len(stacks) != 3 or (gate and over):
            fail(f"{MLA_ARCH} {label}: the expert stacks took {over or stacks} bytes a weight in "
                 f"flight (at most {PLAN_BYTES_PER_WEIGHT})")

    def plan_counts():
        return {**counts(), "SORT": sort_ops.LAUNCHES["SORT"] - sort_base}

    # const_rle through one persistent pool: the same bits served raw (B2) and flagged (B4)
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    reset_counts()
    sort_base = sort_ops.LAUNCHES["SORT"]
    pool_plan, pool_s, pool_pw, pool_peak = plan_tracked(params, spec, pcfg_pool, dev, pool=xbars)
    c = plan_counts()
    add(c)
    plan_line("mla-plan-pool", pool_plan, pool_s, pool_pw, pool_peak, c, gate=False)
    stats = xbars.stats()
    if stats.total_writes != sum(r.transitions_final for r in pool_plan.reports.values()):
        fail("pool wear does not sum to the programmed transitions")
    toks, tps = {}, {}
    p_raw = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    toks["raw_pool"], tps["packed (pool plan)"], _, _ = serve_mla("packed (pool plan)", p_raw, "B2")
    del p_raw
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    flags = p_rle["segments"][0]["moe"]["wi_gate"]["plane_tile_nz"]
    say(f"phase mla-deploy: {CODEC} expert stack segments/0/moe/wi_gate: per-expert tile flags "
        f"{list(flags.shape)}, live tiles {int(flags.sum())}/{flags.numel()}; pool wear max cell "
        f"{stats.max_cell_writes}, total {stats.total_writes}")
    toks["rle"], tps[f"packed {CODEC}"], _, _ = serve_mla(f"packed {CODEC}", p_rle, "B4")
    if not torch.equal(toks["rle"], toks["raw_pool"]):
        fail(f"{MLA_ARCH} {CODEC} tokens differ from raw-packed tokens of the same plan")
    del p_rle, flags, pool_plan, xbars
    torch.cuda.empty_cache()

    # the stateless plan
    pcfg = planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    sort_base = sort_ops.LAUNCHES["SORT"]
    plan, plan_s, per_weight, peak = plan_tracked(params, spec, pcfg, dev)
    c = plan_counts()
    add(c)
    plan_line("mla-plan", plan, plan_s, per_weight, peak, c, gate=True)
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final}); "
            f"{per_weight[name]:.2f} B a weight in flight")
    want_planned = {f"segments/0/mla/{w}" for w in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")}
    want_planned |= {f"segments/0/moe/{w}" for w in ("router", "wi_gate", "wi_up", "wo")}
    if not want_planned | {"head/w"} <= set(plan.reports):
        fail(f"{MLA_ARCH}: not planned: {sorted(want_planned - set(plan.reports))}")
    key = planner.tensor_keys(params, pcfg)[MLA_CHECK]
    w_cpu = dict(planner.iter_weights(params, pcfg))[MLA_CHECK].cpu()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=MLA_CHECK)
    same_report(plan.reports[MLA_CHECK], r_cpu, f"{MLA_ARCH} {MLA_CHECK}")
    if plan.deployed[MLA_CHECK].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of {MLA_ARCH} {MLA_CHECK} deploys other w_hat bytes")
    say(f"phase mla-plan-cpu: {MLA_CHECK} {list(w_cpu.shape)} planned on the CPU: report "
        f"equal, w_hat bytes identical")
    del w_cpu, w_hat_cpu

    toks["fp"], tps["fp"], timed, _ = serve_mla("fp", params, None)
    fp_nodes = len(timed.decode.node_labels())
    say(f"phase mla-sharded: {MLA_ARCH} {mesh_line(cfg, MLA_MESH)}")
    got = sharded_served(f"{MLA_ARCH} fp", cfg, params, batch, MLA_MESH, want=toks["fp"],
                         blockwise=MLA_LAYERS)
    add(got[2])
    say(f"phase mla-sharded: decode graph nodes: unsharded fp {fp_nodes}, {MLA_MESH} {got[3]}")
    check_expert_tp_views(dev)
    del timed
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    toks["dense"], tps["dense"], _, _ = serve_mla("dense", p_dense, None)
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    op = p_packed["segments"][0]["moe"]["wi_gate"]
    say(f"phase mla-deploy: segments/0/moe/wi_gate operands: planes "
        f"{list(op['planes_packed'].shape)}, scale {list(op['scale'].shape)} (layer, expert); "
        f"wk_b / wv_b dense w_hat {list(p_packed['segments'][0]['mla']['wk_b'].shape)}")
    toks["packed"], tps["packed"], timed, _ = serve_mla("packed", p_packed, "B2")
    say(f"phase trace: {MLA_ARCH} cim-packed generate: {trace(timed)}")
    pf = {"dense": moe_prefill(cfg, p_dense, batch), "packed": moe_prefill(cfg, p_packed, batch)}
    moe_logit_check(pf["packed"], pf["dense"], "packed vs dense", ("float32",), MLA_ARCH,
                    kept_rows=True)
    del timed, p_packed, op
    # planes_int8 takes 10 bytes a planned weight: free the f32 originals of every planned
    # tensor first (the dense tree shares w_hat and the unplanned leaves)
    del params
    torch.cuda.empty_cache()
    p_int8, c6 = deploy_int8(p_dense, plan)
    add(c6)
    int8_gb = sum(v["splanes"].numel() for v in _operand_dicts(p_int8)) / 1e9
    del p_dense, plan
    torch.cuda.empty_cache()
    toks["planes_int8"], tps["planes_int8"], timed, _ = serve_mla("planes_int8", p_int8, "B5")
    say(f"phase trace: {MLA_ARCH} cim-planes_int8 generate: {trace(timed)}")
    pf["planes_int8"] = moe_prefill(cfg, p_int8, batch)
    moe_logit_check(pf["planes_int8"], pf["dense"], "planes_int8 vs dense", ("float32",),
                    MLA_ARCH, kept_rows=True)
    moe_logit_check(pf["planes_int8"], pf["packed"], "planes_int8 vs packed (both exact w_hat)",
                    ("bfloat16", "float32"), MLA_ARCH, kept_rows=True)
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase mla-serve: {int8_gb:.2f} GB of int8 planes built by {c6['B6']} B6 launches; "
        f"batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16, graph tok/s "
        + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; {CODEC} tokens == raw-packed tokens; token agreement with dense {agree}; peak CUDA "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del pf, timed, p_int8
    torch.cuda.empty_cache()

    kern = check_moe_kernels(dev, m.n_alloc, MLA_SHAPES, MLA_M, "mla-kernels")
    say(f"phase mla: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return {**totals, "err": kern["err"], "records": kern["records"], "sort": sort_rec}


def plan_counted(label, arch, params, spec, pcfg, dev, **kw):
    """``build_deployment`` on the card, timed, with its launches: B1 > 0
    and nothing else.  Returns the plan and the counts."""
    import torch

    from repro_torch.core import planner

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev, **kw)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    c = counts()
    tot = plan.totals()
    n_w = sum(r.n_weights for r in plan.reports.values())
    say(f"phase {label}: {len(plan.reports)} tensors ({n_w / 1e6:.1f}M weights) in "
        f"{plan_s:.2f} s; sws {tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; "
        f"B1 {c['B1']}; peak CUDA memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if c["B1"] <= 0 or any(c[k_] for k_ in c if k_ not in ("B1", "plain")) or c["plain"]:
        fail(f"{arch} {label} launched {c}")
    return plan, c


def family_decode_check(cfg, p_packed, tokens, prompt, extra, label) -> None:
    """The packed deployment's decode after ``prompt`` positions against
    forward at every decoded position: in f32 within F32_LOGIT_RTOL of
    forward's largest logit (held), in bf16 printed beside
    BF16_LOGIT_RTOL."""
    import torch

    from repro_torch.launch import steps

    for dtype, rtol, held in ((torch.float32, F32_LOGIT_RTOL, True),
                              (torch.bfloat16, BF16_LOGIT_RTOL, False)):
        c_ = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
        served_p = steps.prepare_serving_params(p_packed, dtype)
        d, top, finite = decode_departure(c_, served_p, tokens, prompt, extra)
        bnd = rtol * top
        say(f"phase {label}: packed {c_.dtype}, batch {tokens.shape[0]}, prompt {prompt}, "
            f"{tokens.shape[1] - prompt - 1} decode steps vs forward over {tokens.shape[1]} "
            f"positions: max |d| {d:.4e} at any decoded position (bound {rtol:g} * max|logit| "
            f"= {bnd:.4e}{'' if held else ', printed'})")
        if not finite or (held and d > bnd):
            fail(f"{cfg.name} {c_.dtype}: decode logits differ from forward by {d:.4e} "
                 f"(finite: {finite})")
        del served_p


HYMBA_ARCH = "hymba-1.5b"
HYMBA_LAYERS = 2  # depth cut 32 -> 2, the only cut (the run's time limit): [global, swa]
# a one-layer segment's dt_bias and d_skip are [1, 3200]: planned (and served dense, ROADMAP
# C.12) from this size, as the default 4096 plans a two-layer segment's
HYMBA_MIN_SIZE = 3200
HYMBA_LONG_PROMPT = 1024  # + 128 meta tokens: past the 1024 window, the ring wraps
HYMBA_LOGIT_RTOL = 0.02  # the long generate's last decode logits vs forward, bf16
# K x N of the Mamba projections no other served model reaches: x_proj (N = 132, not a
# multiple of 16) and dt_proj (K = 100, not a multiple of 8): the kernels' non-vec branches
MAMBA_SHAPES = {"x_proj": (3200, 132), "dt_proj": (100, 3200)}
MAMBA_M = (BATCH, BATCH * (128 + PROMPT))  # decode rows, and a served prefill's rows


def check_cim_shapes(dev, label: str, shapes: dict, ms: tuple, f32_only=()) -> dict:
    """B2, B4 (~half the tiles zero, const_rle flags) and B5 at a model's
    projection ``shapes`` ({name: (K, N)}), M in ``ms``, bf16 x
    (tensor-core kernels) and f32 x (FMA kernels; the names in
    ``f32_only``, an LM head served on f32 x, f32 x alone): within the
    bound of the plain version, B4 == B2 bit for bit.  Returns the max |d|
    by kernel and the number of cases ("cases")."""
    import torch

    from repro_torch.core import planes, simulator
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.cim_matmul import ref as cim_ref

    eps = torch.finfo(torch.float32).eps
    errs, n_cases = {"B2": 0.0, "B4": 0.0, "B5": 0.0}, 0
    for name, (k, n) in shapes.items():
        gen = torch.Generator(device=dev).manual_seed(k + n)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gen)
        sg = torch.where(torch.rand(k, n, device=dev, generator=gen) < 0.5, -1, 1).to(torch.int8)
        op = simulator.packed_operands(q, sg, 0.02 / 1023, 0.0, 10)
        dead = torch.rand(10, -(-k // 128), device=dev, generator=gen) < 0.5
        rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
        op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
        op = planes.encode_operands(op, "const_rle")
        i8 = simulator.int8_plane_operands(q, sg, 0.02 / 1023, 0.0, 10)
        args = (op["planes_packed"], op["sign_packed"], op["scale"])
        w_abs = cim_ref.unpack_weights(*args[:2], k).abs() * op["scale"]
        w8_abs = q.float() * i8["scale"]
        for m in ms:
            for dtype in ((torch.float32,) if name in f32_only else
                          (torch.bfloat16, torch.float32)):
                x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
                tc = dtype == torch.bfloat16
                cim_ops.reset_launches()
                got = {"B2": cim_ops.cim_matmul_packed(x, *args),
                       "B4": cim_ops.cim_matmul_packed(x, *args, tile_nz=op["plane_tile_nz"]),
                       "B5": cim_ops.cim_matmul(x, i8["splanes"], i8["scale"])}
                path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
                if path != {"B2": 1, "B4": 1, "B5": 1,
                            **({"B2_tc": 1, "B4_tc": 1, "B5_tc": 1} if tc else {})}:
                    fail(f"B2/B4/B5 at {name} [{k}, {n}] M={m} {dtype} took the wrong "
                         f"kernels: {path}")
                want = cim_ref.cim_matmul_packed(x, *args)
                want5 = cim_ref.cim_matmul(x, i8["splanes"], i8["scale"])
                torch.cuda.synchronize()
                xa = x.float().abs()
                for kern, w_, wa in (("B2", want, w_abs), ("B4", want, w_abs),
                                     ("B5", want5, w8_abs)):
                    err = (got[kern] - w_).abs()
                    if got[kern].shape != (m, n) or not bool(
                            (err <= B2_BOUND_C * eps * k * (xa @ wa)).all()):
                        fail(f"{kern} outside the bound of its plain version at {name} "
                             f"[{k}, {n}] M={m} {dtype}: max |d| {err.max().item():.3e}")
                    errs[kern] = max(errs[kern], err.max().item())
                if not torch.equal(got["B4"], got["B2"]):
                    fail(f"B4 differs from B2 at {name} M={m} {dtype}")
                n_cases += 1
        del op, i8, q, sg, w_abs, w8_abs
    torch.cuda.empty_cache()
    say(f"phase {label}: B2, B4 (~50% zero tiles) and B5 at "
        + " and ".join(f"{name} [{k}, {n}]" for name, (k, n) in shapes.items())
        + f", M in {ms}, bf16 x on the tensor-core kernels and f32 x on the FMA kernels"
        + (f" ({', '.join(f32_only)}: f32 x only)" if f32_only else "") + ": "
        f"{n_cases} cases within {B2_BOUND_C}*eps*K*(|x|@|w|) of the plain versions, B4 == "
        f"B2; max |d| " + ", ".join(f"{k_} {v:.3e}" for k_, v in errs.items()))
    return {**errs, "cases": n_cases}


def hymba_decode_logits(cfg, params, tokens, prompt) -> tuple:
    """Eager prefill of ``tokens[:, :prompt]`` and teacher-forced decode
    steps over the rest (through ring caches and the SSM state): the last
    step's logits, and ``forward``'s over the whole of ``tokens`` at the
    same position."""
    import torch

    from repro_torch.models import api

    b, total = tokens.shape
    with torch.inference_mode():
        logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt]})
        cache = api.merge_prefill_cache(
            cfg, api.init_cache(cfg, b, total, device=tokens.device), pf)
        for i in range(prompt, total):
            logits, cache = api.decode_step(params, cfg, cache, tokens[:, i:i + 1],
                                            torch.tensor(i, device=tokens.device))
        full, _ = api.forward(params, cfg, {"tokens": tokens})
    return logits[:, 0], full[:, -1]


def hymba_phase(dev) -> dict:
    """hymba-1.5b at its published width with the depth cut to
    HYMBA_LAYERS (one hymba_global layer, one hymba_swa): init from the
    reference's key; a const_rle plan through one pool served raw-packed
    (B2) and const_rle (B4, tokens == raw-packed); one stateless plan served
    fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves), each
    through the serve gates: 11 CIM matmuls a layer (wq, wk, wv, wo,
    in_proj, x_proj, dt_proj, out_proj, the MLP's three) and the head,
    (11 x layers + 1) x gen CIM launches a generate, 11 x layers x gen on
    the tensor cores (the f32 head on FMA), B3 = B3_tc = layers at D = 64,
    no plain-version call, no blockwise_attention; prefill logits of packed
    and planes_int8 within the bound of dense's.  Then one long-prompt
    generate (packed, prompt HYMBA_LONG_PROMPT: 1,152 positions with the
    meta tokens, past the 1024 window) through the serve gates, and its
    last decode logits within HYMBA_LOGIT_RTOL of forward's largest over
    the whole sequence.  Returns the phase's launches."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.launch import steps
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(HYMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYMBA_LAYERS)
    sc = cfg.ssm
    say(f"phase hymba-plan: {HYMBA_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"kv={cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"untied head, SSM state {sc.state_size} conv {sc.conv_width} expand {sc.expand} chunk "
        f"{sc.chunk_size}, window {cfg.attn_window}, {cfg.n_meta_tokens} meta tokens; depth cut "
        f"{full.n_layers} -> {HYMBA_LAYERS} (the only cut): {cfg.layer_kinds()}, "
        f"p_stuck={P_STUCK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {HYMBA_ARCH} x{HYMBA_LAYERS} {api.param_count(params) / 1e6:.1f}M params "
        f"from the reference's key in {time.perf_counter() - t0:.2f} s")
    spec = planner.CrossbarSpec()
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    want = (11 * HYMBA_LAYERS + 1) * GEN
    want_tc = 11 * HYMBA_LAYERS * GEN
    say(f"phase hymba-serve: launch formula per generate: (11 x {HYMBA_LAYERS} + 1) x {GEN} = "
        f"{want} CIM launches (wq, wk, wv, wo, in_proj, x_proj, dt_proj, out_proj, wi_gate, "
        f"wi_up, wo a layer; the head), 11 x {HYMBA_LAYERS} x {GEN} = {want_tc} on the tensor "
        f"cores; B3 = B3_tc = {HYMBA_LAYERS} a prefill (D = 64, S = "
        f"{cfg.n_meta_tokens + PROMPT})")

    def serve_hymba(label, p, kernel, b=batch):
        out = served(f"{HYMBA_ARCH} {label}", cfg, p, b, GEN, kernel, want,
                     want_tc=want_tc if kernel else 0)
        add(out[3])
        return out

    def plan_timed(label, pcfg, **kw):
        plan_, c = plan_counted(label, HYMBA_ARCH, params, spec, pcfg, dev, **kw)
        add(c)
        return plan_

    toks, tps = {}, {}
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC, min_size=HYMBA_MIN_SIZE)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    pool_plan = plan_timed("hymba-plan-pool", pcfg_pool, pool=xbars)
    p_raw = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    toks["raw_pool"], tps["packed (pool plan)"], _, _ = serve_hymba("packed (pool plan)", p_raw,
                                                                   "B2")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    toks["rle"], tps[f"packed {CODEC}"], _, _ = serve_hymba(f"packed {CODEC}", p_rle, "B4")
    if not torch.equal(toks["rle"], toks["raw_pool"]):
        fail(f"{HYMBA_ARCH} {CODEC} tokens differ from raw-packed tokens of the same plan")
    del p_raw, p_rle, pool_plan, xbars

    plan = plan_timed("hymba-plan", planner.PlannerConfig(p_stuck=P_STUCK,
                                                          min_size=HYMBA_MIN_SIZE))
    need = {f"segments/1/mamba/{w}" for w in ("in_proj", "x_proj", "dt_proj", "out_proj",
                                               "conv/w", "a_log", "dt_bias", "d_skip")}
    need |= {"meta", "head/w"}
    if not need <= set(plan.reports):
        fail(f"{HYMBA_ARCH}: not planned: {sorted(need - set(plan.reports))}")
    toks["fp"], tps["fp"], _, _ = serve_hymba("fp", params, None)
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    toks["dense"], tps["dense"], _, _ = serve_hymba("dense", p_dense, None)
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    m_ops = p_packed["segments"][1]["mamba"]
    leaves = [m_ops["conv"]["w"], m_ops["a_log"], m_ops["dt_bias"], m_ops["d_skip"],
              p_packed["meta"]]
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        fail(f"{HYMBA_ARCH}: conv / a_log / dt_bias / d_skip / meta not served dense")
    say(f"phase hymba-deploy: segments/1/mamba operands: x_proj planes "
        f"{list(m_ops['x_proj']['planes_packed'].shape)}, dt_proj planes "
        f"{list(m_ops['dt_proj']['planes_packed'].shape)}; conv, a_log, dt_bias, d_skip and "
        f"meta dense w_hat")
    toks["packed"], tps["packed"], timed, _ = serve_hymba("packed", p_packed, "B2")
    say(f"phase trace: {HYMBA_ARCH} cim-packed generate: {trace(timed)}")
    del timed
    logit_check(cfg, p_dense, p_packed, batch, "packed")
    p_int8, c6 = deploy_int8(p_dense, plan)
    add(c6)
    toks["planes_int8"], tps["planes_int8"], timed, _ = serve_hymba("planes_int8", p_int8, "B5")
    say(f"phase trace: {HYMBA_ARCH} cim-planes_int8 generate: {trace(timed)}")
    del timed
    logit_check(cfg, p_dense, p_int8, batch, "planes_int8")
    del p_int8, p_dense
    torch.cuda.empty_cache()
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase hymba-serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16, graph tok/s "
        + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; {CODEC} tokens == raw-packed tokens; token agreement with dense {agree}; peak "
        f"CUDA memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # one long prompt: swa masks at the published window, the ring roll and the ring wrap
    t0 = time.perf_counter()
    long_batch = api.make_batch(cfg, prng.PRNGKey(1), BATCH, HYMBA_LONG_PROMPT, device=dev)
    toks_long, tps_long, _, _ = serve_hymba(f"packed prompt {HYMBA_LONG_PROMPT}", p_packed,
                                            "B2", long_batch)
    served_p = steps.prepare_serving_params(p_packed, torch.bfloat16)
    seq = torch.cat([long_batch["tokens"], toks_long[:, :-1].to(long_batch["tokens"].dtype)],
                    dim=1)
    last, ref_last = hymba_decode_logits(cfg, served_p, seq, HYMBA_LONG_PROMPT)
    if not (torch.isfinite(last).all() and torch.isfinite(ref_last).all()):
        fail(f"{HYMBA_ARCH} long generate: non-finite logits")
    d = (last - ref_last).abs().max().item()
    bnd = HYMBA_LOGIT_RTOL * ref_last.abs().max().item()
    positions = cfg.n_meta_tokens + seq.shape[1]
    say(f"phase hymba-long: packed, batch {BATCH}, prompt {HYMBA_LONG_PROMPT} + "
        f"{cfg.n_meta_tokens} meta, gen {GEN}: graph {tps_long:.1f} tok/s, graph tokens == "
        f"eager tokens; the last decode step (position {positions - 1}, ring slot "
        f"{(positions - 1) % cfg.attn_window} of {cfg.attn_window}) vs forward over the "
        f"{positions} positions: max |d| {d:.4e} (bound {HYMBA_LOGIT_RTOL:g} * max|logit| = "
        f"{bnd:.4e}); {time.perf_counter() - t0:.1f} s")
    if d > bnd:
        fail(f"{HYMBA_ARCH} long generate: decode logits differ from forward by {d:.4e}")
    del served_p, p_packed, params, plan
    torch.cuda.empty_cache()
    say(f"phase hymba: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


XLSTM_ARCH = "xlstm-350m"
XLSTM_LAYERS = 8  # depth cut 24 -> 8, the only cut: seven mlstm layers and one slstm
XLSTM_LONG_PROMPT = 300  # two mLSTM chunks of 256, the second padded
XLSTM_SHORT_PROMPT = 2  # shorter than conv_width - 1 (ROADMAP C.13)
# K x N of xlstm-350m's w_if (N = 8: the kernels' non-vec branches, the narrowest N served)
# and wq (the mLSTM's inner width), at a generate's decode rows and its prefill's rows
XLSTM_SHAPES = {"w_if": (1024, 8), "wq": (2048, 2048)}
XLSTM_M = (BATCH, BATCH * PROMPT)


def decode_departure(cfg, params, tokens, prompt, extra=None) -> tuple:
    """Eager prefill of ``tokens[:, :prompt]``, merged into a zero cache,
    and teacher-forced decode steps over the rest: the largest |decode -
    forward| over every position from ``prompt - 1`` on (the prefill's
    last logits and each step's), forward's largest |logit| over the whole
    sequence, and whether both are finite.  ``extra``: the batch's
    modality inputs (``src_embeds`` or ``prefix_embeds``), given to both."""
    import torch

    from repro_torch.models import api

    extra = extra or {}
    b, total = tokens.shape
    src_len = extra["src_embeds"].shape[1] if "src_embeds" in extra else None
    with torch.inference_mode():
        full, _ = api.forward(params, cfg, {"tokens": tokens, **extra})
        logits, pf = api.prefill(params, cfg, {"tokens": tokens[:, :prompt], **extra})
        d = (logits[:, -1] - full[:, prompt - 1]).abs().max()
        cache = api.merge_prefill_cache(
            cfg, api.init_cache(cfg, b, total, device=tokens.device, src_len=src_len), pf)
        for i in range(prompt, total - 1):
            logits, cache = api.decode_step(params, cfg, cache, tokens[:, i:i + 1],
                                            torch.tensor(i, device=tokens.device))
            d = torch.maximum(d, (logits[:, 0] - full[:, i]).abs().max())
        finite = bool(torch.isfinite(full).all()) and bool(torch.isfinite(d))
    return d.item(), full.abs().max().item(), finite


def f32_logit_check(cfg, deployments: dict, batch) -> None:
    """Prefill logits of the dense, packed and planes_int8 deployments:
    packed and planes_int8 within F32_LOGIT_RTOL of dense's largest logit in
    f32, all finite.  The bf16 comparisons are printed, for the models whose
    random weights amplify one bf16 rounding past BF16_LOGIT_RTOL with the
    program right: the xLSTM some 30x (the q . k of random 512-wide heads
    cancels), seamless-m4t-medium's 24 layers (its encoder's output feeds
    every decoder layer's cross-attention), so two computations that round
    at different points, dense's bf16 w_hat against the exact w_hat, or one
    bf16 flip from a sum taken in another order, part by more."""
    import torch

    from repro_torch.models import api

    logits = {}
    with torch.inference_mode():
        for dtype_name in ("bfloat16", "float32"):
            c_ = dataclasses.replace(cfg, dtype=dtype_name)
            for name, p in deployments.items():
                lg, _ = api.prefill(p, c_, batch)
                if not torch.isfinite(lg).all():
                    fail(f"{cfg.name} non-finite {dtype_name} prefill logits of {name}")
                logits[dtype_name, name] = lg
    for dtype_name, rtol, a, b, held in (
            ("float32", F32_LOGIT_RTOL, "packed", "dense", True),
            ("float32", F32_LOGIT_RTOL, "planes_int8", "dense", True),
            ("bfloat16", BF16_LOGIT_RTOL, "planes_int8", "packed", False),
            ("bfloat16", BF16_LOGIT_RTOL, "packed", "dense", False),
            ("bfloat16", BF16_LOGIT_RTOL, "planes_int8", "dense", False)):
        want = logits[dtype_name, b]
        d = (logits[dtype_name, a] - want).abs().max().item()
        lim = rtol * want.abs().max().item()
        say(f"phase logits: {cfg.name} {dtype_name} prefill {a} vs {b} max |d| {d:.4e} (bound "
            f"{rtol:g} * max|logit| = {lim:.4e}{'' if held else ', printed'})")
        if held and d > lim:
            fail(f"{dtype_name} prefill logits of {a} and {b} differ by {d:.4e}")


def xlstm_phase(dev) -> dict:
    """xlstm-350m at its published width with the depth cut to
    XLSTM_LAYERS (seven mlstm layers and one slstm): init from the
    reference's key; a const_rle plan through one pool served raw-packed
    (B2) and const_rle (B4, tokens == raw-packed); one stateless plan served
    fp, dense, packed (B2) and planes_int8 (B6 builds, B5 serves), each
    through the serve gates: 6 CIM matmuls an mLSTM layer (w_up, wq, wk,
    wv, w_if, w_down), 2 an sLSTM layer (w, w_out) and the head a step, all
    but the f32 head on the tensor cores, no B3 and no blockwise_attention
    (the family has no attention); ``r`` and the conv taps planned and
    served dense; f32 prefill logits of packed and planes_int8 within
    dense's bound (``f32_logit_check``; bf16 printed).  Then a packed
    generate of an XLSTM_LONG_PROMPT-token prompt (two mLSTM chunks, the
    second padded) through the serve gates, and the packed decode after it
    and after an XLSTM_SHORT_PROMPT-token prompt (ROADMAP C.13) against
    forward at every decoded position: in f32 within F32_LOGIT_RTOL of
    forward's largest logit, in bf16 printed beside BF16_LOGIT_RTOL
    (``family_decode_check``).
    Returns the phase's launches."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.models import api
    from repro_torch.models.transformer import segments_of

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(XLSTM_ARCH)
    cfg = dataclasses.replace(full, n_layers=XLSTM_LAYERS)
    sc = cfg.ssm
    kinds = cfg.layer_kinds()
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    if segments_of(cfg) != [("mlstm", 7), ("slstm", 1)]:
        fail(f"{XLSTM_ARCH} x{XLSTM_LAYERS}: layer kinds {kinds}")
    di = sc.expand * cfg.d_model
    say(f"phase xlstm-plan: {XLSTM_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} mLSTM inner "
        f"{di} (head dim {di // cfg.n_heads}), sLSTM head dim {cfg.d_model // cfg.n_heads}, "
        f"conv {sc.conv_width}, chunk {sc.chunk_size}, vocab {cfg.vocab_size}, untied head; "
        f"depth cut {full.n_layers} -> {XLSTM_LAYERS} (the only cut): {n_m} mlstm + {n_s} "
        f"slstm, p_stuck={P_STUCK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {XLSTM_ARCH} x{XLSTM_LAYERS} {api.param_count(params) / 1e6:.1f}M params "
        f"from the reference's key in {time.perf_counter() - t0:.2f} s")
    spec = planner.CrossbarSpec()
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    per_step = 6 * n_m + 2 * n_s
    want, want_tc = (per_step + 1) * GEN, per_step * GEN
    say(f"phase xlstm-serve: launch formula per generate: (6 x {n_m} + 2 x {n_s} + 1) x {GEN} "
        f"= {want} CIM launches (w_up, wq, wk, wv, w_if, w_down an mLSTM layer; w, w_out an "
        f"sLSTM layer; the head), {per_step} x {GEN} = {want_tc} on the tensor cores (the f32 "
        f"head on FMA); no B3, no blockwise_attention")

    def serve_xlstm(label, p, kernel, b=batch):
        expect = {kernel: want, f"{kernel}_tc": want_tc} if kernel else {}
        out = served(f"{XLSTM_ARCH} {label}", cfg, p, b, GEN, kernel, want, expect=expect)
        add(out[3])
        return out

    def plan_timed(label, pcfg, **kw):
        plan_, c = plan_counted(label, XLSTM_ARCH, params, spec, pcfg, dev, **kw)
        add(c)
        return plan_

    toks, tps = {}, {}
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    pool_plan = plan_timed("xlstm-plan-pool", pcfg_pool, pool=xbars)
    p_raw = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    toks["raw_pool"], tps["packed (pool plan)"], _, _ = serve_xlstm("packed (pool plan)", p_raw,
                                                                   "B2")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    toks["rle"], tps[f"packed {CODEC}"], _, _ = serve_xlstm(f"packed {CODEC}", p_rle, "B4")
    if not torch.equal(toks["rle"], toks["raw_pool"]):
        fail(f"{XLSTM_ARCH} {CODEC} tokens differ from raw-packed tokens of the same plan")
    del p_raw, p_rle, pool_plan, xbars

    plan = plan_timed("xlstm-plan", planner.PlannerConfig(p_stuck=P_STUCK))
    planned = set(plan.reports)
    need = {f"segments/0/{w}" for w in ("w_up", "wq", "wk", "wv", "w_if", "w_down", "conv/w")}
    need |= {f"segments/1/{w}" for w in ("w", "r", "w_out")} | {"head/w"}
    if not need <= planned:
        fail(f"{XLSTM_ARCH}: not planned: {sorted(need - planned)}")
    toks["fp"], tps["fp"], _, _ = serve_xlstm("fp", params, None)
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    toks["dense"], tps["dense"], _, _ = serve_xlstm("dense", p_dense, None)
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    m_ops, s_ops = p_packed["segments"][0], p_packed["segments"][1]
    if not (isinstance(s_ops["r"], torch.Tensor) and isinstance(m_ops["conv"]["w"], torch.Tensor)
            and isinstance(m_ops["w_if"], dict)):
        fail(f"{XLSTM_ARCH}: r / conv not served dense, or w_if not as operands")
    say(f"phase xlstm-deploy: segments/0 operands: w_if planes "
        f"{list(m_ops['w_if']['planes_packed'].shape)}, wq planes "
        f"{list(m_ops['wq']['planes_packed'].shape)}; segments/1/r "
        f"{list(s_ops['r'].shape)} and the conv taps dense w_hat")
    toks["packed"], tps["packed"], timed, _ = serve_xlstm("packed", p_packed, "B2")
    say(f"phase trace: {XLSTM_ARCH} cim-packed generate: {trace(timed)}")
    del timed
    p_int8, c6 = deploy_int8(p_dense, plan)
    add(c6)
    toks["planes_int8"], tps["planes_int8"], timed, _ = serve_xlstm("planes_int8", p_int8, "B5")
    say(f"phase trace: {XLSTM_ARCH} cim-planes_int8 generate: {trace(timed)}")
    del timed
    f32_logit_check(cfg, {"dense": p_dense, "packed": p_packed, "planes_int8": p_int8}, batch)
    del p_int8, p_dense
    torch.cuda.empty_cache()
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase xlstm-serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy bf16, graph tok/s "
        + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; {CODEC} tokens == raw-packed tokens; token agreement with dense {agree}; peak "
        f"CUDA memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # a prompt over two mLSTM chunks (the second padded), then one shorter than the conv
    t0 = time.perf_counter()
    long_batch = api.make_batch(cfg, prng.PRNGKey(1), BATCH, XLSTM_LONG_PROMPT, device=dev)
    toks_long, tps_long, _, _ = serve_xlstm(f"packed prompt {XLSTM_LONG_PROMPT}", p_packed,
                                            "B2", long_batch)
    seq = torch.cat([long_batch["tokens"], toks_long[:, :-1].to(long_batch["tokens"].dtype)],
                    dim=1)
    short = api.make_batch(cfg, prng.PRNGKey(2), BATCH, XLSTM_SHORT_PROMPT + GEN,
                           device=dev)["tokens"]
    for label, tokens_, prompt_ in (("long", seq, XLSTM_LONG_PROMPT),
                                    ("short", short, XLSTM_SHORT_PROMPT)):
        family_decode_check(cfg, p_packed, tokens_, prompt_, None, f"xlstm-{label}")
    say(f"phase xlstm-long: graph {tps_long:.1f} tok/s at prompt {XLSTM_LONG_PROMPT}, graph "
        f"tokens == eager tokens; {time.perf_counter() - t0:.1f} s")
    del p_packed, params, plan
    torch.cuda.empty_cache()
    say(f"phase xlstm: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


SEAMLESS_ARCH = "seamless-m4t-medium"
SEAMLESS_LAYERS = 2  # depth cut 12 + 12 -> 2 + 2, the only cut (the run's time limit)
# K x N of seamless-m4t-medium's f32 LM head (N = 256206, N % 4 = 2: the FMA kernels'
# non-vec branch at the widest N served) and of its bf16 MLP projections
SEAMLESS_SHAPES = {"head": (1024, 256206), "wi_gate": (1024, 4096), "mlp/wo": (4096, 1024)}
SEAMLESS_M = (BATCH, BATCH * PROMPT)
INTERNVL2_ARCH = "internvl2-76b"
INTERNVL2_LAYERS = 1  # depth cut 80 -> 1, the only cut
INTERNVL2_PREFIX = 256  # the patch-embedding positions (stub_prefix_len) before the text
# K x N of internvl2-76b's MLP projections and its f32 LM head (1.05 G weights)
INTERNVL2_SHAPES = {"wi_gate": (8192, 28672), "mlp/wo": (28672, 8192), "head": (8192, 128256)}
INTERNVL2_M = (BATCH, BATCH * (INTERNVL2_PREFIX + PROMPT))


def seamless_phase(dev) -> dict:
    """seamless-m4t-medium (the encoder-decoder, audio frontend stubbed) at
    its published width with both stacks cut to SEAMLESS_LAYERS: init
    from the reference's key; a const_rle plan through one
    pool served raw-packed (B2) and const_rle (B4, tokens == raw-packed);
    one stateless plan served fp, dense, packed (B2) and planes_int8 (B6
    builds, B5 serves), each through the serve gates on BATCH x PROMPT
    source frames and tokens: a prefill launches src_proj, 7 CIM matmuls an
    encoder layer, 11 a decoder layer (self 4, cross 4, MLP 3) and the
    head, each decode step 9 a decoder layer (the cross K/V are cached) and
    the head; all but the f32 head's on the tensor cores; B3 = B3_tc =
    encoder (bidir) + decoder (causal) layers a prefill at D = 64, and the
    cross-attention's blockwise_attention once a decoder layer (the
    reference's direct call) the only plain call; f32 prefill logits of
    packed and planes_int8 within 1e-3 of dense's largest (bf16 printed:
    ``f32_logit_check``); the packed decode against forward at every
    decoded position (f32 held, bf16 printed).  Returns the phase's
    launches."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner, pool
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(SEAMLESS_ARCH)
    cfg = dataclasses.replace(full, n_layers=SEAMLESS_LAYERS, n_enc_layers=SEAMLESS_LAYERS)
    le, ld = cfg.n_enc_layers, cfg.n_layers
    say(f"phase seamless-plan: {SEAMLESS_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"kv={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}, untied head; depth cut {full.n_enc_layers} + "
        f"{full.n_layers} -> {le} encoder + {ld} decoder layers (the only cut), "
        f"p_stuck={P_STUCK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {SEAMLESS_ARCH} {le}+{ld} {api.param_count(params) / 1e6:.1f}M params "
        f"from the reference's key in {time.perf_counter() - t0:.2f} s")
    spec = planner.CrossbarSpec()
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    prefill_n, step_n = 1 + 7 * le + 11 * ld + 1, 9 * ld + 1
    want = prefill_n + (GEN - 1) * step_n
    want_tc = want - GEN  # the f32 head on FMA, once a step
    b3 = le + ld
    say(f"phase seamless-serve: launch formula per generate: prefill 1 + 7 x {le} + 11 x {ld} + "
        f"1 = {prefill_n} (src_proj; wq, wk, wv, wo, the MLP's 3 an encoder layer; self 4, "
        f"cross 4, MLP 3 a decoder layer; the head), each of {GEN - 1} decode steps 9 x {ld} + "
        f"1 = {step_n} (self 4, cross wq and wo, MLP 3; the head): {want} CIM launches, "
        f"{want_tc} on the tensor cores; B3 = B3_tc = {le} bidir + {ld} causal a prefill (D = "
        f"64, S = {PROMPT}); blockwise_attention {ld} a prefill (the cross-attention)")

    def serve_seamless(label, p, kernel):
        expect = {"B3": b3, "B3_tc": b3,
                  **({kernel: want, f"{kernel}_tc": want_tc} if kernel else {})}
        out = served(f"{SEAMLESS_ARCH} {label}", cfg, p, batch, GEN, kernel, want,
                     expect=expect, blockwise=ld)
        add(out[3])
        return out

    toks, tps = {}, {}
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    pool_plan, c = plan_counted("seamless-plan-pool", SEAMLESS_ARCH, params, spec, pcfg_pool,
                                dev, pool=xbars)
    add(c)
    p_raw = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    toks["raw_pool"], tps["packed (pool plan)"], _, _ = serve_seamless("packed (pool plan)",
                                                                      p_raw, "B2")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    toks["rle"], tps[f"packed {CODEC}"], _, _ = serve_seamless(f"packed {CODEC}", p_rle, "B4")
    if not torch.equal(toks["rle"], toks["raw_pool"]):
        fail(f"{SEAMLESS_ARCH} {CODEC} tokens differ from raw-packed tokens of the same plan")
    del p_raw, p_rle, pool_plan, xbars

    plan, c = plan_counted("seamless-plan", SEAMLESS_ARCH, params, spec,
                           planner.PlannerConfig(p_stuck=P_STUCK), dev)
    add(c)
    need = {"src_proj/w", "head/w"} | {f"encoder/{s_}/{w}" for s_, w in (
        ("attn", "wq"), ("attn", "wo"), ("mlp", "wi_gate"))} | {f"decoder/{s_}/{w}" for s_, w in (
            ("self", "wk"), ("cross", "wq"), ("cross", "wv"), ("mlp", "wo"))}
    if not need <= set(plan.reports):
        fail(f"{SEAMLESS_ARCH}: not planned: {sorted(need - set(plan.reports))}")
    toks["fp"], tps["fp"], _, _ = serve_seamless("fp", params, None)
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    del params
    toks["dense"], tps["dense"], _, _ = serve_seamless("dense", p_dense, None)
    p_packed = planner.deploy_params(p_dense, plan, materialize="packed")
    if not all(isinstance(w, dict) for w in (
            p_packed["src_proj"]["w"], p_packed["decoder"]["cross"]["wk"], p_packed["head"]["w"])):
        fail(f"{SEAMLESS_ARCH}: src_proj / cross / head not served as operands")
    toks["packed"], tps["packed"], timed, _ = serve_seamless("packed", p_packed, "B2")
    say(f"phase trace: {SEAMLESS_ARCH} cim-packed generate: {trace(timed)}")
    del timed
    seq = torch.cat([batch["tokens"], toks["packed"][:, :-1].to(batch["tokens"].dtype)], dim=1)
    # the source frames stay those of the prompt: the cross cache holds PROMPT frames
    family_decode_check(cfg, p_packed, seq, PROMPT, {"src_embeds": batch["src_embeds"]},
                        "seamless-decode")
    p_int8, c6 = deploy_int8(p_dense, plan)
    add(c6)
    toks["planes_int8"], tps["planes_int8"], timed, _ = serve_seamless("planes_int8", p_int8,
                                                                      "B5")
    say(f"phase trace: {SEAMLESS_ARCH} cim-planes_int8 generate: {trace(timed)}")
    del timed
    f32_logit_check(cfg, {"dense": p_dense, "packed": p_packed, "planes_int8": p_int8}, batch)
    del p_int8, p_packed, p_dense, plan
    torch.cuda.empty_cache()
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase seamless-serve: batch {BATCH}, {PROMPT} source frames, prompt {PROMPT}, gen "
        f"{GEN}, greedy bf16, graph tok/s " + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; {CODEC} tokens == raw-packed tokens; token agreement with dense {agree}; peak "
        f"CUDA memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"phase seamless: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


def internvl2_phase(dev) -> dict:
    """internvl2-76b (a dense GQA decoder behind a 256-position
    patch-embedding prefix, the InternViT frontend stubbed) at its
    published width with the depth cut to INTERNVL2_LAYERS: init from the
    reference's key; one stateless plan (the [8192, 128256] head: 1.05 G
    weights) served fp, dense, packed (B2) and planes_int8 (B6 builds, B5
    serves), each through the serve gates on a prompt of INTERNVL2_PREFIX
    prefix positions + PROMPT text tokens: (7 x layers + 1) x gen CIM
    launches, 7 x layers x gen on the tensor cores (the f32 head on FMA),
    B3 = B3_tc = layers a prefill at D = 128, no plain-version call;
    prefill logits of packed and planes_int8 within dense's bound; the
    packed decode against forward at every decoded position (f32 held,
    bf16 printed).  The pool plan and the const_rle way are left to phase
    seamless (the time limit); each deployment is freed before the next
    but dense.  Returns the phase's launches."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import planner
    from repro_torch.models import api

    t_phase = time.perf_counter()
    totals = {}

    def add(c):
        for k_, v in c.items():
            if k_ != "plain":
                totals[k_] = totals.get(k_, 0) + v

    full = get_arch(INTERNVL2_ARCH)
    cfg = dataclasses.replace(full, n_layers=INTERNVL2_LAYERS)
    if cfg.stub_prefix_len != INTERNVL2_PREFIX:
        fail(f"{INTERNVL2_ARCH}: stub_prefix_len {cfg.stub_prefix_len}")
    prompt = INTERNVL2_PREFIX + PROMPT
    say(f"phase internvl2-plan: {INTERNVL2_ARCH} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"kv={cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}, untied head, {cfg.stub_prefix_len} prefix positions; depth "
        f"cut {full.n_layers} -> {INTERNVL2_LAYERS} (the only cut), p_stuck={P_STUCK}; the pool "
        f"plan and const_rle are phase seamless's (time limit)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    say(f"phase init: {INTERNVL2_ARCH} x{INTERNVL2_LAYERS} {api.param_count(params) / 1e6:.1f}M "
        f"params from the reference's key in {time.perf_counter() - t0:.2f} s")
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, prompt, device=dev)
    want = (7 * INTERNVL2_LAYERS + 1) * GEN
    want_tc = 7 * INTERNVL2_LAYERS * GEN
    say(f"phase internvl2-serve: launch formula per generate: (7 x {INTERNVL2_LAYERS} + 1) x "
        f"{GEN} = {want} CIM launches, {want_tc} on the tensor cores (the f32 head on FMA); B3 "
        f"= B3_tc = {INTERNVL2_LAYERS} a prefill (D = 128, S = {prompt})")

    def serve_internvl2(label, p, kernel):
        out = served(f"{INTERNVL2_ARCH} {label}", cfg, p, batch, GEN, kernel, want,
                     want_tc=want_tc if kernel else 0)
        add(out[3])
        return out

    toks, tps = {}, {}
    toks["fp"], tps["fp"], _, _ = serve_internvl2("fp", params, None)
    plan, c = plan_counted("internvl2-plan", INTERNVL2_ARCH, params, planner.CrossbarSpec(),
                           planner.PlannerConfig(p_stuck=P_STUCK), dev)
    add(c)
    need = {f"segments/0/attn/{w}" for w in ("wq", "wk", "wv", "wo")} | {
        f"segments/0/mlp/{w}" for w in ("wi_gate", "wi_up", "wo")} | {"head/w"}
    if not need <= set(plan.reports):
        fail(f"{INTERNVL2_ARCH}: not planned: {sorted(need - set(plan.reports))}")
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    del params
    torch.cuda.empty_cache()
    toks["dense"], tps["dense"], _, _ = serve_internvl2("dense", p_dense, None)
    p_packed = planner.deploy_params(p_dense, plan, materialize="packed")
    toks["packed"], tps["packed"], timed, _ = serve_internvl2("packed", p_packed, "B2")
    say(f"phase trace: {INTERNVL2_ARCH} cim-packed generate: {trace(timed)}")
    del timed
    logit_check(cfg, p_dense, p_packed, batch, "packed")
    seq = torch.cat([batch["tokens"], toks["packed"][:, :-1].to(batch["tokens"].dtype)], dim=1)
    family_decode_check(cfg, p_packed, seq, prompt, {"prefix_embeds": batch["prefix_embeds"]},
                        "internvl2-decode")
    del p_packed
    torch.cuda.empty_cache()
    p_int8, c6 = deploy_int8(p_dense, plan)
    add(c6)
    toks["planes_int8"], tps["planes_int8"], timed, _ = serve_internvl2("planes_int8", p_int8,
                                                                       "B5")
    say(f"phase trace: {INTERNVL2_ARCH} cim-planes_int8 generate: {trace(timed)}")
    del timed
    logit_check(cfg, p_dense, p_int8, batch, "planes_int8")
    del p_int8, p_dense, plan
    torch.cuda.empty_cache()
    agree = {k_: (toks[k_] == toks["dense"]).float().mean().item()
             for k_ in ("fp", "packed", "planes_int8")}
    say(f"phase internvl2-serve: batch {BATCH}, prompt {INTERNVL2_PREFIX} prefix + {PROMPT} "
        f"text, gen {GEN}, greedy bf16, graph tok/s "
        + ", ".join(f"{k_} {v:.1f}" for k_, v in tps.items())
        + f"; token agreement with dense {agree}; peak CUDA memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"phase internvl2: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


DRYRUN_CELL = ("gemma-2b", "decode_32k", "single")  # arch, shape, mesh of phase dryrun
DRYRUN_LAYERS = 18  # gemma-2b's full depth: no cut
DRYRUN_ROOF = 0.95  # a step faster than this share of its roofline bound means a wrong count
DRYRUN_REPS = 20


def dryrun_count(out: dict) -> None:
    """Phase dryrun's host half, run in a thread beside the kernels' build
    (it needs no card): one device's share of DRYRUN_CELL counted on fake
    tensors (``launch.dryrun.count_cell``) into ``out``, or the traceback
    under "error".  Fake and counting modes are thread-local; the build
    runs no model code meanwhile."""
    import traceback

    try:
        from repro_torch.configs import SHAPES, get_arch
        from repro_torch.launch import dryrun

        t0 = time.perf_counter()
        arch, shape_name, mesh_kind = DRYRUN_CELL
        cfg = dataclasses.replace(get_arch(arch), n_layers=DRYRUN_LAYERS)
        shape, mesh = SHAPES[shape_name], dryrun.production_mesh(mesh_kind)
        step = dryrun.count_cell(cfg, shape, mesh)
        out.update(cfg=cfg, shape=shape, mesh=mesh, step=step,
                   rec=dryrun.cell_fields(step, cfg, shape, mesh), s=time.perf_counter() - t0)
    except Exception:  # noqa: BLE001  (phase dryrun fails with it)
        out["error"] = traceback.format_exc()


def dryrun_phase(dev, host: dict) -> None:
    """Phase dryrun: one device's share of a dry-run cell, counted on the
    host by ``dryrun_count`` (``host``), then the same share built on the
    card, its step timed and one step traced.  The inputs take the layout
    and dtypes the dry run counted (the TP plan's shard 0, f32 params as
    ``api.init`` gives them, no ``prepare_serving_params`` cast), filled by
    ``normal_`` / ``random_``: the step's time does not depend on the values.
    Gates: the counted bytes no fewer than every parameter (the embedding
    table only where the head reads it) and the whole cache read once, and
    the batched matmuls' bytes no fewer than the attention's Q.K and P.V
    (the cache read in f32, the scores written and read); the argument
    bytes the dry run counted == the rise in ``memory_allocated`` over
    materializing the inputs, within 512 bytes a tensor (the caching
    allocator's rounding); the step (median of DRYRUN_REPS, CUDA events)
    no faster than DRYRUN_ROOF x max(compute, memory) of the same count
    (one card runs no collective); no kernel of the kernels line launched
    and no plain version called (decode attention and dense matmuls are
    plain PyTorch on both paths)."""
    import torch

    from repro_torch import tree
    from repro_torch.launch import step_cost
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.parallel import collective

    t_phase = time.perf_counter()
    if "error" in host:
        fail(f"phase dryrun: the host count failed:\n{host['error']}")
    cfg, shape, mesh, step, rec = (host[k] for k in ("cfg", "shape", "mesh", "step", "rec"))
    arch, shape_name, mesh_kind = DRYRUN_CELL
    roof, mem, plan = rec["roofline"], rec["memory_analysis"], step.plan
    rows = rec["device"]["rows"]

    params, cache = step.inputs["params"], tree.leaves(step.inputs["cache"])
    # an untied embedding table is read only by the rows it gathers
    embed = 0 if cfg.tie_embeddings else step_cost.storage_bytes(
        tree.leaves(params["embed"]))
    floor = (step_cost.storage_bytes(tree.leaves(params)) - embed
             + step_cost.storage_bytes(cache))
    if roof["hbm_bytes"] < floor:
        fail(f"phase dryrun: {roof['hbm_bytes']:.6g} bytes counted, under the {floor:,} of "
             f"the parameters and the cache read once")
    scores = 4 * cfg.n_layers * rows * step.cfg.n_heads * shape.seq_len
    attn_floor = 4 * sum(t.numel() for t in cache) + 2 * scores
    bmm = step.cost.bytes_by_op.get("aten.bmm", 0)
    if bmm < attn_floor:
        fail(f"phase dryrun: the batched matmuls counted {bmm:,} bytes, under the {attn_floor:,} "
             f"of Q.K and P.V (the cache in f32, the scores written and read)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    made = {}

    def real(t):
        """The card's tensor for a fake leaf: its shape, strides and dtype,
        one per storage."""
        key = t.untyped_storage()._cdata
        if key not in made:
            x = torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype, device=dev)
            if x.is_floating_point():
                x.normal_(0.0, 0.02)
            elif x.ndim:
                x.random_(0, cfg.vocab_size)
            else:  # the decode position: the last of the cache
                x.fill_(shape.seq_len - 1)
            made[key] = x
        return made[key]

    args = tree.tree_map(real, list(step.args))
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    n_t = len(made)
    if not 0 <= rise - mem["argument_bytes"] < 512 * n_t:
        fail(f"phase dryrun: the dry run counted {mem['argument_bytes']:,} argument bytes; "
             f"materializing them on the card raised memory_allocated by {rise:,} "
             f"({n_t} tensors, 512 bytes of rounding a tensor at most)")
    gate = step_cost.CountingGate(plan.n)
    reset_counts()
    times = []
    with collective.active(gate), torch.no_grad():
        for _ in range(3):
            step.fn(*args)
        for _ in range(DRYRUN_REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step.fn(*args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        where = trace(lambda: step.fn(*args), top=5)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        fail(f"phase dryrun: the counted step launched kernels or plain versions: {launched}")
    per_step = gate.count / (4 + DRYRUN_REPS)
    if per_step != rec["collectives"]["count"]["all-reduce"]:
        fail(f"phase dryrun: {per_step} all-reduces a step on the card, "
             f"{rec['collectives']['count']['all-reduce']} counted")
    peak = torch.cuda.max_memory_allocated() - base
    ms = sorted(times)[len(times) // 2]
    bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3
    if ms < DRYRUN_ROOF * bound_ms:
        fail(f"phase dryrun: the step took {ms:.4f} ms, under {DRYRUN_ROOF} x its roofline "
             f"bound {bound_ms:.4f} ms: the count is wrong")
    del args, made
    torch.cuda.empty_cache()
    frac = bound_ms / ms
    say(f"phase dryrun: {arch} {shape_name} on the {mesh_kind} mesh {mesh.sizes}, one device's "
        f"share ({rows} rows, TP attn={plan.attn} mlp={plan.mlp}; {cfg.n_layers} layers): "
        f"counted on the host beside the build in {host['s']:.1f} s (inputs {step.init_s:.1f} s, "
        f"trace {step.cost.trace_s:.1f} s): {roof['flops']:.4g} FLOPs, {roof['hbm_bytes']:.4g} "
        f"B (floor {floor:.4g}: params and cache read once; batched matmuls {bmm:.4g}, floor "
        f"{attn_floor:.4g}), wire {roof['wire_bytes']:.4g} B; terms compute "
        f"{roof['compute_s'] * 1e3:.4f} ms, "
        f"memory {roof['memory_s'] * 1e3:.4f} ms, collective "
        f"{roof['collective_s'] * 1e3:.4f} ms; measured step {ms:.4f} ms (median of "
        f"{DRYRUN_REPS}, min {min(times):.4f}, max {max(times):.4f}): roofline fraction "
        f"{frac:.4f} (bound / measured), useful-FLOP fraction "
        f"{roof['model_flops'] / (ms * 1e-3) / PEAK_FLOPS:.3e}; argument bytes "
        f"{mem['argument_bytes']:,} counted, {rise:,} allocated ({n_t} tensors); peak "
        f"{mem['peak_bytes']:,} counted, {peak:,} max_memory_allocated over the inputs' base; "
        f"{per_step:g} all-reduces a step at the gate; one step traced: {where}; phase "
        f"{time.perf_counter() - t_phase:.1f} s on the card")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one card")
    try:
        from repro_torch import prng, tree
        from repro_torch.configs import get_arch
        from repro_torch.core import bitslice, planes, planner, pool, simulator
        from repro_torch.kernels import _util
        from repro_torch.kernels.cim_matmul import ops as cim_ops
        from repro_torch.kernels.cim_matmul import ref as cim_ref
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.hamming import ops as ham_ops
        from repro_torch.kernels.hamming import ref as ham_ref
        from repro_torch.launch.steps import CudaGraphCall
        from repro_torch.models import api
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    CudaGraphCall.keep_nodes = True  # the serve gates count each decode graph's kernel nodes

    dev = torch.device("cuda")
    _util.full_f32_matmuls()  # TF32 off: f32 results are compared, not approximated
    eps = torch.finfo(torch.float32).eps
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # --- 1. card + build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else f"{kind}, power limit not reported"
    say(card)
    t0 = time.perf_counter()
    # phase dryrun's host count needs no card: it runs while nvcc builds the kernels
    dry = {}
    count = threading.Thread(target=dryrun_count, args=(dry,), daemon=True)
    count.start()
    logs = _util.build_kernels()
    count.join()
    build_s = time.perf_counter() - t0
    say(f"phase build: {sorted(logs) or 'cached'} in {build_s:.1f} s; ptxas: {ptxas_summary(logs)}")
    SECTIONS.append(("build", build_s))
    t_built = time.perf_counter()

    # --- 2. B1 against its plain version --------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    b1_err = 0
    for t in (0, 1, 37, 4096, 1 << 20):
        a = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
        b = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
        got, want = ham_ops.price_pairs(a, b), ham_ref.hamming_pairs(a, b)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"B1 differs from its plain version at T={t}")
        if t:
            b1_err = max(b1_err, int((got - want).abs().max()))
    say("phase B1: exact at T in {0, 1, 37, 4096, 1048576}")

    # --- 3. B2, B4 and B5 against their plain versions -------------------------
    def packed_operands(k, n, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        return (bitslice.pack_linear_planes(q, 10), bitslice.pack_linear_sign(s),
                torch.tensor(0.02 / 1023, device=dev))

    def matmul_bound(x, w_abs):
        return B2_BOUND_C * eps * x.shape[-1] * (x.float().abs() @ w_abs)

    b2_err, n_checks = 0.0, 0
    cases = [(m, k, n) for k, n in ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
             for m in (1, 4, 128)] + [(5, 1001, 333), (BATCH, 4096, 64000)]  # + yi-6b's head
    for m, k, n in cases:
        planes_, signs, scale = packed_operands(k, n, m + k + n)
        w_abs = cim_ref.unpack_weights(planes_, signs, k).abs() * scale
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=g).to(dtype)
            cim_ops.reset_launches()
            got = cim_ops.cim_matmul_packed(x, planes_, signs, scale)
            path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
            if path != {"B2": 1, **({"B2_tc": 1} if dtype == torch.bfloat16 else {})}:
                fail(f"B2 {dtype} at M={m} took the wrong kernel: {path}")
            want = cim_ref.cim_matmul_packed(x, planes_, signs, scale)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if got.shape != (m, n) or not bool((err <= matmul_bound(x, w_abs)).all()):
                fail(f"B2 outside |d| <= {B2_BOUND_C}*eps*K*(|x|@|w|) at M={m} K={k} N={n} "
                     f"{dtype}: max err {err.max().item():.3e}")
            b2_err = max(b2_err, err.max().item())
            n_checks += 1
        del w_abs
    say(f"phase B2: {n_checks} cases (bf16 x on the tensor-core kernel, f32 x on the FMA "
        f"kernel) within {B2_BOUND_C}*eps*K*(|x|@|w|), max |d| {b2_err:.3e}")

    def zero_tile_operands(k, n, seed, share):
        """Packed operands whose (plane, 128-row K block) tiles are zero with
        probability ``share``, flagged by the const_rle codec."""
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        op = simulator.packed_operands(q, s, 0.02 / 1023, 0.0, 10)
        if share:
            dead = torch.rand(10, -(-k // 128), device=dev, generator=gg) < share
            rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
            op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
        return planes.encode_operands(op, "const_rle")

    def check_b4(op, m, k, ids, what, dtype=torch.bfloat16):
        """B4 == B2 bit for bit (both on the tensor-core kernel for bf16 x,
        on the FMA kernel for f32 x) and within the bound of the plain
        version."""
        x = torch.randn(m, k, device=dev, generator=g).to(dtype)
        args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
        cim_ops.reset_launches()
        b2 = cim_ops.cim_matmul_packed(*args, plane_ids=ids)
        b4 = cim_ops.cim_matmul_packed(*args, tile_nz=op["plane_tile_nz"], plane_ids=ids)
        path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
        tc = {"B2_tc": 1, "B4_tc": 1} if dtype == torch.bfloat16 else {}
        if path != {"B2": 1, "B4": 1, **tc}:
            fail(f"B2/B4 {dtype} on {what} at M={m} took the wrong kernels: {path}")
        want = cim_ref.cim_matmul_packed(*args, plane_ids=ids)
        torch.cuda.synchronize()
        if not torch.equal(b2, b4):
            fail(f"B4 differs from B2 on {what} {dtype} at M={m}: max |d| "
                 f"{(b2 - b4).abs().max().item():.3e}")
        w_abs = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k, ids).abs() * op["scale"]
        err = (b4 - want).abs()
        if not bool((err <= matmul_bound(x, w_abs)).all()):
            fail(f"B4 outside the bound of its plain version on {what} at M={m}")
        return err.max().item()

    b4_err, n4 = 0.0, 0
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(1)).to(dev, torch.int32)
    for k, n in ((2048, 16384), (16384, 2048)):
        for share in (0.0, 0.5, 0.9):
            op = zero_tile_operands(k, n, k + n + int(100 * share), share)
            for ids in (None, perm):
                for m in (1, 4, 128):
                    for dtype in (torch.bfloat16, torch.float32):
                        b4_err = max(b4_err, check_b4(op, m, k, ids,
                                                      f"{k}x{n}, {share:.0%} zero tiles", dtype))
                        n4 += 1
    say(f"phase B4: {n4} synthetic cases (K x N in {{2048x16384, 16384x2048}}, zero tiles "
        f"0/50/90%, plane_ids identity and permuted {perm.tolist()}, M in {{1, 4, 128}}, bf16 "
        f"x on the tensor-core kernels and f32 x on the FMA kernels): bit-equal to B2; max "
        f"|d| to the plain version {b4_err:.3e}")

    b5_err, n5 = 0.0, 0
    # the B2 cases, M in {16, 17, 300}, and cols 16 (weights up to 2^16 - 1)
    b5_cases = [(m, k, n, 10) for m, k, n in cases] + [
        (16, 2048, 16384, 10), (17, 2048, 2048, 10), (300, 2048, 2048, 10),
        (4, 2048, 2048, 16), (128, 2048, 16384, 16), (17, 1001, 333, 16)]
    for m, k, n, cols in b5_cases:
        gg = torch.Generator(device=dev).manual_seed(m + k + n + cols)
        q = torch.randint(0, 2**cols, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        op = simulator.int8_plane_operands(q, s, 0.02 / (2**cols - 1), 0.0, cols)
        w_abs = q.float() * op["scale"]
        del q, s
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=g).to(dtype)
            for mode in cim_ref.MODES:
                cim_ops.reset_launches()
                got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
                path = {key: v for key, v in cim_ops.LAUNCHES.items() if v}
                tc = dtype == torch.bfloat16 and mode == "fused_dequant"
                if path != {"B5": 1, **({"B5_tc": 1} if tc else {})}:
                    fail(f"B5 {mode} {dtype} at M={m} took the wrong kernel: {path}")
                want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], mode)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if got.shape != (m, n) or not bool((err <= matmul_bound(x, w_abs)).all()):
                    fail(f"B5 {mode} outside |d| <= {B2_BOUND_C}*eps*K*(|x|@|w|) at M={m} "
                         f"K={k} N={n} cols={cols} {dtype}: max err {err.max().item():.3e}")
                b5_err = max(b5_err, err.max().item())
                n5 += 1
        del op, w_abs
    say(f"phase B5: {n5} cases (both modes, f32 and bf16 x, cols 10 and 16; bf16 fused_dequant "
        f"on the tensor-core kernel) within {B2_BOUND_C}*eps*K*(|x|@|w|), max |d| {b5_err:.3e}")
    torch.cuda.empty_cache()

    mamba_err = check_cim_shapes(dev, "mamba-kernels", MAMBA_SHAPES, MAMBA_M)
    xlstm_err = check_cim_shapes(dev, "xlstm-kernels", XLSTM_SHAPES, XLSTM_M)
    seamless_err = check_cim_shapes(dev, "seamless-kernels", SEAMLESS_SHAPES, SEAMLESS_M,
                                    f32_only=("head",))
    internvl2_err = check_cim_shapes(dev, "internvl2-kernels", INTERNVL2_SHAPES, INTERNVL2_M,
                                     f32_only=("head",))
    shape_err = {k_: max(e[k_] for e in (mamba_err, xlstm_err, seamless_err, internvl2_err))
                 for k_ in ("B2", "B4", "B5")}

    b3_err, n3 = check_b3(dev)
    say(f"phase B3: {n3} cases within {fa_ref.TOL:g} (abs + rel; bf16 one ulp more; bf16 on "
        f"the tensor-core kernel, f32 on the FMA kernel), max |d| "
        f"{b3_err:.3e}")

    check_b6(dev)

    # --- 4. plan gemma-2b at full width --------------------------------------
    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    say(f"phase plan: gemma-2b d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
        f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; depth cut "
        f"{full.n_layers} -> {LAYERS} layers (the only cut), p_stuck={P_STUCK}")
    t_init = time.perf_counter()
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_init = sum(w.numel() for w in tree.leaves(params))
    say(f"phase init: gemma-2b x{LAYERS} layers {n_init / 1e6:.1f}M params from the reference's key in "
        f"{time.perf_counter() - t_init:.2f} s")
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    c = counts()
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final})")
    tot = plan.totals()
    say(f"phase plan: {len(plan.reports)} tensors in {plan_s:.2f} s; sws "
        f"{tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; B1 launches {c['B1']}")
    if c["B1"] <= 0 or c["B2"] + c["B4"] + c["B5"] != 0:
        fail(f"plan launched {c}")
    b1_plan = c["B1"]

    key = planner.tensor_keys(params, pcfg)[CHECK_TENSOR]
    w_cpu = dict(planner.iter_weights(params, pcfg))[CHECK_TENSOR].cpu()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=CHECK_TENSOR)
    same_report(plan.reports[CHECK_TENSOR], r_cpu, CHECK_TENSOR)
    if plan.deployed[CHECK_TENSOR].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of {CHECK_TENSOR} deploys other w_hat bytes")
    say(f"phase plan-cpu: {CHECK_TENSOR} planned on the CPU: report equal (quant_mse, a "
        f"float mean summed in another order, within {QUANT_MSE_RTOL:g}), w_hat bytes identical")

    # --- 4b. the same model through a persistent pool, with a plane codec -------
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    names = [n for n, _ in planner.iter_weights(params, pcfg_pool)]
    upto = names[: names.index(CHECK_TENSOR) + 1]
    snap = {}

    def progress(name):  # the pool's content once CHECK_TENSOR is programmed
        if name == (names + [None])[len(upto)]:
            snap["state"], snap["wear"] = xbars.state, xbars.wear.copy()

    reset_counts()
    t0 = time.perf_counter()
    pool_plan = planner.build_deployment(params, spec, pcfg_pool, pool=xbars, device=dev,
                                         progress=progress)
    torch.cuda.synchronize()
    pool_plan_s = time.perf_counter() - t0
    c_pool = counts()
    if "state" not in snap:
        snap["state"], snap["wear"] = xbars.state, xbars.wear.copy()
    stats = xbars.stats()
    ptot = pool_plan.totals()
    say(f"phase plan-pool: {len(pool_plan.reports)} tensors through a {xbars.n_crossbars}-crossbar "
        f"pool, codec {CODEC}, in {pool_plan_s:.2f} s; sws {ptot['sws_speedup']:.4f}x total "
        f"{ptot['total_speedup']:.4f}x; B1 launches {c_pool['B1']}")
    say(f"phase plan-pool: pool wear: max cell {stats.max_cell_writes} writes, mean "
        f"{stats.mean_cell_writes:.2f}, total {stats.total_writes} over {stats.tensors_seen} "
        f"tensors; endurance horizon ~{stats.exhaustion_horizon():.4g} such deployments @ 1e8 "
        f"writes/cell")
    if c_pool["B1"] <= 0 or c_pool["B2"] + c_pool["B4"] + c_pool["B5"] != 0:
        fail(f"pool plan launched {c_pool}")
    if stats.total_writes != sum(r.transitions_final for r in pool_plan.reports.values()):
        fail("pool wear does not sum to the programmed transitions")
    cpu_pool = pool.CrossbarPool(spec, pcfg_pool.crossbars, device="cpu")
    keys = planner.tensor_keys(params, pcfg_pool)
    weights = dict(planner.iter_weights(params, pcfg_pool))
    for name in upto:
        r_cpu, w_hat_cpu = planner.analyze_tensor(weights[name].cpu(), spec, pcfg_pool, keys[name],
                                                  name=name, pool=cpu_pool)
    same_report(pool_plan.reports[CHECK_TENSOR], r_cpu, f"{CHECK_TENSOR} (pool)")
    if pool_plan.deployed[CHECK_TENSOR].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU pool plan of {CHECK_TENSOR} deploys other w_hat bytes")
    if cpu_pool.state.tobytes() != snap["state"].tobytes() or not (cpu_pool.wear == snap["wear"]).all():
        fail(f"CPU pool after {CHECK_TENSOR} holds other state or wear than the CUDA pool")
    say(f"phase plan-pool-cpu: {CHECK_TENSOR} through a CPU pool: report equal, w_hat bytes, "
        f"pool state bytes and per-cell wear identical to the CUDA pool's")
    del weights, w_cpu

    # --- 5. serve ------------------------------------------------------------
    batch = api.make_batch(cfg, prng.PRNGKey(0), BATCH, PROMPT, device=dev)
    want_launch = 7 * LAYERS * GEN

    p_dense = planner.deploy_params(params, plan, materialize="dense")
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    tok_fp, tps_fp, _, _ = served("fp", cfg, params, batch, GEN, None, 0)
    tok_dense, tps_dense, timed_dense, _ = served("dense", cfg, p_dense, batch, GEN, None, 0)
    tok_packed, tps_packed, timed_packed, c = served("packed", cfg, p_packed, batch, GEN, "B2",
                                                     want_launch, want_tc=want_launch)
    b2_launches, b2_tc = c["B2"], c["B2_tc"]
    agree = (tok_packed == tok_dense).float().mean().item()
    say(f"phase serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy; tok/s fp "
        f"{tps_fp:.1f} cim-dense {tps_dense:.1f} cim-packed {tps_packed:.1f}; packed/dense "
        f"token agreement {agree:.3f}; B2 launches {b2_launches} (want {want_launch}), on "
        f"tensor cores {b2_tc} (want {want_launch}); B3 launches {c['B3']} (want {LAYERS}, every variant), on tensor cores {c['B3_tc']}; "
        f"plain-version calls 0")

    say(f"phase trace: cim-packed generate: {trace(timed_packed)}")
    say(f"phase trace: cim-dense generate: {trace(timed_dense)}")
    logit_check(cfg, p_dense, p_packed, batch, "packed")
    del timed_packed, timed_dense
    sampled_phase(dev, cfg, p_packed, batch, tok_packed)
    del p_packed
    torch.cuda.empty_cache()

    # int8 planes of the same plan, built by B6, served by B5
    p_int8, c6 = deploy_int8(params, plan)
    int8_gb = sum(v["splanes"].numel() for v in _operand_dicts(p_int8)) / 1e9
    tok_int8, tps_int8, timed_int8, c = served("planes_int8", cfg, p_int8, batch, GEN, "B5",
                                               want_launch, want_tc=want_launch)
    b5_launches, b5_tc = c["B5"], c["B5_tc"]
    agree_int8 = (tok_int8 == tok_dense).float().mean().item()
    say(f"phase serve-int8: cim-planes_int8 {tps_int8:.1f} tok/s ({int8_gb:.2f} GB of int8 "
        f"planes built by {c6['B6']} B6 launches, one per operand dict); token agreement with "
        f"dense {agree_int8:.3f}; B5 launches {b5_launches} (want {want_launch}), on tensor "
        f"cores {c['B5_tc']} (want {want_launch}); B3 on tensor cores {c['B3_tc']}; "
        f"plain-version calls 0")
    say(f"phase trace: cim-planes_int8 generate: {trace(timed_int8)}")
    logit_check(cfg, p_dense, p_int8, batch, "planes_int8")
    del p_int8, timed_int8, p_dense, plan
    torch.cuda.empty_cache()

    # the pool plan served raw (B2) and const_rle-encoded (B4): the same bits
    p_raw_pool = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    n_planned = 0
    for path in ("attn/wq", "attn/wk", "mlp/wi_gate", "mlp/wo"):
        a, b = path.split("/")
        op = {k: v[0] for k, v in p_rle["segments"][0][a][b].items()}
        for m in (1, 4, 128):
            b4_err = max(b4_err, check_b4(op, m, op["kdim"].shape[-2], None, f"planned {path}"))
            n_planned += 1
    check_ids_nan(dev, p_rle)
    live = sum(int(d["plane_tile_nz"].sum()) for d in _operand_dicts(p_rle))
    tiles = sum(d["plane_tile_nz"].numel() for d in _operand_dicts(p_rle))
    say(f"phase B4-planned: layer 0 wq/wk/wi_gate/wo of the {CODEC} deployment at M in "
        f"{{1, 4, 128}}: bit-equal to B2 ({n_planned} cases); live tiles {live}/{tiles} "
        f"({100 * live / tiles:.2f}%)")
    tok_raw_pool, tps_raw_pool, _, _ = served("packed (pool plan)", cfg, p_raw_pool, batch, GEN,
                                              "B2", want_launch, want_tc=want_launch)
    tok_rle, tps_rle, timed_rle, c = served(f"packed {CODEC}", cfg, p_rle, batch, GEN, "B4",
                                            want_launch, want_tc=want_launch)
    b4_launches, b4_tc = c["B4"], c["B4_tc"]
    if not torch.equal(tok_rle, tok_raw_pool):
        fail(f"{CODEC} tokens differ from raw-packed tokens of the same plan")
    say(f"phase serve-{CODEC}: pool plan served raw-packed {tps_raw_pool:.1f} tok/s and "
        f"{CODEC} {tps_rle:.1f} tok/s; tokens identical; B4 launches {b4_launches} "
        f"(want {want_launch}), on tensor cores {b4_tc} (want {want_launch}); plain-version "
        f"calls 0")
    say(f"phase trace: cim-packed-{CODEC} generate: {trace(timed_rle)}")
    del timed_rle, p_raw_pool
    # two or more weight copies (2 x 46 MB) so each timed launch finds L2 cold
    rle_ops = [{k: v[i] for k, v in p_rle["segments"][0]["mlp"][w].items()}
               for i in range(LAYERS) for w in ("wi_gate", "wi_up")]
    del p_rle, pool_plan, params
    torch.cuda.empty_cache()

    # col_perm_rle at full width, 1 layer (the host greedy bounds the depth)
    cfg1 = dataclasses.replace(full, n_layers=COLPERM_LAYERS)
    t_init = time.perf_counter()
    params1 = api.init(prng.PRNGKey(0), cfg1, device=dev)
    torch.cuda.synchronize()
    n_init = sum(w.numel() for w in tree.leaves(params1))
    say(f"phase init: gemma-2b x1 layer {n_init / 1e6:.1f}M params from the reference's key in "
        f"{time.perf_counter() - t_init:.2f} s")
    pcfg_cp = planner.PlannerConfig(p_stuck=P_STUCK, codec="col_perm_rle")
    w_ff = dict(planner.iter_weights(params1, pcfg_cp))["segments/0/mlp/wi_gate"]
    prep = planner._prep(w_ff, spec, pcfg_cp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes.plan_col_order(prep.packed_s, prep.chains, pin_cols=pcfg_cp.stuck_cols)
    col_order_s = time.perf_counter() - t0
    n_pairs = sum(len(ch) - 1 for ch in prep.chains) * 100
    say(f"phase plan_col_order: segments/0/mlp/wi_gate {list(w_ff.shape)} "
        f"({prep.packed_s.shape[0]} sections, {n_pairs} column pairs): {col_order_s:.2f} s")
    del prep
    xb1 = pool.CrossbarPool(spec, pcfg_cp.crossbars, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    plan1 = planner.build_deployment(params1, spec, pcfg_cp, pool=xb1, device=dev)
    torch.cuda.synchronize()
    plan1_s = time.perf_counter() - t0
    c1 = counts()
    t1 = plan1.totals()
    say(f"phase plan-col_perm_rle: {COLPERM_LAYERS} layer, {len(plan1.reports)} tensors in "
        f"{plan1_s:.2f} s; sws {t1['sws_speedup']:.4f}x total {t1['total_speedup']:.4f}x; "
        f"B1 launches {c1['B1']}; pool max cell {xb1.stats().max_cell_writes} writes")
    want1 = 7 * COLPERM_LAYERS * GEN
    p1_raw = planner.deploy_params(params1, plan1, materialize="packed", codec="raw")
    p1_cp = planner.deploy_params(params1, plan1, materialize="packed", codec="col_perm_rle")
    tok1_raw, _, _, _ = served("packed (1 layer)", cfg1, p1_raw, batch, GEN, "B2", want1,
                               want_tc=want1)
    tok1_cp, tps1_cp, _, c = served("packed col_perm_rle", cfg1, p1_cp, batch, GEN, "B4", want1,
                                    want_tc=want1)
    if not torch.equal(tok1_cp, tok1_raw):
        fail("col_perm_rle tokens differ from raw-packed tokens of the same plan")
    say(f"phase serve-col_perm_rle: {COLPERM_LAYERS} layer, {tps1_cp:.1f} tok/s; tokens "
        f"identical to raw-packed; B4 launches {c['B4']} (want {want1}), on tensor cores "
        f"{c['B4_tc']} (want {want1}); plain-version calls 0")
    del params1, plan1, p1_raw, p1_cp, w_ff
    torch.cuda.empty_cache()

    # --- 5a. the serving benchmark at gemma-2b's full width -----------------------
    SECTIONS.append(("checks, plan and serve", time.perf_counter() - t_built))
    timed("throughput", throughput_phase, dev)
    torch.cuda.empty_cache()

    # --- 5b. yi-6b at full width ------------------------------------------------
    yi = timed("yi", yi_phases, dev)
    torch.cuda.empty_cache()

    # --- 5c. the paper's planner figures, held to the reference ----------------
    figs = timed("figures", figures_phase, dev)

    # --- 5d. the trainer at internlm2-1.8b's full width ------------------------
    trained = timed("train", train_phase, dev)

    # --- 5e. the accuracy halves of Figs. 9/10 and accuracy_e2e ----------------
    acc = timed("accuracy", accuracy_phase, dev)

    # --- 5f. the offset_binary encoding at gemma-2b's full width ---------------
    ob = timed("offset-binary", offset_binary_phase, dev, tot)

    # --- 5g. pool wear, plane codecs and redeploy delta, held to the reference --
    bx = timed("bench-extra", bench_extra_phase, dev)

    # --- 5h. faults and integrity at gemma-2b's full width ---------------------
    fl = timed("faults", faults_phase, dev)

    # --- 5i. the continuous-batching engine at gemma-2b's full width ---------
    en = timed("engine", engine_phase, dev)
    ee = en.pop("err")

    # --- 5j. tensor-parallel replicas and the serving fleet --------------------
    tf = timed("tp-fleet", tp_fleet_phase, dev)
    te = tf.pop("err")

    # --- 5k. the MoE family: qwen2-moe-a2.7b, grouped expert launches -----------
    mo = timed("moe", moe_phase, dev)
    me, moe_rec = mo.pop("err"), mo.pop("records")

    # --- 5l. MLA: deepseek-v2-236b at published width, one layer ----------------
    ml = timed("mla", mla_phase, dev)
    mle, mla_rec, sort_rec = ml.pop("err"), ml.pop("records"), ml.pop("sort")

    # --- 5m. hymba-1.5b at published width: Mamba heads, meta tokens, ring caches ---
    hy = timed("hymba", hymba_phase, dev)

    # --- 5n. xlstm-350m at published width: mLSTM and sLSTM, no attention -----
    xl = timed("xlstm", xlstm_phase, dev)

    # --- 5o. seamless-m4t-medium at published width: the encoder-decoder ------
    se = timed("seamless", seamless_phase, dev)

    # --- 5p. internvl2-76b at published width: the modality-stub prefix ------
    iv = timed("internvl2", internvl2_phase, dev)

    # --- 5q. the dry run: one device's count held to the card ----------------
    timed("dryrun", dryrun_phase, dev, dry)

    # --- 6. kernels: time, bound, plain, library -------------------------------
    t_kernels = time.perf_counter()
    t = 1 << 20
    pairs = [tuple(torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
                   for _ in range(2))]
    b1_ms = cuda_ms(lambda: ham_ops.price_pairs(*pairs[0]))
    b1_plain = cuda_ms(lambda: ham_ref.hamming_pairs(*pairs[0]), reps=5)
    b1_bound = (2 * t * 160 + 4 * t) / HBM_BYTES_PER_S * 1e3
    say(f"phase kernels: B1 T={t}: {b1_ms:.4f} ms (bound {b1_bound:.4f}, plain {b1_plain:.4f})")
    del pairs

    def cycle(n_items):
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % n_items
            return it["i"]

        return nxt

    k, n = cfg.d_model, cfg.d_ff
    records = {}
    for label, m in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        # four weight copies (4 x 46 MB) cycled so each launch finds L2 cold,
        # as a decode step does: it reads every layer's weights once
        ops = [packed_operands(k, n, 100 + i) for i in range(4)]
        dense = [cim_ref.unpack_weights(p, s, k) * sc for p, s, sc in ops]
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        xf = x.float()
        nxt = cycle(4)
        ms = cuda_ms(lambda: cim_ops.cim_matmul_packed(x, *ops[nxt()]))
        ms_f32 = cuda_ms(lambda: cim_ops.cim_matmul_packed(xf, *ops[nxt()]))
        dev2 = device_ms(lambda: cim_ops.cim_matmul_packed(x, *ops[nxt()]))
        plain = cuda_ms(lambda: cim_ref.cim_matmul_packed(x, *ops[nxt()]), reps=5)
        library = cuda_ms(lambda: torch.matmul(xf, dense[nxt()]))
        b, by = bound(m * k * 2 + 11 * (k // 8) * n + m * n * 4, 2 * m * k * n, BF16_TC_FLOPS)
        b32, by32 = bound(m * k * 4 + 11 * (k // 8) * n + m * n * 4, 2 * m * k * n)
        records[label] = dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=b, bound_by=by)
        if label == "decode":
            # B2 with drift gains (the FMA kernel, f32 x): the gains' bytes and
            # the cols float adds a weight that rebuilding its magnitude takes
            gains = [torch.exp(0.05 * torch.randn(10, n, device=dev, generator=g))
                     for _ in range(4)]
            dense_g = [cim_ref.unpack_weights(p, s, k, None, gn) * sc
                       for (p, s, sc), gn in zip(ops, gains)]
            gain_call = lambda fn, i: fn(xf, *ops[i], plane_gain=gains[i])  # noqa: E731
            ms_g = cuda_ms(lambda: gain_call(cim_ops.cim_matmul_packed, nxt()))
            dev_g = device_ms(lambda: gain_call(cim_ops.cim_matmul_packed, nxt()))
            plain_g = cuda_ms(lambda: gain_call(cim_ref.cim_matmul_packed, nxt()), reps=5)
            library_g = cuda_ms(lambda: torch.matmul(xf, dense_g[nxt()]))
            bg, byg = bound(m * k * 4 + 11 * (k // 8) * n + 10 * n * 4 + m * n * 4,
                            2 * m * k * n + 10 * k * n)
            records[label].update(gain_ms=ms_g, gain_plain_ms=plain_g, gain_library_ms=library_g,
                                  gain_bound_ms=bg, gain_bound_by=byg)
            say(f"phase kernels: B2 with plane gains {label} M={m} K={k} N={n}, f32 x on the FMA "
                f"kernel: {ms_g:.4f} ms (device only {fmt_ms(dev_g)}; bound {bg:.4f} by {byg}); "
                f"without gains {ms_f32:.4f} ms; plain {plain_g:.4f}, torch.matmul on dense f32 "
                f"{library_g:.4f}")
            del gains, dense_g
        nwg2, splits2, _ = cim_ops.tc_packed_launch_plan(
            m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
        say(f"phase kernels: B2 {label} M={m} K={k} N={n}: bf16 x on tensor cores {ms:.4f} ms "
            f"(device only {fmt_ms(dev2)}; {nwg2} wgmma warpgroup(s), {splits2} K split(s); "
            f"bound {b:.4f} by {by}); f32 x on the FMA kernel {ms_f32:.4f} ms (bound "
            f"{b32:.4f} by {by32}); plain {plain:.4f}, torch.matmul on dense f32 {library:.4f}")

        # B4 on the const_rle deployment's wi_gate and wi_up, one copy each a layer
        nxt = cycle(len(rle_ops))

        def b4_call(op):
            return cim_ops.cim_matmul_packed(x, op["planes_packed"], op["sign_packed"], op["scale"],
                                             tile_nz=op["plane_tile_nz"])

        ms4 = cuda_ms(lambda: b4_call(rle_ops[nxt()]))
        ms2 = cuda_ms(lambda: cim_ops.cim_matmul_packed(
            x, *(rle_ops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))))
        plain4 = cuda_ms(lambda: cim_ref.cim_matmul_packed(
            x, *(rle_ops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))), reps=5)
        dense4 = [simulator.densify_operands(op) for op in rle_ops]
        library4 = cuda_ms(lambda: torch.matmul(xf, dense4[nxt()]))
        payload = planes.operand_payload_bytes(rle_ops[0])["total_bytes"]
        b, by = bound(m * k * 2 + payload + m * n * 4, 2 * m * k * n, BF16_TC_FLOPS)
        records[f"B4 {label}"] = dict(ms=ms4, plain_ms=plain4, library_ms=library4, bound_ms=b,
                                      bound_by=by)
        say(f"phase kernels: B4 {label} M={m} on the {CODEC} wi_gate / wi_up operands (all tiles "
            f"live): {ms4:.4f} ms, B2 on the same {ms2:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain4:.4f}, torch.matmul {library4:.4f})")
        del ops, dense, dense4

        # B4 against B2 as the share of zero tiles grows
        sweep = []
        for share in ZERO_SHARES:
            zops = [zero_tile_operands(k, n, 200 + i, share) for i in range(4)]
            nxt = cycle(4)
            z4 = cuda_ms(lambda: b4_call(zops[nxt()]))
            z2 = cuda_ms(lambda: cim_ops.cim_matmul_packed(
                x, *(zops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))))
            live_share = float(zops[0]["plane_tile_nz"].float().mean())
            zb, _ = bound(m * k * 2 + planes.operand_payload_bytes(zops[0])["total_bytes"]
                          + m * n * 4, 2 * m * k * n, BF16_TC_FLOPS)
            sweep.append(f"{share:.0%}: B4 {z4:.4f} / B2 {z2:.4f} ms (live {live_share:.1%}, "
                         f"bound {zb:.4f})")
            del zops
        say(f"phase kernels: B4 vs B2 {label} M={m} by zero-tile share: " + "; ".join(sweep))

        # B5, both modes, on four int8-plane copies
        i8 = []
        for i in range(4):
            gg = torch.Generator(device=dev).manual_seed(300 + i)
            q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
            s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
            i8.append(simulator.int8_plane_operands(q, s, 0.02 / 1023, 0.0, 10))
            i8[-1]["dense"] = q.float() * s.float() * i8[-1]["scale"]
            del q, s
        nxt = cycle(4)
        ms5 = {mode: cuda_ms(lambda: cim_ops.cim_matmul(
            x, i8[nxt()]["splanes"], i8[0]["scale"], mode=mode)) for mode in cim_ref.MODES}
        ms5_f32 = cuda_ms(lambda: cim_ops.cim_matmul(xf, i8[nxt()]["splanes"], i8[0]["scale"]))
        plain5 = cuda_ms(lambda: cim_ref.cim_matmul(x, i8[nxt()]["splanes"], i8[0]["scale"]),
                         reps=3)
        library5 = cuda_ms(lambda: torch.matmul(xf, i8[nxt()]["dense"]))
        b, by = bound(m * k * 2 + 10 * k * n + m * n * 4, 2 * m * k * n, BF16_TC_FLOPS)
        b32, by32 = bound(m * k * 4 + 10 * k * n + m * n * 4, 2 * m * k * n)
        records[f"B5 {label}"] = dict(ms=ms5["fused_dequant"], plain_ms=plain5,
                                      library_ms=library5, bound_ms=b, bound_by=by)
        dev5 = device_ms(lambda: cim_ops.cim_matmul(x, i8[nxt()]["splanes"], i8[0]["scale"]))
        nwg, splits5, _ = cim_ops.tc_launch_plan(m, k, n, 10, torch.cuda.get_device_properties(
            0).multi_processor_count)
        say(f"phase kernels: B5 {label} tensor-core plan: {nwg} wgmma warpgroup(s), {splits5} "
            f"K split(s)")
        say(f"phase kernels: B5 {label} M={m} K={k} N={n}: fused_dequant bf16 x on tensor cores "
            f"{ms5['fused_dequant']:.4f} ms (device only {fmt_ms(dev5)}; bound {b:.4f} by {by}); "
            f"f32 x on the FMA kernel "
            f"{ms5_f32:.4f} ms (bound {b32:.4f} by {by32}); planes bf16 x (FMA) "
            f"{ms5['planes']:.4f} ms; plain {plain5:.4f}, torch.matmul on dense f32 "
            f"{library5:.4f}")
        del i8
        torch.cuda.empty_cache()

    rec_b3, rec_b6 = time_attention(dev), time_bitslice(dev)

    def row(name, source, replaces, launches, err, rec, launches_tc=None, grouped=None):
        """One kernel's record; ``launches_tc``: how many of the main path's
        launches took its tensor-core kernel (where it has one); ``grouped``:
        the kernel's name in the MoE phase, whose grouped launches (bf16 x,
        G 64, M in MOE_M, qwen's wi_gate shape) add their times."""
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        if launches_tc is not None:
            r["launches_tc"] = launches_tc
        if grouped is not None:
            keys = ("ms", "single_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
            r["launches_moe"] = mo.get(grouped, 0)
            for m in MOE_M:
                r[f"grouped_m{m}"] = {k_: moe_rec[f"{grouped} M={m}"][k_] for k_ in keys}
            r["launches_mla"] = ml.get(grouped, 0)
            for m in MLA_M:
                r[f"grouped_g160_m{m}"] = {k_: mla_rec[f"{grouped} M={m}"][k_] for k_ in keys}
        return r

    def phase_launches(kernel):
        """The family phases' own launches of ``kernel`` (each also in the total)."""
        return {f"launches_{name}": ph.get(kernel, 0)
                for name, ph in (("xlstm", xl), ("seamless", se), ("internvl2", iv))}

    def shape_cases(kernel):
        """The cases and max |d| of ``kernel``'s checks at the families' shapes."""
        return {f"{name}_shapes": {"cases": e["cases"], "max_abs_err": e[kernel]}
                for name, e in (("xlstm", xlstm_err), ("seamless", seamless_err),
                                ("internvl2", internvl2_err))}

    kernels = [
        {**row("hamming_pairs", "src/repro_torch/csrc/hamming.cu",
            "src/repro/kernels/hamming/kernel.py:32",
            b1_plan + figs["B1"] + trained["B1"] + acc["B1"] + ob["B1"] + bx["B1"] + fl["B1"]
            + en.get("B1", 0) + tf.get("B1", 0) + mo.get("B1", 0) + ml.get("B1", 0)
            + hy.get("B1", 0) + xl.get("B1", 0) + se.get("B1", 0) + iv.get("B1", 0), b1_err,
            dict(ms=b1_ms, plain_ms=b1_plain, bound_ms=b1_bound, bound_by="bytes",
                 library_ms=None)),
         **phase_launches("B1")},
        {**row("cim_matmul_packed", "src/repro_torch/csrc/cim_matmul.cu",
               "src/repro/kernels/cim_matmul/kernel.py:242",
               b2_launches + ob["B2"] + bx["B2"] + fl["B2"] + en.get("B2", 0) + tf.get("B2", 0)
               + mo.get("B2", 0) + ml.get("B2", 0) + hy.get("B2", 0) + xl.get("B2", 0)
               + se.get("B2", 0) + iv.get("B2", 0),
               max(b2_err, ee["B2"], te["B2"], me["B2"], mle["B2"], shape_err["B2"]),
               records["decode"],
               b2_tc + ob["B2_tc"] + bx["B2_tc"] + fl["B2_tc"] + en.get("B2_tc", 0)
               + tf.get("B2_tc", 0) + mo.get("B2_tc", 0) + ml.get("B2_tc", 0)
               + hy.get("B2_tc", 0) + xl.get("B2_tc", 0) + se.get("B2_tc", 0)
               + iv.get("B2_tc", 0), grouped="B2"),
         "launches_hymba": hy.get("B2", 0), **phase_launches("B2"), **shape_cases("B2"),
         "launches_gain": fl["B2_gain"],
         **{k: v for k, v in records["decode"].items() if k.startswith("gain_")}},
        {**row("cim_matmul_packed_skip", "src/repro_torch/csrc/cim_matmul.cu",
            "src/repro/kernels/cim_matmul/kernel.py:193",
            b4_launches + ob["B4"] + bx["B4"] + en.get("B4", 0) + tf.get("B4", 0)
            + mo.get("B4", 0) + ml.get("B4", 0) + hy.get("B4", 0) + xl.get("B4", 0)
            + se.get("B4", 0) + iv.get("B4", 0),
            max(b4_err, ee["B4"], te["B4"], me["B4"], mle["B4"], shape_err["B4"]),
            records["B4 decode"],
            b4_tc + ob["B4_tc"] + bx["B4_tc"] + en.get("B4_tc", 0) + tf.get("B4_tc", 0)
            + mo.get("B4_tc", 0) + ml.get("B4_tc", 0) + hy.get("B4_tc", 0)
            + xl.get("B4_tc", 0) + se.get("B4_tc", 0) + iv.get("B4_tc", 0), grouped="B4"),
         **phase_launches("B4"), **shape_cases("B4")},
        {**row("cim_matmul_planes", "src/repro_torch/csrc/cim_planes.cu",
            "src/repro/kernels/cim_matmul/kernel.py:74",
            b5_launches + ob["B5"] + fl["B5"] + en.get("B5", 0) + tf.get("B5", 0)
            + mo.get("B5", 0) + ml.get("B5", 0) + hy.get("B5", 0) + xl.get("B5", 0)
            + se.get("B5", 0) + iv.get("B5", 0),
            max(b5_err, ee["B5"], te["B5"], me["B5"], mle["B5"], shape_err["B5"]),
            records["B5 decode"],
            b5_tc + ob["B5_tc"] + fl["B5_tc"] + en.get("B5_tc", 0) + tf.get("B5_tc", 0)
            + mo.get("B5_tc", 0) + ml.get("B5_tc", 0) + hy.get("B5_tc", 0)
            + xl.get("B5_tc", 0) + se.get("B5_tc", 0) + iv.get("B5_tc", 0), grouped="B5"),
         **phase_launches("B5"), **shape_cases("B5")},
        {**row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:109",
               yi["B3"] + acc["B3"] + ob["B3"] + bx["B3"] + fl["B3"] + en.get("B3", 0)
               + tf.get("B3", 0) + mo.get("B3", 0) + hy.get("B3", 0) + xl.get("B3", 0)
               + se.get("B3", 0) + iv.get("B3", 0),
               max(b3_err, ee["B3"], te["B3"]), rec_b3,
               yi["B3_tc"] + ob["B3_tc"] + bx["B3_tc"] + fl["B3_tc"] + en.get("B3_tc", 0)
               + tf.get("B3_tc", 0) + mo.get("B3_tc", 0) + hy.get("B3_tc", 0)
               + se.get("B3_tc", 0) + iv.get("B3_tc", 0)),
         "launches_hymba": hy.get("B3", 0), "launches_hymba_tc": hy.get("B3_tc", 0),
         **phase_launches("B3"), "launches_seamless_tc": se.get("B3_tc", 0),
         "d64_serve": rec_b3["d64_serve"], "d64_2048": rec_b3["d64_2048"]},
        {**row("bitslice", "src/repro_torch/csrc/bitslice.cu",
            "src/repro/kernels/bitslice/kernel.py:35",
            yi["B6"] + ob["B6"] + fl["B6"] + en.get("B6", 0) + tf.get("B6", 0) + mo.get("B6", 0)
            + ml.get("B6", 0) + hy.get("B6", 0) + xl.get("B6", 0) + se.get("B6", 0)
            + iv.get("B6", 0), 0.0, rec_b6),
         **phase_launches("B6")},
        # a planner helper, not a TPU kernel: the reference sorts on the host; its launches
        # are phase mla's plans' (the other phases' plans launch it too, uncounted)
        row("sws_sort", "src/repro_torch/csrc/sws_sort.cu",
            "none (planner helper; the reference sorts on the host, src/repro/core/sws.py:113)",
            ml["SORT"], 0.0, sort_rec),
    ]
    say("kernels: " + ", ".join(
        f"{r['name']} launches={r['launches']}"
        + (f" launches_tc={r['launches_tc']}" if "launches_tc" in r else "")
        + (f" launches_gain={r['launches_gain']} gain_ms={r['gain_ms']:.4f}"
           f" gain_bound_ms={r['gain_bound_ms']:.4f}" if "launches_gain" in r else "")
        + (f" launches_moe={r['launches_moe']}" + "".join(
            f" grouped_m{m}_ms={r[f'grouped_m{m}']['ms']:.4f}"
            f" (64 singles {r[f'grouped_m{m}']['single_ms']:.4f},"
            f" bmm {r[f'grouped_m{m}']['library_ms']:.4f},"
            f" bound {r[f'grouped_m{m}']['bound_ms']:.4f})" for m in MOE_M)
           + f" launches_mla={r['launches_mla']}" + "".join(
            f" grouped_g160_m{m}_ms={r[f'grouped_g160_m{m}']['ms']:.4f}"
            f" (160 singles {r[f'grouped_g160_m{m}']['single_ms']:.4f},"
            f" bmm {r[f'grouped_g160_m{m}']['library_ms']:.4f},"
            f" bound {r[f'grouped_g160_m{m}']['bound_ms']:.4f})" for m in MLA_M)
           if "launches_moe" in r else "")
        + "".join(f" {k_}_ms={r[k_]['ms']:.4f} (bound {r[k_]['bound_ms']:.4f},"
                  f" SDPA {r[k_]['library_ms']:.4f})" for k_ in ("d64_serve", "d64_2048")
                  if k_ in r)
        + (f" launches_hymba={r['launches_hymba']}" if "launches_hymba" in r else "")
        + "".join(f" launches_{f}={r[f'launches_{f}']}" for f in ("xlstm", "seamless", "internvl2")
                  if f"launches_{f}" in r)
        + "".join(f" {f}_shapes={r[f'{f}_shapes']['cases']} cases max_abs_err="
                  f"{r[f'{f}_shapes']['max_abs_err']:.3e}" for f in ("xlstm", "seamless", "internvl2")
                  if f"{f}_shapes" in r)
        + f" max_abs_err={r['max_abs_err']:.3e} "
        f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f}"
        + (f" library_ms={r['library_ms']:.4f}" if r["library_ms"] is not None else "")
        for r in kernels))
    say(f"launch counting: every serve gate held the graph's launches from its node list "
        f"({NODE_LIST['graphs']} graphs, {NODE_LIST['nodes']} nodes, read in "
        f"{NODE_LIST['s']:.2f} s); " + ("; ".join(COUNT_NOTES) or "the profiler recorded "
                                         "each of them"))
    SECTIONS.append(("kernels", time.perf_counter() - t_kernels))
    say(f"phase done: {time.perf_counter() - t_start:.1f} s after the build started ("
        + ", ".join(f"{name} {sec:.1f} s" for name, sec in SECTIONS) + ")")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def ab_time(root: Path) -> None:
    """One turn of ``--ab``: time the port of the tree at ``root`` and
    print one JSON line.  B2 bf16 decode (M = 4) at gemma-2b's wi_gate over
    4 cycled operand copies, B6 at cols 10 on the B6_TIMED shapes, and three
    walls of a yi-6b (YI_LAYERS layers) planes_int8 deployment of one plan."""
    sys.path.insert(0, str(root / "src"))  # ahead of this tree's port
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.core import bitslice, planner
    from repro_torch.kernels import _util
    from repro_torch.kernels.bitslice import ops as bs_ops
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.models import api

    dev = torch.device("cuda")
    _util.full_f32_matmuls()
    _util.build_kernels(("cim_matmul", "bitslice"))
    rec = {"root": str(root)}
    k, n = 2048, 16384
    ops = []
    for i in range(4):
        gg = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        ops.append((bitslice.pack_linear_planes(q, 10), bitslice.pack_linear_sign(s),
                    torch.tensor(0.02 / 1023, device=dev)))
    x = torch.randn(BATCH, k, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    x = x.to(torch.bfloat16)
    it = {"i": 0}

    def b2():
        it["i"] = (it["i"] + 1) % 4
        return cim_ops.cim_matmul_packed(x, *ops[it["i"]])

    rec["b2_decode_ms"] = [cuda_ms(b2, reps=50) for _ in range(3)]
    del ops
    for shape in B6_TIMED:
        g = torch.Generator(device=dev).manual_seed(11)
        w = torch.randn(shape, device=dev, generator=g) * 0.05
        inv = torch.tensor(4096.0, device=dev)
        rec[f"b6_ms {list(shape)}"] = cuda_ms(lambda: bs_ops.bitslice_planes(w, inv, 10), reps=10)
        del w
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=YI_LAYERS)
    params = api.init(prng.PRNGKey(0), cfg, device=dev)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(p_stuck=P_STUCK), device=dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_int8 = planner.deploy_params(params, plan, materialize="planes_int8")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        del p_int8
        torch.cuda.empty_cache()
    rec["yi_deploy_int8_wall_ms"] = walls
    print(json.dumps(rec), flush=True)


def ab(other: Path) -> None:
    """Turns OTHER, this, this, OTHER of ``ab_time``, one process each, on
    this card; prints each turn's JSON line and the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    say(smi or "card not reported")
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--ab-time",
                            str(Path(root).resolve())], capture_output=True, text=True,
                           check=False)
        if r.returncode != 0:
            say(r.stdout[-4000:] + r.stderr[-4000:])
            fail(f"--ab-time {root} exited with {r.returncode}")
        say(r.stdout.strip().splitlines()[-1])


def _operand_dicts(tree):
    """Every crossbar operand dict of a params tree."""
    if isinstance(tree, dict):
        if "planes_packed" in tree or "splanes" in tree:
            yield tree
            return
        for v in tree.values():
            yield from _operand_dicts(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _operand_dicts(v)


if __name__ == "__main__":
    if "--ab-time" in sys.argv[:-1]:
        ab_time(Path(sys.argv[sys.argv.index("--ab-time") + 1]).resolve())
    elif "--ab" in sys.argv[:-1]:
        ab(Path(sys.argv[sys.argv.index("--ab") + 1]))
    else:
        main()
