#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (all nine
sources compiled together) and drives its main paths: QAT training of
minicpm-2b at full width through kernel row 6, with checkpoints and a
resume; minicpm-2b at its
full width and depth (40 layers, packed and fused, prototype macro),
and the dense family's qwen3-14b, starcoder2-7b and gemma2-9b, the moe
family's qwen2-moe-a2.7b (arctic-480b at smoke size), the vlm family's
paligemma-3b and the audio family's musicgen-medium at theirs,
served lock-step and with continuous batching over a contiguous and a
paged KV cache, and on its raw weights through the unpacked macro
GEMM; the SSM family's mamba2-130m at its full width and depth, served
the same ways; the deployment planner over forwards of those raw
weights; the
complex-MAC lane behind MUSIC direction-of-arrival estimation on 64-
and 32-element arrays, noise-free and with the macro's analog noise
(the figS3 twin); and the kernel bench, Fig. 6 and figure twins with
the W8A8 all-digital baseline and the bit-true macro model, its
comparator noise drawn as the reference draws it.
Each phase prints one JSON line; the script exits non-zero at the first
failure.  Phases:

  1. device: the card's name and power limit, and the kernel build time;
  2. macro-GEMM kernels vs their plain PyTorch version at minicpm-2b's
     full-width (K, N) shapes, int32 outputs compared with torch.equal;
  3. the same over every design point (n_dcim 0-6 x ADC 7/8/9 b x
     acc_len 8/16/32/64) on a ragged shape, plus analog-subset serving of
     a hybrid pack;
  4. lock-step serve (batch 4, prompt 32, 16 tokens) through the kernels,
     with the launch counts that show every macro GEMM went through them;
  5. the same serve through the plain version on the same weights:
     tokens and last logits must be identical;
  6. a torch.profiler trace of one lock-step decode step: step wall
     time, device busy time and the kernels that take it;
  7. per-kernel times of the macro GEMMs at the full-width shapes:
     CUDA events around one call (``ms``) and device time from CUDA-graph
     replays (``device_ms``), beside the plain version, torch._int_mm (a
     labelled yardstick that computes a different function, also timed
     both ways) and the bound from bytes and operations; for the skinny
     kernel at M 1, 4, 8, 16 and 32, with cold device time
     (``device_cold_ms``: replays rotating over distinct weight copies,
     1 GB per layer, so that no call finds its weights in L2); for the
     general kernel its K splits per shape, a data-sheet estimate of the
     integer-op floor of its per-chunk conversions (4 int32 ops each, and
     the activation bit-planes, on 64 int32 lanes per SM at the max SM
     clock; not a measurement, and not the kernels line's bound), and a
     sweep of its device time per layer over acc_len and the number of
     DCIM planes, which changes the integer work and the MMA count but
     not the shapes;
  8. the paged-attention kernel vs its plain version at the minicpm-2b
     decode shape and over a sweep of group size, head dim, block size,
     softcap and sliding window, and on long walks that the kernel
     splits (minicpm-2b's shape at 256 table entries, GQA at Dh 128,
     lengths on split boundaries, window 7 leaving later splits idle);
  9. continuous batching, contiguous KV: 10 mixed-length requests over 8
     slots; pool tokens must equal the lock-step wave baseline's, and no
     paged-attention kernel may launch;
 10. the first 4 of those requests with a paged KV cache (block 16,
     prefill chunks of 32): 40 paged-attention launches per decode step;
     how many requests' tokens equal phase 9's is reported, not gated
     (the kernel's float32 P.V can move a bf16 activation by one ulp,
     and in CIM mode an ADC code with it);
 11. paged serving of 10 requests, half behind one shared 32-token
     prefix: refcounts must drain, the prefix plan must share blocks, and
     pool tokens must equal solo runs of 2 of the requests;
 12. phase 11 with the plain version of the paged read on the card: token
     agreement with phase 11 and the first decode step's logits, and a
     torch.profiler trace of one paged decode step (device busy, idle
     share, the paged read's device time per step);
 13. times of the paged-attention kernel at the minicpm-2b decode shape
     for lengths 32-4096 (per call and device time, as phase 7, and cold:
     replays over distinct KV pools), beside the plain version, a gather +
     scaled_dot_product_attention yardstick (same pool and cold) and the
     byte bound, and cold device time over the split count at long walks;
     and at head dim 256, gemma2-9b's heads (16 over 8, softcap 50, a
     4,096 window) and paligemma-3b's (8 over 1) at lengths 96 and 1,024:
     kernel == plain to the tolerance, one launch counted a call, per
     call, same-pool and cold device time, the byte bound, and the gather
     + SDPA yardstick (without the softcap and window: another function);
     head dim 256 runs its own kernel (``paged_attn_dh256.cu``), a row
     of its own in the kernels line;
 14. the fused complex kernels (prepacked skinny and general, unpacked)
     vs their plain versions with torch.equal at the full-width shapes,
     on ragged shapes and at the DoA shapes; off the prototype design
     point the complex path launches the real prepacked kernels four
     times per call and no complex kernel;
 15. the unpacked real kernel vs its plain version with torch.equal at
     the full-width shapes (M 1-512, 129 included) and on ragged shapes,
     one launch per ``ccim_matmul_int`` call, and ``cim_matmul`` on raw
     weights (one launch each) equal to ``cim_matmul`` on their pack;
 16. MUSIC DoA, 32 seeded frames each on a 64-element ULA (4 sources,
     4,096 snapshots) and a 32-element ULA (2 sources, 1,024 snapshots),
     0.05 degree grid: one unpacked and one prepacked complex launch per
     frame and no real-kernel launch; the plain versions on the card give
     the same covariance ints and estimates; RMSE under 4 % of the field
     of view; frames/s, the kernels' share of a frame, and the covariance
     kernel's device time and K split;
 17. times of kernels 4-7 at the full-width shapes (M 4 and 128; per
     call and device time, as phase 7) beside their plain versions, the
     four-pass route through the port's real kernels (per call and, for
     the complex kernels, device time), a library yardstick and the
     bound;
 18. the W8A8 kernel vs its plain version, float32 outputs with
     torch.equal, bf16 and f32 inputs, at the full-width shapes (M 1, 4,
     32, 128, 256, 512) and ragged M, K, N: exactly one launch per
     ``int8_matmul`` call and none from the plain run;
 19. the kernel bench twin (``launch/kernel_bench.py --scale card``):
     every row's parity assert and the 1.05x decode floor (its two
     routes replayed from CUDA graphs, as the reference jits them), with
     the launches of every kernel it drives; its two noisy rows (bit-true
     and fast on the reference's operands, die and key) with their
     errors and times;
 20. the Fig. 6 twin at 1,048,576 conversions on the card (peak memory
     under 8 GB; the reference's keyed operands and dies), and the same
     seed on the CPU over the first 65,536 of them: this work's (the
     comparator noise), this die's, the floor's and all-analog's y8
     codes compared (0 may differ: the draws and the bit-true sum run
     the same operations on both); the
     first 16,384 conversions, the reference's run, give its 0.408 /
     0.226 / 0.339 % and equal a CPU run of that size; CUDA-event times
     of the bit-true model at 2^20 with and without the noise;
 21. times of the W8A8 kernel per layer (the four full-width GEMMs) at M
     4 and 128: CUDA-event time per call (``ms``, host wrapper included,
     as every row is timed), device time from CUDA-graph replays on one
     operand set (``device_ms``) and cold (``device_cold_ms``, replays
     over distinct weight copies), beside its plain version,
     torch._int_mm with the two dequant multiplies (a yardstick, at M >=
     32, same-operand and cold) and the bound; the plan of each shape
     (token width, tiles, K splits = cluster size, ring depth) and a
     sweep of cold device time over token width, split count and ring
     depth;
 22. full-width minicpm-2b under a mixed deployment plan (wq all-analog
     with an 8-bit ADC, wk+wv, w1 and the default hybrid3 / 8 b / L32,
     wo hybrid5 / 8 b, w2 all-digital, w3 float), lock-step batch 4,
     prompt 32, 16 tokens, through the kernels and through their plain
     versions: tokens and last logits equal, one general launch per
     packed fast site a layer in prefill and one skinny one a decode step
     (4 a layer), none from the plain run; pack bytes and peak memory
     beside the uniform pack's (phase 4);
 23. plan-cascade speculative decoding at full width, drafting under the
     prototype's all-analog shadow (8-bit ADC): batch 2, prompt 16, 24
     tokens, k 8 (verify M 18 on kernel row 1) and batch 4, 12 tokens, k
     8 (M 36 on row 2); kernel and plain speculative tokens equal,
     speculative tokens equal lock-step ones (with the count of equal
     rows, the first differing (row, position) and the logits' largest
     difference if they do not), launches per round; acceptance, rounds
     and decode tok/s of speculative and lock-step serving in one turn
     each (the second turn and the profile of one round were cut to make
     room for phases 36-37);
 24. continuous batching with speculative rounds (k 4, adaptive depth):
     phase 9's first 10 requests over 8 slots, contiguous, pool tokens equal
     phase 9's and the lock-step waves'; then 4 of them paged as in phase
     10, with the paged read launched 40 times a draft step and the token
     agreement with phase 10 reported;
 25. phase 4's serve eager and with its decode step replayed from a CUDA
     graph, in turns (eager, captured): every turn's
     tokens, last logits and launches equal phase 4's; decode tok/s,
     replayed-step tok/s, capture seconds, graph pool bytes and peak
     memory; a torch.profiler trace of one eager and one replayed
     step of one decode body (``device_breakdown``), in which each
     replay ran as many of each serving kernel as the graph credits;
 26. phase 23's two speculative cases with the round captured, against
     captured lock-step serving, one turn each: speculative tokens equal
     lock-step ones, launches as phase 23 counts them per round; a
     replayed round of each case traced (the model's first 2 layers),
     kernels equal to the credit;
 27. the scheduler with its step branch captured (one graph for the
     pooled step, one per rung of the speculative ladder) on phase 9's
     first 4 prompts at a quarter of their stop lengths: contiguous, phase 24's
     speculative queue and phase 10's paged queue, against the eager
     scheduler, one turn each: pool tokens, iterations by branch and
     launches equal the eager run's; tok/s, ms per branch and each
     branch's share of the wall time; one replay of each graph traced,
     kernels equal to the credit;
 28. ``core/prng.py`` (threefry2x32, ``jax.random``'s streams) on the
     card against the CPU port at 2^21 draws: keys (single and batched
     splits, fold_in), bits, uniforms and a per-row categorical bit for
     bit (16 rows over the vocabulary); normals and Gumbels compared
     element by element (count and largest difference reported) with
     mean and variance within five standard errors; device time of one
     normal((4, 11520, 144)) draw (a decode step's fused w1/w3 noise at
     batch 4) and one (128, 11520, 144) draw;
 29. phase 4's lock-step serve at temperature 0.7 (the first token
     sampled too): kernels and plain version give equal tokens and last
     logits, launches equal phase 4's, eager and captured in turns (equal
     bit for bit; tok/s of each), and tokens that differ from phase 4's
     greedy ones;
 30. the scheduler at temperature 0.7 on phase 9's first 4 prompts at
     a quarter of their stop lengths, through the kernels: the contiguous
     pool
     captured equals it eager and equals a solo run of its first
     request; a speculative pool at k 4 (fixed depth) equals a
     speculative solo run, acceptance reported; the paged pool's
     agreement with the contiguous one reported, not gated (as phase
     10);
 31. lock-step serve with the macro's analog noise (noise seed 0, batch
     2, a one-token prompt, 3 tokens), eager and captured: equal tokens
     and logits,
     logits that differ from the noise-free run's, no launch of kernel
     rows 1 and 2 (noisy GEMMs take the chunked GEMM in torch, as the
     reference's leave its kernels); prefill and decode time, peak
     memory, and a profile of one eager noisy decode step of the model
     cut to its first 2 layers (its noise draws' device and host time);
 32. MUSIC DoA with the macro's analog noise: keyed dies on the card
     equal the CPU's; the figS3 twin (12 trials of the reference's
     8-element array, noise keys PRNGKey(t)) on the card equals its CPU
     run trial by trial (covariance ints, spectra, estimates) under the
     4 % bound; 32 noisy frames each of ``ula32`` and ``ula64``: RMSE
     under 4 % of the field of view, frames/s, and no launch of any
     kernel (noisy GEMMs run in torch, as the reference's leave its
     Pallas kernels);
 33. phase 4's serve (captured) on the raw weights, quantized at every
     call (``serve(pack=False)``): kernel row 6 carries every macro GEMM
     (160 launches a forward, credited per replay; rows 1 and 2 none),
     tokens and last logits equal phase 4's through the kernel and
     through its plain version; packed and unpacked, one turn each
     (decode tok/s, peak memory); the captured step's kernel nodes by name;
     phase 22's mixed plan unpacked (packed per call onto rows 1 and 2)
     equal to phase 22's tokens;
 34. the deployment planner at full width on the raw weights: the
     noise-free profile of all seven sites under three candidates
     (digital, the prototype on row 6, hybrid3 / 8 b / L32 on row 1)
     and the Pareto search at budget 1.0 and 0.6, through the kernels
     and through their plain versions, equal; the plan_pareto twin at
     card scale (its four points, the domination gate, decode tok/s of
     three plans served packed) and its mamba2-130m arch at smoke; one
     forward on the profiler's noise seed (no kernel), timed,
     repeatable;
 35. the figure twins (figS2 at 4 multipliers x 8 dies x 2,048
     conversions with its all-analog rows, fig5, figS1, fig2) on the
     card equal to the CPU port, row for row, and figS2's per-die RMS;
 36. serving telemetry at full width (minicpm-2b, prototype macro,
     packed and fused, captured): phase 4's serve with ``metrics=True``
     (its tokens, the four spans, the registry); the paged scheduler on
     the multi-tenant trace (12 requests with Poisson arrivals at 0.5 an
     iteration, 8 slots, context 128, prompts <= 64, blocks of 16,
     chunks of 32), metrics off and on in turns: tokens equal, one flags
     read per iteration, the ring TTFT equal to ``run_instrumented``'s
     first_iter, counted tokens equal to the emitted ones, the rows 1-3
     kernel nodes per replay equal on and off, the best-of on/off tok/s
     ratio and each graph's fingerprint; the contiguous scheduler with
     speculative rounds at draft ADC 5 and metrics on, through the
     kernels and their plain version: equal tokens and ADC clip counts,
     the count > 0; kernel rows 1 and 2 alone at the full-width shapes
     (M 4 and 128; the prototype at ADC 7 and 5, all-analog at 5): clip
     counts equal the plain version's, device time with the counter on
     and off;
 37. the serve_bench twin (``python -m repro_torch.launch.serve_bench
     --smoke --gate``) in a process of its own, its gates held, its JSON
     document on one line;
 38. resilience at full width (minicpm-2b, packed and fused, prototype
     macro) on phase 9's first 8 prompts at half their stop lengths, 8
     slots, segments of 4 iterations: the clean ``GuardedServer`` run
     GREEN with no action and the plain captured scheduler's tokens,
     every rung's graphs captured in ``compile_for`` and none while
     serving, rows 1-2 launches equal to the hybrid graph's replays
     times its kernel nodes (plus the probe's and the admits' GEMMs),
     ``check_replays`` on the analog and hybrid steps; one turn per rung
     (tok/s, a replayed step) and the digital rung's ``wq()`` and float64
     GEMM times; the chaos run under the bench's drift ramp twice, RED
     within 32 tokens on the digital rung, logs equal; the fault-armed
     fast GEMM (layer 0 ``wo``, M 4) replayed from one graph at clocks 0,
     12 and 64 equal to its eager call and to the CPU; stuck-at faults
     on layer 0 of every packed leaf, card == CPU for ``wo`` and ``w2``;
 39. the resilience bench twin (``python -m
     repro_torch.launch.resilience_bench``) in a process of its own, its
     five gates held;
 40. the SSM family: mamba2-130m at full width and depth (24 layers,
     d_model 768, d_inner 1,536, state 128, 24 heads of 64, chunk 128,
     vocab 50,280; random weights from seed 0, packed and fused,
     prototype macro), lock-step batch 4, prompt 128 (one SSD chunk), 16
     generated: through the kernels and their plain versions, captured,
     and on the raw weights through row 6, tokens and last logits equal
     in all four; rows 1 / 2 / 6 launches equal the packed tree's GEMMs
     per forward (2 a layer: the fused input group, K 768 N 3,352, and
     out_proj, K 1,536 N 768) times the forwards; a replayed decode
     step's kernel nodes held to its credit and traced; decode tok/s,
     prefill s, the replayed step's ms beside the bound of one read of
     the macro layers and the lm_head, pack and peak bytes;
 41. mamba2-130m continuous batching, 10 requests of 128 tokens (stops
     8-32) over 8 slots (2 refilled: a reused slot's state reset inside
     the captured step), captured: contiguous, and paged with prefill
     chunks of 128 (aligned with the SSD chunk; tokens equal the
     contiguous pool's, gated) and of 32 (row 1 at M 32; agreement
     reported); rows 1-2 launches equal the GEMMs per forward times each
     pool's forwards, each pooled step's replay held to its nodes; the
     SSM and conv state bytes a slot;
 42. the hybrid family: zamba2-1.2b at full width and depth (38 Mamba2
     layers, d_model 2,048, d_inner 4,096, state 64, 64 heads of 64; the
     shared attention + MLP block, 32 heads of 64, d_ff 8,192, after
     layers 6, 12, ..., 36; vocab 32,000; random weights from seed 0,
     packed and fused, prototype macro), phase 40's lock-step workload
     and gates: 100 macro GEMMs a forward (76 of the Mamba2 layers, the
     shared block's QKV, wo, w1+w3 and w2 at each of its 6 invocations);
     the replayed step against the bound of the macro layers, the shared
     block 6 times and the lm_head read once;
 43. zamba2-1.2b continuous batching, phase 41's 10 requests over 8
     slots, captured: contiguous and paged with prefill chunks of 128
     (rows 1-2 launches equal 100 GEMMs times each pool's forwards, row 3
     6 launches a paged pooled step, refcounts drained, each pooled
     step's replay held to its nodes), the paged pool equal to solo runs
     of requests 0-1; reported, not gated: paged tokens equal to the
     contiguous pool's (as phase 10), and agreement with a paged run on
     the plain read over the first 2 requests (as phase 12);
 44. the dense configs at full width and depth: qwen3-14b (40 layers,
     d_model 5,120, 40 query heads padded to 48 over 8 kv heads of 128,
     qk_norm, d_ff 17,408, vocab 151,936; random weights from seed 0,
     packed and fused, prototype macro; nothing of an earlier phase
     live: at most 2 GB allocated at entry; each raw projection released
     once packed, as ``serve`` packs the params it makes; the init and
     pack peaks), phase 4's workload through ``serve`` with the decode
     step captured: 4 row-2 launches a layer in prefill and 4 row-1
     launches a layer a step (160 and 2,400), pack bytes and peak memory;
     on the same pack the first 4 tokens eagerly through the kernels and
     through their plain versions, tokens equal the captured run's and each
     other's, last logits equal; a replayed decode step's kernel nodes
     held to its credit and its ms against the bound of one read of the
     pack's layers and the lm_head; one layer's four GEMMs timed as in
     phase 7 (row 1 at M 4, row 2 at M 128; same-operand and cold over
     the stack's first layers);
 45. starcoder2-7b (32 layers, d_model 4,608, 36 heads padded to 48 over
     4 kv heads of 128, GELU, d_ff 18,432, vocab 49,152), phase 44's
     workload and gates (128 and 1,920 launches);
 46. gemma2-9b (42 layers, d_model 3,584, 16 heads over 8 kv heads of
     256, local / global layers with a 4,096 window, attention softcap 50,
     logit softcap 30, GELU, tied embeddings, d_ff 14,336, vocab
     256,000), phase 44's workload and gates (168 and 2,520 launches);
     then phase 9's first 6 requests over 8 slots, captured: contiguous,
     pool tokens equal the lock-step waves' (gated); paged as phase 10
     (blocks of 16, chunks of 32), 42 row-3 launches a pooled step at G
     2, Dh 256, softcap 50, refcounts drained, the pool equal to a solo
     run of request 0 (gated), paged == contiguous reported; the
     paged queue served again (the same tokens, gated) with its 10th
     pooled step traced: row 3's device time in a replayed step;
 47. the moe family: qwen2-moe-a2.7b at full width and depth (24 layers,
     d_model 2,048, 16 heads of 128, 60 routed experts top 4 of width
     1,408 and a shared expert of 5,632, vocab 151,936; the routed
     experts stay bf16 matrices, the attention and the shared expert are
     packed), first served unpacked on its raw weights (row 6, 4 tokens,
     == the packed tokens) and then phase 44's workload and gates (96
     and 1,440 launches; the step's bounds read every expert, and only
     the ~14.2 that 16 draws occupy; one layer's expert GEMMs timed);
     phase 46's queues (row 3 at G 1, Dh 128; a solo run of request
     0); a speculative lock-step run at verify M 18 (row 1) == the
     lock-step tokens; one 1 x 1,088 prefill through the grouped
     dispatch (T * K 4,352 > 4,096) and its dropped share; every peak
     within the card; and arctic-480b at smoke size (the dense residual
     beside the moe), kernel == plain tokens and logits;
 48. the vlm family: paligemma-3b at full width and depth (18 layers,
     d_model 2,048, 8 query heads padded to 16 over one kv head of 256,
     GELU, d_ff 16,384, tied embeddings over 257,216 words; random
     weights from seed 0, packed and fused), first served unpacked on
     its raw weights (row 6, 4 tokens, == the packed tokens), then phase
     44's workload and gates with the data pipeline's 256 frontend
     embeddings ahead of each prompt under the prefix-LM mask: the
     prefill on row 2 at M 1,152 (72 launches), 72 row-1 launches a
     step (1,080); the mask live (a prefill without it gives other last
     logits); a speculative lock-step run at verify M 18 (row 1) == the
     text-only greedy chain (the speculative driver takes no frontend
     and the scheduler refuses the vlm, as the reference's);
 49. the audio family: musicgen-medium at full width and depth (48
     layers, d_model 1,536, 24 MHA heads padded to 32 of 64, GELU, d_ff
     6,144, vocab 2,048), unpacked == packed on row 6, phase 44's
     workload and gates (192 and 2,880 launches), phase 46's queues
     without the trace (row 3 at G 1, Dh 64, 48 reads a pooled step;
     pool == lock-step, paged pool == a solo run of request 0), a
     speculative lock-step run at verify M 18 == lock-step.

 50. training at full width and depth (in a child process with
     deterministic cuBLAS, ``python3 chip_smoke.py --training``):
     minicpm-2b, raw fused weights from seed 0, ``--cim`` on the
     prototype macro, 6 steps of ``make_train_step`` (the step
     ``train()`` takes) at its batch 8 x seq 64 from ``batch_at``, each
     layer and CE chunk recomputed in the backward: 320 row-6 launches a
     step at M 512, gated per step; the same steps through row 6's plain
     version under ``torch.use_deterministic_algorithms(True)``, losses
     and every updated leaf ``==``; each step's wall time, peak bytes,
     one further step split into forward, backward and AdamW, and one
     more traced (device busy, idle, top kernels, row 6 beside its
     bound);
 51. fault tolerance: the reference's resume test through ``train`` with
     ``--cim`` at mamba2-130m's full width and depth (batch 2 x 32): 6
     steps straight against 3, a failure at step 4 and a resume from
     the step-3 checkpoint, losses equal (bit for bit reported); the
     ``--verify`` CLI 0 on the checkpoint, 1 on a truncated copy.

Phase 34 also runs the plan_pareto twin's second arch, mamba2-130m, at
the reference bench's smoke size and noise seed.

Depth cuts for time: phase 6 profiles a decode step of the first 2
layers; to make room for phases 40-41, phase 12 serves the first 4 of
phase 11's requests (from 8), phases 27 and 30 the first 4 of phase 9's
(from 8) and phase 31 3 tokens (from 4); to make room for phases 42-43,
phases 6, 26 and 31 profile 2 layers (from 4), phase 20 checks 131,072
conversions on the CPU (from 262,144), phases 23 and 26 generate 12
tokens in their first case (from 24: two rounds at k 8, the fewest that
capture and replay a round), phase 34's plan_pareto twin 8 (from 16),
phase 10 serves the first 8 of phase 9's requests (from 16), phase 30
stops its requests at a quarter of phase 9's stop lengths (from half),
phase 36 (b) times 2 pairs of turns (from 4), (c) stops at 4-8 tokens
(from 6-12) and phase 37 runs the
serve_bench twin with one repeat of its ungated rows (from 3); to make
room for phases 44-46, phase 12 serves the first 2 of phase 11's
requests through the plain read (from 4; 1 since phase 46 traces a
pooled step), phase 20 checks 65,536
conversions on the CPU (from 131,072), phase 34's plan_pareto twin
generates 4 tokens (from 8), phase 43's plain read serves 2 requests
(from 4), phase 24 serves 12 of phase 9's requests contiguous (from 16)
and 4 paged (from 8), and phases 41 and 43 serve 12 requests (from 16;
each pool still refills 4 of its 8 slots); to make room for phase 47,
phases 9 and 11 serve 12 requests (from 16), and phases 11 and 46 hold
their paged pools to solo runs of 2 requests (from 3); to make room for
phases 48-49, phases 9 and 11 serve 10 requests (from 12), phase 10 the
first 4 of phase 9's (from 8), phase 24 10 contiguous (from 12; 2 slots
refilled), phases 41 and 43 10 requests (from 12; 2 slots refilled),
phases 40 and 42 generate 16 tokens (from 32), phase 27 stops its
requests at a quarter of phase 9's stop lengths (from half), and phases
43, 46 and 47 hold their paged pools to solo runs of 2, 1 and 1
requests (from 3, 2 and 2); to make room for phases 50-51, phase 36 (b)
serves 12 multi-tenant requests (from 16) and phases 46, 47 and 49
queue 6 of phase 9's requests (from 8).

The serving drivers replay captured graphs by default on the card
(``launch/graphs.py``), so phases 9, 11, 22 and 24 serve captured.  A
replay launches its kernels without calling their wrappers, so a graph
credits each wrapper's count at every replay with what its capture
counted; phases 25-27 hold that credit to the profiler's trace.  Phases
4-5 and 10, whose counts are the kernels line's ``launches``, and phase
23, whose records measure eager dispatch, pass ``graphs=False``: their
counts are ticks of the wrappers themselves.  Phases 6 and 12 profile
``lm.decode_step`` called directly (eager).  Every profile's device busy
time is the union of its device-side events' intervals
(``device_breakdown``).

Every row of the kernels table carries ``ms`` (CUDA events around one
call, host wrapper included), ``device_ms`` (CUDA-graph replays, the
kernel alone) and the yardstick's ``library_ms`` and
``library_device_ms``.

The line before the last is the kernels table; the last line is the
device record.  Needs a CUDA device: without one it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 operations/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
# int32 lanes per SM (Hopper white paper): the general macro GEMM's
# per-chunk conversions run there, at the card's max SM clock
INT32_LANES_PER_SM = 64
FLOOR_NOTE = ("epilogue_floor_ms: int_ops / (SMs x 64 int32 lanes x the max "
              "SM clock that nvidia-smi reports) -- a data-sheet estimate, "
              "not measured; int_ops counts 4 per conversion and 4 + 4 "
              "n_planes per 4 activation bytes per 128-column block")

# minicpm-2b full-width macro GEMMs of one layer, (K, N), heads padded to 48
FULL_SHAPES = {"qkv": (2304, 9216), "wo": (3072, 2304),
               "gate_up": (2304, 11520), "w2": (5760, 2304)}
SKINNY_MS, GENERAL_MS = (1, 4, 8, 16, 32), (33, 128, 512)
UNPACKED_MS = (1, 4, 32, 33, 128, 129, 512)     # phase 15, kernel 6


T_IMPORT = time.time()


def emit(obj) -> None:
    """One JSON record, with the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=time.time() - T_IMPORT)), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# the serving paths' kernels: each wrapper's launch runs one kernel of
# this symbol (row 3's split merge is a second kernel of another name)
KERNEL_SYMBOLS = {"ccim_matmul_prepacked_skinny_cuda": "skinny_kernel",
                  "ccim_matmul_prepacked_general_cuda": "general_kernel",
                  "paged_attention_cuda": "paged_attn_walk"}
# a symbol, demangled (``::skinny_kernel<``) or mangled (``13skinny_kernel``),
# and not the tail of another (``complex_skinny_kernel``)
SYMBOL_RE = {s: re.compile(rf"(?<![A-Za-z_]){s}")
             for s in KERNEL_SYMBOLS.values()}
# cuBLAS's and CUTLASS's GEMM kernels (the bf16 and float32 matmuls outside
# the macro: the moe's router and experts, the lm_head)
LIBRARY_GEMM_RE = re.compile(r"gemm|xmma|cutlass|nvjet", re.IGNORECASE)


def device_breakdown(prof, steps: int, wall_ms: float) -> dict:
    """Per step of a torch.profiler trace of ``steps`` steps of
    ``wall_ms`` each: device busy time as the union of the device-side
    events' intervals (kernels, memsets, copies: each counted once,
    whether a host op or a graph replay launched it; a profiler range's
    device-side span is not an event), the idle share, device events,
    the serving kernels by symbol, aten calls, and the top device and
    host self times."""
    from torch.autograd import DeviceType
    spans, symbols, ranges = [], dict.fromkeys(SYMBOL_RE, 0), set()
    sym_us, gemm_us = dict.fromkeys(SYMBOL_RE, 0.0), 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.is_user_annotation:
            ranges.add(e.name)
            continue
        spans.append((e.time_range.start, e.time_range.end))
        dur = e.time_range.end - e.time_range.start
        for sym, pat in SYMBOL_RE.items():
            hit = bool(pat.search(e.name))
            symbols[sym] += hit
            sym_us[sym] += dur * hit
        gemm_us += dur * bool(LIBRARY_GEMM_RE.search(e.name))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    dev_us, host_us, aten_calls = {}, {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.key not in ranges:
            dev_us[e.key] = dev_us.get(e.key, 0) + t
        if e.key.startswith("aten::"):
            host_us[e.key] = e.self_cpu_time_total
            aten_calls += e.count
    busy_ms = busy_us / 1e3 / steps
    per_step = lambda d: {k[:60]: v / 1e3 / steps for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:8]}
    return {"device_busy_ms": busy_ms if spans else None,
            "device_idle_share": 1 - busy_ms / wall_ms if spans else None,
            "device_events_per_step": len(spans) / steps,
            "gap_per_event_us": (1e3 * (wall_ms - busy_ms) * steps
                                 / len(spans) if spans else None),
            "kernels_by_symbol_per_step": {k: n / steps
                                           for k, n in symbols.items()},
            "kernels_by_symbol_ms_per_step": {k: v / 1e3 / steps
                                              for k, v in sym_us.items()},
            "library_gemm_ms_per_step": gemm_us / 1e3 / steps,
            "aten_calls_per_step": aten_calls / steps,
            "top_device_ms_per_step": per_step(dev_us),
            "top_host_self_ms_per_step": per_step(host_us)}


TIMING = ("ms, plain_ms, four_pass_ms and library_ms: CUDA events around "
          "one call, host wrapper included; device_ms, four_pass_device_ms "
          "and library_device_ms: device time per call from CUDA-graph "
          "replays of 20 calls")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# minicpm-2b's decode shape of the paged read: 48 padded heads, G 1, Dh 64
PA_BATCH, PA_HEADS, PA_DH, PA_BS = 8, 48, 64, 16
PA_LENGTHS = (32, 64, 96, 160, 1024, 4096)  # phase 13; 96 fills 10-11
PA_REPORT_L = 96
PA_LONG_TBL = 256                            # phase 8's long walks
# phase 13's split sweep: (B, L, rows after the first cut to L 96) -> the
# split counts timed; the ragged batch is one long request among short ones
PA_SWEEP = {(PA_BATCH, 1024, False): (1, 2, 4, 8),
            (PA_BATCH, 4096, False): (1, 2, 4, 8, 16),
            (PA_BATCH, 4096, True): (1, 2, 4, 8, 16),
            (1, 4096, False): (1, 2, 4, 6, 8, 16)}


def paged_attn_shapes(torch, dev) -> float:
    """Phase 8: the paged-attention kernel against its plain version.
    Returns the largest |kernel - plain| seen."""
    import itertools
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.paged_attn import ref as PR

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    splits = set()

    def case(B, Hkv, G, Dh, bs, n_tbl, nb, max_len, softcap, window,
             is_local, trash_rows, lengths=None):
        bf = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
            torch.bfloat16)
        q, kp, vp = (bf(B, Hkv * G, Dh) * 2, bf(nb, bs, Hkv, Dh),
                     bf(nb, bs, Hkv, Dh))
        table = torch.randint(1, nb, (B, n_tbl), generator=gen, device=dev,
                              dtype=torch.int32)
        table[B - trash_rows:] = 0                  # harvested slots
        if lengths is None:
            lengths = torch.randint(1, max_len + 1, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        splits.add(PK.paged_split(B, Hkv, G, n_tbl, PK.sm_count(dev), Dh))
        y = PK.paged_attention_cuda(q, kp, vp, table, lengths, is_local,
                                    softcap=softcap, window=window)
        r = PR.paged_attention_ref(q, kp, vp, table, lengths,
                                   softcap=softcap, window=window,
                                   is_local=is_local)
        torch.cuda.synchronize()
        # the plain version rounds the normalized p to bf16 before P.V:
        # up to 2^-9 of sum(p |v|) <= 2^-9 max|v| per output, and both
        # outputs are rounded to bf16 once: rtol 2^-7, atol 2^-7 max|v|
        tol = 2 ** -7 * r.float().abs() + 2 ** -7 * vp.float().abs().max()
        d = (y.float() - r.float()).abs()
        worst["max_abs_err"] = max(worst["max_abs_err"], float(d.max()))
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"],
                                        float((d / tol).max()))
        check(bool(torch.isfinite(y.float()).all()) and bool((d <= tol).all()),
              f"paged attention kernel != plain at B={B} Hkv={Hkv} G={G} "
              f"Dh={Dh} bs={bs} softcap={softcap} window={window} "
              f"is_local={is_local}: max |diff| {float(d.max())}")

    case(PA_BATCH, PA_HEADS, 1, PA_DH, PA_BS, 10, 81, 160, None, None,
         False, trash_rows=2)
    n = 1
    for G, Dh, bs, softcap, window, is_local in itertools.product(
            (1, 4, 8), (64, 128), (8, 16, 32), (None, 50.0), (None, 7),
            (False, True)):
        case(5, 3, G, Dh, bs, 7, 40, 7 * bs, softcap, window, is_local,
             trash_rows=1)
        n += 1
    # long walks that the kernel splits: minicpm-2b's shape at 256 table
    # entries, GQA at Dh 128 over 64, lengths on and off block and split
    # boundaries; at window 7 the later splits of every row get no work
    nt = PA_LONG_TBL
    for softcap, window, is_local in ((None, None, False), (50.0, 7, True)):
        case(PA_BATCH, PA_HEADS, 1, PA_DH, PA_BS, nt, PA_BATCH * nt + 1,
             nt * PA_BS, softcap, window, is_local, trash_rows=1)
        case(3, 2, 8, 128, 16, 64, 3 * 64 + 1, 1024, softcap, window,
             is_local, trash_rows=1)
        case(8, 8, 1, PA_DH, PA_BS, 48, 8 * 48 + 1, None, softcap, window,
             is_local, trash_rows=1,
             lengths=(768, 720, 721, 80, 81, 64, 17, 1))
        n += 3
    emit({"phase": "paged_attn_shapes", "ok": True, "cases": n,
          "minicpm_shape": {"B": PA_BATCH, "Hq": PA_HEADS, "Hkv": PA_HEADS,
                            "Dh": PA_DH, "bs": PA_BS, "lengths": "1-160",
                            "trash_rows": 2},
          "long_cases": {"minicpm": f"n_tbl {nt}, lengths 1-{nt * PA_BS}",
                         "gqa": "B 3, Hkv 2, G 8, Dh 128, n_tbl 64",
                         "boundaries": "B 8, Hkv 8, n_tbl 48",
                         "windows": "none; 7 with softcap 50"},
          "split_counts": sorted(splits),
          "tolerance": "rtol 2^-7, atol 2^-7 max|v|", **worst})
    return worst["max_abs_err"]


def _serve_record(stats) -> dict:
    keep = ("continuous", "n_iter", "iter_ms", "host_syncs",
            "host_syncs_per_iter", "branch_counts", "branch_ms_per_iter",
            "pack_s", "paged", "lockstep", "speedup_vs_lockstep")
    return {k: stats[k] for k in keep if k in stats}


# phase 12's queue: the first requests of phase 11's (8 until phases
# 40-41, 4 until phases 44-46 and 2 until phase 46's traced pooled step
# needed the time)
PLAIN_PAGED_REQUESTS = 1
# phase 10's queue: the first requests of phase 9's (16 until phases 42-43
# and 8 until phases 48-49 needed the time; a request's tokens do not
# depend on its neighbours)
PAGED_REQUESTS = 4
# phases 9 and 11's queues (16 until phase 47 and 12 until phases 48-49
# needed the time; phase 24 compares its requests with phase 9's first
# ones) and phase 11's solo runs (3)
PHASE9_REQUESTS, SHARED_SOLO = 10, 2


def continuous_phases(torch, dev, params, cfg_full) -> dict:
    """Phases 9-12: continuous batching at full width, contiguous and
    paged, through ``serve_continuous`` and the scheduler.  Returns the
    paged-attention launch counts of each path."""
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              shared_prefix_requests)
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import lm

    slots, plen, stops, n_req = 8, 64, (8, 24, 16, 32), PHASE9_REQUESTS
    layout = PagedLayout(block_size=PA_BS,
                         n_tbl=cdiv(plen + max(stops) - 1, PA_BS),
                         n_blocks=64)
    chunk = 32
    counts = {}

    def reset():
        K.reset_launch_counts()
        PK.reset_launch_counts()

    def launches():
        return {"skinny": K.ccim_matmul_prepacked_skinny_cuda.launches,
                "general": K.ccim_matmul_prepacked_general_cuda.launches,
                "paged_attn": PK.paged_attention_cuda.launches}

    common = dict(smoke=False, slots=slots, prompt_len=plen,
                  n_requests=n_req, stop_lengths=stops, cim=True,
                  params=params, device=dev)
    # -- 9. contiguous: pool tokens == lock-step wave baseline ------------
    reset()
    toks_c, st_c = serve_continuous("minicpm-2b", compare_lockstep=True,
                                    **common)
    n_c = launches()
    check(st_c.get("tokens_match_lockstep") is True,
          "contiguous pool tokens != lock-step tokens")
    check(n_c["paged_attn"] == 0, "the contiguous serve launched the "
          f"paged-attention kernel {n_c['paged_attn']} times")
    counts["serve_contiguous"] = n_c["paged_attn"]
    emit({"phase": "serve_contiguous", "ok": True, "requests": n_req,
          "prompt_len": plen, "stop_lengths": list(stops),
          "tokens_equal_lockstep": True, "launches": n_c,
          **_serve_record(st_c)})

    # -- 10. paged: 40 paged-attention launches per decode step ------------
    reset()
    toks_p, st_p = serve_continuous("minicpm-2b", compare_lockstep=False,
                                    paged=layout, prefill_chunk=chunk,
                                    graphs=False, **dict(
                                        common, n_requests=PAGED_REQUESTS))
    n_p = launches()
    n_steps = st_p["continuous"]["n_steps"]
    check(n_p["paged_attn"] == cfg_full.n_layers * n_steps,
          f"paged serve launched the paged-attention kernel "
          f"{n_p['paged_attn']} times, expected {cfg_full.n_layers} x "
          f"{n_steps} decode steps")
    check(st_p["paged"]["refcounts_drained"], "phase 10 refcounts leaked")
    same = [bool((toks_p[r] == toks_c[r]).all()) if len(toks_p[r]) ==
            len(toks_c[r]) else False for r in toks_p]
    counts["serve_paged"] = n_p["paged_attn"]
    emit({"phase": "serve_paged", "ok": True, "launches": n_p,
          "requests": PAGED_REQUESTS, "decode_steps": n_steps,
          "requests_equal_contiguous": f"{sum(same)} of {len(same)}",
          "requests_equal_contiguous_share": sum(same) / len(same),
          "not_gated_because": "the kernel's float32 P.V can move a bf16 "
                               "activation by one ulp, and in CIM mode an "
                               "ADC code with it",
          **_serve_record(st_p)})

    # -- 11. shared prefix: drain, sharing, pool == solo -------------------
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    reqs = shared_prefix_requests(n_req, 2 * PA_BS, 24, plen, cfg.vocab_size,
                                  stop_lengths=stops, seed=11)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    kw = dict(slots=slots, prompt_len=plen, max_new_cap=max(stops),
              paged=layout, prefill_chunk=chunk)
    sched = ContinuousBatchingScheduler(packed, cfg, **kw)
    reset()
    rep = sched.run(reqs)
    n_s = launches()
    drained = [1] + [0] * (layout.n_blocks - 1)
    plan = sched.last_prefix_plan.stats()
    check(rep.ref_final.tolist() == drained,
          f"phase 11 refcounts did not drain: {rep.ref_final.tolist()}")
    check(plan["shared_blocks"] > 0, f"no shared blocks: {plan}")
    check(n_s["paged_attn"] == cfg.n_layers * rep.n_steps,
          "phase 11 paged-attention launches != 40 per decode step")
    counts["serve_paged_shared"] = n_s["paged_attn"]
    pool = rep.tokens_by_rid()
    solo_rids = tuple(range(SHARED_SOLO))
    for rid in solo_rids:
        solo = sched.run([reqs[rid]])
        check(solo.ref_final.tolist() == drained, "solo run leaked blocks")
        check(bool((solo.tokens_by_rid()[rid] == pool[rid]).all())
              and len(solo.tokens_by_rid()[rid]) == len(pool[rid]),
              f"request {rid}: pool tokens != solo tokens")
    emit({"phase": "serve_paged_shared", "ok": True, "launches": n_s,
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefix_plan": plan, "refcounts_drained": True,
          "pool_equals_solo": list(solo_rids),
          "peak_blocks": rep.peak_blocks,
          "kv_bytes_peak": sched.kv_bytes_paged(rep.peak_blocks),
          "kv_bytes_contiguous": sched.kv_bytes_contiguous(),
          "summary": rep.summary(), "n_iter": rep.n_iter,
          "iter_ms": 1e3 * rep.wall_s / rep.n_iter,
          "host_syncs_per_iter": rep.host_syncs / rep.n_iter,
          "branch_counts": rep.branch_counts})

    # -- 12. the plain paged read on the card ------------------------------
    # (the first PLAIN_PAGED_REQUESTS of phase 11's: the agreement is
    # reported, and the plain read's eager queue was the phase's time)
    cfg_plain = dataclasses.replace(cfg, paged_attn_use_kernel=False)
    reset()
    rep_p = ContinuousBatchingScheduler(packed, cfg_plain, **kw).run(
        reqs[:PLAIN_PAGED_REQUESTS])
    n_pl = launches()
    check(n_pl["paged_attn"] == 0, "the plain run launched the kernel")
    check(rep_p.ref_final.tolist() == drained,
          "phase 12 refcounts did not drain")
    plain = rep_p.tokens_by_rid()
    agree = [len(plain[r]) == len(pool[r]) and bool((plain[r] == pool[r]).all())
             for r in plain]
    lg_diff, arg_equal, step_prof = first_step_logits(
        torch, dev, packed, cfg, cfg_plain, reqs[:slots], layout, chunk,
        profile=True)
    # the same step with float weights: how far the read itself moves the
    # logits before the macro's quantization and ADC codes amplify it
    cfg_fp = dataclasses.replace(cfg_full, cim_mode=False)
    fp_diff, fp_equal, _ = first_step_logits(
        torch, dev, params, cfg_fp,
        dataclasses.replace(cfg_fp, paged_attn_use_kernel=False),
        reqs[:slots], layout, chunk)
    emit({"phase": "serve_paged_plain", "ok": True, "launches": n_pl,
          "requests_equal_kernel": f"{sum(agree)} of {len(agree)}",
          "requests_equal_kernel_share": sum(agree) / len(agree),
          "first_decode_logits_max_abs_diff": lg_diff,
          "first_decode_argmax_equal_share": arg_equal,
          "first_decode_fp_logits_max_abs_diff": fp_diff,
          "first_decode_fp_argmax_equal_share": fp_equal,
          "paged_decode_profile": step_prof,
          "summary": rep_p.summary(),
          "iter_ms": 1e3 * rep_p.wall_s / rep_p.n_iter})
    del packed, sched
    return {"paged_launches": counts["serve_paged"],
            "paged_launches_by_path": counts,
            "tokens_contiguous": toks_c, "tokens_paged": toks_p}


def first_step_logits(torch, dev, packed, cfg, cfg_plain, reqs, layout,
                      chunk, profile: bool = False):
    """Prefill ``reqs`` into a paged pool (one per slot), then one pooled
    decode step with the kernel and one with the plain version from the
    same cache: max |logit difference|, the share of equal argmaxes and,
    with ``profile``, a torch.profiler breakdown of three more kernel
    steps on that cache (as phase 6's), with the paged read's device time
    per step (None without ``profile``)."""
    from repro_torch.models import lm
    B, nt = len(reqs), layout.n_tbl
    with torch.inference_mode():
        cache = lm.init_paged_cache(cfg, B, layout.n_blocks,
                                    layout.block_size, nt, device=dev)
        cache["table"].copy_(1 + torch.arange(B * nt, device=dev,
                                              dtype=torch.int32).view(B, nt))
        last = []
        for slot, r in enumerate(reqs):
            plen = len(r.prompt)
            toks = torch.zeros((1, -(-plen // chunk) * chunk),
                               dtype=torch.int64)
            toks[0, :plen] = torch.from_numpy(r.prompt.astype("int64"))
            toks = toks.to(dev)
            for s0 in range(0, toks.shape[1], chunk):
                lg, cache = lm.prefill_chunk_into_slot(
                    packed, cfg, toks[:, s0:s0 + chunk], cache, slot)
            cache["pos"][slot] = plen
            last.append(torch.argmax(lg[0, (plen - 1) % chunk]))
        tok = torch.stack(last)[:, None]
        live = torch.ones((B,), dtype=torch.bool, device=dev)
        pos0 = cache["pos"].clone()
        lk, _ = lm.decode_step(packed, cfg, tok, cache, live=live)
        cache["pos"].copy_(pos0)                # the plain step, same state
        lp, _ = lm.decode_step(packed, cfg_plain, tok, cache, live=live)
        prof_rec = None
        if profile:
            steps = 1
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    lm.decode_step(packed, cfg, tok, cache, live=live)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / steps
            paged_us = sum(getattr(e, "self_device_time_total", 0) or 0
                           for e in prof.key_averages()
                           if "paged_attn" in e.key)
            prof_rec = {"steps": steps, "step_wall_ms": wall_ms,
                        "paged_attn_device_ms_per_step":
                            paged_us / 1e3 / steps,
                        **device_breakdown(prof, steps, wall_ms)}
    diff = float((lk - lp).abs().max())
    eq = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    return diff, eq, prof_rec


def paged_pools(torch, dev, gen, B: int, L: int, copies: int = 1,
                hq: int = PA_HEADS, hkv: int = PA_HEADS, dh: int = PA_DH):
    """Phase 13's operands at batch ``B`` and length ``L`` (minicpm-2b's
    heads unless given): q, the table of each row's distinct blocks
    (shuffled over the pool) and the lengths, and ``copies`` distinct
    (k_pool, v_pool) pairs that the table indexes alike."""
    bs = PA_BS
    nt = -(-L // bs)
    nb = B * nt + 1
    bf = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
        torch.bfloat16)
    q = bf(B, hq, dh)
    pools = [(bf(nb, bs, hkv, dh), bf(nb, bs, hkv, dh))
             for _ in range(copies)]
    table = (1 + torch.randperm(nb - 1, generator=gen, device=dev)[
        :B * nt]).to(torch.int32).view(B, nt)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    return q, pools, table, lengths


def paged_pool_bytes(B: int, L: int, hkv: int = PA_HEADS,
                     dh: int = PA_DH) -> int:
    return 2 * (B * -(-L // PA_BS) + 1) * PA_BS * hkv * dh * 2


# phase 13's head dim 256 shapes: (B, query heads, kv heads, softcap,
# window, is_local) of gemma2-9b (a local layer: its window of 4,096
# covers these lengths whole) and paligemma-3b, at PA_DH256_LENGTHS
PA_DH256 = {"gemma2-9b": (8, 16, 8, 50.0, 4096, True),
            "paligemma-3b": (8, 8, 1, None, None, False)}
PA_DH256_LENGTHS = (96, 1024)


def times_paged_attn_dh256(torch, dev) -> dict:
    """Phase 13's head dim 256 cases: the kernel against its plain
    version (rtol 2^-7, atol 2^-7 max|v|), one launch counted a call,
    per call (``ms``), same-pool device time and cold (rotating distinct
    pools), beside the plain version, the gather + SDPA yardstick (same
    pool and cold; without gemma2's softcap and window, so a yardstick of
    another function) and the bound by bytes (K and V read up to the
    lengths, q read and the output written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.paged_attn import ref as PR

    gen = torch.Generator(device=dev)
    gen.manual_seed(256)
    n_sm = PK.sm_count(dev)
    rows = {}
    for model, (B, hq, hkv, softcap, window, local) in PA_DH256.items():
        for L in PA_DH256_LENGTHS:
            copies = cold_copy_count(torch, dev,
                                     paged_pool_bytes(B, L, hkv, 256))
            q, pools, table, lengths = paged_pools(
                torch, dev, gen, B, L, copies, hq, hkv, 256)
            kp, vp = pools[0]
            kw = dict(softcap=softcap, window=window)
            kern = lambda kp=kp, vp=vp: PK.paged_attention_cuda(
                q, kp, vp, table, lengths, local, **kw)
            plain_fn = lambda: PR.paged_attention_ref(
                q, kp, vp, table, lengths, is_local=local, **kw)
            n0 = PK.paged_attention_cuda.launches
            y = kern()
            check(PK.paged_attention_cuda.launches == n0 + 1,
                  f"phase 13: Dh 256 {model} L {L}: a call counted "
                  f"{PK.paged_attention_cuda.launches - n0} launches")
            r = plain_fn()
            check(paged_tolerance_ok(torch, y, r, vp),
                  f"phase 13: paged kernel != plain at Dh 256, {model}, "
                  f"L {L}")
            err = float((y.float() - r.float()).abs().max())
            ms = cuda_ms(kern, reps=50)
            plain = cuda_ms(plain_fn, reps=5 if L > 1000 else 20)
            dev_ms = graph_ms(torch, kern)
            cold = graph_rotation_ms(torch, [
                lambda kp=kp, vp=vp: kern(kp, vp) for kp, vp in pools])
            # the library yardstick: gather + SDPA over every position
            # (no softcap, window or length mask: another function)
            def sdpa(kp=kp, vp=vp):
                k = PR.paged_gather_kv(kp, table).transpose(1, 2)
                v = PR.paged_gather_kv(vp, table).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, enable_gqa=hq != hkv)
            lib = cuda_ms(sdpa, reps=50)
            lib_dev = graph_ms(torch, sdpa)
            lib_cold = graph_rotation_ms(torch, [
                lambda kp=kp, vp=vp: sdpa(kp, vp) for kp, vp in pools])
            nbytes = 2 * B * L * hkv * 256 * 2 + 2 * B * hq * 256 * 2
            nops = 4 * B * hq * L * 256
            rows[f"{model}_L{L}"] = dict(
                library_ms=lib, library_device_ms=lib_dev,
                library_cold_ms=lib_cold,
                B=B, hq=hq, hkv=hkv, dh=256, L=L, softcap=softcap,
                window=window, is_local=local, max_abs_err=err, ms=ms,
                device_ms=dev_ms, device_cold_ms=cold, plain_ms=plain,
                bound_ms=1e3 * max(nbytes / HBM_BYTES_S, nops / BF16_OPS_S),
                bound_by=("bytes" if nbytes / HBM_BYTES_S
                          >= nops / BF16_OPS_S else "operations"),
                bytes=nbytes, cold_copies=copies,
                n_split=PK.paged_split(B, hkv, hq // hkv, -(-L // PA_BS),
                                       n_sm, 256))
            del pools, kp, vp
    emit({"phase": "times_paged_attn_dh256", "ok": True, "bs": PA_BS,
          "by_case": rows, "cold": COLD, "timing": TIMING,
          "tolerance": "rtol 2^-7, atol 2^-7 max|v|",
          "library": "paged_gather_kv + scaled_dot_product_attention over "
                     "every position (enable_gqa): a yardstick of another "
                     "function (no softcap, window or length mask), which "
                     "the port never calls"})
    return rows


def paged_tolerance_ok(torch, y, r, vp) -> bool:
    """Phase 8's tolerance: rtol 2^-7, atol 2^-7 max|v|, finite."""
    tol = 2 ** -7 * r.float().abs() + 2 ** -7 * vp.float().abs().max()
    return bool(torch.isfinite(y.float()).all()) and bool(
        ((y.float() - r.float()).abs() <= tol).all())


def times_paged_attn(torch, dev) -> dict:
    """Phase 13: the paged-attention kernel at the minicpm-2b decode
    shape for several lengths: per call (``ms``), device time on one pool
    (``device_ms``) and cold (``device_cold_ms``, a rotation over distinct
    pools of at least 4 L2s of bytes, as a decode step's 40 layers read
    40 distinct pools), beside the plain version, the gather + SDPA
    yardstick (same-pool and cold) and the byte bound; and a sweep of
    cold device time over the split count at long walks.  Returns the row
    of the kernels table at PA_REPORT_L."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.paged_attn import ref as PR

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    B, H, Dh, bs = PA_BATCH, PA_HEADS, PA_DH, PA_BS
    n_sm = PK.sm_count(dev)
    rows = {}
    for L in PA_LENGTHS:
        copies = cold_copy_count(torch, dev, paged_pool_bytes(B, L))
        q, pools, table, lengths = paged_pools(torch, dev, gen, B, L, copies)
        kp, vp = pools[0]
        kern = lambda: PK.paged_attention_cuda(q, kp, vp, table, lengths)
        plain_fn = lambda: PR.paged_attention_ref(q, kp, vp, table, lengths)
        check(paged_tolerance_ok(torch, kern(), plain_fn(), vp),
              f"phase 13: paged kernel != plain at L {L}")
        ms = cuda_ms(kern, reps=50)
        plain = cuda_ms(plain_fn, reps=5 if L > 1000 else 20)

        def sdpa(kp=kp, vp=vp):
            k = PR.paged_gather_kv(kp, table).transpose(1, 2)
            v = PR.paged_gather_kv(vp, table).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None], k, v)
        lib = cuda_ms(sdpa, reps=50)
        dev_ms, lib_dev = graph_ms(torch, kern), graph_ms(torch, sdpa)
        cold = graph_rotation_ms(torch, [
            lambda kp=kp, vp=vp: PK.paged_attention_cuda(q, kp, vp, table,
                                                         lengths)
            for kp, vp in pools])
        lib_cold = graph_rotation_ms(torch, [
            lambda kp=kp, vp=vp: sdpa(kp, vp) for kp, vp in pools])
        # K and V rows read up to lengths, q read and out written once
        nbytes = 2 * B * L * H * Dh * 2 + 2 * B * H * Dh * 2
        nops = 4 * B * H * L * Dh
        bound = 1e3 * max(nbytes / HBM_BYTES_S, nops / BF16_OPS_S)
        rows[L] = dict(ms=ms, device_ms=dev_ms, device_cold_ms=cold,
                       plain_ms=plain, library_ms=lib,
                       library_device_ms=lib_dev, library_cold_ms=lib_cold,
                       bound_ms=bound, bytes=nbytes, cold_copies=copies,
                       n_split=PK.paged_split(B, H, 1, -(-L // bs), n_sm),
                       bound_by=("bytes" if nbytes / HBM_BYTES_S
                                 >= nops / BF16_OPS_S else "operations"))
        del pools, kp, vp
    sweep = {}
    for (b, L, ragged), counts in PA_SWEEP.items():
        copies = cold_copy_count(torch, dev, paged_pool_bytes(b, L))
        q, pools, table, lengths = paged_pools(torch, dev, gen, b, L, copies)
        if ragged:
            lengths[1:] = PA_REPORT_L
        ref = PR.paged_attention_ref(q, *pools[0], table, lengths)
        by_split = {}
        for n_split in counts:
            y = PK._launch(q, *pools[0], table, lengths, False, n_split,
                           None, None)
            check(paged_tolerance_ok(torch, y, ref, pools[0][1]),
                  f"phase 13: {n_split} splits != plain at B {b} L {L}")
            by_split[n_split] = graph_rotation_ms(torch, [
                lambda kp=kp, vp=vp, n=n_split: PK._launch(
                    q, kp, vp, table, lengths, False, n, None, None)
                for kp, vp in pools])
        sweep[f"B{b}_L{L}" + ("_ragged" if ragged else "")] = dict(
            device_cold_ms=by_split,
            chosen=PK.paged_split(b, H, 1, -(-L // bs), n_sm))
        del pools, ref
    emit({"phase": "times_paged_attn", "B": B, "Hq": H, "Hkv": H, "Dh": Dh,
          "bs": bs, "library": "paged_gather_kv + "
          "torch.nn.functional.scaled_dot_product_attention (yardstick, "
          "never called by the port)", "by_length": rows,
          "split_sweep": sweep, "cold": COLD, "timing": TIMING})
    r = rows[PA_REPORT_L]
    return {k: r[k] for k in ("ms", "device_ms", "device_cold_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library_device_ms",
                              "library_cold_ms")} | {
        "at_length": PA_REPORT_L,
        "by_length": {L: {k: v[k] for k in (
            "device_ms", "device_cold_ms", "bound_ms", "library_device_ms",
            "library_cold_ms", "n_split")} for L, v in rows.items()}}


# complex lane: (M, K, N) of the DoA frames -- covariance of the 64- and
# 32-element arrays, and the spectrum against a 2,401-point grid
DOA_SHAPES = ((64, 4096, 64), (32, 1024, 32), (60, 64, 2401), (30, 32, 2401))
RAGGED_SHAPES = ((1, 37, 11), (2, 1001, 333), (3, 130, 2401), (45, 999, 257))
DOA_FRAMES = 32
# array -> the prepacked complex kernel its spectrum takes (M = n - n_src)
DOA_ARRAYS = (("ula64", "complex_general"), ("ula32", "complex_skinny"))


def _equal_pair(got, want) -> int:
    """Largest |got - want| over a (re, im) pair (0 when equal)."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, want))


def complex_pack(torch, wr, wi):
    """A prototype pack of raw (K, N) int weights, Re and Im."""
    from repro_torch.core import engine
    one = torch.ones((1, wr.shape[1]), device=wr.device)
    return engine.PackedComplexCimWeights(
        engine.pack_quantized_cim_weights(wr, one),
        engine.pack_quantized_cim_weights(wi, one))


def complex_kernels(torch, dev, gen) -> dict:
    """Phase 14: kernels 4, 5 and 7 against their plain versions, and the
    four-pass route off the prototype.  Returns max |kernel - plain| by
    kernel."""
    from repro_torch.core import complex_mac, engine
    from repro_torch.core.ccim import CCIMConfig
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_complex import ops as CO
    from repro_torch.kernels.ccim_matmul import kernel as K

    err = {"complex_skinny": 0, "complex_general": 0, "complex_unpacked": 0}

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def case(xr, xi, wr, wi, pack, tag):
        m, k = xr.shape
        n = wr.shape[1]
        for name, fn in (
                ("complex_unpacked", lambda uk: CO.ccim_complex_matmul_int(
                    xr, xi, wr, wi, use_kernel=uk)),
                ("complex_skinny" if m <= K.SKINNY_M else "complex_general",
                 lambda uk: CO.ccim_complex_matmul_int_prepacked(
                     xr, xi, pack.re.kernel_w, pack.im.kernel_w,
                     pack.re.kernel_planes, pack.im.kernel_planes, k_dim=k,
                     n_dim=n, use_kernel=uk))):
            got, want = fn(True), fn(False)
            torch.cuda.synchronize()
            e = _equal_pair(got, want)
            err[name] = max(err[name], e)
            check(got[0].dtype == torch.int32 and e == 0,
                  f"{name} kernel != plain at {tag}: max |diff| {e}")

    n_cases = 0
    for sname, (k, n) in FULL_SHAPES.items():
        wr, wi = ints(k, n), ints(k, n)
        pack = complex_pack(torch, wr, wi)
        for m in SKINNY_MS + GENERAL_MS:
            case(ints(m, k), ints(m, k), wr, wi, pack, f"{sname} M={m}")
            n_cases += 1
    for m, k, n in RAGGED_SHAPES + DOA_SHAPES:
        wr, wi = ints(k, n), ints(k, n)
        case(ints(m, k), ints(m, k), wr, wi, complex_pack(torch, wr, wi),
             f"(M, K, N) = {(m, k, n)}")
        n_cases += 1

    # off the prototype: four real prepacked launches per call, no
    # complex kernel, raw or packed, equal to the plain run
    cfg = CCIMConfig(n_dcim_products=2, adc_bits=8)
    w = torch.randn((300, 77), generator=gen, device=dev,
                    dtype=torch.complex64)
    packed = engine.pack_complex_cim_weights(w.real, w.imag, cfg)
    four_pass = {}
    for m, real in ((4, "skinny"), (40, "general")):
        xr, xi = ints(m, 300), ints(m, 300)
        for label, wts in (("packed", (packed, None)),
                           ("raw", (packed.re.wq(), packed.im.wq()))):
            K.reset_launch_counts()
            CK.reset_launch_counts()
            got = complex_mac.complex_cim_matmul_int(xr, xi, *wts, cfg)
            n_real = {"skinny": K.ccim_matmul_prepacked_skinny_cuda.launches,
                      "general": K.ccim_matmul_prepacked_general_cuda.launches,
                      "unpacked": K.ccim_matmul_unpacked_cuda.launches}
            n_cplx = (CK.ccim_complex_unpacked_cuda.launches
                      + CK.ccim_complex_prepacked_skinny_cuda.launches
                      + CK.ccim_complex_prepacked_general_cuda.launches)
            want = complex_mac.complex_cim_matmul_int(xr, xi, *wts, cfg,
                                                      use_kernel=False)
            check(n_real[real] == 4 and sum(n_real.values()) == 4
                  and n_cplx == 0,
                  f"four-pass route at M={m} ({label}): real launches "
                  f"{n_real}, complex launches {n_cplx}")
            check(_equal_pair(got, want) == 0,
                  f"four-pass route at M={m} ({label}) != plain")
            four_pass[f"M={m} {label}"] = n_real
    emit({"phase": "complex_kernels", "ok": True, "cases": n_cases,
          "full_width_shapes": {s: list(v) for s, v in FULL_SHAPES.items()},
          "m": list(SKINNY_MS + GENERAL_MS),
          "ragged_shapes": [list(v) for v in RAGGED_SHAPES],
          "doa_shapes": [list(v) for v in DOA_SHAPES],
          "max_abs_err": err,
          "four_pass_off_prototype": {"config": "n_dcim 2, ADC 8 b",
                                      "real_launches": four_pass}})
    return err


def unpacked_real(torch, dev, gen) -> dict:
    """Phase 15: kernel 6 against its plain version at the full-width
    shapes (M of UNPACKED_MS) and at RAGGED_SHAPES, one launch per
    ``ccim_matmul_int`` call, then ``cim_matmul`` on raw float weights
    (the main path of the unpacked kernel) against ``cim_matmul`` on
    their pack."""
    from repro_torch.core import ccim, engine
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.ccim_matmul import ops as KO

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    err = 0

    def case(x, w, tag):
        nonlocal err
        K.reset_launch_counts()
        got = KO.ccim_matmul_int(x, w, use_kernel=True)
        torch.cuda.synchronize()
        n_launch = K.ccim_matmul_unpacked_cuda.launches
        want = KO.ccim_matmul_int(x, w, use_kernel=False)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err = max(err, e)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"unpacked kernel != plain at {tag}: max |diff| {e}")
        check(n_launch == 1, f"ccim_matmul_int at {tag} launched the "
              f"unpacked kernel {n_launch} times, expected 1")

    for sname, (k, n) in FULL_SHAPES.items():
        w = ints(k, n)
        for m in UNPACKED_MS:
            case(ints(m, k), w, f"{sname} M={m}")
    for m, k, n in RAGGED_SHAPES:
        case(ints(m, k), ints(k, n), f"(M, K, N) = {(m, k, n)}")
    xs = {s: torch.randn((128, k), generator=gen, device=dev)
          for s, (k, n) in FULL_SHAPES.items()}
    ws = {s: torch.randn((k, n), generator=gen, device=dev)
          for s, (k, n) in FULL_SHAPES.items()}
    K.reset_launch_counts()
    raw = {s: ccim.cim_matmul(xs[s], ws[s]) for s in FULL_SHAPES}
    torch.cuda.synchronize()
    launches = K.ccim_matmul_unpacked_cuda.launches
    check(launches == len(FULL_SHAPES),
          f"cim_matmul on raw weights launched the unpacked kernel "
          f"{launches} times, expected {len(FULL_SHAPES)}")
    for s in FULL_SHAPES:
        packed = ccim.cim_matmul(xs[s], engine.pack_cim_weights(ws[s]))
        check(torch.equal(raw[s], packed) and bool(torch.isfinite(
            raw[s]).all()), f"cim_matmul raw != packed at {s}")
    emit({"phase": "unpacked_real", "ok": True, "max_abs_err": err,
          "m": list(UNPACKED_MS),
          "ragged_shapes": [list(v) for v in RAGGED_SHAPES],
          "cim_matmul_raw_launches": launches, "raw_equals_packed": True})
    return {"launches": launches, "max_abs_err": err}


def doa_phase(torch, dev) -> dict:
    """Phase 16: MUSIC DoA through the complex lane on both arrays.
    Returns the kernels' launches on the path and the per-array record."""
    import numpy as np
    from repro_torch.core.complex_mac import quantize_complex
    from repro_torch.core.engine import pack_complex_cim_weights
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.ccim_matmul.ops import pad_k_int8
    from repro_torch.launch import doa

    def counts():
        return {"complex_unpacked": CK.ccim_complex_unpacked_cuda.launches,
                "complex_skinny":
                    CK.ccim_complex_prepacked_skinny_cuda.launches,
                "complex_general":
                    CK.ccim_complex_prepacked_general_cuda.launches,
                "skinny": K.ccim_matmul_prepacked_skinny_cuda.launches,
                "general": K.ccim_matmul_prepacked_general_cuda.launches,
                "unpacked": K.ccim_matmul_unpacked_cuda.launches}

    def reset():
        K.reset_launch_counts()
        CK.reset_launch_counts()

    launches = {"complex_unpacked": 0, "complex_skinny": 0,
                "complex_general": 0}
    records = {}
    for name, spec_kernel in DOA_ARRAYS:
        arr = doa.ARRAYS[name]
        n, ns = arr.n_sensors, arr.n_sources
        grid = doa.angle_grid(arr.grid_step)
        t0 = time.perf_counter()
        A = doa.steering(n, grid, dev)
        pack = pack_complex_cim_weights(A.real, A.imag)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(16)
        data = [doa.draw_frame(rng, arr) for _ in range(DOA_FRAMES)]
        Xs = [torch.from_numpy(x).to(dev) for _, x in data]
        doa.music_frame(Xs[0], pack, grid, ns)          # warm
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        frames = [doa.music_frame(X, pack, grid, ns) for X in Xs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want = {k: 0 for k in got}
        want.update({"complex_unpacked": DOA_FRAMES, spec_kernel: DOA_FRAMES})
        check(got == want, f"DoA {name}: launches {got}, expected {want}")
        for k in launches:
            launches[k] += got[k]
        reset()
        plain = [doa.music_frame(X, pack, grid, ns, use_kernel=False)
                 for X in Xs]
        check(all(v == 0 for v in counts().values()),
              f"DoA {name}: the plain run launched kernels {counts()}")
        for i, (fk, fp) in enumerate(zip(frames, plain)):
            check(_equal_pair(fk.r_int, fp.r_int) == 0,
                  f"DoA {name} frame {i}: covariance ints differ")
            check(fk.est == fp.est, f"DoA {name} frame {i}: estimates "
                  f"{fk.est} (kernels) != {fp.est} (plain)")
            check(bool(torch.isfinite(fk.p).all()) and fk.p.shape ==
                  (len(grid),), f"DoA {name} frame {i}: bad spectrum")
        est_sw = [doa.estimate(doa.software_spectrum(X, A, ns), grid, ns)
                  for X in Xs]
        err_cim = [doa.rmse(f.est, t) for f, (t, _) in zip(frames, data)]
        err_sw = [doa.rmse(e, t) for e, (t, _) in zip(est_sw, data)]
        rmse_pct = 100 * float(np.mean(err_cim)) / doa.FIELD_OF_VIEW
        check(rmse_pct < doa.RMSE_LIMIT_PCT,
              f"DoA {name}: RMSE {rmse_pct:.3f} % of the field of view")
        # the kernels' share of a frame: their CUDA-event times at the
        # frame's shapes (first frame's operands) over the frame's wall
        q_re, q_im, _ = quantize_complex(Xs[0], -1)
        kp = -(-n // 16) * 16
        T = arr.n_snapshots
        cov = [pad_k_int8(v, T, 1) for v in (q_re, q_im)] + [
            pad_k_int8(v, T, 0) for v in (q_re.t(), -q_im.t())]
        R, _ = doa.covariance(Xs[0])
        e_re, e_im, _ = quantize_complex(
            doa.noise_subspace(R, ns).conj().t(), -1)
        spec = ([pad_k_int8(v, kp, 1) for v in (e_re, e_im)]
                + [pack.re.kernel_w, pack.re.kernel_planes,
                   pack.im.kernel_w, pack.im.kernel_planes])
        spec_fn = (CK.ccim_complex_prepacked_general_cuda
                   if spec_kernel == "complex_general"
                   else CK.ccim_complex_prepacked_skinny_cuda)
        cov_fn = lambda: CK.ccim_complex_unpacked_cuda(*cov)
        cov_ms = cuda_ms(cov_fn, reps=50)
        cov_dev_ms = graph_ms(torch, cov_fn)
        cov_split = CK.complex_unpacked_k_split(n, n, T)
        spec_ms = cuda_ms(lambda: spec_fn(*spec), reps=50)
        frame_ms = 1e3 * wall / DOA_FRAMES
        # where a frame's time goes: a profiler trace of a few frames
        n_prof = 4
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for X in Xs[:n_prof]:
                doa.music_frame(X, pack, grid, ns)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0) / n_prof
        records[name] = {
            "n_sensors": n, "n_snapshots": T, "n_sources": ns,
            "grid_points": len(grid), "frames": DOA_FRAMES,
            "setup_s": setup_s, "frames_per_s": DOA_FRAMES / wall,
            "frame_ms": frame_ms, "covariance_kernel_ms": cov_ms,
            "covariance_kernel_device_ms": cov_dev_ms,
            "covariance_k_split": cov_split,
            "covariance_k_splits": -(-T // cov_split),
            "spectrum_kernel": spec_kernel, "spectrum_kernel_ms": spec_ms,
            "kernel_share_of_frame": (cov_ms + spec_ms) / frame_ms,
            "profile": {"frames": n_prof, "frame_wall_ms": prof_ms,
                        **device_breakdown(prof, n_prof, prof_ms)},
            "launches": got, "plain_equal": True,
            "rmse_cim_deg": float(np.mean(err_cim)),
            "rmse_pct_fov": rmse_pct,
            "rmse_software_deg": float(np.mean(err_sw)),
            "rmse_cim_vs_software_deg": float(np.mean(
                [doa.rmse(f.est, e) for f, e in zip(frames, est_sw)])),
            "first_frame": {"true": [float(v) for v in data[0][0]],
                            "cim": frames[0].est, "software": est_sw[0]}}
    emit({"phase": "doa", "ok": True, "arrays": records})
    return {"launches": launches, "arrays": records}


def _bound(nbytes: float, nops: float) -> dict:
    b, o = nbytes / HBM_BYTES_S, nops / INT8_OPS_S
    return {"bound_ms": 1e3 * max(b, o),
            "bound_by": "bytes" if b >= o else "operations",
            "bytes": nbytes, "ops": nops}


def _timing_case(torch, dev, name: str, m: int, k: int, n: int, gen):
    """Callables and counts for one phase-17 timing: the kernel, its plain
    version, the four-pass route through the port's real kernels (for
    kernel 6 the route it replaced: pack per call, then the prepacked
    kernel), a library yardstick, and the bytes and operations of the
    bound (each input read once, each output written once)."""
    from repro_torch.core.engine import pack_quantized_cim_weights
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K

    def ints8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    xr, xi, wr, wi = ints8(m, k), ints8(m, k), ints8(k, n), ints8(k, n)
    one = torch.ones((1, n), device=dev)
    real = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
            else K.ccim_matmul_prepacked_general_cuda)
    if name == "unpacked":
        def packed_route():
            p = pack_quantized_cim_weights(wr, one)
            return real(xr, p.kernel_w, p.kernel_planes)
        xl = torch.zeros((max(m, 32), k), dtype=torch.int8, device=dev)
        wl = wr.t().contiguous().t()           # column-major, as _int_mm takes
        return dict(kern=lambda: K.ccim_matmul_unpacked_cuda(xr, wr),
                    plain=lambda: K.ccim_matmul_unpacked_plain(xr, wr),
                    four=packed_route, lib=lambda: torch._int_mm(xl, wl),
                    nbytes=m * k + k * n + 4 * m * n, nops=6 * m * n * k)
    xc = torch.complex(xr.float(), xi.float())
    wc = torch.complex(wr.float(), wi.float())
    case = dict(lib=lambda: torch.matmul(xc, wc), nops=24 * m * n * k)
    if name == "complex_unpacked":
        pairs = ((xr, wr), (xi, wi), (xr, wi), (xi, wr))
        case.update(
            kern=lambda: CK.ccim_complex_unpacked_cuda(xr, xi, wr, wi),
            plain=lambda: CK.ccim_complex_unpacked_plain(xr, xi, wr, wi),
            four=lambda: [K.ccim_matmul_unpacked_cuda(a, b) for a, b in pairs],
            nbytes=2 * m * k + 2 * k * n + 8 * m * n)
        return case
    pr = pack_quantized_cim_weights(wr, one)
    pi = pack_quantized_cim_weights(wi, one)
    args = (xr, xi, pr.kernel_w, pr.kernel_planes, pi.kernel_w,
            pi.kernel_planes)
    fn = (CK.ccim_complex_prepacked_skinny_cuda if name == "complex_skinny"
          else CK.ccim_complex_prepacked_general_cuda)
    pairs = ((xr, pr), (xi, pi), (xr, pi), (xi, pr))
    case.update(
        kern=lambda: fn(*args),
        plain=lambda: CK.ccim_complex_prepacked_plain(*args),
        four=lambda: [real(a, p.kernel_w, p.kernel_planes) for a, p in pairs],
        nbytes=2 * m * k + 6 * k * n + 8 * m * n)
    return case


# phase 17: kernel -> the M values it is timed at (the last one is the
# kernels table's row)
TIMED_M = {"complex_skinny": (4,), "complex_general": (128,),
           "complex_unpacked": (4, 128), "unpacked": (4, 128)}


# kernels line: the instance of ccim_mma.cuh each tensor-core row runs
TEMPLATE_DESIGN = {
    "complex_general": "ccim_mma.cuh general_kernel<16, 2, PackedFill, 2>: "
                       "int8 mma.sync, two sides, prepacked fill",
    "unpacked": "ccim_mma.cuh general_kernel<16, 2, RawFill, 1>: int8 "
                "mma.sync, one side, raw-weight fill",
    "complex_unpacked": "ccim_mma.cuh general_kernel<16, 2, RawFill, 2>: "
                        "int8 mma.sync, two sides, raw fill of Re and Im "
                        "side by side, K split over the card"}


def times_complex(torch, dev, gen) -> dict:
    """Phase 17: CUDA-event medians of kernels 4-7 at the full-width
    shapes, summed over one layer's four GEMMs, beside the plain version,
    the four-pass route, a library yardstick (a different function) and
    the bound.  Returns the kernels table's rows by kernel."""
    rows, by_kernel = {}, {}
    keys = ("ms", "device_ms", "plain_ms", "four_pass_ms",
            "four_pass_device_ms", "library_ms", "library_device_ms",
            "bytes", "ops")
    for name, ms_ in TIMED_M.items():
        for m in ms_:
            tot = dict.fromkeys(keys, 0.0)
            shapes = {}
            for sname, (k, n) in FULL_SHAPES.items():
                c = _timing_case(torch, dev, name, m, k, n, gen)
                t = dict(ms=cuda_ms(c["kern"], reps=20),
                         device_ms=graph_ms(torch, c["kern"]),
                         plain_ms=cuda_ms(c["plain"], reps=3, warmup=1),
                         four_pass_ms=cuda_ms(c["four"], reps=10),
                         # the pack-per-call route is not graph-captured
                         four_pass_device_ms=(
                             graph_ms(torch, c["four"])
                             if name != "unpacked" else 0.0),
                         library_ms=cuda_ms(c["lib"], reps=20),
                         library_device_ms=graph_ms(torch, c["lib"]),
                         bytes=c["nbytes"], ops=c["nops"])
                shapes[sname] = dict(t, **_bound(c["nbytes"], c["nops"]))
                for key in keys:
                    tot[key] += t[key]
            tot.update(_bound(tot["bytes"], tot["ops"]))
            if name == "unpacked":
                tot["four_pass_device_ms"] = None
            by_kernel[f"{name} M={m}"] = {"layer_total": tot,
                                          "shapes": shapes}
            rows[name] = dict(tot, m=m)
    emit({"phase": "times_complex", "by_kernel": by_kernel,
          "timing": TIMING,
          "library": {
              "complex": "torch.matmul on complex64 (no macro arithmetic; a "
                         "yardstick the port never calls)",
              "unpacked": "torch._int_mm at M >= 32 (int8 GEMM without the "
                          "per-chunk clip; a yardstick)"},
          "four_pass": {
              "complex": "four launches of the port's real kernel on the "
                         "same operands (prepacked skinny/general, or "
                         "unpacked)",
              "unpacked": "the route the unpacked kernel replaced: pack the "
                          "raw weights per call, then the prepacked kernel"}})
    return rows

def int8_kernel(torch, dev, gen) -> float:
    """Phase 18: the W8A8 kernel against its plain version.  Returns the
    largest |kernel - plain| (0 when equal)."""
    import itertools
    from repro_torch.kernels.int8_matmul import kernel as IK
    from repro_torch.kernels.int8_matmul import ops as IO

    shapes = [(m, k, n) for (k, n) in FULL_SHAPES.values()
              for m in (1, 4, 32, 128, 256, 512)]
    shapes += list(itertools.product((5, 33), (100, 2304), (17, 2304)))
    err = 0.0
    for (m, k, n), dt in itertools.product(shapes, (torch.float32,
                                                    torch.bfloat16)):
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = torch.randn((k, n), generator=gen, device=dev).to(dt)
        IK.reset_launch_counts()
        y_k = IO.int8_matmul(x, w)
        n_k = IK.int8_w8a8_cuda.launches
        y_p = IO.int8_matmul(x, w, use_kernel=False)
        torch.cuda.synchronize()
        check(n_k == 1 and IK.int8_w8a8_cuda.launches == 1,
              f"W8A8 at {(m, k, n)} {dt}: {n_k} kernel launches, then "
              f"{IK.int8_w8a8_cuda.launches - n_k} from the plain run")
        e = float((y_k - y_p).abs().max())
        err = max(err, e)
        check(y_k.dtype == torch.float32 and torch.equal(y_k, y_p)
              and bool(torch.isfinite(y_k).all()),
              f"W8A8 kernel != plain at {(m, k, n)} {dt}: max |diff| {e}")
    emit({"phase": "int8_kernel", "ok": True, "cases": 2 * len(shapes),
          "shapes": [list(v) for v in shapes], "dtypes": ["float32",
                                                          "bfloat16"],
          "compare": "torch.equal on float32 outputs",
          "launches_per_call": 1, "max_abs_err": err})
    return err


def _all_launches():
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.int8_matmul import kernel as IK
    from repro_torch.kernels.paged_attn import kernel as PK
    return {"skinny": K.ccim_matmul_prepacked_skinny_cuda.launches,
            "general": K.ccim_matmul_prepacked_general_cuda.launches,
            "unpacked": K.ccim_matmul_unpacked_cuda.launches,
            "complex_skinny": CK.ccim_complex_prepacked_skinny_cuda.launches,
            "complex_general": CK.ccim_complex_prepacked_general_cuda.launches,
            "complex_unpacked": CK.ccim_complex_unpacked_cuda.launches,
            "paged_attn": PK.paged_attention_cuda.launches,
            "int8": IK.int8_w8a8_cuda.launches}


def _reset_all_launches():
    from repro_torch.kernels.ccim_complex import kernel as CK
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.kernels.int8_matmul import kernel as IK
    from repro_torch.kernels.paged_attn import kernel as PK
    for mod in (K, CK, IK, PK):
        mod.reset_launch_counts()


def kernel_bench_phase(torch, dev) -> dict:
    """Phase 19: the kernel bench twin at card scale.  Its rows raise on
    a parity failure and below the decode floor.  Returns the launches
    of every kernel in the run."""
    from repro_torch.launch import kernel_bench
    rows = []
    _reset_all_launches()
    t0 = time.time()
    kernel_bench.run(seed=0, device=dev, scale="card", emit=rows.append)
    torch.cuda.synchronize()
    launches = _all_launches()
    # the rows that reach each kernel on the card
    for name in ("int8", "skinny", "unpacked", "complex_unpacked",
                 "complex_skinny"):
        check(launches[name] > 0, f"kernel bench: the {name} kernel was "
              f"launched no time ({launches})")
    by_op = {}
    for r in rows:
        by_op.setdefault(r["op"], []).append(r)
    noisy = {}
    for op in ("bit_true_emulation", "fast_emulation"):
        note = by_op[op][0]["note"]
        err = float(re.search(r"max FS-rel err ([0-9.]+)", note).group(1))
        check("analog noise of the reference's key" in note and 0 < err
              < 0.02, f"kernel bench {op}: {note}")
        noisy[op] = {"us": by_op[op][0]["us"], "max_fs_rel_err": err}
    floor = by_op["decode_gemm_prepacked"][0]["speedup_vs_prev"]
    check(floor >= kernel_bench.DECODE_SPEEDUP_FLOOR,
          f"decode floor {floor} < {kernel_bench.DECODE_SPEEDUP_FLOOR}")
    emit({"phase": "kernel_bench", "ok": True, "scale": "card",
          "seconds": time.time() - t0, "launches": launches,
          "decode_speedup": floor,
          "decode_floor": kernel_bench.DECODE_SPEEDUP_FLOOR,
          "noisy_rows": noisy,
          "rows": [{k: r[k] for k in ("op", "shape", "us",
                                      "speedup_vs_prev")} for r in rows],
          "notes": {r["op"]: r["note"] for r in rows}})
    return {"launches": launches}


def fig6_phase(torch, dev) -> dict:
    """Phase 20: the Fig. 6 twin on the card at 1,048,576 conversions,
    the same seed on the CPU, and the reference's 16,384 as a prefix."""
    from repro_torch.core.ccim import DEFAULT_CONFIG, hybrid_mac_bit_true
    from repro_torch.launch import fig6_rms
    rows = []
    seed = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fig6_rms.run(seed=seed, device=dev, emit=rows.append)
    n = out["n"]
    check(n == fig6_rms.CARD_N, f"fig6 ran {n} conversions on the card")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 8 * 2 ** 30, f"fig6 peak device memory {peak} >= 8 GB")
    xq, wq, macro, _, key = fig6_rms.conversions(seed, n, DEFAULT_CONFIG,
                                                 dev)
    bit_true_ms = {
        "noisy": cuda_ms(lambda: hybrid_mac_bit_true(
            xq, wq, macro, DEFAULT_CONFIG, key), reps=5),
        "noise_free": cuda_ms(lambda: hybrid_mac_bit_true(
            xq, wq, macro, DEFAULT_CONFIG), reps=5)}
    del xq, wq
    # the draws are partitionable, so the card's first FIG6_CPU_N
    # conversions are a CPU run of that size, codes and all
    t0 = time.time()
    ys_cpu = fig6_rms.evaluate(*fig6_rms.conversions(seed, FIG6_CPU_N,
                                                     DEFAULT_CONFIG),
                               DEFAULT_CONFIG)
    cpu_s = time.time() - t0
    head = {k: v[:FIG6_CPU_N].cpu() for k, v in out["ys"].items()}
    differ = {k: int((head[k] != ys_cpu[k]).sum())
              for k in ("this_work", "floor", "all_analog", "this_die",
                        "exact")}
    check(all(v == 0 for v in differ.values()),
          f"fig6: card and CPU codes differ {differ} (of {FIG6_CPU_N})")
    rms_cpu = fig6_rms.rows(ys_cpu, DEFAULT_CONFIG)
    check(rms_cpu == fig6_rms.rows(head, DEFAULT_CONFIG),
          f"fig6 RMS of the first {FIG6_CPU_N}: card != CPU {rms_cpu}")
    for v in out["rms"].values():
        check(0 < v < 2, f"fig6 RMS out of range: {out['rms']}")
    # the reference's run is the first REF_N conversions of the card's
    m = fig6_rms.REF_N
    ys_ref = fig6_rms.evaluate(*fig6_rms.conversions(seed, m, DEFAULT_CONFIG),
                               DEFAULT_CONFIG)
    prefix = {k: v[:m].cpu() for k, v in out["ys"].items()}
    check(all(torch.equal(prefix[k], ys_ref[k]) for k in ys_ref),
          "fig6: the card's first 16,384 conversions differ from a CPU run "
          "of that size")
    rms_ref = fig6_rms.rows(prefix, DEFAULT_CONFIG)
    printed = {k: f"{rms_ref[k]:.3f}" for k in ("this_work", "floor",
                                                 "all_analog")}
    check(printed == {"this_work": "0.408", "floor": "0.226",
                      "all_analog": "0.339"},
          f"fig6: the reference-size prefix gives {printed}, not the "
          "reference's 0.408 / 0.226 / 0.339 %")
    emit({"phase": "fig6", "ok": True, "n": n, "seed": seed,
          "rms_pct": out["rms"], "rms_pct_first_16384": rms_ref,
          "card_us": out["us"], "bit_true_ms_2e20": bit_true_ms,
          "cpu_seconds": cpu_s, "cpu_check_n": FIG6_CPU_N,
          "peak_device_bytes": peak,
          "codes_differing_card_vs_cpu": differ,
          "rows": {r["name"]: r.get("value") for r in rows}})
    return out


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed (host dispatch is out of the timed span)."""
    return graph_rotation_ms(torch, [fn], reps)


def graph_rotation_ms(torch, fns, reps: int = 20) -> float:
    """Device milliseconds per call of a rotation over ``fns`` (each on
    its own operands): call i goes to ``fns[i % len(fns)]``, at least
    ``reps`` calls in whole rotations, captured in one CUDA graph and
    replayed.  When the rotation's bytes exceed the L2, no call finds its
    weights there (``device_cold_ms``)."""
    calls = len(fns) * -(-reps // len(fns))
    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return statistics.median(times)


def cold_copy_count(torch, dev, nbytes: int) -> int:
    """Distinct weight copies of ``nbytes`` each for a cold rotation: at
    least 4, and at least 4 L2s of bytes."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) or 50 * 2 ** 20
    return max(4, -(-4 * l2 // nbytes))


def cold_copies(torch, dev, gen, n_planes: int = 2) -> dict:
    """Per full-width shape, distinct random int8 (w, planes) operands for
    cold timings: at least 4 copies and at least 4 L2s of bytes per shape
    (1 GB over a layer's four shapes on a 50 MB L2), each (N, Kp) w with
    planes in [-7, 7] (the time does not depend on the values)."""
    out = {}
    for sname, (k, n) in FULL_SHAPES.items():
        copies = cold_copy_count(torch, dev, (1 + n_planes) * n * k)
        out[sname] = [(torch.randint(-127, 128, (n, k), generator=gen,
                                     device=dev, dtype=torch.int8),
                       torch.randint(-7, 8, (n_planes, n, k), generator=gen,
                                     device=dev, dtype=torch.int8))
                      for _ in range(copies)]
    return out


COLD = ("device_cold_ms and library_cold_ms: device time per call from "
        "CUDA-graph replays rotating over distinct copies of the weights "
        "(of the KV pools for the paged read) "
        "(at least 4 per shape and 4 L2s of bytes), so no call finds its "
        "weights in L2, as in a decode step over 40 distinct layers")


def times_skinny(torch, dev, packs, meta, smf_ints) -> dict:
    """Phase 7, kernel row 1: per M of SKINNY_MS, one layer's four
    full-width GEMMs timed per call (``ms``), on the same operands
    (``device_ms``, the earlier timing) and cold (``device_cold_ms``),
    beside the plain version, torch._int_mm at max(M, 32) (same-operand
    and cold) and the bound.  Returns the kernels table's row at M 4 with
    every M in ``by_m``."""
    from repro_torch.kernels.ccim_matmul import kernel as K
    n_j = len(meta["x_bits"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    copies = cold_copies(torch, dev, gen, n_j)
    keys = ("ms", "device_ms", "device_cold_ms", "plain_ms", "library_ms",
            "library_device_ms", "library_cold_ms", "bound_ms", "bytes",
            "ops")
    by_m = {}
    for m in SKINNY_MS:
        tot = dict.fromkeys(keys, 0.0)
        shapes = {}
        for sname, (k, n) in FULL_SHAPES.items():
            p = packs[sname]
            kp = p.kernel_w.shape[1]
            x = smf_ints((m, kp)).to(torch.int8)
            w, planes = p.kernel_w, p.kernel_planes
            kern = lambda: K.ccim_matmul_prepacked_skinny_cuda(
                x, w, planes, **meta)
            cold = [lambda c=c: K.ccim_matmul_prepacked_skinny_cuda(
                x, c[0], c[1], **meta) for c in copies[sname]]
            # torch._int_mm: int8 GEMM without the per-chunk clip, M >= 17
            xi = torch.zeros((max(m, 32), kp), dtype=torch.int8, device=dev)
            lib_fn = lambda: torch._int_mm(xi, w.t())
            lib_cold = [lambda c=c: torch._int_mm(xi, c[0].t())
                        for c in copies[sname]]
            nbytes = m * kp + (1 + n_j) * n * kp + 4 * m * n
            nops = 2 * m * n * kp * (1 + n_j)
            t = dict(ms=cuda_ms(kern, reps=30),
                     device_ms=graph_ms(torch, kern),
                     device_cold_ms=graph_rotation_ms(torch, cold),
                     plain_ms=cuda_ms(lambda: K.ccim_matmul_prepacked_plain(
                         x, w, planes, **meta), reps=5),
                     library_ms=cuda_ms(lib_fn, reps=30),
                     library_device_ms=graph_ms(torch, lib_fn),
                     library_cold_ms=graph_rotation_ms(torch, lib_cold),
                     bytes=nbytes, ops=nops)
            t.update(_bound(nbytes, nops))
            t.update(k=k, n=n, copies=len(copies[sname]),
                     k_split=K.skinny_k_split(m, n, kp, meta["acc_len"]))
            shapes[sname] = t
            for key in keys:
                tot[key] += t[key]
        tot.update(_bound(tot["bytes"], tot["ops"]))
        by_m[m] = {"layer_total": tot, "shapes": shapes}
    emit({"phase": "times_skinny", "by_m": by_m, "timing": TIMING,
          "cold": COLD, "library": "torch._int_mm at max(M, 32) (a "
          "yardstick the port never calls; one weight byte where the "
          "kernel reads three)"})
    del copies
    row = dict(by_m[4]["layer_total"], m=4)
    row["by_m"] = {m: {k: v["layer_total"][k] for k in
                       ("ms", "device_ms", "device_cold_ms", "plain_ms",
                        "library_ms", "library_device_ms", "library_cold_ms",
                        "bound_ms")}
                   for m, v in by_m.items()}
    return row


def general_int_ops(m: int, n: int, kp: int, acc_len: int,
                    n_planes: int) -> int:
    """Integer ops of the general macro GEMM besides its MMAs: 4 per
    conversion (shift, max, add-min, add) and 4 + 4 n_planes per 4
    activation bytes for the bit-planes, once per 128-column block."""
    return (4 * m * n * kp // acc_len
            + (4 + 4 * n_planes) * m * kp // 4 * -(-n // 128))


# (acc_len, n_planes) of the general kernel's design sweep: the prototype
# (16, 2) first
SWEEP = ((16, 2), (16, 0), (16, 1), (16, 3), (8, 2), (32, 2), (64, 2))


def general_design_sweep(torch, dev, m: int) -> dict:
    """Device ms per full-width layer of the general kernel at M ``m`` for
    each (acc_len, n_planes) of SWEEP, on random SMF ints, w and planes
    (the time does not depend on the values): same shapes and bytes of x
    and w, while the conversions scale with 1 / acc_len and the plane
    MMAs, plane bytes and bit-plane ops with n_planes."""
    from repro_torch.kernels.ccim_matmul import kernel as K
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    i8 = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)
    data = {s: (i8(-127, 128, m, k), i8(-127, 128, n, k), i8(-7, 8, 3, n, k))
            for s, (k, n) in FULL_SHAPES.items()}
    out = {}
    for acc, n_planes in SWEEP:
        meta = dict(acc_len=acc, x_bits=(6, 5, 4)[:n_planes],
                    dcim_lsb=2048, adc_half=64)
        by_shape, iops = {}, 0
        for sname, (k, n) in FULL_SHAPES.items():
            x, w, planes = data[sname]
            planes = planes[:n_planes].contiguous()
            by_shape[sname] = graph_ms(torch, lambda: (
                K.ccim_matmul_prepacked_general_cuda(x, w, planes, **meta)))
            iops += general_int_ops(m, n, k, acc, n_planes)
        out[f"acc{acc}_planes{n_planes}"] = dict(
            acc_len=acc, n_planes=n_planes,
            device_ms=sum(by_shape.values()), by_shape=by_shape,
            int_ops=iops, conversions=sum(m * n * k // acc for k, n
                                          in FULL_SHAPES.values()))
    return out


INT8_DESIGN = ("TMA + mbarrier ring (128-byte swizzle) feeding wgmma "
               "m64nTOKk32 s8: weights the 64-row operand, tokens its N "
               "(8-128, tiles of 128 over the grid above); one producer "
               "warp, two consumer warpgroups of 64 weight rows; K split "
               "over a thread-block cluster whose int32 partial tiles "
               "meet in distributed shared memory; dequant epilogue with "
               "16-byte stores")


def _int8_plan_record(p) -> dict:
    return {"tok": p.tok, "m_tiles": p.m_tiles, "n_tiles": p.n_tiles,
            "k_stages": p.k_stages, "splits": p.splits, "cluster": p.splits,
            "per_split": p.per_split, "ring": p.ring, "blocks": p.blocks}


def int8_plan_sweep(torch, IK, xq, sx, copies, m: int, k: int,
                    n: int) -> dict:
    """Cold device ms of one full-width shape under other plans than
    ``plan``'s, keyed ``t{tok}_s{splits}_r{ring}_b{blocks}``: the plan's
    token width (and 64 above M 64), K in 1, 2, 3, 4 or 8 slices, and a
    ring of the depth two blocks an SM allow or the deepest one block
    allows (227 KB)."""
    import dataclasses
    base = IK.plan(m, n, k, IK.sm_count(xq.device))
    out = {}
    for tok in sorted({base.tok, IK.FEW_TILES_TOK} if m > IK.FEW_TILES_TOK
                      else {base.tok}):
        stage = (IK.BN + tok) * IK.K_STAGE
        rings = {IK.plan(tok, n, k, IK.sm_count(xq.device)).ring,
                 min(12, (232448 - 1024 - 4 * (tok + IK.BN)) // (stage + 16))}
        for splits in (1, 2, 3, 4, 8):
            per = -(-base.k_stages // splits)
            for ring in sorted(rings):
                p = dataclasses.replace(
                    base, tok=tok, m_tiles=-(-m // tok), ring=ring,
                    splits=-(-base.k_stages // per), per_split=per)
                key = f"t{tok}_s{p.splits}_r{ring}_b{p.blocks}"
                if key not in out:
                    out[key] = graph_rotation_ms(torch, [
                        lambda c=c: IK._launch(xq, c[0], sx, c[1], p)
                        for c in copies])
    return out


def times_int8(torch, dev, gen) -> dict:
    """Phase 21: kernel 8 per layer at M 4 and 128, same-operand and
    cold, with its plan per shape and a plan sweep.  Returns the kernels
    table's row (at M 128) with both M in ``by_m``."""
    from repro_torch.kernels.int8_matmul import kernel as IK
    keys = ("ms", "device_ms", "device_cold_ms", "plain_ms", "library_ms",
            "library_device_ms", "library_cold_ms", "bytes", "ops")
    copies = {}
    for sname, (k, n) in FULL_SHAPES.items():
        copies[sname] = [
            (torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8),
             torch.rand(n, generator=gen, device=dev) + 0.5)
            for _ in range(cold_copy_count(torch, dev, n * k))]
    by_m = {}
    for m in (4, 128):
        tot = dict.fromkeys(keys, 0.0)
        shapes = {}
        for sname, (k, n) in FULL_SHAPES.items():
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            wt, sw = copies[sname][0]
            sx = torch.rand(m, generator=gen, device=dev) + 0.5
            ml = max(m, 32)                  # torch._int_mm needs M > 16
            xl = torch.randint(-127, 128, (ml, k), generator=gen, device=dev,
                               dtype=torch.int8)
            sxl = torch.rand(ml, generator=gen, device=dev) + 0.5

            def lib(w=wt, s=sw):
                acc = torch._int_mm(xl, w.t()).to(torch.float32)
                return acc * sxl[:, None] * s[None, :]
            kern = lambda: IK.int8_w8a8_cuda(xq, wt, sx, sw)
            t = dict(ms=cuda_ms(kern, reps=30),
                     device_ms=graph_ms(torch, kern),
                     device_cold_ms=graph_rotation_ms(torch, [
                         lambda c=c: IK.int8_w8a8_cuda(xq, c[0], sx, c[1])
                         for c in copies[sname]]),
                     plain_ms=cuda_ms(lambda: IK.int8_w8a8_plain(
                         xq, wt, sx, sw), reps=5, warmup=1),
                     library_ms=cuda_ms(lib, reps=30),
                     library_device_ms=graph_ms(torch, lib),
                     library_cold_ms=graph_rotation_ms(torch, [
                         lambda c=c: lib(*c) for c in copies[sname]]),
                     bytes=m * k + k * n + 4 * (m + n) + 4 * m * n,
                     ops=2 * m * k * n)
            shapes[sname] = dict(
                t, **_bound(t["bytes"], t["ops"]), copies=len(copies[sname]),
                plan=_int8_plan_record(IK.plan(m, n, k, IK.sm_count(dev))),
                sweep=int8_plan_sweep(torch, IK, xq, sx, copies[sname], m,
                                      k, n))
            for key in tot:
                tot[key] += t[key]
        tot.update(_bound(tot["bytes"], tot["ops"]))
        by_m[m] = {"layer_total": tot, "shapes": shapes}
    del copies
    emit({"phase": "times_int8", "by_m": by_m, "timing": TIMING,
          "cold": COLD, "design": INT8_DESIGN,
          "library": "torch._int_mm + float32 convert + the two dequant "
                     "multiplies, at M >= 32 (a yardstick the port never "
                     "calls)"})
    row = dict(by_m[128]["layer_total"], m=128)
    row["by_m"] = {m: {k: v["layer_total"][k] for k in
                       ("ms", "device_ms", "device_cold_ms", "plain_ms",
                        "library_ms", "library_device_ms", "library_cold_ms",
                        "bound_ms")}
                   for m, v in by_m.items()}
    return row


# -- phases 22-24: deployment plans and speculative decoding ---------------

# phase 23's cases: (batch, prompt, generated tokens, draft depth k); the
# verify forward runs batch * (k + 1) rows: 18 on kernel row 1, 36 on row 2
SPEC_CASES = ((2, 16, 12, 8), (4, 16, 12, 8))
# phase 26's turns (its second round of turns was cut for time)
SPEC_TURNS = ("lockstep", "speculative")


def mixed_plan():
    """Phase 22's plan: an all-analog site at an 8-bit ADC, a hybrid5
    site, an all-digital site, a float site and a hybrid3 / 8 b / L32
    default (the reference's mixed plan of its plan tests)."""
    from repro_torch import plan as TP
    from repro_torch.core.ccim import CCIMConfig
    return TP.DeploymentPlan.from_dict({
        "mlp/w2": TP.DIGITAL_ENTRY,
        "attn/wq": TP.PlanEntry(cfg=CCIMConfig(n_dcim_products=0, adc_bits=8),
                                label="analog0/adc8"),
        "attn/wo": TP.PlanEntry(cfg=CCIMConfig(n_dcim_products=5, adc_bits=8),
                                label="hybrid5/adc8"),
        "mlp/w3": TP.FLOAT_ENTRY,
    }, default=TP.PlanEntry(cfg=CCIMConfig(acc_len=32, adc_bits=8),
                            label="hybrid3/adc8/L32"))


def _tokens_equal(a, b) -> bool:
    return len(a) == len(b) and bool((a == b).all())


def _macro_launches() -> dict:
    from repro_torch.kernels.ccim_matmul import kernel as K
    return {"general": K.ccim_matmul_prepacked_general_cuda.launches,
            "skinny": K.ccim_matmul_prepacked_skinny_cuda.launches}


def plan_phase(torch, dev, params, cfg_full, uniform: dict) -> dict:
    """Phase 22: lock-step serving under ``mixed_plan`` through the
    kernels and their plain versions.  Returns the kernel run (tokens,
    last logits, launches, stats)."""
    from repro_torch.core.engine import FusedPackedCimWeights, PackedCimWeights
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.serve import serve, tree_bytes
    from repro_torch.models import lm

    plan = mixed_plan()
    batch, plen, gen = 4, 32, 16
    runs = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        toks, st = serve("minicpm-2b", smoke=False, batch=batch,
                         prompt_len=plen, gen=gen, plan=plan, params=params,
                         use_kernel=use_kernel, return_stats=True)
        runs[label] = dict(toks=toks, logits=st.pop("last_logits"),
                           launches=_macro_launches(), stats=st,
                           peak=torch.cuda.max_memory_allocated())
        check(bool(torch.isfinite(runs[label]["logits"]).all()),
              f"phase 22 {label}: non-finite logits")
    kr, pr = runs["kernel"], runs["plain"]
    n_gemm = 4 * cfg_full.n_layers           # wq, wk+wv, wo, w1
    check(kr["launches"] == {"general": n_gemm,
                             "skinny": n_gemm * (gen - 1)},
          f"phase 22 launches {kr['launches']}, expected {n_gemm} general "
          f"and {n_gemm * (gen - 1)} skinny")
    check(pr["launches"] == {"general": 0, "skinny": 0},
          "phase 22: the plain run launched kernels")
    check((kr["toks"] == pr["toks"]).all(),
          "phase 22: kernel and plain tokens differ under the plan")
    check(torch.equal(kr["logits"], pr["logits"]),
          "phase 22: kernel and plain logits differ under the plan")
    # what each site of a layer holds under the plan
    cfg = dataclasses.replace(cfg_full, cim_mode=True, cim_plan=plan)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    sites = {}
    for block in ("attn", "mlp"):
        for key, leaf in packed["layers"][block].items():
            pk = (leaf.packed if isinstance(leaf, FusedPackedCimWeights)
                  else leaf)
            rec = {"bytes": tree_bytes(leaf)}
            if isinstance(pk, PackedCimWeights):
                first = key.split("+")[0]
                rec.update(kind="packed",
                           planes=int(pk.kernel_planes.shape[1]),
                           n_dcim=pk.cfg.n_dcim_products,
                           acc_len=pk.cfg.acc_len,
                           entry=plan.resolve(f"{block}/{first}").label)
            else:
                rec.update(kind=str(leaf.dtype))
            sites[f"{block}/{key}"] = rec
    del packed
    check(sites["mlp/w3"]["kind"] == "torch.bfloat16",
          "phase 22: the float site w3 was packed")
    check(sites["attn/wq"]["planes"] == 0, "phase 22: wq holds planes")
    emit({"phase": "serve_plan", "ok": True, "plan": plan.summary(),
          "batch": batch, "prompt_len": plen, "gen": gen,
          "tokens_equal": True, "logits_equal": True,
          "launches": kr["launches"], "plain_launches": pr["launches"],
          "sites_per_layer_stack": sites,
          "pack_bytes": kr["stats"]["pack_bytes"],
          "uniform_pack_bytes": uniform["pack_bytes"],
          "max_memory_allocated": kr["peak"],
          "uniform_max_memory_allocated": uniform["max_memory_allocated"],
          "pack_s": kr["stats"]["pack_s"],
          "prefill_s": kr["stats"]["prefill_s"],
          "decode_tok_s": kr["stats"]["decode_tok_s"],
          "plain_decode_tok_s": pr["stats"]["decode_tok_s"],
          "tokens_row0": kr["toks"][0].tolist()})
    return kr


def verify_chain_diff(torch, dev, packed, cfg, prompt, toks, start: int,
                      k: int) -> float:
    """Largest |verify logit - decode-chain logit| over the k + 1
    positions from ``start`` of ``toks``, after the prompt and
    ``toks[:, :start]`` were committed by decode steps."""
    from repro_torch.models import lm
    B = prompt.shape[0]
    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, prompt.shape[1] + toks.shape[1]
                              + 2 * k + 1, device=dev)
        _, cache = lm.prefill(packed, cfg, prompt, cache)
        for i in range(start):
            _, cache = lm.decode_step(packed, cfg, toks[:, i:i + 1], cache)
        clone = {n: v.clone() for n, v in cache.items()}
        block = toks[:, start:start + k + 1]
        chain = []
        for i in range(block.shape[1]):
            lg, cache = lm.decode_step(packed, cfg, block[:, i:i + 1], cache)
            chain.append(lg[:, -1])
        vlg, _ = lm.verify_step(packed, cfg, block, clone)
    return float((vlg - torch.stack(chain, 1)).abs().max())


def speculative_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 23: plan-cascade speculative decoding at full width, kernel
    and plain, against lock-step serving (one turn each).  Returns the
    kernel runs' launches by case."""
    import numpy as np
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.serve import serve, serve_speculative
    from repro_torch.models import lm

    L = cfg_full.n_layers
    out = {}
    for batch, plen, gen, k in SPEC_CASES:
        m = batch * (k + 1)
        common = dict(smoke=False, batch=batch, prompt_len=plen, gen=gen,
                      params=params, return_stats=True, graphs=False)
        tok_s = {"lockstep": [], "speculative": []}
        for turn in ("lockstep", "speculative"):
            if turn == "lockstep":
                base, st = serve("minicpm-2b", cim=True, **common)
            else:
                K.reset_launch_counts()
                spec, sst = serve_speculative("minicpm-2b", draft_k=k,
                                              compare_baseline=False,
                                              **common)
                launches = _macro_launches()
                st = sst
            tok_s[turn].append(st["decode_tok_s"])
        K.reset_launch_counts()
        plain, pst = serve_speculative("minicpm-2b", draft_k=k,
                                       compare_baseline=False,
                                       use_kernel=False, **common)
        check(_macro_launches() == {"general": 0, "skinny": 0},
              "phase 23: the plain run launched kernels")
        check(plain.shape == spec.shape and (plain == spec).all(),
              f"phase 23 (M {m}): kernel and plain speculative tokens differ")
        rounds = sst["n_rounds"]
        row = lambda rows: "skinny" if rows <= K.SKINNY_M else "general"
        want = {"general": 0, "skinny": 4 * L * k * rounds}
        want[row(batch * plen)] += 4 * L                    # prefill
        want[row(m)] += 4 * L * rounds                      # verify
        check(launches == want, f"phase 23 (M {m}): launches {launches}, "
              f"expected {want} (a prefill at M {batch * plen}, {rounds} "
              f"rounds of {k} drafts + a verify)")
        same = [bool((spec[b] == base[b]).all()) for b in range(batch)]
        diverge = np.argwhere(spec != base)
        rec = {"batch": batch, "prompt_len": plen, "gen": gen, "draft_k": k,
               "prefill_m": batch * plen, "verify_m": m,
               "verify_row": 1 if m <= K.SKINNY_M else 2,
               "draft_plan": sst["draft_plan"], "n_rounds": rounds,
               "n_drafted": sst["n_drafted"], "n_accepted": sst["n_accepted"],
               "acceptance_rate": sst["acceptance_rate"],
               "tokens_per_round": sst["tokens_per_round"],
               "launches": launches,
               "launches_per_round": {
                   "skinny": 4 * L * (k + (m <= K.SKINNY_M)),
                   "general": 4 * L * (m > K.SKINNY_M)},
               "decode_tok_s_turns": ["lockstep", "speculative"],
               "speculative_decode_tok_s": tok_s["speculative"],
               "lockstep_decode_tok_s": tok_s["lockstep"],
               "plain_speculative_decode_tok_s": pst["decode_tok_s"],
               "kernel_equals_plain": True,
               "rows_equal_lockstep": f"{sum(same)} of {batch}"}
        # the verify contract at full width: logits of the first round's
        # positions, verify forward against the decode chain
        cfg = dataclasses.replace(cfg_full, cim_mode=True)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=plen,
                          global_batch=batch, seed=0)
        prompt = torch.from_numpy(batch_at(dcfg, 0)["tokens"]).to(
            dev, torch.int64)
        with torch.inference_mode():
            packed = lm.pack_cim_params(params, cfg, dev)
        btoks = torch.from_numpy(base).to(dev)
        start = int(diverge[0, 1]) if len(diverge) else 0
        start = max(0, min(start - 1, gen - k - 1))
        rec["verify_chain_window"] = [start, start + k + 1]
        rec["verify_chain_max_abs_logit_diff"] = verify_chain_diff(
            torch, dev, packed, cfg, prompt, btoks, start, k)
        if len(diverge):
            rec["first_differing_row_position"] = diverge[0].tolist()
        check(not len(diverge), f"phase 23 (M {m}): speculative tokens "
              f"differ from lock-step: {rec}")
        del packed
        out[f"serve_speculative_m{m}"] = launches
        emit({"phase": "serve_speculative", "ok": True, **rec})
    return out


def continuous_speculative_phase(torch, dev, params, cfg_full,
                                 serve_phases) -> dict:
    """Phase 24: speculative rounds in the continuous-batching scheduler,
    contiguous (gated against phase 9) and paged (reported against phase
    10).  Returns the macro kernels' launches by path and the paged
    read's."""
    from repro_torch.kernels.paged_attn import kernel as PK
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.serve import serve_continuous

    slots, plen, stops, k = 8, 64, (8, 24, 16, 32), 4      # phase 9's
    common = dict(smoke=False, slots=slots, prompt_len=plen,
                  stop_lengths=stops, cim=True, params=params, device=dev,
                  draft_k=k, adaptive_draft_k=True)

    def reset():
        K.reset_launch_counts()
        PK.reset_launch_counts()

    reset()
    toks, st = serve_continuous("minicpm-2b", n_requests=SPEC_REQUESTS,
                                compare_lockstep=True, **common)
    n_c = {**_macro_launches(), "paged_attn": PK.paged_attention_cuda.launches}
    want = serve_phases["tokens_contiguous"]
    same = [_tokens_equal(toks[r], want[r]) for r in toks]
    check(st.get("tokens_match_lockstep") is True,
          "phase 24: speculative pool tokens != lock-step tokens")
    check(st["continuous"]["n_admits"] > slots,
          "phase 24: no slot was refilled")
    check(all(same), f"phase 24: speculative pool tokens equal phase 9's on "
          f"{sum(same)} of {len(same)} requests")
    check(n_c["paged_attn"] == 0, "phase 24: the contiguous pool launched "
          "the paged read")
    emit({"phase": "serve_continuous_speculative", "ok": True,
          "requests": SPEC_REQUESTS, "draft_k": k, "adaptive_draft_k": True,
          "draft_plan": st["draft_plan"], "draft_steps": st["draft_steps"],
          "tokens_equal_phase9": True, "tokens_equal_lockstep": True,
          "launches": n_c, **_serve_record(st)})

    n_req = SPEC_PAGED_REQUESTS
    layout = PagedLayout(block_size=PA_BS,
                         n_tbl=cdiv(plen + max(stops) - 1 + k, PA_BS),
                         n_blocks=64)
    reset()
    toks_p, st_p = serve_continuous("minicpm-2b", n_requests=n_req,
                                    compare_lockstep=False, paged=layout,
                                    prefill_chunk=32, **common)
    n_p = {**_macro_launches(), "paged_attn": PK.paged_attention_cuda.launches}
    check(n_p["paged_attn"] == cfg_full.n_layers * st_p["draft_steps"],
          f"phase 24 paged: {n_p['paged_attn']} paged-read launches, "
          f"expected {cfg_full.n_layers} x {st_p['draft_steps']} draft steps")
    check(st_p["paged"]["refcounts_drained"], "phase 24 refcounts leaked")
    ref = serve_phases["tokens_paged"]
    agree = [_tokens_equal(toks_p[r], ref[r]) for r in range(n_req)]
    agree_c = [_tokens_equal(toks_p[r], want[r]) for r in range(n_req)]
    emit({"phase": "serve_paged_speculative", "ok": True,
          "requests": n_req, "draft_k": k, "n_tbl": layout.n_tbl,
          "draft_steps": st_p["draft_steps"], "launches": n_p,
          "requests_equal_phase10": f"{sum(agree)} of {n_req}",
          "requests_equal_phase9": f"{sum(agree_c)} of {n_req}",
          "not_gated_because": "the draft steps read through the paged "
                               "kernel and the verify forward gathers and "
                               "runs the plain read (phase 10's cause)",
          **_serve_record(st_p)})
    return {"macro": {"serve_continuous_speculative": {
                k_: n_c[k_] for k_ in ("general", "skinny")},
                      "serve_paged_speculative": {
                k_: n_p[k_] for k_ in ("general", "skinny")}},
            "paged_attn": n_p["paged_attn"]}

# phase 24's queues: the first requests of phase 9's, contiguous over 8
# slots (2 slots refilled; 16 and paged 8 until phases 44-46 and 12 until
# phases 48-49 needed the time)
SPEC_REQUESTS, SPEC_PAGED_REQUESTS = 10, 4

# -- phases 25-27: the serving bodies as CUDA graphs -----------------------

GRAPH_TURNS = ("eager", "captured")
# layers of the model behind the profiles of phase 26's speculative round
# and phase 31's noisy step (and of phase 6's step): at full depth they
# trace ~82,000 and ~139,000 device events, and reading those took most
# of each phase (4 layers until phases 42-43 needed the time)
PROFILE_LAYERS = 2


def _first_layers(params, n: int):
    """``params`` with its stacked layer tree cut to the first ``n``
    layers (views)."""
    cut = lambda t: ({k: cut(v) for k, v in t.items()}
                     if isinstance(t, dict) else t[:n])
    return dict(params, layers=cut(params["layers"]))


def profile_steps(torch, step, steps: int = 3) -> dict:
    """``device_breakdown`` of ``steps`` calls of ``step`` under the
    profiler, after a synchronization, with the wall time per step."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    return {"step_wall_ms": wall_ms,
            **device_breakdown(prof, steps, wall_ms)}


def graph_nodes(graph, patterns=None) -> tuple:
    """A captured ``StepGraph``'s kernel nodes by serving-kernel symbol
    (or by the names of ``patterns``, name -> regex over the kernel's
    name), and its count of nodes that run on the device (kernels,
    copies, memsets): ``repro_torch.obs.fingerprint.graph_nodes``, which
    reads the kept graph with the driver API."""
    from repro_torch.obs.fingerprint import graph_nodes as read_nodes
    return read_nodes(graph, SYMBOL_RE if patterns is None else patterns)


def check_replays(torch, graph, label: str) -> dict:
    """What a replay of a captured ``graph`` (a ``StepGraph``) launches:
    its kernel nodes by symbol must equal what the graph credits to the
    wrappers' counts, and a profiler trace of one replay must show them
    run.  Late in this script the profiler drops a few of a replay's
    device events (PERF.md), so the trace must show every such kernel
    when it lost no event, and no fewer than the nodes less the events
    lost."""
    check(set(graph.launches) <= set(KERNEL_SYMBOLS), f"{label}: the graph "
          f"credits {graph.launches}, outside {sorted(KERNEL_SYMBOLS)}")
    want = {s: graph.launches.get(w, 0) for w, s in KERNEL_SYMBOLS.items()}
    check(any(want.values()), f"{label}: a replay runs no serving kernel")
    nodes, on_device = graph_nodes(graph)
    check(nodes == want, f"{label}: the graph holds kernel nodes {nodes}, "
          f"it credits {want}")
    rec = profile_steps(torch, graph, steps=1)
    got, lost = rec["kernels_by_symbol_per_step"], (
        on_device - rec["device_events_per_step"])
    check(lost >= 0, f"{label}: a replay's trace holds more device events "
          f"than the graph's {on_device} nodes")
    check(all(want[s] - lost <= got[s] <= want[s] for s in want),
          f"{label}: the trace of a replay ran {got} kernels, losing "
          f"{lost} of {on_device} device events; the graph holds {want}")
    return dict(rec, graph_kernel_nodes=nodes, graph_device_nodes=on_device,
                trace_events_lost=lost)


# row 3's kernels by name: the walk (either design) and the split merge
ROW3_RE = re.compile(r"(?<![A-Za-z_])paged_attn_(walk|combine)")


def pooled_step_tracer(torch, at_step: int = 10):
    """(on_branch, result): a scheduler run's ``on_branch`` hook that
    traces its ``at_step``-th pooled step, a graph replay mid-run, and a
    function that returns the step's wall and device busy time and row
    3's device time in it (the walk and the split merge, by kernel name),
    with the number of row 3 kernels the trace holds."""
    from torch.autograd import DeviceType

    seen, rec = [0], {}

    def on_branch(branch):
        if branch == "step":
            seen[0] += 1
            if seen[0] == at_step:
                torch.cuda.synchronize()
                rec["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                rec["prof"].__enter__()
                rec["t0"] = time.perf_counter()
        elif branch is None and "prof" in rec and "wall_ms" not in rec:
            torch.cuda.synchronize()
            rec["wall_ms"] = 1e3 * (time.perf_counter() - rec["t0"])
            rec["prof"].__exit__(None, None, None)

    def result() -> dict:
        check("wall_ms" in rec, f"the run took {seen[0]} pooled steps, "
              f"fewer than {at_step}")
        row3_us, n_row3 = 0.0, 0
        for e in rec["prof"].events():
            if e.device_type == DeviceType.CUDA and ROW3_RE.search(e.name):
                row3_us += e.time_range.end - e.time_range.start
                n_row3 += 1
        return dict(device_breakdown(rec["prof"], 1, rec["wall_ms"]),
                    step_wall_ms=rec["wall_ms"], at_step=at_step,
                    row3_device_ms=row3_us / 1e3, row3_kernels=n_row3,
                    pooled_steps=seen[0])

    return on_branch, result


def captured_serve_phase(torch, dev, params, cfg_full, phase4) -> dict:
    """Phase 25: phase 4's lock-step serve with its decode step captured,
    against eager serving in turns, and a profile of an eager and a
    replayed step.  Returns the captured runs' launches."""
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.serve import decode_body, serve
    from repro_torch.models import lm

    batch, plen, gen = 4, 32, 16
    want_toks, want_logits, want_launches = phase4
    turns = []
    for turn in GRAPH_TURNS:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks, st = serve("minicpm-2b", smoke=False, batch=batch,
                         prompt_len=plen, gen=gen, cim=True, params=params,
                         graphs=turn == "captured", return_stats=True)
        launches = _macro_launches()
        check((toks == want_toks).all(), f"phase 25 {turn}: tokens != "
              "phase 4's")
        check(torch.equal(st["last_logits"], want_logits),
              f"phase 25 {turn}: last logits != phase 4's")
        check(launches == want_launches, f"phase 25 {turn}: launches "
              f"{launches} != phase 4's {want_launches}")
        rec = {"turn": turn, "decode_tok_s": st["decode_tok_s"],
               "decode_s": st["decode_s"], "prefill_s": st["prefill_s"],
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        for key in ("replay_tok_s", "capture_s", "graph_pool_bytes"):
            if key in st:
                rec[key] = st[key]
        turns.append(rec)
        captured_launches = launches
    # eager and replayed steps of one decode body, under the profiler
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
        max_seq = plen + 32
        cache = lm.init_cache(cfg, batch, max_seq, device=dev)
        prompt = torch.zeros((batch, plen), dtype=torch.int64, device=dev)
        _, cache = lm.prefill(packed, cfg, prompt, cache)
        tok = prompt[:, :1].clone()
        out = torch.zeros((batch, max_seq), dtype=torch.int64, device=dev)
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        body = decode_body(packed, cfg, tok, cache, out, col)
        body()                                               # warm
        eager = profile_steps(torch, body, steps=1)
        graph = StepGraph(body, dev)
        graph()                                              # capture
        graph()
        replayed = check_replays(torch, graph, "phase 25 decode step")
        replay_ms = cuda_ms(graph, reps=5, warmup=1)
    del packed, cache, graph
    emit({"phase": "serve_captured", "ok": True, "batch": batch,
          "prompt_len": plen, "gen": gen, "turns": turns,
          "tokens_equal_phase4": True, "logits_equal_phase4": True,
          "launches": captured_launches,
          "profile_eager_step": eager, "profile_replayed_step": replayed,
          "replay_cuda_event_ms": replay_ms,
          "replay_idle_share_vs_cuda_events": (
              1 - replayed["device_busy_ms"] / replay_ms
              if replayed["device_busy_ms"] else None),
          "trace_kernels_equal_credit": True})
    return captured_launches


def captured_speculative_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 26: phase 23's speculative cases with the round captured,
    against captured lock-step serving, one turn each, and a profile of
    a replayed round of the model's first ``PROFILE_LAYERS`` layers.
    Returns the speculative runs' launches by case."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.serve import round_body, serve, serve_speculative
    from repro_torch.models import lm
    from repro_torch.plan import draft_plan_for_model

    L = cfg_full.n_layers
    out = {}
    for batch, plen, gen, k in SPEC_CASES:
        m = batch * (k + 1)
        common = dict(smoke=False, batch=batch, prompt_len=plen, gen=gen,
                      params=params, return_stats=True, graphs=True)
        tok_s = {"lockstep": [], "speculative": []}
        replay_tok_s = {"lockstep": [], "speculative": []}
        for turn in SPEC_TURNS:
            if turn == "lockstep":
                base, st = serve("minicpm-2b", cim=True, **common)
            else:
                K.reset_launch_counts()
                spec, st = serve_speculative("minicpm-2b", draft_k=k,
                                             compare_baseline=False,
                                             **common)
                launches, sst = _macro_launches(), st
                check(_tokens_equal(spec.ravel(), base.ravel()),
                      f"phase 26 (M {m}): captured speculative tokens != "
                      "captured lock-step tokens")
            tok_s[turn].append(st["decode_tok_s"])
            replay_tok_s[turn].append(st.get("replay_tok_s"))
        rounds = sst["n_rounds"]
        row = lambda rows: "skinny" if rows <= K.SKINNY_M else "general"
        want = {"general": 0, "skinny": 4 * L * k * rounds}
        want[row(batch * plen)] += 4 * L
        want[row(m)] += 4 * L * rounds
        check(launches == want, f"phase 26 (M {m}): launches {launches}, "
              f"expected {want}")
        rec = {"batch": batch, "prompt_len": plen, "gen": gen, "draft_k": k,
               "verify_m": m, "n_rounds": rounds,
               "acceptance_rate": sst["acceptance_rate"],
               "tokens_per_round": sst["tokens_per_round"],
               "launches": launches,
               "capture_s": sst.get("capture_s"),
               "graph_pool_bytes": sst.get("graph_pool_bytes"),
               "decode_tok_s_turns": list(SPEC_TURNS),
               "speculative_decode_tok_s": tok_s["speculative"],
               "lockstep_decode_tok_s": tok_s["lockstep"],
               "speculative_over_lockstep": (
                   statistics.mean(tok_s["speculative"])
                   / statistics.mean(tok_s["lockstep"])),
               "speculative_replay_tok_s": replay_tok_s["speculative"],
               "lockstep_replay_tok_s": replay_tok_s["lockstep"],
               "tokens_equal_lockstep": True,
               "timing": "decode_tok_s: the whole decode (the first step "
                         "or round eager, then the capture, then replays); "
                         "replay_tok_s: the replays alone"}
        if None not in replay_tok_s["speculative"] + replay_tok_s["lockstep"]:
            rec["speculative_over_lockstep_replayed"] = (
                statistics.mean(replay_tok_s["speculative"])
                / statistics.mean(replay_tok_s["lockstep"]))
        # a replayed round under the profiler, every row live throughout,
        # of the model's first PROFILE_LAYERS layers
        cfg = dataclasses.replace(cfg_full, cim_mode=True,
                                  n_layers=PROFILE_LAYERS)
        dcfg = dataclasses.replace(cfg,
                                   cim_plan=draft_plan_for_model(cfg))
        prompt = torch.from_numpy(batch_at(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=plen, global_batch=batch,
            seed=0), 0)["tokens"]).to(dev, torch.int64)
        with torch.inference_mode():
            packed = lm.pack_cim_params(
                _first_layers(params, PROFILE_LAYERS), cfg, dev)
            cache = lm.init_cache(cfg, batch, plen + 8 * (k + 1) + 2 * k
                                  + 1, device=dev)
            lg, cache = lm.prefill(packed, cfg, prompt, cache)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            counts = torch.zeros((batch,), dtype=torch.int64, device=dev)
            graph = StepGraph(round_body(packed, cfg, dcfg, k, tok, cache,
                                         counts, 10 ** 6), dev)
            graph()                                      # capture
            graph()
            rec["round_profile_replayed"] = dict(check_replays(
                torch, graph, f"phase 26 round (M {m})"),
                n_layers=PROFILE_LAYERS)
        del packed, cache, graph
        out[f"serve_speculative_captured_m{m}"] = launches
        emit({"phase": "serve_speculative_captured", "ok": True, **rec})
    return out


def captured_scheduler_phase(torch, dev, params, cfg_full,
                             serve_phases) -> dict:
    """Phase 27: the scheduler with its step branch captured, on phase
    9's first 4 prompts at half their stop lengths (agreement with the
    earlier phase's tokens is reported over that prefix): contiguous,
    phase 24's speculative queue and phase 10's paged queue, against
    the eager scheduler, one turn each.  Returns the captured runs'
    macro and paged-read launches by queue."""
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.models import lm
    from repro_torch.plan import draft_plan_for_model

    # phase 9's first 4 prompts (8 until phases 40-41 needed the time),
    # each request stopping at a quarter of its length (half until phases
    # 48-49 needed the time)
    slots, plen, stops, n_req = 8, 64, (2, 6, 4, 8), 4
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    reqs = mixed_length_requests(n_req, plen, cfg.vocab_size,
                                 stop_lengths=stops, seed=0)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    base = dict(slots=slots, prompt_len=plen, max_new_cap=max(stops))
    queues = {
        "contiguous": dict(base),
        "speculative": dict(base, draft_k=4, adaptive_draft_k=True,
                            draft_plan=draft_plan_for_model(cfg)),
        "paged": dict(base, prefill_chunk=32, paged=PagedLayout(
            block_size=PA_BS, n_tbl=cdiv(plen + max(stops) - 1, PA_BS),
            n_blocks=64)),
    }
    earlier = {"contiguous": serve_phases["tokens_contiguous"],
               "speculative": serve_phases["tokens_contiguous"],
               "paged": serve_phases["tokens_paged"]}
    out = {}
    for name, kw in queues.items():
        scheds = {"eager": ContinuousBatchingScheduler(packed, cfg,
                                                       graphs=False, **kw),
                  "captured": ContinuousBatchingScheduler(packed, cfg,
                                                          graphs=True, **kw)}
        turns, first = [], None
        for turn in GRAPH_TURNS:
            _reset_all_launches()
            rep = scheds[turn].run(reqs)
            launches = _all_launches()
            toks = rep.tokens_by_rid()
            if first is None:
                first = (toks, rep.branch_counts, launches)
            check(all(_tokens_equal(toks[r], first[0][r]) for r in first[0]),
                  f"phase 27 {name} {turn}: pool tokens != the eager run's")
            check(rep.branch_counts == first[1], f"phase 27 {name} {turn}: "
                  f"iterations by branch {rep.branch_counts} != {first[1]}")
            check(launches == first[2], f"phase 27 {name} {turn}: launches "
                  f"{launches} != the eager run's {first[2]}")
            turns.append({
                "turn": turn, "tok_s": rep.tok_s, "wall_s": rep.wall_s,
                "n_iter": rep.n_iter,
                "iter_ms": 1e3 * rep.wall_s / rep.n_iter,
                "branch_ms_per_iter": {
                    b: 1e3 * t / rep.branch_counts[b]
                    for b, t in rep.branch_s.items() if rep.branch_counts[b]},
                "branch_share_of_wall": {
                    b: t / rep.wall_s for b, t in rep.branch_s.items()}})
        same = [_tokens_equal(first[0][r],
                              earlier[name][r][:len(first[0][r])])
                for r in earlier[name] if r in first[0]]
        if name == "paged":
            check(first[2]["paged_attn"] > 0,
                  "phase 27 paged: the paged read was launched no time")
        graphs = scheds["captured"].graph_stats()
        # replays of each graph on the state the last run left (every slot
        # done: the kernels run all the same, at the graph's shapes)
        with torch.inference_mode():
            traces = {key: check_replays(torch, g, f"phase 27 {name} "
                                         f"graph {key}")
                      for key, g in scheds["captured"]._graphs.items()}
        emit({"phase": "serve_scheduler_captured", "ok": True,
              "queue": name, "requests": n_req, "turns": turns,
              "branch_counts": first[1], "launches": first[2],
              "graphs": graphs, "replay_traces": traces,
              "trace_kernels_equal_credit": True,
              "tokens_equal_eager": True,
              "requests_equal_earlier_phase": f"{sum(same)} of {len(same)}",
              "earlier_phase": 10 if name == "paged" else 9})
        out[name] = first[2]
        del scheds
    del packed
    return out


# -- phases 28-31: threefry on the card, sampled and noisy serving ---------

PRNG_DRAWS = 1 << 21
# conversions of phase 20's CPU cross-check: the first 2^16 of the card's
# (2^18 until phases 42-43 and 2^17 until phases 44-46 needed the time)
FIG6_CPU_N = 1 << 16
TEMPERATURE = 0.7
EULER_GAMMA = 0.5772156649015329


def _moment_bounds(n: int, var: float, kurtosis: float) -> tuple:
    """Five standard errors of a sample's mean and variance over ``n``
    draws of a law of variance ``var`` and kurtosis ``kurtosis``."""
    return (5 * (var / n) ** 0.5,
            5 * ((kurtosis - 1) * var * var / n) ** 0.5)


def prng_phase(torch, dev) -> dict:
    """Phase 28: ``core/prng.py`` on the card against the CPU port, 2^21
    draws: keys, bits, uniforms, normals, Gumbels and categorical rows
    bit for bit (gate; the float transforms evaluate XLA's CPU
    approximations with correctly rounded float32 operations, so the
    card gives the CPU's values), normals' and Gumbels' mean and
    variance held to five standard errors; the device time of the noisy
    decode step's widest draw and of a 128-token prefill's."""
    from repro_torch.core import prng
    n = PRNG_DRAWS
    kc, kd = prng.PRNGKey(0), prng.PRNGKey(0, dev)
    rids = lambda k: torch.arange(1 << 16, device=k.device)
    exact = {
        "bits": lambda k: prng.bits(k, (n,)),
        "uniform": lambda k: prng.uniform(k, (n,)),
        "uniform_bounded": lambda k: prng.uniform(k, (n,), -3.0, 5.0),
        "split": lambda k: prng.split(k, 4),
        "split_batched": lambda k: prng.split(prng.split(k, 1 << 16), 3),
        "fold_in": lambda k: prng.fold_in(prng.split(k, 1 << 16), rids(k)),
        "categorical_rows": lambda k: prng.categorical(
            prng.split(k, 16), prng.normal(k, (16, 122753)) * 3),
    }
    rec = {"draws": n}
    for name, fn in exact.items():
        want, got = fn(kc), fn(kd).cpu()
        check(torch.equal(want, got), f"phase 28: prng.{name} on the card "
              "!= the CPU port")
        rec[name] = "equal"
    stats = {}
    for name, mean, var, kurt in (
            ("normal", 0.0, 1.0, 3.0),
            ("gumbel", EULER_GAMMA, 3.141592653589793 ** 2 / 6, 5.4)):
        fn = getattr(prng, name)
        want, got = fn(kc, (n,)), fn(kd, (n,)).cpu()
        check(torch.equal(want, got), f"phase 28: prng.{name} on the card "
              "!= the CPU port")
        rec[name] = "equal"
        g = got.double()
        m_tol, v_tol = _moment_bounds(n, var, kurt)
        m, v = float(g.mean()), float(g.var())
        check(abs(m - mean) < m_tol and abs(v - var) < v_tol,
              f"phase 28: {name} mean {m} / variance {v} outside "
              f"{mean} +- {m_tol} / {var} +- {v_tol}")
        stats[name] = {"mean": m, "variance": v, "mean_tol": m_tol,
                       "variance_tol": v_tol}
    times = {}
    key = prng.fold_in(kd, 3)
    for label, shape in (("decode_w1w3_m4", (4, 11520, 144)),
                         ("prefill_w1w3_m128", (128, 11520, 144))):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: prng.normal(key, shape), reps=3, warmup=1)
        elems = shape[0] * shape[1] * shape[2]
        times[label] = {"shape": list(shape), "ms": ms,
                        "ns_per_draw": 1e6 * ms / elems,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(),
                        "bound_ms": 1e3 * 4 * elems / HBM_BYTES_S}
    emit({"phase": "prng", "ok": True, "equal_to_cpu": rec,
          "moments": stats,
          "normal_times": times,
          "bound": "4 output bytes a draw over the HBM rate (the draw "
                   "reads nothing); the torch version is ~220 elementwise "
                   "kernels a draw"})
    return times


def sampled_serve_phase(torch, dev, params, cfg_full, phase4) -> dict:
    """Phase 29: phase 4's lock-step serve at temperature 0.7 (every
    token, the first included, sampled from the seed's stream): through
    the kernels and through their plain version (tokens and last logits
    equal, launches as phase 4's), eager and captured in turns (captured
    == eager bit for bit), and tokens that differ from phase 4's greedy
    ones.  Returns the eager run's launches."""
    from repro_torch.launch.serve import serve

    batch, plen, gen = 4, 32, 16
    greedy_toks, _, want_launches = phase4
    common = dict(smoke=False, batch=batch, prompt_len=plen, gen=gen,
                  cim=True, params=params, temperature=TEMPERATURE,
                  return_stats=True)
    _reset_all_launches()
    toks_p, st_p = serve("minicpm-2b", graphs=False, use_kernel=False,
                         **common)
    check(_macro_launches() == {"general": 0, "skinny": 0},
          "phase 29: the plain run launched kernels")
    turns, eager = [], None
    for turn in GRAPH_TURNS:
        _reset_all_launches()
        toks, st = serve("minicpm-2b", graphs=turn == "captured", **common)
        launches = _macro_launches()
        check(launches == want_launches, f"phase 29 {turn}: launches "
              f"{launches} != phase 4's {want_launches}")
        check((toks == toks_p).all() and torch.equal(
            st["last_logits"], st_p["last_logits"]),
            f"phase 29 {turn}: sampled tokens or logits != the plain run's")
        if eager is None:
            eager = launches
        rec = {"turn": turn, "decode_tok_s": st["decode_tok_s"],
               "prefill_s": st["prefill_s"], "decode_s": st["decode_s"]}
        for k in ("replay_tok_s", "capture_s", "graph_pool_bytes"):
            if k in st:
                rec[k] = st[k]
        turns.append(rec)
    differ = int((toks_p != greedy_toks).sum())
    check(differ > 0, "phase 29: sampled tokens equal the greedy ones")
    emit({"phase": "serve_sampled", "ok": True, "temperature": TEMPERATURE,
          "batch": batch, "prompt_len": plen, "gen": gen,
          "kernel_equals_plain": True, "captured_equals_eager": True,
          "launches": eager, "tokens_differing_from_greedy":
              f"{differ} of {toks_p.size}", "tokens_row0": toks_p[0].tolist(),
          "turns": turns})
    return eager


def sampled_scheduler_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 30: the scheduler at temperature 0.7 through the kernels on
    phase 9's first 4 prompts at a quarter of their stop lengths, captured
    and
    eager, each run's counts reset before it: a contiguous pool, a
    speculative pool at k 4 (fixed depth) under a clipping draft (ADC 5,
    so that rejection sampling rejects and draws corrections), and a
    paged pool.  Each queue's captured run
    must equal its eager run (tokens, iterations by branch, launches),
    and each graph's kernel nodes and a traced replay must equal what it
    credits; the contiguous and speculative pools must equal a solo run
    of their first request, the speculative acceptance must lie strictly
    between 0 and 1, and the paged pool's agreement with the contiguous
    one is reported.  Returns the eager runs' launches by queue."""
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.models import lm
    from repro_torch.plan import draft_plan_for_model

    # phase 9's first 4 prompts (8 until phases 40-41 needed the time),
    # each request stopping at a quarter of its length (half until phases
    # 42-43 needed the time)
    slots, plen, stops, n_req = 8, 64, (2, 6, 4, 8), 4
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    reqs = mixed_length_requests(n_req, plen, cfg.vocab_size,
                                 stop_lengths=stops, seed=0)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    base = dict(slots=slots, prompt_len=plen, max_new_cap=max(stops),
                temperature=TEMPERATURE)
    draft_adc = 5
    solo_rids = (0,)
    out, pools = {}, {}
    for name, kw in (
            ("contiguous", dict(base)),
            ("speculative", dict(base, draft_k=4, draft_plan=(
                draft_plan_for_model(cfg, draft_adc)))),
            ("paged", dict(base, prefill_chunk=32, paged=PagedLayout(
                block_size=PA_BS, n_tbl=cdiv(plen + max(stops) - 1, PA_BS),
                n_blocks=64)))):
        scheds = {"captured": ContinuousBatchingScheduler(
                      packed, cfg, graphs=True, **kw),
                  "eager": ContinuousBatchingScheduler(
                      packed, cfg, graphs=False, **kw)}
        runs = {}
        for turn, sched in scheds.items():
            _reset_all_launches()
            rep = sched.run(reqs)
            runs[turn] = (rep, rep.tokens_by_rid(), _all_launches())
        rep, pool, launches = runs["captured"]
        erep, epool, elaunches = runs["eager"]
        check(all(_tokens_equal(epool[r], pool[r]) for r in pool),
              f"phase 30 {name}: the captured sampled pool != the eager one")
        check(rep.branch_counts == erep.branch_counts, f"phase 30 {name}: "
              f"iterations by branch {rep.branch_counts} != the eager "
              f"run's {erep.branch_counts}")
        check(launches == elaunches, f"phase 30 {name}: captured launches "
              f"{launches} != the eager run's {elaunches}")
        # replays of each graph on the state the captured run left
        with torch.inference_mode():
            traces = {key: check_replays(torch, g, f"phase 30 {name} "
                                         f"graph {key}")
                      for key, g in scheds["captured"]._graphs.items()}
        pools[name] = pool
        rec = {"queue": name, "tok_s": rep.tok_s, "wall_s": rep.wall_s,
               "eager_tok_s": erep.tok_s, "eager_wall_s": erep.wall_s,
               "n_iter": rep.n_iter, "branch_counts": rep.branch_counts,
               "launches": elaunches, "captured_equals_eager": True,
               "graphs": scheds["captured"].graph_stats(),
               "replay_traces": traces, "trace_kernels_equal_credit": True,
               "summary": rep.summary()}
        if name != "paged":
            for rid in solo_rids:
                solo = scheds["captured"].run([reqs[rid]]).tokens_by_rid()
                check(_tokens_equal(solo[rid], pool[rid]), f"phase 30 "
                      f"{name}: request {rid}'s pool tokens != its solo "
                      "run's")
            rec["pool_equals_solo"] = list(solo_rids)
        if name == "speculative":
            acc = rep.acceptance_rate
            check(0 < acc < 1, f"phase 30 speculative: acceptance {acc} "
                  f"at draft ADC {draft_adc} is not strictly between 0 "
                  "and 1, so rejection sampling went unexercised")
            rec.update(acceptance_rate=acc, draft_adc_bits=draft_adc,
                       requests_differing_from_contiguous=sum(
                           not _tokens_equal(pool[r], pools["contiguous"][r])
                           for r in pool))
        if name == "paged":
            same = [_tokens_equal(pool[r], pools["contiguous"][r])
                    for r in pool]
            rec.update(
                requests_equal_contiguous=f"{sum(same)} of {len(same)}",
                refcounts_drained=rep.ref_final.tolist()
                == [1] + [0] * 63,
                not_gated_because="the paged read's float32 P.V can move "
                                  "a bf16 activation by one ulp, and in CIM "
                                  "mode an ADC code with it")
            check(elaunches["paged_attn"] > 0,
                  "phase 30: the paged read was launched no time")
        emit({"phase": "serve_scheduler_sampled", "ok": True,
              "temperature": TEMPERATURE, **rec})
        out[name] = elaunches
        del scheds
    del packed
    return out


def noise_draw_profile(torch, dev, params, cfg, batch: int, plen: int
                       ) -> dict:
    """A profile of one eager noisy decode step at phase 31's width and
    batch, the model cut to its first ``PROFILE_LAYERS`` layers:
    the step's wall and device busy time (``device_breakdown``) and,
    over the noise draws' profiler range (``ccim.NOISE_RANGE``, every
    ``_fast_gemm_noise`` call), the device time of the kernels launched
    inside it, its host time, and the union of its device-side spans
    (a draw's first kernel start to its last kernel end)."""
    from torch.autograd import DeviceType
    from repro_torch.core import ccim
    from repro_torch.launch.serve import decode_body
    from repro_torch.models import lm
    cfg = dataclasses.replace(cfg, n_layers=PROFILE_LAYERS)
    params = _first_layers(params, PROFILE_LAYERS)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
        cache = lm.init_cache(cfg, batch, plen + 8, device=dev)
        prompt = torch.zeros((batch, plen), dtype=torch.int64, device=dev)
        # the cache's contents do not change the step's work: a noise-free
        # prefill (the same pack) fills it in a fraction of a noisy one's
        _, cache = lm.prefill(packed, dataclasses.replace(
            cfg, cim_noise_seed=None), prompt, cache)
        tok = prompt[:, :1].clone()
        out = torch.zeros((batch, 8), dtype=torch.int64, device=dev)
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        body = decode_body(packed, cfg, tok, cache, out, col)
        body()                                               # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            body()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    del packed, cache
    draws = [e for e in prof.events() if e.name == ccim.NOISE_RANGE]
    host = [e for e in draws if e.device_type == DeviceType.CPU]
    span_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in draws if e.device_type == DeviceType.CUDA):
        if b > end:
            span_us += b - max(a, end)
            end = b
    kernel_ms = sum(e.device_time_total for e in host) / 1e3
    host_ms = sum(e.cpu_time_total for e in host) / 1e3
    rec = device_breakdown(prof, 1, wall_ms)
    busy = rec["device_busy_ms"]
    check(busy is not None and host and kernel_ms > 0,
          "phase 31: the profile of a noisy step holds no device events, "
          "no noise-draw range or no kernel under it")
    return {"n_layers": PROFILE_LAYERS,
            "step_wall_ms": wall_ms, "noise_draw_calls": len(host),
            "draw_kernel_ms": kernel_ms, "draw_host_ms": host_ms,
            "draw_device_span_ms": span_us / 1e3,
            "draw_kernels_share_of_device_busy": kernel_ms / busy,
            "draw_kernels_share_of_step_wall": kernel_ms / wall_ms,
            "draw_host_share_of_step_wall": host_ms / wall_ms, **rec}


def noisy_serve_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 31: lock-step serve with the macro's analog noise (noise seed
    0; batch 2, prompt 1, 3 tokens), eager and captured: identical
    tokens and logits (the draws are deterministic), logits that differ
    from the noise-free run's, and no launch of kernel rows 1 and 2 (the
    noisy GEMMs take the chunked GEMM in torch, as the reference's leave
    its kernels); prefill and decode wall time, peak memory, and the
    share of an eager decode step's device time spent in the noise
    draws, from a profile of one step of the model's first layers.  (The
    noisy prefill at M 128 that this phase also timed, 51.7 s, was cut
    to make room for phases 33-35; the prompt of 8 tokens, whose M-16
    noisy prefills ran in each of the two noisy serves, became one token
    to make room for phases 36-37; to keep the run well inside its time
    limit, the serves went from 6 tokens to 4 and the profiled step
    from 40 layers to 4; to make room for phases 40-41, to 3 tokens.)"""
    from repro_torch.launch.serve import serve

    batch, plen, gen = 2, 1, 3
    common = dict(smoke=False, batch=batch, prompt_len=plen, gen=gen,
                  cim=True, params=params, return_stats=True)
    zero = {"general": 0, "skinny": 0}
    runs = {}
    for label, kw in (("eager", dict(graphs=False, noise_seed=0)),
                      ("captured", dict(graphs=True, noise_seed=0)),
                      ("noise_free", dict(graphs=False))):
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks, st = serve("minicpm-2b", **common, **kw)
        runs[label] = (toks, st.pop("last_logits"), _macro_launches(), st,
                       torch.cuda.max_memory_allocated())
    (te, le, ne, se, me), (tc, lc, nc, sc, mc) = runs["eager"], runs[
        "captured"]
    check((te == tc).all() and torch.equal(le, lc),
          "phase 31: two noisy runs (eager, captured) differ")
    check(not torch.equal(le, runs["noise_free"][1]),
          "phase 31: noisy logits equal the noise-free ones")
    check(ne == zero and nc == zero, f"phase 31: noisy serving launched "
          f"macro kernels {ne} / {nc}")
    check(bool(torch.isfinite(le).all()), "phase 31: non-finite logits")
    cfg = dataclasses.replace(cfg_full, cim_mode=True, cim_noise_seed=0)
    profile = noise_draw_profile(torch, dev, params, cfg, batch, plen)
    emit({"phase": "serve_noisy", "ok": True, "noise_seed": 0,
          "batch": batch, "prompt_len": plen, "gen": gen,
          "runs_identical": True, "logits_differ_from_noise_free": True,
          "macro_kernel_launches": ne,
          "eager": {k: se[k] for k in ("prefill_s", "decode_s",
                                       "decode_tok_s")},
          "captured": {k: sc[k] for k in ("prefill_s", "decode_s",
                                          "decode_tok_s", "capture_s",
                                          "graph_pool_bytes")
                       if k in sc},
          "noise_free": {k: runs["noise_free"][3][k] for k in (
              "prefill_s", "decode_s", "decode_tok_s")},
          "max_memory_allocated": {"eager": me, "captured": mc,
                                   "noise_free": runs["noise_free"][4]},
          "eager_decode_step_ms": 1e3 * se["decode_s"] / (gen - 1),
          "profile_eager_noisy_step": profile,
          "tokens_row0": te[0].tolist()})
    return ne


def noisy_doa_phase(torch, dev) -> dict:
    """Phase 32: MUSIC DoA with the macro's analog noise.  Keyed dies on
    the card against the CPU; the figS3 twin on the card against its CPU
    run, trial by trial; noisy frames of both large arrays (RMSE, frames/s,
    no kernel launch)."""
    import numpy as np
    from repro_torch.core import ccim, prng
    from repro_torch.launch import doa, figS3_doa

    for seed in (0, 1, 2 ** 32 - 1):
        d_card = ccim.fabricate(prng.PRNGKey(seed, dev))
        d_cpu = ccim.fabricate(prng.PRNGKey(seed))
        check(all(torch.equal(getattr(d_card, f).cpu(), getattr(d_cpu, f))
                  for f in ("eps_array", "adc_cap_eps", "vref_pol_eps")),
              f"phase 32: the keyed die of seed {seed} differs card vs CPU")
    zero = {k: 0 for k in _all_launches()}
    _reset_all_launches()
    rows = []
    card = figS3_doa.run(seed=0, device=dev, emit=rows.append)
    check(_all_launches() == zero,
          f"phase 32: the noisy figS3 twin launched kernels {_all_launches()}")
    t0 = time.time()
    cpu = figS3_doa.run(seed=0, device="cpu", emit=lambda row: None)
    cpu_s = time.time() - t0
    for t, (a, b) in enumerate(zip(card["trials"], cpu["trials"])):
        check(_equal_pair(tuple(v.cpu() for v in a["r_int"]), b["r_int"])
              == 0, f"phase 32: figS3 trial {t}: covariance ints differ")
        check(torch.equal(a["p"].cpu(), b["p"]),
              f"phase 32: figS3 trial {t}: spectra differ card vs CPU")
        check(a["cim"] == b["cim"], f"phase 32: figS3 trial {t}: estimates "
              f"{a['cim']} (card) != {b['cim']} (CPU)")
    check(card["rmse_pct_fov"] < doa.RMSE_LIMIT_PCT,
          f"phase 32: figS3 RMSE {card['rmse_pct_fov']} % of the FOV")
    arrays = {}
    for name, _ in DOA_ARRAYS:
        _reset_all_launches()
        out = doa.run(name, DOA_FRAMES, seed=0, device=dev)
        launches = _all_launches()
        check(launches == zero,
              f"phase 32: noisy {name} frames launched kernels {launches}")
        check(out["rmse_pct_fov"] < doa.RMSE_LIMIT_PCT,
              f"phase 32: noisy {name} RMSE {out['rmse_pct_fov']:.3f} % of "
              "the field of view")
        check(all(bool(torch.isfinite(f["p"]).all()) for f in out["frames"]),
              f"phase 32: noisy {name}: a non-finite spectrum")
        arrays[name] = {k: out[k] for k in (
            "n_frames", "rmse_cim_deg", "rmse_software_deg",
            "rmse_cim_vs_software_deg", "rmse_pct_fov", "cim_frames_per_s")}
        arrays[name]["frame_ms"] = 1e3 / out["cim_frames_per_s"]
        arrays[name]["first_frame"] = {
            k: out["frames"][0][k] for k in ("true", "cim", "software")}
    # the digital back end's eigendecomposition at the ula64 covariance:
    # the port's route (scipy's heevd on the host, the reference's LAPACK)
    # against torch's eigh on the card
    rng = np.random.default_rng(0)
    X = torch.from_numpy(doa.draw_frame(rng, doa.ARRAYS["ula64"])[1]).to(dev)
    R, _ = doa.covariance(X)
    ns = doa.ARRAYS["ula64"].n_sources
    eigh_ms = {"host_heevd": cuda_ms(lambda: doa.noise_subspace(R, ns), 20),
               "card_torch_eigh": cuda_ms(lambda: torch.linalg.eigh(
                   (R + R.conj().t()) * 0.5), 20)}
    emit({"phase": "doa_noisy", "ok": True, "keyed_dies_equal": True,
          "eigh_ms_ula64": eigh_ms,
          "figS3": {"rows": {r["name"]: r["value"] for r in rows},
                    "rmse_pct_fov": card["rmse_pct_fov"],
                    "card_frame_us": card["us"], "cpu_frame_us": cpu["us"],
                    "cpu_seconds": cpu_s, "trials_equal_cpu": len(
                        card["trials"]),
                    "estimates": [tr["cim"] for tr in card["trials"]]},
          "arrays": arrays, "kernel_launches": zero,
          "mean_spectrum_nmse_pct": card["spectrum_nmse_pct"],
          "noise_keys": "PRNGKey(seed * 100 + t); projections fold_in(key, 1)",
          "rmse_limit_pct": doa.RMSE_LIMIT_PCT})
    return arrays


# -- phases 33-35: unpacked serving, the planner, the figure twins ---------

# an unpacked graph's kernel nodes, by wrapper: row 6 runs the general
# template over the raw-weight fill (``general_kernel<..., RawFill, 1>``),
# row 2 over the packed fill
UNPACKED_NODE_RE = {
    "ccim_matmul_unpacked_cuda": re.compile(r"general_kernel.*RawFill"),
    "ccim_matmul_prepacked_general_cuda": re.compile(
        r"general_kernel.*PackedFill"),
    "ccim_matmul_prepacked_skinny_cuda": re.compile(
        r"(?<![A-Za-z_])skinny_kernel")}
UNPACKED_TURNS = ("packed", "unpacked")


def _rows_launches() -> dict:
    """Launches of kernel rows 1, 2 and 6 since the last reset."""
    n = _all_launches()
    return {k: n[k] for k in ("skinny", "general", "unpacked")}


def unpacked_serve_phase(torch, dev, params, cfg_full, phase4,
                         phase22) -> dict:
    """Phase 33: phase 4's lock-step serve (batch 4, prompt 32, 16 tokens,
    captured) on the raw weights, quantized at every call: row 6 carries
    every macro GEMM (4 a layer: QKV, wo, w1+w3, w2; M 128 in prefill, M
    4 in decode, credited per replay), rows 1 and 2 none.  Tokens and
    last logits equal phase 4's packed run, through the kernel and
    through its plain version; packed and unpacked serving in turns
    (decode tok/s, peak memory); the captured step's kernel nodes read
    back by name; then phase 22's mixed plan unpacked, its design points
    packed per call onto rows 1 and 2, equal to phase 22's tokens.
    Returns the launches by path of rows 1, 2 and 6."""
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.serve import decode_body, serve
    from repro_torch.models import lm

    batch, plen, gen = 4, 32, 16
    want_toks, want_logits, _ = phase4
    n_fwd = 4 * cfg_full.n_layers
    common = dict(smoke=False, batch=batch, prompt_len=plen, gen=gen,
                  params=params, return_stats=True)
    want = {"packed": {"skinny": n_fwd * (gen - 1), "general": n_fwd,
                       "unpacked": 0},
            "unpacked": {"skinny": 0, "general": 0, "unpacked": n_fwd * gen}}
    turns = []
    for turn in UNPACKED_TURNS:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks, st = serve("minicpm-2b", cim=True, pack=turn == "packed",
                         **common)
        launches = _rows_launches()
        check((toks == want_toks).all() and torch.equal(
            st["last_logits"], want_logits),
            f"phase 33 {turn}: tokens or last logits != phase 4's")
        check(launches == want[turn], f"phase 33 {turn}: launches "
              f"{launches}, expected {want[turn]}")
        turns.append({"turn": turn, "max_memory_allocated":
                      torch.cuda.max_memory_allocated(),
                      **{k: st[k] for k in (
                          "pack_s", "pack_bytes", "prefill_s", "decode_s",
                          "decode_tok_s", "replay_tok_s", "capture_s",
                          "graph_pool_bytes") if k in st}})
    _reset_all_launches()
    toks, st = serve("minicpm-2b", cim=True, pack=False, use_kernel=False,
                     **common)
    check((toks == want_toks).all() and torch.equal(
        st["last_logits"], want_logits),
        "phase 33: the plain version of row 6 gave other tokens or logits")
    check(not any(_all_launches().values()),
          "phase 33: the plain unpacked run launched kernels")
    plain = {k: st[k] for k in ("prefill_s", "decode_s", "decode_tok_s")}
    # one captured unpacked decode step: its kernel nodes by name
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    with torch.inference_mode():
        max_seq = plen + 32          # room for the warm step and 9 replays
        cache = lm.init_cache(cfg, batch, max_seq, device=dev)
        prompt = torch.zeros((batch, plen), dtype=torch.int64, device=dev)
        _, cache = lm.prefill(params, cfg, prompt, cache)
        tok = prompt[:, :1].clone()
        out = torch.zeros((batch, max_seq), dtype=torch.int64, device=dev)
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        graph = StepGraph(decode_body(params, cfg, tok, cache, out, col),
                          dev)
        graph()
        graph()
        nodes, _ = graph_nodes(graph, UNPACKED_NODE_RE)
        credit = dict(graph.launches)
        replay_ms = cuda_ms(graph, reps=5, warmup=1)
    del cache, graph
    check(credit == {"ccim_matmul_unpacked_cuda": n_fwd}, f"phase 33: the "
          f"captured step credits {credit}, expected {n_fwd} row-6 launches")
    check(nodes == {k: credit.get(k, 0) for k in UNPACKED_NODE_RE},
          f"phase 33: the captured step holds kernel nodes {nodes}, it "
          f"credits {credit}")
    # phase 22's mixed plan, unpacked: packed per call onto rows 1 and 2
    _reset_all_launches()
    toks, st = serve("minicpm-2b", plan=mixed_plan(), pack=False, **common)
    plan_launches = _rows_launches()
    check((toks == phase22["toks"]).all() and torch.equal(
        st["last_logits"], phase22["logits"]),
        "phase 33: the unpacked mixed plan's tokens or logits != phase 22's")
    check(plan_launches == {"skinny": n_fwd * (gen - 1), "general": n_fwd,
                            "unpacked": 0},
          f"phase 33: the unpacked mixed plan launched {plan_launches}")
    by_turn = lambda t: [r for r in turns if r["turn"] == t]
    emit({"phase": "serve_unpacked", "ok": True, "batch": batch,
          "prompt_len": plen, "gen": gen, "turns": turns,
          "tokens_equal_phase4": True, "logits_equal_phase4": True,
          "launches": want["unpacked"], "plain": plain,
          "captured_step": {"kernel_nodes": nodes, "credit": credit,
                            "replay_cuda_event_ms": replay_ms},
          "decode_tok_s_packed": [r["decode_tok_s"]
                                  for r in by_turn("packed")],
          "decode_tok_s_unpacked": [r["decode_tok_s"]
                                    for r in by_turn("unpacked")],
          "plan": {"tokens_equal_phase22": True, "launches": plan_launches,
                   "decode_tok_s": st["decode_tok_s"],
                   "prefill_s": st["prefill_s"]},
          "tokens_row0": toks[0].tolist()})
    return {"serve_unpacked": want["unpacked"],
            "serve_unpacked_plan": plan_launches}


def planner_candidates():
    """Phase 34's candidates (``tests/test_plan.py::_small_candidates``):
    all-digital, the prototype and hybrid3 / 8 b / L32."""
    from repro_torch import plan as TP
    from repro_torch.core.ccim import CCIMConfig
    return [TP.digital_candidate(), TP.prototype_candidate(),
            TP.make_candidate("hybrid3/adc8/L32",
                              CCIMConfig(acc_len=32, adc_bits=8))]


def planner_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 34: the deployment planner at full width on the raw weights
    (calibration batch 2 x 16, M 32).  The noise-free profile of all seven
    sites under ``planner_candidates`` through the kernels (the prototype
    on row 6, the L32 point packed per call on row 1, digital exact) and
    through their plain versions: equal tables (``==``) and equal
    ``pareto_search`` results at budget scales 1.0 and 0.6.  Then the
    ``launch/plan_pareto.py`` twin at card scale, noise-free (its grid of
    7 candidates): four points, the domination gate, decode tok/s of
    three plans served packed, and its second arch, mamba2-130m, at the
    reference bench's smoke size and noise seed.  Last, one forward on
    the profiler's default noise seed (site mlp/w2 on the prototype): no
    kernel, its seconds, and two runs equal.  Returns the kernel runs'
    launches of rows 1, 2 and 6."""
    from repro_torch import plan as TP
    from repro_torch.launch import plan_pareto
    from repro_torch.models import lm

    toks = TP.calibration_batch(cfg_full, batch=2, seq_len=16)
    cands = planner_candidates()
    n_sites = len(lm.iter_packable_paths(params))
    runs = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        cfg = dataclasses.replace(cfg_full, cim_use_kernel=use_kernel)
        _reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        ref = TP.reference_logits(params, cfg, toks)
        prof = TP.profile_sensitivities(params, cfg, toks, cands,
                                        noise_seed=None, ref=ref)
        torch.cuda.synchronize()
        t_prof = time.time() - t0
        launches = _rows_launches()
        _reset_all_launches()
        t0 = time.time()
        searches = {scale: TP.pareto_search(
            params, cfg, toks, candidates=cands, profile=prof, ref=ref,
            noise_seed=None, budget_scale=scale) for scale in (1.0, 0.6)}
        torch.cuda.synchronize()
        runs[label] = dict(prof=prof, searches=searches, profile_s=t_prof,
                           search_s=time.time() - t0,
                           profile_launches=launches,
                           search_launches=_rows_launches())
    kr, pr = runs["kernel"], runs["plain"]
    n_layers = cfg_full.n_layers
    check(kr["profile_launches"] == {"skinny": n_sites * n_layers,
                                     "general": 0,
                                     "unpacked": n_sites * n_layers},
          f"phase 34: the profile launched {kr['profile_launches']}")
    check(not any(pr["profile_launches"].values())
          and not any(pr["search_launches"].values()),
          "phase 34: the plain planner launched kernels")
    check(kr["prof"].as_table() == pr["prof"].as_table(),
          "phase 34: the profile through the kernels != through the plain "
          "versions")
    for scale in (1.0, 0.6):
        a, b = kr["searches"][scale], pr["searches"][scale]
        check(a.assignment == b.assignment and a.moves == b.moves
              and a.n_reverts == b.n_reverts
              and a.measured_rms == b.measured_rms,
              f"phase 34: pareto_search at {scale} differs kernel vs plain")
    # the plan_pareto twin at card scale
    _reset_all_launches()
    t0 = time.time()
    pareto = plan_pareto.run_arch("minicpm-2b", smoke=False, batch=2,
                                  prompt_len=16, gen=4, params=params,
                                  device=dev, noise_seed=None)
    pareto_s = time.time() - t0
    pareto_launches = _rows_launches()
    check(not pareto["planned_dominated_by_global_hybrid"],
          "phase 34: planned-mixed is dominated by global-hybrid")
    pts = pareto["points"]
    check(all(pts[p]["decode_tok_s"] > 0 for p in (
        "global_digital", "global_hybrid", "planned_mixed")),
        "phase 34: a served plan has no decode tok/s")
    # the twin's second arch, mamba2-130m, at the reference bench's smoke
    # size and noise seed (the noisy forwards run in torch, no kernel)
    from repro_torch.configs import get_config
    sparams = lm.init(0, get_config(SSM_ARCH, smoke=True), device=dev)
    _reset_all_launches()
    t0 = time.time()
    ssm_pareto = plan_pareto.run_arch(SSM_ARCH, smoke=True, batch=2,
                                      prompt_len=16, gen=16, params=sparams,
                                      device=dev)
    ssm_pareto_s = time.time() - t0
    ssm_pareto_launches = _rows_launches()
    spts = ssm_pareto["points"]
    check(not ssm_pareto["planned_dominated_by_global_hybrid"],
          "phase 34: mamba2-130m's planned-mixed is dominated")
    check(all(spts[p]["decode_tok_s"] > 0 for p in (
        "global_digital", "global_hybrid", "planned_mixed"))
        and list(ssm_pareto["sites"]) == list(
            lm.iter_packable_paths(sparams)),
        "phase 34: mamba2-130m's twin lacks a point's tok/s or a site")
    # one forward on the profiler's default noise seed: no kernel
    plan = TP.DeploymentPlan.from_dict(
        {"mlp/w2": TP.prototype_candidate().entry}, default=TP.FLOAT_ENTRY)
    _reset_all_launches()
    noisy, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        noisy.append(TP.planned_logits(params, cfg_full, toks, plan))
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    check(not any(_all_launches().values()),
          "phase 34: the noisy forward launched kernels")
    check(torch.equal(noisy[0], noisy[1])
          and bool(torch.isfinite(noisy[0]).all()),
          "phase 34: two noisy forwards differ or are not finite")
    emit({"phase": "planner", "ok": True, "calibration": [2, 16],
          "candidates": [c.label for c in cands],
          "sites": kr["prof"].sites, "table": kr["prof"].as_table(),
          "tables_equal": True, "searches_equal": True,
          "searches": {str(s): dict(assignment=r.assignment,
                                    n_moves=len(r.moves),
                                    n_reverts=r.n_reverts,
                                    measured_rms=r.measured_rms,
                                    combined_cost=r.cost["combined"])
                       for s, r in kr["searches"].items()},
          "profile_s": {"kernel": kr["profile_s"], "plain": pr["profile_s"]},
          "search_s": {"kernel": kr["search_s"], "plain": pr["search_s"]},
          "launches": {"profile": kr["profile_launches"],
                       "search": kr["search_launches"],
                       "plan_pareto": pareto_launches},
          "plan_pareto": {"seconds": pareto_s, "points": pts,
                          "dominates": pareto[
                              "planned_dominates_global_hybrid"],
                          "dominated": pareto[
                              "planned_dominated_by_global_hybrid"],
                          "search": pareto["search"],
                          "sensitivity": pareto["sensitivity"]},
          "plan_pareto_ssm": {"arch": SSM_ARCH, "scale": "smoke",
                              "seconds": ssm_pareto_s, "points": spts,
                              "sites": ssm_pareto["sites"],
                              "dominates": ssm_pareto[
                                  "planned_dominates_global_hybrid"],
                              "launches": ssm_pareto_launches},
          "noisy_forward": {"site": "mlp/w2",
                            "candidate": TP.prototype_candidate().label,
                            "seconds": secs, "equal": True,
                            "kernel_launches": 0}})
    return {"planner_profile": kr["profile_launches"],
            "planner_search": kr["search_launches"],
            "plan_pareto": pareto_launches,
            "plan_pareto_ssm": ssm_pareto_launches}


def figure_twins_phase(torch, dev) -> dict:
    """Phase 35: the figure twins (figS2 at the reference's size, 4
    multipliers x 8 dies x 2,048 conversions, with the all-analog rows;
    fig5, figS1, fig2) on the card and on the CPU: every row's printed
    text and values equal (fig5's sweep time aside), no kernel launched;
    figS2's per-die RMS and each twin's seconds on both."""
    from repro_torch.launch import (fig2_contribution, fig5_transfer,
                                    figS1_cost, figS2_montecarlo)
    quiet = lambda *a: None
    twins = (("figS2", figS2_montecarlo.run), ("fig5", fig5_transfer.run),
             ("figS1", figS1_cost.run),
             ("fig2", lambda device, emit: fig2_contribution.run(emit)))
    rec = {}
    _reset_all_launches()
    for name, run in twins:
        out, secs = {}, {}
        for where in (dev, "cpu"):
            torch.cuda.synchronize()
            t0 = time.time()
            out[str(where)] = run(device=where, emit=quiet)
            torch.cuda.synchronize()
            secs[str(where)] = time.time() - t0
        card, cpu = out[str(dev)], out["cpu"]
        strip = lambda rows: {k: {f: v for f, v in r.items() if f != "us"}
                              for k, r in rows.items()}
        check(strip(card) == strip(cpu), f"phase 35: the {name} twin on the "
              "card differs from the CPU run")
        rec[name] = {"seconds": secs, "rows": len(card),
                     "derived": {k: r["derived"] for k, r in card.items()}}
        if name == "figS2":
            rec[name]["dies"] = {k: r["dies"] for k, r in card.items()
                                 if "dies" in r}
        if name == "fig5":
            rec[name]["sweep_us"] = {
                w: out[w]["fig5.transfer_sweep"]["us"] for w in out}
    check(not any(_all_launches().values()),
          "phase 35: a figure twin launched kernels")
    emit({"phase": "figure_twins", "ok": True, "card_equals_cpu": True,
          **rec})
    return rec


# -- phases 36-37: serving telemetry and the serve_bench twin ----------------

# phase 36 (b): the multi-tenant trace at full width
# 16 requests until phases 50-51 needed the time
MT_REQUESTS, MT_SLOTS, MT_PROMPT, MT_MAX_PROMPT = 12, 8, 128, 64
MT_BS, MT_CHUNK, MT_CAP, MT_RATE = 16, 32, 12, 0.5
# phase 36 (d): rows 1 and 2 alone, (K, N) at full width
CLIP_SHAPES = ((2304, 6912), (2304, 11520), (5760, 2304))
# phase 36 (c)'s stop lengths ((6, 10, 8, 12) until phases 42-43 needed
# the time)
SPEC_CLIP_STOPS = (4, 6, 5, 8)


# phase 36 (d): the prototype at ADC 7 and 5, and the all-analog macro
# at ADC 5 (the configuration that clips on these operands)
CLIP_CONFIGS = (dict(adc_bits=7), dict(adc_bits=5),
                dict(adc_bits=5, n_dcim_products=0))


def clip_rows(torch, dev, gen) -> dict:
    """Phase 36 (d): kernel rows 1 and 2 with the clip counter, at the
    full-width shapes, M 4 (row 1) and 128 (row 2), the prototype at ADC
    7 and 5 bits and the all-analog macro at 5: the outputs and the
    counts equal the plain version's; device time per call with the
    counter on and off, from CUDA-graph replays."""
    from repro_torch.core import engine
    from repro_torch.core.ccim import (CCIMConfig, _dcim_by_j, quantize_smf,
                                       smf_scale)
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.obs import taps

    def smf(shape):
        v = torch.randn(shape, generator=gen, device=dev)
        return quantize_smf(v, smf_scale(v, dim=-1, keepdim=True))

    out = {}
    for k, n in CLIP_SHAPES:
        wq = smf((n, k)).t()
        for ckw in CLIP_CONFIGS:
            cfg = CCIMConfig(**ckw)
            p = engine.pack_quantized_cim_weights(
                wq, torch.ones((1, n), device=dev), cfg)
            meta = dict(acc_len=cfg.acc_len, x_bits=tuple(_dcim_by_j(cfg)),
                        dcim_lsb=cfg.dcim_lsb, adc_half=cfg.adc_half_range)
            for m in (4, 128):
                x = smf((m, k))
                counts, ys = {}, {}
                for label, uk in (("kernel", True), ("plain", False)):
                    with taps.collect() as fr:
                        ys[label] = engine.packed_cim_matmul_int(
                            x, p, cfg, use_kernel=uk)
                        counts[label] = int(taps.drain_sum(fr, "adc_clip"))
                tag = (f"K {k} N {n} M {m} ADC {cfg.adc_bits} "
                       f"n_dcim {cfg.n_dcim_products}")
                check(torch.equal(ys["kernel"], ys["plain"]),
                      f"phase 36 (d) {tag}: kernel != plain")
                check(counts["kernel"] == counts["plain"],
                      f"phase 36 (d) {tag}: kernel counted "
                      f"{counts['kernel']} clips, plain {counts['plain']}")
                xp = x.to(torch.int8).contiguous()
                fn = (K.ccim_matmul_prepacked_skinny_cuda if m <= K.SKINNY_M
                      else K.ccim_matmul_prepacked_general_cuda)
                buf = torch.zeros((1,), dtype=torch.int32, device=dev)
                w, planes = p.kernel_w, p.kernel_planes
                on = graph_ms(torch, lambda: fn(xp, w, planes, **meta,
                                                clips=buf))
                off = graph_ms(torch, lambda: fn(xp, w, planes, **meta))
                out[tag] = {"row": 1 if m <= K.SKINNY_M else 2,
                            "clips": counts["kernel"],
                            "conversions": m * n * (k // cfg.acc_len),
                            "device_ms_counter_on": on,
                            "device_ms_counter_off": off}
    check(any(r["clips"] > 0 for r in out.values()),
          "phase 36 (d): no case clipped")
    by_row = {}
    for r in out.values():
        t = by_row.setdefault(r["row"], {"on": 0.0, "off": 0.0, "cases": 0})
        t["on"] += r["device_ms_counter_on"]
        t["off"] += r["device_ms_counter_off"]
        t["cases"] += 1
    return {"cases": out, "by_row_device_ms": by_row}


def telemetry_phase(torch, dev, params, cfg_full, phase4_tokens) -> dict:
    """Phase 36: telemetry at full width (minicpm-2b, prototype macro,
    packed and fused, captured).  (a) lock-step serve with metrics: the
    tokens of phase 4 and the four spans; (b) the paged scheduler on the
    multi-tenant trace, metrics off and on in turns: equal tokens, one
    flags read per iteration, ring TTFT == run_instrumented's first_iter,
    counted tokens == emitted, the same rows 1-3 kernel nodes per replay;
    (c) the contiguous speculative scheduler at draft ADC 5 with metrics,
    kernels and plain: equal tokens and ADC clips, clips > 0; (d) rows 1
    and 2 alone (``clip_rows``).  Returns rows 1-2 launches of (b)'s
    metrics-on runs."""
    import numpy as np
    from repro_torch.launch.paging import PagedLayout, cdiv
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests,
                                              multi_tenant_trace)
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.obs import ObsConfig, get_tracer
    from repro_torch.obs.fingerprint import graph_fingerprint
    from repro_torch.plan import draft_plan_for_model

    # (a) lock-step serve, captured, metrics on; the tracer keeps every
    # span since its last drain, so drain the earlier phases' first
    get_tracer().drain()
    toks, st = serve("minicpm-2b", smoke=False, batch=4, prompt_len=32,
                     gen=16, cim=True, params=params, return_stats=True,
                     metrics=True)
    names = {sp["name"] for sp in st["spans"]}
    want_spans = {"serve.pack", "serve.compile", "serve.prefill",
                  "serve.decode"}
    check((toks == phase4_tokens).all(),
          "phase 36 (a): serve(metrics=True) tokens != phase 4's")
    check(want_spans <= names, f"phase 36 (a): spans {sorted(names)}")
    check(st["metrics"]["serve_tokens_total"][0]["value"] >= 4 * 16,
          "phase 36 (a): the registry holds no token count")
    emit({"phase": "telemetry_lockstep", "ok": True,
          "tokens_equal_phase4": True, "spans": [
              {k: sp[k] for k in ("name", "dur_s", "attrs")}
              for sp in st["spans"]],
          "metrics": st["metrics"], "decode_tok_s": st["decode_tok_s"]})

    # (b) the paged multi-tenant trace, metrics off and on
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    reqs, arrivals = multi_tenant_trace(MT_REQUESTS, MT_MAX_PROMPT,
                                        cfg.vocab_size, MT_BS,
                                        arrival_rate=MT_RATE)
    lay = PagedLayout(block_size=MT_BS,
                      n_tbl=cdiv(MT_PROMPT + MT_CAP, MT_BS),
                      n_blocks=2 * MT_SLOTS * cdiv(MT_MAX_PROMPT + MT_CAP,
                                                   MT_BS) + 8)
    kw = dict(slots=MT_SLOTS, prompt_len=MT_PROMPT, max_new_cap=MT_CAP,
              paged=lay, prefill_chunk=MT_CHUNK)
    scheds = {"off": ContinuousBatchingScheduler(packed, cfg, **kw),
              "on": ContinuousBatchingScheduler(packed, cfg,
                                                obs=ObsConfig(), **kw)}
    runs = {"off": [], "on": []}
    first, on_launches = None, None
    for turn in ("off", "on") * 2:              # the first pair captures
        _reset_all_launches()
        rep = scheds[turn].run(reqs, arrivals)
        launches = _all_launches()
        toks = rep.tokens_by_rid()
        if first is None:
            first = toks
        check(all(_tokens_equal(toks[r], first[r]) for r in first),
              f"phase 36 (b) {turn}: tokens differ from the first run's")
        check(rep.host_syncs == rep.n_iter + 1, f"phase 36 (b) {turn}: "
              f"{rep.host_syncs} flags reads over {rep.n_iter} iterations")
        if turn == "on":
            check(rep.obs.counters["tokens"] == rep.total_tokens,
                  f"phase 36 (b): counted {rep.obs.counters['tokens']} "
                  f"tokens, emitted {rep.total_tokens}")
            on_launches = launches
        runs[turn].append(rep)
    inst, timeline = scheds["on"].run_instrumented(reqs, arrivals)
    ring = runs["on"][-1].obs.ttft_iters
    check(ring == {f.rid: f.first_iter for f in inst.finished},
          "phase 36 (b): ring TTFT != run_instrumented's first_iter")
    timed = {t: r[1:] for t, r in runs.items()}       # after the capture
    best = {t: max(r.tok_s for r in timed[t]) for t in timed}
    nodes = {t: graph_nodes(scheds[t]._graphs[0])[0] for t in scheds}
    check(nodes["on"] == nodes["off"] and any(nodes["on"].values()),
          f"phase 36 (b): rows 1-3 nodes per replay on {nodes['on']}, off "
          f"{nodes['off']}")
    snap = runs["on"][-1].obs
    steps = timeline["iter_s"][timeline["branch"] == 3]
    emit({"phase": "telemetry_paged", "ok": True, "requests": MT_REQUESTS,
          "slots": MT_SLOTS, "arrival_rate": MT_RATE,
          "arrival_iters": arrivals, "tokens_equal": True,
          "host_syncs_equal_n_iter_plus_1": True,
          "ring_ttft_equals_instrumented": True,
          "tok_s": {t: [r.tok_s for r in timed[t]] for t in timed},
          "on_off_best_tok_s_ratio": best["on"] / best["off"],
          "n_iter": runs["on"][-1].n_iter,
          "branch_counts": runs["on"][-1].branch_counts,
          "ttft_percentiles_s": inst.ttft_percentiles(),
          "latency_percentiles_s": inst.latency_percentiles(),
          "stall_factor": (float(np.percentile(timeline["iter_s"], 95))
                           / float(np.median(steps))),
          "median_step_ms": 1e3 * float(np.median(steps)),
          "rows_1_3_nodes_per_replay": nodes,
          "graph_fingerprint": {t: graph_fingerprint(scheds[t]._graphs[0])
                                for t in scheds},
          "launches_metrics_on": on_launches,
          "telemetry": snap.to_dict()})
    del scheds

    # (c) speculative at draft ADC 5, metrics on, kernels and plain (at
    # ADC 6 these weights and prompts clip no conversion)
    spec_reqs = mixed_length_requests(4, 16, cfg.vocab_size,
                                      stop_lengths=SPEC_CLIP_STOPS, seed=0)
    spec = {}
    for label, uk in (("kernel", None), ("plain", False)):
        c = dataclasses.replace(cfg, cim_use_kernel=uk)
        sched = ContinuousBatchingScheduler(
            packed, c, slots=4, prompt_len=16,
            max_new_cap=max(SPEC_CLIP_STOPS), draft_k=4,
            draft_plan=draft_plan_for_model(c, 5), obs=ObsConfig(),
            graphs=uk is None)
        _reset_all_launches()
        rep = sched.run(spec_reqs)
        spec[label] = (rep, _all_launches())
    (rk, lk), (rp, lp) = spec["kernel"], spec["plain"]
    check(all(_tokens_equal(rk.tokens_by_rid()[r], rp.tokens_by_rid()[r])
              for r in rk.tokens_by_rid()),
          "phase 36 (c): kernel and plain speculative tokens differ")
    ck, cp = rk.obs.counters["adc_clip"], rp.obs.counters["adc_clip"]
    check(ck == cp and ck > 0, f"phase 36 (c): ADC clips kernel {ck}, "
          f"plain {cp} (must be equal and > 0)")
    check(lp["skinny"] == 0 and lp["general"] == 0 and lk["skinny"] > 0,
          f"phase 36 (c): launches kernel {lk}, plain {lp}")
    del packed
    rows = clip_rows(torch, dev, torch.Generator(device=dev).manual_seed(36))
    emit({"phase": "telemetry_clips", "ok": True,
          "speculative": {"draft_adc_bits": 5, "adc_clip": ck,
                          "acceptance_rate": rk.acceptance_rate,
                          "tokens_equal_plain": True,
                          "launches_kernel": lk},
          "rows": rows})
    return {k_: on_launches[k_] for k_ in ("general", "skinny")}


def serve_bench_phase() -> dict:
    """Phase 37: the serve_bench twin at its smoke sizes with its gates,
    in a process of its own; its JSON document on one line."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_bench", "--smoke",
         "--gate", "--repeats", "1"], capture_output=True, text=True,
        env=env, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, "phase 37: serve_bench --smoke "
          f"--gate exited {proc.returncode}: {proc.stderr[-2000:]}"
          f"{lines[-1][:4000] if lines else ''}")
    result = json.loads(lines[-1])
    emit({"phase": "serve_bench", "ok": True, **result})
    return result


# -- phases 38-39: resilience ------------------------------------------------

# phase 38's segment length (the reference bench's) and stuck-at model
RES_SEGMENT = 4
RES_STUCK = dict(seed=11, stuck_frac=0.01)
# the leaves whose layer-0 stuck-at faults phase 38 also draws on the CPU
RES_CPU_LEAVES = ("layers/attn/wo", "layers/mlp/w2")


def _packed_leaves(tree, path=()):
    """(tree path, leaf) of every packed leaf of a params tree."""
    from repro_torch.core.engine import FusedPackedCimWeights, PackedCimWeights
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _packed_leaves(v, path + (k,))
        elif isinstance(v, (PackedCimWeights, FusedPackedCimWeights)):
            out.append((path + (k,), v))
    return out


def _layer0_tree(leaves, device):
    """A params tree holding layer 0 of each packed leaf, on ``device``,
    at the leaves' own tree paths (a 2-D leaf's fault draw is layer 0's
    of the stacked leaf's)."""
    import torch
    tree = {}
    for path, v in leaves:
        one = v.layer(0)
        pk = getattr(one, "packed", one)
        moved = dataclasses.replace(
            pk, scale=pk.scale.to(device), kernel_w=pk.kernel_w.to(device),
            kernel_planes=pk.kernel_planes.to(device))
        if pk is not one:
            moved = dataclasses.replace(one, packed=moved)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = moved
    return tree


def resilience_phase(torch, dev, params, cfg_full) -> dict:
    """Phase 38: resilience at full width (minicpm-2b, 40 layers, seed-0
    weights, packed and fused, prototype macro) on phase 9's first 8
    prompts at half their stop lengths, 8 slots, segments of 4 loop
    iterations: (a) the clean guarded run GREEN with no action, its
    tokens equal to the plain captured scheduler's, every rung's graphs
    captured in ``compile_for`` and none while serving, rows 1-2 launches
    equal to the hybrid graph's replays times its kernel nodes plus the
    admits' general GEMMs, and ``check_replays`` on the analog and hybrid
    step graphs; (b) the chaos run under the bench's drift ramp twice,
    RED and on the digital rung, logs equal; (c) the fault-armed fast
    GEMM (layer 0 ``wo``, M 4) replayed from one graph at clocks 0, 12
    and 64 equal to its eager call and unlike the clean output past the
    onset; (d) the same GEMM on the CPU, and ``apply_weight_faults`` on
    layer 0 of every packed leaf, card == CPU; (e) one turn per rung
    (tok/s, a replayed step's ms) and the digital rung's ``wq()`` and
    float64 GEMM times, reported.  Returns the clean run's launches."""
    from repro_torch.core.ccim import int_matmul_exact
    from repro_torch.core.engine import packed_cim_matmul_int
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.resilience_bench import _DRIFT
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.models import lm
    from repro_torch.resilience import failover as FO
    from repro_torch.resilience import faults as F
    from repro_torch.resilience import watchdog as W

    slots, plen, stops, n_req = 8, 64, (4, 12, 8, 16), 8
    cfg = dataclasses.replace(cfg_full, cim_mode=True)
    reqs = mixed_length_requests(n_req, plen, cfg.vocab_size,
                                 stop_lengths=stops, seed=0)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev)
    base = dict(slots=slots, prompt_len=plen, max_new_cap=max(stops))
    n_gemm = 4 * cfg.n_layers

    # (a) the clean guarded run against the plain captured scheduler
    t0 = time.time()
    plain = ContinuousBatchingScheduler(packed, cfg, **base).run(reqs)
    want = plain.tokens_by_rid()
    plain_rec = dict(tok_s=plain.tok_s, wall_s=plain.wall_s)
    del plain
    server = FO.GuardedServer(packed, cfg, watchdog=W.Watchdog(),
                              probe=FO.default_probe(packed),
                              segment_iters=RES_SEGMENT, **base)
    t1 = time.time()
    server.compile_for(n_req)
    torch.cuda.synchronize()
    compile_s = time.time() - t1
    caps = server.captures()
    check(caps == len(server.ladder), f"phase 38: compile_for captured "
          f"{caps} graphs for {len(server.ladder)} rungs")
    hybrid = server.scheduler()._graphs[0]
    replays0 = hybrid.replays
    _reset_all_launches()
    rep, log = server.run(reqs)
    torch.cuda.synchronize()
    launches = _all_launches()
    check(server.captures() == caps, "phase 38: a graph was captured while "
          "serving")
    check(server.watchdog.state == W.GREEN and not log.actions,
          f"phase 38 clean: {server.watchdog.state}, actions {log.actions}")
    got = rep.tokens_by_rid()
    check(all(_tokens_equal(got[r], want[r]) for r in want),
          "phase 38 clean: guarded tokens != the plain captured scheduler's")
    replays = hybrid.replays - replays0
    credit = hybrid.launches
    # the hybrid step's replays, and the golden probe's GEMM (M 4, row 1)
    # once a window
    check(launches["skinny"] == replays * credit.get(
        "ccim_matmul_prepacked_skinny_cuda", 0) + log.n_segments
          and replays > 0,
          f"phase 38 clean: {launches['skinny']} skinny launches, the graph "
          f"replayed {replays} times crediting {credit}, "
          f"{log.n_segments} probes")
    check(launches["general"] == n_gemm * rep.n_admits,
          f"phase 38 clean: {launches['general']} general launches, "
          f"expected {n_gemm} per admit x {rep.n_admits}")
    with torch.inference_mode():
        traces = {server.ladder[i].label: check_replays(
            torch, server._scheds[i]._graphs[0],
            f"phase 38 rung {server.ladder[i].label}") for i in (0, 1)}
    clean = dict(tok_s=rep.tok_s, wall_s=rep.wall_s, plain=plain_rec,
                 n_iter=rep.n_iter,
                 n_admits=rep.n_admits, compile_s=compile_s, captures=caps,
                 launches={k: launches[k] for k in ("skinny", "general")},
                 hybrid_replays=replays, graph_credit=credit,
                 replay_traces=traces, probe_clean_floor=
                 server.probe.clean_floor, resilience=log.to_dict(),
                 t_run_s=time.time() - t0)
    emit({"phase": "resilience_clean", "ok": True, **clean})

    # (e) one turn per rung on the same server (every rung is captured),
    # and the digital rung's exact GEMM pieces
    server.watchdog = server.probe = None     # each turn stays on its rung
    rungs = []
    for i, rung in enumerate(server.ladder):
        server.start_rung = i
        r, _ = server.run(reqs)
        with torch.inference_mode():
            step_ms = cuda_ms(server._scheds[i]._graphs[0], reps=10)
        rungs.append(dict(rung=i, label=rung.label, tok_s=r.tok_s,
                          wall_s=r.wall_s, n_iter=r.n_iter,
                          replayed_step_ms=step_ms,
                          iter_ms=1e3 * r.wall_s / r.n_iter))
    check(server.captures() == caps, "phase 38 rungs: captured while serving")
    del server
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    leaves = _packed_leaves(packed)
    exact = {}
    with torch.inference_mode():
        for path, v in leaves:
            one = v.layer(0)
            one = getattr(one, "packed", one)
            xq = torch.randint(-127, 128, (slots, one.k_dim), generator=gen,
                               device=dev, dtype=torch.int32)
            wq = one.wq()
            exact["/".join(path)] = dict(
                wq_ms=cuda_ms(one.wq, reps=10),
                f64_gemm_ms=cuda_ms(lambda: int_matmul_exact(xq, wq),
                                    reps=10))
    per_layer = sum(v["wq_ms"] + v["f64_gemm_ms"] for v in exact.values())
    emit({"phase": "resilience_rungs", "ok": True, "rungs": rungs,
          "digital_exact_layer0": exact, "digital_exact_ms_per_layer":
          per_layer, "digital_exact_ms_per_step_est":
          per_layer * cfg.n_layers})

    # (b) the chaos run, twice: RED, the digital rung, equal logs
    logs, runs = [], []
    for turn in range(2):
        fault = F.FaultModel(**_DRIFT)
        s = FO.GuardedServer(
            packed, cfg, fault=fault,
            watchdog=W.Watchdog(W.WatchdogConfig(debounce=1)),
            probe=FO.default_probe(packed, fault=fault),
            segment_iters=RES_SEGMENT, **base)
        s.compile_for(n_req)
        caps = s.captures()
        r, lg = s.run(reqs)
        check(s.captures() == caps, "phase 38 chaos: captured while serving")
        check(s.watchdog.state == W.RED and lg.actions
              and lg.final_rung == len(s.ladder) - 1,
              f"phase 38 chaos: {s.watchdog.state}, final rung "
              f"{lg.final_rung}, actions {lg.actions}")
        logs.append(lg.to_dict())
        runs.append(dict(tok_s=r.tok_s, wall_s=r.wall_s, n_iter=r.n_iter,
                         total_tokens=r.total_tokens))
        del s
    check(logs[0] == logs[1], "phase 38 chaos: two servers' logs differ")
    det = logs[0]["detection_tokens"]
    first = next(w for w in logs[0]["watchdog"]["windows"]
                 if w["state"] != W.GREEN)
    red = next(w for w in logs[0]["watchdog"]["windows"]
               if w["state"] == W.RED)
    check(red["n_iter"] < runs[0]["n_iter"],
          "phase 38 chaos: RED only when the queue was served")
    check(det is not None and det <= 32, f"phase 38 chaos: detection at "
          f"{det} tokens, past the reference's 32-token budget")
    tok_per_window = runs[0]["total_tokens"] / max(
        1, logs[0]["n_segments"])
    emit({"phase": "resilience_chaos", "ok": True, "fault": _DRIFT,
          "detection_tokens": det, "detection_n_iter": first["n_iter"],
          "red_n_iter": red["n_iter"], "reference_budget_tokens": 32,
          "within_reference_budget": det is not None and det <= 32,
          "tokens_per_window": tok_per_window, "runs": runs,
          "logs_equal": True, "resilience": logs[0]})

    # (c)/(d) the clock in a replayed graph; card against CPU
    leaf = W.first_packed_leaf(packed)
    x = torch.randint(-127, 128, (4, leaf.k_dim), generator=gen, device=dev,
                      dtype=torch.int32)
    leaf_cpu = dataclasses.replace(
        leaf, scale=leaf.scale.cpu(), kernel_w=leaf.kernel_w.cpu(),
        kernel_planes=leaf.kernel_planes.cpu())
    mm = lambda xx, p: packed_cim_matmul_int(xx, p, p.cfg)
    fault = F.FaultModel(**_DRIFT)
    clk = torch.zeros((), dtype=torch.int32, device=dev)
    clock_rec = {}
    with torch.inference_mode():
        y_clean = mm(x, leaf)
        with F.inject(fault), F.clock(clk):
            g = StepGraph(lambda: mm(x, leaf), dev)
            g()
            for t in (0, 12, 64):
                clk.fill_(t)
                y = g().clone()
                e = mm(x, leaf)
                check(torch.equal(y, e), f"phase 38: replay != eager at t {t}")
                with F.clock(torch.tensor(t, dtype=torch.int32)):
                    yc = mm(x.cpu(), leaf_cpu)
                check(torch.equal(y.cpu(), yc),
                      f"phase 38: card != CPU at t {t}")
                check(torch.equal(y, y_clean) == (t <= _DRIFT["onset"]),
                      f"phase 38: clean-equality wrong at t {t}")
                clock_rec[t] = int((y != y_clean).sum())
            eager_ms = cuda_ms(lambda: mm(x, leaf), reps=10)
            replay_ms = cuda_ms(g, reps=20)
        kernel_ms = cuda_ms(lambda: mm(x, leaf), reps=20)
    emit({"phase": "resilience_clock", "ok": True, "shape": [
          4, leaf.k_dim, leaf.n_dim], "replay_equals_eager": True,
          "card_equals_cpu": True, "changed_outputs_by_clock": clock_rec,
          "faulted_eager_ms": eager_ms, "faulted_replay_ms": replay_ms,
          "clean_kernel_ms": kernel_ms})

    # apply_weight_faults on layer 0 of every packed leaf on the card; on
    # the CPU for the leaves RES_CPU_LEAVES names (the probe's ``wo``, and
    # ``w2``, whose tag passes 2^31): the CPU's threefry took 40 s for all
    # four
    model = F.FaultModel(**RES_STUCK)
    t1 = time.time()
    with torch.inference_mode():
        on_dev = F.apply_weight_faults(model, _layer0_tree(leaves, dev))
        torch.cuda.synchronize()
        dev_s = time.time() - t1
        t1 = time.time()
        on_cpu = F.apply_weight_faults(model, _layer0_tree(
            [(p, v) for p, v in leaves if "/".join(p) in RES_CPU_LEAVES],
            "cpu"))
        cpu_s = time.time() - t1
    cpu_leaves = dict(_packed_leaves(on_cpu))
    masks = {}
    for path, a in _packed_leaves(on_dev):
        a = getattr(a, "packed", a)
        one = dict(leaves)[path].layer(0)
        one = getattr(one, "packed", one)
        masks["/".join(path)] = dict(
            shape=[a.k_dim, a.n_dim], tag=F.path_tag(path),
            changed_share=float((a.wq() != one.wq()).float().mean()),
            card_equals_cpu=None)
        if path in cpu_leaves:
            b = getattr(cpu_leaves[path], "packed", cpu_leaves[path])
            check(torch.equal(a.kernel_w.cpu(), b.kernel_w)
                  and torch.equal(a.kernel_planes.cpu(), b.kernel_planes),
                  f"phase 38: stuck-at faults of {path} card != CPU")
            masks["/".join(path)]["card_equals_cpu"] = True
    check(len(cpu_leaves) == len(RES_CPU_LEAVES), "phase 38: the CPU "
          f"compared {sorted(cpu_leaves)}, not {RES_CPU_LEAVES}")
    emit({"phase": "resilience_stuck", "ok": True, "model": RES_STUCK,
          "layer": 0, "leaves": masks, "card_s": dev_s, "cpu_s": cpu_s})
    del on_dev, on_cpu, packed
    return clean["launches"]


def resilience_twin_phase() -> dict:
    """Phase 39: the resilience bench twin at its smoke config in a process
    of its own (one repeat per rung), its five gates held."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.resilience_bench",
         "--repeats", "1"], capture_output=True, text=True, env=env,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, "phase 39: resilience_bench "
          f"exited {proc.returncode}: {proc.stderr[-2000:]}"
          f"{lines[-1][:4000] if lines else ''}")
    result = json.loads(lines[-1])
    emit({"phase": "resilience_bench", "ok": True,
          "gates": [ln for ln in lines if ln.startswith("#")], **result})
    return result


# phases 40-43: the SSM family (mamba2-130m) and the hybrid family
# (zamba2-1.2b) at full width and depth, on the same serving workloads
SSM_ARCH = "mamba2-130m"
HYBRID_ARCH = "zamba2-1.2b"
# phases 40 and 42's lock-step runs generate SSM_GEN tokens (32 until
# phases 48-49 needed the time)
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 128, 16
# phases 41 and 43: requests over 8 slots, 2 of them refilled (16
# requests until phases 44-46 and 12 until phases 48-49 needed the time)
SSM_SLOTS, SSM_REQUESTS, SSM_STOPS = 8, 10, (8, 16, 24, 32)
# phase 43: the requests served solo (held to the pool; 3 until phases
# 48-49 needed the time) and through the plain paged read (agreement
# reported; 4 until phases 44-46 needed the time)
HYBRID_SOLO, HYBRID_PLAIN_READ = 2, 2
RECURRENT_PHASES = {SSM_ARCH: (40, "ssm"), HYBRID_ARCH: (42, "hybrid")}


def _macro_gemms_per_forward(packed, cfg) -> int:
    """Macro GEMMs one forward of a packed model runs, read from its
    params tree: each packed leaf is one GEMM (a fused group counts
    once), the stacked layers' once a layer, the hybrid's shared block's
    once an invocation."""
    from repro_torch.core.engine import (FusedPackedCimWeights,
                                         PackedCimWeights)
    from repro_torch.models import lm

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return int(isinstance(t, (PackedCimWeights, FusedPackedCimWeights)))
    return (count(packed["layers"]) * cfg.n_layers
            + count(packed.get("shared", {})) * lm.n_shared_invocations(cfg))


def _recurrent_model(torch, dev, arch: str):
    """``arch`` at full width, random weights from seed 0: the config,
    the raw params, the packed params (prototype macro, fused) and the
    macro GEMMs of one forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    params = lm.init(0, cfg, device=dev)
    ccfg = dataclasses.replace(cfg, cim_mode=True)
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, ccfg, dev)
    return cfg, params, packed, _macro_gemms_per_forward(packed, cfg)


def recurrent_lockstep_phase(torch, dev, arch: str, model) -> dict:
    """Phases 40 (mamba2-130m) and 42 (zamba2-1.2b): lock-step (batch 4,
    prompt 128: one SSD chunk, 32 generated) through the kernels and
    through their plain versions (graphs off: the wrappers' own counts),
    captured, and on the raw weights (row 6): equal tokens and last
    logits in all four, the launches of rows 1, 2 and 6 equal to the
    packed tree's GEMMs per forward (mamba2: the fused input group and
    out_proj a layer; the hybrid adds the shared block's QKV, wo, w1+w3
    and w2 an invocation) times the forwards, a replayed decode step's
    kernel nodes equal to its credit (``check_replays``).  Reports the
    replayed step against the bound of one read of the macro weights a
    step (the shared block once an invocation: it does not stay in L2)
    and the lm_head, decode tok/s, pack and peak bytes and the state a
    slot.  ``model`` is ``_recurrent_model``'s.  Returns the launches by
    path of rows 1, 2 and 6."""
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.serve import decode_body, serve, tree_bytes
    from repro_torch.models import lm

    phase, tag = RECURRENT_PHASES[arch]
    cfg, params, packed, n_fwd = model
    want = {"packed": {"skinny": n_fwd * (SSM_GEN - 1), "general": n_fwd,
                       "unpacked": 0},
            "unpacked": {"skinny": 0, "general": 0,
                         "unpacked": n_fwd * SSM_GEN}}
    runs = {}
    for label, kw in (("kernel", dict(graphs=False)),
                      ("plain", dict(graphs=False, use_kernel=False)),
                      ("captured", dict(graphs=True)),
                      ("unpacked", dict(pack=False))):
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks, st = serve(arch, smoke=False, batch=SSM_BATCH,
                         prompt_len=SSM_PROMPT, gen=SSM_GEN, cim=True,
                         params=params, return_stats=True, **kw)
        torch.cuda.synchronize()
        logits = st.pop("last_logits")
        runs[label] = dict(toks=toks, logits=logits,
                           launches=_rows_launches(),
                           peak=torch.cuda.max_memory_allocated(), **{
                               k: st[k] for k in (
                                   "pack_s", "pack_bytes", "prefill_s",
                                   "decode_s", "decode_tok_s", "replay_tok_s",
                                   "capture_s", "graph_pool_bytes")
                               if k in st})
        check(toks.shape == (SSM_BATCH, SSM_GEN)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
              and bool(torch.isfinite(logits).all()),
              f"phase {phase} {label}: tokens out of range or logits not "
              "finite")
    k = runs["kernel"]
    for label in ("plain", "captured", "unpacked"):
        r = runs[label]
        check((r["toks"] == k["toks"]).all()
              and torch.equal(r["logits"], k["logits"]),
              f"phase {phase}: {label} tokens or last logits != the "
              "kernels'")
    for label, w in (("kernel", want["packed"]), ("captured", want["packed"]),
                     ("unpacked", want["unpacked"])):
        check(runs[label]["launches"] == w, f"phase {phase} {label}: "
              f"launches {runs[label]['launches']}, expected {w}")
    check(not any(runs["plain"]["launches"].values()),
          f"phase {phase}: the plain run launched kernels")
    # one captured decode step: its kernel nodes, a traced replay, its ms
    ccfg = dataclasses.replace(cfg, cim_mode=True)
    with torch.inference_mode():
        max_seq = SSM_PROMPT + 32
        cache = lm.init_cache(ccfg, SSM_BATCH, max_seq, device=dev)
        prompt = torch.zeros((SSM_BATCH, SSM_PROMPT), dtype=torch.int64,
                             device=dev)
        _, cache = lm.prefill(packed, ccfg, prompt, cache)
        tok = prompt[:, :1].clone()
        out = torch.zeros((SSM_BATCH, max_seq), dtype=torch.int64,
                          device=dev)
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        graph = StepGraph(decode_body(packed, ccfg, tok, cache, out, col),
                          dev)
        graph()
        graph()
        check(graph.launches == {"ccim_matmul_prepacked_skinny_cuda":
                                 n_fwd},
              f"phase {phase}: the captured step credits {graph.launches}")
        trace = check_replays(torch, graph, f"phase {phase} decode step")
        replay_ms = cuda_ms(graph, reps=10, warmup=1)
    n_inv = lm.n_shared_invocations(cfg)
    bound_bytes = {"macro_layers": tree_bytes(packed["layers"]),
                   "shared_block": tree_bytes(packed.get("shared", {})),
                   "shared_invocations": n_inv,
                   "lm_head": packed["lm_head"].numel()
                   * packed["lm_head"].element_size()}
    step_bytes = (bound_bytes["macro_layers"] + bound_bytes["lm_head"]
                  + n_inv * bound_bytes["shared_block"])
    state_bytes = {name: t[:, :1].numel() * t.element_size()
                   for name, t in cache.items() if name != "pos"}
    del cache, graph
    emit({"phase": f"{tag}_lockstep", "ok": True, "arch": arch,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
          "ssm_heads": cfg.ssm_heads, "ssm_chunk": cfg.ssm_chunk,
          "shared_invocations": n_inv, "vocab": cfg.vocab_size,
          "batch": SSM_BATCH, "prompt_len": SSM_PROMPT, "gen": SSM_GEN,
          "macro_gemms_per_forward": n_fwd,
          "tokens_equal": ["plain", "captured", "unpacked"],
          "logits_equal": True,
          "runs": {lab: {k_: v for k_, v in r.items()
                         if k_ not in ("toks", "logits")}
                   for lab, r in runs.items()},
          "replayed_step_ms": replay_ms, "replay_trace": trace,
          "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_S,
          "decode_bound_bytes": bound_bytes,
          "state_bytes_per_slot": state_bytes, "state_max_seq": max_seq,
          "tokens_row0": k["toks"][0].tolist()})
    return {f"{tag}_serve": runs["kernel"]["launches"],
            f"{tag}_serve_captured": runs["captured"]["launches"],
            f"{tag}_serve_unpacked": runs["unpacked"]["launches"]}


def _queue_runs(torch, cfg, packed, n_fwd, reqs, runs, phase):
    """The scheduler over ``reqs`` (8 slots, captured) once per (label,
    scheduler kwargs, cfg) of ``runs``: rows 1-2 launches equal the GEMMs
    per forward times the forwards (admits or chunks, pooled steps), row
    3's equal the shared-block invocations times the pooled steps of a
    paged pool reading through the kernel, every request admitted and
    answered, a paged pool's refcounts drained, the pooled step's replay
    held to its kernel nodes.  Returns the records, the tokens by rid and
    the launches by label."""
    from repro_torch.launch.scheduler import ContinuousBatchingScheduler
    from repro_torch.models import lm

    n_inv = lm.n_shared_invocations(cfg)
    cap = max(SSM_STOPS)
    recs, toks, launches_by = {}, {}, {}
    for label, kw, rcfg in runs:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        sched = ContinuousBatchingScheduler(
            packed, rcfg, slots=SSM_SLOTS, prompt_len=SSM_PROMPT,
            max_new_cap=cap, **kw)
        rep = sched.run(reqs)
        torch.cuda.synchronize()
        launches = dict(_rows_launches(),
                        paged_attn=_all_launches()["paged_attn"])
        # prefill forwards: the admits (contiguous) or the chunks (paged),
        # on row 2 at M 128 and on row 1 at M 32
        paged = "paged" in kw
        prefills = rep.n_pf if paged else rep.n_admits
        on_row1 = kw.get("prefill_chunk", SSM_PROMPT) <= 32
        want = {"general": 0 if on_row1 else n_fwd * prefills,
                "skinny": n_fwd * (rep.n_steps + (prefills if on_row1
                                                  else 0)),
                "unpacked": 0,
                "paged_attn": (n_inv * rep.n_steps
                               if paged and rcfg.paged_attn_use_kernel
                               is not False else 0)}
        check(launches == want, f"phase {phase} {label}: launches "
              f"{launches}, expected {want}")
        check(rep.n_admits == len(reqs) and all(
            len(f.tokens) > 0 for f in rep.finished),
            f"phase {phase} {label}: {rep.n_admits} admits")
        if paged:
            check(rep.ref_final.tolist()
                  == [1] + [0] * (kw["paged"].n_blocks - 1),
                  f"phase {phase} {label}: refcounts did not drain")
        trace = check_replays(torch, sched._graphs[0],
                              f"phase {phase} {label} pooled step")
        toks[label] = rep.tokens_by_rid()
        launches_by[label] = launches
        recs[label] = dict(
            rep.summary(), n_iter=rep.n_iter, n_pf=rep.n_pf,
            n_steps=rep.n_steps, host_syncs=rep.host_syncs,
            refilled_slots=max(rep.n_admits - SSM_SLOTS, 0),
            branch_counts=rep.branch_counts,
            iter_ms=1e3 * rep.wall_s / max(rep.n_iter, 1),
            launches=launches, capture=sched.graph_stats(),
            replay_trace=trace,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        del sched
    return recs, toks, launches_by


def _queue_layout():
    from repro_torch.launch.paging import PagedLayout, cdiv
    n_tbl = cdiv(SSM_PROMPT + max(SSM_STOPS) - 1, PA_BS)
    return PagedLayout(block_size=PA_BS, n_tbl=n_tbl,
                       n_blocks=SSM_SLOTS * n_tbl + 1)


def _same_tokens(a: dict, b: dict, rids=None) -> int:
    import numpy as np
    return sum(np.array_equal(a[r], b[r]) for r in (rids or b))


def ssm_continuous_phase(torch, dev, model) -> dict:
    """Phase 41: mamba2-130m continuous batching, 12 requests of 128
    tokens (stops 8-32) over 8 slots (4 refilled), captured: the contiguous pool, the
    paged pool with prefill chunks of 128 (aligned with the SSD chunk:
    tokens equal the contiguous pool's, gated) and with chunks of 32 (row
    1 at M 32; agreement reported, not gated); ``_queue_runs``'s gates.
    Returns the launches by path of rows 1, 2 and 6."""
    from repro_torch.launch.scheduler import mixed_length_requests
    from repro_torch.models import lm

    cfg, _, packed, n_fwd = model
    ccfg = dataclasses.replace(cfg, cim_mode=True)
    reqs = mixed_length_requests(SSM_REQUESTS, SSM_PROMPT, cfg.vocab_size,
                                 stop_lengths=SSM_STOPS, seed=0)
    layout = _queue_layout()
    recs, toks, launches = _queue_runs(
        torch, ccfg, packed, n_fwd, reqs,
        (("contiguous", {}, ccfg),
         ("paged", dict(paged=layout, prefill_chunk=SSM_PROMPT), ccfg),
         ("paged_c32", dict(paged=layout, prefill_chunk=32), ccfg)), 41)
    check(all(recs[k]["refilled_slots"] > 0 for k in recs),
          "phase 41: a pool refilled no slot")
    n_paged = _same_tokens(toks["paged"], toks["contiguous"])
    check(n_paged == SSM_REQUESTS, f"phase 41: paged (chunk "
          f"{SSM_PROMPT}) tokens equal the contiguous pool's on {n_paged}"
          f" of {SSM_REQUESTS} requests")
    with torch.inference_mode():
        one = lm.init_cache(ccfg, 1, 1, device=dev)
    state_bytes = {k: t.numel() * t.element_size() for k, t in one.items()
                   if k != "pos"}
    emit({"phase": "ssm_continuous", "ok": True, "arch": SSM_ARCH,
          "requests": SSM_REQUESTS, "prompt_len": SSM_PROMPT,
          "stop_lengths": list(SSM_STOPS), "slots": SSM_SLOTS,
          "paged_layout": [layout.block_size, layout.n_tbl,
                           layout.n_blocks],
          "paged_equal_contiguous": n_paged,
          "paged_c32_equal_contiguous": _same_tokens(toks["paged_c32"],
                                                     toks["contiguous"]),
          "ssm_state_bytes_per_slot": state_bytes, "runs": recs})
    return {f"ssm_scheduler_{k}": v for k, v in launches.items()}


def hybrid_continuous_phase(torch, dev, model) -> dict:
    """Phase 43: zamba2-1.2b continuous batching, phase 41's 12 requests
    of 128 tokens (stops 8-32) over 8 slots (4 refilled), captured: the contiguous
    pool and the paged pool with prefill chunks of 128 (the shared
    block's KV paged: 6 row-3 launches a pooled step), with
    ``_queue_runs``'s gates, and the paged pool equal to solo runs of
    requests 0-2.  Reported, not gated: how many requests' paged tokens
    equal the contiguous pool's (the kernel's float32 P.V can move a bf16
    activation by one ulp, and in CIM mode an ADC code with it), and the
    paged pool's agreement with the paged read's plain version on the
    first 2 requests.  Returns the launches by path of rows 1, 2, 3 and
    6."""
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.models import lm

    cfg, _, packed, n_fwd = model
    ccfg = dataclasses.replace(cfg, cim_mode=True)
    plain = dataclasses.replace(ccfg, paged_attn_use_kernel=False)
    reqs = mixed_length_requests(SSM_REQUESTS, SSM_PROMPT, cfg.vocab_size,
                                 stop_lengths=SSM_STOPS, seed=0)
    layout = _queue_layout()
    paged = dict(paged=layout, prefill_chunk=SSM_PROMPT)
    recs, toks, launches = _queue_runs(
        torch, ccfg, packed, n_fwd, reqs,
        (("contiguous", {}, ccfg), ("paged", paged, ccfg)), 43)
    plain_recs, plain_toks, _ = _queue_runs(
        torch, plain, packed, n_fwd, reqs[:HYBRID_PLAIN_READ],
        (("paged_plain_read", paged, plain),), 43)
    check(all(recs[k]["refilled_slots"] > 0 for k in recs),
          "phase 43: a pool refilled no slot")
    recs.update(plain_recs)
    rids = [r.rid for r in reqs[:HYBRID_SOLO]]
    solo = {}
    for r in reqs[:HYBRID_SOLO]:
        solo.update(ContinuousBatchingScheduler(
            packed, ccfg, slots=1, prompt_len=SSM_PROMPT,
            max_new_cap=max(SSM_STOPS), **paged).run([r]).tokens_by_rid())
    n_solo = _same_tokens(toks["paged"], solo, rids)
    check(n_solo == HYBRID_SOLO, f"phase 43: the paged pool's tokens equal "
          f"solo runs on {n_solo} of requests 0-{HYBRID_SOLO - 1}")
    with torch.inference_mode():
        one = lm.init_cache(ccfg, 1, layout.tokens_per_slot, device=dev)
    state_bytes = {k: t.numel() * t.element_size() for k, t in one.items()
                   if k != "pos"}
    emit({"phase": "hybrid_continuous", "ok": True, "arch": HYBRID_ARCH,
          "requests": SSM_REQUESTS, "prompt_len": SSM_PROMPT,
          "stop_lengths": list(SSM_STOPS), "slots": SSM_SLOTS,
          "paged_layout": [layout.block_size, layout.n_tbl,
                           layout.n_blocks],
          "paged_equal_solo": n_solo,
          "paged_equal_contiguous": _same_tokens(toks["paged"],
                                                 toks["contiguous"]),
          "paged_equal_plain_read": _same_tokens(
              toks["paged"], plain_toks["paged_plain_read"]),
          "plain_read_requests": HYBRID_PLAIN_READ,
          "state_bytes_per_slot": state_bytes,
          "state_max_seq": layout.tokens_per_slot, "runs": recs})
    return {f"hybrid_scheduler_{k}": v for k, v in launches.items()}


DENSE_PHASES = {"qwen3-14b": 44, "starcoder2-7b": 45, "gemma2-9b": 46}
VLM_PHASE, VLM_ARCH, AUDIO_PHASE, AUDIO_ARCH = (48, "paligemma-3b", 49,
                                                "musicgen-medium")
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 32, 16     # phase 4's workload
DENSE_PLAIN_GEN = 4          # tokens of the eager and plain comparison runs
DENSE_ENTRY_BYTES = 2 * 2 ** 30    # allocated at a dense phase's entry
DENSE_QUEUE = 6              # phase 9's first requests, phase 46's queues
                             # (8 until phases 50-51 needed the time)
DENSE_SOLO = 1               # 2 until phases 48-49 needed the time


def gc_collect(torch) -> None:
    """Free what unreachable objects (graphs, caches) still hold on the
    card before a phase reads ``memory_allocated``."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _dense_model(torch, dev, arch: str, phase: int, raw_hook=None):
    """``arch`` at full width and depth, random weights from seed 0 (the
    serve functions' own), packed and fused on the prototype macro by
    ``pack_cim_params(consume=True)``: each raw projection is released
    once packed, so the raw stack and the pack are never both whole on
    the card.  ``raw_hook(cfg, params)`` runs on the raw weights before
    the pack.  Fails unless at most 2 GB is allocated at entry (nothing
    of an earlier phase live).  Returns the CIM config, the packed params
    and the memory record (init and pack seconds and peaks)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import tree_bytes
    from repro_torch.models import lm

    gc_collect(torch)
    entry = torch.cuda.memory_allocated()
    check(entry <= DENSE_ENTRY_BYTES, f"phase {phase}: {entry} bytes "
          "allocated at entry (an earlier phase's tensors are live)")
    cfg = dataclasses.replace(get_config(arch), cim_mode=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    mem = dict(entry_bytes=entry, init_s=time.perf_counter() - t0,
               init_peak_bytes=torch.cuda.max_memory_allocated(),
               raw_bytes=tree_bytes(params))
    if raw_hook is not None:
        raw_hook(cfg, params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        packed = lm.pack_cim_params(params, cfg, dev, consume=True)
    del params
    torch.cuda.synchronize()
    mem.update(pack_s=time.perf_counter() - t0,
               pack_peak_bytes=torch.cuda.max_memory_allocated(),
               pack_bytes=tree_bytes(packed),
               layers_pack_bytes=tree_bytes(packed["layers"]))
    return cfg, packed, mem


def _layer_leaves(tree, path="") -> dict:
    """A layer's macro GEMMs of a pack (``packed["layers"]``), plan path
    -> the stacked ``PackedCimWeights`` (fused groups unwrapped): the
    dense configs' four, the moe's attention and shared expert."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_layer_leaves(leaf, f"{path}{key}/"))
            continue
        leaf = getattr(leaf, "packed", leaf)
        if hasattr(leaf, "kernel_w"):
            out[path + key] = leaf
    return out


def times_dense_layer(torch, dev, cfg, packed) -> dict:
    """One layer's four GEMMs of a dense config at full width, phase 7's
    way: row 1 at M 4 and row 2 at M 128, per call (``ms``), device time
    on one layer's operands (``device_ms``) and cold (``device_cold_ms``:
    replays rotating over the first layers of the stack, distinct
    weights, at least 4 L2s of bytes), beside the plain version and the
    bound by bytes and operations."""
    from repro_torch.core.ccim import DEFAULT_CONFIG
    from repro_torch.kernels.ccim_matmul import kernel as K

    meta = dict(acc_len=DEFAULT_CONFIG.acc_len, x_bits=(6, 5),
                dcim_lsb=DEFAULT_CONFIG.dcim_lsb,
                adc_half=DEFAULT_CONFIG.adc_half_range)
    gen = torch.Generator(device=dev)
    gen.manual_seed(44)
    leaves = _layer_leaves(packed["layers"])
    rows = {}
    for name, m, fn in (("skinny", 4, K.ccim_matmul_prepacked_skinny_cuda),
                        ("general", 128,
                         K.ccim_matmul_prepacked_general_cuda)):
        keys = ("ms", "device_ms", "device_cold_ms", "plain_ms", "bytes",
                "ops")
        tot, shapes = dict.fromkeys(keys, 0.0), {}
        for sname, leaf in leaves.items():
            n, kp = leaf.kernel_w.shape[1:]
            n_j = leaf.kernel_planes.shape[1]
            layer_bytes = (1 + n_j) * n * kp
            copies = min(cfg.n_layers, cold_copy_count(torch, dev,
                                                       layer_bytes))
            x = torch.randint(-127, 128, (m, kp), generator=gen, device=dev,
                              dtype=torch.int8)
            w, planes = leaf.kernel_w[0], leaf.kernel_planes[0]
            kern = lambda: fn(x, w, planes, **meta)
            cold = [lambda i=i: fn(x, leaf.kernel_w[i],
                                   leaf.kernel_planes[i], **meta)
                    for i in range(copies)]
            nbytes = m * kp + layer_bytes + 4 * m * n
            nops = 2 * m * n * kp * (1 + n_j)
            t = dict(ms=cuda_ms(kern, reps=20),
                     device_ms=graph_ms(torch, kern),
                     device_cold_ms=graph_rotation_ms(torch, cold),
                     plain_ms=cuda_ms(lambda: K.ccim_matmul_prepacked_plain(
                         x, w, planes, **meta), reps=2),
                     bytes=nbytes, ops=nops, k=leaf.k_dim, n=n,
                     cold_layers=copies)
            t.update(_bound(nbytes, nops))
            shapes[sname] = t
            for key in keys:
                tot[key] += t[key]
        tot.update(_bound(tot["bytes"], tot["ops"]))
        rows[name] = {"m": m, "layer_total": tot, "shapes": shapes}
    return rows


def served_frontend(cfg) -> int:
    """Frontend tokens ``serve`` prefills ahead of each prompt: the vlm's
    (paligemma's 256), none for the other families."""
    return cfg.n_frontend_tokens if cfg.family == "vlm" else 0


def dense_lockstep_phase(torch, dev, arch: str, raw_hook=None) -> tuple:
    """Phases 44 (qwen3-14b), 45 (starcoder2-7b), 46 (gemma2-9b), 47
    (qwen2-moe-a2.7b, with the moe's step record), 48 (paligemma-3b, its
    256 frontend embeddings ahead of each prompt) and 49
    (musicgen-medium), ``raw_hook`` run on the raw weights: the configs
    at full width and depth, random weights from seed 0,
    packed and fused, prototype macro, phase 4's workload (batch 4,
    prompt 32, 16 generated).  One pack (``_dense_model``: entry under
    2 GB, init and pack seconds and peaks, each raw projection released
    once packed, as ``serve`` packs the params it makes) served through
    ``serve`` with the decode step captured: launches 4 a layer on row 2
    in prefill and 4 a layer a step on row 1 (credited per replay), pack
    and peak bytes.  Then on the same pack the first 4 tokens eagerly
    through the kernels and through their plain versions: tokens equal
    the captured run's and each other's, last logits equal; a replayed
    decode step's kernel nodes held to its credit, its ms against the
    bound of one read of the pack's layers and of the lm_head (the tied
    embedding for gemma2); one layer's four GEMMs timed (row 1 at M 4,
    row 2 at M 128, same-operand and cold).  Returns the model (for
    phase 46's queues), the launches by path of rows 1 and 2 and the
    eager kernel run's tokens."""
    from repro_torch.launch.graphs import StepGraph
    from repro_torch.launch.serve import decode_body, serve
    from repro_torch.models import lm

    phase = PHASE_OF[arch]
    model = _dense_model(torch, dev, arch, phase, raw_hook)
    cfg, packed, mem = model
    n_fwd = _macro_gemms_per_forward(packed, cfg)
    check(n_fwd == 4 * cfg.n_layers, f"phase {phase}: {n_fwd} macro GEMMs "
          "a forward, expected 4 a layer")
    _reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    toks, st = serve(arch, smoke=False, batch=DENSE_BATCH,
                     prompt_len=DENSE_PROMPT, gen=DENSE_GEN, cim=True,
                     params=packed, return_stats=True, graphs=True)
    torch.cuda.synchronize()
    served = dict(launches=_rows_launches(),
                  peak_bytes=max(mem["pack_peak_bytes"],
                                 torch.cuda.max_memory_allocated()),
                  pack_s=mem["pack_s"], pack_bytes=mem["pack_bytes"],
                  **{k: st[k] for k in ("prefill_s", "decode_s",
                                        "decode_tok_s", "replay_tok_s",
                                        "capture_s", "graph_pool_bytes")})
    captured = dict(toks=toks, logits=st["last_logits"])
    del st
    want = {"general": n_fwd, "skinny": n_fwd * (DENSE_GEN - 1),
            "unpacked": 0}
    check(served["launches"] == want, f"phase {phase} captured: launches "
          f"{served['launches']}, expected {want}")
    check(captured["toks"].shape == (DENSE_BATCH, DENSE_GEN)
          and bool(((captured["toks"] >= 0)
                    & (captured["toks"] < cfg.vocab_size)).all())
          and bool(torch.isfinite(captured["logits"]).all()),
          f"phase {phase}: tokens out of range or logits not finite")
    runs = {}
    for label, kw in (("kernel", {}), ("plain", dict(use_kernel=False))):
        _reset_all_launches()
        toks, st = serve(arch, smoke=False, batch=DENSE_BATCH,
                         prompt_len=DENSE_PROMPT, gen=DENSE_PLAIN_GEN,
                         cim=True, params=packed, return_stats=True,
                         graphs=False, **kw)
        torch.cuda.synchronize()
        runs[label] = dict(toks=toks, logits=st["last_logits"],
                           launches=_rows_launches(),
                           **{k: st[k] for k in ("prefill_s", "decode_s",
                                                 "decode_tok_s")})
    k_, p_ = runs["kernel"], runs["plain"]
    check((k_["toks"] == captured["toks"][:, :DENSE_PLAIN_GEN]).all(),
          f"phase {phase}: the eager kernel run's tokens != the captured "
          "run's")
    check((p_["toks"] == k_["toks"]).all()
          and torch.equal(p_["logits"], k_["logits"]),
          f"phase {phase}: plain tokens or last logits != the kernels'")
    check(k_["launches"] == {"general": n_fwd, "unpacked": 0,
                             "skinny": n_fwd * (DENSE_PLAIN_GEN - 1)},
          f"phase {phase} eager: launches {k_['launches']}")
    check(not any(p_["launches"].values()),
          f"phase {phase}: the plain run launched kernels")
    # one captured decode step: its kernel nodes, a traced replay, its ms
    n_fe = served_frontend(cfg)
    with torch.inference_mode():
        max_seq = DENSE_PROMPT + DENSE_GEN + n_fe
        cache = lm.init_cache(cfg, DENSE_BATCH, max_seq, device=dev)
        prompt = torch.zeros((DENSE_BATCH, DENSE_PROMPT), dtype=torch.int64,
                             device=dev)
        fe = (torch.zeros((DENSE_BATCH, n_fe, cfg.d_model),
                          dtype=torch.bfloat16, device=dev) if n_fe else None)
        _, cache = lm.prefill(packed, cfg, prompt, cache, fe)
        tok = prompt[:, :1].clone()
        out = torch.zeros((DENSE_BATCH, max_seq), dtype=torch.int64,
                          device=dev)
        col = torch.ones((1, 1), dtype=torch.int64, device=dev)
        graph = StepGraph(decode_body(packed, cfg, tok, cache, out, col),
                          dev)
        graph()
        graph()
        check(graph.launches == {"ccim_matmul_prepacked_skinny_cuda":
                                 n_fwd},
              f"phase {phase}: the captured step credits {graph.launches}")
        trace = check_replays(torch, graph, f"phase {phase} decode step")
        replay_ms = cuda_ms(graph, reps=10, warmup=1)
    del cache, graph, out
    head = packed["embed"] if cfg.tie_embeddings else packed["lm_head"]
    bound_bytes = {"macro_layers": mem["layers_pack_bytes"],
                   "lm_head": head.numel() * head.element_size()}
    step_bytes = sum(bound_bytes.values())
    gemms = times_dense_layer(torch, dev, cfg, packed)
    extra = (moe_step_record(torch, dev, cfg, packed, bound_bytes)
             if cfg.family == "moe" else {})
    emit({"phase": f"{cfg.family}_{arch}", "ok": True, "phase_no": phase,
          "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.padded_heads, cfg.n_kv_heads],
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "qk_norm": cfg.qk_norm, "act": cfg.act,
          "softcaps": [cfg.attn_softcap, cfg.logit_softcap],
          "window": cfg.sliding_window, "tied": cfg.tie_embeddings,
          "batch": DENSE_BATCH, "prompt_len": DENSE_PROMPT, "gen": DENSE_GEN,
          "frontend_tokens": n_fe, "prefix_lm": cfg.prefix_lm,
          "prefill_m": DENSE_BATCH * (DENSE_PROMPT + n_fe),
          "macro_gemms_per_forward": n_fwd, "served": served,
          "memory": mem,
          "compared_tokens": DENSE_PLAIN_GEN,
          "tokens_equal": ["kernel == captured", "plain == kernel"],
          "logits_equal": True,
          "runs": {lab: {k: v for k, v in r.items()
                         if k not in ("toks", "logits")}
                   for lab, r in runs.items()},
          "replayed_step_ms": replay_ms, "replay_trace": trace,
          "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_S,
          "decode_bound_bytes": bound_bytes,
          "layer_gemms": gemms, "timing": TIMING, "cold": COLD,
          "tokens_row0": captured["toks"][0].tolist(), **extra})
    return model, {f"{arch}_serve_captured": served["launches"],
                   f"{arch}_serve": k_["launches"]}, k_["toks"]


DENSE_SLOTS, DENSE_PLEN, DENSE_STOPS = 8, 64, (8, 24, 16, 32)


def dense_paged_layout():
    """Phase 46's paged layout: blocks of 16, a table as long as a prompt
    and its longest stop, 64 blocks."""
    from repro_torch.launch.paging import PagedLayout, cdiv
    return PagedLayout(block_size=PA_BS,
                       n_tbl=cdiv(DENSE_PLEN + max(DENSE_STOPS) - 1, PA_BS),
                       n_blocks=64)


def dense_paged_queue(cfg, packed) -> tuple:
    """Phase 46's paged pool on ``packed`` (chunks of 32) as a scheduler
    of its own, and its DENSE_QUEUE requests: (scheduler, requests)."""
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    return (ContinuousBatchingScheduler(
        packed, cfg, slots=DENSE_SLOTS, prompt_len=DENSE_PLEN,
        max_new_cap=max(DENSE_STOPS), paged=dense_paged_layout(),
        prefill_chunk=32),
        mixed_length_requests(DENSE_QUEUE, DENSE_PLEN, cfg.vocab_size,
                              stop_lengths=DENSE_STOPS, seed=0))


def dense_queue_phase(torch, dev, model, arch: str = "gemma2-9b",
                      trace: bool = True) -> dict:
    """Phase 46 (b) (gemma2-9b) and 49 (b) (musicgen-medium): continuous
    batching over phase 9's first 6 requests (prompts of 64, stops 8-32)
    in 8 slots, captured, on the phase's pack: contiguous, pool tokens ==
    the lock-step waves' (gated); paged as phase 10 (blocks of 16, chunks
    of 32): a row-3 launch a layer a pooled step (gemma2-9b: G 2, Dh 256,
    softcap 50, the 4,096 window on the local layers; musicgen-medium: G
    1, Dh 64), refcounts drained, the pool == solo runs of its first
    DENSE_SOLO requests (gated); paged == contiguous reported, not gated
    (as phase 10).  With ``trace`` the paged queue is served again (the
    same tokens, gated) with its 10th pooled step traced: row 3's device
    time in a replayed step (``pooled_step_tracer``).  Returns the
    launches by path of rows 1-3."""
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.launch.serve import serve_continuous

    cfg, packed, _ = model
    phase = PHASE_OF[arch]
    slots, plen, stops = DENSE_SLOTS, DENSE_PLEN, DENSE_STOPS
    layout = dense_paged_layout()
    common = dict(smoke=False, slots=slots, prompt_len=plen,
                  n_requests=DENSE_QUEUE, stop_lengths=stops, cim=True,
                  params=packed, device=dev)
    recs, toks, launches = {}, {}, {}
    for label, kw in (("contiguous", dict(compare_lockstep=True)),
                      ("paged", dict(compare_lockstep=False, paged=layout,
                                     prefill_chunk=32))):
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks[label], st = serve_continuous(arch, **kw, **common)
        torch.cuda.synchronize()
        launches[label] = dict(_rows_launches(),
                               paged_attn=_all_launches()["paged_attn"])
        recs[label] = dict(_serve_record(st), launches=launches[label],
                           peak_bytes=torch.cuda.max_memory_allocated())
        n_steps = st["continuous"]["n_steps"]
        if label == "contiguous":
            check(st.get("tokens_match_lockstep") is True,
                  f"phase {phase}: contiguous pool tokens != lock-step "
                  "tokens")
            check(launches[label]["paged_attn"] == 0,
                  f"phase {phase}: the contiguous pool launched row 3")
        else:
            check(launches[label]["paged_attn"] == cfg.n_layers * n_steps,
                  f"phase {phase}: {launches[label]['paged_attn']} row-3 "
                  f"launches, expected {cfg.n_layers} x {n_steps} pooled "
                  "steps")
            check(st["paged"]["refcounts_drained"],
                  f"phase {phase}: refcounts did not drain")
    reqs = mixed_length_requests(DENSE_QUEUE, plen, cfg.vocab_size,
                                 stop_lengths=stops, seed=0)
    rids = [r.rid for r in reqs[:DENSE_SOLO]]
    solo = {}
    for r in reqs[:DENSE_SOLO]:
        solo.update(ContinuousBatchingScheduler(
            packed, cfg, slots=1, prompt_len=plen, max_new_cap=max(stops),
            paged=layout, prefill_chunk=32).run([r]).tokens_by_rid())
    n_solo = _same_tokens(toks["paged"], solo, rids)
    check(n_solo == DENSE_SOLO, f"phase {phase}: the paged pool's tokens "
          f"equal solo runs on {n_solo} of requests 0-{DENSE_SOLO - 1}")
    step_trace = None
    if trace:
        # row 3's device time in a replayed pooled step: the paged queue
        # served again in a scheduler of its own (the same tokens,
        # gated), its 10th pooled step (every slot live) traced; a run
        # apart, so the paged run's wall holds no profiler
        sched, reqs_p = dense_paged_queue(cfg, packed)
        on_branch, traced = pooled_step_tracer(torch)
        n_again = _same_tokens(sched.run(reqs_p, on_branch=on_branch)
                               .tokens_by_rid(), toks["paged"])
        check(n_again == DENSE_QUEUE, f"phase {phase}: the traced paged "
              f"run's tokens equal the paged pool's on {n_again} of "
              f"{DENSE_QUEUE}")
        step_trace = traced()
        check(step_trace["row3_kernels"] >= cfg.n_layers,
              f"phase {phase}: the traced pooled step ran "
              f"{step_trace['row3_kernels']} row-3 kernels, fewer than its "
              f"{cfg.n_layers} reads")
    emit({"phase": f"{cfg.family}_{arch}_queues", "ok": True,
          "phase_no": phase,
          "requests": DENSE_QUEUE, "prompt_len": plen,
          "stop_lengths": list(stops), "slots": slots,
          "paged_layout": [layout.block_size, layout.n_tbl,
                           layout.n_blocks], "prefill_chunk": 32,
          "row3_at": {"G": cfg.q_per_kv, "dh": cfg.head_dim,
                      "softcap": cfg.attn_softcap,
                      "window": cfg.sliding_window},
          "pool_equals_lockstep": True, "paged_equal_solo": n_solo,
          "paged_pooled_step_trace": step_trace,
          "paged_equal_contiguous": _same_tokens(toks["paged"],
                                                 toks["contiguous"]),
          "not_gated_because": "the kernel's float32 P.V can move a bf16 "
                               "activation by one ulp, and in CIM mode an "
                               "ADC code with it",
          "runs": recs})
    return {f"{arch}_scheduler_{k}": v for k, v in launches.items()}


def dense_phases(torch, dev) -> dict:
    """Phases 44-46, each on a card with nothing of an earlier phase live
    and its model freed before the next."""
    paths = {}
    for arch in DENSE_PHASES:
        model, p, _ = dense_lockstep_phase(torch, dev, arch)
        paths.update(p)
        if arch == "gemma2-9b":
            paths.update(dense_queue_phase(torch, dev, model))
        del model
        gc_collect(torch)
    return paths


# phase 47: the moe family.  qwen2-moe-a2.7b at full width and depth
# (the dense phases' lock-step workload and queues, 2 solo runs), a
# speculative lock-step run at verify M 18 (row 1), one grouped prefill
# past T * K 4,096; arctic-480b at smoke size
MOE_PHASE, MOE_ARCH, MOE_SMOKE_ARCH = 47, "qwen2-moe-a2.7b", "arctic-480b"
MOE_SOLO = 1                 # 2 until phases 48-49 needed the time
MOE_SPEC = (2, 32, 12, 8)        # batch, prompt, generated, draft k: M 18
MOE_GROUPED_S = 1088             # B 1: T * K = 4,352 routed rows
PHASE_OF = {**DENSE_PHASES, MOE_ARCH: MOE_PHASE, VLM_ARCH: VLM_PHASE,
            AUDIO_ARCH: AUDIO_PHASE}


def unpacked_hook(torch, arch: str, out: dict):
    """A ``raw_hook`` for ``dense_lockstep_phase``: the raw weights served
    unpacked (row 6) before they are packed, 4 tokens, eager; ``out``
    gets the tokens, launches, peak bytes and times."""
    from repro_torch.launch.serve import serve

    def run(cfg, params):
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t, st = serve(arch, smoke=False, batch=DENSE_BATCH,
                      prompt_len=DENSE_PROMPT, gen=DENSE_PLAIN_GEN, cim=True,
                      pack=False, params=params, return_stats=True,
                      graphs=False)
        torch.cuda.synchronize()
        out.update(toks=t, launches=_rows_launches(),
                   peak=torch.cuda.max_memory_allocated(),
                   **{k: st[k] for k in ("prefill_s", "decode_s",
                                         "decode_tok_s")})
    return run


def check_unpacked(phase: int, arch: str, unpacked: dict, n_fwd: int,
                   kernel_toks) -> dict:
    """The unpacked run (``unpacked_hook``): 4 macro GEMMs a forward on
    row 6, tokens == the packed kernel run's (the eager run's first
    DENSE_PLAIN_GEN tokens).  Returns its launches by path."""
    check(unpacked["launches"] == {"unpacked": n_fwd * DENSE_PLAIN_GEN,
                                   "general": 0, "skinny": 0},
          f"phase {phase}: the unpacked run launched "
          f"{unpacked['launches']}")
    check((unpacked["toks"] == kernel_toks).all(),
          f"phase {phase}: unpacked tokens != packed tokens")
    return {f"{arch}_serve_unpacked": unpacked["launches"]}


def moe_step_record(torch, dev, cfg, packed, bound_bytes) -> dict:
    """A moe decode step beside its two bounds, at phase 4's batch: the
    reference's form reads every expert (``bound_bytes``: the layers'
    pack with the raw expert stacks, and the lm_head), reading only the
    experts that B * K uniform draws of E occupy would read
    E (1 - (1 - 1/E)^(B K)) of them; and one layer's routed experts
    (``layers._moe_ffn`` over the (E, T * K, D) buffer) and whole moe
    (``moe_apply``, the shared expert on row 1 included) at that shape,
    device time from graph replays."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    E, K, B = cfg.n_experts, cfg.top_k, DENSE_BATCH
    moe = packed["layers"]["moe"]
    expert_bytes = sum(moe[k].numel() * moe[k].element_size()
                       for k in ("w1", "w2", "w3"))
    occupied = E * (1 - (1 - 1 / E) ** (B * K))
    occ_bytes = (sum(bound_bytes.values())
                 - expert_bytes * (1 - occupied / E))
    p = lm._layer(packed["layers"], 0)["moe"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    buf = torch.randn((E, B * K, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        ffn_ms = graph_ms(torch, lambda: L._moe_ffn(p, buf, cfg))
        moe_ms = graph_ms(torch, lambda: L.moe_apply(p, x, cfg))
    rows = -(-B * K // 64) * 64            # the expert GEMMs' 64-row tiles
    ops = 2 * E * rows * cfg.d_model * cfg.moe_d_ff * 3
    return {"moe": {
        "experts": E, "top_k": K, "moe_d_ff": cfg.moe_d_ff,
        "shared_expert_d_ff": cfg.shared_expert_d_ff,
        "expert_bytes": expert_bytes,
        "occupied_experts_expected": occupied,
        "decode_bound_all_experts_ms": 1e3 * sum(bound_bytes.values())
        / HBM_BYTES_S,
        "decode_bound_occupied_experts_ms": 1e3 * occ_bytes / HBM_BYTES_S,
        "expert_ffn_layer_device_ms": ffn_ms,
        "expert_ffn_step_device_ms": ffn_ms * cfg.n_layers,
        "expert_ffn_layer_bound_ms": 1e3 * max(
            expert_bytes / cfg.n_layers / HBM_BYTES_S, ops / BF16_OPS_S),
        "moe_layer_device_ms": moe_ms,
        "timing": "device time per call from CUDA-graph replays of 20 "
                  "calls, one layer's operands"}}


def _moe_drop_tap(L):
    """Wraps ``layers._moe_grouped`` so that each call records, on the
    device, its routed rows and those past the capacity (what the group
    drops); returns (restore, records)."""
    orig, recs = L._moe_grouped, []

    def tapped(p, x, eidx, gates, cfg):
        B, S, K = eidx.shape
        counts = L._one_hot(eidx.reshape(B, S * K), cfg.n_experts).sum(1)
        recs.append(((counts - L.moe_capacity(S, cfg)).clamp_min(0).sum(),
                     B * S * K))
        return orig(p, x, eidx, gates, cfg)

    L._moe_grouped = tapped
    return (lambda: setattr(L, "_moe_grouped", orig)), recs


def moe_phase(torch, dev) -> dict:
    """Phase 47: qwen2-moe-a2.7b at full width and depth (24 layers,
    d_model 2048, 60 experts top 4 and a 5,632-wide shared expert),
    random weights from seed 0, packed and fused on the prototype macro
    (the attention and the shared expert; the routed experts stay bf16
    matrices, as in the reference).  (a) The dense phases' lock-step
    phase (``dense_lockstep_phase``): 96 macro GEMMs a forward, captured
    == eager == plain tokens, a traced replayed decode step with its
    kernel nodes, the step's two bounds and the expert GEMMs' time.
    (b) Continuous batching over phase 9's first 6 requests in 8 slots,
    captured: contiguous == the lock-step waves (gated), paged through
    row 3 (G 1, Dh 128) == solo runs of MOE_SOLO requests (gated),
    paged == contiguous reported.  (c) A speculative lock-step run at
    verify M 18 (row 1) == lock-step tokens (gated).  (d) One prefill of 1 x 1,088
    tokens through the grouped path: its dropped share.  (e) Every peak
    of the phase within the card's memory.  (f) arctic-480b at smoke size
    (its dense residual beside the moe): kernel == plain tokens and
    logits.  Returns the launches by path of rows 1-3."""
    from repro_torch.launch.scheduler import (ContinuousBatchingScheduler,
                                              mixed_length_requests)
    from repro_torch.launch.serve import serve, serve_continuous
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    phase, arch = MOE_PHASE, MOE_ARCH
    unpacked = {}
    model, paths, kernel_toks = dense_lockstep_phase(
        torch, dev, arch, unpacked_hook(torch, arch, unpacked))
    cfg, packed, mem = model
    n_fwd = 4 * cfg.n_layers
    card = torch.cuda.get_device_properties(0).total_memory
    peaks = {"init": mem["init_peak_bytes"], "pack": mem["pack_peak_bytes"],
             "unpacked_serve": unpacked["peak"]}
    paths.update(check_unpacked(phase, arch, unpacked, n_fwd, kernel_toks))
    # (b) the queues
    slots, plen, stops = DENSE_SLOTS, DENSE_PLEN, DENSE_STOPS
    layout = dense_paged_layout()
    common = dict(smoke=False, slots=slots, prompt_len=plen,
                  n_requests=DENSE_QUEUE, stop_lengths=stops, cim=True,
                  params=packed, device=dev)
    recs, toks = {}, {}
    for label, kw in (("contiguous", dict(compare_lockstep=True)),
                      ("paged", dict(compare_lockstep=False, paged=layout,
                                     prefill_chunk=32))):
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        toks[label], st = serve_continuous(arch, **kw, **common)
        torch.cuda.synchronize()
        n = dict(_rows_launches(), paged_attn=_all_launches()["paged_attn"])
        paths[f"{arch}_scheduler_{label}"] = n
        peaks[f"queue_{label}"] = torch.cuda.max_memory_allocated()
        recs[label] = dict(_serve_record(st), launches=n)
        n_steps = st["continuous"]["n_steps"]
        if label == "contiguous":
            check(st.get("tokens_match_lockstep") is True,
                  f"phase {phase}: contiguous pool tokens != lock-step "
                  "tokens")
            check(n["paged_attn"] == 0,
                  f"phase {phase}: the contiguous pool launched row 3")
        else:
            check(n["paged_attn"] == cfg.n_layers * n_steps,
                  f"phase {phase}: {n['paged_attn']} row-3 launches, "
                  f"expected {cfg.n_layers} x {n_steps} pooled steps")
            check(st["paged"]["refcounts_drained"],
                  f"phase {phase}: refcounts did not drain")
    reqs = mixed_length_requests(DENSE_QUEUE, plen, cfg.vocab_size,
                                 stop_lengths=stops, seed=0)
    solo = {}
    for r in reqs[:MOE_SOLO]:
        solo.update(ContinuousBatchingScheduler(
            packed, cfg, slots=1, prompt_len=plen, max_new_cap=max(stops),
            paged=layout, prefill_chunk=32).run([r]).tokens_by_rid())
    n_solo = _same_tokens(toks["paged"], solo, list(solo))
    check(n_solo == MOE_SOLO, f"phase {phase}: the paged pool's tokens "
          f"equal solo runs on {n_solo} of {MOE_SOLO}")
    # (c) speculative lock-step at verify M 18 (row 1)
    torch.cuda.reset_peak_memory_stats()
    spec = speculative_record(torch, dev, arch, packed, cfg, phase, paths)
    peaks["speculative"] = torch.cuda.max_memory_allocated()
    # (d) one prefill past T * K 4,096: the grouped path and its drops
    restore, drops = _moe_drop_tap(L)
    try:
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(47)
        prompt = torch.randint(0, cfg.vocab_size, (1, MOE_GROUPED_S),
                               generator=gen, device=dev)
        with torch.inference_mode():
            cache = lm.init_cache(cfg, 1, MOE_GROUPED_S, device=dev)
            t0 = time.perf_counter()
            logits, cache = lm.prefill(packed, cfg, prompt, cache)
            torch.cuda.synchronize()
            grouped_s = time.perf_counter() - t0
        del cache
    finally:
        restore()
    peaks["grouped_prefill"] = torch.cuda.max_memory_allocated()
    n_grouped = _rows_launches()
    paths[f"{arch}_prefill_grouped"] = n_grouped
    dropped = sum(int(d) for d, _ in drops)
    routed = sum(n for _, n in drops)
    check(len(drops) == cfg.n_layers and bool(torch.isfinite(logits).all()),
          f"phase {phase}: the 1 x {MOE_GROUPED_S} prefill ran the grouped "
          f"path in {len(drops)} of {cfg.n_layers} layers, or its logits "
          "are not finite")
    check(n_grouped["general"] == n_fwd, f"phase {phase}: the grouped "
          f"prefill launched {n_grouped}")
    # (e) memory
    check(max(peaks.values()) <= card, f"phase {phase}: a peak of "
          f"{max(peaks.values())} bytes exceeds the card's {card}")
    # (f) arctic-480b at smoke size on the card
    t0 = time.perf_counter()
    runs = {}
    for label, kw in (("kernel", {}), ("plain", dict(use_kernel=False))):
        _reset_all_launches()
        t, st = serve(MOE_SMOKE_ARCH, smoke=True, cim=True, device=dev,
                      return_stats=True, graphs=False, **kw)
        runs[label] = (t, st["last_logits"], _rows_launches())
    (kt, kl, kn), (pt, pl, pn) = runs["kernel"], runs["plain"]
    check((kt == pt).all() and torch.equal(kl, pl),
          f"phase {phase}: {MOE_SMOKE_ARCH} smoke kernel and plain tokens "
          "or logits differ")
    check(kn["general"] > 0 and kn["skinny"] > 0 and not any(pn.values()),
          f"phase {phase}: {MOE_SMOKE_ARCH} smoke launches {kn} (kernel), "
          f"{pn} (plain)")
    paths[f"{MOE_SMOKE_ARCH}_smoke_serve"] = kn
    emit({"phase": f"moe_{arch}_paths", "ok": True, "phase_no": phase,
          "requests": DENSE_QUEUE, "prompt_len": plen,
          "stop_lengths": list(stops), "slots": slots,
          "paged_layout": [layout.block_size, layout.n_tbl,
                           layout.n_blocks], "prefill_chunk": 32,
          "row3_at": {"G": cfg.q_per_kv, "dh": cfg.head_dim},
          "pool_equals_lockstep": True, "paged_equal_solo": n_solo,
          "paged_equal_contiguous": _same_tokens(toks["paged"],
                                                 toks["contiguous"]),
          "not_gated_because": "the kernel's float32 P.V can move a bf16 "
                               "activation by one ulp, and in CIM mode an "
                               "ADC code with it",
          "unpacked_serve": {k: v for k, v in unpacked.items()
                             if k != "toks"},
          "unpacked_equals_packed_tokens": DENSE_PLAIN_GEN,
          "queues": recs,
          "speculative": spec,
          "grouped_prefill": {
              "batch": 1, "tokens": MOE_GROUPED_S,
              "routed_rows": routed, "dropped_rows": dropped,
              "dropped_share": dropped / routed,
              "capacity": L.moe_capacity(MOE_GROUPED_S, cfg),
              "seconds": grouped_s, "launches": n_grouped},
          "peaks_bytes": peaks, "card_bytes": card,
          "arctic_smoke": {
              "arch": MOE_SMOKE_ARCH, "tokens_equal": True,
              "logits_equal": True, "launches": kn,
              "seconds": time.perf_counter() - t0,
              "tokens_row0": kt[0].tolist()}})
    return paths


def text_lockstep(torch, dev, packed, cfg, batch: int, plen: int,
                  gen: int):
    """Greedy lock-step tokens (batch, gen) of ``serve``'s text prompts
    (seed 0) with no frontend: ``lm.prefill`` then ``lm.decode_step``,
    eager, a cache of plen + gen rows -- the chain a text-only
    ``serve_speculative`` of a vlm is held to."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import lm

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=plen,
                    global_batch=batch, seed=0, d_model=cfg.d_model)
    toks = torch.from_numpy(batch_at(dc, 0)["tokens"]).to(dev, torch.int64)
    with torch.inference_mode():
        cache = lm.init_cache(cfg, batch, plen + gen, device=dev)
        logits, cache = lm.prefill(packed, cfg, toks, cache)
        out = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
        for _ in range(gen - 1):
            logits, cache = lm.decode_step(packed, cfg, out[-1], cache)
            out.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def speculative_record(torch, dev, arch: str, packed, cfg, phase: int,
                       paths: dict) -> dict:
    """A speculative lock-step run (batch 2, prompt 32, 12 tokens, k 8:
    verify M 18 on row 1) == lock-step tokens (gated): ``serve``'s for a
    text model (``compare_baseline``), the text-only greedy chain for the
    vlm (``text_lockstep``: the speculative driver takes no frontend, as
    the reference's).  Adds its launches to ``paths``."""
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.serve import serve_speculative

    batch, plen, gen, k = MOE_SPEC
    vlm = cfg.family == "vlm"
    _reset_all_launches()
    spec, sst = serve_speculative(arch, smoke=False, batch=batch,
                                  prompt_len=plen, gen=gen, draft_k=k,
                                  params=packed, return_stats=True,
                                  compare_baseline=not vlm)
    torch.cuda.synchronize()
    launches = _rows_launches()
    if vlm:
        same = bool((spec == text_lockstep(torch, dev, packed, cfg, batch,
                                           plen, gen)).all())
    else:
        same = sst.get("tokens_match_baseline") is True
    check(same, f"phase {phase}: speculative tokens != lock-step tokens")
    check(launches["skinny"] > 0, f"phase {phase}: the speculative run "
          "launched no row-1 kernel")
    paths[f"{arch}_serve_speculative_m{batch * (k + 1)}"] = launches
    return {"batch": batch, "prompt_len": plen, "gen": gen, "draft_k": k,
            "verify_m": batch * (k + 1),
            "verify_row": 1 if batch * (k + 1) <= K.SKINNY_M else 2,
            "equals_lockstep": "text-only greedy chain" if vlm else "serve",
            "launches": launches,
            **{key: sst[key] for key in (
                "n_rounds", "n_drafted", "n_accepted", "acceptance_rate",
                "tokens_per_round", "decode_tok_s", "draft_plan")
               if key in sst}}


def vlm_phase(torch, dev) -> dict:
    """Phase 48: paligemma-3b at full width and depth (18 layers, d_model
    2,048, 8 query heads padded to 16 over one kv head of 256, GELU, d_ff
    16,384, tied embeddings over 257,216 words), random weights from seed
    0, packed and fused on the prototype macro.  (a) The raw weights
    served unpacked (row 6, 4 tokens) == the packed tokens.  (b) The
    dense phases' lock-step phase with the data pipeline's 256 frontend
    embeddings ahead of each prompt under the prefix-LM mask: prefill at
    M 1,152 on row 2 (72 launches), 72 row-1 launches a decode step,
    captured == eager == plain, a traced replayed step against one read
    of the packed layers and the tied embedding.  (c) The prefix mask is
    live: one prefill without it (``prefix_lm=False``) gives other last
    logits.  (d) A speculative lock-step run at verify M 18 (row 1) ==
    the text-only greedy chain (the speculative driver takes no
    frontend, as the reference's; the scheduler refuses the vlm, as the
    reference's).  Returns the launches by path of rows 1, 2 and 6."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import lm

    phase, arch = VLM_PHASE, VLM_ARCH
    unpacked = {}
    model, paths, kernel_toks = dense_lockstep_phase(
        torch, dev, arch, unpacked_hook(torch, arch, unpacked))
    cfg, packed, mem = model
    n_fwd = 4 * cfg.n_layers
    paths.update(check_unpacked(phase, arch, unpacked, n_fwd, kernel_toks))
    # (c) the prefix mask: the first request's prefill with and without
    n_fe = served_frontend(cfg)
    b = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=DENSE_PROMPT,
                            global_batch=DENSE_BATCH, seed=0,
                            n_frontend_tokens=n_fe, d_model=cfg.d_model), 0)
    toks = torch.from_numpy(b["tokens"][:1]).to(dev, torch.int64)
    fe = torch.from_numpy(b["frontend_embs"][:1]).to(dev, torch.bfloat16)
    last = {}
    with torch.inference_mode():
        for flag in (True, False):
            c = dataclasses.replace(cfg, prefix_lm=flag)
            cache = lm.init_cache(c, 1, DENSE_PROMPT + n_fe, device=dev)
            logits, _ = lm.prefill(packed, c, toks, cache, fe)
            last[flag] = logits[0, -1].float()
        del cache
    diff = float((last[True] - last[False]).abs().max())
    check(bool(torch.isfinite(last[True]).all()) and diff > 0,
          f"phase {phase}: the prefill without the prefix mask gave the "
          "same last logits")
    # (d) speculative, text-only
    spec = speculative_record(torch, dev, arch, packed, cfg, phase, paths)
    emit({"phase": f"vlm_{arch}_paths", "ok": True, "phase_no": phase,
          "unpacked_serve": {k: v for k, v in unpacked.items()
                             if k != "toks"},
          "unpacked_equals_packed_tokens": DENSE_PLAIN_GEN,
          "prefix_mask": {"frontend_tokens": n_fe,
                          "last_logits_max_diff_without": diff,
                          "argmax_with": int(last[True].argmax()),
                          "argmax_without": int(last[False].argmax())},
          "speculative": spec, "memory": mem,
          "scheduler": "refused for the vlm, as the reference's"})
    return paths


def audio_phase(torch, dev) -> dict:
    """Phase 49: musicgen-medium at full width and depth (48 layers,
    d_model 1,536, 24 MHA heads padded to 32 of 64, GELU, d_ff 6,144,
    vocab 2,048 over EnCodec tokens), random weights from seed 0, packed
    and fused on the prototype macro.  (a) The raw weights served
    unpacked (row 6, 4 tokens) == the packed tokens.  (b) The dense
    phases' lock-step phase: 192 row-2 launches in prefill and 192 row-1
    launches a decode step, captured == eager == plain.  (c) Phase 46's
    queues (``dense_queue_phase``, no trace): contiguous == the lock-step
    waves, paged through row 3 at G 1, Dh 64 (48 reads a pooled step) ==
    solo runs of its first DENSE_SOLO requests, paged == contiguous
    reported.  (d) A
    speculative lock-step run at verify M 18 (row 1) == ``serve``'s
    tokens.  Returns the launches by path of rows 1-3 and 6."""
    phase, arch = AUDIO_PHASE, AUDIO_ARCH
    unpacked = {}
    model, paths, kernel_toks = dense_lockstep_phase(
        torch, dev, arch, unpacked_hook(torch, arch, unpacked))
    cfg, packed, mem = model
    paths.update(check_unpacked(phase, arch, unpacked, 4 * cfg.n_layers,
                                kernel_toks))
    paths.update(dense_queue_phase(torch, dev, model, arch, trace=False))
    spec = speculative_record(torch, dev, arch, packed, cfg, phase, paths)
    emit({"phase": f"audio_{arch}_paths", "ok": True, "phase_no": phase,
          "unpacked_serve": {k: v for k, v in unpacked.items()
                             if k != "toks"},
          "unpacked_equals_packed_tokens": DENSE_PLAIN_GEN,
          "speculative": spec})
    return paths


# -- phases 50-51: training ---------------------------------------------------

TRAIN_PHASE, TRAIN_ARCH, TRAIN_STEPS = 50, "minicpm-2b", 6
TRAIN_BATCH, TRAIN_SEQ = 8, 64          # train()'s defaults
RESUME_PHASE, RESUME_ARCH = 51, "mamba2-130m"
RESUME_BATCH, RESUME_SEQ = 2, 32        # the reference's resume test


def _row6_train_bound(params, cfg, m: int) -> dict:
    """Row 6's bound over one train step: each layer's four raw
    projections (QKV, wo, w1+w3 and w2, fused along N; K a multiple of
    16 at these widths) at M rows, run twice (forward and recompute),
    each input read once and each output written once, the prototype's
    6 m n k operations (phase 17's count)."""
    a, f = params["layers"]["attn"], params["layers"]["mlp"]
    layer = [(a["wq"].shape[1], sum(a[k].shape[2] for k in ("wq", "wk",
                                                               "wv"))),
             (a["wo"].shape[1], a["wo"].shape[2]),
             (f["w1"].shape[1], f["w1"].shape[2] + f["w3"].shape[2]),
             (f["w2"].shape[1], f["w2"].shape[2])]
    runs = 2 * cfg.n_layers
    return _bound(runs * sum(m * k + k * n + 4 * m * n for k, n in layer),
                  runs * sum(6 * m * n * k for k, n in layer))


def _split_step_ms(torch, params, opt, cfg, ocfg, batch) -> dict:
    """One train step taken as ``make_train_step``'s step takes it, the
    device synchronized after the forward, the backward and the update:
    their wall times."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw_update, tree_leaves, tree_unflatten
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    loss = lm.lm_loss(params, cfg, batch["tokens"])
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    adamw_update(params, tree_unflatten(params, grads), opt, ocfg)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return {"forward_ms": 1e3 * (t[1] - t[0]),
            "backward_ms": 1e3 * (t[2] - t[1]),
            "adamw_ms": 1e3 * (t[3] - t[2]), "step_ms": 1e3 * (t[3] - t[0])}


def train_phase(torch, dev) -> int:
    """Phase 50: QAT training of minicpm-2b at full width and depth (40
    layers, d_model 2,304, 36 heads padded to 48, d_ff 5,760, vocab
    122,753; raw fused weights from seed 0 on the prototype macro)
    through ``launch.specs.make_train_step``, the step ``train`` takes,
    set up as ``train`` sets it up (``lm.init`` from seed 0,
    ``init_opt_state``, the schedule cut to the run's steps): 6 steps of
    batch 8 x seq 64 from ``batch_at``, with per-layer and per-CE-chunk
    recomputation, so row 6 runs every projection at M 512 twice a step
    (forward and recompute: 320 launches), gated per step.  The same 6
    steps from the same weights through row 6's plain version
    (``cim_use_kernel=False``), under
    ``torch.use_deterministic_algorithms(True)``: every loss and every
    updated leaf ``==`` (the kernel run's final leaves kept on the card
    beside the plain run).  Reported: each step's wall time, peak device
    bytes and losses; then one further step split into forward, backward
    and AdamW (device synchronized at each), and one more traced (device
    busy, idle share, top kernels, row 6's device time beside its
    bound).  Returns row 6's launches of the 6 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.specs import make_train_step, param_count
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state, tree_leaves, tree_unflatten
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), cim_mode=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                batch_at(dcfg, s).items()} for s in range(TRAIN_STEPS + 2)]
    per_step = 2 * 4 * cfg.n_layers          # (QKV, wo, w1+w3, w2) x 2
    runs, kept = {}, None
    clock = {"entry": time.time() - T_IMPORT}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        at_entry = torch.cuda.memory_allocated()
        rcfg = dataclasses.replace(cfg, cim_use_kernel=use_kernel)
        step_fn, ocfg = make_train_step(rcfg)
        ocfg = dataclasses.replace(ocfg, total_steps=TRAIN_STEPS,
                                   warmup=max(1, TRAIN_STEPS // 10))
        params = lm.init(0, rcfg, device=dev)
        opt = init_opt_state(params, ocfg)
        K.reset_launch_counts()
        losses, step_ms, launches = [], [], []
        t0 = time.time()
        for s in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batches[s])
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
            launches.append(K.ccim_matmul_unpacked_cuda.launches)
        wall = time.time() - t0
        clock[f"{label}_end"] = time.time() - T_IMPORT
        want = ([per_step * (i + 1) for i in range(TRAIN_STEPS)]
                if use_kernel is None else [0] * TRAIN_STEPS)
        check(launches == want, f"phase {TRAIN_PHASE}: {label} row-6 "
              f"launches after each step {launches}, expected {want}")
        check(all(v == v and abs(v) < 1e4 for v in losses),
              f"phase {TRAIN_PHASE}: non-finite losses {losses}")
        runs[label] = dict(
            losses=losses, wall_s=wall, at_entry=at_entry,
            peak=torch.cuda.max_memory_allocated(), step_ms=step_ms,
            launches=launches[-1])
        torch.cuda.reset_peak_memory_stats()
        if label == "kernel":
            n_params = param_count(params)
            bound = _row6_train_bound(params, cfg, TRAIN_BATCH * TRAIN_SEQ)
            kept = [p.detach() for p in tree_leaves(params)]
            # two more steps (batches 6 and 7) on a copy: one split into
            # its parts, one traced
            params = tree_unflatten(params,
                                    [p.detach().clone() for p in kept])
            split = _split_step_ms(torch, params, opt, rcfg, ocfg,
                                   batches[TRAIN_STEPS])
            clock["split"] = time.time() - T_IMPORT
            torch.cuda.synchronize()
            # device activity only: the step runs ~120,000 host ops, whose
            # events would take longer to read back than the step itself
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                step_fn(params, opt, batches[TRAIN_STEPS + 1])
                torch.cuda.synchronize()
                traced_ms = 1e3 * (time.perf_counter() - t1)
            clock["traced"] = time.time() - T_IMPORT
            # row 6 is the raw-fill instance of ``general_kernel``, the
            # only instance a training step runs
            trace = dict(step_wall_ms=traced_ms,
                         peak_beside_kept=torch.cuda.max_memory_allocated(),
                         **device_breakdown(prof, 1, traced_ms))
            trace["row6_device_ms"] = trace[
                "kernels_by_symbol_ms_per_step"]["general_kernel"]
            trace.update({f"row6_{k}": v for k, v in bound.items()})
            trace["row6_over_bound"] = (trace["row6_device_ms"]
                                        / bound["bound_ms"])
            del prof
            clock["trace_read"] = time.time() - T_IMPORT
        else:
            parted = [i for i, (a, b) in enumerate(
                zip(kept, tree_leaves(params))) if not torch.equal(a, b)]
            check(not parted, f"phase {TRAIN_PHASE}: {len(parted)} updated "
                  "leaves differ between the kernel and the plain run")
            runs[label]["leaves_equal"] = len(kept)
        del params, opt
    got = runs["plain"]["losses"]
    check(got[0] == runs["kernel"]["losses"][0],
          f"phase {TRAIN_PHASE}: step 0 loss kernel "
          f"{runs['kernel']['losses'][0]} != plain {got[0]}")
    check(got == runs["kernel"]["losses"],
          f"phase {TRAIN_PHASE}: losses kernel {runs['kernel']['losses']} "
          f"!= plain {got}")
    del kept, batches
    gc_collect(torch)
    emit({"phase": f"train_{TRAIN_ARCH}", "phase_no": TRAIN_PHASE,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.padded_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "params": n_params,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "row6_launches_per_step": per_step, "row6_m": TRAIN_BATCH
          * TRAIN_SEQ, "deterministic": True,
          "kernel": runs["kernel"], "plain": runs["plain"],
          "split_step": split, "traced_step": trace, "losses_equal": True,
          "clock_s": dict(clock, exit=time.time() - T_IMPORT)})
    return runs["kernel"]["launches"]


def resume_phase(torch, dev) -> int:
    """Phase 51: fault tolerance on the card, the reference's
    ``test_resume_is_bitwise_exact`` through the port's ``train`` with
    ``--cim`` at mamba2-130m's full width and depth (24 layers, d_model
    768; batch 2 x seq 32 as that test): 6 steps straight against 3, a
    failure injected at step 4 and a resume from the step-3 checkpoint;
    the resumed losses equal the straight run's (rtol 1e-5 / atol 1e-6,
    the reference's; bit for bit reported), then the ``python -m
    repro_torch.checkpoint --verify`` CLI (its ``main``, in this
    process) returns 0 on the checkpoint and 1 on a truncated copy.  Row 6 runs 2 x 48 GEMMs a step (13 steps).
    Returns its launches."""
    import shutil
    import tempfile
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.train import train
    K.reset_launch_counts()
    kw = dict(smoke=False, steps=6, batch=RESUME_BATCH, seq=RESUME_SEQ,
              cim=True, log_every=100, device=dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        d = os.path.join(root, "ck")
        t0 = time.time()
        _, _, full = train(RESUME_ARCH, ckpt_dir="", **kw)
        t_full = time.time() - t0
        try:
            train(RESUME_ARCH, ckpt_dir=d, ckpt_every=3, fail_at=4, **kw)
            fail(f"phase {RESUME_PHASE}: --fail-at 4 did not raise")
        except RuntimeError as e:
            check("injected failure" in str(e), f"phase {RESUME_PHASE}: {e}")
        t1 = time.time()
        _, _, resumed = train(RESUME_ARCH, ckpt_dir=d, resume=True,
                              ckpt_every=3, **kw)
        t_resume = time.time() - t1
        close = all(abs(a - b) <= 1e-6 + 1e-5 * abs(a)
                    for a, b in zip(full[3:], resumed))
        check(len(resumed) == 3 and close,
              f"phase {RESUME_PHASE}: resumed {resumed} != straight "
              f"{full[3:]}")
        from repro_torch.checkpoint.__main__ import main as verify_cli
        t2 = time.time()
        ok = verify_cli([d, "--verify"])
        t_verify = time.time() - t2
        # a truncated copy of the latest step: meta.json and half the npz
        step_dir = sorted(x for x in os.listdir(d)
                          if x.startswith("step_"))[-1]
        bad = os.path.join(root, "bad")
        os.makedirs(os.path.join(bad, step_dir))
        shutil.copy(os.path.join(d, step_dir, "meta.json"),
                    os.path.join(bad, step_dir, "meta.json"))
        npz = os.path.join(d, step_dir, "state.npz")
        with open(npz, "rb") as f:
            half = f.read(os.path.getsize(npz) // 2)
        with open(os.path.join(bad, step_dir, "state.npz"), "wb") as f:
            f.write(half)
        corrupt = verify_cli([bad, "--verify"])
        check(ok == 0 and corrupt == 1,
              f"phase {RESUME_PHASE}: --verify returned {ok} on the "
              f"checkpoint and {corrupt} on a truncated copy")
        ckpt_bytes = os.path.getsize(os.path.join(d, step_dir, "state.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = K.ccim_matmul_unpacked_cuda.launches
    check(n == 2 * 2 * 24 * 13, f"phase {RESUME_PHASE}: {n} row-6 "
          f"launches, expected {2 * 2 * 24 * 13}")
    emit({"phase": f"train_resume_{RESUME_ARCH}", "phase_no": RESUME_PHASE,
          "ok": True, "batch": RESUME_BATCH, "seq": RESUME_SEQ,
          "straight": full, "resumed": resumed,
          "bitwise_equal": full[3:] == resumed,
          "straight_s": t_full, "resume_s": t_resume,
          "checkpoint_bytes": ckpt_bytes, "verify_s": t_verify,
          "verify_rc": ok, "verify_corrupt_rc": corrupt,
          "row6_launches": n})
    return n


def training_main() -> int:
    """Phases 50-51 in a process of their own: deterministic cuBLAS
    needs ``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call, and
    the full-width step wants the card to itself.  Prints the phases'
    records and, last, {"row6": {path: launches}}."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    build.load_all()
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    n_train = train_phase(torch, dev)
    n_resume = resume_phase(torch, dev)
    print(json.dumps({"row6": {f"train_{TRAIN_ARCH}": n_train,
                               f"train_resume_{RESUME_ARCH}": n_resume}}),
          flush=True)
    return 0


def training_phases() -> dict:
    """Phases 50-51 (``training_main``) in a child process; their records
    re-emitted here.  Returns row 6's launches by path."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--training"], capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, "phases 50-51 exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    for ln in lines[:-1]:
        if ln.startswith("{"):
            rec = json.loads(ln)
            rec["child_t_s"] = rec.pop("t_s", None)
            emit(rec)
    return json.loads(lines[-1])["row6"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port is missing ({SRC}/repro_torch); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import engine
    from repro_torch.core.ccim import CCIMConfig, DEFAULT_CONFIG, quantize_smf
    from repro_torch.core.ccim import smf_scale
    from repro_torch.kernels import build
    from repro_torch.kernels.ccim_matmul import kernel as K
    from repro_torch.launch.serve import serve
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = torch.device("cuda")
    t_start = time.time()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.load_all()
    build_s = time.time() - t0
    # registers, shared memory and spills: the first 8 lines per library,
    # every line of the skinny kernel's 32 instances (acc_len x planes x
    # token groups) and of the W8A8 kernel's 5 (token widths)
    every = ("skinny", "int8")
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or (n in every and "Compiling entry" in ln)
                 ][:None if n in every else 8]
             for n, log in build.build_info.get("ptxas", {}).items()}
    emit({"phase": "build", "seconds": build_s,
          "built": build.build_info.get("built"), "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def smf_ints(shape):
        v = torch.randn(shape, generator=gen, device=dev)
        return quantize_smf(v, smf_scale(v, dim=-1, keepdim=True))

    def run(x, p, cfg, use_kernel):
        return engine.packed_cim_matmul_int(x, p, cfg=cfg,
                                            use_kernel=use_kernel)

    max_err = {"skinny": 0, "general": 0}

    def compare(x, p, cfg, tag):
        y_k = run(x, p, cfg, True)
        y_p = run(x, p, cfg, False)
        torch.cuda.synchronize()
        name = "skinny" if x.shape[0] <= K.SKINNY_M else "general"
        err = int((y_k.long() - y_p.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        check(y_k.dtype == torch.int32 and torch.equal(y_k, y_p),
              f"{name} kernel != plain at {tag}: max |diff| {err}")

    # -- 2. full-width shapes ----------------------------------------------
    packs = {}
    for sname, (k, n) in FULL_SHAPES.items():
        wq = smf_ints((n, k)).t()
        packs[sname] = engine.pack_quantized_cim_weights(
            wq, torch.ones((1, n), device=dev), DEFAULT_CONFIG)
        for m in SKINNY_MS + GENERAL_MS:
            compare(smf_ints((m, k)), packs[sname], DEFAULT_CONFIG,
                    f"{sname} M={m}")
    emit({"phase": "full_width_shapes", "ok": True,
          "shapes": {s: list(v) for s, v in FULL_SHAPES.items()},
          "m": list(SKINNY_MS + GENERAL_MS), "max_abs_err": max_err})

    # -- 3. design-point sweep ----------------------------------------------
    n_points = 0
    for acc in (8, 16, 32, 64):
        w_raw = torch.randint(-127, 128, (1000, 300), generator=gen,
                              device=dev, dtype=torch.int32)
        for nd in range(7):
            for adc in (7, 8, 9):
                cfg = CCIMConfig(n_dcim_products=nd, adc_bits=adc,
                                 acc_len=acc)
                p = engine.pack_quantized_cim_weights(
                    w_raw, torch.ones((1, 300), device=dev), cfg)
                for m in (3, 77):
                    x = torch.randint(-127, 128, (m, 1000), generator=gen,
                                      device=dev, dtype=torch.int32)
                    compare(x, p, cfg, f"n_dcim={nd} adc={adc} L={acc} M={m}")
                    n_points += 1
        hybrid = CCIMConfig(n_dcim_products=3, acc_len=acc)
        p = engine.pack_quantized_cim_weights(
            w_raw, torch.ones((1, 300), device=dev), hybrid)
        for adc in (5, 7, 9):
            subset = CCIMConfig(n_dcim_products=0, adc_bits=adc, acc_len=acc)
            for m in (3, 77):
                x = torch.randint(-127, 128, (m, 1000), generator=gen,
                                  device=dev, dtype=torch.int32)
                compare(x, p, subset, f"analog subset adc={adc} L={acc} M={m}")
                n_points += 1
    emit({"phase": "design_sweep", "ok": True, "calls": n_points,
          "max_abs_err": max_err})

    # -- 4./5. full-width serve: kernels, then the plain version -------------
    cfg_full = get_config("minicpm-2b")
    batch, prompt_len, gen_len = 4, 32, 16
    params = lm.init(0, cfg_full, device=dev)
    runs = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        toks, stats = serve("minicpm-2b", smoke=False, batch=batch,
                            prompt_len=prompt_len, gen=gen_len, cim=True,
                            params=params, use_kernel=use_kernel,
                            return_stats=True, graphs=False)
        launches = {
            "general": K.ccim_matmul_prepacked_general_cuda.launches,
            "skinny": K.ccim_matmul_prepacked_skinny_cuda.launches}
        logits = stats.pop("last_logits")
        runs[label] = (toks, logits, launches)
        if label == "kernel":
            uniform = {"pack_bytes": stats["pack_bytes"],
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
        emit({"phase": f"serve_{label}", "n_layers": stats["n_layers"],
              "d_model": cfg_full.d_model, "vocab": cfg_full.vocab_size,
              "batch": batch, "prompt_len": prompt_len, "gen": gen_len,
              "pack_s": stats["pack_s"], "prefill_s": stats["prefill_s"],
              "decode_s": stats["decode_s"],
              "decode_tok_s": stats["decode_tok_s"],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": launches, "tokens_row0": toks[0].tolist()})
        check(toks.shape == (batch, gen_len), f"tokens shape {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg_full.vocab_size)).all()),
              "token ids out of range")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
    n_gemm = 4 * cfg_full.n_layers          # fused QKV, wo, gate-up, w2
    k_launch = runs["kernel"][2]
    check(k_launch["general"] == n_gemm,
          f"prefill launched {k_launch['general']} general kernels, "
          f"expected {n_gemm}")
    check(k_launch["skinny"] == n_gemm * (gen_len - 1),
          f"decode launched {k_launch['skinny']} skinny kernels, expected "
          f"{n_gemm} per step x {gen_len - 1}")
    check(runs["plain"][2] == {"general": 0, "skinny": 0},
          "the plain run launched kernels")
    check((runs["kernel"][0] == runs["plain"][0]).all(),
          "kernel and plain runs generated different tokens")
    check(torch.equal(runs["kernel"][1], runs["plain"][1]),
          "kernel and plain runs gave different logits")
    emit({"phase": "serve_compare", "ok": True, "tokens_equal": True,
          "logits_equal": True})

    # -- 6. where a full-width decode step spends its device time ----------
    # (its first PROFILE_LAYERS layers: at full depth reading the trace's
    # ~9,000 device events took most of the phase)
    cfg_cim = dataclasses.replace(cfg_full, cim_mode=True,
                                  n_layers=PROFILE_LAYERS)
    with torch.inference_mode():
        packed = lm.pack_cim_params(_first_layers(params, PROFILE_LAYERS),
                                    cfg_cim, dev)
        cache = lm.init_cache(cfg_cim, batch, prompt_len + gen_len,
                              device=dev)
        tok = torch.zeros((batch, prompt_len), dtype=torch.int64, device=dev)
        _, cache = lm.prefill(packed, cfg_cim, tok, cache)
        tok = tok[:, :1]
        lm.decode_step(packed, cfg_cim, tok, cache)      # warm
        torch.cuda.synchronize()
        steps = 1                 # phase 25 profiles three eager steps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _, cache = lm.decode_step(packed, cfg_cim, tok, cache)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    del packed, cache
    emit({"phase": "decode_profile", "steps": steps,
          "n_layers": PROFILE_LAYERS,
          "step_wall_ms": wall_ms, **device_breakdown(prof, steps, wall_ms)})

    # -- 7. per-kernel times --------------------------------------------------
    x_bits = (6, 5)                          # the prototype's top-3 split
    n_j = len(x_bits)
    meta = dict(acc_len=DEFAULT_CONFIG.acc_len, x_bits=x_bits,
                dcim_lsb=DEFAULT_CONFIG.dcim_lsb,
                adc_half=DEFAULT_CONFIG.adc_half_range)
    rows = {"skinny": times_skinny(torch, dev, packs, meta, smf_ints)}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    int_ops_s = n_sm * INT32_LANES_PER_SM * sm_clock_hz
    for name, m in (("general", 128),):
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, library_device_ms=0.0, bytes=0, ops=0)
        per_shape = {}
        for sname, (k, n) in FULL_SHAPES.items():
            p = packs[sname]
            kp = p.kernel_w.shape[1]
            x = smf_ints((m, kp)).to(torch.int8)
            w, planes = p.kernel_w, p.kernel_planes
            kern = lambda: K.ccim_matmul_prepacked_general_cuda(
                x, w, planes, **meta)
            ms = cuda_ms(kern, reps=30)
            dev_ms = graph_ms(torch, kern)
            plain = cuda_ms(
                lambda: K.ccim_matmul_prepacked_plain(x, w, planes, **meta),
                reps=5)
            # torch._int_mm: int8 GEMM without the per-chunk clip, M >= 17
            xi = torch.zeros((max(m, 32), kp), dtype=torch.int8, device=dev)
            lib_fn = lambda: torch._int_mm(xi, p.kernel_w.t())
            lib = cuda_ms(lib_fn, reps=30)
            lib_dev = graph_ms(torch, lib_fn)
            nbytes = m * kp + (1 + n_j) * n * kp + 4 * m * n
            nops = 2 * m * n * kp * (1 + n_j)
            bound = 1e3 * max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S)
            per_shape[sname] = dict(m=m, k=k, n=n, ms=ms, device_ms=dev_ms,
                                    plain_ms=plain, library_ms=lib,
                                    library_device_ms=lib_dev, bound_ms=bound)
            if name == "general":
                ks = K.general_k_split(m, n, kp, meta["acc_len"])
                iops = general_int_ops(m, n, kp, meta["acc_len"], n_j)
                per_shape[sname].update(
                    k_splits=-(-kp // ks), int_ops=iops,
                    epilogue_floor_ms=1e3 * iops / int_ops_s)
                tot["int_ops"] = tot.get("int_ops", 0) + iops
            for key, v in (("ms", ms), ("device_ms", dev_ms),
                           ("plain_ms", plain), ("bound_ms", bound),
                           ("library_ms", lib), ("library_device_ms", lib_dev),
                           ("bytes", nbytes), ("ops", nops)):
                tot[key] += v
        extra = {}
        if name == "general":
            tot["epilogue_floor_ms"] = 1e3 * tot["int_ops"] / int_ops_s
            extra = {"epilogue_floor": FLOOR_NOTE,
                     "int32_ops_per_s": int_ops_s,
                     "max_sm_clock_hz": sm_clock_hz,
                     "design_sweep": general_design_sweep(torch, dev, m)}
        emit({"phase": f"times_{name}", "m": m, "shapes": per_shape,
              "layer_total": tot, "timing": TIMING, **extra})
        rows[name] = tot
    # -- 8.-13. paged attention and continuous batching ----------------------
    pa_err = paged_attn_shapes(torch, dev)
    serve_phases = continuous_phases(torch, dev, params, cfg_full)
    pa_time = times_paged_attn(torch, dev)
    pa_wide = times_paged_attn_dh256(torch, dev)
    del params
    # -- 14.-17. the complex-MAC lane and the unpacked real GEMM ------------
    cx_err = complex_kernels(torch, dev, gen)
    unpacked = unpacked_real(torch, dev, gen)
    doa_run = doa_phase(torch, dev)
    cx_rows = times_complex(torch, dev, gen)
    # -- 18.-21. the W8A8 kernel, the kernel bench and Fig. 6 twins --------
    i8_err = int8_kernel(torch, dev, gen)
    bench = kernel_bench_phase(torch, dev)
    fig6_phase(torch, dev)
    i8_row = times_int8(torch, dev, gen)
    # -- 22.-24. deployment plans and speculative decoding -----------------
    params = lm.init(0, cfg_full, device=dev)       # phase 4's weights
    phase22 = plan_phase(torch, dev, params, cfg_full, uniform)
    by_path = {"serve": k_launch, "serve_plan": phase22["launches"]}
    by_path.update(speculative_phase(torch, dev, params, cfg_full))
    cont_spec = continuous_speculative_phase(torch, dev, params, cfg_full,
                                             serve_phases)
    by_path.update(cont_spec["macro"])
    serve_phases["paged_launches_by_path"]["serve_paged_speculative"] = (
        cont_spec["paged_attn"])
    # -- 25.-27. the serving bodies as CUDA graphs ---------------------------
    by_path["serve_captured"] = captured_serve_phase(
        torch, dev, params, cfg_full, runs["kernel"])
    by_path.update(captured_speculative_phase(torch, dev, params, cfg_full))
    by_queue = captured_scheduler_phase(torch, dev, params, cfg_full,
                                        serve_phases)
    for name, n in by_queue.items():
        by_path[f"scheduler_captured_{name}"] = {
            k_: n[k_] for k_ in ("general", "skinny")}
    serve_phases["paged_launches_by_path"]["scheduler_captured_paged"] = (
        by_queue["paged"]["paged_attn"])
    # -- 28.-31. threefry on the card, sampled and noisy serving -----------
    prng_phase(torch, dev)
    by_path["serve_sampled"] = sampled_serve_phase(
        torch, dev, params, cfg_full, runs["kernel"])
    sampled = sampled_scheduler_phase(torch, dev, params, cfg_full)
    for name, n in sampled.items():
        by_path[f"scheduler_sampled_{name}"] = {
            k_: n[k_] for k_ in ("general", "skinny")}
    serve_phases["paged_launches_by_path"]["scheduler_sampled_paged"] = (
        sampled["paged"]["paged_attn"])
    by_path["serve_noisy"] = noisy_serve_phase(torch, dev, params, cfg_full)
    # -- 33.-34. unpacked serving and the planner on raw weights ------------
    raw_paths = unpacked_serve_phase(torch, dev, params, cfg_full,
                                     runs["kernel"], phase22)
    raw_paths.update(planner_phase(torch, dev, params, cfg_full))
    for path, n in raw_paths.items():
        if path != "serve_unpacked":
            by_path[path] = {k_: n[k_] for k_ in ("general", "skinny")}
    del params
    # -- 32. noisy DoA; 35. the figure twins ----------------------------------
    noisy_doa_phase(torch, dev)
    figure_twins_phase(torch, dev)
    # -- 36.-37. serving telemetry and the serve_bench twin ------------------
    params = lm.init(0, cfg_full, device=dev)       # phase 4's weights
    by_path["scheduler_telemetry_paged"] = telemetry_phase(
        torch, dev, params, cfg_full, runs["kernel"][0])
    del params
    serve_bench_phase()
    # -- 38.-39. resilience: guarded serving, faults, the bench twin -------
    params = lm.init(0, cfg_full, device=dev)       # phase 4's weights
    by_path["scheduler_guarded"] = resilience_phase(torch, dev, params,
                                                    cfg_full)
    del params
    resilience_twin_phase()
    # -- 40.-43. the SSM and hybrid families at full width -----------------
    rec_paths = {}
    for arch, queue in ((SSM_ARCH, ssm_continuous_phase),
                        (HYBRID_ARCH, hybrid_continuous_phase)):
        model = _recurrent_model(torch, dev, arch)
        rec_paths.update(recurrent_lockstep_phase(torch, dev, arch, model))
        rec_paths.update(queue(torch, dev, model))
        del model
    # -- 44.-46. the dense configs at full width ---------------------------
    rec_paths.update(dense_phases(torch, dev))
    # -- 47. the moe family: qwen2-moe-a2.7b at full width, arctic smoke ---
    rec_paths.update(moe_phase(torch, dev))
    # -- 48.-49. the vlm and audio families at full width -------------------
    for family_phase in (vlm_phase, audio_phase):
        gc_collect(torch)
        rec_paths.update(family_phase(torch, dev))
    gc_collect(torch)
    # -- 50.-51. training at full width, checkpoints and resume -----------
    train_paths = training_phases()
    for path, n in rec_paths.items():
        by_path[path] = {k_: n[k_] for k_ in ("general", "skinny")}
        raw_paths[path] = n
        if n.get("paged_attn"):
            serve_phases["paged_launches_by_path"][path] = n["paged_attn"]

    src = "src/repro_torch/kernels/ccim_matmul/csrc/"
    table = []
    for name, entry, replaces in (
            ("skinny", "ccim_prepacked_skinny.cu",
             "src/repro/kernels/ccim_matmul/kernel.py:275"),
            ("general", "ccim_prepacked_general.cu",
             "src/repro/kernels/ccim_matmul/kernel.py:157")):
        t = rows[name]
        table.append({
            "name": f"ccim_matmul_prepacked_{name}",
            "route": "cuda", "source": src + entry, "replaces": replaces,
            "launches": k_launch[name], "max_abs_err": max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_S
                         >= t["ops"] / INT8_OPS_S else "operations"),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            **{k: t[k] for k in ("device_cold_ms", "library_cold_ms",
                                 "m", "by_m") if k in t}})
    table.append({
        "name": "paged_attention_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attn/csrc/"
                  "paged_attn_decode.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:81",
        "launches": serve_phases["paged_launches"],
        "launches_by_path": serve_phases["paged_launches_by_path"],
        "max_abs_err": pa_err, **pa_time})
    # head dim 256 (gemma2-9b's paged pool): its own kernel, the row's
    # numbers at gemma2-9b's heads and L 1,024, every case beside them
    wide = pa_wide[f"gemma2-9b_L{PA_DH256_LENGTHS[-1]}"]
    wide_path = "gemma2-9b_scheduler_paged"
    table.append({
        "name": "paged_attention_decode_dh256", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attn/csrc/"
                  "paged_attn_dh256.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:81",
        "launches": raw_paths[wide_path]["paged_attn"],
        "launches_by_path": {wide_path: raw_paths[wide_path]["paged_attn"]},
        "max_abs_err": max(r["max_abs_err"] for r in pa_wide.values()),
        **{k: wide[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "device_cold_ms",
                                "library_device_ms", "library_cold_ms",
                                "n_split")},
        "library": "paged_gather_kv + scaled_dot_product_attention "
                   "(another function: no softcap, window or mask)",
        "by_case": pa_wide})
    csrc = "src/repro_torch/kernels/ccim_complex/csrc/"
    ref = "src/repro/kernels/ccim_complex/kernel.py:"
    for name, label, source, replaces, launches, err in (
            ("complex_skinny", "ccim_complex_prepacked_skinny",
             csrc + "ccim_complex_skinny.cu", ref + "209",
             doa_run["launches"]["complex_skinny"], cx_err["complex_skinny"]),
            ("complex_general", "ccim_complex_prepacked_general",
             csrc + "ccim_complex_general.cu", ref + "255",
             doa_run["launches"]["complex_general"],
             cx_err["complex_general"]),
            ("unpacked", "ccim_matmul_unpacked", src + "ccim_unpacked.cu",
             "src/repro/kernels/ccim_matmul/kernel.py:327",
             raw_paths["serve_unpacked"]["unpacked"]
             + sum(train_paths.values()), unpacked["max_abs_err"]),
            ("complex_unpacked", "ccim_complex_unpacked",
             csrc + "ccim_complex_unpacked.cu", ref + "301",
             doa_run["launches"]["complex_unpacked"],
             cx_err["complex_unpacked"])):
        t = cx_rows[name]
        table.append({
            "name": label, "route": "cuda", "source": source,
            "design": TEMPLATE_DESIGN.get(name),
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "four_pass_ms": t["four_pass_ms"],
            "four_pass_device_ms": t["four_pass_device_ms"],
            "at_m": t["m"]})
        if name == "unpacked":
            table[-1]["launches_by_path"] = {
                "cim_matmul_raw": unpacked["launches"],
                **{p: n["unpacked"] for p, n in raw_paths.items()},
                **train_paths}
    table.append({
        "name": "int8_w8a8", "route": "cuda",
        "source": "src/repro_torch/kernels/int8_matmul/csrc/int8_w8a8.cu",
        "replaces": "src/repro/kernels/int8_matmul/kernel.py:36",
        "launches": bench["launches"]["int8"], "max_abs_err": i8_err,
        "ms": i8_row["ms"], "plain_ms": i8_row["plain_ms"],
        "bound_ms": i8_row["bound_ms"], "bound_by": i8_row["bound_by"],
        "library_ms": i8_row["library_ms"],
        "device_ms": i8_row["device_ms"],
        "device_cold_ms": i8_row["device_cold_ms"],
        "library_device_ms": i8_row["library_device_ms"],
        "library_cold_ms": i8_row["library_cold_ms"],
        "design": INT8_DESIGN, "at_m": i8_row["m"], "by_m": i8_row["by_m"]})
    emit({"phase": "done", "seconds": time.time() - t_start})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(training_main() if sys.argv[1:] == ["--training"] else main())
