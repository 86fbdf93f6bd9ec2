#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                          # from the root of a checkout
    python3 chip_smoke.py --size 2048 --hpl-n 1024  # a quick first call
    python3 chip_smoke.py --serve-layers 2          # phase 10 at depth 2
    python3 -c 'import chip_smoke as c, torch, argparse; c.train_phase(
        argparse.Namespace(seed=0), torch.device("cuda"))'  # phase 12 alone
    python3 -c 'import chip_smoke as c, torch, argparse; c.dist_phase(argparse.Namespace(
        seed=0, size=8192, hpl_n=8192), torch.device("cuda"), [])'  # phase 13 alone
    python3 -c 'import chip_smoke as c, torch, argparse; c.perf_phase(
        argparse.Namespace(seed=0), torch.device("cuda"))'  # phase 14 alone
    python3 -c 'import chip_smoke as c, torch, argparse; c.framework_phase(
        argparse.Namespace(seed=0), torch.device("cuda"))'  # phase 15 alone
    python3 -c 'import chip_smoke as c, torch, argparse; c.analysis_phase(
        argparse.Namespace(seed=0, size=8192), torch.device("cuda"))'  # phase 16 alone
    python3 -c 'import chip_smoke as c, torch, argparse; c.examples_phase(
        argparse.Namespace(seed=0), torch.device("cuda"))'  # phase 17 alone

Phases, each printing its elapsed time; any failed check raises and the
script exits non-zero without printing a result:

1. card: name and power limit; build of the CUDA kernels from csrc/ (one
   nvcc per source, all started together), with ptxas's registers, shared
   memory, stack frame, spills and wgmma serialization notes (C75xx) of
   each kernel; K5's and K6's must have no stack frame and no spill, K1/K2's
   GEMM core no spill.
2. MMA probes: K3/K4's mma.sync k32 FP8 step, and the K1/K2 GEMM core's
   wgmma step (each k32 product into a fresh f32 fragment, promoted into an
   f32 sum), on +-16 and mixed e4m3 patterns at k up to 65536 against an
   int64 product; each also beside an f32 accumulator chained across the
   steps: the longest exact wgmma chain, which the core's promotion
   interval must not exceed.
3. K1 (ozmm_fused_raw: residue prologue + GEMM core) vs its plain version,
   bitwise (torch.equal), at 1024^3, 1000x997x1003 and the main-path size,
   for ozaki2-fp8 fast/accurate, ozaki2-karatsuba fast and ozaki2-int8 fast;
   against the port's '+core' route; and its residue prologue (raw_parts)
   alone against its plain version on every plane it writes.
4. main path: ozmm(a, b, "ozaki2-fp8/accurate") and ".../fast" through
   backend auto at the main-path size; K1's launch count must move, with two
   prologue launches each; normwise error vs cuBLAS DGEMM <= 2^-44; integer
   inputs reproduce A @ B to rtol 1e-14 (the reference's own gate,
   tests/core/test_ozmm_accuracy.py: the f64-rounded Garner weights leave
   ~1 ulp) and bit for bit on a rerun.
5. K1 timings: median of 5 CUDA-event-timed runs after a warm-up (3 for the
   plain version), for the kernel, its split into prologue and core (and
   the core at k = 128, one k-tile per modulus: its per-tile epilogue), its
   plain version and a whole ozmm call, the cheaper layers and cuBLAS DGEMM
   (torch.matmul in float64, a yardstick the port never calls), with the
   kernel's roofline bound.
6. K2 (ozmm_fused_parts: B transpose + GEMM core) on plans prepared on the
   card, bitwise against its plain version, the '+core' route and the
   unprepared ozmm (K1), at the three shapes of phase 3, for ozaki2-fp8,
   ozaki2-karatsuba and ozaki2-int8 fast; one accurate prepared pair on
   '+pallas' (K1 under the bound GEMM's exponents) against '+core'; K2's
   timings (median of 5 after a warm-up) at the main-path size, split into
   transpose and core, beside K1's, cuBLAS DGEMM's and the same 3N FP8 (N
   int8) products through torch._scaled_mm (torch._int_mm), yardsticks the
   port never calls.
6b. past the core's chunk of k = 2^16, and the digit stack: K2 (ozaki2-fp8,
   12 moduli) on phase 2's probe patterns turned into parts (square moduli
   (v, v), Karatsuba (v, 0, v)), with row 4 of A and column 4 of B +16 then
   +1 so their sum ends odd past 2^24, at k = 3 * 2^16 + 128 on one
   128 x 128 tile: its digits (reconstruct="xla") bitwise equal to its plain
   version's and to the exact int64 residue products', its C to its plain
   version's, and one f32 product over the whole k shown not exact (max
   |sum| past 2^24, elements differing); K1 on lognormal phi = 0.5 operands
   at 512 x 2^18 x 512, fast and accurate: bitwise equal to its plain version
   and to ozmm, and on 4 rows within twice DGEMM's componentwise error bound
   (2k 2^-53 |A||B|) of a long-double product, timed beside its plain
   version, bound and cuBLAS DGEMM; K1 and K2 (fast) at the main-path size
   with reconstruct="xla": the digits bitwise equal to their plain versions',
   crt.reconstruct of them bitwise equal to the on-chip epilogue's C, each
   timed beside its on-chip mode; ozmm_pallas_fused with reconstruct="xla"
   bitwise equal to ozmm.
7. linalg on the card: run_hpl(n, policy, block=128, refine_steps=1) for
   native (cuBLAS DGEMM through the same driver) and ozaki2-fp8/fast (K2 on
   every trailing update and TRSM fold) at n = --hpl-n / 2, and
   ozaki2-fp8/accurate (K1 on the prepared pairs) at n = --hpl-n (phase
   13's distributed HPL runs beside it), each scaled residual <= 16 and
   each kernel's launch
   count (and its prologue's or transpose's) moving by the count the code
   predicts, with the time split between the kernels, the rest of the GEMM
   layer and the host, and K2's time a launch; each kernel at the inputs of
   its first call at every distinct shape of the run (TRSM folds, trailing
   updates, residuals) bitwise against its plain version; lu_factor and
   lu_solve at n = 1024 on '+pallas' bitwise equal to '+core', in fast (K2)
   and accurate (K1) mode; one Cholesky refine_solve of an SPD matrix at
   n = 2048 (SYRK's plan x plan tiles on K2), its K2 calls checked the same
   way.
8. the phase-split '+pallas+unfused' pipeline: K6 (quant_residues: its
   f64 entry, which the path runs, and its frame entry), K3 (fp8_gemm), K4
   (int8_gemm) and K5 (requant_garner: its f64 mode, which the path runs,
   and its digits mode) each bitwise against its plain version at 1024^3,
   1000x1024x1003, 1000x997x1003 and the main-path size (e4m3 as bytes), on
   the pipeline's operands (B's parts K-major, from K6 on B^T, itself
   checked against K6 on B by columns, transposed), and K6's two entries
   against each other and on an edge matrix (zeros, subnormals, 1e+-300,
   +-(2^53 - 1), scales past 1023); accurate scaling's exponents at 1024^3
   equal with the global TF32 switch on and off; K3
   and K4 on the route the shape gives (wgmma where k % 16 == 0, else
   mma_sync) and, where that is wgmma, modulus 0's products again through
   the mma_sync route (A 1 byte off alignment); K3 also against
   torch._scaled_mm and K4 against torch._int_mm (oracles the port never
   calls) where their shape rules allow; K3 exact at k = 65536 on both
   routes for +-16 and "+16 then +1" parts, K4 at its limit k = 2^17 for
   +-127 and "+127 then +1"; then the path itself: ozmm(a,
   b, spec + "+pallas+unfused") at the main-path size for the four
   policies, each launch count (K6 2, K3 3N or K4 N, K5 1 a call) and
   route count moving by the predicted amount and no B copied by a GEMM
   wrapper, bitwise equal to '+core' and to the fused '+pallas' (K1),
   normwise error vs cuBLAS DGEMM <= 2^-44; prepared pairings (fast,
   accurate) on '+pallas+unfused' against '+core'; lu_factor + lu_solve at
   n = 1024 on '+pallas+unfused' against '+core'; timings (median of 5
   after a warm-up) of each kernel on the pipeline's own operands (B
   K-major, so no transpose is timed; K5 and K6 in both modes), its plain
   version, its library call and its bound, K3/K4 also on the mma_sync
   route, and one ozmm call split into scaling, B's f64 transpose, K6, the
   K3/K4 total and K5, with the PyTorch passes the card's route no longer
   runs (scaled_int, decompose_int, crt.reconstruct) required at 0 calls.
9. autograd, Ozaki-I, the perf model and obs. (ozmm(A, B, spec) * G).sum()
   .backward() at the main-path size (G from the seed) for ozaki2-fp8
   accurate and fast and ozaki2-int8 fast on backend auto (K1: 3 launches,
   6 of its prologue) and ozaki2-fp8/accurate+unfused and
   ozaki2-int8/fast+unfused (auto's phase-split route: K6 6, K3 9N or K4
   3N, K5 3), K2, its transpose and K6's frame entry predicted at 0, launch
   counts zeroed just before and read just after each, no B copied by a
   GEMM wrapper; A.grad and B.grad bitwise equal to ozmm(G, B^T, "+core")
   and ozmm(A^T, G, "+core"), normwise error vs cuBLAS DGEMM <= 2^-44;
   forward and forward+backward timed (median of 5 after a warm-up), with
   the glue's f64 copies of the transposed operands (row_major, k_major:
   the copies made, and the time of their calls) counted. The plan-reusing
   '+core' VJP at 1024^3 in both modes (same gate; whether it equals the
   unprepared products bitwise is reported), an explicit '+pallas'
   gradient raising the reference's message, and a batched (3, 2048,
   2048) gradient (9 K1 launches, same gate). Ozaki-I accurate@11 and
   fast@11 at the main-path size: normwise error <= 2^-44 / 2^-40, a rerun
   bitwise, the time (median of 3) beside the fp8 accurate forwards (its
   products run as f32 GEMMs on the core executor, not on the FP8 tensor
   cores). The Table-II model's prediction on H100_SXM_SHEET for the four
   policies beside 2mnk / t of phases 5 and 8 (printed, not a gate). Obs:
   one fp8 accurate forward+backward at 2048^3 counts gemm.calls 1 and
   gemm.mma_ops 2mnk x the Table-II product count; a fenced span around
   one main-path call within 0.8-1.5x of its CUDA-event time and an
   unfenced one at most 0.75 of the fenced one; their Chrome trace
   validates; health.bound_gemm_probe on numpy operands at 2048^3 runs its
   bound GEMM on the card by default, bounds log2 max|A @ B| and agrees
   with its device="cpu" result within log2(1 + k 2^-24), the bound's own
   allowance for the f32 summation order.
10. serving (repro_torch.models + repro_torch.serve): qwen2-7b at its
   published width (d_model 3584, 28/4 heads x 128, d_ff 18944, vocab
   152064, QKV bias, bf16 compute, f32 weights from the seed), depth cut to
   --serve-layers (default 1 of 28: with phase 11 the run passed ~480 s
   at 2), through BatchingEngine(policy
   "ozaki2-fp8/fast", 4 slots, pages of 16): the weights quantized once
   into the WeightResidueCache (timed; its nbytes), then 4 greedy requests
   with prompts of 17, 32, 48 and 64 seeded tokens and 8 new tokens each.
   Checks: every request finishes with 8 in-vocabulary tokens; one prefill
   wave and 7 decode steps; K2 (and its transpose) launched (7 L + 1) times
   a wave or step and K1, K3-K6 never; K2 at its first call of every
   distinct input shape of the run (prefill, decode, lm_head) bitwise
   against its plain version; the first prefill's and decode step's logits
   equal the same engine's on "ozaki2-fp8/fast+core" (sharing the weight
   cache) bitwise; requests 0 and 3 run alone through ServeEngine give the
   batch's tokens and logits bitwise. Reported: quantization s, cache and
   peak memory, TTFT, decode ms a step, tokens/s (a second, timed run),
   one decode step split by CUDA events (K2's core, the weight parts'
   per-call stack_parts + _pad3 + transpose_parts, the activation's
   quantize_matrix + pair_exponents, attention's _sdpa + paged KV, the
   rest), K2 at lm_head's decode shape beside its plain version, bound,
   cuBLAS DGEMM and its products through torch._scaled_mm, and the same
   timed run under "native" (bf16 torch.matmul, a yardstick). Then the
   smoke width (get_config("qwen2-7b", "smoke"), 3 requests, 2 slots)
   under ozaki2-fp8/accurate (K1), ozaki2-fp8/fast+unfused (K3, K5),
   ozaki2-fp8/accurate+unfused (K6, K3, K5) and ozaki2-int8/fast+unfused
   (K4, K5): tokens and logits bitwise equal to the policy's '+core' twin,
   each kernel's launches as predicted a GEMM call; and two requests of
   accuracy classes "relaxed" and "fp64" served by two policy groups with
   ordered moduli.
11. the other model families (repro_torch.models' MoE, MLA, Mamba2, zamba2,
   encoder-decoder and vlm), phase 10's model freed first. (a)
   moonshot-v1-16b-a3b at its published widths (d_model 2048, 16/16 heads x
   128, 64 experts top-6 of d_ff 1408 + 1 shared, dense first layer d_ff
   11264, vocab 163840), cut to 3 of 48 layers (the dense layer and two MoE
   layers), and (b) mamba2-2.7b at its published widths (d_model 2560,
   state 128, 80 heads x 64, chunk 128, tied embeddings), cut to 2 of 64
   layers; each with f32 weights from the seed and bf16 compute, through
   BatchingEngine("ozaki2-fp8/fast", 4 slots; paged with pages of 16 for
   MoE, slot-pooled for the SSM) on phase 10's 4 requests. Checks: the plans
   and every launch count as family_gemms reckons them from the config (K2
   and its transpose once a cached GEMM; mamba2's tied lm_head is raw, as in
   the reference's cache: K1 and 2 prologues a call); K2 and K1 at the first
   call of every distinct input shape bitwise against their plain versions;
   the first prefill's and decode step's logits equal "+core" bitwise;
   requests 0 and 3 alone through ServeEngine give the batch's tokens (MoE
   under moe_dropless=True: capacity dispatch follows the bucket's length),
   logits bitwise or else within 1e-5 of max|logit|, and a probe of
   whether the routed experts' bf16 einsum gives a row the same bits at
   another row count. Reported as phase 10's (quantization s, plans and
   nbytes, peak GB, TTFT, decode ms, tokens/s beside native), a decode
   step split by CUDA events (the routed experts and the SSM's
   conv/SSD/norm apart from the emulated GEMMs), and K2 at moonshot's
   lm_head decode shape (4 x 2048 x 163840). (c) the smoke widths of
   deepseek-v3 (MLA + MoE, paged latent cache), moonshot, mamba2, zamba2
   (shared block), seamless-m4t (encoder memory of audio frames,
   cross-attention; Model.init_cache / prefill / decode_step), internvl2
   (patch embeddings; the same) and gemma2 (softcaps, alternating sliding
   window, post-norms, tied head) under ozaki2-fp8/fast and each policy of
   phase 10's smoke width: tokens and logits bitwise equal to the '+core'
   twin, each kernel's launches as predicted.

12. training (repro_torch.train, optim, checkpoint, data, runtime), the
   earlier phases' models freed first. (a) starcoder2-15b at its published
   widths (d_model 6144, 48/4 heads x 128, d_ff 24576, plain GELU MLP, QKV
   bias, vocab 49152, untied lm_head, remat "full"), cut to 2 of 40 layers,
   f32 parameters from the seed, bf16 compute, "ozaki2-fp8/fast" on backend
   auto: Trainer(4 steps, 2 microbatches) over DataConfig(batch 8, seq_len
   256). Checks: every loss finite; the parameters moved; K1 launched as
   train_gemms reckons it (a microbatch: 13 forward, 12 recomputed, 26
   cotangent GEMMs) with 2 prologues each, K2-K6 never; K1 and its
   prologue at their first call of every distinct input shape bitwise
   against their plain versions. Reported: the step (median of steps 1-3),
   split by CUDA events (K1 core, prologue, decompose_raw + padding, the
   glue's f64 copies, scaling, AdamW, attention, the rest), tokens/s, peak
   GB, K1 at lm_head's input-gradient shape (1024 x 49152 x 6144, the
   vocabulary contraction) beside its plain version, bound and cuBLAS
   DGEMM, and the same run under "native" (bf16 torch.matmul). (b) FP64
   grade: (a)'s trained parameters in f64, a synth_batch(step=10000) of 2 x
   128: "ozaki2-fp8/accurate" (K1) against "native" f64 (cuBLAS DGEMM):
   lm_head's product on the final hidden state in f64 within twice
   DGEMM's componentwise error bound k 2^-53 |h||W|; forward_train's
   logits (f32, as the reference's models emit them) within one f32 ulp;
   every parameter's gradient of loss_fn within 2^-23 normwise (the
   reference example's max |d| / (|ref| + 1e-6) < 1e-9 is reported: the
   model's f32 islands and near-zero logits put it out of reach here). (c) the smoke configs of qwen2-7b, starcoder2,
   moonshot (MoE aux), deepseek-v3 (MLA + MoE + MTP), mamba2 (tied head),
   zamba2 (shared block), seamless-m4t (frames), internvl2 (patches,
   masked labels) and gemma2 (softcaps, post-norms, tied head): one
   make_train_step step under ozaki2-fp8/fast (K1) and
   ozaki2-fp8/accurate+unfused (K6, K3, K5), and ozaki2-int8/fast+unfused
   (K6, K4, K5) for qwen2-7b, each against its '+core' twin from the same
   state and batch (loss, gradients, new parameters and moments bitwise),
   each kernel's launches as predicted; the Trainer at qwen2-7b's smoke
   width resumed from the CheckpointManager (4 steps straight == 2, a
   restore, 2 more, bitwise); beside a probe of whether the backward's
   accumulating ops (the embedding gather's, take_along_dim's, the dispatch
   einsum's) give the same bits twice (the phase needs no
   torch.use_deterministic_algorithms: the probe found all three
   deterministic on the card). (d) qwen2-7b at its published widths
   (d_model 3584, 28/4 heads x 128, d_ff 18944, gated SiLU MLP, QKV bias,
   vocab 152064, untied lm_head, remat "full"), cut to 2 of 28 layers, as
   (a) on 2 steps and without the native run: lm_head's input gradient
   contracts over the 152,064 vocabulary rows, three of K1's chunks of
   2^16. The same checks and split as (a), and K1 at that shape (1024 x
   152064 x 3584; its plain version on column blocks of B) beside its
   plain version, bound and cuBLAS DGEMM; the part's seconds.

13. distributed (core.distributed, linalg.dist), every rank on the card:
   (a) ozmm_mn_sharded (accurate: pair_exponents + K1 a shard; fast: K2)
   and ozmm_k_sharded (fp8 fast and accurate: K6 and 3N K3 a shard; int8
   fast: K6 and N K4) at --size^3 on a 2 x 4 mesh of the card, launches as
   predicted; k-sharded fast (fp8, int8) and mn-sharded fast bitwise equal
   to the single-device ozmm; every mn block and every k shard's residue
   products bitwise equal to '+core' on that shard; accurate gates on 8
   rows against a long-double product (componentwise over |A||B|: < 2^-49,
   k-sharded <= 4x the unsharded error); each strategy's ms beside the
   single-device ozmm and cuBLAS DGEMM; K1/K2/K3/K4/K6 at their first shard
   shape bitwise against their plain versions and timed. (b) lu_factor_dist
   under ozaki2-fp8/fast at n = --hpl-n / 2, block 128, 2 x 2, plan and f64
   wires, and a ragged n (2000 by default) on 4 x 1: pivots and factors
   bitwise equal to the single-device lu_factor, K2 (plans) or K1 (f64)
   launches as predicted,
   bytes on the wire, the time by stage. (c) run_hpl_dist under
   ozaki2-fp8/accurate at n = --hpl-n / 2, 2 x 2: the HPL gate, K1 launches as
   predicted (trailing updates, the solves' rank GEMMs, the refinement
   residuals' rank matvecs), seconds, GFLOP/s and the split by stage beside
   phase 7's single-device run.

14. the perf sweep and resolve_fastest (repro_torch.perf): run_sweep on the
   card over repro_torch.perf.sweep's full grid: 4096^3 and qwen2-7b's
   decode MLP up-projection 4 x 3584 x 18944, 20 specs (fp8 fast @5..12,
   fp8 accurate @4, 7, 10, 12, int8 fast @6, 9, 13, 14, Karatsuba fast
   @5, 8, 11, 13: each family at the resolver's floor for each tier and at
   its default count), each on '+core', '+pallas' (K1) and
   '+pallas+unfused' (K6, K3/K4, K5), a warm-up and 3 timed calls a cell,
   the error against numpy's f64 product. Checks: every '+pallas' and
   '+pallas+unfused' C equals its '+core' C (bitwise); each cell's
   launches as the code predicts (K1 and 2 prologues a call; K6 2, K3 3N
   or K4 N, K5 1 a call; none on '+core'); the grid holds each family's
   floor for each tier at both shapes; every tier (1e-4, 1e-8, 1e-12) has
   a winner at 4096^3; the candidate preset round-trips through
   PerfModel.load; resolve_fastest at 4096^3 with the candidate returns,
   for each tier, a swept policy at or above the resolver's floor whose
   measured error meets the tier, and with no preset exactly
   resolve_for's; with no model named it reads the checked-in
   presets/h100-sm90.json (fresh on this card) and returns what that file
   gives, a swept policy whose measured error meets the tier. The cells as
   schema-v2 rows validate, seed a trajectory store and compare "ok"
   against it. Printed: the Pareto front and the tier winners of each
   bucket, in ms. K1 at the decode shape (fp8 fast, 12 moduli) against
   its plain version, timed beside its bound and cuBLAS DGEMM.

15. the distribution layer (repro_torch.distribution, launch.dryrun),
   every rank on the card. (a) pipeline_apply (GPipe, M + S - 1 steps) over
   4 of qwen2-7b's 28 decoder layers at full width (d_model 3584, d_ff
   18944, 28/4 heads), one a stage on a 4-rank "stage" mesh of the card,
   6 microbatches of 2 x 512 tokens (bf16 hidden states from the seed),
   under ozaki2-fp8/fast: the output bitwise equal to the 4 layers applied
   in sequence to each microbatch, K1 launched 7 times a layer and
   microbatch (2 prologues each; K2-K6 never); wall time and peak memory.
   (b) make_sharded_train_step on qwen2-7b at full width, 1 of 28 layers,
   ozaki2-fp8/fast, a batch of 2 x 256 from synth_batch, from the state the
   seed draws: on a (data 1, model 4) mesh of the card bitwise equal to the
   single-device step (loss and every rank's block of the parameters and
   moments); on (2, 2) the loss within 1e-4 of the single-device loss (the
   reference's bound), the state after unshard_state and the loss bitwise
   equal to the same function on one device (each data rank's gradient
   by train.step.batch_grads, summed in rank order and divided, then
   optim.update), and that mean gradient within 2e-2 of the whole batch's,
   normwise in every leaf (bf16 compute rounds each data rank's gradient
   on its own), where a planted fault (data rank 1's rows dropped) must
   trip the same bound; the state's deviation from the single-device
   step's printed, not gated (at step 1 AdamW moves each parameter by
   ~lr sign(g)), with the share of it that sign flips make; K1 launched
   as train_gemms reckons it for each data rank; each step's time beside
   the single device's, and peak memory. (c) dryrun_cell("qwen2-7b", "train_4k") and
   ("qwen2-7b", "decode_32k") on the 16 x 16 production mesh of meta
   devices (nothing allocated, the card untouched): status "ok" and
   flops_per_device equal to launch.dryrun.model_flops, the analytic count
   of rank 0's program; the records printed. K1 at (a)'s MLP up-projection
   (1024 x 3584 x 18944) and at (b)'s lm_head input gradient for a data
   rank of (2, 2) (256 x 152064 x 3584), each against its plain version,
   timed beside its bound and cuBLAS DGEMM.
16. analysis (repro_torch.analysis): (a) the RPL rule pack over
   src/repro_torch finds nothing new against the packaged baseline (its
   astlint section is empty). (b) the graph checker runs the nine registry
   entries on the card: nothing new against the baseline's graph section;
   each ozmm entry launches K1 once (two prologues); each entry is traced
   again on the CPU under the route the card took ("+pallas" for the ozmm
   entries: K1's plain version), and the two traces' findings outside the
   kernel scopes are equal, and each K1 node's input and output dtypes and
   shapes equal those of its plain-version scope. (c) ozmm at the main-path
   size under ozaki2-fp8/accurate, ozaki2-fp8/fast and ozaki2-int8/fast,
   traced: one K1 launch each; the findings equal (b)'s for the same entry
   with the shapes set aside; C bitwise equal to the untraced call; the
   traced and untraced ms (median of 3 on the host clock). (d) planted
   faults, each found on the card and its fixed twin clean: an f64 -> f32
   cast on an output path (RPJ001), an f32 mm with TF32 switched on and
   restored after (RPJ001), an int32 mul -> add (RPJ002), an in-place
   argument copied instead of written (RPJ003), a float index_add_ on a
   bitwise entry (RPJ004). K1 at (c)'s shape under ozaki2-fp8/accurate
   against its plain version, timed beside its bound and cuBLAS DGEMM.
17. the example drivers (examples/torch_*.py), each through its
   main(argv) in this process on the card: torch_quickstart (its defaults;
   every Ozaki-II row on K1, Ozaki-I on core, '+pallas' == '+core'
   bitwise), torch_hpl_lu at its defaults (n = 768, native and fp8 / int8
   accurate) and with --grid 2x2 --n 1000 for fp8 fast and accurate,
   torch_serve_demo for qwen2-7b and mamba2-2.7b (smoke configs, native),
   torch_serve_continuous at its defaults (qwen2-7b smoke, ozaki2-fp8/fast,
   two accuracy classes, an oversized request rejected) and for mamba2-2.7b
   under native, torch_fp64_train --profile paper (~100M parameters, 200
   native f32 steps of 8 x 256 tokens with checkpoints, then the FP64-grade
   gates of 12 (b) on the emulated f64 forward), torch_check_pipeline; each
   run to its own OK, with its drivers' own assertions. Checks: each run's
   K1/K2 launches (2 prologues a K1, a transpose a K2; K3-K6 never) as
   predicted from the driver's code and arguments (the serving drivers: a
   model call's GEMMs, from the config, times the calls the run made); K1
   and K2 at their first call of every distinct input shape of every run
   bitwise against their plain versions; the seconds of each run. K1 at
   fp64_train's f64 lm_head (2048 x 768 x 32000, ozaki2-fp8/accurate) and
   K2 at serve_continuous' decode lm_head (4 x 128 x 512, m padded to
   128), each against its plain version, timed beside its bound and
   cuBLAS DGEMM.

The last two lines are the card (nvidia-smi name, power limit) and
{"ok": true, "device": {...}}; before them a {"kernels": [...]} line, whose
rows are the main path's kernels and then each phase's rows (6b's: K1 at
the long contraction, K1 and K2 in digits mode; 12's: K1 at (a)'s and
(d)'s lm_head input gradients); then K1, K2, K3, K4 and K6 at phase 13's
shard shapes, with (a)'s launches; K1 at phase 14's decode shape, with
the sweep's K1 launches; K1 at phase 15's (a) and (b) shapes, with their
launches; K1 at phase 16's (c) shape, with phase 16's K1 launches ((b)
and (c)); the last two are K1 and K2 at phase 17's shapes, with phase
17's launches.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# Phase 10's full-width serving run holds ~36 GB of weights and plans beside
# ~39 GB of per-call part copies (PERF.md): without expandable segments the
# caching allocator's fragments leave too little contiguous room for them.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

#: Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
#: sheet): HBM bytes/s, and FP8 = int8 tensor operations/s.
H100_BYTES_PER_S = 3.35e12
H100_FP8_OPS_PER_S = 1.979e15
POLICIES = ("ozaki2-fp8/fast", "ozaki2-fp8/accurate", "ozaki2-karatsuba/fast",
            "ozaki2-int8/fast")
UNFUSED = "+pallas+unfused"
#: Prepared (fast-mode) pairings run on K2.
K2_POLICIES = ("ozaki2-fp8/fast", "ozaki2-karatsuba/fast", "ozaki2-int8/fast")
#: Phase 7's HPL runs, each policy's n as a fraction of --hpl-n: the
#: host-bound native and fast runs at half of it keep the whole run well
#: inside its limit on a slow host (at n = 8192 they took 65 and 124 s on
#: an H100 80GB HBM3, 700.00 W, whose host was slow).
HPL_POLICIES = {"native": 2, "ozaki2-fp8/fast": 2, "ozaki2-fp8/accurate": 1}
HPL_BLOCK = 128
#: Timed runs of K1's plain version (~1.3 s each at 8192^3); 3 rather than 5
#: keeps the whole run near half its time limit.
K1_REPS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[phase] {name} done in {now - t0:.1f} s", flush=True)
    return now


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def lognormal(gen, shape, phi, device):
    """The paper's §V-A generator, (rand - 0.5) * exp(randn * phi), on the card."""
    import torch

    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    return (u - 0.5) * torch.exp(z * phi)


def cuda_times(fn, reps: int = 5) -> list[float]:
    """Wall times of ``reps`` calls of fn on the card (CUDA events, ms),
    after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn on the card (CUDA events), after one warm-up."""
    return statistics.median(cuda_times(fn, reps))


class CallTotals:
    """Wraps ``module.name`` while in the block and totals the time of its
    calls: between CUDA events recorded on the current stream before and
    after each call (``events=True``: device time, which also counts the
    call's own host work while the card waits for it), or by the host clock
    (for host functions that end in a synchronizing copy)."""

    def __init__(self, module, name: str, *, events: bool = True):
        self.module, self.name, self.events, self.spans = module, name, events, []

    def __enter__(self):
        import torch

        self.orig = fn = getattr(self.module, self.name)

        def timed(*a, **kw):
            if self.events:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                out = fn(*a, **kw)
                end.record()
            else:
                start = time.perf_counter()
                out = fn(*a, **kw)
                end = time.perf_counter()
            self.spans.append((start, end))
            return out

        # a wrapped kernel wrapper counts its launches on its own attribute,
        # through its module's global name: give the stand-in the counters and
        # hand them back on exit
        self.timed = functools.update_wrapper(timed, fn)
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        for key, value in vars(self.timed).items():
            if key != "__wrapped__":
                setattr(self.orig, key, value)

    def seconds(self) -> float:
        import torch

        if not self.events:
            return sum(e - s for s, e in self.spans)
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.spans) / 1e3


def shapes_of(x):
    """The shapes of a call's tensor arguments, nested as the arguments are."""
    if isinstance(x, (tuple, list)):
        return tuple(shapes_of(v) for v in x)
    return tuple(x.shape) if hasattr(x, "shape") else None


class FirstCallPerShape:
    """Wraps ``module.name`` while in the block and keeps the arguments of
    its first call at each distinct set of input shapes, so that each can be
    held against the plain version after the run."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, {}

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def keep(*a, **kw):
            self.calls.setdefault(shapes_of(a), (a, kw))
            return fn(*a, **kw)

        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def check(self, kern, ref, what: str) -> int:
        """Runs ``kern`` and ``ref`` on each kept call's arguments and requires
        the same bits; returns the number of shapes checked and frees them."""
        for key, (a, kw) in self.calls.items():
            check_equal(kern(*a, **kw), ref(*a, **kw), f"{what} at input shapes {key}")
        n, self.calls = len(self.calls), {}
        return n


def part_bytes(ms, m: int, k: int, n: int) -> int:
    """Bytes K2 must read and write: the parts it reads (2 per square
    modulus, 3 per Karatsuba modulus, 1 per int8 modulus) of both operands,
    lmu and lnu, and the f64 product."""
    if ms.family == "int8":
        parts = ms.n
    else:
        parts = sum(2 if sq else 3 for sq in ms.is_square)
    return parts * (m * k + k * n) + 4 * (m + n) + 8 * m * n


def library_products(sa, sbk, sb, ms):
    """A function that runs the core's products of one call through PyTorch's
    library calls, a yardstick the port never calls: per modulus the eq.
    (12)/(8) e4m3 products by torch._scaled_mm (B column-major, from the
    K-major stacks sbk), or the int8 product by torch._int_mm (B (k, n) from
    the stack sb)."""
    import torch

    if ms.family == "int8":
        pairs = [(sa[l], sb[l]) for l in range(ms.n)]
        return lambda: [torch._int_mm(x, y) for x, y in pairs]
    one = torch.ones((), dtype=torch.float32, device=sa[0].device)
    pairs = []
    for l, sq in enumerate(ms.is_square):
        qs = ((0, 1), (1, 0), (1, 1)) if sq else ((0, 0), (1, 1), (2, 2))
        pairs += [(sa[i][l], sbk[j][l].t()) for i, j in qs]
    return lambda: [torch._scaled_mm(x, y, scale_a=one, scale_b=one, out_dtype=torch.float32,
                                     use_fast_accum=False) for x, y in pairs]


def check_equal(x, y, what: str) -> None:
    """Bitwise equality (torch.equal); on failure, name the first difference."""
    import torch

    if torch.equal(x, y):
        return
    if x.shape != y.shape or x.dtype != y.dtype:
        raise SmokeFailure(f"{what}: {x.dtype} {tuple(x.shape)} vs {y.dtype} {tuple(y.shape)}")
    diff = (x != y).nonzero()
    nans = (int(torch.isnan(x).sum()), int(torch.isnan(y).sum()))
    if len(diff) == 0:
        raise SmokeFailure(f"{what}: no element differs but NaNs {nans}")
    idx = tuple(int(i) for i in diff[0])
    raise SmokeFailure(f"{what}: {len(diff)} elements differ, NaNs {nans}; first at "
                       f"{idx}: {x[idx].item()!r} vs {y[idx].item()!r}")


def probe_operands(k: int, device, rows: int = 16, cols: int = 8, big: int = 16):
    """A (rows, k) and B (k, cols) patterns: all +big, alternating +-big (two
    phases), +big then +1 (a small tail after a large running sum), and
    seeded random integers in [-big, big]; e4m3 for big = 16, else int8.
    Returns them with their exact int64 product (on the CPU)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    idx = np.arange(k)
    alt = np.where(idx % 2 == 0, big, -big)
    alt2 = np.where((idx // 2) % 2 == 0, big, -big)
    tail = np.where(idx < k // 2, big, 1)
    a = rng.integers(-big, big + 1, (rows, k))
    a[0], a[1], a[2], a[3] = big, alt, tail, alt2
    b = rng.integers(-big, big + 1, (k, cols))
    b[:, 0], b[:, 1], b[:, 2], b[:, 3] = big, alt, tail, alt2
    # exact in f64 in any order: |sums| <= big^2 k < 2^53
    a, b = (torch.tensor(x, dtype=torch.float64, device=device) for x in (a, b))
    want = (a @ b).long().cpu()
    if big != 16:
        return a.to(torch.int8), b.to(torch.int8), want
    return a.float().to(torch.float8_e4m3fn), b.float().to(torch.float8_e4m3fn), want


class Swapped:
    """Sets ``module.name`` to ``fn`` while in the block."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def as_bytes(t):
    """e4m3 as its bit pattern, so that torch.equal compares bytes."""
    import torch

    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def max_abs_err(x, y) -> float:
    """max |x - y| over float64 values (e4m3 through float32)."""
    import torch

    f64 = lambda t: (t.float() if t.dtype == torch.float8_e4m3fn else t).double()  # noqa: E731
    return (f64(x) - f64(y)).abs().max().item()


def misaligned(x):
    """A copy of x whose data starts 1 byte past a 16-byte boundary: TMA cannot
    address it, so a residue GEMM on it takes the mma_sync route."""
    import torch

    buf = torch.empty(x.numel() + 16, dtype=torch.uint8, device=x.device)
    y = buf[1:1 + x.numel()].view(x.dtype).view(x.shape)
    return y.copy_(x)


def edge_matrix(rng, k: int, device):
    """K6's edge inputs, (12, k) f64 and per-row log2 scales: rows of zeros,
    signed values, subnormals, values near 1e-300 and 1e300, signed integers
    near 2^53, powers of two and values up to the f64 maximum, under scales
    that include 1074 and 1100 (past ldexp_wide's single-factor range)."""
    import numpy as np
    import torch

    a = (rng.random((12, k)) - 0.5) * np.exp(rng.standard_normal((12, k)) * 2.0)
    sign = np.where(np.arange(k) % 2 == 0, 1.0, -1.0)
    a[0] = 0.0
    a[1, : k // 2] *= -1.0
    a[2] = rng.choice([5e-324, -5e-324, 1e-310, -2.2250738585072014e-308, 0.0, -0.0], k)
    a[3] *= 1e-300
    a[4] *= 1e300
    a[5] = rng.integers(-2 ** 53, 2 ** 53, k).astype(np.float64)
    a[6] = np.ldexp(sign, rng.integers(0, 60, k))
    a[7] = (2.0 ** 53 - 1) * sign
    a[8] = np.finfo(np.float64).max * (rng.random(k) - 0.5)
    a[9] = rng.choice([1e-320, -3e-315, 4.9e-324], k)
    a[10] *= 1e-305
    lscale = np.array([5, 40, 1074, 1000, -900, 0, 0, 1, -1020, 1100, 1050, 60], dtype=np.int32)
    return torch.from_numpy(a).to(device), torch.from_numpy(lscale).to(device)


#: Phase 6b: the K2 probe's contraction (three chunks of the core's 2^16 and
#: one k-tile), K1's long contraction (m, k, n), and the long-double rows of
#: its gate.
PROBE_K = 3 * 2 ** 16 + 128
LONG_SHAPE = (512, 2 ** 18, 512)
LONG_GATE_ROWS = 4


def k_row(name: str, spec: str, shape, launches: int, max_err, ms_kernel: float,
          ms_plain: float, n_bytes: int, products: int, library_ms, **extra) -> dict:
    """A kernels line's row of K1 ("ozmm_fused_raw") or K2 ("ozmm_fused_parts")
    at ``shape`` (m, k, n): its bound from the bytes it must move and its
    ``products`` FP8 (int8) products of 2mnk operations."""
    m, k, n = shape
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = products * 2 * m * n * k / H100_FP8_OPS_PER_S * 1e3
    k1 = name == "ozmm_fused_raw"
    return {"name": name, "policy": spec, "shape": [m, k, n], "route": "cuda",
            "source": f"src/repro_torch/csrc/{'fused_raw' if k1 else 'fused_parts'}.cu",
            "replaces": f"src/repro/kernels/fused/kernel.py:{238 if k1 else 265}",
            "launches": launches, "max_abs_err": max_err, "ms": ms_kernel, "plain_ms": ms_plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms, **extra}


def long_k_phase(args, dev, gen, launches: int) -> list[dict]:
    """Phase 6b (module docstring): K2 on a probe past three chunks, K1 at a
    long contraction, and the digit stack (reconstruct="xla") of K1 and K2.
    Returns the kernels line's rows."""
    import numpy as np
    import torch

    from repro_torch import ozmm, prepare_operand
    from repro_torch.core import crt, numerics
    from repro_torch.core.scaling import compute_scaling
    from repro_torch.kernels import stack_parts
    from repro_torch.kernels.fused import (K_CHUNK, KERNEL_TILE, fused_parts_args,
                                           fused_raw_args, ops, ozmm_fused_parts,
                                           ozmm_fused_parts_ref, ozmm_fused_raw,
                                           ozmm_fused_raw_ref)
    from repro_torch.precision import parse_policy

    spec = "ozaki2-fp8/fast"
    ms = parse_policy(spec).moduli_set()
    products = 3 * ms.n
    rows = []

    # -- K2 on the probe patterns past three chunks, against int64 ----------
    k = PROBE_K
    a8, b8, want = probe_operands(k, dev, rows=KERNEL_TILE[0], cols=KERNEL_TILE[1])
    # row 4 of A and column 4 of B: +16 for the first k/2 + 1, then +1, so
    # their product ends odd past 2^24, where no f32 sum can hold it
    tail = torch.where(torch.arange(k, device=dev) <= k // 2, 16.0, 1.0).to(a8.dtype)
    a8.view(torch.uint8)[4] = tail.view(torch.uint8)
    b8.view(torch.uint8)[:, 4] = tail.view(torch.uint8)
    want = (a8.float().double() @ b8.float().double()).long()  # exact: |sums| < 2^53
    # parts whose residue is w * v: square moduli (v, v) (w = s + 1),
    # Karatsuba (v, 0, v) (w = 16)
    zeros = lambda x: torch.zeros_like(x.view(torch.uint8)).view(x.dtype)  # noqa: E731
    sa = stack_parts([(a8, a8) if sq else (a8, zeros(a8), a8) for sq in ms.is_square], ms)
    sb = stack_parts([(b8, b8) if sq else (b8, zeros(b8), b8) for sq in ms.is_square], ms)
    lmu = torch.zeros((KERNEL_TILE[0], 1), dtype=torch.int32, device=dev)
    lnu = torch.zeros((1, KERNEL_TILE[1]), dtype=torch.int32, device=dev)
    digits = ozmm_fused_parts(sa, sb, lmu, lnu, ms=ms, reconstruct="xla")
    check_equal(digits, ozmm_fused_parts_ref(sa, sb, lmu, lnu, ms=ms, reconstruct="xla"),
                f"K2 digits at k = {k} vs plain version")
    check_equal(ozmm_fused_parts(sa, sb, lmu, lnu, ms=ms),
                ozmm_fused_parts_ref(sa, sb, lmu, lnu, ms=ms), f"K2 at k = {k} vs plain version")
    cs = [numerics.centered_mod(want * (s + 1 if sq else 16) ** 2, p)
          for p, sq, s in zip(ms.ps, ms.is_square, ms.split_s)]
    check_equal(digits, crt.garner_digits(cs, ms).to(torch.int16),
                f"K2 digits at k = {k} vs the exact int64 residue products")
    f32 = numerics.matmul_exact_fp8(a8, b8)
    top = int(want.abs().max())
    check(top > 2 ** 24 and not torch.equal(f32.double(), want.double()),
          f"the probe at k = {k} does not take one f32 product past its exact range")
    print(f"  K2 probe k = {k} ({-(-k // K_CHUNK)} chunks of {K_CHUNK}; +16, +-16, +16 then +1 "
          f"parts, max |sum| {top} > 2^24): digits == plain == exact int64 residue products, C "
          f"== plain (bitwise); one f32 product over the whole k differs in "
          f"{int((f32.double() != want.double()).sum())} elements", flush=True)
    del a8, b8, want, sa, sb, digits, f32
    torch.cuda.empty_cache()

    # -- K1 at a long contraction, fast and accurate ---------------------------
    m, k, n = LONG_SHAPE
    a, b = lognormal(gen, (m, k), 0.5, dev), lognormal(gen, (k, n), 0.5, dev)
    gate_rows = list(range(0, m, m // LONG_GATE_ROWS))
    exact, denom = long_double_rows(a, b, gate_rows)
    dgemm_ms = cuda_ms(lambda: torch.matmul(a, b))
    for spec_l in ("ozaki2-fp8/fast", "ozaki2-fp8/accurate"):
        pol = parse_policy(spec_l)
        msl = pol.moduli_set()
        scal = compute_scaling(a, b, msl, pol.mode)
        fa = fused_raw_args(a, scal.lmu, b, scal.lnu, msl, KERNEL_TILE)
        got, plain = ozmm_fused_raw(*fa, ms=msl), ozmm_fused_raw_ref(*fa, ms=msl)
        check_equal(got, plain, f"{spec_l} K1 at {m}x{k}x{n} vs plain version")
        max_err = (got - plain).abs().max().item()
        del plain
        check_equal(ozmm(a, b, spec_l), got, f"{spec_l} ozmm at {m}x{k}x{n} vs K1")
        err = float(np.max(np.abs(got[gate_rows].cpu().numpy() - exact) / denom))
        gate = 2 * k * 2.0 ** -53
        check(err <= gate, f"{spec_l} K1 at {m}x{k}x{n}: componentwise error {err} > {gate}")
        ms_k1 = cuda_ms(lambda: ozmm_fused_raw(*fa, ms=msl))
        ms_plain = cuda_ms(lambda: ozmm_fused_raw_ref(*fa, ms=msl), 1)
        n_bytes = sum(t.numel() * t.element_size() for t in fa) + m * n * 8
        rows.append(k_row("ozmm_fused_raw", spec_l, (m, k, n), launches, max_err, ms_k1,
                          ms_plain, n_bytes, 3 * msl.n, dgemm_ms, componentwise_err=err))
        print(f"  {spec_l:20s} K1 {m}x{k}x{n} ({-(-k // K_CHUNK)} chunks): == plain == ozmm "
              f"(bitwise); componentwise error {err:.3e} of |A||B| (gate 2k 2^-53 = {gate:.3e}); "
              f"{ms_k1:.2f} ms, plain {ms_plain:.2f} ms, bound {rows[-1]['bound_ms']:.2f} ms "
              f"({rows[-1]['bound_by']}), cuBLAS DGEMM {dgemm_ms:.2f} ms", flush=True)
        del fa, got
        torch.cuda.empty_cache()
    del a, b
    torch.cuda.empty_cache()

    # -- the digit stack at the main-path size: K1 and K2 ----------------------
    big = args.size
    a, b = lognormal(gen, (big, big), 0.5, dev), lognormal(gen, (big, big), 0.5, dev)
    scal = compute_scaling(a, b, ms, "fast")
    qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
    fr = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
    fp = fused_parts_args(stack_parts(qa.parts, ms), qa.lscale, stack_parts(qb.parts, ms),
                          qb.lscale, ms, KERNEL_TILE)
    # (name, kernel, plain version, arguments, their tensors, lmu, lnu)
    cases = (("ozmm_fused_raw", ozmm_fused_raw, ozmm_fused_raw_ref, fr, fr, fr[3], fr[7]),
             ("ozmm_fused_parts", ozmm_fused_parts, ozmm_fused_parts_ref, fp,
              [*fp[0], *fp[1], fp[2], fp[3]], fp[2], fp[3]))
    for name, kern, plain, fa, ins, lmu, lnu in cases:
        lm, ln = lmu[:, 0], lnu[0]
        digits, want = kern(*fa, ms=ms, reconstruct="xla"), plain(*fa, ms=ms, reconstruct="xla")
        check_equal(digits, want, f"{name} digits at {big}^3 vs plain version")
        max_err = (digits.int() - want.int()).abs().max().item()
        del want
        onchip = kern(*fa, ms=ms)
        check_equal(crt.reconstruct(digits, ms, lm, ln), onchip,
                    f"{name} at {big}^3: C of the digits vs the on-chip epilogue")
        ms_x = cuda_ms(lambda: kern(*fa, ms=ms, reconstruct="xla"))
        ms_on = cuda_ms(lambda: kern(*fa, ms=ms))
        ms_plain = cuda_ms(lambda: plain(*fa, ms=ms, reconstruct="xla"), 1)
        n_bytes = sum(t.numel() * t.element_size() for t in ins) + 2 * ms.n * big * big
        rows.append(k_row(name, spec + " digits", (big, big, big), launches, max_err, ms_x,
                          ms_plain, n_bytes, products, None, onchip_ms=ms_on))
        print(f"  {spec} {name} reconstruct='xla' {big}^3: digits == plain, C of the digits "
              f"== on-chip C (bitwise); {ms_x:.2f} ms (on-chip epilogue {ms_on:.2f} ms), plain "
              f"{ms_plain:.2f} ms, bound {rows[-1]['bound_ms']:.2f} ms", flush=True)
        del digits, onchip
    check_equal(ops.ozmm_pallas_fused(a, b, family=ms.family, mode="fast", reconstruct="xla"),
                ozmm(a, b, spec), f"ozmm_pallas_fused reconstruct='xla' at {big}^3 vs ozmm")
    print(f"  ozmm_pallas_fused(reconstruct='xla') == ozmm (on-chip) at {big}^3 (bitwise)",
          flush=True)
    del a, b, qa, qb, fr, fp, cases
    torch.cuda.empty_cache()
    return rows


def unfused_phase(args, dev, gen) -> list[dict]:
    """Phase 8 (module docstring): the phase-split pipeline's kernels K3-K6
    against their plain versions and oracles, the '+pallas+unfused' path,
    and the timings. Returns the kernels line's rows of K3, K4, K5 and K6."""
    import numpy as np
    import torch

    from repro_torch import kernels as kn
    from repro_torch import linalg, ozmm, prepare_operand
    from repro_torch.core import crt, quantize, scaling
    from repro_torch.core.plan import pow2_tables
    from repro_torch.kernels import pipeline
    from repro_torch.kernels.fp8_gemm import ROUTES, max_k, reset_counts, residue_gemm_route
    from repro_torch.kernels.quant_residues import kernel as k6_module
    from repro_torch.kernels.quant_residues import ops as qr_ops
    from repro_torch.precision import parse_policy

    big = args.size
    # the path's kernels: K6 through its f64 entry, the GEMMs, K5 (f64 mode)
    kernels = (kn.quant_residues_f64, kn.fp8_gemm, kn.int8_gemm, kn.requant_garner)
    gemms = (kn.fp8_gemm, kn.int8_gemm)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def counts():
        return tuple(f.launches for f in kernels)

    def routes():
        """(K3 wgmma, K3 mma_sync, K4 wgmma, K4 mma_sync) launches and the
        B copies of both wrappers."""
        return (*(g.launches_by_route[r] for g in gemms for r in ROUTES),
                sum(g.b_copies for g in gemms))

    def stacks(x):
        return list(x) if isinstance(x, tuple) else [x]

    def frames(x, lscale, axis):
        return kn.decompose_int(quantize.scaled_int(x, lscale, axis))

    def first_pair(sa, sbt, ms, l):
        """The operands of modulus l's first product in the schedule: A's
        plane and B's, K-major (the transpose of B^T's plane)."""
        if ms.family == "int8":
            return sa[l], sbt[l].t()
        return (sa[0][l], sbt[1][l].t()) if ms.is_square[l] else (sa[0][l], sbt[0][l].t())

    def pairs_of(sa, sbt, ms, l):
        """Modulus l's products in the schedule (pipeline.residue_gemms)."""
        if ms.family == "int8":
            return [(sa[l], sbt[l].t())]
        qs = ((0, 1), (1, 0), (1, 1)) if ms.is_square[l] else ((0, 0), (1, 1), (2, 2))
        return [(sa[i][l], sbt[j][l].t()) for i, j in qs]

    # -- each kernel against its plain version (and oracles), four shapes --
    specs = ("ozaki2-fp8/fast", "ozaki2-karatsuba/fast", "ozaki2-int8/fast")
    for m, k, n in ((1024, 1024, 1024), (1000, 1024, 1003), (1000, 997, 1003), (big, big, big)):
        a, b = lognormal(gen, (m, k), 0.5, dev), lognormal(gen, (k, n), 0.5, dev)
        for spec in specs:
            ms = parse_policy(spec).moduli_set()
            scal = scaling.compute_scaling(a, b, ms, "fast")
            tables = pow2_tables(ms, dev)
            sides = []
            for what, x, lscale in (("A", a, scal.lmu), ("B^T", pipeline.k_major(b), scal.lnu)):
                got = kn.quant_residues_f64(x, lscale, tables, ms=ms)
                plain = kn.quant_residues_f64_plain(x, lscale, tables, ms=ms)
                fr = frames(x, lscale, 0)
                got_fr = kn.quant_residues(*fr, tables, ms=ms)
                plain_fr = kn.quant_residues_plain(*fr, tables, ms=ms)
                torch.cuda.synchronize()
                for i, (g, w, gf, wf) in enumerate(zip(*map(stacks, (got, plain, got_fr,
                                                                       plain_fr)))):
                    check_equal(as_bytes(g), as_bytes(w),
                                f"K6 f64 entry {spec} {m}x{k}x{n} {what} stack {i} vs plain")
                    check_equal(as_bytes(gf), as_bytes(wf),
                                f"K6 frame entry {spec} {m}x{k}x{n} {what} stack {i} vs plain")
                    check_equal(as_bytes(gf), as_bytes(g),
                                f"K6 {spec} {m}x{k}x{n} {what} stack {i}: frame vs f64 entry")
                sides.append(got)
                del fr, plain, got_fr, plain_fr
            sa, sbt = sides
            # B's parts from B^T are B's parts (per-column exponents) transposed
            by_col = kn.quant_residues_f64(b, scal.lnu, tables, ms=ms, axis=1)
            for i, (g, w) in enumerate(zip(stacks(sbt), stacks(by_col))):
                check_equal(as_bytes(g), as_bytes(w.transpose(1, 2).contiguous()),
                            f"K6 {spec} {m}x{k}x{n}: B^T's stack {i} vs B's transposed")
            del by_col
            gemm = "K4" if ms.family == "int8" else "K3"
            route = residue_gemm_route(k, 0, 0)
            before = routes()
            cparts = pipeline.residue_gemms(sa, sbt, ms)
            moved = tuple(x - y for x, y in zip(routes(), before))
            per_call = ms.n if ms.family == "int8" else 3 * ms.n
            col = (2 if ms.family == "int8" else 0) + ROUTES.index(route)
            check(moved[col] == per_call and sum(moved[:4]) == per_call and moved[4] == 0,
                  f"{gemm} {spec} {m}x{k}x{n}: (K3 wgmma, K3 mma_sync, K4 wgmma, K4 mma_sync, "
                  f"B copies) moved {moved}, predicted {per_call} on {route} and no copy")
            with Swapped(pipeline, "int8_gemm", kn.int8_gemm_plain), \
                    Swapped(pipeline, "fp8_gemm", kn.fp8_gemm_plain):
                cplain = pipeline.residue_gemms(sa, sbt, ms)
            for i, (g, w) in enumerate(zip(cparts, cplain)):
                check_equal(g, w, f"{gemm} {spec} {m}x{k}x{n}: products c{i + 1} vs plain version")
            del cplain
            kern = kn.int8_gemm if ms.family == "int8" else kn.fp8_gemm
            routes_done = route
            if route == "wgmma":  # modulus 0's products again, on the mma_sync route
                for i, (x, y) in enumerate(pairs_of(sa, sbt, ms, 0)):
                    xm = misaligned(x)
                    check(residue_gemm_route(k, xm.data_ptr(), y.t().data_ptr()) == "mma_sync",
                          "a misaligned A did not select the mma_sync route")
                    check_equal(kern(xm, y), cparts[i][0],
                                f"{gemm} {spec} {m}x{k}x{n}: modulus 0 product {i} on the "
                                "mma_sync route vs the wgmma route (== plain version)")
                    del xm
                routes_done = "wgmma + mma_sync"
            x, y = first_pair(sa, sbt, ms, 0)
            if ms.family == "int8" and m > 16 and k % 8 == 0 and n % 8 == 0:
                check_equal(cparts[0][0], torch._int_mm(x, y.contiguous()),
                            f"K4 {m}x{k}x{n} vs torch._int_mm")
                oracle = "torch._int_mm"
            elif ms.family != "int8" and m % 16 == 0 and k % 16 == 0 and n % 16 == 0:
                lib = torch._scaled_mm(x, y, scale_a=one, scale_b=one, out_dtype=torch.float32,
                                       use_fast_accum=False)
                check_equal(cparts[0][0], lib, f"K3 {spec} {m}x{k}x{n} vs torch._scaled_mm")
                oracle = "torch._scaled_mm"
            else:
                oracle = "no oracle (shape)"
            digits = kn.requant_garner(cparts, ms=ms)
            check_equal(digits, kn.requant_garner_plain(cparts, ms=ms),
                        f"K5 digits mode {spec} {m}x{k}x{n} vs plain version")
            c = kn.requant_garner(cparts, ms=ms, lmu=scal.lmu, lnu=scal.lnu)
            check_equal(c, kn.requant_garner_plain(cparts, ms=ms, lmu=scal.lmu, lnu=scal.lnu),
                        f"K5 f64 mode {spec} {m}x{k}x{n} vs plain version")
            torch.cuda.synchronize()
            print(f"  {spec:24s} {m}x{k}x{n}: K6 f64 and frame entries (A and B^T; B^T's == "
                  f"B's by columns, transposed), {gemm} ({len(cparts)} x {ms.n} planes, "
                  f"{routes_done}), K5 digits and f64 modes == plain versions (bitwise); "
                  f"{gemm} plane 0 == {oracle}", flush=True)
            del sa, sbt, sides, cparts, digits, c, x, y
            torch.cuda.empty_cache()
        del a, b
        torch.cuda.empty_cache()

    # -- K6 on edge inputs: both entries against the plain versions ----------
    for spec in (*specs, "ozaki2-fp8/fast@20"):
        ms = parse_policy(spec).moduli_set()
        tables = pow2_tables(ms, dev)
        for k in (301, 304):  # the scalar path, the 16-byte path
            x, lscale = edge_matrix(np.random.default_rng(args.seed + 4), k, dev)
            want = kn.quant_residues_f64_plain(x, lscale, tables, ms=ms)
            got = kn.quant_residues_f64(x, lscale, tables, ms=ms)
            got_fr = kn.quant_residues(*frames(x, lscale, 0), tables, ms=ms)
            for i, (g, gf, w) in enumerate(zip(*map(stacks, (got, got_fr, want)))):
                check_equal(as_bytes(g), as_bytes(w), f"K6 f64 entry {spec} edge matrix "
                                                      f"k={k} stack {i} vs plain version")
                check_equal(as_bytes(gf), as_bytes(w), f"K6 frame entry {spec} edge matrix "
                                                       f"k={k} stack {i} vs plain version")
    print(f"  K6 edge matrix (zeros, signs, subnormals, 1e+-300, +-(2^53 - 1), f64 max, "
          f"lscale up to 1100) at k = 301 and 304: both entries == plain versions for "
          f"{len(specs) + 1} policies", flush=True)

    # -- the bound GEMM under the global TF32 switch --------------------------
    a, b = lognormal(gen, (1024, 1024), 0.5, dev), lognormal(gen, (1024, 1024), 0.5, dev)
    ms = parse_policy("ozaki2-fp8/accurate").moduli_set()
    switch = torch.backends.cuda.matmul
    prev, exps = switch.allow_tf32, {}
    try:
        for on in (False, True):
            switch.allow_tf32 = on
            exps[on] = scaling.compute_scaling(a, b, ms, "accurate")
            check(switch.allow_tf32 == on, "the bound GEMM left the TF32 switch changed")
    finally:
        switch.allow_tf32 = prev
    check(torch.equal(exps[True].lmu, exps[False].lmu)
          and torch.equal(exps[True].lnu, exps[False].lnu),
          "accurate scaling's exponents at 1024^3 change with the global TF32 switch")
    print("  accurate scaling 1024^3: lmu, lnu equal with the global TF32 switch on and off",
          flush=True)
    del a, b

    # -- K3's exactness at k = 65536, both routes --------------------------
    a8, b8, want = probe_operands(65536, dev)
    bt8 = b8.t().contiguous()
    for route, x in (("wgmma", a8), ("mma_sync", misaligned(a8))):
        before = kn.fp8_gemm.launches_by_route[route]
        got = kn.fp8_gemm(x, bt8.t())
        check(kn.fp8_gemm.launches_by_route[route] == before + 1,
              f"K3 at k = 65536 did not take the {route} route")
        check(torch.equal(got.cpu().long(), want),
              f"K3 at k = 65536 on the {route} route: not the exact int64 product")
    print(f"  K3 k = 65536 (+-16, +16 then +1, max |sum| {int(want.abs().max())}): exact on both "
          "routes", flush=True)
    del a8, b8, bt8

    # -- K4's exactness at its limit k = 2^17, both routes ------------------
    k4_limit = max_k(torch.int8)
    a8, b8, want = probe_operands(k4_limit, dev, big=127)
    bt8 = b8.t().contiguous()
    for route, x in (("wgmma", a8), ("mma_sync", misaligned(a8))):
        before = kn.int8_gemm.launches_by_route[route]
        got = kn.int8_gemm(x, bt8.t())
        check(kn.int8_gemm.launches_by_route[route] == before + 1,
              f"K4 at k = 2^17 did not take the {route} route")
        check(torch.equal(got.cpu().long(), want),
              f"K4 at k = 2^17 on the {route} route: not the exact int64 product")
    print(f"  K4 k = {k4_limit} (+-127, +127 then +1, max |sum| {int(want.abs().max())} "
          f"< 2^31): exact on both routes", flush=True)
    del a8, b8, bt8

    # -- the main path: ozmm(..., "+pallas+unfused") for the four policies --
    a, b = lognormal(gen, (big, big), 0.5, dev), lognormal(gen, (big, big), 0.5, dev)
    kn.quant_residues_f64.launches = kn.quant_residues.launches = 0
    kn.requant_garner.launches = 0
    for g in gemms:
        reset_counts(g)
    out = {spec: ozmm(a, b, spec + UNFUSED) for spec in POLICIES}
    torch.cuda.synchronize()
    main_launches, main_routes = counts(), routes()
    mss = [parse_policy(spec).moduli_set() for spec in POLICIES]
    want = (2 * len(POLICIES), sum(3 * ms.n for ms in mss if ms.family != "int8"),
            sum(ms.n for ms in mss if ms.family == "int8"), len(POLICIES))
    route = residue_gemm_route(big, 0, 0)
    want_routes = tuple(want[1 + i // 2] if ROUTES[i % 2] == route else 0
                        for i in range(4)) + (0,)
    check(kn.quant_residues.launches == 0, "the main path launched K6's frame entry")
    print(f"  main path: (K6, K3, K4, K5) launches {main_launches} for {len(POLICIES)} ozmm "
          f"calls, predicted {want}; (K3 wgmma, K3 mma_sync, K4 wgmma, K4 mma_sync, B copies) "
          f"{main_routes}, predicted {want_routes}", flush=True)
    check(main_launches == want, f"unfused main path: (K6, K3, K4, K5) launches "
                                 f"{main_launches}, predicted {want}")
    check(main_routes == want_routes, f"unfused main path: routes and B copies {main_routes}, "
                                      f"predicted {want_routes}")
    dgemm = torch.matmul(a, b)
    for spec, c in out.items():
        check(c.shape == (big, big) and bool(torch.isfinite(c).all()),
              f"{spec}{UNFUSED}: output not finite or of the wrong shape")
        err = (torch.linalg.norm(c - dgemm) / torch.linalg.norm(dgemm)).item()
        check(err <= 2.0 ** -44, f"{spec}{UNFUSED}: normwise error {err} > 2^-44")
        check_equal(c, ozmm(a, b, spec + "+core"), f"{spec} {big}^3: {UNFUSED} vs +core")
        check_equal(c, ozmm(a, b, spec + "+pallas"), f"{spec} {big}^3: {UNFUSED} vs +pallas (K1)")
        print(f"  {spec:24s} {big}^3: {UNFUSED} == +core == +pallas (bitwise); normwise "
              f"error vs cuBLAS DGEMM {err:.3e} (gate 2^-44)", flush=True)
    del out, dgemm
    torch.cuda.empty_cache()

    # -- prepared pairings and the LU on +pallas+unfused ----------------------
    for spec in ("ozaki2-fp8/fast", "ozaki2-fp8/accurate"):
        ms = parse_policy(spec).moduli_set()
        qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
        before, copies = counts(), routes()[4]
        got = ozmm(qa, qb, spec + UNFUSED)
        moved = tuple(x - y for x, y in zip(counts(), before))
        predicted = (0 if spec.endswith("fast") else 2, 3 * ms.n, 0, 1)
        check(moved == predicted, f"{spec} prepared {UNFUSED}: launches {moved}, "
                                  f"predicted {predicted}")
        check(routes()[4] == copies, f"{spec} prepared {UNFUSED}: a GEMM wrapper copied B")
        check_equal(got, ozmm(qa, qb, spec + "+core"), f"{spec} prepared {big}^3: "
                                                       f"{UNFUSED} vs +core")
        print(f"  {spec:24s} prepared {big}^3: {UNFUSED} == +core (bitwise), launches "
              f"{moved}", flush=True)
        del qa, qb, got
        torch.cuda.empty_cache()
    a1, b1 = linalg.hpl_matrix(1024, seed=args.seed + 2)
    nb1 = 1024 // HPL_BLOCK
    pairings = (nb1 - 1) + nb1 * (nb1 - 1)  # trailing updates + the solve's folds
    for spec in ("ozaki2-fp8/fast", "ozaki2-fp8/accurate"):
        ms = parse_policy(spec).moduli_set()
        before, before_routes = counts(), routes()
        lu_k, perm_k = linalg.lu_factor(a1, spec + UNFUSED, block=HPL_BLOCK)
        x_k = linalg.lu_solve(lu_k, perm_k, b1, spec + UNFUSED, block=HPL_BLOCK)
        moved = tuple(x - y for x, y in zip(counts(), before))
        moved_routes = tuple(x - y for x, y in zip(routes(), before_routes))
        check(moved_routes[4] == 0, f"LU n=1024 {spec}{UNFUSED}: a GEMM wrapper copied B")
        quant = 0 if spec.endswith("fast") else 2 * pairings
        predicted = (quant, 3 * ms.n * pairings, 0, pairings)
        check(moved == predicted, f"LU n=1024 {spec}{UNFUSED}: launches {moved}, "
                                  f"predicted {predicted}")
        lu_c, perm_c = linalg.lu_factor(a1, spec + "+core", block=HPL_BLOCK)
        x_c = linalg.lu_solve(lu_c, perm_c, b1, spec + "+core", block=HPL_BLOCK)
        check(np.array_equal(perm_k, perm_c) and np.array_equal(lu_k, lu_c),
              f"LU n=1024 {spec}: {UNFUSED} and +core factorizations differ")
        check(np.array_equal(x_k, x_c), f"LU n=1024 {spec}: {UNFUSED} and +core solves differ")
        print(f"  LU n=1024 {spec}: {UNFUSED} ((K6, K3, K4, K5) launches {moved}; K3 "
              f"(wgmma, mma_sync) {moved_routes[:2]}, no B copied) == +core, factorization and "
              "solve (bitwise)", flush=True)

    # -- timings at the main-path size --------------------------------------
    rows, detail = [], []
    mnk = big ** 3
    for spec in ("ozaki2-fp8/fast", "ozaki2-int8/fast"):
        ms = parse_policy(spec).moduli_set()
        int8 = ms.family == "int8"
        scal = scaling.compute_scaling(a, b, ms, "fast")
        tables = pow2_tables(ms, dev)
        fr = frames(a, scal.lmu, 0)
        sa = kn.quant_residues_f64(a, scal.lmu, tables, ms=ms)
        sbt = qr_ops.quant_residues_op(pipeline.k_major(b), scal.lnu, ms=ms, axis=0)
        x, y = first_pair(sa, sbt, ms, 0)  # y: B's plane, K-major as the pipeline hands it
        xm = misaligned(x)
        plane = torch.empty((big, big), dtype=torch.int32 if int8 else torch.float32, device=dev)
        cparts = pipeline.residue_gemms(sa, sbt, ms)
        n_out = ms.n if int8 else 3 * ms.n  # K6's part stacks = K5's product planes
        gemm_kern = kn.int8_gemm if int8 else kn.fp8_gemm
        gemm_plain = kn.int8_gemm_plain if int8 else kn.fp8_gemm_plain
        if int8:
            yc = y.contiguous()
            gemm_lib = lambda: torch._int_mm(x, yc)  # noqa: E731
        else:
            gemm_lib = lambda: torch._scaled_mm(x, y, scale_a=one, scale_b=one,  # noqa: E731
                                                out_dtype=torch.float32, use_fast_accum=False)
        k6_src = ("src/repro_torch/csrc/quant_residues.cu",
                  "src/repro/kernels/quant_residues/kernel.py:77")
        k5_src = ("src/repro_torch/csrc/requant_garner.cu",
                  "src/repro/kernels/crt_reconstruct/kernel.py:71")
        lmu, lnu = scal.lmu, scal.lnu
        cases = [  # the f64 entry / f64 mode is the path's; the others beside it
            ("quant_residues", "K6", *k6_src, main_launches[0],
             lambda: kn.quant_residues_f64(a, lmu, tables, ms=ms),
             lambda: kn.quant_residues_f64_plain(a, lmu, tables, ms=ms), None,
             (8 + n_out) * big * big + 4 * big + 4 * ms.n * 1024, 0),
            ("quant_residues", "K6-frame", *k6_src, 0,
             lambda: kn.quant_residues(*fr, tables, ms=ms),
             lambda: kn.quant_residues_plain(*fr, tables, ms=ms), None,
             (12 + n_out) * big * big + 4 * ms.n * 1024, 0),
            ("int8_gemm" if int8 else "fp8_gemm", "K4" if int8 else "K3",
             "src/repro_torch/csrc/residue_gemm.cu",
             "src/repro/kernels/int8_gemm/kernel.py:25" if int8
             else "src/repro/kernels/fp8_gemm/kernel.py:34",
             main_launches[2] if int8 else main_launches[1],
             lambda: gemm_kern(x, y, out=plane), lambda: gemm_plain(x, y), gemm_lib,
             2 * big * big + 4 * big * big, 2 * mnk),
            ("requant_garner", "K5", *k5_src, main_launches[3],
             lambda: kn.requant_garner(cparts, ms=ms, lmu=lmu, lnu=lnu),
             lambda: kn.requant_garner_plain(cparts, ms=ms, lmu=lmu, lnu=lnu), None,
             (n_out * 4 + 8) * big * big + 8 * big, 0),
            ("requant_garner", "K5-digits", *k5_src, 0,
             lambda: kn.requant_garner(cparts, ms=ms),
             lambda: kn.requant_garner_plain(cparts, ms=ms), None,
             n_out * 4 * big * big + ms.n * 2 * big * big, 0),
        ]
        for name, tag, source, replaces, launches, kern, plain, lib, n_bytes, n_ops in cases:
            got, ref = kern(), plain()
            err = max(max_abs_err(g, r) for g, r in zip(stacks(got), stacks(ref)))
            del got, ref
            torch.cuda.empty_cache()
            ms_k = cuda_ms(kern)
            ms_p = cuda_ms(plain)
            torch.cuda.empty_cache()
            ms_l = cuda_ms(lib) if lib else None
            t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
            t_ops = n_ops / H100_FP8_OPS_PER_S * 1e3
            row = {"name": name, "tag": tag, "policy": spec, "shape": [big, big, big],
                   "num_moduli": ms.n, "route": "cuda", "source": source, "replaces": replaces,
                   "launches": launches, "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes > t_ops else "operations", "library_ms": ms_l}
            if tag in ("K3", "K4"):  # the same product on the mma_sync route
                row["mma_sync_ms"] = cuda_ms(lambda: gemm_kern(xm, y, out=plane))
            detail.append(row)
            lib_txt = f"{ms_l:.3f} ms" if ms_l is not None else "none"
            if "mma_sync_ms" in row:
                lib_txt += f", mma_sync route {row['mma_sync_ms']:.3f} ms"
            print(f"  {tag:9s} {name:15s} {spec:18s} kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
                  f"library {lib_txt}, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
                  f"launches {launches}, max|kernel-plain| {err}", flush=True)
        del fr, sa, sbt, x, xm, y, plane, cparts
        torch.cuda.empty_cache()
    check(all(r["max_abs_err"] == 0.0 for r in detail), "a K3-K6 kernel and its plain version "
                                                          "differ")
    check(all(r["launches"] > 0 for r in detail if r["tag"] in ("K3", "K4", "K5", "K6")),
          "a kernel of the unfused main path was never launched on it")
    for tag in ("K3", "K4", "K5", "K6"):
        rows.append(next(r for r in detail if r["tag"] == tag))

    # -- one ozmm call split by layer ----------------------------------------
    split = []
    for spec in ("ozaki2-fp8/accurate", "ozaki2-int8/fast"):
        total = cuda_ms(lambda: ozmm(a, b, spec + UNFUSED), 3)
        # the PyTorch passes the card's route no longer runs (the frame, the
        # epilogue) are wrapped where the plain versions would call them
        with CallTotals(scaling, "compute_scaling") as t_scal, \
                CallTotals(pipeline, "k_major") as t_bt, \
                CallTotals(quantize, "scaled_int") as t_int, \
                CallTotals(k6_module, "decompose_int") as t_dec, \
                CallTotals(qr_ops, "quant_residues_f64") as t_k6, \
                CallTotals(pipeline, "fp8_gemm") as t_k3, \
                CallTotals(pipeline, "int8_gemm") as t_k4, \
                CallTotals(pipeline, "requant_garner") as t_k5, \
                CallTotals(crt, "reconstruct") as t_epi:
            ozmm(a, b, spec + UNFUSED)
            torch.cuda.synchronize()
        layers = {"scaling": t_scal, "bt_copy": t_bt, "scaled_int": t_int,
                  "decompose_int": t_dec, "K6": t_k6, "K3": t_k3, "K4": t_k4, "K5": t_k5,
                  "epilogue": t_epi}
        entry = {"policy": spec + UNFUSED, "shape": [big, big, big], "ozmm_ms": total,
                 **{f"{k}_ms": v.seconds() * 1e3 for k, v in layers.items()},
                 **{f"{k}_calls": len(v.spans) for k, v in layers.items()}}
        split.append(entry)
        print(f"  {spec}{UNFUSED} {big}^3: ozmm {total:.2f} ms = " + " + ".join(
            f"{k} {entry[f'{k}_ms']:.2f} ({entry[f'{k}_calls']})" for k in layers)
            + " + rest [ms (calls)]", flush=True)
        check(t_int.spans == t_dec.spans == t_epi.spans == [],
              f"{spec}{UNFUSED}: the card's route called scaled_int, decompose_int or "
              "crt.reconstruct")
    del a, b
    torch.cuda.empty_cache()
    print(json.dumps({"unfused_kernels": detail, "unfused_split": split}))
    return [{k: v for k, v in r.items() if k not in ("tag",)} for r in rows], split


def normwise(x, ref) -> float:
    """||x - ref||_F / ||ref||_F."""
    import torch

    return (torch.linalg.norm(x - ref) / torch.linalg.norm(ref)).item()


def autograd_phase(args, dev, gen, fused_rows, unfused_split) -> dict:
    """Phase 9 (module docstring): gradients through ozmm on the kernel
    route and through the '+core' VJP, Ozaki-I, the perf model's predictions
    beside the measured rates, and the obs layer on the card."""
    import tempfile

    import torch

    from repro_torch import kernels as kn
    from repro_torch import obs, ozmm
    from repro_torch.core import perf_model
    from repro_torch.core.moduli import DEFAULT_NUM_MODULI
    from repro_torch.core.ozaki1 import num_matmuls
    from repro_torch.core import numerics
    from repro_torch.kernels import common, pipeline
    from repro_torch.kernels.fp8_gemm import reset_counts
    from repro_torch.kernels.fused import (ops, ozmm_fused_parts, ozmm_fused_raw, raw_parts,
                                           transpose_parts)
    from repro_torch.obs import health
    from repro_torch.obs.export import validate_chrome_trace
    from repro_torch.precision import parse_policy

    big = args.size
    n1, nb, n2 = min(1024, big), min(2048, big), min(2048, big)  # the +core VJP, batch, obs
    mnk = big ** 3
    kernels = {"K1": ozmm_fused_raw, "K1-prologue": raw_parts, "K2": ozmm_fused_parts,
               "K2-transpose": transpose_parts, "K6": kn.quant_residues_f64,
               "K6-frame": kn.quant_residues, "K3": kn.fp8_gemm, "K4": kn.int8_gemm,
               "K5": kn.requant_garner}
    glue = {"row_major": common.row_major, "k_major": common.k_major}

    def zero_counts():
        for f in kernels.values():
            f.launches = 0
        for f in glue.values():
            f.copies = 0
        for g in (kn.fp8_gemm, kn.int8_gemm):
            reset_counts(g)

    def read_counts():
        return {tag: f.launches for tag, f in kernels.items()}

    def predicted(spec):
        """Launches of one forward + backward (3 unprepared emulated GEMMs)."""
        ms = parse_policy(spec).moduli_set()
        want = dict.fromkeys(kernels, 0)
        if not spec.endswith("+unfused"):
            want.update({"K1": 3, "K1-prologue": 6})
        elif ms.family == "int8":
            want.update({"K6": 6, "K4": 3 * ms.n, "K5": 3})
        else:
            want.update({"K6": 6, "K3": 9 * ms.n, "K5": 3})
        return want

    def loss_backward(a, b, g, spec):
        ta, tb = a.detach().requires_grad_(), b.detach().requires_grad_()
        (ozmm(ta, tb, spec) * g).sum().backward()
        return ta.grad, tb.grad

    out = {"grad": [], "core_vjp": [], "ozaki1": [], "perf_model": []}
    a, b = lognormal(gen, (big, big), 0.5, dev), lognormal(gen, (big, big), 0.5, dev)
    g = torch.randn((big, big), generator=gen, device=dev, dtype=torch.float64)
    ref_ga, ref_gb = g @ b.T, a.T @ g  # cuBLAS DGEMM, a yardstick the port never calls

    # -- autograd on the kernel route at the main-path size -------------------
    for spec in ("ozaki2-fp8/accurate", "ozaki2-fp8/fast", "ozaki2-int8/fast",
                 "ozaki2-fp8/accurate+unfused", "ozaki2-int8/fast+unfused"):
        core = spec.removesuffix("+unfused") + "+core"
        zero_counts()
        with CallTotals(pipeline, "k_major") as t_bt, CallTotals(pipeline, "row_major") as t_ra, \
                CallTotals(ops, "row_major") as t_rf:
            ga, gb = loss_backward(a, b, g, spec)
            torch.cuda.synchronize()
        moved, want = read_counts(), predicted(spec)
        copies = (kn.fp8_gemm.b_copies, kn.int8_gemm.b_copies)
        made = {tag: f.copies for tag, f in glue.items()}
        copies_ms = (t_bt.seconds() + t_ra.seconds() + t_rf.seconds()) * 1e3
        print(f"  grad {spec:28s} {big}^3: launches {moved}, predicted {want}; GEMM-wrapper B "
              f"copies {copies}; glue f64 copies made {made} in "
              f"{len(t_bt.spans) + len(t_ra.spans) + len(t_rf.spans)} calls of k_major and "
              f"row_major ({copies_ms:.2f} ms)", flush=True)
        check(moved == want, f"grad {spec}: launches {moved}, predicted {want}")
        check(copies == (0, 0), f"grad {spec}: a GEMM wrapper copied B")
        check_equal(ga, ozmm(g, b.T, core), f"grad {spec} {big}^3: A.grad vs ozmm(G, B^T, +core)")
        check_equal(gb, ozmm(a.T, g, core), f"grad {spec} {big}^3: B.grad vs ozmm(A^T, G, +core)")
        err_a, err_b = normwise(ga, ref_ga), normwise(gb, ref_gb)
        check(max(err_a, err_b) <= 2.0 ** -44,
              f"grad {spec}: normwise error vs cuBLAS DGEMM ({err_a}, {err_b}) > 2^-44")
        del ga, gb
        torch.cuda.empty_cache()
        fwd = cuda_ms(lambda: ozmm(a, b, spec))
        fwd_bwd = cuda_ms(lambda: loss_backward(a, b, g, spec))
        torch.cuda.empty_cache()
        out["grad"].append({"policy": spec, "shape": [big, big, big], "launches": moved,
                            "err_a": err_a, "err_b": err_b, "forward_ms": fwd,
                            "forward_backward_ms": fwd_bwd, "glue_copies": made,
                            "k_major_calls": len(t_bt.spans),
                            "row_major_calls": len(t_ra.spans) + len(t_rf.spans),
                            "copies_ms": copies_ms})
        print(f"  grad {spec:28s} == +core cotangent GEMMs (bitwise); normwise error vs cuBLAS "
              f"DGEMM dA {err_a:.3e}, dB {err_b:.3e} (gate 2^-44); forward {fwd:.2f} ms, "
              f"forward+backward {fwd_bwd:.2f} ms ({fwd_bwd / fwd:.2f}x)", flush=True)
    del ref_ga, ref_gb

    # -- the plan-reusing '+core' VJP, the '+pallas' refusal, a batch ---------
    a1, b1 = lognormal(gen, (n1, n1), 0.5, dev), lognormal(gen, (n1, n1), 0.5, dev)
    g1 = torch.randn((n1, n1), generator=gen, device=dev, dtype=torch.float64)
    for mode in ("fast", "accurate"):
        spec = f"ozaki2-fp8/{mode}+core"
        zero_counts()
        ga, gb = loss_backward(a1, b1, g1, spec)
        check(sum(read_counts().values()) == 0, f"grad {spec} launched a kernel")
        err = max(normwise(ga, g1 @ b1.T), normwise(gb, a1.T @ g1))
        check(err <= 2.0 ** -44, f"grad {spec} {n1}^3: normwise error {err} > 2^-44")
        same = (torch.equal(ga, ozmm(g1, b1.T, spec)), torch.equal(gb, ozmm(a1.T, g1, spec)))
        out["core_vjp"].append({"policy": spec, "n": n1, "err": err,
                                "equals_unprepared": same})
        print(f"  grad {spec} {n1}^3 (the plan-reusing VJP): normwise error {err:.3e} (gate "
              f"2^-44); (dA, dB) bitwise equal to the unprepared products: {same}", flush=True)
    ta = a1.detach().requires_grad_()
    try:
        ozmm(ta, b1, "ozaki2-fp8/accurate+pallas").sum().backward()
        raise SmokeFailure("an explicit '+pallas' gradient did not raise")
    except NotImplementedError as exc:
        check("backend='pallas' is forward-only — ozmm_pallas_fused has no VJP "
              "(serving/inference)" in str(exc), f"'+pallas' gradient raised {exc}")
        print(f"  grad ozaki2-fp8/accurate+pallas: raises NotImplementedError: {exc}", flush=True)
    a3, b3 = (lognormal(gen, (3, nb, nb), 0.5, dev) for _ in range(2))
    g3 = torch.randn((3, nb, nb), generator=gen, device=dev, dtype=torch.float64)
    zero_counts()
    ga, gb = loss_backward(a3, b3, g3, "ozaki2-fp8/accurate")
    torch.cuda.synchronize()
    batch_k1 = ozmm_fused_raw.launches
    check(batch_k1 == 9, f"batched grad: {batch_k1} K1 launches, predicted 9")
    err = max(normwise(ga, g3 @ b3.transpose(1, 2)), normwise(gb, a3.transpose(1, 2) @ g3))
    check(err <= 2.0 ** -44, f"batched grad (3, {nb}, {nb}): normwise error {err} > 2^-44")
    out["batched"] = {"shape": [3, nb, nb], "k1_launches": batch_k1, "err": err}
    print(f"  grad ozaki2-fp8/accurate batched (3, {nb}, {nb}): {batch_k1} K1 launches, "
          f"normwise error {err:.3e} (gate 2^-44)", flush=True)
    del a1, b1, g1, a3, b3, g3, ga, gb, ta
    torch.cuda.empty_cache()

    # -- Ozaki-I at the main-path size ------------------------------------------
    dgemm = a @ b
    fwd = {r["policy"]: r["forward_ms"] for r in out["grad"]}
    for mode, gate in (("accurate", 2.0 ** -44), ("fast", 2.0 ** -40)):
        spec = f"ozaki1-fp8/{mode}@11"
        c = ozmm(a, b, spec)
        check(c.shape == (big, big) and bool(torch.isfinite(c).all()), f"{spec}: not finite")
        err = normwise(c, dgemm)
        check(err <= gate, f"{spec}: normwise error {err} > {gate}")
        check_equal(c, ozmm(a, b, spec), f"{spec}: a rerun changed bits")
        del c
        t = cuda_ms(lambda: ozmm(a, b, spec), 3)
        products = num_matmuls(11, mode)
        out["ozaki1"].append({"policy": spec, "shape": [big, big, big], "ms": t, "err": err,
                              "products": products})
        print(f"  {spec} {big}^3: {t:.1f} ms, {products} slice products, normwise error "
              f"{err:.3e} (gate {gate:.3e}), rerun bitwise; beside ozaki2-fp8/accurate fused "
              f"{fwd['ozaki2-fp8/accurate']:.2f} ms and +unfused "
              f"{fwd['ozaki2-fp8/accurate+unfused']:.2f} ms. Ozaki-I's products run as f32 "
              "GEMMs on the core executor, not on the FP8 tensor cores: this is not the "
              "paper's FP8-Ozaki-I speed", flush=True)
    del dgemm
    torch.cuda.empty_cache()

    # -- the Table-II perf model beside the measured rates ----------------------
    fused_ms = {r["policy"]: r["ozmm_ms"] for r in fused_rows}
    unfused_ms = {r["policy"].removesuffix(UNFUSED): r["ozmm_ms"] for r in unfused_split}
    for spec in POLICIES:
        pol = parse_policy(spec)
        num = DEFAULT_NUM_MODULI[pol.family]
        try:
            pred = perf_model.predict(pol.scheme, pol.mode, big, big, big, num,
                                      perf_model.H100_SXM_SHEET)
        except ValueError:  # Table II models the int8 and fp8-hybrid families only
            pred = None
        row = {"policy": spec, "num_moduli": num, "predicted_tflops": pred,
               "fused_tflops": 2 * mnk / fused_ms[spec] / 1e9,
               "unfused_tflops": (2 * mnk / unfused_ms[spec] / 1e9 if spec in unfused_ms
                                  else None)}
        out["perf_model"].append(row)
        unf = f"{row['unfused_tflops']:.2f}" if row["unfused_tflops"] else "not timed"
        prd = f"{pred:.2f}" if pred is not None else "not modeled (Table II: int8, fp8-hybrid)"
        print(f"  perf model {spec:22s} N={num} {big}^3 on H100_SXM_SHEET: predicted {prd} "
              f"TFLOP/s; measured fused {row['fused_tflops']:.2f}, +unfused {unf} TFLOP/s "
              "(2mnk / t, phases 5 and 8)", flush=True)

    # -- obs on the card --------------------------------------------------------
    spec = "ozaki2-fp8/accurate"
    a2, b2 = lognormal(gen, (n2, n2), 0.5, dev), lognormal(gen, (n2, n2), 0.5, dev)
    obs.enable_metrics()
    obs.reset_metrics()
    try:
        loss_backward(a2, b2, torch.ones_like(a2), spec)
        reg = obs.global_registry()
        calls, mma = reg.counter_total("gemm.calls"), reg.counter_total("gemm.mma_ops")
    finally:
        obs.disable_metrics()
        obs.reset_metrics()
    ms = parse_policy(spec).moduli_set()
    want_mma = 2.0 * n2 ** 3 * ms.num_lowprec_matmuls_accurate
    check(calls == 1.0, f"obs: gemm.calls {calls} for one forward+backward, predicted 1")
    check(mma == want_mma, f"obs: gemm.mma_ops {mma}, predicted {want_mma}")
    print(f"  obs {spec} {n2}^3 forward+backward: gemm.calls {calls:.0f}, gemm.mma_ops "
          f"{mma:.6e} = 2mnk x {ms.num_lowprec_matmuls_accurate} (Table II)", flush=True)
    a2_np, b2_np = a2.cpu().numpy(), b2.cpu().numpy()
    product, seen = numerics.matmul_exact_fp8, []

    def record(x, y):
        seen.append(x.device.type)
        return product(x, y)

    numerics.matmul_exact_fp8 = record
    try:
        t0 = time.perf_counter()
        probe = health.bound_gemm_probe(a2_np, b2_np)
        probe_s = time.perf_counter() - t0
        probe_cpu = health.bound_gemm_probe(a2_np, b2_np, device="cpu")
    finally:
        numerics.matmul_exact_fp8 = product
    # the bound GEMM's f32 sums of e4m3 products are inexact at k = 2048 and
    # cuBLAS and the CPU sum in different orders; the bound's inflation
    # (1 + k 2^-24) is its allowance for that, so both must bound the true
    # product and agree within it
    top = math.log2((a2 @ b2).abs().max().item())  # cuBLAS DGEMM, a yardstick
    allow = math.log2(1.0 + n2 * 2.0 ** -24)
    check(seen == ["cuda", "cpu"], f"obs: the probe's bound GEMMs ran on {seen}")
    check(min(probe, probe_cpu) >= top,
          f"obs: bound_gemm_probe ({probe}, {probe_cpu}) below log2 max|A @ B| {top}")
    check(abs(probe - probe_cpu) <= allow,
          f"obs: bound_gemm_probe {probe} on the card, {probe_cpu} on the CPU, "
          f"apart by more than log2(1 + k 2^-24) = {allow}")
    print(f"  obs bound_gemm_probe {n2}^3 (numpy operands): its bound GEMM on the card by "
          f"default ({probe_s * 1e3:.1f} ms host clock, copies in); log2 bound {probe!r}, "
          f"device='cpu' {probe_cpu!r} (apart {abs(probe - probe_cpu):.3e}, allowance "
          f"{allow:.3e}); log2 max|A @ B| {top!r}", flush=True)
    obs.enable_tracing()
    obs.clear_trace()
    try:
        ozmm(a, b, spec)  # warm-up
        event_ms = cuda_ms(lambda: ozmm(a, b, spec), 3)
        torch.cuda.synchronize()
        with obs.span("ozmm.fenced", policy=spec) as fenced:
            fenced.fence(ozmm(a, b, spec))
        with obs.span("ozmm.unfenced", policy=spec) as unfenced:
            ozmm(a, b, spec)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "trace.json")
            obs.write_chrome_trace(path)
            n_events = len(validate_chrome_trace(path)["traceEvents"])
    finally:
        obs.disable_tracing()
        obs.clear_trace()
    ratio, short = fenced.elapsed * 1e3 / event_ms, unfenced.elapsed / fenced.elapsed
    out["obs"] = {"gemm_calls": calls, "mma_ops": mma, "probe_log2": probe,
                  "probe_cpu_log2": probe_cpu, "event_ms": event_ms,
                  "fenced_ms": fenced.elapsed * 1e3, "unfenced_ms": unfenced.elapsed * 1e3,
                  "trace_events": n_events}
    print(f"  obs span {spec} {big}^3: fenced {fenced.elapsed * 1e3:.2f} ms, CUDA events "
          f"{event_ms:.2f} ms ({ratio:.3f}x); unfenced {unfenced.elapsed * 1e3:.2f} ms "
          f"({short:.3f} of fenced); Chrome trace of {n_events} events validates", flush=True)
    check(0.8 <= ratio <= 1.5, f"obs: fenced span {ratio:.3f}x the CUDA-event time")
    check(short <= 0.75, f"obs: the unfenced span reads {short:.3f} of the fenced one")
    del a, b, g, a2, b2
    torch.cuda.empty_cache()
    print(json.dumps({"autograd_phase": out}))
    return out


#: Phase 10: qwen2-7b at its published width (depth cut to --serve-layers),
#: four greedy requests with ragged prompts, on the default fast policy.
SERVE_ARCH = "qwen2-7b"
SERVE_POLICY = "ozaki2-fp8/fast"
SERVE_PROMPTS = (17, 32, 48, 64)
SERVE_NEW_TOKENS = 8
SERVE_PAGE = 16
#: Emulated GEMMs a layer makes (wq, wk, wv, wo, w_gate, w_up, w_down).
SERVE_GEMMS_PER_LAYER = 7
#: The smoke width's policies (backend auto) and the kernels each emulated
#: GEMM with a cached weight launches on the card, by counter name (N the
#: policy's moduli; K2's transpose turns a cached fast plan's B parts
#: K-major for K3/K4 as well).
SERVE_SMOKE_POLICIES = {
    "ozaki2-fp8/accurate": lambda n: {"K1": 1, "K1 prologue": 2},
    "ozaki2-fp8/fast+unfused": lambda n: {"K3": 3 * n, "K5": 1, "K2 transpose": 1},
    "ozaki2-fp8/accurate+unfused": lambda n: {"K6": 2, "K3": 3 * n, "K5": 1},
    "ozaki2-int8/fast+unfused": lambda n: {"K4": n, "K5": 1, "K2 transpose": 1},
}


class CheckFirstCallPerShape:
    """Wraps ``module.name`` while in the block; at its first call at each
    distinct set of input shapes the result is held bitwise against
    ``ref`` on the same arguments, right after the call (the arguments of a
    later check may not fit beside the run's). ``ref`` is a plain version,
    so the check launches no kernel."""

    def __init__(self, module, name: str, ref, what: str):
        self.module, self.name, self.ref, self.what, self.shapes = module, name, ref, what, []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def checked(*a, **kw):
            out = fn(*a, **kw)
            key = shapes_of(a)
            if key not in self.shapes:
                self.shapes.append(key)
                check_equal(out, self.ref(*a, **kw), f"{self.what} at input shapes {key}")
            return out

        setattr(self.module, self.name, checked)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def serve_counters():
    """The launch counters of the six kernels and of K1's prologue and K2's
    transpose, by name: (get, zero)."""
    from repro_torch import kernels as kn
    from repro_torch.kernels.fused import raw_parts, transpose_parts

    fns = {"K1": kn.ozmm_fused_raw, "K1 prologue": raw_parts, "K2": kn.ozmm_fused_parts,
           "K2 transpose": transpose_parts, "K3": kn.fp8_gemm, "K4": kn.int8_gemm,
           "K5": kn.requant_garner, "K6": kn.quant_residues_f64,
           "K6 frame entry": kn.quant_residues}

    def get():
        return {k: f.launches for k, f in fns.items()}

    def zero():
        for f in fns.values():
            f.launches = 0

    return get, zero


class ServeRecorder:
    """Records, per request, the logits row of every token an engine emits
    (a copy on the card), and counts the prefill waves and decode steps the
    model runs while in the block."""

    def __init__(self, engine):
        self.engine, self.rows, self.waves, self.steps = engine, {}, 0, 0

    def __enter__(self):
        from repro_torch.models import model as model_mod

        emit = self.engine._emit

        def record(slot, row):
            self.rows.setdefault(slot.req.request_id, []).append(row.detach().clone())
            return emit(slot, row)

        self.engine._emit = record
        cls = model_mod.Model
        self.orig = (cls.prefill_slots, cls.decode_slots, cls.prefill)
        pre, dec, pre_dense = self.orig

        def prefill_slots(*a, **kw):
            self.waves += 1
            return pre(*a, **kw)

        def decode_slots(*a, **kw):
            self.steps += 1
            return dec(*a, **kw)

        def prefill(*a, **kw):
            self.waves += 1
            return pre_dense(*a, **kw)

        cls.prefill_slots, cls.decode_slots, cls.prefill = prefill_slots, decode_slots, prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as model_mod

        del self.engine._emit
        self.engine = None  # the engine's weights and plans are not kept alive here
        cls = model_mod.Model
        cls.prefill_slots, cls.decode_slots, cls.prefill = self.orig


def timed_run(engine, prompts) -> dict:
    """The requests of ``prompts`` (SERVE_NEW_TOKENS each) through ``engine``,
    each engine step timed by the host clock up to a synchronize: TTFT, the
    first step (prefill waves and the first decode), the median decode
    step, tokens/s and the tokens."""
    import torch

    rids = [engine.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    step_ms = []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while len(engine.scheduler) or any(g.num_active for g in engine._groups.values()):
        ts = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    total = time.perf_counter() - t_run
    res = engine.results
    return {"ttft_ms": [res[r].ttft * 1e3 for r in rids],
            "first_step_ms": step_ms[0],
            "decode_ms": statistics.median(step_ms[1:]), "steps": len(step_ms),
            "tokens_per_s": len(rids) * SERVE_NEW_TOKENS / total, "seconds": total,
            "tokens": [res[r].tokens for r in rids]}


def k2_lm_head_row(qb, w, m: int, gen, dev, launches: int) -> dict:
    """The kernels line's row of K2 at a serving run's decode shape of
    lm_head: ``m`` rows (padded to the kernel's tile) times the cached plan
    ``qb`` of the weight ``w`` (d_model, padded vocab), bitwise against its
    plain version, timed (median of 5 after a warm-up) beside its plain
    version, its bound, cuBLAS DGEMM and its products through
    torch._scaled_mm."""
    import torch

    from repro_torch.core.plan import quantize_matrix
    from repro_torch.kernels import stack_parts
    from repro_torch.kernels.fused import (KERNEL_TILE, fused_parts_args, ozmm_fused_parts,
                                           ozmm_fused_parts_ref, transpose_parts)
    from repro_torch.precision import parse_policy

    ms_set = parse_policy(SERVE_POLICY).moduli_set()
    k, n = w.shape
    x_dec = torch.randn((m, k), generator=gen, device=dev, dtype=torch.float64)
    qa = quantize_matrix(x_dec, "lhs", ms_set, mode="fast")
    fa = fused_parts_args(stack_parts(qa.parts, ms_set), qa.lscale,
                          stack_parts(qb.parts, ms_set), qb.lscale, ms_set, KERNEL_TILE)
    got = ozmm_fused_parts(*fa, ms=ms_set)
    plain = ozmm_fused_parts_ref(*fa, ms=ms_set)
    max_err = (got - plain).abs().max().item()
    del got, plain
    ms_k2 = cuda_ms(lambda: ozmm_fused_parts(*fa, ms=ms_set))
    ms_plain = cuda_ms(lambda: ozmm_fused_parts_ref(*fa, ms=ms_set), 3)
    pbk = transpose_parts(fa[1], ms=ms_set)
    ms_products = cuda_ms(library_products(fa[0], pbk, fa[1], ms_set))
    del pbk, fa
    torch.cuda.empty_cache()
    w64 = w.to(torch.float64)
    ms_dgemm = cuda_ms(lambda: torch.matmul(x_dec, w64))
    del w64
    t_ops = 3 * ms_set.n * 2 * m * k * n / H100_FP8_OPS_PER_S * 1e3
    t_bytes = part_bytes(ms_set, m, k, n) / H100_BYTES_PER_S * 1e3
    row = {"name": "ozmm_fused_parts", "policy": SERVE_POLICY, "shape": [m, k, n],
           "padded_m": KERNEL_TILE[0], "route": "cuda",
           "source": "src/repro_torch/csrc/fused_parts.cu",
           "replaces": "src/repro/kernels/fused/kernel.py:265",
           "launches": launches, "max_abs_err": max_err, "ms": ms_k2,
           "plain_ms": ms_plain, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes > t_ops else "operations",
           "library_ms": ms_dgemm, "products_library_ms": ms_products}
    check(max_err == 0.0, f"K2 at the lm_head decode shape {m}x{k}x{n} differs from its "
                          "plain version")
    print(f"  K2 at lm_head's decode shape {m}x{k}x{n} (m padded to {KERNEL_TILE[0]}): "
          f"{ms_k2:.2f} ms, plain {ms_plain:.2f} ms, bound {max(t_ops, t_bytes):.2f} ms "
          f"({row['bound_by']}), cuBLAS DGEMM {ms_dgemm:.2f} ms, its {3 * ms_set.n} products "
          f"through torch._scaled_mm {ms_products:.2f} ms", flush=True)
    return row


def serve_phase(args, dev) -> dict:
    """Phase 10 (module docstring): qwen2-7b at its published width through
    repro_torch.serve on the card, then the smoke width under the other
    policies. Returns the kernels line's row of K2 at the serving path's
    decode shape and the phase's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gemm
    from repro_torch.kernels.fused import ops, ozmm_fused_parts_ref
    from repro_torch.kernels.fused import kernel as fused_kernel
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_mod
    from repro_torch.precision import parse_policy
    from repro_torch.serve import BatchingEngine, RequestStatus, ServeEngine

    get_counts, zero_counts = serve_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layers = args.serve_layers
    cfg = get_config(SERVE_ARCH, "full", num_layers=layers)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    max_len = -(-(max(SERVE_PROMPTS) + SERVE_NEW_TOKENS) // SERVE_PAGE) * SERVE_PAGE
    engine_kw = dict(max_len=max_len, max_slots=len(prompts), page_size=SERVE_PAGE)
    print(f"  {cfg.name} d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {layers} of 28 layers; "
          f"params {sum(p.numel() for p in params.parameters()) / 1e9:.3f} G elements", flush=True)

    # -- quantize the weights once, through the engine's cache --------------
    torch.cuda.synchronize()
    tq = time.perf_counter()
    eng = BatchingEngine(model, params, policy=SERVE_POLICY, **engine_kw)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - tq
    wcache = eng._base_group.weight_cache
    check(len(wcache) == SERVE_GEMMS_PER_LAYER * layers + 1,
          f"weight cache holds {len(wcache)} plans, predicted {SERVE_GEMMS_PER_LAYER * layers + 1}")
    cache_gb = wcache.nbytes() / 1e9
    print(f"  quantization {quant_s:.2f} s, {len(wcache)} plans, WeightResidueCache.nbytes() "
          f"{cache_gb:.3f} GB", flush=True)

    # -- the checked run: launches, each K2 shape vs its plain version -------
    per_wave = SERVE_GEMMS_PER_LAYER * layers + 1
    zero_counts()
    with ServeRecorder(eng) as rec, CheckFirstCallPerShape(
            ops, "ozmm_fused_parts", ozmm_fused_parts_ref, "serve K2 vs plain version") as k2c:
        rids = [eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
    counts = get_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rid in rids:
        r = results[rid]
        check(r.status is RequestStatus.FINISHED and len(r.tokens) == SERVE_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {rid}: {r.status}, tokens {r.tokens}")
    calls = rec.waves + rec.steps
    check((rec.waves, rec.steps) == (1, SERVE_NEW_TOKENS - 1),
          f"(prefill waves, decode steps) {(rec.waves, rec.steps)}, predicted "
          f"{(1, SERVE_NEW_TOKENS - 1)}")
    want = {k: 0 for k in counts}
    want["K2"] = want["K2 transpose"] = per_wave * calls
    check(counts == want, f"serve launches {counts}, predicted {want}")
    batch_rows = {i: rec.rows[rid] for i, rid in enumerate(rids)}
    tokens = {i: results[rid].tokens for i, rid in enumerate(rids)}
    print(f"  checked run: {len(rids)} requests x {SERVE_NEW_TOKENS} tokens, {rec.waves} prefill "
          f"wave + {rec.steps} decode steps, K2 {counts['K2']} launches = ({SERVE_GEMMS_PER_LAYER}"
          f" x {layers} + 1) x {calls}, K1 and K3-K6 0; K2 at {len(k2c.shapes)} distinct input "
          f"shapes == plain version (bitwise): {k2c.shapes}; peak memory {peak_gb:.2f} GB",
          flush=True)
    print(f"  tokens: {[tokens[i] for i in range(len(prompts))]}", flush=True)

    # -- the timed run (warm cache, same requests) ---------------------------
    fast = timed_run(eng, prompts)
    check(fast["tokens"] == [tokens[i] for i in range(len(prompts))],
          "the timed run's tokens differ from the checked run's")

    # -- one decode step split by CUDA events --------------------------------
    for p in prompts:
        eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
    eng.step()  # the prefill wave and the first decode step
    torch.cuda.synchronize()
    with CallTotals(fused_kernel, "gemm_core") as t_core, \
            CallTotals(fused_kernel, "transpose_parts") as t_tr, \
            CallTotals(ops, "stack_parts") as t_stack, CallTotals(ops, "_pad3") as t_pad, \
            CallTotals(gemm, "quantize_matrix") as t_qa, \
            CallTotals(ops, "pair_exponents") as t_pe, \
            CallTotals(attn_mod, "_sdpa") as t_sdpa, \
            CallTotals(attn_mod, "paged_update") as t_pu, \
            CallTotals(attn_mod, "paged_gather") as t_pg:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        eng.step()
        end.record()
        torch.cuda.synchronize()
    step_total = start.elapsed_time(end)
    split = {"K2 core": t_core.seconds() * 1e3,
             "weight parts: stack_parts + _pad3 + transpose_parts":
                 (t_stack.seconds() + t_pad.seconds() + t_tr.seconds()) * 1e3,
             "activation quantization: quantize_matrix + pair_exponents":
                 (t_qa.seconds() + t_pe.seconds()) * 1e3,
             "attention: _sdpa + paged_update + paged_gather":
                 (t_sdpa.seconds() + t_pu.seconds() + t_pg.seconds()) * 1e3}
    split["rest"] = step_total - sum(split.values())
    fast["decode_step_split_ms"] = {"step": step_total, **split}
    print(f"  decode step {step_total:.2f} ms (CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; K2 core calls {len(t_core.spans)}, transposes {len(t_tr.spans)}", flush=True)
    eng.run()

    # -- K2 at the decode shape of lm_head, timed beside its yardsticks ------
    k2_row = k2_lm_head_row(eng._base_group.serve_params.lm_head, params.lm_head, len(prompts),
                            gen, dev, counts["K2"])

    # -- auto vs +core: the first prefill and decode step, bitwise -----------
    core_pol = dataclasses.replace(parse_policy(SERVE_POLICY), backend="core")
    core_eng = BatchingEngine(model, params, policy=core_pol, weight_cache=wcache, **engine_kw)
    zero_counts()
    with ServeRecorder(core_eng) as core_rec:
        core_rids = [core_eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        core_eng.step()  # the prefill wave and the first decode step
    check(all(v == 0 for v in get_counts().values()), "the +core engine launched a kernel")
    for i, rid in enumerate(core_rids):
        for j, row in enumerate(core_rec.rows[rid]):
            check_equal(batch_rows[i][j], row, f"request {i} token {j}: auto vs +core logits")
    print(f"  auto == {core_pol.spec} logits, first prefill and first decode step, all "
          f"{len(prompts)} requests (bitwise)", flush=True)
    del core_eng, eng, wcache
    torch.cuda.empty_cache()

    # -- two requests alone through ServeEngine: batch == alone, bitwise -----
    se = ServeEngine(model, params, max_len=max_len, policy=SERVE_POLICY)
    inner = se._engine_for(1)
    for i in (0, len(prompts) - 1):
        with ServeRecorder(inner) as alone:
            got = se.generate({"tokens": torch.tensor([prompts[i]])}, steps=SERVE_NEW_TOKENS)
        check(got[0].tolist() == tokens[i], f"request {i}: alone {got[0].tolist()} vs batch "
                                            f"{tokens[i]}")
        (rows,) = alone.rows.values()
        for j, row in enumerate(rows):
            check_equal(row, batch_rows[i][j], f"request {i} token {j}: alone vs batch logits")
    print(f"  requests 0 and {len(prompts) - 1} alone through ServeEngine == in the batch, "
          "tokens and logits (bitwise)", flush=True)
    del se, inner
    torch.cuda.empty_cache()

    # -- the yardstick: the same engine under native (bf16 torch.matmul) -----
    nat = timed_run(BatchingEngine(model, params, policy="native", **engine_kw), prompts)
    print(f"  timed run, {len(prompts)} requests x {SERVE_NEW_TOKENS} tokens: " + "; ".join(
        f"{name}: TTFT {', '.join(f'{t:.1f}' for t in r['ttft_ms'])} ms, first step "
        f"{r['first_step_ms']:.1f} ms, decode {r['decode_ms']:.2f} ms a step (median of "
        f"{r['steps'] - 1}), {r['tokens_per_s']:.1f} tokens/s"
        for name, r in (("fast", fast), ("native", nat))), flush=True)
    del params, model
    torch.cuda.empty_cache()
    out = {"config": cfg.name, "layers": layers, "policy": SERVE_POLICY,
           "quantization_s": quant_s, "weight_cache_gb": cache_gb, "peak_gb": peak_gb,
           "launches": counts, "fast": fast, "native": nat,
           "smoke_width": serve_smoke_width(args, dev)}
    return {"k2_row": k2_row, "serve": out}


def serve_smoke_width(args, dev) -> dict:
    """Phase 10 at the smoke width: the engine under each policy of
    SERVE_SMOKE_POLICIES against its '+core' twin (tokens and logits
    bitwise), each kernel's launches as predicted; two accuracy classes as
    two policy groups with ordered moduli. Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.precision import parse_policy
    from repro_torch.serve import BatchingEngine, RequestStatus

    get_counts, zero_counts = serve_counters()
    cfg = get_config(SERVE_ARCH, "smoke")
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 7, 4)]
    engine_kw = dict(max_len=12, max_slots=2, page_size=4)
    per_wave = SERVE_GEMMS_PER_LAYER * cfg.num_layers + 1

    def run(policy):
        eng = BatchingEngine(model, params, policy=policy, **engine_kw)
        zero_counts()
        with ServeRecorder(eng) as rec:
            rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
            res = eng.run()
            torch.cuda.synchronize()
        check(all(res[r].status is RequestStatus.FINISHED for r in rids), f"{policy}: unfinished")
        return [res[r].tokens for r in rids], [rec.rows[r] for r in rids], rec, get_counts()

    launches = {}
    for spec, per_call in SERVE_SMOKE_POLICIES.items():
        pol = parse_policy(spec)
        toks, rows, rec, counts = run(pol)
        core = dataclasses.replace(pol, backend="core", fused=True)
        toks_c, rows_c, _, counts_c = run(core)
        check(all(v == 0 for v in counts_c.values()), f"{core.spec} launched a kernel")
        check(toks == toks_c, f"{spec}: tokens {toks} vs +core {toks_c}")
        for i, (rs, rcs) in enumerate(zip(rows, rows_c)):
            for j, (r, rc) in enumerate(zip(rs, rcs)):
                check_equal(r, rc, f"{spec} request {i} token {j}: logits vs +core")
        calls = per_wave * (rec.waves + rec.steps)
        want = {k: 0 for k in counts}
        want.update({k: v * calls for k, v in per_call(pol.moduli_set().n).items()})
        check(counts == want, f"{spec}: launches {counts}, predicted {want}")
        launches[spec] = {k: v for k, v in counts.items() if v}
        print(f"  smoke width {spec}: {rec.waves} waves + {rec.steps} decode steps, "
              f"launches {launches[spec]} as predicted; tokens and logits == {core.spec} "
              "(bitwise)", flush=True)

    base = parse_policy(SERVE_POLICY)
    eng = BatchingEngine(model, params, policy=base, **engine_kw)
    zero_counts()
    r_lo = eng.submit(prompts[0], max_new_tokens=2, accuracy="relaxed")
    r_hi = eng.submit(prompts[1], max_new_tokens=2, accuracy="fp64")
    res = eng.run()
    counts = get_counts()
    specs = [res[r].policy_spec for r in (r_lo, r_hi)]
    moduli = [parse_policy(sp).num_moduli for sp in specs]
    check(len(eng._groups) == 3 and len(set(specs)) == 2 and moduli[0] < moduli[1],
          f"accuracy classes: groups {list(eng.stats()['groups'])}, specs {specs}")
    check(counts["K2"] > 0 and all(res[r].status is RequestStatus.FINISHED for r in (r_lo, r_hi)),
          f"accuracy classes: K2 launches {counts['K2']}")
    print(f"  accuracy classes relaxed / fp64: policy groups {specs}, moduli {moduli} "
          f"(ordered), K2 {counts['K2']} launches", flush=True)
    return {"launches": launches, "accuracy_groups": specs}


#: Phase 11: the other model families. moonshot-v1-16b-a3b (MoE) and
#: mamba2-2.7b (SSM) at their published widths, depth cut to the layers
#: below; then the smoke widths of the six configs of the families.
FAMILY_FULL = (("moonshot-v1-16b-a3b", 3), ("mamba2-2.7b", 2))
FAMILY_ARCHS = ("deepseek-v3-671b", "moonshot-v1-16b-a3b", "mamba2-2.7b", "zamba2-1.2b",
                "seamless-m4t-medium", "internvl2-26b", "gemma2-27b")
#: Logits of runs that need not be bitwise (the tests' LOGIT_RTOL): |a - b|
#: <= LOGIT_RTOL * max|b|.
LOGIT_RTOL = 1e-5
#: Launches of one emulated GEMM by policy: on a cached weight plan (fast: K2
#: and its transpose; the others as SERVE_SMOKE_POLICIES), and on a raw
#: operand, the lm_head tied to the embeddings, which the weight cache leaves
#: alone as the reference's does.
CACHED_LAUNCHES = {SERVE_POLICY: lambda n: {"K2": 1, "K2 transpose": 1}, **SERVE_SMOKE_POLICIES}
RAW_LAUNCHES = {
    SERVE_POLICY: lambda n: {"K1": 1, "K1 prologue": 2},
    "ozaki2-fp8/accurate": lambda n: {"K1": 1, "K1 prologue": 2},
    "ozaki2-fp8/fast+unfused": lambda n: {"K6": 2, "K3": 3 * n, "K5": 1},
    "ozaki2-fp8/accurate+unfused": lambda n: {"K6": 2, "K3": 3 * n, "K5": 1},
    "ozaki2-int8/fast+unfused": lambda n: {"K6": 2, "K4": n, "K5": 1},
}


def family_gemms(cfg) -> tuple[int, int]:
    """(GEMMs on cached plans, GEMMs on a raw operand) of one model call on
    tokens (a prefill wave or a decode step), reckoned from the config: an
    attention 4 (MLA: w_dq + w_uq or w_q, w_dkv, wo), an MLP 3 (2 ungated),
    an MoE layer's router and shared expert (its routed experts are
    einsums), a Mamba2 layer's in_proj and out_proj, zamba2's shared block
    once a group, a decoder layer's self- and cross-attention, and lm_head
    (raw when tied to the embeddings)."""
    attn = ((2 if cfg.q_lora_rank else 1) + 2) if cfg.use_mla else 4
    mlp = 3 if cfg.gated_mlp else 2
    n = cfg.num_layers
    if cfg.family == "ssm":
        layers = 2 * n
    elif cfg.family == "hybrid":
        layers = 2 * n + n // cfg.shared_attn_every * (attn + mlp)
    elif cfg.family == "moe":
        moe = 1 + 3 * bool(cfg.num_shared_experts)
        dense = cfg.first_dense_layers
        layers = dense * (attn + mlp) + (n - dense) * (attn + moe)
    elif cfg.family == "encdec":
        layers = n * (2 * attn + mlp)
    else:
        layers = n * (attn + mlp)
    return layers + (not cfg.tie_embeddings), int(cfg.tie_embeddings)


def predicted_launches(spec: str, n_moduli: int, cached: int, raw: int, counts: dict) -> dict:
    """The launch counts ``cached`` GEMMs on cached plans and ``raw`` on raw
    operands make under ``spec``, over the counters of ``counts``."""
    want = {k: 0 for k in counts}
    for table, gemms in ((CACHED_LAUNCHES, cached), (RAW_LAUNCHES, raw)):
        for k, v in table[spec](n_moduli).items():
            want[k] += v * gemms
    return want


def compare_rows(a: list, b: list, what: str) -> bool:
    """Logits rows of two runs: bitwise (returns True), or else within
    LOGIT_RTOL of max|b| (returns False); fails beyond that."""
    import torch

    bitwise = True
    for j, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            bitwise = False
            err = (x - y).abs().max().item()
            check(err <= LOGIT_RTOL * y.abs().max().item(),
                  f"{what} token {j}: max |difference| {err}")
    return bitwise


def expert_einsum_row_probe(w, d: int, dev) -> dict:
    """Whether the routed experts' bf16 einsum gives a row the same bits at
    another row count (the dropless prefill's 256 rows against 17, and a
    decode batch's 4 against 1), on the layer's own expert stack ``w``."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((256, d), generator=gen, device=dev).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    full = torch.einsum("td,edf->tef", x, wb)
    return {"256 vs 17 rows": torch.equal(full[:17], torch.einsum("td,edf->tef", x[:17], wb)),
            "4 vs 1 rows": torch.equal(full[:1], torch.einsum("td,edf->tef", x[:1], wb))
            and torch.equal(torch.einsum("td,edf->tef", x[:4], wb)[:1], full[:1])}


def family_full_width(args, dev, arch: str, layers: int) -> dict:
    """Phase 11 (a)/(b) (module docstring): ``arch`` at its published widths,
    ``layers`` deep, served by the BatchingEngine under ozaki2-fp8/fast.
    Returns the run's numbers (and, for an untied lm_head, the kernels
    line's K2 row at its decode shape)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gemm
    from repro_torch.kernels.fused import ops, ozmm_fused_parts_ref, ozmm_fused_raw_ref
    from repro_torch.kernels.fused import kernel as fused_kernel
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.precision import parse_policy
    from repro_torch.serve import BatchingEngine, RequestStatus, ServeEngine

    get_counts, zero_counts = serve_counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, num_layers=layers)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    max_len = -(-(max(SERVE_PROMPTS) + SERVE_NEW_TOKENS) // SERVE_PAGE) * SERVE_PAGE
    engine_kw = dict(max_len=max_len, max_slots=len(prompts), page_size=SERVE_PAGE)
    paged = cfg.family in ("dense", "moe")
    cached, raw = family_gemms(cfg)
    n_moduli = parse_policy(SERVE_POLICY).moduli_set().n
    if cfg.family == "moe":
        widths = (f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
                  f"{cfg.head_dim}, {cfg.num_experts} experts top-{cfg.experts_per_token} of "
                  f"d_ff {cfg.moe_d_ff} + {cfg.num_shared_experts} shared, dense first layer "
                  f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {layers} of {full.num_layers} layers "
                  f"({cfg.first_dense_layers} dense + {layers - cfg.first_dense_layers} MoE)")
    else:
        widths = (f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
                  f"{cfg.ssm_heads} heads x {cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}, vocab "
                  f"{cfg.vocab_size}, tied embeddings; {layers} of {full.num_layers} layers")
    print(f"  {cfg.name} ({cfg.family}): {widths}; bf16 compute, f32 weights from the seed, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} G elements; "
          f"{'paged' if paged else 'slot-pooled'} BatchingEngine", flush=True)

    # -- quantize the weights once, through the engine's cache --------------
    torch.cuda.synchronize()
    tq = time.perf_counter()
    eng = BatchingEngine(model, params, policy=SERVE_POLICY, **engine_kw)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - tq
    wcache = eng._base_group.weight_cache
    check(len(wcache) == cached, f"{arch}: {len(wcache)} plans, predicted {cached}")
    cache_gb = wcache.nbytes() / 1e9
    print(f"  quantization {quant_s:.2f} s, {len(wcache)} plans, WeightResidueCache.nbytes() "
          f"{cache_gb:.3f} GB", flush=True)

    # -- the checked run: launches, each K1/K2 shape vs its plain version ----
    zero_counts()
    with ServeRecorder(eng) as rec, CheckFirstCallPerShape(
            ops, "ozmm_fused_parts", ozmm_fused_parts_ref, f"{arch} K2 vs plain version") as k2c, \
            CheckFirstCallPerShape(ops, "ozmm_fused_raw", ozmm_fused_raw_ref,
                                   f"{arch} K1 vs plain version") as k1c:
        rids = [eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
    counts = get_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rid in rids:
        r = results[rid]
        check(r.status is RequestStatus.FINISHED and len(r.tokens) == SERVE_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{arch} request {rid}: {r.status}, tokens {r.tokens}")
    # paged: one ragged prefill wave; slot-pooled: one exact-length prefill a request
    want_calls = (1 if paged else len(prompts), SERVE_NEW_TOKENS - 1)
    check((rec.waves, rec.steps) == want_calls,
          f"{arch}: (prefill calls, decode steps) {(rec.waves, rec.steps)}, predicted {want_calls}")
    calls = rec.waves + rec.steps
    want = predicted_launches(SERVE_POLICY, n_moduli, cached * calls, raw * calls, counts)
    check(counts == want, f"{arch}: launches {counts}, predicted {want}")
    batch_rows = [rec.rows[rid] for rid in rids]
    tokens = [results[rid].tokens for rid in rids]
    print(f"  checked run: {len(rids)} requests x {SERVE_NEW_TOKENS} tokens, {rec.waves} prefill "
          f"calls + {rec.steps} decode steps; launches {({k: v for k, v in counts.items() if v})} "
          f"= ({cached} cached + {raw} raw GEMMs) x {calls} as predicted; K2 at "
          f"{len(k2c.shapes)} and K1 at {len(k1c.shapes)} distinct input shapes == plain "
          f"version (bitwise); peak memory {peak_gb:.2f} GB", flush=True)
    print(f"  tokens: {tokens}", flush=True)

    # -- the timed run (warm cache, same requests) ---------------------------
    fast = timed_run(eng, prompts)
    check(fast["tokens"] == tokens, f"{arch}: the timed run's tokens differ from the checked run's")

    # -- one decode step split by CUDA events --------------------------------
    for p in prompts:
        eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
    eng.step()  # the prefill and the first decode step
    torch.cuda.synchronize()
    with CallTotals(fused_kernel, "gemm_core") as t_core, \
            CallTotals(fused_kernel, "transpose_parts") as t_tr, \
            CallTotals(ops, "stack_parts") as t_stack, CallTotals(ops, "_pad3") as t_pad, \
            CallTotals(ops, "decompose_raw") as t_raw, \
            CallTotals(fused_kernel, "raw_parts") as t_pro, \
            CallTotals(gemm, "quantize_matrix") as t_qa, \
            CallTotals(ops, "pair_exponents") as t_pe, \
            CallTotals(attn_mod, "_sdpa") as t_sdpa, \
            CallTotals(attn_mod, "paged_update") as t_pu, \
            CallTotals(attn_mod, "paged_gather") as t_pg, \
            CallTotals(blocks_mod, "moe_apply") as t_moe, \
            CallTotals(moe_mod, "_router_probs") as t_router, \
            CallTotals(moe_mod, "mlp_apply") as t_shared, \
            CallTotals(blocks_mod, "mamba2_apply") as t_mamba, \
            CallTotals(ssm_mod, "matmul") as t_proj:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        eng.step()
        end.record()
        torch.cuda.synchronize()
    step_total = start.elapsed_time(end)
    ms = lambda *ts: sum(t.seconds() for t in ts) * 1e3
    split = {"K1/K2 core": ms(t_core),
             "weight parts: stack_parts + _pad3 + transpose_parts": ms(t_stack, t_pad, t_tr),
             "raw lm_head: decompose_raw + K1 prologue": ms(t_raw, t_pro),
             "activation quantization: quantize_matrix + pair_exponents": ms(t_qa, t_pe),
             "attention: _sdpa + paged_update + paged_gather": ms(t_sdpa, t_pu, t_pg),
             "routed experts: moe_apply less its router and shared-expert GEMMs":
                 ms(t_moe) - ms(t_router, t_shared),
             "SSM: mamba2_apply less in_proj/out_proj (conv, SSD step, gated norm)":
                 ms(t_mamba) - ms(t_proj)}
    split["rest"] = step_total - sum(split.values())
    fast["decode_step_split_ms"] = {"step": step_total, **split}
    print(f"  decode step {step_total:.2f} ms (CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items() if v), flush=True)
    eng.run()

    out = {"config": cfg.name, "layers": layers, "policy": SERVE_POLICY, "plans": len(wcache),
           "quantization_s": quant_s, "weight_cache_gb": cache_gb, "peak_gb": peak_gb,
           "launches": {k: v for k, v in counts.items() if v}, "fast": fast}
    if not cfg.tie_embeddings:  # K2 at lm_head's decode shape, timed
        out["k2_row"] = k2_lm_head_row(eng._base_group.serve_params.lm_head, params.lm_head,
                                       len(prompts), gen, dev, counts["K2"])

    # -- auto vs +core: the first prefill and decode step, bitwise -----------
    core_pol = dataclasses.replace(parse_policy(SERVE_POLICY), backend="core")
    core_eng = BatchingEngine(model, params, policy=core_pol, weight_cache=wcache, **engine_kw)
    zero_counts()
    with ServeRecorder(core_eng) as core_rec:
        core_rids = [core_eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        core_eng.step()  # the prefill and the first decode step
    check(all(v == 0 for v in get_counts().values()), f"{arch}: the +core engine launched a kernel")
    for i, rid in enumerate(core_rids):
        for j, row in enumerate(core_rec.rows[rid]):
            check_equal(batch_rows[i][j], row, f"{arch} request {i} token {j}: auto vs +core")
    print(f"  auto == {core_pol.spec}: tokens and logits of the prefill and first decode step, "
          f"all {len(prompts)} requests (bitwise)", flush=True)
    del core_eng, eng, wcache
    gc.collect()
    torch.cuda.empty_cache()

    # -- batch == alone (MoE: dropless; capacity follows the bucket) ---------
    alone_cfg = dataclasses.replace(cfg, moe_dropless=True) if cfg.num_experts else cfg
    alone_model = Model(alone_cfg, device=dev)
    se = ServeEngine(alone_model, params, max_len=max_len, policy=SERVE_POLICY)
    beng = BatchingEngine(alone_model, params, policy=SERVE_POLICY,
                          weight_cache=se.weight_cache, **engine_kw)
    with ServeRecorder(beng) as brec:
        brids = [beng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        bres = beng.run()
    del beng
    bitwise = {}
    for i in (0, len(prompts) - 1):
        with ServeRecorder(se._engine_for(1)) as alone:
            got = se.generate({"tokens": torch.tensor([prompts[i]])}, steps=SERVE_NEW_TOKENS)
        check(got[0].tolist() == bres[brids[i]].tokens,
              f"{arch} request {i}: alone {got[0].tolist()} vs batch {bres[brids[i]].tokens}")
        (rows,) = alone.rows.values()
        bitwise[i] = compare_rows(rows, brec.rows[brids[i]], f"{arch} request {i} alone vs batch")
    out["batch_vs_alone"] = {"config": "moe_dropless" if cfg.num_experts else "as published",
                             "tokens_equal": True, "logits_bitwise": bitwise}
    print(f"  requests 0 and {len(prompts) - 1} alone through ServeEngine == in the batch "
          f"({out['batch_vs_alone']['config']}): tokens equal, logits bitwise {bitwise} "
          f"(else within {LOGIT_RTOL} of max|logit|)", flush=True)
    if cfg.num_experts:
        probe = expert_einsum_row_probe(params.stages[1][0].moe.w_gate, cfg.d_model, dev)
        out["expert_einsum_row_invariant"] = probe
        print(f"  routed-expert bf16 einsum, a row's bits at another row count: {probe}",
              flush=True)
    del se, alone_model
    gc.collect()
    torch.cuda.empty_cache()

    # -- the yardstick: the same engine under native (bf16 torch.matmul) -----
    out["native"] = timed_run(BatchingEngine(model, params, policy="native", **engine_kw), prompts)
    print(f"  timed run, {len(prompts)} requests x {SERVE_NEW_TOKENS} tokens: " + "; ".join(
        f"{name}: TTFT {', '.join(f'{t:.1f}' for t in r['ttft_ms'])} ms, first step "
        f"{r['first_step_ms']:.1f} ms, decode {r['decode_ms']:.2f} ms a step (median of "
        f"{r['steps'] - 1}), {r['tokens_per_s']:.1f} tokens/s"
        for name, r in (("fast", fast), ("native", out["native"]))), flush=True)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def families_smoke_width(args, dev) -> dict:
    """Phase 11 (c): the smoke widths of the six configs under ozaki2-fp8/fast
    and each policy of SERVE_SMOKE_POLICIES against their '+core' twins
    (tokens and logits bitwise), each kernel's launches as predicted. The
    token-only families through the BatchingEngine (paged or slot-pooled),
    seamless-m4t (audio frames) and internvl2 (patch embeddings) through
    Model.init_cache / prefill / decode_step. Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.precision import parse_policy
    from repro_torch.serve import BatchingEngine, RequestStatus, quantize_params

    get_counts, zero_counts = serve_counters()
    launches = {}
    for a, arch in enumerate(FAMILY_ARCHS):
        cfg = get_config(arch, "smoke")
        model = Model(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 2 + a)
        params = model.init(gen)
        rng = np.random.default_rng(args.seed + 2 + a)
        cached, raw = family_gemms(cfg)
        direct = cfg.family == "encdec" or cfg.frontend
        if direct:
            batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 5)), device=dev)}
            extra = 1  # frontend_proj: the vlm's patches at prefill, the encoder's frames
            if cfg.family == "encdec":
                batch["frames"] = torch.tensor(rng.standard_normal((2, 7, cfg.frontend_dim)),
                                               device=dev)
                extra += cfg.num_encoder_layers * (4 + (3 if cfg.gated_mlp else 2))
            else:
                batch["patch_embeds"] = torch.tensor(
                    rng.standard_normal((2, cfg.frontend_len, cfg.frontend_dim)), device=dev)
            max_len = cfg.frontend_len + 5 + 3
        else:
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 7, 4)]

        def run(policy):
            zero_counts()
            if direct:  # two model calls after the prefill
                m = Model(dataclasses.replace(cfg, gemm=policy), device=dev)
                sp = quantize_params(params, policy) if policy.plans_enabled else params
                zero_counts()
                cache = m.init_cache(sp, batch, max_len)
                logits, cache = m.prefill(sp, batch, cache)
                rows = [logits.clone()]
                for _ in range(2):
                    logits, cache = m.decode_step(sp, logits.argmax(-1), cache)
                    rows.append(logits.clone())
                torch.cuda.synchronize()
                return rows, (extra + 3 * cached, 3 * raw), get_counts()
            eng = BatchingEngine(model, params, policy=policy, max_len=12, max_slots=2,
                                 page_size=4)
            zero_counts()
            with ServeRecorder(eng) as rec:
                rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
                res = eng.run()
                torch.cuda.synchronize()
            check(all(res[r].status is RequestStatus.FINISHED for r in rids),
                  f"{arch} {policy.spec}: unfinished")
            calls = rec.waves + rec.steps
            rows = [row for r in rids for row in rec.rows[r]]
            return rows, (cached * calls, raw * calls), get_counts()

        for spec in (SERVE_POLICY, *SERVE_SMOKE_POLICIES):
            pol = parse_policy(spec)
            rows, (c_cached, c_raw), counts = run(pol)
            core = dataclasses.replace(pol, backend="core", fused=True)
            rows_c, _, counts_c = run(core)
            check(all(v == 0 for v in counts_c.values()), f"{arch}: {core.spec} launched a kernel")
            check(len(rows) == len(rows_c), f"{arch} {spec}: {len(rows)} vs {len(rows_c)} rows")
            for j, (r, rc) in enumerate(zip(rows, rows_c)):
                check_equal(r, rc, f"{arch} {spec} row {j}: logits vs +core")
            want = predicted_launches(spec, pol.moduli_set().n, c_cached, c_raw, counts)
            check(counts == want, f"{arch} {spec}: launches {counts}, predicted {want}")
            launches.setdefault(arch, {})[spec] = {k: v for k, v in counts.items() if v}
        print(f"  smoke width {arch} ({cfg.family}{', direct' if direct else ''}): "
              f"{len(launches[arch])} policies, tokens and logits == +core (bitwise), launches "
              f"as predicted ({cached} cached + {raw} raw GEMMs a call): "
              f"{launches[arch][SERVE_POLICY]} under {SERVE_POLICY}", flush=True)
        del model, params
    torch.cuda.empty_cache()
    return launches


def families_phase(args, dev) -> dict:
    """Phase 11 (module docstring). Returns the kernels line's K2 row at
    moonshot's lm_head decode shape and the phase's numbers."""
    out = {arch: family_full_width(args, dev, arch, layers) for arch, layers in FAMILY_FULL}
    k2_row = out[FAMILY_FULL[0][0]].pop("k2_row")
    out["smoke_width"] = families_smoke_width(args, dev)
    return {"k2_row": k2_row, "families": out}




# ---------------------------------------------------------------------------
# Phase 12: training (repro_torch.train, optim, checkpoint, data, runtime)

#: (a)/(b): starcoder2-15b at its published widths (vocab 49,152), depth cut
#: to 2 of 40 layers: memory and the run's time, while two layers keep remat
#: and a layer-to-layer gradient.
TRAIN_ARCH = "starcoder2-15b"
TRAIN_LAYERS = 2
TRAIN_POLICY = "ozaki2-fp8/fast"
TRAIN_STEPS = 4
TRAIN_MICROBATCHES = 2
TRAIN_BATCH, TRAIN_SEQ = 8, 256
#: (b): the batch of the FP64-grade check, and one f32 ulp (2^-23
#: relative), the resolution of the model's own f32 islands, the gate on its
#: f32 logits and (normwise) its gradients. The reference example's gate
#: (examples/fp64_train.py), max |emulated - native| / (|native| + 1e-6) <
#: 1e-9, is reported, not gated: at this width the first chip runs found
#: the f32 logits one ulp apart (1.1e-7), the embedding's gradient 2.1e-9
#: and lm_head's product in f64 2.3e-9 (logits near 0, where 1e-6 is no
#: floor for a k = 6144 sum's rounding); the f64 product is gated by DGEMM's
#: componentwise error bound instead.
FP64_BATCH, FP64_SEQ, F32_ULP = 2, 128, 2.0 ** -23
#: (c): the smoke configs trained one step each under these policies (and
#: ozaki2-int8/fast+unfused on the first), against their '+core' twins.
TRAIN_FAMILIES = ("qwen2-7b", "starcoder2-15b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                  "mamba2-2.7b", "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b",
                  "gemma2-27b")
TRAIN_SMOKE_POLICIES = ("ozaki2-fp8/fast", "ozaki2-fp8/accurate+unfused")
TRAIN_INT8_POLICY = "ozaki2-int8/fast+unfused"
#: (d): qwen2-7b at its published widths (vocab 152,064: lm_head's input
#: gradient contracts past K1's 2^16 chunk, in three chunks), depth cut to 2
#: of 28 layers: the state (f32 parameters, gradients and AdamW moments of
#: 1.56 G parameters, ~31 GB) beside K1's transients at lm_head (~44 GB:
#: both operands in f64, their raw frames and 25 GB of parts) leaves no room
#: for a third; 2 steps of (a)'s microbatches.
LONG_TRAIN_ARCH = "qwen2-7b"
LONG_TRAIN_LAYERS = 2
LONG_TRAIN_STEPS = 2
#: The plain version of K1's row at lm_head's input gradient runs on column
#: blocks of B of at most this many elements (its residues for every
#: modulus of a larger B would not fit beside the run).
PLAIN_B_ELEMS = 1 << 28


def train_gemms(cfg) -> tuple[int, int, int]:
    """(forward, remat-recomputed, backward) emulated GEMMs of one loss and
    its gradient on a batch, reckoned from the config: the serving count of
    one model call (family_gemms; training has no plans, so all are raw),
    plus the frontend projection (the vlm's patches; the encdec's frames and
    its encoder layers) and the MTP head (proj, a dense block, lm_head
    again); under remat "full" (dense only here) each layer's GEMMs once
    more; two cotangent GEMMs a GEMM, one where its input is data (the
    frontend projection's patches or frames)."""
    cached, raw = family_gemms(cfg)
    fwd = cached + raw
    attn = ((2 if cfg.q_lora_rank else 1) + 2) if cfg.use_mla else 4
    mlp = 3 if cfg.gated_mlp else 2
    data_inputs = 1 if cfg.frontend else 0
    if cfg.family == "encdec":
        fwd += 1 + cfg.num_encoder_layers * (4 + mlp)
    elif cfg.frontend:
        fwd += 1
    if cfg.mtp_depth:
        fwd += 1 + attn + mlp + 1
    recompute = 0
    if cfg.remat == "full":
        check(cfg.family == "dense", "train_gemms reckons remat for dense configs only")
        recompute = cfg.num_layers * (attn + mlp)
    return fwd, recompute, 2 * fwd - data_inputs


#: Phase 12's plain-version checks run on blocks, so that their stacks fit
#: beside the training run: an operand panel of at most PLAIN_PANEL
#: elements (its parts for every modulus), an output block of at most
#: PLAIN_OUT.
PLAIN_PANEL, PLAIN_OUT = 1 << 26, 1 << 23


def split_planes(parts) -> list:
    """The planes of ``quantize.split_residues``' per-modulus parts, in
    ``part_planes``' order (a square modulus has no hs)."""
    return [t for p in parts for t in p]


def plain_block(k: int, cap: int) -> int:
    """Rows (or columns) of a plain-version block at contraction ``k``."""
    return max(128, min(cap, PLAIN_PANEL // k) // 128 * 128)


class CheckK1Training:
    """Wraps the fused ops' K1 call while in the block: at its first call at
    each distinct set of input shapes, K1's result is held bitwise against
    its plain version (``raw_split_parts`` + ``parts_product_plain``, the
    composition ``ozmm_fused_raw_ref`` is) block by block, A's parts once a
    row block (output rows and columns are independent), and its residue
    prologue, run on the whole operands, plane by plane against the same
    plain parts (``raw_parts_plain``'s planes: B's transposed to K-major);
    the prologue launches of the check are taken back off its counter."""

    def __init__(self, what: str):
        self.what, self.shapes = what, []

    def __enter__(self):
        from repro_torch.kernels.fused import kernel as fk
        from repro_torch.kernels.fused import ops, part_planes

        self.orig = fn = ops.ozmm_fused_raw

        def checked(*a, **kw):
            out = fn(*a, **kw)
            key = shapes_of(a)
            if key in self.shapes:
                return out
            self.shapes.append(key)
            ms, tbl = kw["ms"], a[8]
            (m, k), n = a[0].shape, a[4].shape[1]
            mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu = a[:8]
            counted = fk.raw_parts.launches
            kern_a = part_planes(fk.raw_parts(*a[:4], tbl, ms=ms, axis=0), ms)
            kern_b = part_planes(fk.raw_parts(*a[4:8], tbl, ms=ms, axis=1), ms)
            fk.raw_parts.launches = counted
            rows = plain_block(k, m)
            cols = plain_block(k, max(128, PLAIN_OUT // rows))
            for r0 in range(0, m, rows):  # A's parts once a row block
                rs = slice(r0, r0 + rows)
                pa = fk.raw_split_parts(mh_a[rs], ml_a[rs], e_a[rs] + lmu[rs], tbl, ms=ms)
                for i, (g, w) in enumerate(zip(kern_a, split_planes(pa))):
                    check_equal(as_bytes(g[rs]), as_bytes(w),
                                f"{self.what} K1 prologue at {key} A plane {i} rows {r0}")
                for c0 in range(0, n, cols):
                    cs = slice(c0, c0 + cols)
                    pb = fk.raw_split_parts(mh_b[:, cs], ml_b[:, cs], e_b[:, cs] + lnu[:, cs],
                                            tbl, ms=ms)
                    if r0 == 0:  # the prologue: B's parts K-major
                        for i, (g, w) in enumerate(zip(kern_b, split_planes(pb))):
                            check_equal(as_bytes(g[cs]), as_bytes(w.t().contiguous()),
                                        f"{self.what} K1 prologue at {key} B plane {i} "
                                        f"columns {c0}")
                    want = fk.parts_product_plain(pa, pb, lmu[rs], lnu[:, cs], ms=ms)
                    check_equal(out[rs, cs], want,
                                f"{self.what} K1 at input shapes {key}, block ({r0}, {c0})")
                    del pb, want
                del pa
            return out

        ops.ozmm_fused_raw = checked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.fused import ops

        ops.ozmm_fused_raw = self.orig


def param_slices(params) -> dict:
    """Copies of a few slices of the parameters (embed, a layer weight, the
    final norm, lm_head), to show that a run moved them."""
    return {name: p.detach()[..., :8].clone() for name, p in params.named_parameters()
            if name in ("embed", "stages.0.0.attn.wq", "stages.0.1.mlp.w_down", "final_norm",
                        "lm_head")}


def k1_train_row(a, b, launches: int, spec: str = TRAIN_POLICY,
                 what: str = "lm_head's input-gradient shape") -> dict:
    """The kernels line's row of K1 under ``spec`` at ``a @ b``, by default
    the training path's vocabulary contraction (lm_head's input gradient,
    dlogits @ W^T): bitwise against its plain version, timed (median of 5
    after a warm-up; the plain version median of K1_REPS, each a pass over
    B's column blocks of at most PLAIN_B_ELEMS) beside its bound and cuBLAS
    DGEMM on the same f64 inputs."""
    import torch

    from repro_torch.core.scaling import compute_scaling
    from repro_torch.kernels.fused import KERNEL_TILE, fused_raw_args, ozmm_fused_raw, ozmm_fused_raw_ref
    from repro_torch.precision import parse_policy

    pol = parse_policy(spec)
    ms = pol.moduli_set()
    (m, k), n = a.shape, b.shape[1]
    scal = compute_scaling(a, b, ms, pol.mode)
    fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
    counted = ozmm_fused_raw.launches
    got = ozmm_fused_raw(*fa, ms=ms)
    n_pad = fa[4].shape[1]
    cols = max(KERNEL_TILE[1], min(n_pad, PLAIN_B_ELEMS // k) // KERNEL_TILE[1] * KERNEL_TILE[1])

    def plain():  # on B's column blocks, one block when B fits
        return torch.cat([ozmm_fused_raw_ref(*fa[:4], *(t[:, c0:c0 + cols] for t in fa[4:8]),
                                             fa[8], ms=ms) for c0 in range(0, n_pad, cols)], 1)

    max_err = (got - plain()).abs().max().item()
    ms_plain = cuda_ms(plain, K1_REPS)
    del got
    ms_k1 = cuda_ms(lambda: ozmm_fused_raw(*fa, ms=ms))
    ozmm_fused_raw.launches = counted
    ms_dgemm = cuda_ms(lambda: torch.matmul(a, b))
    n_bytes = sum(t.numel() * t.element_size() for t in fa) + m * n * 8
    del fa
    t_ops = 3 * ms.n * 2 * m * n * k / H100_FP8_OPS_PER_S * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    check(max_err == 0.0, f"K1 at {what} {m}x{k}x{n} differs from its plain version")
    row = {"name": "ozmm_fused_raw", "policy": spec, "shape": [m, k, n], "route": "cuda",
           "source": "src/repro_torch/csrc/fused_raw.cu",
           "replaces": "src/repro/kernels/fused/kernel.py:238",
           "launches": launches, "max_abs_err": max_err, "ms": ms_k1, "plain_ms": ms_plain,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes > t_ops else "operations",
           "library_ms": ms_dgemm}
    print(f"  K1 at {what} {m}x{k}x{n}: "
          f"{ms_k1:.2f} ms, plain {ms_plain:.2f} ms, bound {row['bound_ms']:.2f} ms "
          f"({row['bound_by']}), cuBLAS DGEMM {ms_dgemm:.2f} ms", flush=True)
    return row


def train_full_width(args, dev, arch: str = TRAIN_ARCH, layers: int = TRAIN_LAYERS,
                     steps: int = TRAIN_STEPS, native: bool = True) -> dict:
    """Phase 12 (a) and (d) (module docstring): ``arch`` at its published
    widths, ``layers`` deep, ``steps`` steps; beside the same run under
    native when ``native``. Returns the run's numbers, the K1 row, and the
    trained parameters and config (for (b))."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gemm, scaling
    from repro_torch.data import DataConfig
    from repro_torch.kernels.fused import kernel as fused_kernel
    from repro_torch.kernels.fused import ops
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_mod
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import step as step_mod

    get_counts, zero_counts = serve_counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, num_layers=layers, gemm=TRAIN_POLICY)
    data = DataConfig(seed=args.seed, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size)
    tcfg = TrainerConfig(steps=steps, microbatches=TRAIN_MICROBATCHES, log_every=1,
                         seed=args.seed)
    fwd, recompute, bwd = train_gemms(cfg)
    per_mb = fwd + recompute + bwd
    want_k1 = steps * TRAIN_MICROBATCHES * per_mb
    rows = TRAIN_BATCH // TRAIN_MICROBATCHES * TRAIN_SEQ
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.act}, "
          f"{'gated' if cfg.gated_mlp else 'plain'} MLP), "
          f"{'QKV bias, ' if cfg.qkv_bias else ''}vocab {cfg.vocab_size}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'} lm_head, remat {cfg.remat!r}; "
          f"{layers} of {full.num_layers} layers; f32 parameters from the seed, {cfg.dtype} "
          f"compute, {cfg.gemm.spec} on backend auto; Trainer: {steps} steps x "
          f"{TRAIN_MICROBATCHES} microbatches of {rows} rows", flush=True)

    class Hook:
        """step_transform: snapshots parameter slices before the first step
        (which carries the checks) and restarts the split and the peak
        memory after it."""

        def __init__(self, totals):
            self.totals, self.steps, self.before, self.peak_checks = totals, 0, None, 0.0

        def __call__(self, step_fn):
            def run(state, batch):
                if self.steps == 0:
                    self.before = param_slices(state.params)
                    self.params = sum(p.numel() for p in state.params.parameters())
                elif self.steps == 1:
                    torch.cuda.synchronize()
                    for t in self.totals.values():
                        t.spans.clear()
                    self.peak_checks = torch.cuda.max_memory_allocated() / 1e9
                    torch.cuda.reset_peak_memory_stats()
                self.steps += 1
                return step_fn(state, batch)
            return run

    zero_counts()
    sink = []
    with CallTotals(fused_kernel, "gemm_core") as t_core, \
            CallTotals(fused_kernel, "raw_parts") as t_pro, \
            CallTotals(ops, "fused_raw_args") as t_frames, \
            CallTotals(ops, "row_major") as t_rowmajor, \
            CallTotals(gemm, "_as_f64") as t_f64, \
            CallTotals(scaling, "compute_scaling") as t_scal, \
            CallTotals(step_mod, "opt_update") as t_adamw, \
            CallTotals(attn_mod, "_sdpa") as t_attn, CheckK1Training(cfg.name) as k1c:
        totals = {"k1_core": t_core, "k1_prologue": t_pro, "decompose_raw_and_pad": t_frames,
                  "f64_copies": t_f64, "transposed_copies": t_rowmajor, "scaling": t_scal,
                  "adamw": t_adamw, "attention": t_attn}
        hook = Hook(totals)
        trainer = Trainer(Model(cfg, device=dev), AdamWConfig(), data, tcfg, step_transform=hook)
        state = trainer.run(sink)
        torch.cuda.synchronize()
        split = {k: t.seconds() * 1e3 / (steps - 1) for k, t in totals.items()}
    counts = get_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in sink]
    dts = [m["dt"] for m in sink]
    check(len(sink) == steps, f"{len(sink)} steps, want {steps}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    after = param_slices(state.params)
    check(all(not torch.equal(after[k], v) for k, v in hook.before.items()),
          "a training run left parameters unmoved")
    want = {k: 0 for k in counts}
    want.update({"K1": want_k1, "K1 prologue": 2 * want_k1})
    check(counts == want, f"training launches {counts}, predicted {want}")
    step_ms = statistics.median(dts[1:]) * 1e3
    split["rest"] = step_ms - sum(split.values())
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"  {hook.params / 1e9:.3f} G parameters; losses {[round(x, 4) for x in losses]}; "
          f"K1 launches {counts['K1']} = {steps} steps x {TRAIN_MICROBATCHES} x "
          f"({fwd} forward + {recompute} recomputed + {bwd} backward), prologue "
          f"{counts['K1 prologue']}, K2-K6 0 (as predicted); K1 and its prologue at "
          f"{len(k1c.shapes)} distinct input shapes == plain versions (bitwise)", flush=True)
    print(f"  step {step_ms:.1f} ms (median of steps 1-{steps - 1}; first step "
          f"{dts[0] * 1e3:.1f} ms with the checks), {tokens_s:.0f} tokens/s, peak "
          f"{peak:.2f} GB (the first step with its checks {hook.peak_checks:.2f}); a step by "
          f"CUDA events: " + ", ".join(
              f"{k} {v:.1f}" for k, v in split.items()) + " ms", flush=True)

    # K1 at lm_head's input-gradient shape, on the trained weight, with the
    # moments freed (its plain version holds every modulus' residues of B)
    params = state.params
    state.opt.m.clear()
    state.opt.v.clear()
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 7)
    dlogits = torch.randn((rows, cfg.vocab_size), generator=gen, device=dev,
                          dtype=torch.float64) * 1e-4
    w_t = params.lm_head.detach().T.to(torch.float64).contiguous()
    k1_row = k1_train_row(dlogits, w_t, counts["K1"])
    del dlogits, w_t
    gc.collect()
    torch.cuda.empty_cache()

    out = {"arch": cfg.name, "layers": layers, "params": hook.params, "losses": losses,
           "step_ms": step_ms, "step_ms_each": [d * 1e3 for d in dts], "tokens_per_s": tokens_s,
           "peak_gb": peak, "peak_gb_first_step": hook.peak_checks, "split_ms": split,
           "launches": counts, "k1_shapes_checked": len(k1c.shapes)}
    if not native:
        return {"numbers": out, "k1_row": k1_row, "params": params, "cfg": cfg}

    # the yardstick: the same run under native (bf16 torch.matmul)
    native_sink = []
    native_trainer = Trainer(Model(dataclasses.replace(cfg, gemm="native"), device=dev),
                             AdamWConfig(), data, tcfg)
    zero_counts()
    native_trainer.run(native_sink)
    check(all(v == 0 for v in get_counts().values()), "the native run launched a kernel")
    native_ms = statistics.median(m["dt"] for m in native_sink[1:]) * 1e3
    del native_trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  native (bf16 torch.matmul) step {native_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / (native_ms / 1e3):.0f} tokens/s; losses "
          f"{[round(m['loss'], 4) for m in native_sink]}", flush=True)
    out.update({"native_step_ms": native_ms,
                "native_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (native_ms / 1e3),
                "native_losses": [m["loss"] for m in native_sink]})
    return {"numbers": out, "k1_row": k1_row, "params": params, "cfg": cfg}


def train_fp64_grade(args, dev, params, cfg) -> dict:
    """Phase 12 (b) (module docstring): (a)'s trained parameters in f64; the
    emulated model (ozaki2-fp8/accurate, K1) against the native one (f64
    cuBLAS DGEMM), both with the reference's f32 islands (rmsnorm, rope,
    attention's logits and softmax, the logits' f32 output)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.layers import matmul, rmsnorm
    from repro_torch.train import loss_fn

    get_counts, zero_counts = serve_counters()
    with torch.no_grad():
        for p in params.parameters():
            p.data = p.data.to(torch.float64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f64 = dict(dtype="float64", param_dtype="float64")
    emu = Model(dataclasses.replace(cfg, gemm="ozaki2-fp8/accurate", **f64), device=dev)
    nat = Model(dataclasses.replace(cfg, gemm="native", **f64), device=dev)
    batch = synth_batch(DataConfig(seed=args.seed, batch=FP64_BATCH, seq_len=FP64_SEQ,
                                   vocab_size=cfg.vocab_size), cfg, step=10_000)
    fwd, recompute, bwd = train_gemms(emu.cfg)
    hidden, logits_of = [], model_mod.Model._logits

    def keep_hidden(self, p, x):
        hidden.append(x)
        return logits_of(self, p, x)

    zero_counts()
    with torch.no_grad():
        lg_emu = emu.forward_train(params, batch).logits
        model_mod.Model._logits = keep_hidden
        try:
            lg_nat = nat.forward_train(params, batch).logits
        finally:
            model_mod.Model._logits = logits_of
        # the logits' GEMM itself in f64, on native's final hidden state
        h = rmsnorm(hidden.pop(), params.final_norm, cfg.norm_eps)
        z_emu = matmul(h, params.lm_head, emu.cfg.gemm, out_dtype=torch.float64)
        z_nat = matmul(h, params.lm_head, "native", out_dtype=torch.float64)
        # a DGEMM's componentwise error bound, gamma_k (|h| |W|) with
        # gamma_k = k 2^-53: both products lie within it of the exact one
        bound = matmul(h.abs(), params.lm_head.abs(), "native", out_dtype=torch.float64)
        bound *= 2 * h.shape[-1] * 2.0 ** -53
    diff = (z_emu - z_nat).abs()
    gemm_dev = (diff / (z_nat.abs() + 1e-6)).max().item()
    gemm_bound = (diff / bound).max().item()
    gemm_norm = (torch.linalg.vector_norm(z_emu - z_nat) / torch.linalg.vector_norm(z_nat)).item()
    del diff, bound
    rel = (lg_emu.double() - lg_nat.double()).abs() / (lg_nat.double().abs() + 1e-6)
    logit_dev, logits_equal = rel.max().item(), (lg_emu == lg_nat).double().mean().item()
    del lg_emu, lg_nat, z_emu, z_nat, h, rel
    leaves = reference_leaves(params)

    def grads(model):
        loss, _ = loss_fn(model, params, batch)
        return float(loss.detach()), torch.autograd.grad(loss, list(leaves.values()))

    t0 = time.perf_counter()
    loss_emu, g_emu = grads(emu)
    torch.cuda.synchronize()
    emu_s = time.perf_counter() - t0
    counts = get_counts()
    t0 = time.perf_counter()
    loss_nat, g_nat = grads(nat)
    torch.cuda.synchronize()
    nat_s = time.perf_counter() - t0
    errs = {name: (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
            for name, a, b in zip(leaves, g_emu, g_nat)}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del g_emu, g_nat
    want = {k: 0 for k in counts}
    k1 = 2 * fwd + 1 + recompute + bwd  # the logits' forward and GEMM, then the loss's
    want.update({"K1": k1, "K1 prologue": 2 * k1})
    check(counts == want, f"FP64 grade: launches {counts}, predicted {want}")
    print(f"  FP64 grade ({FP64_BATCH} x {FP64_SEQ}, f64 parameters), ozaki2-fp8/accurate (K1 "
          f"{counts['K1']} launches) vs native f64 (cuBLAS DGEMM), max |d| / (|ref| + 1e-6): "
          f"lm_head's GEMM in f64 {gemm_dev:.3e} (the reference example's 1e-9; "
          f"normwise {gemm_norm:.3e}; at most {gemm_bound:.3f} of twice DGEMM's "
          f"componentwise bound k 2^-53 |h||W|, the gate 1); the model's f32 "
          f"logits {logit_dev:.3e} (gate one f32 ulp, {F32_ULP:.3e}; {logits_equal:.6%} "
          f"bitwise equal); gradients normwise, worst leaves "
          + ", ".join(f"{k} {errs[k]:.3e}" for k in worst)
          + f" (gate {F32_ULP:.3e}); loss {loss_emu!r} vs {loss_nat!r}; loss + gradient "
          f"{emu_s:.2f} s vs {nat_s:.2f} s; peak {peak:.2f} GB", flush=True)
    check(gemm_bound <= 1.0, f"FP64 grade: lm_head's f64 GEMM deviates {gemm_bound} of "
                             "twice DGEMM's componentwise error bound")
    check(logit_dev <= F32_ULP, f"FP64 grade: logits deviate {logit_dev} > one f32 ulp")
    check(errs[worst[0]] <= F32_ULP, f"FP64 grade: {worst[0]}'s gradient deviates "
                                     f"{errs[worst[0]]}")
    return {"gemm_dev": gemm_dev, "gemm_normwise": gemm_norm, "gemm_of_bound": gemm_bound,
            "logit_dev": logit_dev, "logits_bitwise_equal": logits_equal,
            "grad_dev": {k: errs[k] for k in worst}, "loss": [loss_emu, loss_nat],
            "seconds": [emu_s, nat_s], "peak_gb": peak, "launches": counts}


def determinism_probe(dev) -> dict:
    """Whether the non-GEMM ops of a training step's backward that
    accumulate give the same bits twice on the card (without
    torch.use_deterministic_algorithms): the embedding gather's backward
    (index_put_ with accumulate), cross-entropy's take_along_dim backward
    (scatter_add_), and the routed experts' dispatch einsum backward.
    (c)'s bitwise checks against '+core' rest on them."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    table = torch.randn((512, 2048), generator=gen, device=dev, requires_grad=True)
    tok = torch.randint(0, 64, (8, 256), generator=gen, device=dev)  # many repeats
    g_out = torch.randn((8, 256, 2048), generator=gen, device=dev)
    logp = torch.randn((2048, 49152), generator=gen, device=dev, requires_grad=True)
    lab = torch.randint(0, 49152, (2048, 1), generator=gen, device=dev)
    disp = torch.rand((64, 256, 8, 16), generator=gen, device=dev, requires_grad=True)
    xt = torch.randn((64, 256, 512), generator=gen, device=dev)

    probes = {
        "embedding gather backward (index_put_ accumulate)":
            (lambda: (table[tok] * g_out).sum(), table),
        "take_along_dim backward (scatter_add_)":
            (lambda: torch.take_along_dim(logp, lab, dim=-1).sum(), logp),
        "dispatch einsum backward":
            (lambda: torch.einsum("ngec,ngd->necd", disp, xt).square().sum(), disp)}
    out = {}
    for name, (fn, leaf) in probes.items():
        a, b = (torch.autograd.grad(fn(), leaf)[0] for _ in range(2))
        out[name] = torch.equal(a, b)
    print(f"  determinism probe (two runs each): {out}", flush=True)
    check(all(out.values()), f"an accumulating backward op is not deterministic: {out}")
    return out


def train_smoke_width(args, dev) -> dict:
    """Phase 12 (c) (module docstring): every family's smoke config, one
    make_train_step step a policy against its '+core' twin from the same
    state and batch (loss, gradients, new parameters and moments bitwise),
    each kernel's launches as predicted. Returns the launch counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.precision import parse_policy
    from repro_torch.train import make_train_step
    from repro_torch.train import step as step_mod

    get_counts, zero_counts = serve_counters()
    launches = {}
    for a, arch in enumerate(TRAIN_FAMILIES):
        cfg = get_config(arch, "smoke")
        batch = synth_batch(DataConfig(seed=args.seed, batch=2, seq_len=8,
                                       vocab_size=cfg.vocab_size), cfg, a)
        fwd, recompute, bwd = train_gemms(cfg)

        def run(policy):
            init, step = make_train_step(Model(dataclasses.replace(cfg, gemm=policy), device=dev),
                                         AdamWConfig(lr=1e-2, warmup_steps=1))
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed + a)
            state = init(gen)
            grads, update = {}, step_mod.opt_update

            def keep(opt_cfg, g, st, params):
                grads.update(g)
                return update(opt_cfg, g, st, params)

            step_mod.opt_update = keep
            try:
                zero_counts()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
            finally:
                step_mod.opt_update = update
            return metrics, grads, state, get_counts()

        policies = TRAIN_SMOKE_POLICIES + ((TRAIN_INT8_POLICY,) if a == 0 else ())
        for spec in policies:
            pol = parse_policy(spec)
            metrics, grads, state, counts = run(pol)
            core = dataclasses.replace(pol, backend="core", fused=True)
            metrics_c, grads_c, state_c, counts_c = run(core)
            check(all(v == 0 for v in counts_c.values()), f"{arch}: {core.spec} launched a kernel")
            check(math.isfinite(float(metrics["loss"])), f"{arch} {spec}: loss not finite")
            check_equal(metrics["loss"], metrics_c["loss"], f"{arch} {spec}: loss vs +core")
            for k, g in grads.items():
                check_equal(g, grads_c[k], f"{arch} {spec}: gradient of {k} vs +core")
            for (k, p), pc in zip(state.params.named_parameters(), state_c.params.parameters()):
                check_equal(p, pc, f"{arch} {spec}: new {k} vs +core")
            for k in state.opt.m:
                check_equal(state.opt.m[k], state_c.opt.m[k], f"{arch} {spec}: m of {k}")
                check_equal(state.opt.v[k], state_c.opt.v[k], f"{arch} {spec}: v of {k}")
            want = predicted_launches(spec, pol.moduli_set().n, 0, fwd + recompute + bwd, counts)
            check(counts == want, f"{arch} {spec}: launches {counts}, predicted {want}")
            launches.setdefault(arch, {})[spec] = {k: v for k, v in counts.items() if v}
        print(f"  smoke width {arch} ({cfg.family}): {fwd} forward + {bwd} backward GEMMs a "
              f"step; {len(policies)} policies, loss, gradients, new parameters and moments "
              f"== +core (bitwise), launches as predicted: {launches[arch][TRAIN_POLICY]} under "
              f"{TRAIN_POLICY}", flush=True)
    torch.cuda.empty_cache()
    return launches


def train_resume(args, dev) -> dict:
    """Phase 12 (c)'s resume: the Trainer at qwen2-7b's smoke width on
    TRAIN_POLICY, 4 steps straight against 2 steps, a restore from the
    CheckpointManager and 2 more: per-step losses and the final parameters
    and moments bitwise."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("qwen2-7b", "smoke", gemm=TRAIN_POLICY)
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name, steps):
            return Trainer(Model(cfg, device=dev), AdamWConfig(lr=1e-2, warmup_steps=1),
                           DataConfig(seed=args.seed, batch=4, seq_len=8,
                                      vocab_size=cfg.vocab_size),
                           TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=f"{tmp}/{name}",
                                         microbatches=2, seed=args.seed))

        straight, resumed = [], []
        want = trainer("straight", 4).run(straight)
        trainer("resumed", 2).run(resumed)
        second = trainer("resumed", 4)
        check(second.init_or_restore()[0] == 2, "the resumed Trainer did not restore step 2")
        got = second.run(resumed)
        check([m["loss"] for m in resumed] == [m["loss"] for m in straight],
              f"resume: losses {[m['loss'] for m in resumed]} vs {[m['loss'] for m in straight]}")
        for (k, p), q in zip(got.params.named_parameters(), want.params.parameters()):
            check_equal(p, q, f"resume: {k}")
        for k in want.opt.m:
            check_equal(got.opt.m[k], want.opt.m[k], f"resume: m of {k}")
            check_equal(got.opt.v[k], want.opt.v[k], f"resume: v of {k}")
        steps = second.ckpt.all_steps()
    torch.cuda.synchronize()
    print(f"  resume at qwen2-7b smoke width ({TRAIN_POLICY}): 4 steps straight == 2 steps, "
          f"restore, 2 more (losses, parameters and moments bitwise); checkpoints {steps}",
          flush=True)
    return {"losses": [m["loss"] for m in straight], "checkpoints": steps}


def train_phase(args, dev) -> dict:
    """Phase 12 (module docstring). Returns the kernels line's K1 row at the
    training shape and the phase's numbers."""
    import gc

    import torch

    full = train_full_width(args, dev)
    fp64 = train_fp64_grade(args, dev, full.pop("params"), full.pop("cfg"))
    gc.collect()
    torch.cuda.empty_cache()
    probe = determinism_probe(dev)
    smoke = train_smoke_width(args, dev)
    resume = train_resume(args, dev)
    t0 = time.perf_counter()
    long = train_full_width(args, dev, LONG_TRAIN_ARCH, LONG_TRAIN_LAYERS, LONG_TRAIN_STEPS,
                            native=False)
    del long["params"], long["cfg"]
    gc.collect()
    torch.cuda.empty_cache()
    long["numbers"]["seconds"] = time.perf_counter() - t0
    print(f"  (d) {LONG_TRAIN_ARCH} at full width: {long['numbers']['seconds']:.1f} s",
          flush=True)
    return {"k1_rows": [full["k1_row"], long["k1_row"]],
            "train": {"full_width": full["numbers"], "fp64_grade": fp64, "smoke_width": smoke,
                      "resume": resume, "determinism_probe": probe,
                      "long_vocabulary": long["numbers"]}}


# ---------------------------------------------------------------------------
# Phase 13: the distributed paths (core.distributed, linalg.dist)
# ---------------------------------------------------------------------------

#: (a)'s mesh: 2 x 4 ranks ("data", "model"), every one on the card.
DIST_MESH = (2, 4)
#: (b): the fast LU's grid; the ragged case's grid, at half the other's n
#: less 48 (2000 = 15 x 128 + 80 at the default size).
DIST_GRID, DIST_RAGGED = (2, 2), (48, (4, 1))
#: (c): run_hpl_dist's n is --hpl-n over this share. At n = 8192 it took
#: 54.87 s of a 1,027 s run (H100 80GB HBM3, 700.00 W); at half that n it
#: pays for phase 17, which drives the same entry point through
#: examples/torch_hpl_lu.py --grid 2x2, while phase 7 keeps accurate HPL at
#: --hpl-n.
DIST_HPL_SHARE = 2
DIST_FAST, DIST_ACCURATE = "ozaki2-fp8/fast", "ozaki2-fp8/accurate"
#: The 8-row sample of (a)'s accurate gates, held against a long-double product.
GATE_ROWS = 8


def dist_lu_updates(n: int, block: int, P: int, Q: int) -> int:
    """Rank GEMMs of lu_factor_dist's trailing updates: at every block step
    but the last, one per rank that owns trailing rows and columns."""
    nb = -(-n // block)
    total = 0
    for K in range(nb - 1):
        rows = sum(1 for p in range(P) if any(i % P == p for i in range(K + 1, nb)))
        cols = sum(1 for q in range(Q) if any(j % Q == q for j in range(K + 1, nb)))
        total += rows * cols
    return total


def dist_solve_gemms(n: int, block: int, P: int) -> int:
    """Rank GEMMs of one lu_solve_dist: at block step K of the forward sweep
    one per process row owning a block row below K, of the backward sweep
    one per process row owning a block row above it."""
    nb = -(-n // block)
    fwd = sum(1 for K in range(nb) for p in range(P) if any(i % P == p for i in range(K + 1, nb)))
    bwd = sum(1 for K in range(nb) for p in range(P) if any(i % P == p for i in range(K)))
    return fwd + bwd


def long_double_rows(a, b, rows):
    """Rows ``rows`` of a @ b in numpy's long double (64-bit mantissa on x86:
    its error, k 2^-64 |a||b|, is 2^-11 of the gate it serves), and of
    |a| @ |b| in f64."""
    import numpy as np

    ar, bn = a[rows].cpu().numpy(), b.cpu().numpy()
    exact = ar.astype(np.longdouble) @ bn.astype(np.longdouble)
    return exact, np.abs(ar) @ np.abs(bn)


def dist_gemm_phase(args, dev) -> tuple[list, dict]:
    """Phase 13 (a): the sharded GEMMs at args.size^3 on a 2 x 4 mesh of the
    card. Returns the kernels line's rows (K1, K2, K3, K4, K6 at the shard
    shapes, with (a)'s launches) and the phase's numbers."""
    import numpy as np
    import torch

    from repro_torch import kernels as kn
    from repro_torch import ozmm
    from repro_torch.core import distributed as dist
    from repro_torch.core.moduli import make_moduli_set
    from repro_torch.kernels import pipeline
    from repro_torch.kernels.fused import (KERNEL_TILE, fused_parts_args, ops,
                                           ozmm_fused_parts, ozmm_fused_parts_ref, ozmm_fused_raw,
                                           ozmm_fused_raw_ref, transpose_parts)
    from repro_torch.kernels.quant_residues import ops as qr_ops
    from repro_torch.launch import make_mesh

    big = args.size
    P, Q = DIST_MESH
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 13)
    a = lognormal(gen, (big, big), 0.5, dev)
    b = lognormal(gen, (big, big), 0.5, dev)
    mesh = make_mesh(DIST_MESH, ("data", "model"), devices=dev)
    get_counts, zero_counts = serve_counters()
    hyb, i8 = make_moduli_set("fp8-hybrid", 12), make_moduli_set("int8", 14)
    cases = {  # name -> (call, moduli set, predicted launches)
        "mn accurate": (lambda: dist.ozmm_mn_sharded(a, b, mesh, mode="accurate"), hyb,
                        {"K1": P * Q, "K1 prologue": 2 * P * Q}),
        "mn fast": (lambda: dist.ozmm_mn_sharded(a, b, mesh, mode="fast"), hyb,
                    {"K2": P * Q, "K2 transpose": P * Q}),
        "k fast": (lambda: dist.ozmm_k_sharded(a, b, mesh, mode="fast"), hyb,
                   {"K6": 2 * Q, "K3": 3 * hyb.n * Q}),
        "k accurate": (lambda: dist.ozmm_k_sharded(a, b, mesh, mode="accurate"), hyb,
                       {"K6": 2 * Q, "K3": 3 * hyb.n * Q}),
        "k int8 fast": (lambda: dist.ozmm_k_sharded(a, b, mesh, family="int8", mode="fast"), i8,
                        {"K6": 2 * Q, "K4": i8.n * Q}),
    }
    outs, launches = {}, {}
    with FirstCallPerShape(ops, "ozmm_fused_raw") as c1, \
            FirstCallPerShape(ops, "ozmm_fused_parts") as c2, \
            FirstCallPerShape(pipeline, "fp8_gemm") as c3, \
            FirstCallPerShape(pipeline, "int8_gemm") as c4, \
            FirstCallPerShape(qr_ops, "quant_residues_f64") as c6:
        for name, (call, _, want) in cases.items():
            zero_counts()
            outs[name] = call()
            torch.cuda.synchronize()
            counts = {k: v for k, v in get_counts().items() if v}
            check(counts == want, f"sharded {name}: launches {counts}, predicted {want}")
            launches[name] = counts
            print(f"  sharded {name} {big}^3 on a {P}x{Q} mesh of {dev}: launches {counts} "
                  "as predicted", flush=True)
    # (a) checks: the single-device ozmm, each shard against +core
    single = {spec: ozmm(a, b, spec) for spec in
              ("ozaki2-fp8/fast", "ozaki2-fp8/accurate", "ozaki2-int8/fast")}
    check_equal(outs["k fast"], single["ozaki2-fp8/fast"], "k-sharded fast vs single-device ozmm")
    check_equal(outs["mn fast"], single["ozaki2-fp8/fast"], "mn-sharded fast vs single-device ozmm")
    check_equal(outs["k int8 fast"], single["ozaki2-int8/fast"],
                "k-sharded int8 fast vs single-device ozmm")
    rb, cb = big // P, big // Q
    for mode in ("accurate", "fast"):
        for i in range(P):
            for j in range(Q):
                rs, cs = slice(i * rb, (i + 1) * rb), slice(j * cb, (j + 1) * cb)
                core = dist.mn_shard(a[rs], b[:, cs], hyb, mode, "core")
                check_equal(outs[f"mn {mode}"][rs, cs], core,
                            f"mn-sharded {mode} block ({i}, {j}) vs +core on that block")
                del core
    kb = big // Q
    for name, ms, mode in (("k fast", hyb, "fast"), ("k accurate", hyb, "accurate"),
                           ("k int8 fast", i8, "fast")):
        a_sh = [a[:, s * kb:(s + 1) * kb] for s in range(Q)]
        b_sh = [b[s * kb:(s + 1) * kb] for s in range(Q)]
        lmu, lnu = dist.k_sharded_exponents(a_sh, b_sh, big, ms, mode, dev)
        for s in range(Q):
            kern = dist.k_shard_residues(a_sh[s], b_sh[s], lmu, lnu, ms, "pallas")
            core = dist.k_shard_residues(a_sh[s], b_sh[s], lmu, lnu, ms, "core")
            for l, (x, y) in enumerate(zip(kern, core)):
                check_equal(x, y, f"k-sharded {name} shard {s} modulus {l}: kernels vs +core")
            del kern, core
        torch.cuda.empty_cache()
    print(f"  sharded: k fast (fp8, int8) and mn fast == single-device ozmm; every mn block "
          f"(both modes) and every k shard's residue products == +core (bitwise)", flush=True)
    rows = list(range(0, big, big // GATE_ROWS))[:GATE_ROWS]
    exact, denom = long_double_rows(a, b, rows)
    errs = {}
    for name, c in (("k accurate", outs["k accurate"]), ("single", single["ozaki2-fp8/accurate"]),
                    ("mn accurate", outs["mn accurate"])):
        errs[name] = float(np.max(np.abs(c[rows].cpu().numpy() - exact) / denom))
    check(errs["k accurate"] < 2.0 ** -49, f"k-sharded accurate error {errs['k accurate']} "
                                           ">= 2^-49")
    check(errs["k accurate"] <= 4 * max(errs["single"], 2.0 ** -53),
          f"k-sharded accurate error {errs['k accurate']} > 4x the unsharded {errs['single']}")
    check(errs["mn accurate"] < 2.0 ** -49, f"mn-sharded accurate error {errs['mn accurate']}")
    print(f"  accurate gates on {GATE_ROWS} rows vs a long-double product (componentwise, over "
          f"|A||B|): k-sharded {errs['k accurate']:.3e}, mn-sharded {errs['mn accurate']:.3e}, "
          f"single-device {errs['single']:.3e} (gates 2^-49 = {2.0 ** -49:.3e}, 4x single)",
          flush=True)
    del outs, single
    torch.cuda.empty_cache()

    # timings: each strategy beside the single-device ozmm and cuBLAS DGEMM
    times = {name: cuda_ms(call, 3) for name, (call, _, _) in cases.items()}
    for spec in ("ozaki2-fp8/fast", "ozaki2-fp8/accurate", "ozaki2-int8/fast"):
        times[f"single {spec}"] = cuda_ms(lambda: ozmm(a, b, spec), 3)
    times["cuBLAS DGEMM"] = cuda_ms(lambda: torch.matmul(a, b))
    print("  ms a call at " + f"{big}^3: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()),
          flush=True)

    # the kernels at their first shard shape, against their plain versions
    kernel_rows = []
    one = torch.ones((), dtype=torch.float32, device=dev)
    firsts = {
        "K1": (c1, ozmm_fused_raw, ozmm_fused_raw_ref, "ozmm_fused_raw", "mn accurate",
               "src/repro_torch/csrc/fused_raw.cu", "src/repro/kernels/fused/kernel.py:238"),
        "K2": (c2, ozmm_fused_parts, ozmm_fused_parts_ref, "ozmm_fused_parts", "mn fast",
               "src/repro_torch/csrc/fused_parts.cu", "src/repro/kernels/fused/kernel.py:265"),
        "K3": (c3, kn.fp8_gemm, kn.fp8_gemm_plain, "fp8_gemm", "k fast",
               "src/repro_torch/csrc/residue_gemm.cu", "src/repro/kernels/fp8_gemm/kernel.py:34"),
        "K4": (c4, kn.int8_gemm, kn.int8_gemm_plain, "int8_gemm", "k int8 fast",
               "src/repro_torch/csrc/residue_gemm.cu", "src/repro/kernels/int8_gemm/kernel.py:25"),
        "K6": (c6, kn.quant_residues_f64, kn.quant_residues_f64_plain, "quant_residues",
               "k fast", "src/repro_torch/csrc/quant_residues.cu",
               "src/repro/kernels/quant_residues/kernel.py:77"),
    }
    for tag, (kept, kern, plain, name, case, source, replaces) in firsts.items():
        n_shapes = len(kept.calls)
        args_, kw = next(iter(kept.calls.values()))
        kw = {k: v for k, v in kw.items() if k != "out"}  # K3/K4 write a product plane
        got, ref = kern(*args_, **kw), plain(*args_, **kw)
        outs_k = list(got) if isinstance(got, tuple) else [got]
        outs_p = list(ref) if isinstance(ref, tuple) else [ref]
        for g, r in zip(outs_k, outs_p):
            check_equal(as_bytes(g), as_bytes(r), f"phase 13 {tag} at its shard shape vs plain")
        err = max(max_abs_err(g, r) for g, r in zip(outs_k, outs_p))
        del got, ref, outs_k, outs_p
        torch.cuda.empty_cache()
        ms_k = cuda_ms(lambda: kern(*args_, **kw))
        ms_p = cuda_ms(lambda: plain(*args_, **kw), 3)
        ms_set = cases[case][1]
        prods = ms_set.n if ms_set.family == "int8" else 3 * ms_set.n
        if tag in ("K1", "K2"):
            m, k, n = rb, big, cb
            n_ops = prods * 2 * m * k * n
            n_bytes = (sum(t.numel() * t.element_size() for t in args_ if hasattr(t, "numel"))
                       + 8 * m * n) if tag == "K1" else part_bytes(ms_set, m, k, n)
            am, bm = a[:m], b[:, :n]
            lib = lambda: torch.matmul(am, bm)  # noqa: E731
        elif tag in ("K3", "K4"):
            x, y = args_[0], args_[1]
            m, k, n = x.shape[0], x.shape[1], y.shape[1]
            n_ops, n_bytes = 2 * m * k * n, m * k + k * n + 4 * m * n
            if tag == "K4":
                yc = y.contiguous()
                lib = lambda: torch._int_mm(x, yc)  # noqa: E731
            else:
                lib = lambda: torch._scaled_mm(x, y, scale_a=one, scale_b=one,  # noqa: E731
                                               out_dtype=torch.float32, use_fast_accum=False)
        else:
            m, k = args_[0].shape
            n = None
            n_ops, n_bytes = 0, (8 + 3 * ms_set.n) * m * k + 4 * m + 4 * ms_set.n * 1024
            lib = None
        ms_l = cuda_ms(lib) if lib else None
        t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP8_OPS_PER_S * 1e3
        row = {"name": name, "tag": tag, "phase": 13, "case": case,
               "shape": [m, k] + ([n] if n else []), "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[case].get(tag, 0), "max_abs_err": err,
               "ms": ms_k, "plain_ms": ms_p, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes > t_ops else "operations", "library_ms": ms_l,
               "shapes_seen": n_shapes}
        kernel_rows.append(row)
        lib_txt = f"{ms_l:.3f} ms" if ms_l is not None else "none"
        print(f"  {tag} {name} at {row['shape']} ({case}; {n_shapes} distinct input shapes): "
              f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, library {lib_txt}, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}), launches {row['launches']}, "
              f"== plain (bitwise)", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return kernel_rows, {"launches": launches, "ms": times, "accurate_errors": errs}


def dist_lu_phase(args, dev, hpl_rows) -> dict:
    """Phase 13 (b) and (c): lu_factor_dist under ozaki2-fp8/fast, both
    wires, bitwise against the single-device lu_factor (and a ragged n on
    4 x 1), then run_hpl_dist under ozaki2-fp8/accurate beside phase 7's
    single-device run. Returns the phase's numbers."""
    import numpy as np
    import torch

    from repro_torch import linalg
    from repro_torch.linalg import dist as ldist
    from repro_torch.linalg.dist import grid as dgrid
    from repro_torch.linalg.dist import lu as dlu
    from repro_torch.linalg.dist import trsm as dtrsm

    get_counts, zero_counts = serve_counters()
    out = {"lu": []}
    hn = args.hpl_n
    n4 = hn // 2
    for n, grid, wires in ((n4, DIST_GRID, ("plans", "f64")),
                           (n4 // 2 - DIST_RAGGED[0], DIST_RAGGED[1], ("plans",))):
        a, _ = linalg.hpl_matrix(n, seed=args.seed + 13)
        ts = time.perf_counter()
        lu_s, perm_s = linalg.lu_factor(a, DIST_FAST, block=HPL_BLOCK)
        single_s = time.perf_counter() - ts
        updates = dist_lu_updates(n, HPL_BLOCK, *grid)
        for wire in wires:
            zero_counts()
            with CallTotals(dlu, "pivot_argmax", events=False) as t_piv, \
                    CallTotals(dlu, "rank1_update", events=False) as t_rank1, \
                    CallTotals(dlu, "prepare", events=False) as t_prep, \
                    CallTotals(dlu, "broadcast_plan", events=False) as t_wire, \
                    CallTotals(dlu, "device_matmul") as t_gemm:
                torch.cuda.synchronize()
                ts = time.perf_counter()
                lu_d, perm_d, st = ldist.lu_factor_dist(a, DIST_FAST, grid=grid, block=HPL_BLOCK,
                                                        panel_wire=wire)
                torch.cuda.synchronize()
                secs = time.perf_counter() - ts
            counts = {k: v for k, v in get_counts().items() if v}
            want = ({"K2": updates, "K2 transpose": updates} if wire == "plans"
                    else {"K1": updates, "K1 prologue": 2 * updates})
            check(counts == want, f"dist LU n={n} {grid} {wire}: launches {counts}, "
                                  f"predicted {want}")
            check(np.array_equal(perm_d, perm_s), f"dist LU n={n} {grid} {wire}: pivots differ "
                                                  "from lu_factor's")
            check(np.array_equal(lu_d.to_global(), lu_s),
                  f"dist LU n={n} {grid} {wire}: factors differ from lu_factor's")
            row = {"n": n, "grid": f"{grid[0]}x{grid[1]}", "panel_wire": wire, "seconds": secs,
                   "single_device_seconds": single_s, "launches": counts,
                   **{k: st[k] for k in ("wire_bytes", "f64_bytes", "swap_bytes",
                                         "panel_bcast_bytes", "pivot_collectives")},
                   **{f"{k}_s": v for k, v in st["timings"].items()},
                   "pivot_search_s": t_piv.seconds(), "rank1_s": t_rank1.seconds(),
                   "quantize_s": t_prep.seconds(), "wire_s": t_wire.seconds(),
                   "rank_gemms_s": t_gemm.seconds(), "rank_gemms": len(t_gemm.spans)}
            out["lu"].append(row)
            print(f"  dist LU {DIST_FAST} n={n} block {HPL_BLOCK} {row['grid']} {wire} wire: "
                  f"{secs:.2f} s (single-device lu_factor {single_s:.2f} s), == lu_factor "
                  f"(factors and pivots, bitwise); launches {counts} as predicted; wire "
                  f"{st['wire_bytes']} B (f64 {st['f64_bytes']} B), swaps {st['swap_bytes']} B; "
                  f"panel {row['panel_s']:.2f} s (pivot search {row['pivot_search_s']:.2f}, "
                  f"rank-1 {row['rank1_s']:.2f}), U12 {row['trsm_s']:.2f} s, broadcast "
                  f"{row['broadcast_s']:.2f} s (quantize {row['quantize_s']:.2f}, wire "
                  f"{row['wire_s']:.2f}), update {row['update_s']:.2f} s "
                  f"({row['rank_gemms']} rank GEMMs, {row['rank_gemms_s']:.2f} s by events)",
                  flush=True)
            del lu_d
        del a, lu_s

    # (c) the distributed HPL, accurate mode, beside phase 7's single-device run
    hn = args.hpl_n // DIST_HPL_SHARE
    k1_want, _ = dist_hpl_launches(DIST_ACCURATE, hn, HPL_BLOCK, *DIST_GRID)
    zero_counts()
    with CallTotals(dlu, "pivot_argmax", events=False) as t_piv, \
            CallTotals(dgrid, "argmax_allreduce", events=False) as t_red, \
            CallTotals(dlu, "device_matmul") as t_upd, \
            CallTotals(dtrsm, "device_matmul") as t_sol:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        res = ldist.run_hpl_dist(hn, DIST_ACCURATE, grid=DIST_GRID, block=HPL_BLOCK,
                                 refine_steps=1, seed=args.seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - ts
    counts = {k: v for k, v in get_counts().items() if v}
    want = {"K1": k1_want, "K1 prologue": 2 * k1_want}
    check(res["passed"], f"dist HPL: scaled residual {res['scaled_residual']} > 16")
    check(counts == want, f"dist HPL: launches {counts}, predicted {want}")
    single = next((r for r in hpl_rows if r["policy"] == DIST_ACCURATE), None)
    out["hpl"] = {k: v for k, v in res.items() if k != "refine_history"}
    out["hpl"].update(seconds=secs, launches=counts, pivot_search_s=t_piv.seconds(),
                      pivot_allreduce_s=t_red.seconds(), update_gemms_s=t_upd.seconds(),
                      solve_gemms_s=t_sol.seconds(),
                      refine_s=res["epilogue_seconds"] - res["solve_seconds"],
                      refine_history=res["refine_history"],
                      single_device=single and {k: single[k] for k in
                                                ("n", "seconds", "gflops", "scaled_residual")})
    t = res["timings"]
    print(f"  dist HPL {DIST_ACCURATE} n={hn} block {HPL_BLOCK} {res['grid']}: {secs:.2f} s; "
          f"factor {res['factor_seconds']:.2f} s (panel {t['panel']:.2f}, of it pivot search "
          f"{out['hpl']['pivot_search_s']:.2f}, pivot allreduce on the mesh "
          f"{out['hpl']['pivot_allreduce_s']:.2f}; U12 {t['trsm']:.2f}; broadcast "
          f"{t['broadcast']:.2f}; update {t['update']:.2f}, rank GEMMs by events "
          f"{out['hpl']['update_gemms_s']:.2f}), solve {res['solve_seconds']:.2f} s, refine "
          f"{out['hpl']['refine_s']:.2f} s (solve GEMMs by events "
          f"{out['hpl']['solve_gemms_s']:.2f}); {res['gflops']:.2f} GFLOP/s by HPL's count "
          f"(factor + solve); scaled residual {res['scaled_residual']:.3e}; wire "
          f"{res['wire_bytes']} B + epilogue {res['epilogue_wire_bytes']} B; launches {counts} "
          "as predicted" + (f"; phase 7 single-device (n={single['n']}): "
                            f"{single['seconds']:.2f} s, "
                            f"{single['gflops']:.2f} GFLOP/s, residual "
                            f"{single['scaled_residual']:.3e}" if single else ""), flush=True)
    return out


def dist_phase(args, dev, hpl_rows) -> dict:
    """Phase 13 (module docstring). Returns the kernels line's rows at the
    shard shapes and the phase's numbers."""
    t0 = time.perf_counter()
    rows, gemms = dist_gemm_phase(args, dev)
    t1 = time.perf_counter()
    lu = dist_lu_phase(args, dev, hpl_rows)
    print(f"  phase 13: (a) {t1 - t0:.1f} s, (b) + (c) {time.perf_counter() - t1:.1f} s",
          flush=True)
    return {"kernel_rows": rows, "dist": {"sharded": gemms, **lu}}


#: Phase 14: the perf sweep's timed calls a cell (its warm-up and reps).
SWEEP_REPS = 3
#: The shape of phase 14's K1 row: qwen2-7b's decode MLP up-projection.
SWEEP_ROW_SHAPE = (4, 3584, 18944)


def perf_phase(args, dev) -> dict:
    """Phase 14 (module docstring): the perf sweep on the card, its checks,
    resolve_fastest on its candidate, and its rows through the trajectory
    store."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.perf import (PerfModel, append_results, compare_results,
                                  hardware_fingerprint, make_results_doc, make_row,
                                  resolve_fastest, validate_results)
    from repro_torch.perf import model as perf_model
    from repro_torch.perf import sweep
    from repro_torch.precision import parse_policy
    from repro_torch.precision.resolve import operand_spread_log2

    get, zero = serve_counters()
    calls = SWEEP_REPS + 1
    state = {"last": None, "core": None, "checked": 0}

    def on_cell(cell, out):
        counts = get()
        moved = {k: counts[k] - state["last"][k] for k in counts}
        state["last"] = counts
        pol = parse_policy(cell["spec"])
        n_mod, route = pol.moduli_set().n, cell["route"]
        want = {k: 0 for k in counts}
        if route == "pallas":
            want.update({"K1": calls, "K1 prologue": 2 * calls})
        elif route == "unfused":
            int8 = pol.family == "int8"
            want.update({"K6": 2 * calls, "K5": calls,
                         ("K4" if int8 else "K3"): (1 if int8 else 3) * n_mod * calls})
        what = f"{cell['spec']} {cell['m']}x{cell['k']}x{cell['n']}"
        check(moved == want, f"sweep {what}: launches {moved}, predicted {want}")
        check(out.shape == (cell["m"], cell["n"]) and bool(torch.isfinite(out).all()),
              f"sweep {what}: output not finite or of the wrong shape")
        base = cell["spec"][:len(cell["spec"]) - len(sweep._ROUTE_SUFFIX[route])]
        key = (cell["m"], cell["k"], cell["n"], base)
        if route == "core":
            state["core"] = (key, out)
        else:
            check(state["core"] is not None and state["core"][0] == key,
                  f"sweep {what}: no +core cell before it")
            check_equal(out, state["core"][1], f"sweep {what} vs +core")
            state["checked"] += 1

    zero()
    state["last"] = get()
    t0 = time.perf_counter()
    result = sweep.run_sweep(sweep.FULL_SHAPES, sweep.FULL_SPECS, sweep.FULL_ROUTES,
                             sweep.DEFAULT_TIERS, reps=SWEEP_REPS, device=dev, on_cell=on_cell,
                             log=lambda *_: None,
                             generated_by="chip_smoke.py phase 14 (python -m "
                                          "repro_torch.perf.sweep's full grid, reps 3)")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = get()
    state["core"] = None
    cells, cand = result["cells"], result["candidate"]
    n_specs = len(sweep.expand_specs(sweep.FULL_SPECS))
    check(len(cells) == len(sweep.FULL_SHAPES) * n_specs * len(sweep.FULL_ROUTES),
          f"sweep: {len(cells)} cells")
    check(state["checked"] == len(sweep.FULL_SHAPES) * n_specs * 2,
          f"sweep: {state['checked']} kernel-route cells held against +core")
    print(f"  sweep: {len(cells)} cells ({len(sweep.FULL_SHAPES)} shapes x {n_specs} specs x "
          f"{len(sweep.FULL_ROUTES)} routes, {calls} calls each) in {sweep_s:.1f} s; every "
          f"+pallas and +pallas+unfused C == its +core C (bitwise); launches {launches} as "
          "predicted cell by cell", flush=True)

    def swept_key(spec):
        """A spec's policy with its modulus count spelt out: '@13' and the
        default name one cell."""
        pol = parse_policy(spec)
        return pol.scheme, pol.mode, pol.moduli_set().n, pol.backend, pol.fused

    # the grid holds each family's floor at each tier: whatever a preset entry
    # is clamped up to was measured
    swept = {swept_key(s) for s in sweep.expand_specs(sweep.FULL_SPECS)}
    for shape in sweep.FULL_SHAPES:
        a_np, b_np = sweep.draw_operands(*shape)
        spread = operand_spread_log2(a_np) + operand_spread_log2(b_np)
        del a_np, b_np
        floors = {}
        for scheme, mode in sorted({key[:2] for key in swept}):
            base = parse_policy(f"{scheme}/{mode}")
            floors[f"{scheme}/{mode}"] = [
                base.resolve_for(None, None, t, k=shape[1], spread_log2=spread).num_moduli
                for t in sweep.DEFAULT_TIERS]
            for n_floor in floors[f"{scheme}/{mode}"]:
                check((scheme, mode, n_floor, "auto", True) in swept,
                      f"sweep: {scheme}/{mode}@{n_floor}, a floor at "
                      f"{'x'.join(map(str, shape))}, is not in the grid")
        print(f"  floors at {'x'.join(map(str, shape))} (tiers {sweep.DEFAULT_TIERS}): "
              + ", ".join(f"{fam} {v}" for fam, v in floors.items()) + "; all swept")

    m, k, n = sweep.FULL_SHAPES[0]
    bucket = next(c["shape_bucket"] for c in cells if (c["m"], c["k"], c["n"]) == (m, k, n))
    for key, front in result["pareto"].items():
        print(f"  pareto {key}: " + "; ".join(
            f"{c['spec']} {c['wall_seconds'] * 1e3:.3f} ms {c['rel_err']:.2e}" for c in front))
    for e in cand.entries:
        print(f"  winner {e.shape_bucket}@{e.backend} tier {e.tier:g}: {e.spec} "
              f"{e.wall_seconds * 1e3:.3f} ms, rel_err {e.rel_err:.2e}")
    for miss in result["unmet_tiers"]:
        print(f"  sweep: no cell met {miss}")
    tiers_met = {e.tier for e in cand.entries if e.shape_bucket == bucket}
    check(tiers_met == set(sweep.DEFAULT_TIERS),
          f"sweep: tiers met at {bucket}: {sorted(tiers_met)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "preset_candidate.json")
        cand.save(path)
        loaded = PerfModel.load(path)
        check(loaded.entries == cand.entries, "the candidate does not round-trip")

        # resolve_fastest on the swept operands: the candidate's winner, never
        # below the resolver's floor, its measured error within the tier; with
        # no preset, resolve_for's answer; with no model named, what the
        # checked-in card preset gives, as a user gets it
        a_np, b_np = sweep.draw_operands(m, k, n)
        a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
        by_spec = {swept_key(c["spec"]): c for c in cells
                   if (c["m"], c["k"], c["n"]) == (m, k, n)}
        perf_model.clear_default_model()
        card_preset = PerfModel.load(os.path.join(perf_model.PRESETS_DIR, "h100-sm90.json"))
        check(card_preset.fresh(hardware_fingerprint(dev)),
              "presets/h100-sm90.json is not fresh on this card")
        check(perf_model.default_model(device=dev) is not None,
              "no checked-in preset is fresh on this card")
        resolved = {}
        for tier in sweep.DEFAULT_TIERS:
            got = resolve_fastest(a, b, tier, model=loaded)
            floor = parse_policy(got.spec).resolve_for(a, b, tier).num_moduli
            check(got.num_moduli >= floor, f"resolve_fastest {tier:g}: {got.spec} below the "
                                           f"floor of {floor} moduli")
            cell = by_spec.get(swept_key(got.spec))
            check(cell is not None and cell["rel_err"] <= tier,
                  f"resolve_fastest {tier:g}: {got.spec} not swept or measured "
                  f"{cell and cell['rel_err']}")
            check(loaded.lookup(m, k, n, dev.type, tier) is not None,
                  f"resolve_fastest {tier:g}: the candidate has no entry")
            shipped = resolve_fastest(a, b, tier)
            want = resolve_fastest(a, b, tier, model=card_preset)
            shipped_cell = by_spec.get(swept_key(shipped.spec))
            check(card_preset.lookup(m, k, n, dev.type, tier) is not None and shipped == want
                  and shipped_cell is not None and shipped_cell["rel_err"] <= tier,
                  f"resolve_fastest {tier:g} with the checked-in presets: {shipped.spec}, "
                  f"presets/h100-sm90.json gives {want.spec}, measured "
                  f"{shipped_cell and shipped_cell['rel_err']}")
            perf_model.set_default_model(None)
            plain = resolve_fastest(a, b, tier)
            perf_model.clear_default_model()
            check(plain == parse_policy("ozaki2-fp8/fast").resolve_for(a, b, tier),
                  f"resolve_fastest {tier:g} without a preset: {plain.spec}")
            resolved[f"{tier:g}"] = {"candidate": got.spec, "floor": floor,
                                     "rel_err": cell["rel_err"], "no_preset": plain.spec,
                                     "shipped": shipped.spec,
                                     "shipped_ms": shipped_cell["wall_seconds"] * 1e3,
                                     "shipped_rel_err": shipped_cell["rel_err"]}
            print(f"  resolve_fastest {tier:g} at {m}x{k}x{n}: {got.spec} (floor {floor} "
                  f"moduli, measured {cell['wall_seconds'] * 1e3:.3f} ms, "
                  f"{cell['rel_err']:.2e}); without a preset {plain.spec}; with the "
                  f"checked-in presets {shipped.spec} (measured "
                  f"{shipped_cell['wall_seconds'] * 1e3:.3f} ms, "
                  f"{shipped_cell['rel_err']:.2e})", flush=True)
        del a, b

        # the cells as schema-v2 rows, through a trajectory store
        rows = [make_row("perf_sweep", f"{c['spec']}@{c['m']}x{c['k']}x{c['n']}",
                         c["wall_seconds"], policy=c["spec"],
                         throughput=2 * c["m"] * c["k"] * c["n"] / c["wall_seconds"] / 1e12,
                         throughput_unit="TF-equiv", accuracy=c["rel_err"],
                         accuracy_gate=max(sweep.DEFAULT_TIERS), route=c["route"],
                         mma_ops=c["mma_ops"], residue_bytes=c["residue_bytes"])
                for c in cells]
        doc = validate_results(make_results_doc(rows, policy_specs=list(sweep.FULL_SPECS),
                                                argv=["chip_smoke.py"], device=dev))
        store = os.path.join(tmp, "trajectory")
        seeded = compare_results(doc, store)["status"]
        written = append_results(doc, store)
        report = compare_results(doc, store)
        check(seeded == "baseline-seeded" and written == len(rows) and report["status"] == "ok"
              and not report["accuracy_breaches"],
              f"trajectory: {seeded}, {written} rows, then {report['status']} "
              f"{report['regressions']} {report['accuracy_breaches']}")
        print(f"  rows: {len(rows)} schema-v2 rows validated; trajectory store: {seeded}, "
              f"{written} appended, compared against themselves: {report['status']} "
              f"({len(report['rows'])} report rows, no accuracy breach)", flush=True)

    # the kernels line's row: K1 at the decode shape, with the sweep's launches
    gen = np.random.default_rng(args.seed + 14)
    dm, dk, dn = SWEEP_ROW_SHAPE
    a = torch.from_numpy(gen.standard_normal((dm, dk))).to(dev)
    b = torch.from_numpy(gen.standard_normal((dk, dn))).to(dev)
    row = k1_train_row(a, b, launches["K1"], spec="ozaki2-fp8/fast@12",
                       what="qwen2-7b's decode MLP up-projection")
    del a, b
    torch.cuda.empty_cache()
    return {"k1_row": row, "perf": {
        "seconds_sweep": sweep_s, "launches": launches, "resolved": resolved,
        "cells": [{k: c[k] for k in ("spec", "route", "m", "k", "n", "wall_seconds",
                                     "rel_err")} for c in cells],
        "winners": [e.to_dict() for e in cand.entries],
        "pareto": {key: [c["spec"] for c in front] for key, front in result["pareto"].items()},
        "unmet_tiers": result["unmet_tiers"]}}


#: Phase 15 (a): the GPipe pipeline over PIPE_LAYERS of qwen2-7b's decoder
#: layers at full width, one a stage on a "stage" mesh of the card, PIPE_M
#: microbatches of PIPE_MB sequences x PIPE_SEQ tokens.
PIPE_ARCH, PIPE_POLICY = "qwen2-7b", "ozaki2-fp8/fast"
PIPE_LAYERS, PIPE_M, PIPE_MB, PIPE_SEQ = 4, 6, 2, 512
#: (b): the sharded training step at full width, SPMD_LAYERS deep (the
#: single-device step peaked at 70.54 GB at 2 layers in phase 12: the
#: sharded state and the gathered leaves take the room of the second), on
#: these meshes ("data", "model") of the card, a batch of SPMD_BATCH x
#: SPMD_SEQ tokens.
SPMD_LAYERS, SPMD_BATCH, SPMD_SEQ = 1, 2, 256
SPMD_MESHES = ((1, 4), (2, 2))
#: (b)'s gates on the (2, 2) step against the whole-batch step: the loss
#: within the reference's 1e-4 (tests/distribution/test_sharded_train.py),
#: and the data ranks' mean gradient within SPMD_GRAD_TOL of the whole
#: batch's, normwise in every leaf. The mean is the one the sharded step
#: used: the one-device oracle that computes it is held bitwise to the
#: step's state. The gradients are bf16 compute's, each data rank's rounded
#: on its own. The bound lies between the sound reading and a planted fault
#: (one data rank's rows dropped), both printed and checked each run.
SPMD_LOSS_TOL, SPMD_GRAD_TOL = 1e-4, 2e-2
#: (c): the dry run's cells, on the production mesh of meta devices.
DRYRUN_CELLS = (("qwen2-7b", "train_4k"), ("qwen2-7b", "decode_32k"))


def pipeline_part(args, dev) -> tuple[dict, dict]:
    """Phase 15 (a) (module docstring). Returns its numbers and K1's row."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distribution.pipeline import pipeline_apply
    from repro_torch.launch import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.attention import AttnTemporal
    from repro_torch.models.blocks import block_apply, stage_windows

    get_counts, zero_counts = serve_counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(PIPE_ARCH, "full"), num_layers=PIPE_LAYERS,
                              gemm=PIPE_POLICY)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 15)
    layers = list(model.init(gen).stages[0])
    windows = stage_windows(cfg, model.stages[0].spec, 0)
    t = AttnTemporal(positions=model._positions(PIPE_MB, PIPE_SEQ), cache_len=None, pos=None)
    x = torch.randn((PIPE_M, PIPE_MB, PIPE_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(model.dtype)
    mesh = make_mesh((PIPE_LAYERS,), ("stage",), devices=dev)

    def stage(lw, h):
        return block_apply(lw[0], h, cfg, t, lw[1], {}, "attn_mlp")[0]

    stages = list(zip(layers, windows))
    with torch.no_grad():
        zero_counts()
        torch.cuda.synchronize()
        tp = time.perf_counter()
        out = pipeline_apply(stage, stages, x, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tp
        counts = get_counts()
        seq = []
        for mb in range(PIPE_M):
            h = x[mb]
            for lw in stages:
                h = stage(lw, h)
            seq.append(h)
        seq = torch.stack(seq)
    gemms = 7 * PIPE_LAYERS * PIPE_M  # q, k, v, o, gate, up, down a layer and microbatch
    want = {k: 0 for k in counts}
    want.update({"K1": gemms, "K1 prologue": 2 * gemms})
    check(counts == want, f"pipeline launches {counts}, predicted {want}")
    check(out.shape == x.shape and bool(torch.isfinite(out).all()),
          "pipeline output not finite or of the wrong shape")
    check_equal(out, seq, "the pipeline vs the sequential stack")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (a) pipeline_apply: {cfg.name} {PIPE_LAYERS} of 28 layers (d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, {cfg.num_heads}/{cfg.num_kv_heads} heads) on a {PIPE_LAYERS}-rank "
          f"'stage' mesh of the card, {PIPE_M} microbatches of {PIPE_MB} x {PIPE_SEQ} tokens, "
          f"{PIPE_POLICY}: {PIPE_M + PIPE_LAYERS - 1} steps in {secs:.2f} s; == the sequential "
          f"stack (bitwise); K1 {counts['K1']} launches (prologue {counts['K1 prologue']}, K2-K6 "
          f"0, as predicted); peak {peak:.2f} GB", flush=True)
    rows = PIPE_MB * PIPE_SEQ
    a = torch.randn((rows, cfg.d_model), generator=gen, device=dev, dtype=torch.float64)
    w_up = layers[0].mlp.w_up.detach().to(torch.float64)
    del out, seq, x, layers, stages
    gc.collect()
    torch.cuda.empty_cache()
    row = k1_train_row(a, w_up, counts["K1"], PIPE_POLICY,
                       what="the pipeline's MLP up-projection")
    del a, w_up
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": PIPE_LAYERS, "microbatches": PIPE_M, "seconds": secs, "peak_gb": peak,
            "launches": counts}, row


def dp_oracle_step(model, opt_cfg, state, batch, n_data: int):
    """The sharded step's function on one device, from the port's
    single-device pieces: ``batch_grads`` on each data rank's rows, the
    gradients summed in rank order and divided, ``optim.update`` on whole
    leaves (in place). Returns the loss (the data ranks' mean), the mean
    gradient and data rank 0's gradient alone, by leaf."""
    import torch

    from repro_torch.core.collectives import reduce_ranks
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import update
    from repro_torch.precision import resolve_pinned_policy, use_policy
    from repro_torch.train.step import batch_grads

    dev = model.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    leaves = reference_leaves(state.params)
    rows = -(-next(iter(batch.values())).shape[0] // n_data)
    grads, losses = [], []
    with use_policy(resolve_pinned_policy(model.cfg.gemm, None)):
        for d in range(n_data):
            g, m = batch_grads(model, state.params, leaves,
                               {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
            grads.append(g)
            losses.append(m["loss"])
        first = dict(grads[0])
        mean = {k: reduce_ranks([g.pop(k) for g in grads], torch.add, dev).div_(n_data)
                for k in leaves}
        update(opt_cfg, mean, state.opt, leaves)
    return float(reduce_ranks(losses, torch.add, dev) / n_data), mean, first


def rel_norm(x, ref) -> float:
    """||x - ref|| / ||ref||, in f64."""
    import torch

    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / max(float(torch.linalg.norm(ref)), 1e-300))


def spmd_part(args, dev) -> tuple[dict, dict]:
    """Phase 15 (b) (module docstring). Returns its numbers and K1's row."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.distribution.spmd import make_sharded_train_step
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.precision import resolve_pinned_policy, use_policy
    from repro_torch.train import make_train_step
    from repro_torch.train.step import batch_grads

    get_counts, zero_counts = serve_counters()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(PIPE_ARCH, "full"), num_layers=SPMD_LAYERS,
                              gemm=PIPE_POLICY)
    model = Model(cfg, device=dev)
    opt_cfg = AdamWConfig()
    init_state, step = make_train_step(model, opt_cfg)
    batch = synth_batch(DataConfig(seed=args.seed, batch=SPMD_BATCH, seq_len=SPMD_SEQ,
                                   vocab_size=cfg.vocab_size), cfg, 0)
    fwd, recompute, bwd = train_gemms(cfg)
    per_grad = fwd + recompute + bwd

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 16)
        return init_state(gen)

    def run(fn, *a):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, get_counts(), \
            torch.cuda.max_memory_allocated() / 1e9

    def want(n):
        w = {k: 0 for k in get_counts()}
        w.update({"K1": n, "K1 prologue": 2 * n})
        return w

    tb = time.perf_counter()
    (state, m1), ms1, c1, peak1 = run(step, fresh(), batch)
    t_host = time.perf_counter()
    check(c1 == want(per_grad), f"single-device step launches {c1}, predicted {want(per_grad)}")
    loss1 = float(m1["loss"])
    check(math.isfinite(loss1), f"single-device loss {loss1}")
    def pinned(t):  # a host copy in page-locked memory: the state moves at PCIe rate
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t.detach())

    # the single-device result, on the host, leaf by leaf in the reference's order
    host = {k: (pinned(p), pinned(state.opt.m[k]), pinned(state.opt.v[k]))
            for k, p in reference_leaves(state.params).items()}
    n_params = sum(p.numel() for p, _, _ in host.values())
    t_host = time.perf_counter() - t_host
    del state, m1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) {cfg.name} {SPMD_LAYERS} of 28 layers at full width ({n_params / 1e9:.3f} G "
          f"parameters), {PIPE_POLICY}, a batch of {SPMD_BATCH} x {SPMD_SEQ}: single-device "
          f"step {ms1:.1f} ms, loss {loss1:.6f}, K1 {c1['K1']} launches ({fwd} forward + "
          f"{recompute} recomputed + {bwd} backward), peak {peak1:.2f} GB; its state to the "
          f"host in {t_host:.1f} s", flush=True)
    out = {"params": n_params, "single": {"ms": ms1, "loss": loss1, "peak_gb": peak1,
                                          "launches": c1}}
    for shape in SPMD_MESHES:
        mesh = make_host_mesh(*shape, devices=dev)
        shard_state, sstep, unshard_state = make_sharded_train_step(model, opt_cfg, mesh)
        t_shard = time.perf_counter()
        sharded = shard_state(fresh())
        gc.collect()
        torch.cuda.empty_cache()
        t_shard = time.perf_counter() - t_shard
        (sharded, m2), ms2, c2, peak2 = run(sstep, sharded, batch)
        t_checks = time.perf_counter()
        data = shape[0]
        check(c2 == want(data * per_grad),
              f"{shape} sharded step launches {c2}, predicted {want(data * per_grad)}")
        loss2 = float(m2["loss"])
        if data == 1:  # the single-device step's ops on the same values
            check(loss2 == loss1, f"{shape}: loss {loss2} != single-device {loss1}")
            for k, (p, m, v) in host.items():
                for what, pl, ref in (("param", sharded.params[k], p),
                                      ("m", sharded.opt.m[k], m), ("v", sharded.opt.v[k], v)):
                    ref = ref.to(dev)
                    for r, blk in enumerate(pl.blocks):
                        check(torch.equal(blk, pl.sharding.block(ref, r)),
                              f"{shape}: {k} {what} rank {r} differs from the single-device "
                              "step")
                    del ref
            verdict = "bitwise equal to the single-device step (loss, every block)"
        else:
            check(abs(loss2 - loss1) <= SPMD_LOSS_TOL,
                  f"{shape}: loss {loss2} vs single-device {loss1}")
            back = unshard_state(sharded)
            got = {k: (pinned(p), pinned(back.opt.m[k]), pinned(back.opt.v[k]))
                   for k, p in reference_leaves(back.params).items()}
            del back, sharded
            gc.collect()
            torch.cuda.empty_cache()
            # the same step's ops on one device: each data rank's gradient,
            # summed in rank order and divided, then AdamW on whole leaves;
            # first the whole batch's gradient from the same state
            oracle = fresh()
            with use_policy(resolve_pinned_policy(cfg.gemm, None)):
                whole, _ = batch_grads(model, oracle.params, reference_leaves(oracle.params),
                                       {k: torch.as_tensor(v, device=dev)
                                        for k, v in batch.items()})
            loss_dp, mean, first = dp_oracle_step(model, opt_cfg, oracle, batch, data)
            check(loss_dp == loss2, f"{shape}: loss {loss2} != the one-device oracle's {loss_dp}")
            for k, q in reference_leaves(oracle.params).items():
                for what, mine, ref in (("param", got[k][0], q), ("m", got[k][1], oracle.opt.m[k]),
                                        ("v", got[k][2], oracle.opt.v[k])):
                    check(torch.equal(mine.to(dev), ref.detach()),
                          f"{shape}: {k} {what} differs from the one-device oracle")
            del oracle
            # the data ranks' mean gradient against the whole batch's, leaf
            # by leaf; and the planted fault, data rank 1's rows dropped
            grad = {k: (rel_norm(mean[k], w), rel_norm(first[k], w)) for k, w in whole.items()}
            del mean, first, whole
            gc.collect()
            torch.cuda.empty_cache()
            g_worst = max(grad, key=lambda k: grad[k][0])
            f_least = min(grad, key=lambda k: grad[k][1])
            tripped = sum(f > SPMD_GRAD_TOL for _, f in grad.values())
            print(f"  (b) {shape}: ||mean gradient - whole batch's|| / ||whole batch's|| by "
                  f"leaf (sound, planted fault): "
                  + json.dumps({k: [f"{a:.3e}", f"{b:.3e}"] for k, (a, b) in grad.items()}),
                  flush=True)
            check(grad[g_worst][0] <= SPMD_GRAD_TOL,
                  f"{shape}: {g_worst}'s mean gradient {grad[g_worst][0]:.3e} from the whole "
                  f"batch's, past {SPMD_GRAD_TOL}")
            check(tripped > 0, f"{shape}: the gate {SPMD_GRAD_TOL} misses the planted fault "
                  f"(least {f_least} {grad[f_least][1]:.3e})")
            # beside the whole-batch step's state (readings, not gates: at
            # step 1 AdamW moves a parameter by ~lr sign(g), so a parameter
            # differs by 2 lr wherever the two gradients' signs differ)
            lr = float(m2["lr"])
            worst = {"param_max_abs": 0.0, "param": (0.0, ""), "moment": (0.0, "")}
            for k, (p, m, v) in host.items():
                for what, mine, ref in (("param", got[k][0], p), ("moment", got[k][1], m),
                                        ("moment", got[k][2], v)):
                    mine, ref = mine.to(dev), ref.to(dev)
                    if what == "param":
                        worst["param_max_abs"] = max(worst["param_max_abs"],
                                                     float((mine - ref).abs().max()))
                    worst[what] = max(worst[what], (rel_norm(mine, ref), k))
                    del mine, ref
            # the worst parameter leaf: how many entries moved apart, and on
            # how many of them the two steps' first moments differ in sign
            k = worst["param"][1]
            p_mine, p_ref = got[k][0].to(dev), host[k][0].to(dev)
            m_mine, m_ref = got[k][1].to(dev), host[k][1].to(dev)
            moved = p_mine != p_ref
            flipped = moved & (torch.sign(m_mine) != torch.sign(m_ref))
            share = rel_norm(torch.where(flipped, p_mine, p_ref), p_ref)
            why = (f"{k} ({p_ref.numel()} entries, |p| max {float(p_ref.abs().max()):.3e} "
                   f"after the step): {int(moved.sum())} moved apart, "
                   f"{int(flipped.sum())} of them with m's sign flipped, which alone read "
                   f"{share:.2e}; their largest |m| "
                   f"{float(m_ref[flipped].abs().max()) if bool(flipped.any()) else 0.0:.3e} "
                   f"of the leaf's {float(m_ref.abs().max()):.3e}")
            del p_mine, p_ref, m_mine, m_ref, moved, flipped, got
            verdict = (f"loss within {abs(loss2 - loss1):.2e} of the single-device step (gate "
                       f"{SPMD_LOSS_TOL}); params, moments and loss bitwise equal to the "
                       f"one-device oracle; the mean gradient within {grad[g_worst][0]:.3e} "
                       f"({g_worst}) of the whole batch's, every leaf (gate {SPMD_GRAD_TOL}; "
                       f"the planted fault trips it in {tripped} of {len(grad)} leaves, least "
                       f"{grad[f_least][1]:.3e} ({f_least})); beside the whole-batch step: "
                       f"params max |d| {worst['param_max_abs']:.3e} (2 lr = {2 * lr:.3e}), "
                       f"normwise per leaf params {worst['param'][0]:.2e} ({why}), moments "
                       f"{worst['moment'][0]:.2e} ({worst['moment'][1]})")
            sharded = None
        print(f"  (b) {time.perf_counter() - tb:.1f} s into (b): shard_state {t_shard:.1f} s, "
              f"the checks {time.perf_counter() - t_checks:.1f} s", flush=True)
        print(f"  (b) sharded step on a {shape} (data, model) mesh of the card: {ms2:.1f} ms "
              f"(single device {ms1:.1f}), loss {loss2:.6f}, K1 {c2['K1']} launches "
              f"({data} x {per_grad}), peak {peak2:.2f} GB; {verdict}", flush=True)
        out[f"{shape[0]}x{shape[1]}"] = {"ms": ms2, "loss": loss2, "peak_gb": peak2,
                                         "launches": c2}
        del sharded, m2, shard_state, sstep, unshard_state
        gc.collect()
        torch.cuda.empty_cache()
    # K1 at lm_head's input gradient for a data rank of the (2, 2) step
    rows = SPMD_BATCH * SPMD_SEQ // SPMD_MESHES[-1][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 17)
    dlogits = torch.randn((rows, cfg.vocab_size), generator=gen, device=dev,
                          dtype=torch.float64) * 1e-4
    w_t = host["lm_head"][0].T.to(dev, torch.float64).contiguous()
    del host
    gc.collect()
    row = k1_train_row(dlogits, w_t, out["2x2"]["launches"]["K1"],
                       what="the sharded step's lm_head input gradient")
    del dlogits, w_t
    gc.collect()
    torch.cuda.empty_cache()
    return out, row


def dryrun_part() -> dict:
    """Phase 15 (c) (module docstring): the dry run's cells on meta."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import BIG_ARCHS, dryrun_cell, model_flops

    out = {}
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun_cell(arch, shape, False)
        check(rec["status"] == "ok", f"dry run {arch} {shape}: {rec}")
        s = SHAPES[shape]
        cfg = get_config(arch, "full", **BIG_ARCHS.get(arch, {}))
        local = s.global_batch // 16
        want = model_flops(cfg, s.kind, local, s.seq_len, s.seq_len + 8)
        check(rec["flops_per_device"] == want,
              f"dry run {arch} {shape}: {rec['flops_per_device']} FLOPs a rank, analytic {want}")
        print(f"  (c) dryrun_cell({arch!r}, {shape!r}) on 16 x 16 meta ranks: "
              + json.dumps(rec), flush=True)
        out[f"{arch}/{shape}"] = rec
    return out


def framework_phase(args, dev) -> dict:
    """Phase 15 (module docstring). Returns the kernels line's rows and the
    phase's numbers."""
    t0 = time.perf_counter()
    pipe, pipe_row = pipeline_part(args, dev)
    t1 = time.perf_counter()
    spmd, spmd_row = spmd_part(args, dev)
    t2 = time.perf_counter()
    dry = dryrun_part()
    print(f"  phase 15: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    return {"kernel_rows": [pipe_row, spmd_row],
            "framework": {"pipeline": pipe, "sharded_step": spmd, "dryrun": dry}}


#: Phase 16 (c): the full-width traced ozmm calls, each with the registry
#: entry whose findings it must repeat.
ANALYSIS_SPECS = {"ozaki2-fp8/accurate": "ozmm[fp8-accurate]", "ozaki2-fp8/fast": "ozmm[fp8-fast]",
                  "ozaki2-int8/fast": "ozmm[int8-fast]"}


def _no_shape(keys) -> set:
    """Finding keys with their trailing shape cut off."""
    return {k.rsplit(":", 1)[0] for k in keys}


def planted_faults(dev) -> dict:
    """Phase 16 (d): each planted fault's finding on the card, beside its
    fixed twin, which must find nothing."""
    import torch

    from repro_torch.analysis import check_fn

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    x = torch.randn((64, 64), generator=gen, device=dev, dtype=torch.float64)
    a32, b32 = x.float(), x.t().contiguous().float()
    i32 = torch.randint(-100, 100, (64, 64), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.tensor([1, 1, 3], device=dev)
    switch = torch.backends.cuda.matmul

    def tf32_mm(on: bool):
        prev = switch.allow_tf32
        switch.allow_tf32 = on
        try:
            return check_fn("planted", lambda a, b: torch.mm(a, b), (a32, b32))
        finally:
            switch.allow_tf32 = prev

    def copied(pool, vals):  # the update lands in a copy of the pool
        new = pool.clone()
        new[idx[:2]] = vals
        return new

    def written(pool, vals):
        pool[idx[:2]] = vals
        return pool

    cases = {
        "RPJ001:convert:float64->float32:64x64": (
            lambda: check_fn("planted", lambda x: (x.float() * 2).double(), (x,)),
            lambda: check_fn("planted", lambda x: x * 2.0, (x,))),
        "RPJ001:dot_general:float32->tf32:64x64": (lambda: tf32_mm(True), lambda: tf32_mm(False)),
        "RPJ002:mul->add:int32:64x64": (
            lambda: check_fn("planted", lambda a, b: a * b + a, (i32, i32)),
            lambda: check_fn("planted", lambda a, b: a.long() * b.long() + a.long(), (i32, i32))),
        "RPJ003:unused-donated:0": (
            lambda: check_fn("planted", copied, (x.clone(), x[:2].clone()), inplace=(0,)),
            lambda: check_fn("planted", written, (x.clone(), x[:2].clone()), inplace=(0,))),
        "RPJ004:scatter-add:float64:64x64": (
            lambda: check_fn("planted", lambda t, v: t.index_add_(0, idx, v),
                             (x.clone(), x[:3].clone()), bitwise=True),
            lambda: check_fn("planted", lambda t, v: t.index_add_(0, idx, v),
                             (i32.clone(), i32[:3].clone()), bitwise=True)),
    }
    out = {}
    for sig, (fault, twin) in cases.items():
        found = [f.signature for f in fault()]
        clean = [f.signature for f in twin()]
        check(found == [sig], f"(d) planted {sig}: the checker found {found}")
        check(clean == [], f"(d) the fixed twin of {sig}: the checker found {clean}")
        check(not switch.allow_tf32, "(d) the TF32 switch was left on")
        out[sig] = found
    print(f"  (d) planted faults found on the card, fixed twins clean: {sorted(out)}", flush=True)
    return out


def analysis_phase(args, dev) -> dict:
    """Phase 16 (module docstring). Returns the kernels line's row and the
    phase's numbers."""
    import torch

    from repro_torch import ozmm
    from repro_torch.analysis import (DEFAULT_BASELINE, ENTRY_POINTS, check_trace, lint_paths,
                                      load_baseline, new_findings, trace_entry, trace_fn)
    from repro_torch.kernels.fused import ozmm_fused_raw, raw_parts

    t0 = time.perf_counter()
    data = load_baseline(DEFAULT_BASELINE)
    # (a) the AST layer over the port's tree
    findings = lint_paths([ROOT / "src" / "repro_torch"])
    new = new_findings(findings, data, "astlint")
    check(data["astlint"] == [] and not new,
          "(a) new AST findings: " + "; ".join(f.render() for f in new))
    print(f"  (a) RPL rule pack over src/repro_torch: {len(findings)} findings, 0 new", flush=True)
    t1 = time.perf_counter()

    # (b) the registry on the card, each entry beside its CPU twin
    check(not torch.backends.cuda.matmul.allow_tf32, "(b) the TF32 switch is on")
    entries, k1_b = {}, 0
    for entry in ENTRY_POINTS:
        ozmm_fused_raw.launches = raw_parts.launches = 0
        card = trace_entry(entry, dev)
        torch.cuda.synchronize()
        launched = ozmm_fused_raw.launches
        want = int(entry.name.startswith("ozmm["))
        check(launched == want and raw_parts.launches == 2 * want,
              f"(b) {entry.name}: K1 launched {launched} times (prologue "
              f"{raw_parts.launches}), predicted {want}")
        k1_b += launched
        card_f = check_trace(entry.name, card, bitwise=entry.bitwise)
        new = new_findings(card_f, data, "graph")
        check(not new, f"(b) {entry.name}: new findings on the card: "
                       + "; ".join(f.render() for f in new))
        cpu = trace_entry(entry, "cpu", "+pallas" if want else "")
        cpu_f = check_trace(entry.name, cpu, bitwise=entry.bitwise)
        outside = [sorted(f.key for f in fs if f.scope is None) for fs in (card_f, cpu_f)]
        check(outside[0] == outside[1], f"(b) {entry.name}: card {outside[0]} vs CPU "
                                        f"{outside[1]} outside the kernel scopes")
        check([(s.name, s.launched) for s in card.scopes] == [("ozmm_fused_raw", True)] * want
              and [(s.name, s.launched) for s in cpu.scopes] == [("ozmm_fused_raw", False)] * want,
              f"(b) {entry.name}: scopes card {card.scopes}, CPU {cpu.scopes}")
        for k, p in zip(card.scopes, cpu.scopes):
            check((k.in_types, k.out_types) == (p.in_types, p.out_types),
                  f"(b) {entry.name}: the K1 node {k} vs its plain-version scope {p}")
        entries[entry.name] = {"findings": sorted(f.signature for f in card_f),
                               "k1_launches": launched,
                               "kernel_nodes": [[k.name, len(k.in_types), k.out_types]
                                                for k in card.scopes]}
        print(f"  (b) {entry.name}: {len(card_f)} findings on the card, all baselined; "
              f"{len(cpu_f)} on the CPU twin ({len(outside[1])} outside the kernel scopes, "
              f"equal to the card's); K1 launches {launched}", flush=True)
    t2 = time.perf_counter()

    # (c) the main path at full width, traced
    big = args.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 16)
    a, b = lognormal(gen, (big, big), 0.5, dev), lognormal(gen, (big, big), 0.5, dev)
    ozmm_fused_raw.launches = raw_parts.launches = 0
    traces = {spec: trace_fn(lambda a, b, spec=spec: ozmm(a, b, spec, device=dev), (a, b))
              for spec in ANALYSIS_SPECS}
    torch.cuda.synchronize()
    k1_c = ozmm_fused_raw.launches
    check(k1_c == len(ANALYSIS_SPECS) and raw_parts.launches == 2 * k1_c,
          f"(c) {k1_c} K1 launches for {len(ANALYSIS_SPECS)} traced ozmm calls")
    full = {}
    for spec, tr in traces.items():
        name = ANALYSIS_SPECS[spec]
        keys = {f.key for f in check_trace(name, tr, bitwise=True)}
        check(_no_shape(keys) == _no_shape(f"{name}:{s}" for s in entries[name]["findings"]),
              f"(c) {spec} at {big}^3: findings {sorted(keys)}, (b) {entries[name]['findings']}")
        check_equal(tr.result, ozmm(a, b, spec, device=dev), f"(c) {spec}: traced vs untraced C")

        def timed(traced: bool, spec=spec) -> float:
            torch.cuda.synchronize()
            start = time.perf_counter()
            if traced:
                trace_fn(lambda a, b: ozmm(a, b, spec, device=dev), (a, b))
            else:
                ozmm(a, b, spec, device=dev)
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3

        times = {"traced": [], "untraced": []}
        for _ in range(3):  # in turns
            times["untraced"].append(timed(False))
            times["traced"].append(timed(True))
        full[spec] = {"findings": sorted(k.split(":", 1)[1] for k in keys),
                      "traced_ms": statistics.median(times["traced"]),
                      "untraced_ms": statistics.median(times["untraced"])}
        print(f"  (c) {spec} {big}^3 traced: {sorted(keys)} (= (b)'s, shapes aside); C bitwise "
              f"equal to the untraced call; traced {full[spec]['traced_ms']:.2f} ms, untraced "
              f"{full[spec]['untraced_ms']:.2f} ms (median of 3, host clock)", flush=True)
        del tr
    del traces
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    # (d) planted faults
    planted = planted_faults(dev)
    t4 = time.perf_counter()
    print(f"  phase 16: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, "
          f"(d) {t4 - t3:.1f} s; K1 launches (b) {k1_b} (8x16x8), (c) {k1_c} (at the row's "
          f"shape)", flush=True)
    row = k1_train_row(a, b, k1_c, spec="ozaki2-fp8/accurate", what="phase 16 (c)'s shape")
    del a, b
    torch.cuda.empty_cache()
    return {"k1_row": row, "analysis": {
        "ast_findings": len(findings), "entries": entries, "full_width": full,
        "planted": planted, "k1_launches": {"b": k1_b, "c": k1_c},
        "seconds": {"a": t1 - t0, "b": t2 - t1, "c": t3 - t2, "d": t4 - t3}}}


#: Phase 17: the port's example drivers (examples/torch_*.py), each run in
#: this process through its main(argv) on the card, in this order. The
#: fp64_train run's checkpoints go to EXAMPLE_CKPT, removed before and after.
EXAMPLE_RUNS = (
    ("torch_quickstart", []),
    ("torch_hpl_lu", []),
    ("torch_hpl_lu", ["--grid", "2x2", "--n", "1000", "--policies", "ozaki2-fp8/fast",
                      "ozaki2-fp8/accurate"]),
    ("torch_serve_demo", ["--arch", "qwen2-7b"]),
    ("torch_serve_demo", ["--arch", "mamba2-2.7b"]),
    ("torch_serve_continuous", []),
    ("torch_serve_continuous", ["--arch", "mamba2-2.7b", "--gemm", "native"]),
    ("torch_fp64_train", ["--profile", "paper"]),
    ("torch_check_pipeline", []),
)
EXAMPLE_CKPT = ROOT / "experiments" / "chip_smoke_fp64_train"


def example_module(name: str):
    """examples/<name>.py as a module (the folder is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hpl_launches(spec: str, n: int, block: int) -> tuple[int, int]:
    """(K1, K2) launches of run_hpl(n, spec, block=block, refine_steps=1):
    per LU solve nb(nb-1)/2 TRSM folds each way, nb - 1 trailing updates;
    refine_steps=1 solves twice and takes two accurate residuals (unprepared
    ozmm: K1). Fast plans fold on K2; accurate pairs run on K1."""
    from repro_torch.precision import parse_policy

    if spec == "native":
        return 0, 0
    nb = -(-n // block)
    pairings = (nb - 1) + 2 * nb * (nb - 1)
    return (2, pairings) if parse_policy(spec).mode == "fast" else (pairings + 2, 0)


def dist_hpl_launches(spec: str, n: int, block: int, P: int, Q: int) -> tuple[int, int]:
    """(K1, K2) launches of run_hpl_dist(n, spec, grid=(P, Q), block=block,
    refine_steps=1): the trailing updates' and both solves' rank GEMMs (K2
    on fast plans, K1 on accurate pairs), and each rank's matvec of the two
    accurate refinement residuals (K1)."""
    from repro_torch.precision import parse_policy

    if spec == "native":
        return 0, 0
    gemms = dist_lu_updates(n, block, P, Q) + 2 * dist_solve_gemms(n, block, P)
    residuals = 2 * P * Q
    return (residuals, gemms) if parse_policy(spec).mode == "fast" else (gemms + residuals, 0)


class ModelCalls:
    """Counts the serving calls (prefill waves, decode steps) of every Model
    while in the block."""

    NAMES = ("prefill", "prefill_slots", "decode_step", "decode_slots")

    def __enter__(self):
        from repro_torch.models import model as model_mod

        self.cls, self.count, self.orig = model_mod.Model, 0, {}
        for name in self.NAMES:
            fn = self.orig[name] = getattr(self.cls, name)

            def counted(*a, _fn=fn, **kw):
                self.count += 1
                return _fn(*a, **kw)

            setattr(self.cls, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)


def predicted_example_launches(mod, argv: list, model_calls: int) -> tuple[int, int]:
    """(K1, K2) launches one example driver's run makes on the card, worked
    out from the driver's code and its arguments; ``model_calls`` is the
    serving calls the run made (ModelCalls), for the serving drivers."""
    from repro_torch.configs import get_config
    from repro_torch.linalg.dist import parse_grid

    name = mod.__name__
    ns = mod.parser().parse_args(argv) if hasattr(mod, "parser") else None
    if name == "torch_quickstart":
        # every Ozaki-II row (fast and accurate) on auto, resolve_for's spec,
        # the '+pallas' product; Ozaki-I and the '+core' context on core
        rows = sum(2 for base, _ in mod.SPECS if base.startswith("ozaki2"))
        return rows + 2, 0
    if name == "torch_hpl_lu":
        per = [dist_hpl_launches(spec, ns.n, ns.block, *parse_grid(ns.grid)) if ns.grid
               else hpl_launches(spec, ns.n, ns.block) for spec in ns.policies]
        return sum(k1 for k1, _ in per), sum(k2 for _, k2 in per)
    if name == "torch_serve_continuous":
        if ns.gemm == "native":
            return 0, 0
        # each call: the cached weights' GEMMs on K2, a tied lm_head raw on K1
        cached, raw = family_gemms(get_config(ns.arch, "smoke"))
        return raw * model_calls, cached * model_calls
    if name == "torch_fp64_train":
        # native f32 training; then every GEMM of the native f64 forward
        # emulated on its operands, the emulated logits from the native
        # final hidden state, and the emulated model's own forward (all raw)
        return 2 * sum(family_gemms(mod.model_cfg(ns.profile))) + 1, 0
    if name == "torch_serve_demo":
        check(get_config(ns.arch, "smoke").gemm is None,
              "serve_demo's smoke config sets a policy")
    return 0, 0  # serve_demo (native), check_pipeline (f32 torch.matmul)


def examples_phase(args, dev) -> dict:
    """Phase 17 (module docstring): the example drivers on the card. Returns
    the kernels line's rows (K1 at fp64_train's lm_head, K2 at
    serve_continuous' decode lm_head, each with the phase's launches) and
    the phase's numbers."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plan import quantize_matrix
    from repro_torch.kernels.fused import ops, ozmm_fused_parts_ref, ozmm_fused_raw_ref
    from repro_torch.precision import parse_policy

    get_counts, zero_counts = serve_counters()
    runs, totals = [], {"K1": 0, "K2": 0}
    for name, argv in EXAMPLE_RUNS:
        mod = example_module(name)
        if name == "torch_fp64_train":
            shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
            argv = argv + ["--ckpt-dir", str(EXAMPLE_CKPT)]
        zero_counts()
        with CheckFirstCallPerShape(ops, "ozmm_fused_raw", ozmm_fused_raw_ref,
                                    f"{name}: K1 vs plain version") as c1, \
                CheckFirstCallPerShape(ops, "ozmm_fused_parts", ozmm_fused_parts_ref,
                                       f"{name}: K2 vs plain version") as c2, \
                ModelCalls() as calls:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = mod.main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - ts
        counts = get_counts()
        k1, k2 = predicted_example_launches(mod, argv, calls.count)
        want = {k: 0 for k in counts}
        want.update({"K1": k1, "K1 prologue": 2 * k1, "K2": k2, "K2 transpose": k2})
        what = " ".join([name] + argv)
        check(counts == want, f"{what}: launches {counts}, predicted {want}")
        if name == "torch_quickstart":
            check(out["pallas_equals_core"] and out["pallas_route"] == "K1",
                  f"quickstart: +pallas ({out['pallas_route']}) vs +core not bitwise equal")
            check([r["route"] for r in out["rows"]]
                  == ["K1" if r["spec"].startswith("ozaki2") else "core" for r in out["rows"]],
                  f"quickstart: routes {[r['route'] for r in out['rows']]}")
        if name == "torch_fp64_train":
            shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
            fp64 = {k: out[k] for k in ("gemms", "gemm_of_bound", "lm_head_of_bound",
                                        "logit_dev", "forward_logit_dev",
                                        "forward_logits_equal")}
            fp64["losses"] = [out["losses"][0], out["losses"][-1]]
            fp64["step_s_median"] = statistics.median(out["step_seconds"])
        totals["K1"] += k1
        totals["K2"] += k2
        runs.append({"driver": what, "seconds": secs, "launches": {"K1": k1, "K2": k2},
                     "model_calls": calls.count, "k1_shapes": len(c1.shapes),
                     "k2_shapes": len(c2.shapes)})
        print(f"  [example] {what}: {secs:.1f} s; launches K1 {k1} (prologue {2 * k1}), "
              f"K2 {k2} (transpose {k2}), others 0, as predicted; K1 at {len(c1.shapes)} and "
              f"K2 at {len(c2.shapes)} distinct input shapes == plain version (bitwise)",
              flush=True)
        del out
        torch.cuda.empty_cache()

    # the kernels line's rows at the drivers' shapes, with the phase's launches
    fp = example_module("torch_fp64_train")
    fa = fp.parser().parse_args([])
    cfg = fp.model_cfg("paper")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 17)
    h = torch.randn((fa.batch * fa.seq, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float64)
    w = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen, device=dev,
                    dtype=torch.float64) * cfg.d_model ** -0.5
    k1_row = k1_train_row(h, w, totals["K1"], spec=fp.EMULATED,
                          what="fp64_train --profile paper's f64 lm_head")
    del h, w
    sc = example_module("torch_serve_continuous").parser().parse_args([])
    smoke = get_config(sc.arch, "smoke")
    w = torch.randn((smoke.d_model, smoke.padded_vocab), generator=gen, device=dev,
                    dtype=torch.float32)
    qb = quantize_matrix(w.double(), "rhs", parse_policy(SERVE_POLICY).moduli_set(), mode="fast")
    k2_row = k2_lm_head_row(qb, w, sc.slots, gen, dev, totals["K2"])
    del w, qb
    torch.cuda.empty_cache()
    return {"kernel_rows": [k1_row, k2_row],
            "examples": {"runs": runs, "launches": totals, "fp64_train": fp64}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192,
                    help="m = n = k of the main path (default 8192)")
    ap.add_argument("--hpl-n", type=int, default=8192,
                    help="n of phase 7's accurate HPL run (its native and fast runs take half) "
                         "and of phase 13's (default 8192)")
    ap.add_argument("--serve-layers", type=int, default=1,
                    help="layers of qwen2-7b in phase 10 (default 1 of 28)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import linalg, ozmm, prepare_operand
    from repro_torch.core import gemm
    from repro_torch.core.moduli import DEFAULT_NUM_MODULI
    from repro_torch.core.scaling import compute_scaling
    from repro_torch.kernels import build, stack_parts
    from repro_torch.kernels.fused import (KERNEL_TILE, fused_parts_args,
                                           fused_raw_args, gemm_kc, mma_probe, ops,
                                           ozmm_fused_parts, ozmm_fused_parts_ref,
                                           ozmm_fused_raw, ozmm_fused_raw_ref, part_planes,
                                           raw_parts, raw_parts_plain, transpose_parts,
                                           wgmma_probe)
    from repro_torch.kernels.fused import kernel as fused_kernel
    from repro_torch.linalg import blas3
    from repro_torch.linalg import lu as lu_mod
    from repro_torch.linalg import solve as solve_mod
    from repro_torch.precision import parse_policy

    dev = torch.device("cuda")
    t0 = t_start = time.perf_counter()

    # ---- 1. card + build ------------------------------------------------
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(dev)}", flush=True)
    tb = time.perf_counter()
    build.build_all(build.SOURCES)
    for source in build.SOURCES:
        build.load_library(source)
    print(f"build: {', '.join(build.SOURCES)} (one nvcc each, in parallel) in "
          f"{time.perf_counter() - tb:.1f} s", flush=True)
    for source in build.SOURCES:
        log = build.library_path(source).with_suffix(".log")
        entry = "?"
        for line in log.read_text().splitlines() if log.exists() else ():
            found = re.search(r"Compiling entry function '\w*?(\d+)([a-z_]+kernel)"
                              r"((?:I?L[bi]\d+E)*)", line)
            if found:  # the template arguments: bools, then K5's NMAX
                targs = [{"b0": "false", "b1": "true"}.get(t + v, v)
                         for t, v in re.findall(r"L([bi])(\d+)E", found.group(3))]
                entry = found.group(2) + (f"<{', '.join(targs)}>" if targs else "")
            elif any(w in line for w in ("registers", "spill", "smem", "(C75")):
                print(f"  ptxas {source} {entry}: {line.strip()}")
                # K5 and K6 keep every value in registers: no spill, no stack
                frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                  r"(\d+) bytes spill loads", line)
                if source in ("requant_garner.cu", "quant_residues.cu") and frame:
                    check(all(int(x) == 0 for x in frame.groups()),
                          f"ptxas: {source} {entry} has a stack frame or spills: {line.strip()}")
                # the GEMM core of K1/K2 keeps its chunked accumulators in registers
                if entry.startswith("gemm_core_kernel") and frame:
                    check(int(frame.group(2)) == int(frame.group(3)) == 0,
                          f"ptxas: {source} {entry} spills: {line.strip()}")
    t0 = phase("1 card+build", t0)

    # ---- 2. MMA probe -----------------------------------------------------
    chained_exact = True
    for k in (32, 1024, 4096, 65536):
        a8, b8, want = probe_operands(k, dev)
        exact, chained = mma_probe(a8, b8)
        torch.cuda.synchronize()
        check(torch.equal(exact.cpu().long(), want),
              f"MMA probe k={k}: the kernel's per-step product is not exact")
        chained_ok = torch.equal(chained.cpu().double(), want.double())
        chained_exact &= chained_ok
        worst = (chained.cpu().double() - want.double()).abs().max().item()
        print(f"  probe k={k}: per-k32-step int32 exact; plain f32 chain "
              f"{'exact' if chained_ok else f'NOT exact (max err {worst})'}")
    print(f"B1 probe: plain f32 accumulation across k steps would "
          f"{'also be' if chained_exact else 'NOT be'} exact up to k=65536", flush=True)
    # the GEMM core's wgmma step: each k32 product into a fresh f32 fragment,
    # promoted into an f32 sum, beside one f32 accumulator chained across
    # every step; the longest exact chain bounds the core's promotion interval
    longest = 65536 // 32  # the probe's range, unless a chain leaves the exact sum sooner
    for k in (32, 1024, 4096, 65536):
        a8, b8, want = probe_operands(k, dev, rows=64)
        exact, chained, first_bad = wgmma_probe(a8, b8)
        torch.cuda.synchronize()
        check(torch.equal(exact.cpu().long(), want),
              f"wgmma probe k={k}: the core's promoted k32 steps are not exact")
        bad = first_bad.cpu()
        chain = k // 32 if bool((bad < 0).all()) else int(bad[bad >= 0].min())
        longest = min(longest, chain) if chain < k // 32 else longest
        worst = (chained.cpu().double() - want.double()).abs().max().item()
        print(f"  wgmma probe k={k}: promoted product exact; chained f32 exact for the first "
              f"{chain} of {k // 32} k32 steps (final max err {worst})")
    kc = gemm_kc()
    print(f"B1 wgmma probe: longest exact chain {longest} k32 steps (up to k=65536); the "
          f"core promotes every {kc} step(s)", flush=True)
    check(kc <= longest, f"the core's promotion interval {kc} exceeds the longest exact "
                         f"wgmma chain {longest}")
    t0 = phase("2 mma-probe", t0)

    # ---- 3. kernel vs plain version vs core, bitwise ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    big = args.size
    for m, k, n in ((1024, 1024, 1024), (1000, 997, 1003), (big, big, big)):
        a = lognormal(gen, (m, k), 0.5, dev)
        b = lognormal(gen, (k, n), 0.5, dev)
        for spec in POLICIES:
            pol = parse_policy(spec)
            ms = pol.moduli_set()
            scal = compute_scaling(a, b, ms, pol.mode)
            fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
            got = ozmm_fused_raw(*fa, ms=ms)
            plain = ozmm_fused_raw_ref(*fa, ms=ms)
            torch.cuda.synchronize()
            check_equal(got, plain, f"{spec} {m}x{k}x{n}: kernel vs plain version")
            core = ozmm(a, b, spec + "+core")
            check_equal(got[:m, :n], core, f"{spec} {m}x{k}x{n}: kernel vs +core")
            del got, plain, core
            # the residue prologue alone: every plane it writes, both operands
            for axis, (mh, ml, e, lexp) in enumerate((fa[:4], fa[4:8])):
                got = raw_parts(mh, ml, e, lexp, fa[8], ms=ms, axis=axis)
                plain = raw_parts_plain(mh, ml, e, lexp, fa[8], ms=ms, axis=axis)
                for i, (g, w) in enumerate(zip(part_planes(got, ms), part_planes(plain, ms))):
                    check_equal(as_bytes(g), as_bytes(w),
                                f"{spec} {m}x{k}x{n}: prologue axis {axis} plane {i} vs plain")
                del got, plain
            print(f"  {spec:24s} {m}x{k}x{n}: K1 == plain == core, prologue (both operands) "
                  "== plain (bitwise)", flush=True)
            del fa
            torch.cuda.empty_cache()
        del a, b
        torch.cuda.empty_cache()
    t0 = phase("3 kernel-vs-plain", t0)

    # ---- 4. main path ---------------------------------------------------------
    a = lognormal(gen, (big, big), 0.5, dev)
    b = lognormal(gen, (big, big), 0.5, dev)
    check(gemm._resolve_backend(parse_policy("ozaki2-fp8/accurate"), dev) == "pallas",
          "backend auto did not resolve to the kernel route on this card")
    ozmm_fused_raw.launches = ozmm_fused_parts.launches = 0
    raw_parts.launches = transpose_parts.launches = 0
    out = {spec: ozmm(a, b, spec) for spec in ("ozaki2-fp8/accurate", "ozaki2-fp8/fast")}
    torch.cuda.synchronize()
    main_launches, prologue_launches = ozmm_fused_raw.launches, raw_parts.launches
    check(main_launches >= 1, "the main path never launched ozmm_fused_raw")
    check(prologue_launches == 2 * main_launches,
          f"the main path launched K1's prologue {prologue_launches} times for "
          f"{main_launches} K1 calls, predicted {2 * main_launches}")
    check(ozmm_fused_parts.launches == transpose_parts.launches == 0,
          "unprepared ozmm calls launched K2")
    dgemm = torch.matmul(a, b)
    for spec, c in out.items():
        check(c.shape == (big, big) and bool(torch.isfinite(c).all()),
              f"{spec}: output not finite or of the wrong shape")
        err = (torch.linalg.norm(c - dgemm) / torch.linalg.norm(dgemm)).item()
        print(f"  {spec}: normwise error vs cuBLAS DGEMM {err:.3e} (gate 2^-44)")
        check(err <= 2.0 ** -44, f"{spec}: normwise error {err} > 2^-44")
    del out, dgemm
    gi = torch.Generator(device=dev)
    gi.manual_seed(args.seed + 1)
    ai = torch.randint(-8, 9, (1024, 1024), generator=gi, device=dev).double()
    bi = torch.randint(-8, 9, (1024, 1024), generator=gi, device=dev).double()
    exact = ai @ bi  # |sums| <= 2^16: exact in any order
    for spec in ("ozaki2-fp8/accurate", "ozaki2-fp8/fast"):
        c = ozmm(ai, bi, spec)
        check(bool(((c - exact).abs() <= 1e-14 * exact.abs()).all()),
              f"{spec}: integer inputs not reproduced to rtol 1e-14")
        check(torch.equal(c, ozmm(ai, bi, spec)), f"{spec}: a rerun changed bits")
        rel = ((c - exact).abs() / exact.abs().clamp(min=1)).max().item()
        print(f"  {spec}: integer inputs 1024^3, max rel err {rel:.3e}, "
              f"{int((c != exact).sum())} of {c.numel()} not exact; rerun bitwise")
    print(f"  main path: {main_launches} launches of ozmm_fused_raw (its core) and "
          f"{prologue_launches} of its residue prologue for 2 ozmm calls", flush=True)
    t0 = phase("4 main-path", t0)

    # ---- 5. timings -----------------------------------------------------------
    rows = []
    library_ms = cuda_ms(lambda: torch.matmul(a, b))
    for spec in POLICIES:
        pol = parse_policy(spec)
        ms = pol.moduli_set()
        scal = compute_scaling(a, b, ms, pol.mode)
        fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
        got = ozmm_fused_raw(*fa, ms=ms)
        plain = ozmm_fused_raw_ref(*fa, ms=ms)
        max_err = (got - plain).abs().max().item()
        del got, plain
        ms_kernel = cuda_ms(lambda: ozmm_fused_raw(*fa, ms=ms))
        ms_plain = cuda_ms(lambda: ozmm_fused_raw_ref(*fa, ms=ms), K1_REPS)
        # K1's own split: the residue prologue of both operands, then the
        # core; and the core at k = one k-tile, where its per-tile epilogue
        # (residues, Garner digits, Kahan sum) is most of the time
        split = {"prologue_ms": cuda_ms(lambda: (raw_parts(*fa[:4], fa[8], ms=ms, axis=0),
                                                 raw_parts(*fa[4:8], fa[8], ms=ms, axis=1)))}
        for key, kk in (("core_ms", big), ("core_k128_ms", KERNEL_TILE[2])):
            ft = fused_raw_args(a[:, :kk], scal.lmu, b[:kk], scal.lnu, ms, KERNEL_TILE)
            pa = raw_parts(*ft[:4], ft[8], ms=ms, axis=0)
            pb = raw_parts(*ft[4:8], ft[8], ms=ms, axis=1)
            split[key] = cuda_ms(lambda: fused_kernel.gemm_core(
                "ozmm_fused_raw", pa, pb, ft[3], ft[7], ms=ms))
            del ft, pa, pb
        # where an ozmm call's time goes: scaling, raw frames + padding, kernel
        layers = {"ozmm_ms": cuda_ms(lambda: ozmm(a, b, spec)),
                  "scaling_ms": cuda_ms(lambda: compute_scaling(a, b, ms, pol.mode)),
                  "frames_ms": cuda_ms(lambda: fused_raw_args(a, scal.lmu, b, scal.lnu,
                                                              ms, KERNEL_TILE)), **split}
        n_bytes = sum(t.numel() * t.element_size() for t in fa) + big * big * 8
        products = ms.n if ms.family == "int8" else 3 * ms.n
        n_ops = products * 2 * big ** 3
        t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP8_OPS_PER_S * 1e3
        rows.append({
            "name": "ozmm_fused_raw", "policy": spec, "shape": [big, big, big],
            "num_moduli": ms.n, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_raw.cu",
            "replaces": "src/repro/kernels/fused/kernel.py:238",
            "launches": main_launches, "max_abs_err": max_err,
            "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms, **layers})
        print(f"  {spec:20s} kernel {ms_kernel:.2f} ms (prologue {split['prologue_ms']:.2f} "
              f"+ core {split['core_ms']:.2f}; the core at k = {KERNEL_TILE[2]} "
              f"{split['core_k128_ms']:.2f}), plain {ms_plain:.2f} ms, "
              f"bound {max(t_bytes, t_ops):.2f} ms, cuBLAS DGEMM {library_ms:.2f} ms, "
              f"max|kernel-plain| {max_err}; ozmm {layers['ozmm_ms']:.2f} ms = scaling "
              f"{layers['scaling_ms']:.2f} + frames {layers['frames_ms']:.2f} + kernel "
              f"+ rest", flush=True)
        del fa
        torch.cuda.empty_cache()
    check(all(r["max_abs_err"] == 0.0 for r in rows), "kernel and plain version differ")
    t0 = phase("5 timings", t0)
    print(json.dumps({"k1_by_policy": rows}))

    # ---- 6. K2 on prepared plans: bitwise, then timed ---------------------
    k1_ms = {r["policy"]: r["ms"] for r in rows}
    k2_rows = []
    shapes = dict.fromkeys(((1024, 1024, 1024), (1000, 997, 1003), (big, big, big)))
    a_main, b_main = a, b
    for m, k, n in shapes:
        if (m, k, n) == (big, big, big):
            a, b = a_main, b_main
        else:
            a, b = lognormal(gen, (m, k), 0.5, dev), lognormal(gen, (k, n), 0.5, dev)
        for spec in K2_POLICIES:
            ms = parse_policy(spec).moduli_set()
            qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
            fa = fused_parts_args(stack_parts(qa.parts, ms), qa.lscale,
                                  stack_parts(qb.parts, ms), qb.lscale, ms, KERNEL_TILE)
            launches = ozmm_fused_parts.launches
            got = ozmm_fused_parts(*fa, ms=ms)
            plain = ozmm_fused_parts_ref(*fa, ms=ms)
            torch.cuda.synchronize()
            check(ozmm_fused_parts.launches == launches + 1, f"{spec}: K2 did not launch")
            check_equal(got, plain, f"{spec} {m}x{k}x{n}: K2 vs plain version")
            check_equal(got[:m, :n], ozmm(qa, qb, spec + "+core"),
                        f"{spec} {m}x{k}x{n}: K2 vs +core")
            check_equal(got[:m, :n], ozmm(a, b, spec), f"{spec} {m}x{k}x{n}: K2 vs unprepared")
            print(f"  {spec:24s} {m}x{k}x{n}: K2 == plain == core == unprepared ozmm "
                  "(bitwise)", flush=True)
            max_err = (got - plain).abs().max().item()
            del plain
            if (m, k, n) == (big, big, big):
                ms_k2 = cuda_ms(lambda: ozmm_fused_parts(*fa, ms=ms))
                ms_plain = cuda_ms(lambda: ozmm_fused_parts_ref(*fa, ms=ms))
                ms_prepared = cuda_ms(lambda: ozmm(qa, qb, spec))
                # K2's own split (B's transpose, the core) and the yardstick:
                # the same 3N FP8 (N int8) products through cuBLASLt
                pbk = transpose_parts(fa[1], ms=ms)
                split = {"transpose_ms": cuda_ms(lambda: transpose_parts(fa[1], ms=ms)),
                         "core_ms": cuda_ms(lambda: fused_kernel.gemm_core(
                             "ozmm_fused_parts", fa[0], pbk, fa[2], fa[3], ms=ms))}
                split["products_library_ms"] = cuda_ms(library_products(fa[0], pbk, fa[1], ms))
                del pbk
                products = ms.n if ms.family == "int8" else 3 * ms.n
                t_ops = products * 2 * m * n * k / H100_FP8_OPS_PER_S * 1e3
                t_bytes = part_bytes(ms, m, k, n) / H100_BYTES_PER_S * 1e3
                k2_rows.append({
                    "name": "ozmm_fused_parts", "policy": spec, "shape": [m, k, n],
                    "num_moduli": ms.n, "route": "cuda",
                    "source": "src/repro_torch/csrc/fused_parts.cu",
                    "replaces": "src/repro/kernels/fused/kernel.py:265",
                    "max_abs_err": max_err,
                    "ms": ms_k2, "plain_ms": ms_plain, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "bytes" if t_bytes > t_ops else "operations",
                    "library_ms": library_ms, "k1_ms": k1_ms[spec],
                    "prepared_ozmm_ms": ms_prepared, **split})
                print(f"  {spec:24s} K2 {ms_k2:.2f} ms (transpose {split['transpose_ms']:.2f} "
                      f"+ core {split['core_ms']:.2f}; K1 {k1_ms[spec]:.2f} ms), plain "
                      f"{ms_plain:.2f} ms, bound {max(t_ops, t_bytes):.2f} ms, cuBLAS DGEMM "
                      f"{library_ms:.2f} ms, its {products} products through "
                      f"{'torch._int_mm' if ms.family == 'int8' else 'torch._scaled_mm'} "
                      f"{split['products_library_ms']:.2f} ms; ozmm(qa, qb) "
                      f"{ms_prepared:.2f} ms", flush=True)
            del qa, qb, fa, got
            torch.cuda.empty_cache()
    del a, b, a_main, b_main
    check(all(r["max_abs_err"] == 0.0 for r in k2_rows), "K2 and its plain version differ")
    spec = "ozaki2-fp8/accurate"
    a, b = lognormal(gen, (1024, 1024), 0.5, dev), lognormal(gen, (1024, 1024), 0.5, dev)
    qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
    launches = ozmm_fused_raw.launches
    check_equal(ozmm(qa, qb, spec + "+pallas"), ozmm(qa, qb, spec + "+core"),
                f"{spec} prepared 1024^3: +pallas (K1) vs +core")
    check(ozmm_fused_raw.launches == launches + 1, "the accurate prepared pair skipped K1")
    print(f"  {spec} prepared 1024^3: +pallas (K1 under pair_exponents) == +core")
    del a, b, qa, qb
    torch.cuda.empty_cache()
    t0 = phase("6 K2", t0)
    print(json.dumps({"k2_by_policy": k2_rows}))

    # ---- 6b. contractions past the core's chunk; the digit stack -----------
    long_rows = long_k_phase(args, dev, gen, main_launches)
    t0 = phase("6b long-k/digits", t0)
    print(json.dumps({"long_k": long_rows}))

    # ---- 7. linalg / HPL on the card --------------------------------------
    hpl_rows = []
    for spec, share in HPL_POLICIES.items():
        hn = args.hpl_n // share
        expect = hpl_launches(spec, hn, HPL_BLOCK)  # (K1, K2)
        with CallTotals(ops, "ozmm_fused_raw") as t1, \
                CallTotals(ops, "ozmm_fused_parts") as t2, \
                CallTotals(blas3, "backend_matmul") as tg, \
                CallTotals(lu_mod, "pivot_argmax", events=False) as t_piv, \
                CallTotals(lu_mod, "rank1_update", events=False) as t_rank1, \
                CallTotals(lu_mod, "trsm", events=False) as t_u12, \
                CallTotals(solve_mod, "lu_factor", events=False) as t_factor, \
                CallTotals(solve_mod, "lu_solve", events=False) as t_solve, \
                FirstCallPerShape(ops, "ozmm_fused_raw") as c1, \
                FirstCallPerShape(ops, "ozmm_fused_parts") as c2:
            ozmm_fused_raw.launches = ozmm_fused_parts.launches = 0
            raw_parts.launches = transpose_parts.launches = 0
            torch.cuda.synchronize()
            th = time.perf_counter()
            res = linalg.run_hpl(hn, spec, block=HPL_BLOCK, refine_steps=1, seed=args.seed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - th
            launches = (ozmm_fused_raw.launches, ozmm_fused_parts.launches)
            steps = (raw_parts.launches, transpose_parts.launches)
        row = {"policy": spec, "n": hn, "block": HPL_BLOCK, "seconds": secs,
               "gflops": linalg.hpl_flop_count(hn) / secs / 1e9,
               "scaled_residual": res["scaled_residual"], "k1_launches": launches[0],
               "k2_launches": launches[1], "prologue_launches": steps[0],
               "transpose_launches": steps[1], "k1_s": t1.seconds(), "k2_s": t2.seconds(),
               "gemm_calls": len(tg.spans), "gemm_layer_s": tg.seconds(),
               "factor_s": t_factor.seconds(), "pivot_s": t_piv.seconds(),
               "rank1_s": t_rank1.seconds(), "u12_trsm_s": t_u12.seconds(),
               "solves_s": t_solve.seconds()}
        row["host_s"] = secs - row["gemm_layer_s"]
        # the factorization less its panels and U12 TRSMs: the trailing
        # updates (GEMM, copy back, host subtraction)
        row["trailing_s"] = row["factor_s"] - row["pivot_s"] - row["rank1_s"] - row["u12_trsm_s"]
        hpl_rows.append(row)
        print(f"  HPL {spec:20s} n={hn}: {secs:.2f} s, {row['gflops']:.1f} GFLOP/s, scaled "
              f"residual {res['scaled_residual']:.3e}; GEMM layer {row['gemm_layer_s']:.2f} s "
              f"({row['gemm_calls']} calls) of which K2 {row['k2_s']:.2f} s "
              f"({launches[1]} launches), K1 {row['k1_s']:.2f} s ({launches[0]} launches); "
              f"host {row['host_s']:.2f} s. By stage: factor {row['factor_s']:.2f} s = pivot "
              f"search {row['pivot_s']:.2f} + panel rank-1 updates {row['rank1_s']:.2f} + U12 "
              f"TRSM {row['u12_trsm_s']:.2f} + trailing updates {row['trailing_s']:.2f}; "
              f"2 LU solves {row['solves_s']:.2f} s", flush=True)
        per_k2 = row["k2_s"] / launches[1] * 1e3 if launches[1] else 0.0
        print(f"  HPL {spec}: K1's prologue {steps[0]} launches, K2's transpose {steps[1]}; "
              f"K2 {per_k2:.3f} ms a launch", flush=True)
        check(res["passed"], f"HPL {spec}: scaled residual {res['scaled_residual']} > 16")
        check(launches == expect,
              f"HPL {spec}: (K1, K2) launches {launches}, predicted {expect}")
        check(steps == (2 * launches[0], launches[1]),
              f"HPL {spec}: (prologue, transpose) launches {steps}, predicted "
              f"{(2 * launches[0], launches[1])}")
        # each kernel at the inputs of its first call at every distinct shape
        # of this run (TRSM folds onto one column, every trailing update, the
        # refinement residuals), bitwise against its plain version
        n1 = c1.check(ozmm_fused_raw, ozmm_fused_raw_ref, f"HPL {spec}: K1 vs plain version")
        n2 = c2.check(ozmm_fused_parts, ozmm_fused_parts_ref, f"HPL {spec}: K2 vs plain version")
        print(f"  HPL {spec}: K1 at {n1} and K2 at {n2} distinct input shapes == plain "
              "version (bitwise)", flush=True)
    a1, b1 = linalg.hpl_matrix(1024, seed=args.seed + 2)
    nb1 = 1024 // HPL_BLOCK
    lu_pairings = (nb1 - 1) + nb1 * (nb1 - 1)  # trailing updates + the solve's folds
    for spec, want in (("ozaki2-fp8/fast", (0, lu_pairings)),
                       ("ozaki2-fp8/accurate", (lu_pairings, 0))):
        ozmm_fused_raw.launches = ozmm_fused_parts.launches = 0
        lu_k, perm_k = linalg.lu_factor(a1, spec + "+pallas", block=HPL_BLOCK)
        x_k = linalg.lu_solve(lu_k, perm_k, b1, spec + "+pallas", block=HPL_BLOCK)
        launches = (ozmm_fused_raw.launches, ozmm_fused_parts.launches)
        check(launches == want, f"LU n=1024 {spec}+pallas: (K1, K2) launches {launches}, "
                                f"predicted {want}")
        lu_c, perm_c = linalg.lu_factor(a1, spec + "+core", block=HPL_BLOCK)
        x_c = linalg.lu_solve(lu_c, perm_c, b1, spec + "+core", block=HPL_BLOCK)
        check((ozmm_fused_raw.launches, ozmm_fused_parts.launches) == launches,
              f"LU n=1024 {spec}+core launched a kernel")
        check(np.array_equal(perm_k, perm_c) and np.array_equal(lu_k, lu_c),
              f"LU n=1024 {spec}: +pallas and +core factorizations differ")
        check(np.array_equal(x_k, x_c), f"LU n=1024 {spec}: +pallas and +core solves differ")
        print(f"  LU n=1024 {spec}: +pallas ({launches} (K1, K2) launches) == +core, "
              "factorization and solve (bitwise)", flush=True)
    rng = np.random.default_rng(args.seed + 3)
    g = rng.random((2048, 2048)) - 0.5
    spd, rhs = g @ g.T / 2048 + np.eye(2048), rng.random(2048) - 0.5
    cb = 2048 // HPL_BLOCK
    # SYRK's plan x plan tiles over the trailing block rows, then two TRSMs
    # of cb(cb-1)/2 folds for each of the 3 solves of refine_steps=2
    want_k2 = (cb - 1) * cb * (cb + 1) // 6 + 3 * cb * (cb - 1)
    ozmm_fused_parts.launches = 0
    with FirstCallPerShape(ops, "ozmm_fused_parts") as c2:
        x, info = linalg.refine_solve(spd, rhs, "ozaki2-fp8/fast", factor="cholesky",
                                      block=HPL_BLOCK)
    chol_launches = ozmm_fused_parts.launches
    n2 = c2.check(ozmm_fused_parts, ozmm_fused_parts_ref, "Cholesky refine: K2 vs plain version")
    chol_resid = linalg.hpl_scaled_residual(spd, x, rhs)
    check(chol_launches == want_k2,
          f"Cholesky refine: {chol_launches} K2 launches, predicted {want_k2}")
    check(chol_resid <= linalg.HPL_THRESHOLD, f"Cholesky refine: scaled residual {chol_resid}")
    print(f"  Cholesky refine_solve n=2048 ozaki2-fp8/fast: {want_k2} K2 launches, at {n2} "
          f"distinct input shapes == plain version (bitwise); scaled residual "
          f"{chol_resid:.3e}, residual history {info['residuals']}")
    t0 = phase("7 linalg/HPL", t0)
    print(json.dumps({"hpl": hpl_rows}))

    # ---- 8. the phase-split +pallas+unfused pipeline ------------------------
    unfused_rows, unfused_split = unfused_phase(args, dev, gen)
    t0 = phase("8 unfused pipeline", t0)

    # ---- 9. autograd, Ozaki-I, the perf model, obs -------------------------
    autograd_phase(args, dev, gen, rows, unfused_split)
    t0 = phase("9 autograd/ozaki1/perf-model/obs", t0)

    # ---- 10. serving: qwen2-7b at full width, then the smoke width ---------
    serve = serve_phase(args, dev)
    t0 = phase("10 serve", t0)
    print(json.dumps({"serve": serve["serve"]}))

    # ---- 11. the other model families: MoE and SSM at full width, six smoke -
    families = families_phase(args, dev)
    t0 = phase("11 families", t0)
    print(json.dumps({"families": families["families"]}))

    # ---- 12. training: starcoder2-15b at full width, FP64 grade, families --
    train = train_phase(args, dev)
    t0 = phase("12 train", t0)
    print(json.dumps({"train": train["train"]}))

    # ---- 13. distributed: sharded GEMMs, block-cyclic LU and HPL ------------
    dist = dist_phase(args, dev, hpl_rows)
    t0 = phase("13 distributed", t0)
    print(json.dumps({"dist": dist["dist"]}))

    # ---- 14. the perf sweep and resolve_fastest -----------------------------
    perf = perf_phase(args, dev)
    t0 = phase("14 perf sweep/resolve_fastest", t0)
    print(json.dumps({"perf": perf["perf"]}))

    # ---- 15. the distribution layer: pipeline, sharded step, dry run -------
    framework = framework_phase(args, dev)
    t0 = phase("15 pipeline/sharded step/dry run", t0)
    print(json.dumps({"framework": framework["framework"]}))

    # ---- 16. analysis: the rule pack, the graph checker on the card --------
    analysis = analysis_phase(args, dev)
    t0 = phase("16 analysis", t0)
    print(json.dumps({"analysis": analysis["analysis"]}))

    # ---- 17. the example drivers -------------------------------------------
    examples = examples_phase(args, dev)
    t0 = phase("17 examples", t0)
    print(json.dumps({"examples": examples["examples"]}))
    print(f"total {time.perf_counter() - t_start:.1f} s; DEFAULT_NUM_MODULI "
          f"{DEFAULT_NUM_MODULI}", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = next(r for r in rows if r["policy"] == "ozaki2-fp8/accurate")
    k2_main = dict(next(r for r in k2_rows if r["policy"] == "ozaki2-fp8/fast"),
                   launches=next(r for r in hpl_rows
                                 if r["policy"] == "ozaki2-fp8/fast")["k2_launches"])
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (main, k2_main, *long_rows, *unfused_rows,
                                              serve["k2_row"], families["k2_row"],
                                              *train["k1_rows"], *dist["kernel_rows"],
                                              perf["k1_row"], *framework["kernel_rows"],
                                              analysis["k1_row"],
                                              *examples["kernel_rows"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
