#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (H100).

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. Phases
(any failure makes the exit code non-zero and suppresses the result line):

1. build the Hopper kernel libraries from ``src/repro_torch/kernels/*/csrc``
   (``qmm_wgmma.cu``: ``qmm`` and ``qmm_group`` on the tensor cores; ``qmm.cu``:
   the CUDA-core row walk, ``qmm_group`` for g not a multiple of 16 and both
   for codes off a 16-byte boundary; ``hsthresh.cu``: ``hist`` and ``mask``;
   ``hsthresh_fused.cu``: the whole H_s in one cluster launch; ``sqround.cu``;
   ``flashattn.cu``, float32 attention on the CUDA cores (aligned, and views
   off a 16-byte boundary); ``flashattn_wgmma.cu``, bf16/fp16 attention on
   the tensor cores at every head dim, aligned and off a 16-byte boundary;
   ``qmm_wgmma.cu`` also holds ``qmm_batched``, a stack of expert kernels in
   one launch, on float32 x; ``qmm_experts.cu``, the stack on bf16 x at the
   slots in use), one nvcc per source, started together;
2. hold the ``qmm`` kernel against its plain PyTorch version ``qmm_ref`` on the card
   (TF32 off, asserted) at bits 2/4/8 × M ∈ {1, 8, 64} × the LOFAR CS302
   forward (870×65,536) and adjoint (65,536×870) shapes of the main path's
   own packed Φ̂, plus a ragged shape; tolerance |Δ| ≤ 1e-5·|ref| +
   1e-5·(|x|@|w|ᵀ), the reference's kernel-vs-oracle bound. Every call must
   launch ``QMM`` of ``qmm_wgmma.cu``. Then the checks a tolerance cannot
   give (``exact_checks``), at the LOFAR shapes, 2 and 8 bits: integer x
   (bit for bit, M ∈ {1, 8, 64}), one-hot rows of Φ̂ with full-mantissa x
   (bit for bit) and batch rows (row b of M = 8 equals M = 1, bit for bit).
   The split's edges (``edge_checks``): x with every |x| in [2⁻¹²⁵, 2⁻¹¹⁰),
   rows whose largest |x| is the largest f32, rows spanning the whole f32
   range and rows whose sums overflow, bits 2 and 8, M ∈ {1, 8}, both
   orientations: the 1e-5 rule in float64 where the plain version is
   finite, inf or nan in the same places where it is not. Codes that start
   1, 2 and 8 bytes past a 16-byte boundary must launch the byte-load
   ``QMM_CORE`` of ``qmm.cu`` once each, and nothing else, within the rule.
   Times the kernel, the plain version and ``torch.matmul`` against the
   pre-dequantized f32 Φ̂ (the dense stream the paper compares against),
   with the L2 cache flushed before every timed call;
3. the main path at full size: LOFAR CS302 (870×65,536 complex Φ, 2-bit Φ̂,
   8-bit y, s=30, 60 iterations) packed, single and ``--batch 8``, with the
   kernel's launch counter set to 0 before and read after each solve; then
   the same solves as fake-quantized ``--requantize fixed`` on the same codes.
   Requires |Δrel_error| ≤ 0.01, ‖Δx‖ ≤ 1e-3·‖x‖ and the launch counts the
   iteration predicts (14 per iteration plus 2 per backtracking step);
   A 32-bit dense NIHT solve of the same sky gives the full-precision baseline;
4. the Gaussian toy (256×512) packed at bits 4 and 8 with ``--batch 8``
   against fake-fixed. The batch-level ‖Δx‖ ≤ 1e-3·‖x‖ is reported, met or
   not; each row must agree to ‖Δx_b‖ ≤ 1e-3·‖x_b‖, or split at a knife-edge
   decision after trajectories that agreed to rounding, and then stay within
   0.01 in rel_error. The same solves with ``qmm_ref`` standing in for the
   kernel are the witness; the instance and the answers go to
   ``gaussian_batch8.npz`` for ``scripts/reference_replay.py``;
5. a torch.profiler trace of one packed single-row LOFAR solve on each path
   (per_tensor, per_block, hsthresh): device time by kernel (``qmm_wgmma_kernel``,
   the CUDA-core ``qmm_kernel``, ``hsthresh_kernel``), the device's busy share
   and the set-up alone (``lofar_*_trace.json``); on the hsthresh path also
   the H_s calls' span on the device timeline and the device launches per
   proposal, beside the same solve with the two-kernel chain standing in;
6. ``qmm_group`` against ``qmm_group_ref`` at the LOFAR forward and adjoint
   shapes of the per_block Φ̂ (g = 64), bits 2/4/8 × M ∈ {1, 8, 64}, plus a
   ragged shape with a short last group; same tolerance, timings and exact
   checks as 2 (power-of-two scales; one-hot within 2 ulp; the split's
   edges; misaligned codes on ``QMM_GROUP_CORE``); every aligned call must
   launch ``QMM_GROUP`` of ``qmm_wgmma.cu``. The ragged shape at g = 8 goes
   through ``qmm`` and must launch the CUDA-core ``QMM_GROUP_CORE`` (``qmm.cu``);
7. ``hist`` and ``mask`` against ``hist_ref``/``mask_ref`` at (1, 65,536),
   (8, 65,536) and (3, 1,001), bit for bit, timed beside their bytes bound
   (their launches in the kernels line are this phase's checking calls: the
   solver no longer calls them);
8. LOFAR CS302 at full size with ``scale_granularity="per_block",
   group_size=64``, single and batch 8: ``qmm_group`` takes exactly the
   launches ``qmm`` takes on the per_tensor path and ``qmm`` none; the same
   solves with ``qmm_group_ref`` standing in on the card are the witness,
   held per row as in 4. One ``per_channel`` single solve goes through
   ``qmm``. The per_block instances go to ``lofar_block.npz`` (full size)
   and ``lofar_bench_block.npz``, both with Φ, for
   ``scripts/reference_replay.py lofar-block``;
9. LOFAR CS302 at full size with ``threshold="hsthresh"`` (per_tensor
   packed), single and batch 8: the fused ``HSTHRESH`` launches once per
   proposal for the whole batch, ``hist`` and ``mask`` never, ``qmm`` as on
   the topk path, and the same solves with ``hsthresh_ref`` standing in on
   the card give bit-identical x and trace; iterations whose support
   differs from the ``topk`` solve are counted; the single solve's wall is
   taken five times beside the same solve with the two-kernel chain
   (``hist``, ``mask`` and the plain pick and fill) standing in;
10. the Gaussian toy per_block (g = 64 on ``QMM_GROUP``, and g = 8 on the
    CUDA-core ``QMM_GROUP_CORE``; bits 4 and 8, batch 8) against its
    ``qmm_group_ref`` witness, per row as in 4;
11. ``sqround`` through its entry point at the LOFAR CS302 Φ (the real part
    of the 870×65,536 measurement matrix), the ``kernels_micro`` 512×512 and
    a ragged 333×1,001, bits 2/4/8: one launch per call, codes and scale bit
    for bit equal to ``sqround_ref`` on the same words; timed alone, as the
    whole call (with the threefry draw) and as the plain version, beside the
    9-bytes-per-element bound;
12. ``flash_attention`` through its entry point at starcoder2-3b's attention
    width (24 query heads on 2 KV heads, D = 128, causal): bf16 at S = 4,096
    (held over the whole output against the plain version) and S = 32,768
    (its last 256 rows against the plain version's causal Sq = 256, Sk =
    32,768 call, and every row against the plain version run in 1,024-row
    chunks), fp16 and f32 at S = 4,096, plus ragged and cross-attention f32
    shapes, causal and not; the head dims of the reference's other configs
    (D = 8, 160, 256 in f32, bf16 and fp16, and stablelm-12b's,
    recurrentgemma-2b's and qwen3-moe-235b SMOKE's attention at S = 4,096 in
    bf16, the first two also at the LM prefill's B = 8, S = 1,024); and q,
    k, v as views 2 elements (16-bit at D = 160 and 256, and starcoder2-3b's
    f32 at 4,096: 1 element) into larger tensors; and, on every route (f32,
    bf16 and fp16 aligned, f32 and bf16 views 1 element in) at D = 128 and
    256, a sliding window and a query offset (``FLASH_BAND_CASES``: causal
    with a window shorter than S, a window not causal, causal Sq < Sk at
    ``q_offset`` = Sk − Sq and at 0, a window at an offset) against the
    plain version with the same window and offset. Aligned bf16 and fp16 calls at every D must launch
    ``FLASH_TC`` and 16-bit views off a 16-byte boundary
    ``FLASH_TC_UNALIGNED`` (both ``flashattn_wgmma.cu``), aligned f32 calls
    ``FLASH`` and f32 views ``FLASH_UNALIGNED`` (both ``flashattn.cu``).
    |Δ| ≤ 2e-4 (f32) and 2e-2 (bf16, fp16), abs and rel, TF32 off; 16-bit
    rows also ‖Δ‖₂ ≤ 2⁻⁷·‖ref‖₂ (one bf16 ulp, relative), which scales with
    the output where 2e-2 does not. Timed beside
    ``scaled_dot_product_attention`` on the same tensors (its flash backend
    for 16-bit inputs at D ≤ 128; PyTorch's choice otherwise, recorded by
    the kernels one call launches, and at D = 160 and 256 its flash backend
    too where it takes them) and the bound; the library's own max row
    ‖Δ‖/‖ref‖ against the plain version is reported beside the kernel's, not
    gated;
13. the fused H_s (``HSTHRESH``, ``hsthresh_fused.cu``) against
    ``hsthresh_ref`` at (1, 65,536), (8, 65,536) and (3, 1,001), nbins
    2,048, s = 30, bit for bit (and on rows whose threshold-bin ties
    straddle the cluster's chunk edges), one launch per call; timed as CUDA
    events and as profiler device time beside the two-kernel chain it
    replaces and the plain version, with each call's device launches
    counted.

14. the rest of the solver on LOFAR CS302 at full size (per_tensor packed,
    60 iterations), single and batch 8: ``early_exit=True`` (lossless) and
    segments of 7 + 23 + 30 (``solver_init``/``solver_segment``/
    ``solver_result``) must give the one-shot run's x and trace bit for bit;
    ``exit_tol=1e-4`` at batch 8 must give each row the bits of its single
    solve, and so must the same rows three times over (24 rows, past the
    ``ROW_LOCAL_ROWS`` = 16 rows a ``qmm`` call keeps row-local, so Φ̂ goes
    in blocks). Every run must launch ``qmm`` 14 times per iteration run
    plus 2 per backtracking step, per block, and the solver's own loop must
    stop where the rows' exits say (a witness on its step records each
    row's raw update; it changes no arithmetic). The single solve's host
    syncs (torch's sync debug mode) and device launches are counted with
    and without the early exit;
15. the MRI path at 256×256, ``mri`` (P_Ω F, s = 2,000) and ``mri-wavelet``
    (P_Ω F W†, s = 8,000, per-band ŷ), single and batch 8, through
    ``recover_mri``: PSNR, rel_error, the wall (median of 5), device
    launches per iteration and busy time, and the single PSNR within 0.1 dB
    of the JAX reference's (``MRI_REFERENCE_PSNR``). The same inputs (the
    CPU's instance: mask, y and ŷ; ŷ is a stochastic rounding of y, which
    the card's FFT can tip the other way in a few places: the card's own y
    must be within 1e-5 of the CPU's per row and its own ŷ at most one step
    away at no more than 1e-3 of the positions) solved on the
    card and by the port on the CPU are held per row: ‖Δx_b‖ ≤ 1e-3‖x_b‖,
    or a knife-edge split as in 4 (seen here as the first iteration whose
    top-s support differs) with rel_error within 0.01; PSNR within 0.1 dB. Then
    ``threshold="hsthresh"`` on the same instances: one fused ``HSTHRESH``
    launch per proposal and x and trace bit for bit equal to the same solve
    with ``hsthresh_ref`` standing in; and the fused H_s against
    ``hsthresh_ref`` at N = 65,536, s = 2,000 and 8,000, B = 1 and 8, timed;
16. ``python -m repro_torch.launch.recover --checkpoint-dir D --ckpt-every 10``
    (LOFAR packed 2-bit, batch 8; and ``mri-wavelet``) in a subprocess,
    SIGTERM after its second checkpoint, then ``--resume``: the final
    checkpoint (the whole SolverState: x, the trace ...) must equal the
    uninterrupted checkpointed run's bit for bit, and so must the
    ``[recover]`` lines but for the wall.
17. serving (``repro_torch.launch.serve``'s ``serve_scheduled`` and ``serve``,
    ``repro_torch.parallel``): ``serve-continuous-packed`` (512×1,024 Φ packed
    once at 4 bits, 8-bit y, s = 64, 64 bursty requests, 8 slots, segments of
    8, exit_tol = 0) under ``continuous`` and ``lockstep`` with ``verify``:
    every answer bit for bit its ``reference_solve``, the two policies' answers
    bit for bit equal, the decision log the same when the run is repeated,
    each request's rel_error within 1e-3 of the JAX reference's
    (``SERVE_REFERENCE_REL_ERRORS``) or split from it at a knife edge shown
    by ``knife_edge_witness`` (the card's steps within the error bound of
    exact float64 arithmetic throughout, and the first step at which the
    CPU, from the card's own state, keeps another support parts at entries
    that rounding cannot separate), at most ``SERVE_MAX_SPLITS`` splits, and
    the easy and hard means over the requests that did not split within
    1e-3 of the reference's; items/s, p50/p99 latency, slot occupancy and the
    speed-up of continuous over lockstep from a repeat without the checks,
    whose qmm launches must equal the checked run's segments'; one full
    segment profiled (device launches, device busy) and the ŷ redraw that
    starts every segment timed. ``serve-gaussian-packed`` (4 chunks × 64
    rows, the freeze rule at 1e-5, 96 iterations): each chunk bit for bit the
    packed solve with its key, a chunk under the construction key the
    user-level ``backend="packed"`` solve, rows 0, 7 and 63 their single
    solves; the set-up and steady chunk walls. LOFAR CS302 through the
    scheduler (16 skies of ``lofar_instance``, eight at tick 0 and eight at
    tick 2, odd ones with budget 30; 8 slots, segments of 10, 60
    iterations): every sky bit for bit its ``reference_solve``. ``python -m
    repro_torch.launch.serve --config serve-gaussian-fault-packed
    --checkpoint-dir D`` sent SIGTERM after its first chunk, then
    ``--resume``: both exit 0, the first run preempted before its last
    chunk, the second draining exactly the chunks the first journaled, and
    every digest the uninterrupted run's. qmm launches of every solve and
    segment equal ``qmm_per_step``'s count (4 per iteration + 1 per
    backtracking round on the real Φ̂, 12 + 2 on LOFAR's complex Φ̂, per
    block of 16 rows under the freeze rule), checked against a witness on
    the solver's step; the kernels line counts the path's own launches
    (segments and chunks) and the verify solves' apart; qmm held to phase
    2's tolerance and timed at the serve Φ̂'s shapes, M = 8 and 16.
18. theory (``repro_torch.core.rip``) on the LOFAR CS302 Φ, on the card and
    on the port's CPU, on the same Φ: ``gamma_full`` (singular values within
    ``SV_TOL``·σ_max, γ within what that allows), the Fig. 7 sweep
    ``tune_extent_for_gamma`` over ``THEORY_EXTENTS`` (the same best extent),
    ``rics_sampled`` at s = 60 over 32 supports (supports bit for bit, α̂ and
    β̂ within 1e-4 relative), ``min_bits_lemma1`` and Eqn. 48's γ̂ bound for
    the per-tensor scale and the port's per_channel and per_block (g = 64)
    scales, and Theorem 3's ε_s, ε_q, Corollary 1's coefficients and the
    bound beside the LOFAR phase's packed solve (reported, not gated: the
    theorem assumes γ̂_2s ≤ 1/16);
19. baselines (``repro_torch.core.baselines``): paper Fig. 4 at LOFAR CS302,
    dense NIHT, QNIHT 2&8 packed, IHT, CoSaMP and FISTA-ℓ1 with the counts of
    ``benchmarks/fig4_methods.py`` (``BASELINE_ITERS``): rel_error, support
    recovery, µs per iteration; Fig. 9 at r = 256: the dirty image and beam
    and Högbom CLEAN (300 iterations, gain 0.1). On LOFAR-bench (r = 64) the
    card against the port's CPU on the same inputs: IHT, CoSaMP and CLEAN at
    the same positions with values within 1e-4 of the largest, or parted at
    a top-s or argmax pick (reported with the first call at which it parts,
    after traces that agreed to 1e-4, rel_error within 0.01); FISTA's x
    within 1e-4; host syncs the same at n and 2n iterations. The instance and
    the card's answers go to ``baselines_bench.npz`` for
    ``scripts/reference_replay.py baselines``;
20. sanitize (``repro_torch.analysis.sanitize``): ``recover --sanitize`` on
    LOFAR CS302 packed 2-bit and ``mri-wavelet-bench``, ``serve --config
    serve-gaussian-fault-packed`` (which sanitizes), each with the
    reference's ``[sanitize] ok ...`` line, the serve run's with
    ``compiles_after_warmup=0``; a NaN planted in y must raise
    ``FloatingPointError`` naming an aten op, a finite x of 3e38 through the
    LOFAR Φ̂ must raise naming ``repro_qmm_tc`` (its sums overflow only inside
    the kernel, whose non-finite outputs are the plain version's); and
    ``recover --profile-dir`` (LOFAR-bench packed) writes a trace with
    ``repro_qmm_tc`` spans and device kernels.
21. the dense LM (``repro_torch.models``, phase ``lm``): starcoder2-3b at
    full width, all 30 layers, ``init_params`` from PRNGKey(0) on the card
    and ``quantize_params(params, 4)`` (nearest); 8 prompts of 1,024 tokens
    (``randint`` of PRNGKey(1)) through ``generate`` (a prefill and 32
    greedy decode steps, cache 1,024 + 33 + 8), under W4KV8 on the kernel
    routes and at full precision (bf16 over the f32 weights). Gated per
    step: the prefill launches ``FLASH_TC`` once per layer and no ``qmm``,
    each W4KV8 decode step ``QMM`` 6 per layer (180) and nothing else, full
    precision none; the plain versions (``chunked_attention_plain``,
    ``qmm_ref``, ``attention_plain``) run 0 times and ``materialize`` only
    where the route says (the prefill's products, the unembedding, the full
    precision casts). The plain routes on the card, teacher-forced on the
    kernel run's tokens, hold the logits of the prefill and every step within
    2e-2·max|logits| (``LM_TOL``, the reference's own bound in
    tests/test_models_smoke.py), and so does ``forward`` over prompt +
    generated tokens at full precision; under W4KV8, whose serving reads an
    int8 cache where ``forward`` has exact K/V, that pair is held to 3.5e-2
    (``LM_KV8_FORWARD_TOL``). The kernel routes must be no farther than
    1.25× the plain routes from the float32 truth (``forward`` of the
    float32 model on the same weights and tokens).
    Readings: prefill ms, decode ms per token (median of 32 steps × 3
    passes) and tokens/s, ``param_bytes``, one profiled decode step (device
    busy, ``qmm``'s share), the W4KV8 step's bytes bound and the
    unembedding's per-step dequantize. Two layers at full width in float32
    on the card and on the port's CPU (same weights, the card's tokens,
    full precision and W4, float cache): logits within 1e-4·max|logits|.
    ``qmm`` at M = 8 on layer 0's six products beside ``torch.matmul`` on the
    dequantized bf16 weight and the bound (``lm_qmm_bound_ms``: bf16 x and y,
    one bf16 pass at the tensor-core peak), at the prefill's M =
    8,192 beside materialize + matmul, a layer's six products on both routes
    of ``dense`` at 8 to 1,024 rows (where ``QMM_MAX_ROWS`` should sit), and
    flash at B = 8, S = 1,024 beside SDPA.
22. training the dense LM (phase ``train``): starcoder2-3b at full width,
    ``init_state`` from PRNGKey(0) on the card, then ``train_loop`` over
    ``make_train_step`` for 3 steps of B = 8 × 1,024 synthetic tokens
    (the card's tokens the CPU's), AdamW with the launcher's schedule, Q8
    gradients and IHT at 50% (``examples/train_lm_sparse.py``'s operators).
    Gated: every loss finite; in each step ``FLASH_TC`` 60 launches (forward
    and remat recompute), the attention backward route 30, ``HSTHRESH`` 8
    (one per eligible leaf), ``SQROUND`` 213 (one per 2²⁴-entry chunk of
    every gradient leaf), no other kernel, and the plain
    ``chunked_attention_plain``, ``hsthresh_ref`` and ``sqround_ref`` never;
    on the first step every eligible leaf keeps exactly ``keep`` entries,
    its own values, the smallest kept |w| no smaller than the largest
    dropped less one bin, and one chunk of the largest gradient leaf has
    ``sqround``'s codes bit for bit the plain version's and the path's
    values bit for bit those codes dequantized. Beside it: the attention
    Function at B = 8, S = 1,024 bf16 against autograd through the plain
    forward (dq, dk, dv within 2⁻⁶ in 2-norm, ``TRAIN_ATTN_REL``); two
    float32 layers at full width, loss and every gradient card against
    CPU within 1e-4 (``TRAIN_CPU_TOL``), and 3 whole steps of a small
    model (``TRAIN_RESUME``) card against CPU, loss within 1e-4 and the
    same sparsity; that small model killed after 6 of 12 steps
    (checkpoints every 4) and restarted, bit for bit the uninterrupted
    run; after the run, the fused H_s on the first step's dense inputs to
    the projection (the embedding leaf, 151M entries, and the MLP wi leaf,
    1.13e9), each bit for bit ``hsthresh_ref`` and its support the path's.
    Readings: step ms (median of the steps after the first), tokens/s, the
    step's FLOP bound, the split (forward + backward, compression, AdamW,
    projection), peak ``max_memory_allocated``, and the fused H_s on those
    two dense leaves, ``sqround`` on the captured gradient chunk and
    ``FLASH_TC`` at B = 8, S = 1,024 beside their plain versions.
23. the hybrid LM (phase ``hybrid``, run between phases 21 and 22):
    recurrentgemma-2b at full width, all 26 layers ((rec, rec, attn) × 8,
    then rec, rec; d = 2,560, 10 query heads on 1, D = 256, RG-LRU width
    2,560, window 2,048, vocab 256,000),
    set up, served and gated as phase 21 serves starcoder2-3b (run A: 8
    prompts of 1,024 tokens, 32 decode steps, W4KV8 and full precision):
    each W4KV8 decode step ``QMM`` once per product (an RG-LRU layer's five,
    the gates on float32 x, an attention layer's four, each swiglu MLP's
    three: 200), each prefill ``FLASH_TC`` once per attention layer (8) with
    the window, the logit limits ``HYBRID_TOL`` and
    ``HYBRID_KV8_FORWARD_TOL`` from this family's own noise floor
    (``scripts/lm_noise_floor.py --arch recurrentgemma-2b``). Run B: one
    prompt of 4,096 tokens and 32 decode steps under W4KV8, where the window
    bites: 8 windowed ``FLASH_TC`` launches in the prefill (their shape key
    names the window), the cache's 2,048 slots shifting every step, the
    logits held as in run A (``forward`` over the same 4,128 tokens, whose
    float32 truth runs the windowed ``FLASH``). Readings as phase 21's, and
    ``qmm`` at M = 8 on layer 0's RG-LRU and attention products, the
    windowed ``FLASH_TC`` at B = 1, S = 4,096 and B = 8, S = 1,024 and the
    windowed ``FLASH`` at B = 1, S = 4,096 beside SDPA given the band as a
    boolean mask (its backend recorded), the same call without the window
    and the band's bound, and the RG-LRU scan (plain, log-depth) per
    layer. The first period in float32, its window cut to 32 keys, card
    against CPU on a 96-token prompt within 1e-4·max|logits|.
24. the SSM LM (phase ``ssm``, run after ``hybrid``): mamba2-370m at full
    width, all 48 layers (attention-free SSD blocks, no MLP; d = 1,024,
    d_inner 2,048 in 32 heads of 64, state 128, conv 4, chunk 64, vocab
    50,432), set up, served and gated as phase 21 serves starcoder2-3b (run
    A: 8 prompts of 1,024 tokens, 32 decode steps, W4 and full precision;
    no KV cache for KV8 to act on): each W4 decode step ``QMM`` once per
    product (in_proj and out_proj of every layer: 96), no ``FLASH_TC``
    anywhere, the logit limit ``SSM_TOL`` from this family's own noise floor
    (``scripts/lm_noise_floor.py --arch mamba2-370m``). Run B: one prompt of
    16,384 tokens (256 chunks chain in the prefill) and 32 decode steps
    under W4, held as run A (``forward`` over the same 16,416 tokens pads
    its last chunk), its decode beside a B = 1 decode after 1,024 tokens
    (the state does not grow). Readings as phase 21's, ``qmm`` at M = 8 on
    layer 0's in_proj and out_proj, and the chunked SSD (plain) of one
    layer's prefill at (8, 1,024) and (1, 16,384) with the chunk loop's
    share, beside its bound. Two layers in float32, card against CPU on a
    192-token prompt (three chunks) within 1e-4·max|logits|.
25. the encoder-decoder LM (phase ``encdec``, run after ``train``):
    whisper-tiny at full width (4 encoder and 4 decoder layers, d = 384, 6
    heads of 64, vocab 52,096): 8 × 1,500 float32 stub frames through
    ``encode``, prompts of 224 tokens over its memory and 32 decode steps,
    W4KV8 and full precision, set up, served and gated as phase 21 serves
    starcoder2-3b: each ``encode`` ``FLASH_TC`` 4 times (non-causal,
    S = 1,500), each prefill 8 times (4 causal, 4 cross-attention 224 ×
    1,500), each W4KV8 decode step ``QMM`` 32 times (the cross-attention's
    wk and wv run once, in the prefill); every non-causal call of the run is
    held against the plain version on its own inputs; the logit limits
    ``ENCDEC_*`` from this family's noise floor, the truth its float32
    serving path (its ``forward`` leaves RoPE out). A planted fault, the
    prefill's cross-attention dropping the ragged last key tile (keys
    1,472–1,499), must fail the gates. Readings as phase 21's, ``encode``'s
    time, ``qmm`` at M = 8 on layer 0's products, ``FLASH_TC`` at both
    non-causal shapes beside SDPA (non-causal) and the bound. The whole model
    in float32, card against CPU within 1e-4·max|logits|.
26. the VLM (phase ``vlm``, run after ``encdec``): llama-3.2-vision-11b at
    full width (40 layers, (attn, attn, attn, xattn, attn) × 8, d = 4,096,
    32/8 heads of 128, vocab 128,256) over 8 × 1,600 float32 stub image
    rows, prompts of 1,024 tokens, 32 decode steps, W4KV8 and full
    precision, gated as phase 21: each prefill ``FLASH_TC`` 48 times (40
    causal, 8 cross-attention 1,024 × 1,600 on K/V cast from float32 to
    bf16, the cast counted 8 times), each W4KV8 decode step ``QMM`` 296
    times; each cross-attention call held against the plain version; the
    limits ``VLM_*`` from its noise floor. Readings as phase 21's, the
    prefill's memory projections, ``qmm`` at M = 8 on layer 0's products
    and the cross-attention's wq, ``FLASH_TC`` cross (with the cast's gap to
    float32 K/V) and causal beside SDPA and the bound. Two layers (xattn,
    attn) in float32, card against CPU within 1e-4·max|logits|.
27. training recurrentgemma-2b (phase ``train_hybrid``, run after
    ``train``) at full width on train_4k's rows: 3 steps of B = 4 × 4,096
    in 4 microbatches of one row (``accum_steps``; the global batch of 256
    cut for the phase's time), Q8 gradients and IHT at 50%, gated as phase
    22 in each step: ``FLASH_TC`` 64 launches (8 attention layers, forward
    and remat recompute, 4 microbatches), every one at the run's shape with
    the 2,048-key window, the backward route 32, ``HSTHRESH`` 41,
    ``SQROUND`` one per chunk. Beside it: the attention Function at B = 1,
    10/1 heads of 256, bf16, the window at S = 4,096 and with a query offset
    of 2,048 (Sq 2,048 over 4,096 keys), against autograd through the plain
    forward within 2⁻⁶; three float32 layers (rec, rec, attn; the window cut
    to 64 keys so that it bites at 128 tokens) card against CPU within 1e-4;
    a small model of the family stepped card against CPU and resumed bit
    for bit; the fused H_s on the embedding and the largest MLP leaf,
    ``sqround`` and the windowed ``FLASH_TC`` (beside SDPA with the band as
    a mask) on the run's inputs; the RG-LRU scan's forward and backward a
    layer.
28. training mamba2-370m (phase ``train_ssm``, after ``train_hybrid``):
    3 steps of B = 8 × 4,096 in one microbatch, gated as phase 27 (no
    attention: no ``FLASH_TC``, no backward route; ``HSTHRESH`` 4), two
    float32 layers card against CPU, a small model stepped and resumed, the
    fused H_s on the embedding and the in_proj leaf, and the chunked SSD's
    forward and backward a layer.
29. the MoE LM (phase ``moe``, run after ``vlm``): qwen3-moe-30b-a3b at
    full width (48 layers, d = 2,048, 32/4 heads of 128, 128 experts of
    d_ff 768, top-8, vocab 151,936), its W4 tree built leaf by leaf from
    PRNGKey(0) (``init_quantized_params``; the float32 tree, ~122 GB, does
    not fit the card, so there is no full-precision run), prompts of 1,024
    tokens and 32 decode steps under W4KV8, gated as phase 21 with the MoE
    changes: each prefill ``FLASH_TC`` 48 times and ``QMM_EXPERTS`` 288
    times (two groups of 4,096 tokens, capacity 320), each decode step
    ``QMM`` 192 and ``QMM_EXPERTS`` 144 times (one group of 8 tokens,
    capacity 1), ``QMM_BATCHED`` none (it takes the float32 truth's expert
    products); the prefill's logits against ``forward`` over the prompt
    (the serving path and ``forward`` over prompt + generated tokens route
    other groups); the plain routes and the truth, the float32 serving path
    with exact K/V, over the prefill and the first 8 decode steps; the
    limits ``MOE_*`` from the family's noise floor; every ``QMM_EXPERTS``
    call of the prefill and the first decode step held against
    ``qmm_batched_ref`` on the full xe (without the rows in use, so a wrong
    ``rows`` shows) within 1e-5 per row; the picks that differ between
    the kernel routes, the plain routes and the truth, and the drops per
    layer; the first prefill group's dispatch and combine against the
    reference's one-hot tensors (kept set and xe bit for bit, y within 2⁻⁷
    per row). Readings: set-up seconds, W4 ``param_bytes``, peak memory,
    prefill and decode ms, the decode step's bytes bound with all experts'
    codes and with the routed ones, the dispatch's and combine's ms a layer,
    ``QMM_EXPERTS`` at C = 1 (the run's routed rows, and all rows) and 320
    beside its plain version, ``torch.bmm`` on the stack materialized to
    bf16 and the bound, and ``QMM_BATCHED`` on float32 x at C = 320 for the
    record. Two float32 layers, card against CPU within 1e-4·max|logits|,
    over a prefill and one decode step (their expert products on
    ``QMM_BATCHED``).

Every phase that drives a path sets the launch counts of all kernels to 0
just before it and reads them just after.

Before its last line it prints the card's name and power limit and one JSON
line ``{"kernels": [...]}`` (its ``bound_ms`` is the larger of the bytes and
the f32 CUDA-core operations, as since the first slice; ``bytes_bound_ms``,
beside it for ``qmm`` and ``qmm_group``, is the bytes alone at 3.35 TB/s, the
bound a tensor-core kernel is held to at small M); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chip_smoke.json`` and the trace in the directory named by
``--out`` (default ``chip_smoke_out/`` beside this script).

``python3 chip_smoke.py --flash-mutants`` runs none of that. It checks the bf16
checks of phase 12 instead: it plants each fault of ``FLASH_MUTANTS`` in a
copy of ``flashattn_wgmma.cu`` in a temporary directory, builds the copies,
and holds each, beside the real kernel, to the starcoder2-3b checks. It
passes when the real kernel meets every check and every copy fails one, and
writes ``flash_mutants.json`` to ``--out``.

``python3 chip_smoke.py --lm-faults`` (~3 min) runs only phase ``lm``'s W4KV8
run and its gates, first on the real kernels, then with each fault planted:
every ``qmm`` product of one layer read with its scales ×1.1, ×1.03 and ×1.01,
and each fault of ``FLASH_MUTANTS`` launched as ``FLASH_TC``. It passes when
the real kernels meet every gate and the ×1.1 fault and the logic faults of
flash (``LM_FLASH_FAULTS``) fail one, and writes ``lm_faults.json`` to
``--out``.

``python3 chip_smoke.py --train-faults`` (~2 min) runs only phase
``train_hybrid``'s attention check and card-vs-CPU gradients with faults
planted (``train_faults``): the attention backward route ignoring the
window, and the RG-LRU scan on the card taking one step's a as 1. It passes
when every planted fault fails its gate, and writes ``train_faults.json``
to ``--out``.

``python3 chip_smoke.py --moe-faults`` (~4 min) runs only phase ``moe``'s
W4KV8 run, its gates, its held batched-qmm calls and its dispatch check,
first on the real path, then with each fault planted (``moe_faults``): one
layer's expert multiplying by another expert's codes inside the kernel's
route, and the gate weights left unrenormalized. It passes when the real
path meets every gate and each fault fails one, names what caught each,
and writes ``moe_faults.json`` to ``--out``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import io
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
M_VALUES = (1, 8, 64)
GROUP = 64                     # per_block group size (docs/quantization.md's example)
NBINS = 2048                   # the solver's hsthresh bins
HS_SHAPES = ((1, 65536), (8, 65536), (3, 1001))
HS_S = 30                      # the LOFAR CS302 sparsity
EDGE_KINDS = ("tiny", "top", "mixed", "overflow")
CODE_OFFSETS = (1, 2, 8)       # bytes past a 16-byte boundary of the misaligned code views
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak, H100 SXM data sheet
# starcoder2-3b's attention (src/repro/configs/starcoder2_3b.py) at the
# lengths of src/repro/configs/shapes.py's train_4k and prefill_32k
STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_HEAD_DIM = 24, 2, 128
TRAIN_4K_LEN, PREFILL_32K_LEN = 4096, 32768
# (query heads, KV heads, head dim) of src/repro/configs/stablelm_12b.py,
# recurrentgemma_2b.py and qwen3_moe_235b.py's SMOKE: the head dims besides
# starcoder2-3b's 128 (the widest two on their own tile shapes)
STABLELM_12B_ATTN, RECURRENTGEMMA_2B_ATTN = (32, 8, 160), (10, 1, 256)
# phase 12's windowed and offset cases (what, causal, Sq, Sk, window, q_offset;
# q_offset None: Sk - Sq), at D = 128 and 256 on every route: f32, bf16 and
# fp16 aligned, f32 and bf16 views 1 element in
FLASH_BAND_CASES = (("causal window 64", True, 333, 333, 64, None),
                    ("window 50 not causal", False, 200, 333, 50, None),
                    ("causal Sq<Sk at q_offset=Sk-Sq", True, 200, 333, None, 133),
                    ("causal Sq<Sk at q_offset=0", True, 200, 333, None, 0),
                    ("causal window 100 at q_offset=40", True, 200, 333, 100, 40))
QWEN3_MOE_SMOKE_ATTN = (8, 2, 8)
PREFILL_TAIL_ROWS = 256        # rows of the 32k output held against a causal Sq = 256 call
PLAIN_CHUNK_ROWS = 1024        # query rows per plain-version call at 32k
SOLVER_SEGMENTS = (7, 23, 30)  # a split of the LOFAR solve's 60 iterations
EXIT_TOL = 1e-4                # the freeze rule's tolerance in the solver phase
FREEZE_TILES = 3               # the batch-8 rows 3 times over: 24 rows, past ROW_LOCAL_ROWS
MRI_CONFIGS = ("mri", "mri-wavelet")
# The JAX reference's PSNR (dB) on the same instance (seed 0, 8-bit y, the
# config's own observation scales): repro.launch.recover.recover_mri, as
# `python -m repro.launch.recover --config mri[-wavelet]` runs it, with JAX
# 0.9.0 on the CPU (the value the CLI prints to 4 decimals, unrounded here)
MRI_REFERENCE_PSNR = {"mri": 32.77187728881836, "mri-wavelet": 35.199073791503906}
RESUME_EVERY = 10
SERVE_CONTINUOUS = "serve-continuous-packed"
SERVE_CHUNKED = "serve-gaussian-packed"
SERVE_FAULT = "serve-gaussian-fault-packed"
SERVE_FREEZE_ROWS = (0, 7, 63)  # rows of each 64-row chunk held to their single solves
SERVE_LOFAR_SKIES, SERVE_LOFAR_SLOTS, SERVE_LOFAR_SEG_LEN = 16, 8, 10
# The JAX reference's rel_error of each request of serve-continuous-packed
# (seed 0, continuous policy; request 0 first): repro.launch.serve's
# build_requests and ContinuousScheduler as `python -m repro.launch.serve
# --config serve-continuous-packed --scheduler continuous` runs them (it
# prints their means rounded, easy 0.3897 and hard 0.4646), unrounded, with
# JAX 0.9.0 on the CPU
SERVE_REFERENCE_REL_ERRORS = (
    0.4575880765914917, 0.26073184609413147, 0.40797924995422363,
    0.342720627784729, 0.5495187640190125, 0.3280124068260193,
    0.49756723642349243, 0.4400739371776581, 0.4794386327266693,
    0.28591039776802063, 0.2969803512096405, 0.5311799049377441,
    0.47635337710380554, 0.5980750918388367, 0.2590450644493103,
    0.4512850344181061, 0.44912204146385193, 0.29188627004623413,
    0.34016671776771545, 0.45117321610450745, 0.24496601521968842,
    0.379495769739151, 0.3854626417160034, 0.39339232444763184,
    0.48452028632164, 0.2877635657787323, 0.3266245722770691,
    0.26077890396118164, 0.23331831395626068, 0.334056556224823,
    0.35369542241096497, 0.29672273993492126, 0.43382787704467773,
    0.46015483140945435, 0.4460308849811554, 0.3429233133792877,
    0.4366537928581238, 0.37689632177352905, 0.5141383409500122,
    0.49138346314430237, 0.4881192445755005, 0.3283310830593109,
    0.375007688999176, 0.35017111897468567, 0.3478301465511322,
    0.4925219416618347, 0.5489323735237122, 0.3040693998336792,
    0.4646320939064026, 0.4978274703025818, 0.4530014991760254,
    0.39654409885406494, 0.2949027121067047, 0.37114638090133667,
    0.40004563331604004, 0.2536390721797943, 0.45985573530197144,
    0.5379812121391296, 0.4530322551727295, 0.39108702540397644,
    0.42444726824760437, 0.2704310715198517, 0.40181925892829895,
    0.559690535068512,
)
SERVE_REL_TOL = 1e-3
SERVE_MAX_SPLITS = 8           # requests (of 64) that may split from the reference, each at a
                               # knife edge: the reference's own inputs split 3 between the JAX
                               # reference and the port's CPU run
SERVE_PRODUCT_TOL = 2e-5       # a product by Φ̂ against exact arithmetic, as a share of
                               # |Φ̂v| + |Φ̂||v|: phase 2's qmm tolerance against the float32
                               # plain version (1e-5), and as much again for that against exact
THEORY_EXTENTS = (0.25, 0.5, 1.0, 1.5, 2.0, 3.0)   # benchmarks/fig7_rip_bits.py, full
RIC_SAMPLES = 32
SV_TOL = 1e-4                  # singular values, card against CPU, as a share of σ_max
# benchmarks/fig4_methods.py:38-47 at the LOFAR CS302 config's 60 iterations
BASELINE_ITERS = {"niht": 60, "qniht": 60, "iht": 120, "cosamp": 20, "fista_l1": 180}
CLEAN_ITERS, CLEAN_GAIN = 300, 0.1   # benchmarks/fig9_clean.py, full
BASELINE_TOL = 1e-4            # baselines, card against CPU, relative to the largest value
OVERFLOW_X = 3.0e38            # finite x whose products with the LOFAR Φ̂ overflow float32
SANITIZE_RUNS = (("lofar", ["--config", "lofar", "--backend", "packed", "--bits-phi", "2",
                            "--requantize", "fixed"]),
                 ("mri-wavelet-bench", ["--config", "mri-wavelet-bench"]),
                 ("serve", ["--config", "serve-gaussian-fault-packed"]))
RESUME_RUNS = (("lofar", ["--config", "lofar", "--backend", "packed", "--bits-phi", "2",
                          "--requantize", "fixed", "--batch", "8"]),
               ("mri-wavelet", ["--config", "mri-wavelet"]))
# The lm phase: starcoder2-3b (src/repro/configs/starcoder2_3b.py) at full
# width, all 30 layers, served to 8 prompts of 1,024 tokens, 32 decode steps
LM_ARCH = "starcoder2-3b"
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 8, 1024, 32
LM_TIMING_PASSES = 2            # timed decode passes a run: the script's time limit bounds them
# Logits, as a share of max|logits|. tests/test_models_smoke.py:96 bounds the
# reference's SMOKE model by 2e-2 (LM_TOL): the kernel routes against the plain
# routes, and serving against forward at full precision. W4KV8 serving reads
# an int8 cache where forward has exact K/V; the int8 cache alone moves the
# logits 1.53e-2 from the float32 truth (scripts/lm_noise_floor.py), so that
# pair is held to LM_TOL plus that. The kernel routes must also stay within
# LM_TRUTH_RATIO times the plain routes' distance from the float32 truth.
LM_TOL = 2e-2
LM_KV8_FORWARD_TOL = 3.5e-2
LM_TRUTH_RATIO = 1.25
# the route threshold's rows: a layer's six products through qmm against
# materialize + matmul
LM_ROUTE_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024)
# --lm-faults: faults planted in the W4KV8 run, each held to phase lm's gates.
# qmm: every product of one layer read with its scales off by a factor; the
# first must fail a gate, the others measure how small a fault the gates see.
LM_FAULT_LAYER = 15
LM_SCALE_FAULTS = (1.1, 1.03, 1.01)
# flash faults of FLASH_MUTANTS the lm gates must catch: the logic faults. A
# fault of bf16's size (bf16_acc) is phase 12's elementwise check's to catch.
LM_FLASH_FAULTS = ("diagonal_tile", "own_key")
# the card against the port's CPU: two layers at full width, float32, a
# prefill and two decode steps (each of the CPU's W4 steps dequantizes every
# layer and the unembedding again: 6 s a step at recurrentgemma-2b)
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_DECODE_STEPS = 2, 2, 128, 2
LM_CPU_TOL = 1e-4
# The hybrid phase: recurrentgemma-2b (src/repro/configs/recurrentgemma_2b.py)
# at full width, all 26 layers ((rec, rec, attn) × 8, then rec, rec), served
# as phase lm serves starcoder2-3b (run A: LM_BATCH prompts of LM_PROMPT
# tokens, inside the 2,048-key window) and to one prompt of
# HYBRID_LONG_PROMPT tokens (run B: the window bites in the prefill, and the
# 2,048-slot cache shifts every decode step)
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_LONG_PROMPT = 4096
# Logits, as a share of max|logits|, from this family's own noise floor
# (scripts/lm_noise_floor.py --arch recurrentgemma-2b on an H100; PERF.md §6,
# PR 23): every bf16 route (kernel, plain, forward, with or without the int8
# cache) sits up to 0.0487 from the float32 truth, 3.2× starcoder2-3b's, and
# two of them may sit that far on opposite sides, so a pair is held to twice
# that floor; W4KV8 serving against forward (exact K/V) also carries the int8
# cache's own shift, 0.0031 in float32. The truth ratio (LM_TRUTH_RATIO) is
# the sharper gate here.
HYBRID_BF16_FLOOR, HYBRID_KV8_SHIFT = 0.0487, 0.0031
HYBRID_TOL = 2 * HYBRID_BF16_FLOOR
HYBRID_KV8_FORWARD_TOL = 2 * HYBRID_BF16_FLOOR + HYBRID_KV8_SHIFT
# the card against the port's CPU: the first period (rec, rec, attn) at full
# width in float32, the window cut to HYBRID_CPU_WINDOW keys and a prompt of
# three windows, so that the f32 kernel's window bites
HYBRID_CPU_WINDOW, HYBRID_CPU_PROMPT = 32, 96
# The ssm phase: mamba2-370m (src/repro/configs/mamba2_370m.py) at full
# width, all 48 layers, served as phase lm serves starcoder2-3b (run A, W4
# and full precision) and to one prompt of SSM_LONG_PROMPT tokens (run B:
# 256 chunks of 64 chain in the prefill)
SSM_ARCH = "mamba2-370m"
SSM_LONG_PROMPT = 16384
# Logits, as a share of max|logits|, from this family's own noise floor
# (scripts/lm_noise_floor.py --arch mamba2-370m on an H100; PERF.md §6, PR
# 24): every bf16 route (kernel, plain, forward; W4 or full precision) sits
# 0.059-0.0642 from the float32 truth, the float32 serving path 9.7e-6 from
# it; two routes may sit that far on opposite sides, so a pair is held to
# twice that floor. The truth ratio (LM_TRUTH_RATIO) is the sharper gate.
SSM_BF16_FLOOR = 0.0642
SSM_TOL = 2 * SSM_BF16_FLOOR
# the card against the port's CPU: two layers at full width in float32, a
# prompt of three chunks
SSM_CPU_PROMPT = 192
# The encdec phase: whisper-tiny (src/repro/configs/whisper_tiny.py) at full
# width, 4 encoder and 4 decoder layers, served to LM_BATCH prompts of
# ENCDEC_PROMPT tokens and LM_DECODE_STEPS decode steps (256 tokens, within
# Whisper's 448-token decoder context, arXiv:2212.04356) over the encoder's
# memory of its encoder_seq (1,500) stub frames, float32 from a seed
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_PROMPT = 224
# The vlm phase: llama-3.2-vision-11b (src/repro/configs/llama32_vision_11b.py)
# at full width, 40 layers ((attn, attn, attn, xattn, attn) × 8), served as
# phase lm serves starcoder2-3b over n_image_tokens (1,600) stub image rows,
# float32 from a seed
VLM_ARCH = "llama-3.2-vision-11b"
# Logits, as a share of max|logits|, from each family's own noise floor
# (scripts/lm_noise_floor.py --arch whisper-tiny / llama-3.2-vision-11b on an
# H100; PERF.md §6). whisper-tiny: every bf16 serving route (kernel,
# plain, with or without the int8 cache) sits up to 0.0090 from the truth,
# its float32 serving path with exact K/V (not forward: the reference's
# forward leaves RoPE out of the decoder's self-attention, its prefill and
# decode put it in, ROADMAP.md §3); two routes may sit that far on opposite
# sides, so a pair is held to twice that; serving against forward also
# carries ENCDEC_ROPE_GAP (the float32 forward against the float32 serving
# path, 0.0113) and, under W4KV8, the int8 cache's shift in float32
# (0.00037). llama-3.2-vision-11b: the bf16 routes with exact K/V (full
# precision, forward, the plain routes without the int8 cache) sit up to
# 0.1055 from the float32 forward, those that read the int8 cache up to
# 0.2306 (the int8 cache alone moves the float32 serving path 0.1952); a
# pair of routes is held to the sum of their two floors. The truth ratio
# (LM_TRUTH_RATIO) and the held non-causal calls are the sharper gates.
ENCDEC_BF16_FLOOR, ENCDEC_ROPE_GAP, ENCDEC_KV8_SHIFT = 0.0090, 0.0113, 0.00037
ENCDEC_TOL = 2 * ENCDEC_BF16_FLOOR
VLM_BF16_FLOOR, VLM_KV8_FLOOR = 0.1055, 0.2306
# the planted fault of the encdec phase: the prefill's cross-attention drops
# the ragged last key tile of the memory (keys ENCDEC_FAULT_KEYS and on)
ENCDEC_FAULT_KEYS = 1472
# the card against the port's CPU in float32: whisper-tiny whole; the vlm cut
# to two layers with cross_attn_every = 2, (xattn, attn), and two decode steps
# (each W4 step dequantizes the 128,256 × 4,096 unembedding on the CPU, ~6 s)
VLM_CPU_EVERY, VLM_CPU_DECODE_STEPS = 2, 2
# The moe phase: qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b.py) at
# full width, all 48 layers of 128 experts, top-8, served as phase lm serves
# starcoder2-3b, W4KV8 only: its float32 tree (~122 GB) does not fit the
# card, so the W4 tree is built leaf by leaf (init_quantized_params) and
# there is no full-precision run. A decode step routes its 8 tokens as one
# group of capacity 1; the 8 × 1,024 prefill as two groups of 4,096, capacity
# 320; forward over prompt + generated tokens would route other groups, so
# the prefill is held against forward over the prompt alone.
MOE_ARCH = "qwen3-moe-30b-a3b"
# Logits, as a share of max|logits|, from this family's own noise floor
# (scripts/lm_noise_floor.py --arch qwen3-moe-30b-a3b on an H100; PERF.md
# §6): every bf16 route (kernel, plain, with or without the int8
# cache) sits up to 0.0287 from the truth, the float32 serving path with
# exact K/V (the int8 cache alone moves the float32 path 0.0234), and two
# may sit that far on opposite sides, so the kernel routes are held to
# twice that against the plain routes. The prefill and forward over the
# prompt run the same routes and groups (they read 0 apart): they are held
# to two roundings of the logits to bf16.
MOE_BF16_FLOOR = 0.0287
MOE_TOL = 2 * MOE_BF16_FLOOR
MOE_FORWARD_TOL = 2.0 ** -7
# the kernel run's prefill and first decode steps held against the plain
# routes and the float32 truth, teacher-forced (the script's time limit: a
# plain-route step dequantizes all 128 experts' codes of every layer)
MOE_HELD_STEPS = 8
# each batched qmm call of the prefill and of the first decode step against
# qmm_batched_ref on the same inputs, ‖Δ‖/‖ref‖ of every (expert, slot) row:
# the kernel sums exact bf16 pieces of x in float32, the plain version the
# float32 products, so rows part by float32 rounding alone
MOE_QMM_ROW_TOL = 1e-5
# the reference's one-hot dispatch and combine, transcribed, go over this
# many experts at a time (a (4,096, 8, 8, 320) bf16 slot tensor, 168 MB)
MOE_DISPATCH_CHUNK = 8
# --moe-faults: layer 15's expert 0 multiplies by expert 1's codes in all
# three products (inside the kernel's route), and the gate weights left
# unrenormalized over the k picks
MOE_FAULT_LAYER, MOE_FAULT_EXPERT = 15, 0
BF16_ROW_REL = 2.0 ** -7       # one bf16 ulp, relative: the most that rounding two nearly
                               # equal rows to bf16 sets them apart, in 2-norm
# Faults planted in copies of flashattn_wgmma.cu by --flash-mutants: name ->
# (what it breaks, [(text of the source, its replacement), ...])
FLASH_MUTANTS = {
    "diagonal_tile": ("causal query tiles past the first skip their diagonal KV tile", [
        ("  const int n_kv = (key_hi + kBlockN - 1) / kBlockN - t_lo;\n",
         "  const int n_kv = (key_hi + kBlockN - 1) / kBlockN - t_lo - (causal && qt > 0);\n")]),
    "own_key": ("the causal mask drops each row's own key (j < i + Sk - Sq)", [
        ("(!causal || key <= row + off)", "(!causal || key < row + off)")]),
    "bf16_acc": ("the f32 O accumulator rounded to bf16 after each KV tile", [
        ("    fence_regs(acc);                                // P V has retired: acc holds tile t\n",
         "    fence_regs(acc);                                // P V has retired: acc holds tile t\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < DN / 2; ++i) acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));\n")]),
}


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        print(f"[chip_smoke] phase {name} ...", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 -- a phase failure is reported, then the run fails
            traceback.print_exc()
            self.failed.append(name)
            print(f"[chip_smoke] phase {name} FAILED", flush=True)
            return None
        print(f"[chip_smoke] phase {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        return out


def lm_qmm_bound_ms(m, n, k, kp, x_bytes=2):
    """Least time for the LM's QWeight product x (M, K) @ dequant(w)ᵀ with bf16
    activations (``x_bytes`` 4: float32, as the RG-LRU's gates): codes,
    per-row scales, x and y moved once, or the products at the bf16
    tensor-core peak: one bf16 pass for bf16 x, the three exact bf16 pieces
    that qmm_wgmma.cu splits float32 x into. Returns (ms, bound_by,
    bytes-only ms)."""
    nbytes = n * kp + 4 * n + x_bytes * m * k + x_bytes * m * n
    pieces = 1 if x_bytes == 2 else 3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, pieces * 2 * m * n * k / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            t_bytes * 1e3)


def bound_ms(m, n, k, kp, n_groups=None):
    """Least time for x (M, K) @ dequant(w)ᵀ: codes, scales, x and y moved
    once, or the FMAs at the f32 CUDA-core peak (plus, grouped, one scale
    product per code); and the bytes alone. Returns (ms, bound_by,
    bytes-only ms)."""
    scale_words = n if n_groups is None else n * n_groups
    nbytes = n * kp + 4 * scale_words + 4 * m * k + 4 * m * n
    flops = 2 * m * n * k + (0 if n_groups is None else n * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            t_bytes * 1e3)


def time_ms(torch, fn, reps, flush):
    """Mean device time of fn() over reps calls, L2 flushed before each."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(torch, fn, reps, flush, name):
    """Mean device time per call of fn of the kernels whose name holds
    `name` (torch.profiler, CUPTI), the L2 cache flushed before each call:
    the kernel alone, without the launch and the host's share that the
    event timing of time_ms takes in. None when the profiler sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
             if name in e.key and getattr(e, "device_type", None) == DeviceType.CUDA)
    return us / reps / 1e3 if us else None


def phase_build(libraries):
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries))
    out = {}
    for lib in libraries:
        ptxas = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[chip_smoke] built {lib.library_path().name} in {lib.build_seconds:.1f} s; "
              f"{len(ptxas) // 2} kernel instantiations", flush=True)
        for ln in ptxas[:12]:
            print(f"[chip_smoke]   ptxas {ln}", flush=True)
        spills = [ln for ln in ptxas
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        out[lib.source.name] = {"seconds": lib.build_seconds, "ptxas": ptxas,
                                "lines_with_spills": spills}
    return out


def reset_counts(mods):
    for kernel in mods["KERNELS"]:
        kernel.reset_counts()


def phase_kernel(torch, mods):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    dev = torch.device("cuda")
    QMM, qmm_ref, pack_operator, pack_weights = (mods["QMM"], mods["qmm_ref"],
                                                 mods["pack_operator"], mods["pack_weights"])
    unpack_codes, prng = mods["unpack_codes"], mods["prng"]
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, max_err, core_rows, core_launches = [], 0.0, [], 0
    for bits in (2, 4, 8):
        op = pack_operator(phi, bits, prng.fold_in(prng.PRNGKey(0), 0), shared=True)
        ragged = pack_weights(torch.randn(333, 1001, generator=gen, device=dev), bits,
                              prng.PRNGKey(bits), per_channel=True)
        cases = [("lofar_fwd", op.fwd_re, M_VALUES), ("lofar_adj", op.adj_re, M_VALUES),
                 ("ragged", ragged, (5,))]
        for name, w, ms in cases:
            k = w.k_dim
            n, kp = w.packed.shape
            wdeq = unpack_codes(w.packed, bits, k).to(torch.float32) * (
                w.scale.reshape(-1, 1) / (2 ** (bits - 1) // 2))
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev)
                routed = mods["cuda_kernel"](w)
                if routed is not QMM or QMM.library.source.name != "qmm_wgmma.cu":
                    raise AssertionError(f"qmm {name}: routed to {routed.entry} of "
                                         f"{routed.library.source.name}")
                before = QMM.launches
                y = mods["qmm"](x, w)
                if QMM.launches != before + 1:
                    raise AssertionError(f"qmm {name} bits={bits} M={m}: QMM was not launched")
                ref = qmm_ref(x, w.packed, w.scale, bits, k)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by, bb_ms = bound_ms(m, n, k, kp)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k), 20,
                                     flush),
                       "plain_ms": time_ms(torch, lambda: qmm_ref(x, w.packed, w.scale, bits, k),
                                           5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms,
                       "device_ms": (device_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k),
                                               20, flush, "qmm_wgmma_kernel")
                                     if name != "ragged" and bits == cs.bits_phi else None)}
                rows.append(row)
                print(f"[chip_smoke]   qmm {name:9s} bits={bits} M={m:2d}: max|Δ|={row['max_abs_err']:.3g} "
                      f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                      f"matmul(f32 Φ̂) {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by}), "
                      f"bytes alone {bb_ms:.4f} ms, device (profiler) {row['device_ms']}", flush=True)
            if name != "ragged" and bits == cs.bits_phi:
                mrow, n_launch = misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush,
                                                 group=False)
                core_rows.append(mrow)
                core_launches += n_launch
            del wdeq
        del op
    del phi, flush
    torch.cuda.empty_cache()
    exact = exact_checks(torch, mods, group=False)
    edges = edge_checks(torch, mods, group=False)
    return {"rows": rows, "max_abs_err": max_err, "entry": QMM.entry,
            "source": QMM.library.source.name, "exact": exact, "edges": edges,
            "misaligned_rows": core_rows, "misaligned_launches": core_launches}


def ulps(torch, got, want):
    """|got - want| in units in the last place of want (f32)."""
    _, e = torch.frexp(want)
    return ((got - want).abs() / torch.ldexp(torch.ones_like(want), e - 24)).max()


def exact_checks(torch, mods, group):
    """The checks a tolerance cannot give, at the LOFAR CS302 forward
    (870×65,536) and adjoint (65,536×870) shapes, 2 and 8 bits, random codes:

    * integer x: qmm with x in {-2..2} (Σ|x|·|c - K_h| < 2²⁴ in every row),
      qmm_group with x in {-1, 0, 1} and power-of-two scales {1/2, 1}: every
      partial sum is exact in f32, so the kernel equals the plain version bit
      for bit, M ∈ {1, 8, 64};
    * one-hot: rows of Φ̂ with a single nonzero code, x with full 24-bit
      mantissas: qmm bit for bit, qmm_group within 2 ulp. A kernel that
      dropped the lo piece of x would miss by ~2⁻¹⁶ relative here while
      passing the 1e-5 rule;
    * batch rows: row b of an M = 8 call equals the M = 1 call on row b,
      bit for bit."""
    dev = torch.device("cuda")
    kern = mods["QMM_GROUP"] if group else mods["QMM"]
    ref = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    cs = mods["LOFAR"]
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for bits in (2, 8):
        kh = 2 ** (bits - 1) // 2
        for shape, (n, k) in (("lofar_fwd", (n_vis, n_pix)), ("lofar_adj", (n_pix, n_vis))):
            extra = (GROUP,) if group else ()
            if group:
                n_groups = (k + GROUP - 1) // GROUP
                scale = 2.0 ** -torch.randint(0, 2, (n, n_groups), generator=gen,
                                              device=dev).float()
            else:
                scale = torch.rand(n, generator=gen, device=dev) + 0.5
            codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
            packed = mods["pack_codes"](codes, bits)
            for m in M_VALUES:
                lim = 1 if group else 2
                x = torch.randint(-lim, lim + 1, (m, k), generator=gen, device=dev).float()
                if not torch.equal(kern(x, packed, scale, bits, k, *extra),
                                   ref(x, packed, scale, bits, k, *extra)):
                    raise AssertionError(f"{kern.entry} integer {shape} bits={bits} M={m}: "
                                         "not bit for bit")
            onehot = torch.zeros(n, k, dtype=torch.int8, device=dev)
            sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1
            value = torch.randint(1, kh + 1, (n,), generator=gen, device=dev) * sign
            onehot[torch.arange(n, device=dev),
                   torch.randint(0, k, (n,), generator=gen, device=dev)] = value.to(torch.int8)
            packed = mods["pack_codes"](onehot, bits)
            x = torch.randn(8, k, generator=gen, device=dev) * 3.7
            y = kern(x, packed, scale, bits, k, *extra)
            want = ref(x, packed, scale, bits, k, *extra)
            off = float(ulps(torch, y, want))
            if off > (2.0 if group else 0.0):
                raise AssertionError(f"{kern.entry} one-hot {shape} bits={bits}: {off} ulp")
            rows = torch.cat([kern(x[b:b + 1].contiguous(), packed, scale, bits, k, *extra)
                              for b in range(8)])
            if not torch.equal(rows, y):
                raise AssertionError(f"{kern.entry} batch rows {shape} bits={bits}: row b of "
                                     "M = 8 differs from the M = 1 call")
            torch.cuda.synchronize()
            out.append({"shape": shape, "bits": bits, "integer_bitwise": list(M_VALUES),
                        "onehot_ulp": off, "batch_rows_bitwise": True})
            print(f"[chip_smoke]   {kern.entry} exact {shape} bits={bits}: integer x bit for bit "
                  f"at M = {', '.join(map(str, M_VALUES))}; one-hot {off:g} ulp; batch rows "
                  f"bit for bit", flush=True)
            del codes, onehot, packed
    torch.cuda.empty_cache()
    return out


def edge_x(torch, kind, m, k, gen):
    """x at the edges of the tensor-core kernel's three-piece split: every
    |x| in [2⁻¹²⁵, 2⁻¹¹⁰) ("tiny"); rows whose largest |x| is the largest f32
    over x near 2⁸⁰ ("top"); rows spanning 2⁻¹²⁶ to the largest f32
    ("mixed"); rows with two entries of the largest f32, whose sums overflow
    where their codes agree in sign and add up past 1 ("overflow")."""
    dev = gen.device
    fmax = torch.finfo(torch.float32).max
    sign = torch.where(torch.rand(m, k, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    mant = 1.0 + torch.rand(m, k, generator=gen, device=dev)
    rows = torch.arange(m, device=dev)

    def pick(lo, hi):
        return sign * mant * torch.exp2(torch.randint(lo, hi, (m, k), generator=gen,
                                                      device=dev).float())

    def cols():
        return torch.randint(0, k, (m,), generator=gen, device=dev)
    if kind == "tiny":
        return pick(-125, -110)
    if kind == "top":
        x = torch.randn(m, k, generator=gen, device=dev) * 2.0 ** 80
        x[rows, cols()] = fmax * sign[:, 0]
        return x
    if kind == "mixed":
        x = pick(-126, 80)
        x[rows, cols()] = fmax * sign[:, 1]
        x[rows, cols()] = 2.0 ** -126
        return x
    x = torch.randn(m, k, generator=gen, device=dev)
    c0 = cols()
    x[rows, c0] = fmax
    x[rows, (c0 + 1 + cols() % (k - 1)) % k] = fmax
    return x


def edge_checks(torch, mods, group):
    """x at both edges of the split through QMM (QMM_GROUP, g = 64, when
    ``group``) at the LOFAR CS302 forward and adjoint shapes, bits 2 and 8,
    M ∈ {1, 8}, random codes, scales in [0.5, 0.75]: |Δ| ≤ 1e-5·|ref| +
    1e-5·(|x|@|w|ᵀ), computed in float64 so that the tolerance cannot
    overflow to inf, wherever the plain version is finite, and inf or nan in
    the same places where it is not (and the overflow rows must overflow
    somewhere). Returns the largest |Δ| / tolerance per case."""
    dev = torch.device("cuda")
    kern = mods["QMM_GROUP"] if group else mods["QMM"]
    ref = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    cs = mods["LOFAR"]
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    gen = torch.Generator(device=dev).manual_seed(6)
    out = []
    for bits in (2, 8):
        kh = 2 ** (bits - 1) // 2
        for shape, (n, k) in (("lofar_fwd", (n_vis, n_pix)), ("lofar_adj", (n_pix, n_vis))):
            codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
            packed = mods["pack_codes"](codes, bits)
            if group:
                scale = torch.rand(n, (k + GROUP - 1) // GROUP, generator=gen, device=dev)
                scale = scale * 0.25 + 0.5
                wabs = codes.double().abs() * mods["expand_block_scale"](scale, GROUP, k) / kh
                extra = (GROUP,)
            else:
                scale = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.5
                wabs = codes.double().abs() * (scale.double()[:, None] / kh)
                extra = ()
            for m in (1, 8):
                for kind in EDGE_KINDS:
                    x = edge_x(torch, kind, m, k, gen)
                    y = kern(x, packed, scale, bits, k, *extra)
                    want = ref(x, packed, scale, bits, k, *extra)
                    fin = torch.isfinite(want)
                    label = f"{kern.entry} edge {kind} {shape} bits={bits} M={m}"
                    if not torch.equal(torch.isfinite(y), fin):
                        raise AssertionError(f"{label}: inf/nan in "
                                             f"{int((torch.isfinite(y) != fin).sum())} other "
                                             "places than the plain version's")
                    if kind == "overflow" and bool(fin.all()):
                        raise AssertionError(f"{label}: no output overflowed")
                    tol = 1e-5 * want.double().abs() + 1e-5 * (x.double().abs() @ wabs.T)
                    ratio = float(((y.double() - want.double()).abs() / tol)[fin].max())
                    if not ratio <= 1.0:
                        raise AssertionError(f"{label}: |Δ| is {ratio} times the tolerance")
                    out.append({"kind": kind, "shape": shape, "bits": bits, "M": m,
                                "err_over_tol": ratio,
                                "nonfinite": int((~fin).sum())})
            del codes, packed, wabs
    torch.cuda.synchronize()
    worst = max(r["err_over_tol"] for r in out)
    print(f"[chip_smoke]   {kern.entry} split edges ({', '.join(EDGE_KINDS)}; LOFAR fwd and "
          f"adj, bits 2 and 8, M = 1 and 8): within the 1e-5 rule, largest |Δ|/tolerance "
          f"{worst:.3g}; inf/nan where the plain version's", flush=True)
    torch.cuda.empty_cache()
    return out


def codes_at(torch, packed, offset):
    """The same codes as a contiguous view that starts ``offset`` bytes past a
    16-byte boundary of a larger buffer (a row slice of a bigger operand)."""
    buf = torch.zeros(offset + packed.numel() + 16, dtype=torch.uint8, device=packed.device)
    view = buf[offset:offset + packed.numel()].view(packed.shape)
    view.copy_(packed)
    return view


def misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush, group):
    """The main path's packed operand ``w`` as views 1, 2 and 8 bytes past a
    16-byte boundary, M = 1: ``qmm`` must launch the byte-load QMM_CORE
    (QMM_GROUP_CORE grouped) once per call and no other kernel, within the
    1e-5 rule; offset 1 is timed. Returns (row, checking launches)."""
    core = mods["QMM_GROUP_CORE"] if group else mods["QMM_CORE"]
    ref_fn = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    extra = (GROUP,) if group else ()
    k = w.k_dim
    n, kp = w.packed.shape
    x = torch.randn(1, k, generator=gen, device=torch.device("cuda"))
    launches, row = 0, None
    for offset in CODE_OFFSETS:
        view = mods["PackedWeights"](codes_at(torch, w.packed, offset), w.scale, bits, k,
                                     w.granularity)
        if mods["cuda_kernel"](view) is not core:
            raise AssertionError(f"{name} codes at offset {offset}: not routed to {core.entry}")
        before = [kk.launches for kk in mods["KERNELS"]]
        y = mods["qmm"](x, view)
        moved = {kk.entry: kk.launches - b for kk, b in zip(mods["KERNELS"], before)
                 if kk.launches != b}
        if moved != {core.entry: 1}:
            raise AssertionError(f"{name} codes at offset {offset}: launched {moved}")
        launches += 1
        want = ref_fn(x, view.packed, w.scale, bits, k, *extra)
        err = (y - want).abs()
        if not bool((err <= 1e-5 * want.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)).all()):
            raise AssertionError(f"{name} codes at offset {offset}: max |Δ| "
                                 f"{float(err.max())} exceeds the tolerance")
        if offset == CODE_OFFSETS[0]:
            b_ms, b_by, bb_ms = bound_ms(1, n, k, kp, w.scale.shape[1] if group else None)
            row = {"shape": name, "bits": bits, "M": 1, "N": n, "K": k, "offset": offset,
                   "entry": core.entry, "max_abs_err": float(err.max()),
                   "ms": time_ms(torch, lambda: core(x, view.packed, w.scale, bits, k, *extra),
                                 20, flush),
                   "plain_ms": time_ms(torch, lambda: ref_fn(x, view.packed, w.scale, bits, k,
                                                             *extra), 5, flush),
                   "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms}
    print(f"[chip_smoke]   {core.entry} (codes off a 16-byte boundary, offsets "
          f"{', '.join(map(str, CODE_OFFSETS))}) {name} bits={bits} M=1: within the rule; "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
          f"{row['bound_ms']:.4f} ms", flush=True)
    return row, launches


def expected_launches(res, n_iters):
    """14 qmm launches per iteration on the complex LOFAR path (R: 2, G: 4,
    µ₀ on the complex Gg: 4, acceptance: 2, trace: 2) plus 2 per backtracking
    step (a step runs while any row of the batch is still backtracking)."""
    bt = res.trace.backtracks
    steps = int(bt.sum()) if bt.ndim == 1 else int(bt.max(dim=1).values.sum())
    return 14 * n_iters + 2 * steps


def phase_lofar(torch, mods):
    QMM, recover_lofar, cs = mods["QMM"], mods["recover_lofar"], mods["LOFAR"]
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        reset_counts(mods)
        m_p, r_p, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                  mods["device"])
        launches = QMM.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QMM and k.launches}
        by_shape.update(QMM.launches_by_shape)
        want = expected_launches(r_p, cs.n_iters)
        QMM.reset_counts()
        m_f, r_f, _ = recover_lofar(cs, "fake", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                  mods["device"])
        fake_launches = QMM.launches
        dx = float(torch.linalg.vector_norm(r_p.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        key = "rel_error" if not batch else "rel_error_mean"
        d_rel = abs(m_p[key] - m_f[key])
        label = f"lofar batch={batch}" if batch else "lofar single"
        print(f"[chip_smoke]   {label}: packed {key}={m_p[key]:.4f} wall_s={m_p['wall_s']:.3f} | "
              f"fake-fixed {key}={m_f[key]:.4f} wall_s={m_f['wall_s']:.3f} | "
              f"|Δrel|={d_rel:.2e} ‖Δx‖/‖x‖={dx:.2e} | qmm launches {launches} "
              f"(predicted {want}, {launches / cs.n_iters:.2f} per iteration)", flush=True)
        if d_rel > 0.01 or (batch and abs(m_p["rel_error_max"] - m_f["rel_error_max"]) > 0.01):
            raise AssertionError(f"{label}: packed and fake-fixed rel_error differ by {d_rel}")
        if not dx <= 1e-3:
            raise AssertionError(f"{label}: ‖Δx‖/‖x‖ = {dx} between packed and fake-fixed "
                                 "exceeds 1e-3")
        if launches == 0 or launches != want:
            raise AssertionError(f"{label}: {launches} qmm launches, predicted {want}")
        if others:
            raise AssertionError(f"{label}: the per_tensor topk path launched {others}")
        if fake_launches:
            raise AssertionError(f"{label}: the fake-fixed path launched qmm {fake_launches} times")
        out[label] = {"packed": m_p, "fake_fixed": m_f, "dx_rel": dx, "launches": launches,
                      "launches_predicted": want,
                      "backtracks": int(r_p.trace.backtracks.sum())}
    n_pix = cs.resolution ** 2
    n_vis = cs.n_antennas * (cs.n_antennas - 1)
    out["launches_by_orientation"] = {"lofar_fwd": by_shape[(n_vis, n_pix)],
                                      "lofar_adj": by_shape[(n_pix, n_vis)]}
    m_d, _, _ = recover_lofar(cs, "dense", None, None, 0, "fixed", 0, mods["device"])
    print(f"[chip_smoke]   lofar single 32-bit dense NIHT: rel_error={m_d['rel_error']:.4f} "
          f"source_recovery={m_d['source_recovery']:.3f} wall_s={m_d['wall_s']:.3f}", flush=True)
    out["lofar single dense"] = m_d
    out["saved"] = [save_lofar(torch, mods, c, with_phi) for c, with_phi in
                    ((cs, False), (mods["LOFAR_BENCH"], True))]
    return out


def save_lofar(torch, mods, cs, with_phi):
    """One sky of ``cs`` solved dense, fake-fixed and packed, saved with its
    y (and Φ when ``with_phi``) for ``scripts/reference_replay.py lofar``."""
    import numpy as np

    dev = torch.device(mods["device"])
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    config = cs.name.replace("lofar-cs302", "lofar")        # the name recover takes
    saved = {"config": config,
             "y": y.cpu().numpy(), "x_true": x_true.cpu().numpy(), "bits_phi": cs.bits_phi,
             "bits_y": cs.bits_y, "seed": 0}
    if with_phi:
        saved["phi"] = phi.cpu().numpy()
    del phi
    rel = {}
    for backend, name in (("dense", "dense"), ("fake", "fake_fixed"), ("packed", "packed")):
        m, r, xt = mods["recover_lofar"](cs, backend, cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev)
        if not torch.equal(xt, x_true):
            raise AssertionError("recover_lofar drew another sky than the saved one")
        saved[f"x_{name}"] = r.x.real.cpu().numpy()
        rel[name] = m["rel_error"]
    path = mods["out_dir"] / f"{config.replace('-', '_')}_single.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    print(f"[chip_smoke]   {cs.name} single, saved to {path.name}: rel_error "
          + " ".join(f"{k}={v:.4f}" for k, v in rel.items()), flush=True)
    return {"config": cs.name, "file": path.name, "rel_error": rel}


def split_iteration(torch, tp, tf, b):
    """Where row b of two solves parts: the first iteration at which the two
    take a different discrete decision (backtracks, support change) or their
    quantized residual ‖ŷ − Φ̂x‖ (the cost NIHT minimizes) differs by more than
    1e-3; and the largest residual difference before it. Trajectories whose
    residuals agree to rounding (≤ 1e-4) up to that iteration have split at a
    decision taken the other way on a knife edge, not drifted apart through a
    wrong product. (The step size µ = ‖g_Γ‖²/‖Φ̂g_Γ‖² is not compared: once x
    sits at the least-squares point of its support, g_Γ is rounding noise and
    so is µ.)"""
    rq = ((tp.resid_q[:, b] - tf.resid_q[:, b]).abs()
          / tf.resid_q[:, b].abs().clamp_min(1e-30))
    parted = ((tp.backtracks[:, b] != tf.backtracks[:, b])
              | (tp.support_changed[:, b] != tf.support_changed[:, b]) | (rq > 1e-3))
    where = torch.nonzero(parted).flatten()
    if where.numel() == 0:
        return None, float(rq.max())
    t = int(where[0])
    return t, float(rq[:t].max()) if t else 0.0


@contextlib.contextmanager
def stand_in(module, **plain):
    """The path with plain versions standing in for kernel wrappers of
    ``module`` on CUDA tensors (a witness: the same code path with the plain
    version's arithmetic in place of the kernel's)."""
    kernels = {name: getattr(module, name) for name in plain}
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(module, name, fn)


def row_dx(torch, a, b):
    return (torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1)).tolist()


def phase_gaussian(torch, mods):
    """Packed vs fake-fixed on the Gaussian toy, batch 8, bits 4 and 8.

    The batch-level ‖Δx‖ ≤ 1e-3·‖x‖ is reported, met or not. What is required
    of each row b: ‖Δx_b‖ ≤ 1e-3·‖x_b‖, or a split at a knife-edge decision
    (trajectories that agree to ≤ 1e-4 in ‖ŷ − Φ̂x‖ until one iteration, see
    split_iteration) after which the row's rel_error stays within 0.01 of
    fake-fixed's. Witness: the same packed solves with ``qmm_ref`` in place
    of the kernel, compared with fake-fixed the same way. The instance and
    all three answers go to ``gaussian_batch8.npz`` for a replay through the
    reference (``scripts/reference_replay.py``)."""
    import numpy as np

    QMM, recover_gaussian, g = mods["QMM"], mods["recover_gaussian"], mods["GAUSS"]
    dev = torch.device(mods["device"])
    phi, Y, X_true = mods["gaussian_batch_instance"](g, 0, 8, dev)
    saved = {"phi": phi.cpu().numpy(), "Y": Y.cpu().numpy(), "X_true": X_true.cpu().numpy()}
    out = {}
    for bits in (4, 8):
        reset_counts(mods)
        m_p, r_p, xt = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev)
        launches = QMM.launches
        m_f, r_f, _ = recover_gaussian(g, "fake", bits, 8, 0, "fixed", 8, dev)
        with stand_in(mods["qmm_ops"], qmm_cuda=mods["qmm_ref"]):
            reset_counts(mods)
            m_r, r_r, _ = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev)
            if QMM.launches:
                raise AssertionError("the witness run launched the kernel")
        if not torch.equal(xt, X_true):
            raise AssertionError("recover_gaussian drew another instance than the saved one")
        dx = float(torch.linalg.vector_norm(r_p.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        dx_w = float(torch.linalg.vector_norm(r_r.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        rows, rows_w = row_dx(torch, r_p.x, r_f.x), row_dx(torch, r_r.x, r_f.x)
        rel = {k: row_dx(torch, r.x, X_true) for k, r in
               (("kernel", r_p), ("plain", r_r), ("fake", r_f))}
        batch_gate = dx <= 1e-3
        print(f"[chip_smoke]   gaussian bits={bits} batch=8: packed rel_error_mean="
              f"{m_p['rel_error_mean']:.4f} wall_s={m_p['wall_s']:.3f} | fake-fixed "
              f"{m_f['rel_error_mean']:.4f} wall_s={m_f['wall_s']:.3f} | ‖Δx‖/‖x‖={dx:.2e} "
              f"(batch-level 1e-3 {'met' if batch_gate else 'NOT met'}) | witness (qmm_ref "
              f"packed) vs fake-fixed ‖Δx‖/‖x‖={dx_w:.2e} | qmm launches {launches}", flush=True)
        splits = {}
        for b in range(len(rows)):
            if rows[b] <= 1e-3 and rows_w[b] <= 1e-3:
                continue
            t, before = split_iteration(torch, r_p.trace, r_f.trace, b)
            t_w, before_w = split_iteration(torch, r_r.trace, r_f.trace, b)
            d_rel = abs(rel["kernel"][b] - rel["fake"][b])
            print(f"[chip_smoke]     row {b}: kernel ‖Δx_b‖/‖x_b‖={rows[b]:.2e} (agree to "
                  f"{before:.1e} in ‖ŷ − Φ̂x‖ until iteration {t}); witness {rows_w[b]:.2e} "
                  f"(agree to {before_w:.1e} until iteration {t_w}); rel_error kernel "
                  f"{rel['kernel'][b]:.4f} plain {rel['plain'][b]:.4f} fake "
                  f"{rel['fake'][b]:.4f}", flush=True)
            splits[b] = {"dx_rel": rows[b], "split_iteration": t, "agree_before": before,
                         "witness_dx_rel": rows_w[b], "witness_split_iteration": t_w,
                         "witness_agree_before": before_w,
                         "rel_error": {k: v[b] for k, v in rel.items()}}
            if rows[b] <= 1e-3:
                continue
            if t is None or before > 1e-4:
                raise AssertionError(f"gaussian bits={bits} row {b}: ‖Δx_b‖/‖x_b‖ = {rows[b]} "
                                     "> 1e-3 without a split at a discrete decision")
            if d_rel > 0.01:
                raise AssertionError(f"gaussian bits={bits} row {b}: rel_error differs from "
                                     f"fake-fixed's by {d_rel} > 0.01 after the split")
        if launches == 0:
            raise AssertionError(f"gaussian bits={bits}: the kernel was never launched")
        for k, r in (("kernel", r_p), ("plain", r_r), ("fake", r_f)):
            saved[f"x_{k}_bits{bits}"] = r.x.cpu().numpy()
        out[f"bits={bits}"] = {"packed": m_p, "fake_fixed": m_f, "witness": m_r, "dx_rel": dx,
                               "batch_gate_met": batch_gate, "witness_dx_rel": dx_w,
                               "dx_rows": rows, "witness_dx_rows": rows_w, "rel_error_rows": rel,
                               "splits": splits, "launches": launches}
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "gaussian_batch8.npz", s=g.s, n_iters=g.n_iters, bits_y=8, seed=0,
             **saved)
    return out


def phase_profile(torch, mods):
    """Device time by kernel and the device's busy share over one packed
    single-row LOFAR solve on each path: per_tensor topk, per_block (g = 64),
    hsthresh, and hsthresh with the two-kernel chain standing in
    (torch.profiler, CUPTI), beside the set-up alone (a 0-iteration solve: ŷ
    draw, Φ̂ quantize and pack). On the hsthresh paths each H_s call runs in
    a profiler range "H_s", whose span on the device timeline (its kernels
    and the gaps between them) is reported beside the kernels' own device
    time; device launches are counted per proposal. Reports "not measured"
    when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs, dev = mods["LOFAR"], torch.device(mods["device"])
    phi, y, x = mods["lofar_instance"](cs, 0, 0, dev)
    base = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
                requantize="fixed", backend="packed", real_signal=True, nonneg=True)
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    fused = mods["hs_ops"].hsthresh_cuda

    def h_s(hs):
        """hs inside a profiler range named "H_s", so that the trace sums the
        device time of the kernels it launches."""
        def call(x, s, nbins):
            with torch.profiler.record_function("H_s"):
                return hs(x, s, nbins)
        return call
    for path, extra, trace in (
            ("per_tensor", {}, "lofar_packed_trace.json"),
            ("per_block", dict(scale_granularity="per_block", group_size=GROUP),
             "lofar_per_block_trace.json"),
            ("hsthresh", dict(threshold="hsthresh"), "lofar_hsthresh_trace.json"),
            ("hsthresh_chain", dict(threshold="hsthresh"), "lofar_hsthresh_chain_trace.json")):
        kw = {**base, **extra}
        with contextlib.ExitStack() as stack:
            if path.startswith("hsthresh"):
                hs = fused if path == "hsthresh" else (
                    lambda x, s, nbins: hs_chain(mods, x, s, nbins))
                stack.enter_context(stand_in(mods["hs_ops"], hsthresh_cuda=h_s(hs)))
            mods["qniht"](phi, y, cs.n_sources, 2, **kw)      # warm-up (allocator, kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mods["qniht"](phi, y, cs.n_sources, 0, **kw)      # the set-up alone
            torch.cuda.synchronize()
            setup_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = mods["qniht"](phi, y, cs.n_sources, cs.n_iters, **kw)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        proposals = cs.n_iters + backtrack_steps(res)
        h_s_ms = None
        rows = []
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue                                  # host-side op rows repeat the time
            if ev.key == "H_s":
                # the range on the device timeline: from the first kernel an
                # H_s call launches to the end of its last, gaps included
                h_s_ms = (getattr(ev, "device_time_total", 0) or 0) / 1e3 or None
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0 or ev.count:
                rows.append({"name": ev.key, "device_ms": us / 1e3, "calls": ev.count})
        rows.sort(key=lambda r: -r["device_ms"])
        busy_ms = sum(r["device_ms"] for r in rows)
        device_launches = sum(r["calls"] for r in rows)
        prof.export_chrome_trace(str(out_dir / trace))
        if not rows:
            print(f"[chip_smoke]   profile {path}: no device time seen (not measured)",
                  flush=True)
            out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": None,
                         "proposals": proposals, "kernels": []}
            continue
        ours = {name: sum(r["device_ms"] for r in rows if f"{name}_kernel" in r["name"])
                for name in ("qmm_wgmma", "qmm", "hist", "mask", "hsthresh")}
        calls = {name: sum(r["calls"] for r in rows if f"{name}_kernel" in r["name"])
                 for name in ("qmm_wgmma", "qmm", "hsthresh")}
        print(f"[chip_smoke]   profile of one packed LOFAR solve, {path}: wall {wall_ms:.1f} ms "
              f"(set-up alone {setup_ms:.1f} ms), device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), qmm_wgmma_kernel {ours['qmm_wgmma']:.1f} ms "
              f"({calls['qmm_wgmma']}×), CUDA-core qmm_kernel {ours['qmm']:.1f} ms "
              f"({calls['qmm']}×), hsthresh_kernel {ours['hsthresh']:.2f} ms "
              f"({calls['hsthresh']}×), hist {ours['hist']:.2f} ms, mask {ours['mask']:.2f} ms; "
              f"{device_launches} device launches, {proposals} proposals "
              f"({device_launches / proposals:.1f} per proposal); H_s calls' span on the "
              f"device timeline {'not measured' if h_s_ms is None else f'{h_s_ms:.2f} ms'}",
              flush=True)
        for r in rows[:10]:
            print(f"[chip_smoke]     {r['device_ms']:9.3f} ms  {r['calls']:6d}×  "
                  f"{r['name'][:90]}", flush=True)
        out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": busy_ms,
                     "qmm_wgmma_device_ms": ours["qmm_wgmma"],
                     "qmm_wgmma_calls": calls["qmm_wgmma"],
                     "qmm_core_device_ms": ours["qmm"], "hist_device_ms": ours["hist"],
                     "mask_device_ms": ours["mask"], "hsthresh_device_ms": ours["hsthresh"],
                     "hsthresh_calls": calls["hsthresh"], "h_s_span_ms": h_s_ms,
                     "device_launches": device_launches, "proposals": proposals,
                     "kernels": rows[:40]}
    return out


def phase_group_kernel(torch, mods):
    """qmm_group against qmm_group_ref at the per_block LOFAR shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    QG, ref_fn, prng = mods["QMM_GROUP"], mods["qmm_group_ref"], mods["prng"]
    unpack_codes, expand = mods["unpack_codes"], mods["expand_block_scale"]
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gran = f"per_block:{GROUP}"
    rows, max_err, core_rows, mis_rows, mis_launches = [], 0.0, [], [], 0
    for bits in (2, 4, 8):
        # the main path's own per-orientation quantization of Φ
        op = mods["pack_operator"](phi, bits, prng.fold_in(prng.PRNGKey(0), 0), shared=False,
                                   granularity=gran)
        ragged = mods["pack_weights"](torch.randn(333, 1001, generator=gen, device=dev), bits,
                                      prng.PRNGKey(bits), granularity=gran)
        cases = [("lofar_fwd", op.fwd_re, M_VALUES), ("lofar_adj", op.adj_re, M_VALUES),
                 ("ragged", ragged, (5,))]
        for name, w, ms in cases:
            k = w.k_dim
            n, kp = w.packed.shape
            n_groups = w.scale.shape[1]
            wdeq = (unpack_codes(w.packed, bits, k).to(torch.float32)
                    * expand(w.scale, GROUP, k) / (2 ** (bits - 1) // 2))
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev)
                if mods["cuda_kernel"](w) is not QG or QG.library.source.name != "qmm_wgmma.cu":
                    raise AssertionError(f"qmm_group {name}: not routed to QMM_GROUP")
                before = QG.launches
                y = mods["qmm"](x, w)
                if QG.launches != before + 1:
                    raise AssertionError(f"qmm_group {name} bits={bits} M={m}: QMM_GROUP was "
                                         "not launched")
                ref = ref_fn(x, w.packed, w.scale, bits, k, GROUP)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm_group {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by, bb_ms = bound_ms(m, n, k, kp, n_groups)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k, "G": n_groups,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QG(x, w.packed, w.scale, bits, k, GROUP),
                                     20, flush),
                       "plain_ms": time_ms(torch, lambda: ref_fn(x, w.packed, w.scale, bits, k,
                                                                 GROUP), 5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms,
                       "device_ms": (device_ms(torch, lambda: QG(x, w.packed, w.scale, bits, k,
                                                                 GROUP),
                                               20, flush, "qmm_wgmma_kernel")
                                     if name != "ragged" and bits == cs.bits_phi else None)}
                rows.append(row)
                print(f"[chip_smoke]   qmm_group {name:9s} bits={bits} M={m:2d}: "
                      f"max|Δ|={row['max_abs_err']:.3g} kernel {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  matmul(f32 Φ̂) {row['library_ms']:.4f} ms  "
                      f"bound {b_ms:.4f} ms ({b_by}), bytes alone {bb_ms:.4f} ms, device "
                      f"(profiler) {row['device_ms']}", flush=True)
            if name != "ragged" and bits == cs.bits_phi:
                mrow, n_launch = misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush,
                                                 group=True)
                mis_rows.append(mrow)
                mis_launches += n_launch
            del wdeq
        del op
        # the CUDA-core route: g = 8 is no multiple of 16 (8 // bits divides it)
        core, g_core = mods["QMM_GROUP_CORE"], 8
        w = mods["pack_weights"](torch.randn(333, 1001, generator=gen, device=dev), bits,
                                 prng.PRNGKey(bits), granularity=f"per_block:{g_core}")
        x = torch.randn(5, 1001, generator=gen, device=dev)
        if mods["cuda_kernel"](w) is not core or core.library.source.name != "qmm.cu":
            raise AssertionError(f"g = {g_core} is not routed to the CUDA-core QMM_GROUP_CORE")
        before = (QG.launches, core.launches)
        y = mods["qmm"](x, w)
        if (QG.launches, core.launches) != (before[0], before[1] + 1):
            raise AssertionError(f"g = {g_core}: launched QMM_GROUP {QG.launches - before[0]}, "
                                 f"QMM_GROUP_CORE {core.launches - before[1]} times")
        ref = ref_fn(x, w.packed, w.scale, bits, 1001, g_core)
        wdeq = (unpack_codes(w.packed, bits, 1001).to(torch.float32)
                * expand(w.scale, g_core, 1001) / (2 ** (bits - 1) // 2))
        err = (y - ref).abs()
        if not bool((err <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)).all()):
            raise AssertionError(f"qmm_group core g={g_core} bits={bits}: max |Δ| "
                                 f"{float(err.max())} exceeds the tolerance")
        n, kp = w.packed.shape
        b_ms, b_by, bb_ms = bound_ms(5, n, 1001, kp, w.scale.shape[1])
        core_rows.append({"shape": "ragged", "bits": bits, "M": 5, "N": n, "K": 1001,
                          "G": w.scale.shape[1], "g": g_core, "max_abs_err": float(err.max()),
                          "ms": time_ms(torch, lambda: mods["qmm"](x, w), 20, flush),
                          "plain_ms": time_ms(torch, lambda: ref_fn(x, w.packed, w.scale, bits,
                                                                    1001, g_core), 5, flush),
                          "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                          "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms})
        print(f"[chip_smoke]   qmm_group (CUDA-core route) ragged bits={bits} g={g_core}: "
              f"max|Δ|={core_rows[-1]['max_abs_err']:.3g} kernel {core_rows[-1]['ms']:.4f} ms",
              flush=True)
    del phi, flush
    torch.cuda.empty_cache()
    exact = exact_checks(torch, mods, group=True)
    edges = edge_checks(torch, mods, group=True)
    return {"rows": rows, "max_abs_err": max_err, "group_size": GROUP, "entry": QG.entry,
            "source": QG.library.source.name, "exact": exact, "core_rows": core_rows,
            "edges": edges, "misaligned_rows": mis_rows, "misaligned_launches": mis_launches}


def phase_hs_kernels(torch, mods):
    """hist and mask against their plain versions, bit for bit."""
    dev = torch.device("cuda")
    HIST, MASK = mods["HIST"], mods["MASK"]
    ref = mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, launches = [], {"hist": 0, "mask": 0}
    for b, n in HS_SHAPES:
        # a projected gradient step's shape of data: nonnegative, half zeros
        x = torch.clamp_min(torch.randn(b, n, generator=gen, device=dev), 0.0)
        vmax = ref.row_vmax(x.abs())
        before = (HIST.launches, MASK.launches)
        h = HIST(x, vmax, NBINS)
        h_ref = ref.hist_ref(x.abs(), vmax, NBINS)
        t = ref.select_threshold(h, vmax, HS_S)
        y, y_ref = MASK(x, t), ref.mask_ref(x, t)
        launches["hist"] += HIST.launches - before[0]
        launches["mask"] += MASK.launches - before[1]
        torch.cuda.synchronize()
        if not torch.equal(h, h_ref):
            raise AssertionError(f"hist ({b}, {n}): differs from hist_ref in "
                                 f"{int((h != h_ref).sum())} bins")
        if not torch.equal(y, y_ref):
            raise AssertionError(f"mask ({b}, {n}): differs from mask_ref")
        hist_bytes = 4 * b * n + 4 * b + 4 * b * NBINS
        mask_bytes = 8 * b * n + 4 * b
        for name, kernel, plain, nbytes in (
                ("hist", lambda: HIST(x, vmax, NBINS), lambda: ref.hist_ref(x.abs(), vmax, NBINS),
                 hist_bytes),
                ("mask", lambda: MASK(x, t), lambda: ref.mask_ref(x, t), mask_bytes)):
            row = {"name": name, "B": b, "N": n, "max_abs_err": 0.0,
                   "ms": time_ms(torch, kernel, 50, flush),
                   "plain_ms": time_ms(torch, plain, 20, flush),
                   "library_ms": None,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            rows.append(row)
            print(f"[chip_smoke]   {name} B={b} N={n}: bitwise equal; kernel {row['ms']:.4f} ms "
                  f" plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms (bytes); "
                  "no single PyTorch call computes it", flush=True)
    del flush
    return {"rows": rows, "launches": launches}


def hs_chain(mods, x, s, nbins):
    """The H_s as the two-kernel chain computes it on the card: the plain
    vmax, the ``hist`` kernel, the plain pick, the ``mask`` kernel and the
    plain tie fill, some 35 device launches per call (the fused kernel's
    predecessor on the solver path, kept here as its yardstick)."""
    ref = mods["hsthresh_ref_mod"]
    vmax = ref.row_vmax(x.abs())
    h = mods["HIST"](x, vmax, nbins)
    t = ref.select_threshold(h, vmax, s)
    y = mods["MASK"](x, t)
    return ref.fill_threshold_bin(x, y, t, vmax / nbins, s)


def profile_calls(torch, fn, reps):
    """Device time (ms) and device launches (kernels, memsets, copies) per
    call of fn, from torch.profiler over reps warm calls; (None, None) when
    the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in evs)
    count = sum(e.count for e in evs)
    return (us / reps / 1e3, count / reps) if count else (None, None)


def phase_fused_hs(torch, mods):
    """The fused H_s against hsthresh_ref, bit for bit, one launch per call;
    timed beside the two-kernel chain it replaces and the plain version."""
    dev = torch.device("cuda")
    HS, ref = mods["HSTHRESH"], mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(13)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, launches = [], 0
    for b, n in HS_SHAPES:
        x = torch.clamp_min(torch.randn(b, n, generator=gen, device=dev), 0.0)
        # threshold-bin ties straddling the cluster's chunk edges (8,192 apart)
        ties = torch.randn(b, n, generator=gen, device=dev) * 0.1
        for edge in range(0, n, 8192):
            ties[:, max(0, edge - 6):edge + 6] = 1.0
        for label, inp in (("", x), (" ties across chunk edges", ties)):
            before = [k.launches for k in mods["KERNELS"]]
            y = mods["hsthresh_cuda"](inp, HS_S, NBINS)
            moved = {k.entry: k.launches - c for k, c in zip(mods["KERNELS"], before)
                     if k.launches != c}
            if moved != {HS.entry: 1}:
                raise AssertionError(f"fused H_s ({b}, {n}){label}: launched {moved}")
            launches += 1
            want = ref.hsthresh_ref(inp, HS_S, NBINS)
            if not torch.equal(y, want) or not torch.equal(y, hs_chain(mods, inp, HS_S, NBINS)):
                raise AssertionError(f"fused H_s ({b}, {n}){label}: differs from hsthresh_ref "
                                     f"in {int((y != want).sum())} places")
        row = {"name": "hsthresh", "B": b, "N": n, "s": HS_S, "nbins": NBINS, "max_abs_err": 0.0,
               "ms": time_ms(torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50, flush),
               "chain_ms": time_ms(torch, lambda: hs_chain(mods, x, HS_S, NBINS), 50, flush),
               "plain_ms": time_ms(torch, lambda: ref.hsthresh_ref(x, HS_S, NBINS), 20, flush),
               "library_ms": None,
               "bound_ms": 8 * b * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "device_ms": device_ms(torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50,
                                      flush, "hsthresh_kernel")}
        row["device_ms_warm"], row["device_launches"] = profile_calls(
            torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50)
        row["chain_device_ms_warm"], row["chain_device_launches"] = profile_calls(
            torch, lambda: hs_chain(mods, x, HS_S, NBINS), 50)
        rows.append(row)
        print(f"[chip_smoke]   fused H_s B={b} N={n} s={HS_S}: bitwise equal (and on ties across "
              f"chunk edges); kernel {row['ms']:.4f} ms (device {row['device_ms']}, warm "
              f"{row['device_ms_warm']}; {row['device_launches']} device launches per call) | "
              f"two-kernel chain {row['chain_ms']:.4f} ms (device warm "
              f"{row['chain_device_ms_warm']}; {row['chain_device_launches']} launches per "
              f"call) | plain {row['plain_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms (bytes)",
              flush=True)
    del flush
    return {"rows": rows, "launches": launches}


def as_batch(res):
    """An IHTResult of qniht as a batch of one row (x (1, N), trace (T, 1))."""
    if res.x.ndim == 2:
        return res
    return type(res)(x=res.x[None], trace=type(res.trace)(*(t[:, None] for t in res.trace)))


def backtrack_steps(res):
    """Backtracking steps the batch took: Σ_i max_b n_bt[i, b]."""
    bt = as_batch(res).trace.backtracks
    return int(bt.max(dim=1).values.sum())


def hold_rows(torch, label, r_k, r_w, x_true):
    """Per row b: ‖Δx_b‖ ≤ 1e-3‖x_b‖ between kernel and witness, or a split at
    a knife-edge decision after trajectories that agreed to ≤ 1e-4 in
    ‖ŷ − Φ̂x‖, with rel_error within 0.01. Returns the readings."""
    r_k, r_w = as_batch(r_k), as_batch(r_w)
    x_true = x_true if x_true.ndim == 2 else x_true[None]
    rows = row_dx(torch, r_k.x, r_w.x)
    rel_k, rel_w = row_dx(torch, r_k.x, x_true), row_dx(torch, r_w.x, x_true)
    splits = {}
    for b, dx in enumerate(rows):
        if dx <= 1e-3:
            continue
        t, before = split_iteration(torch, r_k.trace, r_w.trace, b)
        d_rel = abs(rel_k[b] - rel_w[b])
        print(f"[chip_smoke]     {label} row {b}: ‖Δx_b‖/‖x_b‖={dx:.2e} (agree to {before:.1e} "
              f"in ‖ŷ − Φ̂x‖ until iteration {t}); rel_error kernel {rel_k[b]:.4f} witness "
              f"{rel_w[b]:.4f}", flush=True)
        splits[b] = {"dx_rel": dx, "split_iteration": t, "agree_before": before,
                     "rel_error": [rel_k[b], rel_w[b]]}
        if t is None or before > 1e-4:
            raise AssertionError(f"{label} row {b}: ‖Δx_b‖/‖x_b‖ = {dx} > 1e-3 without a "
                                 "split at a discrete decision")
        if d_rel > 0.01:
            raise AssertionError(f"{label} row {b}: rel_error differs from the witness's by "
                                 f"{d_rel} > 0.01 after the split")
    return {"dx_rows": rows, "rel_error_rows": rel_k, "witness_rel_error_rows": rel_w,
            "splits": splits}


def phase_lofar_block(torch, mods, per_tensor):
    """LOFAR CS302 at full size with a per_block (g = 64) packed Φ̂ through
    qmm_group, held per row against the qmm_group_ref witness; one
    per_channel solve through qmm."""
    QMM, QG, cs = mods["QMM"], mods["QMM_GROUP"], mods["LOFAR"]
    recover_lofar, dev = mods["recover_lofar"], mods["device"]
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        label = f"lofar per_block batch={batch}" if batch else "lofar per_block single"
        reset_counts(mods)
        m_k, r_k, x_true = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                         dev, "per_block", GROUP)
        launches, qmm_launches = QG.launches, QMM.launches
        by_shape.update(QG.launches_by_shape)
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QG and k.launches}
        want = expected_launches(r_k, cs.n_iters)
        with stand_in(mods["qmm_ops"], qmm_group_cuda=mods["qmm_group_ref"]):
            reset_counts(mods)
            m_w, r_w, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                        dev, "per_block", GROUP)
            if QG.launches:
                raise AssertionError("the witness run launched the group kernel")
        key = "rel_error" if not batch else "rel_error_mean"
        key_pt = "lofar single" if not batch else "lofar batch=8"
        rel_pt = per_tensor[key_pt]["packed"][key] if per_tensor else float("nan")
        print(f"[chip_smoke]   {label}: {key}={m_k[key]:.4f} (per_tensor {rel_pt:.4f}) "
              f"wall_s={m_k['wall_s']:.3f} | witness (qmm_group_ref) {key}={m_w[key]:.4f} "
              f"wall_s={m_w['wall_s']:.3f} | qmm_group launches {launches} (predicted {want}), "
              f"qmm launches {qmm_launches}", flush=True)
        held = hold_rows(torch, label, r_k, r_w, x_true)
        print(f"[chip_smoke]     ‖Δx_b‖/‖x_b‖ kernel vs witness: "
              + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
        if launches == 0 or launches != want:
            raise AssertionError(f"{label}: {launches} qmm_group launches, predicted {want}")
        if qmm_launches or others:
            raise AssertionError(f"{label}: the per_block path launched qmm {qmm_launches} "
                                 f"times and {others}")
        out[label] = {"kernel": m_k, "witness": m_w, "launches": launches,
                      "launches_predicted": want, "per_tensor_rel_error": rel_pt, **held}
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    out["launches_by_orientation"] = {"lofar_fwd": by_shape[(n_vis, n_pix)],
                                      "lofar_adj": by_shape[(n_pix, n_vis)]}
    reset_counts(mods)
    m_c, r_c, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev,
                                "per_channel")
    want = expected_launches(r_c, cs.n_iters)
    print(f"[chip_smoke]   lofar per_channel single: rel_error={m_c['rel_error']:.4f} "
          f"wall_s={m_c['wall_s']:.3f} | qmm launches {QMM.launches} (predicted {want}), "
          f"qmm_group {QG.launches}", flush=True)
    if QMM.launches != want or QG.launches:
        raise AssertionError(f"lofar per_channel: {QMM.launches} qmm launches (predicted "
                             f"{want}), {QG.launches} qmm_group launches")
    out["lofar per_channel single"] = {"packed": m_c, "launches": QMM.launches}
    # both with Φ: at full size the per_block solve parts from the reference's
    # on a Φ rebuilt there (1e-4 away), so the replay needs the card's own
    out["saved"] = [save_lofar_block(torch, mods, c, True) for c in (cs, mods["LOFAR_BENCH"])]
    return out


def save_lofar_block(torch, mods, cs, with_phi):
    """One sky of ``cs`` solved packed per_block (g = 64), saved with y (and Φ
    when ``with_phi``) for ``scripts/reference_replay.py lofar-block``."""
    import numpy as np

    dev = torch.device(mods["device"])
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    config = cs.name.replace("lofar-cs302", "lofar")        # the name recover takes
    saved = {"config": config, "y": y.cpu().numpy(), "x_true": x_true.cpu().numpy(),
             "bits_phi": cs.bits_phi, "bits_y": cs.bits_y, "seed": 0, "group_size": GROUP}
    if with_phi:
        saved["phi"] = phi.cpu().numpy()
    del phi
    m, r, xt = mods["recover_lofar"](cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev,
                                     "per_block", GROUP)
    if not torch.equal(xt, x_true):
        raise AssertionError("recover_lofar drew another sky than the saved one")
    saved["x_packed"] = r.x.real.cpu().numpy()
    path = mods["out_dir"] / f"{config.replace('-', '_')}_block.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    print(f"[chip_smoke]   {cs.name} per_block single, saved to {path.name}: rel_error="
          f"{m['rel_error']:.4f}", flush=True)
    return {"config": cs.name, "file": path.name, "rel_error": m["rel_error"]}


def support_trajectory(torch, mods, phi, Y, threshold):
    """The support after each iteration of a packed per_tensor LOFAR solve
    (n_iters, B, N), through the solver's own set-up and iteration."""
    cs = mods["LOFAR"]
    X, iteration = mods["solver_setup"](
        phi, Y, cs.n_sources, cs.bits_phi, cs.bits_y, mods["prng"].PRNGKey(0), "fixed",
        "packed", threshold, 0.01, 2.0, 30, True, True, False)
    supports = []
    for i in range(cs.n_iters):
        X, _ = iteration(X, i)
        supports.append(X != 0)
    return torch.stack(supports), X


def phase_lofar_hsthresh(torch, mods):
    """LOFAR CS302 at full size with threshold="hsthresh", per_tensor packed,
    through qniht/qniht_batch: the fused H_s launches once per proposal and
    hist and mask never; the same solves with the plain version standing in
    on the card must give the same x and trace bit for bit. The single
    solve's wall is taken five times beside the two-kernel chain's."""
    HIST, MASK, QMM, cs = mods["HIST"], mods["MASK"], mods["QMM"], mods["LOFAR"]
    HS = mods["HSTHRESH"]
    dev = torch.device(mods["device"])
    ref = mods["hsthresh_ref_mod"]
    kw = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
              requantize="fixed", backend="packed", real_signal=True, nonneg=True,
              threshold="hsthresh")
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        label = f"lofar hsthresh batch={batch}" if batch else "lofar hsthresh single"
        phi, y, x_true = mods["lofar_instance"](cs, 0, batch, dev)
        solve = mods["qniht_batch"] if batch else mods["qniht"]
        reset_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"hsthresh": HS.launches, "hist": HIST.launches, "mask": MASK.launches,
                    "qmm": QMM.launches, "qmm_group": mods["QMM_GROUP"].launches}
        others = {k.entry: k.launches for k in mods["KERNELS"]
                  if k not in (HS, HIST, MASK, QMM, mods["QMM_GROUP"]) and k.launches}
        by_shape.update(HS.launches_by_shape)
        want_hs = cs.n_iters + backtrack_steps(res)
        want_qmm = expected_launches(res, cs.n_iters)
        with stand_in(mods["hs_ops"], hsthresh_cuda=ref.hsthresh_ref):
            reset_counts(mods)
            res_w = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
            if HS.launches or HIST.launches or MASK.launches:
                raise AssertionError("the witness run launched an H_s kernel")
        same = torch.equal(res.x, res_w.x) and all(
            torch.equal(a, b) for a, b in zip(res.trace, res_w.trace))
        rel = row_dx(torch, as_batch(res).x, x_true if batch else x_true[None])
        Y = y if batch else y[None]
        sup_hs, x_hs = support_trajectory(torch, mods, phi, Y, "hsthresh")
        sup_top, x_top = support_trajectory(torch, mods, phi, Y, "topk")
        differ = (sup_hs != sup_top).any(dim=2)                # (n_iters, B)
        rel_top = row_dx(torch, x_top, x_true if batch else x_true[None])
        print(f"[chip_smoke]   {label}: rel_error {' '.join(f'{v:.4f}' for v in rel)} "
              f"(topk on the same codes {' '.join(f'{v:.4f}' for v in rel_top)}) wall_s="
              f"{wall:.3f} | fused H_s {launches['hsthresh']} launches (predicted {want_hs}), "
              f"hist {launches['hist']} mask {launches['mask']}, qmm {launches['qmm']} "
              f"(predicted {want_qmm}) | witness (hsthresh_ref on the card) "
              f"{'bitwise identical' if same else 'DIFFERS'} | iterations whose support "
              f"differs from topk: {int(differ.any(dim=1).sum())} of {cs.n_iters} (per row "
              f"{differ.sum(dim=0).tolist()})", flush=True)
        if not torch.equal(x_hs, res.x if batch else res.x[None]):
            raise AssertionError(f"{label}: the solver's own loop and qniht disagree")
        if not same:
            raise AssertionError(f"{label}: kernel and plain-version solves differ")
        if launches["hsthresh"] != want_hs or launches["hist"] or launches["mask"]:
            raise AssertionError(f"{label}: the fused H_s launched {launches['hsthresh']} times "
                                 f"(predicted {want_hs}), hist {launches['hist']}, mask "
                                 f"{launches['mask']} (predicted 0)")
        if launches["qmm"] != want_qmm or launches["qmm_group"] or others:
            raise AssertionError(f"{label}: qmm launched {launches['qmm']} times (predicted "
                                 f"{want_qmm}), qmm_group {launches['qmm_group']}, {others}")
        out[label] = {"rel_error_rows": rel, "topk_rel_error_rows": rel_top, "wall_s": wall,
                      "launches": launches, "hs_launches_predicted": want_hs,
                      "qmm_launches_predicted": want_qmm, "witness_bitwise": same,
                      "iterations_support_differs": int(differ.any(dim=1).sum()),
                      "iterations_support_differs_per_row": differ.sum(dim=0).tolist()}
        if not batch:
            out["walls"] = hsthresh_walls(torch, mods, solve, phi, y, kw, res)
    out["launches"] = sum(by_shape.values())
    return out


def hsthresh_walls(torch, mods, solve, phi, y, kw, res):
    """The single solve's wall five times with the fused H_s and five times
    with the two-kernel chain standing in, in turns (chain, fused, fused,
    chain, ...); both must give res's x bit for bit."""
    cs = mods["LOFAR"]
    walls = {"fused": [], "chain": []}
    order = ["chain", "fused", "fused", "chain"] * 2 + ["chain", "fused"]
    for which in order:
        with contextlib.ExitStack() as stack:
            if which == "chain":
                stack.enter_context(stand_in(mods["hs_ops"], hsthresh_cuda=lambda x, s, nbins:
                                             hs_chain(mods, x, s, nbins)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
        if not torch.equal(r.x, res.x):
            raise AssertionError(f"hsthresh solve with the {which} H_s: x differs")
    summary = {k: {"walls_s": v, "min_s": min(v), "median_s": sorted(v)[len(v) // 2],
                   "max_s": max(v)} for k, v in walls.items()}
    print("[chip_smoke]   lofar hsthresh single, wall over 5 solves each, in turns: "
          + " | ".join(f"{k}: median {w['median_s']:.3f} s (min {w['min_s']:.3f}, max "
                       f"{w['max_s']:.3f})" for k, w in summary.items()), flush=True)
    return summary


def phase_gaussian_block(torch, mods):
    """The Gaussian toy per_block, bits 4 and 8, batch 8, held per row
    against the same solves with qmm_group_ref standing in: g = 64 runs on
    the tensor-core QMM_GROUP, g = 8 (no multiple of 16) on the CUDA-core
    QMM_GROUP_CORE, and each must launch only its own kernel."""
    recover_gaussian, g = mods["recover_gaussian"], mods["GAUSS"]
    dev = torch.device(mods["device"])
    out = {}
    for bits, group_size in ((4, GROUP), (8, GROUP), (4, 8), (8, 8)):
        QG = mods["group_kernel"](group_size)
        label = f"gaussian per_block g={group_size} bits={bits} batch=8"
        reset_counts(mods)
        m_k, r_k, x_true = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                            "per_block", group_size)
        launches = QG.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QG and k.launches}
        with stand_in(mods["qmm_ops"], qmm_group_cuda=mods["qmm_group_ref"]):
            reset_counts(mods)
            m_w, r_w, _ = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                           "per_block", group_size)
            if QG.launches:
                raise AssertionError("the witness run launched the group kernel")
        print(f"[chip_smoke]   {label}: rel_error_mean={m_k['rel_error_mean']:.4f} "
              f"wall_s={m_k['wall_s']:.3f} | witness {m_w['rel_error_mean']:.4f} | "
              f"{QG.entry} launches {launches}", flush=True)
        held = hold_rows(torch, label, r_k, r_w, x_true)
        print(f"[chip_smoke]     ‖Δx_b‖/‖x_b‖ kernel vs witness: "
              + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
        if launches == 0 or others:
            raise AssertionError(f"{label}: {launches} {QG.entry} launches, others {others}")
        out[label] = {"kernel": m_k, "witness": m_w, "launches": launches,
                      "entry": QG.entry, **held}
    return out


def phase_sqround(torch, mods):
    """sqround through its entry point at the LOFAR Φ and two small shapes,
    bits 2/4/8, bit for bit against sqround_ref on the same words."""
    SQ, sqround, ref, prng = mods["SQROUND"], mods["sqround"], mods["sqround_ref"], mods["prng"]
    dev = torch.device("cuda")
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [("lofar_phi", phi.real.contiguous()),
             ("kernels_micro", torch.randn(512, 512, generator=gen, device=dev)),
             ("ragged", 3.0 * torch.randn(333, 1001, generator=gen, device=dev))]
    del phi
    keys = {bits: prng.fold_in(prng.PRNGKey(0), bits) for bits in (2, 4, 8)}
    reset_counts(mods)
    outs = {(name, bits): sqround(v, bits, keys[bits]) for name, v in cases for bits in keys}
    torch.cuda.synchronize()
    launches, by_shape = SQ.launches, dict(SQ.launches_by_shape)
    others = {k.entry: k.launches for k in mods["KERNELS"] if k is not SQ and k.launches}
    if launches != len(outs) or others:
        raise AssertionError(f"sqround: {launches} launches for {len(outs)} calls, others {others}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, v in cases:
        m = v.abs().amax()
        want_scale = torch.where(m > 0, m, torch.ones_like(m))
        for bits, key in keys.items():
            codes, scale = outs[(name, bits)]
            words = mods["narrow_words"](prng.bits(key, v.shape, device=dev))
            plain = ref(v, words, scale, bits)
            differ = int((codes != plain).sum())
            if differ or not torch.equal(scale, want_scale):
                raise AssertionError(f"sqround {name} bits={bits}: {differ} codes differ from "
                                     f"sqround_ref; scale {float(scale)} (want {float(want_scale)})")
            n = v.numel()
            row = {"shape": name, "bits": bits, "R": v.shape[0], "C": v.shape[1],
                   "max_abs_err": 0.0,
                   "ms": time_ms(torch, lambda: SQ(v, words, scale, bits), 20, flush),
                   "call_ms": time_ms(torch, lambda: sqround(v, bits, key), 3, flush),
                   "plain_ms": time_ms(torch, lambda: ref(v, words, scale, bits), 5, flush),
                   "library_ms": None,
                   "bound_ms": 9 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            rows.append(row)
            print(f"[chip_smoke]   sqround {name:13s} {v.shape[0]}x{v.shape[1]} bits={bits}: "
                  f"bitwise equal; kernel {row['ms']:.4f} ms  whole call (threefry draw "
                  f"included) {row['call_ms']:.3f} ms  plain {row['plain_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms (bytes); no single PyTorch call computes it",
                  flush=True)
    del cases, outs, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches,
            "launches_by_shape": {str(k): n for k, n in by_shape.items()}}


def attention_pairs(sq, sk, causal, window=None, off=None):
    """The (query, key) pairs attention computes: row i, at key position
    i + off (default Sk - Sq), sees keys j < Sk with j <= i + off (causal)
    and i + off - j < window (a window)."""
    off = sk - sq if off is None else off
    pairs = 0
    for i in range(sq):
        pos = i + off
        hi = min(sk - 1, pos) if causal else sk - 1
        lo = max(0, pos - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def attention_bound(b, hq, hkv, sq, sk, d, itemsize, causal, window=None, off=None):
    """(bound ms, bound_by, ms at the f32 CUDA-core peak): q, k, v and o
    moved once, or 4·D flops per visible (query, key) pair
    (``attention_pairs``) over the peak of the inputs' type."""
    pairs = attention_pairs(sq, sk, causal, window, off)
    flops = 4 * b * hq * d * pairs
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            flops / F32_FLOP_PER_S * 1e3)


def attention_gap(torch, out, ref, tol):
    """How far an attention output is from the plain version's: elements off
    by more than tol (abs and rel), rows with ‖Δ‖₂ > 2⁻⁷·‖ref‖₂, max |Δ| and
    the largest ‖Δ‖₂/‖ref‖₂ of a row."""
    err = out.float() - ref.float()
    ref_abs = ref.float().abs()
    over = int((err.abs() > tol + tol * ref_abs).sum())
    err_norm, ref_norm = err.norm(dim=-1), ref_abs.norm(dim=-1)
    return {"over": over, "rows_over": int((err_norm > BF16_ROW_REL * ref_norm).sum()),
            "finite": bool(torch.isfinite(out).all()), "max_abs_err": float(err.abs().max()),
            "max_row_rel": float((err_norm / ref_norm.clamp_min(1e-30)).max())}


def held(torch, label, out, ref, tol, rows):
    """attention_gap, raising where it fails: every element within tol (abs
    and rel), and with ``rows`` (16-bit outputs) every row within 2⁻⁷ in
    2-norm."""
    gap = attention_gap(torch, out, ref, tol)
    if gap["over"] or (rows and gap["rows_over"]) or not gap["finite"]:
        raise AssertionError(f"flash_attention {label}: {gap['over']} elements off by more "
                             f"than {tol} (abs and rel), {gap['rows_over'] if rows else 0} "
                             f"rows off by more than 2^-7 in 2-norm, max |Δ| "
                             f"{gap['max_abs_err']}, max row ‖Δ‖/‖ref‖ {gap['max_row_rel']}")
    return gap


def plain_chunked(torch, plain, q, k, v, scale, flush=None):
    """The plain version of a causal Sq = Sk call, PLAIN_CHUNK_ROWS query rows
    a call (rows a.. see keys < a + chunk), and its device time in ms."""
    s = q.shape[2]
    full = torch.empty_like(q)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if flush is not None:
        flush.zero_()
    start.record()
    for a in range(0, s, PLAIN_CHUNK_ROWS):
        e = a + PLAIN_CHUNK_ROWS
        full[:, :, a:e] = plain(q[:, :, a:e], k[:, :, :e], v[:, :, :e], causal=True,
                                scale=scale)
    end.record()
    end.synchronize()
    return full, start.elapsed_time(end)


def starcoder2_qkv(torch, gen, s, dtype=None):
    """q, k, v of starcoder2-3b's attention at length s, B = 1, in dtype
    (bf16 by default)."""
    return tuple(torch.randn(1, h, s, STARCODER2_3B_HEAD_DIM, generator=gen,
                             device=gen.device).to(dtype or torch.bfloat16)
                 for h in (STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_KV_HEADS))


def sdpa_backend(torch, lib, q, k, v, attn_mask=None, causal=True):
    """The backend scaled_dot_product_attention chose for the call whose
    output is ``lib`` (causal, with the boolean ``attn_mask``, or with
    neither when not ``causal``): the first of cuDNN, flash, efficient and
    math (in PyTorch's order of preference) that, asked for alone, gives the
    same bits; None when none does or none takes the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = ({"attn_mask": attn_mask} if attn_mask is not None else
            {"is_causal": True} if causal else {})
    for name, backend in (("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("math", SDPBackend.MATH)):
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                                       **mask)
        except RuntimeError:          # this backend refuses the inputs
            continue
        if torch.equal(out, lib):
            return name
    return None


def phase_flash(torch, mods):
    """flash_attention through its entry point at starcoder2-3b's width
    (causal; bf16 at S = 4,096 and 32,768, fp16 and f32 at 4,096), at
    stablelm-12b's (D = 160), recurrentgemma-2b's (D = 256) and qwen3-moe
    SMOKE's (D = 8) widths in bf16 at 4,096, stablelm-12b and
    recurrentgemma-2b at the LM prefill's B = 8, S = 1,024, starcoder2-3b's
    bf16 and f32 at 4,096 with q, k, v as views off a 16-byte boundary, and small
    shapes (f32 ragged and cross; D = 8, 160, 256 in f32, bf16 and fp16;
    views 2 elements in, and 16-bit views 1 element in at D = 160 and 256),
    held against the plain version; timed beside
    scaled_dot_product_attention. Each call must launch the kernel its case
    names: FLASH (aligned f32), FLASH_UNALIGNED (f32 views off a 16-byte
    boundary), FLASH_TC (aligned 16-bit, every D) or FLASH_TC_UNALIGNED
    (16-bit views off a 16-byte boundary)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    from torch.nn.attention import SDPBackend, sdpa_kernel

    flash_attention, plain = mods["flash_attention"], mods["attention_plain"]
    routes = {name: mods[name] for name in ("FLASH", "FLASH_TC", "FLASH_TC_UNALIGNED",
                                            "FLASH_UNALIGNED")}

    def sdpa(q, k, v, flash=None):
        """The library call: its flash backend for 16-bit inputs at D <= 128
        (never the math one, which would materialize the S² scores); for
        float32, which that backend refuses, and wider heads, PyTorch's own
        choice (``flash=True`` asks for the flash backend there too), TF32
        off. Its kernels read 16-byte vectors and fault on views off a
        16-byte boundary, so such views are handed to it as aligned copies
        (made outside the timed call)."""
        if flash is None:
            flash = q.dtype != torch.float32 and q.shape[-1] <= 128
        with (sdpa_kernel([SDPBackend.FLASH_ATTENTION]) if flash
              else contextlib.nullcontext()):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def qkv(b, hq, hkv, sq, sk, d, dtype, offset=0, g=None):
        """q, k, v (drawn from ``g``, default ``gen``); with ``offset``, each
        a view that many elements into a larger tensor."""
        out = []
        for h, s in ((hq, sq), (hkv, sk), (hkv, sk)):
            t = torch.randn(b, h, s, d, generator=g or gen, device=dev).to(dtype)
            if offset:
                flat = torch.zeros(offset + t.numel(), dtype=dtype, device=dev)
                view = flat[offset:].view(t.shape)
                view.copy_(t)
                t = view
            out.append(t)
        return tuple(out)

    hq, hkv, d = STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_HEAD_DIM
    f32, bf16, fp16 = torch.float32, torch.bfloat16, torch.float16
    # (label, causal, (q, k, v), tolerance, kernel that must run it)
    small = [(f"{name} causal={causal}", causal, qkv(*shape, f32), 2e-4, "FLASH")
             for name, shape in (("ragged", (2, 4, 2, 333, 333, 64)),
                                 ("cross", (1, 4, 2, 64, 256, 32)))
             for causal in (True, False)]
    small += [(f"D={dd} {str(dt)[6:]}", True, qkv(2, 4, 2, 200, 333, dd, dt),
               2e-4 if dt == f32 else 2e-2, "FLASH" if dt == f32 else "FLASH_TC")
              for dd in (8, 160, 256) for dt in (f32, bf16, fp16)]
    small += [(f"views 2 elements in, D=64 {str(dt)[6:]}", True,
               qkv(1, 4, 2, 130, 130, 64, dt, offset=2), 2e-4 if dt == f32 else 2e-2,
               "FLASH_UNALIGNED" if dt == f32 else "FLASH_TC_UNALIGNED")
              for dt in (f32, bf16, fp16)]
    small += [(f"views 1 element in, D={dd} {str(dt)[6:]} causal={causal}", causal,
               qkv(2, 4, 2, 200, 333, dd, dt, offset=1), 2e-2, "FLASH_TC_UNALIGNED")
              for dd in (160, 256) for dt in (bf16, fp16) for causal in (True, False)]
    small = [case + (None, None) for case in small]
    # a sliding window and a query offset on every route (window, q_offset),
    # drawn from a generator of their own
    band_gen = torch.Generator(device=dev).manual_seed(23)
    small += [(f"{what}, D={dd} {str(dt)[6:]}{' views 1 element in' if n else ''}", causal,
               qkv(2, 4, 2, sq, sk, dd, dt, offset=n, g=band_gen),
               2e-4 if dt == f32 else 2e-2, kernel, window, q_offset)
              for dt, n, kernel in ((f32, 0, "FLASH"), (f32, 1, "FLASH_UNALIGNED"),
                                    (bf16, 0, "FLASH_TC"), (fp16, 0, "FLASH_TC"),
                                    (bf16, 1, "FLASH_TC_UNALIGNED"))
              for dd in (128, 256)
              for what, causal, sq, sk, window, q_offset in FLASH_BAND_CASES]
    # (label, B, S, dtype, (q, k, v), kernel, (Hq, Hkv, D))
    big = [(f"starcoder2_3b S={s} {name}", 1, s, dtype, starcoder2_qkv(torch, gen, s, dtype),
            "FLASH" if dtype == f32 else "FLASH_TC", (hq, hkv, d))
           for s, name, dtype in ((TRAIN_4K_LEN, "bf16", bf16), (PREFILL_32K_LEN, "bf16", bf16),
                                  (TRAIN_4K_LEN, "fp16", fp16), (TRAIN_4K_LEN, "f32", f32))]
    wide = (("stablelm_12b", *STABLELM_12B_ATTN), ("recurrentgemma_2b", *RECURRENTGEMMA_2B_ATTN))
    big += [(f"{name} S={TRAIN_4K_LEN} bf16", 1, TRAIN_4K_LEN, bf16,
             qkv(1, heads, kv, TRAIN_4K_LEN, TRAIN_4K_LEN, dd, bf16), "FLASH_TC",
             (heads, kv, dd))
            for name, heads, kv, dd in (*wide, ("qwen3_moe_235b_smoke", *QWEN3_MOE_SMOKE_ATTN))]
    big += [(f"{name} B={LM_BATCH} S={LM_PROMPT} bf16", LM_BATCH, LM_PROMPT, bf16,
             qkv(LM_BATCH, heads, kv, LM_PROMPT, LM_PROMPT, dd, bf16), "FLASH_TC",
             (heads, kv, dd))
            for name, heads, kv, dd in wide]
    big += [(f"starcoder2_3b S={TRAIN_4K_LEN} {name} views {n} element{'s' * (n > 1)} in", 1,
             TRAIN_4K_LEN, dtype, qkv(1, hq, hkv, TRAIN_4K_LEN, TRAIN_4K_LEN, d, dtype, offset=n),
             kernel, (hq, hkv, d))
            for name, dtype, n, kernel in (("bf16", bf16, 2, "FLASH_TC_UNALIGNED"),
                                           ("f32", f32, 1, "FLASH_UNALIGNED"))]
    reset_counts(mods)
    outs, expected = [], collections.Counter()
    for label, causal, t, _, kernel, window, q_offset in small:
        outs.append(flash_attention(*t, causal=causal, window=window, q_offset=q_offset))
        expected[kernel] += 1
    for label, _, _, _, t, kernel, _ in big:
        outs.append(flash_attention(*t, causal=True))
        expected[kernel] += 1
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in routes.items()}
    others = {k.entry: k.launches for k in mods["KERNELS"]
              if k not in routes.values() and k.launches}
    if launches != {name: expected[name] for name in routes} or others:
        raise AssertionError(f"flash_attention: launches {launches}, expected "
                             f"{dict(expected)}; others {others}")
    by_shape = {k.entry: {str(key): n for key, n in k.launches_by_shape.items()}
                for k in routes.values()}

    for (label, causal, (q, k, v), tol, kernel, window, q_offset), out in zip(small, outs):
        err = held(torch, label, out,
                   plain(q, k, v, causal=causal, scale=1.0 / q.shape[-1] ** 0.5, window=window,
                         q_offset=q_offset), tol, q.dtype != f32)["max_abs_err"]
        print(f"[chip_smoke]   flash_attention {label} {tuple(q.shape)} kv {tuple(k.shape)} "
              f"({routes[kernel].entry}): max|Δ|={err:.3g} (tolerance {tol:g})", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for (label, b, s, dtype, (q, k, v), kernel, (h_q, h_kv, dd)), out in zip(
            big, outs[len(small):]):
        is_f32 = dtype == f32
        tol = 2e-4 if is_f32 else 2e-2
        scale = 1.0 / dd ** 0.5          # flash_attention's default
        row = {"shape": label, "B": b, "Hq": h_q, "Hkv": h_kv, "S": s, "D": dd,
               "dtype": str(dtype).replace("torch.", ""), "kernel": routes[kernel].entry,
               "route": kernel}
        if s != PREFILL_32K_LEN:
            ref = plain(q, k, v, causal=True, scale=scale)
            gap = held(torch, label, out, ref, tol, not is_f32)
            row["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, causal=True, scale=scale),
                                      3, flush)
            row["plain_how"] = f"one call ({b * h_q}·S² f32 scores)"
            reps = 10
        else:
            tail = plain(q[:, :, -PREFILL_TAIL_ROWS:], k, v, causal=True, scale=scale)
            tail_gap = held(torch, f"{label} last {PREFILL_TAIL_ROWS} rows",
                            out[:, :, -PREFILL_TAIL_ROWS:], tail, tol, True)
            row["tail_max_abs_err"] = tail_gap["max_abs_err"]
            row["tail_max_row_rel"] = tail_gap["max_row_rel"]
            del tail
            ref, row["plain_ms"] = plain_chunked(torch, plain, q, k, v, scale, flush)
            row["plain_how"] = f"{s // PLAIN_CHUNK_ROWS} calls of {PLAIN_CHUNK_ROWS} query rows"
            gap = held(torch, f"{label} every row", out, ref, tol, True)
            reps = 3
        row["max_abs_err"], row["max_row_rel"] = gap["max_abs_err"], gap["max_row_rel"]
        row["ms"] = time_ms(torch, lambda: flash_attention(q, k, v, causal=True), reps, flush)
        lq, lk, lv = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
        lib = sdpa(lq, lk, lv)
        row["library_backend"] = sdpa_backend(torch, lib, lq, lk, lv)
        row["library_max_abs_diff"] = float((lib.float() - out.float()).abs().max())
        # the library's own distance from the plain version: a witness of what
        # a kernel that rounds P to 16 bits reaches (reported, not gated)
        lib_gap = attention_gap(torch, lib, ref, tol)
        row["library_max_abs_err"] = lib_gap["max_abs_err"]
        row["library_max_row_rel"] = lib_gap["max_row_rel"]
        del lib, ref
        row["library_ms"] = time_ms(torch, lambda: sdpa(lq, lk, lv), 10, flush)
        if not is_f32 and dd > 128:      # PyTorch chose; its flash backend, where it takes D
            try:
                sdpa(lq, lk, lv, flash=True)
                row["library_flash_ms"] = time_ms(torch, lambda: sdpa(lq, lk, lv, flash=True),
                                                  10, flush)
            except RuntimeError as exc:  # the backend refuses this head dim: recorded
                row["library_flash_ms"] = None
                row["library_flash_refused"] = str(exc).splitlines()[0][:200]
        del lq, lk, lv
        row["bound_ms"], row["bound_by"], row["f32_core_bound_ms"] = attention_bound(
            b, h_q, h_kv, s, s, dd, q.element_size(), True)
        rows.append(row)
        flash_note = ("" if "library_flash_ms" not in row else
                      f"; its flash backend {row['library_flash_ms']:.3f} ms"
                      if row["library_flash_ms"] is not None else "; its flash backend refuses")
        print(f"[chip_smoke]   flash_attention {label} ({b}×{h_q}/{h_kv} heads, D={dd}, causal, "
              f"{row['kernel']}): max|Δ|={row['max_abs_err']:.3g} (tolerance {tol:g}), max row "
              f"‖Δ‖/‖ref‖={row['max_row_rel']:.3g}"
              f"{'' if is_f32 else ' (tolerance 2^-7)'} [sdpa {row['library_max_row_rel']:.3g}]; "
              f"kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms ({row['plain_how']})  "
              f"sdpa {row['library_ms']:.3f} ms ({row['library_backend']}{flash_note}; |Δ| to "
              f"the kernel {row['library_max_abs_diff']:.3g})  bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}; {row['f32_core_bound_ms']:.2f} ms at the f32 CUDA-core "
              f"peak)", flush=True)
    del small, big, outs, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "launches_by_shape": by_shape}


def flash_mutants(torch, mods):
    """Plant each fault of FLASH_MUTANTS in a copy of flashattn_wgmma.cu in a
    temporary directory, build the copies and the real source together, and
    hold each at starcoder2-3b's width (bf16, causal) to phase 12's checks:
    S = 4,096 every row, S = 32,768 the last 256 rows and every row. For each
    check it reports the elementwise 2e-2 rule and the 2⁻⁷ row rule apart."""
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    plain, FLASH_TC = mods["attention_plain"], mods["FLASH_TC"]

    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"kernel": FLASH_TC}
        for name, library in flash_mutant_libraries(mods, tmp).items():
            kernels[name] = type(FLASH_TC)(library, FLASH_TC.entry, FLASH_TC.dtypes)
        phase_build([k.library for k in kernels.values()])

        gen = torch.Generator(device=torch.device("cuda")).manual_seed(5)
        scale = 1.0 / STARCODER2_3B_HEAD_DIM ** 0.5
        results = {name: {} for name in kernels}
        for s in (TRAIN_4K_LEN, PREFILL_32K_LEN):
            q, k, v = starcoder2_qkv(torch, gen, s)
            if s == TRAIN_4K_LEN:
                checks = {f"S={s} every row": (slice(None), plain(q, k, v, causal=True,
                                                                  scale=scale))}
            else:
                tail = plain(q[:, :, -PREFILL_TAIL_ROWS:], k, v, causal=True, scale=scale)
                checks = {f"S={s} last {PREFILL_TAIL_ROWS} rows":
                          (slice(s - PREFILL_TAIL_ROWS, s), tail),
                          f"S={s} every row": (slice(None),
                                               plain_chunked(torch, plain, q, k, v, scale)[0])}
            for name, kernel in kernels.items():
                out = kernel(q, k, v, True, scale)
                for check, (rows, ref) in checks.items():
                    gap = attention_gap(torch, out[:, :, rows], ref, 2e-2)
                    gap["elementwise_2e-2"] = "pass" if gap["over"] == 0 and gap["finite"] \
                        else "FAIL"
                    gap["row_2^-7"] = "pass" if gap["rows_over"] == 0 else "FAIL"
                    results[name][check] = gap
                    print(f"[chip_smoke]   {name:13s} {check:22s} elementwise 2e-2: "
                          f"{gap['elementwise_2e-2']} ({gap['over']} elements over, max|Δ| "
                          f"{gap['max_abs_err']:.3g})  row 2^-7: {gap['row_2^-7']} "
                          f"({gap['rows_over']} rows over, max ‖Δ‖/‖ref‖ "
                          f"{gap['max_row_rel']:.3g})", flush=True)
                del out
            del q, k, v, checks
            torch.cuda.empty_cache()

    def failed(name):
        return any(g["elementwise_2e-2"] == "FAIL" or g["row_2^-7"] == "FAIL"
                   for g in results[name].values())

    missed = [name for name in FLASH_MUTANTS if not failed(name)]
    if failed("kernel") or missed:
        raise AssertionError(f"flash mutants: the real kernel failed a check: "
                             f"{failed('kernel')}; mutants no check caught: {missed}")
    return {"mutants": {n: what for n, (what, _) in FLASH_MUTANTS.items()},
            "results": results}


@contextlib.contextmanager
def record_iterations(mods):
    """The solver with a witness on its step (it changes no arithmetic; the
    solver's own loop runs): for every iteration, each row's raw backtracking
    steps (before the freeze rule masks them) and what the early exit reads
    of the raw update x → x⁺: whether x⁺ = x bit for bit, ‖x⁺ − x‖² and
    ‖x⁺‖² (summed per row as the solver sums them)."""
    niht = mods["niht"]
    real_setup = niht._solver_setup
    log = {"bt": [], "still": [], "dx2": [], "x2": []}

    def setup(*args, **kw):
        x0, iteration = real_setup(*args, **kw)

        def step(X, i):
            X_new, outs = iteration(X, i)
            log["bt"].append(outs[4])
            log["still"].append((X_new == X).all(dim=-1))
            log["dx2"].append(niht._rowwise_sqnorm(X_new - X))
            log["x2"].append(niht._rowwise_sqnorm(X_new))
            return X_new, outs
        return x0, step

    with stand_in(niht, _solver_setup=setup):
        yield log


def row_of(res, b):
    """Row b of a batch result, as a single solve's result."""
    return type(res)(x=res.x[b], trace=type(res.trace)(*(t[:, b] for t in res.trace)))


def same_bits(torch, a, b):
    """x and every trace field equal bit for bit (a, b as batches)."""
    a, b = as_batch(a), as_batch(b)
    return torch.equal(a.x, b.x) and all(torch.equal(u, v) for u, v in zip(a.trace, b.trace))


def iterations_per_row(torch, mods, log, n_iters, exit_tol):
    """The iterations each row runs before the early exit marks it done,
    worked out from the witness's raw updates by the reference's rule
    (lossless: the first x⁺ = x; freeze: the first ``_EXIT_PATIENCE``
    consecutive ‖x⁺ − x‖² ≤ exit_tol²·‖x⁺‖²); n_iters for a row never done."""
    if exit_tol == 0.0:
        hit = torch.stack(log["still"]).cpu()
    else:
        small = (torch.stack(log["dx2"]) <= (exit_tol * exit_tol) * torch.stack(log["x2"])).cpu()
        hit = torch.zeros_like(small)
        streak = torch.zeros(small.shape[1], dtype=torch.int64)
        for t in range(small.shape[0]):
            streak = torch.where(small[t], streak + 1, torch.zeros_like(streak))
            hit[t] = streak >= mods["niht"]._EXIT_PATIENCE
    out = []
    for b in range(hit.shape[1]):
        when = torch.nonzero(hit[:, b]).flatten()
        out.append(int(when[0]) + 1 if when.numel() else n_iters)
    return out


def syncs_and_launches(torch, fn):
    """Host syncs of one call of fn (torch's sync debug mode warns once per
    synchronizing call) and its device launches (torch.profiler: kernels,
    memsets, copies; None when the profiler sees none)."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    return syncs, launches or None


def phase_solver(torch, mods):
    """The rest of the solver on LOFAR CS302 at full size (per_tensor packed,
    60 iterations), single and batch 8, through qniht/qniht_batch and the
    segment API: the lossless early exit and segments of 7 + 23 + 30 give
    the one-shot run's bits, the freeze rule (exit_tol = 1e-4) gives each
    row of the batch the bits of its single solve (also the rows three times
    over, 24, past ROW_LOCAL_ROWS), and qmm launches 14 times per iteration
    run plus 2 per backtracking step, per block of rows under the freeze
    rule."""
    QMM, cs = mods["QMM"], mods["LOFAR"]
    dev = torch.device(mods["device"])
    kw = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
              requantize="fixed", backend="packed", real_signal=True, nonneg=True)
    seg_kw = {k: v for k, v in kw.items() if k != "key"}
    out = {"qmm_launches": 0}

    def run(label, fn, batch, early_exit=False, exit_tol=0.0):
        """fn() under the step witness: the loop must stop where the rows'
        exits say (all n_iters without the exit), and qmm launch 14 times per
        iteration run plus 2 per backtracking step, for each block of up to
        ROW_LOCAL_ROWS rows the freeze rule applies Φ̂ in."""
        reset_counts(mods)
        with record_iterations(mods) as log:
            res = fn()
        torch.cuda.synchronize()
        launches = QMM.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QMM and k.launches}
        iters = len(log["bt"])
        blocks = -(-batch // mods["ROW_LOCAL_ROWS"]) if exit_tol > 0.0 else 1
        want = blocks * (14 * iters + 2 * sum(int(bt.max()) for bt in log["bt"]))
        rows = (iterations_per_row(torch, mods, log, cs.n_iters, exit_tol) if early_exit
                else [cs.n_iters] * batch)
        if iters != min(cs.n_iters, max(rows)):
            raise AssertionError(f"{label}: the loop ran {iters} iterations, the rows' exits "
                                 f"say {min(cs.n_iters, max(rows))} (per row {rows})")
        if launches == 0 or launches != want or others:
            raise AssertionError(f"{label}: qmm launched {launches} times (predicted {want} "
                                 f"for {iters} iterations), others {others}")
        out["qmm_launches"] += launches
        return res, {"iterations": iters, "iterations_per_row": rows, "qmm_launches": launches,
                     "qmm_launches_predicted": want}

    for batch in (0, 8):
        phi, y, x_true = mods["lofar_instance"](cs, 0, batch, dev)
        Y, X_true = (y, x_true) if batch else (y[None], x_true[None])
        single = mods["qniht"] if not batch else mods["qniht_batch"]

        def solve(**extra):
            return single(phi, y, cs.n_sources, cs.n_iters, **kw, **extra)

        def segments():
            st = mods["solver_init"](phi, Y, cs.n_sources, cs.n_iters, **kw)
            for n in SOLVER_SEGMENTS:
                st = mods["solver_segment"](phi, st, n, s=cs.n_sources, **seg_kw)
            return mods["solver_result"](st)

        tag = f"batch={batch}" if batch else "single"
        base, i_base = run(f"solver {tag} one-shot", solve, max(batch, 1))
        early, i_early = run(f"solver {tag} early_exit", lambda: solve(early_exit=True),
                             max(batch, 1), early_exit=True)
        seg, i_seg = run(f"solver {tag} segments", segments, max(batch, 1))
        rel = row_dx(torch, as_batch(base).x, X_true)
        checks = {"early_exit": same_bits(torch, early, base),
                  "segments": same_bits(torch, seg, base)}
        print(f"[chip_smoke]   solver {tag}: rel_error {' '.join(f'{v:.4f}' for v in rel)} | "
              f"one-shot {i_base['iterations']} iterations, qmm {i_base['qmm_launches']} | "
              f"early_exit ran {i_early['iterations']} iterations (per row "
              f"{i_early['iterations_per_row']}), qmm {i_early['qmm_launches']} (predicted "
              f"{i_early['qmm_launches_predicted']}), "
              f"{'bitwise identical' if checks['early_exit'] else 'DIFFERS'} | segments "
              f"{'+'.join(map(str, SOLVER_SEGMENTS))}: qmm {i_seg['qmm_launches']}, "
              f"{'bitwise identical' if checks['segments'] else 'DIFFERS'}", flush=True)
        entry = {"rel_error_rows": rel, "one_shot": i_base, "early_exit": i_early,
                 "segments": i_seg, **{f"{k}_bitwise": v for k, v in checks.items()}}
        for name, ok in checks.items():
            if not ok:
                raise AssertionError(f"solver {tag}: {name} differs from the one-shot run")
        if batch:
            frozen, i_frozen = run(f"solver {tag} exit_tol", lambda: solve(
                early_exit=True, exit_tol=EXIT_TOL), batch, early_exit=True, exit_tol=EXIT_TOL)
            alone, singles = [], []
            for b in range(batch):
                r, i_b = run(f"solver row {b} alone, exit_tol", lambda: mods["qniht"](
                    phi, y[b], cs.n_sources, cs.n_iters, early_exit=True, exit_tol=EXIT_TOL,
                    **kw), 1, early_exit=True, exit_tol=EXIT_TOL)
                singles.append(r)
                alone.append({"bitwise": same_bits(torch, r, row_of(frozen, b)),
                              "iterations": i_b["iterations"]})
            # past ROW_LOCAL_ROWS rows: the batch three times over, in blocks
            tall = FREEZE_TILES * batch
            tiled, i_tiled = run(f"solver batch={tall} exit_tol", lambda: mods["qniht_batch"](
                phi, y.repeat(FREEZE_TILES, 1), cs.n_sources, cs.n_iters, early_exit=True,
                exit_tol=EXIT_TOL, **kw), tall, early_exit=True, exit_tol=EXIT_TOL)
            tiled_ok = [same_bits(torch, singles[b % batch], row_of(tiled, b))
                        for b in range(tall)]
            rel_f = row_dx(torch, frozen.x, X_true)
            print(f"[chip_smoke]   solver {tag} exit_tol={EXIT_TOL}: rows frozen after "
                  f"{i_frozen['iterations_per_row']} iterations, the loop ran "
                  f"{i_frozen['iterations']}, qmm {i_frozen['qmm_launches']} (predicted "
                  f"{i_frozen['qmm_launches_predicted']}) | rel_error "
                  f"{' '.join(f'{v:.4f}' for v in rel_f)} | each row against its single "
                  f"solve: {['bitwise' if a['bitwise'] else 'DIFFERS' for a in alone]} "
                  f"(single solves ran {[a['iterations'] for a in alone]} iterations) | "
                  f"batch={tall} (the rows {FREEZE_TILES} times over, blocks of "
                  f"{mods['ROW_LOCAL_ROWS']}): qmm {i_tiled['qmm_launches']} (predicted "
                  f"{i_tiled['qmm_launches_predicted']}), {sum(tiled_ok)} of {tall} rows "
                  "bitwise against their single solve", flush=True)
            entry["exit_tol"] = {"tol": EXIT_TOL, **i_frozen, "rel_error_rows": rel_f,
                                 "rows_alone": alone,
                                 f"batch={tall}": {**i_tiled, "rows_bitwise": tiled_ok}}
            if not all(a["bitwise"] for a in alone):
                raise AssertionError(f"solver {tag} exit_tol: a row differs from its single "
                                     "solve")
            if not all(tiled_ok):
                raise AssertionError(f"solver batch={tall} exit_tol: rows "
                                     f"{[b for b, ok in enumerate(tiled_ok) if not ok]} differ "
                                     "from their single solve")
        else:
            sync = {}
            for label, extra in (("one_shot", {}), ("early_exit", dict(early_exit=True))):
                syncs, launches = syncs_and_launches(torch, lambda: solve(**extra))
                iters = entry[label]["iterations"]
                sync[label] = {"host_syncs": syncs, "device_launches": launches,
                               "iterations": iters}
            print(f"[chip_smoke]   solver single, host syncs and device launches: one-shot "
                  f"{sync['one_shot']['host_syncs']} syncs, "
                  f"{sync['one_shot']['device_launches']} launches over "
                  f"{sync['one_shot']['iterations']} iterations | early_exit "
                  f"{sync['early_exit']['host_syncs']} syncs, "
                  f"{sync['early_exit']['device_launches']} launches over "
                  f"{sync['early_exit']['iterations']} iterations", flush=True)
            entry["syncs_and_launches"] = sync
        out[f"lofar {tag}"] = entry
    return out


def profile_solve(torch, fn):
    """(wall ms, device busy ms, device launches) of one call of fn under
    torch.profiler; busy and launches None when it sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in evs) / 1e3
    launches = sum(e.count for e in evs)
    return wall, (busy if launches else None), (launches or None)


def mri_truth_in_basis(prob, truth):
    """The truth in the solver's basis: W·image for a wavelet basis."""
    return prob.synthesis.rmv(truth) if prob.synthesis is not None else truth


def mri_psnr_rows(torch, mods, prob, x, truth, r):
    img = prob.to_image(x if x.ndim == 2 else x[None])
    truth = truth if truth.ndim == 2 else truth[None]
    return [float(mods["psnr"](img[b].reshape(r, r), truth[b].reshape(r, r)))
            for b in range(img.shape[0])]


def mri_trajectory(torch, mods, op, Y, cfg, kw):
    """The support and ‖ŷ − Φ̂x‖ after each iteration of an MRI solve
    (n_iters, B, N) and (n_iters, B), on the host, through the solver's own
    set-up and iteration."""
    X, iteration = mods["solver_setup"](
        op, Y, cfg.n_sparse, None, kw.get("bits_y"), kw.get("key"), "pair", "dense", "topk",
        0.01, 2.0, 30, True, kw["nonneg"], True)
    supports, resid = [], []
    for i in range(cfg.n_iters):
        X, row = iteration(X, i)
        supports.append((X != 0).cpu())
        resid.append(row[0].cpu())
    return torch.stack(supports), torch.stack(resid)


def hold_mri_rows(torch, mods, tag, cfg, card, cpu, x_card, x_cpu, truth_basis):
    """Per row b: ‖Δx_b‖ ≤ 1e-3‖x_b‖ between the card and the CPU solve of
    the same inputs, or a knife-edge split: the first iteration whose top-s
    support differs (the discrete decision of the approximately sparse
    wavelet signal, which the trace's flags do not show) comes after
    trajectories that agreed to ≤ 1e-4 in ‖ŷ − Φ̂x‖, and the rows then end
    within 0.01 in rel_error. ``card``/``cpu`` are (op, Y, kw) of each run."""
    truth_basis = truth_basis if truth_basis.ndim == 2 else truth_basis[None]
    rows = row_dx(torch, x_card, x_cpu)
    rel_k = row_dx(torch, x_card, truth_basis)
    rel_w = row_dx(torch, x_cpu, truth_basis)
    far = [b for b, dx in enumerate(rows) if dx > 1e-3]
    splits = {}
    if far:
        sup_k, rq_k = mri_trajectory(torch, mods, *card[:2], cfg, card[2])
        sup_w, rq_w = mri_trajectory(torch, mods, *cpu[:2], cfg, cpu[2])
        for b in far:
            differs = torch.nonzero((sup_k[:, b] != sup_w[:, b]).any(dim=-1)).flatten()
            rq = ((rq_k[:, b] - rq_w[:, b]).abs() / rq_w[:, b].abs().clamp_min(1e-30))
            t = int(differs[0]) if differs.numel() else None
            before = float(rq[:t].max()) if t else 0.0
            d_rel = abs(rel_k[b] - rel_w[b])
            print(f"[chip_smoke]     {tag} row {b}: ‖Δx_b‖/‖x_b‖={rows[b]:.2e}; supports first "
                  f"differ after iteration {t} ({int((sup_k[-1, b] != sup_w[-1, b]).sum())} of "
                  f"{cfg.n_sparse} entries at the end), ‖ŷ − Φ̂x‖ agreeing to {before:.1e} "
                  f"before; rel_error card {rel_k[b]:.4f} CPU {rel_w[b]:.4f}", flush=True)
            splits[b] = {"dx_rel": rows[b], "support_split_iteration": t,
                         "agree_before": before, "rel_error": [rel_k[b], rel_w[b]]}
            if t is None or before > 1e-4:
                raise AssertionError(f"{tag} row {b}: ‖Δx_b‖/‖x_b‖ = {rows[b]} > 1e-3 without "
                                     "a split at a top-s pick")
            if d_rel > 0.01:
                raise AssertionError(f"{tag} row {b}: rel_error differs from the CPU run's by "
                                     f"{d_rel} > 0.01 after the split")
    return {"dx_rows": rows, "rel_error_rows": rel_k, "cpu_rel_error_rows": rel_w,
            "splits": splits}


def hold_mri_observations(torch, mods, tag, cfg, batch, dev, gran, prob_c, y, y_c, kw):
    """The observations the card builds itself against the CPU's: raw y per
    row within 1e-5 relative (FFT rounding), and ŷ, the stochastic rounding
    of y (the instance's for per_band, the solver's own draw for per_tensor),
    at most one step apart, at no more than 1e-3 of the positions: where the
    two y fall on either side of a rounding point."""
    raw_k = mods["mri_instance"](cfg, 0, batch, dev, None, gran)[1]
    raw_c = mods["mri_instance"](cfg, 0, batch, "cpu", None, gran)[1]
    raw_k, raw_c = (raw_k, raw_c) if batch else (raw_k[None], raw_c[None])
    if gran == "per_band":
        q_k, q_c = (y, y_c) if batch else (y[None], y_c[None])
        n_bands = cfg.n_bands
        bands = mods["kspace_radial_bands"](prob_c.op, n_bands=n_bands).to(torch.int64)
    else:
        ky = mods["prng"].split(kw["key"])[0]
        q_k = mods["niht"]._quantize_rows(raw_k, cfg.bits_y, ky)
        q_c = mods["niht"]._quantize_rows(raw_c, cfg.bits_y, ky)
        n_bands, bands = 1, torch.zeros(raw_c.shape[-1], dtype=torch.int64)
    scales = mods["kspace_band_scales"](raw_c, bands, n_bands)
    step = scales[:, bands] / mods["BY_BITS"][cfg.bits_y].half_steps
    q_k = q_k.cpu()
    steps = torch.maximum((q_k.real - q_c.real).abs(), (q_k.imag - q_c.imag).abs()) / step
    dy = row_dx(torch, raw_k.cpu(), raw_c)
    flips, worst = int((steps > 0.5).sum()), float(steps.max())
    print(f"[chip_smoke]     {tag}: the card's own observations against the CPU's: y per row "
          f"‖Δy‖/‖y‖ ≤ {max(dy):.1e} | ŷ differs at {flips} of {steps.numel()} positions "
          f"(real or imaginary part), by at most {worst:.4f} steps", flush=True)
    if max(dy) > 1e-5:
        raise AssertionError(f"{tag}: the card's y differs from the CPU's by {max(dy)} > 1e-5")
    if worst > 1.0 + 1e-3 or flips > 1e-3 * steps.numel():
        raise AssertionError(f"{tag}: the card's ŷ differs from the CPU's at {flips} positions, "
                             f"by up to {worst} steps")
    return {"y_dx_rows": dy, "yhat_flips": flips, "yhat_positions": steps.numel(),
            "yhat_max_steps": worst}


def phase_mri(torch, mods):
    """The MRI path at 256×256 (``mri``: Φ = P_Ω F, s = 2,000; ``mri-wavelet``:
    Φ = P_Ω F W†, s = 8,000, per-band ŷ), single and batch 8: through
    recover_mri, PSNR, rel_error, the wall (median of 5), device launches per
    iteration and the device's busy time, the single solve's PSNR within
    0.1 dB of the JAX reference's; the card's own y and ŷ against the CPU's;
    then the same inputs (the CPU's instance: the same mask, y and ŷ) solved
    on the card and by the port on the CPU,
    held per row (‖Δx_b‖ ≤ 1e-3‖x_b‖ or a knife-edge split, PSNR within
    0.1 dB). Then threshold="hsthresh" on the card instance, bit for bit
    against hsthresh_ref standing in, one fused launch per proposal; and the
    fused H_s timed at s = 2,000 and 8,000."""
    HS, ref = mods["HSTHRESH"], mods["hsthresh_ref_mod"]
    dev = torch.device(mods["device"])
    out = {"hs_launches": {}}
    for name in MRI_CONFIGS:
        cfg = mods["CONFIGS"][name]
        gran, r = cfg.scale_granularity, cfg.resolution
        for batch in (0, 8):
            tag = f"{name} batch={batch}" if batch else f"{name} single"
            reset_counts(mods)
            walls = []
            for _ in range(5):
                m, res, truth = mods["recover_mri"](cfg, cfg.bits_y, 0, batch, dev, gran)
                walls.append(m["wall_s"])
            launched = {k.entry: k.launches for k in mods["KERNELS"] if k.launches}
            prob, y, _, kw = mods["mri_instance"](cfg, 0, batch, dev, cfg.bits_y, gran)
            ps = mri_psnr_rows(torch, mods, prob, res.x, truth, r)
            solve = mods["qniht_batch"] if batch else mods["qniht"]
            wall_ms, busy_ms, launches = profile_solve(
                torch, lambda: solve(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw))

            # the same inputs on both devices: the CPU's instance, moved
            prob_c, y_c, truth_c, kw_c = mods["mri_instance"](cfg, 0, batch, "cpu", cfg.bits_y,
                                                              gran)
            observed = hold_mri_observations(torch, mods, tag, cfg, batch, dev, gran, prob_c, y,
                                             y_c, kw)
            t0 = time.perf_counter()
            res_c = solve(prob_c.op, y_c, cfg.n_sparse, cfg.n_iters, **kw_c)
            cpu_s = time.perf_counter() - t0
            res_k = solve(prob.op, y_c.to(dev), cfg.n_sparse, cfg.n_iters, **kw)
            x_k, x_c = as_batch(res_k).x, as_batch(res_c).x.to(dev)
            Y_c = y_c if batch else y_c[None]
            held = hold_mri_rows(torch, mods, tag, cfg, (prob.op, Y_c.to(dev), kw),
                                 (prob_c.op, Y_c, kw_c), x_k, x_c,
                                 mri_truth_in_basis(prob, truth_c.to(dev)))
            ps_k = mri_psnr_rows(torch, mods, prob, x_k, truth_c.to(dev), r)
            ps_c = mri_psnr_rows(torch, mods, prob, x_c, truth_c.to(dev), r)
            d_ps = max(abs(a - b) for a, b in zip(ps_k, ps_c))
            wall = sorted(walls)[2]
            print(f"[chip_smoke]   {tag}: psnr {' '.join(f'{v:.4f}' for v in ps)} rel_error "
                  f"{m.get('rel_error', m.get('rel_error_mean')):.4f} | wall median of 5 "
                  f"{wall:.3f} s | profiled solve {wall_ms:.1f} ms, device busy {busy_ms} ms, "
                  f"{launches} device launches ({(launches or 0) / cfg.n_iters:.1f} per "
                  f"iteration) | kernels launched {launched or 'none'} | the CPU's inputs on "
                  f"both: psnr card {' '.join(f'{v:.4f}' for v in ps_k)} CPU "
                  f"{' '.join(f'{v:.4f}' for v in ps_c)} (max |Δ| {d_ps:.2e} dB; CPU solve "
                  f"{cpu_s:.2f} s), ‖Δx_b‖/‖x_b‖ "
                  + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
            if d_ps > 0.1:
                raise AssertionError(f"{tag}: PSNR differs from the CPU run's by {d_ps} dB")
            entry = {"metrics": m, "psnr_rows": ps, "walls_s": walls, "wall_median_s": wall,
                     "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_launches": launches,
                     "launches_per_iteration": (launches or 0) / cfg.n_iters,
                     "kernels_launched": launched, "cpu_solve_s": cpu_s,
                     "same_inputs_psnr_rows": ps_k, "cpu_psnr_rows": ps_c,
                     "observations": observed, **held}
            if not batch:
                want = MRI_REFERENCE_PSNR[name]
                print(f"[chip_smoke]     {name} single: psnr {ps[0]:.4f} against the JAX "
                      f"reference's {want:.4f} (|Δ| {abs(ps[0] - want):.2e} dB)", flush=True)
                entry["reference_psnr"] = want
                if abs(ps[0] - want) > 0.1:
                    raise AssertionError(f"{tag}: PSNR {ps[0]} is more than 0.1 dB from the "
                                         f"JAX reference's {want}")
            out[tag] = entry

            # the streaming H_s on the card instance, held bit for bit
            reset_counts(mods)
            res_h = solve(prob.op, y, cfg.n_sparse, cfg.n_iters, threshold="hsthresh", **kw)
            torch.cuda.synchronize()
            hs_launches = HS.launches
            others = {k.entry: k.launches for k in mods["KERNELS"] if k is not HS and k.launches}
            want_hs = cfg.n_iters + backtrack_steps(res_h)
            with stand_in(mods["hs_ops"], hsthresh_cuda=ref.hsthresh_ref):
                reset_counts(mods)
                res_w = solve(prob.op, y, cfg.n_sparse, cfg.n_iters, threshold="hsthresh", **kw)
                if HS.launches:
                    raise AssertionError("the witness run launched the fused H_s")
            same = same_bits(torch, res_h, res_w)
            ps_h = mri_psnr_rows(torch, mods, prob, res_h.x, truth, r)
            print(f"[chip_smoke]   {tag} hsthresh (s={cfg.n_sparse}): psnr "
                  f"{' '.join(f'{v:.4f}' for v in ps_h)} | fused H_s {hs_launches} launches "
                  f"(predicted {want_hs}) | witness (hsthresh_ref on the card) "
                  f"{'bitwise identical' if same else 'DIFFERS'}", flush=True)
            out[f"{tag} hsthresh"] = {"psnr_rows": ps_h, "hs_launches": hs_launches,
                                      "hs_launches_predicted": want_hs, "witness_bitwise": same}
            out["hs_launches"][name] = out["hs_launches"].get(name, 0) + hs_launches
            if hs_launches != want_hs or others:
                raise AssertionError(f"{tag} hsthresh: the fused H_s launched {hs_launches} "
                                     f"times (predicted {want_hs}), others {others}")
            if not same:
                raise AssertionError(f"{tag} hsthresh: kernel and plain-version solves differ")
    out["hs_rows"] = mri_hs_rows(torch, mods)
    return out


def mri_hs_rows(torch, mods):
    """The fused H_s at the MRI sizes (N = 65,536, s = 2,000 and 8,000, B = 1
    and 8) against hsthresh_ref, bit for bit, timed beside its bytes bound."""
    dev = torch.device("cuda")
    ref = mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name in MRI_CONFIGS:
        s = mods["CONFIGS"][name].n_sparse
        for b in (1, 8):
            n = mods["CONFIGS"][name].resolution ** 2
            x = torch.randn(b, n, generator=gen, device=dev)
            y = mods["hsthresh_cuda"](x, s, NBINS)
            if not torch.equal(y, ref.hsthresh_ref(x, s, NBINS)):
                raise AssertionError(f"fused H_s ({b}, {n}) s={s}: differs from hsthresh_ref")
            row = {"config": name, "B": b, "N": n, "s": s, "max_abs_err": 0.0,
                   "ms": time_ms(torch, lambda: mods["hsthresh_cuda"](x, s, NBINS), 50, flush),
                   "plain_ms": time_ms(torch, lambda: ref.hsthresh_ref(x, s, NBINS), 20, flush),
                   "library_ms": None,
                   "bound_ms": 8 * b * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "device_ms": device_ms(torch, lambda: mods["hsthresh_cuda"](x, s, NBINS), 50,
                                          flush, "hsthresh_kernel")}
            rows.append(row)
            print(f"[chip_smoke]   fused H_s B={b} N={n} s={s}: bitwise equal; kernel "
                  f"{row['ms']:.4f} ms (device {row['device_ms']}) | plain {row['plain_ms']:.4f} "
                  f"ms | bound {row['bound_ms']:.5f} ms (bytes)", flush=True)
    del flush
    return rows


def final_leaves(directory):
    """{leaf path: array} of the newest complete checkpoint in directory."""
    import numpy as np

    steps = sorted(int(d.name.split("_")[1]) for d in Path(directory).glob("step_*")
                   if not d.name.endswith(".tmp"))
    final = Path(directory) / f"step_{steps[-1]:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    return steps[-1], {e["path"]: np.load(final / e["file"]) for e in manifest["leaves"]}


def phase_resume(torch, mods):
    """recover --checkpoint-dir in a subprocess, SIGTERM after its second
    checkpoint, then --resume: the final checkpoint (x, the trace, the whole
    SolverState) bit for bit equal to the uninterrupted checkpointed run's,
    for the LOFAR packed batch and for mri-wavelet."""
    import signal
    import tempfile

    import numpy as np

    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    out = {}
    for name, argv in RESUME_RUNS:
        argv = [*argv, "--ckpt-every", str(RESUME_EVERY)]
        cmd = [sys.executable, "-m", "repro_torch.launch.recover", *argv]
        n_iters = mods["CONFIGS"][argv[1]].n_iters
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=mods["out_dir"]) as tmp:
            whole, killed = Path(tmp) / "whole", Path(tmp) / "killed"
            reset_counts(mods)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(__import__("io").StringIO()) as buf:
                mods["recover_main"]([*argv, "--checkpoint-dir", str(whole)])
            whole_line = buf.getvalue().strip().splitlines()[-1]
            whole_s = time.perf_counter() - t0
            qmm = mods["QMM"].launches
            lines = []
            with open(Path(tmp) / "stderr.txt", "w") as err:
                proc = subprocess.Popen([*cmd, "--checkpoint-dir", str(killed)],
                                        stdout=subprocess.PIPE, stderr=err, text=True,
                                        env=env, cwd=ROOT)
                try:
                    for line in proc.stdout:
                        lines.append(line.rstrip())
                        if f"k={2 * RESUME_EVERY}/" in line:
                            proc.send_signal(signal.SIGTERM)
                    code = proc.wait(timeout=600)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            stopped = next((ln for ln in lines if "preempted at iteration" in ln), None)
            if code != 0 or stopped is None:
                raise AssertionError(f"resume {name}: the killed run exited {code} without a "
                                     f"preemption checkpoint: {lines[-3:]} "
                                     f"{(Path(tmp) / 'stderr.txt').read_text()[-2000:]}")
            step_killed, _ = final_leaves(killed)
            done = subprocess.run([*cmd, "--checkpoint-dir", str(killed), "--resume"],
                                  capture_output=True, text=True, env=env, cwd=ROOT,
                                  timeout=600)
            if done.returncode != 0 or "resumed from step" not in done.stdout:
                raise AssertionError(f"resume {name}: --resume exited {done.returncode}: "
                                     f"{done.stdout[-1000:]} {done.stderr[-2000:]}")
            step_a, a = final_leaves(whole)
            step_b, b = final_leaves(killed)
            differ = [p for p in a if not np.array_equal(a[p], b[p], equal_nan=True)]
            resumed_line = done.stdout.strip().splitlines()[-1]
            print(f"[chip_smoke]   resume {name}: SIGTERM after the checkpoint at k="
                  f"{2 * RESUME_EVERY}, stopped with a checkpoint at k={step_killed} "
                  f"(\"{stopped}\"), resumed to k={step_b}; final state against the "
                  f"uninterrupted run (k={step_a}, {whole_s:.1f} s in-process, qmm {qmm}): "
                  f"{'bitwise identical' if not differ else f'DIFFERS in {differ}'}", flush=True)
            print(f"[chip_smoke]     uninterrupted {whole_line}", flush=True)
            print(f"[chip_smoke]     resumed       {resumed_line}", flush=True)
            out[name] = {"killed_at": step_killed, "final_step": step_b, "differ": differ,
                         "uninterrupted": whole_line, "resumed": resumed_line,
                         "uninterrupted_qmm_launches": qmm}
            if step_a != n_iters or step_b != n_iters or not 2 * RESUME_EVERY <= step_killed \
                    < n_iters:
                raise AssertionError(f"resume {name}: checkpoints at k={step_a}/{step_b}, "
                                     f"killed at {step_killed}")
            if differ:
                raise AssertionError(f"resume {name}: the resumed state differs in {differ}")
            if whole_line.split(" wall_s=")[0] != resumed_line.split(" wall_s=")[0]:
                raise AssertionError(f"resume {name}: the [recover] lines differ")
    return out


@contextlib.contextmanager
def record_solves(mods):
    """A witness on the solver's step for every solve or segment the serving
    path runs (it changes no arithmetic): the qmm launch count when the solve
    starts, its rows, whether it applies Φ̂ in row blocks (the freeze rule),
    and each iteration's backtracking rounds (the largest n_bt of the rows:
    the round loop runs while any row is active)."""
    niht, QMM = mods["niht"], mods["QMM"]
    real_setup = niht._solver_setup
    calls = []

    def setup(*args, **kw):
        x0, iteration = real_setup(*args, **kw)
        call = {"start": QMM.launches, "rows": int(args[1].shape[0]),
                "row_local": bool(kw.get("row_local", False)), "rounds": []}
        calls.append(call)

        def step(X, i):
            X_new, outs = iteration(X, i)
            call["rounds"].append(outs[4].max())
            return X_new, outs
        return x0, step

    with stand_in(niht, _solver_setup=setup):
        yield calls


@contextlib.contextmanager
def record_instances(module, name, submits=False):
    """``module.name`` (a class) replaced by a subclass that records each
    instance, and with ``submits`` each ``submit``'s (Y, key, result): a
    witness of what the entry point built (no arithmetic changes)."""
    real = getattr(module, name)
    made = []

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.user_phi, self.recorded = a[0], []
            made.append(self)

        if submits:
            def submit(self, Y, key=None, row_mask=None):
                res = super().submit(Y, key, row_mask)
                self.recorded.append((Y, key, res))
                return res

    with stand_in(module, **{name: Recorded}):
        yield made


def qmm_per_step(op):
    """qmm launches of one NIHT iteration and of one backtracking round on a
    packed operator, worked out from ``core/niht.py`` and
    ``kernels/qmm/ops.py`` with ``with_trace=False``: one qmm per real part
    of Φ̂ for Φ̂x of a real x (the residual and the acceptance test: 1 real,
    2 complex), four for Φ̂†r or Φ̂g of a complex r or g when Φ̂ is complex
    (the gradient and the step size; 1 real); a backtracking round repeats
    the acceptance test."""
    parts = 2 if op.packed.is_complex else 1
    return parts + parts * parts + parts * parts + parts, parts


def hold_launches(torch, label, calls, end, per_iter, per_bt, block_rows):
    """Each recorded solve launched qmm blocks·Σ(per_iter + per_bt·rounds)
    times, blocks = ⌈rows/block_rows⌉ under the freeze rule's row blocks, 1
    otherwise. Returns (launches, predicted, iterations) summed."""
    total = want_total = iters = 0
    for i, call in enumerate(calls):
        got = (calls[i + 1]["start"] if i + 1 < len(calls) else end) - call["start"]
        blocks = -(-call["rows"] // block_rows) if call["row_local"] else 1
        rounds = [int(r) for r in call["rounds"]]
        want = blocks * sum(per_iter + per_bt * r for r in rounds)
        if got != want:
            raise AssertionError(f"{label}: solve {i} ({call['rows']} rows, {len(rounds)} "
                                 f"iterations) launched qmm {got} times, predicted {want}")
        total, want_total, iters = total + got, want_total + want, iters + len(rounds)
    return total, want_total, iters


def serve_qmm_rows(torch, mods, op, flush):
    """qmm at the serving shapes: the 4-bit Φ̂ of the serve configs, both
    orientations, M = 8 (the slot table) and 16 (a row block of the freeze
    rule), held to phase 2's tolerance and timed as there."""
    QMM, qmm_ref = mods["QMM"], mods["qmm_ref"]
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []
    for name, w in (("serve_fwd", op.packed.fwd_re), ("serve_adj", op.packed.adj_re)):
        k, (n, kp), bits = w.k_dim, w.packed.shape, w.bits
        wdeq = mods["unpack_codes"](w.packed, bits, k).to(torch.float32) * (
            w.scale.reshape(-1, 1) / (2 ** (bits - 1) // 2))
        for m in (8, 16):
            x = torch.randn(m, k, generator=gen, device="cuda")
            y = QMM(x, w.packed, w.scale, bits, k)
            ref = qmm_ref(x, w.packed, w.scale, bits, k)
            err = (y - ref).abs()
            tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
            if not bool((err <= tol).all()):
                raise AssertionError(f"qmm {name} M={m}: max |Δ| {float(err.max())} exceeds "
                                     "the tolerance")
            b_ms, b_by, bb_ms = bound_ms(m, n, k, kp)
            rows.append({
                "shape": name, "bits": bits, "M": m, "N": n, "K": k,
                "max_abs_err": float(err.max()),
                "ms": time_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k), 20, flush),
                "plain_ms": time_ms(torch, lambda: qmm_ref(x, w.packed, w.scale, bits, k), 5,
                                    flush),
                "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms})
            r = rows[-1]
            print(f"[chip_smoke]   qmm {name} bits={bits} M={m:2d}: max|Δ|="
                  f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
                  f"  matmul(f32 Φ̂) {r['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    return rows


def profiled_segment(torch, mods, sch, ys):
    """One full segment of ``sch``'s slot table (``ys`` spliced into every
    slot) under torch.profiler: its wall, device launches and device busy
    share (kernel time over the wall); and, on the host clock, the share of
    it that re-derives ŷ from (Y, key), which every segment does first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = mods["parallel"].refill_rows(sch._state, list(range(sch.slots)),
                                         torch.stack(ys[:sch.slots]), [True] * sch.slots)

    def segment():
        return mods["parallel"].segment_step(sch.phi, state, sch.seg_len, **sch._statics)

    segment()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        segment()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    ky = mods["prng"].split(sch.key)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mods["niht"]._quantize_rows(state.Y, sch._statics["bits_y"], ky)
    torch.cuda.synchronize()
    return {"wall_ms": wall * 1e3, "device_launches": sum(e.count for e in events),
            "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / wall,
            "yhat_redraw_ms": (time.perf_counter() - t0) / 5 * 1e3}


def knife_edge_witness(torch, mods, sch, y, n_iters):
    """Positive evidence that float32 rounding alone parts a request's
    answer from the reference's, or its absence. The request is solved on
    the card as ``reference_solve`` solves it (row 0 of the slot table), one
    iteration at a time. From each of the card's states the port's CPU takes
    the same step, and the step is also computed exactly: float64 on Φ̂'s
    codes times their scale, Φ̂ packed on the CPU from the scheduler's key.

    Every product by Φ̂ may be off its exact value by ``SERVE_PRODUCT_TOL``·
    (|Φ̂v| + |Φ̂||v|), every elementwise float32 operation by its unit
    roundoff. Propagated through the residual, the gradient g, the step size
    μ (on the side's own Γ, after each backtracking round; a Rayleigh
    quotient of Φ̂_Γ, so never outside [1/λ_max, 1/λ_min] of Φ̂_ΓᵀΦ̂_Γ) and
    x + μg, that bounds each entry of each proposal (the input of H_s). At
    every iteration up to the witness each of the card's proposals must lie
    within its bound of the exact one: a fault of the card's path (a wrong
    code, scale, tile or order of rows) breaks the bound whatever the other
    paths compute.

    The witness is the first iteration at which the CPU, from the card's own
    state, keeps another support, and in it the first backtracking round at
    which the two sides' proposals keep other supports. There the CPU's
    proposals must lie within their bounds too, and the exact magnitudes of
    the contested entries (the card's weakest pick that the CPU drops, the
    CPU's strongest pick that the card drops) must lie no further apart than
    the bounds let float32 move them. At the first iteration (x = 0) that is
    a tie of the integer sums Cᵀq. With no such round (the sides part at the
    acceptance test), no such iteration, or a bound broken, there is no
    knife edge."""
    niht, prng = mods["niht"], mods["prng"]
    st, T, u = sch._statics, SERVE_PRODUCT_TOL, 2.0 ** -24
    if st["exit_tol"] or sch._ref_statics["backend"] != "packed":
        raise ValueError("the witness follows the lossless exit on a packed Φ̂")
    seen = {"proposals": [], "gamma": None}
    real_make_hs, real_top_s = niht._make_hs, niht.top_s_mask

    def make_hs(threshold, s):
        inner = real_make_hs(threshold, s)

        def hs(v):
            seen["proposals"].append(v[0].detach().to("cpu", torch.float64))
            return inner(v)
        return hs

    def top_s_mask(v, s):
        mask = real_top_s(v, s)
        seen["gamma"] = mask[0].cpu()   # Γ of the first iteration
        return mask

    def setup(phi, Y, kw):
        return niht._solver_setup(
            phi, Y, sch.s, kw["bits_phi"], kw["bits_y"], sch.key, kw["requantize"],
            kw["backend"], kw["threshold"], kw["c"], kw["shrink_k"], kw["max_backtracks"],
            kw["real_signal"], kw["nonneg"], False, kw["scale_granularity"], kw["group_size"])

    ref = sch._ref_statics
    w = mods["PackedStreamingOperator"].pack(
        sch._ref_phi.cpu(), ref["bits_phi"], prng.fold_in(prng.split(sch.key)[1], 0),
        granularity=ref["scale_granularity"]).packed.fwd_re
    W = mods["unpack_codes"](w.packed, w.bits, w.k_dim).to(torch.float64) * (
        w.scale.to(torch.float64).reshape(-1, 1) / mods["BY_BITS"][w.bits].half_steps)
    Wa = W.abs()
    M = W.shape[0]
    Y = torch.zeros((sch.slots, sch._m), dtype=sch._y_dtype, device=sch.device)
    Y[0] = torch.as_tensor(y).to(sch.device)
    yhat = niht._quantize_rows(Y[:1], st["bits_y"], prng.split(sch.key)[0])[0]
    yhat = yhat.to("cpu", torch.float64)
    shrink = st["shrink_k"] * (1.0 - st["c"])

    def exact_proposal(x, g, e_g, on, n_bt):
        """x + μg in float64 on support Γ = ``on`` after ``n_bt`` rounds, the
        bound of a float32 computation of it, μ and μ's relative bound."""
        gg, eg = torch.where(on, g, 0.0), torch.where(on, e_g, 0.0)
        num = float(gg @ gg)
        if num == 0.0:
            mu, rel = 0.0, 0.0
        else:
            e_num = float(2 * gg.abs() @ eg + eg @ eg) + (sch.s + 1) * u * num
            v = W @ gg
            e_v = T * (v.abs() + Wa @ gg.abs()) + Wa @ eg
            den = float(v @ v)
            e_den = float(2 * v.abs() @ e_v + e_v @ e_v) + (M + 1) * u * den
            mu0 = num / den
            lam = torch.linalg.eigvalsh(W[:, on].T @ W[:, on])
            spread = max(mu0 - 1 / float(lam[-1]), 1 / float(lam[0]) - mu0) / mu0
            first = e_num / num + e_den / (den - e_den) if den > e_den else float("inf")
            mu = mu0 / shrink ** n_bt
            rel = min(first, (1 + 4 * T) * spread) + (3 + 2 * n_bt) * u
        exact = niht._project(x + mu * g, st["real_signal"], st["nonneg"])
        bound = (mu * e_g + rel * mu * g.abs() + 2 * u * (x.abs() + mu * g.abs())).clamp_min(
            1e-300)
        return exact, bound, mu, rel

    worst, out = 0.0, {}
    with stand_in(niht, _make_hs=make_hs, top_s_mask=top_s_mask):
        X, step_card = setup(sch.phi, Y, st)
        _, step_cpu = setup(sch._ref_phi.cpu(), Y.cpu(), ref)
        for t in range(n_iters):
            x = X[0].to("cpu", torch.float64)
            Wx = W @ x
            r = yhat - Wx
            g = W.T @ r
            e_r = T * (Wx.abs() + Wa @ x.abs()) + u * (yhat.abs() + Wx.abs())
            e_g = T * (g.abs() + Wa.T @ r.abs()) + Wa.T @ e_r
            sides = {}
            for name, step, state in (("card", step_card, X), ("cpu", step_cpu, X.cpu())):
                seen["proposals"].clear()
                X_new, (*_, n_bt) = step(state, t)
                nb = int(n_bt[0])
                on = seen["gamma"] if bool((x == 0).all()) else x != 0
                rounds = [exact_proposal(x, g, e_g, on, k) for k in range(nb + 1)]
                props = seen["proposals"][:nb + 1]
                sides[name] = dict(
                    X=X_new, n_bt=nb, rounds=rounds, proposals=props,
                    support=(X_new[0] != 0).cpu(),
                    ratio=max(float(((p - e).abs() / bd).max())
                              for p, (e, bd, *_) in zip(props, rounds)))
            card, cpu = sides["card"], sides["cpu"]
            worst = max(worst, card["ratio"])
            out = {"iteration": t, "card_bound_ratio": worst, "cpu_bound_ratio": cpu["ratio"],
                   "backtracks": (card["n_bt"], cpu["n_bt"])}
            if card["ratio"] > 1.0:
                return dict(out, knife_edge=False,
                            reason="the card's step leaves the bound of exact arithmetic")
            if not torch.equal(card["support"], cpu["support"]):
                break
            X = card["X"]
        else:
            return dict(out, knife_edge=False,
                        reason="from the card's states the CPU keeps the card's support")
    keeps = {name: [real_top_s(p[None], sch.s)[0] for p in sd["proposals"]]
             for name, sd in sides.items()}
    k = next((k for k in range(min(card["n_bt"], cpu["n_bt"]) + 1)
              if not torch.equal(keeps["card"][k], keeps["cpu"][k])), None)
    if k is None:
        return dict(out, knife_edge=False,
                    reason="the sides part at the acceptance test, where no witness is taken")
    picked = (keeps["card"][k] & ~keeps["cpu"][k]).nonzero().flatten()
    kept = (keeps["cpu"][k] & ~keeps["card"][k]).nonzero().flatten()
    (exact, _, mu_card, mu_rel), (_, _, mu_cpu, _) = card["rounds"][k], cpu["rounds"][k]
    mag = exact.abs()
    i, j = int(picked[mag[picked].argmin()]), int(kept[mag[kept].argmax()])
    gap = float((mag[i] - mag[j]).abs())
    allow = float(max(sd["rounds"][k][1][i] + sd["rounds"][k][1][j] for sd in (card, cpu))
                  + abs(mu_card - mu_cpu) * (g[i].abs() + g[j].abs()))
    knife = cpu["ratio"] <= 1.0 and gap <= allow
    return dict(out, knife_edge=knife, round=k, contested=(i, j), exact_gap=gap,
                allowed_gap=allow, magnitude=float(mag[i]), mu_rel_bound=mu_rel,
                reason=("rounding cannot separate the contested entries" if knife else
                        "the supports part further from a tie than rounding reaches"))


def hold_serve_quality(torch, mods, cfg, sch, workload):
    """Each request's rel_error against the JAX reference's
    (``SERVE_REFERENCE_REL_ERRORS``): within ``SERVE_REL_TOL``, or split from
    it with :func:`knife_edge_witness`'s positive evidence that rounding
    alone decides it. At most ``SERVE_MAX_SPLITS`` requests split, and the
    easy and hard means over the requests that did not split are held within
    ``SERVE_REL_TOL`` of the reference's over the same requests; the means
    over all requests are printed beside the reference's. ``workload`` is
    ``build_requests``'s (phi, arrivals, truths, hard_rids)."""
    _, arrivals, truths, hard = workload
    requests = {req.rid: req for _, req in arrivals}
    card = {rid: float(mods["relative_error"](torch.as_tensor(rep.x).cpu(), truths[rid].cpu()))
            for rid, rep in sch.reports.items()}
    ref = SERVE_REFERENCE_REL_ERRORS
    split = sorted(r for r in card if abs(card[r] - ref[r]) > SERVE_REL_TOL)
    evidence = {} if len(split) > SERVE_MAX_SPLITS else {
        rid: dict(knife_edge_witness(torch, mods, sch, requests[rid].y,
                                     requests[rid].n_iters or sch.n_iters),
                  card=card[rid], reference=ref[rid]) for rid in split}
    means = {}
    for kind, members in (("easy", [r for r in card if r not in hard]), ("hard", sorted(hard))):
        kept = [r for r in members if r not in split]
        means[kind] = {
            "card": sum(card[r] for r in members) / len(members),
            "reference": sum(ref[r] for r in members) / len(members),
            "card_unsplit": sum(card[r] for r in kept) / max(len(kept), 1),
            "reference_unsplit": sum(ref[r] for r in kept) / max(len(kept), 1)}
    agree = [abs(card[r] - ref[r]) for r in card if r not in split]
    print(f"[chip_smoke]   serve {cfg.name} rel_error against the JAX reference: "
          f"{len(agree)} of {len(card)} requests within {SERVE_REL_TOL} (largest gap "
          f"{max(agree):.2e}) | means easy {means['easy']['card']:.6f} (reference "
          f"{means['easy']['reference']:.6f}), hard {means['hard']['card']:.6f} (reference "
          f"{means['hard']['reference']:.6f}); without the split requests easy "
          f"{means['easy']['card_unsplit']:.6f} / {means['easy']['reference_unsplit']:.6f}, "
          f"hard {means['hard']['card_unsplit']:.6f} / "
          f"{means['hard']['reference_unsplit']:.6f}", flush=True)
    for rid, e in evidence.items():
        where = (f"round {e['round']}, entries {e['contested']} of magnitude "
                 f"{e['magnitude']:.4g}: exact gap {e['exact_gap']:.3g} against "
                 f"{e['allowed_gap']:.3g} allowed, μ known to {e['mu_rel_bound']:.2g}, "
                 if "exact_gap" in e else "")
        print(f"[chip_smoke]     request {rid}: rel_error {e['card']:.4f} against the "
              f"reference's {e['reference']:.4f}; iteration {e['iteration']}: {e['reason']} "
              f"({where}card |Δ|/bound ≤ {e['card_bound_ratio']:.3g}, CPU "
              f"{e['cpu_bound_ratio']:.3g}, backtracks {e['backtracks']})"
              + (" (knife edge)" if e["knife_edge"] else " (NOT a knife edge)"), flush=True)
    if len(split) > SERVE_MAX_SPLITS:
        raise AssertionError(f"serve: {len(split)} requests split from the JAX reference's "
                             f"rel_error, more than {SERVE_MAX_SPLITS}")
    bad = [rid for rid, e in evidence.items() if not e["knife_edge"]]
    if bad:
        raise AssertionError(f"serve: requests {bad} differ from the JAX reference's rel_error "
                             f"by more than {SERVE_REL_TOL} without a knife edge")
    off = {k: abs(m["card_unsplit"] - m["reference_unsplit"]) for k, m in means.items()}
    if max(off.values()) > SERVE_REL_TOL:
        raise AssertionError(f"serve: the means of the requests that did not split are off the "
                             f"reference's by {off}, more than {SERVE_REL_TOL}")
    return {"rel_error_requests": card, "split_requests": evidence, "rel_error_means": means,
            "largest_unsplit_gap": max(agree)}


def phase_serve(torch, mods):
    """The serving path on the card: the continuous-batching scheduler on
    serve-continuous-packed (continuous and lockstep, every answer bitwise
    against its reference_solve, the decision log repeated), the chunked
    BatchServer on serve-gaussian-packed (freeze rule, blocks of 16), LOFAR
    CS302 skies through the scheduler, and the CLI killed and resumed from
    its journal; qmm launches held to qmm_per_step's formula."""
    import numpy as np

    serve, cfgs, prng = mods["serve"], mods["SERVE_CONFIGS"], mods["prng"]
    QMM, dev, block = mods["QMM"], mods["device"], mods["ROW_LOCAL_ROWS"]
    out = {"qmm_launches": 0, "reference_qmm_launches": 0}

    # 1. serve-continuous-packed: continuous and lockstep
    t_part = time.perf_counter()
    cfg = cfgs[SERVE_CONTINUOUS]
    runs = {}
    for label, policy, checked in (("continuous", "continuous", True),
                                   ("lockstep", "lockstep", True),
                                   ("continuous_timed", "continuous", False),
                                   ("lockstep_timed", "lockstep", False)):
        reset_counts(mods)
        witness = record_solves(mods) if checked else contextlib.nullcontext([])
        with record_instances(mods["parallel"], "ContinuousScheduler") as made, \
                witness as calls, contextlib.redirect_stdout(io.StringIO()) as buf:
            metrics = serve.serve_scheduled(cfg, policy, verify=checked, device=dev)
        torch.cuda.synchronize()
        sch, end = made[0], QMM.launches
        entry = {"metrics": metrics, "qmm_launches": end}
        if checked:
            if f"verified {metrics['completed']} requests bitwise" not in buf.getvalue():
                raise AssertionError(f"serve {label}: no bitwise verification: {buf.getvalue()}")
            per_iter, per_bt = qmm_per_step(sch.phi)
            n_seg = sch.segments_run
            seg = hold_launches(torch, f"serve {label} segments", calls[:n_seg],
                                calls[n_seg]["start"], per_iter, per_bt, block)
            ref = hold_launches(torch, f"serve {label} reference solves", calls[n_seg:], end,
                                per_iter, per_bt, block)
            entry.update(segments=n_seg, segment_qmm=seg[0], segment_iterations=seg[2],
                         reference_solves=len(calls) - n_seg, reference_qmm=ref[0],
                         reference_iterations=ref[2], per_iteration=per_iter,
                         per_backtrack_round=per_bt)
            # the path's own launches: its segments, not the verify step's solves
            out["qmm_launches"] += seg[0]
            out["reference_qmm_launches"] += ref[0]
        elif end != runs[policy][0]["segment_qmm"]:
            raise AssertionError(f"serve {label}: {end} qmm launches with verify off, "
                                 f"{runs[policy][0]['segment_qmm']} in the checked run's "
                                 "segments")
        runs[label] = (entry, sch)
        out[f"continuous_packed {label}"] = entry
    (c, c_sch), (lk, l_sch) = runs["continuous"], runs["lockstep"]
    differ = [rid for rid, rep in c_sch.reports.items()
              if not np.array_equal(rep.x, l_sch.reports[rid].x)]
    if differ:
        raise AssertionError(f"serve: continuous and lockstep answers differ for {differ}")
    if c_sch.log != runs["continuous_timed"][1].log:
        raise AssertionError("serve: the continuous decision log changed when repeated")
    ct, lt = runs["continuous_timed"][0]["metrics"], runs["lockstep_timed"][0]["metrics"]
    speedup = ct["items_per_s"] / lt["items_per_s"]
    rel = {k: c["metrics"][f"rel_error_{k}_mean"] for k in ("easy", "hard")}
    workload = serve.build_requests(cfg, prng.PRNGKey(cfg.seed), dev)
    quality = hold_serve_quality(torch, mods, cfg, c_sch, workload)
    seg_prof = profiled_segment(torch, mods, c_sch, [req.y for _, req in workload[1]])
    print(f"[chip_smoke]   serve {SERVE_CONTINUOUS}: {c['metrics']['completed']} requests "
          f"bitwise against reference_solve under both policies, continuous = lockstep "
          f"bitwise, decision log repeated | qmm per segment: {c['segment_qmm']} launches over "
          f"{c['segments']} segments ({c['segment_iterations']} iterations; predicted "
          f"{c['per_iteration']}/iteration + {c['per_backtrack_round']}/backtracking round, "
          f"exact), reference solves {c['reference_qmm']} | continuous items/s "
          f"{ct['items_per_s']} p50 {ct['latency_p50_s']} s p99 {ct['latency_p99_s']} s "
          f"occupancy {ct['slot_occupancy']} | lockstep items/s {lt['items_per_s']} p50 "
          f"{lt['latency_p50_s']} s p99 {lt['latency_p99_s']} s occupancy "
          f"{lt['slot_occupancy']} | speedup_vs_lockstep {speedup:.3f} | one full segment "
          f"profiled: {seg_prof['wall_ms']:.1f} ms, {seg_prof['device_launches']} device "
          f"launches, device busy {seg_prof['device_busy_ms']:.2f} ms "
          f"({100 * seg_prof['device_busy_share']:.1f}%), ŷ redraw "
          f"{seg_prof['yhat_redraw_ms']:.2f} ms | {time.perf_counter() - t_part:.1f} s",
          flush=True)
    out["continuous_packed"] = {"speedup_vs_lockstep": speedup, "rel_error_metrics": rel,
                                "profiled_segment": seg_prof, **quality}

    # 2. serve-gaussian-packed: the chunked BatchServer under the freeze rule
    t_part = time.perf_counter()
    cfg = cfgs[SERVE_CHUNKED]
    reset_counts(mods)
    with record_instances(mods["parallel"], "BatchServer", submits=True) as made, \
            record_solves(mods) as calls, contextlib.redirect_stdout(io.StringIO()) as buf:
        metrics = serve.serve(cfg, device=dev)
    torch.cuda.synchronize()
    end = QMM.launches
    srv = made[0]
    per_iter, per_bt = qmm_per_step(srv.phi)
    chunk_qmm = hold_launches(torch, "serve chunks", calls, end, per_iter, per_bt, block)
    out["qmm_launches"] += end
    kw = dict(bits_y=cfg.bits_y, early_exit=True, exit_tol=cfg.exit_tol, with_trace=False)
    n_chunks = len(srv.recorded)
    whole, rows_ok = [], []
    for ci, (Y, key, res) in enumerate(srv.recorded):
        want = mods["qniht_batch"](srv.phi, Y, cfg.s, cfg.n_iters, key=key, **kw)
        whole.append(bool(torch.equal(want.x, res.x)))
        for b in SERVE_FREEZE_ROWS:
            single = mods["qniht"](srv.phi, Y[b], cfg.s, cfg.n_iters, key=key, **kw)
            rows_ok.append((ci, b, bool(torch.equal(single.x, res.x[b]))))
    # the pack-once construction: a chunk under the construction key is the
    # user-level packed solve (Φ̂ packed from that key) bit for bit
    Y0 = srv.recorded[0][0]
    user = mods["qniht_batch"](srv.user_phi, Y0, cfg.s, cfg.n_iters, key=srv.key,
                               bits_phi=cfg.bits_phi, backend="packed", requantize="fixed",
                               **kw)
    user_ok = bool(torch.equal(user.x, srv.submit(Y0, srv.key).x))
    timed = metrics
    print(f"[chip_smoke]   serve {SERVE_CHUNKED}: {n_chunks} chunks of "
          f"{cfg.chunk} rows, each bitwise the packed solve with its key: {whole}; under the "
          f"construction key bitwise the user-level backend=\"packed\" solve: {user_ok}; rows "
          f"{SERVE_FREEZE_ROWS} against their single solves: "
          f"{sum(ok for *_, ok in rows_ok)} of {len(rows_ok)} bitwise | qmm {chunk_qmm[0]} over "
          f"{chunk_qmm[2]} iterations (predicted {chunk_qmm[1]}: blocks of {block} rows) | "
          f"compile_chunk_s {timed['compile_chunk_s']} steady_chunk_s "
          f"{timed['steady_chunk_s']} items/s {timed['items_per_s']} | "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)
    out["gaussian_packed"] = {"metrics": timed,
                              "chunks_bitwise": whole, "rows_bitwise": rows_ok,
                              "user_level_bitwise": user_ok,
                              "qmm_launches": chunk_qmm[0], "qmm_predicted": chunk_qmm[1],
                              "iterations": chunk_qmm[2]}
    if not all(whole) or not user_ok or not all(ok for *_, ok in rows_ok):
        raise AssertionError(f"serve {SERVE_CHUNKED}: chunks {whole}, user-level {user_ok}, "
                             f"rows {rows_ok}")

    # 3. LOFAR CS302 skies through the scheduler (the paper's deployment)
    t_part = time.perf_counter()
    cs = mods["LOFAR"]
    phi, Y, X = mods["lofar_instance"](cs, 0, SERVE_LOFAR_SKIES, dev)
    Request = mods["Request"]
    budgets = [cs.n_iters // 2 if i % 2 else None for i in range(SERVE_LOFAR_SKIES)]
    arrivals = [(0 if i < SERVE_LOFAR_SKIES // 2 else 2, Request(rid=i, y=Y[i],
                                                                n_iters=budgets[i]))
                for i in range(SERVE_LOFAR_SKIES)]
    reset_counts(mods)
    with record_solves(mods) as calls:
        t0 = time.perf_counter()
        sch = mods["parallel"].ContinuousScheduler(
            phi, cs.n_sources, cs.n_iters, slots=SERVE_LOFAR_SLOTS, seg_len=SERVE_LOFAR_SEG_LEN,
            key=prng.PRNGKey(0), bits_phi=cs.bits_phi, bits_y=cs.bits_y, backend="packed",
            real_signal=True, nonneg=True, exit_tol=0.0)
        reports = sch.run(arrivals)
        wall = time.perf_counter() - t0
        n_seg, seg_end = sch.segments_run, QMM.launches
        refs = {i: sch.reference_solve(Y[i], budgets[i]) for i in range(SERVE_LOFAR_SKIES)}
        torch.cuda.synchronize()
    end = QMM.launches
    per_iter, per_bt = qmm_per_step(sch.phi)
    seg = hold_launches(torch, "serve lofar segments", calls[:n_seg], seg_end, per_iter, per_bt,
                        block)
    ref_calls = calls[n_seg:]
    ref_launches = [(ref_calls[i + 1]["start"] if i + 1 < len(ref_calls) else end)
                    - ref_calls[i]["start"] for i in range(len(ref_calls))]
    out["reference_qmm_launches"] += hold_launches(
        torch, "serve lofar reference solves", ref_calls, end, per_iter, per_bt, block)[0]
    out["qmm_launches"] += seg_end
    rows = []
    for i in range(SERVE_LOFAR_SKIES):
        rep = reports[i]
        rows.append({"rid": i, "budget": budgets[i] or cs.n_iters,
                     "iters_used": rep.iters_used, "start_tick": rep.start_tick,
                     "rel_error": float(mods["relative_error"](torch.from_numpy(rep.x),
                                                                X[i].cpu())),
                     "bitwise": bool(np.array_equal(rep.x, refs[i].cpu().numpy())),
                     "reference_qmm": ref_launches[i]})
    print(f"[chip_smoke]   serve lofar: {SERVE_LOFAR_SKIES} skies, {SERVE_LOFAR_SLOTS} slots, "
          f"seg_len {SERVE_LOFAR_SEG_LEN}: {sum(r['bitwise'] for r in rows)} of "
          f"{len(rows)} bitwise against reference_solve | {n_seg} segments, qmm {seg[0]} "
          f"(predicted {seg[1]}: {per_iter}/iteration + {per_bt}/backtracking round) | wall "
          f"{wall:.3f} s, {SERVE_LOFAR_SKIES / wall:.2f} skies/s, occupancy "
          f"{sch.stats()['slot_occupancy']} | {time.perf_counter() - t_part:.1f} s", flush=True)
    for r in rows:
        print(f"[chip_smoke]     sky {r['rid']:2d}: budget {r['budget']} start tick "
              f"{r['start_tick']} iters {r['iters_used']} rel_error {r['rel_error']:.4f} "
              f"reference solve qmm {r['reference_qmm']} "
              f"{'bitwise' if r['bitwise'] else 'DIFFERS'}", flush=True)
    out["lofar"] = {"rows": rows, "segments": n_seg, "qmm_launches": seg[0],
                    "qmm_predicted": seg[1], "wall_s": wall, "stats": sch.stats()}
    if not all(r["bitwise"] for r in rows):
        raise AssertionError(f"serve lofar: skies {[r['rid'] for r in rows if not r['bitwise']]}"
                             " differ from their reference_solve")
    del phi, Y, X, sch, refs
    torch.cuda.empty_cache()

    # 4. the CLI killed after its first chunk and resumed from its journal
    out["kill_resume"] = serve_kill_resume(mods)

    # qmm at the serving shapes, off the path (launches not counted)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out["qmm_rows"] = serve_qmm_rows(torch, mods, c_sch.phi, flush)
    del flush
    return out


def serve_kill_resume(mods):
    """python -m repro_torch.launch.serve --config serve-gaussian-fault-packed
    --checkpoint-dir D, SIGTERM after its first x_digest line, then --resume:
    both exit 0, at least one chunk drained, every digest the uninterrupted
    run's."""
    import re
    import signal
    import tempfile

    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    base = ["--config", SERVE_FAULT, "--device", mods["device"]]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *base]

    def digests(text):
        return re.findall(r"chunk (\d+) x_digest=([0-9a-f]+)", text)

    t0 = time.perf_counter()
    mods["out_dir"].mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=mods["out_dir"]) as tmp:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            mods["serve"].main([*base, "--checkpoint-dir", str(Path(tmp) / "whole")])
        want = digests(buf.getvalue())
        lines = []
        with open(Path(tmp) / "stderr.txt", "w") as err:
            proc = subprocess.Popen([*cmd, "--checkpoint-dir", str(Path(tmp) / "killed")],
                                    stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                                    cwd=ROOT)
            try:
                for line in proc.stdout:
                    lines.append(line)
                    if "x_digest=" in line and len(digests("".join(lines))) == 1:
                        proc.send_signal(signal.SIGTERM)
                code = proc.wait(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        killed = "".join(lines)
        done = subprocess.run([*cmd, "--checkpoint-dir", str(Path(tmp) / "killed"), "--resume"],
                              capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        stderr = (Path(tmp) / "stderr.txt").read_text()[-2000:]
    drained = re.search(r"chunks_drained=(\d+)", done.stdout)
    drained = int(drained.group(1)) if drained else None
    got = digests(done.stdout)
    print(f"[chip_smoke]   serve kill/resume {SERVE_FAULT}: SIGTERM after chunk 0, the run "
          f"exited {code} after {len(digests(killed))} chunks "
          f"({'preempted' if 'preempted after chunk' in killed else 'not preempted'}); "
          f"--resume exited {done.returncode}, chunks_drained={drained}; digests "
          f"{'identical' if got == want else 'DIFFER'} to the uninterrupted run's "
          f"({len(want)} chunks) | {time.perf_counter() - t0:.1f} s", flush=True)
    if code != 0 or done.returncode != 0:
        raise AssertionError(f"serve kill/resume: exit codes {code}, {done.returncode}: "
                             f"{stderr} {done.stderr[-2000:]}")
    n_chunks, before = mods["SERVE_CONFIGS"][SERVE_FAULT].n_chunks, len(digests(killed))
    preempted = "preempted after chunk" in killed
    # a resume took place: the killed run stopped early on the signal, the
    # resumed run drained exactly what it had journaled and solved the rest
    if not preempted or not 1 <= before < n_chunks or drained != before:
        raise AssertionError(f"serve kill/resume: preempted {preempted}, {before} of "
                             f"{n_chunks} chunks before the kill, {drained} drained")
    if got != want or len(want) != n_chunks:
        raise AssertionError(f"serve kill/resume: digests {got} against {want}")
    return {"killed_exit": code, "chunks_before_kill": before, "preempted": preempted,
            "resume_exit": done.returncode, "chunks_drained": drained,
            "digests_identical": got == want}


def sv_gate(torch, label, sv_card, sv_cpu):
    """Singular values of the card against the CPU's, relative to σ_max:
    ≤ SV_TOL (the float32 Gram method's own error on an ill-conditioned Φ
    is ~3e-5·σ_max in either package). Returns the gap."""
    sv_card = sv_card.cpu()
    gap = float((sv_card - sv_cpu).abs().max() / sv_cpu[0])
    if not gap <= SV_TOL:
        raise AssertionError(f"{label}: singular values on the card and the CPU differ by "
                             f"{gap:.2e}·σ_max > {SV_TOL}")
    return gap


def gamma_gate(label, g_card, g_cpu):
    """γ = σ_max/σ_min − 1 of the card against the CPU's, within what an error
    of SV_TOL·σ_max in each of σ_max and σ_min allows: 2·SV_TOL·(γ + 1)²."""
    tol = 2 * SV_TOL * (g_cpu + 1.0) ** 2
    if not abs(g_card - g_cpu) <= tol:
        raise AssertionError(f"{label}: γ {g_card} on the card and {g_cpu} on the CPU differ "
                             f"by more than {tol:.3g}")
    return tol


def phase_theory(torch, mods, lofar):
    """The paper's RIP machinery on the LOFAR CS302 Φ (870×65,536 complex64),
    on the card and on the port's CPU, on the same Φ: γ over the full
    spectrum (``gamma_full``), the Fig. 7 extent sweep
    (``tune_extent_for_gamma``, each extent's Φ built and freed in turn),
    the sampled RICs at s = 2·30 over 32 supports (supports bit for bit,
    α̂ and β̂ within 1e-4 relative), Lemma 1's minimum bit width for the
    per-tensor scale and the port's own per_channel and per_block (g = 64)
    scales, and Theorem 3's error terms beside the LOFAR phase's packed
    solve."""
    rip, cs, dev = mods["rip"], mods["LOFAR"], torch.device(mods["device"])
    prng = mods["prng"]
    station = mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed)
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    phi_cpu = phi.cpu()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    sv_k, sv_c = rip.singular_values(phi), rip.singular_values(phi_cpu)
    g_k, g_c = float(rip.gamma_full(phi)), float(rip.gamma_full(phi_cpu))
    out["gamma_full"] = {"card": g_k, "cpu": g_c, "sv_gap": sv_gate(torch, "gamma_full", sv_k,
                                                                     sv_c),
                         "tol": gamma_gate("gamma_full", g_k, g_c),
                         "sigma_max": float(sv_c[0]), "sigma_min": float(sv_c[-1]),
                         "card_ms": time_ms(torch, lambda: rip.gamma_full(phi), 3, flush)}
    print(f"[chip_smoke]   gamma_full (LOFAR CS302 Φ): card {g_k:.6g}, CPU {g_c:.6g} "
          f"(σ_max {float(sv_c[0]):.4f}, σ_min {float(sv_c[-1]):.4g}; singular values "
          f"within {out['gamma_full']['sv_gap']:.1e}·σ_max); "
          f"{out['gamma_full']['card_ms']:.2f} ms on the card", flush=True)
    t0 = time.perf_counter()
    sweep_k, best_k = mods["tune_extent_for_gamma"](station, cs.resolution, THEORY_EXTENTS,
                                                    device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_c, best_c = mods["tune_extent_for_gamma"](station, cs.resolution, THEORY_EXTENTS,
                                                    device="cpu")
    cpu_s = time.perf_counter() - t0
    for (d, gk), (_, gc) in zip(sweep_k, sweep_c):
        gamma_gate(f"extent {d}", gk, gc)
    if best_k != best_c:
        raise AssertionError(f"extent sweep: best extent {best_k} on the card, {best_c} on the CPU")
    out["extent_sweep"] = {"card": sweep_k, "cpu": sweep_c, "best": best_k,
                           "card_s": card_s, "cpu_s": cpu_s}
    print("[chip_smoke]   Fig. 7 sweep γ(d), card / CPU: " + ", ".join(
        f"d={d}: {gk:.4g} / {gc:.4g}" for (d, gk), (_, gc) in zip(sweep_k, sweep_c))
        + f"; best d for γ ≤ 1/16: {best_k} ({card_s:.1f} s on the card, {cpu_s:.1f} s on the "
        "CPU)", flush=True)

    s2 = 2 * cs.n_sources
    sup_k = rip.sampled_supports(phi.shape[1], s2, RIC_SAMPLES, device=dev)
    sup_c = rip.sampled_supports(phi.shape[1], s2, RIC_SAMPLES)
    if not torch.equal(sup_k.cpu(), sup_c):
        raise AssertionError("rics_sampled: the card drew other supports than the CPU")
    a_k, b_k = (float(v) for v in rip.rics_sampled(phi, s2, RIC_SAMPLES))
    a_c, b_c = (float(v) for v in rip.rics_sampled(phi_cpu, s2, RIC_SAMPLES))
    gaps = (abs(a_k - a_c) / a_c, abs(b_k - b_c) / b_c)
    if not max(gaps) <= SV_TOL:
        raise AssertionError(f"rics_sampled: α̂, β̂ differ by {gaps} relative > {SV_TOL}")
    g2s = float(rip.gamma_from_rics(a_c, b_c))
    out["rics"] = {"s": s2, "samples": RIC_SAMPLES, "alpha": [a_k, a_c], "beta": [b_k, b_c],
                   "gamma_2s": [float(rip.gamma_from_rics(a_k, b_k)), g2s],
                   "rel_gaps": gaps, "supports_bitwise": True,
                   "card_ms": time_ms(torch, lambda: rip.rics_sampled(phi, s2, RIC_SAMPLES), 3,
                                      flush)}
    print(f"[chip_smoke]   rics_sampled s={s2}, {RIC_SAMPLES} supports (bitwise card = CPU): "
          f"α̂ {a_k:.6g} / {a_c:.6g}, β̂ {b_k:.6g} / {b_c:.6g} (card / CPU), γ_2s = {g2s:.5g}; "
          f"{out['rics']['card_ms']:.1f} ms on the card", flush=True)

    key = prng.PRNGKey(0)
    kphi = prng.fold_in(prng.split(key)[1], 0)        # the solver's fixed Φ̂ key
    q = mods["quantize"](phi, cs.bits_phi, kphi)
    scales = {"per_tensor": float(q.scale)}
    for gran in ("per_channel", f"per_block:{GROUP}"):
        w = mods["pack_weights"](phi.real.contiguous(), cs.bits_phi, kphi, granularity=gran)
        scales[gran.split(":")[0]] = w.scale.reshape(-1).cpu()
    out["lemma1"] = {}
    for name, scale in scales.items():
        bits = rip.min_bits_lemma1(g2s, a_c, s2, scale=scale)
        bounds = {b: rip.gamma_hat_bound(g2s, a_c, s2, b, scale=scale) for b in (2, 8)}
        out["lemma1"][name] = {"c_phi": rip.effective_scale(scale), "min_bits": bits,
                               "gamma_hat_bound": bounds}
    print("[chip_smoke]   Lemma 1 (γ_2s, α̂_2s, |Γ| = 2s): " + "; ".join(
        f"{k}: c_Φ={v['c_phi']:.4f} min bits {v['min_bits']}, γ̂ ≤ "
        f"{v['gamma_hat_bound'][2]:.4g} at 2 bits, {v['gamma_hat_bound'][8]:.4g} at 8"
        for k, v in out["lemma1"].items()), flush=True)

    phi_hat = mods["fake_quantize"](phi, cs.bits_phi, kphi)
    _, b_hat = (float(v) for v in rip.rics_sampled(phi_hat, s2, RIC_SAMPLES))
    del phi_hat
    _, e = mods["visibilities"](phi, x_true, cs.snr_db, key)
    e_norm = float(torch.linalg.vector_norm(e))
    xs_norm = float(torch.linalg.vector_norm(x_true))
    c_y = float(torch.maximum(y.real.abs(), y.imag.abs()).max())
    eps_s = float(rip.eps_s(x_true, cs.n_sources, e_norm, b_c))
    eps_q = rip.eps_q(phi.shape[0], b_hat, xs_norm, cs.bits_phi, cs.bits_y,
                      scales["per_tensor"], c_y)
    bound = rip.theorem3_bound(cs.n_iters, xs_norm, eps_s, eps_q)
    solved = lofar["lofar single"]["packed"]["rel_error"] * xs_norm
    out["theorem3"] = {"beta_2s": b_c, "beta_2s_hat": b_hat, "e_norm": e_norm,
                       "xs_norm": xs_norm, "c_y": c_y, "eps_s": eps_s, "eps_q": eps_q,
                       "corollary1": rip.corollary1_coeffs(cs.n_antennas, b_c, b_hat),
                       "bound": bound, "packed_solve_error": solved,
                       "within_bound": solved <= bound,
                       "hypothesis_gamma_2s_le_1_16": g2s <= 1.0 / 16.0,
                       "stopping_iterations": mods["stopping_iterations"](xs_norm, eps_s)}
    print(f"[chip_smoke]   Theorem 3 (LOFAR packed {cs.bits_phi}&{cs.bits_y}): ε_s={eps_s:.4g} "
          f"ε_q={eps_q:.4g} (β_2s {b_c:.4g}, β̂_2s {b_hat:.4g}, ‖e‖ {e_norm:.4g}), "
          f"Corollary 1 coefficients {out['theorem3']['corollary1'][0]:.4g}, "
          f"{out['theorem3']['corollary1'][1]:.4g}; bound after {cs.n_iters} iterations "
          f"{bound:.4g} against the packed solve's ‖x̂ − x‖ = {solved:.4g}; n* = "
          f"{out['theorem3']['stopping_iterations']} (the theorem assumes γ̂_2s ≤ 1/16: "
          f"γ_2s = {g2s:.4g})", flush=True)
    return out


@contextlib.contextmanager
def record_picks(mods):
    """A witness on the baselines' discrete decisions (it changes no
    arithmetic): the support each H_s of ``iht``/``cosamp`` keeps and each
    pixel CLEAN picks, in call order, on the host."""
    module = mods["baselines"]
    log = []
    hard, peak = module.hard_threshold, module._peak_index

    def hard_threshold(x, s):
        out = hard(x, s)
        log.append((out != 0).cpu())
        return out

    def peak_index(resid):
        p = peak(resid)
        log.append(int(p))
        return p

    with stand_in(module, hard_threshold=hard_threshold, _peak_index=peak_index):
        yield log


def first_parting(log_card, log_cpu):
    """The first call at which the two logs of picks differ, or None."""
    for i, (a, b) in enumerate(zip(log_card, log_cpu)):
        same = a == b if isinstance(a, int) else bool((a == b).all())
        if not same:
            return i
    return None


def hold_baseline(torch, name, card, cpu, log_card, log_cpu, x_true, resid_key):
    """The card's answer against the CPU's on the same inputs: the same
    support (positions) and values within BASELINE_TOL of the largest; or,
    where a top-s or argmax pick parts, the first iteration at which it
    does, after traces that agreed to BASELINE_TOL, and rel_error within
    0.01 at the end."""
    x_k, x_c = card[0].cpu(), cpu[0]
    same = bool(torch.equal(x_k != 0, x_c != 0))
    gap = float((x_k - x_c).abs().max() / x_c.abs().max())
    t = first_parting(log_card, log_cpu)
    rel = [float(torch.linalg.vector_norm(x - x_true) / torch.linalg.vector_norm(x_true))
           for x in (x_k.real if x_k.is_complex() else x_k, x_c.real if x_c.is_complex() else x_c)]
    row = {"same_positions": same, "max_rel_gap": gap, "parted_at": t, "rel_error": rel}
    if same and gap <= BASELINE_TOL:
        return row
    if t is None:
        raise AssertionError(f"{name}: card and CPU differ ({gap:.2e}, same positions {same}) "
                             "with every pick the same")
    tr_k, tr_c = card[resid_key].cpu(), cpu[resid_key]
    before = float(((tr_k[:t] - tr_c[:t]).abs() / tr_c[:t].abs().clamp_min(1e-30)).max()) \
        if t else 0.0
    row["agree_before"] = before
    print(f"[chip_smoke]     {name}: the picks part at call {t}; traces agreed to {before:.1e} "
          f"before; rel_error card {rel[0]:.4f} CPU {rel[1]:.4f}", flush=True)
    if before > BASELINE_TOL or abs(rel[0] - rel[1]) > 0.01:
        raise AssertionError(f"{name}: a split at call {t} after traces {before} apart, "
                             f"rel_error {rel}")
    return row


def baseline_syncs(torch, mods, fn_of_n, n):
    """Host syncs of a baseline at n and 2n iterations (torch's sync debug
    mode): they must not grow with the iteration count."""
    few, _ = syncs_and_launches(torch, lambda: fn_of_n(n))
    more, _ = syncs_and_launches(torch, lambda: fn_of_n(2 * n))
    return few, more


def phase_baselines(torch, mods):
    """Paper Fig. 4 and Fig. 9 on the card at LOFAR CS302 size: dense NIHT
    (60 iterations), QNIHT 2&8 packed (60), IHT (120), CoSaMP (20), FISTA-ℓ1
    (180) with rel_error, support recovery and µs per iteration; the dirty
    image and beam at r = 256 and Högbom CLEAN (300 iterations, gain 0.1).
    Then on LOFAR-bench (r = 64) the card against the port's CPU on the same
    inputs (``hold_baseline``): IHT, CoSaMP and CLEAN by positions and
    values, FISTA by x; no baseline's host syncs grow with its iterations.
    The bench instance and the card's answers go to ``baselines_bench.npz``
    for ``scripts/reference_replay.py baselines``."""
    import numpy as np

    bl, cs, dev = mods["baselines"], mods["LOFAR"], torch.device(mods["device"])
    prng, s = mods["prng"], cs.n_sources
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    r = cs.resolution
    key = prng.PRNGKey(0)
    kw = dict(real_signal=True, nonneg=True)
    runs = (
        ("niht_32bit", BASELINE_ITERS["niht"],
         lambda n: mods["niht"].niht(phi, y, s, n, **kw)),
        (f"qniht_{cs.bits_phi}&{cs.bits_y}bit_packed", BASELINE_ITERS["qniht"],
         lambda n: mods["qniht"](phi, y, s, n, bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=key,
                                 requantize="fixed", backend="packed", **kw)),
        ("iht", BASELINE_ITERS["iht"], lambda n: bl.iht(phi, y, s, n, real_signal=True)),
        ("cosamp", BASELINE_ITERS["cosamp"], lambda n: bl.cosamp(phi, y, s, n, real_signal=True)),
        ("fista_l1", BASELINE_ITERS["fista_l1"],
         lambda n: bl.fista_l1(phi, y, n_iters=n, real_signal=True)),
    )
    out = {"fig4": {}}
    for name, n, run in runs:
        run(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        x = res[0]
        x = x.real if x.is_complex() else x
        row = {"n_iters": n, "us_per_iter": wall * 1e6 / n, "wall_s": wall,
               "rel_error": float(mods["relative_error"](x, x_true)),
               "support_recovery": float(mods["support_recovery"](x, x_true, s)),
               "source_recovery": float(mods["source_recovery"](x.reshape(r, r),
                                                                x_true.reshape(r, r), s, 1))}
        out["fig4"][name] = row
        print(f"[chip_smoke]   Fig. 4 {name}: rel_error={row['rel_error']:.4f} "
              f"support_recovery={row['support_recovery']:.3f} "
              f"{row['us_per_iter']:.1f} µs per iteration ({n})", flush=True)
        if not np.isfinite(row["rel_error"]):
            raise AssertionError(f"{name}: rel_error {row['rel_error']}")
    img = mods["dirty_image"](phi, y, r)
    beam = mods["dirty_beam"](phi, r)
    bl.clean(img, beam, CLEAN_GAIN, 2)                 # warm-up, as for each method above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps, resid, peaks = bl.clean(img, beam, CLEAN_GAIN, CLEAN_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    src = float(mods["source_recovery"](comps, x_true.reshape(r, r), s, 1))
    out["fig9"] = {"clean_s": wall, "us_per_iter": wall * 1e6 / CLEAN_ITERS,
                   "source_recovery": src, "components": int((comps != 0).sum()),
                   "last_peak": float(peaks[-1]), "dirty_peak": float(img.abs().max()),
                   "dirty_ms": time_ms(torch, lambda: mods["dirty_image"](phi, y, r), 3, flush),
                   "beam_ms": time_ms(torch, lambda: mods["dirty_beam"](phi, r), 3, flush),
                   "niht_source_recovery": out["fig4"]["niht_32bit"]["source_recovery"]}
    print(f"[chip_smoke]   Fig. 9 CLEAN r={r}, {CLEAN_ITERS} iterations, gain {CLEAN_GAIN}: "
          f"source_recovery={src:.3f} ({out['fig9']['components']} components; NIHT "
          f"{out['fig9']['niht_source_recovery']:.3f}), {wall * 1e3:.1f} ms; dirty image "
          f"{out['fig9']['dirty_ms']:.2f} ms, beam {out['fig9']['beam_ms']:.2f} ms", flush=True)
    del phi, img, beam

    bench = mods["LOFAR_BENCH"]
    rb, sb = bench.resolution, bench.n_sources
    phi, y, x_true = mods["lofar_instance"](bench, 0, 0, dev)
    img, beam = mods["dirty_image"](phi, y, rb), mods["dirty_beam"](phi, rb)
    cpu = {"phi": phi.cpu(), "y": y.cpu(), "img": img.cpu(), "beam": beam.cpu()}
    calls = {
        "iht": lambda p, v, n: bl.iht(p, v, sb, n, real_signal=True),
        "cosamp": lambda p, v, n: bl.cosamp(p, v, sb, n, real_signal=True),
        "fista_l1": lambda p, v, n: bl.fista_l1(p, v, n_iters=n, real_signal=True),
    }
    held, saved = {}, {"phi": cpu["phi"].numpy(), "y": cpu["y"].numpy(),
                       "x_true": x_true.cpu().numpy(), "s": sb,
                       "dirty_image": cpu["img"].numpy(), "dirty_beam": cpu["beam"].numpy(),
                       "clean_gain": CLEAN_GAIN, "n_iters_clean": CLEAN_ITERS,
                       "gamma_full": float(mods["rip"].gamma_full(phi))}
    for name, call in calls.items():
        n = BASELINE_ITERS[name]
        with record_picks(mods) as log_k:
            card = call(phi, y, n)
        with record_picks(mods) as log_c:
            host = call(cpu["phi"], cpu["y"], n)
        if name == "fista_l1":
            gap = float((card[0].cpu() - host[0]).abs().max() / host[0].abs().max())
            held[name] = {"max_rel_gap": gap}
            if not gap <= BASELINE_TOL:
                raise AssertionError(f"fista_l1: x on the card and the CPU differ by {gap:.2e}")
        else:
            held[name] = hold_baseline(torch, name, card, host, log_k, log_c, x_true.cpu(), 1)
        saved.update({f"n_iters_{name}": n, f"x_{name}": card[0].cpu().numpy(),
                      f"resid_{name}": card[1].cpu().numpy()})
    with record_picks(mods) as log_k:
        card = bl.clean(img, beam, CLEAN_GAIN, CLEAN_ITERS)
    with record_picks(mods) as log_c:
        host = bl.clean(cpu["img"], cpu["beam"], CLEAN_GAIN, CLEAN_ITERS)
    held["clean"] = hold_baseline(torch, "clean", card, host, log_k, log_c,
                                  x_true.cpu().reshape(rb, rb), 2)
    saved.update({"comps_clean": card[0].cpu().numpy(), "peaks_clean": card[2].cpu().numpy()})
    held["syncs"] = {name: baseline_syncs(torch, mods, lambda n, c=call: c(phi, y, n), 4)
                     for name, call in calls.items()}
    held["syncs"]["clean"] = baseline_syncs(
        torch, mods, lambda n: bl.clean(img, beam, CLEAN_GAIN, n), 4)
    grew = {k: v for k, v in held["syncs"].items() if v[1] != v[0]}
    print("[chip_smoke]   LOFAR-bench, card against CPU: " + "; ".join(
        f"{k}: max gap {v['max_rel_gap']:.1e}" + (f", parted at {v['parted_at']}"
                                                   if v.get("parted_at") is not None else "")
        for k, v in held.items() if k != "syncs") + "; host syncs at n / 2n iterations: "
        + ", ".join(f"{k} {a}/{b}" for k, (a, b) in held["syncs"].items()), flush=True)
    if grew:
        raise AssertionError(f"host syncs grow with the iterations: {grew}")
    path = mods["out_dir"] / "baselines_bench.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    out["bench_held"] = held
    out["saved"] = path.name
    return out


def run_main(main, argv):
    """The lines a CLI's main prints, run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


def sanitize_line(label, lines):
    line = next((ln for ln in lines if ln.startswith("[sanitize] ok ")), None)
    if line is None or not line.endswith("debug_nans=on debug_infs=on"):
        raise AssertionError(f"{label}: no [sanitize] ok line in {lines[-3:]}")
    return line


def phase_sanitize(torch, mods):
    """The NaN/Inf sanitizer on the card: ``recover --sanitize`` on LOFAR
    CS302 packed 2-bit and on ``mri-wavelet-bench``, and ``serve --config
    serve-gaussian-fault-packed`` (the config sanitizes), each ending with the
    reference's ``[sanitize] ok ...`` line, the serve run's with
    ``compiles_after_warmup=0``. Two planted faults must raise
    ``FloatingPointError`` naming where: a NaN in y (an aten op of the
    packed solve) and a finite x near the float32 maximum whose product with
    the LOFAR Φ̂ overflows only inside ``repro_qmm_tc`` (the kernel's
    entry). ``recover --profile-dir`` (LOFAR-bench, packed) writes a trace
    that names ``repro_qmm_tc``."""
    cs, dev, prng = mods["LOFAR"], torch.device(mods["device"]), mods["prng"]
    out = {}
    for label, argv in SANITIZE_RUNS:
        reset_counts(mods)
        t0 = time.perf_counter()
        lines = run_main(mods["recover_main"] if label != "serve" else mods["serve"].main,
                         [*argv, "--sanitize"] if label != "serve" else argv)
        wall = time.perf_counter() - t0
        line = sanitize_line(label, lines)
        if label == "serve" and "compiles_after_warmup=0 " not in line:
            raise AssertionError(f"serve: kernel libraries built after warm-up: {line}")
        out[label] = {"sanitize": line, "result": lines[-1], "s": wall,
                      "qmm_launches": mods["QMM"].launches}
        print(f"[chip_smoke]   {label} sanitized ({wall:.1f} s, qmm {mods['QMM'].launches}): "
              f"{line}", flush=True)
        print(f"[chip_smoke]     {lines[-1][:200]}", flush=True)

    phi, y, _ = mods["lofar_instance"](cs, 0, 0, dev)
    bad = y.clone()
    bad[5] = float("nan")
    with mods["sanitize"]():
        try:
            mods["qniht"](phi, bad, cs.n_sources, 3, bits_phi=cs.bits_phi, bits_y=cs.bits_y,
                          key=prng.PRNGKey(0), requantize="fixed", backend="packed",
                          real_signal=True, nonneg=True)
        except FloatingPointError as e:
            out["nan_in_y"] = str(e)
        else:
            raise AssertionError("a NaN planted in y did not trip the sanitizer")
    if "aten." not in out["nan_in_y"]:
        raise AssertionError(f"the NaN in y tripped without naming an op: {out['nan_in_y']}")
    w = mods["pack_operator"](phi, cs.bits_phi, prng.PRNGKey(0), shared=True).fwd_re
    x = torch.full((1, phi.shape[1]), OVERFLOW_X, device=dev)
    plain = mods["qmm_ref"](x, w.packed, w.scale, w.bits, w.k_dim)
    kernel = mods["qmm"](x, w)
    if torch.isfinite(plain).all() or not torch.equal(torch.isfinite(kernel),
                                                      torch.isfinite(plain)):
        raise AssertionError("x near the float32 maximum: the kernel's non-finite outputs "
                             "are not the plain version's")
    reset_counts(mods)
    with mods["sanitize"]():
        try:
            mods["qmm"](x, w)
        except FloatingPointError as e:
            out["overflow_in_qmm"] = str(e)
        else:
            raise AssertionError("an overflow inside repro_qmm_tc did not trip the sanitizer")
    if "kernel repro_qmm_tc" not in out["overflow_in_qmm"] or mods["QMM"].launches != 1:
        raise AssertionError(f"the overflow tripped elsewhere: {out['overflow_in_qmm']}")
    out["overflow_nonfinite"] = int((~torch.isfinite(kernel)).sum())
    print(f"[chip_smoke]   planted NaN in y: {out['nan_in_y']}", flush=True)
    print(f"[chip_smoke]   planted x = {OVERFLOW_X:g} ({out['overflow_nonfinite']} of "
          f"{kernel.numel()} outputs non-finite, as the plain version's): "
          f"{out['overflow_in_qmm']}", flush=True)
    del phi, w, x, plain, kernel

    import json as _json

    trace_dir = mods["out_dir"] / "profile_lofar_bench"
    run_main(mods["recover_main"], ["--config", "lofar-bench", "--backend", "packed",
                                    "--requantize", "fixed", "--profile-dir", str(trace_dir)])
    events = _json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    spans = sum(e.get("name") == "repro_qmm_tc" for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    out["profile"] = {"trace": str(trace_dir / "trace.json"), "repro_qmm_tc_spans": spans,
                      "device_kernels": kernels}
    print(f"[chip_smoke]   recover --profile-dir (lofar-bench packed): {spans} repro_qmm_tc "
          f"spans, {kernels} device kernel events", flush=True)
    if not spans or not kernels:
        raise AssertionError("the profile names no repro_qmm_tc span or holds no device kernel")
    return out


LM_KERNELS = ("QMM", "QMM_CORE", "QMM_GROUP", "QMM_GROUP_CORE", "QMM_BATCHED", "QMM_EXPERTS",
              "FLASH", "FLASH_TC", "FLASH_TC_UNALIGNED", "FLASH_UNALIGNED")
# fixed plain routes on the card, counted as kernels are: the vlm's K/V cast,
# the MoE expert products' materialize + bmm
LM_ROUTES = ("ATTENTION_KV_CAST", "EXPERT_BMM")
# plain versions the kernel routes must not run, by (module key in mods, name)
LM_PLAIN = (("lm_layers", "chunked_attention_plain"), ("qmm_ops", "qmm_ref"),
            ("qmm_ops", "qmm_batched_ref"), ("fa_ops", "attention_plain"))


@contextlib.contextmanager
def counting_plain(mods, calls):
    """Count, in ``calls``, the calls of the LM path's plain versions
    (``LM_PLAIN``) and of ``materialize`` (layers: the products; model: the
    unembedding; moe: the router, and the expert stacks on the bmm route):
    each stands in for itself through :func:`stand_in`."""
    targets = LM_PLAIN + (("lm_layers", "materialize"), ("lm_model", "materialize"),
                          ("lm_moe", "materialize"))

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call
    by_module = collections.defaultdict(dict)
    for m, n in targets:
        calls[f"{m}.{n}"] = 0
        by_module[m][n] = counted(f"{m}.{n}", getattr(mods[m], n))
    with contextlib.ExitStack() as stack:
        for m, fns in by_module.items():
            stack.enter_context(stand_in(mods[m], **fns))
        yield


def lm_snapshot(mods, calls):
    snap = {name: mods[name].launches for name in LM_KERNELS + LM_ROUTES}
    snap.update(calls)
    return snap


def lm_memory(mods, cfg, params, policy, source):
    """The memory the cross-attention layers read: ``encode`` of the stub
    frames ``source`` (encdec), the image embeddings themselves (vlm); None
    for the other families."""
    if source is None:
        return None
    if cfg.family == "encdec":
        return mods["lm_model"].encode(cfg, params, source, policy)
    return source


def lm_stub_source(torch, mods, cfg, b, key=4):
    """The stub input of a cross-attention family, float32 from
    ``PRNGKey(key)`` on the card: b × encoder_seq frames (encdec) or b ×
    n_image_tokens image rows (vlm), d_model wide; None otherwise."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    rows = cfg.encoder_seq if cfg.family == "encdec" else cfg.n_image_tokens
    return mods["prng"].normal(mods["prng"].PRNGKey(key), (b, rows, cfg.d_model),
                               device=torch.device(mods["device"]))


def lm_prompt_len(cfg) -> int:
    """Prompt tokens of a phase's run A: ENCDEC_PROMPT for whisper's decoder,
    else LM_PROMPT."""
    return ENCDEC_PROMPT if cfg.family == "encdec" else LM_PROMPT


def lm_generate(torch, mods, cfg, params, prompt, policy, source=None):
    """``generate`` with LM_DECODE_STEPS decode steps, a CUDA event and the
    launch and call counts after the prefill and after each step, over the
    memory of ``source`` (``lm_memory``; encdec: ``encode`` runs first, timed
    and counted on its own): (tokens, logits, device ms of the prefill and of
    each step, counts, host wall s, the encode's {"ms", "delta"} or None)."""
    events, counts, calls = [], [], collections.Counter()
    start = torch.cuda.Event(enable_timing=True)

    def on_step(i, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        counts.append(lm_snapshot(mods, calls))
    enc = None
    with counting_plain(mods, calls):
        torch.cuda.synchronize()
        before = lm_snapshot(mods, calls)
        t0 = time.perf_counter()
        start.record()
        memory = lm_memory(mods, cfg, params, policy, source)
        if cfg.family == "encdec":
            encoded = torch.cuda.Event(enable_timing=True)
            encoded.record()
            after = lm_snapshot(mods, calls)
            enc = {"delta": {k: after[k] - before[k] for k in after}, "event": encoded}
            before = after
        toks, logits = mods["generate"](cfg, params, prompt, LM_DECODE_STEPS + 1, policy,
                                        on_step=on_step, memory=memory)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    first = start if enc is None else enc.pop("event")
    if enc is not None:
        enc["ms"] = start.elapsed_time(first)
    ms = [first.elapsed_time(events[0])] + [a.elapsed_time(b) for a, b in
                                           zip(events, events[1:])]
    deltas = [{k: c[k] - p[k] for k in c} for p, c in zip([before] + counts, counts)]
    return toks, logits, ms, deltas, wall, enc


def lm_teacher_forced(torch, mods, cfg, params, prompt, toks, policy, source=None):
    """Logits (B, n, V) of a prefill over ``prompt`` and decode steps over
    toks[:, :n - 1], as ``generate`` takes them (teacher-forced), over the
    memory of ``source`` (``lm_memory``)."""
    b, s = prompt.shape
    n = toks.shape[1]
    memory = lm_memory(mods, cfg, params, policy, source)
    mem_len = 0 if memory is None else memory.shape[1]
    cache = mods["lm_model"].init_cache(cfg, b, s + n + 8, policy, mem_len=mem_len,
                                        device=prompt.device)
    logits, cache = mods["lm_model"].prefill(cfg, params, prompt, cache, policy=policy,
                                             memory=memory)
    out = [logits]
    for i in range(n - 1):
        logits, cache = mods["lm_model"].decode_step(cfg, params, toks[:, i], cache,
                                                     policy=policy, position=s + i)
        out.append(logits)
    return torch.stack(out, dim=1)


def lm_gap(torch, got, want):
    """max |got - want| over max |want|, per step (dim 1) and overall."""
    scale = want.float().abs().amax(dim=(0, 2)).clamp_min(1e-30)
    per_step = (got.float() - want.float()).abs().amax(dim=(0, 2)) / scale
    return [float(v) for v in per_step]


def lm_rel(got, want) -> float:
    """max |got - want| over max |want|, over the whole tensor."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def lm_products(cfg, stage="decode") -> int:
    """The QWeight products of one pass over ``cfg``'s layers: an attention
    layer's four (wq, wk, wv, wo) and an RG-LRU layer's five (in_x, in_gate,
    w_r, w_i, out), each with its MLP's (three for swiglu, else two); an SSD
    layer's two (in_proj, out_proj; it has no MLP); a cross-attention
    layer's self-attention four, its MLP's, and its cross-attention's wq and
    wo in a decode step, wq, wk, wv and wo in the prefill (the memory's K/V
    projected once). A MoE layer's experts are not among them
    (:func:`moe_counts`)."""
    mlp = 0 if cfg.n_experts else (3 if cfg.mlp_type == "swiglu" else 2)
    own = {"attn": 4 + mlp, "rec": 5 + mlp, "ssm": 2,
           "xattn": 4 + mlp + (2 if stage == "decode" else 4)}
    return sum(own[kind] for kind in cfg.pattern_for_layers())


def lm_attention_layers(cfg) -> int:
    """Layers with self-attention and a KV cache: "attn" and "xattn"."""
    return sum(kind in ("attn", "xattn") for kind in cfg.pattern_for_layers())


def lm_cross_layers(cfg) -> int:
    return sum(kind == "xattn" for kind in cfg.pattern_for_layers())


def lm_encoder_products(cfg) -> int:
    """The encoder's products: each "attn" block's four and its MLP's."""
    return cfg.n_encoder_layers * (4 + (3 if cfg.mlp_type == "swiglu" else 2))


def moe_groups(cfg, n_tok):
    """The token groups of a pass over n_tok tokens and their capacity."""
    g = min(cfg.moe_group_size, n_tok)
    return -(-n_tok // g), max(1, int(g * cfg.experts_per_token / cfg.n_experts
                                      * cfg.moe_capacity_factor))


def moe_counts(cfg, n_tok, quantized, max_rows):
    """What the expert layers of one pass over n_tok tokens launch and call:
    per layer and group, the three expert products on QMM_EXPERTS (W4 codes,
    a capacity of at most ``max_rows`` and bf16 activations; QMM_BATCHED on
    float32 ones) or on materialize + bmm (EXPERT_BMM, each product's stack
    materialized), and the router's materialize; nothing without experts."""
    if not cfg.n_experts:
        return {}
    groups, cap = moe_groups(cfg, n_tok)
    calls = cfg.n_layers * groups
    batched = quantized and cap <= max_rows
    kernel = "QMM_EXPERTS" if cfg.dtype == "bfloat16" else "QMM_BATCHED"
    return {kernel: 3 * calls if batched else 0,
            "EXPERT_BMM": 0 if batched else 3 * calls,
            "lm_moe.materialize": calls * (1 if batched else 4)}


def lm_quantized(mods, cfg):
    """The label and policy of ``cfg``'s quantized serving run: W4KV8, or W4
    for an attention-free stack (no KV cache for KV8 to act on)."""
    if lm_attention_layers(cfg):
        return "w4kv8", mods["QuantPolicy"](weight_bits=4, kv_bits=8)
    return "w4", mods["QuantPolicy"](weight_bits=4)


def lm_state_bytes(cfg, b, act_bytes=2) -> int:
    """The recurrent states of one decode step at batch b, each read once and
    written once: an RG-LRU layer's conv (d_conv − 1, W) in the activations'
    dtype and h (W) float32, an SSD layer's conv (d_conv − 1, d_inner +
    2·d_state) in the activations' dtype and state (H, hd, d_state) float32."""
    per_layer = {"attn": 0, "xattn": 0,
                 "rec": (cfg.ssm_conv - 1) * cfg.rnn_width_ * act_bytes + cfg.rnn_width_ * 4,
                 "ssm": ((cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * act_bytes
                         + cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4)}
    return 2 * b * sum(per_layer[kind] for kind in cfg.pattern_for_layers())


def lm_launch_gates(label, cfg, deltas, quantized, tag="lm", enc=None, shape=(LM_BATCH, 0),
                    max_rows=512):
    """The launch and call gates of one generate run, as failure messages:
    prefill FLASH_TC once per attention layer and once more per
    cross-attention layer (none for an attention-free stack), the K/V cast
    once per cross-attention layer where the memory is float32 (vlm), and no
    qmm; each decode step QMM once per QWeight product (``lm_products``; W4)
    or none (full precision), no other kernel, no plain version; materialize
    for the prefill's products, per decode step only for the unembedding
    (W4) and every product (full precision, whose f32 weights are cast);
    ``encode`` (``enc``, encdec) FLASH_TC once per encoder layer and
    materialize once per encoder product; a MoE layer's experts as
    :func:`moe_counts` says for the prompt's ``shape`` (B, S) and a step's B
    tokens. A count the gates do not name must be 0."""
    cross = lm_cross_layers(cfg)
    want_pre = {"FLASH_TC": lm_attention_layers(cfg) + cross,
                "ATTENTION_KV_CAST": cross if cfg.family == "vlm" else 0,
                "lm_layers.materialize": lm_products(cfg, "prefill"), "lm_model.materialize": 1,
                **moe_counts(cfg, shape[0] * shape[1], quantized, max_rows)}
    n = lm_products(cfg)
    want_dec = {"QMM": n if quantized else 0,
                "lm_layers.materialize": 0 if quantized else n,
                "lm_model.materialize": 1, **moe_counts(cfg, shape[0], quantized, max_rows)}
    stages = [("prefill", want_pre, deltas[0])] + [
        (f"decode step {step}", want_dec, d) for step, d in enumerate(deltas[1:], 1)]
    if enc is not None:
        stages.append(("encode", {"FLASH_TC": cfg.n_encoder_layers,
                                  "lm_layers.materialize": lm_encoder_products(cfg)},
                       enc["delta"]))
    fails = []
    for stage, want, d in stages:
        for key, got in d.items():
            if got != want.get(key, 0):
                fails.append(f"{tag} {label}: {stage} ran {key} {got} times, expected "
                             f"{want.get(key, 0)}")
    return fails


def lm_logit_gates(label, run, kv8, tag="lm"):
    """The logit gates of one run, as failure messages (see LM_TOL)."""
    fails = [] if run["finite"] else [f"{tag} {label}: non-finite logits"]
    for what, limit in run["limits"].items():
        if not run[what] <= limit:
            fails.append(f"{tag} {label}: {what} {run[what]:.4g} > {limit}")
    if not run["truth"]["kernel"] <= LM_TRUTH_RATIO * run["truth"]["plain"]:
        fails.append(f"{tag} {label}: the kernel routes are {run['truth']['kernel']:.4g} from "
                     f"the float32 truth, more than {LM_TRUTH_RATIO}× the plain routes' "
                     f"{run['truth']['plain']:.4g}")
    return fails


def lm_plain_routes(mods, cfg):
    """The plain routes of the card's two kernel routes in ``models/layers.py``,
    to stand in for them: materialize + matmul for ``qmm``, the reference's
    chunked online softmax for ``flash_attention`` (with its window and
    offset)."""
    layers = mods["lm_layers"]
    return dict(
        qweight_product=lambda x, w: x @ mods["lm_materialize"](w, x.dtype),
        attention_kernel=lambda q, k, v, causal, window=None, q_offset=0:
            layers.chunked_attention_plain(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                           window=window, q_offset=q_offset))


@contextlib.contextmanager
def attention_witness(mods, calls):
    """Keep, in ``calls``, the first non-causal ``attention_kernel`` call of
    each (Sq, Sk) on the path (an encoder's self-attention, a
    cross-attention), its inputs as the kernel got them and its output, to
    hold against the plain version afterwards (:func:`held_witness`)."""
    layers = mods["lm_layers"]
    kernel = layers.attention_kernel

    def witness(q, k, v, causal, window=None, q_offset=0):
        out = kernel(q, k, v, causal, window, q_offset)
        if not causal and (q.shape[2], k.shape[2]) not in calls:
            calls[(q.shape[2], k.shape[2])] = (q, k, v, out)
        return out
    with stand_in(layers, attention_kernel=witness):
        yield


@contextlib.contextmanager
def moe_witness(torch, mods, record, hold=None):
    """Record, in ``record``, what the expert layers of a pass did: each
    group's top-k picks (``picks``, (g, k) per call in call order), its
    dropped picks and capacity (``drops``), and the first group's input and
    router (``first``, kept once). With a ``hold`` dict, hold each
    ``qmm_batched`` call of the prefill and of the first decode step (the
    first 3·L calls at a decode step's capacity, ``hold["decode_cap"]``)
    against ``qmm_batched_ref`` on the same inputs without the rows in use
    (the full xe: a ``rows`` that drops a slot in use shows), row by row:
    ‖Δ‖/‖ref‖ of every (expert, slot) row into ``hold["gaps"]``. ``record``
    None: no witness."""
    if record is None:
        yield
        return
    moe = mods["lm_moe"]
    route, slots, batched = moe.route, moe.slots, moe.qmm_batched
    record.setdefault("picks", [])
    record.setdefault("drops", [])

    def routed(xg, router_w, top_k):
        out = route(xg, router_w, top_k)
        record["picks"].append(out[2])
        if "first" not in record:
            record["first"] = (xg.clone(), router_w)
        return out

    def slotted(gate_idx, n_experts, cap):
        slot, kept, rows = slots(gate_idx, n_experts, cap)
        record["drops"].append((kept.numel() - kept.sum(), cap))
        return slot, kept, rows

    def held_call(x, w_packed, scale, bits, k_dim, rows=None):
        y = batched(x, w_packed, scale, bits, k_dim, rows)
        decode = x.shape[1] == hold["decode_cap"]
        if not decode or hold.setdefault("decode", 0) < 3 * hold["layers"]:
            if decode:
                hold["decode"] += 1
            ref = mods["qmm_batched_ref"](x, w_packed, scale, bits, k_dim)
            num = torch.linalg.vector_norm(y - ref, dim=-1)
            den = torch.linalg.vector_norm(ref, dim=-1)
            hold["gaps"].append(torch.where(den > 0, num / den.clamp_min(1e-30), num).max())
        return y
    stands = dict(route=routed, slots=slotted)
    if hold is not None:
        hold.setdefault("gaps", [])
        stands["qmm_batched"] = held_call
    with stand_in(moe, **stands):
        yield


def moe_drops(torch, cfg, record, shape):
    """Dropped picks per layer of the kernel run: the prefill's (its groups
    summed) and each decode step's, with their capacities."""
    groups, cap = moe_groups(cfg, shape[0] * shape[1])
    d = [int(v) for v in torch.stack([c for c, _ in record["drops"]]).cpu()]
    n_pre, k = cfg.n_layers * groups, cfg.experts_per_token
    pre = [sum(d[i * groups:(i + 1) * groups]) for i in range(cfg.n_layers)]
    dec = d[n_pre:]
    return {"prefill": {"capacity": cap, "groups": groups, "picks_per_layer": shape[0] * shape[1]
                        * k, "mean_per_layer": sum(pre) / len(pre), "max_per_layer": max(pre)},
            "decode": {"capacity": moe_groups(cfg, shape[0])[1], "picks_per_layer": shape[0] * k,
                       "mean_per_layer": sum(dec) / max(len(dec), 1),
                       "max_per_layer": max(dec, default=0), "layer_steps": len(dec)}}


def picks_differ(torch, a, b):
    """The picks of run a that run b did not make, call by call (the same
    sequence of groups): {"differ", "picks"}."""
    if len(a) != len(b):
        raise AssertionError(f"the runs routed {len(a)} and {len(b)} groups")
    differ = sum(int((~(x[:, :, None] == y[:, None, :]).any(-1)).sum()) for x, y in zip(a, b))
    return {"differ": differ, "picks": sum(x.numel() for x in a)}


def held_witness(torch, mods, label, calls, tag):
    """Each call of ``attention_witness`` against ``attention_plain`` on its
    inputs (2e-2 and the 2⁻⁷ row rule): {"Sq x Sk": gap}, and failure
    messages."""
    out, fails = {}, []
    for (sq, sk), (q, k, v, o) in calls.items():
        ref = mods["attention_plain"](q, k, v, causal=False, scale=q.shape[-1] ** -0.5)
        try:
            out[f"{sq}x{sk}"] = held(torch, f"{tag} {label} non-causal {sq}x{sk}", o, ref, 2e-2,
                                     rows=True)
        except AssertionError as e:
            out[f"{sq}x{sk}"] = attention_gap(torch, o, ref, 2e-2)
            fails.append(f"{tag} {label}: {e}")
    return out, fails


def lm_check_run(torch, mods, cfg, label, policy, tree, prompt, quantized, limits=None,
                 tag="lm", source=None, record=None):
    """One generate run on the kernel routes, held to every gate of phase lm:
    the launch and call counts per step, the logits against the plain routes
    on the card (teacher-forced on the run's tokens) and against ``forward``
    over prompt + generated tokens, and all three against the float32 truth
    (``forward`` of the float32 model on the same weights and tokens, exact
    K/V; for encdec the float32 serving path with exact K/V, as its
    ``forward`` leaves RoPE out). ``limits`` (default LM_TOL and
    LM_KV8_FORWARD_TOL) bound the logits against the plain routes and
    against ``forward``. With a ``source`` (the cross-attention families'
    frames or image rows) the run also holds each non-causal attention call
    it made (``attention_witness``) against the plain version. A MoE
    family's serving and ``forward`` route other groups (a decode step's B
    tokens are one group of capacity 1): its prefill's logits are held
    against ``forward`` over the prompt alone (the same groups), its truth
    is the float32 serving path with exact K/V, the plain routes and the
    truth go over the prefill and the first MOE_HELD_STEPS decode steps,
    each of its batched qmm calls in the prefill and the first decode step
    is held against the plain version (``moe_witness``, MOE_QMM_ROW_TOL),
    and the runs' picks are compared; ``record`` (a dict) keeps the kernel
    run's picks, drops and first group. Returns (run, with its failed gates in
    ``gates_failed``; tokens)."""
    m = mods["lm_model"]
    kv8 = policy.kv_bits is not None
    s = prompt.shape[1]
    experts = bool(cfg.n_experts)
    witnessed = {}
    kernel_record = {} if experts else None
    hold = ({"layers": cfg.n_layers, "decode_cap": moe_groups(cfg, prompt.shape[0])[1]}
            if experts else None)
    with attention_witness(mods, witnessed), moe_witness(torch, mods, kernel_record, hold):
        toks, logits, ms, deltas, wall, enc = lm_generate(torch, mods, cfg, tree, prompt, policy,
                                                          source)
    by_shape = dict(mods["QMM"].launches_by_shape)
    experts_by_shape = dict(mods["QMM_EXPERTS"].launches_by_shape)
    run = {"qmm_launches": sum(d["QMM"] for d in deltas),
           "qmm_batched_launches": sum(d["QMM_BATCHED"] for d in deltas),
           "qmm_experts_launches": sum(d["QMM_EXPERTS"] for d in deltas),
           "qmm_experts_per_decode_step": deltas[1]["QMM_EXPERTS"],
           "qmm_experts_per_prefill": deltas[0]["QMM_EXPERTS"],
           "qmm_experts_launches_by_shape": {"x".join(map(str, key)): c
                                             for key, c in experts_by_shape.items()},
           "qmm_launches_by_shape": {f"{n}x{k}": c for (n, k), c in by_shape.items()},
           "flash_tc_launches": sum(d["FLASH_TC"] for d in deltas),
           "flash_tc_launches_by_shape": {str(key): c for key, c in
                                          mods["FLASH_TC"].launches_by_shape.items()},
           "qmm_per_decode_step": deltas[1]["QMM"], "flash_per_prefill": deltas[0]["FLASH_TC"],
           "finite": bool(torch.isfinite(logits).all()), "first_wall_s": wall,
           "first_prefill_ms": ms[0], "first_decode_ms_median": sorted(ms[1:])[(len(ms) - 1) // 2],
           "limits": limits or {"vs_plain_max_rel": LM_TOL,
                                "vs_forward_max_rel": LM_KV8_FORWARD_TOL if kv8 else LM_TOL}}
    if enc is not None:
        run["first_encode_ms"] = enc["ms"]
        run["flash_per_encode"] = enc["delta"]["FLASH_TC"]
    fails = lm_launch_gates(label, cfg, deltas, quantized, tag, enc, tuple(prompt.shape),
                            mods["lm_layers"].QMM_MAX_ROWS)
    if experts:
        gaps = torch.stack(hold["gaps"]).cpu() if hold["gaps"] else torch.zeros(0)
        want = 3 * cfg.n_layers * (moe_groups(cfg, prompt.numel())[0] + 1) if quantized else 0
        run["held_qmm_batched"] = {"calls": len(gaps), "expected": want,
                                   "max_row_rel": float(gaps.max()) if len(gaps) else None,
                                   "limit": MOE_QMM_ROW_TOL}
        if len(gaps) != want or (len(gaps) and not float(gaps.max()) <= MOE_QMM_ROW_TOL):
            fails.append(f"{tag} {label}: held batched qmm calls {run['held_qmm_batched']}")
        run["drops"] = moe_drops(torch, cfg, kernel_record, prompt.shape)
        if record is not None:
            record.update(kernel_record)
    if source is not None:
        run["witness"], witness_fails = held_witness(torch, mods, label, witnessed, tag)
        fails += witness_fails
    del witnessed
    before = {name: mods[name].launches for name in LM_KERNELS}
    plain_record = {} if experts else None
    held = toks[:, :MOE_HELD_STEPS + 1] if experts else toks
    with stand_in(mods["lm_layers"], **lm_plain_routes(mods, cfg)), \
            stand_in(mods["lm_moe"], qmm_batched=mods["qmm_batched_ref"]), \
            moe_witness(torch, mods, plain_record):
        plain_logits = lm_teacher_forced(torch, mods, cfg, tree, prompt, held, policy, source)
    launched = {name: mods[name].launches - before[name] for name in LM_KERNELS}
    if any(launched.values()):
        fails.append(f"{tag} {label}: the plain routes launched {launched}")
    kernel_held = logits[:, :held.shape[1]]
    run["vs_plain_per_step"] = lm_gap(torch, kernel_held, plain_logits)
    run["vs_plain_max_rel"] = lm_rel(kernel_held, plain_logits)
    run["greedy_agree_with_plain"] = float((plain_logits.argmax(-1) == held).float().mean())
    seq = prompt if experts else torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
    memory = lm_memory(mods, cfg, tree, policy, source)
    before = mods["FLASH_TC"].launches
    fwd = m.forward(cfg, tree, seq, policy=policy, memory=memory)[0][:, s - 1:]
    if mods["FLASH_TC"].launches - before != lm_attention_layers(cfg) + lm_cross_layers(cfg):
        fails.append(f"{tag} {label}: forward launched FLASH_TC "
                     f"{mods['FLASH_TC'].launches - before} times")
    del memory
    served = logits[:, :fwd.shape[1]]                    # MoE: the prefill's logits alone
    run["vs_forward_max_rel"] = lm_rel(served, fwd)
    before = mods["FLASH"].launches
    batched_before = collections.Counter(mods["QMM_BATCHED"].launches_by_shape)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    truth_record = {} if experts else None
    if cfg.family == "encdec" or experts:
        with moe_witness(torch, mods, truth_record):
            truth = lm_teacher_forced(torch, mods, cfg32, tree, prompt, held,
                                      dataclasses.replace(policy, kv_bits=None), source)
    else:
        truth = m.forward(cfg32, tree, seq, policy=policy,
                          memory=lm_memory(mods, cfg32, tree, policy, source))[0][:, s - 1:]
    run["truth_flash_f32_launches"] = mods["FLASH"].launches - before
    run["truth_qmm_batched_launches_by_shape"] = {
        "x".join(map(str, key)): c - batched_before[key]
        for key, c in mods["QMM_BATCHED"].launches_by_shape.items() if c > batched_before[key]}
    run["truth"] = {name: lm_rel(a[:, :truth.shape[1]], truth[:, :a.shape[1]]) for name, a in (
        ("kernel", logits), ("plain", plain_logits), ("forward", fwd))}
    if experts:
        n = len(plain_record["picks"])           # the groups of the held steps
        run["held_steps"] = held.shape[1] - 1
        run["picks_differ"] = {
            "kernel_vs_plain": picks_differ(torch, kernel_record["picks"][:n],
                                            plain_record["picks"]),
            "kernel_vs_truth": picks_differ(torch, kernel_record["picks"][:n],
                                            truth_record["picks"])}
    del kernel_record, plain_record, truth_record
    del plain_logits, fwd, truth, logits
    run["gates_failed"] = fails + lm_logit_gates(label, run, kv8, tag)
    print(f"[chip_smoke]   {tag} {label}: qmm {run['qmm_per_decode_step']} per decode step, "
          f"FLASH_TC {run['flash_per_prefill']} per prefill"
          + (f" and {run['flash_per_encode']} per encode" if enc is not None else "")
          + (f"; non-causal calls held against the plain version: "
             f"{ {k: round(v['max_row_rel'], 5) for k, v in run['witness'].items()} } (max row "
             f"‖Δ‖/‖ref‖)" if source is not None else "")
          + f"; logits vs the plain routes "
          f"{run['vs_plain_max_rel']:.4g} (limit {run['limits']['vs_plain_max_rel']}), vs "
          f"forward {run['vs_forward_max_rel']:.4g} (limit "
          f"{run['limits']['vs_forward_max_rel']}) of max|logits|; against the float32 truth: "
          f"kernel routes {run['truth']['kernel']:.4g}, plain routes {run['truth']['plain']:.4g}"
          f" (ratio {run['truth']['kernel'] / run['truth']['plain']:.3f}, limit "
          f"{LM_TRUTH_RATIO}), forward {run['truth']['forward']:.4g} (greedy tokens agree with "
          f"the plain routes' argmax {run['greedy_agree_with_plain']:.0%})"
          + (f"; batched qmm calls held against the plain version: {run['held_qmm_batched']}; "
             f"picks that differ: {run['picks_differ']}; drops {run['drops']}" if experts else "")
          + f"; gates failed: {len(run['gates_failed'])}", flush=True)
    return run, toks


def lm_profile_step(torch, mods, cfg, params, prompt, policy, source=None):
    """One warm decode step under torch.profiler: its wall, device busy time,
    qmm's device time and the device launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m = mods["lm_model"]
    b, s = prompt.shape
    memory = lm_memory(mods, cfg, params, policy, source)
    cache = m.init_cache(cfg, b, s + 4, policy, mem_len=0 if memory is None else memory.shape[1],
                         device=prompt.device)
    logits, cache = m.prefill(cfg, params, prompt, cache, policy=policy, memory=memory)
    del memory
    tok = logits.argmax(-1)
    logits, cache = m.decode_step(cfg, params, tok, cache, policy=policy)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.decode_step(cfg, params, tok, cache, policy=policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events) / 1e3
    qmm = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events
              if "qmm_wgmma_kernel" in e.key) / 1e3
    top = sorted(({"name": e.key[:80], "device_ms": (getattr(e, "self_device_time_total", 0)
                                                      or 0) / 1e3, "calls": e.count}
                  for e in events), key=lambda r: -r["device_ms"])[:12]
    if not events:
        return {"wall_ms": wall * 1e3, "device_busy_ms": None, "qmm_device_ms": None}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "device_busy_share": busy / wall / 1e3,
            "qmm_device_ms": qmm, "qmm_share_of_busy": qmm / busy if busy else None,
            "device_launches": sum(e.count for e in events), "top": top}


def lm_qmm_check(torch, mods, name, x, pw, y):
    """max |y - qmm_ref| of a qmm call, raising past qmm's rule |Δ| <=
    1e-5·|ref| + 1e-5·(|x| @ |w|ᵀ)."""
    k, bits = pw.k_dim, pw.bits
    ref = mods["qmm_ref"](x, pw.packed, pw.scale, bits, k)
    wabs = mods["unpack_codes"](pw.packed, bits, k).float().abs() * (
        pw.scale.reshape(-1, 1) / mods["BY_BITS"][bits].half_steps)
    err = (y - ref).abs()
    if not bool((err <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wabs.T)).all()):
        raise AssertionError(f"{name} M={x.shape[0]}: max |Δ| {float(err.max())} exceeds the "
                             "tolerance")
    return float(err.max())


def lm_qmm_row(torch, mods, tag, name, qw, gen, flush, x_dtype=None):
    """qmm at M = LM_BATCH on one layer's QWeight ``qw`` (x of bf16 values, or
    float32 ones with ``x_dtype``, as the RG-LRU's gates take): the kernel,
    its plain version, torch.matmul on the dequantized weight in x's type,
    and the bound, held to qmm's rule; it must route to QMM."""
    QMM, qmm_ref = mods["QMM"], mods["qmm_ref"]
    dev = torch.device(mods["device"])
    pw = qw.packed_weights()
    if mods["cuda_kernel"](pw) is not QMM:
        raise AssertionError(f"{tag} qmm {name}: routed to {mods['cuda_kernel'](pw).entry}")
    n, kp = pw.packed.shape
    k = pw.k_dim
    x_dtype = x_dtype or torch.bfloat16
    xt = torch.randn(LM_BATCH, k, generator=gen, device=dev).to(x_dtype)
    x = xt.float()
    err = lm_qmm_check(torch, mods, f"{tag} qmm {name}", x, pw, mods["qmm"](xt, pw))
    w = qw.dequantize(x_dtype)
    b_ms, b_by, bb_ms = lm_qmm_bound_ms(LM_BATCH, n, k, kp, xt.element_size())
    row = {"shape": name, "M": LM_BATCH, "N": n, "K": k, "bits": pw.bits,
           "x_dtype": str(x_dtype).replace("torch.", ""), "max_abs_err": err,
           "ms": time_ms(torch, lambda: QMM(x, pw.packed, pw.scale, pw.bits, k), 20, flush),
           "plain_ms": time_ms(torch, lambda: qmm_ref(x, pw.packed, pw.scale, pw.bits, k),
                               5, flush),
           "library_ms": time_ms(torch, lambda: torch.matmul(xt, w), 20, flush),
           "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms}
    print(f"[chip_smoke]   {tag} qmm {name:8s} M={LM_BATCH} N={n:5d} K={k:5d}: "
          f"max|Δ|={err:.3g} kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"matmul({row['x_dtype']} w) {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return row


def lm_kernel_rows(torch, mods, cfg, qparams, flush):
    """qmm at M = LM_BATCH on layer 0's six products (kernel, plain version,
    torch.matmul on the dequantized bf16 weight, bound), qmm at the prefill's
    M = LM_BATCH·LM_PROMPT on the MLP's wi beside materialize + matmul, a
    layer's six products on both routes of ``dense`` at LM_ROUTE_ROWS rows,
    and flash attention at B = LM_BATCH, S = LM_PROMPT beside SDPA and its
    bound. x holds bf16 values, as on the path; the kernel reads them as the
    float32 that ``qmm`` hands it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = torch.device(mods["device"])
    gen = torch.Generator(device=dev).manual_seed(20)
    QMM, qmm = mods["QMM"], mods["qmm"]
    layers, materialize = mods["lm_layers"], mods["lm_materialize"]
    slot = qparams["slots"]["slot0"]
    products = {"wq": slot["attn"]["wq"]["w"], "wk": slot["attn"]["wk"]["w"],
                "wv": slot["attn"]["wv"]["w"], "wo": slot["attn"]["wo"]["w"],
                "mlp_wi": slot["ffn"]["wi"]["w"], "mlp_wo": slot["ffn"]["wo"]["w"]}
    rows = [lm_qmm_row(torch, mods, "lm", name, stacked[0], gen, flush)
            for name, stacked in products.items()]
    # the prefill's rows: M = B·S on the MLP's wi
    qw = products["mlp_wi"][0]
    pw = qw.packed_weights()
    n, kp = pw.packed.shape
    k, m = pw.k_dim, LM_BATCH * LM_PROMPT
    x16 = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    x = x16.float()
    err = lm_qmm_check(torch, mods, "lm mlp_wi", x, pw, qmm(x16, pw))
    b_ms, b_by, bb_ms = lm_qmm_bound_ms(m, n, k, kp)
    prefill_row = {
        "shape": "mlp_wi", "M": m, "N": n, "K": k, "bits": pw.bits, "max_abs_err": err,
        "ms": time_ms(torch, lambda: QMM(x, pw.packed, pw.scale, pw.bits, k), 3, flush),
        "materialize_matmul_ms": time_ms(
            torch, lambda: torch.matmul(x16, materialize(qw, torch.bfloat16)), 3, flush),
        "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms}
    print(f"[chip_smoke]   lm qmm mlp_wi at the prefill's M={m}: kernel {prefill_row['ms']:.3f} ms"
          f"  materialize + matmul (bf16) {prefill_row['materialize_matmul_ms']:.3f} ms  "
          f"bound {b_ms:.3f} ms ({b_by})", flush=True)
    del x, x16
    # the route threshold: a layer's six products at M rows through each route of dense
    route_rows = []
    for m in LM_ROUTE_ROWS:
        t_qmm = t_mat = 0.0
        for qw in (stacked[0] for stacked in products.values()):
            x = torch.randn(m, qw.k_dim, generator=gen, device=dev).to(torch.bfloat16)
            t_qmm += time_ms(torch, lambda x=x, qw=qw: layers.qweight_product(x, qw).to(x.dtype),
                             5, flush)
            t_mat += time_ms(torch, lambda x=x, qw=qw: x @ materialize(qw, x.dtype), 5, flush)
        route_rows.append({"M": m, "qmm_ms": t_qmm, "materialize_matmul_ms": t_mat})
        print(f"[chip_smoke]   lm a layer's six products at M={m:4d}: qmm {t_qmm:.4f} ms, "
              f"materialize + matmul {t_mat:.4f} ms", flush=True)
    qmm_faster = 0
    for r in route_rows:
        if r["qmm_ms"] >= r["materialize_matmul_ms"]:
            break
        qmm_faster = r["M"]
    print(f"[chip_smoke]   lm qmm ahead up to M={qmm_faster} of {LM_ROUTE_ROWS}; the route "
          f"threshold QMM_MAX_ROWS = {layers.QMM_MAX_ROWS}", flush=True)
    # the prefill's attention
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    q, kk, v = (torch.randn(LM_BATCH, h, LM_PROMPT, d, generator=gen, device=dev)
                .to(torch.bfloat16) for h in (hq, hkv, hkv))
    FLASH_TC = mods["FLASH_TC"]
    before = FLASH_TC.launches
    out = mods["flash_attention"](q, kk, v, causal=True)
    if FLASH_TC.launches != before + 1:
        raise AssertionError("lm flash: FLASH_TC was not launched")
    ref = mods["attention_plain"](q, kk, v, causal=True, scale=d ** -0.5)
    gap = held(torch, "lm prefill", out, ref, 2e-2, rows=True)     # the flash phase's bf16 rule

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(q, kk, v, is_causal=True,
                                                                    enable_gqa=True)
    b_ms, b_by, _ = attention_bound(LM_BATCH, hq, hkv, LM_PROMPT, LM_PROMPT, d, 2, True)
    flash_row = {"B": LM_BATCH, "Hq": hq, "Hkv": hkv, "S": LM_PROMPT, "D": d,
                 "max_abs_err": gap["max_abs_err"], "max_row_rel": gap["max_row_rel"],
                 "ms": time_ms(torch, lambda: FLASH_TC(q, kk, v, True, d ** -0.5), 10, flush),
                 "plain_ms": time_ms(torch, lambda: mods["attention_plain"](
                     q, kk, v, causal=True, scale=d ** -0.5), 3, flush),
                 "library_ms": time_ms(torch, sdpa, 10, flush),
                 "bound_ms": b_ms, "bound_by": b_by}
    print(f"[chip_smoke]   lm flash B={LM_BATCH} Hq={hq} Hkv={hkv} S={LM_PROMPT} D={d} bf16: "
          f"max|Δ|={gap['max_abs_err']:.3g} kernel {flash_row['ms']:.4f} ms  plain "
          f"{flash_row['plain_ms']:.3f} ms  SDPA {flash_row['library_ms']:.4f} ms  bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return {"qmm_rows": rows, "qmm_prefill_row": prefill_row, "route_rows": route_rows,
            "qmm_ahead_up_to_rows": qmm_faster, "qmm_max_rows": layers.QMM_MAX_ROWS,
            "flash_row": flash_row}


def lm_card_vs_cpu(torch, mods, cfg, tag="lm", n_layers=LM_CPU_LAYERS,
                   prompt_len=LM_CPU_PROMPT, decode_steps=LM_CPU_DECODE_STEPS, **replace):
    """``n_layers`` layers of ``cfg`` (and the fields of ``replace``) at full
    width in float32 on the card and on the port's CPU, the same weights
    (drawn on the card, copied): logits of a prefill of ``prompt_len`` tokens
    and ``decode_steps`` decode steps over the card's greedy tokens, full
    precision and W4 (the card's decode products on qmm), held within
    LM_CPU_TOL of max|logits|, TF32 off; a cross-attention family over the
    memory of the same stub input (``lm_stub_source``) on both devices. The cache
    stays float: an int8 KV code can round the other way on the two
    devices."""
    dev = torch.device(mods["device"])
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32", **replace)
    params = mods["lm_model"].init_params(cfg2, mods["prng"].PRNGKey(0), device=dev)
    prompt = mods["prng"].randint(mods["prng"].PRNGKey(2), (LM_CPU_BATCH, prompt_len), 0,
                                  cfg2.vocab_size, device=dev)
    source = lm_stub_source(torch, mods, cfg2, LM_CPU_BATCH, key=5)
    out = {}
    for label, policy, tree in (
            ("fp32", mods["QuantPolicy"](), params),
            ("w4", mods["QuantPolicy"](weight_bits=4), mods["quantize_params"](params, 4))):
        toks, card = mods["generate"](cfg2, tree, prompt, decode_steps + 1, policy,
                                      memory=lm_memory(mods, cfg2, tree, policy, source))
        t0 = time.perf_counter()
        cpu = lm_teacher_forced(torch, mods, cfg2, mods["lm_tree_to"](tree, "cpu"), prompt.cpu(),
                                toks.cpu(), policy, None if source is None else source.cpu())
        cpu_s = time.perf_counter() - t0
        gaps = lm_gap(torch, card.cpu(), cpu)
        out[label] = {"max_rel": max(gaps), "per_step": gaps, "cpu_s": cpu_s}
        print(f"[chip_smoke]   {tag} card vs CPU, {n_layers} layers float32 {label}: max "
              f"|Δ|/max|logits| {max(gaps):.3g} over the prefill of {prompt_len} tokens and "
              f"{decode_steps} steps (CPU {cpu_s:.1f} s)", flush=True)
        if not max(gaps) <= LM_CPU_TOL:
            raise AssertionError(f"{tag} card vs CPU {label}: {max(gaps)} > {LM_CPU_TOL}")
    return out


def lm_setup(torch, mods, arch=LM_ARCH, tag="lm"):
    """``arch``'s config (starcoder2-3b by default), its f32 parameters from
    PRNGKey(0) on the card, their W4 tree (nearest) and LM_BATCH prompts of
    LM_PROMPT tokens from PRNGKey(1), with the set-up's readings; every layer
    slice of every slot's W4 kernels, and every tail layer's, must route to
    QMM."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device(mods["device"])
    prng, m = mods["prng"], mods["lm_model"]
    cfg = mods["lm_get_config"](arch)
    out = {"config": cfg.name, "batch": LM_BATCH, "prompt": lm_prompt_len(cfg),
           "decode_steps": LM_DECODE_STEPS}
    t0 = time.perf_counter()
    params = m.init_params(cfg, prng.PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = mods["quantize_params"](params, 4)
    torch.cuda.synchronize()
    out["quantize_s"] = time.perf_counter() - t0
    out["param_bytes"] = {"fp32": mods["param_bytes"](params),
                          "w4": mods["param_bytes"](qparams)}
    layers = [qparams["tail"]]
    for slot in qparams["slots"].values():
        n_full = next(w.packed.shape[0] for w in mods["tree_leaves"](slot)
                      if isinstance(w, mods["QWeight"]))
        layers += [mods["tree_map"](lambda w, i=i: w[i], slot) for i in range(n_full)]
    qweights = [w for layer in layers for w in mods["tree_leaves"](layer)
                if isinstance(w, mods["QWeight"])]
    layer_codes = sum(w.packed.numel() for w in qweights)
    out["layer_code_bytes"] = layer_codes
    out["layer_qweights"] = len(qweights)
    for w in qweights:                            # every layer slice on the tensor cores
        if mods["cuda_kernel"](w.packed_weights()) is not mods["QMM"]:
            raise AssertionError(f"{tag}: the codes {tuple(w.packed.shape)} do not route to QMM")
    print(f"[chip_smoke]   {tag} {cfg.name}: init {out['init_s']:.1f} s, quantize W4 "
          f"{out['quantize_s']:.1f} s; param bytes {out['param_bytes']['fp32']:,} (f32) -> "
          f"{out['param_bytes']['w4']:,} (W4), layer codes {layer_codes:,}", flush=True)
    prompt = prng.randint(prng.PRNGKey(1), (LM_BATCH, lm_prompt_len(cfg)), 0, cfg.vocab_size,
                          device=dev)
    return cfg, params, qparams, prompt, out


def lm_decode_weights(tree):
    """The parameters a decode step reads: the slots and the tail, without
    the cross-attention's wk and wv (the prefill projected the memory once;
    each step reads the cached K/V), and the unembedding."""
    def read(block):
        if isinstance(block, dict) and "xattn" in block:
            return {**block, "xattn": {k: v for k, v in block["xattn"].items()
                                       if k in ("wq", "wo")}}
        return block
    return {"slots": {k: read(v) for k, v in tree["slots"].items()},
            "tail": [read(b) for b in tree["tail"]], "unembed": tree["unembed"]}


def lm_step_bounds(torch, mods, cfg, params, qparams, layer_codes, flush, tag="lm"):
    """The bytes a quantized decode step (W4KV8, or W4 for an attention-free
    stack) at B = LM_BATCH must read (layer codes, scales, biases, norms and
    recurrent parameters, the unembedding's codes, the int8 KV cache at the
    mean length, capped at the local window; the cross-attention layers'
    cached memory K/V in bf16, without their wk and wv; the recurrent
    states, read and written), the same at full precision (f32 weights, bf16
    cache), as times at HBM_BYTES_PER_S, and the unembedding's dequantize,
    which every W4 step runs."""
    label = lm_quantized(mods, cfg)[0]
    mean_len = lm_prompt_len(cfg) + LM_DECODE_STEPS // 2
    if cfg.local_window:
        mean_len = min(mean_len, cfg.local_window)
    kv_elems = (lm_attention_layers(cfg) * 2 * LM_BATCH * cfg.padded_kv_heads * mean_len
                * cfg.head_dim_)
    kv_bytes = kv_elems + (kv_elems // cfg.head_dim_ * 4 if kv_elems else 0)  # codes, scales
    mem_rows = {"encdec": cfg.encoder_seq, "vlm": cfg.n_image_tokens}.get(cfg.family, 0)
    cross_bytes = (lm_cross_layers(cfg) * 2 * LM_BATCH * cfg.padded_kv_heads * mem_rows
                   * cfg.head_dim_ * 2)
    state_bytes = lm_state_bytes(cfg, LM_BATCH)
    out = {"state_bytes": state_bytes, "cross_kv_bytes": cross_bytes}
    step_bytes = (mods["param_bytes"](lm_decode_weights(qparams)) + kv_bytes + cross_bytes
                  + state_bytes)
    out[f"{label}_step_bytes"] = step_bytes
    out[f"{label}_step_bound_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
    read = lm_decode_weights(qparams)
    read_codes = sum(w.packed.numel() for w in mods["tree_leaves"]([read["slots"], read["tail"]])
                     if isinstance(w, mods["QWeight"]))
    out["layer_codes_read_bytes"] = read_codes          # of layer_codes: all but cross wk, wv
    out["layer_codes_bound_ms"] = read_codes / HBM_BYTES_PER_S * 1e3
    out["full_step_bound_ms"] = None if params is None else (
        (mods["param_bytes"](lm_decode_weights(params)) + 2 * kv_elems + cross_bytes
         + state_bytes) / HBM_BYTES_PER_S * 1e3)
    unembed = qparams["unembed"]["w"]
    out["unembed_dequantize_ms"] = time_ms(
        torch, lambda: mods["lm_materialize"](unembed, torch.bfloat16), 5, flush)
    print(f"[chip_smoke]   {tag} {label.upper()} bytes per step {step_bytes:,} -> bound "
          f"{out[f'{label}_step_bound_ms']:.3f} ms (layer codes alone "
          f"{out['layer_codes_bound_ms']:.3f} ms, recurrent states {state_bytes:,} bytes, "
          f"cross K/V {cross_bytes:,} bytes); "
          f"the unembedding's dequantize "
          f"{out['unembed_dequantize_ms']:.3f} ms per step; full precision bound "
          f"{out['full_step_bound_ms']} ms", flush=True)
    return out


def lm_serve_runs(torch, mods, cfg, params, qparams, prompt, limits=None, tag="lm",
                  source=None, record=None):
    """The quantized run (``lm_quantized``: W4KV8, or W4 for an
    attention-free stack) on the kernel routes and full precision (none
    where ``params`` is None: a model whose float32 tree does not fit the
    card), each a run held to lm_check_run's gates (``limits``: its logit
    limits by label, default LM_TOL and LM_KV8_FORWARD_TOL; ``source``: a
    cross-attention family's stub frames or image rows; ``record``: the
    quantized run's expert-layer record), then LM_TIMING_PASSES more runs
    timed and one decode step profiled. Returns {label: run}."""
    out = {}
    variants = [lm_quantized(mods, cfg) + (qparams, True)]
    if params is not None:
        variants.append(("full", mods["QuantPolicy"](), params, False))
    for label, policy, tree, quantized in variants:
        reset_counts(mods)
        run, toks = lm_check_run(torch, mods, cfg, label, policy, tree, prompt, quantized,
                                 (limits or {}).get(label), tag, source,
                                 record if quantized else None)
        if run["gates_failed"]:
            raise AssertionError("; ".join(run["gates_failed"]))
        # timing: LM_TIMING_PASSES more runs
        passes = []
        for _ in range(LM_TIMING_PASSES):
            _, _, pms, _, pwall, enc = lm_generate(torch, mods, cfg, tree, prompt, policy, source)
            passes.append({"prefill_ms": pms[0], "decode_ms": pms[1:], "wall_s": pwall,
                           "encode_ms": None if enc is None else enc["ms"]})
        steps = sorted(v for p in passes for v in p["decode_ms"])
        if source is not None and cfg.family == "encdec":
            run["encode_ms"] = sorted(p["encode_ms"] for p in passes)[len(passes) // 2]
        run["prefill_ms"] = sorted(p["prefill_ms"] for p in passes)[len(passes) // 2]
        run["decode_ms_median"] = steps[len(steps) // 2]
        run["decode_ms_pass_medians"] = [sorted(p["decode_ms"])[len(p["decode_ms"]) // 2]
                                         for p in passes]
        run["tokens_per_s"] = LM_BATCH * 1e3 / run["decode_ms_median"]
        run["passes"] = passes
        run["profile"] = lm_profile_step(torch, mods, cfg, tree, prompt, policy, source)
        prof = run["profile"]
        print(f"[chip_smoke]   {tag} {label}: prefill {run['prefill_ms']:.2f} ms, decode "
              f"{run['decode_ms_median']:.3f} ms per token (pass medians "
              f"{', '.join(f'{v:.3f}' for v in run['decode_ms_pass_medians'])}), "
              f"{run['tokens_per_s']:.0f} tokens/s at B={LM_BATCH}; one profiled step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']} ms, qmm "
              f"{prof['qmm_device_ms']} ms, {prof.get('device_launches')} device launches",
              flush=True)
        out[label] = run
        del toks
        torch.cuda.empty_cache()
    return out


def phase_lm(torch, mods):
    """starcoder2-3b at full width (30 layers) served on the card: W4KV8 on
    the kernel routes and full precision, gated per step and held against
    the plain routes, against forward, and (two layers) against the CPU."""
    dev = torch.device(mods["device"])
    cfg, params, qparams, prompt, out = lm_setup(torch, mods)
    layer_codes = out["layer_code_bytes"]
    out.update(lm_serve_runs(torch, mods, cfg, params, qparams, prompt))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, params, qparams, layer_codes, flush))
    out.update(lm_kernel_rows(torch, mods, cfg, qparams, flush))
    del params, qparams, flush
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg)
    return out


def hybrid_flash_row(torch, mods, cfg, b, s, dtype, flush, gen):
    """The prefill's windowed attention at B = b, S = s (cfg's heads, D and
    window, causal, query offset 0) through flash_attention: the kernel it
    must launch (FLASH_TC for 16-bit, FLASH for float32), held against the
    plain version (2e-2 and the 2⁻⁷ row rule for 16-bit, 2e-4 for f32),
    timed beside it, beside SDPA with the band as a boolean mask (the
    backend it chose recorded) and the band's bound."""
    dev = torch.device(mods["device"])
    hq, hkv, d, w = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_, cfg.local_window
    q, kk, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
                for h in (hq, hkv, hkv))
    is_f32 = dtype == torch.float32
    kernel = mods["FLASH"] if is_f32 else mods["FLASH_TC"]
    before = kernel.launches
    out = mods["flash_attention"](q, kk, v, causal=True, window=w, q_offset=0)
    if kernel.launches != before + 1:
        raise AssertionError(f"hybrid flash B={b} S={s}: {kernel.entry} was not launched")

    def plain():
        return mods["attention_plain"](q, kk, v, causal=True, scale=d ** -0.5, window=w,
                                       q_offset=0)
    gap = held(torch, f"hybrid prefill B={b} S={s} window {w}", out, plain(),
               2e-4 if is_f32 else 2e-2, not is_f32)
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < w)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=band,
                                                                enable_gqa=True)
    lib = sdpa()
    b_ms, b_by, f32_ms = attention_bound(b, hq, hkv, s, s, d, q.element_size(), True, w, 0)
    row = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": w,
           "dtype": str(dtype).replace("torch.", ""), "kernel": kernel.entry,
           "max_abs_err": gap["max_abs_err"], "max_row_rel": gap["max_row_rel"],
           "ms": time_ms(torch, lambda: mods["flash_attention"](q, kk, v, causal=True, window=w,
                                                               q_offset=0), 10, flush),
           "plain_ms": time_ms(torch, plain, 3, flush),
           "library_ms": time_ms(torch, sdpa, 10, flush),
           "library_backend": sdpa_backend(torch, lib, q, kk, v, attn_mask=band),
           "library_max_abs_diff": float((lib.float() - out.float()).abs().max()),
           "causal_ms": time_ms(torch, lambda: kernel(q, kk, v, True, d ** -0.5), 10, flush),
           "band_pairs": attention_pairs(s, s, True, w, 0), "bound_ms": b_ms, "bound_by": b_by,
           "f32_core_bound_ms": f32_ms}
    print(f"[chip_smoke]   hybrid flash B={b} S={s} {hq}/{hkv} heads D={d} window {w} "
          f"{row['dtype']} ({kernel.entry}): max|Δ|={row['max_abs_err']:.3g} kernel "
          f"{row['ms']:.4f} ms (causal, no window: {row['causal_ms']:.4f})  plain "
          f"{row['plain_ms']:.3f} ms  SDPA with the band as a mask {row['library_ms']:.4f} ms "
          f"({row['library_backend']})  bound {b_ms:.4f} ms ({b_by})", flush=True)
    return row


def hybrid_kernel_rows(torch, mods, cfg, qparams, flush):
    """qmm at M = LM_BATCH on layer 0's RG-LRU products (in_x, in_gate and
    out on bf16 x; the gates' w_r and w_i on float32 x) and attention
    products (wq, wk, wv, wo); the windowed prefill attention at B = 1,
    S = HYBRID_LONG_PROMPT (bf16 and f32) and at B = LM_BATCH, S = LM_PROMPT
    (bf16); the RG-LRU scan of one layer's prefill at both shapes beside its
    bytes bound."""
    dev = torch.device(mods["device"])
    gen = torch.Generator(device=dev).manual_seed(23)
    rec, attn = qparams["slots"]["slot0"]["rec"], qparams["slots"]["slot2"]["attn"]
    rows = [lm_qmm_row(torch, mods, "hybrid", name, rec[name]["w"][0], gen, flush,
                       torch.float32 if name in ("w_r", "w_i") else None)
            for name in ("in_x", "in_gate", "w_r", "w_i", "out")]
    rows += [lm_qmm_row(torch, mods, "hybrid", name, attn[name]["w"][0], gen, flush)
             for name in ("wq", "wk", "wv", "wo")]
    flash_rows = [hybrid_flash_row(torch, mods, cfg, b, s, dtype, flush, gen)
                  for b, s, dtype in ((1, HYBRID_LONG_PROMPT, torch.bfloat16),
                                      (LM_BATCH, LM_PROMPT, torch.bfloat16),
                                      (1, HYBRID_LONG_PROMPT, torch.float32))]
    scan_rows = []
    rec_layers = cfg.n_layers - lm_attention_layers(cfg)
    for b, s in ((LM_BATCH, LM_PROMPT), (1, HYBRID_LONG_PROMPT)):
        a = torch.rand(b, s, cfg.rnn_width_, generator=gen, device=dev)
        x = torch.randn(b, s, cfg.rnn_width_, generator=gen, device=dev)
        ms = time_ms(torch, lambda: mods["rglru"].linear_scan(a, x), 10, flush)
        bound = 3 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        scan_rows.append({"B": b, "S": s, "W": cfg.rnn_width_, "ms": ms, "bound_ms": bound,
                          "bound_by": "bytes", "steps": math.ceil(math.log2(s)),
                          "per_prefill_ms": ms * rec_layers})
        print(f"[chip_smoke]   hybrid RG-LRU scan B={b} S={s} W={cfg.rnn_width_}: {ms:.3f} ms a "
              f"layer ({ms * rec_layers:.2f} ms over the prefill's {rec_layers} layers), bound "
              f"{bound:.4f} ms (bytes: a, b and h once)", flush=True)
        del a, x
    return {"qmm_rows": rows, "flash_rows": flash_rows, "scan_rows": scan_rows}


def phase_hybrid(torch, mods):
    """recurrentgemma-2b at full width (26 layers) served on the card: run A,
    W4KV8 on the kernel routes and full precision at B = 8 × 1,024, gated
    per step as phase lm gates starcoder2-3b (the RG-LRU's five products and
    the MLP's three on qmm each decode step, FLASH_TC once per attention
    layer in the prefill, with the 2,048-key window); run B, W4KV8 on one
    prompt of 4,096 tokens, where the window bites (8 windowed FLASH_TC
    launches in the prefill, the cache's 2,048 slots shifting each step);
    both held against the plain routes, forward and the float32 truth; the
    first period in float32 against the CPU at a cut window."""
    t_phase = time.perf_counter()
    dev = torch.device(mods["device"])
    cfg, params, qparams, prompt, out = lm_setup(torch, mods, HYBRID_ARCH, "hybrid")
    limits = {"w4kv8": {"vs_plain_max_rel": HYBRID_TOL,
                        "vs_forward_max_rel": HYBRID_KV8_FORWARD_TOL},
              "full": {"vs_plain_max_rel": HYBRID_TOL, "vs_forward_max_rel": HYBRID_TOL}}
    out.update(lm_serve_runs(torch, mods, cfg, params, qparams, prompt, limits, "hybrid"))
    # run B: one long prompt, the window bites
    w4kv8 = mods["QuantPolicy"](weight_bits=4, kv_bits=8)
    long_prompt = mods["prng"].randint(mods["prng"].PRNGKey(3), (1, HYBRID_LONG_PROMPT), 0,
                                       cfg.vocab_size, device=dev)
    cache = mods["lm_model"].init_cache(cfg, 1, HYBRID_LONG_PROMPT + LM_DECODE_STEPS + 8, w4kv8,
                                        device=dev)
    slots = cache["slots"]["slot2"].k.shape[3]
    if slots != cfg.local_window:
        raise AssertionError(f"hybrid: the attention cache holds {slots} slots, not the window")
    del cache
    reset_counts(mods)
    run, toks = lm_check_run(torch, mods, cfg, "w4kv8 long", w4kv8, qparams, long_prompt, True,
                             limits["w4kv8"], "hybrid")
    windowed = str((1, cfg.padded_heads, cfg.padded_kv_heads, HYBRID_LONG_PROMPT,
                    HYBRID_LONG_PROMPT, cfg.head_dim_, 0, cfg.local_window))
    run["windowed_flash_tc"] = run["flash_tc_launches_by_shape"].get(windowed, 0)
    if run["windowed_flash_tc"] != lm_attention_layers(cfg):
        run["gates_failed"].append(f"hybrid w4kv8 long: {run['windowed_flash_tc']} windowed "
                                   f"FLASH_TC launches {windowed} in the prefill, expected "
                                   f"{lm_attention_layers(cfg)}")
    if run["gates_failed"]:
        raise AssertionError("; ".join(run["gates_failed"]))
    print(f"[chip_smoke]   hybrid w4kv8 long: prefill of {HYBRID_LONG_PROMPT} tokens "
          f"{run['first_prefill_ms']:.2f} ms, decode {run['first_decode_ms_median']:.3f} ms per "
          f"token (one pass), {run['windowed_flash_tc']} windowed FLASH_TC launches", flush=True)
    out["long"] = run
    del toks
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, params, qparams, out["layer_code_bytes"], flush,
                              "hybrid"))
    out.update(hybrid_kernel_rows(torch, mods, cfg, qparams, flush))
    del params, qparams, flush
    torch.cuda.empty_cache()
    reset_counts(mods)
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg, "hybrid", n_layers=3,
                                        prompt_len=HYBRID_CPU_PROMPT,
                                        local_window=HYBRID_CPU_WINDOW)
    out["card_vs_cpu"]["flash_f32_launches"] = mods["FLASH"].launches
    if not mods["FLASH"].launches:
        raise AssertionError("hybrid card vs CPU: the f32 windowed FLASH was not launched")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   hybrid phase {out['seconds']:.1f} s", flush=True)
    return out


def ssd_flops(cfg, b, s) -> int:
    """Operations of the chunked SSD at (b, s), s a multiple of the chunk,
    two per multiply-add: the scores C·Bᵀ and their product with x within
    each chunk, the chunk-final states and the inter-chunk term."""
    h, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    ck = min(cfg.ssm_chunk, s)
    return 2 * b * (s // ck) * (ck * ck * ds + ck * ck * h * hd + 2 * ck * h * hd * ds)


def ssm_kernel_rows(torch, mods, cfg, qparams, flush):
    """qmm at M = LM_BATCH on layer 0's in_proj and out_proj (bf16 x); the
    chunked SSD of one layer's prefill (plain PyTorch: ``ssm.ssd_chunked`` on
    bf16 x, B, C and Δ, as the path hands it) at (LM_BATCH, LM_PROMPT) and
    (1, SSM_LONG_PROMPT), with the chunk loop alone (``chunk_recurrence``),
    beside its bound: the larger of its operations at the f32 CUDA-core peak
    and its bytes (x, B, C and Δ read, y and the final state written)."""
    dev = torch.device(mods["device"])
    gen = torch.Generator(device=dev).manual_seed(24)
    ssm, slot = mods["ssm"], qparams["slots"]["slot0"]["ssm"]
    rows = [lm_qmm_row(torch, mods, "ssm", name, slot[name]["w"][0], gen, flush)
            for name in ("in_proj", "out_proj")]
    p = {k: v[0] for k, v in slot.items() if isinstance(v, torch.Tensor)}
    h, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    ssd_rows = []
    for b, s in ((LM_BATCH, LM_PROMPT), (1, SSM_LONG_PROMPT)):
        xr = torch.randn(b, s, cfg.d_inner, generator=gen, device=dev).to(torch.bfloat16)
        bb, cc = (torch.randn(b, s, ds, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        dt = torch.randn(b, s, h, generator=gen, device=dev).to(torch.bfloat16)
        y, final = ssm.ssd_chunked(p, xr, bb, cc, dt, cfg)
        if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(final).all())):
            raise AssertionError(f"ssm SSD B={b} S={s}: non-finite output")
        ms = time_ms(torch, lambda: ssm.ssd_chunked(p, xr, bb, cc, dt, cfg), 5, flush)
        nc = s // cfg.ssm_chunk
        states = torch.randn(b, nc, h, hd, ds, generator=gen, device=dev)
        decay = torch.rand(b, nc, h, generator=gen, device=dev)
        loop_ms = time_ms(torch, lambda: ssm.chunk_recurrence(states, decay), 5, flush)
        flops = ssd_flops(cfg, b, s)
        moved = (xr.numel() + bb.numel() + cc.numel() + dt.numel()) * 2 + (y.numel()
                                                                          + final.numel()) * 4
        ops_ms, bytes_ms = flops / F32_FLOP_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
        row = {"B": b, "S": s, "chunks": nc, "ms": ms, "chunk_loop_ms": loop_ms,
               "chunk_loop_share": loop_ms / ms, "per_prefill_ms": ms * cfg.n_layers,
               "flops": flops, "bytes": moved, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        ssd_rows.append(row)
        print(f"[chip_smoke]   ssm SSD B={b} S={s} ({nc} chunks): {ms:.3f} ms a layer "
              f"({row['per_prefill_ms']:.1f} ms over the prefill's {cfg.n_layers} layers), the "
              f"chunk loop {loop_ms:.3f} ms of it ({row['chunk_loop_share']:.0%}); bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.2f} GFLOP at the f32 "
              f"peak, {moved / 1e6:.1f} MB)", flush=True)
        del xr, bb, cc, dt, y, final, states, decay
    return {"qmm_rows": rows, "ssd_rows": ssd_rows}


def phase_ssm(torch, mods):
    """mamba2-370m at full width (48 attention-free SSD layers) served on
    the card: run A, W4 on the kernel routes and full precision at B = 8 ×
    1,024, gated per step as phase lm gates starcoder2-3b (in_proj and
    out_proj on qmm each W4 decode step, 96; no FLASH_TC anywhere); run B,
    W4 on one prompt of 16,384 tokens (256 chunks chain), its decode beside
    a B = 1 decode after 1,024 tokens; both held against the plain routes,
    forward and the float32 truth; two layers in float32 against the CPU."""
    t_phase = time.perf_counter()
    dev = torch.device(mods["device"])
    cfg, params, qparams, prompt, out = lm_setup(torch, mods, SSM_ARCH, "ssm")
    label, w4 = lm_quantized(mods, cfg)
    limits = {name: {"vs_plain_max_rel": SSM_TOL, "vs_forward_max_rel": SSM_TOL}
              for name in (label, "full")}
    out.update(lm_serve_runs(torch, mods, cfg, params, qparams, prompt, limits, "ssm"))
    # run B: one long prompt, 256 chunks chain in the prefill
    long_prompt = mods["prng"].randint(mods["prng"].PRNGKey(3), (1, SSM_LONG_PROMPT), 0,
                                       cfg.vocab_size, device=dev)
    reset_counts(mods)
    run, toks = lm_check_run(torch, mods, cfg, f"{label} long", w4, qparams, long_prompt, True,
                             limits[label], "ssm")
    if run["gates_failed"]:
        raise AssertionError("; ".join(run["gates_failed"]))
    del toks
    # the same decode at B = 1 after LM_PROMPT tokens: the state does not grow
    _, _, ms, _, _, _ = lm_generate(torch, mods, cfg, qparams, prompt[:1], w4)
    run["short_b1_decode_ms_median"] = sorted(ms[1:])[(len(ms) - 1) // 2]
    print(f"[chip_smoke]   ssm {label} long: prefill of {SSM_LONG_PROMPT} tokens "
          f"{run['first_prefill_ms']:.2f} ms, decode {run['first_decode_ms_median']:.3f} ms per "
          f"token (one pass); B = 1 after {LM_PROMPT} tokens "
          f"{run['short_b1_decode_ms_median']:.3f} ms per token", flush=True)
    out["long"] = run
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, params, qparams, out["layer_code_bytes"], flush,
                              "ssm"))
    out.update(ssm_kernel_rows(torch, mods, cfg, qparams, flush))
    del params, qparams, flush
    torch.cuda.empty_cache()
    reset_counts(mods)
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg, "ssm", prompt_len=SSM_CPU_PROMPT)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   ssm phase {out['seconds']:.1f} s", flush=True)
    return out


def xattn_flash_row(torch, mods, tag, shape, flush, gen, causal=False, kv_f32=False):
    """An attention call of a cross-attention family's path at its own
    ``shape`` (B, Hq, Hkv, Sq, Sk, D) through the model's route
    (``chunked_attention``; q bf16, K/V bf16, or float32 with ``kv_f32``,
    which the route casts to bf16, counted in ATTENTION_KV_CAST): the kernel
    it must launch (FLASH_TC), held against the plain version on the same
    bf16 inputs (2e-2 and the 2⁻⁷ row rule), timed (the kernel alone, and
    the route with its cast) beside the plain version, SDPA on the bf16
    inputs (non-causal, or causal; its backend recorded) and the bound. With
    float32 K/V also the route's distance from the plain version in float32
    on the float32 K/V (the reference's and the CPU's arithmetic), and the
    cast's own share of it."""
    dev = torch.device(mods["device"])
    b, hq, hkv, sq, sk, d = shape
    layers, plain = mods["lm_layers"], mods["attention_plain"]
    q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(torch.bfloat16)
    kf, vf = (torch.randn(b, hkv, sk, d, generator=gen, device=dev) for _ in range(2))
    k16, v16 = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    kk, v = (kf, vf) if kv_f32 else (k16, v16)
    FLASH_TC, cast = mods["FLASH_TC"], mods["ATTENTION_KV_CAST"]
    before = (FLASH_TC.launches, cast.launches)
    out = layers.chunked_attention(q, kk, v, causal=causal)
    if (FLASH_TC.launches, cast.launches) != (before[0] + 1, before[1] + int(kv_f32)):
        raise AssertionError(f"{tag} flash {shape}: FLASH_TC and the cast ran "
                             f"{FLASH_TC.launches - before[0]} and {cast.launches - before[1]} "
                             f"times, expected 1 and {int(kv_f32)}")
    scale = d ** -0.5
    label = f"{tag} {'causal' if causal else 'non-causal'} {sq}x{sk}"
    gap = held(torch, label, out, plain(q, k16, v16, causal=causal, scale=scale), 2e-2, True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, k16, v16, is_causal=causal,
                                                                enable_gqa=True)
    lib = sdpa()
    b_ms, b_by, f32_ms = attention_bound(b, hq, hkv, sq, sk, d, 2, causal)
    row = {"B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d, "causal": causal,
           "kv_dtype": "float32" if kv_f32 else "bfloat16", "kernel": FLASH_TC.entry,
           "max_abs_err": gap["max_abs_err"], "max_row_rel": gap["max_row_rel"],
           "ms": time_ms(torch, lambda: FLASH_TC(q, k16, v16, causal, scale), 10, flush),
           "route_ms": time_ms(torch, lambda: layers.chunked_attention(q, kk, v, causal=causal),
                               10, flush),
           "plain_ms": time_ms(torch, lambda: plain(q, k16, v16, causal=causal, scale=scale), 3,
                               flush),
           "library_ms": time_ms(torch, sdpa, 10, flush),
           "library_backend": sdpa_backend(torch, lib, q, k16, v16, causal=causal),
           "library_max_abs_diff": float((lib.float() - out.float()).abs().max()),
           "pairs": attention_pairs(sq, sk, causal, off=0 if causal else None),
           "bound_ms": b_ms, "bound_by": b_by, "f32_core_bound_ms": f32_ms}
    if kv_f32:
        ref32 = plain(q.float(), kf, vf, causal=causal, scale=scale)
        row["vs_f32_kv"] = attention_gap(torch, out, ref32, 2e-2)
        row["cast_alone"] = attention_gap(torch, plain(q.float(), k16.float(), v16.float(),
                                                       causal=causal, scale=scale), ref32, 2e-2)
    print(f"[chip_smoke]   {label} B={b} {hq}/{hkv} heads D={d} bf16"
          f"{' (K/V float32, cast)' if kv_f32 else ''}: max|Δ|={row['max_abs_err']:.3g} kernel "
          f"{row['ms']:.4f} ms (route {row['route_ms']:.4f})  plain {row['plain_ms']:.3f} ms  "
          f"SDPA {row['library_ms']:.4f} ms ({row['library_backend']})  bound {b_ms:.4f} ms "
          f"({b_by})" + (f"; against float32 on the float32 K/V: max row ‖Δ‖/‖ref‖ "
                          f"{row['vs_f32_kv']['max_row_rel']:.4g} (the cast alone "
                          f"{row['cast_alone']['max_row_rel']:.4g})" if kv_f32 else ""),
          flush=True)
    del q, kf, vf, k16, v16, kk, v, out, lib
    return row


def xattn_qmm_rows(torch, mods, tag, qparams, names, gen, flush):
    """qmm at M = LM_BATCH on layer 0's codes of each (slot, block, name)."""
    rows = []
    for slot, block, name in names:
        qw = qparams["slots"][slot][block][name]["w"][0]
        rows.append(lm_qmm_row(torch, mods, tag, f"{block}.{name}", qw, gen, flush))
    return rows


def encdec_fault(torch, mods, cfg, qparams, prompt, source, limits):
    """The W4KV8 run with a fault planted in the kernel route: the prefill's
    cross-attention over whisper's memory drops its ragged last key tile
    (keys ENCDEC_FAULT_KEYS to encoder_seq − 1; the kernels, the plain
    routes' witness and forward's and the truth's kernel calls alike). Its
    gates must fail; returns the run's readings and failed gates."""
    layers = mods["lm_layers"]
    kernel = layers.attention_kernel

    def faulty(q, k, v, causal, window=None, q_offset=0):
        if not causal and q.shape[2] != k.shape[2] and k.shape[2] == cfg.encoder_seq:
            k, v = k[:, :, :ENCDEC_FAULT_KEYS], v[:, :, :ENCDEC_FAULT_KEYS]
        return kernel(q, k, v, causal, window, q_offset)
    label, policy = lm_quantized(mods, cfg)
    reset_counts(mods)
    with stand_in(layers, attention_kernel=faulty):
        run, toks = lm_check_run(torch, mods, cfg, f"{label} fault", policy, qparams, prompt,
                                 True, limits, "encdec", source)
    del toks
    if not run["gates_failed"]:
        raise AssertionError(f"encdec: the cross-attention dropping keys {ENCDEC_FAULT_KEYS}"
                             f"-{cfg.encoder_seq - 1} passed every gate")
    print(f"[chip_smoke]   encdec planted fault (keys {ENCDEC_FAULT_KEYS}-{cfg.encoder_seq - 1} "
          f"dropped): {len(run['gates_failed'])} gates failed, as they must: "
          f"{'; '.join(run['gates_failed'])[:400]}", flush=True)
    return {k: run[k] for k in ("vs_plain_max_rel", "vs_forward_max_rel", "truth", "witness",
                                "gates_failed")}


def phase_encdec(torch, mods):
    """whisper-tiny at full width (4 encoder and 4 decoder layers, d = 384)
    served on the card: 8 × 1,500 stub frames through ``encode`` (4
    non-causal FLASH_TC at S = 1,500), prompts of 224 tokens, 32 decode
    steps, W4KV8 on the kernel routes and full precision, gated per step as
    phase lm gates starcoder2-3b (8 FLASH_TC a prefill: 4 causal, 4 cross
    224 × 1,500; 32 qmm a decode step), each non-causal call held against
    the plain version, the logits against the plain routes, forward and the
    float32 serving path; a planted fault (the cross-attention dropping the
    ragged last key tile) must fail the gates; the whole model in float32
    against the CPU."""
    t_phase = time.perf_counter()
    dev = torch.device(mods["device"])
    cfg, params, qparams, prompt, out = lm_setup(torch, mods, ENCDEC_ARCH, "encdec")
    source = lm_stub_source(torch, mods, cfg, LM_BATCH)
    limits = {"w4kv8": {"vs_plain_max_rel": ENCDEC_TOL,
                        "vs_forward_max_rel": ENCDEC_TOL + ENCDEC_ROPE_GAP + ENCDEC_KV8_SHIFT},
              "full": {"vs_plain_max_rel": ENCDEC_TOL,
                       "vs_forward_max_rel": ENCDEC_TOL + ENCDEC_ROPE_GAP}}
    out.update(lm_serve_runs(torch, mods, cfg, params, qparams, prompt, limits, "encdec", source))
    out["fault"] = encdec_fault(torch, mods, cfg, qparams, prompt, source, limits["w4kv8"])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, params, qparams, out["layer_code_bytes"], flush,
                              "encdec"))
    gen = torch.Generator(device=dev).manual_seed(25)
    out["qmm_rows"] = xattn_qmm_rows(torch, mods, "encdec", qparams, (
        ("slot0", "attn", "wq"), ("slot0", "xattn", "wq"), ("slot0", "ffn", "wi"),
        ("slot0", "ffn", "wo")), gen, flush)
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    t, s = cfg.encoder_seq, lm_prompt_len(cfg)
    out["flash_rows"] = [
        xattn_flash_row(torch, mods, "encdec encode", (LM_BATCH, hq, hkv, t, t, d), flush, gen),
        xattn_flash_row(torch, mods, "encdec cross", (LM_BATCH, hq, hkv, s, t, d), flush, gen)]
    del params, qparams, flush, source
    torch.cuda.empty_cache()
    reset_counts(mods)
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg, "encdec", n_layers=cfg.n_layers)
    out["card_vs_cpu"]["flash_f32_launches_by_shape"] = {
        str(k): c for k, c in mods["FLASH"].launches_by_shape.items()}
    if not mods["FLASH"].launches:
        raise AssertionError("encdec card vs CPU: the f32 FLASH was not launched")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   encdec phase {out['seconds']:.1f} s", flush=True)
    return out


def vlm_prefill_parts(torch, mods, cfg, qparams, source, flush):
    """The W4 prefill's memory projections (wk and wv of one cross-attention
    layer over the 8 × 1,600 float32 image rows: materialize + matmul, as
    the reference computes them) timed, and both per prefill (× the
    cross-attention layers)."""
    layers = mods["lm_layers"]
    slot = next(f"slot{j}" for j, kind in enumerate(cfg.pattern_for_layers()[:cfg.cross_attn_every])
                if kind == "xattn")
    xattn = qparams["slots"][slot]["xattn"]
    wk, wv = xattn["wk"]["w"][0], xattn["wv"]["w"][0]
    ms = time_ms(torch, lambda: (layers.dense({"w": wk}, source), layers.dense({"w": wv}, source)),
                 3, flush)
    n = lm_cross_layers(cfg)
    print(f"[chip_smoke]   vlm memory projections (wk, wv over {tuple(source.shape)} float32, "
          f"materialize + matmul): {ms:.3f} ms a layer, {ms * n:.2f} ms a prefill", flush=True)
    return {"memory_projection_ms": ms, "memory_projection_per_prefill_ms": ms * n}


def phase_vlm(torch, mods):
    """llama-3.2-vision-11b at full width (40 layers, 8 of them
    cross-attention image layers) served on the card: 8 × 1,600 float32
    image rows, prompts of 1,024 tokens, 32 decode steps, W4KV8 on the
    kernel routes and full precision, gated per step as phase lm gates
    starcoder2-3b (48 FLASH_TC a prefill: 40 causal, 8 cross 1,024 × 1,600
    on K/V cast from float32, 8 casts; 296 qmm a decode step), each
    cross-attention call held against the plain version, the logits against
    the plain routes, forward and the float32 truth; two layers (xattn,
    attn) in float32 against the CPU."""
    t_phase = time.perf_counter()
    dev = torch.device(mods["device"])
    cfg, params, qparams, prompt, out = lm_setup(torch, mods, VLM_ARCH, "vlm")
    source = lm_stub_source(torch, mods, cfg, LM_BATCH)
    limits = {"w4kv8": {"vs_plain_max_rel": 2 * VLM_KV8_FLOOR,
                        "vs_forward_max_rel": VLM_KV8_FLOOR + VLM_BF16_FLOOR},
              "full": {"vs_plain_max_rel": 2 * VLM_BF16_FLOOR,
                       "vs_forward_max_rel": 2 * VLM_BF16_FLOOR}}
    out.update(lm_serve_runs(torch, mods, cfg, params, qparams, prompt, limits, "vlm", source))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, params, qparams, out["layer_code_bytes"], flush,
                              "vlm"))
    out.update(vlm_prefill_parts(torch, mods, cfg, qparams, source, flush))
    del params, source
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(26)
    out["qmm_rows"] = xattn_qmm_rows(torch, mods, "vlm", qparams, (
        ("slot0", "attn", "wq"), ("slot0", "attn", "wk"), ("slot0", "ffn", "wi_gate"),
        ("slot0", "ffn", "wo"), ("slot3", "xattn", "wq")), gen, flush)
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    out["flash_rows"] = [
        xattn_flash_row(torch, mods, "vlm cross", (LM_BATCH, hq, hkv, LM_PROMPT,
                                                   cfg.n_image_tokens, d), flush, gen,
                        kv_f32=True),
        xattn_flash_row(torch, mods, "vlm self", (LM_BATCH, hq, hkv, LM_PROMPT, LM_PROMPT, d),
                        flush, gen, causal=True)]
    cross = out["flash_rows"][0]
    out["cross_attention_per_prefill_ms"] = cross["route_ms"] * lm_cross_layers(cfg)
    del qparams, flush
    torch.cuda.empty_cache()
    reset_counts(mods)
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg, "vlm", n_layers=2,
                                        decode_steps=VLM_CPU_DECODE_STEPS,
                                        cross_attn_every=VLM_CPU_EVERY)
    out["card_vs_cpu"]["flash_f32_launches_by_shape"] = {
        str(k): c for k, c in mods["FLASH"].launches_by_shape.items()}
    if not mods["FLASH"].launches:
        raise AssertionError("vlm card vs CPU: the f32 FLASH was not launched")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   vlm phase {out['seconds']:.1f} s", flush=True)
    return out


def moe_setup(torch, mods, arch=MOE_ARCH, tag="moe"):
    """``arch``'s config and its W4 tree (nearest codes), built leaf by leaf
    from PRNGKey(0) on the card (init_quantized_params: one layer's float32
    leaves at a time), with the set-up's readings (the seconds in
    quantize_params and outside it, W4 param_bytes, the float32 tree's size,
    peak memory), and LM_BATCH prompts of LM_PROMPT tokens from PRNGKey(1).
    Every layer's three expert stacks must take the batched kernel (3-D,
    contiguous, on a 16-byte boundary; both capacities at most QMM_MAX_ROWS)
    and every attention product route to QMM."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(mods["device"])
    prng, m, QWeight = mods["prng"], mods["lm_model"], mods["QWeight"]
    cfg = mods["lm_get_config"](arch)
    caps = {"decode": moe_groups(cfg, LM_BATCH)[1],
            "prefill": moe_groups(cfg, LM_BATCH * LM_PROMPT)[1]}
    out = {"config": cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "decode_steps": LM_DECODE_STEPS, "capacity": caps,
           "reduced": "no full-precision run: the float32 tree does not fit one card"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["allocated_before_bytes"] = torch.cuda.memory_allocated()
    spent = [0.0]
    real = m.quantize_params

    def timed(tree, bits):
        torch.cuda.synchronize()
        t = time.perf_counter()
        q = real(tree, bits)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return q
    t0 = time.perf_counter()
    with stand_in(m, quantize_params=timed):
        qparams = m.init_quantized_params(cfg, prng.PRNGKey(0), 4, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["quantize_s"], out["init_s"] = spent[0], out["build_s"] - spent[0]
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["param_bytes"] = {"w4": mods["param_bytes"](qparams)}
    leaves = mods["tree_leaves"](qparams)
    out["f32_param_bytes"] = 4 * sum(
        (math.prod(w.packed.shape[:-1]) * w.k_dim) if isinstance(w, QWeight) else w.numel()
        for w in leaves)
    if max(caps.values()) > mods["lm_layers"].QMM_MAX_ROWS:
        raise AssertionError(f"{tag}: capacities {caps} exceed QMM_MAX_ROWS")
    slot = qparams["slots"]["slot0"]
    for name in ("wi_gate", "wi_up", "wo"):
        stack = slot["ffn"][name]
        for i in range(cfg.n_layers):
            w = stack[i]
            if not (isinstance(w, QWeight) and w.packed.ndim == 3 and w.packed.is_contiguous()
                    and mods["tc_aligned"](w.packed)
                    and mods["experts_shape_ok"](w.packed, w.k_dim)):
                raise AssertionError(f"{tag}: layer {i}'s {name} does not take QMM_EXPERTS")
    for name in ("wq", "wk", "wv", "wo"):
        for i in range(cfg.n_layers):
            if mods["cuda_kernel"](slot["attn"][name]["w"][i].packed_weights()) is not mods["QMM"]:
                raise AssertionError(f"{tag}: layer {i}'s attention {name} does not route to QMM")
    codes = [w for w in mods["tree_leaves"](qparams["slots"]) if isinstance(w, QWeight)]
    out["layer_code_bytes"] = sum(w.packed.numel() for w in codes)
    out["expert_code_bytes"] = sum(slot["ffn"][n].packed.numel() for n in ("wi_gate", "wi_up",
                                                                          "wo"))
    print(f"[chip_smoke]   {tag} {cfg.name}: built W4 leaf by leaf in {out['build_s']:.1f} s "
          f"(quantize {out['quantize_s']:.1f} s, init {out['init_s']:.1f} s); param bytes "
          f"{out['param_bytes']['w4']:,} (W4; float32 {out['f32_param_bytes']:,}), layer codes "
          f"{out['layer_code_bytes']:,} (experts {out['expert_code_bytes']:,}); peak "
          f"max_memory_allocated {out['peak_memory_bytes']:,} bytes (allocated before "
          f"{out['allocated_before_bytes']:,}); capacities {caps}; {out['reduced']}", flush=True)
    prompt = prng.randint(prng.PRNGKey(1), (LM_BATCH, LM_PROMPT), 0, cfg.vocab_size, device=dev)
    return cfg, qparams, prompt, out


def moe_layer(qparams, i=0):
    """Layer i's expert layer: its router and its three expert stacks."""
    ffn = qparams["slots"]["slot0"]["ffn"]
    return {"router": {"w": ffn["router"]["w"][i]},
            **{n: ffn[n][i] for n in ("wi_gate", "wi_up", "wo")}}


def moe_reference_group(torch, mods, cfg, xg, router_w, cap, ye):
    """The reference's _group_moe (src/repro/models/moe.py:36-59) transcribed
    literally, its one-hot tensors and einsums, over MOE_DISPATCH_CHUNK
    experts at a time: the router in float32, top-k of a stable descending
    sort, the gate renormalized with the 1e-9 floor, slot positions from the
    cumsum of the one-hot picks, and, given the experts' outputs ``ye``, the
    combine in float32 rounded to xg's dtype. Returns (xe, the token in each
    (expert, slot), -1 where none, y)."""
    F = torch.nn.functional
    g, d = xg.shape
    e, k, dtype = cfg.n_experts, cfg.experts_per_token, xg.dtype
    logits = xg.float() @ mods["lm_materialize"](router_w, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = top.values[:, :k], top.indices[:, :k]
    gv = gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(gi, e).to(torch.int32)                        # (g, k, E)
    flat = onehot.reshape(g * k, e)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(g, k, e)
    within = (pos >= 0) & (pos < cap)
    xe = torch.zeros((e, cap, d), dtype=dtype, device=xg.device)
    token = torch.full((e, cap), -1, dtype=torch.int64, device=xg.device)
    y = torch.zeros((g, d), dtype=torch.float32, device=xg.device)
    for e0 in range(0, e, MOE_DISPATCH_CHUNK):
        sl = slice(e0, e0 + MOE_DISPATCH_CHUNK)
        slot = F.one_hot(torch.clamp(pos[:, :, sl], 0, cap - 1).long(), cap).to(dtype)
        keep = within[:, :, sl, None].to(dtype) * onehot[:, :, sl, None].to(dtype)
        disp = torch.sum(slot * keep, dim=1)                          # (g, ec, C)
        comb = torch.sum(slot * keep * gv[:, :, None, None].to(dtype), dim=1)
        xe[sl] = torch.einsum("td,tec->ecd", xg.to(dtype), disp)
        if int(disp.sum(0).max()) > 1:
            raise AssertionError("the reference's dispatch puts two tokens in one slot")
        token[sl] = torch.where(disp.sum(0) > 0, disp.argmax(0), -1)
        y += torch.einsum("ecd,tec->td", ye[sl].float(), comb.float())
        del slot, keep, disp, comb
    return xe, token, y.to(dtype)


def moe_dispatch_check(torch, mods, cfg, qparams, record, flush, tag="moe"):
    """The first prefill group of the kernel run (layer 0, g = 4,096 tokens,
    capacity 320) through the port's dispatch and combine (index gathers)
    and through the reference's one-hot tensors transcribed
    (:func:`moe_reference_group`), on the same experts' outputs: the kept
    set (which token holds each expert's slot) and xe bit for bit, y within
    BF16_ROW_REL per row; and the dispatch's and combine's device ms per
    layer at the prefill (two groups) and at a decode step (one group of
    LM_BATCH, capacity 1)."""
    moe = mods["lm_moe"]
    F = torch.nn.functional
    xg, router_w = record["first"]
    g, d = xg.shape
    e, k, dtype = cfg.n_experts, cfg.experts_per_token, xg.dtype
    groups, cap = moe_groups(cfg, LM_BATCH * LM_PROMPT)
    p = moe_layer(qparams, 0)
    xe, (_, gate_vals, gate_idx, slot, kept, rows) = moe.dispatch(
        xg, router_w, top_k=k, n_experts=e, cap=cap, dtype=dtype)
    h = F.silu(moe.expert_product(xe, p["wi_gate"], dtype, rows)) * moe.expert_product(
        xe, p["wi_up"], dtype, rows)
    ye = moe.expert_product(h, p["wo"], dtype, rows)
    y = moe.combine(ye, slot, kept, gate_vals)
    token = torch.full((e * cap + 1,), -1, dtype=torch.int64, device=xg.device)
    token[slot] = torch.arange(g, device=xg.device).repeat_interleave(k)
    token = torch.where(token[:e * cap] >= 0, token[:e * cap], -1).reshape(e, cap)
    ref_xe, ref_token, ref_y = moe_reference_group(torch, mods, cfg, xg, router_w, cap, ye)
    row = (torch.linalg.vector_norm((y - ref_y).float(), dim=-1)
           / torch.linalg.vector_norm(ref_y.float(), dim=-1).clamp_min(1e-30))
    out = {"g": g, "E": e, "C": cap, "kept": int(kept.sum()), "dropped": int((~kept).sum()),
           "kept_set_bitwise": bool(torch.equal(token, ref_token)),
           "xe_bitwise": bool(torch.equal(xe, ref_xe)), "y_max_row_rel": float(row.max()),
           "y_limit": BF16_ROW_REL}
    fails = [] if out["kept_set_bitwise"] and out["xe_bitwise"] and out["y_max_row_rel"] <= \
        BF16_ROW_REL else [f"{tag} dispatch and combine against the reference's one-hot "
                           f"tensors: {out}"]
    del ref_xe, ref_y, h
    x8 = xg[:LM_BATCH].contiguous()
    dec_cap = moe_groups(cfg, LM_BATCH)[1]
    xe8, r8 = moe.dispatch(x8, router_w, top_k=k, n_experts=e, cap=dec_cap, dtype=dtype)
    ye8 = torch.randn(xe8.shape, device=xg.device).to(dtype)
    timings = {
        "prefill_dispatch_ms": groups * time_ms(torch, lambda: moe.dispatch(
            xg, router_w, top_k=k, n_experts=e, cap=cap, dtype=dtype), 5, flush),
        "prefill_combine_ms": groups * time_ms(torch, lambda: moe.combine(
            ye, slot, kept, gate_vals), 5, flush),
        "decode_dispatch_ms": time_ms(torch, lambda: moe.dispatch(
            x8, router_w, top_k=k, n_experts=e, cap=dec_cap, dtype=dtype), 20, flush),
        "decode_combine_ms": time_ms(torch, lambda: moe.combine(ye8, r8[3], r8[4], r8[1]), 20,
                                     flush)}
    out.update(timings)
    out["gates_failed"] = fails
    print(f"[chip_smoke]   {tag} dispatch and combine of layer 0's first prefill group (g={g}, "
          f"E={e}, C={cap}; {out['dropped']} of {g * k} picks dropped) against the reference's "
          f"one-hot tensors: kept set bitwise {out['kept_set_bitwise']}, xe bitwise "
          f"{out['xe_bitwise']}, y max row ‖Δ‖/‖ref‖ {out['y_max_row_rel']:.3g} (limit "
          f"{BF16_ROW_REL:.3g}); per layer: prefill dispatch {timings['prefill_dispatch_ms']:.3f} "
          f"ms + combine {timings['prefill_combine_ms']:.3f} ms ({groups} groups), decode "
          f"dispatch {timings['decode_dispatch_ms']:.3f} ms + combine "
          f"{timings['decode_combine_ms']:.3f} ms", flush=True)
    return out


def moe_decode_rows(torch, cfg, record):
    """The rows in use of layer 0's expert products in the kernel run's first
    decode step: each expert's kept picks of its LM_BATCH tokens (int32 on
    the card), from the run's recorded picks."""
    n_pre = cfg.n_layers * moe_groups(cfg, LM_BATCH * LM_PROMPT)[0]
    picks = record["picks"][n_pre].reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64, device=picks.device)
    counts.scatter_add_(0, picks, torch.ones_like(picks))
    return counts.clamp(max=moe_groups(cfg, LM_BATCH)[1]).to(torch.int32)


def moe_kernel_rows(torch, mods, cfg, qparams, flush, routed_rows, tag="moe"):
    """QMM_EXPERTS on layer 0's wi_gate (and wi_up's shape) and wo stacks on
    bf16 x, as on the path: at a decode step's C = 1 with the kernel run's
    routed rows (``routed_rows``, layer 0's first decode step) and with
    every row, and at a prefill group's C = 320 with every row. Each row:
    the kernel, its plain version (qmm_batched_ref at the same rows),
    torch.bmm on the stack materialized to bf16 (the library; the
    materialize not timed; x's rows past the rows in use are zero, as
    dispatch leaves them, so it computes the same function) and the bound
    (the codes and scales of the experts with a row in use, x's rows in
    use, f32 y written once; or one bf16 pass over the rows in use at the
    tensor-core peak), held to qmm's rule. Then QMM_BATCHED, the route of
    float32 activations (the truth's), on the same stack at C = 320, for
    the record; and QMM at M = LM_BATCH on layer 0's attention wq
    (lm_qmm_row)."""
    dev = torch.device(mods["device"])
    gen = torch.Generator(device=dev).manual_seed(27)
    kernels = {"QMM_EXPERTS": mods["QMM_EXPERTS"], "QMM_BATCHED": mods["QMM_BATCHED"]}
    ref = mods["qmm_batched_ref"]
    p = moe_layer(qparams, 0)
    c_dec, c_pre = moe_groups(cfg, LM_BATCH)[1], moe_groups(cfg, LM_BATCH * LM_PROMPT)[1]
    rows_out = []
    for name in ("wi_gate", "wo"):
        w = p[name]
        e, n, kp = w.packed.shape
        k, bits = w.k_dim, w.bits
        wb = mods["lm_materialize"](w, torch.bfloat16)
        wabs = mods["unpack_codes"](w.packed, bits, k).float().abs() * (
            w.scale / mods["BY_BITS"][bits].half_steps)
        every = {c: torch.full((e,), c, dtype=torch.int32, device=dev) for c in (c_dec, c_pre)}
        cases = (("QMM_EXPERTS", "routed", c_dec, routed_rows.clamp(max=c_dec)),
                 ("QMM_EXPERTS", "all", c_dec, every[c_dec]),
                 ("QMM_EXPERTS", "all", c_pre, every[c_pre]),
                 ("QMM_BATCHED", "all", c_pre, every[c_pre]))
        for kname, label, c, rows in cases:
            kernel = kernels[kname]
            in_use = torch.arange(c, device=dev) < rows[:, None]
            xt = torch.randn(e, c, k, generator=gen, device=dev).to(torch.bfloat16)
            xt[~in_use] = 0
            x = xt.float()
            xk = xt if kname == "QMM_EXPERTS" else x
            before = {kn: kk.launches for kn, kk in kernels.items()}
            y = mods["qmm_batched"](xk, w.packed, w.scale, bits, k, rows)
            if {kn: kk.launches - before[kn] for kn, kk in kernels.items()} != {
                    kn: int(kn == kname) for kn in kernels}:
                raise AssertionError(f"{tag} qmm_batched {name}: {kname} was not launched alone")
            plain = ref(x, w.packed, w.scale, bits, k, rows)
            err = (y - plain).abs()
            if not bool((err <= 1e-5 * plain.abs() + 1e-5 * torch.matmul(
                    x.abs(), wabs.transpose(-1, -2))).all()):
                raise AssertionError(f"{tag} qmm_batched {name} C={c} rows={label}: max |Δ| "
                                     f"{float(err.max())} exceeds the tolerance")
            used, experts = int(rows.sum()), int((rows > 0).sum())   # read off the path
            nbytes = experts * (n * kp + 4 * n) + 2 * used * k + 4 * e * c * n
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * used * n * k / BF16_FLOP_PER_S
            reps = 20 if c == 1 else 5
            if kname == "QMM_EXPERTS":
                call = lambda: kernel(xt, w.packed, w.scale, bits, k, rows)   # noqa: E731
            else:
                call = lambda: kernel(x, w.packed, w.scale, bits, k)          # noqa: E731
            row = {"kernel": kname, "shape": name, "rows": label, "rows_in_use": used,
                   "experts_in_use": experts, "E": e, "C": c, "N": n, "K": k, "bits": bits,
                   "max_abs_err": float(err.max()),
                   "ms": time_ms(torch, call, reps, flush),
                   "plain_ms": time_ms(torch, lambda: ref(x, w.packed, w.scale, bits, k, rows),
                                       3, flush),
                   "library_ms": time_ms(torch, lambda: torch.bmm(xt, wb), reps, flush),
                   "library": "torch.bmm on the stack materialized to bf16",
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes_bound_ms": t_bytes * 1e3}
            rows_out.append(row)
            print(f"[chip_smoke]   {tag} {kname} {name:7s} E={e} C={c:3d} N={n} K={k} rows "
                  f"{label} ({used} in use, {experts} experts): max|Δ|={row['max_abs_err']:.3g} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.3f} ms  bmm(bf16 stack) "
                  f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            del xt, x, y, plain, err
        del wb, wabs
    wq = qparams["slots"]["slot0"]["attn"]["wq"]["w"][0]
    return {"batched": rows_out,
            "attention": lm_qmm_row(torch, mods, tag, "wq", wq, gen, flush)}


def moe_routed_bound(torch, mods, cfg, qparams, record, bounds, tag="moe"):
    """The decode step's bytes bound with only the routed experts' codes:
    each decode step's layers read the codes and scales of the distinct
    experts their LM_BATCH tokens picked (the kernel run's picks), in place
    of all 128."""
    p = moe_layer(qparams, 0)
    per_expert = sum(p[n].packed[0].numel() + 4 * p[n].scale[0].numel()
                     for n in ("wi_gate", "wi_up", "wo"))
    all_experts = cfg.n_layers * cfg.n_experts * per_expert
    n_pre = cfg.n_layers * moe_groups(cfg, LM_BATCH * LM_PROMPT)[0]
    distinct = [int(torch.unique(picks).numel()) for picks in record["picks"][n_pre:]]
    steps = len(distinct) / cfg.n_layers
    mean = sum(distinct) / len(distinct)
    step_bytes = bounds["w4kv8_step_bytes"] - all_experts + sum(distinct) / steps * per_expert
    out = {"distinct_experts_per_layer_mean": mean, "distinct_experts_per_layer_max": max(distinct),
           "expert_bytes_all": all_experts, "routed_step_bytes": step_bytes,
           "routed_step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"[chip_smoke]   {tag} W4KV8 bytes bound of a decode step with only the routed "
          f"experts' codes: {out['routed_step_bound_ms']:.3f} ms ({step_bytes:,.0f} bytes; "
          f"{mean:.1f} distinct experts a layer on average, at most "
          f"{out['distinct_experts_per_layer_max']}), all 128 experts' codes: "
          f"{bounds['w4kv8_step_bound_ms']:.3f} ms", flush=True)
    return out


def phase_moe(torch, mods):
    """qwen3-moe-30b-a3b at full width (48 layers, 128 experts, top-8) served
    on the card in W4KV8 from a W4 tree built leaf by leaf: 8 prompts of
    1,024 tokens, 32 decode steps, every expert product on QMM_EXPERTS (3 ×
    48 a decode step, 288 a prefill), gated per step as phase lm gates
    starcoder2-3b, with the MoE changes of lm_check_run (the prefill against
    forward over the prompt; the float32 serving path as the truth; every
    batched call of the prefill and the first decode step held against its
    plain version), the first prefill group's dispatch and combine against
    the reference's one-hot tensors, and two float32 layers card vs CPU."""
    t_phase = time.perf_counter()
    dev = torch.device(mods["device"])
    cfg, qparams, prompt, out = moe_setup(torch, mods)
    record = {}
    limits = {"w4kv8": {"vs_plain_max_rel": MOE_TOL, "vs_forward_max_rel": MOE_FORWARD_TOL}}
    out.update(lm_serve_runs(torch, mods, cfg, None, qparams, prompt, limits, "moe",
                             record=record))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out.update(lm_step_bounds(torch, mods, cfg, None, qparams, out["layer_code_bytes"], flush,
                              "moe"))
    out["routed_bound"] = moe_routed_bound(torch, mods, cfg, qparams, record, out)
    out["dispatch"] = moe_dispatch_check(torch, mods, cfg, qparams, record, flush)
    routed_rows = moe_decode_rows(torch, cfg, record)
    del record
    out["qmm_rows"] = moe_kernel_rows(torch, mods, cfg, qparams, flush, routed_rows)
    out["flash_row"] = xattn_flash_row(
        torch, mods, "moe self", (LM_BATCH, cfg.padded_heads, cfg.padded_kv_heads, LM_PROMPT,
                                  LM_PROMPT, cfg.head_dim_), flush,
        torch.Generator(device=dev).manual_seed(28), causal=True)
    del qparams, flush
    torch.cuda.empty_cache()
    if out["dispatch"]["gates_failed"]:
        raise AssertionError("; ".join(out["dispatch"]["gates_failed"]))
    reset_counts(mods)
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, mods, cfg, "moe", decode_steps=1)
    if not mods["QMM_BATCHED"].launches:
        raise AssertionError("moe card vs CPU: QMM_BATCHED was not launched")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   moe phase {out['seconds']:.1f} s", flush=True)
    return out


def moe_faults(torch, mods):
    """Phase moe's W4KV8 run, its gates, its held batched-qmm calls and its
    dispatch check with faults planted: layer MOE_FAULT_LAYER's expert
    MOE_FAULT_EXPERT multiplying by the next expert's codes inside the
    kernel's route (``wrong_expert_codes``), and the gate weights left
    unrenormalized (``unrenormalized_gates``). Passes when the real path
    meets every gate and each fault fails one; which ones is the reading
    (a fault that only a held check catches is recorded as such)."""
    dev = torch.device(mods["device"])
    cfg, qparams, prompt, _ = moe_setup(torch, mods)
    policy = mods["QuantPolicy"](weight_bits=4, kv_bits=8)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    limits = {"vs_plain_max_rel": MOE_TOL, "vs_forward_max_rel": MOE_FORWARD_TOL}
    results = {}

    def check(name):
        reset_counts(mods)
        record = {}
        try:
            run, _ = lm_check_run(torch, mods, cfg, name, policy, qparams, prompt, True, limits,
                                  "moe", record=record)
            disp = moe_dispatch_check(torch, mods, cfg, qparams, record, flush)
            fails = run["gates_failed"] + disp["gates_failed"]
            results[name] = {k: run[k] for k in ("vs_plain_max_rel", "vs_forward_max_rel",
                                                 "truth", "held_qmm_batched", "picks_differ")}
            results[name]["dispatch"] = {k: disp[k] for k in ("kept_set_bitwise", "xe_bitwise",
                                                              "y_max_row_rel")}
        except Exception as e:  # noqa: BLE001 -- a fault that stops the run is caught
            traceback.print_exc()
            fails, results[name] = [f"raised {type(e).__name__}: {e}"], {}
        results[name]["gates_failed"] = fails
        results[name]["caught_by"] = sorted({
            "held batched qmm calls" if "held batched" in f else
            "dispatch check" if "dispatch and combine" in f else
            "launch counts" if " ran " in f else "logit gates" for f in fails})
        torch.cuda.empty_cache()

    check("kernel")
    ffn = qparams["slots"]["slot0"]["ffn"]
    targets = {ffn[n][MOE_FAULT_LAYER].packed.data_ptr() for n in ("wi_gate", "wi_up", "wo")}
    real = mods["qmm_ops"].QMM_EXPERTS

    def wrong_codes(x, w_packed, scale, bits, k_dim, rows):
        if w_packed.data_ptr() in targets:
            w_packed = w_packed.clone()
            w_packed[MOE_FAULT_EXPERT] = w_packed[MOE_FAULT_EXPERT + 1]
        return real(x, w_packed, scale, bits, k_dim, rows)
    with stand_in(mods["qmm_ops"], QMM_EXPERTS=wrong_codes):
        check("wrong_expert_codes")
    moe = mods["lm_moe"]

    def unrenormalized(xg, router_w, top_k):
        probs = torch.softmax(xg.float() @ moe.materialize(router_w, torch.float32), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        return probs, top.values[:, :top_k], top.indices[:, :top_k]
    with stand_in(moe, route=unrenormalized):
        check("unrenormalized_gates")
    for name, r in results.items():
        print(f"[chip_smoke]   moe fault {name:22s}: {len(r['gates_failed'])} gates failed, "
              f"caught by {r['caught_by']}"
              + (f" ({r['gates_failed'][0][:300]})" if r["gates_failed"] else ""), flush=True)
    missed = [n for n in ("wrong_expert_codes", "unrenormalized_gates")
              if not results[n]["gates_failed"]]
    if results["kernel"]["gates_failed"] or missed:
        raise AssertionError(f"moe faults: the real path failed a gate: "
                             f"{results['kernel']['gates_failed']}; faults nothing caught: "
                             f"{missed}")
    return {"layer": MOE_FAULT_LAYER, "expert": MOE_FAULT_EXPERT, "results": results}


def flash_mutant_libraries(mods, tmp):
    """A library for each fault of FLASH_MUTANTS: a copy of flashattn_wgmma.cu
    in ``tmp`` with the fault planted, built beside the copy (not yet built)."""
    FLASH_TC, CudaLibrary = mods["FLASH_TC"], mods["CudaLibrary"]

    class CopyLibrary(CudaLibrary):
        def library_path(self):
            return self.source.with_suffix(".so")

    source = FLASH_TC.library.source.read_text()
    libraries = {}
    for name, (_, edits) in FLASH_MUTANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"mutant {name}: {old!r} is not in flashattn_wgmma.cu once")
            text = text.replace(old, new)
        path = Path(tmp) / f"flashattn_wgmma_{name}.cu"
        path.write_text(text)
        libraries[name] = CopyLibrary(path, FLASH_TC.library.entries)
    return libraries


def lm_faults(torch, mods):
    """Phase lm's W4KV8 run and its gates (lm_check_run) with faults planted:
    every qmm product of layer LM_FAULT_LAYER read with its scales times each
    factor of LM_SCALE_FAULTS (the real kernel on wrong scales), and each
    fault of FLASH_MUTANTS built into a copy of flashattn_wgmma.cu that
    FLASH_TC launches in place of the real one. Passes when the real kernels
    meet every gate and the first scale fault and the LM_FLASH_FAULTS fail
    one; the other faults are readings."""
    import tempfile

    cfg, params, qparams, prompt, _ = lm_setup(torch, mods)
    del params
    torch.cuda.empty_cache()
    policy = mods["QuantPolicy"](weight_bits=4, kv_bits=8)
    layers, QWeight, FLASH_TC = mods["lm_layers"], mods["QWeight"], mods["FLASH_TC"]
    results = {}

    def check(name):
        reset_counts(mods)
        try:
            run, _ = lm_check_run(torch, mods, cfg, name, policy, qparams, prompt, True)
        except Exception as e:  # noqa: BLE001 -- a fault that stops the run is caught
            traceback.print_exc()
            run = {"gates_failed": [f"raised {type(e).__name__}: {e}"]}
        results[name] = {k: run[k] for k in ("vs_plain_max_rel", "vs_forward_max_rel", "truth",
                                             "limits", "finite", "gates_failed") if k in run}
        torch.cuda.empty_cache()

    check("kernel")
    targets = {w[LM_FAULT_LAYER].packed.data_ptr()
               for w in mods["tree_leaves"](qparams["slots"]["slot0"])
               if isinstance(w, QWeight)}
    real = layers.qweight_product
    for factor in LM_SCALE_FAULTS:
        def faulty(x, w, factor=factor):
            if w.packed.data_ptr() in targets:
                w = QWeight(w.packed, w.scale * factor, w.bits, w.k_dim)
            return real(x, w)
        with stand_in(layers, qweight_product=faulty):
            check(f"qmm_scale_x{factor}")
    real_library = FLASH_TC.library
    with tempfile.TemporaryDirectory() as tmp:
        libraries = flash_mutant_libraries(mods, tmp)
        phase_build(list(libraries.values()))
        for name, library in libraries.items():
            FLASH_TC.library = library
            try:
                check(f"flash_{name}")
            finally:
                FLASH_TC.library = real_library
    required = [f"qmm_scale_x{LM_SCALE_FAULTS[0]}"] + [f"flash_{n}" for n in LM_FLASH_FAULTS]
    missed = [name for name in required if not results[name]["gates_failed"]]
    for name, r in results.items():
        print(f"[chip_smoke]   lm fault {name:22s}: {len(r['gates_failed'])} gates failed"
              + (f" ({r['gates_failed'][0]})" if r["gates_failed"] else ""), flush=True)
    if results["kernel"]["gates_failed"] or missed:
        raise AssertionError(f"lm faults: the real kernels failed a gate: "
                             f"{results['kernel']['gates_failed']}; faults no gate caught: "
                             f"{missed}")
    return {"layer": LM_FAULT_LAYER, "scale_factors": LM_SCALE_FAULTS,
            "flash_mutants": {n: what for n, (what, _) in FLASH_MUTANTS.items()},
            "results": results}


TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024  # the serving slice's prompt shape
TRAIN_STEPS = 3                # the step time is the median of the steps after the first
TRAIN_LR = 3e-3                # launch/train.py's default, cosine with a 20-step warm-up
TRAIN_SPARSITY, TRAIN_GRAD_BITS = 0.5, 8    # examples/train_lm_sparse.py's defaults
TRAIN_NBINS = 4096             # optim/iht.py's bins
# The attention Function (kernel forward, plain backward) against autograd
# through the all-plain forward, per gradient: ‖Δ‖₂ ≤ 2⁻⁶·‖ref‖₂. Both round
# each gradient to bf16 (2⁻⁹ relative) and start from forward outputs within
# one bf16 ulp of each other (phase 12's 2⁻⁷ per row), which reaches the
# gradients through δ = Σ dout·out: two ulps of slack on those.
TRAIN_ATTN_REL = 2.0 ** -6
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 128
TRAIN_CPU_STEPS = 3            # whole steps of the resume model, card against CPU
# two float32 layers at full width, card against the port's CPU: the loss
# relative, each gradient leaf's max|Δ| over its max|g| (the lm phase's
# card-vs-CPU bound on logits; the sums over d = 3,072 and 12,288 run in
# other orders)
TRAIN_CPU_TOL = 1e-4
# the resume check's model: starcoder2-3b's block at 2 layers, d = 512,
# 8 (padded 16) heads of 64 on 2, d_ff 2,048, vocab 4,096
TRAIN_RESUME = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=2048,
                    vocab_size=4096)
TRAIN_RESUME_BATCH, TRAIN_RESUME_SEQ = 4, 256
TRAIN_RESUME_STEPS, TRAIN_RESUME_EVERY, TRAIN_RESUME_KILL = 12, 4, 6
# plain versions the training path must not run on the card, by (module key in mods, name)
TRAIN_PLAIN = (("lm_layers", "chunked_attention_plain"), ("hs_ops", "hsthresh_ref"),
               ("collectives", "sqround_ref"))
# leaves whose dense input to the first step's projection is kept (on the
# host) and held, after the run, kernel against plain on the card
TRAIN_HS_LEAVES = {"embed": "['embed']['w']", "wi": "['slots']['slot0']['ffn']['wi']['w']"}
# The recurrent families trained at full width on train_4k's rows
# (configs/shapes.py: 4,096 tokens; there recurrentgemma-2b's 2,048-key
# window covers half of each late row). train_4k's global batch of 256 is
# cut to 4 rows (recurrentgemma-2b) and 8 (mamba2-370m) for the phases'
# time. recurrentgemma-2b's params, gradients and AdamW's m and v are
# 4 × 14.2 GB, and one row's float32 logits 4.19 GB (vocab 256,000), their
# log-softmax and its gradient about three times that: one row a
# microbatch. mamba2-370m's 1.68 GB of parameters and 6.6 GB of float32
# logits at 8 rows fit in one.
TRAIN_4K_SEQ = TRAIN_4K_LEN
TRAIN_HYBRID_ARCH, TRAIN_SSM_ARCH = "recurrentgemma-2b", "mamba2-370m"
TRAIN_HYBRID_BATCH, TRAIN_HYBRID_ACCUM = 4, 4
TRAIN_SSM_BATCH, TRAIN_SSM_ACCUM = 8, 1
TRAIN_RECURRENT_STEPS = 3
# card against CPU: 3 float32 layers of recurrentgemma-2b (one (rec, rec,
# attn) period, so that its attention layer is in) with the window cut to
# 64 keys, so that it bites at TRAIN_CPU_SEQ; 2 of mamba2-370m
TRAIN_HYBRID_CPU_LAYERS, TRAIN_HYBRID_CPU_WINDOW, TRAIN_SSM_CPU_LAYERS = 3, 64, 2
# the resume models: a (rec, rec, attn) period of recurrentgemma-2b's block
# at d = 512, 2 heads of 256 on 1, the window 128 (it bites at
# TRAIN_RESUME_SEQ); two mamba2-370m blocks at d = 512 (16 SSD heads of 64,
# state 128, chunk 64); vocab 4,096
TRAIN_HYBRID_RESUME = dict(n_layers=3, d_model=512, n_heads=2, n_kv_heads=1, head_dim=256,
                           d_ff=1536, rnn_width=512, local_window=128, vocab_size=4096)
TRAIN_SSM_RESUME = dict(n_layers=2, d_model=512, vocab_size=4096)
# the windowed attention's gradient checks at recurrentgemma-2b's heads:
# (label, Sq, Sk, query offset), B = 1, window 2,048, bf16
TRAIN_HYBRID_ATTN_CASES = (("window", TRAIN_4K_LEN, TRAIN_4K_LEN, 0),
                           ("window+offset", TRAIN_4K_LEN // 2, TRAIN_4K_LEN, TRAIN_4K_LEN // 2))
# leaves held kernel against plain after the run: the embedding and the
# largest MLP (hybrid) or SSD (ssm) leaf
TRAIN_HYBRID_HS_LEAVES = {"embed": "['embed']['w']",
                          "wi": "['slots']['slot0']['ffn']['wi_gate']['w']"}
TRAIN_SSM_HS_LEAVES = {"embed": "['embed']['w']",
                       "wi": "['slots']['slot0']['ssm']['in_proj']['w']"}


def train_spec(arch):
    """The shape of each training phase's run: rows, row length, microbatches,
    steps, the attention check's cases, the leaves held after the run, and
    the card-vs-CPU and resume models."""
    if arch == TRAIN_HYBRID_ARCH:
        return dict(tag="train_hybrid", batch=TRAIN_HYBRID_BATCH, seq=TRAIN_4K_SEQ,
                    accum=TRAIN_HYBRID_ACCUM, steps=TRAIN_RECURRENT_STEPS,
                    attn_cases=TRAIN_HYBRID_ATTN_CASES, hs_leaves=TRAIN_HYBRID_HS_LEAVES,
                    cpu_layers=TRAIN_HYBRID_CPU_LAYERS,
                    cpu_replace=dict(local_window=TRAIN_HYBRID_CPU_WINDOW),
                    resume=TRAIN_HYBRID_RESUME)
    if arch == TRAIN_SSM_ARCH:
        return dict(tag="train_ssm", batch=TRAIN_SSM_BATCH, seq=TRAIN_4K_SEQ,
                    accum=TRAIN_SSM_ACCUM, steps=TRAIN_RECURRENT_STEPS, attn_cases=(),
                    hs_leaves=TRAIN_SSM_HS_LEAVES, cpu_layers=TRAIN_SSM_CPU_LAYERS,
                    cpu_replace={}, resume=TRAIN_SSM_RESUME)
    return dict(tag="train", batch=TRAIN_BATCH, seq=TRAIN_SEQ, accum=1, steps=TRAIN_STEPS,
                attn_cases=(("causal", TRAIN_SEQ, TRAIN_SEQ, 0),), hs_leaves=TRAIN_HS_LEAVES,
                cpu_layers=TRAIN_CPU_LAYERS, cpu_replace={}, resume=TRAIN_RESUME)


def train_flops(mods, cfg, params, b, s):
    """Operations a training step must do with per-layer remat, as (at the
    bf16 tensor-core peak, at the f32 CUDA-core peak, the attention
    backward's): the layers' products 4× (forward, recompute, two in the
    backward), the unembedding 3×, per attention layer 4·D flops a visible
    (query, key) pair a product (the causal triangle, or the window's band):
    QKᵀ and PV twice (forward and recompute) and the backward's five (S, dP,
    dV, dQ, dK). The RG-LRU's gates (float32 x on float32 weights, TF32 off)
    and the chunked SSD (``ssd_flops``, float32) count at the f32 peak, 4×
    (forward, recompute, a backward of twice the forward)."""
    f32_names = ("w_r", "w_i")
    bf16_w = f32_w = 0
    for path, leaf in mods["tree_flatten_with_path"]({"slots": params["slots"],
                                                       "tail": params["tail"]}):
        if mods["last_key"](path) != "w":
            continue
        if any(f"['{n}']" in mods["keystr"](path) for n in f32_names):
            f32_w += leaf.numel()
        else:
            bf16_w += leaf.numel()
    unembed = params["unembed"]["w"].numel() if "unembed" in params else 0
    pairs = attention_pairs(s, s, True, mods["lm_model"]._window(cfg), 0)
    per_product = 2 * b * cfg.padded_heads * cfg.head_dim_ * pairs * lm_attention_layers(cfg)
    attn_bwd = 5 * per_product
    n_ssm = sum(kind == "ssm" for kind in cfg.pattern_for_layers())
    bf16 = 2 * b * s * (4 * bf16_w + 3 * unembed) + 4 * per_product + attn_bwd
    f32 = 2 * b * s * 4 * f32_w + (4 * n_ssm * ssd_flops(cfg, b, s) if n_ssm else 0)
    return bf16, f32, attn_bwd


def train_attention_check(torch, mods, cfg, spec):
    """The attention Function at one layer's heads, per case of
    ``spec["attn_cases"]`` (B = the run's microbatch, bf16, causal, cfg's
    window, Sq ≠ Sk with a query offset) against autograd through the
    all-plain forward on the card: dq, dk, dv within TRAIN_ATTN_REL in
    2-norm. One FLASH_TC launch and one backward-route call a case; the
    plain backward timed beside the kernel forward."""
    dev = torch.device(mods["device"])
    layers = mods["lm_layers"]
    gen = torch.Generator(device=dev).manual_seed(22)
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    window = mods["lm_model"]._window(cfg)
    b = spec["batch"] // spec["accum"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for label, sq, sk, off in spec["attn_cases"]:
        shapes = ((hq, sq), (hkv, sk), (hkv, sk))
        base = [torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
                for h, s in shapes]
        dout = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(causal=True, chunk=cfg.attn_chunk, window=window, q_offset=off)
        grads = {}
        for route in ("kernel", "plain"):
            q, k, v = (t.clone().requires_grad_(True) for t in base)
            before = (mods["FLASH_TC"].launches, mods["ATTENTION_BACKWARD"].launches)
            fn = layers.chunked_attention if route == "kernel" else layers.chunked_attention_plain
            fn(q, k, v, **kw).backward(dout)
            after = (mods["FLASH_TC"].launches, mods["ATTENTION_BACKWARD"].launches)
            want = (1, 1) if route == "kernel" else (0, 0)
            if (after[0] - before[0], after[1] - before[1]) != want:
                raise AssertionError(f"train attention {label} {route}: launches (FLASH_TC, "
                                     f"backward) {(after[0] - before[0], after[1] - before[1])}, "
                                     f"want {want}")
            grads[route] = (q.grad, k.grad, v.grad)
            del q, k, v
        row = {"B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d, "window": window,
               "q_offset": off}
        for name, x, y in zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"]):
            rel = float((x.float() - y.float()).norm() / y.float().norm())
            row[name] = {"rel": rel, "max_abs_err": float((x.float() - y.float()).abs().max()),
                         "finite": bool(torch.isfinite(x).all())}
            if not (rel <= TRAIN_ATTN_REL and row[name]["finite"]):
                raise AssertionError(f"train attention {label} {name}: ‖Δ‖/‖ref‖ {rel} > "
                                     f"{TRAIN_ATTN_REL}")
        del grads
        q, k, v = base
        o = layers.attention_kernel(q, k, v, True, window, off)
        row["forward_ms"] = time_ms(torch, lambda: layers.attention_kernel(q, k, v, True, window,
                                                                           off), 5, flush)
        row["backward_ms"] = time_ms(torch, lambda: layers.attention_backward_plain(
            q, k, v, o, dout, **kw), 3, flush)
        print(f"[chip_smoke]   {spec['tag']} attention Function vs all-plain autograd ({label}: "
              f"B={b} Sq={sq} Sk={sk} {hq}/{hkv} heads D={d} window {window} q_offset {off} "
              f"bf16): " + ", ".join(f"{n} ‖Δ‖/‖ref‖ {row[n]['rel']:.3g}"
                                     for n in ("dq", "dk", "dv"))
              + f" (limit {TRAIN_ATTN_REL:.4g}); forward (FLASH_TC) {row['forward_ms']:.3f} ms, "
              f"the plain backward {row['backward_ms']:.2f} ms", flush=True)
        out[label] = row
        del base, dout, o
    return out


def train_card_vs_cpu(torch, mods, cfg, spec):
    """``spec["cpu_layers"]`` layers of cfg at full width in float32 (with
    ``spec["cpu_replace"]``), the same weights (drawn on the card, copied)
    and tokens: loss_fn and every gradient on the card and on the port's
    CPU, within TRAIN_CPU_TOL; then whole steps of the resume model."""
    dev = torch.device(mods["device"])
    n_layers = spec["cpu_layers"]
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32", **spec["cpu_replace"])
    params = mods["lm_model"].init_params(cfg2, mods["prng"].PRNGKey(0), device=dev)
    batch = mods["SyntheticStream"](0, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, cfg2.vocab_size,
                                    device=dev).at_step(0)
    out = {}
    runs = {}
    for where, tree, b in (("card", params, batch),
                           ("cpu", mods["lm_tree_to"](params, "cpu"),
                            {k: v.cpu() for k, v in batch.items()})):
        leaves = mods["tree_leaves"](tree)
        for p in leaves:
            p.requires_grad_(True)
        t0 = time.perf_counter()
        loss = mods["loss_fn"](cfg2, tree, b)
        loss.backward()
        if where == "card":
            torch.cuda.synchronize()
        out[f"{where}_s"] = time.perf_counter() - t0
        runs[where] = (float(loss.detach()), [p.grad.cpu() for p in leaves])
        del tree, leaves, loss
    names = [mods["keystr"](path) for path, _ in mods["tree_flatten_with_path"](params)]
    del params
    loss_rel = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    rels = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(runs["card"][1], runs["cpu"][1])]
    worst = max(rels)
    worst_leaf = names[rels.index(worst)]
    out.update(loss_card=runs["card"][0], loss_cpu=runs["cpu"][0], loss_rel=loss_rel,
               grad_worst_rel=worst, grad_worst_leaf=worst_leaf, layers=n_layers,
               replace=spec["cpu_replace"])
    print(f"[chip_smoke]   {spec['tag']} card vs CPU, {n_layers} layers float32 B="
          f"{TRAIN_CPU_BATCH} S={TRAIN_CPU_SEQ}"
          + "".join(f" {k}={v}" for k, v in spec["cpu_replace"].items())
          + f": loss {runs['card'][0]:.6f} / {runs['cpu'][0]:.6f} (rel {loss_rel:.3g}), worst "
          f"gradient leaf max|Δ|/max|g| {worst:.3g} ({worst_leaf}; limit {TRAIN_CPU_TOL}; CPU "
          f"{out['cpu_s']:.1f} s)", flush=True)
    if not (loss_rel <= TRAIN_CPU_TOL and worst <= TRAIN_CPU_TOL):
        raise AssertionError(f"{spec['tag']} card vs CPU: loss rel {loss_rel}, gradients {worst} "
                             f"({worst_leaf}) > {TRAIN_CPU_TOL}")
    out["steps"] = train_steps_card_vs_cpu(torch, mods, cfg, spec)
    return out


def train_steps_card_vs_cpu(torch, mods, cfg, spec):
    """TRAIN_CPU_STEPS whole training steps (Q8 gradients, AdamW, IHT) of the
    spec's resume model in float32 on the card and on the port's CPU from
    the same state: the loss at each step within TRAIN_CPU_TOL relative and
    the sparsity the same. A Q8 code whose uniform sits on its rounding edge
    can flip between the devices, so the weights are held by the loss."""
    dev = torch.device(mods["device"])
    rcfg = dataclasses.replace(cfg, name=f"{cfg.name}-resume", dtype="float32", **spec["resume"])
    cfg_iht = mods["IHTConfig"](sparsity=TRAIN_SPARSITY)
    opt = mods["adamw"](mods["cosine_schedule"](TRAIN_LR, warmup=2, total=TRAIN_CPU_STEPS))
    step = mods["make_train_step"](rcfg, opt, policy=mods["QuantPolicy"](grad_bits=TRAIN_GRAD_BITS),
                                   iht=cfg_iht)
    card = mods["init_state"](rcfg, opt, mods["prng"].PRNGKey(0), device=dev)
    cpu = mods["tree_map"](lambda t: t.cpu(), card)
    runs = {}
    for where, state in (("card", card), ("cpu", cpu)):
        stream = mods["SyntheticStream"](2, TRAIN_RESUME_BATCH, TRAIN_RESUME_SEQ, rcfg.vocab_size,
                                         device=dev if where == "card" else "cpu")
        losses = []
        for i in range(TRAIN_CPU_STEPS):
            state, m = step(state, stream.at_step(i))
            losses.append(float(m["loss"]))
        runs[where] = (losses, mods["sparsity_report"](state.params, cfg_iht))
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["card"][0], runs["cpu"][0])]
    print(f"[chip_smoke]   {spec['tag']} {TRAIN_CPU_STEPS} steps card vs CPU ({rcfg.name}, "
          f"float32, Q{TRAIN_GRAD_BITS}, IHT): losses {runs['card'][0]} / {runs['cpu'][0]}, max "
          f"rel {max(rel):.3g} (limit {TRAIN_CPU_TOL}); sparsity {runs['card'][1]} / "
          f"{runs['cpu'][1]}", flush=True)
    if not (max(rel) <= TRAIN_CPU_TOL and runs["card"][1] == runs["cpu"][1]):
        raise AssertionError(f"{spec['tag']} steps card vs CPU: {runs}")
    return {"card": runs["card"], "cpu": runs["cpu"], "max_rel": max(rel)}


def train_resume_check(torch, mods, cfg, spec):
    """A run of the spec's resume model on the card, killed after
    TRAIN_RESUME_KILL steps (checkpoints every TRAIN_RESUME_EVERY) and
    restarted through run_with_restarts, must end with the bits of an
    uninterrupted run (Q8 gradients and the projection on, as the full
    run)."""
    import tempfile

    dev = torch.device(mods["device"])
    rcfg = dataclasses.replace(cfg, name=f"{cfg.name}-resume", **spec["resume"])
    opt = mods["adamw"](TRAIN_LR)
    step = mods["make_train_step"](rcfg, opt, policy=mods["QuantPolicy"](grad_bits=TRAIN_GRAD_BITS),
                                   iht=mods["IHTConfig"](sparsity=TRAIN_SPARSITY))
    stream = mods["SyntheticStream"](1, TRAIN_RESUME_BATCH, TRAIN_RESUME_SEQ, rcfg.vocab_size,
                                     device=dev)
    LoopConfig, train_loop = mods["LoopConfig"], mods["train_loop"]

    def fresh():
        return mods["init_state"](rcfg, opt, mods["prng"].PRNGKey(0), device=dev)

    def loop_cfg(total, d):
        return LoopConfig(total_steps=total, ckpt_dir=str(d), ckpt_every=TRAIN_RESUME_EVERY,
                          ckpt_async=False, log_every=1000)

    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        want = train_loop(step, fresh(), stream, loop_cfg(TRAIN_RESUME_STEPS, tmp / "whole"),
                          log=lambda s: None)

        def body(attempt):
            if attempt == 0:
                train_loop(step, fresh(), stream, loop_cfg(TRAIN_RESUME_KILL, tmp / "killed"),
                           log=lambda s: None)
                raise RuntimeError("injected failure after the checkpoint")
            return train_loop(step, fresh(), stream, loop_cfg(TRAIN_RESUME_STEPS, tmp / "killed"),
                              log=logs.append)

        got = mods["run_with_restarts"](body, max_restarts=1)
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "whole").rglob("*") if f.is_file())
        seconds = time.perf_counter() - t0
    leaves_w, leaves_g = mods["tree_leaves"](want), mods["tree_leaves"](got)
    same = len(leaves_w) == len(leaves_g) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(leaves_w, leaves_g))
    last_ckpt = TRAIN_RESUME_KILL // TRAIN_RESUME_EVERY * TRAIN_RESUME_EVERY
    expect_log = [f"[loop] resumed from checkpoint step {last_ckpt}"]
    n_params = sum(p.numel() for p in mods["tree_leaves"](want.params))
    print(f"[chip_smoke]   {spec['tag']} resume ({rcfg.name}: {n_params:,} params, B="
          f"{TRAIN_RESUME_BATCH} S={TRAIN_RESUME_SEQ}, {TRAIN_RESUME_STEPS} steps, checkpoints "
          f"every {TRAIN_RESUME_EVERY}, killed after {TRAIN_RESUME_KILL}; {ckpt_bytes:,} bytes "
          f"of checkpoints kept): bit for bit {same}, {logs} ({seconds:.1f} s)", flush=True)
    if not same or logs != expect_log or int(got.step) != TRAIN_RESUME_STEPS:
        raise AssertionError(f"{spec['tag']} resume: bitwise {same}, log {logs}, step "
                             f"{int(got.step)}")
    return {"bitwise": same, "params": n_params, "checkpoint_bytes": ckpt_bytes,
            "seconds": seconds, "log": logs}


def _timed(torch, record, name, fn):
    """fn with its wall (synchronized at both ends) appended to record[name]."""
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        record[name].append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def train_projection_gate(torch, mods, params, cfg_iht, project, dense, hs_leaves):
    """project(params) with every eligible leaf held: exactly keep nonzeros,
    the kept entries the leaf's own values, and the smallest kept |w| no
    smaller than the largest dropped |w| less one histogram bin (ties in
    the threshold bin are kept by index). The leaves of ``hs_leaves`` go
    into ``dense`` on the host as (the dense input, the path's kept mask).
    Each leaf's dense copy is kept only while it is checked, so that the
    gate adds one leaf's bytes to the step's peak. Returns the per-leaf
    readings."""
    iht = mods["iht"]
    before = {}
    for path, leaf in mods["tree_flatten_with_path"](params):
        if iht.eligible(path, leaf, cfg_iht):
            before[mods["keystr"](path)] = (path, leaf.to("cpu", copy=True))
    project(params)
    current = {mods["keystr"](path): leaf for path, leaf in
               mods["tree_flatten_with_path"](params)}
    rows = []
    for name, (path, host) in before.items():
        leaf = current[name]
        old = host.to(leaf.device)
        keep = iht.keep_count(leaf, cfg_iht)
        kept = leaf != 0
        n_kept = int(kept.sum())
        same = torch.equal(torch.where(kept, old, torch.zeros_like(old)), leaf)
        mag = old.abs()
        binw = float(mag.max()) / TRAIN_NBINS
        kept_min = float(torch.where(kept, mag, torch.full_like(mag, float("inf"))).min())
        dropped_max = float(torch.where(kept, torch.zeros_like(mag), mag).max())
        rows.append({"leaf": name, "N": leaf.numel(), "keep": keep, "kept": n_kept,
                     "values_kept": same, "kept_min": kept_min, "dropped_max": dropped_max,
                     "bin": binw})
        if name in hs_leaves.values():
            dense[name] = (host, kept.cpu())
        del kept, mag, old, host
        if n_kept != keep or not same or kept_min < dropped_max - binw:
            raise AssertionError(f"train projection {name}: kept {n_kept} of keep {keep}, "
                                 f"values kept {same}, kept min {kept_min} vs dropped max "
                                 f"{dropped_max} (bin {binw})")
    return rows


def train_sqround_check(torch, mods, captured, bits):
    """The kernel's codes on the captured chunk of the largest gradient leaf
    against the plain version's (bit for bit), and the path's compressed
    chunk against those codes dequantized (bit for bit)."""
    v, words, scale, after = captured
    got = mods["SQROUND"](v, words, scale, bits)
    want = mods["sqround_ref"](v, words, scale, bits)
    kk = torch.tensor(float(mods["BY_BITS"][bits].half_steps), device=v.device)
    out = {"N": v.numel(), "codes_bitwise": bool(torch.equal(got, want)),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "path_bitwise": bool(torch.equal(after, (got.float() * scale / kk).view(-1)))}
    if not (out["codes_bitwise"] and out["path_bitwise"]):
        raise AssertionError(f"train sqround on a chunk of the largest gradient leaf: {out}")
    return out


def train_run(torch, mods, cfg, spec):
    """The full-width run: init_state, then train_loop over make_train_step
    (Q8 gradients, IHT at TRAIN_SPARSITY, ``spec["accum"]`` microbatches)
    for ``spec["steps"]`` steps of ``spec["batch"]`` rows of
    ``spec["seq"]`` tokens, timed and split, gated on the loss, the
    launches (FLASH_TC with cfg's window twice per attention layer a
    microbatch, the backward route once), the plain versions' calls and
    (first step) the projection and one chunk of the compression. Returns
    (state, readings, the path's inputs: the first step's dense leaves of
    ``spec["hs_leaves"]`` before its projection and its captured sqround
    chunk)."""
    dev = torch.device(mods["device"])
    tag, b, s, n_steps, accum = (spec["tag"], spec["batch"], spec["seq"], spec["steps"],
                                 spec["accum"])
    steps_mod, prng = mods["train_steps"], mods["prng"]
    cfg_iht = mods["IHTConfig"](sparsity=TRAIN_SPARSITY)
    opt = mods["adamw"](mods["cosine_schedule"](TRAIN_LR, warmup=20, total=n_steps))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = mods["init_state"](cfg, opt, prng.PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = mods["SyntheticStream"](0, b, s, cfg.vocab_size, device=dev)
    on_cpu = mods["SyntheticStream"](0, b, s, cfg.vocab_size, device="cpu")
    if not all(torch.equal(stream.at_step(i)["tokens"].cpu(), on_cpu.at_step(i)["tokens"])
               for i in range(n_steps)):
        raise AssertionError(f"{tag}: the card's tokens differ from the CPU's")
    n_eligible = sum(mods["iht"].eligible(path, leaf, cfg_iht)
                     for path, leaf in mods["tree_flatten_with_path"](state.params))
    chunk = mods["collectives"].CHUNK
    sq_chunks = sum(-(-leaf.numel() // chunk) for leaf in mods["tree_leaves"](state.params))
    record = collections.defaultdict(list)
    checks, captured, dense, count = {}, [], {}, {"step": 0}
    real_compress, real_project = steps_mod.fake_grad_compression, steps_mod.maybe_project

    def compress(grads, bits, key):
        if count["step"] > 0:
            return _timed(torch, record, "compression_ms", real_compress)(grads, bits, key)
        leaves = mods["tree_leaves"](grads)          # step 1: keep one chunk of the largest leaf
        i = max(range(len(leaves)), key=lambda j: leaves[j].numel())
        flat = leaves[i].view(-1)
        scale = torch.clamp_min(torch.linalg.vector_norm(flat, float("inf"),
                                                         dtype=torch.float32), 1e-30)
        words = prng._bits_flat(prng.fold_in(key, i), 0, chunk, dev) & ~0x1FF
        v = flat[:chunk].clone().view(1, -1)
        out = real_compress(grads, bits, key)
        captured.append((v, words.view(1, -1), scale, flat[:chunk].clone()))
        return out

    def project(params, step, cfg_):
        if count["step"] > 0:
            return _timed(torch, record, "projection_ms", real_project)(params, step, cfg_)
        checks["projection"] = train_projection_gate(
            torch, mods, params, cfg_, lambda p: real_project(p, step, cfg_), dense,
            spec["hs_leaves"])
        return params

    timed_opt = mods["Optimizer"](opt.init, _timed(torch, record, "adamw_ms", opt.update))
    losses = []

    def launch_counts():
        counts = {k.entry: k.launches for k in mods["KERNELS"]}
        counts["attention_backward"] = mods["ATTENTION_BACKWARD"].launches
        return counts

    def stepped(state, batch):
        if count["step"] == 1:      # the peak of the steps without the first one's checks
            record["first_step_peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        before = launch_counts()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        record["step_ms"].append((time.perf_counter() - t) * 1e3)
        record["launches_by_step"].append({k: n - before[k] for k, n in launch_counts().items()
                                           if n != before[k]})
        losses.append(float(metrics["loss"]))
        count["step"] += 1
        return state, metrics

    calls = collections.Counter()
    plain = collections.defaultdict(dict)
    for m, n in TRAIN_PLAIN:
        def counted(*a, _fn=getattr(mods[m], n), _key=f"{m}.{n}", **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        plain[m][n] = counted
    with contextlib.ExitStack() as stack:
        stack.enter_context(stand_in(steps_mod, fake_grad_compression=compress,
                                     maybe_project=project))
        for m, fns in plain.items():
            stack.enter_context(stand_in(mods[m], **fns))
        step = mods["make_train_step"](cfg, timed_opt,
                                       policy=mods["QuantPolicy"](grad_bits=TRAIN_GRAD_BITS),
                                       iht=cfg_iht, accum_steps=accum)
        reset_counts(mods)
        mods["ATTENTION_BACKWARD"].reset_counts()
        t_run = time.perf_counter()
        state = mods["train_loop"](stepped, state, stream,
                                   mods["LoopConfig"](total_steps=n_steps, log_every=1),
                                   log=lambda m: print(f"[chip_smoke]   {tag} {m}", flush=True))
        run_s = time.perf_counter() - t_run
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_attn, window = lm_attention_layers(cfg), mods["lm_model"]._window(cfg)
    per_step = {"repro_flash_attention_tc": 2 * n_attn * accum,
                "attention_backward": n_attn * accum,
                "repro_hsthresh": n_eligible,
                "repro_sqround": sq_chunks}
    per_step = {k: v for k, v in per_step.items() if v}
    failed = [f"step {i + 1} launched {got}, want {per_step}"
              for i, got in enumerate(record["launches_by_step"]) if got != per_step]
    if len(record["launches_by_step"]) != n_steps:
        failed.append(f"{len(record['launches_by_step'])} steps run, want {n_steps}")
    shape = (b // accum, cfg.padded_heads, cfg.padded_kv_heads, s, s, cfg.head_dim_, 0,
             window or 0)
    by_shape = mods["FLASH_TC"].launches_by_shape
    if sum(by_shape.values()) != by_shape.get(shape, 0):
        failed.append(f"FLASH_TC launched at {dict(by_shape)}, want only {shape}")
    failed += [f"the plain {k} ran {v} times" for k, v in calls.items() if v]
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"losses {losses} not all finite")
    if ("projection" not in checks or not captured
            or len(dense) != len(spec["hs_leaves"])):
        failed.append("the first step's projection or compression was not checked")
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    checks["sqround"] = train_sqround_check(torch, mods, captured[0], TRAIN_GRAD_BITS)

    def median(xs):
        return sorted(xs)[len(xs) // 2]
    # steps 2.. (the first carries the checks); the projection's record starts at step 2
    later = list(zip(record["step_ms"][1:], record["compression_ms"], record["adamw_ms"][1:],
                     record["projection_ms"]))
    split = {"step_ms": median([x for x, _, _, _ in later]),
             "forward_backward_ms": median([x - c - a - p for x, c, a, p in later]),
             "compression_ms": median([c for _, c, _, _ in later]),
             "adamw_ms": median([a for _, _, a, _ in later]),
             "projection_ms": median([p for _, _, _, p in later])}
    bf16_flops, f32_flops, attn_bwd = train_flops(mods, cfg, state.params, b, s)
    bound_ms = (bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S) * 1e3
    out = {"config": cfg.name, "batch": b, "seq": s, "accum_steps": accum, "steps": n_steps,
           "init_s": init_s, "run_s": run_s, "losses": losses, "record": dict(record),
           "split": split, "tokens_per_s": b * s * 1e3 / split["step_ms"],
           "step_flops": bf16_flops + f32_flops, "step_f32_flops": f32_flops,
           "attention_backward_flops": attn_bwd, "step_bound_ms": bound_ms, "peak_bytes": peak,
           "first_step_peak_bytes": record["first_step_peak_bytes"][0], "launches": launches,
           "launches_per_step": per_step, "flash_tc_shape": str(shape),
           "plain_calls": dict(calls), "eligible_leaves": n_eligible,
           "sqround_chunks_per_step": sq_chunks, "checks": checks}
    print(f"[chip_smoke]   {tag} {cfg.name} B={b} S={s} ({accum} microbatch"
          f"{'es' if accum > 1 else ''}), Q{TRAIN_GRAD_BITS} gradients, IHT "
          f"{TRAIN_SPARSITY:.0%}: init {init_s:.1f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step {split['step_ms']:.1f} ms (median of "
          f"steps 2..{n_steps}; all {', '.join(f'{x:.1f}' for x in record['step_ms'])}), "
          f"{out['tokens_per_s']:.0f} tokens/s; FLOP bound {bound_ms:.1f} ms "
          f"({bf16_flops:.4g} flops at the bf16 peak, {attn_bwd:.3g} of them the attention "
          f"backward's; {f32_flops:.3g} at the f32 peak)", flush=True)
    print(f"[chip_smoke]   {tag} split of a step (medians of steps 2..{n_steps}): forward + "
          f"backward {split['forward_backward_ms']:.1f} ms, compression "
          f"{split['compression_ms']:.1f} ms, AdamW {split['adamw_ms']:.1f} ms, projection "
          f"{split['projection_ms']:.1f} ms; peak max_memory_allocated {peak:,} bytes over "
          f"steps 2..{n_steps} ({record['first_step_peak_bytes'][0]:,} with init_state and "
          f"the first step's checks)", flush=True)
    print(f"[chip_smoke]   {tag} launches in each step: FLASH_TC "
          f"{per_step.get('repro_flash_attention_tc', 0)} (window {window}), the attention "
          f"backward route {per_step.get('attention_backward', 0)}, "
          f"HSTHRESH {n_eligible} (eligible leaves), SQROUND {sq_chunks} (chunks of {chunk:,}); "
          f"plain versions run: none", flush=True)
    for row in checks["projection"]:
        if row["leaf"] in spec["hs_leaves"].values():
            print(f"[chip_smoke]   {tag} projection {row['leaf']}: N={row['N']:,}, kept "
                  f"{row['kept']:,} = keep, kept min {row['kept_min']:.4g} >= dropped max "
                  f"{row['dropped_max']:.4g} - bin {row['bin']:.3g}", flush=True)
    print(f"[chip_smoke]   {tag} projection: all {len(checks['projection'])} eligible leaves kept "
          f"exactly keep; sqround on {checks['sqround']['N']:,} entries of the largest gradient "
          f"leaf: codes bitwise the plain version's, the path's values bitwise them dequantized",
          flush=True)
    return state, out, {"hs": dense, "sqround": captured[0],
                        "sqround_err": checks["sqround"]["max_abs_err"]}


def train_kernel_rows(torch, mods, cfg, inputs, spec):
    """The training kernels on the path's own inputs, after the run: the fused
    H_s on the first step's dense leaves of ``spec["hs_leaves"]``, each bit
    for bit against hsthresh_ref and its support the path's, timed; sqround
    on the captured gradient chunk; FLASH_TC at the run's microbatch shape
    with cfg's window, beside SDPA (the band as a boolean mask where there
    is a window) and its bound."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = torch.device(mods["device"])
    tag = spec["tag"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cfg_iht = mods["IHTConfig"](sparsity=TRAIN_SPARSITY)
    HSTHRESH, ref = mods["HSTHRESH"], mods["hsthresh_ref_mod"].hsthresh_ref
    rows = {}
    for name, path in spec["hs_leaves"].items():
        old, kept = inputs["hs"].pop(path)
        x = old.to(dev).view(1, -1)
        del old
        keep = mods["iht"].keep_count(x, cfg_iht)
        got = HSTHRESH(x, keep, TRAIN_NBINS)
        want = ref(x, keep, TRAIN_NBINS)
        row = {"leaf": path, "N": x.numel(), "keep": keep, "bitwise": bool(torch.equal(got, want)),
               "max_abs_err": float((got - want).abs().max()),
               "path_support": bool(torch.equal(got.view(-1) != 0, kept.to(dev).view(-1)))}
        del got, want, kept
        if not (row["bitwise"] and row["path_support"]):
            raise AssertionError(f"{tag}: the fused H_s on the dense {path} leaf: bitwise "
                                 f"hsthresh_ref {row['bitwise']} (max|Δ| {row['max_abs_err']}), "
                                 f"support the path's {row['path_support']}")
        row["ms"] = time_ms(torch, lambda: HSTHRESH(x, keep, TRAIN_NBINS), 2, flush)
        row["plain_ms"] = time_ms(torch, lambda: ref(x, keep, TRAIN_NBINS), 1, flush)
        row["bound_ms"], row["bound_by"] = 8 * x.numel() / HBM_BYTES_PER_S * 1e3, "bytes"
        rows[name] = row
        del x
        torch.cuda.empty_cache()
    v, words, scale, _ = inputs["sqround"]
    w32 = mods["narrow_words"](words)
    sq = {"N": v.numel(), "max_abs_err": inputs["sqround_err"],
          "ms": time_ms(torch, lambda: mods["SQROUND"](v, w32, scale, TRAIN_GRAD_BITS), 5, flush),
          "plain_ms": time_ms(torch, lambda: mods["sqround_ref"](v, words, scale, TRAIN_GRAD_BITS),
                              3, flush),
          "words_ms": time_ms(torch, lambda: mods["prng"]._bits_flat(
              mods["prng"].PRNGKey(5), 0, v.numel(), dev), 3, flush),
          "bound_ms": 9 * v.numel() / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del v, words, w32
    emb, wi = rows["embed"], rows["wi"]
    print(f"[chip_smoke]   {tag} fused H_s on the first step's dense leaves, bit for bit "
          f"hsthresh_ref and the path's support: embed N={emb['N']:,} {emb['ms']:.2f} ms (plain "
          f"{emb['plain_ms']:.1f} ms, bound {emb['bound_ms']:.2f} ms), {wi['leaf']} "
          f"N={wi['N']:,} {wi['ms']:.1f} ms (plain {wi['plain_ms']:.1f} ms, bound "
          f"{wi['bound_ms']:.2f} ms); sqround on the captured gradient chunk of {sq['N']:,}: "
          f"{sq['ms']:.4f} ms (plain {sq['plain_ms']:.3f}, its threefry words "
          f"{sq['words_ms']:.2f}, bound {sq['bound_ms']:.4f})", flush=True)
    out = {"hsthresh": rows, "sqround": sq}
    if not lm_attention_layers(cfg):
        return out
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    w = mods["lm_model"]._window(cfg)
    b, s = spec["batch"] // spec["accum"], spec["seq"]
    gen = torch.Generator(device=dev).manual_seed(23)
    q, kk, vv = (torch.randn(b, h, s, d, generator=gen, device=dev)
                 .to(torch.bfloat16) for h in (hq, hkv, hkv))
    FLASH_TC = mods["FLASH_TC"]
    o = FLASH_TC(q, kk, vv, True, d ** -0.5, 0, w or 0)
    refo = mods["attention_plain"](q, kk, vv, causal=True, scale=d ** -0.5, window=w, q_offset=0)
    gap = held(torch, f"{tag} forward", o, refo, 2e-2, rows=True)
    del o, refo
    if w is None:
        def sdpa():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return torch.nn.functional.scaled_dot_product_attention(q, kk, vv, is_causal=True,
                                                                        enable_gqa=True)
    else:
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < w)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q, kk, vv, attn_mask=band,
                                                                    enable_gqa=True)
    b_ms, b_by, _ = attention_bound(b, hq, hkv, s, s, d, 2, True, w, 0)
    fl = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": w,
          "max_abs_err": gap["max_abs_err"], "max_row_rel": gap["max_row_rel"],
          "ms": time_ms(torch, lambda: FLASH_TC(q, kk, vv, True, d ** -0.5, 0, w or 0), 10, flush),
          "plain_ms": time_ms(torch, lambda: mods["lm_layers"].chunked_attention_plain(
              q, kk, vv, causal=True, chunk=cfg.attn_chunk, window=w), 3, flush),
          "library_ms": time_ms(torch, sdpa, 10, flush), "bound_ms": b_ms, "bound_by": b_by}
    print(f"[chip_smoke]   {tag} FLASH_TC B={b} S={s} {hq}/{hkv} heads D={d} window {w}: "
          f"{fl['ms']:.4f} ms (plain {fl['plain_ms']:.2f}, SDPA"
          f"{' with the band as a mask' if w else ''} {fl['library_ms']:.4f}, bound {b_ms:.4f} "
          f"{b_by})", flush=True)
    out["flash"] = fl
    return out


def train_recurrent_layers(torch, mods, cfg, spec):
    """Forward and backward ms of one layer's recurrent core at the run's
    microbatch shape (bf16 activations as the path hands them): the RG-LRU's
    log-depth scan (``rglru.linear_scan`` on float32 a and b) or the chunked
    SSD (``ssm.ssd_chunked``, its parameters and inputs requiring a
    gradient); the backward is autograd's, timed as forward + backward less
    the forward."""
    dev = torch.device(mods["device"])
    gen = torch.Generator(device=dev).manual_seed(25)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    b, s = spec["batch"] // spec["accum"], spec["seq"]
    if cfg.family == "hybrid":
        what = "RG-LRU scan"
        w = cfg.rnn_width_
        a = torch.rand(b, s, w, generator=gen, device=dev).requires_grad_(True)
        x = torch.randn(b, s, w, generator=gen, device=dev).requires_grad_(True)
        g = torch.randn(b, s, w, generator=gen, device=dev)
        scan = mods["rglru"].linear_scan

        def fwd():
            with torch.no_grad():
                return scan(a, x)

        def fwd_bwd():
            return torch.autograd.grad(scan(a, x), (a, x), g)
    else:
        what = "SSD"
        ssm = mods["ssm"]
        h, ds = cfg.ssm_heads, cfg.ssm_state
        p = {"dt_bias": torch.zeros(h, device=dev), "d_skip": torch.ones(h, device=dev),
             "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev))}
        xr = torch.randn(b, s, cfg.d_inner, generator=gen, device=dev).to(torch.bfloat16)
        bb, cc = (torch.randn(b, s, ds, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        dt = torch.randn(b, s, h, generator=gen, device=dev).to(torch.bfloat16)
        leaves = [xr, bb, cc, dt, *p.values()]
        for t in leaves:
            t.requires_grad_(True)
        gy = torch.randn(b, s, h, cfg.ssm_headdim, generator=gen, device=dev)

        def fwd():
            with torch.no_grad():
                return ssm.ssd_chunked(p, xr, bb, cc, dt, cfg)

        def fwd_bwd():
            y, _ = ssm.ssd_chunked(p, xr, bb, cc, dt, cfg)
            return torch.autograd.grad(y, leaves, gy)
    grads = fwd_bwd()
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError(f"{spec['tag']} {what} B={b} S={s}: non-finite gradients")
    del grads
    f_ms = time_ms(torch, fwd, 5, flush)
    fb_ms = time_ms(torch, fwd_bwd, 5, flush)
    n = sum(kind in ("rec", "ssm") for kind in cfg.pattern_for_layers())
    row = {"what": what, "B": b, "S": s, "forward_ms": f_ms, "backward_ms": fb_ms - f_ms,
           "layers": n}
    print(f"[chip_smoke]   {spec['tag']} {what} B={b} S={s}, a layer: forward {f_ms:.3f} ms, "
          f"backward {fb_ms - f_ms:.3f} ms (autograd; forward + backward {fb_ms:.3f}), "
          f"{n} layers", flush=True)
    return row


def phase_train_family(torch, mods, arch):
    """``arch`` trained at full width on the card: the attention Function's
    gradient checks (cfg's heads and window), card against CPU, resume bit
    for bit, the full-width run, the kernels on its inputs, and (recurrent
    families) one layer's recurrent core forward and backward."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = mods["lm_get_config"](arch)
    spec = train_spec(arch)
    out = {"attention": train_attention_check(torch, mods, cfg, spec)}
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(torch, mods, cfg, spec)
    torch.cuda.empty_cache()
    out["resume"] = train_resume_check(torch, mods, cfg, spec)
    torch.cuda.empty_cache()
    state, out["run"], inputs = train_run(torch, mods, cfg, spec)
    del state
    torch.cuda.empty_cache()
    out["kernels"] = train_kernel_rows(torch, mods, cfg, inputs, spec)
    if cfg.family in ("hybrid", "ssm"):
        torch.cuda.empty_cache()
        out["recurrent_layer"] = train_recurrent_layers(torch, mods, cfg, spec)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke]   {spec['tag']} phase {out['seconds']:.1f} s", flush=True)
    return out


def train_faults(torch, mods):
    """Faults planted in recurrentgemma-2b's training path, each of which a
    gate of phase train_hybrid must fail on: (1) the attention backward
    route ignoring the window (``attention_backward_plain`` called without
    it): the attention check and the card-vs-CPU gradients; (2) the RG-LRU
    scan on the card dropping one step's a (a_t taken as 1 at t = S/2, as
    if the decay of that step were lost): the card-vs-CPU gradients.
    Returns what each gate read; raises if a gate passed its fault."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mods["lm_get_config"](TRAIN_HYBRID_ARCH)
    spec = train_spec(TRAIN_HYBRID_ARCH)
    layers, rglru = mods["lm_layers"], mods["rglru"]
    real_backward, real_scan = layers.attention_backward_plain, rglru.linear_scan

    def backward_without_window(*args, window=None, **kw):
        return real_backward(*args, **kw)

    def scan_dropping_one_a(a, b):
        if a.is_cuda:
            a = a.clone()
            a[:, a.shape[1] // 2] = 1.0
        return real_scan(a, b)

    def attention():
        return train_attention_check(torch, mods, cfg, spec)

    def card_vs_cpu():
        return train_card_vs_cpu(torch, mods, cfg, spec)
    faults = (("backward_ignores_window", layers,
               dict(attention_backward_plain=backward_without_window),
               (("attention", attention), ("card_vs_cpu", card_vs_cpu))),
              ("scan_drops_one_a", rglru, dict(linear_scan=scan_dropping_one_a),
               (("card_vs_cpu", card_vs_cpu),)))
    results, missed = {}, []
    for fault, module, fns, gates in faults:
        for gate, run in gates:
            with stand_in(module, **fns):
                try:
                    run()
                except AssertionError as e:
                    results[f"{fault}: {gate}"] = f"caught: {e}"
                else:
                    results[f"{fault}: {gate}"] = "missed"
                    missed.append(f"{fault}: {gate}")
            torch.cuda.empty_cache()
            print(f"[chip_smoke]   train fault {fault}, gate {gate}: "
                  f"{results[f'{fault}: {gate}']}", flush=True)
    if missed:
        raise AssertionError(f"planted faults no gate caught: {missed}")
    return results


def phase_train(torch, mods):
    """starcoder2-3b trained at full width on the card (phase ``train``)."""
    return phase_train_family(torch, mods, TRAIN_ARCH)


def phase_train_hybrid(torch, mods):
    """recurrentgemma-2b trained at full width on train_4k's rows (phase
    ``train_hybrid``): 4 rows of 4,096 tokens a step in 4 microbatches, the
    window of 2,048 keys biting in the 8 attention layers."""
    return phase_train_family(torch, mods, TRAIN_HYBRID_ARCH)


def phase_train_ssm(torch, mods):
    """mamba2-370m trained at full width on train_4k's rows (phase
    ``train_ssm``): 8 rows of 4,096 tokens a step, 48 SSD layers."""
    return phase_train_family(torch, mods, TRAIN_SSM_ARCH)


def load_port() -> dict:
    """Import the port from ``src/`` (the only imports of the program)."""
    sys.path.insert(0, str(SRC))
    from repro_torch import random as prng
    from repro_torch.configs.gaussian_toy import CONFIG as GAUSS
    from repro_torch.configs.lofar_cs302 import BENCH as LOFAR_BENCH, CONFIG as LOFAR
    from repro_torch.configs import CONFIGS
    niht = importlib.import_module("repro_torch.core.niht")   # the module, not the function
    from repro_torch.core.niht import (
        _solver_setup,
        qniht_batch,
        solver_init,
        solver_result,
        solver_segment,
    )
    from repro_torch.core.recovery import psnr, relative_error
    from repro_torch import parallel
    from repro_torch.configs import SERVE_CONFIGS
    from repro_torch.launch import serve
    from repro_torch.parallel import Request
    from repro_torch.kernels.cudalib import CudaLibrary
    from repro_torch.kernels.hsthresh import kernel as hs_kernel, ops as hs_ops
    from repro_torch.kernels.hsthresh import ref as hsthresh_ref_mod
    from repro_torch.kernels.flashattn import kernel as fa_kernel
    from repro_torch.kernels.flashattn.ops import attention_plain, flash_attention
    from repro_torch.kernels.sqround import kernel as sq_kernel
    from repro_torch.kernels.sqround.ops import sqround
    from repro_torch.kernels.sqround.ref import sqround_ref
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.kernels.qmm.kernel import (
        QMM,
        QMM_BATCHED,
        QMM_CORE,
        QMM_EXPERTS,
        QMM_GROUP,
        QMM_GROUP_CORE,
        experts_shape_ok,
        tc_aligned,
    )
    from repro_torch.kernels.qmm import ops as qmm_ops
    from repro_torch.kernels.qmm.ops import (
        PackedWeights,
        cuda_kernel,
        group_kernel,
        pack_operator,
        pack_weights,
        qmm,
        qmm_batched,
    )
    from repro_torch.kernels.qmm.ref import qmm_batched_ref, qmm_group_ref, qmm_ref
    from repro_torch.quant.quantize import expand_block_scale
    from repro_torch.launch.recover import (
        gaussian_batch_instance,
        lofar_instance,
        main as recover_main,
        mri_instance,
        recover_gaussian,
        recover_lofar,
        recover_mri,
    )
    from repro_torch.quant.pack import pack_codes, unpack_codes
    from repro_torch.quant.formats import BY_BITS
    from repro_torch.core.niht import qniht
    from repro_torch.core.operators import PackedStreamingOperator
    from repro_torch.sensing import kspace_band_scales, kspace_radial_bands
    from repro_torch.sensing.sky import make_sky
    from repro_torch.sensing.telescope import (
        Station,
        dirty_beam,
        dirty_image,
        measurement_matrix,
        tune_extent_for_gamma,
        visibilities,
    )
    from repro_torch.analysis.sanitize import sanitize
    from repro_torch.core import baselines, rip
    from repro_torch.core.niht import stopping_iterations
    from repro_torch.core.recovery import source_recovery, support_recovery
    from repro_torch.quant.quantize import fake_quantize, quantize
    from repro_torch.configs import get_config as lm_get_config
    from repro_torch.kernels.flashattn import ops as fa_ops
    from repro_torch.models import generate, layers as lm_layers, model as lm_model
    from repro_torch.models import moe as lm_moe, rglru, ssm
    from repro_torch.models.quantized import (
        QWeight,
        materialize as lm_materialize,
        param_bytes,
        quantize_params,
        tree_to as lm_tree_to,
    )
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.data import SyntheticStream
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import ATTENTION_BACKWARD
    from repro_torch.optim import IHTConfig, Optimizer, adamw, cosine_schedule, sparsity_report
    from repro_torch.optim import iht
    from repro_torch.parallel import collectives
    from repro_torch.train import (
        LoopConfig,
        init_state,
        make_train_step,
        run_with_restarts,
        train_loop,
    )
    from repro_torch.train import steps as train_steps
    from repro_torch.tree import keystr, last_key, tree_flatten_with_path, tree_leaves, tree_map

    mods = dict(SyntheticStream=SyntheticStream, loss_fn=loss_fn,
                ATTENTION_BACKWARD=ATTENTION_BACKWARD, IHTConfig=IHTConfig, Optimizer=Optimizer,
                adamw=adamw, cosine_schedule=cosine_schedule, iht=iht, collectives=collectives,
                LoopConfig=LoopConfig, init_state=init_state, make_train_step=make_train_step,
                run_with_restarts=run_with_restarts, train_loop=train_loop,
                train_steps=train_steps, tree_flatten_with_path=tree_flatten_with_path,
                keystr=keystr, last_key=last_key,
                tree_leaves=tree_leaves, tree_map=tree_map, sparsity_report=sparsity_report,
                lm_get_config=lm_get_config, fa_ops=fa_ops, generate=generate,
                lm_layers=lm_layers, lm_model=lm_model, rglru=rglru, ssm=ssm, QWeight=QWeight,
                ATTENTION_KV_CAST=lm_layers.ATTENTION_KV_CAST, lm_moe=lm_moe,
                EXPERT_BMM=lm_moe.EXPERT_BMM, QMM_BATCHED=QMM_BATCHED, qmm_batched=qmm_batched,
                QMM_EXPERTS=QMM_EXPERTS, experts_shape_ok=experts_shape_ok,
                qmm_batched_ref=qmm_batched_ref, tc_aligned=tc_aligned,
                lm_materialize=lm_materialize, param_bytes=param_bytes,
                quantize_params=quantize_params,
                lm_tree_to=lm_tree_to,
                QuantPolicy=QuantPolicy, prng=prng, GAUSS=GAUSS, LOFAR=LOFAR, QMM=QMM, pack_operator=pack_operator,
                pack_weights=pack_weights, qmm_ref=qmm_ref, recover_gaussian=recover_gaussian,
                recover_lofar=recover_lofar, unpack_codes=unpack_codes, Station=Station,
                measurement_matrix=measurement_matrix, make_sky=make_sky,
                visibilities=visibilities, qniht=qniht, qmm_ops=qmm_ops,
                gaussian_batch_instance=gaussian_batch_instance, lofar_instance=lofar_instance,
                LOFAR_BENCH=LOFAR_BENCH, device="cuda", QMM_GROUP=QMM_GROUP,
                qmm_group_ref=qmm_group_ref, expand_block_scale=expand_block_scale,
                HIST=hs_kernel.HIST, MASK=hs_kernel.MASK, hs_ops=hs_ops,
                HSTHRESH=hs_kernel.HSTHRESH, hsthresh_cuda=hs_kernel.hsthresh_cuda,
                QMM_CORE=QMM_CORE, PackedWeights=PackedWeights,
                FLASH_TC_UNALIGNED=fa_kernel.FLASH_TC_UNALIGNED,
                FLASH_UNALIGNED=fa_kernel.FLASH_UNALIGNED,
                hsthresh_ref_mod=hsthresh_ref_mod, qniht_batch=qniht_batch,
                solver_setup=_solver_setup, SQROUND=sq_kernel.SQROUND, sqround=sqround,
                sqround_ref=sqround_ref, narrow_words=sq_kernel.narrow_words,
                FLASH=fa_kernel.FLASH, FLASH_TC=fa_kernel.FLASH_TC,
                flash_attention=flash_attention, attention_plain=attention_plain,
                CudaLibrary=CudaLibrary, QMM_GROUP_CORE=QMM_GROUP_CORE, qmm=qmm,
                cuda_kernel=cuda_kernel, group_kernel=group_kernel, pack_codes=pack_codes,
                niht=niht, solver_init=solver_init, solver_segment=solver_segment,
                solver_result=solver_result, psnr=psnr, CONFIGS=CONFIGS,
                ROW_LOCAL_ROWS=qmm_kernel.ROW_LOCAL_ROWS, BY_BITS=BY_BITS,
                kspace_band_scales=kspace_band_scales, kspace_radial_bands=kspace_radial_bands,
                recover_mri=recover_mri, mri_instance=mri_instance, recover_main=recover_main,
                rip=rip, baselines=baselines, sanitize=sanitize, dirty_image=dirty_image,
                dirty_beam=dirty_beam, tune_extent_for_gamma=tune_extent_for_gamma,
                stopping_iterations=stopping_iterations, quantize=quantize,
                fake_quantize=fake_quantize, support_recovery=support_recovery,
                source_recovery=source_recovery,
                relative_error=relative_error, parallel=parallel, SERVE_CONFIGS=SERVE_CONFIGS,
                serve=serve, Request=Request, PackedStreamingOperator=PackedStreamingOperator,
                KERNELS=(QMM, QMM_CORE, QMM_GROUP, QMM_GROUP_CORE, QMM_BATCHED, QMM_EXPERTS,
                         hs_kernel.HIST,
                         hs_kernel.MASK,
                         hs_kernel.HSTHRESH, sq_kernel.SQROUND, fa_kernel.FLASH,
                         fa_kernel.FLASH_TC, fa_kernel.FLASH_TC_UNALIGNED,
                         fa_kernel.FLASH_UNALIGNED),
                LIBRARIES=(qmm_kernel.LIBRARY, qmm_kernel.CORE_LIBRARY,
                           qmm_kernel.EXPERTS_LIBRARY, hs_kernel.LIBRARY,
                           hs_kernel.FUSED_LIBRARY, sq_kernel.LIBRARY, fa_kernel.LIBRARY,
                           fa_kernel.TC_LIBRARY))
    return mods


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them ("" if it
    cannot)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "chip_smoke_out"),
                    help="directory for chip_smoke.json and the profiler trace")
    ap.add_argument("--flash-mutants", action="store_true",
                    help="only check that planted faults of flashattn_wgmma.cu fail the bf16 "
                         "checks")
    ap.add_argument("--lm-faults", action="store_true",
                    help="only check that faults planted in the lm phase's W4KV8 run (qmm "
                         "scales of one layer, the flash mutants) fail its gates")
    ap.add_argument("--moe-faults", action="store_true",
                    help="only check that faults planted in the moe phase's W4KV8 run (one "
                         "layer's expert on another's codes, unrenormalized gates) fail its "
                         "gates or held checks")
    ap.add_argument("--train-faults", action="store_true",
                    help="only check that faults planted in recurrentgemma-2b's training path "
                         "(a backward that ignores the window, a scan that drops one step's a) "
                         "fail the train_hybrid phase's gates")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    mods = load_port()
    mods["out_dir"] = Path(args.out)
    LOFAR = mods["LOFAR"]
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)
    phases = Phases()
    t0 = time.perf_counter()
    if args.flash_mutants:
        result = phases.run("flash-mutants", flash_mutants, torch, mods)
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        (mods["out_dir"] / "flash_mutants.json").write_text(json.dumps(result, indent=1))
        print(nvidia_smi_line(), flush=True)
        return 1 if phases.failed else 0
    if args.lm_faults:
        result = phases.run("lm-faults", lm_faults, torch, mods)
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        (mods["out_dir"] / "lm_faults.json").write_text(json.dumps(result, indent=1))
        print(nvidia_smi_line(), flush=True)
        return 1 if phases.failed else 0
    if args.moe_faults:
        phases.run("build", phase_build, [mods["QMM"].library, mods["FLASH_TC"].library,
                                          mods["FLASH"].library])
        result = phases.run("moe-faults", moe_faults, torch, mods)
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        (mods["out_dir"] / "moe_faults.json").write_text(json.dumps(result, indent=1, default=str))
        print(nvidia_smi_line(), flush=True)
        return 1 if phases.failed else 0
    if args.train_faults:
        phases.run("build", phase_build, mods["LIBRARIES"])
        result = phases.run("train-faults", train_faults, torch, mods)
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        (mods["out_dir"] / "train_faults.json").write_text(json.dumps(result, indent=1))
        print(nvidia_smi_line(), flush=True)
        return 1 if phases.failed else 0
    report = {"device": kind}
    report["build"] = phases.run("build", phase_build, mods["LIBRARIES"])
    report["kernel"] = phases.run("kernel-vs-plain", phase_kernel, torch, mods)
    report["group_kernel"] = phases.run("qmm_group-vs-plain", phase_group_kernel, torch, mods)
    report["hs_kernels"] = phases.run("hist-mask-vs-plain", phase_hs_kernels, torch, mods)
    report["fused_hs"] = phases.run("fused-hsthresh-vs-plain", phase_fused_hs, torch, mods)
    report["lofar"] = phases.run("lofar-main-path", phase_lofar, torch, mods)
    report["lofar_block"] = phases.run("lofar-per-block", phase_lofar_block, torch, mods,
                                       report["lofar"])
    report["lofar_hsthresh"] = phases.run("lofar-hsthresh", phase_lofar_hsthresh, torch, mods)
    report["gaussian"] = phases.run("gaussian", phase_gaussian, torch, mods)
    report["gaussian_block"] = phases.run("gaussian-per-block", phase_gaussian_block, torch,
                                          mods)
    report["sqround"] = phases.run("sqround", phase_sqround, torch, mods)
    report["flash"] = phases.run("flash-attention", phase_flash, torch, mods)
    report["profile"] = phases.run("profile", phase_profile, torch, mods)
    report["solver"] = phases.run("solver", phase_solver, torch, mods)
    report["mri"] = phases.run("mri", phase_mri, torch, mods)
    report["resume"] = phases.run("resume", phase_resume, torch, mods)
    report["serve"] = phases.run("serve", phase_serve, torch, mods)
    report["theory"] = phases.run("theory", phase_theory, torch, mods, report["lofar"])
    report["baselines"] = phases.run("baselines", phase_baselines, torch, mods)
    report["sanitize"] = phases.run("sanitize", phase_sanitize, torch, mods)
    report["lm"] = phases.run("lm", phase_lm, torch, mods)
    report["hybrid"] = phases.run("hybrid", phase_hybrid, torch, mods)
    report["ssm"] = phases.run("ssm", phase_ssm, torch, mods)
    report["train"] = phases.run("train", phase_train, torch, mods)
    report["train_hybrid"] = phases.run("train_hybrid", phase_train_hybrid, torch, mods)
    report["train_ssm"] = phases.run("train_ssm", phase_train_ssm, torch, mods)
    report["encdec"] = phases.run("encdec", phase_encdec, torch, mods)
    report["vlm"] = phases.run("vlm", phase_vlm, torch, mods)
    report["moe"] = phases.run("moe", phase_moe, torch, mods)
    card = nvidia_smi_line()
    report["nvidia_smi"] = card
    report["seconds"] = time.perf_counter() - t0
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if phases.failed or not card:
        print(f"[chip_smoke] FAILED phases: {phases.failed or ['nvidia-smi']}", flush=True)
        return 1
    kernels = []
    for name, phase, path, replaces in (
            ("qmm", "kernel", "lofar", "src/repro/kernels/qmm/kernel.py:265"),
            ("qmm_group", "group_kernel", "lofar_block", "src/repro/kernels/qmm/kernel.py:221")):
        by_orientation = report[path]["launches_by_orientation"]
        for shape in ("lofar_fwd", "lofar_adj"):
            row = next(r for r in report[phase]["rows"]
                       if r["shape"] == shape and r["bits"] == LOFAR.bits_phi and r["M"] == 1)
            kernels.append({
                "name": f"{name}[{shape}]",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/qmm/csrc/{report[phase]['source']}",
                "entry": report[phase]["entry"],
                "replaces": replaces,
                "launches": by_orientation[shape],
                "max_abs_err": report[phase]["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bytes_bound_ms": row["bytes_bound_ms"],
                "device_ms": row["device_ms"],
                "library_ms": row["library_ms"],
                "shape": f"{shape} bits={row['bits']} M=1 N={row['N']} K={row['K']}"
                         + (f" g={GROUP}" if name == "qmm_group" else ""),
            })
    for name, phase, source in (("qmm_core", "kernel", "qmm.cu"),
                                ("qmm_group_core", "group_kernel", "qmm.cu")):
        for row in report[phase]["misaligned_rows"]:
            kernels.append({
                "name": f"{name}[{row['shape']} codes at offset {row['offset']}]",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/qmm/csrc/{source}",
                "entry": row["entry"],
                "replaces": ("src/repro/kernels/qmm/kernel.py:265" if name == "qmm_core"
                             else "src/repro/kernels/qmm/kernel.py:221"),
                "launches": report[phase]["misaligned_launches"],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bytes_bound_ms": row["bytes_bound_ms"],
                "library_ms": row["library_ms"],
                "shape": f"{row['shape']} bits={row['bits']} M=1 N={row['N']} K={row['K']}"
                         + (f" g={GROUP}" if name == "qmm_group_core" else "")
                         + "; launches: the misaligned checks of its phase",
            })
    core = next(r for r in report["group_kernel"]["core_rows"] if r["bits"] == 4)
    kernels.append({
        "name": "qmm_group_core[gaussian g=8]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/qmm/csrc/qmm.cu",
        "entry": "repro_qmm_group",
        "replaces": "src/repro/kernels/qmm/kernel.py:221",
        "launches": sum(v["launches"] for k, v in report["gaussian_block"].items()
                        if v["entry"] == "repro_qmm_group"),
        "max_abs_err": max(r["max_abs_err"] for r in report["group_kernel"]["core_rows"]),
        "ms": core["ms"],
        "plain_ms": core["plain_ms"],
        "bound_ms": core["bound_ms"],
        "bound_by": core["bound_by"],
        "bytes_bound_ms": core["bytes_bound_ms"],
        "library_ms": core["library_ms"],
        "shape": f"ragged bits=4 M=5 N={core['N']} K={core['K']} g={core['g']} (timed); "
                 "launches from the Gaussian per_block g=8 solves",
    })
    row = next(r for r in report["fused_hs"]["rows"] if r["B"] == 1)
    kernels.append({
        "name": "hsthresh[lofar]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh_fused.cu",
        "entry": "repro_hsthresh",
        "replaces": "src/repro/kernels/hsthresh/kernel.py:48 and :69 (hist_pallas, "
                    "mask_pallas and the jnp pick and fill between them)",
        "launches": report["lofar_hsthresh"]["launches"],
        "max_abs_err": 0.0,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "device_ms": row["device_ms"],
        "chain_ms": row["chain_ms"],
        "shape": f"B=1 N={row['N']} s={row['s']} nbins={NBINS}",
    })
    for name, replaces in (("hist", "src/repro/kernels/hsthresh/kernel.py:48"),
                           ("mask", "src/repro/kernels/hsthresh/kernel.py:69")):
        row = next(r for r in report["hs_kernels"]["rows"] if r["name"] == name and r["B"] == 1)
        kernels.append({
            "name": f"{name}[lofar]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh.cu",
            "replaces": replaces,
            "launches": report["hs_kernels"]["launches"][name],
            "max_abs_err": 0.0,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"B=1 N={row['N']} nbins={NBINS}",
        })
    row = next(r for r in report["sqround"]["rows"]
               if r["shape"] == "lofar_phi" and r["bits"] == LOFAR.bits_phi)
    kernels.append({
        "name": "sqround[lofar_phi]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sqround/csrc/sqround.cu",
        "replaces": "src/repro/kernels/sqround/kernel.py:49",
        "launches": report["sqround"]["launches"],
        "max_abs_err": 0.0,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "call_ms": row["call_ms"],
        "shape": f"R={row['R']} C={row['C']} bits={row['bits']}",
    })
    flash = report["flash"]
    rows = {r["shape"]: r for r in flash["rows"]}
    for name, key, source, entry in (
            ("flash_attention_tc[starcoder2_3b_prefill_32k]",
             f"starcoder2_3b S={PREFILL_32K_LEN} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_f32[starcoder2_3b_train_4k]",
             f"starcoder2_3b S={TRAIN_4K_LEN} f32", "flashattn.cu", "FLASH"),
            ("flash_attention_tc[stablelm_12b_train_4k]",
             f"stablelm_12b S={TRAIN_4K_LEN} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_tc[recurrentgemma_2b_train_4k]",
             f"recurrentgemma_2b S={TRAIN_4K_LEN} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_tc[qwen3_moe_235b_smoke_train_4k]",
             f"qwen3_moe_235b_smoke S={TRAIN_4K_LEN} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_tc[stablelm_12b_prefill_b8_1k]",
             f"stablelm_12b B={LM_BATCH} S={LM_PROMPT} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_tc[recurrentgemma_2b_prefill_b8_1k]",
             f"recurrentgemma_2b B={LM_BATCH} S={LM_PROMPT} bf16", "flashattn_wgmma.cu",
             "FLASH_TC"),
            ("flash_attention_tc_unaligned[starcoder2_3b_train_4k]",
             f"starcoder2_3b S={TRAIN_4K_LEN} bf16 views 2 elements in", "flashattn_wgmma.cu",
             "FLASH_TC_UNALIGNED"),
            ("flash_attention_f32_unaligned[starcoder2_3b_train_4k]",
             f"starcoder2_3b S={TRAIN_4K_LEN} f32 views 1 element in", "flashattn.cu",
             "FLASH_UNALIGNED")):
        row = rows[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/flashattn/csrc/{source}",
            "entry": row["kernel"],
            "replaces": "src/repro/kernels/flashattn/kernel.py:87",
            "launches": flash["launches"][entry],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "max_row_rel": row["max_row_rel"],
            "library_max_row_rel": row["library_max_row_rel"],
            "library_backend": row["library_backend"],
            "library_flash_ms": row.get("library_flash_ms"),
            "f32_core_bound_ms": row["f32_core_bound_ms"],
            "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} "
                     f"{row['dtype']} causal",
        })
    row = next(r for r in report["kernel"]["rows"]
               if r["shape"] == "lofar_fwd" and r["bits"] == LOFAR.bits_phi and r["M"] == 1)
    kernels.append({
        "name": "qmm[lofar solver phase: early exit, segments, freeze]",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/qmm/csrc/{report['kernel']['source']}",
        "entry": report["kernel"]["entry"],
        "replaces": "src/repro/kernels/qmm/kernel.py:265",
        "launches": report["solver"]["qmm_launches"],
        "max_abs_err": report["kernel"]["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": f"lofar_fwd bits={row['bits']} M=1 N={row['N']} K={row['K']} (timed in the "
                 "kernel phase); launches: both orientations over the solver phase",
    })
    serve_rows = report["serve"]["qmm_rows"]
    row = next(r for r in serve_rows if r["shape"] == "serve_fwd" and r["M"] == 8)
    kernels.append({
        "name": "qmm[serve phase: 8-slot scheduler, 64-row chunks in blocks of 16, LOFAR slots]",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/qmm/csrc/{report['kernel']['source']}",
        "entry": report["kernel"]["entry"],
        "replaces": "src/repro/kernels/qmm/kernel.py:265",
        "launches": report["serve"]["qmm_launches"],
        "reference_solve_launches": report["serve"]["reference_qmm_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in serve_rows),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": f"serve_fwd bits={row['bits']} M=8 N={row['N']} K={row['K']} (the 4-bit "
                 "serve Φ̂, timed in the serve phase); launches: the serve phase's path "
                 "(scheduler segments of both policies, the chunks, the LOFAR segments); "
                 "reference_solve_launches: its verify solves, each held to the formula",
    })
    for name in MRI_CONFIGS:
        row = next(r for r in report["mri"]["hs_rows"] if r["config"] == name and r["B"] == 1)
        kernels.append({
            "name": f"hsthresh[{name} s={row['s']}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh_fused.cu",
            "entry": "repro_hsthresh",
            "replaces": "src/repro/kernels/hsthresh/kernel.py:48 and :69 (hist_pallas, "
                        "mask_pallas and the jnp pick and fill between them)",
            "launches": report["mri"]["hs_launches"][name],
            "max_abs_err": 0.0,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "device_ms": row["device_ms"],
            "shape": f"B=1 N={row['N']} s={row['s']} nbins={NBINS}; launches: the {name} "
                     "hsthresh solves, single and batch 8",
        })
    lm, lm_source = report["lm"], f"src/repro_torch/kernels/qmm/csrc/{report['kernel']['source']}"
    for row in lm["qmm_rows"]:
        if row["shape"] == "wv":
            continue                  # wk's shape: launches_by_shape counts them together
        name = "wk+wv" if row["shape"] == "wk" else row["shape"]
        kernels.append({
            "name": f"qmm[lm decode: {LM_ARCH} W4 {name}]",
            "route": "cuda",
            "source": lm_source,
            "entry": report["kernel"]["entry"],
            "replaces": "src/repro/kernels/qmm/kernel.py:265",
            "launches": lm["w4kv8"]["qmm_launches_by_shape"][f"{row['N']}x{row['K']}"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bytes_bound_ms": row["bytes_bound_ms"],
            "library_ms": row["library_ms"],
            "shape": f"M={row['M']} N={row['N']} K={row['K']} bits={row['bits']}, layer 0's "
                     "codes (timed); launches: the W4KV8 run's decode steps, all layers; "
                     "bound: codes, scales, bf16 x and y, or one bf16 pass at the "
                     "tensor-core peak; library: torch.matmul on the dequantized bf16 weight "
                     "(the reference computes materialize, src/repro/models/quantized.py:71, "
                     "then x @ w)",
        })
    row = lm["flash_row"]
    kernels.append({
        "name": f"flash_attention_tc[lm prefill: {LM_ARCH} B={row['B']} S={row['S']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
        "entry": "repro_flash_attention_tc",
        "replaces": "src/repro/kernels/flashattn/kernel.py:87",
        "launches": lm["w4kv8"]["flash_tc_launches"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "max_row_rel": row["max_row_rel"],
        "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} bf16 "
                 "causal; launches: the W4KV8 run's prefill, one per layer (the reference "
                 "computes chunked_attention, src/repro/models/layers.py:203)",
    })
    hybrid = report["hybrid"]
    by_name = {r["shape"]: r for r in hybrid["qmm_rows"]}
    for name, row, shape in (
            ("2560x2560: RG-LRU in_x, in_gate, w_r, w_i, out; attention wq, wo", by_name["in_x"],
             "in_x"),
            ("256x2560: attention wk + wv", by_name["wk"], "wk")):
        kernels.append({
            "name": f"qmm[hybrid decode: {HYBRID_ARCH} W4 {name}]",
            "route": "cuda",
            "source": lm_source,
            "entry": report["kernel"]["entry"],
            "replaces": "src/repro/kernels/qmm/kernel.py:265",
            "launches": hybrid["w4kv8"]["qmm_launches_by_shape"][f"{row['N']}x{row['K']}"]
                        + hybrid["long"]["qmm_launches_by_shape"][f"{row['N']}x{row['K']}"],
            "max_abs_err": max(r["max_abs_err"] for r in hybrid["qmm_rows"]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bytes_bound_ms": row["bytes_bound_ms"],
            "library_ms": row["library_ms"],
            "f32_x_ms": by_name["w_r"]["ms"] if shape == "in_x" else None,
            "shape": f"M={row['M']} N={row['N']} K={row['K']} bits={row['bits']}, layer 0's "
                     f"{shape} codes on bf16 x (timed; f32_x_ms: the gate w_r on float32 x); "
                     "launches: the W4KV8 runs' decode steps (A and B), all layers; library: "
                     "torch.matmul on the dequantized weight",
        })
    for row, what in ((hybrid["flash_rows"][0], "flashattn_wgmma.cu"),
                      (hybrid["flash_rows"][2], "flashattn.cu")):
        f32 = row["dtype"] == "float32"
        kernels.append({
            "name": (f"flash_attention_{'f32' if f32 else 'tc'}[hybrid prefill: {HYBRID_ARCH} "
                     f"B={row['B']} S={row['S']} window {row['window']}]"),
            "route": "cuda",
            "source": f"src/repro_torch/kernels/flashattn/csrc/{what}",
            "entry": row["kernel"],
            "replaces": "src/repro/kernels/flashattn/kernel.py:87",
            "launches": (hybrid["long"]["truth_flash_f32_launches"] if f32 else
                         hybrid["w4kv8"]["flash_tc_launches"]
                         + hybrid["long"]["flash_tc_launches"]),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_backend": row["library_backend"],
            "causal_ms": row["causal_ms"],
            "max_row_rel": row["max_row_rel"],
            "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} "
                     f"{row['dtype']} causal, window {row['window']}, q_offset 0; launches: "
                     + ("run B's float32 truth forward (the reference's chunked_attention, "
                        "src/repro/models/layers.py:203)" if f32 else
                        "the W4KV8 prefills of runs A and B, one per attention layer (the "
                        "reference computes chunked_attention, src/repro/models/layers.py:203)")
                     + "; library: SDPA with the band as a boolean mask; causal_ms: the same "
                     "call without the window",
        })
    ssm = report["ssm"]
    for row in ssm["qmm_rows"]:
        shape = f"{row['N']}x{row['K']}"
        kernels.append({
            "name": f"qmm[ssm decode: {SSM_ARCH} W4 {row['shape']}]",
            "route": "cuda",
            "source": lm_source,
            "entry": report["kernel"]["entry"],
            "replaces": "src/repro/kernels/qmm/kernel.py:265",
            "launches": (ssm["w4"]["qmm_launches_by_shape"][shape]
                         + ssm["long"]["qmm_launches_by_shape"][shape]),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bytes_bound_ms": row["bytes_bound_ms"],
            "library_ms": row["library_ms"],
            "shape": f"M={row['M']} N={row['N']} K={row['K']} bits={row['bits']}, layer 0's "
                     f"{row['shape']} codes on bf16 x (timed); launches: the W4 runs' decode "
                     "steps (A and B), all 48 layers; library: torch.matmul on the dequantized "
                     "bf16 weight (the reference computes materialize, "
                     "src/repro/models/ssm.py:55 and :179, then u @ w)",
        })
    train, train_k = report["train"]["run"], report["train"]["kernels"]
    hs = train_k["hsthresh"]
    kernels.append({
        "name": f"hsthresh[train: {TRAIN_ARCH} IHT projection, MLP wi leaf]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh_fused.cu",
        "entry": "repro_hsthresh",
        "replaces": "src/repro/kernels/hsthresh/kernel.py:48 and :69 (hist_pallas, "
                    "mask_pallas and the jnp pick and fill between them)",
        "launches": train["launches"]["repro_hsthresh"],
        "max_abs_err": hs["wi"]["max_abs_err"],
        "ms": hs["wi"]["ms"],
        "plain_ms": hs["wi"]["plain_ms"],
        "bound_ms": hs["wi"]["bound_ms"],
        "bound_by": hs["wi"]["bound_by"],
        "library_ms": None,
        "embed_ms": hs["embed"]["ms"],
        "embed_plain_ms": hs["embed"]["plain_ms"],
        "shape": f"B=1 N={hs['wi']['N']} s={hs['wi']['keep']} nbins={TRAIN_NBINS} (one "
                 f"cluster), the first step's dense leaf; embed_*: N={hs['embed']['N']}; both "
                 "held bit for bit against hsthresh_ref; "
                 "launches: every eligible leaf of every step of the train phase's run",
    })
    sq = train_k["sqround"]
    kernels.append({
        "name": f"sqround[train: {TRAIN_ARCH} Q8 gradient chunks]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sqround/csrc/sqround.cu",
        "replaces": "src/repro/kernels/sqround/kernel.py:49",
        "launches": train["launches"]["repro_sqround"],
        "max_abs_err": sq["max_abs_err"],
        "ms": sq["ms"],
        "plain_ms": sq["plain_ms"],
        "bound_ms": sq["bound_ms"],
        "bound_by": sq["bound_by"],
        "library_ms": None,
        "words_ms": sq["words_ms"],
        "shape": f"R=1 C={sq['N']} bits={TRAIN_GRAD_BITS} (the first step's first chunk of "
                 "the largest gradient leaf); "
                 "launches: every chunk of every gradient leaf of every step of the train "
                 "phase's run; words_ms: the threefry words of one chunk",
    })
    row = train_k["flash"]
    kernels.append({
        "name": f"flash_attention_tc[train forward: {TRAIN_ARCH} B={row['B']} S={row['S']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
        "entry": "repro_flash_attention_tc",
        "replaces": "src/repro/kernels/flashattn/kernel.py:87",
        "launches": train["launches"]["repro_flash_attention_tc"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "max_row_rel": row["max_row_rel"],
        "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} bf16 "
                 "causal; launches: the train phase's run, two per layer a step (the forward "
                 "and the remat recompute; the reference trains through chunked_attention's "
                 "custom VJP, src/repro/models/layers.py:145-200)",
    })
    for tag, arch in (("train_hybrid", TRAIN_HYBRID_ARCH), ("train_ssm", TRAIN_SSM_ARCH)):
        run, ks = report[tag]["run"], report[tag]["kernels"]
        hs, sq = ks["hsthresh"], ks["sqround"]
        kernels.append({
            "name": f"hsthresh[{tag}: {arch} IHT projection, {hs['wi']['leaf']}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh_fused.cu",
            "entry": "repro_hsthresh",
            "replaces": "src/repro/kernels/hsthresh/kernel.py:48 and :69 (hist_pallas, "
                        "mask_pallas and the jnp pick and fill between them)",
            "launches": run["launches"]["repro_hsthresh"],
            "max_abs_err": max(hs["wi"]["max_abs_err"], hs["embed"]["max_abs_err"]),
            "ms": hs["wi"]["ms"],
            "plain_ms": hs["wi"]["plain_ms"],
            "bound_ms": hs["wi"]["bound_ms"],
            "bound_by": hs["wi"]["bound_by"],
            "library_ms": None,
            "embed_ms": hs["embed"]["ms"],
            "embed_plain_ms": hs["embed"]["plain_ms"],
            "embed_bound_ms": hs["embed"]["bound_ms"],
            "shape": f"B=1 N={hs['wi']['N']} s={hs['wi']['keep']} nbins={TRAIN_NBINS} (one "
                     f"cluster), the first step's dense leaf; embed_*: N={hs['embed']['N']}; both "
                     f"held bit for bit against hsthresh_ref; launches: every eligible leaf "
                     f"({run['eligible_leaves']}) of every step of the {tag} phase's run",
        })
        kernels.append({
            "name": f"sqround[{tag}: {arch} Q8 gradient chunks]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/sqround/csrc/sqround.cu",
            "replaces": "src/repro/kernels/sqround/kernel.py:49",
            "launches": run["launches"]["repro_sqround"],
            "max_abs_err": sq["max_abs_err"],
            "ms": sq["ms"],
            "plain_ms": sq["plain_ms"],
            "bound_ms": sq["bound_ms"],
            "bound_by": sq["bound_by"],
            "library_ms": None,
            "words_ms": sq["words_ms"],
            "shape": f"R=1 C={sq['N']} bits={TRAIN_GRAD_BITS} (the first step's first chunk of "
                     f"the largest gradient leaf); launches: every chunk "
                     f"({run['sqround_chunks_per_step']} a step) of every step of the {tag} "
                     f"phase's run; words_ms: the threefry words of one chunk",
        })
        if "flash" not in ks:
            continue
        row = ks["flash"]
        kernels.append({
            "name": (f"flash_attention_tc[{tag} forward: {arch} B={row['B']} S={row['S']} "
                     f"window {row['window']}]"),
            "route": "cuda",
            "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
            "entry": "repro_flash_attention_tc",
            "replaces": "src/repro/kernels/flashattn/kernel.py:87",
            "launches": run["launches"]["repro_flash_attention_tc"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "max_row_rel": row["max_row_rel"],
            "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} "
                     f"bf16 causal, window {row['window']}; launches: the {tag} phase's run, two "
                     f"per attention layer a microbatch (the forward and the remat recompute; "
                     f"the reference trains through chunked_attention's custom VJP, "
                     f"src/repro/models/layers.py:145-200); library: SDPA with the band as a "
                     f"boolean mask; bound: the band's pairs",
        })
    for tag, arch in (("encdec", ENCDEC_ARCH), ("vlm", VLM_ARCH)):
        phase = report[tag]
        by_shape = phase["w4kv8"]["qmm_launches_by_shape"]
        for row in phase["qmm_rows"]:
            shape = f"{row['N']}x{row['K']}"
            kernels.append({
                "name": f"qmm[{tag} decode: {arch} W4 {row['shape']} ({shape})]",
                "route": "cuda",
                "source": lm_source,
                "entry": report["kernel"]["entry"],
                "replaces": "src/repro/kernels/qmm/kernel.py:265",
                "launches": by_shape.get(shape, 0),
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bytes_bound_ms": row["bytes_bound_ms"],
                "library_ms": row["library_ms"],
                "shape": f"M={row['M']} N={row['N']} K={row['K']} bits={row['bits']}, layer 0's "
                         f"{row['shape']} codes on bf16 x (timed); launches: the W4KV8 run's "
                         "decode steps, every product of this shape in every layer; library: "
                         "torch.matmul on the dequantized bf16 weight",
            })
        for row in phase["flash_rows"]:
            key = str((LM_BATCH, row["Hq"], row["Hkv"], row["Sq"], row["Sk"], row["D"], 0, 0))
            kernels.append({
                "name": (f"flash_attention_tc[{tag}: {arch} B={row['B']} {row['Sq']}x{row['Sk']} "
                         f"{'causal' if row['causal'] else 'non-causal'}]"),
                "route": "cuda",
                "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
                "entry": row["kernel"],
                "replaces": "src/repro/kernels/flashattn/kernel.py:87",
                "launches": phase["w4kv8"]["flash_tc_launches_by_shape"].get(key, 0),
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library_backend": row["library_backend"],
                "route_ms": row["route_ms"],
                "max_row_rel": row["max_row_rel"],
                "vs_f32_kv_max_row_rel": row.get("vs_f32_kv", {}).get("max_row_rel"),
                "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} Sq={row['Sq']} "
                         f"Sk={row['Sk']} D={row['D']} bf16 "
                         f"{'causal' if row['causal'] else 'non-causal'}"
                         + (", K/V float32 cast to bf16 by the route (route_ms)"
                            if row["kv_dtype"] == "float32" else "")
                         + "; launches: the W4KV8 run (encode and prefill); library: SDPA on the "
                           "bf16 inputs (the reference computes chunked_attention, "
                           "src/repro/models/layers.py:203)",
            })
    moe = report["moe"]
    for row in moe["qmm_rows"]["batched"]:
        experts = row["kernel"] == "QMM_EXPERTS"
        key = f"{row['E']}x{row['N']}x{row['K']}"
        kernels.append({
            "name": (f"{'qmm_experts' if experts else 'qmm_batched'}[moe: {MOE_ARCH} W4 "
                     f"{row['shape']} E={row['E']} C={row['C']} rows={row['rows']}]"),
            "route": "cuda",
            "source": ("src/repro_torch/kernels/qmm/csrc/qmm_experts.cu" if experts
                       else lm_source),
            "entry": "repro_qmm_experts" if experts else "repro_qmm_tc_batched",
            "replaces": "src/repro/kernels/qmm/kernel.py:265",
            "launches": (moe["w4kv8"]["qmm_experts_launches_by_shape"].get(key, 0) if experts
                         else moe["w4kv8"]["truth_qmm_batched_launches_by_shape"].get(key, 0)),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bytes_bound_ms": row["bytes_bound_ms"],
            "library_ms": row["library_ms"],
            "shape": f"E={row['E']} C={row['C']} N={row['N']} K={row['K']} bits={row['bits']}, "
                     f"layer 0's {row['shape']} stack, rows in use {row['rows_in_use']} "
                     f"({row['experts_in_use']} experts; {row['rows']}), bf16 x"
                     + ("" if experts else " read as float32 (the route of float32 "
                        "activations)")
                     + "; launches: the W4KV8 run's "
                     + ("prefill and decode steps" if experts else "float32 truth")
                     + ", every expert product of this shape (wi_gate's is also wi_up's; the "
                     "reference computes materialize, then einsum('ecd,edf->ecf'), "
                     "src/repro/models/moe.py:56-58); library: torch.bmm on the stack "
                     "materialized to bf16; bound: the codes and scales of the experts in use, "
                     "x's rows in use and f32 y, or one bf16 pass over the rows in use",
        })
    row = moe["qmm_rows"]["attention"]
    kernels.append({
        "name": f"qmm[moe decode: {MOE_ARCH} W4 attention wq]",
        "route": "cuda",
        "source": lm_source,
        "entry": report["kernel"]["entry"],
        "replaces": "src/repro/kernels/qmm/kernel.py:265",
        "launches": moe["w4kv8"]["qmm_launches"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bytes_bound_ms": row["bytes_bound_ms"],
        "library_ms": row["library_ms"],
        "shape": f"M={row['M']} N={row['N']} K={row['K']} bits={row['bits']}, layer 0's wq "
                 "codes on bf16 x (timed); launches: the W4KV8 run's decode steps, all four "
                 "attention products of all 48 layers; library: torch.matmul on the dequantized "
                 "bf16 weight",
    })
    row = moe["flash_row"]
    kernels.append({
        "name": f"flash_attention_tc[moe prefill: {MOE_ARCH} B={row['B']} S={row['Sq']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
        "entry": row["kernel"],
        "replaces": "src/repro/kernels/flashattn/kernel.py:87",
        "launches": moe["w4kv8"]["flash_tc_launches"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_backend": row["library_backend"],
        "max_row_rel": row["max_row_rel"],
        "shape": f"B={row['B']} Hq={row['Hq']} Hkv={row['Hkv']} S={row['Sq']} D={row['D']} bf16 "
                 "causal; launches: the W4KV8 run's prefill, one per layer",
    })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
