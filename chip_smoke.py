"""Drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. env: torch, CUDA, nvcc and Triton versions; the card's name and power
   limit; the builds of the seven CUDA C++ libraries (csrc/bn_bwd_reduce.cu,
   csrc/causal_attention.cu, csrc/paged_attention.cu,
   csrc/attention_f32.cu, csrc/int8_matmul.cu, csrc/lstm_recurrence.cu
   (the recurrence engine: the LSTM, GRU, Graves and simple RNN cells) and
   csrc/dropout.cu, one nvcc each, started together: seconds,
   and ptxas's registers and spills per kernel); the bf16 attention
   kernels' SASS (``cuobjdump -sass``): wgmma (HGMMA) and TMA loads
   (UTMALDG) and no mma.sync (HMMA) at every head dim, 0 spill bytes at
   head dim 128; the float32 attention kernels' SASS (dense, paged, and
   paged over an int8 cache): tf32 mma.sync (HMMA ... TF32) and no other
   HMMA, at every head dim; the paged cluster kernels'
   (csrc/paged_attention.cu: the decode and the verify kernel, float32
   and float64 over a cache of their type or an int8 one, every head dim):
   ptxas's registers and spills side by side, and in their SASS the bulk
   copy and the cluster's shared-memory pushes and barrier, by opcode;
   the int8 kernel's (csrc/int8_matmul.cu, both layouts, every tile's
   rows, 2 and 8 ranks): registers and spills, wgmma, TMA, async copies,
   pushes and mbarrier waits in its SASS and no mma.sync.
2. kernels: the BN(+ReLU) backward's kernels against their plain PyTorch
   versions on the card (bf16 and f32, ReLU on and off; the TPU spike's
   three shapes, ResNet-50's stem, a ragged shape, and a dy that arrives
   in NCHW layout): phase 1 (CUDA C++, with its fold: five outputs, two
   calls bit-equal) and phase 2 (Triton).
3. kernels: the attention kernels (forward; backward's delta, dk/dv and
   dq) each against its plain version on the same inputs, and end to end
   through autograd against ``sdpa_plain``; two calls bit-equal. Cases:
   the GPT path's shape (16, 12, 512, 128) bf16 causal at build_gpt's
   strides, ragged lengths (1, 77, 200) with head_dim 64 and 16,
   non-causal, Sq < Sk, Sq > Sk with fully masked rows, the bf16 kernels'
   tile edges (127, 128, 129, 257 at head dims 16-128), float32 and
   float64; float32's forward is csrc/attention_f32.cu's 3xTF32 kernel
   (its launches checked), also at the dense prefill's serving shape
   (1, 12, 512, 128), its tile edges (63, 64, 65, 127, 129) and ragged
   Sq < Sk and Sq > Sk at head dims 16 and 128, its stats feeding the
   float32 backward; bf16 and float32 control readings (a causal mask off
   by one, a dropped key tile must be rejected); q, k, v and dO whose rows
   are not on 16 bytes, which the wrappers copy (counted) before TMA
   reads them.
4. parity: ResNet-50 at 32x32, 4 classes, TF32 off: two ``fit`` steps on
   the card (kernels) and on the CPU (plain versions) from the same
   weights, in float64 (every tensor's change, every running statistic
   and both losses, card against CPU) and in float32 (held to the
   float64 step).
5. parity: GPT_TINY in float64, card (attention kernels' float64 path)
   against CPU: every gradient, then three Adam steps, to 1e-6 per
   tensor.
6. main path: ResNet-50 at 224x224, 1000 classes, batch 128, bf16
   MixedPrecision, the zoo conf's Nesterovs, through ``ResNet50(...).conf()``
   -> ``ComputationGraph(conf).init()`` ->
   ``net.fit(DeviceCachedIterator, epochs=1)``: a warm-up epoch (two
   warm-up steps, the capture of the epoch's STEPS steps as one CUDA
   graph, one replay), then a timed epoch, one replay (``last_fit_stats``:
   one replay, no capture), in which every kernel of the path must launch
   (33 + 20 BN layers, two phases each: a replay adds to the wrappers'
   counts what its capture recorded), peak memory and what the graph's
   pool holds, and the replayed epoch under ``torch.profiler`` (busy ms a
   step, idle share, device launches a step, device time by kind with the
   updater's share, each BN kernel 33 or 20 times a step). Then windows
   of 4 (``fused_steps=4``, two replays an epoch) and the per-step tier
   (a listener) warmed up, the three tiers timed in alternating runs
   (scanned, windows, per-step, then back), and windows and two per-step
   steps profiled.
7. tiers and parity: two scanned fits of phase 6's configuration from
   one start, bit-equal in every parameter, running statistic and step
   loss (else the phase sets ``torch.backends.cudnn.deterministic`` and
   says so); the scanned and per-step tiers from the same weights over
   STEPS steps, within rtol 1e-5 / atol 1e-6 (the JAX package's tier
   tolerance), and whether bit-equal; phase 4's ResNet-50 at 32x32 in
   float64, TF32 off: the card's scanned tier (one window of two steps)
   against its per-step tier (the tier rule; bit-equal or not, and again
   with cuDNN deterministic where not), and against the CPU's per-step
   tier over those two steps to 1e-6 (phase 4's bound).
8. main path: GPT-medium (hidden 1536, 16 layers, 12 heads of 128, ffn
   6144, vocab 32768) at batch 16, seq 512, bf16 MixedPrecision, Adam(1e-4),
   through ``build_gpt`` -> ``SameDiff.fit(DeviceCachedIterator)``, as
   ``bench.py`` runs it: no listener, so the scanned tier (the epoch's
   GPT_STEPS steps captured once as a CUDA graph, replayed once an
   epoch). On ``bench.py``'s data (ids and targets uniform over the
   vocabulary), one warm-up epoch (warm-up steps, capture, one replay),
   then a timed epoch over the same batches (step ms, tokens/s, peak
   memory, the loss per step, which must be finite and fall) in which
   the attention kernels must launch 2 x 16 times (forward and remat
   re-forward) and 16 times (each backward kernel) a step, with no copy
   of q, k, v or dO: a replay adds to the wrappers' counts what its
   capture recorded, and one more epoch under ``torch.profiler`` must
   hold as many of each kernel as the wrappers counted (device launches,
   busy time and idle share of the replay). Then the per-step tier (the
   same batches as a list) as the yardstick: a warm-up epoch, a timed
   epoch with the same launch rule, and two steps under
   ``torch.profiler``: device launches, busy time and idle share, and
   device time by group (attention, matmul, layer norm, CE tail, Adam,
   casts, ...).
9. path shapes: at each shape, dtype, ReLU flag and dy layout the main
   path gave the BN kernels, each kernel against its plain version, then
   timed alone as phase 10 times attention (cold L2; the median of 20 calls
   queued behind a device sleep) with its plain version and, where one
   PyTorch call computes the same function, that call, summed over one
   training step, beside the least time the card could take (bytes over
   the card's memory rate).
10. path shape: each attention kernel timed alone (cold L2; the median of
   20 calls queued behind a device sleep, so that no host time enters)
   at the GPT path's shape and strides, with its plain version, beside
   its bound (operations at 989 TFLOP/s bf16, bytes at the card's memory
   rate) and the library yardstick ``F.scaled_dot_product_attention(...,
   is_causal=True)`` forward and backward timed the same way (never
   called by the port): kernel/library ratios, TFLOP/s, the host's time
   of a forward call, of its launch alone, and of encoding its three
   tensor maps.

11. kernels: the paged decode cluster kernel (csrc/paged_attention.cu)
   against its plain versions: ``paged_decode_attention`` (the step's K/V
   write, then the attention) at GPT-medium decode (8 lanes x 12 heads of
   128, blocks of 16, last keys 0..1023, one lane inactive) and at block
   sizes 1, 16 and 1024 x head dims 16-128, float32 and float64: per
   element within 1e-5 / 1e-12 of the sum of absolute terms, the caches
   after the write bit-equal to the plain write's, two calls bit-equal,
   dense = paged bits, NaN in the null block, unused blocks, past each
   lane's last key and where the step writes changing nothing, and
   controls that must fail the rule (a write one offset off, one chunk of
   16 keys dropped); ``paged_attention`` (no write, the same kernel) at
   GPT-medium decode and block sizes 1-1024 at head dims 16-128, last keys
   0, at block edges and in a partly filled last block, float32 and
   float64. The prefill function ``paged_prefill_attention``
   (float32: csrc/attention_f32.cu's kernel; float64: paged_attention):
   GPT-medium's prefill (512 rows after a 256-token prefix, and cold);
   the float32 kernel at hist 0, 15, 256, 1000 x rows 1, 63, 64, 65, 512
   x blocks of 1, 16, 160, 1024, and at head dims 16-64, as the server
   calls it and at two other work splits; views off 16 bytes copied and
   counted. Per element within 1e-5 / 1e-12 of the sum
   of absolute terms; controls (a mask off by one, a table entry one
   block off) must fail the rule; two calls bit-equal, dense = paged bits
   (decode), NaN in the null block, unused blocks and past each lane's
   last key changes nothing.
12. parity: GPT_TINY through ``PagedGenerativeServer`` (float64 and
   float32) and ``GenerativeServer`` (float32) on the card and on the CPU
   (plain attention), a prefix hit among the prompts: identical greedy
   tokens, every dispatch's logits within 1e-12 (float64) or 1e-5
   (float32) of their magnitude; the float32 runs go through the float32
   attention kernels on the card.
13. main path: GPT-medium float32 (``build_gpt(GPT_MEDIUM, ..., seed=0)``)
   served through ``gpt_paged_spec`` by ``PagedGenerativeServer(max_slots=8,
   block_size=16, max_seq_len=1024)``: 32 requests (prompts 16-512, a
   256-token shared prefix for 8, 80% of budgets 2-8 and 20% 64-128),
   temperature 0, through ``submit`` / ``result()``; paged_decode_attention
   must launch 16 times a decode step and paged_prefill_f32 16 times a
   prefill (and nothing else of the attention kernels); every request
   against
   ``greedy_decode``
   (a differing token only at a near tie, top-2 margin below 1e-4 of the
   logits' scale); the pool drains clean; tokens/s, TTFT (cold, prefix
   hit), inter-token and decode-step times, peak memory. Then the dense
   ``GenerativeServer`` over ``gpt_generative_spec`` serves 8 of them,
   each against ``greedy_decode``: its prefill launches attention_fwd_f32
   (attention_fwd's scalar kernel 0 times), its decode
   paged_decode_attention. Then ~20 decode steps under
   ``torch.profiler``: device launches and busy time a step, the idle
   share against the same steps' wall time, device time by group; the
   paged kernel must launch 16 times a step and no ``index_put_`` kernel
   (the K/V write is inside it); then 3 paged and 3 dense prefills of 512
   rows:
   the float32 attention kernels' launches (main and combining, each
   count equal to the wrappers') and device time a prefill.
14. path shapes: every shape the serving run handed the paged functions,
   checked against its plain version; paged_decode_attention timed alone
   at decode (8 lanes at context 128, 512, 1024) beside the same kernel
   with no write, its plain version, its bound and the library's masked
   ``F.scaled_dot_product_attention`` over the dense slab; the two float32
   prefill kernels at their serving shapes
   (the paged prefill, 512 rows after 256 cached keys; the dense forward
   (1, 12, 512, 128) causal) beside the kernels they replace, their plain
   versions, the library and their bound at the 3xTF32 and the float32
   FMA rates.
15. main path: LeNet (``LeNet(28, 28, 1).build()``) at batch 128 on
   ``load_mnist(train=True, n_synthetic=2048)`` with one-hot labels, as
   ``bench.py`` ``bench_lenet`` runs it, through ``net.fit(
   DeviceCachedIterator(X, Y, 128), epochs, listeners, fused_steps)``
   (16 steps an epoch) on SameDiff's three fit tiers: the scanned epoch
   (no listener; one CUDA graph replay an epoch), windows of 8 (a
   ``ScoreIterationListener`` and ``fused_steps=8``; two replays) and
   per-step (the listener, ``fused_steps=1``; eager). Each: fit(2) to
   warm up and capture, then the median of 3 timed fit(6) (samples/s,
   step ms), peak memory, then one epoch under ``torch.profiler``
   (device launches and busy time a step, idle share against the timed
   step; the scanned epoch's device time by kernel); the loss finite
   and falling. Then the same for the SameDiff MLP of
   ``bench_samediff_mlp`` (784-512-256-10, Adam(1e-3), 2048 rows). No
   hand-written kernel is on this path. Float32, TF32 at PyTorch's
   defaults (cuDNN on, cuBLAS off) on every tier.
16. tiers and parity: two scanned LeNet runs from one start bit-equal
   (else the phase sets ``torch.backends.cudnn.deterministic`` and says
   so); the windowed and scanned tiers against the per-step tier over 2
   epochs from LeNet's seed and the same batches, every parameter and
   every step's loss within rtol 1e-5 / atol 1e-6 (the JAX package's
   tier tolerance), and so an 11-step epoch (windows 8 + 2 + 1) and a
   ``set_param`` between two fits (it drops the windows, and the next
   fit captures its window again); a control whose alphat buffer is
   filled at a window's first replay and never again must fail that
   rule. Then LeNet in float64 at batch 16, TF32 off: the card's
   per-step and windowed tiers against the CPU's per-step tier, every
   gradient and then 3 Adam steps to 1e-6 of each tensor.
17. kernels: ``int8_matmul`` (csrc/int8_matmul.cu) against its plain
   version in float64 at GPT-medium's four (K, N) and the transposed
   ``wte`` at M 1-512 across every tile edge (within 1e-5 of the sum of
   absolute terms; NaN-poisoned output memory; two calls bit-equal; a
   dropped K tile must fail the rule), its rows bit-equal across those
   M, and five shapes off GPT-medium's (partial K and N tiles through the
   tensor map, plain loads); then ``paged_verify_attention``
   (csrc/paged_attention.cu's verify kernel) against
   ``paged_verify_plain``: 8 lanes x W 1-20 x 12 x 128 float32, windows
   from positions 0, 15 (straddling a block edge), 128, 512, 1000, blocks
   of 16 (and the dense slab at six W), inactive lanes, head dims 16-64
   and float64, blocks of 5; the written cache bit-equal, two calls
   bit-equal,
   every row bit-equal to ``paged_decode_attention`` at its last key, NaN
   where no row may read changes nothing; controls (a row one key too
   far, the window read from the cache before the write) must fail. Then
   both timed alone (``median_ms``) beside their plain versions, the
   library (``torch.matmul`` with the dequantised weight; masked
   ``F.scaled_dot_product_attention``) and their bounds: int8_matmul at
   each shape and M, the verify at 8 lanes x W 8 at contexts 64, 128,
   512 and 1016 and at two launches of phase 19's traffic (``verify_mixes``:
   its first round, and a round of its long tail).
18. parity: GPT_TINY speculative serving on the card and on the CPU
   (plain kernels), the dense and the paged server, float32 and int8
   weights, an independent 1-layer draft from seed 1 (rejections run):
   identical tokens, every target dispatch's logits within 1e-5 of their
   magnitude.
19. main path: GPT-medium (``build_gpt(GPT_MEDIUM, ..., seed=0)``, layers
   1-15's residual-out projections zeroed: ``bench.py``'s self-draft
   pairing) as an int8-weight target (``gpt_paged_spec(...,
   quantize_weights=True)``) with a 1-layer int8 self-draft through
   ``PagedGenerativeServer(max_slots=8, block_size=16, max_seq_len=1024,
   draft_spec=..., speculate_k=8)``: phase 13's 32 requests at
   temperature 0 through ``submit`` / ``result()``; counts set to 0 just
   before and read just after: 16 paged_verify_attention launches a
   round, 65 int8_matmul a target prefill, step or verify and 5 a draft
   dispatch, paged_decode_attention 16 a plain step and 1 a draft
   decode; every request against ``greedy_decode`` of the dense int8
   target (phase 13's near-tie rule); the pool drains. Then ~10 rounds
   under ``torch.profiler`` (device busy and wall a round, idle share,
   launches a round, device time by group; the traced int8_matmul and
   cluster kernels equal the wrappers' counts), three 512-row prefills of
   the int8 target under the profiler (the int8 GEMM's device time and
   launches a prefill), the same requests on the int8 target without a
   draft (the yardstick), and 8 requests through a
   float32 target with a float32 self-draft, each against
   ``greedy_decode``.
20. parity: BERT_TINY (batch 4, seq 16) in float64, written once as a
   frozen GraphDef (``build_bert_graphdef``) and imported by ``bert_base``
   on the card and on the CPU, a ragged mask and both token types: every
   gradient, then three Adam steps through ``fit`` (the card's scanned
   tier: one replay), each tensor to 1e-6 of its magnitude (the
   attention's key biases, whose gradient is zero but for rounding: below
   1e-9 of the largest gradient on both sides, within 1e-8 of zero after
   the steps).
21. main path: BERT-base (``BERT_BASE``: vocab 30522, hidden 768, 12
   layers, 12 heads of 64, ffn 3072) at batch 16, seq 128, 2 labels,
   Adam(2e-5), bf16 MixedPrecision, as ``bench.py`` ``bench_bert_base``
   runs it: ``bert_base`` writes the GraphDef and imports it with the
   port's TF importer (seconds, ops), then ``SameDiff.fit(
   DeviceCachedIterator([ids, mask, tt], [labels], 16))`` over 16 steps:
   a warm-up epoch (the capture; the dtype of
   ``bert/encoder/sequence_output`` inside the bf16 step, which must be
   float32), a warm-up of the per-step tier, then from one saved state a
   timed scanned epoch (one replay, no capture) and a timed per-step
   epoch, whose losses, parameters and Adam state must be bit-equal
   (samples/s, step ms, peak memory, the graph pool), then one replay
   under ``torch.profiler``: device launches, busy time and idle share a
   step, device time by kernel group (matmul, elementwise, reductions,
   softmax, gather/one-hot/scatter, Adam); then the scanned epoch once
   more, captured again with TF32 allowed in float32 matmuls (PyTorch's
   default, kept by the port, is off): what float32 without TF32 costs.
   No hand-written kernel is on this path.
22. kernels: the decode, verify and paged prefill kernels over an int8
   cache (per-(head, channel) absmax scales of a random float cache)
   against their plain versions: the decode at GPT-medium decode (8 lanes
   x 12 x 128, blocks of 16, contexts 64-1016, one lane inactive) in
   float32 and float64 and at blocks of 1, 5, 16 and 1024 x head dims
   16-128; the verify at 8 lanes x W 8 x 12 x 128 in float32 and float64,
   at W 1, 3 and 20, blocks of 5 and the dense slab; the prefill (float32:
   csrc/attention_f32.cu's int8 form; float64: the decode kernel with no
   write) at 512 rows after 256 cached keys and at hist 0-1000 x rows
   1-512 x head dims 16-128. Per element within 1e-5 / 1e-12 of the sum of
   its absolute terms, the written int8 cache bit-equal to the plain
   write, two calls bit-equal, -128 where the step writes changing
   nothing, verify rows bit-equal to the int8 decode, each launch counted
   as int8. Then each timed alone (``median_ms``) beside the same kernel
   over the float32 cache, its plain version, the library (the gathered
   context dequantised, then masked ``F.scaled_dot_product_attention``)
   and its bound at int8 bytes: the decode at 8 lanes at context 128, 512
   and 1024, the verify at W 8 from 64, 128, 512 and 1016, the prefill of
   512 rows after 256.
23. parity: GPT_TINY with int8 KV through ``PagedGenerativeServer``
   (float32 and float64) and ``GenerativeServer`` (float32) on the card
   and on the CPU from one set of scales (calibrated on the CPU):
   identical tokens, every dispatch's logits within 1e-4 (float32) or
   1e-10 (float64) of their magnitude, the int8 kernels launched.
24. main path: GPT-medium (``build_gpt(GPT_MEDIUM, ..., seed=0)``) with
   int8 weights and an int8 KV cache, ``gpt_paged_spec(...,
   quantize_weights=True, quantize_kv=True)`` (``gpt_kv_scales``'
   calibration timed), through ``PagedGenerativeServer(max_slots=8,
   block_size=16, max_seq_len=1024)``: phase 13's 32 requests at
   temperature 0 through ``submit`` / ``result()``, the int8 counts set to
   0 just before and read just after (16 int8 decode launches a step, 16
   int8 paged prefills a prefill), the pool drains; the dense int8
   ``GenerativeServer`` on 8 of them, each equal to ``greedy_decode`` of
   its spec (phase 13's near-tie rule); token agreement with the float32
   paged server (reported); a profiled pass of ~20 decode steps (phase
   13's); the pool at 49 float32 blocks' bytes, int8 against float32 (at
   least 1.9x), and ``bench_serving_quant``'s closed loop (24 requests,
   concurrency 8, prompts 2-16, new tokens 4-24, seed 23, max_seq_len
   256) through ``serving.loadgen.GenerativeLoadGenerator`` on both:
   tokens/s, TTFT and inter-token p50/p99. Then phase 19's self-draft
   pairing with int8 KV: the 32 requests through the target without a
   draft and with the 1-layer int8-weight int8-KV draft at k = 8, the
   latter's 16 int8 verify launches a round, its tokens equal to the
   former's on every request, and a profiled pass of rounds (phase 19's).
   The 32 requests once more through a fresh int8 server under
   ``torch.profiler``: the int8 paged prefill kernel's and its combining
   kernel's device time and launches over the run's prefills, each
   traced count equal to the wrapper's.
25. main path: ResNet-50 (``ResNet50().build()``: 224x224x3, 1000
   classes, float32, on the card with no ``device=``) served through
   ``ParallelInference``, TF32 off, its batch-norm running statistics set
   from 32 seeded images: SEQUENTIAL, INPLACE and BATCHED (2 workers,
   max_batch_size 32, buckets 4-32, max_delay_ms 2) on 24 seeded
   requests of 1-4 images, each within 1e-4 of ``output()`` with its
   top-1; alone and co-batched rows bit-equal at bucket 32; a NaN request
   quarantined with its neighbours served their solo rows; injected exec
   failures open the breaker, which sheds and closes; the warmup's
   seconds, then ``compiles == 0`` over the traffic:
   ``LoadGenerator.run_closed(512, concurrency=8)`` and ``run_open(512)``
   at half its requests/s (images/s, requests/s, latency p50/p99, mean
   batch rows, padding waste); torch.profiler over 20 BATCHED execs at
   bucket 32 (device ms, launches, top kernels, and the idle share of
   that same pass), each bucket's device ms over 20 direct execs, the
   bucket-32 exec against its float32 FMA-rate bound, and with TF32
   allowed. No kernel of the port's own lies on this path.

26. main path: ResNet-50 (phase 6's: 224x224x3, 1000 classes, batch 128,
   bf16 MixedPrecision, seed 0) trained as ImageNet's recipe trains it:
   ``Nesterovs(RampSchedule(StepSchedule(0.1, 0.1, 16), 8), 0.9)``,
   ``L2Regularization(1e-4)``, ``accum_steps=2`` (an effective batch of
   256), ``fused_steps=4``, ``sentinel=True``, over 24 seeded batches on
   the card keyed by the iteration (``StepSource``). A warm-up captures
   the window and the start is restored in place. A: the 24 steps with a
   ``CheckpointListener`` every 8 (step ms, each capture's device-to-host
   ms, each commit's seconds, the checkpoint bytes, the windows captured;
   the BN kernels' 33 + 20 launches a step, counts set to 0 just before).
   B: from the same start, ``FaultTolerantFit`` (checkpoints every 8,
   ``RetryPolicy(backoff_base=0)``) over a batch poisoned at step 13: the
   sentinel names 13, the run rolls back to 8 with no window captured
   again and ends bit-equal to A (parameters, running statistics,
   momentum). C: a new network restored by ``restore_latest`` from A's
   step-16 checkpoint trains the last 8 steps, bit-equal to A (where B or
   C is not, A-C run again with ``torch.backends.cudnn.deterministic``,
   and the phase says so). The step ms with A's options against neither
   the sentinel nor the regularization (alternating runs, no checkpoint),
   a profiled pass with A's options; D: NaN gradients armed at step 5
   raise ``TrainingDivergedError`` naming step 5 from inside a captured
   window. Then phase 4's 32x32 ResNet-50 in float64 with L2, WeightDecay,
   clip_l2_global, a ``RampSchedule(StepSchedule)`` and accum_steps 2 over
   4 iterations: the card's windows of 2 against the CPU's one step a
   batch, to 1e-6 (phase 4's bound). No kernel of this phase is new; the
   checkpoints' directory is deleted.
27. main path: TextGenLSTM (``TextGenLSTM()``: 77 -> LSTM 256 -> LSTM 256
   -> RnnOutputLayer 77, 887,117 parameters, float32, Adam(1e-3), seed
   0) on SURVEY.md's characters in DL4J's 77-character set, 64 sequences
   of 1001 at seeded offsets (one-hot, on the card once), as
   ``LSTMCharModellingExample`` trains it. (i) the LSTM recurrence
   kernels (csrc/lstm_recurrence.cu, forward and backward, one launch a
   layer and direction) against their plain versions at the path's (B, T,
   U) = (32, 50, 256), at (3, 7, 37), (3, 1, 5), (8, 20, 300), (8, 20,
   512) and (4, 3, 4096) (512 and 4096, and 300 in float64: the streamed
   form, W_hh read from L2), float32 and float64, two calls bit-equal;
   (ii) a 16-unit float64 TextGenLSTM, 4 TBPTT chunks, card against CPU
   (parameter change, carried state, loss to 1e-6); (iii)
   ``fit_tbptt`` with tbptt_length = T against ``fit``; (a) ``fit_tbptt``
   at batch 32, TBPTT 50, 2 epochs (20 chunks a minibatch, one CUDA graph
   replay each), the recurrence kernels' counts set to 0 just before and
   read just after (2 + 2 a chunk: a layer each), (v) the loss falling,
   (vii) no capture after the first window; the chunk timed and profiled
   (device launches, busy, idle share, the recurrence kernels' device
   time and no first-design, fused or cuDNN LSTM kernel), ``Evaluation``
   of next-character prediction; (b) ``fit``
   (full BPTT) on sequences of 50 on the scanned, windowed (8) and
   per-step tiers, (iv) agreeing to rtol 1e-5 / atol 1e-6, each timed and
   profiled; (vi) ``save`` -> ``load``: the output, then ``fit`` and
   ``fit_tbptt``, bit-equal; then each recurrence kernel alone over one
   layer's chunk beside its plain version, its bound and its time a step,
   and one layer (the hoisted GEMM and the kernels) forward, backward and
   both against cuDNN's ``nn.LSTM`` (TF32 off), device time.
28. main path: the zoo's convolutional models, float32 with TF32 off.
   (i) the dropout kernel (``csrc/dropout.cu``, built with the others)
   against ``dropout_plain`` bit for bit, forward and backward: AlexNet's
   two shapes and odd sizes, views off 16 bytes, bf16/float32/float64,
   iterations past 2^32; masks differ from iteration to iteration; one
   captured CUDA graph replayed at staged iterations draws theirs; the
   kept fraction within 5 standard deviations of p. (ii) ``YOLO2()``
   (416x416, 20 classes, the five VOC anchors, Adam(1e-3)), batch 16,
   seeded images and three boxes an image on the 13x13 grid, through
   ``ComputationGraph.fit``: the scanned epoch of 8 steps (the BN kernels'
   counts set to 0 before it: 22 + 22 a step, plain BN pairs), windows of
   4 and per-step, each timed; step ms, images/s, a profiled pass
   (device launches, idle share, device time by group) and
   ``yolo2_loss`` timed alone; gates: two scanned runs bit for bit (else
   cuDNN deterministic, said), scanned against per-step by the tier rule,
   the loss falling over 10 steps on one batch, the float64 64x64 YOLO2
   (the JAX test's size) card scanned against CPU per-step to 1e-6.
   (iii) ``AlexNet()`` (224x224, 1000 classes, Nesterovs(1e-2, 0.9),
   dropout 0.5 on its two 4096-unit layers' inputs), batch 128, through
   ``MultiLayerNetwork.fit`` on the three tiers: the masks each drew (a
   device tap) equal, each the plain version's for (seed, iteration,
   node), new each step, their kept fractions; losses by the tier rule; a
   run captured at step 4 and resumed in a new network bit-equal to an
   uninterrupted one; the scanned epoch's dropout launches (2 + 2 a
   step), the tiers timed, a profiled pass. (iv) the dropout kernel
   alone at AlexNet's shapes beside its plain version, ``F.dropout`` and
   its bound (bytes). (v) every other ported model at its published
   input size, batch 8: one per-step step and one ``output``: a finite
   loss, the output's shape, the parameter count. (vi) the streamed
   recurrence kernels (past 384 float32 units) at (32, 50, 512) and (32,
   50, 1024) alone, their bound and cuDNN's ``nn.LSTM`` each way.
29. main path: the recurrent family and ``ComputationGraph``
   save/load/evaluate. (i) the GRU, Graves (peephole LSTM) and simple RNN
   recurrence kernels (the cells of ``csrc/lstm_recurrence.cu``'s cluster
   engine) against their plain
   versions, forward and backward, float32 (1e-5) and float64 (1e-12 of
   the largest magnitude): (B, T, U) = (64, 256, 256), (1, 50, 5), (7,
   50, 100), (64, 1, 16), (7, 50, 384), (64, 50, 512) (streamed), the
   path's case reversed in time, the simple RNN under each of its seven
   activations; two calls bit-equal; (i') the noise kernel
   (``csrc/dropout.cu`` ``dl4j_noise``) of each kind: Bernoulli kinds bit
   for bit, Gaussian kinds within 4 ulp, and the kernel's float32 normals
   within 2^-20 of their magnitude of ``normals_plain``'s
   (``NORMAL_KERNEL_REL``). (ii) the sentiment graph at
   Word2VecSentimentRNN's widths (64 reviews x 256 words x 300 -> noise
   0.1 -> Bidirectional(GRU 256, CONCAT) -> GravesLSTM 256 -> last step
   -> softmax 2; Adam(5e-3), L2 1e-5, element-wise clip 1.0; float32, TF32
   off) on synthetic reviews from seed 0 through ``ComputationGraph.fit``
   on the scanned, windowed (2) and per-step tiers: losses, parameters and
   each step's noise (a device tap) bit-equal; the counts set to 0 before
   the scanned fit; step ms, sequences/s, a profiled epoch (launches,
   idle share, device time by group; no cuDNN RNN kernel); the loss
   falling. (iii) a float64 copy (10 -> 16 units) card vs CPU to 1e-6.
   (iv) a ``MultiLayerNetwork`` at TextGenLSTM's widths (77 ->
   SpatialDropout 0.9 -> SimpleRnn 256 -> GaussianDropout 0.1 ->
   AlphaDropout 0.95 -> Bidirectional(LSTM 256, ADD) -> RnnOutput 77)
   through ``fit_tbptt``, chunks of 32 x 50: counts, chunk ms, a profiled
   epoch. (v) the trained sentiment graph saved and loaded onto the card:
   outputs and one more step bit-equal; ``evaluate`` with
   ``Evaluation``, ``ROCMultiClass`` and ``EvaluationCalibration``
   against the host's statistics of ``output``. (vi) phase 6's trained
   ResNet-50 (saved at the end of phase 6) loaded: its output bit-equal.
   Then each new kernel alone at its path's shape beside its plain
   version, its bound and cuDNN's ``nn.GRU``/``nn.RNN``,
   ``F.alpha_dropout`` or ``F.dropout1d`` where they compute the same.

Every idle share is read from one profiled pass: its device busy time
against that pass's own wall time.

The last lines are the kernels' JSON record (``launches`` counts each
kernel's main path's timed run, ``launches_per_step`` one step, and for
the float32 kernels ``combine_launches`` their combining kernel's; the times
are per training step of that path, per decode step for
paged_decode_attention and its int8 form,
per 512-row prefill for the float32 prefill kernels and the int8 paged
prefill, per speculative round for int8_matmul and paged_verify_attention
and its int8 form, per TBPTT chunk for the LSTM cell kernels, per
AlexNet step for the dropout kernels, per sentiment step for the GRU and
Graves recurrences and the Gaussian noise, per TBPTT chunk of phase 29's
network for the simple RNN and the other noise kinds),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Nothing of JAX or of the JAX package is imported.
"""
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels.measure import (
    BF16_TC_FLOPS, attention_bounds, attention_inputs, card_rates,
    forward_macs, median_ms, ptxas_spills, ptxas_usage, queued_ms,
    sass_counts, sass_kernels, set_running_stats, synced_ms,
    tensor_map_encode_us, two_rate_bound)

STEPS = 8
BATCH = 128
REPLACES = {1: "experiments/pallas_bn_spike.py:87",
            2: "experiments/pallas_bn_spike.py:115"}
ROUTE = {1: ("cuda", "deeplearning4j_tpu_torch/csrc/bn_bwd_reduce.cu"),
         2: ("triton", "deeplearning4j_tpu_torch/kernels/bn_relu_triton.py")}
#: device launches per training step measured on an H100 when phase 1 was
#: a Triton kernel followed by its fold in PyTorch ops (PERF.md)
TRITON_PHASE1_LAUNCHES_PER_STEP = 4895


def log(*a):
    print(*a, flush=True)


ATTN_TMA_KERNELS = ("fwd", "bwd_dkdv", "bwd_dq")


def check_attention_build():
    """The bf16 attention kernels as built: at every head dim each has
    wgmma (HGMMA) and TMA loads (UTMALDG) in its SASS and no mma.sync
    (HMMA); at D = 128 ptxas reports 0 spill bytes for each. Prints one
    line a kernel; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import _cuda, attention
    sass = sass_kernels(_cuda.library_path(attention._LIB))
    spills = ptxas_spills(_cuda.build_log(attention._LIB))
    bad = []
    for d in (16, 32, 64, 128):
        for k in ATTN_TMA_KERNELS:
            tag = f"attention_{k}_bf16ILi{d}E"
            name = next((n for n in sass if tag in n), None)
            if name is None:
                bad.append(f"{tag}: not in the library")
                continue
            hg, tma, depbar = sass_counts(sass[name])
            sp = spills.get(name)
            ok = hg > 0 and tma > 0 and "HMMA" not in sass[name] and (
                d != 128 or sp == (0, 0))
            log(f"    attention_{k}_bf16<{d}>: HGMMA {hg}, UTMALDG {tma}, "
                f"WARPGROUP.DEPBAR {depbar}, spill stores/loads "
                f"{sp if sp else 'not reported'} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(tag)
    if bad:
        raise SystemExit(f"attention kernels built wrong: {bad}")


def check_attention_f32_build():
    """The float32 attention library as built: the dense and the paged
    kernel of the float engine at every head dim multiply on the tensor
    cores in TF32 (HMMA ... TF32 in their SASS, no other HMMA), with
    ptxas's spills beside; the paged prefill over an int8 cache
    (``prefill_i8_kernel``) at every head dim holds PREFILL_I8_SASS's
    opcodes (wgmma, bulk copies, mbarrier waits) and no mma.sync, with its
    registers and spills. Prints one line a kernel; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import _cuda, attention_f32
    sass = sass_kernels(_cuda.library_path(attention_f32._LIB))
    log_ = _cuda.build_log(attention_f32._LIB)
    spills = ptxas_spills(log_)
    regs = _ptxas_regs(log_)
    bad = []
    for d in (16, 32, 64, 128):
        for paged in (0, 1):
            tag = f"attn_f32_kernelILi{d}ELb{paged}EE"
            name = next((n for n in sass if tag in n), None)
            if name is None:
                bad.append(f"{tag}: not in the library")
                continue
            body = sass[name]
            tf32 = sum(1 for ln in body.splitlines()
                       if "HMMA" in ln and "TF32" in ln)
            other = body.count("HMMA") - tf32
            ok = tf32 > 0 and other == 0
            log(f"    attn_f32_kernel<{d}, {('dense', 'paged')[paged]}>: "
                f"HMMA TF32 {tf32}, other HMMA {other}, spill stores/loads "
                f"{spills.get(name, 'not reported')}, blocks an SM (the "
                f"work split's) "
                f"{attention_f32.blocks_per_sm(d, ('dense', 'paged')[paged])}"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(tag)
        tag = f"prefill_i8_kernelILi{d}EE"
        name = next((n for n in sass if tag in n), None)
        if name is None:
            bad.append(f"{tag}: not in the library")
            continue
        found = {k: sass[name].count(op) for k, op in PREFILL_I8_SASS.items()}
        hmma = sass[name].count("HMMA")
        ok = all(found.values()) and hmma == 0
        log(f"    prefill_i8_kernel<{d}> (paged, int8 cache): "
            f"{regs.get(name, '?')}, spill stores/loads "
            f"{spills.get(name, 'not reported')}; "
            + ", ".join(f"{k} {PREFILL_I8_SASS[k]} x{n}"
                        for k, n in found.items())
            + f", HMMA x{hmma}, blocks an SM "
            f"{attention_f32.blocks_per_sm(d, 'paged_i8')} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(tag)
    if bad:
        raise SystemExit(f"float32 attention kernels built wrong: {bad}")


#: SASS opcodes of the int8 paged prefill's Hopper parts: wgmma, the tiles'
#: bulk copies (cp.async.bulk) and the mbarrier waits on them
PREFILL_I8_SASS = {"wgmma": "HGMMA.", "bulk copy": "UBLKCP",
                   "mbarrier wait": "SYNCS.PHASECHK"}


#: SASS opcodes of the paged decode cluster kernel's Hopper parts: the
#: bulk copy of a chunk (cp.async.bulk), the pushes of a block's partial
#: into rank 0's shared memory (st.async), the cluster barrier's arrive and
#: wait, and the mbarrier waits
PAGED_SASS = {"bulk copy": "UBLKCP", "DSMEM push": "STAS",
              "cluster arrive": "UCGABAR_ARV", "cluster wait": "UCGABAR_WAIT",
              "mbarrier wait": "SYNCS.PHASECHK"}


def _ptxas_regs(log_):
    """Registers per kernel (mangled name) from ptxas's report, as
    "N registers"."""
    return {fn: f"{regs} registers"
            for fn, (regs, _) in ptxas_usage(log_).items()}


def check_paged_build():
    """The paged cluster kernels as built, float32 and float64 at every
    head dim, over a float cache and an int8 one: the decode kernel and the
    verify kernel: ptxas's registers and spills side by side, and each of
    PAGED_SASS's opcodes in its SASS, counted. Prints one line a kernel;
    exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import _cuda
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    sass = sass_kernels(_cuda.library_path(pa._LIB))
    log_ = _cuda.build_log(pa._LIB)
    spills = ptxas_spills(log_)
    regs = _ptxas_regs(log_)
    bad = []
    for t, tc, cc in (("float", "f", "f"), ("double", "d", "d"),
                      ("float, int8", "f", "a"), ("double, int8", "d", "a")):
        for d in (16, 32, 64, 128):
            # the float32 verify over an int8 cache is its own kernel
            verify = (f"paged_verify_i8_kernelILi{d}EE" if (tc, cc) == ("f", "a")
                      else f"paged_verify_kernelI{tc}{cc}Li{d}EE")
            for tag, label in (
                    (f"paged_decode_kernelI{tc}{cc}Li{d}EE", "decode"),
                    (verify, "verify")):
                name = next((n for n in sass if tag in n), None)
                if name is None:
                    bad.append(f"{tag}: not in the library")
                    continue
                found = {k: sass[name].count(op)
                         for k, op in PAGED_SASS.items()}
                ok = all(found.values())
                log(f"    <{t}, {d}> {label:6s}: {regs.get(name, '?')}, "
                    f"spill stores/loads {spills.get(name, 'not reported')}"
                    "; " + ", ".join(f"{k} {PAGED_SASS[k]} x{n}"
                                     for k, n in found.items())
                    + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(tag)
    if bad:
        raise SystemExit(f"paged cluster kernels built wrong: {bad}")


#: SASS opcodes of the int8 kernel's Hopper parts: wgmma, the weight
#: tile's TMA load, x's async copies, the pushes of the partials (st.async)
#: and the mbarrier waits
INT8_SASS = {"wgmma": "HGMMA.", "TMA": "UTMALDG", "async copy": "LDGSTS",
             "DSMEM push": "STAS", "mbarrier wait": "SYNCS.PHASECHK"}


def check_int8_build():
    """The int8 kernel as built, both layouts at each tile's rows (8, 16,
    32, 64) and cluster (2 and 8 ranks): ptxas's registers and spills,
    INT8_SASS's opcodes counted, no mma.sync (HMMA), and what ptxas says
    of serializing the wgmma batch (WARPGROUP.DEPBAR counted). Prints one
    line a kernel; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import _cuda
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    sass = sass_kernels(_cuda.library_path(im._LIB))
    log_ = _cuda.build_log(im._LIB)
    spills = ptxas_spills(log_)
    regs = _ptxas_regs(log_)
    serial = [ln.strip() for ln in log_.splitlines() if "serializ" in ln]
    bad = []
    for layout in (0, 1):
        for rows in im.TILE_ROWS:
            for ranks in (2, 8):
                tag = f"int8_wgmma_kernelILi{layout}ELi{rows}ELi{ranks}E"
                name = next((n for n in sass if tag in n), None)
                if name is None:
                    bad.append(f"{tag}: not in the library")
                    continue
                body = sass[name]
                found = {k: body.count(op) for k, op in INT8_SASS.items()}
                hmma = body.count("HMMA")
                depbar = body.count("WARPGROUP.DEPBAR")
                ok = all(found.values()) and hmma == 0
                log(f"    int8_wgmma_kernel<layout {layout}, rows {rows}, "
                    f"ranks {ranks}>: {regs.get(name, '?')}, spill "
                    f"stores/loads {spills.get(name, 'not reported')}; "
                    + ", ".join(f"{k} x{n}" for k, n in found.items())
                    + f", HMMA x{hmma}, WARPGROUP.DEPBAR x{depbar} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(tag)
    log(f"    ptxas on wgmma serialization: {serial or 'nothing'}")
    if bad:
        raise SystemExit(f"int8 kernel built wrong: {bad}")


# ----------------------------------------------------------------------
def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def bn_inputs(shape, dtype, relu, dev, nchw_dy=False, seed=0,
              gdtype=torch.float32):
    """x channels-last with a per-channel offset, dy, and the forward's
    statistics, on the card; gamma in ``gdtype``. ``shape`` is
    (N, H, W, C)."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, c, h, w, device=dev, generator=g)
         + 2 * torch.randn(1, c, 1, 1, device=dev, generator=g))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(n, c, h, w, device=dev, generator=g).to(dtype)
    if not nchw_dy:
        dy = dy.contiguous(memory_format=torch.channels_last)
    gamma = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(gdtype)
    beta = (0.1 * torch.randn(c, device=dev, generator=g)).to(gdtype)
    _, mean, _, inv, a, b = bn_relu.bn_train_forward(x, gamma, beta, 1e-5,
                                                     relu)
    return x, dy, gamma, mean, inv, a, b


def check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs, label):
    """Both kernels against their plain versions on the same inputs.
    Phase 1's sum-derived outputs are held per channel to 1e-5 of the sum
    of the absolute terms behind them (a float32 sum over R terms in
    another order errs by at most ~log2(R) * 6e-8 of that), plus, for
    dgamma and dbeta in a bf16 gamma's dtype, one unit in its last place
    (one rounding to 8 bits); g = gamma * inv to one unit in its last
    place; two calls must be bit-equal. Phase 2's dx is
    held to 1e-5 (f32) or 8e-3 (bf16: one rounding to 8 bits) of max
    |dx|. Exits on a mismatch."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    got = bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, relu)
    again = bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, relu)
    want = bn_relu.phase1_fold_plain(x, dy, a, b, mean, inv, gamma, relu)
    same = all(torch.equal(p, q) for p, q in zip(got, again))
    dz = bn_relu._masked_dy(x, dy, a, b, relu)
    red = bn_relu._red(x)
    t1 = dz.abs().sum(red).double()
    t2 = (dz * (bn_relu._up(x) - bn_relu._chan(mean, x))).abs().sum(
        red).double()
    del dz
    r, iv = x.numel() // x.shape[1], inv.double()
    e1, abs1 = 0.0, 0.0
    for k, w, terms in zip(got, want, (iv * t2, t1, None, t1 / r,
                                       iv * iv * t2 / r)):
        err = (k.double() - w.double()).abs()
        ulp = torch.finfo(w.dtype).eps * w.double().abs()
        tol = ulp if terms is None else 1e-5 * terms + (
            ulp if w.dtype != mean.dtype else 0.0)
        e1 = max(e1, float((err / tol.clamp_min(1e-300)).max()))
        abs1 = max(abs1, float(err.max()))
    _, _, g, c1, c2 = want
    dx = bn_relu.bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu)
    px = bn_relu.phase2_plain(x, dy, a, b, mean, g, c1, c2, relu)
    torch.cuda.synchronize()
    assert dx.stride() == x.stride(), (dx.stride(), x.stride())
    e2 = rel_err(dx, px)
    tol2 = 1e-5 if x.dtype == torch.float32 else 8e-3
    k1, k2 = bn_relu.kernel_name(1, relu), bn_relu.kernel_name(2, relu)
    errs[k1] = max(errs.get(k1, 0.0), abs1)
    errs[k2] = max(errs.get(k2, 0.0),
                   float((dx.float() - px.float()).abs().max()))
    ok = e1 <= 1 and same and e2 <= tol2
    log(f"  {label}: phase1 {e1:.2e} of its tolerance, bit-equal twice "
        f"{same}  phase2 {e2:.2e} (tol {tol2:g})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("kernel disagrees with its plain version")


def phase_kernels(dev, errs):
    """The kernels against their plain versions at the TPU spike's three
    shapes, ResNet-50's stem, a ragged shape and a dy in NCHW layout."""
    shapes = [((128, 56, 56, 256), False), ((128, 28, 28, 512), False),
              ((128, 56, 56, 64), False), ((128, 112, 112, 64), False),
              ((3, 7, 9, 100), False), ((32, 28, 28, 128), True)]
    for dtype in (torch.bfloat16, torch.float32):
        for relu in (True, False):
            for shape, nchw_dy in shapes:
                x, dy, gamma, mean, inv, a, b = bn_inputs(
                    shape, dtype, relu, dev, nchw_dy)
                check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs,
                              f"{str(dtype)[6:]:8s} relu={int(relu)} "
                              f"{shape} dy={'NCHW' if nchw_dy else 'NHWC'}")
                del x, dy
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
def _max_rel(a, b):
    return {k: float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
            / max(float(np.max(np.abs(b[k]))), 1e-30) for k in b}


def phase_parity():
    """Two fit steps of ResNet-50 at 32x32, 4 classes, batch 8, from the
    same weights, on the card (kernels) and on the CPU (plain versions),
    TF32 off.

    float64: every trained tensor's change over each step, every
    running statistic and both steps' losses, card against CPU, to 1e-6
    of the CPU value's magnitude. Readings the bound sits between (see
    PERF.md): the CPU float32 step's own distance from the float64 step
    (0.11 of a tensor's change on the worst tensor, 1.3e-2 on the median
    one, printed in the run), and the card's float64 distance from the
    CPU's (5e-10 on the worst tensor on an H100).

    float32 (the dtype the issue names, and cuDNN's float32 convolutions):
    this network's float32 step is ill-conditioned at this size (the
    CPU float32 step itself lands up to ~20% of a parameter's magnitude
    from the float64 step), so the card's step is held to the float64
    step no farther than 3x the CPU float32 step is, over the worst and
    the median tensor, and its first loss to 1e-3."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("  TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    rng = np.random.default_rng(0)
    b = 8
    x = rng.normal(size=(2 * b, 3, 32, 32))
    y = np.eye(4)[rng.integers(0, 4, 2 * b)]
    weights = ResNet50(height=32, width=32, num_classes=4).build(
        device="cpu").model.state_dict()
    res = {}
    for tag, dev, dt in (("card32", "cuda", "float32"),
                         ("cpu32", "cpu", "float32"),
                         ("card64", "cuda", "float64"),
                         ("cpu64", "cpu", "float64")):
        conf = ResNet50(height=32, width=32, num_classes=4).conf()
        conf.dtype = dt
        net = ComputationGraph(conf).init(device=dev)
        net.model.load_state_dict(weights)
        steps = [net.params()]
        losses = []
        for s in range(2):
            losses.append(net.fit(DeviceCachedIterator(
                x[s * b:(s + 1) * b].astype(dt),
                y[s * b:(s + 1) * b].astype(dt), batch_size=b, device=dev)
            ).final_loss())
            steps.append(net.params())
        res[tag] = (losses, steps)
    torch.backends.cudnn.allow_tf32 = True
    p64 = res["cpu64"][1]
    stats = [k for k in p64[0] if k.endswith(("_mean", "_var"))]
    # conv biases feed a batch norm: their true gradient is 0, and what
    # either side holds there is rounding noise
    trained = [k for k in p64[0] if k not in stats
               and not (k.endswith("_b") and k != "output_b")]

    # float64, card against CPU, per tensor
    (lc, pc), (lh, ph) = res["card64"], res["cpu64"]
    worst, where = 0.0, ""
    for s in (1, 2):
        dc = {k: pc[s][k] - pc[s - 1][k] for k in trained}
        dh = {k: ph[s][k] - ph[s - 1][k] for k in trained}
        for kind, errs in (("change", _max_rel(dc, dh)),
                           ("statistic", _max_rel(
                               {k: pc[s][k] for k in stats},
                               {k: ph[s][k] for k in stats}))):
            k = max(errs, key=errs.get)
            if errs[k] > worst:
                worst, where = errs[k], f"step {s} {kind} {k}"
    loss64 = max(abs(c - h) / abs(h) for c, h in zip(lc, lh))
    p32 = res["cpu32"][1]
    d32 = _max_rel({k: p32[1][k] - p32[0][k] for k in trained},
                   {k: ph[1][k] - ph[0][k] for k in trained})
    log(f"  float64 losses card {lc} cpu {lh} (worst {loss64:.2e}, tol "
        f"1e-6); card vs cpu over {len(trained)} trained tensors' changes "
        f"and {len(stats)} statistics, both steps: worst {worst:.2e} "
        f"({where}), tol 1e-6; for scale, cpu float32 vs float64 step-1 "
        f"change: worst {max(d32.values()):.3e}, median "
        f"{float(np.median(list(d32.values()))):.3e}")
    ok64 = worst <= 1e-6 and loss64 <= 1e-6 and all(
        np.all(np.isfinite(v)) for v in pc[2].values())

    # float32, card and CPU each against the float64 step
    (lc, pc), (l32, p32) = res["card32"], res["cpu32"]
    ec, e32 = _max_rel(pc[1], ph[1]), _max_rel(p32[1], ph[1])
    worst = (max(ec[k] for k in trained), max(e32[k] for k in trained))
    med = (float(np.median([ec[k] for k in trained])),
           float(np.median([e32[k] for k in trained])))
    loss_err = abs(lc[0] - l32[0]) / abs(l32[0])
    log(f"  float32 loss card {lc[0]:.7f} cpu32 {l32[0]:.7f} cpu64 "
        f"{lh[0]:.7f} (card vs cpu32 {loss_err:.2e}, tol 1e-3)")
    log(f"  float32 params vs f64, worst tensor: card {worst[0]:.3e} cpu32 "
        f"{worst[1]:.3e}; median tensor: card {med[0]:.3e} cpu32 "
        f"{med[1]:.3e} (tol 3x cpu32)")
    ok32 = loss_err <= 1e-3 and worst[0] <= 3 * worst[1] + 1e-6 and \
        med[0] <= 3 * med[1] + 1e-7 and set(pc[1]) == set(ph[1]) and \
        all(np.all(np.isfinite(v)) for v in pc[1].values())
    if not (ok64 and ok32):
        raise SystemExit("card step disagrees with the CPU step")


# ----------------------------------------------------------------------
#: (tier, fit keyword arguments) of the ResNet-50 tiers phase 6 times:
#: the scanned epoch (no listener), windows of 4 (``fused_steps=4``) and
#: one eager step a batch (a listener)
def _resnet_tiers():
    return (("scanned", {"fused_steps": 1}),
            ("windows", {"fused_steps": 4}),
            ("per-step", {"fused_steps": 1,
                          "listeners": [_quiet_listener()]}))


def _resnet_main(dev):
    """The main path's ResNet-50 (224x224x3, 1000 classes, bf16
    MixedPrecision, the zoo conf's Nesterovs) and its device iterator of
    STEPS batches of BATCH, data from seed 0."""
    from deeplearning4j_tpu_torch.autodiff import MixedPrecision
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    conf = ResNet50(height=224, width=224, channels=3,
                    num_classes=1000).conf()
    conf.mixed_precision = MixedPrecision()
    net = ComputationGraph(conf).init(dev)
    rng = np.random.default_rng(0)
    n = BATCH * STEPS
    x = rng.standard_normal((n, 3, 224, 224), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    return net, DeviceCachedIterator(x, y, batch_size=BATCH, device=dev)


def graph_pool_gib(net):
    """GiB the caching allocator holds in the graph's private pool (the
    captured windows' memory), from its snapshot; None where the
    snapshot does not name the pool."""
    pool = getattr(net, "_pool", None)
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(pool)) / 2 ** 30


def phase_main(dev, card):
    """ResNet-50 through ``ComputationGraph.fit(DeviceCachedIterator,
    epochs=1)``: a warm-up epoch (two warm-up steps, the capture, one
    replay), a timed epoch (one replay), a profiled replay; then windows
    of 4 and the per-step tier warmed up, and the three tiers timed in
    alternating runs. Returns (per-step record of the BN calls, launches
    of the timed epoch, metrics)."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    t0 = time.perf_counter()
    net, it = _resnet_main(dev)
    log(f"  built net ({net.num_params()} params) and uploaded "
        f"{BATCH * STEPS} images in {time.perf_counter() - t0:.1f} s")

    # the shapes and layouts the path hands the kernels (recorded in the
    # warm-up steps and the capture, not counted: the launch counts are
    # the wrappers' own)
    calls = []
    real = bn_relu.bn_relu_bwd

    def recording(x, dy, gamma, mean, inv, a, b, relu):
        calls.append((tuple(x.shape), bool(relu), str(x.dtype)[6:],
                      dy.is_contiguous(memory_format=torch.channels_last),
                      str(gamma.dtype)[6:]))
        return real(x, dy, gamma, mean, inv, a, b, relu)

    bn_relu.bn_relu_bwd = recording
    try:
        t0 = time.perf_counter()
        warm = net.fit(it, epochs=1)
        torch.cuda.synchronize()
    finally:
        bn_relu.bn_relu_bwd = real
    st = dict(net.last_fit_stats)
    log(f"  warm-up epoch ({STEPS} steps: 2 warm-up steps, the capture, "
        f"one replay; kernel builds included): "
        f"{time.perf_counter() - t0:.1f} s, loss {warm.final_loss():.4f}; "
        f"last_fit_stats {st}")
    if st["tier"] != "scanned_epoch" or st["window_captures"] != 1:
        raise SystemExit(f"the warm-up epoch did not capture one scanned "
                         f"window: {st}")
    per_step = calls[-53:]
    if len(calls) != 53 * (2 + STEPS) or sorted(per_step) != sorted(
            calls[:53]):
        raise SystemExit(f"{len(calls)} BN backward calls recorded in the "
                         f"warm-up steps and the capture")
    nchw = sum(not c[3] for c in per_step)
    log(f"  dy layout over one step's 53 BN backwards: {53 - nchw} "
        f"channels-last, {nchw} other")

    # the timed epoch: one replay; counts set to 0 just before it
    torch.cuda.reset_peak_memory_stats()
    bn_relu.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit(it, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bn_relu.LAUNCHES)
    st = dict(net.last_fit_stats)
    loss = hist.final_loss()
    peak = torch.cuda.max_memory_allocated()
    pool = graph_pool_gib(net)
    step_ms = 1000 * wall / STEPS
    log(f"  timed epoch (scanned): {STEPS} steps in {wall:.3f} s: step "
        f"{step_ms:.2f} ms, {BATCH * STEPS / wall:.1f} samples/s, mean loss "
        f"{loss:.4f}, step losses "
        f"{[round(v, 4) for v in hist.step_losses]}; last_fit_stats {st}; "
        f"peak memory {peak / 2**30:.2f} GiB, the graph pool "
        + ("not measured" if pool is None else f"{pool:.2f} GiB")
        + f"  [{card}]")
    log(f"  launches {launches}")
    want = {bn_relu.kernel_name(p, r): (33 if r else 20) * STEPS
            for p in (1, 2) for r in (True, False)}
    if not np.all(np.isfinite(hist.step_losses)):
        raise SystemExit(f"non-finite losses {hist.step_losses}")
    if st["graph_replays_per_epoch"] != 1 or st["window_captures"] != 0:
        raise SystemExit(f"the timed epoch was not one replay: {st}")
    if launches != want or sum(launches.values()) != 106 * STEPS:
        raise SystemExit(f"launches {launches}, want {want}")
    metrics = {"step_ms": step_ms, "samples_per_s": BATCH * STEPS / wall,
               "loss": loss, "peak_mem_gib": peak / 2**30,
               "graph_pool_gib": pool, "fit_stats": st}
    log("  profiled replay (the scanned epoch under torch.profiler):")
    metrics["profile"] = profile_fit(lambda: net.fit(it, epochs=1), STEPS,
                                     step_ms, card)

    # the windowed and per-step tiers, each warmed up, then all three in
    # alternating runs (ABC CBA ABC), one epoch each
    runs = {}
    for tier, kw in _resnet_tiers()[1:]:
        t0 = time.perf_counter()
        net.fit(it, epochs=1, **kw)
        torch.cuda.synchronize()
        log(f"  {tier} warm-up epoch: {time.perf_counter() - t0:.1f} s; "
            f"last_fit_stats {net.last_fit_stats}")
    order = list(_resnet_tiers())
    for rnd in range(3):
        for tier, kw in (order if rnd % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = net.fit(it, epochs=1, **kw)
            torch.cuda.synchronize()
            ms = 1000 * (time.perf_counter() - t0) / STEPS
            if not np.all(np.isfinite(h.step_losses)):
                raise SystemExit(f"{tier}: non-finite losses")
            runs.setdefault(tier, []).append(
                (ms, dict(net.last_fit_stats)))
    for tier, rs in runs.items():
        st = rs[-1][1]
        want_replays = {"scanned": 1, "windows": 2, "per-step": 0}[tier]
        if st["graph_replays_per_epoch"] != want_replays or \
                st["window_captures"] != 0:
            raise SystemExit(f"{tier}: {st}")
        ms = [r[0] for r in rs]
        log(f"  {tier:<8} ({st['tier']}, {st['dispatches_per_epoch']} "
            f"dispatches, {want_replays} replays an epoch): step ms "
            f"{[round(v, 2) for v in ms]}, samples/s "
            f"{[round(1000 * BATCH / v, 1) for v in ms]}  [{card}]")
    metrics["tiers"] = {t: [r[0] for r in rs] for t, rs in runs.items()}
    log("  profiled windows of 4 (one epoch, two replays):")
    metrics["profile_windows"] = profile_fit(
        lambda: net.fit(it, epochs=1, fused_steps=4), STEPS,
        min(metrics["tiers"]["windows"]), card)
    log("  profiled per-step tier (two eager steps):")
    batches = iter(it)
    two = [next(batches), next(batches)]
    metrics["profile_per_step"] = profile_fit(
        lambda: net.fit(two, epochs=1, fused_steps=1), 2,
        min(metrics["tiers"]["per-step"]), card)
    p29_resnet_snapshot(net, torch.tensor(np.random.default_rng(1)
                                          .standard_normal((8, 3, 224, 224),
                                                           dtype=np.float32),
                                          device=dev))
    del net, it
    torch.cuda.empty_cache()
    return per_step, launches, metrics


KERNEL_KINDS = (
    ("BN backward (CUDA C++ + Triton)", ("bn_relu_bwd_phase",
                                         "bn_bwd_phase")),
    ("updater (_foreach)", ("multi_tensor_apply",)),
    ("convolution / matmul", ("conv", "cudnn", "nvjet", "gemm", "xmma",
                              "cutlass", "sm90_", "wgrad", "dgrad")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "Functor")),
)


def _profiled_counts(fit, steps, warmup=True):
    """One pass of ``fit()`` (``steps`` training steps) under
    torch.profiler: (device ms and launches of each kernel, both summed
    over the pass, the pass's wall ms a step). With ``warmup`` a first,
    untraced pass of ``fit()`` runs in the profiler's warm-up cycle with
    the device tracing already on, as ``_p27_profile`` takes it: without it
    a trace could lose a replay's first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    cycle = {"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)} \
        if warmup else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **cycle) as prof:
        if warmup:
            fit()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        traced_ms = 1000 * (time.perf_counter() - t0) / steps
        if warmup:
            prof.step()
    totals = {}
    for e in prof.key_averages():
        # the schedule's ProfilerStep range is on the device timeline too
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        totals[e.key] = (ms, e.count)
    return totals, traced_ms


def _bn_counts(totals, steps):
    """The BN backward kernels' launches a step in a pass (phase 1's CUDA
    kernels carry a dtype suffix: bn_relu_bwd_phase1_bf16)."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    n = {}
    for key, (_, c) in totals.items():
        for name in bn_relu.LAUNCHES:
            if key == name or key.startswith(name + "_"):
                n[name] = n.get(name, 0) + c / steps
    return n


def whole_steps_lost(short, full, steps):
    """How many of ``steps`` steps' records a pass (``short``: kernel ->
    launches over the pass) lost against a complete pass of the same
    replay (``full``), if it lost whole steps of every kernel alike: each
    kernel's count then is (steps - lost) / steps of the complete pass's.
    None if the shortfall is not that (a kernel short where others are
    not, by other shares, or a kernel only one pass holds)."""
    if set(short) != set(full):
        return None
    lost = set()
    for k, n in full.items():
        kept = short[k] * steps
        if kept % n:
            return None
        lost.add(steps - kept // n)
    return lost.pop() if len(lost) == 1 and 0 < min(lost) < steps else None


def profile_fit(fit, steps, step_ms, card, warmup=True):
    """``fit()`` (``steps`` training steps, the same replayed or eager step
    each time) under torch.profiler: device time per step by kernel and by
    kind, device launches a step, and the idle share of the traced pass
    itself (busy against its own wall time a step; the unprofiled step
    time ``step_ms`` is printed beside it, and no ratio is taken across
    the two runs); each BN kernel must
    launch 33 (ReLU) and 20 times a step. With ``warmup`` each pass runs
    ``fit()`` once in the profiler's warm-up cycle first
    (``_profiled_counts``; phase 6's passes, each the same replay again).
    A pass whose trace holds fewer BN launches is repeated once: if the repeat is complete and the first
    pass held every kernel at the same whole-step share of the repeat's
    count (the profiler lost whole steps' records, every kernel's alike),
    the repeat is the reading and its line says so; a second shortfall, or
    one in some kernels and not others (a launch that did not happen),
    stops the run."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    want = {bn_relu.kernel_name(p, r): 33 if r else 20
            for p in (1, 2) for r in (True, False)}
    totals, traced_ms = _profiled_counts(fit, steps, warmup)
    kernel_n = _bn_counts(totals, steps)
    note = ""
    if kernel_n != want:
        first = {k: c for k, (_, c) in totals.items()}
        log(f"    the profiled pass traced BN backward launches {kernel_n} a "
            f"step against {want}, {sum(first.values()) / steps:.1f} launches "
            f"a step in all: repeating it once")
        totals, traced_ms = _profiled_counts(fit, steps, warmup)
        kernel_n = _bn_counts(totals, steps)
        full = {k: c for k, (_, c) in totals.items()}
        lost = whole_steps_lost(first, full, steps) if kernel_n == want \
            else None
        short = {k: (first.get(k, 0), c) for k, c in full.items()
                 if first.get(k, 0) != c}
        log(f"    repeat: BN backward launches {kernel_n} a step, "
            f"{sum(full.values()) / steps:.1f} launches a step in all; "
            f"kernels whose count differs (first, repeat): "
            f"{dict(list(short.items())[:8])}")
        if lost is None:
            raise SystemExit(f"profiled BN backward launches {kernel_n}, "
                             f"want {want} (the first pass's shortfall was "
                             f"not whole steps of every kernel alike)")
        note = (f" (the first profiled pass lost {lost} of {steps} steps' "
                f"records, every kernel's alike: this is the repeated pass)")
    per_kernel, by_kind = {}, {}
    for key, (ms, n) in totals.items():
        per_kernel[key] = (ms / steps, n / steps)
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(t in key for t in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms / steps
    busy = sum(ms for ms, _ in per_kernel.values())
    if busy == 0:
        raise SystemExit("the profiler recorded no device time")
    launches = sum(n for _, n in per_kernel.values())
    log(f"    per step: device busy {busy:.2f} ms of the traced pass's own "
        f"{traced_ms:.2f} ms a step: idle share {1 - busy / traced_ms:.3f} "
        f"(the unprofiled step: {step_ms:.2f} ms); "
        f"{launches:.0f} device launches (PR 1's "
        f"{TRITON_PHASE1_LAUNCHES_PER_STEP} with the Triton phase 1 and its "
        f"PyTorch fold, 4243 per-step before the _foreach updaters){note}  "
        f"[{card}]")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:8.3f} ms  {ms / busy:.3f} of the busy time  {kind}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (ms, n) in top:
        log(f"    {ms:8.3f} ms  x{n:<6.1f} {key[:96]}")
    kernel_ms = {}
    for key, (ms, n) in per_kernel.items():
        for name in bn_relu.LAUNCHES:
            if key == name or key.startswith(name + "_"):
                kernel_ms[name] = kernel_ms.get(name, 0.0) + ms
    log(f"    BN backward device launches per step: {kernel_n}")
    return {"busy_ms": busy, "idle_share": 1 - busy / traced_ms,
            "traced_ms": traced_ms, "launches": launches,
            "by_kind_ms": by_kind, "kernel_ms": kernel_ms,
            "repeated": bool(note),
            "top": [(k[:96], v[0], v[1]) for k, v in top]}


def phase_resnet_tiers(card):
    """ResNet-50 on the fit tiers, on the card: two scanned fits of the
    main path's configuration from one start, bit-equal (else
    ``torch.backends.cudnn.deterministic`` is set, and said); the scanned
    and per-step tiers from the same weights over STEPS steps, every
    parameter, running statistic and step loss within rtol 1e-5 / atol
    1e-6 (the JAX tier tolerance), and whether they are bit-equal; then
    phase 4's ResNet-50 at 32x32 in float64, TF32 off, on the card's
    scanned tier against its per-step tier (the tier rule) and the
    CPU's per-step tier over phase 4's two steps: every trained tensor's
    change, every running statistic and every loss to 1e-6 (phase 4's
    bound)."""
    dev = torch.device("cuda")
    det0 = torch.backends.cudnn.deterministic

    def run(kw):
        net, it = _resnet_main(dev)
        hist = net.fit(it, epochs=1, **kw)
        st = dict(net.last_fit_stats)
        out = ({k: v.detach().cpu().clone()
                for k, v in net.model.state_dict().items()},
               hist.step_losses, st)
        del net, it
        torch.cuda.empty_cache()
        return out

    def equal(a, b):
        return a[1] == b[1] and all(torch.equal(v, b[0][k])
                                    for k, v in a[0].items())

    try:
        a, b = run({}), run({})
        same = equal(a, b)
        log(f"  two scanned fits from one start (cuDNN deterministic="
            f"{det0}): bit-equal {same}; tiers {a[2]['tier']}, "
            f"{b[2]['tier']}, replays {a[2]['graph_replays_per_epoch']}")
        if not same:
            torch.backends.cudnn.deterministic = True
            log("  not bit-equal: cuDNN's chosen algorithms are not "
                "deterministic; the rest of this phase sets "
                "torch.backends.cudnn.deterministic")
            a, b = run({}), run({})
            same = equal(a, b)
            log(f"  two scanned fits, cuDNN deterministic: bit-equal {same}")
            if not same:
                raise SystemExit("two scanned ResNet-50 fits from one start "
                                 "differ")
        c = run({"listeners": [_quiet_listener()]})
        if a[2]["tier"] != "scanned_epoch" or c[2]["tier"] != "per_step":
            raise SystemExit(f"tiers {a[2]} / {c[2]}")
        reading = _reading({k: v.float() for k, v in a[0].items()},
                           {k: v.float() for k, v in c[0].items()},
                           a[1], c[1])
        log(f"  scanned against per-step, {STEPS} steps from the same "
            f"weights: tier rule max |a - b| / (1e-6 + 1e-5 |b|) over "
            f"{len(c[0])} tensors and the losses {reading:.3g} (<= 1 "
            f"passes); bit-equal {equal(a, c)}; losses scanned "
            f"{[round(v, 5) for v in a[1]]}, per-step "
            f"{[round(v, 5) for v in c[1]]}  [{card}]")
        if reading > 1:
            raise SystemExit("ResNet-50's scanned and per-step tiers "
                             "disagree on the card")
        worst = resnet_f64_card_vs_cpu()
    finally:
        torch.backends.cudnn.deterministic = det0
    return {"bit_equal_scanned": same, "tier_reading": reading,
            "f64_worst": worst}


def resnet_f64_card_vs_cpu():
    """Phase 4's ResNet-50 (32x32, 4 classes, batch 8) in float64, TF32
    off, from the same weights: one epoch of two steps on the card's
    scanned tier (one window of two steps), on its per-step tier and on
    the CPU's per-step tier (a list of batches). The card's two tiers
    must meet the tier rule (and are printed bit-equal or not: cuDNN's
    float64 algorithms need not be deterministic, so the pair is run
    again with ``torch.backends.cudnn.deterministic`` where they are
    not); the card's scanned tier is held to the CPU over phase 4's two
    steps with phase 4's bound (more steps of this network at init
    amplify the rounding of either side past it)."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    b = 8
    x = rng.normal(size=(2 * b, 3, 32, 32))
    y = np.eye(4)[rng.integers(0, 4, 2 * b)]
    weights = ResNet50(height=32, width=32, num_classes=4).build(
        device="cpu").model.state_dict()
    def run(tag, dev):
        conf = ResNet50(height=32, width=32, num_classes=4).conf()
        conf.dtype = "float64"
        net = ComputationGraph(conf).init(device=dev)
        net.model.load_state_dict(weights)
        init = net.params()
        data = DeviceCachedIterator(x, y, batch_size=b, device=dev) \
            if tag == "scanned" else [(x[:b], y[:b]), (x[b:], y[b:])]
        hist = net.fit(data, epochs=1)
        return (init, net.params(), hist.step_losses,
                dict(net.last_fit_stats))

    def equal(r, q):
        return r[2] == q[2] and all(np.array_equal(v, q[1][k])
                                    for k, v in r[1].items())

    det0 = torch.backends.cudnn.deterministic
    try:
        res = {tag: run(tag, dev) for tag, dev in (
            ("scanned", "cuda"), ("per-step", "cuda"), ("cpu", "cpu"))}
        tiers_equal = equal(res["scanned"], res["per-step"])
        det_equal = None
        if not tiers_equal:
            torch.backends.cudnn.deterministic = True
            det_equal = equal(run("scanned", "cuda"), run("per-step", "cuda"))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = det0
    (i0, pc, lc, sc), (_, ph, lh, sh) = res["scanned"], res["cpu"]
    _, pp, lp, sp = res["per-step"]
    tier_rule = _reading(pc, pp, lc, lp)
    stats = [k for k in pc if k.endswith(("_mean", "_var"))]
    trained = [k for k in pc if k not in stats
               and not (k.endswith("_b") and k != "output_b")]
    change = _max_rel({k: pc[k] - i0[k] for k in trained},
                      {k: ph[k] - i0[k] for k in trained})
    stat = _max_rel({k: pc[k] for k in stats}, {k: ph[k] for k in stats})
    loss = max(abs(c - h) / abs(h) for c, h in zip(lc, lh))
    worst = max(max(change.values()), max(stat.values()), loss)
    log(f"  ResNet-50 32x32 float64: card {sc['tier']} "
        f"({sc['graph_replays_per_epoch']} replay an epoch) against the "
        f"card's {sp['tier']}: tier rule {tier_rule:.3g} (<= 1 passes), "
        f"bit-equal {tiers_equal}"
        + ("" if det_equal is None else
           f" (with cuDNN deterministic: bit-equal {det_equal})")
        + f"; against CPU {sh['tier']}, 2 steps: worst change "
        f"{max(change.values()):.2e} ({max(change, key=change.get)}), "
        f"statistic {max(stat.values()):.2e}, loss {loss:.2e} (tol 1e-6)")
    if sc["tier"] != "scanned_epoch" or sh["tier"] != "per_step" or \
            sp["tier"] != "per_step" or tier_rule > 1 or worst > 1e-6:
        raise SystemExit("the card's scanned ResNet-50 float64 disagrees "
                         "with the CPU's per-step tier")
    return worst


# ----------------------------------------------------------------------
def phase_timing(dev, per_step, card_name, errs):
    """At each (shape, ReLU, dtype, dy layout, gamma dtype) the main path
    gave the kernels: both kernels held to their plain versions, then, per
    training step, each kernel, its plain version and its library call
    timed over the path's 53 BN layers (each call the median of 20 by
    ``median_ms``), beside the bound. Phase 1's
    library call, ``batch_norm_backward_reduce``, computes the same
    function as the fused phase 1 for the 20 layers without ReLU (the
    sums, grad_weight and grad_bias); the port never calls it."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    bw, flops = card_rates(card_name)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    counts = {}
    for c in per_step:
        counts[c] = counts.get(c, 0) + 1
    tot = {bn_relu.kernel_name(p, r): {"ms": 0.0, "plain_ms": 0.0,
                                       "bound_bytes": 0.0, "ops": 0.0,
                                       "library_ms": None}
           for p in (1, 2) for r in (True, False)}
    native_ms = 0.0
    for (shape, relu, dtype, cl_dy, gdtype), cnt in sorted(counts.items()):
        n, c, h, w = shape
        x, dy, gamma, mean, inv, a, b = bn_inputs(
            (n, h, w, c), getattr(torch, dtype), relu, dev,
            nchw_dy=not cl_dy, gdtype=getattr(torch, gdtype))
        check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs,
                      f"path {shape} {dtype} gamma {gdtype} "
                      f"relu={int(relu)} dy={'NHWC' if cl_dy else 'NCHW'}")
        s1, s2 = bn_relu.phase1_plain(x, dy, a, b, mean, relu)
        _, _, g, c1, c2 = bn_relu.phase1_fold_plain(x, dy, a, b, mean, inv,
                                                    gamma, relu)
        es, rc = x.element_size(), x.numel()
        gs, acc = gamma.element_size(), mean.element_size()
        k1 = median_ms(lambda: bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv,
                                                     gamma, relu), flush)
        p1 = median_ms(lambda: bn_relu.phase1_fold_plain(
            x, dy, a, b, mean, inv, gamma, relu), flush)
        k2 = median_ms(lambda: bn_relu.bn_bwd_phase2(x, dy, a, b, mean, g, c1,
                                                     c2, relu), flush)
        p2 = median_ms(lambda: bn_relu.phase2_plain(x, dy, a, b, mean, g, c1,
                                                    c2, relu), flush)
        # bytes the function must move: x and dy read once, dx written
        # once; the per-channel vectors in (a, b, mean, inv, gamma; g, c1,
        # c2 for phase 2) and out (dgamma, dbeta, g, c1, c2 for phase 1)
        b1 = 2 * rc * es + c * (2 * es + 2 * acc + gs) + c * (2 * gs +
                                                              3 * acc)
        b2 = 3 * rc * es + c * (2 * es + 4 * acc)
        o1 = rc * (9 if relu else 4)       # mask (mul, add, cmp, select)
        o2 = rc * (9 if relu else 4)       # + sub, mul, sub, mul
        lib = ""
        for phase, k, p, by, op in ((1, k1, p1, b1, o1), (2, k2, p2, b2, o2)):
            t = tot[bn_relu.kernel_name(phase, relu)]
            t["ms"] += cnt * k
            t["plain_ms"] += cnt * p
            t["bound_bytes"] += cnt * by
            t["ops"] += cnt * op
        if not relu:
            # the library's kernels take dy in x's layout, and a float32
            # weight beside bf16 input
            dy = dy.contiguous(memory_format=torch.channels_last)
            wf = gamma.float()
            cnt_t = torch.tensor([n * h * w], dtype=torch.int32, device=dev)
            l1 = median_ms(lambda: torch.ops.aten.batch_norm_backward_reduce(
                dy, x, mean, inv, wf, True, True, True), flush)
            l2 = median_ms(lambda: torch.ops.aten.batch_norm_backward_elemt(
                dy, x, mean, inv, wf, s1, s2, cnt_t), flush)
            ln = median_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                dy, x, wf, None, None, mean, inv, True, 1e-5,
                [True, True, True]), flush)
            for phase, lt in ((1, l1), (2, l2)):
                t = tot[bn_relu.kernel_name(phase, False)]
                t["library_ms"] = (t["library_ms"] or 0.0) + cnt * lt
            native_ms += cnt * ln
            lib = (f" | library reduce {l1:.4f} elemt {l2:.4f} "
                   f"native_batch_norm_backward {ln:.4f}")
        log(f"  {shape} relu={int(relu)} dy={'NHWC' if cl_dy else 'NCHW'} "
            f"x{cnt}: phase1 {k1:.4f} ms (plain {p1:.4f}, bound "
            f"{1e3 * b1 / bw:.4f}) phase2 {k2:.4f} ms (plain {p2:.4f}, "
            f"bound {1e3 * b2 / bw:.4f}){lib}")
        del x, dy
    # what every "alone" time carries besides the kernel: a one-element
    # fill timed the same way (launch and event overhead, L2 write-back)
    tiny = torch.empty(1, device=dev)
    floor = median_ms(lambda: tiny.zero_(), flush)
    log(f"  timing floor: a one-element fill timed the same way takes "
        f"{1e3 * floor:.1f} us; x53 BN layers = {53 * floor:.3f} ms per "
        f"step in each 'alone' sum")
    # the host's side of a phase-1 call (the step is host-bound)
    n, c, h, w = per_step[0][0]
    x, dy, gamma, mean, inv, a, b = bn_inputs(
        (n, h, w, c), getattr(torch, per_step[0][2]), True, dev,
        gdtype=getattr(torch, per_step[0][4]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, True)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    log(f"  host time of a phase-1 call (wrapper, checks, ctypes launch): "
        f"{host_us:.1f} us at {per_step[0][0]}")
    del x, dy
    out = {}
    for name, t in tot.items():
        by_bytes, by_ops = 1e3 * t["bound_bytes"] / bw, 1e3 * t["ops"] / flops
        out[name] = dict(t, bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations")
    log(f"  per step, the 20 BN layers without ReLU: "
        f"native_batch_norm_backward {native_ms:.3f} ms")
    return out, native_ms


# ----------------------------------------------------------------------
# attention (csrc/causal_attention.cu) and the GPT-medium path
ATTN_KERNELS = ("attention_fwd", "attention_bwd_delta", "attention_bwd_dkdv",
                "attention_bwd_dq")
ATTN_SOURCE = "deeplearning4j_tpu_torch/csrc/causal_attention.cu"
#: the JAX op the kernels stand in for (XLA fused it; no Pallas kernel)
ATTN_REPLACES = "deeplearning4j_tpu/ops/nn_ops.py:462"
ATTN_TILE = 64               # the kernels' key tile
GPT_BATCH, GPT_SEQ, GPT_STEPS = 16, 512, 8


def attn_grads(fn, q, k, v, do, causal):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v, causal=causal)
    return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))


def nan_fails(ratio):
    """A ratio to a tolerance, with NaN (a NaN on either side) read as
    infinitely far: ``max`` and ``<=`` would let a NaN pass."""
    return math.inf if math.isnan(ratio) else ratio


def check_attention(q, k, v, do, causal, errs, label):
    """Each kernel against its plain version on the same inputs (the
    backward kernels get the forward kernel's stats and the delta
    kernel's delta), per element to ``rel`` times the sum of the absolute
    terms behind it: 1e-5 float32, 1e-10 float64, 2^-6 bf16. In bf16 each
    side rounds every P (or dS) term once and its output once, at bf16's
    unit roundoff u = 2^-8, but not the same values (the forward kernel
    rounds P against the running row maximum, the plain version the
    normalized P), so a term may differ by 2u and an output by another
    2u of its magnitude: 4u = 2^-6 of the terms. Two calls bit-equal.
    Then end to end through autograd: float32/float64 against
    ``sdpa_plain`` to 1e-5/1e-10 of the terms; bf16 against ``sdpa_plain``
    in float32 on the same bf16 inputs, to at most twice the bf16 plain
    version's error plus one bf16 unit in the last place of the output's
    magnitude plus 1e-5 of the largest sum of terms (the kernels sum in
    float32 in another order). A bf16 or float32 causal case with S >= 128
    also shows, with ``control_readings``, that the rule rejects a wrong
    mask. float32's forward is ``attention_f32``'s kernel (3xTF32), and
    its launches are checked to go there. Exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    dt = q.dtype
    fwd_name = "attention_fwd_f32" if dt == torch.float32 else \
        "attention_fwd"
    acc = at.acc_dtype(dt)
    rel = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5,
           torch.float64: 1e-10}[dt]
    rel_acc = 1e-10 if dt == torch.float64 else 1e-5
    s = 1.0 / math.sqrt(q.shape[-1])
    t_o, t_dq, t_dk, t_dv = at.abs_terms(q, k, v, do, causal)

    def run():
        o, st = at.attention_fwd(q, k, v, causal)
        delta = torch.empty(q.shape[:3], dtype=acc, device=q.device)
        at._launch("dl4j_attention_bwd_delta", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta)
        dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (k, v))
        at._launch("dl4j_attention_bwd_dkdv", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta, dk=dk, dv=dv)
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        at._launch("dl4j_attention_bwd_dq", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta, dq=dq)
        return o, st, delta, dk, dv, dq

    before = (at.LAUNCHES["attention_fwd"], af.LAUNCHES["attention_fwd_f32"])
    got, again = run(), run()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    routed = (at.LAUNCHES["attention_fwd"] - before[0],
              af.LAUNCHES["attention_fwd_f32"] - before[1]) == (
        (0, 2) if dt == torch.float32 else (2, 0))
    o, st, delta, dk, dv, dq = got
    po, _ = at.attention_fwd_plain(q, k, v, causal)
    pdelta = at.bwd_delta_plain(o, do)
    pdk, pdv = at.bwd_dkdv_plain(q, k, v, do, st, delta, causal)
    pdq = at.bwd_dq_plain(q, k, v, do, st, delta, causal)
    t_delta = (do.double().abs() * o.double().abs()).sum(-1)
    worst, by_kernel = 0.0, {}
    for kname, x, p, t, r in (
            (fwd_name, o, po, t_o, rel),
            ("attention_bwd_delta", delta, pdelta, t_delta, rel_acc),
            ("attention_bwd_dkdv", dk, pdk, t_dk, rel),
            ("attention_bwd_dkdv", dv, pdv, t_dv, rel),
            ("attention_bwd_dq", dq, pdq, t_dq, rel)):
        err = (x.double() - p.double()).abs()
        ratio = nan_fails(float((err / (r * t).clamp_min(1e-300)).max()))
        by_kernel[kname] = max(by_kernel.get(kname, 0.0), ratio)
        worst = max(worst, ratio)
        errs[kname] = max(errs.get(kname, 0.0), float(err.max()))
    # end to end, through autograd
    got = attn_grads(at.scaled_dot_product_attention, q, k, v, do, causal)
    if dt == torch.bfloat16:
        f = [t.float() for t in (q, k, v, do)]
        ref = attn_grads(at.sdpa_plain, *f[:3], f[3], causal)
        plain = attn_grads(at.sdpa_plain, q, k, v, do, causal)
        e2e, parts = 0.0, []
        for x, p, r, t in zip(got, plain, ref, (t_o, t_dq, t_dk, t_dv)):
            ek = float((x.float() - r).abs().max())
            ep = float((p.float() - r).abs().max())
            mag = float(r.abs().max())
            ulp = 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 0.0
            e2e = max(e2e, nan_fails(ek / (2 * ep + ulp + 1e-5 * float(
                t.max()))))
            parts.append(f"{ek:.3e}/{ep:.3e}")
        detail = "kernel/plain-bf16 error vs f32 (O dq dk dv): " + " ".join(
            parts)
        sq, sk = q.shape[2], k.shape[2]
        if causal and sq == sk >= 2 * ATTN_TILE:
            control_readings(q, k, v, do, got, (t_o, t_dq, t_dk, t_dv), rel,
                             label)
    else:
        want = attn_grads(at.sdpa_plain, q, k, v, do, causal)
        e2e = max(nan_fails(float(((x.double() - w.double()).abs() / (
            rel_acc * t).clamp_min(1e-300)).max()))
            for x, w, t in zip(got, want, (t_o, t_dq, t_dk, t_dv)))
        detail = f"forward launches routed {routed}"
        sq, sk = q.shape[2], k.shape[2]
        if dt == torch.float32 and causal and sq == sk >= 2 * ATTN_TILE:
            control_readings(q, k, v, do, got, (t_o, t_dq, t_dk, t_dv), rel,
                             label)
    ok = worst <= 1 and e2e <= 1 and same and routed
    if not ok:
        log(f"    of tol, by kernel: {by_kernel}")
    log(f"  {label}: kernels vs plain {worst:.2e} of tol, end to end "
        f"{e2e:.2e} of tol, bit-equal twice {same} {detail} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("attention kernel disagrees with its plain version")


def control_readings(q, k, v, do, got, terms, rel, label):
    """The check's power: the kernels' O, dq, dk, dv held by the same rule
    (``rel`` of the sum of absolute terms) to the plain version, in the
    inputs' dtype, of a wrong function, the causal mask off by one (each
    row sees one key too many) or one key tile (keys 64-127) dropped. The
    rule must reject both, on every output; exits if it does not."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    sq, sk = q.shape[2], k.shape[2]
    base = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    masks = {"mask off by one": base.tril(sk - sq + 1),
             "key tile dropped": base.tril(sk - sq)}
    masks["key tile dropped"][:, ATTN_TILE:2 * ATTN_TILE] = False
    readings = {}
    for name, m in masks.items():
        wrong = attn_grads(lambda q_, k_, v_, causal: at.sdpa_plain(
            q_, k_, v_, mask=m), q, k, v, do, False)
        readings[name] = [
            float(((x.double() - w.double()).abs() / (rel * t).clamp_min(
                1e-300)).max()) for x, w, t in zip(got, wrong, terms)]
    ok = all(r > 1 for rs in readings.values() for r in rs)
    log(f"  {label}: control, the kernels against a wrong function, of tol "
        f"(O dq dk dv): " + "; ".join(
            f"{n} " + " ".join(f"{r:.3g}" for r in rs)
            for n, rs in readings.items()) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the attention check does not reject a wrong mask")


def phase_attention(dev, errs):
    """The attention kernels against their plain versions: the GPT path's
    shape at build_gpt's strides, ragged lengths, non-causal, Sq < Sk,
    Sq > Sk (fully masked rows), the bf16 kernels' tile edges (Sq, Sk in
    127, 128, 129, 257 at every head dim), in bf16, float32 and float64;
    float32 also at the dense prefill's serving shape (1, 12, 512, 128),
    the float32 kernel's tile edges (63, 64, 65, 127, 129) and ragged Sq <
    Sk and Sq > Sk at head dims 16 and 128; then views whose rows are not
    on 16 bytes, which the wrappers copy."""
    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    cases = [  # (b, h, sq, sk, d, causal, dtype, split)
        (GPT_BATCH, 12, GPT_SEQ, GPT_SEQ, 128, True, bf, True),
        (1, 4, 77, 77, 64, True, bf, False),
        (1, 4, 200, 200, 16, True, bf, False),
        (2, 2, 1, 1, 64, True, bf, False),
        (2, 4, 200, 200, 64, False, bf, False),
        (1, 4, 100, 300, 64, True, bf, False),
        (1, 4, 300, 100, 64, True, bf, False),
        (2, 3, 128, 128, 128, True, bf, True),
        # the tile edges: 64-key and 128-query tiles, 64-key dk/dv blocks
        (1, 2, 127, 127, 16, True, bf, False),
        (1, 2, 128, 128, 32, False, bf, False),
        (1, 2, 129, 129, 64, True, bf, False),
        (1, 2, 257, 257, 128, True, bf, False),
        (1, 2, 129, 257, 128, True, bf, False),
        (1, 2, 257, 129, 64, True, bf, False),
        (1, 2, 128, 127, 32, True, bf, False),
        (1, 2, 127, 129, 16, False, bf, False),
        (2, 3, 257, 257, 64, True, bf, True),
        (1, 2, 129, 129, 128, False, bf, True),
        (1, 4, 77, 77, 64, True, f32, False),
        (1, 4, 200, 200, 16, False, f32, False),
        (1, 4, 300, 100, 128, True, f32, False),
        (1, 2, 129, 257, 128, True, f32, False),
        # the dense prefill's serving shape, and the float32 kernel's edges:
        # 64-row tiles, 32- and 64-key tiles, work items of 64-key units
        (1, 12, 512, 512, 128, True, f32, True),
        (1, 2, 63, 63, 16, True, f32, False),
        (1, 2, 64, 64, 32, True, f32, False),
        (1, 2, 65, 65, 64, True, f32, False),
        (1, 2, 127, 127, 128, True, f32, True),
        (1, 2, 129, 129, 128, True, f32, False),
        (1, 3, 70, 333, 16, True, f32, False),
        (1, 3, 70, 333, 128, True, f32, False),
        (1, 3, 333, 70, 16, True, f32, False),
        (1, 3, 333, 70, 128, True, f32, True),
        (1, 4, 77, 77, 64, True, f64, False),
        (1, 4, 100, 300, 16, True, f64, False),
        (1, 4, 300, 100, 128, True, f64, True),
        (1, 2, 257, 129, 64, True, f64, False),
    ]
    for b, h, sq, sk, d, causal, dtype, split in cases:
        q, k, v, do = attention_inputs(dev, b, h, sq, sk, d, dtype, split)
        check_attention(q, k, v, do, causal, errs,
                        f"{str(dtype)[6:]:8s} ({b},{h},{sq},{sk},{d}) "
                        f"causal={int(causal)}{' strided' if split else ''}")
        del q, k, v, do
    check_alignment_copies(dev)
    torch.cuda.empty_cache()


def check_alignment_copies(dev):
    """bf16 q, k, v whose rows are 130 bytes apart (not on 16 bytes, as TMA
    needs) and a dO that starts 2 bytes into its storage: the wrappers copy
    each (three in the forward, four in the backward), and O and the grads
    are bit-equal to those of the same values laid out contiguously."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    b, h, s, d = 1, 2, 129, 64
    q, k, v, do = attention_inputs(dev, b, h, s, s, d, torch.bfloat16, False)
    wide = [torch.zeros(b, h, s, d + 1, dtype=torch.bfloat16, device=dev)
            for _ in range(3)]
    for w, t in zip(wide, (q, k, v)):
        w[..., :d] = t
    qo, ko, vo = (w[..., :d] for w in wide)
    flat = torch.zeros(do.numel() + 1, dtype=torch.bfloat16, device=dev)
    doo = flat[1:].view(do.shape)
    doo.copy_(do)
    at.reset_launches()
    got = at.attention_fwd(qo, ko, vo, True)
    got = got + at.attention_bwd(qo, ko, vo, got[0], doo, got[1], True)
    copies = (dict(at.ALIGN_COPIES), at.DOUT_COPIES["attention_bwd"])
    o, st = at.attention_fwd(q, k, v, True)
    want = (o, st) + at.attention_bwd(q, k, v, o, do, st, True)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    ok = same and copies == ({"attention_fwd": 3, "attention_bwd": 3}, 1)
    log(f"  bf16 (1,2,129,129,64) causal, rows 130 bytes apart, dO 2 bytes "
        f"in: copies {copies}, O, stats and grads bit-equal to the "
        f"contiguous call's {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the alignment copies are wrong")


def _tensor_rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_gpt_parity():
    """GPT_TINY (batch 4, seq 32) in float64, card against CPU, from the
    same weights: every gradient of ``calculate_gradients``, then three
    Adam fit steps (each step's loss, every parameter after them), each
    tensor to 1e-6 of its magnitude. The card's attention runs the
    kernels' float64 path."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import GPT_TINY, build_gpt
    rng = np.random.default_rng(0)
    ids, tgt = (rng.integers(0, GPT_TINY.vocab_size, (16, 32)).astype(
        np.int32) for _ in range(2))
    res = {}
    for dev in ("cuda", "cpu"):
        sd = build_gpt(GPT_TINY, batch=4, seq_len=32, device=dev)
        for n, a in sd.trainable_params().items():
            sd.set_arr_for_var(n, a.double())
        before = at.LAUNCHES["attention_fwd"]
        grads = sd.calculate_gradients({"input_ids": ids[:4],
                                        "targets": tgt[:4]})
        launched = at.LAUNCHES["attention_fwd"] - before
        sd.training_config = TrainingConfig(
            updater=Adam(1e-3), data_set_feature_mapping=["input_ids"],
            data_set_label_mapping=["targets"])
        losses = sd.fit(DeviceCachedIterator(
            [ids[4:]], [tgt[4:]], batch_size=4, device=dev)).step_losses
        res[dev] = (grads, losses, dict(sd.trainable_params()), launched)
    (gc, lc, pc, nc), (gh, lh, ph, _) = res["cuda"], res["cpu"]
    eg = max(_tensor_rel(gc[n], gh[n]) for n in gh)
    ep = max(_tensor_rel(pc[n], ph[n]) for n in ph)
    el = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    log(f"  float64 GPT_TINY, card vs cpu over {len(gh)} tensors: gradients "
        f"worst {eg:.2e}, params after 3 Adam steps worst {ep:.2e}, losses "
        f"{lc} vs {lh} (worst {el:.2e}); tol 1e-6; attention forward "
        f"launches of the card's gradient pass {nc} (2 layers, forward and "
        f"remat re-forward)")
    if not (eg <= 1e-6 and ep <= 1e-6 and el <= 1e-6 and nc == 4):
        raise SystemExit("GPT_TINY on the card disagrees with the CPU")


def _gpt_iterator(vocab):
    """``bench.py``'s GPT data: GPT_STEPS batches of ids and targets drawn
    uniformly over the whole vocabulary, seed 0."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    rng = np.random.default_rng(0)
    n = GPT_BATCH * GPT_STEPS
    ids = rng.integers(0, vocab, (n, GPT_SEQ)).astype(np.int32)
    tgt = rng.integers(0, vocab, (n, GPT_SEQ)).astype(np.int32)
    return DeviceCachedIterator([ids], [tgt], batch_size=GPT_BATCH)


def _gpt_epoch(sd, data, label, card):
    """One timed epoch of ``sd.fit(data)`` (counts set to 0 just before):
    step ms, tokens/s, peak memory, losses, the attention wrappers'
    counts and copies."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at.reset_launches()
    t0 = time.perf_counter()
    hist = sd.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = {"tier": sd.last_fit_stats["tier"],
         "graph_replays_per_epoch":
             sd.last_fit_stats["graph_replays_per_epoch"],
         "window_captures": sd.last_fit_stats["window_captures"],
         "step_ms": 1000 * wall / GPT_STEPS,
         "tokens_per_s": GPT_BATCH * GPT_SEQ * GPT_STEPS / wall,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
         "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
         "losses": hist.step_losses, "launches": dict(at.LAUNCHES),
         "dout_copies": at.DOUT_COPIES["attention_bwd"],
         "align_copies": dict(at.ALIGN_COPIES)}
    log(f"  {label} ({r['tier']}, {r['graph_replays_per_epoch']} graph "
        f"replays, {r['window_captures']} captures): {GPT_STEPS} steps in "
        f"{wall:.3f} s: step {r['step_ms']:.2f} ms, {r['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {r['peak_mem_gib']:.2f} GiB allocated "
        f"({r['peak_reserved_gib']:.2f} GiB reserved, graph pools "
        f"included)  [{card}]")
    log(f"  loss per step: {[round(v, 4) for v in r['losses']]}")
    log(f"  attention launches {r['launches']}, dO copies "
        f"{r['dout_copies']}, q/k/v alignment copies {r['align_copies']}")
    return r


def _check_gpt_epoch(r, want, first_loss):
    if not all(np.isfinite(r["losses"])) or r["losses"][-1] >= first_loss:
        raise SystemExit(f"GPT-medium losses {r['losses']}")
    if r["launches"] != want:
        raise SystemExit(f"{r['tier']}: attention launches {r['launches']},"
                         f" want {want}")
    if r["dout_copies"] or any(r["align_copies"].values()):
        raise SystemExit(f"the path copied attention inputs: dO "
                         f"{r['dout_copies']}, q/k/v {r['align_copies']}")


def profile_gpt_replay(sd, it, step_ms, card):
    """One scanned epoch (one replay) under torch.profiler: each attention
    kernel's launches in the trace, which must equal what the wrappers
    counted for the replay; device launches, busy time and idle share a
    step, the idle share against the traced epoch's own wall time (the
    timed step ``step_ms`` printed beside it). A trace with fewer launches
    than counted (the tracer can drop a window's first kernels) is taken
    once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import attention as at
    torch.cuda.synchronize()
    for attempt in range(2):
        before = dict(at.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sd.fit(it)
            torch.cuda.synchronize()
            traced_ms = 1000 * (time.perf_counter() - t0) / GPT_STEPS
        counted = {k: at.LAUNCHES[k] - before[k] for k in ATTN_KERNELS}
        if sd.last_fit_stats["graph_replays_per_epoch"] != 1:
            raise SystemExit("the profiled epoch was not one replay")
        n_act, n_kernels, busy, by_name = device_activity(prof)
        traced = {k: 0 for k in ATTN_KERNELS}
        for e in prof.events():
            for k in ATTN_KERNELS:
                if f"{k}_bf16" in e.name and \
                        e.device_type == DeviceType.CUDA:
                    traced[k] += 1
        if traced == counted or attempt:
            break
        log(f"  profiler: the trace holds {traced} attention launches, the "
            f"wrappers counted {counted}: taken again")
    busy /= GPT_STEPS
    r = {"launches": n_act / GPT_STEPS, "kernels": n_kernels / GPT_STEPS,
         "busy_ms": busy, "idle_share": 1 - busy / traced_ms,
         "traced_ms": traced_ms,
         "attention_traced": traced, "attention_counted": counted}
    log(f"  profiler, one replay of the scanned epoch: {r['launches']:.1f} "
        f"device launches a step ({r['kernels']:.1f} kernels), busy "
        f"{busy:.3f} ms a step of the traced epoch's {traced_ms:.2f}: idle "
        f"share {r['idle_share']:.3f} (the timed step: {step_ms:.2f} ms); "
        f"attention kernels in the trace "
        f"{traced}, counted by the wrappers {counted}  [{card}]")
    if traced != counted:
        raise SystemExit(f"the replay's trace holds {traced} attention "
                         f"launches, the wrappers counted {counted}")
    return r


def phase_gpt(dev, card):
    """GPT-medium (hidden 1536, 16 layers, 12 heads of 128, ffn 6144,
    vocab 32768, ~505M parameters), batch 16, seq 512, bf16
    MixedPrecision, Adam(1e-4), through ``build_gpt`` ->
    ``SameDiff.fit(DeviceCachedIterator)`` over ``bench.py``'s data: the
    scanned tier (one CUDA graph replay an epoch), a warm-up epoch, then
    a timed epoch in which every attention of every layer must go
    through the kernels, then one profiled replay; then the per-step
    tier the same way, and two of its steps profiled by group."""
    from deeplearning4j_tpu_torch.autodiff import (MixedPrecision,
                                                   TrainingConfig)
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import GPT_MEDIUM, build_gpt
    cfg = GPT_MEDIUM
    t0 = time.perf_counter()
    sd = build_gpt(cfg, batch=GPT_BATCH, seq_len=GPT_SEQ)
    sd.training_config = TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["targets"], mixed_precision=MixedPrecision())
    it = _gpt_iterator(cfg.vocab_size)
    n_params = sum(p.numel() for p in sd.trainable_params().values())
    torch.cuda.synchronize()
    log(f"  built GPT-medium ({n_params} params) in "
        f"{time.perf_counter() - t0:.1f} s")
    L = cfg.num_layers
    want = {"attention_fwd": 2 * L * GPT_STEPS,
            **{k: L * GPT_STEPS for k in ATTN_KERNELS[1:]}}
    t0 = time.perf_counter()
    warm = sd.fit(it)
    torch.cuda.synchronize()
    log(f"  warm-up epoch ({sd.last_fit_stats['tier']}: warm-up steps, "
        f"capture of {GPT_STEPS} steps, one replay) in "
        f"{time.perf_counter() - t0:.1f} s, losses "
        f"{[round(v, 4) for v in warm.step_losses]}")
    scanned = _gpt_epoch(sd, it, "timed", card)
    if scanned["tier"] != "scanned_epoch" or \
            scanned["graph_replays_per_epoch"] != 1 or \
            scanned["window_captures"]:
        raise SystemExit(f"GPT-medium's timed epoch: {sd.last_fit_stats}")
    _check_gpt_epoch(scanned, want, warm.step_losses[0])
    launches = scanned["launches"]
    metrics = {k: scanned[k] for k in ("step_ms", "tokens_per_s",
                                       "peak_mem_gib", "peak_reserved_gib",
                                       "losses", "dout_copies")}
    metrics["replay_profile"] = profile_gpt_replay(sd, it, scanned["step_ms"],
                                                   card)
    # the per-step tier, the yardstick: the same batches as a list
    steps = list(it)
    sd.fit(steps)
    per_step = _gpt_epoch(sd, steps, "per-step yardstick", card)
    if per_step["tier"] != "per_step":
        raise SystemExit(f"GPT-medium's yardstick ran {per_step['tier']}")
    _check_gpt_epoch(per_step, want, warm.step_losses[0])
    metrics["per_step"] = per_step
    metrics["profile"] = profile_gpt(sd, steps, per_step["step_ms"], card)
    del sd, it, steps
    torch.cuda.empty_cache()
    return launches, metrics


#: device-time groups of the GPT step, by the SameDiff op (or the step's
#: own work) a kernel was launched for
GPT_GROUPS = {
    "scaled_dot_product_attention": "attention (CUDA C++)",
    "matmul": "matmul / einsum (cuBLAS)", "einsum": "matmul / einsum (cuBLAS)",
    "layer_norm": "layer norm", "sparse_softmax_cross_entropy": "CE tail",
    "gelu": "gelu", "bias_add": "bias add / residual add",
    "add": "bias add / residual add", "embedding_lookup": "embedding",
    "slice": "embedding",
    "reshape": "reshape / permute / split copies",
    "permute": "reshape / permute / split copies",
    "split": "reshape / permute / split copies",
}


def profile_gpt(sd, it, step_ms, card):
    """Two GPT steps under torch.profiler: device launches and busy time
    per step, the idle share against the traced steps' own wall time (the
    unprofiled step ``step_ms`` printed beside it), and device time by
    group. Each SameDiff op runs inside a
    ``record_function`` for the profile (the port has none of its own);
    a backward kernel is charged to the op whose forward recorded its
    autograd node (matched by sequence number); the parameter casts and
    their backward, the updater's ``_foreach`` ops and the rest are
    grouped by the aten op that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from deeplearning4j_tpu_torch.autodiff import samediff
    batches = iter(it)
    two = [next(batches), next(batches)]
    real = samediff.SameDiff._run_nodes

    def labelled(nodes, env):
        for node in nodes:
            with record_function(f"sd_op::{node.op}"):
                real([node], env)

    torch.cuda.synchronize()
    samediff.SameDiff._run_nodes = staticmethod(labelled)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sd.fit(two)
            torch.cuda.synchronize()
            traced_ms = 1000 * (time.perf_counter() - t0) / 2
    finally:
        samediff.SameDiff._run_nodes = staticmethod(real)
    events = prof.events()
    # forward aten ops under an sd_op range: sequence number -> group
    seq_group = {}

    def enclosing_op(e):
        p = e
        while p is not None:
            if p.name.startswith("sd_op::"):
                return GPT_GROUPS.get(p.name[len("sd_op::"):], "other op")
            p = p.cpu_parent
        return None

    for e in events:
        if e.device_type == DeviceType.CPU and getattr(
                e, "sequence_nr", -1) >= 0:
            g = enclosing_op(e)
            if g is not None:
                seq_group.setdefault(e.sequence_nr, g)

    def group_of(e):
        g = enclosing_op(e)
        if g is not None:
            return g
        p = e
        while p is not None:
            if p.name.startswith("autograd::engine::evaluate_function") and \
                    getattr(p, "sequence_nr", -1) in seq_group:
                return seq_group[p.sequence_nr] + " (backward)"
            p = p.cpu_parent
        names = []
        p = e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        chain = " ".join(names)
        if "_foreach" in chain:
            return "Adam (_foreach)"
        if "_to_copy" in chain or "ToCopyBackward" in chain:
            return "casts"
        return "other"

    by_group, per_kernel, attn = {}, {}, {}
    n_kernels = 0
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for kern in e.kernels:
            ms = kern.duration / 1e3 / 2
            g = group_of(e)
            by_group[g] = by_group.get(g, 0.0) + ms
            per_kernel[kern.name] = per_kernel.get(kern.name, 0.0) + ms
            n_kernels += 1
            for name in ATTN_KERNELS:
                if name in kern.name:
                    attn[name] = attn.get(name, 0.0) + ms
    busy = sum(by_group.values())
    if busy == 0:
        raise SystemExit("the profiler recorded no device time")
    log(f"  profiler, per step: device busy {busy:.2f} ms of the traced "
        f"steps' own {traced_ms:.2f} ms: idle share "
        f"{1 - busy / traced_ms:.3f} (the unprofiled step: {step_ms:.2f} "
        f"ms); {n_kernels / 2:.0f} device launches  [{card}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:8.3f} ms  {ms / busy:.3f} of busy  {g}")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:8.3f} ms  {key[:100]}")
    log(f"    attention kernels in the step, ms per step: "
        f"{ {k: round(v, 3) for k, v in attn.items()} }")
    if set(attn) != set(ATTN_KERNELS):
        raise SystemExit(f"profiled attention kernels {sorted(attn)}")
    return {"busy_ms": busy, "idle_share": 1 - busy / traced_ms,
            "traced_ms": traced_ms,
            "launches": n_kernels / 2, "by_group_ms": by_group,
            "kernel_ms": attn}


def phase_attention_timing(dev, card_name, per_step):
    """At the GPT path's shape and strides, each attention kernel alone
    (cold L2), its plain version, and the library yardstick
    ``F.scaled_dot_product_attention(..., is_causal=True)`` forward and
    backward (timed only; the port never calls it), each the median of 20
    calls (3 for the plain versions) timed by ``median_ms``, per training
    step (the kernel's launches per step times its time per call), beside
    the least time the card could take; then the host's time of a forward
    call, of its launch alone, and of encoding its three tensor maps."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import attention as at
    bw, flops32 = card_rates(card_name)
    b, h, s, d = GPT_BATCH, 12, GPT_SEQ, 128
    q, k, v, do = attention_inputs(dev, b, h, s, s, d, torch.bfloat16, True)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    sc = 1.0 / math.sqrt(d)
    o, st = at.attention_fwd(q, k, v, True)
    delta = at.bwd_delta_plain(o, do)
    dk, dv, dq = (torch.empty(t.shape, dtype=t.dtype, device=dev)
                  for t in (k, v, q))
    common = dict(o=o, dout=do, stats=st)
    runs = {
        "attention_fwd": (lambda: at.attention_fwd(q, k, v, True),
                          lambda: at.attention_fwd_plain(q, k, v, True)),
        "attention_bwd_delta": (
            lambda: at._launch("dl4j_attention_bwd_delta", q, k, v, sc, True,
                               delta=torch.empty_like(delta), **common),
            lambda: at.bwd_delta_plain(o, do)),
        "attention_bwd_dkdv": (
            lambda: at._launch("dl4j_attention_bwd_dkdv", q, k, v, sc, True,
                               delta=delta, dk=dk, dv=dv, **common),
            lambda: at.bwd_dkdv_plain(q, k, v, do, st, delta, True)),
        "attention_bwd_dq": (
            lambda: at._launch("dl4j_attention_bwd_dq", q, k, v, sc, True,
                               delta=delta, dq=dq, **common),
            lambda: at.bwd_dq_plain(q, k, v, do, st, delta, True)),
    }
    bounds = attention_bounds(b, h, s, s, d, True)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True), flush)
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True), flush)
    out = {}
    for name, (kern, plain) in runs.items():
        per_call = median_ms(kern, flush)
        plain_call = median_ms(plain, flush, 3)
        ops, nbytes = bounds[name]
        rate = BF16_TC_FLOPS if name != "attention_bwd_delta" else flops32
        by_bytes, by_ops = 1e3 * nbytes / bw, 1e3 * ops / rate
        n = per_step[name]
        out[name] = {"ms": n * per_call, "plain_ms": n * plain_call,
                     "bound_ms": n * max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops
                     else "operations",
                     "library_ms": n * lib_fwd if name == "attention_fwd"
                     else None,
                     "per_call_ms": per_call, "plain_per_call_ms": plain_call,
                     "bound_per_call_ms": max(by_bytes, by_ops),
                     "tflops": ops / per_call / 1e9}
        log(f"  {name}: {per_call:.4f} ms a call alone (x{n} per step), "
            f"plain {plain_call:.4f}, bound {max(by_bytes, by_ops):.4f} "
            f"({out[name]['bound_by']}), {ops / per_call / 1e9:.1f} TFLOP/s")
    fwd = out["attention_fwd"]["per_call_ms"]
    bwd = sum(out[k]["per_call_ms"] for k in ATTN_KERNELS[1:])
    bound_f = out["attention_fwd"]["bound_per_call_ms"]
    bound_b = sum(out[k]["bound_per_call_ms"] for k in ATTN_KERNELS[1:])
    ops_f = bounds["attention_fwd"][0]
    ops_b = sum(bounds[k][0] for k in ATTN_KERNELS[1:])
    log(f"  per call (median of 20): kernels forward {fwd:.4f} + backward "
        f"{bwd:.4f} ms; library F.scaled_dot_product_attention forward "
        f"{lib_fwd:.4f} + backward {lib_bwd:.4f} ms (timed only)")
    log(f"  kernel/library: forward {fwd / lib_fwd:.3f}, backward "
        f"{bwd / lib_bwd:.3f}; TFLOP/s kernels {ops_f / fwd / 1e9:.1f} / "
        f"{ops_b / bwd / 1e9:.1f}, library {ops_f / lib_fwd / 1e9:.1f} / "
        f"{ops_b / lib_bwd / 1e9:.1f}; bound/kernel forward "
        f"{bound_f / fwd:.3f}, backward {bound_b / bwd:.3f}")
    for name in ATTN_KERNELS[1:]:
        out[name]["library_pass_ms"] = per_step[name] * lib_bwd
    out["attention_fwd"]["library_pass_ms"] = per_step["attention_fwd"] * \
        lib_fwd
    # the host's side of a forward call (the GPT step's idle share is the
    # host's): the whole wrapper; its launch alone (outputs allocated
    # before); the delta kernel's launch through the same C entry and
    # arguments, which encodes no tensor map and launches plainly; and
    # the forward's three tensor maps encoded alone
    # (the host's clock is noisy: 7 rounds of 100 calls each, the three
    # taken in turn, and the median round)
    out_, st_, dl_ = (torch.empty_like(t) for t in (o, st, delta))
    calls = {
        "wrapper": lambda: at.attention_fwd(q, k, v, True),
        "launch": lambda: at._launch("dl4j_attention_fwd", q, k, v, sc, True,
                                     out=out_, stats=st_),
        "delta": lambda: at._launch("dl4j_attention_bwd_delta", q, k, v, sc,
                                    True, delta=dl_, **common)}
    rounds = {what: [] for what in calls}
    for _ in range(7):
        for what, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            rounds[what].append(1e4 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    host = {what: float(np.median(r)) for what, r in rounds.items()}
    enc_us = tensor_map_encode_us((q, k, v), 128)
    log(f"  host time of a forward call: {host['wrapper']:.1f} us (wrapper: "
        f"checks, outputs, launch), {host['launch']:.1f} us (its launch: "
        f"arguments, the C entry, 3 tensor maps, the persistent launch); "
        f"the delta kernel's launch {host['delta']:.1f} us (no tensor map, "
        f"a plain launch); the forward's 3 maps encoded alone through "
        f"ctypes {enc_us:.2f} us (ctypes' cost included)")
    del flush, q, k, v, do
    torch.cuda.empty_cache()
    return out, {"lib_fwd_ms": lib_fwd, "lib_bwd_ms": lib_bwd,
                 "host_us": host, "encode_us": enc_us}


# ----------------------------------------------------------------------
# generative serving (csrc/paged_attention.cu) and the GPT-medium server
PAGED_SOURCE = "deeplearning4j_tpu_torch/csrc/paged_attention.cu"
#: the JAX code the kernel stands in for (XLA fused it; no Pallas kernel)
PAGED_REPLACES = "deeplearning4j_tpu/zoo/gpt.py:649"
PAGED_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SERVE_SLOTS, SERVE_BS, SERVE_SEQ, SERVE_REQUESTS = 8, 16, 1024, 32
F32_SOURCE = "deeplearning4j_tpu_torch/csrc/attention_f32.cu"
#: the JAX code each float32 kernel stands in for (XLA fused it; no Pallas
#: kernel): the op the dense prefill calls, the paged prefill's attention
F32_REPLACES = {"attention_fwd_f32": "deeplearning4j_tpu/ops/nn_ops.py:462",
                "paged_prefill_f32": "deeplearning4j_tpu/zoo/gpt.py:586"}


def check_paged(args, errs, label, controls=True, dense=False):
    """The kernel against its plain version on ``args`` (q, kc, vc, tables,
    lane, kmax): per element within 1e-5 (float32) or 1e-12 (float64) of
    the sum of its absolute terms; two calls bit-equal; with NaN in the
    null block, the unused blocks and past each lane's last key, the same
    bits and finite; for a decode case (``dense``) the same contexts as a
    dense slab give the same bits. ``controls``: the rule must reject the
    plain version of a mask off by one (t < kmax) and of a table whose
    first entries are one block off. Prints one line; exits on a
    failure."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, kc, vc, tables, lane, kmax = args
    tol = PAGED_TOL[q.dtype]
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    terms = pa.abs_terms(*args)
    torch.cuda.synchronize()
    reading = measure.paged_reading(got, want, terms, tol)
    errs["paged_attention"] = max(errs.get("paged_attention", 0.0), float(
        (got.double() - want.double()).abs().max()))
    same = torch.equal(got, again)
    pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
    poisoned = pa.paged_attention(q, pk, pv, tables, lane, kmax)
    poison_ok = bool(torch.isfinite(poisoned).all()) and torch.equal(
        poisoned, got)
    dense_ok = True
    if dense:
        dk, dv, dt = measure.paged_dense(kc, vc, tables)
        dense_ok = torch.equal(pa.paged_attention(q, dk, dv, dt, lane, kmax),
                               got)
    ctl = ""
    ctl_ok = True
    if controls:
        shifted = tables.clone()
        shifted[:, 0] += 1
        r_mask = measure.paged_reading(pa.paged_attention_plain(
            q, kc, vc, tables, lane, kmax - 1), got, terms, tol)
        r_table = measure.paged_reading(pa.paged_attention_plain(
            q, kc, vc, shifted, lane, kmax), got, terms, tol)
        ctl_ok = r_mask > 1 and r_table > 1
        ctl = (f"; controls (must exceed 1): mask t < kmax {r_mask:.3g}, "
               f"table entry one block off {r_table:.3g}")
    ok = reading <= 1 and same and poison_ok and dense_ok and ctl_ok
    log(f"  {label}: {reading:.3g} of tol, bit-equal twice {same}, NaN "
        f"poison unchanged {poison_ok}" + (f", dense = paged bits "
                                           f"{dense_ok}" if dense else "")
        + ctl + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("paged_attention disagrees with its plain version")


def check_paged_decode(args, errs, label, controls=True, dense=False):
    """``paged_decode_attention`` (the step's K/V write, then attention) on
    ``args`` (``measure.paged_decode_write_case``'s) against its plain
    version (``index_put_``, then the attention), each on its own copy of
    the cache: per element within 1e-5 (float32) or 1e-12 (float64) of the
    sum of its absolute terms; the caches after the write bit-equal to the
    plain write's; two calls give the same bits; with NaN in the null
    block, the unused blocks, past each lane's last key and where the step
    writes, the same bits and finite; for a ``dense`` case the same
    contexts as a dense slab, written at (slot, position), give the same
    bits and the same written slab. ``controls``: the rule must reject the
    plain version of a write one offset off and the attention with one
    chunk of 16 keys dropped. Prints one line; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo = args
    tol = PAGED_TOL[q.dtype]

    def run(fn, kc_, vc_, tables_=tables, wb_=wb, wo_=wo):
        k2, v2 = kc_.clone(), vc_.clone()
        return fn(q, k_new, v_new, k2, v2, tables_, lane, kmax, wb_,
                  wo_), k2, v2
    before = pa.LAUNCHES["paged_decode_attention"]
    got, gk, gv = run(pa.paged_decode_attention, kc, vc)
    again, ak, av = run(pa.paged_decode_attention, kc, vc)
    launched = pa.LAUNCHES["paged_decode_attention"] - before
    want, wk, wv = run(pa.paged_decode_plain, kc, vc)
    terms = pa.abs_terms(q, wk, wv, tables, lane, kmax)
    torch.cuda.synchronize()
    reading = measure.paged_reading(got, want, terms, tol)
    errs["paged_decode_attention"] = max(errs.get(
        "paged_decode_attention", 0.0), float(
        (got.double() - want.double()).abs().max()))
    rows = torch.equal(gk, wk) and torch.equal(gv, wv)
    same = torch.equal(got, again) and torch.equal(gk, ak) and \
        torch.equal(gv, av)
    pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
    pk, pv = measure.paged_write_poisoned(pk, pv, wb, wo)
    poisoned = run(pa.paged_decode_attention, pk, pv)[0]
    poison_ok = bool(torch.isfinite(poisoned).all()) and torch.equal(
        poisoned, got)
    dense_ok = True
    if dense:
        dk, dv, dt = measure.paged_dense(kc, vc, tables)
        slot = torch.where(wb >= 0, dt[:, 0], -1).to(torch.int32)
        dout, dkk, dvv = run(pa.paged_decode_attention, dk, dv, dt, slot,
                             kmax)
        wdk, wdv, _ = measure.paged_dense(gk, gv, tables)
        dense_ok = torch.equal(dout, got) and torch.equal(dkk, wdk) and \
            torch.equal(dvv, wdv)
    ctl, ctl_ok = "", True
    if controls:
        off = torch.where(wb >= 0, (wo + 1) % kc.shape[2], wo)
        r_write = measure.paged_reading(
            run(pa.paged_decode_plain, kc, vc, wo_=off)[0], got, terms, tol)
        r_chunk = measure.paged_reading(measure.paged_chunk_dropped(
            q, wk, wv, tables, lane, kmax, 1), got, terms, tol)
        ctl_ok = r_write > 1 and r_chunk > 1
        ctl = (f"; controls (must exceed 1): write one offset off "
               f"{r_write:.3g}, chunk 1 dropped {r_chunk:.3g}")
    ok = (reading <= 1 and rows and same and poison_ok and dense_ok
          and ctl_ok and launched == 2)
    log(f"  {label}: {reading:.3g} of tol, written cache bit-equal {rows}, "
        f"bit-equal twice {same}, NaN poison unchanged {poison_ok}"
        + (f", dense = paged bits {dense_ok}" if dense else "") + ctl
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("paged_decode_attention disagrees with its plain "
                         "version")


def check_paged_prefill(args, errs, label, controls=True):
    """``paged_prefill_attention`` on ``args`` (a prefill case: q, kc, vc,
    tables [1, MAXB], lane, kmax) against its plain version, per element
    within 1e-5 (float32) or 1e-12 (float64) of the sum of its absolute
    terms, called as the server calls it (with the host's kmax) and, in
    float32, the kernel at two other work splits (items of 64 keys, and
    one item a tile); float32 launches
    ``attention_f32``'s kernel and float64 ``paged_attention``; two calls
    bit-equal; with NaN in the null block, the unused blocks and past the
    lane's last key, the same bits and finite. ``controls``: the rule must
    reject the plain version of a mask off by one (t < kmax) and of a
    table whose first entry is one block off. Prints one line; exits on a
    failure."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, kc, vc, tables, lane, kmax = args
    table, kh = tables[0], kmax.cpu().numpy()
    tol = PAGED_TOL[q.dtype]
    f32 = q.dtype == torch.float32
    before = (af.LAUNCHES["paged_prefill_f32"], pa.LAUNCHES["paged_attention"])
    got = pa.paged_prefill_attention(q, kc, vc, table, kmax, kh)
    again = pa.paged_prefill_attention(q, kc, vc, table, kmax, kh)
    routed = (af.LAUNCHES["paged_prefill_f32"] - before[0],
              pa.LAUNCHES["paged_attention"] - before[1]) == (
        (2, 0) if f32 else (0, 2))
    reach = kc.shape[2] * table.shape[0]
    splits = [measure.paged_prefill_at_chunk(q, kc, vc, table, kmax, ch)
              for ch in (af.CHUNK_ALIGN, -(-reach // af.CHUNK_ALIGN)
                         * af.CHUNK_ALIGN)] if f32 else []
    want = pa.paged_prefill_plain(q, kc, vc, table, kmax)
    terms = pa.abs_terms(*args)
    torch.cuda.synchronize()
    reading = max(measure.paged_reading(x, want, terms, tol)
                  for x in [got] + splits)
    name = "paged_prefill_f32" if f32 else "paged_attention"
    errs[name] = max(errs.get(name, 0.0), float(
        (got.double() - want.double()).abs().max()))
    same = torch.equal(got, again)
    pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
    poisoned = pa.paged_prefill_attention(q, pk, pv, table, kmax, kh)
    poison_ok = bool(torch.isfinite(poisoned).all()) and torch.equal(
        poisoned, got)
    ctl, ctl_ok = "", True
    if controls:
        shifted = table.clone()
        shifted[0] += 1
        r_mask = measure.paged_reading(pa.paged_prefill_plain(
            q, kc, vc, table, kmax - 1), got, terms, tol)
        r_table = measure.paged_reading(pa.paged_prefill_plain(
            q, kc, vc, shifted, kmax), got, terms, tol)
        ctl_ok = r_mask > 1 and r_table > 1
        ctl = (f"; controls (must exceed 1): mask t < kmax {r_mask:.3g}, "
               f"table entry one block off {r_table:.3g}")
    ok = reading <= 1 and same and poison_ok and ctl_ok and routed
    log(f"  {label}: {reading:.3g} of tol, bit-equal twice {same}, NaN "
        f"poison unchanged {poison_ok}, routed {routed}" + ctl
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("paged_prefill_attention disagrees with its plain "
                         "version")


def check_f32_alignment_copies(dev):
    """float32 q, k, v whose rows are 65 floats apart, and a prefill q
    whose heads are 3D + 1 floats apart (not on 16 bytes, as the float32
    kernels' 16-byte copies need): the wrappers copy each (counted), and
    the outputs equal those of the same values laid out contiguously."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, k, v, _ = attention_inputs(dev, 1, 2, 129, 129, 64, torch.float32,
                                  False)
    wide = [torch.zeros(1, 2, 129, 65, device=dev) for _ in range(3)]
    for w, t in zip(wide, (q, k, v)):
        w[..., :64] = t
    af.reset_launches()
    got = at.attention_fwd(*(w[..., :64] for w in wide), True)
    dense_copies = af.ALIGN_COPIES["attention_fwd_f32"]
    want = at.attention_fwd(q, k, v, True)
    pq, kc, vc, tables, _, kmax = measure.paged_prefill_case(
        dev, 15, 65, 65, 2, 32, 16, torch.float32)
    odd = torch.zeros(65, 2, 97, device=dev)
    odd[..., :32] = pq
    kh = kmax.cpu().numpy()
    pgot = pa.paged_prefill_attention(odd[..., :32], kc, vc, tables[0], kmax,
                                      kh)
    pwant = pa.paged_prefill_attention(pq.contiguous(), kc, vc, tables[0],
                                       kmax, kh)
    torch.cuda.synchronize()
    copies = (dense_copies, af.ALIGN_COPIES["paged_prefill_f32"])
    same = all(torch.equal(x, y) for x, y in zip(got, want)) and \
        torch.equal(pgot, pwant)
    ok = same and copies == (3, 1)
    log(f"  float32 rows 65 floats apart (dense) and heads 97 floats apart "
        f"(prefill q): copies {copies}, outputs equal to the contiguous "
        f"calls' {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the float32 alignment copies are wrong")


def phase_paged_kernels(dev, errs):
    """``paged_decode_attention`` against its plain version: GPT-medium
    decode (8 lanes, 12 heads of 128, blocks of 16, last keys 0..1023, one
    lane inactive) and block sizes 1, 16 and 1024 at head dims 16-128, in
    float32 and float64. ``paged_attention`` (the same kernel with no
    write) against its plain version: GPT-medium
    decode (8 lanes, 12 heads of 128, blocks of 16, last keys 0..1023),
    block sizes 1, 8, 16, 160 and 1024 at head dims 16-128 with last keys
    0, at block edges (15, 16, 17) and inside a partly filled last block,
    in float32 and float64. The prefill function: GPT-medium's (512 rows
    after a 256-token prefix with padded rows, and cold) in float32 (the
    tensor-core kernel) and float64 (``paged_attention``); then the float32
    kernel at every hist in (0, 15, 256, 1000), rows in (1, 63, 64, 65,
    512) and block size in (1, 16, 160, 1024), and at head dims 16-64."""
    from deeplearning4j_tpu_torch.kernels import measure
    ctx = [0, 15, 16, 17, 127, 300, 511, 1023]
    for dt in (torch.float32, torch.float64):
        check_paged_decode(measure.paged_decode_write_case(
            dev, ctx, 12, 128, 16, dt, active=[True] * 6 + [False, True]),
            errs, f"decode with the write 8x12x128 BS 16 last keys {ctx} "
            f"(lane 6 inactive) {str(dt)[6:]}", dense=True)
        for bs in (1, 16, 1024):
            for d in (16, 32, 64, 128):
                check_paged_decode(measure.paged_decode_write_case(
                    dev, [0, 15, 16, 17, 150, 1023], 3, d, bs, dt,
                    active=[True, True, False, True, True, True],
                    seed=bs + d), errs, f"decode with the write BS {bs} "
                    f"D {d} {str(dt)[6:]}", controls=bs == 16,
                    dense=d == 128)
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        check_paged(measure.paged_decode_case(dev, ctx, 12, 128, 16, dt),
                    errs, f"decode 8x12x128 BS 16 last keys {ctx} {name}",
                    dense=True)
        for hist, rows, length in ((256, 512, 500), (0, 512, 512)):
            check_paged_prefill(measure.paged_prefill_case(
                dev, hist, rows, length, 12, 128, 16, dt),
                errs, f"prefill {rows} rows x12x128 BS 16 hist {hist} "
                f"length {length} {name}")
    for hist in (0, 15, 256, 1000):
        for rows in (1, 63, 64, 65, 512):
            for bs in (1, 16, 160, 1024):
                check_paged_prefill(measure.paged_prefill_case(
                    dev, hist, rows, rows, 4, 128, bs, torch.float32,
                    seed=hist + rows + bs), errs,
                    f"prefill {rows} rows x4x128 BS {bs} hist {hist} "
                    f"float32")
    for d in (16, 32, 64):
        check_paged_prefill(measure.paged_prefill_case(
            dev, 15, 65, 60, 3, d, 16, torch.float32, seed=d), errs,
            f"prefill 65 rows (60 real) x3x{d} BS 16 hist 15 float32")
    check_f32_alignment_copies(dev)
    for bs in (1, 8, 160, 1024):
        for d in (16, 32, 64, 128):
            for dt in (torch.float32, torch.float64):
                check_paged(measure.paged_decode_case(
                    dev, [0, 15, 16, 17, 150, 1023], 3, d, bs, dt,
                    seed=bs + d), errs,
                    f"decode BS {bs} D {d} {str(dt)[6:]}",
                    controls=bs == 8, dense=d == 128)


#: card-vs-CPU serving parity: each dispatch's logits within this share of
#: their magnitude (float32: the card's 3xTF32 attention and cuBLAS sum in
#: other orders than the CPU's plain versions, each about 2^-21 a product)
SERVE_PARITY_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _serve_tiny(kind, dev, dtype, prompts):
    """GPT_TINY (build_gpt's seed) at ``dtype`` through the ``kind``
    ("paged" or "dense") server on ``dev``: ``prompts`` queued before the
    worker starts (so both devices admit in the same order), 16 new tokens
    each. Returns (tokens, each dispatch's logits on the host, prefix
    blocks hit, the attention kernels' launches)."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_TINY, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device=dev)
    for n, a in sd.trainable_params().items():
        sd.set_arr_for_var(n, a.to(dtype))
    if kind == "paged":
        srv = PagedGenerativeServer(gpt_paged_spec(sd, GPT_TINY),
                                    max_slots=2, block_size=8, start=False,
                                    device=dev, debug_leaks=True)
    else:
        srv = GenerativeServer(gpt_generative_spec(sd, GPT_TINY),
                               max_slots=2, start=False, device=dev)
    logits = []
    for attr in ("_prefill_disp", "_decode_disp"):
        real = getattr(srv, attr)

        def recording(*a, _real=real):
            out = _real(*a)
            lg = out[3].detach().cpu()
            if "active" in a[3]:           # a decode: its active lanes
                lg = lg[np.flatnonzero(a[3]["active"])]
            logits.append(lg)
            return out
        setattr(srv, attr, recording)

    def counts():
        return {**pa.LAUNCHES, **af.LAUNCHES,
                "attention_fwd": at.LAUNCHES["attention_fwd"]}
    before = counts()
    hs = [srv.submit(p, max_new_tokens=16) for p in prompts]
    srv.start()
    toks = [h.result(timeout=300) for h in hs]
    srv.shutdown()
    launched = {k: v - before[k] for k, v in counts().items() if v > before[k]}
    return (toks, logits, srv.metrics.counters.get("prefix_blocks_hit", 0),
            launched)


def phase_serving_parity():
    """GPT_TINY through the servers on the card and on the CPU (whose
    attention is the plain PyTorch versions), the same prompts, one with
    a prefix hit: PagedGenerativeServer in float64 and in float32, and
    GenerativeServer in float32. The same greedy tokens, and every
    dispatch's logits within SERVE_PARITY_TOL of their magnitude. The
    float32 runs hold the float32 attention kernels (the paged and the
    dense prefill) to code that shares nothing with them."""
    from deeplearning4j_tpu_torch.zoo import GPT_TINY
    rng = np.random.default_rng(0)
    shared = rng.integers(0, GPT_TINY.vocab_size, 24).astype(np.int32)
    prompts = [shared, np.concatenate([shared, rng.integers(
        0, GPT_TINY.vocab_size, 5)]).astype(np.int32),
        rng.integers(0, GPT_TINY.vocab_size, 9).astype(np.int32)]
    # (server, dtype, the kernels that must have served it on the card)
    for kind, dtype, want in (
            ("paged", torch.float64, ("paged_attention",
                                      "paged_decode_attention")),
            ("paged", torch.float32, ("paged_prefill_f32",
                                      "paged_decode_attention")),
            ("dense", torch.float32, ("attention_fwd_f32",
                                      "paged_decode_attention"))):
        (tc, lc, hc, nc), (th, lh, hh, _) = (
            _serve_tiny(kind, dev, dtype, prompts) for dev in ("cuda", "cpu"))
        tol = SERVE_PARITY_TOL[dtype]
        worst = max(_tensor_rel(a, b) for a, b in zip(lc, lh)) \
            if len(lc) == len(lh) else math.inf
        routed = all(nc.get(k, 0) > 0 for k in want) and \
            nc.get("attention_fwd", 0) == 0
        log(f"  {str(dtype)[6:]} GPT_TINY {kind} serving, card vs cpu: "
            f"tokens identical {tc == th}, {len(lc)} dispatches' logits "
            f"worst {worst:.2e} (tol {tol:g}), prefix blocks hit {hc}/{hh}, "
            f"attention launches on the card {nc}")
        if not (tc == th and worst <= tol and routed
                and (kind == "dense" or hc >= 1)):
            raise SystemExit(f"{kind} serving in {dtype} on the card "
                             f"disagrees with the CPU")


def serving_traffic(vocab):
    """32 requests from numpy seed 0: prompt lengths uniform over 16-512;
    new tokens 80% in 2-8 and 20% in 64-128 (bench_serving_paged's
    long-tail mix, scaled to max_seq 1024); 8 of them share a 256-token
    prefix (its own suffix of 16-256 tokens after it)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 256).astype(np.int32)
    reqs = []
    for i in range(SERVE_REQUESTS):
        if i % 4 == 1:
            p = np.concatenate([shared, rng.integers(
                0, vocab, int(rng.integers(16, 257)))]).astype(np.int32)
        else:
            p = rng.integers(0, vocab, int(rng.integers(16, 513))).astype(
                np.int32)
        n = int(rng.integers(64, 129)) if rng.random() < 0.2 else int(
            rng.integers(2, 9))
        reqs.append((p, n))
    return reqs


def verify_mixes():
    """Each lane's context (None: an idle lane) at two verify launches of
    phase 19's traffic (``serving_traffic``): its first round (the first 8
    prompts) and a round of its long tail (the first 8 requests of 64-128
    new tokens half-way through them; idle lanes where there are fewer)."""
    from deeplearning4j_tpu_torch.zoo import GPT_MEDIUM
    reqs = serving_traffic(GPT_MEDIUM.vocab_size)
    tail = [len(p) + n // 2 for p, n in reqs if n >= 64][:SERVE_SLOTS]
    return {"first round": [len(p) for p, _ in reqs[:SERVE_SLOTS]],
            "long tail": tail + [None] * (SERVE_SLOTS - len(tail))}


def greedy_logits(spec, prompt, n, dev):
    """The port's greedy_decode, keeping each step's logits on the host."""
    from deeplearning4j_tpu_torch.serving.generative import _slab
    msl = SERVE_SEQ
    kc = _slab(spec.kv_shape(1, msl), spec.kv_dtype, dev)
    vc = _slab(spec.kv_shape(1, msl), spec.kv_dtype, dev)
    params = spec.params()
    L = len(prompt)
    b = 1 << (L - 1).bit_length()
    out, lg = [], []
    with torch.inference_mode():
        kc, vc, nxt, logits = spec.prefill(params, kc, vc, {
            "tokens": np.pad(prompt, (0, b - L)), "length": np.int32(L),
            "slot": np.int32(0)})
        out.append(int(nxt))
        lg.append(logits.cpu())
        pos = L
        while len(out) < n and pos + 1 < msl:
            kc, vc, nxt, logits = spec.decode(params, kc, vc, {
                "tokens": np.array([out[-1]], np.int32),
                "positions": np.array([pos], np.int32),
                "active": np.array([True])})
            pos += 1
            out.append(int(nxt.cpu()[0]))
            lg.append(logits[0].cpu())
    return out, lg


def check_against_greedy(dense_spec, reqs, got, dev):
    """Each request's tokens against the port's greedy_decode on the card.
    cuBLAS picks GEMM kernels by M, so 8 lanes and 1 lane may round
    differently: where a token differs, the reference's top-2 logit
    margin at the first differing position must be below 1e-4 of the
    logits' scale (a near tie). Returns (identical, near ties)."""
    from deeplearning4j_tpu_torch.serving.generative import greedy_decode
    same, ties = 0, []
    for i, ((p, n), toks) in enumerate(zip(reqs, got)):
        ref = greedy_decode(dense_spec, p, n, max_seq_len=SERVE_SEQ)
        if ref == toks:
            same += 1
            continue
        ref2, lg = greedy_logits(dense_spec, p, n, dev)
        j = next(k for k in range(min(len(ref2), len(toks)))
                 if ref2[k] != toks[k])
        top = torch.topk(lg[j].double(), 2).values
        margin = float(top[0] - top[1])
        scale = float(lg[j].abs().max())
        log(f"    request {i}: first differing token {j} (served "
            f"{toks[j]}, reference {ref2[j]}), reference top-2 margin "
            f"{margin:.3e}, {margin / scale:.3e} of the logits' scale "
            f"{scale:.3f}")
        if ref2 != ref or margin >= 1e-4 * scale:
            raise SystemExit(f"request {i}: served tokens differ from "
                             f"greedy_decode beyond a near tie")
        ties.append((i, j, margin / scale))
    return same, ties


PAGED_FNS = ("paged_decode_attention", "paged_prefill_attention")


def _record_shapes(pa, shapes):
    """Wrap ``pa``'s paged functions (``PAGED_FNS``) to record each call's
    (kind, N, A, D, BS, MAXB, table rows, dtype); returns the real
    functions, to be put back with ``_restore``."""
    real = [getattr(pa, n) for n in PAGED_FNS]

    def decode(q, k_new, v_new, kc, vc, tables, *rest):
        shapes.add(("decode", *q.shape, kc.shape[2], tables.shape[1],
                    tables.shape[0], str(q.dtype)[6:]))
        return real[0](q, k_new, v_new, kc, vc, tables, *rest)

    def prefill(q, kc, vc, table, kmax, kmax_host, *scales):
        shapes.add(("prefill", *q.shape, kc.shape[2], table.shape[0], 1,
                    str(q.dtype)[6:]))
        return real[1](q, kc, vc, table, kmax, kmax_host, *scales)
    for n, f in zip(PAGED_FNS, (decode, prefill)):
        setattr(pa, n, f)
    return real


def _restore(pa, real):
    for n, f in zip(PAGED_FNS, real):
        setattr(pa, n, f)


def phase_serving(dev, card):
    """GPT-medium at full width (hidden 1536, 16 layers, 12 heads of 128,
    vocab 32768, max_seq 1024), float32 weights from ``build_gpt(...,
    seed=0)``, served through ``gpt_paged_spec`` by
    ``PagedGenerativeServer(max_slots=8, block_size=16, max_seq_len=1024)``
    (its default pool: 513 blocks, the dense-equivalent floor): the 32
    requests of ``serving_traffic``, temperature 0, submitted at once,
    through ``submit`` / ``result()``. Counts reset just before, read just
    after: paged_decode_attention must launch 16 times a decode step and
    paged_prefill_f32 16 times a prefill, no other attention kernel. Each
    request against greedy_decode; the pool drains clean. Then the dense
    ``GenerativeServer`` over ``gpt_generative_spec`` serves 8 of the
    requests (counts reset and read around it; each against
    greedy_decode): its prefill launches attention_fwd_f32 and its decode
    paged_decode_attention, 16 times each. Then the decode steps' and the
    prefills' profiles. Returns (launches of each path, shapes handed to
    the paged functions, metrics)."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import (PagedGenerativeServer,
                                                        PoolExhaustedError)
    from deeplearning4j_tpu_torch.zoo import (GPT_MEDIUM, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    cfg = GPT_MEDIUM
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()      # what earlier phases hold
    t0 = time.perf_counter()
    sd = build_gpt(cfg, batch=1, seq_len=8, seed=0)
    spec, dense_spec = gpt_paged_spec(sd, cfg), gpt_generative_spec(sd, cfg)
    reqs = serving_traffic(cfg.vocab_size)
    torch.cuda.synchronize()
    log(f"  built GPT-medium float32 ({sum(p.numel() for p in spec.params().values())} "
        f"params) in {time.perf_counter() - t0:.1f} s; requests: prompts "
        f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)} "
        f"tokens, {sum(n for _, n in reqs)} new tokens in all")
    t0 = time.perf_counter()
    srv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                block_size=SERVE_BS, max_seq_len=SERVE_SEQ)
    log(f"  server up in {time.perf_counter() - t0:.1f} s: pool "
        f"{srv.pool.num_blocks} blocks x {srv.bytes_per_block / 2**20:.1f} "
        f"MiB = {srv.kv_slab_bytes / 2**30:.2f} GiB; warmup "
        f"{srv.warmup_report}")
    steps, hist_of = [], {}
    real_obs = srv.metrics.observe_decode_step

    def obs(active, ms):
        steps.append((active, ms))
        real_obs(active, ms)
    srv.metrics.observe_decode_step = obs
    real_prefill = srv._prefill

    def prefill(s, req):
        before = srv.metrics.counters["prefix_blocks_hit"]
        real_prefill(s, req)
        hist_of[req.id] = srv.metrics.counters["prefix_blocks_hit"] - before
    srv._prefill = prefill
    shapes = set()
    real_pa = _record_shapes(pa, shapes)
    times = [[] for _ in reqs]
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pa.reset_launches()
        at.reset_launches()
        af.reset_launches()
        t0 = time.perf_counter()
        # every request submitted at once; one the pool sheds (its
        # worst-case blocks do not fit beside the committed load) is
        # submitted again after the server's backoff hint, as a client
        # does; its TTFT counts from its first attempt
        submit_t = [t0] * len(reqs)
        hs = [None] * len(reqs)
        pending, sheds = list(range(len(reqs))), 0
        while pending:
            still, hint = [], 0.05
            for i in pending:
                p, n = reqs[i]
                try:
                    hs[i] = srv.submit(p, max_new_tokens=n, on_token=lambda
                                       t, i=i: times[i].append(
                                           time.perf_counter()))
                except PoolExhaustedError as e:
                    sheds += 1
                    still.append(i)
                    hint = min(hint, e.retry_after_s)
            pending = still
            if pending:
                time.sleep(hint)
        got = [h.result(timeout=600) for h in hs]
        wall = time.perf_counter() - t0
        launches = {**pa.LAUNCHES, **af.LAUNCHES,
                    "attention_fwd": at.LAUNCHES["attention_fwd"]}
        combines = launches.pop("attention_f32_combine")
    finally:
        _restore(pa, real_pa)
    peak = torch.cuda.max_memory_allocated()
    srv.shutdown()
    rec = srv.metrics.to_record()
    n_tok = sum(len(t) for t in got)
    ttft = {True: [], False: []}
    for i, h in enumerate(hs):
        ttft[hist_of[h.id] > 0].append(1e3 * (times[i][0] - submit_t[i]))
    gaps = [1e3 * (b - a) for t in times for a, b in zip(t, t[1:])]
    step_ms = [ms for _, ms in steps]
    log(f"  served {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s; {len(steps)} decode steps (mean "
        f"{np.mean([a for a, _ in steps]):.2f} lanes active), "
        f"{rec['generative']['prefills']} prefills; {sheds} submits shed "
        f"by the pool and retried  [{card}]")
    for hit, v in ttft.items():
        log(f"  TTFT {'prefix hit' if hit else 'cold'} ({len(v)}): p50 "
            f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} "
            f"ms")
    log(f"  inter-token p50 {np.percentile(gaps, 50):.2f} ms, p99 "
        f"{np.percentile(gaps, 99):.2f} ms; decode step wall p50 "
        f"{np.percentile(step_ms, 50):.2f} ms, p99 "
        f"{np.percentile(step_ms, 99):.2f} ms; serving's peak memory "
        f"{(peak - base) / 2**30:.2f} GiB ({(held - base) / 2**30:.2f} GiB "
        f"before the requests: weights and pool; the card's peak "
        f"{peak / 2**30:.2f} GiB with what earlier phases hold); prefix "
        f"blocks hit "
        f"{rec['paged']['prefix_blocks_hit']}")
    n_dec, n_pre = rec["generative"]["decode_steps"], rec["generative"][
        "prefills"]
    log(f"  launches {launches} over {n_dec} decode steps and {n_pre} "
        f"prefills, and {combines} launches of the float32 kernels' "
        f"combining kernel; shapes handed to the paged functions "
        f"{sorted(shapes)}")
    want = {"paged_decode_attention": cfg.num_layers * n_dec,
            "paged_attention": 0, "paged_verify_attention": 0,
            "paged_prefill_f32": cfg.num_layers * n_pre,
            "attention_fwd_f32": 0, "attention_fwd": 0}
    if launches != want:
        raise SystemExit(f"paged serving launched {launches}, want {want}: "
                         f"{cfg.num_layers} paged_decode_attention a decode "
                         f"step and {cfg.num_layers} paged_prefill_f32 a "
                         f"prefill")
    check_combines(combines, launches["paged_prefill_f32"], cfg.num_layers)
    if not ttft[True]:
        raise SystemExit("no request hit the prefix cache")
    st = srv.pool.stats()
    srv.pool.check_invariant(tables=[])
    deadline = time.monotonic() + 10
    while srv._committed and time.monotonic() < deadline:
        time.sleep(0.01)
    log(f"  pool after the run: {st}, committed {srv._committed}: "
        f"{'clean' if st['held'] == 0 and srv._committed == 0 else 'LEAK'}")
    if st["held"] or srv._committed:
        raise SystemExit("the block pool did not drain")
    t0 = time.perf_counter()
    same, ties = check_against_greedy(dense_spec, reqs, got, dev)
    log(f"  against greedy_decode on the card: {same} of {len(reqs)} "
        f"identical, {len(ties)} near ties {ties} "
        f"({time.perf_counter() - t0:.1f} s)")
    metrics = {"tokens_per_s": n_tok / wall, "wall_s": wall, "sheds": sheds,
               "tokens": n_tok, "ttft_ms": ttft, "gaps_ms": gaps,
               "step_ms": step_ms, "peak_gib": (peak - base) / 2**30}

    # the dense server: its prefill is the attention_fwd kernel's path
    dense_shapes = set()
    real_pa = _record_shapes(pa, dense_shapes)
    try:
        dsrv = GenerativeServer(dense_spec, max_slots=SERVE_SLOTS,
                                max_seq_len=SERVE_SEQ)
        torch.cuda.synchronize()
        pa.reset_launches()
        at.reset_launches()
        af.reset_launches()
        sub = reqs[:8]
        t0 = time.perf_counter()
        dgot = [h.result(timeout=600) for h in
                [dsrv.submit(p, max_new_tokens=n) for p, n in sub]]
        dwall = time.perf_counter() - t0
        dlaunch = {**pa.LAUNCHES, **af.LAUNCHES,
                   "attention_fwd": at.LAUNCHES["attention_fwd"]}
        dcombines = dlaunch.pop("attention_f32_combine")
        dsrv.shutdown()
    finally:
        _restore(pa, real_pa)
    drec = dsrv.metrics.to_record()["generative"]
    dn = sum(len(t) for t in dgot)
    log(f"  dense GenerativeServer, 8 of the requests: {dn} tokens in "
        f"{dwall:.3f} s ({dn / dwall:.1f} tokens/s), launches {dlaunch} "
        f"over {drec['prefills']} prefills and {drec['decode_steps']} "
        f"decode steps, and {dcombines} combining launches; tokens equal the paged server's "
        f"{sum(a == b for a, b in zip(dgot, got))} of 8")
    dwant = {"paged_decode_attention": cfg.num_layers * drec["decode_steps"],
             "paged_attention": 0, "paged_verify_attention": 0,
             "paged_prefill_f32": 0,
             "attention_fwd_f32": cfg.num_layers * drec["prefills"],
             "attention_fwd": 0}
    if dlaunch != dwant:
        raise SystemExit(f"dense serving launches {dlaunch}, want {dwant}")
    check_combines(dcombines, dlaunch["attention_fwd_f32"], cfg.num_layers)
    dsame, dties = check_against_greedy(dense_spec, sub, dgot, dev)
    log(f"  the dense server against greedy_decode on the card: {dsame} of "
        f"{len(sub)} identical, {len(dties)} near ties {dties}")
    metrics["prefill_profile"] = profile_prefills(spec, dense_spec, card,
                                                  cfg.num_layers)
    metrics["profile"] = profile_serving(spec, reqs, card,
                                         float(np.median(step_ms)),
                                         cfg.num_layers)
    del srv, dsrv, sd, spec, dense_spec
    torch.cuda.empty_cache()
    launches["attention_f32_combine"] = combines
    dlaunch["attention_f32_combine"] = dcombines
    return launches, dlaunch, shapes | dense_shapes, metrics


def check_combines(combines, calls, layers):
    """The combining kernel launches at most once a float32 attention
    call, and a prefill's layers split their keys alike (each layer's call
    has the same shapes and kmax), so it launches for all of a prefill's
    layers or none."""
    if combines > calls or combines % layers:
        raise SystemExit(f"{combines} combining launches over {calls} "
                         f"calls, want at most one a call and {layers} or "
                         f"0 a prefill")


SERVE_GROUPS = ("paged attention", "layer norm", "gelu", "logits")


def profile_serving(spec, reqs, card, step_ms, layers):
    """About 20 decode steps of 8 lanes under torch.profiler: 8 of the
    requests with 21 new tokens each, through a fresh server. Each
    dispatch and the kernels' wrapper, layer norm, gelu and the logits
    run inside a ``record_function``; device time per decode step by
    group (matmul, layer norm, paged attention, KV write, gelu, adds,
    logits/argmax, ...), device launches per decode step, and the idle
    share against the wall time of the same steps (CUDA events around
    each step). The paged kernel must launch ``layers`` times a step and
    no ``index_put_`` kernel (the KV write group) at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.ops import elementwise, nn_ops
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.serving.resilience import InflightSlot
    from deeplearning4j_tpu_torch.zoo import gpt

    def labelled(fn, label):
        def run(*a, **kw):
            with record_function(f"serve::{label}"):
                return fn(*a, **kw)
        return run

    saved = [(pa, "paged_decode_attention"), (nn_ops, "layer_norm"),
             (elementwise, "gelu"), (gpt._DecodeMath, "logits")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    for (m, n, f), label in zip(saved, SERVE_GROUPS):
        setattr(m, n, labelled(f, label))
    try:
        srv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                    block_size=SERVE_BS,
                                    max_seq_len=SERVE_SEQ, start=False)
        srv._decode_disp = labelled(srv._decode_disp, "step decode")
        srv._prefill_disp = labelled(srv._prefill_disp, "step prefill")
        hs = [srv.submit(p, max_new_tokens=21) for p, _ in reqs[:8]]
        # the worker's steps, run on this thread (the profiler records the
        # CPU ops, and so each kernel's launching op, of its own thread):
        # the 8 prefills first, then only decode steps under the profiler
        slot = InflightSlot()
        srv._admit(slot)
        torch.cuda.synchronize()
        marks = []
        launched = pa.LAUNCHES["paged_decode_attention"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            while not all(h.future.done() for h in hs):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                srv._step(slot)
                e1.record()
                marks.append((e0, e1))
            torch.cuda.synchronize()
        launched = pa.LAUNCHES["paged_decode_attention"] - launched
        srv.shutdown()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    n_steps = srv.metrics.counters["decode_steps"]
    # the stream's wall time over the same profiled steps (each step ends
    # reading its tokens to the host, so a step's span is its wall time)
    prof_step_ms = sum(a.elapsed_time(b) for a, b in marks) / n_steps

    def chain(e):
        out = []
        while e is not None:
            out.append(e.name)
            e = e.cpu_parent
        return out

    def group_of(cpu, name):
        """A device event's group: by the labelled range or the aten op
        that launched it; a kernel launched through the CUDA runtime that
        our libraries link statically has no launching op on record, and
        goes by its name."""
        if cpu is None:
            return "paged attention" if "paged_decode_kernel" in name \
                else "unlinked"
        names = chain(cpu)
        label = next((n[len("serve::"):] for n in names
                      if n.startswith("serve::")
                      and not n.startswith("serve::step")), None)
        joined = " ".join(names)
        if label == "logits":
            return "logits / argmax"
        if label is not None:
            return label
        for key, g in (("index_put", "KV write"), ("aten::mm", "matmul"),
                       ("aten::addmm", "matmul"), ("aten::matmul", "matmul"),
                       ("aten::add", "adds"), ("argmax", "logits / argmax"),
                       ("aten::copy_", "io copies"), ("aten::to", "io copies")):
            if key in joined:
                return g
        return "other (embedding, index)"

    events = prof.events()
    by_group, per_kernel, linked, n_kernels = {}, {}, {}, 0
    n_by_group = {}

    def add(g, name, ms, n):
        by_group[g] = by_group.get(g, 0.0) + ms
        per_kernel[name] = per_kernel.get(name, 0.0) + ms
        n_by_group[g] = n_by_group.get(g, 0) + n
        return n

    for e in events:                 # kernels with their launching op
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            ms = k.duration / 1e3 / n_steps
            n_kernels += add(group_of(e, k.name), k.name, ms, 1)
            linked[k.name] = linked.get(k.name, (0.0, 0))
            linked[k.name] = (linked[k.name][0] + ms, linked[k.name][1] + 1)
    # every device event of the window (the profiler saw decode steps
    # only), less those above: the kernels with no launching op on record
    dev = {}
    for e in events:                 # (the labels' own device-side ranges
        #                              are not device work)
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("serve::"):
            ms, n = dev.get(e.name, (0.0, 0))
            dev[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / n_steps,
                           n + 1)
    for name, (ms, n) in dev.items():
        lms, ln = linked.get(name, (0.0, 0))
        if n > ln:
            n_kernels += add(group_of(None, name), name, ms - lms, n - ln)
    busy = sum(by_group.values())
    if busy == 0 or "paged attention" not in by_group:
        raise SystemExit(f"the serving profile holds no decode device time: "
                         f"{by_group}")
    log(f"  profiler, {n_steps} decode steps: device busy {busy:.3f} ms a "
        f"step of a {prof_step_ms:.2f} ms wall step (the same profiled "
        f"steps, 8 lanes): idle share {1 - busy / prof_step_ms:.3f}; "
        f"{n_kernels / n_steps:.1f} device launches a step; the traffic "
        f"run's median wall step, another run at fewer lanes, "
        f"{step_ms:.2f} ms  [{card}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:8.4f} ms  {ms / busy:.3f} of device time  "
            f"{n_by_group[g] / n_steps:.1f} launches a step  {g}")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:8.4f} ms  {key[:100]}")
    attn, put = (n_by_group.get(g, 0) / n_steps
                 for g in ("paged attention", "KV write"))
    attn_ms = by_group["paged attention"] + by_group.get("KV write", 0.0)
    log(f"  paged attention and the KV write: {attn_ms:.4f} ms of device "
        f"time a decode step; {launched / n_steps:.1f} paged kernel "
        f"launches a step counted by the wrapper ({attn:.1f} in the trace) "
        f"and {put:.1f} index_put_ kernels in the trace (want {layers} and "
        f"0)  [{card}]")
    if launched != layers * n_steps or put != 0:
        raise SystemExit(f"{n_steps} decode steps launched {launched} paged "
                         f"kernels and {put} index_put_ kernels a step, want "
                         f"{layers} a step and 0")
    return {"busy_ms": busy, "step_ms": prof_step_ms,
            "idle_share": 1 - busy / prof_step_ms,
            "launches": n_kernels / n_steps, "by_group_ms": by_group,
            "launches_by_group": {g: n / n_steps
                                  for g, n in n_by_group.items()},
            "attention_and_write_ms": attn_ms, "steps": n_steps}


def profile_prefills(spec, dense_spec, card, layers, n=3):
    """``n`` paged prefills (512 rows after a 256-token cached prefix,
    blocks of 16, the server's 64-entry table) and ``n`` dense prefills
    (512 rows) of GPT-medium float32 under torch.profiler, after one of
    each unprofiled: per prefill, the float32 attention kernels' launches
    (main and combining) and device time, and all its device time. The
    wrappers' counts of both kernels must equal the profiler's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.serving.generative import _slab
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    maxb = SERVE_SEQ // SERVE_BS
    prefill, _, _ = spec.make_fns(SERVE_BS, maxb)
    nb = 1 + (256 + 512) // SERVE_BS
    kc, vc = (_slab(spec.kv_shape(nb, SERVE_BS), spec.kv_dtype, dev)
              for _ in range(2))
    table = np.zeros(maxb, np.int32)
    table[:nb - 1] = np.arange(1, nb)
    dkc, dvc = (_slab(dense_spec.kv_shape(1, SERVE_SEQ), dense_spec.kv_dtype,
                      dev) for _ in range(2))
    vocab = spec.params()["wte"].shape[0]
    tokens = rng.integers(0, vocab, 512).astype(np.int32)
    params, dparams = spec.params(), dense_spec.params()
    runs = {
        "paged_prefill_f32": lambda: prefill(params, kc, vc, {
            "tokens": tokens, "length": np.int32(512), "hist": np.int32(256),
            "table": table}),
        "attention_fwd_f32": lambda: dense_spec.prefill(dparams, dkc, dvc, {
            "tokens": tokens, "length": np.int32(512), "slot": np.int32(0)})}
    out = {}
    with torch.inference_mode():
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            # a pass whose trace holds fewer launches than the wrappers
            # counted (the tracer can drop a window's first kernels) is
            # taken once more; the checks below hold the second
            for attempt in range(2):
                before = dict(af.LAUNCHES)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                counted = (af.LAUNCHES[name] - before[name],
                           af.LAUNCHES["attention_f32_combine"]
                           - before["attention_f32_combine"])
                main = comb = total = 0.0
                n_main = n_comb = 0
                for e in prof.events():
                    if e.device_type != DeviceType.CUDA:
                        continue
                    ms = e.time_range.elapsed_us() / 1e3
                    total += ms
                    if "attn_f32_kernel" in e.name:
                        main, n_main = main + ms, n_main + 1
                    elif "attn_f32_combine" in e.name:
                        comb, n_comb = comb + ms, n_comb + 1
                if counted == (n_main, n_comb) or attempt:
                    break
                log(f"  profiler, {name}: the trace holds {(n_main, n_comb)} "
                    f"launches, the wrappers counted {counted}: taken again")
            out[name] = {"in_prefill_ms": (main + comb) / n,
                         "main_ms": main / n, "combine_ms": comb / n,
                         "launches": n_main / n, "combines": n_comb / n,
                         "device_ms": total / n}
            r = out[name]
            log(f"  profiler, {n} {'paged' if 'paged' in name else 'dense'} "
                f"prefills of 512 rows: {name} {r['launches']:.1f} launches "
                f"and {r['combines']:.1f} combining launches a prefill, "
                f"{r['in_prefill_ms']:.4f} ms ({r['main_ms']:.4f} + "
                f"{r['combine_ms']:.4f}) of the prefill's {r['device_ms']:.3f}"
                f" ms device time; the wrappers counted {counted[0]} and "
                f"{counted[1]}  [{card}]")
            if n_main != n * layers:
                raise SystemExit(f"{name}: {n_main} launches in {n} "
                                 f"prefills, want {layers} each")
            if counted != (n_main, n_comb):
                raise SystemExit(f"{name}: the wrappers counted {counted} "
                                 f"launches (main, combining), the profiler "
                                 f"{(n_main, n_comb)}")
    del kc, vc, dkc, dvc
    return out


def phase_paged_timing(dev, card_name, shapes, errs, in_step_ms):
    """Every shape the serving run handed the paged functions, checked
    against its plain version on random data of that shape; then
    paged_decode_attention timed alone (cold L2, the median of 20 calls
    queued behind a device sleep, ``median_ms``) at GPT-medium decode, 8
    lanes all at context 128, 512 and 1024, each writing its step's row
    (the cache holds those rows already: the write is idempotent), beside
    the same kernel with no write (``paged_attention``), the plain version
    (which reads
    its lanes to the host: the median of 3 calls between two
    synchronizations, ``synced_ms``, host time included), the bound
    (bytes of K and V up to each lane's last key, q and out, and the new
    rows read and written, over the card's memory rate) and the library
    yardstick: one
    ``F.scaled_dot_product_attention(q, K, V, attn_mask)`` over the dense
    slab's contiguous context, masked at each row's last key (timed only;
    the port never calls it; paged has no one-call counterpart). Then the
    two float32 prefill kernels at their serving shapes, the same way: the
    paged prefill (512 rows after a 256-token prefix, as the server calls
    it) beside the decode kernel's time there, its plain version and the
    library over the lane's contiguous context; the dense forward (1, 12,
    512, 128) causal beside ``attention_fwd``'s scalar float32 kernel,
    ``attention_fwd_plain`` and ``F.scaled_dot_product_attention(...,
    is_causal=True)``; each bound at the 3xTF32 rate, the float32 FMA
    rate's time beside it."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    for (kind, n, a, d, bs, maxb, s, dt) in sorted(shapes):
        dtype = getattr(torch, dt)
        t_len = maxb * bs
        label = (f"path shape {kind} N {n} A {a} D {d} BS {bs} MAXB {maxb} "
                 f"{dt}")
        if kind == "decode":
            kmax = np.linspace(0, t_len - 1, n).astype(int).tolist()
            check_paged_decode(measure.paged_decode_write_case(
                dev, kmax, a, d, bs, dtype, seed=n), errs, label,
                controls=False, dense=True)
        else:
            hist = max(0, min(256, t_len - n) // bs * bs)
            check_paged_prefill(measure.paged_prefill_case(
                dev, hist, n, n, a, d, bs, dtype, seed=n), errs, label,
                controls=False)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    out = {}
    L = 16
    for ctx in (128, 512, 1024):
        case = measure.paged_decode_write_case(
            dev, [ctx - 1] * SERVE_SLOTS, 12, 128, SERVE_BS, torch.float32)
        q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo = case
        args = (q, kc, vc, tables, lane, kmax)
        pa.paged_decode_plain(*case)         # the step's rows in place
        dk, dv, dt = measure.paged_dense(kc, vc, tables)
        keys = torch.arange(dk.shape[2], device=dev)
        mask = (keys[None, :] <= kmax[:, None].long())[:, None, None, :]
        ql = q.contiguous()[:, :, None, :]
        per_call = median_ms(lambda: pa.paged_decode_attention(*case), flush)
        no_write = median_ms(lambda: pa.paged_attention(*args), flush)
        plain_call = synced_ms(lambda: pa.paged_decode_plain(*case), flush,
                               3)
        lib = median_ms(lambda: F.scaled_dot_product_attention(
            ql, dk, dv, attn_mask=mask), flush)
        ops, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax,
                                           writes=int((wb >= 0).sum()))
        bound = measure.two_rate_bound(ops, nbytes, card_name)
        out[f"decode_{ctx}"] = {
            "per_call_ms": per_call, "plain_per_call_ms": plain_call,
            "library_per_call_ms": lib,
            "bound_per_call_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "no_write_per_call_ms": no_write}
        log(f"  paged_decode_attention decode 8 lanes x 12 x 128 at context "
            f"{ctx}: {per_call:.4f} ms a call alone ({no_write:.4f} with no "
            f"write), plain {plain_call:.4f}, library (dense slab, "
            f"mask) {lib:.4f}, bound {bound['bound_ms']:.4f} "
            f"({bound['bound_by']}; {bound['bound_ms'] / per_call:.2f} of "
            f"it), {nbytes / per_call / 1e9:.2f} TB/s; x{L} per decode "
            f"step: {L * per_call:.3f} ms  [{card_name}]")
    log(f"  paged_decode_attention in the decode step (profiler): "
        f"{in_step_ms:.4f} ms a step ({in_step_ms / L:.4f} a launch)")

    # the paged prefill, as the server calls it (the host's kmax with it)
    args = measure.paged_prefill_case(dev, 256, 512, 512, 12, 128, SERVE_BS,
                                      torch.float32)
    q, kc, vc, tables, lane, kmax = args
    table, kh = tables[0], kmax.cpu().numpy()
    t_ctx = int(kmax.max()) + 1   # the library over the lane's 768 keys
    dk, dv, _ = measure.paged_dense(kc, vc, tables)
    dk, dv = dk[:, :, :t_ctx].contiguous(), dv[:, :, :t_ctx].contiguous()
    keys = torch.arange(t_ctx, device=dev)
    mask = (keys[None, :] <= kmax[:, None].long())[None, None]
    ql = q.permute(1, 0, 2)[None].contiguous()
    new = lambda: pa.paged_prefill_attention(q, kc, vc, table, kmax, kh)
    per_call = median_ms(new, flush)
    old_call = median_ms(lambda: pa.paged_attention(*args), flush)
    plain_call = synced_ms(lambda: pa.paged_prefill_plain(
        q, kc, vc, table, kmax), flush, 3)
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        ql, dk, dv, attn_mask=mask), flush)
    lib_diff = float((F.scaled_dot_product_attention(
        ql, dk, dv, attn_mask=mask)[0].transpose(0, 1) - new()).abs().max())
    ops, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax)
    bound = measure.two_rate_bound(ops, nbytes, card_name)
    out["paged_prefill_f32"] = {
        "per_call_ms": per_call, "plain_per_call_ms": plain_call,
        "library_per_call_ms": lib, "old_kernel_per_call_ms": old_call,
        "bound_per_call_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_fma_per_call_ms": bound["fma_ms"]}
    # paged_attention's own record of this shape, as before
    out["prefill_512_hist_256"] = {
        "per_call_ms": old_call, "plain_per_call_ms": plain_call,
        "library_per_call_ms": lib, "bound_per_call_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"]}
    log(f"  paged prefill 512 rows after 256 cached keys: paged_prefill_f32 "
        f"{per_call:.4f} ms a call alone (paged_attention there "
        f"{old_call:.4f}), plain {plain_call:.4f}, library (contiguous "
        f"{t_ctx}-key context, mask t <= hist + j) {lib:.4f} (kernel / "
        f"library {per_call / lib:.3f}; outputs differ by at most "
        f"{lib_diff:.2e}), bound {bound['bound_ms']:.4f} at 3xTF32 "
        f"({bound['bound_by']}; {bound['fma_ms']:.4f} at the float32 FMA "
        f"rate, {bound['bytes_ms']:.4f} bytes), {ops / per_call / 1e9:.2f} "
        f"TFLOP/s  [{card_name}]")

    # the dense prefill's forward, float32 (1, 12, 512, 128) causal
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(1, 512, 12, 3 * 128, device=dev,
                      generator=g).permute(0, 2, 1, 3)
    q, k, v = torch.split(qkv, 128, dim=3)
    o_, st_ = torch.empty(1, 12, 512, 128, device=dev), torch.empty(
        1, 12, 512, 2, device=dev)
    fwd = median_ms(lambda: at.attention_fwd(q, k, v, True), flush)
    fwd_old = median_ms(lambda: at._launch(
        "dl4j_attention_fwd", q, k, v, 1 / math.sqrt(128), True, out=o_,
        stats=st_), flush)
    fwd_plain = median_ms(lambda: at.attention_fwd_plain(q, k, v, True),
                          flush, 3)
    fwd_lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), flush)
    ops, nbytes = measure.attention_f32_bounds(1, 12, 512, 512, 128, True)
    bound = measure.two_rate_bound(ops, nbytes, card_name)
    out["attention_fwd_f32"] = {
        "per_call_ms": fwd, "plain_per_call_ms": fwd_plain,
        "library_per_call_ms": fwd_lib, "old_kernel_per_call_ms": fwd_old,
        "bound_per_call_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_fma_per_call_ms": bound["fma_ms"]}
    # attention_fwd's scalar float32 path at this shape, as before
    out["attention_fwd_serving"] = {
        "per_call_ms": fwd_old, "plain_per_call_ms": fwd_plain,
        "library_per_call_ms": fwd_lib,
        "bound_per_call_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    log(f"  dense prefill forward float32 (1, 12, 512, 128) causal: "
        f"attention_fwd_f32 {fwd:.4f} ms a call alone (attention_fwd's "
        f"scalar float32 kernel {fwd_old:.4f}), plain {fwd_plain:.4f}, "
        f"library {fwd_lib:.4f} (kernel / library {fwd / fwd_lib:.3f}), "
        f"bound {bound['bound_ms']:.4f} at 3xTF32 ({bound['bound_by']}; "
        f"{bound['fma_ms']:.4f} at the float32 FMA rate, "
        f"{bound['bytes_ms']:.4f} bytes), {ops / fwd / 1e9:.2f} TFLOP/s  "
        f"[{card_name}]")
    del flush
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# LeNet and the SameDiff MLP through SameDiff's fit tiers (CUDA graphs)
LENET_BATCH, LENET_ROWS = 128, 2048
TIMED_EPOCHS, TIMED_TRIALS = 6, 3
TIER_RTOL, TIER_ATOL = 1e-5, 1e-6


def _quiet_listener():
    from deeplearning4j_tpu_torch.autodiff import ScoreIterationListener
    return ScoreIterationListener(print_every=10 ** 9,
                                  print_fn=lambda *a: None)


#: (tier, listeners, fused_steps), as ``bench.py`` runs them: no listener
#: (the scanned epoch), a listener with fused_steps=8 (fused windows),
#: and a listener with fused_steps=1 (one eager step a batch)
def _tiers():
    return (("scanned", [], 1), ("windows", [_quiet_listener()], 8),
            ("per-step", [_quiet_listener()], 1))


def _lenet_data():
    from deeplearning4j_tpu_torch.dataset import load_mnist
    X, y = load_mnist(train=True, n_synthetic=LENET_ROWS)
    return X, np.eye(10, dtype=np.float32)[y]


def _mlp_sd(fused_steps, dev="cuda"):
    """``bench.py`` ``_build_mlp_sd``'s graph: 784 -> 512 -> 256 -> 10,
    softmax cross-entropy, Adam(1e-3), seed-0 weights."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.learning import Adam
    rng = np.random.default_rng(0)
    sd = SameDiff(device=dev)
    x = sd.placeholder("x", shape=(-1, 784))
    cur, n_in = x, 784
    for i, h in enumerate((512, 256)):
        w = sd.var(f"w{i}", value=rng.normal(0, 0.05, (n_in, h)).astype(
            np.float32))
        b = sd.var(f"b{i}", value=np.zeros(h, np.float32))
        cur = sd.nn.relu(cur.mmul(w).add(b), name=f"h{i}")
        n_in = h
    w = sd.var("w_out", value=rng.normal(0, 0.05, (n_in, 10)).astype(
        np.float32))
    b = sd.var("b_out", value=np.zeros(10, np.float32))
    logits = cur.mmul(w).add(b, name="logits")
    sd.loss.softmax_cross_entropy(logits, sd.placeholder(
        "labels", shape=(-1, 10)), name="loss")
    sd.set_loss_variables(["loss"])
    sd.training_config = (TrainingConfig.builder().updater(Adam(1e-3))
                          .data_set_feature_mapping("x")
                          .data_set_label_mapping("labels")
                          .fused_steps(fused_steps).build())
    return sd


def _mlp_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(LENET_ROWS, 784)).astype(np.float32)
    return X, np.eye(10, dtype=np.float32)[rng.integers(0, 10, LENET_ROWS)]


def _annotation(e):
    """A range the profiler marks on the device timeline (a scheduled
    pass's ProfilerStep#n), not device work."""
    name = getattr(e, "name", None) or e.key    # an event, or an average
    return getattr(e, "is_user_annotation", False) or \
        name.startswith("ProfilerStep")


def device_activity(prof):
    """(device activities, of which kernels, busy ms, ms by name) of a
    profiler pass: every device event (kernel, copy, set), busy as the
    union of their intervals."""
    from torch.autograd import DeviceType
    spans, kernels, by_name = [], 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        kernels += not e.name.startswith(("Memcpy", "Memset"))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), kernels, busy / 1e3, by_name


def time_tier(fit, sd, steps, batch, base):
    """``bench.py``'s ``_median_rate``: fit(2) to warm up and capture,
    then the median of TIMED_TRIALS fit(TIMED_EPOCHS); then one epoch
    under torch.profiler. Peak memory from before the first fit, less
    ``base``, what was allocated before the network and its data were
    made."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    hist = fit(2)
    rates = []
    for _ in range(TIMED_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = fit(TIMED_EPOCHS)
        torch.cuda.synchronize()
        rates.append(TIMED_EPOCHS * steps * batch /
                     (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    sps = sorted(rates)[TIMED_TRIALS // 2]
    step_ms = 1e3 * batch / sps
    st = dict(sd.last_fit_stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(1)
        torch.cuda.synchronize()
        traced_ms = 1000 * (time.perf_counter() - t0) / steps
    n_dev, n_kern, busy, by_name = device_activity(prof)
    losses = hist.step_losses + last.step_losses
    if not (np.all(np.isfinite(losses)) and
            last.epoch_losses[-1] < hist.epoch_losses[0]):
        raise SystemExit(f"losses not finite and falling: {losses}")
    return {"samples_per_s": sps, "step_ms": step_ms, "rates": rates,
            "replays_per_epoch": st["graph_replays_per_epoch"],
            "dispatches_per_epoch": st["dispatches_per_epoch"],
            "tier": st["tier"], "window_sizes": st["window_sizes"],
            "device_events_per_step": n_dev / steps,
            "kernels_per_step": n_kern / steps,
            "busy_ms_per_step": busy / steps,
            "traced_ms": traced_ms,
            "idle_share": 1 - busy / steps / traced_ms if busy else None,
            "peak_gib": (peak - base) / 2 ** 30, "base_gib": base / 2 ** 30,
            "top_ms": sorted(((ms / steps, n) for n, ms in by_name.items()),
                             reverse=True)[:8],
            "first_loss": hist.step_losses[0],
            "last_loss": last.step_losses[-1]}


def _log_tier(model, tier, r, card):
    idle = "not measured (no device events)" if r["idle_share"] is None \
        else f"{r['idle_share']:.3f}"
    log(f"  {model} {tier:<8} ({r['tier']}): {r['samples_per_s']:.1f} "
        f"samples/s, step {r['step_ms']:.4f} ms (trials "
        f"{[round(v, 1) for v in r['rates']]}); graph replays an epoch "
        f"{r['replays_per_epoch']}, dispatches {r['dispatches_per_epoch']} "
        f"{r['window_sizes']}; profiler: {r['device_events_per_step']:.1f} "
        f"device launches a step ({r['kernels_per_step']:.1f} kernels), "
        f"busy {r['busy_ms_per_step']:.4f} ms a step of the traced epoch's "
        f"{r['traced_ms']:.4f}, idle share {idle}; "
        f"peak {r['peak_gib']:.4f} GiB above the {r['base_gib']:.3f} GiB "
        f"earlier phases hold (parameters, Adam state, data, activations, "
        f"graph pools); loss {r['first_loss']:.4f} -> "
        f"{r['last_loss']:.4f}  [{card}]")
    if tier == "scanned":
        log(f"    device time a step by kernel, the {len(r['top_ms'])} "
            f"largest (scanned epoch):")
        for ms, n in r["top_ms"]:
            log(f"      {ms:8.4f} ms  {n[:110]}")


def phase_lenet(card):
    """LeNet at batch 128 as ``bench.py`` ``bench_lenet`` runs it, then
    the SameDiff MLP as ``bench_samediff_mlp`` does, each on the three
    tiers: samples/s, step ms, graph replays an epoch, device launches a
    step, idle share, peak memory."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.zoo import LeNet
    log(f"  float32; cuDNN TF32 {torch.backends.cudnn.allow_tf32}, cuBLAS "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32} (the defaults; the "
        f"same on every tier)")
    out = {}
    X, Y = _lenet_data()
    steps = LENET_ROWS // LENET_BATCH
    for tier, listeners, k in _tiers():
        base = torch.cuda.memory_allocated()
        net = LeNet(height=28, width=28, channels=1).build()
        it = DeviceCachedIterator(X, Y, batch_size=LENET_BATCH)
        r = time_tier(lambda e: net.fit(it, epochs=e, listeners=listeners,
                                        fused_steps=k),
                      net.samediff, steps, LENET_BATCH, base)
        _log_tier("LeNet", tier, r, card)
        out["lenet", tier] = r
        del net, it
        torch.cuda.empty_cache()
    X, Y = _mlp_data()
    for tier, listeners, k in _tiers():
        base = torch.cuda.memory_allocated()
        sd = _mlp_sd(k)
        it = DeviceCachedIterator(X, Y, batch_size=LENET_BATCH)
        r = time_tier(lambda e: sd.fit(it, epochs=e, listeners=listeners),
                      sd, steps, LENET_BATCH, base)
        _log_tier("MLP", tier, r, card)
        out["mlp", tier] = r
        del sd, it
        torch.cuda.empty_cache()
    for model in ("lenet", "mlp"):
        want = {"scanned": 1, "windows": 2, "per-step": 0}
        got = {t: out[model, t]["replays_per_epoch"] for t in want}
        if got != want:
            raise SystemExit(f"{model}: graph replays an epoch {got}, want "
                             f"{want}")
    torch.cuda.empty_cache()
    return out


def _loss_recorder():
    """A listener that keeps every step's loss (``.losses``)."""
    from deeplearning4j_tpu_torch.autodiff import Listener

    class Rec(Listener):
        frequency = 10 ** 9

        def __init__(self):
            self.losses = []

        def iterations_done(self, sd, epoch, iterations, losses):
            self.losses += [float(v) for v in losses]
    return Rec()


_ITERS = {}


def _train_lenet(tier, rows=LENET_ROWS, epochs=2, net=None, dev="cuda"):
    """(net, each step's loss) after ``epochs`` on ``tier``
    ("per-step", "windows" of 8 or "scanned") from LeNet's seed (or
    ``net``), over the first ``rows`` rows: one iterator a row count, so
    a second fit of a net replays the windows its first one captured."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.zoo import LeNet
    if rows not in _ITERS:
        X, Y = _lenet_data()
        _ITERS[rows] = DeviceCachedIterator(X[:rows], Y[:rows],
                                            batch_size=LENET_BATCH,
                                            device=dev)
    it = _ITERS[rows]
    net = net or LeNet().build(dev)
    if tier == "scanned":
        return net, net.fit(it, epochs=epochs, fused_steps=1).step_losses
    rec = _loss_recorder()
    net.fit(it, epochs=epochs, listeners=[rec],
            fused_steps=8 if tier == "windows" else 1)
    return net, rec.losses


def _reading(pa, pb, la, lb):
    """The tier rule's reading: max |a - b| / (atol + rtol |b|) over the
    parameters and the losses; at most 1 passes."""
    worst = 0.0
    for n in pb:
        x = torch.as_tensor(pa[n]).double()
        y = torch.as_tensor(pb[n]).double()
        worst = max(worst, float(((x - y).abs() / (
            TIER_ATOL + TIER_RTOL * y.abs())).max()))
    x, y = torch.tensor(la).double(), torch.tensor(lb).double()
    if x.shape != y.shape:
        return math.inf
    return max(worst, float(((x - y).abs() / (
        TIER_ATOL + TIER_RTOL * y.abs())).max()))


def phase_tiers():
    """On the card, from LeNet's seed and the same batches: the windowed
    (8) and scanned tiers against the per-step tier over 2 epochs, every
    parameter and every step's loss within rtol 1e-5 / atol 1e-6 (the
    JAX package's tier tolerance); two scanned runs bit-equal; a tail of
    3 steps (windows 8 + 2 + 1); set_param between fits seen by the next
    fit, which captures its window again; a control whose alphat buffer is filled once and never again
    must fail the rule. Then LeNet in float64 at batch 16, card
    (per-step and windows) against the CPU's per-step tier: every
    gradient, then 3 Adam steps, to 1e-6 of each tensor."""
    from deeplearning4j_tpu_torch.autodiff import window
    det0 = torch.backends.cudnn.deterministic
    a, la = _train_lenet("scanned")
    b, lb = _train_lenet("scanned")
    same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(
        b.params()[n])) for n, x in a.params().items()) and la == lb
    log(f"  two scanned runs from one start (cuDNN deterministic={det0}): "
        f"bit-equal {same}")
    if not same:
        torch.backends.cudnn.deterministic = True
        log("  not bit-equal: cuDNN's chosen algorithms are not "
            "deterministic; the rest of this phase sets "
            "torch.backends.cudnn.deterministic")
        a, la = _train_lenet("scanned")
        b, lb = _train_lenet("scanned")
        same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(
            b.params()[n])) for n, x in a.params().items()) and la == lb
        log(f"  two scanned runs, cuDNN deterministic: bit-equal {same}")
        if not same:
            raise SystemExit("two scanned runs from one start differ")
    try:
        ref, lref = _train_lenet("per-step")
        readings = {}
        for tier in ("windows", "scanned"):
            net, l = _train_lenet(tier)
            readings[tier] = _reading(net.params(), ref.params(), l, lref)
        rows = 11 * LENET_BATCH
        tref, ltref = _train_lenet("per-step", rows)
        tail, ltail = _train_lenet("windows", rows)
        sizes = tail.samediff.last_fit_stats["window_sizes"]
        readings["windows, 11 steps"] = _reading(tail.params(),
                                                 tref.params(), ltail, ltref)
        # set_param between fits: it stores a new tensor and drops the
        # windows, and the next fit captures its window again over it
        pair = {}
        for tier in ("scanned", "per-step"):
            net, l1 = _train_lenet(tier, epochs=1)
            w = net.params()["layer0_conv_W"]
            net.set_param("layer0_conv_W", 0.5 * w)
            if net.samediff._windows:
                raise SystemExit("set_param kept the captured windows")
            net, l2 = _train_lenet(tier, epochs=1, net=net)
            if net.samediff.last_fit_stats["window_captures"] != \
                    (tier == "scanned"):
                raise SystemExit(f"{tier}: the fit after set_param captured "
                                 f"{net.samediff.last_fit_stats}")
            pair[tier] = (net, l1 + l2)
        readings["set_param between fits"] = _reading(
            pair["scanned"][0].params(), pair["per-step"][0].params(),
            pair["scanned"][1], pair["per-step"][1])
        # control: each window's alphat row filled at its first replay only
        orig, filled = window.stage_, set()

        def once(dst, src):
            if dst.data_ptr() in filled:
                return
            filled.add(dst.data_ptr())
            orig(dst, src)

        window.stage_ = once
        try:
            net, l = _train_lenet("windows")
        finally:
            window.stage_ = orig
        control = _reading(net.params(), ref.params(), l, lref)
    finally:
        torch.backends.cudnn.deterministic = det0
    log(f"  tier rule max |a - b| / (1e-6 + 1e-5 |b|), against the per-step "
        f"tier (<= 1 passes): "
        + ", ".join(f"{k} {v:.3g}" for k, v in readings.items())
        + f"; the 11-step tail's windows {sizes}")
    log(f"  control, alphat filled once a window (a frozen step count): "
        f"{control:.3g} (must exceed 1)")
    if not (all(v <= 1 for v in readings.values()) and control > 1
            and sizes == {8: 1, 2: 1, 1: 1}):
        raise SystemExit("the fit tiers disagree on the card")
    phase_lenet_parity()
    return readings, control


def phase_lenet_parity():
    """LeNet float64, batch 16: gradients, then 3 Adam steps, card
    (per-step and windows) against the CPU's per-step tier."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import LeNet
    X, Y = _lenet_data()
    X, Y = X[:64].astype(np.float64), Y[:64].astype(np.float64)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    try:
        for label, dev, k in (("cpu", "cpu", 1), ("card per-step", "cuda", 1),
                              ("card windows", "cuda", 4)):
            conf = LeNet().conf()
            conf.dtype = "float64"
            net = MultiLayerNetwork(conf).init(dev)
            grads = net.samediff.calculate_gradients(
                {"input": X[:16], "labels": Y[:16]})
            rec = _loss_recorder()
            net.fit(DeviceCachedIterator(X[16:], Y[16:], 16, device=dev),
                    listeners=[rec], fused_steps=k)
            res[label] = (grads, rec.losses, net.params(),
                          net.samediff.last_fit_stats["window_sizes"])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    gh, lh, ph, _ = res["cpu"]
    ok = True
    for label in ("card per-step", "card windows"):
        gc, lc, pc, sizes = res[label]
        eg = max(_tensor_rel(gc[n], gh[n]) for n in gh)
        ep = max(_tensor_rel(torch.as_tensor(pc[n]), torch.as_tensor(ph[n]))
                 for n in ph)
        el = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        log(f"  LeNet float64 bs16, {label} vs cpu over {len(gh)} tensors: "
            f"gradients worst {eg:.2e}, params after 3 Adam steps worst "
            f"{ep:.2e}, losses worst {el:.2e} (windows {sizes}); tol 1e-6")
        ok = ok and eg <= 1e-6 and ep <= 1e-6 and el <= 1e-6 and \
            len(lc) == 3
    if not ok:
        raise SystemExit("LeNet on the card disagrees with the CPU")


# ----------------------------------------------------------------------
# speculative int8-weight serving: csrc/int8_matmul.cu, the verify entry of
# csrc/paged_attention.cu, and the GPT-medium speculative server
INT8_SOURCE = "deeplearning4j_tpu_torch/csrc/int8_matmul.cu"
#: the JAX code each kernel stands in for (XLA fused it; no Pallas kernel)
INT8_REPLACES = "deeplearning4j_tpu/zoo/gpt.py:262"
VERIFY_REPLACES = "deeplearning4j_tpu/zoo/gpt.py:701"
#: kernel A's gate: 1e-5 of the sum of absolute terms, against float64
INT8_TOL = 1e-5
#: GPT-medium's int8 products (K, N, transposed): qkv, attn proj, mlp fc,
#: mlp proj, and the tied logits over wte [32768, 1536] read transposed
INT8_SHAPES = ((1536, 4608, False), (1536, 1536, False),
               (1536, 6144, False), (6144, 1536, False),
               (1536, 32768, True))
SPEC_K = 8
#: M of the int8 checks: each tile's edges (rows a tile 8, 16, 32, 64)
INT8_MS = (1, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 512)
#: (K, N, transposed) off GPT-medium's: partial K and N tiles through the
#: tensor map (K, N multiples of 16), and plain loads (rows off 16 bytes,
#: K off 4)
INT8_ODD = ((1552, 4624, False), (1552, 4624, True), (100, 72, True),
            (40, 24, False), (33, 17, False))
#: window lengths of the verify checked on the dense slab too
SPEC_DENSE_W = (1, 2, 4, 8, 16, 20)


def _nan_poison_free(nbytes, dev):
    """Fill about ``nbytes`` of the caching allocator's free memory with
    NaN and free it: an output allocated next is likely to reuse it, so a
    kernel that leaves an element unwritten shows as NaN."""
    torch.full((int(nbytes) // 4 + 1024,), float("nan"), device=dev)


def check_int8(dev, m, k, n, transposed, errs, label, x=None):
    """``int8_matmul`` against its plain version in float64 on the same
    inputs: per element within INT8_TOL of the sum of its absolute terms;
    the output written everywhere (NaN-poisoned memory); two calls
    bit-equal; a control the rule must reject (one 32-deep K tile of x
    dropped). Returns the kernel's output; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import measure
    x0, w, s = measure.int8_matmul_case(dev, m, k, n, transposed,
                                        seed=k + n + m)
    x = x0 if x is None else x
    _nan_poison_free(m * n * 4, dev)
    got = im.int8_matmul(x, w, s, transposed)
    again = im.int8_matmul(x, w, s, transposed)
    want = im.int8_matmul_plain(x.double(), w, s.double(), transposed)
    terms = im.abs_terms(x, w, s, transposed)
    reading = measure.paged_reading(got, want, terms, INT8_TOL)
    xd = x.double().clone()
    xd[:, 32:64] = 0
    ctl = measure.paged_reading(im.int8_matmul_plain(
        xd, w, s.double(), transposed), got, terms, INT8_TOL)
    errs["int8_matmul"] = max(errs.get("int8_matmul", 0.0), float(
        (got.double() - want).abs().max()))
    same = torch.equal(got, again)
    ok = reading <= 1 and same and ctl > 1 and bool(
        torch.isfinite(got).all())
    log(f"  {label}: {reading:.3g} of tol, bit-equal twice {same}, "
        f"control (K tile dropped, must exceed 1) {ctl:.3g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("int8_matmul disagrees with its plain version")
    return got, (x, w, s)


def check_int8_rows(dev, k, n, transposed, ms):
    """A row's result does not depend on M: rows of the same x through
    every M in ``ms`` give the bits of M = max(ms)."""
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import measure
    x, w, s = measure.int8_matmul_case(dev, max(ms), k, n, transposed)
    full = im.int8_matmul(x, w, s, transposed)
    same = {m: torch.equal(im.int8_matmul(x[:m], w, s, transposed),
                           full[:m]) for m in ms}
    log(f"  rows independent of M ({k}x{n}{' transposed' if transposed else ''}"
        f"): row bits of M in {list(ms)} equal M = {max(ms)}'s: "
        f"{all(same.values())} {same if not all(same.values()) else ''}")
    if not all(same.values()):
        raise SystemExit("int8_matmul's rows depend on M")


def check_verify(args, errs, label, controls=True):
    """``paged_verify_attention`` on ``args`` (``measure.paged_verify_case``)
    against ``paged_verify_plain`` (``index_put_``, then attention), each
    on its own copy of the cache: per element within PAGED_TOL of the sum
    of its absolute terms; the written caches bit-equal; two calls
    bit-equal; each row bit-equal to ``paged_decode_attention`` of the
    same row at its last key over the written cache (the verify = decode
    invariant); with NaN wherever no row may read (the null block, unused
    blocks, each lane's positions from its window on, which the rows take
    from the new rows), the same bits. ``controls``: the rule must reject
    a row attending one key too far and the window's keys read from the
    cache before the write. Prints one line; exits on a failure."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = args
    tol = PAGED_TOL[q.dtype]

    def run(fn, kc_, vc_, kmax_=kmax):
        k2, v2 = kc_.clone(), vc_.clone()
        return fn(q, kn, vn, k2, v2, tab, lane, kmax_, win0, wrow, wb,
                  wo), k2, v2
    before = pa.LAUNCHES["paged_verify_attention"]
    got, gk, gv = run(pa.paged_verify_attention, kc, vc)
    again, ak, av = run(pa.paged_verify_attention, kc, vc)
    launched = pa.LAUNCHES["paged_verify_attention"] - before
    want, wk, wv = run(pa.paged_verify_plain, kc, vc)
    terms = pa.abs_terms(q, wk, wv, tab, lane, kmax)
    reading = measure.paged_reading(got, want, terms, tol)
    errs["paged_verify_attention"] = max(errs.get(
        "paged_verify_attention", 0.0), float(
        (got.double() - want.double()).abs().max()))
    rows = torch.equal(gk, wk) and torch.equal(gv, wv)
    same = torch.equal(got, again) and torch.equal(gk, ak) and \
        torch.equal(gv, av)
    dk, dv = gk.clone(), gv.clone()
    dec = pa.paged_decode_attention(q, kn, vn, dk, dv, tab, lane, kmax, wb,
                                    wo)
    as_decode = torch.equal(dec, got)
    cached = torch.where(win0 >= 0, win0 - 1, kmax)
    pk, pv = measure.paged_poisoned(kc, vc, tab, lane, cached)
    poisoned = run(pa.paged_verify_attention, pk, pv)[0]
    poison_ok = bool(torch.isfinite(poisoned).all()) and torch.equal(
        poisoned, got)
    ctl, ctl_ok = "", True
    if controls:
        # each row but its window's last one attends one key too far
        w_len = int((lane == lane[0]).sum())
        far = torch.where((win0 >= 0) & (kmax - win0 + 1 < w_len), kmax + 1,
                          kmax)
        r_far = measure.paged_reading(run(
            pa.paged_verify_plain, kc, vc, far)[0], got, terms, tol)
        r_stale = measure.paged_reading(pa.paged_attention_plain(
            q, kc, vc, tab, lane, kmax), got, terms, tol)
        ctl_ok = r_far > 1 and r_stale > 1
        ctl = (f"; controls (must exceed 1): one key too far {r_far:.3g}, "
               f"window read before the write {r_stale:.3g}")
    ok = (reading <= 1 and rows and same and as_decode and poison_ok
          and ctl_ok and launched == 2)
    log(f"  {label}: {reading:.3g} of tol, written cache bit-equal {rows}, "
        f"bit-equal twice {same}, rows = decode bits {as_decode}, NaN "
        f"poison unchanged {poison_ok}{ctl} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("paged_verify_attention disagrees with its plain "
                         "version or with the decode kernel")


def phase_spec_kernels(dev, errs, prefill_m=512):
    """Kernel A (``int8_matmul``) at every GPT-medium (K, N) and the
    transposed ``wte`` at M in INT8_MS and the traffic's largest prefill
    bucket (every tile edge: 8 rows a tile to 8, 16, 32, 64 from 9, 17,
    33, 65), each shape's rows independent of M over the same M; kernel B
    (``paged_verify_attention``) at 8 lanes x W 1-20 x 12 x 128 float32
    with first window positions (0, 15, 128, 512, 1000, ...) (15: a window
    straddling a block edge), blocks of 16 (and the dense slab at W in
    SPEC_DENSE_W), every row against the decode kernel's bits; two lanes
    inactive in one case; head dims 16-64 and float64 at a smaller size,
    and blocks of 5 (the cp.async path)."""
    from deeplearning4j_tpu_torch.kernels import measure
    ms = sorted(set(INT8_MS) | {prefill_m})
    for k, n, tr in INT8_SHAPES:
        for m in ms:
            check_int8(dev, m, k, n, tr, errs,
                       f"int8 {m}x{k} @ {'wte^T ' if tr else ''}{k}x{n}")
        check_int8_rows(dev, k, n, tr, ms)
    for k, n, tr in INT8_ODD:
        for m in (9, 65):
            check_int8(dev, m, k, n, tr, errs,
                       f"int8 {m}x{k} @ {'wte^T ' if tr else ''}{k}x{n}")
    pos0 = [0, 15, 128, 512, 1000, 15, 300, 7]
    for w in range(1, 21):
        for dense in (False, True) if w in SPEC_DENSE_W else (False,):
            check_verify(measure.paged_verify_case(
                dev, pos0, w, 12, 128, 1024 if dense else 16,
                torch.float32, seed=w, dense=dense), errs,
                f"verify 8 lanes x W {w} x12x128 {'dense' if dense else 'BS 16'}"
                f" pos0 {pos0} float32", controls=w == SPEC_K)
    check_verify(measure.paged_verify_case(
        dev, pos0, 8, 12, 128, 16, torch.float32,
        active=[True, True, False, True, True, False, True, True]), errs,
        "verify 8 lanes x W 8 BS 16, lanes 2 and 5 inactive float32")
    for d in (16, 32, 64):
        for dt in (torch.float32, torch.float64):
            for bs in (16, 5):
                check_verify(measure.paged_verify_case(
                    dev, [0, 15, 17, 40], 5, 3, d, bs, dt, seed=d), errs,
                    f"verify 4 lanes x W 5 x3x{d} BS {bs} {str(dt)[6:]}",
                    controls=False)


def phase_spec_timing(dev, card_name, prefill_ms):
    """Kernels A and B timed alone (cold L2, the median of 20 calls queued
    behind a device sleep, ``median_ms``). ``int8_matmul`` at every
    GPT-medium (K, N) and the transposed ``wte`` at M in (1, 8, 64, 512,
    the traffic's largest prefill bucket), beside its plain version (the JAX expression in float32: the payload widened,
    ``torch.matmul``, the scale), the library yardstick (one
    ``torch.matmul`` of x with the dequantised float32 weight, made
    outside the timing: the float32 server's own cuBLAS product) and the
    bound (the payload, x, the scale
    and y moved once over the memory rate; 2 M N K float32-grade products
    with an int8 weight, where only x is split, over the faster of two
    TF32 and three bf16 passes, ``measure.int8_weight_bound``).
    ``paged_verify_attention`` at 8 lanes x W 8 x 12 x 128, every
    lane's window starting at context 64, 128, 512 and 1024 - 8, and at each
    of ``verify_mixes``' launches, blocks of 16, beside its plain version
    (host syncs:
    ``synced_ms``), the decode kernel over the same rows (W launches' worth
    of work in one), the
    library (one masked ``F.scaled_dot_product_attention`` of the windows
    over each lane's contiguous context) and the bound (each lane's
    cached keys read once, q, out and the new rows). Returns per-call
    times by shape."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    out = {}
    for k, n, tr in INT8_SHAPES:
        for m in sorted({1, 8, 64, 512, prefill_ms}):
            x, w, s = measure.int8_matmul_case(dev, m, k, n, tr)
            # the dequantised float32 weight [K, N], made once
            deq = (w.float() * s).t().contiguous() if tr else w.float() * s
            ms = median_ms(lambda: im.int8_matmul(x, w, s, tr), flush)
            plain = median_ms(lambda: im.int8_matmul_plain(x, w, s, tr),
                              flush)
            lib = median_ms(lambda: torch.matmul(x, deq), flush)
            ops, nbytes = measure.int8_matmul_bounds(m, k, n)
            b = measure.int8_weight_bound(ops, nbytes, card_name)
            key = f"{k}x{n}{'T' if tr else ''}_m{m}"
            out[key] = {"ms": ms, "plain_ms": plain,
                        "library_ms": lib, **b,
                        "tb_per_s": nbytes / ms / 1e9,
                        "tflops": ops / ms / 1e9}
            log(f"  int8_matmul {m}x{k} @ {'wte^T' if tr else 'w'} "
                f"{k}x{n}: {ms:.4f} ms (plain "
                f"{plain:.4f}, library {lib:.4f}, bound {b['bound_ms']:.4f} "
                f"by {b['bound_by']}; {nbytes / ms / 1e9:.3f} TB/s, "
                f"{ops / ms / 1e9:.2f} TFLOP/s)  [{card_name}]")
    cases = {**{str(ctx): [ctx] * SERVE_SLOTS
                for ctx in (64, 128, 512, 1024 - SPEC_K)}, **verify_mixes()}
    for label, ctxs in cases.items():
        case = measure.paged_verify_case(
            dev, [c or 0 for c in ctxs], SPEC_K, 12, 128, SERVE_BS,
            torch.float32, active=[c is not None for c in ctxs])
        q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
        pa.paged_verify_plain(*case)          # the window's rows in place
        qs, dk, dv, mask = measure.paged_verify_library(
            q, kc, vc, tab, lane, kmax, SERVE_SLOTS, SPEC_K)
        ms = median_ms(lambda: pa.paged_verify_attention(*case), flush)
        dec = median_ms(lambda: pa.paged_decode_attention(
            q, kn, vn, kc, vc, tab, lane, kmax, wb, wo), flush)
        plain = synced_ms(lambda: pa.paged_verify_plain(*case), flush, 3)
        lib = median_ms(lambda: F.scaled_dot_product_attention(
            qs, dk, dv, attn_mask=mask), flush)
        ops, nbytes = measure.paged_bounds(
            q, kc, tab, lane, kmax, int((wb >= 0).sum()), win0)
        b = measure.two_rate_bound(ops, nbytes, card_name)
        # the bytes of W decode rows a lane, each reading its keys
        _, wbytes = measure.paged_bounds(q, kc, tab, torch.arange(
            q.shape[0], device=dev, dtype=torch.int32), kmax)
        out[f"verify_{label.replace(' ', '_')}"] = {
            "ms": ms, "contexts": ctxs, "decode_kernel_ms": dec,
            "plain_ms": plain, "library_ms": lib, **b,
            "w_fold_bytes": wbytes, "bytes": nbytes}
        log(f"  paged_verify_attention 8 lanes x W {SPEC_K} at "
            f"{'context ' + label if label.isdigit() else label + ' ' + str(ctxs)}"
            f": {ms:.4f} ms (decode kernel over the same rows {dec:.4f}; plain {plain:.3f} host clock; library "
            f"{lib:.4f}; "
            f"bound {b['bound_ms']:.4f} by {b['bound_by']}; the bound's "
            f"{nbytes / 2**20:.2f} MiB against {wbytes / 2**20:.2f} MiB "
            f"if each row read its keys)  [{card_name}]")
    return out


def _serve_tiny_spec(kind, dev, qw, prompts):
    """GPT_TINY (build_gpt's seed 0) float32 as a speculative target with
    ``qw`` int8 weights through the ``kind`` ("paged" or "dense") server
    on ``dev``, its draft an independent 1-layer model of half the width
    from seed 1 (the JAX tests' DRAFT_CFG pairing: low acceptance, so
    rejections run), ``speculate_k`` 4; ``prompts`` queued before the
    worker starts, 16 new tokens each. Returns (tokens, every target
    dispatch's logits of its active lanes on the host, spec rounds, draft
    tokens rejected, the kernels' launches)."""
    import dataclasses
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_TINY, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    dcfg = dataclasses.replace(GPT_TINY, hidden_size=32, num_layers=1,
                               num_heads=2, intermediate_size=64)
    sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device=dev)
    dsd = build_gpt(dcfg, batch=2, seq_len=8, seed=1, device=dev)
    draft = gpt_generative_spec(dsd, dcfg, quantize_weights=qw)
    kw = dict(max_slots=2, start=False, device=dev, draft_spec=draft,
              speculate_k=4)
    if kind == "paged":
        srv = PagedGenerativeServer(gpt_paged_spec(sd, GPT_TINY,
                                                   quantize_weights=qw),
                                    block_size=8, debug_leaks=True, **kw)
    else:
        srv = GenerativeServer(gpt_generative_spec(sd, GPT_TINY,
                                                   quantize_weights=qw), **kw)
    logits = []
    for attr in ("_prefill_disp", "_decode_disp", "_verify_disp"):
        real = getattr(srv, attr)

        def recording(*a, _real=real):
            out = _real(*a)
            lg = out[3].detach().cpu()
            if "active" in a[3]:           # a decode or verify: its lanes
                lg = lg[np.flatnonzero(a[3]["active"])]
            logits.append(lg)
            return out
        setattr(srv, attr, recording)

    def counts():
        return {**pa.LAUNCHES, **im.LAUNCHES}
    before = counts()
    hs = [srv.submit(p, max_new_tokens=16) for p in prompts]
    srv.start()
    toks = [h.result(timeout=300) for h in hs]
    srv.shutdown()
    g = srv.metrics.to_record()["generative"]
    launched = {k: v - before[k] for k, v in counts().items() if v > before[k]}
    return toks, logits, g["spec_rounds"], g["draft_rejected"], launched


def phase_spec_parity():
    """GPT_TINY speculative serving on the card and on the CPU (whose
    kernels are the plain PyTorch versions), the same prompts: the dense
    and the paged server, float32 and int8 weights, each with an
    independent low-acceptance draft. The same tokens, and every target
    dispatch's logits within SERVE_PARITY_TOL of their magnitude; on the
    card the verify kernel, the decode kernel (the draft) and, with int8
    weights, the int8 GEMM must have served it."""
    from deeplearning4j_tpu_torch.zoo import GPT_TINY
    rng = np.random.default_rng(0)
    shared = rng.integers(0, GPT_TINY.vocab_size, 24).astype(np.int32)
    prompts = [shared, np.concatenate([shared, rng.integers(
        0, GPT_TINY.vocab_size, 5)]).astype(np.int32),
        rng.integers(0, GPT_TINY.vocab_size, 9).astype(np.int32)]
    for kind in ("dense", "paged"):
        for qw in (False, True):
            (tc, lc, rc, jc, nc), (th, lh, rh, jh, _) = (
                _serve_tiny_spec(kind, dev, qw, prompts)
                for dev in ("cuda", "cpu"))
            tol = SERVE_PARITY_TOL[torch.float32]
            worst = max(_tensor_rel(a, b) for a, b in zip(lc, lh)) \
                if len(lc) == len(lh) else math.inf
            want = ("paged_verify_attention", "paged_decode_attention") + (
                ("int8_matmul",) if qw else ())
            routed = all(nc.get(k, 0) > 0 for k in want) and (
                qw or nc.get("int8_matmul", 0) == 0)
            log(f"  GPT_TINY {kind} speculative serving, "
                f"{'int8' if qw else 'float32'} weights, card vs cpu: "
                f"tokens identical {tc == th}, {len(lc)} dispatches' logits "
                f"worst {worst:.2e} (tol {tol:g}), rounds {rc}/{rh}, drafts "
                f"rejected {jc}/{jh}, launches on the card {nc}")
            if not (tc == th and worst <= tol and routed and rc >= 1
                    and jc >= 1):
                raise SystemExit(f"{kind} speculative serving on the card "
                                 f"disagrees with the CPU")


#: a speculative round's kernels by group, and the wrapper count each
#: group's traced launches must equal
SPEC_GROUPS = {"int8 GEMM": "int8_matmul",
               "verify attention": "paged_verify_attention",
               "draft decode attention": "paged_decode_attention"}


def _spec_group(name):
    """A device kernel's group in a speculative round, by its traced name:
    the int8 GEMM (its wgmma kernel), the verify kernel, or the cluster
    kernel (the draft's decode), demangled or mangled; else None."""
    if "int8_wgmma_kernel" in name:
        return "int8 GEMM"
    if "paged_verify_kernel" in name or "paged_verify_i8_kernel" in name:
        return "verify attention"
    if "paged_decode_kernel" in name:
        return "draft decode attention"
    return None


def profile_spec_rounds(spec, draft, reqs, card, n_new=81):
    """Speculative rounds of 8 lanes under torch.profiler: 8 of the
    requests with ``n_new`` new tokens each through a fresh speculative
    server, its prefills before the profiler, then its steps on this
    thread. Device busy ms a round (the union of device intervals), the
    wall of the same rounds (CUDA events around each step), device
    launches a round, device time by group (the int8 GEMM, the verify and
    the draft's decode attention by kernel name and instantiation, layer
    norm and the draft's other work by their labelled range), and each
    kernel group's traced launches against its wrapper's count over the
    same window (16 tiny kernels open the window, since the tracer can
    drop its first launches; they fall in "other"). A window whose trace
    lost launches is taken again on a fresh server, twice at most."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.ops import nn_ops
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.serving.resilience import InflightSlot

    def labelled(fn, label):
        def run(*a, **kw):
            with record_function(f"spec::{label}"):
                return fn(*a, **kw)
        return run

    def one_pass():
        """One profiled window over a fresh server's rounds: (the
        profiler, the steps' event pairs, each group's count by its
        wrapper, the rounds)."""
        srv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                    block_size=SERVE_BS,
                                    max_seq_len=SERVE_SEQ, draft_spec=draft,
                                    speculate_k=SPEC_K, start=False)
        real_dd = srv.draft_spec.decode
        srv.draft_spec.decode = labelled(real_dd, "draft")
        hs = [srv.submit(p[:64], max_new_tokens=n_new) for p, _ in reqs[:8]]
        slot = InflightSlot()
        srv._admit(slot)
        torch.cuda.synchronize()
        marks = []
        launches = {**im.LAUNCHES, **pa.LAUNCHES}
        before = {k: launches[k] for k in SPEC_GROUPS.values()}
        r0 = srv.metrics.counters["spec_rounds"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a few tiny kernels first: the tracer can drop a window's
            # first launches, and these are no group's
            warm = torch.zeros(1, device=torch.device("cuda"))
            for _ in range(16):
                warm.add_(1)
            torch.cuda.synchronize()
            while not all(h.future.done() for h in hs):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                srv._step(slot)
                e1.record()
                marks.append((e0, e1))
            torch.cuda.synchronize()
        launches = {**im.LAUNCHES, **pa.LAUNCHES}
        counted = {g: launches[k] - before[k] for g, k in SPEC_GROUPS.items()}
        rounds = srv.metrics.counters["spec_rounds"] - r0
        srv.draft_spec.decode = real_dd
        srv.shutdown()
        return prof, marks, counted, rounds

    def traced_of(prof):
        traced = {g: 0 for g in SPEC_GROUPS}
        for e in prof.events():
            g = _spec_group(e.name) if e.device_type.name == "CUDA" else None
            if g is not None:
                traced[g] += 1
        return traced

    real_ln = nn_ops.layer_norm
    nn_ops.layer_norm = labelled(real_ln, "layer norm")
    try:
        # a window whose trace holds fewer launches of a group than its
        # wrapper counted, and none more (the profiler lost records), is
        # taken again on a fresh server, twice at most; the reading must
        # then hold every launch
        for attempt in range(3):
            prof, marks, counted, rounds = one_pass()
            traced = traced_of(prof)
            lost = traced != counted and all(
                traced[g] <= counted[g] for g in SPEC_GROUPS)
            if rounds != len(marks) or not lost or attempt == 2:
                break
            log(f"  profiler: the trace holds {traced} launches, the "
                f"wrappers counted {counted}: lost records, taken again")
    finally:
        nn_ops.layer_norm = real_ln
    steps = len(marks)
    # device work: every device event but the labels' own ranges
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.name.startswith("spec::"):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    n_kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA"
                    and not e.name.startswith(("spec::", "Memcpy", "Memset")))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    wall = sum(a.elapsed_time(b) for a, b in marks)
    by_group = {}
    for name, ms in by_name.items():
        g = _spec_group(name) or "other"
        by_group[g] = by_group.get(g, 0.0) + ms
    # layer norm and the draft's own other work, by their labelled ranges
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        chain, c = [], e
        while c is not None:
            chain.append(c.name)
            c = c.cpu_parent
        label = next((n[len("spec::"):] for n in chain
                      if n.startswith("spec::")), None)
        if label is None:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        g = label if label == "layer norm" else "draft (other than the kernels)"
        if any(_spec_group(kn.name) for kn in e.kernels):
            continue
        by_group[g] = by_group.get(g, 0.0) + ms
        by_group["other"] = by_group.get("other", 0.0) - ms
    per = max(rounds, 1)
    log(f"  profiler, {rounds} speculative rounds of {steps} steps: device "
        f"busy {busy / per:.3f} ms a round of a {wall / per:.2f} ms wall "
        f"round (idle share {1 - busy / wall:.3f}); {n_kernels / per:.1f} "
        f"device launches a round  [{card}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"    {ms / per:8.4f} ms a round  {g}")
    log(f"  traced kernels over the window: {traced}; counted by the "
        f"wrappers: {counted}")
    if rounds != steps:
        raise SystemExit(f"the profiled window took {steps} steps for "
                         f"{rounds} speculative rounds")
    if traced != counted:
        raise SystemExit(f"the profiled rounds' trace holds {traced} "
                         f"launches, the wrappers counted {counted}")
    return {"busy_ms": busy / per, "round_ms": wall / per,
            "idle_share": 1 - busy / wall, "launches": n_kernels / per,
            "by_group_ms": {g: ms / per for g, ms in by_group.items()},
            "rounds": rounds}


def profile_int8_prefill(spec, card, layers, n=3):
    """``n`` paged 512-row prefills (no cached prefix, blocks of 16) of the
    GPT-medium int8 target under torch.profiler, after one unprofiled:
    per prefill, the int8 kernel's launches (4 a layer and the logits) and
    device time beside all its device time. The wrapper's count must
    equal the profiler's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.serving.generative import _slab
    dev = torch.device("cuda")
    maxb = SERVE_SEQ // SERVE_BS
    prefill, _, _ = spec.make_fns(SERVE_BS, maxb)
    nb = 1 + 512 // SERVE_BS
    kc, vc = (_slab(spec.kv_shape(nb, SERVE_BS), spec.kv_dtype, dev)
              for _ in range(2))
    table = np.zeros(maxb, np.int32)
    table[:nb - 1] = np.arange(1, nb)
    params = spec.params()
    tokens = np.random.default_rng(3).integers(
        0, params["wte"].shape[0], 512).astype(np.int32)
    io = {"tokens": tokens, "length": np.int32(512), "hist": np.int32(0),
          "table": table}
    with torch.inference_mode():
        prefill(params, kc, vc, io)
        torch.cuda.synchronize()
        # a trace holding fewer launches than the wrapper counted (the
        # tracer can drop a window's first kernels) is taken once more
        for attempt in range(2):
            before = im.LAUNCHES["int8_matmul"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    prefill(params, kc, vc, io)
                torch.cuda.synchronize()
            counted = im.LAUNCHES["int8_matmul"] - before
            gemm = total = 0.0
            traced = 0
            for e in prof.events():
                if e.device_type != DeviceType.CUDA:
                    continue
                ms = e.time_range.elapsed_us() / 1e3
                total += ms
                if _spec_group(e.name) == "int8 GEMM":
                    gemm, traced = gemm + ms, traced + 1
            if traced == counted or attempt:
                break
    log(f"  profiler, {n} int8 prefills of 512 rows: int8 GEMM {gemm / n:.4f}"
        f" ms a prefill of its {total / n:.3f} ms device time, "
        f"{traced / n:.1f} launches a prefill (the wrapper counted "
        f"{counted})  [{card}]")
    if traced != counted or traced != n * (4 * layers + 1):
        raise SystemExit(f"int8 prefill: {traced} traced launches, the "
                         f"wrapper counted {counted}, want "
                         f"{n * (4 * layers + 1)}")
    del kc, vc
    return {"int8_gemm_ms": gemm / n, "device_ms": total / n,
            "launches": traced / n}


def _serve_requests(srv, reqs, card, label):
    """``reqs`` through ``srv`` (submitted at once; a submit the pool sheds
    is retried after its hint), each step's wall time and each token's
    arrival recorded. Returns (tokens, metrics)."""
    from deeplearning4j_tpu_torch.serving.paged import PoolExhaustedError
    steps = []
    real_obs = srv.metrics.observe_decode_step

    def obs(active, ms):
        steps.append((active, ms))
        real_obs(active, ms)
    srv.metrics.observe_decode_step = obs
    times = [[] for _ in reqs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hs, pending, sheds = [None] * len(reqs), list(range(len(reqs))), 0
    while pending:
        still, hint = [], 0.05
        for i in pending:
            p, n = reqs[i]
            try:
                hs[i] = srv.submit(p, max_new_tokens=n, on_token=lambda
                                   t, i=i: times[i].append(
                                       time.perf_counter()))
            except PoolExhaustedError as e:
                sheds += 1
                still.append(i)
                hint = min(hint, e.retry_after_s)
        pending = still
        if pending:
            time.sleep(hint)
    got = [h.result(timeout=900) for h in hs]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    g = srv.metrics.to_record()["generative"]
    n_tok = sum(len(t) for t in got)
    gaps = [1e3 * (b - a) for t in times for a, b in zip(t, t[1:])]
    step_ms = [ms for _, ms in steps]
    m = {"tokens_per_s": n_tok / wall, "tokens": n_tok, "wall_s": wall,
         "intertoken_p50_ms": float(np.percentile(gaps, 50)),
         "step_p50_ms": float(np.percentile(step_ms, 50)),
         "steps": len(steps), "spec_rounds": g["spec_rounds"],
         "acceptance": g["draft_acceptance_rate"],
         "prefills": g["prefills"], "decode_steps": g["decode_steps"],
         "peak_gib": peak / 2**30, "peak_above_gib": (peak - base) / 2**30,
         "sheds": sheds}
    log(f"  {label}: {n_tok} tokens in {wall:.3f} s, {m['tokens_per_s']:.1f} "
        f"tokens/s; {m['steps']} dispatch rounds ({g['spec_rounds']} "
        f"speculative, acceptance {g['draft_acceptance_rate']:.4f}), step "
        f"or round wall p50 {m['step_p50_ms']:.2f} ms, inter-token p50 "
        f"{m['intertoken_p50_ms']:.2f} ms; {g['prefills']} prefills, "
        f"{sheds} submits shed and retried; peak {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} above the run's start)  [{card}]")
    return got, m


def _check_drained(srv):
    st = srv.pool.stats()
    srv.pool.check_invariant(tables=[])
    deadline = time.monotonic() + 10
    while srv._committed and time.monotonic() < deadline:
        time.sleep(0.01)
    log(f"  pool after the run: {st}, committed {srv._committed}: "
        f"{'clean' if st['held'] == 0 and srv._committed == 0 else 'LEAK'}")
    if st["held"] or srv._committed:
        raise SystemExit("the block pool did not drain")


def _counting(spec):
    """Count the dispatches of a (draft) spec's prefill and decode."""
    n = {"prefill": 0, "decode": 0}
    for k in n:
        real = getattr(spec, k)

        def run(*a, _real=real, _k=k):
            n[_k] += 1
            return _real(*a)
        setattr(spec, k, run)
    return n


def phase_spec_serving(dev, card):
    """GPT-medium at full width, float32 weights from ``build_gpt(...,
    seed=0)`` with the self-draft pairing (``bench.py``'s
    ``bench_serving_speculative``): from layer 1 on, the residual-out
    projections (``attn/proj``, ``mlp/proj``, kernel and bias) zeroed, so
    a 1-layer draft over the same weights computes the target's logits.
    Target ``gpt_paged_spec(sd, GPT_MEDIUM, quantize_weights=True)``, draft
    ``gpt_generative_spec(sd, replace(GPT_MEDIUM, num_layers=1),
    quantize_weights=True)``, through ``PagedGenerativeServer(max_slots=8,
    block_size=16, max_seq_len=1024, draft_spec=..., speculate_k=8)``: the
    32 ``serving_traffic`` requests, temperature 0, through ``submit`` /
    ``result()``. Counts set to 0 just before, read just after: 16
    ``paged_verify_attention`` launches a round; 65 ``int8_matmul`` a
    target prefill, decode step or verify and 5 a draft dispatch;
    ``paged_decode_attention`` 16 a plain target step and 1 a draft
    decode, never in a verify. Every request against ``greedy_decode``
    of the dense int8 target; the pool drains; ``spec_rounds >= 1``. Then
    a profiled pass of rounds, the same requests on the int8 target
    without a draft (the yardstick), and 8 requests through a float32
    target with a float32 self-draft, each against ``greedy_decode``."""
    import dataclasses
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_MEDIUM, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    cfg = GPT_MEDIUM
    L = cfg.num_layers
    t0 = time.perf_counter()
    sd = build_gpt(cfg, batch=1, seq_len=8, seed=0)
    for i in range(1, L):
        for part in ("attn/proj", "mlp/proj"):
            for leaf in ("kernel", "bias"):
                n = f"h{i}/{part}/{leaf}"
                sd.set_arr_for_var(n, torch.zeros_like(
                    sd.get_arr_for_var(n)))
    dcfg = dataclasses.replace(cfg, num_layers=1)
    spec = gpt_paged_spec(sd, cfg, quantize_weights=True)
    draft = gpt_generative_spec(sd, dcfg, quantize_weights=True)
    ref = gpt_generative_spec(sd, cfg, quantize_weights=True)
    reqs = serving_traffic(cfg.vocab_size)
    srv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                block_size=SERVE_BS, max_seq_len=SERVE_SEQ,
                                draft_spec=draft, speculate_k=SPEC_K)
    log(f"  GPT-medium int8 target and 1-layer int8 self-draft up in "
        f"{time.perf_counter() - t0:.1f} s; warmup {srv.warmup_report}")
    nd = _counting(srv.draft_spec)
    pa.reset_launches()
    im.reset_launches()
    af.reset_launches()
    got, m = _serve_requests(srv, reqs, card,
                             f"int8 speculative (k={SPEC_K}), 32 requests")
    launches = {**pa.LAUNCHES, **im.LAUNCHES,
                "paged_prefill_f32": af.LAUNCHES["paged_prefill_f32"],
                "attention_fwd_f32": af.LAUNCHES["attention_fwd_f32"]}
    srv.shutdown()
    # the counters settle once the worker has stopped: a round's tokens
    # reach their futures before the round itself is recorded
    g = srv.metrics.to_record()["generative"]
    m.update(spec_rounds=g["spec_rounds"], prefills=g["prefills"],
             decode_steps=g["decode_steps"],
             acceptance=g["draft_acceptance_rate"])
    R, P = m["spec_rounds"], m["prefills"]
    plain = m["decode_steps"] - R
    want = {"paged_attention": 0,
            "paged_decode_attention": L * plain + nd["decode"],
            "paged_verify_attention": L * R,
            "int8_matmul": (4 * L + 1) * (P + plain + R)
            + 5 * (nd["prefill"] + nd["decode"]),
            "paged_prefill_f32": L * P, "attention_fwd_f32": nd["prefill"]}
    log(f"  launches {launches} over {P} prefills, {plain} plain steps, "
        f"{R} rounds, {nd['prefill']} draft prefills and {nd['decode']} "
        f"draft decodes; want {want}; launches a round: "
        f"{L} verify, {4 * L + 1} + {SPEC_K} x 5 = {4 * L + 1 + SPEC_K * 5} "
        f"int8_matmul, {SPEC_K} paged_decode_attention (the draft)")
    if launches != want or R < 1 or nd["decode"] != SPEC_K * R:
        raise SystemExit(f"speculative serving launched {launches}, want "
                         f"{want}")
    _check_drained(srv)
    t0 = time.perf_counter()
    same, ties = check_against_greedy(ref, reqs, got, dev)
    log(f"  against greedy_decode of the dense int8 target on the card: "
        f"{same} of {len(reqs)} identical, {len(ties)} near ties {ties} "
        f"({time.perf_counter() - t0:.1f} s)")
    m["launches"] = launches
    m["profile"] = profile_spec_rounds(spec, draft, reqs, card)
    m["int8_prefill"] = profile_int8_prefill(spec, card, L)
    ysrv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                 block_size=SERVE_BS, max_seq_len=SERVE_SEQ)
    ygot, ym = _serve_requests(ysrv, reqs, card,
                               "int8, no draft (the yardstick), 32 requests")
    ysrv.shutdown()
    _check_drained(ysrv)
    log(f"  speculative / plain int8 tokens/s: "
        f"{m['tokens_per_s'] / ym['tokens_per_s']:.3f}; tokens equal "
        f"{sum(a == b for a, b in zip(got, ygot))} of {len(reqs)}")
    # float32 target and float32 self-draft
    fspec = gpt_paged_spec(sd, cfg)
    fdraft = gpt_generative_spec(sd, dcfg)
    fref = gpt_generative_spec(sd, cfg)
    fsrv = PagedGenerativeServer(fspec, max_slots=SERVE_SLOTS,
                                 block_size=SERVE_BS, max_seq_len=SERVE_SEQ,
                                 draft_spec=fdraft, speculate_k=SPEC_K)
    sub = reqs[:8]
    fgot, fm = _serve_requests(fsrv, sub, card,
                               f"float32 speculative (k={SPEC_K}), 8 requests")
    fsrv.shutdown()
    _check_drained(fsrv)
    if fm["spec_rounds"] < 1:
        raise SystemExit("the float32 speculative server ran no round")
    fsame, fties = check_against_greedy(fref, sub, fgot, dev)
    log(f"  float32 against greedy_decode on the card: {fsame} of "
        f"{len(sub)} identical, {len(fties)} near ties {fties}")
    del srv, ysrv, fsrv, sd, spec, draft, ref, fspec, fdraft, fref
    torch.cuda.empty_cache()
    return {"spec": m, "plain": ym, "f32": fm}


def spec_kernel_records(t, serve, errs):
    """The two kernels' JSON records, per speculative round of 8 lanes at
    k = 8: ``int8_matmul``'s 105 launches (a target verify at M = 64: 16
    layers x 4 products and the tied logits; 8 draft dispatches at M = 8:
    4 products and the logits each), ``paged_verify_attention``'s 16 at
    context 512; each time the sum of its calls' per-call times."""
    m = serve["spec"]
    prof = m["profile"]["by_group_ms"]
    keys = ("1536x4608", "1536x1536", "1536x6144", "6144x1536")

    def round_sum(field):
        return sum(16 * t[f"{k}_m64"][field] + SPEC_K * t[f"{k}_m8"][field]
                   for k in keys) + t["1536x32768T_m64"][field] \
            + SPEC_K * t["1536x32768T_m8"][field]
    by_bytes = round_sum("bytes_ms") >= round_sum("ops_ms")
    v = t["verify_512"]
    return [{
        "name": "int8_matmul", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES,
        "launches": m["launches"]["int8_matmul"],
        "launches_per_step": 4 * 16 + 1 + SPEC_K * 5,
        "max_abs_err": errs["int8_matmul"],
        "ms": round_sum("ms"),
        "plain_ms": round_sum("plain_ms"),
        "bound_ms": round_sum("bound_ms"),
        "bound_by": "bytes" if by_bytes else "operations",
        "library_ms": round_sum("library_ms"),
        "ms_per": "speculative round, 8 lanes, k = 8 (a verify at M = 64, "
                  "8 draft dispatches at M = 8)",
        "in_step_ms": prof.get("int8 GEMM"),
        "per_call": {k: c for k, c in t.items() if not k.startswith("v")}},
        {
        "name": "paged_verify_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": VERIFY_REPLACES,
        "launches": m["launches"]["paged_verify_attention"],
        "launches_per_step": 16,
        "max_abs_err": errs["paged_verify_attention"],
        "ms": 16 * v["ms"],
        "plain_ms": 16 * v["plain_ms"],
        "bound_ms": 16 * v["bound_ms"], "bound_by": v["bound_by"],
        "library_ms": 16 * v["library_ms"],
        "ms_per": "speculative round's verify, 8 lanes x W 8 at context 512",
        "in_step_ms": prof.get("verify attention"),
        "per_call": {k: c for k, c in t.items() if k.startswith("v")}}]


# ----------------------------------------------------------------------
# BERT-base from a frozen TF GraphDef (phases 20-21)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 16, 128, 16
BERT_FEATURES = ["input_ids", "input_mask", "token_type_ids"]


def _bert_data(vocab, n, seq, seed=0, ragged=False):
    """``bench.py``'s ``bench_bert_base`` data (ids uniform over the
    vocabulary, mask all ones, token types 0, one-hot labels of 2 classes,
    seed 0); ``ragged`` masks the tail of every third row and gives the
    second half of each row token type 1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    mask = np.ones((n, seq), np.int32)
    tt = np.zeros((n, seq), np.int32)
    if ragged:
        mask[::3, seq // 2:] = 0
        tt[:, seq // 2:] = 1
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return [ids, mask, tt], [labels]


def _bert_config(sd, mixed_precision, lr):
    from deeplearning4j_tpu_torch.autodiff import (MixedPrecision,
                                                   TrainingConfig)
    from deeplearning4j_tpu_torch.learning import Adam
    sd.training_config = TrainingConfig(
        updater=Adam(lr), data_set_feature_mapping=BERT_FEATURES,
        data_set_label_mapping=["labels"],
        mixed_precision=MixedPrecision() if mixed_precision else None)


def phase_bert_parity():
    """BERT_TINY (batch 4, seq 16) in float64, imported from the same
    GraphDef bytes on the card and on the CPU, with a ragged mask and both
    token types: every gradient of ``calculate_gradients``, then three
    Adam steps through ``fit`` (the card's scanned tier captures them as
    one CUDA graph), each tensor to 1e-6 of its magnitude."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.zoo import BERT_TINY, bert_base
    feats, labels = _bert_data(BERT_TINY.vocab_size, 16, 16, seed=3,
                               ragged=True)
    res = {}
    for dev in ("cuda", "cpu"):
        sd = bert_base(BERT_TINY, batch=4, seq_len=16, num_labels=2, seed=7,
                       device=dev)
        for n, a in sd.trainable_params().items():
            sd.set_arr_for_var(n, a.double())
        grads = sd.calculate_gradients(
            {**dict(zip(BERT_FEATURES, (f[:4] for f in feats))),
             "labels": labels[0][:4]})
        _bert_config(sd, False, 1e-3)
        h = sd.fit(DeviceCachedIterator([f[4:] for f in feats],
                                        [labels[0][4:]], batch_size=4,
                                        device=dev))
        res[dev] = (grads, h.step_losses, dict(sd.trainable_params()),
                    dict(sd.last_fit_stats))
    (gc, lc, pc, sc), (gh, lh, ph, _) = res["cuda"], res["cpu"]
    # the key biases' gradient is zero but for rounding (the softmax takes
    # away what they add to a row's scores): held to be that on both sides
    # (below 1e-9 of the largest gradient), and their Adam steps to stay
    # within 1e-8 of zero; every other tensor to 1e-6 of its magnitude
    top = max(float(g.abs().max()) for g in gh.values())
    noise = {n for n in gh if float(gh[n].abs().max()) <= 1e-9 * top}
    keys = {n for n in gh if n.endswith("attention/self/key/bias")}
    noise_ok = noise == keys and all(
        float(gc[n].abs().max()) <= 1e-9 * top and
        float(pc[n].abs().max()) <= 1e-8 and
        float(ph[n].abs().max()) <= 1e-8 for n in keys)
    eg = max(_tensor_rel(gc[n], gh[n]) for n in gh if n not in keys)
    ep = max(_tensor_rel(pc[n], ph[n]) for n in ph if n not in keys)
    el = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    log(f"  float64 BERT_TINY, card vs cpu over {len(gh)} tensors: "
        f"gradients worst {eg:.2e}, params after 3 Adam steps worst "
        f"{ep:.2e}, losses {lc} vs {lh} (worst {el:.2e}); tol 1e-6; the "
        f"{len(keys)} key biases' gradients rounding noise on both sides: "
        f"{noise_ok}; the card's fit: {sc['tier']}, "
        f"{sc['graph_replays_per_epoch']} graph replay(s)")
    if not (eg <= 1e-6 and ep <= 1e-6 and el <= 1e-6 and noise_ok and
            len(lc) == 3 and sc["graph_replays_per_epoch"] == 1):
        raise SystemExit("BERT_TINY on the card disagrees with the CPU")


#: the device-time groups of a replayed BERT step, by kernel name (a
#: replay's kernels have no host op to charge them to)
BERT_KERNEL_GROUPS = (
    ("Adam (_foreach)", ("multi_tensor_apply", "foreach")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "Kernel2", "cutlass", "xmma")),
    ("softmax", ("softmax", "SoftMax")),
    ("gather / one-hot / scatter", ("index", "Index", "scatter", "gather",
                                    "Sort", "sort", "radix", "Radix")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise")),
)


def _bert_group(kernel_name):
    for group, keys in BERT_KERNEL_GROUPS:
        if any(k in kernel_name for k in keys):
            return group
    return "other"


def _bert_epoch(sd, data, label, card):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = sd.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sd.last_fit_stats
    r = {"tier": st["tier"], "graph_replays_per_epoch":
         st["graph_replays_per_epoch"], "window_captures":
         st["window_captures"], "step_ms": 1000 * wall / BERT_STEPS,
         "samples_per_s": BERT_BATCH * BERT_STEPS / wall,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
         "losses": hist.step_losses}
    log(f"  {label} ({r['tier']}, {r['graph_replays_per_epoch']} graph "
        f"replays, {r['window_captures']} captures): {BERT_STEPS} steps in "
        f"{wall:.3f} s: step {r['step_ms']:.2f} ms, "
        f"{r['samples_per_s']:.1f} samples/s, peak memory "
        f"{r['peak_mem_gib']:.2f} GiB allocated ({r['peak_reserved_gib']:.2f}"
        f" GiB reserved, graph pools included)  [{card}]")
    if not all(np.isfinite(r["losses"])):
        raise SystemExit(f"BERT-base {label}: losses {r['losses']}")
    return r


def profile_bert_replay(sd, it, step_ms, card):
    """One scanned epoch (one replay) under torch.profiler: device
    launches, busy time and idle share a step (against the traced epoch's
    own wall time; the timed step ``step_ms`` printed beside it), and
    device time a step by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sd.fit(it)
        torch.cuda.synchronize()
        traced_ms = 1000 * (time.perf_counter() - t0) / BERT_STEPS
    if sd.last_fit_stats["graph_replays_per_epoch"] != 1:
        raise SystemExit("the profiled BERT epoch was not one replay")
    n_act, n_kernels, busy, by_name = device_activity(prof)
    if busy == 0:
        raise SystemExit("the profiler recorded no device time")
    by_group = {}
    for name, ms in by_name.items():
        g = _bert_group(name)
        by_group[g] = by_group.get(g, 0.0) + ms / BERT_STEPS
    busy /= BERT_STEPS
    r = {"launches": n_act / BERT_STEPS, "kernels": n_kernels / BERT_STEPS,
         "busy_ms": busy, "idle_share": 1 - busy / traced_ms,
         "traced_ms": traced_ms, "by_group_ms": by_group}
    log(f"  profiler, one replay of the scanned epoch: {r['launches']:.1f} "
        f"device launches a step ({r['kernels']:.1f} kernels), busy "
        f"{busy:.3f} ms a step of the traced epoch's {traced_ms:.2f}: idle "
        f"share {r['idle_share']:.3f} (the timed step: {step_ms:.2f} ms)  "
        f"[{card}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:8.3f} ms  {ms / busy:.3f} of busy  {g}")
    for key, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms / BERT_STEPS:8.3f} ms  {key[:100]}")
    return r


def phase_bert(card):
    """BERT-base (``BERT_BASE``: vocab 30522, hidden 768, 12 layers, 12
    heads of 64, ffn 3072), batch 16, seq 128, the pooled classifier with 2
    labels and softmax-CE, Adam(2e-5), bf16 MixedPrecision, as
    ``bench_bert_base`` runs it: ``bert_base`` writes the frozen GraphDef
    and imports it with the port's TF importer onto the card, then
    ``SameDiff.fit(DeviceCachedIterator([ids, mask, tt], [labels], 16))``
    on the scanned tier (one CUDA graph replay an epoch). A warm-up epoch
    (warm-up steps, the capture, one replay) and a warm-up of the per-step
    tier (the same batches as a list); then, from one saved state, a timed
    scanned epoch and a timed per-step epoch, whose losses and parameters
    must be bit-equal; then one profiled replay, and the scanned epoch
    captured again with TF32 allowed (what its absence costs)."""
    from deeplearning4j_tpu_torch.autodiff import samediff
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.zoo import BERT_BASE, bert
    cfg = BERT_BASE
    build_s = []
    real_build = bert.build_bert_graphdef

    def timed_build(*a, **k):
        t = time.perf_counter()
        pb = real_build(*a, **k)
        build_s.append((time.perf_counter() - t, len(pb)))
        return pb

    bert.build_bert_graphdef = timed_build
    t0 = time.perf_counter()
    try:
        sd = bert.bert_base(cfg, batch=BERT_BATCH, seq_len=BERT_SEQ,
                            num_labels=2, seed=0)
    finally:
        bert.build_bert_graphdef = real_build
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n_params = sum(p.numel() for p in sd.trainable_params().values())
    ops = {}
    for node in sd.ops():
        ops[node.op] = ops.get(node.op, 0) + 1
    log(f"  GraphDef written in {build_s[0][0]:.1f} s ({build_s[0][1]} "
        f"bytes), imported onto the card in {total - build_s[0][0]:.1f} s: "
        f"{len(sd.ops())} ops, {len(sd.trainable_params())} trainable "
        f"tensors ({n_params} params)")
    log(f"  ops by name: {dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    _bert_config(sd, True, 2e-5)
    feats, labels = _bert_data(cfg.vocab_size, BERT_BATCH * BERT_STEPS,
                               BERT_SEQ)
    it = DeviceCachedIterator(feats, labels, batch_size=BERT_BATCH)
    # the dtypes the step's ops give, read while the warm-up records them
    seen = {}
    real_run = samediff.SameDiff._run_nodes

    def recording(nodes, env):
        real_run(nodes, env)
        for node in nodes:
            for o in node.outputs:
                if o in env:
                    seen[o] = env[o].dtype

    samediff.SameDiff._run_nodes = staticmethod(recording)
    t0 = time.perf_counter()
    try:
        warm = sd.fit(it)
        torch.cuda.synchronize()
    finally:
        samediff.SameDiff._run_nodes = staticmethod(real_run)
    seq_dt = seen.get("bert/encoder/sequence_output")
    log(f"  warm-up epoch ({sd.last_fit_stats['tier']}: warm-up steps, "
        f"capture of {BERT_STEPS} steps, one replay) in "
        f"{time.perf_counter() - t0:.1f} s, losses "
        f"{[round(v, 4) for v in warm.step_losses]}; inside the bf16 step "
        f"bert/encoder/sequence_output is {seq_dt}, the embeddings' gather "
        f"{seen.get('bert/embeddings/gather')}, the logits "
        f"{seen.get('classifier/logits_b')}")
    if seq_dt != torch.float32:
        raise SystemExit(f"sequence_output is {seq_dt} in the bf16 step; the "
                         f"JAX dtype rule makes it float32")
    steps = list(it)
    t0 = time.perf_counter()
    sd.fit(steps)
    torch.cuda.synchronize()
    log(f"  per-step warm-up epoch in {time.perf_counter() - t0:.1f} s")
    pool = graph_pool_gib(sd)
    # one saved state for both timed epochs
    tc = sd.training_config
    live = sd.warmup_restore_set(*sd._fit_state())
    saved = [t.detach().clone() for t in live]
    counters = (tc.iteration_count, tc.epoch_count)
    scanned = _bert_epoch(sd, it, "timed scanned epoch", card)
    if scanned["tier"] != "scanned_epoch" or \
            scanned["graph_replays_per_epoch"] != 1 or \
            scanned["window_captures"]:
        raise SystemExit(f"BERT-base's timed epoch: {sd.last_fit_stats}")
    after_scanned = [t.detach().clone() for t in live]
    with torch.no_grad():
        for t, s in zip(live, saved):
            t.copy_(s)
    tc.iteration_count, tc.epoch_count = counters
    per_step = _bert_epoch(sd, steps, "timed per-step epoch (the yardstick)",
                           card)
    if per_step["tier"] != "per_step":
        raise SystemExit(f"BERT-base's yardstick ran {per_step['tier']}")
    same_losses = scanned["losses"] == per_step["losses"]
    diff = [float((a.double() - b.double()).abs().max())
            for a, b in zip(after_scanned, live)]
    log(f"  scanned vs per-step over the epoch from one state: losses "
        f"{'bit-equal' if same_losses else 'differ'}, {len(live)} tensors "
        f"(parameters and Adam state) "
        f"{'bit-equal' if max(diff) == 0 else f'differ by up to {max(diff):.3e}'}")
    if not same_losses or max(diff) != 0:
        raise SystemExit("BERT-base's scanned and per-step tiers differ")
    del saved, after_scanned
    log(f"  graph pool {pool if pool is None else round(pool, 3)} GiB; "
        f"losses {[round(v, 4) for v in scanned['losses']]}")
    prof = profile_bert_replay(sd, it, scanned["step_ms"], card)
    # what keeping PyTorch's default (no TF32 in float32 matmuls) costs:
    # the same epoch captured again with TF32 allowed, then the flag back
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sd._changed()                    # the next fit captures again
        sd.fit(it)
        tf32 = _bert_epoch(sd, it, "TF32 allowed (not the port's setting)",
                           card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
        sd._changed()
    log(f"  float32 matmuls without TF32 cost {scanned['step_ms'] - tf32['step_ms']:.2f}"
        f" ms a step ({scanned['step_ms']:.2f} against {tf32['step_ms']:.2f})"
        f"  [{card}]")
    del sd, it, steps, live
    torch.cuda.empty_cache()
    return {"scanned": scanned, "per_step": per_step, "profile": prof,
            "tf32": tf32, "graph_pool_gib": pool,
            "sequence_output_dtype": str(seq_dt)}


# ----------------------------------------------------------------------
# int8 KV (phases 22-24): the cluster kernels and the paged prefill over
# an int8 cache, and GPT-medium serving with int8 KV
#: the JAX code each int8 variant stands in for (the int8 write-then-read of
#: the JAX decode functions; XLA fused it, no Pallas kernel)
INT8KV_KERNELS = {
    "paged_decode_attention_int8": (PAGED_SOURCE,
                                    "deeplearning4j_tpu/zoo/gpt.py:668"),
    "paged_verify_attention_int8": (PAGED_SOURCE,
                                    "deeplearning4j_tpu/zoo/gpt.py:728"),
    "paged_prefill_f32_int8": (F32_SOURCE,
                               "deeplearning4j_tpu/zoo/gpt.py:612")}
#: the budget of the pool-size and load-generator comparisons: 49 float32
#: GPT-medium blocks of 16 (bench_serving_quant's 48 usable + the null one)
INT8KV_BUDGET_BLOCKS = 49
#: bench_serving_quant's trace (bench.py:836-909)
LOADGEN = dict(n_requests=24, concurrency=8, prompt_len=(2, 16),
               new_tokens=(4, 24), seed=23, max_seq_len=256)


def _int8_of(kc, vc):
    from deeplearning4j_tpu_torch.kernels import measure
    return measure.int8_cache(kc, vc)


def check_int8kv(kind, case, errs, label):
    """One int8 variant against its plain version, the float case ``case``
    (``measure``'s decode-write, verify or prefill case) made int8 with
    per-(head, channel) absmax scales: each on its own copy of the int8
    cache; the output within PAGED_TOL of the sum of its absolute terms
    (over the dequantised cache the plain version wrote), the written int8
    caches bit-equal, two calls bit-equal in output and cache, each launch
    counted as an int8 one; the decode with -128 (a value no store makes)
    at every row the step writes unchanged; each verify row bit-equal to
    the decode kernel's over the written cache. Prints one line; exits on
    a failure."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    if kind == "prefill":
        q, kc, vc, tables, lane, kmax = case
    else:
        q, kn, vn, kc, vc, tables, lane, kmax = case[:8]
    kc8, vc8, ks, vs = _int8_of(kc, vc)
    tol = PAGED_TOL[q.dtype]
    if kind == "decode":
        wb, wo = case[8:]
        fns = (pa.paged_decode_attention, pa.paged_decode_plain)
        extra = (wb, wo)
        name, counter = "paged_decode_attention_int8", (
            pa.INT8_LAUNCHES, "paged_decode_attention")
    elif kind == "verify":
        win0, wrow, wb, wo = case[8:]
        fns = (pa.paged_verify_attention, pa.paged_verify_plain)
        extra = (win0, wrow, wb, wo)
        name, counter = "paged_verify_attention_int8", (
            pa.INT8_LAUNCHES, "paged_verify_attention")
    else:
        kh = kmax.cpu().numpy()
        f32 = q.dtype == torch.float32
        name = "paged_prefill_f32_int8" if f32 else "paged_attention_int8"
        counter = (af.INT8_LAUNCHES, "paged_prefill_f32") if f32 else (
            pa.INT8_LAUNCHES, "paged_attention")

    def run(fn, k8=kc8, v8=vc8):
        k2, v2 = k8.clone(), v8.clone()
        if kind == "prefill":
            args = (q, k2, v2, tables[0], kmax)
            out = fn(*args, kh, ks, vs) if fn is pa.paged_prefill_attention \
                else fn(*args, ks, vs)
        else:
            out = fn(q, kn, vn, k2, v2, tables, lane, kmax, *extra, ks, vs)
        return out, k2, v2
    before = counter[0][counter[1]]
    kern = pa.paged_prefill_attention if kind == "prefill" else fns[0]
    got, gk, gv = run(kern)
    again, ak, av = run(kern)
    launched = counter[0][counter[1]] - before
    want, wk, wv = run(pa.paged_prefill_plain if kind == "prefill"
                       else fns[1])
    terms = pa.abs_terms(q, wk, wv, tables, lane, kmax, ks, vs)
    torch.cuda.synchronize()
    reading = measure.paged_reading(got, want, terms, tol)
    errs[name] = max(errs.get(name, 0.0), float(
        (got.double() - want.double()).abs().max()))
    rows = torch.equal(gk, wk) and torch.equal(gv, wv)
    same = torch.equal(got, again) and torch.equal(gk, ak) and \
        torch.equal(gv, av)
    extra_ok, note = True, ""
    if kind == "decode":
        pk, pv = measure.int8_write_poisoned(kc8, vc8, wb, wo)
        extra_ok = torch.equal(run(kern, pk, pv)[0], got)
        note = f", -128 where the step writes unchanged {extra_ok}"
    elif kind == "verify":
        act = (wb >= 0).nonzero().flatten()
        dec = pa.paged_decode_attention(q, kn, vn, gk.clone(), gv.clone(),
                                        tables, lane, kmax, wb, wo, ks, vs)
        extra_ok = torch.equal(dec[act], got[act])
        note = f", rows = decode kernel bits {extra_ok}"
    ok = reading <= 1 and rows and same and extra_ok and launched == 2
    log(f"  {label}: {reading:.3g} of tol, written int8 cache bit-equal "
        f"{rows}, bit-equal twice {same}{note}, int8 launches {launched} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")


def phase_int8kv_kernels(dev, errs):
    """The three kernels over an int8 cache against their plain versions
    (``check_int8kv``): the decode at GPT-medium decode (8 lanes x 12 heads
    of 128, blocks of 16, contexts 64-1016, one lane inactive), float32
    and float64, and at blocks of 1, 5 and 1024 x head dims 16-128; the
    verify at 8 lanes x W 8 x 12 x 128 from positions 64-1008, float32
    and float64, at W 1, 3 and 20, blocks of 5 and the dense slab; the
    paged prefill (float32: csrc/attention_f32.cu's int8 form; float64:
    the decode kernel with no write) at GPT-medium's 512 rows after 256
    cached keys, hist 0, 15 and 1000 x rows 1, 63 and 65, head dims
    16-64."""
    from deeplearning4j_tpu_torch.kernels import measure
    f32, f64 = torch.float32, torch.float64
    ctxs = [63, 127, 255, 511, 767, 900, 1015, 40]
    act = [True] * 7 + [False]
    for dt in (f32, f64):
        check_int8kv("decode", measure.paged_decode_write_case(
            dev, ctxs, 12, 128, SERVE_BS, dt, active=act, seed=1), errs,
            f"decode int8 GPT-medium 8 lanes, contexts 64-1016, "
            f"{str(dt)[6:]}")
    for bs, d in ((1, 16), (5, 32), (16, 64), (1024, 128), (16, 16)):
        check_int8kv("decode", measure.paged_decode_write_case(
            dev, [0, 15, 16, 300, 999], 3, d, bs, f32, seed=bs + d), errs,
            f"decode int8 blocks of {bs}, head dim {d}")
    pos0 = [64, 15, 128, 512, 1000, 0, 300, 700]
    for dt in (f32, f64):
        check_int8kv("verify", measure.paged_verify_case(
            dev, pos0, SPEC_K, 12, 128, SERVE_BS, dt, seed=2), errs,
            f"verify int8 GPT-medium 8 lanes x W {SPEC_K}, {str(dt)[6:]}")
    for w, d, bs, dense in ((1, 64, 16, False), (3, 64, 16, False),
                            (20, 64, 16, False), (8, 16, 5, False),
                            (8, 128, 1024, True)):
        check_int8kv("verify", measure.paged_verify_case(
            dev, [0, 40, 300, 500], w, 3, d, bs, f32,
            active=[True, True, False, True], seed=w, dense=dense), errs,
            f"verify int8 W {w}, head dim {d}, "
            f"{'the dense slab' if dense else f'blocks of {bs}'}")
    for hist, rows, length, d, dt in (
            (256, 512, 512, 128, f32), (0, 1, 1, 128, f32),
            (15, 63, 60, 128, f32), (1000, 65, 20, 128, f32),
            (15, 65, 65, 16, f32), (256, 64, 64, 64, f32),
            (256, 64, 64, 128, f64)):
        check_int8kv("prefill", measure.paged_prefill_case(
            dev, hist, rows, length, 12, d, SERVE_BS, dt, seed=rows), errs,
            f"prefill int8 hist {hist} rows {rows} head dim {d} "
            f"{str(dt)[6:]}")


def phase_int8kv_timing(dev, card_name):
    """Each int8 variant timed alone (cold L2, ``median_ms``) at the
    serving shapes, beside the float32 kernel on the same contexts, its
    plain version (host syncs: ``synced_ms``), the library (each lane's
    context gathered once outside the timing, then dequantised and one
    masked ``F.scaled_dot_product_attention``: three calls, no one call
    computes it) and its bound (int8 bytes; the prefill's products with
    int8 K and V, ``measure.int8_weight_bound``): the decode at 8 lanes at
    context 128, 512 and 1024; the verify at 8 lanes x W 8 from context
    64, 128, 512 and 1016; the prefill of 512 rows after 256 cached keys.
    Returns per-call times by shape."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    out = {}
    for ctx in (128, 512, 1024):
        case = measure.paged_decode_write_case(
            dev, [ctx - 1] * SERVE_SLOTS, 12, 128, SERVE_BS, torch.float32)
        q, kn, vn, kc, vc, tables, lane, kmax, wb, wo = case
        kc8, vc8, ks, vs = _int8_of(kc, vc)
        c8 = (q, kn, vn, kc8, vc8, tables, lane, kmax, wb, wo, ks, vs)
        pa.paged_decode_plain(*c8)            # the step's rows in place
        ms = median_ms(lambda: pa.paged_decode_attention(*c8), flush)
        f32 = median_ms(lambda: pa.paged_decode_attention(*case), flush)
        plain = synced_ms(lambda: pa.paged_decode_plain(*c8), flush, 3)
        lib = median_ms(measure.paged_int8_library(
            q, kc8, vc8, ks, vs, tables, kmax), flush)
        ops, nbytes = measure.paged_bounds(q, kc8, tables, lane, kmax,
                                           writes=SERVE_SLOTS)
        b = measure.two_rate_bound(ops, nbytes, card_name)
        out[f"decode_{ctx}"] = {"ms": ms, "float32_ms": f32,
                                "plain_ms": plain, "library_ms": lib, **b}
        log(f"  paged_decode_attention int8 8 lanes x 12 x 128 at context "
            f"{ctx}: {ms:.4f} ms a call (float32 cache {f32:.4f}), plain "
            f"{plain:.4f}, library (dequantise + masked SDPA) {lib:.4f}, "
            f"bound {b['bound_ms']:.4f} ({b['bound_by']}; "
            f"{b['bound_ms'] / ms:.2f} of it)  [{card_name}]")
    for ctx in (64, 128, 512, 1024 - SPEC_K):
        case = measure.paged_verify_case(
            dev, [ctx] * SERVE_SLOTS, SPEC_K, 12, 128, SERVE_BS,
            torch.float32)
        q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
        kc8, vc8, ks, vs = _int8_of(kc, vc)
        c8 = (q, kn, vn, kc8, vc8, tab, lane, kmax, win0, wrow, wb, wo, ks,
              vs)
        pa.paged_verify_plain(*c8)
        ms = median_ms(lambda: pa.paged_verify_attention(*c8), flush)
        f32 = median_ms(lambda: pa.paged_verify_attention(*case), flush)
        plain = synced_ms(lambda: pa.paged_verify_plain(*c8), flush, 3)
        qs, dk, dv, mask = measure.paged_verify_library(
            q, kc8, vc8, tab, lane, kmax, SERVE_SLOTS, SPEC_K)
        sk, sv = ks[None, :, None, :], vs[None, :, None, :]
        lib = median_ms(lambda: F.scaled_dot_product_attention(
            qs, dk.float() * sk, dv.float() * sv, attn_mask=mask), flush)
        ops, nbytes = measure.paged_bounds(q, kc8, tab, lane, kmax,
                                           int((wb >= 0).sum()), win0)
        b = measure.two_rate_bound(ops, nbytes, card_name)
        out[f"verify_{ctx}"] = {"ms": ms, "float32_ms": f32,
                                "plain_ms": plain, "library_ms": lib, **b}
        log(f"  paged_verify_attention int8 8 lanes x W {SPEC_K} at context "
            f"{ctx}: {ms:.4f} ms (float32 cache {f32:.4f}), plain "
            f"{plain:.3f} host clock, library {lib:.4f}, bound "
            f"{b['bound_ms']:.4f} ({b['bound_by']})  [{card_name}]")
    args = measure.paged_prefill_case(dev, 256, 512, 512, 12, 128, SERVE_BS,
                                      torch.float32)
    q, kc, vc, tables, lane, kmax = args
    kc8, vc8, ks, vs = _int8_of(kc, vc)
    table, kh = tables[0], kmax.cpu().numpy()
    ms = median_ms(lambda: pa.paged_prefill_attention(
        q, kc8, vc8, table, kmax, kh, ks, vs), flush)
    f32 = median_ms(lambda: pa.paged_prefill_attention(
        q, kc, vc, table, kmax, kh), flush)
    plain = synced_ms(lambda: pa.paged_prefill_plain(
        q, kc8, vc8, table, kmax, ks, vs), flush, 3)
    t_ctx = int(kmax.max()) + 1
    dk, dv, _ = measure.paged_dense(kc8, vc8, tables)
    dk, dv = dk[:, :, :t_ctx].contiguous(), dv[:, :, :t_ctx].contiguous()
    keys = torch.arange(t_ctx, device=dev)
    mask = (keys[None, :] <= kmax[:, None].long())[None, None]
    ql = q.permute(1, 0, 2)[None].contiguous()
    sk, sv = ks[None, :, None, :], vs[None, :, None, :]
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        ql, dk.float() * sk, dv.float() * sv, attn_mask=mask), flush)
    ops, nbytes = measure.paged_bounds(q, kc8, tables, lane, kmax)
    # K and V are int8, exact in bf16 and TF32: only q * s_k and P are
    # split, so the least time is the int8-operand bound (the faster of
    # two TF32 and three bf16 passes); beside it, named, the same
    # operations at 3xTF32 (the float32 cache's engine)
    b = measure.int8_weight_bound(ops, nbytes, card_name)
    b["tf32x3_ms"] = 1e3 * ops / measure.tf32x3_rate(card_name)
    out["prefill_512_hist_256"] = {"ms": ms, "float32_ms": f32,
                                   "plain_ms": plain, "library_ms": lib, **b}
    log(f"  paged_prefill_f32 int8 (prefill_i8_kernel), 512 rows after 256 "
        f"cached keys: {ms:.4f} ms (float32 cache {f32:.4f}), plain "
        f"{plain:.4f}, library {lib:.4f}, bound {b['bound_ms']:.5f} "
        f"({b['bound_by']}: {b['bf16x3_ms']:.5f} in three bf16 products, "
        f"{b['tf32x2_ms']:.5f} in two TF32; bytes {b['bytes_ms']:.5f}; "
        f"{b['tf32x3_ms']:.5f} at 3xTF32, {b['fma_ms']:.4f} at the FMA "
        f"rate)  [{card_name}]")
    del flush
    torch.cuda.empty_cache()
    return out


class _Scales:
    """Within the block, every int8 spec calibrates to ``scales`` (one set
    for the card's and the CPU's specs)."""

    def __init__(self, scales):
        self.scales = scales

    def __enter__(self):
        from deeplearning4j_tpu_torch.zoo import gpt
        self.real = gpt.gpt_kv_scales
        gpt.gpt_kv_scales = lambda *a, **kw: self.scales
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch.zoo import gpt
        gpt.gpt_kv_scales = self.real


def phase_int8kv_parity():
    """GPT_TINY with int8 KV through ``PagedGenerativeServer`` (float32 and
    float64 weights) and ``GenerativeServer`` (float32) on the card and on
    the CPU (plain versions), from one set of scales (``gpt_kv_scales`` on
    the CPU), a prefix hit among the prompts: identical greedy tokens, and
    every dispatch's logits within 1e-4 (float32) or 1e-10 (float64) of
    their magnitude (a K/V row written on the card may store one entry
    one step off where float32 puts its quotient on the other side of a
    rounding tie)."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_TINY, build_gpt,
                                              gpt_generative_spec,
                                              gpt_kv_scales, gpt_paged_spec)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, GPT_TINY.vocab_size, 24).astype(np.int32)
    prompts = [shared, np.concatenate([shared, rng.integers(
        0, GPT_TINY.vocab_size, 5)]).astype(np.int32),
        rng.integers(0, GPT_TINY.vocab_size, 9).astype(np.int32)]
    for kind, dtype, tol in (("paged", torch.float32, 1e-4),
                             ("paged", torch.float64, 1e-10),
                             ("dense", torch.float32, 1e-4)):
        res = {}
        for dev in ("cuda", "cpu"):
            sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device=dev)
            for n, a in sd.trainable_params().items():
                sd.set_arr_for_var(n, a.to(dtype))
            if dev == "cuda":
                scales = gpt_kv_scales(build_gpt(
                    GPT_TINY, batch=2, seq_len=8, device="cpu"), GPT_TINY)
            with _Scales(scales):
                if kind == "paged":
                    srv = PagedGenerativeServer(
                        gpt_paged_spec(sd, GPT_TINY, quantize_kv=True),
                        max_slots=2, block_size=8, start=False, device=dev,
                        debug_leaks=True)
                else:
                    srv = GenerativeServer(
                        gpt_generative_spec(sd, GPT_TINY, quantize_kv=True),
                        max_slots=2, start=False, device=dev)
            logits = []
            for attr in ("_prefill_disp", "_decode_disp"):
                real = getattr(srv, attr)

                def recording(*a, _real=real):
                    out = _real(*a)
                    lg = out[3].detach().cpu().double()
                    if "active" in a[3]:
                        lg = lg[np.flatnonzero(a[3]["active"])]
                    logits.append(lg)
                    return out
                setattr(srv, attr, recording)
            before = (pa.INT8_LAUNCHES["paged_decode_attention"],
                      af.INT8_LAUNCHES["paged_prefill_f32"]
                      + pa.INT8_LAUNCHES["paged_attention"])
            hs = [srv.submit(p, max_new_tokens=12) for p in prompts]
            srv.start()
            toks = [h.result(timeout=300) for h in hs]
            srv.shutdown()
            res[dev] = (toks, logits, (
                pa.INT8_LAUNCHES["paged_decode_attention"] - before[0],
                af.INT8_LAUNCHES["paged_prefill_f32"]
                + pa.INT8_LAUNCHES["paged_attention"] - before[1]),
                srv._kc.dtype)
        (tc, lc, nc, dc), (th, lh, _, _) = res["cuda"], res["cpu"]
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(lc, lh))
        routed = nc[0] > 0 and (kind == "dense" or nc[1] > 0) and \
            dc == torch.int8
        log(f"  {str(dtype)[6:]} GPT_TINY int8 KV {kind} serving, card vs "
            f"cpu: tokens identical {tc == th}, {len(lc)} dispatches' logits "
            f"worst {worst:.2e} of their magnitude (tol {tol:g}), int8 "
            f"launches on the card (decode, prefill) {nc}")
        if not (tc == th and worst <= tol and routed):
            raise SystemExit(f"int8 KV {kind} serving in {dtype} on the card "
                             f"disagrees with the CPU")


def _zero_residual_outs(sd, layers):
    """bench.py's self-draft pairing: from layer 1 on, the residual-out
    projections zeroed, so a 1-layer draft computes the target's logits."""
    for i in range(1, layers):
        for part in ("attn/proj", "mlp/proj"):
            for leaf in ("kernel", "bias"):
                n = f"h{i}/{part}/{leaf}"
                sd.set_arr_for_var(n, torch.zeros_like(
                    sd.get_arr_for_var(n)))


def _loadgen(srv, card, label):
    """bench_serving_quant's closed loop (LOADGEN) through ``srv``."""
    from deeplearning4j_tpu_torch.serving.loadgen import \
        GenerativeLoadGenerator
    lg = GenerativeLoadGenerator(srv, seed=LOADGEN["seed"],
                                 prompt_len=LOADGEN["prompt_len"],
                                 new_tokens=LOADGEN["new_tokens"])
    res = lg.run_closed(LOADGEN["n_requests"], LOADGEN["concurrency"])
    r = {"tokens_per_s": res.tokens_per_sec, "n_ok": res.n_ok,
         "tokens": res.tokens_total, "wall_s": res.duration_s,
         "ttft_p50_ms": res.ttft_percentile(50),
         "ttft_p99_ms": res.ttft_percentile(99),
         "intertoken_p50_ms": res.intertoken_percentile(50),
         "intertoken_p99_ms": res.intertoken_percentile(99)}
    log(f"  loadgen {label}: {res.n_ok}/{res.n_issued} ok, "
        f"{res.tokens_total} tokens in {res.duration_s:.3f} s, "
        f"{r['tokens_per_s']:.1f} tokens/s; TTFT p50 {r['ttft_p50_ms']:.2f} "
        f"p99 {r['ttft_p99_ms']:.2f} ms; inter-token p50 "
        f"{r['intertoken_p50_ms']:.2f} p99 {r['intertoken_p99_ms']:.2f} ms"
        f"  [{card}]")
    if res.n_ok != LOADGEN["n_requests"]:
        raise SystemExit(f"loadgen {label}: {res.n_ok} requests ok")
    return r


def phase_int8kv_serving(dev, card):
    """GPT-medium (``build_gpt(GPT_MEDIUM, ..., seed=0)``) served with an
    int8 KV cache and int8 weights: ``gpt_paged_spec(sd, GPT_MEDIUM,
    quantize_weights=True, quantize_kv=True)`` (its calibration timed)
    through ``PagedGenerativeServer(max_slots=8, block_size=16,
    max_seq_len=1024)``, the 32 ``serving_traffic`` requests at temperature
    0 through ``submit`` / ``result()``; the int8 counts set to 0 just
    before and read just after: 16 int8 decode launches a step and 16 int8
    paged prefills a prefill; the pool drains. The dense ``GenerativeServer``
    over the int8 ``gpt_generative_spec`` serves 8 of them, each against
    ``greedy_decode`` of its spec (phase 13's near-tie rule). Then the
    self-draft pairing (layers 1-15's residual-out projections zeroed, a
    1-layer int8-weight int8-KV draft at k = 8): the 32 requests through
    the speculative server, 16 int8 verify launches a round, every request
    equal to the same target's without a draft. Agreement of the int8
    server's tokens with the float32 paged server's on 8 requests
    (reported, not gated); the pool's blocks at one ``kv_hbm_bytes``
    budget, int8 against float32 (at least 1.9x); ``bench_serving_quant``'s
    closed loop (``LOADGEN``) on both at that budget; a profiled decode
    step pass (phase 13's), the int8 prefills of a profiled pass of the 32
    requests (``profile_traffic_prefills``) and a profiled round pass
    (phase 19's) of the int8 servers."""
    import dataclasses
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_MEDIUM, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    cfg = GPT_MEDIUM
    L = cfg.num_layers
    sd = build_gpt(cfg, batch=1, seq_len=8, seed=0)
    t0 = time.perf_counter()
    spec = gpt_paged_spec(sd, cfg, quantize_weights=True, quantize_kv=True)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    log(f"  int8 KV scales calibrated (4 prompts of 32 tokens, the dense "
        f"float32 prefill) in {cal_s:.2f} s  [{card}]")
    dense = gpt_generative_spec(sd, cfg, quantize_weights=True,
                                quantize_kv=True)
    reqs = serving_traffic(cfg.vocab_size)
    out = {"calibration_s": cal_s}
    kw = dict(max_slots=SERVE_SLOTS, block_size=SERVE_BS,
              max_seq_len=SERVE_SEQ)
    srv = PagedGenerativeServer(spec, **kw)
    pa.reset_launches()
    af.reset_launches()
    im.reset_launches()
    got, m = _serve_requests(srv, reqs, card,
                             "int8 KV + int8 weights, 32 requests")
    srv.shutdown()
    g = srv.metrics.to_record()["generative"]
    n8 = {"decode": pa.INT8_LAUNCHES["paged_decode_attention"],
          "prefill": af.INT8_LAUNCHES["paged_prefill_f32"]}
    want = {"decode": L * g["decode_steps"], "prefill": L * g["prefills"]}
    log(f"  int8 launches {n8} over {g['decode_steps']} steps and "
        f"{g['prefills']} prefills; want {want}; slab {srv._kc.dtype}, "
        f"{srv.kv_slab_bytes / 2**20:.1f} MiB")
    if n8 != want or srv._kc.dtype != torch.int8:
        raise SystemExit("the int8 server did not run the int8 kernels")
    _check_drained(srv)
    out["paged"] = {**m, "launches": n8}
    # the dense int8 server against greedy_decode of its spec
    dsrv = GenerativeServer(dense, max_slots=SERVE_SLOTS,
                            max_seq_len=SERVE_SEQ)
    before = pa.INT8_LAUNCHES["paged_decode_attention"]
    dgot, dm = _serve_requests(dsrv, reqs[:8], card,
                               "dense int8 KV server, 8 requests")
    dsrv.shutdown()
    dn = pa.INT8_LAUNCHES["paged_decode_attention"] - before
    same, ties = check_against_greedy(dense, reqs[:8], dgot, dev)
    log(f"  dense int8 against greedy_decode of its spec: {same} of 8 "
        f"identical, near ties {ties}; int8 decode launches {dn}")
    if dn < L:
        raise SystemExit("the dense int8 server did not run the int8 decode")
    out["dense"] = {**dm, "identical": same, "near_ties": len(ties)}
    # against the float32 paged server (lossy: reported)
    f32 = gpt_paged_spec(sd, cfg)
    fsrv = PagedGenerativeServer(f32, **kw)
    fgot = [fsrv.submit(p, max_new_tokens=n).result(timeout=900)
            for p, n in reqs[:8]]
    fsrv.shutdown()
    agree = float(np.mean([a == b for x, y in zip(got[:8], fgot)
                           for a, b in zip(x, y)]))
    log(f"  int8 KV + int8 weights against float32, 8 requests: token "
        f"agreement {agree:.4f}; paged int8 against dense int8: "
        f"{sum(a == b for a, b in zip(got[:8], dgot))} of 8 identical "
        f"(the dense prefill attends over fresh float32 K/V)")
    out["agreement_vs_float32"] = agree
    out["profile"] = profile_serving(spec, reqs, card, m["step_p50_ms"], L)
    out["prefill_profile"] = profile_traffic_prefills(spec, reqs, card, L)
    # the pool at one byte budget, and bench_serving_quant's closed loop
    budget = INT8KV_BUDGET_BLOCKS * 2 * int(np.prod(
        f32.kv_shape(1, SERVE_BS))) * 4
    lw = dict(max_slots=SERVE_SLOTS, block_size=SERVE_BS,
              max_seq_len=LOADGEN["max_seq_len"], kv_hbm_bytes=budget)
    pools = {}
    for name, sp in (("int8", spec), ("float32", f32)):
        s = PagedGenerativeServer(sp, **lw)
        pools[name] = s.metrics.to_record()["paged"]["num_blocks"]
        s.submit(np.arange(1, 9, dtype=np.int32), 4).result(timeout=300)
        out[f"loadgen_{name}"] = _loadgen(s, card, name)
        s.shutdown()
        _check_drained(s)
    ratio = pools["int8"] / pools["float32"]
    log(f"  pool at {budget} bytes: int8 {pools['int8']} blocks, float32 "
        f"{pools['float32']}: {ratio:.3f}x (bar 1.9x)")
    if ratio < 1.9:
        raise SystemExit(f"int8 pool only {ratio:.3f}x the float32 blocks")
    out["pool_blocks"] = {**pools, "ratio": ratio, "budget_bytes": budget}
    del fsrv, dsrv, f32
    # the speculative int8 server against the same target with no draft
    _zero_residual_outs(sd, L)
    sspec = gpt_paged_spec(sd, cfg, quantize_weights=True, quantize_kv=True)
    draft = gpt_generative_spec(sd, dataclasses.replace(cfg, num_layers=1),
                                quantize_weights=True, quantize_kv=True)
    ysrv = PagedGenerativeServer(sspec, **kw)
    ygot, ym = _serve_requests(ysrv, reqs, card,
                               "int8 KV target, no draft, 32 requests")
    ysrv.shutdown()
    ssrv = PagedGenerativeServer(sspec, draft_spec=draft,
                                 speculate_k=SPEC_K, **kw)
    pa.reset_launches()
    sgot, sm = _serve_requests(ssrv, reqs, card,
                               f"int8 KV speculative (k={SPEC_K}), "
                               f"32 requests")
    ssrv.shutdown()
    sg = ssrv.metrics.to_record()["generative"]
    nv = pa.INT8_LAUNCHES["paged_verify_attention"]
    equal = sum(a == b for a, b in zip(sgot, ygot))
    log(f"  speculative int8 KV: {sg['spec_rounds']} rounds, acceptance "
        f"{sg['draft_acceptance_rate']:.4f}, int8 verify launches {nv} "
        f"(want {L * sg['spec_rounds']}); tokens equal to the no-draft "
        f"server's on {equal} of {len(reqs)}; tokens/s "
        f"{sm['tokens_per_s'] / ym['tokens_per_s']:.3f}x the no-draft "
        f"server's")
    if nv != L * sg["spec_rounds"] or sg["spec_rounds"] < 1 or \
            equal != len(reqs):
        raise SystemExit("speculative int8 KV serving differs from the "
                         "same target without a draft")
    _check_drained(ssrv)
    out["spec"] = {**sm, "verify_launches": nv, "equal": equal,
                   "spec_rounds": sg["spec_rounds"],
                   "acceptance": sg["draft_acceptance_rate"]}
    out["plain_no_draft"] = ym
    out["launches"] = {"paged_decode_attention_int8": n8["decode"],
                       "paged_prefill_f32_int8": n8["prefill"],
                       "paged_verify_attention_int8": nv}
    out["spec_profile"] = profile_spec_rounds(sspec, draft, reqs, card)
    del sd, spec, dense, sspec, draft, srv, ysrv, ssrv
    torch.cuda.empty_cache()
    return out


def profile_traffic_prefills(spec, reqs, card, layers):
    """The 32 ``serving_traffic`` requests once more through a fresh int8-KV
    ``PagedGenerativeServer`` under torch.profiler, after one unprofiled
    request: the int8 paged prefill kernel's (``prefill_i8_kernel``) and
    its combining kernel's device time and launches over the run's
    prefills, each count traced against the wrapper's (a trace holding
    fewer launches than the wrapper counted is taken once more), beside
    the run's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    for attempt in range(2):
        srv = PagedGenerativeServer(spec, max_slots=SERVE_SLOTS,
                                    block_size=SERVE_BS,
                                    max_seq_len=SERVE_SEQ)
        srv.submit(np.arange(1, 9, dtype=np.int32), 2).result(timeout=300)
        torch.cuda.synchronize()
        b_main = af.INT8_LAUNCHES["paged_prefill_f32"]
        b_comb = af.LAUNCHES["attention_f32_combine"]
        p0 = srv.metrics.to_record()["generative"]["prefills"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _serve_requests(srv, reqs, card, "int8 KV server under the "
                            "profiler")
            torch.cuda.synchronize()
        prefills = srv.metrics.to_record()["generative"]["prefills"] - p0
        srv.shutdown()
        counted = {"main": af.INT8_LAUNCHES["paged_prefill_f32"] - b_main,
                   "combine": af.LAUNCHES["attention_f32_combine"] - b_comb}
        traced = {"main": 0, "combine": 0}
        ms = {"main": 0.0, "combine": 0.0}
        total = 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            dt = e.time_range.elapsed_us() / 1e3
            total += dt
            key = ("main" if "prefill_i8_kernel" in e.name else "combine"
                   if "attn_f32_combine" in e.name else None)
            if key:
                traced[key] += 1
                ms[key] += dt
        if traced == counted or attempt:
            break
    log(f"  profiler, the {len(reqs)} requests' {prefills} int8 paged "
        f"prefills: prefill_i8_kernel {ms['main']:.4f} ms over "
        f"{traced['main']} launches ({ms['main'] / max(traced['main'], 1):.5f}"
        f" a launch), its combining kernel {ms['combine']:.4f} ms over "
        f"{traced['combine']}; the wrapper counted {counted}; the run's "
        f"device time {total:.2f} ms  [{card}]")
    if traced != counted or traced["main"] != layers * prefills:
        raise SystemExit(f"int8 prefills: traced {traced}, the wrapper "
                         f"counted {counted}, want {layers * prefills} "
                         f"main launches")
    return {"prefills": prefills, "launches": traced["main"],
            "combine_launches": traced["combine"], "ms": ms["main"],
            "combine_ms": ms["combine"], "device_ms": total}


def int8kv_kernel_records(t, serve, errs):
    """The int8 variants' JSON records: the decode per decode step (16
    launches at context 512), the verify per round (16 at context 512),
    the prefill per 512-row prefill after 256 cached keys (16 layers);
    ``launches`` the main path's (phase 24's) counts."""
    prof = serve["profile"]["by_group_ms"]
    recs = []
    for name, key, per, in_step in (
            ("paged_decode_attention_int8", "decode_512",
             "GPT-medium decode step, 8 lanes at context 512",
             prof.get("paged attention")),
            ("paged_verify_attention_int8", "verify_512",
             "speculative round's verify, 8 lanes x W 8 at context 512",
             serve["spec_profile"]["by_group_ms"].get("verify attention")),
            ("paged_prefill_f32_int8", "prefill_512_hist_256",
             "GPT-medium prefill of 512 rows after 256 cached keys",
             serve["prefill_profile"])):
        c = t[key]
        source, replaces = INT8KV_KERNELS[name]
        recs.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve["launches"][name],
            "launches_per_step": 16, "max_abs_err": errs[name],
            "ms": 16 * c["ms"], "plain_ms": 16 * c["plain_ms"],
            "bound_ms": 16 * c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": 16 * c["library_ms"],
            "library": "dequantise the gathered context, then masked "
                       "F.scaled_dot_product_attention",
            "float32_cache_ms": 16 * c["float32_ms"], "ms_per": per,
            # the prefill's: a traffic prefill's device time (16 launches
            # and their combines), from phase 24's profiled run
            "in_step_ms": (in_step if not isinstance(in_step, dict) else
                           (in_step["ms"] + in_step["combine_ms"])
                           / max(in_step["prefills"], 1)),
            **({"traffic_prefills": in_step}
               if isinstance(in_step, dict) else {}),
            "per_call": {k: v for k, v in t.items()
                         if k.startswith(key.split("_")[0])}})
    return recs


# ----------------------------------------------------------------------
# phase 25: ResNet-50 served through ParallelInference
PI_BUCKETS = (4, 8, 16, 32)
PI_TOL = 1e-4           # served vs output(), softmax probabilities
PI_POOL = 64            # distinct seeded images the requests slice
PI_REQUESTS = 512


def _top1_gate(got, want, label):
    """Top-1 of every served row equals ``output()``'s, except where
    ``output()``'s own two best classes lie within 2 x PI_TOL (counted)."""
    s = np.sort(want, axis=1)
    decided = s[:, -1] - s[:, -2] > 2 * PI_TOL
    same = got.argmax(1) == want.argmax(1)
    if not np.all(same[decided]):
        raise SystemExit(f"{label}: top-1 differs from output() on "
                         f"{int((~same & decided).sum())} rows")
    return int((~decided).sum())


def _served_vs_direct(outs, direct, label, card):
    errs = [float(np.abs(o - d).max()) for o, d in zip(outs, direct)]
    ties = sum(_top1_gate(o, d, label) for o, d in zip(outs, direct))
    worst = max(errs)
    log(f"  {label}: {len(outs)} requests, {sum(len(d) for d in direct)} "
        f"images: worst |served - output()| {worst:.3e} (tol {PI_TOL:g}), "
        f"top-1 equal ({ties} near-ties exempt)  [{card}]")
    if not worst <= PI_TOL:
        raise SystemExit(f"{label}: served outputs {worst:.3e} from "
                         f"output(), tolerance {PI_TOL:g}")
    return worst


def _pi_delta(pi, before):
    c = pi.metrics.counters
    d = {k: c[k] - before.get(k, 0) for k in c}
    d["mean_batch_rows"] = (d["rows_served"] / d["batches_dispatched"]
                            if d["batches_dispatched"] else 0.0)
    d["padding_waste"] = (d["rows_padded"] / (d["rows_served"]
                                              + d["rows_padded"])
                          if d["rows_served"] else 0.0)
    return d


def _log_load(label, res, d, card):
    images = d["rows_served"]
    log(f"  {label}: {res.n_ok}/{res.n_issued} ok ({res.n_rejected} "
        f"rejected, {res.n_timed_out} timed out, {res.n_failed} failed) in "
        f"{res.duration_s:.3f} s: {images / res.duration_s:.1f} images/s, "
        f"{res.throughput_rps:.1f} requests/s; latency p50 "
        f"{res.percentile(50):.2f} ms, p99 {res.percentile(99):.2f} ms; "
        f"{d['batches_dispatched']} batches, mean {d['mean_batch_rows']:.2f} "
        f"rows, padding waste {d['padding_waste']:.4f}; compiles "
        f"{d['compiles']}  [{card}]")
    if res.n_ok != res.n_issued:
        raise SystemExit(f"{label}: {res.n_issued - res.n_ok} requests not "
                         f"served")


def _profiled(fn):
    """``fn()`` under torch.profiler: (its wall ms, device busy ms as the
    union of device intervals, device activities, kernels, ms by name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    n_act, n_kernels, busy, by_name = device_activity(prof)
    if busy == 0:
        raise SystemExit("the profiler recorded no device time")
    return wall, busy, n_act, n_kernels, by_name


def phase_parallel_inference(card):
    """ResNet-50 (224x224x3, 1000 classes, float32, random weights from
    the zoo's seed, batch-norm running statistics set from one seeded
    batch) served through ``ParallelInference(ResNet50().build())`` on the
    card, TF32 off (cuDNN's float32 convolutions):

    1. gates: SEQUENTIAL, INPLACE and BATCHED (2 workers, max_batch_size
       32, buckets 4-32) serve 24 seeded requests of 1-4 images, each
       within PI_TOL of ``output()`` with the same top-1; on a server with
       the one bucket 32, requests served alone and co-batched give
       bit-equal rows, a NaN request is quarantined
       (``PoisonedRequestError``) while its co-batched neighbours are
       served their solo rows, and injected exec failures open the
       breaker, which sheds and then closes;
    2. warmup of the four buckets (seconds), then ``compiles == 0`` over
       all the traffic;
    3. ``LoadGenerator`` (requests of 1-4 images, uniform, seed 0,
       max_delay_ms 2): ``run_closed(512, concurrency=8)``, then
       ``run_open(512)`` at half its requests/s;
    4. torch.profiler over 20 BATCHED execs at bucket 32 (20 requests of
       32 images submitted at once): device ms and launches an exec, top
       kernels, the idle share of that pass (wall against busy); each
       bucket's device ms per exec over 20 direct execs; the bucket-32
       exec against its FMA-rate bound (``card_rates``: float32 outside
       the tensor cores, 67 TFLOP/s on an H100 SXM), and with
       TF32 allowed, for comparison."""
    from deeplearning4j_tpu_torch.zoo import ResNet50
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off: torch.backends.cudnn.allow_tf32 = False")
    try:
        t0 = time.perf_counter()
        net = ResNet50().build()             # the card: no device= given
        n_params = net.num_params()
        log(f"  ResNet50(): {n_params} parameters on {net.device}, built in "
            f"{time.perf_counter() - t0:.1f} s")
        if net.device.type != "cuda" or n_params < 25_000_000:
            raise SystemExit(f"ResNet50() built {n_params} parameters on "
                             f"{net.device}")
        serve_resnet(net, 224, PI_REQUESTS, card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def serve_resnet(net, hw, n_requests, card):
    """Phase 25's gates, warmup, traffic and profiled execs over ``net``
    (a ResNet-50 at ``hw`` x ``hw``) on its device."""
    from deeplearning4j_tpu_torch.serving import (InferenceMode,
                                                  LoadGenerator,
                                                  ParallelInference)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pool = rng.uniform(size=(PI_POOL, 3, hw, hw)).astype(np.float32)
    set_running_stats(net, pool[:32])
    log(f"  running statistics from 32 seeded images, {PI_POOL} seeded "
        f"images to serve, in {time.perf_counter() - t0:.1f} s")

    def request(rng_, i=None):
        rows = int(rng_.integers(1, 5))
        s = int(rng_.integers(0, PI_POOL - rows + 1))
        return pool[s:s + rows]

    reqs = [request(rng) for _ in range(24)]
    direct = [net.output(x)[0].cpu().numpy() for x in reqs]
    spread = max(float(np.abs(d[0] - direct[0][0]).max()) for d in direct)
    log(f"  output(): the requests' first rows differ by up to {spread:.3e} "
        f"(the outputs depend on the input; tolerance {PI_TOL:g})")
    if spread < 100 * PI_TOL:
        raise SystemExit(f"outputs barely depend on the input ({spread:.3e})")

    # 1. gates
    for mode in ("SEQUENTIAL", "INPLACE"):
        with ParallelInference(net, mode=getattr(InferenceMode, mode),
                               workers=2) as pi:
            if pi.device != net.device:
                raise SystemExit(f"{mode} server on {pi.device}, the "
                                 f"network on {net.device}")
            futs = [pi.submit(x) for x in reqs]
            outs = [f.result(timeout=300) for f in futs]
        _served_vs_direct(outs, direct, mode, card)
    t0 = time.perf_counter()
    pi = ParallelInference(net, mode=InferenceMode.BATCHED, workers=2,
                           max_batch_size=32, max_delay_ms=2.0,
                           max_queue_len=512, warmup_buckets=True)
    build_s = time.perf_counter() - t0
    rep = pi.warmup_report
    log(f"  BATCHED server (2 workers, max_batch_size 32, buckets "
        f"{pi._batcher.spec.buckets}, max_delay_ms 2.0) built in "
        f"{build_s:.2f} s, of which the warmup of buckets {rep['buckets']}: "
        f"{rep['seconds']:.3f} s; warmup_compiles "
        f"{pi.metrics.counters['warmup_compiles']}  [{card}]")
    try:
        if tuple(pi._batcher.spec.buckets) != PI_BUCKETS:
            raise SystemExit(f"buckets {pi._batcher.spec.buckets}")
        futs = [pi.submit(x) for x in reqs]
        outs = [f.result(timeout=300) for f in futs]
        _served_vs_direct(outs, direct, "BATCHED", card)
        _phase25_rail(net, reqs, card)

        # 3. traffic
        lg = LoadGenerator(pi, request, seed=0)
        before = dict(pi.metrics.counters)
        res = lg.run_closed(n_requests, concurrency=8)
        closed = _pi_delta(pi, before)
        _log_load(f"closed loop ({n_requests} requests, concurrency 8)",
                  res, closed, card)
        rate = res.throughput_rps / 2
        before = dict(pi.metrics.counters)
        res_open = lg.run_open(n_requests, rate_rps=rate)
        _log_load(f"open loop ({n_requests} requests at {rate:.1f} "
                  f"requests/s)", res_open, _pi_delta(pi, before), card)
        if pi.metrics.counters["compiles"] != 0:
            raise SystemExit(f"{pi.metrics.counters['compiles']} shapes "
                             f"first seen under traffic after warmup")
        log(f"  compiles after warmup: 0 over "
            f"{pi.metrics.counters['requests_served']} requests")

        # 4. profiled execs
        _phase25_profile(net, pi, pool, card)
    finally:
        pi.shutdown()


def _phase25_rail(net, reqs, card):
    """Bit-equality, quarantine and the breaker, on a server with the one
    bucket 32 (every exec at one shape)."""
    from deeplearning4j_tpu_torch.serving import (InferenceMode,
                                                  ParallelInference,
                                                  PoisonedRequestError,
                                                  ResilienceConfig,
                                                  ServerOverloadedError,
                                                  ServingError)
    cfg = ResilienceConfig(breaker_failure_threshold=3, breaker_reset_s=0.5,
                           single_retries=0, admission=False)
    with ParallelInference(net, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=32, buckets=(32,),
                           max_delay_ms=500.0, resilience=cfg) as rp:
        trio = reqs[:3]
        solo = [rp.output(x) for x in trio]
        n0 = rp.metrics.counters["batches_dispatched"]
        futs = [rp.submit(x) for x in trio]
        together = [f.result(timeout=300) for f in futs]
        n1 = rp.metrics.counters["batches_dispatched"]
        bit = all(np.array_equal(a, b) for a, b in zip(solo, together))
        log(f"  alone vs co-batched at bucket 32: {len(trio)} requests in "
            f"{n1 - n0} batch, rows bit-equal {bit}  [{card}]")
        if not bit or n1 - n0 != 1:
            raise SystemExit("co-batched rows differ from solo rows")
        futs = [rp.submit(x) for x in trio]
        poison = rp.submit(np.full_like(trio[0], np.nan))
        try:
            poison.result(timeout=300)
            raise SystemExit("the NaN request was served")
        except PoisonedRequestError:
            pass
        healthy = all(np.array_equal(f.result(timeout=300), s)
                      for f, s in zip(futs, solo))
        c = rp.metrics.counters
        log(f"  NaN request quarantined (PoisonedRequestError); "
            f"bisect_splits {c['bisect_splits']}, co-batched healthy rows "
            f"equal their solo rows {healthy}; breaker "
            f"{rp.breaker.state}  [{card}]")
        if not healthy or c["bisect_splits"] < 1 or \
                rp.breaker.state != "closed":
            raise SystemExit("poisoned-batch isolation failed")
        orig = rp._execute
        left = {"n": 3}

        def failing(features, real_rows=None):
            if left["n"] > 0:
                left["n"] -= 1
                raise RuntimeError("injected exec failure")
            return orig(features, real_rows=real_rows)
        rp._execute = failing
        typed = 0
        for _ in range(3):
            try:
                rp.submit(trio[0]).result(timeout=300)
            except ServingError:
                typed += 1
        opened = rp.breaker.state
        try:
            rp.submit(trio[0])
            raise SystemExit("the open breaker admitted a request")
        except ServerOverloadedError as e:
            hint = e.retry_after_s
        t0 = time.perf_counter()
        while rp.breaker.reject_for() is not None and \
                time.perf_counter() - t0 < 10:
            time.sleep(0.01)
        healed = rp.submit(trio[0]).result(timeout=300)
        t1 = time.perf_counter()
        while rp.breaker.state != "closed" and time.perf_counter() - t1 < 10:
            time.sleep(0.01)
        log(f"  3 injected exec failures: {typed} typed errors, breaker "
            f"{opened} (breaker_opens {rp.metrics.counters['breaker_opens']}"
            f"), a submit shed with retry_after_s {hint}, then the probe "
            f"served and the breaker {rp.breaker.state}  [{card}]")
        if typed != 3 or opened != "open" or rp.breaker.state != "closed" \
                or not np.array_equal(healed, solo[0]):
            raise SystemExit("the circuit breaker did not open and close")


def _phase25_profile(net, pi, pool, card):
    """20 BATCHED execs at bucket 32 under the profiler; 20 direct execs at
    each bucket; the bucket-32 exec against its bound."""
    futs = []

    def twenty():
        futs.extend(pi.submit(pool[i:i + 32]) for i in range(20))
        for f in futs:
            f.result(timeout=300)
    before = dict(pi.metrics.counters)
    wall, busy, n_act, n_kernels, by_name = _profiled(twenty)
    d = _pi_delta(pi, before)
    if d["batches_dispatched"] != 20 or d["rows_padded"]:
        raise SystemExit(f"the profiled pass ran {d['batches_dispatched']} "
                         f"batches, {d['rows_padded']} padding rows")
    per = busy / 20
    log(f"  profiler, 20 BATCHED execs at bucket 32 (20 requests of 32 "
        f"images at once, 2 workers): device busy {per:.3f} ms an exec, "
        f"wall {wall / 20:.3f} ms an exec: idle share "
        f"{1 - busy / wall:.3f} (the same pass); {n_act / 20:.1f} device "
        f"activities an exec, {n_kernels / 20:.1f} kernels  [{card}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms / 20:8.3f} ms  {name[:100]}")
    hbm, fp32 = card_rates(torch.cuda.get_device_name(0))
    macs = forward_macs(net, pool.shape[-1])
    flop = 2 * (macs["conv"] + macs["dense"])
    params = sum(t.numel() * t.element_size()
                 for t in net.model.state_dict().values())
    classes = net.output(pool[:1])[0].shape[1]
    moved = params + pool[:32].nbytes + 32 * classes * 4
    ops_ms = 32 * flop / fp32 * 1e3
    bytes_ms = moved / hbm * 1e3
    bound = max(ops_ms, bytes_ms)
    log(f"  bound at bucket 32: {flop / 1e9:.3f} GFLOP an image (conv "
        f"{2 * macs['conv'] / 1e9:.3f}, dense {2 * macs['dense'] / 1e9:.4f};"
        f" from the code's shapes) x 32 at {fp32 / 1e12:g} TFLOP/s float32 "
        f"= {ops_ms:.3f} ms; {moved / 1e6:.1f} MB (parameters and "
        f"statistics {params / 1e6:.1f}, input, output) at {hbm / 1e12:g} "
        f"TB/s = "
        f"{bytes_ms:.3f} ms: bound {bound:.3f} ms by "
        f"{'operations' if ops_ms >= bytes_ms else 'bytes'}; the exec's "
        f"device time {per:.3f} ms = {bound / per:.3f} of it, "
        f"{32 * flop / per / 1e9:.1f} TFLOP/s  [{card}]")
    for b in PI_BUCKETS:
        x = np.ascontiguousarray(pool[:b])
        wall, busy, n_act, n_kernels, _ = _profiled(
            lambda: [pi._execute([x], real_rows=b) for _ in range(20)])
        log(f"    bucket {b:2d}: device {busy / 20:.3f} ms an exec, wall "
            f"{wall / 20:.3f} ms (direct execs, one thread), "
            f"{n_kernels / 20:.1f} kernels; {b * 1000 / (busy / 20):.1f} "
            f"images/s of device time  [{card}]")
    x = np.ascontiguousarray(pool[:32])
    for allow in (True, False):
        torch.backends.cudnn.allow_tf32 = allow
        pi._execute([x], real_rows=32)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(20):
            pi._execute([x], real_rows=32)
        end.record()
        torch.cuda.synchronize()
        log(f"    bucket 32, cudnn.allow_tf32={allow}: "
            f"{start.elapsed_time(end) / 20:.3f} ms an exec (CUDA events "
            f"around 20 direct execs)  [{card}]")
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
#: phase 26: one epoch of seeded batches, checkpoints every P26_EVERY
#: iterations, windows of P26_K, accum_steps P26_ACCUM; the batch
#: poisoned in run B and the NaN gradients of run D
P26_STEPS, P26_EVERY, P26_K, P26_ACCUM = 24, 8, 4, 2
P26_POISON, P26_NAN = 13, 5


class StepSource:
    """Phase 26's data: seeded batches on the card, keyed by the model's
    absolute iteration. A pass runs from ``iteration_count`` to the end of
    its epoch, so a fit retried after a rollback resumes where its
    checkpoint stopped (the contract of the JAX package's seekable
    pipeline, which the port does not have yet). The batches lie on the
    card: ``RetryingIterator`` scans host batches and would quarantine a
    poisoned one before the sentinel could see it."""

    def __init__(self, batches, tc):
        self.batches, self.tc = batches, tc

    def __iter__(self):
        n = len(self.batches)
        for i in range(self.tc.iteration_count % n, n):
            yield self.batches[i]


def _p26_net(dev):
    """The main path's ResNet-50 (224x224x3, 1000 classes, bf16
    MixedPrecision) with ImageNet's usual recipe: Nesterovs at 0.1 warmed
    up over 8 updates and cut tenfold at 16 (``RampSchedule(StepSchedule)``),
    L2 1e-4."""
    from deeplearning4j_tpu_torch.autodiff import MixedPrecision
    from deeplearning4j_tpu_torch.learning import (L2Regularization,
                                                   Nesterovs, RampSchedule,
                                                   StepSchedule)
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    conf = ResNet50(height=224, width=224, channels=3, num_classes=1000,
                    updater=Nesterovs(learning_rate=RampSchedule(
                        base=StepSchedule(initial_value=0.1, decay_rate=0.1,
                                          step=16), num_iter=8),
                        momentum=0.9)).conf()
    conf.mixed_precision = MixedPrecision()
    conf.regularization = [L2Regularization(l2=1e-4)]
    net = ComputationGraph(conf).init(dev)
    tc = net.training_config
    tc.fused_steps, tc.accum_steps, tc.sentinel = P26_K, P26_ACCUM, True
    return net


def _p26_batches(dev):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(P26_STEPS):
        x = rng.standard_normal((BATCH, 3, 224, 224), dtype=np.float32)
        y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)]
        out.append((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
    return out


def _states_differ(a, b):
    """(tensors that differ, their largest |a - b|) between two
    TrainingStates' arrays and updater leaves; (0, 0.0) is bit-equal."""
    pairs = [(a.arrays[k], b.arrays.get(k)) for k in a.arrays] + \
        list(zip(a.updater_leaves or [], b.updater_leaves or []))
    n, worst = 0, 0.0
    for x, y in pairs:
        if y is None or x.shape != y.shape:
            n, worst = n + 1, math.inf
        elif not np.array_equal(x, y):
            n += 1
            worst = max(worst, float(np.nanmax(np.abs(
                x.astype(np.float64) - y))))
    if set(a.arrays) != set(b.arrays) or a.iteration != b.iteration or \
            len(a.updater_leaves or []) != len(b.updater_leaves or []):
        n, worst = n + 1, math.inf
    return n, worst


def _p26_abc(dev, card, batches, tmp, tag):
    """Runs A (uninterrupted, with checkpoints), B (self-healing) and C
    (resumed by a new network) from one start; returns their figures and
    the network of A and B."""
    import shutil
    from deeplearning4j_tpu_torch.checkpoint import (CheckpointListener,
                                                     CheckpointManager,
                                                     capture_training_state)
    from deeplearning4j_tpu_torch.faults import (ChaosMonkey,
                                                 FaultTolerantFit,
                                                 RetryPolicy)
    from deeplearning4j_tpu_torch.kernels import bn_relu
    out = {}
    net = _p26_net(dev)
    tc = net.training_config
    init = capture_training_state(net)          # the start, on the host
    t0 = time.perf_counter()
    net.fit(StepSource(batches[:P26_K], tc), listeners=[_quiet_listener()])
    torch.cuda.synchronize()
    st = dict(net.last_fit_stats)
    net.restore_training_state(init)
    log(f"  warm-up: one window of {P26_K} (accum {P26_ACCUM}, phase 0) "
        f"captured in {time.perf_counter() - t0:.1f} s ({st}); the start "
        f"restored in place")
    if st["window_captures"] != 1 or net.captures_total != 1:
        raise SystemExit(f"the warm-up captured {st}")

    # A: uninterrupted, a checkpoint every P26_EVERY iterations
    mgr_a = CheckpointManager(os.path.join(tmp, f"{tag}_a"), keep_last_n=3)
    lis = CheckpointListener(mgr_a, every_n_iterations=P26_EVERY)
    torch.cuda.synchronize()
    bn_relu.reset_launches()
    t0 = time.perf_counter()
    hist = net.fit(StepSource(batches, tc), listeners=[lis])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bn_relu.LAUNCHES)
    mgr_a.wait_until_finished()
    st = dict(net.last_fit_stats)
    a_final = capture_training_state(net)
    recs = list(mgr_a.records)
    disk = {r["step"]: sum(os.path.getsize(os.path.join(
        mgr_a.step_dir(r["step"]), f)) for f in os.listdir(
        mgr_a.step_dir(r["step"]))) for r in recs[-1:]}
    want = {bn_relu.kernel_name(p, r): (33 if r else 20) * P26_STEPS
            for p in (1, 2) for r in (True, False)}
    out.update(a_step_ms=1000 * wall / P26_STEPS,
               capture_ms=[1000 * s for s in lis.capture_seconds],
               commit_s=[r["commit_seconds"] for r in recs],
               bytes=[r["bytes"] for r in recs], disk=disk,
               captures=net.captures_total, launches=launches)
    log(f"  A: {P26_STEPS} steps ({st['tier']}, windows {st['window_sizes']},"
        f" {st['window_captures']} captured, accum {st['accum_steps']}, "
        f"sentinel {st['sentinel']}) in {wall:.3f} s: "
        f"{out['a_step_ms']:.2f} ms a step with the checkpoints, loss "
        f"{hist.step_losses[0]:.4f} -> {hist.step_losses[-1]:.4f}; "
        f"checkpoints {mgr_a.all_steps()}: capture (device to host) ms "
        f"{[round(v, 2) for v in out['capture_ms']]}, commit s "
        f"{[round(v, 3) for v in out['commit_s']]}, bytes {out['bytes']} "
        f"({disk} on disk); windows captured in all {net.captures_total}  "
        f"[{card}]")
    log(f"  A's BN backward launches {launches}")
    if launches != want or not np.all(np.isfinite(hist.step_losses)) or \
            st["window_captures"] != 0 or \
            mgr_a.all_steps() != [8, 16, 24]:
        raise SystemExit(f"run A: launches {launches} (want {want}), "
                         f"{st}, checkpoints {mgr_a.all_steps()}")
    keep_c = os.path.join(tmp, f"{tag}_c")
    shutil.copytree(mgr_a.step_dir(16), os.path.join(
        keep_c, os.path.basename(mgr_a.step_dir(16))))
    mgr_a.close()

    # B: the same start, a batch poisoned at P26_POISON, FaultTolerantFit
    net.restore_training_state(init)
    mgr_b = CheckpointManager(os.path.join(tmp, f"{tag}_b"), keep_last_n=3)
    it = ChaosMonkey(seed=0).poison_batches(StepSource(batches, tc),
                                            at_step=P26_POISON)
    ftf = FaultTolerantFit(net, mgr_b, policy=RetryPolicy(backoff_base=0),
                           checkpoint_every_n_iterations=P26_EVERY)
    before = net.captures_total
    t0 = time.perf_counter()
    ftf.fit(it, epochs=1)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    mgr_b.close()
    events = [e["event"] for e in ftf.events]
    fault = next(e for e in ftf.events if e["event"] == "fault")
    rollback = next(e for e in ftf.events if e["event"] == "rollback")
    b_final = capture_training_state(net)
    out.update(b_diff=_states_differ(a_final, b_final),
               rollback_s=rollback["overhead_s"],
               b_recaptures=net.captures_total - before, b_wall=b_wall)
    log(f"  B: FaultTolerantFit over a batch poisoned at step {P26_POISON}: "
        f"events {events}; the sentinel named step {fault['step']} (epoch "
        f"{fault['epoch']}, batch {fault['batch_index']}), rolled back to "
        f"step {rollback['restored_step']} in {rollback['overhead_s']:.3f} "
        f"s, windows captured after it {out['b_recaptures']}; {b_wall:.2f} s "
        f"in all; against A: {out['b_diff'][0]} tensors differ (largest "
        f"{out['b_diff'][1]:.3g})  [{card}]")
    if events != ["fault", "rollback", "retry", "recovered"] or \
            fault["step"] != P26_POISON or \
            rollback["restored_step"] != 8 or out["b_recaptures"] != 0 or \
            tc.iteration_count != P26_STEPS:
        raise SystemExit(f"run B: events {ftf.events}")

    # C: a new network resumes from A's step-16 checkpoint
    net_c = _p26_net(dev)
    step, _ = CheckpointManager(keep_c).restore_latest(model=net_c)
    t0 = time.perf_counter()
    net_c.fit(StepSource(batches, net_c.training_config))
    torch.cuda.synchronize()
    c_final = capture_training_state(net_c)
    out["c_diff"] = _states_differ(a_final, c_final)
    log(f"  C: a new network restored (restore_latest) at step {step}, "
        f"{P26_STEPS - step} steps in {time.perf_counter() - t0:.1f} s "
        f"(its window's capture included); against A: {out['c_diff'][0]} "
        f"tensors differ (largest {out['c_diff'][1]:.3g})")
    if step != 16 or net_c.training_config.iteration_count != P26_STEPS:
        raise SystemExit(f"run C resumed at {step}")
    del net_c
    torch.cuda.empty_cache()
    out.update(net=net, init=init)
    return out


def _p26_timed(net, init, batches, opts):
    """One epoch from the start with run A's options (``"A"``) or with
    neither the sentinel nor the regularization (``"plain"``): ms a
    step, no checkpoint."""
    from deeplearning4j_tpu_torch.learning import L2Regularization
    tc = net.training_config
    tc.sentinel = opts == "A"
    tc.regularization = [L2Regularization(l2=1e-4)] if opts == "A" else []
    net.restore_training_state(init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = net.fit(StepSource(batches, tc))
    torch.cuda.synchronize()
    if not np.all(np.isfinite(h.step_losses)):
        raise SystemExit(f"{opts}: non-finite losses")
    return 1000 * (time.perf_counter() - t0) / P26_STEPS


def _p26_f64_parity():
    """Phase 4's ResNet-50 (32x32, 4 classes, batch 8) in float64, TF32
    off, with L2, WeightDecay, clip_l2_global, a RampSchedule(StepSchedule)
    and accum_steps 2, over 4 iterations from the same weights: the
    card's fused tier (windows of 2 over a DeviceCachedIterator) against
    the CPU's one step a batch (a list of batches; accumulation makes it
    windows of 1). Every trained tensor's change, running statistic and
    loss to 1e-6 (phase 4's bound)."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.learning import (L2Regularization,
                                                   Nesterovs, RampSchedule,
                                                   StepSchedule, WeightDecay)
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    b = 8
    x = rng.normal(size=(4 * b, 3, 32, 32))
    y = np.eye(4)[rng.integers(0, 4, 4 * b)]
    weights = ResNet50(height=32, width=32, num_classes=4).build(
        device="cpu").model.state_dict()

    def run(dev):
        conf = ResNet50(height=32, width=32, num_classes=4,
                        updater=Nesterovs(learning_rate=RampSchedule(
                            base=StepSchedule(initial_value=0.1,
                                              decay_rate=0.1, step=1),
                            num_iter=2), momentum=0.9)).conf()
        conf.dtype = "float64"
        conf.regularization = [L2Regularization(l2=1e-4),
                               WeightDecay(coeff=1e-4)]
        net = ComputationGraph(conf).init(device=dev)
        net.model.load_state_dict(weights)
        tc = net.training_config
        tc.gradient_normalization = "clip_l2_global"
        tc.gradient_normalization_threshold = 1.0
        init = net.params()
        data = DeviceCachedIterator(x, y, batch_size=b, device=dev) \
            if dev == "cuda" else [(x[i:i + b], y[i:i + b])
                                   for i in range(0, len(x), b)]
        hist = net.fit(data, fused_steps=2 if dev == "cuda" else 1,
                       accum_steps=2)
        return init, net.params(), hist.step_losses, \
            dict(net.last_fit_stats)

    try:
        (i0, pc, lc, sc), (_, ph, lh, sh) = run("cuda"), run("cpu")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    stats = [k for k in pc if k.endswith(("_mean", "_var"))]
    trained = [k for k in pc if k not in stats
               and not (k.endswith("_b") and k != "output_b")]
    change = _max_rel({k: pc[k] - i0[k] for k in trained},
                      {k: ph[k] - i0[k] for k in trained})
    stat = _max_rel({k: pc[k] for k in stats}, {k: ph[k] for k in stats})
    loss = max(abs(c - h) / abs(h) for c, h in zip(lc, lh))
    worst = max(max(change.values()), max(stat.values()), loss)
    log(f"  float64 32x32 with L2, WeightDecay, clip_l2_global, "
        f"RampSchedule(StepSchedule), accum 2, 4 iterations: card "
        f"{sc['tier']} (windows {sc['window_sizes']}, "
        f"{sc['graph_replays_per_epoch']} replays) against CPU {sh['tier']} "
        f"(windows {sh['window_sizes']}): worst change "
        f"{max(change.values()):.2e} ({max(change, key=change.get)}), "
        f"statistic {max(stat.values()):.2e}, loss {loss:.2e} (tol 1e-6)")
    if sc["graph_replays_per_epoch"] != 2 or worst > 1e-6:
        raise SystemExit("the card's float64 training options disagree "
                         "with the CPU")
    return worst


def phase_train_options(dev, card):
    """ResNet-50 trained as users train it (phase 26): runs A, B, C
    (bit-equal, else cuDNN deterministic and said), D, the sentinel's
    and regularization's cost, a profiled pass with A's options, and the
    float64 parity."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.faults import (ChaosMonkey,
                                                 TrainingDivergedError)
    det0 = torch.backends.cudnn.deterministic
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p26_")
    try:
        t0 = time.perf_counter()
        batches = _p26_batches(dev)
        nbytes = sum(x.numel() * 4 + y.numel() * 4 for x, y in batches)
        log(f"  {P26_STEPS} seeded batches of {BATCH} on the card "
            f"({nbytes / 1e9:.2f} GB float32) in "
            f"{time.perf_counter() - t0:.1f} s; checkpoints under {tmp}")
        res = _p26_abc(dev, card, batches, tmp, "run")
        if res["b_diff"][0] or res["c_diff"][0]:
            del res["net"]
            torch.cuda.empty_cache()
            torch.backends.cudnn.deterministic = True
            log("  B or C is not bit-equal to A: cuDNN's chosen algorithms "
                "are not deterministic; A, B and C again with "
                "torch.backends.cudnn.deterministic")
            res = _p26_abc(dev, card, batches, tmp, "det")
            if res["b_diff"][0] or res["c_diff"][0]:
                raise SystemExit("runs B and C are not bit-equal to A")
        log(f"  B and C bit-equal to A (cuDNN deterministic="
            f"{torch.backends.cudnn.deterministic})")
        net, init = res["net"], res["init"]

        # the sentinel's and the regularization's cost
        _p26_timed(net, init, batches, "plain")          # its capture
        ms = {"A": [], "plain": []}
        for opts in ("A", "plain", "plain", "A", "A", "plain"):
            ms[opts].append(_p26_timed(net, init, batches, opts))
        log(f"  step ms, windows of {P26_K}, accum {P26_ACCUM}, no "
            f"checkpoint: A's options (sentinel, L2) "
            f"{[round(v, 2) for v in ms['A']]}, neither "
            f"{[round(v, 2) for v in ms['plain']]}: median "
            f"{np.median(ms['A']) / np.median(ms['plain']):.4f}x  [{card}]")
        log("  profiled pass with A's options (8 steps, two replays):")
        tc = net.training_config
        _p26_timed(net, init, batches[:8], "A")
        net.restore_training_state(init)
        # one pass from the restored start, no warm-up fit: an untraced fit
        # in the profiler's warm-up cycle would move the training state
        # (schedule, accumulation, checkpoint cadence) past that start
        prof = profile_fit(lambda: net.fit(StepSource(batches[:8], tc)), 8,
                           min(ms["A"]), card, warmup=False)

        # D: NaN gradients at P26_NAN inside a captured window
        net.restore_training_state(init)
        with ChaosMonkey(seed=0).nan_gradients(net, at_step=P26_NAN):
            try:
                net.fit(StepSource(batches[:8], tc))
                raise SystemExit("run D: no TrainingDivergedError")
            except TrainingDivergedError as e:
                err = e
        graphs = [w.graph is not None for w in net._windows.values()]
        log(f"  D: NaN gradients armed at step {P26_NAN}: "
            f"TrainingDivergedError step {err.step}, epoch {err.epoch}, "
            f"batch {err.batch_index}: {str(err).split(';')[0]}; windows "
            f"{len(graphs)}, all graphs {all(graphs)}")
        if (err.step, err.epoch, err.batch_index) != (P26_NAN, 0, P26_NAN) \
                or not all(graphs):
            raise SystemExit("run D named another step")
        del net, res
        torch.cuda.empty_cache()
        worst = _p26_f64_parity()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic = det0
    return {"ms": ms, "profile": prof, "f64_worst": worst}



# ----------------------------------------------------------------------
# phase 27: TextGenLSTM trained with fit and fit_tbptt
#: DL4J's ``CharacterIterator.getMinimalCharacterSet()``: the 77
#: characters of the zoo's TextGenLSTM (a-z, A-Z, 0-9, punctuation, space,
#: newline, tab)
CHARSET = ("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
           "0123456789" "!&()?-'\",.:; \n\t")
#: ``LSTMCharModellingExample``'s traffic: minibatch 32, sequences of 1000
#: characters, TBPTT length 50; 64 sequences drawn, two TBPTT epochs
P27_BATCH, P27_SEQ, P27_TBPTT, P27_SEQS, P27_EPOCHS = 32, 1000, 50, 64, 2
P27_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm_recurrence.cu"
P27_REPLACES = "deeplearning4j_tpu/ops/nn_ops.py:520"
P27_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
P27_KERNELS = ("lstm_recurrence_fwd", "lstm_recurrence_bwd")
#: the recurrence's launches a TBPTT chunk, each kernel: one a layer
P27_PER_CHUNK = 2
#: kernel names no profiled pass of the path may hold: the first design's
#: cell kernels, PyTorch's fused LSTM cell and cuDNN's RNN kernels
P27_FOREIGN = ("lstm_cell_fwd_kernel", "lstm_cell_bwd_kernel",
               "lstm_cell_forward", "lstm_cell_backward", "RNN_",
               "LSTM_elementWise", "elemWiseRNN")
#: (B, T, U) the kernels are held to their plain versions at: the path's,
#: ragged units and rows, one step, 3 groups of 8 units a block (float64:
#: streamed), and widths past the resident slice (the streamed form)
P27_CASES = ((P27_BATCH, P27_TBPTT, 256), (3, 7, 37), (3, 1, 5),
             (8, 20, 300), (8, 20, 512), (4, 3, 4096))


def p27_corpus():
    """The repo's SURVEY.md mapped into CHARSET (other characters
    dropped), and ``P27_SEQS`` sequences of ``P27_SEQ + 1`` characters at
    seeded offsets, as DL4J's ``CharacterIterator`` draws example starts:
    one-hot features (the first P27_SEQ characters) and labels (the next
    ones), float32 numpy."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "SURVEY.md"), encoding="utf-8") as f:
        text = f.read()
    index = {c: i for i, c in enumerate(CHARSET)}
    ids = np.array([index[c] for c in text if c in index], np.int64)
    starts = np.random.default_rng(0).integers(0, len(ids) - P27_SEQ - 1,
                                               P27_SEQS)
    seqs = np.stack([ids[s:s + P27_SEQ + 1] for s in starts])
    eye = np.eye(len(CHARSET), dtype=np.float32)
    return eye[seqs[:, :-1]], eye[seqs[:, 1:]], len(text), len(ids)


def _p27_close(got, want, dtype):
    """Worst |got - want| over the largest |want| (a relative error)."""
    err = float((got.double().cpu() - want.double().cpu()).abs().max())
    return err, err <= P27_TOL[dtype] * max(float(want.abs().max()), 1e-30)


def p27_check_kernels(dev):
    """Each recurrence kernel against its plain version on the card on
    the same inputs, forward and backward (the backward from the plain
    forward's gates and cs, with d_hs, dh_T and dc_T), at
    :data:`P27_CASES`, float32 and float64; then each again, bit-equal:
    worst relative error a kernel; raises on a miss."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.kernels.measure import lstm_recurrence_case
    errs = {k: 0.0 for k in P27_KERNELS}
    for dt in (torch.float32, torch.float64):
        for b, t, u in P27_CASES:
            gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
                b, t, u, dt, dev, seed=b * t + u)
            want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
            got_f = lstm.lstm_recurrence_fwd(gx.clone(), w, h0, c0)
            bwd_in = (want_f[0], want_f[2], c0, w, d_hs, dh_t, dc_t)
            want_b = lstm.lstm_recurrence_bwd_plain(*bwd_in)
            got_b = lstm.lstm_recurrence_bwd(*bwd_in)
            torch.cuda.synchronize()
            for name, gots, wants in (("lstm_recurrence_fwd", got_f, want_f),
                                      ("lstm_recurrence_bwd", got_b, want_b)):
                for got, want in zip(gots, wants):
                    err, ok = _p27_close(got, want, dt)
                    errs[name] = max(errs[name], err)
                    if not ok:
                        raise SystemExit(f"{name} {dt} (B, T, U) = ({b}, {t},"
                                         f" {u}): error {err:.3e} against its"
                                         f" plain version")
            again_f = lstm.lstm_recurrence_fwd(gx.clone(), w, h0, c0)
            again_b = lstm.lstm_recurrence_bwd(*bwd_in)
            if not all(torch.equal(x, y) for x, y in
                       zip(again_f + again_b, got_f + got_b)):
                raise SystemExit(f"the recurrence kernels {dt} ({b}, {t}, "
                                 f"{u}): two calls differ")
            plan = lstm._card_plan(dev.index or 0, dt, b, u)
            log(f"  {dt} (B, T, U) = ({b}, {t}, {u}): forward and backward "
                f"within {P27_TOL[dt]:g} of the largest magnitude, two calls "
                f"bit-equal; plan R {plan.ranks} ({plan.units} units a "
                f"block), {plan.b_tile} rows a cluster, {plan.clusters} "
                f"clusters (the card holds {plan.max_clusters}), slice "
                f"{'resident' if plan.resident else 'streamed from L2'}, "
                f"{plan.smem_fwd} / {plan.smem_bwd} bytes a block")
    return errs


def _p27_net(dev, **kw):
    from deeplearning4j_tpu_torch.zoo import TextGenLSTM
    return TextGenLSTM(seed=0, **kw).build(device=dev)


def p27_f64_parity(X, Y):
    """Gate (ii): a narrow float64 TextGenLSTM (2 layers of 16), 4 TBPTT
    chunks of 10 characters of 4 sequences, on the card and on the CPU
    from the same seed: the worst parameter change, carried state and
    loss, each relative to its largest magnitude, within 1e-6."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import TextGenLSTM
    conf = TextGenLSTM(units=16, seed=0).conf()
    conf.dtype = "float64"
    x = torch.tensor(X[:4, :40], dtype=torch.float64)
    y = torch.tensor(Y[:4, :40], dtype=torch.float64)
    res = {}
    for d in ("cuda", "cpu"):
        net = MultiLayerNetwork(conf).init(device=d)
        p0 = {n: torch.tensor(a) for n, a in net.params().items()}
        h = net.fit_tbptt(x.to(d), y.to(d), 10, epochs=1, batch_size=4)
        sd, states = net._tbptt_graphs[4]
        res[d] = ({n: torch.tensor(a) - p0[n]
                   for n, a in net.params().items()},
                  {n: sd.state_vars_map()[n].cpu() for n in states},
                  torch.tensor(h.step_losses, dtype=torch.float64))
    worst = {}
    for i, what in enumerate(("parameter change", "carried state")):
        worst[what] = max(
            float((res["cuda"][i][n] - t).abs().max())
            / max(float(t.abs().max()), 1e-30)
            for n, t in res["cpu"][i].items())
    worst["loss"] = float(((res["cuda"][2] - res["cpu"][2]).abs()
                           / res["cpu"][2].abs()).max())
    log(f"  (ii) float64 TextGenLSTM(units=16), 4 TBPTT chunks of 10, card "
        f"vs CPU: worst " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       worst.items()) + " (tol 1e-6)")
    if max(worst.values()) > 1e-6:
        raise SystemExit("phase 27 gate (ii): float64 card against CPU")
    return worst


def _p27_params(net):
    return {n: torch.tensor(a) for n, a in net.params().items()}


def _p27_diff(a, b):
    """(worst relative difference, bit-equal) of two parameter sets."""
    worst = max(float((a[n] - b[n]).abs().max())
                / max(float(b[n].abs().max()), 1e-30) for n in b)
    return worst, all(torch.equal(a[n], b[n]) for n in b)


def p27_full_length(Xb, Yb):
    """Gate (iii): ``fit_tbptt`` with tbptt_length = T equals ``fit`` on
    the card (JAX's test_tbptt_full_length_equals_bptt): 64 sequences of
    50, one epoch, from seed 0; losses and parameters within rtol 1e-5 /
    atol 1e-6."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    a, b = _p27_net("cuda"), _p27_net("cuda")
    x, y = Xb[:P27_SEQS], Yb[:P27_SEQS]
    ha = a.fit(DeviceCachedIterator(x, y, P27_BATCH, device=x.device))
    hb = b.fit_tbptt(x, y, x.shape[1], epochs=1, batch_size=P27_BATCH)
    worst, bits = _p27_diff(_p27_params(b), _p27_params(a))
    ok = np.allclose(hb.step_losses, ha.step_losses, rtol=TIER_RTOL,
                     atol=TIER_ATOL) and all(
        torch.allclose(b_, a_, rtol=TIER_RTOL, atol=TIER_ATOL)
        for b_, a_ in zip(_p27_params(b).values(), _p27_params(a).values()))
    log(f"  (iii) fit_tbptt(tbptt_length={x.shape[1]}) vs fit (scanned "
        f"tier), {len(ha.step_losses)} steps: losses {hb.step_losses} vs "
        f"{ha.step_losses}; worst parameter difference {worst:.3e}, "
        f"bit-equal {bits}")
    if not ok:
        raise SystemExit("phase 27 gate (iii): full-length TBPTT is not "
                         "fit")


def _p27_profile(fn, n_units):
    """One pass of ``fn`` under torch.profiler: (device launches, busy ms,
    wall ms, ms by kernel name), each a unit (a chunk or a step). A first,
    untraced pass of ``fn`` runs in the profiler's warm-up cycle, with the
    device tracing already on: without it the trace lost the first
    replay's first kernels (1 of 4 sentiment steps' forward launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        prof.step()
    n_dev, n_kern, busy, by_name = device_activity(prof)
    from torch.autograd import DeviceType
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not _annotation(e):
            counts[e.name] = counts.get(e.name, 0) + 1
    return {"launches": n_dev / n_units, "kernels": n_kern / n_units,
            "busy_ms": busy / n_units, "wall_ms": wall / n_units,
            "idle_share": 1 - busy / wall if busy else None,
            "by_name": {k: v / n_units for k, v in by_name.items()},
            "counts": counts}


def _p27_kernel_profile(prof, n_units, label):
    """Each cell kernel's device ms a unit and its traced count; raises
    when a kernel is missing or a foreign LSTM kernel ran."""
    out = {}
    for k in P27_KERNELS:
        names = [n for n in prof["counts"] if f"{k}_kernel" in n]
        if not names:
            raise SystemExit(f"phase 27: the {label} pass traced no {k}")
        out[k] = (sum(prof["by_name"][n] for n in names),
                  sum(prof["counts"][n] for n in names) / n_units)
    foreign = [n for n in prof["counts"] if any(f in n for f in P27_FOREIGN)]
    if foreign:
        raise SystemExit(f"phase 27: the {label} pass ran {foreign}")
    return out


def p27_tbptt(X, Y, card):
    """Run (a): ``fit_tbptt`` over the 64 sequences, 2 epochs (gates (v)
    and (vii), the counts set to 0 just before and read just after), then
    timed epochs and a profiled one; then the Evaluation accuracy."""
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    from deeplearning4j_tpu_torch.kernels import _cuda, lstm
    net = _p27_net("cuda")
    log(f"  TextGenLSTM(): {net.num_params()} parameters, float32, "
        f"Adam(1e-3), seed 0")
    if net.num_params() != 887117:
        raise SystemExit("TextGenLSTM is not the zoo's width")
    chunks = (P27_SEQS // P27_BATCH) * (P27_SEQ // P27_TBPTT)
    lstm.reset_launches()
    before = _cuda.count_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit_tbptt(X, Y, P27_TBPTT, epochs=P27_EPOCHS,
                         batch_size=P27_BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(lstm.LAUNCHES)
    others = [(k, n) for c, k, n in _cuda.counts_since(before)
              if c is not lstm.LAUNCHES]
    sd, states = net._tbptt_graphs[P27_BATCH]
    st = dict(sd.last_fit_stats)
    per_chunk = P27_PER_CHUNK          # 2 layers, a launch each
    # + the capture's 2 warm-up steps; a CPU rehearsal launches nothing
    want = (P27_EPOCHS * chunks + 2) * per_chunk if X.is_cuda else 0
    log(f"  (a) fit_tbptt, {P27_EPOCHS} epochs of {chunks} chunks "
        f"({P27_SEQS // P27_BATCH} minibatches x {st['chunks_per_minibatch']}"
        f" chunks of {P27_TBPTT}): {first_s:.2f} s with the capture; epoch "
        f"losses {hist.epoch_losses}; stats {st}; launches {launches} "
        f"(want {want} each: {per_chunk} a chunk and {per_chunk} in the "
        f"capture's 2 warm-up steps); other kernels' counts {others}")
    if not hist.epoch_losses[1] < hist.epoch_losses[0]:
        raise SystemExit("phase 27 gate (v): the loss did not fall")
    if st["window_captures_by_epoch"] != [1, 0] or \
            st["graph_replays_per_epoch"] != (P27_SEQS // P27_BATCH
                                              if X.is_cuda else 0):
        raise SystemExit("phase 27 gate (vii): a capture after the first "
                         "window")
    if any(launches[k] != want for k in P27_KERNELS) or others:
        raise SystemExit("phase 27: the recurrence kernels' launches")
    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit_tbptt(X, Y, P27_TBPTT, epochs=1, batch_size=P27_BATCH)
        torch.cuda.synchronize()
        timed.append(1e3 * (time.perf_counter() - t0) / chunks)
    # a pass that traced other than P27_PER_CHUNK launches a chunk of a
    # kernel (the profiler lost records) is taken once more; a second short
    # pass stands flagged in the record (its in-chunk times are short)
    for attempt in range(2):
        prof = _p27_profile(lambda: net.fit_tbptt(
            X, Y, P27_TBPTT, epochs=1, batch_size=P27_BATCH), chunks)
        in_chunk = _p27_kernel_profile(prof, chunks, "TBPTT")
        complete = all(abs(v[1] - P27_PER_CHUNK) < 1e-9
                       for v in in_chunk.values())
        if complete:
            break
        log(f"  FLAG: profiled pass {attempt + 1} traced "
            + ", ".join(f"{k} {v[1]:.3f}" for k, v in in_chunk.items())
            + f" launches a chunk, not {P27_PER_CHUNK}: lost records"
            + ("; taking it once more" if attempt == 0 else
               "; its in-chunk times leave the lost launches out"))
    if sd.last_fit_stats["window_captures"]:
        raise SystemExit("phase 27 gate (vii): a capture in a later fit")
    ms = float(np.median(timed))
    chars = P27_BATCH * P27_TBPTT
    log(f"  (a) a TBPTT chunk ({P27_BATCH} x {P27_TBPTT} characters, one "
        f"replay a minibatch of {P27_SEQ // P27_TBPTT}): "
        f"{[round(v, 4) for v in timed]} ms, median {ms:.4f} ms, "
        f"{1e3 * chars / ms:.1f} characters/s; launches a chunk "
        f"{per_chunk} + {per_chunk} (counted); profiler: "
        f"{prof['launches']:.1f} device launches a chunk, busy "
        f"{prof['busy_ms']:.4f} of {prof['wall_ms']:.4f} ms, idle share "
        f"{prof['idle_share']:.3f}; recurrence kernels in the chunk "
        + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:.1f} traced)"
                    for k, v in in_chunk.items()) + f"  [{card}]")
    top = sorted(((v, n) for n, v in prof["by_name"].items()),
                 reverse=True)[:8]
    log("    device time a chunk by kernel, the 8 largest:")
    for v, n in top:
        log(f"      {v:8.4f} ms  {n[:110]}")
    out = net.output(X)
    if tuple(out.shape) != tuple(X.shape) or not torch.isfinite(out).all():
        raise SystemExit("phase 27: TextGenLSTM's output")
    ev = Evaluation()
    ev.eval(Y.reshape(-1, len(CHARSET)), out.reshape(-1, len(CHARSET)))
    try:
        net.evaluate(X[:P27_BATCH], Y[:P27_BATCH])
        raise SystemExit("evaluate took (B, T, C) outputs")
    except ValueError as e:
        refused = str(e)
    log(f"  Evaluation of the trained network, next character over "
        f"{out.shape[0] * out.shape[1]} positions (outputs flattened to "
        f"(N, 77)): accuracy {ev.accuracy():.4f}, F1 {ev.f1():.4f}; "
        f"net.evaluate on (B, T, C) refuses as the JAX one: {refused}")
    return {"net": net, "launches": launches, "chunk_ms": ms,
            "timed": timed, "profile": prof, "in_chunk": in_chunk,
            "in_chunk_complete": complete, "accuracy": ev.accuracy(),
            "chunks": chunks}


def p27_tiers(Xb, Yb, card):
    """Run (b): ``fit`` (full BPTT) over sequences of 50 on the scanned,
    windowed (8) and per-step tiers from seed 0: gate (iv), the tiers
    agree over one epoch; then each timed (median of 3 epochs) and
    profiled (one epoch)."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    it = DeviceCachedIterator(Xb, Yb, P27_BATCH, device=Xb.device)
    steps = len(Xb) // P27_BATCH
    res, nets = {}, {}
    for tier, listeners, k in _tiers():
        net = _p27_net("cuda")
        h = net.fit(it, listeners=listeners, fused_steps=k)
        nets[tier] = net
        res[tier] = {"losses": h.step_losses, "params": _p27_params(net),
                     "stats": dict(net.samediff.last_fit_stats)}
    ref = res["per-step"]
    for tier in ("scanned", "windows"):
        worst, bits = _p27_diff(res[tier]["params"], ref["params"])
        ok = np.allclose(res[tier]["losses"], ref["losses"], rtol=TIER_RTOL,
                         atol=TIER_ATOL) and all(torch.allclose(
                             res[tier]["params"][n], t, rtol=TIER_RTOL,
                             atol=TIER_ATOL) for n, t in ref["params"].items())
        log(f"  (iv) {tier} vs per-step over {steps} steps: worst parameter "
            f"difference {worst:.3e}, losses bit-equal "
            f"{res[tier]['losses'] == ref['losses']}, parameters bit-equal "
            f"{bits}")
        if not ok:
            raise SystemExit(f"phase 27 gate (iv): the {tier} tier")
    out = {}
    chars = P27_BATCH * Xb.shape[1]
    for tier, listeners, k in _tiers():
        net = nets[tier]
        timed = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(it, listeners=listeners, fused_steps=k)
            torch.cuda.synchronize()
            timed.append(1e3 * (time.perf_counter() - t0) / steps)
        st = dict(net.samediff.last_fit_stats)
        prof = _p27_profile(lambda: net.fit(it, listeners=listeners,
                                            fused_steps=k), steps)
        _p27_kernel_profile(prof, steps, tier)
        ms = float(np.median(timed))
        out[tier] = {"step_ms": ms, "timed": timed, "profile": prof}
        log(f"  (b) fit, {tier:<8} ({st['tier']}): a step of {P27_BATCH} x "
            f"{Xb.shape[1]} characters {[round(v, 4) for v in timed]} ms, "
            f"median {ms:.4f} ms, {1e3 * chars / ms:.1f} characters/s; "
            f"graph replays an epoch {st['graph_replays_per_epoch']}, "
            f"captures {st['window_captures']}; profiler: "
            f"{prof['launches']:.1f} device launches a step, busy "
            f"{prof['busy_ms']:.4f} of {prof['wall_ms']:.4f} ms, idle share "
            f"{prof['idle_share']:.3f}  [{card}]")
    return nets["per-step"], out


def p27_save_load(net, Xb, Yb, X, Y):
    """Gate (vi): ``save`` -> ``load`` gives a bit-equal ``output``, and
    the loaded and the saved network then take ``fit`` (restored Adam
    state and iteration) and ``fit_tbptt`` (a new TBPTT graph each, as in
    JAX) to bit-equal parameters."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p27_")
    try:
        path = os.path.join(tmp, "textgen.zip")
        t0 = time.perf_counter()
        net.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        other = MultiLayerNetwork.load(path, device=Xb.device)
        load_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x = Xb[:P27_BATCH]
    same_out = torch.equal(net.output(x), other.output(x))
    it = DeviceCachedIterator(Xb[:4 * P27_BATCH], Yb[:4 * P27_BATCH],
                              P27_BATCH, device=Xb.device)
    for n in (net, other):
        n.fit(it)
    _, fit_bits = _p27_diff(_p27_params(other), _p27_params(net))
    for n in (net, other):
        n.fit_tbptt(X[:P27_BATCH, :4 * P27_TBPTT],
                    Y[:P27_BATCH, :4 * P27_TBPTT], P27_TBPTT, epochs=1,
                    batch_size=P27_BATCH)
    worst, tbptt_bits = _p27_diff(_p27_params(other), _p27_params(net))
    log(f"  (vi) save {save_s:.3f} s ({nbytes} bytes), load {load_s:.3f} s: "
        f"output bit-equal {same_out}; then fit (4 steps) bit-equal "
        f"{fit_bits}, then fit_tbptt (4 chunks) bit-equal {tbptt_bits} "
        f"(worst {worst:.3e})")
    if not (same_out and fit_bits and tbptt_bits):
        raise SystemExit("phase 27 gate (vi): save/load")


def p27_timing(card, card_name, run):
    """Each recurrence kernel alone (``median_ms``, L2 cold) over one
    layer's TBPTT chunk (B 32, T 50, U 256, float32) beside its plain
    version (host clock, ``synced_ms``: it launches 600-1200 kernels a
    call), its bound (``measure.lstm_recurrence_cost`` at the card's
    rates) and its time a step; then one layer (the port's
    ``lstm_layer``: the hoisted GEMM, the kernels and the weight GEMMs)
    against cuDNN's ``torch.nn.LSTM`` (TF32 off; never called by the
    port) in device time (``queued_ms``: CUDA events around each call,
    queued behind a device sleep): forward, backward (``retain_graph``)
    and both.
    A chunk is two layers, so a chunk's kernel times are twice a call's."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.kernels.measure import (
        lstm_recurrence_case, lstm_recurrence_cost, two_rate_bound)
    from deeplearning4j_tpu_torch.ops import registry
    dev, b, t, u = torch.device("cuda"), P27_BATCH, P27_TBPTT, 256
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
        b, t, u, torch.float32, dev)
    gates, hs, cs = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    buf = gx.clone()      # the kernel writes the gates over it: no copy timed
    bwd_in = (gates, cs, c0, w, d_hs, dh_t, dc_t)
    calls = {
        "lstm_recurrence_fwd": (
            lambda: lstm.lstm_recurrence_fwd(buf, w, h0, c0),
            lambda: lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)),
        "lstm_recurrence_bwd": (
            lambda: lstm.lstm_recurrence_bwd(*bwd_in),
            lambda: lstm.lstm_recurrence_bwd_plain(*bwd_in))}
    snap = dict(lstm.LAUNCHES)
    # the plain versions launch 600-1200 kernels a call: host clock
    per_call = {k: {"ms": median_ms(kern, flush),
                    "plain": synced_ms(plain, flush)}
                for k, (kern, plain) in calls.items()}
    # one layer over a chunk: the port's and cuDNN's, device time
    x = torch.randn(b, t, u, device=dev, requires_grad=True)
    ref = torch.nn.LSTM(u, u, batch_first=True).to(dev)
    w_ih = ref.weight_ih_l0.detach().t().contiguous().requires_grad_(True)
    w_hh = ref.weight_hh_l0.detach().t().contiguous().requires_grad_(True)
    bias = (ref.bias_ih_l0 + ref.bias_hh_l0).detach().requires_grad_(True)
    zero = torch.zeros(b, u, device=dev)
    op = registry.get_op("lstm_layer").fn
    port_in = [x, w_ih, w_hh, bias]
    cudnn_in = [x] + list(ref.parameters())
    g_out = torch.randn(b, t, u, device=dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # float32 as the port's
    try:
        with torch.no_grad():
            want = ref(x)[0]
            got = op(x, zero, zero, w_ih, w_hh, bias)[0]
        err = float((got - want).abs().max())
        o_port = op(x, zero, zero, w_ih, w_hh, bias)[0]
        o_cudnn = ref(x)[0]
        layer = {
            "port_fwd_ms": queued_ms(
                lambda: op(x, zero, zero, w_ih, w_hh, bias), flush),
            "port_bwd_ms": queued_ms(lambda: torch.autograd.grad(
                o_port, port_in, g_out, retain_graph=True), flush),
            "port_ms": queued_ms(lambda: torch.autograd.grad(
                op(x, zero, zero, w_ih, w_hh, bias)[0], port_in, g_out),
                flush),
            "cudnn_fwd_ms": queued_ms(lambda: ref(x), flush),
            "cudnn_bwd_ms": queued_ms(lambda: torch.autograd.grad(
                o_cudnn, cudnn_in, g_out, retain_graph=True), flush),
            "cudnn_ms": queued_ms(lambda: torch.autograd.grad(
                ref(x)[0], cudnn_in, g_out), flush),
            "max_abs": err}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    lstm.LAUNCHES.update(snap)            # timing launches do not count
    lib_dir = {"lstm_recurrence_fwd": layer["cudnn_fwd_ms"],
               "lstm_recurrence_bwd": layer["cudnn_bwd_ms"]}
    out = {}
    for k, pc in per_call.items():
        ops, nbytes = lstm_recurrence_cost(b, t, u, 4)[k]
        bound = two_rate_bound(ops, nbytes, card_name)
        in_chunk, traced = run["in_chunk"][k]
        n = P27_PER_CHUNK
        out[k] = {
            "ms": n * pc["ms"], "plain_ms": n * pc["plain"],
            "library_ms": n * lib_dir[k], "bound_ms": n * bound["bound_ms"],
            "bound_by": bound["bound_by"], "in_chunk_ms": in_chunk,
            "traced_per_chunk": traced,
            "per_call": {"ms": pc["ms"], "plain_ms": pc["plain"],
                         "library_ms": lib_dir[k],
                         "bound_ms": bound["bound_ms"], "bytes": nbytes,
                         "ops": ops, "us_per_step": 1e3 * pc["ms"] / t,
                         "in_chunk_us_per_step": 1e3 * in_chunk / (n * t)}}
        log(f"  {k} over one layer's chunk (B {b}, T {t}, U {u}) float32, a "
            f"call: alone {pc['ms']:.5f} ms ({1e3 * pc['ms'] / t:.3f} us a "
            f"step), plain {pc['plain']:.5f} (host clock), library "
            f"{lib_dir[k]:.5f} "
            f"(cuDNN nn.LSTM's {'forward' if k.endswith('fwd') else 'backward'}"
            f" of the layer, x @ W_ih and the weight gradients in it), bound "
            f"{bound['bound_ms']:.6f} ({bound['bound_by']}: {nbytes} bytes, "
            f"{ops} operations; bytes {bound['bytes_ms']:.6f}, 3xTF32 "
            f"{bound['tf32x3_ms']:.6f}); a chunk ({n} calls): alone "
            f"{out[k]['ms']:.4f} ms, in the chunk {in_chunk:.4f} ms "
            f"({traced:.1f} traced, "
            f"{out[k]['per_call']['in_chunk_us_per_step']:.3f} us a step), "
            f"plain {out[k]['plain_ms']:.4f}, library "
            f"{out[k]['library_ms']:.4f}, bound {out[k]['bound_ms']:.5f}  "
            f"[{card}]")
    log(f"  one LSTM layer (256 units) over a chunk ({b} x {t}), device "
        f"time: the port forward {layer['port_fwd_ms']:.4f} ms, backward "
        f"{layer['port_bwd_ms']:.4f}, both {layer['port_ms']:.4f}; cuDNN "
        f"nn.LSTM (TF32 off) forward {layer['cudnn_fwd_ms']:.4f}, backward "
        f"{layer['cudnn_bwd_ms']:.4f}, both {layer['cudnn_ms']:.4f}; "
        f"outputs agree to {err:.2e}  [{card}]")
    if err > 1e-4:
        raise SystemExit("phase 27: the port's LSTM layer against cuDNN's")
    return out, layer


def phase_textgen(dev, card, card_name):
    """Phase 27: gates (i)-(vii) and the measurements; returns the two
    kernels' JSON records."""
    log("  (i) the recurrence kernels against their plain versions:")
    errs = p27_check_kernels(dev)
    t0 = time.perf_counter()
    Xn, Yn, n_text, n_ids = p27_corpus()
    X, Y = torch.tensor(Xn, device=dev), torch.tensor(Yn, device=dev)
    log(f"  corpus: SURVEY.md, {n_text} characters, {n_ids} in the 77-"
        f"character set; {P27_SEQS} sequences of {P27_SEQ + 1} at seeded "
        f"offsets: features {tuple(X.shape)} float32 "
        f"({X.numel() * 4 / 1e6:.1f} MB) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    worst = p27_f64_parity(Xn, Yn)
    Xb = X.reshape(-1, P27_TBPTT, len(CHARSET))
    Yb = Y.reshape(-1, P27_TBPTT, len(CHARSET))
    p27_full_length(Xb, Yb)
    run = p27_tbptt(X, Y, card)
    del run["net"]
    net, tiers = p27_tiers(Xb, Yb, card)
    p27_save_load(net, Xb, Yb, X, Y)
    del net
    torch.cuda.empty_cache()
    timing, layer = p27_timing(card, card_name, run)
    records = []
    for k in P27_KERNELS:
        t = timing[k]
        records.append({
            "name": k, "route": "cuda", "source": P27_SOURCE,
            "replaces": P27_REPLACES, "launches": run["launches"][k],
            "launches_per_step": P27_PER_CHUNK,
            "max_abs_err": errs[k],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": f"cuDNN nn.LSTM's whole-layer "
                       f"{'forward' if k.endswith('fwd') else 'backward'} "
                       f"(TF32 off), x @ W_ih and the weight gradients in "
                       f"it, which the kernel leaves to GEMMs",
            "ms_per": f"TextGenLSTM TBPTT chunk ({P27_BATCH} x {P27_TBPTT}, "
                      f"2 layers of 256)",
            "in_step_ms": t["in_chunk_ms"],
            "in_step_traced_per_chunk": t["traced_per_chunk"],
            "in_step_complete": run["in_chunk_complete"],
            "per_call": t["per_call"], "layer": layer})
    return records, {"f64_worst": worst, "chunk_ms": run["chunk_ms"],
                     "tiers": {k: v["step_ms"] for k, v in tiers.items()}}

# ----------------------------------------------------------------------
# phase 28: the zoo's convolutional models
P28_SOURCE = "deeplearning4j_tpu_torch/csrc/dropout.cu"
P28_REPLACES = "deeplearning4j_tpu/ops/random.py:104"
P28_KERNELS = ("dropout_fwd", "dropout_bwd")
#: YOLO2 at the zoo's defaults (416x416, 20 VOC classes, 5 anchors, Adam)
P28_YOLO_BATCH, P28_YOLO_STEPS = 16, 8
#: AlexNet at the zoo's defaults (224x224, 1000 classes, Nesterovs)
P28_ALEX_BATCH, P28_ALEX_STEPS = 128, 8
#: the inputs of AlexNet's two 4096-unit dense layers, which it drops
P28_ALEX_DROP = ((P28_ALEX_BATCH, 6400), (P28_ALEX_BATCH, 4096))
P28_P = 0.5
#: every other ported model at its published input size, batch 8, and its
#: parameter count (tests/test_torch_zoo_published.py holds this table to
#: the port's build at these sizes and, for YOLO2 and AlexNet, to the JAX
#: networks'; the model tests hold each count at small sizes to JAX's)
P28_PARAMS = {"YOLO2": 50655389, "AlexNet": 50844008, "SimpleCNN": 395658,
              "VGG16": 138357544, "VGG19": 143667240,
              "Darknet19": 21843376, "TinyYOLO": 15861773,
              "SqueezeNet": 2236496, "UNet": 116753, "Xception": 17912960,
              "InceptionResNetV1": 22756328, "FaceNet": 21321832,
              "NASNet": 1773456}
#: each model's output shape at its published size, less the batch axis
#: (``tests/test_torch_zoo_published.py`` holds the port's CPU builds to
#: it)
P28_OUTPUT = {"SimpleCNN": (10,), "VGG16": (1000,), "VGG19": (1000,),
              "Darknet19": (1000,), "TinyYOLO": (125, 13, 13),
              "SqueezeNet": (1000,), "UNet": (1, 64, 64),
              "Xception": (1000,), "InceptionResNetV1": (1000,),
              "FaceNet": (1000,), "NASNet": (1000,)}
P28_OTHERS = ("SimpleCNN", "VGG16", "VGG19", "Darknet19", "TinyYOLO",
              "SqueezeNet", "UNet", "Xception", "InceptionResNetV1",
              "FaceNet", "NASNet")
#: device-time groups of a profiled YOLO2 / AlexNet step, by kernel name
P28_GROUPS = (
    ("BN kernels", ("bn_bwd_phase", "bn_relu_bwd_phase")),
    ("dropout kernel", ("dropout_kernel",)),
    ("Adam / Nesterovs (_foreach)", ("multi_tensor_apply",)),
    ("cuDNN convolutions / GEMMs", ("conv", "cudnn", "nvjet", "gemm", "xmma",
                                   "cutlass", "sm90_", "wgrad", "dgrad",
                                   "implicit", "winograd", "fft")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "Functor", "vectorized", "unrolled")),
)
#: the streamed recurrence kernels' shapes (widths past the resident
#: slice): (B, T, U) float32
P28_STREAM_SHAPES = ((32, 50, 512), (32, 50, 1024))


def _p28_group(name):
    return next((g for g, keys in P28_GROUPS
                 if any(k in name for k in keys)), "other")


def _p28_profile(fit, steps, card, label):
    """One pass of ``fit()`` under torch.profiler: device launches a
    step, busy ms a step (the union of device events), the pass's own
    wall a step and the idle share, device time by group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        traced_ms = 1000 * (time.perf_counter() - t0) / steps
    n_dev, n_kern, busy, by_name = device_activity(prof)
    if busy == 0:
        raise SystemExit(f"{label}: the profiler recorded no device time")
    groups = {}
    for name, ms in by_name.items():
        g = _p28_group(name)
        groups[g] = groups.get(g, 0.0) + ms / steps
    busy /= steps
    log(f"    {label}, profiled pass: {n_kern / steps:.1f} device launches "
        f"a step ({n_dev / steps:.1f} device events), busy {busy:.3f} ms of "
        f"the pass's own {traced_ms:.3f} ms a step: idle share "
        f"{1 - busy / traced_ms:.3f}  [{card}]")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"      {ms:9.4f} ms a step  {g}")
    return {"launches_per_step": n_kern / steps, "busy_ms": busy,
            "traced_ms": traced_ms, "idle_share": 1 - busy / traced_ms,
            "groups_ms": groups}


def _p28_dropout_case(x, dy, seed, it, node, p, errs, label):
    """The kernel's forward and backward (through autograd, ``dy`` the
    output's gradient) against the plain version: bit for bit. ``x`` and
    ``dy`` may be views off 16 bytes: the kernel reads them in place."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    xg = x.detach().requires_grad_(True)
    y = dk.dropout(xg, p, seed, it, node)
    y.backward(dy)
    want_y = dk.dropout_plain(x, p, seed, it, node)
    want_dx = dk.dropout_plain(dy, p, seed, it, node)
    for name, got, want in (("dropout_fwd", y.detach(), want_y),
                            ("dropout_bwd", xg.grad, want_dx)):
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        errs[name] = max(errs.get(name, 0.0), err)
        if not torch.equal(got, want):
            raise SystemExit(f"phase 28: {name} against its plain version "
                             f"at {label}: max |err| {err}")


def p28_check_dropout(dev):
    """The dropout kernel against its plain version, bit for bit: at
    AlexNet's two shapes, odd sizes (not a multiple of 4) and views off
    16 bytes, in bf16, float32 and float64, at iterations past 2^32 and
    several nodes; masks differ from iteration to iteration; a CUDA graph
    captured once draws the masks of the iterations staged before each
    replay; the kept fraction within 5 standard deviations of p. Returns
    the max |err| of each (0: bit-equal)."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    snap = dict(dk.LAUNCHES)
    errs = {}
    g = torch.Generator(device=dev).manual_seed(28)
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        for shape in P28_ALEX_DROP + ((1,), (3,), (5,), (4097,),
                                      (7, 1003)):
            for it_v, node, p in ((0, 3, 0.5), (7, 11, 0.8),
                                  (2 ** 33 + 5, 2, 0.9)):
                it = torch.tensor([it_v], dtype=torch.int64, device=dev)
                n = int(np.prod(shape))
                xs = torch.randn(2, n + 1, generator=g, device=dev,
                                 dtype=torch.float32).to(dtype)
                _p28_dropout_case(xs[0, :n].reshape(shape),
                                  xs[1, :n].reshape(shape), seed, it, node,
                                  p, errs, f"{tuple(shape)} {dtype} it "
                                           f"{it_v}")
                if xs[0, 1:].data_ptr() % 16 == 0:
                    raise SystemExit("the view is not off 16 bytes")
                _p28_dropout_case(xs[0, 1:], xs[1, 1:], seed, it, node, p,
                                  errs, f"a view off 16 bytes, {n} {dtype}")
                n_cases += 2
    # masks from iteration to iteration, and their kept fraction
    n = P28_ALEX_DROP[0][0] * P28_ALEX_DROP[0][1]
    ones = torch.ones(n, device=dev)
    masks = []
    for it_v in range(4):
        it = torch.tensor([it_v], dtype=torch.int64, device=dev)
        masks.append(dk.dropout_apply(ones, P28_P, seed, it, 5) != 0)
    same = [bool(torch.equal(masks[i], masks[i + 1])) for i in range(3)]
    frac = [float(m.float().mean()) for m in masks]
    sigma = math.sqrt(P28_P * (1 - P28_P) / n)
    # a captured graph reads the iteration staged before each replay
    it_buf = torch.zeros(1, dtype=torch.int64, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        dk.dropout_apply(x, P28_P, seed, it_buf, 5)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = dk.dropout_apply(x, P28_P, seed, it_buf, 5)
    replayed = []
    for it_v in (3, 9, 3):
        it_buf.fill_(it_v)
        graph.replay()
        replayed.append(bool(torch.equal(
            y_static, dk.dropout_plain(x, P28_P, seed, it_v, 5))))
    dk.LAUNCHES.update(snap)          # check launches do not count
    log(f"  the dropout kernel against dropout_plain, {n_cases} cases "
        f"(forward and backward each): bit-equal; max |err| {errs}; masks "
        f"of iterations 0-3 equal to the next's: {same}; kept fractions "
        f"{[round(f, 5) for f in frac]} (p {P28_P}, sigma {sigma:.2e}); "
        f"one captured graph replayed at iterations 3, 9, 3: each the "
        f"plain version's mask for that iteration {replayed}")
    if any(same) or not all(replayed) or any(
            abs(f - P28_P) > 5 * sigma for f in frac):
        raise SystemExit("phase 28: dropout masks do not change with the "
                         "iteration, a replay baked its iteration, or the "
                         "kept fraction is off")
    return errs


def _p28_yolo_data(n, hw, classes, seed):
    """Seeded images in [0, 1) and YOLOv2 labels (B, 4+C, g, g): three
    boxes an image, each in a random cell of the g x g grid (hw / 32),
    centred in it with a random size of 0.5-4 cells and a random class."""
    rng = np.random.default_rng(seed)
    g = hw // 32
    x = rng.random((n, 3, hw, hw), dtype=np.float32)
    y = np.zeros((n, 4 + classes, g, g), np.float32)
    for i in range(n):
        cells = rng.choice(g * g, size=min(3, g * g), replace=False)
        for c in cells:
            r, col = divmod(int(c), g)
            w, h = rng.uniform(0.5, 4.0, 2)
            cx, cy = col + rng.random(), r + rng.random()
            y[i, 0:4, r, col] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2)
            y[i, 4 + rng.integers(classes), r, col] = 1.0
    return x, y


def _p28_state(net):
    """A host copy of a network's parameters and statistics."""
    if hasattr(net, "model"):
        return {k: v.detach().cpu().clone()
                for k, v in net.model.state_dict().items()}
    return {k: torch.from_numpy(v) for k, v in net.params().items()}


def _p28_equal(a, b):
    return a[1] == b[1] and all(torch.equal(v, b[0][k])
                                for k, v in a[0].items())


def _p28_det_pair(run, label):
    """Two runs of ``run()`` bit-equal; if not, again with cuDNN
    deterministic (set for the rest of the phase, and said)."""
    a, b = run(), run()
    same = _p28_equal(a, b)
    log(f"  {label}: two runs from one start bit-equal {same} (cuDNN "
        f"deterministic {torch.backends.cudnn.deterministic})")
    if not same:
        torch.backends.cudnn.deterministic = True
        log("  not bit-equal: cuDNN's chosen algorithms are not "
            "deterministic; this model's remaining gates set "
            "torch.backends.cudnn.deterministic")
        a, b = run(), run()
        same = _p28_equal(a, b)
        log(f"  {label}, cuDNN deterministic: bit-equal {same}")
        if not same:
            raise SystemExit(f"phase 28: {label}: two runs differ")
    return a


def _p28_yolo_net(dev, dtype="float32", hw=416, classes=20, anchors=None):
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import YOLO2
    kw = {} if anchors is None else {"anchors": anchors}
    conf = YOLO2(height=hw, width=hw, num_classes=classes, **kw).conf()
    conf.dtype = dtype
    return ComputationGraph(conf).init(dev)


def p28_check_bn(calls, dev):
    """The BN kernel pair against its plain versions (``check_kernels``)
    at each distinct (shape, relu, dtype, x and dy strides, gamma dtype)
    that YOLO2's step hands it: float32 with C 32 at 416x416 down to C
    1024 and 1280 on the 13x13 grid. Returns the max |err| of each."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    errs = {}
    for i, (shape, relu, dtype, xs, ys, gdtype) in enumerate(
            sorted(set(calls), key=str)):
        c = shape[1]
        chan = [1] * len(shape)
        chan[1] = c
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.empty_strided(shape, xs, dtype=dtype, device=dev)
        x.copy_(torch.randn(shape, device=dev, generator=g)
                + 2 * torch.randn(chan, device=dev, generator=g))
        dy = torch.empty_strided(shape, ys, dtype=dtype, device=dev)
        dy.copy_(torch.randn(shape, device=dev, generator=g))
        gamma = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(
            gdtype)
        beta = (0.1 * torch.randn(c, device=dev, generator=g)).to(gdtype)
        _, mean, _, inv, a, b = bn_relu.bn_train_forward(x, gamma, beta,
                                                         1e-5, relu)
        check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs,
                      f"{str(dtype)[6:]} relu={int(relu)} {shape} x "
                      f"strides {xs} dy {ys} gamma {str(gdtype)[6:]}")
        del x, dy
    torch.cuda.empty_cache()
    log(f"  YOLO2's {len(calls)} BN backwards a step, "
        f"{len(set(calls))} distinct: the kernels against their plain "
        f"versions, max |err| {errs}")
    return errs


def p28_yolo(dev, card):
    """YOLO2 at 416x416, batch 16, float32 (TF32 off), Adam(1e-3):
    ``ComputationGraph.fit`` on the scanned epoch, windows of 4 and
    per-step; gates and measurements."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import bn_relu
    b, steps = P28_YOLO_BATCH, P28_YOLO_STEPS
    t0 = time.perf_counter()
    xn, yn = _p28_yolo_data(b * steps, 416, 20, 0)
    it = DeviceCachedIterator(xn, yn, batch_size=b, device=dev)
    net = _p28_yolo_net(dev)
    if net.num_params() != P28_PARAMS["YOLO2"]:
        raise SystemExit(f"YOLO2 has {net.num_params()} parameters")
    log(f"  YOLO2 416x416 ({net.num_params()} parameters, 22 BN layers "
        f"each into a leaky ReLU) and {b * steps} images with box labels "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    # the shapes, dtypes and layouts the path hands the BN kernels
    # (recorded in the warm-up steps and the capture, as phase 6 does)
    calls = []
    real = bn_relu.bn_relu_bwd

    def recording(x, dy, gamma, mean, inv, a, b, relu):
        calls.append((tuple(x.shape), bool(relu), x.dtype, x.stride(),
                      dy.stride(), gamma.dtype))
        return real(x, dy, gamma, mean, inv, a, b, relu)

    bn_relu.bn_relu_bwd = recording
    try:
        t0 = time.perf_counter()
        warm = net.fit(it, epochs=1)
        torch.cuda.synchronize()
    finally:
        bn_relu.bn_relu_bwd = real
    log(f"  warm-up epoch (2 warm-up steps grow the BN phase-1 scratch, "
        f"the capture, one replay): {time.perf_counter() - t0:.1f} s, "
        f"losses {[round(v, 4) for v in warm.step_losses]}; "
        f"{net.last_fit_stats}")
    per_step = calls[-22:]
    if len(calls) != 22 * (2 + steps) or sorted(per_step, key=str) != \
            sorted(calls[:22], key=str):
        raise SystemExit(f"{len(calls)} BN backward calls recorded in "
                         f"YOLO2's warm-up steps and capture")
    bn_errs = p28_check_bn(per_step, dev)
    bn_relu.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit(it, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bn_relu.LAUNCHES)
    st = dict(net.last_fit_stats)
    step_ms = 1000 * wall / steps
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"  timed epoch (scanned, {st['graph_replays_per_epoch']} replay): "
        f"step {step_ms:.2f} ms, {b * steps / wall:.1f} images/s, losses "
        f"{[round(v, 4) for v in hist.step_losses]}; BN kernel launches a "
        f"step {per_step}  [{card}]")
    want = {"bn_bwd_phase1": 22 * steps, "bn_bwd_phase2": 22 * steps,
            "bn_relu_bwd_phase1": 0, "bn_relu_bwd_phase2": 0}
    if launches != want or st["tier"] != "scanned_epoch" or \
            st["graph_replays_per_epoch"] != 1 or \
            not np.all(np.isfinite(hist.step_losses)):
        raise SystemExit(f"YOLO2 timed epoch: launches {launches}, want "
                         f"{want}; {st}")
    prof = _p28_profile(lambda: net.fit(it, epochs=1), steps, card,
                        "YOLO2 scanned epoch")
    tiers = {"scanned": [step_ms]}
    for tier, kw in (("windows", {"fused_steps": 4}),
                     ("per-step", {"fused_steps": 1,
                                   "listeners": [_quiet_listener()]})):
        net.fit(it, epochs=1, **kw)                    # warm-up, capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = net.fit(it, epochs=1, **kw)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0) / steps
        tiers[tier] = [ms]
        log(f"  {tier}: step {ms:.2f} ms, {1000 * b / ms:.1f} images/s; "
            f"{net.last_fit_stats['tier']}, "
            f"{net.last_fit_stats['graph_replays_per_epoch']} replays an "
            f"epoch; losses finite {bool(np.all(np.isfinite(h.step_losses)))}"
            f"  [{card}]")
    # yolo2_loss alone, forward and backward, at the step's shapes
    from deeplearning4j_tpu_torch.ops.nn_ext import yolo2_loss
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    pred = torch.randn(b, 13, 13, 125, device=dev, requires_grad=True)
    lab = it.stacked_batches()[1][0][0].permute(0, 2, 3, 1)
    anchors = net.model["yolo"].anchors
    loss_ms = queued_ms(lambda: torch.autograd.grad(
        yolo2_loss(pred, lab, anchors), pred), flush)
    log(f"  yolo2_loss forward and backward alone at the step's shapes "
        f"({b}, 13, 13, 125): {loss_ms:.4f} ms  [{card}]")
    del net, it, flush
    torch.cuda.empty_cache()

    # gates: two scanned runs bit for bit; scanned against per-step
    def run(kw=None):
        netr = _p28_yolo_net(dev)
        itr = DeviceCachedIterator(xn, yn, batch_size=b, device=dev)
        h = netr.fit(itr, epochs=1, **(kw or {}))
        out = (_p28_state(netr), h.step_losses)
        del netr, itr
        torch.cuda.empty_cache()
        return out
    a = _p28_det_pair(run, "YOLO2 scanned epoch")
    c = run({"fused_steps": 1, "listeners": [_quiet_listener()]})
    reading = _reading({k: v.double() for k, v in a[0].items()},
                       {k: v.double() for k, v in c[0].items()}, a[1], c[1])
    log(f"  scanned against per-step from the same weights, {steps} steps: "
        f"tier rule {reading:.3g} (<= 1 passes), bit-equal "
        f"{_p28_equal(a, c)}  [{card}]")
    if reading > 1:
        raise SystemExit("phase 28: YOLO2's scanned and per-step tiers "
                         "disagree")
    # the loss falls over 10 steps on a fixed batch; at Adam(1e-4): from
    # the initial weights the zoo's Adam(1e-3) first sends the loss up
    # (the timed epochs above), and the JAX network's the same way
    # (tests/test_torch_zoo_detect.py
    # test_yolo2_voc_anchors_adam_steps_match_jax)
    from deeplearning4j_tpu_torch.learning import Adam
    netf = _p28_yolo_net(dev)
    netf.training_config.updater = Adam(1e-4)
    one = DeviceCachedIterator(xn[:b], yn[:b], batch_size=b, device=dev)
    fall = netf.fit(one, epochs=10).step_losses
    log(f"  10 steps of Adam(1e-4) on one batch: losses "
        f"{[round(v, 4) for v in fall]}")
    if not (np.all(np.isfinite(fall)) and fall[-1] < fall[0]):
        raise SystemExit("phase 28: YOLO2's loss does not fall on a fixed "
                         "batch")
    del netf, one
    torch.cuda.empty_cache()
    worst = p28_yolo_f64()
    return {"step_ms": step_ms, "images_per_s": 1000 * b / step_ms,
            "tiers": tiers, "profile": prof, "loss_ms": loss_ms,
            "tier_reading": reading, "f64_worst": worst, "bn_errs": bn_errs,
            "bn_launches_per_step": {k: v / steps
                                     for k, v in launches.items()}}


def p28_yolo_f64():
    """YOLO2 at the JAX test's size (64x64, 2 classes, anchors (1, 1, 2,
    2), batch 2) in float64, TF32 off, from the same weights: two steps on
    the card's scanned tier against the CPU's per-step tier, every
    trained tensor's change, statistic and loss to 1e-6."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    rng = np.random.RandomState(4)
    b, c = 2, 2
    x = rng.rand(2 * b, 3, 64, 64)
    y = np.zeros((2 * b, 4 + c, 2, 2))
    y[:, 0:4, 1, 1] = (0.5, 0.5, 1.5, 1.5)
    y[:, 4, 1, 1] = 1.0
    y[b:, 0:4, 0, 1] = (1.25, 0.25, 2.0, 1.5)
    y[b:, 5, 0, 1] = 1.0
    nets = {}
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        nets[tag] = _p28_yolo_net(dev, "float64", 64, c, (1.0, 1.0, 2.0,
                                                          2.0))
    nets["card"].model.load_state_dict(nets["cpu"].model.state_dict())
    init = nets["cpu"].params()
    hc = nets["card"].fit(DeviceCachedIterator(x, y, batch_size=b,
                                               device="cuda"), epochs=1)
    hh = nets["cpu"].fit([(x[:b], y[:b]), (x[b:], y[b:])], epochs=1)
    pc, ph = nets["card"].params(), nets["cpu"].params()
    stats = [k for k in pc if k.endswith(("_mean", "_var"))]
    trained = [k for k in pc if k not in stats]
    change = _max_rel({k: pc[k] - init[k] for k in trained},
                      {k: ph[k] - init[k] for k in trained})
    stat = _max_rel({k: pc[k] for k in stats}, {k: ph[k] for k in stats})
    loss = max(abs(p - q) / abs(q) for p, q in zip(hc.step_losses,
                                                    hh.step_losses))
    worst = max(max(change.values()), max(stat.values()), loss)
    log(f"  YOLO2 64x64 float64: card {nets['card'].last_fit_stats['tier']} "
        f"against CPU {nets['cpu'].last_fit_stats['tier']}, 2 steps: worst "
        f"change {max(change.values()):.2e} ({max(change, key=change.get)}),"
        f" statistic {max(stat.values()):.2e}, loss {loss:.2e} (tol 1e-6)")
    if worst > 1e-6:
        raise SystemExit("phase 28: YOLO2 float64 card against CPU")
    return worst


def _p28_alex_net(dev):
    from deeplearning4j_tpu_torch.zoo import AlexNet
    return AlexNet().build(dev)


def _mask_tap(real, rings):
    """``kernels/dropout.py`` ``dropout`` that also writes each draw's
    mask of a node in ``rings`` (node -> (R, n) bool) to row ``iteration
    % R``, on the device: a captured window replays the write, so the
    rings hold the masks a fit drew step by step (its extra launches are
    not the main path's and are not read)."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk

    def tapped(x, p, seed, iteration, node):
        ring = rings.get(node)
        if ring is not None:
            with torch.no_grad():
                ones = torch.ones(x.shape, device=x.device)
                keep = dk.dropout_apply(ones, p, seed, iteration, node) != 0
                row = torch.remainder(iteration.reshape(1), ring.shape[0])
                ring.index_copy_(0, row, keep.reshape(1, -1))
        return real(x, p, seed, iteration, node)
    return tapped


def _p28_drop_nodes(net):
    """AlexNet's dropout nodes in its training graph: (node, n)."""
    nodes = [op.attrs["node"] for op in net.samediff.ops()
             if op.op == "dropout"]
    if len(nodes) != 2:
        raise SystemExit(f"AlexNet's training graph holds {len(nodes)} "
                         f"dropout ops")
    return list(zip(nodes, (d[1] for d in P28_ALEX_DROP)))


def p28_alexnet(dev, card):
    """AlexNet at 224x224, batch 128, float32 (TF32 off), Nesterovs(1e-2,
    0.9), dropout 0.5 on the two dense layers' inputs, through
    ``MultiLayerNetwork.fit`` on the three tiers: the masks each tier drew
    (a device tap, :func:`_mask_tap`), the losses, a resume,
    then the timed tiers and a profiled pass."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    from deeplearning4j_tpu_torch.kernels.dropout import keep_mask_plain
    from deeplearning4j_tpu_torch.ops import random as rops
    b, steps = P28_ALEX_BATCH, P28_ALEX_STEPS
    det0 = torch.backends.cudnn.deterministic
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((b * steps, 3, 224, 224), dtype=np.float32)
    yn = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b * steps)]
    tiers = (("scanned", {"fused_steps": 1}),
             ("windows", {"fused_steps": 4,
                          "listeners": [_quiet_listener()]}),
             ("per-step", {"fused_steps": 1,
                           "listeners": [_quiet_listener()]}))

    def run(kw, tap=True, part=None):
        net = _p28_alex_net(dev)
        rings = {}
        real = rops.dropout_kernel.dropout
        if tap:
            for node, n in _p28_drop_nodes(net):
                rings[node] = torch.zeros(steps, b * n, dtype=torch.bool,
                                          device=dev)
            rops.dropout_kernel.dropout = _mask_tap(real, rings)
        try:
            lo, hi = part or (0, steps)
            itr = DeviceCachedIterator(xn[lo * b:hi * b], yn[lo * b:hi * b],
                                       batch_size=b, device=dev)
            h = net.fit(itr, epochs=1, **kw)
        finally:
            rops.dropout_kernel.dropout = real
        return net, h, {k: v.cpu() for k, v in rings.items()}

    def whole():
        net, h, _ = run({}, tap=False)
        return (_p28_state(net), h.step_losses)
    # cuDNN's default algorithms need not be deterministic, and AlexNet at
    # Nesterovs(1e-2) carries a run's rounding into the next steps: two
    # scanned runs decide whether the comparisons set it deterministic
    a = _p28_det_pair(whole, "AlexNet scanned epoch")
    results = {}
    for tier, kw in tiers:
        net, h, rings = run(kw)
        results[tier] = (_p28_state(net), h.step_losses, rings,
                         net.samediff._fit_base_seed,
                         dict(net.samediff.last_fit_stats))
        del net
        torch.cuda.empty_cache()
    ref = results["scanned"]
    masks_equal = {t: all(torch.equal(r[2][k], ref[2][k]) for k in ref[2])
                   for t, r in results.items()}
    plain_equal, differ, fracs = True, True, []
    for node, ring in ref[2].items():
        for i in range(steps):
            want = keep_mask_plain(ring.shape[1], ref[3], i, node, P28_P,
                                   dev).cpu()
            plain_equal &= bool(torch.equal(ring[i], want))
            fracs.append(float(ring[i].float().mean()))
            if i:
                differ &= not bool(torch.equal(ring[i], ring[i - 1]))
    n_min = min(r.shape[1] for r in ref[2].values())
    sigma = math.sqrt(P28_P * (1 - P28_P) / n_min)
    readings = {t: _reading({k: v.double() for k, v in r[0].items()},
                            {k: v.double() for k, v in ref[0].items()},
                            r[1], ref[1])
                for t, r in results.items() if t != "scanned"}
    log(f"  AlexNet with dropout, {steps} steps on each tier from the same "
        f"weights (base seed {ref[3]}; tiers "
        f"{[r[4]['tier'] for r in results.values()]}): the masks each tier "
        f"drew equal the scanned tier's {masks_equal}; each step's mask the "
        f"plain version's for (seed, iteration, node) {plain_equal}; every "
        f"step's mask differs from the last {differ}; kept fractions "
        f"{min(fracs):.5f}-{max(fracs):.5f} (p {P28_P}, sigma {sigma:.2e});"
        f" losses {[round(v, 4) for v in ref[1]]}, against the scanned "
        f"tier's by the tier rule {readings} (<= 1 passes; cuDNN "
        f"deterministic {torch.backends.cudnn.deterministic})  [{card}]")
    if not (all(masks_equal.values()) and plain_equal and differ) or any(
            abs(f - P28_P) > 5 * sigma for f in fracs) or any(
            v > 1 for v in readings.values()):
        raise SystemExit("phase 28: AlexNet's tiers drew other masks, or "
                         "their losses disagree")

    # a resumed run against an uninterrupted one, on the scanned tier
    def resumed():
        net, h1, _ = run({}, tap=False, part=(0, steps // 2))
        state = net.capture_training_state()
        del net
        net2 = _p28_alex_net(dev)
        net2.restore_training_state(state)
        itr = DeviceCachedIterator(xn[steps // 2 * b:], yn[steps // 2 * b:],
                                   batch_size=b, device=dev)
        h2 = net2.fit(itr, epochs=1)
        return (_p28_state(net2), h1.step_losses + h2.step_losses)

    r = resumed()
    log(f"  a run captured at step {steps // 2} and resumed in a new "
        f"network against an uninterrupted one: bit-equal "
        f"{_p28_equal(a, r)} (cuDNN deterministic "
        f"{torch.backends.cudnn.deterministic})")
    if not _p28_equal(a, r):
        raise SystemExit("phase 28: AlexNet resumed from a captured state "
                         "is not the uninterrupted run")
    torch.backends.cudnn.deterministic = det0
    torch.cuda.empty_cache()

    # the timed tiers; the launch counts of the scanned epoch
    net = _p28_alex_net(dev)
    if net.num_params() != P28_PARAMS["AlexNet"]:
        raise SystemExit(f"AlexNet has {net.num_params()} parameters")
    it = DeviceCachedIterator(xn, yn, batch_size=b, device=dev)
    net.fit(it, epochs=1)
    dk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit(it, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the module's other kernels (the noise draws) launch nothing here
    launches = {k: n for k, n in dk.LAUNCHES.items() if n}
    st = dict(net.samediff.last_fit_stats)
    step_ms = 1000 * wall / steps
    log(f"  timed epoch (scanned, {st['graph_replays_per_epoch']} replay): "
        f"step {step_ms:.2f} ms, {b * steps / wall:.1f} images/s, losses "
        f"{[round(v, 4) for v in hist.step_losses]}; dropout launches "
        f"{launches}  [{card}]")
    want = {"dropout_fwd": 2 * steps, "dropout_bwd": 2 * steps}
    if launches != want or st["graph_replays_per_epoch"] != 1:
        raise SystemExit(f"AlexNet: dropout launches {launches}, want "
                         f"{want}; {st}")
    prof = _p28_profile(lambda: net.fit(it, epochs=1), steps, card,
                        "AlexNet scanned epoch")
    times = {"scanned": step_ms}
    for tier, kw in tiers[1:]:
        net.fit(it, epochs=1, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it, epochs=1, **kw)
        torch.cuda.synchronize()
        times[tier] = 1000 * (time.perf_counter() - t0) / steps
        log(f"  {tier}: step {times[tier]:.2f} ms, "
            f"{1000 * b / times[tier]:.1f} images/s; "
            f"{net.samediff.last_fit_stats['tier']}, "
            f"{net.samediff.last_fit_stats['graph_replays_per_epoch']} "
            f"replays an epoch  [{card}]")
    del net, it
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "times": times,
            "profile": prof, "images_per_s": 1000 * b / step_ms}


def p28_dropout_timing(card_name, prof):
    """The dropout kernel at AlexNet's two shapes, float32: forward and
    backward alone (``median_ms``, L2 cold), the plain version (host
    clock, ``synced_ms``), one
    ``F.dropout`` call (the same work with another mask; never called by
    the port) and the bound (each input read once, each output written
    once, over the card's memory rate); per step, the sum of a call at
    each shape, and the profiled step's device time."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    dev = torch.device("cuda")
    bw = card_rates(card_name)[0]
    snap = dict(dk.LAUNCHES)
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    seed = torch.tensor([0], dtype=torch.int64, device=dev)
    it = torch.tensor([3], dtype=torch.int64, device=dev)
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "per_call": []} for k in P28_KERNELS}
    for shape in P28_ALEX_DROP:
        x = torch.randn(shape, device=dev)
        n = x.numel()
        # bytes: x read and y written once; the draw's integer work (ten
        # Philox rounds for four elements) is far below the memory time
        bound = {"bound_ms": 1e3 * 8 * n / bw, "bound_by": "bytes"}
        for k in P28_KERNELS:
            kern = median_ms(lambda: dk.dropout_apply(x, P28_P, seed, it, 7,
                                                      k), flush)
            # the plain version launches about 500 kernels a call, more
            # than the launch queue holds behind a sleep: host clock
            plain = synced_ms(lambda: dk.dropout_plain(x, P28_P, seed, it,
                                                       7), flush)
            lib = median_ms(lambda: F.dropout(x, 1 - P28_P, True), flush)
            o = out[k]
            o["ms"] += kern
            o["plain_ms"] += plain
            o["library_ms"] += lib
            o["bound_ms"] += bound["bound_ms"]
            o["bound_by"] = bound["bound_by"]
            o["per_call"].append({"shape": list(shape), "ms": kern,
                                  "plain_ms": plain, "library_ms": lib,
                                  "bound_ms": bound["bound_ms"],
                                  "bytes": 8 * n,
                                  "gb_per_s": 8 * n / kern / 1e6})
            log(f"  {k} at {shape} float32: alone {kern:.5f} ms "
                f"({8 * n / kern / 1e6:.1f} GB/s), plain {plain:.5f} (host "
                f"clock), "
                f"F.dropout {lib:.5f}, bound {bound['bound_ms']:.5f} "
                f"(bytes: {8 * n} read and written)")
    dk.LAUNCHES.update(snap)
    in_step = prof["groups_ms"].get("dropout kernel", 0.0)
    for k in P28_KERNELS:
        o = out[k]
        log(f"  {k} a step (both shapes): alone {o['ms']:.5f} ms, plain "
            f"{o['plain_ms']:.5f}, F.dropout {o['library_ms']:.5f}, bound "
            f"{o['bound_ms']:.5f} ({o['bound_by']}); both kernels in the "
            f"profiled step {in_step:.5f} ms")
        o["in_step_ms_both"] = in_step
    return out


def _p28_other_labels(name, net, b, rng):
    if name == "TinyYOLO":
        return _p28_yolo_data(b, 416, 20, 1)[1]
    if name == "UNet":
        return (rng.random((b, 1, 64, 64)) > 0.5).astype(np.float32)
    n = net.conf.layers[-1].n_out if hasattr(net.conf, "layers") \
        else 1000
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]


def p28_others(dev, card):
    """Every other ported model at its published input size, batch 8,
    float32: one per-step training step and one ``output``: a finite
    loss, the output's shape and the parameter count."""
    import deeplearning4j_tpu_torch.zoo as zoo
    rng = np.random.default_rng(2)
    rows = {}
    for name in P28_OTHERS:
        t0 = time.perf_counter()
        spec = getattr(zoo, name)()
        net = spec.build(dev)
        x = rng.random((8, spec.channels, spec.height, spec.width),
                       dtype=np.float32)
        y = _p28_other_labels(name, net, 8, rng)
        h = net.fit([(x, y)], epochs=1)
        out = net.output(x)
        out = out[0] if isinstance(out, list) else out
        torch.cuda.synchronize()
        shape, want = tuple(out.shape), (8,) + P28_OUTPUT[name]
        n = net.num_params()
        rows[name] = {"params": n, "loss": h.final_loss(), "output": shape,
                      "s": time.perf_counter() - t0}
        log(f"  {name} {spec.height}x{spec.width}: {n} parameters, one "
            f"per-step step loss {h.final_loss():.4f}, output {shape} "
            f"(want {want}), {rows[name]['s']:.1f} s")
        if n != P28_PARAMS[name] or not math.isfinite(h.final_loss()) or \
                shape != want or not torch.isfinite(out).all():
            raise SystemExit(f"phase 28: {name}: {rows[name]}")
        del net, out
        torch.cuda.empty_cache()
    return rows


def p28_stream_timing(card, card_name):
    """The streamed recurrence kernels (past 384 float32 units) at
    (32, 50, 512) and (32, 50, 1024) float32: each alone (``median_ms``,
    L2 cold), its bound, and cuDNN ``nn.LSTM``'s forward or backward of
    one layer (TF32 off; never called by the port), device time."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.kernels.measure import (
        lstm_recurrence_case, lstm_recurrence_cost, two_rate_bound)
    dev = torch.device("cuda")
    snap = dict(lstm.LAUNCHES)
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for b, t, u in P28_STREAM_SHAPES:
            plan = lstm.recurrence_plan(b, u, 4)
            gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
                b, t, u, torch.float32, dev)
            gates, hs, cs = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
            buf = gx.clone()
            bwd_in = (gates, cs, c0, w, d_hs, dh_t, dc_t)
            fwd_ms = median_ms(lambda: lstm.lstm_recurrence_fwd(
                buf, w, h0, c0), flush)
            bwd_ms = median_ms(lambda: lstm.lstm_recurrence_bwd(*bwd_in),
                               flush)
            x = torch.randn(b, t, u, device=dev, requires_grad=True)
            ref = torch.nn.LSTM(u, u, batch_first=True).to(dev)
            g_out = torch.randn(b, t, u, device=dev)
            o_ref = ref(x)[0]
            lib_f = queued_ms(lambda: ref(x), flush)
            lib_b = queued_ms(lambda: torch.autograd.grad(
                o_ref, [x] + list(ref.parameters()), g_out,
                retain_graph=True), flush)
            cost = lstm_recurrence_cost(b, t, u, 4)
            for k, ms, lib in (("lstm_recurrence_fwd", fwd_ms, lib_f),
                               ("lstm_recurrence_bwd", bwd_ms, lib_b)):
                ops, nbytes = cost[k]
                bound = two_rate_bound(ops, nbytes, card_name)
                rows.append({"kernel": k, "shape": [b, t, u],
                             "plan": str(plan), "ms": ms,
                             "library_ms": lib,
                             "bound_ms": bound["bound_ms"],
                             "bound_by": bound["bound_by"]})
                log(f"  {k} streamed at (B {b}, T {t}, U {u}) float32 "
                    f"(plan {plan}): alone {ms:.4f} ms, bound "
                    f"{bound['bound_ms']:.5f} ({bound['bound_by']}), cuDNN "
                    f"nn.LSTM {'forward' if k.endswith('fwd') else 'backward'}"
                    f" of the layer {lib:.4f} ms  [{card}]")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        lstm.LAUNCHES.update(snap)
    return rows


def phase_zoo(dev, card, card_name):
    """Phase 28; returns the dropout kernels' JSON records."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    det0 = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        log("  (i) the dropout kernel (CUDA C++) against its plain version:")
        errs = p28_check_dropout(dev)
        log("  (ii) YOLO2 416x416 bs16 float32 through ComputationGraph.fit:")
        yolo = p28_yolo(dev, card)
        torch.backends.cudnn.deterministic = det0
        log("  (iii) AlexNet 224x224 bs128 float32 with dropout through "
            "MultiLayerNetwork.fit:")
        alex = p28_alexnet(dev, card)
        torch.backends.cudnn.deterministic = det0
        log("  (iv) the dropout kernel timed at AlexNet's shapes:")
        timing = p28_dropout_timing(card_name, alex["profile"])
        log("  (v) every other ported model at its published size, bs8:")
        p28_others(dev, card)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = det0
    log("  (vi) the streamed LSTM recurrence kernels, timed:")
    stream = p28_stream_timing(card, card_name)
    records = []
    for k in P28_KERNELS:
        t = timing[k]
        records.append({
            "name": k, "route": "cuda", "source": P28_SOURCE,
            "replaces": P28_REPLACES, "launches": alex["launches"][k],
            "launches_per_step": alex["launches"][k] // P28_ALEX_STEPS,
            "max_abs_err": errs[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": "one F.dropout call at each shape (another mask)",
            "ms_per": f"AlexNet step ({P28_ALEX_BATCH} x 224x224, dropout "
                      f"on the inputs of its two 4096-unit layers)",
            "in_step_ms_both_kernels": t["in_step_ms_both"],
            "per_call": t["per_call"]})
    records[0]["streamed_lstm"] = stream
    records[0]["yolo2"] = {k: yolo[k] for k in (
        "step_ms", "images_per_s", "tiers", "loss_ms", "tier_reading",
        "f64_worst", "bn_launches_per_step", "bn_errs")}
    records[0]["yolo2"]["profile"] = yolo["profile"]
    records[0]["alexnet"] = {k: alex[k] for k in ("step_ms", "times",
                                                  "images_per_s")}
    records[0]["alexnet"]["profile"] = alex["profile"]
    return records


# ----------------------------------------------------------------------
# phase 29: the recurrent family, the noise layers and ComputationGraph
# save/load/evaluate
P29_RNN_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm_recurrence.cu"
P29_RNN_REPLACES = {"gru": "deeplearning4j_tpu/ops/nn_ops.py:569",
                    "graves": "deeplearning4j_tpu/ops/nn_ext.py:29",
                    "simple": "deeplearning4j_tpu/ops/nn_ops.py:607"}
P29_NOISE_REPLACES = {"gaussian_noise": "deeplearning4j_tpu/ops/random.py:138",
                      "gaussian_dropout":
                          "deeplearning4j_tpu/ops/random.py:130",
                      "alpha_dropout": "deeplearning4j_tpu/ops/random.py:117",
                      "spatial_dropout":
                          "deeplearning4j_tpu/ops/random.py:145"}
#: Word2VecSentimentRNN's widths: batch 64, 300-wide word vectors, reviews
#: cut to 256 steps, 256 units, 2 classes; 4 minibatches an epoch
P29_B, P29_T, P29_F, P29_U, P29_SEQS = 64, 256, 300, 256, 256
#: the TBPTT network at TextGenLSTM's widths: 77 characters, 256 units,
#: chunks of 32 x 50, sequences of 200 (4 chunks a minibatch), 2 minibatches
P29_TB, P29_TBPTT, P29_TSEQ, P29_TSEQS, P29_V = 32, 50, 200, 64, 77
#: each recurrence kernel's launches a sentiment step (GRU both ways) and a
#: TBPTT chunk (the simple RNN once)
P29_PER_STEP = {"gru_recurrence_fwd": 2, "gru_recurrence_bwd": 2,
                "graves_recurrence_fwd": 1, "graves_recurrence_bwd": 1,
                "gaussian_noise_fwd": 1}
P29_PER_CHUNK = {"simple_recurrence_fwd": 1, "simple_recurrence_bwd": 1,
                 "spatial_dropout_fwd": 1, "gaussian_dropout_fwd": 1,
                 "gaussian_dropout_bwd": 1, "alpha_dropout_fwd": 1,
                 "alpha_dropout_bwd": 1}
#: (the spatial dropout drops the network's input, which takes no
#: gradient: its backward does not run on this path)
#: (B, T, U) the recurrence kernels are held to their plain versions at:
#: the path's, one row, ragged rows and widths, one step, the widest
#: resident width and one streamed (512)
P29_CASES = ((P29_B, P29_T, P29_U), (1, 50, 5), (7, 50, 100), (64, 1, 16),
             (7, 50, 384), (64, 50, 512))
P29_TIERS = (("scanned", 1), ("windows", 2), ("per-step", 1))


def p29_check_kernels(dev):
    """(i) Each recurrence kernel against its plain version on the card at
    :data:`P29_CASES` (and the path's case reversed in time, as a
    ``Bidirectional`` layer's backward direction takes it), float32 and
    float64, the simple RNN under each activation; each call twice, bit
    for bit. Returns the worst relative error a kernel."""
    from deeplearning4j_tpu_torch.kernels import recurrence
    from deeplearning4j_tpu_torch.kernels.measure import (
        rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)
    errs = {}
    snap = dict(recurrence.LAUNCHES)
    cases = [(c, b, t, u, dt, 1, False) for c in ("gru", "graves", "simple")
             for dt in (torch.float32, torch.float64)
             for b, t, u in P29_CASES]
    cases += [(c, P29_B, P29_T, P29_U, dt, 1, True)
              for c in ("gru", "graves") for dt in (torch.float32,
                                                    torch.float64)]
    cases += [("simple", 7, 50, 100, dt, act, False)
              for act in sorted(set(recurrence.ACTIVATIONS.values()))
              for dt in (torch.float32, torch.float64)]
    worst_case = {}
    for cell, b, t, u, dt, act, rev in cases:
        case = rnn_recurrence_case(cell, b, t, u, dt, dev, seed=b + t + u,
                                   act=act)
        if rev:         # the sequence reversed in time, as a contiguous gx
            case["gx"] = case["gx"].flip(0).contiguous()
            case.update(zip(("saved", "hs", "cs", "hn"),
                            recurrence.recurrence_fwd_plain(
                                cell, case["gx"], *rnn_fwd_args(case))))
        got_f = recurrence.recurrence_fwd(cell, case["gx"].clone(),
                                          *rnn_fwd_args(case))
        want_b = recurrence.recurrence_bwd_plain(cell, *rnn_bwd_args(case))
        got_b = recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
        want_f = (case["saved"], case["hs"], case["cs"], case["hn"])
        torch.cuda.synchronize()
        for d, gots, wants in (("fwd", got_f, want_f), ("bwd", got_b,
                                                         want_b)):
            name = f"{cell}_recurrence_{d}"
            for got, want in zip(gots, wants):
                if want is None:
                    continue
                err, ok = _p27_close(got, want, dt)
                if err > errs.get(name, -1.0):
                    errs[name] = err
                    worst_case[name] = (b, t, u, str(dt)[6:], act, rev)
                if not ok:
                    raise SystemExit(f"{name} {dt} (B, T, U) = ({b}, {t}, "
                                     f"{u}) act {act} reversed {rev}: error "
                                     f"{err:.3e} against its plain version")
        again = recurrence.recurrence_fwd(cell, case["gx"].clone(),
                                          *rnn_fwd_args(case)) + \
            recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
        if not all(x is None or torch.equal(x, y)
                   for x, y in zip(again, got_f + got_b)):
            raise SystemExit(f"the {cell} recurrence kernels {dt} ({b}, {t},"
                             f" {u}): two calls differ")
    recurrence.LAUNCHES.update(snap)       # checks are not the path's
    for cell in ("gru", "graves", "simple"):
        for dt in (torch.float32, torch.float64):
            plans = []
            for b, t, u in P29_CASES:
                p = recurrence._card_plan(dev.index or 0, cell, dt, b, u)
                plans.append(f"U {u}: R {p.ranks}, {p.b_tile} rows a "
                             f"cluster, "
                             f"{'resident' if p.resident else 'streamed'}, "
                             f"{p.smem_fwd}/{p.smem_bwd} B, card holds "
                             f"{p.max_clusters} clusters")
            log(f"  {cell} {str(dt)[6:]} plans: " + "; ".join(plans))
    log(f"  (i) {len(cases)} cases (forward and backward each), within "
        f"{P27_TOL[torch.float32]:g} (float32) / "
        f"{P27_TOL[torch.float64]:g} (float64) of the largest magnitude, "
        f"two calls bit-equal; worst |error|: " + ", ".join(
            f"{k} {v:.2e} at {worst_case[k]}" for k, v in sorted(
                errs.items())))
    return errs


def p29_check_noise(dev):
    """(i') The noise kernel of each kind against its plain version at the
    paths' shapes: the Bernoulli kinds bit for bit, the Gaussian ones
    within 4 ulp of the output dtype of the terms' magnitude; two calls
    bit-equal. Returns the worst |difference| a kind."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    snap = dict(dk.LAUNCHES)
    seed = torch.tensor([20260 + (1 << 33)], dtype=torch.int64, device=dev)
    it = torch.tensor([3], dtype=torch.int64, device=dev)
    cases = [("gaussian_noise", (P29_B, P29_T, P29_F), {"stddev": 0.1}),
             ("gaussian_dropout", (P29_TB, P29_TBPTT, P29_U),
              {"stddev": (0.1 / 0.9) ** 0.5}),
             ("alpha_dropout", (P29_TB, P29_TBPTT, P29_U), {"p": 0.95}),
             ("alpha_dropout_bwd", (P29_TB, P29_TBPTT, P29_U), {"p": 0.95}),
             ("spatial_dropout", (P29_TB, P29_TBPTT, P29_V), {"p": 0.9}),
             ("spatial_dropout", (16, 32, 13, 13), {"p": 0.9})]
    errs = {}
    for dt in (torch.float32, torch.float64):
        for kind, shape, kw in cases:
            x = torch.randn(shape, device=dev, dtype=dt)
            axis = 1 if len(shape) == 4 else -1
            got = dk.noise_apply(kind, x, seed, it, 5, "gaussian_noise_fwd",
                                 channel_axis=axis, **kw)
            want = dk.noise_plain(kind, x, seed, it, 5, channel_axis=axis,
                                  **kw)
            diff = float((got - want).abs().max())
            if kind.startswith("gaussian"):
                n = dk.normals_plain(x.numel(), seed, it, 5, dev).reshape(
                    shape)
                s = kw["stddev"]
                scale = x.double().abs() * (1 + s * n.abs()) + s * n.abs() \
                    + want.double().abs()
                ok = bool(((got.double() - want.double()).abs()
                           <= 4 * torch.finfo(dt).eps * scale).all())
            else:
                ok = torch.equal(got, want)
            again = dk.noise_apply(kind, x, seed, it, 5, "gaussian_noise_fwd",
                                   channel_axis=axis, **kw)
            if not ok or not torch.equal(again, got):
                raise SystemExit(f"the noise kernel {kind} {dt} {shape}: "
                                 f"{diff:.3e} from its plain version, or two "
                                 f"calls differ")
            key = kind.replace("_bwd", "")
            errs[key] = max(errs.get(key, 0.0), diff)
    # the kernel's float32 normals themselves (x = 0, s = 1: the noise is
    # the normal, exactly) against normals_plain's, within the stated bound
    x0 = torch.zeros(P29_B, P29_T, P29_F, device=dev)
    got = dk.noise_apply("gaussian_noise", x0, seed, it, 5,
                         "gaussian_noise_fwd", stddev=1.0).double()
    want = dk.normals_plain(x0.numel(), seed, it, 5, dev,
                            torch.float32).reshape(x0.shape).double()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if not bool(((got - want).abs() <= dk.NORMAL_KERNEL_REL
                 * want.abs()).all()):
        raise SystemExit(f"the noise kernel's float32 normals: {rel:.3e} "
                         f"of their magnitude from normals_plain's, over "
                         f"the bound {dk.NORMAL_KERNEL_REL:.3e}")
    dk.LAUNCHES.update(snap)
    log("  (i') the noise kernel against its plain versions, float32 and "
        "float64: Bernoulli kinds bit-equal, Gaussian kinds within 4 ulp; "
        "worst |difference| " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in errs.items())
        + f"; its float32 normals within {rel:.3e} of their magnitude of "
          f"normals_plain's (bound {dk.NORMAL_KERNEL_REL:.3e}, "
          f"{x0.numel()} normals)")
    return errs


def _p29_conf(dtype="float32", f=P29_F, t=P29_T, u=P29_U):
    """The sentiment ComputationGraph (Word2VecSentimentRNN's settings:
    Adam(5e-3), L2 1e-5; ClipElementWiseAbsoluteValue 1.0 set on the
    training config after init)."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (
        Bidirectional, GaussianNoiseLayer, GravesLSTMLayer, GRULayer,
        InputType, LastTimeStepLayer, NeuralNetConfiguration, OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(0)
            .updater(Adam(learning_rate=5e-3)).l2(1e-5).graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.recurrent(f, t))
            .add_layer("noise", GaussianNoiseLayer(stddev=0.1), "in")
            .add_layer("bigru", Bidirectional(layer=GRULayer(n_out=u),
                                              mode="CONCAT"), "noise")
            .add_layer("glstm", GravesLSTMLayer(n_out=u), "bigru")
            .add_layer("last", LastTimeStepLayer(), "glstm")
            .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                          loss_function="MCXENT"), "last")
            .set_outputs("out").build())
    conf.dtype = dtype
    return conf


def _p29_net(dev, **kw):
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    net = ComputationGraph(_p29_conf(**kw)).init(device=dev)
    net.training_config.gradient_normalization = \
        "ClipElementWiseAbsoluteValue"
    net.training_config.gradient_normalization_threshold = 1.0
    return net


def _p29_data(dev, n=P29_SEQS, t=P29_T, f=P29_F, seed=0):
    """Synthetic reviews at the example's shapes, from ``seed``: word
    vectors N(0, 1) / sqrt(f) and a label a linear function of the
    sequence's mean vector decides, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, t, f, generator=g, device=dev) / math.sqrt(f)
    w = torch.randn(f, generator=g, device=dev)
    cls = (x.mean(1) @ w > 0).long()
    y = torch.nn.functional.one_hot(cls, 2).float()
    return x, y


def _p29_noise_tap(rings):
    """``kernels/dropout.py`` ``noise`` that also writes, for a node in
    ``rings`` (node -> (R,) float64 on the card), the sum of the noise it
    drew to row ``iteration % R``: a captured window replays the write, so
    the ring holds each step's draw (its extra launches are not counted
    and not the path's)."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    real = dk.noise

    def tapped(kind, x, seed, iteration, node, *a, **k):
        y = real(kind, x, seed, iteration, node, *a, **k)
        ring = rings.get(node)
        if ring is not None:
            with torch.no_grad():
                row = torch.remainder(iteration.reshape(1), ring.shape[0])
                ring.index_copy_(0, row, (y - x).double().sum().reshape(1))
        return y
    return real, tapped


def _p29_traced(prof, pats, n_units):
    """Each name's (device ms, traced launches) a unit: the trace's
    kernels whose names hold its pattern."""
    out = {}
    for kname, pat in pats.items():
        names = [n for n in prof["counts"] if pat in n]
        out[kname] = (sum(prof["by_name"][n] for n in names),
                      sum(prof["counts"][n] for n in names) / n_units)
    return out


def _p29_profile(fn, n_units, pats, want, label):
    """A profiled pass of ``fn`` (``_p27_profile``) and its traced kernels
    (``pats``). A pass that traced other than ``want`` launches a unit of
    a kernel is taken once more; a second such pass stops the run, since
    its in-step times and idle share would leave launches out."""
    for attempt in range(2):
        prof = _p27_profile(fn, n_units)
        traced = _p29_traced(prof, pats, n_units)
        short = {k: v[1] for k, v in traced.items()
                 if abs(v[1] - want[k]) > 1e-9}
        if not short:
            return prof, traced
        log(f"  FLAG: the {label} pass {attempt + 1} traced {short} "
            f"launches a unit, want {want}"
            + ("; taking it once more" if attempt == 0 else ""))
    raise SystemExit(f"phase 29: two profiled passes of the {label} traced "
                     f"other launches than the path made")


def p29_sentiment(dev, card):
    """(ii) The sentiment graph at full width on the scanned, windowed (2)
    and per-step tiers from seed 0, one epoch each: losses, parameters and
    each step's noise bit-equal across tiers; the counts set to 0 just
    before the scanned fit and read just after (every kernel of the path
    launched, in the replayed step); then each tier timed (median of 3
    epochs), a profiled scanned epoch (launches, idle share, device time
    by group; no cuDNN RNN kernel), and the loss falling over 6 epochs."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import _cuda, recurrence
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    x, y = _p29_data(dev)
    it = DeviceCachedIterator(x, y, P29_B, device=dev)
    steps = P29_SEQS // P29_B
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, nets = {}, {}
    rings = {0: torch.zeros(steps, dtype=torch.float64, device=dev)}
    real, tapped = _p29_noise_tap(rings)
    try:
        for tier, k in P29_TIERS:
            net = _p29_net(dev)
            if tier == "scanned":
                log(f"  sentiment graph: {net.num_params()} parameters, "
                    f"float32 (TF32 off), Adam(5e-3), L2 1e-5, element-wise "
                    f"clip 1.0; data {tuple(x.shape)} on the card "
                    f"({x.numel() * 4 / 1e6:.1f} MB)")
                for c in (recurrence.LAUNCHES, dk.LAUNCHES):
                    for key in c:
                        c[key] = 0
                before = _cuda.count_snapshot()
            rings[0].zero_()
            dk.noise = tapped
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = net.fit(it, listeners=[_quiet_listener()] if tier !=
                            "scanned" else [], fused_steps=k)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            finally:
                dk.noise = real
            if tier == "scanned":
                counts = {key: n for c, key, n in _cuda.counts_since(before)}
            nets[tier] = net
            res[tier] = {"losses": h.step_losses, "params": _p27_params(net),
                         "noise": rings[0].clone(),
                         "stats": dict(net.last_fit_stats), "s": first_s}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    ref = res["per-step"]
    if len(set(ref["noise"].tolist())) != steps:
        raise SystemExit("phase 29: the noise did not change each step")
    for tier in ("scanned", "windows"):
        worst, bits = _p27_diff(res[tier]["params"], ref["params"])
        same = (res[tier]["losses"] == ref["losses"] and bits
                and torch.equal(res[tier]["noise"], ref["noise"]))
        log(f"  (ii) {tier} vs per-step over {steps} steps: losses "
            f"{res[tier]['losses']} vs {ref['losses']}, parameters worst "
            f"{worst:.3e}; losses, parameters and each step's noise "
            f"bit-equal {same}; stats {res[tier]['stats']}")
        if not same:
            raise SystemExit(f"phase 29 gate (ii): the {tier} tier is not "
                             f"the per-step tier bit for bit")
    st = res["scanned"]["stats"]
    if st["tier"] != "scanned_epoch" or st["window_captures"] != 1:
        raise SystemExit(f"phase 29: the scanned fit did not capture one "
                         f"window: {st}")
    launches = {key: counts.get(key, 0) for key in P29_PER_STEP}
    log(f"  (ii) the scanned fit (first epoch, {res['scanned']['s']:.2f} s "
        f"with the warm-up and the capture): counts {counts}")
    for key, per in P29_PER_STEP.items():
        # the epoch's steps in its replay and the capture's 2 warm-up steps
        if launches[key] != (steps + 2) * per:
            raise SystemExit(f"phase 29: {key} launched {launches[key]} "
                             f"times in the scanned fit, want "
                             f"{(steps + 2) * per}")
    net = nets["scanned"]
    timed = {}
    for tier, k in P29_TIERS:
        ls = [_quiet_listener()] if tier != "scanned" else []
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nets[tier].fit(it, listeners=ls, fused_steps=k)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0) / steps)
        timed[tier] = (float(np.median(ts)), ts)
        log(f"  (ii) {tier}: a step of {P29_B} reviews x {P29_T} words "
            f"{[round(v, 3) for v in ts]} ms, median {timed[tier][0]:.3f} "
            f"ms, {1e3 * P29_B / timed[tier][0]:.1f} sequences/s; graph "
            f"replays an epoch "
            f"{nets[tier].last_fit_stats['graph_replays_per_epoch']}  "
            f"[{card}]")
    prof, in_step = _p29_profile(
        lambda: net.fit(it), steps,
        {"gru_recurrence_fwd": "gru_recurrence_fwd_kernel<float",
         "gru_recurrence_bwd": "gru_recurrence_bwd_kernel<float",
         "graves_recurrence_fwd": "graves_recurrence_fwd_kernel<float",
         "graves_recurrence_bwd": "graves_recurrence_bwd_kernel<float",
         "gaussian_noise_fwd": "noise_kernel<float>"}, P29_PER_STEP,
        "sentiment scanned epoch")
    foreign = [n for n in prof["counts"] if any(f in n for f in P27_FOREIGN)
               or "GRU" in n or "gru_cell" in n]
    if foreign:
        raise SystemExit(f"phase 29: the sentiment step ran {foreign}")
    groups = {"recurrence kernels": 0.0, "noise kernel": 0.0,
              "GEMMs": 0.0, "Adam and elementwise": 0.0, "other": 0.0}
    for name, ms in prof["by_name"].items():
        if "_recurrence_fwd_kernel" in name or \
                "_recurrence_bwd_kernel" in name or "_stream_" in name:
            groups["recurrence kernels"] += ms
        elif "noise_kernel" in name:
            groups["noise kernel"] += ms
        elif "gemm" in name.lower() or "sm90_xmma" in name or \
                "cutlass" in name.lower():
            groups["GEMMs"] += ms
        elif "elementwise" in name.lower() or "vectorized" in name or \
                "foreach" in name.lower() or "reduce" in name.lower():
            groups["Adam and elementwise"] += ms
        else:
            groups["other"] += ms
    log(f"  (ii) profiled scanned epoch: {prof['launches']:.1f} device "
        f"launches a step, busy {prof['busy_ms']:.3f} of "
        f"{prof['wall_ms']:.3f} ms, idle share {prof['idle_share']:.3f}; "
        f"device ms a step by group: " + ", ".join(
            f"{g} {v:.3f}" for g, v in groups.items()) + f"  [{card}]")
    log("    in the step: " + ", ".join(
        f"{k} {v[0]:.4f} ms ({v[1]:.1f} traced)" for k, v in in_step.items()))
    top = sorted(((v, n) for n, v in prof["by_name"].items()),
                 reverse=True)[:8]
    for v, n in top:
        log(f"      {v:8.4f} ms  {n[:110]}")
    first = float(np.mean(res["scanned"]["losses"]))
    means = [float(np.mean(net.fit(it).step_losses)) for _ in range(6)]
    log(f"  (ii) the mean step loss of the first epoch {first:.5f}, of six "
        f"more: {[round(v, 5) for v in means]}")
    if not (means[-1] < first and all(np.isfinite(means))):
        raise SystemExit("phase 29: the sentiment graph's loss did not fall")
    del nets
    return {"net": net, "x": x, "y": y, "launches": launches,
            "step_ms": timed["scanned"][0],
            "tiers": {k: v[0] for k, v in timed.items()}, "profile": prof,
            "groups": groups, "in_step": in_step}


def p29_f64_parity(dev):
    """(iii) A narrow float64 copy of the sentiment graph (10 features, 12
    steps, 16 units, 4 reviews) and its 2 fit steps, on the card and on
    the CPU from the same seed: the worst parameter change and loss, each
    relative to its largest magnitude, within 1e-6; the card's output and
    every gradient through autograd (the card's kernels) against the
    CPU's (the plain versions)."""
    res = {}
    for d in ("cuda", "cpu"):
        net = _p29_net(d, dtype="float64", f=10, t=12, u=16)
        x, y = _p29_data(torch.device("cpu"), n=8, t=12, f=10, seed=3)
        x, y = x.double(), y.double()
        p0 = _p27_params(net)
        h = net.fit(x.numpy(), y.numpy(), batch_size=4)
        res[d] = ({n: t - p0[n] for n, t in _p27_params(net).items()},
                  torch.tensor(h.step_losses, dtype=torch.float64),
                  net.output(x.numpy())[0].cpu())
    worst = {"parameter change": max(
        float((res["cuda"][0][n] - t).abs().max())
        / max(float(t.abs().max()), 1e-30) for n, t in res["cpu"][0].items()),
        "loss": float(((res["cuda"][1] - res["cpu"][1]).abs()
                       / res["cpu"][1].abs()).max()),
        "output": float((res["cuda"][2] - res["cpu"][2]).abs().max())}
    log(f"  (iii) float64 sentiment graph (10 -> bi-GRU 16 -> Graves 16), 2 "
        f"steps, card vs CPU: worst " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + " (tol 1e-6)")
    if max(worst.values()) > 1e-6:
        raise SystemExit("phase 29 gate (iii): float64 card against CPU")
    return worst


def _p29_tbptt_conf():
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (
        AlphaDropoutLayer, Bidirectional, GaussianDropoutLayer, InputType,
        LSTMLayer, NeuralNetConfiguration, RnnOutputLayer, SimpleRnnLayer,
        SpatialDropoutLayer)
    return (NeuralNetConfiguration.builder().seed(0)
            .updater(Adam(learning_rate=1e-3)).list()
            .layer(SpatialDropoutLayer(dropout=0.9))
            .layer(SimpleRnnLayer(n_out=P29_U, activation="tanh"))
            .layer(GaussianDropoutLayer(rate=0.1))
            .layer(AlphaDropoutLayer(dropout=0.95))
            .layer(Bidirectional(layer=LSTMLayer(n_out=P29_U), mode="ADD"))
            .layer(RnnOutputLayer(n_out=P29_V))
            .set_input_type(InputType.recurrent(P29_V, P29_TBPTT)).build())


def p29_tbptt(dev, card):
    """(iv) The TBPTT network (TextGenLSTM's widths) through ``fit_tbptt``
    on seeded one-hot characters: the counts set to 0 just before and read
    just after; the loss finite; per-chunk ms (median of 3 epochs) and a
    profiled epoch."""
    from deeplearning4j_tpu_torch.kernels import _cuda, lstm, recurrence
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    g = torch.Generator(device=dev).manual_seed(7)
    ids = torch.randint(0, P29_V, (P29_TSEQS, P29_TSEQ + 1), generator=g,
                        device=dev)
    eye = torch.eye(P29_V, device=dev)
    X, Y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    net = MultiLayerNetwork(_p29_tbptt_conf()).init(device=dev)
    chunks = (P29_TSEQS // P29_TB) * (P29_TSEQ // P29_TBPTT)
    for c in (recurrence.LAUNCHES, dk.LAUNCHES, lstm.LAUNCHES):
        for key in c:
            c[key] = 0
    before = _cuda.count_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit_tbptt(X, Y, P29_TBPTT, epochs=2, batch_size=P29_TB)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {key: n for c, key, n in _cuda.counts_since(before)}
    sd, states = net._tbptt_graphs[P29_TB]
    log(f"  (iv) TBPTT network ({net.num_params()} parameters): fit_tbptt, "
        f"2 epochs of {chunks} chunks of {P29_TB} x {P29_TBPTT}: "
        f"{first_s:.2f} s with the capture; losses {hist.epoch_losses}; "
        f"state variables {states}; counts {counts}")
    if any("_bwd_" in s for s in states) or not all(
            np.isfinite(hist.epoch_losses)):
        raise SystemExit("phase 29 gate (iv): the TBPTT network")
    launches = {key: counts.get(key, 0) for key in P29_PER_CHUNK}
    for key, per in P29_PER_CHUNK.items():
        # 2 epochs' chunks and the capture's 2 warm-up steps
        if launches[key] != (2 * chunks + 2) * per:
            raise SystemExit(f"phase 29: {key} launched {launches[key]} "
                             f"times in fit_tbptt, want "
                             f"{(2 * chunks + 2) * per}")
    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit_tbptt(X, Y, P29_TBPTT, epochs=1, batch_size=P29_TB)
        torch.cuda.synchronize()
        timed.append(1e3 * (time.perf_counter() - t0) / chunks)
    prof, in_chunk = _p29_profile(
        lambda: net.fit_tbptt(X, Y, P29_TBPTT, epochs=1,
                              batch_size=P29_TB), chunks,
        {"simple_recurrence_fwd": "simple_recurrence_fwd_kernel<float",
         "simple_recurrence_bwd": "simple_recurrence_bwd_kernel<float"},
        {"simple_recurrence_fwd": 1, "simple_recurrence_bwd": 1},
        "TBPTT epoch")
    ms = float(np.median(timed))
    log(f"  (iv) a chunk ({P29_TB} x {P29_TBPTT} characters): "
        f"{[round(v, 4) for v in timed]} ms, median {ms:.4f} ms; profiler: "
        f"{prof['launches']:.1f} device launches a chunk, busy "
        f"{prof['busy_ms']:.4f} of {prof['wall_ms']:.4f} ms, idle share "
        f"{prof['idle_share']:.3f}  [{card}]")
    log("    in the chunk: " + ", ".join(
        f"{k} {v[0]:.4f} ms ({v[1]:.1f} traced)"
        for k, v in in_chunk.items()))
    return {"launches": launches, "chunk_ms": ms, "profile": prof,
            "in_chunk": in_chunk}


def _p29_zip_round_trip(net, x, label):
    """save -> load on the card: (zip MB, save s, load s, outputs bit-equal,
    the loaded network)."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p29_")
    try:
        path = os.path.join(tmp, f"{label}.zip")
        t0 = time.perf_counter()
        net.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        other = ComputationGraph.load(path, device=x.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = torch.equal(net.output(x)[0], other.output(x)[0])
    return mb, save_s, load_s, same, other


def p29_save_evaluate(sent, card):
    """(v) The trained sentiment graph saved and loaded onto the card:
    outputs bit-equal, then one more fit step from each bit-equal; then
    ``evaluate`` with ``Evaluation``, ``ROCMultiClass`` and
    ``EvaluationCalibration`` against the same statistics computed on the
    host from ``output``."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.evaluation import (Evaluation,
                                                     EvaluationCalibration,
                                                     ROCMultiClass)
    net, x, y = sent["net"], sent["x"], sent["y"]
    mb, save_s, load_s, same, other = _p29_zip_round_trip(
        net, x[:P29_B], "sentiment")
    it = DeviceCachedIterator(x[:P29_B], y[:P29_B], P29_B, device=x.device)
    # the zip holds the configuration, as the JAX one does: the clipping
    # set on the training config and the next fit's base seed are not in
    # it
    tc, otc = net.training_config, other.training_config
    otc.gradient_normalization = tc.gradient_normalization
    otc.gradient_normalization_threshold = \
        tc.gradient_normalization_threshold
    other._seed = net._seed
    for n in (net, other):
        n.fit(it, listeners=[_quiet_listener()])
    _, bits = _p27_diff(_p27_params(other), _p27_params(net))
    log(f"  (v) sentiment graph: save {save_s:.3f} s ({mb:.2f} MB), load "
        f"{load_s:.3f} s: output bit-equal {same}; one more step from each "
        f"bit-equal {bits}")
    if not (same and bits):
        raise SystemExit("phase 29 gate (v): the sentiment graph's save/load")
    del other
    batches = [(x[i:i + P29_B], y[i:i + P29_B])
               for i in range(0, P29_SEQS, P29_B)]
    ev = net.evaluate(batches)
    roc = net.evaluate(batches, ROCMultiClass())
    cal = net.evaluate(batches, EvaluationCalibration())
    p = torch.cat([net.output(a)[0] for a, _ in batches]).cpu().numpy()
    yh = y.cpu().numpy()
    acc = float((p.argmax(1) == yh.argmax(1)).mean())
    hs = ROCMultiClass()
    hs.eval(yh, p)
    hc = EvaluationCalibration()
    hc.eval(yh, p)
    checks = {"accuracy": (ev.accuracy(), acc),
              "average AUC": (roc.average_auc(), hs.average_auc()),
              "ECE": (cal.expected_calibration_error(),
                      hc.expected_calibration_error())}
    log(f"  (v) evaluate over the {P29_SEQS} reviews: " + ", ".join(
        f"{k} {a:.6f} (host {b:.6f})" for k, (a, b) in checks.items()))
    if any(abs(a - b) > 1e-12 for a, b in checks.values()):
        raise SystemExit("phase 29 gate (v): evaluate against the host "
                         "statistics")
    return {"zip_mb": mb, "save_s": save_s, "load_s": load_s,
            "accuracy": acc}


#: phase 6's ResNet-50, saved after its training (p29_resnet_snapshot):
#: the zip's path, its output on 8 images and the images
P29_RESNET = {}


def p29_resnet_snapshot(net, x):
    """At the end of phase 6: save the trained ResNet-50 and keep its
    output on ``x`` (cuDNN deterministic) for phase 29's load."""
    import atexit
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p6_")
    # removed on every exit, also where a phase between stops the run
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    path = os.path.join(tmp, "resnet50.zip")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        net.save(path)
        save_s = time.perf_counter() - t0
        out = net.output(x)[0].clone()
    finally:
        torch.backends.cudnn.deterministic = det
    P29_RESNET.update(path=path, dir=tmp, x=x.clone(), out=out,
                      save_s=save_s, mb=os.path.getsize(path) / 1e6)
    log(f"  phase 6's trained ResNet-50 saved for phase 29: "
        f"{P29_RESNET['mb']:.1f} MB in {save_s:.2f} s")


def p29_resnet_load(card):
    """(vi) Phase 6's trained ResNet-50 loaded from its zip onto the card:
    the output on the same images bit-equal (cuDNN deterministic)."""
    import shutil
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    r = P29_RESNET
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        net = ComputationGraph.load(r["path"], device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = torch.equal(net.output(r["x"])[0], r["out"])
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(r["dir"], ignore_errors=True)
    log(f"  (vi) ResNet-50 zip ({r['mb']:.1f} MB): save {r['save_s']:.2f} s "
        f"(after phase 6), load {load_s:.2f} s; output on "
        f"{r['x'].shape[0]} images bit-equal {same}  [{card}]")
    if not same:
        raise SystemExit("phase 29 gate (vi): ResNet-50's save/load")
    del net
    return {"zip_mb": r["mb"], "save_s": r["save_s"], "load_s": load_s}


def p29_timing(card, card_name):
    """Each recurrence kernel alone (``median_ms``, L2 cold) at its path's
    shape (GRU and Graves: the sentiment graph's B 64, T 256, U 256; the
    simple RNN: the TBPTT chunk's B 32, T 50, U 256), float32, beside its
    plain version (host clock, ``synced_ms``), its bound and cuDNN's
    whole-layer ``nn.GRU`` / ``nn.RNN`` (TF32 off; none for the peephole
    LSTM); each noise kind alone at its path's shape beside its plain
    version, its byte bound and ``torch.normal(x, 0.1)`` (the Gaussian
    noise: x + 0.1 N(0, 1), other draws), ``F.alpha_dropout`` /
    ``F.dropout1d`` (none for the Gaussian dropout). Times a step (chunk) are a call's times
    its launches a step (chunk)."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    from deeplearning4j_tpu_torch.kernels import recurrence
    from deeplearning4j_tpu_torch.kernels.measure import (
        rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case,
        rnn_recurrence_cost)
    dev = torch.device("cuda")
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    snap_r, snap_n = dict(recurrence.LAUNCHES), dict(dk.LAUNCHES)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for cell, (b, t, u), per, ms_per in (
                ("gru", (P29_B, P29_T, P29_U), 2, "sentiment step"),
                ("graves", (P29_B, P29_T, P29_U), 1, "sentiment step"),
                ("simple", (P29_TB, P29_TBPTT, P29_U), 1, "TBPTT chunk")):
            case = rnn_recurrence_case(cell, b, t, u, torch.float32, dev)
            buf = case["gx"].clone()
            fa, ba = rnn_fwd_args(case), rnn_bwd_args(case)
            calls = {
                "fwd": (lambda: recurrence.recurrence_fwd(cell, buf, *fa),
                        lambda: recurrence.recurrence_fwd_plain(
                            cell, case["gx"], *fa)),
                "bwd": (lambda: recurrence.recurrence_bwd(cell, *ba),
                        lambda: recurrence.recurrence_bwd_plain(cell, *ba))}
            lib = {"fwd": None, "bwd": None}
            if cell != "graves":
                mod = (torch.nn.GRU(u, u, batch_first=True) if cell == "gru"
                       else torch.nn.RNN(u, u, batch_first=True)).to(dev)
                xin = torch.randn(b, t, u, device=dev, requires_grad=True)
                g_out = torch.randn(b, t, u, device=dev)
                o = mod(xin)[0]
                params = [xin] + list(mod.parameters())
                lib["fwd"] = queued_ms(lambda: mod(xin), flush)
                lib["bwd"] = queued_ms(lambda: torch.autograd.grad(
                    o, params, g_out, retain_graph=True), flush)
            cost = rnn_recurrence_cost(cell, b, t, u, 4)
            lib_name = "GRU" if cell == "gru" else "RNN"
            for d, (kern, plain) in calls.items():
                name = f"{cell}_recurrence_{d}"
                ms = median_ms(kern, flush)
                pl = synced_ms(plain, flush)
                ops, nbytes = cost[name]
                bound = two_rate_bound(ops, nbytes, card_name)
                out[name] = {
                    "ms": per * ms, "plain_ms": per * pl,
                    "bound_ms": per * bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "library_ms": None if lib[d] is None else per * lib[d],
                    "ms_per": f"{ms_per} ({per} call{'s' * (per > 1)})",
                    "per_call": {"ms": ms, "plain_ms": pl,
                                 "library_ms": lib[d],
                                 "bound_ms": bound["bound_ms"],
                                 "bytes": nbytes, "ops": ops,
                                 "us_per_step": 1e3 * ms / t}}
                log(f"  {name} (B {b}, T {t}, U {u}) float32, a call: alone "
                    f"{ms:.5f} ms ({1e3 * ms / t:.3f} us a step), plain "
                    f"{pl:.5f} (host clock), library "
                    + (f"{lib[d]:.5f} (cuDNN nn.{lib_name}'s whole-layer "
                       f"{'forward' if d == 'fwd' else 'backward'})"
                       if lib[d] is not None else "none")
                    + f", bound {bound['bound_ms']:.6f} ({bound['bound_by']}:"
                      f" {nbytes} bytes, {ops} operations)  [{card}]")
        noise_cases = (
            ("gaussian_noise_fwd", "gaussian_noise", (P29_B, P29_T, P29_F),
             {"stddev": 0.1}, lambda x: torch.normal(x, 0.1),
             "sentiment step"),
            ("gaussian_dropout_fwd", "gaussian_dropout",
             (P29_TB, P29_TBPTT, P29_U), {"stddev": (0.1 / 0.9) ** 0.5},
             None, "TBPTT chunk"),
            ("gaussian_dropout_bwd", "gaussian_dropout",
             (P29_TB, P29_TBPTT, P29_U), {"stddev": (0.1 / 0.9) ** 0.5},
             None, "TBPTT chunk"),
            ("alpha_dropout_fwd", "alpha_dropout",
             (P29_TB, P29_TBPTT, P29_U), {"p": 0.95},
             lambda x: torch.nn.functional.alpha_dropout(x, 0.05, True),
             "TBPTT chunk"),
            ("alpha_dropout_bwd", "alpha_dropout_bwd",
             (P29_TB, P29_TBPTT, P29_U), {"p": 0.95}, None, "TBPTT chunk"),
            ("spatial_dropout_fwd", "spatial_dropout",
             (P29_TB, P29_TBPTT, P29_V), {"p": 0.9},
             lambda x: torch.nn.functional.dropout1d(
                 x.transpose(1, 2), 0.1, True), "TBPTT chunk"))
        seed = torch.tensor([1], dtype=torch.int64, device=dev)
        itr = torch.tensor([2], dtype=torch.int64, device=dev)
        for name, kind, shape, kw, libf, ms_per in noise_cases:
            x = torch.randn(shape, device=dev)
            ms = median_ms(lambda: dk.noise_apply(
                kind, x, seed, itr, 3, name, **kw), flush)
            pl = synced_ms(lambda: dk.noise_plain(kind, x, seed, itr, 3,
                                                  **kw), flush)
            libms = None if libf is None else median_ms(lambda: libf(x),
                                                        flush)
            n = x.numel()
            gauss = kind.startswith("gaussian")
            bound = two_rate_bound((50 if gauss else 2) * n, 8 * n,
                                   card_name)
            out[name] = {"ms": ms, "plain_ms": pl,
                         "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"], "library_ms": libms,
                         "ms_per": f"{ms_per} (1 call)",
                         "per_call": {"ms": ms, "plain_ms": pl,
                                      "library_ms": libms, "bytes": 8 * n,
                                      "shape": list(shape)}}
            log(f"  {name} {tuple(shape)} float32: alone {ms:.5f} ms, plain "
                f"{pl:.5f} (host clock), library "
                + (f"{libms:.5f}" if libms is not None else "none")
                + f", bound {bound['bound_ms']:.6f} ({bound['bound_by']}: "
                  f"{8 * n} bytes)  [{card}]")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        recurrence.LAUNCHES.update(snap_r)
        dk.LAUNCHES.update(snap_n)
    return out


def phase_recurrent(dev, card, card_name):
    """Phase 29: gates (i)-(vi) and the measurements; returns the new
    kernels' JSON records."""
    errs = p29_check_kernels(dev)
    noise_errs = p29_check_noise(dev)
    sent = p29_sentiment(dev, card)
    p29_f64_parity(dev)
    tb = p29_tbptt(dev, card)
    saved = p29_save_evaluate(sent, card)
    del sent["net"]
    torch.cuda.empty_cache()
    resnet = p29_resnet_load(card)
    timing = p29_timing(card, card_name)
    launches = {**sent["launches"], **tb["launches"]}
    records = []
    for name, t in timing.items():
        cell = name.split("_recurrence")[0] if "_recurrence" in name \
            else None
        kind = None if cell else name.rsplit("_", 1)[0]
        rec = {"name": name, "route": "cuda",
               "source": P29_RNN_SOURCE if cell else P28_SOURCE,
               "replaces": P29_RNN_REPLACES[cell] if cell
               else P29_NOISE_REPLACES[kind],
               "launches": launches[name],
               "max_abs_err": errs[name] if cell else noise_errs[kind],
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "ms_per": t["ms_per"],
               "per_call": t["per_call"]}
        if name in sent["in_step"]:
            rec["in_step_ms"] = sent["in_step"][name][0]
        if cell == "simple":
            rec["in_step_ms"] = tb["in_chunk"][name][0]
        records.append(rec)
    return records, {"sentiment_step_ms": sent["step_ms"],
                     "tiers": sent["tiers"], "chunk_ms": tb["chunk_ms"],
                     "save": saved, "resnet": resnet}



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    from deeplearning4j_tpu_torch.environment import card_info
    card = card_info()
    name = torch.cuda.get_device_name(0)

    log("[1/29] env")
    import triton
    from deeplearning4j_tpu_torch.kernels import (_cuda, attention,
                                                  attention_f32, bn_relu,
                                                  dropout, int8_matmul, lstm,
                                                  paged_attention,
                                                  recurrence)
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  triton {triton.__version__}")
    log(f"  nvcc: {_cuda.nvcc_version()}")
    log(f"  card: {card}  ({torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    with ThreadPoolExecutor(8) as ex:
        for f in [ex.submit(bn_relu._phase1_lib), ex.submit(attention._lib),
                  ex.submit(paged_attention._lib),
                  ex.submit(attention_f32._lib),
                  ex.submit(int8_matmul._lib), ex.submit(lstm._lib),
                  ex.submit(dropout._lib)]:
            f.result()
    recurrence._lib()      # the LSTM's library: the engine's other cells
    log(f"  CUDA C++ libraries ready in {time.perf_counter() - t0:.1f} s")
    for lib in (bn_relu._PHASE1_LIB, attention._LIB, paged_attention._LIB,
                attention_f32._LIB, int8_matmul._LIB, lstm._LIB,
                dropout._LIB):
        build = _cuda.BUILDS.get(lib)
        log(f"  csrc/{lib}.cu: " + (f"built in {build['seconds']:.1f} s"
                                     if build else "already built"))
        for line in (build or {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    log("  the bf16 attention kernels' SASS (cuobjdump -sass) and spills:")
    check_attention_build()
    log("  the float32 attention kernels' SASS: tf32 mma.sync (HMMA .TF32); "
        "the int8 paged prefill's: wgmma, bulk copies, mbarrier waits:")
    check_attention_f32_build()
    log("  the paged cluster kernels (decode, verify): "
        "registers, spills, and their bulk copies, DSMEM pushes, cluster "
        "barrier and mbarrier waits in SASS:")
    check_paged_build()
    log("  the int8 kernel: registers, spills, wgmma, TMA, async copies, "
        "DSMEM pushes and mbarrier waits in SASS:")
    check_int8_build()

    log("[2/29] kernels: BN(+ReLU) backward vs plain, on the card "
        "(phase 1 CUDA C++, phase 2 Triton)")
    t0 = time.perf_counter()
    errs = {}
    phase_kernels(dev, errs)
    log(f"  ({time.perf_counter() - t0:.1f} s, builds included)")

    log("[3/29] kernels: attention forward and backward (CUDA C++) vs plain")
    t0 = time.perf_counter()
    phase_attention(dev, errs)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[4/29] parity: ResNet-50 32x32, two fit steps, card vs CPU")
    t0 = time.perf_counter()
    phase_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[5/29] parity: GPT_TINY float64, gradients and 3 Adam steps, card "
        "vs CPU")
    t0 = time.perf_counter()
    phase_gpt_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[6/29] main path: ResNet-50 224x224 bs{BATCH} bf16 "
        f"ComputationGraph.fit on the card: the scanned epoch (one CUDA "
        f"graph replay), windows of 4 and per-step")
    t0 = time.perf_counter()
    per_step, launches, metrics = phase_main(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[7/29] tiers and parity: ResNet-50's scanned and per-step tiers "
        "agree on the card; float64 card (scanned) vs CPU (per-step)")
    t0 = time.perf_counter()
    phase_resnet_tiers(card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[8/29] main path: GPT-medium bs{GPT_BATCH} seq{GPT_SEQ} bf16 "
        f"SameDiff.fit on the card")
    t0 = time.perf_counter()
    gpt_launches, gpt = phase_gpt(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[9/29] path shapes: BN kernels vs plain, then timed (ms per step)")
    t0 = time.perf_counter()
    timing, _ = phase_timing(dev, per_step, name, errs)
    in_situ = metrics["profile"]["kernel_ms"]
    for label, ms in (("timed alone, L2 cold", sum(
            t["ms"] for t in timing.values())), ("in the step (profiler)",
                                                  sum(in_situ.values()))):
        log(f"  BN backward kernels, {label}: {ms:.3f} ms of a "
            f"{metrics['step_ms']:.2f} ms step "
            f"({ms / metrics['step_ms']:.3f})  [{card}]")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[10/29] path shape: attention kernels timed (ms per GPT step)")
    t0 = time.perf_counter()
    attn_per_step = {k: n // GPT_STEPS for k, n in gpt_launches.items()}
    attn_timing, _ = phase_attention_timing(dev, name, attn_per_step)
    attn_in_step = gpt["profile"]["kernel_ms"]
    for label, ms in (("timed alone, L2 cold", sum(
            t["ms"] for t in attn_timing.values())),
            ("in the step (profiler)", sum(attn_in_step.values())),
            ("bound", sum(t["bound_ms"] for t in attn_timing.values()))):
        log(f"  attention kernels, {label}: {ms:.3f} ms of a "
            f"{gpt['step_ms']:.2f} ms step ({ms / gpt['step_ms']:.3f})  "
            f"[{card}]")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[11/29] kernels: paged attention (CUDA C++) vs plain")
    t0 = time.perf_counter()
    phase_paged_kernels(dev, errs)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[12/29] parity: GPT_TINY paged (float64, float32) and dense "
        "(float32) serving, card vs CPU")
    t0 = time.perf_counter()
    phase_serving_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[13/29] main path: GPT-medium float32 serving, "
        f"PagedGenerativeServer({SERVE_SLOTS} slots, blocks of {SERVE_BS}, "
        f"max_seq {SERVE_SEQ}), {SERVE_REQUESTS} requests; then "
        f"GenerativeServer")
    t0 = time.perf_counter()
    serve_launches, dense_launches, serve_shapes, serve = phase_serving(
        dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[14/29] path shapes: paged attention vs plain, then timed")
    t0 = time.perf_counter()
    paged_in_step = serve["profile"]["by_group_ms"]["paged attention"]
    paged_timing = phase_paged_timing(dev, name, serve_shapes, errs,
                                      paged_in_step)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[15/29] main path: LeNet bs{LENET_BATCH} through "
        f"MultiLayerNetwork.fit, then the SameDiff MLP, on three fit tiers "
        f"(scanned epoch, windows of 8, per-step)")
    t0 = time.perf_counter()
    phase_lenet(card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[16/29] tiers and parity: LeNet tiers agree on the card; float64 "
        "card vs CPU")
    t0 = time.perf_counter()
    phase_tiers()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[17/29] kernels: int8_matmul and paged_verify_attention (CUDA "
        "C++) vs plain, then timed")
    t0 = time.perf_counter()
    phase_spec_kernels(dev, errs)
    spec_timing = phase_spec_timing(dev, name, 512)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[18/29] parity: GPT_TINY speculative serving (dense and paged, "
        "float32 and int8 weights), card vs CPU")
    t0 = time.perf_counter()
    phase_spec_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[19/29] main path: GPT-medium int8-weight speculative serving, "
        f"PagedGenerativeServer({SERVE_SLOTS} slots, blocks of {SERVE_BS}, "
        f"max_seq {SERVE_SEQ}, 1-layer int8 self-draft, speculate_k "
        f"{SPEC_K}), {SERVE_REQUESTS} requests; then int8 without a draft "
        f"and float32 speculative")
    t0 = time.perf_counter()
    spec_serve = phase_spec_serving(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[20/29] parity: BERT_TINY float64 imported from one GraphDef, "
        "gradients and 3 Adam steps, card vs CPU")
    t0 = time.perf_counter()
    phase_bert_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[21/29] main path: BERT-base bs{BERT_BATCH} seq{BERT_SEQ} bf16 "
        f"from a frozen TF GraphDef through the port's importer and "
        f"SameDiff.fit: the scanned epoch (one CUDA graph replay) and the "
        f"per-step tier")
    t0 = time.perf_counter()
    phase_bert(card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[22/29] kernels: paged decode, verify and prefill over an int8 "
        "cache (CUDA C++) vs plain, then timed")
    t0 = time.perf_counter()
    phase_int8kv_kernels(dev, errs)
    int8kv_timing = phase_int8kv_timing(dev, name)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[23/29] parity: GPT_TINY int8 KV serving (paged float32 and "
        "float64, dense float32), card vs CPU")
    t0 = time.perf_counter()
    phase_int8kv_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[24/29] main path: GPT-medium int8 KV + int8 weights serving, "
        f"PagedGenerativeServer({SERVE_SLOTS} slots, blocks of {SERVE_BS}, "
        f"max_seq {SERVE_SEQ}), {SERVE_REQUESTS} requests; the dense int8 "
        f"server; the pool at one byte budget and the load generator; the "
        f"int8 speculative server (k {SPEC_K})")
    t0 = time.perf_counter()
    int8kv_serve = phase_int8kv_serving(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[25/29] main path: ResNet-50 224x224 served through "
        "ParallelInference (BATCHED, 2 workers, max_batch_size 32, buckets "
        "4-32; SEQUENTIAL and INPLACE gates)")
    t0 = time.perf_counter()
    phase_parallel_inference(card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[26/29] main path: ResNet-50 224x224 bs{BATCH} bf16 trained with "
        f"a RampSchedule(StepSchedule), L2, accum_steps {P26_ACCUM}, windows "
        f"of {P26_K} and the sentinel: checkpoints, FaultTolerantFit's "
        f"rollback, a resume, a divergence named; float64 card vs CPU")
    t0 = time.perf_counter()
    phase_train_options(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[27/29] main path: TextGenLSTM (77 -> LSTM 256 -> LSTM 256 -> "
        f"RnnOutputLayer 77) on SURVEY.md's characters: fit_tbptt (batch "
        f"{P27_BATCH}, sequences of {P27_SEQ}, TBPTT {P27_TBPTT}) and fit "
        f"(full BPTT on sequences of {P27_TBPTT}, three tiers); the LSTM "
        f"recurrence kernels (CUDA C++) vs plain; float64 card vs CPU; "
        f"save/load")
    t0 = time.perf_counter()
    textgen_records, _ = phase_textgen(dev, card, name)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[28/29] main path: the zoo's convolutional models: YOLO2 "
        f"416x416 bs{P28_YOLO_BATCH} float32 (ComputationGraph.fit, three "
        f"tiers), AlexNet 224x224 bs{P28_ALEX_BATCH} float32 with dropout "
        f"(MultiLayerNetwork.fit, three tiers, the masks, a resume), the "
        f"dropout kernel (CUDA C++) vs plain and timed, every other ported "
        f"model one step at its published size; the streamed LSTM "
        f"kernels timed")
    t0 = time.perf_counter()
    zoo_records = phase_zoo(dev, card, name)
    # the BN kernels' records hold their checks at YOLO2's shapes too
    for kname, err in zoo_records[0]["yolo2"]["bn_errs"].items():
        errs[kname] = max(errs.get(kname, 0.0), err)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[29/29] main path: the recurrent family: the sentiment "
        f"ComputationGraph at Word2VecSentimentRNN's widths ({P29_B} x "
        f"{P29_T} x {P29_F} -> GaussianNoise -> Bidirectional GRU "
        f"{P29_U} -> GravesLSTM {P29_U} -> last step -> softmax 2) on three "
        f"tiers, a float64 copy card vs CPU, a MultiLayerNetwork "
        f"(SpatialDropout, SimpleRnn {P29_U}, GaussianDropout, AlphaDropout,"
        f" Bidirectional LSTM {P29_U}) through fit_tbptt; the GRU, Graves "
        f"and simple RNN recurrence kernels and the noise kernel (CUDA C++) "
        f"vs plain and timed; save/load/evaluate of the sentiment graph and "
        f"of phase 6's ResNet-50")
    t0 = time.perf_counter()
    recurrent_records, _ = phase_recurrent(dev, card, name)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for kname, t in timing.items():
        route, source = ROUTE[int(kname[-1])]
        kernels.append({
            "name": kname, "route": route, "source": source,
            "replaces": REPLACES[int(kname[-1])],
            "launches": launches[kname],
            "launches_per_step": launches[kname] // STEPS,
            "max_abs_err": errs[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_per": "ResNet-50 step",
            "in_step_ms": in_situ[kname]})
    for kname, t in attn_timing.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_REPLACES,
            "launches": gpt_launches[kname],
            "launches_per_step": attn_per_step[kname],
            "max_abs_err": errs[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_per": "GPT-medium step",
            "in_step_ms": attn_in_step[kname],
            "library_pass_ms": t["library_pass_ms"]})
    kernels[-4]["serving"] = {**paged_timing["attention_fwd_serving"],
                              "launches": dense_launches["attention_fwd"]}
    per_step = 16
    at512 = paged_timing["decode_512"]
    kernels.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": serve_launches["paged_decode_attention"],
        "launches_per_step": per_step,
        "max_abs_err": errs["paged_decode_attention"],
        "no_write_max_abs_err": errs["paged_attention"],
        "ms": per_step * at512["per_call_ms"],
        "plain_ms": per_step * at512["plain_per_call_ms"],
        "bound_ms": per_step * at512["bound_per_call_ms"],
        "bound_by": at512["bound_by"],
        "library_ms": per_step * at512["library_per_call_ms"],
        "ms_per": "GPT-medium decode step, 8 lanes at context 512",
        "in_step_ms": paged_in_step, "per_call": paged_timing,
        "dense_server_launches": dense_launches["paged_decode_attention"]})
    prof = serve["prefill_profile"]
    for kname, launched in (("attention_fwd_f32", dense_launches),
                            ("paged_prefill_f32", serve_launches)):
        t = paged_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": F32_SOURCE,
            "replaces": F32_REPLACES[kname], "launches": launched[kname],
            "launches_per_step": per_step,
            # the combining kernel's launches in the same run, and a
            # profiled 512-row prefill's (either entry's combine)
            "combine_launches": launched["attention_f32_combine"],
            "combine_launches_per_step": prof[kname]["combines"],
            "max_abs_err": errs[kname],
            "ms": per_step * t["per_call_ms"],
            "plain_ms": per_step * t["plain_per_call_ms"],
            "bound_ms": per_step * t["bound_per_call_ms"],
            "bound_by": t["bound_by"],
            "library_ms": per_step * t["library_per_call_ms"],
            "ms_per": "GPT-medium prefill of 512 rows (16 layers)"
                      + (" after 256 cached keys" if "paged" in kname
                         else ""),
            "in_step_ms": prof[kname]["in_prefill_ms"], "per_call": t})
    kernels.extend(spec_kernel_records(spec_timing, spec_serve, errs))
    kernels.extend(int8kv_kernel_records(int8kv_timing, int8kv_serve, errs))
    kernels.extend(textgen_records)
    kernels.extend(zoo_records)
    kernels.extend(recurrent_records)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
