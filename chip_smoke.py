"""Drive paddle_tpu_torch on one CUDA card and check it end to end.

Usage (from the repository root, on a machine with an NVIDIA H100 and
nvcc):

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; any error exits
non-zero and no result line is printed):

1. the card: name, power limit, TF32 off for float32 matmuls;
2. build: the hand-written CUDA kernels are compiled from
   ``paddle_tpu_torch/ops/cuda_kernels/csrc`` with nvcc for sm_90a;
3. kernels K1 and K2: each against its plain PyTorch version on the card,
   in float32 and bfloat16, at the serving path's shapes, timed beside
   the plain version, the bound of the card and (flash only) PyTorch's
   scaled_dot_product_attention as a yardstick the port never calls;
   each flash row names its design (f32 ``mma_3xtf32``, bf16 ``mma``,
   both on the tensor cores) with its ratio to that call and its share of
   the bound; the f32 bound counts three TF32 products at the tensor
   cores' TF32 rate, and the phase's log rows (not the ``kernels`` line)
   give the CUDA cores' bound of one f32 product beside it.  K2 (design
   ``split_kv_cuda_cores``) runs the 8 ragged slots of a decode step, all
   8 at ctx 1024 and one alone at 1024, each timed warm (``kernel_ms``:
   100 calls on one pool, whose pages stay in the 50 MB L2) and cold
   (``kernel_cold_ms``: each call on the next of 8 or more pool copies,
   one per layer as a serve's ``kpool[i]``, at least 100 MB a round);
4. fifo serve: the full-width GPT bench model (vocab 32000, dim 512, 8
   layers, 8 heads, max_len 1024, float32, random weights from a seed)
   behind the fifo ServingEngine (8 slots, page 16) answers 16 requests,
   once to warm up and once measured; every request must finish, no page
   may leak, and the kernels' launch counts must equal 8 layers x the
   prefill runs and decode steps the engine ran;
5. the same weights and requests through an explicit-CPU engine, which
   takes the kernels' plain versions: tokens must agree, except at most
   one request that may part at a near tie (CPU top-2 logits within
   1e-3) — the rule every comparison below uses;
6. kernel K3 (the multi-query page walk) against its plain version at the
   mixed step's shape (4 chunk lanes of 32 rows) and the speculative
   verify's (8 slots of 5 rows), float32 and bfloat16, ragged, with an
   idle lane, a mid-page start, a chunk across a page, a lane near 1024
   and every unseen pool slot poisoned; design ``split_kv_mma`` (bf16) or
   ``split_kv_mma_3xtf32`` (f32, bounded as K1's f32 body), timed warm
   and cold as K2;
7. v2 serve (8 slots, page 16, chunk 32, 4 lanes, the default
   watermark): the 16 requests (tokens as the fifo card run's), the 16
   prefix-heavy requests of ``gpt_bench.prefix_prompts`` (prefix hits and
   copy-on-write must happen; tokens as an explicit-CPU v2 engine's), and
   a low-priority request overtaken by a high-priority burst in a pool
   tight enough to preempt (tokens as a roomy pool's); launch counts
   K3 = 8 x mixed steps, K2 = 8 x (mixed + decode steps), K1 = 0;
8. spec serve (k 4, a 1-layer draft) on weights whose layers 1-7 are
   damped as serve_bench's spec rows damp them: tokens as v2's on the
   same weights, drafts accepted, K3 = 8 x (mixed steps + spec rounds),
   K2 = 8 x (mixed + decode steps) + 1 layer x k x draft runs;
9. (the serving summary rows, printed with phase 18);
10. kernels K4-K6 (flash forward with logsumexp, dQ, dK/dV) against their
    plain versions, float32 and bfloat16, at the training bench shape
    [8, 8, 1024, 64] causal, a ragged [2, 4, 1000, 64] causal and
    non-causal, a D = 128 case [2, 4, 512, 128], one short ragged tile
    with a padded head dim [1, 1, 37, 40], B*H = 1024 [64, 16, 128, 64]
    and a head dim that is no whole number of 16-byte chunks in either
    dtype [1, 2, 77, 38] (staged element by element); out and lse
    absolutely, dq, dk and dv relative to each tensor's max |value|; at
    the bench shape each is timed beside its plain version, the card's
    bound and PyTorch's scaled_dot_product_attention (forward for K4, its
    backward, which yields dq, dk and dv together, for K5 and K6), and
    each row names its design (bf16 K4-K6 ``mma``; f32 K4-K6
    ``mma_3xtf32``, bounded as K1 in 3) with its ratio to that call and
    its share of the bound;
11. training parity, float32: ``build_lm_train_program`` at full width
    and depth (vocab 32000, dim 512, 8 layers, 8 heads, Adam 3e-4), batch
    2 x 256, three steps on the card and three on an explicit CPU
    executor from the same numpy state: losses within 1e-4 relative, the
    step-1 grads of the embedding, the first WQ and the head within 1e-3
    of their max |g|, and per step K4 = 16, K5 = 8, K6 = 8, K1 = 0;
12. bf16 training at the bench shape (``build_lm_train_program``
    defaults, batch 8 x 1024 from ``RandomState(0)`` as ``bench.py`` makes
    it): 2 warm-up steps, then 10 measured; every loss finite, the last
    below the first; step ms, tokens/s, peak memory and launch counts
    (K4 = 16, K5 = 8, K6 = 8, K1 = 0 per step);
13. kernels K7-K10 (the LSTM and GRU time loops, forward and BPTT)
    against their plain versions, float32 and bfloat16: the LSTM at its
    bench shape (B 64, T 96, H 512) and the GRU at the NMT encoder's (B 64,
    T 64, H 512), each with full and with ragged lengths, and at three
    awkward shapes (B 5, T 7, H 96; one row; a row of length 0), both
    also at B 160, T 6, H 512 (more batch groups than the persistent grid
    runs at once), the LSTM at B 4, T 5, H 528 and H 1152 and the GRU at
    B 4, T 5 and the two widths past 512 at which ``gru.smem_bytes``
    first exceeds the card's shared memory a block for some body and for
    every body (``gru.steps_widths``: widths whose W slice does not fit);
    states absolutely, gradients relative to each tensor's max |value|;
    each row logs the body that ran and its device launches, both read
    from the launches the kernel library counted in the parity call,
    kernel by kernel, where it launched them (``lstm.device_launches``,
    ``gru.device_launches``), and fails unless that is the body the
    module's ``route`` chose before the launch (``persistent``: K7 one
    launch, K8 two, K9 one, K10 three; ``steps``: T, 2T + 1, 2T and 4T +
    2); both bodies of each kernel must run; with full lengths each is
    timed beside its plain version and the card's bound (no single
    PyTorch call computes the same function, so no library time);
14. LSTM parity, float32: the stacked-LSTM classifier of
    ``rnn_bench.lstm_train_program`` at full width (vocab 30000, hidden
    512, two layers, the second reversed), batch 16 x 32 with ragged
    lengths, three Adam steps on the card and three on an explicit CPU
    executor from the same state: losses within 1e-4 relative, step-1
    grads of both recurrent weights and the embedding within 1e-3 of
    their max |g|, and per step K7 = 4, K8 = 2 (each LSTM op runs its
    forward again inside its grad op);
15. LSTM bench, bfloat16, batch 64 x 96 as ``bench.py`` makes it: 2 warm-up
    steps, 10 measured (the lowest measured loss below the first step's:
    the classifier memorises its one batch, and at loss 0 a bf16 Adam step
    can spike, so the last step need not be the lowest), then 3 steps on a
    feed with ragged lengths, then the same forward program without grad
    ops (test mode) on that feed: K7 = 2, K8 = 0;
16. NMT parity, float32: ``rnn_bench.nmt_train_program`` (the attention-NMT
    training program at the book's widths: dictionaries 30000, embedding,
    hidden and attention 512), batch 8 x 16 + 16 ragged, card against CPU
    as in 14; per step K9 = 4, K10 = 2;
17. NMT bench, float32, batch 64 x 64 + 64 ragged: 2 + 10 steps, the loss
    falls (judged as in 15);
18. kernels K11-K15 (the fused BatchNorm -> 1x1 convolution forward and
    backward; the fused BatchNorm -> 3x3 convolution forward, its O-blocked
    variant and backward) against their plain versions, float32 and
    bfloat16: every distinct (op, shape, stride, residual) of ResNet-50's
    fused bench program at batch 128 and 224 x 224 (read from its desc),
    ResNet-18's stride-2 and residual 3x3 shapes, and an odd-H stride-2
    3x3; outputs and gradients relative to each tensor's max |value|, the
    f32 kernels against the plain version in float64 (inputs clear of the
    ReLU's kink), the bf16 ones against it in bf16, with each bf16
    output's distance to the float64 function logged beside the plain
    version's (the forwards' too); each row names its body (every bf16
    kernel ``mma``, every f32 one ``mma_3xtf32``, bounded at three TF32
    products per f32 product with the CUDA cores' bound beside it) and
    K14's whether it has K13's bits;
    K13 and K14 timed at
    every 3x3 shape, K11, K12 and K15 in both dtypes at every ResNet-50
    shape, and one row (``bn_f32_resnet50_step``) sums launches x kernel
    ms of f32 K11, K12 and K15 over the fused ops of ResNet-50's step; at
    stage 2's 1x1 with a residual and its 3x3 each kernel is timed beside
    its plain version (the unfused ATen, cuDNN and torch.matmul
    composition) and the card's bound; then the ``top_k`` op that feeds
    ResNet's accuracy, on rows full of ties (all zeros; 128 x 1000
    integers in [0, 4)), float32 and bfloat16: its indices on the card
    equal a stable descending sort's (the lowest index first among equal
    values, as ``jax.lax.top_k``) and the CPU's;
19. ResNet-50 and ResNet-18 parity, float32: the fused NHWC programs of
    ``resnet_bench`` at full width (class_dim 1000), batch 4, Momentum
    0.001, against an explicit CPU executor from the same state.
    ResNet-18 at 64 x 64, three free steps on each: losses within 1e-4
    relative, step-1 grads of the stem filter, a fused 3x3 filter, a BN
    scale and the fc weight within 1e-3 of their max |g|, every running
    mean and variance within 1e-3 after three steps.  ResNet-50 at 128 x
    128, where float32 itself holds its gradients only to about 2%
    (RESNET_PARITY's comment): the card takes each of three steps from the
    CPU's state before it, each loss within 1e-4, the fc grad within 1e-3,
    the running statistics after step 1 within 1e-3, and the stem, fused
    3x3 and BN-scale grads, and all grads together, no further from a
    float64 CPU step's than twice the CPU's f32 ones; again with
    PADDLE_TPU_BNCONV_VARIANT=v2: K13 0, K14 32, each loss within 1e-4 of
    the CPU's and the step-1 loss within 1e-6 of v1's.  Per step K11 68,
    K12 34, K13 32, K15 16 (ResNet-50) and K11 6, K12 3, K13 30, K15 15
    (ResNet-18);
20. ResNet-50 bench, bfloat16, batch 128, 224 x 224 (``bench.py``'s
    configuration): 2 warm-up and 10 measured steps fused (the lowest
    measured loss below the first; step ms, images/s, peak memory, the
    launches of 19 every step), the same fused program again under
    PADDLE_TPU_BNCONV_VARIANT=v2 (K13 0, K14 32 a step), then the program
    built unfused for 2 + 10 steps (no port kernel runs) and the three
    images/s side by side;
21. K steps a dispatch (``Executor.run(steps_per_dispatch=K)``, one
    replay of a captured CUDA graph, ``framework/step_loop.py``), GPT
    training at the bench width, K = 4, in f32 at batch 2 x 256 and in
    bf16 at 8 x 1024: from one state, SPREAD_RUNS runs of 4 eager steps
    (the largest distance between two is the eager spread, printed, of the
    losses and of each persistable tensor; where they part, the ops whose
    outputs part first, from a checksum of every op's outputs in two more
    runs), then from that state the first dispatch (eager), the second
    (capture, then replay) and a third (replay) against the first eager
    run: losses within SPREAD_FACTOR of the losses' spread and each tensor
    within SPREAD_FACTOR of its own, so bitwise where the eager runs agree
    to the bit; launches at capture K x 16 K4, K x 8
    K5 and K6, none at a replay; then (bf16) 12 eager and 12 replayed
    steps, each ending in the loss fetch: step ms, tok/s, peak memory
    (eager; a replay allocates nothing), the memory reserved, and the
    graphs' shared pool;
22. on that GPT, each held as 21 to the spread of eager runs from its
    own start: ``fetch_every="last"`` (a second key, its own capture),
    with the graphs' shared pool and the card's reserved memory at one
    key and at two, and a replay after an eager ``run()`` replaced the
    scope's state; one executor dispatching a small MLP against two
    scopes in turn, each equal to the bit to its own eager steps; a small
    program holding ``uniform_random`` warns naming it, runs its K steps
    eagerly and equals K runs;
23. ``DeviceFeeder(steps=4)`` (pinned memory, its own stream) drives two
    GPT dispatches, held to the spread of eager runs of the same 8 steps
    against two numpy-fed ones from the same state;
24. fused ResNet-50 at the bench shape, K = 2, as 21: launches at
    capture 2 x (K11 68, K12 34, K13 32, K15 16), 12 eager and 12
    replayed steps; then whether one cooperative launch (K7's persistent
    body) captures into a graph (one call in a process of its own; a
    record, not a check);
25. the training options (``optimizer``, ``regularizer``, ``clip``,
    ``learning_rate_decay``, ``ModelAverage``): (a) the options GPT
    (bench.py's model with ``Adam(polynomial_decay(3e-4, 1000, 3e-5),
    L2Decay(1e-4), global_clip_norm=1.0)``, built through the public
    API) in f32 at 2 x 256, three card steps against an explicit-CPU
    executor as in 11, the step-1 learning rate equal on both and to the
    schedule's f32 closed form; (b) the same in bf16 at 8 x 1024: 10
    eager steps (K4 16, K5 8, K6 8 each; the loss falls), then from that
    state the spread of SPREAD_RUNS eager runs of 12 steps, and 3
    dispatches of K = 4 (launches at capture 4 x the per-step want) whose
    12 losses and state are held to it and whose 12 learning rates equal
    the closed form; 12 eager and 12 replayed steps timed beside 21's
    plain-Adam rows; (c) each of the 9 optimizer classes (Momentum also
    Nesterov) on a small f32 MLP with both regularizers and every clip
    kind (a parameter's own by value, by norm and by global norm, the
    optimizer's global norm, an error clip): losses and every persistable
    after 3 card steps within 1e-5 of 3 explicit-CPU steps (by norm),
    then K = 2 dispatches (eager, capture, replay) each equal to the bit
    to eager steps; (d) ``ModelAverage`` on that MLP under K = 2:
    ``apply`` (each average its window's mean) and ``restore`` after the
    first replay, the next replays equal to the bit to eager steps from
    the raw parameters; (e) the book: fit_a_line on synthetic uci_housing
    to a loss under 0.1 on the card, recognize_digits' conv net three card
    steps against the CPU as in 11 (synthetic mnist); (f) a
    ``print_gradient`` program under K = 2 warns naming ``print`` and
    equals 2 eager steps to the bit.  The MLP and book paths reach no
    port kernel and are checked to launch none;
26. generation: (a) K1 against its plain version at the generation
    prefill's shapes ([8, 8, 64, 64] and P 37, causal, f32 and bf16; the
    P 64 rows timed beside the plain version, the bound and SDPA);
    (b) the GPT bench width (vocab 32000, dim 512, 8 layers, 8 heads,
    ``max_len`` 256, seed 0) in f32: ``DecoderLM.generate`` greedy at
    batch 4, P 64, G 32 against an explicit-CPU executor (as 5), each
    token within 1e-4 of the card tower's best logit at its position
    (teacher forcing), K1 = 8 a call; ``beam_generate`` at batch 2, K 4,
    G 32 without and with an eos, held to the CPU's by
    ``first_parting`` (scores within 1e-4, ids equal up to a tie, which
    random weights make likely), the best lane's score its tower
    log-prob within 1e-3, K
    1 within 1e-4 of the tower's best, the best lane against greedy's
    log-prob logged (beam search does not promise to beat greedy);
    sampling (temperature 0.8, top_k 40, and top_k 1): a pinned step
    replays, another differs, every token within the top 40 of an
    explicit-CPU tower's logits, top_k 1 within 1e-4 of the tower's best;
    (c) the same width in bf16 at ``bench.py``'s decode shape (batch 8, P
    64, G 192): 1 + 3 calls, decoded tok/s, wall, peak memory, K1 = 8 a
    call, the op run once under ``torch.cuda.set_sync_debug_mode`` (no
    host sync allowed), one profiled call (device busy share, K1's
    share); (d) the attention NMT at the book's widths (dictionaries
    30000, widths 512), batch 8, source 64 ragged, beam 4, 16 steps:
    ``generate`` against an explicit-CPU executor and
    ``generate_composable`` against ``generate``, each by
    ``first_parting`` (scores within 1e-4, ids equal up to the first f32
    tie, which the fused op breaks by vocab index and the composable
    loop by per-lane rank; lengths exactly where ids are equal, the
    composable loop's stopping before eos), K9 = 2 a call in each; (e)
    control flow at small size: ``While`` sums 0..9, 3 SGD
    steps of a ``StaticRNN`` and of a ragged ``DynamicRNN`` against the
    CPU (losses and state 1e-4), ``ifelse``'s gradients against the CPU's
    for each branch (1e-4; the untaken branch's zero);
27. dropout and remat, GPT at the bench width: (a) f32 at 2 x 256, two
    steps with and without remat from one state (losses 1e-5 relative,
    step-1 grads 1e-4 of max |g|); (b) bf16 at 8 x 1024: remat alone and
    remat with dropout 0.1, 2 + 10 eager steps each (K4 16, K5 8, K6 8 a
    step, by the wrappers' counts and once by the profiler's; the loss
    falls; step ms and peak memory beside phase 12's plain row), the
    step-1 loss with and without remat equal to the bit, a dropout step
    from one state twice equal to the bit and the next step's different,
    K = 4 on the dropout program warning and running eagerly, K = 4 on
    the remat program captured as in 21 (12 eager against 12 replayed
    steps);
28. saving and loading what 27 trained: ``io.save_persistables`` then
    ``io.load_persistables`` into a fresh scope (bf16 card tensors, the
    saved bits), the next step equal to the uninterrupted one to the bit;
    ``io.save_inference_model`` then ``load_inference_model``: ``__model__``
    parses to its ``program.json``, and the loaded forward (K1 8
    launches) equals the live program's test-mode forward to the bit;
29. ResNet-50: (a) f32 at 128 x 128, batch 4, one fused step with and
    without remat from one state (phase 19's tolerances: loss 1e-4, fc
    grad 1e-3, statistics 1e-3); (b) fused bf16 with remat at the bench
    shape, 2 + 5 steps, K11–K15 inside the recompute segments (the
    launches the desc implies: a chain never crosses a segment's edge, so
    16 1x1 and 16 3x3 pairs fuse), step ms and peak memory beside phase
    20's; (c) its trained state in ``bench.py``'s inference program
    (batch 16, 224 x 224 x 3 NHWC) in f32 and bf16, all 53 pairs folded
    by ``fuse_batch_norm``: the f32 logits after the fold within 1e-4 of
    their max |value| of before it, the bf16 folded logits no further
    from the f32 unfolded ones than twice the bf16 unfolded ones (relative
    norm), img/s folded and unfolded (3 warm-up calls, 5 rounds of 10, the
    spread); cuDNN runs those convolutions, no port kernel;
30. the CNN zoo at ``bench.py``'s ``bench_cnn_train`` shape
    (``models/zoo_bench.py``: bf16 NHWC, batch 128, 224 x 224 x 3,
    class_dim 1000, f32 logits, softmax with cross entropy → mean,
    Momentum(0.01, 0.9), feeds from ``RandomState(0)``): AlexNet,
    GoogLeNet and VGG-19, 2 warm-up and 5 measured steps each, eager
    (dropout is not capturable yet); step ms with its spread, img/s,
    peak memory, no port kernel launched; the loss finite and falling; a
    batch that does not fit is halved and the cut named;
31. fused VGG-19: (a) the same at the same batch through
    ``fuse_bn_matmul`` (11 of its 16 convolutions), K13 and K15 launches
    a step as its desc implies (22 and 11), step ms and peak memory beside
    30's unfused row; K13 and K15 in bf16 at each of VGG-19's fused
    shapes (224 x 224 with K = O = 64 to 14 x 14 with K = O = 512) against
    their plain versions, timed beside them and the bound; (b) f32 at
    batch 2, 32 x 32, fc_dim 64, dropout 0: one fused and one unfused
    step from one state (phase 19's tolerances: loss 1e-4, the fc grad
    1e-3, the statistics 1e-3);
32. the DDPM U-Net at ``bench_unet_train``'s shape (f32, batch 64, 64 px,
    base_ch 64, ch_mults (1, 2, 4), Adam(1e-3), ``ddpm_feed`` from
    ``RandomState(0)``): 2 + 5 eager steps (the loss falls), then, on
    cuDNN's deterministic algorithms, K = 4 steps a dispatch held to the
    bit to eager steps from its state as in 21 (no port kernel; the eager
    runs must agree to the bit), 12 eager against 12 replayed steps (img/s
    both ways); then
    ``ddim_sample`` for 10 steps at batch 4 twice from one seed: finite
    and equal to the bit;
33. DeepFM: (a) the JAX package's CTR test shape (6 fields, vocab 256,
    embedding 8, hidden (32, 16), Adam(0.02), 512 rows), 30 steps on the
    card against 30 on an explicit-CPU executor and 30 in float64 from
    the same state: each card step from the CPU's state before it within
    1e-4 relative, step-1 gradients 1e-3 of max |g|, the free-running
    card and CPU losses within 1e-4 of the first loss of each other and
    of float64's; the loss falls by 20%; (b) the DeepFM paper's
    Criteo widths (39 fields, embedding 10, hidden 400-400-400) over a
    hashed vocabulary of 1,000,000 at batch 4096: step ms and rows/s;
34. the small zoo in f32 (TF32 off), card against an explicit-CPU
    executor from one state, dropout at 0 in the training descs:
    ``smallnet_mnist_cifar`` 32 x 32 batch 4, AlexNet and GoogLeNet 64 x
    64 batch 2 (class_dim 10; their test-mode forwards, at the models'
    dropout rates, within 1e-4 of the CPU's first), the U-Net at 16 px
    (base_ch 8) and a small program through ``glu``,
    ``dot_product_attention`` and ``sequence_conv_pool``: 3 steps each,
    losses 1e-4 relative, step-1 grads 1e-3 of max |g|; ``vgg_cifar``
    (batch 4), whose BatchNorm chain makes f32 ill-conditioned, as 19
    holds ResNet-50: each card step from the CPU's state, the fc grad
    1e-3, all grads no further from a float64 step's than twice the
    CPU's;
35. sequence labelling, the book's label_semantic_roles (``srl_net``:
    six word lookups into one frozen ``emb`` table, predicate and mark
    embeddings, stacked LSTMs of alternating direction over mixed fc
    sums, a linear-chain CRF, Viterbi, ``chunk_eval`` into a
    ``ChunkEvaluator``, SGD on an exponential decay; feeds from the
    synthetic conll05 reader): (a) f32 with TF32 off, card against an
    explicit-CPU executor, each of 3 card steps from the CPU's state
    before it: the small SRL (hidden_dim 32, depth 2, a 200-word dict)
    with the kernels' LSTM activations (K7 4, K8 2 a step) and with the
    book's (relu candidate, sigmoid cell: the plain loop, no kernel), and
    the JAX book test's GRU + CRF (K9 2, K10 1 a step): losses and the
    step-1 gradients within 1e-5, paths and chunk counts equal; K7 and K8
    at the full-width path's shapes (batch 10 and 128, the padded T, H
    128, the reader's ragged lengths), K9 and K10 at the GRU + CRF's,
    against their plain versions, timed beside them and the bound, with
    the route and device launches the library counted; the ``lstm`` op in both directions (K7 and K8
    through ``reverse_within_length``) against the plain loop on the
    card, rows of length 1 and T included, 1e-4; (b) the full-width SRL
    (44068 words, 59 labels, 3162 predicates, word_dim 32, hidden_dim
    512, depth 8) with the kernels' activations at batch 10 and 128: 2 +
    10 steps on fresh batches (K7 16, K8 8 a step), step ms (median, min,
    max), sentences and tokens a second, peak memory, 3 profiled steps
    (device busy share, device kernels a step, K7's and K8's device ms a
    step), the ChunkEvaluator's F1 after the timed steps (not gated), and
    the test-mode program (K7 8) in sentences a second;
36. the legacy config path: the v1 form of the reference's RNN benchmark
    config (benchmark/paddle/rnn/rnn.py: ``data_layer`` → 512-wide
    ``embedding_layer`` → 2 × ``simple_lstm(512)`` → ``last_seq`` →
    ``fc_layer(2, Softmax)`` → ``classification_cost``, Adam 2e-3; the
    config and its ``@provider`` of seeded token sequences written into a
    temporary directory by ``write_v1_rnn_config``): (a) at vocab 300,
    widths 32, batch 8 of ragged lengths up to 12, f32 with TF32 off,
    ``V1Trainer`` on the card against an explicit-CPU executor from one
    state for 3 steps (losses 1e-4 relative, step-1 gradients 1e-3 of max
    |g|, K7 4 and K8 2 a step), then a ``train`` pass and ``test`` on the
    card; (b) at full width (vocab 30000, batch 64, length 100, padded to
    128; f32), two subprocess runs of ``python -m paddle_tpu_torch
    train --config ... --job time --time-batches 20`` (ms a batch: median,
    min, max; tokens a second), then in this process the same 20 batches
    (K7 4, K8 2 a step), peak memory, 3 profiled steps (device busy
    share, kernels a step, K7's and K8's device ms a step) and ``test``
    (K7 2 a batch);
37. CTC and detection: (a) every op type this slice adds (``warpctc``,
    ``ctc_align``, ``edit_distance``, ``nce``, ``im2sequence``, ``lrn``,
    ``row_conv``, ``auc``, ``precision_recall``,
    ``positive_negative_pair``, ``iou_similarity``, ``box_coder``,
    ``prior_box``, ``roi_pool``, ``multibox_loss``,
    ``detection_output``) on the card against the CPU at small shapes,
    f32: outputs and gradients 1e-5 of their max |value|, integers equal,
    ``nce`` by its properties; (b) path (b), a bidirectional GRU CTC
    model in Fluid layers (per direction ``sequence_fc(3H)`` +
    ``dynamic_gru(H)``, the two directions' logits summed, ``warpctc``,
    Momentum), small, card against CPU by ``parity_run`` (K9 4, K10 2 a
    step); (c) path (b) at 40-wide frames, 100-384 frames, labels of
    10-60 tokens, C 28, H 256, batch 32: 2 + 5 steps (ms a step, frames
    a second, K9 4 and K10 2 a step), 3 profiled (device busy share,
    kernels a step, K9's and K10's device ms a step), the test-mode
    logits (K9 2)
    greedy-decoded by ``top_k`` → ``ctc_align`` and scored by
    ``edit_distance``, card and CPU equal; (d) ``DetectionMAP`` over
    card- and CPU-made ``detection_output`` slates, equal; then K7-K10 at
    the shapes of these paths, against their plain versions and timed as
    in 35;
38. the replica router and the analysis tier: (a) the dispatch overhead
    the cost model prices for the card (``analysis/cost.py``
    DEFAULT_DISPATCH_OVERHEAD_S), measured as the mean host time of 200
    replays of a one-op program at K = 2, each ending in its fetch; (b)
    the full-width GPT (as 4) serves the 16 requests of 4 through one
    wide v2 engine (8 slots, as 7) and through a ``ReplicaRouter`` over
    two v2 replicas of 4 and 2 slots, each with a pool for every slot at
    max_len: every request finishes, the router's tokens equal the wide
    engine's but for one near tie (5's rule), no page leaks in either
    replica, the router's pending tokens return to 0, request 0 lands on
    the argmin of (prompt + max_new) x the analyzer's token cost, and
    K2 = 8 x (mixed + decode steps), K3 = 8 x mixed steps summed over the
    replicas, K1 = 0; wall, TTFT p50 and output tok/s both ways; then
    each replica built alone and run alone on the requests the router
    placed on it: its ``hbm_report()["total_peak_bytes"]`` (weights
    included) beside the growth of ``torch.cuda.max_memory_allocated``
    plus the weights, which are resident before the replica is built,
    and ``program_cost``'s predicted decode step beside the device time
    of one decode step (its last decode feed replayed by ``time_ms``);
    no bound is set on these; (c)
    ``verify_program`` and ``Executor.run(verify=True)`` on the
    full-width GPT training program (f32, 2 x 256): no error, then one
    step (K4 16, K5 8, K6 8), and ``python -m paddle_tpu_torch lint`` on
    its forward saved as an inference model exits 0; (d)
    ``loop_parity_report`` on the card (K = 1, 2, 4; three dispatches a
    case): every K > 1 case replays a captured graph, and its losses and
    written state equal the sequential steps' to the bit;
39. the measurement tier: (a) the full-width GPT training step (as 10,
    bf16, batch 8 x 1024, one step a dispatch) captured 3 steps under
    ``torch.profiler`` with the op ranges on
    (``observability.attribution.capture_profile``): every op of the
    block has a row, the scaled_dot_product_attention rows and their
    generic_grad rows hold all the K4, K5 and K6 kernel time of the
    trace, the op rows hold at least 95% of its device time (the rest is
    the unattributed row), and the segment walk on the card (CUDA events)
    gives the same set of rows; the top op types' measured ms beside the
    cost model's and their ratio; (b) the table fed into a throwaway
    ``CalibrationStore``: ``program_cost``'s calibrated step beside the
    measured eager step and the captured step (K = 4), no bound; (c)
    ``accounting.track`` on that program and 5 steps (median, read after
    a device synchronize) and the measured peak: both ratios published;
    the 16 requests through a full-width f32 v2 engine (as 7) with the
    registry and the tracer on: the registry's mirrored counters equal
    ``stats()``, ``validate_snapshot`` finds nothing, the serve.decode
    and serve.mixed_step spans are as many as the engine's steps, K2 and
    K3 as 7 implies; ``memory.total`` is the card's; (d) ``tune
    paged_decode`` at the serving widths (8 slots, 8 heads, dh 64, ctx
    1024, f32) over the page sizes K2's limits admit, a second tune a
    cache hit with no trial, a fresh v2 engine without a page size takes
    the winner and serves the requests with the page-16 engine's tokens
    (5's near-tie rule) and no page leak; ``tune bn_conv`` at stage 2's
    3x3 shape of 18 (128 x 28 x 28, 128 -> 128, bf16) over v1, v2 with
    its O blocks and reference, each trial launching only its kernel (K13
    under v1, K14 under v2, none under reference), then the knob resolves
    the winner and the next fused forward launches its kernel; (e)
    ``python -m paddle_tpu_torch metrics``, ``trace`` and ``attribute
    --profile`` on the serving GPT's forward saved as an inference
    model, and ``tune paged_decode --smoke``, in parallel: each exits 0;
40. SPMD over a device mesh (``paddle_tpu_torch/parallel/``): (a) the
    flash ring, the zigzag ring and Ulysses at the GPT bench's attention
    shape ([8, 8, 1024, 64] global, causal), bf16 and f32, over S = 2, 4
    and 8 positions of the card, one training call each (forward and
    backward): held to the same schedule on the plain versions (out
    absolute, gradients relative to their max |g|, at the kernels'
    tolerance), K4/K5/K6 launches as the library counted them held to the
    schedule's (S blocks a position, 2S + 1 for zigzag, one for Ulysses),
    timed beside the plain call; (b) ``lm_dp_sp`` at the bench widths:
    ``build_lm_train_program`` (dim 512, 8 layers, 8 heads, vocab 32000,
    bf16) at global batch 8 x 1024 over {"dp": 4, "sp": 2} on eight
    positions of cuda:0 (zigzag), 2 + 5 steps, each held to the
    single-card Executor's step from the same state against a float32
    witness step (``mesh_gpt_phase``), with ms a step, device ms, busy
    share, peak memory, K4/K5/K6 launches a step (640, 320, 320), the
    reshards and collectives a step, and the single card's figures
    beside them; (c) f32 ``dp``, ``sp_ring`` and ``ep_dp`` on eight
    positions of the card against an explicit-CPU ``ParallelExecutor``,
    three steps (losses 1e-4, state 1e-3 of max |value|); (d) f32
    ``sp_ring`` at ``steps_per_dispatch=2`` on the card (eager, capture
    and replay, replay), each dispatch bitwise against two run() calls.
    One card shows no link time: a hop or a psum between its positions
    is a re-index or an add in its memory;
41. the pipeline executors and the host services
    (``parallel/program_pipeline.py``, ``distributed/``): (a) the bench
    GPT (``decoder_lm`` at dim 512, 8 layers, 8 heads, vocab 32000, bf16,
    batch 8 x 1024) with a ``pipeline_stage`` marker after every two
    blocks (4 stages: embedding and positions in the first, final
    LayerNorm, head and loss in the last) through ``ProgramPipeline``
    over {"pp": 4} at n_micro 4 and {"pp": 2, "dp": 2} at n_micro 2 on
    positions of cuda:0 with SGD, 2 + 10 steps, each held to the
    single-card Executor's SGD step from the same state against a
    float32 witness step (loss, and the parameter update), with ms a
    step, device ms, busy share, peak memory, hops and psums a step, and
    K4/K5/K6 launches a step held to the schedule's (LAYERS x n_micro x
    dp each), the single card's figures beside them; (b) the same GPT in
    f32 with Adam through ``DistributeTranspiler`` and two loopback
    PServers (HostAdam), 3 steps, held to the bit to the same program
    with the same host rule applied in-process (the single-card Adam op
    beside it, its distance reported: epsilon sits on the other side of
    the bias correction), each step split into device, wire and host
    optimizer; (c) the host services on the card: chaos
    ``worker_kill`` with a differential (bitwise) recovery proof, the
    16k-context ``admission_demo``, the CTR with a host table (card
    against CPU, losses 1e-4), and ``pp``, ``pp_dp`` and the functional
    MoE step on eight positions of the card against the CPU (losses
    1e-4);
42. the rest of the op library and the book chapters
    (``models/book_chapters.py``): (a) each of the last 48 op types on
    cuda:0 against the CPU from the same numpy inputs, the forward and
    its ``generic_grad`` (f32 within 1e-5 of the largest value, integer
    outputs equal), ``truncated_gaussian_random`` and ``sampling_id`` by
    their bounds, moments and frequencies, ``save`` then ``load`` through
    a temporary directory; (b) understand_sentiment on ``dataset.imdb``
    (path A's stacked LSTM, hidden 512, batch 64), machine_translation on
    ``dataset.wmt14`` (path B's attention NMT, dictionaries 30000, widths
    512, batch 64), recommender_system on ``dataset.movielens`` (batch
    256), word2vec on ``dataset.imikolov`` (N 5, batch 100), and RankNet
    and LambdaRank on ``dataset.mq2007``, each read by
    ``dataset.<m>.train()`` → ``reader.batch`` → ``DataFeeder`` →
    ``Executor.run`` on ``CUDAPlace(0)``: the first card step held to the
    CPU executor's step from the same startup state (loss 1e-4, step-1
    gradients 1e-3 of max |g|), then 2 warm-up and 10 timed steps, each
    ending in its loss fetch, every step's K7/K8 and K9/K10 launches held
    to the program's LSTM and GRU op counts, with ms a step (median, min,
    max), samples a second, peak memory and the device busy share of a
    profiled step;
43. the v2 API and the RecordIO data plane (``paddle_tpu_torch/v2/``,
    ``native/recordio``): (a) ``dataset.imdb.convert`` writes the imdb
    splits as RecordIO shards through the native library (built with g++
    into ``paddle_tpu_torch/_build/``); the train shards read back by the
    library equal the Python codec's records, byte for byte, the Python
    codec writes the same file bytes, and the records unpickle to
    ``imdb.train()``'s samples in order; (b) the v2 book's
    understand_sentiment ``stacked_lstm_net`` in the v2 idiom
    (``models/book_chapters.py`` ``v2_sentiment_build``: ``layer.data``
    of ``integer_value_sequence``, ``embedding``, ``fc``, ``lstmemory``
    with every other one reversed, ``pooling`` with ``pooling.Max()``,
    ``classification_cost``) at the book's widths (dictionary 5147, emb
    128, hid 512, 3 LSTMs, batch 100), Adam 2e-3 with L2 decay 8e-4,
    f32, through ``trainer.SGD``; (c) three iterations on the card
    against three on an explicit-CPU ``SGD(place=CPUPlace())`` from one
    state carried as a ``Parameters`` tar, fed by
    ``reader.creator.recordio`` over the shards through ``paddle.batch``:
    losses within 1e-4 relative, step-1 gradients within 1e-3 of max
    |g|, 2 K7 and 1 K8 launches a step for each ``lstmemory``; (d) 2
    warm-up and 10 timed iterations from the shards: ms a step, samples a
    second, peak memory, launches a step, and a profiled step's busy
    share and K7/K8 device ms (upper bounds, as in 42); (e) after (c),
    the card's parameters through ``to_tar`` into the CPU program to the
    bit, and ``paddle.infer`` on the card against the CPU's
    probabilities (1e-4 of max; K7 once for each ``lstmemory``); (f)
    one pass of
    ``v2.master.client`` over the shards through a loopback
    ``MasterServer``: every record once; (g) ``SequenceGenerator`` over
    26(d)'s NMT ``generate`` graph on the card against an explicit-CPU
    one by ``first_parting`` (scores 1e-4, ids equal up to the first f32
    tie), K9 twice a call;
44. the deploy tier (``native/program_desc``, ``native/capi``,
    ``capi_runtime``, ``compiler``, ``utils/``, ``net_drawer``, the CLI's
    deploy subcommands): (a) the desc library, the C-API library and the
    C demo (``native/capi_demo.c``) built with g++ into
    ``paddle_tpu_torch/_build/``, each timed; (b) on the full-width GPT
    training program (vocab 32000, dim 512, 8 layers, 8 heads, f32, seq
    512) and its saved inference program: ``validate`` passes, ``stats``
    equals the counts taken from the Program, ``prune(train, [logits])``
    parses to ``io.prune``'s op list, ``text_dump`` is non-empty and the
    same twice, and an undeclared input, the bytes cut in half and a
    ``parent_idx`` cycle are refused with their diagnostics; (c)
    ``save_inference_model`` of that GPT from one seeded state (feed
    ``tokens``, fetch ``logits``; the save validates); (d) the C program,
    a process of its own with no Python of its own, loads the model
    through ``libpaddle_capi`` and runs tokens [4, 512] from
    ``RandomState(0)`` on the card: its logits equal
    ``load_inference_model`` + ``Executor.run``'s in this process to the
    bit, and ``paddle_capi_shutdown`` returns 0; the in-process
    ``InferenceEngine`` gives the same bits with K1 = 8 a run and no other
    kernel, timed beside ``Executor.run`` (host ms, median (min–max) of
    10 after 2 warm-up); (e) ``build_callable`` on the loaded program
    equals ``Executor.run`` to the bit with K1 = 8, one call captured by
    ``torch.cuda.graph`` and replayed equals the eager call to the bit
    (eager and replayed ms), and ResNet-50 inference (``resnet_imagenet``
    depth 50, class_dim 1000, f32, batch 8 x 3 x 224 x 224,
    startup-initialised, TF32 off) through ``build_callable`` is within
    1e-5 of max |logit| of ``Executor.run``'s, no port kernel launched;
    (f) ``cli.main`` runs ``validate`` (OK), ``stats``, ``dump_config``,
    ``show_pb`` and ``merge_model`` on the saved model, the merged bundle
    loads and its forward equals (d)'s logits to the bit,
    ``net_drawer.draw_graph`` gives a digraph; a bf16 fetch raises
    TypeError through ``capi_runtime.output_dtype`` (the C ABI has no
    bf16 code);
45. one program over two processes (``distributed/multihost.py``, the
    mesh of ``distributed/launch.global_mesh``, ``parallel/transport.py``):
    two processes with four positions of cuda:0 each, joined by the env
    contract, each logging the transport the rule chose (gloo, card
    tensors staged through pinned host memory: the two ranks share the
    card), then this process over eight positions (the single-process
    mesh), run the same cases from the same seed; (a) f32 parity of
    ``tools/multihost_smoke.py``'s two programs (the dp-8 MLP under
    ``fsdp_params``, four steps; the small LM over {"sp": 2, "dp": 4},
    sp-major, four steps) and of ``sp_ring`` and ``ep_dp`` (three steps):
    losses within 1e-6 relative and every state tensor within 1e-6 of its
    largest |value| of the single process's (bitwise is logged); (b) the
    full-width GPT (``build_lm_train_program``, dim 512, 8 layers, 8
    heads, vocab 32000, bf16, Adam 3e-4) at global batch 8 x 1024 over
    {"sp": 2, "dp": 4}, sp-major, so that every zigzag hop crosses the
    process boundary: 2 + 10 steps, the first four steps' losses and the
    state after them equal to the single-process mesh's over the same
    axes from the same state (to the bit: the processes add every psum in
    the single process's order; the single process runs those four
    steps), the two processes equal to each other after the last; per
    process ms a step, device ms and busy share of
    one profiled step, peak memory, K4/K5/K6 launches a step (half of
    phase 40's 640/320/320: each process runs four of the eight
    positions), collectives a step and the transport's bytes and seconds
    a step, beside the single process's and phase 40(b)'s figures (the
    two processes time-share one card: no speed claim); (c)
    ``ProgramPipeline`` over {"pp": 2, "dp": 2}, pp-major (the stage hop
    crosses the processes), the bench GPT cut after its fourth block,
    bf16, n_micro 2, SGD 0.05: 2 + 5 steps equal to the single-process
    pipeline's, hops a step and K4/K5/K6 launches a process a step (8 x 2
    x 2 / 2 each); (d) ``run(steps_per_dispatch=2)`` of f32 ``sp_ring``
    on the two-process mesh takes the loud eager route (its safety
    reasons name the staged transport, nothing is captured) and equals
    two ``run()`` calls to the bit, three dispatches; (e) first, in this
    process, K4, K5 and K6 at the processes' per-position shapes (a
    zigzag training call over {"sp": 2}: the GPT's [2, 8, 256, 64] halves
    in bf16 and f32, the small LM's [2, 2, 16, 32] in f32) held to their
    plain versions at phase 40(a)'s tolerances, the launches to the
    schedule's;
46. summary.

The second-to-last line is the ``{"kernels": [...], "serve": [...],
"train": [...], "step_loop": [...], "options": {...}, "generate":
{...}, "remat_save_load": {...}, "zoo": {...}, "srl": {...}, "legacy":
{...}, "router": {...}, "measurement": {...}, "parallel": {...},
"distributed": {...}, "book": {...}, "v2": {...}, "deploy": {...},
"multiprocess": {...}}``
summary (all 15 kernels)
and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2 and
prints no result.
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
import runpy
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as fluid
import paddle_tpu_torch.v2 as paddle_v2
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.dataset import common as dataset_common
from paddle_tpu_torch.dataset import conll05, imdb
from paddle_tpu_torch.distributed import multihost as mh
from paddle_tpu_torch.distributed.master import MasterServer, MasterService
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch import lod as lod_mod
from paddle_tpu_torch.lod import LoDTensor, bucket_len
from paddle_tpu_torch.models import gpt_bench, resnet_bench, rnn_bench
from paddle_tpu_torch.models.gpt_bench import (DIM, HEADS, LAYERS, MAX_LEN,
                                               VOCAB)
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.models import zoo_bench as zb
from paddle_tpu_torch.models.book_chapters import CHAPTERS
from paddle_tpu_torch.models.book_chapters import batches as book_batches
from paddle_tpu_torch.models.book_chapters import (V2_SENTIMENT,
                                                   v2_sentiment_build)
from paddle_tpu_torch.native import recordio
from paddle_tpu_torch.ops.cuda_kernels import _common
from paddle_tpu_torch.ops.cuda_kernels import bn_conv as bnc
from paddle_tpu_torch.ops.cuda_kernels import bn_matmul as bnmm
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa
from paddle_tpu_torch.ops.cuda_kernels import gru as gru_k
from paddle_tpu_torch.ops.cuda_kernels import lstm as lstm_k
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa
from paddle_tpu_torch.parallel import collectives as pcol
from paddle_tpu_torch.parallel import mesh as pmesh
from paddle_tpu_torch.parallel import modes as pmodes
from paddle_tpu_torch.parallel import parallel_executor as pmesh_exe
from paddle_tpu_torch.parallel import ring_attention as tra
from paddle_tpu_torch.ops.registry import EmitContext, get_op_info
from paddle_tpu_torch.ops.transformer_ops import _lm_fns
from paddle_tpu_torch.serving import ServingEngine, pages_needed
from paddle_tpu_torch.trainer.config_parser import set_config_args
from paddle_tpu_torch.v1 import V1Trainer
from paddle_tpu_torch.v1.data_provider import get_data_source
from paddle_tpu_torch.v1.layers import declared_outputs

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,   # CUDA cores: the kernels' FMA loops
              torch.bfloat16: 989e12}
# the dense TF32 rate of the tensor cores, which the f32 flash kernels
# (K1, f32 K4-K6), f32 K3 and the f32 fused BatchNorm backwards and 3x3
# forwards (K12, K13, K14, K15) run on in 3xTF32: three TF32 products per
# f32 product
PEAK_TF32 = 495e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)

# the serving model is gpt_bench's: bench.py's GPT config at _gpt_heads(512)
SLOTS, PAGE, N_REQ, MAX_NEW = 8, 16, 16, 32
NUM_PAGES = SLOTS * pages_needed(MAX_LEN, PAGE) + 1
CHUNK, LANES = 32, 4
SPEC_K, DRAFT_LAYERS = 4, 1
SEED = 0
KERNELS = {"flash_attention": fa.flash_attention,
           "paged_attention": pa.paged_attention,
           "paged_attention_mq": pa.paged_attention_mq,
           "flash_attention_fwd": fa.flash_attention_fwd,
           "flash_attention_dq": fa.flash_attention_dq,
           "flash_attention_dkv": fa.flash_attention_dkv,
           "lstm_forward": lstm_k.lstm_forward,
           "lstm_backward": lstm_k.lstm_backward,
           "gru_forward": gru_k.gru_forward,
           "gru_backward": gru_k.gru_backward,
           "bn_matmul_fwd": bnmm.bn_matmul_fwd,
           "bn_matmul_bwd": bnmm.bn_matmul_bwd,
           "bn_conv3x3_fwd": bnc.bn_conv3x3_fwd,
           "bn_conv3x3_fwd_v2": bnc.bn_conv3x3_fwd_v2,
           "bn_conv3x3_bwd": bnc.bn_conv3x3_bwd}
# the training bench (bench.py bench_gpt_train): batch 8 x 1024, bf16
TRAIN_BS, TRAIN_SEQ = 8, 1024


_T0 = time.monotonic()


def log(tag, obj):
    """One result line; `at_s` is the seconds since the script started."""
    print(f"{tag} {json.dumps({**obj, 'at_s': time.monotonic() - _T0})}",
          flush=True)


def time_ms(fn, iters=20, ahead=True):
    """Mean device time of one call, from CUDA events around `iters` calls
    after a warm-up.  The calls are queued behind a device spin
    (``torch.cuda._sleep``) that lasts longer than the host takes to
    enqueue them, so the events time the kernels back to back and not the
    host's launch rate (for a kernel shorter than its Python wrapper the
    two differ).  The spin doubles until the host stays ahead of it, and
    `iters` halves, because CUDA's launch queue is finite: a host
    that fills it waits for the spin to end.  A call of hundreds of
    launches should pass an `iters` that keeps the whole below about 500.
    With ``ahead=False`` nothing is queued ahead: the events span `iters`
    calls as the host issues them, which for a Python loop of small
    kernels (the recurrent plain versions) is the host's rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not ahead:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.monotonic() - t0) + 0.01
    for _ in range(5):
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles, at up to 2 GHz
        start.record()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        host_s = time.monotonic() - t0
        end.record()
        end.synchronize()
        if host_s < spin_s / 2:
            return start.elapsed_time(end) / iters
        spin_s *= 2
        iters = max(2, iters // 2)
    raise AssertionError(f"time_ms: the host could not enqueue {iters} "
                         f"calls ahead of the device")


def bound(nbytes, flops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the body of each flash kernel by dtype: all run on the tensor cores
# (mma.sync), bf16 in m16n8k16, f32 in 3xTF32
DESIGN = {torch.bfloat16: {"flash_attention": "mma",
                           "flash_attention_fwd": "mma",
                           "flash_attention_dq": "mma",
                           "flash_attention_dkv": "mma"},
          torch.float32: {"flash_attention": "mma_3xtf32",
                          "flash_attention_fwd": "mma_3xtf32",
                          "flash_attention_dq": "mma_3xtf32",
                          "flash_attention_dkv": "mma_3xtf32"}}
# K11-K15: every body runs on the tensor cores (mma.sync), bf16 in
# m16n8k16, f32 in 3xTF32: K11, K12, K15 and bf16 K13 on csrc/bn_mma.cuh's
# 64 x 64 tiles, K14 and f32 K13 on csrc/bn_conv.cu's bnc_fwd_wide
BN_KERNELS = ("bn_matmul_fwd", "bn_matmul_bwd", "bn_conv3x3_fwd",
              "bn_conv3x3_fwd_v2", "bn_conv3x3_bwd")
DESIGN[torch.bfloat16].update(dict.fromkeys(BN_KERNELS, "mma"))
DESIGN[torch.float32].update(dict.fromkeys(BN_KERNELS, "mma_3xtf32"))
# K2 and K3 split a slot's page walk across blocks and stage pages by
# cp.async into rings (csrc/paged_split.cuh); K2 scores on the CUDA cores
# in both dtypes, K3 on the tensor cores (f32 in 3xTF32)
for _dt in DTYPES:
    DESIGN[_dt]["paged_attention"] = "split_kv_cuda_cores"
DESIGN[torch.bfloat16]["paged_attention_mq"] = "split_kv_mma"
DESIGN[torch.float32]["paged_attention_mq"] = "split_kv_mma_3xtf32"


def flash_bound(name, nbytes, flops, dtype):
    """(bound_ms, bound_by, extra fields) of an attention kernel, by its
    body: a 3xTF32 body does three TF32 products per f32 product at the
    tensor cores' TF32 rate, and its log row keeps the CUDA cores' bound of
    the one f32 product beside it; every other body is bounded at its
    dtype's rate."""
    if not DESIGN[dtype][name].endswith("mma_3xtf32"):
        return (*bound(nbytes, flops, dtype), {})
    b_ms, b_by = bound(nbytes, 3 * flops, dtype, peak=PEAK_TF32)
    return b_ms, b_by, {"bound_cuda_cores_ms": bound(nbytes, flops, dtype)[0]}


def ratios(row):
    """The kernel's time over the library call's and the bound's share."""
    row["vs_library"] = row["kernel_ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]


def max_err(a, b):
    return (a.double() - b.double()).abs().max().item()


# -- 1. the card --------------------------------------------------------------

def card():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", {"name": name, "nvidia_smi": smi,
                 "count": torch.cuda.device_count(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    return name, smi


# -- 2. build -----------------------------------------------------------------

def build():
    t0 = time.monotonic()
    so = _common.build()
    _common.load()
    secs = time.monotonic() - t0
    with open(so[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f
                 if any(w in ln for w in ("Function properties", "registers",
                                          "spill", "== "))]
    log("build", {"seconds": secs, "library": so, "ptxas": ptxas})


# -- 3. kernels ---------------------------------------------------------------

def flash_phase(dev):
    """K1 at B in {1, 4}, H 8, D 64, T in {40, 128, 1024}, causal."""
    H, D = HEADS, DIM // HEADS
    rows, summary = [], None
    for dtype in DTYPES:
        for B in (1, 4):
            for T in (40, 128, 1024):
                g = torch.Generator(device=dev).manual_seed(SEED + T + B)
                q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev)
                           .to(dtype) for _ in range(3))
                out = fa.flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                ref = fa.flash_attention_ref(q, k, v, causal=True)
                err = max_err(out, ref)
                itemsize = q.element_size()
                nbytes = 4 * B * H * T * D * itemsize
                flops = 2 * D * T * (T + 1) * B * H  # causal QK^T and PV
                b_ms, b_by, extra = flash_bound("flash_attention", nbytes,
                                                flops, dtype)
                row = {
                    "dtype": str(dtype).split(".")[1], "B": B, "H": H,
                    "T": T, "D": D,
                    "design": DESIGN[dtype]["flash_attention"], **extra,
                    "max_abs_err": err,
                    "kernel_ms": time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=True)),
                    "plain_ms": time_ms(
                        lambda: fa.flash_attention_ref(q, k, v,
                                                       causal=True)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by}
                ratios(row)
                rows.append(row)
                log("flash_attention", row)
                if err > TOL[dtype]:
                    raise AssertionError(
                        f"flash_attention disagrees with its plain version:"
                        f" {row} (tolerance {TOL[dtype]})")
                if dtype == torch.float32 and B == 4 and T == 1024:
                    summary = row
    return rows, summary


def _poison_unseen(kp, vp, pt, cl, ps):
    """Set every pool slot no slot's context can see to 1e9."""
    keep = torch.zeros(kp.shape[0], ps, dtype=torch.bool)
    for n in range(pt.shape[0]):
        L = int(cl[n])
        for j in range(pages_needed(L, ps)):
            keep[int(pt[n, j]), :min(ps, L - j * ps)] = True
    mask = ~keep.to(kp.device)[:, None, :, None]
    return kp.masked_fill(mask, 1e9), vp.masked_fill(mask, 1e9)


# K2's timed cases: the engine's decode step (ragged, 1 to 1024), all 8
# slots at 1024, and one slot alone at 1024 (the case split-KV is for)
PAGED_CASES = {"decode": [1, 17, 1024, 300, 64, 999, 5, 512],
               "full_1024": [1024] * SLOTS,
               "one_1024": [1024]}
# a cold reading rotates each call over distinct pools, one per layer as
# the serve's kpool[i], at least this many and enough to touch COLD_BYTES
# a round: twice the H100's 50 MB L2
COLD_POOLS, COLD_BYTES = LAYERS, 100e6


def page_table(rng, lens, maxp):
    """Distinct random pages of the 513-page pool for each slot's first
    ceil(len / PAGE) entries, null past them (an all-null row for 0)."""
    pt = np.zeros((len(lens), maxp), np.int32)
    perm = iter(rng.permutation(np.arange(1, NUM_PAGES)))
    for n, L in enumerate(lens):
        for j in range(pages_needed(L, PAGE)):
            pt[n, j] = next(perm)
    return torch.from_numpy(pt)


def cold_pools(kp, vp, nbytes):
    """Copies of the pools for a cold reading: COLD_POOLS or more, enough
    that a round through them touches COLD_BYTES of K/V."""
    n = max(COLD_POOLS, -(-int(COLD_BYTES) // int(nbytes)))
    return [(kp.clone(), vp.clone()) for _ in range(n)]


def warm_cold_ms(call, kp, vp, kv_bytes):
    """(warm ms, cold ms, pools) of `call(kp, vp)`: warm, 100 calls on one
    pool (its pages stay in L2); cold, each call on the next of several
    pool copies (``cold_pools``), as a serve's layers each read their own
    pool while the weights pass through L2 between them."""
    warm = time_ms(lambda: call(kp, vp), iters=100)
    pools = cold_pools(kp, vp, kv_bytes)
    n = len(pools)
    cold = time_ms(lambda: [call(k, v) for k, v in pools],
                   iters=max(2, 200 // n)) / n
    del pools
    torch.cuda.empty_cache()
    return warm, cold, n


def paged_case(dev, dtype, ctx, seed=SEED + 1):
    """K2's inputs at the engine's decode shape for ctx_lens `ctx`: q, the
    513-page pools with every slot no context sees poisoned, the table and
    the lengths on the card, and the K/V bytes the call needs."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    pt_t = page_table(np.random.RandomState(SEED), ctx, maxp)
    cl_t = torch.tensor(ctx, dtype=torch.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(len(ctx), nh, dh, generator=g, device=dev).to(dtype)
    kp, vp = (torch.randn(NUM_PAGES, nh, PAGE, dh, generator=g,
                          device=dev).to(dtype) for _ in range(2))
    kp, vp = _poison_unseen(kp, vp, pt_t, cl_t, PAGE)
    kv = sum(ctx) * nh * dh * 2 * q.element_size()
    return q, kp, vp, pt_t.to(dev), cl_t.to(dev), kv


def paged_phase(dev):
    """K2 at the engine's decode shape: nh 8, dh 64, ps 16, maxp 64, the
    engine's 513-page pool, unused slots poisoned; ragged ctx_lens with 1,
    partial pages and 1024 (the 8 slots of a decode step), all 8 slots at
    1024, and one slot alone at 1024; each timed warm and cold."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    rows, summary = [], None
    for case, ctx in PAGED_CASES.items():
        N = len(ctx)
        for dtype in DTYPES:
            q, kp, vp, pt_d, cl_d, kv = paged_case(dev, dtype, ctx)
            out = pa.paged_attention(q, kp, vp, pt_d, cl_d)
            torch.cuda.synchronize()
            ref = pa.paged_attention_ref(q, kp, vp, pt_d, cl_d)
            err = max_err(out, ref)
            if not torch.isfinite(out.float()).all():
                raise AssertionError("paged_attention read a poisoned slot")
            itemsize = q.element_size()
            table = sum(pages_needed(L, PAGE) for L in ctx) * 4 + N * 4
            nbytes = kv + 2 * q.numel() * itemsize + table
            flops = 4 * sum(ctx) * nh * dh
            b_ms, b_by = bound(nbytes, flops, dtype)
            warm, cold, n_pools = warm_cold_ms(
                lambda k, v: pa.paged_attention(q, k, v, pt_d, cl_d), kp,
                vp, kv)
            row = {"case": case, "dtype": str(dtype).split(".")[1], "N": N,
                   "nh": nh, "dh": dh, "ps": PAGE, "maxp": maxp,
                   "pool_pages": NUM_PAGES, "ctx_lens": ctx,
                   "design": DESIGN[dtype]["paged_attention"],
                   "max_abs_err": err, "kernel_ms": warm,
                   "kernel_cold_ms": cold, "cold_pools": n_pools,
                   "plain_ms": time_ms(
                       lambda: pa.paged_attention_ref(q, kp, vp, pt_d,
                                                      cl_d)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / warm,
                   "bound_share_cold": b_ms / cold}
            rows.append(row)
            log("paged_attention", row)
            if err > TOL[dtype]:
                raise AssertionError(
                    f"paged_attention disagrees with its plain version: "
                    f"{row} (tolerance {TOL[dtype]})")
            if dtype == torch.float32 and case == "decode":
                summary = row
            del q, kp, vp, out, ref
    return rows, summary


# -- 4. serve -----------------------------------------------------------------

def serve(lm, prompts, place, scheduler="fifo", priorities=None,
          first_alone=False, **kw):
    """Serve `prompts` on a fresh engine over the global scope's
    parameters.  With `first_alone`, request 0 is submitted and stepped
    once before the others arrive.  Checks that every request finished
    with max_new tokens and that no page leaked (the prefix index let go
    first); returns (tokens per request, requests, engine, wall
    seconds)."""
    eng = ServingEngine(lm, max_batch_size=SLOTS, page_size=PAGE,
                        place=place, scheduler=scheduler, **kw)
    pri = priorities or [0] * len(prompts)
    t0 = time.monotonic()
    rids = [eng.submit(prompts[0], MAX_NEW, arrival=t0, priority=pri[0])]
    if first_alone:
        eng.step()
    rids += [eng.submit(p, MAX_NEW, arrival=t0, priority=pr)
             for p, pr in zip(prompts[1:], pri[1:])]
    fin = eng.run()
    wall = time.monotonic() - t0
    if sorted(fin) != sorted(rids):
        raise AssertionError("not every request finished")
    if any(len(fin[r].generated) != MAX_NEW for r in rids):
        raise AssertionError("a request finished short of max_new")
    eng.cache.prefix.clear()
    if eng.cache.allocator.available() != eng.num_pages - 1:
        raise AssertionError(f"page leak: {eng.stats()['page_stats']}")
    return [fin[r].generated for r in rids], [fin[r] for r in rids], eng, wall


def counted(fn):
    """Run `fn` with every kernel's launch count set to 0 just before;
    returns (its result, the counts just after)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in KERNELS.items()}


def check_launches(path, launches, want):
    """`want` names the kernels the path runs; every other kernel must
    stay at 0."""
    want = {k: want.get(k, 0) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches} != what "
                             f"the engine's counts imply {want}")
    used = [k for k, v in want.items() if v]
    if not used:
        raise AssertionError(f"{path}: no kernel launched")


def no_launches(path, launches):
    """A path that reaches no port kernel launched none."""
    if any(launches.values()):
        raise AssertionError(f"{path}: a path that reaches no port kernel "
                             f"launched {launches}")


def serve_row(scheduler, prompts, tokens, reqs, eng, wall, launches):
    """One serve's numbers: TTFT over the requests (all submitted at t0),
    prefill tokens per second of the runs that carry prefill (fifo:
    prefill runs; v2/spec: mixed runs, which also decode), decoded tokens
    per second of the runs that emit them, steps and launches."""
    st = eng.stats()
    ttft = sorted(r.first_token_t - r.arrival for r in reqs)
    decoded = sum(len(t) - 1 for t in tokens)
    if scheduler == "fifo":
        pre_s, dec_s = st["prefill_s"], st["decode_s"]
    else:
        pre_s = st["mixed_s"]
        dec_s = st["mixed_s"] + st["decode_s"] + st["draft_s"] \
            + st["verify_s"]
    return {"scheduler": scheduler, "requests": len(prompts),
            "prompt_tokens": sum(len(p) for p in prompts),
            "max_new": MAX_NEW, "wall_s": wall,
            "ttft_p50_ms": float(np.median(ttft)) * 1e3,
            "ttft_max_ms": ttft[-1] * 1e3,
            "prefill_tok_s": st["prefill_computed"] / pre_s,
            "decode_tok_s": decoded / dec_s,
            "output_tok_s": sum(len(t) for t in tokens) / wall,
            "steps": eng._steps,
            **{k: st[k] for k in (
                "prefill_runs", "decode_steps", "mixed_steps",
                "spec_rounds", "draft_runs", "prefill_computed",
                "prefill_cached", "cow_copies", "preemptions",
                "spec_drafted", "spec_accepted", "spec_emitted",
                "prefill_s", "decode_s", "mixed_s", "draft_s",
                "verify_s")},
            "launches": launches,
            "launches_per_request": {k: v / len(prompts)
                                     for k, v in launches.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_phase(dev, card_name, smi):
    t0 = time.monotonic()
    lm = gpt_bench.build(fluid.CUDAPlace(0), seed=SEED)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    scope = fluid.global_scope()
    n_params = sum(scope.find(p.name).numel() for p in lm._params)
    if any(scope.find(p.name).device != dev for p in lm._params):
        raise AssertionError("startup left a parameter off the card")

    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    serve(lm, prompts, fluid.CUDAPlace(0))  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, fluid.CUDAPlace(0)))
    st = eng.stats()
    check_launches("fifo", launches, {
        "flash_attention": LAYERS * st["prefill_runs"],
        "paged_attention": LAYERS * st["decode_steps"],
        "paged_attention_mq": 0})
    buckets = sorted(eng._prefill_progs)
    if not {256, 512, 1024} <= set(buckets):
        raise AssertionError(f"prefill buckets {buckets} miss 256/512/1024")
    row = serve_row("fifo", prompts, tokens, reqs, eng, wall, launches)
    log("serve", {"card": card_name, "nvidia_smi": smi, "params": n_params,
                  "startup_s": startup_s,
                  "prompt_lens": [len(p) for p in prompts],
                  "prefill_buckets": buckets, **row})
    arrays = [scope.find_np(p.name) for p in lm._params]
    return lm, prompts, tokens, arrays, row


# -- 5. the same weights on the CPU -------------------------------------------

def cpu_scope(lm, arrays):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        lm.load_params(arrays, scope)
    return scope


def cpu_top2_gap(lm, scope, seq):
    """Gap between the CPU model's two largest next-token logits after
    `seq`, from a full-prefix forward through the port's layer code and
    the plain attention."""
    with fluid.program_guard(fluid.Program()):
        slots = lm._decode_inputs(
            fluid.layers.data("gap.tok", shape=[1], dtype="int64"))
    ins = {s: [scope.find(n) for n in names]
           for s, names in slots.items() if s != "Tokens"}
    fns = _lm_fns(ins, HEADS, 1e-5)
    tok = torch.tensor([seq], dtype=torch.int64)
    scale = 1.0 / fns.dh ** 0.5
    with torch.no_grad():
        x = ins["Emb"][0][tok] + fns.pos[:len(seq)]
        for i in range(fns.L):
            x = fns.block(i, x, lambda i, q, k, v: fa.flash_attention_ref(
                q, k, v, causal=True, scale=scale))
        top = fns.head_logits(x)[0].topk(2).values
    return (top[0] - top[1]).item()


def agree(tag, lm, gap_scope, prompts, want, got, **extra):
    """Hold `got` to `want`: identical, except at most one request that
    parts where the CPU model's top-2 logits are within 1e-3."""
    parted = []
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = cpu_top2_gap(lm, gap_scope, prompts[i] + a[:j])
        parted.append({"request": i, "position": j, "want": a[j],
                       "got": b[j], "cpu_top2_gap": gap})
    res = {"identical": len(want) - len(parted), "of": len(want),
           "parted": parted, **extra}
    log(tag, res)
    if len(parted) > 1 or any(p["cpu_top2_gap"] > 1e-3 for p in parted):
        raise AssertionError(f"{tag}: tokens disagree: {parted}")
    return res


def cpu_phase(lm, prompts, gpu_tokens, scope):
    t0 = time.monotonic()
    with fluid.scope_guard(scope):
        cpu_tokens, _, _, _ = serve(lm, prompts, fluid.CPUPlace())
    agree("cpu_agreement", lm, scope, prompts, cpu_tokens, gpu_tokens,
          cpu_s=time.monotonic() - t0)


# -- 6. kernel K3 -------------------------------------------------------------

def mq_phase(dev):
    """K3 at the mixed step's shape (N 4 chunk lanes, C 32) and the spec
    verify's (N 8, C 5): nh 8, dh 64, ps 16, maxp 64, the 513-page pool.
    Each lane is (q_start, valid rows); ctx_lens = max(q_start + rows, 1),
    as the chunk op passes them."""
    nh, dh = HEADS, DIM // HEADS
    maxp = pages_needed(MAX_LEN, PAGE)
    shapes = {
        # rows past the chunk at the end of a system prompt, a mid-page
        # start whose chunk crosses a page, an idle lane, a lane near 1024
        "mixed": (32, [(576, 20), (200, 32), (0, 0), (990, 32)]),
        # verify rows k+1 = 5 (fewer where the window shrank), a chunk
        # crossing a page, a lane near 1024, an idle lane
        "verify": (5, [(1, 5), (14, 5), (1019, 5), (300, 3), (64, 5),
                       (999, 1), (5, 2), (0, 0)]),
    }
    rng = np.random.RandomState(SEED + 2)
    rows, summary = [], {}
    for shape, (C, lanes) in shapes.items():
        N = len(lanes)
        q0 = [s for s, _ in lanes]
        ctx = [max(s + n, 1) for s, n in lanes]
        # an idle lane keeps its all-null table row
        pt_t = page_table(rng, [L if n else 0 for L, (_, n) in
                                zip(ctx, lanes)], maxp)
        cl_t = torch.tensor(ctx, dtype=torch.int32)
        for dtype in DTYPES:
            g = torch.Generator(device=dev).manual_seed(SEED + 3)
            q = torch.randn(N, nh, C, dh, generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn(NUM_PAGES, nh, PAGE, dh, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            kp, vp = _poison_unseen(kp, vp, pt_t, cl_t, PAGE)
            pt_d, cl_d = pt_t.to(dev), cl_t.to(dev)
            q0_d = torch.tensor(q0, dtype=torch.int32, device=dev)
            args = (q, kp, vp, pt_d, cl_d, q0_d)
            out = pa.paged_attention_mq(*args)
            torch.cuda.synchronize()
            ref = pa.paged_attention_mq_ref(*args)
            err = max_err(out, ref)
            if not torch.isfinite(out.float()).all():
                raise AssertionError("paged_attention_mq read a poisoned "
                                     "slot or left a row unnormalized")
            itemsize = q.element_size()
            # keys some row needs: below min(ctx, q_start + C); each
            # (row, key) pair visible to the row is 4*dh FLOPs per head
            needed = [min(L, s + C) for L, s in zip(ctx, q0)]
            kv = sum(needed) * nh * dh * 2 * itemsize
            table = sum(pages_needed(k, PAGE) for k in needed) * 4 + N * 8
            nbytes = kv + 2 * q.numel() * itemsize + table
            pairs = sum(min(s + c + 1, L) for L, s in zip(ctx, q0)
                        for c in range(C))
            flops = 4 * dh * nh * pairs
            b_ms, b_by, extra = flash_bound("paged_attention_mq", nbytes,
                                            flops, dtype)
            warm, cold, n_pools = warm_cold_ms(
                lambda k, v: pa.paged_attention_mq(q, k, v, *args[3:]), kp,
                vp, kv)
            row = {"shape": shape, "dtype": str(dtype).split(".")[1],
                   "N": N, "nh": nh, "C": C, "dh": dh, "ps": PAGE,
                   "maxp": maxp, "pool_pages": NUM_PAGES,
                   "q_starts": q0, "ctx_lens": ctx,
                   "design": DESIGN[dtype]["paged_attention_mq"], **extra,
                   "max_abs_err": err, "kernel_ms": warm,
                   "kernel_cold_ms": cold, "cold_pools": n_pools,
                   "plain_ms": time_ms(
                       lambda: pa.paged_attention_mq_ref(*args)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / warm,
                   "bound_share_cold": b_ms / cold}
            rows.append(row)
            log("paged_attention_mq", row)
            if err > TOL[dtype]:
                raise AssertionError(
                    f"paged_attention_mq disagrees with its plain version: "
                    f"{row} (tolerance {TOL[dtype]})")
            if dtype == torch.float32:
                summary[shape] = row
    return rows, summary


# -- 7. v2 serve --------------------------------------------------------------

V2 = dict(scheduler="v2", chunk_size=CHUNK, chunk_lanes=LANES)


def v2_want(st):
    return {"flash_attention": 0,
            "paged_attention": LAYERS * (st["mixed_steps"]
                                         + st["decode_steps"]),
            "paged_attention_mq": LAYERS * st["mixed_steps"]}


def v2_phase(lm, prompts, fifo_tokens, scope_cpu):
    card = fluid.CUDAPlace(0)
    serve(lm, prompts, card, **V2)  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, card, **V2))
    check_launches("v2", launches, v2_want(eng.stats()))
    row = serve_row("v2", prompts, tokens, reqs, eng, wall, launches)
    row["watermark_pages"] = eng.scheduler.watermark_pages
    log("serve_v2", row)
    agree("v2_vs_fifo", lm, scope_cpu, prompts, fifo_tokens, tokens)

    # prefix-heavy traffic: hits and copy-on-write, against the CPU
    pprompts = gpt_bench.prefix_prompts(N_REQ, seed=SEED)
    (ptok, preqs, peng, pwall), plaunch = counted(
        lambda: serve(lm, pprompts, card, **V2))
    pst = peng.stats()
    check_launches("v2_prefix", plaunch, v2_want(pst))
    if not (pst["prefill_cached"] > 0 and pst["cow_copies"] > 0):
        raise AssertionError(f"prefix set: no prefix hit or no COW copy: "
                             f"{pst}")
    prow = serve_row("v2", pprompts, ptok, preqs, peng, pwall, plaunch)
    log("serve_v2_prefix", prow)
    t0 = time.monotonic()
    with fluid.scope_guard(scope_cpu):
        cpu_tok, _, ceng, _ = serve(lm, pprompts, fluid.CPUPlace(), **V2)
    agree("v2_prefix_vs_cpu", lm, scope_cpu, pprompts, cpu_tok, ptok,
          cpu_s=time.monotonic() - t0,
          cpu_prefill_cached=ceng.stats()["prefill_cached"])

    # preemption: a low-priority request, then a high-priority burst into
    # a pool of 64 pages; the same arrivals in the roomy pool
    burst = [prompts[0][:300]] + [p[:200] for p in prompts[1:8]]
    pri = [0] + [1] * 7
    (ttok, _, teng, _), tlaunch = counted(lambda: serve(
        lm, burst, card, priorities=pri, first_alone=True, num_pages=64,
        **V2))
    check_launches("v2_tight", tlaunch, v2_want(teng.stats()))
    if teng.stats()["preemptions"] < 1:
        raise AssertionError("the tight pool preempted nothing")
    rtok, _, _, _ = serve(lm, burst, card, priorities=pri, first_alone=True,
                          **V2)
    agree("v2_preempt_vs_roomy", lm, scope_cpu, burst, rtok, ttok,
          preemptions=teng.stats()["preemptions"],
          watermark_pages=teng.scheduler.watermark_pages)
    return row, prow, launches


# -- 8. spec serve ------------------------------------------------------------

def spec_phase(lm, prompts):
    card = fluid.CUDAPlace(0)
    scope = fluid.global_scope()
    gpt_bench.damp_tail_layers(lm, scope, DRAFT_LAYERS, scale=0.01)
    damped_cpu = cpu_scope(lm, [scope.find_np(p.name) for p in lm._params])
    v2_tok, _, _, _ = serve(lm, prompts, card, **V2)
    spec = dict(V2, scheduler="spec", spec_k=SPEC_K,
                spec_draft_layers=DRAFT_LAYERS)
    serve(lm, prompts, card, **spec)  # warm-up
    (tokens, reqs, eng, wall), launches = counted(
        lambda: serve(lm, prompts, card, **spec))
    st = eng.stats()
    check_launches("spec", launches, {
        "flash_attention": 0,
        "paged_attention": LAYERS * (st["mixed_steps"] + st["decode_steps"])
        + DRAFT_LAYERS * SPEC_K * st["draft_runs"],
        "paged_attention_mq": LAYERS * (st["mixed_steps"]
                                        + st["spec_rounds"])})
    if st["spec_accepted"] < 1:
        raise AssertionError(f"spec accepted no draft: {st}")
    row = serve_row("spec", prompts, tokens, reqs, eng, wall, launches)
    row["accept_rate_damped_random_model"] = (st["spec_accepted"]
                                              / max(st["spec_drafted"], 1))
    log("serve_spec", row)
    agree("spec_vs_v2_damped", lm, damped_cpu, prompts, v2_tok, tokens)
    return row, launches


# -- 10. kernels K4-K6 --------------------------------------------------------

TRAIN_SHAPES = [  # (B, H, T, D, causal, timed)
    (TRAIN_BS, HEADS, TRAIN_SEQ, DIM // HEADS, True, True),
    (2, 4, 1000, 64, True, False),
    (2, 4, 1000, 64, False, False),
    (2, 4, 512, 128, True, False),
    (1, 1, 37, 40, True, False),     # one short ragged tile, D padded to 64
    (64, 16, 128, 64, True, False),  # B*H = 1024 blocks along grid.y
    (1, 2, 77, 38, True, False),     # d % 4 != 0: staged element by element
]


def rel_err(got, ref):
    ref = ref.double()
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def train_kernel_phase(dev):
    """K4 (out, lse), K5 (dq) and K6 (dk, dv) against their plain
    versions; the plain backward takes the plain forward's out and lse,
    so each kernel sees the same inputs as its plain version."""
    rows = {"flash_attention_fwd": [], "flash_attention_dq": [],
            "flash_attention_dkv": []}
    summary = {}
    for dtype in DTYPES:
        for B, H, T, D, causal, timed in TRAIN_SHAPES:
            g = torch.Generator(device=dev).manual_seed(SEED + T + D)
            q, k, v, do = (torch.randn(B, H, T, D, generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            r_out, r_lse = fa.flash_attention_fwd_ref(q, k, v, causal=causal)
            delta = (r_out.float() * do.float()).sum(-1).reshape(B * H, T)
            bwd = (q, k, v, do, r_lse, delta)
            dq = fa.flash_attention_dq(*bwd, causal=causal)
            dk, dv = fa.flash_attention_dkv(*bwd, causal=causal)
            torch.cuda.synchronize()
            r_dq = fa.flash_attention_dq_ref(*bwd, causal=causal)
            r_dk, r_dv = fa.flash_attention_dkv_ref(*bwd, causal=causal)
            shape = {"dtype": str(dtype).split(".")[1], "B": B, "H": H,
                     "T": T, "D": D, "causal": causal}
            itemsize = q.element_size()
            tensor_bytes = B * H * T * D * itemsize
            row_bytes = B * H * T * 4
            pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
            checks = {
                "flash_attention_fwd": (
                    {"max_abs_err": max_err(out, r_out),
                     "lse_max_abs_err": max_err(lse, r_lse)},
                    4 * tensor_bytes + row_bytes, 4 * D * pairs),
                "flash_attention_dq": (
                    {"max_abs_err": max_err(dq, r_dq),
                     "max_rel_err": rel_err(dq, r_dq)},
                    5 * tensor_bytes + 2 * row_bytes, 6 * D * pairs),
                "flash_attention_dkv": (
                    {"max_abs_err": max(max_err(dk, r_dk),
                                        max_err(dv, r_dv)),
                     "max_rel_err": max(rel_err(dk, r_dk),
                                        rel_err(dv, r_dv))},
                    6 * tensor_bytes + 2 * row_bytes, 8 * D * pairs),
            }
            for name, (errs, nbytes, flops) in checks.items():
                b_ms, b_by, extra = flash_bound(name, nbytes, flops, dtype)
                rows[name].append({**shape, "design": DESIGN[dtype][name],
                                   **extra, **errs, "bound_ms": b_ms,
                                   "bound_by": b_by})
            if timed:
                timed_rows(q, k, v, do, bwd, causal, rows)
                for name in rows:
                    ratios(rows[name][-1])
            for name in rows:
                log(name, rows[name][-1])
            fwd = rows["flash_attention_fwd"][-1]
            worst = max(rows["flash_attention_dq"][-1]["max_rel_err"],
                        rows["flash_attention_dkv"][-1]["max_rel_err"])
            if (fwd["max_abs_err"] > TOL[dtype]
                    or fwd["lse_max_abs_err"] > 1e-4 or worst > TOL[dtype]):
                raise AssertionError(
                    f"a training kernel disagrees with its plain version at "
                    f"{shape}: out/lse {fwd}, grads {worst} (tolerance "
                    f"{TOL[dtype]}: out absolute, grads relative to max "
                    f"|g|; lse 1e-4)")
            if timed and dtype == torch.bfloat16:
                summary = {n: rows[n][-1] for n in rows}
    return rows, summary


def timed_rows(q, k, v, do, bwd, causal, rows):
    """Kernel, plain and library times at the bench shape, added to the
    last row of each kernel."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), iters=10)
    times = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
            lambda: fa.flash_attention_fwd_ref(q, k, v, causal=causal),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(*bwd, causal=causal),
            lambda: fa.flash_attention_dq_ref(*bwd, causal=causal),
            lib_bwd),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(*bwd, causal=causal),
            lambda: fa.flash_attention_dkv_ref(*bwd, causal=causal),
            lib_bwd),
    }
    for name, (kern, plain, lib) in times.items():
        rows[name][-1].update({"kernel_ms": time_ms(kern),
                               "plain_ms": time_ms(plain, iters=5),
                               "library_ms": lib})


# -- 11. training parity, f32 --------------------------------------------------

PARITY_BS, PARITY_SEQ = 2, 256
TRAIN_KERNELS = ("flash_attention", "flash_attention_fwd",
                 "flash_attention_dq", "flash_attention_dkv")


def train_program(seq, dtype):
    """The full-width GPT training program (bench.py's config at dim 512:
    8 heads) in fresh default programs and scope; returns (loss, main,
    startup)."""
    fluid.reset()
    loss = transformer.build_lm_train_program(
        seq_len=seq, vocab_size=VOCAB, dim=DIM, n_layers=LAYERS,
        n_heads=HEADS, dtype=dtype, learning_rate=3e-4)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def train_batch(bs, seq, seed=0):
    """bench.py's batch: tokens from RandomState(seed) (bench.py: 0),
    targets shifted."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (bs, seq, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def per_step_want():
    return {"flash_attention_fwd": 2 * LAYERS, "flash_attention_dq": LAYERS,
            "flash_attention_dkv": LAYERS}


def run_steps(exe, main, loss, feed, n, fetch=(), scope=None):
    """`n` training steps; per step (loss, the fetched grads (step 1
    only), the kernels' launches in that step, host seconds to the fetched
    loss).  The counts are read as differences: nothing is reset here."""
    out = []
    for step in range(n):
        names = list(fetch) if step == 0 else []
        before = {k: f.launches for k, f in KERNELS.items()}
        t0 = time.monotonic()
        vals = exe.run(main, feed=feed, fetch_list=[loss] + names,
                       scope=scope)
        secs = time.monotonic() - t0
        out.append((float(vals[0][0]), dict(zip(names, vals[1:])),
                    {k: f.launches - before[k] for k, f in KERNELS.items()},
                    secs))
    return out


def parity_run(tag, main, startup, loss, feed, grads, want, shape,
               state_names=(), state_step=3, loss_tol=(1e-4,) * 3,
               grad_tol=None, fetched=None):
    """Three steps of `main` on the card and three on an explicit CPU
    executor from the same numpy state (the card's startup values): each
    step's loss within `loss_tol` relative (1e-4), the step-1 `grads`
    within `grad_tol` of their max |g| (1e-3 each unless the dict says
    otherwise), the persistable `state_names` after step `state_step`
    within 1e-3 of their max |value|, and in every step exactly the
    launches `want` (none at all where `want` is empty: a path that
    reaches no port kernel).  The card's step-1 fetches of `grads` go
    into the dict `fetched` when one is given."""
    grad_tol = {n: (grad_tol or {}).get(n, 1e-3) for n in grads}
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    scope = fluid.global_scope()
    state = {n: scope.find_np(n) for n, v in main.global_block().vars.items()
             if v.persistable}

    def steps(exe, sc):
        first = run_steps(exe, main, loss, feed, state_step, grads, scope=sc)
        snap = {n: (sc or fluid.global_scope()).find_np(n)
                for n in state_names}
        return first + run_steps(exe, main, loss, feed, 3 - state_step,
                                 scope=sc), snap

    gpu, gpu_state = steps(card, None)
    for _, _, launches, _ in gpu:
        if want:
            check_launches(tag, launches, want)
        else:
            no_launches(tag, launches)
    if fetched is not None:
        fetched.update(gpu[0][1])
    t0 = time.monotonic()
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, state, cpu_scope)
    cpu, cpu_state = steps(fluid.Executor(fluid.CPUPlace()), cpu_scope)
    cpu_s = time.monotonic() - t0
    loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(gpu, cpu)]
    grad_rel = {n: float(np.abs(gpu[0][1][n] - cpu[0][1][n]).max()
                         / np.abs(cpu[0][1][n]).max()) for n in grads}
    state_rel = {n: float(np.abs(gpu_state[n] - cpu_state[n]).max()
                          / max(np.abs(cpu_state[n]).max(), 1e-12))
                 for n in state_names}
    res = {**shape, "dtype": "float32",
           "gpu_losses": [r[0] for r in gpu],
           "cpu_losses": [r[0] for r in cpu], "loss_rel_err": loss_rel,
           "loss_tol": list(loss_tol),
           "grad_rel_err_step1": grad_rel, "grad_tol": grad_tol,
           "state_rel_err_max": max(state_rel.values(), default=0.0),
           "state_after_step": state_step,
           "launches_per_step": gpu[-1][2],
           "gpu_step_s": [r[3] for r in gpu], "cpu_s": cpu_s}
    log(tag, res)
    if (any(e > t for e, t in zip(loss_rel, loss_tol))
            or any(grad_rel[n] > grad_tol[n] for n in grads)
            or res["state_rel_err_max"] > 1e-3):
        worst = sorted(state_rel.items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"{tag}: card and CPU training disagree: {res} "
                             f"worst state {worst} (state 1e-3 of max "
                             f"|value|)")
    return res


def train_parity_phase():
    loss, main, startup = train_program(PARITY_SEQ, "float32")
    params = [p.name for p in main.global_block().all_parameters()]
    # the embedding, the first layer's WQ, the head
    grads = [n + "@GRAD" for n in (params[0], params[4], params[-1])]
    return parity_run("train_parity", main, startup, loss,
                      train_batch(PARITY_BS, PARITY_SEQ), grads,
                      per_step_want(), {"bs": PARITY_BS, "seq": PARITY_SEQ})


# -- 12. bf16 training at the bench shape -------------------------------------

def train_bench_phase(card_name, smi):
    t0 = time.monotonic()
    loss, main, startup = train_program(TRAIN_SEQ, "bfloat16")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    want = {k: 10 * v for k, v in per_step_want().items()}
    check_launches("train_bf16", launches, want)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    res = {"card": card_name, "nvidia_smi": smi, "bs": TRAIN_BS,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", "lr": 3e-4,
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "startup_s": startup_s, "losses": losses,
           "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "tok_s": TRAIN_BS * TRAIN_SEQ / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log("train_bench", res)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 training: losses {losses} are not "
                             f"finite or did not fall")
    return res


# -- 13. kernels K7-K10 -------------------------------------------------------

# (B, T, H, lengths or "full"/"ragged", timed)
RNN_AWKWARD = [(5, 7, 96, "ragged", False), (1, 9, 96, [6], False),
               (3, 5, 20, [5, 0, 3], False)]
LSTM_SHAPES = [
    (rnn_bench.LSTM_BS, rnn_bench.LSTM_SEQ, rnn_bench.LSTM_HIDDEN, "full",
     True),
    (rnn_bench.LSTM_BS, rnn_bench.LSTM_SEQ, rnn_bench.LSTM_HIDDEN, "ragged",
     False),
    *RNN_AWKWARD,
    # 10 batch groups x 32 column slices, more blocks than an H100 holds at
    # once: the persistent grid runs the groups a few at a time
    (160, 6, 512, "ragged", False),
    # widths whose W slice does not fit in a block's shared memory on an
    # H100 (lstm.route): H 528 the f32 backward (the f32 forward and bf16
    # fit), H 1152 both directions in both dtypes take the step route
    (4, 5, 528, "ragged", False),
    (4, 5, 1152, "ragged", False),
]
GRU_SHAPES = [(rnn_bench.NMT_BS, rnn_bench.NMT_SEQ, rnn_bench.NMT_DIM, ln, tm)
              for _, _, _, ln, tm in LSTM_SHAPES[:2]] + RNN_AWKWARD + [
    # 10 batch groups x 32 column slices, more blocks than an H100 holds at
    # once: the persistent grid runs the groups a few at a time
    (160, 6, 512, "ragged", False)]
# and at run time the widths whose W slice does not fit in a block's shared
# memory on the card (gru.steps_widths)
NO_LIBRARY = ("null: no single PyTorch call computes it (cuDNN's LSTM takes "
              "the input product in and no per-step mask; PyTorch's GRU "
              "applies the reset gate after the candidate product)")


# each recurrent cell's kernels as its module's ``KERNELS`` names them, by
# direction: each route's time-loop kernels, and the backward's dW kernels,
# launched after either loop (the LSTM's bf16 persistent route has its own)
RNN_KERNELS = {
    "lstm": {False: ({"persistent": ("lstm_fwd_persistent",),
                      "steps": ("lstm_fwd_step",)}, ()),
             True: ({"persistent": ("lstm_bwd_persistent",),
                     "steps": ("lstm_bwd_gates", "lstm_bwd_dh")},
                    ("lstm_dw_mma", "rnn_dw_kernel"))},
    "gru": {False: ({"persistent": ("gru_fwd_persistent",),
                     "steps": ("gru_gates", "gru_fwd_cand")}, ()),
            True: ({"persistent": ("gru_bwd_persistent",),
                    "steps": ("gru_gates", "gru_bwd_cand", "gru_bwd_drh",
                              "gru_bwd_dh")},
                   ("rnn_dw_kernel",))}}


def rnn_launches(kind, route, T):
    """(forward, backward) device launches of one call: K7 1 or T, K8 the
    loop and dW, 2 or 2T + 1; K9 1 or 2T, K10 the loop and dW's two, 3 or
    4T + 2."""
    if kind == "lstm":
        return (1, 2) if route == "persistent" else (T, 2 * T + 1)
    return (1, 3) if route == "persistent" else (2 * T, 4 * T + 2)


def kernels_launched(mod, dev, fn):
    """(fn's result, {kernel name: launches}) of one call of `fn`: the
    device launches of the cell's kernels that the kernel library counted
    during the call, where it launched each (``mod.device_launches``,
    `mod` the ``lstm`` or ``gru`` kernel module)."""
    before = mod.device_launches(dev)
    out = fn()
    after = mod.device_launches(dev)
    return out, {k: n - before[k] for k, n in after.items() if n > before[k]}


def rnn_body(kind, counts, backward):
    """(route, device launches) of one call of the `kind` ("lstm" or
    "gru") kernel of that direction, read from `counts`, {kernel name:
    launches} of the kernels it launched (``kernels_launched``; a name may
    be the profiler's, which holds the kernel's own): the route whose loop
    kernels ran, and the launches of those and of the dW kernels.  Raises
    unless exactly one route's loop kernels ran."""
    loops, dw = RNN_KERNELS[kind][backward]

    def launched(names):
        return sum(c for name, c in counts.items()
                   if any(k in name for k in names))

    n = {body: launched(names) for body, names in loops.items()}
    ran = [body for body, c in n.items() if c]
    if len(ran) != 1:
        raise AssertionError(f"a {kind} {'backward' if backward else 'forward'}"
                             f" call ran the loop kernels of "
                             f"{ran or 'no route'}: {counts}")
    return ran[0], n[ran[0]] + launched(dw)


def rnn_case(dev, dtype, gates, B, T, H, lengths):
    g = torch.Generator(device=dev).manual_seed(SEED + B + T + H)
    rng = np.random.RandomState(SEED + B + T)
    if lengths == "full":
        lengths = [T] * B
    elif lengths == "ragged":
        lengths = rng.randint(1, T + 1, (B,)).tolist()

    def f(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    return {"x": f(B, T, gates * H, scale=0.3), "h0": f(B, H, scale=0.2),
            "c0": f(B, H, scale=0.2), "w": f(H, gates * H, scale=0.05),
            "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
            "dhs": f(B, T, H), "dcs": f(B, T, H), "steps": sum(lengths)}


def rnn_bound(gates, a, B, T, H, backward, dtype):
    """The card's bound for one call: each input read once and each output
    written once, and 2*gates*H^2 flops per valid (row, step) forward,
    three times that backward (recompute, dg W^T, dW).  It ignores that
    the T steps depend on each other."""
    size = a["x"].element_size()
    n_states = 2 if gates == 4 else 1  # (h, c) or h
    big, seq, st = B * T * gates * H, B * T * H, B * H
    if backward:
        # x, saved states, their cotangents, dx; w, dw; h0/c0 and dh0/dc0
        elems = 2 * big + 2 * n_states * seq + 2 * gates * H * H \
            + 2 * n_states * st
    else:
        # x, the states out; w; h0/c0 and hT/cT
        elems = big + n_states * seq + gates * H * H + 2 * n_states * st
    flops = 2 * gates * H * H * a["steps"] * (3 if backward else 1)
    return bound(elems * size + B * 4, flops, dtype)


def recurrent_kernel_phase(dev):
    """K7/K8 (LSTM) and K9/K10 (GRU) against their plain versions; the
    plain backward takes the plain forward's saved states, so each kernel
    sees the same inputs as its plain version."""
    rows = {k: [] for k in ("lstm_forward", "lstm_backward", "gru_forward",
                            "gru_backward")}
    gru_shapes = GRU_SHAPES + [(4, 5, H, "ragged", False)
                               for H in gru_k.steps_widths(dev)]
    for kind, gates, shapes in (("lstm", 4, LSTM_SHAPES),
                                ("gru", 3, gru_shapes)):
        mod = lstm_k if kind == "lstm" else gru_k
        fwd, bwd = (getattr(mod, f"{kind}_{d}") for d in ("forward",
                                                          "backward"))
        fwd_ref, bwd_ref = (getattr(mod, f"{kind}_{d}_ref")
                            for d in ("forward", "backward"))
        for dtype in DTYPES:
            for B, T, H, lengths, timed in shapes:
                a = rnn_case(dev, dtype, gates, B, T, H, lengths)
                if kind == "lstm":
                    ins = (a["x"], a["h0"], a["c0"], a["w"], a["lengths"])
                    cts = (a["dhs"], a["dcs"])
                else:
                    ins = (a["x"], a["h0"], a["w"], a["lengths"])
                    cts = (a["dhs"],)
                got, k_f = kernels_launched(mod, dev, lambda: fwd(*ins))
                ref = fwd_ref(*ins)
                saved = ref[:len(cts)]  # (hs, cs) or (hs,)
                grads, k_b = kernels_launched(
                    mod, dev, lambda: bwd(*ins, *saved, *cts))
                ref_g = bwd_ref(*ins, *saved, *cts)
                shape = {"dtype": str(dtype).split(".")[1], "B": B, "T": T,
                         "H": H, "valid_steps": a["steps"],
                         "lengths": lengths if isinstance(lengths, str)
                         else "given"}
                f_row = {**shape, "max_abs_err": max(
                    max_err(g, r) for g, r in zip(got, ref))}
                b_row = {**shape,
                         "max_abs_err": max(max_err(g, r)
                                            for g, r in zip(grads, ref_g)),
                         "max_rel_err": max(rel_err(g, r)
                                            for g, r in zip(grads, ref_g))}
                for row, back in ((f_row, False), (b_row, True)):
                    row["bound_ms"], row["bound_by"] = rnn_bound(
                        gates, a, B, T, H, back, dtype)
                    row["bound_ignores"] = "the dependence between steps"
                    row["library_ms"] = None
                # the route and device launches the library counted; the
                # route must be the one the module's route names before the
                # launch, with its launches (rnn_launches)
                for row, back, counts in ((f_row, False, k_f),
                                          (b_row, True, k_b)):
                    body, n = rnn_body(kind, counts, back)
                    want = mod.route(a["x"], backward=back)
                    want_n = rnn_launches(kind, want, T)[back]
                    row.update({"route": body, "device_launches": n})
                    if (body, n) != (want, want_n):
                        raise AssertionError(
                            f"{kind} {'backward' if back else 'forward'}"
                            f" at {shape}: ran {body} in {n} launches, "
                            f"{kind}.route chose {want} ({want_n})")
                n_f, n_b = f_row["device_launches"], b_row["device_launches"]
                if timed:
                    # the plain versions are Python loops of about a dozen
                    # small kernels a step, timed at the rate the host
                    # issues them
                    f_row.update({
                        "kernel_ms": time_ms(lambda: fwd(*ins),
                                             iters=max(2, 400 // n_f)),
                        "plain_ms": time_ms(lambda: fwd_ref(*ins), iters=3,
                                            ahead=False),
                        "plain_ms_includes": "the host's launch rate"})
                    b_row.update({
                        "kernel_ms": time_ms(
                            lambda: bwd(*ins, *saved, *cts),
                            iters=max(2, 400 // n_b)),
                        "plain_ms": time_ms(
                            lambda: bwd_ref(*ins, *saved, *cts), iters=3,
                            ahead=False),
                        "plain_ms_includes": "the host's launch rate"})
                rows[f"{kind}_forward"].append(f_row)
                rows[f"{kind}_backward"].append(b_row)
                log(f"{kind}_forward", f_row)
                log(f"{kind}_backward", b_row)
                if (f_row["max_abs_err"] > TOL[dtype]
                        or b_row["max_rel_err"] > TOL[dtype]):
                    raise AssertionError(
                        f"a {kind} kernel disagrees with its plain version "
                        f"at {shape}: forward {f_row['max_abs_err']}, "
                        f"gradients {b_row['max_rel_err']} (tolerance "
                        f"{TOL[dtype]}: states absolute, gradients relative "
                        f"to max |g|)")
    # both bodies of each kernel, as the library counted their launches,
    # are held to the plain versions
    for name, taken in rows.items():
        taken = {r["route"] for r in taken}
        if taken != {"persistent", "steps"}:
            raise AssertionError(f"{name}: its shapes took the routes "
                                 f"{sorted(taken)}, not both")
    return rows


def timed_row(rows, dtype):
    """The row of this dtype timed beside its plain version."""
    name = str(dtype).split(".")[1]
    return next(r for r in rows if "plain_ms" in r and r["dtype"] == name)


# -- 14-17. the recurrent training paths --------------------------------------

LSTM_PARITY_BS, LSTM_PARITY_SEQ = 16, 32
NMT_PARITY_BS, NMT_PARITY_SEQ = 8, 16
LSTM_WANT = {"lstm_forward": 2 * rnn_bench.LSTM_LAYERS,
             "lstm_backward": rnn_bench.LSTM_LAYERS}
# the encoder's two directions
NMT_WANT = {"gru_forward": 4, "gru_backward": 2}


def rnn_program(which, seq, dtype="float32", train=True):
    """One of the two recurrent programs at full width in fresh default
    programs and scope; returns (loss, main, startup)."""
    fluid.reset()
    if which == "lstm":
        loss = rnn_bench.lstm_train_program(seq_len=seq, dtype=dtype,
                                            train=train)
    else:
        loss = rnn_bench.nmt_train_program(seq_len=seq)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def lstm_parity_phase():
    loss, main, startup = rnn_program("lstm", LSTM_PARITY_SEQ)
    grads = [n + "@GRAD" for n in ("embedding_0.w_0", "dynamic_lstm_0.w_0",
                                   "dynamic_lstm_1.w_0")]
    feed = rnn_bench.lstm_feed(LSTM_PARITY_BS, LSTM_PARITY_SEQ, ragged=True)
    return parity_run("lstm_parity", main, startup, loss, feed, grads,
                      LSTM_WANT, {"bs": LSTM_PARITY_BS,
                                  "seq": LSTM_PARITY_SEQ})


def nmt_parity_phase():
    loss, main, startup = rnn_program("nmt", NMT_PARITY_SEQ)
    grads = [n + "@GRAD" for n in ("s2s.src_emb", "s2s.enc_gru_f.w",
                                   "s2s.enc_gru_b.w", "s2s.dec_w_h")]
    feed = rnn_bench.nmt_feed(NMT_PARITY_BS, NMT_PARITY_SEQ)
    return parity_run("nmt_parity", main, startup, loss, feed, grads,
                      NMT_WANT, {"bs": NMT_PARITY_BS, "seq": NMT_PARITY_SEQ})


def rnn_bench_run(tag, which, dtype, feed, want, card_name, smi, lr):
    """2 warm-up steps and 10 measured ones of a recurrent program at full
    width: losses finite and falling (the lowest measured one below the
    first step's), step ms, sequences and tokens per
    second (tokens = the feed's valid source steps), peak memory, and the
    launches `want` in every step."""
    bs, seq = feed[next(iter(feed))].shape[:2]
    t0 = time.monotonic()
    loss, main, startup = rnn_program(which, seq, dtype)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_launches(tag, launches, {k: 10 * v for k, v in want.items()})
    for _, _, per_step, _ in steps:
        check_launches(tag, per_step, want)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    tokens = int(sum(int(v.sum()) for k, v in feed.items()
                     if k in ("words@LENGTH", "src@LENGTH", "tgt@LENGTH")))
    res = {"card": card_name, "nvidia_smi": smi, "bs": bs, "seq": seq,
           "dtype": dtype, "lr": lr, "tokens_per_step": tokens,
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "ops": len(main.global_block().ops),
           "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "seq_s": bs / (step_ms / 1e3),
           "tok_s": tokens / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log(tag, res)
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or did "
                             f"not fall")
    return res, exe, main, loss


def lstm_bench_phase(card_name, smi):
    feed = rnn_bench.lstm_feed()
    res, exe, main, loss = rnn_bench_run(
        "lstm_bench", "lstm", "bfloat16", feed, LSTM_WANT, card_name, smi,
        rnn_bench.LSTM_LR)
    # the mask at full width: ragged lengths, the same program
    ragged = rnn_bench.lstm_feed(ragged=True, seed=1)
    steps = run_steps(exe, main, loss, ragged, 3)
    for _, _, per_step, _ in steps:
        check_launches("lstm_bench_ragged", per_step, LSTM_WANT)
    res["ragged_losses"] = [r[0] for r in steps]
    if not all(np.isfinite(res["ragged_losses"])):
        raise AssertionError(f"lstm_bench: ragged losses "
                             f"{res['ragged_losses']} are not finite")
    # the forward program alone runs in test mode: K7 only
    loss_t, main_t, startup_t = rnn_program("lstm", rnn_bench.LSTM_SEQ,
                                            "bfloat16", train=False)
    exe_t = fluid.Executor(fluid.CUDAPlace(0))
    exe_t.run(startup_t)
    (val,), launches = counted(lambda: exe_t.run(main_t, feed=ragged,
                                                 fetch_list=[loss_t]))
    check_launches("lstm_infer", launches,
                   {"lstm_forward": rnn_bench.LSTM_LAYERS})
    infer = {"bs": rnn_bench.LSTM_BS, "seq": rnn_bench.LSTM_SEQ,
             "dtype": "bfloat16", "loss": float(val[0]),
             "launches": launches}
    log("lstm_infer", infer)
    if not np.isfinite(infer["loss"]):
        raise AssertionError(f"lstm_infer: loss {infer['loss']}")
    return res, infer


def nmt_bench_phase(card_name, smi):
    res, _, _, _ = rnn_bench_run(
        "nmt_bench", "nmt", "float32", rnn_bench.nmt_feed(), NMT_WANT,
        card_name, smi, rnn_bench.NMT_LR)
    return res


# -- 18. kernels K11-K15 ------------------------------------------------------

BN_TIMED_1X1 = ("1x1", 128, 28, 28, 512, 128, 1, True)   # stage 2's conv1
BN_TIMED_3X3 = ("3x3", 128, 28, 28, 128, 128, 1, False)  # stage 2's conv2
BN_EXTRA = [("3x3", 8, 7, 7, 64, 96, 2, True)]  # odd H and W at stride 2
BN_NO_LIBRARY = ("null: no single PyTorch call computes the fused function "
                 "(BatchNorm apply, residual and ReLU inside the "
                 "convolution's operand); the plain version is that "
                 "composition of ATen, cuDNN and torch.matmul calls")


def fused_shape_counts(depth, bs, image):
    """{(kind, N, H, W, K, O, stride, residual): fused ops of that shape}
    of the NHWC training program at this depth, batch and image size,
    read from its desc (built, not run); H and W are X's, before a 1x1's
    stride."""
    fluid.reset()
    resnet_bench.train_program(depth=depth, image=image)
    block = fluid.default_main_program().global_block()
    out = {}
    for op in block.ops:
        if op.type not in ("bn_act_conv1x1", "bn_act_conv3x3"):
            continue
        _, h, w, k = block.var(op.inputs["X"][0]).shape
        o = block.var(op.inputs["Filter"][0]).shape[0]
        key = ("1x1" if op.type == "bn_act_conv1x1" else "3x3", bs, h, w,
               k, o, op.attrs["strides"][0],
               bool(op.inputs.get("Residual")))
        out[key] = out.get(key, 0) + 1
    fluid.reset()
    return out


def fused_shapes(depth, bs, image):
    """Every distinct fused shape of the program (``fused_shape_counts``),
    sorted."""
    return sorted(fused_shape_counts(depth, bs, image))


# launches a ResNet step makes per fused op of a shape (RESNET_WANT): the
# forward twice (the op, then its generic_grad's re-run), the backward once
BN_STEP_LAUNCHES = {"bn_matmul_fwd": 2, "bn_matmul_bwd": 1,
                    "bn_conv3x3_bwd": 1}


def bn_step_sum(rows, counts, dtype):
    """Sum over the fused ops of a ResNet step of launches x kernel ms (and
    x bound ms) of K11, K12 and K15 in `dtype`, from the rows timed at
    each shape; the launches must add up to RESNET_WANT[50]."""
    dt = str(dtype).split(".")[1]
    out = {"dtype": dt}
    for name, per_op in BN_STEP_LAUNCHES.items():
        launches = ms = bound_ms = 0.0
        for row in rows[name]:
            key = (row["kind"], row["N"], row["H"], row["W"], row["K"],
                   row["O"], row["stride"], row["residual"])
            if row["dtype"] != dt or key not in counts:
                continue
            n = per_op * counts[key]
            launches += n
            ms += n * row["kernel_ms"]
            bound_ms += n * row["bound_ms"]
        if launches != RESNET_WANT[50][name]:
            raise AssertionError(
                f"{name}: {launches} launches over ResNet-50's fused shapes, "
                f"not the {RESNET_WANT[50][name]} of a step")
        out[name] = {"launches": int(launches), "kernel_ms": ms,
                     "bound_ms": bound_ms}
    out["kernel_ms"] = sum(out[n]["kernel_ms"] for n in BN_STEP_LAUNCHES)
    return out


def bn_case(dev, dtype, kind, N, H, W, K, O, stride, has_r):
    """Inputs of one fused op on the card, as the kernels see them: for a
    1x1, x and r already read at the stride ([M, K]) and w [K, O]; for a
    3x3, NHWC x and r and w HWIO, the weights scaled to 0.5/sqrt(fan
    in)."""
    g = torch.Generator(device=dev).manual_seed(SEED + H + K + O + stride)

    def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device=dev) * scale
                + shift).to(dt)

    if kind == "1x1":
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos = (N * Ho * Wo, K), (K, O), (N * Ho * Wo, O)
        fan = K
    else:
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        xs, ws, dos = (N, H, W, K), (3, 3, K, O), (N, Ho, Wo, O)
        fan = 9 * K
    return {"x": rnd(*xs, scale=1.5, shift=0.3),
            "r": rnd(*xs) if has_r else None,
            "gamma": (torch.rand(K, generator=g, device=dev) + 0.5),
            "beta": rnd(K, scale=0.3, dt=torch.float32),
            "mean": rnd(K, scale=0.1, shift=0.3, dt=torch.float32),
            "var": torch.rand(K, generator=g, device=dev) + 2.0,
            "w": rnd(*ws, scale=0.5 / fan ** 0.5), "do": rnd(*dos),
            "rows_out": dos[0] if kind == "1x1" else N * Ho * Wo}


BN_KINK = 1e-3  # the least |ReLU input| of an f32 case


def bn_clear_of_kinks(a):
    """Moves each element of x whose ReLU input (x - mean) * gamma *
    rsqrt(var + eps) + beta [+ r] lies within BN_KINK of 0 out to 2
    BN_KINK on its side, so that f32 and f64 take the same mask: an f32
    kernel held to a float64 plain version would otherwise see an element
    that flips move a gradient element by its whole value.  (The bf16
    cases, the on-card tests and the training phases keep such elements:
    there the plain version rounds as the kernel does.)"""
    gi = a["gamma"].double() * torch.rsqrt(a["var"].double() + 1e-5)
    pre = (a["x"].double() - a["mean"].double()) * gi + a["beta"].double()
    if a["r"] is not None:
        pre = pre + a["r"].double()
    step = torch.where(pre >= 0, 2 * BN_KINK, -2 * BN_KINK) / gi
    a["x"] = torch.where(pre.abs() < BN_KINK, a["x"].double() + step,
                         a["x"].double()).to(a["x"].dtype)
    return a


def bn_bound(kind, a, O, backward, dtype, design="cuda_cores"):
    """Each input read once, each output written once (the statistics
    too), and 2 flops per multiply-add of the products: forward M_out K O
    (times 9 taps for a 3x3), backward twice that (dA and dW); the
    prologue's few flops an element are left out.  The products at the
    dtype's rate, or for a 3xTF32 body (``design``) three TF32 products
    per f32 product at the tensor cores' TF32 rate, as ``flash_bound``."""
    size = a["x"].element_size()
    xe, we = a["x"].numel(), a["w"].numel()
    oe = a["do"].numel()
    n_r = 0 if a["r"] is None else 1
    K = a["gamma"].numel()
    if backward:
        elems = (2 + 2 * n_r) * xe + 2 * we + oe  # x, r, dx, dr; w, dw; dO
        stats = 4 * K * 4 + 6 * K * 4
    else:
        elems = (1 + n_r) * xe + we + oe
        stats = 4 * K * 4
    taps = 9 if kind == "3x3" else 1
    flops = 2 * a["rows_out"] * K * O * taps * (2 if backward else 1)
    if design.endswith("mma_3xtf32"):
        return bound(elems * size + stats, 3 * flops, dtype, peak=PEAK_TF32)
    return bound(elems * size + stats, flops, dtype)


def bn_calls(kind, a, stride, v2=False):
    """(forward, plain forward, backward, plain backward) of one case as
    zero-argument callables."""
    args = tuple(a[k] for k in ("x", "gamma", "beta", "mean", "var", "w"))
    if kind == "1x1":
        return (lambda: bnmm.bn_matmul_fwd(*args, a["r"]),
                lambda: bnmm.bn_matmul_fwd_ref(*args, a["r"]),
                lambda: bnmm.bn_matmul_bwd(*args, a["do"], a["r"]),
                lambda: bnmm.bn_matmul_bwd_ref(*args, a["do"], a["r"]))
    fwd = bnc.bn_conv3x3_fwd_v2 if v2 else bnc.bn_conv3x3_fwd
    return (lambda: fwd(*args, a["r"], stride=stride),
            lambda: bnc.bn_conv3x3_fwd_ref(*args, a["r"], stride=stride),
            lambda: bnc.bn_conv3x3_bwd(*args, a["do"], a["r"],
                                       stride=stride),
            lambda: bnc.bn_conv3x3_bwd_ref(*args, a["do"], a["r"],
                                           stride=stride))


def bn_double(a):
    """The case's inputs in float64: what the f32 kernels are held to."""
    return {k: v.double() if isinstance(v, torch.Tensor) else v
            for k, v in a.items()}


BN_OUTPUTS = {False: ("out",),
              True: ("dx", "dgamma", "dbeta", "dmean", "dvar", "dw", "dr")}


def bn_f64_errs(names, got, plain, want):
    """{output: {"kernel": d, "plain": d}}: each bf16 output's and its
    plain version's distance to the function in float64 from the same
    inputs (max |error| over max |value|)."""
    return {n: {"kernel": rel_err(g, w), "plain": rel_err(p, w)}
            for n, g, p, w in zip(names, got, plain, want)}


def bn_kernel_phase(dev):
    """K11-K15 against their plain versions, float32 and bfloat16, at
    every distinct fused shape of ResNet-50's bench program (batch 128,
    224 x 224), the stride-2 and residual 3x3 shapes of ResNet-18, and an
    odd-H stride-2 3x3; outputs and gradients relative to each tensor's
    max |value|, by TOL.  The f32 kernels are held to the plain version in
    float64 (so neither cuDNN's algorithm choice nor its summation order
    moves the reading; inputs clear of the ReLU's kink,
    ``bn_clear_of_kinks``), the bf16 ones to the plain version in bf16,
    and each bf16 output's distance to the float64 function from the same
    inputs is logged beside the plain version's (``f64_err``).  K13 and K14
    are timed at every 3x3 shape, K11, K12 and K15 in both dtypes at every
    ResNet-50 shape, and the f32 ones summed over ResNet-50's step
    (``bn_step_sum``); at stage 2's 1x1 with a residual and stage 2's 3x3
    each kernel is timed beside its plain version (in its own dtype) and
    the bound.  Each row names its kernel's body by dtype (``DESIGN``)."""
    r50 = fused_shape_counts(50, resnet_bench.BS, resnet_bench.IMAGE)
    shapes = sorted(r50)
    shapes += [s for s in fused_shapes(18, resnet_bench.BS,
                                       resnet_bench.IMAGE)
               if s[0] == "3x3" and (s[6] == 2 or s[7]) and s not in shapes]
    shapes += BN_EXTRA
    names = {"1x1": ("bn_matmul_fwd", "bn_matmul_bwd"),
             "3x3": ("bn_conv3x3_fwd", "bn_conv3x3_bwd")}
    rows = {k: [] for k in BN_KERNELS}
    for dtype in DTYPES:
        for shape in shapes:
            kind, N, H, W, K, O, stride, has_r = shape
            a = bn_case(dev, dtype, *shape)
            if dtype == torch.float32:
                a = bn_clear_of_kinks(a)
            fwd, _, bwd, _ = bn_calls(kind, a, stride)
            out = fwd()
            grads = bwd()
            torch.cuda.synchronize()
            ref_calls = bn_calls(kind, bn_double(a) if dtype == torch.float32
                                 else a, stride)
            ref = ref_calls[1]()
            ref_g = ref_calls[3]()
            f64 = {}
            if dtype == torch.bfloat16:
                x64 = bn_calls(kind, bn_double(a), stride)
                f64 = {False: bn_f64_errs(BN_OUTPUTS[False], [out], [ref],
                                          [x64[1]()]),
                       True: bn_f64_errs(BN_OUTPUTS[True], grads, ref_g,
                                         x64[3]())}
                del x64
            desc = {"dtype": str(dtype).split(".")[1], "kind": kind, "N": N,
                    "H": H, "W": W, "K": K, "O": O, "stride": stride,
                    "residual": has_r,
                    "plain_dtype": str(ref.dtype).split(".")[1]}
            checks = [(names[kind][0], fwd, [out], [ref], False)]
            if kind == "3x3":
                v2 = bn_calls(kind, a, stride, v2=True)[0]
                out2 = v2()
                torch.cuda.synchronize()
                checks.append(("bn_conv3x3_fwd_v2", v2, [out2], [ref],
                               False))
            checks.append((names[kind][1], bwd, grads, ref_g, True))
            timed = (shape == BN_TIMED_1X1 or shape == BN_TIMED_3X3)
            for name, kern, got, want, back in checks:
                design = DESIGN[dtype][name]
                b_ms, b_by = bn_bound(kind, a, O, back, dtype, design)
                row = {**desc, "design": design,
                       "max_rel_err": max(rel_err(g, r)
                                          for g, r in zip(got, want)),
                       "max_abs_err": max(max_err(g, r)
                                          for g, r in zip(got, want)),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
                if design.endswith("mma_3xtf32"):
                    row["bound_cuda_cores_ms"] = bn_bound(kind, a, O, back,
                                                          dtype)[0]
                if name == "bn_conv3x3_fwd_v2":
                    row["block_o"] = bnc._v2_block_o(O)
                    row["equals_v1"] = torch.equal(out2, out)
                elif f64:
                    row["f64_err"] = f64[back]
                if timed or (kind == "3x3" and not back) or shape in r50:
                    row["kernel_ms"] = time_ms(kern, iters=10)
                if timed:
                    row["plain_ms"] = time_ms(
                        bn_calls(kind, a, stride)[3 if back else 1], iters=5)
                rows[name].append(row)
                log(name, row)
                if row["max_rel_err"] > TOL[dtype]:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at "
                        f"{desc}: {row} (tolerance {TOL[dtype]} of each "
                        f"tensor's max |value|)")
            del a, out, grads, ref, ref_g
    log("bn_f32_resnet50_step", bn_step_sum(rows, r50, torch.float32))
    return rows


def top_k_phase(dev):
    """The top_k op on ties, on the card and on the CPU, against a stable
    descending sort of the same rows."""
    info = get_op_info("top_k")
    rng = np.random.RandomState(SEED)
    cases = [(np.zeros((1, 10), np.float32), 3),
             (rng.randint(0, 4, (128, 1000)).astype(np.float32), 5)]
    rows = []
    for x, k in cases:
        want = np.argsort(-x, axis=1, kind="stable")[:, :k]
        for dtype in DTYPES:
            for d in (dev, torch.device("cpu")):
                xt = torch.from_numpy(x).to(device=d, dtype=dtype)
                got = info.emit(EmitContext(d, is_test=True), {"X": [xt]},
                                {"k": k})["Indices"][0].cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"top_k on {d} ({dtype}) breaks ties otherwise than "
                        f"a stable sort: {got[:2]} against {want[:2]}")
            rows.append({"shape": list(x.shape), "k": k,
                         "dtype": str(dtype).split(".")[1],
                         "indices_equal": True})
    log("top_k_ties", {"cases": rows})
    return rows


def v1_v2_times(rows):
    """K13 against K14 at every 3x3 shape the phase timed: each kernel's
    ms and K14's share of K13's time."""
    v2 = {tuple(r[k] for k in ("dtype", "N", "H", "W", "K", "O", "stride",
                               "residual")): r
          for r in rows["bn_conv3x3_fwd_v2"]}
    out = []
    for r in rows["bn_conv3x3_fwd"]:
        key = tuple(r[k] for k in ("dtype", "N", "H", "W", "K", "O",
                                   "stride", "residual"))
        if "kernel_ms" in r and "kernel_ms" in v2.get(key, {}):
            out.append({"shape": dict(zip(
                ("dtype", "N", "H", "W", "K", "O", "stride", "residual"),
                key)), "v1_ms": r["kernel_ms"],
                "v2_ms": v2[key]["kernel_ms"],
                "v2_over_v1": v2[key]["kernel_ms"] / r["kernel_ms"]})
    log("bn_conv3x3_v1_vs_v2", {"shapes": out})
    return out


# -- 19-20. ResNet training ---------------------------------------------------

# (image, batch) of the f32 parity runs.  ResNet-50's f32 training is
# ill-conditioned at these sizes: from one state its step-1 gradients lie
# about 2% (in norm over all parameters; up to 27% of max |g| for the last
# stage's filters) from a float64 run of the same step, on the CPU and on
# the card alike, at 128 x 128 and at 224 x 224, and the next steps
# inherit that spread (tools/resnet_conditioning.py --card).  ResNet-18
# at 64 x 64 stays within 2e-5.
RESNET_PARITY = {50: (128, 4), 18: (64, 4)}
RESNET_PARITY_LR = 0.001
# per step: each fused op once in the forward and once inside its
# generic_grad's re-run of the forward, its backward once
RESNET_WANT = {
    50: {"bn_matmul_fwd": 68, "bn_matmul_bwd": 34, "bn_conv3x3_fwd": 32,
         "bn_conv3x3_bwd": 16},
    18: {"bn_matmul_fwd": 6, "bn_matmul_bwd": 3, "bn_conv3x3_fwd": 30,
         "bn_conv3x3_bwd": 15}}
# ResNet-50 under PADDLE_TPU_BNCONV_VARIANT=v2: K14 in K13's place
RESNET_V2_WANT = dict(RESNET_WANT[50], bn_conv3x3_fwd=0,
                      bn_conv3x3_fwd_v2=32)


def resnet_program(depth, image, dtype, lr, fuse=True):
    """The NHWC training program of ``resnet_bench`` at this depth, image
    size and dtype (class_dim 1000) in fresh default programs and scope;
    returns (loss, main, startup)."""
    fluid.reset()
    loss, _ = resnet_bench.train_program(depth=depth, image=image,
                                         dtype=dtype, learning_rate=lr,
                                         fuse_bn=fuse)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def resnet_watched(block):
    """The stem filter's, the first fused 3x3's filter and BN scale's and
    the fc weight's gradient names."""
    conv3 = next(op for op in block.ops if op.type == "bn_act_conv3x3")
    return [n + "@GRAD" for n in (
        "conv2d_0.w_0", conv3.inputs["Filter"][0], conv3.inputs["Scale"][0],
        next(p.name for p in block.all_parameters()
             if p.name.startswith("fc") and ".w_" in p.name))]


def snapshot(block, scope=None):
    return {n: (scope or fluid.global_scope()).find_np(n)
            for n, v in block.vars.items() if v.persistable}


def forced_steps(exe, main, loss, feed, states, grads, scope=None):
    """One step from each numpy state of `states` (loaded by name before
    it), the step-1 `grads` fetched; returns run_steps' rows."""
    rows = []
    for i, state in enumerate(states):
        fluid.load_persistables(main, state, scope)
        rows += run_steps(exe, main, loss, feed, 1, grads if i == 0 else (),
                          scope=scope)
    return rows


def resnet50_parity_phase():
    """ResNet-50 in f32 at 128 x 128, batch 4, held where f32 itself holds
    (RESNET_PARITY's comment).  The CPU takes three f32 steps from the
    card's startup state; the card takes each step from the CPU's state
    before it (so every step starts equal, the velocities of steps 2 and 3
    included), with v1 (K13) and again with v2 (K14); the CPU takes one
    float64 step from the same start.  Held: each step's loss within 1e-4
    relative of the CPU's, and v2's step-1 loss within 1e-6 of v1's (the
    same function and rounding; later steps differ in cuDNN's and max
    pooling's atomics); the fc weight's step-1 gradient within 1e-3 of
    its max |g|, and the running statistics after step 1 within 1e-3; the
    stem, first fused 3x3 and BN-scale gradients, each, and all gradients
    together (in norm), no further from the float64 ones than twice the
    CPU's f32 ones are.  Launches per step are RESNET_WANT[50] (v2: K14 in
    place of K13).  The free-running card trajectory's losses are logged
    beside the CPU's and float64's, not held."""
    image, bs = RESNET_PARITY[50]
    loss, main, startup = resnet_program(50, image, "float32",
                                         RESNET_PARITY_LR)
    block = main.global_block()
    watched = resnet_watched(block)
    names = sorted(p.name + "@GRAD" for p in block.all_parameters())
    stats = [op.inputs[s][0] for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    feed = resnet_bench.feed(bs, image)
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    states = [snapshot(block)]
    t0 = time.monotonic()
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = forced_steps(cpu_exe, main, loss, feed, states[:1], names,
                       cpu_scope)
    for _ in range(2):
        states.append(snapshot(block, cpu_scope))
        cpu += run_steps(cpu_exe, main, loss, feed, 1, scope=cpu_scope)
    cpu_s = time.monotonic() - t0
    cpu_stats = {n: states[1][n] for n in stats}
    free, _ = counted(lambda: run_steps(card, main, loss, feed, 3))
    gpu, launches = counted(lambda: forced_steps(card, main, loss, feed,
                                                 states[:1], names))
    gpu_stats = {n: fluid.global_scope().find_np(n) for n in stats}
    gpu += forced_steps(card, main, loss, feed, states[1:], ())
    for _, _, per_step, _ in gpu:
        check_launches("resnet50_parity", per_step, RESNET_WANT[50])
    os.environ["PADDLE_TPU_BNCONV_VARIANT"] = "v2"
    try:
        v2, v2_launches = counted(lambda: forced_steps(card, main, loss,
                                                       feed, states, ()))
    finally:
        del os.environ["PADDLE_TPU_BNCONV_VARIANT"]
    for _, _, per_step, _ in v2:
        check_launches("resnet50_parity_v2", per_step, RESNET_V2_WANT)
    del card
    t0 = time.monotonic()
    loss64, main64, _ = resnet_program(50, image, "float64",
                                       RESNET_PARITY_LR)
    block64 = main64.global_block()
    scope64 = fluid.Scope()
    fluid.load_persistables(main64, {
        n: a.astype(block64.vars[n].dtype) for n, a in states[0].items()},
        scope64)
    feed64 = dict(feed, image=feed["image"].astype(np.float64))
    f64 = run_steps(fluid.Executor(fluid.CPUPlace()), main64, loss64,
                    feed64, 1, names, scope=scope64)
    f64_s = time.monotonic() - t0
    g32, gc, g64 = gpu[0][1], cpu[0][1], f64[0][1]

    def max_rel(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / np.abs(b).max())

    def norm_rel(a):
        num = sum(float(((np.asarray(a[n], np.float64) - g64[n]) ** 2).sum())
                  for n in names)
        return (num / sum(float((g64[n] ** 2).sum()) for n in names)) ** 0.5

    loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(gpu, cpu)]
    v2_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(v2, gpu)]
    fc = watched[3]
    witness = {n: {"card": max_rel(g32[n], g64[n]),
                   "cpu": max_rel(gc[n], g64[n])} for n in watched[:3]}
    witness["all_norm"] = {"card": norm_rel(g32), "cpu": norm_rel(gc)}
    res = {"depth": 50, "bs": bs, "image": image, "dtype": "float32",
           "gpu_losses": [r[0] for r in gpu],
           "cpu_losses": [r[0] for r in cpu], "loss_rel_err": loss_rel,
           "loss_tol": [1e-4] * 3, "steps": "each from the CPU's state",
           "grad_rel_err_step1": {fc: max_rel(g32[fc], gc[fc])},
           "grad_tol": {fc: 1e-3},
           "grad_vs_f64_step1": witness, "grad_vs_f64_tol": "2 x the CPU's",
           "state_rel_err_max": max(max_rel(gpu_stats[n], cpu_stats[n])
                                    for n in stats),
           "state_after_step": 1,
           "free_running_losses": {"card": [r[0] for r in free],
                                   "cpu": [r[0] for r in cpu],
                                   "f64_step1": f64[0][0]},
           "launches_per_step": gpu[-1][2],
           "gpu_step_s": [r[3] for r in gpu], "cpu_s": cpu_s,
           "f64_s": f64_s}
    log("resnet50_parity", res)
    v2res = {"losses": [r[0] for r in v2], "v1_losses": res["gpu_losses"],
             "loss_rel_err_vs_v1": v2_rel, "loss_tol_step1": 1e-6,
             "loss_rel_err_vs_cpu": [abs(a[0] - b[0]) / abs(b[0])
                                     for a, b in zip(v2, cpu)],
             "launches_per_step": v2[-1][2], "launches": v2_launches}
    log("resnet50_parity_v2", v2res)
    bad = [f"step {i + 1} loss {e}" for i, e in enumerate(loss_rel)
           if e > 1e-4]
    bad += [f"v2 step {i + 1} loss vs the CPU {e}" for i, e in
            enumerate(v2res["loss_rel_err_vs_cpu"]) if e > 1e-4]
    bad += [f"v2 step-1 loss vs v1 {v2_rel[0]}"] if v2_rel[0] > 1e-6 else []
    bad += [f"{fc} {res['grad_rel_err_step1'][fc]}"] \
        if res["grad_rel_err_step1"][fc] > 1e-3 else []
    bad += [f"statistics {res['state_rel_err_max']}"] \
        if res["state_rel_err_max"] > 1e-3 else []
    bad += [f"{n} vs float64 {w}" for n, w in witness.items()
            if w["card"] > 2 * w["cpu"]]
    if bad:
        raise AssertionError(f"resnet50 card and CPU training disagree: "
                             f"{bad}: {res}")
    fluid.reset()
    return res, v2res


def resnet18_parity_phase():
    """Three f32 steps of ResNet-18 at 64 x 64 on the card against three
    on the CPU (``parity_run``), the running statistics after step 3."""
    image, bs = RESNET_PARITY[18]
    loss, main, startup = resnet_program(18, image, "float32",
                                         RESNET_PARITY_LR)
    block = main.global_block()
    stats = [op.inputs[s][0] for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    return parity_run("resnet18_parity", main, startup, loss,
                      resnet_bench.feed(bs, image), resnet_watched(block),
                      RESNET_WANT[18], {"depth": 18, "bs": bs,
                                        "image": image}, stats)


def resnet_bench_run(tag, fuse, card_name, smi, want=RESNET_WANT[50]):
    """2 warm-up steps and 10 measured ones of ResNet-50's bench program
    (bf16, batch 128, 224 x 224): losses finite and the lowest measured
    below the first, step ms, images per second, peak memory and, fused,
    exactly `want` launches a step (unfused: none)."""
    t0 = time.monotonic()
    loss, main, startup = resnet_program(resnet_bench.DEPTH,
                                         resnet_bench.IMAGE,
                                         resnet_bench.DTYPE, resnet_bench.LR,
                                         fuse)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = resnet_bench.feed()
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed, 10))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    want = want if fuse else {}
    for _, _, per_step, _ in steps:
        if fuse:
            check_launches(tag, per_step, want)
        elif any(per_step.values()):
            raise AssertionError(f"{tag}: the unfused program launched "
                                 f"{per_step}")
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    block = main.global_block()
    res = {"card": card_name, "nvidia_smi": smi, "fused": fuse,
           "depth": resnet_bench.DEPTH, "bs": resnet_bench.BS,
           "image": resnet_bench.IMAGE, "dtype": resnet_bench.DTYPE,
           "lr": resnet_bench.LR, "ops": len(block.ops),
           "ops_run_per_step": sum(texecutor.live_ops(block, [loss.name])),
           "params": sum(int(np.prod(p.shape))
                         for p in block.all_parameters()),
           "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_each": [r[3] * 1e3 for r in steps],
           "img_s": resnet_bench.BS / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(steps)
                                 for k, v in launches.items()}}
    log(tag, res)
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or did "
                             f"not fall")
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


def resnet_bench_phase(card_name, smi):
    fused = resnet_bench_run("resnet50_bench_fused", True, card_name, smi)
    os.environ["PADDLE_TPU_BNCONV_VARIANT"] = "v2"
    try:
        v2 = resnet_bench_run("resnet50_bench_fused_v2", True, card_name,
                              smi, RESNET_V2_WANT)
    finally:
        del os.environ["PADDLE_TPU_BNCONV_VARIANT"]
    unfused = resnet_bench_run("resnet50_bench_unfused", False, card_name,
                               smi)
    cmp = {"fused_img_s": fused["img_s"], "fused_v2_img_s": v2["img_s"],
           "unfused_img_s": unfused["img_s"],
           "fused_over_unfused": fused["img_s"] / unfused["img_s"],
           "fused_v2_over_fused": v2["img_s"] / fused["img_s"],
           "card": card_name, "nvidia_smi": smi}
    log("resnet50_fused_vs_unfused", cmp)
    return fused, v2, unfused


# -- 21-24. K steps a dispatch: the captured step loop -------------------------

# GPT training at the bench shape takes 4 steps a dispatch, ResNet-50 2
STEP_LOOP_K = {"gpt": 4, "resnet50": 2}
# timed steps of each route
STEP_LOOP_TIMED = 12
# eager runs from one state: the eager spread is the largest distance
# between any two of them
SPREAD_RUNS = 6
# where eager runs from one state part (an op whose sums depend on the
# order atomics land in), a graph's losses and each state tensor are held
# to this multiple of their spread: the graph-to-eager distance is a draw
# from the same spread
SPREAD_FACTOR = 2.0


def persistables(main):
    return [n for n, v in main.global_block().vars.items() if v.persistable]


def snap(names):
    """The scope's values of `names`, cloned on the card."""
    scope = fluid.global_scope()
    return {n: scope.find(n).detach().clone() for n in names}


def restore(state):
    """Replace the scope's entries by copies of `state` (new tensors, as
    an eager run() or Scope.set leaves them)."""
    for n, t in state.items():
        fluid.global_scope().set(n, t.clone())


def distance(losses_a, state_a, losses_b, state_b):
    """Whether two runs agree to the bit, and how far apart they are: the
    losses' largest relative distance (`loss_rel`), and each state
    tensor's that differs, as the norm of the difference relative to the
    tensor's norm (`tensors`; the largest is `state_rel`, in `worst`).
    The norm sums every element's part, where a largest element
    difference is one rounding flip (bf16 parameters, Adam's second
    moments) and jumps by whole units in the last place; that largest,
    relative to the tensor's max |value|, is `state_max_rel`.  `flips`
    holds each differing tensor's one flip of its largest element in the
    same measure: its dtype's eps times its max |value|, over its norm."""
    la, lb = np.asarray(losses_a, np.float64), np.asarray(losses_b,
                                                          np.float64)
    loss_rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    tensors, flips, peak = {}, {}, 0.0
    for n, b in state_b.items():
        a = state_a[n]
        if not torch.equal(a, b):
            eps = torch.finfo(b.dtype).eps
            diff, b = a.double() - b.double(), b.double()
            norm, top = b.norm().clamp_min(1e-30), b.abs().max()
            tensors[n] = (diff.norm() / norm).item()
            flips[n] = (eps * top / norm).item()
            peak = max(peak, (diff.abs().max()
                              / top.clamp_min(1e-30)).item())
    worst = max(tensors, key=tensors.get, default=None)
    return {"bitwise": loss_rel == 0.0 and not tensors, "loss_rel": loss_rel,
            "state_rel": tensors.get(worst, 0.0), "worst": worst,
            "state_max_rel": peak, "tensors": tensors, "flips": flips}


def eager_runs(exe, main, loss, blocks, k, start):
    """SPREAD_RUNS runs from `start`, each k eager steps per stacked block
    of `blocks`: (losses, state) each."""
    names = list(start)
    runs = []
    for _ in range(SPREAD_RUNS):
        restore(start)
        losses = []
        for stacked in blocks:
            losses += eager_steps(exe, main, loss, stacked, k)
        runs.append((losses, snap(names)))
    return runs


def spread_of(runs):
    """The eager spread of runs from one state: the largest distance
    between any two of them, of the losses and of each state tensor."""
    pairs = [distance(*a, *b) for i, a in enumerate(runs)
             for b in runs[i + 1:]]
    tensors = {}
    for pair in pairs:
        for n, d in pair["tensors"].items():
            tensors[n] = max(tensors.get(n, 0.0), d)
    worst = max(tensors, key=tensors.get, default=None)
    return {"runs": len(runs), "bitwise": all(p["bitwise"] for p in pairs),
            "loss_rel": max(p["loss_rel"] for p in pairs),
            "state_rel": tensors.get(worst, 0.0), "worst": worst,
            "state_max_rel": max(p["state_max_rel"] for p in pairs),
            "tensors": tensors}


def brief(d):
    """A ``distance`` or ``spread_of`` without its per-tensor tables."""
    return {k: v for k, v in d.items() if k not in ("tensors", "flips")}


def hold(tag, what, got, spread):
    """`got` (a ``distance``) within the eager `spread` (``spread_of``):
    to the bit where every eager run agrees to the bit; else its losses
    within SPREAD_FACTOR of the losses' spread, and each state tensor
    within SPREAD_FACTOR of that tensor's spread or within one rounding
    flip of its largest element (``distance``'s `flips`), whichever is
    more: a tensor whose elements part by rare flips (a bf16 bias) has a
    spread of whichever few elements flipped, and every run that is not
    bitwise may flip its largest.  Returns `got` in brief, with the
    largest share of its bound that the losses and a tensor take."""
    over, share = [], {"loss": 0.0, "state": 0.0}
    floor = (lambda n: 0.0) if spread["bitwise"] else got["flips"].get
    for part, n, d, lim in (
            [("loss", "losses", got["loss_rel"],
              SPREAD_FACTOR * spread["loss_rel"])]
            + [("state", n, d, max(SPREAD_FACTOR
                                   * spread["tensors"].get(n, 0.0),
                                   floor(n)))
               for n, d in got["tensors"].items()]):
        if d > lim:
            over.append((n, d, lim))
        if d > 0:
            share[part] = max(share[part],
                              d / lim if lim > 0 else float("inf"))
    if over:
        raise AssertionError(
            f"{tag}: {what} is not within {SPREAD_FACTOR} x the spread of "
            f"{spread['runs']} eager runs; (name, distance, bound): "
            f"{over[:8]}, {len(over)} in all; {brief(got)}")
    return {**brief(got), "share_of_bound": share}


def bits_sum(t):
    """An exact checksum of a tensor's bits: its elements read as integers
    of their width, summed plainly and weighted by position (1 + index mod
    1021), in int64; the weights catch two changes that cancel in the
    plain sum (+1 and -1 ulp, as atomics' rounding leaves them)."""
    t = t.detach().contiguous().view(-1)
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[t.element_size()]
    v = t.view(as_int).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 1021 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def parting_ops(exe, main, loss, stacked, k, state, show=5):
    """Where two eager runs of k steps from `state` part: both run with a
    checksum of every op's outputs, compared op by op in walk order; the
    first `show` ops whose outputs differ (step, op index, type, and the
    forward type a ``generic_grad`` re-runs) and how many differ."""
    runs = []
    patched = texecutor.Executor.__dict__["_run_op"]
    inner = patched.__func__

    def checked(op, env, ctx):
        inner(op, env, ctx)
        sums = [bits_sum(env[n]) for n in op.output_names()
                if n and env.get(n) is not None]
        runs[-1].append((exe._walking[0], op.type,
                         op.attrs.get("__fwd_type__"),
                         torch.stack(sums) if sums else None))

    texecutor.Executor._run_op = staticmethod(checked)
    try:
        for _ in range(2):
            restore(state)
            runs.append([])
            eager_steps(exe, main, loss, stacked, k)
    finally:
        texecutor.Executor._run_op = patched
    per_step = len(runs[0]) // k
    parted = [{"step": j // per_step, "op_index": a[0], "op": a[1],
               "fwd": a[2]}
              for j, (a, b) in enumerate(zip(*runs))
              if a[3] is not None and not torch.equal(a[3], b[3])]
    return {"ops_walked": len(runs[0]), "ops_parted": len(parted),
            "first": parted[:show]}


def eager_steps(exe, main, loss, stacked, k):
    """`k` run() calls, one slice of the stacked feed each; the losses."""
    return [float(exe.run(main, feed={n: v[i] for n, v in stacked.items()},
                          fetch_list=[loss])[0][0]) for i in range(k)]


def dispatch(exe, main, loss, stacked, k, fetch_every="all"):
    out = exe.run(main, feed=stacked, fetch_list=[loss],
                  steps_per_dispatch=k, fetch_every=fetch_every)[0]
    return [float(v) for v in np.asarray(out).reshape(-1)]


def loop_parity(tag, exe, main, loss, stacked, k, want):
    """From one state: SPREAD_RUNS eager runs of k steps (their spread;
    where two part, the ops that part first), then, each from that state
    and held to the spread against the first eager run, the first
    dispatch (eager, the warm-up), the second (capture, then replay;
    launches at capture k x `want`) and a third (a replay alone, after the
    scope's entries were replaced; no launch)."""
    names = persistables(main)
    s0 = snap(names)
    runs = eager_runs(exe, main, loss, [stacked], k, s0)
    spread = spread_of(runs)
    if not spread["bitwise"]:
        spread["parting"] = parting_ops(exe, main, loss, stacked, k, s0)
    la, sa = runs[0]
    restore(s0)
    lc = dispatch(exe, main, loss, stacked, k)
    first = hold(tag, "the first (eager) dispatch",
                 distance(lc, snap(names), la, sa), spread)
    restore(s0)
    ld, launches = counted(lambda: dispatch(exe, main, loss, stacked, k))
    if want:
        check_launches(tag + " capture", launches,
                       {n: k * v for n, v in want.items()})
    else:
        no_launches(tag + " capture", launches)
    replay = hold(tag, "the replay", distance(ld, snap(names), la, sa),
                  spread)
    restore(s0)
    le, again = counted(lambda: dispatch(exe, main, loss, stacked, k))
    if any(again.values()):
        raise AssertionError(f"{tag}: a replay made Python launches {again}")
    replay2 = hold(tag, "the second replay",
                   distance(le, snap(names), la, sa), spread)
    return {"k": k, "eager_losses": la, "dispatch1_losses": lc,
            "replay_losses": ld, "replay2_losses": le,
            "eager_spread": brief(spread), "dispatch1_vs_eager": first,
            "replay_vs_eager": replay, "replay2_vs_eager": replay2,
            "spread_factor": SPREAD_FACTOR,
            "launches_at_capture": launches}


def loop_timing(exe, main, loss, stacked, k, per_step_items):
    """STEP_LOOP_TIMED eager steps, then as many replayed ones, each ending
    in the loss fetch; ms a step, items/s, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(STEP_LOOP_TIMED // k):
        eager_steps(exe, main, loss, stacked, k)
    eager_s = time.monotonic() - t0
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(STEP_LOOP_TIMED // k):
        dispatch(exe, main, loss, stacked, k)
    replay_s = time.monotonic() - t0
    eager_ms = eager_s / STEP_LOOP_TIMED * 1e3
    replay_ms = replay_s / STEP_LOOP_TIMED * 1e3
    return {"steps_timed": STEP_LOOP_TIMED, "eager_step_ms": eager_ms,
            "replay_step_ms": replay_ms, "replay_speedup": eager_ms / replay_ms,
            "eager_items_s": per_step_items / (eager_ms / 1e3),
            "replay_items_s": per_step_items / (replay_ms / 1e3),
            "peak_mem_gb_eager": peak_eager / 1e9,
            # a replay allocates nothing: its memory is the graph's pool,
            # reserved since the capture
            "peak_mem_gb_replay": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "pool_gb": graph_pool_gb(exe)}


def gpt_stacked(bs, seq, k):
    batches = [train_batch(bs, seq, seed=i) for i in range(k)]
    return {n: np.stack([b[n] for b in batches]) for n in batches[0]}


def step_loop_gpt_phase(card_name, smi):
    """21. GPT training at the bench width and shape (bf16, batch 8 x
    1024), 4 steps a dispatch: parity of the first dispatch and of a
    replay with eager steps from the same state, launches at capture,
    eager against replayed step ms; then the f32 parity shape (batch 2 x
    256) the same way, which puts the 3xTF32 flash bodies in a graph."""
    k = STEP_LOOP_K["gpt"]
    rows = {}
    for dtype, (bs, seq) in (("float32", (PARITY_BS, PARITY_SEQ)),
                             ("bfloat16", (TRAIN_BS, TRAIN_SEQ))):
        loss, main, startup = train_program(seq, dtype)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        stacked = gpt_stacked(bs, seq, k)
        row = {"dtype": dtype, "bs": bs, "seq": seq,
               **loop_parity(f"step_loop_gpt_{dtype}", exe, main, loss,
                             stacked, k, per_step_want())}
        if dtype == "bfloat16":
            row.update(loop_timing(exe, main, loss, stacked, k, bs * seq))
            row["tok_s_eager"] = row.pop("eager_items_s")
            row["tok_s_replay"] = row.pop("replay_items_s")
            ctx = {"exe": exe, "main": main, "loss": loss,
                   "stacked": stacked, "k": k}
        else:
            exe.close()
        rows[dtype] = row
    res = {"card": card_name, "nvidia_smi": smi, **rows["bfloat16"],
           "f32_parity": rows["float32"]}
    log("step_loop_gpt", res)
    return res, ctx


def graph_pool_gb(exe):
    """GB of the card's memory in the pool `exe`'s graphs share."""
    pool = exe._graph_pool
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool or ())
               ) / 1e9 if pool is not None else 0.0


def two_scopes_check(k):
    """A small MLP, f32, on one executor, dispatched against two scopes in
    turn (for each: an eager dispatch, a capture, two replays): each equals
    k eager steps of its own from its own state, to the bit, and the two
    loops share no state buffer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64])
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=256, act="relu")
        cost = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(input=h, size=10), y))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(cost)
    startup.random_seed = SEED
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scopes = [fluid.Scope(), fluid.Scope()]
    exe.run(startup, scope=scopes[0])
    names = persistables(main)
    for n in names:
        t = scopes[0].find(n)
        scopes[1].set(n, t * 0.5 if t.is_floating_point() else t.clone())
    rng = np.random.RandomState(SEED)
    for d in range(4):
        for j, scope in enumerate(scopes):
            feed = {"x": rng.randn(k, 32, 64).astype(np.float32),
                    "y": rng.randint(0, 10, (k, 32, 1)).astype(np.int64)}
            twin = fluid.Scope()
            for n in names:
                twin.set(n, scope.find(n).clone())
            ref = fluid.Executor(fluid.CUDAPlace(0))
            want = np.stack([ref.run(main, feed={n: v[i] for n, v in
                                                 feed.items()},
                                     fetch_list=[cost], scope=twin)[0]
                             for i in range(k)])
            got = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          steps_per_dispatch=k)[0]
            if not (np.array_equal(got, want) and all(
                    torch.equal(scope.find(n), twin.find(n))
                    for n in names)):
                raise AssertionError(
                    f"step_loop_two_scopes: scope {j}, dispatch {d} differs "
                    f"from its own eager steps")
    loops = [entry.loop for entry in exe._loops.values()]
    ptrs = [{t.untyped_storage().data_ptr() for t in loop.state.values()}
            for loop in loops if loop is not None]
    if len(ptrs) != 2 or ptrs[0] & ptrs[1]:
        raise AssertionError(f"step_loop_two_scopes: {len(ptrs)} loops, or "
                             f"their state buffers overlap")
    exe.close()
    return {"scopes": 2, "dispatches_each": 4, "bitwise": True}


def step_loop_last_and_unsafe_phase(ctx):
    """22. On the GPT, each from a state of its own and held to the spread
    of SPREAD_RUNS eager runs from it: ``fetch_every="last"`` (a second
    key, its own capture) against the eager runs, with the memory the
    graphs' shared pool and the card hold while both keys are live; a
    replay right after an eager run() replaced the scope's state against
    the eager continuation.  Then two scopes in turn on one executor
    (``two_scopes_check``), and a small program with ``uniform_random``,
    which must warn, run its K steps eagerly and equal them."""
    exe, main, loss, stacked, k = (ctx[n] for n in ("exe", "main", "loss",
                                                    "stacked", "k"))
    names = persistables(main)
    pool_one_key = graph_pool_gb(exe)
    reserved_one_key = torch.cuda.memory_reserved() / 1e9
    s0 = snap(names)
    runs = eager_runs(exe, main, loss, [stacked], k, s0)
    spread = spread_of(runs)
    restore(s0)
    dispatch(exe, main, loss, stacked, k, "last")  # eager: the warm-up
    restore(s0)
    last = dispatch(exe, main, loss, stacked, k, "last")  # capture, replay
    last_vs_eager = hold("step_loop_last", "fetch_every='last'",
                         distance(last, snap(names), runs[0][0][-1:],
                                  runs[0][1]), spread)
    memory = {"keys_live": 2, "pool_gb_one_key": pool_one_key,
              "pool_gb_two_keys": graph_pool_gb(exe),
              "reserved_gb_one_key": reserved_one_key,
              "reserved_gb_two_keys": torch.cuda.memory_reserved() / 1e9}

    exe.run(main, feed={n: v[0] for n, v in stacked.items()},
            fetch_list=[loss])  # replaces the scope's entries
    s1 = snap(names)
    replay = dispatch(exe, main, loss, stacked, k)
    s_replay = snap(names)
    runs1 = eager_runs(exe, main, loss, [stacked], k, s1)
    adopt = hold("step_loop_adopt", "a replay after an eager run()",
                 distance(replay, s_replay, *runs1[0]), spread_of(runs1))
    two_scopes = two_scopes_check(k)

    prog = fluid.Program()  # beside the GPT's programs and scope
    with fluid.program_guard(prog, fluid.Program()):
        fluid.layers.data(name="x", shape=[3])
    block = prog.global_block()
    for n in ("noise", "out"):
        block.create_var(name=n, shape=(2, 3), dtype="float32")
    block.append_op("uniform_random", outputs={"Out": ["noise"]},
                    attrs={"shape": [2, 3], "dtype": "float32"})
    block.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["noise"]},
                    outputs={"Out": ["out"]}, attrs={"axis": -1})
    x = np.random.RandomState(SEED).randn(k, 2, 3).astype(np.float32)
    noisy = fluid.Executor(fluid.CUDAPlace(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused = noisy.run(prog, feed={"x": x}, fetch_list=["out"],
                          scope=fluid.Scope(), rng_step=3,
                          steps_per_dispatch=k)[0]
    said = [str(w.message) for w in caught]
    if not any("loop-unsafe" in m and "'uniform_random'" in m for m in said):
        raise AssertionError(f"step_loop_unsafe: no warning naming "
                             f"uniform_random: {said}")
    seq = np.stack([fluid.Executor(fluid.CUDAPlace(0)).run(
        prog, feed={"x": x[i]}, fetch_list=["out"], scope=fluid.Scope(),
        rng_step=3 + i)[0] for i in range(k)])
    if not np.array_equal(fused, seq) or any(
            entry.loop is not None for entry in noisy._loops.values()):
        raise AssertionError("step_loop_unsafe: the eager K steps differ "
                             "from K runs, or a loop was captured")
    res = {"last_vs_eager": last_vs_eager, "last_spread": brief(spread),
           "memory": memory, "adopt_vs_eager": adopt,
           "adopt_spread": brief(spread_of(runs1)), "two_scopes": two_scopes,
           "unsafe_warning": said[0], "unsafe_equal": True}
    log("step_loop_last_and_unsafe", res)
    return res


def step_loop_feeder_phase(ctx):
    """23. ``DeviceFeeder(steps=4)`` drives two GPT dispatches from pinned
    memory on its own stream; from one state, the losses and state equal
    two numpy-fed dispatches', held to the spread of SPREAD_RUNS eager runs
    of the same 8 steps from that state."""
    exe, main, loss, k = (ctx[n] for n in ("exe", "main", "loss", "k"))
    names = persistables(main)
    feeder = fluid.DataFeeder(feed_list=["tokens", "targets"],
                              place=fluid.CUDAPlace(0), program=main)
    blocks = [gpt_stacked(TRAIN_BS, TRAIN_SEQ, k) for _ in range(2)]
    blocks[1] = {n: np.roll(v, 1, axis=0) for n, v in blocks[1].items()}

    def reader():
        for blk in blocks:
            for i in range(k):
                yield list(zip(blk["tokens"][i], blk["targets"][i]))

    s0 = snap(names)
    spread = spread_of(eager_runs(exe, main, loss, blocks, k, s0))
    restore(s0)
    fed = []
    for blk in fluid.DeviceFeeder(feeder, reader, steps=k):
        if blk["tokens"].device != feeder.place.device:
            raise AssertionError("DeviceFeeder: a block off the card")
        fed += dispatch(exe, main, loss, blk, k)
    s_fed = snap(names)
    restore(s0)
    ref = []
    for blk in blocks:
        ref += dispatch(exe, main, loss, blk, k)
    got = hold("step_loop_feeder", "the DeviceFeeder dispatches",
               distance(fed, s_fed, ref, snap(names)), spread)
    res = {"dispatches": len(blocks), "k": k, "feeder_losses": fed,
           "numpy_losses": ref, "feeder_vs_numpy": got,
           "spread_8_steps": brief(spread)}
    log("step_loop_feeder", res)
    return res


def step_loop_resnet50_phase(card_name, smi):
    """24. Fused ResNet-50 at the bench shape (bf16, batch 128, 224 x 224,
    Momentum(0.1, 0.9)), 2 steps a dispatch: parity as 21, launches of
    K11-K15 at capture, eager against replayed step ms."""
    k = STEP_LOOP_K["resnet50"]
    loss, main, startup = resnet_program(resnet_bench.DEPTH,
                                         resnet_bench.IMAGE,
                                         resnet_bench.DTYPE, resnet_bench.LR)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    feeds = [resnet_bench.feed(seed=i) for i in range(k)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    res = {"card": card_name, "nvidia_smi": smi, "fused": True,
           "bs": resnet_bench.BS, "image": resnet_bench.IMAGE,
           "dtype": resnet_bench.DTYPE,
           **loop_parity("step_loop_resnet50", exe, main, loss, stacked, k,
                         RESNET_WANT[50]),
           **loop_timing(exe, main, loss, stacked, k, resnet_bench.BS)}
    res["img_s_eager"] = res.pop("eager_items_s")
    res["img_s_replay"] = res.pop("replay_items_s")
    log("step_loop_resnet50", res)
    exe.close()
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


COOPERATIVE_PROBE = r"""
import json, torch
from paddle_tpu_torch.ops.cuda_kernels import lstm
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
B, T, H = 64, 8, 512
def f(*shape, s):
    return (torch.randn(*shape, generator=g, device=dev) * s).bfloat16()
x, h0, c0, w = f(B, T, 4 * H, s=0.3), f(B, H, s=0.2), f(B, H, s=0.2), \
    f(H, 4 * H, s=0.05)
lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
want = lstm.lstm_forward(x, h0, c0, w, lengths)
torch.cuda.synchronize()
res = {"kernel": "lstm_forward", "route": lstm.route(x), "B": B, "T": T,
       "H": H, "dtype": "bfloat16", "torch": torch.__version__,
       "cuda": torch.version.cuda}
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        got = lstm.lstm_forward(x, h0, c0, w, lengths)
    graph.replay()
    torch.cuda.synchronize()
    res.update(captures=True,
               equal=all(torch.equal(a, b) for a, b in zip(got, want)))
except Exception as e:
    res.update(captures=False, error=f"{type(e).__name__}: {e}"[:600])
print(json.dumps(res))
"""


def cooperative_capture_probe():
    """Whether one cooperative launch (K7's persistent body,
    ``cudaLaunchCooperativeKernel``) captures into a CUDA graph on this
    toolkit: one call, in a process of its own so that a broken capture
    cannot touch this one.  A record for the next slice, not a check."""
    out = subprocess.run([sys.executable, "-c", COOPERATIVE_PROBE],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if out.returncode == 0 and lines else {
        "captures": None, "returncode": out.returncode,
        "stderr": out.stderr[-600:]}
    log("step_loop_cooperative_probe", res)
    return res


# -- 25. training options -----------------------------------------------------

# the options GPT trains as LM users train it: Adam over a decaying rate,
# with weight decay and a global-norm clip
OPT_LR, OPT_DECAY_STEPS, OPT_END_LR = 3e-4, 1000, 3e-5
OPT_DECAY, OPT_CLIP = 1e-4, 1.0
OPT_EAGER_STEPS = 10
OPT_DISPATCHES = 3  # of STEP_LOOP_K["gpt"] steps each: 12 replayed steps
# the small f32 MLP that every optimizer class trains: the card's state
# after 3 steps within this of the CPU's, by norm (``distance``'s measure)
OPT_MLP_TOL = 1e-5
OPT_MLP_K = 2
OPT_CLASSES = {
    "SGD": lambda kw: fluid.optimizer.SGD(0.05, **kw),
    "Momentum": lambda kw: fluid.optimizer.Momentum(0.02, 0.9, **kw),
    "Momentum_nesterov": lambda kw: fluid.optimizer.Momentum(
        0.02, 0.9, use_nesterov=True, **kw),
    "Adagrad": lambda kw: fluid.optimizer.Adagrad(0.02, **kw),
    "Adam": lambda kw: fluid.optimizer.Adam(1e-3, **kw),
    "Adamax": lambda kw: fluid.optimizer.Adamax(1e-3, **kw),
    "DecayedAdagrad": lambda kw: fluid.optimizer.DecayedAdagrad(0.02, **kw),
    "RMSProp": lambda kw: fluid.optimizer.RMSProp(1e-3, momentum=0.5, **kw),
    "Adadelta": lambda kw: fluid.optimizer.Adadelta(**kw),
}


def options_program(seq, dtype):
    """The options GPT in fresh default programs and scope: bench.py's
    model (``decoder_lm`` + ``lm_loss`` at the bench width) with
    ``Adam(polynomial_decay(3e-4, 1000, 3e-5), L2Decay(1e-4),
    global_clip_norm=1.0)``, built through the public API; returns
    (loss, learning-rate var, main, startup)."""
    fluid.reset()
    tokens = fluid.layers.data("tokens", shape=[seq, 1], dtype="int64")
    targets = fluid.layers.data("targets", shape=[seq, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, VOCAB, DIM, LAYERS, HEADS,
                                    max_len=seq, dtype=dtype)
    loss = transformer.lm_loss(logits, targets, dtype=dtype)
    lr = fluid.learning_rate_decay.polynomial_decay(
        OPT_LR, decay_steps=OPT_DECAY_STEPS, end_learning_rate=OPT_END_LR)
    fluid.optimizer.Adam(
        learning_rate=lr, regularization=fluid.regularizer.L2Decay(OPT_DECAY),
        global_clip_norm=OPT_CLIP).minimize(loss)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, lr, fluid.default_main_program(), startup


def schedule_f32(step):
    """polynomial_decay at `step` in f32, each op rounded as the port's
    ops round it: clip, scale (a product, then a sum), pow 1, scale."""
    f = np.float32
    frac = f(min(step, OPT_DECAY_STEPS)) * f(-1.0 / OPT_DECAY_STEPS) + f(1.0)
    return float(frac * f(OPT_LR - OPT_END_LR) + f(OPT_END_LR))


def options_parity_phase():
    """25a. The options GPT in f32 at 2 x 256: parity_run's three card
    steps against an explicit-CPU executor, the step-1 learning rate equal
    on both and to the schedule's closed form."""
    loss, lr, main, startup = options_program(PARITY_SEQ, "float32")
    params = [p.name for p in main.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in (params[0], params[4], params[-1])]
    fetched = {}
    res = parity_run("options_parity", main, startup, loss,
                     train_batch(PARITY_BS, PARITY_SEQ), grads + [lr.name],
                     per_step_want(), {"bs": PARITY_BS, "seq": PARITY_SEQ},
                     grad_tol={lr.name: 0.0}, fetched=fetched)
    got = float(fetched[lr.name][0])
    if got != schedule_f32(1):
        raise AssertionError(f"options_parity: step-1 learning rate {got!r} "
                             f"!= the schedule's {schedule_f32(1)!r}")
    res["lr_step1"] = got
    return res


def options_blocks(k):
    """OPT_DISPATCHES stacked blocks of k bench batches, seeds 100 on."""
    out = []
    for d in range(OPT_DISPATCHES):
        batches = [train_batch(TRAIN_BS, TRAIN_SEQ, seed=100 + k * d + i)
                   for i in range(k)]
        out.append({n: np.stack([b[n] for b in batches])
                    for n in batches[0]})
    return out


def options_bench_phase(card_name, smi, plain):
    """25b. The options GPT in bf16 at the bench shape (8 x 1024): 10
    eager steps (K4/K5/K6 16/8/8 each, the loss falls), then from that
    state SPREAD_RUNS eager runs of 12 steps (their spread), the key's
    first dispatch (eager), then 3 dispatches of K = 4 (capture, replays;
    launches at capture K x the per-step want): their 12 losses and the
    state held to the spread, their 12 learning rates equal to the
    schedule's closed form; then 12 eager against 12 replayed steps,
    beside phase 21's plain-Adam rows (`plain`)."""
    k = STEP_LOOP_K["gpt"]
    t0 = time.monotonic()
    loss, lr, main, startup = options_program(TRAIN_SEQ, "bfloat16")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed,
                                                OPT_EAGER_STEPS))
    check_launches("options_bf16", launches,
                   {n: OPT_EAGER_STEPS * v for n, v in
                    per_step_want().items()})
    for _, _, each, _ in steps:
        check_launches("options_bf16 step", each, per_step_want())
    losses = [r[0] for r in steps]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"options_bf16: losses {losses} are not finite "
                             f"or did not fall")
    names = persistables(main)
    blocks = options_blocks(k)
    s0 = snap(names)
    runs = eager_runs(exe, main, loss, blocks, k, s0)
    spread = spread_of(runs)
    restore(s0)
    exe.run(main, feed=blocks[0], fetch_list=[loss, lr],
            steps_per_dispatch=k)  # the key's first dispatch: eager
    restore(s0)
    outs, at_capture = counted(lambda: [
        exe.run(main, feed=b, fetch_list=[loss, lr], steps_per_dispatch=k)
        for b in blocks])
    check_launches("options_bf16 capture", at_capture,
                   {n: k * v for n, v in per_step_want().items()})
    replay_losses = [float(v) for o in outs for v in np.ravel(o[0])]
    replay_lrs = [float(v) for o in outs for v in np.ravel(o[1])]
    want_lrs = [schedule_f32(OPT_EAGER_STEPS + i + 1)
                for i in range(k * OPT_DISPATCHES)]
    if replay_lrs != want_lrs:
        raise AssertionError(f"options_bf16: replayed learning rates "
                             f"{replay_lrs} != the schedule's {want_lrs}")
    held = hold("options_bf16", f"{k * OPT_DISPATCHES} replayed steps",
                distance(replay_losses, snap(names), *runs[0]), spread)
    # the timing's memory is a step's, as phase 21's: no snapshot lives
    # on, and the timed key (the loss alone) is the executor's only loop
    del runs, s0, outs
    exe.close()
    for _ in range(2):  # the timed key's eager dispatch, then its capture
        dispatch(exe, main, loss, blocks[0], k)
    timing = loop_timing(exe, main, loss, blocks[0], k,
                         TRAIN_BS * TRAIN_SEQ)
    block = main.global_block()
    types = [op.type for op in block.ops]
    res = {"card": card_name, "nvidia_smi": smi, "bs": TRAIN_BS,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", "k": k,
           "params": len(block.all_parameters()), "ops": len(types),
           "ops_by_type": {t: types.count(t) for t in (
               "squared_l2_norm", "elementwise_mul", "scale", "sum",
               "increment", "adam")},
           "startup_s": startup_s, "eager_losses": losses,
           "eager_step_ms_each": [r[3] * 1e3 for r in steps],
           "launches_10_steps": launches,
           "replay_losses": replay_losses, "replay_lrs": replay_lrs,
           "eager_spread_12_steps": brief(spread), "replay_vs_eager": held,
           "launches_at_capture": at_capture, **timing,
           "plain_adam_eager_step_ms": plain["eager_step_ms"],
           "plain_adam_replay_step_ms": plain["replay_step_ms"],
           "plain_adam_peak_mem_gb_eager": plain["peak_mem_gb_eager"]}
    res["tok_s_eager"] = res.pop("eager_items_s")
    res["tok_s_replay"] = res.pop("replay_items_s")
    log("options_bench", res)
    exe.close()
    fluid.reset()
    torch.cuda.empty_cache()
    return res


def options_mlp(name, average=None, print_grad=False, width=128):
    """A small f32 MLP (64 -> 3 hidden layers -> 10) with every option:
    the first layer's own L1 decay and clip by value, the second's clip by
    norm and an error clip on its output, the third's clip by global
    norm, the optimizer's L2 decay and global-norm clip; `average` adds a
    ModelAverage window, `print_grad` a print of the second layer's
    gradient.  Returns (main, startup, cost, ModelAverage or None)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64])
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=width, act="relu",
                            param_attr=fluid.ParamAttr(
                                gradient_clip=fluid.clip.GradientClipByValue(
                                    0.01),
                                regularizer=fluid.regularizer.L1Decay(1e-3)))
        h = fluid.layers.fc(input=h, size=width, act="tanh",
                            param_attr=fluid.ParamAttr(
                                gradient_clip=fluid.clip.GradientClipByNorm(
                                    0.5)))
        h.error_clip = fluid.clip.ErrorClipByValue(0.05)
        h.print_gradient = print_grad
        h = fluid.layers.fc(
            input=h, size=width, act="sigmoid", param_attr=fluid.ParamAttr(
                gradient_clip=fluid.clip.GradientClipByGlobalNorm(0.5)))
        cost = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(input=h, size=10), y))
        OPT_CLASSES[name](dict(
            regularization=fluid.regularizer.L2Decay(1e-3),
            global_clip_norm=1.0)).minimize(cost)
        ma = fluid.optimizer.ModelAverage(max_average_window=average,
                                          program=main) if average else None
    startup.random_seed = SEED
    return main, startup, cost, ma


def mlp_feed(rng, lead=(), bs=32):
    return {"x": rng.randn(*lead, bs, 64).astype(np.float32),
            "y": rng.randint(0, 10, (*lead, bs, 1)).astype(np.int64)}


def state_rel(got, want):
    """Each tensor's distance by norm, relative to `want`'s norm."""
    out = {}
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        out[n] = float(np.linalg.norm(np.asarray(got[n], np.float64) - w)
                       / max(float(np.linalg.norm(w)), 1e-30))
    return out


def twin_scope(main, scope):
    twin = fluid.Scope()
    for n in persistables(main):
        twin.set(n, scope.find(n).clone())
    return twin


def same_bits(main, sa, sb):
    return all(torch.equal(sa.find(n), sb.find(n)) for n in persistables(main))


def k_dispatches(tag, exe, main, cost, scope, rng, dispatches, between=None):
    """`dispatches` dispatches of OPT_MLP_K steps against `scope` (the
    first eager, the second captured, the rest replays), each equal to
    the bit to OPT_MLP_K eager steps of a twin scope from the same state;
    `between(d)` runs after dispatch d."""
    k = OPT_MLP_K
    for d in range(dispatches):
        feed = mlp_feed(rng, (k,))
        twin = twin_scope(main, scope)
        ref = fluid.Executor(fluid.CUDAPlace(0))
        want = np.stack([ref.run(main, feed={n: v[i] for n, v in
                                             feed.items()},
                                 fetch_list=[cost], scope=twin)[0]
                         for i in range(k)])
        got = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                      steps_per_dispatch=k)[0]
        if not (np.array_equal(got, want) and same_bits(main, scope, twin)):
            raise AssertionError(f"{tag}: dispatch {d} differs from "
                                 f"{k} eager steps from its state")
        if between is not None:
            between(d)


def options_mlp_phase():
    """25c. Every optimizer class with every regularizer and clip kind
    (``options_mlp``): 3 card steps against 3 explicit-CPU steps from the
    card's startup state, losses and every persistable within OPT_MLP_TOL;
    then K = 2 dispatches (eager, capture, replay) each bitwise against
    eager steps.  No port kernel runs here."""
    rows = {}
    for name in OPT_CLASSES:
        main, startup, cost, _ = options_mlp(name)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        names = persistables(main)
        cpu_scope = fluid.Scope()
        fluid.load_persistables(main, {n: scope.find_np(n) for n in names},
                                cpu_scope)
        cpu = fluid.Executor(fluid.CPUPlace())
        rng = np.random.RandomState(SEED)
        feeds = [mlp_feed(rng) for _ in range(3)]
        (card_l, cpu_l), launches = counted(lambda: [
            [float(e.run(main, feed=f, fetch_list=[cost], scope=sc)[0][0])
             for f in feeds] for e, sc in ((exe, scope), (cpu, cpu_scope))])
        if any(launches.values()):
            raise AssertionError(f"options_mlp {name}: launched {launches}")
        rel = state_rel({n: scope.find_np(n) for n in names},
                        {n: cpu_scope.find_np(n) for n in names})
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        worst = max(rel, key=rel.get)
        if loss_rel > OPT_MLP_TOL or rel[worst] > OPT_MLP_TOL:
            raise AssertionError(
                f"options_mlp {name}: card and CPU disagree: losses "
                f"{card_l} vs {cpu_l}, worst state {worst} {rel[worst]}")
        k_dispatches(f"options_mlp {name}", exe, main, cost, scope,
                     np.random.RandomState(SEED + 1), 3)
        exe.close()
        rows[name] = {"card_losses": card_l, "cpu_losses": cpu_l,
                      "loss_rel": loss_rel, "state_rel_max": rel[worst],
                      "worst": worst, "k2_bitwise": True}
    res = {"tol": OPT_MLP_TOL, "k": OPT_MLP_K, "classes": rows}
    log("options_mlp", res)
    return res


def options_average_phase():
    """25d. ModelAverage (window 3) on the options MLP with Adam, K = 2:
    after the first replay ``apply`` swaps the averages in (each the
    window sums over the counts) and ``restore`` puts the raw parameters
    back; the next replays equal eager steps from the raw parameters, to
    the bit."""
    main, startup, cost, ma = options_mlp("Adam", average=3)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    seen = {}

    def swap(d):
        if d != 1:
            return
        raw = {p.name: scope.find(p.name).clone() for p in ma._params}
        with ma.apply(exe, scope=scope):
            for p in ma._params:
                acc = ma._accs[p.name]
                n = sum(float(scope.find(acc[c])[0])
                        for c in ("num_acc", "old_num_acc"))
                want = ((scope.find(acc["sum_1"]) + scope.find(acc["sum_2"]))
                        / n).to(raw[p.name].dtype)
                if not torch.equal(scope.find(p.name), want):
                    raise AssertionError(f"options_average: {p.name} is not "
                                         f"its window's mean")
            seen["moved"] = not torch.equal(
                scope.find(ma._params[0].name), raw[ma._params[0].name])
        if not all(torch.equal(scope.find(n), t) for n, t in raw.items()):
            raise AssertionError("options_average: restore did not give the "
                                 "raw parameters back")

    k_dispatches("options_average", exe, main, cost, scope,
                 np.random.RandomState(SEED + 2), 4, between=swap)
    exe.close()
    if not seen.get("moved"):
        raise AssertionError("options_average: the average equals the raw "
                             "parameters")
    res = {"window": 3, "k": OPT_MLP_K, "dispatches": 4,
           "apply_restore_after_dispatch": 1, "bitwise": True}
    log("options_average", res)
    return res


def options_print_phase():
    """25f. The options MLP (width 8, batch 4) with ``print_gradient``:
    K = 2 warns that the block is loop-unsafe naming its ``print`` op,
    runs 2 eager steps, and equals 2 eager runs to the bit."""
    main, startup, cost, _ = options_mlp("SGD", print_grad=True, width=8)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    k = OPT_MLP_K
    feed = mlp_feed(np.random.RandomState(SEED + 3), (k,), bs=4)
    twin = twin_scope(main, scope)
    want = np.stack([fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed={n: v[i] for n, v in feed.items()}, fetch_list=[cost],
        scope=twin)[0] for i in range(k)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                      steps_per_dispatch=k)[0]
    said = [str(w.message) for w in caught]
    if not any("loop-unsafe" in m and "'print'" in m for m in said):
        raise AssertionError(f"options_print: no warning naming print: "
                             f"{said}")
    if not (np.array_equal(got, want) and same_bits(main, scope, twin)) \
            or any(e.loop is not None for e in exe._loops.values()):
        raise AssertionError("options_print: the eager K steps differ from "
                             "K runs, or a loop was captured")
    res = {"warning": said[0], "equal": True}
    log("options_print", res)
    return res


def options_book_phase():
    """25e. The book paths on the card, data in synthetic mode (a
    DATA_HOME with nothing in it): fit_a_line's SGD reaches a loss under
    0.1 in 30 epochs of uci_housing; recognize_digits' conv net (two
    ``simple_img_conv_pool``, ``cross_entropy``, Adam) gives parity_run's
    three card steps against the CPU.  Neither reaches a port kernel."""
    common = fluid.dataset.common
    home = common.DATA_HOME
    common.DATA_HOME = os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "_no_dataset_files")
    try:
        fluid.reset()
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        cost = fluid.layers.mean(fluid.layers.square_error_cost(
            input=fluid.layers.fc(input=x, size=1), label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
        fluid.default_startup_program().random_seed = SEED
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(fluid.default_startup_program())
        samples = list(fluid.dataset.uci_housing.train(n=512)())
        mode = common.data_mode("uci_housing")
        xs = np.stack([s[0] for s in samples]).astype(np.float32)
        ys = np.stack([s[1] for s in samples]).astype(np.float32)
        ys = ys.reshape(-1, 1) / max(1.0, float(np.abs(ys).max()))
        losses = []
        for _ in range(30):
            for i in range(0, len(xs), 64):
                out = exe.run(feed={"x": xs[i:i + 64], "y": ys[i:i + 64]},
                              fetch_list=[cost])
            losses.append(float(out[0][0]))
        if mode != "synthetic" or not losses[-1] < 0.1:
            raise AssertionError(f"fit_a_line ({mode}): losses {losses}")

        fluid.reset()
        img = fluid.layers.data(name="img", shape=[1, 28, 28])
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        h = fluid.nets.simple_img_conv_pool(
            input=h, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        prob = fluid.layers.softmax(fluid.layers.fc(input=h, size=10))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=prob,
                                                            label=label))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        startup = fluid.default_startup_program()
        startup.random_seed = SEED
        digits = list(fluid.dataset.mnist.train(n=64)())
        feed = {"img": np.stack([d[0] for d in digits]).reshape(
                    -1, 1, 28, 28).astype(np.float32),
                "label": np.array([[d[1]] for d in digits], np.int64)}
        conv = parity_run("book_conv_parity", fluid.default_main_program(),
                          startup, loss, feed, ["conv2d_0.w_0@GRAD",
                                                "fc_0.w_0@GRAD"], {},
                          {"bs": 64, "image": 28})
        conv["data_mode"] = common.data_mode("mnist")
    finally:
        common.DATA_HOME = home
    res = {"fit_a_line": {"data_mode": mode, "losses_by_epoch": losses},
           "recognize_digits_conv": conv}
    log("options_book", res)
    return res


def options_phase(card_name, smi, plain):
    """25. the training options, sub-phases a to f."""
    fluid.reset()
    torch.cuda.empty_cache()
    return {"gpt_parity_f32": options_parity_phase(),
            "gpt_bench_bf16": options_bench_phase(card_name, smi, plain),
            "mlp_every_class": options_mlp_phase(),
            "model_average": options_average_phase(),
            "book": options_book_phase(),
            "print": options_print_phase()}


# -- 26. generation ---------------------------------------------------------

# the GPT generation runs (bench.py bench_gpt_generate: P 64, G 192, batch
# 8, bf16); the position table holds P + G = 256 rows
GEN_MAX_LEN, GEN_P, GEN_G, GEN_BS = 256, 64, 32, 4
GEN_BENCH_BS, GEN_BENCH_G, GEN_BENCH_CALLS = 8, 192, 3
BEAM_BS, BEAM_K = 2, 4
SAMPLE_TEMP, SAMPLE_TOP_K = 0.8, 40
# the NMT book's widths at generation: beam 4, 16 target steps
NMT_GEN_BS, NMT_GEN_SRC, NMT_GEN_BEAM, NMT_GEN_LEN = 8, 64, 4, 16
# K1 at the prefill's shape (batch 8, 8 heads, P 64, dh 64) and an odd P
GEN_FLASH_SHAPES = [(8, HEADS, 64, DIM // HEADS), (8, HEADS, 37,
                                                   DIM // HEADS)]


def gen_model(dtype):
    """The GPT bench width (vocab 32000, dim 512, 8 layers, 8 heads) with
    a 256-row position table, its tower over P + G = 96 tokens built and
    its startup run on the card from SEED, in fresh default programs and
    scope; returns (lm, tower logits)."""
    fluid.reset()
    lm = transformer.DecoderLM(VOCAB, DIM, LAYERS, HEADS,
                               max_len=GEN_MAX_LEN, dtype=dtype)
    logits = lm.logits(fluid.layers.data("tokens", shape=[GEN_P + GEN_G, 1],
                                         dtype="int64"))
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    return lm, logits


def gen_program(make):
    """`make(prompt)` over a [GEN_P, 1] prompt in a program of its own;
    returns (program, its outputs)."""
    prog = fluid.Program()
    with fluid.program_guard(prog):
        outs = make(fluid.layers.data("prompt", shape=[GEN_P, 1],
                                      dtype="int64"))
    return prog, outs


def gen_prompts(bs, seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (bs, GEN_P, 1)).astype(np.int64)


def tower_logits(exe, logits, prompts, ids, scope=None):
    """The tower's f32 logits [B, P + G, V] over prompt + ids."""
    full = np.concatenate([prompts, ids[:, :, None]], axis=1)
    return exe.run(feed={"tokens": full}, fetch_list=[logits],
                   scope=scope)[0].astype(np.float32)


def seq_logprob(lg, P, seq, eos=-1):
    """Sum of log-probs of `seq` [B, G] under tower logits [B, P + G, V],
    in float64, up to and including its first eos (a beam lane's score
    stops growing there)."""
    z = lg.astype(np.float64)
    lp = z - z.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    tot = np.zeros(seq.shape[0])
    live = np.ones(seq.shape[0], bool)
    for t in range(seq.shape[1]):
        tot += np.where(live, lp[np.arange(len(seq)), P + t - 1, seq[:, t]],
                        0.0)
        if eos >= 0:
            live &= seq[:, t] != eos
    return tot


def tower_gaps(lg, P, ids):
    """How far below the tower's best logit each generated token lies
    (max over the run) and how many are the tower's argmax."""
    B, G = ids.shape
    steps = lg[:, P - 1:P + G - 1]  # [B, G, V]
    chosen = np.take_along_axis(steps, ids[:, :, None], axis=2)[..., 0]
    return (float((steps.max(-1) - chosen).max()),
            int((steps.argmax(-1) == ids).sum()))


def gen_flash_rows(dev):
    """K1 against its plain version at the generation prefill's shapes,
    causal, f32 and bf16; the rows at P 64 (the bench's prefill) are
    timed beside the plain version, the bound and SDPA."""
    rows = []
    for dtype in DTYPES:
        for B, H, T, D in GEN_FLASH_SHAPES:
            g = torch.Generator(device=dev).manual_seed(SEED + 64 + T)
            q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            out = fa.flash_attention(q, k, v, causal=True)
            ref = fa.flash_attention_ref(q, k, v, causal=True)
            row = {"dtype": str(dtype).split(".")[1], "B": B, "H": H,
                   "T": T, "D": D, "causal": True,
                   "max_abs_err": max_err(out, ref), "tol": TOL[dtype]}
            if row["max_abs_err"] > TOL[dtype]:
                raise AssertionError(f"K1 at a generation prefill shape "
                                     f"disagrees with its plain version: "
                                     f"{row}")
            if T == GEN_P:
                nbytes = 4 * B * H * T * D * q.element_size()
                flops = 2 * D * T * (T + 1) * B * H
                b_ms, b_by, extra = flash_bound("flash_attention", nbytes,
                                                flops, dtype)
                row.update({
                    "design": DESIGN[dtype]["flash_attention"],
                    "kernel_ms": time_ms(lambda: fa.flash_attention(
                        q, k, v, causal=True)),
                    "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                        q, k, v, causal=True)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by, **extra})
                ratios(row)
            rows.append(row)
            log("gen_flash_attention", row)
    return rows


def no_host_sync(lm, prompts, max_gen):
    """One ``gpt_decode`` call, its emitter run directly on the card's
    tensors under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing calls it made (must be none) and the number of
    warnings seen in all."""
    with fluid.program_guard(fluid.Program()):
        slots = lm._decode_inputs(fluid.layers.data(
            "sync.prompt", shape=[prompts.shape[1], 1], dtype="int64"))
    scope = fluid.global_scope()
    dev = torch.device("cuda", 0)
    ins = {s: [scope.find(n) for n in names] for s, names in slots.items()
           if s != "Tokens"}
    ins["Tokens"] = [torch.as_tensor(prompts, device=dev)]
    ctx = EmitContext(dev, is_test=True)
    attrs = {"n_heads": HEADS, "max_gen": max_gen, "eos_id": -1,
             "eps": 1e-5, "temperature": 0.0, "top_k": 0}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                get_op_info("gpt_decode").emit(ctx, ins, attrs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own notice ("a prototype feature ...") is no sync
    syncs = [str(w.message)[:160] for w in seen
             if "called a synchronizing" in str(w.message)]
    torch.cuda.synchronize()
    return syncs, len(seen)


def merged_us(spans):
    """The time covered by (start, end) intervals, overlaps counted once:
    the device's busy time from its kernels' intervals."""
    busy, end = 0.0, None
    for s, f in sorted(spans):
        if end is None or s > end:
            busy, end = busy + f - s, f
        elif f > end:
            busy, end = busy + f - end, f
    return busy


def profile_generate(exe, prog, feed, fetch):
    """One generate call under torch.profiler: device busy share of its
    wall (kernel intervals merged; the profiler inflates the wall), device
    ms in all and in K1's bodies, and the kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        exe.run(prog, feed=feed, fetch_list=fetch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans, k1_us = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "flash_fwd" in e.name:
            k1_us += e.time_range.elapsed_us()
    if not spans:
        return {"profiled": "not measured: the profiler saw no device "
                            "event"}
    busy = merged_us(spans)
    return {"wall_ms_profiled": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "k1_device_ms": k1_us / 1e3,
            "k1_share_of_device": k1_us / busy if busy else 0.0,
            "kernels": len(spans)}


def gpt_parity_and_sampling(lm, logits):
    """The f32 model: greedy parity with an explicit-CPU executor and
    teacher forcing on the card (a); beams with and without eos (c);
    sampling's properties (d)."""
    card = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.global_scope()
    arrays = [scope.find_np(p.name) for p in lm._params]
    scope_cpu = cpu_scope(lm, arrays)
    cpu = fluid.Executor(fluid.CPUPlace())

    # (a) greedy, batch 4, P 64, G 32
    prompts = gen_prompts(GEN_BS, SEED + 1)
    prog, (ids,) = gen_program(lambda p: [lm.generate(p, max_gen=GEN_G)])
    feed = {"prompt": prompts}
    card.run(prog, feed=feed, fetch_list=[ids])  # the first call
    (gpu_ids,), launches = counted(
        lambda: card.run(prog, feed=feed, fetch_list=[ids]))
    check_launches("gpt_generate_f32", launches,
                   {"flash_attention": LAYERS})
    t0 = time.monotonic()
    (cpu_ids,) = cpu.run(prog, feed=feed, fetch_list=[ids], scope=scope_cpu)
    cpu_s = time.monotonic() - t0
    plist = [p[:, 0].tolist() for p in prompts]
    greedy = agree("gpt_generate_agreement", lm, scope_cpu, plist,
                   cpu_ids.tolist(), gpu_ids.tolist(), cpu_s=cpu_s)
    gap, argmax_hits = tower_gaps(tower_logits(card, logits, prompts,
                                               gpu_ids), GEN_P, gpu_ids)
    res = {"greedy": {**greedy, "bs": GEN_BS, "P": GEN_P, "G": GEN_G,
                      "launches": launches,
                      "teacher_forcing_max_gap": gap,
                      "teacher_forcing_argmax": argmax_hits,
                      "teacher_forcing_of": gpu_ids.size}}
    log("gpt_generate_teacher_forcing", res["greedy"])
    if gap > 1e-4:
        raise AssertionError(f"a greedy token lies {gap} below the tower's "
                             f"best logit (stable_argmax's slack 1e-4)")

    # (c) beams: batch 2, K 4, G 32, without and with eos; beside them
    # K 1 and greedy on the same prompts
    bprompts = gen_prompts(BEAM_BS, SEED + 2)
    bfeed = {"prompt": bprompts}
    res["beam"] = []
    eos = -1
    for _ in range(2):
        prog_b, outs = gen_program(lambda p: [
            *lm.beam_generate(p, max_gen=GEN_G, beam_size=BEAM_K,
                              eos_id=eos),
            lm.beam_generate(p, max_gen=GEN_G, beam_size=1, eos_id=eos)[0],
            lm.generate(p, max_gen=GEN_G, eos_id=eos)])
        (g_ids, g_sc, g_k1, g_greedy), launches = counted(
            lambda: card.run(prog_b, feed=bfeed, fetch_list=list(outs)))
        check_launches("gpt_beam_f32", launches,
                       {"flash_attention": 3 * LAYERS})
        c_ids, c_sc, _, _ = cpu.run(prog_b, feed=bfeed,
                                    fetch_list=list(outs), scope=scope_cpu)

        def beam_run(exe, full, scope=None, eos=eos):
            def go(n):
                if n == GEN_G:  # the runs above
                    return full
                prog, outs = gen_program(lambda p: list(lm.beam_generate(
                    p, max_gen=n, beam_size=BEAM_K, eos_id=eos)))
                return exe.run(prog, feed=bfeed, fetch_list=list(outs),
                               scope=scope)
            return go

        parting = first_parting(
            "gpt beam, card against CPU", beam_run(card, (g_ids, g_sc)),
            beam_run(cpu, (c_ids, c_sc), scope_cpu), GEN_G, 1e-4)
        best_lp = seq_logprob(tower_logits(card, logits, bprompts,
                                           g_ids[:, 0]), GEN_P, g_ids[:, 0],
                              eos)
        greedy_lp = seq_logprob(tower_logits(card, logits, bprompts,
                                             g_greedy), GEN_P, g_greedy, eos)
        k1 = g_k1[:, 0]
        k1_gap, _ = tower_gaps(tower_logits(card, logits, bprompts, k1),
                               GEN_P, k1) if eos < 0 else (0.0, 0)
        row = {"eos": eos, "bs": BEAM_BS, "K": BEAM_K, "G": GEN_G,
               "card_vs_cpu": parting,
               "best_lane_scores": g_sc[:, 0].tolist(),
               "best_lane_tower_logprob": best_lp.tolist(),
               "greedy_logprob": greedy_lp.tolist(),
               "best_at_least_greedy": int((g_sc[:, 0] >= greedy_lp
                                            - 1e-3).sum()),
               "k1_tower_max_gap": k1_gap,
               "k1_equal_greedy": bool((k1 == g_greedy).all()),
               "launches": launches}
        res["beam"].append(row)
        log("gpt_beam_generate", row)
        if np.abs(g_sc[:, 0] - best_lp).max() > 1e-3 or k1_gap > 1e-4:
            raise AssertionError(f"beam bookkeeping: the best lane's score "
                                 f"is not its tower log-prob (1e-3), or K 1 "
                                 f"left the tower's best (1e-4): {row}")
        if eos >= 0:
            for lane in g_ids.reshape(-1, GEN_G):
                hit = np.where(lane == eos)[0]
                if hit.size and (lane[hit[0]:] != eos).any():
                    raise AssertionError(f"tokens after eos: {lane}")
        # the second pass takes an eos that the first one's lanes emit
        eos = int(np.bincount(g_ids.ravel()).argmax())

    # (d) sampling: temperature 0.8, top_k 40 (and top_k 1), batch 4
    prog_s, outs = gen_program(lambda p: [
        lm.generate(p, max_gen=GEN_G, temperature=SAMPLE_TEMP,
                    top_k=SAMPLE_TOP_K),
        lm.generate(p, max_gen=GEN_G, temperature=SAMPLE_TEMP, top_k=1)])

    def sample(step):
        return card.run(prog_s, feed=feed, fetch_list=list(outs),
                        rng_step=step)

    s_a, k1_a = sample(11)
    s_b, _ = sample(11)
    s_c, _ = sample(12)
    k1_gap, _ = tower_gaps(tower_logits(card, logits, prompts, k1_a),
                           GEN_P, k1_a)
    lg_cpu = tower_logits(cpu, logits, prompts, s_a, scope=scope_cpu)
    steps = lg_cpu[:, GEN_P - 1:GEN_P + GEN_G - 1]
    kth = np.sort(steps, axis=-1)[..., -SAMPLE_TOP_K]
    chosen = np.take_along_axis(steps, s_a[:, :, None], axis=2)[..., 0]
    row = {"temperature": SAMPLE_TEMP, "top_k": SAMPLE_TOP_K,
           "replays": bool((s_a == s_b).all()),
           "other_step_differs": bool((s_a != s_c).any()),
           "tokens_off_greedy": int((s_a != gpu_ids).sum()),
           "top_k_margin_min": float((chosen - kth).min()),
           "top_k1_max_gap": k1_gap,
           "top_k1_equal_greedy": int((k1_a == gpu_ids).sum()),
           "of": s_a.size}
    res["sampling"] = row
    log("gpt_sampling", row)
    if not (row["replays"] and row["other_step_differs"]
            and row["top_k_margin_min"] >= -1e-4 and k1_gap <= 1e-4):
        raise AssertionError(f"sampling's properties fail: {row}")
    return res


def gpt_bench_generate(card_name, smi):
    """(b): bf16 at bench.py's shape, batch 8, P 64, G 192: one call to
    warm up, GEN_BENCH_CALLS measured (decoded tok/s = B·G over the wall
    of one call, to the fetched ids), K1 launched 8 times a call, peak
    memory, one profiled call, and no host sync inside the op."""
    lm, _ = gen_model("bfloat16")
    card = fluid.Executor(fluid.CUDAPlace(0))
    prompts = np.random.RandomState(0).randint(
        0, VOCAB, (GEN_BENCH_BS, GEN_P, 1)).astype(np.int64)
    prog, (ids,) = gen_program(lambda p: [lm.generate(
        p, max_gen=GEN_BENCH_G)])
    feed = {"prompt": prompts}
    card.run(prog, feed=feed, fetch_list=[ids])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, launches = [], []
    for _ in range(GEN_BENCH_CALLS):
        t0 = time.monotonic()
        (out,), n = counted(lambda: card.run(prog, feed=feed,
                                             fetch_list=[ids]))
        walls.append(time.monotonic() - t0)
        check_launches("gpt_generate_bf16", n, {"flash_attention": LAYERS})
        launches.append(n)
    if not ((0 <= out) & (out < VOCAB)).all():
        raise AssertionError("generated ids out of the vocab")
    syncs, warned = no_host_sync(lm, prompts, GEN_BENCH_G)
    prof = profile_generate(card, prog, feed, [ids])
    res = {"card": card_name, "nvidia_smi": smi, "dtype": "bfloat16",
           "bs": GEN_BENCH_BS, "P": GEN_P, "G": GEN_BENCH_G,
           "wall_ms": [w * 1e3 for w in walls],
           "tok_s": [GEN_BENCH_BS * GEN_BENCH_G / w for w in walls],
           "tok_s_best": GEN_BENCH_BS * GEN_BENCH_G / min(walls),
           "ms_per_step": min(walls) * 1e3 / GEN_BENCH_G,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_call": launches[-1],
           "host_syncs_in_op": syncs, "sync_debug_warnings": warned,
           **prof}
    log("gpt_generate_bench", res)
    if syncs:
        raise AssertionError(f"gpt_decode synchronized with the host: "
                             f"{syncs}")
    return res


def first_parting(tag, run_a, run_b, steps, tol):
    """Hold two beam decoders to each other: `run_x(L)` decodes L steps
    and returns (ids [B, K, L], scores [B, K]).  Equal ids and scores
    within `tol` over all `steps`, or else, decoding 1, 2, ... steps,
    equal ids and scores up to the first step where the ids part, and
    there the scores within `tol`: the two broke a tie (at random
    weights the beams' candidates lie within 1e-4 of one another, and
    two candidates' f32 sums can round to one value) in different ways.
    Returns the step where they parted (None if never) and the scores'
    distance."""
    a, b = run_a(steps), run_b(steps)
    err = float(np.abs(a[1] - b[1]).max())
    if (a[0] == b[0]).all() and err <= tol:
        return {"parted_at": None, "score_max_abs_err": err}
    for n in range(1, steps + 1):
        a, b = run_a(n), run_b(n)
        err = float(np.abs(a[1] - b[1]).max())
        if err > tol:
            raise AssertionError(f"{tag}: after {n} steps the scores are "
                                 f"{err} apart (tolerance {tol})")
        if (a[0] != b[0]).any():
            return {"parted_at": n, "score_max_abs_err": err}
    raise AssertionError(f"{tag}: {steps} steps part, no shorter run does")


def nmt_generate_phase():
    """The attention NMT at the book's widths (dictionaries 30000,
    embedding, hidden and attention 512), batch 8, source 64 ragged, beam
    4, 16 steps: ``generate`` on the card against an explicit-CPU
    executor and ``generate_composable`` against ``generate`` on the card,
    each held by ``first_parting`` (scores within 1e-4; ids equal up to
    a tie; lengths exactly where the ids are, the composable loop's
    stopping before eos), K9 twice a call in each."""
    fluid.reset()
    progs = {}

    def programs(n):
        """generate and generate_composable decoding n steps, in programs
        of their own (the parameters are the scope's, by name)."""
        if n not in progs:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                gen, comp_prog, comp = rnn_bench.nmt_generate_programs(
                    seq_len=NMT_GEN_SRC, beam_size=NMT_GEN_BEAM, max_len=n)
            progs[n] = (main, startup, gen, comp_prog, comp)
        return progs[n]

    main, startup, gen, comp_prog, comp = programs(NMT_GEN_LEN)
    startup.random_seed = SEED
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    state = {n: fluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    cpu_sc = fluid.Scope()
    fluid.load_persistables(main, state, cpu_sc)
    cpu = fluid.Executor(fluid.CPUPlace())
    nf = rnn_bench.nmt_feed(NMT_GEN_BS, NMT_GEN_SRC)
    feed = {"src": nf["src"], "src@LENGTH": nf["src@LENGTH"]}
    want = {"gru_forward": 2}
    card.run(main, feed=feed, fetch_list=list(gen))
    t0 = time.monotonic()
    g, launches = counted(lambda: card.run(main, feed=feed,
                                           fetch_list=list(gen)))
    wall = time.monotonic() - t0
    check_launches("nmt_generate", launches, want)
    t0 = time.monotonic()
    c, c_launches = counted(lambda: card.run(comp_prog, feed=feed,
                                             fetch_list=list(comp)))
    comp_wall = time.monotonic() - t0
    check_launches("nmt_generate_composable", c_launches, want)
    t0 = time.monotonic()
    cg = cpu.run(main, feed=feed, fetch_list=list(gen), scope=cpu_sc)
    cpu_s = time.monotonic() - t0

    def run(which, exe, scope=None):
        def go(n):
            if n == NMT_GEN_LEN:  # the runs above
                return {("gen", "card"): g, ("comp", "card"): c,
                        ("gen", "cpu"): cg}[(which, exe)][:2]
            m, _, gn, cp, cm = programs(n)
            prog, outs = (m, gn) if which == "gen" else (cp, cm)
            x = card if exe == "card" else cpu
            return x.run(prog, feed=feed, fetch_list=list(outs),
                         scope=cpu_sc if exe == "cpu" else None)[:2]
        return go

    vs_cpu = first_parting("nmt generate, card against CPU",
                           run("gen", "card"), run("gen", "cpu"),
                           NMT_GEN_LEN, 1e-4)
    vs_gen = first_parting("nmt generate_composable against generate",
                           run("comp", "card"), run("gen", "card"),
                           NMT_GEN_LEN, 1e-4)
    has_eos = (g[0] == 1).any(-1)
    res = {"bs": NMT_GEN_BS, "src": NMT_GEN_SRC, "beam": NMT_GEN_BEAM,
           "max_len": NMT_GEN_LEN, "card_vs_cpu": vs_cpu,
           "composable_vs_generate": vs_gen,
           "lanes_with_eos": int(has_eos.sum()),
           "wall_ms": wall * 1e3, "composable_wall_ms": comp_wall * 1e3,
           "cpu_s": cpu_s, "launches": launches,
           "composable_launches": c_launches}
    log("nmt_generate", res)
    if vs_cpu["parted_at"] is None and (g[2] != cg[2]).any():
        raise AssertionError(f"NMT lengths: card and CPU disagree: {res}")
    if vs_gen["parted_at"] is None and (c[2] != g[2] - has_eos).any():
        raise AssertionError(f"NMT lengths: the composable loop's are not "
                             f"generate's short of the eos: {res}")
    return res


def cf_sgd_steps(tag, build, feed):
    """3 SGD steps of the program `build()` makes, on the card and on an
    explicit-CPU executor from the card's startup state: losses within
    1e-4 relative, every persistable within 1e-4 of its max |value|."""
    fluid.reset()
    loss = build()
    main = fluid.default_main_program()
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    scope = fluid.global_scope()
    names = [n for n, v in main.global_block().vars.items()
             if v.persistable]
    state = {n: scope.find_np(n) for n in names}
    cpu_sc = fluid.Scope()
    fluid.load_persistables(main, state, cpu_sc)
    cpu = fluid.Executor(fluid.CPUPlace())
    gl = [float(card.run(main, feed=feed, fetch_list=[loss])[0].ravel()[0])
          for _ in range(3)]
    cl = [float(cpu.run(main, feed=feed, fetch_list=[loss],
                        scope=cpu_sc)[0].ravel()[0]) for _ in range(3)]
    state_rel = max(float(np.abs(scope.find_np(n) - cpu_sc.find_np(n)).max()
                          / max(np.abs(cpu_sc.find_np(n)).max(), 1e-12))
                    for n in names)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    res = {"gpu_losses": gl, "cpu_losses": cl, "loss_rel_err": loss_rel,
           "state_rel_err_max": state_rel}
    log(tag, res)
    if loss_rel > 1e-4 or state_rel > 1e-4:
        raise AssertionError(f"{tag}: card and CPU disagree: {res}")
    return res


def control_flow_phase():
    """``While`` sums 0..9 on the card; 3 SGD steps of a ``StaticRNN``
    and of a ragged ``DynamicRNN``, card against CPU; ``ifelse``'s
    gradients on the card against the CPU's for both branches (1e-4 of
    max |g|).  No port kernel runs here."""
    res = {}
    fluid.reset()
    i = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0)
    n = fluid.layers.fill_constant(shape=[1], dtype="float32", value=10)
    total = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0)
    cond = fluid.layers.less_than(i, n)
    w = fluid.layers.While(cond)
    with w.block():
        fluid.layers.assign(fluid.layers.elementwise_add(total, i), total)
        fluid.layers.increment(i, 1.0)
        fluid.layers.less_than(i, n, cond=cond)
    (tot,), launches = counted(lambda: fluid.Executor(
        fluid.CUDAPlace(0)).run(feed={}, fetch_list=[total]))
    res["while_total"] = float(tot.ravel()[0])
    if res["while_total"] != 45.0 or any(launches.values()):
        raise AssertionError(f"While on the card: {res}, {launches}")

    def static_rnn():
        x = fluid.layers.data(name="x", shape=[5, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            h_prev = rnn.memory(shape=[16], batch_ref=x)
            h = fluid.layers.fc(input=[rnn.step_input(x), h_prev], size=16,
                                act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        logits = fluid.layers.fc(input=fluid.layers.reshape(
            rnn(), [-1, 5 * 16]), size=2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    def dynamic_rnn():
        x = fluid.layers.sequence_data(name="x", shape=[4], dtype="float32")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(shape=[8], batch_ref=x)
            h = fluid.layers.fc(input=[x_t, h_prev], size=8, act="relu")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        pooled = fluid.layers.sequence_pool(rnn(), pool_type="sum")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(input=pooled, size=1),
            fluid.layers.data(name="y", shape=[1], dtype="float32")))
        fluid.optimizer.SGD(learning_rate=0.02).minimize(loss)
        return loss

    rng = np.random.RandomState(SEED)
    labels = rng.randint(0, 2, (64, 1)).astype(np.int64)
    res["static_rnn"] = cf_sgd_steps("cf_static_rnn", static_rnn, {
        "x": rng.rand(64, 5, 8).astype(np.float32) + labels[:, :, None] * .5,
        "y": labels})
    seqs = [rng.rand(k, 4).astype(np.float32) for k in (3, 6, 1, 4)]
    res["dynamic_rnn"] = cf_sgd_steps("cf_dynamic_rnn", dynamic_rnn, {
        "x": LoDTensor.from_sequences(seqs),
        "y": rng.rand(4, 1).astype(np.float32)})

    fluid.reset()
    fluid.default_startup_program().random_seed = SEED
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    flag = fluid.layers.data(name="flag", shape=[1], dtype="float32",
                             append_batch_size=False)
    out = fluid.layers.ifelse(
        flag, lambda: [fluid.layers.fc(input=x, size=3, act="tanh")],
        lambda: [fluid.layers.scale(fluid.layers.fc(input=x, size=3), -1.0)])
    loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, out))
    grads = fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)[1]
    gnames = [g.name for _, g in grads]
    main = fluid.default_main_program()
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(fluid.default_startup_program())
    state = {n: fluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    errs = {}
    for f in (1.0, 0.0):
        cpu_sc = fluid.Scope()
        fluid.load_persistables(main, state, cpu_sc)
        fluid.load_persistables(main, state)
        feed = {"x": rng.randn(2, 4).astype(np.float32),
                "flag": np.asarray([f], np.float32)}
        g = card.run(main, feed=feed, fetch_list=gnames)
        c = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                 fetch_list=gnames,
                                                 scope=cpu_sc)
        errs[str(f)] = max(float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-12))
                           for a, b in zip(g, c))
        zero = sum(int(not np.abs(a).any()) for a in g)
        if errs[str(f)] > 1e-4 or zero != 2:
            raise AssertionError(f"ifelse gradients, flag {f}: rel err "
                                 f"{errs[str(f)]}, {zero} zero grads "
                                 f"(the untaken branch's 2)")
    res["ifelse_grad_rel_err"] = errs
    log("control_flow", res)
    return res


def generation_phase(dev, card_name, smi):
    """26. generation: the GPT (a) greedy parity, (b) the bf16 bench, (c)
    beams, (d) sampling; K1 at the prefill's shapes; the NMT; control
    flow."""
    fluid.reset()
    torch.cuda.empty_cache()
    flash_rows = gen_flash_rows(dev)
    lm, logits = gen_model("float32")
    res = gpt_parity_and_sampling(lm, logits)
    res["bench_bf16"] = gpt_bench_generate(card_name, smi)
    res["flash_rows"] = flash_rows
    res["nmt"] = nmt_generate_phase()
    res["control_flow"] = control_flow_phase()
    return res


# -- 27. dropout and remat: GPT training at the bench shape -------------------

GPT_DROPOUT = 0.1
GPT_REMAT_STEPS = 10
# the bf16 kernels of the flash path, by the names the profiler shows
FLASH_BF16_BODIES = {"flash_attention_fwd": "flash_fwd_mma_kernel",
                     "flash_attention_dq": "flash_dq_mma_kernel",
                     "flash_attention_dkv": "flash_dkv_mma_kernel"}


def lm_program(seq, dtype, remat=False, dropout_prob=0.0):
    """The bench GPT (``build_lm_train_program``'s tower, loss and Adam
    3e-4 at bench.py's width) with ``decoder_lm``'s `dropout_prob` and
    `remat`, in fresh default programs and scope; returns (loss, logits,
    main, startup).  The parameter names do not depend on either."""
    fluid.reset()
    tokens = fluid.layers.data("tokens", shape=[seq, 1], dtype="int64")
    targets = fluid.layers.data("targets", shape=[seq, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, VOCAB, DIM, LAYERS, HEADS,
                                    max_len=seq, dtype=dtype,
                                    dropout_prob=dropout_prob, remat=remat)
    loss = transformer.lm_loss(logits, targets, dtype=dtype)
    fluid.optimizer.Adam(learning_rate=3e-4).minimize(loss)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    main = fluid.default_main_program()
    main.random_seed = SEED
    return loss, logits, main, startup


def profiled_flash_counts(exe, main, loss, feed):
    """One step under torch.profiler: the bf16 flash kernels' device
    launches by name (the wrappers' counts are the contract's; this is
    what the device ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not device:
        return {"profiled": "not measured: the profiler saw no device "
                            "event"}
    return {k: sum(body in n for n in device)
            for k, body in FLASH_BF16_BODIES.items()}


def timed_eager(tag, exe, main, loss, feed, n, want):
    """2 warm-up steps, then `n` eager steps, each ending in the loss fetch
    and each launching exactly `want`: losses, step ms, peak memory."""
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    steps = run_steps(exe, main, loss, feed, n)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for _, _, per_step, _ in steps:
        check_launches(tag, per_step, want)
    losses = [r[0] for r in warm + steps]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or "
                             f"did not fall")
    return {"losses": losses, "step_ms": wall / n * 1e3,
            "step_ms_each": [r[3] * 1e3 for r in steps],
            "tok_s": TRAIN_BS * TRAIN_SEQ / (wall / n),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": steps[-1][2]}


def remat_f32_parity():
    """f32 at the parity shape (2 x 256): from one state, two steps with
    and without remat: losses within 1e-5 relative, the step-1 grads of
    the embedding, the first WQ and the head within 1e-4 of their max |g|
    (the same ops; autograd over a segment sums in another order than one
    grad op at a time); K4 16, K5 8, K6 8 a step in both."""
    feed = train_batch(PARITY_BS, PARITY_SEQ)
    runs, state = {}, None
    for remat in (False, True):
        loss, _, main, startup = lm_program(PARITY_SEQ, "float32",
                                            remat=remat)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        if state is None:
            exe.run(startup)
            state = {n: fluid.global_scope().find_np(n)
                     for n in persistables(main)}
        else:
            fluid.load_persistables(main, state)
        params = [p.name for p in main.global_block().all_parameters()]
        grads = [n + "@GRAD" for n in (params[0], params[4], params[-1])]
        runs[remat] = run_steps(exe, main, loss, feed, 2, grads)
        for _, _, launches, _ in runs[remat]:
            check_launches(f"remat_f32_parity remat={remat}", launches,
                           per_step_want())
    loss_rel = [abs(a[0] - b[0]) / abs(b[0])
                for a, b in zip(runs[True], runs[False])]
    grad_rel = {n: float(np.abs(runs[True][0][1][n] - g).max()
                         / np.abs(g).max())
                for n, g in runs[False][0][1].items()}
    res = {"bs": PARITY_BS, "seq": PARITY_SEQ,
           "losses_remat": [r[0] for r in runs[True]],
           "losses_plain": [r[0] for r in runs[False]],
           "loss_rel": loss_rel, "grad_rel_step1": grad_rel,
           "tol": {"loss": 1e-5, "grad": 1e-4}}
    if max(loss_rel) > 1e-5 or max(grad_rel.values()) > 1e-4:
        raise AssertionError(f"remat_f32_parity: remat and no remat part: "
                             f"{res}")
    return res


def remat_gpt_phase(card_name, smi, plain):
    """27. (a) f32 remat against no remat (``remat_f32_parity``); (b) bf16
    at the bench shape (8 x 1024): remat alone, then remat with dropout
    0.1, each 2 + GPT_REMAT_STEPS eager steps (K4 16, K5 8, K6 8 a step
    by the wrappers' counts, and once by the profiler's), the loss
    falling; from one state the step-1 loss with and without remat equal
    to the bit (the same forward); with dropout the same step from the
    same state twice equal to the bit (loss and every persistable) and the
    next step's mask another; K = 4 on the dropout program warns naming
    dropout and runs eagerly; K = 4 on the remat program without dropout
    captured as phase 21 (held to the spread of eager runs, launches at
    capture 4 x a step's, none at a replay), 12 eager against 12 replayed
    steps; `plain` is phase 12's row (no remat, no dropout) beside it.
    Returns the row and the dropout program's state for phase 28."""
    f32 = remat_f32_parity()
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    want = per_step_want()
    k = STEP_LOOP_K["gpt"]

    loss, _, main, startup = lm_program(TRAIN_SEQ, "bfloat16", remat=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    s0 = snap(persistables(main))
    first_remat = run_steps(exe, main, loss, feed, 1)[0][0]
    remat = timed_eager("gpt_remat_bf16", exe, main, loss, feed,
                        GPT_REMAT_STEPS, want)
    restore(s0)
    safety = step_loop.safety_report(main)
    if not safety["safe"]:
        raise AssertionError(f"remat GPT: loop-unsafe {safety}")
    stacked = gpt_stacked(TRAIN_BS, TRAIN_SEQ, k)
    captured = loop_parity("gpt_remat_capture", exe, main, loss, stacked,
                           k, want)
    captured.update(loop_timing(exe, main, loss, stacked, k,
                                TRAIN_BS * TRAIN_SEQ))
    exe.close()
    del exe
    s0_np = {n: t.float().cpu().numpy() for n, t in s0.items()}

    loss, _, main, _ = lm_program(TRAIN_SEQ, "bfloat16")
    fluid.load_persistables(main, s0_np)
    first_plain = run_steps(fluid.Executor(fluid.CUDAPlace(0)), main, loss,
                            feed, 1)[0][0]
    if first_plain != first_remat:
        raise AssertionError(f"gpt remat: the step-1 loss {first_remat} "
                             f"!= no remat's {first_plain} (one forward)")

    loss, logits, main, _ = lm_program(TRAIN_SEQ, "bfloat16", remat=True,
                                       dropout_prob=GPT_DROPOUT)
    fluid.load_persistables(main, s0_np)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    drop = timed_eager("gpt_remat_dropout_bf16", exe, main, loss, feed,
                       GPT_REMAT_STEPS, want)
    names = persistables(main)
    s1 = snap(names)
    replays = []
    for step in (100, 100, 101):
        restore(s1)
        lv = float(exe.run(main, feed=feed, fetch_list=[loss],
                           rng_step=step)[0][0])
        replays.append((lv, snap(names)))
    same = distance([replays[0][0]], replays[0][1], [replays[1][0]],
                    replays[1][1])
    other = distance([replays[2][0]], replays[2][1], [replays[0][0]],
                     replays[0][1])
    if not same["bitwise"] or other["bitwise"]:
        raise AssertionError(f"gpt dropout: the same (seed, step) "
                             f"{brief(same)} or the next step "
                             f"{brief(other)}")
    restore(s1)
    profiled = profiled_flash_counts(exe, main, loss, feed)
    if "profiled" not in profiled and profiled != want:
        raise AssertionError(f"gpt dropout: the profiler counted "
                             f"{profiled} flash launches, want {want}")
    restore(s1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        k_losses = dispatch(exe, main, loss, stacked, k)
        torch.cuda.synchronize()
        k_ms = (time.monotonic() - t0) / k * 1e3
    said = [str(w.message) for w in caught if "loop-unsafe" in
            str(w.message)]
    if not said or "'dropout'" not in said[0] or not np.all(
            np.isfinite(k_losses)) or exe._loops and any(
            e.loop is not None for e in exe._loops.values()):
        raise AssertionError(f"gpt dropout K={k}: no loud eager route "
                             f"naming dropout: {said}")
    restore(s1)
    state = {n: t.detach().clone() for n, t in s1.items()}
    res = {"card": card_name, "nvidia_smi": smi, "bs": TRAIN_BS,
           "seq": TRAIN_SEQ, "dtype": "bfloat16",
           "dropout_prob": GPT_DROPOUT, "f32_parity": f32,
           "step1_loss_remat_equals_plain": True,
           "step1_loss": first_remat,
           "plain_eager_step_ms": plain["step_ms"],
           "plain_peak_mem_gb": plain["peak_mem_gb"],
           "remat": remat, "remat_dropout": drop,
           "dropout_replay_same_step_bitwise": True,
           "dropout_next_step_differs": brief(other),
           "profiled_flash_launches_per_step": profiled,
           "dropout_k_dispatch": {"k": k, "warning": said[0],
                                  "ms_a_step": k_ms, "losses": k_losses},
           "remat_captured": {kk: captured[kk] for kk in (
               "k", "replay_vs_eager", "eager_spread", "launches_at_capture",
               "eager_step_ms", "replay_step_ms", "replay_speedup",
               "peak_mem_gb_eager", "pool_gb")}}
    log("gpt_remat_dropout", res)
    return res, (exe, main, loss, logits, feed, state)


# -- 28. save, load and serve what was trained --------------------------------

def save_load_phase(ctx, tmp):
    """28. On phase 27's dropout GPT (bf16, 8 x 1024) and its state:
    ``save_persistables``, then ``load_persistables`` into a fresh scope
    on the card: the next step (pinned rng step) equals the uninterrupted
    one to the bit, loss and every persistable, each loaded value a card
    tensor of its saved dtype equal to the bit to what was saved.  Then
    ``save_inference_model`` of the logits and ``load_inference_model``:
    ``__model__`` parses to the ``program.json`` it was saved beside (equal
    JSON documents), the global block's dropout op is in test mode (those
    inside the recompute segments run in test mode as the program has no
    grad op, as in the JAX package), and the loaded forward
    on the card (K1 8 launches, no other kernel) equals the live program's
    test-mode forward (``io.get_inference_program`` on the live scope, K1
    8 launches) to the bit."""
    from paddle_tpu_torch import io

    exe, main, loss, logits, feed, state = ctx
    names = persistables(main)
    restore(state)
    d = os.path.join(tmp, "persist")
    io.save_persistables(exe, d, main)
    want = float(exe.run(main, feed=feed, fetch_list=[loss],
                         rng_step=200)[0][0])
    want_state = snap(names)
    fresh = fluid.Scope()
    io.load_persistables(exe, d, main, fresh)
    for n in names:
        t = fresh.find(n)
        if t.device != exe.device or t.dtype != state[n].dtype or \
                not torch.equal(t, state[n]):
            raise AssertionError(f"save_load: {n} loaded as {t.dtype} on "
                                 f"{t.device}, or not the saved bits")
    got = float(exe.run(main, feed=feed, fetch_list=[loss], scope=fresh,
                        rng_step=200)[0][0])
    resumed = distance([got], {n: fresh.find(n) for n in names}, [want],
                       want_state)
    if not resumed["bitwise"]:
        raise AssertionError(f"save_load: the resumed step is not the "
                             f"uninterrupted one: {brief(resumed)}")

    restore(state)
    m = os.path.join(tmp, "model")
    saved = io.save_inference_model(m, ["tokens"], [logits], exe, main)
    parsed, feeds, fetches = io.load_program_desc(m)
    # equal documents: the wire form orders each op's attrs by name
    with open(os.path.join(m, "program.json")) as f:
        if not json.loads(parsed.to_json()) == json.loads(f.read()) == \
                json.loads(saved.to_json()):
            raise AssertionError("save_load: __model__ does not parse to "
                                 "program.json")
    toks = {"tokens": feed["tokens"]}
    live = io.get_inference_program([logits], main)
    for op in live.global_block().ops:
        if op.type == "dropout":
            op.attrs["is_test"] = True
    (want_logits,), live_launches = counted(lambda: exe.run(
        live, feed=toks, fetch_list=[logits], return_numpy=False))
    scope = fluid.Scope()
    prog, feeds, fetches = io.load_inference_model(m, exe, scope)
    if not all(op.attrs.get("is_test") for op in prog.global_block().ops
               if op.type == "dropout"):
        raise AssertionError("save_load: a loaded dropout op trains")
    (got_logits,), launches = counted(lambda: exe.run(
        prog, feed=toks, fetch_list=fetches, scope=scope,
        return_numpy=False))
    for tag, l in (("loaded", launches), ("live", live_launches)):
        check_launches(f"save_load {tag} forward", l,
                       {"flash_attention": LAYERS})
    if not torch.equal(got_logits, want_logits):
        raise AssertionError("save_load: the loaded forward differs from "
                             "the live program's")
    files = sorted(os.listdir(m))
    res = {"persistables": len(names), "resumed_step_bitwise": True,
           "loss_after_resume": got, "inference_ops": len(
               prog.global_block().ops),
           "model_files": len(files),
           "model_bytes": sum(os.path.getsize(os.path.join(m, f))
                              for f in files),
           "loaded_launches": launches,
           "loaded_equals_live_bitwise": True,
           "bf16_npy_files": sum(f.endswith(".npy") for f in files)}
    log("save_load", res)
    exe.close()
    return res


# -- 29. ResNet-50: remat training, then inference with the BN fold -----------

INFER_WARMUP, INFER_REPEATS, INFER_ITERS = 3, 5, 10


def fused_want(block):
    """Launches a fused step implies: each fused op once forward and once
    inside the grad's re-run of its forward (a recompute segment's
    included), its backward once."""
    ops = [op.type for b in block.program.blocks for op in b.ops]
    n1, n3 = ops.count("bn_act_conv1x1"), ops.count("bn_act_conv3x3")
    return {"bn_matmul_fwd": 2 * n1, "bn_matmul_bwd": n1,
            "bn_conv3x3_fwd": 2 * n3, "bn_conv3x3_bwd": n3}


def resnet_remat_parity():
    """f32 ResNet-50 at 128 x 128, batch 4 (phase 19's shape and
    tolerances): one step from one state with and without remat, each
    fused (remat fuses fewer pairs: a chain never crosses a segment's
    edge): the losses within 1e-4 relative, the fc weight's grad within
    1e-3 of its max |g|, the running statistics after the step within
    1e-3 of their max |value|."""
    image, bs = RESNET_PARITY[50]
    feed = resnet_bench.feed(bs, image)
    rows, state = {}, None
    for remat in (False, True):
        fluid.reset()
        loss, _ = resnet_bench.train_program(
            depth=50, image=image, dtype="float32",
            learning_rate=RESNET_PARITY_LR, remat=remat)
        fluid.default_startup_program().random_seed = SEED
        main = fluid.default_main_program()
        block = main.global_block()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        if state is None:
            exe.run(fluid.default_startup_program())
            state = snapshot(block)
        else:
            fluid.load_persistables(main, state)
        fc = next(p.name for p in block.all_parameters()
                  if p.name.startswith("fc") and ".w_" in p.name) + "@GRAD"
        (lv, grads, launches, _), = run_steps(exe, main, loss, feed, 1, [fc])
        check_launches(f"resnet_remat_parity remat={remat}", launches,
                       fused_want(block))
        rows[remat] = (lv, grads[fc], {n: fluid.global_scope().find_np(n)
                                       for n in state if ".global" in n},
                       launches)
    (l1, g1, s1, _), (l0, g0, s0, _) = rows[True], rows[False]
    res = {"image": image, "bs": bs, "loss_remat": l1, "loss_plain": l0,
           "loss_rel": abs(l1 - l0) / abs(l0),
           "fc_grad_rel": float(np.abs(g1 - g0).max() / np.abs(g0).max()),
           "stats_rel": max(float(np.abs(s1[n] - s0[n]).max()
                                  / max(np.abs(s0[n]).max(), 1e-12))
                            for n in s0),
           "launches_remat": rows[True][3], "launches_plain": rows[False][3],
           "tol": {"loss": 1e-4, "fc_grad": 1e-3, "stats": 1e-3}}
    if res["loss_rel"] > 1e-4 or res["fc_grad_rel"] > 1e-3 or \
            res["stats_rel"] > 1e-3:
        raise AssertionError(f"resnet remat parity: {res}")
    return res


def infer_img_s(exe, prog, feed, fetch, bs):
    """INFER_REPEATS rounds of INFER_ITERS runs after INFER_WARMUP, each
    round ending in a synchronize: img/s per round."""
    for _ in range(INFER_WARMUP):
        exe.run(prog, feed=feed, fetch_list=fetch, return_numpy=False)
    rates = []
    for _ in range(INFER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(INFER_ITERS):
            exe.run(prog, feed=feed, fetch_list=fetch, return_numpy=False)
        torch.cuda.synchronize()
        rates.append(bs * INFER_ITERS / (time.monotonic() - t0))
    return {"img_s_median": float(np.median(rates)),
            "img_s_min": min(rates), "img_s_max": max(rates),
            "img_s_each": rates}


def rel_norm(a, b):
    """||a - b|| / ||b||, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def resnet_infer_fold(state, dtype):
    """``bench_resnet_infer``'s program (``resnet_bench.infer_program``:
    batch INFER_BS, 224 x 224 x 3 NHWC, softmax over f32 logits) in
    `dtype` with the trained `state`'s weights and running statistics:
    its logits and probabilities before and after ``fuse_batch_norm``,
    img/s of each, and that no port kernel ran (cuDNN convolutions)."""
    fluid.reset()
    prob = resnet_bench.infer_program(dtype=dtype)
    main = fluid.default_main_program()
    block = main.global_block()
    logits = [op for op in block.ops
              if op.type == "softmax"][-1].inputs["X"][0]
    fluid.load_persistables(main, {n: state[n] for n, v in block.vars.items()
                                   if v.persistable})
    exe = fluid.Executor(fluid.CUDAPlace(0))
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(resnet_bench.INFER_BS, resnet_bench.IMAGE,
                              resnet_bench.IMAGE, 3).astype(np.float32)}
    before, launches = counted(lambda: exe.run(main, feed=feed,
                                               fetch_list=[logits, prob]))
    if any(launches.values()):
        raise AssertionError(f"resnet inference launched {launches}")
    unfolded = infer_img_s(exe, main, feed, [prob], resnet_bench.INFER_BS)
    n_bn = sum(op.type == "batch_norm" for op in block.ops)
    folded_n = fluid.fuse_batch_norm(main, fluid.global_scope(),
                                     fetch_names=[prob.name])
    after = exe.run(main, feed=feed, fetch_list=[logits, prob])
    folded = infer_img_s(exe, main, feed, [prob], resnet_bench.INFER_BS)
    return {"dtype": dtype, "bs": resnet_bench.INFER_BS,
            "batch_norm_ops": n_bn, "folded": folded_n,
            "logits_before": before[0], "logits_after": after[0],
            "logits_rel_max": float(np.abs(after[0] - before[0]).max()
                                    / np.abs(before[0]).max()),
            "logits_max_abs": float(np.abs(before[0]).max()),
            "prob_max_abs_diff": float(np.abs(after[1] - before[1]).max()),
            "prob_max": float(before[1].max()),
            "top1_agree": float(np.mean(after[1].argmax(-1)
                                        == before[1].argmax(-1))),
            "unfolded": unfolded, "folded_rates": folded,
            "fold_speedup": folded["img_s_median"]
            / unfolded["img_s_median"]}


def resnet_remat_phase(card_name, smi, fused_row):
    """29. (a) ``resnet_remat_parity``; (b) fused ResNet-50 with remat at
    the bench shape (bf16, batch 128, 224 x 224): 2 warm-up and 5
    measured steps, the launches its desc implies every step (K11–K15
    inside the recompute segments), the loss finite and falling, step ms
    and peak memory beside phase 20's fused row (no remat); (c) its
    trained state into ``bench_resnet_infer``'s program (batch 16) in f32
    and bf16, every batch_norm folded by ``fuse_batch_norm``: the f32
    logits after the fold within 1e-4 of their max |value| of before it,
    the bf16 folded logits no further from the f32 unfolded ones than
    twice the bf16 unfolded ones are (relative norm; the probabilities'
    largest difference and top-1 agreement logged), img/s folded and
    unfolded (INFER_REPEATS rounds, the spread)."""
    parity = resnet_remat_parity()
    fluid.reset()
    torch.cuda.empty_cache()
    loss, _ = resnet_bench.train_program(remat=True)
    fluid.default_startup_program().random_seed = SEED
    main = fluid.default_main_program()
    block = main.global_block()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    want = fused_want(block)
    feed = resnet_bench.feed()
    warm = run_steps(exe, main, loss, feed, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    steps = run_steps(exe, main, loss, feed, 5)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for _, _, per_step, _ in steps:
        check_launches("resnet50_remat_bf16", per_step, want)
    losses = [r[0] for r in warm + steps]
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        raise AssertionError(f"resnet50 remat: losses {losses}")
    step_ms = wall / len(steps) * 1e3
    train = {"bs": resnet_bench.BS, "image": resnet_bench.IMAGE,
             "losses": losses, "step_ms": step_ms,
             "img_s": resnet_bench.BS / (step_ms / 1e3),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches_per_step": steps[-1][2],
             "segments": sum(op.type == "recompute" for op in block.ops),
             "no_remat_step_ms": fused_row["step_ms"],
             "no_remat_peak_mem_gb": fused_row["peak_mem_gb"],
             "no_remat_launches_per_step": fused_row["launches_per_step"]}
    state = {n: fluid.global_scope().find_np(n) for n in persistables(main)}
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    infer = {dt: resnet_infer_fold(state, dt)
             for dt in ("float32", "bfloat16")}
    ref = infer["float32"]["logits_before"]
    f32, bf16 = infer["float32"], infer["bfloat16"]
    for row in (f32, bf16):
        row["logits_rel_norm_to_f32_unfolded"] = {
            "unfolded": rel_norm(row.pop("logits_before"), ref),
            "folded": rel_norm(row.pop("logits_after"), ref)}
    f32["tol"] = {"logits_rel_max": TOL[torch.float32]}
    bf16["tol"] = {"folded_vs_f32": "2 x the unfolded bf16 logits' "
                                    "distance (relative norm)"}
    d = bf16["logits_rel_norm_to_f32_unfolded"]
    if any(r["folded"] != r["batch_norm_ops"] for r in (f32, bf16)) or \
            f32["logits_rel_max"] > TOL[torch.float32] or \
            d["folded"] > 2 * d["unfolded"]:
        raise AssertionError(f"resnet fold: {infer}")
    res = {"card": card_name, "nvidia_smi": smi, "f32_parity": parity,
           "train_bf16": train, "infer": infer}
    log("resnet50_remat_and_fold", res)
    fluid.reset()
    torch.cuda.empty_cache()
    return res


# -- 30-34. the model zoo -------------------------------------------------------

# the zoo's launches a step by path: the fused ops of fused VGG-19 (K13 and
# K15), none elsewhere (cuDNN and ATen run the zoo's other convolutions)
ZOO_WARMUP, ZOO_TIMED = 2, 5
ZOO_SMALL = {  # phase 34: (image, batch) of the f32 card-against-CPU runs
    "smallnet": (32, 4), "alexnet": (64, 2), "googlenet": (64, 2),
    "vgg_cifar": (32, 4)}
VGG_SMALL = {"image": 32, "bs": 2, "fc_dim": 64}  # phase 31(b)
UNET_K = 4
UNET_SMALL = {"image": 16, "base_ch": 8, "bs": 4}
DDIM_STEPS, DDIM_BS = 10, 4
DEEPFM_STEPS, DEEPFM_FALL = 30, 0.8
DEEPFM_TIMED = 10


def zoo_program(build, seed=SEED):
    """`build()` in fresh default programs and scope, the startup seeded;
    returns (build's result, main, startup)."""
    fluid.reset()
    out = build()
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return out, fluid.default_main_program(), startup


def zoo_train_run(tag, model, card_name, smi, fuse=False, bs=None):
    """``bench_cnn_train``'s program for `model` (bf16, NHWC, 224 x 224,
    class_dim 1000, Momentum(0.01, 0.9); `fuse`: VGG-19 through
    ``fuse_bn_matmul``) at batch `bs`, halved while the card's memory
    refuses it (the cut is named in the row): ZOO_WARMUP steps, then
    ZOO_TIMED measured ones, eager (dropout draws on the host: Queue A 2).
    Held: every loss finite, the lowest measured below the first; fused,
    exactly ``fused_want`` launches every step, else none.  Step ms (mean,
    each), img/s, peak memory."""
    bs = bs or zb.CNN_BS
    cut = None
    while True:
        try:
            return _zoo_train(tag, model, card_name, smi, fuse, bs, cut)
        except torch.cuda.OutOfMemoryError as e:
            if bs == 1:
                raise
            cut = (f"batch {bs} did not fit in the card's memory "
                   f"({str(e).splitlines()[0][:160]}); halved")
        # outside the handler, so that the traceback's frames (and the
        # tensors they hold) are gone before the cache is emptied
        fluid.reset()
        torch.cuda.empty_cache()
        bs //= 2
        log(tag + "_cut", {"cut": cut})


def _zoo_train(tag, model, card_name, smi, fuse, bs, cut):
    t0 = time.monotonic()
    (loss, _), main, startup = zoo_program(
        lambda: zb.cnn_train_program(model, fuse_bn=fuse))
    block = main.global_block()
    want = fused_want(block) if fuse else {}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = zb.cnn_feed(bs)
    warm = run_steps(exe, main, loss, feed, ZOO_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed,
                                                ZOO_TIMED))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for _, _, per_step, _ in warm + steps:
        if fuse:
            check_launches(tag, per_step, want)
        else:
            no_launches(tag, per_step)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    each = [r[3] * 1e3 for r in steps]
    res = {"card": card_name, "nvidia_smi": smi, "model": model,
           "fused": fuse, "bs": bs, "bench_bs": zb.CNN_BS, "batch_cut": cut,
           "image": zb.CNN_IMAGE, "layout": "NHWC", "dtype": zb.CNN_DTYPE,
           "lr": zb.CNN_LR, "ops": len(block.ops),
           "ops_run_per_step": sum(texecutor.live_ops(block, [loss.name])),
           "params": sum(int(np.prod(p.shape))
                         for p in block.all_parameters()),
           "fused_ops": sum(op.type.startswith("bn_act_conv")
                            for op in block.ops),
           "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
           "step_ms_each": each, "step_ms_min": min(each),
           "step_ms_max": max(each), "img_s": bs / (step_ms / 1e3),
           "img_s_min": bs / (max(each) / 1e3),
           "img_s_max": bs / (min(each) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": steps[-1][2],
           "want_per_step": want}
    log(tag, res)
    if not all(np.isfinite(losses)) or not min(losses[ZOO_WARMUP:]) \
            < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite or did "
                             f"not fall")
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


def cnn_zoo_phase(card_name, smi):
    """30. AlexNet, GoogLeNet and VGG-19 at ``bench_cnn_train``'s
    shape."""
    return {m: zoo_train_run(f"zoo_{m}_bench", m, card_name, smi)
            for m in zb.CNN_MODELS}


def vgg19_fused_shapes(bs, image):
    """{(N, H, W, K, O): fused ops} of fused VGG-19's bench program, read
    from its desc: every fused op is a stride-1 3x3 without a residual."""
    fluid.reset()
    zb.cnn_train_program("vgg", image=image, fuse_bn=True)
    block = fluid.default_main_program().global_block()
    out = {}
    for op in block.ops:
        if op.type == "bn_act_conv3x3":
            assert op.attrs["strides"][0] == 1
            assert not op.inputs.get("Residual")
            _, h, w, k = block.var(op.inputs["X"][0]).shape
            key = (bs, h, w, k, block.var(op.inputs["Filter"][0]).shape[0])
            out[key] = out.get(key, 0) + 1
    fluid.reset()
    return out


def vgg19_kernel_rows(dev, bs):
    """K13 and K15 in bf16 at every fused shape of VGG-19's bench program
    (a 3x3 at 224 x 224 with K = O = 64 down to 14 x 14 with K = O = 512):
    each against its plain version (TOL), timed beside it and the bound;
    the float64 distance of kernel and plain logged (``f64_err``).  A
    shape a kernel refuses raises, and the phase with it."""
    rows = []
    for (N, H, W, K, O), n_ops in sorted(vgg19_fused_shapes(
            bs, zb.CNN_IMAGE).items()):
        a = bn_case(dev, torch.bfloat16, "3x3", N, H, W, K, O, 1, False)
        fwd, plain_fwd, bwd, plain_bwd = bn_calls("3x3", a, 1)
        got = {False: [fwd()], True: list(bwd())}
        want = {False: [plain_fwd()], True: list(plain_bwd())}
        torch.cuda.synchronize()
        for back, name in ((False, "bn_conv3x3_fwd"),
                           (True, "bn_conv3x3_bwd")):
            design = DESIGN[torch.bfloat16][name]
            b_ms, b_by = bn_bound("3x3", a, O, back, torch.bfloat16, design)
            row = {"kernel": name, "dtype": "bfloat16", "kind": "3x3",
                   "N": N, "H": H,
                   "W": W, "K": K, "O": O, "stride": 1, "residual": False,
                   "fused_ops": n_ops, "design": design,
                   "max_rel_err": max(rel_err(g, r) for g, r in
                                      zip(got[back], want[back])),
                   "max_abs_err": max(max_err(g, r) for g, r in
                                      zip(got[back], want[back])),
                   "kernel_ms": time_ms(bwd if back else fwd, iters=10),
                   "plain_ms": time_ms(plain_bwd if back else plain_fwd,
                                       iters=5),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
            log("vgg19_" + name, row)
            if row["max_rel_err"] > TOL[torch.bfloat16]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at VGG-19's shape: {row}")
        del a, got, want
        torch.cuda.empty_cache()
    return rows


def vgg19_fused_parity():
    """31(b). f32 VGG-19 at batch 2, 32 x 32, fc_dim 64, dropout 0: one
    fused and one unfused step on the card from one state (phase 19's
    tolerances: loss 1e-4, the class fc's gradient 1e-3 of its max |g|,
    the running statistics after the step 1e-3 of their max |value|);
    the fused step launches K13 and K15 as its desc implies, the unfused
    none."""
    im, bs, fc_dim = (VGG_SMALL[k] for k in ("image", "bs", "fc_dim"))
    feed = zb.cnn_feed(bs, im, zb.CNN_CLASSES)
    rows, state = {}, None
    for fuse in (False, True):
        (loss, _), main, startup = zoo_program(
            lambda: zb.cnn_train_program("vgg", image=im, dtype="float32",
                                         fuse_bn=fuse, dropout_prob=0.0,
                                         fc_dim=fc_dim))
        block = main.global_block()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        if state is None:
            exe.run(startup)
            state = snapshot(block)
        else:
            fluid.load_persistables(main, state)
        fc = max(p.name for p in block.all_parameters()
                 if p.name.startswith("fc") and ".w_" in p.name) + "@GRAD"
        (lv, grads, launches, _), = run_steps(exe, main, loss, feed, 1, [fc])
        if fuse:
            check_launches("vgg19_fused_parity", launches, fused_want(block))
        else:
            no_launches("vgg19_unfused_parity", launches)
        rows[fuse] = (lv, grads[fc], {n: fluid.global_scope().find_np(n)
                                      for n in state if ".global" in n},
                      launches)
    (l1, g1, s1, _), (l0, g0, s0, _) = rows[True], rows[False]
    res = {"image": im, "bs": bs, "fc_dim": fc_dim, "dtype": "float32",
           "loss_fused": l1, "loss_unfused": l0,
           "loss_rel": abs(l1 - l0) / abs(l0),
           "fc_grad_rel": float(np.abs(g1 - g0).max() / np.abs(g0).max()),
           "stats_rel": max(float(np.abs(s1[n] - s0[n]).max()
                                  / max(np.abs(s0[n]).max(), 1e-12))
                            for n in s0),
           "launches_fused": rows[True][3],
           "tol": {"loss": 1e-4, "fc_grad": 1e-3, "stats": 1e-3}}
    log("vgg19_fused_parity", res)
    if res["loss_rel"] > 1e-4 or res["fc_grad_rel"] > 1e-3 or \
            res["stats_rel"] > 1e-3:
        raise AssertionError(f"fused VGG-19 parity: {res}")
    fluid.reset()
    return res


def vgg19_fused_phase(dev, card_name, smi, unfused):
    """31. (a) fused VGG-19 at phase 30's shape beside its unfused row,
    K13 and K15 at VGG-19's shapes; (b) ``vgg19_fused_parity``."""
    fused = zoo_train_run("zoo_vgg19_fused_bench", "vgg", card_name, smi,
                          fuse=True, bs=unfused["bs"])
    fused["vs_unfused"] = {
        "step_ms": [fused["step_ms"], unfused["step_ms"]],
        "img_s": [fused["img_s"], unfused["img_s"]],
        "peak_mem_gb": [fused["peak_mem_gb"], unfused["peak_mem_gb"]]}
    log("zoo_vgg19_fused_vs_unfused", fused["vs_unfused"])
    kernels = vgg19_kernel_rows(dev, unfused["bs"])
    return fused, kernels, vgg19_fused_parity()


def unet_phase(card_name, smi):
    """32. The DDPM U-Net at ``bench_unet_train``'s shape (f32, batch 64,
    64 px, base_ch 64, ch_mults (1, 2, 4), Adam(1e-3)): ZOO_WARMUP +
    ZOO_TIMED eager steps (the lowest measured loss below the first), then,
    on cuDNN's deterministic algorithms, UNET_K steps a dispatch held to
    the bit to eager steps from its state (``loop_parity``; no port kernel
    runs) and timed against them (``loop_timing``, img/s both ways); then
    ``ddim_sample`` for DDIM_STEPS steps at batch DDIM_BS twice from one
    seed: finite, equal to the bit."""
    (loss, eps_hat, infer), main, startup = zoo_program(
        zb.unet_train_program)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    feed = zb.unet_feed()
    warm = run_steps(exe, main, loss, feed, ZOO_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed,
                                                ZOO_TIMED))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    no_launches("unet_eager", launches)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    feeds = [zb.unet_feed(seed=i) for i in range(UNET_K)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    # cuDNN's default convolution backwards sum in varying order, so two
    # eager runs part after one step and a replay is held only to their
    # spread, which a 3-element bias samples too thinly to hold steadily;
    # on cuDNN's deterministic algorithms eager runs agree to the bit and
    # every dispatch is held to the bit.  Eager and replay are timed on
    # the same algorithms, the eager steps above on the default ones.
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loop = {**loop_parity("unet_step_loop", exe, main, loss, stacked,
                              UNET_K, {}),
                **loop_timing(exe, main, loss, stacked, UNET_K, zb.UNET_BS)}
    finally:
        torch.backends.cudnn.deterministic = det
    if not loop["eager_spread"]["bitwise"]:
        raise AssertionError(f"unet_step_loop: eager runs on cuDNN's "
                             f"deterministic algorithms part: "
                             f"{loop['eager_spread']}")
    res = {"card": card_name, "nvidia_smi": smi, "bs": zb.UNET_BS,
           "image": zb.UNET_IMAGE, "base_ch": zb.UNET_CH,
           "ch_mults": list(zb.UNET_MULTS), "dtype": "float32",
           "params": sum(int(np.prod(p.shape))
                         for p in main.global_block().all_parameters()),
           "ops": len(main.global_block().ops), "losses": losses,
           "step_ms": step_ms, "step_ms_each": [r[3] * 1e3 for r in steps],
           "img_s": zb.UNET_BS / (step_ms / 1e3),
           "peak_mem_gb": peak_gb, "step_loop_cudnn_deterministic": True,
           **loop}
    res["img_s_eager"] = res.pop("eager_items_s")
    res["img_s_replay"] = res.pop("replay_items_s")
    if not all(np.isfinite(losses)) or not min(losses[ZOO_WARMUP:]) \
            < losses[0]:
        raise AssertionError(f"unet: losses {losses} are not finite or did "
                             f"not fall")
    from paddle_tpu_torch.models import unet

    sched = unet.ddpm_schedule(T=zb.UNET_T)
    shape = (DDIM_BS, 3, zb.UNET_IMAGE, zb.UNET_IMAGE)
    t0 = time.monotonic()
    samples = [unet.ddim_sample(exe, infer, eps_hat, sched, shape,
                                np.random.RandomState(SEED),
                                steps=DDIM_STEPS) for _ in range(2)]
    res["ddim"] = {"steps": DDIM_STEPS, "bs": DDIM_BS,
                   "wall_s_two_calls": time.monotonic() - t0,
                   "finite": bool(np.isfinite(samples[0]).all()),
                   "equal": bool(np.array_equal(samples[0], samples[1])),
                   "shape": list(samples[0].shape),
                   "abs_max": float(np.abs(samples[0]).max())}
    log("unet_bench", res)
    if not (res["ddim"]["finite"] and res["ddim"]["equal"]):
        raise AssertionError(f"ddim_sample: {res['ddim']}")
    exe.close()
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return res


def as_float64(program):
    """`program` with every float32 variable and ``dtype`` attribute made
    float64 (DeepFM's layers declare float32 outright)."""
    for block in program.blocks:
        for v in block.vars.values():
            if v.dtype == "float32":
                v.dtype = "float64"
        for op in block.ops:
            if op.attrs.get("dtype") == "float32":
                op.attrs["dtype"] = "float64"
    return program


def deepfm_phase(card_name, smi):
    """33. DeepFM: (a) the CTR test's shape (``zb.DEEPFM_CTR``),
    DEEPFM_STEPS steps on the card, as many on an explicit-CPU executor
    and as many in float64 on the CPU, all from the card's startup
    state.  Adam(0.02) drives the loss from ~0.7 to ~1e-5, where its
    gradients are ~0 and Adam's normalized update turns 1e-7 differences
    in them into O(lr) ones in the weights: as the loss nears 0, two
    trajectories that differ only in summation order may part by more
    than 1e-4 relative (each f32 trajectory's relative distance from the
    float64 one is logged, with the first step past 1e-4).  So each card
    step is also taken from the CPU's state before it, as phase 19 takes
    ResNet-50's.  Held: each such step's loss within 1e-4 relative of the
    CPU's, and the step-1 gradients of the first-order weights, the field
    embeddings and the deep tower's last fc within 1e-3 of their max |g|
    (Adam's update and the embeddings' scattered gradient are in the
    later steps' losses); the free-running card losses within 1e-4 of the
    first loss of the CPU's, and both f32 trajectories as near the
    float64 one; the free-running card loss falls below DEEPFM_FALL x its
    first.  (b) the Criteo widths (``zb.DEEPFM_CRITEO``): ZOO_WARMUP +
    DEEPFM_TIMED steps, step ms and rows/s.  No port kernel runs."""
    nf, vocab, emb, hidden, lr, rows = zb.DEEPFM_CTR
    build = lambda: zb.deepfm_train_program(nf, vocab, emb, hidden, lr)
    (loss, _), main, startup = zoo_program(build)
    block = main.global_block()
    params = [p.name for p in block.all_parameters()]
    grads = [n + "@GRAD" for n in ("deepfm.w1", "deepfm.emb", [
        p for p in params if p.startswith("fc") and ".w_" in p][-1])]
    feed = zb.deepfm_feed(rows, nf, vocab)
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    states = [snapshot(block)]
    free, launches = counted(lambda: run_steps(card, main, loss, feed,
                                               DEEPFM_STEPS))
    no_launches("deepfm_ctr", launches)
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = forced_steps(cpu_exe, main, loss, feed, states[:1], grads,
                       cpu_scope)
    for _ in range(DEEPFM_STEPS - 1):
        states.append(snapshot(block, cpu_scope))
        cpu += run_steps(cpu_exe, main, loss, feed, 1, scope=cpu_scope)
    forced, launches = counted(lambda: forced_steps(
        card, main, loss, feed, states, grads))
    no_launches("deepfm_ctr_forced", launches)
    (loss64, _), main64, _ = zoo_program(build)
    as_float64(main64)
    scope64 = fluid.Scope()
    fluid.load_persistables(main64, {
        n: a.astype(np.float64) if a.dtype == np.float32 else a
        for n, a in states[0].items()}, scope64)
    f64 = [r[0] for r in run_steps(
        cpu_exe, main64, loss64, dict(feed, click=feed["click"].astype(
            np.float64)), DEEPFM_STEPS, scope=scope64)]
    g, c, f = ([r[0] for r in rows_] for rows_ in (forced, cpu, free))
    rel = [abs(a - b) / abs(b) for a, b in zip(g, c)]
    grad_rel = {n: float(np.abs(forced[0][1][n] - cpu[0][1][n]).max()
                         / np.abs(cpu[0][1][n]).max()) for n in grads}

    def apart(a, b):  # per step: |a - b| relative, and over b's first
        return ([abs(x - y) / abs(y) for x, y in zip(a, b)],
                max(abs(x - y) for x, y in zip(a, b)) / abs(b[0]))

    free_rel, free_abs = apart(f, c)
    (card64, card64_abs), (cpu64, cpu64_abs) = apart(f, f64), apart(c, f64)
    first_past = lambda errs: next(
        (i + 1 for i, e in enumerate(errs) if e > 1e-4), None)
    ctr = {"fields": nf, "vocab": vocab, "embed": emb, "hidden": hidden,
           "lr": lr, "rows": rows, "steps": DEEPFM_STEPS,
           "forced_losses": g, "cpu_losses": c, "f64_losses": f64,
           "forced_loss_rel_err_max": max(rel),
           "grad_rel_err_step1": grad_rel,
           "free_running_losses": f,
           "free_vs_cpu": {"rel_max": max(free_rel),
                           "first_past_1e-4": first_past(free_rel),
                           "abs_max_over_first": free_abs},
           "vs_f64": {"card_rel_max": max(card64),
                      "card_first_past_1e-4": first_past(card64),
                      "card_abs_max_over_first": card64_abs,
                      "cpu_rel_max": max(cpu64),
                      "cpu_first_past_1e-4": first_past(cpu64),
                      "cpu_abs_max_over_first": cpu64_abs},
           "fall": f[-1] / f[0]}
    log("deepfm_ctr_parity", ctr)
    if (max(rel) > 1e-4 or any(e > 1e-3 for e in grad_rel.values())
            or max(free_abs, card64_abs, cpu64_abs) > 1e-4
            or not f[-1] < DEEPFM_FALL * f[0]):
        raise AssertionError(f"deepfm CTR: card and CPU disagree or the "
                             f"loss did not fall by 20%: {ctr}")
    del card
    nf, vocab, emb, hidden, lr, rows = zb.DEEPFM_CRITEO
    (loss, _), main, startup = zoo_program(
        lambda: zb.deepfm_train_program(nf, vocab, emb, hidden, lr))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    feed = zb.deepfm_feed(rows, nf, vocab)
    warm = run_steps(exe, main, loss, feed, ZOO_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps, launches = counted(lambda: run_steps(exe, main, loss, feed,
                                                DEEPFM_TIMED))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    no_launches("deepfm_criteo", launches)
    losses = [r[0] for r in warm + steps]
    step_ms = wall / len(steps) * 1e3
    crit = {"card": card_name, "nvidia_smi": smi, "fields": nf,
            "vocab": vocab, "embed": emb, "hidden": hidden, "lr": lr,
            "bs": rows, "params": sum(int(np.prod(p.shape)) for p in
                                      main.global_block().all_parameters()),
            "losses": losses, "step_ms": step_ms,
            "step_ms_each": [r[3] * 1e3 for r in steps],
            "rows_s": rows / (step_ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("deepfm_criteo_bench", crit)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"deepfm Criteo widths: losses {losses}")
    del exe
    fluid.reset()
    torch.cuda.empty_cache()
    return {"ctr_parity": ctr, "criteo_bench": crit}


def zoo_watched(main):
    """The first, a middle and the last parameter's gradient names."""
    params = [p.name for p in main.global_block().all_parameters()]
    return [n + "@GRAD" for n in (params[0], params[len(params) // 2],
                                  params[-1])]


def zoo_test_mode(tag, main, test, startup, feed):
    """The test-mode clone (the model's dropout rates: Out = X·(1 − p);
    BatchNorm on the running statistics) on the card and on an
    explicit-CPU executor from the card's startup state: the logits
    within 1e-4 of their max |value|."""
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    state = snapshot(main.global_block())
    logits = [op.inputs["Logits"][0] for op in test.global_block().ops
              if op.type == "softmax_with_cross_entropy"]
    (gpu,) = card.run(test, feed=feed, fetch_list=logits)
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, state, cpu_scope)
    (cpu,) = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, fetch_list=logits, scope=cpu_scope)
    err = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if err > 1e-4:
        raise AssertionError(f"{tag}: the test-mode logits on the card lie "
                             f"{err} of max |value| from the CPU's")
    return err


def vgg_cifar_parity():
    """``vgg_cifar`` (32 x 32, batch 4, f32, dropout 0) held as phase 19
    holds ResNet-50, and for the same reason: its chain of BatchNorms
    makes f32 ill-conditioned (tests/test_torch_zoo.py: either package's
    f32 first-filter gradient lies 1e-4 to 2e-2 from float64).  The CPU
    takes three steps from the card's startup state; the card takes each
    step from the CPU's state before it; the CPU takes one float64 step
    from the start.  Held: each loss within 1e-4 relative, the class fc's
    step-1 gradient within 1e-3 of its max |g|, the running statistics
    after step 1 within 1e-3, all gradients together (in norm) no further
    from the float64 ones than twice the CPU's f32 ones."""
    image, bs = ZOO_SMALL["vgg_cifar"]
    build = (lambda dt: lambda: zb.cnn_train_program(
        "vgg_cifar", image=image, class_dim=10, dtype=dt, layout="NCHW",
        dropout_prob=0.0))
    (loss, test), main, startup = zoo_program(build("float32"))
    block = main.global_block()
    names = sorted(p.name + "@GRAD" for p in block.all_parameters())
    fc = max(n for n in names if n.startswith("fc") and ".w_" in n)
    stats = [op.inputs[s][0] for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    feed = zb.cnn_feed(bs, image, 10, "NCHW")
    test_err = zoo_test_mode("vgg_cifar", main, test, startup, feed)
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    states = [snapshot(block)]
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = forced_steps(cpu_exe, main, loss, feed, states[:1], names,
                       cpu_scope)
    for _ in range(2):
        states.append(snapshot(block, cpu_scope))
        cpu += run_steps(cpu_exe, main, loss, feed, 1, scope=cpu_scope)
    gpu, launches = counted(lambda: forced_steps(card, main, loss, feed,
                                                 states[:1], names))
    gpu_stats = {n: fluid.global_scope().find_np(n) for n in stats}
    gpu += forced_steps(card, main, loss, feed, states[1:], ())
    no_launches("vgg_cifar_parity", launches)
    del card
    (loss64, _), main64, _ = zoo_program(build("float64"))
    block64 = main64.global_block()
    scope64 = fluid.Scope()
    fluid.load_persistables(main64, {
        n: a.astype(block64.vars[n].dtype) for n, a in states[0].items()},
        scope64)
    feed64 = dict(feed, image=feed["image"].astype(np.float64))
    f64 = run_steps(fluid.Executor(fluid.CPUPlace()), main64, loss64,
                    feed64, 1, names, scope=scope64)
    g32, gc, g64 = gpu[0][1], cpu[0][1], f64[0][1]

    def norm_rel(a):
        num = sum(float(((np.asarray(a[n], np.float64) - g64[n]) ** 2).sum())
                  for n in names)
        return (num / sum(float((g64[n] ** 2).sum()) for n in names)) ** 0.5

    res = {"model": "vgg_cifar", "image": image, "bs": bs,
           "dtype": "float32", "steps": "each from the CPU's state",
           "gpu_losses": [r[0] for r in gpu],
           "cpu_losses": [r[0] for r in cpu],
           "loss_rel_err": [abs(a[0] - b[0]) / abs(b[0])
                            for a, b in zip(gpu, cpu)],
           "grad_rel_err_step1": {fc: float(
               np.abs(g32[fc] - gc[fc]).max() / np.abs(gc[fc]).max())},
           "grads_vs_f64_norm": {"card": norm_rel(g32), "cpu": norm_rel(gc)},
           "state_rel_err_max": max(
               float(np.abs(gpu_stats[n] - states[1][n]).max()
                     / max(np.abs(states[1][n]).max(), 1e-12))
               for n in stats),
           "test_mode_logits_rel": test_err,
           "launches_per_step": gpu[-1][2]}
    log("zoo_parity_vgg_cifar", res)
    w = res["grads_vs_f64_norm"]
    if (max(res["loss_rel_err"]) > 1e-4
            or res["grad_rel_err_step1"][fc] > 1e-3
            or res["state_rel_err_max"] > 1e-3 or w["card"] > 2 * w["cpu"]):
        raise AssertionError(f"vgg_cifar: card and CPU training disagree: "
                             f"{res}")
    fluid.reset()
    return res


def zoo_parity_phase():
    """34. The small zoo in f32 (TF32 off, ``card``), card against an
    explicit-CPU executor from the card's startup state, every dropout op
    at probability 0 in the training desc: ``smallnet_mnist_cifar`` at
    32 x 32 (batch 4), AlexNet and GoogLeNet at 64 x 64 (batch 2,
    class_dim 10), the U-Net at 16 px (base_ch 8, batch 4) and the
    ``nets`` program (``zb.nets_train_program``: ``glu``,
    ``dot_product_attention``, ``sequence_conv_pool``, ragged) by
    ``parity_run`` (3 steps, losses 1e-4 relative, the first, a middle and
    the last parameter's step-1 gradient 1e-3 of max |g|, no port
    kernel); the CNNs' test-mode clones (at the models' dropout rates)
    first, ``zoo_test_mode``; ``vgg_cifar`` by ``vgg_cifar_parity``."""
    out = {}
    for model in ("smallnet", "alexnet", "googlenet"):
        image, bs = ZOO_SMALL[model]
        layout = "NCHW" if model == "smallnet" else "NHWC"
        (loss, test), main, startup = zoo_program(
            lambda: zb.cnn_train_program(model, image=image, class_dim=10,
                                         dtype="float32", layout=layout,
                                         dropout_prob=0.0))
        feed = zb.cnn_feed(bs, image, 10, layout)
        err = zoo_test_mode(model, main, test, startup, feed)
        out[model] = parity_run(f"zoo_parity_{model}", main, startup, loss,
                                feed, zoo_watched(main), {},
                                {"bs": bs, "image": image})
        out[model]["test_mode_logits_rel"] = err
    out["vgg_cifar"] = vgg_cifar_parity()
    u = UNET_SMALL
    (loss, _, _), main, startup = zoo_program(
        lambda: zb.unet_train_program(image=u["image"], base_ch=u["base_ch"],
                                      ch_mults=(1, 2)))
    out["unet"] = parity_run("zoo_parity_unet", main, startup, loss,
                             zb.unet_feed(u["bs"], u["image"]),
                             zoo_watched(main), {},
                             {"bs": u["bs"], "image": u["image"]})
    loss, main, startup = zoo_program(zb.nets_train_program)
    out["nets"] = parity_run(
        "zoo_parity_nets", main, startup, loss, zb.nets_feed(),
        [n + "@GRAD" for n in ("embedding_0.w_0", "sequence_conv_0.w_0",
                               "fc_0.w_0", "fc_3.w_0")], {}, {"bs": 4})
    fluid.reset()
    return out


# -- 35. sequence labelling: the book's label_semantic_roles ------------------

SRL_SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
             "target")
# the book's widths (PaddlePaddle v0.11 fluid/tests/book/
# test_label_semantic_roles.py): 44068 words, 59 labels, 3162 predicates,
# mark dict 2, word_dim 32, mark_dim 5, hidden_dim 512 (H 128), depth 8
SRL_BOOK = {"word_dict_len": conll05.WORD_DICT_LEN,
            "label_dict_len": conll05.LABEL_DICT_LEN,
            "pred_len": conll05.PRED_DICT_LEN, "hidden_dim": 512, "depth": 8}
SRL_SMALL = {"word_dict_len": 200, "label_dict_len": conll05.LABEL_DICT_LEN,
             "pred_len": conll05.PRED_DICT_LEN, "hidden_dim": 32, "depth": 2}
# the kernels' activations; the book's (relu candidate, sigmoid cell) run
# the plain loop and reach no kernel
SRL_KERNEL_ACTS = {"candidate_activation": "tanh",
                   "gate_activation": "sigmoid", "cell_activation": "tanh"}
SRL_BOOK_ACTS = {"candidate_activation": "relu",
                 "gate_activation": "sigmoid", "cell_activation": "sigmoid"}
SRL_BS = (10, 128)  # the book's BATCH_SIZE, and a batch that fills the card
SRL_WARM, SRL_TIMED, SRL_PROFILED = 2, 10, 3
SRL_INFER_RUNS = 5
SRL_PARITY_BS, SRL_PARITY_STEPS, SRL_TOL = 8, 3, 1e-5
SRL_BOOK_GRU = {"vocab": 64, "ntag": 5, "hidden": 32}


def srl_net(word_dict_len, label_dict_len, pred_len, hidden_dim, depth,
            acts, word_dim=32, mark_dim=5):
    """The book's db_lstm + linear-chain CRF + Viterbi + chunk_eval through
    the port's layers: six word lookups share the frozen ``emb`` table,
    predicate and mark embeddings, `depth` LSTMs (size hidden_dim, so H =
    hidden_dim / 4) of alternating direction over mixed fc sums, the
    feature of two fc sums, ``crfw`` at learning rate × 1e-3, a
    ChunkEvaluator (IOB, 29 chunk types), and SGD on
    exponential_decay(1e-4, 100000, 0.5, staircase).  The test-mode clone
    (loss, path, chunk counts) is taken before minimize.  Returns (dict of
    variables, main, startup)."""
    fluid.reset()
    L = fluid.layers
    data = {n: L.sequence_data(name=n, shape=[1], dtype="int64")
            for n in SRL_SLOTS}
    embs = [L.sequence_embedding(
        data[n], size=[word_dict_len, word_dim],
        param_attr=fluid.ParamAttr(name="emb", trainable=False))
        for n in SRL_SLOTS[:6]]
    embs.append(L.sequence_embedding(
        data["verb_data"], size=[pred_len, word_dim],
        param_attr=fluid.ParamAttr(name="vemb")))
    embs.append(L.sequence_embedding(data["mark_data"], size=[2, mark_dim]))

    def mix(inputs, size):
        fcs = [L.sequence_fc(x, size) for x in inputs]
        return L.propagate_length(fcs[0], L.sums(fcs))

    hidden_0 = mix(embs, hidden_dim)
    lstm_0, _ = L.dynamic_lstm(hidden_0, size=hidden_dim, **acts)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = mix(input_tmp, hidden_dim)
        lstm, _ = L.dynamic_lstm(mix_hidden, size=hidden_dim,
                                 is_reverse=(i % 2) == 1, **acts)
        input_tmp = [mix_hidden, lstm]
    feature_out = mix(input_tmp, label_dict_len)
    crf_cost = L.linear_chain_crf(
        feature_out, data["target"],
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=1e-3))
    avg_cost = L.mean(crf_cost)
    decode = L.crf_decoding(feature_out, crf_cost._crf_transition)
    chunk = L.chunk_eval(decode, data["target"], chunk_scheme="IOB",
                         num_chunk_types=-(-(label_dict_len - 1) // 2))
    evaluator = fluid.evaluator.ChunkEvaluator(*chunk[3:])
    test = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.SGD(learning_rate=fluid.learning_rate_decay
                        .exponential_decay(learning_rate=1e-4,
                                           decay_steps=100000,
                                           decay_rate=0.5,
                                           staircase=True)).minimize(
        avg_cost)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    net = {"cost": avg_cost, "decode": decode, "chunk": chunk,
           "evaluator": evaluator, "test": test}
    return net, fluid.default_main_program(), startup


def srl_batches(bs, n, word_dict_len, pred_len, seed=0):
    """`n` batches of `bs` samples from the synthetic conll05 reader
    (``conll05.train`` for seed 0, ``test`` for 1), word and predicate ids
    folded into the dicts, one LoDTensor a slot (labels [len, 1], as the
    book feeds them); and each batch's valid tokens."""
    reader = conll05.train if seed == 0 else conll05.test
    samples = list(reader(n=bs * n)())
    mods = [word_dict_len] * 6 + [pred_len, 2, conll05.LABEL_DICT_LEN]
    out = []
    for b in range(n):
        rows = samples[b * bs:(b + 1) * bs]
        out.append(({name: LoDTensor.from_sequences(
            [(r[k] % m).reshape(-1, 1) for r in rows])
            for k, (name, m) in enumerate(zip(SRL_SLOTS, mods))},
            int(sum(len(r[0]) for r in rows))))
    return out


def srl_fetch(net, grads=()):
    return [net["cost"], *grads, net["decode"], *net["chunk"][3:]]


def srl_steps(exe, main, fetch, feed, n, scope=None):
    """`n` steps fetching `fetch`; per step (fetched arrays, the kernels'
    launches in it, host seconds to the fetch)."""
    out = []
    for _ in range(n):
        before = {k: f.launches for k, f in KERNELS.items()}
        t0 = time.monotonic()
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        secs = time.monotonic() - t0
        out.append((vals, {k: f.launches - before[k]
                           for k, f in KERNELS.items()}, secs))
    return out


def srl_card_vs_cpu(tag, main, startup, fetch, n_grads, feed, bs, want,
                    init=None):
    """`SRL_PARITY_STEPS` steps on an explicit-CPU executor from the
    card's startup state, and on the card each step from the CPU's state
    before it (f32, TF32 off): each loss within SRL_TOL relative, the
    step-1 gradients within SRL_TOL of their max |g|, the fetched paths and
    chunk counts equal, and the launches `want` in every card step (none
    where `want` is empty)."""
    card = fluid.Executor(fluid.CUDAPlace(0))
    card.run(startup)
    if init is not None:
        init(fluid.global_scope())
    block = main.global_block()
    states = [snapshot(block)]
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, states[0], cpu_scope)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = []
    for k in range(SRL_PARITY_STEPS):
        if k:
            states.append(snapshot(block, cpu_scope))
        cpu += srl_steps(cpu_exe, main, fetch, feed, 1, cpu_scope)
    gpu = []
    for state in states:
        fluid.load_persistables(main, state)
        gpu += srl_steps(card, main, fetch, feed, 1)
    loss_rel = [abs(float(g[0][0][0]) - float(c[0][0][0]))
                / abs(float(c[0][0][0])) for g, c in zip(gpu, cpu)]
    grad_rel = [float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
                for g, c in zip(gpu[0][0][1:1 + n_grads],
                                cpu[0][0][1:1 + n_grads])]
    exact = all(np.array_equal(g, c) for gr, cr in zip(gpu, cpu)
                for g, c in zip(gr[0][1 + n_grads:], cr[0][1 + n_grads:]))
    counts = [[int(v[0]) for v in r[0][2 + n_grads:]] for r in gpu]
    res = {"tag": tag, "bs": bs, "dtype": "float32",
           "steps": "each from the CPU's state",
           "gpu_losses": [float(r[0][0][0]) for r in gpu],
           "cpu_losses": [float(r[0][0][0]) for r in cpu],
           "loss_rel_err": loss_rel, "grads": n_grads,
           "grad_rel_err_step1_max": max(grad_rel, default=0.0),
           "paths_and_counts_equal": exact,
           "chunk_counts_infer_label_correct": counts,
           "launches_per_step": gpu[-1][1]}
    log(f"srl_parity_{tag}", res)
    for _, launches, _ in gpu:
        if want:
            check_launches(f"srl_parity_{tag}", launches, want)
        else:
            no_launches(f"srl_parity_{tag}", launches)
    if (max(loss_rel) > SRL_TOL or res["grad_rel_err_step1_max"] > SRL_TOL
            or not exact):
        raise AssertionError(f"srl_parity_{tag}: card and CPU disagree: "
                             f"{res}")
    return res


def srl_emb_init(n):
    def init(scope):
        scope.set("emb", conll05.get_embedding()[:n])
    return init


def srl_trainable_grads(main):
    return sorted(p.name + "@GRAD" for p in
                  main.global_block().all_parameters() if p.trainable)


def srl_parity_phase():
    """35(a) the small SRL (hidden_dim 32, depth 2, a 200-word dict) in
    both activation sets and the JAX book test's GRU + CRF, card against
    an explicit CPU; returns the rows and the GRU + CRF feed's
    lengths."""
    out = {}
    feed = srl_batches(SRL_PARITY_BS, 1, SRL_SMALL["word_dict_len"],
                       SRL_SMALL["pred_len"])[0][0]
    for name, acts, want in (
            ("small_kernel_acts", SRL_KERNEL_ACTS,
             {"lstm_forward": 2 * SRL_SMALL["depth"],
              "lstm_backward": SRL_SMALL["depth"]}),
            ("small_book_acts", SRL_BOOK_ACTS, {})):
        net, main, startup = srl_net(acts=acts, **SRL_SMALL)
        grads = srl_trainable_grads(main)
        out[name] = srl_card_vs_cpu(
            name, main, startup, srl_fetch(net, grads), len(grads), feed,
            SRL_PARITY_BS, want, srl_emb_init(SRL_SMALL["word_dict_len"]))
    g = SRL_BOOK_GRU
    fluid.reset()
    L = fluid.layers
    words = L.sequence_data(name="words", shape=[1], dtype="int64")
    tags = L.sequence_data(name="tags", shape=[1], dtype="int64")
    emb = L.sequence_embedding(words, size=[g["vocab"], 16])
    gru = L.dynamic_gru(L.sequence_fc(emb, size=3 * g["hidden"]),
                        size=g["hidden"])
    emission = L.sequence_fc(gru, size=g["ntag"])
    nll = L.linear_chain_crf(emission, tags)
    cost = L.mean(nll)
    decoded = L.crf_decoding(emission, nll._crf_transition)
    fluid.optimizer.Adam(learning_rate=0.02).minimize(cost)
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    startup.random_seed = SEED
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, g["vocab"], rng.randint(1, 9))
            for _ in range(16)]
    book_feed = {
        "words": LoDTensor.from_sequences(
            [t.reshape(-1, 1) for t in toks]),
        "tags": LoDTensor.from_sequences(
            [(t % g["ntag"]).reshape(-1, 1) for t in toks])}
    grads = srl_trainable_grads(main)
    out["book_gru_crf"] = srl_card_vs_cpu(
        "book_gru_crf", main, startup, [cost, *grads, decoded], len(grads),
        book_feed, len(toks), {"gru_forward": 2, "gru_backward": 1})
    fluid.reset()
    return out, [len(t) for t in toks]


def srl_kernel_phase(dev, shapes):
    """35(a) the recurrent kernels at the shapes of this phase's paths:
    K7 and K8 at the full-width SRL's (B, the padded T, H 128, the
    reader's ragged lengths), K9 and K10 at the GRU + CRF's, `shapes`
    holding (kind, B, T, H, lengths); each against its plain version,
    timed beside it and the bound, with the route and device launches the
    library counted.  Then the ``lstm`` op in both directions on the card
    (the kernels through ``reverse_within_length``) against the plain
    loop ``_lstm_scan`` run on the card, from a non-zero initial state, a
    row of length 1 and one of length T among the reader's lengths.
    States 1e-4 absolute, gradients 1e-4 of their max |g| (phase 13's
    tolerance)."""
    from paddle_tpu_torch.ops.sequence_ops import _lstm_scan

    rows = {f"{k}_{d}": [] for k in ("lstm", "gru")
            for d in ("forward", "backward")}
    dirs = []
    for kind, B, T, H, lengths in shapes:
        mod = lstm_k if kind == "lstm" else gru_k
        gates = 4 if kind == "lstm" else 3
        fwd, bwd = (getattr(mod, f"{kind}_{d}") for d in ("forward",
                                                          "backward"))
        fwd_ref, bwd_ref = (getattr(mod, f"{kind}_{d}_ref")
                            for d in ("forward", "backward"))
        a = rnn_case(dev, torch.float32, gates, B, T, H, lengths)
        if kind == "lstm":
            ins = (a["x"], a["h0"], a["c0"], a["w"], a["lengths"])
            cts = (a["dhs"], a["dcs"])
        else:
            ins = (a["x"], a["h0"], a["w"], a["lengths"])
            cts = (a["dhs"],)
        got, k_f = kernels_launched(mod, dev, lambda: fwd(*ins))
        ref = fwd_ref(*ins)
        saved = ref[:len(cts)]
        grads, k_b = kernels_launched(
            mod, dev, lambda: bwd(*ins, *saved, *cts))
        ref_g = bwd_ref(*ins, *saved, *cts)
        shape = {"dtype": "float32", "B": B, "T": T, "H": H,
                 "valid_steps": a["steps"], "lengths": "the path's"}
        f_row = {**shape, "max_abs_err": max(max_err(x, y)
                                             for x, y in zip(got, ref))}
        b_row = {**shape, "max_rel_err": max(rel_err(x, y)
                                             for x, y in zip(grads, ref_g))}
        for row, back, counts, call, plain in (
                (f_row, False, k_f, lambda: fwd(*ins),
                 lambda: fwd_ref(*ins)),
                (b_row, True, k_b, lambda: bwd(*ins, *saved, *cts),
                 lambda: bwd_ref(*ins, *saved, *cts))):
            body, n = rnn_body(kind, counts, back)
            want = mod.route(a["x"], backward=back)
            if (body, n) != (want, rnn_launches(kind, want, T)[back]):
                raise AssertionError(f"srl {kind} at {shape}: ran {body} "
                                     f"in {n} launches, {kind}.route chose "
                                     f"{want}")
            row.update({"route": body, "device_launches": n})
            row["bound_ms"], row["bound_by"] = rnn_bound(
                gates, a, B, T, H, back, torch.float32)
            row["kernel_ms"] = time_ms(call, iters=max(2, 400 // n))
            row["plain_ms"] = time_ms(plain, iters=3, ahead=False)
            row["plain_ms_includes"] = "the host's launch rate"
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["bound_ignores"] = "the dependence between the T steps"
            row["library_ms"] = None
        rows[f"{kind}_forward"].append(f_row)
        rows[f"{kind}_backward"].append(b_row)
        log(f"srl_{kind}_forward", f_row)
        log(f"srl_{kind}_backward", b_row)
        if (f_row["max_abs_err"] > TOL[torch.float32]
                or b_row["max_rel_err"] > TOL[torch.float32]):
            raise AssertionError(f"srl: the {kind} kernels disagree with "
                                 f"their plain versions at {shape}: "
                                 f"{f_row}, {b_row}")
        if kind == "lstm":
            lens = a["lengths"].clone()
            lens[0], lens[-1] = 1, T
            for rev in (False, True):
                dirs.append(srl_direction_row(dev, a, lens, rev, _lstm_scan))
    return rows, dirs


def srl_direction_row(dev, a, lengths, rev, lstm_scan):
    """The ``lstm`` op (training mode: LSTMTrain, K7 and K8) against
    ``_lstm_scan`` on the same card tensors, forward states and the
    gradients of sum(hs·dhs + cs·dcs) in Input, Weight, H0 and C0."""
    B, T = a["x"].shape[:2]
    info = get_op_info("lstm")
    ctx = EmitContext(dev, is_test=False)

    def run(kernel):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (a["x"], a["w"], a["h0"], a["c0"])]
        x, w, h0, c0 = leaves
        if kernel:
            out = info.emit(ctx, {"Input": [x], "Weight": [w], "H0": [h0],
                                  "C0": [c0], "Length": [lengths]},
                            {"is_reverse": rev})
            hs, cs = out["Hidden"][0], out["Cell"][0]
        else:
            hs, cs, _, _ = lstm_scan(x, h0, c0, w, lengths, torch.sigmoid,
                                     torch.tanh, torch.tanh, reverse=rev)
        loss = (hs * a["dhs"]).sum() + (cs * a["dcs"]).sum()
        return (hs, cs), torch.autograd.grad(loss, leaves)

    (got, g_got), counts = kernels_launched(lstm_k, dev, lambda: run(True))
    want, g_want = run(False)
    row = {"B": B, "T": T, "is_reverse": rev,
           "lengths_min_max": [int(lengths.min()), int(lengths.max())],
           "max_abs_err": max(max_err(x, y) for x, y in zip(got, want)),
           "max_rel_err": max(rel_err(x, y) for x, y in zip(g_got, g_want)),
           "kernels": counts}
    log("srl_lstm_direction", row)
    if not any("lstm_fwd" in k for k in counts) or not any(
            "lstm_bwd" in k for k in counts):
        raise AssertionError(f"srl direction check ran no K7 or K8: {row}")
    if row["max_abs_err"] > TOL[torch.float32] or \
            row["max_rel_err"] > TOL[torch.float32]:
        raise AssertionError(f"srl: the lstm op (is_reverse={rev}) and "
                             f"the plain loop disagree: {row}")
    return row


SRL_K7_NAMES = ("lstm_fwd",)
SRL_K8_NAMES = ("lstm_bwd", "lstm_dw", "rnn_dw")


def srl_profile(exe, main, fetch, batches,
                kernels=(("k7", SRL_K7_NAMES), ("k8", SRL_K8_NAMES))):
    """A few steps under torch.profiler: the device busy share of their
    wall (kernel intervals merged), device kernels a step, and the device
    ms a step of each of `kernels` (label, the bodies' names; K7's and
    K8's by default)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for feed, _ in batches:
            exe.run(main, feed=feed, fetch_list=fetch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans, us = [], {label: 0.0 for label, _ in kernels}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for label, names in kernels:
            if any(k in e.name for k in names):
                us[label] += e.time_range.elapsed_us()
                break
    if not spans:
        return {"profiled": "not measured: the profiler saw no device "
                            "event"}
    busy = merged_us(spans)
    n = len(batches)
    return {"profiled_steps": n, "wall_ms_profiled_per_step":
            wall_us / 1e3 / n, "device_busy_share": busy / wall_us,
            "device_busy_ms_per_step": busy / 1e3 / n,
            "device_kernels_per_step": len(spans) / n,
            **{f"{label}_device_ms_per_step": v / 1e3 / n
               for label, v in us.items()}}


def srl_bench_run(bs, card_name, smi):
    """35(b) the full-width SRL with the kernels' activations at batch
    `bs`: SRL_WARM + SRL_TIMED training steps, each on the next batch of
    the synthetic conll05 reader and each launching K7 2 x depth and K8
    depth times; step ms (median, min, max), sentences and tokens a
    second, peak memory, the profiled steps, the ChunkEvaluator's P/R/F1
    after them (not gated), then the test-mode program (loss, Viterbi,
    chunk_eval; K7 depth times) in sentences a second."""
    depth = SRL_BOOK["depth"]
    want = {"lstm_forward": 2 * depth, "lstm_backward": depth}
    t0 = time.monotonic()
    net, main, startup = srl_net(acts=SRL_KERNEL_ACTS, **SRL_BOOK)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    fluid.global_scope().set("emb", conll05.get_embedding())
    batches = srl_batches(bs, SRL_WARM + SRL_TIMED + SRL_PROFILED,
                          SRL_BOOK["word_dict_len"], SRL_BOOK["pred_len"])
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    fetch = srl_fetch(net)
    rows = []
    for feed, _ in batches[:SRL_WARM]:
        rows += srl_steps(exe, main, fetch, feed, 1)
    net["evaluator"].reset(exe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[SRL_WARM:SRL_WARM + SRL_TIMED]
    for feed, _ in timed:
        rows += srl_steps(exe, main, fetch, feed, 1)
    for _, launches, _ in rows:
        check_launches(f"srl_bench_{bs}", launches, want)
    step_ms = [r[2] * 1e3 for r in rows[SRL_WARM:]]
    med = float(np.median(step_ms))
    tokens = [t for _, t in timed]
    precision, recall, f1 = net["evaluator"].eval()
    res = {"card": card_name, "nvidia_smi": smi, "bs": bs,
           "dtype": "float32", **{k: SRL_BOOK[k] for k in SRL_BOOK},
           "H": SRL_BOOK["hidden_dim"] // 4, "setup_s": setup_s,
           "T_padded": sorted({bucket_len(int(
               f["word_data"].sequence_lengths().max())) for f, _ in timed}),
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "ops": len(main.global_block().ops),
           "losses": [float(r[0][0][0]) for r in rows],
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "step_ms_each": step_ms,
           "sent_s": bs / (med / 1e3),
           "tok_s": float(np.mean(tokens)) / (med / 1e3),
           "tokens_per_step_mean": float(np.mean(tokens)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": rows[-1][1],
           "chunk_eval_after_timed_steps": {
               "precision": precision, "recall": recall, "f1": f1}}
    res.update(srl_profile(exe, main, fetch,
                           batches[SRL_WARM + SRL_TIMED:]))
    if not all(np.isfinite(res["losses"])):
        raise AssertionError(f"srl_bench_{bs}: losses {res['losses']}")
    # the test-mode program on the trained state: K7 only
    feed, tok = timed[0]
    (val, *_), launches = counted(lambda: exe.run(
        net["test"], feed=feed, fetch_list=srl_fetch(net)))
    check_launches(f"srl_infer_{bs}", launches, {"lstm_forward": depth})
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(SRL_INFER_RUNS):
        exe.run(net["test"], feed=feed, fetch_list=srl_fetch(net))
    torch.cuda.synchronize()
    infer_ms = (time.monotonic() - t0) / SRL_INFER_RUNS * 1e3
    res["infer"] = {"bs": bs, "ms": infer_ms, "sent_s": bs / (infer_ms / 1e3),
                    "tok_s": tok / (infer_ms / 1e3), "loss": float(val[0]),
                    "launches": launches}
    log(f"srl_bench_{bs}", res)
    if not np.isfinite(res["infer"]["loss"]):
        raise AssertionError(f"srl_infer_{bs}: loss {res['infer']['loss']}")
    return res


def srl_phase(dev, card_name, smi):
    """35. Sequence labelling: (a) card against CPU and K7/K8 at the SRL
    shapes, (b) the full-width SRL at batch 10 and 128."""
    parity, gru_lengths = srl_parity_phase()
    H = SRL_BOOK["hidden_dim"] // 4
    shapes = [("gru", len(gru_lengths), bucket_len(max(gru_lengths)),
               SRL_BOOK_GRU["hidden"], gru_lengths)]
    for bs in SRL_BS:
        feed, _ = srl_batches(bs, 1, SRL_BOOK["word_dict_len"],
                              SRL_BOOK["pred_len"])[0]
        lengths = feed["word_data"].sequence_lengths()
        shapes.append(("lstm", bs, bucket_len(int(lengths.max())), H,
                       [int(n) for n in lengths]))
    kernel_rows, directions = srl_kernel_phase(dev, shapes)
    bench = {}
    for bs in SRL_BS:
        fluid.reset()
        torch.cuda.empty_cache()
        bench[bs] = srl_bench_run(bs, card_name, smi)
    fluid.reset()
    # each kernel row's launches a step on the path it has the shape of
    for kname, krows in kernel_rows.items():
        for r in krows:
            path = bench[r["B"]] if kname.startswith("lstm") \
                else parity["book_gru_crf"]
            r["launches_per_step"] = path["launches_per_step"][kname]
    return {"parity": parity, "kernel_rows": kernel_rows,
            "directions": directions, "bench": bench}


# -- 36. the legacy config path: the reference's RNN benchmark as a v1 config

# bench.py's copy of the reference RNN baseline (bench.py:591-605,
# models/image_models.py:101-113): vocab 30000, embedding and hidden 512,
# two LSTMs, batch 64, Adam 2e-3; the sequence length 100 is the README
# row bench.py:578 quotes ("bs64 h512 seqlen100 -> 184 ms/batch on K40m")
V1_RNN = {"vocab": 30000, "emb": 512, "hidden": 512, "lstm_num": 2,
          "batch_size": 64, "seq_len": 100, "ragged": 0,
          "samples": 64 * 24, "test_samples": 128}
V1_RNN_SMALL = {"vocab": 300, "emb": 32, "hidden": 32, "lstm_num": 2,
                "batch_size": 8, "seq_len": 12, "ragged": 1, "samples": 24,
                "test_samples": 16}
V1_RNN_TIME_BATCHES, V1_RNN_RUNS, V1_RNN_PROFILED = 20, 2, 3
V1_RNN_WANT = {"lstm_forward": 4, "lstm_backward": 2}

# the @provider module: seeded synthetic token sequences (labels {0, 1}:
# whether the last token lies in the lower half of the vocabulary), as
# bench.py feeds random ids; "{pkg}" is the package the config runs on
V1_RNN_PROVIDER = '''\
import numpy as np
from {pkg}.trainer.PyDataProvider2 import (integer_value,
                                          integer_value_sequence, provider)


def hook(settings, file_list=None, vocab=30000, seq_len=100, ragged=False,
         samples=64, test_samples=64, seed=0, **kwargs):
    settings.input_types = {{"word": integer_value_sequence(vocab),
                            "label": integer_value(2)}}
    settings.vocab, settings.seq_len, settings.ragged = vocab, seq_len, ragged
    settings.samples, settings.test_samples = samples, test_samples
    settings.seed = seed


@provider(input_types={{"word": integer_value_sequence(1),
                       "label": integer_value(2)}}, init_hook=hook)
def process(settings, file_name):
    test = file_name.endswith("test")
    rng = np.random.RandomState(settings.seed + int(test))
    for _ in range(settings.test_samples if test else settings.samples):
        n = (int(rng.randint(1, settings.seq_len + 1)) if settings.ragged
             else settings.seq_len)
        ids = rng.randint(0, settings.vocab, n)
        yield {{"word": ids.tolist(),
               "label": int(ids[-1] < settings.vocab // 2)}}
'''

# the v1 form of benchmark/paddle/rnn/rnn.py, which rnn/run.sh times with
# `paddle train --job=time`
V1_RNN_CONFIG = '''\
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from {pkg}.v1 import *  # noqa: F401,F403

vocab = get_config_arg("vocab", int, 30000)
emb = get_config_arg("emb", int, 512)
hidden = get_config_arg("hidden", int, 512)
lstm_num = get_config_arg("lstm_num", int, 2)
batch_size = get_config_arg("batch_size", int, 64)
seq_len = get_config_arg("seq_len", int, 100)
define_py_data_sources2(
    "synthetic", "synthetic_test", module="v1_rnn_provider_{tag}",
    obj="process",
    args={{"vocab": vocab, "seq_len": seq_len,
          "ragged": get_config_arg("ragged", bool, False),
          "samples": get_config_arg("samples", int, 64 * 24),
          "test_samples": get_config_arg("test_samples", int, 128),
          "seed": get_config_arg("seed", int, 0)}})
settings(batch_size=batch_size, learning_rate=2e-3,
         learning_method=AdamOptimizer())
net = data_layer("word", size=vocab, dtype="int64", seq=True)
net = embedding_layer(input=net, size=emb)
for _ in range(lstm_num):
    net = simple_lstm(input=net, size=hidden)
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
label = data_layer("label", size=2, dtype="int64")
outputs(classification_cost(input=net, label=label))
'''


def v1_rnn_args(sizes):
    """`sizes` as the --config_args string the config reads."""
    return ",".join(f"{k}={v}" for k, v in sizes.items())


def write_v1_rnn_config(dirname, pkg="paddle_tpu_torch", tag="port"):
    """The RNN config and its provider module into `dirname`, on the
    package `pkg` (the provider module is named after `tag`, so configs on
    two packages can share a process); returns the config's path."""
    with open(os.path.join(dirname, f"v1_rnn_provider_{tag}.py"), "w") as f:
        f.write(V1_RNN_PROVIDER.format(pkg=pkg))
    conf = os.path.join(dirname, f"v1_rnn_conf_{tag}.py")
    with open(conf, "w") as f:
        f.write(V1_RNN_CONFIG.format(pkg=pkg, tag=tag))
    return conf


def v1_rnn_trainer(conf, sizes, place):
    """The config at `sizes` read as `train --config` reads it, in fresh
    default programs, and its V1Trainer on `place` (startup run)."""
    fluid.reset()
    set_config_args(v1_rnn_args(sizes))
    runpy.run_path(conf, run_name="__config__")
    return V1Trainer(declared_outputs()[0], place=place)


def v1_rnn_parity_phase(conf):
    """36(a) the small RNN config (vocab 300, embedding and hidden 32, two
    LSTMs, batch 8 of ragged lengths up to 12), f32 with TF32 off: 3 steps
    on the card (``V1Trainer(place=CUDAPlace(0))``) and 3 on an
    explicit-CPU executor from the card's startup state, on the
    provider's first three batches: losses within 1e-4 relative, the
    step-1 gradients within 1e-3 of their max |g|, K7 4 and K8 2 a step;
    then a pass of ``train`` (K7 4, K8 2 a batch) and ``test`` (K7 2 a
    batch) on the card."""
    trainer = v1_rnn_trainer(conf, V1_RNN_SMALL, fluid.CUDAPlace(0))
    main = fluid.default_main_program()
    block = main.global_block()
    state = snapshot(block)
    grads = sorted(p.name + "@GRAD" for p in block.all_parameters())
    prov, files = get_data_source("train")
    feeds = list(prov.batches(files, trainer.batch_size, seed=0))[:3]
    fetch = [trainer.cost_var] + grads
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, state, cpu_scope)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    gpu, cpu = [], []
    for feed in feeds:
        vals, launches = counted(lambda: trainer.exe.run(
            main, feed=feed, fetch_list=fetch))
        check_launches("v1_rnn_parity", launches, V1_RNN_WANT)
        gpu.append(vals)
        cpu.append(cpu_exe.run(main, feed=feed, fetch_list=fetch,
                               scope=cpu_scope))
    loss_rel = [abs(float(g[0][0]) - float(c[0][0])) / abs(float(c[0][0]))
                for g, c in zip(gpu, cpu)]
    grad_rel = {n: float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
                for n, g, c in zip(grads, gpu[0][1:], cpu[0][1:])}
    n_train = V1_RNN_SMALL["samples"] // V1_RNN_SMALL["batch_size"]
    n_test = V1_RNN_SMALL["test_samples"] // V1_RNN_SMALL["batch_size"]
    pass_losses, train_launches = counted(lambda: trainer.train(1))
    check_launches("v1_rnn_train_pass", train_launches,
                   {k: n_train * v for k, v in V1_RNN_WANT.items()})
    test_loss, test_launches = counted(trainer.test)
    check_launches("v1_rnn_test", test_launches,
                   {"lstm_forward": 2 * n_test})
    res = {**V1_RNN_SMALL, "dtype": "float32",
           "steps": "free-running from one state",
           "gpu_losses": [float(g[0][0]) for g in gpu],
           "cpu_losses": [float(c[0][0]) for c in cpu],
           "loss_rel_err": loss_rel, "grad_rel_err_step1": grad_rel,
           "launches_per_step": launches,
           "train_pass_losses": pass_losses,
           "train_pass_launches": train_launches, "test_loss": test_loss,
           "test_launches": test_launches}
    log("v1_rnn_parity", res)
    if (max(loss_rel) > 1e-4 or max(grad_rel.values()) > 1e-3
            or not np.isfinite(pass_losses + [test_loss]).all()):
        raise AssertionError(f"v1_rnn_parity: card and CPU disagree: {res}")
    fluid.reset()
    return res


def v1_rnn_time_run(conf):
    """One `python -m paddle_tpu_torch train --config ... --job time` at
    full width in a subprocess; returns its JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train", "--config", conf,
         "--job", "time", "--time-batches", str(V1_RNN_TIME_BATCHES),
         "--config_args", v1_rnn_args(V1_RNN)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train --job time exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def v1_rnn_bench_phase(conf, card_name, smi):
    """36(b) the full-width config (``V1_RNN``: about 19.6 M parameters,
    f32) through the CLI, two runs of `train --config ... --job time
    --time-batches 20` in subprocesses (ms a batch: median, min, max;
    tokens a second); then in this process: a warm-up step, the same 20
    batches with every count at 0 before them (K7 4, K8 2 a step), peak
    memory, 3 profiled steps (device busy share, device kernels a step,
    K7's and K8's device ms a step), and ``test`` (K7 2 a batch)."""
    runs = [v1_rnn_time_run(conf) for _ in range(V1_RNN_RUNS)]
    ms = [r["ms_per_batch"] for r in runs]
    for r in runs:
        if r["batch_size"] != V1_RNN["batch_size"] or r["last_loss"] is None:
            raise AssertionError(f"v1_rnn_time: {r}")
    t0 = time.monotonic()
    trainer = v1_rnn_trainer(conf, V1_RNN, fluid.CUDAPlace(0))
    main = fluid.default_main_program()
    prov, files = get_data_source("train")
    it = prov.batches(files, trainer.batch_size, seed=0)
    feeds = [f for _, f in zip(range(1 + V1_RNN_TIME_BATCHES
                                     + V1_RNN_PROFILED), it)]
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    fetch = [trainer.cost_var]
    trainer.exe.run(main, feed=feeds[0], fetch_list=fetch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = feeds[1:1 + V1_RNN_TIME_BATCHES]
    t0 = time.monotonic()
    losses, launches = counted(lambda: [
        float(trainer.exe.run(main, feed=f, fetch_list=fetch)[0][0])
        for f in timed])
    in_ms = (time.monotonic() - t0) / len(timed) * 1e3
    check_launches("v1_rnn_bench", launches,
                   {k: len(timed) * v for k, v in V1_RNN_WANT.items()})
    n_test = V1_RNN["test_samples"] // V1_RNN["batch_size"]
    test_loss, test_launches = counted(trainer.test)
    check_launches("v1_rnn_bench_test", test_launches,
                   {"lstm_forward": 2 * n_test})
    tokens = V1_RNN["batch_size"] * V1_RNN["seq_len"]
    med = float(np.median(ms))
    res = {"card": card_name, "nvidia_smi": smi, **V1_RNN,
           "dtype": "float32", "T_padded": bucket_len(V1_RNN["seq_len"]),
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "ops": len(main.global_block().ops),
           "cli_runs": runs, "cli_ms_per_batch_median": med,
           "cli_ms_per_batch_min": min(ms), "cli_ms_per_batch_max": max(ms),
           "cli_tok_s": tokens / (med / 1e3),
           "setup_s": setup_s, "in_process_ms_per_batch": in_ms,
           "losses": losses,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / len(timed)
                                 for k, v in launches.items()},
           "test_loss": test_loss, "test_launches": test_launches}
    res.update(srl_profile(trainer.exe, main, fetch,
                           [(f, None) for f in feeds[1 + len(timed):]]))
    log("v1_rnn_bench", res)
    if not np.isfinite(losses + [test_loss]).all():
        raise AssertionError(f"v1_rnn_bench: losses {losses}")
    fluid.reset()
    return res


def v1_rnn_phase(card_name, smi):
    with tempfile.TemporaryDirectory() as tmp:
        conf = write_v1_rnn_config(tmp)
        parity = v1_rnn_parity_phase(conf)
        bench = v1_rnn_bench_phase(conf, card_name, smi)
    return parity, bench


# -- 37. CTC and detection ----------------------------------------------------

# path (b): per direction sequence_fc(3H) + dynamic_gru(H), the logits of
# C classes and a blank from the sum of two sequence_fc, warpctc, mean,
# Momentum; feeds of 40-wide frames and C 28 labels
CTC_BIG = {"frames": 40, "hidden": 256, "classes": 28, "bs": 32,
           "t_min": 100, "t_max": 384, "l_min": 10, "l_max": 60}
CTC_SMALL = {"frames": 6, "hidden": 8, "classes": 5, "bs": 4,
             "t_min": 3, "t_max": 12, "l_min": 0, "l_max": 4}
CTC_LR, CTC_MOMENTUM = 1e-4, 0.9
CTC_WANT = {"gru_forward": 4, "gru_backward": 2}
CTC_WARM, CTC_TIMED, CTC_PROFILED = 2, 5, 3


def ctc_train_program(fluid, frames, hidden, classes, before_minimize=None,
                      **_):
    """Path (b) in `fluid` (either package), in its fresh default
    programs: returns (loss, logits, test program, main, startup).
    `before_minimize(main)` may edit the program first."""
    fluid.reset()
    L = fluid.layers
    x = L.sequence_data(name="frames", shape=[frames], dtype="float32")
    label = L.sequence_data(name="labels", shape=[1], dtype="int64")
    fc_f = L.sequence_fc(x, size=3 * hidden)
    fc_b = L.sequence_fc(x, size=3 * hidden)
    fwd = L.dynamic_gru(fc_f, size=hidden)
    bwd = L.dynamic_gru(fc_b, size=hidden, is_reverse=True)
    logits = L.propagate_length(fc_f, L.sums(
        [L.sequence_fc(fwd, size=classes + 1),
         L.sequence_fc(bwd, size=classes + 1)]))
    loss = L.mean(L.warpctc(logits, label, blank=classes))
    test = fluid.default_main_program().clone(for_test=True)
    if before_minimize is not None:
        before_minimize(fluid.default_main_program())
    fluid.optimizer.Momentum(learning_rate=CTC_LR,
                             momentum=CTC_MOMENTUM).minimize(loss)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, logits, test, fluid.default_main_program(), startup


def ctc_feed(lod, frames, classes, bs, t_min, t_max, l_min, l_max, seed=0,
             **_):
    """A batch of `bs` ragged frame sequences and label sequences (at most
    a quarter as long as their frames, so every alignment is feasible)
    from RandomState(seed), as `lod` LoDTensors; and the lengths."""
    rng = np.random.RandomState(seed)
    ts = rng.randint(t_min, t_max + 1, bs)
    ls = [int(rng.randint(l_min, min(l_max, t // 4) + 1)) for t in ts]
    xs = [rng.randn(t, frames).astype(np.float32) for t in ts]
    ys = [rng.randint(0, classes, (n, 1)).astype(np.int64) for n in ls]
    return ({"frames": lod.LoDTensor.from_sequences(xs),
             "labels": lod.LoDTensor.from_sequences(ys)},
            [int(t) for t in ts], ls)


def ctc_decode_program(fluid, classes):
    """Greedy CTC decoding and its edit distance as a test-mode program in
    `fluid`: logits [B, T, C + 1] and their lengths → ``top_k`` 1 →
    ``ctc_align`` (blank C) → ``edit_distance`` (normalized) against the
    labels [B, L] and theirs.  Returns the fetch list (ids, their
    lengths, distances, sequence count)."""
    from_helper = fluid.framework.layer_helper.LayerHelper
    fluid.reset()
    L = fluid.layers
    logits = L.data("logits", shape=[-1, classes + 1], dtype="float32")
    lens = L.data("logits_len", shape=[-1], dtype="int32",
                  append_batch_size=False)
    ref = L.data("ref", shape=[-1], dtype="int64")
    ref_len = L.data("ref_len", shape=[-1], dtype="int32",
                     append_batch_size=False)
    _, idx = L.topk(logits, 1)
    ids = L.reshape(idx, [0, -1])
    helper = from_helper("ctc_align")
    out = helper.create_tmp_variable("int32", shape=None)
    out_len = helper.create_tmp_variable("int32", shape=None)
    helper.append_op("ctc_align", inputs={"Input": [ids.name],
                                          "Length": [lens.name]},
                     outputs={"Output": [out.name],
                              "OutputLength": [out_len.name]},
                     attrs={"blank": classes})
    helper = from_helper("edit_distance")
    dist = helper.create_tmp_variable("float32", shape=None)
    seqn = helper.create_tmp_variable("int64", shape=None)
    helper.append_op("edit_distance",
                     inputs={"Hyps": [out.name], "Refs": [ref.name],
                             "HypsLength": [out_len.name],
                             "RefsLength": [ref_len.name]},
                     outputs={"Out": [dist.name], "SequenceNum": [seqn.name]},
                     attrs={"normalized": True})
    return [out, out_len, dist, seqn]


def ctc_decode_feed(logits, lengths, labels, label_lengths):
    return {"logits": logits, "logits_len": np.asarray(lengths, np.int32),
            "ref": labels, "ref_len": np.asarray(label_lengths, np.int32)}


def ctc_decode(exe, fetch, feed):
    prog = fluid.default_main_program()
    return [np.asarray(v) for v in exe.run(prog, feed=feed,
                                           fetch_list=fetch)]


def padded_labels(labels):
    """A labels LoDTensor as a padded [B, L] int64 array."""
    padded, _ = labels.to_padded(bucket=False)
    return padded.reshape(padded.shape[0], -1)


def _boxes(rng, n, lo=0.0, hi=1.0, min_side=0.05):
    """`n` corner boxes (x1, y1, x2, y2) inside [lo, hi]."""
    a = rng.uniform(lo, hi - min_side, (n, 2))
    side = rng.uniform(min_side, (hi - lo) / 2, (n, 2))
    return np.concatenate([a, np.minimum(a + side, hi)], 1).astype(
        np.float32)


def _detection_inputs(rng, n=2, p=12, k=3, g=3):
    prior = _boxes(rng, p)
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (p, 1))
    # ground truths are priors shifted a little: each valid one has its own
    # best prior, so no two claim one (an order XLA leaves undefined)
    pick = np.stack([rng.choice(p, g, replace=False) for _ in range(n)])
    gt = (prior[pick] + rng.uniform(-0.02, 0.02, (n, g, 4))).astype(
        np.float32)
    return {"Loc": rng.randn(n, p, 4).astype(np.float32) * 0.5,
            "Conf": rng.randn(n, p, k).astype(np.float32),
            "PriorBox": prior, "PriorBoxVar": pvar, "GtBox": gt,
            "GtLabel": rng.randint(1, k, (n, g)).astype(np.int64),
            "GtCount": np.asarray([g, g - 1], np.int32)[:n]}


def new_op_cases():
    """Every op type this slice adds, at small shapes from fixed seeds:
    name → (op type, inputs as numpy, attrs, differentiable input slots,
    output slots)."""
    r = np.random.RandomState
    i32 = np.int32
    ctc = {"Logits": r(1).randn(3, 7, 5).astype(np.float32),
           "Label": np.asarray([[1, 2, 2], [3, 4, 0], [4, 0, 0]], np.int64),
           "LogitsLength": np.asarray([7, 5, 6], i32),
           "LabelLength": np.asarray([3, 2, 1], i32)}
    det = _detection_inputs(r(2))
    roi_x = r(3).randn(2, 3, 8, 8).astype(np.float32)
    roi_x[1, :, 2:4, 2:4] = 1.5  # a tied maximum inside one bin
    scores = np.round(r(4).rand(16), 1).astype(np.float32)  # ties
    qid = np.repeat(np.arange(3), 4).reshape(-1, 1).astype(np.int64)
    return {
        "warpctc": ("warpctc", ctc, {"blank": 0}, ("Logits",), ("Loss",)),
        "warpctc_edges": (
            "warpctc",
            {"Logits": r(5).randn(4, 6, 4).astype(np.float32),
             # infeasible (3 repeats in 4 frames), a label of length 0, a
             # logit length of 0, a logit length below T
             "Label": np.asarray([[1, 1, 1], [2, 0, 0], [3, 0, 0],
                                  [1, 2, 0]], np.int64)[..., None],
             "LogitsLength": np.asarray([4, 6, 0, 3], i32),
             "LabelLength": np.asarray([3, 0, 1, 2], i32)},
            {"blank": 0}, ("Logits",), ("Loss",)),
        "warpctc_last_blank": (
            "warpctc", {**ctc, "Label": ctc["Label"] % 4}, {"blank": 4},
            ("Logits",), ("Loss",)),
        "ctc_align": (
            "ctc_align",
            {"Input": np.asarray([[0, 1, 1, 0, 2, 2, 3, 3],
                                  [1, 0, 1, 1, 0, 0, 0, 2],
                                  [2, 2, 2, 2, 2, 2, 2, 2],
                                  [3, 3, 0, 3, 1, 2, 1, 0]], np.int64),
             "Length": np.asarray([8, 5, 0, 8], i32)},
            {"blank": 0}, (), ("Output", "OutputLength")),
        "edit_distance": (
            "edit_distance",
            {"Hyps": r(6).randint(0, 4, (4, 6)).astype(np.int64),
             "Refs": r(7).randint(0, 4, (4, 7)).astype(np.int64),
             "HypsLength": np.asarray([6, 3, 0, 5], i32),
             "RefsLength": np.asarray([7, 0, 4, 5], i32)},
            {"normalized": True}, (), ("Out", "SequenceNum")),
        "edit_distance_raw": (
            "edit_distance",
            {"Hyps": r(8).randint(0, 3, (3, 5)).astype(np.int64),
             "Refs": r(9).randint(0, 3, (3, 4)).astype(np.int64),
             "HypsLength": np.asarray([5, 2, 4], i32),
             "RefsLength": np.asarray([4, 4, 1], i32)},
            {"normalized": False}, (), ("Out", "SequenceNum")),
        "nce": ("nce", {"Input": r(10).randn(4, 8).astype(np.float32) * 0.3,
                        "Weight": r(11).randn(16, 8).astype(np.float32)
                        * 0.3,
                        "Bias": r(12).randn(16).astype(np.float32) * 0.1,
                        "Label": r(13).randint(0, 16, (4, 1))},
                {"num_neg_samples": 5}, ("Input", "Weight", "Bias"),
                ("Cost", "SampleLogits", "SampleLabels")),
        "im2sequence": (
            "im2sequence", {"X": r(14).randn(2, 3, 7, 6).astype(np.float32)},
            {"kernels": [3, 2], "strides": [2, 1],
             "paddings": [1, 0, 2, 1]}, ("X",), ("Out",)),
        "im2sequence_two_pads": (
            "im2sequence", {"X": r(15).randn(1, 2, 5, 5).astype(np.float32)},
            {"kernels": [2, 2], "strides": [1, 2], "paddings": [1, 1]},
            ("X",), ("Out",)),
        "lrn": ("lrn", {"X": r(16).randn(2, 6, 4, 5).astype(np.float32)},
                {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ("X",),
                ("Out", "MidOut")),
        "row_conv": ("row_conv",
                     {"X": r(17).randn(3, 6, 4).astype(np.float32),
                      "Filter": r(18).randn(3, 4).astype(np.float32)},
                     {}, ("X", "Filter"), ("Out",)),
        "auc": ("auc", {"Predict": np.stack([1 - scores, scores], 1),
                        "Label": (r(19).rand(16, 1) > 0.5).astype(np.int64)},
                {}, (), ("AUC",)),
        "precision_recall": (
            "precision_recall",
            {"Indices": r(20).randint(0, 4, (16, 1)).astype(np.int64),
             "Label": r(21).randint(0, 4, (16, 1)).astype(np.int64)},
            {"class_number": 4}, (), ("BatchMetrics", "AccumMetrics")),
        "positive_negative_pair": (
            "positive_negative_pair",
            {"Score": np.round(r(22).rand(12, 1), 1).astype(np.float32),
             "Label": r(23).randint(0, 3, (12, 1)).astype(np.float32),
             "QueryID": qid,
             "AccumulatePositivePair": np.float32([2.0]),
             "AccumulateNegativePair": np.float32([1.0]),
             "AccumulateNeutralPair": np.float32([0.0])},
            {}, (), ("PositivePair", "NegativePair", "NeutralPair")),
        "iou_similarity": ("iou_similarity",
                           {"X": _boxes(r(24), 5), "Y": _boxes(r(25), 3)},
                           {}, (), ("Out",)),
        "box_coder_encode": (
            "box_coder", {"PriorBox": det["PriorBox"],
                          "PriorBoxVar": det["PriorBoxVar"],
                          "TargetBox": _boxes(r(26), 3)},
            {"code_type": "encode_center_size"}, (), ("OutputBox",)),
        "box_coder_decode": (
            "box_coder", {"PriorBox": det["PriorBox"],
                          "PriorBoxVar": det["PriorBoxVar"],
                          "TargetBox": det["Loc"]},
            {"code_type": "decode_center_size"}, (), ("OutputBox",)),
        "prior_box": (
            "prior_box", {"Input": np.zeros((1, 4, 3, 4), np.float32),
                          "Image": np.zeros((1, 3, 12, 16), np.float32)},
            {"min_sizes": [2.0, 5.0], "max_sizes": [4.0, 9.0],
             "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
             "variances": [0.1, 0.1, 0.2, 0.2]}, (),
            ("Boxes", "Variances")),
        "roi_pool": (
            "roi_pool",
            {"X": roi_x,
             "ROIs": np.asarray([[0, 0, 0, 7, 7], [1, 1, 1, 5, 4],
                                 [1, 4, 2, 4, 2], [0, 6, 6, 2, 2]],
                                np.float32)},
            {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 1.0},
            ("X",), ("Out",)),
        "multibox_loss": (
            "multibox_loss", det,
            {"overlap_threshold": 0.3, "neg_pos_ratio": 2.0,
             "background_label": 0}, ("Loc", "Conf"), ("Loss",)),
        "detection_output": (
            "detection_output",
            {k: det[k] for k in ("Loc", "Conf", "PriorBox", "PriorBoxVar")},
            {"score_threshold": 0.05, "nms_threshold": 0.3, "nms_top_k": 6,
             "keep_top_k": 7, "background_label": 0}, (), ("Out",)),
    }


def emit_op(dev, op, ins, attrs, diff=(), outs=(), cts=None):
    """The port's emitter of `op` on `dev` from numpy inputs; with `diff`,
    also the gradients of sum_k sum(out_k * ct_k) over the float `outs`
    in those slots (``torch.autograd``, as ``generic_grad`` takes them).
    Returns ({slot: [numpy]}, {slot: numpy gradient})."""
    info = get_op_info(op)
    ctx = EmitContext(dev, is_test=False)
    t = {s: [torch.as_tensor(a).to(dev)] for s, a in ins.items()}
    leaves = {}
    for s in diff:
        leaves[s] = t[s][0].detach().clone().requires_grad_(True)
        t[s] = [leaves[s]]
    with torch.enable_grad():
        out = info.emit(ctx, t, dict(attrs))
        grads = {}
        if diff:
            total = sum((out[s][0] * torch.as_tensor(cts[s]).to(dev)).sum()
                        for s in outs if out[s][0].is_floating_point()
                        and s in cts)
            gs = torch.autograd.grad(total, [leaves[s] for s in diff],
                                     allow_unused=True)
            grads = {s: (np.zeros(ins[s].shape) if g is None
                         else g.detach().cpu().numpy())
                     for s, g in zip(diff, gs)}
    return ({s: [v.detach().cpu().numpy() for v in vs]
             for s, vs in out.items()}, grads)


def op_cotangents(outs):
    """Fixed cotangents in [0.5, 1.5) for every float output."""
    return {s: np.random.RandomState(90 + k).uniform(
        0.5, 1.5, v[0].shape).astype(v[0].dtype)
        for k, (s, v) in enumerate(sorted(outs.items()))
        if np.issubdtype(v[0].dtype, np.floating)}


def nce_formula(ins, got):
    """nce's Cost from its inputs and its fetched SampleLabels (numpy,
    float64)."""
    x = ins["Input"].astype(np.float64)
    w = ins["Weight"].astype(np.float64)
    b = ins["Bias"].astype(np.float64)
    lab = ins["Label"].reshape(-1)
    neg = got["SampleLabels"][0].astype(np.int64)
    log_q = -np.log(w.shape[0])

    def log_sig(v):
        return -np.logaddexp(0.0, -v)

    pos = (w[lab] * x).sum(-1) + b[lab]
    negl = (w[neg] * x[:, None]).sum(-1) + b[neg]
    return -(log_sig(pos - log_q) + log_sig(-(negl - log_q)).sum(1))


def ops_card_phase(dev):
    """37(a) every op type this slice adds on the card against the CPU,
    f32, at ``new_op_cases``' shapes: each output within 1e-5 of its max
    |value| (integers equal), each gradient of a differentiable slot
    within 1e-5 of its max |g|; ``nce`` by its properties (negatives in
    [0, C), Cost equal to the numpy formula from the fetched negatives)."""
    rows = {}
    for name, (op, ins, attrs, diff, outs) in new_op_cases().items():
        cpu_out, _ = emit_op(torch.device("cpu"), op, ins, attrs)
        cts = op_cotangents({s: cpu_out[s] for s in outs})
        cpu, cpu_g = emit_op(torch.device("cpu"), op, ins, attrs, diff,
                             outs, cts)
        gpu, gpu_g = emit_op(dev, op, ins, attrs, diff, outs, cts)
        if op == "nce":
            c = ins["Weight"].shape[0]
            negs = gpu["SampleLabels"][0]
            err = float(np.abs(gpu["Cost"][0][:, 0]
                               - nce_formula(ins, gpu)).max())
            ok = bool((negs >= 0).all() and (negs < c).all()) and err < 1e-4
            rows[name] = {"cost_vs_formula": err, "negatives_in_range": ok}
        else:
            out_err = max(_rel(g, c) for s in outs
                          for g, c in zip(gpu[s], cpu[s]))
            grad_err = max((_rel(gpu_g[s], cpu_g[s]) for s in diff),
                           default=0.0)
            ok = out_err <= 1e-5 and grad_err <= 1e-5
            rows[name] = {"op": op, "out_rel_err": out_err,
                          "grad_rel_err": grad_err}
        rows[name]["ok"] = ok
        if not ok:
            raise AssertionError(f"op {name} on the card disagrees with the "
                                 f"CPU: {rows[name]}")
    log("ctc_detection_ops", rows)
    return rows


def _rel(got, want):
    """Integers: 0 if equal, else inf; floats: max |got - want| over max
    |want|."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    if not np.issubdtype(want.dtype, np.floating):
        return 0.0 if np.array_equal(got, want) else float("inf")
    if not want.size:
        return 0.0
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def ctc_parity_phase():
    """37(b) path (b) at ``CTC_SMALL``, f32 with TF32 off, by
    ``parity_run``: 3 Momentum steps on the card and on an explicit CPU
    from one state, losses 1e-4 relative, step-1 gradients 1e-3 of max
    |g|, K9 4 and K10 2 a step."""
    loss, _, _, main, startup = ctc_train_program(fluid, **CTC_SMALL)
    feed, _, _ = ctc_feed(lod_mod, **CTC_SMALL)
    grads = sorted(p.name + "@GRAD" for p in
                   main.global_block().all_parameters())
    res = parity_run("ctc_parity", main, startup, loss, feed, grads,
                     CTC_WANT, {"bs": CTC_SMALL["bs"]})
    fluid.reset()
    return res


def ctc_bench_phase(card_name, smi):
    """37(c) path (b) at ``CTC_BIG`` (40-wide frames, 100-384 of them,
    labels of 10-60 tokens, C 28, H 256, batch 32), f32: CTC_WARM +
    CTC_TIMED Momentum steps on fresh batches (K9 4, K10 2 a step), ms a
    step and frames a second; the last CTC_PROFILED batches again under
    the profiler (device busy share, kernels a step, K9's and K10's device
    ms a step); then the test-mode clone's logits of the
    last batch, greedy-decoded (``top_k`` → ``ctc_align``) and scored
    (``edit_distance``) by ``ctc_decode_program`` on the card and on the
    CPU from those logits: equal ids, lengths and distances."""
    t0 = time.monotonic()
    loss, logits, test, main, startup = ctc_train_program(fluid, **CTC_BIG)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    batches = [ctc_feed(lod_mod, seed=s, **CTC_BIG)
               for s in range(CTC_WARM + CTC_TIMED)]
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    rows = []
    for i, (feed, ts, _) in enumerate(batches):
        t0 = time.monotonic()
        (val,), launches = counted(lambda: exe.run(main, feed=feed,
                                                   fetch_list=[loss]))
        rows.append((float(val[0]), launches, time.monotonic() - t0,
                     sum(ts)))
        check_launches(f"ctc_bench_step{i}", launches, CTC_WANT)
    step_ms = [r[2] * 1e3 for r in rows[CTC_WARM:]]
    med = float(np.median(step_ms))
    prof = srl_profile(exe, main, [loss],
                       [(f, None) for f, _, _ in batches[-CTC_PROFILED:]],
                       (("k9", ("gru_fwd",)), ("k10", ("gru_bwd", "rnn_dw"))))
    feed, ts, ls = batches[-1]
    (lg,), infer_launches = counted(lambda: exe.run(
        test, feed=feed, fetch_list=[logits]))
    check_launches("ctc_infer", infer_launches, {"gru_forward": 2})
    labels = padded_labels(feed["labels"])
    dfeed = ctc_decode_feed(np.asarray(lg), ts, labels, ls)
    fetch = ctc_decode_program(fluid, CTC_BIG["classes"])
    gpu = ctc_decode(fluid.Executor(fluid.CUDAPlace(0)), fetch, dfeed)
    cpu = ctc_decode(fluid.Executor(fluid.CPUPlace()), fetch, dfeed)
    same = all(np.array_equal(a, b) for a, b in zip(gpu, cpu))
    res = {"card": card_name, "nvidia_smi": smi, **CTC_BIG,
           "dtype": "float32", "lr": CTC_LR, "setup_s": setup_s,
           "T_padded": bucket_len(max(max(b[1]) for b in batches)),
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "losses": [r[0] for r in rows], "step_ms_median": med,
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "frames_s": float(np.mean([r[3] for r in rows[CTC_WARM:]]))
           / (med / 1e3),
           "launches_per_step": rows[-1][1],
           "infer_launches": infer_launches,
           "last_lengths": ts, "T_padded_last": bucket_len(max(ts)),
           "decode_card_equals_cpu": same,
           "greedy_edit_distance_mean": float(np.mean(gpu[2])),
           "decoded_len_mean": float(np.mean(gpu[1])), **prof}
    log("ctc_bench", res)
    if not np.isfinite(res["losses"]).all() or not same:
        raise AssertionError(f"ctc_bench: {res}")
    fluid.reset()
    return res


def detection_map_phase(dev):
    """37(d) ``detection_output`` on the card and on the CPU from one set
    of inputs, each slate into a ``DetectionMAP`` with the same ground
    truth: the slates within 1e-5 and the two mAPs equal, in both AP
    versions."""
    _, ins, attrs, _, _ = new_op_cases()["detection_output"]
    det = _detection_inputs(np.random.RandomState(2))
    maps = {}
    for ap in ("integral", "11point"):
        got = []
        for d in (dev, torch.device("cpu")):
            out, _ = emit_op(d, "detection_output", ins, attrs)
            m = fluid.evaluator.DetectionMAP(overlap_threshold=0.3,
                                             ap_version=ap)
            m.add_batch(out["Out"][0], det["GtBox"], det["GtLabel"],
                        det["GtCount"])
            got.append((out["Out"][0], m.eval()))
        (card_slate, card_map), (cpu_slate, cpu_map) = got
        maps[ap] = {"card": card_map, "cpu": cpu_map,
                    "slate_rel_err": _rel(card_slate, cpu_slate)}
    log("detection_map", maps)
    for ap, m in maps.items():
        if m["card"] != m["cpu"] or m["slate_rel_err"] > 1e-5:
            raise AssertionError(f"DetectionMAP ({ap}): card and CPU "
                                 f"slates disagree: {maps}")
    return maps


def ctc_detection_phase(dev, card_name, smi):
    ops = ops_card_phase(dev)
    parity = ctc_parity_phase()
    bench = ctc_bench_phase(card_name, smi)
    maps = detection_map_phase(dev)
    return {"ops": ops, "parity": parity, "bench": bench, "map": maps}


# -- 38. the replica router and the analysis tier ----------------------------

# the router's replicas: (slots) each, with a pool for every slot at max_len
ROUTER_SLOTS = (4, 2)
DISPATCH_TIMED = 200  # replays timed for the dispatch overhead


def dispatch_overhead_s():
    """Host seconds one Executor.run dispatch costs beyond its device
    work: a one-op program (a [1] feed scaled) at K = 2, whose dispatches
    after the capture replay one CUDA graph, each ending in its fetch's
    host copy; the mean over DISPATCH_TIMED replays."""
    card = fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("dispatch.x", shape=[1], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.scale(x, scale=2.0)
    exe = fluid.Executor(card)
    feed = {"dispatch.x": np.ones((2, 1), np.float32)}
    for _ in range(3):  # eager, capture, first replay
        exe.run(main, feed=feed, fetch_list=[y], steps_per_dispatch=2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(DISPATCH_TIMED):
        out = exe.run(main, feed=feed, fetch_list=[y], steps_per_dispatch=2)
    secs = (time.monotonic() - t0) / DISPATCH_TIMED
    exe.close()
    if not np.allclose(out[0], 2.0):
        raise AssertionError(f"dispatch probe computed {out[0]}")
    return secs


def router_engine(lm, card, i):
    """Replica `i` of the router: a v2 engine of ROUTER_SLOTS[i] slots
    over the global scope's weights, with a right-sized pool."""
    n = ROUTER_SLOTS[i]
    return ServingEngine(lm, max_batch_size=n, page_size=PAGE, place=card,
                         num_pages=n * pages_needed(MAX_LEN, PAGE) + 1,
                         name=f"replica{i}_{n}slots", **V2)


def drop_pools(eng):
    """Free `eng`'s K/V pools, which the engine keeps in the global
    scope (they outlive the engine object)."""
    scope = fluid.global_scope()
    for s in ("k", "v"):
        scope._vars.pop(f"{eng._cache_name}.{s}", None)


def leak_free(eng):
    eng.cache.prefix.clear()
    if eng.cache.allocator.available() != eng.num_pages - 1:
        raise AssertionError(f"{eng.name}: page leak: "
                             f"{eng.stats()['page_stats']}")


def decode_device_ms(eng, prompts):
    """Device ms of one decode step of `eng`'s program: the feed of its
    last decode step, recorded while it serves `prompts`, moved to the
    card once and replayed by ``time_ms`` without a host sync."""
    seen = {}
    run = eng._run

    def record(prog, feed, fetch, counter, mark):
        if mark == "serve.decode":
            seen.update(prog=prog, feed=feed, fetch=fetch)
        return run(prog, feed, fetch, counter, mark)

    eng._run = record
    for p in prompts:
        eng.submit(p, MAX_NEW)
    eng.run()
    del eng._run
    leak_free(eng)
    if not seen:
        raise AssertionError(f"{eng.name} ran no decode step")
    feed = {k: torch.as_tensor(np.asarray(v)).to(eng._exe.device)
            for k, v in seen["feed"].items()}
    return time_ms(lambda: eng._exe.run(
        seen["prog"], feed=feed, fetch_list=seen["fetch"],
        scope=eng._scope, return_numpy=False))


def router_serve_phase(card_name, smi):
    """The prompts through one wide v2 engine and through a ReplicaRouter
    over two narrower ones (serve_bench's router mode)."""
    from paddle_tpu_torch.analysis import cost as acost
    from paddle_tpu_torch.serving import ReplicaRouter

    card = fluid.CUDAPlace(0)
    fluid.reset()
    torch.cuda.empty_cache()
    lm = gpt_bench.build(card, seed=SEED)
    scope = fluid.global_scope()
    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    serve(lm, prompts, card, **V2)  # warm-up
    (wide_tok, wide_reqs, wide, wide_wall), wide_launch = counted(
        lambda: serve(lm, prompts, card, **V2))
    check_launches("v2_wide", wide_launch, v2_want(wide.stats()))
    wide_row = serve_row("v2", prompts, wide_tok, wide_reqs, wide,
                         wide_wall, wide_launch)

    engines = [router_engine(lm, card, i) for i in range(len(ROUTER_SLOTS))]
    router = ReplicaRouter(engines)
    want_first = min(range(len(engines)), key=lambda i: (
        (len(prompts[0]) + MAX_NEW) * router.token_cost_s[i], i))

    def route():
        t0 = time.monotonic()
        rids = [router.submit(p, MAX_NEW, arrival=t0) for p in prompts]
        fin = router.run()
        return rids, fin, time.monotonic() - t0

    (rids, fin, wall), launches = counted(route)
    if sorted(fin) != sorted(rids):
        raise AssertionError("router: not every request finished")
    if any(len(fin[r].generated) != MAX_NEW for r in rids):
        raise AssertionError("router: a request finished short of max_new")
    first = router.replica_of(rids[0])
    if first != want_first:
        raise AssertionError(f"router placed request 0 on replica {first}, "
                             f"the analyzer's argmin is {want_first}")
    st = router.stats()
    if any(st["pending_tokens"]):
        raise AssertionError(f"router pending tokens {st['pending_tokens']}")
    for e in engines:
        leak_free(e)
    want = {k: sum(v2_want(e.stats())[k] for e in engines)
            for k in ("flash_attention", "paged_attention",
                      "paged_attention_mq")}
    check_launches("router", launches, want)
    tokens = [fin[r].generated for r in rids]
    reqs = [fin[r] for r in rids]
    ttft = sorted(r.first_token_t - r.arrival for r in reqs)
    gap_scope = cpu_scope(lm, [scope.find_np(p.name) for p in lm._params])
    agreement = agree("router_vs_wide", lm, gap_scope, prompts, wide_tok,
                      tokens)

    # static memory report of each replica beside its measured growth,
    # each replica built alone and run alone on the requests the router
    # placed on it; then the device time of one decode step beside the
    # cost model's
    placed = [[p for r, p in zip(rids, prompts)
               if router.replica_of(r) == i] for i in range(len(engines))]
    router_stats = [e.stats() for e in engines]
    step_cost_s = list(router.step_cost_s)
    for e in engines:
        drop_pools(e)
    del router, engines[:]
    # the weights are resident before a replica is built, so they are in
    # hbm_report's static peak and not in the measured growth
    weights = sum(scope.find(p.name).numel()
                  * scope.find(p.name).element_size() for p in lm._params)
    replicas = []
    for i, n in enumerate(ROUTER_SLOTS):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = router_engine(lm, card, i)
        for p in placed[i]:
            eng.submit(p, MAX_NEW)
        eng.run()
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        leak_free(eng)
        hbm = eng.hbm_report()
        static = hbm["total_peak_bytes"]
        cost = acost.program_cost(eng.programs()["decode"],
                                  batch_size=eng.num_slots)
        replicas.append({
            "name": eng.name, "slots": n, "num_pages": eng.num_pages,
            "placements": st["placements"][i],
            "step_cost_s": step_cost_s[i],
            "hbm_report_total_peak_bytes": static,
            "hbm_report_kv_pool_bytes": hbm["kv_pool_bytes"],
            "weights_bytes": weights,
            "measured_peak_growth_bytes": grown,
            "static_over_measured_plus_weights": static / (grown + weights),
            "predicted_decode_step_ms": cost["predicted_step_time_s"] * 1e3,
            "predicted_bound": cost["predicted_bound"],
            "measured_decode_step_device_ms": decode_device_ms(
                eng, placed[i] or prompts[:1]),
            **{k: router_stats[i][k] for k in (
                "mixed_steps", "decode_steps", "prefill_computed",
                "prefill_cached", "preemptions")}})
        drop_pools(eng)
        del eng
    row = {"requests": len(prompts), "max_new": MAX_NEW,
           "replica_slots": list(ROUTER_SLOTS), "wall_s": wall,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3,
           "output_tok_s": sum(len(t) for t in tokens) / wall,
           "placements": st["placements"], "first_placement": first,
           "launches": launches, "agreement": {
               k: agreement[k] for k in ("identical", "of", "parted")},
           "replicas": replicas}
    wide_keys = ("wall_s", "ttft_p50_ms", "output_tok_s", "mixed_steps",
                 "decode_steps", "launches")
    wide_out = {k: wide_row[k] for k in wide_keys}
    wide_out.update(slots=SLOTS, hbm_report_total_peak_bytes=wide.hbm_report()[
        "total_peak_bytes"])
    log("router_serve", {"card": card_name, "nvidia_smi": smi, "wide": wide_out,
                         "router": row})
    return {"wide": wide_out, "router": row}


def verify_lint_phase():
    """``Executor.run(verify=True)`` on the full-width GPT training program
    (f32, batch 2 x 256), then one training step; the forward saved as an
    inference model and linted by ``python -m paddle_tpu_torch lint``."""
    from paddle_tpu_torch.analysis import verify_program

    card = fluid.CUDAPlace(0)
    loss, main, startup = train_program(PARITY_SEQ, "float32")
    t0 = time.monotonic()
    report = verify_program(main, feed_names=["targets", "tokens"],
                            fetch_names=[loss.name])
    verify_s = time.monotonic() - t0
    if report.errors:
        raise AssertionError(f"verifier: {report.render()}")
    exe = fluid.Executor(card)
    exe.run(startup)
    (lval,), launches = counted(lambda: exe.run(
        main, feed=train_batch(PARITY_BS, PARITY_SEQ), fetch_list=[loss],
        verify=True))
    check_launches("verify_train_step", launches, per_step_want())
    if not np.isfinite(lval).all():
        raise AssertionError(f"verified step's loss {lval}")
    with tempfile.TemporaryDirectory() as tmp:
        fluid.io.save_inference_model(tmp, ["tokens", "targets"], [loss], exe,
                                      main_program=main)
        t0 = time.monotonic()
        lint = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "lint", tmp],
            capture_output=True, text=True, timeout=300)
        lint_s = time.monotonic() - t0
    if lint.returncode != 0:
        raise AssertionError(f"lint exited {lint.returncode}: "
                             f"{lint.stdout}{lint.stderr}")
    res = {"ops": report.stats["ops"], "errors": len(report.errors),
           "warnings": len(report.warnings), "findings": len(report),
           "verify_s": verify_s, "loss": float(lval[0]),
           "launches": launches, "lint_rc": lint.returncode,
           "lint_last_line": lint.stdout.strip().splitlines()[-1],
           "lint_s": lint_s}
    log("verify_lint", res)
    fluid.reset()
    return res


def loop_parity_phase():
    """``analysis.equivalence.loop_parity_report`` on the card: each K > 1
    case's fused side replays a captured graph, bitwise equal to the
    sequential steps."""
    from paddle_tpu_torch.analysis import equivalence

    fluid.reset()
    t0 = time.monotonic()
    rep = equivalence.loop_parity_report(ks=(1, 2, 4), batch_size=4)
    secs = time.monotonic() - t0
    if rep["verdict"] != "PROVEN":
        raise AssertionError(f"loop parity: {rep['findings'][:3]}")
    if any(c["replayed"] != (c["k"] > 1) for c in rep["cases"]):
        raise AssertionError(f"loop parity replayed {rep['cases']}")
    res = {"verdict": rep["verdict"], "device": rep["device"],
           "cases": [{k: c[k] for k in ("model", "k", "dispatches",
                                        "replayed", "bitwise")}
                     for c in rep["cases"]], "seconds": secs}
    log("loop_parity", res)
    fluid.reset()
    return res


def router_phase(card_name, smi):
    from paddle_tpu_torch.analysis import cost as acost

    overhead = dispatch_overhead_s()
    log("dispatch_overhead", {
        "card": card_name, "nvidia_smi": smi, "measured_s": overhead,
        "cost_model_s": acost.DEFAULT_DISPATCH_OVERHEAD_S["h100-sxm"]})
    serve_rows = router_serve_phase(card_name, smi)
    checks = verify_lint_phase()
    parity = loop_parity_phase()
    fluid.reset()
    torch.cuda.empty_cache()
    return {"card": card_name, "nvidia_smi": smi,
            "dispatch_overhead_s": overhead, **serve_rows,
            "verify_lint": checks, "loop_parity": parity}


# -- 39. the measurement tier -------------------------------------------------

MEASURE_STEPS = 3  # profiled GPT steps
FLASH_FAMILIES = {"flash_fwd": "K4", "flash_dq": "K5", "flash_dkv": "K6"}


def _flash_family(kernel_name):
    return next((k for f, k in FLASH_FAMILIES.items() if f in kernel_name),
                None)


def attribution_step_phase(card_name, smi, captured_step_ms=None):
    """(a)-(c) of 39 on the full-width bf16 GPT training step."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.analysis import cost as acost

    card = fluid.CUDAPlace(0)
    loss, main, startup = train_program(TRAIN_SEQ, "bfloat16")
    exe = fluid.Executor(card)
    exe.run(startup)
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    run_steps(exe, main, loss, feed, 2)
    block = main.global_block()

    # (a) the profile capture, 3 eager steps
    with tempfile.TemporaryDirectory() as tmp:
        (cap, launches) = counted(lambda: obs.attribution.capture_profile(
            lambda i: exe.run(main, feed=feed, fetch_list=[loss]), tmp,
            steps=MEASURE_STEPS, place=card))
    want = {k: MEASURE_STEPS * v for k, v in per_step_want().items()}
    check_launches("attribution_capture", launches, want)
    table = obs.attribution.table_from_scopes(
        block, cap["by_scope"], batch_size=TRAIN_BS, chip="h100-sxm",
        unattributed_s=cap["unattributed_s"], mode=cap["mode"])
    obs.attribution.publish(table, "gpt_bench_bf16")
    live = texecutor.live_ops(block, [loss.name])
    rows = {r["index"] for r in table["rows"] if r["index"] >= 0}
    missing = [i for i in range(len(block.ops)) if live[i] and i not in rows]
    if missing:
        raise AssertionError(f"attribution: ops without a row: "
                             f"{[(i, block.ops[i].type) for i in missing]}")
    flash_total = {}
    for secs in (cap["unattributed_kernels"],
                 *cap["kernels_by_scope"].values()):
        for kname, t in secs.items():
            fam = _flash_family(kname)
            if fam:
                flash_total[fam] = flash_total.get(fam, 0.0) + t
    flash_in_attn = {}
    for (typ, uid), secs in cap["kernels_by_scope"].items():
        op = next(o for o in block.ops if o.type == typ
                  and int(o.attrs.get("__uid__", -1)) == uid)
        attn = (typ == "scaled_dot_product_attention"
                or op.attrs.get("__fwd_type__")
                == "scaled_dot_product_attention")
        for kname, t in secs.items():
            fam = _flash_family(kname)
            if fam and attn:
                flash_in_attn[fam] = flash_in_attn.get(fam, 0.0) + t
    if sorted(flash_total) != ["K4", "K5", "K6"] or any(
            abs(flash_in_attn.get(k, 0.0) - v) > 1e-9
            for k, v in flash_total.items()):
        raise AssertionError(f"attribution: flash kernel time outside the "
                             f"attention rows: {flash_total} vs "
                             f"{flash_in_attn}")
    if table["coverage"] < 0.95:
        raise AssertionError(f"attribution: op rows hold "
                             f"{table['coverage']:.4f} of the device time "
                             f"(unattributed: "
                             f"{cap['unattributed_kernels']})")
    walk = obs.attribution.attribute_cpu(
        main, feed, batch_size=TRAIN_BS, chip="h100-sxm", repeats=1,
        place=card)
    walk_rows = {r["index"] for r in walk["rows"]}
    if walk["mode"] != "cuda-events" or not rows <= walk_rows or \
            {i for i in walk_rows if live[i]} != rows:
        raise AssertionError(f"the segment walk's rows differ from the "
                             f"profile's: {sorted(walk_rows ^ rows)}")
    steps = MEASURE_STEPS
    top = [{"op_type": t, "count": e["count"],
            "measured_ms": e["measured_s"] / steps * 1e3,
            "predicted_ms": e["pred_time_s"] / steps * 1e3,
            "pred_over_measured": e["pred_vs_measured"],
            "share": e["measured_share"]}
           for t, e in list(table["by_type"].items())[:8]]
    attribution = {
        "card": card_name, "nvidia_smi": smi, "bs": TRAIN_BS,
        "seq": TRAIN_SEQ, "dtype": "bfloat16", "steps": steps,
        "ops": len(block.ops), "rows": table["n_ops"],
        "device_ms_per_step": cap["device_total_s"] / steps * 1e3,
        "attributed_ms_per_step": table["attributed_s"] / steps * 1e3,
        "coverage": table["coverage"],
        "unattributed_kernels": cap["unattributed_kernels"],
        "flash_ms_per_step": {k: v / steps * 1e3
                              for k, v in flash_total.items()},
        "predicted_ms_per_step": table["pred_total_s"] / steps * 1e3,
        "top_op_types": top,
        "walk_ms": walk["total_s"] * 1e3, "walk_coverage": walk["coverage"],
        "launches": launches}
    log("attribution_gpt_bf16", attribution)

    # (b) calibration from the table
    with tempfile.TemporaryDirectory() as tmp:
        store = obs.calibration.CalibrationStore(tmp)
        store.record_attribution({**table, "rows": [
            {**r, "measured_s": r["measured_s"] / steps}
            for r in table["rows"]]})
        rep = acost.program_cost(main, TRAIN_BS, chip="h100-sxm",
                                 calibration=store)
    # (c) accounting: 5 tracked steps, then the measured peak
    obs.accounting.track(main, "gpt_bench_bf16", batch_size=TRAIN_BS,
                         chip="h100-sxm")
    run_steps(exe, main, loss, feed, 5)
    peak = obs.accounting.record_measured_peak(main, exe, feed=feed,
                                               fetch_list=[loss])
    (acct,) = [r for r in obs.accounting.report()
               if r["program"] == "gpt_bench_bf16"]
    gauges = obs.REGISTRY.snapshot()["families"]
    for fam in ("pred_vs_measured_step_time_ratio",
                "pred_vs_measured_peak_ratio"):
        if fam not in gauges:
            raise AssertionError(f"accounting: {fam} not published")
    if captured_step_ms is None:
        k = 4
        stacked = {n: np.stack([v] * k) for n, v in feed.items()}
        for _ in range(2):  # eager, then the capture
            exe.run(main, feed=stacked, fetch_list=[loss],
                    steps_per_dispatch=k)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(3):
            exe.run(main, feed=stacked, fetch_list=[loss],
                    steps_per_dispatch=k)
        torch.cuda.synchronize()
        captured_step_ms = (time.monotonic() - t0) / (3 * k) * 1e3
    calib = {
        "raw_predicted_ms": rep["predicted_step_time_s"] * 1e3,
        "calibrated_ms": rep["calibrated_step_time_s"] * 1e3,
        "factors_applied": rep["calibration"]["factors_applied"],
        "measured_eager_ms": acct["measured_step_time_s"] * 1e3,
        "captured_k4_ms": captured_step_ms,
        "calibrated_over_eager": rep["calibrated_step_time_s"]
        / acct["measured_step_time_s"]}
    log("calibration_gpt_bf16", calib)
    accounting = {k: acct[k] for k in (
        "predicted_step_time_s", "measured_step_time_s", "steady_runs",
        "compile_runs", "step_time_ratio", "predicted_peak_bytes",
        "measured_peak_bytes", "peak_ratio")}
    log("accounting_gpt_bf16", accounting)
    exe.close()
    return {"attribution": attribution, "calibration": calib,
            "accounting": accounting}


def metrics_serve_phase(card_name, smi, lm, prompts):
    """(c) of 39: the 16 requests through a full-width f32 v2 engine with
    the registry and the tracer on."""
    from paddle_tpu_torch import memory as pmemory
    from paddle_tpu_torch import observability as obs

    card = fluid.CUDAPlace(0)
    obs.REGISTRY.reset()
    obs.TRACER.reset()
    obs.enable_tracing()
    try:
        (tokens, reqs, eng, wall), launches = counted(
            lambda: serve(lm, prompts, card, name="metrics_v2", **V2))
    finally:
        obs.disable_tracing()
    st = eng.stats()
    check_launches("metrics_v2", launches, v2_want(st))
    gauge = obs.REGISTRY.gauge("serve_counters")
    off = {k: (st[k], gauge.value(counter=k, engine="metrics_v2",
                                  scheduler="v2"))
           for k in eng.counters
           if gauge.value(counter=k, engine="metrics_v2", scheduler="v2")
           != float(st[k])}
    problems = obs.validate_snapshot(obs.REGISTRY.snapshot())
    names = [e["name"] for e in obs.TRACER.events()]
    spans = {m: names.count(m) for m in ("serve.decode", "serve.mixed_step",
                                         "serve.admit")}
    total = pmemory.total(card)
    row = {"card": card_name, "nvidia_smi": smi, "requests": len(prompts),
           "mirrored_off": off, "snapshot_problems": problems,
           "spans": spans, "decode_steps": st["decode_steps"],
           "mixed_steps": st["mixed_steps"], "launches": launches,
           "wall_s": wall, "memory_total": total,
           "mem_get_info_total": torch.cuda.mem_get_info()[1]}
    log("metrics_serve_v2", row)
    if off or problems:
        raise AssertionError(f"metrics: mirrored counters {off}, snapshot "
                             f"{problems}")
    if spans["serve.decode"] != st["decode_steps"] or \
            spans["serve.mixed_step"] != st["mixed_steps"]:
        raise AssertionError(f"metrics: spans {spans} != steps "
                             f"{st['decode_steps']}, {st['mixed_steps']}")
    if total != torch.cuda.mem_get_info()[1]:
        raise AssertionError(f"memory.total {total} is not the card's")
    return row, tokens


def tune_phase(card_name, smi, lm, prompts, page16_tokens, scope_cpu):
    """(d) of 39: tune paged_decode and bn_conv in a throwaway store."""
    from paddle_tpu_torch.autotune import integration as at_int
    from paddle_tpu_torch.autotune import knobs as at_knobs
    from paddle_tpu_torch.autotune import measure as at_measure
    from paddle_tpu_torch.autotune import tuner as at_tuner
    from paddle_tpu_torch.autotune import workloads as at_wl

    card = fluid.CUDAPlace(0)
    prev = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")
    tmp = tempfile.mkdtemp(prefix="smoke_tune_")
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = tmp
    at_int.reset()
    try:
        measurer = at_measure.TimedMeasurer(warmup=2, iters=10, repeats=3)
        paged = at_wl.PagedDecodeWorkload(N=SLOTS, nh=HEADS, dh=DIM // HEADS,
                                          max_ctx=MAX_LEN, place=card)
        rep = at_tuner.tune(paged, measurer=measurer, top_k=3)
        n = 2 + 10 * 3
        for t in rep["trials"]:
            if t["launches"] != {"paged_attention": n}:
                raise AssertionError(f"tune paged_decode: trial "
                                     f"{t['params']} launched "
                                     f"{t['launches']}")
        mock = at_measure.MockMeasurer()
        hit = at_tuner.tune(at_wl.PagedDecodeWorkload(
            N=SLOTS, nh=HEADS, dh=DIM // HEADS, max_ctx=MAX_LEN,
            place=card), measurer=mock)
        if not hit["cache_hit"] or mock.measured:
            raise AssertionError("tune paged_decode: no cache hit")
        ps = rep["winner"]["paged_attention.page_size"]
        if at_knobs.paged_page_size() != ps:
            raise AssertionError("the page-size knob misses the winner")
        eng = ServingEngine(lm, max_batch_size=SLOTS, place=card, **V2)
        if eng.page_size != ps:
            raise AssertionError(f"engine page size {eng.page_size} != "
                                 f"winner {ps}")
        rids = [eng.submit(p, MAX_NEW) for p in prompts]
        fin = eng.run()
        tuned_tokens = [fin[r].generated for r in rids]
        leak_free(eng)
        agreed = agree("tuned_page_vs_page16", lm, scope_cpu, prompts,
                       page16_tokens, tuned_tokens, page_size=ps)
        paged_row = {
            "shape": {"N": SLOTS, "nh": HEADS, "dh": DIM // HEADS,
                      "max_ctx": MAX_LEN, "dtype": "float32"},
            "winner_page_size": ps, "cache_hit": True,
            "trials": [{"page_size": t["params"][
                "paged_attention.page_size"], "best_ms": t["best_s"] * 1e3,
                "median_ms": t["median_s"] * 1e3,
                "predicted_ms": t["predicted_step_s"] * 1e3}
                for t in rep["trials"]],
            "rejected": [r["reject_reason"] for r in rep["rejected"]],
            "engine_identical": agreed["identical"], "of": agreed["of"]}
        log("tune_paged_decode", paged_row)

        bn = at_wl.BnConvWorkload(N=128, H=28, W=28, K=128, O=128,
                                  dtype="bfloat16", place=card)
        rep = at_tuner.tune(bn, measurer=measurer, measure_all=True)
        kern = {"v1": "bn_conv3x3_fwd", "v2": "bn_conv3x3_fwd_v2",
                "reference": None}
        for t in rep["trials"]:
            k = kern[t["params"]["bn_conv.variant"]]
            want = {kk: (n if kk == k else 0) for kk in t["launches"]}
            if t["launches"] != want:
                raise AssertionError(f"tune bn_conv: trial {t['params']} "
                                     f"launched {t['launches']}")
        mock = at_measure.MockMeasurer()
        if not at_tuner.tune(at_wl.BnConvWorkload(
                N=128, H=28, W=28, K=128, O=128, dtype="bfloat16",
                place=card), measurer=mock)["cache_hit"] or mock.measured:
            raise AssertionError("tune bn_conv: no cache hit")
        variant = rep["winner"]["bn_conv.variant"]
        if at_knobs.bnconv_variant() != variant:
            raise AssertionError("the bn-conv knob misses the winner")
        runner = bn.build_runner(bn.space().default())  # no trial: knobs
        _, after = counted(runner.step)
        k = kern[variant]
        if any(v != (1 if n_ == k else 0) for n_, v in after.items()
               if n_.startswith("bn_conv3x3_fwd")):
            raise AssertionError(f"the tuned forward launched {after}")
        bn_row = {
            "shape": {"N": 128, "H": 28, "W": 28, "K": 128, "O": 128,
                      "dtype": "bfloat16"},
            "winner": rep["winner"], "cache_hit": True,
            "trials": [{"variant": t["params"]["bn_conv.variant"],
                        "block_o": t["params"]["bn_conv.block_o"],
                        "best_ms": t["best_s"] * 1e3,
                        "median_ms": t["median_s"] * 1e3,
                        "predicted_ms": t["predicted_step_s"] * 1e3,
                        "launches": t["launches"]} for t in rep["trials"]]}
        log("tune_bn_conv", bn_row)
    finally:
        if prev is None:
            os.environ.pop("PADDLE_TPU_AUTOTUNE_CACHE", None)
        else:
            os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = prev
        at_int.reset()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return {"card": card_name, "nvidia_smi": smi, "paged_decode": paged_row,
            "bn_conv": bn_row}


def cli_phase(tmpdir):
    """(e) of 39: the four subcommands in parallel processes."""
    model = os.path.join(tmpdir, "gpt_forward")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main = fluid.default_main_program()
    block = main.global_block()
    # the tower's last op, the head's product, writes the logits
    (logits,) = block.ops[-1].output_names()
    fluid.io.save_inference_model(model, ["tokens"], [block.var(logits)],
                                  exe, main)
    py = [sys.executable, "-m", "paddle_tpu_torch"]
    cmds = {
        "metrics": py + ["metrics", model, "--steps", "3", "--json"],
        "trace": py + ["trace", model, "--steps", "3", "--out",
                       os.path.join(tmpdir, "t.json")],
        "attribute": py + ["attribute", model, "--repeats", "1", "--json",
                           "--profile", os.path.join(tmpdir, "prof"),
                           "--steps", "2"],
        "tune_smoke": py + ["tune", "paged_decode", "--smoke"]}
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, pr in procs.items():
            so, se = pr.communicate(timeout=300)
            lines = so.strip().splitlines()
            out[k] = {"rc": pr.returncode,
                      "last": lines[-1] if lines else ""}
            if pr.returncode:
                raise AssertionError(f"paddle_tpu_torch {k}: exit "
                                     f"{pr.returncode}\n{se[-2000:]}")
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    attr = json.loads(out["attribute"]["last"])
    res = {k: v["rc"] for k, v in out.items()}
    res["trace"] = out["trace"]["last"]
    res["attribute_mode"] = attr["mode"]
    res["attribute_coverage"] = attr["value"]
    res["attribute_profile_coverage"] = attr["profile_coverage"]
    res["attribute_top_op"] = attr["top_op"]
    log("measurement_cli", res)
    return res


def measurement_phase(card_name, smi, captured_step_ms=None):
    t0 = time.monotonic()
    fluid.reset()
    torch.cuda.empty_cache()
    step = attribution_step_phase(card_name, smi, captured_step_ms)
    fluid.reset()
    torch.cuda.empty_cache()
    card = fluid.CUDAPlace(0)
    lm = gpt_bench.build(card, seed=SEED)
    scope = fluid.global_scope()
    scope_cpu = cpu_scope(lm, [scope.find_np(p.name) for p in lm._params])
    prompts = gpt_bench.prompts(N_REQ, seed=SEED)
    serve(lm, prompts, card, **V2)  # warm-up
    serve_row_, page16 = metrics_serve_phase(card_name, smi, lm, prompts)
    tuned = tune_phase(card_name, smi, lm, prompts, page16, scope_cpu)
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_phase(tmp)
    fluid.reset()
    torch.cuda.empty_cache()
    res = {**step, "serve_v2": serve_row_, "tune": tuned, "cli": cli,
           "phase_s": time.monotonic() - t0}
    log("measurement_phase", {"phase_s": res["phase_s"]})
    return res


# -- 40. SPMD over a device mesh ----------------------------------------------

# (a) the ring kernels at the GPT bench's attention shape, global
RING_SHAPE = (TRAIN_BS, HEADS, TRAIN_SEQ, DIM // HEADS)  # [8, 8, 1024, 64]
RING_S = (2, 4, 8)
RING_SCHEDULES = ("flash", "zigzag", "ulysses")
# (b) the flagship dp x sp step: GPT bench widths, eight positions of
# cuda:0, 2 warm-up + MESH_TIMED held steps
MESH_AXES = {"dp": 4, "sp": 2}
MESH_TIMED = 5
# (c) f32 modes on the card against an explicit-CPU ParallelExecutor
MESH_PARITY_MODES = ("dp", "sp_ring", "ep_dp")


class _PlainFlash:
    """The kernels' plain versions in their places, for the ring held to
    itself on them (``plain_ring``)."""

    flash_attention_fwd = staticmethod(fa.flash_attention_fwd_ref)
    flash_attention_bwd = staticmethod(fa.flash_attention_bwd_ref)

    class FlashAttentionTrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            out, lse = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            return (*fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                ctx.causal, ctx.scale),
                    None, None)


class plain_ring:
    """Within: the ring module calls the plain versions on CUDA tensors
    (the port's wrappers launch the kernels there)."""

    def __enter__(self):
        self.saved, tra.fa = tra.fa, _PlainFlash

    def __exit__(self, *exc):
        tra.fa = self.saved


def ring_want(schedule, S):
    """K4, K5, K6 launches of one training call of a schedule over S
    positions: a block a hop (flash: S; zigzag: 2S + 1) or one full
    attention (Ulysses) a position, forward and backward."""
    per = {"flash": S, "zigzag": 2 * S + 1, "ulysses": 1}[schedule] * S
    return {"flash_attention_fwd": per, "flash_attention_dq": per,
            "flash_attention_dkv": per}


def ring_call(schedule, mesh, q, k, v, do):
    """One training call: (out, dq, dk, dv) at the global shape."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if schedule == "ulysses":
        out = tra.ulysses_attention(*leaves, mesh, causal=True,
                                    use_flash=True, is_train=True)
    else:
        out = tra.ring_attention(*leaves, mesh, causal=True, use_flash=True,
                                 is_train=True, schedule=schedule
                                 if schedule == "zigzag" else "plain")
    return (out.detach(), *torch.autograd.grad(out, leaves, do))


def ring_kernel_phase(dev):
    """(a) Each schedule at S = 2, 4, 8, bf16 and f32, on the card: held
    to the same schedule on the plain versions (out absolute, gradients
    relative to their max |g|, at TOL), the launches the library counted
    held to the schedule's, and the call timed beside the plain one."""
    B, H, T, D = RING_SHAPE
    rows = []
    for dtype in DTYPES:
        g = torch.Generator(device=dev).manual_seed(SEED + 40)
        q, k, v, do = (torch.randn(B, H, T, D, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        for S in RING_S:
            mesh = pmesh.make_mesh({"sp": S}, devices=[dev] * S)
            for sched in RING_SCHEDULES:
                got, launches = counted(
                    lambda: ring_call(sched, mesh, q, k, v, do))
                torch.cuda.synchronize()
                tag = f"ring_{sched}_S{S}_{str(dtype).split('.')[1]}"
                check_launches(tag, launches, ring_want(sched, S))
                with plain_ring():
                    ref = ring_call(sched, mesh, q, k, v, do)
                    torch.cuda.synchronize()
                    plain_ms = time_ms(
                        lambda: ring_call(sched, mesh, q, k, v, do),
                        iters=2, ahead=False)
                kernel_ms = time_ms(
                    lambda: ring_call(sched, mesh, q, k, v, do), iters=3,
                    ahead=False)
                pairs = B * H * T * (T + 1) // 2
                nbytes = (8 * B * H * T * D * q.element_size()
                          + 2 * B * H * T * 4)
                b_ms, b_by, extra = flash_bound(
                    "flash_attention_fwd", nbytes, 18 * D * pairs, dtype)
                row = {"schedule": sched, "S": S,
                       "dtype": str(dtype).split(".")[1],
                       "shape": list(RING_SHAPE), "causal": True,
                       "max_abs_err": max_err(got[0], ref[0]),
                       "grad_max_rel_err": max(
                           rel_err(a, b) for a, b in zip(got[1:], ref[1:])),
                       "launches": {k: launches[k] for k in (
                           "flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv")},
                       "kernel_ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, **extra,
                       "timed_is": "forward + backward, host-issued"}
                log("ring_kernel", row)
                if (row["max_abs_err"] > TOL[dtype]
                        or row["grad_max_rel_err"] > TOL[dtype]):
                    raise AssertionError(
                        f"{tag}: the ring on the kernels disagrees with the "
                        f"ring on the plain versions: {row}")
                rows.append(row)
    return rows


def mesh_lm_program(dtype):
    """The bench GPT (``build_lm_train_program`` at bench.py's width,
    ring attention, zigzag) in fresh default programs."""
    fluid.reset()
    loss = transformer.build_lm_train_program(
        seq_len=TRAIN_SEQ, vocab_size=VOCAB, dim=DIM, n_layers=LAYERS,
        n_heads=HEADS, dtype=dtype, learning_rate=3e-4)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def global_state(scope, names):
    """The scope's values of `names` as whole tensors on the card (a
    sharded value gathered), cloned."""
    out = {}
    for n in names:
        v = scope.find(n)
        out[n] = (v.gather() if getattr(v, "__sharded__", False)
                  else v).detach().clone()
    return out


def into_scope(scope, state, dtypes=None):
    for n, t in state.items():
        scope.set(n, t.to(dtypes[n]) if dtypes else t.clone())


def all_rel(state, witness):
    """The distance of a state from its witness as one vector: the norm
    of the difference of all its tensors over the witness's norm, in
    float64."""
    num = den = 0.0
    for n, w in witness.items():
        w = w.double()
        num += (state[n].double() - w).pow(2).sum().item()
        den += w.pow(2).sum().item()
    return (num / max(den, 1e-300)) ** 0.5


def mesh_launch_want(S, P=None):
    """K4, K5, K6 a step of the dp x sp GPT over P positions (all of
    MESH_AXES by default): each layer's attention is a zigzag ring of
    2S + 1 blocks a position, run by the forward op and again by its
    gradient op (which then runs the blocks' K5 and K6)."""
    P = MESH_AXES["dp"] * S if P is None else P
    per = (2 * S + 1) * P * LAYERS
    return {"flash_attention_fwd": 2 * per, "flash_attention_dq": per,
            "flash_attention_dkv": per}


def profile_steps(run, n, bodies):
    """`n` calls of `run` under torch.profiler: the device busy share of
    their wall, device ms a step, and the device ms a step of each body
    (a name substring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans, us = [], dict.fromkeys(bodies, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for key, body in bodies.items():
            if body in e.name:
                us[key] += e.time_range.elapsed_us()
    if not spans:
        return {"profiled": "not measured: the profiler saw no device "
                            "event"}
    busy = merged_us(spans)
    return {"profiled_steps": n, "device_ms_per_step": busy / 1e3 / n,
            "device_busy_share": busy / wall_us,
            "wall_ms_profiled_per_step": wall_us / 1e3 / n,
            "device_kernels_per_step": len(spans) / n,
            **{f"{k}_device_ms_per_step": v / 1e3 / n
               for k, v in us.items()}}


def mesh_gpt_phase(dev, card_name, smi):
    """(b) lm_dp_sp at the GPT bench widths: ``build_lm_train_program``
    (dim 512, 8 layers, 8 heads, vocab 32000, bf16) at global batch 8 x
    1024 over {"dp": 4, "sp": 2} on eight positions of cuda:0, zigzag.
    2 warm-up + 5 steps, each held to the single-card Executor's step
    from the same state against a float32 witness step from that state
    (the same program built in f32, its state cast back to the bf16
    program's dtypes): per step, the mesh step's loss within
    SPREAD_FACTOR x the single-card bf16 losses' largest distance from
    their witnesses over the held steps, and its whole state (every
    persistable as one vector) within SPREAD_FACTOR x the single-card
    step's distance from the witness — the mesh step as close to the
    exact step as the single card's.  The single-card runs are bitwise
    from one state (a sorted embedding backward), so their eager spread
    is zero; the witness is the spread of the one thing both steps
    share, bf16 rounding.  Per-tensor distances are logged beside
    (``spread_of`` the two single-card runs): Adam's first steps turn a
    near-zero gradient's rounding into a full step of its sign, so one
    tensor's distance is a count of such flips, not a bound.  Timed: ms a step (synchronized), peak memory, launches a
    step (K4, K5, K6 at ``mesh_launch_want``, counted over the mesh steps
    only), reshards and collectives a step; profiled: device ms a step and
    busy share; the single card's figures beside them."""
    t0 = time.monotonic()
    loss_f, main_f, _ = mesh_lm_program("float32")
    loss, main, startup = mesh_lm_program("bfloat16")
    names = persistables(main)
    single = fluid.Executor(fluid.CUDAPlace(0))
    s_single = fluid.Scope()
    single.run(startup, scope=s_single)
    dtypes = {n: s_single.find(n).dtype for n in names}
    mesh = pmesh.make_mesh(MESH_AXES, devices=[dev] * 8)
    pe = pmesh_exe.ParallelExecutor(mesh=mesh)
    s_mesh = fluid.Scope()
    into_scope(s_mesh, global_state(s_single, names))
    witness = fluid.Executor(fluid.CUDAPlace(0))
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    warm = [float(pe.run(main, feed=feed, fetch_list=[loss],
                         scope=s_mesh)[0][0]) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held, per_step, step_ms, spreads = [], [], [], []
    launches = {k: 0 for k in KERNELS}
    for i in range(MESH_TIMED):
        start = global_state(s_mesh, names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: f.launches for k, f in KERNELS.items()}
        t1 = time.monotonic()
        lm = float(pe.run(main, feed=feed, fetch_list=[loss],
                          scope=s_mesh)[0][0])
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t1) * 1e3)
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        check_launches("mesh_gpt_step", got, mesh_launch_want(
            MESH_AXES["sp"]))
        for k in launches:
            launches[k] += got[k]
        per_step.append({"reshards": pe.last_step["reshards"],
                         "collectives": pe.comm_summary(),
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9})
        m_state = global_state(s_mesh, names)
        sa = fluid.Scope()
        into_scope(sa, start)
        la = float(single.run(main, feed=feed, fetch_list=[loss],
                              scope=sa)[0][0])
        a_state = global_state(sa, names)
        sr = fluid.Scope()
        into_scope(sr, start, {n: torch.float32 if dtypes[n] ==
                               torch.bfloat16 else dtypes[n]
                               for n in names})
        lr_ = float(witness.run(main_f, feed=feed, fetch_list=[loss_f],
                                scope=sr)[0][0])
        r_state = {n: t.to(dtypes[n]) for n, t in
                   global_state(sr, names).items()}
        del sa, sr
        spreads.append({**spread_of([([la], a_state), ([lr_], r_state)]),
                        "state_all_rel": all_rel(a_state, r_state)})
        held.append((i, lm, la, lr_, distance([lm], m_state, [lr_],
                                              r_state),
                     all_rel(m_state, r_state)))
        del start, m_state, a_state, r_state
    loss_spread = max(s["loss_rel"] for s in spreads)
    holds = []
    for (i, lm, la, lr_, got, g_all), spread in zip(held, spreads):
        bound = {"loss": SPREAD_FACTOR * loss_spread,
                 "state": SPREAD_FACTOR * spread["state_all_rel"]}
        row = {"step": i, "loss_rel": got["loss_rel"],
               "state_all_rel": g_all, "bound": bound,
               "single_loss_rel": spread["loss_rel"],
               "single_state_all_rel": spread["state_all_rel"],
               "worst_tensor": got["worst"], "worst_tensor_rel":
               got["state_rel"], "single_worst_tensor_rel":
               spread["state_rel"],
               "share_of_bound": {"loss": got["loss_rel"] / bound["loss"],
                                  "state": g_all / bound["state"]}}
        holds.append(row)
        if got["loss_rel"] > bound["loss"] or g_all > bound["state"]:
            raise AssertionError(
                f"mesh_gpt: mesh step {i} is farther from its float32 "
                f"witness than {SPREAD_FACTOR} x the single card's bf16 "
                f"step: {row}")
    prof = profile_steps(lambda: pe.run(main, feed=feed, fetch_list=[loss],
                                        scope=s_mesh), 2, FLASH_BF16_BODIES)
    # the single card's own figures, from the mesh's final state
    s1 = fluid.Scope()
    into_scope(s1, global_state(s_mesh, names))
    run_steps(single, main, loss, feed, 2, scope=s1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.monotonic()
    single_steps = run_steps(single, main, loss, feed, MESH_TIMED, scope=s1)
    torch.cuda.synchronize()
    single_ms = (time.monotonic() - t1) / MESH_TIMED * 1e3
    single_row = {"step_ms": single_ms,
                  "tok_s": TRAIN_BS * TRAIN_SEQ / (single_ms / 1e3),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches_per_step": single_steps[-1][2],
                  **profile_steps(lambda: single.run(
                      main, feed=feed, fetch_list=[loss], scope=s1), 2,
                      FLASH_BF16_BODIES)}
    losses = warm + [h[1] for h in held]
    res = {"card": card_name, "nvidia_smi": smi, "mesh": MESH_AXES,
           "positions": "8 on cuda:0", "bs": TRAIN_BS, "seq": TRAIN_SEQ,
           "dtype": "bfloat16", "lr": 3e-4, "schedule": "zigzag",
           "losses": losses,
           "single_losses": [h[2] for h in held],
           "witness_f32_losses": [h[3] for h in held],
           "held": holds, "loss_spread": loss_spread,
           "step_ms": float(np.median(step_ms)), "step_ms_each": step_ms,
           "tok_s": TRAIN_BS * TRAIN_SEQ / (float(np.median(step_ms))
                                             / 1e3),
           "peak_mem_gb": max(s["peak_mem_gb"] for s in per_step),
           "peak_mem_is": "the mesh step's, the step's start state "
                          "snapshot (one copy of the persistables) "
                          "included",
           "launches": launches,
           "launches_per_step": {k: v / MESH_TIMED
                                 for k, v in launches.items()},
           "reshards_per_step": per_step[-1]["reshards"],
           "collectives_per_step": per_step[-1]["collectives"],
           **prof, "single_card": single_row,
           "link_time": "none: the eight positions share one card, so a "
                        "hop or a psum is a re-index or an add in its "
                        "memory",
           "phase_s": time.monotonic() - t0}
    log("mesh_gpt", res)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"mesh_gpt: losses {losses} are not finite or "
                             f"did not fall")
    return res


def mesh_parity_phase(dev):
    """(c) f32 dp, sp_ring and ep_dp: three steps of the mode on eight
    positions of the card against an explicit-CPU ParallelExecutor from
    the same state and feeds: losses within 1e-4 relative, the written
    state within 1e-3 of each tensor's max |value| (parity_run's bars);
    sp_ring launches K4-K6 at its ring's count, dp and ep_dp none."""
    out = {}
    for name in MESH_PARITY_MODES:
        mode, main, lossname = pmodes.build_mode(name)
        startup = fluid.default_startup_program()
        startup.random_seed = SEED
        s_cpu, s_card = fluid.Scope(), fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=s_cpu)
        names = persistables(main)
        for n in names:
            s_card.set(n, s_cpu.find(n).clone())
        cpu_pe = pmesh_exe.ParallelExecutor(mesh=pmesh.make_mesh(
            mode.mesh_axes, devices=[torch.device("cpu")] * 8),
            **mode.executor_kwargs)
        card_pe = pmesh_exe.ParallelExecutor(mesh=pmesh.make_mesh(
            mode.mesh_axes, devices=[dev] * 8), **mode.executor_kwargs)
        rng = np.random.RandomState(SEED)
        feeds = [mode.feed_fn(rng, 8) for _ in range(3)]
        lc, lg, per = [], [], []
        for f in feeds:
            lc.append(float(np.asarray(cpu_pe.run(
                main, feed=f, fetch_list=[lossname], scope=s_cpu)[0])[0]))
            before = {k: fn.launches for k, fn in KERNELS.items()}
            lg.append(float(np.asarray(card_pe.run(
                main, feed=f, fetch_list=[lossname], scope=s_card)[0])[0]))
            per.append({k: fn.launches - before[k]
                        for k, fn in KERNELS.items()})
        for launches in per:
            if name == "sp_ring":
                S = mode.mesh_axes["sp"]
                P = 8
                want = {"flash_attention_fwd": 2 * S * P,
                        "flash_attention_dq": S * P,
                        "flash_attention_dkv": S * P}
                check_launches(f"mesh_parity_{name}", launches, want)
            else:
                no_launches(f"mesh_parity_{name}", launches)
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(lg, lc)]
        state_rel = {}
        for n in names:
            a = s_card.find_np(n).astype(np.float64)
            b = s_cpu.find_np(n).astype(np.float64)
            state_rel[n] = float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-12))
        row = {"mode": name, "mesh": dict(mode.mesh_axes),
               "card_losses": lg, "cpu_losses": lc, "loss_rel_err": loss_rel,
               "state_rel_err_max": max(state_rel.values()),
               "launches_per_step": per[-1],
               "collectives_per_step": card_pe.comm_summary()}
        log("mesh_parity", row)
        if max(loss_rel) > 1e-4 or row["state_rel_err_max"] > 1e-3:
            worst = sorted(state_rel.items(), key=lambda kv: -kv[1])[:3]
            raise AssertionError(f"mesh_parity {name}: card and CPU "
                                 f"disagree: {row}, worst state {worst}")
        out[name] = row
    return out


def mesh_loop_phase(dev):
    """(d) ``run(steps_per_dispatch=2)`` of f32 ``sp_ring`` on eight
    positions of the card: the first dispatch eager, the second captures
    its two steps as one CUDA graph and replays it, the third replays; each
    dispatch's losses and the written state held to the bit to two run()
    calls of another executor from the same state (the same kernels in the
    same order), the graph launching nothing at its replays."""
    mode, main, lossname = pmodes.build_mode("sp_ring")
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    names = persistables(main)
    sa, sb = fluid.Scope(), fluid.Scope()

    def exe():
        return pmesh_exe.ParallelExecutor(mesh=pmesh.make_mesh(
            mode.mesh_axes, devices=[dev] * 8))

    seq, fused = exe(), exe()
    seq.run(startup, scope=sa)
    for n in names:
        sb.set(n, sa.find(n).clone())
    rng = np.random.RandomState(SEED)
    rows = []
    for d in range(3):
        feeds = [mode.feed_fn(rng, 8) for _ in range(2)]
        want = [float(np.asarray(seq.run(main, feed=f, fetch_list=[lossname],
                                         scope=sa)[0])[0]) for f in feeds]
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got, launches = counted(lambda: [float(v) for v in np.asarray(
            fused.run(main, feed=stacked, fetch_list=[lossname], scope=sb,
                      steps_per_dispatch=2)[0]).reshape(-1)])
        torch.cuda.synchronize()
        differ = [n for n in names
                  if not np.array_equal(sa.find_np(n), sb.find_np(n))]
        captured = any(e.loop is not None for e in fused._loops.values())
        rows.append({"dispatch": d, "losses": got, "sequential": want,
                     "bitwise": got == want and not differ,
                     "state_differs": differ[:5], "captured": captured,
                     "launches": {k: v for k, v in launches.items() if v}})
        if got != want or differ:
            raise AssertionError(f"mesh_loop: dispatch {d} parts from two "
                                 f"run() calls: {rows[-1]}")
        if d == 2 and any(launches.values()):
            raise AssertionError(f"mesh_loop: a replay launched "
                                 f"{launches}")
    if dev.type == "cuda" and not rows[-1]["captured"]:
        raise AssertionError("mesh_loop: no dispatch was captured")
    log("mesh_loop", {"rows": rows})
    return rows


def parallel_phase(dev, card_name, smi):
    """Phase 40: (a) ``ring_kernel_phase``, (b) ``mesh_gpt_phase``, (c)
    ``mesh_parity_phase``, (d) ``mesh_loop_phase``."""
    t0 = time.monotonic()
    fluid.reset()
    torch.cuda.empty_cache()
    ring = ring_kernel_phase(dev)
    torch.cuda.empty_cache()
    gpt = mesh_gpt_phase(dev, card_name, smi)
    fluid.reset()
    torch.cuda.empty_cache()
    parity = mesh_parity_phase(dev)
    fluid.reset()
    loop = mesh_loop_phase(dev)
    fluid.reset()
    torch.cuda.empty_cache()
    res = {"ring": ring, "lm_dp_sp": gpt, "parity_f32": parity,
           "loop_k2": loop, "phase_s": time.monotonic() - t0}
    log("parallel_phase", {"phase_s": res["phase_s"]})
    return res


# -- 41. the pipeline executors and the host services --------------------------

# (a) the bench GPT staged every two blocks (4 stages), pipelined on
# positions of cuda:0 with SGD, 2 warm-up + PIPE_TIMED held steps a layout
PIPE_LAYOUTS = (({"pp": 4}, 4), ({"pp": 2, "dp": 2}, 2))
PIPE_LR = 0.05
PIPE_TIMED = 10
# (b) the bench GPT in f32 through two loopback pservers with HostAdam
PS_STEPS = 3
# (c) the host services on the card
HOST_EMB = {"vocab": 1000, "dim": 8, "bs": 32, "steps": 60}
MOE_SMALL = {"ep": 4, "dp": 2, "d": 8, "h": 16, "capacity": 16}


def pipe_lm_program(dtype, sgd, stages=4):
    """The bench GPT (``decoder_lm`` at bench.py's widths cut into
    `stages` stages by ``pipeline_stage`` markers — after every two blocks
    for 4 — and ``lm_loss``) in fresh default programs; with `sgd` the SGD
    step the single card runs (the markers are no-ops there).  The
    markers make no variables: every stage count names the same
    parameters."""
    fluid.reset()
    tok = fluid.layers.data("tokens", shape=[TRAIN_SEQ, 1], dtype="int64")
    tgt = fluid.layers.data("targets", shape=[TRAIN_SEQ, 1], dtype="int64")
    logits = transformer.decoder_lm(tok, VOCAB, DIM, LAYERS, HEADS,
                                    max_len=TRAIN_SEQ, dtype=dtype,
                                    stage_every=LAYERS // stages)
    loss = transformer.lm_loss(logits, tgt, dtype=dtype)
    if sgd:
        fluid.optimizer.SGD(learning_rate=PIPE_LR).minimize(loss)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    return loss, fluid.default_main_program(), startup


def pipe_launch_want(axes, n_micro):
    """K4, K5, K6 a pipelined step: each (stage, dp) position runs its
    LAYERS / pp layers on each of its n_micro microbatches, one K4 a
    layer forward and one K5 and one K6 in its backward."""
    per = LAYERS * n_micro * axes.get("dp", 1)
    return {"flash_attention_fwd": per, "flash_attention_dq": per,
            "flash_attention_dkv": per}


def update_rel(after, start, witness):
    """The distance of a step's parameter update from the witness step's:
    the norm of the difference of the two updates (after - start, all
    tensors as one vector) over the norm of the witness's, in float64."""
    num = den = 0.0
    for n, s0 in start.items():
        s0 = s0.double()
        w = witness[n].double() - s0
        num += (after[n].double() - s0 - w).pow(2).sum().item()
        den += w.pow(2).sum().item()
    return (num / max(den, 1e-300)) ** 0.5


def pipe_layout_run(dev, axes, n_micro, progs, names, start, extras):
    """One layout: 2 warm-up steps from `start`, then PIPE_TIMED steps,
    each from the bf16 state the last one ended in (the pipeline
    re-packed from it, as the single card holds its parameters), held to
    the single-card SGD step and an f32 witness step from that state
    (`extras`: the SGD programs' own persistables, the learning rate):
    the pipelined loss within SPREAD_FACTOR x the largest single-card
    loss distance from its witness over the held steps, and its update
    (the float32 rows after the step less the start) within
    SPREAD_FACTOR x the single card's update distance from the
    witness's.  Both updates are float32 (the rows are; the SGD op
    promotes a bf16 parameter to float32), so the distance is the bf16
    forward and backward's."""
    from paddle_tpu_torch.parallel.program_pipeline import ProgramPipeline

    (loss_s, main_s), (loss_f, main_f) = progs
    loss_p, main_p, _ = pipe_lm_program("bfloat16", False, axes["pp"])
    mesh = pmesh.make_mesh(axes, devices=[dev] * int(np.prod(list(
        axes.values()))))
    s_pipe = fluid.Scope()
    into_scope(s_pipe, start)
    pipe = ProgramPipeline(main_p, loss_p, mesh, n_micro=n_micro,
                           optimizer=("sgd", PIPE_LR), scope=s_pipe)
    pipe.initialize()
    single = fluid.Executor(fluid.CUDAPlace(0))
    witness = fluid.Executor(fluid.CUDAPlace(0))
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    warm = [pipe.run(feed) for _ in range(2)]
    pipe.sync_scope()
    held, step_ms, single_ms, peaks, single_peaks = [], [], [], [], []
    launches = {k: 0 for k in KERNELS}
    comm = None
    for i in range(PIPE_TIMED):
        state = {n: s_pipe.find(n).detach().clone() for n in names}
        pipe.initialize()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: f.launches for k, f in KERNELS.items()}
        with pcol.record() as log_:
            t1 = time.monotonic()
            lp = pipe.run(feed)
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t1) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        check_launches("pipe_gpt_step", got, pipe_launch_want(axes, n_micro))
        for k in launches:
            launches[k] += got[k]
        comm = {"hops": sum(1 for e in log_ if e[0] == "collective-permute"),
                "psums": sum(1 for e in log_ if e[0] == "all-reduce"),
                "hop_bytes": sum(e[2] for e in log_
                                 if e[0] == "collective-permute"),
                "kinds": sorted({(e[0], e[1]) for e in log_})}
        p_rows = pipe.params(cast=False)
        pipe.sync_scope()
        sa = fluid.Scope()
        into_scope(sa, {**state, **extras[0]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.monotonic()
        la = float(single.run(main_s, feed=feed, fetch_list=[loss_s],
                              scope=sa)[0][0])
        torch.cuda.synchronize()
        single_ms.append((time.monotonic() - t1) * 1e3)
        single_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        a_state = {n: sa.find(n).detach().clone() for n in names}
        sr = fluid.Scope()
        into_scope(sr, state, {n: torch.float32 for n in names})
        into_scope(sr, extras[1])
        lr_ = float(witness.run(main_f, feed=feed, fetch_list=[loss_f],
                                scope=sr)[0][0])
        r_state = {n: sr.find(n).detach().clone() for n in names}
        del sa, sr
        held.append((i, lp, la, lr_, update_rel(p_rows, state, r_state),
                     update_rel(a_state, state, r_state)))
        del state, p_rows, a_state, r_state
    loss_spread = max(abs(la - lr_) / abs(lr_)
                      for _, _, la, lr_, _, _ in held)
    holds = []
    for (i, lp, la, lr_, g_upd, a_upd) in held:
        loss_rel = abs(lp - lr_) / abs(lr_)
        bound_ = {"loss": SPREAD_FACTOR * loss_spread,
                  "update": SPREAD_FACTOR * a_upd}
        row = {"step": i, "loss_rel": loss_rel, "update_rel": g_upd,
               "bound": bound_,
               "single_loss_rel": abs(la - lr_) / abs(lr_),
               "single_update_rel": a_upd,
               "share_of_bound": {"loss": loss_rel / bound_["loss"],
                                  "update": g_upd / bound_["update"]}}
        holds.append(row)
        if loss_rel > bound_["loss"] or g_upd > bound_["update"]:
            raise AssertionError(
                f"pipe_gpt {axes}: pipelined step {i} is farther from its "
                f"float32 witness than {SPREAD_FACTOR} x the single card's "
                f"bf16 step: {row}")
    pipe.initialize()
    prof = profile_steps(lambda: pipe.run(feed), 2, FLASH_BF16_BODIES)
    # the single card's SGD op writes a bf16 parameter back as float32
    # (ROADMAP.md Queue C), so each profiled step starts from the bf16
    # state again, as each held step does
    s1 = fluid.Scope()
    bf16_state = {**{n: s_pipe.find(n) for n in names}, **extras[0]}

    def single_step():
        into_scope(s1, bf16_state)
        single.run(main_s, feed=feed, fetch_list=[loss_s], scope=s1)

    single_prof = profile_steps(single_step, 2, FLASH_BF16_BODIES)
    losses = warm + [h[1] for h in held]
    med = float(np.median(step_ms))
    res = {"mesh": axes, "n_micro": n_micro,
           "positions": f"{mesh.size} on cuda:0", "bs": TRAIN_BS,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", "lr": PIPE_LR,
           "stage_ops": [len(s.ops) for s in pipe.stages],
           "losses": losses, "single_losses": [h[2] for h in held],
           "witness_f32_losses": [h[3] for h in held], "held": holds,
           "loss_spread": loss_spread, "step_ms": med,
           "step_ms_each": step_ms,
           "tok_s": TRAIN_BS * TRAIN_SEQ / (med / 1e3),
           "peak_mem_gb": max(peaks),
           "launches": launches,
           "launches_per_step": {k: v / PIPE_TIMED
                                 for k, v in launches.items() if v},
           "launches_want": pipe_launch_want(axes, n_micro),
           "ticks": n_micro + axes["pp"] - 1,
           "hops_per_step": comm["hops"], "psums_per_step": comm["psums"],
           "hop_bytes_per_step": comm["hop_bytes"],
           "collective_kinds": comm["kinds"], **prof,
           "single_card": {"step_ms": float(np.median(single_ms)),
                           "tok_s": TRAIN_BS * TRAIN_SEQ
                           / (float(np.median(single_ms)) / 1e3),
                           "peak_mem_gb": max(single_peaks),
                           "launches_per_step": per_step_want(),
                           **single_prof},
           "link_time": "none: the positions share one card, so a hop is "
                        "a re-index of its memory"}
    log("pipe_gpt", res)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"pipe_gpt {axes}: losses {losses} are not "
                             f"finite or did not fall")
    return res


def pipe_gpt_phase(dev):
    """(a) the bench GPT through ProgramPipeline over {"pp": 4} (a marker
    after every two blocks, n_micro 4) and {"pp": 2, "dp": 2} (after
    every four, n_micro 2)."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    extras = []
    for dtype in ("bfloat16", "float32"):
        loss_, main_, startup_ = pipe_lm_program(dtype, True)
        s0 = fluid.Scope()
        exe.run(startup_, scope=s0)
        extras.append((loss_, main_, s0))
    loss_p, main_p, startup = pipe_lm_program("bfloat16", False)
    names = persistables(main_p)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    start = {n: s0.find(n).detach().clone() for n in names}
    (loss_s, main_s, s_s), (loss_f, main_f, s_f) = extras
    extras = [{n: sc.find(n).detach().clone()
               for n in persistables(m) if n not in start}
              for _, m, sc in extras]
    del s0, s_s, s_f
    progs = ((loss_s, main_s), (loss_f, main_f))
    out = {}
    for axes, n_micro in PIPE_LAYOUTS:
        tag = "_".join(f"{a}{s}" for a, s in axes.items())
        out[tag] = pipe_layout_run(dev, axes, n_micro, progs, names, start,
                                   extras)
        torch.cuda.empty_cache()
    return out


def pserver_gpt_phase(dev):
    """(b) ``build_lm_train_program`` at the bench widths in f32 (Adam
    3e-4), transpiled over two loopback PServers (HostAdam), batch 8 x
    1024, PS_STEPS steps.  Held to the bit to the same transpiled program
    on one card with each step's gradients applied by the same host rule
    in this process (``pserver.make_optimizer`` on the transpiler's
    rules, no wire): the wire and the server threads change nothing.  The
    single-card Executor's Adam op from the same state is run beside it
    and its distance reported, unbounded: HostAdam (the JAX package's,
    paddle/optimizer's) adds epsilon after the bias correction, the op
    before it, so rarely-hit rows move by different steps (ROADMAP.md
    Queue C).  Each pserver step's ms is split into the device step
    (forward and backward, gradients fetched), the wire (push and pull,
    the host optimizer excluded) and the host optimizer."""
    from paddle_tpu_torch.distributed.pserver import PServer, make_optimizer

    loss, main, startup = mesh_lm_program("float32")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    s_ref = fluid.Scope()
    exe.run(startup, scope=s_ref)
    names = persistables(main)
    start = {n: s_ref.find(n).detach().clone() for n in names}
    feed = train_batch(TRAIN_BS, TRAIN_SEQ)
    op_adam = [float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=s_ref)[0][0]) for _ in range(PS_STEPS)]
    del s_ref

    def transpiled(eps):
        loss_, main_, startup_ = mesh_lm_program("float32")
        t = fluid.DistributeTranspiler().transpile(
            0, program=main_, startup_program=startup_, pservers=eps,
            trainers=1)
        scope = fluid.Scope()
        exe_ = fluid.Executor(fluid.CUDAPlace(0))
        exe_.run(startup_, scope=scope)
        into_scope(scope, start)
        return t, loss_, main_, scope, exe_

    # the same host rule in this process, no wire
    t, loss_l, main_l, scope, exe_l = transpiled("127.0.0.1:1")
    rules = {p: make_optimizer({k: v for k, v in c.items()
                                if k != "_lr_var"})
             for p, c in t.param_cfg.items()}
    gvars = t.grad_fetch_list()
    local = []
    for _ in range(PS_STEPS):
        outs = exe_l.run(main_l, feed=feed, fetch_list=[loss_l] + gvars,
                         scope=scope)
        local.append(float(np.asarray(outs[0]).reshape(-1)[0]))
        for (pname, _), g in zip(t.param_grad.items(), outs[1:]):
            scope.set(pname, rules[pname].update(scope.find_np(pname), g))
    local_state = {n: scope.find_np(n) for n in t.param_cfg}
    del scope, rules
    servers = [PServer(num_trainers=1).start() for _ in range(2)]
    opt_s = [0.0]

    def timed(fn):
        def run(*a, **k):
            t1 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                opt_s[0] += time.monotonic() - t1
        return run

    try:
        t, loss, main, scope, exe2 = transpiled(
            ",".join(s.endpoint for s in servers))
        upd = t.make_updater(scope)
        upd.init_params()
        for s in servers:
            for o in s.service._opts.values():
                o.update = timed(o.update)
        gvars = t.grad_fetch_list()
        gnames = [g.name for g in gvars]
        got, rows = [], []
        total = {k: 0 for k in KERNELS}
        for _ in range(PS_STEPS):
            before = {k: f.launches for k, f in KERNELS.items()}
            torch.cuda.synchronize()
            t1 = time.monotonic()
            outs = exe2.run(main, feed=feed, fetch_list=[loss] + gvars,
                            scope=scope)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            opt_s[0] = 0.0
            upd.step(dict(zip(gnames, outs[1:])))
            t3 = time.monotonic()
            launches = {k: f.launches - before[k] for k, f in KERNELS.items()}
            check_launches("pserver_gpt_step", launches, per_step_want())
            for k in total:
                total[k] += launches[k]
            got.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            rows.append({"step_ms": (t3 - t1) * 1e3,
                         "device_ms": (t2 - t1) * 1e3,
                         "wire_ms": (t3 - t2 - opt_s[0]) * 1e3,
                         "host_optimizer_ms": opt_s[0] * 1e3,
                         "launches": {k: v for k, v in launches.items()
                                      if v}})
        differ = [n for n in t.param_cfg if not np.array_equal(
            scope.find_np(n), local_state[n])]
        upd.close()
    finally:
        for s in servers:
            s.stop()
    nbytes = sum(int(np.prod(v.shape)) * 4 for v in start.values()
                 if v.is_floating_point())
    res = {"pservers": 2, "optimizer": "adam (HostAdam)", "dtype": "float32",
           "bs": TRAIN_BS, "seq": TRAIN_SEQ, "losses": got,
           "local_host_rule_losses": local,
           "bitwise_vs_local_host_rule": got == local and not differ,
           "params_differ": differ[:5],
           "single_card_adam_op_losses": op_adam,
           "loss_rel_vs_adam_op": [abs(a - b) / abs(b)
                                   for a, b in zip(got, op_adam)],
           "param_bytes_each_way": nbytes, "launches": total,
           "steps": rows, "step_ms": float(np.median(
               [r["step_ms"] for r in rows[1:]])),
           "device_ms": float(np.median([r["device_ms"] for r in rows[1:]])),
           "wire_ms": float(np.median([r["wire_ms"] for r in rows[1:]])),
           "host_optimizer_ms": float(np.median(
               [r["host_optimizer_ms"] for r in rows[1:]])),
           "median_of": "steps 2-3"}
    log("pserver_gpt", res)
    if not res["bitwise_vs_local_host_rule"]:
        raise AssertionError(f"pserver_gpt: the pserver path parts from the "
                             f"same host rule applied in-process: {got} "
                             f"vs {local}, params {differ[:5]}")
    return res


def host_services_phase(dev):
    """(c) the chaos worker_kill scenario with a differential proof, the
    16k-context admission demo, the CTR with a host table (card against
    an explicit-CPU run, losses 1e-4), and ``pp``, ``pp_dp`` and the
    functional MoE step on eight positions of the card against the CPU
    (losses 1e-4); none of these reaches a port kernel."""
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed.host_embedding import HostEmbedding
    from paddle_tpu_torch.distributed.pserver import ParameterServerService
    from paddle_tpu_torch.parallel.moe import (build_moe_train_step,
                                               init_moe_params)

    out = {}
    t0 = time.monotonic()
    rec, launches = counted(lambda: chaos.run_scenario(
        "worker_kill", seed=0, place=fluid.CUDAPlace(0)))
    no_launches("chaos_worker_kill", launches)
    out["chaos_worker_kill"] = {
        "all_faults_fired": rec["all_faults_fired"],
        "recoveries": len(rec["recoveries"]),
        "resumed_from": [r.get("resumed_from_step")
                         for r in rec["recoveries"]],
        "final_step": rec["final_step"], "proof": rec["proof"],
        "wall_s": time.monotonic() - t0}
    if not (rec["all_faults_fired"] and rec["recoveries"]
            and rec["proof"]["equivalent"]
            and rec["proof"]["tier"] == "differential"):
        raise AssertionError(f"chaos worker_kill on the card: "
                             f"{out['chaos_worker_kill']}")
    t0 = time.monotonic()
    demo, launches = counted(lambda: chaos.admission_demo(
        seed=0, place=fluid.CUDAPlace(0)))
    no_launches("admission_demo", launches)
    out["admission_demo"] = {
        "ok": demo["ok"], "budget_bytes": demo["budget_bytes"],
        "estimator_peak_dense": demo["estimator_peak_dense"],
        "estimator_peak_full_remat": demo["estimator_peak_full_remat"],
        "admitted_peak_bytes": demo["cert_admitted_remat"]["peak_bytes"],
        "remat": demo["cert_admitted_remat"].get("remat"),
        "rejected_reason": demo["cert_rejected_no_remat"]["reason"],
        "final_steps": demo.get("final_steps"),
        "wall_s": time.monotonic() - t0}
    if not demo["ok"]:
        raise AssertionError(f"admission_demo on the card: {demo}")

    def ctr(place, state=None):
        svc = ParameterServerService(num_trainers=1)
        table = HostEmbedding(svc, "emb_table", HOST_EMB["vocab"],
                              HOST_EMB["dim"],
                              optimizer={"type": "adagrad", "lr": 0.5})
        svc.finish_init_params()
        fluid.reset()
        emb = fluid.layers.data(name="emb", shape=[HOST_EMB["dim"]],
                                dtype="float32")
        emb.stop_gradient = False
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        cost = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(emb, size=1, act="sigmoid"), y))
        fluid.optimizer.SGD(learning_rate=0.2).minimize(cost)
        exe = fluid.Executor(place)
        exe.run(fluid.default_startup_program())
        for n, v in (state or {}).items():
            fluid.global_scope().set(n, v)
        init = {n: fluid.global_scope().find_np(n)
                for n in fluid.global_scope().local_names()}
        rng = np.random.RandomState(0)
        B, losses = HOST_EMB["bs"], []
        for _ in range(HOST_EMB["steps"]):
            ids = rng.randint(0, HOST_EMB["vocab"], size=B)
            labels = (ids % 2 == 0).astype(np.float32).reshape(B, 1)
            c, g = exe.run(feed={"emb": table.fetch(ids), "y": labels},
                           fetch_list=[cost, "emb@GRAD"])
            table.push_grad(ids, g)
            losses.append(float(np.asarray(c).ravel()[0]))
        return losses, init

    lc, init = ctr(fluid.CPUPlace())
    lg, launches = counted(lambda: ctr(fluid.CUDAPlace(0), init)[0])
    no_launches("host_table_ctr", launches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    out["host_table_ctr"] = {"card_losses": [lg[0], lg[-1]],
                             "cpu_losses": [lc[0], lc[-1]],
                             "loss_rel_err_max": rel}
    if rel > 1e-4 or not lg[-1] < lg[0] * 0.6:
        raise AssertionError(f"host_table_ctr: {out['host_table_ctr']}")

    for name in ("pp", "pp_dp"):
        runs = []
        for devices in ([torch.device("cpu")] * 8, [dev] * 8):
            mode, pipe, prog, lossname = pmodes.run_mode(name,
                                                         devices=devices)
            fluid.Executor(fluid.CPUPlace()).run(
                fluid.default_startup_program())
            rng = np.random.RandomState(SEED)
            feeds = [mode.feed_fn(rng, 16) for _ in range(3)]
            runs.append(counted(lambda: [pipe.run(f) for f in feeds]))
        no_launches(f"mode_{name}", runs[1][1])
        rel = [abs(a - b) / abs(b) for a, b in zip(runs[1][0], runs[0][0])]
        out[f"mode_{name}"] = {"card_losses": runs[1][0],
                               "cpu_losses": runs[0][0],
                               "loss_rel_err": rel}
        if max(rel) > 1e-4:
            raise AssertionError(f"mode {name}: {out[f'mode_{name}']}")
    m = MOE_SMALL
    runs = []
    for devices in ([torch.device("cpu")] * 8, [dev] * 8):
        params = init_moe_params(torch.Generator().manual_seed(SEED),
                                 m["ep"], m["d"], m["h"])
        step = build_moe_train_step(pmesh.make_mesh(
            {"ep": m["ep"], "dp": m["dp"]}, devices=devices), m["d"],
            m["h"], m["capacity"])
        rng = np.random.RandomState(1)
        x = rng.randn(32, m["d"]).astype(np.float32)
        y = (x * 2.0 + 0.5).astype(np.float32)

        def steps():
            nonlocal params
            ls = []
            for _ in range(3):
                loss_, params = step(params, x, y)
                ls.append(float(loss_))
            return ls

        runs.append(counted(steps))
    no_launches("moe_step", runs[1][1])
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[1][0], runs[0][0])]
    out["moe_step"] = {"card_losses": runs[1][0], "cpu_losses": runs[0][0],
                       "loss_rel_err": rel}
    if max(rel) > 1e-4:
        raise AssertionError(f"moe step: {out['moe_step']}")
    log("host_services", out)
    return out


def distributed_phase(dev, card_name, smi):
    """Phase 41: (a) ``pipe_gpt_phase``, (b) ``pserver_gpt_phase``, (c)
    ``host_services_phase``."""
    t0 = time.monotonic()
    fluid.reset()
    torch.cuda.empty_cache()
    pipe = pipe_gpt_phase(dev)
    fluid.reset()
    torch.cuda.empty_cache()
    ps = pserver_gpt_phase(dev)
    fluid.reset()
    torch.cuda.empty_cache()
    host = host_services_phase(dev)
    fluid.reset()
    torch.cuda.empty_cache()
    res = {"card": card_name, "nvidia_smi": smi, "pipeline": pipe,
           "pserver_gpt_f32": ps, "host_services": host,
           "phase_s": time.monotonic() - t0}
    log("distributed_phase", {"phase_s": res["phase_s"]})
    return res


# -- 42. the rest of the op library and the book chapters -----------------------

def _u(seed, *shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ids(*v, dt=np.int64):
    return np.array(v, dt)


def rest_op_cases():
    """One case of each op type of the last 48 but the two that draw and
    the two host I/O ops, at small shapes from fixed seeds, with a tie or
    a kink where the op has one: name → (op type, inputs {slot: [numpy]},
    attrs, differentiable input slots)."""
    ties = _u(4, 3, 5)
    ties[0, 1] = ties[0, 3] = 3.0
    pool = _u(5, 2, 2, 5, 5)
    pool[0, 0, 0:2, 0:2] = 2.5
    l1 = _u(6, 3, 4)
    l1[0, :2] = 0.0
    rng = np.random.RandomState(26)
    dy, dx = rng.randint(0, 2, (2, 2, 2, 2)), rng.randint(0, 2, (2, 2, 2, 2))
    unpool_idx = ((np.arange(2)[:, None] * 2 + dy) * 4
                  + np.arange(2)[None, :] * 2 + dx).astype(np.int32)
    rel = np.random.RandomState(22).randint(0, 3, (3, 6, 1)).astype(
        np.float32)
    y01 = (np.random.RandomState(38).rand(6, 1) > 0.5).astype(np.float32)
    f = np.array([[-2.0], [-0.5], [0.3], [1.5], [0.9], [-1.2]], np.float32)
    return {
        "pad": ("pad", {"X": [_u(1, 2, 3, 4)]},
                {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}, ("X",)),
        "crop": ("crop", {"X": [_u(2, 3, 5, 6)]},
                 {"offsets": [0, 1, 2], "shape": [-1, 3, 3]}, ("X",)),
        "reverse": ("reverse", {"X": [_u(3, 2, 3, 4)]}, {"axis": [0, 2]},
                    ("X",)),
        "expand": ("expand", {"X": [_u(4, 2, 3)]}, {"expand_times": [2, 3]},
                   ("X",)),
        "squeeze": ("squeeze", {"X": [_u(5, 2, 1, 3, 1)]}, {"axes": [1]},
                    ("X",)),
        "prelu": ("prelu", {"X": [_u(8, 2, 3, 4, 4)],
                            "Alpha": [_u(9, 3, lo=0.1, hi=0.5)]}, {},
                  ("X", "Alpha")),
        "maxout": ("maxout", {"X": [_u(12, 2, 6, 3, 3)]}, {"groups": 3},
                   ("X",)),
        "norm": ("norm", {"X": [_u(14, 2, 3, 4)], "Scale": [_u(15, 3)]},
                 {"axis": 1}, ("X", "Scale")),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": [_u(16, 4, 3)], "Y": [_u(17, 4, 3)]},
                                {}, ("X", "Y")),
        "smooth_l1_loss": ("smooth_l1_loss",
                           {"X": [_u(32, 4, 3)], "Y": [_u(33, 4, 3)],
                            "InsideWeight": [_u(34, 4, 3, lo=0, hi=1)],
                            "OutsideWeight": [_u(35, 4, 3, lo=0, hi=1)]},
                           {"sigma": 1.5}, ("X", "Y")),
        "huber_loss": ("huber_loss", {"X": [_u(36, 6, 1)],
                                      "Y": [_u(37, 6, 1)]},
                       {"delta": 0.8}, ("X", "Y")),
        "rank_loss": ("rank_loss", {"Label": [y01[:4]],
                                    "Left": [_u(39, 4, 1)],
                                    "Right": [_u(40, 4, 1)]}, {},
                      ("Left", "Right")),
        "arg_max": ("arg_max", {"X": [ties]}, {"axis": -1}, ()),
        "multiplex": ("multiplex", {"Ids": [_ids([2], [0], [1], [2])],
                                    "X": [_u(41, 4, 5), _u(42, 4, 5),
                                          _u(43, 4, 5)]}, {}, ("X",)),
        "hsigmoid": ("hsigmoid", {"X": [_u(23, 4, 5)], "W": [_u(24, 5, 5)],
                                  "Label": [_ids([0], [5], [2], [3])],
                                  "Bias": [_u(25, 1, 5)]},
                     {"num_classes": 6}, ("X", "W", "Bias")),
        "selective_fc": ("selective_fc",
                         {"X": [_u(44, 3, 4)], "W": [_u(45, 4, 6)],
                          "Bias": [_u(46, 6)],
                          "Mask": [(np.random.RandomState(47).rand(3, 6)
                                    > 0.5).astype(np.float32)]},
                         {}, ("X", "W", "Bias")),
        "factorization_machine": ("factorization_machine",
                                  {"Input": [_u(48, 3, 5)],
                                   "Factors": [_u(49, 5, 4)]}, {},
                                  ("Input", "Factors")),
        "bilinear_interp": ("bilinear_interp", {"X": [_u(50, 2, 2, 3, 4)]},
                            {"out_h": 5, "out_w": 7}, ("X",)),
        "bilinear_tensor_product": ("bilinear_tensor_product",
                                    {"X": [_u(52, 3, 4)],
                                     "Y": [_u(53, 3, 5)],
                                     "Weight": [_u(54, 2, 4, 5)],
                                     "Bias": [_u(55, 1, 2)]}, {},
                                    ("X", "Y", "Weight", "Bias")),
        "conv3d": ("conv3d", {"Input": [_u(56, 2, 2, 4, 5, 5)],
                              "Filter": [_u(57, 3, 2, 3, 3, 3)]},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                    "dilations": [1, 1, 2]}, ("Input", "Filter")),
        "conv3d_transpose": ("conv3d_transpose",
                             {"Input": [_u(60, 2, 3, 3, 3, 3)],
                              "Filter": [_u(61, 3, 2, 2, 3, 2)]},
                             {"strides": [2, 2, 2], "paddings": [0, 1, 0],
                              "dilations": [1, 1, 2]}, ("Input", "Filter")),
        "pool3d": ("pool3d", {"X": [_u(65, 1, 2, 4, 5, 4)]},
                   {"pooling_type": "avg", "ksize": [3, 3, 3],
                    "strides": [2, 2, 2], "paddings": [1, 1, 1]}, ("X",)),
        "spp": ("spp", {"X": [_u(67, 2, 2, 5, 6)]},
                {"pyramid_height": 3, "pooling_type": "max"}, ("X",)),
        "conv_shift": ("conv_shift", {"X": [_u(69, 3, 7)],
                                      "Y": [_u(70, 3, 3)]}, {}, ("X", "Y")),
        "cross_entropy_over_beam": (
            "cross_entropy_over_beam",
            {"X": [_u(20, 3, 6)], "Ids": [_ids([0, 2, 4], [1, 3, 5],
                                               [2, 0, 5])],
             "Label": [_ids([2], [4], [5])], "Length": [_ids(6, 6, 3)]},
            {}, ("X",)),
        "cross_entropy_selfnorm": ("cross_entropy_selfnorm",
                                   {"X": [_u(71, 4, 5, lo=0.1, hi=1.0)],
                                    "Label": [_ids([0], [4], [2], [1])]},
                                   {"softmax_selfnorm_alpha": 0.2}, ("X",)),
        "huber_classification": ("huber_classification",
                                 {"X": [f], "Label": [y01.astype(np.int64)]},
                                 {}, ("X",)),
        "lambda_rank": ("lambda_rank", {"X": [_u(21, 3, 6, 1)],
                                        "Score": [rel],
                                        "Length": [_ids(6, 4, 2)]},
                        {"NDCG_num": 3}, ("X",)),
        "scale_sub_region": ("scale_sub_region",
                             {"X": [_u(72, 2, 3, 4, 5)],
                              "Indices": [_ids([1, 2, 2, 3, 1, 5],
                                               [3, 3, 1, 4, 2, 2])]},
                             {"value": 2.5}, ("X",)),
        "depthwise_conv2d": ("depthwise_conv2d",
                             {"Input": [_u(73, 2, 3, 5, 5)],
                              "Filter": [_u(74, 3, 1, 3, 3)]},
                             {"paddings": [1, 1], "strides": [2, 1]},
                             ("Input", "Filter")),
        "fill_zeros_like": ("fill_zeros_like", {"X": [_u(75, 3, 2)]}, {},
                            ()),
        "hinge_loss": ("hinge_loss", {"Logits": [f], "Labels": [y01]}, {},
                       ("Logits",)),
        "l1_norm": ("l1_norm", {"X": [l1]}, {}, ("X",)),
        "log_loss": ("log_loss",
                     {"Predicted": [_u(76, 6, 1, lo=0.05, hi=0.95)],
                      "Labels": [y01]}, {"epsilon": 1e-6}, ("Predicted",)),
        "log_softmax": ("log_softmax", {"X": [_u(78, 3, 5)]}, {}, ("X",)),
        "margin_rank_loss": ("margin_rank_loss",
                             {"Label": [y01 * 2 - 1], "X1": [_u(79, 6, 1)],
                              "X2": [_u(80, 6, 1)]}, {"margin": 0.1},
                             ("X1", "X2")),
        "max_pool2d_with_index": ("max_pool2d_with_index", {"X": [pool]},
                                  {"ksize": [2, 2], "strides": [2, 2],
                                   "paddings": [1, 1]}, ("X",)),
        "max_pool3d_with_index": ("max_pool3d_with_index",
                                  {"X": [_u(82, 1, 2, 4, 4, 5)]},
                                  {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                                   "paddings": [0, 1, 1]}, ("X",)),
        "minus": ("minus", {"X": [_u(83, 3, 4)], "Y": [_u(84, 3, 4)]}, {},
                  ("X", "Y")),
        "modified_huber_loss": ("modified_huber_loss",
                                {"X": [f], "Y": [y01]}, {}, ("X",)),
        "one_hot": ("one_hot", {"X": [_ids([0], [3], [7], [4])]},
                    {"depth": 5}, ()),
        "scatter": ("scatter", {"X": [_u(85, 5, 3)], "Ids": [_ids(3, 0)],
                                "Updates": [_u(86, 2, 3)]}, {},
                    ("X", "Updates")),
        "sequence_mask": ("sequence_mask", {"X": [_ids(3, 0, 5, 1)]},
                          {"maxlen": 5}, ()),
        "unpool": ("unpool", {"X": [_u(27, 2, 2, 2, 2)],
                              "Indices": [unpool_idx]},
                   {"ksize": [2, 2], "strides": [2, 2]}, ("X",)),
    }


def emit_with_grad(dev, op, ins, attrs, diff):
    """The port's emitter of `op` on `dev` from numpy inputs, then, with
    `diff`, its ``generic_grad`` op on the same device: the cotangents
    fixed values in [0.5, 1.5) for every float output that takes one.
    Returns ({slot: [numpy]}, {"<slot>@GRAD": [numpy]})."""
    from paddle_tpu_torch.framework.core import GRAD_SUFFIX

    info = get_op_info(op)
    ctx = EmitContext(dev, is_test=False)
    t = {s: [torch.as_tensor(a).to(dev) for a in v] for s, v in ins.items()}
    out = info.emit(ctx, t, dict(attrs))
    host = {s: [v.detach().cpu().numpy() for v in vs]
            for s, vs in out.items()}
    if not diff:
        return host, {}
    g_ins = {**t, **out}
    for k, (s, vs) in enumerate(sorted(out.items())):
        if s in info.non_diff_outputs or not vs[0].is_floating_point():
            continue
        g_ins[s + GRAD_SUFFIX] = [torch.as_tensor(np.random.RandomState(
            90 + k).uniform(0.5, 1.5, v.shape).astype(np.float32)).to(dev)
            for v in vs]
    g_attrs = {"__fwd_type__": op, "__fwd_attrs__": dict(attrs),
               "__fwd_input_slots__": sorted(ins),
               "__fwd_output_slots__": sorted(out),
               "__wanted__": {(s, i) for s in diff
                              for i in range(len(ins[s]))}}
    grads = get_op_info("generic_grad").emit(ctx, g_ins, g_attrs)
    return host, {s: [g.detach().cpu().numpy() for g in gs]
                  for s, gs in grads.items()}


def rest_ops_phase(dev):
    """42(a) the last 48 op types on the card against the CPU, f32: each
    forward output within 1e-5 of its max |value| (integers equal) and
    each ``generic_grad`` gradient within 1e-5 of its max |g|, from the
    same numpy inputs; ``truncated_gaussian_random`` and ``sampling_id``
    by their properties (bounds, moments, frequencies); ``save`` then
    ``load`` on the card through a temporary directory, bitwise."""
    rows = {}
    for name, (op, ins, attrs, diff) in rest_op_cases().items():
        cpu, cpu_g = emit_with_grad(torch.device("cpu"), op, ins, attrs,
                                    diff)
        gpu, gpu_g = emit_with_grad(dev, op, ins, attrs, diff)
        out_err = max(_rel(g, c) for s in cpu for g, c in zip(gpu[s],
                                                               cpu[s]))
        grad_err = max((_rel(g, c) for s in cpu_g
                        for g, c in zip(gpu_g[s], cpu_g[s])), default=0.0)
        ok = (sorted(gpu) == sorted(cpu) and sorted(gpu_g) == sorted(cpu_g)
              and out_err <= 1e-5 and grad_err <= 1e-5)
        rows[name] = {"op": op, "out_rel_err": out_err,
                      "grad_rel_err": grad_err,
                      "grads": sorted(cpu_g), "ok": ok}
        if not ok:
            raise AssertionError(f"op {name} on the card disagrees with the "
                                 f"CPU: {rows[name]}")
    prog = fluid.Program()
    ctx = EmitContext(dev, is_test=False, program=prog)
    tg = get_op_info("truncated_gaussian_random").emit(
        ctx, {}, {"shape": [200000], "mean": 1.0, "std": 2.0,
                  "__uid__": 3})["Out"][0].cpu().numpy()
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    sid = get_op_info("sampling_id").emit(
        ctx, {"X": [torch.as_tensor(np.tile(p, (100000, 1))).to(dev)]},
        {"__uid__": 4})["Out"][0].cpu().numpy()
    freq = np.bincount(sid, minlength=4) / sid.size
    rows["truncated_gaussian_random"] = {
        "n": tg.size, "min": float(tg.min()), "max": float(tg.max()),
        "mean": float(tg.mean()), "std": float(tg.std()),
        "std_want": 2.0 * 0.8796,
        "ok": bool(tg.min() >= -3.0 and tg.max() <= 5.0
                   and abs(tg.mean() - 1.0) < 0.02
                   and abs(tg.std() - 2.0 * 0.8796) < 0.02)}
    rows["sampling_id"] = {"n": sid.size, "freq": freq.tolist(),
                           "p": p.tolist(), "dtype": str(sid.dtype),
                           "ok": bool(np.abs(freq - p).max() < 0.01
                                      and sid.dtype == np.int64)}
    x = torch.as_tensor(_u(88, 3, 4)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tensor")
        get_op_info("save").emit(ctx, {"X": [x]}, {"file_path": path})
        back = get_op_info("load").emit(ctx, {}, {"file_path": path})
        back = back["Out"][0]
        rows["save_load"] = {"device": str(back.device),
                             "ok": bool(back.device == x.device
                                        and torch.equal(back, x))}
    for name in ("truncated_gaussian_random", "sampling_id", "save_load"):
        if not rows[name]["ok"]:
            raise AssertionError(f"{name} on the card: {rows[name]}")
    log("rest_ops", rows)
    return rows


BOOK_WARM, BOOK_TIMED = 2, 10
BOOK_KERNELS = {"lstm": (("k7", SRL_K7_NAMES), ("k8", SRL_K8_NAMES)),
                "gru": (("k9", ("gru_fwd",)), ("k10", ("gru_bwd", "rnn_dw")))}


def book_launch_want(main):
    """K7/K8 and K9/K10 launches a training step from the program's LSTM
    and GRU op counts: each op launches its forward once and its
    ``generic_grad`` the forward again and the backward once."""
    ops = [op.type for op in main.global_block().ops]
    want = {"lstm_forward": 2 * ops.count("lstm"),
            "lstm_backward": ops.count("lstm"),
            "gru_forward": 2 * ops.count("gru"),
            "gru_backward": ops.count("gru")}
    return {k: v for k, v in want.items() if v}


def book_chapter_run(name, card_name, smi):
    """42(b) one book chapter (``models/book_chapters.py``) at its full
    widths on the card, fed by its dataset module's synthetic reader
    through ``reader.batch`` and ``DataFeeder``: the first step held to
    the CPU executor's step from the same startup state (loss 1e-4
    relative, three weights' gradients 1e-3 of their max |g|, as paths A
    and B hold theirs), then BOOK_WARM warm-up and BOOK_TIMED timed steps
    each ending in its loss fetch, every step's K7-K10 launches equal to
    what the program's LSTM and GRU ops imply, and one profiled step."""
    ch = CHAPTERS[name]
    w = ch.full
    fluid.reset()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    loss, feed_vars = ch.build(fluid, **w)
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    startup.random_seed = SEED
    feeds = book_batches(fluid, ch, feed_vars, 1 + BOOK_WARM + BOOK_TIMED,
                         **w)
    mode = dataset_common.data_mode(ch.dataset)
    want = book_launch_want(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    scope = fluid.global_scope()
    state = {n: scope.find_np(n) for n, v in main.global_block().vars.items()
             if v.persistable}
    weights = [p.name for p in main.global_block().all_parameters()
               if len(p.shape) >= 2]
    grads = [n + "@GRAD" for n in (weights[0], weights[len(weights) // 2],
                                   weights[-1])]
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    first = run_steps(exe, main, loss, feeds[0], 1, grads)
    t0 = time.monotonic()
    cpu_scope = fluid.Scope()
    fluid.load_persistables(main, state, cpu_scope)
    cpu = run_steps(fluid.Executor(fluid.CPUPlace()), main, loss, feeds[0],
                    1, grads, scope=cpu_scope)
    cpu_s = time.monotonic() - t0
    loss_rel = abs(first[0][0] - cpu[0][0]) / abs(cpu[0][0])
    grad_rel = {n: float(np.abs(first[0][1][n] - cpu[0][1][n]).max()
                         / max(np.abs(cpu[0][1][n]).max(), 1e-30))
                for n in grads}
    rows = list(first)
    for feed in feeds[1:1 + BOOK_WARM]:
        rows += run_steps(exe, main, loss, feed, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for feed in feeds[1 + BOOK_WARM:]:
        rows += run_steps(exe, main, loss, feed, 1)
    for _, _, launches, _ in rows:
        if want:
            check_launches(f"book_{name}", launches, want)
        else:
            no_launches(f"book_{name}", launches)
    step_ms = [r[3] * 1e3 for r in rows[1 + BOOK_WARM:]]
    med = float(np.median(step_ms))
    bs = w["bs"]
    losses = [r[0] for r in rows]
    res = {"card": card_name, "nvidia_smi": smi, "chapter": name,
           "dataset": ch.dataset, "data_mode": mode, "widths": w,
           "dtype": "float32", "optimizer": "adam" if ch.adam else "sgd",
           "setup_s": setup_s, "cpu_step_s": cpu_s,
           "params": sum(int(np.prod(p.shape)) for p in
                         main.global_block().all_parameters()),
           "ops": len(main.global_block().ops),
           "lstm_ops": [op.type for op in main.global_block().ops].count(
               "lstm"),
           "gru_ops": [op.type for op in main.global_block().ops].count(
               "gru"),
           "feed_shapes": {k: list(np.shape(v)) for k, v in
                           feeds[0].items()},
           "gpu_loss_step1": first[0][0], "cpu_loss_step1": cpu[0][0],
           "loss_rel_err": loss_rel, "grad_rel_err_step1": grad_rel,
           "losses": losses, "step_ms_median": med,
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "step_ms_each": step_ms, "samples_s": bs / (med / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": rows[-1][2], "launches_want": want}
    kinds = [k for k in ("lstm", "gru") if res[f"{k}_ops"]]
    res.update(srl_profile(exe, main, [loss], [(feeds[-1], None)],
                           kernels=sum((BOOK_KERNELS[k] for k in kinds),
                                       ())))
    log(f"book_{name}", res)
    if (loss_rel > 1e-4 or any(v > 1e-3 for v in grad_rel.values())
            or not np.isfinite(losses).all()):
        raise AssertionError(f"book_{name}: card and CPU disagree, or the "
                             f"losses are not finite: {res}")
    return res


def book_phase(dev, card_name, smi):
    """Phase 42: (a) ``rest_ops_phase``, (b) ``book_chapter_run`` for each
    chapter."""
    t0 = time.monotonic()
    ops = rest_ops_phase(dev)
    chapters = {name: book_chapter_run(name, card_name, smi)
                for name in CHAPTERS}
    fluid.reset()
    torch.cuda.empty_cache()
    res = {"card": card_name, "nvidia_smi": smi, "ops": ops,
           "chapters": chapters, "phase_s": time.monotonic() - t0}
    log("book_phase", {"phase_s": res["phase_s"]})
    return res


def book_summary(book):
    """Phase 42's numbers for the summary line."""
    keys = ("dataset", "data_mode", "widths", "params", "ops",
            "loss_rel_err", "grad_rel_err_step1", "losses",
            "step_ms_median", "step_ms_min", "step_ms_max", "samples_s",
            "peak_mem_gb", "launches_per_step", "launches_want",
            "device_busy_share", "device_busy_ms_per_step",
            "device_kernels_per_step", "k7_device_ms_per_step",
            "k8_device_ms_per_step", "k9_device_ms_per_step",
            "k10_device_ms_per_step", "profiled")
    return {"card": book["card"], "nvidia_smi": book["nvidia_smi"],
            "ops_card_vs_cpu": {
                "op_types": len({r.get("op", k)
                                 for k, r in book["ops"].items()}) + 1,
                "out_rel_err_max": max(r.get("out_rel_err", 0.0)
                                       for r in book["ops"].values()),
                "grad_rel_err_max": max(r.get("grad_rel_err", 0.0)
                                        for r in book["ops"].values()),
                "rng_and_io": {k: book["ops"][k] for k in (
                    "truncated_gaussian_random", "sampling_id",
                    "save_load")}},
            "chapters": {n: {k: r[k] for k in keys if k in r}
                         for n, r in book["chapters"].items()},
            "phase_s": book["phase_s"]}


# -- 43. the v2 API and the RecordIO data plane ---------------------------------

V2_FEEDING = {"word": 0, "label": 1}
V2_PARITY, V2_WARM, V2_TIMED = 3, 2, 10
V2_INFER_N = 16
V2_PROFILED_IS = ("upper bounds: the profiler inflates the step it watches "
                  "(PERF.md section 7)")


def v2_shards_phase(tmp):
    """43(a) ``imdb.convert`` writes the imdb splits as RecordIO shards
    through the native library; the train shards read back by the library
    equal the Python codec's records, the Python codec writes the same
    bytes, and the records unpickle to the reader's samples in order."""
    t0 = time.monotonic()
    imdb.convert(tmp)
    convert_s = time.monotonic() - t0
    shards = sorted(glob.glob(os.path.join(tmp, "imdb_train-*")))
    t0 = time.monotonic()
    native = [list(recordio.read_records(p, use_native=True)) for p in shards]
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    python = [list(recordio.read_records(p, use_native=False))
              for p in shards]
    python_s = time.monotonic() - t0
    if native != python:
        raise AssertionError("RecordIO: the library's records differ from "
                             "the Python codec's")
    for p, recs in zip(shards, native):
        with tempfile.NamedTemporaryFile(dir=tmp) as f:
            with recordio.Writer(f.name, use_native=False) as w:
                for r in recs:
                    w.write(r)
            with open(p, "rb") as a, open(f.name, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"RecordIO: {p} is not the bytes "
                                         f"the Python codec writes")
    samples = list(imdb.train(imdb.word_dict())())
    got = [pickle.loads(r) for recs in native for r in recs]
    if len(got) != len(samples) or any(
            g[1] != s[1] or g[0].dtype != s[0].dtype
            or not np.array_equal(g[0], s[0]) for g, s in zip(got, samples)):
        raise AssertionError("RecordIO: the shards are not imdb.train()'s "
                             "samples in order")
    nbytes = sum(os.path.getsize(p) for p in shards)
    res = {"shards": [os.path.basename(p) for p in shards],
           "records": len(got), "bytes": nbytes,
           "data_mode": dataset_common.data_mode("imdb"),
           "library": os.path.basename(recordio.library_path()),
           "convert_s": convert_s, "read_native_s": native_s,
           "read_python_s": python_s,
           "native_equals_python": True, "records_equal_samples": True}
    log("v2_shards", res)
    return shards, [r for recs in native for r in recs], res


def v2_tar(params):
    buf = io.BytesIO()
    params.to_tar(buf)
    return buf.getvalue()


def v2_trainer(place, scope, widths):
    """The v2 book's stacked-LSTM net (``v2_sentiment_build``) in fresh
    default programs, its ``trainer.SGD`` at `place` (None: the card) and
    its startup run, all in `scope`."""
    fluid.reset()
    with fluid.scope_guard(scope):
        cost, output, opt = v2_sentiment_build(paddle_v2, **widths)
        fluid.default_startup_program().random_seed = SEED
        tr = paddle_v2.trainer.SGD(cost=cost, update_equation=opt,
                                   place=place)
        tr._ensure_startup()
    return tr, cost, output


def v2_shard_batches(shards, bs, n):
    """The first `n` batches of `bs` from ``reader.creator.recordio`` over
    the shards, unpickled, through ``paddle.batch``."""
    samples = fluid.reader.map_readers(
        pickle.loads, fluid.reader.creator.recordio(shards))
    return fluid.reader.firstn(paddle_v2.batch(samples, bs), n)


def v2_train(tr, scope, batches):
    """``tr.train`` over `batches` in `scope`, every kernel's launch count
    set to 0 just before; per iteration (cost, metrics, launches, seconds
    from BeginIteration to EndIteration, seconds since the previous
    EndIteration or the call), and the counts just after."""
    rows, mark = [], {}

    def handler(e):
        if isinstance(e, paddle_v2.event.BeginIteration):
            mark["before"] = {k: f.launches for k, f in KERNELS.items()}
            mark["begin"] = time.monotonic()
        elif isinstance(e, paddle_v2.event.EndIteration):
            now = time.monotonic()
            rows.append((e.cost, e.metrics,
                         {k: f.launches - mark["before"][k]
                          for k, f in KERNELS.items()},
                         now - mark["begin"], now - mark["end"]))
            mark["end"] = now
            if len(rows) == V2_WARM:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()

    for k in KERNELS.values():
        k.launches = 0
    mark["end"] = time.monotonic()
    with fluid.scope_guard(scope):
        tr.train(batches, event_handler=handler, feeding=V2_FEEDING)
    return rows, {name: k.launches for name, k in KERNELS.items()}


def v2_sentiment_phase(shards, records, card_name, smi):
    """43(b)-(e): the v2 book's stacked-LSTM net at the book's widths
    (``V2_SENTIMENT["full"]``), f32, fed from the RecordIO shards; (e)
    runs between (c) and (d), while the probabilities are not yet 0 or
    1."""
    w = V2_SENTIMENT["full"]
    t0 = time.monotonic()
    card_scope, cpu_scope = fluid.Scope(), fluid.Scope()
    card, cost, output = v2_trainer(None, card_scope, w)
    want = book_launch_want(card.program)
    if want != {"lstm_forward": 2 * w["stacked_num"],
                "lstm_backward": w["stacked_num"]}:
        raise AssertionError(f"v2 sentiment: {want} is not 2 K7 and 1 K8 "
                             f"for each of the {w['stacked_num']} lstmemory")
    start = v2_tar(card.parameters)
    cpu, cpu_cost, cpu_output = v2_trainer(fluid.CPUPlace(), cpu_scope, w)
    cpu.parameters.from_tar(io.BytesIO(start))
    if v2_tar(cpu.parameters) != start:
        raise AssertionError("v2 sentiment: the card's tar did not load "
                             "into the CPU trainer to the bit")
    setup_s = time.monotonic() - t0
    names = card.parameters.names()
    # (c) three iterations, card against CPU, from the tar's state
    for tr in (card, cpu):
        tr.extra_layers = [tr.program.global_block().var(n + "@GRAD")
                           for n in names]
    parity = v2_shard_batches(shards, w["bs"], V2_PARITY)
    g_rows, g_total = v2_train(card, card_scope, parity)
    t0 = time.monotonic()
    c_rows, _ = v2_train(cpu, cpu_scope, parity)
    cpu_s = time.monotonic() - t0
    for tr in (card, cpu):
        tr.extra_layers = []
    loss_rel = max(abs(g[0] - c[0]) / abs(c[0])
                   for g, c in zip(g_rows, c_rows))
    grad_rel = {n: float(np.abs(g_rows[0][1][n + "@GRAD"]
                                - c_rows[0][1][n + "@GRAD"]).max()
                         / max(np.abs(c_rows[0][1][n + "@GRAD"]).max(),
                               1e-30))
                for n in names}
    for r in g_rows:
        check_launches("v2_sentiment_parity", r[2], want)
    # (e) the card's parameters as a tar into the CPU program, and infer
    # from them (after (c)'s three steps, before the losses saturate)
    blob = v2_tar(card.parameters)
    cpu.parameters.from_tar(io.BytesIO(blob))
    bitwise = all(
        np.array_equal(card.parameters.get(n).view(np.uint32),
                       cpu.parameters.get(n).view(np.uint32))
        and cpu_scope.find(n).device.type == "cpu" for n in names)
    samples = [(pickle.loads(r)[0],) for r in records[:V2_INFER_N]]
    with fluid.scope_guard(card_scope):
        probs, infer_launches = counted(lambda: paddle_v2.infer(
            output_layer=output, parameters=card.parameters, input=samples,
            feeding={"word": 0}))
    check_launches("v2_infer", infer_launches,
                   {"lstm_forward": w["stacked_num"]})
    with fluid.scope_guard(cpu_scope):
        cpu_probs = paddle_v2.infer(
            output_layer=cpu_output, parameters=cpu.parameters,
            input=samples, feeding={"word": 0}, place=fluid.CPUPlace())
    infer_err = float(np.abs(probs - cpu_probs).max()
                      / np.abs(cpu_probs).max())
    # (d) the timed run from the shards
    timed = v2_shard_batches(shards, w["bs"], V2_WARM + V2_TIMED)
    t_rows, t_total = v2_train(card, card_scope, timed)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(t_rows) != V2_WARM + V2_TIMED:
        raise AssertionError(f"v2 sentiment: {len(t_rows)} iterations")
    for r in t_rows:
        check_launches("v2_sentiment", r[2], want)
    check_launches("v2_sentiment_run", t_total,
                   {k: (V2_WARM + V2_TIMED) * v for k, v in want.items()})
    step_ms = [r[4] * 1e3 for r in t_rows[V2_WARM:]]
    run_ms = [r[3] * 1e3 for r in t_rows[V2_WARM:]]
    med = float(np.median(step_ms))
    feeder = paddle_v2.DataFeeder(paddle_v2.Topology(cost).data_type(),
                                  V2_FEEDING, program=card.program)
    feed = feeder(next(iter(timed()))[:w["bs"]])
    with fluid.scope_guard(card_scope):
        prof = srl_profile(card.exe, card.program, [card.cost],
                           [(feed, None)], kernels=BOOK_KERNELS["lstm"])
    main = card.program.global_block()
    res = {"card": card_name, "nvidia_smi": smi, "widths": w,
           "dtype": "float32", "optimizer": "adam 2e-3, L2 decay 8e-4",
           "params": sum(int(np.prod(p.shape))
                         for p in main.all_parameters()),
           "ops": len(main.ops), "lstm_ops": want["lstm_backward"],
           "setup_s": setup_s, "cpu_3_steps_s": cpu_s,
           "gpu_losses": [r[0] for r in g_rows],
           "cpu_losses": [r[0] for r in c_rows],
           "loss_rel_err": loss_rel, "grad_rel_err_step1": grad_rel,
           "grad_rel_err_step1_max": max(grad_rel.values()),
           "launches_per_step": t_rows[-1][2], "launches_want": want,
           "launches_parity_run": g_total, "launches_timed_run": t_total,
           "losses": [r[0] for r in t_rows], "step_ms_median": med,
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "step_ms_each": step_ms,
           "run_ms_median": float(np.median(run_ms)),
           "samples_s": w["bs"] / (med / 1e3), "peak_mem_gb": peak,
           **prof, "profiled_is": V2_PROFILED_IS,
           "tar_bytes": len(blob), "tar_card_to_cpu_bitwise": bitwise,
           "infer_n": V2_INFER_N, "infer_rel_err": infer_err,
           "infer_prob_min": float(cpu_probs.min()),
           "infer_launches": infer_launches}
    log("v2_sentiment", res)
    if (loss_rel > 1e-4 or max(grad_rel.values()) > 1e-3 or not bitwise
            or infer_err > 1e-4 or not np.isfinite(res["losses"]).all()):
        raise AssertionError(f"v2 sentiment: card and CPU disagree: {res}")
    return res


def v2_master_phase(shards, records):
    """43(f) one pass of ``v2.master.client`` over the shards through a
    loopback MasterServer: every record comes back once."""
    srv = MasterServer(MasterService(timeout_s=30.0)).start()
    try:
        host, port = srv.addr
        c = paddle_v2.master.client(f"{host}:{port}", 30)
        c.set_dataset(shards)
        c.paddle_start_get_records(0)
        got = []
        t0 = time.monotonic()
        while True:
            r, _ = c.next_record()
            if r is None:
                break
            got.append(r)
        wall = time.monotonic() - t0
        c.release()
    finally:
        srv.stop()
    res = {"tasks": len(shards), "records": len(got),
           "each_once": Counter(got) == Counter(records), "wall_s": wall}
    log("v2_master", res)
    if not res["each_once"]:
        raise AssertionError(f"v2 master: not every record once: {res}")
    return res


def v2_beam_phase():
    """43(g) ``SequenceGenerator`` over phase 26(d)'s NMT ``generate``
    graph (dictionaries 30000, widths 512, batch 8, ragged source up to
    64, beam 4, 16 steps) on the card against an explicit-CPU one, held
    by ``first_parting`` (scores within 1e-4; ids, and so lengths, equal
    up to the first f32 tie); K9 twice a call."""
    fluid.reset()
    progs = {}

    def programs(n):
        if n not in progs:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                gen, _, _ = rnn_bench.nmt_generate_programs(
                    seq_len=NMT_GEN_SRC, beam_size=NMT_GEN_BEAM, max_len=n)
            progs[n] = (main, startup, gen)
        return progs[n]

    main, startup, gen = programs(NMT_GEN_LEN)
    startup.random_seed = SEED
    fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    state = {n: fluid.global_scope().find_np(n)
             for n, v in main.global_block().vars.items() if v.persistable}
    cpu_sc = fluid.Scope()
    fluid.load_persistables(main, state, cpu_sc)
    nf = rnn_bench.nmt_feed(NMT_GEN_BS, NMT_GEN_SRC)
    feed = {"src": nf["src"], "src@LENGTH": nf["src@LENGTH"]}

    def generator(n, place):
        m, _, (ids, scores, lengths) = programs(n)
        return paddle_v2.SequenceGenerator(ids, scores, lengths, program=m,
                                           place=place)

    card_gen = generator(NMT_GEN_LEN, None)
    card_gen(feed)
    t0 = time.monotonic()
    hyps, launches = counted(lambda: card_gen(feed))
    wall = time.monotonic() - t0
    check_launches("v2_sequence_generator", launches, {"gru_forward": 2})

    def arrays(rows, n):
        ids = np.full((len(rows), NMT_GEN_BEAM, n), -1, np.int64)
        scores = np.zeros((len(rows), NMT_GEN_BEAM), np.float64)
        for b, row in enumerate(rows):
            for j, (s, toks) in enumerate(row):
                ids[b, j, :len(toks)] = toks
                scores[b, j] = s
        return ids, scores

    def run(place):
        def go(n):
            if place is None:
                return arrays(hyps if n == NMT_GEN_LEN
                              else generator(n, None)(feed), n)
            with fluid.scope_guard(cpu_sc):
                return arrays(generator(n, place)(feed), n)
        return go

    vs_cpu = first_parting("v2 SequenceGenerator, card against CPU",
                           run(None), run(fluid.CPUPlace()), NMT_GEN_LEN,
                           1e-4)
    res = {"bs": NMT_GEN_BS, "src": NMT_GEN_SRC, "beam": NMT_GEN_BEAM,
           "max_len": NMT_GEN_LEN, "card_vs_cpu": vs_cpu,
           "hypotheses_per_row": [len(r) for r in hyps],
           "best_scores": [r[0][0] for r in hyps], "wall_ms": wall * 1e3,
           "launches": launches}
    log("v2_sequence_generator", res)
    return res


def v2_api_phase(dev, card_name, smi):
    """Phase 43: (a) ``v2_shards_phase``, (b)-(e) ``v2_sentiment_phase``,
    (f) ``v2_master_phase``, (g) ``v2_beam_phase``."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        shards, records, sh = v2_shards_phase(tmp)
        sent = v2_sentiment_phase(shards, records, card_name, smi)
        master = v2_master_phase(shards, records)
    beam = v2_beam_phase()
    fluid.reset()
    torch.cuda.empty_cache()
    res = {"card": card_name, "nvidia_smi": smi, "shards": sh,
           "sentiment": sent, "master": master, "beam": beam,
           "phase_s": time.monotonic() - t0}
    log("v2_api_phase", {"phase_s": res["phase_s"]})
    return res


# -- 44. the deploy tier: the desc library, the C API, build_callable ---------

DEPLOY_BS, DEPLOY_SEQ = 4, 512  # the C program's tokens, [4, 512]
DEPLOY_TIMED, DEPLOY_WARM = 10, 2
RESNET_DEPLOY_BS = 8  # __graft_entry__.entry()'s example batch


def equal_bits(a, b):
    """Equal shapes and equal bytes (so -0.0 and NaN payloads count)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def host_ms(call, warm=DEPLOY_WARM, n=DEPLOY_TIMED):
    """Host ms of `call` between device synchronizes: median, min, max of
    `n` after `warm` warm-up calls."""
    for _ in range(warm):
        call()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(ts)), "min": min(ts), "max": max(ts)}


def deploy_builds():
    """(a) The desc library, the C-API library and the C demo, each timed."""
    from paddle_tpu_torch.native import capi, program_desc

    secs = {}
    for name, fn in (("program_desc", program_desc.build_lib),
                     ("capi", capi.build_lib), ("capi_demo", capi.build_demo)):
        t0 = time.monotonic()
        path = fn()
        secs[name] = time.monotonic() - t0
        if not os.path.exists(path):
            raise AssertionError(f"deploy: {name} built no {path}")
    log("deploy_build", secs)
    return secs


def desc_checks(main, logits, model_bytes):
    """(b) The desc library on the full-width GPT training program and its
    saved inference program: validate, stats against the Program's own
    counts, prune against ``io.prune``, a stable text dump, and three
    corruptions refused with their diagnostics."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.framework import proto_io
    from paddle_tpu_torch.framework.core import Parameter
    from paddle_tpu_torch.native import program_desc

    train = proto_io.serialize_program(main)
    res = {"train_bytes": len(train), "inference_bytes": len(model_bytes)}
    for tag, data in (("train", train), ("inference", model_bytes)):
        ok, diag = program_desc.validate(data)
        if not ok:
            raise AssertionError(f"deploy: the {tag} program is refused: "
                                 f"{diag}")
        prog = proto_io.parse_program(data)
        blocks = prog.blocks
        want = {"blocks": len(blocks),
                "ops": sum(len(b.ops) for b in blocks),
                "vars": sum(len(b.vars) for b in blocks),
                "params": sum(isinstance(v, Parameter) for b in blocks
                              for v in b.vars.values()),
                "op_types": len({op.type for b in blocks for op in b.ops})}
        stats = json.loads(program_desc.stats(data))
        if stats != want:
            raise AssertionError(f"deploy: {tag} stats {stats} != the "
                                 f"program's {want}")
        text = program_desc.text_dump(data)
        if not text or program_desc.text_dump(data) != text:
            raise AssertionError(f"deploy: the {tag} text dump is empty or "
                                 f"unstable")
        res[tag] = {**stats, "text_bytes": len(text)}
    pruned = proto_io.parse_program(program_desc.prune(train, [logits.name]))
    want_ops = [op.type for op in io.prune(main, [logits.name])
                .global_block().ops]
    if [op.type for op in pruned.global_block().ops] != want_ops:
        raise AssertionError("deploy: the library's prune is not io.prune's")
    res["pruned_ops"] = len(want_ops)
    pdef = proto_io.program_to_proto(main)
    pdef["blocks"][0]["ops"][0]["inputs"][0]["arguments"].append("ghost")
    cyclic = proto_io.program_to_proto(main)
    cyclic["blocks"] += [
        {"idx": 1, "parent_idx": 2, "ops": [{"type": "mean", "inputs": [
            {"name": "X", "arguments": ["undeclared_var"]}]}]},
        {"idx": 2, "parent_idx": 1}]
    for tag, data, want in (
            ("undeclared", proto_io.encode("ProgramDef", pdef),
             "input 'ghost' is undeclared"),
            ("half", train[:len(train) // 2],
             "parse error: bad ProgramDef bytes"),
            ("cyclic_parent", proto_io.encode("ProgramDef", cyclic),
             "input 'undeclared_var' is undeclared")):
        ok, diag = program_desc.validate(data)
        if ok or want not in diag:
            raise AssertionError(f"deploy: corruption {tag} not refused "
                                 f"as expected: {diag!r}")
    res["corruptions_refused"] = 3
    return res


def cli_tools(m, merged):
    """(f) ``cli.main`` on the saved model: validate, stats, dump_config,
    show_pb, merge_model; their output sizes and the merge's seconds."""
    import contextlib

    from paddle_tpu_torch import cli

    res = {}
    for sub in ("validate", "stats", "dump_config", "show_pb",
                "merge_model"):
        argv = [sub, m] + ([merged] if sub == "merge_model" else [])
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        secs = time.monotonic() - t0
        out = buf.getvalue()
        if rc != 0 or not out:
            raise AssertionError(f"deploy: cli {sub} exited {rc}")
        res[sub] = {"rc": rc, "stdout_bytes": len(out), "s": secs}
    if buf.getvalue() != merged + "\n":
        raise AssertionError("deploy: merge_model printed another path")
    res["validate"]["stdout"] = "OK"
    res["merged_bytes"] = os.path.getsize(merged)
    return res


def capture_callable(fn, state, feeds, name):
    """One call of `fn` captured by ``torch.cuda.graph`` after a warm-up
    on a side stream; returns (graph, its static output, launches at
    capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(state, feeds)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            return fn(state, feeds)[name]

    out, launches = counted(capture)
    return graph, out, launches


def resnet_callable(dev):
    """(e) ``__graft_entry__.entry()``'s counterpart: ResNet-50 inference
    (depth 50, class_dim 1000, f32, startup-initialised, batch 8 of 3 x
    224 x 224) through ``build_callable`` against ``Executor.run``'s
    test-mode forward, TF32 off; cuDNN runs it, no port kernel."""
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.models import resnet

    fluid.reset()
    img = fluid.layers.data(name="image", shape=[3, 224, 224],
                            dtype="float32")
    logits = resnet.resnet_imagenet(img, class_dim=1000, depth=50)
    infer = fluid.default_main_program().clone(for_test=True)
    startup = fluid.default_startup_program()
    startup.random_seed = SEED
    exe = fluid.Executor()
    exe.run(startup)
    fn, state = compiler.build_callable(infer, [logits],
                                        feed_names=["image"])
    x = np.random.RandomState(0).randn(
        RESNET_DEPLOY_BS, 3, 224, 224).astype(np.float32)
    (want,), exe_launches = counted(lambda: exe.run(
        infer, feed={"image": x}, fetch_list=[logits]))
    xt = torch.from_numpy(x).to(dev)
    got, fn_launches = counted(lambda: fn(state, {"image": xt})[logits.name])
    no_launches("deploy resnet50 Executor.run", exe_launches)
    no_launches("deploy resnet50 build_callable", fn_launches)
    got = got.cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if not err <= 1e-5:
        raise AssertionError(f"deploy: ResNet-50 through build_callable is "
                             f"{err} of max |logit| from Executor.run")
    ms = host_ms(lambda: fn(state, {"image": xt}))
    res = {"bs": RESNET_DEPLOY_BS, "state_tensors": len(state),
           "rel_err_vs_executor": err, "launches": fn_launches,
           "port_kernels": "none: cuDNN runs the convolutions",
           "eager_ms": ms}
    exe.close()
    fluid.reset()
    return res


def bf16_fetch_refused(tmp):
    """(c) The C ABI has no bfloat16 code: a bf16 fetch raises TypeError
    through ``output_dtype`` (checked once, on a small model)."""
    from paddle_tpu_torch import capi_runtime, io

    fluid.reset()
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    out = fluid.layers.cast(fluid.layers.fc(x, size=2), "bfloat16")
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    d = os.path.join(tmp, "bf16")
    io.save_inference_model(d, ["x"], [out], exe)
    h = capi_runtime.create(d)
    xb = np.ones((2, 4), np.float32)
    capi_runtime.set_input(h, "x", xb.tobytes(), xb.shape, 0)
    capi_runtime.run(h)
    try:
        capi_runtime.output_dtype(h, 0)
    except TypeError as e:
        msg = str(e)
    else:
        raise AssertionError("deploy: a bf16 fetch got a C ABI dtype code")
    capi_runtime.release(h)
    exe.close()
    fluid.reset()
    return msg


def deploy_phase(dev, card_name, smi):
    """Phase 44: (a) builds, (b) ``desc_checks``, (c) the save, (d) the C
    program and the in-process engine, (e) ``build_callable`` (GPT, a
    captured replay, ResNet-50), (f) ``cli_tools`` and the merged bundle,
    ``net_drawer``."""
    from paddle_tpu_torch import capi_runtime, compiler, net_drawer
    from paddle_tpu_torch import io as fio
    from paddle_tpu_torch.native import capi

    t0 = time.monotonic()
    builds = deploy_builds()
    res = {"card": card_name, "nvidia_smi": smi, "builds_s": builds,
           "widths": {"vocab": VOCAB, "dim": DIM, "layers": LAYERS,
                      "heads": HEADS, "bs": DEPLOY_BS, "seq": DEPLOY_SEQ,
                      "dtype": "float32"}}
    with tempfile.TemporaryDirectory() as tmp:
        # (c) the f32 GPT at the bench width from one seeded state
        loss, logits, main, startup = lm_program(DEPLOY_SEQ, "float32")
        exe = fluid.Executor()
        exe.run(startup)
        m = os.path.join(tmp, "gpt")
        t1 = time.monotonic()
        fio.save_inference_model(m, ["tokens"], [logits], exe, main)
        res["save_s"] = time.monotonic() - t1
        with open(os.path.join(m, "__model__"), "rb") as f:
            model_bytes = f.read()
        toks = np.random.RandomState(0).randint(
            0, VOCAB, (DEPLOY_BS, DEPLOY_SEQ, 1)).astype(np.int64)
        tok_file, out_file = (os.path.join(tmp, "tokens.bin"),
                              os.path.join(tmp, "logits.bin"))
        toks.tofile(tok_file)
        # (d) the C program, a process of its own, on the card
        env = capi.embed_env()
        env.pop(capi_runtime.PLACE_ENV, None)
        t_demo = time.monotonic()
        demo = subprocess.Popen(
            [capi.build_demo(), m, os.path.dirname(os.path.abspath(
                __file__)), "tokens", "1", f"{DEPLOY_BS},{DEPLOY_SEQ},1",
             tok_file, out_file], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        # (b) and (f) on the host while it runs
        res["desc"] = desc_checks(main, logits, model_bytes)
        merged = os.path.join(tmp, "gpt.merged")
        res["tools"] = cli_tools(m, merged)
        dot = net_drawer.draw_graph(fio.load_program_desc(m)[0])
        if not dot.startswith("digraph"):
            raise AssertionError("deploy: draw_graph gave no digraph")
        res["tools"]["draw_graph_lines"] = dot.count("\n") + 1
        out, err = demo.communicate(timeout=600)
        if demo.returncode != 0:
            raise AssertionError(f"deploy: the C program exited "
                                 f"{demo.returncode}:\n{out}\n{err[-4000:]}")
        demo_wall = time.monotonic() - t_demo
        last = out.strip().splitlines()[-1].split()
        if last[0] != "CAPI_OK" or last[1:3] != ["0", "3"]:
            raise AssertionError(f"deploy: the C program said {last}")
        exe.close()
        del exe
        fluid.reset()
        torch.cuda.empty_cache()

        # the reference: load_inference_model + Executor.run in this process
        exe = fluid.Executor()
        scope = fluid.Scope()
        prog, feeds, fetches = fio.load_inference_model(m, exe, scope)
        (want,), exe_launches = counted(lambda: exe.run(
            prog, feed={"tokens": toks}, fetch_list=fetches, scope=scope))
        check_launches("deploy Executor.run", exe_launches,
                       {"flash_attention": LAYERS})
        c_logits = np.fromfile(out_file, np.float32).reshape(want.shape)
        if not equal_bits(c_logits, want):
            raise AssertionError("deploy: the C program's logits are not "
                                 "Executor.run's")
        res["c_program"] = {
            "logits_shape": list(want.shape), "bitwise_vs_executor": True,
            "create_ms": float(last[-2]), "first_run_ms": float(last[-1]),
            "wall_s": demo_wall, "shutdown_rc": 0}

        # the in-process engine through the C ABI
        eng = capi.InferenceEngine(m)
        (got,), eng_launches = counted(lambda: eng.run({"tokens": toks}))
        check_launches("deploy capi engine", eng_launches,
                       {"flash_attention": LAYERS})
        if not equal_bits(got, want):
            raise AssertionError("deploy: the in-process engine's logits are "
                                 "not Executor.run's")
        res["engine"] = {
            "bitwise_vs_executor": True, "launches": eng_launches,
            "engine_ms": host_ms(lambda: eng.run({"tokens": toks})),
            "executor_ms": host_ms(lambda: exe.run(
                prog, feed={"tokens": toks}, fetch_list=fetches,
                scope=scope)),
            "shutdown_rc": capi.load().paddle_capi_shutdown()}
        eng.close()
        if res["engine"]["shutdown_rc"] != 0:
            raise AssertionError("deploy: paddle_capi_shutdown failed")

        # (e) build_callable on the loaded program
        fn, state = compiler.build_callable(prog, fetches, scope=scope)
        feeds_t = {"tokens": torch.from_numpy(toks).to(dev)}
        name = fetches[0]
        eager, fn_launches = counted(lambda: fn(state, feeds_t)[name])
        check_launches("deploy build_callable", fn_launches,
                       {"flash_attention": LAYERS})
        eager = eager.clone()
        if not equal_bits(eager.cpu().numpy(), want):
            raise AssertionError("deploy: build_callable's logits are not "
                                 "Executor.run's")
        graph, static_out, capture_launches = capture_callable(
            fn, state, feeds_t, name)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(static_out, eager):
            raise AssertionError("deploy: the captured build_callable "
                                 "replay differs from the eager call")
        res["build_callable"] = {
            "state_tensors": len(state), "bitwise_vs_executor": True,
            "launches": fn_launches, "launches_at_capture": capture_launches,
            "replay_bitwise_vs_eager": True,
            "eager_ms": host_ms(lambda: fn(state, feeds_t)),
            "replay_ms": host_ms(graph.replay)}
        del graph, static_out, eager
        torch.cuda.empty_cache()

        # (f) the merged bundle loads and gives (d)'s logits
        mscope = fluid.Scope()
        t1 = time.monotonic()
        mprog, _, mfetches = fio.load_merged_model(merged, exe, mscope)
        res["tools"]["load_merged_s"] = time.monotonic() - t1
        (mlogits,) = exe.run(mprog, feed={"tokens": toks},
                             fetch_list=mfetches, scope=mscope)
        if not equal_bits(mlogits, c_logits):
            raise AssertionError("deploy: the merged bundle's logits are not "
                                 "the C program's")
        res["tools"]["merged_bitwise_vs_c_program"] = True
        exe.close()
        del exe, scope, mscope, state, fn
        fluid.reset()
        torch.cuda.empty_cache()
        res["resnet50"] = resnet_callable(dev)
        res["bf16_fetch_type_error"] = bf16_fetch_refused(tmp)
    torch.cuda.empty_cache()
    res["phase_s"] = time.monotonic() - t0
    log("deploy_phase", {k: res[k] for k in (
        "builds_s", "save_s", "desc", "tools", "c_program", "engine",
        "build_callable", "resnet50", "phase_s")})
    return res


def v2_api_summary(v2):
    """Phase 43's numbers for the summary line."""
    keys = ("widths", "params", "ops", "lstm_ops", "gpu_losses",
            "cpu_losses", "loss_rel_err", "grad_rel_err_step1_max",
            "losses", "step_ms_median", "step_ms_min", "step_ms_max",
            "run_ms_median", "samples_s", "peak_mem_gb",
            "launches_per_step", "launches_want", "device_busy_share",
            "device_busy_ms_per_step", "device_kernels_per_step",
            "k7_device_ms_per_step", "k8_device_ms_per_step", "profiled",
            "profiled_is", "tar_card_to_cpu_bitwise", "infer_rel_err",
            "infer_prob_min", "infer_launches")
    s = v2["sentiment"]
    return {"card": v2["card"], "nvidia_smi": v2["nvidia_smi"],
            "shards": {k: v2["shards"][k] for k in (
                "records", "bytes", "data_mode", "convert_s",
                "read_native_s", "read_python_s", "native_equals_python",
                "records_equal_samples")},
            "sentiment_f32": {k: s[k] for k in keys if k in s},
            "master": v2["master"],
            "sequence_generator": {k: v2["beam"][k] for k in (
                "card_vs_cpu", "wall_ms", "launches")},
            "phase_s": v2["phase_s"]}


def distributed_summary(dist):
    """Phase 41's numbers for the summary line."""
    keys = ("mesh", "n_micro", "positions", "losses", "single_losses",
            "witness_f32_losses", "step_ms", "tok_s", "peak_mem_gb",
            "launches_per_step", "launches_want", "ticks", "hops_per_step",
            "psums_per_step", "hop_bytes_per_step", "device_ms_per_step",
            "device_busy_share", "single_card", "link_time")
    return {
        "card": dist["card"], "nvidia_smi": dist["nvidia_smi"],
        "pipeline_bf16": {tag: {k: r[k] for k in keys if k in r}
                          for tag, r in dist["pipeline"].items()},
        "pipeline_held": {tag: [{k: h[k] for k in (
            "loss_rel", "update_rel", "bound", "share_of_bound")}
            for h in r["held"]] for tag, r in dist["pipeline"].items()},
        "pserver_gpt_f32": {k: dist["pserver_gpt_f32"][k] for k in (
            "pservers", "optimizer", "losses", "local_host_rule_losses",
            "bitwise_vs_local_host_rule", "single_card_adam_op_losses",
            "loss_rel_vs_adam_op", "param_bytes_each_way", "step_ms",
            "device_ms", "wire_ms", "host_optimizer_ms")},
        "host_services": dist["host_services"]}


# -- 44. summary --------------------------------------------------------------

def summary_row(name, source, replaces, row, by_dtype, launches, by_path):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "max_abs_err_by_dtype": by_dtype,
            "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in row
                      if k in ("shape", "dtype", "B", "H", "T", "D", "N",
                               "nh", "C", "dh", "ps", "maxp",
                               "pool_pages", "causal", "lengths")}}


def parallel_summary(par, name, smi):
    """Phase 40's numbers for the summary line."""
    g = par["lm_dp_sp"]
    return {
        "card": name, "nvidia_smi": smi,
        "ring": [{k: r[k] for k in (
            "schedule", "S", "dtype", "max_abs_err", "grad_max_rel_err",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "launches")}
            for r in par["ring"]],
        "lm_dp_sp_bf16": {k: g[k] for k in (
            "mesh", "positions", "bs", "seq", "schedule", "losses",
            "single_losses", "witness_f32_losses", "step_ms", "tok_s",
            "peak_mem_gb", "launches_per_step", "reshards_per_step",
            "collectives_per_step", "device_ms_per_step",
            "device_busy_share", "single_card", "link_time") if k in g},
        "lm_dp_sp_held": [{k: h[k] for k in (
            "loss_rel", "state_all_rel", "bound", "share_of_bound",
            "worst_tensor_rel", "single_worst_tensor_rel")}
            for h in g["held"]],
        "parity_f32": {m: {k: r[k] for k in (
            "loss_rel_err", "state_rel_err_max", "launches_per_step")}
            for m, r in par["parity_f32"].items()},
        "sp_ring_k2_dispatches": par["loop_k2"]}


# -- 45. one program over two processes -------------------------------------

MP_PARITY = ("jax_mlp_fsdp", "jax_lm_sp", "mode:sp_ring", "mode:ep_dp")
MP_NPROC = 2
MP_TIMEOUT = 300.0


def mp_job(cases, nproc, out):
    """One multihost job on the card (the cases' seed is SEED's 0); fatal
    unless every process exits 0 and the processes agree."""
    t0 = time.monotonic()
    rc, outs = mh.launch_job(cases, nproc=nproc, place="cuda", out=out,
                             timeout=MP_TIMEOUT)
    if rc != 0:
        raise AssertionError(
            f"multiprocess: {cases} over {nproc} process(es) exit {rc}:\n"
            + "\n".join(o[-4000:] for o in outs))
    infos = [json.loads(ln[len("TRANSPORT "):]) for o in outs
             for ln in o.splitlines() if ln.startswith("TRANSPORT ")]
    return {"wall_s": time.monotonic() - t0, "transport": infos}


def mp_rel(got, want):
    """(largest |difference| over largest |value|, bitwise) of two
    arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} != {want.shape}")
    d = float(np.abs(got - want).max()) if got.size else 0.0
    return d / max(float(np.abs(want).max()) if want.size else 0.0,
                   1e-30), bool(np.array_equal(got, want))


def mp_per_step(rows, key):
    return [r[key] for r in rows]


def mp_process_row(meta, warm):
    """One process's figures of a timed case."""
    f = meta["figures"]
    timed = f["steps"][warm:]
    launches = {k: [r["launches"][k] for r in timed]
                for k in timed[0]["launches"]}
    tx = {k: float(np.mean([r["transport"][k] for r in timed]))
          for k in timed[0].get("transport", {})}
    return {"step_ms": float(np.median(mp_per_step(timed, "ms"))),
            "step_ms_each": mp_per_step(timed, "ms"),
            "peak_mem_gb": max(r.get("peak_mem_gb", 0.0) for r in f["steps"]),
            "launches_per_step": {k: v[-1] for k, v in launches.items()},
            "launches_each_step": launches,
            "collectives_per_step": f["collectives_per_step"],
            "transport_per_step": tx, "mesh": f["mesh"],
            **{k: f[k] for k in ("device_ms_per_step", "device_busy_share",
                                 "wall_ms_profiled_per_step", "profiled")
               if k in f}}


def mp_parity(two, one):
    """(a) each case: the two processes' losses and state against the
    single process's."""
    rows = {}
    for case in MP_PARITY:
        (m2, a2), (m1, a1) = (mh.results(two, case, MP_NPROC)[0],
                              mh.results(one, case, 1)[0])
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(m2["losses"],
                                                        m1["losses"])]
        state = {k: mp_rel(a2[k], a1[k]) for k in a1
                 if k.startswith("state/")}
        row = {"case": case, "losses": m2["losses"],
               "single_losses": m1["losses"], "loss_rel_err": loss_rel,
               "state_rel_err_max": max(r for r, _ in state.values()),
               "bitwise": m2["losses"] == m1["losses"]
               and all(b for _, b in state.values()),
               "seconds_two": m2["seconds"], "seconds_one": m1["seconds"]}
        log("multiprocess_parity", row)
        if max(loss_rel) > 1e-6 or row["state_rel_err_max"] > 1e-6:
            worst = sorted(state.items(), key=lambda kv: -kv[1][0])[:3]
            raise AssertionError(f"multiprocess {case}: two processes part "
                                 f"from one: {row}, worst {worst}")
        rows[case] = row
    return rows


def mp_held(case, two, one, warm, want_launches):
    """(b)/(c): the loss of every step the single process ran and the
    state's digests after them (``sha1/``) of the two processes equal to
    the single process's, and each process's launches a step at
    `want_launches`."""
    got = mh.results(two, case, MP_NPROC)
    m1, a1 = mh.results(one, case, 1)[0]
    (m2, a2) = got[0]
    held = len(m1["losses"])
    if m2["figures"].get("held_steps", held) != held:
        raise AssertionError(f"multiprocess {case}: the processes took "
                             f"their digests after "
                             f"{m2['figures']['held_steps']} steps, the "
                             f"single process ran {held}")
    digests = [k for k in a1 if k.startswith("sha1/")]
    if not digests or any(k not in a2 for k in digests):
        raise AssertionError(f"multiprocess {case}: the digests after "
                             f"{held} steps are missing")
    differ = sorted(k.split("/", 1)[1] for k in digests
                    if not np.array_equal(a2[k], a1[k]))
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(m2["losses"][:held],
                                                    m1["losses"])]
    rows = [mp_process_row(m, warm) for m, _ in got]
    for r, (m, _) in enumerate(got):
        for row in m["figures"]["steps"]:
            if row["launches"] != want_launches:
                raise AssertionError(
                    f"multiprocess {case}: process {r} launched "
                    f"{row['launches']} in a step, want {want_launches}")
    res = {"losses": m2["losses"], "single_losses": m1["losses"],
           "seconds": {"two": [m["seconds"] for m, _ in got],
                       "one": m1["seconds"]},
           "held_steps": held, "loss_rel_err": loss_rel,
           "state_tensors_differ": differ[:5],
           "bitwise": m2["losses"][:held] == m1["losses"] and not differ,
           "processes": rows, "single_process": mp_process_row(m1, warm),
           "launches_want_per_process_step": want_launches}
    if not res["bitwise"]:
        raise AssertionError(f"multiprocess {case}: two processes part "
                             f"from the single-process mesh: {res}")
    if not all(np.isfinite(m2["losses"])):
        raise AssertionError(f"multiprocess {case}: losses {m2['losses']}")
    return res


def mp_ring_shapes():
    """[(dtype, global q/k/v shape over a two-position sp ring)] at which
    phase 45's cases reach K4-K6 a position: the GPT of ``gpt_sp`` (a dp
    position's batch, zigzag halves of [2, 8, 256, 64]; bf16 as it runs,
    and f32) and ``jax_lm_sp``'s small LM (f32, halves of [2, 2, 16,
    32])."""
    o = mh.GPT
    dp = mh.GPT_AXES["dp"]
    gpt = (o["bs"] // dp, o["heads"], o["seq"], o["dim"] // o["heads"])
    lm = (8 // dp, 2, 64, 32)
    return [(torch.bfloat16, gpt), (torch.float32, gpt),
            (torch.float32, lm)]


def mp_kernel_check(dev):
    """(e) K4, K5 and K6 at the per-position shapes of the processes' ring
    (``mp_ring_shapes``): one zigzag training call over {"sp": 2} on the
    kernels held to the same call on their plain versions at phase 40(a)'s
    TOL, the launches held to the schedule's."""
    S = mh.GPT_AXES["sp"]
    mesh = pmesh.make_mesh({"sp": S}, devices=[dev] * S)
    rows = []
    for dtype, shape in mp_ring_shapes():
        g = torch.Generator(device=dev).manual_seed(SEED + 45)
        q, k, v, do = (torch.randn(*shape, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        got, launches = counted(lambda: ring_call("zigzag", mesh, q, k, v,
                                                  do))
        tag = f"multiprocess_ring_{str(dtype).split('.')[1]}_{shape[2]}"
        check_launches(tag, launches, ring_want("zigzag", S))
        with plain_ring():
            ref = ring_call("zigzag", mesh, q, k, v, do)
        torch.cuda.synchronize()
        B, H, T, D = shape
        row = {"schedule": "zigzag", "S": S,
               "dtype": str(dtype).split(".")[1], "shape": list(shape),
               "block": [B, H, T // (2 * S), D],
               "max_abs_err": max_err(got[0], ref[0]),
               "grad_max_rel_err": max(
                   rel_err(a, b) for a, b in zip(got[1:], ref[1:])),
               "tol": TOL[dtype],
               "launches": {n: launches[n] for n in (
                   "flash_attention_fwd", "flash_attention_dq",
                   "flash_attention_dkv")}}
        log("multiprocess_ring_kernel", row)
        if row["max_abs_err"] > TOL[dtype] or \
                row["grad_max_rel_err"] > TOL[dtype]:
            raise AssertionError(f"{tag}: the ring on the kernels disagrees "
                                 f"with the ring on the plain versions: "
                                 f"{row}")
        rows.append(row)
    return rows


def multiprocess_phase(card_name, smi, par=None, dist=None):
    """Phase 45: (a)-(e) of the docstring, one two-process job and the
    same cases on the single-process mesh in this process (``gpt_sp`` for
    the steps it holds); `par` and `dist` (phases 40 and 41, when they
    ran) give the figures set beside."""
    t0 = time.monotonic()
    fluid.reset()
    torch.cuda.empty_cache()
    ring = mp_kernel_check(torch.device("cuda", 0))
    o = mh.GPT
    with tempfile.TemporaryDirectory() as tmp:
        two, one = os.path.join(tmp, "two"), os.path.join(tmp, "one")
        job_two = mp_job(list(MP_PARITY) + ["gpt_sp", "gpt_pipe", "loop_k2"],
                         MP_NPROC, two)
        # the single-process mesh in this process (the kernels are loaded);
        # gpt_sp runs the steps the two processes' digests follow
        t1 = time.monotonic()
        mh.run_here(list(MP_PARITY) + ["gpt_pipe"], place="cuda", out=one)
        mh.run_here(["gpt_sp"], place="cuda", out=one,
                    opts={"timed": o["held"] - o["warm"]})
        job_one = {"wall_s": time.monotonic() - t1}
        fluid.reset()
        torch.cuda.empty_cache()
        for info in job_two["transport"]:
            tr = info["transport"]
            log("multiprocess_transport", info)
            if tr is None or tr["backend"] != "gloo" or not tr["staged"]:
                raise AssertionError(f"multiprocess: rank {info['rank']} "
                                     f"took {tr}, want gloo staged")
        parity = mp_parity(two, one)
        per_process = int(np.prod(list(mh.GPT_AXES.values()))) // MP_NPROC
        gpt = mp_held("gpt_sp", two, one, o["warm"], mesh_launch_want(
            mh.GPT_AXES["sp"], per_process))
        want_pipe = {k: v // MP_NPROC for k, v in pipe_launch_want(
            mh.PIPE_AXES, mh.PIPE_MICRO).items()}
        pipe = mp_held("gpt_pipe", two, one, o["warm"], want_pipe)
        loops = [m["figures"] for m, _ in
                 mh.results(two, "loop_k2", MP_NPROC)]
        for r, f in enumerate(loops):
            log("multiprocess_loop_k2", {"rank": r, **f})
            if not f["bitwise"] or f["captured"] or not any(
                    "host memory" in x for x in f["safety_reasons"]):
                raise AssertionError(f"multiprocess loop_k2: rank {r}: {f}")
    g40 = par["lm_dp_sp"] if par else {}
    p41 = dist["pipeline"]["pp2_dp2"] if dist else {}
    res = {"card": card_name, "nvidia_smi": smi,
           "processes": MP_NPROC, "positions_per_process": 4,
           "device": "cuda:0", "transport": job_two["transport"],
           "ring_kernels": ring, "parity_f32": parity,
           "gpt_sp": {"mesh": mh.GPT_AXES, "order": "sp-major",
                      "bs": o["bs"], "seq": o["seq"], "dtype": o["dtype"],
                      **gpt,
                      "phase40_single_process": {k: g40[k] for k in (
                          "step_ms", "peak_mem_gb", "launches_per_step",
                          "device_ms_per_step", "device_busy_share")
                          if k in g40}},
           "gpt_pipe": {"mesh": mh.PIPE_AXES, "order": "pp-major",
                        "n_micro": mh.PIPE_MICRO, "dtype": o["dtype"],
                        **pipe,
                        "phase41_pp2_dp2": {k: p41[k] for k in (
                            "step_ms", "peak_mem_gb",
                            "launches_per_step") if k in p41}},
           "loop_k2": loops, "wall_s": {"two": job_two["wall_s"],
                                        "one": job_one["wall_s"]},
           "time_sharing": "the two processes share one card: their step "
                           "times are no speed claim; a hop between them "
                           "is a host round trip, not a link",
           "phase_s": time.monotonic() - t0}
    log("multiprocess", res)
    return res


def multiprocess_launches(mp, case):
    """The launches the processes of a case made, summed, every kernel."""
    out = {k: 0 for k in KERNELS}
    for row in mp[case]["processes"]:
        for k, each in row["launches_each_step"].items():
            out[k] += sum(each)
    return out


def multiprocess_summary(mp):
    """Phase 45's numbers for the summary line."""
    keep = ("step_ms", "peak_mem_gb", "launches_per_step",
            "collectives_per_step", "transport_per_step",
            "device_ms_per_step", "device_busy_share")
    return {
        "card": mp["card"], "nvidia_smi": mp["nvidia_smi"],
        "transport": [i["transport"] for i in mp["transport"]],
        "ring_kernels": [{k: r[k] for k in (
            "dtype", "block", "max_abs_err", "grad_max_rel_err", "tol")}
            for r in mp["ring_kernels"]],
        "parity_f32": {c: {k: r[k] for k in (
            "loss_rel_err", "state_rel_err_max", "bitwise")}
            for c, r in mp["parity_f32"].items()},
        **{case: {"bitwise": mp[case]["bitwise"],
                  "held_steps": mp[case]["held_steps"],
                  "losses": mp[case]["losses"],
                  "processes": [{k: p.get(k) for k in keep}
                                for p in mp[case]["processes"]],
                  "single_process": {k: mp[case]["single_process"].get(k)
                                     for k in keep}}
           for case in ("gpt_sp", "gpt_pipe")},
        "loop_k2_bitwise": all(f["bitwise"] for f in mp["loop_k2"])}


def errs_by_dtype(rows, key="max_abs_err"):
    out = {}
    for r in rows:
        out[r["dtype"]] = max(out.get(r["dtype"], 0.0), r[key])
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, smi = card()
    build()
    fl_rows, fl_sum = flash_phase(dev)
    pg_rows, pg_sum = paged_phase(dev)
    lm, prompts, tokens, arrays, fifo_row = serve_phase(dev, name, smi)
    scope_cpu = cpu_scope(lm, arrays)
    cpu_phase(lm, prompts, tokens, scope_cpu)
    mq_rows, mq_sum = mq_phase(dev)
    v2_row, v2p_row, v2_launch = v2_phase(lm, prompts, tokens, scope_cpu)
    spec_row, spec_launch = spec_phase(lm, prompts)
    tr_rows, tr_sum = train_kernel_phase(dev)
    parity = train_parity_phase()
    bench = train_bench_phase(name, smi)
    rnn_rows = recurrent_kernel_phase(dev)
    lstm_parity = lstm_parity_phase()
    lstm_bench, lstm_infer = lstm_bench_phase(name, smi)
    nmt_parity = nmt_parity_phase()
    nmt_bench = nmt_bench_phase(name, smi)
    bn_rows = bn_kernel_phase(dev)
    top_k_phase(dev)
    v1_v2 = v1_v2_times(bn_rows)
    r50_parity, r50_v2 = resnet50_parity_phase()
    r18_parity = resnet18_parity_phase()
    r50_fused, r50_fused_v2, r50_unfused = resnet_bench_phase(name, smi)
    sl_gpt, sl_ctx = step_loop_gpt_phase(name, smi)
    sl_last = step_loop_last_and_unsafe_phase(sl_ctx)
    sl_feeder = step_loop_feeder_phase(sl_ctx)
    sl_ctx["exe"].close()
    sl_ctx.clear()
    fluid.reset()
    torch.cuda.empty_cache()
    sl_r50 = step_loop_resnet50_phase(name, smi)
    coop = cooperative_capture_probe()
    opts = options_phase(name, smi, sl_gpt)
    gen = generation_phase(dev, name, smi)
    fluid.reset()
    torch.cuda.empty_cache()
    remat_gpt, gpt_ctx = remat_gpt_phase(name, smi, bench)
    with tempfile.TemporaryDirectory() as tmp:
        saved = save_load_phase(gpt_ctx, tmp)
    del gpt_ctx
    fluid.reset()
    torch.cuda.empty_cache()
    r50_remat = resnet_remat_phase(name, smi, r50_fused)
    fluid.reset()
    torch.cuda.empty_cache()
    zoo_cnn = cnn_zoo_phase(name, smi)
    vgg_fused, vgg_kernels, vgg_parity = vgg19_fused_phase(
        dev, name, smi, zoo_cnn["vgg"])
    unet_row = unet_phase(name, smi)
    deepfm_rows = deepfm_phase(name, smi)
    zoo_parity = zoo_parity_phase()
    fluid.reset()
    torch.cuda.empty_cache()
    srl = srl_phase(dev, name, smi)
    srl_big = srl["bench"][SRL_BS[-1]]
    fluid.reset()
    torch.cuda.empty_cache()
    v1_parity, v1_bench = v1_rnn_phase(name, smi)
    ctc = ctc_detection_phase(dev, name, smi)
    new_rows, _ = srl_kernel_phase(dev, [
        ("lstm", V1_RNN["batch_size"], bucket_len(V1_RNN["seq_len"]),
         V1_RNN["hidden"], [V1_RNN["seq_len"]] * V1_RNN["batch_size"]),
        ("gru", CTC_BIG["bs"], ctc["bench"]["T_padded_last"],
         CTC_BIG["hidden"], ctc["bench"]["last_lengths"])])
    fluid.reset()
    torch.cuda.empty_cache()
    router = router_phase(name, smi)
    measurement = measurement_phase(name, smi, sl_gpt["replay_step_ms"])
    par = parallel_phase(dev, name, smi)
    dist = distributed_phase(dev, name, smi)
    book = book_phase(dev, name, smi)
    v2 = v2_api_phase(dev, name, smi)
    deploy = deploy_phase(dev, name, smi)
    mp = multiprocess_phase(name, smi, par, dist)
    ring_launches = {k: sum(r["launches"].get(k, 0) for r in par["ring"])
                     for k in KERNELS}
    by_path = {"fifo": fifo_row["launches"], "v2": v2_launch,
               "v2_prefix": v2p_row["launches"], "spec": spec_launch,
               "train_f32_per_step": parity["launches_per_step"],
               "train_bf16_10_steps": bench["launches"],
               "lstm_f32_per_step": lstm_parity["launches_per_step"],
               "lstm_bf16_10_steps": lstm_bench["launches"],
               "lstm_infer": lstm_infer["launches"],
               "nmt_f32_per_step": nmt_parity["launches_per_step"],
               "nmt_f32_10_steps": nmt_bench["launches"],
               "resnet50_f32_per_step": r50_parity["launches_per_step"],
               "resnet50_v2_f32_3_steps": r50_v2["launches"],
               "resnet18_f32_per_step": r18_parity["launches_per_step"],
               "resnet50_bf16_10_steps": r50_fused["launches"],
               "resnet50_v2_bf16_10_steps": r50_fused_v2["launches"],
               "resnet50_unfused_bf16_10_steps": r50_unfused["launches"],
               "gpt_options_bf16_10_steps":
                   opts["gpt_bench_bf16"]["launches_10_steps"],
               "gpt_generate_f32": gen["greedy"]["launches"],
               "gpt_generate_bf16_per_call":
                   gen["bench_bf16"]["launches_per_call"],
               "gpt_beam_and_greedy_f32": gen["beam"][0]["launches"],
               "nmt_generate": gen["nmt"]["launches"],
               "nmt_generate_composable": gen["nmt"]["composable_launches"],
               "gpt_remat_bf16_per_step":
                   remat_gpt["remat"]["launches_per_step"],
               "gpt_remat_dropout_bf16_per_step":
                   remat_gpt["remat_dropout"]["launches_per_step"],
               "gpt_remat_captured_k4":
                   remat_gpt["remat_captured"]["launches_at_capture"],
               "gpt_loaded_inference_forward": saved["loaded_launches"],
               "resnet50_remat_f32_per_step":
                   r50_remat["f32_parity"]["launches_remat"],
               "resnet50_remat_bf16_per_step":
                   r50_remat["train_bf16"]["launches_per_step"],
               "vgg19_fused_bf16_per_step": vgg_fused["launches_per_step"],
               "vgg19_fused_f32_parity_step": vgg_parity["launches_fused"],
               "srl_f32_per_step": srl_big["launches_per_step"],
               "srl_infer": srl_big["infer"]["launches"],
               "v1_rnn_small_f32_per_step": v1_parity["launches_per_step"],
               "v1_rnn_small_train_pass": v1_parity["train_pass_launches"],
               "v1_rnn_small_test": v1_parity["test_launches"],
               "v1_rnn_f32_20_steps": v1_bench["launches"],
               "v1_rnn_test": v1_bench["test_launches"],
               "ctc_small_f32_per_step": ctc["parity"]["launches_per_step"],
               "ctc_f32_per_step": ctc["bench"]["launches_per_step"],
               "ctc_infer": ctc["bench"]["infer_launches"],
               "v2_wide_router_phase": router["wide"]["launches"],
               "router_two_replicas": router["router"]["launches"],
               "gpt_verified_train_step_f32":
                   router["verify_lint"]["launches"],
               "gpt_bf16_attributed_3_steps":
                   measurement["attribution"]["launches"],
               "v2_metrics_serve": measurement["serve_v2"]["launches"],
               "lm_dp_sp_bf16_10_steps": par["lm_dp_sp"]["launches"],
               "ring_schedules_18_calls": ring_launches,
               "mesh_sp_ring_f32_per_step":
                   par["parity_f32"]["sp_ring"]["launches_per_step"],
               "gpt_pp4_bf16_10_steps": dist["pipeline"]["pp4"]["launches"],
               "gpt_pp2_dp2_bf16_10_steps":
                   dist["pipeline"]["pp2_dp2"]["launches"],
               "gpt_pserver_f32_3_steps":
                   dist["pserver_gpt_f32"]["launches"],
               **{f"book_{n}_f32_per_step": r["launches_per_step"]
                  for n, r in book["chapters"].items()},
               "v2_sentiment_f32_per_step":
                   v2["sentiment"]["launches_per_step"],
               "v2_sentiment_infer": v2["sentiment"]["infer_launches"],
               "v2_sequence_generator": v2["beam"]["launches"],
               "capi_engine_gpt_forward": deploy["engine"]["launches"],
               "build_callable_gpt_forward":
                   deploy["build_callable"]["launches"],
               "gpt_sp_major_two_processes_bf16_12_steps":
                   multiprocess_launches(mp, "gpt_sp"),
               "gpt_pp2_dp2_two_processes_bf16_7_steps":
                   multiprocess_launches(mp, "gpt_pipe")}
    csrc = "paddle_tpu_torch/ops/cuda_kernels/csrc/"
    pallas = "paddle_tpu/ops/pallas_kernels/"

    def paths(kernel):
        return {p: c[kernel] for p, c in by_path.items()}

    kernels = [
        {**summary_row("flash_attention", csrc + "flash_attention.cu",
                       pallas + "flash_attention.py:213", fl_sum,
                       errs_by_dtype(fl_rows),
                       fifo_row["launches"]["flash_attention"],
                       paths("flash_attention")),
         **{k: fl_sum[k] for k in ("design", "vs_library", "bound_share")},
         "generation_prefill": [r for r in gen["flash_rows"]
                                if "kernel_ms" in r],
         "generation_max_abs_err_by_dtype": errs_by_dtype(
             gen["flash_rows"])},
        summary_row("paged_attention", csrc + "paged_attention.cu",
                    pallas + "paged_attention.py:177", pg_sum,
                    errs_by_dtype(pg_rows),
                    fifo_row["launches"]["paged_attention"],
                    paths("paged_attention")),
        summary_row("paged_attention_mq", csrc + "paged_attention_mq.cu",
                    pallas + "paged_attention.py:284", mq_sum["mixed"],
                    errs_by_dtype(mq_rows),
                    v2_launch["paged_attention_mq"],
                    paths("paged_attention_mq")),
    ]
    # K2 and K3: every case and dtype, warm and cold, beside the bound
    for row, timed in ((kernels[1], pg_rows), (kernels[2], mq_rows)):
        row["design"] = {r["dtype"]: r["design"] for r in timed}
        row["cases"] = [{k: r[k] for k in (
            "case", "shape", "dtype", "kernel_ms", "kernel_cold_ms",
            "cold_pools", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "bound_share_cold", "max_abs_err") if k in r}
            for r in timed]
    for kname, replaces, err_key in (
            ("flash_attention_fwd", "flash_attention.py:342", "max_abs_err"),
            ("flash_attention_dq", "flash_attention.py:235", "max_rel_err"),
            ("flash_attention_dkv", "flash_attention.py:286",
             "max_rel_err")):
        src = "flash_attention.cu" if kname == "flash_attention_fwd" \
            else "flash_attention_bwd.cu"
        row = summary_row(kname, csrc + src, pallas + replaces,
                          tr_sum[kname], errs_by_dtype(tr_rows[kname],
                                                       err_key),
                          bench["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row.update({k: tr_sum[kname][k]
                    for k in ("design", "vs_library", "bound_share")})
        row["f32_bench_shape"] = {
            k: v for k, v in tr_rows[kname][0].items() if k in (
                "design", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "vs_library", "bound_share", "max_abs_err")}
        kernels.append(row)
    # K7-K10: the row of the dtype the main path runs (the LSTM bench in
    # bf16, the NMT bench in f32), the other dtype's numbers beside it
    for kname, replaces, main_dt, other_dt, run in (
            ("lstm_forward", "lstm.py:72", torch.bfloat16, torch.float32,
             lstm_bench),
            ("lstm_backward", "lstm.py:236", torch.bfloat16, torch.float32,
             lstm_bench),
            ("gru_forward", "gru.py:60", torch.float32, torch.bfloat16,
             nmt_bench),
            ("gru_backward", "gru.py:159", torch.float32, torch.bfloat16,
             nmt_bench)):
        err_key = "max_rel_err" if kname.endswith("backward") \
            else "max_abs_err"
        main_row = timed_row(rnn_rows[kname], main_dt)
        # the source is that of the body the timed row ran
        cell = kname.split("_")[0]
        steps_src = f"{cell}.cu"
        src = f"{cell}_persistent.cuh" if main_row["route"] == "persistent" \
            else steps_src
        row = summary_row(kname, csrc + src, pallas + replaces, main_row,
                          errs_by_dtype(rnn_rows[kname], err_key),
                          run["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row["library_ms_is"] = NO_LIBRARY
        row["bound_ignores"] = "the dependence between the T steps"
        # "route" stays "cuda": the contract's word for the language; the
        # body and its device launches are the library's count
        row.update({"body": main_row["route"],
                    "device_launches": main_row["device_launches"],
                    "steps_route_source": csrc + steps_src})
        other = timed_row(rnn_rows[kname], other_dt)
        row["other_dtype_bench_shape"] = {
            k: other[k] for k in ("dtype", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by", "max_abs_err")}
        if srl["kernel_rows"][kname]:
            row["srl_shapes"] = [
                {**{k: r[k] for k in (
                    "B", "T", "H", "valid_steps", "route", "device_launches",
                    "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_share") if k in r},
                 "max_err": r.get("max_abs_err", r.get("max_rel_err")),
                 "launches_per_step": r["launches_per_step"]}
                for r in srl["kernel_rows"][kname]]
        # the same at the shapes of the v1 RNN config (K7, K8) and of the
        # CTC program (K9, K10), with their paths' launches a step
        step = (v1_bench["launches_per_step"] if cell == "lstm"
                else ctc["bench"]["launches_per_step"])
        row["v1_ctc_shapes"] = [
            {**{k: r[k] for k in (
                "B", "T", "H", "valid_steps", "route", "device_launches",
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share") if k in r},
             "max_err": r.get("max_abs_err", r.get("max_rel_err")),
             "launches_per_step": step[kname]}
            for r in new_rows[kname]]
        kernels.append(row)
    # K11-K15: the bf16 row (the bench's dtype) at the timed shape, the
    # f32 row beside it; K14's launches are the v2 bench run's
    for kname, src, replaces in (
            ("bn_matmul_fwd", "bn_matmul.cu", "bn_matmul.py:161"),
            ("bn_matmul_bwd", "bn_matmul.cu", "bn_matmul.py:195"),
            ("bn_conv3x3_fwd", "bn_conv.cu", "bn_conv.py:352"),
            ("bn_conv3x3_fwd_v2", "bn_conv.cu", "bn_conv.py:181"),
            ("bn_conv3x3_bwd", "bn_conv.cu", "bn_conv.py:386")):
        err_key = "max_rel_err"
        run = r50_fused_v2 if kname == "bn_conv3x3_fwd_v2" else r50_fused
        main_row = timed_row(bn_rows[kname], torch.bfloat16)
        row = summary_row(kname, csrc + src, pallas + replaces, main_row,
                          errs_by_dtype(bn_rows[kname], err_key),
                          run["launches"][kname], paths(kname))
        row["max_err_by_dtype_is"] = err_key
        row["library_ms_is"] = BN_NO_LIBRARY
        row["design"] = main_row["design"]
        row["shape"] = {k: main_row[k] for k in (
            "dtype", "kind", "N", "H", "W", "K", "O", "stride", "residual")}
        other = timed_row(bn_rows[kname], torch.float32)
        row["other_dtype_bench_shape"] = {
            k: other[k] for k in ("dtype", "design", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by",
                                  "bound_cuda_cores_ms", "max_abs_err")
            if k in other}
        if kname == "bn_conv3x3_fwd_v2":
            row["v1_vs_v2_by_shape"] = v1_v2
        if kname in ("bn_conv3x3_fwd", "bn_conv3x3_bwd"):
            row["vgg19_shapes"] = [
                {k: r[k] for k in ("N", "H", "W", "K", "O", "fused_ops",
                                   "kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by", "bound_share", "max_rel_err")}
                for r in vgg_kernels if r["kernel"] == kname]
        kernels.append(row)
    # the tuned axes of phase 39: K2's page sizes, K14's O blocks
    kernels[1]["tuned_page_sizes"] = measurement["tune"]["paged_decode"]
    next(k for k in kernels if k["name"] == "bn_conv3x3_fwd_v2")[
        "tuned_block_o"] = [
        t for t in measurement["tune"]["bn_conv"]["trials"]
        if t["variant"] == "v2"]
    kernels[2]["verify_shape"] = {
        k: mq_sum["verify"][k] for k in ("kernel_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")}
    serve_rows = [{k: r[k] for k in (
        "scheduler", "requests", "ttft_p50_ms", "prefill_tok_s",
        "decode_tok_s", "output_tok_s", "steps", "mixed_steps",
        "decode_steps", "spec_rounds", "launches")}
        for r in (fifo_row, v2_row, spec_row)]
    train_rows = [
        {"run": "parity_f32", **{k: parity[k] for k in (
            "bs", "seq", "gpu_losses", "cpu_losses", "loss_rel_err",
            "grad_rel_err_step1", "launches_per_step")}},
        {"run": "bench_bf16", **{k: bench[k] for k in (
            "bs", "seq", "losses", "step_ms", "tok_s", "peak_mem_gb",
            "launches_per_step")}}]
    parity_keys = ("bs", "seq", "gpu_losses", "cpu_losses", "loss_rel_err",
                   "grad_rel_err_step1", "launches_per_step")
    bench_keys = ("bs", "seq", "dtype", "losses", "step_ms", "seq_s",
                  "tok_s", "peak_mem_gb", "launches_per_step")
    train_rows += [
        {"run": "lstm_parity_f32", **{k: lstm_parity[k]
                                      for k in parity_keys}},
        {"run": "lstm_bench_bf16", **{k: lstm_bench[k] for k in bench_keys},
         "ragged_losses": lstm_bench["ragged_losses"]},
        {"run": "lstm_infer_bf16", **lstm_infer},
        {"run": "nmt_parity_f32", **{k: nmt_parity[k] for k in parity_keys}},
        {"run": "nmt_bench_f32", **{k: nmt_bench[k] for k in bench_keys}},
        {"run": "resnet50_parity_f32",
         **{k: r50_parity[k] for k in parity_keys if k != "seq"},
         "image": r50_parity["image"],
         "state_rel_err_max": r50_parity["state_rel_err_max"],
         "v2_loss_rel_err_vs_v1": r50_v2["loss_rel_err_vs_v1"],
         "v2_launches_per_step": r50_v2["launches_per_step"]},
        {"run": "resnet18_parity_f32",
         **{k: r18_parity[k] for k in parity_keys if k != "seq"},
         "image": r18_parity["image"],
         "state_rel_err_max": r18_parity["state_rel_err_max"]}]
    resnet_keys = ("fused", "bs", "image", "dtype", "losses", "step_ms",
                   "img_s", "peak_mem_gb", "launches_per_step")
    train_rows += [{"run": run, **{k: r[k] for k in resnet_keys}}
                   for run, r in (("resnet50_bench_bf16", r50_fused),
                                  ("resnet50_bench_bf16_v2", r50_fused_v2),
                                  ("resnet50_bench_bf16_unfused",
                                   r50_unfused))]
    loop_keys = ("k", "replay_vs_eager", "eager_spread",
                 "launches_at_capture", "eager_step_ms", "replay_step_ms",
                 "replay_speedup", "peak_mem_gb_eager", "peak_mem_gb_replay",
                 "reserved_gb", "pool_gb")
    step_loop_rows = [
        {"phase": "step_loop_gpt", "dtype": "bfloat16", "bs": TRAIN_BS,
         "seq": TRAIN_SEQ, **{k: sl_gpt[k] for k in loop_keys},
         "tok_s_eager": sl_gpt["tok_s_eager"],
         "tok_s_replay": sl_gpt["tok_s_replay"],
         "f32_parity": {k: sl_gpt["f32_parity"][k] for k in (
             "bs", "seq", "replay_vs_eager", "eager_spread",
             "launches_at_capture")}},
        {"phase": "step_loop_resnet50", "dtype": resnet_bench.DTYPE,
         "bs": resnet_bench.BS, **{k: sl_r50[k] for k in loop_keys},
         "img_s_eager": sl_r50["img_s_eager"],
         "img_s_replay": sl_r50["img_s_replay"]},
        {"phase": "step_loop_last_and_unsafe", **sl_last},
        {"phase": "step_loop_feeder", **{k: sl_feeder[k] for k in (
            "dispatches", "k", "feeder_vs_numpy", "spread_8_steps")}},
        {"phase": "step_loop_cooperative_probe", **coop}]
    ob = opts["gpt_bench_bf16"]
    options_rows = {
        "gpt_parity_f32": {k: opts["gpt_parity_f32"][k] for k in (
            "bs", "seq", "gpu_losses", "cpu_losses", "loss_rel_err",
            "grad_rel_err_step1", "launches_per_step", "lr_step1")},
        "gpt_bench_bf16": {k: ob[k] for k in (
            "bs", "seq", "k", "params", "ops", "eager_losses",
            "replay_vs_eager", "eager_spread_12_steps",
            "launches_at_capture", "eager_step_ms", "replay_step_ms",
            "plain_adam_eager_step_ms", "plain_adam_replay_step_ms",
            "peak_mem_gb_eager", "plain_adam_peak_mem_gb_eager",
            "tok_s_eager", "tok_s_replay")},
        "mlp_every_class": {n: {k: r[k] for k in ("loss_rel",
                                                   "state_rel_max")}
                            for n, r in opts["mlp_every_class"][
                                "classes"].items()},
        "model_average": opts["model_average"],
        "book": {"fit_a_line_last_loss":
                 opts["book"]["fit_a_line"]["losses_by_epoch"][-1],
                 "conv_loss_rel_err": opts["book"][
                     "recognize_digits_conv"]["loss_rel_err"]},
        "print": opts["print"]}
    gb, nmt = gen["bench_bf16"], gen["nmt"]
    generate_rows = {
        "gpt_greedy_f32": {k: gen["greedy"][k] for k in (
            "bs", "P", "G", "identical", "of", "parted",
            "teacher_forcing_max_gap")},
        "gpt_bench_bf16": {k: gb[k] for k in (
            "bs", "P", "G", "wall_ms", "tok_s", "tok_s_best", "ms_per_step",
            "peak_mem_gb", "launches_per_call", "host_syncs_in_op")
            if k in gb},
        "gpt_bench_bf16_profile": {k: gb[k] for k in (
            "device_busy_share", "k1_device_ms", "k1_share_of_device",
            "wall_ms_profiled", "profiled") if k in gb},
        "gpt_beam_f32": [{k: r[k] for k in (
            "eos", "card_vs_cpu", "best_lane_scores",
            "best_lane_tower_logprob", "greedy_logprob",
            "best_at_least_greedy")} for r in gen["beam"]],
        "gpt_sampling": gen["sampling"],
        "nmt": {k: nmt[k] for k in (
            "bs", "src", "beam", "max_len", "card_vs_cpu",
            "composable_vs_generate", "wall_ms", "composable_wall_ms",
            "launches")},
        "control_flow": gen["control_flow"]}
    rg, r5 = remat_gpt, r50_remat
    remat_rows = {
        "gpt_remat_f32_parity": {k: rg["f32_parity"][k] for k in (
            "loss_rel", "grad_rel_step1")},
        "gpt_bf16": {
            "plain_eager_step_ms": rg["plain_eager_step_ms"],
            "plain_peak_mem_gb": rg["plain_peak_mem_gb"],
            **{f"{run}_{k}": rg[run][k] for run in ("remat", "remat_dropout")
               for k in ("step_ms", "peak_mem_gb", "launches_per_step")},
            "remat_replay_step_ms": rg["remat_captured"]["replay_step_ms"],
            "remat_replay_vs_eager": rg["remat_captured"]["replay_vs_eager"],
            "dropout_k_dispatch_ms_a_step":
                rg["dropout_k_dispatch"]["ms_a_step"],
            "profiled_flash_launches_per_step":
                rg["profiled_flash_launches_per_step"]},
        "save_load": {k: saved[k] for k in (
            "resumed_step_bitwise", "loaded_equals_live_bitwise",
            "loaded_launches", "model_bytes")},
        "resnet50": {
            "remat_f32_parity": {k: r5["f32_parity"][k] for k in (
                "loss_rel", "fc_grad_rel", "stats_rel")},
            "remat_bf16": {k: r5["train_bf16"][k] for k in (
                "step_ms", "img_s", "peak_mem_gb", "launches_per_step",
                "no_remat_step_ms", "no_remat_peak_mem_gb")},
            "infer_fold": {dt: {k: row[k] for k in (
                "bs", "folded", "logits_rel_max",
                "logits_rel_norm_to_f32_unfolded", "prob_max_abs_diff",
                "top1_agree", "fold_speedup")} | {
                "img_s_folded": row["folded_rates"]["img_s_median"],
                "img_s_unfolded": row["unfolded"]["img_s_median"]}
                for dt, row in r5["infer"].items()}}}
    zoo_keys = ("model", "fused", "bs", "batch_cut", "image", "dtype",
                "losses", "step_ms", "step_ms_min", "step_ms_max", "img_s",
                "img_s_min", "img_s_max", "peak_mem_gb", "fused_ops",
                "launches_per_step")
    par_keys = ("bs", "image", "gpu_losses", "cpu_losses", "loss_rel_err",
                "grad_rel_err_step1", "test_mode_logits_rel",
                "grads_vs_f64_norm", "state_rel_err_max")
    zoo_rows = {
        "card": name, "nvidia_smi": smi,
        "cnn_bench_bf16": {m: {k: r[k] for k in zoo_keys}
                           for m, r in zoo_cnn.items()},
        "vgg19_fused_bf16": {**{k: vgg_fused[k] for k in zoo_keys},
                             "vs_unfused": vgg_fused["vs_unfused"]},
        "vgg19_fused_f32_parity": {k: vgg_parity[k] for k in (
            "loss_rel", "fc_grad_rel", "stats_rel", "launches_fused")},
        "unet_bench_f32": {k: unet_row[k] for k in (
            "bs", "image", "base_ch", "losses", "step_ms", "img_s",
            "peak_mem_gb", "k", "replay_vs_eager", "eager_spread",
            "eager_step_ms", "replay_step_ms", "img_s_eager",
            "img_s_replay", "replay_speedup", "pool_gb", "ddim")},
        "deepfm": {"ctr_parity": {k: deepfm_rows["ctr_parity"][k] for k in (
                       "steps", "forced_loss_rel_err_max",
                       "grad_rel_err_step1", "free_vs_cpu", "vs_f64",
                       "fall")},
                   "criteo_bench": {k: deepfm_rows["criteo_bench"][k]
                                    for k in ("bs", "fields", "vocab",
                                              "params", "step_ms", "rows_s",
                                              "peak_mem_gb")}},
        "parity_f32": {m: {k: r[k] for k in par_keys if k in r}
                       for m, r in zoo_parity.items()}}
    srl_keys = ("bs", "T_padded", "losses", "step_ms_median", "step_ms_min",
                "step_ms_max", "sent_s", "tok_s", "peak_mem_gb",
                "launches_per_step", "device_busy_share",
                "device_kernels_per_step", "k7_device_ms_per_step",
                "k8_device_ms_per_step", "chunk_eval_after_timed_steps",
                "infer", "profiled")
    srl_rows = {
        "card": name, "nvidia_smi": smi,
        "parity_f32": {k: {f: r[f] for f in (
            "loss_rel_err", "grad_rel_err_step1_max",
            "paths_and_counts_equal", "launches_per_step")}
            for k, r in srl["parity"].items()},
        "lstm_directions": srl["directions"],
        "bench_f32": {bs: {k: r[k] for k in srl_keys if k in r}
                      for bs, r in srl["bench"].items()}}
    v1_keys = ("cli_ms_per_batch_median", "cli_ms_per_batch_min",
               "cli_ms_per_batch_max", "cli_tok_s", "in_process_ms_per_batch",
               "T_padded", "params", "peak_mem_gb", "launches_per_step",
               "device_busy_share", "device_kernels_per_step",
               "k7_device_ms_per_step", "k8_device_ms_per_step", "profiled",
               "test_launches")
    legacy_rows = {
        "card": name, "nvidia_smi": smi,
        "v1_rnn_small_f32": {k: v1_parity[k] for k in (
            "loss_rel_err", "grad_rel_err_step1", "launches_per_step",
            "train_pass_launches", "test_launches")},
        "v1_rnn_full_f32": {k: v1_bench[k] for k in v1_keys
                            if k in v1_bench},
        "ctc_small_f32": {k: ctc["parity"][k] for k in (
            "loss_rel_err", "grad_rel_err_step1", "launches_per_step")},
        "ctc_f32": {k: ctc["bench"][k] for k in (
            "bs", "T_padded", "params", "losses", "step_ms_median",
            "step_ms_min", "step_ms_max", "frames_s", "launches_per_step",
            "infer_launches", "decode_card_equals_cpu",
            "greedy_edit_distance_mean", "device_busy_share",
            "device_kernels_per_step", "k9_device_ms_per_step",
            "k10_device_ms_per_step", "profiled") if k in ctc["bench"]},
        "ops_card_vs_cpu": ctc["ops"], "detection_map": ctc["map"]}
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "serve": serve_rows,
                      "train": train_rows, "step_loop": step_loop_rows,
                      "options": options_rows, "generate": generate_rows,
                      "remat_save_load": remat_rows, "zoo": zoo_rows,
                      "srl": srl_rows, "legacy": legacy_rows,
                      "router": router, "measurement": measurement,
                      "parallel": parallel_summary(par, name, smi),
                      "distributed": distributed_summary(dist),
                      "book": book_summary(book),
                      "v2": v2_api_summary(v2),
                      "deploy": deploy,
                      "multiprocess": multiprocess_summary(mp)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
