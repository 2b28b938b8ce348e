#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

  python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

  device    the card's name and power limit (nvidia-smi), versions; TF32
            off for matmul and cuDNN, so float32 is compared in float32
  build     nvcc builds every kernel of the port from src/repro_torch/
            kernels/csrc, one nvcc per source, all started together
            (ptxas register and spill report printed)
  kernel    the conv kernel against its plain PyTorch version on the card
            at every shape the main path gives it, the launcher world's
            scorer buckets among them (and a ragged and a small
            one, and shapes that cross the float32 kernel's tile edges), in
            float32 and bfloat16; with NaN and +-inf in the inputs at B=256
            (NaN positions equal, +-inf giving +-1); each route's design
            stage, registers, spills, shared memory and blocks resident on
            an SM; then its time from CUDA events, the plain version's, one
            PyTorch library call's as a yardstick, and the bound the card's
            data-sheet rates put on the same work (repro_torch.roofline: a
            float32 product at the 3xTF32 rate, 495/3 TFLOP/s)
  pipeline  the paper's system at the full width of sm-cnn (weights from
            --seed): Retrieve(h=20) >> Rerank("pallas") % 10 planned on the
            card through PlanContext + plan, `local` on 32 queries and
            `batched` on 256; the kernel's launch counter is set to 0 just
            before and read just after, and must show 2 launches per pallas
            scorer call; then local == batched (verify_plans), pallas ==
            eager rankings, pallas scores == a CPU eager scorer, q/s, p50,
            p99, per-stage spans and the device's busy share of one batch;
            the pallas scorer at bucket 256 timed and read against its bound
  backends  the paper's integration strategies (its Table 1) at the full
            width of sm-cnn, same weights and corpus: for each of eager, jit,
            aot, numpy, pallas and artifact over buckets (1, 8, 64, 256),
            make_scorer's build seconds; each bucket's scores against eager
            on the card (rtol 1e-4, atol 1e-5); p50/p99 of each bucket's
            scorer call (host clock, as Scorer times it) and rows/s; the
            conv kernel's launch counter over the timed calls (2 a call for
            pallas, 0 for the others); jit compiles one program a bucket and
            never again, aot and artifact nothing after make_scorer
            (dynamo's graph counter and the scorer's own), aot replays one
            CUDA graph a call. Then Retrieve(h=20) >> Rerank(backend) % 10
            through both plans: batched q/s over the first 64 questions,
            local p50/p99 over 32, nothing compiled while timed, the top 10
            against eager's (neighbours may swap only where eager's scores
            are within 2e-5; the swaps are counted)
  service   the paper's service strategy (its Table 2) on the card, with the
            backends phase's scorers: 300 get_score RPCs from one client to
            a SimpleServer over a QuestionAnsweringHandler for pallas, jit,
            aot and numpy (q/s, p50/p99, the overhead: RPC p50 less the
            same handler's in-process p50 in the same run, and less the
            backends phase's bucket-1 scorer p50); every RPC score
            against the same handler in process (rtol 1e-4, atol 1e-5); the
            conv's launch counter set to 0 before and read after: 2 a pallas
            RPC, 0 for the others; each backend again behind a
            ThreadPoolServer under 8 client threads, each with pairs of its
            own, every reply against its pair's score in process (a scorer
            that mixed concurrent calls up would answer with another
            client's score); then a ServingEngine (max_batch 64,
            max_wait 1 ms) behind a ThreadPoolServer under 8 client threads
            (q/s, p50/p99, mean batch); Retrieve(h=20) >> Rerank("pallas")
            % 10 planned local, remote (a ThreadPoolServer over a handler)
            and remote_pipeline (a ThreadPoolServer over a PipelineEngine)
            ranking 64 questions alike (verify_plans); a past deadline shed
            as ShedError; a drain reaching 0 in flight
  launch    the serving launcher's stack (repro_torch.launch, training,
            serving.cluster/rollout/fabric) on the card: full-width sm-cnn
            trained 60 steps of batch 64 (Trainer + adamw) on the pipeline
            phase's corpus, the loss falling, the trained weights served by
            pallas == eager (rtol 1e-4, atol 1e-5), a checkpoint written
            from the card restored on the CPU bit-equal and published to a
            registry, build_world()'s seconds; ReplicaPools of 2 pallas and
            2 aot replicas behind a ThreadPoolServer under 8 client threads
            with pairs of their own, every reply against its pair's eager
            score in process, the conv launched 2 times a pallas scorer
            call (counter set to 0 before, read after), q/s and p50/p99
            beside the service phase's one-scorer rows; ShadowEngine and
            ABEngine between the seed and the trained registry versions,
            every reply the ranking of the version its arm names, and
            RolloutController.hot_swap through MSG_SWAP on a live server
            (a NaN version rolled back, the trained one landed); python -m
            repro_torch.launch.serve --describe --device cuda --backend
            pallas (aot's compiles are the backends phase's), then a
            --serve-pipeline --server threadpool --backend pallas server
            ranked through Client.rank_batch and drained with --drain; the
            launcher's world published to a registry and served by one
            in-process ThreadPoolServer, then by Fabric(n_workers=1) and
            Fabric(n_workers=4) (pallas on the card), each worker's and
            every router reply's rankings == the in-process pallas plan on
            that version, q/s and p50/p99 under 8 client threads, start-up
            seconds
  attn-kernel  the causal GQA attention kernel against its plain version
            at qwen3-0.6b's H=16, Hkv=8, d=128 for (B, S) from (1, 1) to
            (1, 4096), float32 and bfloat16 (randn inputs), by max absolute
            error and by the error's norm over the output's; then at the LM
            phase's prefills (8 x 2048 both types, 1 x 32768 bfloat16): the
            same checks (at 32768 on the first and last 256 query rows
            against all keys, where the plain version's full scores would
            not fit), SDPA as a yardstick held against the kernel, times of
            the kernel, the plain version where it fits and SDPA, the bound;
            bfloat16 also at B=2 for S around the 64-key tiles (63 .. 191),
            where a tile crosses the diagonal; first each route's design
            stage (bfloat16: wgmma; float32: 3xTF32 wgmma), registers,
            spills, shared memory and blocks resident on an SM
  lm-check  the LM path in float32 against itself: prefill through the
            kernel ("flash") == plain torch ("chunked"), logits and cache;
            decode at position S == forward over S+1 tokens
  lm        qwen3-0.6b at full width in bfloat16 (weights from --seed,
            tokens from data/lm.py): prefill 8 x 2048, 32 greedy decode
            steps on the copied cache, prefill 1 x 32768; the attention
            kernel's launch counter is set to 0 just before and read just
            after, and must show 28 launches per prefill and none in
            decode; prefill tokens/s, decode ms per step, busy shares and
            the attention kernel's share of a prefill's device time; the
            8 x 2048 prefill read against its bound
  lm-moe-check  deepseek-moe-16b (MHA: the attention kernel at G=1) on the
            card, full width cut to 2 layers where a model runs: (a) the
            kernel against its plain version at H=16, Hkv=16, d=128 for
            (2, 130) and (8, 2048), float32 and bfloat16, and on the first
            and last 256 query rows of lm-moe's 1 x 32768 and lm-moonshot's
            1 x 16384 prefills in bfloat16, then its times at
            8 x 2048 bfloat16 with the plain version's, SDPA's and the
            bound; (b) moe_apply against the dense mixture (every expert on
            every token) at capacity factor 16, float32 and float64, and
            route's ties going to the lower expert index as on the CPU; (c)
            one group of 2048 tokens at the config's capacity factor 1.25:
            the output equals the dense mixture over the kept (token,
            choice) pairs only, a token with every choice dropped gets
            zero, the drop share; (d) float64 with plain attention at
            capacity 16: decode at position S after a prefill of S == forward
            over S+1 tokens (rtol=atol=2e-2); (e) the int8 KV cache's
            quantize and dequantize on the card == on the CPU, bit for bit,
            bfloat16 and float32; (f) (d)'s model with the prefill's cache
            quantized to int8 and decode under kv_quant == forward (top-1
            identical, atol 0.15: tests/test_arch_smoke.py's bound); TF32
            must be off
  lm-moe    deepseek-moe-16b at full width in bfloat16 (33.76 GB of weights
            from --seed), the lm phase's schedule and checks: init_lm's
            seconds and peak, prefill 8 x 2048 (28 attention launches
            each), 32 greedy decode steps (none), prefill 1 x 32768; the
            8 x 2048 prefill read against its bound with its dropped
            (token, choice) pairs counted; then, as the JAX launcher serves
            a model past 5e9 parameters, the int8 KV cache at decode_32k's
            32,768 positions: B=8, the 8 x 2048 prefill's cache quantized
            into its first 2048 positions, 32 greedy steps (no attention
            launch), each reading and masking all 32,768 positions; step
            ms, tokens/s, the cache's GB, peak, busy share, the greedy
            tokens that equal the bf16 decode's, the step's roofline at
            decode_32k (B=8) and its share of the int8 cache's own bytes
  lm-moonshot  moonshot-v1-16b-a3b at full width in bfloat16 (57.78 GB of
            weights, 48 layers, deepseek's widths), lm-moe's schedule and
            checks with the long prefill cut to 1 x 16384 and the int8
            decode at B=2 (MOE_LM_RUNS), whose peak must leave 4 GB of the
            card unreserved
  attn-d64  the bfloat16 attention kernel at head width 64 (granite-3-2b's
            H=32, Hkv=8) against its plain version: attn-kernel's shapes
            and diagonal lengths, G = 1, 2, 4, 8 at S from 1 to 257 around
            the 64-key tiles, 8 x 2048 and the first and last 256 query
            rows of 1 x 32768 (bfloat16 tolerances); the d=64 route's
            registers, spills and shared memory; a float32 call at d=64,
            with or without the gradient, raises ValueError with no launch
            (float32 is not compiled at that width); times at 8 x 2048 and
            1 x 32768 beside the plain version (8 x 2048), SDPA and the bound
  lm-granite-check  granite-3-2b at full width cut to 2 layers, bfloat16:
            prefill through the d=64 kernel (2 launches) == chunked plain
            torch at (2, 130), logits and cache; decode at position S ==
            forward over S+1 tokens; top-1 tokens equal, the padded
            vocabulary masked, no lm_head (tied embeddings)
  lm-granite  granite-3-2b at full width in bfloat16 (5.07 GB of weights,
            40 layers, d_head 64), the lm phase's schedule and checks:
            prefill 8 x 2048 with its bound, 32 greedy decode steps,
            prefill 1 x 32768; 40 attention launches a prefill, none in
            decode (its 2.5e9 parameters are under KV_QUANT_PARAMS, so the
            bfloat16 cache)
  attn-g7   the attention kernel at group sizes that are not powers of two
            (the forward pads G to the next one and never stores the idle
            rows), both routes at d=128 against the plain version: G = 3,
            5, 6, 7 over deepseek-coder-33b's 8 KV heads for B=2 and S from
            1 to 257 around the 16-position blocks and 64-key tiles, then at
            coder's H=56, Hkv=8 at 8 x 2048 (both types) and on the first
            and last 256 query rows of lm-coder's long prefill (bfloat16);
            each launch writes into a buffer filled with NaN one position's
            rows wider on each side: every output element written, none
            around it; a float32 NaN-free Q beside an inf in the next
            group's first head (loaded into this group's idle rows) stays
            finite; a call past 128 query heads a KV head raises with no
            launch, with or without the gradient; times at 8 x 2048 in both
            types beside the plain version, SDPA (GQA) and the bound
  lm-coder-check  deepseek-coder-33b at full width cut to 2 layers,
            bfloat16: lm-granite-check's (a) and (b) through the kernel at
            G=7, untied lm_head; (c) decode at position S on the int8 cache
            (the prefill's cache quantized) against the bfloat16 decode at
            INT8_ATOL
  lm-coder  deepseek-coder-33b at full width in bfloat16 (66.68 GB of
            weights, 62 layers, G=7), the lm phase's schedule and checks:
            prefill 8 x 2048 with its bound (62 attention launches each),
            32 greedy decode steps, the long prefill cut to 1 x CODER_LONG
            (at 32768 its cache and working memory would not fit beside the
            weights and the decode cache), then the int8 decode at
            decode_32k's 32,768 positions at CODER_INT8_ROWS rows, whose
            peak must leave 4 GB of the card unreserved
  attn-bwd  the attention's backward kernel (csrc/flash_attention_bwd.cu)
            against the plain backward at qwen3-0.6b's H=16, Hkv=8, d=128,
            float32 and bfloat16 (randn inputs and incoming gradient), for
            (B, S) from (1, 1) to (1, 1024) and S around the 64-key and
            64-row tiles and the bfloat16 kernels' 128-key and 128-row
            blocks (63 .. 257): dq, dk, dv by max absolute error (atol +
            rtol |want|) and by the error's norm; the forward kernel's lse
            against the plain lse; each backward kernel's registers,
            spills, shared memory and blocks resident on an SM; times at
            B=4 and B=8 x 2048 in bfloat16 of the kernel, the plain
            backward and SDPA's backward (the yardstick, held against the
            kernel), the bound, two calls bit-equal (no atomics), and the
            forward with its lse against without, the plain forward with
            its lse and SDPA's forward with grad on; the float32 backward
            (3xTF32) at 4 x 2048: two calls bit-equal, timed with SDPA's
            float32 backward, split by kernel, its bound; then the
            bfloat16 backward at head width 64 (granite-3-2b's H=32,
            Hkv=8): its kernels' registers, spills and shared memory, the
            kernel and the forward's lse against plain at the same (B, S)
            set, and at 4 and 8 x 2048 timed as at d=128 (plain, SDPA, the
            bound, device ms by kernel); then group sizes that are not
            powers of two (G padded to the next one, Q and dO read through
            a 5-D view whose idle rows are zeros): both routes at G = 3, 5,
            6, 7 over deepseek-coder-33b's 8 KV heads for B=2 and S from 1
            to 257 around the 16-position dq blocks and 64-row tiles, with
            the forward's lse, every forward and backward launch writing
            into NaN-filled buffers one position wider on each side (dq,
            dk, dv all written, nothing around them); inf and NaN in q and
            dout of the next group's first head leaving KV head 0's dk and
            dv and group 0's dq equal to plain's, in both types; coder's
            H=56, Hkv=8 at 4 x 2048 timed in bfloat16 (two calls bit-equal,
            plain, SDPA with enable_gqa, the bound, device ms by kernel) and
            in float32; then deepseek-moe-16b's heads (H=16, Hkv=16,
            d=128: G=1) in both routes, the kernel and the forward's lse
            against plain at the (B, S) set above, timed at TRAIN_B x
            TRAIN_S in bfloat16 (with the forward with its lse: device ms and
            bound too) and float32 as d=128 is; under the port's counter a
            forward and backward on the card read the formulas
  lm-train  qwen3-0.6b's training path: float32 at full width cut to 2
            layers, the loss and every gradient leaf through the kernels
            ("flash") against plain autograd ("chunked"), every leaf
            nonzero; then the full-width bfloat16 model from
            launch.train.build(full=True) trained 12 steps of 4 x 2048
            through Trainer + adamw; both attention counters set to 0 just
            before and read just after: 56 forward and 28 backward launches
            a step (each layer rematerialised: cfg.remat); the loss falls;
            step ms, tokens/s, peak memory, the step's share of its bound,
            busy share and the attention's share of a step's device time;
            then python -m
            repro_torch.launch.train --arch qwen3-0.6b --full --steps 3
            --batch 2 --seq-len 512 --device cuda exiting 0
  lm-granite-train  granite-3-2b's training path: (a) at full width cut
            to 2 layers, the bfloat16 loss and every gradient leaf through
            the d=64 kernels against float32 plain autograd ("chunked") from
            the same weights, within GRANITE_TRAIN_REL, every leaf nonzero,
            4 forward and 2 backward launches, remat on and off equal; (b)
            the full model (40 layers, bfloat16) from
            launch.train.build(full=True) trained 12 steps of 4 x 2048
            through Trainer(donate=True) + adamw, both attention counters
            set to 0 just before and read just after: 80 forward and 40
            backward launches a step; the loss falls; step ms, tokens/s,
            peak memory (leaving 4 GB of the card free), busy share, the
            step's share of its bound (the counter counts remat's second
            forward, model_flops does not); (c) python -m
            repro_torch.launch.train --arch granite-3-2b --full --batch 1
            --seq-len 2048 --steps 2 --device cuda exiting 0
  lm-coder-train  deepseek-coder-33b's training path, its attention on
            the kernels both ways at G=7: lm-granite-train's (a) at full
            width cut to 2 layers; (b) full width cut to CODER_TRAIN_LAYERS
            = 4 layers (2.584e9 parameters: all 62 layers' 533 GB of
            training state do not fit one card), built as the launcher
            builds an LM, 12 steps of 4 x 2048 through Trainer(donate=True)
            + adamw: 8 forward and 4 backward launches a step, the loss
            falling, step ms, tokens/s, peak memory (4 GB of the card
            left), busy share, the step's share of model_flops at 4 layers;
            (c) python -m repro_torch.launch.train --arch qwen3-0.6b
            --steps 3 and --arch deepseek-coder-33b --steps 3, started
            together, reduced on the card: float32 at d_head 16, for which
            no attention kernel is compiled, so the launcher trains them on
            "chunked" and prints attn=chunked (no CUDA kernel for float32
            d_head 16); each exits 0
  lm-moe-train  deepseek-moe-16b's training path, its attention on the
            kernels both ways at G=1 (held against plain in attn-bwd): (a) at
            full width cut to 2 layers in float32, where routing cannot
            differ (a bfloat16 x routes some tokens to other experts than
            its float32 copy, whose expert gradients then differ far past
            granite's 0.04): each layer's (idx, keep) through the float32
            kernels equal to float32 chunked's, and to its own recompute
            under remat, then the loss and every gradient leaf within
            TRAIN_GRAD_REL of plain autograd, every leaf nonzero, 2 forward
            and 1 backward launches a layer; remat off against on: the
            loss, the gradients and the drop share; the bfloat16 model
            (the same weights) through the bfloat16 kernels: its loss within
            MOE_BF16_LOSS_REL of the float32 one, every gradient finite, the
            share of (token, choice) pairs routed to another expert printed;
            (b) full width cut to MOE_TRAIN_LAYERS = 4 layers, built as the
            launcher builds an LM, 12 steps of 4 x 2048 through
            Trainer(donate=True) + adamw: 8 forward and 4 backward launches
            a step, the loss falling, step ms, tokens/s, peak memory (4 GB
            of the card left), busy share, the step's roofline share, the
            drop share (count_drops) and moe_aux at the first and last
            steps; (c) python -m repro_torch.launch.train --arch
            deepseek-moe-16b --steps 3 and --arch moonshot-v1-16b-a3b
            --steps 3, reduced on the card, on "chunked" with the attn= line,
            each printing moe_aux in its final line and exiting 0
  lm-moe-a2a  expert parallelism (models/moe.py moe_apply_a2a) through
            real NCCL collectives at world size 1: a default process group
            on the nccl backend (a file:// store under build/; a failed
            initialisation fails the phase, nothing falls back to gloo or
            the CPU) and make_mesh((1, 1), ("data", "model")) on the card,
            destroyed before the later phases. (a) On reduced
            deepseek-moe-16b in float32: at capacity 8.0 the a2a within
            A2A_GATHER_TOL of moe_apply on the card; at the config's own
            capacity (pairs drop) the card's a2a against the CPU's (a gloo
            group and a CPU mesh) on the same inputs, each dispatch's
            (slot, kept) equal first, then y within A2A_Y_ATOL; the MoE LM
            (2 layers, "chunked") under activation_sharding(..., moe_a2a=
            True): each layer's routing equal, then the loss and every
            gradient leaf card == CPU within A2A_GRAD_REL (error norm over
            gradient norm); compress_with_feedback's int8 payloads and
            scales and compressed_psum's means and errors over the NCCL
            group == the CPU's over gloo, bit for bit. (b) deepseek-moe-16b
            at full width and depth in bfloat16, prefill 8 x 2048 through
            the a2a under activation_sharding(mesh, lm_rules(mesh),
            moe_a2a=True): tokens/s, the roofline share, the two-level drop
            share, attention launches (one a layer a prefill) and the c10d
            collectives the counter reads (3 all-to-alls and 2 all-reduces
            a layer), beside lm-moe's gather-path prefill. (c) The model
            cut to MOE_TRAIN_LAYERS layers, A2A_TRAIN_STEPS steps of 4 x
            2048 through Trainer(donate=True) + adamw in the context: step
            ms, tokens/s, peak, share, whether the loss fell (means of 3),
            beside lm-moe-train
  bag-kernel  the EmbeddingBag kernel against its plain version: at
            tests/test_kernels.py's shapes and a ragged bag count, float32
            and bfloat16, with and without weights; ids outside the table
            (-1, -V, V, -V-1: jnp.take's wrap, and a NaN bag outside
            [-V, V)), NaN positions equal; in float32 over a
            20M-row table (past 2^31 elements) at the serve shapes' bag
            counts with ids from its last 10% of rows, and multi-hot; then
            dlrm-mlperf's full table (187,767,808 x 128 bfloat16, 48.07 GB,
            drawn from --seed on the card) at serve_p99 and serve_bulk with
            ids from data/recsys.py and from its last 10% of rows, and
            multi-hot (B=16384, L=32) with and without weights; times of
            the kernel, the plain version and F.embedding_bag (the
            yardstick) at both serve shapes and the multi-hot one, and the
            bound
  rec-check dlrm-mlperf in bfloat16: serve_step and retrieval_step through
            the kernel == through the plain version (torch.equal: a bag of
            one row is its row)
  rec       dlrm-mlperf at full width in bfloat16, batches from
            data/recsys.py: serve_p99 (B=512, p50/p99 of 64 steps),
            serve_bulk (B=262144, examples/s, median of 3), retrieval_cand
            (1,000,000 candidates, median of 5); the bag kernel's launch
            counter is set to 0 just before and read just after, and must
            show 1 launch per serve_step and 2 per retrieval_step; peak
            memory, the busy share of one serve_bulk step, serve_bulk read
            against its bound
  planner   the dry-run planner (launch/specs.py, launch/dryrun.py) on
            the card, on an NCCL group of one rank and its (1, 1) mesh:
            (b) dlrm-mlperf x serve_p99 planned, the rec phase's 48 GB
            table wrapped as DTensors in place, the planned serve step
            against serve_step (PLANNER_SERVE_ATOL) with 1 bag launch; then
            the table is freed; (a) qwen3-0.6b x train_4k planned at full
            width, its global batch cut from 256 to PLANNER_BATCH (seq_len
            4096), the arguments materialised from the plan on the card:
            PLANNER_STEPS planned steps against make_train_step + adamw on
            plain tensors from the same weights (loss, every updated leaf),
            the attention kernels' launches counted both ways (56 + 28 a
            step); (c) python -m repro_torch.launch.dryrun --both-meshes in
            a subprocess (a fake group cannot share a process with NCCL) for
            PLANNER_CELLS at 256 and 512 fake ranks: every record ok, its
            roofline_frac within SHARE_CAP, per-rank peak GB, bottleneck and
            step bound printed; (d) (a)'s cut cell dry-run at world size 1:
            its FLOPs equal to counts.count of (a)'s executed step, its
            bytes within 1%, the ratio of its peak estimate to the card's
            max_memory_allocated printed
  bag-bwd   the EmbeddingBag backward kernel (csrc/embedding_bag_bwd.cu)
            against its plain version, bit for bit, float32 and bfloat16,
            with and without weights: at the bag-kernel phase's shapes, a
            3-row field named 65,536 times, ids -1, -V, V, -V-1 (wrapped or
            dropped), a float32 gradient of 20M rows (past 2^31 elements);
            then dlrm-mlperf's training lookup (65,536 x 26 bags of one row,
            bfloat16, each field cut to 1,000,000 rows: V = 7,110,656): two
            calls bit-equal, times of the kernel, its sort, the plain
            version and aten.embedding_dense_backward (the yardstick), the
            bound; under the port's counter a lookup and its gradient on
            the card read the formulas
  rec-train dlrm-mlperf's training path, bfloat16, every width full and
            each field cut to 1,000,000 rows (the MLPerf DLRM reference's
            --max-ind-range): 20 steps of Trainer + adamw (the launcher's
            schedule) at batch 65,536 from data/recsys.py seed 0; both bag
            counters set to 0 just before and read just after: one forward
            and one backward launch a step; the loss falls; step ms,
            examples/s, peak memory, the step's share of its bound, busy
            share; the gradient tree through the kernels == through the
            plain route (torch.equal, B=512); reduced(dlrm-mlperf) float32
            loss and every gradient leaf on the card against the CPU;
            python -m repro_torch.launch.train --arch dlrm-mlperf --steps 3
            --device cuda exiting 0
  rec-family  FM and DIN at full width in bfloat16: serve_step at B=512 and
            262,144, retrieval_step over 1,000,000 candidates, 5 training
            steps at 65,536 (ms of each, peak memory); reduced float32
            serve, retrieval, loss and gradients on the card against the CPU
  bert4rec  BERT4Rec at full width in bfloat16 (d 64, 2 blocks, 2 heads,
            seq 200, a 1,000,448 x 64 table), its lookups on the bag
            kernels both ways: serve_p99 (B=512, p50/p99 of 20 steps),
            serve_bulk (262,144 rows as 8 calls of 32,768, median of 3),
            retrieval_cand (1 sequence x 1,000,000 candidates, median of 5),
            the bag kernel's launch counter set to 0 just before and read
            just after: one launch a serve_step and a retrieval_step (a
            step's ids go as one launch); at the timed shapes (B=512, a
            32,768-row serve_bulk chunk, 1,000,000 candidates, then the loss
            and every gradient leaf at B=16,384) through the kernels ==
            through the plain route (torch.equal); 10 Trainer + adamw steps
            at B=16,384 (the largest power of two up to 65,536 whose step
            peaks under 70 GB: twice the batch, by the bytes a row holds,
            would not), both bag counters counted: one forward and one
            backward launch a step; step ms, examples/s, peak, the step's
            bound and share, busy share; reduced float32 card == CPU
  gnn       meshgraphnet at full width (15 layers, d_hidden 128, bfloat16,
            remat): 5 Trainer + adamw steps each on molecule (128 graphs x
            30 nodes x 64 edges through forward_batched), full_graph_sm
            (2,708 nodes, 10,556 edges, d_feat 1,433) and minibatch_lg (the
            port's NeighborSampler over random_graph(232,965, 492), 1,024
            seeds, fanout (15, 10), pads that hold every hop's full
            fanout (169,984 nodes / 168,960 edges), features taken
            by node_ids from one seeded host matrix, the loss over
            node_mask): finite losses, step ms, peak, the host's sampling
            time apart, each step read against its bound; ogb_products
            printed as left out (its edge latents
            do not fit one card); reduced float32 forward, forward_batched
            and loss_fn gradients, each aggregator, card == CPU

The attn-kernel, lm-check, lm, lm-moe-check, lm-moe, lm-moonshot, attn-d64,
lm-granite-check, lm-granite, attn-g7, lm-coder-check, lm-coder,
bag-kernel, rec-check and rec phases run under torch.inference_mode()
(attn-d64's float32 and attn-g7's past-128 refusals with the gradient
outside it); attn-bwd, lm-train, lm-granite-train, lm-coder-train,
lm-moe-train, lm-moe-a2a, bag-bwd, rec-train,
rec-family, bert4rec and gnn differentiate, outside it (their serving steps
under it).
A kernel's "ms" is the mean over calls between two CUDA events with the
host issuing each call; its "device ms" is the same calls queued behind a
spin kernel, so that they run back to back on the card. Busy shares and
the attention backward's split by kernel come from torch.profiler, which
late in the run loses kernel records: a busy share says how many it saw
for how many launches, and a split counts only a session that saw all.
Every bound comes from repro_torch.roofline: a kernel call's from its work
formula (analysis.*_work, analysis.bound), a step's from the model's counts
at the cut shape the phase runs (analysis.build_roofline over one more,
untimed call under counts.count), which also prints the counted FLOPs and
the useful ratio. A share of a bound past SHARE_CAP (1.05) fails its phase.
It prints one `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {...}}`. Any failed check raises and ends the run
with a nonzero exit; without a card, or without the repository's sources
beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import json
import math
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: a call or a step whose share of its bound (repro_torch.roofline) reads
#: past this fails its phase: nothing runs faster than the least time the
#: card could take, and the margin is the timer's
SHARE_CAP = 1.05
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
#: kernel batch sizes: the scorer buckets of both plans (1..4096) and a
#: ragged one; S, d, w, F are sm-cnn's
KERNEL_BATCHES = (1, 3, 8, 64, 256, 1024, 4096)
#: (B, S, d, w, F) across the float32 kernel's tile edges: S=1 (5 windows),
#: S=13 (17 windows, not a multiple of 8 or 16), F around 8 and past 104 and
#: 112 (filter tiles of 16, the bank padded to 8), d around the k8 pad, more
#: samples than 132 SMs hold blocks; S past one chunk of 9 window tiles (69:
#: two, 141: three) up to the longest S its shared memory takes (180)
KERNEL_EDGE_SHAPES = ((4, 1, 50, 5, 100), (4, 13, 50, 5, 100), (4, 64, 50, 5, 8),
                      (4, 64, 50, 5, 9), (4, 64, 50, 5, 105), (4, 64, 50, 5, 113),
                      (4, 64, 8, 5, 100), (4, 64, 57, 5, 100), (133, 64, 50, 5, 100),
                      (4, 69, 50, 5, 100), (2, 141, 50, 5, 100), (2, 180, 50, 5, 100))
TIMED_BATCHES = (256, 4096)
TIE_ATOL = 1e-5
#: the pipeline phase times the pallas scorer at its top bucket this many
#: times
SCORER_ROWS = 256
SCORER_CALLS = 20
#: the host's kernel launch calls as torch.profiler names them
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"))
#: tries of a back-to-back timing (_queued_ms), and profiler sessions of a
#: split by kernel (_profiled_split_ms)
QUEUE_ATTEMPTS = 6
PROFILE_ATTEMPTS = 8
#: every kernel of the port's paths (csrc/<name>.cu)
KERNELS = ("sm_cnn_conv", "flash_attention", "embedding_bag", "flash_attention_bwd",
           "embedding_bag_bwd")
#: the attention kernel against its plain version: tests/test_kernels.py's
#: tolerances for it, and (B, S) at qwen3-0.6b's H=16, Hkv=8, d=128, from
#: one token through ragged lengths to the largest S whose plain version
#: fits (its (1, 16, 4096, 4096) float32 scores take 1.07 GB)
ATTN_TOLERANCE = {"float32": 2e-5, "bfloat16": 3e-2}
#: and, since randn outputs shrink with S (about sqrt(e / S): 0.036 at
#: S=2048) while the absolute tolerance does not, the error's norm over the
#: output's norm: two right bfloat16 results differ by at most one rounding
#: of the output, 2^-8 of it, so 1e-2 leaves 2.5x; float32 keeps 2e-5
ATTN_REL_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-2}
ATTN_SHAPES = ((1, 1), (2, 7), (1, 128), (2, 130), (4, 1024), (1, 4096))
#: bfloat16 lengths whose last tile of 64 keys crosses the diagonal inside
#: it, at its edge or one key past it, at B=2
ATTN_DIAGONAL_S = (63, 64, 65, 127, 129, 191)
#: timed: the LM phase's two prefills; the plain version is timed only where
#: its scores fit (at S=32768 they would take 68.7 GB)
ATTN_TIMED = ((8, 2048, "bfloat16"), (8, 2048, "float32"), (1, 32768, "bfloat16"))
PLAIN_MAX_S = 4096
#: past PLAIN_MAX_S the kernel is checked on its first and last rows of
#: queries, each against all keys (scores (1, 16, 256, 32768): 0.54 GB)
ATTN_SLICE_ROWS = 256
#: the LM path: a prefill of 8 x 2048 then 32 greedy decode steps, and a
#: prefill of 1 x 32768 (LM_SHAPES' prefill_32k length; its batch of 32
#: would need 120 GB of KV cache, more than one 80 GB card)
LM_BATCH, LM_SEQ, LM_DECODE = 8, 2048, 32
LM_LONG = 32768
#: the prefills of each LM phase's counted run: LM_PREFILLS at 8 x 2048,
#: LM_LONG_PREFILLS at its long length
LM_PREFILLS, LM_LONG_PREFILLS = 2, 1
#: lm-check in float32: prefill flash vs chunked at this (B, S), and decode
#: at position S against forward over S+1 tokens
CHECK_B, CHECK_S = 2, 130
#: lm-moe-check and lm-moe: deepseek-moe-16b, multi-head (the attention
#: kernel at G = H / Hkv = 1). The check cuts it to MOE_CHECK_LAYERS layers:
#: (a) the kernel against its plain version at MOE_ATTN_SHAPES in both types
#: and at each long prefill of MOE_LM_RUNS in bfloat16 (on its first and last
#: ATTN_SLICE_ROWS query rows, as attn-kernel holds it at G=2); (b) moe_apply
#: against the dense mixture and (d) decode against forward at capacity
#: factor MOE_CHECK_CF, where no slot drops, at MOE_TOL in float32 and
#: float64 ((d) in float64 only); (c) one group of the config's size at its
#: own capacity factor, the tokens sharing a direction of MOE_SKEW times
#: their own scale, as a residual stream's do, so that the load is uneven
#: and slots drop
MOE_ARCH = "deepseek-moe-16b"
MOE_CHECK_LAYERS, MOE_CHECK_CF, MOE_SKEW = 2, 16.0, 0.5
MOE_ATTN_SHAPES = ((2, 130), (8, 2048))
MOE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "float64": dict(rtol=1e-10, atol=1e-12)}
#: a model past KV_QUANT_PARAMS parameters decodes on the int8 KV cache, as
#: the JAX launcher serves it (src/repro/launch/specs.py:179): lm-moe and
#: lm-moonshot run it at decode_32k's context at their MOE_LM_RUNS rows,
#: which must leave INT8_SPARE bytes of the card unreserved; (f) of
#: lm-moe-check holds it to tests/test_arch_smoke.py's INT8_ATOL
KV_QUANT_PARAMS, INT8_SPARE, INT8_ATOL = 5e9, 4e9, 0.15
#: lm-moonshot: moonshot-v1-16b-a3b (57.78 GB of bf16 weights), its long
#: prefill cut to 1 x MOONSHOT_LONG: at 1 x 32768 its bf16 cache (12.9 GB)
#: and the prefill's working memory at that length (~17 GB in lm-moe) would
#: not fit beside the weights
MOONSHOT_ARCH, MOONSHOT_LONG = "moonshot-v1-16b-a3b", 16384
#: the G=1 LM phases: (phase, arch, long prefill's length, int8 decode's
#: rows at decode_32k's context: deepseek's 31.0 GB of int8 cache beside its
#: 33.8 GB of weights, moonshot's 13.3 GB beside 57.8 GB)
MOE_LM_RUNS = (("lm-moe", MOE_ARCH, LM_LONG, 8),
               ("lm-moonshot", MOONSHOT_ARCH, MOONSHOT_LONG, 2))
#: granite-3-2b: GQA at d_head 64 (H=32, Hkv=8: G=4), the bfloat16 forward
#: kernel's other width. attn-d64 holds it against its plain version at
#: ATTN_SHAPES and ATTN_DIAGONAL_S at granite's heads, at each G of
#: D64_GROUPS (H=32, Hkv=32/G) for B=2 and S in D64_GROUP_S (one token, one
#: key either side of a 64-key tile's edge, ragged lengths past one and two
#: blocks), and at lm-granite's two prefills, which it times
GRANITE_ARCH = "granite-3-2b"
D64_GROUPS = (1, 2, 4, 8)
D64_GROUP_S = (1, 63, 64, 65, 130, 257)
#: lm-granite-check: granite at full width cut to GRANITE_CHECK_LAYERS
#: layers, in bfloat16 on the card, at (CHECK_B, CHECK_S). Its logits
#: (std ~0.9: tied embeddings at std 0.02 over d_model 2048, the largest
#: near 4) and the cache's k and v (std ~1) are bfloat16, spaced 2^-6 =
#: 0.016 in [2, 4). Two right answers differ here: the kernel rounds the
#: unnormalised probabilities to bfloat16 and divides the float32 sums at
#: the end, as SDPA does, where chunked (and decode) round the normalised
#: ones, as the reference does; decode and forward also sum every product
#: in another order. A CPU model of both (its own bf16 products, the
#: kernel's rounding written out in torch) differs by up to 0.039 in the
#: logits and the layer-1 cache at |want| 0.3 to 1, which GRANITE_TOL (2^-4
#: + 2^-4 |want|: 0.0625 near 0) holds with room; a wrong weight, head, key
#: mask or layout moves them by a tenth of their std and more. Top-1 tokens
#: must be identical
GRANITE_CHECK_LAYERS = 2
GRANITE_TOL = dict(rtol=2 ** -4, atol=2 ** -4)
#: deepseek-coder-33b: 56 query heads over 8 KV heads (G=7), the one config
#: whose group size is not a power of two. attn-g7 holds the kernel at each
#: G of G7_GROUPS over coder's 8 KV heads for B=2 and S in G7_S (one token,
#: one position either side of a 16-position block's edge (G=5..7: 16
#: positions a block of 128 rows) and of a 64-key tile's, ragged lengths).
#: lm-coder-check cuts it to GRANITE_CHECK_LAYERS layers and holds it to
#: GRANITE_TOL (its logits and cache have granite's scales: an untied head
#: at std 1/sqrt(d_model) gives logits of std ~1, k and v std ~1).
#: lm-coder's long prefill is cut to 1 x CODER_LONG: at 1 x 32768 its bf16
#: cache (8.32 GB) and the prefill's working memory (~6 GB: the MLP's three
#: 32768 x 19200 bf16 temporaries and more) beside 66.68 GB of weights and
#: the 8 x 2080 decode cache (4.23 GB), which the int8 decode reads after
#: it, would pass the card's 85.5 GB. Its int8 decode runs at
#: CODER_INT8_ROWS rows: 4.29 GB of int8 cache a row beside the weights
CODER_ARCH = "deepseek-coder-33b"
G7_GROUPS = (3, 5, 6, 7)
G7_S = (1, 15, 16, 17, 63, 64, 65, 130, 257)
CODER_LONG, CODER_INT8_ROWS = 16384, 2
#: attn-bwd: the backward kernel against the plain backward at qwen3-0.6b's
#: H=16, Hkv=8, d=128: (B, S) from one token to 1 x 1024, and S around the
#: 64-key tiles at B=1. Tolerances: max abs error within atol + rtol |want|
#: and the error's norm over the gradient's. float32 differs only in the
#: order of float32 sums. bfloat16 rounds ds to bfloat16 for dq and dk as the
#: reference does, and P for dv where the reference keeps float32 (the
#: tensor cores take bf16): an output rounding (2^-8), ds values that round
#: to the other neighbour, and 2^-9 of each dv term, inside 1e-2 of the norm
BWD_SHAPES = ((1, 1), (2, 7), (1, 130), (2, 257), (1, 1024))
#: around the 64-key and 64-row tiles and the bfloat16 kernels' 128-key and
#: 128-row blocks
BWD_DIAGONAL_S = (63, 64, 65, 127, 128, 129, 191, 255, 256, 257)
BWD_TOLERANCE = {"float32": (1e-4, 1e-4, 2e-5), "bfloat16": (2e-2, 2e-2, 1e-2)}
#: the forward's lse against the plain lse (float32 sums in another order;
#: the bfloat16 route's exp2 and tensor-core sums)
LSE_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-4}
#: a gradient whose RMS is below this is rounding (at S=1 dq is 0)
RMS_FLOOR = 1e-3
#: timed, bfloat16: the training step's shape and the prefill's batch; the
#: float32 route (the checks' only) at the training step's shape
BWD_TIMED = ((4, 2048), (8, 2048))
BWD_TIMED_F32 = (4, 2048)
#: lm-train: float32 gradients through the kernels against "chunked" on
#: qwen3-0.6b at full width cut to this many layers, at (B, S); then the
#: full-width bfloat16 model trained through the launcher's build and
#: Trainer at (B, S) for this many steps; the CLI's run. Every LM config
#: rematerialises its layers (cfg.remat), so a step launches the attention
#: forward twice a layer and its backward once
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 130
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 2048, 12, 1e-3
TRAIN_CLI = ("--arch", "qwen3-0.6b", "--full", "--steps", "3", "--batch", "2",
             "--seq-len", "512", "--device", "cuda")
#: the float32 gradient check: each leaf's error norm over its gradient's,
#: and the loss's relative error
TRAIN_GRAD_REL = 1e-4
#: lm-granite-train (a): granite-3-2b at full width cut to
#: GRANITE_CHECK_LAYERS layers, its bfloat16 loss and gradients through the
#: d=64 kernels against float32 plain autograd ("chunked") from the same
#: bfloat16 weights, at (TRAIN_CHECK_B, TRAIN_CHECK_S): each leaf's error
#: norm over its gradient's within GRANITE_TRAIN_REL, the loss within
#: GRANITE_LOSS_REL. A CPU rehearsal of this comparison (the same cut model
#: and batch, bfloat16 through the plain attention against float32
#: chunked) gave the loss within 3.2e-6 and every leaf within 0.0134 (wo
#: worst, 0.0060 at best): bfloat16's rounding, not a fault, which moves a
#: leaf by a large part of its norm. Remat on and off through the kernels
#: must agree within GRANITE_REMAT_REL (the same products run again)
GRANITE_TRAIN_REL, GRANITE_LOSS_REL, GRANITE_REMAT_REL = 0.04, 1e-3, 1e-5
#: (b): the full model, TRAIN_STEPS steps of TRAIN_B x TRAIN_S through the
#: Trainer with donated updates, whose peak allocated memory must leave
#: GRANITE_SPARE bytes of the card; (c) the launcher at full width
GRANITE_SPARE = 4e9
GRANITE_CLI = ("--arch", "granite-3-2b", "--full", "--batch", "1", "--seq-len", "2048",
               "--steps", "2")
#: lm-coder-train: deepseek-coder-33b at full width, lm-granite-train's
#: schedule. (a) Its check at GRANITE_CHECK_LAYERS layers and granite's
#: tolerances (a CPU rehearsal of the comparison at a narrower width,
#: d_model 1792 with coder's G=7, head width, untied head and vocabulary,
#: gave the loss within 2.0e-4 and every leaf within 0.0125). (b) The model
#: cut to CODER_TRAIN_LAYERS layers: all 62 hold 3.334e10 parameters, whose
#: 16 B each of training state (bf16 param and grad, float32 master copy
#: and moments) are 533 GB; 4 layers and both tables hold 2.584e9 (41.3 GB),
#: which leaves room for 4 x 2048 under remat; 6 would hold 58 GB. (c) The
#: launcher's reduced LMs on the card: float32 at d_head 16, for which no
#: attention kernel is compiled, so the launcher trains them on "chunked"
#: and prints an attn= line saying so
CODER_TRAIN_LAYERS = 4
CODER_CLIS = (("--arch", "qwen3-0.6b", "--steps", "3"),
              ("--arch", "deepseek-coder-33b", "--steps", "3"))
#: lm-moe-train: deepseek-moe-16b at full width, lm-coder-train's schedule.
#: (a) Its check at GRANITE_CHECK_LAYERS layers compares float32 with
#: float32: the router takes x in float32 whatever the model's type, so a
#: bfloat16 model routes some tokens otherwise than its float32 copy (a CPU
#: rehearsal at d_model 512 with deepseek's experts, heads and vocabulary
#: moved 0.93-0.96% of the (token, choice) pairs, and the worst expert leaf
#: by 0.11-0.13 of its norm), so the bfloat16 model is held by its loss
#: only, within MOE_BF16_LOSS_REL of the float32 one (the rehearsal:
#: 7.6e-5 and 2.0e-4). (b) The model cut to MOE_TRAIN_LAYERS layers: all 28
#: hold 1.688e10 parameters, whose 16 B each of training state are 270 GB;
#: 4 layers and both tables hold 2.771e9 (44.3 GB), coder's cut, and a step
#: of 4 x 2048 under remat with the zero-filled stacked expert gradients
#: (1.48 GB a leaf) of each layer's backward peaks at 57.0 GB allocated on
#: an NVIDIA H100 80GB HBM3; each more layer adds 9.4 GB of state. (c) The
#: launcher's reduced MoE configs on the card (float32, d_head 16:
#: "chunked")
MOE_TRAIN_LAYERS = 4
MOE_BF16_LOSS_REL = 2e-3
MOE_CLIS = (("--arch", MOE_ARCH, "--steps", "3"), ("--arch", MOONSHOT_ARCH, "--steps", "3"))
#: lm-moe-a2a: (a) reduced deepseek-moe-16b's MoE and its LM on A2A_CHECK_B x
#: A2A_CHECK_S tokens, the MoE's sharing a direction of A2A_SKEW times their
#: scale (uneven load: pairs drop at the config's capacity 1.5, as in
#: tests/test_torch_moe_a2a.py); the a2a against moe_apply at
#: capacity 8.0 within tests/test_moe_a2a.py's 2e-4; card against CPU: y
#: within A2A_Y_ATOL, the LM's gradient leaves within A2A_GRAD_REL (error
#: norm over gradient norm). (c) A2A_TRAIN_STEPS training steps
A2A_CHECK_B, A2A_CHECK_S, A2A_SKEW = 4, 32, 1.5
A2A_GATHER_TOL, A2A_Y_ATOL, A2A_GRAD_REL = 2e-4, 1e-5, 1e-5
A2A_TRAIN_STEPS = 6
#: the planner phase: (a) qwen3-0.6b x train_4k's global batch cut from 256
#: to this, PLANNER_STEPS planned steps against plain ones (loss within
#: PLANNER_LOSS_REL, every updated leaf's error norm within PLANNER_LEAF_REL
#: of its norm: bfloat16 steps whose ops are the same on the same tensors);
#: (b) the planned serve step within PLANNER_SERVE_ATOL of serve_step's
#: scores; (c) the cells the dry run runs at 256 and 512 fake ranks, in a
#: subprocess given PLANNER_DRYRUN_TIMEOUT seconds
PLANNER_BATCH, PLANNER_STEPS = 2, 2
PLANNER_LOSS_REL, PLANNER_LEAF_REL, PLANNER_SERVE_ATOL = 1e-3, 1e-2, 1e-2
PLANNER_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-moe-16b", "prefill_32k"),
                 ("dlrm-mlperf", "serve_p99"))
PLANNER_DRYRUN_TIMEOUT = 300
#: the EmbeddingBag kernel against its plain version: tests/test_kernels.py's
#: tolerances for it, its (V, d, B, L) shapes, and ragged bag counts (not a
#: multiple of a block's 8 bags)
BAG_TOLERANCE = {"float32": 1e-5, "bfloat16": 3e-2}
BAG_SHAPES = ((100, 16, 8, 4), (1000, 32, 16, 10), (64, 8, 4, 1), (1000, 128, 13, 3),
              (1000, 128, 1, 1))
#: the large multi-hot shape (B, L) at d=128
BAG_MULTI = (16384, 32)
#: float32 checks over a table of this many rows: 2.56e9 elements, past 2^31
BAG_F32_ROWS = 20_000_000
#: ids "from the last rows" lie in the last tenth of a table's rows
BAG_TOP = 0.1
#: serve_p99's timing cycles through this many id sets, 109 MB of rows in
#: all, more than the 50 MB L2 holds, so each launch finds its rows cold
BAG_P99_SETS = 32
#: the recsys path at RECSYS_SHAPES' serve and retrieval sizes: steps of each
REC_P99_STEPS, REC_BULK_STEPS, REC_RETRIEVAL_STEPS = 64, 3, 5
#: backends: the scorer buckets, timed calls a bucket, warm-up, batched and
#: local questions, timed batches, and the score gap under which two
#: neighbours may swap
BACKEND_BUCKETS = (1, 8, 64, 256)
BACKEND_CALLS = 50
BACKEND_WARM_Q, BACKEND_BATCH_Q, BACKEND_LOCAL_Q, BACKEND_ROUNDS = 8, 64, 32, 3
SWAP_ATOL = 2e-5

#: service: the paper's Table 2 (RPCs a backend from one client, warm-up
#: RPCs), its beyond-paper micro-batched row (client threads, RPCs each, the
#: engine's batching), and the unseen questions the remote plans rank
SERVICE_BACKENDS = ("pallas", "jit", "aot", "numpy")
SERVICE_RPCS, SERVICE_WARM = 300, 10
ENGINE_CLIENTS, ENGINE_MAX_BATCH, ENGINE_MAX_WAIT_S = 8, 64, 0.001
CONCURRENT_RPCS = 50   # a client thread's RPCs in each backend's concurrent check
SERVICE_PLAN_Q = 64
#: every wait of the service phase on a thread, a reply or a drain
SERVICE_WAIT_S = 60.0

#: launch: full-width training steps and batch; the ReplicaPools' backends
#: and replicas; client threads; rollout questions; fabric sizes and each
#: client thread's rank_batch RPCs of one question; every spawn and wait
LAUNCH_TRAIN_STEPS, LAUNCH_BATCH = 60, 64
POOL_BACKENDS, POOL_REPLICAS = ("pallas", "aot"), 2
LAUNCH_CLIENTS = 8
ROLLOUT_Q = 32
FABRIC_WORKERS, FABRIC_RPCS = (1, 4), 32
#: a worker's rank_batch of the whole world's questions goes in chunks of
#: this many (the launcher's admission bound takes 32 queries an RPC)
FABRIC_CHUNK = 16
LAUNCH_WAIT_S = 180.0
#: the launcher's world (reduced sm-cnn, S=16 d=8 F=12): its scorer buckets
#: but 8, which the kernel phase's small shape already is
LAUNCH_WORLD_SHAPES = ((1, 16, 8, 5, 12), (64, 16, 8, 5, 12), (256, 16, 8, 5, 12))

#: rec-check: serve batches and retrieval candidates
REC_CHECK_BATCHES, REC_CHECK_CANDIDATES = (512, 4096), 65536
#: bag-bwd: a field of this many rows named at this many positions (each
#: row ~21,845 times, as dlrm-mlperf's 3-row Criteo field at the training
#: batch); the float32 table past 2^31 elements is BAG_F32_ROWS rows
BAG_BWD_HOT = (3, 65536)
#: rec-train: each field cut to at most this many rows (the MLPerf DLRM
#: reference's --max-ind-range cap), steps and peak lr of Trainer + adamw,
#: the batch of the gradient-tree check, and the launcher's run on the card
REC_TRAIN_MAX_ROWS = 10 ** 6
REC_TRAIN_STEPS, REC_TRAIN_LR = 20, 1e-3
REC_TRAIN_CHECK_B = 512
REC_TRAIN_CLI = ("--arch", "dlrm-mlperf", "--steps", "3", "--device", "cuda")
#: rec-train and rec-family: the reduced float32 card-against-CPU checks,
#: the loss's relative error and each gradient element's tolerance (the CPU
#: tests' against JAX). Elementwise, not a norm over a leaf's norm: DIN's
#: last attention bias has a gradient that is 0 in exact arithmetic (the
#: softmax ignores a constant), so both sides hold rounding noise there
REC_LOSS_REL = 1e-5
REC_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: rec-family: FM and DIN at full width, serve_p99 steps timed, training steps
REC_FAMILY = ("fm", "din")
REC_FAMILY_P99_STEPS, REC_FAMILY_TRAIN_STEPS = 20, 5
#: bert4rec: serve_bulk's rows go as chunks of this many (one call of all
#: 262,144 would hold 83.9 GB of float32 scores a block); the training
#: batch (the largest power of two up to train_batch's 65,536 whose step
#: peaks under B4R_PEAK_CAP bytes: 32,768 runs out of the card's memory) and
#: its steps. Its step counts and check sizes are rec's and rec-family's
B4R_BULK_CHUNK = 32768
B4R_TRAIN_BATCH, B4R_TRAIN_STEPS = 16384, 10
B4R_PEAK_CAP = 70e9
#: gnn: training steps a shape
GNN_TRAIN_STEPS = 5


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ device --

def phase_device(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {count} python {sys.version.split()[0]}")
    log("tf32: off for matmul and cuDNN (float32 compared in float32)")
    return {"card": card, "kind": kind, "count": count}


# ------------------------------------------------------------------- build --

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, together
        list(pool.map(build.compile_library, KERNELS))
    for name in KERNELS:
        build.load_library(name)
    log(f"build: {', '.join(KERNELS)} ready in {time.perf_counter() - t0:.3f} s (sm_90a)")
    for name in KERNELS:
        log(f"build: {name} nvcc {build.BUILD_SECONDS[name]:.3f} s")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "arning",
                                       "Performance Loss")):
                log(f"  ptxas {name}: {line.strip()}")


# ------------------------------------------------------------------ kernel --

def _event_ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_alternating(torch, fns: dict, iters: int = 200, rounds: int = 3) -> dict:
    """Median over rounds of each function's mean time per call, the
    functions taking turns (a, b, c, c, b, a, ...) after a warm-up."""
    for fn in fns.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(_event_ms(torch, fns[name], iters))
    return {name: statistics.median(t) for name, t in times.items()}


def _queued_ms(torch, fn, iters: int) -> float:
    """ms a call of ``fn`` takes on the card with no host gaps between
    calls: a spin kernel holds the stream while the host queues ``iters``
    calls between two events. The time counts only if the first event had
    not been reached when the last call was queued, so the calls ran back
    to back; otherwise the spin doubles, and the phase fails past
    QUEUE_ATTEMPTS tries."""
    cycles = 1 << 24   # ~9 ms at the H100's 1.98 GHz
    for _ in range(QUEUE_ATTEMPTS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    check(False, f"the host queued {iters} calls slower than the card spun "
                 f"{cycles // 2} cycles, {QUEUE_ATTEMPTS} times")


def _profiled_split_ms(torch, fn, names, iters: int):
    """Device ms a call of ``fn`` spends in each kernel whose name holds one
    of ``names`` (each launched once a call), from torch.profiler over
    ``iters`` calls, or None. A session counts only if it recorded every
    launch, ``iters`` of each kernel: late in a long process the profiler
    loses kernel records (aten's too; `_busy_share` reports it), and a
    session that lost some would give too small a time. Up to
    PROFILE_ATTEMPTS sessions."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {name: [] for name in names}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in names:
                    if name in e.name:
                        times[name].append(e.time_range.elapsed_us())
        if all(len(t) == iters for t in times.values()):
            return {name: sum(t) / 1e3 / iters for name, t in times.items()}
    return None


def _bound_text(bd, ms: float, what: str, device_ms=None) -> str:
    """A kernel call's bound (``repro_torch.roofline.analysis.Bound``) as
    log text, with its share of the measured ``ms`` (and of ``device_ms``,
    the same calls back to back). A share past SHARE_CAP fails the phase."""
    from repro_torch.roofline import hw
    shares = {"share_of_bound": bd.ms / ms}
    if device_ms is not None:
        shares["device_share"] = bd.ms / device_ms
    for name, share in shares.items():
        check(share <= SHARE_CAP, f"{what}: {name} {share:.4f} is past {SHARE_CAP}: the "
                                  f"card beat the bound of {bd.ms:.5f} ms")
    return (f"bound_ms={bd.ms:.5f} ({bd.by}: {bd.ops / 1e9:.4f} GOP at "
            f"{bd.peak / 1e12:.0f} TFLOP/s, {bd.n_bytes / 1e6:.3f} MB at "
            f"{hw.HBM_BW / 1e12:.2f} TB/s) "
            + " ".join(f"{name}={share:.4f}" for name, share in shares.items()))


def _step_roofline(torch, arch: str, shape, run, median_ms: float, what: str,
                   cfg=None) -> dict:
    """One more call of ``run``, untimed, under the port's counter
    (``repro_torch.roofline.counts``), then the module's roofline of the
    step at ``shape``, the ShapeSpec of the (cut) cell the phase runs, and
    ``cfg``, the (cut) config where it is not ``arch``'s own: the model's
    FLOPs, the counted FLOPs and bytes, the useful ratio, the bound (the
    model's FLOPs at the peak of the config's dtype against its bytes at the
    HBM rate), what bounds it, and its share of the phase's measured median.
    A share past SHARE_CAP fails the phase."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis, counts, hw

    counted = counts.count(run)
    torch.cuda.synchronize()
    r = analysis.build_roofline(arch, shape, "1 card", 1, counted, cfg=cfg)
    share = r.share(median_ms / 1e3)
    peak = hw.peak_flops((get_config(arch) if cfg is None else cfg).dtype)
    log(f"{what}: roofline of {shape.describe()}: model_flops {r.model_flops:.6e}, counted "
        f"{counted.flops:.6e} FLOPs (useful ratio {r.useful_ratio:.5f}) and "
        f"{counted.bytes_accessed:.6e} bytes (at the card's rates {r.compute_s * 1e3:.5f} ms "
        f"of compute, {r.memory_s * 1e3:.5f} ms of memory: {r.bottleneck}); model_bytes "
        f"{r.model_bytes:.6e}; bound {r.bound_s * 1e3:.5f} ms by {r.bound_by} "
        f"({peak / 1e12:.0f} TFLOP/s, {hw.HBM_BW / 1e12:.2f} TB/s); share of the measured "
        f"median {median_ms:.3f} ms {share:.4f}")
    check(share <= SHARE_CAP, f"{what}: share {share:.4f} of the bound {r.bound_s * 1e3:.3f} "
                              f"ms is past {SHARE_CAP}")
    return {"bound_ms": r.bound_s * 1e3, "bound_by": r.bound_by, "share": share,
            "model_flops": r.model_flops, "flops": counted.flops,
            "useful_ratio": r.useful_ratio, "collectives": dict(counted.n_collectives),
            "collective_bytes": dict(counted.collective_bytes),
            "link_bytes": counted.link_bytes}


def phase_kernel(torch, cfg) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.roofline import analysis

    s, d, w, f = cfg.max_len, cfg.embed_dim, cfg.filter_width, cfg.conv_filters
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def inputs(b, s_, d_, w_, f_, dtype):
        dt = getattr(torch, dtype)
        x = torch.randn((b, s_, d_), generator=gen, device="cuda").to(dt)
        # pre-activations of std 0.3: tanh stays off its saturation, so the
        # outputs spread over (-1, 1) and the tolerances bite
        filt = (torch.randn((w_ * d_, f_), generator=gen, device="cuda")
                * (0.3 / math.sqrt(w_ * d_))).to(dt)
        bias = (torch.randn((f_,), generator=gen, device="cuda") * 0.1).to(dt)
        return x, filt, bias

    routes = {}
    for dtype in ("float32", "bfloat16"):
        info = routes[dtype] = K.route_info(getattr(torch, dtype), s, d, f)
        log(f"kernel: {dtype} route: stage {info['stage']} ({info['design']}), "
            f"registers={info['registers']} spill_bytes={info['local_bytes']} "
            f"static_smem={info['static_smem']} dynamic_smem={info['dynamic_smem']} "
            f"blocks_per_sm={info['blocks_per_sm']} threads={info['threads']} "
            f"at S={s} d={d} F={f}")
        check(info["local_bytes"] == 0, f"the {dtype} conv kernel spills")

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    shapes = ([(b, s, d, w, f) for b in KERNEL_BATCHES] + [(8, 16, 8, 5, 12)]
              + list(LAUNCH_WORLD_SHAPES) + list(KERNEL_EDGE_SHAPES))
    for shape in shapes:
        for dtype in ("float32", "bfloat16"):
            x, filt, bias = inputs(*shape, dtype)
            got = K.conv_tanh_maxpool(x, filt, bias, shape[3])
            want = K.conv_tanh_maxpool_plain(x, filt, bias, shape[3])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOLERANCE[dtype]
            log(f"kernel: B={shape[0]} S={shape[1]} d={shape[2]} w={shape[3]} "
                f"F={shape[4]} {dtype}: max_abs_err={err:.3e} "
                f"tol={TOLERANCE[dtype]} {'ok' if ok else 'FAIL'}")
            check(ok, f"conv kernel disagrees with its plain version at "
                      f"{shape} {dtype}: {err}")
            if shape[1:] == (s, d, w, f):
                max_err[dtype] = max(max_err[dtype], err)

    # NaN and +-inf, as tests/test_torch_kernels.py places them: a NaN in
    # sample 0, +inf and -inf at sample 1's first and last rows, a NaN in
    # the last filter column. JAX's max keeps NaN and tanh(+-inf) is +-1.
    for dtype in ("float32", "bfloat16"):
        x, filt, bias = inputs(256, s, d, w, f, dtype)
        x[0, s // 2, 1] = math.nan
        x[1, 0, 2] = math.inf
        x[1, s - 1, 0] = -math.inf
        filt[3, f - 1] = math.nan
        got = K.conv_tanh_maxpool(x, filt, bias, w).float()
        want = K.conv_tanh_maxpool_plain(x, filt, bias, w).float()
        torch.cuda.synchronize()
        same_nan = bool(torch.equal(got.isnan(), want.isnan()))
        finite = ~want.isnan()
        err = (got[finite] - want[finite]).abs().max().item()
        shape_ok = (bool(got[0].isnan().all()) and bool(got[:, -1].isnan().all())
                    and bool(torch.isfinite(got[1:, :-1]).all())
                    and bool((got[1, :-1] == 1.0).any()))
        ok = same_nan and shape_ok and err <= TOLERANCE[dtype]
        log(f"kernel: non-finite inputs B=256 {dtype}: NaN positions "
            f"{'equal' if same_nan else 'DIFFER'} ({int(got.isnan().sum())} NaN), "
            f"sample 0 and filter {f - 1} NaN, +-inf giving +1: {shape_ok}; "
            f"finite max_abs_err={err:.3e} tol={TOLERANCE[dtype]} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"conv kernel on non-finite inputs {dtype}: NaN positions equal "
                  f"{same_nan}, pattern {shape_ok}, finite error {err}")

    timings = {}
    for b in TIMED_BATCHES:
        for dtype in ("float32", "bfloat16"):
            x, filt, bias = inputs(b, s, d, w, f, dtype)
            # the library yardstick's layouts are made once, outside the timing
            x_t = x.transpose(1, 2).contiguous()                      # (B, d, S)
            w_t = filt.view(w, d, f).permute(2, 1, 0).contiguous()    # (F, d, w)

            def library():
                return torch.amax(torch.tanh(F.conv1d(x_t, w_t, bias, padding=w - 1)), -1)

            lib_err = (library().float()
                       - K.conv_tanh_maxpool_plain(x, filt, bias, w).float()
                       ).abs().max().item()
            t = _time_alternating(torch, {
                "kernel": lambda: K.conv_tanh_maxpool(x, filt, bias, w),
                "plain": lambda: K.conv_tanh_maxpool_plain(x, filt, bias, w),
                "library": library,
            })
            dev_ms = _queued_ms(torch, lambda: K.conv_tanh_maxpool(x, filt, bias, w), 20)
            bd = analysis.bound(*analysis.conv_tanh_maxpool_work(b, s, d, w, f, dtype), dtype)
            timings[(b, dtype)] = dict(t, bound_ms=bd.ms, bound_by=bd.by, device_ms=dev_ms)
            log(f"kernel: B={b} {dtype} kernel_ms={t['kernel']:.5f} "
                f"kernel_device_ms={dev_ms:.5f} "
                f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
                f"(F.conv1d+tanh+amax, max_abs_err vs plain {lib_err:.2e}) "
                + _bound_text(bd, t["kernel"], f"kernel: B={b} {dtype}", dev_ms)
                + f" achieved_tflops={bd.ops / t['kernel'] / 1e9:.1f}")
    return {"max_err": max_err, "timings": timings, "routes": routes}


# ---------------------------------------------------------------- pipeline --

def _percentile(values, q):
    vals = sorted(values)
    pos = (len(vals) - 1) * q
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _busy_share(torch, run, kernel: str = "conv_tanh_maxpool", top: int = 5) -> str:
    """Device busy time (union of kernel intervals) over the host wall time
    of one call of ``run``, from torch.profiler, with the time and launches
    of the kernels whose name holds ``kernel`` and the ``top`` kernel names
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernel_ms, kernel_n, by_name = [], 0.0, 0, {}
    # kernel launches on the host against kernel records on the device (a
    # graph launch runs several): fewer records means the profiler lost some
    launched = recorded = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            launched += e.name in LAUNCH_CALLS
            continue
        recorded += not e.name.startswith(("Memcpy", "Memset"))
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        if kernel in e.name:
            kernel_ms += e.time_range.elapsed_us() / 1e3
            kernel_n += 1
    if not spans:
        return f"busy share not measured (the profiler saw no device events in {wall_ms:.3f} ms)"
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in sorted(spans):
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy = (busy + cur_e - cur_s) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    lost = (f"; the profiler LOST records: {recorded} kernel records for {launched} "
            f"launches, so busy is a lower bound" if recorded < launched else
            f"; {recorded} kernel records for {launched} launches")
    return (f"device busy {busy:.3f} ms over {len(spans)} device events "
            f"({kernel} {kernel_ms:.3f} ms, {kernel_n} launches, "
            f"{kernel_ms / busy:.4f} of the device time) in a "
            f"{wall_ms:.3f} ms profiled run: busy share {busy / wall_ms:.4f} "
            f"(idle {1 - busy / wall_ms:.4f}){lost}; top device time: "
            + "; ".join(f"{name[:72]} {ms:.3f} ms x{n}" for name, (ms, n) in ranked))


def phase_pipeline(torch, cfg, seed: int, n_docs: int = 2000, n_questions: int = 256,
                   n_local: int = 32, batches: int = 3) -> dict:
    import dataclasses

    from repro_torch.configs import TEXTPAIR_SHAPES
    from repro_torch.core import backends, bm25, ops
    from repro_torch.core.plan import PlanContext, plan, verify_plans
    from repro_torch.data import qa
    from repro_torch.data.tokenizer import HashingTokenizer
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.models import sm_cnn
    from repro_torch.serving import telemetry

    t0 = time.perf_counter()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=seed)
    corpus = qa.generate_corpus(n_docs=n_docs, n_questions=n_questions, seed=0)
    tok = HashingTokenizer(cfg.vocab_size)
    index = bm25.build_index([tok.encode(" ".join(doc)) for doc in corpus.documents],
                             cfg.vocab_size)
    ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    sync = torch.cuda.synchronize
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    local, batched = plan(pipe, "local", ctx), plan(pipe, "batched", ctx)
    queries = corpus.questions
    n_params = cfg.n_params()
    log(f"pipeline: cfg={cfg.name} vocab={cfg.vocab_size} d={cfg.embed_dim} "
        f"F={cfg.conv_filters} w={cfg.filter_width} max_len={cfg.max_len} "
        f"hidden={cfg.n_hidden} params={n_params} {cfg.dtype}; corpus {n_docs} docs, "
        f"{len(queries)} questions; setup {time.perf_counter() - t0:.3f} s")
    log(f"pipeline: {pipe!r}")
    for p in (local, batched):
        log(f"pipeline: {p.describe()}")
    # warm-up: first launches, allocator, cuBLAS handles
    local.run_many(queries[:2])
    batched.run_many(queries[:8])
    sync()

    # ---- the main path, counted ----
    K.reset_launches()
    for s_ in ctx.scorers():
        s_.calls = 0
    telemetry.reset_all()
    lat = []
    for q in queries[:n_local]:
        t = time.perf_counter()
        local.run(q)
        sync()
        lat.append(time.perf_counter() - t)
    spans = {"local": telemetry.stage_breakdown(telemetry.get_tracer().finished())}
    telemetry.get_tracer().clear()
    batch_s = []
    results = None
    for _ in range(batches):
        t = time.perf_counter()
        results = batched.run_many(queries)
        sync()
        batch_s.append(time.perf_counter() - t)
    launches = K.launches
    pallas_calls = sum(s_.calls for s_ in ctx.scorers() if s_.name == "pallas")
    spans["batched"] = telemetry.stage_breakdown(telemetry.get_tracer().finished())
    # ---- end of the counted run ----

    log(f"pipeline: local {n_local} queries in {sum(lat):.4f} s: "
        f"q/s={n_local / sum(lat):.3f} p50_ms={_percentile(lat, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(lat, 0.99) * 1e3:.3f}")
    med = statistics.median(batch_s)
    log(f"pipeline: batched {len(queries)} queries per batch, {batches} batches: "
        f"batch_s={','.join(f'{b:.4f}' for b in batch_s)} q/s={len(queries) / med:.3f} "
        f"p50_ms={_percentile(batch_s, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(batch_s, 0.99) * 1e3:.3f} (every query of a batch "
        f"waits for the whole batch)")
    for target, rows in spans.items():
        for name, row in sorted(rows.items()):
            log(f"pipeline: {target} span {name}: count={int(row['count'])} "
                f"total_ms={row['total_ms']:.3f} mean_ms={row['mean_ms']:.4f}")
    log(f"pipeline: conv_tanh_maxpool launches={launches} over {pallas_calls} "
        f"pallas scorer calls")
    check(launches > 0, "the main path launched the conv kernel no time")
    check(launches == 2 * pallas_calls,
          f"expected 2 conv launches per pallas scorer call, got {launches} "
          f"for {pallas_calls} calls")

    # ---- what came out ----
    check(len(results) == len(queries), "batched plan lost queries")
    n_ranked = 0
    for cands, _ in results:
        check(len(cands) <= 10, "more than k=10 candidates")
        for c in cands:
            check(math.isfinite(c.score) and 0.0 <= c.score <= 1.0,
                  f"score {c.score} is not a probability")
        check([c.score for c in cands] == sorted((c.score for c in cands), reverse=True),
              "ranking is not sorted by score")
        n_ranked += bool(cands)
    check(n_ranked > len(queries) // 2, f"only {n_ranked} queries got candidates")
    log(f"pipeline: {n_ranked}/{len(queries)} queries ranked, scores finite "
        f"probabilities in descending order")
    log(f"pipeline: batched {_busy_share(torch, lambda: batched.run_many(queries))}")

    verify_plans([local, batched], queries[:n_local], tie_atol=TIE_ATOL)
    log(f"pipeline: local == batched on {n_local} queries (verify_plans, "
        f"tie_atol={TIE_ATOL})")
    eager = plan(ops.Retrieve(h=20) >> ops.Rerank("eager") % 10, "batched", ctx)
    verify_plans([batched, eager], queries, tie_atol=TIE_ATOL)
    log(f"pipeline: pallas rankings == eager rankings on {len(queries)} queries "
        f"(swaps only within tie_atol={TIE_ATOL})")

    # the card's scorer against the CPU's plain model on the same rows
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:8])
    on_card = backends.make_scorer("pallas", tree, cfg, buckets=(8,), device="cuda")
    on_cpu = backends.make_scorer("eager", tree, cfg, buckets=(8,), device="cpu")
    a = on_card(rows["q_tok"], rows["a_tok"], rows["feats"])
    b = on_cpu(rows["q_tok"], rows["a_tok"], rows["feats"])
    err = float(abs(a - b).max())
    check(bool(((abs(a - b)) <= 1e-5 + 1e-4 * abs(b)).all()),
          f"pallas on the card disagrees with eager on the CPU: {err}")
    log(f"pipeline: pallas on the card == eager on the CPU on 8 rows "
        f"(max_abs_err={err:.3e}, rtol=1e-4 atol=1e-5)")

    # the plan's pallas scorer at its top bucket, timed, then read against
    # its bound
    scorer = next(s_ for s_ in ctx.scorers() if s_.name == "pallas")
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:SCORER_ROWS])
    check(rows["q_tok"].shape[0] == SCORER_ROWS, f"fewer than {SCORER_ROWS} pairs")
    rows = (rows["q_tok"], rows["a_tok"], rows["feats"])
    scorer(*rows)   # warm-up
    ms = _median_ms(torch, lambda: scorer(*rows), SCORER_CALLS)
    log(f"pipeline: the pallas scorer at bucket {SCORER_ROWS}: median {ms:.3f} ms of "
        f"{SCORER_CALLS} calls (host clock, numpy rows in, scores out)")
    pair_serve = {s_.name: s_ for s_ in TEXTPAIR_SHAPES}["pair_serve"]
    _step_roofline(torch, cfg.name, dataclasses.replace(pair_serve, batch=SCORER_ROWS),
                   lambda: scorer(*rows), ms, f"pipeline: pallas scorer at {SCORER_ROWS}")
    return {"launches": launches, "world": (tree, corpus, tok, index)}


# ---------------------------------------------------------------- backends --

def _swaps(want, got, what: str) -> int:
    """The neighbour swaps between two top-k lists of one query; any other
    difference, or a swap of scores ``SWAP_ATOL`` or more apart in ``want``,
    fails. A last place that differs counts as a swap with the candidate
    past the cut when the two scores are that close."""
    ids = [(c.doc_id, c.sent_id) for c in want]
    gids = [(c.doc_id, c.sent_id) for c in got]
    check(len(ids) == len(gids), f"{what}: {len(gids)} candidates, eager {len(ids)}")
    swaps, i = 0, 0
    while i < len(ids):
        if ids[i] == gids[i]:
            i += 1
            continue
        if i + 1 < len(ids):
            check(ids[i] == gids[i + 1] and ids[i + 1] == gids[i]
                  and abs(want[i].score - want[i + 1].score) < SWAP_ATOL,
                  f"{what}: rank {i} differs from eager's beyond a swap of near-ties "
                  f"({gids[i]} for {ids[i]})")
            i += 2
        else:
            check(abs(want[i].score - got[i].score) < SWAP_ATOL,
                  f"{what}: last place differs from eager's ({gids[i]} for {ids[i]})")
            i += 1
        swaps += 1
    return swaps


def phase_backends(torch, cfg, world) -> dict:
    import numpy as np
    from torch._dynamo.utils import counters

    from repro_torch.core import backends, ops
    from repro_torch.core.plan import PlanContext, plan
    from repro_torch.data import qa
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving import telemetry

    tree, corpus, tok, index = world
    buckets = BACKEND_BUCKETS
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:buckets[-1]])
    q, a, f = rows["q_tok"], rows["a_tok"], rows["feats"]
    eager = backends.make_scorer("eager", tree, cfg, buckets, device="cuda")
    want = {b: eager(q[:b], a[:b], f[:b]) for b in buckets}
    log(f"backends: sm-cnn full width, buckets {buckets}, {BACKEND_CALLS} timed calls "
        f"a bucket (host clock around each Scorer call, which ends in the copy of "
        f"the scores to the host)")
    table = {}
    for name in backends.BACKENDS:
        t0 = time.perf_counter()
        scorer = backends.make_scorer(name, tree, cfg, buckets, device="cuda")
        table[name] = {"scorer": scorer}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stats = scorer.programs
        errs = {}
        for b in buckets:   # first calls: jit compiles here
            got = scorer(q[:b], a[:b], f[:b])
            errs[b] = float(abs(got - want[b]).max())
            check(bool((abs(got - want[b]) <= 1e-5 + 1e-4 * abs(want[b])).all()),
                  f"backends: {name} bucket {b} disagrees with eager: {errs[b]:.3e}")
        compiles = stats.compiles if stats else 0
        if name == "jit":
            check(compiles == len(buckets),
                  f"backends: jit compiled {compiles} programs for {len(buckets)} buckets")
        if name == "aot":
            check(compiles == len(buckets) and stats.replays == len(buckets),
                  f"backends: aot compiled {compiles} programs and replayed "
                  f"{stats.replays} graphs for {len(buckets)} buckets and calls")
            check(stats.inputs == [3] * len(buckets),
                  f"backends: aot's programs take {stats.inputs} inputs, not the 3 rows "
                  f"alone: the weights were not frozen into constants")
        if name == "jit":
            check(all(n > 3 for n in stats.inputs),
                  f"backends: jit's programs take {stats.inputs} inputs: the weights "
                  f"are not arguments")

        # ---- timed calls, counted ----
        graphs = counters["stats"]["unique_graphs"]
        replays = stats.replays if stats else 0
        K.reset_launches()
        calls0 = scorer.calls
        per_bucket = {}
        for b in buckets:
            lat = []
            for _ in range(BACKEND_CALLS):
                t = time.perf_counter()
                scorer(q[:b], a[:b], f[:b])
                lat.append(time.perf_counter() - t)
            per_bucket[b] = lat
        launches, calls = K.launches, scorer.calls - calls0
        # ---- end of the counted calls ----
        check(launches == (2 * calls if name == "pallas" else 0),
              f"backends: {name} launched the conv kernel {launches} times in {calls} calls")
        check(counters["stats"]["unique_graphs"] == graphs
              and (stats.compiles if stats else 0) == compiles,
              f"backends: {name} compiled during the timed calls")
        if name == "aot":
            check(stats.replays - replays == calls,
                  f"backends: aot replayed {stats.replays - replays} graphs in {calls} calls")
        log(f"backends: {name} build_s={build_s:.3f} compiled={compiles} "
            f"conv_launches={launches} in {calls} calls"
            + (f" graph_replays={stats.replays - replays}" if name == "aot" else "")
            + (f" program_inputs={stats.inputs}" if stats else "")
            + f" max_abs_err_vs_eager={max(errs.values()):.3e}")
        table[name].update(build_s=build_s, buckets={})
        for b, lat in per_bucket.items():
            p50, p99 = _percentile(lat, 0.5) * 1e3, _percentile(lat, 0.99) * 1e3
            table[name]["buckets"][b] = (p50, p99)
            log(f"backends: {name} bucket {b}: p50_ms={p50:.4f} p99_ms={p99:.4f} "
                f"rows/s={b / (p50 / 1e3):.1f}")

    # ---- the ranking pipeline on each backend ----
    # Each backend ranks in a context of its own: its own featurization
    # cache and scorers. Every bucket of its scorers is built on rows of
    # zeros, and the plans warm up on questions that no timed run takes.
    # Each timed batch then takes questions the context has not seen, as
    # ranking traffic does, and the backends take turns batch by batch, so
    # that the host's drift falls on all of them alike.
    queries = corpus.questions
    start = BACKEND_WARM_Q + BACKEND_ROUNDS * BACKEND_BATCH_Q
    timed = [queries[BACKEND_WARM_Q + r * BACKEND_BATCH_Q:][:BACKEND_BATCH_Q]
             for r in range(BACKEND_ROUNDS)]
    local_q = queries[start:start + BACKEND_LOCAL_Q]
    check(len(local_q) == BACKEND_LOCAL_Q,
          f"backends: {len(queries)} questions are too few for the timed runs")
    names = ("eager",) + tuple(n for n in backends.BACKENDS if n != "eager")
    runs = {}
    for name in names:
        ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
        pipe = ops.Retrieve(h=20) >> ops.Rerank(name) % 10
        t0 = time.perf_counter()
        local, batched = plan(pipe, "local", ctx), plan(pipe, "batched", ctx)
        mine = [s_ for s_ in ctx.scorers() if s_.name == name]
        for s_ in mine:
            for b in s_._buckets:
                s_(np.zeros((b, cfg.max_len), np.int32), np.zeros((b, cfg.max_len), np.int32),
                   np.zeros((b, cfg.n_extra_feats), np.float32))
        local.run_many(queries[:BACKEND_WARM_Q])
        batched.run_many(queries[:BACKEND_WARM_Q])
        torch.cuda.synchronize()
        compiles = [s_.programs.compiles if s_.programs else 0 for s_ in mine]
        if name in ("jit", "aot"):
            for s_, c in zip(mine, compiles):
                check(c == len(s_._buckets),
                      f"backends: {name} compiled {c} programs for ladder {s_._buckets}")
        runs[name] = {"local": local, "batched": batched, "mine": mine,
                      "compiles": compiles, "warm_s": time.perf_counter() - t0,
                      "batch_s": [], "feat": [], "lat": []}

    # ---- timed, in turns; a last batch runs the last one's questions
    # again, so that its featurization comes from the context's cache ----
    graphs = counters["stats"]["unique_graphs"]
    tracer = telemetry.get_tracer()
    results = {}
    for r, qs in enumerate(timed + timed[-1:]):
        for name in names:
            run = runs[name]
            tracer.clear()
            t = time.perf_counter()
            res = run["batched"].run_many(qs)
            torch.cuda.synchronize()
            run["batch_s"].append(time.perf_counter() - t)
            feats = [sp for sp in tracer.finished() if sp.name == "featurize"]
            run["feat"].append((sum(sp.dur_us for sp in feats) / 1e3,
                                sum(int(sp.attrs.get("hits", 0)) for sp in feats),
                                sum(int(sp.attrs.get("misses", 0)) for sp in feats)))
            if r == 0:
                results[name] = res
    tracer.clear()
    for qq in local_q:
        for name in names:
            t = time.perf_counter()
            runs[name]["local"].run(qq)
            torch.cuda.synchronize()
            runs[name]["lat"].append(time.perf_counter() - t)
    # ---- end of the timed runs ----
    check(counters["stats"]["unique_graphs"] == graphs,
          "backends: a pipeline compiled a graph while timed")

    for name in names:
        run, mine = runs[name], runs[name]["mine"]
        check([s_.programs.compiles if s_.programs else 0 for s_ in mine] == run["compiles"],
              f"backends: the {name} pipeline compiled while timed")
        swaps = sum(_swaps(w, g, f"backends: {name} query {i}")
                    for i, ((w, _), (g, _)) in enumerate(zip(results["eager"], results[name])))
        batch_s, feat, lat = run["batch_s"][:-1], run["feat"][:-1], run["lat"]
        med = statistics.median(batch_s)
        busy = _busy_share(torch, lambda: run["batched"].run_many(timed[0]))
        log(f"backends: {name} pipeline batched, profiled on the first batch's "
            f"questions: {busy}")
        log(f"backends: {name} pipeline ladders={[s_._buckets for s_ in mine]} "
            f"compiled={run['compiles']} "
            f"inputs={[s_.programs.inputs for s_ in mine if s_.programs]} "
            f"warm-up {run['warm_s']:.3f} s; batched {BACKEND_BATCH_Q} unseen q "
            f"batch_s={','.join(f'{b_:.4f}' for b_ in batch_s)} q/s={BACKEND_BATCH_Q / med:.3f} "
            f"featurize_ms={','.join(f'{f_[0]:.3f}' for f_ in feat)} "
            f"cache hits={','.join(str(f_[1]) for f_ in feat)} "
            f"misses={','.join(str(f_[2]) for f_ in feat)}; the last batch's questions "
            f"again: batch_s={run['batch_s'][-1]:.4f} featurize_ms={run['feat'][-1][0]:.3f} "
            f"hits={run['feat'][-1][1]} misses={run['feat'][-1][2]}; "
            f"local {BACKEND_LOCAL_Q} unseen q p50_ms={_percentile(lat, 0.5) * 1e3:.3f} "
            f"p99_ms={_percentile(lat, 0.99) * 1e3:.3f}; "
            f"top-10 == eager's with {swaps} near-tie swaps")
        table[name]["pipeline"] = {"qps": BACKEND_BATCH_Q / med, "swaps": swaps,
                                   "p50_ms": _percentile(lat, 0.5) * 1e3,
                                   "p99_ms": _percentile(lat, 0.99) * 1e3}
    return table


# ----------------------------------------------------------------- service --

def _rpc_table_row(torch, scorer, handler, reqs, K, SV, telemetry) -> dict:
    """One Table 2 row: ``SERVICE_RPCS`` get_score RPCs from one client to a
    SimpleServer over ``handler``, each timed on the host clock; the conv's
    launch counter and the scorer's call count read around them, and the
    p50 of the server's request spans (``server.score``: decode to reply
    encoded) and of the scorer's spans inside them. The same pairs then go
    through the handler in process, one a call: back to back on this thread,
    and on a second thread that a queue wakes for each call and that hands
    each score back through another, as the server's thread is woken by
    each request (the socket, codec and spans left out)."""
    tracer = telemetry.get_tracer()
    with SV.SimpleServer(handler).start_background() as srv, SV.Client(srv.address) as cl:
        for q, a in reqs[:SERVICE_WARM]:
            cl.get_score(q, a)
        torch.cuda.synchronize()
        tracer.clear()
        # ---- the service path, counted ----
        K.reset_launches()
        calls0 = scorer.calls
        lat, got = [], []
        t0 = time.perf_counter()
        for q, a in reqs:
            t = time.perf_counter()
            got.append(cl.get_score(q, a))
            lat.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
        # ---- end of the counted RPCs ----
    spans = {}
    for sp in tracer.finished():
        spans.setdefault(sp.name, []).append(sp.dur_us / 1e3)
    tracer.clear()
    local_lat, want = [], []
    for q, a in reqs:
        t = time.perf_counter()
        want.append(float(handler.get_scores([(q, a)])[0]))
        local_lat.append(time.perf_counter() - t)
    inbox, outbox = queue.Queue(), queue.Queue()

    def serve():
        for pair in iter(inbox.get, None):
            outbox.put(float(handler.get_scores([pair])[0]))

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    woken_lat = []
    try:
        for q, a in reqs:
            t = time.perf_counter()
            inbox.put((q, a))
            outbox.get(timeout=SERVICE_WAIT_S)
            woken_lat.append(time.perf_counter() - t)
    finally:
        inbox.put(None)
        worker.join(timeout=SERVICE_WAIT_S)
    check(not worker.is_alive(), "service: the woken handler thread did not stop")
    return {"lat": lat, "wall": wall, "got": got, "want": want, "launches": launches,
            "calls": calls, "local_lat": local_lat, "woken_lat": woken_lat,
            "server_p50_ms": _percentile(spans.get("server.score", [0.0]), 0.5),
            "scorer_span_p50_ms": _percentile(spans.get("scorer", [0.0]), 0.5)}


def _concurrent_rows(scorer, handler, pairs, name, K, SV) -> dict:
    """``ENGINE_CLIENTS`` client threads at once, each sending its own share
    of ``pairs`` one ``get_score`` at a time, to a ThreadPoolServer of as
    many workers over ``handler``; every reply is held against its pair's
    score from the handler in process, one pair a call. Returns q/s, p50
    and p99 ms, the conv's launches and the scorer's calls."""
    import numpy as np

    results, lat = {}, {}
    with SV.ThreadPoolServer(handler, num_workers=ENGINE_CLIENTS).start_background() as srv:
        def client(c: int) -> None:
            out, ls = [], []
            with SV.Client(srv.address) as cl:
                for q, a in pairs[c::ENGINE_CLIENTS]:
                    t = time.perf_counter()
                    out.append(cl.get_score(q, a))
                    ls.append(time.perf_counter() - t)
            results[c], lat[c] = out, ls

        threads = [threading.Thread(target=client, args=(c,)) for c in range(ENGINE_CLIENTS)]
        K.reset_launches()
        calls0 = scorer.calls
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVICE_WAIT_S)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
    check(not any(t.is_alive() for t in threads) and len(results) == ENGINE_CLIENTS,
          f"service: a concurrent {name} client did not finish")
    want = [float(handler.get_scores([p])[0]) for p in pairs]
    err = 0.0
    for c, got in results.items():
        got, ref = np.asarray(got), np.asarray(want[c::ENGINE_CLIENTS])
        err = max(err, float(abs(got - ref).max()))
        check(len(got) == len(ref) and bool((abs(got - ref) <= 1e-5 + 1e-4 * abs(ref)).all()),
              f"service: {name} behind a ThreadPoolServer answered client {c} with "
              f"scores not its own pairs' (max error {err:.3e})")
    check(calls == len(pairs) and launches == (2 * calls if name == "pallas" else 0),
          f"service: {len(pairs)} concurrent {name} RPCs made {calls} scorer calls and "
          f"{launches} conv launches")
    all_lat = [x for v in lat.values() for x in v]
    p50, p99 = _percentile(all_lat, 0.5) * 1e3, _percentile(all_lat, 0.99) * 1e3
    log(f"service: concurrent {name}: ThreadPoolServer {ENGINE_CLIENTS} workers, "
        f"{ENGINE_CLIENTS} client threads x {len(pairs) // ENGINE_CLIENTS} RPCs of pairs "
        f"of their own: q/s={len(pairs) / wall:.3f} p50_ms={p50:.4f} p99_ms={p99:.4f}; "
        f"every reply its own pair's score (max_abs_err_vs_in_process={err:.3e}); "
        f"conv_launches={launches} in {calls} scorer calls")
    return {"qps": len(pairs) / wall, "p50_ms": p50, "p99_ms": p99, "launches": launches}


def phase_service(torch, cfg, world, scorers: dict) -> dict:
    """The paper's first integration strategy, the Thrift-style service
    (its Table 2), on the card; ``scorers`` are the backends phase's, with
    their bucket-1 p50."""
    import numpy as np

    from repro_torch.core import ops, wire
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext, plan, verify_plans
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving.admission import AdmissionController
    from repro_torch.serving import telemetry
    from repro_torch.serving.engine import PipelineEngine, ServingEngine

    tree, corpus, tok, index = world
    reqs = [(corpus.questions[qi], corpus.documents[di][si])
            for qi, di, si, _ in corpus.pairs[:SERVICE_RPCS]]
    check(len(reqs) == SERVICE_RPCS, f"service: {len(reqs)} pairs, fewer than {SERVICE_RPCS}")
    log(f"service: Table 2: {SERVICE_RPCS} get_score RPCs a backend from one client "
        f"thread to a SimpleServer over a QuestionAnsweringHandler (tokenize + overlap "
        f"features + the backends phase's scorer) on 127.0.0.1, host clock around each "
        f"RPC; overhead = RPC p50 - the same handler's p50 in process, back to back, in "
        f"this run (the codec, loopback and wake-ups); overhead_vs_b1 = RPC p50 - that "
        f"scorer's bucket-1 p50 in the backends phase")
    live = sorted(t.name for t in threading.enumerate())
    log(f"service: {len(live)} threads live in the process before serving: {', '.join(live)}")

    class NullHandler:
        """The service stack alone: no featurization, no scorer."""
        calls = 0

        def get_scores(self, pairs):
            self.calls += 1
            return np.zeros(len(pairs))

    null = NullHandler()
    r = _rpc_table_row(torch, null, null, reqs, K, SV, telemetry)
    check(r["launches"] == 0 and r["calls"] == SERVICE_RPCS and not any(r["got"]),
          "service: the null handler's RPCs went wrong")
    p50, p99 = _percentile(r["lat"], 0.5) * 1e3, _percentile(r["lat"], 0.99) * 1e3
    log(f"service: table2 null handler (codec, socket, server dispatch and spans; no "
        f"featurization, no scorer): q/s={SERVICE_RPCS / r['wall']:.3f} p50_ms={p50:.4f} "
        f"p99_ms={p99:.4f} server_span_p50_ms={r['server_p50_ms']:.4f}")
    rows = {"null": {"qps": SERVICE_RPCS / r["wall"], "p50_ms": p50, "p99_ms": p99}}
    for name in SERVICE_BACKENDS:
        scorer = scorers[name]["scorer"]
        compiles = scorer.programs.compiles if scorer.programs else 0
        handler = SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
        r = _rpc_table_row(torch, scorer, handler, reqs, K, SV, telemetry)
        got, want = np.asarray(r["got"]), np.asarray(r["want"])
        err = float(abs(got - want).max())
        check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()),
              f"service: {name} RPC scores disagree with the scorer in process: {err:.3e}")
        check(r["calls"] == SERVICE_RPCS,
              f"service: {name} scorer called {r['calls']} times for {SERVICE_RPCS} RPCs")
        check(r["launches"] == (2 * SERVICE_RPCS if name == "pallas" else 0),
              f"service: {name} launched the conv kernel {r['launches']} times in "
              f"{SERVICE_RPCS} RPCs")
        check((scorer.programs.compiles if scorer.programs else 0) == compiles,
              f"service: {name} compiled while serving")
        p50, p99 = _percentile(r["lat"], 0.5) * 1e3, _percentile(r["lat"], 0.99) * 1e3
        h50 = _percentile(r["local_lat"], 0.5) * 1e3
        w50 = _percentile(r["woken_lat"], 0.5) * 1e3
        s50 = scorers[name]["buckets"][1][0]
        rows[name] = {"qps": SERVICE_RPCS / r["wall"], "p50_ms": p50, "p99_ms": p99,
                      "scorer_p50_ms": s50, "overhead_ms": p50 - h50,
                      "overhead_vs_b1_ms": p50 - s50, "handler_p50_ms": h50,
                      "woken_p50_ms": w50,
                      "launches": r["launches"], "server_p50_ms": r["server_p50_ms"],
                      "scorer_span_p50_ms": r["scorer_span_p50_ms"]}
        log(f"service: table2 {name}: q/s={SERVICE_RPCS / r['wall']:.3f} p50_ms={p50:.4f} "
            f"p99_ms={p99:.4f} overhead_p50_ms={p50 - h50:.4f} over the handler in "
            f"process (p50_ms={h50:.4f} back to back: featurize + scorer; {w50:.4f} on a "
            f"woken thread); overhead_vs_b1_ms={p50 - s50:.4f} over scorer_b1_p50_ms="
            f"{s50:.4f}; server span p50_ms={r['server_p50_ms']:.4f}, the "
            f"scorer's span in it {r['scorer_span_p50_ms']:.4f}) "
            f"conv_launches={r['launches']} in {r['calls']} "
            f"scorer calls; max_abs_err_vs_in_process={err:.3e}")

    engine_reqs = [(corpus.questions[qi], corpus.documents[di][si])
                   for qi, di, si, _ in corpus.pairs[:ENGINE_CLIENTS * SERVICE_RPCS]]
    check(len(engine_reqs) == ENGINE_CLIENTS * SERVICE_RPCS,
          f"service: {len(engine_reqs)} pairs for the concurrent clients")

    # ---- every backend behind a ThreadPoolServer under concurrent clients:
    # one scorer called from many threads at once answers each its own pair ----
    for name in SERVICE_BACKENDS:
        rows[name]["concurrent"] = _concurrent_rows(
            scorers[name]["scorer"], SV.QuestionAnsweringHandler(
                scorers[name]["scorer"], tok, corpus.idf, cfg.max_len),
            engine_reqs[:ENGINE_CLIENTS * CONCURRENT_RPCS], name, K, SV)

    # ---- beyond the paper: the micro-batching engine under concurrent clients,
    # each sending pairs of its own, every pair once ----
    scorer = scorers["pallas"]["scorer"]
    with ServingEngine(scorer, tok, corpus.idf, cfg.max_len, max_batch=ENGINE_MAX_BATCH,
                       max_wait_s=ENGINE_MAX_WAIT_S) as eng, \
            SV.ThreadPoolServer(eng, num_workers=ENGINE_CLIENTS).start_background() as srv:
        with SV.Client(srv.address) as cl:
            for q, a in reqs[:SERVICE_WARM]:
                cl.get_score(q, a)
        results, lat = {}, {}

        def client(c: int) -> None:
            mine = engine_reqs[c::ENGINE_CLIENTS]
            out, ls = [], []
            with SV.Client(srv.address) as cl_:
                for q, a in mine:
                    t = time.perf_counter()
                    out.append(cl_.get_score(q, a))
                    ls.append(time.perf_counter() - t)
            results[c], lat[c] = (mine, out), ls

        threads = [threading.Thread(target=client, args=(c,)) for c in range(ENGINE_CLIENTS)]
        b0 = eng.batcher.stats()["batches"]
        K.reset_launches()
        calls0 = scorer.calls
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVICE_WAIT_S)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
        check(not any(t.is_alive() for t in threads) and len(results) == ENGINE_CLIENTS,
              "service: an engine client did not finish")
        stats = eng.stats()
        batches = stats["batches"] - b0
    n = sum(len(v) for v in lat.values())
    all_lat = [x for v in lat.values() for x in v]
    pairs = [p for mine, _ in results.values() for p in mine]
    got = np.asarray([x for _, out in results.values() for x in out])
    want = np.concatenate([SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
                           .get_scores(pairs[i:i + 256]) for i in range(0, len(pairs), 256)])
    err = float(abs(got - want).max())
    check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()),
          f"service: engine RPC scores disagree with the scorer in process: {err:.3e}")
    check(launches == 2 * calls and calls == batches,
          f"service: the engine's {batches} batches made {calls} scorer calls and "
          f"{launches} conv launches")
    p50, p99 = _percentile(all_lat, 0.5) * 1e3, _percentile(all_lat, 0.99) * 1e3
    rows["engine"] = {"qps": n / wall, "p50_ms": p50, "p99_ms": p99,
                      "mean_batch": n / max(batches, 1), "launches": launches}
    log(f"service: table2 engine (ServingEngine pallas, max_batch={ENGINE_MAX_BATCH}, "
        f"max_wait_s={ENGINE_MAX_WAIT_S}, ThreadPoolServer {ENGINE_CLIENTS} workers, "
        f"{ENGINE_CLIENTS} client threads x {n // ENGINE_CLIENTS} RPCs): q/s={n / wall:.3f} "
        f"p50_ms={p50:.4f} p99_ms={p99:.4f} mean_batch={n / max(batches, 1):.3f} over "
        f"{int(batches)} batches; conv_launches={launches} in {calls} scorer calls; "
        f"max_abs_err_vs_in_process={err:.3e}")

    # ---- the remote targets against servers on the card ----
    ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    server_ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    queries = corpus.questions[-SERVICE_PLAN_Q:]
    handler = SV.QuestionAnsweringHandler(server_ctx.scorer_for("pallas"), tok, corpus.idf,
                                          cfg.max_len)
    engine = PipelineEngine(pipe, server_ctx, target="batched")
    plans = []
    with SV.ThreadPoolServer(handler, admission=AdmissionController(1024)
                             ).start_background() as srv, \
            SV.ThreadPoolServer(engine, admission=AdmissionController(
                SERVICE_PLAN_Q * engine.rows_per_query)).start_background() as psrv:
        try:
            plans = [plan(pipe, "local", ctx),
                     plan(pipe, "remote", ctx=ctx, remote=srv.address),
                     plan(pipe, "remote_pipeline", ctx=ctx, remote=psrv.address)]
            for p in plans:
                log(f"service: {p.describe()}")
            K.reset_launches()
            all_scorers = ctx.scorers() + server_ctx.scorers()
            calls0 = sum(s_.calls for s_ in all_scorers)
            t0 = time.perf_counter()
            verify_plans(plans, queries, tie_atol=TIE_ATOL)
            verify_s = time.perf_counter() - t0
            launches = K.launches
            calls = sum(s_.calls for s_ in all_scorers) - calls0
            check(launches > 0 and launches == 2 * calls,
                  f"service: the plans made {calls} pallas scorer calls and {launches} "
                  f"conv launches")
            log(f"service: local == remote == remote_pipeline on {len(queries)} unseen "
                f"questions (verify_plans, tie_atol={TIE_ATOL}) in {verify_s:.3f} s; "
                f"conv_launches={launches} in {calls} pallas scorer calls")
            timed = {}
            for p in plans:
                t = time.perf_counter()
                p.run_many(queries)
                timed[p.target] = len(queries) / (time.perf_counter() - t)
            log("service: the same questions again, q/s: "
                + " ".join(f"{k}={v:.3f}" for k, v in timed.items()))

            # a deadline already past sheds before any work
            with SV.Client(srv.address) as cl:
                try:
                    cl.get_score(*reqs[0], deadline_s=0.0)
                    shed = None
                except wire.ShedError as e:
                    shed = str(e)
                check(shed is not None and "expired" in shed,
                      f"service: a past deadline was not shed ({shed!r})")
                check(srv.stats()["shed_expired"] == 1.0,
                      "service: the admission controller counted no expired shed")
            log(f"service: a frame with a past deadline came back as ShedError ({shed})")

            # drain: in-flight work finishes, new work sheds, inflight reaches 0
            done = {}

            def ranking():
                with SV.Client(psrv.address) as cl_:
                    done["rankings"] = cl_.rank_batch(queries)

            th = threading.Thread(target=ranking)
            th.start()
            with SV.Client(psrv.address) as cl:
                t_end = time.perf_counter() + SERVICE_WAIT_S
                while psrv.state.inflight == 0 and th.is_alive() \
                        and time.perf_counter() < t_end:
                    time.sleep(0.0005)
                inflight = cl.drain()["inflight"]
                try:
                    cl.rank(queries[0])
                    drained_shed = None
                except wire.ShedError as e:
                    drained_shed = str(e)
                check(drained_shed is not None and "draining" in drained_shed,
                      f"service: a draining server took new work ({drained_shed!r})")
                while cl.health()["inflight"] > 0 and time.perf_counter() < t_end:
                    time.sleep(0.001)
                health = cl.health()
            th.join(timeout=SERVICE_WAIT_S)
            check(health["inflight"] == 0.0 and health["draining"] == 1.0,
                  f"service: drain left {health['inflight']} requests in flight")
            check(not th.is_alive() and len(done.get("rankings", [])) == len(queries),
                  "service: the in-flight ranking did not finish during the drain")
            log(f"service: drain acked with {inflight:.0f} in flight, shed new work "
                f"({drained_shed}), health inflight reached 0; the in-flight batch of "
                f"{len(queries)} finished")
        finally:
            for p in plans:
                p.close()
    return rows


# ------------------------------------------------------------------ launch --

def _rank_ids(rankings):
    return [[(d, s) for d, s, _ in r] for r in rankings]


def _same_rankings(got, want, what: str) -> float:
    """Rankings of (doc, sent, score) lists: the same ids, scores within
    rtol 1e-4 / atol 1e-5. Returns the largest score difference."""
    check(len(got) == len(want), f"{what}: {len(got)} rankings for {len(want)} queries")
    err = 0.0
    for g, w in zip(got, want):
        check([(d, s) for d, s, _ in g] == [(d, s) for d, s, _ in w],
              f"{what}: ranking {[(d, s) for d, s, _ in g]} differs from "
              f"{[(d, s) for d, s, _ in w]}")
        for (_, _, a), (_, _, b) in zip(g, w):
            check(abs(a - b) <= 1e-5 + 1e-4 * abs(b), f"{what}: score {a} against {b}")
            err = max(err, abs(a - b))
    return err


def _clients(n_threads: int, work, what: str) -> dict:
    """``n_threads`` threads each running ``work(c) -> [(latency_s, ...)]``;
    returns per-thread results, the wall time and the latencies."""
    results = {}

    def run(c):
        results[c] = work(c)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=LAUNCH_WAIT_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and len(results) == n_threads,
          f"launch: a {what} client did not finish")
    lat = [x[0] for v in results.values() for x in v]
    return {"results": results, "wall": wall, "n": len(lat),
            "qps": len(lat) / wall, "p50_ms": _percentile(lat, 0.5) * 1e3,
            "p99_ms": _percentile(lat, 0.99) * 1e3}


class _ServedTarget:
    """A live server as a ``RolloutController`` target: ``swap_version`` is
    MSG_SWAP, ``model_version`` MSG_VERSION, the canaries ``rank_batch``."""

    def __init__(self, client):
        self.client = client

    @property
    def model_version(self):
        return self.client.version()[0]

    def swap_version(self, version):
        return self.client.swap(version)[0]

    def rank_batch(self, queries):
        return self.client.rank_batch(queries)


def _launch_train(torch, cfg, world, tmp: Path) -> dict:
    """(a) Full-width sm-cnn trained on the card, its weights served by
    pallas against eager, a checkpoint restored on the CPU and published."""
    import functools

    from repro_torch.core import backends
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import qa
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.launch.world import build_world
    from repro_torch.models import sm_cnn
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import Trainer

    tree, corpus, tok, _ = world

    def stream():
        ep = 0
        while True:
            yield from qa.pair_batches(corpus, tok, cfg.max_len, LAUNCH_BATCH, seed=ep)
            ep += 1

    tr = Trainer(functools.partial(sm_cnn.loss_fn, cfg=cfg), adamw(3e-3),
                 sm_cnn.params_from_numpy(tree, "cuda"))
    t0 = time.perf_counter()
    tr.run(stream(), max_steps=LAUNCH_TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in tr.history]
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    check(all(math.isfinite(x) for x in losses), "launch: a training loss is not finite")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"launch: the loss did not fall ({first:.4f} -> {last:.4f})")
    check(all(t.device.type == "cuda" for t in tree_leaves(tr.params)),
          "launch: trained params left the card")
    log(f"launch: trained full-width {cfg.name} on the card: {LAUNCH_TRAIN_STEPS} "
        f"steps of batch {LAUNCH_BATCH} (Trainer + adamw(3e-3), eager autograd) in "
        f"{train_s:.3f} s; step_ms first={step_ms[0]:.3f} "
        f"median(2..{LAUNCH_TRAIN_STEPS})={statistics.median(step_ms[1:]):.4f} "
        f"p99={_percentile(step_ms[1:], 0.99):.4f}; loss mean of first 5 {first:.5f} "
        f"-> last 5 {last:.5f} (acc {tr.history[-1]['acc']:.4f})")

    # the trained weights served by the conv kernel against eager on the card
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:256])
    K.reset_launches()
    got = backends.make_scorer("pallas", tr.params, cfg, buckets=(256,),
                               device="cuda")(rows["q_tok"], rows["a_tok"], rows["feats"])
    launches = K.launches
    want = backends.make_scorer("eager", tr.params, cfg, buckets=(256,),
                                device="cuda")(rows["q_tok"], rows["a_tok"], rows["feats"])
    err = float(abs(got - want).max())
    check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()) and launches == 2,
          f"launch: trained weights: pallas against eager {err:.3e}, {launches} launches")
    log(f"launch: trained weights served by pallas == eager on the card on 256 rows "
        f"(max_abs_err={err:.3e}, rtol 1e-4 atol 1e-5; {launches} conv launches)")

    # a checkpoint written from the card restores on the CPU bit-equal
    mgr = CheckpointManager(str(tmp / "ckpt"))
    mgr.save(tr.step, tr.params, tr.opt_state)
    cpu = lambda t: torch.zeros_like(t, device="cpu")  # noqa: E731
    params, opt, step = mgr.restore(tree_map(cpu, tr.params), tree_map(cpu, tr.opt_state))
    same = all(torch.equal(a, b.cpu()) for a, b in
               zip(tree_leaves(params) + tree_leaves(opt),
                   tree_leaves(tr.params) + tree_leaves(tr.opt_state)))
    check(same and step == LAUNCH_TRAIN_STEPS,
          "launch: the checkpoint did not restore on the CPU bit-equal")
    reg = ModelRegistry(str(tmp / "registry"))
    v_trained = mgr.publish_to_registry(reg).version_id
    v_seed = reg.publish(tree, model=cfg.name).version_id
    check(v_trained == reg.publish(params, model=cfg.name).version_id != v_seed,
          "launch: publish_checkpoint's id is not the id of the same weights")
    log(f"launch: checkpoint of step {step} written from the card restored on the "
        f"CPU bit-equal (params + adamw state, {len(tree_leaves(opt))} tensors); "
        f"published to a registry as {v_trained} (seed weights {v_seed})")

    t0 = time.perf_counter()
    lw = build_world(device="cuda")
    torch.cuda.synchronize()
    world_s = time.perf_counter() - t0
    log(f"launch: build_world() (the launcher's world, {lw[0].name}, 60 steps) on the "
        f"card in {world_s:.3f} s")
    return {"params": tr.params, "registry": reg, "v_seed": v_seed,
            "v_trained": v_trained, "step_ms": statistics.median(step_ms[1:]),
            "first_step_ms": step_ms[0], "train_s": train_s, "world_s": world_s,
            "loss": (first, last), "launcher_world": lw}


def _launch_pool(torch, cfg, world, params, service: dict) -> dict:
    """(b) ReplicaPools of 2 pallas and 2 aot replicas behind a
    ThreadPoolServer under 8 client threads with pairs of their own."""
    import numpy as np

    from repro_torch.core import backends
    from repro_torch.core import service as SV
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving.cluster import ReplicaPool

    _, corpus, tok, _ = world
    pairs = [(corpus.questions[qi], corpus.documents[di][si])
             for qi, di, si, _ in corpus.pairs[:LAUNCH_CLIENTS * CONCURRENT_RPCS]]
    ref = SV.QuestionAnsweringHandler(
        backends.make_scorer("eager", params, cfg, buckets=BACKEND_BUCKETS, device="cuda"),
        tok, corpus.idf, cfg.max_len)
    want = np.concatenate([ref.get_scores(pairs[i:i + 256])
                           for i in range(0, len(pairs), 256)])
    rows = {}
    for name in POOL_BACKENDS:
        t0 = time.perf_counter()
        pool = ReplicaPool.build(name, params, cfg, tok, corpus.idf,
                                 n_replicas=POOL_REPLICAS, buckets=BACKEND_BUCKETS,
                                 device="cuda")
        build_s = time.perf_counter() - t0
        with pool, SV.ThreadPoolServer(pool, num_workers=LAUNCH_CLIENTS
                                       ).start_background() as srv:
            with SV.Client(srv.address) as cl:
                for q, a in pairs[:SERVICE_WARM]:
                    cl.get_score(q, a)
            torch.cuda.synchronize()

            def work(c):
                out = []
                with SV.Client(srv.address) as cl_:
                    for i in range(c, len(pairs), LAUNCH_CLIENTS):
                        t = time.perf_counter()
                        score = cl_.get_score(*pairs[i])
                        out.append((time.perf_counter() - t, i, score))
                return out

            # ---- the launch path, counted ----
            K.reset_launches()
            calls0 = sum(r.batcher.scorer.calls for r in pool.replicas)
            run = _clients(LAUNCH_CLIENTS, work, f"{name} pool")
            launches = K.launches
            calls = sum(r.batcher.scorer.calls for r in pool.replicas) - calls0
            # ---- end of the counted run ----
            stats = pool.stats()
        err = 0.0
        for out in run["results"].values():
            for _, i, score in out:
                check(abs(score - want[i]) <= 1e-5 + 1e-4 * abs(want[i]),
                      f"launch: {name} pool answered pair {i} with {score}, its score "
                      f"in process is {want[i]}")
                err = max(err, abs(score - want[i]))
        check(run["n"] == len(pairs), f"launch: {name} pool answered {run['n']} RPCs")
        check(calls > 0 and launches == (2 * calls if name == "pallas" else 0),
              f"launch: {name} pool: {launches} conv launches in {calls} scorer calls")
        per_rep = [int(stats[f"replica{i}_requests"]) for i in range(POOL_REPLICAS)]
        single = service[name]["concurrent"]
        rows[name] = dict(qps=run["qps"], p50_ms=run["p50_ms"], p99_ms=run["p99_ms"],
                          launches=launches, calls=calls, build_s=build_s,
                          mean_batch=run["n"] / calls)
        log(f"launch: pool {name} x{POOL_REPLICAS} (built in {build_s:.3f} s) behind a "
            f"ThreadPoolServer, {LAUNCH_CLIENTS} client threads x {CONCURRENT_RPCS} "
            f"get_score RPCs of pairs of their own: q/s={run['qps']:.3f} "
            f"p50_ms={run['p50_ms']:.4f} p99_ms={run['p99_ms']:.4f} (one {name} scorer "
            f"behind a ThreadPoolServer, service phase: q/s={single['qps']:.3f} "
            f"p50_ms={single['p50_ms']:.4f} p99_ms={single['p99_ms']:.4f}); requests a "
            f"replica {per_rep}, {calls} scorer calls (mean batch "
            f"{run['n'] / calls:.3f}), conv_launches={launches}; every reply its own "
            f"pair's score (max_abs_err_vs_eager_in_process={err:.3e})")
    return rows


def _launch_rollout(torch, cfg, world, trained: dict) -> dict:
    """(c) Shadow, A/B and a guardrailed hot swap over MSG_SWAP between two
    registry versions of the full-width model, on the card."""
    import numpy as np

    from repro_torch.core import ops
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext
    from repro_torch.core.treepath import tree_map
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving import telemetry
    from repro_torch.serving.engine import PipelineEngine
    from repro_torch.serving.rollout import ABEngine, RolloutController, ShadowEngine

    tree, corpus, tok, index = world
    reg, va, vb = trained["registry"], trained["v_seed"], trained["v_trained"]
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    queries = corpus.questions[:ROLLOUT_Q]

    def engine(version):
        ctx = PlanContext.from_world(cfg, None, corpus, tok, index, registry=reg,
                                     model_version=version, device="cuda")
        return PipelineEngine(pipe, ctx, target="batched")

    solo = {v: engine(v).rank_batch(queries) for v in (va, vb)}
    differ = sum(a != b for a, b in zip(_rank_ids(solo[va]), _rank_ids(solo[vb])))
    check(differ > 0, "launch: the two versions rank every query alike")
    telemetry.reset_all()
    K.reset_launches()
    # ---- the rollout path, counted ----
    shadow = ShadowEngine(engine(va), engine(vb), fraction=1.0, max_pending=4)
    out = shadow.rank_batch(queries)
    check(shadow.drain(LAUNCH_WAIT_S), "launch: the shadow did not drain")
    err = _same_rankings(out, solo[va], "shadow primary")
    snap = telemetry.get_registry().snapshot()
    mirrored = sum(v for k, v in snap.items() if k.startswith("shadow_queries") and vb in k)
    changed = sum(v for k, v in snap.items()
                  if k.startswith("shadow_top1_changed") and vb in k)
    check(mirrored == len(queries) and not any(k.startswith("shadow_errors") for k in snap),
          f"launch: the shadow mirrored {mirrored} of {len(queries)} queries")
    log(f"launch: ShadowEngine(primary {va}, candidate {vb}, fraction 1.0) on "
        f"{len(queries)} questions: the primary's rankings == {va} alone "
        f"(max_abs_err={err:.3e}); {int(mirrored)} mirrored to {vb}, top-1 changed on "
        f"{int(changed)}; the versions' rankings differ on {differ} questions")

    ab = ABEngine(engine(va), engine(vb), split_pct=50.0)
    arms = [ab.arm_of(q) for q in queries]
    got = ab.rank_batch(queries)
    for i, (r, arm) in enumerate(zip(got, arms)):
        _same_rankings([r], [solo[vb if arm == "b" else va][i]], f"A/B arm {arm}")
    check({"a", "b"} == set(arms), "launch: the A/B split used one arm")
    snap = telemetry.get_registry().snapshot()
    per_arm = {v: sum(x for k, x in snap.items() if k.startswith("ab_queries") and v in k)
               for v in (va, vb)}
    check(per_arm == {va: arms.count("a"), vb: arms.count("b")},
          f"launch: ab_queries per version {per_arm}")
    log(f"launch: ABEngine 50/50: {arms.count('a')} questions to {va}, "
        f"{arms.count('b')} to {vb}; every reply == its arm's version alone")

    vbad = reg.publish(tree_map(lambda x: np.full(np.shape(x), np.nan, np.float32), tree),
                       model="broken").version_id
    with SV.ThreadPoolServer(engine(va), num_workers=2).start_background() as srv, \
            SV.Client(srv.address) as cl:
        ctrl = RolloutController(_ServedTarget(cl), canary_queries=queries[:4],
                                 canary_passes=1)
        bad = ctrl.hot_swap(vbad)
        check(bad.rolled_back and cl.version() == (va, "active"),
              f"launch: a NaN candidate was not rolled back ({bad})")
        good = ctrl.hot_swap(vb)
        check(good.swapped and cl.version() == (vb, "active"),
              f"launch: the trained version did not land ({good})")
        served = cl.rank_batch(queries)
    launches = K.launches
    # ---- end of the counted run ----
    err = _same_rankings(served, solo[vb], "after hot_swap")
    check(launches > 0, "launch: the rollout launched the conv kernel no time")
    log(f"launch: RolloutController.hot_swap through MSG_SWAP on a live ThreadPoolServer: "
        f"NaN candidate {vbad} rolled back ({bad.reason}); {vb} swapped in "
        f"{good.swap_ms:.3f} ms (canary p99 {good.baseline.p99_ms:.3f} -> "
        f"{good.candidate.p99_ms:.3f} ms); the server's rankings == {vb} alone "
        f"(max_abs_err={err:.3e}); conv_launches in the rollout runs={launches}")
    return {"launches": launches, "swap_ms": good.swap_ms}


def _read_ready(proc, timeout_s: float):
    found = {}
    tail = []

    def read():
        for line in proc.stdout:
            tail.append(line.rstrip())
            if line.startswith("FABRIC_READY "):
                _, host, port = line.split()
                found["address"] = (host, int(port))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout_s)
    check("address" in found, f"launch: the launcher never printed FABRIC_READY: {tail[-20:]}")
    return found["address"]


def _launch_cli() -> dict:
    """(d) The launcher as users start it: --describe, then a pipeline
    server, ranked through the port's Client, then --drain."""
    from repro_torch.core import service as SV
    from repro_torch.data import qa

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    # the pallas backend: the default, aot, compiles 10 inductor programs
    # here (89.6–121.0 s), which the backends phase already builds and checks
    out = subprocess.run(cmd + ["--describe", "--device", "cuda", "--backend", "pallas"],
                         env=env, cwd=str(ROOT), capture_output=True, text=True,
                         timeout=LAUNCH_WAIT_S)
    describe_s = time.perf_counter() - t0
    check(out.returncode == 0, f"launch: --describe failed: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 5 and lines[1].lstrip().startswith("local@cuda:")
          and lines[4].lstrip().startswith("remote_pipeline:"),
          f"launch: --describe printed {lines}")
    for line in lines:
        log(f"launch: describe | {line}")
    log(f"launch: python -m repro_torch.launch.serve --describe --device cuda "
        f"--backend pallas in {describe_s:.3f} s")

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--serve-pipeline", "--server", "threadpool",
                                   "--backend", "pallas", "--device", "cuda", "--port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=str(ROOT))
    try:
        host, port = _read_ready(proc, LAUNCH_WAIT_S)
        ready_s = time.perf_counter() - t0
        questions = qa.generate_corpus(n_docs=80, n_questions=60, seed=0).questions
        with SV.Client((host, port)) as cl:
            rankings = cl.rank_batch(questions[:32])
            version = cl.version()
        check(len(rankings) == 32 and sum(bool(r) for r in rankings) > 16,
              "launch: the launched server ranked too few questions")
        for r in rankings:
            check(all(math.isfinite(s) and 0.0 <= s <= 1.0 for _, _, s in r)
                  and [s for _, _, s in r] == sorted((s for _, _, s in r), reverse=True),
                  f"launch: a ranking is not in descending probabilities: {r}")
        drain = subprocess.run(cmd + ["--drain", f"{host}:{port}"], env=env, cwd=str(ROOT),
                               capture_output=True, text=True, timeout=LAUNCH_WAIT_S)
        check(drain.returncode == 0 and "draining=1" in drain.stdout
              and "inflight=0" in drain.stdout,
              f"launch: --drain printed {drain.stdout!r} {drain.stderr[-500:]!r}")
        log(f"launch: python -m repro_torch.launch.serve --serve-pipeline --server "
            f"threadpool --backend pallas --device cuda: FABRIC_READY after "
            f"{ready_s:.3f} s; rank_batch of 32 questions from the launcher's world: "
            f"{sum(bool(r) for r in rankings)} ranked, descending probabilities; "
            f"version {version}; --drain: {drain.stdout.strip()}")
    finally:
        proc.terminate()
        try:
            proc.wait(LAUNCH_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(LAUNCH_WAIT_S)
    return {"describe_s": describe_s, "ready_s": ready_s}


def _launch_fabric(trained: dict, tmp: Path) -> dict:
    """(e) The fabric: 1 and then 4 worker processes serving one registry
    version of the launcher's world with pallas on the card, against one
    in-process ThreadPoolServer over the same engine."""
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.launch import serve
    from repro_torch.serving.engine import PipelineEngine
    from repro_torch.serving.fabric import Fabric

    cfg, params, corpus, tok, index, _ = trained["launcher_world"]
    reg_dir = str(tmp / "fabric_registry")
    reg = ModelRegistry(reg_dir)
    vid = reg.publish(params, model=cfg.name).version_id
    ctx = PlanContext.from_world(cfg, params, corpus, tok, index, buckets=(1, 8, 64, 256),
                                 registry=reg, model_version=vid, device="cuda")
    engine = PipelineEngine(serve.canonical_pipeline("pallas"), ctx)
    queries = corpus.questions
    want = engine.rank_batch(queries)
    want_of = dict(zip(queries, want))

    def load(rank_batch_of):
        def work(c):
            out = []
            for i in range(FABRIC_RPCS):
                q = queries[(c * FABRIC_RPCS + i) % len(queries)]
                t = time.perf_counter()
                r = rank_batch_of(c)([q])
                out.append((time.perf_counter() - t, q, r[0]))
            return out
        return work

    def held(run, what):
        err = 0.0
        for out in run["results"].values():
            for _, q, r in out:
                err = max(err, _same_rankings([r], [want_of[q]], what))
        return err

    rows = {}
    with SV.ThreadPoolServer(engine, num_workers=LAUNCH_CLIENTS).start_background() as srv:
        clients = [SV.Client(srv.address) for _ in range(LAUNCH_CLIENTS)]
        try:
            for cl in clients:
                cl.rank_batch(queries[:2])
            run = _clients(LAUNCH_CLIENTS, load(lambda c: clients[c].rank_batch),
                           "single-server")
        finally:
            for cl in clients:
                cl.close()
    err = held(run, "one ThreadPoolServer")
    rows["server"] = run
    log(f"launch: one process: ThreadPoolServer({LAUNCH_CLIENTS} workers) over "
        f"PipelineEngine({serve.canonical_pipeline('pallas')!r}) on {vid}, "
        f"{LAUNCH_CLIENTS} client threads (a Client each) x {FABRIC_RPCS} rank_batch "
        f"RPCs of one question: q/s={run['qps']:.3f} p50_ms={run['p50_ms']:.4f} "
        f"p99_ms={run['p99_ms']:.4f}; every ranking == in process "
        f"(max_abs_err={err:.3e})")

    for n in FABRIC_WORKERS:
        # a worker serves one connection a thread: the router's two and as
        # many clients as there are threads
        fab = Fabric(n_workers=n, backend="pallas", train_steps=60, device="cuda",
                     spawn_timeout_s=LAUNCH_WAIT_S, worker_threads=LAUNCH_CLIENTS + 2,
                     extra_args=("--registry", reg_dir, "--model-version", vid))
        t0 = time.perf_counter()
        with fab:
            up_s = time.perf_counter() - t0
            for ep in fab.router._endpoints:
                check(ep.version() == (vid, "active"), "launch: a worker serves another "
                      "version")
                got = [r for i in range(0, len(queries), FABRIC_CHUNK)
                       for r in ep.client.rank_batch(queries[i:i + FABRIC_CHUNK])]
                _same_rankings(got, want, f"fabric worker {ep.slot} of {n}")
            run = _clients(LAUNCH_CLIENTS, load(lambda c: fab.router.rank_batch),
                           f"fabric x{n}")
            stats = fab.stats()
            # the same load with no router: a Client a thread, the threads
            # spread over the workers
            direct = [SV.Client(fab.workers[c % n].address) for c in range(LAUNCH_CLIENTS)]
            try:
                run_d = _clients(LAUNCH_CLIENTS, load(lambda c: direct[c].rank_batch),
                                 f"fabric x{n} direct")
            finally:
                for cl in direct:
                    cl.close()
            per_worker = {i: m.get("engine_rank_queries{model_version=" + vid + "}", 0.0)
                          for i, m in fab.worker_metrics().items()}
        err = max(held(run, f"fabric x{n}"), held(run_d, f"fabric x{n} direct"))
        check(stats["alive_workers"] == n and stats["respawns"] == 0,
              f"launch: fabric x{n}: {stats}")
        rows[n] = dict(run, up_s=up_s, direct=run_d)
        log(f"launch: Fabric(n_workers={n}, backend pallas, --registry, --model-version "
            f"{vid}, --device cuda, --train-steps 60): up in {up_s:.3f} s (spawn to the "
            f"last FABRIC_READY: torch import, CUDA context, kernel load, training); "
            f"every worker's rankings of the world's {len(queries)} questions == the "
            f"in-process pallas plan on {vid}; router under {LAUNCH_CLIENTS} client "
            f"threads x {FABRIC_RPCS} rank_batch RPCs of one question: "
            f"q/s={run['qps']:.3f} p50_ms={run['p50_ms']:.4f} p99_ms={run['p99_ms']:.4f} "
            f"(hedged {int(stats['router_hedged'])}, hedge wins "
            f"{int(stats['router_hedge_wins'])}); queries a worker {per_worker}; "
            f"without the router, a Client a thread spread over the workers: "
            f"q/s={run_d['qps']:.3f} p50_ms={run_d['p50_ms']:.4f} "
            f"p99_ms={run_d['p99_ms']:.4f}; every reply == in process "
            f"(max_abs_err={err:.3e})")
    hi, lo = rows[FABRIC_WORKERS[-1]], rows[FABRIC_WORKERS[0]]
    log(f"launch: fabric x{FABRIC_WORKERS[-1]} against x{FABRIC_WORKERS[0]}: q/s "
        f"{hi['qps'] / lo['qps']:.3f}x through the router, "
        f"{hi['direct']['qps'] / lo['direct']['qps']:.3f}x without it; against one "
        f"in-process ThreadPoolServer: {hi['qps'] / rows['server']['qps']:.3f}x through "
        f"the router, {hi['direct']['qps'] / rows['server']['qps']:.3f}x without it")
    return rows


def phase_launch(torch, cfg, world, service: dict) -> dict:
    """The serving launcher's stack on the card: training, ReplicaPool,
    rollout, the CLI as users start it, and the fabric of worker processes."""
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="launch_", dir=str(ROOT / "build")))
    try:
        trained = _launch_train(torch, cfg, world, tmp)
        pool = _launch_pool(torch, cfg, world, trained["params"], service)
        rollout = _launch_rollout(torch, cfg, world, trained)
        cli = _launch_cli()
        fabric = _launch_fabric(trained, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": pool["pallas"]["launches"] + rollout["launches"],
            "pool": pool, "rollout": rollout, "cli": cli, "fabric": fabric,
            "step_ms": trained["step_ms"], "world_s": trained["world_s"]}


# ------------------------------------------------------------- attn-kernel --

def _attn_agrees(torch, got, want, dtype: str, what: str) -> float:
    """Holds ``got`` against ``want`` at the dtype's absolute tolerance and
    at its tolerance on the error's norm over ``want``'s; returns the max
    absolute error."""
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.float())).item()
    ok = (math.isfinite(err) and err <= ATTN_TOLERANCE[dtype]
          and math.isfinite(rel) and rel <= ATTN_REL_TOLERANCE[dtype])
    log(f"attn-kernel: {what} {dtype}: max_abs_err={err:.3e} tol={ATTN_TOLERANCE[dtype]} "
        f"rel_norm_err={rel:.3e} tol={ATTN_REL_TOLERANCE[dtype]} {'ok' if ok else 'FAIL'}")
    check(ok, f"attention: {what} {dtype} disagree: max_abs_err {err}, rel_norm_err {rel}")
    return err


def phase_attn_kernel(torch, cfg) -> dict:
    """The attention kernel against its plain version on the card at
    qwen3-0.6b's widths, then its times, the plain version's, SDPA's as a
    yardstick, and the bound.

    Inputs are standard normal (randn), so the softmax stays spread over
    the keys, not one-hot, and the outputs are averages of many rows of v
    that a wrong weight or a wrong KV head would move. Every check holds
    the max absolute error and the error's norm relative to the output's.
    The timed shapes are checked too: against the plain version at
    (8, 2048); at (1, 32768), where its scores would not fit, on the first
    and last ATTN_SLICE_ROWS query rows against all keys; and SDPA against
    the kernel at each.
    """
    from repro_torch.kernels import flash_attention as FA

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def inputs(b, s, dtype):
        dt = getattr(torch, dtype)
        return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dt)
                     for n in (h, hkv, hkv))

    routes = {}
    for dtype in ("float32", "bfloat16"):
        info = routes[dtype] = FA.route_info(getattr(torch, dtype))
        log(f"attn-kernel: {dtype} route: stage {info['stage']} ({info['design']}), "
            f"{info['registers']} registers and {info['local_bytes']} local (spill) bytes a "
            f"thread, shared memory {info['static_smem']} B static + {info['dynamic_smem']} B "
            f"dynamic a block, {info['threads']} threads a block, {info['blocks_per_sm']} "
            f"blocks resident on an SM")

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checks = [(b, s, dtype) for b, s in ATTN_SHAPES for dtype in ("float32", "bfloat16")]
    checks += [(2, s, "bfloat16") for s in ATTN_DIAGONAL_S]
    for b, s, dtype in checks:
        q, k, v = inputs(b, s, dtype)
        got = FA.flash_attention(q, k, v)
        want = FA.flash_attention_plain(q, k, v)
        err = _attn_agrees(torch, got, want, dtype,
                           f"kernel vs plain B={b} S={s} H={h} Hkv={hkv} d={d}")
        max_err[dtype] = max(max_err[dtype], err)
        del q, k, v, got, want
    torch.cuda.empty_cache()

    timings = {}
    for b, s, dtype in ATTN_TIMED:
        timings[(b, s, dtype)] = t = _time_attention(torch, *inputs(b, s, dtype), dtype)
        max_err[dtype] = max(max_err[dtype], t["max_err"])
        torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings, "routes": routes}


def _kernel_vs_plain(torch, q, k, v, got, dtype: str, what: str) -> float:
    """Holds the kernel's output ``got`` against the plain version on the
    same inputs; past PLAIN_MAX_S, where the plain scores would not fit, on
    the first and last ATTN_SLICE_ROWS query rows, each against all keys.
    Returns the max absolute error."""
    from repro_torch.kernels import flash_attention as FA

    b, s, h, d = q.shape
    shape = f"{what}kernel vs plain B={b} S={s} H={h} Hkv={k.shape[2]} d={d}"
    if s <= PLAIN_MAX_S:
        return _attn_agrees(torch, got, FA.flash_attention_plain(q, k, v), dtype, shape)
    n = ATTN_SLICE_ROWS
    return max(_attn_agrees(torch, got[:, :n], FA.flash_attention_plain(q[:, :n], k, v),
                            dtype, f"{shape} query rows 0..{n - 1}"),
               _attn_agrees(torch, got[:, s - n:], FA.flash_attention_plain(
                   q[:, s - n:], k, v, q_start=s - n), dtype,
                   f"{shape} query rows {s - n}..{s - 1}"))


def _time_attention(torch, q, k, v, dtype: str) -> dict:
    """The attention kernel at one timed shape: held against its plain
    version (past PLAIN_MAX_S on its first and last ATTN_SLICE_ROWS query
    rows) and SDPA against the kernel; then the kernel's, the plain
    version's and SDPA's times, the kernel's back to back, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis

    b, s, h, d = q.shape
    hkv = k.shape[2]
    shape = f"B={b} S={s} H={h} Hkv={hkv}"
    # the yardstick's (B, H, S, d) layouts are made once, outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    fns = {"kernel": lambda: FA.flash_attention(q, k, v), "library": library}
    if s <= PLAIN_MAX_S:
        fns["plain"] = lambda: FA.flash_attention_plain(q, k, v)
    got = FA.flash_attention(q, k, v)
    err = _kernel_vs_plain(torch, q, k, v, got, dtype, "")
    lib_err = _attn_agrees(torch, library().transpose(1, 2), got, dtype,
                           f"SDPA vs kernel {shape}")
    del got
    iters = 20 if s <= PLAIN_MAX_S else 2
    t = _time_alternating(torch, fns, iters=iters)
    dev_ms = _queued_ms(torch, fns["kernel"], iters)
    bd = analysis.bound(*analysis.attention_work(b, s, h, hkv, d, dtype), dtype)
    plain = f"{t['plain']:.5f}" if "plain" in t else "not run (scores too large)"
    log(f"attn-kernel: {shape} {dtype} kernel_ms={t['kernel']:.5f} "
        f"kernel_device_ms={dev_ms:.5f} "
        f"plain_ms={plain} library_ms={t['library']:.5f} (SDPA causal GQA, "
        f"max_abs_err vs kernel {lib_err:.3e}) "
        + _bound_text(bd, t["kernel"], f"attn-kernel: {shape} {dtype}", dev_ms)
        + f" achieved_tflops={bd.ops / t['kernel'] / 1e9:.3f}")
    return dict(t, bound_ms=bd.ms, bound_by=bd.by, device_ms=dev_ms, max_err=err)


# ---------------------------------------------------------------- lm-check --

def phase_lm_check(torch, cfg, seed: int) -> None:
    """The LM path against itself on the card in float32 (TF32 off): (a)
    prefill with the kernel ("flash") against plain torch ("chunked"), and
    (b) decode at position S after a prefill of S tokens against forward
    over S+1 tokens."""
    import dataclasses

    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tfm

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tfm.init_lm(cfg32, torch.Generator("cuda").manual_seed(seed), "cuda")
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, CHECK_B, CHECK_S + 1, seed=seed))["tokens"]).cuda()
    prompt = toks[:, :CHECK_S]

    # (a) the two attentions differ only in the order of float32 sums (the
    # kernel's online softmax against materialised scores), about 1e-6 per
    # layer; 28 layers carry that into logits of std about 0.6, so the
    # repo's score rtol 1e-4 with atol 1e-4 (not 1e-5) bounds it
    flash_l, flash_c = tfm.prefill(params, prompt, cfg32)
    chunk_l, chunk_c = tfm.prefill(params, prompt,
                                   dataclasses.replace(cfg32, attn_impl="chunked"))
    errs = {"logits": (flash_l - chunk_l).abs().max().item()}
    ok = torch.allclose(flash_l, chunk_l, rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        errs[key] = (flash_c[key] - chunk_c[key]).abs().max().item()
        ok = ok and torch.allclose(flash_c[key], chunk_c[key], rtol=1e-4, atol=1e-4)
    log(f"lm-check: float32 prefill B={CHECK_B} S={CHECK_S} flash (kernel) vs chunked "
        f"(plain torch): max_abs_err logits={errs['logits']:.3e} cache k={errs['k']:.3e} "
        f"v={errs['v']:.3e} (rtol=1e-4 atol=1e-4; logits std "
        f"{flash_l.float().std().item():.4f}) {'ok' if ok else 'FAIL'}")
    check(ok, f"flash and chunked prefills disagree in float32: {errs}")
    del chunk_l, chunk_c

    # (b) tests/test_arch_smoke.py::test_lm_prefill_decode_consistency's check
    full, _ = tfm.forward(params, toks, cfg32)
    cache = tfm.init_cache(cfg32, CHECK_B, CHECK_S + 8)
    for key in ("k", "v"):
        cache[key][:, :, :CHECK_S] = flash_c[key]
    pos = torch.full((CHECK_B,), CHECK_S, dtype=torch.int32, device="cuda")
    lg, _ = tfm.decode_step(params, cache, toks[:, CHECK_S], pos, cfg32)
    err = (lg - full[:, -1]).abs().max().item()
    ok = torch.allclose(lg, full[:, -1], rtol=2e-2, atol=2e-2)
    err_p = (flash_l - full[:, -2]).abs().max().item()
    ok = ok and torch.allclose(flash_l, full[:, -2], rtol=2e-2, atol=2e-2)
    log(f"lm-check: float32 decode at position {CHECK_S} vs forward over {CHECK_S + 1} "
        f"tokens: max_abs_err={err:.3e}; prefill's last logits vs forward: "
        f"{err_p:.3e} (rtol=atol=2e-2) {'ok' if ok else 'FAIL'}")
    check(ok, f"decode after prefill disagrees with forward: {err}, {err_p}")
    del params, flash_l, flash_c, full, cache, lg
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- lm --

def phase_lm(torch, cfg, seed: int, name: str = "lm", long_len: int = LM_LONG,
             int8_rows: int = 0) -> dict:
    """An LM's serving path at full width in bfloat16 (qwen3-0.6b as "lm",
    deepseek-moe-16b as "lm-moe", moonshot-v1-16b-a3b as "lm-moonshot",
    granite-3-2b as "lm-granite", deepseek-coder-33b as "lm-coder"):
    prefill of 8 x 2048 tokens (each call's cache freed before the next), the cache copied into a 2048+32 cache, 32
    greedy decode steps, then a prefill of 1 x ``long_len``. The attention
    kernel's launch count is set to 0 just before and read just after, and
    must be one a layer per prefill; decode launches it never. The 8 x 2048
    prefill is then counted once more and read against its bound, an MoE
    model's with its dropped slots counted. A model past KV_QUANT_PARAMS
    parameters then decodes on the int8 KV cache at ``int8_rows`` rows
    (``_int8_decode``)."""
    import contextlib
    import dataclasses

    from repro_torch.configs import LM_SHAPES
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()              # what earlier phases still hold
    t0 = time.perf_counter()
    params = tfm.init_lm(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    sync()
    setup_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, LM_BATCH, LM_SEQ, seed=seed))["tokens"]).cuda()
    long_toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, 1, long_len, seed=seed + 1))["tokens"]).cuda()
    ffn = (f"d_ff={cfg.d_ff}" if cfg.moe is None else
           f"moe={cfg.moe.n_routed}x{cfg.moe.d_expert} top-{cfg.moe.top_k} "
           f"shared={cfg.moe.n_shared} capacity_factor={cfg.moe.capacity_factor} "
           f"group={cfg.moe.group_size}")
    log(f"{name}: cfg={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} {ffn} "
        f"vocab={cfg.vocab_size} {cfg.dtype} params={n_params} ({n_bytes / 1e9:.3f} GB); "
        f"init_lm {setup_s:.3f} s, its peak allocated {init_peak / 1e9:.3f} GB "
        f"({held / 1e9:.3f} GB held before it, so {(init_peak - held) / 1e9:.3f} GB its own)")
    tfm.prefill(params, toks[:, :128], cfg)           # warm-up: handles, first launches
    sync()

    # ---- the main path, counted ----
    FA.reset_launches()
    n_full = 0
    prefill_s = []
    for _ in range(LM_PREFILLS):
        logits = pcache = None                        # the last call's cache, freed first
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits, pcache = tfm.prefill(params, toks, cfg)
        sync()
        prefill_s.append(time.perf_counter() - t)
        n_full += 1
    peak8 = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite (B, V)")
    cache = tfm.init_cache(cfg, LM_BATCH, LM_SEQ + LM_DECODE)
    for key in ("k", "v"):
        cache[key][:, :, :LM_SEQ] = pcache[key]
    del pcache
    tok = logits.argmax(-1)
    pos = torch.full((LM_BATCH,), LM_SEQ, dtype=torch.int32, device="cuda")
    step_s, generated = [], [tok]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LM_DECODE):
        t = time.perf_counter()
        logits, cache = tfm.decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1)
        sync()
        step_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        generated.append(tok)
        pos = pos + 1
    peak_decode = torch.cuda.max_memory_allocated()
    decode_launches = FA.launches - cfg.n_layers * n_full
    long_s = []
    for _ in range(LM_LONG_PREFILLS):
        long_logits = long_cache = None               # the last call's cache, freed first
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        long_logits, long_cache = tfm.prefill(params, long_toks, cfg)
        sync()
        long_s.append(time.perf_counter() - t)
        n_full += 1
    peak_long = torch.cuda.max_memory_allocated()
    launches = FA.launches
    # ---- end of the counted run ----

    check(tuple(long_logits.shape) == (1, cfg.vocab_padded)
          and bool(torch.isfinite(long_logits).all()), "long prefill logits not finite")
    check(tuple(long_cache["k"].shape) == (cfg.n_layers, 1, long_len, cfg.n_kv_heads,
                                           cfg.d_head), "long prefill's cache shape")
    gen_toks = torch.stack(generated, 1)
    check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
          "a greedy token outside the vocabulary")
    kv_bytes = cfg.n_layers * cfg.n_kv_heads * cfg.d_head * 2 * 2
    med8, best_long = statistics.median(prefill_s), min(long_s)
    med_step = statistics.median(step_s)
    log(f"{name}: prefill B={LM_BATCH} S={LM_SEQ}: "
        f"{','.join(f'{x * 1e3:.3f}' for x in prefill_s)} "
        f"ms, median {med8 * 1e3:.3f} ms, {LM_BATCH * LM_SEQ / med8:.1f} tokens/s; "
        f"KV cache {LM_BATCH * LM_SEQ * kv_bytes / 1e9:.3f} GB ({kv_bytes} B a token); "
        f"peak allocated {peak8 / 1e9:.3f} GB")
    log(f"{name}: decode B={LM_BATCH} from position {LM_SEQ}, {LM_DECODE} greedy steps: "
        f"median {med_step * 1e3:.3f} ms/step (min {min(step_s) * 1e3:.3f}, max "
        f"{max(step_s) * 1e3:.3f}), {LM_BATCH / med_step:.1f} tokens/s; first tokens of "
        f"row 0: {gen_toks[0, :8].tolist()}; peak allocated {peak_decode / 1e9:.3f} GB")
    cut = ("" if long_len == LM_LONG else
           f" (prefill_32k's {LM_LONG} cut to {long_len}: at {LM_LONG} its bf16 cache, "
           f"{LM_LONG * kv_bytes / 1e9:.3f} GB, and the prefill's working memory would not "
           f"fit beside {n_bytes / 1e9:.3f} GB of weights)")
    log(f"{name}: prefill B=1 S={long_len}{cut}: "
        f"{','.join(f'{x * 1e3:.3f}' for x in long_s)} ms, "
        f"best {best_long * 1e3:.3f} ms, {long_len / best_long:.1f} tokens/s; KV cache "
        f"{long_len * kv_bytes / 1e9:.3f} GB; peak allocated {peak_long / 1e9:.3f} GB")
    log(f"{name}: flash_attention launches={launches} over {n_full} prefill calls "
        f"(decode launched it {decode_launches} times)")
    check(launches > 0, "the LM path launched the attention kernel no time")
    check(launches == cfg.n_layers * n_full,
          f"expected {cfg.n_layers} attention launches per prefill, got {launches} "
          f"for {n_full} prefills")
    check(decode_launches == 0, f"decode launched the attention kernel {decode_launches} times")
    del long_logits, long_cache
    torch.cuda.empty_cache()
    prefill_32k = {s_.name: s_ for s_ in LM_SHAPES}["prefill_32k"]
    with (moe.count_drops() if cfg.moe is not None else contextlib.nullcontext()) as drops:
        roof = _step_roofline(
            torch, cfg.name,
            dataclasses.replace(prefill_32k, seq_len=LM_SEQ, global_batch=LM_BATCH),
            lambda: tfm.prefill(params, toks, cfg), med8 * 1e3,
            f"{name}: prefill B={LM_BATCH} S={LM_SEQ}", cfg=cfg)
    out = {"launches": launches, "prefill_ms": med8 * 1e3, "decode_ms": med_step * 1e3,
           "long_ms": best_long * 1e3, "peak": peak8, "init_peak": init_peak,
           "share": roof["share"]}
    if drops is not None:
        out["drop_share"] = drops.share
        log(f"{name}: prefill B={LM_BATCH} S={LM_SEQ}: {drops.dropped} of {drops.routed} "
            f"(token, choice) pairs dropped over {cfg.n_layers} layers at capacity factor "
            f"{cfg.moe.capacity_factor} ({moe._capacity(cfg.moe, cfg.moe.group_size)} slots "
            f"an expert a group of {cfg.moe.group_size}): drop share {drops.share:.5f}")

    # busy shares, outside the counted run: one B=8 prefill, then 8 decode
    # steps redone on the last 8 positions with the tokens they had
    log(f"{name}: prefill B={LM_BATCH} S={LM_SEQ} "
        f"{_busy_share(torch, lambda: tfm.prefill(params, toks, cfg), 'flash_attention')}")
    pos0 = LM_SEQ + LM_DECODE - 8

    def eight_steps():
        for i in range(8):
            tfm.decode_step(params, cache, gen_toks[:, LM_DECODE - 8 + i],
                            torch.full((LM_BATCH,), pos0 + i, dtype=torch.int32,
                                       device="cuda"), cfg)

    log(f"{name}: 8 decode steps B={LM_BATCH} "
        f"{_busy_share(torch, eight_steps, 'flash_attention')}")
    if cfg.n_params() > KV_QUANT_PARAMS:
        check(0 < int8_rows <= LM_BATCH, f"{name}: int8 decode rows {int8_rows}")
        out["int8"] = _int8_decode(torch, cfg, params, cache, gen_toks, name, int8_rows)
    del params, cache
    torch.cuda.empty_cache()
    return out


def _int8_decode(torch, cfg, params, cache: dict, gen_toks, name: str, b: int) -> dict:
    """The int8 KV cache (``cfg.kv_quant``) at decode_32k's context, as the
    JAX launcher serves a model past KV_QUANT_PARAMS parameters: a cache of
    decode_32k's positions at ``b`` rows, whose peak must leave INT8_SPARE
    bytes of the card unreserved; positions [0, LM_SEQ) of ``cache``,
    the bf16 decode cache (the 8 x 2048 prefill's cache there), quantized
    layer by layer with the port's ``_kv_quantize`` into an int8 prefix,
    ``cache`` emptied, then the prefix written into the int8 cache's first
    LM_SEQ positions; LM_DECODE greedy steps from position LM_SEQ, the attention
    kernel's count set to 0 before and read after (decode never launches
    it). Each step's decode attention reads and masks every position, as
    JAX's does. ``gen_toks`` are the bf16 decode's tokens from the same
    prefill, its first column the prefill's own: the int8 decode starts
    from that column, and how many of its tokens equal the bf16 decode's is
    printed, not gated (random weights)."""
    import dataclasses

    from repro_torch.configs import LM_SHAPES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import hw

    sync = torch.cuda.synchronize
    decode_32k = {s_.name: s_ for s_ in LM_SHAPES}["decode_32k"]
    s = decode_32k.seq_len
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    # a row: int8 K and V and their float32 scales; bf16 K and V
    row_bytes = cfg.n_layers * s * cfg.n_kv_heads * (cfg.d_head + 4) * 2
    bf16_row = cfg.n_layers * s * cfg.n_kv_heads * cfg.d_head * 2 * 2
    log(f"{name}: int8 KV cache (kv_quant: the JAX launcher's above "
        f"{KV_QUANT_PARAMS:.0e} parameters, src/repro/launch/specs.py:179; "
        f"{cfg.n_params()} here) at decode_32k's {s} positions, B={b}: "
        f"{b * row_bytes / 1e9:.3f} GB ({row_bytes // s} B a token: int8 K/V and float32 "
        f"scales; bf16 would take {bf16_row / 1e9:.3f} GB a row)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    prefix = tfm.init_cache(cfgq, b, LM_SEQ)
    for li in range(cfg.n_layers):
        for key in ("k", "v"):
            prefix[key][li], prefix[f"{key}_scale"][li] = tfm._kv_quantize(
                cache[key][li, :b, :LM_SEQ])
    cache.clear()
    torch.cuda.empty_cache()
    qcache = tfm.init_cache(cfgq, b, s)
    for key, t_ in prefix.items():
        qcache[key][:, :, :LM_SEQ] = t_
    del prefix, t_
    sync()
    quant_s = time.perf_counter() - t

    # ---- the int8 decode, counted ----
    FA.reset_launches()
    tok = gen_toks[:b, 0]
    pos = torch.full((b,), LM_SEQ, dtype=torch.int32, device="cuda")
    step_s, generated = [], [tok]
    for _ in range(LM_DECODE):
        t = time.perf_counter()
        logits, qcache = tfm.decode_step(params, qcache, tok, pos, cfgq)
        tok = logits.argmax(-1)
        sync()
        step_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()), "int8 decode logits not finite")
        generated.append(tok)
        pos = pos + 1
    launches = FA.launches
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the counted run ----

    check(launches == 0, f"the int8 decode launched the attention kernel {launches} times")
    spare = torch.cuda.get_device_properties(0).total_memory - torch.cuda.max_memory_reserved()
    log(f"{name}: int8 decode B={b}: peak reserved {torch.cuda.max_memory_reserved() / 1e9:.3f} "
        f"GB, {spare / 1e9:.3f} GB of the card left")
    check(spare >= INT8_SPARE, f"{name}: B={b} leaves {spare / 1e9:.3f} GB of the card, "
                               f"under {INT8_SPARE / 1e9:.0f} GB")
    q_toks = torch.stack(generated, 1)
    check(bool(((q_toks >= 0) & (q_toks < cfg.vocab_size)).all()),
          "an int8 decode token outside the vocabulary")
    end = LM_SEQ + LM_DECODE
    check(all(bool((qcache[k][:, :, :end] > 0).all()) and not bool(qcache[k][:, :, end:].any())
              for k in ("k_scale", "v_scale")),
          f"the int8 cache's scales are not set on exactly its first {end} positions")
    same = int((q_toks[:, 1:] == gen_toks[:b, 1:]).sum())
    med = statistics.median(step_s)
    log(f"{name}: int8 decode B={b} from position {LM_SEQ} on a {s}-position cache (every "
        f"step reads and masks all {s}), {LM_DECODE} greedy steps: median {med * 1e3:.3f} "
        f"ms/step (min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}), "
        f"{b / med:.1f} tokens/s; the prefill's cache quantized in {quant_s:.3f} s; peak "
        f"allocated {peak / 1e9:.3f} GB; flash_attention launches {launches}; greedy "
        f"tokens equal to the bf16 decode's from the same prefill: {same} of "
        f"{b * LM_DECODE} (not gated: random weights, {cfg.n_layers} layers)")

    pos0 = end - 8

    def eight_steps():
        for i in range(8):
            tfm.decode_step(params, qcache, q_toks[:, LM_DECODE - 8 + i],
                            torch.full((b,), pos0 + i, dtype=torch.int32, device="cuda"), cfgq)

    log(f"{name}: 8 int8 decode steps B={b} "
        f"{_busy_share(torch, eight_steps, 'flash_attention')}")
    last = torch.full((b,), end - 1, dtype=torch.int32, device="cuda")
    roof = _step_roofline(
        torch, cfg.name, dataclasses.replace(decode_32k, global_batch=b),
        lambda: tfm.decode_step(params, qcache, q_toks[:, LM_DECODE - 1], last, cfgq),
        med * 1e3, f"{name}: int8 decode B={b}", cfg=cfg)
    # reference fault 10: model_bytes reads the cache at 2 B an element
    # under kv_quant too (parity keeps it); the int8 cache's own bytes beside
    weights = cfg.n_params() * 2.0
    own_ms = (weights + b * row_bytes) / hw.HBM_BW * 1e3
    own_share = own_ms / (med * 1e3)
    log(f"{name}: int8 decode B={b}: model_bytes reads the cache at 2 B an element "
        f"(reference fault 10): {weights / 1e9:.3f} GB of weights + {b * bf16_row / 1e9:.3f} "
        f"GB, bound {roof['bound_ms']:.5f} ms, share {roof['share']:.4f}; the int8 cache's "
        f"own bytes, {weights / 1e9:.3f} + {b * row_bytes / 1e9:.3f} GB at "
        f"{hw.HBM_BW / 1e12:.2f} TB/s: bound {own_ms:.5f} ms, share {own_share:.4f}")
    check(own_share <= SHARE_CAP,
          f"{name}: share {own_share:.4f} of the int8 cache's bound is past {SHARE_CAP}")
    del qcache
    torch.cuda.empty_cache()
    return {"rows": b, "decode_ms": med * 1e3, "peak": peak, "share": roof["share"],
            "own_share": own_share, "same_tokens": same}


# ------------------------------------------------------------ lm-moe-check --

def _moe_agrees(torch, got, want, dtype: str, what: str) -> float:
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MOE_TOL[dtype])
    log(f"lm-moe-check: {what} {dtype}: max_abs_err={err:.3e} "
        f"(rtol={MOE_TOL[dtype]['rtol']} atol={MOE_TOL[dtype]['atol']}; output max "
        f"{want.abs().max().item():.4f}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{what} {dtype}: max_abs_err {err}")
    return err


def phase_lm_moe_check(torch, cfg, seed: int) -> dict:
    """deepseek-moe-16b's path on the card at full width, cut to
    MOE_CHECK_LAYERS layers where a model runs: (a) the attention kernel at
    the model's H=16, Hkv=16 (G=1), d=128 against its plain version in both
    types, and at each long prefill of MOE_LM_RUNS (1 x its length) in
    bfloat16 past PLAIN_MAX_S on its first and last query rows, then timed
    at 8 x 2048 in bfloat16; (b)
    ``moe_apply`` against the dense mixture at capacity factor
    MOE_CHECK_CF, and ``route``'s ties
    (the lower expert index first, as on the CPU); (c) one group at the
    config's capacity factor: every dropped (token, choice) pair adds
    nothing, the drop share; (d) decode at position S after a prefill of S
    against forward over S+1 in float64 with plain attention at capacity
    factor MOE_CHECK_CF: no slot drops, so the one-token decode routes as
    the full pass does, and the two passes differ by float64 sums (the
    layers' float32 norms and scores aside, as in JAX) where a top-6 choice
    among 64 experts could flip on a near tie in a lower precision."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for matmul: the router's float32 product would round its inputs")
    h, hkv, d, spec = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.moe
    check(h == hkv, f"{cfg.name} is not multi-head: G={h // hkv}")
    for _, arch, _, _ in MOE_LM_RUNS:
        c = get_config(arch)
        check((c.n_heads, c.n_kv_heads, c.d_head) == (h, hkv, d),
              f"{arch}'s attention is not {cfg.name}'s: the check would miss its shapes")
    gen = torch.Generator("cuda").manual_seed(seed + 31)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # (a) the kernel at G=1, at every prefill shape of lm-moe and lm-moonshot
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checks = [(b, s, dtype) for b, s in MOE_ATTN_SHAPES for dtype in max_err]
    checks += [(1, s, "bfloat16") for s in sorted({run[2] for run in MOE_LM_RUNS})]
    for b, s, dtype in checks:
        q, k, v = (randn(b, s, n, d, dtype=getattr(torch, dtype)) for n in (h, hkv, hkv))
        err = _kernel_vs_plain(torch, q, k, v, FA.flash_attention(q, k, v), dtype, "G=1 ")
        max_err[dtype] = max(max_err[dtype], err)
        del q, k, v
    torch.cuda.empty_cache()
    timing = _time_attention(torch, *(randn(LM_BATCH, LM_SEQ, n, d, dtype=torch.bfloat16)
                                      for n in (h, hkv, hkv)), "bfloat16")
    torch.cuda.empty_cache()

    # (b) moe_apply == the dense mixture where no slot drops; ties
    cfg16 = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS, attn_impl="chunked",
                                moe=dataclasses.replace(spec, capacity_factor=MOE_CHECK_CF))
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        p = moe.moe_params(gen, cfg16, dt)
        x = randn(CHECK_B, CHECK_S, cfg.d_model, dtype=dt)
        with moe.count_drops() as drops:
            y, aux = moe.moe_apply(p, x, cfg16)
        check(drops.dropped == 0 and bool(torch.isfinite(aux)), "slots dropped at capacity 16")
        _moe_agrees(torch, y, moe.moe_apply_dense(p, x, cfg16.moe), dtype,
                    f"moe_apply vs the dense mixture B={CHECK_B} S={CHECK_S} capacity "
                    f"factor {MOE_CHECK_CF} (aux {aux.item():.6f})")
        del p, x, y
    # router columns repeating 16 times, small dyadic entries: exact logits
    base = torch.randint(-4, 5, (cfg.d_model, 4), generator=gen, device="cuda").float() / 8
    router = base[:, torch.arange(spec.n_routed, device="cuda") % 4]
    x = torch.randint(-2, 3, (1, 64, cfg.d_model), generator=gen, device="cuda").float()
    _, idx, _ = moe.route(router, x, spec)
    probs = torch.softmax(x @ router, dim=-1).gather(-1, idx)
    tied = probs[..., 1:] == probs[..., :-1]
    ok = (torch.equal(idx.cpu(), moe.route(router.cpu(), x.cpu(), spec)[1])
          and bool((idx[..., 1:] > idx[..., :-1])[tied].all()))
    log(f"lm-moe-check: route ties: {int(tied.sum())} tied neighbours among the top "
        f"{spec.top_k} of 64 tokens, each at the higher expert index; card == CPU "
        f"{'ok' if ok else 'FAIL'}")
    check(ok and bool(tied.any()), "route breaks ties unlike jax.lax.top_k")

    # (c) dropped slots add nothing, at the config's capacity factor
    p = moe.moe_params(gen, cfg, torch.float64)
    del p["shared"]
    x = (randn(1, spec.group_size, cfg.d_model)
         + MOE_SKEW * randn(cfg.d_model)).to(torch.float64)
    with moe.count_drops() as drops:
        y, _ = moe.moe_apply(p, x, cfg)
    c = moe._capacity(spec, spec.group_size)
    _, idx, _ = moe.route(p["router"], x, spec)
    _, keep = moe.slots(idx, spec.n_routed, c)
    none_kept = ~keep[0].any(-1)
    check(drops.dropped == int((~keep).sum()) > 0, "no slot dropped: (c) would hold nothing")
    _moe_agrees(torch, y, moe.moe_apply_dense(p, x, spec, keep[0]), "float64",
                f"moe_apply vs the dense mixture over kept pairs, one group of "
                f"{spec.group_size} at capacity factor {spec.capacity_factor} ({c} slots; "
                f"{drops.dropped} of {drops.routed} pairs dropped, share {drops.share:.5f}; "
                f"{int(none_kept.sum())} tokens with none kept)")
    check(bool((y[0][none_kept] == 0).all()), "a token with every choice dropped got output")
    del p, x, y
    torch.cuda.empty_cache()

    # (d) decode == forward, float64, plain attention
    cfg64 = dataclasses.replace(cfg16, dtype="float64")
    params = tfm.init_lm(cfg64, gen, "cuda")
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, CHECK_B, CHECK_S + 1, seed=seed))["tokens"]).cuda()
    full, _ = tfm.forward(params, toks, cfg64)
    lg_prefill, pcache = tfm.prefill(params, toks[:, :CHECK_S], cfg64)
    cache = tfm.init_cache(cfg64, CHECK_B, CHECK_S + 8)
    for key in ("k", "v"):
        cache[key][:, :, :CHECK_S] = pcache[key]
    pos = torch.full((CHECK_B,), CHECK_S, dtype=torch.int32, device="cuda")
    lg, _ = tfm.decode_step(params, cache, toks[:, CHECK_S], pos, cfg64)
    err = (lg - full[:, -1]).abs().max().item()
    err_p = (lg_prefill - full[:, -2]).abs().max().item()
    ok = (torch.allclose(lg, full[:, -1], rtol=2e-2, atol=2e-2)
          and torch.allclose(lg_prefill, full[:, -2], rtol=2e-2, atol=2e-2))
    log(f"lm-moe-check: float64 {MOE_CHECK_LAYERS} layers, capacity factor {MOE_CHECK_CF}: "
        f"decode at position {CHECK_S} vs forward over {CHECK_S + 1} tokens: "
        f"max_abs_err={err:.3e}; prefill's last logits vs forward: {err_p:.3e} "
        f"(rtol=atol=2e-2) {'ok' if ok else 'FAIL'}")
    check(ok, f"MoE decode after prefill disagrees with forward: {err}, {err_p}")
    del cache, lg

    # (e) the int8 cache's quantizer on the card == on the CPU, bit for bit:
    # rows across scales, an all-zero row (the 1e-8 floor), rows at absmax
    # 127 (scale 1) holding every half from -126.5 to 0.5 (half to even)
    x = randn(2, LM_SEQ, hkv, d) * torch.exp(3 * randn(2, LM_SEQ, hkv, 1))
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = torch.arange(-127, 1, device="cuda", dtype=torch.float32) + 0.5
    x[0, 1, 0, 0] = 127.0
    x[0, 1, 1] = -x[0, 1, 0]
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        q, scale = tfm._kv_quantize(xd)
        q_cpu, scale_cpu = tfm._kv_quantize(xd.cpu())
        ok = torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)
        for out in (torch.bfloat16, torch.float32):
            ok = ok and torch.equal(tfm._kv_dequantize(q, scale, out).cpu(),
                                    tfm._kv_dequantize(q_cpu, scale_cpu, out))
        ok = (ok and q[0, 1, 0, 1:4].tolist() == [-126, -124, -124]
              and scale[0, 1, 0].item() == 1.0 and not bool(q[0, 0, 0].any()))
        log(f"lm-moe-check: int8 KV quantize/dequantize {str(dtype)[6:]} on "
            f"{x.numel() // d} rows of {d}: int8 values, scales and dequantized values card "
            f"== CPU bit for bit, halves to even {'ok' if ok else 'FAIL'}")
        check(ok, f"the int8 KV quantizer differs between the card and the CPU ({dtype})")
    del x, xd, q, scale

    # (f) (d)'s model, the prefill's cache quantized to int8, decode under
    # kv_quant == forward: tests/test_arch_smoke.py's int8 bound
    cfgq = dataclasses.replace(cfg64, kv_quant=True)
    qcache = tfm.init_cache(cfgq, CHECK_B, CHECK_S + 8)
    for key in ("k", "v"):
        rows, scale = tfm._kv_quantize(pcache[key])
        qcache[key][:, :, :CHECK_S] = rows
        qcache[f"{key}_scale"][:, :, :CHECK_S] = scale
    lg, _ = tfm.decode_step(params, qcache, toks[:, CHECK_S], pos, cfgq)
    err = (lg - full[:, -1]).abs().max().item()
    top1 = torch.equal(lg.argmax(-1), full[:, -1].argmax(-1))
    ok = top1 and torch.allclose(lg, full[:, -1], rtol=0.0, atol=INT8_ATOL)
    log(f"lm-moe-check: float64 {MOE_CHECK_LAYERS} layers, int8 KV cache: decode at position "
        f"{CHECK_S} vs forward over {CHECK_S + 1} tokens: max_abs_err={err:.3e} (atol "
        f"{INT8_ATOL}), top-1 identical {top1} {'ok' if ok else 'FAIL'}")
    check(ok, f"int8-cache decode disagrees with forward: {err}, top-1 {top1}")
    del params, full, lg_prefill, pcache, qcache, lg
    torch.cuda.empty_cache()
    return {"max_err": max_err, "timing": timing}


# ---------------------------------------------------------- attn-d64, granite --

def _refusal(fn):
    """The message of the ValueError ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def phase_attn_d64(torch, cfg) -> dict:
    """The bfloat16 attention kernel at head width 64 against its plain
    version on the card: at granite-3-2b's H=32, Hkv=8 for ATTN_SHAPES and
    ATTN_DIAGONAL_S, at each G of D64_GROUPS for S in D64_GROUP_S, and at
    lm-granite's prefills (8 x 2048; 1 x 32768 on the first and last
    ATTN_SLICE_ROWS query rows), which are then timed beside the plain
    version (8 x 2048), SDPA and the bound. Randn inputs, each check at
    ATTN_TOLERANCE and ATTN_REL_TOLERANCE for bfloat16. The float32
    kernels are not compiled at d=64: a float32 call, with or without the
    gradient, must raise ValueError with no launch either way (the bfloat16
    backward at d=64 is held in attn-bwd)."""
    from repro_torch.kernels import flash_attention as FA

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    check(d == 64, f"{cfg.name}'s head width is {d}, not 64")
    gen = torch.Generator(device="cuda").manual_seed(6464)

    def inputs(b, s, heads, kv_heads, dtype=torch.bfloat16, grad=False):
        return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda")
                     .to(dtype).requires_grad_(grad) for n in (heads, kv_heads, kv_heads))

    info = FA.route_info(torch.bfloat16, d)
    log(f"attn-d64: bfloat16 route at d={d}: stage {info['stage']} ({info['design']}), "
        f"{info['registers']} registers and {info['local_bytes']} local (spill) bytes a "
        f"thread, shared memory {info['static_smem']} B static + {info['dynamic_smem']} B "
        f"dynamic a block, {info['threads']} threads a block, {info['blocks_per_sm']} blocks "
        f"resident on an SM")
    check(info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0,
          f"the d=64 kernel spills or fits no block: {info}")

    max_err = 0.0
    checks = [(b, s, h, hkv) for b, s in ATTN_SHAPES]
    checks += [(2, s, h, hkv) for s in ATTN_DIAGONAL_S]
    checks += [(2, s, h, h // g) for g in D64_GROUPS for s in D64_GROUP_S]
    for b, s, heads, kv_heads in checks:
        q, k, v = inputs(b, s, heads, kv_heads)
        err = _kernel_vs_plain(torch, q, k, v, FA.flash_attention(q, k, v), "bfloat16",
                               f"d=64 G={heads // kv_heads} ")
        max_err = max(max_err, err)
        del q, k, v
    torch.cuda.empty_cache()

    before = (FA.launches, FA.bwd_launches)
    f32 = _refusal(lambda: FA.flash_attention(*inputs(1, 64, h, hkv, torch.float32)))
    with torch.inference_mode(False), torch.enable_grad():
        grad = _refusal(lambda: FA.flash_attention(
            *inputs(1, 64, h, hkv, torch.float32, grad=True)))
    torch.cuda.synchronize()
    launched = (FA.launches - before[0], FA.bwd_launches - before[1])
    ok = f32 is not None and grad is not None and launched == (0, 0)
    log(f"attn-d64: float32 at d=64 refused ({f32}); float32 with the gradient at d=64 "
        f"refused ({grad}); launches (forward, backward) {launched} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "a float32 call at d=64 was not refused before a launch")

    timings = {}
    for b, s in ((LM_BATCH, LM_SEQ), (1, LM_LONG)):
        timings[(b, s)] = t = _time_attention(torch, *inputs(b, s, h, hkv), "bfloat16")
        max_err = max(max_err, t["max_err"])
        torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings, "route": info}


def _fenced_launch(torch, q, k, v, with_lse: bool = False):
    """The forward kernel written into the middle of a buffer of NaN that
    holds one position's rows more on each side; fails unless every
    element of the output was written (randn inputs give no NaN) and
    nothing around it. Returns the output (and, ``with_lse``, its lse)."""
    from repro_torch.kernels import flash_attention as FA

    b, s, h, d = q.shape
    buf = torch.full((b * s + 2, h, d), float("nan"), dtype=q.dtype, device=q.device)
    res = FA._launch(q, k, v, with_lse=with_lse, out=buf[1:-1].view(b, s, h, d))
    got = res[0] if with_lse else res
    torch.cuda.synchronize()
    unwritten = int(got.isnan().sum())
    fenced = bool(buf[0].isnan().all()) and bool(buf[-1].isnan().all())
    check(unwritten == 0 and fenced,
          f"attention B={b} S={s} H={h} Hkv={k.shape[2]}: {unwritten} output elements "
          f"unwritten, the rows around it untouched: {fenced}")
    return res


def _fenced_bwd(torch, q, k, v, out, lse, dout):
    """The backward kernels written into the middle of three buffers of NaN,
    each holding one position's rows more on each side than dq, dk or dv;
    fails unless every element of the three was written (randn inputs give
    no NaN) and nothing around them. Returns ``(dq, dk, dv)``."""
    from repro_torch.kernels import flash_attention as FA

    b, s = q.shape[:2]
    bufs = [torch.full((b * s + 2, *x.shape[2:]), float("nan"), dtype=x.dtype,
                       device=x.device) for x in (q, k, v)]
    got = FA._launch_bwd(q, k, v, out, lse, dout,
                         grads=tuple(buf[1:-1].view(x.shape) for buf, x in zip(bufs, (q, k, v))))
    torch.cuda.synchronize()
    for name, buf, g in zip(("dq", "dk", "dv"), bufs, got):
        unwritten = int(g.isnan().sum())
        fenced = bool(buf[0].isnan().all()) and bool(buf[-1].isnan().all())
        check(unwritten == 0 and fenced,
              f"attention backward B={b} S={s} H={q.shape[2]} Hkv={k.shape[2]}: {unwritten} "
              f"{name} elements unwritten, the rows around it untouched: {fenced}")
    return got


def phase_attn_g7(torch, cfg, long_len: int) -> dict:
    """The attention kernel at group sizes that are not powers of two,
    against its plain version on the card in both routes at d=128: at each
    G of G7_GROUPS over ``cfg``'s (deepseek-coder-33b's) Hkv for B=2 and S
    in G7_S, at its own H=56, Hkv=8 at 8 x 2048 in both types and at 1 x
    ``long_len`` in bfloat16 on the first and last ATTN_SLICE_ROWS query
    rows; every launch fenced (``_fenced_launch``). The float32 route's
    flag for non-finite Q must not read the next group's heads in its idle
    rows; a call past KERNEL_ROWS query heads a KV head raises with no
    launch, with or without the gradient. Times at 8 x 2048 in both types
    beside the plain version, SDPA and the bound."""
    from repro_torch.kernels import flash_attention as FA

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    check(h % hkv == 0 and (h // hkv) & (h // hkv - 1) != 0,
          f"{cfg.name}'s group size {h // hkv} is a power of two")
    gen = torch.Generator(device="cuda").manual_seed(7777)

    def inputs(b, s, heads, dtype):
        return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda")
                     .to(getattr(torch, dtype)) for n in (heads, hkv, hkv))

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checks = [(2, s, g * hkv, dtype) for g in G7_GROUPS for s in G7_S
              for dtype in ("float32", "bfloat16")]
    checks += [(LM_BATCH, LM_SEQ, h, dtype) for dtype in ("float32", "bfloat16")]
    checks += [(1, long_len, h, "bfloat16")]
    for b, s, heads, dtype in checks:
        q, k, v = inputs(b, s, heads, dtype)
        err = _kernel_vs_plain(torch, q, k, v, _fenced_launch(torch, q, k, v), dtype,
                               f"G={heads // hkv} fenced ")
        max_err[dtype] = max(max_err[dtype], err)
        del q, k, v
        torch.cuda.empty_cache()

    # an inf in group 1's first head, which group 0's idle rows load
    q, k, v = inputs(1, 130, h, "float32")
    q[0, 20, h // hkv, 3] = float("inf")
    got, want = FA.flash_attention(q, k, v), FA.flash_attention_plain(q, k, v)
    own = h // hkv
    ok = (torch.equal(got.isnan(), want.isnan()) and bool(want.isnan().any())
          and bool(torch.isfinite(got[:, :, :own]).all()))
    finite = ~want.isnan()
    err = (got[finite] - want[finite]).abs().max().item()
    ok = ok and err <= ATTN_TOLERANCE["float32"]
    log(f"attn-g7: float32 inf in head {own} (group 1's first, group 0's idle row): group 0 "
        f"finite, NaN where plain's are, max_abs_err elsewhere {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "the float32 kernel's idle rows changed another group's result")

    # past KERNEL_ROWS query heads a KV head: refused before any launch, with
    # or without the gradient (the gradient at G=7 runs in attn-bwd)
    before = (FA.launches, FA.bwd_launches)
    past = FA.KERNEL_ROWS + 1

    def past_rows(grad):
        return tuple(torch.randn((1, 64, n, d), generator=gen, device="cuda")
                     .to(torch.bfloat16).requires_grad_(grad) for n in (past, 1, 1))

    plain = _refusal(lambda: FA.flash_attention(*past_rows(False)))
    with torch.inference_mode(False), torch.enable_grad():
        grad = _refusal(lambda: FA.flash_attention(*past_rows(True)))
    torch.cuda.synchronize()
    launched = (FA.launches - before[0], FA.bwd_launches - before[1])
    ok = plain is not None and grad is not None and launched == (0, 0)
    log(f"attn-g7: bfloat16 at G={past} refused ({plain}), with the gradient too ({grad}); "
        f"launches (forward, backward) {launched} {'ok' if ok else 'FAIL'}")
    check(ok, f"a call at G={past} was not refused before a launch")

    timings = {}
    for dtype in ("bfloat16", "float32"):
        timings[dtype] = t = _time_attention(torch, *inputs(LM_BATCH, LM_SEQ, h, dtype), dtype)
        max_err[dtype] = max(max_err[dtype], t["max_err"])
        torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings}


def _granite_agrees(torch, got, want, what: str, top1: bool = False,
                    phase: str = "lm-granite-check") -> float:
    """Holds bfloat16 ``got`` against ``want`` at GRANITE_TOL (and, for
    logits, the same top-1 token in every row: ``got``'s is a token on
    which ``want`` peaks, so where bfloat16 rounds two of ``want``'s
    logits to the same top value either is its top-1); returns the max
    absolute error. Prints each row's top-1 lead over its runner-up in
    ``want``, the margin a rounding would have to cross to flip the token."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    ok = math.isfinite(err) and torch.allclose(g, w, **GRANITE_TOL)
    text = ""
    if top1:
        lead = w.topk(2, dim=-1).values
        picked = w.gather(-1, g.argmax(-1, keepdim=True))[:, 0]
        same = torch.equal(picked, lead[:, 0])
        ok = ok and same
        text = (f", top-1 identical {same} (leads "
                f"{', '.join(f'{x:.4f}' for x in (lead[:, 0] - lead[:, 1]).tolist())})")
    log(f"{phase}: {what}: max_abs_err={err:.3e} (rtol {GRANITE_TOL['rtol']} atol "
        f"{GRANITE_TOL['atol']}){text} {'ok' if ok else 'FAIL'}")
    check(ok, f"{phase}: {what} disagree: max_abs_err {err}")
    return err


def phase_lm_bf16_check(torch, cfg, seed: int, phase: str) -> None:
    """A bfloat16 LM's serving path at full width cut to
    GRANITE_CHECK_LAYERS layers on the card (weights from ``seed``):
    granite-3-2b as lm-granite-check (the d=64 kernel, tied embeddings),
    deepseek-coder-33b as lm-coder-check (the kernel at G=7, an untied
    lm_head). (a) prefill through the kernel ("flash", one launch a layer)
    against plain torch ("chunked") at (CHECK_B, CHECK_S): last logits and
    the cache; (b) decode at position S after that prefill against forward
    over S+1 tokens, and the prefill's last logits against forward's; at
    GRANITE_TOL with top-1 tokens equal. Padded vocabulary columns (granite:
    49,155 to 49,280) read -1e30, and a tied head leaves no lm_head. (c)
    For a model past KV_QUANT_PARAMS parameters, which serves on the int8
    cache: decode at position S on the prefill's cache quantized to int8
    against (b)'s bfloat16 decode at INT8_ATOL."""
    import dataclasses

    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm

    cfg2 = dataclasses.replace(cfg, n_layers=GRANITE_CHECK_LAYERS)
    check(cfg2.dtype == "bfloat16", f"{cfg.name} is not bfloat16")
    params = tfm.init_lm(cfg2, torch.Generator("cuda").manual_seed(seed), "cuda")
    check(("lm_head" in params) != cfg2.tie_embeddings,
          f"{cfg.name}: tie_embeddings {cfg2.tie_embeddings} but lm_head "
          f"{'built' if 'lm_head' in params else 'missing'}")
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, CHECK_B, CHECK_S + 1, seed=seed))["tokens"]).cuda()
    prompt = toks[:, :CHECK_S]

    before = FA.launches
    flash_l, flash_c = tfm.prefill(params, prompt, cfg2)
    torch.cuda.synchronize()
    launched = FA.launches - before
    check(launched == GRANITE_CHECK_LAYERS,
          f"the flash prefill launched the kernel {launched} times, not one a layer")
    chunk_l, chunk_c = tfm.prefill(params, prompt,
                                   dataclasses.replace(cfg2, attn_impl="chunked"))
    check(FA.launches - before == launched, "the chunked prefill launched the kernel")
    pad = flash_l[:, cfg.vocab_size:].float()
    check(tuple(flash_l.shape) == (CHECK_B, cfg.vocab_padded) and bool((pad <= -1e29).all()),
          f"padded vocabulary columns {cfg.vocab_size}..{cfg.vocab_padded} not masked")
    kernel = f"d={cfg.d_head} G={cfg.n_heads // cfg.n_kv_heads}"
    _granite_agrees(torch, flash_l, chunk_l, f"bfloat16 prefill B={CHECK_B} S={CHECK_S} "
                    f"flash (the {kernel} kernel, {launched} launches) vs chunked: last "
                    f"logits", top1=True, phase=phase)
    for key in ("k", "v"):
        _granite_agrees(torch, flash_c[key], chunk_c[key], f"prefill cache {key}", phase=phase)
    del chunk_l, chunk_c

    full, _ = tfm.forward(params, toks, cfg2)
    cache = tfm.init_cache(cfg2, CHECK_B, CHECK_S + 8)
    for key in ("k", "v"):
        cache[key][:, :, :CHECK_S] = flash_c[key]
    pos = torch.full((CHECK_B,), CHECK_S, dtype=torch.int32, device="cuda")
    lg, _ = tfm.decode_step(params, cache, toks[:, CHECK_S], pos, cfg2)
    _granite_agrees(torch, lg, full[:, -1], f"bfloat16 decode at position {CHECK_S} vs "
                    f"forward over {CHECK_S + 1} tokens", top1=True, phase=phase)
    _granite_agrees(torch, flash_l, full[:, -2], "prefill's last logits vs forward's",
                    top1=True, phase=phase)
    if cfg.n_params() > KV_QUANT_PARAMS:
        cfgq = dataclasses.replace(cfg2, kv_quant=True)
        qcache = tfm.init_cache(cfgq, CHECK_B, CHECK_S + 8)
        for key in ("k", "v"):
            qcache[key][:, :, :CHECK_S], qcache[f"{key}_scale"][:, :, :CHECK_S] = (
                tfm._kv_quantize(flash_c[key]))
        lq, _ = tfm.decode_step(params, qcache, toks[:, CHECK_S], pos, cfgq)
        err = (lq.float() - lg.float()).abs().max().item()
        same = int((lq.argmax(-1) == lg.argmax(-1)).sum())
        ok = math.isfinite(err) and err <= INT8_ATOL
        log(f"{phase}: int8 decode at position {CHECK_S} (the prefill's cache quantized) vs "
            f"the bfloat16 decode: max_abs_err={err:.3e} (atol {INT8_ATOL}); top-1 equal in "
            f"{same} of {CHECK_B} rows (not gated) {'ok' if ok else 'FAIL'}")
        check(ok, f"{phase}: int8 decode disagrees with the bfloat16 decode: {err}")
        del qcache, lq
    del params, flash_l, flash_c, full, cache, lg
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- attn-bwd --

def _grad_agrees(torch, got, want, dtype: str, what: str, elementwise: bool = True) -> float:
    """Holds a gradient against its reference: max abs error within
    atol + rtol |want| (unless not ``elementwise``: then only reported) and,
    where the gradient is above rounding, the error's norm over the
    reference's; returns the max absolute error."""
    rtol, atol, rel_tol = BWD_TOLERANCE[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    ok = (not elementwise or bool((diff <= atol + rtol * w.abs()).all())) and math.isfinite(err)
    w_norm = torch.linalg.vector_norm(w).item()
    rel = torch.linalg.vector_norm(g - w).item() / w_norm if w_norm else 0.0
    gated = w_norm > RMS_FLOOR * w.numel() ** 0.5
    ok = ok and (not gated or rel <= rel_tol)
    log(f"attn-bwd: {what} {dtype}: max_abs_err={err:.3e} (atol {atol} + rtol {rtol}"
        f"{'' if elementwise else ': reported, not gated'}) "
        f"rel_norm_err={rel:.3e} tol={rel_tol}{'' if gated else ' (below rounding: not gated)'} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"attention backward: {what} {dtype} disagree: max_abs_err {err}, "
              f"rel_norm_err {rel}")
    return err


def _bwd_inputs(torch, gen, b, s, h, hkv, d, dtype):
    """q, k, v, dout of the backward's checks: randn on the card."""
    dt = getattr(torch, dtype)
    return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dt)
                 for n in (h, hkv, hkv, h))


def _bwd_timed(torch, b, s, h, hkv, d, gen, max_err, lse_err, key) -> dict:
    """The bfloat16 backward at (b, s, h, hkv, d) as attn-bwd times it: the
    forward's lse and out against plain, the kernel and SDPA's backward
    against plain, two calls bit-equal, then the kernel, the plain backward
    and SDPA's backward in turns, the forward with and without lse, device
    ms back to back and by kernel, the bound. Errors go into
    ``max_err[key]`` and ``lse_err[key]``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis

    dtype = "bfloat16"
    tag = f"B={b} S={s}" + ("" if (h, hkv, d) == (16, 8, 128) else f" H={h} Hkv={hkv} d={d}")
    q, k, v, dout = _bwd_inputs(torch, gen, b, s, h, hkv, d, dtype)
    out, lse = FA._launch(q, k, v, with_lse=True)
    # the forward with its lse at the training path's shape, before the
    # backward comparison takes out and lse as given
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
    e = (lse - want_lse).abs().max().item()
    check(e <= LSE_TOLERANCE[dtype], f"attn-bwd: forward lse {tag} {dtype}: "
                                     f"max_abs_err {e} > {LSE_TOLERANCE[dtype]}")
    lse_err[key] = max(lse_err[key], e)
    log(f"attn-bwd: forward lse vs plain lse {tag} {dtype}: max_abs_err {e:.3e} "
        f"(tol {LSE_TOLERANCE[dtype]}) ok")
    _attn_agrees(torch, out, want_out, dtype, f"forward with lse vs plain {tag}")
    del want_out, want_lse
    # the yardstick: SDPA's backward in (B, H, S, d) layouts made once
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dout_t, retain_graph=True)

    fns = {"kernel": lambda: FA._launch_bwd(q, k, v, out, lse, dout),
           "plain": lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout),
           "library": library}
    got = fns["kernel"]()
    err = max(_grad_agrees(torch, g, w, dtype, f"{name} kernel vs plain {tag}")
              for name, g, w in zip(("dq", "dk", "dv"), got,
                                    fns["plain"]()))
    max_err[key] = max(max_err[key], err)
    lib = library()
    # the yardstick computes the same gradient: at d=128 and G=2 element by
    # element and by its norm; at d=64 (G=4) and G=7 by its norm, since SDPA
    # and the kernel each sum bf16-rounded P over G heads into dv, in other
    # orders, and differ by a bf16 step (0.0625) at some elements below 2
    # (the kernel holds the float32-P plain version element by element above)
    lib_err = max(_grad_agrees(torch, a.transpose(1, 2), g, dtype,
                               f"{name} SDPA backward vs kernel {tag}",
                               elementwise=d == 128 and h // hkv <= 2)
                  for name, a, g in zip(("dq", "dk", "dv"), lib, got))
    again = fns["kernel"]()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"attn-bwd: two backward calls at {tag} differ")
    log(f"attn-bwd: {tag} {dtype}: two backward calls bit-equal (dq, dk, dv)")
    del got, lib, again
    t = _time_alternating(torch, fns, iters=3, rounds=3)
    # the forward with and without its lse, in turns, as attn-kernel
    # times it, with the plain forward with lse and SDPA's forward with
    # grad on (which keeps its logsumexp for the backward)
    t.update(_time_alternating(torch, {
        "fwd_lse": lambda: FA._launch(q, k, v, with_lse=True),
        "fwd": lambda: FA._launch(q, k, v),
        "fwd_lse_plain": lambda: FA.flash_attention_fwd_plain(q, k, v),
        "fwd_lse_library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}, iters=20))
    fwd_dev_ms = _queued_ms(torch, lambda: FA._launch(q, k, v, with_lse=True), 20)
    fwd_bd = analysis.bound(*analysis.attention_work(b, s, h, hkv, d, dtype, lse=True), dtype)
    dev_ms = _queued_ms(torch, fns["kernel"], 10)
    lib_dev_ms = _queued_ms(torch, library, 10)
    # the three kernels of a call: the statistics pass, dk/dv, dq
    split = _profiled_split_ms(
        torch, fns["kernel"], ("flash_bwd_stats", "flash_bwd_dkdv", "flash_bwd_dq"), 3)
    bd = analysis.bound(*analysis.attention_bwd_work(b, s, h, hkv, d, dtype), dtype)
    timing = dict(t, bound_ms=bd.ms, bound_by=bd.by, device_ms=dev_ms,
                  library_device_ms=lib_dev_ms, device_split=split,
                  fwd_lse_device_ms=fwd_dev_ms, fwd_lse_bound_ms=fwd_bd.ms)
    log(f"attn-bwd: {tag} {dtype} kernel_ms={t['kernel']:.5f} "
        f"kernel_device_ms={dev_ms:.5f} "
        f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
        f"library_device_ms={lib_dev_ms:.5f} (SDPA causal GQA "
        f"backward, max_abs_err vs kernel {lib_err:.3e}) "
        + _bound_text(bd, t["kernel"], f"attn-bwd: {tag} {dtype}", dev_ms)
        + f" achieved_tflops={bd.ops / t['kernel'] / 1e9:.3f}")
    log(f"attn-bwd: {tag} {dtype} device ms by kernel (profiler): " + (
        ", ".join(f"{name[len('flash_bwd_'):]} {ms:.5f}" for name, ms in split.items())
        if split else f"not measured (each of {PROFILE_ATTEMPTS} sessions lost "
                      f"kernel records)"))
    log(f"attn-bwd: forward {tag} {dtype} with lse {t['fwd_lse']:.5f} ms (device "
        f"{fwd_dev_ms:.5f}), without {t['fwd']:.5f} ms (ratio {t['fwd_lse'] / t['fwd']:.4f}); "
        f"plain forward with lse {t['fwd_lse_plain']:.5f} ms; SDPA forward with grad on "
        f"{t['fwd_lse_library']:.5f} ms; "
        + _bound_text(fwd_bd, t["fwd_lse"], f"attn-bwd: forward with lse {tag}", fwd_dev_ms))
    del q, k, v, dout, out, lse, qt, kt, vt, lib_out, dout_t, fns
    torch.cuda.empty_cache()
    return timing


def _bwd_timed_f32(torch, b, s, h, hkv, d, gen, max_err, key) -> dict:
    """The float32 backward (3xTF32) at (b, s, h, hkv, d) as attn-bwd times
    it: the kernel against plain, two calls bit-equal, then the kernel, the
    plain backward and SDPA's float32 backward in turns, device ms back to
    back and by kernel, the bound. The error goes into ``max_err[key]``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis

    dtype = "float32"
    tag = f"B={b} S={s}" + ("" if (h, hkv) == (16, 8) else f" H={h} Hkv={hkv}")
    q, k, v, dout = _bwd_inputs(torch, gen, b, s, h, hkv, d, dtype)
    out, lse = FA._launch(q, k, v, with_lse=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()

    def library_f32():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dout_t, retain_graph=True)

    fns = {"kernel": lambda: FA._launch_bwd(q, k, v, out, lse, dout),
           "plain": lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout),
           "library": library_f32}
    got = fns["kernel"]()
    max_err[key] = max(max_err[key], max(
        _grad_agrees(torch, g, w, dtype, f"{name} kernel vs plain {tag}")
        for name, g, w in zip(("dq", "dk", "dv"), got, fns["plain"]())))
    again = fns["kernel"]()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"attn-bwd: two float32 backward calls at {tag} differ")
    log(f"attn-bwd: {tag} {dtype}: two backward calls bit-equal (dq, dk, dv)")
    del got, again
    t = _time_alternating(torch, fns, iters=2, rounds=3)
    dev_ms = _queued_ms(torch, fns["kernel"], 5)
    lib_dev_ms = _queued_ms(torch, library_f32, 5)
    split = _profiled_split_ms(
        torch, fns["kernel"], ("flash_bwd_stats", "flash_bwd_dkdv", "flash_bwd_dq"), 3)
    bd = analysis.bound(*analysis.attention_bwd_work(b, s, h, hkv, d, dtype), dtype)
    timing = dict(t, bound_ms=bd.ms, bound_by=bd.by, device_ms=dev_ms,
                  library_device_ms=lib_dev_ms, device_split=split)
    log(f"attn-bwd: {tag} {dtype} kernel_ms={t['kernel']:.5f} "
        f"kernel_device_ms={dev_ms:.5f} plain_ms={t['plain']:.5f} "
        f"library_ms={t['library']:.5f} library_device_ms={lib_dev_ms:.5f} (SDPA causal "
        f"GQA backward, float32) "
        + _bound_text(bd, t["kernel"], f"attn-bwd: {tag} {dtype}", dev_ms)
        + f" achieved_tflops={bd.ops / t['kernel'] / 1e9:.3f}")
    log(f"attn-bwd: {tag} {dtype} device ms by kernel (profiler): " + (
        ", ".join(f"{name[len('flash_bwd_'):]} {ms:.5f}" for name, ms in split.items())
        if split else f"not measured (each of {PROFILE_ATTEMPTS} sessions lost "
                      f"kernel records)"))
    del q, k, v, dout, out, lse, qt, kt, vt, lib_out, dout_t, fns
    torch.cuda.empty_cache()
    return timing



def phase_attn_bwd(torch, cfg, granite_cfg, coder_cfg, moe_cfg) -> dict:
    """The attention's backward kernel against the plain backward on the
    card at qwen3-0.6b's widths, and the forward's lse against the plain
    lse; then the backward's times, the plain backward's, SDPA's backward
    as a yardstick, the bound, two calls bit-equal (no atomics), and the
    forward with its lse against without, against the plain forward with
    its lse and against SDPA's forward where grad is on (it keeps its
    logsumexp); the float32 route timed the same way at BWD_TIMED_F32.
    Then granite-3-2b's width (``granite_cfg``: d=64, H=32, Hkv=8) in
    bfloat16: its routes, the kernel and the forward's lse against plain at
    BWD_SHAPES and BWD_DIAGONAL_S, and at BWD_TIMED timed as d=128 is.
    Then group sizes that are not powers of two (``coder_cfg``:
    deepseek-coder-33b, G=7): both routes at each G of G7_GROUPS over its
    Hkv for B=2 and S in G7_S against the plain backward, with the
    forward's lse against plain's, every forward and backward launch
    writing into NaN-filled buffers one position wider on each side
    (``_fenced_launch``, ``_fenced_bwd``); inf and NaN in q and dout of
    head G (group 1's first) leaving group 0's dq and KV head 0's dk and dv
    equal to plain's; coder's H=56, Hkv=8 at TRAIN_B x TRAIN_S timed in
    bfloat16 as d=128 is and in float32 at BWD_TIMED_F32. deepseek-moe-16b's
    heads (``moe_cfg``: H=16, Hkv=16, d=128, G=1) in both routes: the
    kernel and the forward's lse against plain at BWD_SHAPES and
    BWD_DIAGONAL_S, and at TRAIN_B x TRAIN_S timed in bfloat16 as d=128 is
    and in float32. Inputs are randn,
    the incoming gradient too. Last, the port's counter on the card: a
    forward and backward through FlashAttention, whose backward runs on
    autograd's own thread, reads the two work formulas."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis, counts

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(8765)

    def inputs(b, s, dtype):
        return _bwd_inputs(torch, gen, b, s, h, hkv, d, dtype)

    # the routes: float32 and bfloat16 at qwen3-0.6b's d=128 (H=16, Hkv=8),
    # bfloat16 at granite-3-2b's d=64 (H=32, Hkv=8: G=4), each keyed by
    # dtype (and width) in routes, max_err and lse_err
    gh, ghkv, gd = granite_cfg.n_heads, granite_cfg.n_kv_heads, granite_cfg.d_head
    mh, mhkv, md = moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.d_head
    check(mh == mhkv and md == d, f"{moe_cfg.name}'s attention is not G=1 at d={d}")
    cases = (("float32", "float32", h, hkv, d), ("bfloat16", "bfloat16", h, hkv, d),
             ("bfloat16_d64", "bfloat16", gh, ghkv, gd),
             ("float32_g1", "float32", mh, mhkv, md), ("bfloat16_g1", "bfloat16", mh, mhkv, md))
    routes = {}
    for key, dtype, _, _, dd in cases:
        if key.endswith("_g1"):   # G=1 runs d=128's instances
            continue
        routes[key] = FA.bwd_route_info(getattr(torch, dtype), dd)
        for name, info in routes[key].items():
            log(f"attn-bwd: {dtype} d={dd} {name} kernel ({info['design']}): "
                f"{info['registers']} registers and {info['local_bytes']} local (spill) bytes "
                f"a thread, shared memory {info['static_smem']} B static + "
                f"{info['dynamic_smem']} B dynamic a block, {info['threads']} threads a block, "
                f"{info['blocks_per_sm']} blocks resident on an SM")
            check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1,
                  f"attn-bwd: {dtype} d={dd} {name} kernel spills or does not fit an SM")

    max_err = {key: 0.0 for key, *_ in cases}
    lse_err = {key: 0.0 for key, *_ in cases}
    for b, s in BWD_SHAPES + tuple((1, s_) for s_ in BWD_DIAGONAL_S):
        for key, dtype, hh, kk, dd in cases:
            q, k, v, dout = _bwd_inputs(torch, gen, b, s, hh, kk, dd, dtype)
            tag = f"B={b} S={s} H={hh} Hkv={kk} d={dd}"
            out, lse = FA._launch(q, k, v, with_lse=True)
            want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
            e = (lse - want_lse).abs().max().item()
            check(e <= LSE_TOLERANCE[dtype], f"attn-bwd: forward lse {tag} {dtype}: "
                                             f"max_abs_err {e} > {LSE_TOLERANCE[dtype]}")
            lse_err[key] = max(lse_err[key], e)
            _attn_agrees(torch, out, want_out, dtype, f"forward with lse vs plain {tag}")
            got = FA._launch_bwd(q, k, v, out, lse, dout)
            want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                max_err[key] = max(max_err[key], _grad_agrees(
                    torch, g, w, dtype, f"{name} kernel vs plain {tag}"))
            del q, k, v, dout, out, lse, got, want
    log("attn-bwd: forward lse vs plain lse: max_abs_err " + ", ".join(
        f"{key} {lse_err[key]:.3e} (tol {LSE_TOLERANCE[dtype]})" for key, dtype, *_ in cases)
        + " ok")
    torch.cuda.empty_cache()

    # bfloat16 at the training path's shapes, both widths
    timings = {}
    for b, s in BWD_TIMED:
        timings[(b, s)] = _bwd_timed(torch, b, s, h, hkv, d, gen, max_err, lse_err, "bfloat16")
    for b, s in BWD_TIMED:
        timings[(b, s, gd)] = _bwd_timed(torch, b, s, gh, ghkv, gd, gen, max_err, lse_err,
                                         "bfloat16_d64")

    # the float32 route (3xTF32), timed as above
    timings[(*BWD_TIMED_F32, "float32")] = _bwd_timed_f32(torch, *BWD_TIMED_F32, h, hkv, d,
                                                          gen, max_err, "float32")
    # G=1 (deepseek-moe-16b's MHA), the training step's shape in both types
    timings[(TRAIN_B, TRAIN_S, "g1")] = _bwd_timed(torch, TRAIN_B, TRAIN_S, mh, mhkv, md, gen,
                                                   max_err, lse_err, "bfloat16_g1")
    timings[(*BWD_TIMED_F32, "float32_g1")] = _bwd_timed_f32(
        torch, *BWD_TIMED_F32, mh, mhkv, md, gen, max_err, "float32_g1")

    # group sizes that are not powers of two (deepseek-coder-33b's G=7), G
    # padded to the next power of two: both routes against the plain
    # backward, every launch fenced; a NaN or inf in the next group's first
    # head; coder's shape timed
    ch, chkv = coder_cfg.n_heads, coder_cfg.n_kv_heads
    check(coder_cfg.d_head == d and (ch // chkv) & (ch // chkv - 1) != 0 and ch % chkv == 0,
          f"{coder_cfg.name}'s group size {ch // chkv} is a power of two")
    for key in ("float32_g7", "bfloat16_g7"):
        max_err[key] = lse_err[key] = 0.0
    for g in G7_GROUPS:
        for s_ in G7_S:
            for dtype in ("float32", "bfloat16"):
                key = f"{dtype}_g7"
                q, k, v, dout = _bwd_inputs(torch, gen, 2, s_, g * chkv, chkv, d, dtype)
                tag = f"B=2 S={s_} H={g * chkv} Hkv={chkv} G={g} fenced"
                out, lse = _fenced_launch(torch, q, k, v, with_lse=True)
                want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
                e = (lse - want_lse).abs().max().item()
                check(e <= LSE_TOLERANCE[dtype], f"attn-bwd: forward lse {tag} {dtype}: "
                                                 f"max_abs_err {e} > {LSE_TOLERANCE[dtype]}")
                lse_err[key] = max(lse_err[key], e)
                _attn_agrees(torch, out, want_out, dtype, f"forward with lse vs plain {tag}")
                got = _fenced_bwd(torch, q, k, v, out, lse, dout)
                want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
                for name, gg, w in zip(("dq", "dk", "dv"), got, want):
                    max_err[key] = max(max_err[key], _grad_agrees(
                        torch, gg, w, dtype, f"{name} kernel vs plain {tag}"))
                del q, k, v, dout, out, lse, got, want
    log(f"attn-bwd: G={'/'.join(map(str, G7_GROUPS))} over Hkv={chkv}, S in {G7_S}: forward "
        f"lse max_abs_err float32 {lse_err['float32_g7']:.3e}, bfloat16 "
        f"{lse_err['bfloat16_g7']:.3e}; every backward launch wrote all of dq, dk, dv and "
        f"nothing around them ok")
    torch.cuda.empty_cache()
    # isolation: inf and NaN in q and dout of head G, group 1's first, which
    # a box of Gp heads from group 0's first would hold
    own = ch // chkv
    for dtype in ("float32", "bfloat16"):
        q, k, v, dout = _bwd_inputs(torch, gen, 2, 130, ch, chkv, d, dtype)
        q[:, 5::9, own, :4] = float("inf")
        q[:, 3::11, own, 9] = float("nan")
        dout[:, 2::7, own, :] = float("nan")
        dout[:, 4::13, own, 3] = float("-inf")
        out, lse = FA._launch(q, k, v, with_lse=True)
        got = FA._launch_bwd(q, k, v, out, lse, dout)   # NaN where group 1's are: no fence
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        parts = (("dq of group 0", got[0][:, :, :own], want[0][:, :, :own]),
                 ("dk of KV head 0", got[1][:, :, 0], want[1][:, :, 0]),
                 ("dv of KV head 0", got[2][:, :, 0], want[2][:, :, 0]))
        for what, gg, w in parts:
            check(bool(torch.isfinite(w).all()), f"attn-bwd: plain {what} not finite")
            _grad_agrees(torch, gg, w, dtype, f"{what}, inf/NaN in head {own} (group 1's "
                                              f"first), H={ch} Hkv={chkv} S=130")
        ok = not bool(torch.isfinite(got[1][:, :, 1]).all())
        log(f"attn-bwd: {dtype} group 1's own dk holds its NaN: {'ok' if ok else 'FAIL'}")
        check(ok, "attn-bwd: group 1's dk is finite beside a NaN in its own dout")
        del q, k, v, dout, out, lse, got, want
    torch.cuda.empty_cache()
    b, s = TRAIN_B, TRAIN_S
    timings[(b, s, "g7")] = _bwd_timed(torch, b, s, ch, chkv, d, gen, max_err, lse_err,
                                       "bfloat16_g7")
    timings[(*BWD_TIMED_F32, "float32_g7")] = _bwd_timed_f32(
        torch, *BWD_TIMED_F32, ch, chkv, d, gen, max_err, "float32_g7")

    b, s = BWD_TIMED[0]
    q, k, v, dout = inputs(b, s, "bfloat16")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (FA.launches, FA.bwd_launches)
    counted = counts.count(lambda: torch.autograd.backward(FA.flash_attention(q, k, v), dout))
    launched = (FA.launches - before[0], FA.bwd_launches - before[1])
    want = (analysis.attention_work(b, s, h, hkv, d, "bfloat16", lse=True)[0]
            + analysis.attention_bwd_work(b, s, h, hkv, d, "bfloat16")[0])
    ok = counted.flops == want and launched == (1, 1)
    log(f"attn-bwd: under the counter, one forward + backward B={b} S={s} bfloat16 "
        f"(launches {launched}) reads {counted.flops:.6e} FLOPs, the formulas' "
        f"{want:.6e} {'ok' if ok else 'FAIL'}")
    check(ok, f"attn-bwd: the counter read {counted.flops} FLOPs for a forward and backward "
              f"on the card, not the formulas' {want} (launches {launched})")
    del q, k, v, dout
    torch.cuda.empty_cache()
    return {"max_err": max_err, "lse_err": lse_err, "timings": timings, "routes": routes}


# ---------------------------------------------------------------- lm-train --

def phase_lm_train(torch, cfg, seed: int) -> dict:
    """qwen3-0.6b's training path on the card. (a) float32 at full width cut
    to TRAIN_CHECK_LAYERS layers: the loss and the gradient of every leaf
    through the kernels ("flash": the forward kernel with its lse, the
    backward kernel) against plain torch autograd ("chunked"), every leaf's
    gradient nonzero. (b) The full-width bfloat16 model from the training
    launcher's ``build(..., full=True)`` trained TRAIN_STEPS steps of
    TRAIN_B x TRAIN_S through ``Trainer`` + ``adamw`` (the launcher's
    schedule); both attention counters are set to 0 just before and read
    just after, and must show 56 forward and 28 backward launches a step
    (remat runs each layer's forward again in the backward);
    the loss falls; step ms, tokens/s, peak memory, busy share and the
    attention's share of a step's device time. (c) ``python -m
    repro_torch.launch.train`` at full width on the card, exiting 0."""
    import dataclasses
    import functools

    from repro_torch.configs import LM_SHAPES
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tfm
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    # (a) float32 gradients: kernels against plain autograd
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=TRAIN_CHECK_LAYERS)
    params = tfm.init_lm(cfg32, torch.Generator("cuda").manual_seed(seed), "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(lm_data.token_batches(
        cfg.vocab_size, TRAIN_CHECK_B, TRAIN_CHECK_S, seed=seed)).items()}
    results = {}
    for impl in ("flash", "chunked"):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        before = (FA.launches, FA.bwd_launches)
        loss, _ = tfm.loss_fn(live, batch, dataclasses.replace(cfg32, attn_impl=impl))
        grads = torch.autograd.grad(loss, tree_leaves(live))
        results[impl] = (loss.item(), grads, (FA.launches - before[0],
                                              FA.bwd_launches - before[1]))
    # remat (cfg.remat): each layer's forward runs again in the backward
    check(results["flash"][2] == (2 * TRAIN_CHECK_LAYERS, TRAIN_CHECK_LAYERS)
          and results["chunked"][2] == (0, 0),
          f"lm-train: float32 check launched {results['flash'][2]} (flash), "
          f"{results['chunked'][2]} (chunked)")
    loss_rel = abs(results["flash"][0] - results["chunked"][0]) / abs(results["chunked"][0])
    worst, zero = 0.0, 0
    for g, w in zip(results["flash"][1], results["chunked"][1]):
        worst = max(worst, (torch.linalg.vector_norm(g - w)
                            / torch.linalg.vector_norm(w)).item())
        zero += int(not bool(g.abs().max() > 0))
    n_leaves = len(results["flash"][1])
    ok = loss_rel <= TRAIN_GRAD_REL and worst <= TRAIN_GRAD_REL and zero == 0
    log(f"lm-train: float32 {cfg.name} at full width cut to {TRAIN_CHECK_LAYERS} layers, "
        f"B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}: loss flash (kernels) {results['flash'][0]:.6f} "
        f"vs chunked (plain autograd) {results['chunked'][0]:.6f} (rel {loss_rel:.3e}); "
        f"{n_leaves} gradient leaves, worst error norm over gradient norm {worst:.3e} "
        f"(tol {TRAIN_GRAD_REL}), {zero} all-zero; launches fwd/bwd "
        f"{results['flash'][2]} {'ok' if ok else 'FAIL'}")
    check(ok, f"lm-train: float32 gradients through the kernels disagree with plain "
              f"autograd: loss rel {loss_rel}, worst leaf {worst}, {zero} zero leaves")
    del params, results, live, grads, loss
    torch.cuda.empty_cache()

    # (b) full width, bfloat16, through the launcher's build and Trainer
    t0 = time.perf_counter()
    tcfg, params, loss_fn, data = launch_train.build(cfg.name, True, TRAIN_B, TRAIN_S,
                                                     "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    tr = Trainer(loss_fn, adamw(warmup_cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)), params)
    del params
    torch.cuda.synchronize()
    log(f"lm-train: {tcfg.name} {tcfg.dtype} params={n_params:,} from "
        f"launch.train.build(full=True) on the card in {time.perf_counter() - t0:.3f} s; "
        f"B={TRAIN_B} S={TRAIN_S} ({TRAIN_B * TRAIN_S} tokens a step), Trainer + "
        f"adamw(warmup_cosine_schedule({TRAIN_LR}, 10, {TRAIN_STEPS}))")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ----
    FA.reset_launches()
    FA.reset_bwd_launches()
    t0 = time.perf_counter()
    tr.run(data, max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = FA.launches, FA.bwd_launches
    # ---- end of the counted run ----
    peak = torch.cuda.max_memory_allocated()
    losses = [hh["loss"] for hh in tr.history]
    step_ms = [hh["step_time_s"] * 1e3 for hh in tr.history]
    check(all(math.isfinite(x) for x in losses), "lm-train: a loss is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    med = statistics.median(step_ms[1:])
    log(f"lm-train: {TRAIN_STEPS} steps in {train_s:.3f} s; step_ms first={step_ms[0]:.3f} "
        f"median(2..{TRAIN_STEPS})={med:.3f} min={min(step_ms[1:]):.3f} "
        f"max={max(step_ms[1:]):.3f}; {TRAIN_B * TRAIN_S / med * 1e3:.1f} tokens/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB")
    log(f"lm-train: flash_attention launches={fwd}, flash_attention_bwd launches={bwd} "
        f"over {TRAIN_STEPS} steps ({cfg.n_layers} layers)")
    check(fwd > 0 and bwd > 0, "lm-train: the training path launched an attention kernel "
                               "no time")
    check(fwd == 2 * bwd == 2 * cfg.n_layers * TRAIN_STEPS,
          f"lm-train: expected {2 * cfg.n_layers} forward and {cfg.n_layers} backward "
          f"launches a step (remat), got {fwd} and {bwd} over {TRAIN_STEPS} steps")
    check(last < first, f"lm-train: the loss did not fall ({first:.4f} -> {last:.4f})")
    busy = _busy_share(torch, lambda: tr.run(data, max_steps=tr.step + 1, log_every=0),
                       "flash", top=8)
    log(f"lm-train: one step B={TRAIN_B} S={TRAIN_S} {busy}")
    train_4k = {s_.name: s_ for s_ in LM_SHAPES}["train_4k"]
    roof = _step_roofline(torch, cfg.name,
                          dataclasses.replace(train_4k, seq_len=TRAIN_S, global_batch=TRAIN_B),
                          lambda: tr.run(data, max_steps=tr.step + 1, log_every=0), med,
                          "lm-train")
    del tr, data
    torch.cuda.empty_cache()

    # (c) the launcher itself, at full width on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI],
                          env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"lm-train: python -m repro_torch.launch.train {' '.join(TRAIN_CLI)}: exit "
        f"{proc.returncode} in {cli_s:.3f} s: {' | '.join(lines[-3:])}")
    check(proc.returncode == 0 and lines and lines[-1].startswith("final:")
          and lines[0].startswith(f"arch={cfg.name} family=lm params={n_params:,}"),
          f"lm-train: the launcher failed: {proc.stderr[-2000:]}")
    return {"launches": fwd, "bwd_launches": bwd, "step_ms": med, "peak": peak,
            "loss": (first, last), "roofline": roof}


# ------------------------------------------- lm-granite-train, lm-coder-train --

def _train_clis(phase: str, n_params: int, clis) -> None:
    """``python -m repro_torch.launch.train`` with each command line of
    ``clis``, all started together on the card, each exiting 0 with the JAX
    launcher's ``arch=`` line first (with ``--full`` at the full model's
    ``n_params``) and a ``final:`` line last; a reduced LM (float32, d_head
    16: no attention kernel) also prints the launcher's ``attn=chunked``
    line second. The ``final:`` line holds ``moe_aux``, above 0 for an MoE
    config and 0 for a dense one."""
    from repro_torch.configs import get_config
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = [(cli, subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *cli],
                                    env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)) for cli in clis]
    outs = []
    try:
        for _, proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for _, proc in procs:
            proc.kill()
            proc.wait()
    for (cli, proc), (stdout, stderr) in zip(procs, outs):
        lines = stdout.strip().splitlines()
        cli_arch = cli[cli.index("--arch") + 1]
        first = f"arch={cli_arch} family=lm params=" + (f"{n_params:,}" if "--full" in cli
                                                        else "")
        ok = (proc.returncode == 0 and len(lines) >= 2 and lines[0].startswith(first)
              and lines[-1].startswith("final:"))
        if "--full" not in cli:
            ok = ok and lines[1] == "attn=chunked (no CUDA kernel for float32 d_head 16)"
        if ok:
            aux = ast.literal_eval(lines[-1][len("final:"):].strip()).get("moe_aux")
            ok = aux is not None and (aux > 0) == (get_config(cli_arch).moe is not None)
        log(f"{phase}: python -m repro_torch.launch.train {' '.join(cli)}: exit "
            f"{proc.returncode} ({time.perf_counter() - t0:.3f} s since the launches): "
            f"{' | '.join(lines[:2] + lines[-1:])} {'ok' if ok else 'FAIL'}")
        check(ok, f"{phase}: the launcher failed: {stderr[-2000:]}")


def _check_batch(torch, cfg, seed: int) -> dict:
    """The training checks' batch: TRAIN_CHECK_B x TRAIN_CHECK_S tokens of
    ``data/lm.py`` on the card."""
    from repro_torch.data import lm as lm_data
    return {k: torch.from_numpy(v).cuda() for k, v in next(lm_data.token_batches(
        cfg.vocab_size, TRAIN_CHECK_B, TRAIN_CHECK_S, seed=seed)).items()}


def _bf16_grad_check(torch, cfg, seed: int, phase: str) -> float:
    """phase_lm_bf16_train's (a) for a dense LM: the model at full width cut
    to GRANITE_CHECK_LAYERS layers, its bfloat16 loss and every gradient
    leaf through the kernels (remat) against float32 plain autograd
    ("chunked") from the same weights, every leaf nonzero, 2 forward and 1
    backward launches a layer, and remat off against on. Returns the worst
    leaf's error norm over its gradient's."""
    import dataclasses

    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm

    n_cut = GRANITE_CHECK_LAYERS
    cut = dataclasses.replace(cfg, n_layers=n_cut)
    params = tfm.init_lm(cut, torch.Generator("cuda").manual_seed(seed), "cuda")
    batch = _check_batch(torch, cfg, seed)

    def loss_and_grads(c, p):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        before = (FA.launches, FA.bwd_launches)
        loss, _ = tfm.loss_fn(live, batch, c)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.item(), grads, (FA.launches - before[0], FA.bwd_launches - before[1])

    flash = loss_and_grads(cut, params)
    flash_off = loss_and_grads(dataclasses.replace(cut, remat=False), params)
    ref = loss_and_grads(dataclasses.replace(cut, dtype="float32", attn_impl="chunked"),
                         tree_map(lambda t: t.float(), params))
    check(flash[2] == (2 * n_cut, n_cut) and flash_off[2] == (n_cut, n_cut)
          and ref[2] == (0, 0),
          f"{phase}: the check launched {flash[2]} (remat), {flash_off[2]} "
          f"(no remat), {ref[2]} (chunked)")
    loss_rel = abs(flash[0] - ref[0]) / abs(ref[0])
    worst, zero, remat_worst, remat_equal = 0.0, 0, 0.0, 0
    for g, g_off, w in zip(flash[1], flash_off[1], ref[1]):
        worst = max(worst, (torch.linalg.vector_norm(g.float() - w)
                            / torch.linalg.vector_norm(w)).item())
        zero += int(not bool(g.abs().max() > 0))
        remat_equal += int(torch.equal(g, g_off))
        remat_worst = max(remat_worst, (torch.linalg.vector_norm(g.float() - g_off.float())
                                        / torch.linalg.vector_norm(g_off.float())).item())
    n_leaves = len(flash[1])
    ok = (loss_rel <= GRANITE_LOSS_REL and worst <= GRANITE_TRAIN_REL and zero == 0
          and remat_worst <= GRANITE_REMAT_REL)
    log(f"{phase}: {cfg.name} at full width cut to {n_cut} layers, "
        f"B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}: loss bfloat16 flash (kernels, remat) "
        f"{flash[0]:.6f} vs float32 chunked (plain autograd) {ref[0]:.6f} (rel "
        f"{loss_rel:.3e}, tol {GRANITE_LOSS_REL}); {n_leaves} gradient leaves, worst error "
        f"norm over gradient norm {worst:.3e} (tol {GRANITE_TRAIN_REL}), {zero} all-zero; "
        f"launches fwd/bwd {flash[2]} with remat, {flash_off[2]} without; remat off vs on: "
        f"{remat_equal} of {n_leaves} leaves bit-equal, worst {remat_worst:.3e} (tol "
        f"{GRANITE_REMAT_REL}), loss {flash_off[0]:.6f} {'ok' if ok else 'FAIL'}")
    check(ok, f"{phase}: bfloat16 gradients through the kernels disagree: loss "
              f"rel {loss_rel}, worst leaf {worst}, {zero} zero leaves, remat {remat_worst}")
    del params, batch, flash, flash_off, ref
    torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def _routings():
    """Records each ``moe_apply`` call's routing while open: ``(idx, keep)``
    as integers, in call order (``models.moe.slots`` wrapped)."""
    from repro_torch.models import moe
    slots, seen = moe.slots, []

    def recorded(idx, n_routed, c):
        pos, keep = slots(idx, n_routed, c)
        seen.append((idx.clone(), keep.clone()))
        return pos, keep

    moe.slots = recorded
    try:
        yield seen
    finally:
        moe.slots = slots


def _moe_grad_check(torch, cfg, seed: int, phase: str) -> float:
    """phase_lm_bf16_train's (a) for an MoE LM (G=1), where a bfloat16 and a
    float32 model route some tokens to other experts: the model at full
    width cut to GRANITE_CHECK_LAYERS layers in float32, through the float32
    (3xTF32) kernels both ways ("flash", remat) against float32 plain
    autograd ("chunked") from the same weights. Every layer's (idx, keep)
    first, equal in both and equal to its own recompute under remat; then
    the loss and every gradient leaf within TRAIN_GRAD_REL, every leaf
    nonzero, 2 forward and 1 backward launches a layer; remat off against
    on: the loss and every leaf within GRANITE_REMAT_REL, the drop share
    equal. The bfloat16 model (the same weights) through the bfloat16
    kernels: its loss within MOE_BF16_LOSS_REL of the float32 one, every
    gradient finite, and the share of (token, choice) pairs routed to
    another expert than in float32 printed. Returns the worst float32
    leaf's error norm over its gradient's."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import moe, transformer as tfm

    n_cut = GRANITE_CHECK_LAYERS
    cut = dataclasses.replace(cfg, n_layers=n_cut)
    params = tfm.init_lm(cut, torch.Generator("cuda").manual_seed(seed), "cuda")
    params32 = tree_map(lambda t: t.float(), params)
    cut32 = dataclasses.replace(cut, dtype="float32")
    batch = _check_batch(torch, cfg, seed)

    def run(c, p):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        before = (FA.launches, FA.bwd_launches)
        with _routings() as routes, moe.count_drops() as n:
            loss, metrics = tfm.loss_fn(live, batch, c)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        torch.cuda.synchronize()
        return {"loss": loss.item(), "aux": metrics["moe_aux"].item(), "grads": grads,
                "routes": routes, "dropped": n.dropped, "routed": n.routed,
                "launches": (FA.launches - before[0], FA.bwd_launches - before[1])}

    flash = run(cut32, params32)
    flash_off = run(dataclasses.replace(cut32, remat=False), params32)
    ref = run(dataclasses.replace(cut32, attn_impl="chunked"), params32)
    bf16 = run(cut, params)
    check(flash["launches"] == bf16["launches"] == (2 * n_cut, n_cut)
          and flash_off["launches"] == (n_cut, n_cut) and ref["launches"] == (0, 0),
          f"{phase}: the check launched {flash['launches']} (float32, remat), "
          f"{flash_off['launches']} (no remat), {ref['launches']} (chunked), "
          f"{bf16['launches']} (bfloat16)")

    # the routing first: a pair routed otherwise would change the expert
    # leaves' gradients without raising
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    fwd = flash["routes"][:n_cut]
    recomputed = flash["routes"][n_cut:][::-1]     # the backward runs the layers in reverse
    ok = (len(flash["routes"]) == len(ref["routes"]) == 2 * n_cut
          and all(same(a, b) for a, b in zip(flash["routes"], ref["routes"]))
          and all(same(a, b) for a, b in zip(fwd, recomputed))
          and all(same(a, b) for a, b in zip(fwd, flash_off["routes"])))
    log(f"{phase}: float32 {cfg.name} at full width cut to {n_cut} layers, "
        f"B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}: every layer's routing (idx, keep) through the "
        f"float32 kernels == chunked's, == its recompute under remat, == remat off's "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{phase}: the float32 routing through the kernels differs from chunked's "
              f"or from its recompute")
    loss_rel = abs(flash["loss"] - ref["loss"]) / abs(ref["loss"])
    worst, zero, remat_worst = 0.0, 0, 0.0
    for g, g_off, w in zip(flash["grads"], flash_off["grads"], ref["grads"]):
        worst = max(worst, (torch.linalg.vector_norm(g - w)
                            / torch.linalg.vector_norm(w)).item())
        zero += int(not bool(g.abs().max() > 0))
        remat_worst = max(remat_worst, (torch.linalg.vector_norm(g - g_off)
                                        / torch.linalg.vector_norm(g_off)).item())
    remat_loss_rel = abs(flash["loss"] - flash_off["loss"]) / abs(flash_off["loss"])
    share_on = flash["dropped"] / flash["routed"]
    share_off = flash_off["dropped"] / flash_off["routed"]
    n_leaves = len(flash["grads"])
    ok = (loss_rel <= TRAIN_GRAD_REL and worst <= TRAIN_GRAD_REL and zero == 0
          and remat_loss_rel <= GRANITE_REMAT_REL and remat_worst <= GRANITE_REMAT_REL
          and share_on == share_off and flash["routed"] == 2 * flash_off["routed"])
    log(f"{phase}: float32 loss flash (kernels, remat) {flash['loss']:.6f} vs chunked (plain "
        f"autograd) {ref['loss']:.6f} (rel {loss_rel:.3e}, tol {TRAIN_GRAD_REL}); moe_aux "
        f"{flash['aux']:.6f} vs {ref['aux']:.6f}; {n_leaves} gradient leaves, worst error norm "
        f"over gradient norm {worst:.3e} (tol {TRAIN_GRAD_REL}), {zero} all-zero; launches "
        f"fwd/bwd {flash['launches']} with remat, {flash_off['launches']} without; remat off "
        f"vs on: loss rel {remat_loss_rel:.3e}, worst leaf {remat_worst:.3e} (tol "
        f"{GRANITE_REMAT_REL}), drop share {share_off:.6f} vs {share_on:.6f} (pairs counted "
        f"{flash_off['routed']} vs {flash['routed']}: remat routes each layer twice) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{phase}: float32 gradients through the kernels disagree: loss rel "
              f"{loss_rel}, worst leaf {worst}, {zero} zero leaves, remat {remat_loss_rel} "
              f"{remat_worst}, drop share {share_off} vs {share_on}")

    # bfloat16: the loss, finite gradients, and how much of the routing moved
    moved = sum(int((F.one_hot(b[0], cfg.moe.n_routed).sum(-2)
                     * (1 - F.one_hot(w[0], cfg.moe.n_routed).sum(-2))).sum())
                for b, w in zip(bf16["routes"][:n_cut], ref["routes"][:n_cut]))
    pairs = sum(b[0].numel() for b in bf16["routes"][:n_cut])
    bf_rel = abs(bf16["loss"] - ref["loss"]) / abs(ref["loss"])
    finite = all(bool(torch.isfinite(g).all()) for g in bf16["grads"])
    ok = bf_rel <= MOE_BF16_LOSS_REL and finite
    log(f"{phase}: bfloat16 (kernels, remat) loss {bf16['loss']:.6f} vs float32 "
        f"{ref['loss']:.6f} (rel {bf_rel:.3e}, tol {MOE_BF16_LOSS_REL}); moe_aux "
        f"{bf16['aux']:.6f}; every gradient finite: {finite}; (token, choice) pairs routed to "
        f"another expert than in float32: {moved} of {pairs} ({moved / pairs:.5f}); drop "
        f"share {bf16['dropped'] / bf16['routed']:.6f} (float32 {share_on:.6f}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{phase}: the bfloat16 MoE loss {bf16['loss']} is {bf_rel} from float32's, "
              f"or a gradient is not finite")
    del params, params32, batch, flash, flash_off, ref, bf16
    torch.cuda.empty_cache()
    return worst


def phase_lm_bf16_train(torch, cfg, seed: int, phase: str, n_layers=None,
                        clis=()) -> dict:
    """A bfloat16 LM's training path on the card, its attention on the
    kernels both ways (granite-3-2b as "lm-granite-train" on the d=64
    instances, deepseek-coder-33b as "lm-coder-train" at G=7,
    deepseek-moe-16b as "lm-moe-train" at G=1). (a) At full width cut to
    GRANITE_CHECK_LAYERS layers: for a dense LM the bfloat16 loss and the
    gradient of every leaf through the kernels against float32 plain
    autograd ("chunked") from the same weights (``_bf16_grad_check``); for
    an MoE LM, whose routing bfloat16 moves, float32 through the float32
    kernels against float32 chunked, the routing first
    (``_moe_grad_check``). (b) The model at full width: at full depth from
    the launcher's ``build(..., full=True)``, or, with ``n_layers``, cut to
    that depth and built as ``build`` builds an LM (``init_lm`` from a
    ``torch.Generator`` seeded 0 on the card, ``loss_fn``,
    ``token_batches``); trained TRAIN_STEPS steps of TRAIN_B x TRAIN_S
    through ``Trainer(donate=True)`` + ``adamw`` (the launcher's schedule);
    both attention counters are set to 0 just before and read just after:
    2 forward and 1 backward launches a layer a step; the loss falls; step
    ms, tokens/s, peak memory (GRANITE_SPARE of the card left), busy share,
    the step's roofline share at the (cut) config; an MoE LM's drop share
    (``count_drops``) and ``moe_aux`` at the first and the last step. (c)
    The launcher with each command line of ``clis`` (``_train_clis``)."""
    import dataclasses
    import functools

    from repro_torch.configs import LM_SHAPES
    from repro_torch.core.treepath import tree_leaves
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    # (a) the gradients through the kernels against plain autograd
    worst = (_moe_grad_check if cfg.moe is not None else _bf16_grad_check)(
        torch, cfg, seed, phase)

    # (b) full width, bfloat16, through a donating Trainer: at full depth
    # from the launcher's build, or cut to n_layers and built as it builds
    t0 = time.perf_counter()
    if n_layers is None:
        tcfg, params, loss_fn, data = launch_train.build(cfg.name, True, TRAIN_B, TRAIN_S,
                                                         "cuda")
        source = "launch.train.build(full=True)"
    else:
        tcfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = tfm.init_lm(tcfg, torch.Generator("cuda").manual_seed(0), "cuda")
        loss_fn = functools.partial(tfm.loss_fn, cfg=tcfg)
        data = lm_data.token_batches(tcfg.vocab_size, TRAIN_B, TRAIN_S)
        source = (f"its config cut to {n_layers} of {cfg.n_layers} layers, built as "
                  f"launch.train.build builds an LM")
    n_params = sum(t.numel() for t in tree_leaves(params))
    tr = Trainer(loss_fn, adamw(warmup_cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)), params,
                 donate=True)
    del params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(f"{phase}: {tcfg.name} {tcfg.dtype} params={n_params:,} ({tcfg.n_layers} layers, "
        f"remat={tcfg.remat}) from {source} on the card in "
        f"{time.perf_counter() - t0:.3f} s; params + adamw state {held / 1e9:.3f} GB "
        f"allocated; B={TRAIN_B} S={TRAIN_S} ({TRAIN_B * TRAIN_S} tokens a step), "
        f"Trainer(donate=True) + adamw(warmup_cosine_schedule({TRAIN_LR}, 10, {TRAIN_STEPS}))")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ----
    FA.reset_launches()
    FA.reset_bwd_launches()
    t0 = time.perf_counter()
    if tcfg.moe is None:
        tr.run(data, max_steps=TRAIN_STEPS, log_every=0)
    else:   # drops counted apart for the first step, the middle ones and the last
        drops = []
        for upto in (1, TRAIN_STEPS - 1, TRAIN_STEPS):
            with moe.count_drops() as n:
                tr.run(data, max_steps=upto, log_every=0)
            drops.append(n)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = FA.launches, FA.bwd_launches
    # ---- end of the counted run ----
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    losses = [hh["loss"] for hh in tr.history]
    step_ms = [hh["step_time_s"] * 1e3 for hh in tr.history]
    check(all(math.isfinite(x) for x in losses), f"{phase}: a loss is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    med = statistics.median(step_ms[1:])
    log(f"{phase}: {TRAIN_STEPS} steps in {train_s:.3f} s; step_ms "
        f"first={step_ms[0]:.3f} median(2..{TRAIN_STEPS})={med:.3f} min={min(step_ms[1:]):.3f} "
        f"max={max(step_ms[1:]):.3f}; {TRAIN_B * TRAIN_S / med * 1e3:.1f} tokens/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB, "
        f"reserved {reserved / 1e9:.3f} GB of the card's {total / 1e9:.3f} GB")
    log(f"{phase}: flash_attention launches={fwd}, flash_attention_bwd "
        f"launches={bwd} over {TRAIN_STEPS} steps ({tcfg.n_layers} layers, remat)")
    moe_stats = {}
    if tcfg.moe is not None:
        first_n, last_n = drops[0], drops[-1]
        moe_stats = {"drop_share": (first_n.share, last_n.share),
                     "moe_aux": (tr.history[0]["moe_aux"], tr.history[-1]["moe_aux"])}
        log(f"{phase}: dropped (token, choice) pairs (count_drops; remat routes each layer "
            f"twice a step): first step {first_n.dropped} of {first_n.routed} (share "
            f"{first_n.share:.6f}), last step {last_n.dropped} of {last_n.routed} (share "
            f"{last_n.share:.6f}); moe_aux (summed over {tcfg.n_layers} layers) first step "
            f"{moe_stats['moe_aux'][0]:.6f}, last {moe_stats['moe_aux'][1]:.6f}")
        check(first_n.routed == last_n.routed == 2 * tcfg.n_layers * TRAIN_B * TRAIN_S
              * tcfg.moe.top_k, f"{phase}: count_drops counted {first_n.routed} and "
                                f"{last_n.routed} pairs a step")
    check(fwd > 0 and bwd > 0, f"{phase}: the training path launched an attention "
                               f"kernel no time")
    check(fwd == 2 * bwd == 2 * tcfg.n_layers * TRAIN_STEPS,
          f"{phase}: expected {2 * tcfg.n_layers} forward and {tcfg.n_layers} "
          f"backward launches a step, got {fwd} and {bwd} over {TRAIN_STEPS} steps")
    check(last < first, f"{phase}: the loss did not fall ({first:.4f} -> {last:.4f})")
    check(peak <= total - GRANITE_SPARE,
          f"{phase}: peak allocated {peak / 1e9:.3f} GB leaves less than "
          f"{GRANITE_SPARE / 1e9:.0f} GB of the card's {total / 1e9:.3f} GB")
    busy = _busy_share(torch, lambda: tr.run(data, max_steps=tr.step + 1, log_every=0),
                       "flash", top=8)
    log(f"{phase}: one step B={TRAIN_B} S={TRAIN_S} {busy}")
    train_4k = {s_.name: s_ for s_ in LM_SHAPES}["train_4k"]
    roof = _step_roofline(torch, cfg.name,
                          dataclasses.replace(train_4k, seq_len=TRAIN_S, global_batch=TRAIN_B),
                          lambda: tr.run(data, max_steps=tr.step + 1, log_every=0), med,
                          phase, cfg=tcfg)
    log(f"{phase}: the counter's FLOPs include remat's second forward "
        f"({roof['flops']:.6e} counted against model_flops {roof['model_flops']:.6e}, 6 N T "
        f"at {tcfg.n_layers} layers)")
    del tr, data
    torch.cuda.empty_cache()

    # (c) the launcher itself on the card
    _train_clis(phase, n_params, clis)
    return dict(moe_stats, launches=fwd, bwd_launches=bwd, step_ms=med, peak=peak,
                loss=(first, last), roofline=roof, grad_rel=worst, n_params=n_params,
                n_layers=tcfg.n_layers)


# -------------------------------------------------------------- lm-moe-a2a --

def _a2a_inputs(torch, cfg, seed: int):
    """reduced(deepseek-moe-16b)'s MoE parameters (float32, on the CPU, from
    ``seed``) and x (A2A_CHECK_B x A2A_CHECK_S tokens sharing a direction of
    A2A_SKEW times their scale)."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_params(gen, cfg, torch.float32)
    x = torch.randn(A2A_CHECK_B, A2A_CHECK_S, cfg.d_model, generator=gen)
    return p, x + A2A_SKEW * torch.randn(1, 1, cfg.d_model, generator=gen)


def _a2a_checks(torch, cfg, seed: int, mesh, cpu_mesh, cpu_group) -> dict:
    """lm-moe-a2a (a): the all-to-all on the card against moe_apply and
    against the CPU's all-to-all, the MoE LM's gradients through it card ==
    CPU, the compression collectives card == CPU."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import lm as lm_data
    from repro_torch.distributed.context import activation_sharding, lm_rules
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.training import compression

    @contextlib.contextmanager
    def recorded():     # each _local_dispatch call's (slot, kept), in call order
        orig, seen = moe._local_dispatch, []

        def rec(x, ids, n_buckets, cap, valid=None):
            buf, slot, kept = orig(x, ids, n_buckets, cap, valid)
            seen.append((slot.cpu(), kept.cpu()))
            return buf, slot, kept
        moe._local_dispatch = rec
        try:
            yield seen
        finally:
            moe._local_dispatch = orig

    def cuda(tree):
        return tree_map(lambda t: t.cuda(), tree)

    out = {}
    p, x = _a2a_inputs(torch, cfg, seed)
    # capacity 8.0: no pair drops, the a2a == the gather formulation
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    with torch.inference_mode():
        y, _ = moe.moe_apply_a2a(cuda(p), x.cuda(), ample, mesh)
        y_ref, _ = moe.moe_apply(cuda(p), x.cuda(), ample)
    err = (y - y_ref).abs().max().item()
    log(f"lm-moe-a2a: (a) {cfg.name} float32 MoE on {A2A_CHECK_B}x{A2A_CHECK_S} tokens, "
        f"capacity 8.0: moe_apply_a2a vs moe_apply on the card max abs err {err:.3e} "
        f"(tol {A2A_GATHER_TOL}) {'ok' if err <= A2A_GATHER_TOL else 'FAIL'}")
    check(err <= A2A_GATHER_TOL, f"lm-moe-a2a: a2a vs moe_apply {err}")
    out["gather_err"] = err

    # the config's own capacity (pairs drop): card == CPU, routing first
    with torch.inference_mode():
        with recorded() as seen_card, moe.count_drops() as n_card:
            y_card, aux_card = moe.moe_apply_a2a(cuda(p), x.cuda(), cfg, mesh)
        with recorded() as seen_cpu, moe.count_drops() as n_cpu:
            y_cpu, aux_cpu = moe.moe_apply_a2a(p, x, cfg, cpu_mesh)
    same = len(seen_card) == len(seen_cpu) == 3 and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(seen_card, seen_cpu))
    check(same, "lm-moe-a2a: the card's dispatches differ from the CPU's")
    err = (y_card.cpu() - y_cpu).abs().max().item()
    aux_err = abs(aux_card.item() - aux_cpu.item())
    ok = err <= A2A_Y_ATOL and aux_err <= A2A_Y_ATOL and n_card.dropped == n_cpu.dropped > 0
    log(f"lm-moe-a2a: (a) capacity {cfg.moe.capacity_factor}: every dispatch's (slot, kept) "
        f"card == CPU; {n_card.dropped} of {n_card.routed} pairs dropped (CPU "
        f"{n_cpu.dropped}); y max abs err {err:.3e} (tol {A2A_Y_ATOL}), aux "
        f"{aux_card.item():.6f} vs {aux_cpu.item():.6f} {'ok' if ok else 'FAIL'}")
    check(ok, f"lm-moe-a2a: card vs CPU a2a: y {err}, aux {aux_err}, drops "
              f"{n_card.dropped} vs {n_cpu.dropped}")
    out["y_err"] = err

    # the MoE LM through the a2a: routing, loss and every gradient leaf
    lcfg = dataclasses.replace(cfg, attn_impl="chunked")
    params = tfm.init_lm(lcfg, torch.Generator().manual_seed(seed), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(lm_data.token_batches(
        lcfg.vocab_size, A2A_CHECK_B, A2A_CHECK_S, seed=seed)).items()}

    def grads(m, on_card: bool):
        live = tree_map(lambda t: (t.cuda() if on_card else t).detach().requires_grad_(True),
                        params)
        b = cuda(batch) if on_card else batch
        with recorded() as seen:
            with activation_sharding(m, lm_rules(m), moe_a2a=True):
                loss, _ = tfm.loss_fn(live, b, lcfg)
            g = torch.autograd.grad(loss, tree_leaves(live))
        return loss.item(), [t.detach().cpu() for t in g], seen

    loss_card, g_card, seen_card = grads(mesh, True)
    loss_cpu, g_cpu, seen_cpu = grads(cpu_mesh, False)
    same = len(seen_card) == len(seen_cpu) == 6 * lcfg.n_layers and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(seen_card, seen_cpu))
    check(same, "lm-moe-a2a: the LM's routing on the card differs from the CPU's")
    worst = max((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
                for a, b in zip(g_card, g_cpu))
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    ok = worst <= A2A_GRAD_REL and loss_rel <= A2A_GRAD_REL
    log(f"lm-moe-a2a: (a) the MoE LM ({lcfg.n_layers} layers, chunked) under "
        f"activation_sharding(moe_a2a=True), B={A2A_CHECK_B} S={A2A_CHECK_S}: each "
        f"layer's dispatches (forward and remat's recompute) card == CPU; loss {loss_card:.6f} "
        f"vs {loss_cpu:.6f} (rel {loss_rel:.3e}); {len(g_card)} gradient leaves, worst error "
        f"norm over gradient norm {worst:.3e} (tol {A2A_GRAD_REL}) {'ok' if ok else 'FAIL'}")
    check(ok, f"lm-moe-a2a: LM gradients card vs CPU: worst {worst}, loss {loss_rel}")
    out["grad_rel"] = worst

    # the compression collectives: int8 payloads, scales, means, errors
    g_tree = {str(i): g for i, g in enumerate(g_cpu)}
    e_tree = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i)) * 1e-3
              for i, (k, v) in enumerate(g_tree.items())}
    q_cpu, s_cpu, _ = compression.compress_with_feedback(g_tree, e_tree)
    q_card, s_card, _ = compression.compress_with_feedback(cuda(g_tree), cuda(e_tree))
    m_cpu, ne_cpu = compression.compressed_psum(g_tree, e_tree, cpu_group)
    m_card, ne_card = compression.compressed_psum(cuda(g_tree), cuda(e_tree),
                                                  mesh.get_group("model"))
    bits = all(torch.equal(q_card[k].cpu(), q_cpu[k]) and torch.equal(s_card[k].cpu(), s_cpu[k])
               and torch.equal(m_card[k].cpu(), m_cpu[k])
               and torch.equal(ne_card[k].cpu(), ne_cpu[k]) for k in g_tree)
    log(f"lm-moe-a2a: (a) compress_with_feedback's int8 payloads and scales, and "
        f"compressed_psum's means and errors over the NCCL group "
        f"({dist.get_backend(mesh.get_group('model'))}), == the CPU's over gloo bit for bit "
        f"on {len(g_tree)} gradient leaves: {bits}")
    check(bits, "lm-moe-a2a: compression on the card differs from the CPU's")
    return out


def phase_lm_moe_a2a(torch, cfg, seed: int, gather: dict, gather_train: dict) -> dict:
    """Expert parallelism through real NCCL collectives at world size 1
    (the module docstring's lm-moe-a2a): (a) ``_a2a_checks``; (b) the full
    model's prefill through the all-to-all, beside ``gather`` (lm-moe's
    prefill); (c) the model cut to MOE_TRAIN_LAYERS layers trained through
    it, beside ``gather_train`` (lm-moe-train)."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import LM_SHAPES, reduced
    from repro_torch.core.treepath import tree_leaves
    from repro_torch.data import lm as lm_data
    from repro_torch.distributed.context import activation_sharding, lm_rules
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    store = ROOT / "build" / f"nccl-store-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl", f"lm-moe-a2a: backend {dist.get_backend()}")
        mesh = make_mesh((1, 1), ("data", "model"))
        # the CPU's reference all-to-all: a gloo group and a CPU mesh over it
        cpu_group = dist.new_group(ranks=[0], backend="gloo")
        cpu_mesh = DeviceMesh.from_group([cpu_group, cpu_group], "cpu",
                                         mesh=torch.tensor([[0]]),
                                         mesh_dim_names=("data", "model"))
        log(f"lm-moe-a2a: default process group on {dist.get_backend()} (world size "
            f"{dist.get_world_size()}), mesh {mesh.device_type} {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
            f"model group on {dist.get_backend(mesh.get_group('model'))}, in "
            f"{time.perf_counter() - t0:.3f} s")
        check(mesh.device_type == "cuda"
              and dist.get_backend(mesh.get_group("model")) == "nccl",
              "lm-moe-a2a: the card's mesh is not on NCCL")
        out = {"check": _a2a_checks(torch, reduced(cfg), seed, mesh, cpu_mesh, cpu_group)}
        rules = lm_rules(mesh)

        # (b) serving: the full model's prefill through the all-to-all
        params = tfm.init_lm(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
        toks = torch.from_numpy(next(lm_data.token_batches(
            cfg.vocab_size, LM_BATCH, LM_SEQ, seed=seed))["tokens"]).cuda()

        def prefill(t):
            with activation_sharding(mesh, rules, moe_a2a=True):
                return tfm.prefill(params, t, cfg)

        with torch.inference_mode():
            prefill(toks[:, :128])                         # warm-up
            torch.cuda.synchronize()
            FA.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            prefill_s = []
            with moe.count_drops() as drops:
                for _ in range(LM_PREFILLS):
                    logits = cache = None
                    t = time.perf_counter()
                    logits, cache = prefill(toks)
                    torch.cuda.synchronize()
                    prefill_s.append(time.perf_counter() - t)
            launches = FA.launches
            peak = torch.cuda.max_memory_allocated()
            check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
                  and bool(torch.isfinite(logits).all()), "lm-moe-a2a: prefill logits")
            del logits, cache
            med = statistics.median(prefill_s)
            prefill_32k = {s_.name: s_ for s_ in LM_SHAPES}["prefill_32k"]
            roof = _step_roofline(
                torch, cfg.name,
                dataclasses.replace(prefill_32k, seq_len=LM_SEQ, global_batch=LM_BATCH),
                lambda: prefill(toks), med * 1e3,
                f"lm-moe-a2a: prefill B={LM_BATCH} S={LM_SEQ} (a2a)")
        n_coll = roof["collectives"]
        log(f"lm-moe-a2a: (b) {cfg.name} {cfg.n_layers} layers {cfg.dtype}, prefill "
            f"B={LM_BATCH} S={LM_SEQ} through moe_apply_a2a: "
            f"{','.join(f'{x * 1e3:.3f}' for x in prefill_s)} ms, median {med * 1e3:.3f} ms, "
            f"{LM_BATCH * LM_SEQ / med:.1f} tokens/s, share {roof['share']:.4f}, peak "
            f"allocated {peak / 1e9:.3f} GB; lm-moe's gather path in this run: "
            f"{gather['prefill_ms']:.3f} ms, {LM_BATCH * LM_SEQ / gather['prefill_ms'] * 1e3:.1f} "
            f"tokens/s, share {gather['share']:.4f}")
        log(f"lm-moe-a2a: (b) drop share {drops.share:.5f} ({drops.dropped} of {drops.routed} "
            f"pairs over {LM_PREFILLS} prefills: not kept at the dispatch to the owner rank, or "
            f"at the owner's dispatch by expert at 1.1 of an even share); gather path "
            f"{gather['drop_share']:.5f}; flash_attention launches={launches} over "
            f"{LM_PREFILLS} prefills; c10d collectives of one prefill (roofline.counts, on the "
            f"NCCL group): all-to-all {n_coll['all-to-all']}, all-reduce "
            f"{n_coll['all-reduce']}, {roof['collective_bytes']['all-to-all'] / 1e9:.3f} GB "
            f"all-to-all, link bytes {roof['link_bytes']:.0f} (a group of one)")
        check(launches == cfg.n_layers * LM_PREFILLS,
              f"lm-moe-a2a: {launches} attention launches over {LM_PREFILLS} prefills")
        check(n_coll["all-to-all"] == 3 * cfg.n_layers and n_coll["all-reduce"] == 2 * cfg.n_layers,
              f"lm-moe-a2a: collectives {n_coll}")
        check(drops.routed == LM_PREFILLS * cfg.n_layers * LM_BATCH * LM_SEQ * cfg.moe.top_k,
              f"lm-moe-a2a: {drops.routed} pairs counted")
        out.update(prefill_ms=med * 1e3, prefill_share=roof["share"], drop_share=drops.share,
                   launches=launches, collectives=n_coll, prefill_peak=peak)
        del params
        torch.cuda.empty_cache()

        # (c) training through the all-to-all at a cut depth
        tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
        tparams = tfm.init_lm(tcfg, torch.Generator("cuda").manual_seed(0), "cuda")

        def loss_fn(p, b):
            with activation_sharding(mesh, rules, moe_a2a=True):
                return tfm.loss_fn(p, b, tcfg)

        data = lm_data.token_batches(tcfg.vocab_size, TRAIN_B, TRAIN_S)
        tr = Trainer(loss_fn, adamw(warmup_cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)),
                     tparams, donate=True)
        del tparams
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        FA.reset_bwd_launches()
        tr.run(data, max_steps=A2A_TRAIN_STEPS, log_every=0)
        torch.cuda.synchronize()
        fwd, bwd = FA.launches, FA.bwd_launches
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
        med = statistics.median(step_ms[1:])
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(all(math.isfinite(v) for v in losses), "lm-moe-a2a: a loss is not finite")
        check(fwd == 2 * bwd == 2 * tcfg.n_layers * A2A_TRAIN_STEPS,
              f"lm-moe-a2a: training launches {fwd} and {bwd}")
        train_4k = {s_.name: s_ for s_ in LM_SHAPES}["train_4k"]
        troof = _step_roofline(torch, cfg.name,
                               dataclasses.replace(train_4k, seq_len=TRAIN_S, global_batch=TRAIN_B),
                               lambda: tr.run(data, max_steps=tr.step + 1, log_every=0), med,
                               "lm-moe-a2a: training step (a2a)", cfg=tcfg)
        log(f"lm-moe-a2a: (c) {tcfg.name} cut to {tcfg.n_layers} layers, "
            f"{sum(t.numel() for t in tree_leaves(tr.params)):,} params, {A2A_TRAIN_STEPS} steps of "
            f"{TRAIN_B}x{TRAIN_S} through moe_apply_a2a, Trainer(donate=True) + adamw: step_ms "
            f"first={step_ms[0]:.3f} median(2..)={med:.3f}; {TRAIN_B * TRAIN_S / med * 1e3:.1f} "
            f"tokens/s; peak allocated {peak / 1e9:.3f} GB; share {troof['share']:.4f}; loss "
            f"{' '.join(f'{v:.4f}' for v in losses)}: means of 3 {first:.4f} -> {last:.4f} "
            f"({'fell' if last < first else 'did not fall'}); attention launches {fwd} + {bwd}; "
            f"lm-moe-train (gather path, this run): {gather_train['step_ms']:.3f} ms, "
            f"{gather_train['peak'] / 1e9:.3f} GB, share {gather_train['roofline']['share']:.4f}")
        out.update(step_ms=med, train_peak=peak, train_share=troof["share"],
                   loss=(first, last), train_launches=(fwd, bwd))
        del tr, data
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return out


# ----------------------------------------------------------------- planner --

def _nccl_world_one(torch, tag: str):
    """A default process group of one rank on NCCL (a ``file://`` store under
    build/) and the (1, 1) mesh of ("data", "model") on the card; the caller
    destroys the group."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import make_mesh
    store = ROOT / "build" / f"nccl-store-{tag}-{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    check(dist.get_backend() == "nccl", f"{tag}: backend {dist.get_backend()}")
    return make_mesh((1, 1), ("data", "model")), store


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def phase_planner_serve(torch, cfg, params, seed: int) -> dict:
    """(b) of the planner phase: dlrm-mlperf x serve_p99 planned by
    ``specs._plan_recsys`` on the (1, 1) mesh of an NCCL group of one rank,
    its arguments the rec phase's parameters (the 48 GB table wrapped as
    DTensors, not copied) and a batch of PLANNER_SERVE_BATCH: the planned
    serve step against ``recsys.serve_step`` on the same tensors, and the
    bag kernel launched once by the planned step (its count set to 0 just
    before and read just after)."""
    import torch.distributed as dist

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.launch import specs
    from repro_torch.models import recsys as rec

    mesh, store = _nccl_world_one(torch, "planner-serve")
    try:
        shape = {s_.name: s_ for s_ in RECSYS_SHAPES}["serve_p99"]
        t0 = time.perf_counter()
        plan = specs._plan_recsys(cfg.name, cfg, shape, mesh)
        batch = _rec_batch(torch, rec_data.batch_for(cfg, shape.batch, seed=seed + 7))
        args = specs.dtensor_args(plan, mesh, (params, batch))
        check(args[0]["emb"].to_local().data_ptr() == params["emb"].data_ptr(),
              "planner: the planned step copied the table")
        plan.fn(*args)                      # warm-up
        torch.cuda.synchronize()
        EB.reset_launches()
        got = _full(plan.fn(*args))
        torch.cuda.synchronize()
        launches = EB.launches
        want = rec.serve_step(params, batch, cfg)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        equal = bool(torch.equal(got, want))
        log(f"planner: (b) {cfg.name} x {shape.name} ({shape.batch} examples) planned on "
            f"mesh (1, 1) over {dist.get_backend()}, the rec phase's "
            f"{params['emb'].numel() * params['emb'].element_size() / 1e9:.2f} GB table "
            f"wrapped in place: scores {tuple(got.shape)} {got.dtype}, max abs err vs "
            f"serve_step {err:.3e} ({'bit-equal' if equal else 'not bit-equal'}), bag "
            f"launches {launches}, in {time.perf_counter() - t0:.3f} s")
        check(tuple(got.shape) == (shape.batch,) and bool(torch.isfinite(got).all()),
              "planner: planned serve scores not finite (B,)")
        check(err <= PLANNER_SERVE_ATOL, f"planner: planned serve differs by {err}")
        check(launches == 1, f"planner: planned serve launched the bag kernel {launches} times")
        return {"launches": launches, "max_err": err, "equal": equal}
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _dryrun(argv, out: Path, timeout: float) -> list:
    """``python -m repro_torch.launch.dryrun`` in a subprocess (a fake
    process group cannot share a process with the NCCL one): its records."""
    import shutil
    import subprocess

    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                           "--out", str(out)], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("ok", "FAIL", "SKIP", "done")):
            log(f"planner: dryrun | {line}")
    check(proc.returncode == 0, f"planner: dryrun {' '.join(argv)} exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    recs = [json.loads(p_.read_text()) for p_ in sorted(out.glob("*.json"))]
    log(f"planner: dryrun {' '.join(argv)}: {len(recs)} records in {wall:.3f} s")
    return recs


def phase_planner(torch, seed: int, serve: dict) -> dict:
    """The dry-run planner on the card (the module docstring's planner):
    (a) qwen3-0.6b x train_4k planned by ``specs._plan_lm`` on the (1, 1)
    mesh of an NCCL group of one rank at full width, its global batch cut
    from 256 to PLANNER_BATCH (seq_len 4096 kept), the arguments
    materialised on the card from the plan: PLANNER_STEPS planned steps
    against as many ``make_train_step`` + ``adamw`` steps on plain tensors
    from the same weights (the loss, and every updated leaf by its error
    norm), the attention kernels' launches counted both ways; (c) the dry
    run of PLANNER_CELLS at 256 and 512 fake ranks, every record ok within
    SHARE_CAP; (d) (a)'s cut cell dry-run at world size 1, its FLOPs equal
    to ``counts.count`` of (a)'s executed step and its bytes within 1%."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import specs
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import counts

    out = {"serve": serve}
    cfg = get_config("qwen3-0.6b")
    shape = dataclasses.replace({s_.name: s_ for s_ in LM_SHAPES}["train_4k"],
                                global_batch=PLANNER_BATCH)
    mesh, store = _nccl_world_one(torch, "planner")
    try:
        t0 = time.perf_counter()
        plan = specs._plan_lm(cfg.name, cfg, shape, mesh)
        params = tfm.init_lm(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
        opt = specs.train_optimizer()
        state = opt.init(params)
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(lm_data.token_batches(
            cfg.vocab_size, shape.global_batch, shape.seq_len, seed=seed)).items()}
        clone = lambda tree: tree_map(lambda t: t.clone(), tree)  # noqa: E731
        args = specs.dtensor_args(plan, mesh, (clone(params), clone(state), batch))
        step = tfm.make_train_step(cfg, opt)
        torch.cuda.synchronize()
        log(f"planner: (a) {cfg.name} x train_4k cut to global batch {shape.global_batch} "
            f"(from 256) at seq_len {shape.seq_len}, full width ({cfg.n_layers} layers, "
            f"{sum(t.numel() for t in tree_leaves(params)):,} params, {cfg.dtype}), planned on "
            f"mesh (1, 1) over {dist.get_backend()}; arguments materialised in "
            f"{time.perf_counter() - t0:.3f} s")
        losses, planned_ms = [], []
        FA.reset_launches()
        FA.reset_bwd_launches()
        for _ in range(PLANNER_STEPS):
            t = time.perf_counter()
            p_new, s_new, loss = plan.fn(*args)
            torch.cuda.synchronize()
            planned_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(_full(loss)))
            args = (p_new, s_new, args[2])
        planned_launches = (FA.launches, FA.bwd_launches)
        FA.reset_launches()
        FA.reset_bwd_launches()
        ref_losses = []
        for _ in range(PLANNER_STEPS):
            params, state, metrics = step(params, state, batch)
            ref_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        plain_launches = (FA.launches, FA.bwd_launches)
        worst, where = 0.0, ""
        for name, got_tree, want_tree in (("params", args[0], params), ("opt", args[1], state)):
            from repro_torch.core.treepath import keystr, tree_paths
            want_flat = dict((keystr(p_), t_) for p_, t_ in tree_paths(want_tree))
            for path, t_ in tree_paths(got_tree):
                g, w = _full(t_).float(), want_flat[keystr(path)].float()
                rel = (torch.linalg.vector_norm(g - w)
                       / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
                if rel > worst:
                    worst, where = rel, f"{name}/{keystr(path)}"
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        log(f"planner: (a) {PLANNER_STEPS} planned steps: loss "
            f"{' '.join(f'{v:.6f}' for v in losses)} vs plain "
            f"{' '.join(f'{v:.6f}' for v in ref_losses)} (rel {loss_rel:.3e}); every updated "
            f"leaf: worst error norm over norm {worst:.3e} ({where}); step ms "
            f"{' '.join(f'{v:.1f}' for v in planned_ms)}; attention launches planned "
            f"{planned_launches[0]} + {planned_launches[1]}, plain {plain_launches[0]} + "
            f"{plain_launches[1]}")
        check(loss_rel <= PLANNER_LOSS_REL, f"planner: planned loss rel {loss_rel}")
        check(worst <= PLANNER_LEAF_REL, f"planner: planned leaf {where} off by {worst}")
        want_launches = (2 * cfg.n_layers * PLANNER_STEPS, cfg.n_layers * PLANNER_STEPS)
        check(planned_launches == plain_launches == want_launches,
              f"planner: attention launches planned {planned_launches}, plain "
              f"{plain_launches}, want {want_launches}")
        out["launches"] = planned_launches
        # (d)'s reference: one more planned step, counted on the card
        torch.cuda.reset_peak_memory_stats()
        counted = counts.count(lambda: plan.fn(*args))
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated()
        del args, params, state, p_new, s_new, loss
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    # (c) the dry run at 256 and 512 fake ranks
    cells = [c for a, s_ in PLANNER_CELLS for c in ("--cell", f"{a}:{s_}")]
    recs = _dryrun([*cells, "--both-meshes"], ROOT / "build" / "planner" / "cells",
                   PLANNER_DRYRUN_TIMEOUT)
    check(len(recs) == 2 * len(PLANNER_CELLS), f"planner: {len(recs)} dry-run records")
    for r in recs:
        check(r["ok"], f"planner: dry run of {r['arch']} x {r['shape']} on {r['mesh']} "
                       f"failed: {r.get('error')}")
        roof = r["roofline"]
        log(f"planner: (c) {r['arch']} x {r['shape']} on {r['mesh']}: per-rank peak "
            f"{r['memory']['peak_estimate_bytes'] / 1e9:.3f} GB (arguments "
            f"{r['memory']['argument_bytes'] / 1e9:.3f} GB), bottleneck {roof['bottleneck']}, "
            f"step bound {roof['step_s'] * 1e3:.3f} ms, roofline_frac "
            f"{roof['roofline_frac']:.4f}, collectives {roof['n_collectives']}, run "
            f"{r['run_s']:.2f} s")
        check(roof["roofline_frac"] <= SHARE_CAP,
              f"planner: {r['arch']} x {r['shape']} roofline_frac {roof['roofline_frac']}")
    out["cells"] = recs

    # (d) (a)'s cut cell at world size 1, against (a)'s executed step
    (rec,) = _dryrun(["--cell", f"{cfg.name}:train_4k", "--mesh", "1x1", "--global-batch",
                      str(PLANNER_BATCH)], ROOT / "build" / "planner" / "world1",
                     PLANNER_DRYRUN_TIMEOUT)
    check(rec["ok"], f"planner: world-1 dry run failed: {rec.get('error')}")
    dry = rec["counts"]
    bytes_rel = abs(dry["bytes_accessed"] - counted.bytes_accessed) / counted.bytes_accessed
    log(f"planner: (d) world-1 dry run of the cut cell: {dry['flops']:.6e} FLOPs, "
        f"{dry['bytes_accessed']:.6e} bytes; the executed step counted on the card "
        f"{counted.flops:.6e} FLOPs, {counted.bytes_accessed:.6e} bytes (rel {bytes_rel:.3e}); "
        f"peak estimate {rec['memory']['peak_estimate_bytes'] / 1e9:.3f} GB vs the card's "
        f"max_memory_allocated {card_peak / 1e9:.3f} GB over the counted step (ratio "
        f"{rec['memory']['peak_estimate_bytes'] / card_peak:.4f})")
    check(dry["flops"] == counted.flops, f"planner: world-1 FLOPs {dry['flops']} != "
                                         f"{counted.flops}")
    check(bytes_rel <= 0.01, f"planner: world-1 bytes off by {bytes_rel}")
    out.update(flops=counted.flops, bytes_rel=bytes_rel,
               peak_ratio=rec["memory"]["peak_estimate_bytes"] / card_peak)
    return out


# -------------------------------------------------------------- bag-kernel --

def _bag_agrees(torch, EB, table, ids, weights, dtype: str, what: str) -> float:
    """The kernel against its plain version on the same inputs, by max
    absolute error at the dtype's tolerance; returns the error."""
    got = EB.embedding_bag(table, ids, weights)
    want = EB.embedding_bag_plain(table, ids, weights)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    exact = bool(torch.equal(got, want))
    ok = math.isfinite(err) and err <= BAG_TOLERANCE[dtype]
    log(f"bag-kernel: {what} {dtype}: max_abs_err={err:.3e} tol={BAG_TOLERANCE[dtype]} "
        f"bit_equal={exact} {'ok' if ok else 'FAIL'}")
    check(ok, f"bag kernel disagrees with its plain version at {what} {dtype}: {err}")
    # both sum each bag in float32 in order, each product and sum rounded
    # on its own, so they agree bit for bit (a bag of one row is that row)
    check(exact, f"bag kernel is not bit-equal to its plain version at {what} {dtype}")
    return err


def _top_ids(torch, gen, v: int, shape):
    """int32 ids drawn from the last BAG_TOP of a table's v rows."""
    return torch.randint(int(v * (1 - BAG_TOP)), v, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _serve_ids(torch, cfg, batch: int, seed: int):
    """A serve batch's ids from data/recsys.py with the field offsets folded
    in, as embedding_lookup hands them to the kernel: (batch * 26, 1)."""
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    ids = torch.from_numpy(rec_data.batch_for(cfg, batch, seed=seed)["ids"]).cuda()
    return (ids + rec.field_offsets(cfg.vocab_sizes, "cuda")).reshape(-1, 1)


def phase_bag_kernel(torch, cfg, seed: int) -> dict:
    """The bag kernel against its plain version, then dlrm-mlperf's table
    drawn at full width, the kernel over it at the path's shapes, and the
    times there. Returns the DLRM parameters for the recsys phases."""
    import torch.nn.functional as F
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec
    from repro_torch.roofline import analysis

    gen = torch.Generator(device="cuda").manual_seed(2468)
    sizes = {s.name: s for s in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    mb, ml = BAG_MULTI
    d = cfg.embed_dim
    max_err = {"float32": 0.0, "bfloat16": 0.0}

    def weights(b, l):
        return torch.rand((b, l), generator=gen, device="cuda")

    for v, d_, b, l in BAG_SHAPES:
        for dtype in ("float32", "bfloat16"):
            table = torch.randn((v, d_), generator=gen, device="cuda").to(getattr(torch, dtype))
            ids = torch.randint(0, v, (b, l), generator=gen, device="cuda", dtype=torch.int32)
            for w in (None, weights(b, l)):
                err = _bag_agrees(torch, EB, table, ids, w, dtype,
                                  f"V={v} d={d_} B={b} L={l} weighted={w is not None}")
                max_err[dtype] = max(max_err[dtype], err)

    # ids outside the table, as jnp.take reads them: [-V, 0) wraps to
    # id + V, and an id outside [-V, V) makes its whole bag NaN
    v, b, l = BAG_SHAPES[3][0], 13, 3
    for dtype in ("float32", "bfloat16"):
        table = torch.randn((v, d), generator=gen, device="cuda").to(getattr(torch, dtype))
        for bad in (-1, -v, v, -v - 1):
            ids = torch.randint(0, v, (b, l), generator=gen, device="cuda", dtype=torch.int32)
            ids[1, 2] = ids[4, 0] = bad
            for w in (None, weights(b, l)):
                got = EB.embedding_bag(table, ids, w).float()
                want = EB.embedding_bag_plain(table, ids, w).float()
                nan_got, nan_want = torch.isnan(got), torch.isnan(want)
                same_nan = bool(torch.equal(nan_got, nan_want))
                nan_bags = nan_want.all(dim=1).nonzero().view(-1).tolist()
                err = (got - want).nan_to_num(0.0).abs().max().item()
                ok = (same_nan and nan_bags == ([1, 4] if bad in (v, -v - 1) else [])
                      and err <= BAG_TOLERANCE[dtype])
                log(f"bag-kernel: id {bad} at bags 1 and 4, V={v} B={b} L={l} "
                    f"weighted={w is not None} {dtype}: NaN positions equal={same_nan}, "
                    f"NaN bags {nan_bags}, max_abs_err elsewhere={err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"bag kernel: id {bad} outside the table disagrees with the "
                          f"plain version ({dtype}, weighted={w is not None})")

    # float32 over a table past 2^31 elements: a 32-bit offset would wrap
    table = torch.empty((BAG_F32_ROWS, d), device="cuda").normal_(generator=gen)
    for name, n_bags in (("serve_p99", p99 * cfg.n_sparse), ("serve_bulk", bulk * cfg.n_sparse)):
        err = _bag_agrees(torch, EB, table, _top_ids(torch, gen, BAG_F32_ROWS, (n_bags, 1)),
                          None, "float32", f"{name} {n_bags} bags L=1 V={BAG_F32_ROWS} "
                          f"ids in the last {BAG_TOP:.0%} of rows")
        max_err["float32"] = max(max_err["float32"], err)
    ids = torch.randint(0, BAG_F32_ROWS, (mb, ml), generator=gen, device="cuda",
                        dtype=torch.int32)
    for w in (None, weights(mb, ml)):
        err = _bag_agrees(torch, EB, table, ids, w, "float32",
                          f"multi-hot B={mb} L={ml} V={BAG_F32_ROWS} weighted={w is not None}")
        max_err["float32"] = max(max_err["float32"], err)
    del table, ids
    torch.cuda.empty_cache()

    # dlrm-mlperf's table at full width, drawn on the card from --seed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = rec.init_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table = params["emb"]
    v = table.shape[0]
    # every chunk of the in-place draw holds N(0, 0.02) values: a chunk
    # left undrawn would hold whatever the allocator's memory held
    stds = [table[i:i + rec.INIT_CHUNK_ROWS:509].float().std().item()
            for i in range(0, v, rec.INIT_CHUNK_ROWS)]
    log(f"bag-kernel: dlrm-mlperf parameters drawn on the card in {init_s:.3f} s: table "
        f"{v} x {d} {table.dtype} ({table.numel() * table.element_size() / 1e9:.3f} GB), "
        f"memory allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB; std of every "
        f"{rec.INIT_CHUNK_ROWS}-row chunk (every 509th row) {min(stds):.5f}..{max(stds):.5f}")
    check(all(abs(x - 0.02) < 5e-4 for x in stds),
          f"the table's chunks are not N(0, 0.02): stds {min(stds)}..{max(stds)}")
    serve = {"serve_p99": _serve_ids(torch, cfg, p99, seed),
             "serve_bulk": _serve_ids(torch, cfg, bulk, seed + 1)}
    for name, ids in serve.items():
        for what, ids_ in (("ids from data/recsys.py", ids),
                           (f"ids in the last {BAG_TOP:.0%} of rows",
                            _top_ids(torch, gen, v, tuple(ids.shape)))):
            err = _bag_agrees(torch, EB, table, ids_, None, "bfloat16",
                              f"{name} {ids.shape[0]} bags L=1 V={v} {what}")
            max_err["bfloat16"] = max(max_err["bfloat16"], err)
    multi = torch.randint(0, v, (mb, ml), generator=gen, device="cuda", dtype=torch.int32)
    for w in (None, weights(mb, ml)):
        err = _bag_agrees(torch, EB, table, multi, w, "bfloat16",
                          f"multi-hot B={mb} L={ml} V={v} weighted={w is not None}")
        max_err["bfloat16"] = max(max_err["bfloat16"], err)

    # times over the full table: serve_p99 cycles through BAG_P99_SETS id
    # sets so each launch finds its rows cold in L2, as a stream of
    # requests would
    sets = {"serve_p99": [serve["serve_p99"]]
            + [_serve_ids(torch, cfg, p99, seed + 100 + i) for i in range(BAG_P99_SETS - 1)],
            "serve_bulk": [serve["serve_bulk"]], "multi-hot": [multi]}
    timings = {}
    for name, id_sets in sets.items():
        turn = dict.fromkeys(("kernel", "plain", "library", "gather"), 0)

        def cycled(key, fn, id_sets=id_sets, turn=turn):
            def call():
                turn[key] = (turn[key] + 1) % len(id_sets)
                return fn(id_sets[turn[key]])
            return call

        fns = {"kernel": cycled("kernel", lambda i: EB.embedding_bag(table, i)),
               "plain": cycled("plain", lambda i: EB.embedding_bag_plain(table, i)),
               "library": cycled("library", lambda i: F.embedding_bag(i, table, mode="sum"))}
        if id_sets[0].shape[1] == 1:   # a plain row gather, for scale (not the function)
            fns["gather"] = cycled("gather", lambda i: table.index_select(0, i.view(-1)))
        lib_err = (F.embedding_bag(id_sets[0], table, mode="sum").float()
                   - EB.embedding_bag_plain(table, id_sets[0]).float()).abs().max().item()
        check(lib_err <= BAG_TOLERANCE["bfloat16"],
              f"F.embedding_bag disagrees with the plain version at {name}: {lib_err}")
        iters = 200 if name == "serve_p99" else 20
        t = _time_alternating(torch, fns, iters=iters)
        dev_ms = _queued_ms(torch, fns["kernel"], iters)
        # the bound of the cycled id sets: each set's work, averaged
        works = [analysis.embedding_bag_work(i, False, d, "bfloat16") for i in id_sets]
        bd = analysis.bound(statistics.mean(w_[0] for w_ in works),
                            statistics.mean(w_[1] for w_ in works), "bfloat16", products=False)
        distinct = statistics.mean(int(i.unique().numel()) for i in id_sets)
        b, l = id_sets[0].shape
        timings[name] = dict(t, bound_ms=bd.ms, bound_by=bd.by, device_ms=dev_ms,
                             shape=f"B={b} L={l} d={d} V={v}")
        log(f"bag-kernel: {name} B={b} L={l} bfloat16 kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={dev_ms:.5f} "
            f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} (F.embedding_bag "
            f"mode=sum, max_abs_err vs plain {lib_err:.2e}) "
            + (f"gather_ms={t['gather']:.5f} (index_select of the rows) " if "gather" in t else "")
            + f"{distinct:.0f} distinct rows of {b * l} named; "
            + _bound_text(bd, t["kernel"], f"bag-kernel: {name}", dev_ms)
            + f" achieved_GB/s={bd.n_bytes / t['kernel'] / 1e6:.1f}")
    del serve, sets, multi
    torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings, "params": params, "init_s": init_s}


# --------------------------------------------------------------- rec-check --

def _rec_batch(torch, batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items() if k != "label"}


def phase_rec_check(torch, cfg, params, seed: int) -> None:
    """The DLRM path in bfloat16 through the kernel against the same path
    through the plain version (reduced(dlrm-mlperf) in float32 on the card
    against the CPU is rec-train's, with its loss and gradients)."""
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec

    for b in REC_CHECK_BATCHES:
        batch = _rec_batch(torch, rec_data.batch_for(cfg, b, seed=seed + 7 + b))
        got = rec.serve_step(params, batch, cfg)
        want = rec.serve_step(params, batch, cfg, lookup="plain")
        ok = (tuple(got.shape) == (b,) and bool(torch.isfinite(got).all())
              and bool(torch.equal(got, want)))
        log(f"rec-check: serve_step B={b} bfloat16 kernel == plain lookup: "
            f"{'ok' if ok else 'FAIL'} (max_abs_err "
            f"{(got - want).abs().max().item():.3e}, scores std {got.std().item():.4f})")
        check(ok, f"serve_step through the kernel != through the plain lookup at B={b}")
    batch = _rec_batch(torch, rec_data.retrieval_batch(cfg, REC_CHECK_CANDIDATES, seed=seed + 9))
    got = rec.retrieval_step(params, batch, cfg)
    want = rec.retrieval_step(params, batch, cfg, lookup="plain")
    ok = (tuple(got.shape) == (REC_CHECK_CANDIDATES,) and bool(torch.isfinite(got).all())
          and bool(torch.equal(got, want)))
    log(f"rec-check: retrieval_step N={REC_CHECK_CANDIDATES} bfloat16 kernel == plain "
        f"lookup: {'ok' if ok else 'FAIL'} (max_abs_err {(got - want).abs().max().item():.3e})")
    check(ok, "retrieval_step through the kernel != through the plain lookup")


# --------------------------------------------------------------------- rec --

def phase_rec(torch, cfg, params, seed: int) -> dict:
    """dlrm-mlperf's serving path at full width in bfloat16. The bag
    kernel's launch count is set to 0 just before and read just after, and
    must be 1 per serve_step and 2 per retrieval_step. serve_bulk is then
    counted once more and read against its bound."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec

    sync = torch.cuda.synchronize
    sizes = {s.name: s for s in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    n_cand = sizes["retrieval_cand"].n_candidates
    t0 = time.perf_counter()
    gen = rec_data.batches(cfg, p99, seed=seed)
    p99_batches = [_rec_batch(torch, next(gen)) for _ in range(REC_P99_STEPS + 1)]
    bulk_batch = _rec_batch(torch, rec_data.batch_for(cfg, bulk, seed=seed + 1))
    ret_batch = _rec_batch(torch, rec_data.retrieval_batch(cfg, n_cand, seed=seed + 2))
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"rec: cfg={cfg.name} fields={cfg.n_sparse} embed_dim={cfg.embed_dim} "
        f"bot={cfg.bot_mlp} top={cfg.top_mlp} {cfg.dtype} params={n_params} "
        f"(n_params() {cfg.n_params()}; the table padded to {params['emb'].shape[0]} rows); "
        f"batches made in {time.perf_counter() - t0:.3f} s")
    # warm-up at each shape: allocator, cuBLAS handles and heuristics
    rec.serve_step(params, p99_batches[-1], cfg)
    rec.serve_step(params, bulk_batch, cfg)
    rec.retrieval_step(params, ret_batch, cfg)
    sync()
    torch.cuda.empty_cache()

    # ---- the main path, counted ----
    EB.reset_launches()
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    p99_s = []
    for batch in p99_batches[:REC_P99_STEPS]:
        t = time.perf_counter()
        scores = rec.serve_step(params, batch, cfg)
        sync()
        p99_s.append(time.perf_counter() - t)
        check(tuple(scores.shape) == (p99,) and bool(torch.isfinite(scores).all()),
              "serve_p99 scores not finite (B,)")
    peak["serve_p99"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bulk_s = []
    for _ in range(REC_BULK_STEPS):
        t = time.perf_counter()
        scores = rec.serve_step(params, bulk_batch, cfg)
        sync()
        bulk_s.append(time.perf_counter() - t)
    check(tuple(scores.shape) == (bulk,) and bool(torch.isfinite(scores).all()),
          "serve_bulk scores not finite (B,)")
    bulk_std = scores.std().item()
    del scores
    peak["serve_bulk"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ret_s = []
    for _ in range(REC_RETRIEVAL_STEPS):
        t = time.perf_counter()
        cand = rec.retrieval_step(params, ret_batch, cfg)
        sync()
        ret_s.append(time.perf_counter() - t)
    peak["retrieval_cand"] = torch.cuda.max_memory_allocated()
    launches = EB.launches
    # ---- end of the counted run ----

    check(tuple(cand.shape) == (n_cand,) and bool(torch.isfinite(cand).all()),
          "retrieval scores not finite (N,)")
    n_serve = REC_P99_STEPS + REC_BULK_STEPS
    log(f"rec: serve_p99 B={p99}, {REC_P99_STEPS} steps: p50_ms={_percentile(p99_s, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(p99_s, 0.99) * 1e3:.3f} (min {min(p99_s) * 1e3:.3f}, max "
        f"{max(p99_s) * 1e3:.3f}); peak allocated {peak['serve_p99'] / 1e9:.3f} GB")
    med = statistics.median(bulk_s)
    log(f"rec: serve_bulk B={bulk}: {','.join(f'{x * 1e3:.3f}' for x in bulk_s)} ms, median "
        f"{med * 1e3:.3f} ms, {bulk / med:.1f} examples/s; scores std {bulk_std:.4f}; peak "
        f"allocated {peak['serve_bulk'] / 1e9:.3f} GB")
    med_r = statistics.median(ret_s)
    log(f"rec: retrieval_cand 1 query x {n_cand} candidates: "
        f"{','.join(f'{x * 1e3:.3f}' for x in ret_s)} ms, median {med_r * 1e3:.3f} ms, "
        f"{n_cand / med_r:.1f} candidates/s; peak allocated "
        f"{peak['retrieval_cand'] / 1e9:.3f} GB; top candidate {int(cand.argmax())}")
    log(f"rec: embedding_bag launches={launches} over {n_serve} serve_step and "
        f"{REC_RETRIEVAL_STEPS} retrieval_step calls")
    check(launches > 0, "the DLRM path launched the bag kernel no time")
    check(launches == n_serve + 2 * REC_RETRIEVAL_STEPS,
          f"expected 1 bag launch per serve_step and 2 per retrieval_step, got {launches} "
          f"for {n_serve} and {REC_RETRIEVAL_STEPS}")
    del cand
    torch.cuda.empty_cache()
    log(f"rec: serve_bulk B={bulk} "
        f"{_busy_share(torch, lambda: rec.serve_step(params, bulk_batch, cfg), 'embedding_bag', top=12)}")
    _step_roofline(torch, cfg.name, sizes["serve_bulk"],
                   lambda: rec.serve_step(params, bulk_batch, cfg), med * 1e3,
                   f"rec: serve_bulk B={bulk}")
    return {"launches": launches}


# ----------------------------------------------------------------- bag-bwd --

def _bwd_agrees(torch, EB, g, ids, w, v: int, what: str) -> float:
    """The backward kernel against its plain version on the same inputs, bit
    for bit (both sum in the kernel's order); returns the max abs error."""
    got = EB.embedding_bag_bwd(g, ids, w, v)
    want = EB.embedding_bag_bwd_plain(g, ids, w, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    exact = bool(torch.equal(got, want))
    dtype = str(g.dtype).replace("torch.", "")
    log(f"bag-bwd: {what} weighted={w is not None} {dtype}: max_abs_err={err:.3e} "
        f"bit_equal={exact} {'ok' if exact else 'FAIL'}")
    check(exact, f"bag backward kernel is not bit-equal to its plain version at {what} "
                 f"{dtype} weighted={w is not None}: {err}")
    return err


def phase_bag_bwd(torch, cfg, seed: int) -> dict:
    """The EmbeddingBag backward kernel against its plain version, bit for
    bit, in float32 and bfloat16, weighted and not: at BAG_SHAPES, a 3-row
    field named 65,536 times, ids outside the table, a float32 gradient past
    2^31 elements; then dlrm-mlperf's training lookup (B=65,536 x 26 bags of
    one row over the table cut to REC_TRAIN_MAX_ROWS rows a field): two
    calls bit-equal, times of the kernel, its sort, the plain version and
    embedding_dense_backward (the yardstick), the bound; last, the port's
    counter on the card reads a lookup and its gradient as their formulas."""
    import dataclasses

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec
    from repro_torch.roofline import analysis
    from repro_torch.roofline import counts as counters

    gen = torch.Generator(device="cuda").manual_seed(1357)
    d = cfg.embed_dim
    max_err = {"float32": 0.0, "bfloat16": 0.0}

    def ids_in(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    def grad_out(b, d_, dtype):
        return torch.randn((b, d_), generator=gen, device="cuda").to(getattr(torch, dtype))

    cases = [(f"V={v} d={d_} B={b} L={l}", v, d_, ids_in(0, v, (b, l)))
             for v, d_, b, l in BAG_SHAPES]
    hv, hn = BAG_BWD_HOT
    cases.append((f"a {hv}-row field at B={hn} L=1", hv, d, ids_in(0, hv, (hn, 1))))
    v = BAG_SHAPES[3][0]
    for bad in (-1, -v, v, -v - 1):   # [-V, 0) wraps; outside [-V, V) adds nothing
        ids = ids_in(0, v, (13, 3))
        ids[1, 2] = ids[4, 0] = bad
        cases.append((f"id {bad} at bags 1 and 4, V={v} B=13 L=3", v, d, ids))
    for what, v, d_, ids in cases:
        for dtype in ("float32", "bfloat16"):
            g = grad_out(ids.shape[0], d_, dtype)
            for w in (None, torch.rand(tuple(ids.shape), generator=gen, device="cuda")):
                max_err[dtype] = max(max_err[dtype], _bwd_agrees(torch, EB, g, ids, w, v, what))
    # a float32 gradient past 2^31 elements: a 32-bit offset would wrap
    ids = _top_ids(torch, gen, BAG_F32_ROWS, (BAG_MULTI[0], 1))
    g = grad_out(ids.shape[0], d, "float32")
    max_err["float32"] = max(max_err["float32"], _bwd_agrees(
        torch, EB, g, ids, None, BAG_F32_ROWS,
        f"V={BAG_F32_ROWS} d={d} B={ids.shape[0]} L=1, ids in the last {BAG_TOP:.0%} of rows"))
    del ids, g
    torch.cuda.empty_cache()

    # dlrm-mlperf's training lookup, the table cut as rec-train cuts it
    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(x, REC_TRAIN_MAX_ROWS)
                                                     for x in cfg.vocab_sizes))
    v = rec.padded_rows(sum(cut.vocab_sizes))
    b_train = {s_.name: s_ for s_ in RECSYS_SHAPES}["train_batch"].batch
    ids = _serve_ids(torch, cut, b_train, seed)
    g = grad_out(ids.shape[0], d, "bfloat16")
    counts = torch.bincount(ids.view(-1).long(), minlength=v)
    log(f"bag-bwd: training lookup {ids.shape[0]} bags of one row (B={b_train} x "
        f"{cfg.n_sparse} fields) over V={v} rows (fields cut to {REC_TRAIN_MAX_ROWS}): "
        f"{int((counts > 0).sum())} rows named, the hottest {int(counts.max())} times, "
        f"{int((counts > EB.BWD_CHUNK).sum())} rows named more than {EB.BWD_CHUNK} times")
    first = EB.embedding_bag_bwd(g, ids, None, v)
    second = EB.embedding_bag_bwd(g, ids, None, v)
    torch.cuda.synchronize()
    twice = bool(torch.equal(first, second))
    log(f"bag-bwd: two calls at the training lookup bit-equal: {twice}")
    check(twice, "bag backward: two calls differ")
    max_err["bfloat16"] = max(max_err["bfloat16"], _bwd_agrees(
        torch, EB, g, ids, None, v, f"training lookup V={v} d={d} B={ids.shape[0]} L=1"))
    flat = ids.view(-1).long()
    lib = torch.ops.aten.embedding_dense_backward(g, flat, v, -1, False)
    lib_err = (lib.float() - first.float()).abs().max().item()
    lib_rel = (torch.linalg.vector_norm(lib.float() - first.float())
               / torch.linalg.vector_norm(first.float())).item()
    del first, second, lib
    fns = {"kernel": lambda: EB.embedding_bag_bwd(g, ids, None, v),
           "library": lambda: torch.ops.aten.embedding_dense_backward(g, flat, v, -1, False),
           "sort": lambda: EB._sorted_positions(ids, v)}
    t = _time_alternating(torch, fns, iters=20)
    EB.embedding_bag_bwd_plain(g, ids, None, v)   # warm-up
    plain_ms = _event_ms(torch, lambda: EB.embedding_bag_bwd_plain(g, ids, None, v), 2)
    dev_ms = _queued_ms(torch, fns["kernel"], 20)
    bd = analysis.bound(*analysis.embedding_bag_bwd_work(ids, False, d, v, "bfloat16"),
                        "bfloat16", products=False)
    log(f"bag-bwd: training lookup bfloat16 kernel_ms={t['kernel']:.5f} "
        f"kernel_device_ms={dev_ms:.5f} (its torch.sort of the keys {t['sort']:.5f} ms) "
        f"plain_ms={plain_ms:.5f} library_ms={t['library']:.5f} "
        f"(aten.embedding_dense_backward, max_abs_err vs the kernel "
        f"{lib_err:.3e}, error norm {lib_rel:.3e}) "
        + _bound_text(bd, t["kernel"], "bag-bwd: training lookup", dev_ms)
        + f" achieved_GB/s={bd.n_bytes / dev_ms / 1e6:.1f}")

    # the port's counter on the card: a lookup and its gradient through
    # EmbeddingBag, the backward on autograd's own thread, read the formulas
    table = torch.zeros((v, d), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    before = (EB.launches, EB.bwd_launches)
    counted = counters.count(lambda: torch.autograd.backward(
        EB.embedding_bag(table, ids), g))
    launched = (EB.launches - before[0], EB.bwd_launches - before[1])
    want = [x + y for x, y in zip(analysis.embedding_bag_work(ids, False, d, "bfloat16"),
                                  analysis.embedding_bag_bwd_work(ids, False, d, v, "bfloat16"))]
    # bytes: the formulas' and any the autograd engine's own aten ops add
    ok = (counted.flops == want[0] and counted.bytes_accessed >= want[1]
          and launched == (1, 1))
    log(f"bag-bwd: under the counter, one lookup + gradient at the training lookup "
        f"(launches {launched}) reads {counted.flops:.6e} operations and "
        f"{counted.bytes_accessed:.6e} bytes, the formulas' {want[0]:.6e} and {want[1]:.6e} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"bag-bwd: the counter read {counted.flops}, {counted.bytes_accessed} for a "
              f"lookup and its gradient on the card, not the formulas' {want}")
    del g, ids, flat, counts, table
    torch.cuda.empty_cache()
    return {"max_err": max_err,
            "timing": dict(t, plain=plain_ms, device_ms=dev_ms, bound_ms=bd.ms,
                           bound_by=bd.by,
                           shape=f"B={b_train * cfg.n_sparse} L=1 d={d} V={v}")}


# --------------------------------------------------------------- rec-train --

def _grad_trees_close(torch, got, want):
    """(every leaf within REC_GRAD_TOL elementwise, the worst max abs error)."""
    close, worst = True, 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        g, w = g.float().cpu(), w.float().cpu()
        close &= bool(torch.allclose(g, w, **REC_GRAD_TOL))
        worst = max(worst, (g - w).abs().max().item())
    return close, worst


def _serving_batch(cfg, batch: dict) -> dict:
    """A serving batch from data/recsys.py's training batch: BERT4Rec serves
    {"seq", "target"} (the label as the target, as the JAX package's
    launch/specs.py lays it out); the CTR models their batch as it is."""
    if cfg.kind == "bert4rec":
        return {"seq": batch["seq"], "target": batch["label"]}
    return batch


def _reduced_on_card_vs_cpu(torch, cfg, seed: int, what: str) -> None:
    """reduced(cfg) in float32: serve_step, retrieval_step, loss_fn and every
    gradient leaf on the card against the CPU."""
    import functools

    from repro_torch.configs import reduced
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    from repro_torch.training.train_loop import value_and_grad

    small = reduced(cfg)
    cpu = rec.init_model(small, torch.Generator().manual_seed(seed), "cpu")
    card = rec.params_from_numpy(cpu, "cuda")
    batch = rec_data.batch_for(small, 256, seed=seed)
    serve = _serving_batch(small, batch)
    rbatch = rec_data.retrieval_batch(small, 1000, seed=seed)
    with torch.inference_mode():
        for name, fn, b in (("serve_step B=256", rec.serve_step, serve),
                            ("retrieval_step N=1000", rec.retrieval_step, rbatch)):
            on_card = fn(card, _rec_batch(torch, b), small).cpu()
            on_cpu = fn(cpu, {k: torch.from_numpy(v) for k, v in b.items()}, small)
            err = (on_card - on_cpu).abs().max().item()
            ok = bool(torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-5))
            log(f"{what}: {small.name} float32 {name} on the card == on the CPU: "
                f"max_abs_err={err:.3e} (rtol=1e-4 atol=1e-5) {'ok' if ok else 'FAIL'}")
            check(ok, f"{small.name} {name}: the card disagrees with the CPU: {err}")
    loss = functools.partial(rec.loss_fn, cfg=small)
    l_card, _, g_card = value_and_grad(loss, card, {k: torch.from_numpy(v).cuda()
                                                    for k, v in batch.items()})
    l_cpu, _, g_cpu = value_and_grad(loss, cpu, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    loss_rel = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    close, worst = _grad_trees_close(torch, g_card, g_cpu)
    ok = loss_rel <= REC_LOSS_REL and close
    log(f"{what}: {small.name} float32 loss_fn B=256 on the card {l_card.item():.6f} vs the "
        f"CPU {l_cpu.item():.6f} (rel {loss_rel:.3e}, tol {REC_LOSS_REL}); "
        f"{len(list(_leaves(g_cpu)))} gradient leaves within rtol "
        f"{REC_GRAD_TOL['rtol']} atol {REC_GRAD_TOL['atol']}: {close} (max abs error "
        f"{worst:.3e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{small.name}: loss or gradients on the card disagree with the CPU: loss rel "
              f"{loss_rel}, worst leaf {worst}")


def phase_rec_train(torch, cfg, seed: int) -> dict:
    """dlrm-mlperf's training path on the card, bfloat16, every width full
    and each field cut to REC_TRAIN_MAX_ROWS rows: Trainer + adamw (the
    launcher's schedule) for REC_TRAIN_STEPS steps of RECSYS_SHAPES'
    train_batch, data from data/recsys.py seed 0; both bag counters set to 0
    just before and read just after: one forward and one backward launch a
    step; the loss falls; step ms, examples/s, peak memory, the step's share
    of its bound, busy share. Then the kernel route's gradient tree ==
    the plain route's (torch.equal, B=REC_TRAIN_CHECK_B), reduced float32 on
    the card against the CPU, and python -m repro_torch.launch.train on the
    card."""
    import dataclasses
    import functools

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer, value_and_grad

    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, REC_TRAIN_MAX_ROWS)
                                                     for v in cfg.vocab_sizes))
    train_shape = {s_.name: s_ for s_ in RECSYS_SHAPES}["train_batch"]
    b_train = train_shape.batch
    t0 = time.perf_counter()
    params = rec.init_model(cut, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t_.numel() for t_ in _leaves(params))
    v, d = params["emb"].shape
    loss = functools.partial(rec.loss_fn, cfg=cut)
    tr = Trainer(loss, adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, REC_TRAIN_STEPS)),
                 params)
    del params
    torch.cuda.synchronize()
    log(f"rec-train: {cfg.name} {cut.dtype} at full width (d={d}, {cut.n_dense} dense, "
        f"{cut.n_sparse} fields, bot {cut.bot_mlp}, top {cut.top_mlp}), fields cut to "
        f"{REC_TRAIN_MAX_ROWS} rows: table {v} x {d} ({v * d * 2 / 1e9:.3f} GB), "
        f"params={n_params:,}, Trainer + adamw(warmup_cosine_schedule({REC_TRAIN_LR}, 10, "
        f"{REC_TRAIN_STEPS})) ready in {time.perf_counter() - t0:.3f} s; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    data = rec_data.batches(cut, b_train, seed=0)
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ----
    EB.reset_launches()
    EB.reset_bwd_launches()
    t0 = time.perf_counter()
    tr.run(data, max_steps=REC_TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = EB.launches, EB.bwd_launches
    # ---- end of the counted run ----
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    check(all(math.isfinite(x) for x in losses), "rec-train: a loss is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    med = statistics.median(step_ms[1:])
    log(f"rec-train: {REC_TRAIN_STEPS} steps of B={b_train} in {train_s:.3f} s; step_ms "
        f"first={step_ms[0]:.3f} median(2..{REC_TRAIN_STEPS})={med:.3f} "
        f"min={min(step_ms[1:]):.3f} max={max(step_ms[1:]):.3f}; "
        f"{b_train / med * 1e3:.1f} examples/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB")
    log(f"rec-train: embedding_bag launches={fwd}, embedding_bag_bwd launches={bwd} over "
        f"{REC_TRAIN_STEPS} steps")
    check(fwd > 0 and bwd > 0, "rec-train: the training path launched a bag kernel no time")
    check(fwd == bwd == REC_TRAIN_STEPS,
          f"rec-train: expected one forward and one backward bag launch a step, got {fwd} "
          f"and {bwd} over {REC_TRAIN_STEPS} steps")
    check(last < first, f"rec-train: the loss did not fall ({first:.4f} -> {last:.4f})")
    one = [next(data)]   # made before the profiled step: the host's batch is not in it
    busy = _busy_share(torch, lambda: tr.run(iter(one), max_steps=tr.step + 1, log_every=0),
                       "embedding_bag", top=12)
    log(f"rec-train: one step B={b_train} {busy}")
    roof = _step_roofline(torch, cfg.name, train_shape,
                          lambda: tr.run(iter(one), max_steps=tr.step + 1, log_every=0), med,
                          "rec-train")

    # the kernel route's gradient tree against the plain route's, bit for bit
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in rec_data.batch_for(cut, REC_TRAIN_CHECK_B, seed=seed + 3).items()}
    trees = {}
    for lookup in ("kernel", "plain"):
        before = (EB.launches, EB.bwd_launches)
        l_, _, g_ = value_and_grad(functools.partial(rec.loss_fn, cfg=cut, lookup=lookup),
                                   tr.params, batch)
        trees[lookup] = (l_.item(), g_, (EB.launches - before[0], EB.bwd_launches - before[1]))
    same = all(bool(torch.equal(a, b)) for a, b in zip(_leaves(trees["kernel"][1]),
                                                      _leaves(trees["plain"][1])))
    ok = (same and trees["kernel"][0] == trees["plain"][0]
          and trees["kernel"][2] == (1, 1) and trees["plain"][2] == (0, 0))
    log(f"rec-train: bfloat16 B={REC_TRAIN_CHECK_B}: loss and {len(list(_leaves(trees['plain'][1])))} "
        f"gradient leaves through the kernels == through the plain route (torch.equal): "
        f"{same}; loss {trees['kernel'][0]:.6f}; launches fwd/bwd kernel route "
        f"{trees['kernel'][2]}, plain route {trees['plain'][2]} {'ok' if ok else 'FAIL'}")
    check(ok, "rec-train: the kernel route's gradient tree differs from the plain route's")
    del trees, tr, data, batch
    torch.cuda.empty_cache()

    _reduced_on_card_vs_cpu(torch, cfg, seed, "rec-train")

    # the launcher itself on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *REC_TRAIN_CLI],
                          env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    log(f"rec-train: python -m repro_torch.launch.train {' '.join(REC_TRAIN_CLI)}: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.3f} s: {' | '.join(lines[-3:])}")
    check(proc.returncode == 0 and lines and lines[-1].startswith("final:")
          and lines[0].startswith(f"arch={cfg.name} family=recsys params="),
          f"rec-train: the launcher failed: {proc.stderr[-2000:]}")
    return {"launches": fwd, "bwd_launches": bwd, "step_ms": med, "peak": peak,
            "loss": (first, last), "roofline": roof}


# -------------------------------------------------------------- rec-family --

def _median_ms(torch, fn, n: int) -> float:
    """Median host ms of ``n`` calls, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def phase_rec_family(torch, seed: int) -> dict:
    """FM and DIN at full width in bfloat16 (weights from --seed, data from
    data/recsys.py): serve_step at serve_p99 and serve_bulk, retrieval_step
    over retrieval_cand's candidates, REC_FAMILY_TRAIN_STEPS Trainer + adamw
    steps at train_batch (finite losses); then reduced float32 on the card
    against the CPU."""
    import functools

    from repro_torch.configs import RECSYS_SHAPES, get_config
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    sizes = {s_.name: s_ for s_ in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    n_cand, b_train = sizes["retrieval_cand"].n_candidates, sizes["train_batch"].batch
    out = {}
    for arch in REC_FAMILY:
        cfg = get_config(arch)
        params = rec.init_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
        n_params = sum(t_.numel() for t_ in _leaves(params))
        res = {}
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            for name, b in (("serve_p99", p99), ("serve_bulk", bulk)):
                batch = _rec_batch(torch, rec_data.batch_for(cfg, b, seed=seed + 1))
                scores = rec.serve_step(params, batch, cfg)   # warm-up
                check(tuple(scores.shape) == (b,) and bool(torch.isfinite(scores).all()),
                      f"rec-family: {arch} {name} scores not finite (B,)")
                res[name] = _median_ms(torch, lambda: rec.serve_step(params, batch, cfg),
                                       REC_FAMILY_P99_STEPS if name == "serve_p99" else 3)
            rb = _rec_batch(torch, rec_data.retrieval_batch(cfg, n_cand, seed=seed + 2))
            cand = rec.retrieval_step(params, rb, cfg)
            check(cand.numel() == n_cand and bool(torch.isfinite(cand).all()),
                  f"rec-family: {arch} retrieval scores not finite ({n_cand})")
            res["retrieval_cand"] = _median_ms(torch, lambda: rec.retrieval_step(params, rb, cfg),
                                               3)
            del batch, scores, rb, cand
        serve_peak = torch.cuda.max_memory_allocated()
        tr = Trainer(functools.partial(rec.loss_fn, cfg=cfg),
                     adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, REC_FAMILY_TRAIN_STEPS)),
                     params)
        del params
        torch.cuda.reset_peak_memory_stats()
        tr.run(rec_data.batches(cfg, b_train, seed=0), max_steps=REC_FAMILY_TRAIN_STEPS,
               log_every=0)
        torch.cuda.synchronize()
        losses = [h["loss"] for h in tr.history]
        check(all(math.isfinite(x) for x in losses), f"rec-family: {arch} loss not finite")
        res["train_step"] = statistics.median(h["step_time_s"] * 1e3 for h in tr.history[1:])
        log(f"rec-family: {arch} {cfg.dtype} params={n_params:,} (embed_dim {cfg.embed_dim}): "
            f"serve_p99 B={p99} median {res['serve_p99']:.3f} ms, serve_bulk B={bulk} median "
            f"{res['serve_bulk']:.3f} ms ({bulk / res['serve_bulk'] * 1e3:.1f} examples/s), "
            f"retrieval_cand N={n_cand} median {res['retrieval_cand']:.3f} ms, peak "
            f"{serve_peak / 1e9:.3f} GB; train B={b_train} step median(2..) "
            f"{res['train_step']:.3f} ms ({b_train / res['train_step'] * 1e3:.1f} examples/s), "
            f"loss {' '.join(f'{x:.4f}' for x in losses)}, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del tr
        torch.cuda.empty_cache()
        _reduced_on_card_vs_cpu(torch, cfg, seed, "rec-family")
        out[arch] = res
    return out


# ---------------------------------------------------------------- bert4rec --

def _b4r_serving(cfg, batch: int, seed: int) -> dict:
    """The serving batch {"seq", "target"} of data/recsys.py's bert4rec
    batch: its sequences and its labels as targets, drawn with no negatives
    (they come after both from the generator, so the two are unchanged)."""
    import dataclasses

    from repro_torch.data import recsys as rec_data
    return _serving_batch(cfg, rec_data.batch_for(dataclasses.replace(cfg, n_negatives=0),
                                                  batch, seed=seed))


def phase_bert4rec(torch, seed: int) -> dict:
    """BERT4Rec at full width in bfloat16 (weights from --seed, data from
    data/recsys.py): serve_p99, serve_bulk in chunks of B4R_BULK_CHUNK,
    retrieval_cand, the bag kernel's launches counted (one a serve_step and
    a retrieval_step: the ids of a step go as one launch); the kernel route
    == the plain route at the timed shapes (a serve_p99 batch, a serve_bulk
    chunk, all the candidates; then the loss and every gradient leaf of a
    B4R_TRAIN_BATCH training batch); B4R_TRAIN_STEPS Trainer + adamw steps
    at B4R_TRAIN_BATCH with both bag counters counted (one forward and one
    backward launch a step), its peak under B4R_PEAK_CAP and twice the
    batch, by the bytes a row holds, past it; the step counted once more
    and read against its bound; reduced float32 on the card against the
    CPU."""
    import dataclasses
    import functools

    from repro_torch.configs import RECSYS_SHAPES, get_config
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer, value_and_grad

    sync = torch.cuda.synchronize
    cfg = get_config("bert4rec")
    sizes = {s_.name: s_ for s_ in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    n_cand, b_full = sizes["retrieval_cand"].n_candidates, sizes["train_batch"].batch
    t0 = time.perf_counter()
    params = rec.init_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t_.numel() for t_ in _leaves(params))
    v, d = params["emb"].shape
    p99_batches = [_rec_batch(torch, _b4r_serving(cfg, p99, seed + i))
                   for i in range(REC_FAMILY_P99_STEPS + 1)]
    n_chunks = bulk // B4R_BULK_CHUNK
    bulk_chunks = [_rec_batch(torch, _b4r_serving(cfg, B4R_BULK_CHUNK, seed + 100 + i))
                   for i in range(n_chunks)]
    ret_batch = _rec_batch(torch, rec_data.retrieval_batch(cfg, n_cand, seed=seed + 2))
    sync()
    log(f"bert4rec: cfg d={cfg.embed_dim} blocks={cfg.n_blocks} heads={cfg.n_heads} "
        f"seq={cfg.seq_len} items={cfg.n_items} {cfg.dtype}: params={n_params:,} (n_params() "
        f"{cfg.n_params():,}; the table padded to {v:,} rows, row {cfg.n_items} the [MASK] "
        f"token, {v * d * 2 / 1e6:.1f} MB); made with batches in "
        f"{time.perf_counter() - t0:.3f} s; serve_bulk's {bulk} rows as {n_chunks} calls of "
        f"{B4R_BULK_CHUNK} (one call would hold {bulk * cfg.n_heads * cfg.seq_len ** 2 * 4 / 1e9:.1f} "
        f"GB of float32 scores a block)")
    with torch.inference_mode():
        # warm-up at each shape
        rec.serve_step(params, p99_batches[-1], cfg)
        rec.serve_step(params, bulk_chunks[0], cfg)
        rec.retrieval_step(params, ret_batch, cfg)
        sync()
        torch.cuda.empty_cache()

        # ---- the serving path, counted ----
        EB.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        p99_s = []
        for batch in p99_batches[:REC_FAMILY_P99_STEPS]:
            t = time.perf_counter()
            scores = rec.serve_step(params, batch, cfg)
            sync()
            p99_s.append(time.perf_counter() - t)
            check(tuple(scores.shape) == (p99,) and bool(torch.isfinite(scores).all()),
                  "bert4rec: serve_p99 scores not finite (B,)")
        bulk_s = []
        for _ in range(REC_BULK_STEPS):
            t = time.perf_counter()
            outs = [rec.serve_step(params, c, cfg) for c in bulk_chunks]
            sync()
            bulk_s.append(time.perf_counter() - t)
        scores = torch.cat(outs)
        check(tuple(scores.shape) == (bulk,) and bool(torch.isfinite(scores).all()),
              "bert4rec: serve_bulk scores not finite (B,)")
        bulk_std = scores.std().item()
        ret_s = []
        for _ in range(REC_RETRIEVAL_STEPS):
            t = time.perf_counter()
            cand = rec.retrieval_step(params, ret_batch, cfg)
            sync()
            ret_s.append(time.perf_counter() - t)
        serve_launches = EB.launches
        # ---- end of the counted run ----
        serve_peak = torch.cuda.max_memory_allocated()
        check(tuple(cand.shape) == (1, n_cand) and bool(torch.isfinite(cand).all()),
              "bert4rec: retrieval scores not finite (1, N)")
        n_calls = REC_FAMILY_P99_STEPS + REC_BULK_STEPS * n_chunks + REC_RETRIEVAL_STEPS
        med_b, med_r = statistics.median(bulk_s), statistics.median(ret_s)
        log(f"bert4rec: serve_p99 B={p99}, {REC_FAMILY_P99_STEPS} steps: p50_ms="
            f"{_percentile(p99_s, 0.5) * 1e3:.3f} p99_ms={_percentile(p99_s, 0.99) * 1e3:.3f} "
            f"(min {min(p99_s) * 1e3:.3f}, max {max(p99_s) * 1e3:.3f})")
        log(f"bert4rec: serve_bulk B={bulk} ({n_chunks} x {B4R_BULK_CHUNK}): "
            f"{','.join(f'{x * 1e3:.3f}' for x in bulk_s)} ms, median {med_b * 1e3:.3f} ms, "
            f"{bulk / med_b:.1f} examples/s; scores std {bulk_std:.4f}")
        log(f"bert4rec: retrieval_cand 1 sequence x {n_cand} candidates: "
            f"{','.join(f'{x * 1e3:.3f}' for x in ret_s)} ms, median {med_r * 1e3:.3f} ms; "
            f"top candidate {int(cand.argmax())}; serving peak allocated "
            f"{serve_peak / 1e9:.3f} GB")
        log(f"bert4rec: embedding_bag launches={serve_launches} over {n_calls} serve_step and "
            f"retrieval_step calls")
        check(serve_launches > 0, "bert4rec: the serving path launched the bag kernel no time")
        check(serve_launches == n_calls, f"bert4rec: expected one bag launch a serve_step and a "
                                         f"retrieval_step, got {serve_launches} for {n_calls}")
        del outs, scores, cand
        torch.cuda.empty_cache()
        busy = _busy_share(torch, lambda: rec.serve_step(params, p99_batches[0], cfg),
                           "embedding_bag", top=8)
        log(f"bert4rec: serve_p99 B={p99} {busy}")

        # the kernel route against the plain route, serving, at the timed
        # shapes: a serve_p99 batch, a serve_bulk chunk, all the candidates
        for name, fn, batch in (
                (f"serve_step B={p99}", rec.serve_step, p99_batches[0]),
                (f"serve_step B={B4R_BULK_CHUNK} (a serve_bulk chunk)", rec.serve_step,
                 bulk_chunks[0]),
                (f"retrieval_step N={n_cand}", rec.retrieval_step, ret_batch)):
            got = fn(params, batch, cfg)
            want = fn(params, batch, cfg, lookup="plain")
            ok = bool(torch.isfinite(got).all()) and bool(torch.equal(got, want))
            log(f"bert4rec: {name} bfloat16 kernel == plain lookup (torch.equal): "
                f"{'ok' if ok else 'FAIL'} (max_abs_err {(got - want).abs().max().item():.3e})")
            check(ok, f"bert4rec: {name} through the kernel != through the plain lookup")
            del got, want
            torch.cuda.empty_cache()
        del p99_batches, bulk_chunks, ret_batch

    # training differentiates: outside inference_mode
    b_train = B4R_TRAIN_BATCH
    t0 = time.perf_counter()
    gen = rec_data.batches(cfg, b_train, seed=0)
    batches = [{k: torch.from_numpy(x).cuda() for k, x in next(gen).items()}
               for _ in range(B4R_TRAIN_STEPS + 1)]
    sync()
    batch_bytes = sum(t_.numel() * t_.element_size() for b_ in batches for t_ in b_.values())
    log(f"bert4rec: train B={b_train} (train_batch {b_full} cut to the largest power of two "
        f"whose step peaks under {B4R_PEAK_CAP / 1e9:.0f} GB), n_negatives {cfg.n_negatives}: "
        f"{B4R_TRAIN_STEPS + 1} batches ({batch_bytes / 1e9:.3f} GB) made and moved to the "
        f"card in {time.perf_counter() - t0:.3f} s")

    # the kernel route against the plain route on the first training batch:
    # the loss and every gradient leaf, the table's (the backward kernel on
    # this step's ids and cotangent) included; the kernel route's gradients
    # are kept, its activations freed before the plain route runs
    n_pos = sum(batches[0][k].numel() for k in ("seq", "label", "negatives"))
    trees = {}
    for lookup in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        before = (EB.launches, EB.bwd_launches)
        l_, _, g_ = value_and_grad(functools.partial(rec.loss_fn, cfg=cfg, lookup=lookup),
                                   params, batches[0])
        sync()
        trees[lookup] = (l_.item(), g_, (EB.launches - before[0], EB.bwd_launches - before[1]),
                         torch.cuda.max_memory_allocated())
        del l_, g_
        torch.cuda.empty_cache()
    kern, plain = trees["kernel"], trees["plain"]
    same = all(bool(torch.equal(a, b)) for a, b in zip(_leaves(kern[1]), _leaves(plain[1])))
    finite = all(bool(torch.isfinite(g_).all()) for g_ in _leaves(kern[1]))
    emb_err = (kern[1]["emb"].float() - plain[1]["emb"].float()).abs().max().item()
    ok = (same and finite and kern[0] == plain[0] and kern[2] == (1, 1)
          and plain[2] == (0, 0))
    log(f"bert4rec: bfloat16 loss_fn B={b_train} ({n_pos:,} positions over {v:,} rows at "
        f"d={d}): loss {kern[0]:.6f} and {len(list(_leaves(plain[1])))} gradient leaves, the "
        f"table's included (max_abs_err {emb_err:.3e}), through the kernels == through the "
        f"plain route (torch.equal): {same}; launches fwd/bwd kernel route {kern[2]}, plain "
        f"route {plain[2]}; peak allocated {kern[3] / 1e9:.3f} / {plain[3] / 1e9:.3f} GB "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "bert4rec: the kernel route's loss or gradients differ from the plain route's")
    del trees, kern, plain

    tr = Trainer(functools.partial(rec.loss_fn, cfg=cfg),
                 adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, B4R_TRAIN_STEPS)), params)
    del params
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    # ---- the training path, counted ----
    EB.reset_launches()
    EB.reset_bwd_launches()
    t0 = time.perf_counter()
    tr.run(iter(batches[:B4R_TRAIN_STEPS]), max_steps=B4R_TRAIN_STEPS, log_every=0)
    sync()
    train_s = time.perf_counter() - t0
    fwd, bwd = EB.launches, EB.bwd_launches
    # ---- end of the counted run ----
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    med = statistics.median(step_ms[1:])
    check(all(math.isfinite(x) for x in losses), "bert4rec: a training loss is not finite")
    log(f"bert4rec: {B4R_TRAIN_STEPS} steps of B={b_train} in {train_s:.3f} s; step_ms "
        f"first={step_ms[0]:.3f} median(2..{B4R_TRAIN_STEPS})={med:.3f} min={min(step_ms[1:]):.3f} "
        f"max={max(step_ms[1:]):.3f}; {b_train / med * 1e3:.1f} examples/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB")
    log(f"bert4rec: embedding_bag launches={fwd}, embedding_bag_bwd launches={bwd} over "
        f"{B4R_TRAIN_STEPS} steps")
    check(fwd > 0 and bwd > 0, "bert4rec: the training path launched a bag kernel no time")
    check(fwd == bwd == B4R_TRAIN_STEPS,
          f"bert4rec: expected one forward and one backward bag launch a step, got {fwd} and "
          f"{bwd} over {B4R_TRAIN_STEPS} steps")
    check(peak < B4R_PEAK_CAP, f"bert4rec: the step peaked at {peak / 1e9:.3f} GB, past "
                               f"{B4R_PEAK_CAP / 1e9:.0f} GB")
    # the next power of two: what the step adds to what was held before it
    # scales with the batch, and so do the batches; the rest (weights,
    # optimizer state) does not
    per_row = (peak - held + batch_bytes) / b_train
    twice = held - batch_bytes + 2 * b_train * per_row
    log(f"bert4rec: the step holds {per_row / 1e6:.3f} MB a row over the "
        f"{(held - batch_bytes) / 1e9:.3f} GB of weights and optimizer state held before it; "
        f"B={2 * b_train} would peak at about {twice / 1e9:.1f} GB, past {B4R_PEAK_CAP / 1e9:.0f} "
        f"GB: {'ok' if twice > B4R_PEAK_CAP else 'FAIL'}")
    check(twice > B4R_PEAK_CAP, f"bert4rec: B={2 * b_train} would peak at about "
                                f"{twice / 1e9:.1f} GB, under the cap: the training batch is "
                                f"not the largest power of two that fits")
    one = batches[-1:]
    busy = _busy_share(torch, lambda: tr.run(iter(one), max_steps=tr.step + 1, log_every=0),
                       "embedding_bag", top=12)
    log(f"bert4rec: one step B={b_train} {busy}")
    roof = _step_roofline(torch, cfg.name,
                          dataclasses.replace(sizes["train_batch"], batch=b_train),
                          lambda: tr.run(iter(one), max_steps=tr.step + 1, log_every=0), med,
                          "bert4rec")
    del tr, batches, one
    torch.cuda.empty_cache()
    _reduced_on_card_vs_cpu(torch, cfg, seed, "bert4rec")
    return {"launches": serve_launches + fwd, "bwd_launches": bwd, "step_ms": med,
            "peak": peak, "roofline": roof}


# --------------------------------------------------------------------- gnn --

def _gnn_steps(torch, cfg, params, batches, batched: bool, what: str):
    """GNN_TRAIN_STEPS Trainer + adamw steps over ``batches`` (tensors on
    the card): (step ms median of steps 2.., the first step's ms, losses,
    peak bytes, the trainer)."""
    import functools

    from repro_torch.models import gnn
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    tr = Trainer(functools.partial(gnn.loss_fn, cfg=cfg, batched=batched),
                 adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, GNN_TRAIN_STEPS)), params)
    torch.cuda.reset_peak_memory_stats()
    tr.run(iter(batches), max_steps=GNN_TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    check(len(losses) == GNN_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"gnn: {what}: a training loss is not finite")
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    return statistics.median(step_ms[1:]), step_ms[0], losses, peak, tr


def _gnn_reduced_on_card_vs_cpu(torch, cfg, seed: int) -> None:
    """reduced(meshgraphnet) in float32 for each aggregator: forward,
    forward_batched and loss_fn's value and every gradient leaf on the card
    against the CPU (index_add_ sums with float atomics on the card)."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs import reduced
    from repro_torch.data.graph import graph_batch
    from repro_torch.models import gnn
    from repro_torch.training.train_loop import value_and_grad

    for agg in ("sum", "mean", "max"):
        small = dataclasses.replace(reduced(cfg), aggregator=agg)
        cpu = gnn.init_gnn(small, torch.Generator().manual_seed(seed), 16, "cpu")
        card = gnn.params_from_numpy(cpu, "cuda")
        for batched, b in ((False, graph_batch(200, 800, 16, seed=seed)),
                           (True, graph_batch(30, 64, 16, seed=seed, n_graphs=8))):
            b["receivers"][..., :b["nodes"].shape[-2]] = np.arange(b["nodes"].shape[-2])
            keys = ("nodes", "edges", "senders", "receivers")
            f = gnn.forward_batched if batched else gnn.forward
            with torch.inference_mode():
                on_card = f(card, *[torch.from_numpy(b[k]).cuda() for k in keys], small).cpu()
                on_cpu = f(cpu, *[torch.from_numpy(b[k]) for k in keys], small)
            fwd_err = (on_card - on_cpu).abs().max().item()
            fwd_ok = bool(torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-5))
            loss = functools.partial(gnn.loss_fn, cfg=small, batched=batched)
            l_card, _, g_card = value_and_grad(loss, card, {k: torch.from_numpy(v).cuda()
                                                            for k, v in b.items()})
            l_cpu, _, g_cpu = value_and_grad(loss, cpu, {k: torch.from_numpy(v)
                                                         for k, v in b.items()})
            loss_rel = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
            close, worst = _grad_trees_close(torch, g_card, g_cpu)
            ok = fwd_ok and loss_rel <= REC_LOSS_REL and close
            log(f"gnn: {small.name} float32 {agg} {'forward_batched 8 x 30' if batched else 'forward 200'} "
                f"on the card == on the CPU: max_abs_err={fwd_err:.3e}; loss_fn rel "
                f"{loss_rel:.3e}; {len(list(_leaves(g_cpu)))} gradient leaves within rtol "
                f"{REC_GRAD_TOL['rtol']} atol {REC_GRAD_TOL['atol']}: {close} (max abs error "
                f"{worst:.3e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"gnn: {small.name} {agg} batched={batched}: the card disagrees with the "
                      f"CPU (forward {fwd_err}, loss rel {loss_rel}, worst leaf {worst})")


def phase_gnn(torch, seed: int) -> dict:
    """MeshGraphNet at full width (15 layers, d_hidden 128, bfloat16,
    remat) on the GNN_SHAPES one card holds: molecule through
    forward_batched, full_graph_sm, and minibatch_lg from the port's
    NeighborSampler over random_graph(232,965, 492) with features taken by
    node_ids from one seeded host matrix; GNN_TRAIN_STEPS Trainer + adamw
    steps each (finite losses, step ms, peak; the host's sampling apart from
    the card's step); reduced float32 on the card against the CPU.
    ogb_products is left out: its edge latents do not fit one card. Each
    shape's step is then counted once more under the port's counter and
    read against its bound (minibatch_lg at its sampled pads)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.data import graph as G
    from repro_torch.models import gnn

    cfg = get_config("meshgraphnet")
    shapes = {s_.name: s_ for s_ in GNN_SHAPES}
    gen = torch.Generator("cuda")
    out = {}

    def on_card(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in b.items()}

    def report(name, params, what, batches, batched, extra="", shape=None):
        n_params = sum(t_.numel() for t_ in _leaves(params))
        med, first, losses, peak, tr = _gnn_steps(torch, cfg, params, batches, batched, name)
        log(f"gnn: {name} ({what}) params={n_params:,} (n_params() "
            f"{cfg.n_params(batches[0]['nodes'].shape[-1]):,}): {GNN_TRAIN_STEPS} steps, "
            f"step_ms first={first:.3f} median(2..)={med:.3f}; loss "
            f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB{extra}")
        busy = _busy_share(torch, lambda: tr.run(iter(batches[-1:]), max_steps=tr.step + 1,
                                                 log_every=0), "indexFunc", top=6)
        log(f"gnn: {name} one step {busy}")
        roof = _step_roofline(torch, cfg.name, shape or shapes[name],
                              lambda: tr.run(iter(batches[-1:]), max_steps=tr.step + 1,
                                             log_every=0), med, f"gnn: {name}")
        out[name] = {"step_ms": med, "peak": peak, "roofline": roof}

    s_ = shapes["molecule"]
    batches = [on_card(G.graph_batch(s_.n_nodes, s_.n_edges, s_.d_feat, d_out=cfg.d_out,
                                     seed=seed + i, n_graphs=s_.n_graphs))
               for i in range(GNN_TRAIN_STEPS)]
    params = gnn.init_gnn(cfg, gen.manual_seed(seed), s_.d_feat, "cuda")
    report("molecule", params, f"{s_.n_graphs} graphs x {s_.n_nodes} nodes x {s_.n_edges} "
                               f"edges, d_feat {s_.d_feat}, forward_batched", batches, True)

    s_ = shapes["full_graph_sm"]
    batches = [on_card(G.graph_batch(s_.n_nodes, s_.n_edges, s_.d_feat, d_out=cfg.d_out,
                                     seed=seed + i))
               for i in range(GNN_TRAIN_STEPS)]
    params = gnn.init_gnn(cfg, gen.manual_seed(seed), s_.d_feat, "cuda")
    report("full_graph_sm", params, f"{s_.n_nodes} nodes, {s_.n_edges} edges, d_feat "
                                    f"{s_.d_feat}", batches, False)

    s_ = shapes["minibatch_lg"]
    t0 = time.perf_counter()
    graph = G.random_graph(s_.n_nodes, round(s_.n_edges / s_.n_nodes), seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((s_.n_nodes, s_.d_feat), dtype=np.float32)
    targets = rng.standard_normal((s_.n_nodes, cfg.d_out), dtype=np.float32)
    host_s = time.perf_counter() - t0
    sampler = G.NeighborSampler(graph, s_.fanout, seed=seed)
    # pads that hold every hop's full fanout, so the sampler truncates nothing
    hops = [s_.batch_nodes]
    for f in s_.fanout:
        hops.append(hops[-1] * f)
    pad_nodes, pad_edges = sum(hops), sum(hops[1:])
    batches, sample_s, sizes = [], [], []
    for i in range(GNN_TRAIN_STEPS):
        t0 = time.perf_counter()
        seeds = np.random.default_rng(seed + i).choice(s_.n_nodes, s_.batch_nodes, replace=False)
        sub = sampler.sample(seeds, pad_nodes, pad_edges)
        ids = sub["node_ids"]
        b = {"nodes": feats[ids], "targets": targets[ids], "node_mask": sub["node_mask"],
             "senders": sub["senders"], "receivers": sub["receivers"],
             "edges": rng.standard_normal((pad_edges, cfg.d_edge_in), dtype=np.float32)
             * sub["edge_mask"][:, None]}
        sample_s.append(time.perf_counter() - t0)
        sizes.append((int(sub["node_mask"].sum()), int(sub["edge_mask"].sum())))
        batches.append(on_card(b))
    check(all(n <= pad_nodes and e <= pad_edges for n, e in sizes),
          "gnn: minibatch_lg: a sample exceeds its pads")
    params = gnn.init_gnn(cfg, gen.manual_seed(seed), s_.d_feat, "cuda")
    report("minibatch_lg", params,
           f"NeighborSampler over random_graph({s_.n_nodes:,}, "
           f"{round(s_.n_edges / s_.n_nodes)}): {graph.n_edges:,} edges, "
           f"{graph.indices.nbytes / 1e6:.1f} MB of indices; {s_.batch_nodes} seeds, fanout "
           f"{s_.fanout}, pads {pad_nodes} nodes / {pad_edges} edges; d_feat {s_.d_feat}",
           batches, False,
           f"; host: graph, features and targets {host_s:.3f} s, each sample "
           f"{','.join(f'{x * 1e3:.1f}' for x in sample_s)} ms (median "
           f"{statistics.median(sample_s) * 1e3:.1f}), real nodes/edges "
           f"{' '.join(f'{n}/{e}' for n, e in sizes)}",
           # the step runs the sampled subgraph at its pads, not the whole graph
           dataclasses.replace(s_, n_nodes=pad_nodes, n_edges=pad_edges))
    out["minibatch_lg"]["sample_ms"] = statistics.median(sample_s) * 1e3
    s_ = shapes["ogb_products"]
    log(f"gnn: ogb_products ({s_.n_nodes:,} nodes, {s_.n_edges:,} edges) left out: one "
        f"(E, {cfg.d_hidden}) bf16 edge latent is {s_.n_edges * cfg.d_hidden * 2 / 1e9:.1f} GB "
        f"and the (E, {3 * cfg.d_hidden}) message input "
        f"{s_.n_edges * 3 * cfg.d_hidden * 2 / 1e9:.1f} GB, past one card even for a forward "
        f"pass; it waits for node and edge latents sharded over more than one card "
        f"(ROADMAP.md item 11: the rules and the planner are ported, multi-card cells "
        f"are not)")
    del batches, params, graph, feats, targets, sampler
    torch.cuda.empty_cache()
    _gnn_reduced_on_card_vs_cpu(torch, cfg, seed)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import dataclasses
    # inductor's and Triton's caches (the backends phase) inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    # inductor's notes on its softmax lowering, and torch.export's on loading
    # from a read-only buffer, once per compile or load
    warnings.filterwarnings("ignore", message=r"\s*Online softmax is disabled")
    warnings.filterwarnings("ignore", message="The given buffer is not writable")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import embedding_bag, flash_attention, sm_cnn_conv

    phases = {}
    t_all = time.perf_counter()
    t = time.perf_counter()
    dev = phase_device(torch)
    phases["device"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_build()
    phases["build"] = time.perf_counter() - t
    cfg = get_config("sm-cnn")
    t = time.perf_counter()
    kern = phase_kernel(torch, cfg)
    phases["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    pipe = phase_pipeline(torch, cfg, args.seed)
    phases["pipeline"] = time.perf_counter() - t
    world = pipe.pop("world")
    t = time.perf_counter()
    table1 = phase_backends(torch, cfg, world)
    phases["backends"] = time.perf_counter() - t
    t = time.perf_counter()
    service = phase_service(torch, cfg, world, table1)
    phases["service"] = time.perf_counter() - t
    t = time.perf_counter()
    launch = phase_launch(torch, cfg, world, service)
    phases["launch"] = time.perf_counter() - t
    del table1, world
    lm_cfg = get_config("qwen3-0.6b")
    with torch.inference_mode():
        t = time.perf_counter()
        attn = phase_attn_kernel(torch, lm_cfg)
        phases["attn-kernel"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_lm_check(torch, lm_cfg, args.seed)
        phases["lm-check"] = time.perf_counter() - t
        t = time.perf_counter()
        lm = phase_lm(torch, lm_cfg, args.seed)
        phases["lm"] = time.perf_counter() - t
        moe_cfg = get_config(MOE_ARCH)
        t = time.perf_counter()
        moe_check = phase_lm_moe_check(torch, moe_cfg, args.seed)
        phases["lm-moe-check"] = time.perf_counter() - t
        moe_runs = {}
        for name, arch, long_len, rows in MOE_LM_RUNS:
            t = time.perf_counter()
            moe_runs[name] = phase_lm(torch, get_config(arch), args.seed, name, long_len, rows)
            phases[name] = time.perf_counter() - t
        lm_moe, lm_moonshot = moe_runs["lm-moe"], moe_runs["lm-moonshot"]
        granite_cfg = get_config(GRANITE_ARCH)
        t = time.perf_counter()
        attn64 = phase_attn_d64(torch, granite_cfg)
        phases["attn-d64"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_lm_bf16_check(torch, granite_cfg, args.seed, "lm-granite-check")
        phases["lm-granite-check"] = time.perf_counter() - t
        t = time.perf_counter()
        lm_granite = phase_lm(torch, granite_cfg, args.seed, "lm-granite", LM_LONG, 0)
        phases["lm-granite"] = time.perf_counter() - t
        coder_cfg = get_config(CODER_ARCH)
        t = time.perf_counter()
        attn_g7 = phase_attn_g7(torch, coder_cfg, CODER_LONG)
        phases["attn-g7"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_lm_bf16_check(torch, coder_cfg, args.seed, "lm-coder-check")
        phases["lm-coder-check"] = time.perf_counter() - t
        t = time.perf_counter()
        lm_coder = phase_lm(torch, coder_cfg, args.seed, "lm-coder", CODER_LONG,
                            CODER_INT8_ROWS)
        phases["lm-coder"] = time.perf_counter() - t
    # training differentiates: outside inference_mode
    t = time.perf_counter()
    attn_bwd = phase_attn_bwd(torch, lm_cfg, granite_cfg, coder_cfg, moe_cfg)
    phases["attn-bwd"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_train = phase_lm_train(torch, lm_cfg, args.seed)
    phases["lm-train"] = time.perf_counter() - t
    t = time.perf_counter()
    granite_train = phase_lm_bf16_train(torch, granite_cfg, args.seed, "lm-granite-train",
                                        clis=(GRANITE_CLI,))
    phases["lm-granite-train"] = time.perf_counter() - t
    t = time.perf_counter()
    coder_train = phase_lm_bf16_train(torch, coder_cfg, args.seed, "lm-coder-train",
                                      CODER_TRAIN_LAYERS, CODER_CLIS)
    phases["lm-coder-train"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_train = phase_lm_bf16_train(torch, moe_cfg, args.seed, "lm-moe-train",
                                    MOE_TRAIN_LAYERS, MOE_CLIS)
    phases["lm-moe-train"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_a2a = phase_lm_moe_a2a(torch, moe_cfg, args.seed, lm_moe, moe_train)
    phases["lm-moe-a2a"] = time.perf_counter() - t
    with torch.inference_mode():
        rec_cfg = get_config("dlrm-mlperf")
        t = time.perf_counter()
        bag = phase_bag_kernel(torch, rec_cfg, args.seed)
        phases["bag-kernel"] = time.perf_counter() - t
        params = bag.pop("params")
        t = time.perf_counter()
        phase_rec_check(torch, rec_cfg, params, args.seed)
        phases["rec-check"] = time.perf_counter() - t
        t = time.perf_counter()
        rec = phase_rec(torch, rec_cfg, params, args.seed)
        phases["rec"] = time.perf_counter() - t
        t = time.perf_counter()
        planner_serve = phase_planner_serve(torch, rec_cfg, params, args.seed)
        phases["planner"] = time.perf_counter() - t
        del params   # the 48 GB serving table
        torch.cuda.empty_cache()
    # the planned training step differentiates: outside inference_mode
    t = time.perf_counter()
    planner = phase_planner(torch, args.seed, planner_serve)
    phases["planner"] += time.perf_counter() - t
    # recsys training differentiates: outside inference_mode
    t = time.perf_counter()
    bag_bwd = phase_bag_bwd(torch, rec_cfg, args.seed)
    phases["bag-bwd"] = time.perf_counter() - t
    t = time.perf_counter()
    rec_train = phase_rec_train(torch, rec_cfg, args.seed)
    phases["rec-train"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_rec_family(torch, args.seed)
    phases["rec-family"] = time.perf_counter() - t
    t = time.perf_counter()
    b4r = phase_bert4rec(torch, args.seed)
    phases["bert4rec"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_gnn(torch, args.seed)
    phases["gnn"] = time.perf_counter() - t
    for name, sec in phases.items():
        log(f"phase {name}: ok in {sec:.3f} s")
    log(f"total {time.perf_counter() - t_all:.3f} s on {dev['card']}")

    t32 = kern["timings"][(256, "float32")]
    tfa = attn["timings"][(LM_BATCH, LM_SEQ, "bfloat16")]
    tfa32 = attn["timings"][(LM_BATCH, LM_SEQ, "float32")]
    tg1 = moe_check["timing"]
    t64 = attn64["timings"][(LM_BATCH, LM_SEQ)]
    tg7, tg7_32 = attn_g7["timings"]["bfloat16"], attn_g7["timings"]["float32"]
    tbg = bag["timings"]["serve_bulk"]
    tbb = bag_bwd["timing"]
    tbw = attn_bwd["timings"][(TRAIN_B, TRAIN_S)]
    tb32 = attn_bwd["timings"][(*BWD_TIMED_F32, "float32")]
    tb64 = attn_bwd["timings"][(TRAIN_B, TRAIN_S, granite_cfg.d_head)]
    tbg7 = attn_bwd["timings"][(TRAIN_B, TRAIN_S, "g7")]
    tbg7_32 = attn_bwd["timings"][(*BWD_TIMED_F32, "float32_g7")]
    tbg1 = attn_bwd["timings"][(TRAIN_B, TRAIN_S, "g1")]
    tbg1_32 = attn_bwd["timings"][(*BWD_TIMED_F32, "float32_g1")]
    shape_g1_b4 = (f"B={TRAIN_B} S={TRAIN_S} H={moe_cfg.n_heads} Hkv={moe_cfg.n_kv_heads} "
                   f"d={moe_cfg.d_head}")
    line = {"kernels": [{
        "name": "conv_tanh_maxpool", "route": "cuda", "source": sm_cnn_conv.SOURCE,
        "replaces": sm_cnn_conv.REPLACES, "launches": pipe["launches"],
        "max_abs_err": kern["max_err"]["float32"], "ms": t32["kernel"],
        "plain_ms": t32["plain"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": t32["library"],
        "device_ms": t32["device_ms"],
        "launches_service": service["pallas"]["launches"],
        "launches_launch": launch["launches"],
        "design": kern["routes"]["float32"]["design"],
        "dtype": "float32", "shape": "B=256 S=64 d=50 w=5 F=100",
    }, {
        "name": "flash_attention", "route": "cuda", "source": flash_attention.SOURCE,
        "replaces": flash_attention.REPLACES, "launches": lm["launches"],
        "max_abs_err": attn["max_err"]["bfloat16"],
        "max_abs_err_float32": attn["max_err"]["float32"], "ms": tfa["kernel"],
        "ms_float32": tfa32["kernel"], "device_ms_float32": tfa32["device_ms"],
        "plain_ms_float32": tfa32["plain"], "library_ms_float32": tfa32["library"],
        "bound_ms_float32": tfa32["bound_ms"],
        "design_float32": attn["routes"]["float32"]["design"],
        "plain_ms": tfa["plain"], "bound_ms": tfa["bound_ms"],
        "bound_by": tfa["bound_by"], "library_ms": tfa["library"],
        "device_ms": tfa["device_ms"], "design": attn["routes"]["bfloat16"]["design"],
        "dtype": "bfloat16", "shape": f"B={LM_BATCH} S={LM_SEQ} H={lm_cfg.n_heads} "
                                      f"Hkv={lm_cfg.n_kv_heads} d={lm_cfg.d_head}",
        "launches_train": lm_train["launches"],
        "ms_with_lse_b4": tbw["fwd_lse"], "ms_without_lse_b4": tbw["fwd"],
        "plain_ms_with_lse_b4": tbw["fwd_lse_plain"],
        "library_ms_with_lse_b4": tbw["fwd_lse_library"],
        "lse_max_abs_err": attn_bwd["lse_err"]["bfloat16"],
        "launches_moe": lm_moe["launches"], "launches_moonshot": lm_moonshot["launches"],
        "max_abs_err_g1": moe_check["max_err"]["bfloat16"],
        "max_abs_err_g1_float32": moe_check["max_err"]["float32"],
        "ms_g1": tg1["kernel"], "device_ms_g1": tg1["device_ms"],
        "plain_ms_g1": tg1["plain"], "bound_ms_g1": tg1["bound_ms"],
        "library_ms_g1": tg1["library"],
        "shape_g1": f"B={LM_BATCH} S={LM_SEQ} H={moe_cfg.n_heads} Hkv={moe_cfg.n_kv_heads} "
                    f"d={moe_cfg.d_head}",
        "max_abs_err_d64": attn64["max_err"], "ms_d64": t64["kernel"],
        "device_ms_d64": t64["device_ms"], "plain_ms_d64": t64["plain"],
        "bound_ms_d64": t64["bound_ms"], "library_ms_d64": t64["library"],
        "shape_d64": f"B={LM_BATCH} S={LM_SEQ} H={granite_cfg.n_heads} "
                     f"Hkv={granite_cfg.n_kv_heads} d={granite_cfg.d_head}",
        "launches_granite": lm_granite["launches"],
        "launches_granite_train": granite_train["launches"],
        "ms_with_lse_d64_b4": tb64["fwd_lse"], "ms_without_lse_d64_b4": tb64["fwd"],
        "plain_ms_with_lse_d64_b4": tb64["fwd_lse_plain"],
        "library_ms_with_lse_d64_b4": tb64["fwd_lse_library"],
        "lse_max_abs_err_d64": attn_bwd["lse_err"]["bfloat16_d64"],
        "max_abs_err_g7": attn_g7["max_err"]["bfloat16"],
        "max_abs_err_g7_float32": attn_g7["max_err"]["float32"],
        "ms_g7": tg7["kernel"], "device_ms_g7": tg7["device_ms"],
        "plain_ms_g7": tg7["plain"], "bound_ms_g7": tg7["bound_ms"],
        "library_ms_g7": tg7["library"], "ms_g7_float32": tg7_32["kernel"],
        "device_ms_g7_float32": tg7_32["device_ms"], "plain_ms_g7_float32": tg7_32["plain"],
        "bound_ms_g7_float32": tg7_32["bound_ms"], "library_ms_g7_float32": tg7_32["library"],
        "shape_g7": f"B={LM_BATCH} S={LM_SEQ} H={coder_cfg.n_heads} "
                    f"Hkv={coder_cfg.n_kv_heads} d={coder_cfg.d_head}",
        "launches_coder": lm_coder["launches"],
        "launches_coder_train": coder_train["launches"],
        "ms_with_lse_g1_b4": tbg1["fwd_lse"], "device_ms_with_lse_g1_b4": tbg1["fwd_lse_device_ms"],
        "ms_without_lse_g1_b4": tbg1["fwd"], "plain_ms_with_lse_g1_b4": tbg1["fwd_lse_plain"],
        "library_ms_with_lse_g1_b4": tbg1["fwd_lse_library"],
        "bound_ms_with_lse_g1_b4": tbg1["fwd_lse_bound_ms"],
        "lse_max_abs_err_g1": attn_bwd["lse_err"]["bfloat16_g1"],
        "lse_max_abs_err_g1_float32": attn_bwd["lse_err"]["float32_g1"],
        "shape_g1_b4": shape_g1_b4, "launches_moe_train": moe_train["launches"],
        "launches_moe_a2a": moe_a2a["launches"],
        "launches_moe_a2a_train": moe_a2a["train_launches"][0],
        "launches_planner": planner["launches"][0],
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "source": flash_attention.BWD_SOURCE,
        "replaces": flash_attention.BWD_REPLACES,
        "gradient_of": flash_attention.REPLACES, "launches": lm_train["bwd_launches"],
        "max_abs_err": attn_bwd["max_err"]["bfloat16"],
        "max_abs_err_float32": attn_bwd["max_err"]["float32"], "ms": tbw["kernel"],
        "plain_ms": tbw["plain"], "bound_ms": tbw["bound_ms"],
        "bound_by": tbw["bound_by"], "library_ms": tbw["library"],
        "device_ms": tbw["device_ms"], "library_device_ms": tbw["library_device_ms"],
        "design": attn_bwd["routes"]["bfloat16"]["dkdv"]["design"],
        "ms_b8": attn_bwd["timings"][(8, TRAIN_S)]["kernel"],
        "ms_float32": tb32["kernel"], "plain_ms_float32": tb32["plain"],
        "library_ms_float32": tb32["library"], "bound_ms_float32": tb32["bound_ms"],
        "device_ms_float32": tb32["device_ms"],
        "library_device_ms_float32": tb32["library_device_ms"],
        "design_float32": attn_bwd["routes"]["float32"]["dkdv"]["design"],
        "dtype": "bfloat16", "shape": f"B={TRAIN_B} S={TRAIN_S} H={lm_cfg.n_heads} "
                                      f"Hkv={lm_cfg.n_kv_heads} d={lm_cfg.d_head}",
        "launches_granite_train": granite_train["bwd_launches"],
        "max_abs_err_d64": attn_bwd["max_err"]["bfloat16_d64"], "ms_d64": tb64["kernel"],
        "device_ms_d64": tb64["device_ms"], "plain_ms_d64": tb64["plain"],
        "bound_ms_d64": tb64["bound_ms"], "library_ms_d64": tb64["library"],
        "library_device_ms_d64": tb64["library_device_ms"],
        "ms_d64_b8": attn_bwd["timings"][(8, TRAIN_S, granite_cfg.d_head)]["kernel"],
        "shape_d64": f"B={TRAIN_B} S={TRAIN_S} H={granite_cfg.n_heads} "
                     f"Hkv={granite_cfg.n_kv_heads} d={granite_cfg.d_head}",
        "max_abs_err_g7": attn_bwd["max_err"]["bfloat16_g7"],
        "max_abs_err_g7_float32": attn_bwd["max_err"]["float32_g7"],
        "lse_max_abs_err_g7": attn_bwd["lse_err"]["bfloat16_g7"],
        "ms_g7": tbg7["kernel"], "device_ms_g7": tbg7["device_ms"],
        "plain_ms_g7": tbg7["plain"], "bound_ms_g7": tbg7["bound_ms"],
        "library_ms_g7": tbg7["library"], "library_device_ms_g7": tbg7["library_device_ms"],
        "ms_g7_float32": tbg7_32["kernel"], "device_ms_g7_float32": tbg7_32["device_ms"],
        "plain_ms_g7_float32": tbg7_32["plain"], "bound_ms_g7_float32": tbg7_32["bound_ms"],
        "library_ms_g7_float32": tbg7_32["library"],
        "shape_g7": f"B={TRAIN_B} S={TRAIN_S} H={coder_cfg.n_heads} "
                    f"Hkv={coder_cfg.n_kv_heads} d={coder_cfg.d_head}",
        "launches_coder_train": coder_train["bwd_launches"],
        "max_abs_err_g1": attn_bwd["max_err"]["bfloat16_g1"],
        "max_abs_err_g1_float32": attn_bwd["max_err"]["float32_g1"],
        "ms_g1": tbg1["kernel"], "device_ms_g1": tbg1["device_ms"],
        "plain_ms_g1": tbg1["plain"], "bound_ms_g1": tbg1["bound_ms"],
        "library_ms_g1": tbg1["library"], "library_device_ms_g1": tbg1["library_device_ms"],
        "ms_g1_float32": tbg1_32["kernel"], "device_ms_g1_float32": tbg1_32["device_ms"],
        "plain_ms_g1_float32": tbg1_32["plain"], "bound_ms_g1_float32": tbg1_32["bound_ms"],
        "library_ms_g1_float32": tbg1_32["library"], "shape_g1": shape_g1_b4,
        "launches_moe_train": moe_train["bwd_launches"],
        "launches_moe_a2a_train": moe_a2a["train_launches"][1],
        "launches_planner": planner["launches"][1],
    }, {
        "name": "embedding_bag", "route": "cuda", "source": embedding_bag.SOURCE,
        "replaces": embedding_bag.REPLACES, "launches": rec["launches"],
        "max_abs_err": bag["max_err"]["bfloat16"],
        "max_abs_err_float32": bag["max_err"]["float32"], "ms": tbg["kernel"],
        "plain_ms": tbg["plain"], "bound_ms": tbg["bound_ms"],
        "bound_by": tbg["bound_by"], "library_ms": tbg["library"],
        "device_ms": tbg["device_ms"], "launches_train": rec_train["launches"],
        "launches_bert4rec": b4r["launches"],
        "launches_planner": planner["serve"]["launches"],
        "dtype": "bfloat16", "shape": f"serve_bulk {tbg['shape']}",
    }, {
        "name": "embedding_bag_bwd", "route": "cuda", "source": embedding_bag.BWD_SOURCE,
        "replaces": embedding_bag.BWD_REPLACES, "gradient_of": embedding_bag.REPLACES,
        "launches": rec_train["bwd_launches"], "max_abs_err": bag_bwd["max_err"]["bfloat16"],
        "max_abs_err_float32": bag_bwd["max_err"]["float32"], "ms": tbb["kernel"],
        "plain_ms": tbb["plain"], "bound_ms": tbb["bound_ms"], "bound_by": tbb["bound_by"],
        "library_ms": tbb["library"], "device_ms": tbb["device_ms"], "sort_ms": tbb["sort"],
        "launches_bert4rec_train": b4r["bwd_launches"],
        "dtype": "bfloat16", "shape": f"training lookup {tbb['shape']}",
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
