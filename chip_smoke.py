#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line:

1. card     — nvidia-smi's name and power limit, torch and CUDA versions.
2. build    — nvcc builds the CUDA kernels (paged attention, rmsnorm
              forward, pair and backward, matmul, LoRA shrink, expand and
              fused delta, selective scan, flash attention forward and
              backward) from the repo's sources for sm_90a, one nvcc process
              per source, all started together, and prints ptxas's register
              and spill lines (rmsnorm's also in its kernel lines).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes its path gives it (f32 and bf16), row by row
              (``ref.row_rel_err``), and planted faults that the same gate
              must reject; device times (calls captured in a CUDA graph and
              replayed between CUDA events) of the kernel, the plain version
              and one PyTorch library call that computes the same function
              (a yardstick the port never calls), the kernel wrapper's
              host-inclusive time, and the least time the card could take
              (bytes moved over 3.35 TB/s or operations over the type's peak
              rate).  Paged attention runs at the four head layouts that
              serve (qwen3-0.6b: 16 heads over 8 KV heads, head_dim 128;
              zamba2's shared block: 32 heads over 32, head_dim 80;
              olmoe-1b-7b: 16 over 16, head_dim 128; llama4-maverick: 40
              over 8, head_dim 128; a rank's half of qwen3-0.6b's on a
              2-rank serve mesh: 8 over 4; a rank's half of olmoe-1b-7b's
              on it: 8 over 8), through the
              model-facing ``ops`` entries.  K1 and K4 rows also hold two
              launches bitwise equal, each decode row run alone bitwise
              equal to its row of the batch, a planted fault of each
              redesign (a middle split, a middle K slice dropped) failing
              the gate, and ``sass_mma`` (> 0 in the bf16 GEMM and chunk
              kernels, 0 in the f32 ones); gate-only rows take K1 to its
              split boundaries (spans 511 to 2,048), a group of 8, block
              size 5 at head_dim 40 and ragged chunks, and K4 to K or N
              not a multiple of 8 and K = 0.  The LoRA kernels run at the
              serve path's shapes (T = 8 decode rows and a 256-row prefill
              chunk, every projection's widths, rank 16, 8 slots, block_out
              128) under four per-row slot mixes and the engine's chunk (one
              sequence of 256 rows, with and without an adapter); K5 and K6
              base rows must be exact zeros and the expand output bitwise
              the same for block_out 33, 128 and 256.  The fused delta
              (K5 then K6 plus the base, one launch) runs at the seven
              projections' width pairs: the row gate with three planted
              faults (slot 0, one d-slice of its cluster sum dropped, the
              last output tile unwritten), bitwise equal to K5 then K6 plus
              the base, base rows bitwise base + 0, bitwise across three
              tiles, a relaunch and each sequence alone; K5 and the delta
              carry ``sass_mma`` (> 0 on the bf16 chunk's tensor-core
              tile).  Their yardstick is ``torch.bmm`` over per-row factors
              gathered before the call (for the delta, bmm then baddbmm).
              The selective scan (K7) runs at the ssm path's shapes (a
              decode step of 8 rows, a 256-step prefill chunk, a 300-step
              prefill, d_inner 8,192, state 16): the fused entries the
              Mamba1 layers call (the discretisation a = exp(dt A),
              b = (dt B) x inside the kernel; B, C and x bf16) and the
              unfused ones (a and b f32 from memory, the TPU kernel's
              interface; gate-only): y and h_last row by row, two launches
              bitwise, one launch bitwise equal to the engine's split into
              chunks of 256 (state carried, masked or identity-padded
              tail), and three planted faults (h0 ignored, the last step
              dropped, one tile of d unwritten); the fused rows also record
              whether they give the unfused path's bits and time that path
              beside the kernel; it has no library call.  At the training
              shape (B 8 x T 512) the fused forward with checkpoints and
              the fused backward (d(dt), dA, dB, dC, dx, dh0) in bf16,
              timed, and in f32 with planted faults in each of its
              reductions (a lane of d(dt), a batch row of dA, a block of
              dB, dh_last ignored); the unfused backward's gates stay.  rmsnorm (K2) runs at
              qwen3-0.6b's serve rows, the ssm and hybrid widths (4,096,
              2,560 and the gated norm's 5,120), olmoe-1b-7b's (2,048)
              and llama4-maverick's (4 x 5,120) at decode and prefill-chunk
              rows, and at the training step's
              rows (4,096 x 1,024, the q norms' 65,536 x 128 and the k
              norms' 32,768 x 128; the backward also at the stateful
              families' 4,096 x 4,096, 2,560 and 5,120 and olmoe's 4,096 x
              2,048): each row
              bitwise across two launches, sample rows alone and the first
              8 rows bitwise their rows in the batch, a planted fault (tail
              columns zeroed); ``ops_host_ms`` beside the wrapper's
              ``host_ms`` (the no-Function path the serve engine takes) and
              RMSNormFn's.  The pair (q and k norms in one launch) at
              qwen's decode, chunk and training q/k rows and olmoe's decode
              and chunk rows (16 + 16 heads), each output
              bitwise its single launch, timed beside two single launches.
              The backward (row pass and column pass) at the training
              rows: dx and dw against the plain backward, with planted
              faults (g's rows shifted, the last quarter of the rows out of
              dw, one row block out of the column sum, dx without its mean
              term; the last two in f32 only at the stateful widths, whose
              4-row blocks move dw by too little for the bf16 limit), two
              launches bitwise equal; its yardstick is autograd
              of ``F.rms_norm``, forward + backward less forward.  K2's
              narrow mode (REPRO_NORM_F32=0: the mean, rstd and each
              product rounded to bf16, the sums in f32, as the reference
              computes rms_norm in the activation dtype) at bf16: the
              forward at qwen's and olmoe's serve rows and qwen's training
              row, the pair at qwen's decode q/k rows and the backward at
              the training rows, each against the narrow plain version
              with planted faults, timed; gate rows (no path runs the
              mode: the knob's default is 1).  Flash
              attention (K3) at the training step's shape (B 8 x 16 query
              heads over 8 KV heads, read grouped by the kernel, S 512,
              head_dim 128, causal; f32 and bf16), at zamba2-2.7b's (B 8 x
              32 heads over 32, head_dim 80) and at olmoe-1b-7b's (B 8 x 16
              heads over 16, head_dim 128): o, lse, dq, dk and
              dv row by row (gradient rows floored at 1e-2 of the largest
              and held to 1e-4 in f32, ``ref.GRAD_ROW_FLOOR`` and
              ``GRAD_ROW_TOL``), two launches bitwise equal, planted
              faults (a kv tile dropped, the causal mask flipped, dO rows
              zeroed, lse shifted, D from a zero O); its yardstick is SDPA
              (with ``enable_gqa``), forward and backward, both from graph
              replay.  Each K3 row carries ``sass_mma``, the tensor-core
              instructions ``cuobjdump -sass`` finds in its kernels: bf16
              must have them, f32 must have none.  A
              ``flash_attention_grad_witness`` line holds the f32 kernel and
              the f32 plain versions each against the plain versions in f64
              at the training shape.  The same gates, untimed, non-causal,
              with q_offset (128 queries after 512 keys), ragged (S 300),
              at head_dim 256, at head_dim 80 (zamba2's shared block, 32
              heads over 32), with 8 query heads a KV head, and at head_dim
              40 (ragged, q_offset 3).
4. compile  — ``repro_torch.pipeline.compile()`` with the H100 record on the
              serve engine's full-width decode attention term, a full-width
              qwen3-0.6b SwiGLU MLP term (not vectorized, so its products stay
              logical) and the prefill-chunk term (default options: the packed
              path); bf16 inputs on the card, each compiled program against
              the same term compiled with kernels off (or evaluated plainly),
              with the matmul kernel's launches counted; each report's
              summary, the H100 kernel plan and the engine's pages_per_fetch.
5. serve    — the port's ServeEngine (kernel planning on, the default)
              serves 16 requests of full-width qwen3-0.6b in bf16 (random
              weights from seed 0); every kernel's launch count is zeroed
              just before and read just after: K2 launches exactly 85 times
              a model call (ln1, ln2 and the q/k pair a layer, the final
              norm).  A short greedy run with planning off must give the
              same tokens as one with it on.
   lora     — the same engine with four synthesized tenants loaded serves the
              same 16 requests, every fifth one base and the others spread
              over the tenants: every request finishes, the invariants hold
              after every step, the adapter slab is the size its shape gives,
              the fused LoRA kernel launches exactly once per adapted
              projection and layer of every dispatch that holds an adapter
              row (K5 and K6 never alone), and the host time of a dispatch
              stands beside the serve phase's.
   lora_identity — greedy tokens: base requests on an engine with tenants
              loaded and pinned equal an adapter-free engine's (with no LoRA
              launch), a rank-0 tenant gives the base tokens, and one prompt
              under two tenants gives two streams, neither adopting the
              other's prefix.
   profile  — torch.profiler over 12 steps of a second engine at 14 of the
              28 layers (full depth until the examples phase needed the
              time): device busy
              time by kernel against the window's wall time, and each
              kernel's device time per launch on the main path (device
              events only; an MoE arch's profiles also record the CPU ops,
              to tell its expert products apart).
   serve_mesh — right after the serve phase, the same workload through an
              engine on a 1-rank NCCL serve mesh (``launch.mesh.
              process_group``, ``make_serve_mesh``) with tensor-parallel
              weights gathered at every use: the serve phase's tokens
              exactly, K1 28 and K2 85 launches a model call.
   serve_mesh_2 — two ranks spawned on the one card over gloo (NCCL
              refuses two ranks on one GPU; gloo stages every collective
              through host memory), full width at 4 of 28 layers, 8
              requests of the serve workload cut to 256 prompt tokens, 16
              new: the KV pool sharded on kv-heads (4 of 8 a rank) with
              TP identity gives a plain engine's tokens on the same
              weights, each rank's K1 and K2 launch 4 and 13 times a model
              call, each rank's param bytes and peak memory; reduce-scatter
              prefill logits of a 256-token chunk within 5e-2 of the
              replicated forward's largest, with the greedy agreement; one
              swap preemption on the sharded pool equal to each request
              alone.  A rank that raises or outlasts its time fails the
              phase.
   moe_mesh_2 — in the same group of two ranks: olmoe-1b-7b at full
              width, 2 of 16 layers, through a KV-only mesh engine (8 of
              16 heads a rank, the weights replicated) on the same
              workload: a plain engine's tokens, K1 2 and K2 7 launches a
              model call a rank; the TP layout (the expert stacks split
              inside each expert) on one 256-token chunk, identity mode
              bitwise the replicated forward, reduce-scatter on the
              replicated forward's expert picks within 5e-2 on the chunk
              and one decode step of 8 rows after it, and on its own
              picks with the greedy agreement and the flipped expert sets
              counted; each rank's param bytes and peak memory.
   gateway_mesh_2 — in the same group: rank 0 runs the gateway over a
              router of both models (qwen at 4 layers, olmoe at 2) on the
              2-rank mesh, one stepper thread each under the engine's mesh
              lock, rank 1 follows both; 8 streams over HTTP, 4 a model,
              one closed by its client; a ``step`` fault seeded alike on
              both ranks' olmoe engines quarantines the same request on
              both; every finished stream equals a plain engine's tokens;
              stopping the gateway releases rank 1.
   train_mesh_2 — in the same group: qwen3-0.6b at full width, 2 of 28
              layers, f32, B 8 x S 512, trained through ``Trainer(mesh=)``
              on ``TrainMesh``es of the two ranks: 2x1 under fsdp_tp (2
              steps), again under REPRO_WEIGHT_AG=1 (1 step, the first
              run's bits after its first step) and with a failure at
              step 1 (the first run's bits); 1x2 (K3 at 8 heads over 4
              a rank) under fsdp_tp (2 steps) and REPRO_SEQ_PARALLEL=1 (1
              step); 2x1 under dp (1 step, ZeRO-1 moments).  Each run's
              losses and gradient norms within 1e-4 and leaves within 1e-3
              of one device's Trainer (the ranks train those oracles
              between them); a rank's param and moment bytes half of the
              whole apart from the leaves no axis splits; K3 and K2 launches a step a
              rank; collectives, peak memory and seconds a rank.  The
              kernel rows gain K3 at 8 heads over 4 and K2 at a rank's
              rows (2,048 x 1,024; the q/k pair at 32,768 + 16,384 rows,
              2,048 x 16 + 8 heads at 2x1 and 4,096 x 8 + 4 at 1x2),
              forward and backward.  Then (``FAMILY_MESH_RUNS``, a
              ``train_mesh_2_families`` line) the stateful and
              encoder-decoder families at full width in f32, B 2, 1
              step each: falcon-mamba-7b at 1 layer (S 512) on 1x2
              (K7 over a rank's 4,096 of 8,192 channels) and with int8
              moments on 2x1; zamba2-2.7b at 2 segments of 1 Mamba2
              layer (the shared block at two call sites) on 1x2 (40 SSD
              heads and 16 over 16 attention heads a rank); whisper-small
              at 2 + 2 layers (S 448) on 2x1 and 1x2 (6 over 6 heads a
              rank).  Each against one device's run (trained by the
              ranks between them): losses and gradient norms within
              1e-4, the first step's gradient leaves and the weights
              within 1e-3 (zamba2's gradient leaves within the limit
              train_hybrid_oracle sets in the same call, checked after
              it, ``train_mesh_2_hybrid_gate``, its weights reported:
              AdamW's first step makes a gradient near zero a step of
              about lr; the int8 run's weights reported, its moments
              within one quantization step of one device's instead, since
              a v stored as 0 divides m by eps, C0);
              K7, K3 and K2 launches a step a rank as one device's step
              at that depth; collectives a step by kind and bytes, peak
              memory and seconds a rank.  The kernel rows gain K7's
              fused forward and backward at a rank's D 4,096 (B 8 x T
              512, timed) and K3 at a rank's 16 over 16 heads, head_dim
              80, and 6 over 6, head_dim 64 (S 448, causal and not),
              timed.
   dryrun_mesh — the dry run (``launch.dryrun``: a ``DryTrainMesh`` on
              meta, no process) of one step of train_mesh_2's qwen runs
              on 2x1 and 1x2 and its falcon-mamba run on 1x2 gives each
              rank's collectives a step (calls and bytes, by kind) exactly
              as its ``TrainMesh.issued`` (less the whole-weight gathers
              the oracle checks add).
6. oracle   — teacher-forced logits of the paged path (kernels) against the
              dense prefill + decode path (plain attention), f32 and bf16;
              and one tenant's request (a 256-token prompt chunk and 8 decode
              steps, full width, 2 layers, f32) through the paged path with
              the kernels on the card against the same path with the plain
              versions on the CPU.
7. ssm_serve, hybrid_serve — the serve workload through full-width
              falcon-mamba-7b and zamba2-2.7b in bf16 (random weights from
              seed 0): every request finishes, the invariants hold after
              every step, the state slab is empty at the end, the
              attention-free engine allocates no KV block, and each dispatch
              launches K7 once per Mamba1 layer (64, ssm) or never (hybrid)
              and K1 once per shared-block call site (9, hybrid) or never
              (ssm).  ssm_swap_resume: a greedy request preempted by swap
              resumes from the slab's host tier with the unpreempted run's
              tokens.  ssm_profile, hybrid_profile: a profiled window each,
              at half depth (32 of 64 layers; 4 of 9 segments).
8. ssm_oracle, hybrid_oracle — one request (a 256-token prompt chunk and 8
              decode steps, full width, f32; 2 Mamba1 layers, or 2 hybrid
              segments) through the paged path with the kernels on the card
              against the same path with the plain versions on the CPU;
              then the same tokens through the dense path (plain attention,
              no K1) on the card against the CPU.
9. gateway  — the OpenAI-compatible gateway in-process on port 0 (random
              weights from seed 0, bf16, the serve engine's settings): a
              ``Router`` of two engines on their own stepper threads,
              full-width qwen3-0.6b (adapters t0 and t1 declared, loaded on
              first use) and full-width falcon-mamba-7b at 16 of its 64
              layers (a cut for the script's time).  ``/health`` and
              ``/v1/models``; 16 streamed ``/v1/completions`` of the serve
              workload to qwen (every fourth to ``:t0`` or ``:t1``; one
              client closes its socket after 6 tokens) and 4 to
              falcon-mamba at once over real HTTP, and an adapter ask to
              falcon-mamba that must be refused.  Every stream passes
              ``tools.gateway_smoke_torch.check_sse`` and ends ``length``,
              its tokens equal a fresh engine's ``run_until_done`` on the
              same weights (the closed one's, a prefix), the cancel frees
              blocks the call it lands, both pools drain to zero with the
              invariants clean, and K1, K2, the fused delta and K7 launch
              exactly what the dispatches imply (28 / 85 a qwen call, 196 an
              adapter dispatch, 16 K7 and 17 K2 a falcon-mamba call);
              TTFT, inter-token latency and host ms a dispatch.
   gateway_open_loop — qwen3-0.6b alone: 32 requests of the serve workload
              as Poisson arrivals at 2 a second; every stream ``length``
              with 32 tokens, no block left; TTFT and inter-token latency
              percentiles, delivered tokens/s, wall time.
   gateway_chaos — ``tools.chaos_smoke_torch.run_chaos`` on full-width
              qwen3-0.6b under alloc faults (p 0.1) and a step fault every
              second check: every stream terminal, the faults fired, no
              block leaked on either tier, survivors equal the fault-free
              oracle.  Each gateway line carries the card's name and power
              limit and the phase's seconds.
10. train   — full-width qwen3-0.6b in bf16 through ``Trainer`` (B 8 x S
              512, 10 steps, AdamW as the train CLI builds it, remat on):
              losses finite and falling, step seconds, tokens/s without step
              0, peak memory, and exactly 56 K3 forward, 28 K3 backward,
              169 K2 forward launches and 85 K2 backward calls a step (no
              serve kernel).  train_mesh: its first 3 steps through
              ``Trainer(mesh=make_train_mesh(1, 1))`` on a 1-rank NCCL
              group, the "world" collectives over one NCCL rank (the
              one-rank axes run none): the same losses and gradient
              norms bit for bit and launches a step, with the
              collectives a step by kind and bytes, tokens/s and peak
              memory.  train_int8: three
              steps with int8 moments, finite and falling.  train_restart:
              2 layers at full width, 8 steps checkpointed every 4, a failure
              at step 6; the final loss equals a clean run's bit for bit.
              train_oracle: 2 layers at full width, f32, loss and every
              gradient leaf on the card against the CPU's plain versions
              (1e-4 relative, 1e-3 of each leaf's largest value), and remat
              off / dots / nothing agreeing on the card.  train_remat: four
              full-width steps under each REPRO_REMAT_POLICY, step time and
              peak memory.  train_profile:
              torch.profiler over 3 steps at 14 of 28 layers, busy time by
              group and the idle share.
11. train_ssm, train_hybrid — full-width falcon-mamba-7b (int8 moments)
              and zamba2-2.7b (f32 moments) in bf16 through ``Trainer`` (B 8
              x S 512, 5 steps, remat on): losses finite and falling (for
              falcon-mamba on a second run at 16 layers with f32 moments:
              its 64-layer int8 run rises, reported), step
              seconds, tokens/s without step 0, peak memory, and exactly
              128 K7 forward and 64 K7 backward launches with 129 / 65 of
              K2 a step (ssm), 18 / 9 of K3 at head_dim 80 with 253 / 127
              of K2 (hybrid).  train_ssm_profile, train_hybrid_profile: 2
              profiled steps each at half depth (32 of 64 layers; 4 of 9
              segments), K7's share of the busy time.
              train_ssm_oracle, train_hybrid_oracle: 1 Mamba1 layer / 1
              hybrid segment of 2 Mamba2 layers (2 layers, and 3, until the
              examples phase needed the time; 2 segments of 6 until the
              dry run's phases did) at full width, f32, B 2 x
              S 512, the loss and
              every gradient leaf on the card against the CPU's, within
              1e-4 / 1e-3, or for the hybrid twice the CPU's own spread
              between two thread counts where that is wider (falcon-mamba
              runs no witness: its spread, under 1e-6 of a leaf, lies far
              below 1e-3, so the witness could only loosen its limit, and
              the script needed the time); then a restart, bitwise, at
              1 layer / 1 segment (its bits do not depend on a second
              layer or the shared block's second call, and the script
              needed the time: with both hybrid runs at 2 segments it took
              1,008 s), 4 steps checkpointed every 2 with the failure at
              step 3 (8 until train_mesh_2's family runs and 6 until the
              dry run's phases needed the time).
12. moe     — moe_serve: the serve workload through full-width olmoe-1b-7b
              (16 layers, d 2048, 16/16 heads, 64 experts, top-8; 13.84 GB)
              in bf16 at its native capacity factor 2.0: the invariants
              after every step, K1 16 and K2 49 launches a model call
              exactly, host ms a dispatch; moe_profile: a profiled window
              of 3 steps at 8 of the 16 layers, the expert products
              (``aten::bmm``) a group of their own.
              moe_lora: two rank-16 tenants on the attention projections,
              64 fused-delta launches an adapter dispatch, a rank-0 tenant
              bitwise base.  moe_oracle: paged (K1) against dense at the
              factor where no token drops (capacity >= tokens), every
              step's (layer, token) expert sets compared between the
              paths: f32 (at 8 of the 16 layers) within 1e-3 with no set
              differing; bf16, where
              the paths' roundings move tokens across routing boundaries,
              the paged path run again with the dense path's expert
              choices (its own router and gates) within 5e-2 on every
              step, the free run within it on every step whose sets all
              agree (at least 4 such steps), and its differing sets at
              most twice those between the dense path in bf16 and in f32
              on the same weights and tokens (the witness of rounding).
              moe_cpu_oracle: 2 layers, f32, native factor, card against
              CPU, paged and dense paths, 1e-3.  llama4_layer: one
              super-layer of llama4-maverick-400b-a17b at full width (a
              dense layer of d_ff 16,384 and an MoE layer of 128 experts,
              top-1, with a shared expert; d 5120, 40/8 heads, vocab
              202,048; 37.36 GB, drawn on the card): 4 requests, 8 new
              tokens, K1 2 and K2 5 a model call, and the paged bf16 gap
              against the dense oracle at the no-drop factor under
              moe_oracle's bf16 gates but the witness (its f32 weights
              would not fit).
              train_moe: olmoe in bf16 through ``Trainer`` (B 8 x S 512, 5
              steps, int8 moments: f32 ones leave about 2 GB of the card):
              finite losses, exactly 32 / 16 K3 and 97 / 49 K2 a step;
              its loss falls at 8 layers with f32 moments;
              train_moe_profile (1 step, 8 of 16 layers);
              train_moe_oracle: 1 layer (2 until the examples phase
              needed the time), f32, loss and every leaf (the
              routers' reported apart)
              against the CPU within 1e-4 / 1e-3, then a bitwise restart
              at 1 layer (4 steps, the failure at step 3).
13. encdec, vlm — the families the paged engine refuses (as the
              reference's does), through ``launch.steps``' prefill and
              decode step builders over a dense cache.  whisper_serve:
              whisper-small (12 + 12 layers, d 768, vocab 51,865) in bf16,
              8 requests of 1,500 stub frames, a 4-token prompt and 64
              greedy new tokens, the prefill cache placed into a
              ``make_encdec_cache(8, 1500)``: K3 36 and K2 62 launches a
              prefill call, 0 and 37 a decode step, every 8th step's
              logits within 5e-2 of a fresh prefill's; whisper_oracle: 2 +
              2 layers f32, card against CPU, prefill and 8 decode steps
              within 1e-3.  train_whisper: ``Trainer`` at B 8 x S 448
              (frames and tokens), f32 moments, 5 steps, losses falling,
              72 / 36 K3 and 122 / 62 K2 a step; then at 2 + 2 layers the
              loss and every leaf against the CPU (1e-4 / 1e-3) and a
              bitwise restart.  vlm_serve: qwen2-vl-72b at full width and
              16 of its 80 layers (33.1 GB), two batches of 8 requests, an
              image of 16 x 16 patch embeddings with distinct (t, h, w)
              M-RoPE streams then 256 or 768 text positions, 32 greedy
              tokens fed back as embedding rows: K2 33 launches a model
              call and nothing else, every 8th step against a fresh
              prefill within 5e-2.  train_vlm: 2 layers at full width
              (4.25 B parameters, f32 moments: 51.0 GB reckoned), B 8 x S
              512, 5 steps at a peak rate of 3e-5, K3 4 / 2 and K2 9 / 5 a
              step, losses falling;
              then one remat loss and backward at distinct streams (the
              same launches, a finite loss unlike the equal streams').
              The kernel rows gain K3 at whisper's training shape (12
              over 12 heads, S 448, hd 64, causal and not), its
              encoder's serve shape (1,500 frames, forward), the
              cross-attention's 4 and 448 queries over 1,500 frames
              (gate-only) and qwen2-vl's (64 over 8 heads, S 512), and
              K2 at 768 and 8,192 (forward and backward).
14. examples — after train_profile, the port's four examples
              (``examples/*_torch.py``) through their own entry points at
              full width on the card, their prints kept off the output,
              each with its launch counts from zero: quickstart (the
              packed Fig. 3 program within 1e-4 of its logical term, whose
              two matmuls launch K4; the recompile a cache hit; the loss
              of qwen3-0.6b in bf16 finite, K3 28 and K2 85 launches),
              serve_lm (qwen3-0.6b in bf16, its eight requests each
              finished with 12 tokens, the KV invariants clean, K1 28 and
              K2 85 launches a model call), train_lm (qwen3-0.6b at 2 of
              28 layers, 36 steps, the failure at step 24 after the step-20
              checkpoint, the restore and replay, the last loss below the
              first, K3 and K2 a step's launches for every step run) and
              compile_inspect (qwen3-0.6b's decode_32k cell on pod1 counted
              on meta in the process); each example's seconds and the
              phase's, with the card's name and power limit.

The dry run (ROADMAP A13a): ``dryrun_calib`` after train: qwen3-0.6b's
train step at its shape (B 8 x S 512, 28 layers, bf16, remat "dots")
counted twice, by the dry run on a 1x1 virtual mesh on meta and by
``hlo_analysis.analyze_step`` over one more step of the train phase's
Trainer on the card (not timed): FLOPs equal exactly, K2 and K3 launches
equal (the hooks' count equal to the wrappers' counters: 169 + 85 K2, 56 +
28 K3), the dry run's peak above its arguments within ``CALIB_PEAK`` of
the step's ``max_memory_allocated`` rise, and the roofline's step time
beside the train phase's measured step seconds.  Its prefill and decode
steps (A13b): ``dryrun_serve_calib`` after train_mesh: qwen3-0.6b at full
depth in bf16, a prefill at prefill_32k's batch a device on pod1 (B 2 x
S 32,768) and a decode step at decode_32k's (B 8 over a 32,768-position
cache), counted by the dry run on a 1x1 virtual mesh on meta and over the
same mesh step on the card (a 1-rank NCCL group): FLOPs equal, K2's 85
launches equal to the counters, the peak within ``CALIB_PEAK``, the
measured seconds beside the roofline's; and after ssm_serve,
falcon-mamba-7b's long_500k decode step (B 1): FLOPs equal, K7 once a
layer.  ``serve_steps_mesh_2`` in train_mesh_2's rank group:
``make_prefill_step`` / ``make_decode_step`` on the two gloo ranks, bf16
at full width (qwen3-0.6b at 2 layers on 2x1 and 1x2, falcon-mamba-7b at
1 on 1x2; B 2, a 4,096-token prompt, 8 decode steps): logits and caches
gathered whole within ``BF16_ORACLE_TOL`` of one device's, launches a
step one device's; ``dryrun_mesh`` counts their prefill and first decode
step too.  ``dryrun_grid`` at the end: four production cells (qwen3-0.6b
train_4k and decode_32k on pod1, llama4-maverick train_4k and zamba2-2.7b
long_500k on pod2: both sequence-parallel caches) in subprocesses under a
time limit, each cell's line without its collectives, with its host
seconds.

Then a ``{"kernels": [...]}`` summary line (each row's launches from the
main path that gives its shape, named in its ``path``), a check that no
process the script started is still running (the ranks' fork server is
stopped right after train_mesh_2), nvidia-smi's line, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before that line.  Without a CUDA device, or without the repo's
``src/`` beside it, the script exits non-zero and prints no result.

``--only paged_attention,matmul`` (any kernel checks) runs phases 1-3 for
those kernels alone and prints no result line: a quick check of a kernel.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12,  # f32 outside the tensor cores
                  "bfloat16": 989e12}  # bf16 dense tensor-core rate
# exp2 on the special function units: 16 results a clock an SM (CUDA
# programming guide's throughput table, compute capability 9.0), 132 SMs at
# the H100 SXM's 1,980 MHz boost clock; each expf issues one
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BF16_ORACLE_TOL = 5e-2


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started (``elapsed_s``), so a run shows where its time went."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
    print(json.dumps(obj), flush=True)


def rel_err(got, want) -> tuple:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def host_ms(fn, reps: int = 5, samples: int = 21) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    eager calls, from CUDA events, after a warm-up: host dispatch included,
    which is what a small kernel costs on the eager main path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, samples: int = 21) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``samples`` times between CUDA events, median per call.  The
    replay needs no host, so this is the time of the call's kernels on the
    card (and the graph's gaps between them), not of their dispatch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def gate(name, got, want, faults, margin=4.0, floor=0.0, tols=None) -> dict:
    """Hold a kernel's output to its plain version row by row, and check
    that each planted fault (a wrong output at the same shape) fails the
    same gate by ``margin`` times its tolerance.  ``floor`` and ``tols``
    (limits by dtype, default ``ref.ROW_TOL``): gradients take
    ``ref.GRAD_ROW_FLOOR`` and ``ref.GRAD_ROW_TOL``."""
    from repro_torch.kernels import ref
    import torch
    tol = (tols or ref.ROW_TOL)[want.dtype]
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err, rel = ref.row_rel_err(got, want, floor)
    assert rel <= tol, f"{name}: row rel err {rel} > {tol}"
    planted = {k: ref.row_rel_err(f, want, floor)[1]
               for k, f in faults.items()}
    for k, r in planted.items():
        assert r > margin * tol, \
            f"{name}: planted fault {k} passes the gate ({r})"
    return dict(max_abs_err=err, row_rel_err=rel, tol=tol,
                planted_fault_row_rel_err=planted)


def bound(nbytes: float, ops: float, dtype: str, sfu: float = 0.0) -> tuple:
    """The least time (ms) and what sets it: ``nbytes`` over the memory rate,
    or ``ops`` over the type's peak rate or ``sfu`` special-function results
    (expf) over the SFUs' rate, whichever is longest (the pipes run side by
    side)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS_PER_S[dtype], sfu / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters() -> dict:
    """Each kernel's launch counter: name -> (wrapper module, attribute)."""
    from repro_torch.kernels import (flash_attention, lora, matmul,
                                     paged_attention, rmsnorm, ssm_scan)
    return {"paged_attention": (paged_attention, "launches"),
            "rmsnorm": (rmsnorm, "launches"),
            "rmsnorm_bwd": (rmsnorm, "bwd_launches"),
            "matmul": (matmul, "launches"),
            "lora_shrink": (lora, "shrink_launches"),
            "lora_expand": (lora, "expand_launches"),
            "lora_delta": (lora, "delta_launches"),
            "ssm_scan": (ssm_scan, "launches"),
            "ssm_scan_bwd": (ssm_scan, "bwd_launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches")}


def zero_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool(torch, gen, n, bs, kv, hd, dtype):
    k = torch.randn((n, bs, kv, hd), generator=gen, device=DEV) * 0.5
    v = torch.randn((n, bs, kv, hd), generator=gen, device=DEV) * 0.5
    return k.to(dtype), v.to(dtype)


def _tables(torch, lens, m, bs, n, rng):
    """Distinct live blocks per row, null-padded past ceil(len/bs)."""
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((len(lens), m), np.int32)
    at = 0
    for i, ln in enumerate(lens):
        used = -(-ln // bs)
        tables[i, :used] = perm[at:at + used]
        at += used
    return torch.from_numpy(tables).to(DEV)


# paged attention's head layouts, each with the main path that gives it:
# qwen3-0.6b (16 query heads over 8 KV heads, head_dim 128), zamba2-2.7b's
# shared block (32 heads, one per KV head, head_dim 80), olmoe-1b-7b (16
# heads over 16, head_dim 128), llama4-maverick (40 heads over 8, a group
# of 5, head_dim 128), a rank's half of qwen3-0.6b's heads on a 2-rank
# serve mesh (8 over 4), and a rank's half of olmoe-1b-7b's 16/16 on the
# same mesh (8 over 8)
PAGED_SHAPES = (("serve", 16, 8, 128), ("hybrid_serve", 32, 32, 80),
                ("moe_serve", 16, 16, 128), ("llama4_layer", 40, 8, 128),
                ("serve_mesh_2", 8, 4, 128), ("moe_mesh_2", 8, 8, 128))
# gate-only decode rows (no main path gives them, so no times): spans at the
# split-KV kernel's split boundaries (512 keys, ``ref.PAGED_SPLIT``) at both
# serve layouts, a group of 8 query heads a KV head, and a block size that
# divides nothing at head_dim 40 (an odd count of 16-byte chunks a row).
# Each entry: (name, H, KV, head_dim, block size, spans).
PAGED_GATES = (("split_boundaries", 16, 8, 128, 16,
                (511, 512, 513, 1025, 2048)),
               ("split_boundaries", 32, 32, 80, 16,
                (511, 512, 513, 1025, 2048)),
               ("group_8", 32, 4, 128, 16,
                (1, 17, 255, 512, 1000, 1537, 2000, 2048)),
               ("block_size_5", 4, 1, 40, 5, (1, 7, 513, 1100)))
# gate-only prefill chunks: C = 100 at start 37 (q tiles of 64 rows that
# straddle two heads' rows and end ragged) at both serve layouts, and C = 70
# at start 600 with block size 5 and head_dim 40 (two splits in f32).
# Each entry: (name, H, KV, head_dim, block size, C, start).
PAGED_CHUNK_GATES = (("ragged_chunk", 16, 8, 128, 16, 100, 37),
                     ("ragged_chunk", 32, 32, 80, 16, 100, 37),
                     ("block_size_5", 4, 1, 40, 5, 70, 600))
# SASS function-name fragments of K1's kernels: split-KV (decode in both
# dtypes, f32 chunks; CUDA cores) and the bf16 chunk kernel (tensor cores)
K1_SASS = {("bfloat16", "decode"): "paged_split_kernelI13__nv_bfloat16",
           ("float32", "decode"): "paged_split_kernelIf",
           ("bfloat16", "prefill_chunk"): "paged_chunk_mma_kernel",
           ("float32", "prefill_chunk"): "paged_split_kernelIf"}


def check_paged_attention(torch, results):
    counts = sass_mma("paged_attention")
    for path, h, kv, hd in PAGED_SHAPES:
        _check_paged_attention(torch, results, path, h, kv, hd)
    for dtype in (torch.float32, torch.bfloat16):
        for name, h, kv, hd, bs, lens in PAGED_GATES:
            results.append(_paged_gate(torch, name, dtype, h, kv, hd, bs,
                                       lens))
        for name, *shape in PAGED_CHUNK_GATES:
            results.append(_paged_chunk_gate(torch, name, dtype, *shape))
    for r in results:
        if r["name"].startswith("paged_attention/"):
            frag = K1_SASS[(r["dtype"], r["name"].split("/")[1])]
            r["sass_mma"] = {frag: sum(c for f, c in counts.items()
                                       if frag in f)}
            if (r["dtype"], r["name"]) == ("bfloat16",
                                           "paged_attention/prefill_chunk"):
                assert r["sass_mma"][frag] > 0, r["sass_mma"]
            elif r["dtype"] == "float32":
                assert r["sass_mma"][frag] == 0, r["sass_mma"]


def _drop_split(torch, q, kp, vp, tables, lens, drop=1):
    """A planted fault of the split-KV design: decode with one middle split
    of every span left out (``ref.paged_attention_split_ref``)."""
    from repro_torch.kernels import ref
    b, _, h, hd = q.shape
    group = h // kp.shape[2]
    o = ref.paged_attention_split_ref(
        q.reshape(b, -1, group, hd), kp, vp, tables,
        (lens - 1)[:, None].expand(b, group).contiguous(), lens, drop=drop)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _k1_split_checks(torch, name, q, kp, vp, tables, lens, got, want,
                     checked) -> dict:
    """K1's decode checks of the split-KV design, added to a row's gate:
    the planted fault of a dropped middle split (gated on the rows whose
    span it reaches, those over 1,024 keys), two launches bitwise equal,
    and each batch row run alone (B = 1) bitwise equal to its row of the
    batch."""
    from repro_torch.kernels import ops
    long = lens > 1024
    checked["planted_fault_row_rel_err"]["drop_middle_split"] = gate(
        f"{name} rows over 1024", got[long], want[long],
        {"drop_middle_split": _drop_split(torch, q, kp, vp, tables,
                                          lens)[long]})[
        "planted_fault_row_rel_err"]["drop_middle_split"]
    assert torch.equal(got, ops.paged_attention(q, kp, vp, tables, lens)), \
        f"{name}: two launches differ"
    for i in range(q.shape[0]):
        alone = ops.paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                    lens[i:i + 1])
        assert torch.equal(alone, got[i:i + 1]), \
            f"{name}: batch row {i} alone differs from the batch"
    return dict(checked, bitwise_repeat=True,
                batch_invariant_rows=q.shape[0])


def _paged_gate(torch, name, dtype, h, kv, hd, bs, lens_list):
    """A gate-only K1 decode row: per-row gate with its planted faults, two
    launches bitwise equal, every row bitwise batch-invariant."""
    from repro_torch.kernels import ops, ref
    b, max_len = len(lens_list), 2048
    m = -(-max_len // bs)
    n = b * m + 1
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=DEV).manual_seed(1)
    dname = str(dtype).split(".")[1]
    kp, vp = _pool(torch, gen, n, bs, kv, hd, dtype)
    tables = _tables(torch, list(lens_list), m, bs, n, rng)
    lens = torch.tensor(lens_list, dtype=torch.int32, device=DEV)
    q = (torch.randn((b, 1, h, hd), generator=gen, device=DEV)
         * 0.5).to(dtype)
    got = ops.paged_attention(q, kp, vp, tables, lens)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens)
    label = f"paged_attention {name} H={h} KV={kv} hd={hd} {dname}"
    checked = _k1_split_checks(torch, label, q, kp, vp, tables, lens, got,
                               want, gate(label, got, want, {}))
    return dict(name="paged_attention/decode", dtype=dname, path=None,
                gate=name, shape=f"B={b} H={h} KV={kv} hd={hd} bs={bs} "
                                 f"lens={list(lens_list)}", **checked)


def _paged_chunk_gate(torch, name, dtype, h, kv, hd, bs, c, start):
    """A gate-only K1 prefill chunk: per-row gate with a planted fault, two
    launches bitwise equal."""
    from repro_torch.kernels import ops, ref
    kv_len = start + c
    m = -(-kv_len // bs) + 2                   # a null-padded table tail
    rng = np.random.default_rng(2)
    gen = torch.Generator(device=DEV).manual_seed(2)
    dname = str(dtype).split(".")[1]
    kp, vp = _pool(torch, gen, m + 1, bs, kv, hd, dtype)
    tables = _tables(torch, [kv_len], m, bs, m + 1, rng)
    cpos = torch.arange(start, kv_len, dtype=torch.int32, device=DEV)
    kvl = torch.tensor([kv_len], dtype=torch.int32, device=DEV)
    q = (torch.randn((1, c, h, hd), generator=gen, device=DEV)
         * 0.5).to(dtype)
    got = ops.paged_attention_chunk(q, kp, vp, tables, cpos, kvl)
    want = ref.paged_attention_chunk_ref(q, kp, vp, tables, cpos, kvl)
    zeroed = got.clone()
    zeroed[:, -1] = 0
    label = f"paged_attention chunk {name} H={h} KV={kv} hd={hd} {dname}"
    checked = gate(label, got, want, {"zero_last_token": zeroed})
    assert torch.equal(got, ops.paged_attention_chunk(
        q, kp, vp, tables, cpos, kvl)), f"{label}: two launches differ"
    return dict(name="paged_attention/prefill_chunk", dtype=dname,
                path=None, gate=name, bitwise_repeat=True,
                shape=f"C={c} start={start} H={h} KV={kv} hd={hd} bs={bs}",
                **checked)


def _check_paged_attention(torch, results, path, h, kv, hd):
    """K1 through ``ops.paged_attention`` / ``ops.paged_attention_chunk``
    (so the callers' grouping copies are covered) at one head layout: a
    decode batch of 8 rows over ragged spans up to 2,048 and a 256-token
    prefill chunk at two offsets, f32 and bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import paged_gather
    b, bs, max_len = 8, 16, 2048
    m = max_len // bs
    n = b * m + 1
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=DEV).manual_seed(0)
    lens_list = [1, 17, 255, 512, 1000, 1537, 2000, 2048]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        kp, vp = _pool(torch, gen, n, bs, kv, hd, dtype)

        # decode: q (B,1,H,hd) over ragged spans with null-padded tables
        tables = _tables(torch, lens_list, m, bs, n, rng)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=DEV)
        q = (torch.randn((b, 1, h, hd), generator=gen, device=DEV)
             * 0.5).to(dtype)
        got = ops.paged_attention(q, kp, vp, tables, lens)
        want = ref.paged_attention_ref(q, kp, vp, tables, lens)
        zeroed = got.clone()
        zeroed[lens > 255] = 0
        skip = torch.where(lens > bs, (lens - 1) // bs * bs, lens)
        checked = gate(f"paged_attention decode {dname}", got, want, {
            "zero_spans_over_255": zeroed,
            "skip_last_page": ops.paged_attention(q, kp, vp, tables, skip)})
        checked = _k1_split_checks(
            torch, f"paged_attention decode {dname}", q, kp, vp, tables,
            lens, got, want, checked)
        kg = paged_gather(kp, tables).repeat_interleave(h // kv, dim=2) \
            .transpose(1, 2)
        vg = paged_gather(vp, tables).repeat_interleave(h // kv, dim=2) \
            .transpose(1, 2)
        mask = (torch.arange(m * bs, device=DEV)[None, :]
                < lens[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        live = sum(lens_list)
        nbytes = 2 * q.numel() * esize + tables.numel() * 4 + b * 4 \
            + 2 * live * kv * hd * esize
        t_bound, by = bound(nbytes, 4.0 * h * hd * live, dname)
        results.append(dict(
            name="paged_attention/decode", dtype=dname, path=path,
            shape=f"B={b} H={h} KV={kv} hd={hd} bs={bs} lens={lens_list}",
            **checked,
            kernel_ms=graph_ms(lambda: ops.paged_attention(
                q, kp, vp, tables, lens)),
            host_ms=host_ms(lambda: ops.paged_attention(
                q, kp, vp, tables, lens)),
            plain_ms=graph_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, tables, lens)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask)),
            bound_ms=t_bound, bound_by=by))

        # prefill chunk: C = 256 query tokens (R = 512 rows per KV head)
        c = 256
        for start in (0, 512):
            kv_len = start + c
            tables = _tables(torch, [kv_len], m, bs, n, rng)
            cpos = torch.arange(start, start + c, dtype=torch.int32,
                                device=DEV)
            kvl = torch.tensor([kv_len], dtype=torch.int32, device=DEV)
            q = (torch.randn((1, c, h, hd), generator=gen, device=DEV)
                 * 0.5).to(dtype)
            got = ops.paged_attention_chunk(q, kp, vp, tables, cpos, kvl)
            want = ref.paged_attention_chunk_ref(q, kp, vp, tables, cpos, kvl)
            assert torch.equal(got, ops.paged_attention_chunk(
                q, kp, vp, tables, cpos, kvl)), "chunk: two launches differ"
            zeroed = got.clone()
            zeroed[:, -1] = 0
            checked = gate(f"paged_attention chunk@{start} {dname}", got,
                           want, {
                               "zero_last_token": zeroed,
                               "skip_last_page": ops.paged_attention_chunk(
                                   q, kp, vp, tables, cpos,
                                   (kvl - 1) // bs * bs)})
            kg = paged_gather(kp, tables).repeat_interleave(h // kv, dim=2) \
                .transpose(1, 2)
            vg = paged_gather(vp, tables).repeat_interleave(h // kv, dim=2) \
                .transpose(1, 2)
            kpos = torch.arange(m * bs, device=DEV)
            cmask = ((kpos[None, :] <= cpos[:, None].long())
                     & (kpos[None, :] < kv_len))[None, None]
            qh = q.transpose(1, 2)
            pairs = sum(start + i + 1 for i in range(c))
            nbytes = 2 * q.numel() * esize + tables.numel() * 4 + c * 4 + 4 \
                + 2 * kv_len * kv * hd * esize
            t_bound, by = bound(nbytes, 4.0 * h * hd * pairs, dname)
            results.append(dict(
                name="paged_attention/prefill_chunk", dtype=dname,
                path=path,
                shape=f"C={c} start={start} H={h} KV={kv} hd={hd} bs={bs}",
                **checked,
                kernel_ms=graph_ms(lambda: ops.paged_attention_chunk(
                    q, kp, vp, tables, cpos, kvl)),
                host_ms=host_ms(lambda: ops.paged_attention_chunk(
                    q, kp, vp, tables, cpos, kvl)),
                plain_ms=graph_ms(lambda: ref.paged_attention_chunk_ref(
                    q, kp, vp, tables, cpos, kvl)),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                    qh, kg, vg, attn_mask=cmask)),
                bound_ms=t_bound, bound_by=by))
        del kp, vp


# rmsnorm's shapes, at decode and prefill-chunk rows: qwen3-0.6b's norms
# (d 1,024, the q/k norms at 128), falcon-mamba-7b's layer norms (4,096),
# zamba2-2.7b's layer and shared-block norms (2,560) and its Mamba2 gated
# norm over d_inner (5,120); then qwen3-0.6b's training step (B 8 x S 512
# rows at 1,024, times 16 query heads and 8 key heads at 128); olmoe's
# norms (2,048); llama4-maverick's at its decode step (4 rows of 5,120; its
# chunk rows are zamba2's); whisper-small's (768) at a decode step of 8
# and over its encoder's 8 x 1,500 frames; qwen2-vl-72b's (8,192) at a
# decode step of 8 and at its training step (B 8 x S 512); and the main
# path that gives each.  The q/k
# norms at 128 run as a pair on every path (``RMSNORM_PAIR_SHAPES``), so
# their single rows are gate-only (path None)
RMSNORM_SHAPES = ((8, 1024), (256, 1024), (8 * 16, 128), (256 * 16, 128),
                  (8, 4096), (256, 4096), (8, 2560), (256, 2560),
                  (8, 5120), (256, 5120), (4096, 1024), (4096 * 16, 128),
                  (4096 * 8, 128), (8, 2048), (256, 2048), (4, 5120),
                  (8, 768), (8 * 1500, 768), (8, 8192), (4096, 8192),
                  (2048, 1024))
RMSNORM_PATH = {1024: "serve", 128: None, 4096: "ssm_serve",
                2560: "hybrid_serve", 5120: "hybrid_serve",
                2048: "moe_serve", 768: "whisper_serve", 8192: "vlm_serve"}
RMSNORM_TRAIN_SHAPES = ((4096, 1024), (4096 * 16, 128), (4096 * 8, 128))
# rows whose path is not their width's
# (2048, 1024): a rank's layer norms on the 2-rank training mesh (half the
# batch at 2x1, half the sequence under sequence parallelism at 1x2)
RMSNORM_ROW_PATH = {(4, 5120): "llama4_layer", (4096, 8192): "train_vlm",
                    (2048, 1024): "train_mesh_2"}


def rmsnorm_path(rows, d):
    if d == 128:
        return None
    if (rows, d) in RMSNORM_ROW_PATH:
        return RMSNORM_ROW_PATH[rows, d]
    return "train" if (rows, d) in RMSNORM_TRAIN_SHAPES else RMSNORM_PATH[d]


def ptxas_info(name: str) -> dict:
    """ptxas's register and spill lines for each kernel of the library
    ``name``, from this process's build: {mangled function: [lines]};
    empty where an earlier build was reused."""
    from repro_torch.kernels import build
    info, fn = {}, None
    for ln in build.BUILD_LOG.get(name, "").splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn is not None and ("registers" in ln or "spill" in ln):
            info.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return info


def k2_ptxas(info, kernels, dname) -> dict:
    """The rows of ``ptxas_info("rmsnorm")`` for K2's ``kernels`` at x and
    w both of ``dname`` (the template arguments in the mangled name)."""
    arg = "f" if dname == "float32" else "13__nv_bfloat16"
    other = "13" if dname == "float32" else "f"
    return {fn: v for fn, v in info.items()
            for k in kernels if f"{k}I{arg}" in fn
            and f"{k}I{arg}{other}" not in fn}


def check_rmsnorm(torch, results):
    """K2 against its plain version at every path's rows: the forward, the
    pair (qwen's q and k norms in one launch) and the backward.  Forward
    rows: two launches bitwise equal, sample rows alone and the first 8
    rows bitwise their rows in the batch.  ``host_ms`` is the wrapper's
    eager cost, ``ops_host_ms`` that of ``ops.rmsnorm`` with nothing
    recording (how the serve engine reaches it: the kernel, no Function)
    and ``function_host_ms`` that of ``RMSNormFn``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_kernel
    info = ptxas_info("rmsnorm")
    gen = torch.Generator(device=DEV).manual_seed(1)
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for rows, d in RMSNORM_SHAPES:
            x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device=DEV)).to(dtype)
            got = rmsnorm_kernel(x, w, eps)
            want = ref.rmsnorm_ref(x, w, eps)
            tail = got.clone()
            tail[:, -d // 8:] = 0
            checked = gate(f"rmsnorm ({rows},{d}) {dname}", got, want,
                           {"zero_tail_columns": tail})
            name = f"rmsnorm ({rows},{d}) {dname}"
            assert torch.equal(got, rmsnorm_kernel(x, w, eps)), \
                f"{name}: two launches differ"
            assert torch.equal(rmsnorm_kernel(x[:8], w, eps), got[:8]), \
                f"{name}: the first 8 rows alone differ"
            for i in sorted({0, rows // 2, rows - 1}):
                assert torch.equal(rmsnorm_kernel(x[i:i + 1], w, eps),
                                   got[i:i + 1]), f"{name}: row {i} alone"
            lib = (lambda: F.rms_norm(x, (d,), w, eps)) \
                if hasattr(F, "rms_norm") else None
            t_bound, by = bound((2 * rows * d + d) * esize, 4.0 * rows * d,
                                dname)
            with torch.no_grad():
                ops_host = host_ms(lambda: ops.rmsnorm(x, w, eps))
            results.append(dict(
                name=f"rmsnorm/d{d}", dtype=dname, shape=f"({rows}, {d})",
                path=rmsnorm_path(rows, d),
                **checked, bitwise_repeat=True, batch_invariant_rows=True,
                ptxas=k2_ptxas(info, ("rmsnorm_fwd_kernel",), dname),
                kernel_ms=graph_ms(lambda: rmsnorm_kernel(x, w, eps)),
                host_ms=host_ms(lambda: rmsnorm_kernel(x, w, eps)),
                ops_host_ms=ops_host,
                function_host_ms=host_ms(lambda: RMSNormFn.apply(x, w, eps)),
                plain_ms=graph_ms(lambda: ref.rmsnorm_ref(x, w, eps)),
                library_ms=graph_ms(lib) if lib else None,
                bound_ms=t_bound, bound_by=by))
        del x, w, got, want, tail
        _check_rmsnorm_pair(torch, results, dtype, gen, eps, info)
    check_rmsnorm_grad(torch, results, info)
    check_rmsnorm_narrow(torch, results, info)


# REPRO_NORM_F32=0's mode (``f32=False``: the mean, rstd and every product
# rounded to bf16, the sums in f32) at bf16, the only dtype it changes: the
# forward at qwen's and olmoe's serve rows and qwen's training row, the
# pair at qwen's decode q/k rows, the backward at the training rows of
# qwen and olmoe.  No main path runs it (the knob's default is 1): gate
# rows, timed, with path None
RMSNORM_NARROW_SHAPES = ((8, 1024), (256, 1024), (8, 2048), (256, 2048),
                         (4096, 1024))
RMSNORM_NARROW_PAIR = (8 * 16, 8 * 8, 128)
RMSNORM_NARROW_GRAD_SHAPES = ((4096, 1024), (4096, 2048))


def check_rmsnorm_narrow(torch, results, info):
    """K2 in narrow mode (bf16) against its plain version
    (``ref.rmsnorm_ref(..., f32=False)``, which equals the reference's
    ``rms_norm`` under REPRO_NORM_F32=0 on the CPU): the forward row by row
    with the tail-columns fault, two launches bitwise, the first 8 rows
    bitwise their rows in the batch, and other bits than the f32 mode's;
    the pair bitwise its two single launches; the backward's dx and dw
    against the narrow plain backward with g's rows shifted and dx without
    its mean term as planted faults, two launches bitwise.  The f32 mode's
    rows above stay as they were (its code path has no narrow step)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k2
    gen = torch.Generator(device=DEV).manual_seed(5)
    eps, dtype, dname = 1e-6, torch.bfloat16, "bfloat16"
    for rows, d in RMSNORM_NARROW_SHAPES:
        x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device=DEV)) \
            .to(dtype)
        name = f"rmsnorm narrow ({rows},{d}) {dname}"
        got = k2.rmsnorm_kernel(x, w, eps, f32=False)
        tail = got.clone()
        tail[:, -d // 8:] = 0
        checked = gate(name, got, ref.rmsnorm_ref(x, w, eps, False),
                       {"zero_tail_columns": tail})
        assert torch.equal(got, k2.rmsnorm_kernel(x, w, eps, f32=False)), \
            f"{name}: two launches differ"
        assert torch.equal(k2.rmsnorm_kernel(x[:8], w, eps, f32=False),
                           got[:8]), f"{name}: the first 8 rows alone differ"
        f32_mode = k2.rmsnorm_kernel(x, w, eps)
        assert not torch.equal(got, f32_mode), f"{name}: the f32 mode's bits"
        t_bound, by = bound((2 * rows * d + d) * 2, 4.0 * rows * d, dname)
        results.append(dict(
            name=f"rmsnorm_narrow/d{d}", dtype=dname, shape=f"({rows}, {d})",
            path=None, **checked, bitwise_repeat=True,
            differs_from_f32_mode=float((got.float() - f32_mode.float())
                                        .abs().max()),
            ptxas=k2_ptxas(info, ("rmsnorm_fwd_kernel",), dname),
            kernel_ms=graph_ms(lambda: k2.rmsnorm_kernel(x, w, eps,
                                                         f32=False)),
            host_ms=host_ms(lambda: k2.rmsnorm_kernel(x, w, eps, f32=False)),
            plain_ms=graph_ms(lambda: ref.rmsnorm_ref(x, w, eps, False)),
            library_ms=graph_ms(lambda: F.rms_norm(x, (d,), w, eps))
            if hasattr(F, "rms_norm") else None,
            bound_ms=t_bound, bound_by=by))
    r1, r2, d = RMSNORM_NARROW_PAIR
    x1, x2 = (torch.randn((r, d), generator=gen, device=DEV).to(dtype)
              for r in (r1, r2))
    w1, w2 = ((1 + 0.1 * torch.randn((d,), generator=gen, device=DEV))
              .to(dtype) for _ in range(2))
    y1, y2 = k2.rmsnorm_pair_kernel(x1, w1, x2, w2, eps, f32=False)
    name = f"rmsnorm narrow pair ({r1}+{r2},{d}) {dname}"
    assert torch.equal(y1, k2.rmsnorm_kernel(x1, w1, eps, f32=False)) \
        and torch.equal(y2, k2.rmsnorm_kernel(x2, w2, eps, f32=False)), \
        f"{name}: not its single launches"
    checked = gate(name, torch.cat([y1, y2]), torch.cat(
        [ref.rmsnorm_ref(x1, w1, eps, False),
         ref.rmsnorm_ref(x2, w2, eps, False)]), {"weights_swapped": torch.cat(
             [ref.rmsnorm_ref(x1, w2, eps, False),
              ref.rmsnorm_ref(x2, w1, eps, False)])})
    t_bound, by = bound((2 * (r1 + r2) * d + 2 * d) * 2,
                        4.0 * (r1 + r2) * d, dname)
    results.append(dict(
        name=f"rmsnorm_narrow_pair/d{d}", dtype=dname,
        shape=f"({r1}+{r2}, {d})", path=None, **checked,
        bitwise_single_launches=True,
        kernel_ms=graph_ms(lambda: k2.rmsnorm_pair_kernel(
            x1, w1, x2, w2, eps, f32=False)),
        host_ms=host_ms(lambda: k2.rmsnorm_pair_kernel(
            x1, w1, x2, w2, eps, f32=False)),
        plain_ms=graph_ms(lambda: (ref.rmsnorm_ref(x1, w1, eps, False),
                                   ref.rmsnorm_ref(x2, w2, eps, False))),
        library_ms=graph_ms(lambda: (F.rms_norm(x1, (d,), w1, eps),
                                     F.rms_norm(x2, (d,), w2, eps)))
        if hasattr(F, "rms_norm") else None,
        bound_ms=t_bound, bound_by=by))
    for rows, d in RMSNORM_NARROW_GRAD_SHAPES:
        x, g = (torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
                for _ in range(2))
        w = (1 + 0.5 * torch.randn((d,), generator=gen, device=DEV)) \
            .to(dtype)
        name = f"rmsnorm narrow bwd ({rows},{d}) {dname}"
        dx, dw = k2.rmsnorm_bwd_kernel(x, w, g, eps, f32=False)
        again = k2.rmsnorm_bwd_kernel(x, w, g, eps, f32=False)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dw), \
            f"{name}: two launches differ"
        rdx, rdw = ref.rmsnorm_bwd_ref(x, w, g, eps, f32=False)
        sdx, sdw = ref.rmsnorm_bwd_ref(x, w, g.roll(1, 0), eps, f32=False)
        ndx = ref.rmsnorm_bwd_ref(x, w, g, eps, mean_term=False,
                                  f32=False)[0]
        # the mean term moves dx by several bf16 limits at d 1,024 (held at
        # a margin of 1.5, as the f32 mode's training rows), less at 2,048
        faults = {"g_rows_shifted": sdx}
        if d == 1024:
            faults["no_mean_term"] = ndx
        gx = gate(f"{name} dx", dx, rdx, faults, margin=1.5)
        gw = gate(f"{name} dw", dw[None], rdw[None],
                  {"g_rows_shifted": sdw[None]})
        lib = lib_fwd = None
        if hasattr(F, "rms_norm"):
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            lib_fwd = graph_ms(lambda: F.rms_norm(xl, (d,), wl, eps))
            lib = graph_ms(lambda: torch.autograd.grad(
                F.rms_norm(xl, (d,), wl, eps), (xl, wl), g)) - lib_fwd
        t_bound, by = bound(3 * rows * d * 2 + 2 * d * 2, 10.0 * rows * d,
                            "float32")
        results.append(dict(
            name=f"rmsnorm_narrow_bwd/d{d}", dtype=dname,
            shape=f"({rows}, {d})", path=None,
            max_abs_err=max(gx["max_abs_err"], gw["max_abs_err"]),
            row_rel_err=max(gx["row_rel_err"], gw["row_rel_err"]),
            tol=gx["tol"], dx_gate=gx, dw_gate=gw, bitwise_repeat=True,
            ptxas=k2_ptxas(info, ("rmsnorm_bwd_rows_kernel",), dname),
            kernel_ms=graph_ms(lambda: k2.rmsnorm_bwd_kernel(
                x, w, g, eps, f32=False)),
            host_ms=host_ms(lambda: k2.rmsnorm_bwd_kernel(x, w, g, eps,
                                                          f32=False)),
            plain_ms=graph_ms(lambda: ref.rmsnorm_bwd_ref(x, w, g, eps,
                                                          f32=False)),
            library_ms=lib, library_fwd_ms=lib_fwd,
            bound_ms=t_bound, bound_by=by))
    torch.cuda.empty_cache()


# the pair's rows and the main path that gives each: qwen3-0.6b's q and k
# norms (16 and 8 heads of 128) at a decode step (B 8) and a prefill chunk
# (256 tokens), olmoe-1b-7b's (16 and 16 heads) at the same two, and qwen's
# at the training step (B 8 x S 512, last: the pair's backward row).
# llama4-maverick has no q/k norms
RMSNORM_PAIR_SHAPES = ((8 * 16, 8 * 8, 128, "serve"),
                       (256 * 16, 256 * 8, 128, "serve"),
                       (8 * 16, 8 * 16, 128, "moe_serve"),
                       (256 * 16, 256 * 16, 128, "moe_serve"),
                       (4096 * 16, 4096 * 8, 128, "train"),
                       (2048 * 16, 2048 * 8, 128, "train_mesh_2"))
# the pairs a training step runs backward through: the train path's, and a
# rank's on the 2-rank training mesh (2x1: half the batch; 1x2, half the
# heads, gives the same rows, 4,096 x 8 + 4,096 x 4)
RMSNORM_PAIR_GRAD_SHAPES = tuple(s for s in RMSNORM_PAIR_SHAPES
                                 if s[3].startswith("train"))


def _check_rmsnorm_pair(torch, results, dtype, gen, eps, info):
    """K2's pair: each output against the plain version and bitwise its
    single launch; timed beside two single launches (``singles_ms``,
    ``singles_host_ms``); plain version and yardstick are two calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (rmsnorm_kernel,
                                             rmsnorm_pair_kernel)
    dname = str(dtype).split(".")[1]
    esize = torch.finfo(dtype).bits // 8
    for r1, r2, d, path in RMSNORM_PAIR_SHAPES:
        x1, x2 = (torch.randn((r, d), generator=gen, device=DEV).to(dtype)
                  for r in (r1, r2))
        w1, w2 = ((1 + 0.1 * torch.randn((d,), generator=gen, device=DEV))
                  .to(dtype) for _ in range(2))
        y1, y2 = rmsnorm_pair_kernel(x1, w1, x2, w2, eps)
        name = f"rmsnorm pair ({r1}+{r2},{d}) {dname}"
        assert torch.equal(y1, rmsnorm_kernel(x1, w1, eps)) and torch.equal(
            y2, rmsnorm_kernel(x2, w2, eps)), f"{name}: not its single launch"
        got, want = torch.cat([y1, y2]), torch.cat(
            [ref.rmsnorm_ref(x1, w1, eps), ref.rmsnorm_ref(x2, w2, eps)])
        swapped = torch.cat([ref.rmsnorm_ref(x1, w2, eps),
                             ref.rmsnorm_ref(x2, w1, eps)])
        checked = gate(name, got, want, {"weights_swapped": swapped})

        def singles():
            rmsnorm_kernel(x1, w1, eps)
            rmsnorm_kernel(x2, w2, eps)

        def lib():
            F.rms_norm(x1, (d,), w1, eps)
            F.rms_norm(x2, (d,), w2, eps)
        t_bound, by = bound((2 * (r1 + r2) * d + 2 * d) * esize,
                            4.0 * (r1 + r2) * d, dname)
        results.append(dict(
            name=f"rmsnorm_pair/d{d}", dtype=dname,
            shape=f"({r1}+{r2}, {d})", counter="rmsnorm", path=path,
            **checked, bitwise_single_launches=True,
            kernel_ms=graph_ms(lambda: rmsnorm_pair_kernel(x1, w1, x2, w2,
                                                           eps)),
            host_ms=host_ms(lambda: rmsnorm_pair_kernel(x1, w1, x2, w2,
                                                        eps)),
            singles_ms=graph_ms(singles), singles_host_ms=host_ms(singles),
            plain_ms=graph_ms(lambda: (ref.rmsnorm_ref(x1, w1, eps),
                                       ref.rmsnorm_ref(x2, w2, eps))),
            library_ms=graph_ms(lib) if hasattr(F, "rms_norm") else None,
            bound_ms=t_bound, bound_by=by))


# the matmul kernel's shapes on the compile path: the decode term's two
# products, the prefill chunk's first, the SwiGLU MLP's two
MATMUL_SHAPES = ((1, 128, 2048), (1, 2048, 128), (256, 128, 2048),
                 (256, 1024, 3072), (256, 3072, 1024))
# gate-only shapes (no main path gives them, so no times): ragged M, K and N
# on every kernel (K or N not a multiple of 8 takes the element loads),
# M = 15 (the widest skinny product), a long K that splits, K = 0
MATMUL_GATES = ((37, 100, 77), (65, 33, 129), (16, 4104, 520),
                (15, 4096, 64), (4, 1000, 77), (3, 0, 5), (40, 0, 8))
# planted faults of the function (not of any tiling): the last 32
# positions of K left out, the last 64 columns zeroed, and the middle
# slice of a 4-way split of K left out (``ref.matmul_split_k_ref``)
MATMUL_K_TAIL = 32
MATMUL_ZERO_COLS = 64
# SASS function-name fragments of K4's kernels: the bf16 tensor-core GEMM
# (M >= 16), the f32 CUDA-core GEMM (M >= 16), the split-K kernels of the
# skinny products (M < 16, CUDA cores) by dtype
K4_SASS = {("bfloat16", True): "mm_tc_kernel",
           ("float32", True): "mm_f32_kernel",
           ("bfloat16", False): "mm_skinny_kernelI13__nv_bfloat16",
           ("float32", False): "mm_skinny_kernelIf"}


def check_matmul(torch, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_kernel
    counts = sass_mma("matmul")
    gen = torch.Generator(device=DEV).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for m, k, n in MATMUL_SHAPES:
            a = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
            b = torch.randn((k, n), generator=gen, device=DEV).to(dtype)
            got = matmul_kernel(a, b)
            want = ref.matmul_ref(a, b)
            assert torch.equal(got, matmul_kernel(a, b)), \
                f"matmul ({m},{k})@({k},{n}): two launches differ"
            kk = k - MATMUL_K_TAIL
            zeroed = got.clone()
            zeroed[:, n - MATMUL_ZERO_COLS:] = 0
            # the k-tail fault moves a row by about sqrt(32 / K) of its
            # largest value (0.10 at K = 3072): a margin of 2 keeps it clear
            # of the bf16 tolerance at every shape here
            checked = gate(f"matmul ({m},{k})@({k},{n}) {dname}", got, want, {
                "skip_last_32_k": matmul_kernel(a[:, :kk].contiguous(),
                                                b[:kk].contiguous()),
                "zero_last_64_columns": zeroed,
                "drop_middle_k_slice": ref.matmul_split_k_ref(a, b, 4,
                                                              drop=1)},
                margin=2.0)
            frag = K4_SASS[(dname, m >= 16)]
            sass = {frag: sum(c for f, c in counts.items() if frag in f)}
            if dname == "bfloat16" and m >= 16:
                assert sass[frag] > 0, sass
            elif dname == "float32":
                assert sass[frag] == 0, sass
            t_bound, by = bound((m * k + k * n + m * n) * esize,
                                2.0 * m * n * k, dname)
            results.append(dict(
                name="matmul", dtype=dname, shape=f"({m},{k})@({k},{n})",
                path="compile",
                **checked, bitwise_repeat=True, sass_mma=sass,
                kernel_ms=graph_ms(lambda: matmul_kernel(a, b)),
                host_ms=host_ms(lambda: matmul_kernel(a, b)),
                plain_ms=graph_ms(lambda: ref.matmul_ref(a, b)),
                library_ms=graph_ms(lambda: torch.matmul(a, b)),
                bound_ms=t_bound, bound_by=by))
        for m, k, n in MATMUL_GATES:
            a = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
            b = torch.randn((k, n), generator=gen, device=DEV).to(dtype)
            got = matmul_kernel(a, b)
            want = ref.matmul_ref(a, b)
            assert torch.equal(got, matmul_kernel(a, b)), \
                f"matmul ({m},{k})@({k},{n}): two launches differ"
            if k == 0:
                assert torch.equal(got, torch.zeros_like(got)), "K = 0"
                checked = dict(max_abs_err=0.0, row_rel_err=0.0)
            else:
                checked = gate(f"matmul ({m},{k})@({k},{n}) {dname}", got,
                               want, {"drop_middle_k_slice":
                                      ref.matmul_split_k_ref(a, b, 4,
                                                             drop=1)},
                               margin=2.0)
            results.append(dict(name="matmul", dtype=dname, path=None,
                                shape=f"({m},{k})@({k},{n})",
                                bitwise_repeat=True, **checked))


# the LoRA kernels' shapes on the serve path: rows of a decode step and of a
# prefill chunk; the projections' input and output widths at qwen3-0.6b
# (each width, and each projection's pair for the fused delta: q, k and v,
# o, gate and up, down); the store's rank slot and slot count; the H100
# plan's expand tile and two others
LORA_ROWS = (8, 256)
LORA_D_IN = (1024, 2048, 3072)
LORA_D_OUT = (1024, 2048, 3072)
LORA_PROJS = {"q": (1024, 2048), "k,v": (1024, 1024), "o": (2048, 1024),
              "gate,up": (1024, 3072), "down": (3072, 1024)}
LORA_RANK, LORA_SLOTS, LORA_BLOCK_OUT = 16, 8, 128
LORA_BLOCK_OUTS = (33, 128, 256)
# the engine's prefill chunk: one sequence of 256 rows, one slot
LORA_CHUNK_MIXES = {"one_sequence": [1], "base_sequence": [-1]}
# the timed mix of each row count: a decode step over three adapters, the
# engine's chunk
LORA_TIMED = {8: "repeats", 256: "one_sequence"}
# gate-only cases of the fused delta that no serve path gives, (ids,
# rows_per_seq, d, O, R, block_out): the tensor-core tile at ranks that pad
# to 16, 32 and 64 (at 64 its receive area reuses the shrink's ring), a
# ragged 20-row sequence, and d, O and block_out off the 8-column grid (d
# not a multiple of 8 keeps 32 rows a sequence on the CUDA cores)
LORA_GATE_CASES = (([1], 256, 1024, 2048, 8, 128),
                   ([2, -1], 64, 1024, 1024, 24, 128),
                   ([1], 256, 3072, 1024, 64, 128),
                   ([0, 3, -1], 20, 1024, 200, 16, 33),
                   ([1, -1, 2], 5, 1001, 77, 16, 33),
                   ([1], 32, 1001, 64, 16, 128))
# the tensor-core cluster kernels (rows_per_seq >= 16, bf16) and the CUDA
# core ones, by a fragment of their mangled names
LORA_SASS = {"tc": ("lora_cluster_kernelI13__nv_bfloat16Li16E",),
             "bfloat16": ("lora_cluster_kernelI13__nv_bfloat16Li1E",
                          "lora_cluster_kernelI13__nv_bfloat16Li8E"),
             "float32": ("lora_cluster_kernelIf",)}


def lora_mixes(t):
    """Slot mixes of ``t`` rows: repeats of three adapters, all base rows,
    base and adapter rows interleaved, and one row alone."""
    return {"repeats": [i % 3 for i in range(t)],
            "all_base": [-1] * t,
            "interleaved": [-1 if i % 2 else (i // 2) % LORA_SLOTS
                            for i in range(t)],
            "single_row": [1]}


def lora_cases(t):
    """(mix, per-sequence ids, rows_per_seq) at ``t`` rows: every per-row
    mix, and at 256 rows the engine's chunk (one sequence) with an adapter
    and without."""
    cases = [(mix, ids, 1) for mix, ids in lora_mixes(t).items()]
    if t == 256:
        cases += [(mix, ids, t) for mix, ids in LORA_CHUNK_MIXES.items()]
    return cases


def _lora_sass(counts, dname, tc) -> dict:
    """Tensor-core instructions in the cluster kernels of one row's regime
    (the tensor-core tile, or the CUDA cores of its dtype)."""
    return {f: sum(c for fn, c in counts.items() if f in fn)
            for f in LORA_SASS["tc" if tc else dname]}


def check_lora(torch, results):
    """K5, K6 and the fused delta against their plain versions at the serve
    path's shapes: every mix and the engine's chunk in f32 and bf16 through
    the row gate, exact zeros (K5, K6) or base + 0 (the delta) on base rows,
    the expand and the delta bitwise the same for three tiles, planted
    faults (every row reads slot 0; K5's last rank block, K6's last output
    tile or the delta's left unwritten; one d-slice of the delta's cluster
    sum dropped).  The delta is also held bitwise to K5 then K6 plus the
    base, to a relaunch, and each sequence run alone to its rows of the
    batch.  The decode "repeats" mix and the chunk are timed; K5 and the
    delta carry ``sass_mma`` of their regime (> 0 on the bf16 chunk's
    tensor-core tile, 0 on the CUDA cores)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lora import (lora_expand_kernel,
                                          lora_shrink_kernel,
                                          tensor_core_rows)
    counts = sass_mma("lora")
    assert sum(c for f, c in counts.items() if "lora_expand" in f) == 0
    gen = torch.Generator(device=DEV).manual_seed(4)
    r, s = LORA_RANK, LORA_SLOTS
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for t in LORA_ROWS:
            for mix, id_list, seq in lora_cases(t):
                idx = torch.tensor(id_list, dtype=torch.int32, device=DEV)
                rows_idx = idx.repeat_interleave(seq)
                rows = len(id_list) * seq
                live = rows_idx >= 0
                slot0 = torch.where(idx >= 0, 0, idx)
                n_live = int(live.sum())
                n_adapters = len({i for i in id_list if i >= 0})
                timed = mix == LORA_TIMED[t]
                label = f"T={rows} rows_per_seq={seq} R={r} S={s} {mix}"
                for d in LORA_D_IN:
                    x = torch.randn((rows, d), generator=gen,
                                    device=DEV).to(dtype)
                    a = (torch.randn((s, d, r), generator=gen, device=DEV)
                         * 0.1).to(dtype)
                    tc = tensor_core_rows(dtype, d, seq)
                    got = lora_shrink_kernel(x, a, idx, seq)
                    want = ref.lora_shrink_ref(x, a, rows_idx)
                    assert torch.equal(got[~live], torch.zeros_like(
                        got[~live])), "lora_shrink: base rows not zero"
                    faults = {}
                    if bool((idx > 0).any()):
                        tail = got.clone()
                        tail[:, -8:] = 0
                        faults = {"every_row_reads_slot_0":
                                  lora_shrink_kernel(x, a, slot0, seq),
                                  "last_rank_block_zero": tail}
                    checked = gate(f"lora_shrink d={d} {label} {dname}",
                                   got, want, faults)
                    if not timed:
                        continue
                    sass = _lora_sass(counts, dname, tc)
                    assert (sum(sass.values()) > 0) == tc, sass
                    a_rows = a[rows_idx.clamp_min(0).long()]
                    t_bound, by = bound(
                        (rows * d + n_adapters * d * r) * esize
                        + len(id_list) * 4 + rows * r * 4,
                        2.0 * n_live * d * r, dname)
                    results.append(dict(
                        name="lora_shrink", dtype=dname, path="lora_serve",
                        counter="lora_delta", shape=f"d={d} {label}",
                        tensor_cores=tc, sass_mma=sass, **checked,
                        kernel_ms=graph_ms(lambda: lora_shrink_kernel(
                            x, a, idx, seq)),
                        host_ms=host_ms(lambda: lora_shrink_kernel(
                            x, a, idx, seq)),
                        plain_ms=graph_ms(lambda: ref.lora_shrink_ref(
                            x, a, rows_idx)),
                        library_ms=graph_ms(lambda: torch.bmm(
                            x[:, None, :], a_rows)),
                        library="torch.bmm over per-row A gathered before "
                                "the call (yardstick)",
                        bound_ms=t_bound, bound_by=by))
                for o in LORA_D_OUT:
                    h = torch.randn((rows, r), generator=gen, device=DEV)
                    b = (torch.randn((s, r, o), generator=gen, device=DEV)
                         * 0.1).to(dtype)
                    got = lora_expand_kernel(h, b, idx, LORA_BLOCK_OUT, seq)
                    want = ref.lora_expand_ref(h, b, rows_idx, dtype)
                    assert torch.equal(got[~live], torch.zeros_like(
                        got[~live])), "lora_expand: base rows not zero"
                    for bo in LORA_BLOCK_OUTS:
                        assert torch.equal(
                            lora_expand_kernel(h, b, idx, bo, seq), got), \
                            f"lora_expand: block_out {bo} changed the output"
                    faults = {}
                    if bool((idx > 0).any()):
                        tail = got.clone()
                        tail[:, (o - 1) // LORA_BLOCK_OUT
                             * LORA_BLOCK_OUT:] = 0
                        faults = {"every_row_reads_slot_0":
                                  lora_expand_kernel(h, b, slot0,
                                                     LORA_BLOCK_OUT, seq),
                                  "last_output_tile_unwritten": tail}
                    checked = gate(f"lora_expand O={o} {label} {dname}",
                                   got, want, faults)
                    if not timed:
                        continue
                    b_rows = b[rows_idx.clamp_min(0).long()]
                    hb = h.to(dtype)[:, None, :]
                    t_bound, by = bound(
                        rows * r * 4 + n_adapters * r * o * esize
                        + len(id_list) * 4 + rows * o * esize,
                        2.0 * n_live * r * o, dname)
                    results.append(dict(
                        name="lora_expand", dtype=dname, path="lora_serve",
                        counter="lora_delta",
                        shape=f"O={o} block_out={LORA_BLOCK_OUT} {label}",
                        sass_mma={"lora_expand_kernel": 0}, **checked,
                        kernel_ms=graph_ms(lambda: lora_expand_kernel(
                            h, b, idx, LORA_BLOCK_OUT, seq)),
                        host_ms=host_ms(lambda: lora_expand_kernel(
                            h, b, idx, LORA_BLOCK_OUT, seq)),
                        plain_ms=graph_ms(lambda: ref.lora_expand_ref(
                            h, b, rows_idx, dtype)),
                        library_ms=graph_ms(lambda: torch.bmm(hb, b_rows)),
                        library="torch.bmm over per-row B gathered before "
                                "the call (yardstick)",
                        bound_ms=t_bound, bound_by=by))
                for proj, (d, o) in LORA_PROJS.items():
                    _check_lora_delta(
                        torch, results, counts, gen, dtype, d, o, idx,
                        rows_idx, seq, f"{proj} d={d} O={o} {label}", timed)
        for id_list, seq, d, o, rank, bo in LORA_GATE_CASES:
            idx = torch.tensor(id_list, dtype=torch.int32, device=DEV)
            label = (f"d={d} O={o} T={len(id_list) * seq} rows_per_seq={seq} "
                     f"R={rank} S={s} gate-only")
            results.append(dict(
                name="lora_delta", dtype=dname, path=None,
                shape=f"{label} block_out={bo} +base",
                tensor_cores=tensor_core_rows(dtype, d, seq),
                **_check_lora_delta(torch, results, counts, gen, dtype, d, o,
                                    idx, idx.repeat_interleave(seq), seq,
                                    label, False, rank, bo)))


def _check_lora_delta(torch, results, counts, gen, dtype, d, o, idx,
                      rows_idx, seq, label, timed, r=LORA_RANK,
                      bo=LORA_BLOCK_OUT):
    """The fused delta at one width pair and one case: the row gate with
    its planted faults, bitwise K5 then K6 plus the base (and without a
    base, K5 then K6), base rows base + 0, three tiles, a relaunch, each
    sequence alone; timed (a row of ``results``) when ``timed``.  Returns
    the gate's record."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lora import (SLICES, lora_delta_kernel,
                                          tensor_core_rows)
    s = LORA_SLOTS
    dname = str(dtype).split(".")[1]
    esize = torch.finfo(dtype).bits // 8
    rows = rows_idx.shape[0]
    live = rows_idx >= 0
    x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
    a = (torch.randn((s, d, r), generator=gen, device=DEV) * 0.1).to(dtype)
    b = (torch.randn((s, r, o), generator=gen, device=DEV) * 0.1).to(dtype)
    base = torch.randn((rows, o), generator=gen, device=DEV).to(dtype)

    def delta(ids=idx, block_out=bo, xx=x, bb=base):
        return lora_delta_kernel(xx, a, b, ids, seq, block_out, bb)
    got = delta()
    composed = ops.lora_expand(ops.lora_shrink(x, a, idx, seq), b, idx, bo,
                               seq)
    assert torch.equal(got, base + composed), \
        f"lora_delta {label}: not K5 then K6 plus the base, bitwise"
    assert torch.equal(delta(bb=None), composed), \
        f"lora_delta {label}: not K5 then K6, bitwise"
    assert torch.equal(got[~live], base[~live] + 0), \
        f"lora_delta {label}: base rows are not base + 0"
    for other in LORA_BLOCK_OUTS:
        assert torch.equal(delta(block_out=other), got), \
            f"lora_delta {label}: block_out {other} changed the output"
    assert torch.equal(delta(), got), f"lora_delta {label}: relaunch differs"
    for i in range(idx.shape[0]):
        sl = slice(i * seq, (i + 1) * seq)
        assert torch.equal(delta(ids=idx[i:i + 1], xx=x[sl], bb=base[sl]),
                           got[sl]), \
            f"lora_delta {label}: sequence {i} alone differs from the batch"
    want = ref.lora_delta_ref(x, a, b, rows_idx, base)
    faults = {}
    if bool(live.any()):
        tail = got.clone()
        tail[:, (o - 1) // bo * bo:] = 0
        faults = {"drop_one_d_slice": ref.lora_delta_ref(
                      x, a, b, rows_idx, base, drop_slice=3, slices=SLICES),
                  "last_output_tile_unwritten": tail}
        if bool((idx > 0).any()):
            faults["every_row_reads_slot_0"] = delta(
                ids=torch.where(idx >= 0, 0, idx))
    # dropping one of 8 slices moves h by about 1/sqrt(8) of itself, and y
    # is some third of a row beside a unit base at d = 1024: a margin of 2
    # keeps that fault clear of the bf16 tolerance at every width here
    checked = gate(f"lora_delta {label} {dname}", got, want, faults,
                   margin=2.0)
    checked.update(composition_bitwise=True, bitwise_repeat=True,
                   block_out_invariant=list(LORA_BLOCK_OUTS),
                   batch_invariant_seqs=int(idx.shape[0]))
    if not timed:
        return checked
    tc = tensor_core_rows(dtype, d, seq)
    sass = _lora_sass(counts, dname, tc)
    assert (sum(sass.values()) > 0) == tc, sass
    gathered = rows_idx.clamp_min(0).long()
    a_rows, b_rows = a[gathered], b[gathered]
    x3, base3 = x[:, None, :], base[:, None, :]
    n_live = int(live.sum())
    n_adapters = len({int(i) for i in idx.tolist() if i >= 0})
    t_bound, by = bound(
        (rows * d + n_adapters * (d + o) * r + 2 * rows * o) * esize
        + idx.shape[0] * 4, 2.0 * n_live * r * (d + o), dname)
    results.append(dict(
        name="lora_delta", dtype=dname, path="lora_serve",
        shape=f"{label} block_out={bo} +base", tensor_cores=tc,
        sass_mma=sass, **checked,
        kernel_ms=graph_ms(delta), host_ms=host_ms(delta),
        plain_ms=graph_ms(lambda: ref.lora_delta_ref(x, a, b, rows_idx,
                                                     base)),
        library_ms=graph_ms(lambda: torch.baddbmm(
            base3, torch.bmm(x3, a_rows), b_rows)),
        library="torch.bmm then torch.baddbmm (adds the base) over per-row "
                "A and B gathered before the calls: the two yardsticks "
                "(two calls)",
        bound_ms=t_bound, bound_by=by))
    return checked


# the selective scan's shapes on the ssm path (falcon-mamba-7b: d_inner
# 8,192, state 16): a decode step of 8 rows, one 256-token prefill chunk, and
# a 300-token prefill (one launch over all 300 steps, held bitwise against
# the engine's split into chunks of 256 with an identity-padded tail)
SSM_D, SSM_N, SSM_CHUNK = 8192, 16, 256
SSM_CASES = (("decode", 8, 1), ("prefill_chunk", 1, 256),
             ("chunked_ragged", 1, 300))
SSM_LIBRARY = ("none: no single PyTorch call computes a linear recurrence "
               "(torch.cumsum/cumprod are associative scans of one operator)")


def _ssm_inputs(torch, gen, b, t, d, n):
    """The layer's own distributions: a = exp(dt A) with dt = softplus(~-4.6)
    and A = -(1..N), b = dt B x, c = C, a non-zero h0."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((b, t, d), generator=gen, device=DEV) * 0.5
                    - 4.6)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=DEV)
    a = torch.exp(dt[..., None] * A)
    bb = dt[..., None] * torch.randn((b, t, 1, n), generator=gen, device=DEV) \
        * torch.randn((b, t, d, 1), generator=gen, device=DEV)
    c = torch.randn((b, t, n), generator=gen, device=DEV)
    h0 = torch.randn((b, d, n), generator=gen, device=DEV) * 0.5
    return a.contiguous(), bb.contiguous(), c, h0


def _split_scan(torch, a, bb, c, h0, chunk):
    """The scan as the engine's chunked prefill runs it: one launch per
    ``chunk`` steps, each resuming from the last launch's h_last, the
    ragged last chunk padded to ``chunk`` steps with identity steps (a = 1,
    b = 0, as ``mamba1_chunk`` makes a masked position)."""
    from repro_torch.kernels import ops
    bsz, t, d, n = a.shape
    ys, h = [], h0
    for s in range(0, t, chunk):
        at, bt, ct = a[:, s:s + chunk], bb[:, s:s + chunk], c[:, s:s + chunk]
        pad = chunk - at.shape[1]
        if pad:
            at = torch.cat([at, at.new_ones((bsz, pad, d, n))], dim=1)
            bt = torch.cat([bt, bt.new_zeros((bsz, pad, d, n))], dim=1)
            ct = torch.cat([ct, ct.new_zeros((bsz, pad, n))], dim=1)
        y, h = ops.ssm_scan(at, bt, ct, h)
        ys.append(y[:, :chunk - pad])
    return torch.cat(ys, dim=1), h


def check_ssm_scan(torch, results):
    """K7's unfused entries (a and b read from device memory, the TPU
    kernel's interface; gate-only rows since the Mamba1 layers call the
    fused entries) against their plain sequential version at the ssm path's
    shapes, row by row for y and h_last; one launch bitwise equal to the
    engine's split into chunks (state carried, identity-padded tail); three
    planted faults (h0 ignored, the last step dropped, one tile of d left
    unwritten) must fail the same gate.  Times: the kernel and the plain
    version from graph replay, the wrapper eagerly; bound = bytes of a, b,
    c, h0, y and h_last over 3.35 TB/s.  Then the unfused backward and
    checkpointing forward of the training shape (``_check_ssm_bwd``), and
    the fused entries the Mamba1 layers run (``_check_ssm_fused``,
    ``_check_ssm_fused_bwd``)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(9)
    d, n = SSM_D, SSM_N
    tile = 256 // n                  # the d values one block of the kernel owns
    for case, b, t in SSM_CASES:
        a, bb, c, h0 = _ssm_inputs(torch, gen, b, t, d, n)
        chunk = SSM_CHUNK if case == "chunked_ragged" else t

        def run(a=a, bb=bb, c=c, h0=h0):
            return ops.ssm_scan_chunked(a, bb, c, h0, chunk=chunk)
        y, h = run()
        ry, rh = ref.ssm_scan_ref(a, bb, c, h0)
        split_y, split_h = _split_scan(torch, a, bb, c, h0, chunk)
        bitwise = bool(torch.equal(y, split_y) and torch.equal(h, split_h))
        assert bitwise, f"ssm_scan {case}: one launch differs from the " \
            f"engine's split into chunks of {chunk}"
        fy0, fh0 = ops.ssm_scan(a, bb, c, torch.zeros_like(h0))
        a_drop, b_drop = a.clone(), bb.clone()
        a_drop[:, -1] = 1.0
        b_drop[:, -1] = 0.0
        fyd, fhd = ops.ssm_scan(a_drop, b_drop, c, h0)
        skip_y, skip_h = y.clone(), h.clone()
        skip_y[..., d // 2:d // 2 + tile] = 0
        skip_h[:, d // 2:d // 2 + tile] = 0
        gy = gate(f"ssm_scan {case} y", y, ry, {
            "h0_ignored": fy0, "last_step_dropped": fyd,
            "d_tile_skipped": skip_y})
        gh = gate(f"ssm_scan {case} h_last", h, rh, {
            "h0_ignored": fh0, "last_step_dropped": fhd,
            "d_tile_skipped": skip_h})
        nbytes = 4 * (2 * a.numel() + c.numel() + 2 * h0.numel() + y.numel())
        t_bound, by = bound(nbytes, 4.0 * a.numel() + 2.0 * y.numel() * n,
                            "float32")
        plain_reps = 20 if t == 1 else 2
        results.append(dict(
            name=f"ssm_scan/{case}", dtype="float32", path=None,
            shape=f"B={b} T={t} D={d} N={n} chunk={chunk}",
            max_abs_err=max(gy["max_abs_err"], gh["max_abs_err"]),
            row_rel_err=max(gy["row_rel_err"], gh["row_rel_err"]),
            tol=gy["tol"], y_gate=gy, h_last_gate=gh,
            one_launch_bitwise_split=bitwise,
            h_last_bitwise_plain=bool(torch.equal(h, rh)),
            kernel_ms=graph_ms(run), host_ms=host_ms(run),
            plain_ms=graph_ms(lambda: ref.ssm_scan_chunked_ref(
                a, bb, c, h0, chunk), reps=plain_reps),
            library_ms=None, library=SSM_LIBRARY,
            bound_ms=t_bound, bound_by=by))
        del a, bb, c, h0, a_drop, b_drop
    for case, b, t, d_, n_ in SSM_BWD_CASES:
        _check_ssm_bwd(torch, results, gen, case, b, t, d_, n_)
    for case, b, t in SSM_CASES:
        _check_ssm_fused(torch, results, gen, case, b, t)
    for case, b, t, d_, n_, dtype in SSM_FUSED_BWD_CASES:
        _check_ssm_fused_bwd(torch, results, gen, case, b, t, d_, n_,
                             getattr(torch, dtype))
    torch.cuda.empty_cache()


# K7's backward (and the checkpointing forward it rebuilds from): the
# training step of falcon-mamba-7b (B 8 x S 512, timed, the train_ssm path),
# then gate-only shapes no path gives: T = 1, a ragged T = 300 (the last
# window 12 of 16 steps), and N = 1, 4 and 32 at a small D (320: for N = 1
# two blocks, the second with 64 live d).  Each: (case, B, T, D, N).
SSM_BWD_CASES = (("train", 8, 512, SSM_D, SSM_N), ("t1", 8, 1, SSM_D, SSM_N),
                 ("ragged", 2, 300, SSM_D, SSM_N), ("n1", 2, 77, 320, 1),
                 ("n4", 2, 77, 320, 4), ("n32", 2, 77, 320, 32))
SSM_BWD_LIBRARY = ("none: no single PyTorch call computes the gradient of "
                   "a linear recurrence")


def _check_ssm_bwd(torch, results, gen, case, b, t, d, n):
    """K7's backward against ``ref.ssm_scan_bwd_ref`` row by row: da and db
    per (b, t, d) row over N, dc per (b, t) row, dh0 per (b, d) row, from a
    nonzero h0 and dh_last; da, db and dh0 must also equal the plain
    version bit for bit (the same rounding, step for step), and two
    launches each other.  Planted faults that must fail the same gate:
    dh_last ignored (da, db, dh0), h_t in place of h_{t-1} in da, and one
    block's partial (the middle one, 256 / N values of d) left out of dc's
    column sum.  The checkpointing forward must give the serve launch's
    bits and the plain version's states.  At the training shape, times:
    the backward and the checkpointing forward from graph replay (kernel
    and plain version), the wrappers eagerly; bound = bytes of a, b, the
    checkpoints, dy, c, dh_last in and da, db, dc, dh0 out (forward: a, b,
    c, h0 in, y, h_last and the checkpoints out) over 3.35 TB/s."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as k7
    a, bb, c, h0 = _ssm_inputs(torch, gen, b, t, d, n)
    dy = torch.randn((b, t, d), generator=gen, device=DEV)
    dh = torch.randn((b, d, n), generator=gen, device=DEV)
    y, h_last, ckpt = k7.ssm_scan_ckpt_kernel(a, bb, c, h0)
    sy, sh = k7.ssm_scan_kernel(a, bb, c, h0)
    ry, rh, rk = ref.ssm_scan_ckpt_ref(a, bb, c, h0, k7.WINDOW)
    assert torch.equal(y, sy) and torch.equal(h_last, sh), \
        f"ssm_scan {case}: the checkpointing forward differs from the scan"
    assert torch.equal(ckpt, rk) and torch.equal(h_last, rh), \
        f"ssm_scan {case}: checkpoints or h_last differ from the plain scan"
    del sy, sh
    got = k7.ssm_scan_bwd_kernel(a, bb, c, ckpt, dy, dh)
    again = k7.ssm_scan_bwd_kernel(a, bb, c, ckpt, dy, dh)
    bitwise = all(torch.equal(x, z) for x, z in zip(got, again))
    assert bitwise, f"ssm_scan_bwd {case}: two launches differ"
    del again
    want = ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh)
    names = ("da", "db", "dc", "dh0")
    exact = {nm: bool(torch.equal(x, z))
             for nm, x, z in zip(names, got, want)}
    assert exact["da"] and exact["db"] and exact["dh0"], \
        f"ssm_scan_bwd {case}: not the plain version's bits {exact}"
    tol = ref.ROW_TOL[torch.float32]
    gates = {nm: dict(zip(("max_abs_err", "row_rel_err"),
                          ref.row_rel_err(x, z)))
             for nm, x, z in zip(names, got, want)}
    for nm, g in gates.items():
        assert g["row_rel_err"] <= tol, f"ssm_scan_bwd {case} {nm}: {g}"
    tile = 256 // n                   # the d values of one block's partial
    mid = -(-d * n // 256) // 2 * tile
    faults = {"dh_last_ignored": (
                  ref.ssm_scan_bwd_ref(a, bb, c, h0, dy), (0, 1, 3)),
              "h_t_for_h_prev": (
                  ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh,
                                       prev_state=False), (0,)),
              "dc_block_dropped": (
                  ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh,
                                       drop_d=(mid, mid + tile)), (2,))}
    planted = {}
    for fault, (out, hit) in faults.items():
        planted[fault] = {names[i]: ref.row_rel_err(out[i], want[i])[1]
                          for i in hit}
        assert max(planted[fault].values()) > 4 * tol, \
            f"ssm_scan_bwd {case}: planted fault {fault} passes ({planted})"
    del faults, out
    row = dict(
        name=f"ssm_scan_bwd/{case}", dtype="float32", path=None,
        shape=f"B={b} T={t} D={d} N={n} window={k7.WINDOW}",
        max_abs_err=max(g["max_abs_err"] for g in gates.values()),
        row_rel_err=max(g["row_rel_err"] for g in gates.values()),
        tol=tol, gates=gates, bitwise_plain=exact,
        planted_fault_row_rel_err=planted, two_launches_bitwise=bitwise)
    if case == "train":
        fwd_bytes = 4 * (2 * a.numel() + c.numel() + 2 * h0.numel()
                         + y.numel() + ckpt.numel())
        f_bound, f_by = bound(fwd_bytes, 4.0 * a.numel() + 2.0 * y.numel()
                              * n, "float32")
        bwd_bytes = 4 * (4 * a.numel() + ckpt.numel() + dy.numel()
                         + 2 * c.numel() + 2 * h0.numel())
        b_bound, b_by = bound(bwd_bytes, 8.0 * a.numel(), "float32")
        gy = gate("ssm_scan train y", y, ry, {
            "h0_ignored": k7.ssm_scan_kernel(a, bb, c,
                                             torch.zeros_like(h0))[0]})
        results.append(dict(
            name="ssm_scan/train", dtype="float32", path=None,
            shape=f"B={b} T={t} D={d} N={n} window={k7.WINDOW} (checkpoints)",
            max_abs_err=gy["max_abs_err"], row_rel_err=gy["row_rel_err"],
            tol=gy["tol"], y_gate=gy, h_last_bitwise_plain=True,
            kernel_ms=graph_ms(lambda: k7.ssm_scan_ckpt_kernel(a, bb, c, h0),
                               reps=5),
            host_ms=host_ms(lambda: k7.ssm_scan_ckpt_kernel(a, bb, c, h0),
                            reps=2),
            plain_ms=graph_ms(lambda: ref.ssm_scan_ckpt_ref(
                a, bb, c, h0, k7.WINDOW), reps=1, samples=5),
            library_ms=None, library=SSM_LIBRARY, bound_ms=f_bound,
            bound_by=f_by, bytes=fwd_bytes))
        row.update(
            kernel_ms=graph_ms(lambda: k7.ssm_scan_bwd_kernel(
                a, bb, c, ckpt, dy, dh), reps=5),
            host_ms=host_ms(lambda: k7.ssm_scan_bwd_kernel(
                a, bb, c, ckpt, dy, dh), reps=2),
            plain_ms=graph_ms(lambda: ref.ssm_scan_bwd_ref(
                a, bb, c, h0, dy, dh), reps=1, samples=5),
            library_ms=None, library=SSM_BWD_LIBRARY, bound_ms=b_bound,
            bound_by=b_by, bytes=bwd_bytes)
    results.append(row)
    del a, bb, c, h0, dy, dh, y, ckpt, ry, rk, got, want
    torch.cuda.empty_cache()


# The fused entries (Mamba1's discretisation inside K7), which every Mamba1
# layer calls: the serve shapes in bf16 (the path's dtype; B and C slices of
# one projection as the layer hands them), then the training step's forward
# with checkpoints and backward (bf16, timed; at a rank's half of d_inner,
# 4,096 channels, on the 1x2 training mesh, the train_mesh_2 path, timed;
# again in f32, where the planted
# faults of its reductions are held at the f32 limit), and gate-only shapes
# no path gives, in f32: a ragged T = 300 and N = 1 and 32 at a small D.
# Each backward case: (case, B, T, D, N, dtype).
SSM_FUSED_BWD_CASES = (("train", 8, 512, SSM_D, SSM_N, "bfloat16"),
                       ("rank_half", 8, 512, SSM_D // 2, SSM_N, "bfloat16"),
                       ("train_f32", 8, 512, SSM_D, SSM_N, "float32"),
                       ("ragged", 2, 300, SSM_D, SSM_N, "float32"),
                       ("n1", 2, 77, 320, 1, "float32"),
                       ("n32", 2, 77, 320, 32, "float32"))
# the timed cases and the path each one's launches come from
SSM_FUSED_TIMED = {"train": "train_ssm", "rank_half": "train_mesh_2"}
# f32 operations a (b, t, d, n) beside its one expf: the forward rounds
# dt A, dt B, (dt B) x, a h, + b and h c (and sums y); the backward also
# rebuilds h from the checkpoints and forms g, u, v, d(dt)'s two products
# and sum, dx's two, dA's, dB's and dC's products, the carry and the sums
SSM_FUSED_FWD_OPS, SSM_FUSED_BWD_OPS = 7.0, 22.0


def _ssm_fused_inputs(torch, gen, b, t, d, n, dtype):
    """The layer's own tensors: dt = softplus(~-4.6) f32, A = -exp(log(1..N))
    as the layer's init, B and C slices of one (B, T, 8 + 2N) projection and
    x in ``dtype``, a non-zero h0."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((b, t, d), generator=gen, device=DEV) * 0.5
                    - 4.6)
    A = -torch.exp(torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=DEV)))[None, :].expand(d, n)
    proj = torch.randn((b, t, 8 + 2 * n), generator=gen,
                       device=DEV).to(dtype)
    x = torch.randn((b, t, d), generator=gen, device=DEV).to(dtype)
    h0 = torch.randn((b, d, n), generator=gen, device=DEV) * 0.5
    return dt, A.contiguous(), proj[..., 8:8 + n], proj[..., 8 + n:], x, h0


def _split_fused(torch, dt, A, bm, c, x, h0, chunk):
    """The fused scan as the engine's chunked prefill runs it: one launch
    per ``chunk`` steps, each resuming from the last launch's h_last, the
    ragged last chunk padded with masked steps (dt = 0, as ``mamba1_chunk``
    masks them; B, C and x there are whatever the pad holds)."""
    from repro_torch.kernels import ops
    bsz, t, d = dt.shape
    ys, h = [], h0
    for s in range(0, t, chunk):
        sl = slice(s, s + chunk)
        pad = chunk - dt[:, sl].shape[1]
        dtc, bc, cc, xc = dt[:, sl], bm[:, sl], c[:, sl], x[:, sl]
        if pad:
            dtc = torch.cat([dtc, dtc.new_zeros((bsz, pad, d))], dim=1)
            bc, cc, xc = (torch.cat([v, v.new_ones((bsz, pad, v.shape[2]))],
                                    dim=1) for v in (bc, cc, xc))
        y, h = ops.ssm_scan_fused(dtc, A, bc, cc, xc, h)
        ys.append(y[:, :chunk - pad])
    return torch.cat(ys, dim=1), h


def _check_ssm_fused(torch, results, gen, case, b, t):
    """The fused forward (``ops.ssm_scan_fused``, what the Mamba1 layers
    call) at a serve shape, bf16: y and h_last row by row against
    ``ref.ssm_scan_fused_ref`` (the discretisation in torch ops on the card,
    then the plain scan), two launches bitwise, one launch bitwise equal to
    the engine's split into masked chunks, and three planted faults (h0
    ignored, the last step masked, one tile of d unwritten) failing the same
    gate.  Recorded beside: whether it gives the bits of the unfused path it
    replaces (the discretisation in torch ops, then the unfused kernel) and
    by how much a row differs.  Times: the kernel, the plain version and the
    unfused path from graph replay, the wrapper eagerly; bound = the larger
    of the bytes of dt, x, B, C, A, h0, y and h_last over 3.35 TB/s, one
    expf a (b, t, d, n) over the SFUs' rate and ``SSM_FUSED_FWD_OPS`` f32
    operations a (b, t, d, n) over 67 TFLOP/s."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as k7
    d, n = SSM_D, SSM_N
    tile = 256 // n
    dt, A, bm, c, x, h0 = _ssm_fused_inputs(torch, gen, b, t, d, n,
                                            torch.bfloat16)
    chunk = SSM_CHUNK if case == "chunked_ragged" else t

    def run():
        return ops.ssm_scan_fused(dt, A, bm, c, x, h0)

    def unfused():
        a, bb = ref.ssm_discretise_ref(dt, A, bm, x)
        return k7.ssm_scan_kernel(a, bb, c.float(), h0)
    y, h = run()
    y2, h2 = run()
    repeat = bool(torch.equal(y, y2) and torch.equal(h, h2))
    assert repeat, f"ssm_scan_fused {case}: two launches differ"
    split_y, split_h = _split_fused(torch, dt, A, bm, c, x, h0, chunk)
    bitwise = bool(torch.equal(y, split_y) and torch.equal(h, split_h))
    assert bitwise, f"ssm_scan_fused {case}: one launch differs from the " \
        f"engine's split into masked chunks of {chunk}"
    ry, rh = ref.ssm_scan_fused_ref(dt, A, bm, c, x, h0)
    uy, uh = unfused()
    unfused_gap = max(ref.row_rel_err(y, uy)[1], ref.row_rel_err(h, uh)[1])
    fy0, fh0 = ops.ssm_scan_fused(dt, A, bm, c, x, torch.zeros_like(h0))
    dt_drop = dt.clone()
    dt_drop[:, -1] = 0.0
    fyd, fhd = ops.ssm_scan_fused(dt_drop, A, bm, c, x, h0)
    skip_y, skip_h = y.clone(), h.clone()
    skip_y[..., d // 2:d // 2 + tile] = 0
    skip_h[:, d // 2:d // 2 + tile] = 0
    gy = gate(f"ssm_scan_fused {case} y", y, ry, {
        "h0_ignored": fy0, "last_step_masked": fyd, "d_tile_skipped": skip_y})
    gh = gate(f"ssm_scan_fused {case} h_last", h, rh, {
        "h0_ignored": fh0, "last_step_masked": fhd, "d_tile_skipped": skip_h})
    del fy0, fh0, fyd, fhd, skip_y, skip_h, dt_drop, split_y, split_h
    elems = dt.numel() * n
    nbytes = 4 * dt.numel() + x.element_size() * (x.numel() + 2 * b * t * n) \
        + 4 * (A.numel() + 2 * h0.numel() + y.numel())
    t_bound, by = bound(nbytes, SSM_FUSED_FWD_OPS * elems, "float32",
                        sfu=elems)
    plain_reps = 20 if t == 1 else 2
    results.append(dict(
        name=f"ssm_scan_fused/{case}", dtype="bfloat16", path="ssm_serve",
        counter="ssm_scan",
        shape=f"B={b} T={t} D={d} N={n} chunk={chunk} (B, C, x bf16)",
        max_abs_err=max(gy["max_abs_err"], gh["max_abs_err"]),
        row_rel_err=max(gy["row_rel_err"], gh["row_rel_err"]),
        tol=gy["tol"], y_gate=gy, h_last_gate=gh,
        one_launch_bitwise_split=bitwise, two_launches_bitwise=repeat,
        h_last_bitwise_plain=bool(torch.equal(h, rh)),
        bitwise_unfused_path=bool(torch.equal(y, uy)
                                  and torch.equal(h, uh)),
        unfused_path_row_rel_err=unfused_gap,
        kernel_ms=graph_ms(run), host_ms=host_ms(run),
        plain_ms=graph_ms(lambda: ref.ssm_scan_fused_ref(
            dt, A, bm, c, x, h0), reps=plain_reps),
        unfused_path_ms=graph_ms(unfused, reps=plain_reps),
        library_ms=None, library=SSM_LIBRARY, bound_ms=t_bound, bound_by=by,
        bytes=nbytes, expf=elems))
    del dt, A, bm, c, x, h0, y, h, ry, rh, uy, uh


def _check_ssm_fused_bwd(torch, results, gen, case, b, t, d, n, dtype):
    """The fused forward with checkpoints and the fused backward (what
    ``SSMScanFusedFn`` launches in training) against their plain versions:
    the checkpointing forward gives the serve launch's bits and the plain
    checkpoints' states (row by row; bits recorded); d(dt), dA, dB, dC, dx
    and dh0 row by row against ``ref.ssm_scan_fused_bwd_ref`` from a
    nonzero h0 and dh_last, at the limit of each output's dtype, rows
    floored at ``ref.GRAD_ROW_FLOOR`` (bits recorded); two launches
    bitwise.  In f32, planted faults that must fail
    the same gate: dh_last ignored, one lane's term of d(dt) dropped, one
    batch row's dA partial dropped and one block's dB partial dropped.  At
    the training shape in bf16, times of both (kernel and plain version from
    graph replay, the wrappers eagerly, and the unfused path they replace:
    the discretisation in torch ops then the unfused forward; the unfused
    backward then the discretisation's chain rule in torch ops); bound =
    the larger of their bytes over 3.35 TB/s, one expf a (b, t, d, n) over
    the SFUs' rate and their f32 operations over 67 TFLOP/s.  The rows carry
    ptxas's register counts of the fused kernels at this N."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as k7
    dt, A, bm, c, x, h0 = _ssm_fused_inputs(torch, gen, b, t, d, n, dtype)
    dy = torch.randn((b, t, d), generator=gen, device=DEV)
    dh = torch.randn((b, d, n), generator=gen, device=DEV)
    y, h_last, ckpt = k7.ssm_scan_fused_ckpt_kernel(dt, A, bm, c, x, h0)
    sy, sh = k7.ssm_scan_fused_kernel(dt, A, bm, c, x, h0)
    assert torch.equal(y, sy) and torch.equal(h_last, sh), \
        f"ssm_scan_fused {case}: the checkpointing forward differs from " \
        "the scan"
    del sy, sh
    a, bb = ref.ssm_discretise_ref(dt, A, bm, x)
    ry, rh, rk = ref.ssm_scan_ckpt_ref(a, bb, c.float(), h0, k7.WINDOW)
    del a, bb
    f32_tol = ref.ROW_TOL[torch.float32]
    ckpt_gap = ref.row_rel_err(ckpt, rk)[1]
    assert ckpt_gap <= f32_tol, f"ssm_scan_fused {case}: ckpt {ckpt_gap}"
    ckpt_bitwise = bool(torch.equal(ckpt, rk))
    del rk
    got = k7.ssm_scan_fused_bwd_kernel(dt, A, bm, c, x, ckpt, dy, dh)
    again = k7.ssm_scan_fused_bwd_kernel(dt, A, bm, c, x, ckpt, dy, dh)
    repeat = all(torch.equal(g, z) for g, z in zip(got, again))
    assert repeat, f"ssm_scan_fused_bwd {case}: two launches differ"
    del again
    want = ref.ssm_scan_fused_bwd_ref(dt, A, bm, c, x, h0, dy, dh)
    names = ("ddt", "dA", "dB", "dC", "dx", "dh0")
    # rows floored at 1e-2 of the gradient's largest value: a dA, dB or dC
    # row of few values (N = 1) can be a sum that cancels to near zero,
    # where any two summation orders part by more than f32 reassociation
    # of the row's own size
    floor = ref.GRAD_ROW_FLOOR
    gates = {nm: dict(zip(("max_abs_err", "row_rel_err"),
                          ref.row_rel_err(g, w, floor)),
                      tol=ref.ROW_TOL[w.dtype])
             for nm, g, w in zip(names, got, want)}
    for nm, g in gates.items():
        assert g["row_rel_err"] <= g["tol"], \
            f"ssm_scan_fused_bwd {case} {nm}: {g}"
    exact = {nm: bool(torch.equal(g, w))
             for nm, g, w in zip(names, got, want)}
    planted = {}
    if dtype == torch.float32:
        tile = 256 // n                  # the d values of one block's partial
        mid = -(-d * n // 256) // 2 * tile
        faults = {"dh_last_ignored": (dict(), (0, 1, 5)),
                  "ddt_lane_dropped": (dict(drop_n=n // 2), (0,)),
                  "dA_batch_row_dropped": (dict(drop_b=b // 2), (1,)),
                  "dB_block_dropped": (dict(drop_d=(mid, mid + tile)), (2,))}
        for fault, (kw, hit) in faults.items():
            out = ref.ssm_scan_fused_bwd_ref(
                dt, A, bm, c, x, h0, dy,
                None if fault == "dh_last_ignored" else dh, **kw)
            planted[fault] = {names[i]: ref.row_rel_err(out[i], want[i],
                                                        floor)[1]
                              for i in hit}
            del out
            assert max(planted[fault].values()) > 4 * f32_tol, \
                f"ssm_scan_fused_bwd {case}: planted fault {fault} " \
                f"passes ({planted})"
    info = {fn: v for fn, v in ptxas_info("ssm_scan").items()
            if "fused" in fn and f"ILi{n}E" in fn}
    path = SSM_FUSED_TIMED.get(case)
    timed = path is not None
    row = dict(
        name=f"ssm_scan_fused_bwd/{case}", dtype=str(dtype).split(".")[1],
        path=path, counter="ssm_scan_bwd",
        shape=f"B={b} T={t} D={d} N={n} window={k7.WINDOW}",
        max_abs_err=max(g["max_abs_err"] for g in gates.values()),
        row_rel_err=max(g["row_rel_err"] for g in gates.values()),
        tol=max(g["tol"] for g in gates.values()), gates=gates,
        bitwise_plain=exact, planted_fault_row_rel_err=planted,
        two_launches_bitwise=repeat, ckpt_row_rel_err=ckpt_gap,
        ckpt_bitwise_plain=ckpt_bitwise, ptxas=info)
    if timed:
        esz = x.element_size()
        elems = dt.numel() * n
        io = 4 * dt.numel() + esz * x.numel()           # dt and x in
        fwd_bytes = io + esz * 2 * b * t * n + 4 * (
            A.numel() + 2 * h0.numel() + y.numel() + ckpt.numel())
        f_bound, f_by = bound(fwd_bytes, SSM_FUSED_FWD_OPS * elems,
                              "float32", sfu=elems)
        bwd_bytes = io + esz * 4 * b * t * n + 4 * (
            2 * A.numel() + ckpt.numel() + dy.numel() + 2 * h0.numel()
            + dt.numel()) + esz * x.numel()
        b_bound, b_by = bound(bwd_bytes, SSM_FUSED_BWD_OPS * elems,
                              "float32", sfu=elems)
        gy = gate("ssm_scan_fused train y", y, ry, {
            "h0_ignored": k7.ssm_scan_fused_kernel(
                dt, A, bm, c, x, torch.zeros_like(h0))[0]})
        cf = c.float()

        def old_fwd():
            a_, b_ = ref.ssm_discretise_ref(dt, A, bm, x)
            return k7.ssm_scan_ckpt_kernel(a_, b_, cf, h0)
        a, bb = ref.ssm_discretise_ref(dt, A, bm, x)
        uckpt = k7.ssm_scan_ckpt_kernel(a, bb, cf, h0)[2]

        def old_bwd():
            da, db, dc, dh0 = k7.ssm_scan_bwd_kernel(a, bb, cf, uckpt, dy, dh)
            return ref.ssm_discretise_bwd_ref(da, db, a, dt, A, bm, x), dc, dh0
        results.append(dict(
            name=f"ssm_scan_fused/{case}", dtype=row["dtype"], path=path,
            counter="ssm_scan",
            shape=f"B={b} T={t} D={d} N={n} window={k7.WINDOW} "
                  "(checkpoints; B, C, x bf16)",
            max_abs_err=gy["max_abs_err"], row_rel_err=gy["row_rel_err"],
            tol=gy["tol"], y_gate=gy, ckpt_row_rel_err=ckpt_gap,
            ckpt_bitwise_plain=ckpt_bitwise,
            h_last_bitwise_plain=bool(torch.equal(h_last, rh)),
            kernel_ms=graph_ms(lambda: k7.ssm_scan_fused_ckpt_kernel(
                dt, A, bm, c, x, h0), reps=5),
            host_ms=host_ms(lambda: k7.ssm_scan_fused_ckpt_kernel(
                dt, A, bm, c, x, h0), reps=2),
            plain_ms=graph_ms(lambda: ref.ssm_scan_ckpt_ref(
                *ref.ssm_discretise_ref(dt, A, bm, x), cf, h0, k7.WINDOW),
                reps=1, samples=5),
            unfused_path_ms=graph_ms(old_fwd, reps=1, samples=5),
            library_ms=None, library=SSM_LIBRARY, bound_ms=f_bound,
            bound_by=f_by, bytes=fwd_bytes, expf=elems, ptxas=info))
        row.update(
            kernel_ms=graph_ms(lambda: k7.ssm_scan_fused_bwd_kernel(
                dt, A, bm, c, x, ckpt, dy, dh), reps=5),
            host_ms=host_ms(lambda: k7.ssm_scan_fused_bwd_kernel(
                dt, A, bm, c, x, ckpt, dy, dh), reps=2),
            plain_ms=graph_ms(lambda: ref.ssm_scan_fused_bwd_ref(
                dt, A, bm, c, x, h0, dy, dh), reps=1, samples=5),
            unfused_path_ms=graph_ms(old_bwd, reps=1, samples=5),
            library_ms=None, library=SSM_BWD_LIBRARY, bound_ms=b_bound,
            bound_by=b_by, bytes=bwd_bytes, expf=elems)
        del a, bb, uckpt
    results.append(row)
    del dt, A, bm, c, x, h0, dy, dh, y, ckpt, ry, got, want
    torch.cuda.empty_cache()


# qwen3-0.6b's training step through K3: B 8 x 16 query heads over 8 KV
# heads (q 128 rows, k/v 64, GQA read in the kernel), S 512, head_dim 128,
# causal; then the gates at other shapes the kernel takes (no main path
# gives them, so they carry no times): zamba2's shared attention block
# (32 heads over 32, head_dim 80), a group of 8 among them, and head_dim 40
# (the bf16 kernels' zero columns up to their 64-wide tile).  Each entry:
# (q rows B*H, k/v rows B*KV, Sq, Skv, head_dim, causal, q_offset).
FLASH_TRAIN = (8 * 16, 8 * 8, 512, 512, 128, True, 0)
# zamba2-2.7b's training step through its shared block: B 8 x 32 heads over
# 32, S 512, head_dim 80, causal (timed, the train_hybrid path)
FLASH_HYBRID_TRAIN = (8 * 32, 8 * 32, 512, 512, 80, True, 0)
# olmoe-1b-7b's training step: B 8 x 16 heads over 16, S 512, head_dim 128,
# causal (timed, the train_moe path)
FLASH_MOE_TRAIN = (8 * 16, 8 * 16, 512, 512, 128, True, 0)
# whisper-small's training step (B 8 x 12 heads over 12, S 448 frames and
# tokens, head_dim 64): the decoder's causal self-attention, and the
# encoder's and the cross-attention's non-causal attention (Sq = Skv =
# 448 when frames and tokens are both 448 long); its serve path's encoder
# over 8 x 1,500 frames (forward only: serving has no backward); and
# qwen2-vl-72b's training step (B 8 x 64 heads over 8, S 512, head_dim
# 128, causal)
FLASH_WHISPER_CAUSAL = (8 * 12, 8 * 12, 448, 448, 64, True, 0)
FLASH_WHISPER = (8 * 12, 8 * 12, 448, 448, 64, False, 0)
FLASH_WHISPER_ENCODER = (8 * 12, 8 * 12, 1500, 1500, 64, False, 0)
FLASH_VLM_TRAIN = (8 * 64, 8 * 8, 512, 512, 128, True, 0)
# a rank's half of qwen3-0.6b's heads on the 1x2 training mesh (B 8 x 8
# heads over 4, S 512, head_dim 128, causal; the train_mesh_2 path)
FLASH_MESH_TRAIN = (8 * 8, 8 * 4, 512, 512, 128, True, 0)
# a rank's half of the heads on train_mesh_2's 1x2 family runs (B 2):
# zamba2's shared block (16 over 16, head_dim 80, S 512, causal) and
# whisper's (6 over 6, head_dim 64, S 448, causal and not)
FLASH_MESH_HYBRID = (2 * 16, 2 * 16, 512, 512, 80, True, 0)
FLASH_MESH_WHISPER_CAUSAL = (2 * 6, 2 * 6, 448, 448, 64, True, 0)
FLASH_MESH_WHISPER = (2 * 6, 2 * 6, 448, 448, 64, False, 0)
# the batch of a timed shape (SDPA's view), where it is not 8
FLASH_BATCH = {FLASH_MESH_HYBRID: 2, FLASH_MESH_WHISPER_CAUSAL: 2,
               FLASH_MESH_WHISPER: 2}
# (path, shape, whether the path runs the backward)
FLASH_TIMED = (("train", FLASH_TRAIN, True),
               ("train_hybrid", FLASH_HYBRID_TRAIN, True),
               ("train_moe", FLASH_MOE_TRAIN, True),
               ("train_whisper", FLASH_WHISPER_CAUSAL, True),
               ("train_whisper", FLASH_WHISPER, True),
               ("whisper_serve", FLASH_WHISPER_ENCODER, False),
               ("train_vlm", FLASH_VLM_TRAIN, True),
               ("train_mesh_2", FLASH_MESH_TRAIN, True),
               ("train_mesh_2", FLASH_MESH_HYBRID, True),
               ("train_mesh_2", FLASH_MESH_WHISPER_CAUSAL, True),
               ("train_mesh_2", FLASH_MESH_WHISPER, True))
# gate-only: whisper's cross-attention at serve time, the prompt's 4 and a
# training length's 448 queries over 1,500 frames (Sq != Skv, non-causal,
# 1,500 not a multiple of the 64-key tile)
FLASH_GATES = (("non_causal", 32, 16, 512, 512, 128, False, 0),
               ("cross_4x1500", 8 * 12, 8 * 12, 4, 1500, 64, False, 0),
               ("cross_448x1500", 8 * 12, 8 * 12, 448, 1500, 64, False, 0),
               ("q_offset", 32, 16, 128, 640, 128, True, 512),
               ("ragged", 32, 16, 300, 300, 128, True, 0),
               ("head_dim_256", 8, 8, 200, 200, 256, True, 0),
               ("head_dim_80", 2 * 32, 2 * 32, 512, 512, 80, True, 0),
               ("group_8", 64, 8, 512, 512, 128, True, 0),
               ("head_dim_40", 8, 4, 100, 100, 40, True, 3))
# SASS function-name fragments of K3's kernels by dtype and direction
K3_SASS = {("bfloat16", "forward"): ("flash_fwd_mma_kernel",),
           ("bfloat16", "backward"): ("flash_bwd_dkdv_mma_kernel",
                                      "flash_bwd_dq_mma_kernel"),
           ("float32", "forward"): ("flash_fwd_kernelIf",),
           ("float32", "backward"): ("flash_bwd_dkdv_kernelIf",
                                     "flash_bwd_dq_kernelIf")}


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, else the copy in Triton's package."""
    import importlib.util
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    from repro_torch.kernels import build
    path = Path(build.nvcc()).parent / "cuobjdump"
    if path.exists():
        return str(path)
    spec = importlib.util.find_spec("triton")
    assert spec is not None, "no cuobjdump in the CUDA toolkit or Triton"
    path = Path(spec.origin).parent / "backends/nvidia/bin/cuobjdump"
    assert path.exists(), f"no cuobjdump at {path}"
    return str(path)


def sass_mma(name: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of the built
    library ``name``, from ``cuobjdump -sass``: {function: count}."""
    from repro_torch.kernels import build
    out = subprocess.run([cuobjdump(), "-sass",
                          str(build.library_path(name))], check=True,
                         capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "MMA" in line and \
                ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def _k3_sass(counts, dname, direction) -> dict:
    """K3's tensor-core instruction counts for one row: each kernel of the
    row's dtype and direction, summed over its head_dim instances."""
    return {frag: sum(c for f, c in counts.items() if frag in f)
            for frag in K3_SASS[(dname, direction)]}


def _flash_case(torch, name, dtype, bh, bkv, sq, skv, hd, causal, off, gen):
    """Gate K3's forward (o, lse) and backward (dq, dk, dv) against the
    plain versions, with planted faults: the last kv tile dropped and the
    causal mask flipped (forward); the last 64 rows of dO zeroed, lse
    shifted by 0.5 and D computed from a zero O (backward; D does not reach
    dV).  q has ``bh`` rows and k/v ``bkv`` (GQA).  Two launches of each
    must be bitwise equal."""
    from repro_torch.kernels import flash_attention as k3, ref
    q, k, v, do = ((torch.randn((rows, n, hd), generator=gen, device=DEV))
                   .to(dtype) for rows, n in ((bh, sq), (bkv, skv),
                                              (bkv, skv), (bh, sq)))
    dname = str(dtype).split(".")[1]
    o, lse = k3.flash_attention_kernel(q, k, v, causal, off)
    ro, rlse = ref.flash_attention_ref(q, k, v, causal, off)
    cut = (skv - 1) // 64 * 64
    fo_cut, flse_cut = k3.flash_attention_kernel(
        q, k[:, :cut].contiguous(), v[:, :cut].contiguous(), causal, off)
    fo_flip, flse_flip = k3.flash_attention_kernel(q, k, v, not causal, off)
    go = gate(f"flash_attention {name} o {dname}", o, ro, {
        "last_kv_tile_dropped": fo_cut, "causal_flipped": fo_flip})
    gl = gate(f"flash_attention {name} lse {dname}", lse, rlse, {
        "last_kv_tile_dropped": flse_cut, "causal_flipped": flse_flip})
    grads = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    do_cut = do.clone()
    do_cut[:, -64:] = 0
    faults = (k3.flash_attention_bwd_kernel(q, k, v, o, lse, do_cut, causal,
                                            off),
              k3.flash_attention_bwd_kernel(q, k, v, o, lse + 0.5, do, causal,
                                            off),
              k3.flash_attention_bwd_kernel(q, k, v, torch.zeros_like(o), lse,
                                            do, causal, off))
    gg = {}
    for i, g in enumerate(("dq", "dk", "dv")):
        planted = {"do_last_rows_zeroed": faults[0][i],
                   "lse_shifted": faults[1][i]}
        if g != "dv":
            planted["D_from_zero_o"] = faults[2][i]
        gg[g] = gate(f"flash_attention {name} {g} {dname}", grads[i],
                     want[i], planted, floor=ref.GRAD_ROW_FLOOR,
                     tols=ref.GRAD_ROW_TOL)
    o2, lse2 = k3.flash_attention_kernel(q, k, v, causal, off)
    again = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    bitwise = bool(torch.equal(o, o2) and torch.equal(lse, lse2)
                   and all(torch.equal(a, b) for a, b in zip(grads, again)))
    assert bitwise, f"flash_attention {name} {dname}: two launches differ"
    shape = f"BH={bh} BKV={bkv} Sq={sq} Skv={skv} hd={hd} " \
        f"causal={causal} q_offset={off}"
    fwd = dict(name="flash_attention/forward", dtype=dname, shape=shape,
               o_gate=go, lse_gate=gl, two_launches_bitwise=bitwise,
               max_abs_err=max(go["max_abs_err"], gl["max_abs_err"]),
               row_rel_err=go["row_rel_err"], tol=go["tol"])
    bwd = dict(name="flash_attention/backward", dtype=dname, shape=shape,
               counter="flash_attention_bwd", two_launches_bitwise=bitwise,
               max_abs_err=max(x["max_abs_err"] for x in gg.values()),
               row_rel_err=max(x["row_rel_err"] for x in gg.values()),
               tol=gg["dq"]["tol"], floor=ref.GRAD_ROW_FLOOR,
               **{f"{g}_gate": x for g, x in gg.items()})
    return (q, k, v, do, o, lse), fwd, bwd


def _worst_row(torch, got, exact, floor):
    """(row_rel_err per row against ``exact`` with the floor) -> the worst
    row's (bh, row), its exact largest value, and how many rows exceed 2e-5
    and 4e-5."""
    diff = (got.double() - exact).abs().amax(-1)
    scale = exact.abs().amax(-1).clamp_min(floor * float(exact.abs().max()))
    rel = diff / scale.clamp_min(1e-300)
    j = int(rel.argmax())
    return {"worst_row": list(divmod(j, rel.shape[1])),
            "worst_row_exact_max": float(exact.abs().amax(-1).flatten()[j]),
            "rows_over_2e-5": int((rel > 2e-5).sum()),
            "rows_over_4e-5": int((rel > 4e-5).sum())}


def grad_witness(torch, q, k, v, do, o, lse, causal, off):
    """The f32 kernel and the f32 plain versions each against the plain
    versions in f64 on the same inputs (the kernel's o and lse widened for
    the backward), row by row with the gradient floor: the error of each
    f32 side alone, where each side's worst row lies and how many rows pass
    2e-5 and 4e-5; and, apart, how far the f32 rounding of o and lse moves
    the f64 backward (against one given the f64 forward's o and lse).  The
    kernel may be at most twice as far from f64 as the plain f32 version
    is, and within the gates' limits."""
    from repro_torch.kernels import flash_attention as k3, ref
    wide = [x.double() for x in (q, k, v, do, o, lse)]
    o64, lse64 = ref.flash_attention_ref(*wide[:3], causal, off)
    po, plse = ref.flash_attention_ref(q, k, v, causal, off)
    pairs = {"o": (o, po, o64, 0.0), "lse": (lse, plse, lse64, 0.0)}
    g64 = ref.flash_attention_bwd_ref(*wide[:3], wide[4], wide[5], wide[3],
                                      causal, off)
    g64f = ref.flash_attention_bwd_ref(*wide[:3], o64, lse64, wide[3],
                                       causal, off)
    g32 = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    gk = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    for i, name in enumerate(("dq", "dk", "dv")):
        pairs[name] = (gk[i], g32[i], g64[i], ref.GRAD_ROW_FLOOR)
    line = {}
    for name, (kern, plain, exact, floor) in pairs.items():
        line[name] = {
            "kernel_vs_f64": ref.row_rel_err(kern, exact, floor)[1],
            "plain_f32_vs_f64": ref.row_rel_err(plain, exact, floor)[1],
            "kernel_vs_plain_f32": ref.row_rel_err(kern, plain, floor)[1]}
        if name.startswith("d"):
            i = ("dq", "dk", "dv").index(name)
            line[name].update(
                kernel=_worst_row(torch, kern, exact, floor),
                plain_f32=_worst_row(torch, plain, exact, floor),
                f64_from_f32_forward_vs_f64_forward=ref.row_rel_err(
                    exact, g64f[i], floor)[1])
    emit({"phase": "flash_attention_grad_witness",
          "shape": f"BH={q.shape[0]} S={q.shape[1]} hd={q.shape[2]} "
                   f"causal={causal}", "floor": ref.GRAD_ROW_FLOOR, **line})
    for name, r in line.items():
        tol = (ref.GRAD_ROW_TOL if name.startswith("d")
               else ref.ROW_TOL)[torch.float32]
        assert r["kernel_vs_f64"] <= max(2 * r["plain_f32_vs_f64"], tol / 4), \
            f"flash_attention {name}: kernel {r['kernel_vs_f64']} from f64 " \
            f"against the plain f32 version's {r['plain_f32_vs_f64']}"
    del wide, g64, g64f, g32, gk
    torch.cuda.empty_cache()


def check_flash_attention(torch, results):
    """K3 at the training shapes (qwen3-0.6b's, zamba2-2.7b's shared
    block, olmoe-1b-7b's, whisper-small's causal and non-causal and
    qwen2-vl-72b's, f32 and bf16, timed), at whisper's encoder over 1,500
    frames (the serve path's forward; its backward gated, untimed) and at
    the gate-only shapes.  Times: kernel and plain version from graph
    replay, the wrapper eagerly; the library yardstick is SDPA (causal as
    the row is) on the same tensors
    viewed as (B, H, S, hd) and (B, KV, S, hd) with ``enable_gqa`` (or,
    where this torch lacks it, on K/V repeated to every head before the
    timed call), its forward and its forward + backward (``autograd.grad``
    of a fresh forward) from graph replay, the backward alone their
    difference.  Bound: q and o at the query heads, k and v at the KV heads
    (and lse) moved once over 3.35 TB/s forward; q, o, dO, dQ, k, v, dK,
    dV and lse backward; against 4 hd flops per (query, key) pair the mask
    leaves visible (all Sq x Skv where the row is not causal) forward, 10
    hd backward (S recomputed, dP, dV, dK, dQ), at the type's
    peak.  Each row carries ``sass_mma``: the tensor-core instructions in
    its dtype's kernels (bf16 must have them; f32 must not, or it would be
    TF32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3, ref
    gen = torch.Generator(device=DEV).manual_seed(3)
    counts = sass_mma("flash_attention")
    # SDPA is a builtin without a signature; its docstring names the option
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    extra = {"enable_gqa": True} if gqa else {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for path, shape, backward in FLASH_TIMED:
            bh, bkv, sq, skv, hd, causal, off = shape
            b = FLASH_BATCH.get(shape, 8)
            h, kvh = bh // b, bkv // b
            (q, k, v, do, o, lse), fwd, bwd = _flash_case(
                torch, path, dtype, bh, bkv, sq, skv, hd, causal, off, gen)
            # (query, key) pairs the mask leaves visible
            pairs = bh * (sum(min(skv, off + i + 1) for i in range(sq))
                          if causal else sq * skv)
            nq, nkv = bh * sq * hd, bkv * skv * hd
            f_bound, f_by = bound((2 * nq + 2 * nkv) * esize + bh * sq * 4,
                                  4.0 * hd * pairs, dname)
            b_bound, b_by = bound((4 * nq + 4 * nkv) * esize + bh * sq * 4,
                                  10.0 * hd * pairs, dname)
            if dtype == torch.float32 and path == "train":
                grad_witness(torch, q, k, v, do, o, lse, causal, off)
            q4, do4 = (x.view(b, h, -1, hd) for x in (q, do))
            k4, v4 = (x.view(b, kvh, -1, hd) if gqa
                      else x.view(b, kvh, -1, hd).repeat_interleave(
                          h // kvh, 1)
                      for x in (k, v))
            ql, kl, vl = (x.detach().clone().requires_grad_()
                          for x in (q4, k4, v4))
            library = "SDPA enable_gqa" if gqa else "SDPA on K/V repeated"
            fwd_ms = graph_ms(lambda: k3.flash_attention_kernel(
                q, k, v, causal, off))
            fwd.update(
                path=path, kernel_ms=fwd_ms,
                host_ms=host_ms(lambda: k3.flash_attention_kernel(
                    q, k, v, causal, off)),
                plain_ms=graph_ms(lambda: ref.flash_attention_ref(
                    q, k, v, causal, off), reps=2),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, **extra)),
                library=library, bound_ms=f_bound, bound_by=f_by,
                flops=4.0 * hd * pairs)
            results.append(fwd)
            if not backward:
                # gated, untimed: the path runs the forward alone
                results.append(dict(bwd, path=None))
                del q, k, v, do, o, lse, ql, kl, vl, q4, k4, v4, do4
                continue
            lib_fwd_grad = graph_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, **extra), reps=5)
            lib_fwd_bwd = graph_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                               **extra),
                (ql, kl, vl), do4), reps=5)
            bwd_ms = graph_ms(lambda: k3.flash_attention_bwd_kernel(
                q, k, v, o, lse, do, causal, off), reps=5)
            bwd.update(
                path=path, kernel_ms=bwd_ms,
                fwd_plus_bwd_ms=fwd_ms + bwd_ms,
                host_ms=host_ms(lambda: k3.flash_attention_bwd_kernel(
                    q, k, v, o, lse, do, causal, off), reps=2),
                plain_ms=graph_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, o, lse, do, causal, off), reps=2),
                library_ms=lib_fwd_bwd - lib_fwd_grad,
                library_fwd_bwd_ms=lib_fwd_bwd, library=library,
                bound_ms=b_bound, bound_by=b_by, flops=10.0 * hd * pairs)
            results.append(bwd)
            del q, k, v, do, o, lse, ql, kl, vl, q4, k4, v4, do4
        for name, *shape in FLASH_GATES:
            _, fwd, bwd = _flash_case(torch, name, dtype, *shape, gen)
            results.extend([dict(fwd, path=None), dict(bwd, path=None)])
    for r in results:
        if r["name"].startswith("flash_attention/"):
            r["sass_mma"] = _k3_sass(counts, r["dtype"],
                                     r["name"].split("/")[1])
            if r["dtype"] == "bfloat16":
                assert all(r["sass_mma"].values()), r["sass_mma"]
            else:
                assert not any(r["sass_mma"].values()), r["sass_mma"]
    torch.cuda.empty_cache()


# K2's backward at the training step's norm rows: the layer norms (4,096 x
# 1,024), the q norms (65,536 x 128) and the k norms (32,768 x 128); the
# train path runs the last two as one pair (``_check_rmsnorm_pair_grad``);
# then falcon-mamba-7b's layer norms (4,096 x 4,096, train_ssm) and
# zamba2-2.7b's (4,096 x 2,560) and gated norms (4,096 x 5,120,
# train_hybrid), olmoe-1b-7b's layer norms (4,096 x 2,048, train_moe),
# whisper-small's (B 8 x S 448 rows of 768, train_whisper) and
# qwen2-vl-72b's (4,096 x 8,192, train_vlm)
RMSNORM_GRAD_SHAPES = RMSNORM_TRAIN_SHAPES + ((4096, 4096), (4096, 2560),
                                              (4096, 5120), (4096, 2048),
                                              (8 * 448, 768), (4096, 8192),
                                              (2048, 1024))
RMSNORM_GRAD_PATH = {4096: "train_ssm", 2560: "train_hybrid",
                     5120: "train_hybrid", 2048: "train_moe",
                     768: "train_whisper", 8192: "train_vlm"}


def check_rmsnorm_grad(torch, results, info):
    """K2's backward (row pass and column pass) against its plain version
    (``ref.rmsnorm_bwd_ref``), dx row by row and dw as one row, with
    planted faults: g's rows shifted by one, dw without the last quarter of
    the rows, and two of the design's, dx without its mean term and dw
    without one middle row block of the column sum.  In bf16 those two are
    held at a margin of 1.5 times the limit, not 4: one of 256-512 row
    blocks moves dw by about 1/16-1/23 of its largest value, 2-4 times the
    bf16 limit (f32 keeps the margin of 4).  Two
    launches bitwise equal; ``RMSNormFn`` gives the kernel's bits.  The
    yardstick is autograd of ``F.rms_norm``: forward + backward less
    forward, both from graph replay."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k2
    gen = torch.Generator(device=DEV).manual_seed(4)
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        margin = 4.0 if dtype == torch.float32 else 1.5
        for rows, d in RMSNORM_GRAD_SHAPES:
            x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            w = (1 + 0.5 * torch.randn((d,), generator=gen, device=DEV)) \
                .to(dtype)
            g = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            name = f"rmsnorm bwd ({rows},{d}) {dname}"
            dx, dw = k2.rmsnorm_bwd_kernel(x, w, g, eps)
            again = k2.rmsnorm_bwd_kernel(x, w, g, eps)
            assert torch.equal(again[0], dx) and torch.equal(again[1], dw), \
                f"{name}: two launches differ"
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            fdx, fdw = torch.autograd.grad(k2.RMSNormFn.apply(xg, wg, eps),
                                           (xg, wg), g)
            assert torch.equal(fdx, dx) and torch.equal(fdw, dw), \
                f"{name}: RMSNormFn differs from the kernel"
            rdx, rdw = ref.rmsnorm_bwd_ref(x, w, g, eps)
            sdx, sdw = ref.rmsnorm_bwd_ref(x, w, g.roll(1, 0), eps)
            qdw = ref.rmsnorm_bwd_ref(x[:3 * rows // 4], w,
                                      g[:3 * rows // 4], eps)[1]
            ndx = ref.rmsnorm_bwd_ref(x, w, g, eps, mean_term=False)[0]
            rb = k2.block_rows(d, dtype)
            mid = -(-rows // rb) // 2
            bdw = ref.rmsnorm_bwd_ref(x, w, g, eps,
                                      drop_rows=(mid * rb, mid * rb + rb))[1]
            gx = gate(f"{name} dx", dx, rdx, {"g_rows_shifted": sdx})
            gw = gate(f"{name} dw", dw[None], rdw[None],
                      {"g_rows_shifted": sdw[None],
                       "last_quarter_dropped": qdw[None]})
            # the stateful widths split 4,096 rows into 1,024 blocks of 4:
            # one block moves dw by about 3% of its largest value and the
            # mean term dx by about 5%, 1.5-2.7 times the bf16 limit, so
            # those two design faults are held there in f32 (margin 4)
            design = dtype == torch.float32 \
                or (rows, d) in RMSNORM_TRAIN_SHAPES
            if design:
                gx["planted_fault_row_rel_err"].update(gate(
                    f"{name} dx", dx, rdx, {"no_mean_term": ndx},
                    margin=margin)["planted_fault_row_rel_err"])
                gw["planted_fault_row_rel_err"].update(gate(
                    f"{name} dw", dw[None], rdw[None],
                    {"one_row_block_dropped": bdw[None]},
                    margin=margin)["planted_fault_row_rel_err"])
            lib = lib_fwd = None
            if hasattr(F, "rms_norm"):
                xl, wl = x.clone().requires_grad_(), \
                    w.clone().requires_grad_()
                lib_fwd = graph_ms(lambda: F.rms_norm(xl, (d,), wl, eps))
                lib = graph_ms(lambda: torch.autograd.grad(
                    F.rms_norm(xl, (d,), wl, eps), (xl, wl), g)) - lib_fwd
            t_bound, by = bound(3 * rows * d * esize + 2 * d * esize,
                                10.0 * rows * d, "float32")
            results.append(dict(
                name=f"rmsnorm_bwd/d{d}", dtype=dname,
                shape=f"({rows}, {d})",
                path=RMSNORM_GRAD_PATH.get(d) or rmsnorm_path(rows, d),
                counter="rmsnorm_bwd",
                max_abs_err=max(gx["max_abs_err"], gw["max_abs_err"]),
                row_rel_err=max(gx["row_rel_err"], gw["row_rel_err"]),
                tol=gx["tol"], dx_gate=gx, dw_gate=gw, block_rows=rb,
                design_fault_margin=margin if design else "f32 rows only",
                bitwise_repeat=True,
                ptxas=k2_ptxas(info, ("rmsnorm_bwd_rows_kernel",
                                      "rmsnorm_bwd_cols_kernel"), dname),
                kernel_ms=graph_ms(lambda: k2.rmsnorm_bwd_kernel(x, w, g,
                                                                 eps)),
                host_ms=host_ms(lambda: k2.rmsnorm_bwd_kernel(x, w, g, eps)),
                plain_ms=graph_ms(lambda: ref.rmsnorm_bwd_ref(x, w, g, eps)),
                library_ms=lib, library_fwd_ms=lib_fwd,
                bound_ms=t_bound, bound_by=by))
            del x, g, dx, again, fdx, rdx, sdx, ndx, xg
        for shape in RMSNORM_PAIR_GRAD_SHAPES:
            _check_rmsnorm_pair_grad(torch, results, dtype, gen, eps, info,
                                     shape)
    torch.cuda.empty_cache()


def _check_rmsnorm_pair_grad(torch, results, dtype, gen, eps, info,
                             shape):
    """The pair's backward at a training step's q and k norms (``shape``:
    rows of q, rows of k, width and the path that gives them): each
    tensor's dx and dw bitwise its single call's (so the
    single rows' gates and planted faults hold for it), against the plain
    version; timed beside the
    two single calls, autograd of two ``F.rms_norm`` as yardstick.  Planted
    faults: dx with the two weights swapped, the two dw swapped."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k2
    dname = str(dtype).split(".")[1]
    esize = torch.finfo(dtype).bits // 8
    r1, r2, d, path = shape
    x1, g1 = (torch.randn((r1, d), generator=gen, device=DEV).to(dtype)
              for _ in range(2))
    x2, g2 = (torch.randn((r2, d), generator=gen, device=DEV).to(dtype)
              for _ in range(2))
    w1, w2 = ((1 + 0.5 * torch.randn((d,), generator=gen, device=DEV))
              .to(dtype) for _ in range(2))
    name = f"rmsnorm pair bwd ({r1}+{r2},{d}) {dname}"
    got = k2.rmsnorm_pair_bwd_kernel(x1, w1, g1, x2, w2, g2, eps)
    one = k2.rmsnorm_bwd_kernel(x1, w1, g1, eps) \
        + k2.rmsnorm_bwd_kernel(x2, w2, g2, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, one)), \
        f"{name}: not its single calls"
    want = ref.rmsnorm_bwd_ref(x1, w1, g1, eps) \
        + ref.rmsnorm_bwd_ref(x2, w2, g2, eps)
    swapped = ref.rmsnorm_bwd_ref(x1, w2, g1, eps)[0], \
        ref.rmsnorm_bwd_ref(x2, w1, g2, eps)[0]
    gx = gate(f"{name} dx", torch.cat([got[0], got[2]]),
              torch.cat([want[0], want[2]]),
              {"weights_swapped": torch.cat(swapped)})
    gw = gate(f"{name} dw", torch.stack([got[1], got[3]]),
              torch.stack([want[1], want[3]]),
              {"segments_swapped": torch.stack([want[3], want[1]])})

    def singles():
        k2.rmsnorm_bwd_kernel(x1, w1, g1, eps)
        k2.rmsnorm_bwd_kernel(x2, w2, g2, eps)
    lib = lib_fwd = None
    if hasattr(F, "rms_norm"):
        leaves = [t.clone().requires_grad_() for t in (x1, w1, x2, w2)]

        def lib_f():
            return (F.rms_norm(leaves[0], (d,), leaves[1], eps),
                    F.rms_norm(leaves[2], (d,), leaves[3], eps))
        lib_fwd = graph_ms(lib_f)
        lib = graph_ms(lambda: torch.autograd.grad(
            lib_f(), leaves, (g1, g2))) - lib_fwd
    t_bound, by = bound(3 * (r1 + r2) * d * esize + 4 * d * esize,
                        10.0 * (r1 + r2) * d, "float32")
    results.append(dict(
        name=f"rmsnorm_pair_bwd/d{d}", dtype=dname, shape=f"({r1}+{r2}, {d})",
        path=path, counter="rmsnorm_bwd",
        max_abs_err=max(gx["max_abs_err"], gw["max_abs_err"]),
        row_rel_err=max(gx["row_rel_err"], gw["row_rel_err"]),
        tol=gx["tol"], dx_gate=gx, dw_gate=gw, bitwise_single_calls=True,
        ptxas=k2_ptxas(info, ("rmsnorm_bwd_rows_kernel",
                              "rmsnorm_bwd_cols_kernel"), dname),
        kernel_ms=graph_ms(lambda: k2.rmsnorm_pair_bwd_kernel(
            x1, w1, g1, x2, w2, g2, eps)),
        host_ms=host_ms(lambda: k2.rmsnorm_pair_bwd_kernel(
            x1, w1, g1, x2, w2, g2, eps)),
        singles_ms=graph_ms(singles), singles_host_ms=host_ms(singles),
        plain_ms=graph_ms(lambda: (ref.rmsnorm_bwd_ref(x1, w1, g1, eps),
                                   ref.rmsnorm_bwd_ref(x2, w2, g2, eps))),
        library_ms=lib, library_fwd_ms=lib_fwd, bound_ms=t_bound,
        bound_by=by))


# ---------------------------------------------------------------------------
# Phase 4: compile
# ---------------------------------------------------------------------------

def _term_inputs(torch, term, gen, dtype, scale=0.1):
    shapes = {}

    def walk(t):
        if t.op == "input":
            shapes[t.attr("name")] = t.attr("shape")
        for c in t.children:
            walk(c)
    walk(term)
    return {n: (torch.randn(s, generator=gen, device=DEV) * scale).to(dtype)
            for n, s in shapes.items()}


def compile_phase(torch, cfg, calls=4):
    """The compile pipeline's entry point on the H100 record: the engine's
    full-width decode attention term and a SwiGLU MLP term with kernels on
    run the matmul kernel (two launches per call each); the prefill-chunk
    term compiles to the packed path.  Every program is held to the same
    term with kernels off, row by row in bf16."""
    from repro_torch.core.codegen import compile_term, paged_pages_per_fetch
    from repro_torch.core.tensor_ir import inp, matmul, unary
    from repro_torch.kernels import ref
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.pipeline import CompileOptions, CompileTarget, Compiler
    from repro_torch.serve.engine import (chunked_prefill_attention_term,
                                          paged_decode_attention_term)
    hd, span, chunk = cfg.resolved_head_dim, 2048, 256
    x = inp("x", (chunk, cfg.d_model))
    mlp = matmul(unary(matmul(x, inp("w_up", (cfg.d_model, cfg.d_ff))),
                       kind="silu"), inp("w_down", (cfg.d_ff, cfg.d_model)))
    engine_opts = dict(extraction="greedy", schedule_iterations=10)
    cases = (
        ("decode", paged_decode_attention_term(span, hd),
         CompileOptions(**engine_opts), 2),
        ("mlp", mlp, CompileOptions(vectorize=False, **engine_opts), 2),
        ("prefill", chunked_prefill_attention_term(chunk, span, hd),
         CompileOptions(), 0),
    )
    gen = torch.Generator(device=DEV).manual_seed(3)
    compiler = Compiler(cache_dir=None)
    dtype = torch.bfloat16
    zero_counts()
    compiled = []
    out = {"phase": "compile", "hardware": CompileTarget().hardware.name,
           "terms": {}}
    for name, term, opts, per_call in cases:
        on = compiler.compile(term, target=CompileTarget(use_kernels=True),
                              options=opts)
        off = compiler.compile(term, target=CompileTarget(), options=opts)
        env = _term_inputs(torch, term, gen, dtype)
        plain = compile_term(term)(**env)
        n0 = mm_mod.launches
        for _ in range(calls):
            got = on(**env)
        torch.cuda.synchronize()
        launched = mm_mod.launches - n0
        assert launched == per_call * calls, (name, launched)
        want = off(**env)
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        err, rel = ref.row_rel_err(got, want)
        tol = ref.ROW_TOL[dtype]
        assert rel <= tol, f"compile {name}: row rel err {rel} > {tol}"
        rel_plain = ref.row_rel_err(got, plain)[1]
        assert rel_plain <= tol, f"compile {name}: vs plain {rel_plain}"
        rep = on.report
        out["terms"][name] = {
            "options": repr(opts), "packed": on.term != on.logical_term,
            "matmul_launches_per_call": launched / calls,
            "row_rel_err_vs_kernels_off": rel,
            "row_rel_err_vs_plain": rel_plain, "max_abs_err": err,
            "compile_s": rep.total_seconds, "pass_s": rep.pass_times,
            "modeled_speedup": rep.modeled_speedup,
            "schedule": {k: v for k, v in (rep.schedule or {}).items()
                         if k != "groups"},
            "kernel_plan": repr(rep.kernel_plan),
            "summary": rep.summary().splitlines()}
        compiled.append((name, on, off, env))
    launches = read_counts()
    assert launches["matmul"] > 0, launches
    plan = compiled[0][1].report.kernel_plan
    out.update(launches=launches,
               pages_per_fetch=paged_pages_per_fetch(plan, 16, span // 16))
    # device time of each compiled program, kernels on and off (after the
    # counts are read: timing launches do not count)
    for name, on, off, env in compiled:
        out["terms"][name]["kernels_on_ms"] = graph_ms(lambda: on(**env))
        out["terms"][name]["kernels_off_ms"] = graph_ms(lambda: off(**env))
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: serve
# ---------------------------------------------------------------------------

def workload(vocab, n=16, seed=0, tenants=(None,)):
    """``n`` requests, prompts of 128-1024 tokens, every third opening with
    one shared 256-token prefix, every third sampled, 32 new tokens each;
    request i is served by ``tenants[i % len(tenants)]``."""
    from repro_torch.serve.engine import Request, SamplingParams
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=256).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(128, 1025))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        if i % 3 == 0:
            prompt = shared + prompt[256:] if plen > 256 else shared[:plen]
        sp = SamplingParams(temperature=0.8, top_k=40, seed=i) \
            if i % 3 == 1 else SamplingParams()
        reqs.append(Request(rid=i, prompt=prompt, max_new=32, sampling=sp,
                            adapter_id=tenants[i % len(tenants)]))
    return reqs


def serve_engine(cfg, params, **kw):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=16,
                       prefill_chunk_tokens=256, **kw)


def warm_up(eng, adapter_ids=(None, None)):
    """Serve one short request a given adapter id (cuBLAS handles, the LoRA
    kernels for a tenant's request), then drop the prefixes it registered
    and zero the engine's metrics."""
    from repro_torch.serve.engine import Request
    vocab = eng.cfg.vocab
    for i, adapter_id in enumerate(adapter_ids):
        eng.submit(Request(rid=1000 + i, max_new=4, adapter_id=adapter_id,
                           prompt=[1 + t % (vocab - 1)
                                   for t in range(300 + i)]))
    eng.run_until_done()
    eng.release_prefix_cache()
    eng.reset_metrics()


def wrap_dispatches(eng, counted) -> None:
    """Route each of the engine's model calls through ``counted(kind,
    batch, call)`` ("prefill" or "decode"), which must return ``call()``
    (a sharded engine's ``shard`` passes through)."""
    fns = eng.fns

    def prefill(p, c, b, m_used=None, **kw):
        return counted("prefill", b, lambda: fns.prefill_chunk(
            p, c, b, m_used=m_used, **kw))

    def decode(p, c, b, **kw):
        return counted("decode", b, lambda: fns.decode_paged(p, c, b, **kw))
    eng.fns = dataclasses.replace(fns, prefill_chunk=prefill,
                                  decode_paged=decode)


def run_workload(torch, eng, reqs, counted=None):
    """Warm the engine up on two short requests (``warm_up``, with the
    first two requests' adapters), zero every launch count, serve ``reqs``
    checking the KV invariants after every step, and read the counts.  Each
    dispatch goes through ``counted`` (``wrap_dispatches``)."""
    warm_up(eng, [r.adapter_id for r in reqs[:2]])
    if counted is not None:
        wrap_dispatches(eng, counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    check_s = 0.0
    while eng.step():
        t1 = time.perf_counter()
        violations = eng.check_invariants()
        check_s += time.perf_counter() - t1
        assert violations == [], violations
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    m = eng.metrics()
    assert all(r.done and not r.rejected and len(r.out) == r.max_new
               for r in reqs), [r.finish_reason for r in reqs]
    assert m.requests_finished == len(reqs)
    # a stateful engine's slab holds no slot once every request retired
    assert eng.state_store is None \
        or eng.state_store.device.pool.num_used == 0
    return launches, m, {
        "requests": len(reqs), "engine_steps": eng.steps, "wall_s": wall,
        "invariant_check_s": check_s, "tokens_per_sec": m.tokens_per_sec,
        "ttft_mean_s": m.ttft_mean_s, "ttft_max_s": m.ttft_max_s,
        "itl_mean_s": m.itl_mean_s, "prefill_tokens": m.prefill_tokens,
        "decode_tokens": m.decode_tokens,
        "peak_blocks_used": m.peak_blocks_used,
        "pool_blocks": m.pool_blocks, "shared_blocks": m.shared_blocks,
        "re_prefill_avoided": m.re_prefill_avoided,
        "preemptions": m.preemptions,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "launches_per_step": {k: v / eng.steps for k, v in launches.items()}}


def dispatch_timer():
    """A ``counted`` hook for ``run_workload`` and its tally: dispatches by
    kind ("decode"/"prefill") and by whether they hold an adapter row, with
    the host seconds of each model call (it launches its kernels and
    returns: nothing in it waits for the card)."""
    tally = {}

    def counted(kind, batch, call):
        t0 = time.perf_counter()
        out = call()
        key = f"{kind}_{'lora' if 'lora' in batch else 'base'}"
        n, sec = tally.get(key, (0, 0.0))
        tally[key] = (n + 1, sec + time.perf_counter() - t0)
        return out
    return tally, counted


def host_ms_per_dispatch(tally) -> dict:
    return {k: {"dispatches": n, "host_ms": 1e3 * sec / n}
            for k, (n, sec) in sorted(tally.items())}


def k2_per_model_call(cfg) -> int:
    """K2 launches of one dense model call: ln1, ln2 and (with qk-norm) the
    q/k pair each layer, and the final norm."""
    return (3 if cfg.qk_norm else 2) * cfg.n_layers + 1


def serve_phase(torch, cfg, params):
    """The main path: 16 base requests, every kernel of the path launched,
    K2 exactly ``k2_per_model_call`` times a dispatch (85 for qwen3-0.6b)
    and its backward never; the host time of each dispatch."""
    eng = serve_engine(cfg, params)
    assert eng.kernel_plan is not None
    tally, counted = dispatch_timer()
    reqs = workload(cfg.vocab)
    launches, _, out = run_workload(torch, eng, reqs, counted)
    out["host_ms_per_dispatch"] = host_ms_per_dispatch(tally)
    calls = sum(n for n, _ in tally.values())
    out["k2_launches_per_model_call"] = launches["rmsnorm"] / calls
    assert launches["paged_attention"] > 0 and launches["rmsnorm"] \
        == k2_per_model_call(cfg) * calls, (launches, calls)
    assert launches["lora_shrink"] == launches["lora_expand"] \
        == launches["lora_delta"] == launches["rmsnorm_bwd"] == 0, launches
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype, **out,
          "pages_per_fetch": eng.pages_per_fetch,
          "kernel_plan": repr(eng.kernel_plan),
          "compile_report_decode": eng.compile_report.summary().splitlines()})
    del eng
    torch.cuda.empty_cache()
    return launches, out, [list(r.out) for r in reqs]


# ---------------------------------------------------------------------------
# Multi-device serving: the engine on a serve mesh of torch.distributed ranks
# ---------------------------------------------------------------------------

# serve_mesh_2: full width at 4 of qwen3-0.6b's 28 layers (8 until the
# training mesh's phase needed the time), 8 requests of the serve workload
# cut to their first 256 prompt tokens (one chunk), 16 new tokens.  gloo stages every collective through host memory (a 256 MB
# all_gather took 0.55 s on the card), and identity mode gathers a rank's
# missing half of every weight, the 151,936 x 1,024 table twice, each model
# call: about 0.4 GB a rank a call
MESH_LAYERS, MESH_REQUESTS, MESH_NEW, MESH_PROMPT = 4, 8, 16, 256


def mesh_workload(vocab):
    return [dataclasses.replace(r, prompt=r.prompt[:MESH_PROMPT],
                                max_new=MESH_NEW)
            for r in workload(vocab, n=MESH_REQUESTS)]


def serve_mesh_phase(torch, cfg, params, base_tokens):
    """serve_mesh: the serve workload through an engine on a 1-rank NCCL
    mesh with TP identity (the weights gathered at every use, the KV pool a
    rank's): the serve phase's tokens exactly, K1 and K2 as many launches a
    model call (28 and 85)."""
    import tempfile
    from repro_torch.launch.mesh import make_serve_mesh, process_group
    backend = "nccl" if DEV == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp, \
            process_group(0, 1, backend, os.path.join(tmp, "store"), DEV):
        eng = serve_engine(cfg, params, mesh=make_serve_mesh(1), tp=True)
        tally, counted = dispatch_timer()
        reqs = workload(cfg.vocab)
        launches, m, out = run_workload(torch, eng, reqs, counted)
        eng.close()
    calls = sum(n for n, _ in tally.values())
    tokens = [list(r.out) for r in reqs]
    emit({"phase": "serve_mesh", "arch": cfg.name, "dtype": cfg.dtype,
          "backend": backend, "world": 1, "tp": True, **out,
          "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "mesh_devices": m.mesh_devices, "tp_devices": m.tp_devices,
          "param_bytes_per_device": m.param_bytes_per_device,
          "tokens_identical_to_serve": tokens == base_tokens})
    assert tokens == base_tokens, "serve_mesh tokens differ from serve's"
    assert launches["paged_attention"] == cfg.n_layers * calls \
        and launches["rmsnorm"] == k2_per_model_call(cfg) * calls, \
        (launches, calls)
    return launches


def _mesh_serve(eng, reqs):
    """Rank 0 serves ``reqs`` (the other ranks follow), the invariants
    checked after every step on every rank; tokens by rid."""
    bad = []

    def check():
        bad.extend(eng.check_invariants())
    if eng.is_leader:
        for r in reqs:
            eng.submit(r)
        try:
            while eng.step():
                check()
        finally:
            eng.close()
    else:
        eng.follow(check)
    assert bad == [], bad
    return {r.rid: list(r.out) for r in eng.finished}


def _mesh_rank(mesh, device, cfg, moe_cfg, train_cfg, workdir):
    """One rank of serve_mesh_2, moe_mesh_2, gateway_mesh_2 and
    train_mesh_2, in that order, in one group of ranks (see
    ``serve_mesh_2_phase``): each part's results under its phase's name;
    the gateway serves the first two parts' weights."""
    import torch
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.rank}
    t0 = time.perf_counter()
    with torch.no_grad():
        fns = build_model(cfg, device)
        params = fns.init(0)
        out["serve_mesh_2"] = _serve_mesh_rank(mesh, device, cfg, fns,
                                               params)
        t1 = time.perf_counter()
        mfns = build_model(moe_cfg, device)
        mparams = mfns.init(0)
        out["moe_mesh_2"] = _moe_mesh_rank(mesh, device, moe_cfg, mfns,
                                           mparams)
    t2 = time.perf_counter()
    out["gateway_mesh_2"] = _gateway_mesh_rank(mesh, device, cfg, params,
                                               moe_cfg, mparams)
    del params, mparams
    t3 = time.perf_counter()
    out["train_mesh_2"] = _train_mesh_rank(mesh, device, train_cfg, workdir)
    out["part_s"] = {"serve_mesh_2": t1 - t0, "moe_mesh_2": t2 - t1,
                     "gateway_mesh_2": t3 - t2,
                     "train_mesh_2": time.perf_counter() - t3}
    return out


# train_mesh_2: qwen3-0.6b at full width and 2 of 28 layers in f32 (B 8 x S
# 512) on the 2-rank group: (run, (data, model), knobs, steps); the restart
# fails at step TRAIN_MESH_FAIL_AT (checkpoints every step) and is held
# bitwise to the first run.  SP, dp and REPRO_WEIGHT_AG=1 (held to the
# first run's bits after its first step) take 1 step for the
# script's time (PERF.md section 4): a 1-step run still holds the
# gradient's scale through its gated norm, while AdamW's first update
# shows only its sign
TRAIN_MESH_LAYERS = 2
TRAIN_MESH_RUNS = (
    ("fsdp_tp_2x1", (2, 1), {}, 2),
    ("weight_ag_2x1", (2, 1), {"REPRO_WEIGHT_AG": "1"}, 1),
    ("restart_2x1", (2, 1), {}, 2),
    ("fsdp_tp_1x2", (1, 2), {}, 2),
    ("seq_parallel_1x2", (1, 2), {"REPRO_SEQ_PARALLEL": "1"}, 1),
    ("dp_2x1", (2, 1), {"REPRO_TRAIN_SHARDING": "dp"}, 1))
TRAIN_MESH_FAIL_AT = 1
# a mesh run against one device's (the train_oracle gates: AdamW divides by
# sqrt(v), so a gradient near zero amplifies a reordered sum); each step's
# gradient norm is held to the loss tolerance
TRAIN_MESH_LOSS_TOL, TRAIN_MESH_LEAF_TOL = 1e-4, 1e-3
# then, in the same group, the stateful and encoder-decoder families at full
# width in f32, cut in depth (``family_mesh_cfg``: falcon-mamba-7b 1 Mamba1
# layer, zamba2-2.7b 2 segments of 1 Mamba2 layer, the shared block at both
# call sites, whisper-small 2 + 2 layers), B 2 x S 512 (whisper S 448):
# (run, arch, (data, model), steps, moments).  Each run takes 1 step for
# the script's time (PERF.md section 4) and is held by its loss, gradient
# norm and first gradients; the int8 run also by its moments after the
# update, each value within one quantization step (its block's scale) of
# one device's.  Its weights are reported, not gated: where v quantizes to
# 0 the update divides m by eps, so a gradient's reordered sum, or m's
# rounding flipped by one, moves a weight by up to lr / eps times the
# difference (ROADMAP C0)
FAMILY_MESH_RUNS = (
    ("falcon_fsdp_tp_1x2", "falcon-mamba-7b", (1, 2), 1, "f32"),
    ("falcon_int8_2x1", "falcon-mamba-7b", (2, 1), 1, "int8"),
    ("zamba2_fsdp_tp_1x2", "zamba2-2.7b", (1, 2), 1, "f32"),
    ("whisper_fsdp_tp_2x1", "whisper-small", (2, 1), 1, "f32"),
    ("whisper_fsdp_tp_1x2", "whisper-small", (1, 2), 1, "f32"))
FAMILY_MESH_BATCH = 2
# train_mesh_2's zamba2 leaf gaps, held after train_hybrid_oracle sets the
# hybrid's limit (``hybrid_mesh_gate``)
HYBRID_MESH_LEAVES = {}


def family_mesh_cfg(arch):
    """A family's train_mesh_2 config: full width, f32, cut in depth."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=2, hybrid=dataclasses.replace(
            cfg.hybrid, attn_every=1))
    return at_depth(cfg, 1 if cfg.family == "ssm" else 2)


def family_seq(cfg) -> int:
    return WHISPER_TRAIN_SEQ if cfg.family == "audio" else 512


def _family_trainer(cfg, steps, opt_state, device, mesh=None):
    """A family run's Trainer (B 2, its sequence, the train phase's
    optimizer with ``opt_state`` moments), on ``mesh`` if given, keeping
    its first gradients (``_keep_first_grads``)."""
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr = Trainer(cfg, TrainerConfig(seq_len=family_seq(cfg),
                                    global_batch=FAMILY_MESH_BATCH,
                                    steps=steps, log_every=1),
                 opt_config(TRAIN_LR, TRAIN_STEPS, opt_state), mesh=mesh,
                 device=device)
    return _keep_first_grads(tr, mesh)


def _keep_first_grads(tr, mesh=None):
    """``tr`` with its optimizer's update wrapped to keep the whole
    gradients of the first step (``tr.first_step_grads``), before AdamW
    turns a gradient near zero into a step of about lr."""
    from repro_torch.distributed import sharding
    from repro_torch.train.tree import leaves
    update = tr.opt.update
    tr.first_step_grads = None

    def first(grads, state, params, layout=None):
        if tr.first_step_grads is None:
            before = None if mesh is None else mesh.issued
            g = grads if mesh is None else sharding.unshard_tree(
                grads, layout.params, mesh)
            tr.first_step_grads = [t.clone() for t in leaves(g)]
            if mesh is not None:
                tr.check_issued = _issued_since(mesh, before)
        return update(grads, state, params, layout=layout)
    tr.opt.update = first
    return tr


def _keep_first_step(tr, mesh):
    """``tr`` with its step wrapped to keep the whole weights after the
    first step (``tr.first_step_params``)."""
    from repro_torch.distributed import sharding
    from repro_torch.train.tree import leaves
    step = tr._step
    tr.first_step_params = None

    def first(*args):
        res = step(*args)
        if tr.first_step_params is None:
            before = mesh.issued
            p = sharding.unshard_tree(res[0], tr.layout.params, mesh)
            tr.first_step_params = [t.clone() for t in leaves(p)]
            tr.check_issued = _issued_since(mesh, before)
        return res
    tr._step = first
    return tr


def _issued_since(mesh, before) -> dict:
    """The collectives ``mesh`` issued since its ``issued`` was
    ``before`` (a check's own gathers, kept out of a step's count)."""
    return {k: [a - b for a, b in zip(v, before[k])]
            for k, v in mesh.issued.items()}


def collectives_per_step(issued, steps, tr) -> dict:
    """A run's ``TrainMesh.issued`` a step by kind, [calls, bytes], less
    the gathers a first-step check added (``tr.check_issued``)."""
    extra = getattr(tr, "check_issued", {})
    return {k: [(v[0] - extra.get(k, [0, 0])[0]) / steps,
                (v[1] - extra.get(k, [0, 0])[1]) / steps]
            for k, v in issued.items()}


def _family_oracle(arch, opt_state, steps, device):
    """One device's run of a family (``FAMILY_MESH_RUNS``' settings): its
    losses, gradient norms, first gradients, weights and int8 moments."""
    from repro_torch.train.tree import leaves
    tr = _family_trainer(family_mesh_cfg(arch), steps, opt_state, device)
    res = tr.train()
    st = res["state"]
    return {"losses": [e["loss"] for e in res["log"]],
            "grad_norms": [e["grad_norm"] for e in res["log"]],
            "params": leaves(st["params"]), "grads": tr.first_step_grads,
            "moments": leaves([st["opt"]["m"], st["opt"]["v"]])
            if opt_state == "int8" else None}


def _gaps(got, want) -> list:
    """Each leaf's largest gap over the leaf's largest value (on the
    leaves' device)."""
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def _leaf_rel(got, want) -> float:
    return max(_gaps(got, want))


def _worst(gaps, names) -> str:
    return names[max(range(len(gaps)), key=gaps.__getitem__)]


def _moment_steps(got, want) -> float:
    """The largest gap between two int8 moments' dequantized values, in
    steps of ``want``'s block scale."""
    worst = 0.0
    for g, w in zip(got, want):
        gap = (g.q.float() * g.scale - w.q.float() * w.scale).abs()
        worst = max(worst, float((gap / w.scale).max()))
        del gap
    return worst


def _family_mesh_runs(device, plain, totals):
    """train_mesh_2's ``FAMILY_MESH_RUNS`` on this rank: each run on a
    ``TrainMesh`` of its shape over the group, launches counted from zero
    (added to ``totals``), its whole weights (and int8 moments) held to
    the oracle this rank trained, if it trained it."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.tree import leaves
    card = device.type == "cuda"
    runs = {}
    for name, arch, shape, steps, opt_state in FAMILY_MESH_RUNS:
        tmesh = make_train_mesh(*shape)
        cfg = family_mesh_cfg(arch)
        tr = _family_trainer(cfg, steps, opt_state, device, tmesh)
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tmesh.reset_issued()
        t0 = time.perf_counter()
        res = tr.train()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        issued = tmesh.issued
        state = res["state"]
        p_mine, p_whole, p_kept = _share(state["params"], tr.layout.params,
                                         tmesh)
        r = {"arch": cfg.name, "family": cfg.family,
             "layers": cfg.n_layers, "mesh": f"{shape[0]}x{shape[1]}",
             "opt_state": opt_state, "steps": steps,
             "batch": FAMILY_MESH_BATCH, "seq_len": family_seq(cfg),
             "losses": [e["loss"] for e in res["log"]],
             "grad_norms": [e["grad_norm"] for e in res["log"]],
             "step_s": [e["sec"] for e in res["log"]], "wall_s": wall,
             "launches": launches,
             "launches_per_step": {k: v / steps for k, v in launches.items()},
             "collectives": issued,
             "collectives_per_step": collectives_per_step(issued, steps,
                                                          tr),
             "peak_device_bytes": torch.cuda.max_memory_allocated()
             if card else 0,
             "param_bytes": p_mine, "whole_param_bytes": p_whole,
             "unsplit_param_bytes": p_kept}
        whole = leaves(sharding.unshard_tree(state["params"],
                                             tr.layout.params, tmesh))
        moments = leaves(sharding.unshard_tree(
            [state["opt"]["m"], state["opt"]["v"]],
            [tr.layout.moments, tr.layout.moments], tmesh)) \
            if opt_state == "int8" else None
        grads, names = tr.first_step_grads, leaf_names(state["params"])
        del tr, res, state
        one = plain.get((arch, opt_state, steps))
        if one is not None:
            r["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                    zip(r["losses"], one["losses"]))
            r["grad_norm_rel_err"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(r["grad_norms"], one["grad_norms"]))
            gaps = _gaps(whole, one["params"])
            r["leaf_rel_err"], r["worst_leaf"] = max(gaps), _worst(gaps,
                                                                   names)
            gaps = _gaps(grads, one["grads"])
            r["grad_leaf_rel_err"] = max(gaps)
            r["worst_grad_leaf"] = _worst(gaps, names)
            if moments is not None:
                r["moment_steps"] = _moment_steps(moments, one["moments"])
        del whole, moments, grads
        runs[name] = r
        if card:
            torch.cuda.empty_cache()
    return runs


def _mesh_trainer(cfg, steps, device, mesh=None, workdir=None):
    """The train phase's Trainer settings (B 8 x S 512, its optimizer)
    for ``steps`` steps, on ``mesh`` if given, checkpointed every step
    into ``workdir`` if given."""
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(cfg, TrainerConfig(seq_len=512, global_batch=8,
                                      steps=steps, log_every=1,
                                      workdir=workdir, checkpoint_every=1),
                   opt_config(TRAIN_LR, TRAIN_STEPS), mesh=mesh,
                   device=device)


def _share(local, specs, mesh):
    """(this rank's bytes of a tree of shards, the whole tree's bytes, the
    bytes of the leaves no axis splits, which every rank holds whole)."""
    import types
    from repro_torch.distributed import sharding
    from repro_torch.train.tree import leaves
    mine = whole = kept = 0
    specs = [x.spec for x in leaves(sharding._tree_map2(
        lambda sp, _: types.SimpleNamespace(spec=sp), specs, local))]
    for spec, t in zip(specs, leaves(local)):
        n = t.numel() * t.element_size()
        full = n * sharding.mesh_axis_size(
            mesh, tuple(a for e in spec if e is not None
                        for a in (e if isinstance(e, tuple) else (e,)))
            or None)
        mine, whole = mine + n, whole + full
        kept += full if full == n else 0
    return mine, whole, kept


def _train_mesh_rank(mesh, device, cfg, workdir):
    """One rank of train_mesh_2 (see ``train_mesh_2_report``): the ranks
    first train one device's oracle runs between them (rank r those of the
    r-th step counts, so both ranks warm up at once), then every rank runs
    ``TRAIN_MESH_RUNS``, each on a ``TrainMesh`` of its shape over the
    group with its knobs set, its launches counted from zero, and holds
    each run's whole weights to the oracle it trained and to the first
    run's."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.tree import leaves
    card = device.type == "cuda"
    out = {"rank": mesh.rank, "runs": {}, "launches": {}}
    plain = {}
    oracles = [("qwen", s) for s in sorted({r[3] for r in TRAIN_MESH_RUNS})]
    oracles += sorted({(arch, moments, steps)
                       for _, arch, _, steps, moments in FAMILY_MESH_RUNS})
    for key in oracles[mesh.rank::mesh.world]:
        t0 = time.perf_counter()
        if key[0] == "qwen":
            steps = key[1]
            res = _mesh_trainer(cfg, steps, device).train()
            plain[steps] = ([e["loss"] for e in res["log"]],
                            [e["grad_norm"] for e in res["log"]],
                            leaves(res["state"]["params"]))
            out[f"plain_{steps}_steps_s"] = time.perf_counter() - t0
            del res
        else:
            plain[key] = _family_oracle(*key, device)
            out["plain_{}_{}_{}_steps_s".format(*key)] = \
                time.perf_counter() - t0
    torch.distributed.barrier()
    first = None
    for name, shape, env, steps in TRAIN_MESH_RUNS:
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            tmesh = make_train_mesh(*shape)
            restart = name.startswith("restart")
            tr = _mesh_trainer(cfg, steps, device, tmesh,
                               workdir if restart else None)
            if first is None:
                _keep_first_step(tr, tmesh)
            if card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            zero_counts()
            tmesh.reset_issued()
            t0 = time.perf_counter()
            res = tr.train(fail_at=TRAIN_MESH_FAIL_AT if restart else None)
            if card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            for k, v in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            state = res["state"]
            p_mine, p_whole, p_kept = _share(state["params"],
                                             tr.layout.params, tmesh)
            m_mine, m_whole, m_kept = _share(
                [state["opt"]["m"], state["opt"]["v"]],
                [tr.layout.moments, tr.layout.moments], tmesh)
            r = {"mesh": f"{shape[0]}x{shape[1]}", "knobs": env,
                 "steps": steps, "losses": [e["loss"] for e in res["log"]],
                 "grad_norms": [e["grad_norm"] for e in res["log"]],
                 "step_s": [e["sec"] for e in res["log"]], "wall_s": wall,
                 "launches": launches, "steps_run": len(res["log"]),
                 "collectives": tmesh.issued,
                 "collectives_per_step": collectives_per_step(
                     tmesh.issued, steps, tr),
                 "peak_device_bytes": torch.cuda.max_memory_allocated()
                 if card else 0,
                 "param_bytes": p_mine, "whole_param_bytes": p_whole,
                 "unsplit_param_bytes": p_kept, "moment_bytes": m_mine,
                 "whole_moment_bytes": m_whole, "unsplit_moment_bytes": m_kept}
            whole = leaves(sharding.unshard_tree(state["params"],
                                                 tr.layout.params, tmesh))
            first_step = getattr(tr, "first_step_params", None)
            del tr, res, state
            if steps in plain:
                ploss, pnorm, pparams = plain[steps]
                r["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(r["losses"][-steps:], ploss))
                r["grad_norm_rel_err"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(r["grad_norms"][-steps:], pnorm))
                r["leaf_rel_err"] = max(
                    float((a - b).abs().max() / b.abs().max().clamp_min(
                        1e-30)) for a, b in zip(whole, pparams))
            if first is None:
                first = (r["losses"], whole, first_step)
            else:
                # against the first run after as many steps (a 1-step run:
                # its weights after its first step)
                ref = first[1] if steps == len(first[0]) else first[2]
                r["bitwise_first_run"] = \
                    r["losses"][-1] == first[0][steps - 1] and all(
                        torch.equal(a, b) for a, b in zip(whole, ref))
            del whole, first_step
            out["runs"][name] = r
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if card:
            torch.cuda.empty_cache()
    out["family_runs"] = _family_mesh_runs(device, plain, out["launches"])
    out["serve_steps"] = _serve_steps_rank(mesh, device)
    return out


# serve_steps_mesh_2: the prefill and decode step builders on the 2-rank
# group (``make_prefill_step(mesh=)``, ``make_decode_step(mesh=)``), bf16 at
# full width, cut in depth (``serve_mesh_cfg``: qwen3-0.6b 2 layers,
# falcon-mamba-7b 1): (run, arch, (data, model)); B 2, a 4,096-token
# prompt, then 8 teacher-forced decode steps in a cache of 4,104 positions
SERVE_MESH_RUNS = (("qwen_serve_2x1", "qwen3-0.6b", (2, 1)),
                   ("qwen_serve_1x2", "qwen3-0.6b", (1, 2)),
                   ("falcon_serve_1x2", "falcon-mamba-7b", (1, 2)))
SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_STEPS = 2, 4096, 8


def serve_mesh_cfg(arch):
    """A serve_steps_mesh_2 config: full width, bf16, cut in depth."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return at_depth(cfg, 1 if cfg.family == "ssm" else 2)


def _serve_run(torch, cfg, device, mesh=None):
    """The prompt's prefill and ``SERVE_MESH_STEPS`` decode steps of
    ``cfg`` (seeded weights and tokens) on one device, or on ``mesh`` from
    the rank's shards, batch rows and cache blocks: the logits and both
    caches whole (gathered over the ranks), and per step its seconds, its
    launches and the collectives this rank issued."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import abstract_cache
    b, s, n = SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_STEPS
    fns = build_model(cfg, device)
    params = fns.init(0)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (b, s + n), generator=g,
                           dtype=torch.int32).to(device)
    prefill = make_prefill_step(cfg, device, mesh=mesh)
    decode = make_decode_step(cfg, device, mesh=mesh)
    split = mesh is not None and mesh.shape["data"] > 1
    rows = (lambda t: mesh.part(t, 0, "data")) if split else (lambda t: t)
    whole = (lambda t: mesh.gather(t, 0, "data")) if split \
        else (lambda t: t)
    extra = ()
    if mesh is not None:
        layout = sharding.train_layout(cfg, params, mesh)
        params = sharding.shard_tree(params, layout.params, mesh)
        extra = (layout, True)
    out = {"step_s": [], "launches": [], "issued": []}

    def step(fn, *args):
        torch.cuda.synchronize()
        zero_counts()
        if mesh is not None:
            mesh.reset_issued()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append(read_counts())
        out["issued"].append(mesh.issued if mesh is not None else {})
        return res

    cache, logits = step(prefill, params, {"tokens": rows(tokens[:, :s])},
                         *extra)
    out["logits"] = [whole(logits)]
    if mesh is not None:
        cache = sharding.unshard_tree(cache, sharding.cache_specs(
            cfg, abstract_cache(cfg, b, s), mesh), mesh)
    out["prefill_cache"] = cache
    big = place_cache(dict(cache), fns.make_cache(b, s + n))
    if mesh is not None:
        specs = sharding.cache_specs(cfg, big, mesh)
        big = sharding.shard_tree(big, specs, mesh)
        extra = (layout, specs, True)
    for i in range(n):
        batch = {"token": rows(tokens[:, s + i:s + i + 1])}
        if cfg.family != "ssm":
            batch["cur_len"] = s + i
        big, logits = step(decode, params, big, batch, *extra)
        out["logits"].append(whole(logits))
    out["cache"] = sharding.unshard_tree(big, specs, mesh) \
        if mesh is not None else big
    return out


def _serve_steps_rank(mesh, device):
    """One rank of serve_steps_mesh_2 (see ``serve_steps_mesh_report``):
    each run on a ``TrainMesh`` of its shape over the group, held to one
    device's run of the same weights and tokens on this rank: the logits
    of the prefill and of every decode step, and the prefill's and the
    final cache gathered whole."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.tree import leaves
    out = {}
    for name, arch, shape in SERVE_MESH_RUNS:
        cfg = serve_mesh_cfg(arch)
        with torch.no_grad():
            one = _serve_run(torch, cfg, device)
            got = _serve_run(torch, cfg, device, make_train_mesh(*shape))
        errs = {"logits": max(rel_err(a, b)[1] for a, b in
                              zip(got["logits"], one["logits"]))}
        for c in ("prefill_cache", "cache"):
            errs[c] = max(rel_err(a, b)[1] for a, b in
                          zip(leaves(got[c]), leaves(one[c])))
        out[name] = {"mesh": f"{shape[0]}x{shape[1]}", "arch": cfg.name,
                     "layers": cfg.n_layers, "rel_err": errs,
                     "finite": all(bool(torch.isfinite(t).all())
                                   for t in got["logits"]),
                     **{k: got[k] for k in ("step_s", "launches", "issued")},
                     "one_device_step_s": one["step_s"],
                     "one_device_launches": one["launches"]}
        del one, got
        torch.cuda.empty_cache()
    return out


def _serve_mesh_rank(mesh, device, cfg, fns, params):
    """One rank of serve_mesh_2 (see ``serve_mesh_2_phase``)."""
    import torch
    from repro_torch.distributed.param_sharding import (ServeShard,
                                                        shard_params,
                                                        tp_param_specs)
    from repro_torch.serve.engine import Request
    card = device.type == "cuda"     # False in a rehearsal on the CPU
    out = {"rank": mesh.rank}
    # the sharded engine: KV/2 heads a rank, TP identity
    eng = serve_engine(cfg, params, mesh=mesh, tp=True)
    tally, counted = dispatch_timer()
    wrap_dispatches(eng, counted)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out["tokens"] = _mesh_serve(eng, mesh_workload(cfg.vocab))
    if card:
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["model_calls"] = sum(n for n, _ in tally.values())
    out["host_ms_per_dispatch"] = host_ms_per_dispatch(tally)
    m = eng.metrics()
    out["metrics"] = {k: getattr(m, k) for k in (
        "tokens_per_sec", "ttft_mean_s", "engine_steps", "mesh_devices",
        "tp_devices", "param_bytes_per_device", "param_bytes_replicated",
        "re_prefill_avoided", "peak_blocks_used")}
    out["slab"] = list(eng.cache["k"].shape)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated() \
        if card else 0
    del eng
    if mesh.rank == 0:
        # the plain engine on the same weights
        plain = serve_engine(cfg, params, mesh=False)
        out["plain"] = _mesh_serve(plain, mesh_workload(cfg.vocab))
        del plain
    # reduce-scatter prefill logits against the replicated forward on
    # a 256-token chunk (bf16: the partial sums reorder the reduction)
    prompt = workload(cfg.vocab, n=1)[0].prompt[:256]
    batch = {"tokens": torch.tensor([prompt], device=device),
             "block_table": torch.arange(1, 17, dtype=torch.int32,
                                         device=device)[None],
             "start": 0, "prompt_len": 256}
    ref = fns.prefill_chunk(params, fns.make_paged_cache(17, 16),
                            batch)[1].float()
    specs, _ = tp_param_specs(cfg, params, mesh.n_model)
    local = shard_params(params, specs, mesh)
    got = fns.prefill_chunk(local, fns.make_paged_cache(
        17, 16, n_model=mesh.n_model), batch,
        shard=ServeShard(mesh, True))[1].float()
    out["rs_max_abs_err"], out["rs_rel_err"] = rel_err(got, ref)
    out["rs_greedy_agreement"] = float(
        (got.argmax(-1) == ref.argmax(-1)).float().mean())
    del local, ref, got
    # one swap preemption on the sharded pool (weights replicated: the
    # swap moves each rank's head slice, TP adds nothing to it), against
    # each request served alone on one device
    swap = [Request(rid=i, prompt=[3, 5, 7, 11 + i], max_new=16)
            for i in range(2)]
    kw = dict(max_batch=2, max_len=32, block_size=4,
              prefill_chunk_tokens=4)
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, mesh=mesh, tp=False, num_blocks=7,
                      admission="optimistic", **kw)
    out["swap"] = _mesh_serve(eng, swap)
    m = eng.metrics()
    out["swap_counts"] = (m.preemptions, m.swap_out_blocks,
                          m.swap_in_blocks)
    del eng
    if mesh.rank == 0:
        out["solo"] = {}
        for r in swap:
            solo = ServeEngine(cfg, params, mesh=False,
                               prefix_cache_blocks=0,
                               **dict(kw, max_batch=1))
            out["solo"][r.rid] = _mesh_serve(solo, [Request(
                rid=r.rid, prompt=list(r.prompt), max_new=16)])[r.rid]
    return out



def _moe_mesh_rank(mesh, device, cfg, fns, params):
    """One rank of moe_mesh_2 (see ``moe_mesh_2_phase``)."""
    import torch
    from repro_torch.distributed.param_sharding import (ServeShard,
                                                        param_bytes_per_device,
                                                        shard_params,
                                                        tp_param_specs)
    card = device.type == "cuda"
    out = {"rank": mesh.rank}
    # the KV pool on kv-heads (8 of 16 a rank), the weights replicated
    eng = serve_engine(cfg, params, mesh=mesh, tp=False)
    tally, counted = dispatch_timer()
    wrap_dispatches(eng, counted)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out["tokens"] = _mesh_serve(eng, mesh_workload(cfg.vocab))
    if card:
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["model_calls"] = sum(n for n, _ in tally.values())
    out["host_ms_per_dispatch"] = host_ms_per_dispatch(tally)
    m = eng.metrics()
    out["metrics"] = {k: getattr(m, k) for k in (
        "tokens_per_sec", "ttft_mean_s", "engine_steps", "mesh_devices",
        "tp_devices", "param_bytes_per_device", "param_bytes_replicated",
        "re_prefill_avoided", "peak_blocks_used")}
    out["slab"] = list(eng.cache["k"].shape)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated() \
        if card else 0
    del eng
    if mesh.rank == 0:
        plain = serve_engine(cfg, params, mesh=False)
        out["plain"] = _mesh_serve(plain, mesh_workload(cfg.vocab))
        del plain
    # the stored TP layout against the replicated forward: one 256-token
    # chunk in identity mode (every expert stack gathered whole through
    # the host) and in reduce-scatter mode, then one decode step of 8 rows
    # after it (each row's own last page, the chunk's 16 pages shared)
    specs, _ = tp_param_specs(cfg, params, mesh.n_model)
    local = shard_params(params, specs, mesh)
    out["tp_param_bytes"] = param_bytes_per_device(local)
    prompt = workload(cfg.vocab, n=1)[0].prompt[:256]
    pre = {"tokens": torch.tensor([prompt], device=device),
           "block_table": torch.arange(1, 17, dtype=torch.int32,
                                       device=device)[None],
           "start": 0, "prompt_len": 256}
    dec = {"token": torch.tensor(prompt[:8], dtype=torch.int32,
                                 device=device)[:, None],
           "block_tables": torch.cat([
               torch.arange(1, 17, dtype=torch.int32,
                            device=device).expand(8, 16),
               torch.arange(17, 25, dtype=torch.int32, device=device)[:, None]],
               dim=1),
           "seq_lens": torch.full((8,), 256, dtype=torch.int32,
                                  device=device),
           "pages_per_fetch": 1, "lora_block_out": 256}
    # reduce-scatter runs twice: free (its own routing; a flipped expert
    # set moves its token's logits by far more than the arithmetic, so the
    # flips are counted, not gated) and on the replicated forward's picks
    # (``RouteLog(force=)``: the arithmetic alone, gated)
    got, ref_calls = {}, []
    for mode, p, shard in (("ref", params, None),
                           ("id", local, ServeShard(mesh, False)),
                           ("rs", local, ServeShard(mesh, True)),
                           ("rs_forced", local, ServeShard(mesh, True))):
        kw = {} if shard is None else {"shard": shard}
        cache = fns.make_paged_cache(26, 16, n_model=1 if shard is None
                                     else mesh.n_model)
        force = list(ref_calls) if mode == "rs_forced" else None
        with RouteLog(force=force) as log:
            cache, lg = fns.prefill_chunk(p, cache, pre, **kw)
            calls = list(log.calls)
            routes = log.take(cfg)
            if mode == "id":
                got[mode] = (lg.float(), None, routes, None)
                continue
            _, dl = fns.decode_paged(p, cache, dec, **kw)
            calls += log.calls
            got[mode] = (lg.float(), dl.float(), routes, log.take(cfg))
        if mode == "ref":
            ref_calls = calls
        del cache
    ref_pre, ref_dec, ref_routes, ref_droutes = got["ref"]
    out["identity_bitwise"] = bool(torch.equal(got["id"][0], ref_pre))
    out["identity_route_flips"] = differing_sets(got["id"][2], ref_routes)
    rs_pre, rs_dec, rs_routes, rs_droutes = got["rs"]
    out["rs_free_prefill_rel_err"] = rel_err(rs_pre, ref_pre)[1]
    out["rs_free_decode_rel_err"] = rel_err(rs_dec, ref_dec)[1]
    out["rs_prefill_greedy_agreement"] = float(
        (rs_pre.argmax(-1) == ref_pre.argmax(-1)).float().mean())
    out["rs_decode_greedy_agreement"] = float(
        (rs_dec.argmax(-1) == ref_dec.argmax(-1)).float().mean())
    out["rs_route_flips"] = {"prefill": differing_sets(rs_routes, ref_routes),
                             "decode": differing_sets(rs_droutes,
                                                      ref_droutes),
                             "of": [cfg.n_layers * 256, cfg.n_layers * 8]}
    f_pre, f_dec, f_routes, f_droutes = got["rs_forced"]
    out["rs_forced_flips"] = differing_sets(f_routes, ref_routes) \
        + differing_sets(f_droutes, ref_droutes)
    out["rs_prefill_rel_err"] = rel_err(f_pre, ref_pre)[1]
    out["rs_decode_rel_err"] = rel_err(f_dec, ref_dec)[1]
    if card:
        out["peak_device_bytes_tp"] = torch.cuda.max_memory_allocated()
    del local, got
    return out


def _gateway_mesh_rank(mesh, device, cfg, qparams, moe_cfg, mparams):
    """One rank of gateway_mesh_2 (see ``gateway_mesh_2_phase``)."""
    import asyncio

    import torch
    from repro_torch.serve.engine import follow_all
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.gateway import Gateway, Router
    from tools.gateway_smoke_torch import (check_sse, completion_payload,
                                           sse_payloads, sse_request)
    engines = [serve_engine(cfg, qparams, mesh=mesh, tp=False,
                            fault_injector=False),
               serve_engine(moe_cfg, mparams, mesh=mesh, tp=False,
                            fault_injector=FaultInjector.parse(
                                GATEWAY_MESH_FAULT))]
    out = {"rank": mesh.rank}
    if mesh.rank == 0:
        models = [gateway_model(cfg, engines[0]),
                  gateway_model(moe_cfg, engines[1])]
        reqs = gateway_mesh_requests(cfg, moe_cfg)

        async def drive():
            async with Gateway(Router(models), port=0) as gw:
                health = await sse_request(gw.host, gw.port, None,
                                           path="/health")
                asks = [sse_request(gw.host, gw.port, completion_payload(
                    models[m].model_id, r.prompt, r.max_new, r.sampling),
                    close_after=GATEWAY_MESH_CANCEL[1]
                    if i == GATEWAY_MESH_CANCEL[0] else None)
                    for i, (m, r) in enumerate(reqs)]
                t0 = time.perf_counter()
                got = await asyncio.wait_for(asyncio.gather(*asks),
                                             GATEWAY_TIMEOUT_S)
                wall = time.perf_counter() - t0
                for _ in range(1000):
                    if engines[0].cancelled:
                        break
                    await asyncio.sleep(0.01)
                return health, got, wall
        t0 = time.perf_counter()
        health, got, wall = asyncio.run(drive())
        out["serve_s"] = time.perf_counter() - t0
        out["streams_wall_s"] = wall
        out["health"] = health["status"]
        out["faults"] = [m.async_engine.fault for m in models]
        out["streams"] = []
        for i, ((m, r), g) in enumerate(zip(reqs, got)):
            if g["closed_early"]:
                ids = [t for p in sse_payloads(g["raw"])[0] if p != b"[DONE]"
                       for t in json.loads(p)["choices"][0]["token_ids"]]
                out["streams"].append({"model": m, "status": g["status"],
                                       "finish_reason": "client closed",
                                       "token_ids": ids, "errors": []})
                continue
            sse = check_sse(g["raw"], prompt_tokens=len(r.prompt))
            out["streams"].append({"model": m, "status": g["status"],
                                   "finish_reason": sse["finish_reason"],
                                   "token_ids": sse["token_ids"],
                                   "errors": sse["errors"],
                                   "ttft_s": g["ttft_s"]})
        # a plain engine a model on the same weights, and olmoe's plain
        # engine once more under the same fault
        with torch.no_grad():
            plain = {}
            for m, (c, p, spec) in enumerate(((cfg, qparams, ""),
                                              (moe_cfg, mparams, ""),
                                              (moe_cfg, mparams,
                                               GATEWAY_MESH_FAULT))):
                eng = serve_engine(c, p, mesh=False, fault_injector=(
                    FaultInjector.parse(spec) if spec else False))
                mine = [dataclasses.replace(r, out=[]) for mm, r in reqs
                        if mm == min(m, 1)]
                for r in mine:
                    eng.submit(r)
                while eng.step_guarded():
                    pass
                plain[m] = ({r.rid: list(r.out) for r in eng.finished},
                            sorted(r.rid for r in eng.errored))
                del eng
        out["plain"] = plain
    else:
        with torch.no_grad():
            out["follower_steps"] = follow_all(engines)
    out["engines"] = [{
        "finished": {r.rid: list(r.out) for r in e.finished},
        "cancelled": sorted(r.rid for r in e.cancelled),
        "errored": sorted(r.rid for r in e.errored),
        "step_crashes": e.metrics().step_crashes, "closed": e._closed,
        "invariants": e.check_invariants() + e.invariant_violations}
        for e in engines]
    del engines
    return out


# moe_mesh_2: olmoe-1b-7b at full width and 2 of its 16 layers (bf16
# weights replicated a rank) on the same 2-rank mesh and workload
MOE_MESH_LAYERS = 2
# gateway_mesh_2: 4 streams a model of the mesh workload (qwen: requests 0
# to 3, olmoe: 4 to 7); qwen's stream 1 closed by its client after 6
# tokens; olmoe's engine on both ranks crashes at its 7th dispatch
GATEWAY_MESH_CANCEL = (1, 6)
GATEWAY_MESH_FAULT = "step:after=6"


def gateway_mesh_requests(cfg, moe_cfg):
    """(model index, request) of the 8 gateway_mesh_2 streams."""
    return [(0, r) for r in mesh_workload(cfg.vocab)[:4]] \
        + [(1, r) for r in mesh_workload(moe_cfg.vocab)[4:]]


def serve_mesh_2_phase(torch, cfg, smi, moe_cfg=None):
    """serve_mesh_2, moe_mesh_2, gateway_mesh_2 and train_mesh_2: one group
    of two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), one fork server, stopped at once after (``_mesh_rank``);
    ``moe_cfg`` defaults to olmoe-1b-7b; train_mesh_2 trains ``cfg`` in f32
    at ``TRAIN_MESH_LAYERS`` layers.  Returns the launches of
    serve_mesh_2's, moe_mesh_2's and train_mesh_2's rank 0."""
    import shutil
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn_ranks, stop_rank_server
    mcfg = at_depth(cfg, MESH_LAYERS)
    moe_cfg = at_depth(moe_cfg or get_config(MOE_ARCH), MOE_MESH_LAYERS)
    train_cfg = at_depth(dataclasses.replace(cfg, dtype="float32"),
                         TRAIN_MESH_LAYERS)
    workdir = tempfile.mkdtemp(prefix="train_mesh_2_")
    t0 = time.perf_counter()
    try:
        outs = spawn_ranks(_mesh_rank, 2, "gloo", DEV,
                           args=(mcfg, moe_cfg, train_cfg, workdir),
                           timeout_s=1000)
    finally:
        # no later phase spawns ranks: the fork server goes now
        stop_rank_server()
        shutil.rmtree(workdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    parts = [o["part_s"] for o in outs]
    launches = serve_mesh_2_report(
        mcfg, [o["serve_mesh_2"] for o in outs], smi, parts)
    moe_launches = moe_mesh_2_report(
        moe_cfg, [o["moe_mesh_2"] for o in outs], smi, parts)
    gateway_mesh_2_report(mcfg, moe_cfg, [o["gateway_mesh_2"] for o in outs],
                          smi, parts, wall)
    train_launches = train_mesh_2_report(
        train_cfg, [o["train_mesh_2"] for o in outs], smi, parts)
    serve_steps_mesh_report([o["train_mesh_2"]["serve_steps"] for o in outs],
                            smi)
    dryrun_mesh_phase(train_cfg, [o["train_mesh_2"] for o in outs], smi)
    return launches, moe_launches, train_launches


# train_mesh_2's runs that the dry run counts again: (run, config, batch,
# sequence); its qwen runs at B 8 x S 512, its falcon-mamba run at B 2
DRYRUN_MESH_RUNS = (("fsdp_tp_2x1", "qwen", 8, 512),
                    ("fsdp_tp_1x2", "qwen", 8, 512),
                    ("falcon_fsdp_tp_1x2", "falcon-mamba-7b",
                     FAMILY_MESH_BATCH, 512))


def serve_steps_mesh_report(outs, smi):
    """serve_steps_mesh_2: each ``SERVE_MESH_RUNS`` run on the two gloo
    ranks (both on the one card) against one device's run of the same
    weights and tokens on each rank: the logits of the prefill and of all
    8 decode steps, the prefill's cache and the cache after the last step
    (gathered whole) within ``BF16_ORACLE_TOL``, the logits finite, and
    each step's launches (K2; K7 for falcon-mamba) one device's.  Reports
    the steps' seconds and collectives."""
    runs = {}
    for name, _, _ in SERVE_MESH_RUNS:
        rows = [o[name] for o in outs]
        for r in rows:
            assert all(v <= BF16_ORACLE_TOL for v in r["rel_err"].values()), \
                (name, r["rel_err"])
            assert r["finite"], name
            assert r["launches"] == r["one_device_launches"], \
                (name, r["launches"], r["one_device_launches"])
            assert all(n["rmsnorm"] > 0 for n in r["launches"]), name
        r0 = rows[0]
        runs[name] = {"mesh": r0["mesh"], "arch": r0["arch"],
                      "layers": r0["layers"],
                      "rel_err": [r["rel_err"] for r in rows],
                      "launches_per_step": [
                          {k: v for k, v in n.items() if v}
                          for n in r0["launches"][:2]],
                      "prefill_s": [r["step_s"][0] for r in rows],
                      "decode_s": [r["step_s"][1:] for r in rows],
                      "one_device_prefill_s": r0["one_device_step_s"][0],
                      "one_device_decode_s": r0["one_device_step_s"][1:],
                      "collectives": {"prefill": r0["issued"][0],
                                      "decode": r0["issued"][1]}}
    emit({"phase": "serve_steps_mesh_2", "backend": "gloo", "world": 2,
          "device": "cuda:0 (both ranks)", "nvidia_smi": smi,
          "dtype": "bfloat16", "batch": SERVE_MESH_BATCH,
          "prompt": SERVE_MESH_PROMPT, "decode_steps": SERVE_MESH_STEPS,
          "tol": BF16_ORACLE_TOL, "runs": runs})


def _dry_serve_issued(cfg, shape, rank):
    """The collectives a ``DryTrainMesh`` of ``shape`` issues at ``rank``
    in a serve_steps_mesh_2 run's prefill and in one decode step over its
    cache, by kind [calls, bytes]."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import count_decode_step, \
        count_prefill_step
    from repro_torch.launch.mesh import dry_train_mesh
    b, s = SERVE_MESH_BATCH, SERVE_MESH_PROMPT
    out = []
    for count, spec in (
            (count_prefill_step, ShapeSpec("p", s, b, "prefill")),
            (count_decode_step,
             ShapeSpec("d", s + SERVE_MESH_STEPS, b, "decode"))):
        mesh = dry_train_mesh({"data": shape[0], "model": shape[1]}, rank)
        count(cfg, spec, mesh)
        out.append({k: v[:2] for k, v in mesh.issued.items()})
    return out


def dryrun_mesh_phase(cfg, outs, smi):
    """dryrun_mesh: one step of each ``DRYRUN_MESH_RUNS`` run counted by
    the dry run on a ``DryTrainMesh`` of the run's shape (meta tensors, no
    process) issues each rank's collectives a step exactly: calls and
    bytes by kind, against the ranks' ``TrainMesh.issued`` a step (less
    the oracle checks' whole-weight gathers); so do the prefill and the
    first decode step of each ``SERVE_MESH_RUNS`` run.  ``cfg``:
    train_mesh_2's qwen config; ``outs``: its ranks' results."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import count_train_step
    from repro_torch.launch.mesh import dry_train_mesh
    from repro_torch.launch.train import opt_config
    rows = {}
    for name, arch, shape in SERVE_MESH_RUNS:
        t0 = time.perf_counter()
        run_cfg = serve_mesh_cfg(arch)
        for rank in range(shape[0] * shape[1]):
            got = _dry_serve_issued(run_cfg, shape, rank)
            want = [{k: v[:2] for k, v in w.items()}
                    for w in outs[rank]["serve_steps"][name]["issued"][:2]]
            assert got == want, (name, rank, got, want)
        rows[name] = {"mesh": f"{shape[0]}x{shape[1]}", "arch": run_cfg.name,
                      "layers": run_cfg.n_layers,
                      "collectives": {"prefill": got[0], "decode": got[1]},
                      "dry_s": time.perf_counter() - t0}
    for name, arch, batch, seq in DRYRUN_MESH_RUNS:
        family = arch != "qwen"
        runs = [o["family_runs" if family else "runs"][name] for o in outs]
        d, m = (int(x) for x in runs[0]["mesh"].split("x"))
        run_cfg = family_mesh_cfg(arch) if family else cfg
        t0 = time.perf_counter()
        for rank in range(d * m):
            mesh = dry_train_mesh({"data": d, "model": m}, rank)
            analysis = count_train_step(
                run_cfg, ShapeSpec(name, seq, batch, "train"), mesh,
                opt_cfg=opt_config(TRAIN_LR, TRAIN_STEPS))
            got = {k: [float(v[0]), float(v[1])]
                   for k, v in mesh.issued.items()}
            want = runs[rank]["collectives_per_step"]
            assert got == want, (name, rank, got, want)
        rows[name] = {"mesh": runs[0]["mesh"], "arch": run_cfg.name,
                      "layers": run_cfg.n_layers, "batch": batch,
                      "seq_len": seq, "collectives_per_step": got,
                      "dry_flops": analysis["flops"],
                      "dry_peak_bytes": analysis["peak_bytes"],
                      "rank_peak_device_bytes": [
                          r["peak_device_bytes"] for r in runs],
                      "dry_s": time.perf_counter() - t0}
    emit({"phase": "dryrun_mesh", "nvidia_smi": smi, "equal": True,
          "runs": rows})


# rank 0's peak device bytes in train_mesh_2's 1x2 runs when their loss
# all-gathered the whole vocabulary's logits on each model rank before the
# f32 cross-entropy: this script's reading on an NVIDIA H100 80GB HBM3 at
# 700 W, before the loss became vocab-parallel, printed beside today's
WHOLE_LOGITS_PEAK = {"fsdp_tp_1x2": 22_543_184_896,
                     "seq_parallel_1x2": 22_509_628_928}


def train_mesh_2_report(cfg, outs, smi, parts):
    """train_mesh_2: qwen3-0.6b at full width, ``TRAIN_MESH_LAYERS``
    layers, f32, B 8 x S 512, on the two gloo ranks (both on the one card).
    Every run (``TRAIN_MESH_RUNS``: 2x1 under fsdp_tp, again under
    REPRO_WEIGHT_AG=1 and with a failure; 1x2 under fsdp_tp and
    REPRO_SEQ_PARALLEL=1, K3 at 8 heads over 4 a rank; 2x1 under dp) holds
    each step's loss and gradient norm within 1e-4 relative and every leaf
    within 1e-3 of its largest value of one device's Trainer on the same
    weights (trained by the rank that reports it);
    REPRO_WEIGHT_AG=1 and the restart are the first run's bits; a rank
    holds half of the whole state apart from the leaves no axis splits
    (under dp: the weights whole, the moments ZeRO-1 halves); each rank
    launches K3 and K2 a step what the train phase does at this depth.
    On 1x2 the loss is vocab-parallel: each rank's all_gathers a step send
    less than its (B, S, V/2) slice of the logits, which the whole-logits
    loss gathered every step; rank 0's peak is printed beside
    ``WHOLE_LOGITS_PEAK``.  Returns rank 0's launches over the runs."""
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 2 * k2_per_model_call(cfg) - 1,
            "rmsnorm_bwd": k2_per_model_call(cfg)}
    runs = {}
    for name, shape, env, steps in TRAIN_MESH_RUNS:
        rows = [o["runs"][name] for o in outs]
        r0 = next(r for r in rows if "loss_rel_err" in r)
        assert r0["loss_rel_err"] <= TRAIN_MESH_LOSS_TOL, (name, r0)
        assert r0["grad_norm_rel_err"] <= TRAIN_MESH_LOSS_TOL, (name, r0)
        assert r0["leaf_rel_err"] <= TRAIN_MESH_LEAF_TOL, (name, r0)
        if name != TRAIN_MESH_RUNS[0][0] and shape == (2, 1) \
                and "REPRO_TRAIN_SHARDING" not in env:
            assert all(r["bitwise_first_run"] for r in rows), name
        dp = env.get("REPRO_TRAIN_SHARDING") == "dp"
        for r in rows:
            half = lambda mine, whole, kept: \
                mine == kept + (whole - kept) // 2  # noqa: E731
            assert (r["param_bytes"] == r["whole_param_bytes"]) if dp \
                else half(r["param_bytes"], r["whole_param_bytes"],
                          r["unsplit_param_bytes"]), (name, r)
            assert half(r["moment_bytes"], r["whole_moment_bytes"],
                        r["unsplit_moment_bytes"]), (name, r)
            if not name.startswith("restart"):
                per = {k: v / steps for k, v in r["launches"].items()}
                assert {k: per[k] for k in want} == want, (name, per)
                assert all(v == 0 for k, v in per.items()
                           if k not in want), (name, per)
        vocab_parallel = None
        if shape[1] > 1 and "REPRO_TRAIN_SHARDING" not in env:
            slice_bytes = 8 * 512 * cfg.vocab // shape[1] \
                * {"float32": 4, "bfloat16": 2}[cfg.dtype]
            for r in rows:
                sent = r["collectives_per_step"]["all_gather"][1]
                assert sent < slice_bytes, (name, sent, slice_bytes)
            vocab_parallel = {
                "logits_slice_bytes": slice_bytes,
                "all_gather_bytes_per_step": [
                    r["collectives_per_step"]["all_gather"][1]
                    for r in rows],
                "rank0_peak_device_bytes": rows[0]["peak_device_bytes"],
                "rank0_whole_logits_peak_device_bytes":
                    WHOLE_LOGITS_PEAK.get(name)}
        runs[name] = {
            "vocab_parallel_loss": vocab_parallel,
            "mesh": r0["mesh"], "knobs": r0["knobs"], "steps": steps,
            "losses": r0["losses"], "loss_rel_err": r0["loss_rel_err"],
            "grad_norms": r0["grad_norms"],
            "grad_norm_rel_err": r0["grad_norm_rel_err"],
            "leaf_rel_err": r0["leaf_rel_err"],
            "bitwise_first_run": r0.get("bitwise_first_run"),
            "ranks": [{k: r[k] for k in (
                "step_s", "wall_s", "launches", "collectives",
                "collectives_per_step", "peak_device_bytes", "param_bytes", "whole_param_bytes",
                "unsplit_param_bytes", "moment_bytes", "whole_moment_bytes",
                "unsplit_moment_bytes")} for r in rows]}
    emit({"phase": "train_mesh_2", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": layers, "backend": "gloo", "world": 2,
          "device": "cuda:0 (both ranks)", "nvidia_smi": smi,
          "batch": 8, "seq_len": 512, "fail_at": TRAIN_MESH_FAIL_AT,
          "plain_s": {k: v for o in outs for k, v in o.items()
                      if k.startswith("plain_")},
          "phase_s": [p["train_mesh_2"] for p in parts], "runs": runs})
    family_mesh_report(outs, smi)
    return outs[0]["launches"]


def family_mesh_report(outs, smi):
    """train_mesh_2's ``FAMILY_MESH_RUNS``: every run's losses and gradient
    norms within 1e-4 relative of one device's Trainer on the same weights
    (trained by the rank that reports it); its first step's gradient
    leaves within 1e-3 of their largest value (zamba2's held later to
    train_hybrid_oracle's limit, ``hybrid_mesh_gate``) and its weights too
    (zamba2's reported: AdamW's first step turns a gradient near zero into
    about lr, which a reordered sum moves by more than the hybrid's limit;
    the int8 run's reported, its moments within one quantization step of
    one device's instead); a rank holds half
    of the whole weights apart from the leaves no axis splits; each rank
    launches K7, K3 and K2 a step what one device's step launches at this
    depth (K7 over a rank's 4,096 channels at 1x2, K3 over its heads)."""
    runs = {}
    for name, arch, shape, steps, opt_state in FAMILY_MESH_RUNS:
        rows = [o["family_runs"][name] for o in outs]
        r0 = next(r for r in rows if "loss_rel_err" in r)
        assert r0["loss_rel_err"] <= TRAIN_MESH_LOSS_TOL, (name, r0)
        assert r0["grad_norm_rel_err"] <= TRAIN_MESH_LOSS_TOL, (name, r0)
        if r0["family"] == "hybrid":
            HYBRID_MESH_LEAVES[name] = r0["grad_leaf_rel_err"]
        else:
            assert r0["grad_leaf_rel_err"] <= TRAIN_MESH_LEAF_TOL, (name, r0)
        if opt_state == "int8":
            assert r0["moment_steps"] <= 1 + 1e-3, (name, r0)
        elif r0["family"] != "hybrid":
            assert r0["leaf_rel_err"] <= TRAIN_MESH_LEAF_TOL, (name, r0)
        want = stateful_train_launches(family_mesh_cfg(arch))
        for r in rows:
            per = r["launches_per_step"]
            assert {k: per[k] for k in want} == want, (name, per, want)
            assert all(v == 0 for k, v in per.items() if k not in want), \
                (name, per)
            assert r["param_bytes"] == r["unsplit_param_bytes"] + (
                r["whole_param_bytes"] - r["unsplit_param_bytes"]) // 2, \
                (name, r)
        runs[name] = {**{k: r0[k] for k in r0 if k not in (
            "step_s", "wall_s", "launches", "collectives", "peak_device_bytes",
            "param_bytes", "whole_param_bytes", "unsplit_param_bytes",
            "launches_per_step", "collectives_per_step")},
            "ranks": [{k: r[k] for k in (
                "step_s", "wall_s", "launches_per_step",
                "collectives_per_step", "peak_device_bytes", "param_bytes",
                "whole_param_bytes", "unsplit_param_bytes")} for r in rows]}
    emit({"phase": "train_mesh_2_families", "backend": "gloo", "world": 2,
          "device": "cuda:0 (both ranks)", "nvidia_smi": smi,
          "dtype": "float32", "runs": runs})


def hybrid_mesh_gate(leaf_tol):
    """train_mesh_2's zamba2 runs: each gradient leaf of the first step
    within ``leaf_tol`` of its largest value from one device's, the limit
    train_hybrid_oracle held the card's gradient leaves to against the
    CPU's: max(1e-3, twice its CPU witness's spread)."""
    emit({"phase": "train_mesh_2_hybrid_gate", "leaf_tol": leaf_tol,
          "grad_leaf_rel_err": HYBRID_MESH_LEAVES})
    assert HYBRID_MESH_LEAVES, "train_mesh_2 ran no hybrid run"
    for name, err in HYBRID_MESH_LEAVES.items():
        assert err <= leaf_tol, (name, err, leaf_tol)


def serve_mesh_2_report(mcfg, outs, smi, parts):
    """serve_mesh_2: two ranks on the one card, full width at
    ``MESH_LAYERS`` layers: the KV pool sharded on kv-heads (4 of 8 a rank)
    with TP identity serves ``mesh_workload`` with the tokens of a plain
    engine on the same weights; each rank's K1 and K2 launches are what its
    model calls imply (L and 3L + 1 a call); each rank's param bytes and
    peak memory; reduce-scatter prefill logits within the bf16 gate of the
    replicated forward, with the greedy agreement; one swap preemption
    bitwise against each request alone."""
    plain = outs[0]["plain"]
    for o in outs:
        assert o["tokens"] == plain, f"rank {o['rank']}: tokens differ"
        assert o["slab"][-2] == mcfg.n_kv_heads // 2, o["slab"]
        calls, launches = o["model_calls"], o["launches"]
        assert launches["paged_attention"] == mcfg.n_layers * calls \
            and launches["rmsnorm"] == k2_per_model_call(mcfg) * calls, \
            (o["rank"], launches, calls)
        assert o["rs_rel_err"] <= BF16_ORACLE_TOL, o["rs_rel_err"]
        assert o["swap_counts"][0] >= 1 and o["swap_counts"][1] > 0 \
            and o["swap_counts"][1] == o["swap_counts"][2], o["swap_counts"]
        assert o["swap"] == outs[0]["solo"], f"rank {o['rank']}: swap"
    emit({"phase": "serve_mesh_2", "arch": mcfg.name, "dtype": mcfg.dtype,
          "layers": MESH_LAYERS, "backend": "gloo", "world": 2,
          "device": "cuda:0 (both ranks)", "nvidia_smi": smi,
          "requests": MESH_REQUESTS, "max_new": MESH_NEW,
          "tokens_identical_to_plain": True,
          "phase_s": [p["serve_mesh_2"] for p in parts],
          "ranks": [{k: o[k] for k in (
              "rank", "wall_s", "launches", "model_calls",
              "host_ms_per_dispatch", "metrics", "slab",
              "peak_device_bytes", "rs_max_abs_err", "rs_rel_err",
              "rs_greedy_agreement", "swap_counts")} for o in outs]})
    return outs[0]["launches"]


def moe_mesh_2_report(cfg, outs, smi, parts):
    """moe_mesh_2: olmoe-1b-7b at full width, ``MOE_MESH_LAYERS`` layers,
    on the two ranks.  The KV-only mesh engine (8 of 16 heads a rank, the
    weights replicated) serves ``mesh_workload`` with rank 0's plain
    engine's tokens on every rank; each rank's K1 launches are a layer a
    model call (at its 8 over 8 heads) and K2's ``k2_per_model_call``,
    nothing else.  The TP layout (expert stacks split inside each expert)
    on one 256-token chunk: identity mode bitwise the replicated forward;
    reduce-scatter, run on the replicated forward's expert picks, within
    ``BF16_ORACLE_TOL`` on the chunk and on one decode step of 8 rows after
    it; run on its own picks, its greedy agreement, logits' distance and
    (layer, token) expert sets that flipped, reported apart (routing is
    discontinuous).  Each rank's
    param bytes (replicated and TP) and peak memory."""
    plain = outs[0]["plain"]
    for o in outs:
        assert o["tokens"] == plain, f"rank {o['rank']}: moe tokens differ"
        assert o["slab"][-2] == cfg.n_kv_heads // 2, o["slab"]
        calls, launches = o["model_calls"], o["launches"]
        assert launches["paged_attention"] == cfg.n_layers * calls \
            and launches["rmsnorm"] == k2_per_model_call(cfg) * calls, \
            (o["rank"], launches, calls)
        assert all(v == 0 for k, v in launches.items()
                   if k not in ("paged_attention", "rmsnorm")), launches
        assert o["identity_bitwise"] and o["identity_route_flips"] == 0, \
            (o["identity_bitwise"], o["identity_route_flips"])
        assert o["rs_forced_flips"] == 0, o["rs_forced_flips"]
        assert o["rs_prefill_rel_err"] <= BF16_ORACLE_TOL \
            and o["rs_decode_rel_err"] <= BF16_ORACLE_TOL, \
            (o["rs_prefill_rel_err"], o["rs_decode_rel_err"])
        assert o["tp_param_bytes"] < o["metrics"]["param_bytes_replicated"]
    emit({"phase": "moe_mesh_2", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "backend": "gloo", "world": 2,
          "device": "cuda:0 (both ranks)", "nvidia_smi": smi,
          "requests": MESH_REQUESTS, "max_new": MESH_NEW,
          "tokens_identical_to_plain": True,
          "phase_s": [p["moe_mesh_2"] for p in parts],
          "ranks": [{k: o.get(k) for k in (
              "rank", "wall_s", "launches", "model_calls",
              "host_ms_per_dispatch", "metrics", "slab", "tp_param_bytes",
              "peak_device_bytes", "peak_device_bytes_tp",
              "identity_bitwise", "rs_prefill_rel_err", "rs_decode_rel_err",
              "rs_free_prefill_rel_err", "rs_free_decode_rel_err",
              "rs_prefill_greedy_agreement", "rs_decode_greedy_agreement",
              "rs_route_flips")} for o in outs]})
    return outs[0]["launches"]


def gateway_mesh_2_report(cfg, moe_cfg, outs, smi, parts, group_s):
    """gateway_mesh_2: rank 0 runs one in-process ``Gateway`` over a
    router of qwen3-0.6b (``MESH_LAYERS``) and olmoe-1b-7b
    (``MOE_MESH_LAYERS``), both engines on the 2-rank mesh with the KV pool
    on kv-heads, each stepped by its own thread; rank 1 follows both.  8
    streams over HTTP, 4 a model, one closed by its client mid-stream;
    olmoe's engine on both ranks under one ``step`` fault seeded alike.
    Every stream passes ``check_sse``; each that ended ``length`` equals a
    plain engine's tokens on the same weights, the closed one and the
    quarantined one a prefix of them; both ranks cancel and quarantine the
    same request and finish the same tokens; a plain olmoe engine under the
    same fault also quarantines one request and finishes the others with
    the same tokens; after the gateway stops both engines are closed on
    both ranks (rank 1 left ``follow_all``)."""
    rank0 = outs[0]
    assert rank0["health"] == 200 and rank0["faults"] == [None, None], \
        (rank0["health"], rank0["faults"])
    want = rank0["plain"]
    reqs = gateway_mesh_requests(cfg, moe_cfg)
    reasons = []
    for i, ((m, r), s) in enumerate(zip(reqs, rank0["streams"])):
        assert s["status"] == 200 and s["errors"] == [], (i, s)
        full = want[m][0][r.rid]
        reasons.append(s["finish_reason"])
        if s["finish_reason"] == "length":
            assert s["token_ids"] == full, (i, s["token_ids"], full)
        else:
            assert s["finish_reason"] in ("client closed", "error"), s
            assert s["token_ids"] == full[:len(s["token_ids"])], (i, s)
    assert reasons.count("client closed") == 1 \
        and reasons[GATEWAY_MESH_CANCEL[0]] == "client closed", reasons
    assert reasons.count("error") == 1 and reqs[reasons.index(
        "error")][0] == 1, reasons
    for k in range(2):
        a, b = (o["engines"][k] for o in outs)
        assert a["finished"] == b["finished"] and a["cancelled"] == \
            b["cancelled"] and a["errored"] == b["errored"], k
        assert a["invariants"] == [] and b["invariants"] == [], k
        assert a["closed"] and b["closed"], k
    assert len(rank0["engines"][0]["cancelled"]) == 1
    assert len(rank0["engines"][1]["errored"]) == 1 \
        and rank0["engines"][1]["step_crashes"] == 1
    assert rank0["engines"][0]["errored"] == []
    fin, err = want[2]
    assert len(err) == 1 and all(want[1][0][rid] == t
                                 for rid, t in fin.items()), (err, fin)
    emit({"phase": "gateway_mesh_2", "archs": [cfg.name, moe_cfg.name],
          "layers": [cfg.n_layers, moe_cfg.n_layers], "dtype": cfg.dtype,
          "backend": "gloo", "world": 2, "device": "cuda:0 (both ranks)",
          "nvidia_smi": smi, "fault": GATEWAY_MESH_FAULT,
          "streams": [{k: s.get(k) for k in ("model", "finish_reason",
                                             "ttft_s")}
                      | {"tokens": len(s["token_ids"])}
                      for s in rank0["streams"]],
          "quarantined": rank0["engines"][1]["errored"],
          "cancelled": rank0["engines"][0]["cancelled"],
          "plain_under_fault_quarantined": err,
          "serve_s": rank0["serve_s"],
          "streams_wall_s": rank0["streams_wall_s"],
          "follower_steps": outs[1]["follower_steps"],
          "phase_s": [p["gateway_mesh_2"] for p in parts],
          "mesh_group_s": group_s})


TENANTS = ("tenant-0", "tenant-1", "tenant-2", "tenant-3")
# at qwen3-0.6b's widths: launches of the fused LoRA kernel per dispatch
# with an adapter row (7 adapted projections x 28 layers), and the adapter
# slab of
# the store's defaults (8 slots x 28 layers x rank 16 x 22,528 summed
# d_in + d_out of the 7 projections x 2 B)
LORA_PER_DISPATCH = 7 * 28
LORA_SLAB_BYTES = 8 * 28 * 16 * 22528 * 2


def lora_serve_phase(torch, cfg, params, base):
    """Multi-LoRA serving: the serve phase's engine with four tenants
    loaded (rank 8, alpha 16) serves the same 16 requests, every fifth one
    base; the fused LoRA kernel launches once per adapted projection and
    layer of every dispatch that holds an adapter row, and never otherwise,
    and K5 and K6 never launch on their own.  The host time of a dispatch
    is printed beside the base serve phase's."""
    eng = serve_engine(cfg, params)
    for name in TENANTS:
        eng.load_adapter(name, rank=8, alpha=16.0)
    tally, counted = dispatch_timer()
    launches, m, out = run_workload(
        torch, eng, workload(cfg.vocab, tenants=(None,) + TENANTS), counted)
    dispatches = {k: sum(n for key, (n, _) in tally.items()
                         if key.endswith(k)) for k in ("lora", "base")}
    per = len(eng.adapters.projs) * cfg.n_layers
    assert per == LORA_PER_DISPATCH, per
    assert dispatches["lora"] > 0, dispatches
    assert launches["lora_delta"] == per * dispatches["lora"], \
        (launches, dispatches)
    assert launches["lora_shrink"] == launches["lora_expand"] == 0, launches
    assert launches["paged_attention"] > 0 and launches["rmsnorm"] > 0
    assert m.adapter_device_bytes == LORA_SLAB_BYTES, m.adapter_device_bytes
    assert sorted(m.per_tenant) == sorted(("base",) + TENANTS), m.per_tenant
    emit({"phase": "lora_serve", "arch": cfg.name, "dtype": cfg.dtype, **out,
          "tenants": list(TENANTS), "lora_block_out": eng.lora_block_out,
          "rank_cap": eng.adapters.rank_cap,
          "adapter_device_bytes": m.adapter_device_bytes,
          "dispatches": dispatches, "lora_launches_per_lora_dispatch": per,
          "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "per_tenant": m.per_tenant,
          "base_serve": {k: base[k] for k in (
              "engine_steps", "wall_s", "tokens_per_sec", "ttft_mean_s",
              "ttft_max_s", "itl_mean_s", "launches_per_step",
              "host_ms_per_dispatch")}})
    del eng
    torch.cuda.empty_cache()
    return launches


def lora_identity_phase(torch, cfg, params):
    """Greedy, 4 requests x 12 tokens: base rows with tenants loaded and
    pinned equal an adapter-free engine's with no LoRA launch; a rank-0
    tenant gives the base tokens; one prompt under two tenants gives two
    streams and neither adopts the other's prefix."""
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in (150, 300, 520, 700)]

    def engine():
        return ServeEngine(cfg, params, max_batch=4, max_len=1024,
                           block_size=16, prefill_chunk_tokens=256)

    def serve(eng, adapter_id=None, ps=prompts):
        reqs = [Request(rid=i, prompt=list(p), max_new=12,
                        adapter_id=adapter_id) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done and not r.rejected for r in reqs)
        return [r.out for r in reqs]

    base = serve(engine())
    eng = engine()
    for name in TENANTS:
        eng.load_adapter(name, rank=8, alpha=16.0)
        eng.adapters.pin(name)
    zero_counts()
    with_tenants = serve(eng)
    torch.cuda.synchronize()
    n = read_counts()
    assert with_tenants == base, "base tokens moved with tenants loaded"
    assert n["lora_shrink"] == n["lora_expand"] == n["lora_delta"] == 0, n
    eng.load_adapter("null-tenant", rank=0)
    rank0 = serve(eng, "null-tenant")
    assert rank0 == base, "a rank-0 tenant changed the base tokens"
    del eng
    eng = engine()
    for name in TENANTS[:2]:
        eng.load_adapter(name, rank=8, alpha=16.0)
    hits = []
    outs = []
    for name in (TENANTS[0], TENANTS[1], TENANTS[0]):
        eng.reset_metrics()
        outs.append(serve(eng, name, prompts[1:2])[0])
        m = eng.metrics()
        hits.append({"tenant": name, "shared_blocks": m.shared_blocks,
                     "re_prefill_avoided": m.re_prefill_avoided})
    assert outs[0] != outs[1], "two tenants gave the same tokens"
    assert hits[1]["shared_blocks"] == hits[1]["re_prefill_avoided"] == 0, \
        hits
    assert hits[2]["re_prefill_avoided"] > 0, hits
    emit({"phase": "lora_identity", "requests": len(prompts),
          "tokens_each": 12, "base_identical_with_tenants": True,
          "lora_launches_on_base_requests": n["lora_shrink"]
          + n["lora_expand"] + n["lora_delta"], "rank0_identical": True,
          "two_tenants_differ": True, "prefix_hits": hits,
          "same_tenant_reuse_identical": outs[2] == outs[0]})
    del eng
    torch.cuda.empty_cache()


def plan_identity(torch, cfg, params):
    """Greedy tokens with kernel planning on and off: the paged kernel takes
    the plan's pages_per_fetch and does not use it, so they must be equal."""
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in (150, 300, 520, 700)]
    outs, ppf = [], []
    for plan in (True, False):
        eng = ServeEngine(cfg, params, max_batch=4, max_len=1024,
                          block_size=16, prefill_chunk_tokens=256,
                          plan_kernels=plan)
        reqs = [Request(rid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs.append([r.out for r in reqs])
        ppf.append(eng.pages_per_fetch)
        del eng
    emit({"phase": "plan_identity", "pages_per_fetch_on_off": ppf,
          "requests": len(prompts), "tokens_each": 12,
          "identical": outs[0] == outs[1]})
    assert outs[0] == outs[1], "planning changed greedy tokens"


# device kernel-name fragments of each ported kernel on the serve paths
# (K1: the split-KV kernel and its combine, the bf16 chunk kernel)
PROFILE_KERNELS = {"paged_attention": ("paged_split_kernel",
                                       "paged_combine_kernel",
                                       "paged_chunk_mma_kernel"),
                   "rmsnorm": ("rmsnorm",), "ssm_scan": ("ssm_scan",)}


def profiled(cfg) -> list:
    """The profiler's activities: device events, and the CPU ops only on
    an MoE arch, whose expert products are told apart by the op that
    launched them (``bmm_kernel_us``); every other group is read from the
    device events, and recording the CPU ops costs most of the trace's
    processing."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cfg.moe is not None else [])


def bmm_kernel_us(prof) -> dict:
    """Device µs of the kernels that ``aten::bmm`` calls launched, by
    kernel name: on an MoE arch, the expert products (the port's other
    GEMMs are ``aten::mm``/``addmm``; the router is a matmul)."""
    out = {}
    for e in prof.events():
        if e.name == "aten::bmm":
            for k in e.kernels:
                out[k.name] = out.get(k.name, 0.0) + k.duration
    return out


def profile_phase(torch, cfg, params=None, steps=12, phase="profile"):
    """Device busy time by kernel over a steady window of engine steps
    (torch.profiler), against the window's host wall time.  Builds the
    arch's weights from seed 0 unless ``params`` is given.  On an MoE arch
    the expert products (``bmm_kernel_us``) are a group of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    if params is None:
        params = build_model(cfg, DEV).init(0)
    eng = ServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=16,
                      prefill_chunk_tokens=256)
    for r in workload(cfg.vocab, n=12, seed=1):
        eng.submit(r)
    for _ in range(6):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=profiled(cfg)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
        counts[e.key] = counts.get(e.key, 0) + e.count
    groups = {"paged_attention": 0.0, "rmsnorm": 0.0, "ssm_scan": 0.0,
              "gemm": 0.0, "other": 0.0}
    ported = {"paged_attention": 0, "rmsnorm": 0, "ssm_scan": 0}
    bmm = bmm_kernel_us(prof) if cfg.moe is not None else {}
    if cfg.moe is not None:
        groups["expert_bmm"] = 0.0
    for name, us in kernels.items():
        low = name.lower()
        if name in bmm:
            part = min(us, bmm[name])
            groups["expert_bmm"] += part
            us -= part
        hit = next((k for k, frags in PROFILE_KERNELS.items()
                    if any(f in low for f in frags)), None)
        if hit is not None:
            groups[hit] += us
            # a wrapper call is one launch: K1's split-KV combine (its
            # second kernel) adds time, not launches
            if "combine" not in low:
                ported[hit] += counts[name]
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": phase, "arch": cfg.name, "steps": steps,
          "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3,
          "device_idle_share": 1 - busy / wall_us if wall_us else None,
          "busy_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
          "ported_kernels": {k: {"launches": n,
                                 "device_us_per_launch":
                                 groups[k] / n if n else None}
                             for k, n in ported.items()},
          "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]})
    del eng, params
    torch.cuda.empty_cache()


SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "zamba2-2.7b"


def stateful_serve_phase(torch, cfg, params):
    """ssm_serve / hybrid_serve: the serve workload through the full-width
    ssm or hybrid arch.  Every request finishes with the invariants clean
    after every step and the slab empty at the end; per dispatch, K7
    launches once per Mamba1 layer (ssm) or never (hybrid), K1 once per
    shared-block call site (hybrid) or never (ssm), K2 at least once; the
    attention-free engine allocates no KV block."""
    eng = serve_engine(cfg, params)
    ssm = cfg.family == "ssm"
    sites = 0 if ssm else cfg.n_layers // cfg.hybrid.attn_every
    # a prefill chunk launches K7 once per layer, over all its positions
    want = {"prefill": {"ssm_scan": cfg.n_layers if ssm else 0,
                        "paged_attention": sites},
            "decode": {"ssm_scan": cfg.n_layers if ssm else 0,
                       "paged_attention": sites}}
    per = {"prefill": [], "decode": []}

    def counted(kind, batch, call):
        n0 = read_counts()
        out = call()
        n1 = read_counts()
        per[kind].append({k: n1[k] - n0[k] for k in n1})
        return out
    launches, m, out = run_workload(torch, eng, workload(cfg.vocab), counted)
    for kind, deltas in per.items():
        assert deltas, f"{cfg.name}: no {kind} dispatch"
        for dl in deltas:
            assert all(dl[k] == v for k, v in want[kind].items()) \
                and dl["rmsnorm"] > 0, (kind, dl, want)
    assert launches["ssm_scan"] == sum(
        want[k]["ssm_scan"] * len(v) for k, v in per.items()), launches
    assert launches["lora_shrink"] == launches["lora_delta"] \
        == launches["matmul"] == 0, launches
    if ssm:
        assert m.peak_blocks_used == 0 and eng.kernel_plan is None, m
    slab = sum(t.numel() * t.element_size()
               for t in (eng.cache.values() if ssm
                         else eng.cache["ssm"].values()))
    emit({"phase": f"{cfg.family}_serve", "arch": cfg.name,
          "dtype": cfg.dtype, **out,
          "prefill_chunk_tokens": eng.prefill_chunk_tokens,
          "dispatches": {k: len(v) for k, v in per.items()},
          "launches_per_dispatch": want, "state_slots": eng.state_slots,
          "state_slab_bytes": slab,
          "param_bytes": eng.param_bytes_per_device})
    del eng
    torch.cuda.empty_cache()
    return launches


def swap_resume_phase(torch, cfg, params, preempt_at=4):
    """One greedy request (300-token prompt, 12 new tokens) preempted by
    swap after ``preempt_at`` tokens: its state parks on the slab's host
    tier, comes back, and the request gives the unpreempted run's tokens."""
    from repro_torch.serve.engine import Request
    prompt = np.random.default_rng(10).integers(1, cfg.vocab,
                                                size=300).tolist()

    def serve(at):
        eng = serve_engine(cfg, params)
        r = Request(rid=0, prompt=list(prompt), max_new=12)
        eng.submit(r)
        tier = None
        while eng.step():
            assert eng.check_invariants() == []
            if at and tier is None and len(r.out) >= at:
                eng._requeue(next(a for a in eng.slots if a is not None))
                tier = eng._parked[0].state.tier
        m = eng.metrics()
        assert r.done and eng.state_store.device.pool.num_used == 0
        del eng
        return r.out, tier, m
    base, _, _ = serve(0)
    resumed, tier, m = serve(preempt_at)
    emit({"phase": f"{cfg.family}_swap_resume", "arch": cfg.name,
          "preempted_after_tokens": preempt_at, "parked_tier": tier,
          "swap_out_blocks": m.swap_out_blocks,
          "swap_in_blocks": m.swap_in_blocks,
          "identical": resumed == base})
    assert tier == "host" and m.swap_out_blocks >= 1 \
        and m.swap_in_blocks >= 1, (tier, m)
    assert resumed == base, "swap-resume changed the greedy tokens"
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6: oracle
# ---------------------------------------------------------------------------

def oracle_phase(torch, cfg):
    from repro_torch.models import build_model
    fns = build_model(cfg, DEV)
    params = fns.init(0)
    bs, chunk, steps = 16, 256, 16
    rng = np.random.default_rng(7)
    out = {"phase": "oracle", "dtype": cfg.dtype, "prompts": []}
    worst = 0.0
    for plen in (200, 700):
        prompt = rng.integers(1, cfg.vocab, size=plen).tolist()
        tokens = torch.tensor([prompt], device=DEV)
        cache1, ref_logits = fns.prefill(params, {"tokens": tokens})
        dense = fns.make_cache(1, plen + steps)
        for k in dense:
            dense[k][:, :, :plen] = cache1[k]
        nb = -(-(plen + steps) // bs)
        paged = fns.make_paged_cache(nb + 1, bs)
        table = torch.arange(1, nb + 1, dtype=torch.int32,
                             device=DEV)[None, :]
        for start in range(0, plen, chunk):
            end = min(plen, start + chunk)
            ids = prompt[start:end] + [0] * (chunk - (end - start))
            paged, logits = fns.prefill_chunk(
                params, paged,
                {"tokens": torch.tensor([ids], device=DEV),
                 "block_table": table, "start": start, "prompt_len": end},
                m_used=-(-end // bs))
        got = logits[:, plen - 1 - start]
        gaps, agree = [], 0
        for i in range(steps + 1):
            if i:
                tok = torch.tensor([[forced]], device=DEV)
                dense, ref_logits = fns.decode_step(
                    params, dense, {"token": tok, "cur_len": plen + i - 1})
                paged, got = fns.decode_paged(
                    params, paged,
                    {"token": tok, "block_tables": table,
                     "seq_lens": torch.tensor([plen + i - 1],
                                              dtype=torch.int32,
                                              device=DEV)})
            _, rel = rel_err(got[0], ref_logits[0])
            gaps.append(rel)
            forced = int(ref_logits[0].float().argmax())
            agree += int(int(got[0].float().argmax()) == forced)
        out["prompts"].append({"prompt_len": plen, "max_rel_gap": max(gaps),
                               "greedy_agreement": agree / (steps + 1)})
        worst = max(worst, max(gaps))
    tol = 1e-3 if cfg.dtype == "float32" else BF16_ORACLE_TOL
    out.update(max_rel_gap=worst, tol=tol)
    emit(out)
    assert worst <= tol, f"oracle {cfg.dtype}: rel gap {worst} > {tol}"
    del params, paged, dense
    torch.cuda.empty_cache()


def lora_oracle_phase(torch, cfg, steps=8, chunk=256, bs=16):
    """One tenant's request teacher-forced through the paged path: a
    ``chunk``-token prompt and ``steps`` decode steps at full width, 2
    layers, f32; the LoRA kernels and K1/K2 on the card against the plain
    versions on the CPU, on the same weights and adapter."""
    from repro_torch.models import build_model
    from repro_torch.serve.adapters import AdapterStore
    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    out = {"phase": "lora_oracle", "layers": cfg.n_layers, "dtype": cfg.dtype,
           "prompt_len": chunk, "decode_steps": steps}
    gpu = build_model(cfg, DEV)
    params = gpu.init(0)
    sides = {}
    for dev in (DEV, "cpu"):
        fns = build_model(cfg, dev)
        p = params if dev == DEV else _to(params, "cpu")
        store = AdapterStore(cfg, device=dev)
        slot = store.load(TENANTS[0], rank=8, alpha=16.0)
        nb = -(-(chunk + steps) // bs)
        sides[dev] = (fns, p, fns.make_paged_cache(nb + 1, bs), store, slot)
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, cfg.vocab, size=chunk).tolist()
    nb = -(-(chunk + steps) // bs)
    gaps, logits = [], {}
    zero_counts()
    for i in range(steps + 1):
        for dev, (fns, p, cache, store, slot) in sides.items():
            table = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device=dev)[None, :]
            lora = {"ids": torch.tensor([slot], dtype=torch.int32,
                                        device=dev),
                    "slabs": store.slabs()}
            if i == 0:
                batch = {"tokens": torch.tensor([prompt], device=dev),
                         "block_table": table, "start": 0,
                         "prompt_len": chunk, "lora": lora,
                         "lora_block_out": LORA_BLOCK_OUT}
                _, lg = fns.prefill_chunk(p, cache, batch, m_used=nb)
                logits[dev] = lg[0, chunk - 1]
            else:
                batch = {"token": torch.tensor([[forced]], device=dev),
                         "block_tables": table,
                         "seq_lens": torch.tensor([chunk + i - 1],
                                                  dtype=torch.int32,
                                                  device=dev),
                         "lora": lora, "lora_block_out": LORA_BLOCK_OUT}
                _, lg = fns.decode_paged(p, cache, batch)
                logits[dev] = lg[0]
        want = logits["cpu"]
        gaps.append(rel_err(logits[DEV].cpu(), want)[1])
        forced = int(want.argmax())
    torch.cuda.synchronize()
    n = read_counts()
    per = len(sides[DEV][3].projs) * cfg.n_layers
    assert n["lora_shrink"] == n["lora_expand"] == 0, n
    assert n["lora_delta"] == per * (steps + 1), n
    tol = 1e-3
    out.update(max_rel_gap=max(gaps), gaps=gaps, tol=tol,
               lora_launches=n["lora_delta"])
    emit(out)
    assert max(gaps) <= tol, f"lora oracle: rel gap {max(gaps)} > {tol}"
    del sides, params
    torch.cuda.empty_cache()


def stateful_oracle_phase(torch, cfg, n_layers, steps=8, chunk=256, bs=16):
    """One request teacher-forced through the paged path of the ssm or the
    hybrid arch: a ``chunk``-token prompt into slab slot 1 and ``steps``
    decode steps, full width, ``n_layers`` layers, f32; the kernels on the
    card (K7 on every Mamba1 layer; K1 at head_dim 80 and K2 for the
    hybrid) against the plain versions on the CPU, on the same weights.
    Then the same tokens through the dense path (whole-prompt prefill and
    decode steps, plain attention: no K1) on the card against the CPU, so
    that a gap the paged path shares with it is not K1's."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    out = {"phase": f"{cfg.family}_oracle", "arch": cfg.name,
           "layers": cfg.n_layers, "dtype": cfg.dtype, "prompt_len": chunk,
           "decode_steps": steps}
    params = build_model(cfg, DEV).init(0)
    nb = -(-(chunk + steps) // bs)
    sides = {}
    for dev in (DEV, "cpu"):
        fns = build_model(cfg, dev)
        p = params if dev == DEV else _to(params, "cpu")
        sides[dev] = (fns, p, fns.make_paged_cache(nb + 1, bs, state_slots=2))
    prompt = np.random.default_rng(11).integers(1, cfg.vocab,
                                                size=chunk).tolist()
    gaps, logits, forced_tokens = [], {}, []
    zero_counts()
    for i in range(steps + 1):
        for dev, (fns, p, cache) in sides.items():
            table = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device=dev)[None, :]
            if i == 0:
                batch = {"tokens": torch.tensor([prompt], device=dev),
                         "block_table": table, "state_slot": 1, "start": 0,
                         "prompt_len": chunk}
                _, lg = fns.prefill_chunk(p, cache, batch, m_used=nb)
                logits[dev] = lg[0, chunk - 1]
            else:
                batch = {"token": torch.tensor([[forced]], device=dev),
                         "block_tables": table,
                         "seq_lens": torch.tensor([chunk + i - 1],
                                                  dtype=torch.int32,
                                                  device=dev),
                         "state_slots": torch.tensor([1], dtype=torch.int32,
                                                     device=dev)}
                _, lg = fns.decode_paged(p, cache, batch)
                logits[dev] = lg[0]
        want = logits["cpu"]
        gaps.append(rel_err(logits[DEV].cpu(), want)[1])
        forced = int(want.argmax())
        forced_tokens.append(forced)
    torch.cuda.synchronize()
    n = read_counts()
    if cfg.family == "ssm":
        # one launch per layer for the prompt chunk and per decode step
        assert n["ssm_scan"] == cfg.n_layers * (1 + steps), n
    else:
        sites = cfg.n_layers // cfg.hybrid.attn_every
        assert n["ssm_scan"] == 0 and n["rmsnorm"] > 0 \
            and n["paged_attention"] == sites * (steps + 1), n
    dense_gaps = _dense_oracle_gaps(torch, cfg, sides, prompt,
                                    forced_tokens[:-1])
    tol = 1e-3
    out.update(max_rel_gap=max(gaps), gaps=gaps, tol=tol, launches=n,
               dense_path_max_rel_gap=max(dense_gaps),
               dense_path_gaps=dense_gaps)
    emit(out)
    assert max(gaps) <= tol, f"{cfg.name} oracle: rel gap {max(gaps)} > {tol}"
    assert max(dense_gaps) <= tol, \
        f"{cfg.name} dense oracle: rel gap {max(dense_gaps)} > {tol}"
    del sides, params
    torch.cuda.empty_cache()


def _dense_oracle_gaps(torch, cfg, sides, prompt, forced_tokens):
    """The stateful (or moe) arch's dense path (whole-prompt prefill, then one decode
    step per forced token) on the card against the CPU: each step's largest
    logit gap over the CPU's largest logit."""
    caps = len(prompt) + len(forced_tokens)
    logits, caches = {}, {}
    for dev, (fns, p, _) in sides.items():
        cache, logits[dev] = fns.prefill(
            p, {"tokens": torch.tensor([prompt], device=dev)})
        if cfg.family in ("hybrid", "moe"):
            big = fns.make_cache(1, caps)
            for k in ("k", "v"):
                big[k][:, :, :len(prompt)] = cache[k]
            cache = dict(big, ssm=cache["ssm"]) if "ssm" in cache else big
        caches[dev] = cache
    gaps = [rel_err(logits[DEV][0].cpu(), logits["cpu"][0])[1]]
    for i, tok in enumerate(forced_tokens):
        for dev, (fns, p, _) in sides.items():
            caches[dev], lg = fns.decode_step(
                p, caches[dev], {"token": torch.tensor([[tok]], device=dev),
                                 "cur_len": len(prompt) + i})
            logits[dev] = lg[0]
        gaps.append(rel_err(logits[DEV].cpu(), logits["cpu"])[1])
    del caches
    return gaps


# ---------------------------------------------------------------------------
# Phase 9: the gateway
# ---------------------------------------------------------------------------

# qwen3-0.6b's 16 streams: every fourth names an adapter, t0 and t1 in turn
GATEWAY_ADAPTERS = ("t0", "t1")
GATEWAY_TENANTS = (None, None, None, "t0", None, None, None, "t1")
GATEWAY_SSM_STREAMS = 4
# falcon-mamba-7b's depth behind the gateway (of 64): cut for the time of
# the prefill and decode phases
GATEWAY_SSM_LAYERS = 16
# the qwen stream whose client closes its socket, and after how many tokens
GATEWAY_CANCEL = (4, 6)
GATEWAY_TIMEOUT_S = 300.0
OPEN_LOOP_REQUESTS = 32
OPEN_LOOP_QPS = 2.0
CHAOS_SPEC = "alloc:p=0.1,step:exc=2"


def k2_per_ssm_call(cfg) -> int:
    """K2 launches of one ssm model call: each Mamba1 layer's norm and the
    final norm."""
    return cfg.n_layers + 1


def model_calls(tally, lora=None) -> int:
    return sum(n for k, (n, _) in tally.items()
               if lora is None or k.endswith("_lora") == lora)


def gateway_model(cfg, eng, adapters=()):
    from repro_torch.serve.async_engine import AsyncServeEngine
    from repro_torch.serve.gateway import ByteTokenizer, GatewayModel
    return GatewayModel(model_id=cfg.name,
                        async_engine=AsyncServeEngine(eng, model_id=cfg.name),
                        tokenizer=ByteTokenizer(cfg.vocab),
                        adapters=list(adapters))


def drained(eng) -> dict:
    """After the steppers stopped: both tiers of the block pool (and of the
    state slab) empty once the prefix registry is dropped, no reservation
    left, the invariants clean now and during every crash recovery."""
    eng.release_prefix_cache()
    out = {"pool_used": eng.pool.num_used, "host_used": eng.store.host.num_used,
           "reserved": eng.pool.num_reserved,
           "invariants": eng.check_invariants() + eng.invariant_violations}
    if eng.state_store is not None:
        out["slab_used"] = eng.state_store.device.pool.num_used
        out["slab_host_used"] = eng.state_store.host.num_used
    assert out["invariants"] == [] and all(
        v == 0 for k, v in out.items() if k != "invariants"), out
    return out


def oracle_outputs(cfg, params, reqs, adapters=()):
    """A fresh engine's ``run_until_done`` over ``reqs`` (the same prompts,
    lengths, sampling and adapters) on the same weights and card."""
    from repro_torch.serve.engine import Request
    eng = serve_engine(cfg, params)
    for name in adapters:
        eng.load_adapter(name)
    fresh = [Request(rid=i, prompt=list(r.prompt), max_new=r.max_new,
                     sampling=r.sampling, adapter_id=r.adapter_id)
             for i, r in enumerate(reqs)]
    for r in fresh:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and r.finish_reason == "length" for r in fresh), \
        [r.finish_reason for r in fresh]
    del eng
    return [list(r.out) for r in fresh]


def gateway_phase(torch, cfg, ssm_cfg, smi):
    """One in-process ``Gateway`` on port 0 over a ``Router`` of two engines,
    each on its own stepper thread: full-width qwen3-0.6b (adapters t0 and
    t1 declared, loaded on first use) and full-width falcon-mamba-7b (the
    caller's depth, ``GATEWAY_SSM_LAYERS``).
    ``/health`` and ``/v1/models``; 16 streamed completions to qwen (the
    serve workload, every fourth to ``:t0`` or ``:t1``, one client closing
    its socket after 6 tokens) and 4 to falcon-mamba at once over real HTTP,
    and one ``falcon-mamba-7b:t0`` that must be refused.  Every stream
    passes ``check_sse`` and ends with the reason it must; its tokens equal
    a fresh engine's ``run_until_done`` (the cancelled one's, a prefix);
    the cancel frees blocks the call it lands; both pools drain to zero
    with the invariants clean; the launches of K1, K2, the fused delta and
    K7 over the phase equal what its dispatches imply."""
    import asyncio
    from repro_torch.models import build_model
    from repro_torch.serve.adapters import adapted_projections
    from repro_torch.serve.engine import GREEDY
    from repro_torch.serve.gateway import Gateway, Router
    from tools.gateway_smoke_torch import (check_sse, completion_payload,
                                           latency_summary, sse_payloads,
                                           sse_request)
    t_phase = time.perf_counter()
    qparams = build_model(cfg, DEV).init(0)
    sparams = build_model(ssm_cfg, DEV).init(0)
    qeng, seng = serve_engine(cfg, qparams), serve_engine(ssm_cfg, sparams)
    warm_up(qeng)
    warm_up(seng)
    # one tally an engine: each engine's calls run on its own stepper thread
    qtally, qcounted = dispatch_timer()
    stally, scounted = dispatch_timer()
    wrap_dispatches(qeng, qcounted)
    wrap_dispatches(seng, scounted)
    cancels = []
    engine_cancel = qeng.cancel

    def cancel(rid):
        # runs on qwen's stepper thread: the pool before and after the
        # call, and the table's blocks that only this request holds (not
        # shared with the prefix registry or a neighbour), which the call
        # must free, every one of them
        table = next((a.table.blocks for a in qeng.slots
                      if a is not None and a.req.rid == rid), [])
        alone = sum(1 for b in table if b.refcount == 1)
        before = qeng.pool.num_used
        found = engine_cancel(rid)
        cancels.append({"found": found, "table_blocks": len(table),
                        "blocks_held_alone": alone,
                        "pool_used_before": before,
                        "pool_used_after": qeng.pool.num_used})
        return found
    qeng.cancel = cancel
    qmodel = gateway_model(cfg, qeng, GATEWAY_ADAPTERS)
    smodel = gateway_model(ssm_cfg, seng)
    qreqs = workload(cfg.vocab, tenants=GATEWAY_TENANTS)
    sreqs = workload(ssm_cfg.vocab, n=GATEWAY_SSM_STREAMS, seed=1)

    async def drive():
        async with Gateway(Router([qmodel, smodel]), port=0) as gw:
            host, port = gw.host, gw.port
            health = await sse_request(host, port, None, path="/health")
            models = await sse_request(host, port, None, path="/v1/models")
            asks = []
            for i, r in enumerate(qreqs):
                mid = cfg.name + (f":{r.adapter_id}" if r.adapter_id else "")
                asks.append(sse_request(
                    host, port, completion_payload(mid, r.prompt, r.max_new,
                                                   r.sampling),
                    close_after=GATEWAY_CANCEL[1]
                    if i == GATEWAY_CANCEL[0] else None))
            asks += [sse_request(host, port, completion_payload(
                ssm_cfg.name, r.prompt, r.max_new, r.sampling))
                for r in sreqs]
            asks.append(sse_request(host, port, completion_payload(
                f"{ssm_cfg.name}:t0", sreqs[0].prompt, 4, GREEDY)))
            t0 = time.perf_counter()
            got = await asyncio.wait_for(asyncio.gather(*asks),
                                         GATEWAY_TIMEOUT_S)
            wall = time.perf_counter() - t0
            # the closed stream's cancel lands on the stepper's next turn
            for _ in range(1000):
                if cancels:
                    break
                await asyncio.sleep(0.01)
            return health, models, got, wall

    torch.cuda.synchronize()
    zero_counts()
    health, models, got, wall = asyncio.run(drive())
    torch.cuda.synchronize()
    launches = read_counts()
    for m in (qmodel, smodel):
        assert m.async_engine.fault is None, m.async_engine.fault
    drain = {"qwen": drained(qeng), "ssm": drained(seng)}
    assert all(qeng.adapters.refcount(a) == 0 for a in GATEWAY_ADAPTERS)

    # /health and /v1/models
    assert health["status"] == 200, health
    hbody = json.loads(health["raw"])
    assert hbody["status"] == "ok" and [m["model"] for m in hbody["models"]] \
        == [cfg.name, ssm_cfg.name], hbody
    assert models["status"] == 200, models
    cards = [c["id"] for c in json.loads(models["raw"])["data"]]
    assert cards == [cfg.name] + [f"{cfg.name}:{a}" for a in GATEWAY_ADAPTERS] \
        + [ssm_cfg.name], cards

    # every stream: framing, reason, tokens against the oracle
    want_q = oracle_outputs(cfg, qparams, qreqs, GATEWAY_ADAPTERS)
    want_s = oracle_outputs(ssm_cfg, sparams, sreqs)
    streams = []
    for i, (r, res, want) in enumerate(zip(qreqs + sreqs, got,
                                           want_q + want_s)):
        assert res["status"] == 200, (i, res["status"], res["raw"][:200])
        mid = cfg.name if i < len(qreqs) else ssm_cfg.name
        if i == GATEWAY_CANCEL[0]:
            # cut short by its client: framed line by line, no [DONE]
            assert res["closed_early"], i
            payloads, errs = sse_payloads(res["raw"])
            assert len(errs) == 1 and "[DONE]" in errs[0], errs
            ids = [t for p in payloads
                   for t in json.loads(p)["choices"][0]["token_ids"]]
            assert ids == want[:len(ids)] and GATEWAY_CANCEL[1] <= len(ids) \
                < r.max_new, (ids, want)
            streams.append({"model": mid, "finish_reason": "client closed",
                            "tokens": len(ids), "oracle_prefix": True})
            continue
        sse = check_sse(res["raw"], prompt_tokens=len(r.prompt))
        assert sse["errors"] == [], (i, sse["errors"])
        assert sse["finish_reason"] == "length", (i, sse["finish_reason"])
        tag = mid + (f":{r.adapter_id}" if r.adapter_id else "")
        assert sse["model"] == tag, (i, sse["model"], tag)
        assert sse["token_ids"] == want, (i, sse["token_ids"], want)
        streams.append({"model": tag, "finish_reason": "length",
                        "tokens": len(want), "oracle_identical": True})
    refused = got[-1]
    refusal = (f"http {refused['status']}" if refused["status"] != 200
               else check_sse(refused["raw"])["finish_reason"])
    assert refused["status"] in (400, 404) \
        or refusal.startswith("rejected"), refusal
    assert b"token_ids" not in refused["raw"], refused["raw"][:200]

    # the cancel: found in a slot; every block only it held freed by that
    # call (the shared ones go back when the prefix registry drops them)
    cancelled = qeng.cancelled
    assert len(cancels) == 1 and cancels[0]["found"] and \
        cancels[0]["blocks_held_alone"] >= 1 and \
        cancels[0]["pool_used_before"] - cancels[0]["pool_used_after"] \
        == cancels[0]["blocks_held_alone"], cancels
    assert len(cancelled) == 1 and cancelled[0].finish_reason == "cancelled" \
        and cancelled[0].prompt == qreqs[GATEWAY_CANCEL[0]].prompt, cancelled

    # launches against the dispatches
    q_calls, s_calls = model_calls(qtally), model_calls(stally)
    lora_calls = model_calls(qtally, lora=True)
    implied = {"paged_attention": cfg.n_layers * q_calls,
               "rmsnorm": k2_per_model_call(cfg) * q_calls
               + k2_per_ssm_call(ssm_cfg) * s_calls,
               "lora_delta": len(adapted_projections(cfg)) * cfg.n_layers
               * lora_calls,
               "ssm_scan": ssm_cfg.n_layers * s_calls}
    assert lora_calls > 0 and s_calls > 0
    assert all(launches[k] == v for k, v in implied.items()), \
        (launches, implied)
    assert all(v == 0 for k, v in launches.items() if k not in implied), \
        launches
    emit({"phase": "gateway", "card": smi, "archs": [cfg.name, ssm_cfg.name],
          "dtype": cfg.dtype, "streams": streams, "refused_adapter": refusal,
          "cancel": cancels[0], "drain": drain,
          "latency": latency_summary([g for g in got[:-1]
                                      if not g["closed_early"]], wall),
          "launches": {k: launches[k] for k in implied},
          "implied_launches": implied,
          "dispatches": {"qwen": q_calls, "qwen_lora": lora_calls,
                         "ssm": s_calls},
          "host_ms_per_dispatch": {
              "qwen": host_ms_per_dispatch(qtally),
              "ssm": host_ms_per_dispatch(stally)},
          "seconds": time.perf_counter() - t_phase})
    del qeng, seng, qmodel, smodel, sparams
    torch.cuda.empty_cache()
    return qparams


def gateway_open_loop_phase(torch, cfg, params, smi):
    """qwen3-0.6b alone behind the gateway: 32 requests of the serve
    workload as Poisson arrivals at 2 a second, all streamed; each ends
    with ``length`` after 32 tokens and passes ``check_sse``; no block is
    left once they drained.  TTFT and inter-token latency percentiles as
    the clients see them, delivered tokens/s and the wall time; K2 and K1
    launches against the dispatches."""
    import asyncio
    from repro_torch.serve.gateway import Gateway, Router
    from tools.gateway_smoke_torch import (check_sse, completion_payload,
                                           latency_summary, open_loop,
                                           poisson_arrivals)
    t_phase = time.perf_counter()
    eng = serve_engine(cfg, params)
    warm_up(eng)
    tally, counted = dispatch_timer()
    wrap_dispatches(eng, counted)
    model = gateway_model(cfg, eng)
    reqs = workload(cfg.vocab, n=OPEN_LOOP_REQUESTS)
    payloads = [completion_payload(cfg.name, r.prompt, r.max_new, r.sampling)
                for r in reqs]
    arrivals = poisson_arrivals(len(reqs), OPEN_LOOP_QPS, seed=1)

    async def drive():
        async with Gateway(Router([model]), port=0) as gw:
            return await asyncio.wait_for(
                open_loop(gw.host, gw.port, payloads, arrivals),
                GATEWAY_TIMEOUT_S)

    torch.cuda.synchronize()
    zero_counts()
    results, wall = asyncio.run(drive())
    torch.cuda.synchronize()
    launches = read_counts()
    assert model.async_engine.fault is None, model.async_engine.fault
    reasons = {}
    for r, res in zip(reqs, results):
        sse = check_sse(res["raw"], prompt_tokens=len(r.prompt))
        assert res["status"] == 200 and sse["errors"] == [], sse["errors"]
        reasons[sse["finish_reason"]] = reasons.get(sse["finish_reason"],
                                                    0) + 1
        assert len(sse["token_ids"]) == r.max_new, len(sse["token_ids"])
    assert reasons == {"length": len(reqs)}, reasons
    drain = drained(eng)
    calls = model_calls(tally)
    assert launches["rmsnorm"] == k2_per_model_call(cfg) * calls \
        and launches["paged_attention"] == cfg.n_layers * calls, \
        (launches, calls)
    m = eng.metrics()
    emit({"phase": "gateway_open_loop", "card": smi, "arch": cfg.name,
          "dtype": cfg.dtype, "qps": OPEN_LOOP_QPS,
          **latency_summary(results, wall), "finish_reasons": reasons,
          "engine_ttft_mean_s": m.ttft_mean_s,
          "engine_itl_mean_s": m.itl_mean_s,
          "engine_steps": m.engine_steps, "preemptions": m.preemptions,
          "peak_blocks_used": m.peak_blocks_used, "drain": drain,
          "launches": {k: launches[k]
                       for k in ("paged_attention", "rmsnorm")},
          "dispatches": calls,
          "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "seconds": time.perf_counter() - t_phase})
    del eng, model
    torch.cuda.empty_cache()


def gateway_chaos_phase(torch, cfg, params, smi):
    """``tools.chaos_smoke_torch.run_chaos`` on full-width qwen3-0.6b with
    the serve engine's settings: alloc faults at p 0.1 and a step fault
    every second check, 6 requests at 4 a second.  Every stream terminal,
    the step faults fired, no block leaked on either tier, and every
    survivor equal to the fault-free oracle."""
    from tools.chaos_smoke_torch import run_chaos
    from tools.gateway_smoke_torch import Deadline
    t_phase = time.perf_counter()
    report, failures = run_chaos(
        CHAOS_SPEC, seed=1, n_requests=6, qps=4.0,
        deadline=Deadline(GATEWAY_TIMEOUT_S), cfg=cfg, params=params,
        engine_kwargs=dict(max_batch=8, max_len=2048, block_size=16,
                           prefill_chunk_tokens=256))
    emit({"phase": "gateway_chaos", "card": smi, **report,
          "seconds": time.perf_counter() - t_phase})
    assert failures == [], failures
    assert sum(report["outcomes"].values()) == 6, report["outcomes"]
    assert report["step_crashes"] >= 1, "the step faults did not fire"
    assert report["fault_counts"]["step"]["fired"] >= 1, report
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10
TRAIN_LR = 3e-4


def _trainer(cfg, steps, opt_state="f32", seq_len=512, lr=TRAIN_LR, **kw):
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(seq_len=seq_len, global_batch=8, steps=steps,
                         log_every=1, **kw)
    return Trainer(cfg, tcfg, opt_config(lr, steps, opt_state),
                   device=DEV)


def _losses(res, steps, falling=True):
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == steps, res["log"]
    assert all(np.isfinite(losses)), losses
    assert not falling or losses[-1] < losses[0], losses
    return losses


def train_phase(torch, cfg):
    """The training path: full-width qwen3-0.6b in bf16 through ``Trainer``
    (B 8 x S 512, AdamW as the train CLI builds it, remat on), every count
    zeroed just before and read just after.  Each step launches K3's forward
    twice a layer (the forward and the rematerialised recompute), its
    backward once a layer, K2's forward six times a layer plus the final
    norm (ln1, ln2 and the q/k pair, forward and recompute) and its
    backward once for each of those 3n + 1 norms; no serve kernel.  The
    loss is finite and falls.  Then three steps with int8 moments."""
    trainer = _trainer(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses = _losses(res, TRAIN_STEPS)
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 2 * k2_per_model_call(cfg) - 1,
            "rmsnorm_bwd": k2_per_model_call(cfg)}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    assert {k: per_step[k] for k in want} == want, per_step
    assert all(v == 0 for k, v in launches.items() if k not in want), \
        launches
    secs = [e["sec"] for e in res["log"]]
    norms = [e["grad_norm"] for e in res["log"]]
    toks = 8 * 512
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": layers, "batch": 8, "seq_len": 512,
          "steps": TRAIN_STEPS, "losses": losses,
          "grad_norms": norms, "step_s": secs, "wall_s": wall,
          "tokens_per_s_after_step0": toks * (TRAIN_STEPS - 1)
          / sum(secs[1:]),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_per_step": per_step})
    dryrun_calib_phase(torch, cfg, trainer, res["state"], secs, want)
    del trainer, res
    torch.cuda.empty_cache()
    res8 = _trainer(cfg, 3, "int8").train()
    emit({"phase": "train_int8", "arch": cfg.name, "steps": 3,
          "losses": _losses(res8, 3),
          "step_s": [e["sec"] for e in res8["log"]]})
    del res8
    torch.cuda.empty_cache()
    return launches, (losses, norms), toks * (TRAIN_STEPS - 1) \
        / sum(secs[1:])


# the dry run's peak above its arguments over the card's
# max_memory_allocated rise in one more step of the train phase: its lower
# and upper limit.  The first reading (H100 80GB HBM3) was 1.020:
# the analyzer's own tracking on the card matched the allocator's rise
# within 1.5 KB, so the dry run sees every allocation; the 2% is the 1x1
# mesh path's copies of a layer's weights at its one-rank gathers, less the
# allocator's rounding up to its block sizes.  Both are fixed by the
# shapes, so the limits leave 5% below and 8% above the reading.
CALIB_PEAK = (0.97, 1.10)


def dryrun_calib_phase(torch, cfg, trainer, state, step_s, want):
    """dryrun_calib: the train phase's step (B 8 x S 512, ``cfg`` at full
    depth, remat "dots") counted by the dry run on a 1x1 ``DryTrainMesh``
    on meta, and by ``analyze_step`` over one more step of ``trainer`` on
    the card from its trained ``state`` (not timed).  FLOPs equal exactly;
    the K2 and K3 launches equal, the hooks' count equal to the wrappers'
    counters and to ``want`` a step; the dry run's peak above its
    arguments within ``CALIB_PEAK`` of the card's ``max_memory_allocated``
    rise over the step; the roofline's step seconds beside the train
    phase's measured ones (median of steps 1-9)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hardware import H100
    from repro_torch.launch.dryrun import count_train_step
    from repro_torch.launch.hlo_analysis import analyze_step, roofline_terms
    from repro_torch.launch.mesh import dry_train_mesh
    t0 = time.perf_counter()
    dry = count_train_step(cfg, ShapeSpec("train", 512, 8, "train"),
                           dry_train_mesh({"data": 1, "model": 1}))
    dry_s = time.perf_counter() - t0
    batch, _ = trainer.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    card = analyze_step(trainer._step, state["params"], state["opt"], batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - before
    launches = read_counts()
    del card["out"], dry["out"]
    assert card["flops"] == dry["flops"], (card["flops"], dry["flops"])
    assert card["launches"] == dry["launches"] == want, \
        (card["launches"], dry["launches"], want)
    assert {k: launches[k] for k in want} == want, launches
    dry_rise = dry["peak_bytes"] - dry["argument_bytes"]
    ratio = dry_rise / rise
    assert CALIB_PEAK[0] <= ratio <= CALIB_PEAK[1], (dry_rise, rise)
    roof = roofline_terms(dry, H100)
    measured = statistics.median(step_s[1:])
    emit({"phase": "dryrun_calib", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "batch": 8, "seq_len": 512,
          "nvidia_smi": nvidia_smi(), "hardware": H100.name,
          "flops": dry["flops"], "flops_equal": True,
          "kernel_flops": dry["kernel_flops"], "launches": dry["launches"],
          "dry_bytes_traffic": dry["bytes_traffic"],
          "card_bytes_traffic": card["bytes_traffic"],
          "dry_argument_bytes": dry["argument_bytes"],
          "dry_peak_bytes": dry["peak_bytes"], "dry_peak_rise": dry_rise,
          "card_bytes_before": before, "card_max_allocated_rise": rise,
          "card_tracked_peak_rise": card["peak_bytes"]
          - card["argument_bytes"],
          "peak_ratio": ratio, "peak_limits": CALIB_PEAK,
          "card_total_memory":
          torch.cuda.get_device_properties(0).total_memory,
          "record_hbm_bytes": H100.hbm_bytes,
          "roofline": roof, "measured_step_s": measured,
          "measured_over_roofline": measured / roof["step_time_s"],
          "dry_s": dry_s, "card_analyzed_step_s": card_s})


# dryrun_serve_calib: prefill_32k's and decode_32k's batch a device on pod1
# (B 32 and 128 over 16 data ranks): (kind, batch, sequence or capacity)
SERVE_CALIB = (("prefill", 2, 32768), ("decode", 8, 32768))


def _calib_row(torch, cfg, kind, dry, step, args, mesh):
    """One step of ``SERVE_CALIB`` on the card, run under
    ``analyze_step`` with its
    launches counted and the allocator's rise read, and timed: the
    decode step by one call after a warm-up, the prefill (20 s at 32,768
    positions) by the analyzed call itself; the gates of
    ``dryrun_serve_calib_phase``.  Returns the phase's row."""
    from repro_torch.core.hardware import H100
    from repro_torch.launch.hlo_analysis import analyze_step, roofline_terms
    if kind == "decode":
        step(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        measured = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    card = analyze_step(step, *args, mesh=mesh)
    torch.cuda.synchronize()
    if kind == "prefill":
        # the analyzed call (about 13,000 ops' tracking on the host beside
        # a 20-second step; kernels and cuBLAS warm from earlier phases)
        measured = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - before
    launches = read_counts()
    finite = bool(torch.isfinite(card["out"][1]).all())
    del card["out"], dry["out"]
    assert finite, kind
    assert card["flops"] == dry["flops"], (kind, card["flops"], dry["flops"])
    assert card["launches"] == dry["launches"] \
        == {k: v for k, v in launches.items() if v}, \
        (kind, card["launches"], dry["launches"], launches)
    dry_rise = dry["peak_bytes"] - dry["argument_bytes"]
    ratio = dry_rise / rise
    assert CALIB_PEAK[0] <= ratio <= CALIB_PEAK[1], (kind, dry_rise, rise)
    roof = roofline_terms(dry, H100)
    return {"flops": dry["flops"], "flops_equal": True,
            "kernel_flops": dry["kernel_flops"], "launches": dry["launches"],
            "dry_bytes_traffic": dry["bytes_traffic"],
            "card_bytes_traffic": card["bytes_traffic"],
            "dry_argument_bytes": dry["argument_bytes"],
            "dry_peak_bytes": dry["peak_bytes"], "dry_peak_rise": dry_rise,
            "card_bytes_before": before, "card_max_allocated_rise": rise,
            "peak_ratio": ratio, "peak_limits": CALIB_PEAK,
            "roofline": roof, "measured_step_s": measured,
            "measured_over_roofline": measured / roof["step_time_s"]}


def dryrun_serve_calib_phase(torch, cfg, smi):
    """dryrun_serve_calib: qwen3-0.6b at full width and depth, bf16, one
    prefill at prefill_32k's batch a device on pod1 (B 2 x S 32,768) and
    one decode step at decode_32k's (B 8 over a 32,768-position cache at
    ``cur_len`` 32,767), each counted by the dry run on a 1x1
    ``DryTrainMesh`` on meta and by ``analyze_step`` over the same mesh
    step on the card (a 1-rank NCCL group's 1x1 ``TrainMesh``, whose
    one-rank gathers copy what the dry run's do).  FLOPs equal exactly;
    the K2 launches equal, the hooks' count equal to the wrappers'
    counters; the dry run's peak above its arguments within
    ``CALIB_PEAK`` of the card's ``max_memory_allocated`` rise; the
    measured seconds of each step (``_calib_row``) beside the roofline's
    ``step_time_s``, not gated."""
    import tempfile
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hardware import H100
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (dry_train_mesh, make_train_mesh,
                                         process_group)
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import abstract_cache
    rows = {}
    with tempfile.TemporaryDirectory() as tmp, \
            process_group(0, 1, "nccl", os.path.join(tmp, "store"), DEV):
        mesh = make_train_mesh(1, 1)
        fns = build_model(cfg, DEV)
        params = fns.init(0)
        layout = sharding.train_layout(cfg, params, mesh)
        local = sharding.shard_tree(params, layout.params, mesh)
        del params
        gen = torch.Generator(device=DEV).manual_seed(5)
        for kind, batch, seq in SERVE_CALIB:
            t0 = time.perf_counter()
            dry = dryrun.COUNTERS[kind](
                cfg, ShapeSpec(kind, seq, batch, kind),
                dry_train_mesh({"data": 1, "model": 1}))
            dry_s = time.perf_counter() - t0
            if kind == "prefill":
                step = make_prefill_step(cfg, DEV, mesh=mesh)
                tokens = torch.randint(0, cfg.vocab, (batch, seq),
                                       generator=gen, device=DEV,
                                       dtype=torch.int32)
                args = (local, {"tokens": tokens}, layout, True)
            else:
                step = make_decode_step(cfg, DEV, mesh=mesh)
                whole = abstract_cache(cfg, batch, seq)
                specs = sharding.cache_specs(cfg, whole, mesh)
                # the rank's blocks made in place (30 GB of K/V at 1x1)
                cache = {k: torch.empty(t.shape, dtype=t.dtype, device=DEV)
                         .normal_(generator=gen) for k, t in
                         sharding.shard_tree(whole, specs, mesh).items()}
                token = torch.randint(0, cfg.vocab, (batch, 1),
                                      generator=gen, device=DEV,
                                      dtype=torch.int32)
                args = (local, cache, {"token": token, "cur_len": seq - 1},
                        layout, specs, True)
            rows[kind] = {"batch": batch, "seq_len": seq, "dry_s": dry_s,
                          **_calib_row(torch, cfg, kind, dry, step, args,
                                       mesh)}
            del args, step
            torch.cuda.empty_cache()
        del local
    torch.cuda.empty_cache()
    emit({"phase": "dryrun_serve_calib", "arch": cfg.name,
          "dtype": cfg.dtype, "layers": cfg.n_layers, "mesh": "1x1",
          "nvidia_smi": smi, "hardware": H100.name, "steps": rows})


def dryrun_ssm_calib_phase(torch, cfg, params, smi):
    """dryrun_serve_calib (ssm): falcon-mamba-7b's long_500k decode step
    (B 1, at full width and depth, bf16, on the ssm_serve phase's weights)
    counted by the dry run on a 1x1 ``DryTrainMesh`` on meta and by
    ``analyze_step`` over one device's step on the card: FLOPs equal, K7
    launching once a layer in both and in its counter.  The state cache
    does not grow with the sequence, so the step is the decode_32k
    step's at B 1."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.mesh import dry_train_mesh
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import build_model
    spec = SHAPES["long_500k"]
    t0 = time.perf_counter()
    dry = dryrun.count_decode_step(cfg, spec,
                                   dry_train_mesh({"data": 1, "model": 1}))
    dry_s = time.perf_counter() - t0
    cache = build_model(cfg, DEV).make_cache(1, spec.seq_len)
    token = torch.zeros((1, 1), dtype=torch.int32, device=DEV)
    zero_counts()
    card = analyze_step(make_decode_step(cfg, DEV), params, cache,
                        {"token": token})
    launches = read_counts()
    logits = card.pop("out")[1]
    del dry["out"]
    assert bool(torch.isfinite(logits).all())
    assert card["flops"] == dry["flops"], (card["flops"], dry["flops"])
    assert card["launches"]["ssm_scan"] == dry["launches"]["ssm_scan"] \
        == launches["ssm_scan"] == cfg.n_layers, \
        (card["launches"], dry["launches"], launches)
    emit({"phase": "dryrun_serve_calib", "arch": cfg.name,
          "dtype": cfg.dtype, "layers": cfg.n_layers, "shape": spec.name,
          "batch": 1, "nvidia_smi": smi, "flops": dry["flops"],
          "flops_equal": True, "launches": dry["launches"],
          "card_launches": card["launches"],
          "state_bytes": dry["state_bytes"], "dry_s": dry_s})
    del cache, card
    torch.cuda.empty_cache()


TRAIN_MESH_STEPS = 3


def train_mesh_phase(torch, cfg, train_log, train_rate):
    """train_mesh: the train phase's first ``TRAIN_MESH_STEPS`` steps
    through ``Trainer(mesh=make_train_mesh(1, 1))`` on a 1-rank NCCL group
    (gloo off the card): full width and depth, bf16, the same seed and
    optimizer (the train phase's warm-up and cosine), so the mesh step runs
    with its "world" collectives on NCCL (the one-rank "data" and "model"
    axes run none) and the losses and gradient norms are the train
    phase's (``train_log``) bit for bit; K3 and K2 launch as many times a
    step as there.  Reports the collectives a step by kind and bytes,
    tokens/s against the train phase's and peak memory."""
    import tempfile
    from repro_torch.launch.mesh import make_train_mesh, process_group
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    backend = "nccl" if DEV == "cuda" else "gloo"
    steps = TRAIN_MESH_STEPS
    with tempfile.TemporaryDirectory() as tmp, \
            process_group(0, 1, backend, os.path.join(tmp, "store"), DEV):
        mesh = make_train_mesh(1, 1)
        trainer = Trainer(cfg, TrainerConfig(seq_len=512, global_batch=8,
                                             steps=steps, log_every=1),
                          opt_config(TRAIN_LR, TRAIN_STEPS), mesh=mesh,
                          device=DEV)
        if DEV == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = trainer.train()
        if DEV == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        issued = mesh.issued
        del trainer
    losses = _losses(res, steps, falling=False)
    norms = [e["grad_norm"] for e in res["log"]]
    train_losses, train_norms = (x[:steps] for x in train_log)
    secs = [e["sec"] for e in res["log"]]
    rate = 8 * 512 * (steps - 1) / sum(secs[1:])
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 2 * k2_per_model_call(cfg) - 1,
            "rmsnorm_bwd": k2_per_model_call(cfg)}
    per_step = {k: v / steps for k, v in launches.items()}
    emit({"phase": "train_mesh", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": layers, "backend": backend, "mesh": "1x1",
          "batch": 8, "seq_len": 512, "steps": steps, "losses": losses,
          "train_losses": train_losses, "grad_norms": norms,
          "train_grad_norms": train_norms,
          "bitwise_train": (losses, norms) == (train_losses, train_norms),
          "step_s": secs, "wall_s": wall,
          "tokens_per_s_after_step0": rate,
          "train_tokens_per_s_after_step0": train_rate,
          "collectives_per_step": {k: {"calls": n / steps,
                                       "bytes": b / steps,
                                       "host_s": t / steps}
                                   for k, (n, b, t) in issued.items()},
          "peak_device_bytes": torch.cuda.max_memory_allocated()
          if DEV == "cuda" else 0,
          "launches_per_step": per_step})
    assert losses == train_losses, (losses, train_losses)
    assert norms == train_norms, (norms, train_norms)
    assert {k: per_step[k] for k in want} == want, per_step
    assert all(v == 0 for k, v in launches.items() if k not in want), \
        launches
    del res
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return launches


def train_remat_phase(torch, cfg, steps=4):
    """What REPRO_REMAT_POLICY selects: four full-width bf16 steps under
    "dots" and under "nothing", each with its step time (median after step
    0) and peak device memory.  The policy changes what is kept, not what
    is computed, so the losses are equal."""
    runs = {}
    for policy in ("dots", "nothing"):
        os.environ["REPRO_REMAT_POLICY"] = policy
        try:
            trainer = _trainer(cfg, steps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = trainer.train()
            torch.cuda.synchronize()
        finally:
            os.environ.pop("REPRO_REMAT_POLICY")
        secs = [e["sec"] for e in res["log"]]
        runs[policy] = {"losses": _losses(res, steps), "step_s": secs,
                        "median_step_s_after_step0":
                            statistics.median(secs[1:]),
                        "peak_device_bytes":
                            torch.cuda.max_memory_allocated()}
        del trainer, res
        torch.cuda.empty_cache()
    emit({"phase": "train_remat", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "batch": 8, "seq_len": 512,
          "steps": steps, **runs})
    assert runs["dots"]["losses"] == runs["nothing"]["losses"], runs


def at_depth(cfg, n_layers):
    """``cfg`` cut to ``n_layers`` layers (an encoder-decoder: that many
    encoder layers and that many decoder layers), widths kept."""
    kw = {"n_layers": n_layers}
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_enc_layers=n_layers)
    return dataclasses.replace(cfg, **kw)


def train_restart_phase(torch, cfg, n_layers=2, opt_state="f32",
                        phase="train_restart", steps=8, fail_at=6,
                        seq_len=512, every=4):
    """Checkpoint/restart on the card: ``n_layers`` layers at full width,
    bf16, ``steps`` steps checkpointed every ``every`` with a failure
    injected at step ``fail_at`` (restore the last checkpoint, replay); the
    final loss equals a clean run's bit for bit (the reference bounds the
    gap at 5e-3)."""
    import tempfile
    cfg2 = at_depth(cfg, n_layers)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = _trainer(cfg2, steps, opt_state, seq_len, workdir=d,
                       checkpoint_every=every).train(fail_at=fail_at)
        failed_s = time.perf_counter() - t0
        assert res["final_step"] == steps
        from repro_torch.train.checkpoint import list_checkpoints
        ckpts = [s for s, _ in list_checkpoints(d)]
    clean = _trainer(cfg2, steps, opt_state, seq_len).train()
    gap = abs(res["log"][-1]["loss"] - clean["log"][-1]["loss"])
    emit({"phase": phase, "arch": cfg.name, "layers": n_layers,
          "opt_state": opt_state,
          "steps": steps, "checkpoint_every": every, "fail_at": fail_at,
          "checkpoints": ckpts, "replayed_steps": [e["step"]
                                                  for e in res["log"]],
          "final_loss": res["log"][-1]["loss"],
          "clean_final_loss": clean["log"][-1]["loss"], "gap": gap,
          "bitwise": gap == 0.0, "run_with_failure_s": failed_s})
    assert res["log"][-1]["step"] == clean["log"][-1]["step"] == steps - 1
    assert gap == 0.0, f"restart replay differs from the clean run by {gap}"
    torch.cuda.empty_cache()


def _loss_and_grads(torch, cfg, params, batch, remat):
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves, map_tree
    ps = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
    dev = leaves(ps)[0].device
    loss = build_model(cfg, dev).loss(
        ps, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
        remat=remat)
    loss.backward()
    # a leaf the loss does not reach (the VLM's token embedding) has zeros
    return float(loss.detach()), [torch.zeros_like(p) if p.grad is None
                         else p.grad.detach() for p in leaves(ps)]


def train_oracle_phase(torch, cfg):
    """2 layers at full width, f32: ``lm_loss`` and every gradient leaf on
    the card (K2, K3 forward and backward) against the CPU's (their plain
    versions) from the same weights and batch (B 2 x S 512): loss within
    1e-4 relative, each leaf within 1e-3 of its largest value.  On the card,
    remat off, "dots" and "nothing" give the same loss and gradients."""
    from repro_torch.models import build_model
    from repro_torch.train.data import TokenPipeline
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = build_model(cfg2, "cpu").init(0)
    batch = TokenPipeline(cfg2.vocab, 512, 2, seed=5).batch_at(0)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = _loss_and_grads(torch, cfg2, params, batch, False)
    cpu_s = time.perf_counter() - t0
    gpu = _to(params, DEV)
    runs = {}
    for mode in ("off", "dots", "nothing"):
        os.environ["REPRO_REMAT_POLICY"] = "nothing" if mode == "nothing" \
            else "dots"
        runs[mode] = _loss_and_grads(torch, cfg2, gpu, batch, mode != "off")
    os.environ.pop("REPRO_REMAT_POLICY")
    loss, grads = runs["dots"]
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    leaf_rel = [float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for g, w in zip(grads, cpu_grads)]
    remat_gap = 0.0
    bitwise = True
    for mode in ("off", "nothing"):
        other_loss, other = runs[mode]
        remat_gap = max(remat_gap, abs(other_loss - loss) / abs(loss),
                        *(float((a - b).abs().max()
                                / b.abs().max().clamp_min(1e-30))
                          for a, b in zip(other, grads)))
        bitwise = bitwise and other_loss == loss and all(
            torch.equal(a, b) for a, b in zip(other, grads))
    emit({"phase": "train_oracle", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "batch": 2, "seq_len": 512, "loss": loss,
          "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
          "grad_leaves": len(grads), "grad_leaf_rel_err_max": max(leaf_rel),
          "remat_off_dots_nothing_gap": remat_gap,
          "remat_bitwise": bitwise, "cpu_s": cpu_s})
    assert loss_rel <= 1e-4, loss_rel
    assert max(leaf_rel) <= 1e-3, leaf_rel
    assert remat_gap <= 1e-6, remat_gap
    del gpu, runs, grads
    torch.cuda.empty_cache()


def train_profile_phase(torch, cfg, steps=3, opt_state="f32",
                        phase="train_profile"):
    """torch.profiler over ``steps`` full-width bf16 train steps (after one
    warm-up step): the device's idle share of the window and busy time by
    group (K3 forward, K3 backward, K7 forward, K7 backward with dc's
    column sum, GEMMs, K2, everything else; on an MoE arch the expert
    products forward and backward, ``bmm_kernel_us``, apart from the
    GEMMs)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    trainer = _trainer(cfg, steps + 1, opt_state)
    # one train state: the step updates it in place (AdamW.update)
    params, opt = trainer.init_state().values()
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in trainer.pipeline.batch_at(i).items()}
               for i in range(steps + 1)]
    params, opt, _ = trainer._step(params, opt, batches[0])
    torch.cuda.synchronize()
    with profile(activities=profiled(cfg)) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            params, opt, m = trainer._step(params, opt, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
              "ssm_scan_fwd": 0.0, "ssm_scan_bwd": 0.0, "gemm": 0.0,
              "rmsnorm": 0.0, "other": 0.0}
    bmm = bmm_kernel_us(prof) if cfg.moe is not None else {}
    if cfg.moe is not None:
        groups["expert_bmm"] = 0.0
    counts = dict.fromkeys(groups, 0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
        if e.key in bmm:
            part = min(us, bmm[e.key])
            groups["expert_bmm"] += part
            us -= part
        low = e.key.lower()
        if "flash_fwd" in low:
            g = "flash_attention_fwd"
        elif "flash_bwd" in low:
            g = "flash_attention_bwd"
        elif "ssm_scan" in low and any(
                k in low for k in ("bwd", "_dc_", "finish")):
            g = "ssm_scan_bwd"
        elif "ssm_scan_kernel" in low:
            g = "ssm_scan_fwd"
        elif "rmsnorm" in low:
            g = "rmsnorm"
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            g = "gemm"
        else:
            g = "other"
        groups[g] += us
        counts[g] += e.count
    busy = sum(groups.values())
    own = ("ssm_scan_fwd", "ssm_scan_bwd") if cfg.family == "ssm" \
        else ("flash_attention_fwd", "flash_attention_bwd")
    assert all(groups[g] > 0 for g in own) and groups["gemm"] > 0, groups
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": phase, "arch": cfg.name, "steps": steps,
          "opt_state": opt_state,
          "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": 1 - busy / wall_us,
          "busy_share_by_group": {k: v / busy for k, v in groups.items()},
          "busy_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
          "launches_by_group": counts,
          "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top]})
    del trainer, params, opt
    torch.cuda.empty_cache()


TRAIN_STATEFUL_STEPS = 5
# train_hybrid_oracle and its restart: one segment of this many Mamba2
# layers before the shared block (zamba2-2.7b's segments hold 6; 3 here
# until the examples phase needed the time)
HYBRID_ORACLE_SEGMENT = 2
# train_ssm_restart and train_hybrid_restart: (steps, the step that fails,
# the checkpoint interval)
STATEFUL_RESTART = (4, 3, 2)


def stateful_train_launches(cfg) -> dict:
    """Launches (K2 and K7 backward: calls) of one remat train step of the
    ssm, hybrid or moe arch, by counter.  ssm: each layer's scan through
    SSMScanFn in the forward and again in the recompute, its backward once;
    the layer's norm likewise, plus the final norm.  hybrid: the shared
    block's attention once a segment and again in the recompute, its
    backward once; two norms a Mamba2 layer (ln and the gated norm) and two
    a shared-block call (ln1, ln2) likewise, plus the final norm.  moe: as
    the dense train phase, K3 twice a layer and its backward once, K2's
    model call twice less the final norm and its backward once (olmoe: 32 /
    16 and 97 / 49); vlm likewise; audio: ``encdec_launches``."""
    n = cfg.n_layers
    if cfg.family == "audio":
        return encdec_launches(cfg)["train"]
    if cfg.family in ("moe", "vlm"):
        return {"flash_attention": 2 * n, "flash_attention_bwd": n,
                "rmsnorm": 2 * k2_per_model_call(cfg) - 1,
                "rmsnorm_bwd": k2_per_model_call(cfg)}
    if cfg.family == "ssm":
        return {"ssm_scan": 2 * n, "ssm_scan_bwd": n, "rmsnorm": 2 * n + 1,
                "rmsnorm_bwd": n + 1}
    segs = n // cfg.hybrid.attn_every
    norms = 2 * n + 2 * segs
    return {"flash_attention": 2 * segs, "flash_attention_bwd": segs,
            "rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1}


# falcon-mamba-7b's depth for the run whose loss must fall with f32 moments
# (16 of its 64 layers: 51.4 GB peak on an NVIDIA H100 80GB HBM3 while the
# optimizer held two train states; the depth is kept so the gate compares)
SSM_F32_LAYERS = 16


def train_stateful_phase(torch, cfg, opt_state, f32_layers=SSM_F32_LAYERS,
                         seq_len=512, phase=None, lr=TRAIN_LR):
    """train_ssm / train_hybrid / train_moe (and train_whisper at S 448,
    train_vlm at 2 layers; ``phase`` names them): the full-width arch in
    bf16 through
    ``Trainer`` (B 8 x S 512, AdamW as the train CLI builds it with the
    given moments, remat on), every count zeroed just before and read just
    after: finite losses, step seconds, tokens/s without step 0, peak
    memory, and exactly ``stateful_train_launches`` a step (no other
    kernel); the last loss below the first.  With int8 moments (falcon-
    mamba-7b, whose f32 moments do not fit) that last gate is held on a
    second run at full width and ``f32_layers`` layers with f32 moments:
    the reference's int8 scheme quantizes v in blocks against their
    largest value, and from the second update the loss of the 64-layer run
    rises (PERF.md, Findings), so its losses are reported, not gated
    (olmoe-1b-7b trains with int8 moments too: f32 ones leave about 2 GB of
    the card for activations)."""
    from repro_torch.launch.train import state_bytes
    steps = TRAIN_STATEFUL_STEPS
    trainer = _trainer(cfg, steps, opt_state, seq_len, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = _losses(res, steps, falling=opt_state == "f32")
    want = stateful_train_launches(cfg)
    per_step = {k: v / steps for k, v in launches.items()}
    assert {k: per_step[k] for k in want} == want, (per_step, want)
    assert all(v == 0 for k, v in launches.items() if k not in want), \
        launches
    secs = [e["sec"] for e in res["log"]]
    norms = [e["grad_norm"] for e in res["log"]]
    toks = 8 * seq_len
    del trainer, res
    torch.cuda.empty_cache()
    f32_run = {}
    if opt_state != "f32":
        cut = at_depth(cfg, f32_layers)
        torch.cuda.reset_peak_memory_stats()
        res = _trainer(cut, steps, seq_len=seq_len, lr=lr).train()
        f32_run = {"f32_moments_run": {
            "layers": f32_layers, "losses": _losses(res, steps),
            "step_s": [e["sec"] for e in res["log"]],
            "peak_device_bytes": torch.cuda.max_memory_allocated()}}
        del res
        torch.cuda.empty_cache()
    emit({"phase": phase or f"train_{cfg.family}", "arch": cfg.name,
          "dtype": cfg.dtype, "opt_state": opt_state,
          "layers": cfg.n_layers, "batch": 8, "seq_len": seq_len,
          "steps": steps, "lr": lr, "losses": losses,
          "grad_norms": norms,
          "step_s": secs, "wall_s": wall,
          "tokens_per_s_after_step0": toks * (steps - 1) / sum(secs[1:]),
          "peak_device_bytes": peak,
          "state_bytes_reckoned": state_bytes(cfg, opt_state),
          "last_loss_below_first": losses[-1] < losses[0],
          "launches": launches, "launches_per_step": per_step, **f32_run})
    return launches


def _leaf_gaps(grads, want) -> list:
    """Each gradient leaf's largest gap from ``want``'s, over ``want``'s
    largest value."""
    return [float((g.cpu() - w.cpu()).abs().max()
                  / w.cpu().abs().max().clamp_min(1e-30))
            for g, w in zip(grads, want)]


def train_stateful_oracle_phase(torch, cfg, n_layers, opt_state,
                                witness=True, restart=(8, 6, 4),
                                seq_len=512, phase=None, restart_layers=None):
    """``n_layers`` layers at full width (1 Mamba1 layer; 1 hybrid
    segment, ``HYBRID_ORACLE_SEGMENT`` Mamba2 layers and 1 shared-block
    call; 1 MoE layer; 2 + 2 encoder-decoder layers),
    f32, B 2 x S 512:
    the loss and every gradient leaf on the card (K7 forward and backward,
    or K3 at head_dim 80, and K2, remat "dots" as the trainer runs) against
    the CPU's (the plain versions, remat off) from the same weights and
    batch; the card's launches are the train step's.  The limits come from
    a witness: the same CPU run again on one thread (another summation
    order of the same f32 program, no kernel involved) gives the spread
    that f32 rounding alone causes, and the card may be at most twice as
    far from the CPU as that, and never held looser than 1e-4 (loss) and
    1e-3 of each leaf's largest value (the dense train_oracle's limits).
    The hybrid needs it: two CPU orders part by about 4e-3 of a leaf at
    2 segments.  Without ``witness`` (moe) the limits
    are those two; the routers' leaves are reported apart.  Then a restart
    at that depth or at ``restart_layers`` (bf16, the family's moments;
    ``restart`` = (steps, the step that fails, the checkpoint interval))
    replays the clean run's final loss bit for bit.  Returns the leaf
    limit it held the card to.
    ``phase`` names the lines (default ``train_<family>``); an
    encoder-decoder is cut to ``n_layers`` encoder and decoder layers and
    takes the pipeline's stub frames."""
    from repro_torch.models import build_model
    from repro_torch.train.data import TokenPipeline
    phase = phase or f"train_{cfg.family}"
    cfg2 = dataclasses.replace(at_depth(cfg, n_layers), dtype="float32")
    gpu = build_model(cfg2, DEV).init(0)
    params = _to(gpu, "cpu")
    batch = TokenPipeline(cfg2.vocab, seq_len, 2, seed=5,
                          family=cfg2.family,
                          d_model=cfg2.d_model).batch_at(0)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = _loss_and_grads(torch, cfg2, params, batch, False)
    cpu_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    spread = loss_spread = 0.0
    if witness:
        torch.set_num_threads(1)
        try:
            alt_loss, alt_grads = _loss_and_grads(torch, cfg2, params, batch,
                                                  False)
        finally:
            torch.set_num_threads(threads)
        spread = max(_leaf_gaps(alt_grads, cpu_grads))
        loss_spread = abs(alt_loss - cpu_loss) / abs(cpu_loss)
        del alt_grads
    zero_counts()
    loss, grads = _loss_and_grads(torch, cfg2, gpu, batch, True)
    torch.cuda.synchronize()
    launches = read_counts()
    want = stateful_train_launches(cfg2)
    assert {k: launches[k] for k in want} == want, (launches, want)
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    leaf_rel = _leaf_gaps(grads, cpu_grads)
    loss_tol, leaf_tol = max(1e-4, 2 * loss_spread), max(1e-3, 2 * spread)
    worst = max(range(len(leaf_rel)), key=leaf_rel.__getitem__)
    names = leaf_names(params)
    routers = {n: r for n, r in zip(names, leaf_rel) if "router" in n}
    emit({"phase": f"{phase}_oracle", "arch": cfg.name,
          "layers": n_layers, "dtype": "float32", "batch": 2,
          "seq_len": seq_len, "loss": loss, "cpu_loss": cpu_loss,
          "loss_rel_err": loss_rel, "grad_leaves": len(grads),
          "grad_leaf_rel_err_max": max(leaf_rel), "worst_leaf": worst,
          "worst_leaf_name": names[worst], "witness": witness,
          "cpu_threads": threads, "cpu_one_thread_loss_rel": loss_spread,
          "cpu_one_thread_leaf_rel_max": spread, "loss_tol": loss_tol,
          "leaf_tol": leaf_tol, "launches": launches, "cpu_s": cpu_s,
          **({"router_leaf_rel_err": routers} if routers else {})})
    assert loss_rel <= loss_tol, (loss_rel, loss_tol)
    assert max(leaf_rel) <= leaf_tol, (max(leaf_rel), leaf_tol)
    del gpu, params, grads, cpu_grads
    torch.cuda.empty_cache()
    train_restart_phase(torch, cfg, restart_layers or n_layers, opt_state,
                        phase=f"{phase}_restart",
                        steps=restart[0], fail_at=restart[1],
                        seq_len=seq_len, every=restart[2])
    return leaf_tol


# ---------------------------------------------------------------------------
# Phase 12: the moe family
# ---------------------------------------------------------------------------

MOE_ARCH, LLAMA4_ARCH = "olmoe-1b-7b", "llama4-maverick-400b-a17b"
# the two tenants of moe_lora, rank 16 on the attention projections
MOE_TENANTS = TENANTS[:2]
# olmoe's depth for the run whose loss must fall with f32 moments (its
# full-width f32 moments reckon 83.0 GB with weights and gradients)
MOE_F32_LAYERS = 8


def no_drop(cfg):
    """``cfg`` at the capacity factor where no token drops: capacity >=
    tokens a call (factor = n_experts), as tests/test_models_smoke.py
    raises it."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def moe_serve_phase(torch, cfg, params):
    """moe_serve: the serve workload through full-width olmoe-1b-7b at its
    native capacity factor (2.0): every request finishes with the KV
    invariants clean after every step, and every model call launches K1
    once a layer and K2 ``k2_per_model_call`` times (16 and 49), no LoRA
    and no backward kernel; the host time of each dispatch."""
    eng = serve_engine(cfg, params)
    tally, counted = dispatch_timer()
    launches, m, out = run_workload(torch, eng, workload(cfg.vocab), counted)
    calls = sum(n for n, _ in tally.values())
    assert launches["paged_attention"] == cfg.n_layers * calls, \
        (launches, calls)
    assert launches["rmsnorm"] == k2_per_model_call(cfg) * calls, \
        (launches, calls)
    assert all(v == 0 for k, v in launches.items()
               if k not in ("paged_attention", "rmsnorm")), launches
    emit({"phase": "moe_serve", "arch": cfg.name, "dtype": cfg.dtype,
          "capacity_factor": cfg.moe.capacity_factor, **out,
          "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "model_calls": calls,
          "k1_launches_per_model_call": launches["paged_attention"] / calls,
          "k2_launches_per_model_call": launches["rmsnorm"] / calls,
          "param_bytes": eng.param_bytes_per_device,
          "kv_pool_bytes": sum(t.numel() * t.element_size()
                               for t in eng.cache.values())})
    del eng
    torch.cuda.empty_cache()
    return launches


def moe_lora_phase(torch, cfg, params):
    """moe_lora: olmoe with two rank-16 tenants (attention projections
    only) serves 8 requests of the serve workload, every third base: the
    fused delta launches 4 x 16 = 64 times a dispatch with an adapter row,
    never otherwise, and K5 and K6 never alone.  Then greedy tokens: a
    rank-0 tenant gives the base tokens bit for bit."""
    from repro_torch.serve.engine import Request
    eng = serve_engine(cfg, params)
    for name in MOE_TENANTS:
        eng.load_adapter(name, rank=16, alpha=32.0)
    assert sorted(eng.adapters.projs) == ["k", "o", "q", "v"], \
        eng.adapters.projs
    tally, counted = dispatch_timer()
    launches, m, out = run_workload(
        torch, eng, workload(cfg.vocab, n=8, tenants=(None,) + MOE_TENANTS),
        counted)
    dispatches = {k: sum(n for key, (n, _) in tally.items()
                         if key.endswith(k)) for k in ("lora", "base")}
    per = 4 * cfg.n_layers
    assert dispatches["lora"] > 0, dispatches
    assert launches["lora_delta"] == per * dispatches["lora"], \
        (launches, dispatches)
    assert launches["lora_shrink"] == launches["lora_expand"] == 0, launches
    emit({"phase": "moe_lora", "arch": cfg.name, "dtype": cfg.dtype, **out,
          "tenants": list(MOE_TENANTS), "rank": 16,
          "adapted_projections": sorted(eng.adapters.projs),
          "adapter_device_bytes": m.adapter_device_bytes,
          "dispatches": dispatches, "lora_launches_per_lora_dispatch": per,
          "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "per_tenant": m.per_tenant})
    del eng
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in (150, 300, 520)]

    def serve(adapter_id):
        eng = serve_engine(cfg, params)
        eng.load_adapter("null-tenant", rank=0)
        reqs = [Request(rid=i, prompt=list(p), max_new=12,
                        adapter_id=adapter_id) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done and not r.rejected for r in reqs)
        return [r.out for r in reqs]
    base, rank0 = serve(None), serve("null-tenant")
    emit({"phase": "moe_lora_identity", "requests": len(prompts),
          "tokens_each": 12, "rank0_identical": rank0 == base})
    assert rank0 == base, "a rank-0 tenant changed olmoe's base tokens"
    torch.cuda.empty_cache()
    return launches


class RouteLog:
    """Records the experts every token ``moe._select`` picks, in call order
    (one call a MoE layer within one model call), while active.  Given
    ``force`` (a list of (n, k) index tensors, one a call in order) it
    replaces the first n tokens' picks of each call with the forced ones;
    the rest of ``moe._route`` (the router, its softmax, the gates gathered
    from it and renormalised) is the program's own, so the path runs the
    other path's expert choices on its own numbers.  A call's tokens are
    its rows in order, batch-major (a decode step's B rows, a chunk's S
    tokens)."""

    def __init__(self, force=None):
        self.calls = []
        self.force = None if force is None else list(force)

    def __enter__(self):
        from repro_torch.models import moe
        self._real = moe._select

        def spy(probs, k):
            idx = self._real(probs, k)
            if self.force is not None:
                forced = self.force.pop(0)
                idx = idx.clone()
                idx.view(-1, idx.shape[-1])[:forced.shape[0]] = \
                    forced.to(idx.device)
            self.calls.append(idx.reshape(-1, idx.shape[-1]))
            return idx
        moe._select = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._select = self._real

    def take(self, cfg, tokens=None):
        """The recorded calls as one (tokens, k) index tensor an MoE layer
        (chunks of one prompt joined in order, cut to ``tokens``), and
        clear."""
        import torch
        n = cfg.n_layers // cfg.moe.every
        per = [torch.cat(self.calls[i::n]) for i in range(n)]
        self.calls = []
        return [o[:tokens] for o in per] if tokens else per


def differing_sets(a, b) -> int:
    """(layer, token) pairs whose expert sets differ between two paths."""
    return sum(int((x.cpu().sort(-1).values != y.cpu().sort(-1).values)
                   .any(-1).sum()) for x, y in zip(a, b))


def _dense_run(torch, fns, params, cfg, prompt, steps, log, feed=None):
    """The dense path: a whole-prompt prefill, then ``steps`` decode steps
    fed its own argmax (or the tokens ``feed``): per step the logits and
    each MoE layer's expert indices, and the tokens fed."""
    plen = len(prompt)
    cache1, lg = fns.prefill(params, {"tokens": torch.tensor([prompt],
                                                             device=DEV)})
    dense = fns.make_cache(1, plen + steps)
    for k in dense:
        dense[k][:, :, :plen] = cache1[k]
    del cache1
    logits, routes, tokens = [lg[0]], [log.take(cfg)], []
    for i in range(steps):
        tokens.append(int(logits[-1].float().argmax()) if feed is None
                      else feed[i])
        dense, lg = fns.decode_step(params, dense, {
            "token": torch.tensor([[tokens[-1]]], device=DEV),
            "cur_len": plen + i})
        logits.append(lg[0])
        routes.append(log.take(cfg))
    return logits, routes, tokens


def _paged_run(torch, fns, params, cfg, prompt, tokens, log, bs=16,
               chunk=256):
    """The paged path on the same prompt (chunks of ``chunk``) and decode
    tokens: per step the logits and each MoE layer's expert indices."""
    plen = len(prompt)
    nb = -(-(plen + len(tokens)) // bs)
    paged = fns.make_paged_cache(nb + 1, bs)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=DEV)[None, :]
    for start in range(0, plen, chunk):
        end = min(plen, start + chunk)
        ids = prompt[start:end] + [0] * (chunk - (end - start))
        paged, lg = fns.prefill_chunk(
            params, paged, {"tokens": torch.tensor([ids], device=DEV),
                            "block_table": table, "start": start,
                            "prompt_len": end}, m_used=-(-end // bs))
    # a chunk routes its padding too: keep the prompt's tokens
    logits, routes = [lg[0, plen - 1 - start]], [log.take(cfg, plen)]
    for i, tok in enumerate(tokens):
        paged, lg = fns.decode_paged(params, paged, {
            "token": torch.tensor([[tok]], device=DEV), "block_tables": table,
            "seq_lens": torch.tensor([plen + i], dtype=torch.int32,
                                     device=DEV)})
        logits.append(lg[0])
        routes.append(log.take(cfg))
    return logits, routes


def _forced_plan(routes, plen, chunk=256):
    """The dense path's indices in the paged path's call order: each
    prompt chunk's tokens per MoE layer, then each decode step's."""
    plan = [layer[start:min(plen, start + chunk)]
            for start in range(0, plen, chunk) for layer in routes[0]]
    return plan + [layer for step in routes[1:] for layer in step]


# the bf16 MoE oracle's routing gates: the paged path's differing (layer,
# token) expert sets, summed over all steps, at most this multiple of the
# dense path's own between bf16 and f32 (the witness of what rounding alone
# moves: two bf16 paths' independent roundings differ by about sqrt(2)
# times one path's); and at least this many steps whose sets all agree, so
# the free-run check is never empty
ROUTE_FLIP_MULTIPLE = 2
MIN_AGREEING_STEPS = 4


def moe_oracle_phase(torch, cfg, params=None, prompts=(200, 700),
                     steps=16, phase="moe_oracle", witness=True):
    """Logits of the paged path (prompt chunks of 256 through K1, then
    decode steps) against the dense path (whole-prompt prefill, plain
    attention) on the same tokens, at the no-drop factor where the two
    route alike, with each step's (layer, token) expert sets compared.
    f32: every step within 1e-3 and no set differing.  bf16 (where the
    paths' roundings move some tokens across a routing boundary): the
    paged path run again with the dense path's expert choices
    (``RouteLog(force=)``: only the pick is replaced, the gates are the
    program's) within ``BF16_ORACLE_TOL`` on every step; the free-running
    paged path within it on every step whose sets all agree, of which
    there are at least ``MIN_AGREEING_STEPS``; and, with ``witness``, its
    differing sets at most ``ROUTE_FLIP_MULTIPLE`` times those of the dense
    path run in f32 on the same weights (cast up) and tokens."""
    from repro_torch.models import build_model
    cfg = no_drop(cfg)
    fns = build_model(cfg, DEV)
    if params is None:
        params = fns.init(0)
    rng = np.random.default_rng(7)
    bf16 = cfg.dtype != "float32"
    witness = witness and bf16
    if witness:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        fns32, params32 = build_model(cfg32, DEV), _to(params, torch.float32)
    out = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.n_layers,
           "capacity_factor": cfg.moe.capacity_factor, "prompts": []}
    gaps_all, diffs_all, forced_all, witness_all = [], [], [], []
    for plen in prompts:
        prompt = rng.integers(1, cfg.vocab, size=plen).tolist()
        with RouteLog() as log:
            want, routes, tokens = _dense_run(torch, fns, params, cfg,
                                              prompt, steps, log)
            got, paged_routes = _paged_run(torch, fns, params, cfg, prompt,
                                           tokens, log)
            if witness:
                _, routes32, _ = _dense_run(torch, fns32, params32, cfg32,
                                            prompt, steps, log, feed=tokens)
        gaps = [rel_err(g, w)[1] for g, w in zip(got, want)]
        diffs = [differing_sets(a, b) for a, b in zip(paged_routes, routes)]
        entry = {"prompt_len": plen, "max_rel_gap": max(gaps), "gaps": gaps,
                 "differing_expert_sets": diffs,
                 "sets_compared": [sum(x.shape[0] for x in r)
                                   for r in routes]}
        if witness:
            entry["dense_bf16_vs_f32_differing_sets"] = [
                differing_sets(a, b) for a, b in zip(routes32, routes)]
            witness_all += entry["dense_bf16_vs_f32_differing_sets"]
        if bf16:
            with RouteLog(force=_forced_plan(routes, plen)) as log:
                forced, _ = _paged_run(torch, fns, params, cfg, prompt,
                                       tokens, log)
                assert not log.force, "forced routes left over"
            fgaps = [rel_err(g, w)[1] for g, w in zip(forced, want)]
            entry["forced_routing_gaps"] = fgaps
            forced_all += fgaps
        out["prompts"].append(entry)
        gaps_all += gaps
        diffs_all += diffs
    tol = BF16_ORACLE_TOL if bf16 else 1e-3
    agreeing = [g for g, d in zip(gaps_all, diffs_all) if d == 0]
    out.update(max_rel_gap=max(gaps_all), tol=tol, steps=len(gaps_all),
               steps_with_differing_sets=sum(d > 0 for d in diffs_all),
               steps_where_sets_agree=len(agreeing),
               differing_sets=sum(diffs_all),
               max_rel_gap_where_sets_agree=max(agreeing, default=None),
               forced_routing_max_rel_gap=max(forced_all, default=None),
               gate="forced routing on every step; free run where sets "
                    f"agree (at least {MIN_AGREEING_STEPS} steps)"
                    + (f"; differing sets at most {ROUTE_FLIP_MULTIPLE}x "
                       "the dense path's bf16 against f32" if witness
                       else "")
               if bf16 else "every step, no set differing")
    if witness:
        out.update(witness_differing_sets=sum(witness_all),
                   route_flip_limit=ROUTE_FLIP_MULTIPLE * sum(witness_all))
        del params32
    emit(out)
    if bf16:
        assert max(forced_all) <= tol, out
        assert len(agreeing) >= MIN_AGREEING_STEPS, out
        assert max(agreeing) <= tol, out
        if witness:
            assert sum(diffs_all) <= ROUTE_FLIP_MULTIPLE * sum(witness_all), \
                out
    else:
        assert max(gaps_all) <= tol and not any(diffs_all), out
    del params
    torch.cuda.empty_cache()
    return out


def moe_cpu_oracle_phase(torch, cfg, steps=8, chunk=256, bs=16):
    """One request teacher-forced through olmoe's paged path at its native
    factor (a 256-token prompt chunk, so the capacity drops tokens, and
    ``steps`` decode steps), full width, 2 layers, f32: K1 and K2 on the
    card against the plain versions on the CPU, on the same weights; then
    the same tokens through the dense path on both.  Gate 1e-3."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = build_model(cfg, DEV).init(0)
    nb = -(-(chunk + steps) // bs)
    sides = {}
    for dev in (DEV, "cpu"):
        fns = build_model(cfg, dev)
        p = params if dev == DEV else _to(params, "cpu")
        sides[dev] = (fns, p, fns.make_paged_cache(nb + 1, bs))
    prompt = np.random.default_rng(11).integers(1, cfg.vocab,
                                                size=chunk).tolist()
    gaps, logits, forced_tokens, sets, diffs = [], {}, [], {}, []
    zero_counts()
    with RouteLog() as log:
        for i in range(steps + 1):
            for dev, (fns, p, cache) in sides.items():
                table = torch.arange(1, nb + 1, dtype=torch.int32,
                                     device=dev)[None, :]
                if i == 0:
                    batch = {"tokens": torch.tensor([prompt], device=dev),
                             "block_table": table, "start": 0,
                             "prompt_len": chunk}
                    _, lg = fns.prefill_chunk(p, cache, batch, m_used=nb)
                    logits[dev] = lg[0, chunk - 1]
                else:
                    batch = {"token": torch.tensor([[forced]], device=dev),
                             "block_tables": table,
                             "seq_lens": torch.tensor([chunk + i - 1],
                                                      dtype=torch.int32,
                                                      device=dev)}
                    _, lg = fns.decode_paged(p, cache, batch)
                    logits[dev] = lg[0]
                sets[dev] = log.take(cfg)
            want = logits["cpu"]
            gaps.append(rel_err(logits[DEV].cpu(), want)[1])
            forced = int(want.argmax())
            forced_tokens.append(forced)
            diffs.append(differing_sets(sets[DEV], sets["cpu"]))
    torch.cuda.synchronize()
    n = read_counts()
    assert n["paged_attention"] == cfg.n_layers * (steps + 1), n
    assert n["rmsnorm"] == k2_per_model_call(cfg) * (steps + 1), n
    dense_gaps = _dense_oracle_gaps(torch, cfg, sides, prompt,
                                    forced_tokens[:-1])
    tol = 1e-3
    emit({"phase": "moe_cpu_oracle", "arch": cfg.name, "layers": 2,
          "dtype": cfg.dtype, "capacity_factor": cfg.moe.capacity_factor,
          "prompt_len": chunk, "decode_steps": steps,
          "max_rel_gap": max(gaps), "gaps": gaps, "tol": tol,
          "differing_expert_sets": diffs, "launches": n,
          "dense_path_max_rel_gap": max(dense_gaps),
          "dense_path_gaps": dense_gaps})
    assert max(gaps) <= tol, f"moe cpu oracle: rel gap {max(gaps)} > {tol}"
    assert max(dense_gaps) <= tol, \
        f"moe cpu dense oracle: rel gap {max(dense_gaps)} > {tol}"
    del sides, params
    torch.cuda.empty_cache()


def llama4_layer_phase(torch, cfg):
    """llama4_layer: one super-layer of llama4-maverick-400b-a17b at full
    width (a dense layer, d_ff_dense 16,384, then an MoE layer of 128
    experts, top-1, with a shared expert; d 5120, 40/8 heads, vocab
    202,048), bf16, drawn on the card: 4 requests of the serve workload, 8
    new tokens each, the KV invariants after every step, K1 twice and K2
    five times a model call.  Then the paged path's bf16 gap against the
    dense oracle at the no-drop factor (``moe_oracle_phase``'s gates but
    the f32 witness, for which the card lacks the room: 74.7 GB of f32
    weights)."""
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves
    cfg = dataclasses.replace(cfg, n_layers=2)
    t0 = time.perf_counter()
    params = build_model(cfg, DEV).init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(params))
    expert_bytes = sum(params["layers"][1]["moe"][k].numel() * 2
                       for k in ("wi_gate", "wi_up", "wo"))
    eng = serve_engine(cfg, params)
    reqs = workload(cfg.vocab, n=4)
    for r in reqs:
        r.max_new = 8
    tally, counted = dispatch_timer()
    launches, m, out = run_workload(torch, eng, reqs, counted)
    calls = sum(n for n, _ in tally.values())
    assert launches["paged_attention"] == cfg.n_layers * calls, \
        (launches, calls)
    assert launches["rmsnorm"] == k2_per_model_call(cfg) * calls, \
        (launches, calls)
    del eng
    torch.cuda.empty_cache()
    gap = moe_oracle_phase(torch, cfg, params, prompts=(300,), steps=8,
                           phase="llama4_oracle", witness=False)
    emit({"phase": "llama4_layer", "arch": cfg.name, "layers": 2,
          "dtype": cfg.dtype, "init_s": init_s, "param_bytes": param_bytes,
          "param_count": cfg.param_count(), "expert_bytes": expert_bytes,
          **out, "host_ms_per_dispatch": host_ms_per_dispatch(tally),
          "model_calls": calls,
          "k1_launches_per_model_call": launches["paged_attention"] / calls,
          "k2_launches_per_model_call": launches["rmsnorm"] / calls,
          "paged_vs_dense_bf16_max_rel_gap": gap["max_rel_gap"],
          "steps_with_differing_sets": gap["steps_with_differing_sets"]})
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the encoder-decoder and the VLM stub frontend
# ---------------------------------------------------------------------------

WHISPER_ARCH, VLM_ARCH = "whisper-small", "qwen2-vl-72b"
# whisper_serve: 8 requests of 1,500 stub frames (30 s of audio at
# whisper's 50 frames a second), a 4-token prompt, 64 greedy new tokens
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW = 8, 1500, 4, 64
# train_whisper: B 8 x 448 frames and tokens (whisper's decoder context)
WHISPER_TRAIN_SEQ = 448
# vlm_serve: 16 of qwen2-vl-72b's 80 layers at full width (33.1 GB of bf16
# weights; 80 would need 145 GB), two batches of 8 requests, each an image
# of 16 x 16 patch embeddings then 256 or 768 text positions, 32 greedy
# new tokens fed back as their embedding rows
VLM_LAYERS, VLM_BATCH, VLM_GRID, VLM_TEXT, VLM_NEW = 16, 8, 16, (256, 768), 32
# train_vlm: 2 layers at full width, f32 moments when its reckoned state
# (weights, gradients and moments) fits under this many bytes, else int8;
# a peak rate of 3e-5: at d 8192 an Adam step of 3e-4 on every weight (the
# rate the narrower archs train at) sent the loss from 11.41 to 34.12 at
# the second update on an NVIDIA H100 80GB HBM3 (PERF.md, Findings)
VLM_TRAIN_LAYERS, VLM_STATE_LIMIT, VLM_TRAIN_LR = 2, 70e9, 3e-5
# the decode gates: every GATE_EVERY-th step against a fresh prefill
GATE_EVERY = 8


def encdec_launches(cfg) -> dict:
    """K3 and K2 launches of one encoder-decoder prefill call, decode step
    and remat train step: K3 on each encoder layer's attention and each
    decoder layer's self- and cross-attention (a decode step attends in
    plain PyTorch); K2 on two norms an encoder layer, three a decoder
    layer, and the encoder's and the decoder's final norms; the remat step
    runs each layer's forward twice and each norm's backward once (whisper
    at 12 + 12 layers: 36 / 62 a prefill, 0 / 37 a decode step, 72 / 36 K3
    and 122 / 62 K2 a train step)."""
    ne, nd = cfg.encdec.n_enc_layers, cfg.n_layers
    attn, norms = ne + 2 * nd, 2 * ne + 3 * nd
    return {"prefill": {"flash_attention": attn, "rmsnorm": norms + 2},
            "decode": {"flash_attention": 0, "rmsnorm": 3 * nd + 1},
            "train": {"flash_attention": 2 * attn,
                      "flash_attention_bwd": attn,
                      "rmsnorm": 2 * norms + 2, "rmsnorm_bwd": norms + 2}}


def place_cache(small: dict, big: dict) -> dict:
    """A prefill cache written into the front of an empty larger one, each
    tensor along the axis where the two differ (the reference tests'
    ``_embed_cache``); tensors of equal shape (``enc_len``) are taken from
    the prefill."""
    for k, s in small.items():
        b = big[k]
        if s.shape == b.shape:
            big[k] = s
            continue
        ax = next(i for i in range(s.dim()) if s.shape[i] != b.shape[i])
        b.narrow(ax, 0, s.shape[ax]).copy_(s)
    return big


def _only(launches, want) -> None:
    """``launches`` are ``want``'s, and every other counter is 0."""
    got = {k: launches[k] for k in want}
    assert got == want, (got, want)
    assert all(v == 0 for k, v in launches.items() if k not in want), \
        launches


def greedy_decode(torch, prefill, decode, params, first, cache, steps,
                  step_batch, gate_batch):
    """``steps`` greedy decode steps from a prefill's logits ``first``:
    ``step_batch(i, tok)`` makes step i's batch from the token fed,
    ``gate_batch(toks)`` a fresh prefill's batch of everything fed so far.
    Each step's launches are counted (the gates' are not); every
    ``GATE_EVERY``-th step's logits are held, after the loop, to a fresh
    prefill's last position.  Returns (tokens (B, steps), decode seconds,
    the decode loop's launches, each gate's relative gap, greedy agreement
    at the gates)."""
    tok = first.float().argmax(-1, keepdim=True)
    toks, held, secs = [], [], 0.0
    zero_counts()
    for i in range(steps):
        toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = decode(params, cache, step_batch(i, tok))
        tok = logits.float().argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        if (i + 1) % GATE_EVERY == 0:
            held.append((i + 1, logits))
    launches = read_counts()
    gaps, agree = [], []
    for n, logits in held:
        _, want = prefill(params, gate_batch(torch.cat(toks[:n], dim=1)))
        gaps.append(rel_err(logits, want)[1])
        agree.append(float((logits.float().argmax(-1)
                            == want.float().argmax(-1)).float().mean()))
    return torch.cat(toks, dim=1), secs, launches, gaps, agree


def whisper_serve_phase(torch, cfg):
    """whisper_serve: full whisper-small (12 + 12 layers, d 768, vocab
    51,865) in bf16 through ``make_prefill_step`` / ``make_decode_step``
    (the reference serves its encoder-decoder so; its paged engine refuses
    it): 8 requests of 1,500 seeded f32 stub frames (cast to bf16 at the
    encoder's entry), a 4-token prompt and 64 greedy new tokens; the
    prefill cache placed into a ``make_encdec_cache(8, 1500)`` cache.
    Every count zeroed just before and read just after each part: K3 and
    K2 exactly ``encdec_launches`` a prefill call and a decode step; every
    8th decode step's logits within 5e-2 of max|ref| of a fresh prefill of
    the same tokens.  Decode tokens/s, encode + prefill ms, peak memory."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves
    fns = build_model(cfg, DEV)
    t0 = time.perf_counter()
    params = fns.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = make_prefill_step(cfg, DEV)
    decode = make_decode_step(cfg, DEV)
    b = WHISPER_BATCH
    gen = torch.Generator(device=DEV).manual_seed(11)
    frames = 0.1 * torch.randn((b, WHISPER_FRAMES, cfg.d_model),
                               generator=gen, device=DEV)
    prompt = torch.randint(1, cfg.vocab, (b, WHISPER_PROMPT), generator=gen,
                           device=DEV)
    want = encdec_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    small, first = prefill(params, {"frames": frames, "tokens": prompt})
    cache = place_cache(small, fns.make_cache(b, WHISPER_FRAMES))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    _only(pre, {k: want["prefill"][k] for k in ("flash_attention",
                                                "rmsnorm")})
    del small
    toks, secs, dec, gaps, agree = greedy_decode(
        torch, prefill, decode, params, first, cache, WHISPER_NEW,
        lambda i, tok: {"token": tok, "cur_len": WHISPER_PROMPT + i},
        lambda fed: {"frames": frames,
                     "tokens": torch.cat([prompt, fed], dim=1)})
    peak = torch.cuda.max_memory_allocated()
    _only(dec, {"rmsnorm": want["decode"]["rmsnorm"] * WHISPER_NEW})
    emit({"phase": "whisper_serve", "arch": cfg.name, "dtype": cfg.dtype,
          "enc_layers": cfg.encdec.n_enc_layers, "dec_layers": cfg.n_layers,
          "requests": b, "frames": WHISPER_FRAMES,
          "prompt_tokens": WHISPER_PROMPT, "new_tokens": WHISPER_NEW,
          "init_s": init_s, "param_bytes": sum(
              t.numel() * t.element_size() for t in leaves(params)),
          "encode_prefill_ms": prefill_s * 1e3,
          "decode_s": secs, "decode_tokens_per_s": b * WHISPER_NEW / secs,
          "peak_device_bytes": peak,
          "k3_launches_per_prefill": pre["flash_attention"],
          "k2_launches_per_prefill": pre["rmsnorm"],
          "k2_launches_per_decode_step": dec["rmsnorm"] / WHISPER_NEW,
          "gate_steps": list(range(GATE_EVERY, WHISPER_NEW + 1, GATE_EVERY)),
          "decode_vs_prefill_rel_gap": gaps, "greedy_agreement": agree,
          "tol": BF16_ORACLE_TOL, "first_tokens": toks[0, :8].tolist()})
    assert max(gaps) <= BF16_ORACLE_TOL, gaps
    del params, cache, frames
    torch.cuda.empty_cache()
    return {k: pre[k] + dec[k] for k in pre}


def whisper_oracle_phase(torch, cfg, n_layers=2, steps=8):
    """whisper_oracle: 2 + 2 layers at full width, f32, the same weights
    on the card and on the CPU: 2 requests of 1,500 stub frames and a
    4-token prompt prefilled (K3 and K2 on the card, their plain versions
    on the CPU) into a padded cache, then 8 decode steps fed the card's
    greedy tokens: every step's logits within 1e-3 of max|ref|."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    cfg2 = dataclasses.replace(at_depth(cfg, n_layers), dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(12)
    frames = 0.1 * torch.randn((2, WHISPER_FRAMES, cfg.d_model),
                               generator=gen)
    prompt = torch.randint(1, cfg.vocab, (2, WHISPER_PROMPT), generator=gen)
    gpu = build_model(cfg2, DEV).init(0)
    sides = {DEV: gpu, "cpu": _to(gpu, "cpu")}
    logits = {}
    fed = []
    for dev, params in sides.items():
        fns = build_model(cfg2, dev)
        prefill = make_prefill_step(cfg2, dev)
        decode = make_decode_step(cfg2, dev)
        small, out = prefill(params, {"frames": frames.to(dev),
                                      "tokens": prompt.to(dev)})
        cache = place_cache(small, fns.make_cache(2, WHISPER_FRAMES))
        logits[dev] = [out.cpu()]
        for i in range(steps):
            if dev == DEV:
                fed.append(out.float().argmax(-1, keepdim=True).cpu())
            cache, out = decode(params, cache, {
                "token": fed[i].to(dev), "cur_len": WHISPER_PROMPT + i})
            logits[dev].append(out.cpu())
    gaps = [rel_err(g, c)[1] for g, c in zip(logits[DEV], logits["cpu"])]
    emit({"phase": "whisper_oracle", "arch": cfg.name, "layers": n_layers,
          "dtype": "float32", "requests": 2, "frames": WHISPER_FRAMES,
          "decode_steps": steps, "max_rel_gap": max(gaps),
          "rel_gaps": gaps, "tol": 1e-3})
    assert max(gaps) <= 1e-3, gaps
    del gpu, sides
    torch.cuda.empty_cache()


def vlm_positions(torch, b: int, grid: int, text: int, start: int = 0):
    """(3, b, grid² + text) int32 M-RoPE streams of an image then text, as
    qwen2-vl places them: the patches at t = start, h = start + row,
    w = start + column; the text from start + grid on, the three streams
    equal."""
    n = torch.arange(grid * grid, device=DEV)
    img = torch.stack([torch.zeros_like(n), n // grid, n % grid])
    txt = (grid + torch.arange(text, device=DEV)).expand(3, text)
    pos = (torch.cat([img, txt], dim=1) + start).to(torch.int32)
    return pos[:, None].expand(3, b, pos.shape[1]).contiguous()


def vlm_serve_phase(torch, cfg):
    """vlm_serve: qwen2-vl-72b at full width (d 8192, 64/8 heads, d_ff
    29,568, vocab 152,064) and 16 of its 80 layers, bf16, through
    ``make_prefill_step`` / ``make_decode_step`` (the dense oracle's plain
    attention: the reference's engine refuses the VLM frontend, and so does
    the port's): two batches of 8 requests, each 256 seeded f32 patch
    embeddings on a 16 x 16 grid with distinct (t, h, w) streams, then 256
    (first batch) or 768 (second) text positions (the text's embedding
    rows), then 32 greedy new tokens fed back as their embedding rows at
    M-RoPE positions that run behind the cache index.  Gates: K2 33
    launches a model call (two a layer and the final norm; no other
    kernel), every 8th decode step within 5e-2 of max|ref| of a fresh
    prefill.  Decode tokens/s, prefill ms, peak memory."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves
    cfg = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    fns = build_model(cfg, DEV)
    t0 = time.perf_counter()
    params = fns.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emb = params["embed"]["embed"]
    prefill = make_prefill_step(cfg, DEV)
    decode = make_decode_step(cfg, DEV)
    b, patches = VLM_BATCH, VLM_GRID * VLM_GRID
    gen = torch.Generator(device=DEV).manual_seed(13)
    per_call = k2_per_model_call(cfg)
    torch.cuda.reset_peak_memory_stats()
    batches, total = [], {}
    for text in VLM_TEXT:
        s = patches + text
        image = 0.02 * torch.randn((b, patches, cfg.d_model), generator=gen,
                                   device=DEV)
        words = torch.randint(1, cfg.vocab, (b, text), generator=gen,
                              device=DEV)
        embeds = torch.cat([image, emb[words].float()], dim=1)
        pos = vlm_positions(torch, b, VLM_GRID, text + VLM_NEW)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        small, first = prefill(params, {"embeds": embeds,
                                        "positions": pos[:, :, :s]})
        cache = place_cache(small, fns.make_cache(b, s + VLM_NEW))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = read_counts()
        _only(pre, {"rmsnorm": per_call})
        del small
        toks, secs, dec, gaps, agree = greedy_decode(
            torch, prefill, decode, params, first, cache, VLM_NEW,
            lambda i, tok, s=s: {"embeds": emb[tok], "cur_len": s + i,
                                 "positions": pos[:, :, s + i:s + i + 1]},
            lambda fed, s=s, e=embeds: {
                "embeds": torch.cat([e, emb[fed].float()], dim=1),
                "positions": pos[:, :, :s + fed.shape[1]]})
        _only(dec, {"rmsnorm": per_call * VLM_NEW})
        assert int(pos[0, 0, s]) == VLM_GRID + text < s
        for k in pre:
            total[k] = total.get(k, 0) + pre[k] + dec[k]
        batches.append({
            "text_positions": text, "prompt_len": s,
            "prefill_ms": prefill_s * 1e3, "decode_s": secs,
            "decode_tokens_per_s": b * VLM_NEW / secs,
            "decode_vs_prefill_rel_gap": gaps, "greedy_agreement": agree,
            "k2_launches_per_model_call": dec["rmsnorm"] / VLM_NEW})
        del cache, embeds, image
    peak = torch.cuda.max_memory_allocated()
    gaps = [g for x in batches for g in x["decode_vs_prefill_rel_gap"]]
    emit({"phase": "vlm_serve", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": VLM_LAYERS, "requests_per_batch": b,
          "patches": patches, "new_tokens": VLM_NEW, "init_s": init_s,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in leaves(params)),
          "param_count": cfg.param_count(), "peak_device_bytes": peak,
          "batches": batches, "max_rel_gap": max(gaps),
          "tol": BF16_ORACLE_TOL})
    assert max(gaps) <= BF16_ORACLE_TOL, gaps
    del params, emb
    torch.cuda.empty_cache()
    return total


def train_vlm_phase(torch, cfg):
    """train_vlm: qwen2-vl-72b at full width and 2 layers (4.25 B
    parameters) through ``train_stateful_phase``, B 8 x S 512, 5 steps at
    a peak rate of 3e-5, f32 moments where the reckoned state fits under
    70 GB (51.0 GB),
    else int8 with the loss gate at 1 layer in f32: the pipeline's VLM
    batches (f32 stub embeds, three equal streams), K3 4 / 2 and K2 9 / 5
    launches a step.  Then one remat loss and backward on the same
    weights at distinct streams (256 patches on a 16 x 16 grid, then 256
    text positions): the same launches, a finite loss, and a different
    one from the same batch at equal streams."""
    from repro_torch.launch.train import state_bytes
    from repro_torch.models import build_model
    from repro_torch.train.data import TokenPipeline
    cfg2 = dataclasses.replace(cfg, n_layers=VLM_TRAIN_LAYERS)
    reckoned = state_bytes(cfg2, "f32")
    opt_state = "f32" if reckoned < VLM_STATE_LIMIT else "int8"
    launches = train_stateful_phase(torch, cfg2, opt_state, f32_layers=1,
                                    phase="train_vlm", lr=VLM_TRAIN_LR)
    params = build_model(cfg2, DEV).init(0)
    batch = TokenPipeline(cfg2.vocab, 512, 8, seed=5, family="vlm",
                          d_model=cfg2.d_model).batch_at(0)
    distinct = vlm_positions(torch, 8, VLM_GRID, 512 - VLM_GRID ** 2).cpu()
    equal = torch.from_numpy(batch["positions"])
    zero_counts()
    loss, grads = _loss_and_grads(torch, cfg2, params, dict(
        batch, positions=distinct.numpy()), True)
    torch.cuda.synchronize()
    counts = read_counts()
    del grads
    _only(counts, stateful_train_launches(cfg2))
    with torch.no_grad():
        plain = float(build_model(cfg2, DEV).loss(params, {
            "embeds": torch.from_numpy(batch["embeds"]).to(DEV),
            "positions": equal.to(DEV),
            "labels": torch.from_numpy(batch["labels"]).to(DEV)},
            remat=False))
    emit({"phase": "train_vlm_distinct_streams", "arch": cfg.name,
          "layers": VLM_TRAIN_LAYERS, "opt_state": opt_state,
          "state_bytes_reckoned_f32": reckoned,
          "loss_distinct_streams": loss, "loss_equal_streams": plain,
          "launches": counts})
    assert np.isfinite(loss) and loss != plain, (loss, plain)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the port's examples (examples/*_torch.py) on the card
# ---------------------------------------------------------------------------

# train_lm at full width cut to 2 of qwen3-0.6b's 28 layers (as
# train_restart), 36 steps: a checkpoint at step 20, the failure at step 24
# (2/3 of the run), so the run restores step 20 and replays 4 steps
EXAMPLES_TRAIN_LAYERS, EXAMPLES_TRAIN_STEPS = 2, 36
# compile_inspect's dry-run cell
EXAMPLES_CELL = ("qwen3-0.6b", "decode_32k", "pod1")


def _example(fn):
    """(``fn()``, the lines it printed, its seconds): an example's prints
    kept off the script's output (each phase prints one JSON line)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue().splitlines(), time.perf_counter() - t0


def examples_phase(torch, cfg, smi):
    """examples: the four ``examples/*_torch.py`` through their own entry
    points on the card at full width (no ``--smoke``), each with its launch
    counts from zero.  quickstart: the packed Fig. 3 program within 1e-4 of
    its logical term, whose two matmuls launch K4, the recompile a cache
    hit, the loss of full-width qwen3-0.6b in bf16 finite (K3 once a layer,
    K2 ``k2_per_model_call``); serve_lm: full-width qwen3-0.6b in bf16,
    every request finished with its 12 tokens, the KV invariants clean, K1
    once a layer and K2 ``k2_per_model_call`` times a model call; train_lm:
    full width at ``EXAMPLES_TRAIN_LAYERS`` layers, the failure after a
    checkpoint, the restart restoring it, the last loss below the first,
    K3 and K2 what a step launches at that depth for every step run;
    compile_inspect on ``EXAMPLES_CELL`` (the dry run in this process, on
    meta)."""
    import math
    import tempfile
    sys.path.insert(0, str(ROOT / "examples"))
    import compile_inspect_torch
    import quickstart_torch
    import serve_lm_torch
    import train_lm_torch
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    out = {"phase": "examples", "nvidia_smi": smi, "arch": cfg.name,
           "dtype": cfg.dtype}
    k2 = k2_per_model_call(cfg)

    zero_counts()
    q, lines, sec = _example(lambda: quickstart_torch.main([]))
    torch.cuda.synchronize()
    launches = read_counts()
    pipe, loss = q["pipeline"], q["train_step"]
    assert pipe["rel_err"] <= 1e-4 and pipe["cache_hit"], pipe
    assert pipe["matmul_launches"] == launches["matmul"] == 2, \
        (pipe, launches)
    assert math.isfinite(loss["loss"]) and loss["dtype"] == "bfloat16" \
        and loss["n_layers"] == cfg.n_layers, loss
    assert launches["flash_attention"] == cfg.n_layers \
        and launches["rmsnorm"] == k2, launches
    out["quickstart"] = {"s": sec, "launches": launches,
                         "pipeline": pipe, "train_step": loss,
                         "distribute": {k: v for k, v in
                                        q["distribute"].items()
                                        if k != "pspecs"},
                         "schedule": q["schedule"], "stdout": lines[-6:]}

    params = build_model(cfg, DEV).init(0)
    tally, counted = dispatch_timer()
    zero_counts()
    sv, lines, sec = _example(lambda: serve_lm_torch.serve(
        cfg, params, on_engine=lambda eng: wrap_dispatches(eng, counted)))
    torch.cuda.synchronize()
    launches = read_counts()
    del params
    torch.cuda.empty_cache()
    calls = sum(n for n, _ in tally.values())
    assert sorted(sv["outputs"]) == list(range(serve_lm_torch.N_REQUESTS)) \
        and all(len(t) == serve_lm_torch.MAX_NEW
                for t in sv["outputs"].values()), sv["outputs"]
    assert sv["kv_violations"] == [], sv["kv_violations"]
    assert launches["paged_attention"] == cfg.n_layers * calls \
        and launches["rmsnorm"] == k2 * calls, (launches, calls)
    out["serve_lm"] = {"s": sec, "launches": launches, "model_calls": calls,
                       "host_ms_per_dispatch": host_ms_per_dispatch(tally),
                       "tokens_per_sec": sv["tokens_per_sec"],
                       "peak_blocks_used": sv["peak_blocks_used"],
                       "dense_equiv_blocks": sv["dense_equiv_blocks"],
                       "stdout": lines[:2]}

    layers = EXAMPLES_TRAIN_LAYERS
    with tempfile.TemporaryDirectory(prefix="train_lm_") as workdir:
        zero_counts()
        tr, lines, sec = _example(lambda: train_lm_torch.main(
            ["--layers", str(layers), "--steps", str(EXAMPLES_TRAIN_STEPS),
             "--workdir", workdir]))
        torch.cuda.synchronize()
        launches = read_counts()
    torch.cuda.empty_cache()
    assert tr["restored_step"] is not None \
        and 0 < tr["restored_step"] < tr["fail_at"], tr
    assert tr["final_step"] == EXAMPLES_TRAIN_STEPS, tr
    assert tr["last"] < tr["first"], tr
    run = EXAMPLES_TRAIN_STEPS + tr["fail_at"] - tr["restored_step"]
    k2_cut = k2_per_model_call(at_depth(cfg, layers))
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 2 * k2_cut - 1, "rmsnorm_bwd": k2_cut}
    assert {k: launches[k] for k in want} \
        == {k: v * run for k, v in want.items()}, (launches, run)
    out["train_lm"] = {"s": sec, "layers": layers, "launches": launches,
                       "steps_run": run,
                       **{k: tr[k] for k in ("first", "last", "fail_at",
                                             "restored_step")},
                       "stdout": lines[-3:]}

    with tempfile.TemporaryDirectory(prefix="dryrun_cell_") as cell_dir:
        arch, shape, mesh = EXAMPLES_CELL
        ci, lines, sec = _example(lambda: compile_inspect_torch.main(
            ["--arch", arch, "--shape", shape, "--mesh", mesh,
             "--out", cell_dir]))
    assert ci["pipeline"]["rel_err"] <= 1e-4, ci["pipeline"]
    cell = ci["dryrun"]
    assert cell["status"] == "ok" and cell["fits"], cell
    out["compile_inspect"] = {
        "s": sec, "cell": list(EXAMPLES_CELL),
        "pipeline": {k: v for k, v in ci["pipeline"].items()
                     if k != "summary"},
        "dryrun": {k: cell[k] for k in (
            "hlo_flops_per_device", "peak_bytes_per_device",
            "cache_bytes_per_device", "roofline", "analyze_s")}}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)


def leaf_names(tree, prefix="") -> list:
    """Each leaf's path, in ``train.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _to(tree, where):
    """``tree`` with every tensor moved to a device or cast to a dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, where) for v in tree]
    return tree.to(where)


# ---------------------------------------------------------------------------

# the kernel checks that ``--only`` can name
# production cells the dry run counts on the host: (arch, shape, mesh)
DRYRUN_GRID = (("qwen3-0.6b", "train_4k", "pod1"),
               ("llama4-maverick-400b-a17b", "train_4k", "pod2"),
               # the sequence-parallel caches: over "model" (8 kv heads,
               # 16 model ranks) and over "data" (B 1)
               ("qwen3-0.6b", "decode_32k", "pod1"),
               ("zamba2-2.7b", "long_500k", "pod2"))
DRYRUN_CELL_TIMEOUT_S = 300


def start_dryrun_grid():
    """Start each ``DRYRUN_GRID`` cell through ``python -m
    repro_torch.launch.dryrun`` in a subprocess of its own (meta tensors,
    one CPU thread each: the host's work only), all together, so they run
    beside the card's phases; a thread a cell waits for it, at most
    ``DRYRUN_CELL_TIMEOUT_S`` (then kills it), and notes when it ended.
    ``dryrun_grid_phase`` collects them; they are killed if the script
    exits first."""
    import atexit
    import tempfile
    import threading
    out_dir = tempfile.mkdtemp(prefix="dryrun_grid_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    grid = {"out_dir": out_dir, "cells": []}

    def watch(cell):
        p = cell["proc"]

        def expire():
            cell["timed_out"] = True
            p.kill()
        timer = threading.Timer(DRYRUN_CELL_TIMEOUT_S, expire)
        timer.start()
        cell["err"] = p.communicate()[1]
        timer.cancel()
        cell["end"] = time.perf_counter()

    for arch, shape, mesh in DRYRUN_GRID:
        cell = {"key": (arch, shape, mesh), "start": time.perf_counter(),
                "timed_out": False, "proc": subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", out_dir],
                    env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True)}
        cell["watch"] = threading.Thread(target=watch, args=(cell,),
                                         daemon=True)
        cell["watch"].start()
        grid["cells"].append(cell)
    atexit.register(_stop_dryrun_grid, grid)
    return grid


def _stop_dryrun_grid(grid) -> None:
    import shutil
    for cell in grid["cells"]:
        if cell["proc"].poll() is None:
            cell["proc"].kill()
        cell["watch"].join()
    shutil.rmtree(grid["out_dir"], ignore_errors=True)


def dryrun_grid_phase(grid, smi):
    """dryrun_grid: each cell started by ``start_dryrun_grid``, ended
    within ``DRYRUN_CELL_TIMEOUT_S`` of its start: its result line without
    the collectives, with the subprocess's seconds (host time, shared with
    the phases it ran beside); every cell ok."""
    try:
        for cell in grid["cells"]:
            arch, shape, mesh = cell["key"]
            cell["watch"].join()
            assert not cell["timed_out"], (arch, mesh, "timed out")
            assert cell["proc"].returncode == 0, \
                (arch, mesh, cell["err"][-3000:])
            res = json.loads(Path(grid["out_dir"],
                                  f"{arch}__{shape}__{mesh}.json").read_text())
            assert res["status"] == "ok", res
            emit({"phase": "dryrun_grid", "nvidia_smi": smi,
                  "host_s": cell["end"] - cell["start"],
                  **{k: v for k, v in res.items() if k != "collectives"}})
    finally:
        _stop_dryrun_grid(grid)


KERNEL_CHECKS = ("paged_attention", "rmsnorm", "matmul", "lora", "ssm_scan",
                 "flash_attention")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="run only the card, build and these kernel checks "
                         f"(comma-separated: {', '.join(KERNEL_CHECKS)}) and "
                         "print no result line: a quick check of kernels")
    args = ap.parse_args()
    assert args.only is None or set(args.only) <= set(KERNEL_CHECKS), \
        args.only
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import lora as lora_mod
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.kernels import ssm_scan as k7_mod
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    # 1. card
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    build.build("paged_attention", "rmsnorm", "matmul", "lora", "ssm_scan",
                "flash_attention")
    pa_mod.load_kernel()
    rn_mod.load_kernels()
    mm_mod.load_kernel()
    lora_mod.load_kernels()
    k7_mod.load_kernels()
    fa_mod.load_kernels()
    emit({"phase": "build", "nvcc_s": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in build.BUILD_LOG.items()}})
    # the dry run's production cells need no card: they run beside the
    # phases below (dryrun_grid collects them at the end)
    grid = None if args.only is not None else start_dryrun_grid()

    # 3. kernels against their plain versions
    results = []
    checks = {"paged_attention": check_paged_attention,
              "rmsnorm": check_rmsnorm, "matmul": check_matmul,
              "lora": check_lora, "ssm_scan": check_ssm_scan,
              "flash_attention": check_flash_attention}
    for name in args.only or KERNEL_CHECKS:
        checks[name](torch, results)
    for r in results:
        emit({"phase": "kernel", **r})
    if args.only is not None:
        print(smi, flush=True)
        return 0

    cfg = get_config("qwen3-0.6b")
    # 4. the compile pipeline at full width, kernels on the card
    compile_launches = compile_phase(torch, cfg)
    # 5. serve, full width, bf16: the base workload, then the same workload
    # spread over four tenants; identity runs; a profiled window
    params = build_model(cfg, DEV).init(0)
    launches, base, base_tokens = serve_phase(torch, cfg, params)
    # multi-device serving: the same workload on a 1-rank NCCL mesh with TP
    # weights, then two gloo ranks on this card: qwen at 4 layers, olmoe at 2,
    # the gateway over both on that mesh, and qwen trained at 2 layers
    # on 2x1 and 1x2 training meshes
    mesh_launches = serve_mesh_phase(torch, cfg, params, base_tokens)
    mesh2_launches, moe_mesh_launches, train_mesh_launches = \
        serve_mesh_2_phase(torch, cfg, smi)
    plan_identity(torch, cfg, params)
    lora_launches = lora_serve_phase(torch, cfg, params, base)
    lora_identity_phase(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    # the serve profiles at half depth (the hybrid's at 4 of its 9
    # segments), cut for the time of the examples phase
    profile_phase(torch, at_depth(cfg, cfg.n_layers // 2))
    # 6. oracles: dense in f32 and bf16, one tenant's request in f32
    oracle_phase(torch, dataclasses.replace(cfg, dtype="float32"))
    oracle_phase(torch, cfg)
    lora_oracle_phase(torch, cfg)

    # 7. the stateful families at full width, bf16, one at a time: the serve
    # workload, a swap-resume (ssm) and a profiled window each
    ssm_cfg = get_config(SSM_ARCH)
    params = build_model(ssm_cfg, DEV).init(0)
    ssm_launches = stateful_serve_phase(torch, ssm_cfg, params)
    dryrun_ssm_calib_phase(torch, ssm_cfg, params, smi)
    swap_resume_phase(torch, ssm_cfg, params)
    del params
    torch.cuda.empty_cache()
    profile_phase(torch, at_depth(ssm_cfg, ssm_cfg.n_layers // 2), steps=8,
                  phase="ssm_profile")
    torch.cuda.empty_cache()
    hy_cfg = get_config(HYBRID_ARCH)
    params = build_model(hy_cfg, DEV).init(0)
    hybrid_launches = stateful_serve_phase(torch, hy_cfg, params)
    del params
    torch.cuda.empty_cache()
    profile_phase(torch, at_depth(hy_cfg, 4 * hy_cfg.hybrid.attn_every),
                  steps=8, phase="hybrid_profile")
    # 8. their oracles: 2 Mamba1 layers; 2 hybrid segments
    stateful_oracle_phase(torch, ssm_cfg, n_layers=2)
    stateful_oracle_phase(torch, hy_cfg,
                          n_layers=2 * hy_cfg.hybrid.attn_every)

    # 9. the gateway at full width, bf16: qwen3-0.6b with adapters and
    # falcon-mamba-7b behind one router, streamed over HTTP; qwen alone
    # under open-loop arrivals; the chaos lane on qwen
    params = gateway_phase(torch, cfg, at_depth(ssm_cfg, GATEWAY_SSM_LAYERS),
                           smi)
    gateway_open_loop_phase(torch, cfg, params, smi)
    gateway_chaos_phase(torch, cfg, params, smi)
    del params
    torch.cuda.empty_cache()

    # 10. training: full-width qwen3-0.6b bf16 through the Trainer (K3
    # forward and backward, K2 through RMSNormFn), int8 moments, a restart,
    # the card's gradients against the CPU's, a profiled window
    train_launches, train_log, train_rate = train_phase(torch, cfg)
    # the same steps through the mesh path on a 1-rank NCCL group
    train_mesh_phase(torch, cfg, train_log, train_rate)
    # the dry run's prefill and decode steps against the card's
    dryrun_serve_calib_phase(torch, cfg, smi)
    train_remat_phase(torch, cfg)
    train_restart_phase(torch, cfg)
    train_oracle_phase(torch, cfg)
    # the train profiles at half depth (the hybrid's at 4 of its 9
    # segments), cut for the time of the prefill and decode phases when
    # the script took 1,189 s on a slow host
    train_profile_phase(torch, at_depth(cfg, cfg.n_layers // 2))
    # 14. the port's examples at full width: quickstart, serve_lm, train_lm
    # (2 layers) and compile_inspect
    examples_phase(torch, cfg, smi)

    # 11. the stateful families' training at full width, bf16 (falcon-mamba
    # with int8 moments: f32 ones do not fit beside its weights), a
    # profiled window each, then their card-against-CPU oracles at 1
    # layer / 1 segment and restarts at 1 layer / 1 segment (with the
    # hybrid's restart at 2 segments the script took 1,008 s; its oracle
    # went from 2 segments to 1 when the script with the dry run's phases
    # took 1,133 s on a slow host, and to 3 of its 6 Mamba2 layers, with
    # its restart, when the prefill and decode phases took it to 1,189 s;
    # the ssm oracle from 2 layers to 1 and the hybrid's segment to 2
    # Mamba2 layers for the examples phase)
    ssm_train_launches = train_stateful_phase(torch, ssm_cfg, "int8")
    train_profile_phase(torch, at_depth(ssm_cfg, ssm_cfg.n_layers // 2),
                        steps=2, opt_state="int8", phase="train_ssm_profile")
    hybrid_train_launches = train_stateful_phase(torch, hy_cfg, "f32")
    train_profile_phase(torch, at_depth(hy_cfg, 4 * hy_cfg.hybrid.attn_every),
                        steps=2, phase="train_hybrid_profile")
    # (the restarts at 4 steps, checkpointed every 2 and failing at 3: cuts
    # for the time of train_mesh_2's family runs and the dry run's phases)
    train_stateful_oracle_phase(torch, ssm_cfg, 1, "int8", witness=False,
                                restart=STATEFUL_RESTART, restart_layers=1)
    hy_short = dataclasses.replace(hy_cfg, hybrid=dataclasses.replace(
        hy_cfg.hybrid, attn_every=HYBRID_ORACLE_SEGMENT))
    hybrid_leaf_tol = train_stateful_oracle_phase(
        torch, hy_short, HYBRID_ORACLE_SEGMENT, "f32",
        restart=STATEFUL_RESTART, restart_layers=HYBRID_ORACLE_SEGMENT)
    # train_mesh_2's zamba2 run: its leaves against one device's, held to
    # the hybrid oracle's limit (the hybrid's f32 gradients depend on the
    # order of sums)
    hybrid_mesh_gate(hybrid_leaf_tol)

    # 12. the moe family at full width: olmoe-1b-7b served (bf16, native
    # capacity factor), a profiled window, two tenants on its attention;
    # its oracles (f32 and bf16 paged against dense at the no-drop factor,
    # 2 layers card against CPU at the native one); one super-layer of
    # llama4 served; olmoe trained (int8 moments), profiled, at 8 layers
    # with f32 moments, and at 1 layer against the CPU and restarted (the
    # oracle at 2 layers until the examples phase needed the time)
    moe_cfg = get_config(MOE_ARCH)
    params = build_model(moe_cfg, DEV).init(0)
    moe_launches = moe_serve_phase(torch, moe_cfg, params)
    moe_lora_phase(torch, moe_cfg, params)
    moe_oracle_phase(torch, moe_cfg, params)
    del params
    torch.cuda.empty_cache()
    profile_phase(torch, at_depth(moe_cfg, moe_cfg.n_layers // 2), steps=3,
                  phase="moe_profile")
    # the f32 oracle at 8 of the 16 layers (16 until the examples phase
    # needed the time)
    moe_oracle_phase(torch, at_depth(dataclasses.replace(
        moe_cfg, dtype="float32"), moe_cfg.n_layers // 2))
    moe_cpu_oracle_phase(torch, moe_cfg)
    llama4_launches = llama4_layer_phase(torch, get_config(LLAMA4_ARCH))
    moe_train_launches = train_stateful_phase(torch, moe_cfg, "int8",
                                              f32_layers=MOE_F32_LAYERS)
    train_profile_phase(torch, at_depth(moe_cfg, moe_cfg.n_layers // 2),
                        steps=1, opt_state="int8",
                        phase="train_moe_profile")
    # the restart at 1 layer in 4 steps, failing at 3: checkpoints at
    # steps 2 and 4 (6 steps until the dry run's phases needed the time)
    train_stateful_oracle_phase(torch, moe_cfg, 1, "int8", witness=False,
                                restart=(4, 3, 2), restart_layers=1)

    # 13. the encoder-decoder and the VLM stub frontend at full width, bf16,
    # through the prefill and decode step builders (the paged engine
    # refuses both, as the reference's does): whisper-small served and its
    # 2 + 2 layers against the CPU; trained (f32 moments), at 2 + 2 layers
    # against the CPU and restarted; qwen2-vl-72b served at 16 layers and
    # trained at 2
    whisper_cfg = get_config(WHISPER_ARCH)
    whisper_launches = whisper_serve_phase(torch, whisper_cfg)
    whisper_oracle_phase(torch, whisper_cfg)
    whisper_train_launches = train_stateful_phase(
        torch, whisper_cfg, "f32", seq_len=WHISPER_TRAIN_SEQ,
        phase="train_whisper")
    train_stateful_oracle_phase(torch, whisper_cfg, 2, "f32", witness=False,
                                seq_len=WHISPER_TRAIN_SEQ,
                                phase="train_whisper")
    vlm_cfg = get_config(VLM_ARCH)
    vlm_launches = vlm_serve_phase(torch, vlm_cfg)
    vlm_train_launches = train_vlm_phase(torch, vlm_cfg)

    # the dry run's two production cells, started after the build
    dryrun_grid_phase(grid, smi)

    # each row's launches come from the main path that gives its shape
    # (the row's ``path``): the qwen3-0.6b serve workload (K1 at head_dim
    # 128, K2 at 1,024 and 128), its rank-0 run on the 2-rank serve mesh (K1
    # at 8 over 4 heads), olmoe's rank-0 run on that mesh (K1 at 8 over 8),
    # rank 0's training runs on that group (K3 at 8 over 4 heads, K2 at a
    # rank's rows),
    # the compile phase (K4), the multi-LoRA
    # workload (the fused delta, whose launches run K5's and K6's device
    # code: their rows count its launches, ``launches_of``), the ssm
    # workload (K7, K2 at 4,096) and the hybrid workload (K1 at head_dim
    # 80, K2 at 2,560 and 5,120) and the training run (K3 forward and
    # backward, K2 at the training rows), and the stateful families'
    # training runs (K7 forward with checkpoints and backward, K2 at 4,096;
    # K3 at head_dim 80, K2 at 2,560 and 5,120), and olmoe's serve workload
    # (K1 at 16 over 16 heads, K2 at 2,048 and its q/k pair) and training
    # run (K3 at 16 over 16 heads, K2's backward at 2,048), and llama4's
    # super-layer (K1 at 40 over 8 heads, K2 at its 4 decode rows), and
    # whisper's serve run (K3 over its encoder's 1,500 frames, K2 at 768)
    # and training run (K3 at 448, causal and not; K2's backward at 768),
    # and qwen2-vl's serve run (K2 at 8,192) and training run (K3 at 64
    # over 8 heads, K2 at 4,096 x 8,192)
    path_launches = {"serve": launches, "compile": compile_launches,
                     "serve_mesh": mesh_launches,
                     "serve_mesh_2": mesh2_launches,
                     "moe_mesh_2": moe_mesh_launches,
                     "train_mesh_2": train_mesh_launches,
                     "lora_serve": lora_launches, "ssm_serve": ssm_launches,
                     "hybrid_serve": hybrid_launches,
                     "train": train_launches,
                     "train_ssm": ssm_train_launches,
                     "train_hybrid": hybrid_train_launches,
                     "moe_serve": moe_launches,
                     "train_moe": moe_train_launches,
                     "llama4_layer": llama4_launches,
                     "whisper_serve": whisper_launches,
                     "train_whisper": whisper_train_launches,
                     "vlm_serve": vlm_launches,
                     "train_vlm": vlm_train_launches}
    sources = {
        "paged_attention": (
            "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:113"),
        "rmsnorm": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:19"),
        "rmsnorm_pair": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:19"),
        "rmsnorm_bwd": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:19"),
        "rmsnorm_pair_bwd": (
            "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:19"),
        "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:33"),
        "lora_shrink": ("cuda", "src/repro_torch/kernels/csrc/lora.cu",
                        "src/repro/kernels/lora.py:64"),
        "lora_expand": ("cuda", "src/repro_torch/kernels/csrc/lora.cu",
                        "src/repro/kernels/lora.py:98"),
        "lora_delta": ("cuda", "src/repro_torch/kernels/csrc/lora.cu",
                       "src/repro/kernels/lora.py:64+98"),
        "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:33"),
        "ssm_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                         "src/repro/kernels/ssm_scan.py:33"),
        "ssm_scan_fused": (
            "cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan.py:33"),
        "ssm_scan_fused_bwd": (
            "cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan.py:33"),
        "flash_attention": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:65")}
    summary = []
    for r in results:
        # the bf16 rows, and K7's, whose path is f32 only; not the
        # gate-only shapes no path gives
        if r["dtype"] != "bfloat16" and not r["name"].startswith("ssm_scan"):
            continue
        if r["path"] is None:
            continue
        kernel = r["name"].split("/")[0]
        route, source, replaces = sources[kernel]
        summary.append({
            "name": f"{r['name']} {r['shape']}", "route": route,
            "source": source, "replaces": replaces, "path": r["path"],
            "launches": path_launches[r["path"]][r.get("counter", kernel)],
            **({"launches_of": r["counter"]} if "counter" in r else {}),
            "max_abs_err": r["max_abs_err"],
            "row_rel_err": r["row_rel_err"], "ms": r["kernel_ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"sass_mma": r["sass_mma"]} if "sass_mma" in r else {})})
    assert {k["source"] for k in summary} >= {v[1] for v in sources.values()}
    assert all(k["launches"] > 0 for k in summary), \
        [k["name"] for k in summary if not k["launches"]]
    emit({"kernels": summary})
    # the script stops every process it starts
    from tools.session_leftovers import children
    assert not children(os.getpid()), children(os.getpid())
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
