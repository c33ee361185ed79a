#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port of SplitZip runs on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device   — the card's name and power limit, torch/CUDA versions, and the
              build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (``nvcc`` for sm_90a, all sources at once); the HGMMA
              (wgmma) instructions in the flash library's SASS and the
              HMMA (mma.sync) ones in the paged-attention library's, where
              the toolkit has ``cuobjdump`` (none of either fails the run).
2. kernels  — all four codec kernels held BITWISE against their plain
              PyTorch versions for bf16 / fp8_e5m2 / fp8_e4m3 (16- or
              14-entry exponent tables, then 8-entry ones) on edge inputs
              (specials, zero-/all-escape rows, count == cap and cap + 1,
              cap 1/64/128, a ragged tail) and on the persistent fused
              kernels' edges (chunks 256 to 8192, 1 and 7 rows, counts
              31/32/33/cap, one lane's span, slots 31 and 32 on one
              position, more rows than one pass of the largest of the
              three persistent grids: encode_fused, decode_fused,
              decode_dense), then timed at the main path's shape (one
              smollm-135m KV leaf: device time from a replayed CUDA graph,
              and issued eagerly) beside their plain versions and their
              memory bound, the persistent kernels with their grid and raw
              GB/s; the fused pair also on the same leaf with about two
              escapes a row.  Last, the capacity retry's whole decode half
              at that leaf encoded with ``layout='global'``
              (``twostage.decode_to_bits`` and ``ops.decode_bits``, each
              bitwise, eager and profiled device time, and the dense
              kernel's share of each).
3. main     — smollm-135m at full width with seeded random weights: batch 8,
              prompt 2048, 16 new tokens, codebook calibrated on the model's
              own prefill KV, through ``launch/serve.py``'s code path with
              the ``cuda`` backend at n_chunks 1 and 8 and with
              compression off.  Delivered caches must equal the prefill
              cache bit for bit and the tokens must agree across the runs.
              At n_chunks 1 it also reports the escapes per row of the
              streams sent and one ``torch.profiler`` trace of the encode
              and decode halves (host clock beside device time).
4. capacity — a cache with one chunk of nothing but escapes walks the
              capacity schedule to ``layout='global'``: the dense kernels
              launch and delivery stays bitwise.
4a. profile — ``CalibratedProfile.measure`` of the ``cuda`` backend at the
              main-path leaf's shape (5 repeats; host clock around
              synchronized calls) and of the ``torch`` backend on a smaller
              one: g_enc, g_dec and ratio beside the kernels' device GB/s,
              saved under ``build/`` and resolved back equal, and the
              served transfer's ``transfer_report`` at 100 Gb/s under the
              measured profile and the paper's.
4b. verified — smollm-135m served with ``verify=True`` under a seeded
              ``FaultPlan`` at n_chunks 1 and 8 (a corruption and a drop
              each, seeded rates at 8): delivery bitwise, tokens equal to
              the fault-free run's, every injected fault re-fetched, encode
              launches as fault-free; an unverified run whose corrupted
              entry arrives corrupted; a failover re-send bitwise at the
              same wire bytes and with no encode; the verified transfer's
              host time against the plain one, in turns.
4c. wire    — the served cache through ``wire`` and ``wire-verify``:
              bitwise round trip, each SZ02 payload the size
              ``payload_bytes_model`` says, encode and decode timed; a
              flipped byte raises ``WireIntegrityError`` naming its frame;
              phase 4's all-escape chunk through the wire's global
              re-encode (the dense kernels).
4c'. fp8    — phase 3's served cache cast to float8_e5m2 (k 16) and
              float8_e4m3fn (k 8), codebooks from ``fp8.calibrate_fp8``,
              through the plan's ``fp8`` route on ``cuda``: bitwise, the
              wire ratio against native beside ``ratio_vs_native`` at the
              measured escape rate (wire bytes follow the size model's
              code bits; the nibble-packed streams' ratio apart).
4d. fleet   — the serving control plane on smollm's full-width weights:
              (a) prefix-delta transfer (batch 1, turn 1 a 2048-token
              prompt, turn 2 the same plus 256 tokens, n_chunks 480: a
              segment is an eighth of a leaf-layer slab): a cold delta
              equals a full transfer bitwise at equal wire bytes, the same
              cache again ships 0 bytes with no codec launch, k altered
              segments ship exactly k (k encode_fused and k decode_fused
              launches), another session id hits nothing, the tokens after
              a delta equal those after a full transfer; reported: turn 2's
              hit share against the slab geometry's prediction, whether the
              two prefills' K/V agree bitwise over the shared prompt, delta
              and full host ms in turns, the comparison pass's device ms.
              (b) a ``DisaggregatedScheduler`` (1 prefill, 1 link, 2 decode
              workers, router ``transfer-aware``) kills decode worker 0; its
              ``on_failover`` hook re-sends through ``resend_cache``: every
              re-send bitwise the baseline, no encode, one decode_fused a
              leaf.  (c) the Fig. 2 analogue: 256 requests of a seeded
              multi-tenant trace (prompts 256–16384, sessions 0.3) over
              2 prefill x 2 links (50 GB/s and a quarter of it) x 4 decode
              workers, every link policy, bucket plans of smollm-135m's and
              qwen3-moe-30b-a3b's caches (meta tensors), priced with phase
              ``profile``'s measured cuda profile against the native link
              and phase ``main``'s prefill and decode-step times: link busy
              conserved, every request accounted for, two runs equal, and
              SplitZip's link busy time below native's.
5. attention — the paged-attention kernels against their plain versions:
              ``decode_pages`` (the kernels' shared page decoder) BITWISE
              for bf16 / fp8_e5m2 / fp8_e4m3 pages with escape counts 0,
              cap and over cap, padding and repeated slots, NaN/Inf/zero/
              subnormal payloads; ``paged_gqa_attention`` and
              ``paged_mla_attention`` within ``PARTIALS_RTOL`` on edge inputs
              (an empty row, nq 1 and 4 causal, K/V and ckv/krope with their
              own caps, every format; for both also the split's edges at
              their own split count, one split and the wrapper's) and at
              the main paths' geometries (GQA at smollm-135m's and
              qwen3-moe-30b-a3b's, MLA at minicpm3-4b's, with its grid),
              where each is timed (device time from a replayed CUDA graph,
              and issued eagerly) beside its plain version, its bound
              (GQA's on the f32 ALU rate, MLA's on the bf16 tensor-core
              rate its products run at), and SDPA over the same prefix
              held raw (a yardstick only).
6. resident — smollm-135m at full width, ``resident="compressed"``: batch 8,
              prompt 2048, 40 new tokens through ``serve_once``.  Admitted
              (not demoted), the pool rehydrates bitwise to the prefill
              cache, one flush per row, the exact resident/raw byte counts,
              and teacher-forced logits within 0.12 max|logits| of raw decode.
7. mla      — minicpm3-4b at full width (62 layers), batch 4, prompt 1000,
              40 new tokens: the raw path (cuda backend, n_chunks 1 and 8,
              compression off) bitwise, then the resident path as phase 6.
8. demotion — an out-of-band codebook makes the stream inadmissible: the
              batch demotes once and its tokens equal the raw-resident
              engine's bit for bit.
8a. minitron — minitron-4b at full width (32 layers, d_model 3072, GQA
              24/8 x 128), batch 4, prompt 2048, 16 new tokens, served raw
              (cuda, n_chunks 1) and with compression off: delivery
              bitwise, tokens equal, 32 flash launches.
8b. ssm     — mamba2-2.7b at full width (64 layers, d_model 2560, 80 heads
              x 64, d_state 128), batch 4, prompt 2048 (8 SSD chunks), 16
              new tokens, three runs: ``compress_fp32=True`` (the 671 MB
              f32 SSM state's hi halves fold into the codec stream),
              ``compress_fp32=False`` (the state ships raw), compression
              off.  Delivered state bitwise the prefill's, tokens equal;
              per run the prefill, transfer and decode-loop seconds, the
              ratio, escapes per row, capacity retries and peak memory.
8c. hybrid  — recurrentgemma-9b at full width (12 triples + 2 extra
              recurrent blocks, d_model 4096, LRU 4096, window 2048), batch
              4, prompt 4096 (past the window: the cache keeps the last
              2048 positions), 16 new tokens, the same three runs and
              gates as ``ssm``; its prefill launches the flash kernel 12
              times, all on the tensor-core path, and its first and last
              local-attention layer join ``flash_live`` (bound counted over
              the window; SDPA with an explicit band mask).
8d. vlm     — pixtral-12b at full width (40 layers, d_model 5120, GQA 32/8
              x 128, d_ff 14336, vocab 131072; the vision frontend a stub of
              precomputed patch embeddings through ``frontend_proj``), batch
              4, 256 patches + 1792 text tokens (2048 positions), 16 new
              tokens: served compressed (cuda, n_chunks 1) and with
              compression off (delivery bitwise, tokens equal, 40 flash
              launches), then compressed-resident with an explicit max_seq
              (as phase 6: admitted, bitwise rehydrate, one flush a row,
              teacher-forced logits within 0.12 max|logits| of raw decode;
              its first layer joins ``flash_live``).
8e. persist — the persistent executor on the card: phase 8d's served
              cache through ``session.save`` (one SZ02 file a leaf and the
              ``szpersist-1`` manifest, in a temporary directory under
              ``build/``, removed at the end) and ``session.load`` back
              onto the card, bitwise; save and load host ms, each leaf's
              wire encode, host Fletcher-32 and verified decode ms,
              directory bytes against raw bytes.  Then a
              ``Checkpointer`` drill on a small train-state tree: steps 1
              and 2 saved, a leaf file of step 2 corrupted, ``restore``
              falls back to step 1 bitwise with re-reads counted.
8f. audio   — hubert-xlarge at full width (48 layers, d_model 1280, 16
              heads x 80, encoder-only), batch 8 x 1500 frames (30 s of
              audio at 50 frames/s) through ``serving.prefill.prefill_step``
              (the launcher refuses the config, as the JAX launcher does;
              the refusal is checked first): 48 flash launches, every one
              on the tensor-core path, no cache, finite logits; its first
              and last layer's live q/k/v join ``flash_live``, not causal.
8g. mesh    — the pod-to-pod hop across processes: 2 ranks spawned on the
              one card over gloo (mesh (2, 1, 1), ``launch/mesh.py``; the
              kernels are built by the parent first).  Rank 0, the prefill
              pod, draws smollm-135m from the seed and prefills batch 8 x
              2048 (30 flash launches, all wgmma); it ships the 380 MB
              cache through the mesh executor at n_chunks 1 and 8, through
              a compress-off plan, and with an all-escape first chunk of
              ``k`` (3 capacity-schedule steps, the dense kernels).  Rank
              1, the decode pod, holds every delivery bitwise against the
              compress-off copy and decodes 16 tokens from each, equal to
              rank 0's tokens from its own cache.  Per rank: wire and raw
              bytes, the ratio, the host ms of the hop, its staging, wire
              and codec parts, and the codec launches (each run counted
              alone in its rank).
8h. ring    — the compressed ring all-reduce: 4 ranks, contributions
              shaped like smollm-135m's parameter tree (134.5 M bf16 a
              rank) plus a leaf of 65536 values spread over 80 binades,
              through ``grad_compress.compressed_cross_pod_mean``.
              Small integers (compressed and raw): bitwise equal to
              ``torch.mean``; normal values: bitwise equal to each rank's
              ring-order f32 sum, and within the f32 summation bound of
              rank 0's (the bf16 ulp spread reported); the wide leaf
              overflows and re-runs raw.  Per rank: ms a hop, bytes
              handed to gloo against ``cross_pod_wire_bytes``.
8i. train   — training at smollm-135m's full width (30 x 576, 9/3 heads
              x 64, vocab 49152, tied embeddings; weights and data from
              the seed), batch 8 x 2048, AdamW with the launcher's
              defaults, through ``launch/train.py``'s ``make_run``.  (a) One
              process under ``torch.use_deterministic_algorithms`` (and
              ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): 4 steps uninterrupted,
              then a ``ResilientTrainer`` with a ``Checkpointer`` on the
              card (a checkpoint every 2 steps, a crash injected at step 3):
              every loss finite, the restored state bitwise the one saved
              at step 2, the resumed losses and final state bitwise the
              uninterrupted run's.  Step ms (first apart), tok/s, peak GB,
              save and restore ms, raw and directory bytes, escapes a row
              of the parameters and of the moments' hi halves, leaves that
              took the global re-encode.  (b) Two gloo ranks on the card,
              ``--grad-compress``, 4 sequences a rank: one step under the
              launcher's default gradient codebook (window
              ``train_ring_default``: its encodes and raw re-runs), then 2
              steps under a codebook calibrated on that step's pod-0
              gradients (window ``train_ring``: encode and decode must
              launch): the ranks' parameters bitwise equal after each
              step, each rank's averaged gradients bitwise the f32 mean of
              both half-batch gradients computed in the rank, cast to
              bf16; ring ms and its share of the step, bytes handed to
              gloo beside ``cross_pod_wire_bytes``, leaves routed raw.  No
              train window launches the flash kernel.
8j. shard   — the sharding policy and the sharded train step
              (``make_run(policy=)``) at smollm-135m's full width cut to
              4 layers (``SHARD_LAYERS``), batch 8 x 2048, ranks spawned
              over gloo on the one card.  (a) Mesh
              (pod 1, data 2, model 1), 2 steps with ``fsdp`` on and off:
              the gathered parameters and moments bitwise equal across
              ranks and between the two runs, each rank's held bytes
              equal to the spec arithmetic, and the FSDP run within
              ``tests/test_torch_shard_train.py``'s bounds of the
              single-process step on the same batches (rank 0); the
              token lookup's gradient at the train batch within one bf16
              rounding of an f32 sum (indexing's reported beside it).  Per
              rank: held bytes, peak memory, step ms, gather / reduce ms
              and bytes.  (b) Mesh (pod 2, data 2, model 1), FSDP, one
              step with ``grad_compress`` under phase ``train``'s
              calibrated gradient codebook: the data-reduced shards cross
              pods through the compressed ring (window ``shard_ring``:
              encode and decode must launch on rank 0), the four ranks'
              gathered parameters bitwise equal.  (c) The
              ``pd_disaggregated`` policy's ``cache_specs`` on (pod 2,
              data 2) drive that model's served cache pod 0 -> 1: every
              destination shard bitwise the one its source sent; bytes
              each rank hands to gloo.
8k. tp      — tensor-parallel training over the model axis
              (``distributed/tensor_parallel.py``) at smollm-135m's full
              width cut to 4 layers (``SHARD_LAYERS``), batch 4 x 2048, 2
              steps, ranks spawned over gloo on the one card.  (a) Mesh
              (pod 1, data 1, model 3): 9 / 3 heads split (attention
              case ``heads``), every split leaf a third a rank; (b) mesh
              (1, 2, 2) with FSDP: 9 heads do not split over 2, the
              ``seq`` fallback.  Gates: the ranks'
              gathered states bitwise equal, each leaf replicated over
              model bitwise equal across the model ranks, held bytes
              equal to the spec arithmetic, no parameter gathered over
              model (the step's gather bytes are the data axis's), no
              flash launch (windows ``tp_heads``, ``tp_seq``), and rank 0
              within ``tests/test_torch_shard_train.py``'s bounds of the
              single-process step on the same batches.  Per rank: held
              bytes, step ms, the activation collectives' bytes and ms
              forward and backward, gather / reduce / norm, peak memory.
8l. ep      — MoE training under the model and data axes: expert
              parallelism and global-batch routing
              (``distributed/expert_parallel.py``) at qwen3-moe-30b-a3b's
              full width (d_model 2048, 32 / 4 heads x 128, 128 experts
              top-8, d_ff_expert 768, vocab 151,936, capacity factor
              1.25) cut to 2 layers, batch 2 x 2048 (capacity 320 a
              layer), one step (``EP_STEPS``) through
              ``make_run(policy=)``, ranks spawned over gloo.  The
              single-process step runs first, in this process, and saves
              its state after each step as bf16
              under ``build/`` (removed after the phase); each rank maps
              it and reads its blocks, so the 18.7 GB state crosses
              neither gloo nor the ranks' share of the card.  (a) Mesh
              (1, 1, 2): 64 experts, 16 / 2 heads and half the vocab a
              rank; (b) (1, 2, 2) with FSDP: one sequence a data rank
              (capacity 160 alone, 320 over the routing group).  Gates:
              the leaves replicated over model bitwise across the model
              ranks, held bytes equal to the spec arithmetic, the state
              after each step within the ``SHARD_*`` bounds of the
              single-process step (the ranks' shares of each leaf's
              distance summed), no parameter gathered over model, no
              flash or codec launch (windows ``ep_heads``, ``ep_fsdp``),
              and each layer's dropped choices and slots on its
              first-step input equal to the single-process FFN's on the
              same router logits (whether the rank's own router product
              gave the whole product's bits is reported, with the run's
              own drops).  Per rank: step ms, every collective's bytes
              and ms (the expert-output gathers ``ep_gather``), peak
              memory, dropped choices a layer.
8m. tp_recurrent — tensor-parallel training of Mamba-2 and the RG-LRU
              hybrid over the model axis, ranks spawned over gloo, each
              world's single-process step run first and saved as in
              phase ``ep``.  (a) mamba2-2.7b at full width (2560, 80
              heads x 64, d_state 128, in_proj K 10,576, vocab 50,280)
              cut to 4 layers, mesh (1, 2, 2) with FSDP, batch 2 x 2048
              (one sequence a data rank): ``in_proj``'s product gathered,
              the SSD scan whole on every model rank, ``out_proj`` a row
              product; (b) recurrentgemma-9b at full width (4096, LRU
              4096, d_ff 12,288, 16 heads over 1 KV head x 256, vocab
              256,000, window 2048) cut to one triple and 2 extra
              recurrent blocks, mesh (1, 1, 2), batch 1 x 4096 (the window
              bites), lr 3e-5 (at 3e-4 its first step diverges, 13.35 ->
              18.21, and amplifies round-off past the loss bound): the
              RG-LRU on a rank's half of the channels, the local attention
              in case ``kv``.  2 steps each, each step donating its state
              (``make_run(donate=True)``: the hybrid's 3.2 B parameters'
              reference holds one state, not two).  Gates as in
              ``ep``: model replicas bitwise, held bytes exact, no
              parameter gathered over model, no flash or codec launch
              (windows ``tpr_ssm``, ``tpr_hybrid``), each step and the
              state after it within the ``SHARD_*`` bounds of the
              single-process step; a leaf initialised to 0 (``conv_b``,
              ``dt_bias``, ``b_a``, ``b_x``) is its AdamW updates alone,
              whose signs round-off may flip, so its elements are held
              within the two updates' distance plus one rounding and the
              flipped ones counted.  Per rank: step ms, every
              collective's bytes and ms, held bytes, peak memory.
8n. serve_tp — sharded serving of the dense family
              (``serving/sharded.py``): qwen3-32b at full width (5120, 64
              / 8 heads x 128, d_ff 25,600, vocab 151,936, untied) cut to
              4 layers, batch 2, prompt 2048, max_seq 4096, 8 decoded
              tokens, each rank drawing its block of the seeded
              parameters in turn.  (a) mesh (2, 1, 2) under
              ``pd_disaggregated``, the dry-run's ``xfer_chunked``: pod 0
              prefills at model 2 (case ``heads``; the cache's 4096 slots
              split, rank 0's block the prompt, rank 1's zeros until
              decode writes it), each pod-0 rank ships its own shard
              through ``transfer_shard`` with the first token and
              ``cache_len``, pod 1 decodes 8 tokens from the shards; then
              one ``xfer_global`` hop of the same shards.  (b) mesh (1, 2,
              2): the batch over data, ``prefill_step(tp=)`` then
              ``decode_loop(tp=)``.  (c) the same mesh under ``fsdp``: a
              rank holds half its model blocks (1,753,134,080 bytes), and
              the prefill and each of 2 decode steps gather each layer's
              blocks over data before its products
              (``serving/sharded.block_gather``); held bitwise to (b)'s
              first tokens, first 2 steps' tokens and logits, and cache
              after the prefill and after 2 steps (hashes; (b) hashes its
              own after 2 uncounted steps); per rank the gathers' bytes, ms
              and all-gathers a pass, and both worlds' peaks read after
              the draw.  Then the single-process replay: the
              whole parameters, the prefill and each decode rank's tokens
              teacher-forced, and its round-off witness (the same run with
              the row products f32, rounded once).  Gates: pod 1's shards
              bitwise pod 0's (both hops), held bytes equal the spec
              arithmetic (parameters, cache, ``init_cache(policy=)``),
              model replicas bitwise (parameter blocks, replicated leaves,
              tokens), no parameter storage handed to a collective over
              ``model``, one tensor-core flash launch a layer on every
              prefill rank and none in decode, the hops' codec launches,
              logits within the CPU tests' bound or 1.5 times the
              witness's distance.  Per rank: prefill and decode-step ms
              (host clock), held and received bytes, the hop's wire
              bytes and ratio, peak memory.
8o. serve_tp_families — sharded serving of MLA and of MoE under
              expert parallelism, phase ``serve_tp``'s worlds, machinery
              and gates, each world's ranks spawned once for both
              families: minicpm3-4b at full width (2560, 40 heads, MLA
              ranks 768 / 256, nope / rope / v 64 / 32 / 64, d_ff 6400,
              vocab 73,448) cut to 8 layers, whose latent cache
              (``ckv``, ``krope``) splits its 4096 slots over model and
              whose decode is the absorbed form over a rank's span
              (``mla.mla_decode_tp``); then qwen3-moe-30b-a3b at full
              width (2048, 32 / 4 heads x 128, 128 experts top-8, expert
              d_ff 768, vocab 151,936) cut to 2 layers, 64 experts a
              rank, routed over the data axis
              (``serving/sharded.expert_parallel``).  The replay of a MoE
              is routed as the ranks recorded (a world's prefill as its
              prefill ranks, each decode rank's steps as it did), so the
              logits gates read the sharding's round-off, not routing
              flips.  Gates as ``serve_tp``'s, and the decoded tokens equal
              the replay's greedy choice (MoE: where its top logit leads
              by 1e-2).  A line a rank and family: prefill and
              decode-step ms, ``tp.fwd`` and the expert-parallel bytes
              and ms, the hops' raw and wire bytes, ratio and retry steps,
              held bytes, peak GB.
8p. serve_tp_recurrent — sharded serving of Mamba-2 and of the RG-LRU
              hybrid, whose states split heads, channels or the window's
              KV heads (never the sequence): phase ``serve_tp``'s worlds
              and machinery, each world's ranks spawned once for both
              families, the (2, 1, 2) hop ``xfer_chunked`` (the f32
              states raw) then ``xfer_fp32`` (their hi halves through the
              dense codec pair, ``fp32_hilo``).  mamba2-2.7b at full width
              (2560, 80 heads x 64, d_state 128, vocab 50,280) cut to 4
              layers, prompt 2048, 4096 slots; recurrentgemma-9b at full
              width (4096, 16 heads x 256 over one KV head, U 4096, window
              2048, d_ff 12,288, vocab 256,000) cut to one triple and 2
              extra blocks, prompt 4096 (twice the window), 8192 slots.
              Gates as ``serve_tp_families``', the replicated window's
              replicas bitwise, the f32 states' routes, the dense pair
              launched under ``xfer_fp32``, no ``chunked_attention`` in a
              served window (every serving phase), recurrentgemma's one
              flash launch a prefill rank and Mamba-2's none.  A line a
              rank and family: prefill and decode-step ms, ``tp.fwd``
              bytes and ms, the decode step's collectives over ``model``,
              each hop's raw and wire bytes, ratio and retry steps by
              route, held bytes, peak GB, the f32 state blocks' largest
              distance from the replay's.
8q. dryrun  — the multi-pod dry run on fake ranks
              (``python -m repro_torch.launch.dryrun``), in subprocesses
              (a ``fake`` process group, fake tensors: nothing allocated,
              no card): (a) four full-size cells, qwen3-32b
              ``decode_32k`` on the (16, 16) mesh with ``fsdp`` off and
              on, qwen3-32b ``prefill_32k`` ``xfer_chunked`` on (2, 16,
              16) and
              smollm-135m ``train_4k`` ``fsdp`` on (16, 16): each rank's
              peak GB against the card's 80 GB, FLOPs, bytes, collective
              bytes, the H100 roofline terms and bottleneck, the seconds
              a cell took; (b) phase ``serve_tp``'s configuration and
              worlds dry-run at every rank coordinate, its predictions
              held against what that phase's gloo ranks counted on the
              card: held parameter and cache bytes, ``tp.fwd`` bytes
              (prefill, and each decode step), the collectives over
              ``model`` a decode step, the ``fsdp`` world's gathers (bytes
              and all-gathers, the prefill's and the decode steps'), the
              hop's raw shard bytes and side
              message exactly, its wire bytes within the capacity-sized
              payload where no unit overflowed; (c) each rank's predicted
              peak beside its ``torch.cuda.max_memory_allocated`` (since
              the draw) and the peak read after the draw, no gate.
9. moe      — qwen3-moe-30b-a3b at full width (48 layers, d_model 2048,
              128 experts top-8, about 61 GB of random bf16 weights drawn
              a layer at a time), batch 4, prompt 2048, 40 new tokens: the
              raw path (n_chunks 1 and 8, compression off) bitwise, then
              the resident path as phase 6 (32-token pages).  Peak device
              memory is reported per phase.  Each family's model is freed
              before the next is drawn.

Then a ``timing`` line: each phase's host seconds (build included), so a
run that grows shows where.  Each phase's seconds also go to standard error
as it ends.

Prefill attention runs the flash-attention kernel in every attention layer,
on its tensor-core (wgmma) path for every served family.  Phase ``flash``
(after phase 5) holds it against its plain version on seeded edge cases,
each on the path its dtype and widths pick; each family's phase then holds
it on the live q/k/v of
its first and last layer (captured from a prefill at the served geometry)
against the plain version and against ``chunked_attention``, and times it
beside the plain version and ``scaled_dot_product_attention`` (a yardstick
the port never calls); phase ``flash_live`` reports the six geometries,
recurrentgemma's with its window, hubert's not causal at d 80.  Phase
``flash``'s cases include sliding windows (1, 16, 100, >= Skv, non-causal,
d 256 with one KV head) on both kernels, d = dv = 80 without the causal
mask, and a GQA group of 4 at d 128.

The launch counters are set to 0 right before each main-path run and read
right after it: the served transfer of phase 3 (``encode_fused``,
``decode_fused``), the capacity walk of phase 4 (``encode_dense``,
``decode_dense``), each path of phases 4a–4d (the codec kernels'
``launches_by_path``; phase 4d's turn-2 delta and the scheduler run with
its re-sends), the served resident decode of phases 6
(``paged_gqa_attention``), 7 (``paged_mla_attention``) and 8d, the
persistent executor's save and load (phase 8e), each mesh run on each of
its two ranks and each compressed ring on rank 0 (phases 8g, 8h; counted
inside the rank), the training checkpoint's saves and restore and each
step's gradient ring on rank 0 (phase 8i, ``train_save``,
``train_restore``, ``train_ring``, ``train_ring_default``: the launcher's
default gradient codebook; the train steps, counted apart in
``train_steps``, launch no flash kernel), the sharded step's ring on rank
0 and the policy-specified hop on a source and a destination rank (phase
8j, ``shard_ring``, ``shard_hop_src``, ``shard_hop_dst``), the
tensor-parallel steps on rank 0 (phase 8k, ``tp_heads``, ``tp_seq``: no
flash launch), the expert-parallel steps on rank 0 (phase 8l,
``ep_heads``, ``ep_fsdp``: no flash or codec launch), the recurrent
families' tensor-parallel steps on rank 0 (phase 8m, ``tpr_ssm``,
``tpr_hybrid``: no flash or codec launch), each sharded serving rank's
prefill, decode and hops (phase 8n, ``serve_tp_*``; phase 8o,
``serve_fam_mla_*``, ``serve_fam_moe_*``; phase 8p, ``serve_rec_ssm_*``,
``serve_rec_hybrid_*``), and the served prefills of phases 3, 7, 8a, 8c,
8d, 8f, 8n's, 8o's and 8p's base rank 0 and 9 (``flash_attention``: one
launch per attention layer, 30 + 62 + 32 + 12 + 40 + 48 + 4 + 8 + 2 + 1 +
48, every one on the tensor-core path, or the run fails);
the checks around those runs are not counted.  The
``kernels`` JSON line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": ...}`` close the output.  Without CUDA, or outside
a checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # 32-bit ALU rate outside the tensor cores
H100_BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core rate
ARCH, BATCH, PROMPT, NEW_TOKENS = "smollm-135m", 8, 2048, 16
RES_TOKENS = 40                  # phase 6: the tails fill and flush at step 32
MLA_ARCH, MLA_BATCH, MLA_PROMPT = "minicpm3-4b", 4, 1000
MOE_ARCH, MOE_BATCH, MOE_PROMPT = "qwen3-moe-30b-a3b", 4, 2048
# |logits| bound of resident vs raw decode, the JAX package's own
# (tests/test_kvpool.py): raw decode accumulates p.v in bf16, the paged
# kernel in f32
LOGITS_BOUND = 0.12


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


#: each phase's host seconds in this run, in the order the phases ran
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its host seconds kept under ``name`` and told on
    standard error."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"chip_smoke: phase {name} {PHASE_SECONDS[name]:.3f} s",
          file=sys.stderr, flush=True)
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, ops: float, ops_per_s: float = H100_F32_OPS_PER_S):
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_count(lib_path, opcode: str):
    """How many ``opcode`` instructions the library's SASS holds
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    sass = build.sass(lib_path)
    return None if sass is None else sum(opcode in ln for ln in sass.splitlines())


def profiled(torch, fn, reps: int = 1):
    """``fn()`` ``reps`` times under ``torch.profiler``, after a
    synchronize: (host ms a call, profiled; ``[(device ms a call, calls,
    name)]`` of the kernels and copies it ran and ``[(host self ms a call,
    calls, name)]`` of its host operations, each largest first)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    events = prof.key_averages()
    device = sorted(((ev.device_time_total / 1e3 / reps, ev.count, ev.key[:90])
                     for ev in events
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and ev.device_time_total > 0), reverse=True)
    host = sorted(((ev.self_cpu_time_total / 1e3 / reps, ev.count, ev.key[:60])
                   for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)
    return wall * 1e3, device, host


def launch_counters():
    """Every kernel wrapper, by its kernel's name."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E
    return {"encode_fused": E.encode_fused, "decode_fused": D.decode_fused,
            "encode_dense": E.encode_dense, "decode_dense": D.decode_dense,
            "paged_gqa_attention": SA.paged_gqa_attention,
            "paged_mla_attention": SA.paged_mla_attention,
            "decode_pages": SA.decode_pages,
            "flash_attention": FA.flash_attention}


def counted(fn, *args):
    """``fn(*args)`` with every launch counter set to 0 just before it and
    read just after it: ``(result, {kernel: launches})``; the flash kernel's
    tensor-core launches count apart as ``flash_attention_tc``, its causal
    ones as ``flash_attention_causal``."""
    from repro_torch.kernels import flash_attention as FA
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    FA.flash_attention.launches_tc = 0
    FA.flash_attention.launches_causal = 0
    out = fn(*args)
    counts = {k: w.launches for k, w in wrappers.items()}
    counts["flash_attention_tc"] = FA.flash_attention.launches_tc
    counts["flash_attention_causal"] = FA.flash_attention.launches_causal
    return out, counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

KERNELS = {
    "encode_fused": ("src/repro_torch/kernels/csrc/splitzip_encode.cu",
                     "src/repro/kernels/splitzip_encode.py:203"),
    "decode_fused": ("src/repro_torch/kernels/csrc/splitzip_decode.cu",
                     "src/repro/kernels/splitzip_decode.py:142"),
    "encode_dense": ("src/repro_torch/kernels/csrc/splitzip_encode.cu",
                     "src/repro/kernels/splitzip_encode.py:154"),
    "decode_dense": ("src/repro_torch/kernels/csrc/splitzip_decode.cu",
                     "src/repro/kernels/splitzip_decode.py:99"),
}


def _bits_tensor(torch, bits, device):
    """numpy container bits -> a tensor of the same width on ``device``."""
    if bits.dtype.itemsize == 2:
        return torch.from_numpy(bits.view("int16")).to(device).view(torch.uint16)
    return torch.from_numpy(bits).to(device)


def phase_kernels(torch, cfg, device):
    from repro_torch.kernels import cases as K
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E
    from repro_torch.kernels.timing import cuda_ms, graph_ms

    # edge inputs, all formats, every kernel bitwise against its plain
    # version; then the persistent fused kernels' own edges: every chunk
    # width, 1 and 7 rows, the 32-slot prefetch, one lane's span, a repeated
    # slot, and more rows than one pass of each grid covers
    n_cases, passes = 0, {}
    for fmt, cb in K.CODEBOOKS.items():
        edges = [(name, bits, cap, 1024) for name, bits, cap
                 in K.kernel_cases(fmt, seed=1)] + K.fused_cases(fmt, seed=1)
        for chunk in (1024, 768):
            big = 1 << 40
            warps = E.FUSED_WARPS * max(grid(fmt, big, chunk, device) for grid
                                        in (E.fused_grid, D.fused_grid,
                                            D.dense_grid))
            passes[f"{fmt}/{chunk}"] = warps
            edges.append((f"grid_pass_{chunk}", K.many_rows(fmt, warps + 37, 5, chunk),
                          64, chunk))
        for name, bits, cap, chunk in edges:
            errs = K.check_case(_bits_tensor(torch, bits, device), cb, cap, chunk)
            if max(errs.values()) != 0:
                raise AssertionError(f"{fmt}/{name}: kernel != plain {errs}")
            n_cases += 1
        streams = tuple(t.to(device) for t in K.repeated_slot_case(fmt))
        if K.check_decode_case(streams, cb) != 0:
            raise AssertionError(f"{fmt}/repeated slot: decode_fused != plain")
        n_cases += 1
    # 8-entry exponent tables (fp8 e4m3's recommended k, e5m2's 3-bit
    # variant), the same edges
    n_k8 = 0
    for fmt, cb in K.CODEBOOKS_K8.items():
        edges = [(name, bits, cap, 1024) for name, bits, cap
                 in K.kernel_cases(fmt, seed=3, cb=cb)] + K.fused_cases(fmt, seed=3, cb=cb)
        for name, bits, cap, chunk in edges:
            errs = K.check_case(_bits_tensor(torch, bits, device), cb, cap, chunk)
            if max(errs.values()) != 0:
                raise AssertionError(f"{fmt}/k8/{name}: kernel != plain {errs}")
            n_k8 += 1
    torch.cuda.synchronize()

    # main-path shape: one smollm KV leaf (L, B, S, Hkv, hd), synthetic bf16,
    # and the same leaf with about two escapes a row
    shape = (cfg.num_layers, BATCH, PROMPT + 1 + NEW_TOKENS, cfg.num_kv_heads,
             cfg.head_dim)
    if shape != K.MAIN_LEAF_SHAPE:
        raise AssertionError(f"main-path leaf {shape} != {K.MAIN_LEAF_SHAPE}")
    x, cb = K.codec_leaf(device, shape)
    exps, chunk, cap = tuple(cb.exponents), 1024, 64
    rows, n = x.shape[0], x.numel()

    def fused_runs(bits):
        enc = E.encode_fused(bits, exps, "bf16", chunk, cap)
        sm, packed, pos, val, cnt = enc
        cnt = torch.clamp(cnt, max=cap)
        applied = int(cnt.sum())          # escape slots decode_fused reads
        return applied, {
            "encode_fused": (lambda: E.encode_fused(bits, exps, "bf16", chunk, cap),
                             lambda: E.encode_fused_plain(bits, exps, "bf16", chunk, cap),
                             2 * n + n + n // 2 + 3 * rows * cap + 4 * rows, 16 * n),
            "decode_fused": (lambda: D.decode_fused(packed, sm, pos, val, cnt, exps, "bf16", chunk),
                             lambda: D.decode_fused_plain(packed, sm, pos, val, cnt, exps, "bf16", chunk),
                             n // 2 + n + 3 * applied + 4 * rows + 2 * n, 12 * n)}

    def held(name, kernel, plain, label):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = K.max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain at the {label} shape")
        return err

    applied, runs = fused_runs(x)
    dense = E.encode_dense(x, exps, "bf16", chunk)
    runs.update({
        "encode_dense": (lambda: E.encode_dense(x, exps, "bf16", chunk),
                         lambda: E.encode_dense_plain(x, exps, "bf16", chunk),
                         2 * n + n + n // 2 + n, 12 * n),
        "decode_dense": (lambda: D.decode_dense(dense[1], dense[0], exps, "bf16", chunk),
                         lambda: D.decode_dense_plain(dense[1], dense[0], exps, "bf16", chunk),
                         n // 2 + n + 2 * n, 10 * n),
    })
    records = {}
    for name, (kernel, plain, nbytes, ops) in runs.items():
        err = held(name, kernel, plain, "main-path")
        b_ms, b_by = bound_ms(nbytes, ops)
        ms = graph_ms(kernel, reps=20)
        records[name] = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=None, max_abs_err=err,
            bitwise_equal=True, ms=ms, kernel_ms=ms,
            eager_ms=cuda_ms(kernel, reps=20),
            plain_ms=cuda_ms(plain, reps=3, warmup=1), bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            library="none: no single PyTorch call computes it",
            bytes=nbytes, ops=ops, shape=[rows, chunk])
    # the persistent grids, and codec throughput in raw (bf16) bytes, the
    # paper's measure
    raw_bytes = 2 * n
    for name, grid in (("encode_fused", E.fused_grid), ("decode_fused", D.fused_grid),
                       ("decode_dense", D.dense_grid)):
        records[name].update(
            grid=[grid("bf16", rows, chunk, device), E.FUSED_WARPS],
            raw_bytes=raw_bytes, raw_gb_per_s=raw_bytes / records[name]["ms"] / 1e6)
    for name in ("encode_fused", "decode_fused"):
        records[name].update(escapes_applied=applied, escapes_per_row=applied / rows)
    del dense, runs
    torch.cuda.empty_cache()
    capacity = capacity_decode_half(torch, x, cb, records["decode_dense"]["ms"])

    heavy_bits = K.escape_heavy(x, cb)
    heavy_applied, heavy = fused_runs(heavy_bits)
    for name, (kernel, plain, nbytes, ops) in heavy.items():
        err = held(name, kernel, plain, "escape-heavy")
        b_ms, b_by = bound_ms(nbytes, ops)
        ms = graph_ms(kernel, reps=20)
        records[name]["escape_heavy"] = dict(
            ms=ms, eager_ms=cuda_ms(kernel, reps=20), bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, max_abs_err=err,
            escapes_applied=heavy_applied, escapes_per_row=heavy_applied / rows,
            raw_gb_per_s=raw_bytes / ms / 1e6)
    del x, heavy_bits, heavy
    torch.cuda.empty_cache()
    emit(phase="kernels", edge_cases=n_cases, k8_edge_cases=n_k8,
         formats=list(K.CODEBOOKS),
         grid_pass_warps=passes,
         timed={k: {f: v[f] for f in ("ms", "eager_ms", "plain_ms", "bound_ms", "bytes")}
                for k, v in records.items()},
         escape_heavy={k: records[k]["escape_heavy"] for k in ("encode_fused", "decode_fused")},
         capacity_decode_half=capacity)
    return records


def capacity_decode_half(torch, x, cb, dense_ms):
    """The capacity retry's whole decode half at the main-path leaf ``x``
    (container bits) encoded as its ``layout='global'`` retry encodes it
    (``twostage.encode``): ``twostage.decode_to_bits``, the path
    ``CudaBackend.for_retry("global")`` takes, and ``ops.decode_bits``, the
    fused backend's global decode.  Each must give back ``x`` bit for bit;
    each is timed eagerly (CUDA events) and by its device time under
    ``torch.profiler`` (its nonzero reads sync, so no CUDA graph takes it),
    with the dense kernel's share of both (``dense_ms`` is its graph time)."""
    from repro_torch.core import codec as C
    from repro_torch.kernels import ops, twostage
    from repro_torch.kernels.timing import cuda_ms
    ct = twostage.encode(C.from_bits(x, torch.bfloat16), cb, layout="global")
    if not bool(ct.ok):
        raise AssertionError("global layout overflowed at the main-path leaf")
    out = {"escapes": int(ct.esc_count.sum()), "cap": ct.cap}
    for name, fn in (("twostage.decode_to_bits", lambda: twostage.decode_to_bits(ct)),
                     ("ops.decode_bits", lambda: ops.decode_bits(ct))):
        if not C.bits_equal(fn(), x.reshape(-1)):
            raise AssertionError(f"{name}: the global decode != the sent bits")
        eager = cuda_ms(fn, reps=5)
        _, device, _ = profiled(torch, fn, reps=3)
        dev_ms = sum(ms for ms, _, _ in device)
        dense_dev = sum(ms for ms, _, k in device if "decode_kernel" in k)
        out[name] = dict(
            eager_ms=eager, device_ms=dev_ms, dense_device_ms=dense_dev,
            dense_share_of_device=dense_dev / dev_ms,
            dense_share_of_eager=dense_ms / eager,
            device=[dict(name=k, ms=ms, calls=c) for ms, c, k in device[:6]])
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, cfg, device):
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=1)
    prompt = serve.make_prompt(cfg, BATCH, PROMPT, device=device, seed=2)

    def same_cache(a, b):
        return all(C.bits_equal(x, y) for x, y in zip(TR.leaves(a), TR.leaves(b)))

    def codec_seconds(eng, cache):
        """The transfer once more through a session of the engine's plan,
        its encode (``send``) and decode (``recv``) halves timed apart."""
        sess = eng.plan.session()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.send(cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = sess.recv()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not same_cache(out, cache):
            raise AssertionError("send/recv: delivered cache != prefill cache")
        return {"encode": t1 - t0, "decode": t2 - t1}

    def codec_profile(eng, cache):
        """One more send and recv under ``torch.profiler``: each half's host
        clock (profiled) beside the device time of the kernels and copies it
        ran, and its host operations by their own host time, largest
        first."""
        sess = eng.plan.session()
        out = {}
        for half, call in (("encode", lambda: sess.send(cache)),
                           ("decode", sess.recv)):
            wall, dev, host = profiled(torch, call)
            out[half] = dict(wall_ms=wall,
                             device_ms=sum(ms for ms, _, _ in dev),
                             device=[dict(name=k, ms=ms, calls=c)
                                     for ms, c, k in dev[:8]],
                             host=[dict(name=k, self_ms=ms, calls=c)
                                   for ms, c, k in host[:8]])
        return out

    results, tokens, launches = {}, {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res, launches[label] = counted(serve.serve_once, eng, prompt, NEW_TOKENS)
        if not same_cache(res.delivered.cache, res.prefill.state.cache):
            raise AssertionError(f"{label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        seconds = dict(res.seconds)
        if eng.plan is not None:
            seconds.update(codec_seconds(eng, res.prefill.state.cache))
        results[label] = dict(
            seconds=seconds,
            transfer_ratio=eng.stats.transfer_ratio,
            raw_bytes=eng.stats.raw_cache_bytes, wire_bytes=eng.stats.wire_bytes,
            codec_ok=eng.stats.codec_ok, plan=eng.describe_plan())
        if label == "cuda_n1":
            first = res
            results[label].update(
                escapes=served_escapes(eng, res.prefill.state.cache),
                codec_profile=codec_profile(eng, res.prefill.state.cache))
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"tokens differ: {label} vs cuda_n1")
    if not bool(torch.isfinite(first.prefill.last_logits.float()).all()):
        raise AssertionError("non-finite prefill logits")
    n_elems = sum(x.numel() for x in TR.leaves(first.prefill.state.cache))
    emit(phase="main", arch=cfg.name, batch=BATCH, prompt=PROMPT,
         new_tokens=NEW_TOKENS, cache_elements=n_elems,
         codebook=list(cb.exponents), runs=results,
         tokens_equal=True, delivered_bitwise=True)
    return cb, first, params, prompt, launches, results


def served_escapes(eng, cache):
    """Escapes per chunk row of the streams the served path sends (leaves
    that ship raw after the capacity schedule have no streams)."""
    comp, _ = eng.plan.session().transfer_compressed(cache)
    rows = sum(ct.n_padded // ct.chunk for ct in comp.values())
    escapes = sum(int(ct.esc_count.sum()) for ct in comp.values())
    return dict(escapes=escapes, rows=rows,
                escapes_per_row=escapes / rows if rows else None,
                encoded_leaves=sorted(comp))


def escape_chunk_state(torch, cb, first, device):
    """The served prefill cache with its first chunk of ``k`` made of
    nothing but escapes (1024 of them, past every per-chunk capacity)."""
    from repro_torch.core import codec as C
    from repro_torch.core.codebook import FORMATS
    from repro_torch.models.kvcache import DecodeState

    cache = {k: v.clone() for k, v in first.prefill.state.cache.items()}
    esc_e = next(e for e in range(256) if e not in cb.exponents)
    mbits = FORMATS["bf16"]["mbits"]
    chunk_bits = (torch.arange(1024, device=device, dtype=torch.int32) % 128) \
        | (esc_e << mbits)
    flat = C.signed_view(cache["k"].view(torch.uint16)).reshape(-1)
    flat[:1024] = chunk_bits.to(torch.int16)
    return DecodeState(cache=cache, cache_len=first.prefill.state.cache_len)


def phase_capacity(torch, cfg, cb, first, device):
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.serving.engine import DisaggregatedEngine

    state = escape_chunk_state(torch, cb, first, device)
    cache = state.cache
    eng = DisaggregatedEngine(cfg, None, cb, backend="cuda", device=device)
    out, launches = counted(eng.transfer, state)
    torch.cuda.synchronize()
    if not all(C.bits_equal(x, y) for x, y in zip(TR.leaves(out.cache),
                                                 TR.leaves(cache))):
        raise AssertionError("capacity schedule: delivered cache != sent cache")
    steps = eng.stats.chunk_retry_steps
    if steps != 3 or not eng.stats.codec_ok:
        raise AssertionError(f"capacity schedule walked {steps} steps "
                             "(expected cap -> 2cap -> 4cap -> global = 3)")
    emit(phase="capacity", retry_steps=steps, transfer_ratio=eng.stats.transfer_ratio,
         delivered_bitwise=True)
    return launches


# ---------------------------------------------------------------------------
# phases profile, verified and wire: the transfer plane
# ---------------------------------------------------------------------------

LINK_GBPS = 100.0                 # the launcher's default simulated PD link


def host_ms(torch, fn, reps: int):
    """Host-clock ms of each of ``reps`` calls of ``fn`` (after one warm-up),
    each ended by a device synchronize, and the last call's result."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def need_launches(path, counts, names):
    missing = [k for k in names if not counts[k]]
    if missing:
        raise AssertionError(f"path {path}: kernels never launched: {missing}")


def phase_profile(torch, records, served, smi, device):
    """``CalibratedProfile.measure`` on the ``cuda`` backend at the main-path
    leaf's shape, on the ``torch`` backend at a smaller one; saved under
    ``build/`` and resolved back; the served smollm transfer priced under
    the measured profile and the paper's."""
    from repro_torch.core import profile as PR
    from repro_torch.serving.transfer import transfer_report

    rows = served["leaf_rows"]
    cal, launches = counted(lambda: PR.CalibratedProfile.measure(
        backend="cuda", shapes=((rows, 1024),), repeats=5, warmup=1,
        device=device))
    need_launches("profile", launches, ("encode_fused", "decode_fused"))
    cal_torch = PR.CalibratedProfile.measure(
        backend="torch", shapes=((1 << 22,),), repeats=3, warmup=1,
        device=device)
    path = ROOT / "build" / "chip_smoke_profiles.json"
    PR.save_profiles([cal, cal_torch], str(path))
    link_bw = LINK_GBPS * 1e9 / 8
    measured = PR.resolve_profile(str(path), link_bw=link_bw, backend="cuda")
    if measured != cal.profile(link_bw) or \
            PR.load_profiles(str(path)) != {cal.key: cal, cal_torch.key: cal_torch}:
        raise AssertionError("the saved profile does not resolve back equal")
    reports = {}
    for name, prof in (("measured", measured),
                       ("paper", PR.resolve_profile("paper", link_bw=link_bw))):
        rep = transfer_report(served["raw_bytes"], served["wire_bytes"], prof)
        reports[name] = dict(source=prof.source, t_native_ms=rep.t_native * 1e3,
                             t_splitzip_ms=rep.t_splitzip * 1e3,
                             t_encode_ms=rep.t_encode * 1e3,
                             t_transfer_ms=rep.t_transfer * 1e3,
                             t_decode_ms=rep.t_decode * 1e3,
                             speedup=rep.speedup, ratio=rep.ratio)

    def gbps(c):
        return dict(g_enc_GBps=c.g_enc / 1e9, g_dec_GBps=c.g_dec / 1e9,
                    ratio=c.ratio, workload_elems=c.workload_elems,
                    repeats=c.repeats, source=c.source)
    emit(phase="profile", nvidia_smi=smi, cuda=gbps(cal), torch=gbps(cal_torch),
         kernel_device_raw_GBps={k: records[k]["raw_gb_per_s"]
                                 for k in ("encode_fused", "decode_fused")},
         saved=str(path.relative_to(ROOT)), resolves_equal=True,
         link_gbps=LINK_GBPS, transfer_report=reports, launches=launches)
    return launches, cal


def phase_verified(torch, cfg, params, cb, prompt, first, main_runs, device):
    """Verified delivery under a seeded fault plan at n_chunks 1 and 8 (each
    executor meets a corruption and a drop; n_chunks 8 also seeded rates):
    bitwise delivery, the fault-free tokens, every fault re-fetched, encode
    launches as fault-free.  Then an unverified run whose corrupted entry
    arrives corrupted, a failover re-send, and the verified transfer's
    overhead against the plain one on the same plan."""
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.core.backend import get_backend
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DisaggregatedEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.plan import TransferConfig, TransferPlan

    def differing(a, b):
        return sum(int((C.signed_view(x.view(torch.uint16))
                        != C.signed_view(y.view(torch.uint16))).sum())
                   for x, y in zip(TR.leaves(a), TR.leaves(b)))

    plans = {1: FaultPlan(seed=18, corrupt_chunks=(0,), drop_chunks=(1,)),
             8: FaultPlan(seed=18, corrupt_chunks=(2,), drop_chunks=(5,),
                          corrupt_p=0.25, drop_p=0.1)}
    fault_free = {1: main_runs["cuda_n1"], 8: main_runs["cuda_n8"]}
    runs, windows = {}, {}
    for n, faults in plans.items():
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", n_chunks=n,
                                  verify=True, faults=faults, device=device)
        res, launches = counted(serve.serve_once, eng, prompt, NEW_TOKENS)
        st = eng.stats
        if differing(res.delivered.cache, res.prefill.state.cache):
            raise AssertionError(f"verified n_chunks {n}: delivered != prefill")
        if not torch.equal(res.tokens, first.tokens):
            raise AssertionError(f"verified n_chunks {n}: tokens != fault-free")
        if not (st.faults_injected == st.verify_failures == st.refetches >= 2):
            raise AssertionError(
                f"verified n_chunks {n}: injected {st.faults_injected}, "
                f"failures {st.verify_failures}, re-fetches {st.refetches}")
        for k in ("encode_fused", "encode_dense"):
            if launches[k] != fault_free[n][k]:
                raise AssertionError(f"verified n_chunks {n}: {k} launched "
                                     f"{launches[k]}, fault-free {fault_free[n][k]}")
        need_launches(f"verified_n{n}", launches, ("encode_fused", "decode_fused"))
        windows[f"verified_n{n}"] = launches
        runs[f"n_chunks_{n}"] = dict(
            faults=faults.describe(), faults_injected=st.faults_injected,
            verify_failures=st.verify_failures, refetches=st.refetches,
            raw_refetches=st.raw_refetches, wire_bytes=st.wire_bytes,
            transfer_ratio=st.transfer_ratio, seconds=res.seconds,
            launches={k: launches[k] for k in ("encode_fused", "decode_fused",
                                               "encode_dense", "decode_dense")})

    state = first.prefill.state
    loose = DisaggregatedEngine(cfg, None, cb, backend="cuda", device=device,
                                faults=FaultPlan(corrupt_chunks=(0,)))
    bad = differing(loose.transfer(state).cache, state.cache)
    if not bad or loose.stats.verify_failures:
        raise AssertionError("unverified: the corrupted entry was not delivered")

    fo = DisaggregatedEngine(cfg, None, cb, backend="cuda", device=device,
                             retain_for_failover=True)
    fo.transfer(state)
    wire_first = fo._session.last_stats.wire_bytes
    again, resend_launches = counted(fo.resend_cache, state)
    if differing(again.cache, state.cache) or \
            fo._session.last_stats.wire_bytes != wire_first:
        raise AssertionError("failover re-send: cache or wire bytes differ")
    if resend_launches["encode_fused"] or resend_launches["encode_dense"]:
        raise AssertionError("failover re-send encoded again")

    overhead = {}
    for n in (1, 8):
        plan = TransferPlan.build(state.cache, TransferConfig(
            codebook=cb, backend="cuda", n_chunks=n))
        plain, ver = plan.session(), plan.session(verify=True)
        t_plain, t_ver = [], []
        for order in ((plain, t_plain), (ver, t_ver), (ver, t_ver),
                      (plain, t_plain)) * 2:
            sess, out = order
            out.extend(host_ms(torch, lambda: sess.transfer(state.cache), 1)[0])
        overhead[f"n_chunks_{n}"] = dict(
            plain_ms=t_plain, verified_ms=t_ver,
            plain_mean_ms=sum(t_plain) / len(t_plain),
            verified_mean_ms=sum(t_ver) / len(t_ver))
    ct = get_backend("cuda").encode(state.cache["k"], cb)
    stream_bytes = sum(t.numel() * t.element_size() for t in ct.tensors())
    tag_ms, _ = host_ms(torch, lambda: get_backend("cuda").checksum(ct), 5)
    emit(phase="verified", arch=cfg.name, batch=BATCH, prompt=PROMPT, runs=runs,
         delivered_bitwise=True, tokens_equal_fault_free=True,
         unverified_corrupted_elements=bad, failover_resend_bitwise=True,
         failover_resend_launches=resend_launches,
         verify_overhead=overhead,
         checksum_one_leaf=dict(stream_bytes=stream_bytes, host_ms=tag_ms,
                                GBps=stream_bytes / min(tag_ms) / 1e6))
    return windows


def phase_wire(torch, cfg, cb, first, smi, device):
    """The served cache through the ``wire`` and ``wire-verify`` backends
    (bitwise round trip, each payload's size against ``payload_bytes_model``,
    encode and decode timed on the host clock), a flipped byte caught in its
    frame, and the all-escape chunk through the global re-encode."""
    from repro_torch.core import backend as B
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.core import wire as W
    from repro_torch.serving.engine import DisaggregatedEngine

    state = first.prefill.state
    windows, engines = {}, {}
    for name in ("wire", "wire-verify"):
        eng = DisaggregatedEngine(cfg, None, cb, backend=name, device=device)
        out, launches = counted(eng.transfer, state)
        if not all(C.bits_equal(x, y) for x, y in zip(TR.leaves(out.cache),
                                                     TR.leaves(state.cache))):
            raise AssertionError(f"{name}: delivered cache != sent cache")
        need_launches(name, launches, ("encode_fused", "decode_fused"))
        windows[name] = launches
        engines[name] = dict(transfer_ratio=eng.stats.transfer_ratio,
                             wire_bytes=eng.stats.wire_bytes)

    be = B.get_backend("wire-verify")
    leaves = {}
    for key, leaf in state.cache.items():
        enc_ms, wc = host_ms(torch, lambda: be.encode(leaf, cb), 3)
        dec_ms, back = host_ms(torch, lambda: be.decode(wc), 3)
        model = W.payload_bytes_model(leaf.numel(), wc.stats.n_escapes, "bf16",
                                      cb.k, W.DEFAULT_CHUNK)
        if len(wc.payload) != model or not C.bits_equal(back, leaf):
            raise AssertionError(f"wire {key}: payload {len(wc.payload)} vs "
                                 f"model {model}, or the round trip differs")
        leaves[key] = dict(payload_bytes=len(wc.payload), model_bytes=model,
                           escapes=wc.stats.n_escapes, ratio=wc.stats.ratio,
                           raw_bytes=wc.stats.raw_bytes, encode_ms=enc_ms,
                           decode_ms=dec_ms,
                           encode_raw_GBps=wc.stats.raw_bytes / min(enc_ms) / 1e6,
                           decode_raw_GBps=wc.stats.raw_bytes / min(dec_ms) / 1e6)
    # where a wire encode's and decode's host time goes: one traced call each
    trace = {}
    for half, call in (("encode", lambda: be.encode(leaf, cb)),
                       ("decode", lambda: be.decode(wc))):
        wall, dev, host = profiled(torch, call)
        trace[half] = dict(wall_ms=wall, device_ms=sum(ms for ms, _, _ in dev),
                           host_ops_self_ms=sum(ms for ms, _, _ in host),
                           device=[dict(name=k, ms=ms, calls=c)
                                   for ms, c, k in dev[:6]],
                           host=[dict(name=k, self_ms=ms, calls=c)
                                 for ms, c, k in host[:8]])
    lay = W._parse(wc.payload)
    frame = min(3, lay.n_frames - 1)
    bad = bytearray(wc.payload)
    bad[lay.body_off + frame * W.FRAME_BYTES + 5] ^= 0x04
    try:
        be.decode(B.WireCompressed(payload=bytes(bad), shape=wc.shape,
                                   dtype=wc.dtype, fmt=wc.fmt, stats=wc.stats,
                                   device=wc.device))
    except W.WireIntegrityError as err:
        if err.frames != (frame,):
            raise AssertionError(f"flipped byte in frame {frame}, error names "
                                 f"{err.frames}")
    else:
        raise AssertionError("wire-verify decoded a corrupted payload")

    esc = escape_chunk_state(torch, cb, first, device)
    eng = DisaggregatedEngine(cfg, None, cb, backend="wire", device=device)
    out, launches = counted(eng.transfer, esc)
    if not all(C.bits_equal(x, y) for x, y in zip(TR.leaves(out.cache),
                                                 TR.leaves(esc.cache))):
        raise AssertionError("wire, all-escape chunk: delivered != sent")
    need_launches("wire_escapes", launches, ("encode_dense", "decode_dense"))
    windows["wire_escapes"] = launches
    emit(phase="wire", nvidia_smi=smi, engines=engines, leaves=leaves,
         trace=trace, round_trip_bitwise=True, flipped_byte_frame=frame,
         integrity_error_frames=[frame], n_frames=lay.n_frames,
         escape_chunk_transfer_ratio=eng.stats.transfer_ratio,
         launches=windows)
    return windows


# ---------------------------------------------------------------------------
# phase fleet: prefix delta, scheduler-driven failover, the fleet simulation
# ---------------------------------------------------------------------------

FLEET_PROMPT, FLEET_FRESH = 2048, 256   # turn 1's prompt; turn 2 appends
FLEET_CHUNKS = 480                      # a segment: 1/8 of a leaf-layer slab
FLEET_ALTERED = 3                       # the last k segments altered
FLEET_LINK_GBPS = 400.0                 # 400GbE, 50 GB/s: the fleet's base
FLEET_ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b")


def predicted_hit_share(plan, cfg, max_seq: int) -> float:
    """The share of turn 2's raw bytes that can hit when only its fresh
    tokens' K/V differ from turn 1's: segments of the folded stream that
    overlap no changed span of any (L, B=1, S, Hkv, hd) slab."""
    per_tok = cfg.num_kv_heads * cfg.head_dim
    slab = max_seq * per_tok
    n_leaf = cfg.num_layers * slab
    changed = [(leaf * n_leaf + layer * slab + FLEET_PROMPT * per_tok,
                leaf * n_leaf + layer * slab + (FLEET_PROMPT + FLEET_FRESH) * per_tok)
               for leaf in range(2) for layer in range(cfg.num_layers)]
    hit = sum(s.raw_bytes for s in plan.segments
              if not any(a < s.stop and s.start < b for a, b in changed))
    return hit / (2.0 * plan.stream_len)


def fleet_delta(torch, cfg, params, cb, device):
    """Part (a): prefix-delta transfer at full width, batch 1, n_chunks 480,
    through ``DisaggregatedEngine(..., prefix_cache_bytes=...)``."""
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.kernels.timing import cuda_ms
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DisaggregatedEngine

    def same(a, b):
        return all(C.bits_equal(x, y) for x, y in zip(TR.leaves(a), TR.leaves(b)))

    max_seq = FLEET_PROMPT + FLEET_FRESH + 1 + NEW_TOKENS
    p2 = serve.make_prompt(cfg, 1, FLEET_PROMPT + FLEET_FRESH, device=device, seed=30)
    p1 = {"tokens": p2["tokens"][:, :FLEET_PROMPT].contiguous()}
    kw = dict(backend="cuda", n_chunks=FLEET_CHUNKS, device=device)
    full = DisaggregatedEngine(cfg, params, cb, **kw)
    eng = DisaggregatedEngine(cfg, params, cb, prefix_cache_bytes=float(8 << 30), **kw)
    pre1 = eng.prefill(p1, max_seq=max_seq)
    pre2 = eng.prefill(p2, max_seq=max_seq)
    s1, s2 = pre1.state, pre2.state
    raw = sum(x.numel() * x.element_size() for x in TR.leaves(s1.cache))

    # cold: a full transfer's delivery and wire bytes
    want, full_launches = counted(full.transfer, s1)
    got, cold_launches = counted(eng.transfer, s1, 0)
    sess = eng._session
    plan = sess.plan
    cold = sess.last_stats
    if not (same(got.cache, want.cache) and same(got.cache, s1.cache)):
        raise AssertionError("fleet delta, cold: delivery != full transfer")
    if cold.wire_bytes != full._session.last_stats.wire_bytes or cold.prefix_hit_bytes:
        raise AssertionError("fleet delta, cold: wire bytes != full transfer's")
    if any(cold_launches[k] != full_launches[k] for k in ("encode_fused", "decode_fused")):
        raise AssertionError("fleet delta, cold: launches != full transfer's")

    # the same cache again: nothing crosses the wire, no codec launch
    got, same_launches = counted(eng.transfer, s1, 0)
    st = sess.last_stats
    codec = ("encode_fused", "decode_fused", "encode_dense", "decode_dense")
    if st.wire_bytes != 0.0 or st.prefix_hit_bytes != raw or \
            any(same_launches[k] for k in codec) or not same(got.cache, s1.cache):
        raise AssertionError(f"fleet delta, unchanged: wire {st.wire_bytes}, "
                             f"hit {st.prefix_hit_bytes} of {raw}, {same_launches}")

    # another session id: isolated, a full transfer
    got, _ = counted(eng.transfer, s1, 1)
    st = sess.last_stats
    if st.prefix_hit_bytes or st.wire_bytes != cold.wire_bytes or not same(got.cache, s1.cache):
        raise AssertionError("fleet delta: session 1 hit session 0's prefix")

    # the last k segments altered (a low mantissa bit flipped in each): those
    # k ship, bitwise, one encode_fused and one decode_fused each
    alt = {k: v.clone() for k, v in s1.cache.items()}
    n_k = alt["k"].numel()
    flat_v = C.signed_view(alt["v"].view(torch.uint16)).reshape(-1)
    altered = list(range(plan.n_chunks - FLEET_ALTERED, plan.n_chunks))
    for i in altered:
        seg = plan.segments[i]
        j = (seg.start + seg.stop) // 2 - n_k
        flat_v[j] = flat_v[j] ^ 1
    alt_state = type(s1)(cache=alt, cache_len=s1.cache_len)
    got, alt_launches = counted(eng.transfer, alt_state, 0)
    st = sess.last_stats
    shipped = [i for i, w in enumerate(st.chunk_wire_bytes) if w > 0]
    if shipped != altered or not same(got.cache, alt) or \
            alt_launches["encode_fused"] != FLEET_ALTERED or \
            alt_launches["decode_fused"] != FLEET_ALTERED:
        raise AssertionError(f"fleet delta, {FLEET_ALTERED} altered: shipped "
                             f"{shipped}, launches {alt_launches}")

    # the real turn 2 on a fresh session id: turn 1 cold, then the delta
    eng.transfer(s1, 2)
    d2, turn2_launches = counted(eng.transfer, s2, 2)
    st2 = sess.last_stats
    f2 = full.transfer(s2)
    if not (same(d2.cache, f2.cache) and same(d2.cache, s2.cache)):
        raise AssertionError("fleet delta, turn 2: delivery != full transfer")
    need_launches("fleet_delta", turn2_launches, ("encode_fused", "decode_fused"))
    toks_delta = eng.decode(pre2.first_token, d2, NEW_TOKENS)
    toks_full = full.decode(pre2.first_token, f2, NEW_TOKENS)
    if not torch.equal(toks_delta, toks_full):
        raise AssertionError("fleet delta: tokens after delta != after full transfer")
    prefix_equal = {k: C.bits_equal(s1.cache[k][:, :, :FLEET_PROMPT].contiguous(),
                                    s2.cache[k][:, :, :FLEET_PROMPT].contiguous())
                    for k in s1.cache}

    # host ms in turns: full, delta, delta, full (each delta's session primed
    # with turn 1 first, untimed, and dropped after), and the comparison
    # pass's device ms
    t_full, t_delta = [], []
    for rep in range(3):
        for kind in ("full", "delta", "delta", "full"):
            if kind == "full":
                t_full.extend(host_ms(torch, lambda: full.transfer(s2), 1)[0][-1:])
            else:
                sid = 100 + len(t_delta)
                eng.transfer(s1, sid)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.transfer(s2, sid)
                torch.cuda.synchronize()
                t_delta.append((time.perf_counter() - t0) * 1e3)
                sess._prefix_index.drop(sid)
    eng.transfer(s1, 99)
    entry = sess._prefix_index.get(99)
    stream, lo, fp8, raw_side = plan.fold_stream(s2.cache)
    sides = sess._delta_sides(lo, fp8, raw_side)
    cmp_ms = cuda_ms(lambda: sess.shadow_hits(stream, sides, entry), reps=20)
    cmp_bytes = 2 * stream.numel() * 2 + 2 * stream.numel()   # two reads, bools
    out = dict(
        max_seq=max_seq, n_chunks=plan.n_chunks, segment_elems=plan.segments[0].n_elements,
        stream_bytes=2 * plan.stream_len, raw_bytes=raw,
        cold=dict(wire_bytes=cold.wire_bytes, launches=cold_launches),
        unchanged=dict(wire_bytes=0.0, prefix_hit_bytes=raw, launches=same_launches),
        altered=dict(k=FLEET_ALTERED, shipped=shipped, launches=alt_launches),
        turn2=dict(hit_share=st2.prefix_hit_bytes / raw,
                   predicted_hit_share=predicted_hit_share(plan, cfg, max_seq),
                   segments_shipped=sum(w > 0 for w in st2.chunk_wire_bytes),
                   wire_bytes=st2.wire_bytes, full_wire_bytes=full._session.last_stats.wire_bytes,
                   prefix_hit_bytes=st2.prefix_hit_bytes, launches=turn2_launches,
                   prefill_prefix_bitwise=prefix_equal),
        tokens_equal=True, delivered_bitwise=True, sessions_isolated=True,
        host_ms=dict(full=t_full, delta=t_delta,
                     full_median=statistics.median(t_full),
                     delta_median=statistics.median(t_delta)),
        compare_pass=dict(device_ms=cmp_ms, bytes=cmp_bytes,
                          GBps=cmp_bytes / cmp_ms / 1e6,
                          bound_ms=cmp_bytes / H100_HBM_BYTES_PER_S * 1e3))
    return out, turn2_launches, s1


def fleet_resend(torch, cfg, cb, state, profile, device):
    """Part (b): a decode-worker kill in the event scheduler drives real
    re-sends through the engine's ``on_failover`` hook."""
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.kernels import splitzip_decode as D
    from repro_torch.kernels import splitzip_encode as E
    from repro_torch.serving.cluster import ClusterConfig, LinkSpec
    from repro_torch.serving.engine import DisaggregatedEngine
    from repro_torch.serving.faults import FaultPlan, WorkerKill
    from repro_torch.serving.scheduler import DisaggregatedScheduler, Request

    fo = DisaggregatedEngine(cfg, None, cb, backend="cuda", device=device,
                             retain_for_failover=True)
    baseline = fo.transfer(state)
    n_leaves = len(TR.leaves(state.cache))
    resent = []

    def on_failover(req):
        before = (E.encode_fused.launches + E.encode_dense.launches,
                  D.decode_fused.launches)
        out = fo.resend_cache(state)
        resent.append(dict(rid=req.rid, cache=out.cache,
                           encodes=E.encode_fused.launches + E.encode_dense.launches - before[0],
                           decodes=D.decode_fused.launches - before[1]))

    tokens = int(state.cache_len.max())
    kv_tok = fo.stats.raw_cache_bytes / (state.cache["k"].shape[1] * state.cache["k"].shape[2])
    sched = DisaggregatedScheduler(fo.scheduler_config(
        profile, kv_bytes_per_token=kv_tok, prefill_time_per_token=0.0,
        decode_time_per_step=1e-3, max_prefill_batch=4,
        cluster=ClusterConfig(n_prefill=1, n_decode=2, links=(LinkSpec(),),
                              router="transfer-aware"),
        faults=FaultPlan(seed=1, worker_kills=(WorkerKill(worker=0, at=5e-3),)),
        heartbeat_timeout_s=1e-3, on_failover=on_failover))
    for i in range(4):
        sched.submit(Request(rid=i, arrival=0.0, prompt_len=tokens, max_new_tokens=64))
    done, launches = counted(sched.run)
    if sched.failovers < 1 or not resent:
        raise AssertionError("fleet resend: the scheduler reported no failover")
    if fo.stats.failover_resends != len(resent):
        raise AssertionError("fleet resend: engine re-sends != hook calls")
    for r in resent:
        if not all(C.bits_equal(a, b) for a, b in zip(TR.leaves(r["cache"]),
                                                      TR.leaves(baseline.cache))):
            raise AssertionError(f"fleet resend: rid {r['rid']} != baseline delivery")
        if r["encodes"] or r["decodes"] != n_leaves:
            raise AssertionError(f"fleet resend: rid {r['rid']} launched "
                                 f"{r['encodes']} encodes, {r['decodes']} decodes")
    states = sorted({r.state for r in done})
    if len(done) != 4 or not set(states) <= {"completed", "shed", "failed-over"}:
        raise AssertionError(f"fleet resend: states {states}")
    return dict(failovers=sched.failovers, resends=len(resent),
                resent_rids=[r["rid"] for r in resent],
                per_resend_launches=dict(encode=0, decode_fused=n_leaves),
                states=states, resend_bitwise=True, kv_bytes_per_token=kv_tok), launches


def fleet_sim(profile, seconds, link_gbps):
    """Part (c): the Fig. 2 analogue on the port's scheduler, priced with
    this run's measured cuda profile against the native link, prefill and
    decode-step time from phase ``main``; bucket plans of each arch's cache
    structure from meta tensors."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.serving.cluster import ClusterConfig, LinkSpec
    from repro_torch.serving.policy import available_policies
    from repro_torch.serving.scheduler import (DisaggregatedScheduler,
                                               SchedulerConfig, summarize)
    from repro_torch.serving.traces import TraceConfig, generate_trace

    link = dataclasses.replace(profile, link_bw=link_gbps * 1e9 / 8)
    ptpt = seconds["prefill"] / PROMPT        # a batch costs its longest prompt
    step = seconds["decode_loop"] / NEW_TOKENS
    trace_cfg = TraceConfig(seed=0, n_requests=256, prompt_min=256,
                            prompt_max=16384, session_p=0.3)

    def run(arch, policy, compress):
        cluster = ClusterConfig(
            n_prefill=2, n_decode=4,
            links=(LinkSpec(policy=policy, bw_scale=1.0),
                   LinkSpec(policy=policy, bw_scale=0.25)),
            router="transfer-aware", prefix_cache_bytes=float(64 << 30))
        sched = DisaggregatedScheduler(SchedulerConfig(
            arch=get_config(arch), profile=link, compress=compress, n_chunks=8,
            prefill_time_per_token=ptpt, decode_time_per_step=step,
            cluster=cluster))
        reqs = generate_trace(trace_cfg)
        for r in reqs:
            sched.submit(r)
        done = sched.run()
        if len(done) != len(reqs) or any(
                r.state not in ("completed", "shed", "failed-over") for r in done):
            raise AssertionError(f"fleet {arch}/{policy}: requests not accounted")
        if abs(sched.link_busy_s - sum(sched.link_busy_by_link)) > \
                1e-9 * max(1.0, sched.link_busy_s):
            raise AssertionError(f"fleet {arch}/{policy}: link busy not conserved")
        return sched, summarize(done)

    out, t0 = {}, time.perf_counter()
    for arch in FLEET_ARCHS:
        for policy in available_policies():
            sz, s = run(arch, policy, True)
            nat, n = run(arch, policy, False)
            if run(arch, policy, True)[1] != s:
                raise AssertionError(f"fleet {arch}/{policy}: two runs differ")
            if not sz.link_busy_s < nat.link_busy_s:
                raise AssertionError(f"fleet {arch}/{policy}: SplitZip link busy "
                                     f"{sz.link_busy_s} >= native {nat.link_busy_s}")
            out[f"{arch}/{policy}"] = dict(
                splitzip=s, native=n,
                ttft_ratio=n["mean_ttft_s"] / s["mean_ttft_s"],
                p99_ttft_ratio=n["p99_ttft_s"] / s["p99_ttft_s"],
                tok_s_ratio=s["throughput_tok_s"] / n["throughput_tok_s"],
                req_s_ratio=s["throughput_req_s"] / n["throughput_req_s"],
                link_busy_s=dict(splitzip=sz.link_busy_s, native=nat.link_busy_s,
                                 ratio=sz.link_busy_s / nat.link_busy_s,
                                 by_link=sz.link_busy_by_link),
                prefix_hit_bytes=sz.prefix_hit_bytes,
                transfer_bytes=sz.transfer_bytes, sheds=sz.sheds,
                buckets=len(sz.plans))
    return dict(profile=dict(source=link.source, g_enc_GBps=link.g_enc / 1e9,
                             g_dec_GBps=link.g_dec / 1e9, ratio=link.ratio,
                             link_GBps=link.link_bw / 1e9),
                prefill_time_per_token=ptpt, decode_time_per_step=step,
                trace=dict(seed=trace_cfg.seed, n_requests=trace_cfg.n_requests,
                           prompt_min=trace_cfg.prompt_min,
                           prompt_max=trace_cfg.prompt_max,
                           session_p=trace_cfg.session_p),
                runs=out, seconds=time.perf_counter() - t0)


def phase_fleet(torch, cfg, params, cb, cal, seconds, smi, device):
    """Phase ``fleet``: (a) prefix delta at full width, (b) scheduler-driven
    failover re-sends on the card, (c) the fleet on the card's prices."""
    t0 = time.perf_counter()
    delta, delta_launches, state = fleet_delta(torch, cfg, params, cb, device)
    t1 = time.perf_counter()
    profile = cal.profile(FLEET_LINK_GBPS * 1e9 / 8)
    resend, resend_launches = fleet_resend(torch, cfg, cb, state, profile, device)
    t2 = time.perf_counter()
    sim = fleet_sim(profile, seconds, FLEET_LINK_GBPS)
    emit(phase="fleet", nvidia_smi=smi, delta=delta, resend=resend, fleet=sim,
         seconds=dict(delta=t1 - t0, resend=t2 - t1,
                      fleet=time.perf_counter() - t2))
    return {"fleet_delta": delta_launches, "fleet_resend": resend_launches}


# ---------------------------------------------------------------------------
# phase 5: the paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_KERNELS = {
    "paged_gqa_attention": ("src/repro_torch/kernels/csrc/splitzip_attention.cu",
                            "src/repro/kernels/splitzip_attention.py:212"),
    "paged_mla_attention": ("src/repro_torch/kernels/csrc/splitzip_attention.cu",
                            "src/repro/kernels/splitzip_attention.py:360"),
}
# the main paths' geometries are ``attention_cases.GQA_SERVED`` (smollm-135m,
# qwen3-moe-30b-a3b, pixtral-12b) and ``MLA_SERVED`` (minicpm3-4b at MLA_BATCH after
# MLA_PROMPT tokens)
GQA_EDGE = dict(batch=3, heads=4, hkv=2, hd=32, dv=128, tp=16, pages=4,
                lens=[64, 37, 9])           # dv != hd, own caps, an empty row
MLA_EDGE = dict(batch=3, heads=8, rank=128, rope=32, tp=32, pages=3,
                lens=[96, 50, 20])          # own caps, an empty row


def _page_bytes(streams):
    sm, _, pos, _, _ = streams
    pe = sm.shape[1] * sm.shape[2]
    return 1.5 * pe + 3 * pos.shape[1] + 4


def attention_work(case, kind):
    """(bytes, operations) the call must move and do: every full page's
    compressed streams and page-table entries read once, q read, the f32
    partials written; nq H Tp (score width + context width) multiply-adds a
    page, two operations each (the rate counts a fused multiply-add as
    two)."""
    tp = case["tokens_per_page"]
    if kind == "gqa":
        q = case["q"]
        b, nq, h, hd = q.shape
        s0, s1, table = case["k_streams"], case["v_streams"], case["page_table_k"]
        dv = s1[0].shape[1] * s1[0].shape[2] // tp // case["hkv"]
        width, out_w = hd + dv, dv
        q_bytes = q.numel() * 2
    else:
        ql, qr = case["q_lat"], case["q_rope"]
        b, nq, h, r = ql.shape
        s0, s1, table = case["ckv_streams"], case["krope_streams"], \
            case["page_table_ckv"]
        width, out_w = 2 * r + qr.shape[-1], r
        q_bytes = (ql.numel() + qr.numel()) * 2
    n = int((case["cache_len"] // tp).clamp(max=table.shape[1]).sum())
    nbytes = (n * (_page_bytes(s0) + _page_bytes(s1) + 8) + q_bytes
              + b * nq * h * (out_w + 2) * 4 + b * 4)
    return nbytes, n * 2 * nq * h * tp * width


def raw_sdpa_ms(torch, case, kind):
    """SDPA over the same prefix held RAW in bf16 (the decoded full pages):
    a yardstick of what attention over uncompressed KV costs here.  Not the
    same function (no page decode, normalized output) and never called by
    the port."""
    import torch.nn.functional as F
    from repro_torch.core import codec as C
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.kernels.timing import cuda_ms
    tp = case["tokens_per_page"]
    fmt, exps, chunk = case["fmt"], case["exponents"], case["chunk"]

    def prefix(streams, table):
        n = int((case["cache_len"] // tp).min())
        ids = table[:, :n].reshape(-1).long()
        sel = tuple(C.unsigned_view(C.signed_view(t)[ids]) if t.dtype == torch.uint16
                    else t[ids] for t in streams)
        bits = SA.decode_pages_plain(sel, exps, fmt, chunk)
        return SA.bits_to_float(bits, fmt).to(torch.bfloat16).reshape(
            table.shape[0], n * tp, -1)

    if kind == "gqa":
        q = case["q"]
        b, nq, h, hd = q.shape
        hkv = case["hkv"]
        k = prefix(case["k_streams"], case["page_table_k"]).reshape(b, -1, hkv, hd)
        v = prefix(case["v_streams"], case["page_table_v"]).reshape(b, -1, hkv, hd)
        k = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
        v = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1).contiguous()
        qq = q.transpose(1, 2).contiguous()
    else:
        ql, qr = case["q_lat"], case["q_rope"]
        b, nq, h, r = ql.shape
        c = prefix(case["ckv_streams"], case["page_table_ckv"])
        kr = prefix(case["krope_streams"], case["page_table_krope"])
        k = torch.cat([c, kr], dim=-1)[:, None].expand(b, h, -1, -1).contiguous()
        v = c[:, None].expand(b, h, -1, -1).contiguous()
        qq = torch.cat([ql, qr], dim=-1).transpose(1, 2).contiguous()
    scale = case["scale"]
    return cuda_ms(lambda: F.scaled_dot_product_attention(qq, k, v, scale=scale),
                   reps=20)


def phase_attention(torch, device):
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import cases as K
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.kernels.timing import cuda_ms, graph_ms

    # the shared page decoder, bitwise, every format
    n_dec = 0
    for name, fmt, exps, streams in AC.decode_cases(seed=3):
        dev = tuple(t.to(device) for t in streams)
        got = SA.decode_pages(dev, exps, fmt, 1024)
        torch.cuda.synchronize()
        if K.max_abs_err((got,), (SA.decode_pages_plain(dev, exps, fmt, 1024),)) != 0:
            raise AssertionError(f"decode_pages {name}: kernel != plain")
        n_dec += 1

    # edge inputs, every format, nq 1 and 4 (causal)
    n_edge, worst_edge = 0, 0.0
    for fmt in ("bf16", "fp8_e5m2", "fp8_e4m3"):
        for nq in (1, 4):
            for kind, make, kw, fn in (
                    ("gqa", AC.gqa_case, GQA_EDGE, SA.paged_gqa_attention),
                    ("mla", AC.mla_case, MLA_EDGE, SA.paged_mla_attention)):
                case = AC.to_device(make(fmt, 20 + nq, nq=nq, **kw), device)
                got = fn(**case)
                torch.cuda.synchronize()
                plain = SA.paged_gqa_attention_plain if kind == "gqa" \
                    else SA.paged_mla_attention_plain
                worst_edge = max(worst_edge, AC.check_partials(got, plain(**case)))
                n_edge += 1
        # the split edges of both kernels, at their own split count, one
        # split, and the wrapper's choice, against the unsplit plain version
        for edges, make, plain, launch, fn in (
                (AC.GQA_SPLIT_EDGE, AC.gqa_case, SA.paged_gqa_attention_plain,
                 SA.launch_paged_gqa, SA.paged_gqa_attention),
                (AC.MLA_SPLIT_EDGE, AC.mla_case, SA.paged_mla_attention_plain,
                 SA.launch_paged_mla, SA.paged_mla_attention)):
            for name, (kw, n_split) in edges.items():
                case = AC.to_device(make(fmt, 30, **kw), device)
                want = plain(**case)
                for got in (launch(**case, n_split=n_split),
                            launch(**case, n_split=1), fn(**case)):
                    torch.cuda.synchronize()
                    worst_edge = max(worst_edge, AC.check_partials(got, want))
                    n_edge += 1

    # the main paths' geometries: check, then time (device time with no
    # host gaps, ``ms``, and issued eagerly from Python, ``eager_ms``)
    records = {}
    for name, label, kind, make, kw, fn, plain in (
            ("paged_gqa_attention", ARCH, "gqa", AC.gqa_case,
             AC.GQA_SERVED[ARCH], SA.paged_gqa_attention,
             SA.paged_gqa_attention_plain),
            ("paged_gqa_attention", MOE_ARCH, "gqa", AC.gqa_case,
             AC.GQA_SERVED[MOE_ARCH], SA.paged_gqa_attention,
             SA.paged_gqa_attention_plain),
            ("paged_gqa_attention", VLM_ARCH, "gqa", AC.gqa_case,
             AC.GQA_SERVED[VLM_ARCH], SA.paged_gqa_attention,
             SA.paged_gqa_attention_plain),
            ("paged_mla_attention", MLA_ARCH, "mla", AC.mla_case,
             AC.MLA_SERVED[MLA_ARCH], SA.paged_mla_attention,
             SA.paged_mla_attention_plain)):
        case = AC.to_device(make("bf16", 7, **kw), device)
        k_streams = case["k_streams"] if kind == "gqa" else case["ckv_streams"]
        got_bits = SA.decode_pages(k_streams, case["exponents"], "bf16", 1024)
        if K.max_abs_err((got_bits,), (SA.decode_pages_plain(
                k_streams, case["exponents"], "bf16", 1024),)) != 0:
            raise AssertionError(f"{name}: page decode != plain at {label}'s geometry")
        err = AC.check_partials(fn(**case), plain(**case))
        nbytes, ops = attention_work(case, kind)
        # GQA's products run on the f32 ALUs, MLA's on the bf16 tensor cores
        rate = H100_F32_OPS_PER_S if kind == "gqa" else H100_BF16_OPS_PER_S
        b_ms, b_by = bound_ms(nbytes, ops, rate)
        ms = graph_ms(lambda: fn(**case), reps=20)
        rec = dict(
            name=name, route="cuda", source=ATTN_KERNELS[name][0],
            replaces=ATTN_KERNELS[name][1], launches=None, max_abs_err=err,
            tolerance=f"rtol {AC.PARTIALS_RTOL} (f32 sums in another order"
                      + ("; p as two bf16 terms)" if kind == "mla" else ")"),
            ms=ms, kernel_ms=ms, eager_ms=cuda_ms(lambda: fn(**case), reps=20),
            plain_ms=cuda_ms(lambda: plain(**case), reps=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library="none: no single PyTorch call decodes pages",
            raw_sdpa_ms=raw_sdpa_ms(torch, case, kind), bytes=nbytes, ops=ops,
            bound_rate_ops_per_s=rate, arch=label,
            geometry={k: v for k, v in kw.items() if k != "lens"},
            cache_len=kw["lens"][0])
        if kind == "mla":
            grid = SA.mla_grid(kw["batch"], kw["nq"], kw["heads"], kw["pages"],
                               torch.cuda.get_device_properties(0).multi_processor_count)
            rec.update(grid=grid, n_split=grid[2])
        rec["geometries"] = {label: {f: rec[f] for f in (
            "geometry", "cache_len", "ms", "eager_ms", "plain_ms", "bound_ms",
            "bound_by", "raw_sdpa_ms", "max_abs_err")}}
        if name in records:             # a further geometry of a kernel
            records[name]["geometries"].update(rec["geometries"])
        else:
            records[name] = rec
        del case
        torch.cuda.empty_cache()
    emit(phase="attention", decode_cases=n_dec, edge_cases=n_edge,
         edge_max_abs_err=worst_edge, decode_bitwise=True,
         timed={k: v["geometries"] for k, v in records.items()})
    return records


# ---------------------------------------------------------------------------
# prefill flash attention against its plain version
# ---------------------------------------------------------------------------

FLASH_KERNEL = ("src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:91")


def phase_flash(torch, device):
    """The kernel against ``flash_attention_ref`` on every seeded edge case,
    with each case's tolerance, and twice: the same bits on a second run."""
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import flash_attention as FA
    worst, path = {}, {}
    for c in AC.flash_cases(seed=1):
        q, k, v = AC.flash_operands(c, device)
        kw = dict(causal=c["causal"], window=c["window"])
        tc0 = FA.flash_attention.launches_tc
        got = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        path[c["name"]] = "tensor_core" if FA.flash_attention.launches_tc > tc0 \
            else "cuda_core"
        want = FA.flash_attention_ref(q, k, v, **kw)
        worst[c["name"]] = AC.check_close(got, want, *c["tol"])
        if not torch.equal(got, FA.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash {c['name']}: two runs differ")
        if c["window"] is not None and c["window"] >= k.shape[1] and not \
                torch.equal(got, FA.flash_attention(q, k, v, causal=c["causal"])):
            raise AssertionError(f"flash {c['name']}: a window >= Skv differs "
                                 "from no window")
        if path[c["name"]] != ("tensor_core" if FA.tensor_core_path(
                q.dtype, q.shape[-1], v.shape[-1]) else "cuda_core"):
            raise AssertionError(f"flash {c['name']}: took the {path[c['name']]} "
                                 "kernel against its dtype and widths")
    emit(phase="flash", edge_cases=len(worst), max_abs_err=worst, path=path,
         tolerances={k: list(v) for k, v in AC.FLASH_TOL.items()},
         deterministic=True)


def capture_flash(fn, *args):
    """``fn(*args)`` with the q/k/v of its first and last flash-attention
    call kept (the first and last attention layer of a prefill): the
    layers' handle on the kernel module is swapped for a recorder that
    calls the real wrapper, whose launch counter stays its own."""
    import types
    from repro_torch.models import layers as L
    kernels, seen = L.FA, []

    def keep(q, k, v, **kw):
        seen[1:] = [(q, k, v, kw)]
        return kernels.flash_attention(q, k, v, **kw)

    L.FA = types.SimpleNamespace(flash_attention=keep)
    try:
        out = fn(*args)
    finally:
        L.FA = kernels
    return out, (seen[0], seen[-1])


def flash_live(torch, layers, arch):
    """The kernel on a served prefill's live q/k/v (first and last layer)
    against its plain version (one bf16 ulp) and ``chunked_attention``
    (the JAX package's 3e-2), then timed on the first layer's (device
    time, ``ms``, and issued eagerly, ``eager_ms``) beside the plain
    version and SDPA (causal or not as served, GQA, the same bf16 inputs; with a sliding
    window, an explicit boolean band mask, since no single call takes a
    window).  The bound counts only the (query, key) pairs inside the
    window."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.timing import cuda_ms, graph_ms
    from repro_torch.models import layers as L
    errs = []
    for q, k, v, kw in layers:
        causal, window = kw.get("causal", True), kw.get("window")
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        errs.append(dict(
            plain=AC.check_close(got, FA.flash_attention_ref(
                q, k, v, causal=causal, window=window), *AC.FLASH_TOL["bf16"]),
            chunked=AC.check_close(got, L.chunked_attention(
                q, k, v, causal=causal, window=window, kv_block=512),
                AC.FLASH_VS_CHUNKED, AC.FLASH_VS_CHUNKED)))
        torch.cuda.empty_cache()
    q, k, v, kw = layers[0]
    causal, window = kw.get("causal", True), kw.get("window")
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    nbytes = FA.hbm_bytes(b, sq, skv, h, hkv, d, dv)
    ops = FA.flops(b, sq, skv, h, d, dv, causal=causal, window=window)
    b_ms, b_by = bound_ms(nbytes, ops, H100_BF16_OPS_PER_S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        sdpa_kw = dict(is_causal=causal)
        library = (f"scaled_dot_product_attention(is_causal={causal}, "
                   "enable_gqa=True)")
    else:
        i = torch.arange(sq, device=q.device)
        rel = i[:, None] - torch.arange(skv, device=q.device)[None, :]
        sdpa_kw = dict(attn_mask=(rel >= 0) & (rel < window))
        library = ("scaled_dot_product_attention(attn_mask=causal band of "
                   f"{window}, enable_gqa=True)")
    try:
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw), reps=10)
    except RuntimeError as exc:      # e.g. a value width SDPA refuses
        sdpa, library = None, f"none: SDPA refused ({str(exc).splitlines()[0]})"
    del sdpa_kw

    def kernel():
        return FA.flash_attention(q, k, v, causal=causal, window=window)

    ms = graph_ms(kernel, reps=10)
    rec = dict(arch=arch, geometry=dict(B=b, S=sq, H=h, Hkv=hkv, d=d, dv=dv,
                                        window=window),
               max_abs_err=max(e["plain"] for e in errs), errors=errs,
               ms=ms, eager_ms=cuda_ms(kernel, reps=10),
               plain_ms=cuda_ms(lambda: FA.flash_attention_ref(
                   q, k, v, causal=causal, window=window), reps=2, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=sdpa, library=library,
               bytes=nbytes, ops=ops, tflops=ops / ms / 1e9)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 6 and 7: compressed-resident decode at full width
# ---------------------------------------------------------------------------

def live_pool_check(torch, cfg, states, device) -> float:
    """The family's paged kernel against its plain version on live pools
    after their flush: the real page tables (pages allocated in (row, page,
    layer) order at admission, (layer, row) order at the flush), the
    flushed pages, every row's own length; the first and last layer,
    seeded queries.  Returns the largest absolute difference."""
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import splitzip_attention as SA
    from repro_torch.models import mla as MLA
    gen = torch.Generator(device=device).manual_seed(5)

    def q(*shape):
        return (0.25 * torch.randn(*shape, generator=gen, device=device)
                ).to(torch.bfloat16)

    worst = 0.0
    for st in states:
        g, b, h = st.geom, st.geom.batch, cfg.num_heads
        common = dict(cache_len=st.cache_len, exponents=g.exponents,
                      chunk=g.chunk, tokens_per_page=g.tokens_per_page,
                      causal=True)
        for i in (0, g.n_layers - 1):
            if cfg.mla is not None:
                c, r = st.leaves["ckv"], st.leaves["krope"]
                kw = dict(q_lat=q(b, 1, h, cfg.mla.kv_lora_rank),
                          q_rope=q(b, 1, h, cfg.mla.qk_rope_head_dim),
                          ckv_streams=c.streams(), krope_streams=r.streams(),
                          page_table_ckv=c.page_table[i],
                          page_table_krope=r.page_table[i],
                          fmt=g.leaf("ckv").fmt, scale=MLA.mla_scale(cfg.mla),
                          **common)
                fn, plain = SA.paged_mla_attention, SA.paged_mla_attention_plain
            else:
                k, v = st.leaves["k"], st.leaves["v"]
                kw = dict(q=q(b, 1, h, cfg.head_dim), k_streams=k.streams(),
                          v_streams=v.streams(), page_table_k=k.page_table[i],
                          page_table_v=v.page_table[i], fmt=g.leaf("k").fmt,
                          hkv=cfg.num_kv_heads, scale=1.0 / cfg.head_dim ** 0.5,
                          **common)
                fn, plain = SA.paged_gqa_attention, SA.paged_gqa_attention_plain
            worst = max(worst, AC.check_partials(fn(**kw), plain(**kw)))
    return worst


def resident_checks(torch, cfg, params, cb, prompt, new_tokens, device, *,
                    want_bytes, want_max_seq):
    """Serve ``resident="compressed"`` through ``serve_once`` (its launches
    counted), then hold a fresh admission of the same prefill against the
    prefill cache (bitwise rehydrate, exact bytes), teacher-force the served
    tokens through resident and raw decode steps side by side, and hold the
    paged kernel against its plain version on both flushed pools.  The
    fresh admission's prefill is the one whose first and last layer hold
    the flash-attention kernel (``flash_live``).  Returns the phase's record
    and the served run's launches."""
    from repro_torch.core import codec as C
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.kvcache import DecodeState
    from repro_torch.serving.engine import DisaggregatedEngine

    eng = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                              backend="cuda", device=device)
    res, launches = counted(serve.serve_once, eng, prompt, new_tokens,
                            want_max_seq)
    st = eng.stats
    if (st.resident_admits, st.resident_demotions) != (1, 0):
        raise AssertionError(f"admits/demotions {st.resident_admits}/"
                             f"{st.resident_demotions}, want 1/0")
    pool = eng._pool
    g = pool.geom
    if g.max_seq != want_max_seq:
        raise AssertionError(f"max_seq {g.max_seq} != {want_max_seq}")
    positions = serve.prompt_positions(cfg, prompt)
    n_full0 = positions // g.tokens_per_page
    n_flush = (positions + new_tokens) // g.tokens_per_page - n_full0
    flushed = {lg.key: pool.allocated_pages(lg.key)
               - g.n_layers * g.batch * n_full0 for lg in g.leaves}
    if any(v != n_flush * g.n_layers * g.batch for v in flushed.values()):
        raise AssertionError(f"flush allocated {flushed}, want "
                             f"{n_flush * g.n_layers * g.batch} pages a leaf")
    got_bytes = (pool.hbm_bytes(), pool.raw_bytes())
    if got_bytes != want_bytes:
        raise AssertionError(f"resident/raw bytes {got_bytes} != {want_bytes}")

    eng_raw = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device)
    raw = serve.serve_once(eng_raw, prompt, new_tokens)
    same_tok = (res.tokens == raw.tokens)
    agree = float(same_tok.float().mean())
    # per row, the first generated position where resident and raw differ
    # (random weights give flat logits, so one flip changes all that follows)
    first_diff = [int(torch.nonzero(~row)[0]) if not bool(row.all()) else None
                  for row in same_tok.cpu()]

    # a fresh admission of the same prefill: rehydrate, then teacher forcing
    eng_tf = DisaggregatedEngine(cfg, params, cb, resident="compressed",
                                 backend="cuda", device=device)
    pre, flash_layers = capture_flash(eng_tf.prefill, prompt, want_max_seq)
    flash = flash_live(torch, flash_layers, cfg.name)
    del flash_layers
    rst = eng_tf.transfer(pre.state)
    tpool = eng_tf._pool
    reh = tpool.rehydrate(rst)
    for k, v in pre.state.cache.items():
        if not C.bits_equal(reh[k], v):
            raise AssertionError(f"rehydrate after admission != prefill cache ({k})")
    del reh
    raw_st = DecodeState(cache={k: v.clone() for k, v in pre.state.cache.items()},
                         cache_len=pre.state.cache_len.clone())
    worst, served_argmax = 0.0, 0
    t_res = t_raw = 0.0
    with torch.no_grad():
        for i in range(new_tokens):
            tok = res.tokens[:, i:i + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lr, raw_st = M.decode_step(params, tok, raw_st, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lc, rst = M.resident_decode_step(params, tok, rst, cfg)
            rst = tpool.flush_full_tails(rst)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_raw, t_res = t_raw + (t1 - t0), t_res + (t2 - t1)
            a, b = lr.float(), lc.float()
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"non-finite resident logits at step {i}")
            scale = max(1e-3, float(a.abs().max()))
            ratio = float((a - b).abs().max()) / scale
            worst = max(worst, ratio)
            if ratio >= LOGITS_BOUND:
                raise AssertionError(f"step {i}: |resident - raw| = {ratio:.4f} "
                                     f"max|logits| >= {LOGITS_BOUND}")
            served_argmax += int(torch.equal(
                torch.argmax(lc, dim=-1).to(torch.int32), res.tokens[:, i + 1]))
    live_err = live_pool_check(torch, cfg, (pool.state, rst), device)
    return dict(
        tokens_per_page=g.tokens_per_page, max_seq=g.max_seq,
        resident_admits=st.resident_admits,
        resident_demotions=st.resident_demotions, flushed_pages=flushed,
        resident_hbm_bytes=got_bytes[0], resident_raw_bytes=got_bytes[1],
        resident_ratio=got_bytes[1] / got_bytes[0],
        transfer_ratio=st.transfer_ratio,
        rehydrate_bitwise=True, tokens_agree_with_raw=agree,
        first_divergence_per_row=first_diff,
        teacher_forced_max_ratio=worst, logits_bound=LOGITS_BOUND,
        teacher_forced_steps_matching_served=served_argmax,
        live_pool_max_abs_err=live_err, live_pool_rtol=AC.PARTIALS_RTOL,
        seconds_resident=res.seconds, seconds_raw=raw.seconds,
        step_ms_resident=t_res / new_tokens * 1e3,
        step_ms_raw=t_raw / new_tokens * 1e3, served_launches=launches,
        flash_live=flash), launches


def phase_resident(torch, cfg, params, cb, prompt, device):
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(315_780_480, 398_131_200), want_max_seq=2160)
    emit(phase="resident", arch=cfg.name, batch=BATCH, prompt=PROMPT,
         new_tokens=RES_TOKENS, **out)
    return launches, out["flash_live"]


def phase_mla(torch, device):
    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    cfg = get_config(MLA_ARCH)
    gen = torch.Generator(device=device).manual_seed(10)
    params = M.init_params(cfg, gen, device)
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=11)
    prompt = serve.make_prompt(cfg, MLA_BATCH, MLA_PROMPT, device=device, seed=12)
    raw_runs, tokens = {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res = serve.serve_once(eng, prompt, RES_TOKENS)
        if not all(C.bits_equal(x, y) for x, y in zip(
                TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache))):
            raise AssertionError(f"mla {label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        raw_runs[label] = dict(seconds=res.seconds,
                               transfer_ratio=eng.stats.transfer_ratio,
                               codec_ok=eng.stats.codec_ok)
        del res, eng
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"mla tokens differ: {label} vs cuda_n1")
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(126_684_352, 155_418_624), want_max_seq=1088)
    emit(phase="mla", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_lora_rank=cfg.mla.kv_lora_rank,
         rope=cfg.mla.qk_rope_head_dim, vocab=cfg.vocab_size,
         batch=MLA_BATCH, prompt=MLA_PROMPT, new_tokens=RES_TOKENS,
         raw_runs=raw_runs, raw_tokens_equal=True, delivered_bitwise=True,
         **out)
    del params
    torch.cuda.empty_cache()
    return launches, out["flash_live"]


def phase_moe(torch, device):
    """qwen3-moe-30b-a3b at full width: the raw path bitwise, then the
    resident path (``resident_checks``).  Returns the served resident run's
    launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    def peak_gb():
        gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return gb

    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(20),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(params))
    peak = {"init": peak_gb()}
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=21)
    prompt = serve.make_prompt(cfg, MOE_BATCH, MOE_PROMPT, device=device, seed=22)
    raw_runs, tokens = {}, {}
    for label, kw in (("cuda_n1", dict(n_chunks=1)),
                      ("cuda_n8", dict(n_chunks=8)),
                      ("raw", dict(compress=False))):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        res = serve.serve_once(eng, prompt, RES_TOKENS)
        if not all(C.bits_equal(x, y) for x, y in zip(
                TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache))):
            raise AssertionError(f"moe {label}: delivered cache != prefill cache")
        tokens[label] = res.tokens
        raw_runs[label] = dict(seconds=res.seconds,
                               transfer_ratio=eng.stats.transfer_ratio,
                               raw_bytes=eng.stats.raw_cache_bytes,
                               wire_bytes=eng.stats.wire_bytes,
                               codec_ok=eng.stats.codec_ok)
        del res, eng
        peak[label] = peak_gb()
    for label in ("cuda_n8", "raw"):
        if not torch.equal(tokens[label], tokens["cuda_n1"]):
            raise AssertionError(f"moe tokens differ: {label} vs cuda_n1")
    out, launches = resident_checks(
        torch, cfg, params, cb, prompt, RES_TOKENS, device,
        want_bytes=(640_505_856, 830_472_192), want_max_seq=2112)
    peak["resident"] = peak_gb()
    emit(phase="moe", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
         weight_bytes=weight_bytes, init_seconds=init_s,
         batch=MOE_BATCH, prompt=MOE_PROMPT, new_tokens=RES_TOKENS,
         raw_runs=raw_runs, raw_tokens_equal=True, delivered_bitwise=True,
         peak_memory_gb=peak, **out)
    del params
    torch.cuda.empty_cache()
    return launches, out["flash_live"]


def phase_demotion(torch, cfg, params, prompt, device):
    from repro_torch.core.codebook import Codebook
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DisaggregatedEngine

    bad = Codebook(fmt="bf16", exponents=tuple(range(16)))   # every value escapes
    eng_res = DisaggregatedEngine(cfg, params, bad, resident="compressed",
                                  backend="cuda", device=device)
    eng_raw = DisaggregatedEngine(cfg, params, bad, backend="cuda", device=device)
    max_seq = eng_res.resident_max_seq(PROMPT + 1 + NEW_TOKENS)
    res, launches = counted(serve.serve_once, eng_res, prompt, NEW_TOKENS)
    raw = serve.serve_once(eng_raw, prompt, NEW_TOKENS, max_seq=max_seq)
    if (eng_res.stats.resident_demotions, eng_res.stats.resident_admits) != (1, 0):
        raise AssertionError("inadmissible stream: expected one demotion")
    if not torch.equal(res.tokens, raw.tokens):
        raise AssertionError("demoted tokens != raw-resident tokens")
    emit(phase="demotion", resident_demotions=1, tokens_bitwise=True,
         max_seq=max_seq, seconds=res.seconds)
    return launches


# ---------------------------------------------------------------------------
# the fp8 route, and the families of the sixth slice
# ---------------------------------------------------------------------------

#: (fmt, k, torch dtype name): Appendix B's preferred e5m2 variant and
#: e4m3's only meaningful one
FP8_VARIANTS = (("fp8_e5m2", 16, "float8_e5m2"), ("fp8_e4m3", 8, "float8_e4m3fn"))
MINITRON_ARCH, MINITRON_BATCH, MINITRON_PROMPT = "minitron-4b", 4, 2048
SSM_ARCH, SSM_BATCH, SSM_PROMPT = "mamba2-2.7b", 4, 2048
HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT = "recurrentgemma-9b", 4, 4096


def phase_fp8(torch, cb, first, device):
    """Phase ``main``'s served cache cast to float8 (e5m2 at k 16, e4m3 at
    k 8), codebooks from ``fp8.calibrate_fp8`` on the cast leaves, through
    the plan's ``fp8`` route on the ``cuda`` backend: delivery bitwise, the
    wire ratio against native beside ``ratio_vs_native`` at the measured
    escape rate.  The wire bytes follow the size model (``code_bits``
    a code: 3 at k 8); the streams keep a nibble a code, and the ratio
    with nibble codes is reported apart.  Returns each variant's
    launches."""
    from repro_torch.core import codec as C
    from repro_torch.core import fp8 as FP8
    from repro_torch.core.codebook import FORMATS
    from repro_torch.core import tree as TR
    from repro_torch.serving.plan import TransferConfig, TransferPlan

    out, launches = {}, {}
    for fmt, k, dtype in FP8_VARIANTS:
        cache = {key: v.to(getattr(torch, dtype))
                 for key, v in first.prefill.state.cache.items()}
        sample = [v.reshape(-1)[: 1 << 22].view(torch.uint8).cpu().numpy()
                  for v in cache.values()]
        cb8 = FP8.calibrate_fp8(sample, fmt, k)
        plan = TransferPlan.build(cache, TransferConfig(
            codebook=cb, fp8_codebook=cb8, backend="cuda"))
        if [r.route for r in plan.routes] != ["fp8", "fp8"]:
            raise AssertionError(f"{fmt}: routes {[r.route for r in plan.routes]}")
        sess = plan.session()
        got, launches[fmt] = counted(sess.transfer, cache)
        torch.cuda.synchronize()
        if not all(C.bits_equal(a, b) for a, b in zip(TR.leaves(got), TR.leaves(cache))):
            raise AssertionError(f"{fmt}: delivered cache != sent cache")
        st = sess.last_stats
        comp, _ = plan.session().transfer_compressed(cache)
        n = sum(v.numel() for v in cache.values())
        escapes = sum(int(ct.esc_count.sum()) for ct in comp.values())
        mbits = FORMATS[fmt]["mbits"]
        eps = escapes / n
        out[fmt] = dict(
            k=k, dtype=dtype, codebook=list(cb8.exponents), elements=n,
            raw_bytes=float(n), wire_bytes=st.fp8_wire_bytes,
            wire_ratio_vs_native=n / st.fp8_wire_bytes,
            model_ratio_vs_native=FP8.ratio_vs_native(fmt, k, eps),
            model_ratio_vs_bf16=FP8.ratio_vs_bf16(fmt, k, eps),
            escape_rate=eps, escapes=escapes, codec_ok=st.all_ok,
            retry_steps=st.chunk_retry_steps,
            wire_bytes_follow=f"the size model: {cb8.code_bits}-bit codes",
            # the codes as the streams hold them (a nibble each), the rest
            # as the size model counts it
            nibble_code_bytes=n * (1 + mbits) / 8 + n / 2 + 3 * escapes,
            nibble_code_ratio_vs_native=n / (n * (1 + mbits) / 8 + n / 2
                                             + 3 * escapes),
            # what the streams take in device memory: a byte of sign and
            # mantissa and a nibble of code an element
            stream_bytes_in_memory=sum(ct.sign_mantissa.numel() + ct.packed.numel()
                                       for ct in comp.values()),
            nan_elements=int(sum(int(torch.isnan(v.float()).sum())
                                 for v in cache.values())))
        del cache, got, comp, sess, plan
        torch.cuda.empty_cache()
    emit(phase="fp8", arch=ARCH, batch=BATCH, prompt=PROMPT, variants=out,
         delivered_bitwise=True, paper_appendix_b="up to 1.14x over native E5M2")
    return launches


def hi_half_escapes(torch, cache, cb, chunk: int = 1024):
    """Escapes of the f32 leaves' hi halves under the bf16 codebook ``cb``
    (the exponent of an f32 value is its hi half's bf16 exponent), per
    chunk row of ``chunk`` elements, as the ``fp32_hilo`` route encodes
    them: ``{leaf: {escapes, rows, per_row, max_per_row}}``."""
    book = torch.zeros(256, dtype=torch.bool, device=next(iter(cache.values())).device)
    book[list(cb.exponents)] = True
    out = {}
    for key, x in cache.items():
        if x.dtype != torch.float32 or not x.numel():
            continue
        e = (x.reshape(-1).view(torch.int32) >> 23) & 0xFF
        esc = ~book[e.to(torch.int64)]
        esc = torch.nn.functional.pad(esc, (0, (-esc.numel()) % chunk))
        per_row = esc.view(-1, chunk).sum(dim=1)
        out[key] = dict(escapes=int(per_row.sum()), rows=per_row.numel(),
                        per_row=float(per_row.float().mean()),
                        max_per_row=int(per_row.max()))
    return out


def _peak_gb(torch):
    gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return gb


def serve_family(torch, arch, batch, prompt_len, runs, device, seed, *,
                 flash_layers=False, keep=False):
    """``arch`` at full width (seeded random weights, drawn on the card),
    served through ``serve_once`` once per ``(label, engine keywords)`` of
    ``runs`` with the ``cuda`` backend at n_chunks 1: each run's delivered
    cache bitwise the prefill's, the tokens of every run equal.  Reports
    each run's seconds, ratio, escapes (with ``compress_fp32``, also the
    f32 leaves' hi halves'), capacity retries and peak device memory, and
    the cache's leaf shapes.  The first run's launches are counted alone; with
    ``flash_layers`` its prefill's first and last attention layer are kept
    for ``flash_live``.  Frees the model before it returns, unless ``keep``:
    then a fourth value holds the config, the parameters, the codebook, the
    prompt and the first run's delivered cache, for the caller to free."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in TR.leaves(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(params))
    peak = {"init": _peak_gb(torch)}
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=seed + 1)
    prompt = serve.make_prompt(cfg, batch, prompt_len, device=device, seed=seed + 2)
    results, tokens, launches, layers, kept = {}, {}, {}, None, None
    for i, (label, kw) in enumerate(runs):
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device, **kw)
        if i == 0 and flash_layers:
            (res, launches[label]), layers = capture_flash(
                counted, serve.serve_once, eng, prompt, NEW_TOKENS)
        else:
            res, launches[label] = counted(serve.serve_once, eng, prompt, NEW_TOKENS)
        cache = res.prefill.state.cache
        if not all(C.bits_equal(x, y) for x, y in zip(
                TR.leaves(res.delivered.cache), TR.leaves(cache))):
            raise AssertionError(f"{arch} {label}: delivered cache != prefill cache")
        if not bool(torch.isfinite(res.prefill.last_logits.float()).all()):
            raise AssertionError(f"{arch} {label}: non-finite prefill logits")
        tokens[label] = res.tokens
        shapes = {k: list(v.shape) for k, v in cache.items()}
        st = eng.stats
        results[label] = dict(
            seconds=res.seconds, transfer_ratio=st.transfer_ratio,
            raw_bytes=st.raw_cache_bytes, wire_bytes=st.wire_bytes,
            fp32_lo_wire_bytes=st.fp32_lo_wire_bytes, codec_ok=st.codec_ok,
            retried_units=st.chunk_retries, retry_steps=st.chunk_retry_steps,
            plan=eng.describe_plan())
        if eng.plan is not None:
            results[label]["escapes"] = served_escapes(eng, cache)
            if eng.tc.compress_fp32:
                results[label]["fp32_hi_escapes"] = hi_half_escapes(torch, cache, cb)
        if keep and i == 0:
            kept = dict(cfg=cfg, params=params, cb=cb, prompt=prompt,
                        cache=res.delivered.cache)
        del res, eng, cache
        peak[label] = _peak_gb(torch)
    for label in tokens:
        if not torch.equal(tokens[label], tokens[runs[0][0]]):
            raise AssertionError(f"{arch} tokens differ: {label} vs {runs[0][0]}")
    flash = flash_live(torch, layers, arch) if layers is not None else None
    del params, layers
    torch.cuda.empty_cache()
    record = dict(arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
                  vocab=cfg.vocab_size, params=n_params, weight_bytes=weight_bytes,
                  init_seconds=init_s, batch=batch, prompt=prompt_len,
                  new_tokens=NEW_TOKENS, codebook=list(cb.exponents),
                  cache_shapes=shapes, runs=results,
                  tokens_equal=True, delivered_bitwise=True, peak_memory_gb=peak)
    if keep:
        return record, launches, flash, kept
    return record, launches, flash


#: the recurrent families' three runs: the f32 state through the hi/lo
#: route, the f32 state raw, and compression off
RECURRENT_RUNS = (("fp32_hilo", dict(compress_fp32=True)),
                  ("fp32_raw", dict(compress_fp32=False)),
                  ("off", dict(compress=False)))


def phase_minitron(torch, device):
    rec, launches, _ = serve_family(
        torch, MINITRON_ARCH, MINITRON_BATCH, MINITRON_PROMPT,
        (("cuda_n1", {}), ("off", dict(compress=False))), device, seed=40)
    emit(phase="minitron", **rec)
    return launches["cuda_n1"]


def phase_ssm(torch, device):
    from repro_torch.configs.base import get_config
    cfg = get_config(SSM_ARCH)
    rec, launches, _ = serve_family(torch, SSM_ARCH, SSM_BATCH, SSM_PROMPT,
                                    RECURRENT_RUNS, device, seed=50)
    emit(phase="ssm", d_state=cfg.ssm.d_state, ssd_chunks=SSM_PROMPT // cfg.ssm.chunk,
         **rec)
    return launches["fp32_hilo"]


def phase_hybrid(torch, device):
    from repro_torch.configs.base import get_config
    cfg = get_config(HYBRID_ARCH)
    rec, launches, flash = serve_family(
        torch, HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, RECURRENT_RUNS, device,
        seed=60, flash_layers=True)
    if rec["cache_shapes"]["attn_k"][2] != cfg.hybrid.window:
        raise AssertionError(f"hybrid cache keeps {rec['cache_shapes']['attn_k'][2]} "
                             f"positions, not the window's {cfg.hybrid.window}")
    emit(phase="hybrid", window=cfg.hybrid.window, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, **rec)
    return launches["fp32_hilo"], flash


# ---------------------------------------------------------------------------
# the seventh slice: the frontend families and the persistent executor
# ---------------------------------------------------------------------------

VLM_ARCH, VLM_BATCH, VLM_PROMPT = "pixtral-12b", 4, 2048   # 256 patches + 1792 tokens
VLM_MAX_SEQ = 2080               # 2048 + 1 + 16 up to pixtral's 16-token pages
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES = "hubert-xlarge", 8, 1500  # 30 s at 50/s


def phase_vlm(torch, device):
    """pixtral-12b at full width: served compressed and with compression
    off (``serve_family``), then compressed-resident with an explicit
    ``max_seq`` (``resident_checks``).  Returns the compressed run's
    launches, the resident run's, the first layer's ``flash_live``, and the
    delivered cache with its codebook for phase ``persist``."""
    rec, launches, _, kept = serve_family(
        torch, VLM_ARCH, VLM_BATCH, VLM_PROMPT,
        (("cuda_n1", {}), ("off", dict(compress=False))), device, seed=70,
        keep=True)
    cfg, params, cb, prompt = (kept[k] for k in ("cfg", "params", "cb", "prompt"))
    positions = prompt["patches"].shape[1] + prompt["tokens"].shape[1]
    if positions != VLM_PROMPT or rec["cache_shapes"]["k"][2] != VLM_PROMPT + 1 + NEW_TOKENS:
        raise AssertionError(f"vlm: {positions} prompt positions, cache "
                             f"{rec['cache_shapes']['k']}")
    torch.cuda.reset_peak_memory_stats()
    out, res_launches = resident_checks(
        torch, cfg, params, cb, prompt, NEW_TOKENS, device,
        want_bytes=(1_041_167_360, 1_363_148_800), want_max_seq=VLM_MAX_SEQ)
    rec["peak_memory_gb"]["resident"] = _peak_gb(torch)
    emit(phase="vlm", heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, frontend=cfg.frontend,
         frontend_dim=cfg.frontend_dim, patches=cfg.frontend_len,
         text_tokens=VLM_PROMPT - cfg.frontend_len, resident=out, **rec)
    cache = kept["cache"]
    del params, prompt, kept
    torch.cuda.empty_cache()
    return launches["cuda_n1"], res_launches, out["flash_live"], cache, cb


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_persist(torch, cache, cb, device):
    """The persistent executor on the card: ``session.save`` of phase
    ``vlm``'s delivered cache and ``session.load`` back onto the card,
    bitwise, each counted alone; each leaf's wire encode, host Fletcher-32
    and verified decode timed apart; then
    a ``Checkpointer`` drill: a corrupted step falls back to the previous
    one bitwise, its re-reads counted.  Everything is written under
    ``build/`` and removed.  Returns the save's and the load's launches."""
    import shutil
    import tempfile
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.core.backend import get_backend
    from repro_torch.core.wire import fletcher32
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.serving.plan import TransferConfig, TransferPlan

    def synced(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_persist_", dir=ROOT / "build"))
    try:
        plan = TransferPlan.build(cache, TransferConfig(codebook=cb, backend="wire"))
        sess = plan.session(device=device)
        path = str(tmp / "vlm_cache")
        (_, save_launches), save_ms = synced(counted, sess.save, path, cache)
        save_stats = sess.last_stats
        ((tree, _), load_launches), load_ms = synced(counted, sess.load, path)
        if not all(C.bits_equal(a, b) for a, b in zip(TR.leaves(tree), TR.leaves(cache))):
            raise AssertionError("persist: loaded cache != saved cache")
        if any(x.device != cache["k"].device for x in TR.leaves(tree)):
            raise AssertionError("persist: a leaf did not land on the card")
        load_stats = sess.last_stats
        del tree
        # the save's and the load's parts, a leaf at a time: the wire
        # encode, the host Fletcher-32 of the file, the verified decode
        wire, wire_ver = get_backend("wire"), get_backend("wire-verify")
        parts = {}
        for k, v in cache.items():
            ct, enc_ms = synced(wire.encode, v, cb)
            _, fl_ms = synced(fletcher32, ct.payload)
            _, dec_ms = synced(wire_ver.decode, ct)
            parts[k] = dict(wire_encode_ms=enc_ms, host_fletcher_ms=fl_ms,
                            wire_verify_decode_ms=dec_ms,
                            payload_bytes=len(ct.payload))
            del ct
        raw_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(cache))
        dir_bytes = _dir_bytes(path)
        manifest = json.loads((Path(path) / "manifest.json").read_text())
        if manifest["format"] != "szpersist-1" or \
                [e["key"] for e in manifest["leaves"]] != ["k", "v"]:
            raise AssertionError(f"persist: manifest {manifest['format']}, "
                                 f"{[e['key'] for e in manifest['leaves']]}")

        # the Checkpointer drill on a small train-state tree on the card
        gen = torch.Generator(device=device).manual_seed(90)

        def state(step):
            return {"params": {"w": torch.randn(1024, 1024, generator=gen,
                                                device=device).to(torch.bfloat16)},
                    "opt": {"m": torch.randn(1024, 1024, generator=gen, device=device)},
                    "step": torch.tensor(step, dtype=torch.int32, device=device)}

        ck = CKPT.Checkpointer(str(tmp / "ckpt"), device=device)
        s1, s2 = state(1), state(2)
        ck.save(1, s1, extra={"step": 1})
        ck.save(2, s2)
        step2 = tmp / "ckpt" / "step_0000000002"
        victim = max(step2.glob("*.szc"), key=lambda f: f.stat().st_size)
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))
        (got, extra, step), restore_ms = synced(ck.restore, s1)
        if step != 1 or extra != {"step": 1} or not all(
                C.bits_equal(a, b) for a, b in zip(TR.leaves(got), TR.leaves(s1))):
            raise AssertionError(f"checkpointer: restored step {step}, not step 1 "
                                 "bitwise")
        if ck.stats.refetches <= 0 or ck.stats.verify_failures <= 0:
            raise AssertionError("checkpointer: the corrupt step counted no re-read")
        drill = dict(steps_saved=[1, 2], corrupted=victim.name, restored_step=step,
                     bitwise=True, verify_failures=ck.stats.verify_failures,
                     refetches=ck.stats.refetches,
                     refetch_wire_bytes=ck.stats.refetch_wire_bytes,
                     restore_ms=restore_ms,
                     step_bytes=CKPT.checkpoint_bytes(str(tmp / "ckpt"), 1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="persist", arch=VLM_ARCH, leaves={k: list(v.shape) for k, v in cache.items()},
         raw_bytes=raw_bytes, directory_bytes=dir_bytes,
         ratio=raw_bytes / dir_bytes, save_ms=save_ms, load_ms=load_ms,
         parts=parts,
         save_wire_bytes=save_stats.leaf_wire_bytes,
         load_verify_failures=load_stats.verify_failures, loaded_bitwise=True,
         checkpointer=drill, save_launches=save_launches,
         load_launches=load_launches)
    return save_launches, load_launches


def phase_audio(torch, device):
    """hubert-xlarge at full width, encode-only: the launcher's refusal, then
    ``prefill_step`` on 1500 frames a row (launches counted alone, the first
    and last layer's q/k/v kept for ``flash_live``): no cache, finite
    logits, every flash launch on the tensor-core path.  Returns the
    prefill's launches and the first layer's ``flash_live``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import tree as TR
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.prefill import prefill_step

    try:
        serve.main(["--arch", AUDIO_ARCH])
    except SystemExit as exc:
        refusal = str(exc)
    else:
        raise AssertionError("the launcher served an encoder-only config")
    cfg = get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(80),
                           device)
    n_params = sum(x.numel() for x in TR.leaves(params))
    prompt = serve.make_prompt(cfg, AUDIO_BATCH, AUDIO_FRAMES, device=device, seed=81)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill_step(params, prompt, cfg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prefill_step(params, prompt, cfg)          # warm: cuBLAS, the kernels
    ((out, seconds), launches), layers = capture_flash(counted, run)
    if out.state.cache != {} or out.state.cache_len.tolist() != [AUDIO_FRAMES] * AUDIO_BATCH:
        raise AssertionError(f"audio: cache {list(out.state.cache)}, lengths "
                             f"{out.state.cache_len.tolist()}")
    if not bool(torch.isfinite(out.last_logits.float()).all()):
        raise AssertionError("audio: non-finite logits")
    if (launches["flash_attention"], launches["flash_attention_tc"]) != \
            (cfg.num_layers, cfg.num_layers):
        raise AssertionError(f"audio: flash launches {launches['flash_attention']}, "
                             f"tensor-core {launches['flash_attention_tc']}, want "
                             f"{cfg.num_layers} each")
    if any(kw.get("causal", True) for _, _, _, kw in layers):
        raise AssertionError("audio: an encoder layer ran causal attention")
    flash = flash_live(torch, layers, AUDIO_ARCH)
    units = out.first_token.tolist()
    del params, prompt, out, layers
    torch.cuda.empty_cache()
    emit(phase="audio", arch=AUDIO_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, head_dim=cfg.head_dim, params=n_params,
         batch=AUDIO_BATCH, frames=AUDIO_FRAMES, prefill_seconds=seconds,
         first_units=units, launcher_refusal=refusal, cache_leaves=0,
         peak_memory_gb=_peak_gb(torch), flash_live=flash)
    return launches, flash


# ---------------------------------------------------------------------------
# phases mesh and ring: the collective executors across ranks on one card
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 1, 1)           # pod x data x model: one prefill, one decode
RING_RANKS = 4
RANK_TIMEOUT_S = 420
RING_WIDE_ELEMS = 65536          # the forced-overflow leaf, per contribution


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(body: str, world: int, *args):
    """``world`` processes of ``body(torch, rank, device, *args)`` over gloo
    on the one card (the kernels are built before, by the parent).  Each
    rank's dict comes back through a queue; a rank that raises, or a world
    still running after ``RANK_TIMEOUT_S``, fails the phase.  The ranks
    fork from a server that imported torch once (``forkserver``; it never
    touches CUDA): a spawned rank imports torch itself, 8-10 s a world on
    the card's host, a forked one starts in under a second."""
    import torch.multiprocessing as mp
    mp.set_forkserver_preload(["torch", "torch.distributed"])
    q = mp.get_context("forkserver").SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(world, f"tcp://localhost:{_free_port()}", body, q,
                          args),
        nprocs=world, join=False, start_method="forkserver")
    results = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while True:
        while not q.empty():
            rank, res = q.get()
            results[rank] = res
        if procs.join(timeout=1.0):
            break
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise AssertionError(f"{body}: ranks still running after "
                                 f"{RANK_TIMEOUT_S} s")
    while not q.empty():
        rank, res = q.get()
        results[rank] = res
    if sorted(results) != list(range(world)):
        raise AssertionError(f"{body}: results from ranks {sorted(results)}")
    return [results[r] for r in range(world)]


def _rank_main(rank, world, addr, body, q, args=()):
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=addr, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        q.put((rank, globals()[body](torch, rank, torch.device("cuda", 0),
                                     *args)))
        dist.barrier()   # no rank tears its connections down under a peer
    finally:
        dist.destroy_process_group()


def _comm(sess, seconds):
    c = sess.last_comm
    return dict(host_ms=seconds * 1e3, staging_ms=c.staging_s * 1e3,
                wire_ms=c.wire_s * 1e3, codec_and_host_ms=c.codec_s * 1e3,
                sent_bytes=c.sent_bytes, recv_bytes=c.recv_bytes,
                header_bytes=c.header_bytes, messages=c.messages)


def _bits_equal_trees(a, b):
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    return all(C.bits_equal(x, y) for x, y in zip(TR.leaves(a), TR.leaves(b)))


def mesh_rank(torch, rank, device):
    """One rank of phase ``mesh``.  Rank 0 (pod 0, the prefill pod) prefills
    smollm-135m (B 8 x 2048) and ships its cache through the mesh executor
    at n_chunks 1 and 8, through a compress-off plan, and once with an
    all-escape first chunk; rank 1 (pod 1, the decode pod) receives each,
    checks it bitwise against the compress-off copy and decodes 16 tokens
    from each, which must equal rank 0's tokens from its own cache."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import codec as C
    from repro_torch.core import tree as TR
    from repro_torch.core.codebook import Codebook
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.kvcache import DecodeState
    from repro_torch.serving.decode import decode_loop
    from repro_torch.serving.engine import DisaggregatedEngine
    from repro_torch.serving.plan import TransferConfig, TransferPlan

    cfg = get_config(ARCH)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    mesh = make_mesh(MESH_SHAPE, ("pod", "data", "model"))
    out = {"rank": rank, "pod": mesh.get_local_rank("pod")}
    if rank == 0:
        cb = serve.calibrate_on_model(cfg, params, device=device, seed=1)
        prompt = serve.make_prompt(cfg, BATCH, PROMPT, device=device, seed=2)
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device)
        max_seq = serve.prompt_positions(cfg, prompt) + 1 + NEW_TOKENS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre, launches = counted(eng.prefill, prompt, max_seq)
        torch.cuda.synchronize()
        out.update(prefill_seconds=time.perf_counter() - t0,
                   prefill_launches={k: launches[k] for k in
                                     ("flash_attention", "flash_attention_tc")})
        cache = pre.state.cache
        flat, treedef = TR.flatten_with_path(cache)
        meta = [cb.to_json(), treedef,
                [(tuple(x.shape), C.dtype_name(x.dtype)) for _, x in flat],
                pre.state.cache_len.cpu(), pre.first_token.cpu()]
    else:
        meta = [None] * 5
    dist.broadcast_object_list(meta, src=0)
    cb = Codebook.from_json(meta[0])
    cache_len, first_token = meta[3].to(device), meta[4].to(device)
    if rank == 1:
        cache = TR.unflatten(meta[1], [torch.empty(s, dtype=getattr(torch, d),
                                                   device="meta")
                                       for s, d in meta[2]])

    def heavy(c):
        """``c`` with the first 1024 elements of ``k`` all escapes."""
        c = {k: v.clone() for k, v in c.items()}
        esc_e = next(e for e in range(256) if e not in cb.exponents)
        bits = (torch.arange(1024, device=device, dtype=torch.int32) % 128) | (esc_e << 7)
        C.signed_view(c["k"].view(torch.uint16)).reshape(-1)[:1024] = \
            bits.to(torch.int16)
        return c

    runs, delivered = {}, {}
    for label, kw in (("n1", dict(n_chunks=1)), ("n8", dict(n_chunks=8)),
                      ("raw", dict(enabled=False)), ("escape", dict(n_chunks=1))):
        src = cache if label != "escape" else (
            heavy(cache) if rank == 0 else cache)
        plan = TransferPlan.build(src, TransferConfig(codebook=cb, backend="cuda",
                                                      **kw), mesh=mesh)
        sess = plan.session(device=device)
        sess.transfer(src if rank == 0 else None)   # warm: loads, pinned sizes
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, launches = counted(sess.transfer, src if rank == 0 else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st = sess.last_stats
        runs[label] = dict(
            _comm(sess, seconds), n_chunks=max(1, plan.n_chunks),
            raw_bytes=plan.raw_bytes(), wire_bytes=st.wire_bytes,
            ratio=plan.raw_bytes() / st.wire_bytes,
            retry_steps=st.n_retry_steps, all_ok=st.all_ok,
            launches={k: launches[k] for k in KERNELS})
        if rank == 1:
            delivered[label] = got
    if rank == 0:
        tokens, _ = decode_loop(params, first_token,
                                DecodeState(cache=cache, cache_len=cache_len),
                                cfg, NEW_TOKENS)
        tokens = [tokens.cpu()]
    else:
        tokens = [None]
        ref = delivered["raw"]
        for label in ("n1", "n8"):
            if not _bits_equal_trees(delivered[label], ref):
                raise AssertionError(f"mesh {label}: delivered != raw copy")
        if not _bits_equal_trees(delivered["escape"], heavy(ref)):
            raise AssertionError("mesh escape: delivered != sent")
        decoded = {label: decode_loop(params, first_token,
                                      DecodeState(cache=delivered[label],
                                                  cache_len=cache_len),
                                      cfg, NEW_TOKENS)[0].cpu()
                   for label in ("n1", "n8", "raw")}
    dist.broadcast_object_list(tokens, src=0)
    if rank == 1:
        for label, t in decoded.items():
            if not torch.equal(t, tokens[0]):
                raise AssertionError(f"mesh {label}: tokens differ from the "
                                     "prefill rank's own")
        out["tokens_equal"] = True
    out["runs"] = runs
    return out


def _ring_tree(torch, shapes, treedef, device, seed, kind):
    """Stacked (RING_RANKS, ...) contributions shaped like ``shapes`` plus
    the forced-overflow leaf ``wide``, drawn from ``seed`` on the card."""
    from repro_torch.core import tree as TR
    gen = torch.Generator(device=device).manual_seed(seed)
    n = RING_RANKS
    leaves = []
    for s in shapes:
        if kind == "int":
            x = torch.randint(-8, 8, (n,) + s, generator=gen, device=device)
        else:
            x = torch.randn((n,) + s, generator=gen, device=device) * 0.02
        leaves.append(x.to(torch.bfloat16))
    wide = torch.randn((n, RING_WIDE_ELEMS), generator=gen, device=device) * \
        torch.exp2(torch.randint(-40, 40, (n, RING_WIDE_ELEMS), generator=gen,
                                 device=device).float())
    return {"params": TR.unflatten(treedef, leaves),
            "wide": wide.to(torch.bfloat16)}


def ring_rank(torch, rank, device):
    """One rank of phase ``ring``: contributions shaped like smollm-135m's
    parameter tree (and one wide leaf) through
    ``grad_compress.compressed_cross_pod_mean`` on a 4-rank pod mesh."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import tree as TR
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.training import grad_compress as GC

    cfg = get_config(ARCH)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    flat, treedef = TR.flatten_with_path(params)
    shapes = [tuple(x.shape) for _, x in flat]
    del params, flat
    mesh = make_mesh((RING_RANKS,), ("pod",))
    n, i = RING_RANKS, rank
    out = {"rank": rank, "elements_per_rank": sum(
        int(torch.tensor(s).prod()) for s in shapes) + RING_WIDE_ELEMS}

    def row0(tree):
        return TR.unflatten(TR.flatten_with_path(tree)[1],
                            [x[0] for x in TR.leaves(tree)])

    def ring_order(x):
        """Rank i's f32 sum in the ring's order: x_i, then x_{i-1}, ..."""
        acc = x[i].float()
        for h in range(1, n):
            acc = acc + x[(i - h) % n].float()
        return (acc / n).to(x.dtype)

    for kind, seed in (("int", 11), ("normal", 12)):
        grads = _ring_tree(torch, shapes, treedef, device, seed, kind)
        cb = GC.calibrate_on_grads(row0(grads["params"]))
        for compress in ((True, False) if kind == "int" else (True,)):
            label = f"{kind}_{'comp' if compress else 'raw'}"
            GC.compressed_cross_pod_mean(grads, mesh, cb, compress)   # warm
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, launches = counted(GC.compressed_cross_pod_mean, grads, mesh,
                                     cb, compress)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            sess = next(s for s in GC._SESSIONS.values()
                        if s.last_stats is GC.last_stats)
            st = GC.last_stats
            rec = dict(_comm(sess, seconds),
                       hop_ms=[h * 1e3 for h in sess.last_comm.hop_s],
                       wire_bytes_model=GC.cross_pod_wire_bytes(
                           row0(grads), n_pod=n, compress=compress,
                           codebook=cb),
                       leaf_ok=st.leaf_ok, raw_refetches=st.raw_refetches,
                       launches={k: launches[k] for k in KERNELS})
            for x, m in zip(TR.leaves(grads), TR.leaves(mean)):
                if not torch.equal(m.view(torch.int16),
                                   ring_order(x).view(torch.int16)):
                    raise AssertionError(f"ring {label}: != the ring-order "
                                         "f32 sum")
            if kind == "int":       # small integers: exact in any order
                for x, m in zip(TR.leaves(grads["params"]),
                                TR.leaves(mean["params"])):
                    ref = torch.mean(x.float(), 0).to(x.dtype)
                    if not torch.equal(m.view(torch.int16), ref.view(torch.int16)):
                        raise AssertionError(f"ring {label}: != torch.mean")
            else:
                # rank 0's means against every rank's: in bf16 ulps, and
                # against the f32 summation bound (each order's sum is
                # within 3u·Σ|x| of the exact one, u = 2^-24; /n is exact;
                # each side then rounds to bf16 once), which a sum that
                # cancels can leave more than one ulp apart
                def spread(pairs):
                    worst, over1, beyond = 0, 0, 0
                    for x, m in pairs:
                        r0 = m.cpu().clone()
                        dist.broadcast(r0, src=0)
                        r0 = r0.to(device)
                        key = lambda v: torch.where(v < 0, -(v & 0x7FFF), v)
                        d = (key(m.view(torch.int16).int())
                             - key(r0.view(torch.int16).int())).abs()
                        worst = max(worst, int(d.max()))
                        over1 += int((d > 1).sum())
                        big = torch.maximum(m.float().abs(), r0.float().abs())
                        ulp = ((big.to(torch.bfloat16).view(torch.int16) + 1)
                               .view(torch.bfloat16).float() - big)
                        sum_abs = x.float().abs().sum(0)
                        bound = ulp.abs() + 6 * 2.0 ** -24 * sum_abs / n
                        beyond += int(((m.float() - r0.float()).abs() > bound).sum())
                    return worst, over1, beyond
                (rec["max_ulps_vs_rank0"], rec["elements_over_1_ulp"],
                 rec["elements_beyond_f32_bound"]) = spread(
                    zip(TR.leaves(grads["params"]), TR.leaves(mean["params"])))
                rec["wide_ulps_vs_rank0"] = spread(
                    [(grads["wide"], mean["wide"])])[0]
                if rec["elements_beyond_f32_bound"]:
                    raise AssertionError(
                        f"ring: {rec['elements_beyond_f32_bound']} elements "
                        "differ across ranks by more than the f32 summation "
                        "bound")
            if compress and rec["leaf_ok"].get("wide", True):
                raise AssertionError("ring: the wide leaf did not overflow")
            out[label] = rec
        del grads
    return out


TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 2048, 3e-4
#: 4 steps, a checkpoint every 2, a crash at 3: every gate reads a save,
#: a crash between saves and a resume
TRAIN_STEPS, TRAIN_EVERY, TRAIN_CRASH = 4, 2, 3
TRAIN_RANKS, TRAIN_RING_STEPS = 2, 2


def _deterministic(torch):
    """Deterministic CUDA algorithms for this process (cuBLAS needs its
    workspace configured before its first call).  ``warn_only``: an op
    without a deterministic path warns, and the warnings are reported; the
    bitwise gates then decide."""
    import os
    import warnings
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.simplefilter("always")


def _nondeterministic_warnings(caught):
    return sorted({str(w.message)[:160] for w in caught
                   if "deterministic" in str(w.message)})


def _clone_state(state):
    from repro_torch.core import tree as TR
    return TR.unflatten(TR.flatten_with_path(state)[1],
                        [x.clone() for x in TR.leaves(state)])


def _escapes(torch, leaves, cb, chunk: int = 1024):
    """Escapes a ``chunk``-element row under ``cb`` of bf16 leaves and of
    f32 leaves' hi halves (an f32 value's exponent is its hi half's bf16
    exponent), as the codec and the ``fp32_hilo`` route see them."""
    book = torch.zeros(256, dtype=torch.bool, device=leaves[0].device)
    book[list(cb.exponents)] = True
    esc = rows = 0
    for x in leaves:
        view, shift = ((torch.int16, 7) if x.dtype == torch.bfloat16
                       else (torch.int32, 23))
        e = (x.reshape(-1).view(view).to(torch.int32) >> shift) & 0xFF
        miss = torch.nn.functional.pad(~book[e.to(torch.int64)],
                                       (0, (-x.numel()) % chunk))
        esc += int(miss.sum())
        rows += miss.numel() // chunk
    return dict(escapes=esc, rows=rows, per_row=esc / rows)


def train_attention(torch, cfg, device):
    """One layer's training attention at the step's shapes, CUDA events:
    ``chunked_attention`` forward alone (remat's first pass runs without
    grad) and forward + backward (the recompute and the backward), beside
    ``scaled_dot_product_attention`` (causal, GQA) forward + backward, the
    library yardstick of a fused backward.  Bound: the causal half of
    both products, forward and backward (2.5x forward), on the bf16
    tensor cores, over the q/k/v/o and their gradients' bytes."""
    from repro_torch.kernels.timing import cuda_ms
    from repro_torch.models import layers as L
    gen = torch.Generator(device=device).manual_seed(5)
    b, s, h, hkv, d = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16).requires_grad_(True)

    q, k, v = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    go = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)

    def fwd():
        with torch.no_grad():
            L.chunked_attention(q, k, v, causal=True, kv_block=min(s, 1024))

    def fwd_bwd():
        L.chunked_attention(q, k, v, causal=True,
                            kv_block=min(s, 1024)).backward(go)

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        o.backward(go.transpose(1, 2))

    torch.cuda.reset_peak_memory_stats()
    f, fb, lib = cuda_ms(fwd, 3), cuda_ms(fwd_bwd, 3), cuda_ms(sdpa, 3)
    flops = 3.5 * 2.0 * b * h * (s * s / 2) * 2 * d     # fwd + 2.5x fwd
    nbytes = 2 * 2 * (2 * b * s * h * d + 2 * b * s * hkv * d)
    bound, by = bound_ms(nbytes, flops, H100_BF16_OPS_PER_S)
    return dict(geometry=dict(B=b, S=s, H=h, Hkv=hkv, d=d), chunked_fwd_ms=f,
                chunked_fwd_bwd_ms=fb, per_layer_ms=f + fb,
                sdpa_fwd_bwd_ms=lib, bound_ms=bound, bound_by=by,
                peak_gb=_peak_gb(torch))


def train_rank(torch, rank, device):
    """Phase ``train`` (a): one process, 4 steps uninterrupted, then the
    ``ResilientTrainer`` run with a crash at step 3 restored from the
    step-2 checkpoint."""
    import shutil
    import tempfile
    import warnings

    from repro_torch.configs.base import get_config
    from repro_torch.core import tree as TR
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.distributed.fault_tolerance import (FaultConfig,
                                                         ResilientTrainer)
    from repro_torch.launch import train as LT

    _deterministic(torch)
    cfg = get_config(ARCH)
    out = {"warnings": []}

    def make():
        return LT.make_run(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                           steps=TRAIN_STEPS, seed=0, device=device)

    def recording(step_at, log):
        def step_fn(state, i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, metrics), launches = counted(step_at, state, i)
            loss = float(metrics["loss"])
            log.append(dict(step=i, loss=loss, ms=(time.perf_counter() - t0) * 1e3,
                            flash=launches["flash_attention"],
                            grad_norm=float(metrics["grad_norm"]),
                            lr=float(metrics["lr"])))
            return state, metrics
        return step_fn

    with warnings.catch_warnings(record=True) as caught:
        torch.cuda.reset_peak_memory_stats()
        state0, step_at = make()
        whole, snaps = [], {}

        def keep(step, state):
            snaps[step] = _clone_state(state)

        def no_restore():
            raise AssertionError("train: the uninterrupted run restored")

        ResilientTrainer(recording(step_at, whole), keep, no_restore,
                         FaultConfig(checkpoint_every=TRAIN_EVERY)).run(
            state0, TRAIN_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del state0
        at3 = snaps[TRAIN_EVERY]
        escapes = {name: _escapes(torch, TR.leaves(tree), CKPT.CKPT_CODEBOOK)
                   for name, tree in (("params_bf16", at3.params),
                                      ("m_hi", at3.opt.m), ("v_hi", at3.opt.v))}

        (ROOT / "build").mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=ROOT / "build"))
        try:
            state0, step_at = make()
            ck = CKPT.Checkpointer(str(tmp), device=device)
            saved, io, restored = {}, {"save": [], "restore": []}, []
            save, restore = ck.save, ck.restore

            def timed(kind, fn, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, launches = counted(fn, *args)
                torch.cuda.synchronize()
                io[kind].append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                     launches={k: launches[k] for k in
                                               (*KERNELS, "flash_attention")}))
                return res

            def ck_save(step, state, extra=None):
                saved[step] = _clone_state(state)
                return timed("save", save, step, state, extra)

            def ck_restore(like, step=None):
                res = timed("restore", restore, like, step)
                restored.append(res)
                return res

            ck.save, ck.restore = ck_save, ck_restore
            fired = set()

            def crash(step):
                if step == TRAIN_CRASH and step not in fired:
                    fired.add(step)
                    return "crash"
                return None

            resumed = []
            report = ResilientTrainer(recording(step_at, resumed),
                                      cfg=FaultConfig(checkpoint_every=TRAIN_EVERY),
                                      fault_source=crash, checkpointer=ck).run(
                state0, TRAIN_STEPS)
            final = saved[TRAIN_STEPS]
            # one traced step: device time by kernel, and the busy share
            wall_ms, dev, _ = profiled(torch, lambda: step_at(_clone_state(final), 0))
            busy_ms = sum(ms for ms, _, _ in dev)
            out["traced_step"] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                                      busy_share=busy_ms / wall_ms,
                                      top_device=dev[:12])
            raw_bytes = sum(x.numel() * x.element_size()
                            for x in TR.leaves(saved[TRAIN_EVERY]))
            dir_bytes = CKPT.checkpoint_bytes(str(tmp), TRAIN_EVERY)
            stats = ck.stats
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out["warnings"] = _nondeterministic_warnings(caught)
    # the SDPA yardstick's backward (cuDNN) is not deterministic: timed
    # outside the window whose warnings the phase reports
    out["attention"] = train_attention(torch, cfg, device)
    (r_state, _extra, r_step), = restored
    if r_step != TRAIN_EVERY:
        raise AssertionError(f"train: restored step {r_step}, want {TRAIN_EVERY}")
    losses = [x["loss"] for x in whole + resumed]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    out["restored_bitwise_saved"] = _bits_equal_trees(r_state, saved[TRAIN_EVERY])
    out["restored_bitwise_uninterrupted"] = _bits_equal_trees(
        r_state, snaps[TRAIN_EVERY])
    by_step = {x["step"]: x["loss"] for x in whole}
    out["resumed_losses_bitwise"] = [x["loss"] for x in resumed] == \
        [by_step[x["step"]] for x in resumed]
    out["final_state_bitwise"] = _bits_equal_trees(final, snaps[TRAIN_STEPS])
    if not (out["restored_bitwise_saved"] and out["restored_bitwise_uninterrupted"]
            and out["resumed_losses_bitwise"] and out["final_state_bitwise"]):
        raise AssertionError(f"train: crash/resume is not bitwise: "
                             f"{ {k: v for k, v in out.items() if k != 'warnings'} }; "
                             f"nondeterministic ops: {out['warnings']}")
    steady = [x["ms"] for x in whole[1:]]
    out.update(
        steps=whole, resumed_steps=resumed,
        report=dict(steps_completed=report.steps_completed,
                    restarts=report.restarts, final_loss=report.final_loss),
        first_step_ms=whole[0]["ms"], step_ms=statistics.median(steady),
        step_ms_all=steady,
        tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (statistics.median(steady) / 1e3),
        peak_gb=peak_gb, save=io["save"], restore=io["restore"],
        checkpoint_raw_bytes=raw_bytes, checkpoint_directory_bytes=dir_bytes,
        checkpoint_ratio=raw_bytes / dir_bytes,
        leaf_wire_bytes=stats.leaf_wire_bytes,
        fp32_lo_wire_bytes=stats.fp32_lo_wire_bytes,
        raw_passthrough_bytes=stats.raw_passthrough_bytes,
        escapes=escapes,
        global_reencodes_per_save=[s["launches"]["encode_dense"] for s in io["save"]],
        flash_in_steps=sum(x["flash"] for x in whole + resumed))
    return out


def train_ring_rank(torch, rank, device):
    """Phase ``train`` (b): one of two pods of ``--mesh 2,1,1
    --grad-compress`` training under the launcher's policy, the global
    batch split across the ranks.  First one step as the
    launcher runs it, under the default gradient codebook (the KV cache's
    exponents 112-127): smollm's gradients at initialisation escape past
    the ring's capacity there, every stream re-runs raw and nothing is
    decoded (window ``train_ring_default``).  Then ``TRAIN_RING_STEPS``
    steps of a fresh run under a codebook calibrated on pod 0's gradients
    of that first step, which only a caller of ``make_run`` can hand the
    ring (window ``train_ring``).  Every step: the rank's averaged
    gradients against the f32 mean of both pods' half-batch gradients."""
    import hashlib
    import warnings

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree as TR
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import grad_compress as GC
    from repro_torch.training import train_step as TS
    from repro_torch.training.data import DataConfig, SyntheticTokenStream

    _deterministic(torch)
    cfg = get_config(ARCH)
    # the launcher's policy for --mesh TRAIN_RANKS,1,1
    policy = ShardingPolicy(make_mesh((TRAIN_RANKS, 1, 1), MESH_AXES))
    rings = []
    orig = GC.compressed_cross_pod_mean_own

    def ring(own, mesh_, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, launches = counted(lambda: orig(own, mesh_, **kw))
        torch.cuda.synchronize()
        rings.append(dict(ms=(time.perf_counter() - t0) * 1e3, launches=launches,
                          own=own, mean=mean))
        return mean

    half = TRAIN_BATCH // TRAIN_RANKS
    data = SyntheticTokenStream(cfg, ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                DataConfig(seed=0), device=device)

    def run(codebook, n_steps):
        """``n_steps`` of a fresh launcher run (seed 0): each step's record,
        and pod 0's gradients of the first step (this rank's own on rank
        0, the ones it computes for the other pod on rank 1)."""
        book = {} if codebook is None else {"grad_codebook": codebook}
        state, step_at = LT.make_run(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                     lr=TRAIN_LR, steps=n_steps, seed=0,
                                     device=device, policy=policy,
                                     grad_compress=True, **book)
        records, pod0 = [], None
        for i in range(n_steps):
            before = state.params
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_at(state, i)
            loss = float(metrics["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            r = rings[-1]
            # the other pod's half-batch gradients, computed here
            other = 1 - rank
            batch = {k: v[other * half:(other + 1) * half]
                     for k, v in data.batch_at(i).items()}
            _, theirs = TS.value_and_grad(before, batch, cfg,
                                          kv_block=min(TRAIN_SEQ, 1024))
            if i == 0:
                pod0 = r["own"] if rank == 0 else theirs
            want = TR.unflatten(TR.flatten_with_path(theirs)[1], [
                ((a.float() + b.float()) / TRAIN_RANKS).to(b.dtype)
                for a, b in zip(TR.leaves(r["own"]), TR.leaves(theirs))])
            bitwise = _bits_equal_trees(r["mean"], want) and all(
                m.dtype == p.dtype for m, p in zip(TR.leaves(r["mean"]),
                                                   TR.leaves(before)))
            del theirs, before, want
            sha = hashlib.sha256()
            for x in TR.leaves(state.params):
                sha.update(x.view(torch.int16).cpu().numpy().tobytes())
            sess = next(s for s in GC._SESSIONS.values()
                        if s.last_stats is GC.last_stats)
            routes = sess.plan.routes
            records.append(dict(
                step=i, loss=loss, ms=ms, ring_ms=r["ms"],
                ring_share=r["ms"] / ms, mean_bitwise=bitwise,
                params_sha=sha.hexdigest(),
                sent_bytes=sess.last_comm.sent_bytes,
                recv_bytes=sess.last_comm.recv_bytes,
                wire_bytes_model=GC.cross_pod_wire_bytes(
                    r["own"], n_pod=TRAIN_RANKS, compress=True,
                    codebook=codebook or GC.DEFAULT_GRAD_CODEBOOK),
                leaf_ok=GC.last_stats.leaf_ok,
                raw_refetches=GC.last_stats.raw_refetches,
                routed_raw=[x.key for x in routes if x.route == "raw"],
                routed_splitzip=sum(x.route == "splitzip" for x in routes),
                launches={k: r["launches"][k] for k in (*KERNELS, "flash_attention")}))
            del r["own"], r["mean"]
        return records, pod0

    GC.compressed_cross_pod_mean_own = ring
    try:
        with warnings.catch_warnings(record=True) as caught:
            default, g0 = run(None, 1)
            cb = GC.calibrate_on_grads(g0)
            default_escapes, calibrated_escapes = (
                {TR.leaf_key(p): _escapes(torch, [x], book)["per_row"]
                 for p, x in TR.flatten_with_path(g0)[0]}
                for book in (GC.DEFAULT_GRAD_CODEBOOK, cb))
            del g0
            steps, _ = run(cb, TRAIN_RING_STEPS)
    finally:
        GC.compressed_cross_pod_mean_own = orig
    return dict(rank=rank, default_steps=default, steps=steps,
                codebook=list(cb.exponents), codebook_json=cb.to_json(),
                escapes_default_codebook=default_escapes,
                escapes_calibrated=calibrated_escapes,
                warnings=_nondeterministic_warnings(caught))


def phase_train(torch, smi):
    t0 = time.perf_counter()
    (one,) = run_ranks("train_rank", 1)
    single_s = time.perf_counter() - t0
    for s in one["save"]:
        need_launches("train_save", s["launches"], ("encode_fused",))
    need_launches("train_restore", one["restore"][0]["launches"], ("decode_fused",))
    ranks = run_ranks("train_ring_rank", TRAIN_RANKS)
    ring_s = time.perf_counter() - t0 - single_s
    if len({tuple(r["codebook"]) for r in ranks}) != 1:
        raise AssertionError("train ring: the ranks calibrated different "
                             "gradient codebooks")
    for run in ("default_steps", "steps"):
        for i in range(len(ranks[0][run])):
            if len({r[run][i]["params_sha"] for r in ranks}) != 1:
                raise AssertionError(f"train ring ({run}): the ranks' "
                                     f"parameters differ after step {i}")
            for r in ranks:
                st = r[run][i]
                if not st["mean_bitwise"]:
                    raise AssertionError(
                        f"train ring ({run}): rank {r['rank']} step {i}: the "
                        "averaged gradients are not the f32 mean of the two "
                        "half-batch gradients")
                if not math.isfinite(st["loss"]):
                    raise AssertionError(f"train ring: loss {st['loss']}")
    # a stream is decoded only where its encode held, and a leaf that
    # overflows anywhere re-runs raw.  Window ``train_ring`` is the
    # calibrated run, both steps together: under this codebook only the
    # norm leaves hold, at step 1 (PERF.md §6).  Window
    # ``train_ring_default`` is the launcher's own step, reported: it
    # encodes, and decodes nothing when every stream overflows.
    for r in ranks:
        for run, window in (("steps", "launches"),
                            ("default_steps", "launches_default")):
            r[window] = {k: sum(st["launches"][k] for st in r[run])
                         for k in (*KERNELS, "flash_attention")}
        need_launches(f"train_ring rank {r['rank']}", r["launches"],
                      ("encode_fused", "decode_fused"))
        need_launches(f"train_ring_default rank {r['rank']}",
                      r["launches_default"], ("encode_fused",))
    windows = {"train_save": one["save"][0]["launches"],
               "train_restore": one["restore"][0]["launches"],
               "train_ring": ranks[0]["launches"],
               "train_ring_default": ranks[0]["launches_default"],
               "train_steps": {"flash_attention": one["flash_in_steps"]}}
    flash = {w: c.get("flash_attention", 0) for w, c in windows.items()}
    flash.update({f"{w} rank {r['rank']}": r[key]["flash_attention"]
                  for r in ranks for w, key in (("train_ring", "launches"),
                                                ("train_ring_default",
                                                 "launches_default"))})
    if any(flash.values()):
        raise AssertionError(f"train: the flash kernel launched in a train "
                             f"window: {flash}")
    emit(phase="train", nvidia_smi=smi, arch=ARCH, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, steps=TRAIN_STEPS,
         checkpoint_every=TRAIN_EVERY, crash_at=TRAIN_CRASH,
         single=one, ring=dict(ranks=ranks, ranks_n=TRAIN_RANKS,
                               steps=TRAIN_RING_STEPS, default_steps=1,
                               transport="gloo"),
         seconds=dict(single=single_s, ring=ring_s,
                      phase=time.perf_counter() - t0),
         flash_launches=flash)
    return {w: {k: c.get(k, 0) for k in (*KERNELS, "flash_attention")}
            for w, c in windows.items()}, ranks[0]["codebook_json"]


# ---------------------------------------------------------------------------
# phase shard: the sharding policy and the sharded train step across ranks
# ---------------------------------------------------------------------------

SHARD_STEPS = 2
#: phases shard and tp train smollm-135m at full width cut to this depth
#: (at 30 layers they took 98 and 110 s of a 1092-s run of this script on
#: an H100 80GB HBM3 at 700 W; the layers repeat, so the gates read the
#: same arithmetic)
SHARD_LAYERS = 4
SHARD_FSDP_MESH, SHARD_RING_MESH = (1, 2, 1), (2, 2, 1)
MESH_AXES = ("pod", "data", "model")
# the sharded step against the single-process one, the bounds of
# tests/test_torch_shard_train.py: loss, grad-norm rtol, and each leaf's
# relative L2 norm for the parameters and the moments
SHARD_CE_ATOL, SHARD_GN_RTOL, SHARD_PARAM_RTOL, SHARD_MOMENT_RTOL = \
    2e-3, 5e-3, 5e-3, 5e-2


def _sha_tree(torch, tree) -> str:
    import hashlib

    from repro_torch.core import tree as TR
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sha = hashlib.sha256()
    for x in TR.leaves(tree):
        sha.update(x.contiguous().view(width[x.element_size()]).cpu()
                   .numpy().reshape(-1))
    return sha.hexdigest()


def _held(state):
    from repro_torch.core import tree as TR
    return {k: sum(x.numel() * x.element_size() for x in TR.leaves(t))
            for k, t in (("params", state.params), ("m", state.opt.m),
                         ("v", state.opt.v))}


def _spec_bytes(like, policy):
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import train_step as TS
    specs = TS.state_specs(policy, like)
    return {k: SH.held_bytes(t, s, policy.sizes) for k, t, s in (
        ("params", like.params, specs.params), ("m", like.opt.m, specs.opt.m),
        ("v", like.opt.v, specs.opt.v))}


def _comm_record():
    from repro_torch.training import train_step as TS
    return {k: dict(ms=c.seconds * 1e3, wire_ms=c.wire_s * 1e3,
                    staging_ms=c.staging_s * 1e3, sent_bytes=c.sent_bytes,
                    recv_bytes=c.recv_bytes)
            for k, c in TS.last_comm.items()}


def _sharded_steps(torch, step_at, state, n_steps):
    """``n_steps`` of a placed run, each timed (host clock around a
    synchronized step) and counted: ``(state, records, launches)``."""
    records, total = [], {}
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, metrics), launches = counted(step_at, state, i)
        torch.cuda.synchronize()
        records.append(dict(step=i, ms=(time.perf_counter() - t0) * 1e3,
                            **{k: float(v) for k, v in metrics.items()},
                            comm=_comm_record()))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return state, records, total


def shard_fsdp_rank(torch, rank, device):
    """Phase ``shard`` (a): 2 ranks on mesh (pod 1, data 2, model 1),
    smollm-135m at full width cut to ``SHARD_LAYERS`` layers, batch 8 x
    2048 (4 sequences a rank),
    ``SHARD_STEPS`` steps through ``make_run(policy=)``, with ``fsdp`` on
    and off.  Each run: the bytes this rank holds against the spec
    arithmetic, peak memory, step ms, the gather / reduce traffic, the
    gathered state's hash.  Rank 0 then runs the single-process step on
    the same global batches and holds the FSDP run's gathered state to it
    within the bounds of ``tests/test_torch_shard_train.py``."""
    import warnings

    from repro_torch.core import tree as TR
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_step as TS

    _deterministic(torch)
    cfg = _depth_cut(ARCH, SHARD_LAYERS)
    mesh = make_mesh(SHARD_FSDP_MESH, MESH_AXES)
    like = TS.abstract_state(cfg)
    out, keep = {"rank": rank, "runs": {}}, None
    with warnings.catch_warnings(record=True) as caught:
        for fsdp in (True, False):
            policy = ShardingPolicy(mesh, fsdp=fsdp)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, step_at = LT.make_run(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                         lr=TRAIN_LR, steps=SHARD_STEPS,
                                         seed=0, device=device, policy=policy)
            held = _held(state)
            state, records, launches = _sharded_steps(torch, step_at, state,
                                                      SHARD_STEPS)
            peak = _peak_gb(torch)
            t0 = time.perf_counter()
            whole = TS.gather_state(state, policy, like)
            torch.cuda.synchronize()
            gather_ms = (time.perf_counter() - t0) * 1e3
            out["runs"]["fsdp" if fsdp else "replicated"] = dict(
                held=held, spec_bytes=_spec_bytes(like, policy),
                steps=records, peak_gb=peak, launches=launches,
                gather_state_ms=gather_ms, sha=_sha_tree(torch, whole))
            if fsdp and rank == 0:
                keep = whole
            del state, whole, step_at
        if rank == 0:
            out["reference"] = _against_single(torch, cfg, keep,
                                               out["runs"]["fsdp"]["steps"])
            del keep
            out["embedding_backward"] = _embedding_backward(torch, cfg, device)
    out["warnings"] = _nondeterministic_warnings(caught)
    return out


def _embedding_backward(torch, cfg, device):
    """The token lookup's backward at the train batch's tokens (a random
    upstream gradient) against an f32 ``index_add_``, relative L2: the
    model's lookup (``embed_inputs``: ``F.embedding``, which sums a
    token's rows in f32 on the card) beside indexing (which sums them in
    bf16)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as M
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    tokens = SyntheticTokenStream(
        cfg, ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train"),
        DataConfig(seed=0), device=device).batch_at(0)["tokens"]
    gen = torch.Generator(device=device).manual_seed(3)
    w = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                     device=device) * 0.02).to(torch.bfloat16)
    up = torch.randn(tuple(tokens.shape) + (cfg.d_model,), generator=gen,
                     device=device).to(torch.bfloat16)
    ref = torch.zeros(w.shape, device=device).index_add_(
        0, tokens.reshape(-1).long(), up.reshape(-1, cfg.d_model).float())
    out = {"top_token_count": int(torch.bincount(tokens.reshape(-1)).max())}
    for name, look in (
            ("lookup", lambda p: M.embed_inputs({"embed": p},
                                                {"tokens": tokens}, cfg)),
            ("indexing", lambda p: p[tokens])):
        p = w.clone().requires_grad_(True)
        (look(p).float() * up.float()).sum().backward()
        out[name] = float(torch.linalg.vector_norm(p.grad.float() - ref)
                          / torch.linalg.vector_norm(ref))
    return out


def _against_single(torch, cfg, sharded, steps, batch=TRAIN_BATCH):
    """The single-process step (``make_run`` without a policy) on the same
    batches against the sharded run: the bounds and the worst leaf."""
    from repro_torch.core import tree as TR
    from repro_torch.launch import train as LT
    device = TR.leaves(sharded)[0].device
    state, step_at = LT.make_run(cfg, batch=batch, seq=TRAIN_SEQ,
                                 lr=TRAIN_LR, steps=SHARD_STEPS, seed=0,
                                 device=device)
    metrics = []
    for i in range(SHARD_STEPS):
        state, m = step_at(state, i)
        metrics.append({k: float(v) for k, v in m.items()})
    worst, leaf = {"params": 0.0, "moments": 0.0}, {}
    for (path, a), b in zip(TR.flatten_with_path(state)[0], TR.leaves(sharded)):
        if a.dim() == 0:
            continue
        a32, b32 = a.float(), b.float()
        r = float(torch.linalg.vector_norm(a32 - b32)
                  / torch.clamp(torch.linalg.vector_norm(a32), min=1e-30))
        key = "params" if path[0] == ".params" else "moments"
        if r >= worst[key]:
            worst[key], leaf[key] = r, TR.leaf_key(path)
    loss = max(abs(s["loss"] - m["loss"]) for s, m in zip(steps, metrics))
    gn = max(abs(s["grad_norm"] - m["grad_norm"]) / m["grad_norm"]
             for s, m in zip(steps, metrics))
    ok = (loss <= SHARD_CE_ATOL and gn <= SHARD_GN_RTOL
          and worst["params"] <= SHARD_PARAM_RTOL
          and worst["moments"] <= SHARD_MOMENT_RTOL
          and all(s["lr"] == m["lr"] for s, m in zip(steps, metrics)))
    return dict(ok=ok, loss_abs=loss, grad_norm_rel=gn,
                params_rel_l2=worst["params"], moments_rel_l2=worst["moments"],
                worst_leaf=leaf,
                single_losses=[m["loss"] for m in metrics])


def shard_mesh_rank(torch, rank, device, grad_book):
    """Phase ``shard`` (b) and (c), 4 ranks on mesh (pod 2, data 2, model
    1).  (b) One step of smollm-135m at full width cut to
    ``SHARD_LAYERS`` layers, batch 8 x 2048 (2 sequences a rank),
    ``fsdp=True`` and ``grad_compress`` under the gradient codebook
    phase ``train`` calibrates: the data-reduced shards cross pods
    through the compressed ring (window ``shard_ring``, counted in the
    rank).  (c) The ``pd_disaggregated`` policy's ``cache_specs``
    drive that model's served cache (B 8 x 2048, prefilled on both pod-0
    ranks) pod 0 -> 1: each source sends its data shard, each destination
    receives the shard of its data coordinate (windows ``shard_hop_src``
    / ``shard_hop_dst``); the shards' hashes come back to the parent."""
    import torch.distributed as dist

    from repro_torch.core import tree as TR
    from repro_torch.core.codebook import Codebook
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import serve
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DisaggregatedEngine
    from repro_torch.serving.plan import TransferConfig, TransferPlan
    from repro_torch.training import grad_compress as GC
    from repro_torch.training import train_step as TS

    _deterministic(torch)
    cfg = _depth_cut(ARCH, SHARD_LAYERS)
    mesh = make_mesh(SHARD_RING_MESH, MESH_AXES)
    pod, data = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    out = {"rank": rank, "pod": pod, "data": data}
    # (b) the pod ring on the data-reduced shards
    policy = ShardingPolicy(mesh, fsdp=True)
    torch.cuda.reset_peak_memory_stats()
    state, step_at = LT.make_run(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, steps=1, seed=0,
        device=device, policy=policy, grad_compress=True,
        grad_codebook=Codebook.from_json(grad_book))
    held = _held(state)
    state, records, launches = _sharded_steps(torch, step_at, state, 1)
    sess = next(s for s in GC._SESSIONS.values() if s.last_stats is GC.last_stats)
    out["ring"] = dict(
        held=held, spec_bytes=_spec_bytes(TS.abstract_state(cfg), policy),
        steps=records, launches=launches, peak_gb=_peak_gb(torch),
        leaf_ok=GC.last_stats.leaf_ok, raw_refetches=GC.last_stats.raw_refetches,
        ring_sent_bytes=sess.last_comm.sent_bytes,
        ring_recv_bytes=sess.last_comm.recv_bytes,
        ring_ms=sess.last_comm.seconds * 1e3,
        sha=_sha_tree(torch, TS.gather_state(state, policy,
                                             TS.abstract_state(cfg))))
    del state, step_at
    torch.cuda.empty_cache()
    # (c) the policy-specified mesh hop
    policy = ShardingPolicy(mesh, pd_disaggregated=True)
    if pod == 0:
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                               device)
        book = [serve.calibrate_on_model(cfg, params, device=device, seed=1)
                .to_json() if rank == 0 else None]
    else:
        book = [None]
    dist.broadcast_object_list(book, src=0)
    cb = Codebook.from_json(book[0])
    if pod == 0:
        prompt = serve.make_prompt(cfg, BATCH, PROMPT, device=device, seed=2)
        eng = DisaggregatedEngine(cfg, params, cb, backend="cuda", device=device)
        max_seq = serve.prompt_positions(cfg, prompt) + 1 + NEW_TOKENS
        cache = eng.prefill(prompt, max_seq).state.cache
        del eng, params
        shapes = [(tuple(x.shape), str(x.dtype).split(".")[-1])
                  for x in TR.leaves(cache)]
    meta = [shapes if rank == 0 else None]
    dist.broadcast_object_list(meta, src=0)
    if pod != 0:
        cache = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
                 for k, (s, d) in zip(("k", "v"), meta[0])}
    specs = policy.cache_specs(cache)
    plan = TransferPlan.build(cache, TransferConfig(codebook=cb, backend="cuda"),
                              mesh=mesh, specs=specs)
    sess = plan.session(device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard, hop_launches = counted(lambda: sess.transfer(
        cache if pod == 0 else None, select_dst=False))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mine = (TR.unflatten(plan.treedef, [
        SH.shard_slice(x, s, mesh) for x, s in zip(TR.leaves(cache),
                                                    plan.in_specs)])
        if pod == 0 else shard)
    st = sess.last_stats
    out["hop"] = dict(
        in_specs=[list(s) for s in plan.in_specs], sha=_sha_tree(torch, mine),
        launches=hop_launches, ok=bool(all(st.leaf_ok.values())
                                       and all(st.chunk_ok)),
        wire_bytes=st.wire_bytes, raw_bytes=float(sum(
            x.numel() * x.element_size() for x in TR.leaves(mine))),
        **_comm(sess, seconds))
    return out


def phase_shard(torch, smi, grad_book):
    t0 = time.perf_counter()
    a = run_ranks("shard_fsdp_rank", SHARD_FSDP_MESH[1])
    a_s = time.perf_counter() - t0
    for tag in ("fsdp", "replicated"):
        if len({r["runs"][tag]["sha"] for r in a}) != 1:
            raise AssertionError(f"shard ({tag}): the ranks gathered "
                                 "different states")
    if a[0]["runs"]["fsdp"]["sha"] != a[0]["runs"]["replicated"]["sha"]:
        raise AssertionError("shard: FSDP on and off are not bitwise equal")
    for r in a:
        for tag, run in r["runs"].items():
            if run["held"] != run["spec_bytes"]:
                raise AssertionError(f"shard ({tag}) rank {r['rank']}: holds "
                                     f"{run['held']}, the specs give "
                                     f"{run['spec_bytes']}")
            for st in run["steps"]:
                if not math.isfinite(st["loss"]):
                    raise AssertionError(f"shard ({tag}): loss {st['loss']}")
    if not a[0]["reference"]["ok"]:
        raise AssertionError(f"shard: the sharded step left the single-process "
                             f"step's bounds: {a[0]['reference']}")
    if a[0]["embedding_backward"]["lookup"] > 2 ** -8:
        raise AssertionError(f"shard: the token lookup's gradient is more than "
                             f"one bf16 rounding from its f32 sum: "
                             f"{a[0]['embedding_backward']}")
    t1 = time.perf_counter()
    bc = run_ranks("shard_mesh_rank", math.prod(SHARD_RING_MESH), grad_book)
    bc_s = time.perf_counter() - t1
    if len({r["ring"]["sha"] for r in bc}) != 1:
        raise AssertionError("shard ring: the ranks' gathered parameters differ")
    for r in bc:
        if r["ring"]["held"] != r["ring"]["spec_bytes"]:
            raise AssertionError(f"shard ring rank {r['rank']}: holds "
                                 f"{r['ring']['held']}, the specs give "
                                 f"{r['ring']['spec_bytes']}")
    need_launches("shard_ring rank 0", bc[0]["ring"]["launches"],
                  ("encode_fused", "decode_fused"))
    src = {r["data"]: r for r in bc if r["pod"] == 0}
    for r in bc:
        if r["pod"] == 1 and r["hop"]["sha"] != src[r["data"]]["hop"]["sha"]:
            raise AssertionError(f"shard hop: rank {r['rank']}'s shard is not "
                                 "the one its source sent")
        need_launches(f"shard_hop rank {r['rank']}", r["hop"]["launches"],
                      ("encode_fused",) if r["pod"] == 0 else ("decode_fused",))
    windows = {"shard_ring": bc[0]["ring"]["launches"],
               "shard_hop_src": bc[0]["hop"]["launches"],
               "shard_hop_dst": next(r for r in bc if r["pod"] == 1)["hop"]["launches"]}
    flash = {f"{w} rank {r['rank']}": r[k]["launches"]["flash_attention"]
             for r in bc for w, k in (("shard_ring", "ring"),)}
    flash.update({f"shard_fsdp {tag} rank {r['rank']}":
                  r["runs"][tag]["launches"]["flash_attention"]
                  for r in a for tag in r["runs"]})
    if any(flash.values()):
        raise AssertionError(f"shard: the flash kernel launched in a train "
                             f"window: {flash}")
    emit(phase="shard", nvidia_smi=smi, arch=ARCH, layers=SHARD_LAYERS,
         batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, transport="gloo",
         fsdp=dict(mesh=list(SHARD_FSDP_MESH), steps=SHARD_STEPS, ranks=a,
                   bitwise_on_off=True),
         ring=dict(mesh=list(SHARD_RING_MESH), steps=1, fsdp=True,
                   ranks=[dict(r["ring"], rank=r["rank"]) for r in bc]),
         hop=dict(mesh=list(SHARD_RING_MESH), pd_disaggregated=True,
                  ranks=[dict(r["hop"], rank=r["rank"], pod=r["pod"],
                              data=r["data"]) for r in bc]),
         seconds=dict(fsdp=a_s, ring_and_hop=bc_s,
                      phase=time.perf_counter() - t0))
    return {w: {k: c.get(k, 0) for k in (*KERNELS, "flash_attention")}
            for w, c in windows.items()}


# ---------------------------------------------------------------------------
# phase tp: tensor-parallel training over the model axis across ranks
# ---------------------------------------------------------------------------

TP_BATCH, TP_STEPS = 4, 2
TP_HEADS_MESH, TP_SEQ_MESH = (1, 1, 3), (1, 2, 2)


def tp_rank(torch, rank, device, shape, fsdp):
    """Phase ``tp``: smollm-135m at full width cut to ``SHARD_LAYERS``
    layers on mesh ``shape``, batch
    ``TP_BATCH`` x 2048, ``TP_STEPS`` steps through ``make_run(policy=)``
    (``fsdp`` on the data axis).  (a) (1, 1, 3): 9 / 3 heads split over 3
    model ranks (attention case ``heads``); (b) (1, 2, 2): 9 heads do not
    split over 2, the ``seq`` fallback.  Each rank: its attention case,
    the bytes it holds against the spec arithmetic, step ms and the step's
    traffic (``train_step.last_comm``: activation collectives forward and
    backward, parameter gathers over data, gradient reduction, norm),
    the parameter-gather bytes the data axis alone accounts for, peak
    memory, the hash of its shards of the leaves replicated over
    ``model`` and of the gathered state.  Rank 0 then runs the
    single-process step on the same batches and holds the gathered state
    to it within the ``SHARD_*`` bounds."""
    import warnings

    from repro_torch.core import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.collective import _padded
    from repro_torch.training import train_step as TS

    _deterministic(torch)
    cfg = _depth_cut(ARCH, SHARD_LAYERS)
    mesh = make_mesh(shape, MESH_AXES)
    policy = SH.ShardingPolicy(mesh, fsdp=fsdp)
    like = TS.abstract_state(cfg)
    specs = SH.leaf_specs(TS.state_specs(policy, like), like)
    out = {"rank": rank, "coord": SH.coordinate(mesh),
           "case": TP.TensorParallel(mesh.get_group("model"), cfg)
           .attention(TRAIN_SEQ)}
    seconds, t0 = {}, time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step_at = LT.make_run(cfg, batch=TP_BATCH, seq=TRAIN_SEQ,
                                     lr=TRAIN_LR, steps=TP_STEPS, seed=0,
                                     device=device, policy=policy)
        seconds["setup"] = time.perf_counter() - t0
        out["held"] = _held(state)
        out["spec_bytes"] = _spec_bytes(like, policy)
        out["data_gather_bytes"] = sum(
            _padded(x.numel() * x.element_size())
            for x, s in zip(TR.leaves(state.params), specs)
            if SH.splits(SH.restrict(s, ("data",)), policy.sizes))
        t0 = time.perf_counter()
        state, out["steps"], out["launches"] = _sharded_steps(
            torch, step_at, state, TP_STEPS)
        seconds["steps"] = time.perf_counter() - t0
        out["peak_gb"] = _peak_gb(torch)
        t0 = time.perf_counter()
        out["replicated_sha"] = _sha_tree(torch, [
            x for x, s in zip(TR.leaves(state), specs)
            if not any("model" in SH.entry_axes(e) for e in s)])
        whole = TS.gather_state(state, policy, like)
        out["sha"] = _sha_tree(torch, whole)
        seconds["gather_and_hash"] = time.perf_counter() - t0
        del state, step_at
        if rank == 0:
            t0 = time.perf_counter()
            out["reference"] = _against_single(torch, cfg, whole, out["steps"],
                                               batch=TP_BATCH)
            seconds["reference"] = time.perf_counter() - t0
        del whole
    out["warnings"] = _nondeterministic_warnings(caught)
    out["seconds"] = seconds
    return out


def _tp_gates(tag, ranks, want_case):
    """Phase ``tp``'s gates on one run's ranks."""
    if {r["case"] for r in ranks} != {want_case}:
        raise AssertionError(f"tp ({tag}): attention case "
                             f"{[r['case'] for r in ranks]}, want {want_case}")
    if len({r["sha"] for r in ranks}) != 1:
        raise AssertionError(f"tp ({tag}): the ranks gathered different states")
    replicas = {}
    for r in ranks:
        c = r["coord"]
        replicas.setdefault((c["pod"], c["data"]), set()).add(r["replicated_sha"])
        if r["held"] != r["spec_bytes"]:
            raise AssertionError(f"tp ({tag}) rank {r['rank']}: holds "
                                 f"{r['held']}, the specs give {r['spec_bytes']}")
        for st in r["steps"]:
            if st["comm"]["gather"]["sent_bytes"] != r["data_gather_bytes"]:
                raise AssertionError(
                    f"tp ({tag}) rank {r['rank']}: parameter gathers of "
                    f"{st['comm']['gather']['sent_bytes']} bytes, the data axis "
                    f"accounts for {r['data_gather_bytes']}: a parameter "
                    "crossed the model group")
            if not math.isfinite(st["loss"]):
                raise AssertionError(f"tp ({tag}): loss {st['loss']}")
        if r["launches"]["flash_attention"]:
            raise AssertionError(f"tp ({tag}) rank {r['rank']}: the flash "
                                 "kernel launched in a train window")
    if any(len(v) != 1 for v in replicas.values()):
        raise AssertionError(f"tp ({tag}): a leaf replicated over model "
                             "differs between model ranks")
    if not ranks[0]["reference"]["ok"]:
        raise AssertionError(f"tp ({tag}): the sharded step left the "
                             f"single-process step's bounds: "
                             f"{ranks[0]['reference']}")


def phase_tp(torch, smi):
    t0 = time.perf_counter()
    a = run_ranks("tp_rank", math.prod(TP_HEADS_MESH), TP_HEADS_MESH, False)
    a_s = time.perf_counter() - t0
    _tp_gates("heads", a, "heads")
    b = run_ranks("tp_rank", math.prod(TP_SEQ_MESH), TP_SEQ_MESH, True)
    b_s = time.perf_counter() - t0 - a_s
    _tp_gates("seq", b, "seq")
    emit(phase="tp", nvidia_smi=smi, arch=ARCH, layers=SHARD_LAYERS,
         batch=TP_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, steps=TP_STEPS, transport="gloo",
         heads=dict(mesh=list(TP_HEADS_MESH), fsdp=False, ranks=a),
         seq_fallback=dict(mesh=list(TP_SEQ_MESH), fsdp=True, ranks=b),
         seconds=dict(heads=a_s, seq_fallback=b_s,
                      phase=time.perf_counter() - t0))
    return {w: {k: r[0]["launches"].get(k, 0) for k in (*KERNELS, "flash_attention")}
            for w, r in (("tp_heads", a), ("tp_seq", b))}


# ---------------------------------------------------------------------------
# phase ep: MoE training under the model and data axes across ranks
# ---------------------------------------------------------------------------

#: one step (two took 133 s of the 1092-s run above)
EP_LAYERS, EP_BATCH, EP_STEPS = 2, 2, 1
EP_HEADS_MESH, EP_FSDP_MESH = (1, 1, 2), (1, 2, 2)


def ep_config():
    """qwen3-moe-30b-a3b at full width, cut in depth to ``EP_LAYERS``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=EP_LAYERS)


def ep_reference(torch, device, out_dir):
    """The single-process step (``make_run`` without a policy) on phase
    ``ep``'s batches: after each step the state's leaves as bf16 (the
    parameters as they are, the f32 moments rounded: 2^-9 against the
    moments' bound of 5e-2) saved under ``out_dir``, one file a step,
    which each rank maps (``torch.load(mmap=True)``) and reads its blocks
    of: the 18.7 GB state crosses neither gloo nor the ranks' share of
    the card; and the metrics."""
    from repro_torch.core import tree as TR
    from repro_torch.launch import train as LT
    cfg = ep_config()
    torch.cuda.reset_peak_memory_stats()
    state, step_at = LT.make_run(cfg, batch=EP_BATCH, seq=TRAIN_SEQ,
                                 lr=TRAIN_LR, steps=EP_STEPS, seed=0,
                                 device=device)
    steps, metrics = [], []
    for i in range(EP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_at(state, i)
        torch.cuda.synchronize()
        metrics.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                            **{k: float(v) for k, v in m.items()}))
        path = out_dir / f"step{i}.pt"
        torch.save([x.to(torch.bfloat16).cpu() for x in TR.leaves(state)],
                   path)
        steps.append(str(path))
    del state, step_at
    peak = _peak_gb(torch)
    torch.cuda.empty_cache()
    return dict(steps=steps, metrics=metrics, peak_gb=peak)


def _ep_drops(torch, cfg, records, device):
    """Each recorded layer's dropped choices on its first-step input:
    the run's (``route`` on the rank's rows, summed over the routing
    group), and on the same logits, the expert-parallel ``route_logits``
    of the rank's rows of the whole group batch's logits against the
    single-process ``route_logits`` of them all (slots and drops); whether
    the rank's own (T/n, d) x (d, E) router product gave the whole
    product's bits.  Every rank calls it (the group's gathers)."""
    from repro_torch.distributed import expert_parallel as EP
    from repro_torch.models import moe as MOE
    from repro_torch.serving import collective as CL
    mc = cfg.moe
    e = mc.num_experts
    out = []
    for x, router, group in records:
        ep = EP.ExpertParallel(cfg, group)
        xf = x.reshape(-1, x.shape[-1])
        t = xf.shape[0]
        cap = MOE.capacity(t * ep.size, mc)
        link = CL.Link(group, device, CL.CommStats()) if group is not None else None

        def group_sum(n):
            n = n.reshape(1)
            return int(torch.stack(link.all_gather(n)).sum() if link else n)

        whole = torch.cat(link.all_gather(xf)) if link else xf
        logits = torch.matmul(whole.float(), router)
        rows = slice(ep.rank * t, (ep.rank + 1) * t)
        own = torch.matmul(xf.float(), router)
        run = MOE.route(router, xf, mc, cap, ep)
        same = MOE.route_logits(logits[rows], mc, cap, ep)
        single = MOE.route_logits(logits, mc, cap)
        mine = torch.empty_like(same["slot"])
        mine[same["order"]] = same["slot"]
        every = torch.empty_like(single["slot"])
        every[single["order"]] = single["slot"]
        k = mc.top_k
        out.append(dict(
            cap=cap, cap_local=MOE.capacity(t, mc), group_size=ep.size,
            logits_bitwise=bool(torch.equal(own, logits[rows])),
            run_dropped=group_sum((run["slot"] == e * cap).sum()),
            dropped=group_sum((same["slot"] == e * cap).sum()),
            single_dropped=int((single["slot"] == e * cap).sum()),
            slots_bitwise=bool(torch.equal(
                mine, every[rows.start * k:rows.stop * k]))))
    return out


def _against_reference(torch, state, path, specs, mesh, coord, zero=None,
                       allow=0.0):
    """This rank's share of each leaf's distance to the reference leaves
    saved at ``path`` (bf16, mapped): ``[diff^2, ref^2]`` a leaf over its
    block, from the one rank of each block (coordinate 0 on every axis the
    leaf's spec does not name), else None.  ``zero`` maps the index of a
    parameter initialised to 0 (its AdamW updates alone) to the
    reference's first moment after one step, saved at that path: such a
    leaf's sums are taken over the elements whose first gradient exceeds
    ``ZERO_GRAD_FRAC`` of the leaf's largest, and it adds the largest
    excess of another element's distance over ``allow`` plus one bf16
    rounding (at most 0 where it holds), the number of elements whose
    distance exceeds half of ``allow`` (the flipped updates), and its
    element count."""
    from repro_torch.core import tree as TR
    from repro_torch.distributed import sharding as SH
    ref = torch.load(path, mmap=True)
    first = torch.load(zero["path"], mmap=True) if zero else {}
    out = []
    for i, (x, r, spec) in enumerate(zip(TR.leaves(state), ref, specs)):
        named = {a for e in spec for a in SH.entry_axes(e)}
        if x.dim() == 0 or any(coord[a] for a in coord if a not in named):
            out.append(None)
            continue
        a = SH.shard_slice(r, spec, mesh).to(x.device).float()
        b = x.float()
        if i not in first:
            out.append([float(torch.sum((a - b) ** 2)), float(torch.sum(a * a))])
            continue
        g = first[i].abs()
        above = SH.shard_slice(g, spec, mesh).to(x.device) > ZERO_GRAD_FRAC * g.max()
        gap = (a - b).abs()
        below = gap - allow - 2 ** -7 * torch.maximum(a.abs(), b.abs())
        out.append([float(torch.sum(((a - b) ** 2)[above])),
                    float(torch.sum((a * a)[above])),
                    float(torch.max(torch.where(above, -math.inf, below))),
                    int(torch.sum(gap > allow / 2)), a.numel()])
    return out


def ep_rank(torch, rank, device, shape, fsdp, ref):
    """Phase ``ep``: qwen3-moe-30b-a3b at full width, 2 layers, on mesh
    ``shape``, batch ``EP_BATCH`` x 2048, ``EP_STEPS`` steps through
    ``make_run(policy=)`` (``fsdp`` on the data axis).  (a) (1, 1, 2): 64
    experts, 16 / 2 heads and half the vocab a rank; (b) (1, 2, 2) with
    FSDP: one sequence a data rank (capacity 160 alone, 320 over the
    routing group).  Each rank: the bytes it holds against the spec
    arithmetic, step ms, the step's traffic (``train_step.last_comm``),
    the parameter-gather bytes the data axis alone accounts for, launches,
    peak memory, the hash of its leaves replicated over ``model``, its
    share of each leaf's distance to the single-process step's state
    after each step (``ref``: the files it is saved in), and each layer's dropped
    choices (``_ep_drops``)."""
    import warnings

    from repro_torch.core import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.serving.collective import _padded
    from repro_torch.training import train_step as TS

    _deterministic(torch)
    cfg = ep_config()
    mesh = make_mesh(shape, MESH_AXES)
    policy = SH.ShardingPolicy(mesh, fsdp=fsdp)
    like = TS.abstract_state(cfg)
    specs = SH.leaf_specs(TS.state_specs(policy, like), like)
    coord = SH.coordinate(mesh)
    out = {"rank": rank, "coord": coord, "steps": [], "against": []}
    seconds, t0 = {}, time.perf_counter()
    records, orig = [], MOE.moe_ffn

    def recording(p, x, mc, ep=None):
        if (ep is not None and len(records) < cfg.num_layers
                and torch._C._current_graph_task_id() == -1):
            records.append((x.detach().clone(), p["router"].detach().clone(),
                            ep.group))
        return orig(p, x, mc, ep)

    with warnings.catch_warnings(record=True) as caught:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step_at = LT.make_run(cfg, batch=EP_BATCH, seq=TRAIN_SEQ,
                                     lr=TRAIN_LR, steps=EP_STEPS, seed=0,
                                     device=device, policy=policy)
        torch.cuda.synchronize()
        seconds["setup"] = time.perf_counter() - t0
        out["setup_peak_gb"] = _peak_gb(torch)
        out["held"] = _held(state)
        out["spec_bytes"] = _spec_bytes(like, policy)
        out["data_gather_bytes"] = sum(
            _padded(x.numel() * x.element_size())
            for x, s in zip(TR.leaves(state.params), specs)
            if SH.splits(SH.restrict(s, ("data",)), policy.sizes))
        launches = {}
        MOE.moe_ffn = recording
        try:
            for i in range(EP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (state, metrics), counts = counted(step_at, state, i)
                torch.cuda.synchronize()
                out["steps"].append(dict(
                    step=i, ms=(time.perf_counter() - t0) * 1e3,
                    **{k: float(v) for k, v in metrics.items()},
                    comm=_comm_record()))
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                out["against"].append(_against_reference(
                    torch, state, ref["steps"][i], specs, mesh, coord))
        finally:
            MOE.moe_ffn = orig
        out["launches"] = launches
        out["peak_gb"] = _peak_gb(torch)
        out["replicated_sha"] = _sha_tree(torch, [
            x for x, s in zip(TR.leaves(state), specs)
            if not any("model" in SH.entry_axes(e) for e in s)])
        t0 = time.perf_counter()
        out["layers"] = _ep_drops(torch, cfg, records, device)
        seconds["drops"] = time.perf_counter() - t0
        del state, step_at, records
    out["warnings"] = _nondeterministic_warnings(caught)
    out["seconds"] = seconds
    return out


def _reference_distance(ranks, ref, cfg, steps):
    """Each leaf's relative L2 distance to the reference after each step
    whose state the reference saved (None for the others), from the
    ranks' shares; the worst parameter and moment leaf a step.  The
    leaves initialised to 0 (``_against_reference``'s ``zero``) are held
    apart: the worst relative L2 over their elements above the gradient
    threshold, the largest excess of the others over the allowance, and
    the flipped elements of all their elements."""
    from repro_torch.core import tree as TR
    from repro_torch.training import train_step as TS
    paths = [TR.leaf_key(p) for p, _ in
             TR.flatten_with_path(TS.abstract_state(cfg))[0]]
    out = []
    for i in range(steps):
        if ref["steps"][i] is None:
            out.append(None)
            continue
        worst = {"params": (0.0, None), "moments": (0.0, None)}
        zero = dict(rel_l2=0.0, leaf=None, excess=-math.inf, flipped=0,
                    elements=0, leaves=0)
        for j, path in enumerate(paths):
            parts = [r["against"][i][j] for r in ranks if r["against"][i][j]]
            if not parts:
                continue
            d = math.sqrt(sum(p[0] for p in parts)
                          / max(sum(p[1] for p in parts), 1e-30))
            if len(parts[0]) > 2:
                if d >= zero["rel_l2"]:
                    zero.update(rel_l2=d, leaf=path)
                zero["excess"] = max([zero["excess"]] + [p[2] for p in parts])
                zero["flipped"] += sum(p[3] for p in parts)
                zero["elements"] += sum(p[4] for p in parts)
                zero["leaves"] += 1
                continue
            key = "params" if path.startswith(".params") else "moments"
            if d >= worst[key][0]:
                worst[key] = (d, path)
        out.append({k: dict(rel_l2=v[0], leaf=v[1]) for k, v in worst.items()})
        if zero["leaves"]:
            out[-1]["zero_init"] = zero
    return out


def _world_gates(name, ranks, ref, cfg, steps):
    """The gates every world of phases ``ep`` and ``tp_recurrent`` shares
    (``name`` labels its failures): the leaves replicated over model
    bitwise across the model ranks, held bytes equal to the specs,
    parameter gathers the data axis's alone, finite losses, no flash or
    codec launch, each step within the ``SHARD_*`` bounds of the
    single-process step, and so each state the reference saved (a
    zero-initialised leaf within ``SHARD_PARAM_RTOL`` above its gradient
    threshold, within its allowance below it, and at most
    ``ZERO_FLIP_FRAC`` of its elements flipped); returns the distances."""
    replicas = {}
    for r in ranks:
        c = r["coord"]
        replicas.setdefault((c["pod"], c["data"]), set()).add(r["replicated_sha"])
        if r["held"] != r["spec_bytes"]:
            raise AssertionError(f"{name} rank {r['rank']}: holds "
                                 f"{r['held']}, the specs give {r['spec_bytes']}")
        for st in r["steps"]:
            if st["comm"]["gather"]["sent_bytes"] != r["data_gather_bytes"]:
                raise AssertionError(
                    f"{name} rank {r['rank']}: parameter gathers of "
                    f"{st['comm']['gather']['sent_bytes']} bytes, the data axis "
                    f"accounts for {r['data_gather_bytes']}: a parameter "
                    "crossed the model group")
            if not math.isfinite(st["loss"]):
                raise AssertionError(f"{name}: loss {st['loss']}")
        if any(r["launches"].get(k, 0) for k in (*KERNELS, "flash_attention")):
            raise AssertionError(f"{name} rank {r['rank']}: a flash or "
                                 f"codec kernel launched: {r['launches']}")
    if any(len(v) != 1 for v in replicas.values()):
        raise AssertionError(f"{name}: a leaf replicated over model "
                             "differs between model ranks")
    dist_ = _reference_distance(ranks, ref, cfg, steps)
    for i, (st, m) in enumerate(zip(ranks[0]["steps"], ref["metrics"])):
        d = dist_[i] = dist_[i] or {}
        z = d.get("zero_init", dict(rel_l2=0, excess=0, flipped=0, elements=1))
        ok = (abs(st["loss"] - m["loss"]) <= SHARD_CE_ATOL
              and abs(st["grad_norm"] - m["grad_norm"]) / m["grad_norm"]
              <= SHARD_GN_RTOL and st["lr"] == m["lr"]
              and d.get("params", {}).get("rel_l2", 0) <= SHARD_PARAM_RTOL
              and d.get("moments", {}).get("rel_l2", 0) <= SHARD_MOMENT_RTOL
              and z["rel_l2"] <= SHARD_PARAM_RTOL and z["excess"] <= 0
              and z["flipped"] <= ZERO_FLIP_FRAC * z["elements"])
        d.update(loss_abs=abs(st["loss"] - m["loss"]),
                 grad_norm_rel=abs(st["grad_norm"] - m["grad_norm"])
                 / m["grad_norm"], ok=ok)
        if not ok:
            raise AssertionError(f"{name} step {i}: the sharded step left "
                                 f"the single-process step's bounds: {d}")
    return dist_


def _ep_gates(tag, ranks, ref):
    """Phase ``ep``'s gates on one world's ranks; returns the distances."""
    from repro_torch.models import moe as MOE
    want_cap = MOE.capacity(EP_BATCH * TRAIN_SEQ, ep_config().moe)
    for r in ranks:
        if any("ep_gather" not in st["comm"] for st in r["steps"]):
            raise AssertionError(f"ep ({tag}): the experts did not split "
                                 "over model")
        for layer in r["layers"]:
            if layer["cap"] != want_cap \
                    or layer["dropped"] != layer["single_dropped"] \
                    or not layer["slots_bitwise"] or (
                        layer["logits_bitwise"]
                        and layer["run_dropped"] != layer["single_dropped"]):
                raise AssertionError(f"ep ({tag}) rank {r['rank']}: routing "
                                     f"against the single-process FFN: {layer}")
    return _world_gates(f"ep ({tag})", ranks, ref, ep_config(), EP_STEPS)


def phase_ep(torch, smi):
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    ref_dir = Path(tempfile.mkdtemp(prefix="ep_reference_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        ref = ep_reference(torch, device, ref_dir)
        ref_s = time.perf_counter() - t0
        a = run_ranks("ep_rank", math.prod(EP_HEADS_MESH), EP_HEADS_MESH,
                      False, ref)
        a_s = time.perf_counter() - t0 - ref_s
        a_dist = _ep_gates("heads", a, ref)
        b = run_ranks("ep_rank", math.prod(EP_FSDP_MESH), EP_FSDP_MESH,
                      True, ref)
        b_s = time.perf_counter() - t0 - ref_s - a_s
        b_dist = _ep_gates("fsdp", b, ref)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    cfg = ep_config()
    for r in a + b:
        del r["against"]
    emit(phase="ep", nvidia_smi=smi, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
         capacity_factor=cfg.moe.capacity_factor, batch=EP_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, steps=EP_STEPS, transport="gloo",
         reference=dict(metrics=ref["metrics"], peak_gb=ref["peak_gb"]),
         heads=dict(mesh=list(EP_HEADS_MESH), fsdp=False, ranks=a,
                    against_single=a_dist),
         fsdp=dict(mesh=list(EP_FSDP_MESH), fsdp=True, ranks=b,
                   against_single=b_dist),
         seconds=dict(reference=ref_s, heads=a_s, fsdp=b_s,
                      phase=time.perf_counter() - t0))
    return {w: {k: r[0]["launches"].get(k, 0) for k in (*KERNELS, "flash_attention")}
            for w, r in (("ep_heads", a), ("ep_fsdp", b))}


# ---------------------------------------------------------------------------
# phase tp_recurrent: Mamba-2 and the RG-LRU hybrid under the model axis
# ---------------------------------------------------------------------------

TPR_STEPS = 2
# a parameter initialised to 0 is its AdamW updates alone, about lr times
# its gradients' signs, which round-off flips where a gradient is near 0:
# its elements whose first gradient (the reference's first moment after
# one step) exceeds ZERO_GRAD_FRAC of the leaf's largest are held as a
# leaf (the CPU tests saw flips up to 0.82% of it), the others within the
# updates' distance; at most ZERO_FLIP_FRAC of its elements may flip
# (phase tp_recurrent's first runs on the H100: 19 of 21,824 and 58 of
# 49,152)
ZERO_GRAD_FRAC, ZERO_FLIP_FRAC = 2e-2, 5e-3
# world -> the config cut in depth, its mesh, FSDP, batch and sequence
# and the attention case it must take (None: no attention), the steps
# after which the reference's state is saved and compared (the hybrid's
# 19.2 GB only after the last), and the learning rate: the hybrid's is a
# tenth of the launcher's, at which its random full-width first step
# diverges (loss 13.35 -> 18.21, gradient norm 30 -> 156) and the second
# step's loss moves by round-off past the loss bound while the states stay
# within theirs (``--lr-witness`` measures that gap against the single
# process's own under another reduction order)
TPR_WORLDS = {
    "ssm": dict(arch=SSM_ARCH, layers=4, mesh=(1, 2, 2), fsdp=True, batch=2,
                seq=TRAIN_SEQ, case=None, saved=(0, 1), lr=TRAIN_LR),
    "hybrid": dict(arch=HYBRID_ARCH, layers=5, mesh=(1, 1, 2), fsdp=False,
                   batch=1, seq=4096, case="kv", saved=(1,), lr=TRAIN_LR / 10),
}


def tpr_config(world):
    """World ``world``'s config: full width, cut to its layers."""
    import dataclasses

    from repro_torch.configs.base import get_config
    w = TPR_WORLDS[world]
    return dataclasses.replace(get_config(w["arch"]), num_layers=w["layers"])


def tpr_reference(torch, device, out_dir, world, lr=None, kv_block=None,
                  save=True):
    """World ``world``'s single-process step (``make_run`` without a
    policy), its state saved after each step of ``saved`` as
    ``ep_reference`` saves it (None for the others), and the first moment
    after one step of the parameter leaves initialised to 0, by leaf
    index (``_against_reference``'s ``zero``).  ``lr`` and ``kv_block``
    replace the world's (``--lr-witness``); ``save=False`` keeps the
    metrics alone."""
    from repro_torch.core import tree as TR
    from repro_torch.launch import train as LT
    w = TPR_WORLDS[world]
    torch.cuda.reset_peak_memory_stats()
    state, step_at = LT.make_run(tpr_config(world), batch=w["batch"],
                                 seq=w["seq"], lr=lr or w["lr"],
                                 steps=TPR_STEPS, seed=0, device=device,
                                 donate=True, kv_block=kv_block)
    zero = [i for i, x in enumerate(TR.leaves(state.params)) if not bool(x.any())]
    steps, metrics, first = [], [], None
    for i in range(TPR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_at(state, i)
        torch.cuda.synchronize()
        metrics.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                            **{k: float(v) for k, v in m.items()}))
        if save and i == 0:
            m1 = TR.leaves(state.opt.m)
            first = dict(path=str(out_dir / f"{world}_first.pt"), leaves=len(zero))
            torch.save({j: m1[j].float().cpu() for j in zero}, first["path"])
        steps.append(None)
        if save and i in w["saved"]:
            steps[-1] = str(out_dir / f"{world}_step{i}.pt")
            torch.save([x.to(torch.bfloat16).cpu() for x in TR.leaves(state)],
                       steps[-1])
    del state, step_at
    peak = _peak_gb(torch)
    torch.cuda.empty_cache()
    return dict(steps=steps, metrics=metrics, peak_gb=peak, zero=first)


def tpr_rank(torch, rank, device, world, ref, lr=None):
    """Phase ``tp_recurrent``, world ``world`` (``TPR_WORLDS``):
    ``TPR_STEPS`` steps through ``make_run(policy=)``.  Each rank: which
    dimensions split over model, its attention case, the bytes it holds
    against the spec arithmetic, step ms, the step's traffic
    (``train_step.last_comm``), the parameter-gather bytes the data axis
    alone accounts for, launches, peak memory, the hash of its leaves
    replicated over ``model``, and its share of each leaf's distance to
    the single-process step's state after each step it saved (``ref``).
    ``lr`` replaces the world's (``--lr-witness``)."""
    import warnings

    from repro_torch.core import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm as SSM
    from repro_torch.serving.collective import _padded
    from repro_torch.training import train_step as TS

    _deterministic(torch)
    cfg, w = tpr_config(world), TPR_WORLDS[world]
    mesh = make_mesh(w["mesh"], MESH_AXES)
    policy = SH.ShardingPolicy(mesh, fsdp=w["fsdp"])
    like = TS.abstract_state(cfg)
    specs = SH.leaf_specs(TS.state_specs(policy, like), like)
    coord = SH.coordinate(mesh)
    tp = TP.TensorParallel(mesh.get_group("model"), cfg)
    if cfg.ssm is not None:
        d_inner, heads, conv = SSM.dims(cfg.d_model, cfg.ssm)
        split = {"in_proj": tp.splits(d_inner + conv + heads),
                 "out_proj": tp.splits(d_inner)}
        case = None
    else:
        split = {"lru_width": tp.splits(tp.lru_width),
                 "d_ff": tp.splits(cfg.d_ff)}
        case = tp.attention(w["seq"])
    out = {"rank": rank, "coord": coord, "split": split, "case": case,
           "steps": [], "against": []}
    seconds, t0 = {}, time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step_at = LT.make_run(cfg, batch=w["batch"], seq=w["seq"],
                                     lr=lr or w["lr"], steps=TPR_STEPS, seed=0,
                                     device=device, policy=policy, donate=True)
        torch.cuda.synchronize()
        seconds["setup"] = time.perf_counter() - t0
        out["setup_peak_gb"] = _peak_gb(torch)
        out["held"] = _held(state)
        out["spec_bytes"] = _spec_bytes(like, policy)
        out["data_gather_bytes"] = sum(
            _padded(x.numel() * x.element_size())
            for x, s in zip(TR.leaves(state.params), specs)
            if SH.splits(SH.restrict(s, ("data",)), policy.sizes))
        launches, allow = {}, 0.0
        for i in range(TPR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, metrics), counts = counted(step_at, state, i)
            torch.cuda.synchronize()
            out["steps"].append(dict(
                step=i, ms=(time.perf_counter() - t0) * 1e3,
                **{k: float(v) for k, v in metrics.items()},
                comm=_comm_record()))
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            allow += 2 * ref["metrics"][i]["lr"]
            out["against"].append(None)
            if ref["steps"][i] is not None:
                t0 = time.perf_counter()
                out["against"][-1] = _against_reference(
                    torch, state, ref["steps"][i], specs, mesh, coord,
                    ref["zero"], allow)
                seconds[f"against{i}"] = time.perf_counter() - t0
        out["launches"] = launches
        out["peak_gb"] = _peak_gb(torch)
        out["replicated_sha"] = _sha_tree(torch, [
            x for x, s in zip(TR.leaves(state), specs)
            if not any("model" in SH.entry_axes(e) for e in s)])
        del state, step_at
    out["warnings"] = _nondeterministic_warnings(caught)
    out["seconds"] = seconds
    return out


def _tpr_gates(world, ranks, ref):
    """Phase ``tp_recurrent``'s gates on one world's ranks; returns the
    distances."""
    for r in ranks:
        if not all(r["split"].values()) or r["case"] != TPR_WORLDS[world]["case"]:
            raise AssertionError(f"tp_recurrent ({world}): a dimension did not "
                                 f"split over model: {r['split']}, attention "
                                 f"case {r['case']}")
    return _world_gates(f"tp_recurrent ({world})", ranks, ref,
                        tpr_config(world), TPR_STEPS)


def phase_tp_recurrent(torch, smi):
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    worlds, windows = {}, {}
    for world, w in TPR_WORLDS.items():
        ref_dir = Path(tempfile.mkdtemp(prefix="tpr_reference_",
                                        dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            ref = tpr_reference(torch, device, ref_dir, world)
            ref_s = time.perf_counter() - t0
            ranks = run_ranks("tpr_rank", math.prod(w["mesh"]), world, ref)
            ranks_s = time.perf_counter() - t0 - ref_s
            against = _tpr_gates(world, ranks, ref)
        finally:
            shutil.rmtree(ref_dir, ignore_errors=True)
        for r in ranks:
            del r["against"]
        cfg = tpr_config(world)
        worlds[world] = dict(
            arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
            vocab=cfg.vocab_size, mesh=list(w["mesh"]), fsdp=w["fsdp"],
            batch=w["batch"], seq=w["seq"], lr=w["lr"],
            reference=dict(metrics=ref["metrics"], peak_gb=ref["peak_gb"],
                           zero_init_leaves=ref["zero"]["leaves"],
                           saved_after=list(w["saved"])),
            ranks=ranks, against_single=against,
            seconds=dict(reference=ref_s, ranks=ranks_s))
        windows[f"tpr_{world}"] = {k: ranks[0]["launches"].get(k, 0)
                                   for k in (*KERNELS, "flash_attention")}
    emit(phase="tp_recurrent", nvidia_smi=smi, steps=TPR_STEPS,
         transport="gloo", **worlds,
         seconds=dict(phase=time.perf_counter() - t_phase))
    return windows


def lr_witness(torch, smi):
    """``--lr-witness``: how far round-off alone moves world ``hybrid``'s
    second-step loss, at the launcher's lr and at the world's.  At each,
    the single-process step with the attention's keys in blocks of 1024
    (the default) and of 512 (another order of the online softmax's sums);
    at the launcher's, also the tensor-parallel world.  Prints the losses
    and each run's gap to the single-process default."""
    device = torch.device("cuda", 0)
    w = TPR_WORLDS["hybrid"]
    t0 = time.perf_counter()
    out = {}
    for lr in (TRAIN_LR, w["lr"]):
        runs = {kv: tpr_reference(torch, device, None, "hybrid", lr=lr,
                                  kv_block=kv, save=False)["metrics"]
                for kv in (1024, 512)}
        if lr == TRAIN_LR:
            ref = dict(steps=[None] * TPR_STEPS, metrics=runs[1024], zero=None)
            ranks = run_ranks("tpr_rank", math.prod(w["mesh"]), "hybrid", ref,
                              lr)
            runs["tp"] = ranks[0]["steps"]
        out[f"lr {lr:g}"] = {
            name: dict(loss=[m["loss"] for m in ms],
                       grad_norm=[m["grad_norm"] for m in ms],
                       loss_gap=[abs(m["loss"] - b["loss"])
                                 for m, b in zip(ms, runs[1024])])
            for name, ms in (("single kv_block 1024", runs[1024]),
                             ("single kv_block 512", runs[512]),
                             ("tp (1, 1, 2)", runs.get("tp"))) if ms}
    emit(phase="lr_witness", nvidia_smi=smi, arch=tpr_config("hybrid").name,
         layers=w["layers"], batch=w["batch"], seq=w["seq"], steps=TPR_STEPS,
         loss_bound=SHARD_CE_ATOL, runs=out,
         seconds=time.perf_counter() - t0)
    return 0


# ---------------------------------------------------------------------------
# phases serve_tp, serve_tp_families: sharded serving across ranks
# ---------------------------------------------------------------------------

#: qwen3-32b cut to 4 layers (8 took 75 s of the 1092-s run above, with
#: phase serve_tp_families after it)
SERVE_TP_ARCH, SERVE_TP_LAYERS = "qwen3-32b", 4
SERVE_TP_BATCH, SERVE_TP_PROMPT, SERVE_TP_MAX_SEQ = 2, 2048, 4096
#: decode steps of the serving phases' worlds (8: the script's time
#: budget, with the fsdp world's gathers)
SERVE_TP_STEPS, SERVE_TP_SEED = 8, 0
#: world -> its mesh, whether pods are prefill and decode workers, the
#: dry-run transfer variant of its hop, and (``fsdp``) whether its ranks
#: hold FSDP blocks, gathered a layer at a time, with the decode steps it
#: runs (phase serve_tp alone: it is held bitwise to ``base``'s first steps)
SERVE_TP_WORLDS = {
    "xfer": dict(mesh=(2, 1, 2), pd=True, variant="xfer_chunked"),
    "base": dict(mesh=(1, 2, 2), pd=False, variant=None),
    "fsdp": dict(mesh=(1, 2, 2), pd=False, variant=None, fsdp=True, steps=2),
}
#: the worlds of phases serve_tp_families, serve_tp_recurrent and
#: serve_tp_frontends
SERVE_FAMILY_WORLDS = ("xfer", "base")
#: phase serve_tp's fsdp world: the parameter bytes a rank holds, the
#: spec arithmetic of qwen3-32b at 4 layers under fsdp on (1, 2, 2)
SERVE_TP_FSDP_HELD = 1_753_134_080
#: the prefill bound of tests/test_torch_serve_tp.py (its docstring says
#: why), for the last logits and the teacher-forced decode logits; at full
#: width the single-process run moves farther than that when only its row
#: products round elsewhere (the replay's witness), and the ranks are held
#: within SERVE_TP_WITNESS times that distance where it is the larger
SERVE_TP_ATOL, SERVE_TP_RTOL, SERVE_TP_WITNESS = 4e-2, 2e-2, 1.5
#: phase serve_tp_families: each family's configuration at full width and
#: the depth it is cut to, in the order each rank serves them
SERVE_FAMILIES = {"mla": ("minicpm3-4b", 8), "moe": ("qwen3-moe-30b-a3b", 2)}
#: phase serve_tp_recurrent: each recurrent family at full width, the depth
#: it is cut to (as phase tp_recurrent), its prompt and cache slots
#: (recurrentgemma's prompt twice its 2048-token window: the prefill's
#: band cuts and every decode step shifts a full window)
SERVE_RECURRENT = {
    "ssm": dict(arch="mamba2-2.7b", layers=4, prompt=2048, max_seq=4096),
    "hybrid": dict(arch="recurrentgemma-9b", layers=5, prompt=4096,
                   max_seq=8192),
}
#: phase serve_tp_frontends: each front end at full width, the depth it is
#: cut to, its prompt positions (pixtral: 256 patches + 1792 tokens;
#: hubert: 30 s of frames at 50 a second) and cache slots (pixtral's 3072
#: split at model 2 put the patches and 1280 tokens in rank 0's span, the
#: last 512 prompt tokens and every decoded token in rank 1's; hubert has
#: no cache)
SERVE_FRONTENDS = {
    "vlm": dict(arch="pixtral-12b", layers=4, prompt=2048, max_seq=3072),
    "audio": dict(arch="hubert-xlarge", layers=48, prompt=1500, max_seq=1500),
}
#: phase serve_tp_families holds the decoded tokens equal to the replay's
#: greedy choice where the replay's largest logit leads the next by at
#: least this much and by twice the rank's largest logit distance from the
#: replay (a lead round-off of that size cannot overturn)
SERVE_FAM_MARGIN = 1e-2


def serve_tp_config():
    """qwen3-32b at full width, cut in depth to ``SERVE_TP_LAYERS``."""
    return _depth_cut(SERVE_TP_ARCH, SERVE_TP_LAYERS)


def serve_family_config(fam):
    """Phase ``serve_tp_families``' ``fam`` at full width, cut in depth."""
    return _depth_cut(*SERVE_FAMILIES[fam])


def _depth_cut(arch, layers):
    import dataclasses

    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def serve_tp_tokens(torch, cfg, prompt=SERVE_TP_PROMPT):
    """The prompt, drawn on the host from a seed: every rank and the
    single-process replay draw the same."""
    g = torch.Generator().manual_seed(SERVE_TP_SEED + 1)
    return torch.randint(0, cfg.vocab_size, (SERVE_TP_BATCH, prompt),
                         generator=g, dtype=torch.int64)


def serve_tp_prompt(torch, cfg, prompt=SERVE_TP_PROMPT):
    """The served prompt of ``prompt`` positions, drawn on the host from a
    seed (every rank and the single-process replay draw the same):
    :func:`serve_tp_tokens`, a vision config's ``frontend_len`` patches
    before ``prompt - frontend_len`` tokens, or an audio config's
    frames (bf16, standard normal)."""
    g = torch.Generator().manual_seed(SERVE_TP_SEED + 2)

    def normal(*dims):
        return torch.randn(dims, generator=g).to(torch.bfloat16)
    if cfg.frontend == "audio_frames":
        return {"frames": normal(SERVE_TP_BATCH, prompt, cfg.frontend_dim)}
    if cfg.frontend == "vision_patches":
        return {"patches": normal(SERVE_TP_BATCH, cfg.frontend_len,
                                  cfg.frontend_dim),
                "tokens": serve_tp_tokens(torch, cfg,
                                          prompt - cfg.frontend_len)}
    return {"tokens": serve_tp_tokens(torch, cfg, prompt)}


def _model_collectives(group, seen, calls):
    """Record the storage of every tensor this process hands to a
    collective over ``group`` (``Link.all_to_all``, ``all_to_all_v``,
    ``all_gather``) into ``seen``, and count the collectives in
    ``calls[0]``: a parameter's storage there would be a parameter moving
    over that group."""
    from repro_torch.serving import collective as CL
    for name in ("all_to_all", "all_to_all_v", "all_gather"):
        orig = getattr(CL.Link, name)
        if hasattr(orig, "seen_by"):
            orig.seen_by = (group.group_name, seen, calls)
            continue

        def rec(self, x, *a, _orig=orig, **k):
            name_, sink, n = rec.seen_by
            if self.group.group_name == name_:
                n[0] += 1
                for t in (x if isinstance(x, (list, tuple)) else [x]):
                    if t.numel():
                        sink.add(t.untyped_storage().data_ptr())
            return _orig(self, x, *a, **k)
        rec.seen_by = (group.group_name, seen, calls)
        setattr(CL.Link, name, rec)


class _calls_of:
    """Within: the Python-level calls of ``fn`` (its code object's starts,
    ``sys.monitoring``; any caller, a default argument's too) counted in
    ``n``."""

    def __init__(self, fn):
        self.code, self.n = fn.__code__, 0

    def __enter__(self):
        mon = sys.monitoring
        self.tool = next(i for i in (3, 4) if mon.get_tool(i) is None)
        mon.use_tool_id(self.tool, "chip_smoke")

        def start(code, offset):
            self.n += 1
        mon.register_callback(self.tool, mon.events.PY_START, start)
        mon.set_local_events(self.tool, self.code, mon.events.PY_START)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        mon.set_local_events(self.tool, self.code, 0)
        mon.register_callback(self.tool, mon.events.PY_START, None)
        mon.free_tool_id(self.tool)
        return False


class _recorded_routes:
    """Within: the MoE FFN's top-k choices, each call's (T, k) experts
    (on the device), appended to ``calls`` in call order."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.orig = orig = MOE.top_k

        def top_k(probs, k):
            vals, idx = orig(probs, k)
            self.calls.append(idx)
            return vals, idx
        MOE.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.top_k = self.orig
        return False


class _forced_routes:
    """Within: the MoE FFN routed to the given experts, one (T, k) tensor a
    call in call order; the gates are the run's own probabilities there."""

    def __init__(self, calls):
        self.calls = list(calls)

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.orig = MOE.top_k

        def top_k(probs, k):
            idx = self.calls.pop(0).to(probs.device).long()
            return probs.gather(-1, idx), idx
        MOE.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.top_k = self.orig
        if not exc[0] and self.calls:
            raise AssertionError(f"{len(self.calls)} forced routes unused")
        return False


class _recorded_frame_logits:
    """Within: the logits an encoder-only prefill returns for every frame
    (``models.model.prefill``, which ``prefill_step`` calls; the rank's
    vocab columns under ``tp``), copied to the host into ``calls``."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        from repro_torch.models import model as M
        self.orig = orig = M.prefill

        def prefill(*a, **kw):
            logits, state = orig(*a, **kw)
            self.calls.append(logits.float().cpu())
            return logits, state
        M.prefill = prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.prefill = self.orig
        return False


def serve_tp_rank(torch, rank, device, world, out_dir):
    """Phase ``serve_tp``, world ``world`` (``SERVE_TP_WORLDS``): qwen3-32b
    at full width cut to ``SERVE_TP_LAYERS`` layers (:func:`serve_world`);
    the ``base`` and ``fsdp`` worlds also hash their cache after the
    ``fsdp`` world's steps."""
    return serve_world(torch, rank, device, serve_tp_config(), world, out_dir,
                       world, cache_after=SERVE_TP_WORLDS["fsdp"]["steps"])


def serve_families_rank(torch, rank, device, world, out_dir):
    """Phase ``serve_tp_families``, world ``world``: each of
    ``SERVE_FAMILIES`` served in turn by the same ranks
    (:func:`serve_world`), each model freed before the next is drawn."""
    out = {}
    for fam in SERVE_FAMILIES:
        out[fam] = serve_world(torch, rank, device, serve_family_config(fam),
                               world, out_dir, f"{fam}_{world}")
        torch.cuda.empty_cache()
    return out


def serve_recurrent_rank(torch, rank, device, world, out_dir):
    """Phase ``serve_tp_recurrent``, world ``world``: each of
    ``SERVE_RECURRENT`` served in turn by the same ranks
    (:func:`serve_world`, the second hop ``xfer_fp32``), each model freed
    before the next is drawn."""
    out = {}
    for fam, c in SERVE_RECURRENT.items():
        out[fam] = serve_world(torch, rank, device,
                               _depth_cut(c["arch"], c["layers"]), world,
                               out_dir, f"rec_{fam}_{world}",
                               prompt=c["prompt"], max_seq=c["max_seq"],
                               second="xfer_fp32")
        torch.cuda.empty_cache()
    return out


def serve_frontends_rank(torch, rank, device, world, out_dir):
    """Phase ``serve_tp_frontends``, world ``world``: each of
    ``SERVE_FRONTENDS`` served in turn by the same ranks
    (:func:`serve_world`, the second hop ``xfer_global``), each model freed
    before the next is drawn."""
    out = {}
    for fam, c in SERVE_FRONTENDS.items():
        out[fam] = serve_world(torch, rank, device,
                               _depth_cut(c["arch"], c["layers"]), world,
                               out_dir, f"fe_{fam}_{world}",
                               prompt=c["prompt"], max_seq=c["max_seq"])
        torch.cuda.empty_cache()
    return out


def serve_world(torch, rank, device, cfg, world, out_dir, tag, *,
                prompt=SERVE_TP_PROMPT, max_seq=SERVE_TP_MAX_SEQ,
                second="xfer_global", cache_after=None):
    """One rank of one world (``SERVE_TP_WORLDS``) serving ``cfg`` at a
    ``prompt``-token prompt and ``max_seq`` cache slots, each rank drawing
    its block of the seeded parameters (``serving/sharded.place_params``).
    ``xfer``: ``disaggregated_step`` (pod 0 prefills at model 2 and ships
    each rank's own cache shard, pod 1 decodes ``SERVE_TP_STEPS`` tokens
    from it), then a ``second`` hop of the same shards (``xfer_global``;
    the recurrent families' ``xfer_fp32``), kept under the variant's
    suffix.  ``base``: ``prefill_step(tp=, ep=)`` on the
    rank's row, then ``decode_loop(tp=, ep=)``; a MoE's ``ep`` is
    ``serving/sharded.expert_parallel``'s.  Each main-path run counted
    alone.  Per rank: its coordinate and attention case, held bytes
    against the spec arithmetic (parameters and cache), the hashes of its
    parameters, of its parameter leaves replicated over ``model`` and of
    its cache leaves replicated over ``model`` (after the prefill and after
    the decode), the storages it handed to collectives over ``model`` that
    are a parameter's, the collectives over ``model`` a decode step
    issues, the calls of ``chunked_attention`` in the served prefill (the
    flash kernel is serving's), launches, prefill and decode-step ms (host
    clock around synchronized calls), the collectives over ``model``
    (``tp.fwd``) and a MoE's routing and expert-output collectives, the
    hops' stats and each route's raw and wire bytes, peak memory (since
    the draw, and ``serve_peak_gb``: read after ``place_params``).  Under
    an ``fsdp`` world the ranks hold FSDP blocks and every pass gathers
    each layer's over ``data`` (``serving/sharded.block_gather``): its
    bytes, ms and all-gathers, the prefill's apart.  Hashes of the
    prefill's logits, of each step's logits and of the cache blocks after
    the prefill (and, with ``cache_after``, after that many steps: an
    uncounted ``decode_loop`` from the prefill's state where the world
    runs another number) let two worlds be held bitwise.  Its
    vocab columns of the prefill and of every step's logits, the first
    token, the tokens, a MoE's top-k choices (call order) and a recurrent
    family's f32 state blocks (after the prefill, after the steps) go to
    ``out_dir`` as ``<tag>_rank<r>.pt`` for the single-process replay.
    The prompt is :func:`serve_tp_prompt`'s (a front end's patches or
    frames).  An encoder-only config runs the prefill cell alone (its
    ``prefill`` there is the rank's columns of every frame's logits), and
    its hop ships the empty cache: pod 1 keeps the first units."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.core import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import kvcache as KC
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving import sharded as SV
    from repro_torch.serving.decode import decode_loop
    from repro_torch.serving.prefill import prefill_step

    w = SERVE_TP_WORLDS[world]
    b, m, steps = SERVE_TP_BATCH, max_seq, w.get("steps", SERVE_TP_STEPS)
    mesh = make_mesh(w["mesh"], MESH_AXES)
    policy = SH.ShardingPolicy(mesh, pd_disaggregated=w["pd"],
                               fsdp=w.get("fsdp", False))
    coord = SH.coordinate(mesh)
    tp = SV.tensor_parallel(policy, cfg)
    seconds, t0 = {}, time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the ranks draw in turns: a whole stacked leaf's f32 draw (4.2 GB for
    # qwen3-32b's w_gate) on top of the blocks, four ranks at once, does
    # not fit
    for turn in range(dist.get_world_size()):
        if turn == rank:
            params = SV.place_params(cfg, torch.Generator(
                device=device).manual_seed(SERVE_TP_SEED), policy, device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    seconds["params"] = time.perf_counter() - t0
    draw_peak = _peak_gb(torch)     # read, then reset: the serving's own
    held_gb = torch.cuda.memory_allocated() / 1e9
    like_p = M.init_params(cfg, torch.Generator(), "meta")
    like_c = SV.cache_like(cfg, b, m, prompt)
    pspecs = SH.leaf_specs(policy.param_specs(like_p), like_p)
    cspecs = SH.leaf_specs(policy.cache_specs(like_c), like_c)
    nbytes = (lambda tree: sum(x.numel() * x.element_size()
                               for x in TR.leaves(tree)))

    def over_model(specs, axes=("model",)):
        return [any(a in SH.entry_axes(e) for e in sp for a in axes)
                for sp in specs]

    def replicated_cache(cache):
        return _sha_tree(torch, [x for x, split in zip(
            TR.leaves(cache), over_model(cspecs)) if not split])

    def f32_blocks(cache):
        return {k: x.cpu() for k, x in cache.items()
                if x.dtype == torch.float32}

    out = {"rank": rank, "coord": coord, "arch": cfg.name,
           "case": tp.attention(prompt) if cfg.num_heads else None,
           "held_params": nbytes(params),
           "spec_params": SH.held_bytes(like_p, policy.param_specs(like_p),
                                        policy.sizes),
           "spec_cache": SH.held_bytes(like_c, policy.cache_specs(like_c),
                                       policy.sizes),
           "init_cache": nbytes(KC.init_cache(cfg, b, m, device="meta",
                                              policy=policy)),
           "params_sha": _sha_tree(torch, params),
           # a parameter leaf split over neither model nor (an FSDP
           # block) data is the same on every rank
           "replicated_sha": _sha_tree(torch, [
               x for x, split in zip(TR.leaves(params),
                                     over_model(pspecs, ("model", "data")))
               if not split])}
    seen, calls = set(), [0]
    _model_collectives(mesh.get_group("model"), seen, calls)
    batch = {k: x.to(device) for k, x in
             serve_tp_prompt(torch, cfg, prompt).items()}
    rows = SH.shard_slice(torch.arange(b), policy.spec_for_activation(
        "tokens", (b,)), mesh).tolist()
    logits, stamps, routes = [], [], []

    def on_logits(i, lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logits.append(lg.float().cpu())

    saved = {"rows": rows}
    ep = None
    fs = SV.block_gather(policy, cfg)
    chunked = _calls_of(L.chunked_attention)
    # an encoder-only prefill's every frame (prefill_step keeps the last)
    frames = []
    record = _recorded_frame_logits(frames) if cfg.encoder_only else \
        contextlib.nullcontext()
    with _recorded_routes(routes), chunked, record:
        if w["pd"]:
            tc = SV.transfer_config(w["variant"], backend="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, launches = counted(lambda: SV.disaggregated_step(
                params, batch, cfg, policy, tc, max_seq=m,
                num_steps=steps, device=device, on_logits=on_logits))
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
            st, comm = res.session.last_stats, res.session.last_comm
            tp, ep, fs = res.tp, res.ep, res.fsdp
            out.update(pod=res.pod, launches=launches, window_ms=window_ms,
                       hop=dict(ms=comm.seconds * 1e3, wire_bytes=st.wire_bytes,
                                staging_ms=comm.staging_s * 1e3,
                                wire_ms=comm.wire_s * 1e3,
                                sent_bytes=comm.sent_bytes,
                                recv_bytes=comm.recv_bytes,
                                retry_steps=st.n_retry_steps,
                                leaf_ok=st.leaf_ok,
                                routes=_hop_routes(res.session, comm)),
                       side_bytes=res.side.sent_bytes + res.side.recv_bytes)
            if res.pod == 1 and res.tokens is not None:
                out["decode_collectives"] = calls[0] / steps
        else:
            ep = SV.expert_parallel(policy, cfg, tp)
            local = SV.local_batch(batch, policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre, launches = counted(lambda: prefill_step(
                params, local, cfg, max_seq=m, tp=tp, ep=ep, fsdp=fs))
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["prefill_gather"] = dict(sent_bytes=fs.comm.sent_bytes,
                                         recv_bytes=fs.comm.recv_bytes,
                                         calls=fs.calls,
                                         ms=fs.comm.seconds * 1e3)
            out["held_cache"] = nbytes(pre.state.cache)
            out["cache_replicated_sha"] = replicated_cache(pre.state.cache)
            out["first_token"] = pre.first_token.tolist()
            out["prefill_logits_sha"] = _sha_tree(torch, pre.last_logits)
            out["cache_prefill_sha"] = _sha_tree(torch, pre.state.cache)
            saved.update(prefill=frames[-1] if cfg.encoder_only
                         else pre.last_logits.float().cpu(),
                         first=pre.first_token.cpu(),
                         state_prefill=f32_blocks(pre.state.cache))
            if cfg.encoder_only:      # the prefill cell alone: no decode
                _, dl = counted(lambda: None)
            else:
                calls[0] = 0
                (toks, after), dl = counted(lambda: decode_loop(
                    params, pre.first_token, pre.state, cfg, steps, tp=tp,
                    max_seq=m, on_logits=on_logits, ep=ep, fsdp=fs))
                out["decode_collectives"] = calls[0] / steps
                out["tokens"] = toks.tolist()
                out["after_replicated_sha"] = replicated_cache(after.cache)
                out["step_logits_sha"] = [_sha_tree(torch, x) for x in logits]
                saved.update(steps=torch.stack(logits), tokens=toks.cpu(),
                             state_after=f32_blocks(after.cache))
            out["launches"], out["decode_launches"] = launches, dl
    out["chunked_attention_calls"] = chunked.n
    out["gather"] = dict(sent_bytes=fs.comm.sent_bytes,
                         recv_bytes=fs.comm.recv_bytes, calls=fs.calls,
                         ms=fs.comm.seconds * 1e3,
                         staging_ms=fs.comm.staging_s * 1e3,
                         wire_ms=fs.comm.wire_s * 1e3)
    if cache_after is not None and not w["pd"] and not cfg.encoder_only:
        if cache_after != steps:     # uncounted: contexts of its own
            tp2 = SV.tensor_parallel(policy, cfg)
            _, after = decode_loop(params, pre.first_token, pre.state, cfg,
                                   cache_after, tp=tp2, max_seq=m,
                                   ep=SV.expert_parallel(policy, cfg, tp2),
                                   fsdp=SV.block_gather(policy, cfg))
        out["cache_after_sha"] = _sha_tree(torch, after.cache)
        del after
    if cfg.moe is not None:
        saved["routes"] = [r.cpu() for r in routes]
    if w["pd"]:
        key = second.rsplit("_", 1)[-1]
        gtc = SV.transfer_config(second, backend="cuda")
        gsess = SV.hop_plan(cfg, policy, gtc, b, m, prompt).session(
            device=device)
        dist.barrier()   # both pods start the second hop together
        if res.pod == 0:
            blocks = res.prefill.state.cache
            out["held_cache"] = nbytes(blocks)
            out["shard_sha"] = _sha_tree(torch, blocks)
            out["cache_replicated_sha"] = replicated_cache(blocks)
            out["hop"]["raw_bytes"] = nbytes(blocks)
            out["prefill_ms"] = window_ms - comm.seconds * 1e3
            out["first_token"] = res.prefill.first_token.tolist()
            saved.update(prefill=frames[-1] if cfg.encoder_only
                         else res.prefill.last_logits.float().cpu(),
                         first=res.prefill.first_token.cpu(),
                         state_prefill=f32_blocks(blocks))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, glaunch = counted(gsess.transfer_shard, blocks)
        else:
            out["held_cache"] = nbytes(res.received)
            out["shard_sha"] = _sha_tree(torch, res.received)
            out["hop"]["raw_bytes"] = nbytes(res.received)
            out["first_token"] = res.first_token.tolist()
            out["after_replicated_sha"] = replicated_cache(res.state.cache)
            saved["first"] = res.first_token.cpu()
            if res.tokens is not None:
                out["tokens"] = res.tokens.tolist()
                saved.update(steps=torch.stack(logits),
                             tokens=res.tokens.cpu(),
                             state_after=f32_blocks(res.state.cache))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, glaunch = counted(gsess.transfer_shard, None)
            out[key + "_sha"] = _sha_tree(torch, got)
            del got
        torch.cuda.synchronize()
        gst, gcomm = gsess.last_stats, gsess.last_comm
        out[key] = dict(ms=(time.perf_counter() - t0) * 1e3,
                        wire_bytes=gst.wire_bytes,
                        retry_steps=gst.n_retry_steps,
                        leaf_ok=gst.leaf_ok, launches=glaunch,
                        routes=_hop_routes(gsess, gcomm))
    if len(stamps) > 1:
        out["decode_step_ms"] = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
    out["tp_fwd"] = dict(sent_bytes=tp.fwd.sent_bytes,
                         recv_bytes=tp.fwd.recv_bytes,
                         wire_ms=tp.fwd.wire_s * 1e3,
                         staging_ms=tp.fwd.staging_s * 1e3)
    if ep is not None:
        out["ep"] = {k: dict(recv_bytes=c.recv_bytes, sent_bytes=c.sent_bytes,
                             wire_ms=c.wire_s * 1e3,
                             staging_ms=c.staging_s * 1e3)
                     for k, c in (("route", ep.fwd),
                                  ("out_gather", ep.out_gather))}
        out["ep"]["group_size"] = ep.size
        out["ep"]["experts"] = [ep.experts.start, ep.experts.stop]
    ptrs = {x.untyped_storage().data_ptr() for x in TR.leaves(params)}
    out["param_storages_over_model"] = len(ptrs & seen)
    out["storages_over_model"] = len(seen)
    serve_peak = _peak_gb(torch)
    out.update(peak_gb=max(draw_peak, serve_peak), serve_peak_gb=serve_peak,
               held_gb=held_gb)
    out["seconds"] = seconds
    torch.save(saved, Path(out_dir) / f"{tag}_rank{rank}.pt")
    return out


def _hop_routes(session, comm):
    """A mesh hop's bytes by route (``splitzip``, ``fp32_hilo``, ``raw``)
    from its unit records, one a leaf in plan order (the tensor path): the
    shard's raw bytes, the wire bytes handed to gloo, the units that fell
    back raw and the capacity steps they took."""
    from repro_torch.serving import collective as CL
    shard = session._shard_plan_session().plan
    out = {}
    for r, rec in zip(shard.routes, comm.records):
        d = out.setdefault(r.route, dict(raw=0, wire=0, units=0, fallback=0,
                                         retry_steps=0))
        d["raw"] += r.n_elements * (4 if r.dtype == "float32" else 2)
        d["wire"] += rec[4]
        d["units"] += 1
        d["fallback"] += rec[0] == CL.FALLBACK
        d["retry_steps"] += rec[5]
    for d in out.values():
        d["ratio"] = d["raw"] / max(d["wire"], 1)
    return out


def serve_replay(torch, device, cfg, worlds, out_dir, tag_of, *,
                 prompt=SERVE_TP_PROMPT, max_seq=SERVE_TP_MAX_SEQ):
    """The single-process run the ranks of ``worlds`` (``world -> ranks``,
    their files ``<tag_of(world)>_rank<r>.pt``) are held to: the whole
    seeded parameters, ``prefill_step`` on the whole batch, and for each
    decode rank ``serve_step`` on the tokens it chose (teacher-forced; the
    model ranks of one (pod, data) coordinate share one replay where
    their tokens agree); a MoE routed as the ranks recorded, each world's
    prefill as its prefill ranks and each decode rank's steps as it did
    (:class:`_forced_routes`); and the round-off witness, the same run
    with every row product (``wo``, the SwiGLU's ``w_down``) an f32
    product rounded once, as the ranks' sums are, unsplit.  Per world and
    rank: the largest excess of its vocab columns' distance from the
    replay's over ``rtol |ref|``, prefill and decode apart, the largest
    distance itself, a recurrent family's largest distance of its f32
    state blocks from the replay's (after the prefill, after the steps),
    its tokens' agreement with the replay's greedy
    choice, how many of them the replay's top logit leads by
    ``SERVE_FAM_MARGIN`` and by twice that largest distance, how many of
    those differ, and the replay's leads where they differ; the same for
    a prefill rank's first token (an encoder-only config's first unit,
    from frame 0, whose prefill logits are every frame's); and the
    witness's excess over the whole vocabulary, prefill and decode (for
    a recurrent family also ``witness_before``: the witness without its
    ``out_proj`` / ``w_out`` products, :class:`_f32_row_products`)."""
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        SERVE_TP_SEED), device)
    saved = {(world, r["rank"]): (r, torch.load(
        Path(out_dir) / f"{tag_of(world)}_rank{r['rank']}.pt"))
        for world, ranks in worlds.items() for r in ranks}
    ref = _replay_logits(torch, device, cfg, params, saved, prompt, max_seq)
    with _f32_row_products():
        wit = _replay_logits(torch, device, cfg, params, saved, prompt,
                             max_seq)
    before = None
    if cfg.ssm is not None or cfg.hybrid is not None:
        with _f32_row_products(recurrent=False):
            before = _replay_logits(torch, device, cfg, params, saved, prompt,
                                    max_seq)
    del params
    torch.cuda.synchronize()
    seconds, peak = time.perf_counter() - t0, _peak_gb(torch)

    def dist_(got, want):
        d = (got - want).abs()
        return (d - SERVE_TP_RTOL * want.abs()).max().item(), d.max().item()

    states = ref.pop("states")
    pre_keys = [k for k in ref if k[0] == "prefill"]
    steps = [k for k in ref if k[0] != "prefill"]

    def witness(w):
        w.pop("states")
        out = {}
        for when, keys in (("prefill", pre_keys), ("decode", steps)):
            if keys:
                out[f"{when}_excess"] = max(dist_(w[k], ref[k])[0]
                                            for k in keys)
                out[f"{when}_max_abs"] = max(dist_(w[k], ref[k])[1]
                                             for k in keys)
        return out
    out = {"witness": witness(wit)}
    if before is not None:
        out["witness_before"] = witness(before)
    v = cfg.vocab_size
    for (world, rank), (r, sv) in saved.items():
        if "prefill" not in sv and "steps" not in sv:
            # an encoder-only pod-1 rank: the first units it received
            out.setdefault(world, []).append({"rank": rank})
            continue
        local = sv["prefill"] if "prefill" in sv else sv["steps"][0]
        n = local.shape[-1]
        mr = r["coord"]["model"] % (v // n)
        cols = slice(mr * n, (mr + 1) * n)
        rec = {"rank": rank}
        if "prefill" in sv:
            want = ref[("prefill", world)][sv["rows"]]
            if sv["prefill"].shape != want[..., cols].shape:
                raise AssertionError(f"rank {rank} ({world}): prefill logits "
                                     f"{tuple(sv['prefill'].shape)}, the "
                                     f"replay's {tuple(want[..., cols].shape)}")
            rec["prefill_excess"], rec["prefill_max_abs"] = dist_(
                sv["prefill"], want[..., cols])
            lg = want[:, 0] if cfg.encoder_only else want
            top2 = torch.topk(lg, 2, dim=-1).values
            lead = top2[:, 0] - top2[:, 1]
            same = torch.argmax(lg, -1) == sv["first"].long()
            held = lead >= max(SERVE_FAM_MARGIN, 2 * rec["prefill_max_abs"])
            rec["first_agreement"] = float(same.float().mean())
            rec["first_held"] = int(held.sum())
            rec["first_held_differ"] = int((held & ~same).sum())
        if "steps" in sv:
            lg = ref[_decode_key(world, r, sv)]
            rec["decode_excess"], rec["decode_max_abs"] = dist_(
                sv["steps"], lg[..., cols])
            greedy = torch.argmax(lg, -1).T
            same = greedy == sv["tokens"].long()
            top2 = torch.topk(lg, 2, dim=-1).values
            lead = (top2[..., 0] - top2[..., 1]).T
            held = lead >= max(SERVE_FAM_MARGIN, 2 * rec["decode_max_abs"])
            rec["token_agreement"] = float(same.float().mean())
            rec["tokens_held"] = int(held.sum())
            rec["tokens_held_differ"] = int((held & ~same).sum())
            rec["leads_of_differing"] = lead[~same].tolist()
        for when, key in (("prefill", ("prefill", world)),
                          ("after", _decode_key(world, r, sv)
                           if "steps" in sv else None)):
            got = sv.get("state_" + when)
            if got:
                rec[f"state_{when}_max_abs"] = max(
                    (x - _state_block(states[key][k], k, r["coord"], world))
                    .abs().max().item() for k, x in got.items())
        out.setdefault(world, []).append(rec)
    return out, seconds, peak


def _batch_dim(name):
    """The batch dimension of a cache leaf (``models/kvcache.py``): 2 for
    the hybrid's (nt, 2, B, ...) recurrent leaves, else 1."""
    return 2 if name in ("rec_h", "rec_conv") else 1


def _state_block(whole, name, coord, world):
    """A rank's block of a whole cache leaf of the replay (its rows
    already cut to the rank's data coordinate where a decode replay ran
    them) under the world's policy (on a ``{axis: size}`` mesh)."""
    from repro_torch.distributed import sharding as SH
    w = SERVE_TP_WORLDS[world]
    sizes = dict(zip(MESH_AXES, w["mesh"]))
    policy = SH.ShardingPolicy(sizes, pd_disaggregated=w["pd"])
    spec = list(policy.spec_for_cache(name, tuple(whole.shape)))
    if whole.shape[_batch_dim(name)] != SERVE_TP_BATCH:
        spec[_batch_dim(name)] = None          # the rows are cut already
    return SH.shard_slice(whole, tuple(spec), sizes, coord)


def _decode_key(world, r, sv):
    """The replay of a decode rank: one a (pod, data) coordinate and its
    tokens."""
    c = r["coord"]
    return (world, c["pod"], c["data"], str(sv["tokens"].tolist()))


class _f32_row_products:
    """Within: the single-process model's row products (``attention_out``'s
    ``wo``, MLA's ``wo`` product, the SwiGLU's ``w_down`` and, with
    ``recurrent``, Mamba-2's ``out_proj`` and the RG-LRU's ``w_out``) as
    f32 products of the bf16 values rounded once, the arithmetic of the
    ranks' ``row_product`` without the split; and the decode steps'
    attention as the ranks' merged partials compute it over one span (the
    unnormalised ``p`` rounded to bf16, ``p . v`` or ``p . ckv`` in f32,
    normalised and rounded once: ``layers.decode_attention_tp``'s and
    ``mla.latent_partials``' arithmetic).  The replay's round-off
    witness; ``recurrent=False`` is the witness as it stood before it
    covered the recurrent products (kept to report the two side by
    side)."""

    def __init__(self, recurrent=True):
        self.recurrent = recurrent

    def __enter__(self):
        import numpy as np
        import torch
        import torch.nn.functional as F

        from repro_torch.models import layers as L
        from repro_torch.models import mla as MLA
        from repro_torch.models import rglru as RG
        from repro_torch.models import ssm as SSM
        self.saved = (L.attention_out, L.mlp, MLA._heads_out,
                      MLA.latent_attention, L.decode_attention,
                      SSM.out_product, RG.out_product)
        out, mlp, _, _, _, _, _ = self.saved

        def attention_out(p, o, tp=None):
            if tp is not None:
                return out(p, o, tp)
            return heads_out(o, p["wo"])

        def heads_out(o, w):
            h, k, d = w.shape
            return torch.matmul(o.reshape(*o.shape[:-2], h * k).float(),
                                w.reshape(h * k, d).float()).to(o.dtype)

        def swiglu(p, x, tp=None):
            if tp is not None:
                return mlp(p, x, tp)
            a = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
            return torch.matmul(a.float(), p["w_down"].float()).to(x.dtype)

        def latent_attention(q_lat, q_rope, ckv, krope, n_valid, scale):
            m, l, acc = MLA.latent_partials(q_lat, q_rope, ckv, krope, 0,
                                            n_valid, scale)
            return (acc / l[..., None]).to(ckv.dtype)

        def decode_attention(q, k, v, cache_len, *, window=None, scale=None):
            b, sq, h, d = q.shape
            hkv, dv = k.shape[2], v.shape[-1]
            qg = q.reshape(b, sq, hkv, h // hkv, d).permute(0, 2, 3, 1, 4).float()
            sc = torch.matmul(qg, k.permute(0, 2, 1, 3).float()[:, :, None]
                              .transpose(-1, -2))
            sc = sc * scale if scale is not None else sc / np.sqrt(d)
            pos = torch.arange(k.shape[1], device=q.device)
            valid = pos[None, :] < cache_len[:, None]
            if window is not None:
                valid &= pos[None, :] >= cache_len[:, None] - window
            sc = torch.where(valid[:, None, None, None, :], sc,
                             torch.tensor(L.NEG_INF, device=q.device))
            m = sc.amax(dim=-1)
            pr = torch.exp(sc - m[..., None])
            acc = torch.matmul(pr.to(v.dtype).float(),
                               v.permute(0, 2, 1, 3).float()[:, :, None])
            o = acc / pr.sum(dim=-1)[..., None]
            return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
        def row_product(y, w):
            return torch.matmul(y.float(), w.float()).to(y.dtype)
        (L.attention_out, L.mlp, MLA._heads_out, MLA.latent_attention,
         L.decode_attention) = (attention_out, swiglu, heads_out,
                                latent_attention, decode_attention)
        if self.recurrent:
            SSM.out_product = RG.out_product = row_product
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        from repro_torch.models import mla as MLA
        from repro_torch.models import rglru as RG
        from repro_torch.models import ssm as SSM
        (L.attention_out, L.mlp, MLA._heads_out, MLA.latent_attention,
         L.decode_attention, SSM.out_product, RG.out_product) = self.saved
        return False


def _replay_logits(torch, device, cfg, params, saved, prompt, max_seq):
    """The single-process prefill's last logits (B, V) of each world
    (``("prefill", world)``; an encoder-only config's every frame's, (B,
    S, V); one run for every world but a MoE's, routed
    as each world's prefill ranks were) and, for each decode (pod, data)
    coordinate (:func:`_decode_key`), its teacher-forced steps' logits
    (steps, B_rank, V), f32 on the host; under ``"states"`` the f32 cache
    leaves after each (a recurrent family's states; on the host)."""
    import contextlib

    from repro_torch.models.kvcache import DecodeState
    from repro_torch.serving.decode import serve_step
    from repro_torch.serving.prefill import prefill_step

    from repro_torch.models import model as M

    moe = cfg.moe is not None
    batch = {k: x.to(device) for k, x in
             serve_tp_prompt(torch, cfg, prompt).items()}
    out, pre, states = {}, None, {}

    def f32(cache):
        return {k: x.cpu() for k, x in cache.items()
                if x.dtype == torch.float32}
    for world in sorted({w for w, _ in saved}):
        ranks = [(r, sv) for (w, _), (r, sv) in saved.items() if w == world]
        if pre is None or moe:
            forced = contextlib.nullcontext()
            if moe:
                heads = sorted(((r["coord"]["data"], sv) for r, sv in ranks
                                if "prefill" in sv and r["coord"]["model"] == 0),
                               key=lambda t: t[0])
                forced = _forced_routes(
                    [torch.cat([sv["routes"][i] for _, sv in heads])
                     for i in range(cfg.num_layers)])
            del pre
            with forced:
                pre = prefill_step(params, batch, cfg, max_seq=max_seq)
                if cfg.encoder_only:   # every frame's logits
                    frames = M.prefill(params, batch, cfg,
                                       max_seq=max_seq)[0].float().cpu()
        out[("prefill", world)] = frames if cfg.encoder_only else \
            pre.last_logits.float().cpu()
        states[("prefill", world)] = f32(pre.state.cache)
        for r, sv in ranks:
            key = _decode_key(world, r, sv) if "steps" in sv else None
            if key is None or key in out:
                continue
            rows = torch.as_tensor(sv["rows"], device=device)
            st = DecodeState(cache={k: x.index_select(_batch_dim(k), rows)
                                    for k, x in pre.state.cache.items()},
                             cache_len=pre.state.cache_len[rows])
            feed = torch.cat([sv["first"][:, None], sv["tokens"][:, :-1]],
                             dim=1).to(device, torch.int32)
            forced = contextlib.nullcontext()
            if moe:
                n_pre = cfg.num_layers if "prefill" in sv else 0
                forced = _forced_routes(sv["routes"][n_pre:])
            steps = []
            with forced:
                for i in range(feed.shape[1]):
                    lg, st = serve_step(params, feed[:, i:i + 1], st, cfg)
                    steps.append(lg.float().cpu())
            out[key] = torch.stack(steps)
            states[key] = f32(st.cache)
            del st
    del pre
    out["states"] = states
    return out


def _serve_tp_gates(world, ranks, replay, layers, tag, tokens=False,
                    case="heads", second="global", first=False,
                    causal=True, empty_hop=False):
    """Sharded serving's gates on one world's ranks (``layers`` attention
    layers of attention ``case``, None for an attention-free family, each
    prefill launch ``causal`` or every one not; ``tokens``: the decoded
    tokens held equal to the replay's greedy choice where its lead allows,
    :func:`serve_replay`, and ``first`` the prefill ranks' first tokens or
    units likewise; ``second``: the second hop's variant suffix;
    ``empty_hop``: the cache is empty, so both hops move 0 bytes with no
    codec launch); returns the numbers each gate read."""
    w = SERVE_TP_WORLDS[world]
    tag = f"{tag} ({world})"
    gates = {}
    for r in ranks:
        if r["case"] != case:
            raise AssertionError(f"{tag} rank {r['rank']}: attention case "
                                 f"{r['case']}, want {case}")
        if r["chunked_attention_calls"]:
            raise AssertionError(f"{tag} rank {r['rank']}: "
                                 f"{r['chunked_attention_calls']} calls of "
                                 "chunked_attention in a served window")
        if r["held_params"] != r["spec_params"]:
            raise AssertionError(f"{tag} rank {r['rank']}: holds "
                                 f"{r['held_params']} parameter bytes, the "
                                 f"specs give {r['spec_params']}")
        if not r["held_cache"] == r["spec_cache"] == r["init_cache"]:
            raise AssertionError(f"{tag} rank {r['rank']}: cache bytes "
                                 f"{r['held_cache']}, specs {r['spec_cache']}, "
                                 f"init_cache {r['init_cache']}")
        # a rank that ran the model (not an encoder-only pod 1, which
        # decodes nothing) handed some tensors to collectives over model
        ran = r.get("pod", 0) == 0 or "tokens" in r
        if r["param_storages_over_model"] or \
                bool(r["storages_over_model"]) != ran:
            raise AssertionError(
                f"{tag} rank {r['rank']}: {r['param_storages_over_model']} "
                f"parameter storages of {r['storages_over_model']} handed to "
                f"collectives over model (want 0 of "
                f"{'some' if ran else 'none'})")
    gates["held_bytes"] = {r["rank"]: [r["held_params"], r["held_cache"]]
                           for r in ranks}
    # model replicas: every rank of one model coordinate holds the same
    # parameter blocks (of one (model, data) coordinate under fsdp), every
    # rank the same replicated leaves, every model rank of one (pod, data)
    # coordinate the same tokens
    by_model, toks, states = {}, {}, {}
    for r in ranks:
        c = r["coord"]
        by_model.setdefault((c["model"], c["data"] if w.get("fsdp") else 0),
                            set()).add(r["params_sha"])
        if "tokens" in r:
            toks.setdefault((c["pod"], c["data"]), set()).add(str(r["tokens"]))
        for k in ("cache_replicated_sha", "after_replicated_sha"):
            if k in r:
                states.setdefault((k, c["pod"], c["data"]), set()).add(r[k])
    if any(len(v) != 1 for v in by_model.values()) or \
            len({r["replicated_sha"] for r in ranks}) != 1 or \
            any(len(v) != 1 for v in toks.values()) or \
            any(len(v) != 1 for v in states.values()):
        raise AssertionError(f"{tag}: model replicas disagree")
    gates["replicas"] = {"param_blocks": len(by_model),
                         "token_sets": len(toks),
                         "cache_replica_sets": len(states)}
    # flash: one tensor-core launch a layer on every prefill rank, causal
    # or every one not as the family attends, none in decode
    for r in ranks:
        prefills = ("pod" not in r) or r["pod"] == 0
        want = layers if prefills else 0
        got = (r["launches"]["flash_attention"],
               r["launches"]["flash_attention_tc"],
               r["launches"]["flash_attention_causal"])
        if got != (want, want, want if causal else 0) or r.get(
                "decode_launches", {}).get("flash_attention", 0):
            raise AssertionError(f"{tag} rank {r['rank']}: flash launches "
                                 f"(all, tensor-core, causal) {got}, want "
                                 f"{want} (tensor-core, "
                                 f"{'causal' if causal else 'not causal'}), "
                                 "and none in decode")
    gates["flash"] = {r["rank"]: r["launches"]["flash_attention_tc"]
                      for r in ranks}
    gates["flash_causal"] = causal
    if w["pd"]:
        by = {(r["coord"]["pod"], r["coord"]["data"], r["coord"]["model"]): r
              for r in ranks}
        for (pod, d, mo), r in by.items():
            if pod == 1:
                src = by[(0, d, mo)]
                if not r["shard_sha"] == src["shard_sha"] == r[second + "_sha"]:
                    raise AssertionError(f"{tag}: pod 1's shard ({d}, {mo}) "
                                         "is not pod 0's")
                if r["first_token"] != src["first_token"]:
                    raise AssertionError(f"{tag}: pod 1's first tokens "
                                         f"({d}, {mo}) are not pod 0's")
        codec = ("encode_fused", "encode_dense", "decode_fused",
                 "decode_dense")
        enc = sum(r["launches"]["encode_fused"] for r in ranks if r["pod"] == 0)
        dec = sum(r["launches"]["decode_fused"] for r in ranks if r["pod"] == 1)
        genc = sum(r[second]["launches"][k] for r in ranks if r["pod"] == 0
                   for k in ("encode_fused", "encode_dense"))
        gdec = sum(r[second]["launches"][k] for r in ranks if r["pod"] == 1
                   for k in ("decode_fused", "decode_dense"))
        if empty_hop:
            moved = {r["rank"]: (r["hop"]["raw_bytes"], r["hop"]["wire_bytes"],
                                 r[second]["wire_bytes"],
                                 sum(r["launches"][k] + r[second]["launches"][k]
                                     for k in codec))
                     for r in ranks}
            if any(v != (0, 0, 0, 0) for v in moved.values()):
                raise AssertionError(f"{tag}: the empty hop moved (raw, wire, "
                                     f"{second} wire bytes, codec launches) "
                                     f"{moved}, want 0 each")
            gates["empty_hop"] = moved
        elif not (enc and dec and genc and gdec):
            raise AssertionError(f"{tag}: the hop's codec launches: chunked "
                                 f"encode {enc} decode {dec}, {second} "
                                 f"encode {genc} decode {gdec}")
        gates["hop_codec"] = dict(encode=enc, decode=dec, global_encode=genc,
                                  global_decode=gdec)
    # the ranks' logits against the single-process replay's: within the
    # CPU tests' bound, or within SERVE_TP_WITNESS times the distance the
    # replay itself moves when only its row products round elsewhere
    worst, allowed = {}, {}
    for rec in replay[world]:
        for k in ("prefill_excess", "decode_excess"):
            if k in rec:
                worst[k] = max(worst.get(k, -1e30), rec[k])
                allowed[k] = max(SERVE_TP_ATOL,
                                 SERVE_TP_WITNESS * replay["witness"][k])
    if not worst or any(worst[k] > allowed[k] for k in worst):
        raise AssertionError(f"{tag}: logits {worst} beyond {allowed} "
                             f"(atol {SERVE_TP_ATOL} or {SERVE_TP_WITNESS} x "
                             f"the witness {replay['witness']}) over rtol "
                             f"{SERVE_TP_RTOL} |ref| of the single-process "
                             f"replay: {replay[world]}")
    gates["logits_excess"] = dict(worst=worst, allowed=allowed,
                                  within_cpu_bound=max(worst.values())
                                  <= SERVE_TP_ATOL)
    if first:
        pres = [rec for rec in replay[world] if "first_agreement" in rec]
        bad = [rec for rec in pres if rec["first_held_differ"]]
        if not pres or bad:
            raise AssertionError(f"{tag}: first tokens or units differ from "
                                 f"the replay's greedy choice where its lead "
                                 f"is at least {SERVE_FAM_MARGIN} and twice "
                                 f"the logits' distance: {bad}")
        gates["first"] = {rec["rank"]: dict(
            agreement=rec["first_agreement"], held=rec["first_held"])
            for rec in pres}
    if tokens:
        decs = [rec for rec in replay[world] if "token_agreement" in rec]
        bad = [rec for rec in decs if rec["tokens_held_differ"]]
        if not decs or bad:
            raise AssertionError(f"{tag}: decoded tokens differ from the "
                                 f"replay's greedy choice where its lead is "
                                 f"at least {SERVE_FAM_MARGIN} and twice the "
                                 f"logits' distance: {bad}")
        gates["tokens"] = {rec["rank"]: dict(
            agreement=rec["token_agreement"], held=rec["tokens_held"])
            for rec in decs}
    return gates


def _serve_windows(prefix, worlds, second="global"):
    """Each rank's launch windows: ``<prefix>_xfer_src<m>`` / ``_dst<m>``,
    ``<prefix>_<second>_*`` and ``<prefix>_base_prefill<r>`` /
    ``_decode<r>`` (and ``<prefix>_fsdp_*`` likewise where that world
    ran)."""
    windows = {}
    for r in worlds["xfer"]:
        side = "src" if r["pod"] == 0 else "dst"
        windows[f"{prefix}_xfer_{side}{r['coord']['model']}"] = r["launches"]
        windows[f"{prefix}_{second}_{side}{r['coord']['model']}"] = \
            r[second]["launches"]
    for world in ("base", "fsdp"):
        for r in worlds.get(world, ()):
            windows[f"{prefix}_{world}_prefill{r['rank']}"] = r["launches"]
            windows[f"{prefix}_{world}_decode{r['rank']}"] = \
                r["decode_launches"]
    return windows


def _spawn_serving(body, out_dir, names=SERVE_FAMILY_WORLDS):
    """Each world ``names`` of ``SERVE_TP_WORLDS`` spawned once for
    ``body``: its ranks' dicts and the seconds it took."""
    worlds, seconds = {}, {}
    for world in names:
        t0 = time.perf_counter()
        worlds[world] = run_ranks(body, math.prod(SERVE_TP_WORLDS[world][
            "mesh"]), world, str(out_dir))
        seconds[world] = time.perf_counter() - t0
    return worlds, seconds


def _fsdp_gates(worlds):
    """Phase ``serve_tp``'s ``fsdp`` world against its ``base`` world, rank
    by rank at one coordinate: held parameter bytes ``SERVE_TP_FSDP_HELD``;
    bitwise the base world's first tokens, its first steps' tokens, the
    prefill's and each step's logits, and the cache blocks after the
    prefill and after those steps; gathers in every pass of the ``fsdp``
    world and none in the ``base`` one.  A row a rank: the gathers' bytes,
    ms and all-gathers a pass (the prefill's, a decode step's), prefill
    and decode-step ms beside the base world's, held bytes and the peaks
    read after the draw."""
    n = SERVE_TP_WORLDS["fsdp"]["steps"]
    base = {r["rank"]: r for r in worlds["base"]}
    rows = {}
    for r in worlds["fsdp"]:
        b = base[r["rank"]]
        tag = f"serve_tp (fsdp) rank {r['rank']}"
        if r["coord"] != b["coord"]:
            raise AssertionError(f"{tag}: coordinate {r['coord']}, base "
                                 f"{b['coord']}")
        if r["held_params"] != SERVE_TP_FSDP_HELD:
            raise AssertionError(f"{tag}: holds {r['held_params']} parameter "
                                 f"bytes, want {SERVE_TP_FSDP_HELD}")

        def view(x):
            return dict(first=x["first_token"],
                        tokens=[t[:n] for t in x["tokens"]],
                        prefill_logits=x["prefill_logits_sha"],
                        step_logits=x["step_logits_sha"][:n],
                        cache_prefill=x["cache_prefill_sha"],
                        cache_after=x["cache_after_sha"])
        got, want = view(r), view(b)
        if got != want:
            raise AssertionError(f"{tag}: not bitwise the base world's first "
                                 f"{n} steps: "
                                 f"{sorted(k for k in got if got[k] != want[k])}")
        pg, g = r["prefill_gather"], r["gather"]
        if not pg["calls"] or g["calls"] <= pg["calls"] or b["gather"]["calls"]:
            raise AssertionError(f"{tag}: all-gathers prefill {pg['calls']}, "
                                 f"all {g['calls']}, base "
                                 f"{b['gather']['calls']}")
        rows[r["rank"]] = dict(
            coord=r["coord"], held_params=r["held_params"],
            base_held_params=b["held_params"], held_gb=r["held_gb"],
            base_held_gb=b["held_gb"],
            serve_peak_gb=r["serve_peak_gb"],
            base_serve_peak_gb=b["serve_peak_gb"], peak_gb=r["peak_gb"],
            base_peak_gb=b["peak_gb"],
            prefill_gather=pg, decode_gather_a_step=dict(
                sent_bytes=(g["sent_bytes"] - pg["sent_bytes"]) / n,
                calls=(g["calls"] - pg["calls"]) / n,
                ms=(g["ms"] - pg["ms"]) / n),
            gather=g, prefill_ms=r["prefill_ms"],
            base_prefill_ms=b["prefill_ms"],
            decode_step_ms=r.get("decode_step_ms"),
            base_decode_step_ms=b.get("decode_step_ms"))
    return rows


#: phase ``serve_tp``'s ranks' dicts by world, for phase ``dryrun`` (b)
SERVE_TP_COUNTS: dict = {}


def phase_serve_tp(torch, smi):
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="serve_tp_", dir=ROOT / "build"))
    cfg = serve_tp_config()
    try:
        worlds, seconds = _spawn_serving("serve_tp_rank", out_dir,
                                         tuple(SERVE_TP_WORLDS))
        replay, seconds["replay"], replay_peak = serve_replay(
            torch, device, cfg, worlds, out_dir, lambda world: world)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    gates = {world: _serve_tp_gates(world, ranks, replay, SERVE_TP_LAYERS,
                                    "serve_tp")
             for world, ranks in worlds.items()}
    gates["fsdp"]["against_base"] = _fsdp_gates(worlds)
    SERVE_TP_COUNTS.update(worlds)       # phase dryrun's predictions' targets
    emit(phase="serve_tp", nvidia_smi=smi, arch=cfg.name,
         layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         batch=SERVE_TP_BATCH, prompt=SERVE_TP_PROMPT,
         max_seq=SERVE_TP_MAX_SEQ, steps=SERVE_TP_STEPS, transport="gloo",
         worlds={k: dict(mesh=list(SERVE_TP_WORLDS[k]["mesh"]),
                         variant=SERVE_TP_WORLDS[k]["variant"],
                         fsdp=SERVE_TP_WORLDS[k].get("fsdp", False),
                         steps=SERVE_TP_WORLDS[k].get("steps",
                                                      SERVE_TP_STEPS),
                         ranks=v)
                 for k, v in worlds.items()},
         replay=replay, replay_peak_gb=replay_peak, gates=gates,
         bound=dict(atol=SERVE_TP_ATOL, rtol=SERVE_TP_RTOL),
         seconds=dict(**seconds, phase=time.perf_counter() - t_phase))
    return _serve_windows("serve_tp", worlds)


def phase_serve_tp_families(torch, smi):
    """Sharded serving of MLA and of MoE under expert parallelism: each
    world spawned once for both families (``serve_families_rank``), then
    each family's single-process replay and gates; a line a rank and
    family, then the phase's line."""
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="serve_fam_", dir=ROOT / "build"))
    replays, windows, gates, seconds = {}, {}, {}, {}
    try:
        both, seconds = _spawn_serving("serve_families_rank", out_dir)
        worlds = {fam: {world: [r[fam] for r in ranks]
                        for world, ranks in both.items()}
                  for fam in SERVE_FAMILIES}
        for fam in SERVE_FAMILIES:
            cfg = serve_family_config(fam)
            replays[fam], seconds[f"replay_{fam}"], peak = serve_replay(
                torch, device, cfg, worlds[fam], out_dir,
                lambda world, fam=fam: f"{fam}_{world}")
            replays[fam]["peak_gb"] = peak
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    failed = []
    for fam in SERVE_FAMILIES:
        cfg = serve_family_config(fam)
        gates[fam] = {}
        for world, ranks in worlds[fam].items():
            try:
                gates[fam][world] = _serve_tp_gates(
                    world, ranks, replays[fam], cfg.num_layers,
                    f"serve_tp_families {fam}", tokens=True)
            except AssertionError as e:   # every gate read, then raised
                gates[fam][world] = {"failed": str(e)}
                failed.append(str(e))
        windows.update(_serve_windows(f"serve_fam_{fam}", worlds[fam]))
        for world, ranks in worlds[fam].items():
            for r in ranks:
                hop = r.get("hop")
                emit(phase="serve_tp_families_rank", family=fam,
                     arch=cfg.name, world=world, rank=r["rank"],
                     coord=r["coord"], prefill_ms=r.get("prefill_ms"),
                     decode_step_ms=r.get("decode_step_ms"),
                     tp_fwd=r["tp_fwd"], ep=r.get("ep"),
                     hop=None if hop is None else dict(
                         raw_bytes=hop["raw_bytes"],
                         wire_bytes=hop["wire_bytes"],
                         ratio=hop["raw_bytes"] / max(hop["wire_bytes"], 1),
                         retry_steps=hop["retry_steps"], ms=hop["ms"]),
                     global_hop=r.get("global"),
                     held=dict(params=r["held_params"],
                               cache=r["held_cache"]),
                     peak_gb=r["peak_gb"])
    emit(phase="serve_tp_families", nvidia_smi=smi,
         families={fam: dict(arch=serve_family_config(fam).name,
                             layers=serve_family_config(fam).num_layers)
                   for fam in SERVE_FAMILIES},
         batch=SERVE_TP_BATCH, prompt=SERVE_TP_PROMPT,
         max_seq=SERVE_TP_MAX_SEQ, steps=SERVE_TP_STEPS, transport="gloo",
         worlds={k: dict(mesh=list(SERVE_TP_WORLDS[k]["mesh"]),
                         variant=SERVE_TP_WORLDS[k]["variant"])
                 for k in SERVE_FAMILY_WORLDS},
         replay=replays, gates=gates,
         bound=dict(atol=SERVE_TP_ATOL, rtol=SERVE_TP_RTOL,
                    witness=SERVE_TP_WITNESS, token_margin=SERVE_FAM_MARGIN),
         seconds=dict(**seconds, phase=time.perf_counter() - t_phase))
    if failed:
        raise AssertionError("serve_tp_families: " + " | ".join(failed))
    return windows


def _recurrent_gates(fam, world, ranks):
    """Phase ``serve_tp_recurrent``'s gates beside :func:`_serve_tp_gates`:
    on the hop's ranks the f32 states ship raw under ``xfer_chunked`` and
    on the ``fp32_hilo`` route under ``xfer_fp32``, whose codec is the
    dense pair (``layout='global'``) on both ends; returns what it read."""
    if not SERVE_TP_WORLDS[world]["pd"]:
        return {}
    tag = f"serve_tp_recurrent {fam} ({world})"
    for r in ranks:
        if "raw" not in r["hop"]["routes"] or \
                "fp32_hilo" not in r["fp32"]["routes"]:
            raise AssertionError(f"{tag} rank {r['rank']}: routes "
                                 f"{sorted(r['hop']['routes'])} / "
                                 f"{sorted(r['fp32']['routes'])}: the f32 "
                                 "states ship raw, then as fp32_hilo")
    enc = sum(r["fp32"]["launches"]["encode_dense"] for r in ranks
              if r["pod"] == 0)
    dec = sum(r["fp32"]["launches"]["decode_dense"] for r in ranks
              if r["pod"] == 1)
    if not (enc and dec):
        raise AssertionError(f"{tag}: xfer_fp32's dense codec launches: "
                             f"encode {enc}, decode {dec}")
    return dict(fp32_dense_encode=enc, fp32_dense_decode=dec)


def phase_serve_tp_recurrent(torch, smi):
    """Sharded serving of Mamba-2 and of the RG-LRU hybrid: each world of
    ``SERVE_TP_WORLDS`` spawned once for both families
    (``serve_recurrent_rank``), the (2, 1, 2) hop under ``xfer_chunked``
    then ``xfer_fp32``; then each family's single-process replay and
    gates; a line a rank and family, then the phase's line."""
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="serve_rec_", dir=ROOT / "build"))
    replays, windows, gates = {}, {}, {}
    try:
        both, seconds = _spawn_serving("serve_recurrent_rank", out_dir)
        worlds = {fam: {world: [r[fam] for r in ranks]
                        for world, ranks in both.items()}
                  for fam in SERVE_RECURRENT}
        for fam, c in SERVE_RECURRENT.items():
            replays[fam], seconds[f"replay_{fam}"], peak = serve_replay(
                torch, device, _depth_cut(c["arch"], c["layers"]),
                worlds[fam], out_dir, lambda world, fam=fam: f"rec_{fam}_{world}",
                prompt=c["prompt"], max_seq=c["max_seq"])
            replays[fam]["peak_gb"] = peak
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    failed = []
    for fam, c in SERVE_RECURRENT.items():
        cfg = _depth_cut(c["arch"], c["layers"])
        attn = cfg.num_layers // 3 if cfg.hybrid is not None else 0
        gates[fam] = {}
        for world, ranks in worlds[fam].items():
            try:
                gates[fam][world] = _serve_tp_gates(
                    world, ranks, replays[fam], attn,
                    f"serve_tp_recurrent {fam}", tokens=True,
                    case="kv" if attn else None, second="fp32")
                gates[fam][world].update(_recurrent_gates(fam, world, ranks))
            except AssertionError as e:   # every gate read, then raised
                gates[fam][world] = {"failed": str(e)}
                failed.append(str(e))
        windows.update(_serve_windows(f"serve_rec_{fam}", worlds[fam],
                                      second="fp32"))
        for world, ranks in worlds[fam].items():
            rep_of = {rec["rank"]: rec for rec in replays[fam][world]}
            for r in ranks:
                hop = r.get("hop")
                emit(phase="serve_tp_recurrent_rank", family=fam,
                     arch=cfg.name, world=world, rank=r["rank"],
                     coord=r["coord"], prefill_ms=r.get("prefill_ms"),
                     decode_step_ms=r.get("decode_step_ms"),
                     decode_collectives=r.get("decode_collectives"),
                     tp_fwd=r["tp_fwd"],
                     hop=None if hop is None else dict(
                         raw_bytes=hop["raw_bytes"],
                         wire_bytes=hop["wire_bytes"],
                         ratio=hop["raw_bytes"] / max(hop["wire_bytes"], 1),
                         retry_steps=hop["retry_steps"], ms=hop["ms"],
                         routes=hop["routes"]),
                     fp32_hop=r.get("fp32"),
                     held=dict(params=r["held_params"],
                               cache=r["held_cache"]),
                     peak_gb=r["peak_gb"],
                     state_max_abs={k: rep_of[r["rank"]].get(
                         f"state_{k}_max_abs") for k in ("prefill", "after")})
    emit(phase="serve_tp_recurrent", nvidia_smi=smi,
         families={fam: dict(arch=c["arch"], layers=c["layers"],
                             prompt=c["prompt"], max_seq=c["max_seq"])
                   for fam, c in SERVE_RECURRENT.items()},
         batch=SERVE_TP_BATCH, steps=SERVE_TP_STEPS, transport="gloo",
         worlds={k: dict(mesh=list(v["mesh"]), variant=v["variant"],
                         second="xfer_fp32" if v["pd"] else None)
                 for k, v in SERVE_TP_WORLDS.items()
                 if k in SERVE_FAMILY_WORLDS},
         replay=replays, gates=gates,
         bound=dict(atol=SERVE_TP_ATOL, rtol=SERVE_TP_RTOL,
                    witness=SERVE_TP_WITNESS, token_margin=SERVE_FAM_MARGIN),
         seconds=dict(**seconds, phase=time.perf_counter() - t_phase))
    if failed:
        raise AssertionError("serve_tp_recurrent: " + " | ".join(failed))
    return windows


def phase_serve_tp_frontends(torch, smi):
    """Sharded serving of the front ends: each world of ``SERVE_TP_WORLDS``
    spawned once for both (``serve_frontends_rank``); pixtral-12b's
    patches before the sequence-split cache (the hop ``xfer_chunked`` then
    ``xfer_global``), hubert-xlarge's prefill cell (every frame's vocab
    columns, its flash launches all non-causal) and the hop of its empty
    cache; then each one's single-process replay and gates; a line a rank
    and front end, then the phase's line."""
    import shutil
    import tempfile
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="serve_fe_", dir=ROOT / "build"))
    replays, windows, gates = {}, {}, {}
    try:
        both, seconds = _spawn_serving("serve_frontends_rank", out_dir)
        worlds = {fam: {world: [r[fam] for r in ranks]
                        for world, ranks in both.items()}
                  for fam in SERVE_FRONTENDS}
        for fam, c in SERVE_FRONTENDS.items():
            replays[fam], seconds[f"replay_{fam}"], peak = serve_replay(
                torch, device, _depth_cut(c["arch"], c["layers"]),
                worlds[fam], out_dir, lambda world, fam=fam: f"fe_{fam}_{world}",
                prompt=c["prompt"], max_seq=c["max_seq"])
            replays[fam]["peak_gb"] = peak
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    failed = []
    for fam, c in SERVE_FRONTENDS.items():
        cfg = _depth_cut(c["arch"], c["layers"])
        gates[fam] = {}
        for world, ranks in worlds[fam].items():
            try:
                gates[fam][world] = _serve_tp_gates(
                    world, ranks, replays[fam], cfg.num_layers,
                    f"serve_tp_frontends {fam}", tokens=not cfg.encoder_only,
                    first=True, causal=not cfg.encoder_only,
                    empty_hop=cfg.encoder_only)
            except AssertionError as e:   # every gate read, then raised
                gates[fam][world] = {"failed": str(e)}
                failed.append(str(e))
        windows.update(_serve_windows(f"serve_fe_{fam}", worlds[fam]))
        for world, ranks in worlds[fam].items():
            for r in ranks:
                hop = r.get("hop")
                emit(phase="serve_tp_frontends_rank", family=fam,
                     arch=cfg.name, world=world, rank=r["rank"],
                     coord=r["coord"], prefill_ms=r.get("prefill_ms"),
                     decode_step_ms=r.get("decode_step_ms"),
                     decode_collectives=r.get("decode_collectives"),
                     tp_fwd=r["tp_fwd"],
                     hop=None if hop is None else dict(
                         raw_bytes=hop["raw_bytes"],
                         wire_bytes=hop["wire_bytes"],
                         ratio=hop["raw_bytes"] / max(hop["wire_bytes"], 1),
                         retry_steps=hop["retry_steps"], ms=hop["ms"],
                         routes=hop["routes"]),
                     global_hop=r.get("global"),
                     held=dict(params=r["held_params"],
                               cache=r["held_cache"]),
                     flash=dict(all=r["launches"]["flash_attention"],
                                causal=r["launches"]["flash_attention_causal"]),
                     peak_gb=r["peak_gb"])
    emit(phase="serve_tp_frontends", nvidia_smi=smi,
         families={fam: dict(arch=c["arch"], layers=c["layers"],
                             prompt=c["prompt"], max_seq=c["max_seq"])
                   for fam, c in SERVE_FRONTENDS.items()},
         batch=SERVE_TP_BATCH, steps=SERVE_TP_STEPS, transport="gloo",
         worlds={k: dict(mesh=list(v["mesh"]), variant=v["variant"],
                         second="xfer_global" if v["pd"] else None)
                 for k, v in SERVE_TP_WORLDS.items()
                 if k in SERVE_FAMILY_WORLDS},
         replay=replays, gates=gates,
         bound=dict(atol=SERVE_TP_ATOL, rtol=SERVE_TP_RTOL,
                    witness=SERVE_TP_WITNESS, token_margin=SERVE_FAM_MARGIN),
         seconds=dict(**seconds, phase=time.perf_counter() - t_phase))
    if failed:
        raise AssertionError("serve_tp_frontends: " + " | ".join(failed))
    return windows


def phase_mesh(torch, smi):
    ranks = run_ranks("mesh_rank", MESH_SHAPE[0] * MESH_SHAPE[1] * MESH_SHAPE[2])
    src, dst = ranks
    if src["prefill_launches"] != {"flash_attention": 30, "flash_attention_tc": 30}:
        raise AssertionError(f"mesh prefill: flash launches {src['prefill_launches']}")
    for label in ("n1", "n8", "escape"):
        need_launches(f"mesh_{label} (source)", src["runs"][label]["launches"],
                      ("encode_fused",))
        need_launches(f"mesh_{label} (destination)", dst["runs"][label]["launches"],
                      ("decode_fused",) if label != "escape" else ())
    need_launches("mesh_escape (source)", src["runs"]["escape"]["launches"],
                  ("encode_dense",))
    need_launches("mesh_escape (destination)", dst["runs"]["escape"]["launches"],
                  ("decode_dense",))
    for r in ranks:
        if r["runs"]["escape"]["retry_steps"] != 3 or not r["runs"]["escape"]["all_ok"]:
            raise AssertionError(f"mesh escape: {r['runs']['escape']['retry_steps']}"
                                 " retry steps, want 3 (cap, 2cap, 4cap, global)")
        for label in ("n1", "n8", "raw"):
            if r["runs"][label]["wire_bytes"] != src["runs"][label]["wire_bytes"]:
                raise AssertionError(f"mesh {label}: the two ends count "
                                     "different bytes")
    emit(phase="mesh", nvidia_smi=smi, mesh=list(MESH_SHAPE), arch=ARCH,
         batch=BATCH, prompt=PROMPT, new_tokens=NEW_TOKENS, transport="gloo",
         ranks=ranks, delivered_bitwise=True, tokens_equal=dst["tokens_equal"])
    windows = {}
    for label in ("n1", "n8", "escape"):
        for side, r in (("src", src), ("dst", dst)):
            windows[f"mesh_{label}_{side}"] = r["runs"][label]["launches"]
    return windows


def phase_ring(torch, smi):
    ranks = run_ranks("ring_rank", RING_RANKS)
    for r in ranks:
        for label in ("int_comp", "normal_comp"):
            need_launches(f"ring {label} rank {r['rank']}", r[label]["launches"],
                          ("encode_fused", "decode_fused"))
            if r[label]["raw_refetches"] != 1:
                raise AssertionError(f"ring {label}: the wide leaf did not "
                                     "re-run raw")
    emit(phase="ring", nvidia_smi=smi, ranks_n=RING_RANKS, arch=ARCH,
         transport="gloo", ranks=ranks, int_bitwise_mean=True,
         normal_ring_order_bitwise=True)
    return {f"ring_{label}": ranks[0][label]["launches"]
            for label in ("int_comp", "normal_comp")}


# ---------------------------------------------------------------------------
# phase 8q: the multi-pod dry run on fake ranks
# ---------------------------------------------------------------------------

#: (arch, shape, multi_pod, variant) of phase dryrun (a), each at full size
DRYRUN_CELLS = (("qwen3-32b", "decode_32k", False, "base"),
                ("qwen3-32b", "decode_32k", False, "fsdp"),
                ("qwen3-32b", "prefill_32k", True, "xfer_chunked"),
                ("smollm-135m", "train_4k", False, "fsdp"))
DRYRUN_TIMEOUT_S = 300


def dryrun_child(what: str, *args) -> dict:
    """One subprocess's work in phase ``dryrun`` (the fake group must be
    its process's only group): ``cell`` runs one cell of
    :data:`DRYRUN_CELLS` (``run_cell``, uncached), ``predict`` phase
    ``serve_tp``'s worlds rank by rank (``dryrun.predict``, one decode
    step)."""
    import dataclasses

    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    if what == "cell":
        arch, shape, multi, variant = DRYRUN_CELLS[int(args[0])]
        r = D.run_cell(arch, shape, multi, variant, cache=False)
        r.pop("roofline_scanraw", None)
        return dict(r, seconds=time.perf_counter() - t0)
    cfg = serve_tp_config()
    out = {}
    for world, w in SERVE_TP_WORLDS.items():
        ranks = D.predict(cfg, w["mesh"], _dryrun_variant(w),
                          batch=SERVE_TP_BATCH, prompt=SERVE_TP_PROMPT,
                          max_seq=SERVE_TP_MAX_SEQ, num_steps=1)
        out[world] = [{k: v for k, v in dataclasses.asdict(r).items()
                       if k in ("rank", "coord", "peak_bytes", "seen",
                                "kernels", "seconds")} for r in ranks]
    return dict(worlds=out, seconds=time.perf_counter() - t0)


def _dryrun_variant(w) -> str:
    """The dry-run variant a world of ``SERVE_TP_WORLDS`` serves under."""
    return w["variant"] or ("fsdp" if w.get("fsdp") else "base")


def _dryrun_spawn(what: str, *args):
    code = ("import json, sys; sys.path[:0] = [%r, %r]; import chip_smoke; "
            "print('DRYRUN ' + json.dumps(chip_smoke.dryrun_child(*sys.argv[1:])))"
            % (str(SRC), str(ROOT)))
    return subprocess.Popen([sys.executable, "-c", code, what, *map(str, args)],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dryrun_result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dryrun: a child still ran after "
                             f"{DRYRUN_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
    if proc.returncode or not lines:
        raise AssertionError(f"dryrun: a child failed ({proc.returncode}): "
                             f"{err[-3000:]}")
    return json.loads(lines[-1][len("DRYRUN "):])


def _predicted_vs_counted(world: str, counted_ranks, predicted) -> list:
    """Phase ``serve_tp``'s gloo ranks against the dry run's prediction at
    their coordinates (one decode step predicted, the world's counted):
    held bytes, ``tp.fwd``, a decode step's collectives over ``model``,
    the FSDP gathers' bytes and all-gathers, the hop's; raises on any
    difference; a row a rank."""
    steps = SERVE_TP_WORLDS[world].get("steps", SERVE_TP_STEPS)
    pred = {p["rank"]: p for p in predicted}
    rows = []
    for r in counted_ranks:
        p = pred[r["rank"]]
        seen = p["seen"]
        tag = f"dryrun ({world}) rank {r['rank']}"
        if p["coord"] != r["coord"]:
            raise AssertionError(f"{tag}: coordinate {p['coord']}, counted "
                                 f"{r['coord']}")
        want = {"held_params": seen["held"]["params"],
                "held_cache": seen["held"]["cache"]}
        decode = r.get("pod", 1) == 1
        if "prefill_fwd" in seen:        # prefill, then the decode steps
            pre = seen["prefill_fwd"]
            want["tp_fwd_sent"] = pre["bytes"] + steps * (
                seen["tp_fwd"]["bytes"] - pre["bytes"])
            want["tp_fwd_recv"] = pre["recv_bytes"] + steps * (
                seen["tp_fwd"]["recv_bytes"] - pre["recv_bytes"])
            pg, g = seen["prefill_gather"], seen["gather"]
            want.update({f"gather_{k}": pg[k] + steps * (g[k] - pg[k])
                         for k in ("bytes", "recv_bytes", "calls")})
            got_gather = r["gather"]
            want["prefill_gather"] = [pg["bytes"], pg["calls"]]
        else:                            # pod 0 prefills, pod 1 decodes
            n = steps if decode else 1
            want["tp_fwd_sent"] = n * seen["tp_fwd"]["bytes"]
            want["tp_fwd_recv"] = n * seen["tp_fwd"]["recv_bytes"]
        got = {"held_params": r["held_params"], "held_cache": r["held_cache"],
               "tp_fwd_sent": r["tp_fwd"]["sent_bytes"],
               "tp_fwd_recv": r["tp_fwd"]["recv_bytes"]}
        if "prefill_fwd" in seen:
            got.update(gather_bytes=got_gather["sent_bytes"],
                       gather_recv_bytes=got_gather["recv_bytes"],
                       gather_calls=got_gather["calls"],
                       prefill_gather=[r["prefill_gather"]["sent_bytes"],
                                       r["prefill_gather"]["calls"]])
        if decode:
            want["decode_collectives"] = seen["model_calls"]
            got["decode_collectives"] = r["decode_collectives"]
        if "hop" in seen:
            want["hop_raw_bytes"] = seen["held"]["cache"]
            got["hop_raw_bytes"] = r["hop"]["raw_bytes"]
            want["side_bytes"] = seen["hop"]["side_bytes"]
            got["side_bytes"] = r["side_bytes"]
        if got != want:
            raise AssertionError(f"{tag}: counted {got}, predicted {want}")
        row = dict(rank=r["rank"], coord=r["coord"], **got,
                   predicted_peak_gb=p["peak_bytes"] / 1e9,
                   max_memory_allocated_gb=r["peak_gb"],
                   after_draw_gb=r["serve_peak_gb"])
        if "hop" in seen:
            cap = seen["hop"]["comp_bytes"] + seen["hop"]["raw_bytes"]
            fell = sum(d["fallback"] for d in r["hop"]["routes"].values())
            row.update(wire_bytes=r["hop"]["wire_bytes"],
                       capacity_bytes=cap, fallback_units=fell)
            if not fell and r["hop"]["wire_bytes"] > cap:
                raise AssertionError(f"{tag}: the hop shipped "
                                     f"{r['hop']['wire_bytes']} bytes, over "
                                     f"the capacity-sized {cap}")
        rows.append(row)
    return rows


def phase_dryrun(torch, smi):
    """Phase ``dryrun`` (8q): (a) the full-size cells and (b) phase
    ``serve_tp``'s worlds predicted, each in a subprocess of its own, all
    at once; (b) held against ``SERVE_TP_COUNTS``; (c) the peaks side by
    side."""
    t0 = time.perf_counter()
    procs = [_dryrun_spawn("cell", i) for i in range(len(DRYRUN_CELLS))]
    procs.append(_dryrun_spawn("predict"))
    try:
        results = [_dryrun_result(p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    cells, pred = results[:-1], results[-1]
    summary = []
    for c in cells:
        if c["status"] != "ok":
            raise AssertionError(f"dryrun: cell {c['cell']} "
                                 f"{c['status']}: {c.get('error')}")
        rl = c["roofline"]
        summary.append(dict(
            cell=c["cell"], device=c["device"], seconds=c["seconds"],
            peak_gb_a_rank=c["memory"]["peak_bytes"] / 1e9,
            fits=c["fits"], fits_of=c["roofline_device"],
            flops_global=rl["flops_global"], bytes_global=rl["bytes_global"],
            collective_bytes_a_rank=rl["collective_bytes_per_chip"],
            collectives=rl["collectives_detail"], t_compute=rl["t_compute"],
            t_memory=rl["t_memory"], t_collective=rl["t_collective"],
            bottleneck=rl["bottleneck"],
            useful_flops_ratio=rl["useful_flops_ratio"],
            kernels={k: v for r in c["ranks_played"]
                     for k, v in r["kernels"].items()}))
    if not SERVE_TP_COUNTS:
        raise AssertionError("dryrun: phase serve_tp's counts are missing")
    rows = {world: _predicted_vs_counted(world, SERVE_TP_COUNTS[world],
                                         pred["worlds"][world])
            for world in SERVE_TP_WORLDS}
    emit(phase="dryrun", nvidia_smi=smi, roofline_device="NVIDIA H100 80GB "
         "HBM3 (SXM5), 700 W datasheet constants (predictions, not "
         "measurements)", cells=summary, serve_tp=dict(
             arch=SERVE_TP_ARCH, layers=SERVE_TP_LAYERS,
             predicted_vs_counted=rows, predict_seconds=pred["seconds"]),
         seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the kernel build log (default: none)")
    ap.add_argument("--lr-witness", action="store_true",
                    help="run only the hybrid train world's round-off "
                         "witness (lr_witness) and exit")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to prove", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    if args.lr_witness:
        print(smi, flush=True)
        return lr_witness(torch, smi)
    t_start = t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    hgmma = sass_count(build.library_path("flash_attention"), "HGMMA")
    if hgmma == 0:
        raise AssertionError("the flash library's SASS has no HGMMA: the "
                             "tensor-core kernel was not built for sm_90a")
    hmma = sass_count(build.library_path("splitzip_attention"), "HMMA")
    if hmma == 0:
        raise AssertionError("the paged-attention library's SASS has no HMMA: "
                             "the MLA kernel's products are not on the tensor "
                             "cores")
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(build_s, 3), built=sorted(logs),
         flash_sass_hgmma=hgmma if hgmma is not None else "not available",
         attention_sass_hmma=hmma if hmma is not None else "not available",
         ptxas=[ln.strip() for v in logs.values() for ln in v.splitlines()
                if "registers" in ln or "bytes smem" in ln or "spill" in ln])

    cfg = get_config(ARCH)
    records = timed("kernels", phase_kernels, torch, cfg, device)
    records.update(timed("attention", phase_attention, torch, device))
    timed("flash", phase_flash, torch, device)

    # each main-path run is counted alone (``counted``): the served
    # transfer (phase 3, cuda n_chunks 1), the capacity walk (phase 4), and
    # the served resident decodes of each family (phases 6, 7 and 9); the
    # served prefills of phases 3, 7 and 9 count the flash-attention kernel
    cb, first, params, prompt, main_runs, main_results = timed(
        "main", phase_main, torch, cfg, device)
    windows = {"main": main_runs["cuda_n1"], "main_n8": main_runs["cuda_n8"],
               "capacity": timed("capacity", phase_capacity, torch, cfg, cb,
                                 first, device)}
    served = dict(raw_bytes=main_results["cuda_n1"]["raw_bytes"],
                  wire_bytes=main_results["cuda_n1"]["wire_bytes"],
                  leaf_rows=first.prefill.state.cache["k"].numel() // 1024)
    windows["profile"], cal = timed("profile", phase_profile, torch, records,
                                   served, smi, device)
    windows.update(timed("verified", phase_verified, torch, cfg, params, cb,
                         prompt, first, main_runs, device))
    windows.update(timed("wire", phase_wire, torch, cfg, cb, first, smi,
                         device))
    windows.update(timed("fp8", phase_fp8, torch, cb, first, device))
    del first
    windows.update(timed("fleet", phase_fleet, torch, cfg, params, cb, cal,
                         main_results["cuda_n1"]["seconds"], smi, device))
    flash = {}
    windows["resident"], flash[ARCH] = timed(
        "resident", phase_resident, torch, cfg, params, cb, prompt, device)
    windows["mla"], flash[MLA_ARCH] = timed("mla", phase_mla, torch, device)
    windows["demotion"] = timed("demotion", phase_demotion, torch, cfg,
                                params, prompt, device)
    del params, cb, prompt
    torch.cuda.empty_cache()
    windows["minitron"] = timed("minitron", phase_minitron, torch, device)
    windows["ssm"] = timed("ssm", phase_ssm, torch, device)
    windows["hybrid"], flash[HYBRID_ARCH] = timed("hybrid", phase_hybrid,
                                                  torch, device)
    windows["vlm"], windows["vlm_resident"], flash[VLM_ARCH], vlm_cache, vlm_cb = \
        timed("vlm", phase_vlm, torch, device)
    windows["persist_save"], windows["persist_load"] = timed(
        "persist", phase_persist, torch, vlm_cache, vlm_cb, device)
    del vlm_cache
    torch.cuda.empty_cache()
    windows["audio"], flash[AUDIO_ARCH] = timed("audio", phase_audio, torch,
                                                device)
    torch.cuda.empty_cache()
    windows.update(timed("mesh", phase_mesh, torch, smi))
    windows.update(timed("ring", phase_ring, torch, smi))
    train_windows, grad_book = timed("train", phase_train, torch, smi)
    windows.update(train_windows)
    windows.update(timed("shard", phase_shard, torch, smi, grad_book))
    windows.update(timed("tp", phase_tp, torch, smi))
    windows.update(timed("ep", phase_ep, torch, smi))
    windows.update(timed("tp_recurrent", phase_tp_recurrent, torch, smi))
    windows.update(timed("serve_tp", phase_serve_tp, torch, smi))
    windows.update(timed("serve_tp_families", phase_serve_tp_families, torch,
                         smi))
    windows.update(timed("serve_tp_recurrent", phase_serve_tp_recurrent, torch,
                         smi))
    windows.update(timed("serve_tp_frontends", phase_serve_tp_frontends, torch,
                         smi))
    timed("dryrun", phase_dryrun, torch, smi)
    windows["moe"], flash[MOE_ARCH] = timed("moe", phase_moe, torch, device)
    emit(phase="launches", **windows)
    emit(phase="flash_live", geometries=flash)
    owner = {"encode_fused": "main", "decode_fused": "main",
             "encode_dense": "capacity", "decode_dense": "capacity",
             "paged_gqa_attention": "resident", "paged_mla_attention": "mla"}
    for k, rec in records.items():
        rec["launches"] = windows[owner[k]][k]
    transfer_paths = ("main", "main_n8", "capacity", "profile", "verified_n1",
                      "verified_n8", "wire", "wire-verify", "wire_escapes",
                      "fp8_e5m2", "fp8_e4m3", "fleet_delta",
                      "fleet_resend", "minitron", "ssm", "hybrid", "vlm",
                      "persist_save", "persist_load", "mesh_n1_src",
                      "mesh_n1_dst", "mesh_n8_src", "mesh_n8_dst",
                      "mesh_escape_src", "mesh_escape_dst", "ring_int_comp",
                      "ring_normal_comp", "train_save", "train_restore",
                      "train_ring", "train_ring_default", "shard_ring",
                      "shard_hop_src", "shard_hop_dst", "serve_tp_xfer_src0",
                      "serve_tp_xfer_src1", "serve_tp_xfer_dst0",
                      "serve_tp_xfer_dst1", "serve_tp_global_src0",
                      "serve_tp_global_src1", "serve_tp_global_dst0",
                      "serve_tp_global_dst1") + tuple(
        f"serve_fam_{fam}_{hop}_{side}{m}" for fam in SERVE_FAMILIES
        for hop in ("xfer", "global") for side in ("src", "dst")
        for m in (0, 1)) + tuple(
        f"serve_rec_{fam}_{hop}_{side}{m}" for fam in SERVE_RECURRENT
        for hop in ("xfer", "fp32") for side in ("src", "dst")
        for m in (0, 1)) + tuple(
        f"serve_fe_{fam}_{hop}_{side}{m}" for fam in SERVE_FRONTENDS
        for hop in ("xfer", "global") for side in ("src", "dst")
        for m in (0, 1))
    for k in ("encode_fused", "decode_fused", "encode_dense", "decode_dense"):
        records[k]["launches_by_path"] = {w: windows[w][k] for w in transfer_paths}
    records["paged_gqa_attention"]["launches_by_arch"] = {
        ARCH: windows["resident"]["paged_gqa_attention"],
        MOE_ARCH: windows["moe"]["paged_gqa_attention"],
        VLM_ARCH: windows["vlm_resident"]["paged_gqa_attention"]}
    # the flash-attention kernel: one launch per layer of each served prefill
    served_prefills = {ARCH: ("main", 30), MLA_ARCH: ("mla", 62),
                       MOE_ARCH: ("moe", 48), MINITRON_ARCH: ("minitron", 32),
                       HYBRID_ARCH: ("hybrid", 12), VLM_ARCH: ("vlm", 40),
                       AUDIO_ARCH: ("audio", 48),
                       SERVE_TP_ARCH: ("serve_tp_base_prefill0",
                                       SERVE_TP_LAYERS)}
    served_prefills.update({
        f"{arch} (serve_tp_families)": (f"serve_fam_{fam}_base_prefill0", layers)
        for fam, (arch, layers) in SERVE_FAMILIES.items()})
    served_prefills[f"{HYBRID_ARCH} (serve_tp_recurrent)"] = (
        "serve_rec_hybrid_base_prefill0",
        SERVE_RECURRENT["hybrid"]["layers"] // 3)
    served_prefills.update({
        f"{c['arch']} (serve_tp_frontends)": (f"serve_fe_{fam}_base_prefill0",
                                              c["layers"])
        for fam, c in SERVE_FRONTENDS.items()})
    by_arch = {a: windows[w]["flash_attention"] for a, (w, _) in served_prefills.items()}
    if by_arch != {a: n for a, (_, n) in served_prefills.items()}:
        raise AssertionError(f"flash_attention launches per served prefill "
                             f"{by_arch}, want one per attention layer")
    tc_by_arch = {a: windows[w]["flash_attention_tc"]
                  for a, (w, _) in served_prefills.items()}
    if tc_by_arch != by_arch:
        raise AssertionError(f"flash_attention tensor-core launches per served "
                             f"prefill {tc_by_arch} of {by_arch}: a served "
                             "prefill took the CUDA-core kernel")
    moe_rec = flash[MOE_ARCH]
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda", source=FLASH_KERNEL[0],
        replaces=FLASH_KERNEL[1], launches=sum(by_arch.values()),
        launches_by_arch=by_arch, launches_tensor_core=sum(tc_by_arch.values()),
        max_abs_err=moe_rec["max_abs_err"],
        tolerance="atol 1e-3, rtol 8e-3 (one bf16 ulp)",
        ms=moe_rec["ms"], kernel_ms=moe_rec["ms"], eager_ms=moe_rec["eager_ms"],
        plain_ms=moe_rec["plain_ms"],
        bound_ms=moe_rec["bound_ms"], bound_by=moe_rec["bound_by"],
        library_ms=moe_rec["library_ms"], library=moe_rec["library"],
        bytes=moe_rec["bytes"], ops=moe_rec["ops"], geometry=moe_rec["geometry"],
        geometries={a: {k: r[k] for k in ("geometry", "ms", "eager_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms",
                                          "max_abs_err")}
                    for a, r in flash.items()})
    missing = [k for k, rec in records.items() if not rec["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if windows["resident"]["paged_gqa_attention"] < 30 * RES_TOKENS:
        raise AssertionError("paged_gqa_attention: fewer than one launch per "
                             "layer and step on the resident path")
    if windows["mla"]["paged_mla_attention"] < 62 * RES_TOKENS:
        raise AssertionError("paged_mla_attention: fewer than one launch per "
                             "layer and step on the MLA resident path")
    if windows["moe"]["paged_gqa_attention"] < 48 * RES_TOKENS:
        raise AssertionError("paged_gqa_attention: fewer than one launch per "
                             "layer and step on the MoE resident path")
    if windows["vlm_resident"]["paged_gqa_attention"] < 40 * NEW_TOKENS:
        raise AssertionError("paged_gqa_attention: fewer than one launch per "
                             "layer and step on the vlm resident path")
    for w in ("persist_save", "persist_load"):
        if not windows[w]["encode_fused" if w == "persist_save" else "decode_fused"]:
            raise AssertionError(f"{w}: the codec kernel never launched")
    emit(phase="timing", seconds=dict(build=build_s, **PHASE_SECONDS,
                                      total=time.perf_counter() - t_start))
    emit(kernels=list(records.values()), seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
