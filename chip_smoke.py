#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # the full run, on one CUDA card

Phases, each printing one JSON line (or one per call):

1. env      — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, TF32 switched off, the kernels built from
              ``src/repro_torch/kernels/csrc`` with nvcc, one process per
              source, all started together (build seconds).
2. kernels  — every CUDA kernel held against its plain torch version on the
              card: modes {sqeuclidean, euclidean, dot, cosine}.  The sweeps
              (B1, B2) at small ragged shapes and the main shape, b in
              {1, 8, 9, 33}, p in {1, 32, 128, 256}, and at the edges of
              the sweep's plan (``gmm_topb.edge_cases``: n in {1, 15, 17, a
              tile and one row, 8,196}, d in {1, 3, 5,000, 5,001}, b in
              {1, 8, 9, 32, 33}, p in {1, 32, 128, 4,096}; rows N(0, 1/d)),
              equal rows on both sides of every slab border, a fully masked
              tile, every row masked, and a base 4 bytes off 16; each B1/B2
              top-p must also be the stable top-p of the kernel's own
              min_out, value and index; the distance tile (B3) at
              small ragged shapes and the four streaming tile shapes below,
              where a one-column call must equal its tile's column and a
              tail of the rows the tile's rows, bit for bit; the grouped
              sweep (B4) at ragged n, m in {2, 16, 64} groups of 8 centers
              and m = 4 groups of 1, 3 and 9, one empty group, rows
              labelled -1, p in {1, 8, 128, 256}, and at the main shape.
              Values must match to 3e-5; every B4 index must lie in
              [0, n).  B3 and B4 share one arithmetic with their plain
              versions (float64 sums rounded once), so each case also
              counts the entries where kernel and plain differ (expected
              0; a nonzero count is printed, not failed: such an entry is
              a float64 sum within float64 rounding of an fp32 rounding
              boundary, one ulp off).
3. main     — ``repro_torch.diversify`` at the paper's musiXmatch shape
              (237,662 songs x 5,000 words, cosine), its words drawn by the
              host's generator from ``--seed`` (the same rows on every
              machine; its fingerprint printed) and scattered into the
              dense array on the card: (a) cosine with default knobs, (b)
              euclidean defaults, (c) ``kprime=64, b=1`` cosine (the
              gmm_update_select path), each with ``use_pallas="auto"`` (the kernels) and
              ``use_pallas=False`` (plain torch); radius, ratio and value
              agree to rtol 1e-4, meets_target and the executed schedule are
              equal, and the kernel launch counters moved on the kernel runs
              only (they are zeroed just before each call); each call runs
              ten times per side in turns kernel, plain, plain, kernel, ...
              (median and spread of the seconds) and must repeat exactly.
4. stream   — ``repro_torch.diversify`` on streaming problems, data made
              from ``--seed``: (a) the musiXmatch shape, cosine,
              remote-edge, k = 128, default knobs (k' = 256, chunk 4,096);
              (b) the same with k' = 1,024; (c) remote-clique (SMM-EXT),
              k = 32, k' = 128; (d) 2^24 points on the unit sphere in 3-D
              (the paper's synthetic streaming set), euclidean, SMM-GEN,
              k = 64, k' = 512, chunk 65,536, fed as a chunk iterator.  Each
              call runs three times per side, kernel and plain in turns; it
              prints seconds, points/s, chunks, far inserts, merges and host
              reads per chunk, and kernel and plain must agree on the
              core-set, d_i, the phase log, the certificate and the picks,
              and on the value to rtol 1e-4.
5. constrained — ``repro_torch.diversify`` on constrained problems at the
              musiXmatch shape, with synthetic "genre" labels over 16 groups
              with Zipf(1) shares drawn by the host from ``--seed`` (the
              follow-up paper's genre partition; its label file is not in
              the repo): (e) remote-edge, k = 32, labels alone (2 per
              group), default knobs, cosine and euclidean; (f) the same
              with ``kprime=64, b=1``; (g) remote-clique, quotas 2 per
              group, ``kprime=8`` (the delegates pass through B3); three
              calls per side in turns, kernel and plain agreeing on the
              picks and labels, the quotas, the value (rtol 1e-4), the
              per-group radius and certificate, the schedule and every
              counter.  (h) the constrained stream, remote-edge, k = 32,
              quotas 2 per group, k' = 256, chunk 4,096, over the whole
              stream, three calls per side in turns, with the same
              agreement.
6. mapreduce — ``repro_torch.diversify`` with ``mode="mapreduce"``, the
              simulated reducers: (i) the musiXmatch shape, cosine,
              remote-edge, k = 128, 16 reducers, default knobs (the probe
              through B1, then round 1 as 16-group B4 sweeps); (j)
              remote-clique (EXT), k = 32, k' = 64, 16 reducers, random
              partition (delegates through B3); (k) remote-clique,
              generalized, k = 16, k' = 64, 8 reducers (multiplicities,
              instantiation through B3 columns); (l) remote-edge, k = 32,
              the genre labels alone, 4 reducers (one 64-group B4 run);
              (m) the 2^24-point sphere, euclidean, k = 64, k' = 512, 16
              reducers, adversarial partition.  Kernel and plain runs in
              turns; each call prints its seconds, the probe, round-1 and
              solve seconds, the frozen schedule, the core-set size, the
              counters and launches, and an ``agree`` dict (picks, labels,
              value, radius and certificate to rtol 1e-4, counters); round 1
              must make one B4 launch a fold, as the run's own
              ``mr.round1`` span records them.
7. times    — median kernel and plain times by CUDA events: the sweeps at
              the main shape beside their bytes bound, the grouped sweep
              there (16 groups of 8 centers, p in {1, 128}; 16 groups of one
              center, p = 1; 64 groups at p = 128), the distance tile at the
              streaming shapes beside its
              bound and, for euclidean, ``torch.cdist``'s time (the library
              call; the port never calls it on this path), and B4 at the
              MapReduce round-1 shapes, at the serving shape (phase 9's
              256 requests x 1,024 rows x 768 as 256 groups, bc = 1, p = 1)
              and at every sweep shape of phase 12's runs (a rank's shard
              at m = 1 and with the 16 genres, (x)'s whole input at m = 1,
              each (bc, p) their schedules give) and phase 13's (the
              selection pool over 16 reducers, the reranker's fused solve
              of 8 sessions) and phase 14's (the curation's round 1 over
              16 reducers), with its merge time and
              tile filler, each shape first held against its plain version
              entry for entry (its differing entries, expected 0, join
              phase 2's); and B1/B2 at every (b, p) the probe of (i) and of
              (m) swept in their first kernel run (8,196 x 5,000 cosine,
              8,192 x 3), at phase 14's probe (8,192 x 2,048 euclidean, b in
              {1, 8}, p in {1, 32}) and B2 at phase 13's ``select_diverse``
              pool (65,536 x 2,048), each first held against plain: the
              kernel's device ms a launch (profiler), the wrapper's and the
              plain version's ms, the bound and the blocks of the grid.
8. profile  — device-only torch.profiler traces of batch call (a), stream
              call (b), constrained call (e) cosine, MapReduce call (i),
              serving call (s), one churn round of dynamic call (u),
              one group of phase 13's (q) (prefill, decode, rerank) and
              one AdamW step of phase 14's (z) at full width:
              device time by kernel, the device's busy share of that
              call's wall time and its idle gaps (full tables in the
              script's output directory).
9. serving  — data made on the card from ``--seed``: (s) the facade on
              an (R, n, d) = (256, 1,024, 768) tensor of candidate
              embeddings (each request its query plus one of 8 topics plus
              noise), cosine, remote-edge, k = 32: the fused multi-tenant
              rerank, every fold of all 256 requests one B4 launch; (s')
              ``serving.rerank_batched`` on a ragged list of 256 requests of
              512-1,024 candidates, euclidean; (t) the session reranker,
              ``OnlineReranker(k=16, kprime=64, metric="cosine")`` over 64
              sessions x 8 rounds of ``rerank_many``, 256 candidates x 768
              a request, each session drawing from its own shifted Gaussian
              (``benchmarks/bench_serving.py``), then again under a byte
              budget of half the sessions' ``session_nbytes``, and 4
              sessions checkpointed midway, restored into a new reranker
              and finished there (their slates and certificates must equal
              the uninterrupted reranker's).  Three calls a side in turns;
              kernel and plain agree on every index, on radii and values to
              rtol 1e-4 and on every counter; B4 launches equal the folds
              the runs' spans record.
10. resilience — each variant once, on the kernel side, held to the
              kernel run phase 6 or 4 already made: MapReduce call (i)
              with ``trace="reducers"`` and with a retried reducer 3
              (picks, core-set, certificate equal to phase 6's, 16
              ``mr.reducer[i]`` spans), with reducer 3 lost under
              ``on_failure="degrade"`` (degraded certificate, surviving
              shards, coverage), and stream (b) checkpointed every 8
              chunks, killed at chunk 30 and resumed (core-set rows, d_i,
              phase log, certificate and picks equal to phase 4's).
11. dynamic — ``repro_torch.dynamic.DynamicIndex`` under churn, data made
              on the card from ``--seed``, each call's kernel side (B3
              tiles for every maintenance distance, B1 at p = 1 for the
              query) and plain side (``use_pallas=False``) in turn: (u)
              the churn schedule of ``benchmarks/bench_dynamic.py:33-50``
              at catalog scale, a Gaussian x 10 at d = 8, euclidean, k = 8,
              k' = 64, 2^20 live points, 10 rounds of 52,428 deletes,
              52,428 inserts and one query; (u') the same at churn 0.25 for
              6 rounds (a rebuild fires); (v) a sliding window over the
              musiXmatch stand-in, cosine, k = 32: 65,536 songs, then 8
              rounds of 4,096 inserted, the oldest 4,096 deleted, a query.
              Each prints seconds per round and updates/s, boot, rebuild
              and query seconds, live centers per level and the frozen
              depth, rebuilds, B3 and B1 launches, host syncs per round
              and an ``agree`` dict: the two sides' level arrays, liveness,
              covers and frozen flags equal entry for entry, the same query
              levels, the same query ids but where the two sides part at a
              tie (the two picks' fields over the earlier picks within 3e-5
              of each other in float64; printed with the gap), certificate
              floats within rtol 1e-5.  (w)
              the facade over (u)'s 21 ops, checkpointed every 4, killed at
              op 7 and resumed from op 4: equal to the uninterrupted
              facade run on every field.

12. mesh    — the MapReduce mesh path over ``torch.distributed``, each
              call through the facade with a ``DTensor`` input placed
              ``Shard(0)``: (x) call (i)'s problem (k = 128, default knobs)
              with ``mesh=`` a one-rank NCCL mesh, so every collective is a
              real NCCL call on card tensors, equal on every field to the
              simulated run at ``num_reducers=1``; (y) four gloo ranks
              sharing the card, spawned here (``file://`` store, a timeout
              on the process group and on every join), each making the
              stand-in from ``--seed`` and keeping only its shard of the
              first 237,660 rows (59,415 x 5,000 fp32): (i') remote-edge,
              k = 128, default knobs; (j') remote-clique (EXT), k = 32,
              k' = 64; (k') remote-clique, ``three_round=True``, k = 16,
              k' = 64; (n) recursive on a (2, 2) ('pod', 'data') mesh,
              remote-edge, k = 32, k' = 64; (l') the genre labels alone,
              k = 32.  Three runs a call, each after a barrier; every rank's
              union, radius, certificate, picks, value and counters must
              equal this process's simulated run at ``num_reducers=4``
              (contiguous; for (n) the union built from the per-reducer
              units and one masked exact GMM a pod) and its B4 launches its
              folds.  Each call prints the slowest rank's seconds, probe,
              round-1, all-gather and solve seconds, the gathered bytes and
              each rank's launches by kernel.  Then B3 at a rank's EXT/GEN
              delegate tiles (4,096 and 2,071 rows x k') and round-3 column
              (59,415 x 1), and B2 at every sweep of (n)'s level-2 GMM over
              each pod's 128-row union (``check_level2``) and there with
              centers off the data (``check_pair``), against their plain
              versions (B4 at the mesh's shapes is held in phase 7).

13. serve   — the model-backed serving path at internlm2-1.8b's full
              width (24 layers, d_model 2,048, bf16, 1.889 B parameters),
              random weights drawn on the card from ``--seed``: (o)
              ``ServingEngine(batch=8, capacity=128)`` answers 16 requests
              (64 prompt tokens, 16 new) twice, traced and not, with the
              same tokens: init seconds, per-group prefill seconds, decode
              ms a step beside the weight-bytes bound and the prefill's
              operations bound, generated tokens/s; (o') prefill 63 tokens
              and decode the 64th against the full forward, in fp32 (the
              same weights upcast) at the reference's bound rtol = atol =
              2e-2, in bf16 at that bound on the model cut to its first
              layer, and in bf16 at full depth within a fixed atol of 0.4
              (the bf16 error and the model's own bf16 floor, a row's
              logits alone against in the batch, printed at 1, 2, 4, 8,
              16 and 24 layers); (q) ``generate_diverse`` over the same
              requests, one session a request, each carrying 1,024
              candidates embedded through the model's table
              (16-token Zipf(1) windows, d = 2,048) for
              ``OnlineReranker(k=16, kprime=64, metric="cosine")``, with the
              kernels and with ``use_pallas=False``: equal tokens, slates
              and reuse, B3/B4 launched on the kernel run only; then
              ``diverse_rerank`` (k = 8, B2) over the 32 outputs, equal
              picks; (p) 65,536 examples x 128 Zipf(1) tokens embedded
              through the table (a 537 MB fp32 pool) and ``select_diverse``
              (k = 64) batch b = 1 (B2) and over 16 reducers (round 1 on
              B4), three calls a side in turns, equal indices; B2 (and B1)
              at the pool and B3 at the reranker's tile held against
              plain; the serving launcher once at full width.

14. train   — dense-model training on diversity-curated data at
              internlm2-1.8b's full width (random weights from
              ``--seed``, TF32 off), as ``examples/train_diverse_data.py``
              does it: (r) 65,536 examples x 129 Zipf(1) tokens, the first
              128 embedded through the model's table (d = 2,048), curated
              by ``diversify(k=1024, measure="remote-edge",
              mode="mapreduce", num_reducers=16, kprime=128)`` with the
              kernels and with ``use_pallas=False`` (equal indices; the
              probe on B1, round 1 one B4 launch a fold), B1 (and B2) at
              the probe's subsample held against plain, B4 at every
              round-1 sweep shape handed to phase 7; (z) ``make_train_step``
              with AdamW, 6 steps at lr 3e-4 on one fixed batch of 8 x
              128 curated tokens (the loss must fall): step, gradient and
              update ms by CUDA events beside the step's operations bound
              and the update's bytes bound, tokens/s, peak memory beside
              the reckoned 30.2 GB of state; ``accum_steps=2`` against 1
              at the reference test's bounds; (z') the float64 autograd
              gradient against the float64 loss's central difference
              along a random unit direction and along one in each block
              (embedding, layer group, norm, head), the fp32 gradient
              along the same direction and against the float64 one block
              by block, planted faults read above their bounds; (z'')
              the reduced config under ``TrainingSupervisor``,
              checkpoints every 4 steps, killed at step 6 and resumed:
              losses and final state equal to an uninterrupted run bit
              for bit; (z''') the training launcher in its own process,
              4 steps.

15. moe     — the MoE family at granite-moe-1b-a400m's full width (24
              layers, d_model 1,024, 32 experts, top-8, expert F 512,
              1.335 B parameters of which 428.8 M active, bf16 with an
              fp32 router; random weights from ``--seed``, every token id
              drawn on the host, fingerprints printed), after phase 14
              has released its model and state: (o_moe) the engine, 16
              requests x (64 + 16) twice, prefill seconds beside the
              active params' operations bound, decode ms beside the whole
              weights' bytes bound (every expert's buffer is computed),
              tokens/s and each prefill's dropped assignments; (o'_moe)
              decode from the cache against the full forward at 2 x 16
              tokens (no call drops), fp32 and one-layer bf16 at 2e-2, full
              depth printed with its floor; (moe') layer 0's MoE on the
              card against the CPU from the same fp32 inputs at 8 x 128
              tokens, capacity factors 1.25 and 0.5: the dispatch equal
              entry for entry but at proven near-ties, the outputs at
              1e-4; (r_moe) phase 14's curation through granite's table
              (B1 probe held here, B4 round 1 to phase 7); (q_moe)
              ``generate_diverse`` into the session reranker, kernel vs
              plain (B3 tile held here, the fused solve to phase 7);
              (z_moe) 6 AdamW steps on 8 x 128 curated tokens beside
              ``train_bounds`` (the experts' share, and their padded rows)
              and the update's bytes bound, peak memory beside the
              reckoned state, accumulation 2 vs 1 at 2 x 16 tokens in
              float64, fp32 and bf16 with each one's routing partings;
              (z'_moe) the fp32 gradient against the float64 one block by
              block under the float64 routing, with its own logits'
              near-ties and a planted fault; arctic-480b reduced (the
              dense residual) against the CPU and from its cache; phase
              8's traces of one (q_moe) group and one (z_moe) step.

16. vlm     — the vlm family at phi-3-vision-4.2b's full width (32 layers,
              d_model 3,072, 32/32 heads of 96, SwiGLU 8,192, vocab
              32,064, 576 patches of 1,024 projected; 3.824 B parameters,
              bf16, random weights from ``--seed``; token ids and patch
              embeddings drawn on the host, fingerprints printed), after
              phase 15 has released its state: (o_vlm) the engine, 16
              requests x (64 + 16), batch 8, capacity 672 (zero patches
              before each prompt, as the reference's engine feeds), twice:
              prefill seconds beside its operations bound, decode ms beside
              the bf16 weights' bytes (the KV cache's bytes beside them),
              tokens/s; (o'_vlm) decode from the cache against
              ``forward_train`` with non-zero patches, fp32 and one-layer
              bf16 at 2e-2, full depth printed with its floor; (q_vlm)
              ``generate_diverse`` into the session reranker, kernel vs
              plain (B3 tile at d = 3,072 held here, the fused solve to
              phase 7); (z_vlm) 6 AdamW steps on the model cut to 8 layers
              (full width, 1.106 B parameters) over ``lm_batch``'s 8 x
              (576 patches + 128 tokens): the text loss falls,
              ``patch_proj``'s gradient non-zero and finite, step and
              update ms beside ``train_bounds``, peak memory; phase 8's
              trace of one (o_vlm) group.

17. ssm     — the ssm family at mamba2-130m's full width and depth (24
              layers, d_model 768, 24 SSM heads of 64, state 128, chunk
              256, vocab 50,432 tied; 129.1 M parameters, bf16): (o_ssm)
              the engine, 16 requests x (64 + 16), batch 8, twice (prefill
              steps the recurrence over the prompt, as the reference
              does; its and a decode step's dispatched ops printed), decode
              ms beside the weights' and the state's bytes; (ssd') the
              chunked scan against the step recurrence at 2 x 4,096 tokens
              of the model's SSD shape, float64 within 1e-10 and fp32
              within 1e-4 (relative Frobenius), the inter-chunk term
              dropped read above the fp32 bound, both paths' ms; (o'_ssm)
              decode from the state against the full (chunked) forward;
              (r_ssm) 16,384 windows of 1,025 Zipf(1) tokens through the
              table (d = 768), ``diversify(k=256, remote-edge, mapreduce,
              16 reducers, k'=128)``, kernel vs plain (B1 probe held here,
              B4 round 1 to phase 7); (q_ssm) as (q_vlm) at d = 768;
              (z_ssm) 6 AdamW steps on 8 x 1,024 curated tokens (4 chunks
              a row) beside ``train_bounds``, accumulation 2 vs 1 with its
              control, and the gradient witness (z'_ssm) at full depth;
              phase 8's trace of one (z_ssm) step.
18. hybrid  — the hybrid family at recurrentgemma-9b's full width and
              depth (38 layers: 2 leading RG-LRU layers and 12 groups of
              local MQA attention and two RG-LRU layers, d_model 4,096,
              window 2,048, vocab 256,000 tied; 9.40 B parameters, bf16):
              (o_rg) the engine, 16 requests x (64 + 16), batch 8, twice,
              then 2 x (2,040 + 16) so that decode wraps the 2,048-slot
              rolling buffer, prefill beside its operations and decode
              beside its bytes; (o'_rg) decode from the cache against the
              full forward at 2 x 2,056 tokens, fp32 and bf16 held at 2e-2
              on the model cut to 4 layers, full-depth bf16 printed beside
              its floor; (scan') ``rglru._lru_scan`` against a float64
              loop at (8, 4,096, 4,096), float64 within 1e-10 and fp32
              within 1e-5 (relative Frobenius), h0's term dropped read
              above the fp32 bound, both paths' ms; (r_rg) 16,384 windows
              of 1,025 Zipf(1) tokens through the table (d = 4,096),
              curated as (r_ssm); (q_rg) as (q_vlm) at d = 4,096 on one
              group of 8 requests; (z_rg) 6 AdamW steps on the model cut
              to 4 layers (1 leading layer and 1 group) over 8 x 512
              curated tokens beside
              ``train_bounds``, accumulation 2 vs 1 with its control, the
              gradient witness (z'_rg) on that cut over 2 rows; phase 8's
              traces of one (o_rg) group and one (z_rg) step.
19. encdec  — the encdec family at seamless-m4t-large-v2's full width and
              depth (24 + 24 layers, d_model 1,024, 16 heads of 64, vocab
              256,256 tied; 1.77 B parameters, bf16): (o_s2t) the engine
              with 256 zero frames a row (the reference engine's frames),
              16 requests x (64 + 16), batch 8, twice; (o'_s2t) decode
              from the cache against ``forward_train`` on host-drawn
              frames, fp32 at full depth and bf16 at one encoder and one
              decoder layer at 2e-2; (q_s2t) as (q_vlm) at d = 1,024 on
              one group of 8 requests; (z_s2t) 6 AdamW steps over
              ``lm_batch``'s 8 x (512 frames + 512 tokens), accumulation,
              and the gradient witness (z'_s2t)
              on the model cut to 4 + 4 layers over 2 rows of 128 frames
              and tokens (the encoder's blocks included); phase 8's trace
              of one (z_s2t) step.

20. sharded — the reference's sharded training step (``rules_for``'s
              placements over a ``DeviceMesh``, ``make_train_step`` on
              DTensor params and AdamW state, MoE expert parallelism) at
              granite-moe-1b-a400m's full width and depth on four gloo
              ranks sharing the card, a (2, 2) ('data', 'model') mesh, 8
              x 128 ``lm_batch`` tokens drawn on the host: (zw_sh) the
              sharded float64 gradient against the one-process gradient
              of the same function (the mean of the data shards' one-device
              gradients: a MoE layer's capacity counts the shard's own
              tokens) on the model cut to one layer, held leaf by leaf
              within 1e-10, the copy's backward without its all-reduce
              over 'model', a step without the gradient sum over 'data'
              and the vocab-parallel loss without its all-reduces of the
              max and the sums each read above 1e-3, and the same
              comparison at full depth in bf16 printed; the step computes
              tensor-parallel over 'model' (the vocab split: the
              embedding's lookup, the logits, the loss; the experts
              expert-parallel); (z_sh) 2 AdamW steps: each step's ms
              on the slowest rank (CUDA events and host clock), loss and
              grad norm (equal on every rank), the collective bytes a
              step counted in ``distributed.sharded``, each rank's shard
              bytes of the params and the state (equal to the whole
              divided as the specs divide it), each rank's peak beside
              the parent's reserved bytes (under 80 GB together); the
              phase within 120 s.
21. dryrun  — the dry run (``launch.dryrun``: a cell's sharded step traced
              on ``meta`` tensors over a fake process group) in a spawned
              process: (dr_sh) phase 20's cell, whose collective bytes of
              a step must equal every rank's per-step ``sharded.BYTES``
              of phase 20 in this run, and its shard bytes of the params
              and the state each rank's, to the byte (the trace's peak
              estimate printed beside the ranks' measured peaks); (dr_sv)
              phase 22's (d_sh), (cp_sh) and (d_tp) decode cells, whose
              bytes a step and cache shard bytes must equal every decode
              step's
              and every rank's of phase 22, to the byte, and their
              prefills (cells of the prompt's length), whose bytes must
              equal every rank's prefill's; (dr_pod)
              arctic-480b x train_4k on (2, 16, 16) at 512 ranks,
              recurrentgemma-9b x long_500k and gemma-2b x decode_32k on
              (16, 16), each traced (FLOPs, collective bytes), a JSON
              line each with its trace seconds; then
              (dr_paper) one rank of the paper cell at its real size, a
              4,194,304 x 64 fp32 shard drawn on the host: exact GMM(2,048)
              through B2 (2,048 sweeps) and b = 8 through B1 (257 sweeps),
              kernel and plain in turns, picks equal up to a proven
              near-tie (float64 distances to the earlier picks within
              1e-5) and the radius within 1e-4, seconds beside the bytes
              bound of the sweeps, launches equal to the sweeps, the
              peak memory; the phase within 90 s.

22. sharded_serve — the reference's sharded prefill and decode steps
              (``make_prefill_step``/``make_decode_step`` on DTensor
              params and caches; the cache moved from the prefill rules
              to the decode rules by ``launch.sharding.move``) on phase
              20's four gloo ranks and (2, 2) mesh: (w_sh) granite-moe
              cut to one layer in float64, split-KV (8 x 96 tokens into
              128 slots) and context-parallel (2 x 96 into 128) decode,
              4 steps, logits and caches against the one-process steps of
              the same function within 1e-10, the combine without its
              all-reduces and the decode write at every rank's local slot
              each read above 1e-3; at full width and depth in bf16,
              (p_sh) the prefill of 8 x 3,072 host-drawn tokens into
              4,096 slots under the prefill rules (fsdp over 'data') and
              (d_sh) 8 split-KV decode steps (kv_seq 'model', weights
              resident, the vocab split: 0 B all-gathered a step, held),
              (cp_sh) 2 x 12,288 into 16,384 slots and 4
              context-parallel steps (kv_seq 'data', the batch on every
              rank; 8 before the tensor-parallel slice); (s_sh)
              mamba2-130m at full width and depth, the state over
              'model', 8 x 1,024 then 8 steps, with a float64 witness at
              full depth (8 x 16, 2 steps); (d_tp) internlm2-1.8b at full
              width and depth under its published ``pad_heads`` (the
              prefill's 16 padded heads 8 a 'model' rank, a decode
              step's attention whole on each rank, the MLPs and the
              vocab tensor-parallel), 8 x 1,024 host-drawn tokens into
              2,048 slots, then 8 split-KV decode steps (fsdp None: 0 B
              all-gathered a step, held), its float64 witness (w_tp) on
              the model cut to one layer (8 x 96 into 128, 2 steps)
              within 1e-10, the MLP's row product without its
              all-reduce above 1e-3 and the padded heads'
              out-projection without its sum over 'model' above 0.1;
              (w_pad) gemma-2b at full width (8 query heads, one KV
              head, padded to 16: rank 1 of each 'model' pair attends
              padding alone; vocab 256,000) cut to one layer in float64:
              the prefill of 2 x 128 tokens and the loss and gradient of
              ``sharded_value_and_grad`` on them against the one-process
              steps within 1e-10, the 'model' ranks' gradients of
              ``wq``/``wo`` equal, and the padded heads' gradient left
              partial (``SplitToGroup``'s backward without its gather)
              above 1e-3, each rank's peak printed; it runs first, on an
              empty card.  For each run: each step's ms on
              the slowest rank (CUDA events and host clock), the
              collective bytes by kind and their host ms, each rank's
              cache and param shard bytes against the whole divided as
              the specs divide them (held), the tokens against the
              one-process ones (bf16, printed, not held: the model is
              chaotic), each rank's peak beside the parent's (under 80 GB
              together); the phase within 210 s.
23. pipeline — ``distributed.pipeline_apply`` trained through, on four
              gloo ranks sharing the card over a (4, 1) ('pod', 'model')
              mesh, one stage a rank: internlm2-1.8b's decoder layers as
              the stage function (built from ``transformer._sublayer`` as
              ``transformer.forward`` builds its groups), each rank's
              stage a DTensor row sharded over 'pod', the embedding and
              ``lm_head`` outside the pipeline on every rank.  (w_pp) one
              layer a stage in float64 on 4 x 128 tokens, num_micro 4:
              every leaf's gradient and the layers' input's against one
              process's autograd through the same four layers
              unpipelined on the same micro-batches within 1e-10; the
              broadcast's backward summing instead of averaging and the
              backward's ring sending to the wrong neighbour each read
              above 1e-3; the whole batch's gradient in one pass printed
              beside it.  (t_pp) bf16 at full depth, 6 layers a stage,
              8 x 512 host-drawn tokens, num_micro 4, two forward and
              backward passes: each pass's ms on the slowest rank (CUDA
              events and host clock), the ring's, the broadcasts' and
              the reduce's bytes and host ms a rank, each rank's peak,
              beside rank 0's unpipelined pass of the same 24 layers and
              tokens and the bound (the layers' products and fp32
              attention x3, the head on every rank; the GPipe bubble
              stated).

Phases run in the order 1, 20, 22, 23, 21, 2-6, 9, 10, 11, 12, 13, 14,
15, 16, 17, 18, 19, 7, 8 (8 also traces one churn round of (u) and one
group of (q); phase 14's step is traced right after phase 14, phases
15-19's inside them; 20, 22 and 23 run first, while the parent holds
nothing on the card, and 21 next, held to 20's and 22's readings; 21's dry runs need no card
and start in a process of their own before the build, beside 20 and 22).
The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero before it.
``--rehearse`` runs phases 2-6 and 9-23 at a tiny size on the CPU with the
plain versions (no build, no timings, no ``ok`` line; phases 12, 20, 22
and 23 over gloo on the CPU; phases 13-23 on the reduced configs, phase 22's
granite-moe under ``pad_heads``, phase 21's paper shard at 4,096 rows)
to check the script itself.  ``--probe-only RUNS`` builds, makes the musiXmatch stand-in and
runs call (i) RUNS times on the kernels, printing each run's ``mr.probe``
and call seconds and B1 launches, and stops (no ``ok`` line): two
checkouts run in turns on one card compare the probe end to end.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
FP64_TC_FLOPS = 67e12          # H100 SXM float64 on the tensor cores
TOL = 3e-5                     # kernel parity (reference tests/test_kernels.py)
RTOL_E2E = 1e-4                # end-to-end parity (reference test_kernels.py)
MODES = ("sqeuclidean", "euclidean", "dot", "cosine")
KERNELS = {
    "gmm_topb": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_sweep.cu",
        "replaces": "src/repro/kernels/gmm_topb.py:71"},
    "gmm_update_select": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_sweep.cu",
        "replaces": "src/repro/kernels/gmm_update.py:96"},
    "pairwise": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise.cu",
        "replaces": "src/repro/kernels/pairwise.py:59"},
    "gmm_grouped_topb": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm_grouped.cu",
        "replaces": "src/repro/kernels/gmm_update.py:187"},
}
GROUPS = 16                    # synthetic genres of the constrained phase
FIRST = {}                     # first kernel runs phase 10 is held to


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def _zipf_draws(rng, m: int, size: int):
    """``size`` draws from Zipf(1) rank frequencies over ``m`` items, by the
    inverse of the distribution function on ``rng.random`` (a numpy
    Generator's uniform doubles, the same on every machine and numpy
    release)."""
    import numpy as np
    ranks = np.arange(1, m + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(size), side="right"),
                      m - 1)


def musixmatch_like(n: int, d: int, seed: int, device):
    """Bag-of-words counts shaped like the paper's musiXmatch set: each row
    draws 50-150 words with Zipf(1) rank frequencies over the d words and
    counts them (repeats of frequent words become counts > 1).  Dense
    Gaussian data would be useless here: in 5,000-d its angles all sit near
    pi/2 and the run would be made of near-ties.  The words are drawn by
    the host's generator (numpy, from ``seed``), so every machine makes the
    same rows (two runs of the card's ``torch.multinomial`` on one card
    model drew different ids from one seed), and scattered into the dense
    tensor on ``device``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    draws = rng.integers(50, 151, size=n)
    words = _zipf_draws(rng, d, int(draws.sum())).astype(np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), draws)
    flat = (torch.as_tensor(rows).to(device).long() * d
            + torch.as_tensor(words).to(device).long())
    x = torch.zeros((n, d), dtype=torch.float32, device=device)
    x.view(-1).index_add_(0, flat, torch.ones((), device=device).expand(
        flat.shape[0]))
    return x


def mxm_fingerprint(x) -> dict:
    """A few sums that tell two draws of the musiXmatch stand-in apart (the
    counts are small integers, so every sum is exact in float64)."""
    import torch
    n, d = x.shape
    rows = x.sum(dim=1, dtype=torch.float64)
    cols = x.sum(dim=0, dtype=torch.float64)
    return {"words": float(rows.sum()),
            "row_weighted": float((rows * torch.arange(
                n, dtype=torch.float64, device=x.device)).sum()),
            "word_weighted": float((cols * torch.arange(
                d, dtype=torch.float64, device=x.device)).sum())}


def unit_sphere(n: int, seed: int, device):
    """Points uniform on the unit sphere in 3-D, the paper's synthetic
    streaming distribution (benchmarks/bench_streaming.py)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 3), generator=g, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


# --------------------------------------------------------------------------
# phase 2: kernels vs plain
# --------------------------------------------------------------------------

def _close(a, b) -> bool:
    import torch
    return bool(torch.allclose(a, b, rtol=TOL, atol=TOL))


def _err(a, b) -> float:
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def check_pair(x, mode, b, p, gen, errs, label, masked=None,
               ties=False):
    """One (shape, mode, b, p) case: CUDA kernel vs plain on the same
    prepared inputs.  Centers are data rows pushed off the data (so no
    distance sits at the cancellation-prone zero), min_in straddles the
    field so both branches of the running min run, ~15 % of the rows are
    masked, and the rows ``masked`` = (start, stop) all are.  With
    ``ties`` min_in is +inf and no row is masked but those, so equal rows
    give equal field values.  Besides the values, the kernel's top-p must
    be the stable top-p of its own masked min_out, value and index alike:
    no arithmetic lies between the two, so ties and their order are held
    exactly."""
    import torch
    from repro_torch.kernels import ops, ref
    n, d = x.shape
    dev = x.device
    rows = torch.randint(0, n, (b,), generator=gen, device=dev)
    cen = x[rows] + torch.rand((b, d), generator=gen, device=dev) * 2.0 - 1.0
    metric = "cosine" if mode == "cosine" else mode
    prep = ops.prepare(x, metric)
    cen_k = ops._normalize(cen) if mode == "cosine" else cen.contiguous()
    scale = ref.pairwise_ref(prep.points, cen_k, mode, xsq=prep.xsq)
    scale = scale.min(dim=1).values
    min_in = scale * (0.5 + torch.rand((n,), generator=gen, device=dev))
    mask = torch.rand((n,), generator=gen, device=dev) > 0.15
    if ties:
        min_in = torch.full((n,), float("inf"), device=dev)
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if masked is not None:
        mask[masked[0]:masked[1]] = False
    neg = torch.full((n,), float("-inf"), device=dev)
    # B2: gmm_update_select (p = 1 by construction)
    if p == 1:
        km, ka, kx = ops.gmm_update_select(prep.points, cen_k, min_in, mask,
                                           metric, xsq=prep.xsq,
                                           prepared=True)
        rm, ra, rx = ref.gmm_update_select_ref(prep.points, cen_k, min_in,
                                               mask, mode, xsq=prep.xsq)
        masked_f = torch.where(mask, rm, neg)
        own = torch.where(mask, km, neg)
        ok = {"min_out": _close(km, rm), "max": _close(kx, rx),
              "argmax_value": _close(ref.take(masked_f, ka),
                                     ref.take(masked_f, ra)),
              "own_argmax": int(ka) == int(torch.argmax(own))
              and bool(kx == ref.take(own, ka))}
        errs["gmm_update_select"] = max(errs["gmm_update_select"],
                                        _err(km, rm), _err(kx, rx))
        if not all(ok.values()):
            fail(f"gmm_update_select disagrees with plain at {label}: {ok}, "
                 f"min_out err {_err(km, rm)}, max {float(kx)} vs "
                 f"{float(rx)}")
    # B1: gmm_topb
    km, kv, ki = ops.gmm_topb(prep.points, cen_k, min_in, mask, metric, p=p,
                              xsq=prep.xsq, prepared=True)
    rm, rv, ri = ref.gmm_topb_ref(prep.points, cen_k, min_in, mask, mode, p,
                                  xsq=prep.xsq)
    masked_f = torch.where(mask, rm, neg)
    sv, si = ref.topk_stable(torch.where(mask, km, neg), p)
    # index sets are compared through the values they select (exact ties)
    ok = {"min_out": _close(km, rm), "values": _close(kv, rv),
          "selected": _close(torch.sort(masked_f[ki]).values,
                             torch.sort(masked_f[ri]).values),
          "own_top_p": torch.equal(kv, sv) and torch.equal(ki, si)}
    errs["gmm_topb"] = max(errs["gmm_topb"], _err(km, rm), _err(kv, rv))
    if not all(ok.values()):
        fail(f"gmm_topb disagrees with plain at {label}: {ok}, min_out err "
             f"{_err(km, rm)}, values err {_err(kv, rv)}")


def check_sweep_edges(dev, gen, errs, small: bool) -> int:
    """B1 and B2 at the edges of the sweep's plan (``edge_cases``: one
    row, a slab less or more one row, a tile and one row, 8,196 rows; d in
    {1, 3, 5,000, 5,001}; b in {1, 8, 9, 32, 33}; p in {1, 32, 128,
    4,096}), then equal rows on both sides of every slab border (ties that
    cross slabs and tiles), a fully masked tile, a sweep with every row
    masked, and points whose base lies 4 bytes off 16 (``x[1:]`` of a
    d = 5,001 array, and a d = 5,000 view one float into its storage).
    Returns the number of cases; ``small`` is the rehearsal's size."""
    import torch
    from repro_torch.kernels.gmm_topb import edge_cases, sweep_plan
    if small:
        cases = edge_cases(n=300, ds=(1, 3, 17), ps=(1, 32, 128))
    else:
        cases = edge_cases()
    big = max(n for n, *_ in cases)
    # rows N(0, 1/d): a dot product's size does not grow with d (at
    # d = 5,000 with N(0, 1) rows any two fp32 summation orders, torch's
    # own product among them, differ by ~1e-4 at near-zero dot products)
    base = {d: torch.randn((big, d), generator=gen, device=dev) / d ** 0.5
            for d in sorted({d for _, d, _, _ in cases})}
    count = 0
    for mode in MODES:
        for n, d, b, p in cases:
            check_pair(base[d][:n], mode, b, p, gen, errs,
                       f"edge n={n} d={d} {mode} b={b} p={p}")
            count += 1
    d = 17 if small else 64
    for b, p in ((1, 1), (8, 32), (8, 128), (33, 32)):
        plan = sweep_plan(2 ** 13, p)
        n = 2 * plan.bn + plan.rows + 1
        x = torch.randn((n, d), generator=gen, device=dev)
        for r in range(plan.rows, n, plan.rows):
            x[r] = x[r - 1]
        for mode in MODES:
            check_pair(x, mode, b, p, gen, errs,
                       f"ties across slabs n={n} d={d} {mode} b={b} p={p}",
                       ties=True)
            check_pair(x, mode, b, p, gen, errs,
                       f"masked tile n={n} d={d} {mode} b={b} p={p}",
                       masked=(plan.bn, 2 * plan.bn))
            check_pair(x[:plan.rows + 1], mode, b, min(p, plan.rows + 1),
                       gen, errs, f"all masked n={plan.rows + 1} {mode} "
                       f"b={b}", masked=(0, plan.rows + 1))
            count += 3
    n = 300 if small else 8196
    off = (torch.randn((n, 5001), generator=gen, device=dev)
           / 5001 ** 0.5)[1:]
    flat = (torch.randn((n * 5000 + 1,), generator=gen, device=dev)
            / 5000 ** 0.5)[1:]
    for x in (off, flat.view(n, 5000)):
        for mode in MODES:
            for b, p in ((1, 1), (8, 32), (33, 128)):
                check_pair(x, mode, b, p, gen, errs,
                           f"misaligned base n={x.shape[0]} d={x.shape[1]} "
                           f"{mode} b={b} p={p}")
                count += 1
    return count


def check_pairwise(x, y, mode, errs, diffs, label):
    """One B3 case: the kernel against its plain version on the same
    prepared rows (float64 sums rounded once on both sides, so they agree
    bit for bit on the card but for sums within float64 rounding of an fp32
    rounding boundary; the stated bound is 3e-5, and ``diffs[label]`` counts
    the entries that differ), a one-column call against its tile's column
    and a tail of the rows against the tile's rows, bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    px, py = ops.prepare(x, mode), ops.prepare(y, mode)
    got = ops.pairwise(px.points, py.points, mode, xsq=px.xsq, ysq=py.xsq,
                       prepared=True)
    want = ref.pairwise_ref(px.points, py.points, mode, xsq=px.xsq,
                            ysq=py.xsq)
    errs["pairwise"] = max(errs["pairwise"], _err(got, want))
    diffs[label] = int((got != want).sum())
    if not _close(got, want):
        fail(f"pairwise disagrees with plain at {label}")
    m, n = x.shape[0], y.shape[0]
    for s in sorted({0, n // 2, n - 1}):
        col = ops.pairwise(px.points, py.points[s:s + 1], mode, xsq=px.xsq,
                           ysq=None if py.xsq is None else py.xsq[s:s + 1],
                           prepared=True)
        if not torch.equal(col[:, 0], got[:, s]):
            fail(f"pairwise one-column call differs from its tile at "
                 f"{label}, column {s}")
    r = m // 3
    tail = ops.pairwise(px.points[r:], py.points, mode,
                        xsq=None if px.xsq is None else px.xsq[r:],
                        ysq=py.xsq, prepared=True)
    if not torch.equal(tail, got[r:]):
        fail(f"pairwise rows from {r} on differ from their tile at {label}")


def check_grouped(x, mode, m, p, gen, errs, diffs, label, bc=8):
    """One B4 case: the grouped sweep against its plain version on the same
    prepared inputs.  Group 1 is empty, ~5 % of the rows are labelled -1
    (they keep min_in and are never candidates), centers are data rows
    pushed off the data, and min_in straddles each row's own-group
    distance.  ``diffs[label]`` counts the min_out and top-p values that
    differ from the plain version's (expected 0, as for B3)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_update import gmm_grouped_topb_cuda
    n, d = x.shape
    dev = x.device
    rows = torch.randint(0, n, (m * bc,), generator=gen, device=dev)
    cen = (x[rows] + torch.rand((m * bc, d), generator=gen, device=dev)
           * 2.0 - 1.0).view(m, bc, d)
    prep = ops.prepare(x, mode)
    cen_k = (ops._normalize(cen) if mode == "cosine" else cen).contiguous()
    labels = torch.randint(0, m, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[labels == 1] = 0
    labels[torch.rand((n,), generator=gen, device=dev) < 0.05] = -1
    inf = torch.full((n,), float("inf"), device=dev)
    own = ref.gmm_grouped_topb_ref(prep.points, cen_k, inf, labels, mode, 1,
                                   xsq=prep.xsq)[0]
    own = torch.where(torch.isinf(own), torch.ones_like(own), own)
    min_in = own * (0.5 + torch.rand((n,), generator=gen, device=dev))
    if x.is_cuda:
        k_out = gmm_grouped_topb_cuda(prep.points, cen_k, prep.xsq, min_in,
                                      labels, mode=mode, p=p)
    else:
        k_out = ops.grouped_gmm_topb(prep.points, cen_k, min_in, labels,
                                     mode, p, xsq=prep.xsq, prepared=True)
    r_out = ref.gmm_grouped_topb_ref(prep.points, cen_k, min_in, labels,
                                     mode, p, xsq=prep.xsq)
    compare_grouped(k_out, r_out, labels, m, errs, diffs, label)


def compare_grouped(k_out, r_out, labels, m, errs, diffs, label):
    """Hold one B4 output (min_out, top-p values, indices) against its
    plain version's on the same inputs: min_out and the values equal entry
    for entry, every index in [0, n), and the indices select the same
    own-group min_out values (exact ties pass; a -inf fill entry selects
    nothing).  ``diffs[label]`` counts the min_out and top-p values that
    differ; any difference fails the run."""
    import torch
    km, kv, ki = k_out
    rm, rv, ri = r_out
    n = km.shape[0]
    field = torch.where(labels[None, :] == torch.arange(
        m, device=km.device)[:, None], rm[None, :], float("-inf"))

    def picked(vals, idx):
        return torch.sort(torch.where(torch.isfinite(vals),
                                      torch.gather(field, 1, idx),
                                      float("-inf")), dim=1).values
    if kv.shape != rv.shape or ki.shape != ri.shape:
        fail(f"gmm_grouped_topb at {label}: top-p of shape "
             f"{tuple(kv.shape)}, plain {tuple(rv.shape)}")
    diffs[label] = int((km != rm).sum()) + int((kv != rv).sum())
    errs["gmm_grouped_topb"] = max(errs["gmm_grouped_topb"], _err(km, rm),
                                   _err(kv, rv))
    ok = (diffs[label] == 0 and bool(((ki >= 0) & (ki < n)).all())
          and bool(torch.equal(picked(kv, ki), picked(rv, ri))))
    if not ok:
        fail(f"gmm_grouped_topb disagrees with plain at {label} "
             f"({diffs[label]} differing entries)")


STREAM_TILES = {"chunk": 4096, "caps": (257, 1025, 129),
                "sphere_chunk": 65536, "sphere_cap": 513}
REHEARSAL_TILES = {"chunk": 512, "caps": (9, 65, 17), "sphere_chunk": 4096,
                   "sphere_cap": 65}


def stream_tiles(big, sphere, shapes):
    """The distance tiles the stream calls run: a chunk of rows against
    k'+1 other rows of the same data."""
    m, caps = shapes["chunk"], shapes["caps"]
    far = big.shape[0] // 2
    out = [(f"stream tile {m}x{c}x{big.shape[1]} cosine", big[:m],
            big[far:far + c], "cosine") for c in caps]
    ms, cs = shapes["sphere_chunk"], shapes["sphere_cap"]
    out.append((f"stream tile {ms}x{cs}x3 euclidean", sphere[:ms],
                sphere[-cs:], "euclidean"))
    return out


def phase_kernels(big, seed: int, small_only: bool, tiles=(), out=None):
    import torch
    dev = big.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    errs = dict.fromkeys(KERNELS, 0.0)
    diffs = {"pairwise": {}, "gmm_grouped_topb": {}}
    cases = 0
    t0 = time.perf_counter()
    for n in (33, 1000, 4097):
        for d in (3, 17, 128):
            x = torch.randn((n, d), generator=gen, device=dev)
            for mode in MODES:
                for b in (1, 8):
                    for p in (1, 32, 128, 256):
                        if p <= n:
                            check_pair(x, mode, b, p, gen, errs,
                                       f"n={n} d={d} {mode} b={b} p={p}")
                            cases += 1
    cases += check_sweep_edges(dev, gen, errs, small_only)
    if not small_only:
        for mode in MODES:
            for b in (1, 8, 9, 33):
                for p in (1, 32, 128, 256):
                    check_pair(big, mode, b, p, gen, errs,
                               f"main shape {mode} b={b} p={p}")
                    cases += 1
    # B3: ragged m, n, d (none a multiple of a tile edge; n <= 8 takes the
    # narrow tile, the others the medium and wide ones)
    for m, n, d in ((33, 5, 3), (1000, 129, 17), (4097, 300, 128),
                    (1, 1, 5), (70, 4, 64), (300, 1025, 3), (65, 9, 1),
                    (130, 70, 5000)):
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((n, d), generator=gen, device=dev)
        for mode in MODES:
            check_pairwise(x, y, mode, errs, diffs["pairwise"],
                           f"m={m} n={n} d={d} {mode}")
            cases += 1
    for label, x, y, mode in tiles:
        check_pairwise(x, y, mode, errs, diffs["pairwise"], label)
        cases += 1
    # B4: ragged n, m groups of bc centers (bc = 9 takes two passes of 8),
    # p up to 256
    for n, d in ((1000, 17), (4097, 128)):
        x = torch.randn((n, d), generator=gen, device=dev)
        for mode in MODES:
            for m, bc in ((2, 8), (16, 8), (64, 8), (4, 1), (4, 3), (4, 9)):
                for p in (1, 8, 128, 256):
                    check_grouped(x, mode, m, p, gen, errs,
                                  diffs["gmm_grouped_topb"],
                                  f"n={n} d={d} {mode} m={m} bc={bc} p={p}",
                                  bc=bc)
                    cases += 1
    if not small_only:
        for mode in MODES:
            for m in (2, GROUPS, 64):
                for p in (1, 128):
                    check_grouped(big, mode, m, p, gen, errs,
                                  diffs["gmm_grouped_topb"],
                                  f"main shape {mode} m={m} p={p}")
                    cases += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if out is not None:
        (out / "kernel_differing_entries.json").write_text(
            json.dumps(diffs, indent=1))
    emit({"phase": "kernels", "cases": cases, "tolerance": TOL,
          "max_abs_err": errs,
          "differing_entries": {k: sum(v.values()) for k, v in diffs.items()},
          "cases_with_differing_entries": {
              k: {c: n for c, n in v.items() if n} for k, v in diffs.items()},
          "seconds": time.perf_counter() - t0})
    # every B3 and B4 case with its count (expected 0 each)
    for k, v in diffs.items():
        emit({"phase": "differing_entries", "kernel": k,
              "cases": len(v), "counts": list(v.values())})
    return errs, diffs


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

CALLS = {
    "a_cosine_defaults": (dict(k=16, metric="cosine"), {}),
    "b_euclidean_defaults": (dict(k=16), {}),
    "c_cosine_kprime64_b1": (dict(k=16, metric="cosine"),
                             dict(kprime=64, b=1)),
}


def _run(x, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(x, execution=repro_torch.ExecutionSpec(
        use_pallas=use_pallas, device=device, **knobs), **problem)
    idx = res.indices
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, idx, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _spread(secs):
    return {"median": statistics.median(secs), "min": min(secs),
            "max": max(secs), "all": secs}


def _spread_of(v):
    return {"median": statistics.median(v), "min": min(v), "max": max(v)}


def phase_main(x, device, check_launches: bool, pairs: int = 10):
    import numpy as np
    launches = dict.fromkeys(KERNELS, 0)
    kernel_median_s = {}
    # untimed warm-up of both paths: a process's first engine call pays
    # one-time library set-up (~0.1-0.4 s) that would land on whichever
    # side runs first
    for use_pallas in ("auto", False):
        _run(x, *CALLS["a_cosine_defaults"], use_pallas, device)
    order = ("auto", False, False, "auto") * (pairs // 2)
    for name, (problem, knobs) in CALLS.items():
        # `pairs` calls per side in turns (kernel, plain, plain, kernel, ...)
        # so neither side always runs first; the first call of each side is
        # held to the agreement checks, the repeats must reproduce it
        # exactly (no atomics, no data races)
        runs = {"auto": [], False: []}
        for use_pallas in order:
            runs[use_pallas].append(_run(x, problem, knobs, use_pallas,
                                         device))
        (kres, kidx, _, kl), (pres, pidx, _, pl) = runs["auto"][0], \
            runs[False][0]
        for first, idx0, side in ((kres, kidx, "auto"), (pres, pidx, False)):
            for res, idx, _, _ in runs[side][1:]:
                if not (np.array_equal(idx, idx0)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        if any(lc != kl for *_, lc in runs["auto"]):
            fail(f"{name}: kernel launch counts differ between repeats")
        ks = [r[2] for r in runs["auto"]]
        ps = [r[2] for r in runs[False]]
        kc, pc = kres.cert, pres.cert
        row = {"phase": "main", "call": name, "n": int(x.shape[0]),
               "d": int(x.shape[1]), "problem": problem, "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_over_plain_median":
                   statistics.median(ks) / statistics.median(ps),
               "kernel_launches": kl,
               "value": [kres.value, pres.value],
               "coreset_radius": [float(kres.coreset.radius),
                                  float(pres.coreset.radius)],
               "identical_picks": int(len(np.intersect1d(kidx, pidx))),
               "k": len(kidx)}
        close = ["value", "coreset_radius"]
        if kc is not None or pc is not None:    # pinned knobs mint no cert
            row.update({
                "radius": [kc.radius, pc.radius],
                "ratio": [kc.ratio, pc.ratio],
                "meets_target": [kc.meets_target, pc.meets_target],
                "kprime": [kc.kprime, pc.kprime],
                "b_schedule_equal": kc.b_schedule == pc.b_schedule,
                "b_schedule": [list(map(list, kc.b_schedule)),
                               list(map(list, pc.b_schedule))]})
            close += ["radius", "ratio"]
        emit(row)
        for key in close:
            a, b = row[key]
            if not np.isclose(a, b, rtol=RTOL_E2E, atol=0.0):
                fail(f"{name}: {key} kernel {a} vs plain {b}")
        if "radius" in row and (kc.meets_target != pc.meets_target
                                or not row["b_schedule_equal"]):
            fail(f"{name}: meets_target/b_schedule differ")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and len(set(kidx.tolist())) == problem["k"]):
            fail(f"{name}: solution is not k distinct finite rows")
        if any(any(lc.values()) for *_, lc in runs[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches:
            want = "gmm_update_select" if knobs.get("b") == 1 else "gmm_topb"
            if kl[want] <= 0:
                fail(f"{name}: {want} never launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        kernel_median_s[name] = statistics.median(ks)
    return launches, kernel_median_s


# --------------------------------------------------------------------------
# phase 4: the streaming path
# --------------------------------------------------------------------------

def stream_calls(full: bool):
    """(name, data, problem, knobs) of the stream calls; ``full=False`` is
    the rehearsal's tiny size."""
    if full:
        return [
            ("a_cosine_edge_k128", "mxm", dict(k=128, metric="cosine"), {}),
            ("b_cosine_edge_k128_kp1024", "mxm",
             dict(k=128, metric="cosine"), dict(kprime=1024)),
            ("c_cosine_clique_k32_ext", "mxm",
             dict(k=32, metric="cosine", measure="remote-clique"),
             dict(kprime=128)),
            ("d_sphere_gen_k64", "sphere", dict(k=64),
             dict(kprime=512, chunk=65536, smm_mode="gen")),
        ]
    return [
        ("a_cosine_edge", "mxm", dict(k=8, metric="cosine"),
         dict(chunk=512)),
        ("b_cosine_edge_kp64", "mxm", dict(k=8, metric="cosine"),
         dict(kprime=64, chunk=512)),
        ("c_cosine_clique_ext", "mxm",
         dict(k=4, metric="cosine", measure="remote-clique"),
         dict(kprime=16, chunk=512)),
        ("d_sphere_gen", "sphere", dict(k=8),
         dict(kprime=64, chunk=4096, smm_mode="gen")),
    ]


def _stream_source(data, x, chunk):
    """The points as a user streams them: the on-card array with
    ``mode="streaming"`` (musiXmatch shape), or a chunk iterator over the
    on-card sphere points."""
    if data == "mxm":
        return x, {"mode": "streaming"}
    return (x[i:i + chunk] for i in range(0, x.shape[0], chunk)), {}


def _run_stream(x, data, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    src, extra = _stream_source(data, x, knobs["chunk"] if "chunk" in knobs
                                else 4096)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(src, execution=repro_torch.ExecutionSpec(
        use_pallas=use_pallas, device=device, trace=True, **extra, **knobs),
        **problem)
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _near(a, b) -> bool:
    """Floats derived from distances (d_i, the certificate) agree to rtol
    1e-5; kernel and plain compute the same chain, so they are expected
    equal, and the bound only absorbs a last-ulp difference of sqrt/acos."""
    import numpy as np
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and bool(np.allclose(a, b, rtol=1e-5, atol=0))


def _coreset_rows(res):
    """The core-set as host arrays: its points (valid rows, in slot order)
    and, for a generalized one, the multiplicities."""
    from repro_torch.device import to_numpy
    cs = res.coreset
    if hasattr(cs, "multiplicity"):
        m = to_numpy(cs.multiplicity)
        return to_numpy(cs.points)[m > 0], m[m > 0]
    v = to_numpy(cs.valid)
    return to_numpy(cs.points)[v], None


def phase_stream(data, device, check_launches: bool, runs: int = 3,
                 full: bool = True):
    """The stream calls, ``runs`` per side in turns (kernel, plain, plain,
    kernel, ...).  Returns (launches of the first kernel run of each call,
    summed; per-call kernel median seconds).  The first kernel run of call
    (b) stays in ``FIRST`` for phase 10."""
    import numpy as np
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    order = ["auto", False, False, "auto"] * runs
    order = order[:2 * runs]
    for name, kind, problem, knobs in stream_calls(full):
        x = data[kind]
        n = int(x.shape[0])
        out = {"auto": [], False: []}
        for use_pallas in order:
            out[use_pallas].append(_run_stream(x, kind, problem, knobs,
                                               use_pallas, device))
        (kres, _, kl), (pres, _, pl) = out["auto"][0], out[False][0]
        for side in ("auto", False):
            first = out[side][0][0]
            for res, _, lc in out[side][1:]:
                if not (np.array_equal(res.solution, first.solution)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        kc, pc = kres.cert, pres.cert
        (kp, km), (pp, pm) = _coreset_rows(kres), _coreset_rows(pres)
        same_coreset = (kp.shape == pp.shape and np.array_equal(kp, pp)
                        and (km is None or np.array_equal(km, pm)))
        tr = kres.telemetry
        chunk = knobs.get("chunk", 4096)
        chunks = -(-n // chunk)
        ks = [r[1] for r in out["auto"]]
        ps = [r[1] for r in out[False]]
        row = {"phase": "stream", "call": name, "n": n,
               "d": int(x.shape[1]), "problem": problem, "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_points_per_s": n / statistics.median(ks),
               "plain_points_per_s": n / statistics.median(ps),
               "chunks": chunks,
               "far_inserts": tr.counters.get("far_inserts", 0),
               "merges": tr.extras["merges"],
               "host_reads_per_chunk": tr.counters["host_syncs"] / chunks,
               "distance_tiles": tr.counters["device_dispatches"],
               "kernel_launches": kl,
               "coreset_rows": int(kp.shape[0]),
               "agree": {
                   "coreset": bool(same_coreset),
                   "d_thr": _near(float(kres.coreset.radius),
                                  float(pres.coreset.radius)),
                   "phase_log": kc.counts == pc.counts
                   and _near(kc.radii, pc.radii),
                   "certificate": kc.meets_target == pc.meets_target
                   and _near((kc.radius, kc.scale, kc.ratio),
                             (pc.radius, pc.scale, pc.ratio)),
                   "picks": bool(np.array_equal(kres.solution,
                                                pres.solution)),
                   "value": bool(np.isclose(kres.value, pres.value,
                                            rtol=RTOL_E2E, atol=0.0))},
               "value": [kres.value, pres.value],
               "radius": [kc.radius, pc.radius],
               "scale": [kc.scale, pc.scale],
               "ratio": [kc.ratio, pc.ratio]}
        emit(row)
        bad = [k for k, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and np.isfinite(kres.value)):
            fail(f"{name}: the solution is not k finite rows")
        if any(any(lc.values()) for *_, lc in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches and kl["pairwise"] <= 0:
            fail(f"{name}: pairwise never launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        median_s[name] = statistics.median(ks)
        if name.startswith("b_"):
            FIRST["stream_b"] = (kres, median_s[name])
    return launches, median_s


# --------------------------------------------------------------------------
# phase 5: the constrained path
# --------------------------------------------------------------------------

def genre_labels(n: int, m: int, seed: int, device):
    """Synthetic "genre" labels: m groups with Zipf(1) shares (the smallest
    of 16 holds ~1.8 % of the rows).  The follow-up paper
    (arXiv:2002.03175) runs musiXmatch under a genre partition matroid;
    its label file is not in the repo, so the labels are made here, by the
    host's generator (numpy, from ``seed``; the same on every machine)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 3)
    return torch.as_tensor(_zipf_draws(rng, m, n).astype(np.int32)).to(
        device)


def labels_fingerprint(labels) -> dict:
    """Rows a group and an index-weighted sum, to compare two draws."""
    import torch
    lab = labels.long()
    return {"group_rows": torch.bincount(lab).tolist(),
            "index_weighted": int((lab * torch.arange(
                lab.shape[0], device=lab.device)).sum())}


def constrained_calls(full: bool):
    """(name, problem, knobs) of the constrained batch calls; ``full=False``
    is the rehearsal's tiny size."""
    k = 32 if full else GROUPS
    quotas = [k // GROUPS] * GROUPS
    return [
        ("e_cosine_labels_k32", dict(k=k, metric="cosine"), {}),
        ("e_euclidean_labels_k32", dict(k=k), {}),
        ("f_cosine_labels_k32_kp64_b1", dict(k=k, metric="cosine"),
         dict(kprime=64 if full else 16, b=1)),
        ("g_cosine_clique_quotas_k32_kp8",
         dict(k=k, metric="cosine", measure="remote-clique", quotas=quotas),
         dict(kprime=8 if full else 4)),
    ]


def _run_constrained(x, labels, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(x, labels=labels,
                                execution=repro_torch.ExecutionSpec(
                                    use_pallas=use_pallas, device=device,
                                    trace=True, **knobs), **problem)
    idx = res.indices
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, idx, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _agree_constrained(kres, pres, kidx, pidx, labels_np):
    """Kernel against plain on one constrained call: the same picks and
    labels, quotas met, value to rtol 1e-4, per-group radius and
    certificate to rtol 1e-4, the same executed schedule, equal
    counters."""
    import numpy as np
    from repro_torch.device import to_numpy
    mat = kres.plan.matroid
    kc, pc = kres.cert, pres.cert

    def close(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return a.shape == b.shape and bool(np.allclose(a, b, rtol=RTOL_E2E,
                                                       atol=0.0))
    agree = {
        "picks": bool(np.array_equal(kidx, pidx)),
        "labels": bool(np.array_equal(kres.labels, pres.labels)
                       and np.array_equal(labels_np[kidx], kres.labels)),
        "quotas": bool(mat.basis_feasible(np.bincount(kres.labels,
                                                      minlength=mat.m))),
        "value": bool(np.isclose(kres.value, pres.value, rtol=RTOL_E2E,
                                 atol=0.0)),
        "counters": dict(kres.telemetry.counters)
        == dict(pres.telemetry.counters),
    }
    if kres.coreset is not None:
        agree["group_radius"] = close(to_numpy(kres.coreset.radius),
                                      to_numpy(pres.coreset.radius))
    if kc is not None or pc is not None:
        agree["certificate"] = (
            kc.meets_target == pc.meets_target
            and close((kc.radius, kc.scale, kc.ratio),
                      (pc.radius, pc.scale, pc.ratio))
            and close(kc.group_ratios, pc.group_ratios))
        agree["b_schedule"] = kc.b_schedule == pc.b_schedule
    return agree


def phase_constrained(x, labels, device, check_launches: bool,
                      runs: int = 3, full: bool = True):
    """The constrained batch calls, ``runs`` per side in turns, then the
    constrained stream.  Returns (launches of the first kernel run of each
    call, summed; per-call kernel median seconds)."""
    import numpy as np
    from repro_torch.device import to_numpy
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    labels_np = to_numpy(labels)
    sizes = np.bincount(labels_np, minlength=GROUPS)
    emit({"phase": "constrained", "labels": "synthetic genres, Zipf(1)",
          "groups": GROUPS, "group_rows": sizes.tolist()})
    order = (["auto", False, False, "auto"] * runs)[:2 * runs]
    for name, problem, knobs in constrained_calls(full):
        out = {"auto": [], False: []}
        for use_pallas in order:
            out[use_pallas].append(_run_constrained(x, labels, problem, knobs,
                                                    use_pallas, device))
        (kres, kidx, _, kl), (pres, pidx, _, _) = out["auto"][0], \
            out[False][0]
        for side in ("auto", False):
            first, idx0 = out[side][0][0], out[side][0][1]
            for res, idx, _, _ in out[side][1:]:
                if not (np.array_equal(idx, idx0)
                        and res.value == first.value):
                    fail(f"{name}: a repeated run gave another answer")
        ks = [r[2] for r in out["auto"]]
        ps = [r[2] for r in out[False]]
        kc = kres.cert
        row = {"phase": "constrained", "call": name, "n": int(x.shape[0]),
               "d": int(x.shape[1]),
               "problem": {k: v for k, v in problem.items()
                           if k != "quotas"},
               "quotas": f"{problem['quotas'][0]} per group"
               if "quotas" in problem else "labels alone (balanced)",
               "knobs": knobs,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_over_plain_median":
                   statistics.median(ks) / statistics.median(ps),
               "kernel_launches": kl,
               "coreset_rows": kres.telemetry.extras["coreset_size"],
               "counters": dict(kres.telemetry.counters),
               "value": [kres.value, pres.value],
               "agree": _agree_constrained(kres, pres, kidx, pidx,
                                           labels_np)}
        if kres.coreset is not None:
            row["group_radius"] = [to_numpy(kres.coreset.radius).tolist(),
                                   to_numpy(pres.coreset.radius).tolist()]
        if kc is not None:
            row.update({"ratio": [kc.ratio, pres.cert.ratio],
                        "meets_target": kc.meets_target,
                        "kprime": kc.kprime,
                        "b_schedule": list(map(list, kc.b_schedule)),
                        "worst_group_ratio": max(kc.group_ratios)})
        emit(row)
        bad = [k for k, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and len(set(kidx.tolist())) == problem["k"]):
            fail(f"{name}: solution is not k distinct finite rows")
        if any(any(lc.values()) for *_, lc in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches:
            want = ["gmm_grouped_topb"] + (
                ["pairwise"] if problem.get("measure") == "remote-clique"
                else [])
            if any(kl[w] <= 0 for w in want):
                fail(f"{name}: {want} not all launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        median_s[name] = statistics.median(ks)
    s_launches, s_median = phase_constrained_stream(
        x, labels, device, check_launches, runs=runs, full=full)
    for k, v in s_launches.items():
        launches[k] += v
    median_s.update(s_median)
    return launches, median_s


def phase_constrained_stream(x, labels, device, check_launches: bool,
                             runs: int = 3, full: bool = True):
    """Call (h): the constrained stream over the whole data, ``runs`` calls
    per side in turns; kernel and plain must agree."""
    import numpy as np
    import torch
    from repro_torch.device import to_numpy
    k = 32 if full else GROUPS
    chunk = 4096 if full else 512
    problem = dict(k=k, metric="cosine", quotas=[k // GROUPS] * GROUPS)
    knobs = dict(mode="streaming", kprime=256 if full else 16, chunk=chunk)
    name = "h_cosine_stream_quotas_k32_kp256"
    n = int(x.shape[0])
    chunks = -(-n // chunk)
    out = {"auto": [], False: []}
    for use_pallas in (["auto", False, False, "auto"] * runs)[:2 * runs]:
        out[use_pallas].append(_run_constrained(x, labels, problem, knobs,
                                                use_pallas, device))
    for side in ("auto", False):
        res0, idx0 = out[side][0][0], out[side][0][1]
        for res, idx, _, _ in out[side][1:]:
            if not (np.array_equal(idx, idx0) and res.value == res0.value):
                fail(f"{name}: a repeated run gave another answer")
    kres, kidx, _, kl = out["auto"][0]
    pres, pidx, _, _ = out[False][0]
    ks = [r[2] for r in out["auto"]]
    ps = [r[2] for r in out[False]]
    tr = kres.telemetry
    row = {"phase": "constrained", "call": name, "n": n,
           "d": int(x.shape[1]), "problem": {"k": k, "metric": "cosine"},
           "quotas": f"{k // GROUPS} per group", "knobs": knobs,
           "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
           "kernel_points_per_s": n / statistics.median(ks),
           "plain_points_per_s": n / statistics.median(ps),
           "chunks": chunks, "tiles": tr.counters["device_dispatches"],
           "merges": tr.counters.get("merges", 0),
           "far_inserts": tr.counters.get("far_inserts", 0),
           "host_reads_per_chunk": tr.counters["host_syncs"] / chunks,
           "coreset_rows": tr.extras["coreset_size"],
           "kernel_launches": kl, "value": kres.value,
           "ratio": kres.cert.ratio,
           "worst_group_ratio": max(kres.cert.group_ratios),
           "agree": _agree_constrained(kres, pres, kidx, pidx,
                                       to_numpy(labels))}
    emit(row)
    bad = [key for key, ok in row["agree"].items() if not ok]
    if bad:
        fail(f"{name}: kernel and plain disagree on {bad}")
    if not (np.isfinite(kres.solution).all()
            and kres.solution.shape == (k, x.shape[1])
            and len(set(kidx.tolist())) == k):
        fail(f"{name}: solution is not k distinct finite rows")
    if any(any(lc.values()) for *_, lc in out[False]):
        fail(f"{name}: a kernel launched on a plain run")
    if check_launches and kl["pairwise"] <= 0:
        fail(f"{name}: pairwise never launched on the kernel run")
    if x.is_cuda:
        torch.cuda.empty_cache()
    return kl, {name: statistics.median(ks)}


# --------------------------------------------------------------------------
# phase 6: the simulated MapReduce path
# --------------------------------------------------------------------------

def mapreduce_calls(full: bool):
    """(name, data, problem, knobs, kernel runs, plain runs) of the
    MapReduce calls; ``full=False`` is the rehearsal's tiny size.  Data
    "mxm" is the musiXmatch shape, "mxm+genres" the same with the
    constrained phase's labels, "sphere" the 2^24-point unit sphere."""
    if full:
        return [
            ("i_cosine_edge_k128_l16", "mxm",
             dict(k=128, metric="cosine"), dict(num_reducers=16), 3, 1),
            ("j_cosine_clique_k32_kp64_l16_random", "mxm",
             dict(k=32, metric="cosine", measure="remote-clique"),
             dict(kprime=64, num_reducers=16, partition="random"), 2, 1),
            ("k_cosine_clique_gen_k16_kp64_l8", "mxm",
             dict(k=16, metric="cosine", measure="remote-clique"),
             dict(kprime=64, num_reducers=8, generalized=True), 3, 1),
            ("l_cosine_labels_k32_l4", "mxm+genres",
             dict(k=32, metric="cosine"), dict(num_reducers=4), 3, 1),
            ("m_sphere_edge_k64_kp512_l16_adversarial", "sphere",
             dict(k=64), dict(kprime=512, num_reducers=16,
                              partition="adversarial"), 3, 1),
        ]
    return [
        ("i_cosine_edge_l16", "mxm", dict(k=8, metric="cosine"),
         dict(num_reducers=16), 1, 1),
        ("j_cosine_clique_kp16_l16_random", "mxm",
         dict(k=4, metric="cosine", measure="remote-clique"),
         dict(kprime=16, num_reducers=16, partition="random"), 1, 1),
        ("k_cosine_clique_gen_kp16_l8", "mxm",
         dict(k=4, metric="cosine", measure="remote-clique"),
         dict(kprime=16, num_reducers=8, generalized=True), 1, 1),
        ("l_cosine_labels_l4", "mxm+genres", dict(k=GROUPS, metric="cosine"),
         dict(num_reducers=4), 1, 1),
        ("m_sphere_edge_kp64_l16_adversarial", "sphere", dict(k=8),
         dict(kprime=64, num_reducers=16, partition="adversarial"), 1, 1),
    ]


def _find_span(trace, name):
    """The first span called ``name`` in a run's trace, or None."""
    todo = list(trace.spans)
    while todo:
        sp = todo.pop(0)
        if sp.name == name:
            return sp
        todo.extend(sp.children)
    return None


def _span_seconds(trace, name):
    """Seconds of the first span called ``name`` in a run's trace."""
    sp = _find_span(trace, name)
    return 0.0 if sp is None else sp.seconds


def _run_mr(x, labels, problem, knobs, use_pallas, device):
    import torch
    import repro_torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.diversify(x, labels=labels,
                                execution=repro_torch.ExecutionSpec(
                                    mode="mapreduce", use_pallas=use_pallas,
                                    device=device, trace=True, **knobs),
                                **problem)
    idx = res.indices
    if x.is_cuda:
        torch.cuda.synchronize()
    return res, idx, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _agree_mr(kres, pres, kidx, pidx):
    """Kernel against plain on one MapReduce call: the same picks (and
    labels), value, core-set radius and certificate floats within rtol
    1e-4, equal certificate counts and schedules, equal counters."""
    import numpy as np

    def close(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return a.shape == b.shape and bool(np.allclose(a, b, rtol=RTOL_E2E,
                                                       atol=0.0))
    agree = {
        "picks": bool(np.array_equal(kres.solution, pres.solution)
                      and (kidx is None) == (pidx is None)
                      and (kidx is None or np.array_equal(kidx, pidx))),
        "value": close(kres.value, pres.value),
        "counters": dict(kres.telemetry.counters)
        == dict(pres.telemetry.counters),
    }
    if kres.labels is not None:
        agree["labels"] = bool(np.array_equal(kres.labels, pres.labels))
    if kres.coreset is not None:
        agree["radius"] = close(float(kres.coreset.radius),
                                float(pres.coreset.radius))
        agree["coreset_size"] = (kres.telemetry.extras.get("coreset_size")
                                 == pres.telemetry.extras.get("coreset_size"))
    kc, pc = kres.cert, pres.cert
    if kc is not None or pc is not None:
        agree["certificate"] = (
            kc is not None and pc is not None
            and kc.meets_target == pc.meets_target
            and kc.counts == pc.counts and kc.kprime == pc.kprime
            and kc.b_schedule == pc.b_schedule
            and close((kc.radius, kc.scale, kc.ratio),
                      (pc.radius, pc.scale, pc.ratio)))
    return agree


class SweepRecorder:
    """Counts the calls of the B1 and B2 wrappers (``kernels.ops.gmm_topb``
    and ``gmm_update_select``) by (wrapper, metric, n, d, b, p) while it is
    entered.  The engine calls them through the ``ops`` module, so wrapping
    the module's functions sees every sweep of a run."""

    def __init__(self):
        import collections
        self.calls = collections.Counter()

    def __enter__(self):
        import inspect

        import torch
        from repro_torch.kernels import ops
        self._saved = {"gmm_topb": ops.gmm_topb,
                       "gmm_update_select": ops.gmm_update_select}
        for name, fn in self._saved.items():
            sig = inspect.signature(fn)

            def wrapped(*a, _fn=fn, _sig=sig, _name=name, **kw):
                args = _sig.bind(*a, **kw).arguments
                pts = args["points"]
                b = torch.atleast_2d(args["centers"]).shape[0]
                p = 1 if _name == "gmm_update_select" else (
                    args.get("p") or b)
                self.calls[(_name, args["metric_name"], int(pts.shape[0]),
                            int(pts.shape[1]), int(b), int(p))] += 1
                return _fn(*a, **kw)
            setattr(ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        return False

    def rows(self):
        """[[wrapper, metric, n, d, b, p, calls], ...] in sorted order."""
        return [[*k, v] for k, v in sorted(self.calls.items())]


SWEEPS = {}                    # B1/B2 shapes of (i)'s and (m)'s first run


def phase_mapreduce(data, device, check_launches: bool, full: bool = True):
    """The MapReduce calls, kernel and plain runs in turns (kernel first,
    plain second, then the remaining kernel runs).  Returns (launches of
    the first kernel run of each call, summed; per-call kernel median
    seconds).  The first kernel run of call (i) stays in ``FIRST`` for
    phase 10."""
    import numpy as np
    import torch
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    for name, kind, problem, knobs, kruns, pruns in mapreduce_calls(full):
        x = data["mxm" if kind == "mxm+genres" else kind]
        labels = data["genres"] if kind == "mxm+genres" else None
        order = (["auto", False] * max(kruns, pruns))
        out = {"auto": [], False: []}
        recorder = SweepRecorder()
        for use_pallas in order:
            if len(out[use_pallas]) < (kruns if use_pallas else pruns):
                if use_pallas and not out[use_pallas]:
                    with recorder:
                        out[use_pallas].append(_run_mr(
                            x, labels, problem, knobs, use_pallas, device))
                    continue
                out[use_pallas].append(_run_mr(x, labels, problem, knobs,
                                               use_pallas, device))
        SWEEPS[name[0]] = recorder.rows()
        (kres, kidx, _, kl), (pres, pidx, _, _) = out["auto"][0], \
            out[False][0]
        for side in ("auto", False):
            res0, idx0 = out[side][0][0], out[side][0][1]
            for res, idx, _, _ in out[side][1:]:
                if not (np.array_equal(res.solution, res0.solution)
                        and res.value == res0.value):
                    fail(f"{name}: a repeated run gave another answer")
        if any(lc != kl for *_, lc in out["auto"]):
            fail(f"{name}: kernel launch counts differ between repeats")
        # the timed run's own record of round 1: its frozen schedule, fold
        # count and the launches made inside the span
        r1 = _find_span(kres.telemetry, "mr.round1")
        if r1 is None:
            fail(f"{name}: the run recorded no mr.round1 span")
        ks = [r[2] for r in out["auto"]]
        ps = [r[2] for r in out[False]]
        tr = kres.telemetry
        rounds = tr.phases[0]["seconds"]
        probe_s = _span_seconds(tr, "mr.probe")
        round1_s = _span_seconds(tr, "mr.round1")
        row = {"phase": "mapreduce", "call": name, "n": int(x.shape[0]),
               "d": int(x.shape[1]), "problem": problem, "knobs": knobs,
               "labels": "synthetic genres, Zipf(1), 16 groups"
               if labels is not None else None,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_over_plain_median":
                   statistics.median(ks) / statistics.median(ps),
               "rounds_s": rounds, "probe_s": probe_s,
               "round1_s": round1_s,
               "solve_s": rounds - probe_s - round1_s,
               "plain_round1_s": _span_seconds(pres.telemetry, "mr.round1"),
               "kprime": r1.attrs["kprime"],
               "schedule": r1.attrs["schedule"],
               "round1_sweeps": r1.attrs["folds"],
               "round1_launches": r1.attrs["launches"],
               "round1_b4_launches": r1.attrs["launches"]["gmm_grouped_topb"],
               "coreset_size": tr.extras.get("coreset_size"),
               "counters": dict(tr.counters),
               "kernel_launches": kl, "value": [kres.value, pres.value],
               # the B1/B2 sweeps of the first kernel run:
               # [wrapper, metric, n, d, b, p, calls]
               "b1_b2_sweeps": SWEEPS[name[0]],
               "agree": _agree_mr(kres, pres, kidx, pidx)}
        if kres.cert is not None:
            row.update({"ratio": [kres.cert.ratio, pres.cert.ratio],
                        "meets_target": kres.cert.meets_target,
                        "probe_b_schedule": list(map(list,
                                                     kres.cert.b_schedule))})
        emit(row)
        bad = [k for k, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if not (np.isfinite(kres.solution).all()
                and kres.solution.shape == (problem["k"], x.shape[1])
                and np.isfinite(kres.value)):
            fail(f"{name}: the solution is not k finite rows")
        if kidx is not None and len(set(kidx.tolist())) != problem["k"]:
            fail(f"{name}: the indices are not k distinct rows")
        if any(any(lc.values()) for *_, lc in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches:
            if row["round1_b4_launches"] != row["round1_sweeps"]:
                fail(f"{name}: round 1 made {row['round1_b4_launches']} B4 "
                     f"launches for {row['round1_sweeps']} folds")
            if (problem.get("measure") == "remote-clique"
                    and kl["pairwise"] <= 0):
                fail(f"{name}: pairwise never launched on the kernel run")
        for k, v in kl.items():
            launches[k] += v
        median_s[name] = statistics.median(ks)
        if name.startswith("i_"):
            FIRST["mapreduce_i"] = (kres, kidx, median_s[name])
        if x.is_cuda:
            torch.cuda.empty_cache()
    return launches, median_s


# --------------------------------------------------------------------------
# phase 7: times
# --------------------------------------------------------------------------

def _time_ms(fn, reps: int = 10):
    """(device ms per call, host ms per call): the median of three
    CUDA-event windows of ``reps`` calls, and the host time to enqueue them
    (a call whose host time nears its device time is host-bound)."""
    import torch
    fn()
    fn()
    ts, hs = [], []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        hs.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts), statistics.median(hs)


def bound_ms(n, d, b, p, mode="cosine"):
    """Least time for one sweep: the larger of the bytes the function must
    move (points and centers read once, min_in and mask read, the squared
    norms read in the euclidean modes, min_out written, the p (value,
    index) pairs written) over the memory rate and its fp32 flops over the
    CUDA-core rate."""
    norms = 4 * n if mode in ("sqeuclidean", "euclidean") else 0
    bytes_ = n * d * 4 + 9 * n + norms + b * d * 4 + p * 8
    flops = 2 * n * d * b
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def _kernel_device_ms(fn, key: str = "gmm_sweep", reps: int = 20,
                      tries: int = 3):
    """(device ms a launch, launches seen) of the kernels whose name holds
    ``key`` over ``reps`` calls of ``fn``, from a torch.profiler trace
    (CUPTI kernel records): a small sweep's CUDA-event time is the host's
    enqueue rate, not the kernel's.  A trace that missed launches is taken
    again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us, count = 0.0, 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == cuda and key in e.name]
        us, count = sum(t.end - t.start for t in spans), len(spans)
        if count == reps:
            break
    return (us / 1e3 / count if count else "not measured"), count


def sweep_cases(x, sphere, train_b4, serve_b4):
    """(label, points, metric, [(wrapper, b, p, launches in the run)]) of
    the sweep shapes phase 7 times beside the main shape: (i)'s probe at
    every (b, p) its first kernel run swept (8,196 x 5,000 cosine), (m)'s
    probe (8,192 x 3), phase 14's probe (8,192 x 2,048 euclidean; b in
    {1, 8}, p in {1, 32}) and B2 at phase 13's ``select_diverse`` pool
    (65,536 x 2,048 euclidean)."""
    from repro_torch.core.adaptive import probe_stride
    out = []
    for call, pts, metric in (("i", x, "cosine"),
                              ("m", sphere, "euclidean")):
        sub = pts[::probe_stride(pts.shape[0])]
        shapes = [(w, b, p, c) for w, _, n, _, b, p, c
                  in SWEEPS.get(call, []) if n == sub.shape[0]]
        out.append((f"({call}) probe", sub, metric, shapes))
    emb = train_b4[0][1]
    out.append(("train (r) probe", emb[::probe_stride(emb.shape[0])],
                "euclidean", [("gmm_topb", b, p, None) for b in (1, 8)
                              for p in (1, 32)]))
    out.append(("serve (p) select_diverse pool", serve_b4[0][1], "euclidean",
                [("gmm_update_select", 1, 1, None)]))
    return out


def phase_times_sweeps(cases, seed: int, errs):
    """B1/B2 at the probe-shaped sweeps and the serving pool: each shape
    first held against its plain version (``check_pair``), then the
    kernel's device ms a launch (profiler), the wrapper's ms (CUDA events;
    host-bound at these sizes), the plain version's, the bound and the
    grid the plan launches."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_topb import launch_sweep, sweep_plan
    rows = []
    for label, pts, metric, shapes in cases:
        dev = pts.device
        gen = torch.Generator(device=dev).manual_seed(seed + 5)
        prep = ops.prepare(pts, metric)
        n, d = prep.points.shape
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
        min_in = torch.full((n,), float("inf"), device=dev)
        for wrapper, b, p, launches in shapes:
            check_pair(pts, metric, b, p, gen, errs,
                       f"times {label} {n}x{d} {metric} b={b} p={p}")
            cen = prep.points[torch.randint(0, n, (b,), generator=gen,
                                            device=dev)]
            plan = sweep_plan(n, p)
            kernel_ms, traced = _kernel_device_ms(lambda: launch_sweep(
                prep.points, cen, prep.xsq, min_in, mask, mode=metric, p=p,
                bn=plan.bn))
            if wrapper == "gmm_update_select":
                kern = (lambda: ops.gmm_update_select(
                    prep.points, cen, min_in, mask, metric, xsq=prep.xsq,
                    prepared=True))
                plain = (lambda: ref.gmm_update_select_ref(
                    prep.points, cen, min_in, mask, metric, xsq=prep.xsq))
            else:
                kern = (lambda: ops.gmm_topb(
                    prep.points, cen, min_in, mask, metric, p=p,
                    xsq=prep.xsq, prepared=True))
                plain = (lambda: ref.gmm_topb_ref(
                    prep.points, cen, min_in, mask, metric, p,
                    xsq=prep.xsq))
            ms, host_ms = _time_ms(kern)
            pms, _ = _time_ms(plain)
            bms, bby = bound_ms(n, d, b, p, metric)
            rows.append({
                "kernel": wrapper, "at": label, "mode": metric, "n": n, "d": d, "b": b, "p": p,
                "launches_in_run": launches, "bn": plan.bn,
                "rows_per_block": plan.rows, "blocks": plan.blocks,
                "kernel_ms": kernel_ms, "kernel_launches_traced": traced,
                "ms": ms, "host_ms": host_ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": bby,
                "bound_share": bms / kernel_ms
                if isinstance(kernel_ms, float) else "not measured"})
        del prep
    emit({"phase": "times", "at": "probe and pool sweeps", "rows": rows})
    return rows


def phase_times(x, seed: int):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_topb import (launch_sweep, sweep_plan,
                                              tile_rows)
    n, d = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed + 2)
    prep = ops.prepare(x, "cosine")
    mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    min_in = torch.full((n,), float("inf"), device=x.device)
    rows, kerns = [], []
    for b in (1, 8):
        cen = prep.points[torch.randint(0, n, (b,), generator=gen,
                                        device=x.device)]
        for p in (1, 128):
            bn = tile_rows(p)
            bms, bby = bound_ms(n, d, b, p)
            # cen and p bound now: the second pass below calls it again
            kern = (lambda cen=cen: ops.gmm_update_select(
                prep.points, cen, min_in, mask, "cosine", prepared=True)) \
                if p == 1 else (lambda cen=cen, p=p: ops.gmm_topb(
                    prep.points, cen, min_in, mask, "cosine", p=p,
                    prepared=True))
            plain = (lambda: ref.gmm_update_select_ref(
                prep.points, cen, min_in, mask, "cosine")) if p == 1 else \
                (lambda: ref.gmm_topb_ref(prep.points, cen, min_in, mask,
                                          "cosine", p))
            sweep_only = (lambda: launch_sweep(
                prep.points, cen, None, min_in, mask, mode="cosine", p=p,
                bn=bn))
            ms, host_ms = _time_ms(kern)
            kms, _ = _time_ms(sweep_only)
            dms, _ = _kernel_device_ms(sweep_only, reps=10)
            pms, plain_host_ms = _time_ms(plain)
            plan = sweep_plan(n, p)
            rows.append({"kernel": "gmm_update_select" if p == 1
                         else "gmm_topb", "mode": "cosine", "n": n, "d": d,
                         "b": b, "p": p, "bn": bn,
                         "rows_per_block": plan.rows, "blocks": plan.blocks,
                         "ms": ms, "kernel_ms": dms,
                         "host_ms": host_ms, "launch_only_ms": kms,
                         "plain_ms": pms, "plain_host_ms": plain_host_ms,
                         "bound_ms": bms, "bound_by": bby,
                         "GBps": (n * d * 4 + 9 * n) / (ms * 1e-3) / 1e9})
            kerns.append(kern)
    # each call timed again after all of them: the phase's first window
    # follows the model phases, and its call ms alone has parted from the
    # kernel's device ms (PERF.md section 6)
    for row, kern in zip(rows, kerns):
        row["ms_second_pass"] = _time_ms(kern)[0]
    emit({"phase": "times", "rows": rows})
    return rows


def grouped_bound_ms(n, d, m, bc, p):
    """Least time for one grouped sweep: the larger of its bytes (points and
    centers read once, min_in and labels read, min_out written, the m·p
    (value, index) pairs written) over the memory rate and its own-group
    operations (2·n·bc·d, float64 on the FP64 tensor cores) over their
    rate."""
    bytes_ = n * d * 4 + 12 * n + m * bc * d * 4 + m * p * 8
    tb = bytes_ / HBM_BYTES_PER_S * 1e3
    to = 2 * n * bc * d / FP64_TC_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_times_grouped(x, labels, seed: int):
    """B4 at the main shape: 16 groups of 8 centers at p = 128 (the block
    step's pool at b = 8) and p = 1, 16 groups of one center at p = 1 (the
    sweep of call (f)), and 64 groups of 8 at p = 128.  No single PyTorch
    call fuses the own-group distance, the min and a per-group top-p, so
    there is no library time."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_update import grouped_tile_rows
    n, d = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed + 4)
    prep = ops.prepare(x, "cosine")
    min_in = torch.full((n,), float("inf"), device=x.device)
    rows = []
    for m, p, bc in ((GROUPS, 128, 8), (GROUPS, 1, 8), (GROUPS, 1, 1),
                     (64, 128, 8)):
        lab = labels if m == GROUPS else torch.randint(
            0, m, (n,), generator=gen, device=x.device, dtype=torch.int32)
        cen = prep.points[torch.randint(0, n, (m * bc,), generator=gen,
                                        device=x.device)].view(m, bc, d)
        kern = (lambda: ops.grouped_gmm_topb(prep.points, cen, min_in, lab,
                                             "cosine", p, prepared=True))
        plain = (lambda: ref.gmm_grouped_topb_ref(prep.points, cen, min_in,
                                                  lab, "cosine", p))
        ms, host_ms = _time_ms(kern)
        pms, _ = _time_ms(plain)
        bms, bby = grouped_bound_ms(n, d, m, bc, p)
        rows.append({"kernel": "gmm_grouped_topb", "mode": "cosine", "n": n,
                     "d": d, "m": m, "bc": bc, "p": p,
                     "bn": grouped_tile_rows(p), "ms": ms,
                     "host_ms": host_ms, "plain_ms": pms,
                     "library_ms": None, "bound_ms": bms, "bound_by": bby,
                     "share_of_bound": bms / ms,
                     "GBps": (n * d * 4 + 12 * n) / (ms * 1e-3) / 1e9})
    emit({"phase": "times", "rows": rows})
    return rows


def contiguous_labels(n, ell, device):
    """Reducer ids of the contiguous partition of ``n`` rows over ``ell``
    reducers (int32)."""
    import torch
    per = -(-n // ell)
    return (torch.arange(n, device=device) // per).to(torch.int32)


def round1_cases(x, sphere, genres, serving=None, mesh=()):
    """The B4 cases of ``phase_times_round1``: (where, points, mode,
    labels, m, bc, p).  The contiguous reducer shards of calls (i) (16
    groups, cosine) and (m) (16 groups, the 2^24 sphere, euclidean) at the
    lookahead sweep (bc = 8, p = 32) and the b = 1 tail (bc = 1, p = 1),
    and call (l)'s 64 reducer x genre groups; with ``serving`` (phase 9's
    (R, n, d) requests) the fused rerank's shape, m = R request groups,
    bc = 1, p = 1 over all R·n rows; then ``mesh``, the mesh path's
    sweeps (``phase_mesh``), and phase 13's (``phase_serve``)."""
    dev = x.device
    cases = [("round 1 (i)", x, "cosine", contiguous_labels(x.shape[0], 16,
                                                             dev), 16, 8, 32),
             ("round 1 (i)", x, "cosine", contiguous_labels(x.shape[0], 16,
                                                             dev), 16, 1, 1),
             ("round 1 (l)", x, "cosine",
              contiguous_labels(x.shape[0], 4, dev) * GROUPS + genres,
              4 * GROUPS, 8, 32),
             ("round 1 (m)", sphere, "euclidean",
              contiguous_labels(sphere.shape[0], 16, dev), 16, 8, 32),
             ("round 1 (m)", sphere, "euclidean",
              contiguous_labels(sphere.shape[0], 16, dev), 16, 1, 1)]
    if serving is not None:
        R, rn, rd = serving.shape
        cases.append(("serving (s)", serving.view(R * rn, rd), "cosine",
                      contiguous_labels(R * rn, R, dev), R, 1, 1))
    return cases + list(mesh)


def phase_times_round1(cases, seed: int, errs, diffs, timed: bool = True):
    """B4 at the shapes of the MapReduce round 1, simulated and on the mesh
    (``round1_cases``).  Before timing, each case's wrapper output is held
    entry for entry against its plain version (``compare_grouped``), on
    the timed inputs (min_in = inf) and with min_in straddling each row's
    own-group distance; the counts of differing entries join phase 2's B4
    cases in ``diffs``.  Beside each time: the per-group merge of the tile
    winners alone (``merge_ms``), and the tile-output slots a sweep writes
    (m x tiles x p) against the ones that hold a row of their group; the
    rest are -inf filler.  ``timed=False`` (the rehearsal) only holds the
    cases against their plain versions."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gmm_update import grouped_tile_rows
    gen = None
    rows = []
    for where, pts, mode, lab, m, bc, p in cases:
        if gen is None:
            gen = torch.Generator(device=pts.device).manual_seed(seed + 5)
        n, d = pts.shape
        prep = ops.prepare(pts, mode)
        min_in = torch.full((n,), float("inf"), device=pts.device)
        cen = prep.points[torch.randint(0, n, (m * bc,), generator=gen,
                                        device=pts.device)].view(m, bc, d)
        bn = grouped_tile_rows(p)
        tiles = -(-n // bn)
        kern = (lambda: ops.grouped_gmm_topb(prep.points, cen, min_in, lab,
                                             mode, p, xsq=prep.xsq,
                                             prepared=True))
        r_out = ref.gmm_grouped_topb_ref(prep.points, cen, min_in, lab, mode,
                                         p, xsq=prep.xsq)
        own = torch.where(torch.isinf(r_out[0]), 1.0, r_out[0])
        straddled = own * (0.5 + torch.rand((n,), generator=gen,
                                            device=pts.device))
        del own
        at = f"{where} n={n} d={d} {mode} m={m} bc={bc} p={p}"
        compare_grouped(kern(), r_out, lab, m, errs,
                        diffs["gmm_grouped_topb"], f"{at} min_in=inf")
        del r_out
        compare_grouped(
            ops.grouped_gmm_topb(prep.points, cen, straddled, lab, mode, p,
                                 xsq=prep.xsq, prepared=True),
            ref.gmm_grouped_topb_ref(prep.points, cen, straddled, lab, mode,
                                     p, xsq=prep.xsq),
            lab, m, errs, diffs["gmm_grouped_topb"],
            f"{at} min_in straddled")
        del straddled
        if not timed:
            continue
        torch.cuda.empty_cache()
        ms, host_ms = _time_ms(kern)
        tv = torch.randn((m, tiles * p), generator=gen, device=pts.device)
        ti = torch.randint(0, n, (m, tiles * p), generator=gen,
                           device=pts.device)
        merge_ms, _ = _time_ms(lambda: ref.merge_tiles_grouped(tv, ti, p))
        plain = (lambda: ref.gmm_grouped_topb_ref(prep.points, cen, min_in,
                                                  lab, mode, p,
                                                  xsq=prep.xsq))
        pms, _ = _time_ms(plain, reps=3)
        # slots holding a row of their group: min(rows of g in tile t, p)
        tile_of = torch.arange(n, device=pts.device) // bn
        per_tile = torch.bincount(tile_of * m + lab.long(),
                                  minlength=tiles * m)
        real = int(torch.clamp(per_tile, max=p).sum())
        slots = m * tiles * p
        bms, bby = grouped_bound_ms(n, d, m, bc, p)
        rows.append({"kernel": "gmm_grouped_topb", "call": where,
                     "mode": mode, "n": n, "d": d, "m": m, "bc": bc, "p": p,
                     "bn": bn, "tiles": tiles, "ms": ms, "host_ms": host_ms,
                     "merge_ms": merge_ms, "plain_ms": pms,
                     "library_ms": None, "bound_ms": bms, "bound_by": bby,
                     "share_of_bound": bms / ms, "tile_slots": slots,
                     "filler_slots": slots - real,
                     "filler_write_ms_at_hbm_rate":
                         (slots - real) * 8 / HBM_BYTES_PER_S * 1e3})
        del prep
        torch.cuda.empty_cache()
    emit({"phase": "times", "rows": rows})
    return rows


def pairwise_bound_ms(m, n, d):
    """Least time for one distance tile: its operations (2·m·n·d, run in
    float64 on the FP64 tensor cores) over their rate, 67 TFLOP/s (the
    same figure as fp32 outside the tensor cores), or its bytes (both
    inputs read once, the output written once) over the memory rate,
    whichever is larger."""
    to = 2 * m * n * d / FP64_TC_FLOPS * 1e3
    tb = ((m + n) * d + m * n) * 4 / HBM_BYTES_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_times_pairwise(tiles):
    """B3 at the streaming tile shapes: the wrapper the stream calls
    (kernel), its plain version, and for euclidean the one PyTorch call
    that computes the same function, ``torch.cdist`` with the matrix-product
    form (the library time; the port never calls it here)."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = []
    for label, x, y, mode in tiles:
        px, py = ops.prepare(x, mode), ops.prepare(y, mode)
        m, d = px.points.shape
        n = py.points.shape[0]
        kern = (lambda: ops.pairwise(px.points, py.points, mode, xsq=px.xsq,
                                     ysq=py.xsq, prepared=True))
        plain = (lambda: ref.pairwise_ref(px.points, py.points, mode,
                                          xsq=px.xsq, ysq=py.xsq))
        ms, host_ms = _time_ms(kern)
        pms, _ = _time_ms(plain, reps=3)
        lib = None
        if mode == "euclidean":
            lib, _ = _time_ms(lambda: torch.cdist(
                px.points, py.points,
                compute_mode="use_mm_for_euclid_dist"))
        bms, bby = pairwise_bound_ms(m, n, d)
        rows.append({"kernel": "pairwise", "tile": label, "mode": mode,
                     "m": m, "n": n, "d": d, "ms": ms, "host_ms": host_ms,
                     "plain_ms": pms, "library_ms": lib, "bound_ms": bms,
                     "bound_by": bby, "share_of_bound": bms / ms,
                     "gflops": 2 * m * n * d / (ms * 1e-3) / 1e9})
    emit({"phase": "times", "rows": rows})
    return rows


# --------------------------------------------------------------------------
# phase 8: where the time of one main-path call goes
# --------------------------------------------------------------------------

def phase_profile(call, name: str, out: Path, unprofiled_s: float):
    """Device-only torch.profiler trace (CUPTI kernel activity, no host-op
    recording) over one main-path call with the kernels (``call()``):
    device time by kernel name, and the device's busy share of that same
    call's wall time — the union of the device activity intervals over the
    host time from entry to the final synchronize.  The second of two
    traced calls is kept (the first pays CUPTI set-up).  ``unprofiled_s``
    (the call's median from its phase) is printed beside it to show what
    the trace itself costs the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, end = 0.0, float("-inf")
    gaps = []
    for s, e in spans:                   # union of the device intervals
        if e > end:
            if s > end > float("-inf"):
                gaps.append(s - end)
            busy_us += e - max(s, end)
            end = e
    kernels = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append({"name": e.key[:90], "ms": us / 1e3,
                        "count": e.count})
    kernels.sort(key=lambda r: -r["ms"])
    (out / f"profile_{name}.json").write_text(json.dumps(
        {"wall_s": wall, "device_busy_s": busy_us / 1e6,
         "kernels": kernels}, indent=1))
    emit({"phase": "profile", "call": name,
          "profiled_wall_s": wall, "unprofiled_median_s": unprofiled_s,
          "device_busy_s": busy_us / 1e6 if spans else "not measured",
          "device_busy_share": busy_us / 1e6 / wall if spans
          else "not measured",
          # idle gaps between device activity, inside the traced span
          "idle_gaps": {"count": len(gaps),
                        "over_50us": sum(g > 50 for g in gaps),
                        "largest_ms": max(gaps, default=0.0) / 1e3,
                        "sum_ms": sum(gaps) / 1e3},
          # device ms of the hand-written kernels (B1 and B2 share one)
          "kernel_ms": {name: sum(r["ms"] for r in kernels
                                  if key in r["name"])
                        for name, key in (("B1/B2", "gmm_sweep_kernel"),
                                          ("B3", "pairwise"),
                                          ("B4", "grouped_sweep_kernel"))},
          "top": kernels[:8]})


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 9: serving
# --------------------------------------------------------------------------

def serving_requests(R: int, n: int, d: int, seed: int, device):
    """(R, n, d) candidate embeddings made on the device from ``seed``: each
    request's candidates are its query vector plus one of 8 topic offsets
    plus noise, the shape of a retrieval server's decode group (top-n
    candidates per query at BERT-base width)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed + 11)
    out = torch.randn((R, n, d), generator=g, device=device)
    out.mul_(0.5)
    topics = torch.randn((R, 8, d), generator=g, device=device)
    which = torch.randint(0, 8, (R, n), generator=g, device=device)
    for r in range(R):            # per request: no (R, n, d) temporaries
        out[r] += topics[r, which[r]] * 0.7
    out += torch.randn((R, 1, d), generator=g, device=device)
    return out


def session_workload(S: int, rounds: int, n: int, d: int, seed: int, device):
    """rounds x S candidate batches, as ``benchmarks/bench_serving.py``
    makes them, on the device: each session draws from its own shifted
    Gaussian (centers at scale 4), so later batches land inside the
    session's certified radius and exercise the cached-slate path."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed + 13)
    centers = 4.0 * torch.randn((S, d), generator=g, device=device)
    return [[centers[s] + torch.randn((n, d), generator=g, device=device)
             for s in range(S)] for _ in range(rounds)]


def serving_data(cfg, seed: int, device):
    """Phase 9's inputs, made on the device: the (s) requests, the (s')
    requests (each later cut to its own length) and the (t) sessions'
    batches."""
    R, n, d = cfg["R"], cfg["n"], cfg["d"]
    return {"serving": serving_requests(R, n, d, seed, device),
            "serving_ragged": serving_requests(R, cfg["ragged"][1], d,
                                               seed + 1, device),
            "sessions": session_workload(cfg["S"], cfg["rounds"],
                                         cfg["batch"], d, seed, device)}


def serving_calls(full: bool):
    """Sizes of phase 9: (s)/(s') requests x candidates x d, and the
    session reranker's (t) sessions, rounds, batch rows, d, k, k'."""
    if full:
        return {"R": 256, "n": 1024, "d": 768, "k": 32, "ragged": (512, 1024),
                "S": 64, "rounds": 8, "batch": 256, "tk": 16, "tkp": 64}
    return {"R": 8, "n": 64, "d": 16, "k": 4, "ragged": (32, 64),
            "S": 6, "rounds": 4, "batch": 48, "tk": 4, "tkp": 16}


def _traced(fn):
    """Run ``fn(trace)`` under an enabled ``RunTrace`` with the kernel
    counts set to 0 just before; returns (output, seconds, launches,
    trace)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import RunTrace, activate
    tr = RunTrace(enabled=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    with activate(tr):
        out = fn(tr)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(ops.LAUNCHES), tr


def _spans(trace, name):
    out, todo = [], list(trace.spans)
    while todo:
        sp = todo.pop(0)
        if sp.name == name:
            out.append(sp)
        todo.extend(sp.children)
    return out


def _fold_launches(trace, name):
    """(folds, B4 launches) summed over the spans called ``name``."""
    sps = _spans(trace, name)
    return (sum(sp.attrs.get("folds", 0) for sp in sps),
            sum(sp.attrs.get("launches", {}).get("gmm_grouped_topb", 0)
                for sp in sps))


def _turns(call, runs: int):
    """``runs`` calls a side in turns (kernel, plain, plain, kernel, ...);
    every repeat must reproduce its side's first answer.  Returns
    {side: [(out, seconds, launches, trace), ...]}."""
    out = {"auto": [], False: []}
    for use_pallas in (["auto", False, False, "auto"] * runs)[:2 * runs]:
        out[use_pallas].append(_traced(lambda tr: call(use_pallas, tr)))
    return out


def phase_serving(data, device, check_launches: bool, runs: int = 3,
                  full: bool = True, seed: int = 0):
    """(s) the facade on an (R, n, d) tensor, cosine, remote-edge; (s')
    ``rerank_batched`` on a ragged list, euclidean; (t) the session
    reranker, S sessions x rounds of ``rerank_many``, with a byte budget of
    half the sessions' ``session_nbytes`` as a second run, and 4 sessions
    checkpointed midway, restored into a new reranker and finished there.
    Kernel and plain in turns; they must agree on every index, on radii
    and values to rtol 1e-4 and on every counter, and every fold of a
    fused run is one B4 launch.  Returns (launches of the first kernel run
    of each call, summed; seconds)."""
    import shutil

    import numpy as np
    import torch
    import repro_torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serving import (OnlineReranker, rerank_batched,
                                     session_nbytes)
    cfg = serving_calls(full)
    launches = dict.fromkeys(KERNELS, 0)
    seconds = {}

    def close(a, b):
        return bool(np.allclose(np.asarray(a, float), np.asarray(b, float),
                                rtol=RTOL_E2E, atol=0.0))

    # (s) and (s'): the stateless fused rerank
    x = data["serving"]
    g = torch.Generator().manual_seed(seed + 17)
    lo, hi = cfg["ragged"]
    sizes = torch.randint(lo, hi + 1, (cfg["R"],), generator=g).tolist()
    ragged = [data["serving_ragged"][r, :sizes[r]] for r in range(cfg["R"])]
    k = cfg["k"]
    calls = {
        "s_fused_cosine_edge": lambda up, tr: repro_torch.diversify(
            x, k=k, metric="cosine", execution=repro_torch.ExecutionSpec(
                device=device, use_pallas=up, trace=tr)),
        "s_prime_ragged_euclidean_edge": lambda up, tr: rerank_batched(
            ragged, k, metric="euclidean", use_pallas=up)}
    for name, call in calls.items():
        out = _turns(call, runs)
        (kout, _, kl, ktr), (pout, _, _, ptr) = out["auto"][0], out[False][0]
        if name.startswith("s_fused"):
            kidx, pidx = kout.indices, pout.indices
            kv, pv = kout.telemetry["values"], pout.telemetry["values"]
            kr, pr = kout.telemetry["radii"], pout.telemetry["radii"]
            reqs = int(x.shape[0])
        else:
            kidx, pidx = kout.indices, pout.indices
            kv, pv, kr, pr = kout.values, pout.values, kout.radii, pout.radii
            reqs = len(ragged)
        for side in ("auto", False):
            for o, *_ in out[side][1:]:
                if not np.array_equal(o.indices, out[side][0][0].indices):
                    fail(f"{name}: a repeated run gave another answer")
        folds, b4 = _fold_launches(ktr, "serving.rerank_batched")
        ks = [r[1] for r in out["auto"]]
        ps = [r[1] for r in out[False]]
        row = {"phase": "serving", "call": name, "requests": reqs,
               "candidates": int(x.shape[1]) if name.startswith("s_fused")
               else [min(sizes), max(sizes)], "d": int(x.shape[2]), "k": k,
               "kernel_seconds": _spread(ks), "plain_seconds": _spread(ps),
               "kernel_requests_per_s": reqs / statistics.median(ks),
               "plain_requests_per_s": reqs / statistics.median(ps),
               "folds": folds, "b4_launches": b4, "kernel_launches": kl,
               "counters": dict(ktr.counters),
               "mean_value": [float(np.mean(kv)), float(np.mean(pv))],
               "agree": {"indices": bool(np.array_equal(kidx, pidx)),
                         "radii": close(kr, pr), "values": close(kv, pv),
                         "counters": dict(ktr.counters)
                         == dict(ptr.counters)}}
        emit(row)
        bad = [c for c, ok in row["agree"].items() if not ok]
        if bad:
            fail(f"{name}: kernel and plain disagree on {bad}")
        if kidx.shape != (reqs, k) or not np.isfinite(kv).all() \
                or any(len(set(r.tolist())) != k for r in kidx):
            fail(f"{name}: not k distinct picks a request")
        if any(any(lc.values()) for _, _, lc, _ in out[False]):
            fail(f"{name}: a kernel launched on a plain run")
        if check_launches and not (b4 == folds == k
                                   and kl["gmm_grouped_topb"] == b4):
            fail(f"{name}: {b4} B4 launches for {folds} folds")
        for c, v in kl.items():
            launches[c] += v
        seconds[name] = statistics.median(ks)

    # (t): the session reranker
    work = data["sessions"]
    S, rounds = cfg["S"], cfg["rounds"]

    def sessions(up, budget=None, upto=None, keys=None):
        rr = OnlineReranker(k=cfg["tk"], dim=cfg["d"], kprime=cfg["tkp"],
                            metric="cosine", device=device, use_pallas=up,
                            memory_budget_bytes=budget)
        return rr, _session_rounds(rr, work, upto, keys)

    def call(up, tr, budget=None):
        return sessions(up, budget)

    out = _turns(call, runs)
    (krr, kres), _, kl, ktr = out["auto"][0]
    (prr, pres), _, _, ptr = out[False][0]
    per = session_nbytes(krr.store.get("s0").coreset)
    budget = S * per // 2
    ev = {up: _traced(lambda tr, up=up: call(up, tr, budget))
          for up in ("auto", False)}

    def same(a, b):
        return (np.array_equal(a.slate, b.slate) and a.reused == b.reused
                and a.cert.counts == b.cert.counts
                and close((a.cert.radius, a.cert.scale, a.cert.ratio),
                          (b.cert.radius, b.cert.scale, b.cert.ratio)))
    agree = {
        "slates_and_certificates": all(
            same(kres[r][key], pres[r][key])
            for r in range(rounds) for key in kres[r]),
        "counters": dict(ktr.counters) == dict(ptr.counters),
        "stats": krr.stats() == prr.stats(),
        "budget_stats": ev["auto"][0][0].stats() == ev[False][0][0].stats(),
        "budget_counters": dict(ev["auto"][3].counters)
        == dict(ev[False][3].counters)}
    for side in ("auto", False):
        first = out[side][0][0][1]
        for (_, again), *_ in out[side][1:]:
            if not all(np.array_equal(first[r][key].slate,
                                      again[r][key].slate)
                       for r in range(rounds) for key in first[r]):
                fail("t_sessions: a repeated run gave another answer")
    # midway checkpoint: 4 sessions saved after half the rounds, restored
    # into a new reranker that finishes their rounds
    half, keys = rounds // 2, [f"s{s}" for s in range(4)]
    tmp = ROOT / "build" / "chip_smoke_sessions"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        rr, _ = sessions("auto", upto=half)
        for key in keys:               # one checkpoint directory a session
            rr.save_session(key, CheckpointManager(f"{tmp}/{key}"), half)
        again = OnlineReranker(k=cfg["tk"], dim=cfg["d"], kprime=cfg["tkp"],
                               metric="cosine", device=device)
        if not all(again.restore_session(key, CheckpointManager(
                f"{tmp}/{key}")) for key in keys):
            fail("t_sessions: a checkpointed session did not restore")
        resumed = _session_rounds(again, work[half:], None, keys)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # a restored session has no cached slate yet, so only its first
    # answer's ``reused`` flag may differ
    agree["resumed_sessions"] = all(
        np.array_equal(resumed[r][key].slate, kres[half + r][key].slate)
        and resumed[r][key].cert == kres[half + r][key].cert
        and resumed[r][key].generation == kres[half + r][key].generation
        for r in range(rounds - half) for key in keys)
    folds, b4 = _fold_launches(ktr, "serving.solve_fused")
    ks = [r[1] for r in out["auto"]]
    ps = [r[1] for r in out[False]]
    row = {"phase": "serving", "call": "t_sessions_cosine_k16_kp64",
           "sessions": S, "rounds": rounds, "batch": cfg["batch"],
           "d": cfg["d"], "kernel_seconds": _spread(ks),
           "plain_seconds": _spread(ps),
           "kernel_seconds_per_round": statistics.median(ks) / rounds,
           "plain_seconds_per_round": statistics.median(ps) / rounds,
           "counters": {c: ktr.counters.get(c, 0) for c in (
               "coreset_reuses", "rerank_batched", "sessions_active")},
           "stats": krr.stats(), "fused_solves": len(_spans(
               ktr, "serving.solve_fused")), "folds": folds,
           "b4_launches": b4, "b3_launches": kl["pairwise"],
           "kernel_launches": kl, "session_nbytes": per,
           "budget_bytes": budget,
           "budget_evictions": ev["auto"][0][0].stats()["evictions"],
           "budget_seconds": ev["auto"][1],
           "budget_counters": {c: ev["auto"][3].counters.get(c, 0) for c in (
               "coreset_reuses", "rerank_batched", "sessions_active")},
           "agree": agree}
    emit(row)
    bad = [c for c, ok in agree.items() if not ok]
    if bad:
        fail(f"t_sessions: disagreement on {bad}")
    if any(any(lc.values()) for _, _, lc, _ in out[False]):
        fail("t_sessions: a kernel launched on a plain run")
    if check_launches and not (b4 == folds == kl["gmm_grouped_topb"] > 0
                               and kl["pairwise"] > 0):
        fail(f"t_sessions: {b4} B4 launches for {folds} folds, "
             f"{kl['pairwise']} B3 launches")
    for c, v in kl.items():
        launches[c] += v
    seconds["t_sessions"] = statistics.median(ks)
    return launches, seconds


def _session_rounds(rr, work, upto=None, keys=None):
    """Serve ``work`` (rounds x sessions batches) through ``rr.rerank_many``
    round by round (only ``keys`` if given, only the first ``upto``
    rounds); returns the per-round result dicts."""
    res = []
    for batch in work[:upto]:
        res.append(rr.rerank_many({f"s{s}": c for s, c in enumerate(batch)
                                   if keys is None or f"s{s}" in keys}))
    return res


# --------------------------------------------------------------------------
# phase 10: resilience
# --------------------------------------------------------------------------

def phase_resilience(data, device, full: bool = True):
    """MapReduce call (i) with ``trace="reducers"``, under a retry policy
    with reducer 3 failing once, and under ``on_failure="degrade"`` with
    reducer 3 lost; stream (b) killed at a chunk and resumed from its
    checkpoint.  Each runs once, on the kernel side: it is held to phase
    6's or phase 4's kernel run (equal picks, core-set and certificate).
    Returns (launches, seconds)."""
    import shutil

    import numpy as np
    import torch
    import repro_torch
    from repro_torch.distributed import (FailureInjector, InjectedFailure,
                                         ResiliencePolicy)
    launches = dict.fromkeys(KERNELS, 0)
    seconds = {}
    name, kind, problem, knobs, _, _ = mapreduce_calls(full)[0]
    base, base_idx, base_s = FIRST["mapreduce_i"]
    x = data[kind]
    ell = knobs["num_reducers"]

    def mr(tr, **extra):
        res = repro_torch.diversify(x, execution=repro_torch.ExecutionSpec(
            mode="mapreduce", device=device, trace=tr, **knobs, **extra),
            **problem)
        return res, res.indices
    variants = {
        "reducers": dict(),
        "retry": dict(resilience=ResiliencePolicy(
            on_failure="retry", injector=FailureInjector(
                fail_at=("reducer:3",)))),
        "degrade": dict(resilience=ResiliencePolicy(
            on_failure="degrade", injector=FailureInjector(
                fail_at=("reducer:3",))))}
    for var, extra in variants.items():
        (res, idx), secs, kl, _ = _traced(
            lambda tr, extra=extra, var=var: mr(
                "reducers" if var == "reducers" else True, **extra))
        tr = res.telemetry
        r1 = _spans(tr, "mr.round1")[0]
        row = {"phase": "resilience", "call": f"{name}_{var}",
               "seconds": secs, "default_seconds": base_s,
               "reducer_spans": sum(sp.name.startswith("mr.reducer[")
                                    for sp in r1.children),
               "round1_s": r1.seconds,
               "default_round1_s": _span_seconds(base.telemetry,
                                                 "mr.round1"),
               "round1_b4_launches": r1.attrs["launches"][
                   "gmm_grouped_topb"],
               "default_round1_b4_launches": _spans(
                   base.telemetry, "mr.round1")[0].attrs["launches"][
                   "gmm_grouped_topb"],
               "reducer_seconds": [sp.seconds for sp in r1.children],
               "stragglers": tr.extras.get("mr_stragglers"),
               "resilience": tr.extras.get("resilience"),
               "counters": {c: tr.counters.get(c, 0) for c in (
                   "retries", "failures_injected", "reducers_recovered")},
               "kernel_launches": kl}
        if var == "degrade":
            c = res.cert
            row.update({"degraded": c.degraded,
                        "surviving_shards": list(c.surviving_shards),
                        "points_covered": c.points_covered,
                        "points_total": c.points_total,
                        "value": [res.value, base.value]})
            ok = (c.degraded and 3 not in c.surviving_shards
                  and len(c.surviving_shards) == ell - 1
                  and c.points_covered * ell == c.points_total * (ell - 1)
                  and np.isfinite(res.solution).all())
            emit(row)
            if not ok:
                fail(f"{name}_{var}: the degraded run's certificate is "
                     f"wrong ({row})")
        else:
            agree = {
                "picks": bool(np.array_equal(res.solution, base.solution)
                              and np.array_equal(idx, base_idx)),
                "coreset": bool(torch.equal(res.coreset.points,
                                            base.coreset.points)
                                and torch.equal(res.coreset.valid,
                                                base.coreset.valid)),
                "certificate": res.cert == base.cert,
                "value": res.value == base.value,
                "reducer_spans": row["reducer_spans"] == ell}
            if var == "retry":
                agree["counters"] = row["counters"] == {
                    "retries": 1, "failures_injected": 1,
                    "reducers_recovered": 1}
            row["agree"] = agree
            emit(row)
            bad = [c for c, ok in agree.items() if not ok]
            if bad:
                fail(f"{name}_{var}: differs from phase 6's run on {bad}")
        for c, v in kl.items():
            launches[c] += v
        seconds[f"mr_i_{var}"] = secs
        if x.is_cuda:
            torch.cuda.empty_cache()

    # stream (b): killed at a chunk, resumed from its checkpoint
    sname, skind, sproblem, sknobs = stream_calls(full)[1]
    sbase, sbase_s = FIRST["stream_b"]
    every, kill = (8, 30) if full else (2, 4)
    tmp = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        def stream(tr, pol):
            src, extra = _stream_source(skind, data[skind],
                                        sknobs.get("chunk", 4096))
            return repro_torch.diversify(src, execution=repro_torch.
                                         ExecutionSpec(
                                             device=device, trace=tr,
                                             resilience=pol, **extra,
                                             **sknobs), **sproblem)
        t0 = time.perf_counter()
        try:
            stream(True, ResiliencePolicy(
                on_failure="raise", checkpoint_dir=str(tmp),
                checkpoint_every=every,
                injector=FailureInjector(fail_at=(f"chunk:{kill}",))))
            fail(f"{sname}: the injected failure at chunk {kill} did not "
                 "stop the stream")
        except InjectedFailure:
            pass
        killed_s = time.perf_counter() - t0
        res, secs, kl, _ = _traced(lambda tr: stream(tr, ResiliencePolicy(
            checkpoint_dir=str(tmp), checkpoint_every=every)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (gp, gm), (bp, bm) = _coreset_rows(res), _coreset_rows(sbase)
    kc, bc = res.cert, sbase.cert
    agree = {"coreset": bool(gp.shape == bp.shape and np.array_equal(gp, bp)
                             and (gm is None or np.array_equal(gm, bm))),
             "d_thr": float(res.coreset.radius) == float(sbase.coreset.radius),
             "phase_log": kc.counts == bc.counts and kc.radii == bc.radii,
             "certificate": kc == bc,
             "picks": bool(np.array_equal(res.solution, sbase.solution)),
             "resumed_from": res.telemetry["resilience"]["resumed_from"]
             == (kill // every) * every}
    row = {"phase": "resilience", "call": f"{sname}_kill_resume",
           "checkpoint_every": every, "killed_at_chunk": kill,
           "killed_run_seconds": killed_s, "resumed_run_seconds": secs,
           "default_seconds": sbase_s,
           "resilience": res.telemetry["resilience"],
           "checkpoints_written": res.telemetry.counters.get(
               "checkpoints_written", 0), "kernel_launches": kl,
           "agree": agree}
    emit(row)
    bad = [c for c, ok in agree.items() if not ok]
    if bad:
        fail(f"{sname}: the resumed stream differs from phase 4's on {bad}")
    for c, v in kl.items():
        launches[c] += v
    seconds["stream_b_resumed"] = secs
    return launches, seconds


# --------------------------------------------------------------------------
# phase 11: dynamic
# --------------------------------------------------------------------------

def dynamic_calls(full: bool):
    """Sizes of phase 11: (u) and (u') the churn schedule of
    ``benchmarks/bench_dynamic.py`` at catalog scale, (v) the sliding
    window over the musiXmatch stand-in, (w) the facade's kill point."""
    if full:
        return {"u": dict(n0=2 ** 20, d=8, frac=0.05, rounds=10, k=8,
                          kprime=64),
                "u_prime": dict(n0=2 ** 20, d=8, frac=0.25, rounds=6, k=8,
                                kprime=64),
                "v": dict(window=65536, step=4096, rounds=8, k=32),
                "w": dict(every=4, kill=7), "profile_rounds": 2}
    return {"u": dict(n0=2048, d=8, frac=0.05, rounds=3, k=8, kprime=64),
            "u_prime": dict(n0=2048, d=8, frac=0.25, rounds=6, k=8,
                            kprime=64),
            "v": dict(window=512, step=64, rounds=3, k=8),
            "w": dict(every=2, kill=3), "profile_rounds": 0}


def churn_schedule(n0: int, d: int, frac: float, rounds: int, seed: int,
                   device):
    """The churn script of ``benchmarks/bench_dynamic.py:33-50``, made on
    the device from ``seed``: a Gaussian x 10 boot set of ``n0`` points in
    ``d`` dimensions, then per round (delete_ids, new_points): ``frac *
    n0`` random live ids (sorted) and as many fresh points."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    boot = torch.randn((n0, d), generator=g, device=device) * 10.0
    c = max(1, int(frac * n0))
    alive = torch.ones((n0,), dtype=torch.bool, device=device)
    script = []
    for _ in range(rounds):
        live = torch.nonzero(alive).flatten()
        pick = torch.randperm(live.numel(), generator=g, device=device)[:c]
        kill = torch.sort(live[pick]).values
        alive[kill] = False
        fresh = torch.randn((c, d), generator=g, device=device) * 10.0
        alive = torch.cat([alive, torch.ones((c,), dtype=torch.bool,
                                             device=device)])
        script.append((kill, fresh))
    return boot, script


def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _field64(rows, centers, metric):
    """Each row's distance to its nearest center, in float64 on the rows
    as the sweeps read them (``ops.prepare``: cosine normalized in fp32)."""
    import torch
    from repro_torch.kernels import ops
    x = ops.prepare(rows, metric).points.double()
    c = ops.prepare(centers, metric).points.double()
    if metric == "cosine":
        d = torch.arccos(torch.clamp(x @ c.T, -1.0, 1.0))
    elif metric == "dot":
        d = -(x @ c.T)
    else:
        d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(dim=-1)
        d = torch.sqrt(d) if metric == "euclidean" else d
    return d.min(dim=1).values


def _query_partings(kq, pq, metric):
    """[round, pick, kernel id, plain id, gap] for each round whose query
    picks part between the kernel side (``kq``) and the plain side: at the
    first pick that differs, ``gap`` is the difference of the two picks'
    fields over the picks both sides made before it, in float64 (0 at an
    exact tie; ``inf`` where they part at the first pick or in length)."""
    import numpy as np
    import torch
    out = []
    for r, (a, b) in enumerate(zip(kq, pq)):
        ia, ib = np.asarray(a.ids), np.asarray(b.ids)
        if ia.shape != ib.shape:
            out.append([r, 0, None, None, float("inf")])
            continue
        if np.array_equal(ia, ib):
            continue
        j = int(np.argmax(ia != ib))
        gap = float("inf")
        if j > 0:
            f = _field64(torch.stack([a.solution[j], b.solution[j]]).cpu(),
                         a.solution[:j].cpu(), metric)
            gap = float(abs(f[0] - f[1]))
        out.append([r, j, int(ia[j]), int(ib[j]), gap])
    return out


def _agree_dynamic(ka, pa, metric):
    """Kernel run ``ka`` against plain run ``pa`` (dicts of their final
    state and per-round queries): the structure equal entry for entry,
    certificate floats within rtol 1e-5 and equal ints, and the same query
    ids every round but where the two sides part at a tie: the two picks'
    fields over the picks both made before, in float64, within the
    sweeps' parity TOL of each other (fp32 sums in another order, the
    kernel's or cuBLAS's, may order such a pair either way; the partings
    and their gaps are printed)."""
    import numpy as np
    (karr, kmeta), (parr, pmeta) = ka["state"], pa["state"]
    agree = {name: bool(karr[name].shape == parr[name].shape
                        and np.array_equal(karr[name], parr[name]))
             for name in ("center", "assign", "adist", "alive", "cover",
                          "frozen", "dirty", "radii", "points")}
    agree["meta"] = kmeta == pmeta
    agree["query_ids"] = all(
        gap <= TOL for *_, gap in _query_partings(ka["queries"],
                                                  pa["queries"], metric))
    agree["query_level"] = [q.level for q in ka["queries"]] == \
        [q.level for q in pa["queries"]]
    ok = True
    for a, b in zip(ka["queries"], pa["queries"]):
        for f, v in a.cert.to_dict().items():
            w = b.cert.to_dict()[f]
            if isinstance(v, float):
                ok &= bool(np.isclose(v, w, rtol=1e-5, atol=0.0)
                           or v == w)
            elif isinstance(v, tuple) and v and isinstance(v[0], float):
                ok &= bool(np.allclose(v, w, rtol=1e-5, atol=0.0))
            else:
                ok &= v == w
    agree["certificates"] = bool(ok)
    return agree


def _churn_run(boot, script, cfg, metric, use_pallas, device,
               windows=False):
    """One side of a churn call: a ``DynamicIndex`` booted on ``boot``,
    then per round the round's ops and one k-query.  ``script`` holds
    (delete_ids, new_points) rounds (``windows``: (new_points,
    delete_ids), insert first).  Returns the run's record and the index."""
    import numpy as np
    import torch
    from repro_torch.dynamic import DynamicIndex
    from repro_torch.kernels import ops
    idx = DynamicIndex(dim=int(boot.shape[1]), metric=metric,
                       budget=cfg.get("kprime", max(2 * cfg["k"], 64)),
                       device=device, use_pallas=use_pallas)
    rebuild_s = []
    plain_maybe = idx._maybe_rebuild

    def timed_rebuild():
        before = idx.rebuilds
        t = time.perf_counter()
        plain_maybe()
        if idx.rebuilds > before:
            _sync()
            rebuild_s.append(time.perf_counter() - t)
    idx._maybe_rebuild = timed_rebuild
    ops.reset_launches()
    _sync()
    t0 = time.perf_counter()
    idx.insert(boot)
    _sync()
    boot_s = time.perf_counter() - t0
    boot_syncs = idx.host_syncs
    rounds, queries, query_s, syncs, updates = [], [], [], [], []
    for first, second in script:
        s0 = idx.host_syncs
        t0 = time.perf_counter()
        if windows:
            idx.insert(first)
            idx.delete(second)
        else:
            idx.delete(first)
            idx.insert(second)
        _sync()
        t1 = time.perf_counter()
        q = idx.query(cfg["k"])
        _sync()
        t2 = time.perf_counter()
        rounds.append(t2 - t0)
        query_s.append(t2 - t1)
        syncs.append(idx.host_syncs - s0)
        updates.append(int(first.shape[0]) + int(second.shape[0]))
        queries.append(q)
    launches = dict(ops.LAUNCHES)
    lv = idx._levels
    counts = lv.center_counts(idx._alive).tolist()
    frozen = int(np.argmax(lv.frozen)) if lv.frozen.any() else lv.L
    rec = {"boot_s": boot_s, "boot_syncs": boot_syncs,
           "round_s": rounds, "query_s": query_s, "syncs": syncs,
           "updates_per_s": [u / s for u, s in zip(updates, rounds)],
           "rebuild_s": rebuild_s, "rebuilds": idx.rebuilds,
           "phase_log": [list(e) for e in idx.phase_log],
           "centers_per_level": counts, "active_levels": frozen,
           "radii": [float(r) for r in lv.radii],
           "launches": launches, "queries": queries,
           "state": idx.state_dict()}
    idx._maybe_rebuild = plain_maybe
    return rec, idx


def phase_dynamic(data, device, full: bool = True, seed: int = 0):
    """(u) churn at catalog scale, (u') the same at churn 0.25 with a
    rebuild, (v) a sliding window at the musiXmatch shape (cosine), each
    with its kernel side (B3 tiles, B1 query sweeps) and its plain side
    (``use_pallas=False`` on the same device), held to each other; (w) the
    facade over (u)'s ops, killed at an op and resumed, held to the
    uninterrupted facade run.  Returns (launches of the kernel sides,
    summed; seconds; what phase 8 profiles)."""
    import shutil

    import numpy as np
    import torch
    import repro_torch
    from repro_torch.distributed import (FailureInjector, InjectedFailure,
                                         ResiliencePolicy)
    from repro_torch.kernels import ops
    cfgs = dynamic_calls(full)
    launches = dict.fromkeys(KERNELS, 0)
    seconds, keep = {}, {}
    calls = {"u_churn_0.05": ("u", "euclidean"),
             "u_prime_churn_0.25": ("u_prime", "euclidean"),
             "v_window_cosine": ("v", "cosine")}
    for name, (key, metric) in calls.items():
        cfg = cfgs[key]
        if key == "v":
            x, w, st = data["mxm"], cfg["window"], cfg["step"]
            boot = x[:w]
            script = [(x[w + i * st:w + (i + 1) * st],
                       torch.arange(i * st, (i + 1) * st, device=x.device))
                      for i in range(cfg["rounds"])]
        else:
            extra = cfgs["profile_rounds"] if key == "u" else 0
            boot, script = churn_schedule(cfg["n0"], cfg["d"], cfg["frac"],
                                          cfg["rounds"] + extra, seed,
                                          device)
            if extra:
                keep["profile_script"] = script[cfg["rounds"]:]
                script = script[:cfg["rounds"]]
        _sync()
        runs = {}
        for up in ("auto", False):
            runs[up], idx = _churn_run(boot, script, cfg, metric, up, device,
                                       windows=key == "v")
            if key == "u" and up == "auto":
                keep["u_index"], keep["u_cfg"] = idx, cfg
                keep["u_ops"] = [repro_torch.Insert(boot)] + [
                    op for kill, fresh in script
                    for op in (repro_torch.Delete(kill),
                               repro_torch.Insert(fresh))]
            del idx
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        k, p = runs["auto"], runs[False]
        agree = _agree_dynamic(k, p, metric)
        kl = k["launches"]
        row = {"phase": "dynamic", "call": name, "metric": metric,
               **{c: v for c, v in cfg.items()},
               "seconds_per_round": _spread(k["round_s"]),
               "plain_seconds_per_round": _spread(p["round_s"]),
               "updates_per_s": _spread(k["updates_per_s"]),
               "boot_s": k["boot_s"], "plain_boot_s": p["boot_s"],
               "rebuild_s": k["rebuild_s"], "plain_rebuild_s": p["rebuild_s"],
               "query_s": _spread(k["query_s"]),
               "centers_per_level": k["centers_per_level"],
               "active_levels": k["active_levels"],
               "frozen_levels": len(k["radii"]) - k["active_levels"],
               "radii": k["radii"], "rebuilds": k["rebuilds"],
               "phase_log": k["phase_log"],
               "query_levels": [q.level for q in k["queries"]],
               "scale": [q.cert.scale for q in k["queries"]],
               "cover_radius": [q.cert.radius for q in k["queries"]],
               "host_syncs_per_round": _spread(k["syncs"]),
               "boot_host_syncs": k["boot_syncs"],
               "kernel_launches": kl, "plain_launches": p["launches"],
               "agree": agree,
               # [round, pick, kernel id, plain id, float64 field gap]
               "query_partings": _query_partings(k["queries"],
                                                 p["queries"], metric)}
        emit(row)
        bad = [c for c, ok in agree.items() if not ok]
        if bad:
            fail(f"dynamic {name}: kernel and plain differ on {bad}")
        if device != "cpu" and (kl["pairwise"] == 0 or kl["gmm_topb"] == 0
                                or sum(p["launches"].values())):
            fail(f"dynamic {name}: B3 {kl['pairwise']} and B1 "
                 f"{kl['gmm_topb']} launches on the kernel side, "
                 f"{p['launches']} on the plain side")
        if key == "u_prime" and k["rebuilds"] < 2:
            fail(f"dynamic {name}: no rebuild fired ({k['phase_log']})")
        for c, v in kl.items():
            launches[c] += v
        seconds[name] = statistics.median(k["round_s"])
        del runs, k, p
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # (w): the facade over (u)'s ops, killed at an op, resumed
    cfg, wcfg = cfgs["u"], cfgs["w"]
    dyn_ops = keep.pop("u_ops")
    tmp = ROOT / "build" / "chip_smoke_dynamic_checkpoints"
    shutil.rmtree(tmp, ignore_errors=True)

    def facade(pol, tr):
        return repro_torch.diversify(
            dyn_ops, k=cfg["k"], execution=repro_torch.ExecutionSpec(
                mode="dynamic", device=device, kprime=cfg["kprime"],
                resilience=pol, trace=tr))
    try:
        base, base_s, bl, _ = _traced(lambda tr: facade(None, tr))
        t0 = time.perf_counter()
        try:
            facade(ResiliencePolicy(
                on_failure="raise", checkpoint_dir=str(tmp),
                checkpoint_every=wcfg["every"], injector=FailureInjector(
                    fail_at=(f"update:{wcfg['kill']}",))), True)
            fail(f"dynamic w: the injected failure at op {wcfg['kill']} "
                 "did not stop the run")
        except InjectedFailure:
            pass
        _sync()
        killed_s = time.perf_counter() - t0
        res, secs, kl, _ = _traced(lambda tr: facade(ResiliencePolicy(
            checkpoint_dir=str(tmp), checkpoint_every=wcfg["every"]), tr))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rs = res.telemetry["resilience"]
    agree = {"solution": bool(np.array_equal(res.solution, base.solution)),
             "indices": bool(np.array_equal(res.indices, base.indices)),
             "certificate": res.cert == base.cert,
             "value": res.value == base.value,
             "coreset": bool(torch.equal(res.coreset.points,
                                         base.coreset.points)),
             "telemetry": all(res.telemetry[f] == base.telemetry[f] for f in
                              ("n_live", "updates", "rebuilds",
                               "query_level", "coreset_size")),
             "resumed_from": rs["resumed_from"]
             == (wcfg["kill"] // wcfg["every"]) * wcfg["every"]}
    row = {"phase": "dynamic", "call": "w_facade_kill_resume",
           "ops": len(dyn_ops), "checkpoint_every": wcfg["every"],
           "killed_at_op": wcfg["kill"], "uninterrupted_s": base_s,
           "killed_run_s": killed_s, "resumed_run_s": secs,
           "phases": {p["name"]: p["seconds"]
                      for p in base.telemetry.phases},
           "resilience": rs,
           "checkpoints_written": res.telemetry.counters.get(
               "checkpoints_written", 0),
           "counters": {c: base.telemetry.counters.get(c, 0) for c in (
               "inserts_absorbed", "deletes_absorbed", "level_rebuilds")},
           "kernel_launches": bl, "resumed_launches": kl, "agree": agree}
    emit(row)
    bad = [c for c, ok in agree.items() if not ok]
    if bad:
        fail(f"dynamic w: the resumed run differs from the uninterrupted "
             f"one on {bad}")
    for c, v in bl.items():
        launches[c] += v
    seconds["w_facade"] = base_s
    return launches, seconds, keep


def dynamic_round(idx, script, k):
    """A callable that applies the next round of ``script`` to ``idx`` and
    answers its query (phase 8 profiles one such round)."""
    todo = list(script)

    def call():
        kill, fresh = todo.pop(0)
        idx.delete(kill)
        idx.insert(fresh)
        return idx.query(k).solution
    return call


# --------------------------------------------------------------------------
# phase 12: the MapReduce mesh path
# --------------------------------------------------------------------------

MESH_WORLD = 4                  # ranks of call (y), sharing one card
MESH_TIMEOUT_S = 600            # the ranks' process group and every join


def mesh_sizes(full: bool):
    """(n made, rows used, d) of phase 12's stand-in: the first multiple of
    the four ranks' rows (237,662 is not divisible by 4: 237,660 rows, a
    shard 59,415 x 5,000 fp32)."""
    n, d = (237662, 5000) if full else (3000, 64)
    return n, n - n % MESH_WORLD, d


def mesh_calls(full: bool):
    """(name, problem, knobs, mesh, labelled) of the four-rank calls; mesh
    "data" is the 1-D mesh of the four ranks, "pod" the (2, 2) ('pod',
    'data') one; ``full=False`` is the rehearsal's tiny size."""
    def kk(big, small):
        return big if full else small
    return [
        ("i_cosine_edge_k128", dict(k=kk(128, 8), metric="cosine"), {},
         "data", False),
        ("j_cosine_clique_k32_kp64",
         dict(k=kk(32, 4), metric="cosine", measure="remote-clique"),
         dict(kprime=kk(64, 16)), "data", False),
        ("k_cosine_clique_three_round_k16_kp64",
         dict(k=kk(16, 4), metric="cosine", measure="remote-clique"),
         dict(kprime=kk(64, 16), three_round=True), "data", False),
        ("n_cosine_edge_recursive_k32_kp64",
         dict(k=kk(32, 4), metric="cosine"),
         dict(kprime=kk(64, 16), recursive=True), "pod", False),
        ("l_cosine_labels_k32", dict(k=kk(32, GROUPS), metric="cosine"), {},
         "data", True),
    ]


def _digest(x) -> str:
    """A fingerprint of a result field: the bytes, shape and dtype of every
    tensor or array in it, and the repr of everything else (two fields
    have one fingerprint iff they are equal entry for entry)."""
    import dataclasses
    import hashlib
    import numpy as np
    import torch
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            h.update(f"{v.shape}{v.dtype}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif dataclasses.is_dataclass(v):
            walk(dataclasses.asdict(v))
        elif isinstance(v, dict):
            for k in sorted(v):
                h.update(repr(k).encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(f"{type(v).__name__}{len(v)}".encode())
            for e in v:
                walk(e)
        else:
            h.update(repr(v).encode())
    walk(x)
    return h.hexdigest()


def _mesh_fields(sol, indices, labels, value, coreset, cert, counters):
    """The fingerprints phase 12 compares, field by field."""
    return {"picks": _digest((sol, indices, labels)), "value": repr(value),
            "union": _digest(coreset),
            "radius": None if coreset is None else
            repr(float(coreset.radius)),
            "certificate": _digest(cert), "counters": _digest(counters)}


def _mesh_run_summary(runs):
    """One rank's record of one call: the first run's fingerprints and
    launches, every run's seconds and spans; the repeats must give the
    first run's answer."""
    fields = []
    for res, idx, _, _ in runs:
        fields.append(_mesh_fields(res.solution, idx, res.labels, res.value,
                                   res.coreset, res.cert,
                                   dict(res.telemetry.counters)))
    times = []
    for res, _, secs, _ in runs:
        tr = res.telemetry
        gathers = _spans(tr, "mr.allgather")
        r1 = _find_span(tr, "mr.round1")
        times.append({
            "seconds": secs,
            "phases_s": sum(p["seconds"] for p in tr.phases),
            "probe_s": _span_seconds(tr, "mr.probe"),
            "round1_s": 0.0 if r1 is None else r1.seconds,
            "allgather_s": sum(sp.seconds for sp in gathers),
            "level2_s": _span_seconds(tr, "mr.level2"),
            "gathered_bytes": sum(sp.attrs.get("bytes", 0)
                                  for sp in gathers)})
    r1 = _find_span(runs[0][0].telemetry, "mr.round1")
    return {"fields": fields[0],
            "repeats_equal": all(f == fields[0] for f in fields),
            "times": times, "launches": runs[0][3],
            "folds": None if r1 is None else r1.attrs["folds"],
            "b4_launches": None if r1 is None
            else r1.attrs["launches"]["gmm_grouped_topb"],
            "kprime": None if r1 is None else r1.attrs["kprime"],
            "schedule": None if r1 is None else r1.attrs["schedule"],
            "coreset_size": runs[0][0].telemetry.extras.get("coreset_size")}


def _mesh_rank(rank: int, world: int, store: str, out: str, seed: int,
               full: bool):
    """One rank of call (y) (a spawned process): gloo over a ``file://``
    store, its shard of the stand-in made from ``--seed`` (as
    phase 3 makes the whole) and kept alone, then every call of
    ``mesh_calls`` three times, each after a barrier, on a DTensor of the
    shard.  Writes its record, or the exception, to ``out/rank{r}.pkl``."""
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    record = {}
    try:
        import torch
        import torch.distributed as dist
        device = "cuda" if full else "cpu"
        if full:
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        import repro_torch
        from repro_torch.kernels import build, ops
        if full:
            build.library()
        n, rows, d = mesh_sizes(full)
        per = rows // world
        x = musixmatch_like(n, d, seed, device)
        shard = x[rank * per:(rank + 1) * per].clone()
        del x
        labels = genre_labels(n, GROUPS, seed, device)[:rows].cpu().numpy()
        if full:
            torch.cuda.empty_cache()
        record["shard_sum"] = float(shard.double().sum())
        meshes = {"data": init_device_mesh(device, (world,),
                                           mesh_dim_names=("data",)),
                  "pod": init_device_mesh(device, (2, world // 2),
                                          mesh_dim_names=("pod", "data"))}
        for name, problem, knobs, kind, labelled in mesh_calls(full):
            mesh = meshes[kind]
            pts = DTensor.from_local(shard, mesh, [Shard(0)] * mesh.ndim,
                                     run_check=False)
            runs = []
            for _ in range(3 if full else 1):
                dist.barrier()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = repro_torch.diversify(
                    pts, labels=labels if labelled else None,
                    execution=repro_torch.ExecutionSpec(
                        mode="mapreduce", mesh=mesh, device=device,
                        trace=True, **knobs), **problem)
                idx = res.indices
                if full:
                    torch.cuda.synchronize()
                runs.append((res, idx, time.perf_counter() - t0,
                             dict(ops.LAUNCHES)))
            record[name] = _mesh_run_summary(runs)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(record, f)


def _recursive_expected(x, problem, knobs, world: int):
    """Call (n)'s answer built in one process from the simulated run's
    per-reducer units and one masked exact GMM a pod through the public
    ``core.gmm.gmm`` (the reference's recursive scheme): (solution,
    indices, value, union, certificate, counters), and each pod's union
    with its mask and level-2 picks (for ``check_level2``)."""
    import torch
    from repro_torch.core.coreset import Coreset
    from repro_torch.core.distributed import _resolve_reducer_plan, _sim_round1
    from repro_torch.core.gmm import gmm
    from repro_torch.core.measures import solution_value
    from repro_torch.core.sequential import solve_on_coreset
    from repro_torch.data.selection import _match_rows
    from repro_torch.obs.trace import RunTrace, activate
    k, metric = problem["k"], problem["metric"]
    per = x.shape[0] // world
    tr = RunTrace(enabled=True)
    with activate(tr):
        kp, schedule, b, cert = _resolve_reducer_plan(
            x, k, knobs["kprime"], "auto", eps=0.1, metric=metric, chunk=0,
            per_shard=per)
    units = [_sim_round1(x[r * per:(r + 1) * per], 1, k, kp, metric,
                         "plain", b, 0, schedule) for r in range(world)]
    lvl2, radii, pods = [], [], []
    for pod in range(2):
        blocks = units[pod * world // 2:(pod + 1) * world // 2]
        pod_pts = torch.cat([u[0][0] for u in blocks])
        pod_mask = torch.cat([u[1][0] for u in blocks])
        res = gmm(pod_pts, kp, metric=metric, mask=pod_mask)
        lvl2.append(pod_pts[res.idx])
        radii += [res.radius] + [u[2].max() for u in blocks]
        pods.append((pod_pts, pod_mask, res.idx))
    pts = torch.cat(lvl2)
    m = pts.shape[0]
    cs = Coreset(points=pts, valid=torch.ones((m,), dtype=torch.bool,
                                              device=pts.device),
                 weights=torch.ones((m,), dtype=torch.int32,
                                    device=pts.device),
                 radius=torch.stack(radii).max(), cert=cert)
    sol = solve_on_coreset(cs, k, problem.get("measure", "remote-edge"),
                           metric=metric)
    value = solution_value(sol, problem.get("measure", "remote-edge"),
                           metric)
    return (sol.cpu().numpy(), _match_rows(x, sol, k), None, value, cs,
            cert, dict(tr.counters)), pods


NEAR_CENTER = 0.01   # rows this close to a sweep's center: the center itself


def check_level2(pts, mask, idx, mode, errs, label):
    """B2 at the recursive scheme's level 2: every sweep of the masked
    exact GMM over a pod's union, its centers in pick order, the kernel
    against its plain version on the same inputs (each sweep's min_in is
    the kernel's previous min_out).  The max, the pick and min_out are held
    to ``TOL`` as ``check_pair`` holds B2, except min_out at the rows within
    ``NEAR_CENTER`` of the sweep's center (the center's own row): there the
    cosine distance is arccos of a dot a few ulps from 1, whose slope turns
    the last-bit difference of the kernel's fp32 dot and the plain product
    into ~1e-3 (phase 2 pushes its centers off the data for this reason).
    Those entries are counted and their largest difference returned."""
    import torch
    from repro_torch.kernels import ops, ref
    prep = ops.prepare(pts, mode)
    min_in = torch.full((pts.shape[0],), float("inf"), device=pts.device)
    near_n, near_err = 0, 0.0
    for i, c in enumerate(idx.tolist()):
        cen = prep.points[c:c + 1]
        km, ka, kx = ops.gmm_update_select(prep.points, cen, min_in, mask,
                                           mode, xsq=prep.xsq, prepared=True)
        rm, ra, rx = ref.gmm_update_select_ref(prep.points, cen, min_in,
                                               mask, mode, xsq=prep.xsq)
        near = ref.sweep_dist_ref(prep.points, cen, mode,
                                  xsq=prep.xsq)[:, 0] < NEAR_CENTER
        far = ~near
        near_n += int(near.sum())
        near_err = max(near_err, _err(km[near], rm[near]))
        masked = torch.where(mask, rm, torch.full_like(rm, float("-inf")))
        errs["gmm_update_select"] = max(errs["gmm_update_select"],
                                        _err(km[far], rm[far]), _err(kx, rx))
        if not (_close(km[far], rm[far]) and _close(kx, rx)
                and _close(ref.take(masked, ka), ref.take(masked, ra))):
            fail(f"gmm_update_select disagrees with plain at {label}, "
                 f"sweep {i}")
        min_in = km
    return {"sweeps": len(idx), "near_center_entries": near_n,
            "near_center_max_abs_err": near_err}


def sweep_shapes(schedule):
    """The (bc, p) of every sweep a reducer's grouped run makes under the
    (block, rounds) ``schedule`` (``core.gmm._schedule_select_impl``): a
    first block of b > 1 opens with a seed sweep (bc = 1); each later
    phase with a sweep of the previous phase's block; the rounds of a
    block of b fold b centers at p = 4b (p = 1 at b = 1); the final fold
    folds the last block at p = 1."""
    out = set()
    for i, (b, r) in enumerate(schedule):
        p = 4 * b if b > 1 else 1
        if i == 0 and b > 1:
            out.add((1, p))
        elif i > 0:
            out.add((schedule[i - 1][0], p))
        if r > 1:
            out.add((b, p))
    out.add((schedule[-1][0], 1))
    return sorted(out)


def _mesh_agree(got, want):
    """Field-by-field agreement of a rank's fingerprints with the expected
    run's."""
    return {f: got[f] == want[f] for f in want}


def phase_mesh(x, genres, device, seed: int, errs, diffs, full: bool = True):
    """(x) call (i)'s problem with ``mesh=`` a one-rank NCCL mesh (gloo in
    the rehearsal) against the simulated run at ``num_reducers=1``; (y) four
    gloo ranks on one card, each holding only its shard, against the
    simulated runs at ``num_reducers=4`` (contiguous) in this process, and
    call (n) against its construction from the per-reducer units.  Then
    the kernels at the shapes the mesh path gave them, each against its
    plain version: B3 at a rank's EXT/GEN delegate tiles and round-3
    columns, and B2 at every level-2 sweep of call (n) and at its pods'
    unions with centers off the data, here (``errs``, ``diffs``); B4 at every sweep shape of the ranks' and (x)'s schedules
    goes to ``phase_times_round1``.  Returns (launches summed over the
    ranks' first runs and (x)'s mesh run; per-call median seconds of the
    slowest rank; the B4 cases, ``round1_cases``'s ``mesh``)."""
    import datetime
    import pickle
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.core.distributed import _simulate_mr_impl
    from repro_torch.data.selection import _match_rows
    from repro_torch.obs.trace import RunTrace, activate
    launches = dict.fromkeys(KERNELS, 0)
    median_s = {}
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build")

    # ---- (x): one rank over NCCL, full width ----------------------------
    k = 128 if full else 8
    problem = dict(k=k, metric="cosine")
    dist.init_process_group(
        "nccl" if full else "gloo",
        init_method=f"file://{scratch}/store_x", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda" if full else "cpu", (1,),
                                mesh_dim_names=("data",))
        pts = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
        runs = [_run_mr(pts, None, problem, dict(mesh=mesh), "auto", device)
                for _ in range(2)]
    finally:
        dist.destroy_process_group()
    res, idx, _, xl = runs[0]
    warm = runs[1][0].telemetry            # the second run's spans
    tr = RunTrace(enabled=True)
    t0 = time.perf_counter()
    with activate(tr):
        sol, value, cs, _ = _simulate_mr_impl(
            x, k, "remote-edge", num_reducers=1, kprime="auto",
            metric="cosine", b="auto", eps=0.1)
    sim_idx = _match_rows(x, sol, k)
    if x.is_cuda:
        torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    got = _mesh_fields(res.solution, idx, None, res.value, res.coreset,
                       res.cert, dict(res.telemetry.counters))
    want = _mesh_fields(sol.cpu().numpy(), sim_idx, None, value, cs,
                        cs.cert, dict(tr.counters))
    gathers = _spans(warm, "mr.allgather")
    row = {"phase": "mesh", "call": "x_nccl_world1_cosine_edge_k128",
           "backend": "nccl" if full else "gloo", "ranks": 1,
           "n": int(x.shape[0]), "d": int(x.shape[1]), "problem": problem,
           "seconds": [r[2] for r in runs], "simulated_l1_seconds": sim_s,
           "probe_s": _span_seconds(warm, "mr.probe"),
           "round1_s": _span_seconds(warm, "mr.round1"),
           "allgather_s": sum(sp.seconds for sp in gathers),
           "gathered_bytes": sum(sp.attrs.get("bytes", 0) for sp in gathers),
           "launches": xl, "agree": _mesh_agree(got, want)}
    emit(row)
    if not all(row["agree"].values()):
        fail(f"mesh (x): differs from the simulated run on "
             f"{[f for f, ok in row['agree'].items() if not ok]}")
    if _mesh_fields(runs[1][0].solution, runs[1][1], None, runs[1][0].value,
                    runs[1][0].coreset, runs[1][0].cert,
                    dict(runs[1][0].telemetry.counters)) != got:
        fail("mesh (x): a repeated run gave another answer")
    for kname, v in xl.items():
        launches[kname] += v
    median_s["x"] = statistics.median(row["seconds"])
    # where -> (m, the (bc, p) of its B4 sweeps), for phase_times_round1
    b4_shapes = {"mesh (x)": (1, set(sweep_shapes(
        _find_span(res.telemetry, "mr.round1").attrs["schedule"])))}
    del runs, res, cs, sol
    if x.is_cuda:
        torch.cuda.empty_cache()

    # ---- (y): the expected runs, one process --------------------------------
    n, rows, d = mesh_sizes(full)
    xs, labels = x[:rows], genres[:rows].cpu().numpy()
    expected, sim_s = {}, {}
    for name, problem, knobs, kind, labelled in mesh_calls(full):
        t0 = time.perf_counter()
        if kind == "pod":
            (sol, sidx, slab, value, cs, cert, counters), pods = \
                _recursive_expected(xs, problem, knobs, MESH_WORLD)
        else:
            sim = {k_: v for k_, v in knobs.items() if k_ != "three_round"}
            if knobs.get("three_round"):
                sim["generalized"] = True
            res, sidx, _, _ = _run_mr(xs, labels if labelled else None,
                                      problem, dict(num_reducers=MESH_WORLD,
                                                    **sim), "auto", device)
            sol, slab, value, cs, cert = (res.solution, res.labels,
                                          res.value, res.coreset, res.cert)
            counters = dict(res.telemetry.counters)
            if knobs.get("three_round"):
                # the simulated run charges the generalized scheme's
                # multiplicity re-dispatch (the reference's model); the
                # three-round mesh run makes none
                counters["device_dispatches"] -= 1
        sim_s[name] = time.perf_counter() - t0
        expected[name] = _mesh_fields(sol, sidx, slab, value, cs, cert,
                                      counters)
    del res
    if x.is_cuda:
        torch.cuda.empty_cache()

    # ---- (y): four gloo ranks sharing the card -------------------------------
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, MESH_WORLD, f"{scratch}/store_y", scratch,
                               seed, full)) for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=30)
    spawn_s = time.perf_counter() - t0
    if hung:
        fail(f"mesh (y): ranks {hung} did not finish in {MESH_TIMEOUT_S} s")
    records = []
    for r, p in enumerate(procs):
        path = os.path.join(scratch, f"rank{r}.pkl")
        if not os.path.exists(path):
            fail(f"mesh (y): rank {r} exited {p.exitcode} with no record")
        with open(path, "rb") as f:
            records.append(pickle.load(f))
        if "error" in records[-1] or p.exitcode != 0:
            fail(f"mesh (y): rank {r} exited {p.exitcode}:\n"
                 f"{records[-1].get('error', '')}")
    want_sums = [float(xs[r * (rows // MESH_WORLD):(r + 1) * (rows // MESH_WORLD)]
                       .double().sum()) for r in range(MESH_WORLD)]
    if [rec["shard_sum"] for rec in records] != want_sums:
        fail("mesh (y): a rank's shard differs from the stand-in's rows")
    emit({"phase": "mesh", "ranks": MESH_WORLD, "backend": "gloo",
          "device": "one card shared" if full else "cpu",
          "n": rows, "d": d, "shard": [rows // MESH_WORLD, d],
          "shard_gb": rows // MESH_WORLD * d * 4 / 1e9,
          "spawn_to_join_s": spawn_s})
    for name, problem, knobs, kind, labelled in mesh_calls(full):
        recs = [rec[name] for rec in records]
        slowest = [max(rec["times"][i]["seconds"] for rec in recs)
                   for i in range(len(recs[0]["times"]))]

        def worst(key):
            return max(statistics.median(t[key] for t in rec["times"])
                       for rec in recs)
        solve = max(statistics.median(
            t["phases_s"] - t["probe_s"] - t["round1_s"] - t["allgather_s"]
            for t in rec["times"]) for rec in recs)
        agree = {f: all(rec["fields"][f] == expected[name][f]
                        for rec in recs) for f in expected[name]}
        agree["repeats"] = all(rec["repeats_equal"] for rec in recs)
        row = {"phase": "mesh", "call": name, "ranks": MESH_WORLD,
               "mesh": "(2, 2) ('pod', 'data')" if kind == "pod"
               else "(4,) ('data',)",
               "problem": problem, "knobs": knobs,
               "labels": "synthetic genres, Zipf(1), 16 groups"
               if labelled else None,
               "seconds_slowest_rank": _spread(slowest),
               "simulated_l4_seconds": sim_s[name],
               "probe_s": worst("probe_s"), "round1_s": worst("round1_s"),
               "allgather_s": worst("allgather_s"),
               "level2_s": worst("level2_s"), "solve_s": solve,
               "gathered_bytes": recs[0]["times"][0]["gathered_bytes"],
               "kprime": recs[0]["kprime"],
               "coreset_size": recs[0]["coreset_size"],
               "launches_by_rank": [rec["launches"] for rec in recs],
               "folds_by_rank": [rec["folds"] for rec in recs],
               "b4_launches_by_rank": [rec["b4_launches"] for rec in recs],
               "agree": agree}
        emit(row)
        bad = [f for f, ok in agree.items() if not ok]
        if bad:
            fail(f"mesh {name}: the ranks differ from the simulated run "
                 f"on {bad}")
        if full and row["b4_launches_by_rank"] != row["folds_by_rank"]:
            fail(f"mesh {name}: B4 launches {row['b4_launches_by_rank']} "
                 f"!= folds {row['folds_by_rank']}")
        for rec in recs:
            for kname, v in rec["launches"].items():
                launches[kname] += v
        median_s[name] = statistics.median(slowest)
        where = "mesh rank 0 shard" + (", genres" if labelled else "")
        b4_shapes.setdefault(where, (GROUPS if labelled else 1, set()))[
            1].update(sweep_shapes(recs[0]["schedule"]))
    shutil.rmtree(scratch, ignore_errors=True)

    # ---- the kernels at the mesh path's shapes, against plain ---------------
    per = rows // MESH_WORLD
    shard = xs[:per]
    kp = records[0]["j_cosine_clique_k32_kp64"]["kprime"]
    centers = shard[::per // kp][:kp]
    ch = min(4096, per)                 # the delegate pass's row chunk
    tiles = [(f"mesh EXT/GEN delegates {ch}x{kp}x{d} cosine", shard[:ch],
              centers)]
    if per % ch:
        tiles.append((f"mesh EXT/GEN delegates {per % ch}x{kp}x{d} cosine",
                      shard[per - per % ch:], centers))
    tiles.append((f"mesh round 3 {per}x1x{d} cosine", shard, centers[:1]))
    for label, a, b in tiles:
        check_pairwise(a, b, "cosine", errs, diffs["pairwise"], label)
    level2 = {}
    gen = torch.Generator(device=x.device).manual_seed(seed + 12)
    for i, (pts, mask, idx) in enumerate(pods):
        label = (f"mesh (n) level 2, pod {i}: {pts.shape[0]}x{pts.shape[1]} "
                 f"cosine")
        level2[label] = check_level2(pts, mask, idx, "cosine", errs, label)
        check_pair(pts, "cosine", 1, 1, gen, errs, f"{label}, centers off "
                   f"the data")
    emit({"phase": "mesh", "kernels_at_mesh_shapes": {
        "pairwise": {label: diffs["pairwise"][label] for label, _, _ in tiles},
        "gmm_update_select": level2,
        "gmm_grouped_topb": {f"{w} m={m} (bc, p)": sorted(sh)
                             for w, (m, sh) in b4_shapes.items()}}})
    mesh_b4 = []
    for where, (m, shapes) in b4_shapes.items():
        pts = x if where == "mesh (x)" else shard
        lab = (torch.zeros((pts.shape[0],), dtype=torch.int32,
                           device=pts.device) if m == 1
               else genres[:per].to(torch.int32))
        mesh_b4 += [(where, pts, "cosine", lab, m, bc, p)
                    for bc, p in sorted(shapes)]
    return launches, median_s, mesh_b4


# --------------------------------------------------------------------------
# phase 13: the model-backed serving path
# --------------------------------------------------------------------------

BF16_FLOPS = 989e12            # H100 SXM bf16 dense on the tensor cores
LOGITS_TOL = 2e-2              # the reference's cache-consistency bound
# atol of the bf16 cache check at the model's full depth.  Fixed from the
# readings of PERF.md section 6, PR 19 (H100 80GB HBM3, 700 W): the random
# bf16 model at 24 layers parts from itself by 0.192 between a row alone
# and in a batch of 8, and decode-from-cache parted from the full forward
# by 0.211; the reference's 2e-2 holds in fp32 (6.3e-4) and, in bf16, at a
# depth of one layer (the depth witness in phase 13).
BF16_FULL_DEPTH_ATOL = 0.4
WITNESS_DEPTHS = (1, 2, 4, 8, 16)
# (o'_vlm): the one-layer bf16 gate's atol is the larger of 2e-2 and one
# bf16 ulp (2^-7) of the layer's largest logit.  The logits are bf16
# products, and a bf16 error of the stream projects onto every logit at
# the scale of the largest: with the patches' N(0, 1) rows in the stream
# phi-3-vision's one-layer logits reach 4.4, and the first card run read
# 0.0206 at a logit of 0.0053 (5e-4 over 2e-2), the same with cuBLAS's
# reduced-precision bf16 reduction off, 0.0156 with zero patches, and the
# full forward of S - 1 tokens equal to that of S at position S - 2
# (PERF.md section 6, the vlm and ssm entry); the fp32 check holds the
# function
ONE_LAYER_ULP = 2.0 ** -7


def serve_sizes(full: bool):
    """Sizes of phase 13: the model, the engine's slots and cache, the
    requests (prompt and decode lengths), the candidate windows a request,
    the session reranker's k and k', the selection pool (examples x tokens)
    and its k and reducers, and the launcher's arguments."""
    if full:
        return {"arch": "internlm2-1.8b", "reduced": False, "batch": 8,
                "capacity": 128, "requests": 16, "prompt": 64, "new": 16,
                "windows": 1024, "window": 16, "k": 16, "kprime": 64,
                "rerank_k": 8, "pool": 65536, "pool_len": 128,
                "select_k": 64, "reducers": 16,
                "launch": ["--arch", "internlm2-1.8b", "--requests", "8",
                           "--new-tokens", "16", "--diverse-k", "4"]}
    return {"arch": "internlm2-1.8b", "reduced": True, "batch": 4,
            "capacity": 32, "requests": 8, "prompt": 8, "new": 6,
            "windows": 64, "window": 8, "k": 4, "kprime": 16,
            "rerank_k": 4, "pool": 2048, "pool_len": 16, "select_k": 8,
            "reducers": 4,
            "launch": ["--arch", "internlm2-1.8b", "--reduced", "--requests",
                       "4", "--new-tokens", "4", "--diverse-k", "2",
                       "--device", "cpu"]}


def zipf_tokens(shape, vocab: int, seed: int, device, host: bool = False):
    """Token ids with Zipf(1) frequencies over the vocabulary (natural
    text's law), each id's rank fixed by a seeded permutation, made on the
    device, or with ``host`` drawn by the host's generator (the same ids on
    every machine: two runs of the device's draws on the same card model
    gave pools whose sums differed) and moved to the device."""
    import math

    import torch
    at = "cpu" if host else device
    g = torch.Generator(device=at).manual_seed(seed)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=at)
    prob = ((1.0 / ranks) / (1.0 / ranks).sum()).float()
    ids = torch.randperm(vocab, generator=g, device=at)
    draws = torch.multinomial(prob, math.prod(shape), replacement=True,
                              generator=g)
    return ids[draws].view(*shape).to(device)


def _quiet(fn, *args, **kwargs):
    """A legacy entry point without its DeprecationWarning on stderr."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def _engine_twice(engine, requests, label: str, record=None):
    """(o): ``engine.generate(requests())`` twice, traced (inside the
    context ``record``, if given) then not, with the same tokens (else
    fails).  Returns (the first run's requests, its seconds, the untraced
    run's seconds, its trace)."""
    import contextlib

    import numpy as np
    import torch
    with record or contextlib.nullcontext():
        first, traced_s, _, tr = _traced(
            lambda tr: engine.generate(requests()))
    t0 = time.perf_counter()
    second = engine.generate(requests())
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(np.array_equal(a.out, b.out) for a, b in zip(first, second)):
        fail(f"{label}: two runs of the engine gave different tokens")
    return first, traced_s, wall, tr


def _logits(m, c, toks, pe=None):
    """The full forward's logits of ``toks`` (a vlm model's after its
    patch embeddings ``pe``; an ssm model's through the chunked scan; an
    encdec model's ``forward_train`` from the frames ``pe``)."""
    import torch
    from repro_torch.models import encdec, rglru, ssd, transformer, vlm
    with torch.no_grad():
        if c.family == "vlm":
            return vlm.forward_train(m, c, None, toks, pe)[0]
        if c.family == "ssm":
            return ssd.forward(m, c, None, toks)[0]
        if c.family == "encdec":
            return encdec.forward_train(m, c, None, pe, toks)[0]
        pos = torch.arange(toks.shape[1], dtype=torch.int32,
                           device=toks.device)
        fwd = rglru.forward if c.family == "hybrid" else transformer.forward
        return fwd(m, c, None, toks, pos)[0]


def _last_logits(m, c, toks, capacity, pe=None):
    """(the full forward's last logits, those of a prefill of S - 1 tokens
    (after a vlm model's patches ``pe``, or encoding an encdec model's
    frames ``pe``) and a decode of the S-th from the cache)."""
    import torch
    import repro_torch.models as M
    B, S = toks.shape
    P = pe.shape[1] if c.family == "vlm" else 0
    full = _logits(m, c, toks, pe)[:, -1]
    if c.family == "encdec":
        cache = M.make_cache(c, B, capacity, t_enc=pe.shape[1],
                             device=toks.device)
        batch = {"frames": pe, "dec_tokens": toks[:, :S - 1]}
    else:
        cache = M.make_cache(c, B, capacity, device=toks.device)
        batch = {"tokens": toks[:, :S - 1]}
        if pe is not None:
            batch["patch_embeds"] = pe
    _, cache = M.prefill_fn(m, c, None, batch, cache)
    step = M.decode_fn(m, c, None, toks[:, S - 1:],
                       torch.tensor(P + S - 1, device=toks.device), cache)[0]
    return full, step[:, -1]


def _excess(step, full, atol):
    err = (step - full).abs()
    return float(err.max()), bool(
        (err <= atol + LOGITS_TOL * full.abs()).all())


def _first_layers(model, cfg, depth):
    """The same weights, the model cut to ``depth`` layers: the first
    ``depth`` layers (one layer a group); a hybrid model's layout at
    ``depth`` (its first leading layers and groups); an encdec model's
    first ``depth`` encoder and decoder layers."""
    import dataclasses
    if cfg.family == "encdec":
        tree = dict(model, **{k: {n: w[:depth] for n, w in model[k].items()}
                              for k in ("encoder", "decoder")})
        return tree, dataclasses.replace(cfg, num_layers=depth,
                                         num_decoder_layers=depth)
    c = dataclasses.replace(cfg, num_layers=depth)
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import _layout
        lead, G = _layout(c)
        tree = {k: v for k, v in model.items() if k != "lead"}
        tree["groups"] = {g: {n: w[:G] for n, w in d.items()}
                          for g, d in model["groups"].items()}
        if lead:
            tree["lead"] = {n: w[:lead] for n, w in model["lead"].items()}
        return tree, c
    tree = dict(model, layers={n: w[:depth]
                               for n, w in model["layers"].items()})
    return tree, c


def _cache_consistency(model, cfg, toks, capacity, full_atol, pe=None,
                       ulp_atol: bool = False, gate_depth: int = 1,
                       fp32_depth=None):
    """(o'): prefill S - 1 tokens of ``toks`` (after a vlm model's patch
    embeddings ``pe``) and decode the S-th against the full forward: in
    fp32 (the weights upcast) at the reference's bound, in bf16 at that
    bound on the model cut to its first layer (and at the other
    ``WITNESS_DEPTHS``, printed), in bf16 at full depth within
    ``full_atol`` (None: printed, not held), each depth's error beside the
    model's own bf16 floor (a row's logits alone against in the batch).
    With ``ulp_atol`` the one-layer gate's atol is the larger of the
    reference's and one bf16 ulp of that layer's largest logit
    (``ONE_LAYER_ULP``).  ``gate_depth``: the cut the bf16 gate holds
    (default one layer); ``fp32_depth``: the cut the fp32 check runs on
    (default the full depth).  Returns (readings, ok)."""
    import dataclasses

    import torch
    from repro_torch.tree import tree_map

    def floor_of(m, c, full):
        row = _logits(m, c, toks[:1], None if pe is None else pe[:1])
        return float((row[:, -1] - full[:1]).abs().max())

    witness = []
    depths = sorted({d for d in WITNESS_DEPTHS if d < cfg.num_layers}
                    | ({gate_depth} if gate_depth < cfg.num_layers else set()))
    for depth in depths:
        m_d, c_d = _first_layers(model, cfg, depth)
        full_d, step_d = _last_logits(m_d, c_d, toks, capacity, pe)
        err_d, ok_d = _excess(step_d, full_d, LOGITS_TOL)
        ulp = ONE_LAYER_ULP * float(full_d.abs().max())
        witness.append({"layers": depth, "max_abs_err": err_d,
                        "ok_at_reference_bound": ok_d,
                        "ok_at_one_ulp_atol": _excess(
                            step_d, full_d, max(LOGITS_TOL, ulp))[1],
                        "one_ulp_of_largest": ulp,
                        "floor_row_alone_vs_batch": floor_of(m_d, c_d, full_d),
                        "logits_max_abs": float(full_d.abs().max())})
        del m_d, full_d, step_d
    full16, step16 = _last_logits(model, cfg, toks, capacity, pe)
    floor = floor_of(model, cfg, full16)
    m32, cfg32 = (model, cfg) if fp32_depth is None else _first_layers(
        model, cfg, fp32_depth)
    cfg32 = dataclasses.replace(cfg32, dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = tree_map(lambda w: w.float(), m32)
    full32, step32 = _last_logits(m32, cfg32, toks, capacity, pe)
    del m32
    err32, ok32 = _excess(step32, full32, LOGITS_TOL)
    err16, ok16 = _excess(step16, full16,
                          LOGITS_TOL if full_atol is None else full_atol)
    gate = [w for w in witness if w["layers"] == gate_depth]
    ok1 = not gate or gate[0]["ok_at_one_ulp_atol" if ulp_atol
                              else "ok_at_reference_bound"]
    S, P = toks.shape[1], pe.shape[1] if cfg.family == "vlm" else 0
    row = {"prefill": P + S - 1, "decoded_position": P + S - 1,
           "patches": P,
           "rows": int(toks.shape[0]), "vocab": cfg.vocab_size,
           "fp32": {"max_abs_err": err32, "rtol": LOGITS_TOL,
                    "atol": LOGITS_TOL, "ok": ok32,
                    "layers": cfg32.num_layers},
           "bf16": {"max_abs_err": err16, "rtol": LOGITS_TOL,
                    "atol": full_atol, "ok": ok16 if full_atol is not None
                    else "not held", "floor_row_alone_vs_batch": floor,
                    "layers": cfg.num_layers},
           "bf16_first_layers": witness,
           "one_layer_gate": "rtol 2e-2, atol max(2e-2, one bf16 ulp of "
                             "the largest logit)" if ulp_atol
                             else "rtol = atol = 2e-2",
           "gate_layers": gate_depth,
           "bf16_vs_fp32_full_max_abs": None if fp32_depth is not None
           else float((full16 - full32).abs().max()),
           "logits_max_abs": float(full16.abs().max())}
    return row, ok32 and ok1 and (ok16 or full_atol is None)


def _diverse_requests(prompts, cands, W, new, lo, hi):
    """Requests ``lo .. hi - 1``, each carrying its W candidates, one
    session a request: without a key the engine names a request by its
    index in the group (the reference's keying), and every group after the
    first would land in the first group's sessions."""
    from repro_torch.serving import Request
    return [Request(prompt=prompts[r], max_new_tokens=new,
                    session=f"req-{r}", candidates=cands[r * W:(r + 1) * W])
            for r in range(lo, hi)]


def _reranker(cfg, sz, device, use_pallas):
    from repro_torch.serving import OnlineReranker
    return OnlineReranker(k=sz["k"], dim=cfg.d_model, kprime=sz["kprime"],
                          metric="cosine", device=device,
                          use_pallas=use_pallas)


def _diverse_runs(cfg, model, requests, sz, device, check_launches: bool,
                  label: str):
    """(q): ``generate_diverse`` of ``requests`` into a fresh session
    reranker, with the kernels and with ``use_pallas=False``: equal tokens,
    slates and reuse, B3/B4 launched on the kernel run only.  Returns (the
    kernel run's requests, its launches, each side's seconds a group, the
    readings)."""
    import numpy as np
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import Request, ServingEngine

    def fresh():
        return [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        session=r.session, candidates=r.candidates)
                for r in requests]
    runs = {}
    for up in ("auto", False):
        eng = ServingEngine(cfg, launcher.RULES, model, batch=sz["batch"],
                            capacity=sz["capacity"],
                            t_enc=sz.get("t_enc", 0),
                            reranker=_reranker(cfg, sz, device, up))
        runs[up] = _traced(lambda tr: eng.generate_diverse(fresh()))
    (kout, ks, kl, ktr), (pout, ps, pl, ptr) = runs["auto"], runs[False]
    agree = {"tokens": all(np.array_equal(a.out, b.out)
                           for a, b in zip(kout, pout)),
             "slates": all(np.array_equal(a.slate, b.slate)
                           for a, b in zip(kout, pout)),
             "slate_reused": [a.slate_reused for a in kout]
             == [b.slate_reused for b in pout]}
    if check_launches and (kl["pairwise"] == 0
                           or kl["gmm_grouped_topb"] == 0):
        fail(f"{label}: the kernel run launched B3/B4 {kl}")
    if any(pl.values()):
        fail(f"{label}: the plain run launched kernels {pl}")
    if not all(agree.values()):
        fail(f"{label}: kernel and plain differ on {agree}")
    group_s = {side: [a.seconds + b.seconds for a, b in zip(
        _spans(t, "serving.generate"), _spans(t, "serving.rerank_group"))]
        for side, t in (("kernel", ktr), ("plain", ptr))}
    row = {"kernel_seconds": ks, "plain_seconds": ps,
           "rerank_group_seconds": {
               side: [sp.seconds for sp in _spans(t, "serving.rerank_group")]
               for side, t in (("kernel", ktr), ("plain", ptr))},
           "group_seconds": group_s,
           "slates_reused": sum(a.slate_reused for a in kout),
           "launches": kl, "agree": agree}
    return kout, kl, group_s, row


def _prints(t):
    """A fingerprint of drawn data: its shape, sum and first entries."""
    import torch
    t = torch.as_tensor(t)
    return {"shape": list(t.shape), "sum": int(t.long().sum()),
            "head": t.reshape(-1)[:6].tolist()}


def _serve_diverse(cfg, model, prompts, sz, seed, device, errs, diffs,
                   check_launches: bool, phase: str, call: str, card: str):
    """(q) of a model phase: ``sz["windows"]`` windows of Zipf(1) tokens a
    request, drawn on the host and embedded through the model's table, go
    with their request through ``generate_diverse`` into a session
    reranker, kernel against plain (``_diverse_runs``); B3 at the
    reranker's tile is held against plain here.  Returns (the kernel run's
    launches, the fused solve's B4 case for phase 7, one group of requests
    for phase 8's trace, each side's seconds a group)."""
    from repro_torch.data import embed_examples
    R, B, W, new = len(prompts), sz["batch"], sz["windows"], sz["new"]
    windows = zipf_tokens((R * W, sz["window"]), cfg.vocab_size, seed,
                          device, host=True)
    cands = embed_examples(windows, embedding=model["embed"],
                           dim=cfg.d_model)
    wprint = _prints(windows.cpu())
    del windows
    label = f"{phase} ({call})"
    kout, kl, group_s, row = _diverse_runs(
        cfg, model, _diverse_requests(prompts, cands, W, new, 0, R), sz,
        device, check_launches, label)
    emit({"phase": phase, "call": f"{call}_generate_diverse", "card": card,
          "requests": R, "candidates": W, "window_tokens": sz["window"],
          "windows": wprint, "d": cfg.d_model, "k": sz["k"],
          "kprime": sz["kprime"], "metric": "cosine", **row})
    cap = sz["kprime"] + 1
    tile = f"{label} reranker tile {W}x{cap}x{cfg.d_model} cosine"
    check_pairwise(cands[:W], cands[W:W + cap], "cosine", errs,
                   diffs["pairwise"], tile)
    sess = cands[:B * cap].clone()
    b4 = (f"{label} fused solve of {B} sessions", sess, "cosine",
          contiguous_labels(B * cap, B, sess.device), B, 1, 1)
    group = _diverse_requests(prompts, cands, W, new, 0, B)
    for r in group:
        r.candidates = r.candidates.clone()
    return kl, b4, group, group_s


def phase_serve(device, seed: int, errs, diffs, card: str = "",
                full: bool = True, check_launches: bool = True):
    """(o) the engine at the model's full width: random init on the device,
    R requests through ``ServingEngine.generate`` twice (traced, then not:
    the same tokens); (o') prefill S-1 tokens and decode the S-th against
    the full forward, in fp32 at the reference's bound, in bf16 at the
    reference's bound on the model cut to its first layer, and in bf16 at
    full depth within the fixed ``BF16_FULL_DEPTH_ATOL``, the bf16 error
    and the model's own bf16 floor printed at each depth; (q)
    ``generate_diverse`` with the session reranker, one session a request,
    kernel against ``use_pallas=False`` (equal tokens, slates and reuse;
    B3/B4 launched on the kernel run only), then
    ``diverse_rerank`` over the outputs; (p) a pool of examples embedded
    through the model's table and ``select_diverse`` batch (B2) and over
    reducers (round 1 on B4), three runs a side in turns with equal
    indices; then the serving launcher once.  B2 (and B1) at the pool, B3
    at the reranker's tile are held against plain here; the B4 shapes go
    to phase 7.  Returns (launches, B4 cases, what phase 8 profiles)."""
    import contextlib
    import io

    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import embed_examples, select_diverse
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import Request, ServingEngine, diverse_rerank
    sz = serve_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new = sz["requests"], sz["batch"], sz["new"]
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def count(got):
        for k, v in got.items():
            launches[k] += v

    # (o) the engine
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 19)
    prompts = [rng.integers(1, cfg.vocab_size, size=sz["prompt"])
               .astype(np.int32) for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    engine = ServingEngine(cfg, launcher.RULES, model, batch=B,
                           capacity=sz["capacity"])
    first, traced_s, wall, tr = _engine_twice(engine, requests, "serve (o)")
    n_params = M.count_params(cfg)
    prefill = [sp.seconds for sp in _spans(tr, "serving.prefill")]
    decode = [sp.seconds * 1e3 for sp in _spans(tr, "serving.decode")]
    emit({"phase": "serve", "call": "o_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "init_seconds": init_s, "requests": R, "batch": B,
          "capacity": sz["capacity"], "prompt_tokens": sz["prompt"],
          "new_tokens": new, "groups": len(prefill),
          "prefill_seconds": prefill,
          "prefill_bound_ms": 2 * n_params * B * sz["prompt"]
          / BF16_FLOPS * 1e3, "prefill_bound_by": "operations",
          "decode_ms": {"median": statistics.median(decode),
                        "min": min(decode), "max": max(decode),
                        "steps": len(decode)},
          "decode_bound_ms": n_params * 2 / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (the bf16 weights read once a step)",
          "traced_seconds": traced_s, "untraced_seconds": wall,
          "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # (o') cache consistency at full width.  The random model is chaotic in
    # bf16 at this depth: one full forward of a row alone and in the batch
    # (cuBLAS picks its kernels by the batch) part by ~0.2 in the logits.
    # So the cache path is held at the reference's bound in fp32 (the same
    # weights upcast) and in bf16 on the model cut to its first layer (the
    # witness: the error grows with depth, as the floor does), and at full
    # depth in bf16 within a fixed atol set from earlier readings.
    toks = torch.as_tensor(np.stack(prompts[:B]), device=device)
    row, ok = _cache_consistency(model, cfg, toks, sz["capacity"],
                                 BF16_FULL_DEPTH_ATOL)
    emit({"phase": "serve", "call": "o_prime_cache_consistency",
          "card": card, **row})
    if not ok:
        fail(f"serve (o'): decode from the cache disagrees with the full "
             f"forward {row}")

    # (q) serve-then-diversify
    W = sz["windows"]
    windows = zipf_tokens((R * W, sz["window"]), cfg.vocab_size, seed + 23,
                          device, host=True)
    t0 = time.perf_counter()
    cands = embed_examples(windows, embedding=model["embed"], dim=cfg.d_model)
    sync()
    cand_s = time.perf_counter() - t0
    del windows

    def diverse_requests(lo=0, hi=R):
        return _diverse_requests(prompts, cands, W, new, lo, hi)

    kout, kl, group_s, row = _diverse_runs(cfg, model, diverse_requests(),
                                           sz, device, check_launches,
                                           "serve (q)")
    count(kl)
    emit({"phase": "serve", "call": "q_generate_diverse", "card": card,
          "requests": R, "candidates": W, "window_tokens": sz["window"],
          "d": cfg.d_model, "k": sz["k"], "kprime": sz["kprime"],
          "metric": "cosine", "candidate_embed_seconds": cand_s, **row})

    outs = np.stack([r.out for r in kout])
    emb_out = embed_examples(outs, embedding=model["embed"], dim=cfg.d_model,
                             device=device)
    ops.reset_launches()
    kidx = _quiet(diverse_rerank, emb_out, sz["rerank_k"], use_pallas="auto")
    dl = dict(ops.LAUNCHES)
    pidx = _quiet(diverse_rerank, emb_out, sz["rerank_k"], use_pallas=False)
    if not np.array_equal(kidx, pidx):
        fail(f"serve (q): diverse_rerank picks differ: {kidx} / {pidx}")
    if check_launches and dl["gmm_update_select"] == 0:
        fail(f"serve (q): diverse_rerank launched no B2 {dl}")
    count(dl)
    emit({"phase": "serve", "call": "q_diverse_rerank", "card": card,
          "n": int(emb_out.shape[0]), "d": int(emb_out.shape[1]),
          "k": sz["rerank_k"], "indices": kidx.tolist(), "launches": dl,
          "agree": True})

    # (p) data selection over a pool embedded through the model's table
    N, L, K = sz["pool"], sz["pool_len"], sz["select_k"]
    pool_toks = zipf_tokens((N, L), cfg.vocab_size, seed + 29, device,
                            host=True)
    t0 = time.perf_counter()
    pool = embed_examples(pool_toks, embedding=model["embed"], dim=cfg.d_model)
    sync()
    pool_s = time.perf_counter() - t0
    del pool_toks
    emit({"phase": "serve", "call": "p_embed_pool", "card": card,
          "examples": N, "tokens": L, "d": int(pool.shape[1]),
          "pool_gb": pool.numel() * 4 / 1e9, "seconds": pool_s,
          "table_row_reads_gb": N * L * cfg.d_model * 2 / 1e9})
    for name, knobs in (("p_select_batch_b1", {}),
                        (f"p_select_mapreduce_l{sz['reducers']}",
                         {"num_reducers": sz["reducers"]})):
        out = _turns(lambda up, tr: _quiet(select_diverse, pool, K,
                                           use_pallas=up, **knobs), 3)
        first = out["auto"][0][0]
        same = all(np.array_equal(o, first) for side in out
                   for o, *_ in out[side])
        if not same:
            fail(f"serve {name}: runs or sides gave different indices")
        pl = [r[2] for r in out[False]]
        if any(any(l.values()) for l in pl):
            fail(f"serve {name}: a plain run launched kernels")
        kl = out["auto"][0][2]
        want = "gmm_grouped_topb" if knobs else "gmm_update_select"
        if check_launches and kl[want] == 0:
            fail(f"serve {name}: no {want} launch {kl}")
        count(kl)
        emit({"phase": "serve", "call": name, "card": card, "n": N,
              "d": int(pool.shape[1]), "k": K, **knobs,
              "kernel_seconds": _spread([r[1] for r in out["auto"]]),
              "plain_seconds": _spread([r[1] for r in out[False]]),
              "launches": kl, "agree": {"indices": True}})

    # the kernels at this phase's shapes, against their plain versions
    gen = torch.Generator(device=device).manual_seed(seed + 31)
    check_pair(pool, "euclidean", 1, 1, gen, errs,
               f"serve (p) pool {N}x{pool.shape[1]} euclidean b=1 p=1")
    cap = sz["kprime"] + 1
    tile = f"serve (q) reranker tile {W}x{cap}x{cfg.d_model} cosine"
    check_pairwise(cands[:W], cands[W:W + cap], "cosine", errs,
                   diffs["pairwise"], tile)
    sess = cands[:B * cap].clone()
    serve_b4 = [(f"serve (p) round 1 l={sz['reducers']}", pool, "euclidean",
                 contiguous_labels(N, sz["reducers"], pool.device),
                 sz["reducers"], 1, 1),
                (f"serve (q) fused solve of {B} sessions", sess, "cosine",
                 contiguous_labels(B * cap, B, sess.device), B, 1, 1)]
    emit({"phase": "serve", "call": "kernels_at_serve_shapes", "card": card,
          "pairwise_differing_entries": diffs["pairwise"][tile],
          "gmm_grouped_topb_cases_for_phase_7": [c[0] for c in serve_b4]})

    # the launcher, once
    ops.reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = _quiet(launcher.main, sz["launch"])
    sync()
    ll = dict(ops.LAUNCHES)
    count(ll)
    lines = buf.getvalue().splitlines()
    if len(done) != int(sz["launch"][sz["launch"].index("--requests") + 1]) \
            or not lines[-1].startswith("most diverse"):
        fail(f"serve launcher: unexpected output {lines[-3:]}")
    emit({"phase": "serve", "call": "launcher", "card": card,
          "argv": sz["launch"], "seconds": time.perf_counter() - t0,
          "requests_printed": sum(l.startswith("req ") for l in lines),
          "last_line": lines[-1], "launches": ll})
    del done

    # what phase 8 profiles: one group of (q), with a fresh reranker and
    # the model drawn again from the seed (the phases between hold none)
    group = diverse_requests(0, B)
    for r in group:
        r.candidates = r.candidates.clone()
    del cands, emb_out, model, engine

    def profile():
        again = M.init_params(cfg, seed, device=device)
        return lambda: ServingEngine(
            cfg, launcher.RULES, again, batch=B, capacity=sz["capacity"],
            reranker=_reranker(cfg, sz, device, "auto")).generate_diverse(
                [Request(prompt=r.prompt, max_new_tokens=new,
                         session=r.session, candidates=r.candidates)
                 for r in group])
    emit({"phase": "serve", "phase_seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches, serve_b4, {"profile": profile,
                                "group_s": statistics.median(
                                    group_s["kernel"])}


# --------------------------------------------------------------------------
# phase 14: dense-model training on diversity-curated data
# --------------------------------------------------------------------------

TRAIN_LR = 3e-4                # (z): constant lr of the steps
# (z): accumulation against one batch at the reference test's bounds (rtol
# 2e-2, atol 2e-3).  Adam's first step moves every entry by +-lr whatever
# its gradient's size, so an entry whose bf16 gradient changes sign with
# the micro-batching parts by 2 lr (and a bf16 rounding): the reference
# test's lr 1e-3 puts that at the atol itself; 5e-4 keeps it inside
ACCUM_LR = 5e-4
# (z): so the params cannot witness the accumulation; the gradients the
# step hands its optimizer do.  accum_steps=2 against one batch, the
# largest per-leaf relative Frobenius error, fp32 (the weights upcast) and
# bf16 (as trained), each within its limit; the control, a step that drops
# the second micro-batch, must read above it.  The limits sit between the
# sound readings (fp32 5.5e-3, bf16 2.2e-2) and the control's (0.84) of
# the training slice's card runs (PERF.md section 6)
ACCUM_GRAD_RTOL = {"fp32": 5e-2, "bf16": 0.2}
# (z_moe): the MoE model's routing is discontinuous, and at full width the
# random model carries fp32 rounding through 24 layers far enough that the
# one-batch and the micro-batched forwards can route a token apart at a
# near-tie (the first card run read fp32 6.8e-2 against 5e-2, bf16 2.4e-2).
# So the witness there is float64 (rounding ~1e-16, nothing parts), held
# at ACCUM_GRAD_RTOL_F64, and bf16 (as trained) at the bf16 limit; fp32 is
# held at its limit when its routings do not part, and otherwise printed
# with the partings, each a proven near-tie
ACCUM_GRAD_RTOL_F64 = 1e-6
ADAMW_BYTES_PER_PARAM = 28     # grad bf16 2 + master, mu, nu read 12 and
                               # written 12 + param bf16 written 2
# (z'): the float64 model (the weights upcast) is the witness's reference.
# Its autograd gradient is held to the central difference of its loss at
# step FD_EPS along a random unit direction d of the whole tree and along
# one random unit direction in each block (the embedding, each layer group,
# the final norm, the head), the error over the spread of <grad, d> across
# random unit directions, |grad| / sqrt(params) of the tree or the block (a
# quotient by <grad, d> itself, a draw near 0 at random, does not measure
# the gradient), within FD64_RTOL (the training slice's card runs read
# 4.9e-7-1.1e-5).  The fp32 gradient is held to the float64 one block by
# block, the relative Frobenius error rho within GRAD32_RTOL (read 3.6e-3
# -8.4e-3, the largest at the embedding), and to the same central
# difference along d within FD_RTOL.  One random direction reads a gradient
# error e as |z| |e| / |grad| (z a standard normal): for the fp32 rounding
# that is |z| rho, read 5.5e-4-1.7e-2 (|z| up to 3.5) over the batches the
# card runs drew, so FD_RTOL is GRAD32_RTOL, ~6 times the largest rho; and
# it cannot tell a fault of ~1 % of the gradient's norm, such as layer
# group 0's part doubled, from fp32's own error (the embedding holds
# 99.99 % of the norm), so the planted faults are read block by block
# (PERF.md section 6).  At
# full width the fp32 loss's own central difference parted from <grad, d>
# by 0.20-0.64 (its rounding noise against the curvature); the float64
# one's truncation is ~9e3 eps^2 (9e-5 of <grad, d> at 1e-4)
FD_EPS = 1e-5
FD_RTOL = 5e-2
FD64_RTOL = 1e-4
GRAD32_RTOL = 5e-2
FD_WITNESS_EPS = (1e-4, 1e-3)


def train_sizes(full: bool):
    """Sizes of phase 14: the model, the pool (examples x tokens), the
    curation's k, reducers and k', the batch and steps of (z), and the
    launcher's arguments."""
    if full:
        return {"arch": "internlm2-1.8b", "reduced": False, "pool": 65536,
                "pool_len": 129, "k": 1024, "reducers": 16, "kprime": 128,
                "batch": 8, "steps": 6, "resume_batch": 4,
                "resume_seq": 16,
                "launch": ["--arch", "internlm2-1.8b", "--steps", "4",
                           "--batch", "8", "--seq", "128"]}
    return {"arch": "internlm2-1.8b", "reduced": True, "pool": 2048,
            "pool_len": 17, "k": 64, "reducers": 4, "kprime": 32,
            "batch": 4, "steps": 12, "resume_batch": 4, "resume_seq": 16,
            "launch": ["--arch", "internlm2-1.8b", "--reduced", "--device",
                       "cpu", "--steps", "2", "--batch", "4", "--seq",
                       "16"]}


class _Marks:
    """Device-time marks of one step: CUDA events on the card, the host
    clock after a synchronize elsewhere (the rehearsal)."""

    def __init__(self, device):
        import torch
        self.cuda = device == "cuda"
        self._torch = torch

    def mark(self):
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3


class _TimedUpdate:
    """An optimizer whose ``update`` is bracketed by marks (the split of a
    step into its gradients and its update)."""

    def __init__(self, opt, marks):
        self.opt, self.marks, self.spans = opt, marks, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr):
        a = self.marks.mark()
        out = self.opt.update(grads, state, params, lr)
        self.spans.append((a, self.marks.mark()))
        return out


def _as_dtype(tree, dt):
    """``tree``'s weights in ``dt``, but for a float32 leaf (the MoE
    router, built in float32) when ``dt`` is narrower: the model as the
    config of that dtype builds it."""
    import torch
    from repro_torch.tree import tree_map
    keep = dt in (torch.bfloat16, torch.float16)
    return tree_map(lambda t: t if keep and t.dtype == torch.float32
                    else t.to(dt), tree)


def _tree_numel(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def train_bounds(cfg, batch: int, seq: int, t_enc: int = 0):
    """(step operations bound ms, its parts, update bytes bound ms) of one
    AdamW step of ``cfg`` on ``batch`` rows of ``seq`` tokens, from the
    code's arithmetic, every product x3 for the backward (forward 2,
    backward 4 operations a weight and token): the layers' matrix products
    in bf16 (an expert's weights count topk / E of their size, the share
    of the tokens each sees; a vlm model's patch projection over its
    patches); a transformer's attention score and context products in fp32
    (both operands upcast in ``attention.attend``; every (query, key) pair
    computed, masked or not) over the patches and tokens; an ssm model's
    chunked scan in fp32 (``ssd.ssd_chunked``: 2 l n + 2 h l p + 4 h p n
    a layer and token for chunk l); ``lm_head``'s bf16 product over every
    position (6 T D V); the update's bytes, 28 a parameter, over the
    memory rate.  For an MoE model the parts also give the experts'
    capacity-padded rows (E C, every row of which the batched products
    compute) against the assignments (T topk), and those padded products'
    own time at the bf16 rate.  The hybrid and encdec families:
    ``_family_train_bounds`` (an encdec model's ``t_enc`` frames)."""
    import repro_torch.models as M
    from repro_torch.models.moe import capacity
    from repro_torch.tree import tree_items
    if cfg.family in ("hybrid", "encdec"):
        return _family_train_bounds(cfg, batch, seq, t_enc)
    P = cfg.num_patches if cfg.family == "vlm" else 0
    S = P + seq
    T = batch * S
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    shapes = M.param_shapes(cfg)
    mats = active = 0
    for name, t in tree_items(shapes["layers"]):
        if t.ndim > 3 or name in ("['in_proj']", "['out_proj']"):
            mats += t.numel()
            expert = any(e in name for e in ("e_gate", "e_up", "e_down"))
            active += t.numel() * (topk / E if expert else 1)
    layers_ms = 6 * active * T / BF16_FLOPS * 1e3
    parts = {"layer_matrix_params": mats,
             "active_layer_matrix_params": active,
             "layer_products_bf16_ms": layers_ms}
    ops_ms = layers_ms
    if cfg.family == "ssm":
        l = min(cfg.ssm_chunk, S)
        while S % l:
            l -= 1
        h, p_, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        per = 2 * l * n + 2 * h * l * p_ + 4 * h * p_ * n
        parts["ssd_scan_fp32_ms"] = (3 * per * T * cfg.num_layers
                                     / FP32_FLOPS * 1e3)
        parts["ssd_chunk"] = l
        ops_ms += parts["ssd_scan_fp32_ms"]
    else:
        parts["attention_fp32_ms"] = (3 * 4 * batch * cfg.num_heads * S * S
                                      * cfg.head_dim * cfg.num_layers
                                      / FP32_FLOPS * 1e3)
        ops_ms += parts["attention_fp32_ms"]
    if P:
        parts["patch_proj_bf16_ms"] = (6 * batch * P * shapes["patch_proj"]
                                       .numel() / BF16_FLOPS * 1e3)
        ops_ms += parts["patch_proj_bf16_ms"]
    parts["lm_head_bf16_ms"] = (6 * T * cfg.d_model * cfg.vocab_size
                                / BF16_FLOPS * 1e3)
    ops_ms += parts["lm_head_bf16_ms"]
    if E:
        C = capacity(cfg, T)
        parts.update({
            "expert_rows_padded": E * C, "expert_assignments": T * topk,
            "expert_products_padded_ms": 6 * 3 * E * C * cfg.d_model
            * cfg.d_ff * cfg.num_layers / BF16_FLOPS * 1e3})
    n_params = M.count_params(cfg)
    return (ops_ms, parts,
            ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3)


def _family_train_bounds(cfg, batch: int, seq: int, t_enc: int = 0):
    """``train_bounds`` of the hybrid and encdec families, counted by
    family (neither has a ``layers`` subtree): every matrix leaf 6 x its
    params x the positions it sees (an encdec model's encoder and cross
    K/V projections the frames, the rest the tokens; the hybrid's conv,
    gains and norms are elementwise); the attention products in fp32 over
    every (query, key) pair the code computes (the hybrid's local
    attention over the whole sequence a chunk, the window masked, once an
    attention layer; encdec's encoder self T_enc², decoder self S² and
    cross S T_enc); ``lm_head`` over the tokens; the hybrid's RG-LRU scan
    is elementwise, so its bytes are printed beside the rest (a and b
    read, h written, fp32, forward and backward x3) and its time at the
    memory rate; the update's bytes, 28 a parameter."""
    import repro_torch.models as M
    from repro_torch.tree import tree_items
    shapes = M.param_shapes(cfg)
    T = batch * seq
    H, hd = cfg.num_heads, cfg.head_dim
    parts = {}
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import _layout
        lead, G = _layout(cfg)
        sub = {k: v for k, v in shapes.items() if k in ("lead", "groups")}
        mats = sum(t.numel() for n, t in tree_items(sub)
                   if t.ndim > 2 and "conv_w" not in n)
        parts["layer_matrix_params"] = mats
        parts["layer_products_bf16_ms"] = 6 * mats * T / BF16_FLOPS * 1e3
        parts["attention_fp32_ms"] = (3 * 4 * batch * H * seq * seq * hd * G
                                      / FP32_FLOPS * 1e3)
        parts["attention_layers"] = G
        n_rec, R = lead + 2 * G, cfg.rnn_width or cfg.d_model
        parts["rg_lru_scan_bytes"] = 3 * 12 * T * R * n_rec
        parts["rg_lru_scan_bytes_ms"] = (parts["rg_lru_scan_bytes"]
                                         / HBM_BYTES_PER_S * 1e3)
        ops_ms = (parts["layer_products_bf16_ms"]
                  + parts["attention_fp32_ms"])
    else:
        Tf = batch * t_enc
        enc = sum(t.numel() for _, t in tree_items(shapes["encoder"])
                  if t.ndim > 2)
        cross = sum(shapes["decoder"][k].numel() for k in ("xk", "xv"))
        dec = sum(t.numel() for _, t in tree_items(shapes["decoder"])
                  if t.ndim > 2) - cross
        parts.update({"encoder_matrix_params": enc,
                      "decoder_matrix_params": dec,
                      "cross_kv_matrix_params": cross,
                      "layer_products_bf16_ms": 6 * (enc * Tf + cross * Tf
                                                     + dec * T)
                      / BF16_FLOPS * 1e3})
        Le, Ld = cfg.num_layers, cfg.num_decoder_layers or cfg.num_layers
        parts["attention_fp32_ms"] = (
            3 * 4 * batch * H * hd * (Le * t_enc * t_enc + Ld * (
                seq * seq + seq * t_enc)) / FP32_FLOPS * 1e3)
        ops_ms = (parts["layer_products_bf16_ms"]
                  + parts["attention_fp32_ms"])
    parts["lm_head_bf16_ms"] = (6 * T * cfg.d_model * cfg.vocab_size
                                / BF16_FLOPS * 1e3)
    ops_ms += parts["lm_head_bf16_ms"]
    return (ops_ms, parts,
            ADAMW_BYTES_PER_PARAM * M.count_params(cfg) / HBM_BYTES_PER_S
            * 1e3)


class _GradProbe:
    """An optimizer that hands the gradients a train step computes to
    ``see`` and changes nothing."""

    def __init__(self, see):
        self.see = see

    def init(self, params):
        return ()

    def update(self, grads, state, params, lr):
        self.see(grads)
        return params, state


def _accum_witness(cfg, tree, batch, dtypes=None):
    """The gradient ``make_train_step`` with ``accum_steps=2`` hands its
    optimizer against the one-batch gradient, and the control (a step that
    drops the second micro-batch: the first one's gradient alone) against
    it, by each leaf's relative Frobenius error; on ``tree``'s weights in
    each of ``dtypes`` ((name, dtype) pairs; default fp32, the weights
    upcast, and the config's bf16).  Returns {name: {"accum": [per leaf],
    "control": [per leaf]}}."""
    import dataclasses

    import torch
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves
    first = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    out = {}
    for name, dt in dtypes or (("fp32", torch.float32), ("bf16", cfg.dtype)):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        w = _as_dtype(tree, dt)
        one, res = [], {}
        wide = torch.float64 if dt == torch.float64 else torch.float32

        def keep(g):
            one.extend(x.detach().to(wide, copy=True)
                       for x in tree_leaves(g))

        def against(key):
            def see(g):
                res[key] = [float(torch.linalg.vector_norm(x.to(wide) - r)
                                  / torch.linalg.vector_norm(r))
                            for x, r in zip(tree_leaves(g), one)]
            return see

        for see, accum, b in ((keep, 1, batch), (against("accum"), 2, batch),
                              (against("control"), 1, first)):
            make_train_step(c, None, _GradProbe(see), lambda s: 0.0,
                            accum_steps=accum)(w, (), b, 0)
        out[name] = res
        del w, one
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _blocks(tree):
    """The witness's blocks of a parameter tree, as (name, tensors): each
    top-level leaf (embed, final_norm, head) and each layer group i of a
    stacked subtree (``layers``; a hybrid model's ``groups`` and ``lead``;
    an encdec model's ``encoder`` and ``decoder``): every leaf's slice
    [i]."""
    from repro_torch.tree import tree_leaves
    out = [(k, [v]) for k, v in tree.items() if not isinstance(v, dict)]
    for k, v in tree.items():
        if isinstance(v, dict):
            leaves = tree_leaves(v)
            out += [(f"{k}[{g}]", [t[g] for t in leaves])
                    for g in range(leaves[0].shape[0])]
    return out


def _layer0(names):
    """The block of the first layer group (``layers[0]``, or the first
    stacked subtree's)."""
    return "layers[0]" if "layers[0]" in names else next(
        n for n in names if n.endswith("[0]"))


def _unit(shapes, seed: int, dev, dtype):
    """A random unit direction over tensors of ``shapes`` (float64 normal
    draws, seeded, normalized in float64, held in ``dtype``)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = [torch.randn(s, generator=gen, dtype=torch.float64, device=dev)
         for s in shapes]
    norm = torch.sqrt(sum((x * x).sum() for x in d))
    return [x.div_(norm).to(dtype) for x in d]


def _dot(gs, ds):
    return float(sum((g.double() * x).sum() for g, x in zip(gs, ds)))


def _gradient_witness(cfg, tree, batch, eps_list, seed: int,
                      block_eps=FD_EPS):
    """The gradient witness on ``tree``'s weights.  The float64 model (the
    weights upcast): its loss's central difference (L(w + eps d) -
    L(w - eps d)) / (2 eps) along a random unit direction d of the whole
    tree at each step in ``eps_list``, and along one random unit direction
    of each block at ``block_eps`` (a step, or a function of the block's
    share of the gradient's norm giving it); its autograd gradient's <grad, d> along each.
    The difference is taken in float64 because the fp32 loss of the random
    model at full width is itself noisy: fp32 rounding, amplified through
    the layers, moves it by ~1e-3 between two nearby weights, as much as
    eps <grad, d> at any eps where the loss is still near-linear.  Then the
    fp32 and bf16 models' gradients: <grad, d>, and each block's relative
    Frobenius error against the float64 gradient.  Planted faults go
    through the block comparisons: layer group 0's part doubled (in the
    float64 gradient against its central difference, in the fp32 gradient
    against the float64 one), and the bf16 gradient in place of the fp32
    one.  Returns a dict of the readings."""
    import dataclasses

    import torch
    from repro_torch.train import make_loss
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.train.step import _value_and_grad
    dev = tree_leaves(tree)[0].device
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = tree_map(lambda t: torch.randn(t.shape, generator=gen, dtype=f64,
                                       device=dev).float(), tree)
    norm = torch.sqrt(sum((x.double() ** 2).sum() for x in tree_leaves(d)))
    tree_map(lambda x: x.div_(norm), d)
    names = [n for n, _ in _blocks(tree)]
    l0 = _layer0(names)
    n_block = {n: sum(t.numel() for t in ts) for n, ts in _blocks(tree)}
    c = dataclasses.replace(cfg, dtype=f64, param_dtype=f64)
    loss_fn = make_loss(c, None)
    w = tree_map(lambda t: t.to(f64), tree)
    _, g64 = _value_and_grad(loss_fn, w, batch)
    gb64 = dict(_blocks(g64))
    norm64 = {n: float(torch.sqrt(sum((x * x).sum() for x in gs)))
              for n, gs in gb64.items()}
    gnorm = sum(v * v for v in norm64.values()) ** 0.5
    bdir = {n: seed + 1 + i for i, n in enumerate(names)}
    bdot = {n: _dot(gb64[n], _unit([x.shape for x in gb64[n]], bdir[n], dev,
                                   f64)) for n in names}
    dots = {"float64": _dot(tree_leaves(g64), tree_leaves(d))}
    fd, bfd, beps = {}, {}, {}
    with torch.no_grad():
        def central(ws, ds, eps):
            vals = []
            for step in (eps, -2 * eps):
                for t, x in zip(ws, ds):
                    t.add_(x, alpha=step)
                vals.append(float(loss_fn(w, batch)))
            for t, x in zip(ws, ds):
                t.add_(x, alpha=eps)
            return (vals[0] - vals[1]) / (2 * eps)

        for eps in eps_list:
            fd[eps] = central(tree_leaves(w), tree_leaves(d), eps)
        for n, ws in _blocks(w):
            beps[n] = block_eps(norm64[n] / gnorm) if callable(block_eps) \
                else block_eps
            bfd[n] = central(ws, _unit([x.shape for x in ws], bdir[n], dev,
                                       f64), beps[n])
    del w
    bspread = {n: norm64[n] / n_block[n] ** 0.5 for n in names}
    out = {"gnorm": gnorm, "block_norm_share": {n: norm64[n] / gnorm
                                                for n in names},
           "fd": fd, "block_err": {n: abs(bdot[n] - bfd[n]) / bspread[n]
                                   for n in names},
           "planted_block": l0, "block_eps": beps,
           "planted_block_err": {"float64_layer_0_doubled":
                                 abs(2 * bdot[l0] - bfd[l0]) / bspread[l0]},
           "frob": {}}
    for name, dt in (("fp32", torch.float32), ("bf16", cfg.dtype)):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        w = _as_dtype(tree, dt)
        loss, g = _value_and_grad(make_loss(c, None), w, batch)
        del w
        dots[name] = _dot(tree_leaves(g), tree_leaves(d))

        def frob(n, gs, scale0=1.0):
            num = sum(float(((x.double() * scale0 - r) ** 2).sum())
                      for x, r in zip(gs, gb64[n]))
            return num ** 0.5 / norm64[n]

        gb = dict(_blocks(g))
        out["frob"][name] = {n: frob(n, gb[n]) for n in names}
        if name == "fp32":
            out["loss"] = float(loss)
            out["planted_block_err"]["fp32_layer_0_doubled"] = frob(
                l0, gb[l0], 2.0)
            out["planted_dot_layer_0_doubled"] = dots["fp32"] + _dot(
                gb[l0], dict(_blocks(d))[l0])
        del g, gb
    out["planted_block_err"]["bf16_gradient"] = max(
        out["frob"]["bf16"].values())
    out["dots"] = dots
    return out


def _adamw_steps(cfg, params, batch, steps: int, device):
    """(z): ``steps`` AdamW steps at the constant ``TRAIN_LR`` on one
    fixed batch, the params updated in place (their tree is released
    after).  Returns (losses, step ms, gradient ms, update ms, peak
    allocated GB, GB allocated before the optimizer state), each ms by
    CUDA events on the card."""
    import torch
    from repro_torch.launch import train as launcher
    from repro_torch.train import AdamW, make_train_step
    cuda = device == "cuda"
    marks = _Marks(device)
    opt = _TimedUpdate(AdamW(), marks)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9 if cuda else None
    state = opt.init(params)
    step = make_train_step(cfg, launcher.RULES, opt, lambda s: TRAIN_LR)
    losses, step_ms, grad_ms, upd_ms = [], [], [], []
    for i in range(steps):
        a = marks.mark()
        params, state, m = step(params, state, batch, i)
        b = marks.mark()
        if cuda:
            torch.cuda.synchronize()
        u0, u1 = opt.spans[-1]
        step_ms.append(marks.ms(a, b))
        grad_ms.append(marks.ms(a, u0))
        upd_ms.append(marks.ms(u0, u1))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del state, opt, m
    return losses, step_ms, grad_ms, upd_ms, peak, held


def _curate(cfg, params, sz, seed, device, errs, check_launches: bool,
            label: str):
    """(r): a pool of Zipf(1) token sequences drawn on the host, embedded
    through the model's table, then the k most diverse over simulated
    reducers (the probe on B1, round 1 on B4), with the kernels and with
    ``use_pallas=False`` (equal indices); B1 (and B2) at the probe's
    subsample held against plain here.  Returns (the curated rows of
    tokens, the kernel run's launches, B4's round-1 cases for phase 7, the
    readings)."""
    import numpy as np
    import torch
    from repro_torch.core.adaptive import probe_stride
    from repro_torch.data import embed_examples
    cuda = device == "cuda"
    N, L = sz["pool"], sz["pool_len"]
    pool_toks = zipf_tokens((N, L), cfg.vocab_size, seed + 37, device,
                            host=True)
    t0 = time.perf_counter()
    emb = embed_examples(pool_toks[:, :L - 1], embedding=params["embed"],
                         dim=cfg.d_model)
    if cuda:
        torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    problem = {"k": sz["k"], "measure": "remote-edge"}
    knobs = {"num_reducers": sz["reducers"], "kprime": sz["kprime"]}
    runs = {up: _run_mr(emb, None, problem, knobs, up, device)
            for up in ("auto", False)}
    (kres, kidx, ks, kl), (pres, pidx, ps, pl) = runs["auto"], runs[False]
    if not np.array_equal(kidx, pidx):
        fail(f"{label}: the kernels and use_pallas=False curated "
             "different rows")
    if any(pl.values()):
        fail(f"{label}: the plain run launched kernels {pl}")
    if check_launches and (kl["gmm_topb"] == 0
                           or kl["gmm_grouped_topb"] == 0):
        fail(f"{label}: the curation launched no B1 or no B4 {kl}")
    r1 = _find_span(kres.telemetry, "mr.round1")
    shapes = sweep_shapes(r1.attrs["schedule"])
    if check_launches and r1.attrs["launches"]["gmm_grouped_topb"] \
            != r1.attrs["folds"]:
        fail(f"{label}: round 1 made {r1.attrs['launches']} launches "
             f"for {r1.attrs['folds']} folds")
    stride = probe_stride(N)
    sub = emb[::stride].contiguous()
    gen = torch.Generator(device=device).manual_seed(seed + 41)
    for bc, p in shapes:
        check_pair(sub, "euclidean", bc, p, gen, errs,
                   f"{label} probe {sub.shape[0]}x{sub.shape[1]} "
                   f"euclidean b={bc} p={p}")
    b4 = [(f"{label} round 1 l={sz['reducers']}", emb, "euclidean",
           contiguous_labels(N, sz["reducers"], emb.device),
           sz["reducers"], bc, p) for bc, p in shapes]
    curated = pool_toks[torch.as_tensor(kidx, device=pool_toks.device)]
    # fingerprints of the data, to compare runs
    prints = {"embed_table_sum": float(params["embed"].double().sum()),
              "pool_tokens_sum": int(pool_toks.sum()),
              "embedding_sum": float(emb.double().sum()),
              "indices_sum": int(np.asarray(kidx).sum()),
              "indices_head": np.asarray(kidx)[:8].tolist()}
    if cuda:
        prints["multiprocessors"] = torch.cuda.get_device_properties(
            0).multi_processor_count
    row = {**prints, "arch": cfg.arch, "pool": N, "tokens": L,
           "d": int(emb.shape[1]), "pool_gb": emb.numel() * 4 / 1e9,
           "embed_seconds": embed_s, **problem, **knobs,
           "kernel_seconds": ks, "plain_seconds": ps,
           "probe_seconds": _span_seconds(kres.telemetry, "mr.probe"),
           "round1_seconds": r1.seconds, "schedule": r1.attrs["schedule"],
           "round1_sweeps": r1.attrs["folds"],
           "round1_launches": r1.attrs["launches"],
           "probe_rows": int(sub.shape[0]), "sweep_shapes": shapes,
           "curated": int(len(kidx)), "launches": kl,
           "agree": {"indices": True},
           "held_against_plain": {"gmm_topb_probe": len(shapes),
                                  "gmm_grouped_topb_round1_for_phase_7":
                                      len(b4)}}
    return curated, kl, b4, row


def _accumulation_checks(cfg, p0, batch, phase: str, prefix: str,
                         card: str):
    """Accumulation over 2 micro-batches against one batch from the
    weights ``p0`` (the reference's tests/test_train.py case: AdamW without
    decay): the loss and the params at the reference test's bounds, then
    the gradients handed to the optimizer (``_accum_witness``) within
    ``ACCUM_GRAD_RTOL`` with the control above it.  Emits both readings
    and fails on either."""
    import torch
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    opt0 = AdamW(weight_decay=0.0)
    out = {}
    for accum in (1, 2):
        fn = make_train_step(cfg, None, opt0, lambda s: ACCUM_LR,
                             accum_steps=accum)
        st = opt0.init(p0)
        p, st, m = fn(tree_map(lambda t: t.clone(), p0), st, batch, 0)
        out[accum] = (p, float(m["loss"]))
        del st, m
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    (p1, l1), (p2, l2) = out[1], out[2]
    worst, outside, nonfinite, flipped = 0.0, 0, 0, 0
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        nonfinite += int((~torch.isfinite(a)).sum() + (~torch.isfinite(b))
                         .sum())
        outside += int((~(diff <= 2e-3 + 2e-2 * b.abs())).sum())
        flipped += int((diff > ACCUM_LR).sum())
        worst = max(worst, float(torch.nan_to_num(diff, nan=0.0).max()))
    ok = abs(l1 - l2) <= 1e-3 * abs(l1) and outside == 0
    del out, p1, p2
    emit({"phase": phase, "call": f"{prefix}_accumulation", "card": card,
          "loss_accum_1": l1, "loss_accum_2": l2,
          "loss_rel_diff": abs(l1 - l2) / abs(l1),
          "params_max_abs_diff": worst, "params_outside_bound": outside,
          "params_not_finite": nonfinite, "lr": ACCUM_LR,
          "params_apart_by_over_lr": flipped,
          "params": _tree_numel(p0),
          "bound": {"loss_rel": 1e-3, "params_rtol": 2e-2,
                    "params_atol": 2e-3}, "ok": ok})
    if not ok:
        fail(f"{phase} ({prefix}): accum_steps=2 parts from accum_steps=1 "
             "beyond the reference's bounds")
    wit = _accum_witness(cfg, p0, batch)
    read = {name: {"accum_max": max(r["accum"]),
                   "accum_median": statistics.median(r["accum"]),
                   "control_min": min(r["control"]),
                   "control_max": max(r["control"]),
                   "limit": ACCUM_GRAD_RTOL[name]} for name, r in wit.items()}
    ok = all(r["accum_max"] <= r["limit"] < r["control_max"]
             for r in read.values())
    emit({"phase": phase, "call": f"{prefix}_accumulation_gradients",
          "card": card, "leaves": len(wit["fp32"]["accum"]),
          "measure": "per-leaf relative Frobenius error against the "
                     "one-batch gradient", "control": "the first "
          "micro-batch's gradient alone", "readings": read, "ok": ok})
    if not ok:
        fail(f"{phase} ({prefix}): the accumulated gradients part from the "
             f"one-batch ones beyond their limit, or the control does not: "
             f"{read}")


def _gradient_witness_checks(cfg, p0, batch, seed: int, phase: str,
                             call: str, card: str, block_eps=FD_EPS):
    """The gradient witness (``_gradient_witness``) on the weights ``p0``
    and its gates: the float64 gradient against its loss's central
    difference within ``FD64_RTOL`` (along the tree and block by block,
    a block at ``block_eps``), the fp32 one within ``FD_RTOL`` and
    ``GRAD32_RTOL`` of it, and the planted faults above their bounds.
    Emits the readings and fails on any gate."""
    eps = FD_EPS
    eps_list = sorted(set(FD_WITNESS_EPS) | {eps})
    t0 = time.perf_counter()
    wit = _gradient_witness(cfg, p0, batch, eps_list, seed,
                            block_eps=block_eps)
    wit_s = time.perf_counter() - t0
    dots, fd, gnorm = wit["dots"], wit["fd"], wit["gnorm"]
    spread = gnorm / _tree_numel(p0) ** 0.5
    err = {name: {str(e): abs(dot - v) / spread for e, v in fd.items()}
           for name, dot in dots.items()}
    block64 = max(wit["block_err"].values())
    frob32 = max(wit["frob"]["fp32"].values())
    planted = wit["planted_block_err"]
    planted_bound = {"float64_layer_0_doubled": FD64_RTOL,
                     "fp32_layer_0_doubled": GRAD32_RTOL,
                     "bf16_gradient": GRAD32_RTOL}
    ok = (err["fp32"][str(eps)] <= FD_RTOL
          and err["float64"][str(eps)] <= FD64_RTOL
          and block64 <= FD64_RTOL and frob32 <= GRAD32_RTOL
          and all(v > planted_bound[k] for k, v in planted.items()))
    emit({"phase": phase, "call": call,
          "card": card, "seconds": wit_s, "loss_fp32": wit["loss"],
          "grad_norm_float64": gnorm,
          "spread_grad_norm_over_sqrt_params": spread,
          "dot_grad_direction": dots,
          "central_difference_float64": {str(e): v for e, v in fd.items()},
          "err_over_spread": err,
          "rel_err_over_dot": {name: {str(e): abs(dot - v) / abs(v)
                                      for e, v in fd.items()}
                               for name, dot in dots.items()},
          "blocks": len(wit["block_err"]),
          "block_err_over_spread_float64": {
              "max": block64, "median": statistics.median(
                  wit["block_err"].values()),
              "argmax": max(wit["block_err"], key=wit["block_err"].get)},
          "block_rel_frobenius_against_float64": {
              name: {"max": max(r.values()),
                     "median": statistics.median(r.values()),
                     "argmax": max(r, key=r.get)}
              for name, r in wit["frob"].items()},
          "block_norm_share": wit["block_norm_share"],
          "block_eps": wit["block_eps"]
          if len(wit["block_eps"]) <= 8 else sorted(set(
              wit["block_eps"].values())),
          "eps": eps, "bound": {"fp32": FD_RTOL, "float64": FD64_RTOL,
                                "fp32_block_frobenius": GRAD32_RTOL},
          "planted": planted, "planted_bound": planted_bound,
          "planted_dot_layer_0_doubled_err_over_spread":
              abs(wit["planted_dot_layer_0_doubled"] - fd[eps]) / spread,
          "ok": ok})
    if not ok:
        fail(f"{phase} ({call}): the gradients part from the central "
             f"difference "
             f"or from the float64 gradient, or a planted fault reads "
             f"inside its bound: {err} float64 blocks {block64} fp32 "
             f"blocks {frob32} planted {planted}")


def phase_train(device, seed: int, errs, diffs, card: str = "",
                full: bool = True, check_launches: bool = True):
    """(r) curation: a pool of Zipf(1) token sequences embedded through
    the model's table, then the k most diverse over simulated reducers
    (the probe on B1, round 1 on B4), with the kernels and with
    ``use_pallas=False`` (equal indices); B1 (and B2) at the probe's
    subsample held against plain here, B4's round-1 shapes handed to
    phase 7.  (z) ``make_train_step`` with AdamW at the model's full width
    on one fixed batch of curated rows: 6 steps at a constant lr (the
    loss must fall), step, gradient and update ms by CUDA events beside
    their bounds, tokens/s, peak memory; accumulation over 2 micro-batches
    against one batch.  (z') the fp32 gradient witness.  (z'') a
    supervised run of the reduced config, killed at step 6 and resumed,
    against an uninterrupted run.  (z''') the training launcher once.
    Returns (launches, B4 cases, what phase 8 profiles)."""
    import torch
    import repro_torch.models as M
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.distributed import (FailureInjector, ResiliencePolicy,
                                         TrainingSupervisor)
    from repro_torch.launch import train as launcher
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    sz = train_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    # (r) curation, as examples/train_diverse_data.py does it
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    curated, kl, train_b4, row = _curate(cfg, params, sz, seed, device, errs,
                                         check_launches, "train (r)")
    for k_, v in kl.items():
        launches[k_] += v
    emit({"phase": "train", "call": "r_curation", "card": card,
          "init_seconds": init_s, **row})

    # (z) training at the model's width on one fixed batch of curated rows
    B = sz["batch"]
    rows = curated[torch.randperm(curated.shape[0], generator=torch.Generator(
        ).manual_seed(seed + 43))[:B].to(curated.device)]
    batch = {"tokens": rows[:, :-1].contiguous(),
             "labels": rows[:, 1:].contiguous()}
    S = batch["tokens"].shape[1]
    p0 = clone(params)
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        cfg, params, batch, sz["steps"], device)
    if not losses[-1] < losses[0]:
        fail(f"train (z): the loss did not fall: {losses}")
    n_params = M.count_params(cfg)
    ops_ms, ops_parts, upd_bound = train_bounds(cfg, B, S)
    state_gb = n_params * (2 + 2 + 12) / 1e9

    emit({"phase": "train", "call": "z_train_steps", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "remat": cfg.remat, "optimizer": "AdamW(b1=0.9, b2=0.95, "
          "eps=1e-8, weight_decay=0.1)", "lr": TRAIN_LR, "batch": B,
          "seq": S, "steps": sz["steps"], "losses": losses,
          "batch_tokens_sum": int(batch["tokens"].sum()),
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": B * S / (statistics.median(step_ms) / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": state_gb,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    del params
    if cuda:
        torch.cuda.empty_cache()

    _accumulation_checks(cfg, p0, batch, "train", "z", card)
    # (z') the gradient witness on the same weights, upcast
    _gradient_witness_checks(cfg, p0, batch, seed + 47, "train",
                             "z_prime_gradient_witness", card)
    if cuda:
        torch.cuda.empty_cache()

    # (z'') a supervised run of the reduced config, killed and resumed
    rcfg = get_config(sz["arch"], reduced=True)
    tree0 = M.init_params(rcfg, seed, device=device)
    ropt = AdamW()
    rstep = make_train_step(rcfg, launcher.RULES, ropt, lambda s: 1e-3)

    def step_fn(st, bt, i):
        p, o, mm = rstep(st[0], st[1], bt, i)
        return (p, o), mm

    def batch_fn(i):
        return lm_batch(rcfg, seed=seed + 53, step=i,
                        batch=sz["resume_batch"], seq=sz["resume_seq"],
                        device=device)

    root = ROOT / "build" / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    sup = {}
    t0 = time.perf_counter()
    for name, inj in (("clean", None),
                      ("killed", FailureInjector(fail_at=(6,)))):
        s_ = TrainingSupervisor(CheckpointManager(str(root / name)),
                                policy=ResiliencePolicy(
                                    checkpoint_every=4, injector=inj))
        final = s_.run((clone(tree0), ropt.init(tree0)), step_fn, 12,
                       batch_fn)
        sup[name] = (final, s_.report)
    resume_s = time.perf_counter() - t0
    (cf, cr), (kf, kr) = sup["clean"], sup["killed"]
    same = [bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(cf[0]) + [x for f in cf[1] for x in tree_leaves(f)],
        tree_leaves(kf[0]) + [x for f in kf[1] for x in tree_leaves(f)])]
    agree = {"losses": kr.losses == cr.losses[:6] + cr.losses[4:],
             "final_state": all(same), "resumes": kr.resumes == 1,
             "final_step": kr.final_step == cr.final_step == 12}
    emit({"phase": "train", "call": "z_double_prime_resume", "card": card,
          "arch": rcfg.arch, "steps": 12, "checkpoint_every": 4,
          "killed_at": 6, "seconds": resume_s,
          "losses_clean": cr.losses, "losses_killed": kr.losses,
          "leaves_equal": f"{sum(same)}/{len(same)}", "agree": agree})
    shutil.rmtree(root, ignore_errors=True)
    if not all(agree.values()):
        fail(f"train (z''): the resumed run parts from the uninterrupted "
             f"one {agree}")
    del sup, cf, kf, tree0

    # (z''') the launcher once, in its own process (what a user runs)
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *sz["launch"]],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    lines = proc.stdout.splitlines()
    emit({"phase": "train", "call": "z_triple_prime_launcher", "card": card,
          "argv": sz["launch"], "exit": proc.returncode,
          "seconds": time.perf_counter() - t0, "stdout": lines[-4:]})
    if proc.returncode != 0 or not lines or not lines[-1].startswith("step"):
        fail(f"train launcher: exit {proc.returncode}: "
             f"{proc.stderr[-2000:]}")

    # what phase 8 profiles: one step at the model's width, from p0
    def profile():
        st = AdamW().init(p0)
        fn = make_train_step(cfg, launcher.RULES, AdamW(),
                             lambda s: TRAIN_LR)
        return lambda: fn(p0, st, batch, 0)
    emit({"phase": "train", "phase_seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches, train_b4, {"profile": profile,
                                "step_s": statistics.median(step_ms) / 1e3}


# --------------------------------------------------------------------------
# phase 15: the MoE family, serving and training
# --------------------------------------------------------------------------

# (moe'): one MoE layer in fp32 on the card against the CPU, outputs at
# this rtol and an atol of it times the largest entry (cuBLAS and the
# CPU's BLAS sum the products over D = 1,024 and F = 512 in other orders)
MOE_LAYER_RTOL = 1e-4


def moe_sizes(full: bool):
    """Sizes of phase 15: the model, the engine's slots, cache and
    requests, the drop-free consistency call (rows, tokens), the single
    layer's tokens, the candidate windows and the session reranker's k and
    k', the curation's pool, k, reducers and k', the training batch and
    steps, the drop-free accumulation batch (rows, tokens), and the arctic
    check's prompt."""
    if full:
        return {"arch": "granite-moe-1b-a400m", "reduced": False,
                "batch": 8, "capacity": 128, "requests": 16, "prompt": 64,
                "new": 16, "consistency": (2, 16), "layer_tokens": (8, 128),
                "windows": 1024, "window": 16, "k": 16, "kprime": 64,
                "curate": {"pool": 65536, "pool_len": 129, "k": 1024,
                           "reducers": 16, "kprime": 128},
                "train_batch": 8, "steps": 6, "accum": (2, 16),
                "arctic": (2, 16)}
    return {"arch": "granite-moe-1b-a400m", "reduced": True, "batch": 4,
            "capacity": 32, "requests": 8, "prompt": 8, "new": 6,
            "consistency": (2, 8), "layer_tokens": (4, 16), "windows": 64,
            "window": 8, "k": 4, "kprime": 16,
            "curate": {"pool": 2048, "pool_len": 17, "k": 64, "reducers": 4,
                       "kprime": 32},
            "train_batch": 4, "steps": 12, "accum": (2, 8),
            "arctic": (2, 8)}


class _Dispatches:
    """While active, ``moe._dispatch_local`` (which the MoE layer looks up
    at every call) is wrapped: each call's tokens, assignments and dropped
    assignments (a device tensor, read after the run) are kept, and with
    ``routing`` its router logits and its dispatch table.  With ``force``
    (a list of (N, k) expert ids, one a call in order), call i routes each
    token to the experts ``force[i]`` names: one constant, larger than the
    spread of the call's logits, is added to those logits, so the top-k
    picks them, and the gates, a softmax of the picked values, do not move
    with it (nor does the logits' gradient); the logits recorded are the
    layer's own."""

    def __init__(self, routing: bool = False, force=None):
        self.routing, self.force, self.calls = routing, force, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._moe, self._real = moe, moe._dispatch_local

        def record(xf, logits, E_range, cfg):
            own = logits.detach()
            if self.force is not None:
                top = self.force[len(self.calls)].to(logits.device)
                big = float(own.max() - own.min()) + 1.0
                logits = logits + torch.zeros_like(logits).scatter_(
                    1, top, big)
            buf, meta = self._real(xf, logits, E_range, cfg)
            keep = meta[0]
            call = {"tokens": xf.shape[0], "assignments": keep.numel(),
                    "dropped": (~keep).sum()}
            if self.routing:
                call["logits"] = own
                call["table"] = _dispatch_table(
                    torch.topk(logits, cfg.num_experts_per_tok).indices,
                    meta, cfg.num_experts)
            self.calls.append(call)
            return buf, meta
        moe._dispatch_local = record
        return self

    def __exit__(self, *exc):
        self._moe._dispatch_local = self._real

    def dropped(self, tokens=None):
        """Dropped assignments of each call (of ``tokens`` tokens)."""
        return [int(c["dropped"]) for c in self.calls
                if tokens is None or c["tokens"] == tokens]


def _routing_partings(la, lb, k: int):
    """The tokens whose top-k expert sets differ between the router logits
    ``la`` and ``lb`` (N, E) of the same layer, each held as a proven
    near-tie: on both sides the gap between its k-th and (k+1)-th logit is
    no larger than the largest logit difference between the two over the
    tokens that agree.  Returns (the differing tokens' mask, that bound,
    their gaps, whether every one is such a tie)."""
    import torch
    la, lb = la.double().cpu(), lb.double().cpu()
    sets = [torch.topk(v, k).indices.sort(-1).values for v in (la, lb)]
    differ = (sets[0] != sets[1]).any(-1)
    agree = ~differ
    bound = float((la - lb).abs()[agree].max()) if bool(agree.any()) \
        else float("inf")
    tops = [torch.topk(v, k + 1).values for v in (la, lb)]
    gaps = [max(float(v[t, k - 1] - v[t, k]) for v in tops)
            for t in differ.nonzero().flatten().tolist()]
    return differ, bound, gaps, all(g <= bound for g in gaps)


def _dispatch_table(top_i, meta, E: int):
    """A layer's dispatch as an (N, E) table on the host, whatever the
    order of a token's slots: -1 where the token does not route to the
    expert, its row in the expert's buffer where kept, C where dropped
    (a token holds at most one slot an expert, so its ranks do not depend
    on its slots' order)."""
    import torch
    keep, _, dest_c, _, C = meta
    N, k = top_i.shape
    val = torch.where(keep, dest_c, C).view(N, k).long()
    table = torch.full((N, E), -1, dtype=torch.long, device=top_i.device)
    return table.scatter_(1, top_i.long(), val).cpu()


def _dispatch_compared(ta, tb, la, lb, differ, k: int):
    """(the (N, E) mask of the table entries two runs must give alike,
    the tokens whose output they must give alike): all but a parted
    token's and, from it on, those of the experts its parting moved in or
    out (their ranks shift by the moved slot)."""
    import torch
    tops = [torch.topk(v.cpu(), k).indices for v in (la, lb)]
    skip = torch.zeros(ta.shape, dtype=torch.bool)
    for t in differ.nonzero().flatten().tolist():
        moved = sorted(set(tops[0][t].tolist()) ^ set(tops[1][t].tolist()))
        skip[t] = True
        skip[t:, moved] = True
    routed = (ta >= 0) | (tb >= 0)
    return ~skip, ~(skip & routed).any(-1)


def _accum_partings(cfg, tree, batch, dt):
    """The routing partings between the one-batch forward of ``batch`` and
    its two micro-batches' (rows halved, as ``make_train_step``'s
    accumulation splits it), layer by layer, on ``tree`` in ``dt``: their
    count, each checked as a proven near-tie (``_routing_partings``)."""
    import dataclasses

    import torch
    import repro_torch.models as M
    c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
    w = _as_dtype(tree, dt)
    h = batch["tokens"].shape[0] // 2
    runs = []
    for b in (batch, {n: v[:h] for n, v in batch.items()},
              {n: v[h:] for n, v in batch.items()}):
        with torch.no_grad(), _Dispatches(routing=True) as rec:
            M.loss_fn(w, c, None, b)
        runs.append([cl["logits"] for cl in rec.calls])
    del w
    partings, proven, bound = 0, True, 0.0
    for whole, a, b in zip(*runs):
        differ, bd, _, ok = _routing_partings(whole, torch.cat([a, b]),
                                              cfg.num_experts_per_tok)
        partings += int(differ.sum())
        proven &= ok
        bound = max(bound, bd)
    return {"near_ties": partings, "all_proven": proven,
            "largest_bound": bound}


def _moe_gradient_witness(cfg, tree, batch):
    """(z'_moe): the fp32 gradient (the weights upcast) against the float64
    one of the same weights, block by block (the embedding, each layer
    group, the final norm), the relative Frobenius error; the bf16
    gradient's too.  Routing is discrete: at this width the random model
    carries fp32 rounding through the layers far enough that a free fp32
    forward routes a quarter of the tokens apart from the float64 one (the
    first card run), and gradients of two routings are gradients of two
    functions.  So the fp32 and bf16 runs take the float64 run's routing
    (``_Dispatches(force=...)``), and each layer's own fp32 logits are
    held to the float64 ones: a token they would route apart must be a
    proven near-tie (``_routing_partings``), counted; the free fp32
    forward's partings are printed beside.  No central difference: a step
    along a direction can cross a routing boundary, and the difference is
    then not the gradient.  ``remat`` is set to none (the gradients are
    equal bit for bit in every mode, ``tests/test_torch_moe.py``), so the
    dispatch runs once a layer.  Planted fault: layer group 0's expert
    gradients doubled in the fp32 gradient.  Returns a dict of the
    readings."""
    import dataclasses

    import torch
    import repro_torch.models as M
    from repro_torch.train import make_loss
    from repro_torch.train.step import _value_and_grad
    cfg = dataclasses.replace(cfg, remat="none")
    L, k = cfg.num_layers, cfg.num_experts_per_tok
    layer_names = sorted(tree["layers"])
    experts = [i for i, n in enumerate(layer_names)
               if n in ("e_gate", "e_up", "e_down")]
    grads, routes, force = {}, {}, None
    for name, dt in (("float64", torch.float64), ("fp32", torch.float32),
                     ("bf16", cfg.dtype)):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        w = _as_dtype(tree, dt)
        with _Dispatches(routing=True, force=force) as rec:
            loss, g = _value_and_grad(make_loss(c, None), w, batch)
        if name == "fp32":
            with torch.no_grad(), _Dispatches(routing=True) as free:
                M.loss_fn(w, c, None, batch)
            routes["fp32_free"] = [cl["logits"] for cl in free.calls]
            del free
        del w
        grads[name] = (float(loss), dict(_blocks(g)))
        routes[name] = [cl["logits"] for cl in rec.calls]
        if force is None:
            force = [torch.topk(v, k).indices for v in routes[name]]
            dropped = sum(rec.dropped())
        del g, rec
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    g64 = grads["float64"][1]
    norm64 = {n: float(torch.sqrt(sum((x.double() ** 2).sum() for x in gs)))
              for n, gs in g64.items()}

    def frob(gs, n, scale=None):
        num = sum(float(((x.double() * (scale[i] if scale else 1.0)
                          - r.double()) ** 2).sum())
                  for i, (x, r) in enumerate(zip(gs, g64[n])))
        return num ** 0.5 / norm64[n]
    out = {"loss": {n: v[0] for n, v in grads.items()},
           "frob": {name: {n: frob(gs, n) for n, gs in grads[name][1].items()}
                    for name in ("fp32", "bf16")}}
    scale = [2.0 if i in experts else 1.0 for i in range(len(layer_names))]
    out["planted_fp32_layer_0_experts_doubled"] = frob(
        grads["fp32"][1]["layers[0]"], "layers[0]", scale)
    out["expert_share_of_layer_0_norm"] = float(torch.sqrt(sum(
        (g64["layers[0]"][i].double() ** 2).sum() for i in experts))) \
        / norm64["layers[0]"]
    out["routing"] = {"layers": L, "routings": L * len(force[0]),
                      "dropped_float64": dropped}
    for name in ("fp32", "bf16", "fp32_free"):
        per, bounds, gaps, proven = [], [], [], True
        for mine, ref in zip(routes[name], routes["float64"]):
            differ, bound, g, ok = _routing_partings(mine, ref, k)
            per.append(int(differ.sum()))
            bounds.append(bound)
            gaps.extend(g)
            proven &= ok
        out["routing"][name] = {"near_ties": sum(per), "per_layer": per,
                                "all_proven": proven,
                                "largest_bound": max(bounds),
                                "bound_per_layer": bounds,
                                "largest_tie_gap": max(gaps, default=0.0)}
    return out


def phase_moe(device, seed: int, errs, diffs, card: str = "",
              full: bool = True, check_launches: bool = True, out=None):
    """Phase 15: the MoE family at granite-moe-1b-a400m's full width, every
    token id drawn on the host (fingerprints printed).  (o_moe) the engine
    twice, traced then not; (o'_moe) decode from the cache against the
    full forward at a drop-free size; (moe') one MoE layer on the card
    against the CPU; (r_moe) curation through the model's table (B1 probe,
    B4 round 1); (q_moe) ``generate_diverse`` into the session reranker
    (B3, B4); (z_moe) AdamW steps, their bounds, peak memory and the
    accumulation witness at a drop-free size; (z'_moe) the gradient
    witness; arctic-480b reduced (the dense-residual branch): a forward
    against the CPU's and decode from the cache.  With ``out``, one (q_moe)
    group and one (z_moe) step are profiled.  Returns (launches, B4 cases
    for phase 7)."""
    import dataclasses

    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import moe
    from repro_torch.models.common import rms_norm
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_items, tree_map
    sz = moe_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new, P = sz["requests"], sz["batch"], sz["new"], sz["prompt"]
    L, k = cfg.num_layers, cfg.num_experts_per_tok
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def count(got):
        for k_, v in got.items():
            launches[k_] += v

    # (o_moe) the engine
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(cfg)
    ratio = M.active_param_ratio(cfg)
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_items(model))
    rng = np.random.default_rng(seed + 59)
    prompts = [rng.integers(1, cfg.vocab_size, size=P).astype(np.int32)
               for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    engine = ServingEngine(cfg, serve_launcher.RULES, model, batch=B,
                           capacity=sz["capacity"])
    rec = _Dispatches()
    first, traced_s, wall, tr = _engine_twice(engine, requests,
                                              "moe (o_moe)", record=rec)
    nk = B * P * k
    pre = rec.dropped(tokens=B * P)
    pre = [pre[i:i + L] for i in range(0, len(pre), L)]
    prefill = [sp.seconds for sp in _spans(tr, "serving.prefill")]
    decode = [sp.seconds * 1e3 for sp in _spans(tr, "serving.decode")]
    emit({"phase": "moe", "call": "o_moe_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "active_param_ratio": ratio,
          "active_params": n_params * ratio, "dtype": "bfloat16",
          "router_dtype": str(model["layers"]["router"].dtype),
          "init_seconds": init_s, "requests": R, "batch": B,
          "capacity": sz["capacity"], "prompt_tokens": P, "new_tokens": new,
          "prompts": _prints(np.stack(prompts)),
          "groups": len(prefill), "prefill_seconds": prefill,
          "prefill_bound_ms": 2 * n_params * ratio * B * P / BF16_FLOPS
          * 1e3, "prefill_bound_by": "operations (active params)",
          "decode_ms": {"median": statistics.median(decode),
                        "min": min(decode), "max": max(decode),
                        "steps": len(decode)},
          "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (every weight read once a step: each "
                             "expert's capacity buffer goes through the "
                             "batched products)",
          "weight_bytes": weight_bytes,
          "prefill_capacity": moe.capacity(cfg, B * P),
          "prefill_mean_load": B * P * k / cfg.num_experts,
          "prefill_dropped": [{"dropped": sum(d), "of": L * nk,
                               "largest_layer": max(d), "of_a_layer": nk}
                              for d in pre],
          "decode_dropped": sum(rec.dropped(tokens=B)),
          "traced_seconds": traced_s, "untraced_seconds": wall,
          "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True})
    del rec, tr

    # (o'_moe) decode from the cache against the full forward, at B x S
    # tokens few enough that no call drops (C >= min(N, 4) topk >= N)
    cb, cs = sz["consistency"]
    toks = torch.as_tensor(np.stack([p[:cs] for p in prompts[:cb]]),
                           device=device)
    with _Dispatches() as rec:
        row, ok = _cache_consistency(model, cfg, toks, sz["capacity"], None)
    dropped = sum(rec.dropped())
    emit({"phase": "moe", "call": "o_prime_moe_cache_consistency",
          "card": card, **row, "dispatch_calls": len(rec.calls),
          "dropped": dropped})
    if not ok or dropped:
        fail(f"moe (o'_moe): decode from the cache disagrees with the full "
             f"forward, or a call dropped ({dropped}): {row}")
    del rec

    # (moe') one MoE layer, the card against the CPU, from the same fp32
    # inputs (layer 0's weights, normed table rows of host-drawn tokens), at
    # the config's capacity factor and at 0.5, where drops are sure
    lb, ls = sz["layer_tokens"]
    ltoks = zipf_tokens((lb, ls), cfg.vocab_size, seed + 61, "cpu",
                        host=True)
    lw = {n: model["layers"][n][0, 0].float().cpu()
          for n in ("ln2", "router", "e_gate", "e_up", "e_down")}
    x = rms_norm(model["embed"].cpu()[ltoks.long()].float(), lw["ln2"])
    for cf in (cfg.capacity_factor, 0.5):
        c32 = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32,
                                  capacity_factor=cf)
        sides = {}
        for side, dev in (("cpu", "cpu"), ("card", device)):
            with _Dispatches(routing=True) as rec:
                y = moe.moe_mlp(x.to(dev), lw["router"].to(dev),
                                *(lw[n].to(dev) for n in ("e_gate", "e_up",
                                                          "e_down")),
                                c32, None)
            sides[side] = (y.cpu(), rec.calls[0])
        (yc, cc), (yg, cg) = sides["cpu"], sides["card"]
        differ, bound, gaps, ties_ok = _routing_partings(cc["logits"],
                                                         cg["logits"], k)
        same, rows = _dispatch_compared(cc["table"], cg["table"],
                                        cc["logits"], cg["logits"], differ,
                                        k)
        equal = torch.equal(cc["table"][same], cg["table"][same])
        rows = rows.view(lb, ls)
        err = float((yg - yc).abs()[rows].max())
        scale = float(yc.abs().max())
        close = bool(((yg - yc).abs()[rows] <= MOE_LAYER_RTOL * scale
                      + MOE_LAYER_RTOL * yc.abs()[rows]).all())
        drops = int(cc["dropped"])
        emit({"phase": "moe", "call": "moe_prime_layer_card_vs_cpu",
              "card": card, "capacity_factor": cf, "tokens": lb * ls,
              "d": cfg.d_model, "experts": cfg.num_experts, "topk": k,
              "capacity": moe.capacity(c32, lb * ls),
              "tokens_drawn": _prints(ltoks),
              "dropped": {"cpu": drops, "card": int(cg["dropped"])},
              "of": lb * ls * k, "near_ties": int(differ.sum()),
              "near_tie_bound": bound, "near_tie_gaps": gaps,
              "dispatch_equal_but_ties": equal,
              "rows_compared": int(rows.sum()), "max_abs_err": err,
              "out_max_abs": scale, "rtol": MOE_LAYER_RTOL,
              "atol": MOE_LAYER_RTOL * scale, "ok": close})
        if not (ties_ok and equal and close) or (cf == 0.5 and drops == 0):
            fail(f"moe (moe'): the layer's dispatch or output parts between "
                 f"the card and the CPU beyond a proven near-tie, or nothing "
                 f"dropped at capacity factor 0.5: ties {ties_ok} dispatch "
                 f"{equal} output {err} drops {drops}")
        del sides, cc, cg
    del x, lw

    # (r_moe) curation through granite's table
    curated, kl, moe_b4, row = _curate(cfg, model, sz["curate"], seed + 3,
                                       device, errs, check_launches,
                                       "moe (r_moe)")
    count(kl)
    emit({"phase": "moe", "call": "r_moe_curation", "card": card, **row})

    # (q_moe) serve-then-diversify, one session a request
    kl, b4, group, group_s = _serve_diverse(
        cfg, model, prompts, sz, seed + 67, device, errs, diffs,
        check_launches, "moe", "q_moe", card)
    count(kl)
    moe_b4.append(b4)

    # (z_moe) AdamW steps at full width on one fixed batch of curated rows
    TB = sz["train_batch"]
    pick = torch.randperm(curated.shape[0], generator=torch.Generator(
        ).manual_seed(seed + 71))[:TB].to(curated.device)
    trows = curated[pick]
    batch = {"tokens": trows[:, :-1].contiguous(),
             "labels": trows[:, 1:].contiguous()}
    S = batch["tokens"].shape[1]
    p0 = tree_map(lambda t: t.clone(), model)
    with torch.no_grad(), _Dispatches() as rec:
        M.loss_fn(p0, cfg, None, batch)
    batch_drops = rec.dropped()
    del rec, engine
    params = model
    del model
    before_steps = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        cfg, params, batch, sz["steps"], device)
    del params
    if cuda:
        torch.cuda.empty_cache()
    if not losses[-1] < losses[0]:
        fail(f"moe (z_moe): the loss did not fall: {losses}")
    ops_ms, ops_parts, upd_bound = train_bounds(cfg, TB, S)

    emit({"phase": "moe", "call": "z_moe_train_steps", "card": card,
          "arch": cfg.arch, "params": n_params, "active_params":
          n_params * ratio, "dtype": "bfloat16", "remat": cfg.remat,
          "optimizer": "AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)",
          "lr": TRAIN_LR, "batch": TB, "seq": S, "steps": sz["steps"],
          "losses": losses, "batch_tokens": _prints(batch["tokens"].cpu()),
          "batch_dropped": {"dropped": sum(batch_drops),
                            "of": L * TB * S * k,
                            "capacity": moe.capacity(cfg, TB * S)},
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": TB * S / (statistics.median(step_ms) / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": n_params * (2 + 2 + 12) / 1e9,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # accumulation over 2 micro-batches against one batch, at a drop-free
    # size: the one-batch call's N tokens and each micro-batch's both <= 32
    ab, as_ = sz["accum"]
    small = {n: v[:ab, :as_].contiguous() for n, v in batch.items()}
    dts = (("float64", torch.float64), ("fp32", torch.float32),
           ("bf16", cfg.dtype))
    with _Dispatches() as rec:
        wit = _accum_witness(cfg, p0, small, dts)
    dropped = sum(rec.dropped())
    limits = {"float64": ACCUM_GRAD_RTOL_F64, **ACCUM_GRAD_RTOL}
    read = {name: {"accum_max": max(r["accum"]),
                   "accum_median": statistics.median(r["accum"]),
                   "control_min": min(r["control"]),
                   "control_max": max(r["control"]),
                   "limit": limits[name],
                   "routing_partings": _accum_partings(cfg, p0, small, dt)}
            for (name, r), (_, dt) in zip(wit.items(), dts)}
    ok = dropped == 0 and all(
        r["control_max"] > r["limit"] and r["routing_partings"]["all_proven"]
        and (r["accum_max"] <= r["limit"] or name == "fp32"
             and r["routing_partings"]["near_ties"] > 0)
        for name, r in read.items())
    emit({"phase": "moe", "call": "z_moe_accumulation_gradients",
          "card": card, "rows": ab, "tokens": as_,
          "leaves": len(wit["fp32"]["accum"]), "dispatch_calls":
          len(rec.calls), "dropped": dropped,
          "measure": "per-leaf relative Frobenius error against the "
                     "one-batch gradient", "control": "the first "
          "micro-batch's gradient alone", "readings": read, "ok": ok})
    if not ok:
        fail(f"moe (z_moe): the accumulated gradients part from the "
             f"one-batch ones beyond their limit, the control does not, a "
             f"routing parting is no near-tie, or a call dropped "
             f"({dropped}): {read}")
    del wit, rec
    if cuda:
        torch.cuda.empty_cache()

    # (z'_moe) the gradient witness on the same weights, upcast, on the
    # model cut to its first layers (held at one layer, printed at each
    # depth up to the whole model: the random MoE model is chaotic through
    # its gates, and the fp32 and float64 forwards part with depth)
    t0 = time.perf_counter()
    depths = [d for d in WITNESS_DEPTHS if d < L] + [L]
    by_depth = []
    for depth in depths:
        m_d, c_d = _first_layers(p0, cfg, depth)
        wit = _moe_gradient_witness(c_d, m_d, batch)
        r = wit["routing"]
        by_depth.append({
            "layers": depth, "loss": wit["loss"],
            "block_rel_frobenius_against_float64": {
                name: {"max": max(v.values()),
                       "median": statistics.median(v.values()),
                       "argmax": max(v, key=v.get)}
                for name, v in wit["frob"].items()},
            "planted_fp32_layer_0_experts_doubled":
                wit["planted_fp32_layer_0_experts_doubled"],
            "expert_share_of_layer_0_norm":
                wit["expert_share_of_layer_0_norm"],
            "dropped_float64": r["dropped_float64"],
            "routings": r["routings"],
            "near_ties": {name: {f: r[name][f] for f in
                                 ("near_ties", "all_proven",
                                  "largest_bound", "largest_tie_gap")}
                          for name in ("fp32", "fp32_free", "bf16")},
            "fp32_near_ties_per_layer": r["fp32"]["per_layer"],
            "fp32_bound_per_layer": r["fp32"]["bound_per_layer"]})
        del m_d, wit
    one = by_depth[0]
    frob32 = one["block_rel_frobenius_against_float64"]["fp32"]["max"]
    planted = one["planted_fp32_layer_0_experts_doubled"]
    ok = (frob32 <= GRAD32_RTOL < planted
          and one["near_ties"]["fp32"]["all_proven"])
    emit({"phase": "moe", "call": "z_prime_moe_gradient_witness",
          "card": card, "seconds": time.perf_counter() - t0,
          "tokens": int(batch["tokens"].numel()),
          "blocks": "embed, final_norm, each layer group",
          "held_at_layers": one["layers"], "bound": GRAD32_RTOL,
          "routing": "fp32 and bf16 take the float64 run's routing; the "
                     "fp32 run's own logits' partings must be proven "
                     "near-ties; fp32_free is a free fp32 forward's",
          "by_depth": by_depth, "ok": ok})
    if not ok:
        fail(f"moe (z'_moe): at one layer the fp32 gradient parts from the "
             f"float64 one ({frob32} against {GRAD32_RTOL}), the planted "
             f"fault reads inside ({planted}), or a routing parting is no "
             f"near-tie {one['near_ties']}")
    del by_depth
    if cuda:
        torch.cuda.empty_cache()

    # what phase 8 would profile: one (q_moe) group and one (z_moe) step
    if out is not None:
        phase_profile(lambda: ServingEngine(
            cfg, serve_launcher.RULES, p0, batch=B, capacity=sz["capacity"],
            reranker=_reranker(cfg, sz, device, "auto")).generate_diverse(
                [Request(prompt=r.prompt, max_new_tokens=new,
                         session=r.session, candidates=r.candidates)
                 for r in group]), "moe_q_group", out,
            statistics.median(group_s["kernel"]))
        st = AdamW().init(p0)
        fn = make_train_step(cfg, train_launcher.RULES, AdamW(),
                             lambda s: TRAIN_LR)
        phase_profile(lambda: fn(p0, st, batch, 0), "moe_z_step", out,
                      statistics.median(step_ms) / 1e3)
        del st, fn
    del p0, group, batch, curated
    if cuda:
        torch.cuda.empty_cache()
    peak_phase = max(before_steps, torch.cuda.max_memory_allocated() / 1e9) \
        if cuda else None

    # arctic-480b reduced: the dense-residual branch on the device, its
    # forward against the same weights' on the CPU and decode from the cache
    acfg = get_config("arctic-480b", reduced=True)
    am = M.init_params(acfg, seed, device=device)
    ab, as_ = sz["arctic"]
    atoks = zipf_tokens((ab, as_), acfg.vocab_size, seed + 73, device,
                        host=True)
    got = _logits(am, acfg, atoks)
    want = _logits(tree_map(lambda t: t.cpu(), am), acfg, atoks.cpu())
    err_cpu, ok_cpu = _excess(got.cpu(), want, LOGITS_TOL)
    row, ok = _cache_consistency(am, acfg, atoks, as_ + 8, LOGITS_TOL)
    emit({"phase": "moe", "call": "arctic_reduced", "card": card,
          "arch": acfg.arch, "params": M.count_params(acfg),
          "dense_residual_ff": acfg.moe_dense_ff,
          "tokens": _prints(atoks.cpu()),
          "forward_vs_cpu": {"max_abs_err": err_cpu, "rtol": LOGITS_TOL,
                             "atol": LOGITS_TOL, "ok": ok_cpu}, **row})
    if not (ok and ok_cpu):
        fail(f"moe arctic reduced: the forward parts from the CPU's "
             f"({err_cpu}) or decode from the cache from the full forward "
             f"{row}")
    del am
    emit({"phase": "moe", "phase_seconds": time.perf_counter() - t_phase,
          "max_memory_allocated_gb": peak_phase, "launches": launches})
    return launches, moe_b4


# --------------------------------------------------------------------------
# phase 16: the vlm family (phi-3-vision-4.2b)
# --------------------------------------------------------------------------

def vlm_sizes(full: bool):
    """Sizes of phase 16: the model, the engine's slots and cache (the
    patches, the prompt and the decoded tokens), the requests, the
    candidate windows and the session reranker's k and k', and (z_vlm)'s
    depth, batch (rows x text tokens) and steps."""
    if full:
        return {"arch": "phi-3-vision-4.2b", "reduced": False, "batch": 8,
                "capacity": 576 + 64 + 32, "requests": 16, "prompt": 64,
                "new": 16, "windows": 1024, "window": 16, "k": 16,
                "kprime": 64, "train_layers": 8, "train_batch": 8,
                "train_seq": 128, "steps": 6}
    return {"arch": "phi-3-vision-4.2b", "reduced": True, "batch": 4,
            "capacity": 8 + 8 + 6, "requests": 8, "prompt": 8, "new": 6,
            "windows": 64, "window": 8, "k": 4, "kprime": 16,
            "train_layers": 1, "train_batch": 4, "train_seq": 16,
            "steps": 6}


def phase_vlm(device, seed: int, errs, diffs, card: str = "",
              full: bool = True, check_launches: bool = True, out=None):
    """Phase 16: the vlm family at phi-3-vision-4.2b's full width (random
    bf16 weights from ``seed``; token ids and patch embeddings drawn on the
    host, fingerprints printed).  (o_vlm) the engine twice, traced then
    not (zero patch embeddings before each prompt, as the reference's
    engine feeds); (o'_vlm) decode from the cache against
    ``forward_train`` with non-zero patches, fp32 and one-layer bf16 held
    at 2e-2; (q_vlm) ``generate_diverse`` into the session reranker (B3,
    B4 at d = 3,072); (z_vlm) AdamW steps on the model cut to
    ``train_layers`` (full width) over ``lm_batch``'s patches and tokens.
    With ``out``, one (o_vlm) group is profiled.  Returns (launches, B4
    cases for phase 7)."""
    import dataclasses

    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.vlm import D_VISION
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_items, tree_map
    sz = vlm_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new, S = sz["requests"], sz["batch"], sz["new"], sz["prompt"]
    P, L = cfg.num_patches, cfg.num_layers
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # (o_vlm) the engine
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(cfg)
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_items(model))
    layer_params = sum(t.numel() for _, t in tree_items(model["layers"])
                       if t.ndim > 3)
    rng = np.random.default_rng(seed + 79)
    prompts = [rng.integers(1, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    engine = ServingEngine(cfg, serve_launcher.RULES, model, batch=B,
                           capacity=sz["capacity"])
    first, traced_s, wall, tr = _engine_twice(engine, requests,
                                              "vlm (o_vlm)")
    prefill = [sp.seconds for sp in _spans(tr, "serving.prefill")]
    decode = [sp.seconds * 1e3 for sp in _spans(tr, "serving.decode")]
    group_s = [sp.seconds for sp in _spans(tr, "serving.generate")]
    pos = B * (P + S)
    pre_parts = {
        "layer_products_bf16_ms": 2 * layer_params * pos / BF16_FLOPS * 1e3,
        "patch_proj_bf16_ms": 2 * B * P * D_VISION * cfg.d_model
        / BF16_FLOPS * 1e3,
        "attention_fp32_ms": 4 * B * cfg.num_heads * (P + S) ** 2
        * cfg.head_dim * L / FP32_FLOPS * 1e3,
        "lm_head_bf16_ms": 2 * pos * cfg.d_model * cfg.vocab_size
        / BF16_FLOPS * 1e3}
    kv_bytes = 2 * L * B * sz["capacity"] * cfg.num_kv_heads \
        * cfg.head_dim * 2
    emit({"phase": "vlm", "call": "o_vlm_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "init_seconds": init_s, "requests": R, "batch": B,
          "capacity": sz["capacity"], "patches": P, "prompt_tokens": S,
          "new_tokens": new, "prompts": _prints(np.stack(prompts)),
          "groups": len(prefill), "prefill_seconds": prefill,
          "prefill_positions": pos,
          "prefill_bound_ms": sum(pre_parts.values()),
          "prefill_bound_parts": pre_parts,
          "prefill_bound_by": "operations",
          "decode_ms": {**_spread_of(decode), "steps": len(decode)},
          "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (the bf16 weights read once a step)",
          "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
          "kv_cache_read_ms": kv_bytes / HBM_BYTES_PER_S * 1e3,
          "traced_seconds": traced_s, "untraced_seconds": wall,
          "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True})
    del tr

    # (o'_vlm) decode from the cache against forward_train, non-zero
    # patches drawn on the host
    toks = torch.as_tensor(np.stack(prompts[:B]), device=device)
    pe_np = np.random.default_rng(seed + 83).normal(
        size=(B, P, D_VISION)).astype(np.float32)
    pe = torch.as_tensor(pe_np, device=device)
    row, ok = _cache_consistency(model, cfg, toks, sz["capacity"], None,
                                 pe=pe, ulp_atol=True)
    emit({"phase": "vlm", "call": "o_prime_vlm_cache_consistency",
          "card": card, "patch_embeds_sum": float(pe_np.astype(
              np.float64).sum()), **row})
    if not ok:
        fail(f"vlm (o'_vlm): decode from the cache disagrees with the full "
             f"forward in fp32 or at one layer in bf16: {row}")
    del pe, toks

    # (q_vlm) serve-then-diversify, one session a request
    kl, b4, group, q_s = _serve_diverse(
        cfg, model, prompts, sz, seed + 87, device, errs, diffs,
        check_launches, "vlm", "q_vlm", card)
    for k_, v in kl.items():
        launches[k_] += v
    del group

    # what phase 8 would profile: one (o_vlm) group, prefill and decode
    if out is not None:
        phase_profile(lambda: engine.generate(requests()[:B]), "vlm_o_group",
                      out, statistics.median(group_s))

    # (z_vlm) AdamW steps at full width, the depth cut: the first layers'
    # weights copied, the whole model released
    TL, TB, TS = sz["train_layers"], sz["train_batch"], sz["train_seq"]
    tree = tree_map(lambda t: t.clone(), dict(
        model, layers={n: w[:TL] for n, w in model["layers"].items()}))
    del model, engine
    if cuda:
        torch.cuda.empty_cache()
    c_t = dataclasses.replace(cfg, num_layers=TL)
    batch = lm_batch(c_t, seed=seed + 89, step=0, batch=TB, seq=TS,
                     device=device)
    seen = {}

    def keep(g):
        seen["patch_proj"] = g["patch_proj"].float()
    make_train_step(c_t, None, _GradProbe(keep), lambda s: 0.0)(
        tree, (), batch, 0)
    gp = seen.pop("patch_proj")
    gp_norm, gp_finite = float(gp.norm()), bool(torch.isfinite(gp).all())
    del gp
    n_t = M.count_params(c_t)
    # _adamw_steps resets the peak: keep the phase's until then
    before_steps = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else None
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        c_t, tree, batch, sz["steps"], device)
    del tree
    if cuda:
        torch.cuda.empty_cache()
    ops_ms, ops_parts, upd_bound = train_bounds(c_t, TB, TS)
    ok = losses[-1] < losses[0] and gp_finite and gp_norm > 0
    emit({"phase": "vlm", "call": "z_vlm_train_steps", "card": card,
          "arch": cfg.arch, "layers": TL, "cut_from_layers": L,
          "params": n_t, "dtype": "bfloat16", "remat": cfg.remat,
          "optimizer": "AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)",
          "lr": TRAIN_LR, "batch": TB, "patches": P, "text_tokens": TS,
          "steps": sz["steps"], "losses_text_positions": losses,
          "batch_tokens": _prints(batch["tokens"].cpu()),
          "patch_embeds_sum": float(batch["patch_embeds"].double().sum()),
          "patch_proj_grad_norm": gp_norm,
          "patch_proj_grad_finite": gp_finite,
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": TB * (P + TS) / (statistics.median(step_ms)
                                           / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": n_t * (2 + 2 + 12) / 1e9, "ok": ok})
    if not ok:
        fail(f"vlm (z_vlm): the text loss did not fall {losses}, or "
             f"patch_proj's gradient is zero or not finite ({gp_norm})")
    del batch
    emit({"phase": "vlm", "phase_seconds": time.perf_counter() - t_phase,
          "max_memory_allocated_gb": max(
              before_steps, torch.cuda.max_memory_allocated() / 1e9)
          if cuda else None, "launches": launches})
    return launches, [b4]


# --------------------------------------------------------------------------
# phase 17: the ssm family (mamba2-130m)
# --------------------------------------------------------------------------

# (ssd'): the chunked scan against the step recurrence from the same
# inputs, relative Frobenius error of y and of the final state: float64
# within SSD_F64_FRO, fp32 within SSD_F32_FRO; a planted fault (the
# inter-chunk term dropped: each chunk scanned alone) must read above the
# fp32 bound
SSD_F64_FRO = 1e-10
SSD_F32_FRO = 1e-4


def ssm_sizes(full: bool):
    """Sizes of phase 17: the model, the engine's slots and capacity (an
    ssm model's state does not grow; the engine does not read it), the
    requests, the
    candidate windows and the session reranker's k and k', (ssd')'s batch
    and sequence, the curation's pool, k, reducers and k', and (z_ssm)'s
    batch and steps."""
    if full:
        return {"arch": "mamba2-130m", "reduced": False, "batch": 8,
                "capacity": 64 + 32, "requests": 16, "prompt": 64,
                "new": 16, "windows": 1024,
                "window": 16, "k": 16, "kprime": 64, "scan": (2, 4096),
                "curate": {"pool": 16384, "pool_len": 1025, "k": 256,
                           "reducers": 16, "kprime": 128},
                "train_batch": 8, "steps": 6}
    return {"arch": "mamba2-130m", "reduced": True, "batch": 4,
            "capacity": 8 + 6, "requests": 8, "prompt": 8, "new": 6,
            "windows": 64,
            "window": 8, "k": 4, "kprime": 16, "scan": (2, 96),
            "curate": {"pool": 2048, "pool_len": 65, "k": 32, "reducers": 4,
                       "kprime": 16},
            "train_batch": 4, "steps": 12}


class _DispatchCount:
    """While active, counts the aten operations dispatched (each one device
    kernel launch or more on the card)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            count = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Mode.count += 1
                return func(*args, **(kwargs or {}))
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self.ops = type(self._mode).count


def _scan_witness(cfg, b: int, s: int, seed: int, device):
    """(ssd'): ``ssd_chunked`` against ``_ssd_recurrent`` at the model's
    SSD shape (heads, head dim, state, chunk) on b x s tokens drawn on the
    host: dt log-uniform in [1e-3, 1e-1] and A uniform in [1, 16] a head
    (Mamba-2's init ranges; dtA = -dt A), x N(0, 1) scaled by dt, B and C
    N(0, 1).  Returns the readings."""
    import numpy as np
    import torch
    from repro_torch.models import ssd
    h, p, n, chunk = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(b, s, h)))
    A = rng.uniform(1.0, 16.0, size=h)
    host = {"x": rng.normal(size=(b, s, h, p)) * dt[..., None],
            "dtA": -dt * A, "B": rng.normal(size=(b, s, n)),
            "C": rng.normal(size=(b, s, n))}
    prints = {k: float(v.sum()) for k, v in host.items()}
    marks = _Marks(device)

    def fro(a, r):
        return float(torch.linalg.vector_norm((a - r).double())
                     / torch.linalg.vector_norm(r.double()))

    out = {"b": b, "s": s, "heads": h, "head_dim": p, "state": n,
           "chunk": chunk, "inputs_sum": prints}
    for name, dt_ in (("float64", torch.float64), ("fp32", torch.float32)):
        ins = [torch.as_tensor(host[k], dtype=dt_, device=device)
               for k in ("x", "dtA", "B", "C")]
        zero = torch.zeros((b, h, p, n), dtype=dt_, device=device)
        ms = {}
        for path, fn in (("chunked", lambda: ssd.ssd_chunked(*ins, chunk)),
                         ("recurrence",
                          lambda: ssd._ssd_recurrent(*ins, zero))):
            fn()
            a = marks.mark()
            got = fn()
            z = marks.mark()
            if device == "cuda":
                torch.cuda.synchronize()
            ms[path] = marks.ms(a, z)
            if path == "chunked":
                (yc, fc) = got
            else:
                (yr, fr) = got
        row = {"y_rel_frobenius": fro(yc, yr),
               "final_state_rel_frobenius": fro(fc, fr), "ms": ms}
        if name == "fp32":
            l = min(chunk, s)
            while s % l:
                l -= 1
            alone = torch.cat([ssd.ssd_chunked(*(t[:, i:i + l] for t in ins),
                                               chunk)[0]
                               for i in range(0, s, l)], dim=1)
            row["planted_inter_chunk_dropped_rel_frobenius"] = fro(alone, yr)
            row["inter_chunk_share"] = fro(alone, yc)
            del alone
        out[name] = row
        del ins, yc, fc, yr, fr
    return out


def phase_ssm(device, seed: int, errs, diffs, card: str = "",
              full: bool = True, check_launches: bool = True, out=None):
    """Phase 17: the ssm family at mamba2-130m's full width and depth
    (random bf16 weights from ``seed``; every token id drawn on the host,
    fingerprints printed).  (o_ssm) the engine twice (prefill steps the
    recurrence over the prompt, as the reference does), with the prefill's
    and a decode step's dispatched ops; (ssd') the chunked scan against
    the recurrence at the model's SSD shape; (o'_ssm) decode from the
    state against the full (chunked) forward; (r_ssm) curation through
    mamba2's table (B1 probe, B4 round 1); (q_ssm) ``generate_diverse``
    into the session reranker (B3, B4 at d = 768); (z_ssm) AdamW steps on
    curated rows, accumulation and the gradient witness.  With ``out``,
    one (z_ssm) step is profiled.  Returns (launches, B4 cases for phase
    7)."""
    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_items, tree_map
    sz = ssm_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new, S = sz["requests"], sz["batch"], sz["new"], sz["prompt"]
    L = cfg.num_layers
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def count(got):
        for k_, v in got.items():
            launches[k_] += v

    # (o_ssm) the engine
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(cfg)
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_items(model))
    rng = np.random.default_rng(seed + 91)
    prompts = [rng.integers(1, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    engine = ServingEngine(cfg, serve_launcher.RULES, model, batch=B,
                           capacity=sz["capacity"])
    first, traced_s, wall, tr = _engine_twice(engine, requests,
                                              "ssm (o_ssm)")
    prefill = [sp.seconds for sp in _spans(tr, "serving.prefill")]
    decode = [sp.seconds * 1e3 for sp in _spans(tr, "serving.decode")]
    del tr
    toks = torch.as_tensor(np.stack(prompts[:B]), device=device)
    cache = M.make_cache(cfg, B, 0, device=device)
    with _DispatchCount() as pre_ops:
        _, cache = M.prefill_fn(model, cfg, None, {"tokens": toks}, cache)
    with _DispatchCount() as dec_ops:
        M.decode_fn(model, cfg, None, toks[:, :1], S, cache)
    state_bytes = 2 * cache.state.numel() * cache.state.element_size()
    del cache
    emit({"phase": "ssm", "call": "o_ssm_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "init_seconds": init_s, "requests": R, "batch": B,
          "prompt_tokens": S, "new_tokens": new,
          "prompts": _prints(np.stack(prompts)), "groups": len(prefill),
          "prefill_seconds": prefill,
          "prefill_ops_dispatched": pre_ops.ops,
          "prefill_path": "the step recurrence over the prompt's tokens "
                          "(host-paced)",
          "decode_ms": {**_spread_of(decode), "steps": len(decode)},
          "decode_ops_dispatched": dec_ops.ops,
          "decode_bound_ms": (weight_bytes + state_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (the bf16 weights read once, the fp32 "
                             "state read and written)",
          "weight_bytes": weight_bytes, "state_bytes_read_and_written":
          state_bytes, "traced_seconds": traced_s,
          "untraced_seconds": wall, "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True})

    # (ssd') the chunked scan against the recurrence at the model's shape
    sb, ss = sz["scan"]
    row = _scan_witness(cfg, sb, ss, seed + 97, device)
    f64, f32 = row["float64"], row["fp32"]
    planted = f32["planted_inter_chunk_dropped_rel_frobenius"]
    ok = (max(f64["y_rel_frobenius"], f64["final_state_rel_frobenius"])
          <= SSD_F64_FRO
          and max(f32["y_rel_frobenius"], f32["final_state_rel_frobenius"])
          <= SSD_F32_FRO < planted)
    emit({"phase": "ssm", "call": "ssd_prime_chunked_vs_recurrence",
          "card": card, **row, "bound": {"float64": SSD_F64_FRO,
                                         "fp32": SSD_F32_FRO},
          "ok": ok})
    if not ok:
        fail(f"ssm (ssd'): the chunked scan and the recurrence part beyond "
             f"their bounds, or the planted fault reads inside: {row}")

    # (o'_ssm) decode from the state against the full (chunked) forward
    row, ok = _cache_consistency(model, cfg, toks, 0, None)
    emit({"phase": "ssm", "call": "o_prime_ssm_cache_consistency",
          "card": card, **row})
    if not ok:
        fail(f"ssm (o'_ssm): decode from the state disagrees with the full "
             f"forward in fp32 or at one layer in bf16: {row}")
    del toks

    # (r_ssm) curation through mamba2's table
    curated, kl, ssm_b4, row = _curate(cfg, model, sz["curate"], seed + 101,
                                       device, errs, check_launches,
                                       "ssm (r_ssm)")
    count(kl)
    emit({"phase": "ssm", "call": "r_ssm_curation", "card": card, **row})

    # (q_ssm) serve-then-diversify, one session a request
    kl, b4, group, _ = _serve_diverse(
        cfg, model, prompts, sz, seed + 107, device, errs, diffs,
        check_launches, "ssm", "q_ssm", card)
    count(kl)
    ssm_b4.append(b4)
    del group, engine

    # (z_ssm) AdamW steps at full width and depth on curated rows
    TB = sz["train_batch"]
    pick = torch.randperm(curated.shape[0], generator=torch.Generator(
        ).manual_seed(seed + 109))[:TB].to(curated.device)
    trows = curated[pick]
    batch = {"tokens": trows[:, :-1].contiguous(),
             "labels": trows[:, 1:].contiguous()}
    TS = batch["tokens"].shape[1]
    p0 = tree_map(lambda t: t.clone(), model)
    # _adamw_steps resets the peak: keep the phase's until then
    before_steps = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else None
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        cfg, model, batch, sz["steps"], device)
    del model
    if cuda:
        torch.cuda.empty_cache()
    ops_ms, ops_parts, upd_bound = train_bounds(cfg, TB, TS)
    emit({"phase": "ssm", "call": "z_ssm_train_steps", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "remat": cfg.remat, "optimizer": "AdamW(b1=0.9, b2=0.95, "
          "eps=1e-8, weight_decay=0.1)", "lr": TRAIN_LR, "batch": TB,
          "seq": TS, "chunks_a_row": TS // ops_parts["ssd_chunk"],
          "steps": sz["steps"], "losses": losses,
          "batch_tokens": _prints(batch["tokens"].cpu()),
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": TB * TS / (statistics.median(step_ms) / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": n_params * (2 + 2 + 12) / 1e9,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    if not losses[-1] < losses[0]:
        fail(f"ssm (z_ssm): the loss did not fall: {losses}")
    _accumulation_checks(cfg, p0, batch, "ssm", "z_ssm", card)

    # (z'_ssm) the gradient witness on the same weights, upcast, at the
    # model's full depth
    _gradient_witness_checks(cfg, p0, batch, seed + 103, "ssm",
                             "z_prime_ssm_gradient_witness", card)
    if cuda:
        torch.cuda.empty_cache()

    # what phase 8 would profile: one (z_ssm) step
    if out is not None:
        st = AdamW().init(p0)
        fn = make_train_step(cfg, None, AdamW(), lambda s: TRAIN_LR)
        phase_profile(lambda: fn(p0, st, batch, 0), "ssm_z_step", out,
                      statistics.median(step_ms) / 1e3)
        del st, fn
    del p0, batch, curated
    emit({"phase": "ssm", "phase_seconds": time.perf_counter() - t_phase,
          "max_memory_allocated_gb": max(
              before_steps, torch.cuda.max_memory_allocated() / 1e9)
          if cuda else None, "launches": launches})
    return launches, ssm_b4


# --------------------------------------------------------------------------
# phase 18: the hybrid family (recurrentgemma-9b)
# --------------------------------------------------------------------------

# (scan'): ``rglru._lru_scan`` (the associative scan of the RG-LRU
# combine, h0 folded in) against a float64 sequential loop from the same
# inputs, relative Frobenius error: float64 within LRU_F64_FRO, fp32
# within LRU_F32_FRO; a planted fault (h0's term dropped) must read above
# the fp32 bound
LRU_F64_FRO = 1e-10
LRU_F32_FRO = 1e-5
# (z'_rg): a block's central difference steps FD_EPS over the block's
# share of the gradient's norm, at most 1e-4.  The float64 loss (12.46)
# resolves one ulp, 1.8e-15: on the random model group 0 holds 5.3e-5 of
# the norm, and at FD_EPS its difference resolves 2.3e-4 of its spread (a
# few thousand ulps; over FD64_RTOL), 4.3e-6 at 1e-4, while the embedding
# (99.999 % of it) curves too hard for 1e-4 (2.2e-3) and reads 2.2e-5 at
# FD_EPS (PERF.md section 6, PR 24)
def _share_scaled_eps(share: float) -> float:
    return min(FD_EPS / max(share, 1e-30), 1e-4)


def hybrid_sizes(full: bool):
    """Sizes of phase 18: the model, the engine's slots and capacity (the
    local attention's buffer holds min(capacity, window) slots), the
    requests, the wrap group (rows, prompt, new tokens: decode wraps the
    2,048-slot buffer), (o'_rg)'s rows and tokens, the candidate windows
    and the session reranker's k and k', (scan')'s (B, S, R), the
    curation's pool, k, reducers and k', and (z_rg)'s depth, batch, tokens,
    steps and the witness's rows."""
    if full:
        return {"arch": "recurrentgemma-9b", "reduced": False, "batch": 8,
                "capacity": 64 + 32, "requests": 16, "prompt": 64,
                "new": 16, "wrap": (2, 2040, 16), "check": (2, 2056),
                "gate_layers": 4, "windows": 1024, "window": 16, "k": 16,
                "kprime": 64, "scan": (8, 4096, 4096),
                "curate": {"pool": 16384, "pool_len": 1025, "k": 256,
                           "reducers": 16, "kprime": 128},
                "train_layers": 4, "train_batch": 8, "train_seq": 512,
                "steps": 6, "witness_rows": 2}
    return {"arch": "recurrentgemma-9b", "reduced": True, "batch": 4,
            "capacity": 8 + 6, "requests": 8, "prompt": 8, "new": 6,
            "wrap": (2, 20, 6), "check": (2, 24), "gate_layers": 4,
            "windows": 64, "window": 8, "k": 4, "kprime": 16,
            "scan": (2, 64, 16),
            "curate": {"pool": 2048, "pool_len": 65, "k": 32, "reducers": 4,
                       "kprime": 16},
            "train_layers": 4, "train_batch": 4, "train_seq": 32,
            "steps": 6, "witness_rows": 2}


def _lru_scan_witness(b: int, s: int, r: int, seed: int, device):
    """(scan'): ``rglru._lru_scan`` against the sequential recurrence h_t
    = a_t h_{t-1} + b_t in float64 from h0, on inputs made from host draws
    (fp32 normals g, x, h0 and lam): a = exp(-8 softplus(lam) sigmoid(g))
    and b = sqrt(max(1 - a², 1e-6)) x as the RG-LRU makes them (lam
    N(1, 0.25), g N(0, 4)), rounded to fp32, so both paths read the same
    values.  Returns the readings."""
    import numpy as np
    import torch
    from repro_torch.models import rglru
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, s, r), dtype=np.float32) * 2
    x = rng.standard_normal((b, s, r), dtype=np.float32)
    h0 = rng.standard_normal((b, r), dtype=np.float32)
    lam = 1 + rng.standard_normal(r, dtype=np.float32) / 2
    prints = {"g": float(g.sum(dtype=np.float64)),
              "x": float(x.sum(dtype=np.float64)),
              "h0": float(h0.sum(dtype=np.float64)),
              "lam": float(lam.sum(dtype=np.float64))}
    f64 = torch.float64
    gd = torch.as_tensor(g, device=device).to(f64)
    del g
    a = torch.exp(-8 * torch.nn.functional.softplus(torch.as_tensor(
        lam, device=device).to(f64)) * torch.sigmoid(gd)).float()
    del gd
    bt = (torch.sqrt(torch.clamp(1 - a.double() ** 2, min=1e-6))
          * torch.as_tensor(x, device=device).to(f64)).float()
    del x
    h0 = torch.as_tensor(h0, device=device)
    marks = _Marks(device)

    def timed(fn):
        fn()
        t0 = marks.mark()
        got = fn()
        t1 = marks.mark()
        if device == "cuda":
            torch.cuda.synchronize()
        return got, marks.ms(t0, t1)

    def loop():
        h, out = h0.double(), torch.empty((b, s, r), dtype=f64,
                                          device=device)
        a64, b64 = a.double(), bt.double()
        for t in range(s):
            h = a64[:, t] * h + b64[:, t]
            out[:, t] = h
        return out

    def fro(u, v):
        return float(torch.linalg.vector_norm((u - v).double())
                     / torch.linalg.vector_norm(v.double()))

    want, loop_ms = timed(loop)
    out = {"b": b, "s": s, "r": r, "inputs_sum": prints,
           "a_above_0.999_share": float((a > 0.999).double().mean()),
           "loop_float64_ms": loop_ms}
    for name, dt in (("float64", f64), ("fp32", torch.float32)):
        ad, bd, hd = a.to(dt), bt.to(dt), h0.to(dt)
        got, ms = timed(lambda: rglru._lru_scan(ad, bd, hd))
        out[name] = {"rel_frobenius": fro(got, want), "ms": ms}
        if name == "fp32":
            out[name]["planted_h0_dropped_rel_frobenius"] = fro(
                rglru._lru_scan(ad, bd, None), want)
        del ad, bd, hd, got
    del want, a, bt
    return out


def _engine_readings(tr):
    """(prefill seconds, decode ms a step, group seconds) of a trace."""
    return ([sp.seconds for sp in _spans(tr, "serving.prefill")],
            [sp.seconds * 1e3 for sp in _spans(tr, "serving.decode")],
            [sp.seconds for sp in _spans(tr, "serving.generate")])


def _matrix_params(tree, skip=("conv_w",)):
    """Params of a tree's matrix leaves (ndim > 2 in a stacked subtree)."""
    from repro_torch.tree import tree_items
    return sum(t.numel() for n, t in tree_items(tree)
               if t.ndim > 2 and not any(k in n for k in skip))


def phase_hybrid(device, seed: int, errs, diffs, card: str = "",
                 full: bool = True, check_launches: bool = True, out=None):
    """Phase 18: the hybrid family at recurrentgemma-9b's full width and
    depth (random bf16 weights from ``seed``; every token id drawn on the
    host, fingerprints printed).  (o_rg) the engine twice, traced then
    not, then a group of long prompts whose decode wraps the local
    attention's rolling buffer; (o'_rg) decode from the cache against the
    full forward across the wrap, fp32 and bf16 held at the 4-layer cut;
    (scan') the associative scan against a float64 loop; (r_rg) curation
    through the model's table (B1 probe, B4 round 1 at d = 4,096);
    (q_rg) ``generate_diverse`` into the session reranker (B3, B4); (z_rg)
    AdamW steps on the model cut to ``train_layers`` at full width over
    curated rows, accumulation and the gradient witness.  With ``out``,
    one (o_rg) group and one (z_rg) step are profiled.  Returns
    (launches, B4 cases for phase 7)."""
    import dataclasses

    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.rglru import _layout
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_items, tree_map
    sz = hybrid_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new, S = sz["requests"], sz["batch"], sz["new"], sz["prompt"]
    lead, G = _layout(cfg)
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def count(got):
        for k_, v in got.items():
            launches[k_] += v

    # (o_rg) the engine
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(cfg)
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_items(model))
    mats = _matrix_params({k: model[k] for k in ("lead", "groups")
                           if k in model})
    rng = np.random.default_rng(seed + 113)
    prompts = [rng.integers(1, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    def prefill_parts(rows, n):
        return {"layer_products_bf16_ms": 2 * mats * rows * n
                / BF16_FLOPS * 1e3,
                "attention_fp32_ms": 4 * rows * cfg.num_heads * n * n
                * cfg.head_dim * G / FP32_FLOPS * 1e3,
                "lm_head_bf16_ms": 2 * rows * n * cfg.d_model
                * cfg.vocab_size / BF16_FLOPS * 1e3,
                "rg_lru_scan_bytes_ms": 12 * rows * n * cfg.rnn_width
                * (lead + 2 * G) / HBM_BYTES_PER_S * 1e3}

    def decode_bound(cache):
        kv = sum(t.numel() * t.element_size() for t in cache.kv[:2])
        st = 2 * cache.state.numel() * cache.state.element_size() \
            + 2 * cache.conv.numel() * cache.conv.element_size()
        return {"decode_bound_ms": (weight_bytes + kv + st)
                / HBM_BYTES_PER_S * 1e3,
                "decode_bound_by": "bytes (the bf16 weights and the KV "
                                   "buffer read once, the fp32 state and "
                                   "conv rows read and written)",
                "kv_buffer_bytes": kv, "state_conv_bytes_rw": st}

    engine = ServingEngine(cfg, serve_launcher.RULES, model, batch=B,
                           capacity=sz["capacity"])
    first, traced_s, wall, tr = _engine_twice(engine, requests,
                                              "hybrid (o_rg)")
    prefill, decode, group_s = _engine_readings(tr)
    del tr
    pre_parts = prefill_parts(B, S)
    emit({"phase": "hybrid", "call": "o_rg_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "layout": {"leading_recurrent": lead, "groups": G},
          "init_seconds": init_s, "requests": R, "batch": B,
          "capacity": sz["capacity"], "prompt_tokens": S,
          "new_tokens": new, "prompts": _prints(np.stack(prompts)),
          "groups": len(prefill), "prefill_seconds": prefill,
          "prefill_bound_ms": sum(v for k_, v in pre_parts.items()
                                  if "bytes" not in k_),
          "prefill_bound_parts": pre_parts,
          "prefill_bound_by": "operations",
          "decode_ms": {**_spread_of(decode), "steps": len(decode)},
          **decode_bound(M.make_cache(cfg, B, sz["capacity"],
                                      shapes_only=True)),
          "weight_bytes": weight_bytes, "traced_seconds": traced_s,
          "untraced_seconds": wall, "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True})
    # what phase 8 would profile: one (o_rg) group, prefill and decode
    if out is not None:
        phase_profile(lambda: engine.generate(requests()[:B]),
                      "hybrid_o_group", out, statistics.median(group_s))
    del engine

    # the wrap group: long prompts, decode past the window's slots
    wr, wp, wn = sz["wrap"]
    wtoks = zipf_tokens((wr, wp), cfg.vocab_size, seed + 127, device,
                        host=True).cpu().numpy().astype(np.int32)
    weng = ServingEngine(cfg, serve_launcher.RULES, model, batch=wr,
                         capacity=wp + wn)
    wout, w_s, _, wtr = _traced(lambda tr: weng.generate(
        [Request(prompt=p, max_new_tokens=wn) for p in wtoks]))
    wpre, wdec, _ = _engine_readings(wtr)
    del wtr
    wcache = M.make_cache(cfg, wr, wp + wn, shapes_only=True)
    wparts = prefill_parts(wr, wp)
    emit({"phase": "hybrid", "call": "o_rg_window_wrap", "card": card,
          "rows": wr, "prompt_tokens": wp, "new_tokens": wn,
          "window": cfg.window, "buffer_slots": int(wcache.kv.k.shape[2]),
          "last_position": wp + wn - 2, "prompts": _prints(wtoks),
          "prefill_seconds": wpre,
          "prefill_bound_ms": sum(v for k_, v in wparts.items()
                                  if "bytes" not in k_),
          "prefill_bound_parts": wparts,
          "decode_ms": {**_spread_of(wdec), "steps": len(wdec)},
          **decode_bound(wcache), "seconds": w_s,
          "tokens_head": wout[0].out[:8].tolist()})
    del weng, wout

    # (o'_rg) decode from the cache against the full forward, across the
    # window's wrap: fp32 and bf16 held at the cut, bf16 at full depth
    # printed beside its floor
    cr, cs = sz["check"]
    ctoks = zipf_tokens((cr, cs), cfg.vocab_size, seed + 131, device,
                        host=True)
    row, ok = _cache_consistency(model, cfg, ctoks, cs, None,
                                 gate_depth=sz["gate_layers"],
                                 fp32_depth=sz["gate_layers"])
    emit({"phase": "hybrid", "call": "o_prime_rg_cache_consistency",
          "card": card, "window": cfg.window, "tokens": _prints(ctoks.cpu()),
          **row})
    if not ok:
        fail(f"hybrid (o'_rg): decode from the cache disagrees with the "
             f"full forward in fp32 or bf16 at {sz['gate_layers']} layers: "
             f"{row}")
    del ctoks

    # (scan') the associative scan against the float64 loop
    row = _lru_scan_witness(*sz["scan"], seed + 137, device)
    planted = row["fp32"]["planted_h0_dropped_rel_frobenius"]
    ok = (row["float64"]["rel_frobenius"] <= LRU_F64_FRO
          and row["fp32"]["rel_frobenius"] <= LRU_F32_FRO < planted)
    emit({"phase": "hybrid", "call": "scan_prime_associative_vs_loop",
          "card": card, **row, "bound": {"float64": LRU_F64_FRO,
                                         "fp32": LRU_F32_FRO}, "ok": ok})
    if not ok:
        fail(f"hybrid (scan'): the associative scan parts from the float64 "
             f"loop beyond its bounds, or the planted fault reads inside: "
             f"{row}")
    if cuda:
        torch.cuda.empty_cache()

    # (r_rg) curation through recurrentgemma's table
    curated, kl, hyb_b4, row = _curate(cfg, model, sz["curate"], seed + 139,
                                       device, errs, check_launches,
                                       "hybrid (r_rg)")
    count(kl)
    emit({"phase": "hybrid", "call": "r_rg_curation", "card": card, **row})

    # (q_rg) serve-then-diversify, one session a request
    kl, b4, group, _ = _serve_diverse(
        cfg, model, prompts[:B], sz, seed + 149, device, errs, diffs,
        check_launches, "hybrid", "q_rg", card)
    count(kl)
    hyb_b4.append(b4)
    del group

    # (z_rg) AdamW steps at full width, the depth cut: the cut's weights
    # copied, the whole model released
    TL, TB, TS = sz["train_layers"], sz["train_batch"], sz["train_seq"]
    tree, c_t = _first_layers(model, cfg, TL)
    tree = tree_map(lambda t: t.clone(), tree)
    del model
    if cuda:
        torch.cuda.empty_cache()
    pick = torch.randperm(curated.shape[0], generator=torch.Generator(
        ).manual_seed(seed + 151))[:TB].to(curated.device)
    trows = curated[pick]
    batch = {"tokens": trows[:, :TS].contiguous(),
             "labels": trows[:, 1:TS + 1].contiguous()}
    p0 = tree_map(lambda t: t.clone(), tree)
    n_t = M.count_params(c_t)
    before_steps = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else None
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        c_t, tree, batch, sz["steps"], device)
    del tree
    if cuda:
        torch.cuda.empty_cache()
    ops_ms, ops_parts, upd_bound = train_bounds(c_t, TB, TS)
    emit({"phase": "hybrid", "call": "z_rg_train_steps", "card": card,
          "arch": cfg.arch, "layers": TL, "cut_from_layers": cfg.num_layers,
          "layout": dict(zip(("leading_recurrent", "groups"),
                             _layout(c_t))),
          "params": n_t, "dtype": "bfloat16", "remat": cfg.remat,
          "optimizer": "AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)",
          "lr": TRAIN_LR, "batch": TB, "seq": TS, "steps": sz["steps"],
          "losses": losses, "batch_tokens": _prints(batch["tokens"].cpu()),
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": TB * TS / (statistics.median(step_ms) / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": n_t * (2 + 2 + 12) / 1e9})
    if not losses[-1] < losses[0]:
        fail(f"hybrid (z_rg): the loss did not fall: {losses}")
    _accumulation_checks(c_t, p0, batch, "hybrid", "z_rg", card)

    # (z'_rg) the gradient witness on the same cut over the first rows
    # (float64 activations of every row would add ~3x the logits' 8 GB)
    wrows = sz["witness_rows"]
    _gradient_witness_checks(c_t, p0, {k: v[:wrows] for k, v in
                                       batch.items()}, seed + 157, "hybrid",
                             "z_prime_rg_gradient_witness", card,
                             block_eps=_share_scaled_eps)
    if cuda:
        torch.cuda.empty_cache()

    # what phase 8 would profile: one (z_rg) step
    if out is not None:
        st = AdamW().init(p0)
        fn = make_train_step(c_t, None, AdamW(), lambda s_: TRAIN_LR)
        phase_profile(lambda: fn(p0, st, batch, 0), "hybrid_z_step", out,
                      statistics.median(step_ms) / 1e3)
        del st, fn
    del p0, batch, curated
    emit({"phase": "hybrid", "phase_seconds": time.perf_counter() - t_phase,
          "max_memory_allocated_gb": max(
              before_steps, torch.cuda.max_memory_allocated() / 1e9)
          if cuda else None, "launches": launches})
    return launches, hyb_b4


# --------------------------------------------------------------------------
# phase 19: the encdec family (seamless-m4t-large-v2)
# --------------------------------------------------------------------------

def encdec_sizes(full: bool):
    """Sizes of phase 19: the model, the engine's slots, capacity and
    frames, the requests, (o'_s2t)'s rows, tokens and frames, the
    candidate windows and the session reranker's k and k', (z_s2t)'s
    batch, tokens, frames and steps, and the witness's cut (layers,
    rows, tokens and frames)."""
    if full:
        return {"arch": "seamless-m4t-large-v2", "reduced": False,
                "batch": 8, "capacity": 64 + 32, "t_enc": 256,
                "requests": 16, "prompt": 64, "new": 16,
                "check": (2, 96, 256), "windows": 1024, "window": 16,
                "k": 16, "kprime": 64, "train_batch": 8, "train_seq": 512,
                "train_frames": 512, "steps": 6,
                "witness": {"layers": 4, "rows": 2, "seq": 128}}
    return {"arch": "seamless-m4t-large-v2", "reduced": True, "batch": 4,
            "capacity": 8 + 6, "t_enc": 10, "requests": 8, "prompt": 8,
            "new": 6, "check": (2, 12, 10), "windows": 64, "window": 8,
            "k": 4, "kprime": 16, "train_batch": 4, "train_seq": 16,
            "train_frames": 16, "steps": 6,
            "witness": {"layers": 1, "rows": 2, "seq": 8}}


def phase_encdec(device, seed: int, errs, diffs, card: str = "",
                 full: bool = True, check_launches: bool = True, out=None):
    """Phase 19: the encdec family at seamless-m4t-large-v2's full width
    and depth (random bf16 weights from ``seed``; token ids and frame
    embeddings drawn on the host, fingerprints printed).  (o_s2t) the
    engine twice, traced then not (``t_enc`` zero frames a row, as the
    reference's engine feeds); (o'_s2t) decode from the cache against
    ``forward_train`` on host-drawn frames, fp32 at full depth and bf16 at
    one encoder and one decoder layer held at 2e-2; (q_s2t)
    ``generate_diverse`` into the session reranker (B3, B4 at d = 1,024);
    (z_s2t) AdamW steps over ``lm_batch``'s frames and tokens,
    accumulation, and the gradient witness on a cut (the encoder's blocks
    included).  With ``out``, one (z_s2t) step is profiled.  Returns
    (launches, B4 cases for phase 7)."""
    import numpy as np
    import torch
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_items, tree_map
    sz = encdec_sizes(full)
    cfg = get_config(sz["arch"], reduced=sz["reduced"])
    R, B, new, S, TE = (sz["requests"], sz["batch"], sz["new"], sz["prompt"],
                        sz["t_enc"])
    Le, Ld = cfg.num_layers, cfg.num_decoder_layers
    H, hd = cfg.num_heads, cfg.head_dim
    launches = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def count(got):
        for k_, v in got.items():
            launches[k_] += v

    # (o_s2t) the engine
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed, device=device)
    sync()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(cfg)
    enc = _matrix_params(model["encoder"])
    cross = sum(model["decoder"][k].numel() for k in ("xk", "xv"))
    dec = _matrix_params(model["decoder"]) - cross
    nbytes = {k: sum(t.numel() * t.element_size() for _, t in tree_items(v))
              for k, v in (("decoder", model["decoder"]),
                           ("embed", model["embed"]))}
    rng = np.random.default_rng(seed + 163)
    prompts = [rng.integers(1, cfg.vocab_size, size=S).astype(np.int32)
               for _ in range(R)]

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

    engine = ServingEngine(cfg, serve_launcher.RULES, model, batch=B,
                           capacity=sz["capacity"], t_enc=TE)
    first, traced_s, wall, tr = _engine_twice(engine, requests,
                                              "encdec (o_s2t)")
    prefill, decode, _ = _engine_readings(tr)
    del tr, engine
    pre_parts = {
        "encoder_products_bf16_ms": 2 * (enc + cross) * B * TE
        / BF16_FLOPS * 1e3,
        "decoder_products_bf16_ms": 2 * dec * B * S / BF16_FLOPS * 1e3,
        "attention_fp32_ms": 4 * B * H * hd * (Le * TE * TE + Ld * (
            S * sz["capacity"] + S * TE)) / FP32_FLOPS * 1e3,
        "lm_head_bf16_ms": 2 * B * S * cfg.d_model * cfg.vocab_size
        / BF16_FLOPS * 1e3}
    cache = M.make_cache(cfg, B, sz["capacity"], t_enc=TE, shapes_only=True)
    cross_bytes = 2 * cache.cross_k.numel() * cache.cross_k.element_size()
    self_bytes = 2 * cache.self_kv.k.numel() * cache.self_kv.k.element_size()
    emit({"phase": "encdec", "call": "o_s2t_engine", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "init_seconds": init_s, "requests": R, "batch": B,
          "capacity": sz["capacity"], "t_enc": TE,
          "frames": "zeros (the engine's, as the reference's engine feeds)",
          "prompt_tokens": S, "new_tokens": new,
          "prompts": _prints(np.stack(prompts)), "groups": len(prefill),
          "prefill_seconds": prefill,
          "prefill_bound_ms": sum(pre_parts.values()),
          "prefill_bound_parts": pre_parts,
          "prefill_bound_by": "operations",
          "decode_ms": {**_spread_of(decode), "steps": len(decode)},
          "decode_bound_ms": (nbytes["decoder"] + nbytes["embed"]
                              + cross_bytes + self_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (the decoder's weights and the tied "
                             "embedding, the cross K/V and the "
                             "self-attention cache read once a step)",
          "decoder_and_embed_bytes": nbytes["decoder"] + nbytes["embed"],
          "cross_kv_bytes": cross_bytes, "self_kv_bytes": self_bytes,
          "traced_seconds": traced_s, "untraced_seconds": wall,
          "generated_tokens_per_s": R * new / wall,
          "same_tokens_two_runs": True})
    del cache

    # (o'_s2t) decode from the cache against forward_train, host-drawn
    # frames
    cr, cs, ct = sz["check"]
    ctoks = zipf_tokens((cr, cs), cfg.vocab_size, seed + 167, device,
                        host=True)
    fr_np = np.random.default_rng(seed + 173).standard_normal(
        (cr, ct, cfg.d_model), dtype=np.float32)
    frames = torch.as_tensor(fr_np, device=device)
    row, ok = _cache_consistency(model, cfg, ctoks, cs, None, pe=frames)
    emit({"phase": "encdec", "call": "o_prime_s2t_cache_consistency",
          "card": card, "frames": ct,
          "frames_sum": float(fr_np.sum(dtype=np.float64)),
          "tokens": _prints(ctoks.cpu()), **row})
    if not ok:
        fail(f"encdec (o'_s2t): decode from the cache disagrees with "
             f"forward_train in fp32 or at one layer in bf16: {row}")
    del ctoks, frames

    # (q_s2t) serve-then-diversify, one session a request
    kl, b4, group, _ = _serve_diverse(
        cfg, model, prompts[:B], sz, seed + 179, device, errs, diffs,
        check_launches, "encdec", "q_s2t", card)
    count(kl)
    del group

    # (z_s2t) AdamW steps at full width and depth over lm_batch's frames
    # and tokens
    TB, TS, TF = sz["train_batch"], sz["train_seq"], sz["train_frames"]
    batch = lm_batch(cfg, seed=seed + 181, step=0, batch=TB, seq=TS,
                     t_enc=TF, device=device)
    p0 = tree_map(lambda t: t.clone(), model)
    before_steps = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else None
    losses, step_ms, grad_ms, upd_ms, peak, held = _adamw_steps(
        cfg, model, batch, sz["steps"], device)
    del model
    if cuda:
        torch.cuda.empty_cache()
    ops_ms, ops_parts, upd_bound = train_bounds(cfg, TB, TS, t_enc=TF)
    emit({"phase": "encdec", "call": "z_s2t_train_steps", "card": card,
          "arch": cfg.arch, "params": n_params, "dtype": "bfloat16",
          "remat": cfg.remat, "optimizer": "AdamW(b1=0.9, b2=0.95, "
          "eps=1e-8, weight_decay=0.1)", "lr": TRAIN_LR, "batch": TB,
          "seq": TS, "frames": TF, "steps": sz["steps"], "losses": losses,
          "batch_tokens": _prints(batch["dec_tokens"].cpu()),
          "frames_sum": float(batch["frames"].double().sum()),
          "step_ms": _spread_of(step_ms), "grad_ms": _spread_of(grad_ms),
          "update_ms": _spread_of(upd_ms),
          "step_bound_ms": ops_ms, "step_bound_by": "operations",
          "step_bound_parts": ops_parts,
          "update_bound_ms": upd_bound, "update_bound_by": "bytes",
          "tokens_per_s": TB * (TS + TF) / (statistics.median(step_ms)
                                            / 1e3),
          "max_memory_allocated_gb": peak,
          "allocated_before_state_gb": held,
          "reckoned_state_gb": n_params * (2 + 2 + 12) / 1e9})
    if not losses[-1] < losses[0]:
        fail(f"encdec (z_s2t): the loss did not fall: {losses}")
    _accumulation_checks(cfg, p0, batch, "encdec", "z_s2t", card)

    # (z'_s2t) the gradient witness on a cut (encoder and decoder layers,
    # the first rows, frames and tokens): its blocks include the
    # encoder's, whose gradient arrives through the cross-attention only
    w = sz["witness"]
    wtree, wcfg = _first_layers(p0, cfg, w["layers"])
    wbatch = {"frames": batch["frames"][:w["rows"], :w["seq"]],
              "dec_tokens": batch["dec_tokens"][:w["rows"], :w["seq"]],
              "labels": batch["labels"][:w["rows"], :w["seq"]]}
    _gradient_witness_checks(wcfg, wtree, wbatch, seed + 191, "encdec",
                             "z_prime_s2t_gradient_witness", card)
    del wtree, wbatch
    if cuda:
        torch.cuda.empty_cache()

    # what phase 8 would profile: one (z_s2t) step
    if out is not None:
        st = AdamW().init(p0)
        fn = make_train_step(cfg, None, AdamW(), lambda s_: TRAIN_LR)
        phase_profile(lambda: fn(p0, st, batch, 0), "encdec_z_step", out,
                      statistics.median(step_ms) / 1e3)
        del st, fn
    del p0, batch
    emit({"phase": "encdec", "phase_seconds": time.perf_counter() - t_phase,
          "max_memory_allocated_gb": max(
              before_steps, torch.cuda.max_memory_allocated() / 1e9)
          if cuda else None, "launches": launches})
    return launches, [b4]


# --------------------------------------------------------------------------
# 20. sharded training: the reference's placements over a DeviceMesh
# --------------------------------------------------------------------------

SHARDED_WORLD = 4               # gloo ranks of phase 20, sharing one card
SHARDED_TIMEOUT_S = 300         # their process group and the join
SHARDED_WITNESS_LIMIT = 1e-10   # (zw_sh), float64, relative Frobenius
SHARDED_PLANTED_FLOOR = 1e-3    # each planted fault reads above it


def sharded_sizes(full: bool):
    """Phase 20's run: granite-moe-1b-a400m at full width and depth (the
    reduced config in the rehearsal), 8 x 128 tokens (8 x 16), a (2, 2)
    ('data', 'model') mesh, 2 AdamW steps."""
    return {"arch": "granite-moe-1b-a400m", "reduced": not full,
            "batch": 8, "seq": 128 if full else 16, "steps": 2,
            "model_axis": 2, "lr": 1e-4}


def _sharded_grad_errs(cfg, mesh, rules, full, batch, want=None):
    """Per leaf, the relative Frobenius distance between the sharded
    step's gradient of ``full`` (placed by the specs) and ``want``, the
    one-process gradient of the same function: the mean over the data
    shards of the port's one-device gradients on each shard's rows (a
    MoE layer's capacity counts the shard's own tokens).  Every rank
    computes ``want`` itself and compares its own shard; the sums meet in
    one all-reduce.  Returns (errs, want)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import models as M
    from repro_torch.distributed import sharded
    from repro_torch.launch import RULES
    from repro_torch.launch.sharding import distribute
    from repro_torch.models.common import set_current_mesh
    from repro_torch.train.step import (_value_and_grad, make_loss,
                                        sharded_value_and_grad)
    from repro_torch.tree import tree_items, tree_map

    sp = distribute(full, mesh, M.param_specs(cfg, rules))
    _, got = sharded_value_and_grad(make_loss(cfg, rules), sp, batch, rules)
    if want is None:
        n_data = int(mesh.size(0))
        per = next(iter(batch.values())).shape[0] // n_data
        set_current_mesh(None)
        try:
            for j in range(n_data):
                g = _value_and_grad(make_loss(cfg, RULES), full, {
                    k: v[j * per:(j + 1) * per] for k, v in batch.items()})[1]
                # fp32 sums (float64 in a float64 config)
                want = (tree_map(lambda x: x.to(torch.promote_types(
                    x.dtype, torch.float32)), g) if j == 0 else
                    tree_map(lambda a, x: a.add_(x), want, g))
                del g
        finally:
            set_current_mesh(mesh)
        want = tree_map(lambda a: a.div_(n_data), want)
    sums = []
    names = []
    for (k, leaf), (_, g), (_, w) in zip(tree_items(sp), tree_items(got),
                                         tree_items(want)):
        wl = distribute_tensor(w, mesh, list(leaf.placements),
                               src_data_rank=None).to_local()
        r = sharded.replicas(leaf)
        wl = wl.double()
        sums += [((g.double() - wl) ** 2).sum() / r, (wl ** 2).sum() / r]
        names.append(k)
    tot = sharded.mesh_sum(torch.stack(sums), mesh).cpu()
    errs = {k: float((tot[2 * i] / tot[2 * i + 1]).sqrt())
            for i, k in enumerate(names)}
    return errs, want


class _LocalOnly:
    """A stand-in for the 'model' ranks' ``AxisComm`` whose max and sum
    stop at this rank (the planted fault of the vocab-parallel loss)."""

    def __init__(self, comm):
        self.rank, self.size = comm.rank, comm.size

    def max(self, t):
        return t

    def sum(self, t):
        return t


def _sharded_witness(cfg, mesh, rules, full, batch):
    """(zw_sh): the gradient errors of the sharded step and of its three
    planted faults (the copy's backward without its all-reduce over
    'model'; no gradient sum over 'data'; the vocab-parallel loss
    without its all-reduces of the max and the sums)."""
    from repro_torch import models as M
    from repro_torch.distributed import sharded
    from repro_torch.models import common

    errs, want = _sharded_grad_errs(cfg, mesh, rules, full, batch)
    out = {"errs": errs}
    nll = M.vocab_nll
    M.vocab_nll = lambda logits, labels: common._VocabNLL.apply(
        logits, labels, _LocalOnly(common.tp_comm("vocab")))
    try:
        out["planted_xent"] = _sharded_grad_errs(cfg, mesh, rules, full,
                                                 batch, want)[0]
    finally:
        M.vocab_nll = nll
    copy_bwd = sharded.CopyToGroup.backward
    sharded.CopyToGroup.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        out["planted_copy"] = _sharded_grad_errs(cfg, mesh, rules, full,
                                                 batch, want)[0]
    finally:
        sharded.CopyToGroup.backward = copy_bwd
    reduce = sharded.reduce_grad
    sharded.reduce_grad = (lambda g, leaf, axes, keep=():
                           reduce(g, leaf, (), keep))
    try:
        out["planted_data"] = _sharded_grad_errs(cfg, mesh, rules, full,
                                                 batch, want)[0]
    finally:
        sharded.reduce_grad = reduce
    return out


PAD_WITNESS_ARCH = "gemma-2b"


def pad_witness_sizes(full: bool):
    """(w_pad): gemma-2b at full width (8 query heads, one KV head, padded
    to 16: rank 1 of each 'model' pair attends padding alone), cut to one
    layer, in float64; the reduced config in the rehearsal, under
    ``pad_heads`` with its 4 heads padded to 8 (the same split)."""
    return {"batch": 2, "seq": 128 if full else 16,
            "pad_to": None if full else 8}


def _block_of(t, placements, mesh, coord):
    """The block of ``t`` that the rank at mesh coordinate ``coord`` holds
    of a leaf placed by ``placements`` (``distributed.sharded._chunk``'s
    rule, for any rank)."""
    from repro_torch.distributed.sharded import split_dims
    for dim, mdims in split_dims(placements).items():
        idx, n = 0, 1
        for i in mdims:
            size = int(mesh.size(i))
            idx, n = idx * size + coord[i], n * size
        per = t.shape[dim] // n
        t = t.narrow(dim, idx * per, per)
    return t


def _pad_witness(mesh, seed: int, device, full: bool):
    """(w_pad) on this rank, before any other work of phase 22 (the card
    is still empty): the sharded prefill of ``pad_witness_sizes``'
    tokens (last-position logits and the cache) against the one-process
    prefill; the loss and gradient of ``sharded_value_and_grad`` on the
    same tokens against the one-process step's, relative, leaf by leaf;
    the largest relative distance between the 'model' ranks' gradient
    shards of ``wq`` and ``wo`` (leaves no rank splits over 'model', so
    every rank's must be the same); and the padded heads' gradient left
    partial (``SplitToGroup``'s backward without its all-gather, the trap
    of a replicated leaf), which must read far off.  The one-process
    gradient is taken on the first rank alone, the other ranks dropping
    their whole copy first (four float64 copies and their gradients do
    not fit one card beside the ranks' shards), and each rank receives
    its block of it, one leaf at a time, and compares its own shard (a
    whole 4 GB embedding gradient a rank does not fit either)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import models as M
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import lm_batch
    from repro_torch.distributed import sharded
    from repro_torch.launch import RULES
    from repro_torch.launch.sharding import distribute, rules_for
    from repro_torch.models.common import set_current_mesh
    from repro_torch.train.step import (_value_and_grad, make_loss,
                                        sharded_value_and_grad)
    from repro_torch.tree import tree_items, tree_map
    sz = pad_witness_sizes(full)
    f64 = torch.float64
    cfg = dataclasses.replace(get_config(PAD_WITNESS_ARCH, reduced=not full),
                              num_layers=1, dtype=f64, param_dtype=f64)
    if sz["pad_to"]:
        cfg = dataclasses.replace(cfg, attn_shard="pad_heads",
                                  attn_pad_to=sz["pad_to"])
    B, S = sz["batch"], sz["seq"]
    out = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "padded": cfg.attn_pad_to, "vocab": cfg.vocab_size,
           "d_model": cfg.d_model, "tokens": (B, S)}
    params = tree_map(lambda t: t.to(f64),
                      M.init_params(cfg, seed, device=device))
    out["params"] = _tree_numel(params)
    prompt, _ = _serve_inputs(cfg, seed + 1, B, S, 0, device)
    want = _one_process_logits(cfg, mesh, params, prompt, [], S)
    got = _sharded_logits(cfg, mesh, params, prompt, [], S)
    out["prefill"] = {
        "logits": _rel_err(got[0][0], want[0][0]),
        "cache": max(_rel_err(got[1][k], v) for k, v in want[1].items()
                     if v.is_floating_point())}
    del want, got

    rules = rules_for(cfg, SHAPES["train_4k"], mesh)
    batch = {k: v.to(device) for k, v in lm_batch(
        cfg, seed=seed, step=0, batch=B, seq=S, device="cpu").items()}
    sp = distribute(params, mesh, M.param_specs(cfg, rules))
    first = dist.get_rank() == 0
    if not first:
        params = None
        if device == "cuda":
            torch.cuda.empty_cache()
    loss_fn = make_loss(cfg, rules)
    loss, got = sharded_value_and_grad(loss_fn, sp, batch, rules)
    split_bwd = sharded.SplitToGroup.backward

    def partial(ctx, g):
        comm, dim, n = ctx.args
        per = g.shape[dim]
        whole = torch.cat([g.new_zeros(g.shape)] * comm.size, dim)
        whole.narrow(dim, comm.rank * per, per).copy_(g)
        return whole.narrow(dim, 0, n), None, None, None
    sharded.SplitToGroup.backward = staticmethod(partial)
    try:
        _, bad = sharded_value_and_grad(loss_fn, sp, batch, rules)
    finally:
        sharded.SplitToGroup.backward = split_bwd
    model = sharded.AxisComm(mesh, ("model",))
    out["model_ranks_parted"] = {}
    for path, g in tree_items(got):
        name = path[path.rindex("[") + 2:-2]
        if name in ("wq", "wo"):
            both = model.gather(g[None].contiguous())
            out["model_ranks_parted"][name] = float(
                (both - both[:1]).abs().max()) / max(
                float(both.abs().max()), 1e-300)
    want = None
    if first:
        if device == "cuda":
            torch.cuda.empty_cache()     # the sharded steps' cached blocks
        n_data = int(mesh.size(0))
        per = B // n_data
        set_current_mesh(None)
        try:
            want_loss = 0.0
            for j in range(n_data):
                l, g = _value_and_grad(make_loss(cfg, RULES), params, {
                    k: v[j * per:(j + 1) * per] for k, v in batch.items()})
                want_loss += float(l) / n_data
                want = (g if want is None else
                        tree_map(lambda a, x: a.add_(x), want, g))
                del g
        finally:
            set_current_mesh(mesh)
        want = dict(tree_items(tree_map(lambda a: a.div_(n_data), want)))
        out["loss"] = abs(float(loss) - want_loss) / abs(want_loss)
        params = None
    if device == "cuda":
        torch.cuda.empty_cache()
    # each rank gets its block of each leaf's one-process gradient from
    # the first rank (point to point) and compares its own shard; the
    # squared sums meet in one all-reduce
    ranks = sharded.AxisComm(mesh, tuple(mesh.mesh_dim_names))
    src = ranks.order.index(0)
    coord = [tuple(int(c) for c in (mesh.mesh == r).nonzero()[0])
             for r in ranks.order]
    sums, names = [], []
    for (path, leaf), (_, g), (_, b) in zip(tree_items(sp), tree_items(got),
                                            tree_items(bad)):
        if first:
            blocks = {j: _block_of(want[path], leaf.placements, mesh,
                                   coord[j]) for j in range(ranks.size)}
            w = blocks.pop(ranks.rank).contiguous()
            ranks.exchange(blocks, {}, w)
        else:
            w = ranks.exchange({}, {src: tuple(g.shape)}, g)[src]
        r = sharded.replicas(leaf)
        sums += [((g - w) ** 2).sum() / r, ((b - w) ** 2).sum() / r,
                 (w ** 2).sum() / r]
        names.append(path)
        del w
    tot = sharded.mesh_sum(torch.stack(sums), mesh).cpu()
    errs = {"grads": [], "planted_partial_padded_grad": []}
    for i in range(len(names)):
        norm = max(float(tot[3 * i + 2]), 1e-300)
        errs["grads"].append(float(tot[3 * i] / norm) ** 0.5)
        errs["planted_partial_padded_grad"].append(
            float(tot[3 * i + 1] / norm) ** 0.5)
    if first:
        out.update({k: max(v) for k, v in errs.items()})
    return out


def _spec_bytes(shapes, specs, mesh):
    """The bytes a rank holds of the ``meta`` tree ``shapes`` split as the
    ``PartitionSpec`` tree ``specs`` divides it over ``mesh``."""
    from repro_torch.launch.sharding import placements, spec_walk
    total = 0
    for _, spec, t in spec_walk(specs, shapes):
        n = t.numel() * t.element_size()
        for i, pl in enumerate(placements(mesh, spec)):
            if pl.is_shard():
                n //= int(mesh.size(i))
        total += n
    return total


def _state_items(st):
    from repro_torch.tree import tree_items
    return [(f"{f}{k}", v) for f in st._fields
            for k, v in tree_items(getattr(st, f))]


def _sharded_rank(rank: int, world: int, store: str, out: str, seed: int,
                  full: bool):
    """One rank of phase 20 (a spawned process): gloo over a ``file://``
    store, the (2, 2) ('data', 'model') mesh on the card (``cuda``, the
    tensors' device), ``rules_for(cfg, SHAPES["train_4k"], mesh)``; the
    witness (zw_sh) on the model cut to one layer in float64, the same
    comparison at full depth in bf16 (printed), then the steps (z_sh).
    Writes its record, or the exception, to ``out/sharded{r}.pkl``."""
    import dataclasses
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    record = {}
    try:
        import torch
        import torch.distributed as dist
        device = "cuda" if full else "cpu"
        if full:
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
        from repro_torch import models as M
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.data import lm_batch
        from repro_torch.distributed import sharded
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.sharding import (distribute, init_state,
                                                 rules_for)
        from repro_torch.models.common import set_current_mesh
        from repro_torch.train import AdamW, make_train_step
        from repro_torch.tree import tree_items, tree_map
        sz = sharded_sizes(full)
        mesh = make_host_mesh(model_axis=sz["model_axis"], device=device)
        set_current_mesh(mesh)
        cfg = get_config(sz["arch"], reduced=sz["reduced"])
        rules = rules_for(cfg, SHAPES["train_4k"], mesh)
        record["rules"] = {"batch": rules.batch, "fsdp": rules.fsdp,
                           "experts": rules.experts, "vocab": rules.vocab}
        batch = {k: v.to(device) for k, v in lm_batch(
            cfg, seed=seed, step=0, batch=sz["batch"], seq=sz["seq"],
            device="cpu").items()}
        if full:
            torch.cuda.reset_peak_memory_stats()

        # (zw_sh): one layer, float64, held
        f64 = torch.float64
        cfg1 = dataclasses.replace(cfg, num_layers=1, dtype=f64,
                                   param_dtype=f64)
        p1 = tree_map(lambda t: t.to(f64),
                      M.init_params(cfg1, seed, device=device))
        record["witness"] = _sharded_witness(cfg1, mesh, rules, p1, batch)
        del p1

        # the same comparison at full depth in bf16, printed only
        full_p = M.init_params(cfg, seed, device=device)
        record["bf16_full_depth"] = _sharded_grad_errs(
            cfg, mesh, rules, full_p, batch)[0]

        # (z_sh): the steps
        specs = M.param_specs(cfg, rules)
        sp = distribute(full_p, mesh, specs)
        del full_p
        if full:
            torch.cuda.empty_cache()
        opt = AdamW()
        st = init_state(opt, sp, specs)
        shapes = M.param_shapes(cfg)
        record["bytes"] = {
            "params": sum(v.to_local().numel() * v.element_size()
                          for _, v in tree_items(sp)),
            "state": sum(v.to_local().numel() * v.element_size()
                         for _, v in _state_items(st)),
            "params_by_specs": _spec_bytes(shapes, specs, mesh),
            "state_by_specs": sum(
                _spec_bytes(a, b, mesh) for a, b in zip(
                    opt.state_shapes(shapes), opt.state_specs(specs))),
            "params_whole": sum(t.numel() * t.element_size()
                                for _, t in tree_items(shapes)),
            "state_whole": sum(t.numel() * t.element_size()
                               for _, t in _state_items(
                                   opt.state_shapes(shapes)))}
        step = make_train_step(cfg, rules, opt, lambda s: sz["lr"])
        steps = []
        for i in range(sz["steps"]):
            dist.barrier()
            sharded.reset()
            if full:
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
            t0 = time.perf_counter()
            sp, st, m = step(sp, st, batch, i)
            if full:
                e1.record()
                torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            steps.append({"step": i, "host_ms": host_ms,
                          "event_ms": e0.elapsed_time(e1) if full else None,
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "collective_bytes": dict(sharded.BYTES),
                          "collective_host_ms": {
                              k: v * 1e3 for k, v in sharded.SECONDS.items()}})
        record["steps"] = steps
        record["peak_bytes"] = (torch.cuda.max_memory_allocated() if full
                                else None)
        record["peak_reserved"] = (torch.cuda.max_memory_reserved() if full
                                   else None)
        set_current_mesh(None)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, f"sharded{rank}.pkl"), "wb") as f:
            pickle.dump(record, f)


def phase_sharded(device: str, seed: int, card: str = "",
                  full: bool = True):
    """Phase 20: the reference's sharded training step on four gloo ranks
    sharing the card (spawned as call (y)'s are), over a (2, 2) ('data',
    'model') mesh.  (zw_sh) the sharded step's float64 gradient against
    the one-process gradient of the same function on the model cut to
    one layer, held within 1e-10, each planted fault above 1e-3, and the
    same comparison at full depth in bf16, printed; (z_sh) 2 AdamW steps
    at full width and depth: each step's ms on the slowest rank (CUDA
    events and the host clock), loss and grad norm, the collective bytes
    a step, each rank's shard bytes beside the whole divided as the specs
    divide it, and each rank's peak beside the parent's bytes."""
    import math
    import pickle
    import tempfile
    import torch
    t_phase = time.perf_counter()
    sz = sharded_sizes(full)
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="sharded_", dir=ROOT / "build")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, SHARDED_WORLD, f"{scratch}/store", scratch,
                               seed, full)) for r in range(SHARDED_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=30)
    spawn_s = time.perf_counter() - t0
    if hung:
        fail(f"sharded: ranks {hung} did not finish in {SHARDED_TIMEOUT_S} s")
    recs = []
    for r, p in enumerate(procs):
        path = os.path.join(scratch, f"sharded{r}.pkl")
        if not os.path.exists(path):
            fail(f"sharded: rank {r} exited {p.exitcode} with no record")
        with open(path, "rb") as f:
            recs.append(pickle.load(f))
        if "error" in recs[-1] or p.exitcode != 0:
            fail(f"sharded: rank {r} exited {p.exitcode}:\n"
                 f"{recs[-1].get('error', '')}")
    shutil.rmtree(scratch, ignore_errors=True)

    w = recs[0]["witness"]
    worst = max(w["errs"].values())
    planted = {k: max(w[k].values()) for k in ("planted_copy",
                                                "planted_data",
                                                "planted_xent")}
    emit({"phase": "sharded", "call": "zw_sh", "arch": sz["arch"],
          "layers": 1, "dtype": "float64", "mesh": "(2, 2) ('data', "
          "'model')", "ranks": SHARDED_WORLD, "backend": "gloo",
          "max_rel_err": worst, "limit": SHARDED_WITNESS_LIMIT,
          "worst_leaf": max(w["errs"], key=w["errs"].get),
          "planted_copy_backward_without_model_all_reduce":
              planted["planted_copy"],
          "planted_no_data_sum": planted["planted_data"],
          "planted_xent_without_max_and_sum_all_reduce":
              planted["planted_xent"],
          "planted_floor": SHARDED_PLANTED_FLOOR, "rules": recs[0]["rules"]})
    if not worst <= SHARDED_WITNESS_LIMIT:
        fail(f"sharded (zw_sh): the float64 gradient parts from the "
             f"one-process gradient by {worst:.3e}")
    for k, v in planted.items():
        if not v > SHARDED_PLANTED_FLOOR:
            fail(f"sharded (zw_sh): planted fault {k} reads {v:.3e}")
    bf = recs[0]["bf16_full_depth"]
    emit({"phase": "sharded", "call": "zw_sh_full_depth", "dtype": "bf16",
          "held": False, "max_rel_err": max(bf.values()),
          "median_rel_err": statistics.median(bf.values()),
          "worst_leaf": max(bf, key=bf.get)})
    for i in range(sz["steps"]):
        rows = [rec["steps"][i] for rec in recs]
        losses = {r["loss"] for r in rows}
        if len(losses) != 1 or not all(map(math.isfinite, losses)):
            fail(f"sharded (z_sh): step {i} losses {sorted(losses)}")
        if len({r["grad_norm"] for r in rows}) != 1:
            fail(f"sharded (z_sh): step {i}: the ranks' grad norms differ")
        emit({"phase": "sharded", "call": "z_sh", "step": i,
              "batch": [sz["batch"], sz["seq"]],
              "loss": rows[0]["loss"], "grad_norm": rows[0]["grad_norm"],
              "ms_events_slowest": (max(r["event_ms"] for r in rows)
                                    if full else None),
              "ms_host_slowest": max(r["host_ms"] for r in rows),
              "collective_bytes_per_rank": [r["collective_bytes"]
                                            for r in rows],
              "collective_host_ms_slowest": {
                  k: max(r["collective_host_ms"].get(k, 0.0) for r in rows)
                  for k in rows[0]["collective_host_ms"]}})
    for r, rec in enumerate(recs):
        b = rec["bytes"]
        if (b["params"], b["state"]) != (b["params_by_specs"],
                                         b["state_by_specs"]):
            fail(f"sharded: rank {r} holds {b['params']} + {b['state']} "
                 f"bytes, the specs divide {b['params_by_specs']} + "
                 f"{b['state_by_specs']}")
    parent = (torch.cuda.memory_reserved() if full else None)
    peaks = [rec["peak_reserved"] for rec in recs]
    emit({"phase": "sharded", "call": "memory",
          "shard_bytes": [{k: rec["bytes"][k] for k in ("params", "state")}
                          for rec in recs],
          "whole_bytes": {k: recs[0]["bytes"][f"{k}_whole"]
                          for k in ("params", "state")},
          "peak_allocated_per_rank": [rec["peak_bytes"] for rec in recs],
          "peak_reserved_per_rank": peaks,
          "parent_reserved": parent,
          "total_gb": (sum(peaks) + parent) / 1e9 if full else None})
    if full and sum(peaks) + parent >= 80e9:
        fail("sharded: the ranks' and the parent's bytes pass 80 GB")
    secs = time.perf_counter() - t_phase
    emit({"phase": "sharded", "phase_seconds": secs,
          "spawn_to_join_s": spawn_s, "card": card})
    if full and secs > 120:
        fail(f"sharded: phase 20 took {secs:.1f} s (limit 120)")
    # what phase 21's dry run of this cell must reckon
    readings = {"collective_bytes": [[s["collective_bytes"]
                                      for s in rec["steps"]]
                                     for rec in recs],
                "shard_bytes": [{k: rec["bytes"][k] for k in ("params",
                                                               "state")}
                                for rec in recs],
                "peak_allocated": [rec["peak_bytes"] for rec in recs]}
    return secs, readings


# --------------------------------------------------------------------------
# 22. sharded serving: the prefill and decode steps on DTensor caches
# --------------------------------------------------------------------------

SERVE_PHASE_LIMIT_S = 210       # phase 22 on the card
SERVE_WITNESS_LIMIT = 1e-10     # (w_sh), float64, relative to the largest
# the floor of the planted padded-head attention's out-projection without
# its sum over 'model' (the other faults read above SHARDED_PLANTED_FLOOR)
ATTN_PLANTED_FLOOR = 0.1


def sharded_serve_sizes(full: bool):
    """Phase 22's runs on the (2, 2) ('data', 'model') mesh: granite-moe-
    1b-a400m at full width and depth (the reduced config under
    ``pad_heads`` in the rehearsal), (p_sh) and (d_sh) as (batch, prompt
    tokens, slots) then ``steps`` decode steps, (cp_sh) likewise with
    ``cp_steps``, (w_sh) the same two layouts on the model cut to one
    layer in float64; (s_sh) mamba2-130m's (batch, prompt tokens), its
    witness's at full depth; (d_tp) internlm2-1.8b's (batch, prompt
    tokens, slots) then ``steps`` split-KV decode steps, its witness
    (w_tp) on the model cut to one layer."""
    if full:
        return {"arch": "granite-moe-1b-a400m", "reduced": False,
                "d": (8, 3072, 4096), "cp": (2, 12288, 16384), "steps": 8,
                "cp_steps": 4, "w_d": (8, 96, 128), "w_cp": (2, 96, 128),
                "w_steps": 2, "ssm": "mamba2-130m", "s": (8, 1024),
                "s_w": (8, 16), "tp_arch": "internlm2-1.8b",
                "tp": (8, 1024, 2048), "w_tp": (8, 96, 128),
                "compare_steps": 1, "model_axis": 2}
    return {"arch": "granite-moe-1b-a400m", "reduced": True,
            "d": (8, 24, 32), "cp": (2, 48, 64), "steps": 3, "cp_steps": 3,
            "w_d": (8, 24, 32), "w_cp": (2, 48, 64), "w_steps": 2,
            "ssm": "mamba2-130m", "s": (8, 16), "s_w": (8, 8),
            "tp_arch": "internlm2-1.8b", "tp": (8, 24, 32),
            "w_tp": (8, 24, 32), "compare_steps": 2, "model_axis": 2}


def _serve_cfg(arch: str, reduced: bool):
    """The arch's config; the reduced one under the published
    ``pad_heads`` (4 heads: no padding on the 2-wide model axis)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=reduced)
    if reduced and cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, attn_shard="pad_heads", attn_pad_to=4)
    return cfg


def _serve_rules(cfg, mesh, B: int, C: int):
    """(prefill rules, decode rules, prefill cache specs, decode cache
    shapes and specs) of the (B, C) cells."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.sharding import cache_struct, rules_for
    cp = ShapeCell("prefill", "prefill", C, B)
    cd = ShapeCell("decode", "decode", C, B)
    rp, rd = rules_for(cfg, cp, mesh), rules_for(cfg, cd, mesh)
    _, specs_p = cache_struct(cfg, cp, rp)
    shapes, specs_d = cache_struct(cfg, cd, rd)
    return rp, rd, specs_p, shapes, specs_d


def _serve_inputs(cfg, seed: int, B: int, S: int, steps: int, device):
    """Host-drawn prompt tokens (B, S) and decode tokens (B, 1) a step."""
    from repro_torch.data import lm_batch
    toks = lm_batch(cfg, seed=seed, step=0, batch=B, seq=S + steps,
                    device="cpu")["tokens"]
    return (toks[:, :S].to(device),
            [toks[:, S + i:S + i + 1].to(device) for i in range(steps)])


def _local_cache_bytes(cache):
    from repro_torch.tree import cache_items
    return sum(l.to_local().numel() * l.element_size()
               for _, l in cache_items(cache))


def _sharded_logits(cfg, mesh, full, prompt, dec, C: int):
    """The sharded prefill, the cache and params moved to the decode
    rules, and decode fed ``dec``, through ``train.step.sharded_serve``:
    (each step's last-position logits, the final cache whole), on the
    host in float64."""
    from repro_torch import models as M
    from repro_torch.distributed import sharded
    from repro_torch.launch.sharding import distribute, move
    from repro_torch.train.step import sharded_serve
    from repro_torch.tree import cache_items
    B, S = prompt.shape
    rp, rd, specs_p, _, specs_d = _serve_rules(cfg, mesh, B, C)
    cache = distribute(M.make_cache(cfg, B, C, device=prompt.device,
                                    split_local_global=True), mesh, specs_p)
    sp = distribute(full, mesh, M.param_specs(cfg, rp))

    def rows(logits, rules):
        return _whole_rows(logits[:, -1].double(), cfg, mesh, rules).cpu()
    logits, cache = sharded_serve(
        cfg, rp, lambda p, b, c: M.prefill_fn(p, cfg, rp, b, c), sp,
        {"tokens": prompt}, cache)
    out = [rows(logits, rp)]
    if dec:
        cache = move(cache, mesh, specs_d)
        sp = move(sp, mesh, M.param_specs(cfg, rd))
    for i, t in enumerate(dec):
        logits, cache = sharded_serve(
            cfg, rd, lambda p, b, c: M.decode_fn(p, cfg, rd, b["tokens"],
                                                 S + i, c),
            sp, {"tokens": t}, cache)
        out.append(rows(logits, rd))
    return out, {path: sharded.gather(l).double().cpu()
                 for path, l in cache_items(cache)}


def _whole_rows(last, cfg, mesh, rules):
    """``last`` (this rank's rows of last-position logits, its vocab
    columns under a tensor-parallel vocab) with the 'model' ranks'
    columns and the data ranks' rows gathered."""
    from repro_torch.distributed import sharded
    if last.shape[-1] < cfg.vocab_size:
        last = sharded.AxisComm(mesh, ("model",)).gather(
            last.movedim(-1, 0).contiguous()).movedim(0, -1)
    bt = rules.resolve("batch")
    if not bt:
        return last
    return sharded.AxisComm(mesh, (bt,) if isinstance(bt, str)
                            else bt).gather(last)


def _one_process_logits(cfg, mesh, full, prompt, dec, C: int):
    """The one-process steps of the same function: each data shard's rows
    of the prefill rules alone (a MoE layer's capacity counts the
    shard's tokens), its cache decoded on (a decode call never drops),
    the shards' logits and caches concatenated."""
    import torch
    from repro_torch import models as M
    from repro_torch.launch import RULES
    from repro_torch.models.common import current_mesh, set_current_mesh
    from repro_torch.tree import cache_items
    B, S = prompt.shape
    rp = _serve_rules(cfg, mesh, B, C)[0]
    n = int(mesh.size(0)) if rp.resolve("batch") else 1
    per = B // n
    saved = current_mesh()
    set_current_mesh(None)
    try:
        parts = []
        for j in range(n):
            rows = slice(j * per, (j + 1) * per)
            cache = M.make_cache(cfg, per, C, device=prompt.device,
                                 split_local_global=True)
            logits, cache = M.prefill_fn(full, cfg, RULES,
                                         {"tokens": prompt[rows]}, cache)
            ls = [logits[:, -1].double().cpu()]
            for i, t in enumerate(dec):
                logits, cache = M.decode_fn(full, cfg, RULES, t[rows], S + i,
                                            cache)
                ls.append(logits[:, -1].double().cpu())
            parts.append((ls, dict(cache_items(cache))))
    finally:
        set_current_mesh(saved)
    logits = [torch.cat([p[0][i] for p in parts]) for i in range(len(dec) + 1)]
    caches = {}
    for path, leaf in parts[0][1].items():
        if path.endswith(("slot_pos", "pos")):
            caches[path] = leaf.double().cpu()
        else:
            caches[path] = torch.cat([p[1][path] for p in parts],
                                     dim=1).double().cpu()
    return logits, caches


def _rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _serve_witness(cfg, mesh, sizes, steps: int, seed: int, device,
                   faults=()):
    """(w_sh)/(s_sh)/(w_tp) witness: for each (B, S, C) layout of
    ``sizes``, the sharded steps' logits and caches against the
    one-process steps' (the float64 ``cfg``), the largest relative error
    a step and a leaf; then the planted ``faults``, each over the prefill
    and one decode step: ``"combine"`` and ``"write"`` on the
    context-parallel layout (the combine without its all-reduces, the
    decode write at every rank's local slot), ``"row"`` on the split-KV
    layout (the MLP's row product without its all-reduce over 'model');
    ``"attn"`` on the split-KV layout (the padded-head attention's
    out-projection without its sum over 'model', in the prefill)."""
    from repro_torch import models as M
    from repro_torch.distributed import sharded
    from repro_torch.models import attention, common
    from repro_torch.tree import tree_map
    import torch
    full = tree_map(lambda t: t.to(torch.float64),
                    M.init_params(cfg, seed, device=device))
    out = {}
    for name, (B, S, C) in sizes.items():
        prompt, dec = _serve_inputs(cfg, seed + 1, B, S, steps, device)
        want = _one_process_logits(cfg, mesh, full, prompt, dec, C)

        def errs(got):
            return {"logits": max(_rel_err(a, b) for a, b in zip(got[0],
                                                                  want[0])),
                    "cache": max(_rel_err(got[1][k], v)
                                 for k, v in want[1].items()
                                 if v.is_floating_point())}
        got = _sharded_logits(cfg, mesh, full, prompt, dec, C)
        out[name] = dict(errs(got), tokens_equal=all(
            bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in zip(got[0], want[0])))
        if faults and name == "split_kv":
            # the faults run the prefill and one decode step
            dec = dec[:1]
            want = _one_process_logits(cfg, mesh, full, prompt, dec, C)
        if "row" in faults and name == "split_kv":
            tp_sum = common.tp_sum
            common.tp_sum = lambda y, part: (y if part == "mlp"
                                             else tp_sum(y, part))
            try:
                out["planted_row_without_all_reduce"] = errs(
                    _sharded_logits(cfg, mesh, full, prompt, dec, C))
            finally:
                common.tp_sum = tp_sum
        if "attn" in faults and name == "split_kv":
            attn_sum = attention.tp_sum
            attention.tp_sum = lambda y, part: (y if part == "pad_heads"
                                                else attn_sum(y, part))
            try:
                out["planted_attn_without_sum"] = errs(
                    _sharded_logits(cfg, mesh, full, prompt, dec, C))
            finally:
                attention.tp_sum = attn_sum
        if "combine" in faults and name == "context_parallel":
            # each fault over the prefill and one decode step, against the
            # one-process steps as far
            dec = dec[:1]
            want = _one_process_logits(cfg, mesh, full, prompt, dec, C)
            combine = sharded.softmax_combine
            sharded.softmax_combine = lambda m, l, o, comm: o / l[..., None]
            try:
                out["planted_combine_without_all_reduce"] = errs(
                    _sharded_logits(cfg, mesh, full, prompt, dec, C))
            finally:
                sharded.softmax_combine = combine
            write = attention.cache_write

            def everywhere(lk, lv, lp, k, v, pos, window, shard=None):
                if shard is None or shard.seq is None or pos.shape[0] != 1:
                    return write(lk, lv, lp, k, v, pos, window, shard)
                return write(lk, lv, lp, k, v, pos, lk.shape[1],
                             shard._replace(seq=None))
            attention.cache_write = everywhere
            try:
                out["planted_write_on_every_rank"] = errs(
                    _sharded_logits(cfg, mesh, full, prompt, dec, C))
            finally:
                attention.cache_write = write
    return out


def _serve_steps(cfg, mesh, full, B: int, S: int, C: int, steps: int,
                 seed: int, device, timed: bool):
    """(p_sh)/(d_sh)/(cp_sh)/(s_sh): the prefill of B x S host-drawn tokens
    into C slots under the prefill rules, the cache and params moved to
    the decode rules, then ``steps`` decode steps fed their own tokens,
    through ``make_prefill_step`` and ``make_decode_step``: each step's
    ms (CUDA events, host clock), collective bytes and host ms; the
    cache shard bytes beside the specs' division; the tokens and the
    prefill's last-position logits (recorded by wrapping
    ``models.prefill_fn``, gathered outside the timed calls)."""
    import torch
    import torch.distributed as dist
    from repro_torch import models as M
    from repro_torch.distributed import sharded
    from repro_torch.launch.sharding import distribute, move
    from repro_torch.models.common import P
    from repro_torch.train.step import make_decode_step, make_prefill_step
    from repro_torch.tree import cache_items, tree_items

    rp, rd, specs_p, shapes, specs_d = _serve_rules(cfg, mesh, B, C)
    prompt, _ = _serve_inputs(cfg, seed, B, S, 0, device)
    cache = distribute(M.make_cache(cfg, B, C, device=device,
                                    split_local_global=True), mesh, specs_p)
    sp = distribute(full, mesh, M.param_specs(cfg, rp))
    if timed:
        torch.cuda.empty_cache()

    def timed_call(fn):
        dist.barrier()
        sharded.reset()
        if timed:
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
        t0 = time.perf_counter()
        res = fn()
        if timed:
            e1.record()
            torch.cuda.synchronize()
        return res, {"host_ms": (time.perf_counter() - t0) * 1e3,
                     "event_ms": e0.elapsed_time(e1) if timed else None,
                     "collective_bytes": dict(sharded.BYTES),
                     "collective_host_ms": {k: v * 1e3 for k, v in
                                            sharded.SECONDS.items()}}
    rec = {"rules": {"prefill": (rp.batch, rp.kv_seq, rp.fsdp),
                     "decode": (rd.batch, rd.kv_seq, rd.fsdp)}}
    with _recorded_prefill() as seen:
        (tok, cache), rec["prefill"] = timed_call(
            lambda: make_prefill_step(cfg, rp)(sp, {"tokens": prompt},
                                               cache))
    rec["prefill_last"] = _whole_rows(seen.pop(), cfg, mesh, rp).cpu()
    bt = rd.resolve("batch")

    def moved():
        return (move(cache, mesh, specs_d),
                move(sp, mesh, M.param_specs(cfg, rd)),
                move({"t": tok}, mesh, {"t": P(bt)})["t"])
    (cache, sp, tok), rec["move"] = timed_call(moved)
    rec["cache_bytes"] = _local_cache_bytes(cache)
    rec["cache_bytes_by_specs"] = _spec_bytes(shapes, specs_d, mesh)
    rec["param_bytes"] = sum(v.to_local().numel() * v.element_size()
                             for _, v in tree_items(sp))
    rec["param_bytes_by_specs"] = _spec_bytes(
        M.param_shapes(cfg), M.param_specs(cfg, rd), mesh)
    rec["cache_bytes_whole"] = sum(t.numel() * t.element_size()
                                   for _, t in cache_items(shapes))
    step = make_decode_step(cfg, rd)
    toks = [sharded.gather(tok).cpu()]
    rec["steps"] = []
    for i in range(steps):
        (tok, cache), row = timed_call(
            lambda: step(sp, tok[:, None], S + i, cache))
        rec["steps"].append(row)
        toks.append(sharded.gather(tok).cpu())
    rec["tokens"] = torch.stack(toks, dim=1)
    return rec


class _recorded_prefill:
    """Within: each ``models.prefill_fn`` call's last-position logits
    (fp32) appended to the list the block gets."""

    def __enter__(self):
        from repro_torch import models as M
        self.seen, self.real = [], M.prefill_fn

        def recording(*args):
            logits, cache = self.real(*args)
            self.seen.append(logits[:, -1].float())
            return logits, cache
        M.prefill_fn = recording
        return self.seen

    def __exit__(self, *exc):
        from repro_torch import models as M
        M.prefill_fn = self.real


def _one_process_tokens(cfg, mesh, full, B: int, S: int, C: int,
                        steps: int, seed: int, device):
    """The one-process steps of the same function on (p_sh)'s prompt: each
    data shard's rows of the prefill rules alone (a MoE layer's capacity
    counts the shard's tokens), then ``steps`` decode steps fed their
    own tokens.  Returns (tokens (B, steps + 1), the prefill's
    last-position logits) on the host."""
    import torch
    from repro_torch import models as M
    from repro_torch.launch import RULES
    from repro_torch.models.common import current_mesh, set_current_mesh
    from repro_torch.train.step import make_decode_step, make_prefill_step
    rp = _serve_rules(cfg, mesh, B, C)[0]
    prompt, _ = _serve_inputs(cfg, seed, B, S, 0, device)
    n = int(mesh.size(0)) if rp.resolve("batch") else 1
    per, saved = B // n, current_mesh()
    set_current_mesh(None)
    try:
        toks = []
        with _recorded_prefill() as seen:
            for j in range(n):
                c = M.make_cache(cfg, per, C, device=device,
                                 split_local_global=True)
                t, c = make_prefill_step(cfg, RULES)(
                    full, {"tokens": prompt[j * per:(j + 1) * per]}, c)
                ts = [t.cpu()]
                for i in range(steps):
                    t, c = make_decode_step(cfg, RULES)(full, t[:, None],
                                                        S + i, c)
                    ts.append(t.cpu())
                toks.append(torch.stack(ts, dim=1))
                del c
    finally:
        set_current_mesh(saved)
    return torch.cat(toks), torch.cat(seen).cpu()


def _serve_rank(rank: int, world: int, store: str, out: str, seed: int,
                full: bool):
    """One rank of phase 22 (a spawned process): gloo over a ``file://``
    store, the (2, 2) ('data', 'model') mesh on the card; (w_sh) the
    float64 witness on granite-moe cut to one layer, (p_sh)/(d_sh) and
    (cp_sh) at full depth in bf16, (s_sh) mamba2-130m with its float64
    witness at full depth.  Writes its record, or the exception, to
    ``out/serve{r}.pkl``."""
    import dataclasses
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    record = {}
    try:
        import torch
        import torch.distributed as dist
        device = "cuda" if full else "cpu"
        if full:
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
        from repro_torch import models as M
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.common import set_current_mesh
        sz = sharded_serve_sizes(full)
        mesh = make_host_mesh(model_axis=sz["model_axis"], device=device)
        set_current_mesh(mesh)
        if full:
            torch.cuda.reset_peak_memory_stats()
        f64 = torch.float64

        # (w_pad): gemma-2b's padded heads, one layer, float64, held; first,
        # while the card holds none of the phase's other trees
        t0 = time.perf_counter()
        record["pad_witness"] = _pad_witness(mesh, seed, device, full)
        record["pad_witness"]["seconds"] = time.perf_counter() - t0
        if full:
            record["pad_witness"]["peak_allocated"] = (
                torch.cuda.max_memory_allocated())
            record["pad_witness"]["peak_reserved"] = (
                torch.cuda.max_memory_reserved())
            torch.cuda.empty_cache()
        cfg = _serve_cfg(sz["arch"], not full)

        # (w_sh): one layer, float64, held
        t0 = time.perf_counter()
        cfg1 = dataclasses.replace(cfg, num_layers=1, dtype=f64,
                                   param_dtype=f64)
        record["witness"] = _serve_witness(
            cfg1, mesh, {"split_kv": sz["w_d"],
                         "context_parallel": sz["w_cp"]},
            sz["w_steps"], seed, device, faults=("combine", "write"))
        record["witness_s"] = time.perf_counter() - t0

        # (p_sh), (d_sh), (cp_sh): full depth, bf16
        params = M.init_params(cfg, seed, device=device)
        runs = (("d_sh", sz["d"], sz["steps"]),
                ("cp_sh", sz["cp"], sz["cp_steps"]))
        for name, (B, S, C), steps in runs:
            t0 = time.perf_counter()
            record[name] = _serve_steps(cfg, mesh, params, B, S, C, steps,
                                        seed, device, full)
            record[name]["seconds"] = time.perf_counter() - t0
        # the one-process tokens of the same function, printed: run r on
        # rank r, together
        t0 = time.perf_counter()
        if rank < len(runs):
            name, (B, S, C), _ = runs[rank]
            record[name]["one_process_tokens"], want = _one_process_tokens(
                cfg, mesh, params, B, S, C, sz["compare_steps"], seed,
                device)
            last = record[name]["prefill_last"]
            record[name]["prefill_logits_rel_err"] = float(
                (last - want).abs().max() / want.abs().max())
        dist.barrier()
        record["compare_s"] = time.perf_counter() - t0
        del params
        if full:
            torch.cuda.empty_cache()

        # (s_sh): mamba2, the state over 'model'
        t0 = time.perf_counter()
        scfg = _serve_cfg(sz["ssm"], not full)
        B, S = sz["s_w"]
        record["s_witness"] = _serve_witness(
            dataclasses.replace(scfg, dtype=f64, param_dtype=f64), mesh,
            {"batch_split": (B, S, S + sz["w_steps"])}, sz["w_steps"], seed,
            device)
        record["s_witness_s"] = time.perf_counter() - t0
        if full:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = M.init_params(scfg, seed, device=device)
        B, S = sz["s"]
        record["s_sh"] = _serve_steps(scfg, mesh, params, B, S,
                                      S + sz["steps"], sz["steps"], seed,
                                      device, full)
        record["s_sh"]["seconds"] = time.perf_counter() - t0
        del params
        if full:
            torch.cuda.empty_cache()

        # (w_tp), (d_tp): internlm2-1.8b, its MLPs and vocab over 'model'
        t0 = time.perf_counter()
        tcfg = _serve_cfg(sz["tp_arch"], not full)
        record["tp_witness"] = _serve_witness(
            dataclasses.replace(tcfg, num_layers=1, dtype=f64,
                                param_dtype=f64), mesh,
            {"split_kv": sz["w_tp"]}, sz["w_steps"], seed, device,
            faults=("row", "attn"))
        record["tp_witness_s"] = time.perf_counter() - t0
        before = (0, 0)
        if full:
            torch.cuda.empty_cache()
            before = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(tcfg, seed, device=device)
        B, S, C = sz["tp"]
        record["d_tp"] = _serve_steps(tcfg, mesh, params, B, S, C,
                                      sz["steps"], seed, device, full)
        record["d_tp"]["seconds"] = time.perf_counter() - t0
        record["d_tp"]["peak_allocated"] = (
            torch.cuda.max_memory_allocated() if full else None)
        t0 = time.perf_counter()
        if rank == 0:
            record["d_tp"]["one_process_tokens"], want = \
                _one_process_tokens(tcfg, mesh, params, B, S, C,
                                    sz["compare_steps"], seed, device)
            last = record["d_tp"]["prefill_last"]
            record["d_tp"]["prefill_logits_rel_err"] = float(
                (last - want).abs().max() / want.abs().max())
        dist.barrier()
        record["tp_compare_s"] = time.perf_counter() - t0
        del params

        record["peak_bytes"] = (max(before[0],
                                    torch.cuda.max_memory_allocated())
                                if full else None)
        record["peak_reserved"] = (max(before[1],
                                       torch.cuda.max_memory_reserved())
                                   if full else None)
        set_current_mesh(None)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, f"serve{rank}.pkl"), "wb") as f:
            pickle.dump(record, f)


def _step_rows(recs, key: str):
    """Each step of run ``key`` on the slowest rank: ms (events, host),
    each rank's collective bytes, the slowest rank's collective host ms
    by kind."""
    out = []
    for i in range(len(recs[0][key]["steps"])):
        rows = [rec[key]["steps"][i] for rec in recs]
        out.append({
            "step": i,
            "ms_events_slowest": (max(r["event_ms"] for r in rows)
                                  if rows[0]["event_ms"] is not None
                                  else None),
            "ms_host_slowest": max(r["host_ms"] for r in rows),
            "collective_bytes_per_rank": [r["collective_bytes"]
                                          for r in rows],
            "collective_host_ms_slowest": {
                k: max(r["collective_host_ms"].get(k, 0.0) for r in rows)
                for k in rows[0]["collective_host_ms"]}})
    return out


def phase_sharded_serve(device: str, seed: int, card: str = "",
                        full: bool = True):
    """Phase 22: the sharded prefill and decode steps on four gloo ranks
    sharing the card over a (2, 2) ('data', 'model') mesh.  (w_sh) the
    float64 witness on granite-moe cut to one layer (split-KV and
    context-parallel decode against the one-process steps within 1e-10,
    the two planted faults above 1e-3); (p_sh) the prefill of 8 x 3,072
    tokens into 4,096 slots under the prefill rules and (d_sh) 8
    split-KV decode steps after the cache is moved to the decode rules;
    (cp_sh) 2 x 12,288 into 16,384 slots, 4 context-parallel steps; each
    step's ms on the slowest rank, its collective bytes and host ms, each
    rank's cache and param shard bytes against the specs' division, the
    tokens against the one-process ones (printed); (s_sh) mamba2-130m
    with the state over 'model', 8 x 1,024 then 8 steps, and its float64
    witness at full depth; (w_tp) and (d_tp): internlm2-1.8b, its MLPs
    and vocab tensor-parallel, the float64 witness on one layer with the
    row product's planted fault, then 8 x 1,024 into 2,048 slots and 8
    split-KV steps.  A decode step of (d_sh) or (d_tp) that all-gathers
    fails the phase.  Returns (seconds, the per-step readings phase 21's
    dry run must reckon)."""
    import pickle
    import tempfile
    import torch
    t_phase = time.perf_counter()
    sz = sharded_serve_sizes(full)
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="serve_", dir=ROOT / "build")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_serve_rank,
                         args=(r, SHARDED_WORLD, f"{scratch}/store", scratch,
                               seed, full)) for r in range(SHARDED_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=30)
    spawn_s = time.perf_counter() - t0
    if hung:
        fail(f"sharded_serve: ranks {hung} did not finish in "
             f"{SHARDED_TIMEOUT_S} s")
    recs = []
    for r, p in enumerate(procs):
        path = os.path.join(scratch, f"serve{r}.pkl")
        if not os.path.exists(path):
            fail(f"sharded_serve: rank {r} exited {p.exitcode} with no "
                 f"record")
        with open(path, "rb") as f:
            recs.append(pickle.load(f))
        if "error" in recs[-1] or p.exitcode != 0:
            fail(f"sharded_serve: rank {r} exited {p.exitcode}:\n"
                 f"{recs[-1].get('error', '')}")
    shutil.rmtree(scratch, ignore_errors=True)

    for key, arch, wit in (("witness", sz["arch"], "w_sh"),
                           ("s_witness", sz["ssm"], "s_sh_witness"),
                           ("tp_witness", sz["tp_arch"], "w_tp")):
        w = recs[0][key]
        layouts = {k: v for k, v in w.items() if not k.startswith("planted")}
        worst = max(max(v["logits"], v["cache"]) for v in layouts.values())
        planted = {k: max(v["logits"], v["cache"]) for k, v in w.items()
                   if k.startswith("planted")}
        emit({"phase": "sharded_serve", "call": wit, "arch": arch,
              "layers": "all" if key == "s_witness" else 1,
              "dtype": "float64", "mesh": "(2, 2) ('data', 'model')",
              "ranks": SHARDED_WORLD, "backend": "gloo",
              "layouts": layouts, "max_rel_err": worst,
              "limit": SERVE_WITNESS_LIMIT, **planted,
              "planted_floor": SHARDED_PLANTED_FLOOR,
              "attn_planted_floor": ATTN_PLANTED_FLOOR})
        if not worst <= SERVE_WITNESS_LIMIT:
            fail(f"sharded_serve ({wit}): the float64 steps part from the "
                 f"one-process steps by {worst:.3e}")
        if not all(v["tokens_equal"] for v in layouts.values()):
            fail(f"sharded_serve ({wit}): float64 tokens differ")
        for k, v in planted.items():
            floor = (ATTN_PLANTED_FLOOR if k == "planted_attn_without_sum"
                     else SHARDED_PLANTED_FLOOR)
            if not v > floor:
                fail(f"sharded_serve ({wit}): planted fault {k} reads "
                     f"{v:.3e}")
    pads = [rec["pad_witness"] for rec in recs]
    w = pads[0]                     # the one-process gradient is rank 0's
    worst = max([w["loss"], w["grads"]] + [
        max(p["prefill"]["logits"], p["prefill"]["cache"]) for p in pads])
    parted = max(max(p["model_ranks_parted"].values()) for p in pads)
    planted = w["planted_partial_padded_grad"]
    emit({"phase": "sharded_serve", "call": "w_pad",
          "arch": PAD_WITNESS_ARCH, "layers": 1, "dtype": "float64",
          "heads": w["heads"], "kv_heads": w["kv_heads"],
          "padded_heads": w["padded"], "vocab": w["vocab"],
          "params": w["params"], "tokens": w["tokens"],
          "mesh": "(2, 2) ('data', 'model')", "ranks": SHARDED_WORLD,
          "prefill": [p["prefill"] for p in pads], "loss_rel_err": w["loss"],
          "grad_max_rel_err": w["grads"], "max_rel_err": worst,
          "limit": SERVE_WITNESS_LIMIT,
          "model_ranks_parted_wq_wo": parted,
          "planted_partial_padded_grad": planted,
          "planted_floor": SHARDED_PLANTED_FLOOR,
          "seconds_slowest": max(p["seconds"] for p in pads),
          "peak_allocated_per_rank": [p.get("peak_allocated") for p in pads],
          "peak_reserved_per_rank": [p.get("peak_reserved") for p in pads],
          "card": card})
    if not worst <= SERVE_WITNESS_LIMIT:
        fail(f"sharded_serve (w_pad): the float64 prefill or gradient parts "
             f"from the one-process steps by {worst:.3e}")
    if parted != 0.0:
        fail(f"sharded_serve (w_pad): the 'model' ranks' gradients of wq/wo "
             f"part by {parted:.3e}")
    if not planted > SHARDED_PLANTED_FLOOR:
        fail(f"sharded_serve (w_pad): the partial padded-head gradient reads "
             f"{planted:.3e}")
    readings = {}
    for key, arch, (B, S, C) in (
            ("d_sh", sz["arch"], sz["d"]), ("cp_sh", sz["arch"], sz["cp"]),
            ("s_sh", sz["ssm"], sz["s"] + (sz["s"][1] + sz["steps"],)),
            ("d_tp", sz["tp_arch"], sz["tp"])):
        r0 = recs[0][key]
        toks = {tuple(map(tuple, rec[key]["tokens"].tolist()))
                for rec in recs}
        if len(toks) != 1:
            fail(f"sharded_serve ({key}): the ranks' tokens differ")
        # (d_sh)'s prefill is (p_sh)
        emit({"phase": "sharded_serve",
              "call": "p_sh" if key == "d_sh" else key, "arch": arch,
              "batch": B, "prompt": S, "slots": C, "rules": r0["rules"],
              "prefill": {"ms_events_slowest": (
                  max(rec[key]["prefill"]["event_ms"] for rec in recs)
                  if full else None),
                  "ms_host_slowest": max(rec[key]["prefill"]["host_ms"]
                                         for rec in recs),
                  "collective_bytes": r0["prefill"]["collective_bytes"],
                  "collective_host_ms": r0["prefill"]["collective_host_ms"]},
              "move": {"ms_host_slowest": max(rec[key]["move"]["host_ms"]
                                              for rec in recs),
                       "collective_bytes": r0["move"]["collective_bytes"]},
              "seconds_slowest": max(rec[key]["seconds"] for rec in recs),
              "card": card})
        for row in _step_rows(recs, key):
            emit({"phase": "sharded_serve", "call": key, **row})
            gathered = [b.get("all_gather", 0)
                        for b in row["collective_bytes_per_rank"]]
            if key in ("d_sh", "d_tp") and any(gathered):
                fail(f"sharded_serve ({key}): decode step {row['step']} "
                     f"all-gathers {gathered} B a rank, not 0: a "
                     f"'model'-split leaf was gathered")
        shard = [rec[key]["cache_bytes"] for rec in recs]
        pshard = [rec[key]["param_bytes"] for rec in recs]
        emit({"phase": "sharded_serve", "call": key,
              "cache_shard_bytes_per_rank": shard,
              "cache_bytes_by_specs": r0["cache_bytes_by_specs"],
              "cache_bytes_whole": r0["cache_bytes_whole"],
              "param_shard_bytes_per_rank": pshard,
              "param_bytes_by_specs": r0["param_bytes_by_specs"],
              "peak_allocated_per_rank": [rec[key].get("peak_allocated")
                                          for rec in recs]})
        if any(b != r0["cache_bytes_by_specs"] for b in shard):
            fail(f"sharded_serve ({key}): cache shard bytes {shard}, the "
                 f"specs divide {r0['cache_bytes_by_specs']}")
        if any(b != r0["param_bytes_by_specs"] for b in pshard):
            fail(f"sharded_serve ({key}): param shard bytes {pshard}, the "
                 f"specs divide {r0['param_bytes_by_specs']}")
        one = [rec[key] for rec in recs if "one_process_tokens" in rec[key]]
        if one:
            want = one[0]["one_process_tokens"]
            got = r0["tokens"][:, :want.shape[1]]
            emit({"phase": "sharded_serve", "call": key, "held": False,
                  "dtype": "bf16", "tokens_equal_one_process":
                      int((got == want).sum()), "tokens": got.numel(),
                  "first_parting_step": (int((got != want).any(0).nonzero()
                                             [0]) if bool((got != want).any())
                                         else None),
                  "prefill_logits_rel_err": one[0]["prefill_logits_rel_err"]})
        readings[key] = {"collective_bytes": [[s["collective_bytes"]
                                               for s in rec[key]["steps"]]
                                              for rec in recs],
                         "cache_bytes": shard, "batch": B, "slots": C}
        if key != "s_sh":
            readings[f"{key}:prefill"] = {
                "collective_bytes": [[rec[key]["prefill"]["collective_bytes"]]
                                     for rec in recs],
                "cache_bytes": None, "batch": B, "slots": S}
    parent = (torch.cuda.memory_reserved() if full else None)
    peaks = [rec["peak_reserved"] for rec in recs]
    emit({"phase": "sharded_serve", "call": "memory",
          "peak_allocated_per_rank": [rec["peak_bytes"] for rec in recs],
          "peak_reserved_per_rank": peaks, "parent_reserved": parent,
          "total_gb": (sum(peaks) + parent) / 1e9 if full else None})
    if full and sum(peaks) + parent >= 80e9:
        fail("sharded_serve: the ranks' and the parent's bytes pass 80 GB")
    secs = time.perf_counter() - t_phase
    emit({"phase": "sharded_serve", "phase_seconds": secs,
          "spawn_to_join_s": spawn_s,
          "witness_s_slowest": max(rec["witness_s"] for rec in recs),
          "s_witness_s_slowest": max(rec["s_witness_s"] for rec in recs),
          "pad_witness_s_slowest": max(rec["pad_witness"]["seconds"]
                                       for rec in recs),
          "tp_witness_s_slowest": max(rec["tp_witness_s"] for rec in recs),
          "d_tp_s_slowest": max(rec["d_tp"]["seconds"] for rec in recs),
          "one_process_s_slowest": max(rec["compare_s"] for rec in recs),
          "tp_one_process_s_slowest": max(rec["tp_compare_s"]
                                          for rec in recs),
          "card": card})
    if full and secs > SERVE_PHASE_LIMIT_S:
        fail(f"sharded_serve: phase 22 took {secs:.1f} s (limit "
             f"{SERVE_PHASE_LIMIT_S})")
    return secs, readings


# --------------------------------------------------------------------------
# 23. the pipeline: internlm2-1.8b's layers as four stages, differentiated
# --------------------------------------------------------------------------

PIPE_WORLD = 4                  # gloo ranks of phase 23, one stage each
PIPE_TIMEOUT_S = 300            # their process group and the join
PIPE_WITNESS_LIMIT = 1e-10      # (w_pp), float64, relative Frobenius
PIPE_PLANTED_FLOOR = 1e-3       # each planted fault reads above it


def pipeline_sizes(full: bool):
    """Phase 23's run: internlm2-1.8b at full width and depth (the reduced
    config at 4 layers in the rehearsal), 8 x 512 host-drawn tokens (8 x
    16), num_micro 4 over a (4, 1) ('pod', 'model') mesh, 2 forward and
    backward passes; (w_pp) one layer a stage in float64 on 4 x 128
    tokens (4 x 8)."""
    return {"arch": "internlm2-1.8b", "batch": 8, "seq": 512 if full else 16,
            "num_micro": 4, "steps": 2, "w_batch": 4,
            "w_seq": 128 if full else 8}


def _pipe_cfg(full: bool):
    """internlm2-1.8b, or its reduced config at 4 layers (one a stage)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(pipeline_sizes(full)["arch"], reduced=not full)
    return cfg if full else dataclasses.replace(cfg, num_layers=PIPE_WORLD)


def _pipe_stage(cfg, rules, positions):
    """The stage function: a stage's rows of the stacked layer leaves,
    each (G / S, P, ...), run as ``transformer.forward`` runs its groups
    (P sublayers, the fp32 residual sum passed between them, under
    ``maybe_remat`` when gradients are on)."""
    import types
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import maybe_remat, rope_angles
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def group(x, *ws):
        x_hi = None
        for layer in ws:
            x, x_hi = T._sublayer(x, x_hi, layer, cfg, rules, positions,
                                  None, layer.window, angles)
        return x

    def stage(params, x):
        G, P = next(iter(params.values())).shape[:2]
        cols = {n: w.reshape(G * P, *w.shape[2:]).unbind(0)
                for n, w in params.items()}
        layers = [types.SimpleNamespace(window=T._layer_window(cfg, l % P),
                                        **{n: c[l] for n, c in cols.items()})
                  for l in range(G * P)]
        body = maybe_remat(group, cfg) if torch.is_grad_enabled() else group
        for l0 in range(0, G * P, P):
            x = body(x, *layers[l0:l0 + P])
        return x
    return stage


def _positions(batch):
    """A batch's token positions (S,)."""
    import torch
    S = batch["tokens"].shape[1]
    return torch.arange(S, dtype=torch.int32, device=batch["tokens"].device)


def _pipe_loss(cfg, rules, outer, layers_fn, batch):
    """The model's loss with its layers run by ``layers_fn``: the
    embedding, the final norm and ``lm_head`` on this rank, as
    ``transformer.forward`` runs them.  Returns (loss, the layers' input,
    its gradient retained)."""
    from repro_torch import models as M
    from repro_torch.models.common import embed_tokens, lm_head, rms_norm
    x = embed_tokens(batch["tokens"], outer["embed"], rules,
                     scale=cfg.embed_scale, dtype=cfg.dtype)
    x.retain_grad()
    y = rms_norm(layers_fn(x), outer["final_norm"])
    head = outer["embed"].T if cfg.tie_embeddings else outer["head"]
    return M._xent(lm_head(y, head, cfg, rules), batch["labels"]), x


def _stage_leaves(layers, mesh, S: int, sid: int):
    """Each stacked layer leaf (G, P, ...) cut into S stages of G / S
    layers, this rank's stage as a DTensor sharded over 'pod' (local
    (1, G / S, P, ...)), a leaf of the graph."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {}
    for n, w in layers.items():
        local = w.detach().reshape(S, w.shape[0] // S, *w.shape[1:])[
            sid:sid + 1].clone()
        out[n] = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                                    run_check=False).requires_grad_()
    return out


def _frob(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def _pipe_grad_errs(cfg, rules, mesh, outer, sp, batch, nm: int, want):
    """Per leaf (this rank's stage rows of each layer leaf, the embedding,
    the final norm, the head) and for the layers' input ``x``, the
    relative Frobenius distance between the gradient through
    ``pipeline_apply`` and ``want``'s; and the losses' relative
    distance."""
    from repro_torch.distributed import pipeline_apply
    stage = _pipe_stage(cfg, rules, _positions(batch))
    loss, x = _pipe_loss(cfg, rules, outer, lambda x: pipeline_apply(
        stage, sp, x, mesh, axis="pod", num_micro=nm), batch)
    loss.backward()
    errs = {f"layers.{k}": _frob(v.grad.to_local()[0], want["layers"][k])
            for k, v in sp.items()}
    errs.update({k: _frob(v.grad, want[k]) for k, v in outer.items()})
    errs["x"] = _frob(x.grad, want["x"])
    errs["loss"] = (abs(float(loss.detach()) - want["loss"])
                    / abs(want["loss"]))
    for v in list(sp.values()) + list(outer.values()):
        v.grad = None
    return errs


def _pipe_witness(cfg, rules, mesh, params, batch, nm: int):
    """(w_pp): the float64 gradients through the pipeline against one
    process's autograd through the same layers unpipelined, run on the
    same micro-batches one after another (each rank computes it and
    compares its own stage), then the two planted faults (the broadcast's
    backward summing the output cotangents instead of averaging them; the
    backward's ring sending each cotangent to the next stage instead of
    the previous).  Printed beside them: how far that unpipelined
    gradient lies from the one of the whole batch in one pass (the
    model's own sensitivity to the split, not the pipeline's)."""
    import torch
    from repro_torch import models as M
    from repro_torch.distributed import pipeline as P
    S, sid = mesh.size(0), mesh.get_local_rank("pod")
    layers = {k: v.requires_grad_() for k, v in params["layers"].items()}
    outer = {k: v.requires_grad_() for k, v in params.items()
             if k != "layers"}
    stage = _pipe_stage(cfg, rules, _positions(batch))

    def unpipelined(split: int):
        for v in list(layers.values()) + list(outer.values()):
            v.grad = None
        loss, x = _pipe_loss(cfg, rules, outer, lambda x: torch.cat(
            [stage(layers, xm) for xm in x.chunk(split)]), batch)
        loss.backward()
        return {"loss": float(loss.detach()), "x": x.grad,
                "layers": {k: v.grad.reshape(S, v.shape[0] // S,
                                             *v.shape[1:])[sid].clone()
                           for k, v in layers.items()},
                **{k: v.grad for k, v in outer.items()}}
    whole = unpipelined(1)
    whole = {"x": whole["x"], **{f"layers.{k}": v
                                 for k, v in whole["layers"].items()}}
    want = unpipelined(nm)
    for v in list(layers.values()) + list(outer.values()):
        v.grad = None
    with torch.no_grad():
        model_loss = float(M.loss_fn(params, cfg, rules, batch))
    out = {"split": {k: _frob(v, want["x"] if k == "x" else
                              want["layers"][k[len("layers."):]])
                     for k, v in whole.items()},
           "loss_vs_model": abs(want["loss"] - model_loss) / abs(model_loss)}
    del whole
    sp = _stage_leaves(layers, mesh, S, sid)
    del layers, params["layers"]
    out["errs"] = _pipe_grad_errs(cfg, rules, mesh, outer, sp, batch, nm,
                                  want)
    reduce = P._output_cotangent
    P._output_cotangent = (lambda g, group, S, root: (
        lambda r: None if r is None else r * S)(reduce(g, group, S, root)))
    try:
        out["planted_sum"] = _pipe_grad_errs(cfg, rules, mesh, outer, sp,
                                             batch, nm, want)
    finally:
        P._output_cotangent = reduce
    shift = P._ring_shift
    P._ring_shift = (lambda y, group, sid, S, step=1:
                     shift(y, group, sid, S, 1))
    try:
        out["planted_neighbour"] = _pipe_grad_errs(cfg, rules, mesh, outer,
                                                   sp, batch, nm, want)
    finally:
        P._ring_shift = shift
    return out


def _timed(full: bool, fn):
    """``fn()``'s result, its host ms and its CUDA-event ms (None on the
    CPU)."""
    import torch
    if full:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        e0.record()
    t0 = time.perf_counter()
    res = fn()
    if full:
        e1.record()
        torch.cuda.synchronize()
    return (res, (time.perf_counter() - t0) * 1e3,
            e0.elapsed_time(e1) if full else None)


def _pipe_rank(rank: int, world: int, store: str, out: str, seed: int,
               full: bool):
    """One rank of phase 23 (a spawned process): gloo over a ``file://``
    store, the (4, 1) ('pod', 'model') mesh on the card, this rank one
    stage; (w_pp) the float64 witness at one layer a stage, (t_pp) the
    bf16 forward and backward at full depth, then rank 0's one-process
    forward and backward of the same layers and tokens.  Writes its
    record, or the exception, to ``out/pipe{r}.pkl``."""
    import dataclasses
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    record = {}
    try:
        import torch
        import torch.distributed as dist
        device = "cuda" if full else "cpu"
        if full:
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PIPE_TIMEOUT_S))
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import models as M
        from repro_torch.data import lm_batch
        from repro_torch.distributed import pipeline_apply, sharded
        from repro_torch.launch import RULES
        from repro_torch.tree import tree_map
        sz = pipeline_sizes(full)
        mesh = init_device_mesh(device, (world, 1),
                                mesh_dim_names=("pod", "model"))
        sid = mesh.get_local_rank("pod")
        cfg = _pipe_cfg(full)
        nm = sz["num_micro"]

        # (w_pp): one layer a stage, float64, held
        t0 = time.perf_counter()
        f64 = torch.float64
        cfg1 = dataclasses.replace(cfg, num_layers=world, dtype=f64,
                                   param_dtype=f64)
        batch = {k: v.to(device) for k, v in lm_batch(
            cfg1, seed=seed, step=0, batch=sz["w_batch"], seq=sz["w_seq"],
            device="cpu").items()}
        p1 = tree_map(lambda t: t.to(f64),
                      M.init_params(cfg1, seed, device=device))
        record["witness"] = _pipe_witness(cfg1, RULES, mesh, p1, batch, nm)
        del p1
        record["witness_s"] = time.perf_counter() - t0
        if full:
            torch.cuda.empty_cache()

        # (t_pp): full depth, bf16, this rank's stage
        params = M.init_params(cfg, seed, device=device)
        sp = _stage_leaves(params.pop("layers"), mesh, world, sid)
        outer = {k: v.requires_grad_() for k, v in params.items()}
        del params
        batch = {k: v.to(device) for k, v in lm_batch(
            cfg, seed=seed, step=0, batch=sz["batch"], seq=sz["seq"],
            device="cpu").items()}
        stage = _pipe_stage(cfg, RULES, _positions(batch))
        if full:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        def step():
            loss, _ = _pipe_loss(cfg, RULES, outer, lambda x: pipeline_apply(
                stage, sp, x, mesh, axis="pod", num_micro=nm), batch)
            loss.backward()
            return float(loss.detach())
        steps = []
        for i in range(sz["steps"]):
            for v in list(sp.values()) + list(outer.values()):
                v.grad = None
            dist.barrier()
            sharded.reset()
            loss, host_ms, event_ms = _timed(full, step)
            steps.append({"step": i, "host_ms": host_ms,
                          "event_ms": event_ms, "loss": loss,
                          "transfer_bytes": dict(sharded.BYTES),
                          "transfer_host_ms": {
                              k: v * 1e3 for k, v in sharded.SECONDS.items()}})
        record["steps"] = steps
        record["stage_bytes"] = sum(v.to_local().numel() * v.element_size()
                                    for v in sp.values())
        record["peak_bytes"] = (torch.cuda.max_memory_allocated() if full
                                else None)
        record["peak_reserved"] = (torch.cuda.max_memory_reserved() if full
                                   else None)
        del sp, outer
        if full:
            torch.cuda.empty_cache()

        # rank 0: one process's forward and backward of the same layers
        dist.barrier()
        if rank == 0:
            if full:
                torch.cuda.reset_peak_memory_stats()
            params = M.init_params(cfg, seed, device=device)
            leaves = tree_map(lambda v: v.requires_grad_(), params)
            layers = leaves.pop("layers")

            def one():
                loss, _ = _pipe_loss(cfg, RULES, leaves,
                                     lambda x: stage(layers, x), batch)
                loss.backward()
                return float(loss.detach())
            runs = []
            for i in range(sz["steps"]):
                for v in list(layers.values()) + list(leaves.values()):
                    v.grad = None
                loss, host_ms, event_ms = _timed(full, one)
                runs.append({"step": i, "host_ms": host_ms,
                             "event_ms": event_ms, "loss": loss})
            record["one_process"] = {
                "runs": runs, "peak_bytes": (torch.cuda.max_memory_allocated()
                                             if full else None)}
            del params, leaves, layers
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, f"pipe{rank}.pkl"), "wb") as f:
            pickle.dump(record, f)


def phase_pipeline(device: str, seed: int, card: str = "",
                   full: bool = True):
    """Phase 23: ``distributed.pipeline_apply`` trained through, on four
    gloo ranks sharing the card over a (4, 1) ('pod', 'model') mesh, one
    stage a rank: internlm2-1.8b's decoder layers as the stage function
    (6 layers a stage), the embedding and ``lm_head`` outside the pipeline
    on every rank.  (w_pp) one layer a stage in float64: every leaf's
    gradient and the layers' input's against one process's autograd
    through the same four layers unpipelined, on the same micro-batches,
    within 1e-10, the two planted faults above 1e-3 (the whole batch's
    gradient in one pass printed beside it); (t_pp) bf16 at full depth, 8 x 512 tokens,
    num_micro 4: each pass's ms on the slowest rank, the ring's and the
    broadcasts' bytes and host ms, each rank's peak, beside one process's
    unpipelined pass and the bound.  Returns the phase's seconds."""
    import pickle
    import tempfile
    import torch
    t_phase = time.perf_counter()
    sz = pipeline_sizes(full)
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="pipe_", dir=ROOT / "build")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_pipe_rank,
                         args=(r, PIPE_WORLD, f"{scratch}/store", scratch,
                               seed, full)) for r in range(PIPE_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + PIPE_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=30)
    spawn_s = time.perf_counter() - t0
    if hung:
        fail(f"pipeline: ranks {hung} did not finish in {PIPE_TIMEOUT_S} s")
    recs = []
    for r, p in enumerate(procs):
        path = os.path.join(scratch, f"pipe{r}.pkl")
        if not os.path.exists(path):
            fail(f"pipeline: rank {r} exited {p.exitcode} with no record")
        with open(path, "rb") as f:
            recs.append(pickle.load(f))
        if "error" in recs[-1] or p.exitcode != 0:
            fail(f"pipeline: rank {r} exited {p.exitcode}:\n"
                 f"{recs[-1].get('error', '')}")
    shutil.rmtree(scratch, ignore_errors=True)

    def worst(key):
        return {k: max(rec["witness"][key][k] for rec in recs)
                for k in recs[0]["witness"][key]}
    errs = worst("errs")
    planted = {k: max(worst(k).values())
               for k in ("planted_sum", "planted_neighbour")}
    max_err = max(errs.values())
    emit({"phase": "pipeline", "call": "w_pp", "arch": sz["arch"],
          "layers": PIPE_WORLD, "layers_a_stage": 1, "dtype": "float64",
          "mesh": "(4, 1) ('pod', 'model')", "ranks": PIPE_WORLD,
          "backend": "gloo", "tokens": [sz["w_batch"], sz["w_seq"]],
          "num_micro": sz["num_micro"], "rel_err": errs,
          "max_rel_err": max_err, "limit": PIPE_WITNESS_LIMIT,
          "loss_vs_model": max(rec["witness"]["loss_vs_model"]
                               for rec in recs),
          # printed: the unpipelined gradient of the micro-batches against
          # the whole batch's in one pass
          "split_vs_whole_batch": max(max(rec["witness"]["split"].values())
                                      for rec in recs), **planted,
          "planted_floor": PIPE_PLANTED_FLOOR})
    if not max_err <= PIPE_WITNESS_LIMIT:
        fail(f"pipeline (w_pp): the float64 gradients part from the "
             f"unpipelined ones by {max_err:.3e}")
    for k, v in planted.items():
        if not v > PIPE_PLANTED_FLOOR:
            fail(f"pipeline (w_pp): planted fault {k} reads {v:.3e}")

    cfg = _pipe_cfg(full)
    ops_ms, parts, _ = train_bounds(cfg, sz["batch"], sz["seq"])
    layers_ms = parts["layer_products_bf16_ms"] + parts["attention_fp32_ms"]
    S, nm = PIPE_WORLD, sz["num_micro"]
    for i in range(sz["steps"]):
        rows = [rec["steps"][i] for rec in recs]
        emit({"phase": "pipeline", "call": "t_pp", "step": i,
              "arch": sz["arch"], "layers": cfg.num_layers,
              "layers_a_stage": cfg.num_layers // S, "dtype": "bf16",
              "tokens": [sz["batch"], sz["seq"]], "num_micro": nm,
              "ms_events_slowest": (max(r["event_ms"] for r in rows)
                                    if full else None),
              "ms_host_slowest": max(r["host_ms"] for r in rows),
              "losses_equal": len({r["loss"] for r in rows}) == 1,
              "loss": rows[0]["loss"],
              "transfer_bytes_per_rank": [r["transfer_bytes"] for r in rows],
              "transfer_host_ms_slowest": {
                  k: max(r["transfer_host_ms"].get(k, 0.0) for r in rows)
                  for k in rows[0]["transfer_host_ms"]}, "card": card})
    one = recs[0]["one_process"]
    for run in one["runs"]:
        emit({"phase": "pipeline", "call": "t_pp_one_process", **run,
              "card": card})
    emit({"phase": "pipeline", "call": "t_pp", "memory": True,
          "stage_bytes_per_rank": [rec["stage_bytes"] for rec in recs],
          "peak_allocated_per_rank": [rec["peak_bytes"] for rec in recs],
          "peak_reserved_per_rank": [rec["peak_reserved"] for rec in recs],
          "one_process_peak_allocated": one["peak_bytes"]})
    emit({"phase": "pipeline", "call": "t_pp", "bound": True,
          # every product x3 for the backward; the card shared by the four
          # ranks, each running the head: their sum is the card's work
          "layers_bound_ms": layers_ms,
          "layer_products_bf16_ms": parts["layer_products_bf16_ms"],
          "attention_fp32_ms": parts["attention_fp32_ms"],
          "lm_head_bf16_ms": parts["lm_head_bf16_ms"],
          "shared_card_bound_ms": layers_ms
          + S * parts["lm_head_bf16_ms"],
          "one_process_bound_ms": ops_ms,
          # a card a stage: num_micro + S - 1 slots of one micro-batch's
          # stage each, the bubble (S - 1) / (num_micro + S - 1)
          "card_a_stage_bound_ms": layers_ms * (nm + S - 1) / (nm * S)
          + parts["lm_head_bf16_ms"],
          "bubble": (S - 1) / (nm + S - 1)})
    secs = time.perf_counter() - t_phase
    emit({"phase": "pipeline", "phase_seconds": secs,
          "spawn_to_join_s": spawn_s,
          "witness_s_slowest": max(rec["witness_s"] for rec in recs),
          "card": card})
    return secs


# --------------------------------------------------------------------------
# 21. the dry run: each cell's sharded step traced on meta tensors
# --------------------------------------------------------------------------

DRYRUN_TIMEOUT_S = 240          # the dry runs' process
# (dr_pod): (arch, shape, multi_pod) traced or placed on the production mesh
DRYRUN_POD_CELLS = (("arctic-480b", "train_4k", True),
                    ("recurrentgemma-9b", "long_500k", False),
                    ("gemma-2b", "decode_32k", False))
PAPER_TIE_RTOL = 1e-5           # a proven near-tie: float64 distances


def paper_sizes(full: bool):
    """(dr_paper): one rank's shard of the paper cell on (16, 16), 2^30 /
    256 = 4,194,304 x 64 fp32 (4,096 rows in the rehearsal), k' = 2,048,
    exact GMM (B2) and b = 8 (B1), kernel and plain in turns."""
    return {"rows": 4194304 if full else 4096, "dim": 64, "kprime": 2048,
            "b": (0, 8), "order": ("auto", False, False, "auto") if full
            else ("auto", False)}


def _dryrun_child(out: str, full: bool):
    """Phase 21's dry runs, in a spawned process of their own, so that its
    fake process group never meets phase 20's gloo ranks: (dr_sh) phase
    20's cell (``sharded_sizes``: the mesh, the config, the batch) and,
    at full size, (dr_pod) the ``DRYRUN_POD_CELLS`` on their production
    meshes.  Writes its record, or the exception, to ``out/dryrun.pkl``."""
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    record = {}
    try:
        import torch
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeCell
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        sz = sharded_sizes(full)
        cfg = get_config(sz["arch"], reduced=sz["reduced"])
        model = sz["model_axis"]
        with dryrun.fake_group(SHARDED_WORLD):
            mesh = init_device_mesh("cpu", (SHARDED_WORLD // model, model),
                                    mesh_dim_names=("data", "model"))
            trace, meta = dryrun.lower_config(
                cfg, ShapeCell("train", "train", sz["seq"], sz["batch"]),
                mesh)
        record["dr_sh"] = {**dryrun.analyze(trace), **meta}
        # (dr_sv): phase 22's decode cells, (d_sh), (cp_sh) and (d_tp),
        # and their prefills, cells of the prompt's length (a prefill's
        # collectives carry its prompt's activations)
        ssz = sharded_serve_sizes(full)
        scfg = _serve_cfg(ssz["arch"], ssz["reduced"])
        tcfg = _serve_cfg(ssz["tp_arch"], ssz["reduced"])
        record["dr_sv"] = {}
        for key, size, c in (("d_sh", "d", scfg), ("cp_sh", "cp", scfg),
                             ("d_tp", "tp", tcfg)):
            B, S, C = ssz[size]
            for kind, cell in (("decode", ShapeCell("decode", "decode", C,
                                                    B)),
                               ("prefill", ShapeCell("prefill", "prefill",
                                                     S, B))):
                with dryrun.fake_group(SHARDED_WORLD):
                    mesh = init_device_mesh(
                        "cpu", (SHARDED_WORLD // model, model),
                        mesh_dim_names=("data", "model"))
                    trace, meta = dryrun.lower_config(c, cell, mesh)
                name = key if kind == "decode" else f"{key}:prefill"
                record["dr_sv"][name] = {**dryrun.analyze(trace), **meta}
        record["dr_pod"] = []
        for arch, shape, multi_pod in (DRYRUN_POD_CELLS if full else ()):
            with dryrun.fake_group(512 if multi_pod else 256):
                trace, meta = dryrun.lower_cell(
                    arch, shape, make_production_mesh(multi_pod=multi_pod))
            record["dr_pod"].append({**dryrun.analyze(trace), **meta,
                                     "multi_pod": multi_pod,
                                     "torch": torch.__version__})
    except Exception:
        record["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out, "dryrun.pkl"), "wb") as f:
            pickle.dump(record, f)


def _paper_run(shard, kprime: int, b: int, use_pallas):
    """One GMM run of the paper cell's round 1 on ``shard``: exact GMM
    (b = 0) or ``gmm_batched`` with ``b`` centers a sweep.  Returns
    (picks on the host, radius, seconds, launches)."""
    import torch
    from repro_torch.core.gmm import gmm, gmm_batched
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    if b:
        idx, radius, _ = gmm_batched(shard, kprime, b=b, metric="euclidean",
                                     use_pallas=use_pallas)
    else:
        res = gmm(shard, kprime, metric="euclidean", use_pallas=use_pallas)
        idx, radius = res.idx, res.radius
    idx, radius = idx.cpu().numpy(), float(radius)
    if shard.is_cuda:
        torch.cuda.synchronize()
    return idx, radius, time.perf_counter() - t0, dict(ops.LAUNCHES)


def _first_parting(shard_np, a, b):
    """The first pick where the index arrays ``a`` and ``b`` part, with
    the float64 distances of both picks to the picks before it (a proven
    near-tie when they agree within ``PAPER_TIE_RTOL``), or None."""
    import numpy as np
    differ = np.flatnonzero(a != b)
    if not len(differ):
        return None
    i = int(differ[0])
    prefix = shard_np[a[:i]].astype(np.float64)
    dist = [float(np.sqrt(((prefix - shard_np[j].astype(np.float64)) ** 2)
                          .sum(axis=1).min())) for j in (a[i], b[i])]
    return {"at": i, "float64_distances": dist,
            "proven_near_tie": abs(dist[0] - dist[1])
            <= PAPER_TIE_RTOL * max(dist)}


def start_dryruns(full: bool):
    """Phase 21's dry runs (``_dryrun_child``) started at once in a spawned
    process of their own: they need no card, so they run on the CPU
    beside phases 20 and 22 (one thread), and ``phase_dryrun`` joins
    them.  Returns (the process, its directory, its start time)."""
    import tempfile
    import torch
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build")
    proc = torch.multiprocessing.get_context("spawn").Process(
        target=_dryrun_child, args=(scratch, full), daemon=True)
    proc.start()
    return proc, scratch, time.monotonic()


def phase_dryrun(device: str, seed: int, sharded: dict, serve: dict,
                 dry, card: str = "", full: bool = True):
    """Phase 21: (dr_sh) the dry run of phase 20's cell in a spawned
    process: its collective bytes of a step must equal every rank's
    per-step ``sharded.BYTES`` that phase 20 read in this run, and its
    shard bytes each rank's, to the byte (its peak estimate printed
    beside the ranks' measured peaks); (dr_sv) the dry runs of phase
    22's (d_sh), (cp_sh) and (d_tp) decode cells, held likewise to every
    decode step of phase 22 and each rank's cache shard bytes, and of
    their prefills (cells of the prompt's length), held to each rank's
    prefill; (dr_pod) at full
    size, the
    ``DRYRUN_POD_CELLS`` on the card machine's torch, a JSON line each
    with its trace seconds; (dr_paper) one rank of the paper cell at its
    real size, exact GMM through B2 and b = 8 through B1, kernel and plain
    in turns, picks equal up to a proven near-tie and the radius within
    rtol ``RTOL_E2E``, seconds beside the bytes bound of its sweeps.
    ``dry`` is ``start_dryruns``'s process, joined here.  Returns the
    kernel runs' launches and the sweeps' largest errors against plain."""
    import pickle

    import numpy as np
    import torch
    from repro_torch.launch.dryrun import KINDS as names, sweep_bytes
    t_phase = time.perf_counter()
    proc, scratch, started = dry
    proc.join(timeout=max(1.0, started + DRYRUN_TIMEOUT_S - time.monotonic()))
    emit({"phase": "dryrun", "dry_runs_joined_after_s":
          time.monotonic() - started})
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=30)
        fail(f"dryrun: the dry runs did not finish in {DRYRUN_TIMEOUT_S} s")
    path = os.path.join(scratch, "dryrun.pkl")
    if not os.path.exists(path):
        fail(f"dryrun: the dry runs exited {proc.exitcode} with no record")
    with open(path, "rb") as f:
        rec = pickle.load(f)
    shutil.rmtree(scratch, ignore_errors=True)
    if "error" in rec or proc.exitcode != 0:
        fail(f"dryrun: exited {proc.exitcode}:\n{rec.get('error', '')}")

    # (dr_sh): the trace against phase 20's ranks, to the byte
    dr = rec["dr_sh"]
    want = {k: v for k, v in dr["collective_bytes_per_device"].items() if v}
    differ = [(r, i, got) for r, steps in enumerate(sharded["collective_bytes"])
              for i, got in enumerate(
                  {names[k]: v for k, v in step.items()} for step in steps)
              if got != want]
    shard_want = {"params": dr["argument_bytes_by_tree"]["params"],
                  "state": dr["argument_bytes_by_tree"]["opt_state"]}
    shard_differ = [r for r, got in enumerate(sharded["shard_bytes"])
                    if got != shard_want]
    emit({"phase": "dryrun", "call": "dr_sh", "arch": dr["arch"],
          "mesh": "(2, 2) ('data', 'model')", "chips": dr["chips"],
          "collective_bytes_per_device": dr["collective_bytes_per_device"],
          "phase_20_per_rank_step_0": [
              {names[k]: v for k, v in steps[0].items()}
              for steps in sharded["collective_bytes"]],
          "steps_compared": sum(map(len, sharded["collective_bytes"])),
          "equal": not differ,
          "shard_bytes": shard_want,
          "phase_20_shard_bytes": sharded["shard_bytes"],
          "shard_bytes_equal": not shard_differ,
          "flops_per_device": dr["flops_per_device"],
          "argument_bytes": dr["argument_bytes"],
          "peak_bytes_estimate": dr["peak_bytes"],
          "phase_20_peak_allocated_per_rank": sharded["peak_allocated"],
          "trace_s": dr["trace_s"]})
    if differ:
        fail(f"dryrun (dr_sh): the trace reckons {want}, phase 20's ranks "
             f"counted otherwise: {differ[:3]}")
    if shard_differ:
        fail(f"dryrun (dr_sh): shard bytes {shard_want}, phase 20's ranks "
             f"{[sharded['shard_bytes'][r] for r in shard_differ]}")

    # (dr_sv): phase 22's decode cells and prefills against its ranks, to
    # the byte (a prefill cell's cache is the prompt's: not compared)
    for key, dr in rec["dr_sv"].items():
        want = {k: v for k, v in dr["collective_bytes_per_device"].items()
                if v}
        got = serve[key]
        differ = [(r, i, step) for r, steps in enumerate(
            got["collective_bytes"]) for i, step in enumerate(
            {names[k]: v for k, v in st.items()} for st in steps)
            if step != want]
        cache_want = dr["argument_bytes_by_tree"]["cache"]
        emit({"phase": "dryrun", "call": "dr_sv", "cell": key,
              "arch": dr["arch"], "batch": got["batch"],
              "slots": got["slots"], "rules": {
                  k: dr["rules"][k] for k in ("batch", "kv_seq", "fsdp")},
              "collective_bytes_per_device": dr["collective_bytes_per_device"],
              "phase_22_per_rank_step_0": [
                  {names[k]: v for k, v in steps[0].items()}
                  for steps in got["collective_bytes"]],
              "steps_compared": sum(map(len, got["collective_bytes"])),
              "equal": not differ, "cache_shard_bytes": cache_want,
              "phase_22_cache_shard_bytes": got["cache_bytes"],
              "flops_per_device": dr["flops_per_device"],
              "peak_bytes_estimate": dr["peak_bytes"],
              "trace_s": dr["trace_s"]})
        if differ:
            fail(f"dryrun (dr_sv) {key}: the trace reckons {want}, phase "
                 f"22's ranks counted otherwise: {differ[:3]}")
        if got["cache_bytes"] is not None and any(
                b != cache_want for b in got["cache_bytes"]):
            fail(f"dryrun (dr_sv) {key}: cache shard bytes {cache_want}, "
                 f"phase 22's ranks {got['cache_bytes']}")

    # (dr_pod): the production meshes on this machine's torch
    for info in rec["dr_pod"]:
        emit({"phase": "dryrun", "call": "dr_pod", **{
            k: info[k] for k in (
                "arch", "shape", "multi_pod", "chips", "valid", "invalid",
                "flops_per_device", "collective_bytes_per_device",
                "collective_total", "argument_bytes",
                "argument_bytes_by_tree", "peak_bytes", "null_reason",
                "params", "active_ratio", "trace_s", "torch")}})
        if not info["valid"] or info["null_reason"] is not None or (
                info["flops_per_device"] is None):
            fail(f"dryrun (dr_pod): {info['arch']} x {info['shape']}: "
                 f"valid {info['valid']}, {info['null_reason']}")

    # (dr_paper): one rank of the paper cell, kernel and plain in turns
    sz = paper_sizes(full)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 211)
    shard_np = rng.standard_normal((sz["rows"], sz["dim"]), dtype=np.float32)
    shard = torch.from_numpy(shard_np).to(device)
    if shard.is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    emit({"phase": "data", "paper_shard": list(shard.shape),
          "gb": shard.numel() * 4 / 1e9, "seed": seed + 211,
          "fingerprint": {"sum": float(shard_np.sum(dtype=np.float64)),
                          "sha256_first_rows": hashlib.sha256(
                              shard_np[:64].tobytes()).hexdigest()[:16]},
          "seconds": time.perf_counter() - t0})
    launches = dict.fromkeys(KERNELS, 0)
    for b in sz["b"]:
        wrapper = "gmm_topb" if b else "gmm_update_select"
        runs = {"auto": [], False: []}
        for use_pallas in sz["order"]:
            runs[use_pallas].append(_paper_run(shard, sz["kprime"], b,
                                               use_pallas))
        (kidx, kr, _, kl), (pidx, pr, _, _) = runs["auto"][0], runs[False][0]
        for side in runs.values():
            if any(not np.array_equal(i, side[0][0]) or r != side[0][1]
                   for i, r, _, _ in side[1:]):
                fail(f"dryrun (dr_paper) b={b}: a repeated run gave another "
                     f"answer")
        sweeps = sz["kprime"] if not b else sz["kprime"] // b + 1
        parting = _first_parting(shard_np, kidx, pidx)
        bound_s = sweeps * sweep_bytes(sz["rows"], sz["dim"]) / HBM_BYTES_PER_S
        emit({"phase": "dryrun", "call": "dr_paper", "b": b or 1,
              "rows": sz["rows"], "dim": sz["dim"], "kprime": sz["kprime"],
              "kernel": wrapper, "sweeps": sweeps,
              "kernel_launches": kl[wrapper],
              "kernel_seconds": _spread([r[2] for r in runs["auto"]]),
              "plain_seconds": _spread([r[2] for r in runs[False]]),
              "bound_s": bound_s, "bound_by": "bytes",
              "sweep_bytes": sweep_bytes(sz["rows"], sz["dim"]),
              "radius": [kr, pr], "identical_picks": int(
                  len(np.intersect1d(kidx, pidx))),
              "first_parting": parting,
              "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                          / 1e9 if shard.is_cuda else None),
              "card": card})
        if parting is not None and not parting["proven_near_tie"]:
            fail(f"dryrun (dr_paper) b={b}: kernel and plain part at pick "
                 f"{parting['at']}, not at a near-tie: {parting}")
        if not np.isclose(kr, pr, rtol=RTOL_E2E, atol=0.0):
            fail(f"dryrun (dr_paper) b={b}: radius kernel {kr} vs plain {pr}")
        if any(any(r[3].values()) for r in runs[False]):
            fail(f"dryrun (dr_paper) b={b}: a kernel launched on a plain run")
        if shard.is_cuda and kl[wrapper] != sweeps:
            fail(f"dryrun (dr_paper) b={b}: {kl[wrapper]} {wrapper} "
                 f"launches, {sweeps} sweeps")
        launches[wrapper] += kl[wrapper]
    errs = dict.fromkeys(KERNELS, 0.0)
    if shard.is_cuda:
        # the runs' main sweeps at this shape, as phase 7 times the probes:
        # held against plain, the kernel's device ms a launch, the call's
        # and the plain version's ms, the bound
        phase_times_sweeps([("(dr_paper) shard", shard, "euclidean",
                             [("gmm_update_select", 1, 1, sz["kprime"]),
                              ("gmm_topb", 8, 32, sz["kprime"] // 8 - 1)])],
                           seed, errs)
    del shard
    secs = time.perf_counter() - t_phase
    emit({"phase": "dryrun", "phase_seconds": secs, "card": card})
    if full and secs > 90:
        fail(f"dryrun: phase 21 took {secs:.1f} s (limit 90)")
    return launches, errs


def probe_only(seed: int, runs: int) -> int:
    """Call (i) ``runs`` times with the kernels: its ``mr.probe`` span and
    call seconds and its B1 launches, one JSON line a run."""
    import torch
    from repro_torch.kernels import build
    card = nvidia_smi()
    build.library()
    x = musixmatch_like(237662, 5000, seed, "cuda")
    torch.cuda.synchronize()
    name, _, problem, knobs, _, _ = mapreduce_calls(True)[0]
    for r in range(runs):
        res, _, secs, launches = _run_mr(x, None, problem, knobs, "auto",
                                         "cuda")
        emit({"phase": "probe_only", "call": name, "run": r, "card": card,
              "sweep_source_sha256": hashlib.sha256(
                  (SRC / "repro_torch" / "kernels" / "csrc" / "gmm_sweep.cu")
                  .read_bytes()).hexdigest()[:16],
              "probe_s": _span_seconds(res.telemetry, "mr.probe"),
              "call_s": secs, "b1_launches": launches["gmm_topb"],
              "b_schedule": list(map(list, res.cert.b_schedule))})
    return 0


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of phases 2-6 and 9-23 with the "
                         "plain versions")
    ap.add_argument("--probe-only", type=int, default=0, metavar="RUNS",
                    help="run call (i) RUNS times on the card, print its "
                         "probe seconds and stop")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the CUDA port on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    if args.probe_only:
        torch.backends.cuda.matmul.allow_tf32 = False
        return probe_only(args.seed, args.probe_only)

    if args.rehearse:
        data = {"mxm": musixmatch_like(3000, 64, args.seed, "cpu"),
                "sphere": unit_sphere(20000, args.seed, "cpu")}
        errs, diffs = phase_kernels(
            data["mxm"], args.seed, small_only=True,
            tiles=stream_tiles(data["mxm"], data["sphere"], REHEARSAL_TILES))
        phase_main(data["mxm"], "cpu", check_launches=False, pairs=2)
        phase_stream(data, "cpu", check_launches=False, runs=1, full=False)
        genres = genre_labels(3000, GROUPS, args.seed, "cpu")
        phase_constrained(data["mxm"], genres, "cpu", check_launches=False,
                          runs=1, full=False)
        phase_mapreduce(dict(data, genres=genres), "cpu",
                        check_launches=False, full=False)
        cfg = serving_calls(False)
        data.update(serving_data(cfg, args.seed, "cpu"))
        phase_serving(data, "cpu", check_launches=False, runs=1, full=False,
                      seed=args.seed)
        phase_resilience(data, "cpu", full=False)
        phase_dynamic(data, "cpu", full=False, seed=args.seed)
        _, _, mesh_b4 = phase_mesh(data["mxm"], genres, "cpu", args.seed,
                                   errs, diffs, full=False)
        _, serve_b4, _ = phase_serve("cpu", args.seed, errs, diffs,
                                     full=False, check_launches=False)
        _, train_b4, _ = phase_train("cpu", args.seed, errs, diffs,
                                     full=False, check_launches=False)
        _, moe_b4 = phase_moe("cpu", args.seed, errs, diffs, full=False,
                              check_launches=False)
        t0 = time.perf_counter()
        _, vlm_b4 = phase_vlm("cpu", args.seed, errs, diffs, full=False,
                              check_launches=False)
        _, ssm_b4 = phase_ssm("cpu", args.seed, errs, diffs, full=False,
                              check_launches=False)
        emit({"phase": "rehearsal", "phases_16_17_seconds":
              time.perf_counter() - t0})
        t0 = time.perf_counter()
        _, hyb_b4 = phase_hybrid("cpu", args.seed, errs, diffs, full=False,
                                 check_launches=False)
        _, enc_b4 = phase_encdec("cpu", args.seed, errs, diffs, full=False,
                                 check_launches=False)
        emit({"phase": "rehearsal", "phases_18_19_seconds":
              time.perf_counter() - t0})
        dry = start_dryruns(full=False)
        secs, sharded = phase_sharded("cpu", args.seed, full=False)
        emit({"phase": "rehearsal", "phase_20_seconds": secs})
        secs, serve = phase_sharded_serve("cpu", args.seed, full=False)
        emit({"phase": "rehearsal", "phase_22_seconds": secs})
        secs = phase_pipeline("cpu", args.seed, full=False)
        emit({"phase": "rehearsal", "phase_23_seconds": secs})
        t0 = time.perf_counter()
        phase_dryrun("cpu", args.seed, sharded, serve, dry, full=False)
        emit({"phase": "rehearsal", "phase_21_seconds":
              time.perf_counter() - t0})
        phase_times_round1(mesh_b4 + serve_b4 + train_b4 + moe_b4 + vlm_b4
                           + ssm_b4 + hyb_b4 + enc_b4, args.seed, errs,
                           diffs, timed=False)
        emit({"phase": "rehearsal", "ok": True})
        return 0

    # ---- 1. env + build ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    dry = start_dryruns(full=True)      # phase 21's, on the CPU meanwhile
    build.library()
    out = ROOT / "chiprun_out"      # long reports: ptxas, profile
    out.mkdir(parents=True, exist_ok=True)
    (out / "nvcc_build.log").write_text(build.BUILD_INFO["log"])
    emit({"phase": "env", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "build_seconds": build.BUILD_INFO["seconds"],
          "build_cached": build.BUILD_INFO["cached"]})

    # ---- 20. sharded training, while the parent holds nothing on the card
    _, sharded = phase_sharded("cuda", args.seed, card=card)
    emit({"phase": "sharded", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- 22. sharded serving, while the parent still holds nothing ---------
    _, serve = phase_sharded_serve("cuda", args.seed, card=card)
    emit({"phase": "sharded_serve", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- 23. the pipeline's backward, while the parent still holds nothing
    phase_pipeline("cuda", args.seed, card=card)
    emit({"phase": "pipeline", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- 21. the dry run, held to phases 20's and 22's readings -------------
    dry_launches, dry_errs = phase_dryrun("cuda", args.seed, sharded, serve,
                                          dry, card=card)
    torch.cuda.empty_cache()
    emit({"phase": "dryrun", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- data -------------------------------------------------------------
    t0 = time.perf_counter()
    x = musixmatch_like(237662, 5000, args.seed, "cuda")
    sphere = unit_sphere(2 ** 24, args.seed, "cuda")
    torch.cuda.synchronize()
    nnz = (x > 0).sum(dim=1).float()
    emit({"phase": "data", "shape": list(x.shape), "seed": args.seed,
          "gb": x.numel() * 4 / 1e9,
          "words_per_row": [float(nnz.min()), float(nnz.mean()),
                            float(nnz.max())],
          "fingerprint": mxm_fingerprint(x),
          "sphere_shape": list(sphere.shape),
          "sphere_sum": float(sphere.sum(dtype=torch.float64)),
          "sphere_gb": sphere.numel() * 4 / 1e9,
          "seconds": time.perf_counter() - t0})
    tiles = stream_tiles(x, sphere, STREAM_TILES)

    # ---- 2. kernels vs plain ---------------------------------------------
    errs, diffs = phase_kernels(x, args.seed, small_only=False, tiles=tiles,
                                out=out)
    for k, v in dry_errs.items():
        errs[k] = max(errs[k], v)
    torch.cuda.empty_cache()

    # ---- 3. batch path, 4. streaming path -------------------------------
    launches, main_s = phase_main(x, "cuda", check_launches=True)
    for k, v in dry_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    s_launches, stream_s = phase_stream({"mxm": x, "sphere": sphere},
                                        "cuda", check_launches=True)
    for k, v in s_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 5. constrained path --------------------------------------------
    genres = genre_labels(x.shape[0], GROUPS, args.seed, "cuda")
    emit({"phase": "data", "genres": GROUPS,
          "fingerprint": labels_fingerprint(genres)})
    c_launches, constrained_s = phase_constrained(x, genres, "cuda",
                                                  check_launches=True)
    for k, v in c_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 6. MapReduce path -----------------------------------------------
    m_launches, mr_s = phase_mapreduce(
        {"mxm": x, "sphere": sphere, "genres": genres}, "cuda",
        check_launches=True)
    for k, v in m_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 9. serving, 10. resilience ----------------------------------------
    t0 = time.perf_counter()
    serving = serving_data(serving_calls(True), args.seed, "cuda")
    torch.cuda.synchronize()
    emit({"phase": "data", "serving_shape": list(serving["serving"].shape),
          "serving_gb": serving["serving"].numel() * 4 / 1e9,
          "sessions": [len(serving["sessions"]),
                       len(serving["sessions"][0]),
                       list(serving["sessions"][0][0].shape)],
          "seconds": time.perf_counter() - t0})
    v_launches, serve_s = phase_serving(serving, "cuda", check_launches=True,
                                        seed=args.seed)
    for k, v in v_launches.items():
        launches[k] += v
    del serving["serving_ragged"], serving["sessions"]
    torch.cuda.empty_cache()
    r_launches, _ = phase_resilience(
        {"mxm": x, "sphere": sphere}, "cuda")
    for k, v in r_launches.items():
        launches[k] += v
    FIRST.clear()
    torch.cuda.empty_cache()

    # ---- 11. dynamic -------------------------------------------------------
    y_launches, dyn_s, dyn_keep = phase_dynamic({"mxm": x}, "cuda",
                                                seed=args.seed)
    for k, v in y_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()

    # ---- 12. mesh ----------------------------------------------------------
    t0 = time.perf_counter()
    z_launches, _, mesh_b4 = phase_mesh(x, genres, "cuda", args.seed, errs,
                                        diffs)
    for k, v in z_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})

    # ---- 13. serve ---------------------------------------------------------
    e_launches, serve_b4, serve_keep = phase_serve("cuda", args.seed, errs,
                                                   diffs, card=card)
    for k, v in e_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "serve", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- 14. train ---------------------------------------------------------
    t_launches, train_b4, train_keep = phase_train("cuda", args.seed, errs,
                                                   diffs, card=card)
    for k, v in t_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    # phase 8's trace of one (z) step, taken here so that phase 15 does not
    # sit beside phase 14's model and optimizer state
    phase_profile(train_keep["profile"](), "train_z_step", out,
                  train_keep["step_s"])
    del train_keep
    torch.cuda.empty_cache()
    emit({"phase": "train", "script_seconds_so_far":
          time.perf_counter() - t_start})

    # ---- 15. MoE -----------------------------------------------------------
    t0 = time.perf_counter()
    x_launches, moe_b4 = phase_moe("cuda", args.seed, errs, diffs, card=card,
                                   out=out)
    for k, v in x_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "moe", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})

    # ---- 16. vlm, 17. ssm ----------------------------------------------------
    t0 = time.perf_counter()
    v_launches, vlm_b4 = phase_vlm("cuda", args.seed, errs, diffs,
                                   card=card, out=out)
    for k, v in v_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "vlm", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})
    t0 = time.perf_counter()
    s_launches, ssm_b4 = phase_ssm("cuda", args.seed, errs, diffs, card=card,
                                   out=out)
    for k, v in s_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "ssm", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})

    # ---- 18. hybrid, 19. encdec ----------------------------------------------
    t0 = time.perf_counter()
    h_launches, hyb_b4 = phase_hybrid("cuda", args.seed, errs, diffs,
                                      card=card, out=out)
    for k, v in h_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "hybrid", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})
    t0 = time.perf_counter()
    d_launches, enc_b4 = phase_encdec("cuda", args.seed, errs, diffs,
                                      card=card, out=out)
    for k, v in d_launches.items():
        launches[k] += v
    torch.cuda.empty_cache()
    emit({"phase": "encdec", "phase_seconds": time.perf_counter() - t0,
          "script_seconds_so_far": time.perf_counter() - t_start})

    # ---- 7. times, 8. profile ---------------------------------------------
    rows = phase_times(x, args.seed)
    sweep_rows = phase_times_sweeps(sweep_cases(x, sphere, train_b4,
                                                serve_b4), args.seed, errs)
    g_rows = phase_times_grouped(x, genres, args.seed)
    b4_cases = set(diffs["gmm_grouped_topb"])
    requests = serving.pop("serving")
    phase_times_round1(round1_cases(x, sphere, genres, serving=requests,
                                    mesh=mesh_b4 + serve_b4 + train_b4
                                    + moe_b4 + vlm_b4 + ssm_b4 + hyb_b4
                                    + enc_b4),
                       args.seed, errs, diffs)
    del serve_b4, train_b4, moe_b4, vlm_b4, ssm_b4, hyb_b4, enc_b4
    (out / "kernel_differing_entries.json").write_text(
        json.dumps(diffs, indent=1))
    round1 = {c: v for c, v in diffs["gmm_grouped_topb"].items()
              if c not in b4_cases}
    emit({"phase": "differing_entries", "kernel": "gmm_grouped_topb",
          "at": "round-1 (simulated and mesh) and serving shapes, "
                "phase 13's pool and fused solve, phase 14's curation, "
                "phase 15's curation and fused solve, phase 16's fused "
                "solve, phase 17's curation and fused solve, phase 18's "
                "curation and fused solve, phase 19's fused solve",
          "cases": len(round1),
          "counts": list(round1.values())})
    far = x.shape[0] // 2
    b_rows = phase_times_pairwise(tiles + [(
        "stream tile 4096x1025x5000 euclidean", x[:4096],
        x[far:far + 1025], "euclidean")])
    import repro_torch
    phase_profile(lambda: repro_torch.diversify(
        x, k=16, metric="cosine",
        execution=repro_torch.ExecutionSpec(device="cuda")).indices,
        "batch_a_cosine_defaults", out, main_s["a_cosine_defaults"])
    _, kind, problem, knobs = stream_calls(True)[1]
    phase_profile(lambda: repro_torch.diversify(
        x, execution=repro_torch.ExecutionSpec(
            mode="streaming", device="cuda", **knobs), **problem),
        "stream_b_cosine_edge_k128_kp1024", out,
        stream_s["b_cosine_edge_k128_kp1024"])
    _, problem, knobs = constrained_calls(True)[0]
    phase_profile(lambda: repro_torch.diversify(
        x, labels=genres, execution=repro_torch.ExecutionSpec(
            device="cuda", **knobs), **problem).indices,
        "constrained_e_cosine_labels_k32", out,
        constrained_s["e_cosine_labels_k32"])
    _, _, problem, knobs, _, _ = mapreduce_calls(True)[0]
    phase_profile(lambda: repro_torch.diversify(
        x, execution=repro_torch.ExecutionSpec(
            mode="mapreduce", device="cuda", **knobs), **problem).indices,
        "mapreduce_i_cosine_edge_k128_l16", out,
        mr_s["i_cosine_edge_k128_l16"])
    phase_profile(lambda: repro_torch.diversify(
        requests, k=serving_calls(True)["k"], metric="cosine",
        execution=repro_torch.ExecutionSpec(device="cuda")).indices,
        "serving_s_fused_cosine_edge", out, serve_s["s_fused_cosine_edge"])
    del requests
    phase_profile(dynamic_round(dyn_keep["u_index"],
                                dyn_keep["profile_script"],
                                dyn_keep["u_cfg"]["k"]),
                  "dynamic_u_round", out, dyn_s["u_churn_0.05"])
    del dyn_keep
    phase_profile(serve_keep["profile"](), "serve_q_group", out,
                  serve_keep["group_s"])
    del serve_keep
    torch.cuda.empty_cache()
    pick = {"gmm_topb": next(r for r in rows if r["b"] == 8 and r["p"] == 128),
            "gmm_update_select": next(r for r in rows if r["b"] == 1
                                      and r["p"] == 1),
            # the tile where B3 meets a library call: (b)'s size, euclidean
            "pairwise": next(r for r in b_rows if r["d"] == x.shape[1]
                             and r["mode"] == "euclidean"),
            "gmm_grouped_topb": next(r for r in g_rows
                                     if r["m"] == GROUPS and r["p"] == 128
                                     and r["bc"] == 8)}
    at_keys = {"gmm_topb": ("mode", "n", "d", "b", "p"),
               "gmm_update_select": ("mode", "n", "d", "b", "p"),
               "pairwise": ("mode", "m", "n", "d"),
               "gmm_grouped_topb": ("mode", "n", "d", "m", "bc", "p")}
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port pulled in jax or the reference package")
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "script_seconds": time.perf_counter() - t_start,
          "vlm_ssm_slice_run_f_script_seconds": 640.0})
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": pick[name]["ms"],
         # B1/B2: the profiler's device ms a launch beside the call's ms,
         # and the call timed again after the phase's other windows
         "kernel_ms": pick[name].get("kernel_ms"),
         "ms_second_pass": pick[name].get("ms_second_pass"),
         "plain_ms": pick[name]["plain_ms"],
         "bound_ms": pick[name]["bound_ms"],
         "bound_by": pick[name]["bound_by"],
         # B1/B2/B4: no single PyTorch call fuses distance, min and top-p
         "library_ms": pick[name].get("library_ms"),
         "at": {k: pick[name][k] for k in at_keys[name]}}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
