#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``kubeinfer_tpu_torch``; nothing of JAX) through the
placement solve's and the route solve's entry points, through the
serving path (``/v1/completions`` on llama-3-8b), through the training
step (``train.train_step`` on llama-3-8b), through a dense-mask forward
(``attention_auto``) and through speculative decoding, builds its CUDA
kernels from this checkout, holds each kernel against its plain PyTorch
version, checks the solves' hard guarantees and the served tokens, and
times them. Phases:

  (0) the card's name and power limit (nvidia-smi);
  (1) the nvcc build of every kernel, one nvcc per source, started
      together, eleven sources: mega_solve.cu, round_ops.cu, auction.cu,
      route_pick.cu, flash_prefill.cu,
      quant_matmul.cu, flash_backward.cu, flash_prefill_tc.cu (the
      tensor-core kernel of every bf16 call of #9, #13 and #9b),
      flash_backward_tc.cu (the tensor-core kernels of every bf16 #14
      call at D 64 and 128), decode_split.cu (the split-K kernel of every
      #10, #11 and #12 call), quant_matmul_tc.cu (the wgmma + TMA kernel
      of every #15 call that weight_quant.qmm_route admits; quant_matmul.cu
      keeps the ragged bf16 and the f32 calls);
  (2) mega_solve vs mega_rounds at the headline shape J=12288, N=1024 on
      the same tensors: a fresh solve, a fill with may_bid over a 25%-gang
      request (the fill's W + 1 cap), and a seeded churn re-solve with
      asg_init, and on seeded dyadic inputs at N=16384, J=1024 (W=128, 128
      nodes a block) — every output bitwise equal, and the kernel's own
      walk count (windows, rounds, fenced rounds, grid barriers) equal to
      kernels.mega_walk's;
  (3) the mega path: ``get_backend("jax-greedy").solve`` at 10k jobs x 1k
      nodes and the ``/solve`` handler at 32 x 8 and 1k x 128, with the
      launch counts reset just before and read just after; no overcommit,
      gangs all-or-nothing, a fixpoint, 10000 placed, and the assignment
      equal to the port's own device="cpu" solve. The 32 x 8 call pads to
      a 64 x 64 bucket, which is not 128-aligned: it runs the pipelined
      loop (round kernels), as the reference routes it;
  (4) times of the mega path: p50 pack + solve at 10k x 1k and 50k x 1k,
      the kernel by device time (a CUDA graph of 20 launches) at both
      shapes with its rounds, beside CUDA events over calls, the first
      kernel's time, its bound and its plain version; one grid barrier
      alone (mega_barrier_launch); the serial native baseline;
  (5) fence, bid and accept vs fence_minrank, round_bids and dense_accept,
      bitwise, on every round of a real 10k jobs x 20k nodes solve
      (J=12288, N=24576, both accept passes; no mega window fits), of its
      10% churn re-solve through the backend, of the churn loop with no
      incumbent seated (columns that bid at their incumbent's node alone)
      and of a 700 x 60 solve with 25% gangs (N=64, the halves group
      rule); on each fence and bid call, the kernel's own count of its
      walk (chunk sweeps; pairs tested and chunks walked) equal to its
      plain mirror's (kernels.fence_walk, kernels.bid_walk);
  (6) the pipelined path: ``get_backend("jax-greedy").solve`` at 10k x 20k
      fresh, with 25% gangs, and a 10% churn re-solve (seeded, with the
      preemption repair), launch counts reset just before and read just
      after; the same guarantees, and the card's solve equal to the
      device="cpu" solve at 1k x 20k, at 700 x 60 with 25% gangs, and at
      an overloaded 1000 x 60 with 25% gangs (gang repair + fill);
  (7) times of the pipelined path: p50 pack + solve at 10k x 20k, rounds,
      the main loop's ms, launches and host syncs per solve; fence, bid
      and accept on every round's inputs by device time (a CUDA graph of
      20 launches) beside the bound of what those inputs need and the
      walk counts, and on round 1 also by CUDA events over calls, by the
      wrapper's host us and beside the plain version; torch.amin over as
      many columns of S as are active, a yardstick of the same bytes;
      accept's grid barriers a launch (one, from its source) and its
      workspace, one for every accept call of a solve;
  (9) auction_solve vs auction_rounds, bitwise (assigned, iterations), on
      the benefit fields of bench.py's whole-node auction request
      (J = N = 1024), of 256 identical jobs, of a random 64 x 64 field
      (25% infeasible, 10% invalid rows), of a 4096 x 4096 whole-node
      request (beyond L2) — the shared-state kernel, one grid barrier an
      iteration — and of a 1000 x 24000 one (1024 x 24576, past
      kernels.auction_plan's line: the two-barrier kernel); on each, the
      kernel's own walk count (rows walked, tie-break entries, grid
      barriers) equal to kernels.auction_walk's;
  (10) the jax-auction path: ``get_backend("jax-auction").solve`` on the
      1k x 1k request and on 960 jobs with 25% gangs on a fleet where
      100 nodes cannot host a job (gangs unwind, the fill runs mega), and
      the ``/solve`` handler at 32 x 64; launch counts reset before and
      read after each; one job per node, no overcommit, gangs
      all-or-nothing, a fixpoint, and equality with device="cpu";
  (11) times of the auction path: p50 pack + solve; the kernel by device
      time (a CUDA graph of 20 launches), per iteration, by CUDA events
      over calls and by the wrapper's host us at 1k x 1k, 4096 x 4096 and
      1024 x 24576, beside its bound and, on the first two, the
      two-barrier kernel through its launcher; its plain version;
  (12) route_pick vs route_pick_plain, bitwise, on every call of
      solved_affinity at 10k jobs x 1k nodes (12288 x 1024) and of the
      route solve's three modes on a fleet-storm batch (bench.py's
      fleet_storm_bench: 256 requests x 100 replicas), and at 256 x 128;
      those solves against device="cpu", their launch counts, and times
      (route_pick and torch.max on the masked plane by device time, a
      CUDA graph of 20 launches, beside CUDA events over calls);
  (29) the reconcile tick through the manager (run right after (12)):
      ``Manager`` with its device left at the card's default hosts the
      store on ephemeral ports; 1024 nodes and 1344 services (1280
      jax-greedy of 8 replicas, 25% gangs, and 64 whole-node
      jax-auction) written over HTTP through ``RemoteStore``; the
      manager's own loop takes the first tick (after a lease that held
      it off is deleted), then 5 steady ticks by
      ``controller.reconcile_once()``; launch counts reset before and
      read after (#1, #7 and #8 all launched); each tick split into
      store reads, host work, solved_affinity (pack, #8), each group's
      solve and launches, write-back, host syncs; no overcommit, gangs
      all or nothing, the first and a steady tick's bindings equal to a
      device="cpu" Controller's on the same contents, /metrics solve
      counts for both policies, POST /solve equal to the handler;
  (13) the serving path at full width: ``server.build_server`` with
      ``--model llama-3-8b --random-init --batch-slots 8`` (bf16 weights
      from init_params, a 4096-wide slot row, a 513-block pool of 128);
      decode_attention_blocks (#11), flash_attention_ragged (#9) and
      decode_attention (#10) each against its plain version, within the
      stated tolerance, on every layer's call of the continuous engine's
      decode windows (8 requests of 512 tokens) and of an Engine
      generate with a 4100-token prompt (4 prefill chunks of 2048, one
      decode step), every #9 call on the tensor-core route, the split-K
      kernel's own count of the live splits it walked for #10 and #11
      equal to decode_split_walk's;
  (14) /v1/completions over HTTP: 4 greedy 512-token prompts (two share
      256 tokens) and 1 sampled, 64 new tokens each, on the continuous
      route, and a 4100-token prompt on the engine route, concurrently;
      the three launch counts reset before and read after (all > 0,
      every #9 launch on the tensor-core route, the live splits of every
      #10 and #11 launch by the kernel's own count equal to
      decode_split_walk's),
      the routes, tokens in the vocabulary, finite logits, and the host
      syncs of one decode window (1: its readback);
  (15) the port on the card against the port on the CPU: llama-3-8b
      widths cut to 1 layer (CPU_CHECK_LAYERS), f32,
      Engine and ContinuousEngine, greedy and sampled, equal streams;
  (16) times: TTFT of a 512-token prompt on the continuous route, decode
      ms per token at 8 live slots, the engine route's prefill chunks,
      the engine route's decode (16 step_forward steps of the 4100-token
      row, split-K #10), and each
      attention kernel against its bound, its plain version and
      scaled_dot_product_attention on the path's heaviest call (#9 also
      against the CUDA-core kernel on the same call; #10 and #11 by
      device time, wall time and the wrapper's host time, and each of
      the two routes' distance from an f32 evaluation of the call);
  (17) the int8 serving path at full width: ``server.build_server``
      with ``--kv-dtype int8 --weight-dtype int8`` (the bf16 server
      stopped and freed first): the GiB on the card, model_param_bytes
      and kv_pool_bytes beside the bf16 server's;
      decode_attention_blocks_q8 (#12) on every layer's call of 8
      requests of 512 tokens (4 new) and quant_matmul (#15) on every
      projection of those and of a 4100-token Engine generate (M = 8,
      512 and 2048), each against its plain version within the stated
      tolerance (#12's live splits equal to decode_split_walk's), every
      #15 call on the tensor-core route; #11 never launched;
  (18) /v1/completions over HTTP on the int8 server, the bodies of
      (14): #12, #15, #9 and #10 launched, #11 not (#12's live splits
      equal to decode_split_walk's; every #15 call within tolerance of
      its plain version and on the tensor-core route); routes, tokens,
      finite logits, one
      host sync per decode window, quant_blocks_total;
  (19) int8 on the card against the CPU at llama-3-8b widths cut to 2
      layers, f32: the weight codes and scales bitwise equal, the
      Engine and the int8-pool ContinuousEngine (blocks of 128, prompts
      of about 120: a block edge crossed while decoding) giving equal
      streams, the card's through #10 and #12 (launched) and the CPU's
      through the dense route, the count of pool codes that differ;
  (20) times of the int8 path: TTFT, decode ms per token at 8 slots,
      the engine route's prefill chunks, a torch.profiler split of one
      admit and of a decode run, device launches per decode step
      against bf16 and #15's share of each profile, #12 as #10 and #11 in
      (16), and #15 at M = 8, 40, 512 and 2048 on the gate and down
      projections and on the path's heaviest call: device time, the
      wrapper's host us, the bound, the plain version,
      torch._weight_int8pack_mm and torch.matmul on the pre-dequantized
      weight;
  (21) the training step at full width and depth: ``train.train_step``
      on llama-3-8b (bf16 init_params(seed=0), the int8 server freed
      first) over seeded tokens [1, 2049] (T = S = 2048, the flash
      route), no attn_fn, lr 1e-3; on step 1 flash_ragged_lse (#13),
      flash_bwd_dq and flash_bwd_dkv (#14) each against its plain version
      within the stated tolerance on every layer's call, #13's o bitwise
      #9's, every call of the three on the tensor-core route, and on
      layer 0 each #14 kernel's own count of its folded steps equal to
      its plain mirror's (flash_bwd_walk); steps 2-3 with the launch
      counts reset before and read after (32 a step each, all on the
      tensor-core route, #9 none); finite losses, peak memory;
  (23) times of the training step: its p50, one step under
      torch.profiler (device busy share, top device operations), and
      #13, dQ and dK/dV per launch beside their bounds, their plain
      versions, scaled_dot_product_attention (causal, GQA) forward and
      backward, and the CUDA-core kernels on the same calls;
  (22) the training step on the card (flash route) against the CPU
      (dense route) at llama-3-8b widths cut to 1 layer, f32, tokens
      [2, 513]: loss and every gradient leaf within tolerance;
      TRAIN_CHECK_STEPS (3) steps
      at lr 5e-2 lower the loss on both;
  (24) #9b on its entry: ``forward(params, tokens [1, 2048], cfg,
      attn_mask=packed, attn_fn=attention_auto)`` on llama-3-8b bf16 at
      full width and depth, a block-diagonal causal mask over documents
      of 512, 1024 and 384 tokens and 128 rows that see nothing:
      flash_attention against its plain version on all 32 layer calls,
      the all-False rows equal to the mean of v, 32 launches in a counted
      forward, every one on the tensor-core route (which folds only the
      key tiles the mask makes live: the kernel's own count of the tiles
      its blocks fold equal to flash_mask_walk's), the live rows' hidden
      states against attn_fn=model.attention; then 2 layers in f32, the
      card (#9b on the CUDA-core route) against device="cpu" (dense);
  (25) verify windows at 8 slots: (a) a library ContinuousEngine whose
      draft is the target itself (acceptance near 1; at SPEC_INT8_LAYERS
      layers, as the plain engine it is held to), (b) the server with
      ``--draft-model llama-3-8b --speculative-draft`` at SPEC_INT8_LAYERS
      layers (a seed-1 draft: every window rolls back) over HTTP, the
      plain engine's streams on its weights; #11 at T = 5 and #10 on the
      draft steps against their plain versions on every call (the
      split-K kernel's live splits equal to decode_split_walk's), one
      host sync per verify window; greedy streams equal to the plain
      engine's up to a near-tie (the two tokens' logits under a
      teacher-forced f32 forward of the same weights closer than the
      largest bf16 allowance of any position of the streams: twice the
      dense bf16 forward's error on its top two logits, plus an ulp), and
      for every token, beside the plain engine's, whether it is that
      forward's argmax; the verify counters against the emitted
      lengths; then 1 layer in f32 with blocks of 128 and a bigram
      draft, card (#11 launched) against the CPU (dense): equal streams
      and counters; (25c) full width in f32 at SPEC_INT8_LAYERS layers,
      the plain engine, a self draft and a bigram draft: every speculative token within
      2**-10 of a teacher-forced f32 forward's argmax on its own prefix,
      the streams equal to the plain engine's up to such a tie;
  (26) the same server without ``--speculative-draft``: four sampled
      requests of one seed served by one draft group, a greedy one on a
      slot, and a direct SpeculativeEngine.generate whose prefills launch
      #9 once per chunk and layer, its greedy tokens checked as in (25);
  (27) the int8 verify server (``--kv-dtype int8 --weight-dtype int8``)
      at full width and a quarter of its depth (SPEC_INT8_LAYERS):
      #12 at T = 5 on every call (its live splits equal to
      decode_split_walk's), windows that spill into tail slot 1, #11
      never, #15 on every projection; then 1 layer in f32 with blocks of
      128 and a bigram draft, card (#12 launched) against the CPU
      (dense): equal streams and counters;
  (28) times: #9b against its bound, SDPA with the same mask and the
      CUDA-core kernel on the same call, #11 and #12 at T = 5 (as in
      (16)), a verify window's ms and tokens a row in (a) and (b),
      decode ms per emitted token per slot with and without a draft;
  (30) disaggregated prefill and decode, run as (30a) on a second
      server over the first SPEC_INT8_LAYERS layers of the bf16 server of
      (13)'s tensors before that server stops, and as (30b) on one over
      the first SPEC_INT8_LAYERS layers of the int8 server of (17)'s
      tensors (``cut_server``; the whole run keeps inside its time
      limit): its
      engine is the prefill replica; a second ContinuousEngine and
      InferenceServer on the same parameter tensors (its own pool) is the
      decode replica. A 512-token greedy and a 600-token sampled prompt
      with max_tokens=0 (route "prefill", a wire blob in the export
      cache), then with max_tokens=64 and kubeinfer_kv_source to the
      decode replica, which fetches GET /kv/blocks, verifies and imports:
      #11 (#12, and #15 on both replicas, in int8) against its plain
      version on every call and counted, the landed pages bitwise the
      exporter's, the streams bitwise a fresh engine's after a local
      max_tokens=0 warm-up (whose pages are held against the exported
      ones too), equal to a cold prefill's up to (25)'s near-tie rule,
      one host sync a decode window, a repeat not imported again, an
      unreachable source counted as fetch_error; then, unchecked, the
      export capture, encode_payload, fetch + verify and staged import
      ms, wire bytes and the decode replica's TTFT after the import. The
      kernels line's #11, #12 and #15 entries gain ``disagg_launches``;
  (31) preemption, drain and live-session migration. (31b), before (30a)'s
      decode replica stops: a 600-token greedy and a 600-token sampled
      session (80 new each) on (30a)'s cut server; once each decoded 48
      tokens, POST /admin/drain: both complete with finish_reason
      "migrated" after streaming their committed blocks (a 4-block v1
      chunk, then v3) into the export cache, new work answers 503
      draining; each resumes on the decode replica from a
      kubeinfer_resume body with kv_source (route "resume"): the chain
      lands bitwise the source's pool pages and counted, the whole
      stream equals an uninterrupted run on the target up to (25)'s
      near-tie rule (for the sampled one, the same rule on the sampler's
      perturbed scores), a degenerate tail answers with no admit, and
      {"resume": true} undrains the source; #11 held on every call of
      both replicas. (31a), after (30a): a 2-slot ContinuousEngine on
      (13)'s parameter tensors, their first SPEC_INT8_LAYERS layers
      (``--migrate`` keeps all 32) (cache 4096, blocks of 128, its 129-block
      pool, prefill chunks of 4) under PreemptionPolicy(0.0005, 0.5, 0.5,
      1, 1) and queue_depth_limit 5: 6 requests of 512 tokens (3 greedy,
      3 sampled; 32 new), one more shed at the door; parks and readmits,
      every readmit warm, #11 held on every call and counted, one host
      sync a decode window, the streams equal to an uncontended run up
      to the near-tie rule; (31a2) the same with the target as its own
      draft (spec_k 4): 4 greedy requests across preemption cycles, #11
      at T = 5 and #10 on the draft steps held on every call. (31c), on
      (30b)'s cut int8 server and its decode replica: (31b) in int8
      (wire v2 then v3, the pages and scales bitwise, #12 and #15 held on
      every call of both replicas). Times: the readmit admit beside a
      cold admit, request latency under preemption beside uncontended,
      the drain, each chunk pass's gather and encode, the chunk bytes, the
      chain import and the resume's TTFT. #10, #11, #12 and #15 gain
      ``migrate_launches`` in the kernels line. Since (32), the servers of
      (13) and (17) carry a bearer token: (31b)'s and (31c)'s drains send
      it, and one drain without it answers 401, the source undrained;
  (32) /metrics and the debug endpoints: the servers of (13) and (17) are
      built with ``--slo ttft:2.0:0.99 --debug-token-file <a temporary
      file> --flight-capacity 4096`` (``observe_flags``), so every phase
      on them runs instrumented (the batcher's step profiler and flight
      recorder, the server's collectors and SLO monitor). (32a) on the bf16
      server after (31b), (32b) on the int8 one after (31c): GET /metrics
      parses with every family of the serving collectors and its counters
      equal the engine's own; a burst (7 completions, 2 shed at the door,
      an invalid body, the engine route, a prefill-only export fetched
      twice) moves each counter by what the answers say, the step
      histogram by the profiler's new records, #11 (#12) by 32 launches a
      decode step (#11 and #12 held against their plain versions on every
      call, #15's launches counted: [17]-(31c) hold it on this server's
      calls); histograms only grow; /debug/flightrecorder?since=
      replays each event once; /debug/spans, /debug/slo,
      stats_summary() and /cache/summary answer sanely, /debug/* 401
      without the token; one host sync a decode window with the
      instrumentation on. Unchecked: a scrape's ms, the host us of a
      profiler record and a flight note. #11, #12 and #15 gain
      ``observe_launches`` in the kernels line;
  (33) the node's model path (``agent_phase``), after (32) once the earlier
      servers are freed: (33a) an HF checkpoint (``config.json`` and two
      bf16 ``*.safetensors`` shards, written with json and numpy) of
      ``init_params(llama-3-8b, seed=0)`` at full width and
      ``AGENT_LAYERS`` = 4 layers (3.85 GB), ``load_pretrained`` onto the
      card bitwise the tensors written, its int8 load bitwise
      ``quantize_weight`` on the card, ``save_checkpoint`` then
      ``restore_checkpoint`` bitwise for both trees; (33b) the manager
      in-process and two ``python -m kubeinfer_tpu_torch.agent``
      processes (node-0 bf16, node-1 int8; the probe sets their memory)
      bring a ``runtime: native`` LLMService with a shared cache to
      Running: one coordinator (its ``hub_download`` runs a
      ``huggingface-cli`` shim that copies the checkpoint), one follower
      (its files byte-equal to the coordinator's), the card's free memory
      down by at least the weights each replica holds as it goes Ready
      (the checkpoint's bytes in bf16, the int8 tree's in int8);
      the bodies of (14) over HTTP on each spawned server; (33c) SIGTERM,
      both agents exit 0, the serving ports close, the memory returns;
      in-process servers on the same cache dirs take the same bodies with
      #9-#12 and #15 held against their plain versions on every call,
      their streams equal to the spawned servers' up to [25]'s near-tie
      rule. Times, unchecked: the load, save and restore, the download,
      the follower's sync, spawn to Ready, the first TTFT. The tick's #1-#8
      and the in-process #9-#12 and #15 gain ``agent_launches`` in the
      kernels line;
  (34) the fleet router and the fleet plane (``fleet_phase``), inside
      (30a)'s ``then`` after (31b), on two replicas over the first 8
      layers of (13)'s weights (``fleet_on_cut``: ``cut_server`` (r0) and
      a decode replica beside it (r1), as (30b) and (31c));
      every ``kernels.route_pick`` call through
      ``CheckedPick`` (bitwise), every #11 call through
      ``attention_check``. (34a) bench.py:fleet_storm_bench's plant (100
      replicas, 4 draining, 4 stale, 2 dead; 32 families of 8 blocks of
      32 tokens + 8; seed 23) on ``FleetRouter(device=cuda)`` through
      ``update_replica``: 10,000 requests by ``route_batch(engine=
      "solver")`` in chunks of 256 in parity, greedy and auction; parity
      equal to the ``engine="python"`` decisions on every chunk (every
      field) and the first chunk to per-request ``route()``, the skip
      counters and replica gauge equal to the planted masks; per-request
      us of route_batch (the match plane included) and of route(). (34b)
      a RouterServer (storm window 20 ms) over HTTP: fleet_routing_bench's
      shape (4 families of 256-token prefixes + 8, seed 17, planted 2 a
      replica by direct posts, 12 shuffled requests of 4 new tokens in two
      concurrent waves of 6): each on its family's replica with the
      prefix's full blocks matched, hit rate 1.0, all 12 through the storm
      solve, tokens equal to a direct post to the chosen replica; r1
      drained and polled: 4 requests of its families go to r0,
      skipped{r1, draining} up by 4; a 48-token session routed to r0,
      drained mid-stream and resumed on r1 through kubeinfer_resume, its
      stream equal to an undrained run up to (25)'s rule; a second
      RouterServer (decode r1, prefill r0, threshold 256): a 600-token
      prompt takes the two-phase route, one import, its stream bitwise a
      warm admit's. (34c) loadgen's Poisson schedule (seed 29, 12 requests
      at 2 req/s) replayed open-loop through the router's ``forward``, a
      FleetView on both engines' rings (each drain exactly once), one
      ledger per request over tracing.RECORDER with its phases summing to
      its end to end, tail attribution naming a phase and a replica;
      TTFT p50/p99 and an envelope point. route_pick and #11 gain
      ``fleet_launches`` in the kernels line;
  (35) tensor parallelism on one card (``tp_phase``): llama-3-8b at full
      width cut to 8 layers (``init_params(seed=0)``), the tp ranks
      repeated ``cuda:0`` devices. (35a) the bf16 ``ContinuousEngine`` at
      tp=1 and tp=2 on 4 greedy and 1 sampled 512-token prompts (32 new):
      tp=2 equal to tp=1 up to (25)'s near-tie rule, every #11 call held
      to its plain version on its shard and tallied by rank; decode ms a
      token a slot at both. (35b) the same on the int8 pool and weights,
      #12 and every #15 call held, #15's device time at each shard shape
      beside the whole one. (35c) tp=8 (one KV head a rank), a 16-token
      prompt. (35d) ``build_server([... "--tensor-parallel-size", "2",
      "--draft-model", ..., "--speculative-draft"], mesh=...)`` over HTTP:
      a verify-window request (#11 at T = 5 a rank) and an 8180-token
      engine-route request (#9 and #10 a rank), both against tp=1, every
      call held; the tp gauges read 2; on one card a tp=2 server without a
      mesh raises. #9-#12 and #15 gain ``tp_launches`` in the kernels
      line;
  (36) sequence, pipeline and expert parallelism on one card
      (``sp_moe_phase``), the ranks repeated ``cuda:0`` devices: (36a)
      sp=2 at llama-3-8b width cut to 8 layers, a greedy and a sampled
      (top_p 0.9) 2048-token prompt through ``SPEngine.generate`` against
      ``Engine.generate`` up to the near-tie rules, every #10 call held,
      the handed-off caches against ``chunked_prefill``'s, one layer's
      ring attention against the dense at [1, 2048, 32, 128]; (36b) sp=2
      x tp=2, #10 equal on both tp ranks, streams equal to (36a)'s;
      (36c) the ``--sequence-parallel-size 2 --sp-min-prompt 1024
      --draft-model`` server over HTTP, route "sp" by ``/metrics``; (36e)
      ``pipeline_forward`` at pp 2 and 4, M 2 and 4, against the dense
      forward; (36d) mixtral-8x7b width cut to 4 layers in the continuous
      engine (#11 bf16, tp=2 against tp=1, #12 and #15 int8 with the
      experts bf16), a 4100-token engine request (#9, #10), the MoE
      block's share of a decode step, ``moe_block_ep`` at ep 2 and 8, the
      card against the CPU at 1 layer in f32. #10 gains ``sp_launches``,
      #9-#12 and #15 ``moe_launches`` in the kernels line;
  (8) the ``kernels`` JSON line (fifteen entries), printed last of all
      phases, after each phase's seconds (lines "[s] ...").

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Full numbers go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --placement

runs (0)-(4), (5)-(7), (9)-(12) and (29) alone (the four solver
libraries; about a minute and a half of command), with their entries of the kernels line and the last
line; the numbers go to chiprun_out/placement.json. ``--p50s`` prints the
placement p50s of (4), (7) and (11) alone. ``--disagg`` runs (30a) and
(30b) alone (chiprun_out/disagg_probe.json); ``--migrate`` runs (31) alone
(chiprun_out/migrate_probe.json); ``--observe`` runs (32) alone on fresh
servers (chiprun_out/observe_probe.json); ``--agent`` runs (33) alone
(chiprun_out/agent_probe.json); ``--fleet`` runs (34) alone on the
server of (13) and a decode replica (chiprun_out/fleet_probe.json);
``--tp`` runs (35) alone (chiprun_out/tp_probe.json); ``--sp`` runs
(36) alone (chiprun_out/sp_probe.json).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import math
import pathlib
import secrets
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROUND_KERNELS = ("fence", "bid", "accept")
# depth of the card-against-CPU runs at llama-3-8b widths in f32 ([15],
# [19], [22], [25], [27]): the host's f32 run is most of each check's
# time, and one layer keeps the whole run near 750 s
CPU_CHECK_LAYERS = 1
# depth of the verify engines and servers in [25a], [25b], [25c] and [27]
# and of ``cut_server``'s replicas ((30), (31b), (31c), (34); the preset
# has 32): [13]-[20] serve at full depth; an eighth here keeps the whole
# run well inside its time limit with (36) added
SPEC_INT8_LAYERS = 4
# steps of (22)'s training run on each side (the loss falls from the
# first; the CPU's f32 steps are most of (21)-(23)), and new tokens of
# each row of (25) and (27)'s card-against-CPU verify runs (both still
# cross a block edge); both cut to keep the whole run well inside its
# time limit with (34) added
TRAIN_CHECK_STEPS = 3
SPEC_CHECK_NEW = 12


def build_request(J, N, seed=0, gang_fraction=0.0):
    """The headline benchmark's request generator (bench.py:build_request),
    on the port's SolveRequest."""
    from kubeinfer_tpu_torch.scheduler import SolveRequest

    rng = np.random.default_rng(seed)
    gang = np.full(J, -1, np.int32)
    if gang_fraction > 0:
        n_gang_jobs = int(J * gang_fraction)
        # gangs of 4; the last one shorter when the count is not a
        # multiple of 4 (bench.py's generator takes only multiples)
        gang[:n_gang_jobs] = np.repeat(
            np.arange(max(-(-n_gang_jobs // 4), 1)), 4
        )[:n_gang_jobs]
    return SolveRequest(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        job_gang=gang if gang_fraction > 0 else None,
        job_model=rng.integers(0, 256, J).astype(np.int32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=(rng.random((N, 256)) < 0.02).astype(np.uint8),
        node_topology=rng.integers(0, 16, N).astype(np.int32),
    )


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def problem_of(req, device):
    """The backend's own priority sort + pack + unpack, for kernel inputs."""
    from kubeinfer_tpu_torch.scheduler.backends import _descending_stable_perm
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    perm = _descending_stable_perm(np.asarray(req.job_priority))
    buf, _, _, J, N = pack_problem_arrays(
        job_gpu=req.job_gpu, job_mem_gib=req.job_mem_gib,
        job_priority=req.job_priority, job_gang=req.job_gang,
        job_model=req.job_model, job_current_node=req.job_current_node,
        node_gpu_free=req.node_gpu_free,
        node_mem_free_gib=req.node_mem_free_gib,
        node_topology=req.node_topology, node_cached=req.node_cached,
        job_perm=perm,
    )
    return unpack_problem(buf, J, N, device), perm


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_assignment(req, assignment, label, expect_all=False):
    """No overcommit, gangs all-or-nothing, and a fixpoint: no unplaced
    non-gang job fits any node's remaining capacity."""
    N = req.num_nodes
    placed = assignment >= 0
    check((assignment < N).all(), f"{label}: placed on a padding node")
    used_g = np.zeros(N)
    used_m = np.zeros(N)
    np.add.at(used_g, assignment[placed], req.job_gpu[placed])
    np.add.at(used_m, assignment[placed], req.job_mem_gib[placed])
    left_g = req.node_gpu_free - used_g
    left_m = req.node_mem_free_gib - used_m
    check((left_g >= -1e-3).all() and (left_m >= -1e-3).all(),
          f"{label}: overcommit")
    gang = req.job_gang
    if gang is not None:
        for g in np.unique(gang[gang >= 0]):
            members = placed[gang == g]
            check(members.all() or not members.any(),
                  f"{label}: gang {g} partially placed")
    for j in np.nonzero(~placed)[0]:
        if gang is not None and gang[j] >= 0:
            continue
        fits = (req.job_gpu[j] <= left_g + 1e-3) & (
            req.job_mem_gib[j] <= left_m + 1e-3
        )
        check(not fits.any(), f"{label}: job {j} unplaced but feasible")
    if expect_all:
        check(placed.all(), f"{label}: placed {int(placed.sum())}/{len(placed)}")
    return int(placed.sum())


def handler_body(J, N, seed, fractional):
    rng = np.random.default_rng(seed)
    gpu = (
        rng.choice([0.25, 0.5, 1.0, 2.0], J) if fractional
        else np.ones(J)
    )
    return {
        "policy": "jax-greedy",
        "jobs": {
            "gpu": gpu.tolist(),
            "memGib": rng.integers(1, 16, J).astype(float).tolist(),
            "priority": rng.integers(0, 4, J).astype(float).tolist(),
        },
        "nodes": {
            "gpuFree": [8.0] * N,
            "memFreeGib": [128.0] * N,
            "topology": rng.integers(0, 4, N).tolist(),
        },
    }


def reset_counts(kernels):
    """Set every kernel wrapper's launch count to 0."""
    for name in ("mega_solve", *ROUND_KERNELS, "auction_solve", "route_pick"):
        getattr(kernels, name).launches = 0


def dyadic_mega_inputs(seed, N, J, dev):
    """Seeded mega-loop inputs on which every sum is exact (as
    tests/test_torch_mega.py:dyadic_inputs makes them): S on a 2^-8 grid,
    integer demands and capacities, power-of-two fit weights and q_scale,
    5% invalid nodes, 30% incumbents, half of them seated. Returns the
    twelve tensors and the constants of ``kernels.mega_solve``."""
    import torch

    from kubeinfer_tpu_torch.solver.kernels import RANK_INF

    rng = np.random.default_rng(seed)
    bits = max((N - 1).bit_length(), 1)
    S = (rng.integers(-4 * 256, 12 * 256, (N, J)) / 256.0).astype(np.float32)
    d = rng.integers(1, 8, J).astype(np.float32)
    md = rng.integers(1, 32, J).astype(np.float32)
    rank = np.sort(rng.integers(0, 4, J)).astype(np.float32)
    may = np.ones(J, bool)
    key = ((rank.astype(np.int32) << 24) | ((15 - d.astype(np.int32)) << 20)
           | np.arange(J, dtype=np.int32)).astype(np.int32)
    cur = np.where(rng.random(J) < 0.3, rng.integers(0, N, J), -1
                   ).astype(np.int32)
    gf = rng.integers(4, 24, N).astype(np.float32)
    gf[rng.random(N) < 0.05] = -1.0
    mf = rng.integers(32, 160, N).astype(np.float32)
    asg0 = np.where((cur >= 0) & (rng.random(J) < 0.5), cur, -1
                    ).astype(np.int32)
    vg = np.where(rng.random(N) < 0.5, 2.0**-6, 2.0**-5).astype(np.float32)
    vm = np.full(N, 2.0**-10, np.float32)
    assert (rank < RANK_INF).all()
    arrays = [torch.from_numpy(a).to(dev)
              for a in (S, d, md, key, rank, cur, asg0, may, gf, mf, vg, vm)]
    consts = dict(q_lo=-4.0, q_scale=2.0**16,
                  q_max=float((1 << (31 - bits)) - 2), node_idx_bits=bits)
    return arrays, consts


def round_counts(kernels):
    return {name: getattr(kernels, name).launches for name in ROUND_KERNELS}


class CheckedOps:
    """Round ops for ``core.run_rounds`` that run each kernel and its plain
    version on the same inputs, hold every output bitwise equal, and hand
    the kernel's result on. Where a wrapper has a ``walk_counter``, the
    kernel's own count of what it read is held to its plain mirror
    (``walk_mirror``) on every call. The inputs of every call are kept, in
    order, for the timings (``every``). ``ops()`` gives them to
    ``run_rounds``; under ``installed()`` every ``run_rounds`` call of a
    solve through the backend takes them."""

    def __init__(self, kernels):
        self.k = kernels
        self.real = {name: getattr(kernels, name) for name in ROUND_KERNELS}
        self.plain = {"fence": kernels.fence_minrank,
                      "bid": kernels.round_bids,
                      "accept": kernels.dense_accept}
        self.calls = dict.fromkeys(ROUND_KERNELS, 0)
        self.max_err = dict.fromkeys(ROUND_KERNELS, 0.0)
        self.walked = {"fence": 0, "bid": 0}
        self.walk_log = {"fence": [], "bid": []}
        self.every = {name: [] for name in ROUND_KERNELS}

    def _held(self, name, args, kw):
        self.every[name].append((args, kw))
        counter = getattr(self.real[name], "walk_counter", None)
        if counter is not None:
            counter.zero_()
        got = self.real[name](*args, **kw)
        want = self.plain[name](*args, **kw)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            err = float((g.double() - w.double()).abs().max())
            self.max_err[name] = max(self.max_err[name], err)
            check(torch_equal(g, w),
                  f"{name}: kernel != plain version, call {self.calls[name]}")
        if counter is not None:
            mirror = walk_mirror(self.k, name, args)
            check(counter.tolist() == mirror,
                  f"{name}: the kernel's walk count {counter.tolist()} != "
                  f"its mirror's {mirror}, call {self.calls[name]}")
            self.walked[name] += mirror[0]
            self.walk_log[name].append(mirror)
        self.calls[name] += 1
        return got if len(got) > 1 else got[0]

    def ops(self):
        from kubeinfer_tpu_torch.solver.core import RoundOps

        return RoundOps(*(
            (lambda *a, _n=name, **kw: self._held(_n, a, kw))
            for name in ROUND_KERNELS))

    @contextlib.contextmanager
    def installed(self):
        from kubeinfer_tpu_torch.solver import core

        real = core.run_rounds
        core.run_rounds = lambda *a, **kw: real(*a, **kw, ops=self.ops())
        try:
            yield self
        finally:
            core.run_rounds = real


def home_reads(kernels, chk):
    """The pairs the bid kernel tested at an incumbent's node alone, over
    the bid calls ``chk`` checked (``bid_walk``'s home pairs)."""
    return sum(int(kernels.bid_walk(a[6], a[7], a[8])[1].sum())
               for a, _ in chk.every["bid"])


def walk_mirror(kernels, name, args):
    """The plain mirror of a round kernel's own walk count: ``[sweeps]``
    of ``fence_walk`` for fence, ``[entries, walks]`` of ``bid_walk`` for
    bid."""
    if name == "fence":
        return [int(kernels.fence_walk(*args).sum())]
    rank, minrank, cur = args[6], args[7], args[8]
    return list(kernels.bid_walk(rank, minrank, cur)[2:])


def torch_equal(a, b):
    import torch

    return a.dtype == b.dtype and torch.equal(a, b)


def count_syncs(fn):
    """Run ``fn`` under torch's CUDA sync debug mode; returns its result
    and its synchronising calls, counted by source line."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the sync warnings themselves, not the note that the debug mode is a
    # prototype (emitted once a process, on its first switch)
    sites = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)
        and "prototype" not in str(w.message)
    )
    return out, sites


def churned(req, assignment, seed):
    """A 10% churn re-solve request (bench.py's churn cell): incumbents
    from a previous assignment, departed jobs replaced by new demands."""
    from kubeinfer_tpu_torch.scheduler import SolveRequest

    rng = np.random.default_rng(seed)
    current = np.asarray(assignment, np.int32).copy()
    departed = rng.random(req.num_jobs) < 0.1
    current[departed] = -1
    gpu = req.job_gpu.copy()
    gpu[departed] = rng.integers(1, 8, int(departed.sum()))
    return SolveRequest(**{**req.__dict__, "job_gpu": gpu,
                           "job_current_node": current})


def pipelined_phases(dev, backend, cpu_backend, kernels, record, card,
                     big=(10000, 20000), cpu_big=(1000, 20000), reps=10):
    """Phases (5)-(7): the round kernels against their plain versions, the
    pipelined path driven through the backend, and its times. Returns the
    round kernels' entries of the ``kernels`` line."""
    import torch

    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        cost_field,
        run_rounds,
        seed_incumbents,
    )
    from kubeinfer_tpu_torch.solver.kernels import mega_window

    w = ScoreWeights()
    Jb, Nb = big
    req20 = build_request(Jb, Nb, seed=5)
    p20, _ = problem_of(req20, dev)
    J, N = p20.jobs.valid.shape[0], p20.nodes.valid.shape[0]
    check(mega_window(N, J) is None, f"{J}x{N} has a mega window")

    # (5) kernel vs plain, and the fence and bid kernels' own walk counts
    # vs their mirrors: every round of the main loop of a fresh solve at
    # the full width, of a 700 x 60 solve with 25% gangs (N=64), of the
    # whole 10% churn solve through the backend (the preemption repair's
    # re-solves included) and of the churn loop with no incumbent seated
    kernels.fence.walk_counter = torch.zeros(1, dtype=torch.int64,
                                             device=dev)
    kernels.bid.walk_counter = torch.zeros(2, dtype=torch.int64, device=dev)
    f20 = cost_field(p20, w)
    a0, g0, m0, _ = seed_incumbents(p20, False)
    chk = CheckedOps(kernels)
    _, _, _, r20 = run_rounds(f20, p20.jobs, a0, g0, m0, 0, f20.rankf, 64,
                              ops=chk.ops())
    print(f"[5] {J}x{N}: fence/bid/accept bitwise equal to their plain "
          f"versions over {r20} rounds ({chk.calls}); walk counts equal to "
          f"the mirrors': fence {chk.walked['fence']} chunk sweeps, bid "
          f"{chk.walked['bid']} pairs tested")
    req700 = build_request(700, 60, seed=6, gang_fraction=0.25)
    p7, _ = problem_of(req700, dev)
    check(p7.nodes.valid.shape[0] == 64, "700x60 does not pad to N=64")
    f7 = cost_field(p7, w)
    a7, g7, m7, _ = seed_incumbents(p7, False)
    chk64 = CheckedOps(kernels)
    _, _, _, r7 = run_rounds(f7, p7.jobs, a7, g7, m7, 0, f7.rankf, 64,
                             ops=chk64.ops())
    print(f"[5] {p7.jobs.valid.shape[0]}x64 (halves group rule): bitwise "
          f"equal over {r7} rounds ({chk64.calls}); walk counts equal to the "
          "mirrors'")
    req20c = churned(req20, backend.solve(req20).assignment, seed=9)
    chk_c = CheckedOps(kernels)
    with chk_c.installed():
        res_c = backend.solve(req20c)
    print(f"[5] {Jb}x{Nb} 10% churn through the backend: bitwise equal over "
          f"{res_c.rounds} rounds ({chk_c.calls}); walk counts equal to the "
          f"mirrors', {home_reads(kernels, chk_c)} home-only reads (a "
          "seated incumbent is placed and does not bid)")
    # the churn problem's loop with no incumbent seated: a column whose
    # rank is above its chunks' fence minima bids at its incumbent's node
    # alone (the home-only reads)
    p20c, _ = problem_of(req20c, dev)
    f20c = cost_field(p20c, w)
    ac, gc, mc, _ = seed_incumbents(p20c, False)
    chk_h = CheckedOps(kernels)
    _, _, _, rh = run_rounds(f20c, p20c.jobs, ac, gc, mc, 0, f20c.rankf, 64,
                             ops=chk_h.ops())
    homes = home_reads(kernels, chk_h)
    check(homes > 0, "the unseated churn loop read no incumbent's home alone")
    print(f"[5] {J}x{N} churn loop, no incumbent seated: bitwise equal over "
          f"{rh} rounds ({chk_h.calls}); walk counts equal to the mirrors', "
          f"{homes} home-only reads")
    kernels.fence.walk_counter = kernels.bid.walk_counter = None
    max_err = {k: max(c.max_err[k] for c in (chk, chk64, chk_c, chk_h))
               for k in ROUND_KERNELS}
    record["round_checks"] = {"rounds_full": r20, "rounds_n64": r7,
                              "rounds_churn": res_c.rounds,
                              "calls_full": chk.calls,
                              "calls_n64": chk64.calls,
                              "calls_churn": chk_c.calls,
                              "walked_full": chk.walked,
                              "walked_churn": chk_c.walked,
                              "rounds_unseated": rh,
                              "calls_unseated": chk_h.calls,
                              "home_reads_unseated": homes}

    # (6) the pipelined path through the backend, counted
    req20g = build_request(Jb, Nb, seed=1, gang_fraction=0.25)
    reset_counts(kernels)
    res20 = backend.solve(req20)
    res20g = backend.solve(req20g)
    res20c = backend.solve(req20c)
    check(np.array_equal(res20c.assignment, res_c.assignment),
          "the churn solve differs from its checked run in [5]")
    counts = round_counts(kernels)
    check(all(counts.values()), f"the pipelined path skipped a kernel: {counts}")
    check(kernels.mega_solve.launches == 0, "a no-window solve ran mega")
    placed = check_assignment(req20, res20.assignment, "10kx20k", True)
    placed_g = check_assignment(req20g, res20g.assignment, "10kx20k gang")
    placed_c = check_assignment(req20c, res20c.assignment, "10kx20k churn")
    stay = req20c.job_current_node >= 0
    moved = float((res20c.assignment[stay] != req20c.job_current_node[stay]).mean())
    print(f"[6] pipelined path, {Jb}x{Nb}: fresh placed {placed} rounds "
          f"{res20.rounds}; 25% gangs placed {placed_g} rounds {res20g.rounds};"
          f" 10% churn placed {placed_c} rounds {res20c.rounds}, survivors "
          f"moved {moved:.4f}; launches {counts}")
    for label, (jn, nn, kw) in {
        f"{cpu_big[0]}x{cpu_big[1]}": (*cpu_big, {"seed": 8}),
        "700x60 gang 0.25": (700, 60, {"seed": 6, "gang_fraction": 0.25}),
        # more demand than capacity: gangs end incomplete, so the gang
        # repair and the fill through run_rounds run on the card too
        "1000x60 gang 0.25": (1000, 60, {"seed": 6, "gang_fraction": 0.25}),
    }.items():
        req = build_request(jn, nn, **kw)
        card_res = backend.solve(req)
        t_cpu = time.perf_counter()
        cpu_res = cpu_backend.solve(req)
        cpu_s = time.perf_counter() - t_cpu
        check_assignment(req, card_res.assignment, label)
        check(np.array_equal(card_res.assignment, cpu_res.assignment)
              and card_res.rounds == cpu_res.rounds,
              f"{label}: card and CPU solves differ")
        print(f"[6] {label}: placed {card_res.placed} rounds "
              f"{card_res.rounds}, equal to the device='cpu' solve "
              f"({cpu_s:.1f} s on the host)")
        record[f"cpu_equal_{label}"] = {"placed": card_res.placed,
                                        "rounds": card_res.rounds,
                                        "cpu_s": cpu_s}
    record["pipelined_main_path"] = {
        "launches": counts, "placed": placed, "rounds": res20.rounds,
        "placed_gang": placed_g, "rounds_gang": res20g.rounds,
        "placed_churn": placed_c, "rounds_churn": res20c.rounds,
        "churn_moved": moved,
    }

    # (7) times
    for _ in range(2):
        backend.solve(req20)
    runs = [backend.solve(req20) for _ in range(reps)]
    p50 = statistics.median(r.solve_ms for r in runs)
    enc = statistics.median(r.extras["encode_ms"] for r in runs)
    reset_counts(kernels)
    _, sync_sites = count_syncs(lambda: backend.solve(req20))
    syncs = sum(sync_sites.values())
    per_solve = round_counts(kernels)
    # per-layer split of one solve: pack (host, above), one host-to-device
    # copy + views, the cost field, the round loop
    from kubeinfer_tpu_torch.scheduler.backends import _descending_stable_perm
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    buf, _, _, Jp, Np = pack_problem_arrays(
        **req20.__dict__, job_perm=_descending_stable_perm(req20.job_priority)
    )
    unpack_ms = cuda_ms(lambda: unpack_problem(buf, Jp, Np, dev), reps=10)
    field_ms = cuda_ms(lambda: cost_field(p20, w), reps=5)

    def loop():
        run_rounds(f20, p20.jobs, a0, g0, m0, 0, f20.rankf, 64)

    loop_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        loop_ms.append((time.perf_counter() - t0) * 1e3)
    loop_p50 = statistics.median(loop_ms)
    torch.cuda.reset_peak_memory_stats()
    backend.solve(req20)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # each round kernel on every round's inputs of the fresh solve
    entries, rec = round_kernel_times(kernels, chk, card, counts, per_solve,
                                      max_err, f"{J}x{N}")
    record["round_kernel_times"] = rec
    print(f"[7] {card}: p50 pack+solve {Jb}x{Nb} {p50:.3f} ms (pack "
          f"{enc:.3f} ms), {res20.rounds} rounds, main loop {loop_p50:.3f} ms"
          f" = {loop_p50 / max(r20, 1):.3f} ms/round over {r20} rounds; per "
          f"solve: launches {per_solve}, {syncs} synchronising calls "
          f"{dict(sync_sites)}; layers: copy+unpack {unpack_ms:.3f} ms, cost "
          f"field {field_ms:.3f} ms; peak device memory {peak_gb:.2f} GB")
    record["pipelined_times"] = {
        "p50_ms": p50, "pack_ms": enc, "rounds": res20.rounds,
        "loop_ms": loop_p50, "loop_rounds": r20,
        "ms_per_round": loop_p50 / max(r20, 1),
        "launches_per_solve": per_solve, "syncs_per_solve": syncs,
        "sync_sites": dict(sync_sites), "unpack_ms": unpack_ms,
        "cost_field_ms": field_ms, "peak_gb": peak_gb,
    }
    return entries


def round_bound(name, args):
    """(bound ms, "bytes" or "operations", note, counts) of one round
    kernel call: what these inputs need. fence: the larger of its bytes
    and the compare-selects of the chunk sweeps its walk takes
    (``fence_walk``), beside the dense count (N x unplaced jobs); bid: the
    bytes of the S entries whose pair is allowed (the entries any kernel
    must read) and of the vectors, beside the count of the active columns'
    S; accept: its O(N + J) bytes."""
    import torch

    from kubeinfer_tpu_torch.solver.kernels import (
        FENCE_CHUNK,
        RANK_INF,
        fence_walk,
    )

    if name == "fence":
        gf, mf, d, md, rank = args
        N, J = gf.shape[0], d.shape[0]
        sweeps = int(fence_walk(*args).sum())
        pairs = sweeps * FENCE_CHUNK * 64  # a warp's 64 nodes x 32 jobs
        dense = N * int((rank < RANK_INF).sum())
        moved_b = N * 8 + J * 12 + N * 4
        op_s, b_s = pairs / F32_OPS_PER_S, moved_b / HBM_BYTES_PER_S
        return (max(op_s, b_s) * 1e3, "operations" if op_s > b_s else "bytes",
                f"{moved_b} bytes; {pairs} compare-selects in the {sweeps} "
                f"chunk sweeps of the walk at 67 TFLOP/s; the dense count of "
                f"the earlier design, N x unplaced jobs: {dense}, "
                f"{dense / F32_OPS_PER_S * 1e3:.5f} ms",
                {"sweeps": sweeps, "dense_pairs": dense})
    if name == "bid":
        S, u, gf, mf, d, md, rank, minrank, cur = args
        N, J = S.shape
        finite = minrank < RANK_INF * 0.5
        max_mr = torch.where(finite, minrank, -1.0).max()
        active = (rank < RANK_INF * 0.5) & ((rank <= max_mr) | (cur >= 0))
        cols = int(active.sum())
        allowed = 0
        for n0 in range(0, N, 2048):  # [2048, J] at a time
            n = torch.arange(n0, min(N, n0 + 2048), device=S.device)
            ok = ((d[None, :] <= (gf[n] + 1e-4)[:, None])
                  & (md[None, :] <= (mf[n] + 1e-4)[:, None])
                  & ((rank[None, :] <= minrank[n][:, None])
                     | (cur[None, :] == n[:, None]))
                  & (rank[None, :] < RANK_INF * 0.5))
            allowed += int(ok.sum())
        moved_b = allowed * 4 + N * 16 + J * 16 + J * 8
        return (moved_b / HBM_BYTES_PER_S * 1e3, "bytes",
                f"S of {allowed} allowed pairs ({allowed * 4} bytes); the "
                f"active columns' S, the earlier count: {cols} columns, "
                f"{cols * N * 4} bytes, "
                f"{(cols * N * 4 + N * 16 + J * 24) / HBM_BYTES_PER_S * 1e3:.5f}"
                " ms", {"allowed": allowed, "active_cols": cols})
    choice = args[0]
    N, J = args[4].shape[0], choice.shape[0]
    moved_b = J * 16 + N * 8 + J + N * 8
    return (moved_b / HBM_BYTES_PER_S * 1e3, "bytes",
            "O(N + J) bytes; launch and barrier latency set the pace", {})


def accept_barriers() -> int:
    """The grid barriers in one launch of the accept kernel: the
    ``grid.sync()`` calls in ``accept_kernel``'s body, which has no loop
    around them."""
    src = (pathlib.Path(__file__).resolve().parent / "kubeinfer_tpu_torch"
           / "solver" / "csrc" / "round_ops.cu").read_text()
    body = src[src.index("accept_kernel(AcceptParams P)"):]
    return body[:body.index("\n}\n")].count("grid.sync()")


def round_kernel_times(kernels, chk, card, counts, per_solve, max_err, shape):
    """[7]: fence, bid and accept on every round's inputs of a checked
    solve (``chk.every``) by device time (``device_ms``), each beside its
    bound; round 1 also by CUDA events over calls (the measure up to PR
    12), by the wrapper's host us and by its plain version. Returns the
    three entries of the ``kernels`` line and the record."""
    plain = {"fence": kernels.fence_minrank, "bid": kernels.round_bids,
             "accept": kernels.dense_accept}
    sources = {"fence": 587, "bid": 275, "accept": 420}
    also = {"fence": None, "bid": 513, "accept": 1125}
    rounds = len(chk.every["fence"])
    per_round = {name: [] for name in ROUND_KERNELS}
    for name in ROUND_KERNELS:
        fn = getattr(kernels, name)
        calls = chk.every[name]
        per = len(calls) // rounds  # accept: two passes a round
        for r in range(rounds):
            row = {"device_ms": 0.0, "bound_ms": 0.0}
            for args, kw in calls[r * per:(r + 1) * per]:
                row["device_ms"] += device_ms(lambda: fn(*args, **kw))
                bound_ms, bound_by, note, n = round_bound(name, args)
                row["bound_ms"] += bound_ms
                row["bound_by"], row["note"], row["counts"] = bound_by, note, n
            if r < len(chk.walk_log.get(name, [])):
                row["walk"] = chk.walk_log[name][r]
            per_round[name].append(row)
    for r in range(rounds):
        walks = {name: per_round[name][r].get("walk") for name in ("fence",
                                                                   "bid")}
        print(f"[7] {card}: round {r + 1}/{rounds}: " + "; ".join(
            f"{name} {per_round[name][r]['device_ms']:.4f} ms device, bound "
            f"{per_round[name][r]['bound_ms']:.5f} ms "
            f"({per_round[name][r]['bound_by']})" for name in ROUND_KERNELS)
            + f"; walks: fence {walks['fence']} chunk sweeps, bid "
            f"{walks['bid']} (pairs tested, chunks walked), "
            f"{per_round['bid'][r]['counts']['allowed']} allowed pairs")
    entries, rec = [], {"per_round": per_round}
    for name in ROUND_KERNELS:
        fn = getattr(kernels, name)
        args, kw = chk.every[name][0]
        first = per_round[name][0]
        event_ms = cuda_ms(lambda: fn(*args, **kw), reps=20)
        us = host_us(lambda: fn(*args, **kw), reps=100)
        pms = cuda_ms(lambda: plain[name](*args, **kw), reps=3)
        total = sum(row["device_ms"] for row in per_round[name])
        yard = ""
        if name == "bid":
            S, cols = args[0], first["counts"]["active_cols"]
            rec["amin_ms"] = device_ms(lambda: S[:, :cols].amin(dim=0))
            yard = (f"; torch.amin over the first {cols} columns of S, read "
                    f"once, {rec['amin_ms']:.4f} ms device (a yardstick of "
                    "the same bytes, not a library call for the function)")
        total_bound = sum(row["bound_ms"] for row in per_round[name])
        if name == "accept":
            rec["accept_barriers"] = accept_barriers()
            check(rec["accept_barriers"] == 1,
                  f"accept_kernel has {rec['accept_barriers']} grid barriers")
            yard = (f"; {rec['accept_barriers']} grid barrier a launch "
                    "(accept_kernel), one workspace for the solve's "
                    f"{per_solve[name]} calls (the earlier kernel had "
                    "two barriers and allocated its own)")
        print(f"[7] {card}: {name} round 1 {first['device_ms']:.4f} ms device "
              f"(CUDA events over calls {event_ms:.4f} ms), host {us:.1f} us "
              f"a call, plain {pms:.3f} ms, bound {first['bound_ms']:.5f} ms "
              f"({first['bound_by']}: {first['note']}); over the {rounds} "
              f"rounds {total:.4f} ms device against a bound of "
              f"{total_bound:.5f} ms; {per_solve[name]} launches per {shape} "
              f"solve{yard}")
        rec[name] = {"device_ms": first["device_ms"], "event_ms": event_ms,
                     "host_us": us, "plain_ms": pms,
                     "bound_ms": first["bound_ms"],
                     "bound_by": first["bound_by"], "note": first["note"],
                     "solve_device_ms": total, "solve_bound_ms": total_bound,
                     "launches_per_solve": per_solve[name]}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "kubeinfer_tpu_torch/solver/csrc/round_ops.cu",
            "replaces": f"kubeinfer_tpu/solver/pallas_kernels.py:{sources[name]}",
            **({"also_replaces":
                f"kubeinfer_tpu/solver/pallas_kernels.py:{also[name]}"}
               if also[name] else {}),
            "launches": counts[name],
            "max_abs_err": max_err[name],
            "ms": first["device_ms"],
            "plain_ms": pms,
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "check": f"bitwise equal to its plain version on every round "
                     f"at {shape} (fresh, churn, churn unseated) and at N=64"
                     + ("; its own walk count equal to its mirror's"
                        if name != "accept" else
                        "; one grid barrier a launch, one workspace a solve "
                        "reused by every call"),
        })
    return entries, rec


def whole_node_request(J, N, seed=3):
    """bench.py's whole-node auction request (bench.py:2901-2912: 64 GPUs
    a job on 64-GPU, 512 GiB nodes, 2% cache density), at J x N."""
    from kubeinfer_tpu_torch.scheduler import SolveRequest

    rng = np.random.default_rng(seed)
    return SolveRequest(
        job_gpu=np.full(J, 64.0, np.float32),
        job_mem_gib=rng.integers(64, 512, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        job_model=rng.integers(0, 256, J).astype(np.int32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=(rng.random((N, 256)) < 0.02).astype(np.uint8),
    )


def auction_inputs(req, dev):
    """The auction loop's inputs for a request, as the backend builds them:
    priority sort, pack, unpack, benefit field, tie-break."""
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        auction_benefit,
        auction_tiebreak,
    )

    p, _ = problem_of(req, dev)
    J, N = p.jobs.valid.shape[0], p.nodes.valid.shape[0]
    return (auction_benefit(p, ScoreWeights()), auction_tiebreak(J, N, dev),
            p.jobs.valid)


def auction_phases(dev, kernels, record, card, big=(4096, 4096),
                   wide=(1000, 24000)):
    """Phases (9)-(11): the auction kernel against its plain version, the
    jax-auction path through the backend and the /solve handler, and its
    times. ``big`` and ``wide`` are the (jobs, nodes) of the whole-node
    fields beyond L2 and past ``auction_plan``'s line (a CPU rehearsal
    cuts them). Returns the auction's entry of the ``kernels`` line."""
    import torch

    from kubeinfer_tpu_torch.scheduler import (
        SolveRequest,
        get_backend,
        solve_service_handler,
    )
    from kubeinfer_tpu_torch.solver.core import auction_tiebreak

    # (9) kernel vs plain, bitwise, on the same card tensors
    req1k = whole_node_request(1000, 1000)
    req4k = whole_node_request(*big)
    identical = SolveRequest(  # TestAuction.test_identical_fleet_converges_fast
        job_gpu=np.full(256, 8.0, np.float32),
        job_mem_gib=np.full(256, 8.0, np.float32),
        job_priority=np.zeros(256, np.float32),
        node_gpu_free=np.full(256, 8.0, np.float32),
        node_mem_free_gib=np.full(256, 64.0, np.float32),
    )
    rng = np.random.default_rng(0)
    field = rng.normal(0.0, 3.0, (64, 64)).astype(np.float32)
    field[rng.random((64, 64)) < 0.25] = -1e9
    random64 = (torch.from_numpy(field).to(dev),
                auction_tiebreak(64, 64, dev),
                torch.from_numpy(rng.random(64) >= 0.1).to(dev))
    big_label = f"{big[0]}x{big[1]} whole-node"
    wide_label = f"{wide[0]}x{wide[1]} whole-node, past the plan's line"
    cases = {
        "1kx1k whole-node": auction_inputs(req1k, dev),
        "256 identical": auction_inputs(identical, dev),
        "64x64 random, 25% infeasible, 10% invalid": random64,
        big_label: auction_inputs(req4k, dev),
        wide_label: auction_inputs(whole_node_request(*wide), dev),
    }
    sms = kernels._sm_count(dev)
    max_err, checked = 0.0, {}
    for label, (b, t, v) in cases.items():
        active, near = [], []
        plan = kernels.auction_plan(*b.shape, sms)
        check(plan.route == ("wide" if label == wide_label else "shared"),
              f"{label}: auction_plan routes {b.shape} to {plan.route}")
        walked = torch.zeros(3, dtype=torch.int64, device=dev)
        kernels.auction_solve.walk_counter = walked
        try:
            ka, ki = kernels.auction_solve(b, t, v, 0.01, max_iters=512)
        finally:
            kernels.auction_solve.walk_counter = None
        pa, pi = kernels.auction_rounds(b, t, v, 0.01, max_iters=512,
                                        active_rows=active, near_entries=near)
        mirror = kernels.auction_walk(b, t, v, 0.01, max_iters=512,
                                      plan=plan).tolist()
        torch.cuda.synchronize()
        err = float((ka - pa).abs().max())
        max_err = max(max_err, err)
        same = torch.equal(ka, pa) and int(ki) == int(pi)
        walk = walked.tolist()
        print(f"[9] {label} ({b.shape[0]}x{b.shape[1]}, route "
              f"{plan.route}, {plan.blocks} blocks): kernel iters {int(ki)} "
              f"placed {int((ka >= 0).sum())}, plain iters {int(pi)}; "
              f"bitwise_equal={same} max_abs_err={err}; walk (rows, "
              f"tie-break entries, grid barriers) {walk}, auction_walk's "
              f"{mirror}")
        check(same, f"auction_solve != auction_rounds on {label}")
        check(walk == mirror and walk[:2] == [sum(active), sum(near)],
              f"{label}: the kernel's walk {walk} != auction_walk's "
              f"{mirror} (active rows {sum(active)}, near {sum(near)})")
        check(walk[2] == (int(ki) if plan.route == "shared"
                          else 1 + 2 * int(ki)),
              f"{label}: {walk[2]} grid barriers in {int(ki)} iterations")
        # the bytes this run's data needs: the benefit row of every active
        # job in every iteration, and the tie-break only at the near
        # entries of the rows that bid
        checked[label] = {"iters": int(ki), "active_rows": sum(active),
                          "near_entries": sum(near),
                          "bound_bytes": 4 * b.shape[1] * sum(active)
                          + 4 * sum(near),
                          "placed": int((ka >= 0).sum()),
                          "route": plan.route, "blocks": plan.blocks,
                          "walk": walk}
    record["auction_checks"] = checked

    # (10) the auction path, counted
    backend = get_backend("jax-auction")
    cpu_backend = get_backend("jax-auction", "cpu")
    gang = whole_node_request(960, 1000, seed=4)
    gang.job_gang = np.where(
        np.arange(960) < 240, np.arange(960) // 4, -1).astype(np.int32)
    gang.node_gpu_free[rng.choice(1000, 100, replace=False)] = 32.0
    body = {"policy": "jax-auction", "jobs": {
        "gpu": [8.0] * 32, "memGib": [16.0] * 32,
        "priority": [float(i % 3) for i in range(32)]},
        "nodes": {"gpuFree": [8.0] * 64, "memFreeGib": [64.0] * 64}}
    launches = collections.Counter()
    results = {}
    for label, req in (("1kx1k fresh", req1k), ("960x1k 25% gangs", gang)):
        reset_counts(kernels)
        results[label] = backend.solve(req)
        counts = {"auction_solve": kernels.auction_solve.launches,
                  "mega_solve": kernels.mega_solve.launches}
        launches.update(counts)
        check(counts["auction_solve"] == 1,
              f"{label}: {counts['auction_solve']} auction launches")
        res = results[label]
        check(res.policy == "jax-auction", f"{label}: fell back to greedy")
        placed = check_assignment(req, res.assignment, label,
                                  expect_all=label == "1kx1k fresh")
        hosts = res.assignment[res.assignment >= 0]
        check(len(np.unique(hosts)) == len(hosts),
              f"{label}: a node hosts two whole-node jobs")
        cpu = cpu_backend.solve(req)
        check(np.array_equal(cpu.assignment, res.assignment)
              and cpu.rounds == res.rounds and cpu.placed == res.placed,
              f"{label}: card and CPU auction solves differ")
        print(f"[10] jax-auction {label}: placed {placed}, {res.rounds} "
              f"iterations, launches {counts}; equal to the device='cpu' "
              "solve")
    check(launches["mega_solve"] >= 1 and
          kernels.mega_solve.launches >= 1,
          "the gang case's fill did not run mega")
    reset_counts(kernels)
    out = solve_service_handler(body)
    handler_launches = kernels.auction_solve.launches
    launches["auction_solve"] += handler_launches
    check(handler_launches == 1 and out["policy"] == "jax-auction"
          and out["placed"] == 32, f"/solve jax-auction 32x64: {out}")
    check(out == {**solve_service_handler(body, device="cpu"),
                  "solveMs": out["solveMs"]},
          "/solve jax-auction 32x64: card and CPU differ")
    print(f"[10] /solve jax-auction 32x64 (a 64x64 bucket): placed "
          f"{out['placed']}, {out['rounds']} iterations, equal to the CPU")
    record["auction_main_path"] = {
        "launches": dict(launches),
        **{label: {"placed": r.placed, "rounds": r.rounds}
           for label, r in results.items()},
        "handler": {"placed": out["placed"], "rounds": out["rounds"]},
    }

    # (11) times
    for _ in range(2):
        backend.solve(req1k)
    host_ms, event_ms = [], []
    for _ in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = backend.solve(req1k)
        end.record()
        end.synchronize()
        host_ms.append(res.solve_ms)
        event_ms.append(start.elapsed_time(end))
    p50, p50_event = statistics.median(host_ms), statistics.median(event_ms)
    pack = statistics.median(backend.solve(req1k).extras["encode_ms"]
                             for _ in range(5))
    _, sync_sites = count_syncs(lambda: backend.solve(req1k))
    b, t, v = cases["1kx1k whole-node"]
    iters = checked["1kx1k whole-node"]["iters"]
    times = {}
    for label in ("1kx1k whole-node", big_label, wide_label):
        fb, ft, fv = cases[label]
        kernel = lambda: kernels.auction_solve(fb, ft, fv, 0.01, max_iters=512)
        c = checked[label]
        times[label] = row = {
            "device_ms": device_ms(kernel),
            "event_ms": cuda_ms(kernel, reps=20),
            "host_us": host_us(kernel, reps=50),
            "iters": c["iters"], "route": c["route"],
            "bound_ms": c["bound_bytes"] / HBM_BYTES_PER_S * 1e3}
        print(f"[11] {card}: auction_solve {label}, route {c['route']}: "
              f"{row['device_ms']:.4f} ms device (a CUDA graph of 20), "
              f"{row['device_ms'] * 1e3 / c['iters']:.2f} us an iteration "
              f"over {c['iters']}, {row['event_ms']:.4f} ms wall a call by "
              f"CUDA events, host {row['host_us']:.1f} us a call; bound "
              f"{row['bound_ms']:.5f} ms (bytes)")
    kernel_ms = times["1kx1k whole-node"]["device_ms"]
    plain_ms = cuda_ms(
        lambda: kernels.auction_rounds(b, t, v, 0.01, max_iters=512), reps=3)
    N = b.shape[1]
    bound_bytes = checked["1kx1k whole-node"]["bound_bytes"]
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    # per-layer split of one solve: the benefit field and tie-break, the
    # kernel, and solve_auction on the unpacked problem (the rest of it is
    # the gang repair, the fill and their host syncs)
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        auction_benefit,
        solve_auction,
    )

    p1k, _ = problem_of(req1k, dev)
    field_ms = cuda_ms(lambda: (auction_benefit(p1k, ScoreWeights()),
                                auction_tiebreak(N, N, dev)), reps=20)
    solve_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_auction(p1k, device=dev)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    solve_p50 = statistics.median(solve_ms)
    k4_ms = times[big_label]["device_ms"]
    c4 = checked[big_label]
    bound4_ms = times[big_label]["bound_ms"]
    print(f"[11] {card}: jax-auction 1kx1k p50 pack+solve {p50:.3f} ms "
          f"(CUDA events {p50_event:.3f} ms, pack {pack:.3f} ms), "
          f"{sum(sync_sites.values())} synchronising calls "
          f"{dict(sync_sites)}; layers: solve_auction on the unpacked "
          f"problem {solve_p50:.3f} ms, of which benefit field + tie-break "
          f"{field_ms:.3f} ms and the kernel; auction_solve {kernel_ms:.4f} "
          f"ms/launch device, "
          f"{iters} iterations, {kernel_ms / iters * 1e3:.2f} us/iteration, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms (bytes: "
          f"{bound_bytes} B: the benefit rows of "
          f"{checked['1kx1k whole-node']['active_rows']} active rows and "
          f"the tie-break at {checked['1kx1k whole-node']['near_entries']} "
          f"near entries, over all iterations); {big_label} "
          f"{k4_ms:.4f} ms/launch, {c4['iters']} iterations, bound "
          f"{bound4_ms:.4f} ms")
    record["auction_times"] = {
        "p50_ms": p50, "p50_event_ms": p50_event, "pack_ms": pack,
        "syncs_per_solve": sum(sync_sites.values()),
        "sync_sites": dict(sync_sites), "solve_auction_ms": solve_p50,
        "field_ms": field_ms, "kernel_ms": kernel_ms,
        "iters": iters, "ms_per_iter": kernel_ms / iters,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "kernel_4096_ms": k4_ms, "iters_4096": c4["iters"],
        "bound_4096_ms": bound4_ms, "fields": times,
    }
    return {
        "name": "auction_solve",
        "route": "cuda",
        "source": "kubeinfer_tpu_torch/solver/csrc/auction.cu",
        "replaces": "kubeinfer_tpu/solver/pallas_kernels.py:1306",
        "launches": launches["auction_solve"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "check": "bitwise equal (assigned, iterations) to auction_rounds "
                 "at 1024x1024, 256x256, 64x64 and 4096x4096 (the "
                 "shared-state kernel, one grid barrier an iteration) and "
                 "at 1024x24576 (past auction_plan's line: the "
                 "two-barrier kernel); its own walk count (rows, tie-break "
                 "entries, grid barriers) equal to auction_walk's on each",
    }


def storm_plant(n_replicas=100, n_requests=256, families=32, block_size=32,
                prefix_blocks=8, tail=8, seed=23, fps=None):
    """bench.py:fleet_storm_bench's planted fleet and requests: real
    summaries (3 families a replica at a seeded depth), seeded queue depths
    and KV fill, 4 draining, 4 stale (15 s old) and 2 dead (40 s old)
    replicas; each request a family's 8-block prefix and 8 tail tokens.
    ``fps`` is the fingerprint chain (the port's
    ``kv_blocks.prefix_fingerprints`` unless given). Returns (replicas,
    requests, dead, draining, stale): each replica (name, serving stats,
    age in s) as ``FleetRouter.update_replica`` takes them, the masks as
    sets of replica indices."""
    if fps is None:
        from kubeinfer_tpu_torch.inference.kv_blocks import (
            prefix_fingerprints as fps,
        )

    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 50_000, prefix_blocks * block_size).tolist()
                for _ in range(families)]
    draining = set(rng.choice(n_replicas, 4, replace=False).tolist())
    stale = set(rng.choice(n_replicas, 4, replace=False).tolist())
    dead = set(rng.choice(n_replicas, 2, replace=False).tolist())
    replicas = []
    for i in range(n_replicas):
        chain: set[int] = set()
        for k in range(3):
            fam = (i + k * 11) % families
            depth = int(rng.integers(2, prefix_blocks + 1))
            chain.update(fps(prefixes[fam][: depth * block_size],
                             block_size))
        replicas.append((f"r{i:03d}", {  # zero-padded: name == column order
            "queue_depth": int(rng.integers(0, 5)), "n_slots": 2,
            "kv_blocks_free": int(rng.integers(8, 64)),
            "kv_blocks_in_use": int(rng.integers(0, 32)),
            "draining": i in draining,
            "cache_summary": {"fingerprints": sorted(chain), "version": 1,
                              "block_size": block_size},
        }, 40.0 if i in dead else (15.0 if i in stale else 0.0)))
    requests = [prefixes[int(rng.integers(0, families))]
                + rng.integers(0, 50_000, tail).tolist()
                for _ in range(n_requests)]
    return replicas, requests, dead, draining, stale


def storm_batch(batch=256, **plant):
    """``storm_plant``'s fleet and its first batch of requests, with no
    router object: the planes FleetRouter.route_batch hands the route
    solve (dead and draining replicas masked out, stale ones flagged,
    pressure = queue depth / slots, KV headroom)."""
    from kubeinfer_tpu_torch.solver.routing import build_match_plane

    replicas, requests, dead, draining, stale = storm_plant(
        n_requests=batch, **plant)
    n_replicas = len(replicas)
    fp_sets = [frozenset(st["cache_summary"]["fingerprints"])
               for _, st, _ in replicas]
    sizes = [st["cache_summary"]["block_size"] for _, st, _ in replicas]
    ok = np.zeros(n_replicas, bool)
    st = np.zeros(n_replicas, bool)
    pressure = np.zeros(n_replicas, np.float32)
    slots = np.ones(n_replicas, np.float32)
    headroom = np.ones(n_replicas, np.float32)
    for i, (_, stats, _) in enumerate(replicas):
        if i in dead or i in draining:
            continue
        ok[i], st[i] = True, i in stale
        pressure[i] = stats["queue_depth"] / stats["n_slots"]
        slots[i] = stats["n_slots"]
        free, used = stats["kv_blocks_free"], stats["kv_blocks_in_use"]
        headroom[i] = free / (free + used)

    def planes():
        match = build_match_plane(requests, fp_sets, sizes)
        return np.where(ok[None, :], match, -1).astype(np.int32)

    return planes, (pressure, st, slots, headroom)


def prefix_fingerprints(tokens, block_size):
    """Per-request fingerprint chain (the reference's
    kv_blocks.prefix_fingerprints), through the port's batched form."""
    from kubeinfer_tpu_torch.solver.routing import batched_prefix_fingerprints

    fps = batched_prefix_fingerprints([tokens], block_size, 1 << 30)[0]
    return [int(x) for x in fps if x != -1]


def affinity_inputs(J=10000, N=1000, seed=17):
    """The reconciler's solved_affinity inputs for build_request(J, N):
    its job models and cache bitmap, seeded queue depths over slots in
    {1, 2, 4}, alpha and cutoff at the router's defaults (4 and 1)."""
    req = build_request(J, N)
    rng = np.random.default_rng(seed)
    slots = rng.choice([1.0, 2.0, 4.0], N).astype(np.float32)
    pressure = (rng.integers(0, 9, N) / slots).astype(np.float32)
    return req.job_model, req.node_cached, pressure, slots


class CheckedPick:
    """A stand-in for ``kernels.route_pick`` that runs the kernel and its
    plain version on the same inputs, holds them bitwise equal, and hands
    the kernel's result on. Keeps the largest inputs it saw. While it
    stands in, the wrapper's ``route_pick.launches += 1`` resolves to this
    object's ``launches``, so the checking launches stay off the
    wrapper's own count. ``check_s`` sums the host seconds of the checks
    alone (the plain pick and the compare, timed once the kernel has
    finished), for callers that time the checked path without them."""

    def __init__(self, kernels):
        self.kernel, self.plain = kernels.route_pick, kernels.route_pick_plain
        self.launches = 0
        self.calls = 0
        self.max_err = 0.0
        self.largest = None
        self.check_s = 0.0

    def __call__(self, match, bias, active):
        import torch

        got = self.kernel(match, bias, active)
        if match.is_cuda:
            torch.cuda.synchronize(match.device)
        t0 = time.perf_counter()
        want = self.plain(match, bias, active)
        for g, w in zip(got, want):
            check(torch_equal(g, w),
                  f"route_pick != route_pick_plain at {tuple(match.shape)}, "
                  f"call {self.calls}")
            self.max_err = max(self.max_err, float(
                (g.double() - w.double()).abs().max()))
        if self.largest is None or match.numel() > self.largest[0].numel():
            self.largest = (match, bias, active)
        self.calls += 1
        self.check_s += time.perf_counter() - t0
        return got


def route_phases(dev, kernels, record, card):
    """Phase (12): the route pick against its plain version, the route
    solve and solved_affinity on the card against device="cpu", launch
    counts and times. Returns the route pick's entry of the ``kernels``
    line."""
    import torch

    from kubeinfer_tpu_torch.solver import routing

    planes, vectors = storm_batch()
    match = planes()
    B = match.shape[0]
    model, cached, pressure, slots = affinity_inputs()
    aff_kw = dict(alpha=4.0, cutoff=1.0)

    # the pick, bitwise, on every call of a solved_affinity solve at 10k x
    # 1k (12288 x 1024) and of the storm solves, and at 256 x 128 with
    # ties, inactive rows and an active row with no candidate
    chk = CheckedPick(kernels)
    orig = kernels.route_pick
    kernels.route_pick = chk
    try:
        routing.solved_affinity(model, cached, pressure, slots, device=dev,
                                **aff_kw)
        big = chk.largest
        rp, _, _ = routing.pack_route_arrays(match, *vectors, device=dev)
        for mode in ("parity", "greedy", "auction"):
            routing.solve_routes(rp, mode=mode)
        rng = np.random.default_rng(2)
        small = rng.integers(-1, 4, (256, 128)).astype(np.int32)
        small[128] = -1
        chk(torch.from_numpy(small).to(dev),
            torch.from_numpy((rng.integers(-8, 8, 128) / 2.0)
                             .astype(np.float32)).to(dev),
            torch.from_numpy(rng.random(256) < 0.9).to(dev))
    finally:
        kernels.route_pick = orig
    check(tuple(big[0].shape) == (12288, 1024),
          f"solved_affinity plane {tuple(big[0].shape)}")
    print(f"[12] route_pick bitwise equal to route_pick_plain on {chk.calls} "
          f"calls (solved_affinity 12288x1024, storm {rp.match.shape[0]}x"
          f"{rp.match.shape[1]} in three modes, 256x128 with ties and dead "
          "rows)")

    # the route solve through its entry points, counted
    route_launches = 0
    for mode, per_round in (("parity", 0), ("greedy", 1), ("auction", 2)):
        reset_counts(kernels)
        rp, _, _ = routing.pack_route_arrays(match, *vectors, device=dev)
        out = routing.solve_routes(rp, mode=mode)
        picks = routing.decode_routes(out, B)
        n = kernels.route_pick.launches
        route_launches += n
        cpu_rp, _, _ = routing.pack_route_arrays(match, *vectors, device="cpu")
        ref = routing.solve_routes(cpu_rp, mode=mode)
        check(torch.equal(out.replica.cpu(), ref.replica)
              and torch.equal(out.score.cpu(), ref.score)
              and int(out.rounds) == int(ref.rounds),
              f"solve_routes {mode}: card and CPU differ")
        check(n == per_round * int(out.rounds) + 1,
              f"solve_routes {mode}: {n} launches for {int(out.rounds)} rounds")
        check((picks >= 0).all(), f"solve_routes {mode}: a request unrouted")
        print(f"[12] solve_routes {mode} on the storm batch ({B} requests x "
              f"100 replicas): {int(out.rounds)} rounds, {n} route_pick "
              f"launches, {len(np.unique(picks))} replicas used; equal to "
              "the device='cpu' solve")
    reset_counts(kernels)
    aff = routing.solved_affinity(model, cached, pressure, slots, device=dev,
                                  **aff_kw)
    n_aff = kernels.route_pick.launches
    route_launches += n_aff
    t0 = time.perf_counter()
    aff_cpu = routing.solved_affinity(model, cached, pressure, slots,
                                      device="cpu", **aff_kw)
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(aff, aff_cpu), "solved_affinity: card and CPU differ")
    check(n_aff >= 2, f"solved_affinity: {n_aff} route_pick launches")
    print(f"[12] solved_affinity 10kx1k: {int(aff.sum())} affinity bits, "
          f"{n_aff} route_pick launches; equal to the device='cpu' solve "
          f"({cpu_s:.1f} s on the host)")

    # times at the solved_affinity plane
    m, bias, act = big
    Bb, R = m.shape
    kernel_ms = cuda_ms(lambda: kernels.route_pick(m, bias, act), reps=50)
    plain_ms = cuda_ms(lambda: kernels.route_pick_plain(m, bias, act), reps=10)
    s = torch.where((m >= 0) & act[:, None], m.float() + bias[None, :],
                    torch.tensor(kernels.ROUTE_NEG, device=dev))
    library_ms = cuda_ms(lambda: torch.max(s, dim=1), reps=50)
    # device time (a CUDA graph of 20 launches): at ~0.02 ms a call, the
    # CUDA-event times above include the host's per-call work
    kernel_dev = device_ms(lambda: kernels.route_pick(m, bias, act))
    library_dev = device_ms(lambda: torch.max(s, dim=1))
    # the kernel reads no match row of an inactive request
    n_act = int(act.sum())
    bound_bytes = 4 * n_act * R + 4 * R + Bb + 8 * Bb
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3

    def p50_ms(fn, reps):
        fn()
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    def storm_once():
        rp_, _, _ = routing.pack_route_arrays(planes(), *vectors, device=dev)
        return routing.decode_routes(routing.solve_routes(rp_), B)

    storm_p50 = p50_ms(storm_once, 20)
    plane_p50 = p50_ms(planes, 20)
    aff_p50 = p50_ms(lambda: routing.solved_affinity(
        model, cached, pressure, slots, device=dev, **aff_kw), 10)
    # its layers: the pack (host padding + the copy of the 50 MB plane)
    # and the greedy solve + readback on the packed problem
    aff_match = np.where(cached[:, model].T.astype(bool), 4, 0).astype(np.int32)
    aff_vectors = (pressure, np.zeros(len(slots), bool), slots,
                   np.ones(len(slots), np.float32))
    aff_pack_p50 = p50_ms(lambda: routing.pack_route_arrays(
        aff_match, *aff_vectors, device=dev), 10)
    aff_rp, _, _ = routing.pack_route_arrays(aff_match, *aff_vectors,
                                             device=dev)
    aff_solve_p50 = p50_ms(lambda: routing.decode_routes(routing.solve_routes(
        aff_rp, alpha=4.0, stale_penalty=0.0, mode="greedy"), len(model)), 10)
    print(f"[12] {card}: route_pick device {kernel_dev:.5f} ms/launch at "
          f"{Bb}x{R} (CUDA events over calls {kernel_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes: "
          f"{n_act} active rows), "
          f"torch.max over a precomputed masked plane device "
          f"{library_dev:.5f} ms (CUDA events {library_ms:.4f} ms; a lower "
          f"yardstick: no mask, no add); p50 match plane + pack + "
          f"parity solve + decode at B={B}: {storm_p50:.3f} ms "
          f"({storm_p50 / B * 1e3:.2f} us/request; the host match plane "
          f"{plane_p50:.3f} ms of it); p50 solved_affinity 10kx1k "
          f"{aff_p50:.3f} ms (pack {aff_pack_p50:.3f} ms, greedy solve + "
          f"readback {aff_solve_p50:.3f} ms)")
    record["route"] = {
        "launches": route_launches, "checked_calls": chk.calls,
        "kernel_ms": kernel_dev, "kernel_wall_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_dev,
        "library_wall_ms": library_ms, "bound_ms": bound_ms,
        "bound_active_rows": n_act,
        "storm_p50_ms": storm_p50, "storm_plane_ms": plane_p50,
        "affinity_p50_ms": aff_p50, "affinity_pack_ms": aff_pack_p50,
        "affinity_solve_ms": aff_solve_p50,
        "affinity_launches": n_aff, "affinity_cpu_s": cpu_s,
    }
    return {
        "name": "route_pick",
        "route": "cuda",
        "source": "kubeinfer_tpu_torch/solver/csrc/route_pick.cu",
        "replaces": "kubeinfer_tpu/solver/pallas_kernels.py:1433",
        "launches": route_launches,
        "max_abs_err": chk.max_err,
        "ms": kernel_dev,
        "wall_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_dev,
        "library_wall_ms": library_ms,
        "timing": "ms, library_ms: device time a launch (a CUDA graph of "
                  "20 launches, replays timed by CUDA events); *_wall_ms: "
                  "CUDA events over back-to-back calls",
        "library_call": "torch.max(s, dim=1) on a precomputed masked f32 "
                        "plane (leaves out the mask and the add: a lower "
                        "yardstick)",
        "check": "bitwise equal to route_pick_plain on every call of "
                 "solved_affinity at 12288x1024 and of the storm solves, "
                 "and at 256x128",
    }


# --- the reconcile tick on the card: phase (29) --------------------------------

TICK_LAUNCHES = ("mega_solve", *ROUND_KERNELS, "auction_solve", "route_pick")
TICK_NODE_TTL_S = 600.0  # every node's heartbeat stays fresh for the phase
TICK_TOKEN = "chip-smoke-token"


def tick_state(seed=29, n_nodes=1024, n_greedy=1280, n_whole=64, per=8):
    """What phase (29) writes to the store, shaped as
    ``build_request(10000, 1000, gang_fraction=0.25)`` shapes a solve:
    ``n_nodes`` NodeStates (64 GPUs, 512 GiB, topology 0-15, 2% of 255
    model names cached, a fresh heartbeat, 8 serving slots and a seeded
    queue depth), ``n_greedy`` jax-greedy services of ``per`` replicas
    (1-7 GPUs and 4-63 GiB a replica, priority 0-7, gang on every fourth,
    a model from the 255) and ``n_whole`` jax-auction services of one
    whole-node replica at priority 8. Returns the node and service
    dicts as the agents and ``ctl apply`` send them."""
    from kubeinfer_tpu_torch.api.types import LLMService
    from kubeinfer_tpu_torch.api.workload import NodeState

    rng = np.random.default_rng(seed)
    models = [f"org/model-{i:03d}" for i in range(255)]
    now = time.time()
    nodes = []
    for i in range(n_nodes):
        cached = rng.random(len(models)) < 0.02
        n = NodeState(
            gpu_capacity=64.0, gpu_free=64.0,
            gpu_memory_bytes=512 * 2**30, gpu_memory_free_bytes=512 * 2**30,
            topology=(int(rng.integers(0, 16)), 0),
            cached_models=[m for m, c in zip(models, cached) if c],
            heartbeat=now,
            serving_stats={"n_slots": 8,
                           "queue_depth": int(rng.integers(0, 16))},
        )
        n.metadata.name = f"node-{i:04d}"
        nodes.append(n.to_dict())

    def service(name, spec):
        svc = LLMService.from_dict({"metadata": {"name": name},
                                    "spec": spec})
        svc.validate()
        return svc.to_dict()

    services = [service(f"whole-{i:02d}", {
        "model": models[int(rng.integers(0, len(models)))], "replicas": 1,
        "gpuPerReplica": 64, "gpuMemory": "256Gi", "priority": 8,
        "schedulerPolicy": "jax-auction"}) for i in range(n_whole)]
    services += [service(f"svc-{i:04d}", {
        "model": models[int(rng.integers(0, len(models)))],
        "replicas": per, "gpuPerReplica": int(rng.integers(1, 8)),
        "gpuMemory": f"{int(rng.integers(4, 64))}Gi",
        "priority": int(rng.integers(0, 8)), "gang": i % 4 == 0,
        "schedulerPolicy": "jax-greedy"}) for i in range(n_greedy)]
    return nodes, services


class TickSplit:
    """Where each reconcile tick's time goes, by wrappers around the
    controller's store, its backends' ``solve``, ``solved_affinity``
    and the route pack: store reads (list, get), write-back (create,
    update, delete), the affinity solve (its pack, its #8 launches),
    each policy group's solve (wall, solve_ms, kernel launches) and the
    controller's own host work (the rest). One tick runs at a time."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.ticks: list[dict] = []
        self.cur: dict | None = None
        self.syncs: list | None = None  # a catch_warnings record list
        self.after = None  # called with the tick count after each tick

    def add(self, key, ms):
        if self.cur is not None:
            self.cur[key] = self.cur.get(key, 0.0) + ms

    def counts(self):
        return {k: getattr(self.kernels, k).launches for k in TICK_LAUNCHES}

    def timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.add(key, (time.perf_counter() - t0) * 1e3)
        return run

    def tick(self, reconcile_once):
        def run():
            self.cur = {"reads_ms": 0.0, "writes_ms": 0.0,
                        "affinity_ms": 0.0, "affinity_pack_ms": 0.0,
                        "groups": {}}
            n_sync = len(self.syncs) if self.syncs is not None else None
            c0 = self.counts()
            t0 = time.perf_counter()
            res = reconcile_once()
            cur, self.cur = self.cur, None
            cur["total_ms"] = (time.perf_counter() - t0) * 1e3
            cur["affinity_launches"] = (self.counts()["route_pick"]
                                        - c0["route_pick"])
            cur["solves_ms"] = sum(g["wall_ms"]
                                   for g in cur["groups"].values())
            cur["host_ms"] = (cur["total_ms"] - cur["reads_ms"]
                              - cur["writes_ms"] - cur["affinity_ms"]
                              - cur["solves_ms"])
            cur["syncs"] = None if n_sync is None else sum(
                1 for w in self.syncs[n_sync:]
                if "synchroniz" in str(w.message)
                and "prototype" not in str(w.message))
            cur["placed"] = res.replicas_placed
            cur["replicas"] = res.replicas_total
            self.ticks.append(cur)
            if self.after is not None:
                self.after(len(self.ticks))
            return res
        return run

    def solve(self, policy, solve):
        def run(req):
            c0 = self.counts()
            t0 = time.perf_counter()
            res = solve(req)
            wall = (time.perf_counter() - t0) * 1e3
            c1 = self.counts()
            if self.cur is not None:
                self.cur["groups"][policy] = {
                    "wall_ms": wall, "solve_ms": res.solve_ms,
                    "pack_ms": res.extras.get("encode_ms"),
                    "jobs": req.num_jobs, "placed": res.placed,
                    "launches": {k: c1[k] - c0[k] for k in TICK_LAUNCHES
                                 if c1[k] != c0[k]},
                }
            return res
        return run


class TimedStore:
    """The controller's handle on the hosted store, timed into a
    ``TickSplit``: the HTTP server keeps the store itself, untimed."""

    def __init__(self, store, split):
        self._store = store
        for name in ("list", "get"):
            setattr(self, name, split.timed("reads_ms",
                                            getattr(store, name)))
        for name in ("create", "update", "delete"):
            setattr(self, name, split.timed("writes_ms",
                                            getattr(store, name)))

    def watch(self, *a, **kw):
        return self._store.watch(*a, **kw)


@contextlib.contextmanager
def sync_capture():
    """Torch's CUDA sync debug mode on, its warnings recorded from every
    thread into the yielded list."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def tick_bindings(workloads):
    """(namespace, name) -> [(node, phase) of every replica]."""
    return {(w["metadata"]["namespace"], w["metadata"]["name"]):
            [(r["node"], r["phase"]) for r in w["replicas"]]
            for w in workloads}


def check_tick_state(nodes, workloads, gangs, label):
    """No node overcommitted in GPUs or memory by the bound replicas,
    every gang all or nothing. Returns the replicas bound."""
    free = {n["metadata"]["name"]: [n["gpuFree"], n["gpuMemoryFreeBytes"]]
            for n in nodes}
    bound = 0
    for w in workloads:
        on = [bool(r["node"]) for r in w["replicas"]]
        bound += sum(on)
        for r in w["replicas"]:
            if r["node"]:
                f = free[r["node"]]
                f[0] -= w["gpuPerReplica"]
                f[1] -= w["gpuMemoryBytes"]
        if w["metadata"]["name"] in gangs:
            check(all(on) or not any(on),
                  f"{label}: gang {w['metadata']['name']} partially bound")
    check(all(g >= -1e-3 and m >= 0 for g, m in free.values()),
          f"{label}: a node is overcommitted")
    return bound


def cpu_tick(dump):
    """The port's ``Controller(device="cpu")`` over a copy of the store
    contents ``dump``: the bindings its tick leaves."""
    from kubeinfer_tpu_torch.controller import Controller
    from kubeinfer_tpu_torch.controlplane.store import Store

    store = Store()
    store.load_dump(*dump)
    Controller(store, node_ttl_s=TICK_NODE_TTL_S,
               device="cpu").reconcile_once()
    return tick_bindings(store.list("Workload"))


def tick_phase(dev, kernels, record, card, steady=5):
    """Phase (29): the reconcile tick on the card, through the manager.

    ``Manager`` (device left at its default, the card) hosts the store
    on an ephemeral port; a lease held by another identity keeps its
    election from winning while ``tick_state`` is written over HTTP
    through ``RemoteStore``, one object a request. Deleting that lease
    lets the manager's own loop take the first tick (a fresh solve) and
    a second; the loop is then paused as on a lost lease, and
    ``steady`` ticks more are taken with ``controller.reconcile_once()``
    (full re-solves with incumbents). Launch counts are reset just
    before the lease is deleted and read after the last tick. Checks:
    no overcommit, gangs all or nothing, the first tick's and the
    first steady tick's bindings equal to a device="cpu" Controller's
    on a copy of the same contents, solve_duration_seconds counted for
    both policies on /metrics, and POST /solve on the hosted store
    equal to solve_service_handler called directly. Returns the tick's
    launches of #1, #7 and #8."""
    import threading
    import urllib.request

    import torch

    from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore
    from kubeinfer_tpu_torch.coordination.lease import Lease
    from kubeinfer_tpu_torch.manager import (
        MANAGER_LEASE,
        Manager,
        ManagerConfig,
    )
    from kubeinfer_tpu_torch.scheduler import (
        get_backend,
        solve_service_handler,
    )
    from kubeinfer_tpu_torch.solver import routing

    t_phase = time.perf_counter()
    nodes, services = tick_state()
    gangs = {s["metadata"]["name"] for s in services if s["spec"]["gang"]}
    mgr = Manager(ManagerConfig(
        store_bind_port=0, metrics_bind_port=0, health_bind_port=0,
        auth_token=TICK_TOKEN, tick_interval_s=0.3,
        node_ttl_s=TICK_NODE_TTL_S, leader_elect=True,
        identity="chip-smoke-manager", lease_timings=(60.0, 20.0, 0.1),
    ))
    now = time.time()
    mgr.store.create("Lease", Lease(
        name=MANAGER_LEASE, holder="chip-smoke-writer", acquire_time=now,
        renew_time=now, duration_s=3600.0).to_dict())
    split = TickSplit(kernels)
    ctl = mgr.controller
    ctl._store = TimedStore(mgr.store, split)
    ctl.reconcile_once = split.tick(ctl.reconcile_once)
    backends = {p: get_backend(p) for p in ("jax-greedy", "jax-auction")}
    for policy, be in backends.items():
        be.solve = split.solve(policy, be.solve)
    real_affinity, real_pack = routing.solved_affinity, routing.pack_route_arrays
    routing.solved_affinity = split.timed("affinity_ms", real_affinity)
    routing.pack_route_arrays = split.timed("affinity_pack_ms", real_pack)
    first: dict = {}

    def after(n):  # on the controller's thread, between its ticks
        if n == 1:
            first["workloads"] = mgr.store.list("Workload")
        elif n == 2:
            # pause the loop, as a lost lease does, and hold this thread
            # until the loop's relay has seen it (it looks every 0.2 s),
            # so the loop takes no third tick
            mgr._on_lost()
            time.sleep(0.25)

    split.after = after
    try:
        mgr.start()
        t0 = time.perf_counter()

        def write(chunk):
            remote = RemoteStore(mgr.store_address, token=TICK_TOKEN)
            for kind, obj in chunk:
                remote.create(kind, obj)

        # one writer: more threads only contend for the interpreter lock
        # that the hosted store's handlers also take
        write([("Node", n) for n in nodes]
              + [("LLMService", s) for s in services])
        write_s = time.perf_counter() - t0
        check(not split.ticks, "the manager ticked while its lease was held")
        pre_first = mgr.store.dump()
        remote = RemoteStore(mgr.store_address, token=TICK_TOKEN)
        with sync_capture() as caught:
            split.syncs = caught
            reset_counts(kernels)
            remote.delete("Lease", MANAGER_LEASE)
            deadline = time.monotonic() + 300
            while len(split.ticks) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            check(len(split.ticks) >= 2, "the manager's loop did not tick")
            for th in mgr._threads:
                th.join(timeout=30)
            check(not any(th.is_alive() for th in mgr._threads),
                  "the manager's loop did not pause")
            check(len(split.ticks) == 2,
                  f"the loop took {len(split.ticks)} ticks, not 2")
            pre_steady = mgr.store.dump()
            for i in range(steady):
                ctl.reconcile_once()
                if i == 0:
                    steady_workloads = mgr.store.list("Workload")
            split.syncs = None
        tick_launches = split.counts()
        for name in ("mega_solve", "auction_solve", "route_pick"):
            check(tick_launches[name] > 0,
                  f"the tick never launched {name}")
        req = urllib.request.Request(
            f"http://127.0.0.1:{mgr.metrics_server.port}/metrics",
            headers={"Authorization": f"Bearer {TICK_TOKEN}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            metrics_text = r.read().decode()
        solve_counts = {}
        for policy in backends:
            key = ('kubeinfer_solve_duration_seconds_count{policy="'
                   + policy + '"} ')
            line = [ln for ln in metrics_text.splitlines()
                    if ln.startswith(key)]
            solve_counts[policy] = float(line[0].split()[-1]) if line else 0
            check(solve_counts[policy] >= 1,
                  f"/metrics counts no solve of {policy}")
        body = handler_body(1000, 128, 4, fractional=True)
        rpc = remote._req("POST", "/solve", body)
        direct = solve_service_handler(body)
        check(rpc["assignment"] == direct["assignment"],
              "POST /solve on the hosted store != solve_service_handler")
    finally:
        routing.solved_affinity, routing.pack_route_arrays = (
            real_affinity, real_pack)
        for be in backends.values():
            be.__dict__.pop("solve", None)
        mgr.stop()
    final = tick_bindings(steady_workloads)
    bound_first = check_tick_state(nodes, first["workloads"], gangs,
                                   "first tick")
    bound_steady = check_tick_state(nodes, steady_workloads, gangs,
                                    "steady tick")
    t0 = time.perf_counter()
    cpu_first, cpu_steady = in_threads(cpu_tick, [pre_first, pre_steady])
    cpu_s = time.perf_counter() - t0
    check(cpu_first == tick_bindings(first["workloads"]),
          "first tick: the card's bindings != the device='cpu' tick's")
    check(cpu_steady == final,
          "steady tick: the card's bindings != the device='cpu' tick's")
    torch.cuda.synchronize()

    def p50(key, ticks):
        return statistics.median(t[key] for t in ticks)

    def split_line(what, ticks):
        groups = {}
        for policy in ticks[0]["groups"]:
            gs = [t["groups"][policy] for t in ticks]
            groups[policy] = {
                "jobs": gs[0]["jobs"], "placed": gs[-1]["placed"],
                "solve_ms": statistics.median(g["solve_ms"] for g in gs),
                "wall_ms": statistics.median(g["wall_ms"] for g in gs),
                "launches": gs[-1]["launches"]}
        row = {k: p50(k, ticks) for k in (
            "total_ms", "reads_ms", "host_ms", "affinity_ms",
            "affinity_pack_ms", "solves_ms", "writes_ms")}
        row.update(ticks=len(ticks), groups=groups,
                   affinity_launches=ticks[-1]["affinity_launches"],
                   syncs=[t["syncs"] for t in ticks],
                   placed=ticks[-1]["placed"],
                   replicas=ticks[-1]["replicas"])
        print(f"[29] {card}: {what} ({len(ticks)}), p50 {row['total_ms']:.1f}"
              f" ms: store reads {row['reads_ms']:.1f}, controller host "
              f"work {row['host_ms']:.1f}, solved_affinity "
              f"{row['affinity_ms']:.1f} (pack {row['affinity_pack_ms']:.1f},"
              f" #8 launches {row['affinity_launches']}), solves "
              f"{row['solves_ms']:.1f} ("
              + "; ".join(f"{p} {g['jobs']} jobs solve_ms "
                          f"{g['solve_ms']:.2f} wall {g['wall_ms']:.2f} "
                          f"launches {g['launches']}"
                          for p, g in groups.items())
              + f"), write-back {row['writes_ms']:.1f}; host syncs a tick "
              f"{row['syncs']}; placed {row['placed']}/{row['replicas']}")
        return row

    first_row = split_line("the manager's first tick", split.ticks[:1])
    loop_row = split_line("the loop's second tick", split.ticks[1:2])
    steady_row = split_line("steady ticks", split.ticks[2:])
    print(f"[29] {card}: {len(nodes)} nodes and {len(services)} services "
          f"written over HTTP, one a request, in {write_s:.2f} s; bound "
          f"{bound_first} replicas after the first tick, {bound_steady} "
          f"after the first steady tick (no overcommit, gangs all or "
          f"nothing); bindings equal to the device='cpu' tick on the same "
          f"contents (both ticks, {cpu_s:.1f} s on the host, in two "
          f"threads); /metrics "
          f"solve counts {solve_counts}; POST /solve 1kx128 equal to the "
          f"handler; launches {tick_launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    record["tick"] = {
        "first": first_row, "loop_second": loop_row, "steady": steady_row,
        "ticks": split.ticks, "write_s": write_s, "cpu_check_s": cpu_s,
        "bound_first": bound_first, "bound_steady": bound_steady,
        "launches": tick_launches, "solve_counts": solve_counts,
        "nodes": len(nodes), "services": len(services),
    }
    return tick_launches


# --- the serving path: phases (13)-(16) ---------------------------------------

SERVE_KERNELS = ("flash_attention_ragged", "decode_attention",
                 "decode_attention_blocks")
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
BF16_REL = 2.0 ** -6  # 2 bf16 ulps of a row's magnitude


def reset_serve_counts(fa):
    for name in SERVE_KERNELS:
        getattr(fa, name).launches = 0
    fa.flash_attention_ragged.tc_launches = 0


# the tensor-core kernel of every bf16 call of #9, #13 and #9b, and the
# one of every bf16 #14 call at D 64 and 128
TC_SOURCE = "kubeinfer_tpu_torch/inference/csrc/flash_prefill_tc.cu"
TC_CORES = "tensor cores: wgmma, TMA (flash_prefill_tc.cu)"
BWD_TC_CORES = "tensor cores: wgmma, TMA (flash_backward_tc.cu)"


def cuda_core_ms(name, args, reps=3):
    """ms per launch of the CUDA-core kernel (``flash_prefill.cu``, or
    ``flash_backward.cu`` for #14) on the same bf16 call, the route these
    calls took before the tensor-core kernels: launched through its
    library, outside the wrappers' counts."""
    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import flash_attention as fa

    q, k, v = args[:3]
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    scale = 1.0 / float(D) ** 0.5
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        lib = _build.load_kernel_library("flash_backward")
        outs = (torch.empty_like(q),) if name == "flash_bwd_dq" else (
            torch.empty_like(k), torch.empty_like(v))
        call = (f"{name}_launch", *args[:6], args[7], *outs, B, T, S, H,
                n_kv, D, int(args[6]), scale, 1)
        return cuda_ms(lambda: fa._launch(lib, *call), reps=reps)
    lib = _build.load_kernel_library("flash_prefill")
    out = torch.empty_like(q)
    if name == "flash_attention":
        call = ("flash_masked_launch", q, k, v, args[3], out, B, T, S, H,
                n_kv, D, scale, 1)
    else:
        lse = torch.empty((B * n_kv, T * (H // n_kv), 1), dtype=torch.float32,
                          device=q.device) if name == "flash_ragged_lse" \
            else None
        call = ("flash_prefill_launch", q, k, v, args[4], out, lse, B, T, S,
                H, n_kv, D, int(args[3]), scale, 1)
    return cuda_ms(lambda: fa._launch(lib, *call), reps=reps)


def attn_err(got, want, live):
    """(largest |kernel - plain| over the live rows, within tolerance):
    f32 1e-5; bf16 2**-6 of each live row's largest |plain value|; every
    row finite."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False
    B = g.shape[0]
    row_err = (g - w).abs().reshape(B, -1).amax(dim=1)[live]
    row_mag = w.abs().reshape(B, -1).amax(dim=1)[live]
    if row_err.numel() == 0:
        return 0.0, True
    if got.dtype == torch.float32:
        ok = bool((row_err <= 1e-5).all())
    else:
        ok = bool((row_err <= BF16_REL * row_mag).all())
    return float(row_err.max()), ok


def split_walk(fa, name, args):
    """The live splits the split-K kernel of #10, #11 or #12 walks on one
    call of its wrapper, n_kv * row blocks * the sum of
    ``decode_split_walk``, as a device tensor (no host sync)."""
    q, lens = args[0], args[-1]
    T, H = q.shape[1], q.shape[2]
    if name == "decode_attention":
        k = args[1]
        n_kv, S_total = k.shape[2], k.shape[1]
        C = fa.decode_split_size(S_total, False)
    else:  # the pool (#11) or the int8 pages (#12), then the tables
        kp, tbl = args[1], args[-2]
        n_kv, bs = kp.shape[2], kp.shape[1]
        S_total, C = tbl.shape[1] * bs, fa.decode_split_size(bs, True)
    rb = fa.decode_row_blocks(T * (H // n_kv), q.dtype)
    return n_kv * rb * fa.decode_split_walk(lens, T, S_total, C).sum()


class CheckedAttention:
    """A stand-in for one attention wrapper of ``inference.flash_attention``
    that runs the kernel and its plain version on the same inputs, holds
    them within the stated tolerance and hands the kernel's result on.
    Keeps the call with the most work (``weight``) for the times. While it
    stands in, the wrapper's ``<name>.launches += 1`` resolves to this
    object's ``launches`` (``tc_launches`` likewise), so the checking
    launches stay off the wrapper's own count. Its ``walk_counter`` is
    None (#9b: the checking launches count no key tiles), unless ``walk``
    is set (#10, #11, #12): then it is an int32 device counter of the split-K
    kernel's live splits over every checked call, and ``walk_want`` adds
    ``split_walk``'s count of each call, on the device (``walk_check``
    compares them).

    ``trim`` (#11, #12: the block tables second to last, the lengths
    last) runs the plain version on the table columns the live rows reach
    (``trimmed``; #10: on the whole TILE_S tiles of the linear caches they
    reach): every tile past a row's length is masked, and a masked tile
    adds exactly nothing to the row's online softmax (weights 0, a rescale
    of 1), so the live rows' plain outputs are bitwise those of the whole
    call. The first call holds that: the whole call's plain
    output, bitwise the trimmed one on the live rows. A trimmed check
    that fails keeps its error and lets the path run on (the served
    request completes; the phase fails on ``error`` afterwards)."""

    def __init__(self, fa, name, plain, live, weight, walk=False, trim=False):
        self.fa, self.name = fa, name
        self.kernel, self.plain = getattr(fa, name), plain
        self.live, self.weight = live, weight
        self.trim, self.trim_held = trim, False
        self.launches = self.tc_launches = self.calls = 0
        self.walk, self.walk_counter, self.walk_want = walk, None, None
        self.max_err = 0.0
        self.heaviest = None
        self.error = None  # a failure on the scheduler thread, kept here
        # (35): {data_ptr of a tp rank's pool piece: rank}; the calls are
        # then tallied by the rank whose pool they read
        self.ranks, self.per_rank = None, collections.Counter()

    def __enter__(self):
        setattr(self.fa, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.fa, self.name, self.kernel)

    def walk_check(self, tag):
        """(kernel count, mirror count) of the live splits over the
        checked calls; fails unless they are equal."""
        got, want = int(self.walk_counter.item()), int(self.walk_want.item())
        check(got == want, f"{tag} {self.name}: the kernel walked {got} live "
              f"splits, decode_split_walk says {want}")
        return got, want

    def __call__(self, *args):
        if self.ranks is not None:
            self.per_rank[self.ranks.get(args[1].data_ptr(), -1)] += 1
        if self.walk:
            import torch

            if self.walk_counter is None:
                self.walk_counter = torch.zeros(1, dtype=torch.int32,
                                                device=args[0].device)
                self.walk_want = torch.zeros((), dtype=torch.int64,
                                             device=args[0].device)
            self.walk_want += split_walk(self.fa, self.name, args)
        got = self.kernel(*args)
        if self.trim:
            return self.trimmed(got, args)
        want = self.plain(*args)
        err, ok = attn_err(got, want, self.live(*args))
        if not ok:
            self.error = (f"{self.name}: kernel vs plain out of tolerance "
                          f"on call {self.calls} (max err {err})")
            raise AssertionError(self.error)
        self.max_err = max(self.max_err, err)
        if self.heaviest is None or \
                self.weight(*args) > self.weight(*self.heaviest):
            # copies of the small operands (q, tables, lengths): the slot
            # state's tables change in place as rows retire; the caches
            # and pools are kept by reference
            self.heaviest = tuple(
                a.clone() if hasattr(a, "clone") and a.numel() < 1 << 22
                else a for a in args)
        self.calls += 1
        return got

    def trimmed(self, got, args):
        """The call checked against the plain version on the table columns
        the live rows reach; returns the kernel's result."""
        import torch

        live = self.live(*args)
        sub = list(args)
        if self.name == "decode_attention":  # q, k, v, lengths
            tile = min(self.fa.TILE_S, args[1].shape[1])
            n = max(1, int((args[-1][live].max() + tile - 1) // tile)
                    if bool(live.any()) else 1)
            sub[1], sub[2] = args[1][:, :n * tile], args[2][:, :n * tile]
        else:  # the block tables second to last
            bs = args[1].shape[1]
            cols = max(1, int((args[-1][live].max() + bs - 1) // bs)
                       if bool(live.any()) else 1)
            sub[-2] = sub[-2][:, :cols].contiguous()
        want = self.plain(*sub)
        if not self.trim_held:
            full = self.plain(*args)
            if not torch.equal(full[live], want[live]) and self.error is None:
                self.error = (f"{self.name}: the plain version on the "
                              "trimmed call differs from the whole call's "
                              "on the live rows")
            self.trim_held = True
        err, ok = attn_err(got, want, live)
        if not ok and self.error is None:
            self.error = (f"{self.name}: kernel vs plain out of tolerance "
                          f"on call {self.calls} (max err {err})")
        self.max_err = max(self.max_err, err)
        self.calls += 1
        return got


class CountedSplit:
    """A pass-through stand-in for #10, #11 or #12 while the main path runs
    over HTTP: the wrapper launches its kernel as it would, its own
    ``launches += 1`` and its kernel's live-split count (``walk_counter``)
    land here, and each call adds ``split_walk``'s count for its lengths
    on the device (no host sync on the path)."""

    def __init__(self, fa, name, dev):
        import torch

        self.fa, self.name = fa, name
        self.kernel = getattr(fa, name)
        self.launches = 0
        self.walk_counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.walk_want = torch.zeros((), dtype=torch.int64, device=dev)

    __enter__ = CheckedAttention.__enter__
    __exit__ = CheckedAttention.__exit__
    walk_check = CheckedAttention.walk_check

    def __call__(self, *args):
        self.walk_want += split_walk(self.fa, self.name, args)
        return self.kernel(*args)


def post_json(port, body, timeout=900):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get_status(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status


def get_text(port, path, token=None):
    """(status, body, host ms) of a GET; an HTTP error's too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode(), \
                (time.perf_counter() - t0) * 1e3
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), (time.perf_counter() - t0) * 1e3


# the bearer token of (13)'s and (17)'s servers (--debug-token-file),
# fresh each run: /debug/* and POST /admin/drain need it
OBSERVE_TOKEN = secrets.token_hex(16)
_TOKEN_FILE: list = []


def observe_flags():
    """The observability flags (13)'s and (17)'s servers are built with:
    the SLO objective, the bearer token (a file in a temporary directory
    removed at exit) and the flight recorder's ring."""
    if not _TOKEN_FILE:
        d = tempfile.mkdtemp(prefix="chip-smoke-")
        atexit.register(shutil.rmtree, d, True)
        path = pathlib.Path(d) / "debug-token"
        path.write_text(OBSERVE_TOKEN + "\n")
        _TOKEN_FILE.append(str(path))
    return ["--slo", "ttft:2.0:0.99", "--debug-token-file", _TOKEN_FILE[0],
            "--flight-capacity", "4096"]


def metric_samples(text):
    """Prometheus text -> {"name{labels}": value} of every sample line."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def family(srv, name):
    """{"{labels}" or "": value} of one family of ``srv``'s registry."""
    return {series[len(name):]: v for series, v in
            metric_samples(srv.registry.render()).items()
            if series == name or series.startswith(name + "{")}


def in_threads(fn, items):
    """fn over items, one thread each, all started together."""
    import threading

    out = [None] * len(items)
    errs = []

    def go(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:  # re-raised below, on the main thread
            errs.append(e)

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(items))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return out


def device_profile(fn):
    """Run ``fn`` under torch.profiler (CPU + CUDA). Returns (host wall ms
    until the device is done, device busy ms = the kernels' summed time
    on the one stream, the top kernels as (name, ms, count)). A trace
    with no device time gives busy 0: not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows


def card_vs_cpu(dev, record):
    """Phase (15): the port's engines on the card and on the CPU, same
    f32 weights at llama-3-8b widths cut to 1 layer: equal greedy and
    sampled token streams."""
    import dataclasses

    import torch

    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.model import init_params, params_to

    rng = np.random.default_rng(15)
    kw_sets = ({}, dict(temperature=0.8, top_k=50, top_p=0.9,
                        repetition_penalty=1.2, seed=3))

    def run(cfg, params, device):
        eng = Engine(params, cfg, max_cache_len=512, device=device)
        cont = ContinuousEngine(params, cfg, n_slots=2, cache_len=128,
                                device=device).start()
        try:
            out = []
            for kw in kw_sets:
                out.append(eng.generate(prompts, 16, **kw).tokens.tolist())
                # both rows in one decode batch: half the forwards (the
                # host run is bound by streaming the f32 vocab head)
                out.append(in_threads(lambda p: cont.generate(p, 16, **kw),
                                      prompts))
            return out
        finally:
            cont.stop()

    layers = CPU_CHECK_LAYERS
    cfg = dataclasses.replace(PRESETS["llama-3-8b"], num_hidden_layers=layers)
    prompts = [rng.integers(1, cfg.vocab_size, 64).tolist()
               for _ in range(2)]
    p_cpu = init_params(cfg, seed=15, dtype=torch.float32, device="cpu")
    t0 = time.perf_counter()
    want = run(cfg, p_cpu, "cpu")
    host_s = time.perf_counter() - t0
    p_card = params_to(p_cpu, dev)
    t0 = time.perf_counter()
    got = run(cfg, p_card, dev)
    card_s = time.perf_counter() - t0
    names = ("Engine greedy", "ContinuousEngine greedy", "Engine sampled",
             "ContinuousEngine sampled")
    for name, g, w in zip(names, got, want):
        check(g == w, f"[15] {name}: card {g} != CPU {w}")
    print(f"[15] llama-3-8b widths, {layers} layers, f32, 2 prompts of 64 "
          f"tokens, 16 new: {', '.join(names)} on the card equal to "
          f"device='cpu' (host {host_s:.1f} s, card {card_s:.1f} s)")
    record["card_vs_cpu"] = {"layers": layers, "host_s": host_s,
                             "card_s": card_s, "streams": got}
    del p_card, p_cpu


def serving_phases(dev, record, card):
    """Phases (13)-(16): the serving path at full width (llama-3-8b, bf16,
    random weights from a seed) through the port's InferenceServer; the
    three attention kernels against their plain versions on inputs
    captured from it; the card against the CPU; times. Returns the
    kernels' entries of the ``kernels`` line."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import model as tm
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference.engine import (
        chunked_prefill,
        make_caches,
        prefill_attn,
    )
    from kubeinfer_tpu_torch.inference.stepper import RowFlags, decode_window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    # the user's entry point: flags as for the command line, on the card
    t0 = time.perf_counter()
    srv, cont = server.build_server(
        ["--model", "llama-3-8b", "--random-init", "--port", "0",
         "--host", "127.0.0.1", "--batch-slots", "8", *observe_flags()])
    torch.cuda.synchronize()
    engine = srv.engine
    cfg = engine.cfg
    V = cfg.vocab_size
    build_s = time.perf_counter() - t0
    check(cont.cache_len == 4096 and cont.block_size == 128
          and cont._pool.num_blocks == 513,
          f"slot geometry {cont.cache_len} {cont.block_size} "
          f"{cont._pool.num_blocks}")
    print(f"[13] llama-3-8b (H {cfg.hidden_size}, {cfg.num_hidden_layers} "
          f"layers, {cfg.num_attention_heads} heads, "
          f"{cfg.num_key_value_heads} kv heads, D {cfg.head_dim}, vocab {V})"
          f" bf16 from init_params(seed=0): "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card "
          f"with the 513-block pool, built in {build_s:.1f} s")
    cont.start()

    # (13) each kernel vs its plain version on the path's own calls
    rng = np.random.default_rng(13)
    layers = cfg.num_hidden_layers
    chk11 = CheckedAttention(
        fa, "decode_attention_blocks", fa.decode_attention_blocks_plain,
        live=lambda q, kp, vp, tbl, ln: ((tbl[:, 0] != 0)
                                         & (ln >= q.shape[1])),
        weight=lambda q, kp, vp, tbl, ln: (int((tbl[:, 0] != 0).sum()),
                                           int(ln.sum())), walk=True)
    with torch.inference_mode(), chk11:
        prompts = [rng.integers(1, V, 512).tolist() for _ in range(8)]
        try:
            in_threads(lambda p: cont.generate(p, 4, timeout=180), prompts)
        finally:
            check(chk11.error is None, str(chk11.error))
    check(chk11.calls >= layers and chk11.calls % layers == 0,
          f"#11 checked on {chk11.calls} calls")
    chk9 = CheckedAttention(
        fa, "flash_attention_ragged", fa.flash_attention_ragged_plain,
        live=lambda q, k, v, off, ln: torch.ones(q.shape[0], dtype=torch.bool,
                                                 device=q.device),
        weight=lambda q, k, v, off, ln: off)
    chk10 = CheckedAttention(
        fa, "decode_attention", fa.decode_attention_plain,
        live=lambda q, k, v, ln: ln > 0,
        weight=lambda q, k, v, ln: 0, walk=True)
    long_prompt = rng.integers(1, V, 4100).tolist()
    with torch.inference_mode(), chk9, chk10:
        engine.generate([long_prompt], 2)
    check(chk9.calls == 4 * layers and chk10.calls == layers,
          f"#9 {chk9.calls} calls, #10 {chk10.calls}")
    check(chk9.tc_launches == chk9.calls,
          f"#9: {chk9.tc_launches} of {chk9.calls} bf16 calls on the "
          "tensor-core route")
    # #10 and #11 launch the split-K kernel (decode_split.cu) on every
    # call: its own count of the live splits it walked equals the mirror's
    walks = {chk.name: chk.walk_check("[13]") for chk in (chk11, chk10)}
    for chk, what in ((chk11, "every layer of the continuous engine's decode "
                              "windows (8 requests of 512 tokens, 4 new)"),
                      (chk9, "the 4 chunks of 2048 of a 4100-token prompt, "
                             "every layer"),
                      (chk10, "one decode step of Engine, every layer")):
        print(f"[13] {chk.name}: {chk.calls} calls on {what}, within "
              f"tolerance; max |kernel - plain| {chk.max_err:.3e} (bf16)"
              + (f"; {chk.tc_launches} on the tensor-core route"
                 if chk is chk9 else "")
              + (f"; split-K (decode_split.cu): {walks[chk.name][0]} live "
                 "splits walked by the kernel's own count, equal to "
                 "decode_split_walk's" if chk.name in walks else ""))

    # (14) the main path over HTTP, counted
    srv.start()
    check(get_status(srv.port, "/health") == 200
          and get_status(srv.port, "/v1/models") == 200, "read endpoints")
    shared = rng.integers(1, V, 256).tolist()
    bodies = [dict(prompt=shared + rng.integers(1, V, 256).tolist(),
                   max_tokens=64) for _ in range(2)]
    bodies += [dict(prompt=rng.integers(1, V, 512).tolist(), max_tokens=64)
               for _ in range(2)]
    bodies.append(dict(prompt=rng.integers(1, V, 512).tolist(),
                       max_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
                       seed=7))
    bodies.append(dict(prompt=rng.integers(1, V, 4100).tolist(),
                       max_tokens=16))
    reset_serve_counts(fa)
    split10 = CountedSplit(fa, "decode_attention", dev)
    split11 = CountedSplit(fa, "decode_attention_blocks", dev)
    t0 = time.perf_counter()
    with split10, split11:
        resps = in_threads(lambda b: post_json(srv.port, b), bodies)
        http_s = time.perf_counter() - t0
        counts = {name: getattr(fa, name).launches for name in SERVE_KERNELS}
    check(all(counts.values()), f"a serving kernel never launched: {counts}")
    walks14 = {c.name: c.walk_check("[14]") for c in (split10, split11)}
    tc9 = fa.flash_attention_ragged.tc_launches
    check(tc9 == counts["flash_attention_ragged"],
          f"#9: {tc9} of {counts['flash_attention_ragged']} launches on the "
          "tensor-core route")
    routes = [r["kubeinfer"]["route"] for r in resps]
    check(routes == ["continuous"] * 5 + ["engine"], f"routes {routes}")
    for b, r in zip(bodies, resps):
        toks = r["choices"][0]["tokens"]
        check(len(toks) == b["max_tokens"]
              and all(0 <= x < V for x in toks), "tokens out of range")
    with torch.inference_mode():
        lg, _ = tm.forward(engine.params, torch.tensor(
            [bodies[0]["prompt"][:64]], device=dev), cfg)
    check(bool(torch.isfinite(lg).all()), "NaN/inf logits")
    stats = cont.kv_cache_stats()
    print(f"[14] /v1/completions over HTTP: 4 greedy + 1 sampled 512-token "
          f"prompts (64 new) on route continuous, 1 of 4100 tokens (16 new)"
          f" on route engine, {http_s:.1f} s; launches {counts} (#9 on "
          f"the tensor-core route: {tc9}; #10 and #11 on the split-K "
          f"kernel, live splits walked {walks14['decode_attention'][0]} and "
          f"{walks14['decode_attention_blocks'][0]} by its own count, equal "
          f"to decode_split_walk's); radix "
          f"hits {stats['hits']} misses {stats['misses']}, blocks in use "
          f"{stats['blocks_in_use']}; logits finite")
    # the scheduler is idle (nothing submitted): one decode window of its
    # slot state, every sampling gate on, plus the readback
    flags = RowFlags(sampled=True, top_k=True, top_p=True, penalty=True)
    with torch.inference_mode():
        _, sites = count_syncs(lambda: decode_window(
            cont.params, cont._state, cfg, 4, flags)[1].cpu())
    n_sync = sum(sites.values())
    check(n_sync == 1, f"decode window host syncs {dict(sites)}")
    print(f"[14] host syncs in one decode window (K=4, sampling gates on) "
          f"+ its readback: {n_sync} ({dict(sites)})")
    record["serving"] = {"launches": counts, "http_s": http_s,
                         "split_walks": walks14,
                         "window_syncs": n_sync, "radix": stats,
                         "model_param_bytes": cont.model_param_bytes,
                         "kv_pool_bytes": cont.kv_pool_bytes}

    # (15) the card against the CPU
    card_vs_cpu(dev, record)

    # (16) times
    def p50(xs):
        return statistics.median(xs)

    ttft = []
    for _ in range(5):
        req = cont.serve(rng.integers(1, V, 512).tolist(), 1)
        ttft.append((req.t_first - req.t_submit) * 1e3)
    reqs = in_threads(lambda p: cont.serve(p, 64),
                      [rng.integers(1, V, 512).tolist() for _ in range(8)])
    t_all = max(r.t_first for r in reqs)
    gaps = []
    for r in reqs:
        times = [x for x in r.token_times if x > t_all]
        gaps += list(np.diff(times) * 1e3)
    decode_ms = p50(gaps)
    # the engine route's prefill chunks, each timed with CUDA events
    lens = torch.tensor([4100], dtype=torch.int32, device=dev)
    prompt = torch.zeros((1, 8192), dtype=torch.int64, device=dev)
    prompt[0, :4100] = torch.tensor(long_prompt, device=dev)
    chunk_ms = []
    with torch.inference_mode():
        caches = make_caches(cfg, 1, 8192, torch.bfloat16, dev)
        for _ in range(2):
            for c0 in range(0, 8192, 2048):
                ms = cuda_ms(lambda c0=c0: tm.forward(
                    engine.params, prompt[:, c0:c0 + 2048], cfg,
                    kv_caches=caches, cache_offset=c0,
                    attn_fn=prefill_attn(c0, lens), return_hidden=True),
                    reps=1, warmup=0)
                chunk_ms.append(ms)
        whole_ms = cuda_ms(lambda: chunked_prefill(
            engine.params, prompt, lens, cfg, caches, 2048), reps=1)
        # the engine route's decode on those caches (#10, split-K)
        eng_dec = engine_decode(engine.params, cfg, caches, 4100, dev)
    del caches
    print(f"[16] {card}: engine-route decode, 16 step_forward steps of the "
          f"4100-token row on its dense 8192-wide caches: {eng_dec[0]:.2f} "
          f"ms per token (CUDA events), device busy {eng_dec[1]:.2f} ms a "
          f"token")
    # where the time goes: one admit, and a decode run of 8 slots
    adm_wall, adm_busy, adm_top = device_profile(
        lambda: cont.serve(rng.integers(1, V, 512).tolist(), 1))
    dec_wall, dec_busy, dec_top = device_profile(
        lambda: in_threads(lambda p: cont.serve(p, 32), [
            rng.integers(1, V, 512).tolist() for _ in range(8)]))
    for what, wall, busy, top in (
            ("one 512-token admit (TTFT)", adm_wall, adm_busy, adm_top),
            ("8 requests of 512 + 32 new", dec_wall, dec_busy, dec_top)):
        print(f"[16] profile, {what}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms ({100 * busy / wall:.1f}%); top kernels "
              + "; ".join(f"{n[:60]} {ms:.1f} ms x{c}"
                          for n, ms, c in top[:6]))
    step = launches_per_step(cont, cfg)
    record["profile"] = {
        "admit": {"wall_ms": adm_wall, "busy_ms": adm_busy,
                  "qmm_ms": qmm_share(adm_top), "top": adm_top[:12]},
        "decode_8x32": {"wall_ms": dec_wall, "busy_ms": dec_busy,
                        "qmm_ms": qmm_share(dec_top), "top": dec_top[:12]},
        "decode_step": {"launches": step[0], "busy_ms": step[1],
                        "wall_ms": step[2], "qmm_ms": step[3]},
    }
    print(f"[16] {card}: TTFT of a 512-token prompt on the continuous route "
          f"p50 {p50(ttft):.2f} ms ({[round(x, 2) for x in ttft]}); decode "
          f"at 8 live slots p50 {decode_ms:.3f} ms per token per slot, "
          f"{8e3 / decode_ms:.1f} tokens/s; engine route prefill chunk "
          f"(2048 queries, 8192-wide cache) p50 {p50(chunk_ms):.2f} ms "
          f"({[round(x, 2) for x in chunk_ms[4:]]}), whole 4100-token "
          f"prefill {whole_ms:.2f} ms")

    entries = []
    with torch.inference_mode():
        entries.append(time_kernel(dev, fa, chk9, card,
                                   counts["flash_attention_ragged"], F, tc9))
        entries.append(time_decode(dev, fa, chk10, card, "decode_attention",
                                   counts["decode_attention"], F))
        entries.append(time_decode(dev, fa, chk11, card,
                                   "decode_attention_blocks",
                                   counts["decode_attention_blocks"], F))
    record["serving_times"] = {
        "ttft_ms": ttft, "decode_ms_per_token": decode_ms,
        "tokens_per_s": 8e3 / decode_ms, "prefill_chunk_ms": chunk_ms,
        "prefill_4100_ms": whole_ms,
        "engine_decode_ms_per_token": eng_dec[0],
        "engine_decode_busy_ms_per_token": eng_dec[1],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    # (30a) disaggregated prefill and decode on this server's first
    # SPEC_INT8_LAYERS layers (a second server on its tensors, as (30b):
    # the whole run keeps inside its time limit with (36) added), the cut
    # server the prefill side; (31b) drains it onto (30a)'s decode
    # replica; (34) routes over two replicas on this server's first
    # SPEC_INT8_LAYERS layers; (31a) preempts on its parameter tensors
    migrate, fleet = {}, {}

    try:
        cut_srv, cut = cut_server(dev, srv, cont, SPEC_INT8_LAYERS)

        def then(dec_srv, dec):
            migrate.update(migrate_phase(dev, record, card, cut_srv, cut,
                                         dec_srv, dec))
            fleet.update(fleet_on_cut(dev, record, card, srv, cont))

        try:
            launches = disagg_phase(dev, record, card, cut_srv, cut,
                                    then=then)
        finally:
            cut_srv.stop()
            cut.stop()
        del cut_srv, cut
        gc.collect()
        torch.cuda.empty_cache()
        # (32a) on the full-depth server, after (31b)
        observe = observe_phase(dev, record, card, srv, cont)
        # at SPEC_INT8_LAYERS of the served layers: the whole run keeps
        # inside its time limit with (33) added
        preempt = preempt_phases(
            dev, record, card, {**cont.params, "layers": cont.params[
                "layers"][:SPEC_INT8_LAYERS]},
            dataclasses.replace(cfg, num_hidden_layers=SPEC_INT8_LAYERS),
            cont.cache_len)
    finally:
        srv.stop()
        cont.stop()
    entries[2]["observe_launches"] = observe["decode_attention_blocks"]
    entries[2]["disagg_launches"] = launches["decode_attention_blocks"]
    entries[2]["fleet_launches"] = fleet["decode_attention_blocks"]
    entries[1]["migrate_launches"] = preempt["decode_attention"]
    entries[2]["migrate_launches"] = (preempt["decode_attention_blocks"]
                                      + migrate["decode_attention_blocks"])
    return entries


DISAGG_NEW = 48  # new tokens of each decode-replica request in (30)


def pool_blocks(cont, tokens):
    """The block ids ``cont``'s radix trie holds for the full blocks of
    ``tokens`` (the walk's references returned)."""
    blocks = cont._radix.match(tokens)
    cont._pool.unref(blocks)
    return blocks


def pool_pages(cont, blocks):
    """The pool's pages of ``blocks`` on the card: every layer's K and V
    ([2, L, n, bs, n_kv, D]), and the int8 pool's scales
    ([2, L, n, n_kv])."""
    import torch

    st = cont._state
    idx = torch.tensor(blocks, dtype=torch.long, device=st.tables.device)
    if st.quantized:
        return [st.q8_pages[:, :, idx], st.q8_scales[:, :, idx]]
    return [torch.stack([torch.stack([c[idx] for c in side])
                         for side in (st.caches_k, st.caches_v)])]


def differing_bytes(a, b):
    """Bytes that differ between two lists of same-shaped tensors."""
    import torch

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    return sum(int((raw(x) != raw(y)).sum()) for x, y in zip(a, b))


class Timed:
    """Host ms of every call of ``owner.name`` while installed (of those
    for which ``when()`` holds just before, if given), with the card
    synchronised before and after each call when ``sync`` is set (the
    time of the call's own device work, not of the work queued before
    it). Installs on an instance or a module; ``__exit__`` restores."""

    def __init__(self, owner, name, sync=False, when=None):
        self.owner, self.name, self.sync, self.when = owner, name, sync, when
        self.fn = getattr(owner, name)
        self.ms = []

    def __enter__(self):
        import torch

        def run(*args, **kw):
            if self.when is not None and not self.when():
                return self.fn(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.owner, self.name, run)
        return self

    def __exit__(self, *exc):
        if isinstance(self.owner, type(sys)):
            setattr(self.owner, self.name, self.fn)
        else:
            delattr(self.owner, self.name)  # the bound method shows again


def attention_check(fa, int8):
    """The stand-in that holds #11 (bf16 pool) or #12 (int8 pool) against
    its plain version on every call, on the table columns the live rows
    reach, with the split-K kernel's live splits counted."""
    if int8:
        return CheckedAttention(
            fa, "decode_attention_blocks_q8",
            fa.decode_attention_blocks_q8_plain, live=q8_live,
            weight=lambda q, kp, vp, ks, vs, kt, vt, tbl, ln: (
                int((tbl[:, 0] != 0).sum()), int(ln.sum())), walk=True,
            trim=True)
    return CheckedAttention(
        fa, "decode_attention_blocks", fa.decode_attention_blocks_plain,
        live=lambda q, kp, vp, tbl, ln: ((tbl[:, 0] != 0)
                                         & (ln >= q.shape[1])),
        weight=lambda q, kp, vp, tbl, ln: (int((tbl[:, 0] != 0).sum()),
                                           int(ln.sum())), walk=True,
        trim=True)


def cut_server(dev, srv, cont, layers):
    """A second InferenceServer + ContinuousEngine (started) with ``cont``'s
    settings and ``srv``'s debug token on the first ``layers`` layers of
    ``cont``'s parameter tensors (shared, not copied): (30b) and (31c)'s
    prefill replica and migration source."""
    import dataclasses

    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.engine import Engine

    params = {**cont.params, "layers": cont.params["layers"][:layers]}
    cfg = dataclasses.replace(cont.cfg, num_hidden_layers=layers)
    cut = ContinuousEngine(
        params, cfg, n_slots=cont.n_slots, cache_len=cont.cache_len,
        block_size=cont.block_size,
        prefill_chunk_blocks=cont.chunk_tokens // cont.block_size,
        kv_dtype=cont.kv_dtype, weight_dtype=cont.weight_dtype,
        migration_chunk_blocks=cont.migration_chunk_blocks,
        device=dev).start()
    cut_srv = server.InferenceServer(
        Engine(params, cfg, max_cache_len=srv.engine.max_cache_len,
               device=dev), f"{srv.model_id}-{layers}l", host="127.0.0.1",
        port=0, continuous=cut, device=dev, token=srv._token).start()
    return cut_srv, cut


def decode_replica(dev, pre_srv, pre):
    """A second ContinuousEngine + InferenceServer with ``pre``'s
    settings on its parameter tensors (its own pool), started: phase
    (30)'s decode replica and phase (31)'s migration target."""
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine

    dec = ContinuousEngine(
        pre.params, pre.cfg, n_slots=pre.n_slots, cache_len=pre.cache_len,
        block_size=pre.block_size,
        prefill_chunk_blocks=pre.chunk_tokens // pre.block_size,
        kv_dtype=pre.kv_dtype, weight_dtype=pre.weight_dtype,
        device=dev).start()
    dec_srv = server.InferenceServer(
        pre_srv.engine, "llama-3-8b-decode", host="127.0.0.1", port=0,
        continuous=dec, device=dev).start()
    return dec_srv, dec


def disagg_phase(dev, record, card, pre_srv, pre, then=None):
    """Phase (30): disaggregated prefill and decode on the server of
    (13)-(16) ("bf16") or (17)-(20) ("int8"), whose continuous engine is
    the prefill replica. A decode replica (a second ContinuousEngine +
    InferenceServer on the same parameter tensors, its own pool) takes
    the same bodies with ``kubeinfer_kv_source``: it pulls the blob from
    ``GET /kv/blocks``, verifies it and stages the pages into its pool,
    then admits warm and decodes through #11 (bf16 pool) or #12 (int8
    pool), with #15 on every int8 projection. Every call of those kernels
    is held against its plain version; the landed pages are bitwise the
    exporter's; the streams are bitwise those after a local prefill-only
    warm-up on a fresh engine, and equal to a cold prefill's up to a
    near-tie ([25]'s rule). ``then(dec_srv, dec)``, if given, runs on the
    decode replica before it stops (phase (31b)/(31c)). Returns the
    path's launch counts."""
    import gc

    import torch

    from kubeinfer_tpu_torch.disagg import client, wire
    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.stepper import RowFlags, decode_window

    t_phase = time.perf_counter()
    int8 = pre.kv_dtype == "int8"
    label = "[30b]" if int8 else "[30a]"
    cfg, bs = pre.cfg, pre.block_size
    V, layers = cfg.vocab_size, cfg.num_hidden_layers
    rng = np.random.default_rng(30 + int8)
    source = f"http://127.0.0.1:{pre_srv.port}"

    def engine():
        # the prefill replica's settings, on its parameter tensors
        return ContinuousEngine(
            pre.params, cfg, n_slots=pre.n_slots, cache_len=pre.cache_len,
            block_size=bs, prefill_chunk_blocks=pre.chunk_tokens // bs,
            kv_dtype=pre.kv_dtype, weight_dtype=pre.weight_dtype,
            device=dev)

    # 4 full blocks, and 4 full blocks + a tail (a chunk of 512 first)
    sampled = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    cases = [(rng.integers(1, V, 512).tolist(), {}),
             (rng.integers(1, V, 600).tolist(), sampled)]
    marks = {}
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    chk = attention_check(fa, int8)
    chk15 = CheckedMatmul(wq) if pre.weight_dtype == "int8" else None
    other = ("decode_attention_blocks" if int8
             else "decode_attention_blocks_q8")
    getattr(fa, other).launches = 0

    dec_srv, dec = decode_replica(dev, pre_srv, pre)
    try:
        # the main path, every kernel call checked and counted; the two
        # requests of each replica together (a row's tokens do not depend
        # on the batch's other rows)
        with torch.inference_mode(), chk, (chk15 or contextlib.nullcontext()):
            try:
                docs = in_threads(lambda c: post_json(pre_srv.port, dict(
                    prompt=c[0], max_tokens=0, **c[1])), cases)
                exports = [d["kubeinfer"].get("kv_export") for d in docs]
                check(all(d["kubeinfer"]["route"] == "prefill"
                          and d["choices"][0]["tokens"] == [] for d in docs)
                      and [e and e["blocks"] for e in exports]
                      == [len(p) // bs for p, _ in cases],
                      f"{label} prefill replica answered "
                      f"{[d['kubeinfer'] for d in docs]}")
                imp0 = (dec.imports_total, dec.imported_blocks_total)
                docs = in_threads(lambda c: post_json(dec_srv.port, dict(
                    prompt=c[0], max_tokens=DISAGG_NEW,
                    kubeinfer_kv_source=source, **c[1])), cases)
                check(all(d["kubeinfer"]["route"] == "continuous"
                          for d in docs),
                      f"{label} decode replica routes "
                      f"{[d['kubeinfer'] for d in docs]}")
                got = [d["choices"][0]["tokens"] for d in docs]
            finally:
                check(chk.error is None, str(chk.error))
                if chk15 is not None:
                    check(chk15.verify() is None, str(chk15.error))
        check(chk.calls >= layers and chk.calls % layers == 0,
              f"{label} {chk.name} checked on {chk.calls} calls")
        walk = chk.walk_check(label)[0]
        launches = {chk.name: chk.launches}
        check(chk.launches == chk.calls and chk.launches > 0,
              f"{label} {chk.name}: {chk.launches} launches, {chk.calls} calls")
        check(getattr(fa, other).launches == 0,
              f"{label} {other} launched on the {pre.kv_dtype} pool")
        if chk15 is not None:
            routes15 = chk15.all_tc(label)
            launches["quant_matmul"] = chk15.launches
        n_blocks = sum(len(p) // bs for p, _ in cases)
        check((dec.imports_total - imp0[0],
               dec.imported_blocks_total - imp0[1]) == (len(cases), n_blocks)
              and not family(dec_srv, "kubeinfer_disagg_fallbacks_total"),
              f"{label} imports {dec.scheduler_stats()}, fallbacks "
              f"{family(dec_srv, 'kubeinfer_disagg_fallbacks_total')}")
        # the same prompt again: advertised, so not fetched again (greedy:
        # its first 8 tokens are the first request's)
        again = post_json(dec_srv.port, dict(
            prompt=cases[0][0], max_tokens=8, kubeinfer_kv_source=source))
        check(dec.imports_total - imp0[0] == len(cases)
              and again["choices"][0]["tokens"] == got[0][:8],
              f"{label} a repeat was imported again or differs")
        # a source that does not answer: a local prefill, counted
        fb = post_json(dec_srv.port, dict(
            prompt=rng.integers(1, V, 512).tolist(), max_tokens=8,
            kubeinfer_kv_source="http://127.0.0.1:9"))
        check(fb["kubeinfer"]["route"] == "continuous"
              and len(fb["choices"][0]["tokens"]) == 8
              and family(dec_srv, "kubeinfer_disagg_fallbacks_total")
              == {'{reason="fetch_error"}': 1.0}
              and dec.imports_total - imp0[0] == len(cases),
              f"{label} fallback "
              f"{family(dec_srv, 'kubeinfer_disagg_fallbacks_total')}")
        mark("path")
        # the landed pages, bitwise the exporter's
        exported = [pool_pages(pre, pool_blocks(pre, p[:len(p) // bs * bs]))
                    for p, _ in cases]
        landed = [pool_pages(dec, pool_blocks(dec, p[:len(p) // bs * bs]))
                  for p, _ in cases]
        diff_landed = [differing_bytes(a, b)
                       for a, b in zip(exported, landed)]
        check(all(n == 0 for n in diff_landed),
              f"{label} imported pages differ from the exporter's: "
              f"{diff_landed} bytes")
        flags = RowFlags(sampled=True, top_k=True, top_p=True, penalty=True)
        with torch.inference_mode():
            _, sites = count_syncs(lambda: decode_window(
                dec.params, dec._state, cfg, 4, flags)[1].cpu())
        n_sync = sum(sites.values())
        check(n_sync == 1, f"{label} decode window host syncs {dict(sites)}")

        # times, unchecked: 3 more prompts through both replicas
        timing = {key: Timed(*args) for key, args in (
            ("capture", (pre, "_capture_export", True)),
            ("encode", (wire, "encode_payload")),
            ("fetch", (client, "fetch_kv_blocks")),
            # every scheduler pass calls it; timed where a task waits
            ("import", (dec, "_step_import", True,
                        lambda: bool(dec._imports))),
            # the server's whole import: fetch, verify, staged write
            ("server_import", (dec_srv, "_maybe_import_prefix")))}
        ttft, latency, wire_bytes = [], [], []
        with contextlib.ExitStack() as stack:
            for t in timing.values():
                stack.enter_context(t)
            for _ in range(3):
                p = rng.integers(1, V, 512).tolist()
                doc = post_json(pre_srv.port, dict(prompt=p, max_tokens=0))
                wire_bytes.append(doc["kubeinfer"]["kv_export"]["bytes"])
                t0 = time.perf_counter()
                doc = post_json(dec_srv.port, dict(
                    prompt=p, max_tokens=1, kubeinfer_kv_source=source))
                latency.append((time.perf_counter() - t0) * 1e3)
                ttft.append(doc["kubeinfer"]["ttft_ms"])
        check(dec.imports_total - imp0[0] == len(cases) + 3
              and len(timing["import"].ms) == 3,
              f"{label} timing runs imported {dec.imports_total}")
        import_s = [ms / 1e3 for ms in timing["server_import"].ms]
        streamed = (family(pre_srv, "kubeinfer_kv_stream_blocks_total"),
                    family(dec_srv, "kubeinfer_kv_stream_blocks_total"))
        mark("times")
        if then is not None:
            then(dec_srv, dec)
            mark("[31]")
    finally:
        dec_srv.stop()
        dec.stop()
    del dec, dec_srv, landed
    gc.collect()
    torch.cuda.empty_cache()

    # a fresh engine warmed by a local prefill-only request, then a cold one
    warm = engine().start()
    try:
        in_threads(lambda c: warm.serve(c[0], 0, timeout=300, **c[1]), cases)
        local = [pool_pages(warm, pool_blocks(warm, p[:len(p) // bs * bs]))
                 for p, _ in cases]
        warm_got = in_threads(lambda c: warm.serve(
            c[0], DISAGG_NEW, timeout=300, **c[1]).out_tokens, cases)
    finally:
        warm.stop()
    diff_local = [differing_bytes(a, b) for a, b in zip(exported, local)]
    del warm, local
    gc.collect()
    torch.cuda.empty_cache()
    cold = engine().start()
    try:
        reqs = in_threads(lambda c: cold.serve(c[0], DISAGG_NEW, timeout=300,
                                               **c[1]), cases)
        cold_got = [r.out_tokens for r in reqs]
        # alone, for the TTFT beside the import's
        r = cold.serve(rng.integers(1, V, 512).tolist(), 1, timeout=300)
        cold_ttft = (r.t_first - r.t_submit) * 1e3
    finally:
        cold.stop()
    del cold, exported
    gc.collect()
    torch.cuda.empty_cache()
    mark("warm and cold")
    check(all(n == 0 for n in diff_local),
          f"{label} a local prefill's pages differ from the exported ones: "
          f"{diff_local} bytes")
    check(got == warm_got, f"{label} the decode replica's streams differ "
          f"from a locally warmed engine's: {got} vs {warm_got}")
    # the sampled case's cold admit runs the same chunk + suffix as the
    # warm one; the greedy case's cold admit prefills all 512 at once
    check(got[1] == cold_got[1], f"{label} sampled stream differs from a "
          "cold prefill's")
    divs, _ = held_streams(f"{label} against a cold prefill:", [got[0]],
                           [cold_got[0]], [cases[0][0]], pre.params, cfg,
                           dev)
    mark("near-tie")

    p50 = statistics.median
    ms = {key: t.ms for key, t in timing.items()}
    before = record.get("int8_times" if int8 else "serving_times",
                        {}).get("ttft_ms")
    print(f"{label} {pre.kv_dtype} pool: 2 prompts (512 tokens greedy, 600 "
          f"sampled) prefilled by the prefill replica (max_tokens=0, route "
          f"prefill, exports {exports}), imported by the decode replica "
          f"over GET /kv/blocks ({n_blocks} blocks; blocks streamed, "
          f"prefill replica {streamed[0]}, decode replica {streamed[1]}), "
          f"{DISAGG_NEW} new tokens each: landed pages bitwise the "
          f"exporter's (differing bytes {diff_landed}); a local prefill's "
          f"pages against the exported ones: differing bytes {diff_local}; "
          f"streams bitwise equal to a locally warmed fresh engine's; "
          f"against a cold prefill: {divs} greedy divergence(s) (near-tie "
          f"rule), the sampled stream equal; a repeat not imported again; "
          f"an unreachable source fell back (fetch_error 1)")
    print(f"{label} {chk.name}: {chk.calls} calls on the decode replica's "
          f"imported requests, within tolerance of its plain version (on "
          f"the table columns the live rows reach, bitwise the whole "
          f"call's on the first); max |kernel - plain| "
          f"{chk.max_err:.3e}; split-K live splits {walk} by the kernel's "
          f"own count, equal to decode_split_walk's"
          + (f"; quant_matmul: {chk15.calls} calls on both replicas, within "
             f"tolerance, max |kernel - plain| {chk15.max_err:.3e}, routes "
             f"{routes15}" if chk15 is not None else "")
          + f"; launches {launches}; host syncs in one decode window "
          f"{n_sync}")
    print(f"{label} {card}: wire bytes of a 512-token prompt "
          f"{wire_bytes[0]} ({wire_bytes[0] / 2**20:.3f} MiB); export "
          f"capture p50 {p50(ms['capture']):.3f} ms {rounded(ms['capture'])}"
          f"; encode_payload p50 {p50(ms['encode']):.3f} ms "
          f"{rounded(ms['encode'])}; fetch + verify p50 "
          f"{p50(ms['fetch']):.3f} ms {rounded(ms['fetch'])}; staged import "
          f"on the scheduler thread p50 {p50(ms['import']):.3f} ms "
          f"{rounded(ms['import'])}; the server's whole import (fetch, "
          f"verify, staged write) {rounded([x * 1e3 for x in import_s])} "
          f"ms; decode replica TTFT after the import p50 {p50(ttft):.3f} ms "
          f"{rounded(ttft)}, request latency with the import p50 "
          f"{p50(latency):.3f} ms {rounded(latency)}; a cold 512-token "
          f"prefill's TTFT {cold_ttft:.3f} ms on a fresh engine"
          + (f", and p50 {p50(before):.3f} ms in "
             f"{'[20]' if int8 else '[16]'}" if before else ""))
    record["disagg_" + pre.kv_dtype] = {
        "exports": exports, "wire_bytes": wire_bytes,
        "capture_ms": ms["capture"], "encode_ms": ms["encode"],
        "fetch_verify_ms": ms["fetch"], "import_ms": ms["import"],
        "server_import_s": import_s, "ttft_ms": ttft,
        "latency_ms": latency, "cold_ttft_ms": cold_ttft,
        "launches": launches, "max_err": chk.max_err,
        "qmm_max_err": chk15.max_err if chk15 is not None else None,
        "split_walk": walk, "window_syncs": n_sync,
        "differing_bytes_landed": diff_landed,
        "differing_bytes_local": diff_local, "cold_divergences": divs,
        "streams": got, "split_s": marks,
    }
    record.setdefault("phase_s", {})[label] = time.perf_counter() - t_phase
    print(f"{label} seconds: {rounded(list(marks.values()))} "
          f"({', '.join(marks)})")
    return launches


# phase (31): preemption, drain and live-session migration
PREEMPT_POLICY = dict(threshold_s=0.0005, objective=0.5, burn_limit=0.5,
                      cooldown_steps=1, min_progress=1)
PREEMPT_NEW = 32  # new tokens of each (31a) request
PREEMPT_F32_LAYERS = 2  # (31a)'s f32 identity run, cut to this depth
# the budget of each (31b)/(31c) session: the drains land at 61-62 tokens
MIGRATE_NEW = 80
# tokens each session decodes before the drain: 600 + 48 tokens commit 5
# blocks of 128, so a v3 chunk follows the 4-block v1/v2 one
MIGRATE_AT = 48


def post_path(port, path, body, timeout=900, token=None):
    """(status, JSON body, headers) of a POST, an HTTP error's too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def wait_until(cond, what, timeout=300.0):
    """Poll ``cond`` every 2 ms; the phase fails after ``timeout``."""
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        time.sleep(0.002)


def scan_noise(seed, n, V, dev):
    """The gumbel noise ``stepper.decode_scan`` adds to a one-row
    request's scores [n, V]: output 0 from the first key of
    ``split(PRNGKey(seed))``, output i from the (i - 1)-th of
    ``split(rest, n - 1)`` (the per-request engines' schedule; the
    batcher folds the position into the key instead)."""
    import torch

    from kubeinfer_tpu_torch.inference import prng

    k0, rest = prng.split(prng.PRNGKey(seed, dev))
    rows = [prng.gumbel(k0, (1, V))[0]]
    if n > 1:
        keys = prng.split(rest, n - 1)
        rows += [prng.gumbel(keys[j], (1, V))[0] for j in range(n - 1)]
    return torch.stack(rows)


def sampled_tie(label, got, want, prompt, kw, params, cfg, dev, scan=False):
    """A sampled bf16 stream (``got``) that leaves ``want`` (the same
    request on another route) first at output i, held to [25]'s rule on
    the sampler's own decision. The sampler's scores are the tempered
    logits plus the request's gumbel noise (key fold_in(key(seed),
    len(prompt) + i)) over the filtered tokens, and it may draw any of
    those, so a position's allowance is 2 x the served forward's largest
    error on the tempered scores of the tokens the f32 top-k filter keeps
    + GAP_ULP; the envelope is the largest over both streams, all under
    teacher-forced forwards of the same weights (``scan``: the noise of
    ``decode_scan``'s key schedule, ``scan_noise``, for a request of the
    per-request engines). Held where the two
    tokens' f32 scores differ by no more than the envelope, or where
    either token lies within the envelope of one of the f32 filter's
    edges, which one route's bf16 logits may cross:

    - the top-k edge (in logits, envelope x temperature): kept, and that
      close above the (k+1)-th largest logit; or dropped, and that close
      below the k-th;
    - the nucleus (top_p) edge: with every tempered score moved by at
      most half the envelope, a token's cumulative probability of the
      tokens ranked above it can reach [lo, hi]: lo = the mass of the
      tokens surely above it (scores more than the envelope higher,
      surely kept by top-k) over the largest normalizer (every token
      top-k may keep) times e^-envelope; hi = the mass of every token
      that may rank above it over the smallest normalizer times
      e^envelope. The token is at the cut where lo < top_p <= hi: the
      nucleus may keep it on one route and drop it on the other.

    Returns (i, the f32 score gap, the envelope)."""
    import torch

    from kubeinfer_tpu_torch.inference import prng
    from kubeinfer_tpu_torch.inference.engine import filter_logits

    i = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
    T, k = float(kw["temperature"]), int(kw.get("top_k", 0))
    top_p = float(kw.get("top_p", 1.0))
    temp = torch.full((), T, dtype=torch.float32, device=dev)
    envelope, rows = 0.0, None
    for stream in (got, want):
        l16, l32 = forced_logits(params, cfg, prompt, stream, dev)
        n, V = l32.shape
        if scan:
            noise = scan_noise(int(kw.get("seed", 0)), n, V, dev)
        else:
            keys = prng.fold_in(
                prng.key(int(kw.get("seed", 0)), device=dev)[None].expand(
                    n, 2), len(prompt) + torch.arange(n, device=dev))
            noise = prng.gumbel(keys, (V,))
        kept_k = torch.isfinite(filter_logits(l32 / temp, k, 1.0))
        err = torch.where(kept_k, (l16 - l32).abs() / temp, 0.0)
        envelope = max(envelope, 2 * float(err.amax()) + GAP_ULP)
        if rows is None:  # the shared prefix: row i is the same in both
            keep = torch.isfinite(filter_logits(l32[i] / temp, k, top_p))
            rows = (l32[i], noise[i], kept_k[i], keep)
    l32, noise, kept_k, keep = rows
    x, y = got[i], want[i]
    gap = abs(float((l32[x] - l32[y]) / temp + noise[x] - noise[y]))
    edge = {}  # token: its f32 logit's distance from the top-k edge
    if k >= 1:
        top = l32.topk(k + 1).values
        for t in (x, y):
            edge[t] = float(l32[t] - top[k] if kept_k[t] else top[k - 1]
                            - l32[t])
    nucleus = {}  # token: (lo, hi) of its cumulative probability above it
    if top_p < 1.0:
        sc = (l32 / temp).double()
        e = envelope
        if k >= 1:
            top_s = sc.topk(k + 1).values
            may = sc >= top_s[k - 1] - e  # top-k may keep it
            sure = sc > top_s[k] + e  # top-k keeps it on any route
        else:
            may = sure = torch.ones_like(sc, dtype=torch.bool)
        w = torch.exp(sc - sc.max())
        for t in (x, y):
            here = torch.zeros_like(may)
            here[t] = True
            above_sure = float(w[sure & (sc > sc[t] + e)].sum())
            above_may = float(w[may & (sc >= sc[t] - e) & ~here].sum())
            z_max = float(w[may | here].sum())
            z_min = float(w[sure | here].sum())
            nucleus[t] = (above_sure / z_max * math.exp(-e),
                          above_may / z_min * math.exp(e))
    held = (gap <= envelope
            or any(d <= envelope * T for d in edge.values())
            or any(lo < top_p <= hi for lo, hi in nucleus.values()))
    print(f"{label} sampled divergence at output {i}: the two tokens' f32 "
          f"scores differ by {gap:.5f}, the largest allowance of the two "
          f"streams {envelope:.5f}; their f32 logits' distance from the "
          f"top-{k} edge (kept above the (k+1)-th, dropped below the k-th) "
          f"{ {t: round(d, 5) for t, d in edge.items()} }, kept "
          f"{[bool(keep[t]) for t in (x, y)]}"
          + (f"; the mass ranked above each, as far as the envelope may "
             f"move it, against top_p {top_p}: "
             f"{ {t: (round(lo, 5), round(hi, 5)) for t, (lo, hi) in nucleus.items()} }"
             if nucleus else ""))
    check(held, f"{label} a sampled stream leaves the other route's where "
          f"the sampler's f32 decision is not within the bf16 model's error")
    return i, gap, envelope


def held_pairs(label, got, want, jobs, params, cfg, dev, scan=False):
    """Each stream of ``got`` equal to the same request's in ``want`` (the
    same budget), or leaving it first at a near-tie: [25]'s rule for a
    greedy stream (``held_streams``), ``sampled_tie`` for a sampled one.
    Only the pairs that differ run the teacher-forced f32 forward.
    Returns the divergences as (request, output index)."""
    divs = []
    for n, (g, w, (p, kw)) in enumerate(zip(got, want, jobs)):
        check(len(g) == len(w), f"{label} request {n}: {len(g)} tokens "
              f"against {len(w)}")
        if g == w:
            continue
        if kw.get("temperature", 0.0) > 0:
            sampled_tie(f"{label} request {n}:", g, w, p, kw, params, cfg,
                        dev, scan=scan)
        else:
            held_streams(f"{label} request {n}:", [g], [w], [p], params,
                         cfg, dev)
        divs.append((n, next(j for j, (x, y) in enumerate(zip(g, w))
                             if x != y)))
    return divs


def preempt_phases(dev, record, card, params, cfg, cache_len):
    """Phase (31a) and (31a2): SLO-aware preemption at full width (and the
    depth of the tree given)
    on (13)'s parameter tensors: a 2-slot ContinuousEngine (``cache_len``,
    blocks of 128, its default pool, prefill chunks of 4 blocks) under the
    reference tests' aggressive policy, with a queue depth limit of 5.
    (a): 6 requests of 512 tokens (3 greedy, 3 sampled), 32 new each,
    while one more is shed at the door; parks and readmits counted, every
    readmit warm, #11 held on every call, one host sync a decode window,
    every stream equal to an uncontended run on the same engine class or
    leaving it at a near-tie; the same at PREEMPT_F32_LAYERS layers in f32
    (#11 on CUDA cores), every stream EQUAL. (a2): the same engine with the
    target as its own draft (spec_k 4): 4 greedy requests through verify
    windows across preemption cycles, #11 at T = 5 and #10 on the draft
    steps held on every call. Returns the launch counts of #10 and #11."""
    import dataclasses
    import gc

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference.batching import (
        ContinuousEngine,
        EngineOverloadedError,
        PreemptionPolicy,
    )
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.stepper import RowFlags, decode_window

    t_phase = time.perf_counter()
    marks = {}
    t_mark = [t_phase]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    V, layers = cfg.vocab_size, cfg.num_hidden_layers
    rng = np.random.default_rng(31)
    jobs = [(rng.integers(1, V, 512).tolist(), {}) for _ in range(3)]
    jobs += [(rng.integers(1, V, 512).tolist(),
              dict(temperature=0.9, top_k=11, seed=s))
             for s in (100, 101, 102)]
    jobs_a2 = jobs[:3] + [(rng.integers(1, V, 512).tolist(), {})]
    pol = PreemptionPolicy(**PREEMPT_POLICY)

    def engine(p=params, c=cfg, n_slots=2, **kw):
        return ContinuousEngine(p, c, n_slots=n_slots, cache_len=cache_len,
                                prefill_chunk_blocks=4, device=dev, **kw)

    def latency_ms(r):
        return (r.token_times[-1] - r.t_submit) * 1e3

    def uncontended(p, c, todo):
        """Every request at once on a slot of its own: nobody waits."""
        ref = engine(p, c, n_slots=len(todo)).start()
        try:
            reqs = in_threads(lambda j: ref.serve(
                j[0], PREEMPT_NEW, timeout=900, **j[1]), todo)
        finally:
            ref.stop()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        return [r.out_tokens for r in reqs], [latency_ms(r) for r in reqs]

    plain, plain_ms = uncontended(params, cfg, jobs + jobs_a2[3:])
    mark("uncontended")

    # (a) under the policy; a sixth waiting request is shed
    eng = engine(preemption=pol, queue_depth_limit=5)
    check(eng._pool.num_blocks == 1 + 4 * eng.max_blocks,
          f"[31a] pool of {eng._pool.num_blocks} blocks")
    admits = []  # (readmit?, reused blocks, ms) of every finalized admit
    finalize = eng._finalize_admit

    def logged(task):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finalize(task)
        torch.cuda.synchronize()
        admits.append((task.resumed, task.reuse,
                       (time.perf_counter() - t0) * 1e3))

    eng._finalize_admit = logged

    def contended(eng):
        """Five requests queued before the scheduler starts, a sixth shed
        at the door, then let in once both slots are busy."""
        reqs = [eng.submit(p, PREEMPT_NEW, **kw) for p, kw in jobs[:5]]
        shed = None
        try:
            eng.submit(jobs[5][0], PREEMPT_NEW, **jobs[5][1])
        except EngineOverloadedError as e:
            shed = e
        check(shed is not None and shed.request.failed == "shed"
              and shed.request.done.is_set() and shed.retry_after_s > 0,
              f"[31a] a request past 5 waiting was not shed: {shed!r}")
        eng.start()
        wait_until(lambda: all(r is not None for r in eng._slot_req),
                   "[31a] both slots busy")
        reqs.append(eng.submit(jobs[5][0], PREEMPT_NEW, **jobs[5][1]))
        for r in reqs:
            check(r.done.wait(900) and not r.failed,
                  f"[31a] a request failed: {r.failed!r}")
        return reqs

    chk = attention_check(fa, False)
    with torch.inference_mode(), chk:
        try:
            reqs = contended(eng)
        finally:
            check(chk.error is None, str(chk.error))
    # the scheduler thread logs an admit after the admit completes its
    # request: join it before the counts are read
    eng.stop()
    stats = eng.scheduler_stats()
    got = [r.out_tokens for r in reqs]
    readmits = [a for a in admits if a[0]]
    cold = [a for a in admits if not a[0]]
    check(stats["preempted"] > 0 and stats["resumed"] == stats["preempted"]
          and stats["parked"] == 0 and stats["chunk_queue"] == 0,
          f"[31a] scheduler {stats}")
    check(len(readmits) == stats["resumed"] and len(cold) == len(jobs)
          and all(reuse > 0 for _, reuse, _ in readmits),
          f"[31a] admits (readmit, reused blocks, ms) {admits}")
    check(all(len(g) == PREEMPT_NEW for g in got), "[31a] a budget unmet")
    check(chk.calls > 0 and chk.calls % layers == 0
          and chk.launches == chk.calls,
          f"[31a] #11: {chk.launches} launches, {chk.calls} calls")
    walk = chk.walk_check("[31a]")[0]
    flags = RowFlags(sampled=True, top_k=True, top_p=True, penalty=True)
    with torch.inference_mode():
        _, sites = count_syncs(lambda: decode_window(
            eng.params, eng._state, cfg, 4, flags)[1].cpu())
    n_sync = sum(sites.values())
    check(n_sync == 1, f"[31a] decode window host syncs {dict(sites)}")
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    mark("checked run")
    divs = held_pairs("[31a]", got, plain[:6], jobs, params, cfg, dev)
    mark("near-tie")
    # in f32 at a cut depth the readmit's dense tail and #11 agree to the
    # last bit: the streams under the policy EQUAL the uncontended ones
    c32 = dataclasses.replace(cfg, num_hidden_layers=PREEMPT_F32_LAYERS)
    p32 = init_params(c32, seed=0, dtype=torch.float32, device=dev)
    want32, _ = uncontended(p32, c32, jobs)
    chk32 = attention_check(fa, False)
    e32 = engine(p32, c32, preemption=pol, queue_depth_limit=5)
    with torch.inference_mode(), chk32:
        try:
            got32 = [r.out_tokens for r in contended(e32)]
        finally:
            e32.stop()
            check(chk32.error is None, str(chk32.error))
    st32 = e32.scheduler_stats()
    del e32, p32
    gc.collect()
    torch.cuda.empty_cache()
    check(got32 == want32 and st32["preempted"] > 0
          and st32["resumed"] == st32["preempted"] and chk32.launches > 0,
          f"[31a] f32 at {PREEMPT_F32_LAYERS} layers: streams equal "
          f"{[g == w for g, w in zip(got32, want32)]}, scheduler {st32}, "
          f"#11 launches {chk32.launches}")
    mark("f32")
    # the latencies with nothing checked, on a fresh engine
    et = engine(preemption=pol, queue_depth_limit=5)
    try:
        reqs = contended(et)
        lat = [latency_ms(r) for r in reqs]
        st_t = et.scheduler_stats()
    finally:
        et.stop()
    del et, reqs
    gc.collect()
    torch.cuda.empty_cache()
    mark("times")

    # (a2) verify windows across preemption cycles
    ea = engine(preemption=pol, spec_draft=(params, cfg), spec_k=4).start()
    chk11 = attention_check(fa, False)
    chk10 = CheckedAttention(
        fa, "decode_attention", fa.decode_attention_plain,
        live=lambda q, kk, vv, ln: ln > 0, weight=lambda *a: 0, walk=True,
        trim=True)
    with torch.inference_mode(), chk11, chk10:
        try:
            reqs = [ea.submit(p, PREEMPT_NEW, **kw) for p, kw in jobs_a2]
            for r in reqs:
                check(r.done.wait(900) and not r.failed,
                      f"[31a2] a request failed: {r.failed!r}")
        finally:
            check(chk11.error is None and chk10.error is None,
                  f"{chk11.error} {chk10.error}")
    st2 = ea.scheduler_stats()
    got2 = [r.out_tokens for r in reqs]
    ea.stop()
    del ea, reqs
    gc.collect()
    torch.cuda.empty_cache()
    check(st2["preempted"] >= 1 and st2["resumed"] == st2["preempted"]
          and st2["spec_draft_tokens"] > 0 and st2["parked"] == 0,
          f"[31a2] scheduler {st2}")
    check(chk11.calls > 0 and chk11.launches == chk11.calls
          and chk10.calls > 0 and chk10.launches == chk10.calls,
          f"[31a2] #11 {chk11.launches}/{chk11.calls}, #10 "
          f"{chk10.launches}/{chk10.calls} launches/calls")
    walks2 = [c.walk_check("[31a2]")[0] for c in (chk11, chk10)]
    mark("(a2) run")
    divs2 = held_pairs("[31a2]", got2, plain[:3] + plain[6:], jobs_a2,
                       params, cfg, dev)
    mark("(a2) near-tie")

    p50 = statistics.median
    re_ms = [ms for _, _, ms in readmits]
    cold_ms = [ms for _, _, ms in cold]
    print(f"[31a] {card}: 6 requests of 512 tokens (3 greedy, 3 sampled), "
          f"{PREEMPT_NEW} new each, through 2 slots under "
          f"PreemptionPolicy({PREEMPT_POLICY}) and queue_depth_limit 5: a "
          f"request past 5 waiting shed (EngineOverloadedError, failed "
          f"'shed'); parks {stats['preempted']}, readmits "
          f"{stats['resumed']}, every readmit warm (reused blocks "
          f"{sorted(set(r for _, r, _ in readmits))}); #11 on "
          f"{chk.calls} calls within tolerance, max |kernel - plain| "
          f"{chk.max_err:.3e}, split-K live splits {walk}; host syncs in "
          f"one decode window {n_sync}; streams against an uncontended run "
          f"(request, output index of the first divergence): {divs}; in f32 "
          f"at {PREEMPT_F32_LAYERS} layers ({st32['preempted']} parks, #11 on "
          f"{chk32.calls} calls within tolerance, max |kernel - plain| "
          f"{chk32.max_err:.3e}) every stream equal")
    print(f"[31a] {card}: readmit admit p50 {p50(re_ms):.3f} ms "
          f"{rounded(sorted(re_ms))}, a cold 512-token admit p50 "
          f"{p50(cold_ms):.3f} ms {rounded(cold_ms)}; request latency "
          f"under preemption (unchecked, {st_t['preempted']} parks) p50 "
          f"{p50(lat):.1f} ms (max {max(lat):.1f}), uncontended (a slot "
          f"each) p50 {p50(plain_ms[:6]):.1f} ms (max "
          f"{max(plain_ms[:6]):.1f})")
    print(f"[31a2] {card}: 4 greedy requests through verify windows (the "
          f"target as its own draft, spec_k 4) under the same policy: parks "
          f"{st2['preempted']}, readmits {st2['resumed']}, proposed "
          f"{st2['spec_draft_tokens']} and accepted "
          f"{st2['spec_accepted_tokens']} draft tokens; #11 at T = 5 on "
          f"{chk11.calls} calls and #10 on {chk10.calls} draft-step calls "
          f"within tolerance (max |kernel - plain| {chk11.max_err:.3e}, "
          f"{chk10.max_err:.3e}; live splits {walks2}); streams against the "
          f"plain engine's: divergences {divs2}")
    record["preempt"] = {
        "stats": stats, "admits": admits, "latency_ms": lat,
        "timing_stats": st_t,
        "uncontended_latency_ms": plain_ms, "divergences": divs,
        "max_err": chk.max_err, "launches": chk.launches, "split_walk": walk,
        "window_syncs": n_sync, "verify_stats": st2,
        "verify_divergences": divs2,
        "verify_launches": [chk11.launches, chk10.launches],
        "verify_max_err": [chk11.max_err, chk10.max_err],
        "f32_stats": st32, "f32_launches": chk32.launches, "split_s": marks,
    }
    print(f"[31a] seconds: {rounded(list(marks.values()))} ({', '.join(marks)})")
    record.setdefault("phase_s", {})["[31a]"] = time.perf_counter() - t_phase
    return {"decode_attention_blocks": chk.launches + chk11.launches,
            "decode_attention": chk10.launches}


def migrate_phase(dev, record, card, src_srv, src, dst_srv, dst):
    """Phase (31b) on (30a)'s cut bf16 server with (30a)'s decode replica
    as the target, or (31c) on (30b)'s cut int8 server with (30b)'s: a
    600-token greedy and a 600-token sampled session (80 new each) on
    the source; once each decoded 48 tokens, ``POST /admin/drain``: the
    sessions stream their committed blocks (a 4-block v1/v2 chunk, then
    v3) into the export cache and complete as migrated; new work answers
    503 ``draining``. Each resumes on the target from ``kubeinfer_resume
    {tokens, kv_source}``: the chain lands bitwise (the int8 scales too)
    and counted, the whole stream equals an uninterrupted run on the
    target or leaves it at a near-tie. #11 (or #12 and #15) held against
    its plain version on every call of both replicas. A degenerate tail
    answers with no admit; ``{"resume": true}`` undrains the source. The
    times come from a second drain and resume with nothing checked (two
    new sessions). Returns the path's launch counts."""
    import threading

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.kv_blocks import prefix_fingerprints

    t_phase = time.perf_counter()
    marks = {}
    t_mark = [t_phase]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    int8 = src.kv_dtype == "int8"
    label = "[31c]" if int8 else "[31b]"
    cfg, bs = src.cfg, src.block_size
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(310 + int8)
    sampled = dict(temperature=0.8, top_k=50, seed=11)

    def sessions():
        return [(rng.integers(1, cfg.vocab_size, 600).tolist(), {}),
                (rng.integers(1, cfg.vocab_size, 600).tolist(), sampled)]

    source = f"http://127.0.0.1:{src_srv.port}"
    check(src.migration_sink is not None and src.migration_chunk_blocks == 4
          and dst.migration_chunk_blocks == 4,
          f"{label} the source's sink or chunk size")

    def migrate(jobs, budget, together=True):
        """The sessions on the source, the drain once each decoded
        MIGRATE_AT tokens, a request refused while draining, and the
        resumes on the target (``together``, else one after the other).
        Returns the drain's (report, ms), the sessions' and the resumes'
        answers, the refusal, and each chunk pass's gather and export
        ms."""
        gather = Timed(src, "_gather_pages", True)
        sink, sink_ms = src.migration_sink, []

        def timed_sink(chunk):
            t0 = time.perf_counter()
            sink(chunk)
            sink_ms.append((time.perf_counter() - t0) * 1e3)

        docs = [None] * len(jobs)

        def client(n):
            docs[n] = post_json(src_srv.port, dict(
                prompt=jobs[n][0], max_tokens=budget, **jobs[n][1]))

        def live():
            rows = [r for r in src._slot_req if r is not None
                    and any(r.prompt == p for p, _ in jobs)]
            return len(rows) == len(jobs) and all(
                len(r.out_tokens) >= MIGRATE_AT for r in rows)

        src.migration_sink = timed_sink
        try:
            with gather:
                threads = [threading.Thread(target=client, args=(n,))
                           for n in range(len(jobs))]
                for th in threads:
                    th.start()
                wait_until(live, f"{label} the sessions past {MIGRATE_AT} "
                           "tokens")
                t0 = time.perf_counter()
                status, report, _ = post_path(src_srv.port, "/admin/drain",
                                              {}, token=OBSERVE_TOKEN)
                drain_ms = (time.perf_counter() - t0) * 1e3
                for th in threads:
                    th.join(900)
        finally:
            src.migration_sink = sink
        check(status == 200 and all(d is not None for d in docs),
              f"{label} drain {status} {report}, a session's client failed")
        refused = post_path(src_srv.port, "/v1/completions",
                            dict(prompt=jobs[0][0][:64], max_tokens=2))
        mig = [d["kubeinfer"]["migrated"] for d in docs]

        resume_ms = [None] * len(jobs)

        def resume(n):
            t0 = time.perf_counter()
            doc = post_json(dst_srv.port, dict(
                prompt=jobs[n][0], max_tokens=budget,
                kubeinfer_resume={"tokens": mig[n]["tokens"],
                                  "kv_source": source}, **jobs[n][1]))
            resume_ms[n] = (time.perf_counter() - t0) * 1e3
            return doc

        order = list(range(len(jobs)))
        resumed = (in_threads(resume, order) if together
                   else [resume(n) for n in order])
        return (report, drain_ms), docs, mig, resumed, refused, \
            gather.ms, sink_ms, resume_ms

    chk = attention_check(fa, int8)
    chk15 = (CheckedMatmul(wq, keep_f32=True) if src.weight_dtype == "int8"
             else None)
    stream_blocks = family(dst_srv, "kubeinfer_kv_stream_blocks_total")
    imp0 = (dst.imports_total, dst.imported_blocks_total,
            stream_blocks.get('{direction="import"}', 0.0))
    chunks0 = (src.migration_chunks_total, src.migration_blocks_total)
    jobs = sessions()
    # without the bearer token a drain is refused and the source undrained
    st, body, _ = post_path(src_srv.port, "/admin/drain", {})
    check(st == 401 and body == {"error": "unauthorized"}
          and not src.draining,
          f"{label} a drain without the token answered {st} {body}")
    with torch.inference_mode(), chk, (chk15 or contextlib.nullcontext()):
        try:
            (report, _), docs, mig, resumed, refused, _, _, _ = migrate(
                jobs, MIGRATE_NEW)
        finally:
            check(chk.error is None, str(chk.error))
            if chk15 is not None:
                check(chk15.verify() is None, str(chk15.error))
    mark("checked path")
    chunks = src.migration_chunks_total - chunks0[0]
    blocks = src.migration_blocks_total - chunks0[1]
    check(report["drained"] and report["draining"]
          and report["migrated"] == 2 and chunks >= 4,
          f"{label} drain report {report}, {chunks} chunks")
    chains = [(p + m["tokens"])[:-1] for (p, _), m in zip(jobs, mig)]
    for d, m, chain in zip(docs, mig, chains):
        toks = m["tokens"]
        check(d["choices"][0]["finish_reason"] == "migrated"
              and d["choices"][0]["tokens"] == toks
              and MIGRATE_AT <= len(toks) < MIGRATE_NEW
              and m["blocks"] == len(chain) // bs >= 5
              and m["kv_dtype"] == src.kv_dtype,
              f"{label} migrated session {d['kubeinfer']}")
    check(blocks == sum(m["blocks"] for m in mig),
          f"{label} {blocks} blocks streamed for {mig}")
    check(refused[0] == 503 and refused[1]["error"]["type"] == "draining"
          and "Retry-After" not in refused[2],
          f"{label} new work on the draining source: {refused[:2]}")
    # the chunks in the source's export cache: v1 (v2 in int8) for the
    # first 4 blocks, then v3
    chunk_bytes, magics = [], []
    for chain in chains:
        fps = prefix_fingerprints(chain, bs)
        for fp in (fps[3], fps[-1]):
            blob = src_srv.kv_exports.get(fp)
            check(blob is not None, f"{label} a chunk left the export cache")
            magics.append(json.loads(blob[:blob.find(b"\n")])["magic"][-1])
            chunk_bytes.append(len(blob))
    check(magics == ["2" if int8 else "1", "3"] * 2,
          f"{label} chunk wire versions {magics}")
    full = [d["choices"][0]["tokens"] for d in resumed]
    for d, m, f in zip(resumed, mig, full):
        check(d["kubeinfer"]["route"] == "resume"
              and d["choices"][0]["finish_reason"] == "length"
              and len(f) == MIGRATE_NEW
              and f[:len(m["tokens"])] == m["tokens"],
              f"{label} resume answered {d['kubeinfer']}")
    n_chain = sum(m["blocks"] for m in mig)
    fallbacks = family(dst_srv, "kubeinfer_migration_fallbacks_total")
    check((dst.imported_blocks_total - imp0[1],
           dst_srv.metrics["kv_stream_blocks"].value("import") - imp0[2])
          == (n_chain, n_chain)
          and dst.imports_total - imp0[0] == 4 and not fallbacks,
          f"{label} chain imports {dst.scheduler_stats()}, fallbacks "
          f"{fallbacks}")
    diff = []
    for chain in chains:
        n = len(chain) // bs
        a, b = (pool_blocks(e, chain[:n * bs]) for e in (src, dst))
        check(len(a) == len(b) == n, f"{label} {len(a)} and {len(b)} of "
              f"{n} chain blocks cached")
        diff.append(differing_bytes(pool_pages(src, a), pool_pages(dst, b)))
    check(diff == [0, 0], f"{label} landed pages differ from the source's: "
          f"{diff} bytes")
    check(chk.calls > 0 and chk.calls % layers == 0
          and chk.launches == chk.calls,
          f"{label} {chk.name}: {chk.launches} launches, {chk.calls} calls")
    walk = chk.walk_check(label)[0]
    launches = {chk.name: chk.launches}
    if chk15 is not None:
        routes15 = chk15.all_tc(label)
        launches["quant_matmul"] = chk15.launches

    # a degenerate tail: answered with no admit
    before = dst.scheduler_stats()
    st, doc, _ = post_path(dst_srv.port, "/v1/completions", dict(
        prompt=jobs[0][0], max_tokens=8,
        kubeinfer_resume={"tokens": mig[0]["tokens"][:8]}))
    check(st == 200 and doc["kubeinfer"]["route"] == "resume"
          and doc["choices"][0]["tokens"] == mig[0]["tokens"][:8]
          and dst.scheduler_stats() == before,
          f"{label} degenerate tail {st} {doc}")

    def undrain():
        st, rep, _ = post_path(src_srv.port, "/admin/drain", {"resume": True},
                               token=OBSERVE_TOKEN)
        check(st == 200 and rep["drained"] and not rep["draining"]
              and not src.draining, f"{label} undrain {rep}")
        ok = post_json(src_srv.port, dict(prompt=jobs[0][0][:64],
                                          max_tokens=2))
        check(len(ok["choices"][0]["tokens"]) == 2, f"{label} after undrain")

    undrain()
    mark("checks")
    # an uninterrupted run on the target, for the streams
    ref = in_threads(lambda j: dst.serve(j[0], MIGRATE_NEW, timeout=900,
                                         **j[1]).out_tokens, jobs)
    mark("uninterrupted")
    divs = held_pairs(label, full, ref, jobs, src.params, cfg, dev)
    mark("near-tie")

    # times, nothing checked: two new sessions of 128, drained and resumed
    # the target's whole chain import: fetch, verify, staged writes
    with Timed(dst_srv, "_maybe_import_chain") as chain_t:
        (report_t, drain_ms), _, mig_t, resumed_t, _, gather_ms, sink_ms, \
            resume_ms = migrate(sessions(), MIGRATE_NEW, together=False)
    check(report_t["migrated"] == 2 and all(
        d["kubeinfer"]["route"] == "resume"
        and len(d["choices"][0]["tokens"]) == MIGRATE_NEW
        for d in resumed_t),
        f"{label} the timing drain {report_t}")
    undrain()
    import_s = [ms / 1e3 for ms in chain_t.ms]
    ttft = [d["kubeinfer"]["ttft_ms"] for d in resumed_t]
    mark("times")

    p50 = statistics.median
    first_ms = [s * 1e3 + t for s, t in zip(import_s, ttft)]
    print(f"{label} {src.kv_dtype} pool: 2 sessions of 600 tokens (greedy, "
          f"sampled; {MIGRATE_NEW} new) drained at "
          f"{[len(m['tokens']) for m in mig]} tokens: POST /admin/drain "
          f"{report['migrated']} migrated, {chunks} chunks, {blocks} blocks "
          f"streamed (wire versions {magics} of the first and last chunk "
          f"of each), new work 503 draining; resumed on the target "
          f"(route resume, {n_chain} chain blocks imported, landed pages "
          f"{'and scales ' if int8 else ''}bitwise the source's: differing "
          f"bytes {diff}); whole streams against an uninterrupted run on "
          f"the target: divergences (request, output index) {divs}; a "
          f"degenerate tail answered with no admit; undrained and serving")
    print(f"{label} {chk.name}: {chk.calls} calls on both replicas within "
          f"tolerance of its plain version, max |kernel - plain| "
          f"{chk.max_err:.3e}, split-K live splits {walk}"
          + (f"; quant_matmul: {chk15.calls} calls within tolerance, max "
             f"|kernel - plain| {chk15.max_err:.3e}, routes {routes15}"
             if chk15 is not None else "") + f"; launches {launches}")
    print(f"{label} {card}, unchecked (2 sessions of {MIGRATE_NEW} drained at "
          f"{[len(m['tokens']) for m in mig_t]} tokens, resumed one after "
          f"the other): drain "
          f"{drain_ms:.1f} ms from POST to drained; chunk wire bytes "
          f"{chunk_bytes} (MiB {rounded([b / 2**20 for b in chunk_bytes])})"
          f"; per chunk pass gather p50 {p50(gather_ms):.3f} ms "
          f"{rounded(gather_ms)}, encode + export p50 {p50(sink_ms):.3f} ms "
          f"{rounded(sink_ms)}; chain import on the target (fetch, verify, "
          f"staged writes) {rounded([s * 1e3 for s in import_s])} ms; "
          f"resume TTFT after the import {rounded(ttft)} ms, import + TTFT "
          f"{rounded(first_ms)} ms")
    record["migrate_" + src.kv_dtype] = {
        "drain_ms": drain_ms, "report": report, "chunks": chunks,
        "blocks": blocks, "chunk_bytes": chunk_bytes, "magics": magics,
        "gather_ms": gather_ms, "encode_ms": sink_ms,
        "import_s": import_s, "resume_ttft_ms": ttft,
        "resume_latency_ms": resume_ms,
        "migrated_tokens": [len(m["tokens"]) for m in mig],
        "timing_migrated_tokens": [len(m["tokens"]) for m in mig_t],
        "differing_bytes": diff, "divergences": divs,
        "launches": launches, "max_err": chk.max_err, "split_walk": walk,
        "qmm_max_err": chk15.max_err if chk15 is not None else None,
        "split_s": marks,
    }
    print(f"{label} seconds: {rounded(list(marks.values()))} "
          f"({', '.join(marks)})")
    record.setdefault("phase_s", {})[label] = time.perf_counter() - t_phase
    return launches


# phase (34): the fleet router and the fleet plane
FLEET_REQUESTS = 10_000  # (34a): fleet_storm_bench's requests
FLEET_CHUNK = 256  # (34a): route_batch's batch, as the bench's
FLEET_MIGRATE_NEW = 48  # (34b): new tokens of the re-routed session


def fleet_plant(router, n_requests=FLEET_REQUESTS, n_replicas=100,
                fps=None):
    """``storm_plant``'s fleet (bench.py:fleet_storm_bench's) planted into
    ``router`` through ``add_replica`` and ``update_replica`` with real
    summaries. Returns the requests and the planted (dead, draining,
    stale) name sets."""
    replicas, requests, *masks = storm_plant(n_replicas, n_requests,
                                             fps=fps)
    for name, stats, age_s in replicas:
        router.add_replica(name, f"http://{name}:8000")
        router.update_replica(name, stats, age_s=age_s)
    return requests, *({f"r{i:03d}" for i in m} for m in masks)


def fleet_storm(dev, chk):
    """(34a): fleet_storm_bench's decisions on ``FleetRouter(device=dev)``
    (a SimulatedClock keeps the planted ages): the 10,000 requests by
    ``route_batch(engine="solver")`` in chunks of 256 in the three modes,
    every pick through ``chk``; the parity decisions equal to the
    ``engine="python"`` decisions on every chunk (every field), the first
    chunk's also to per-request ``route()``; the skip counters and the
    replica gauge equal to the planted masks. Times: per-request us of
    ``route_batch`` in each mode (chunk wall / chunk size, the match plane
    included, p50 over chunks after the first) and of one ``route()``."""
    from kubeinfer_tpu_torch.router import FleetRouter
    from kubeinfer_tpu_torch.utils.clock import SimulatedClock

    router = FleetRouter(clock=SimulatedClock(start=1000.0).now, device=dev)
    requests, dead, draining, stale = fleet_plant(router)
    chunks = [requests[i:i + FLEET_CHUNK]
              for i in range(0, len(requests), FLEET_CHUNK)]
    route_us, singles = [], []
    for t in chunks[0]:
        t0 = time.perf_counter()
        singles.append(router.route(t))
        route_us.append((time.perf_counter() - t0) * 1e6)
    # a chunk's us: its wall time less the checks' (chk.check_s), so the
    # plain pick and the compare of every launch stay out of the number;
    # each launch still ends in a sync before its check
    us, checked_us, decided, launches = {}, {}, {}, {}
    for mode in ("parity", "greedy", "auction"):
        n0, out, us[mode], checked_us[mode] = chk.launches, [], [], []
        for c in chunks:
            c0, t0 = chk.check_s, time.perf_counter()
            out += router.route_batch(c, engine="solver", mode=mode)
            wall = time.perf_counter() - t0
            checked_us[mode].append(wall * 1e6 / len(c))
            us[mode].append((wall - (chk.check_s - c0)) * 1e6 / len(c))
        decided[mode], launches[mode] = out, chk.launches - n0
    python_us, bad = [], []
    for n, c in enumerate(chunks):
        t0 = time.perf_counter()
        py = router.route_batch(c, engine="python")
        python_us.append((time.perf_counter() - t0) * 1e6 / len(c))
        if py != decided["parity"][n * FLEET_CHUNK:(n + 1) * FLEET_CHUNK]:
            bad.append(n)
    check(not bad, f"(34a) parity decisions differ from the python "
          f"engine's on chunks {bad}")
    check(decided["parity"][:len(singles)] == singles,
          "(34a) the first chunk's parity decisions differ from route()'s")
    check(all(d is not None for ds in decided.values() for d in ds),
          "(34a) a request left unrouted")
    check(all(d.stale == (d.replica in stale) for ds in decided.values()
              for d in ds), "(34a) a decision's stale flag")
    n_decided = len(singles) + 4 * len(requests)
    skipped = router.metrics["skipped"]
    wrong = [(v.name, reason, skipped.value(v.name, reason))
             for v in router.replicas()
             for reason, want in (
                 ("dead", n_decided if v.name in dead else 0),
                 ("draining", n_decided if v.name in draining - dead
                  else 0),
                 ("breaker", 0), ("failed", 0))
             if skipped.value(v.name, reason) != want]
    check(not wrong, f"(34a) skip counters against the planted masks: "
          f"{wrong[:6]}")
    gauge = {state: router.metrics["replicas"].value(state)
             for state in ("alive", "stale", "dead", "draining")}
    n_stale = len(stale - dead - draining)
    want_gauge = {"alive": 100 - len(dead | draining) - n_stale,
                  "stale": n_stale, "dead": len(dead),
                  "draining": len(draining - dead)}
    check(gauge == want_gauge, f"(34a) replica gauge {gauge}, planted "
          f"{want_gauge}")
    routed = {m: router.metrics["solver_routed"].value(m)
              for m in ("parity", "greedy", "auction", "python")}
    check(all(n == len(requests) for n in routed.values()),
          f"(34a) solver_routed {routed}")
    p50 = {m: statistics.median(v[1:]) for m, v in us.items()}
    checked_p50 = {m: statistics.median(v[1:]) for m, v in checked_us.items()}
    route_p50 = statistics.median(route_us)
    python_p50 = statistics.median(python_us[1:])
    used = {m: len({d.replica for d in ds}) for m, ds in decided.items()}
    hits = sum(not d.fallback for d in decided["parity"])
    print(f"(34a) fleet_storm_bench's plant on FleetRouter(device="
          f"{dev.type}): "
          f"100 replicas ({len(dead)} dead, {len(draining - dead)} "
          f"draining, {n_stale} stale), {len(requests)} requests in "
          f"{len(chunks)} chunks of <= {FLEET_CHUNK}: parity decisions "
          f"equal to the python engine's on every chunk and the first "
          f"chunk's to route()'s (every field); skip counters and the "
          f"replica gauge equal to the planted masks; route_pick launches "
          f"{launches}, each bitwise equal to route_pick_plain; replicas "
          f"used {used}; affinity hits {hits} of {len(requests)}")
    print(f"(34a) per-request us of route_batch, match plane included, "
          f"the checks' own time taken out, p50 over chunks "
          f"2-{len(chunks)}: parity {p50['parity']:.2f}, "
          f"greedy {p50['greedy']:.2f}, auction {p50['auction']:.2f} "
          f"(with the checks {rounded(list(checked_p50.values()))}); "
          f"engine='python' {python_p50:.2f}; one route() call p50 "
          f"{route_p50:.2f} us (over the first chunk's {len(singles)})")
    return {"route_batch_us_p50": p50, "route_batch_us": us,
            "checked_us_p50": checked_p50, "checked_us": checked_us,
            "python_us_p50": python_p50, "route_us_p50": route_p50,
            "route_us": route_us, "launches": launches,
            "replicas_used": used, "affinity_hits": hits,
            "skip_gauge": gauge}


def fleet_http(dev, srv, cont, dec_srv, dec):
    """(34b): a RouterServer (storm window 20 ms) in front of r0 = ``srv``
    and r1 = ``dec_srv``: affinity in fleet_routing_bench's shape, the
    draining skip, a migration re-route and, on a second RouterServer,
    the two-phase route. Returns (the numbers, the affinity router's
    server, its router, the second server)."""
    import threading

    from kubeinfer_tpu_torch.router import FleetRouter, RouterServer

    cfg, bs = cont.cfg, cont.block_size
    V = cfg.vocab_size
    ports = {"r0": srv.port, "r1": dec_srv.port}
    router = FleetRouter(device=dev)
    for name, port in ports.items():
        router.add_replica(name, f"http://127.0.0.1:{port}")
    rs = RouterServer(router, port=0, storm_window_s=0.02).start(poll=False)
    router2 = FleetRouter(device=dev)
    router2.add_replica("d", f"http://127.0.0.1:{dec_srv.port}")
    router2.add_prefill_replica("p", f"http://127.0.0.1:{srv.port}")
    rs2 = RouterServer(router2, port=0, prefill_threshold=256).start(
        poll=False)
    out, marks, t_mark = {}, {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    # affinity: 4 families of 256-token prefixes planted 2 a replica by
    # direct posts, then 12 shuffled requests in two concurrent waves
    rng = np.random.default_rng(17)
    prefixes = [rng.integers(1, V, 256).tolist() for _ in range(4)]
    home = {f: f"r{f % 2}" for f in range(4)}
    for f, p in enumerate(prefixes):
        post_json(ports[home[f]], dict(prompt=p, max_tokens=4))
    check(rs.poll_once() == 2, "(34b) a replica did not answer the poll")
    order = [f for f in range(4) for _ in range(3)]
    rng.shuffle(order)
    bodies = [dict(prompt=prefixes[f] + rng.integers(1, V, 8).tolist(),
                   max_tokens=4) for f in order]
    t0 = time.perf_counter()
    docs = in_threads(lambda b: post_json(rs.port, b), bodies[:6])
    docs += in_threads(lambda b: post_json(rs.port, b), bodies[6:])
    out["affinity_s"] = time.perf_counter() - t0
    mark("plant and route")
    got = [(d["kubeinfer"]["replica"], d["kubeinfer"]["match_blocks"])
           for d in docs]
    want = [(home[f], 256 // bs) for f in order]
    check(got == want, f"(34b) replica and match_blocks {got}, planted "
          f"{want}")
    check(router.affinity_hit_rate == 1.0,
          f"(34b) affinity hit rate {router.affinity_hit_rate}")
    storm = router.metrics["solver_routed"].value("parity")
    check(storm == len(bodies), f"(34b) {storm} of {len(bodies)} first "
          "placements took the storm solve")
    direct = [post_json(ports[r], b)["choices"][0]["tokens"]
              for (r, _), b in zip(got, bodies)]
    check([d["choices"][0]["tokens"] for d in docs] == direct,
          "(34b) a routed completion differs from a direct post of its "
          "body to the chosen replica")
    out["ttft_ms"] = [d["kubeinfer"]["ttft_ms"] for d in docs]
    mark("direct posts")

    # the draining skip: r1 drained and polled, 4 of its families' requests
    dec.drain()
    check(rs.poll_once() == 2, "(34b) a replica did not answer the poll")
    skip0 = router.metrics["skipped"].value("r1", "draining")
    drain_ms, to = [], []
    r1_fams = [f for f in range(4) if home[f] == "r1"]
    for n in range(4):
        body = dict(prompt=prefixes[r1_fams[n % 2]]
                    + rng.integers(1, V, 8).tolist(), max_tokens=4)
        t0 = time.perf_counter()
        to.append(post_json(rs.port, body)["kubeinfer"]["replica"])
        drain_ms.append((time.perf_counter() - t0) * 1e3)
    skips = router.metrics["skipped"].value("r1", "draining") - skip0
    dec.undrain()
    check(rs.poll_once() == 2, "(34b) a replica did not answer the poll")
    check(to == ["r0"] * 4 and skips == 4, f"(34b) during r1's drain the "
          f"requests went to {to}, skipped{{r1, draining}} grew by {skips}")
    out["draining_ms"] = drain_ms
    mark("draining skip")

    # migration re-route: the session lands on r0 (both idle, no match:
    # the lower name), r0 drains mid-stream, the router resumes it on r1
    mig = dict(prompt=rng.integers(1, V, 600).tolist(),
               max_tokens=FLEET_MIGRATE_NEW)
    res, imp0, res0 = {}, dec.imports_total, \
        router.metrics["migration_resumes"].value("r1")
    th = threading.Thread(target=lambda: res.update(
        doc=post_json(rs.port, mig)), daemon=True)
    t0 = time.perf_counter()
    th.start()
    wait_until(lambda: any(r is not None and len(r.out_tokens) >= 16
                           for r in cont._slot_req),
               "the routed session decoding on r0")
    status, report, _ = post_path(srv.port, "/admin/drain", {},
                                  token=OBSERVE_TOKEN)
    th.join(300)
    out["migrate_s"] = time.perf_counter() - t0
    status2, _, _ = post_path(srv.port, "/admin/drain", {"resume": True},
                              token=OBSERVE_TOKEN)
    check(status == 200 and status2 == 200 and report.get("migrated") == 1,
          f"(34b) the drain of r0 answered {status} {report}")
    doc = res.get("doc") or {}
    ext = doc.get("kubeinfer", {})
    full = doc["choices"][0]["tokens"]
    check(ext.get("replica") == "r1" and ext.get("resume_hops") == 1
          and doc["choices"][0]["finish_reason"] == "length"
          and len(full) == FLEET_MIGRATE_NEW
          and dec.imports_total > imp0
          and router.metrics["migration_resumes"].value("r1") == res0 + 1,
          f"(34b) the re-routed session: {ext}, "
          f"{doc['choices'][0]['finish_reason']}, {len(full)} tokens")
    mark("migration")
    ref = post_json(dec_srv.port, mig)["choices"][0]["tokens"]
    mark("undrained run")
    out["migrate_divergences"] = held_pairs(
        "(34b) the re-routed session against an undrained run:", [full],
        [ref], [(mig["prompt"], {})], cont.params, cfg, dev)
    mark("near-tie")

    # the two-phase route: 600 tokens, prefill on srv, decode on dec
    check(rs2.poll_once() == 2, "(34b) a replica did not answer the poll")
    two = dict(prompt=rng.integers(1, V, 600).tolist(), max_tokens=16)
    imp0 = dec.imports_total
    t0 = time.perf_counter()
    doc = post_json(rs2.port, two)
    out["two_phase_ms"] = (time.perf_counter() - t0) * 1e3
    check(doc["kubeinfer"]["replica"] == "d"
          and dec.imports_total - imp0 == 1
          and router2.metrics["prefill_routed"].value("p") == 1
          and not router2.metrics["disagg_fallbacks"].value(
              "prefill_unreachable"),
          f"(34b) two-phase: {doc['kubeinfer']}, imports "
          f"{dec.imports_total - imp0}")
    # held as (30a) holds an imported stream: bitwise a warm admit's over
    # the same pages (the prefill replica's own, which it exported)
    warm = post_json(srv.port, two)["choices"][0]["tokens"]
    check(doc["choices"][0]["tokens"] == warm, "(34b) the two-phase stream "
          "differs from a warm admit's on the prefill replica")
    out["two_phase_ttft_ms"] = doc["kubeinfer"]["ttft_ms"]
    mark("two-phase")
    out["split_s"] = marks
    return out, rs, router, rs2


def fleet_plane(rs, cont, dec, V):
    """(34c): a Poisson schedule (seed 29, 12 requests at 2 req/s,
    fleet_envelope_bench's length families) replayed open-loop through
    the affinity router's ``forward``, a FleetView on both replicas'
    profiler and flight rings, the ledgers over tracing.RECORDER."""
    from kubeinfer_tpu_torch.observability import fleetview, loadgen, tracing

    sched = loadgen.make_schedule("poisson", rate=2.0, n_requests=12,
                                  seed=29, long_frac=0.1, long_new=16,
                                  short_new=4)
    fv = fleetview.FleetView()
    fv.register("r0", cont)
    fv.register("r1", dec)
    drains = [fv.drain()]  # the rings' history before the replay

    def post(body):
        code, payload = rs.forward(json.dumps(body).encode())
        if code != 200:
            raise RuntimeError(f"HTTP {code}: {payload[:200]!r}")
        return json.loads(payload)

    def on_dispatch():
        # the views age out (dead past 30 s) without the poller thread:
        # refresh them on every arrival, as fleet_envelope_bench does
        rs.poll_once()
        drains.append(fv.drain())

    check(rs.poll_once() == 2, "(34c) a replica did not answer the poll")
    tracing.RECORDER.clear()
    res = loadgen.replay(sched, post, V, max_workers=16,
                         on_dispatch=on_dispatch)
    drains.append(fv.drain())
    check(fv.drain() == {"r0": (0, 0), "r1": (0, 0)},
          "(34c) a drain after the last found records again")
    for name in ("r0", "r1"):
        for what, recs, col in (("steps", fv.steps(name), 0),
                                ("flights", fv.flights(name), 1)):
            seqs = [r.seq for r in recs]
            check(seqs == list(range(seqs[0], seqs[0] + len(seqs)))
                  and sum(d[name][col] for d in drains) == len(seqs),
                  f"(34c) {name}'s {what} not drained exactly once")
    check(res.errors() == 0 and len(res.completed()) == 12,
          f"(34c) {res.errors()} errors, {len(res.completed())} completed: "
          f"{sorted({r.error for r in res.records if not r.ok})}")
    ledgers = fleetview.build_ledgers(tracing.RECORDER.snapshot())
    check(len(ledgers) == 12 and {led.trace_id for led in ledgers}
          == {r.trace_id for r in res.records},
          f"(34c) {len(ledgers)} ledgers for 12 requests")
    worst = max(abs(sum(led.phase_s.values()) + led.other_s - led.e2e_s)
                * 1e3 for led in ledgers)
    check(worst <= 1e-6, f"(34c) a ledger's phases sum {worst} ms off its "
          "end to end")
    tail = fleetview.tail_attribution(ledgers)
    check(bool(tail["by_phase"]) and bool(tail["by_replica"]),
          f"(34c) tail attribution {tail}")
    point = fleetview.envelope_point(sched.offered_req_per_s(), res)
    return {"ttft_ms_p50": res.ttft_ms_percentile(50.0),
            "ttft_ms_p99": res.ttft_ms_percentile(99.0),
            "ledgers": len(ledgers), "worst_sum_ms": worst, "tail": tail,
            "envelope_point": point.to_dict(),
            "steps": {n: len(fv.steps(n)) for n in ("r0", "r1")},
            "flights": {n: len(fv.flights(n)) for n in ("r0", "r1")},
            "checksum": sched.checksum(), "late": res.late_dispatches}


def fleet_on_cut(dev, record, card, srv, cont):
    """(34) on ``cut_server``'s replica of ``srv`` over the first
    SPEC_INT8_LAYERS layers of ``cont``'s parameter tensors (r0) and a
    decode replica beside it (r1): its checked #11 paces it, so the depth
    is cut, as (30b) and (31c)'s. Returns ``fleet_phase``'s launches."""
    csrv, ccont = cut_server(dev, srv, cont, SPEC_INT8_LAYERS)
    try:
        dec_srv, dec = decode_replica(dev, csrv, ccont)
        try:
            return fleet_phase(dev, record, card, csrv, ccont, dec_srv, dec)
        finally:
            dec_srv.stop()
            dec.stop()
    finally:
        csrv.stop()
        ccont.stop()


def fleet_phase(dev, record, card, srv, cont, dec_srv, dec):
    """Phase (34): the fleet router and the fleet plane on two bf16
    replicas (r0, r1; ``fleet_on_cut``: (13)'s weights at SPEC_INT8_LAYERS
    layers), inside ``disagg_phase``'s ``then`` after (31b): (34a) ``fleet_storm``, (34b) ``fleet_http``,
    (34c) ``fleet_plane``. Every ``kernels.route_pick`` call goes through
    ``CheckedPick`` (bitwise against ``route_pick_plain``), every #11 call
    through ``attention_check``; both counts must be above 0. Leaves
    ``srv`` undrained. Returns the launch counts."""
    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.solver import kernels

    t_phase = time.perf_counter()
    marks, t_mark = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    chk = CheckedPick(kernels)
    chk11 = attention_check(fa, False)
    orig = kernels.route_pick
    kernels.route_pick = chk
    rs = rs2 = None
    try:
        with chk11:
            try:
                storm = fleet_storm(dev, chk)
                mark("(34a)")
                http, rs, router, rs2 = fleet_http(dev, srv, cont, dec_srv,
                                                   dec)
                mark("(34b)")
                plane = fleet_plane(rs, cont, dec, cont.cfg.vocab_size)
                mark("(34c)")
            finally:
                check(chk11.error is None, str(chk11.error))
    finally:
        kernels.route_pick = orig
        for server in (rs, rs2):
            if server is not None:
                server.stop()
    launches = {"route_pick": chk.launches,
                "decode_attention_blocks": chk11.launches}
    check(chk.launches > 0 and chk11.launches > 0
          and chk11.launches == chk11.calls,
          f"(34) launches {launches}, #11 calls {chk11.calls}")
    walk = chk11.walk_check("(34)")[0]
    p50 = statistics.median
    print(f"(34b) {card}: over HTTP in front of r0 and r1 ((13)'s weights "
          f"at {cont.cfg.num_hidden_layers} layers), storm window 20 ms: 12 "
          f"affinity "
          f"requests (4 families of 256 + 8 tokens, 2 waves of 6) all on "
          f"their family's replica with 2 blocks matched, hit rate 1.0, "
          f"all 12 through the storm solve, tokens equal to direct posts "
          f"(TTFT p50 {p50(http['ttft_ms']):.2f} ms); during r1's drain 4 "
          f"requests skipped it for r0, {rounded(http['draining_ms'])} ms "
          f"each; a {FLEET_MIGRATE_NEW}-token session drained on r0 "
          f"mid-stream and finished on r1 ({http['migrate_s']:.2f} s, "
          f"divergences from an undrained run "
          f"{http['migrate_divergences']}); a 600-token two-phase request "
          f"{http['two_phase_ms']:.1f} ms (TTFT {http['two_phase_ttft_ms']:.2f}"
          f" ms), one import, its stream bitwise a warm admit's")
    print(f"(34c) {card}: 12 Poisson requests at 2 req/s (seed 29) replayed "
          f"open-loop through the router: TTFT p50 "
          f"{plane['ttft_ms_p50']:.2f} ms, p99 {plane['ttft_ms_p99']:.2f} ms; "
          f"{plane['ledgers']} ledgers, phases + residual within "
          f"{plane['worst_sum_ms']:.2e} ms of end to end; tail "
          f"{plane['tail']['by_phase']} on {plane['tail']['by_replica']}; "
          f"drained exactly once (steps {plane['steps']}, flight events "
          f"{plane['flights']}); envelope point {plane['envelope_point']}")
    print(f"(34) route_pick: {chk.calls} calls bitwise equal to "
          f"route_pick_plain; #11: {chk11.calls} calls within tolerance, "
          f"max |kernel - plain| {chk11.max_err:.3e}, live splits {walk}; "
          f"launches {launches}")
    record["fleet"] = {"storm": storm, "http": http, "plane": plane,
                       "launches": launches, "pick_calls": chk.calls,
                       "max_err_11": chk11.max_err, "split_walk": walk,
                       "split_s": marks}
    record.setdefault("phase_s", {})["(34)"] = time.perf_counter() - t_phase
    print(f"(34) seconds: {rounded(list(marks.values()))} "
          f"({', '.join(marks)}); (34b) "
          f"{rounded(list(http['split_s'].values()))} "
          f"({', '.join(http['split_s'])})")
    return launches


# phase (32): /metrics and the debug endpoints on the instrumented servers
OBSERVE_NEW = 33  # new tokens of each (32) request: windows of 4 and 8


def readback_site():
    """``batching.py:<line>`` of the decode window's one readback in
    ``ContinuousEngine._loop`` (where the sync debug mode reports it)."""
    import inspect

    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine

    lines, start = inspect.getsourcelines(ContinuousEngine._loop)
    hits = [start + i for i, ln in enumerate(lines)
            if "tokens.cpu()" in ln]
    check(len(hits) == 1, f"the decode window's readback lines {hits}")
    return f"batching.py:{hits[0]}"


def observe_phase(dev, record, card, srv, cont):
    """Phase (32a) on the bf16 server of (13) after (31b), or (32b) on the
    int8 server of (17) after (31c), both built with ``observe_flags()``:
    ``GET /metrics`` parses and carries every family of the serving
    collectors; its counters equal the engine's own (parks, readmits,
    chunks, migrations and their chunks, prefix hits, misses and
    evictions, quantized blocks, the verify counters; the flight ring's
    events where it kept them all). Then a burst (5 requests of 512
    tokens, one sampled; two shed at the door, a limit of 1 set while
    the scheduler is held; an invalid body; 4100 tokens on the engine
    route; a prefill-only export fetched twice) with #11 (#12) held
    against its plain version on every call and #15's launches counted
    (held on this server's calls in [17]-(31c)): the scrape's deltas
    equal the answers' routes and outcomes, tokens and sheds, the
    export's blocks and bytes; the step histogram counts each new
    profiler record once, and the decode records' steps x layers equal
    #11's (#12's) launches; every histogram sample only grows;
    ``/debug/flightrecorder?since=`` polled through the burst replays
    each event once; ``/debug/spans`` is a Chrome trace with the
    request's spans and the engine-counters process; ``/debug/slo`` and
    ``stats_summary()`` are sane; ``/debug/*`` answer 401 without the
    token; ``/cache/summary`` answers. One request under the sync debug
    mode: one host sync a decode window, none in the instrumentation.
    Unchecked: a scrape's ms, the host us of ``profiler.record`` and a
    flight note, the instrumented decode ms/token of [16] ([20]).
    Returns the burst's launch counts."""
    import threading
    import urllib.request

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.metrics.registry import Registry
    from kubeinfer_tpu_torch.observability.flightrecorder import (
        FlightRecorder,
    )
    from kubeinfer_tpu_torch.observability.stepprof import StepProfiler

    t_phase = time.perf_counter()
    int8 = cont.kv_dtype == "int8"
    label = "[32b]" if int8 else "[32a]"
    cfg, port, tok = cont.cfg, srv.port, OBSERVE_TOKEN
    V, layers = cfg.vocab_size, cfg.num_hidden_layers
    rng = np.random.default_rng(32 + int8)
    wait_until(lambda: not any(r is not None for r in cont._slot_req)
               and cont._queue.empty(), f"{label} an idle engine")

    def scrape():
        st, text, ms = get_text(port, "/metrics")
        check(st == 200, f"{label} GET /metrics answered {st}")
        return text, ms

    # every family (tests/test_torch_observability.py holds the port's
    # names, labels and buckets to the reference's on the CPU)
    families = sorted(c.name for c in
                      server._serving_metrics(Registry()).values())
    text_a, scrape_ms = scrape()
    missing = [f for f in families if f"# TYPE {f} " not in text_a]
    check(not missing, f"{label} /metrics lacks {missing}")
    a = metric_samples(text_a)
    seq_a = srv._prof_seq
    sched, kv = cont.scheduler_stats(), cont.kv_cache_stats()
    engine_counts = {
        "kubeinfer_preemptions_total": sched["preempted"],
        "kubeinfer_preemption_resumes_total": sched["resumed"],
        "kubeinfer_prefill_chunks_total": sched["chunks"],
        "kubeinfer_migrations_total": sched["migrated"],
        "kubeinfer_migration_chunks_total": sched["migration_chunks"],
        "kubeinfer_spec_draft_tokens_total": sched["spec_draft_tokens"],
        "kubeinfer_spec_accepted_tokens_total":
            sched["spec_accepted_tokens"],
        "kubeinfer_spec_rollbacks_total": sched["spec_rollbacks"],
        "kubeinfer_prefix_cache_hits_total": kv["hits"],
        "kubeinfer_prefix_cache_misses_total": kv["misses"],
        "kubeinfer_prefix_cache_evictions_total": kv["evictions"],
        "kubeinfer_kv_quant_blocks_total": kv["quant_blocks"],
        "kubeinfer_kv_blocks_in_use": kv["blocks_in_use"],
        "kubeinfer_kv_blocks_free": kv["blocks_free"],
        "kubeinfer_parked_requests": sched["parked"],
        "kubeinfer_engine_draining_state": 0,
    }
    off = {k: (a.get(k), v) for k, v in engine_counts.items()
           if a.get(k) != v}
    check(not off, f"{label} scrape against the engine (scraped, engine): "
          f"{off}")
    ring = cont.flight.to_dict()
    kinds = collections.Counter(e["kind"] for e in ring["events"])
    whole_ring = ring["recorded"] == len(ring["events"])
    if whole_ring:
        ring_counts = {"preempt": sched["preempted"],
                       "resume": sched["resumed"],
                       "chunk": sched["chunks"],
                       "migrate": sched["migrated"],
                       "migrate_chunk": sched["migration_chunks"],
                       "import": sched["kv_imports"]}
        off = {k: (kinds[k], v) for k, v in ring_counts.items()
               if kinds[k] != v}
        check(not off, f"{label} flight events against the engine: {off}")

    # the burst, every #11 (#12) call checked and counted; #15, held on
    # this server's calls in [17] and [18] and on its cut's in (30b) and
    # (31c), is counted here
    chk = attention_check(fa, int8)
    qmm0 = (wq.quant_matmul.launches, wq.quant_matmul.tc_launches)
    answers = []  # (status, body) of every completion
    cursor = [ring["recorded"] - 1]
    cursor0 = cursor[0]
    polled: list = []
    done = threading.Event()

    def poll():
        while True:
            last = done.is_set()
            st, body, _ = get_text(
                port, f"/debug/flightrecorder?since={cursor[0]}", tok)
            check(st == 200, f"{label} flightrecorder poll answered {st}")
            evs = json.loads(body)["events"]
            polled.extend(e["seq"] for e in evs)
            if evs:
                cursor[0] = evs[-1]["seq"]
            if last:
                return
            done.wait(0.02)

    def send(body):
        st, doc, _ = post_path(port, "/v1/completions", body)
        answers.append((st, doc))
        return st, doc

    poller = threading.Thread(target=poll, daemon=True)
    bodies = [dict(prompt=rng.integers(1, V, 512).tolist(),
                   max_tokens=OBSERVE_NEW) for _ in range(4)]
    bodies.append(dict(prompt=rng.integers(1, V, 512).tolist(),
                       max_tokens=OBSERVE_NEW, temperature=0.8, top_k=50,
                       seed=5))
    export_prompt = rng.integers(1, V, 512).tolist()
    short = [dict(prompt=rng.integers(1, V, 64).tolist(), max_tokens=4)
             for _ in range(4)]
    with torch.inference_mode(), chk:
        try:
            poller.start()
            in_threads(send, bodies)
            # two shed at the door: with the scheduler held on its lock,
            # two requests are submitted (an idle scheduler takes at most
            # one off the queue before it blocks), then, with a limit of
            # 1 and one still queued, the next two are refused
            with cont._lock:
                seq0 = cont.flight.to_dict()["recorded"] - 1
                held = [threading.Thread(target=send, args=(b,))
                        for b in short[:2]]
                for th in held:
                    th.start()
                # both submitted (each notes "submit" past the shed check,
                # before its queue put), one of them still queued
                wait_until(lambda: sum(
                    e.kind == "submit"
                    for e in cont.flight.snapshot(since_seq=seq0)) == 2
                    and cont._queue.qsize() >= 1,
                    f"{label} two submitted requests, one queued")
                cont.queue_depth_limit = 1
                try:
                    shed = [send(b)[0] for b in short[2:]]
                finally:
                    cont.queue_depth_limit = 0
            for th in held:
                th.join(900)
            send(dict(prompt=[1, 2, 3], max_tokens=2, top_p=0.0))
            send(dict(prompt=rng.integers(1, V, 4100).tolist(),
                      max_tokens=4))
            st, doc = send(dict(prompt=export_prompt, max_tokens=0))
            ext = doc["kubeinfer"]["kv_export"]
            blobs = []
            for _ in range(2):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/kv/blocks?fp="
                        f"{ext['fingerprint']}", timeout=60) as r:
                    blobs.append(len(r.read()))
        finally:
            done.set()
            poller.join(60)
            check(chk.error is None, str(chk.error))
    qmm = (wq.quant_matmul.launches - qmm0[0],
           wq.quant_matmul.tc_launches - qmm0[1])
    check(shed == [503, 503], f"{label} the held scheduler's sheds {shed}")
    text_b, _ = scrape()
    b = metric_samples(text_b)
    seq_b = srv._prof_seq
    recs = cont.profiler.snapshot(since_seq=seq_a)

    def delta(name):
        return b.get(name, 0.0) - a.get(name, 0.0)

    tally = collections.Counter()
    tokens = [0, 0]
    for st, doc in answers:
        if st == 200:
            tally[(doc["kubeinfer"]["route"], "ok")] += 1
            tokens[0] += doc["usage"]["prompt_tokens"]
            tokens[1] += doc["usage"]["completion_tokens"]
        elif st == 503:
            tally[("continuous",
                   "shed" if doc["error"]["type"] == "overloaded"
                   else "draining")] += 1
        else:
            tally[("invalid", "invalid")] += 1
    req_fam = "kubeinfer_inference_requests_total"
    got = {k: delta(f'{req_fam}{{route="{k[0]}",outcome="{k[1]}"}}')
           for k in tally}
    check(got == dict(tally) and tally[("engine", "ok")] == 1
          and tally[("prefill", "ok")] == 1
          and tally[("continuous", "ok")] == 7,
          f"{label} requests by route and outcome: scraped {got}, answered "
          f"{dict(tally)}")
    shed_d = delta('kubeinfer_requests_shed_total{reason="queue_depth_limit"}')
    tok_d = (delta("kubeinfer_inference_prompt_tokens_total"),
             delta("kubeinfer_inference_completion_tokens_total"))
    exp_d = (delta('kubeinfer_kv_stream_blocks_total{direction="export"}'),
             delta('kubeinfer_kv_stream_bytes_total{direction="export"}'))
    check(shed_d == 2 and tok_d == tuple(tokens)
          and exp_d == (2 * ext["blocks"], sum(blobs))
          and blobs == [ext["bytes"]] * 2,
          f"{label} sheds {shed_d}, tokens {tok_d} against {tokens}, "
          f"export {exp_d} against {ext} fetched {blobs}")
    steps_hist = "kubeinfer_engine_step_duration_seconds_count"
    hist_d = sum(v - a.get(k, 0.0) for k, v in b.items()
                 if k.startswith(steps_hist))
    compiles_d = delta("kubeinfer_engine_compiles_total")
    decode_steps = sum(r.steps for r in recs if r.phase == "decode")
    check(hist_d == seq_b - seq_a == len(recs)
          and compiles_d == sum(r.compiled for r in recs)
          and chk.launches == chk.calls == layers * decode_steps > 0,
          f"{label} step records: histogram +{hist_d}, profiler "
          f"{seq_a}->{seq_b} ({len(recs)} records, {decode_steps} decode "
          f"steps); {chk.name} {chk.launches} launches, {chk.calls} calls")
    walk = chk.walk_check(label)[0]
    shrunk = {k: (v, b.get(k)) for k, v in a.items()
              if ("_bucket" in k or "_count" in k or "_sum" in k)
              and b.get(k, -1.0) < v}
    check(not shrunk, f"{label} histogram samples shrank: {shrunk}")
    flight_seqs = [e.seq for e in cont.flight.snapshot(since_seq=cursor0)]
    check(polled == flight_seqs == list(range(cursor0 + 1, cursor0 + 1
                                              + len(polled))),
          f"{label} /debug/flightrecorder?since= replayed {len(polled)} "
          f"events ({len(set(polled))} distinct) of {len(flight_seqs)}")
    polled_kinds = collections.Counter(
        e.kind for e in cont.flight.snapshot(since_seq=cursor0))
    check(polled_kinds["fail"] == 2 and polled_kinds["backpressure"] == 2
          and polled_kinds["submit"] == len(answers) - 2,
          f"{label} flight kinds of the burst {dict(polled_kinds)}")
    launches = {chk.name: chk.launches}
    if cont.weight_dtype == "int8":
        check(qmm[0] == qmm[1] > 0 and qmm[0] % (7 * layers) == 0,
              f"{label} quant_matmul {qmm[0]} launches, {qmm[1]} on the "
              "tensor-core route")
        launches["quant_matmul"] = qmm[0]

    # the debug surface
    st, body, _ = get_text(port, "/debug/spans", tok)
    doc = json.loads(body) if st == 200 else {}
    names = {e.get("name") for e in doc.get("traceEvents", [])}
    procs = {e["args"].get("name") for e in doc.get("traceEvents", [])
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    want = {"server.complete", "engine.prefill", "engine.decode",
            "engine.queue_wait", "engine.generate"}
    check(st == 200 and want <= names and "engine-counters" in procs
          and {"batch_occupancy", "queue_depth"} <= names,
          f"{label} /debug/spans {st}: spans {sorted(names)[:20]}, "
          f"processes {procs}")
    st, body, _ = get_text(port, "/debug/slo", tok)
    slo = json.loads(body) if st == 200 else {}
    ttft = slo.get("objectives", {}).get("ttft", {})
    check(st == 200 and list(slo["objectives"]) == ["ttft"]
          and ttft["threshold_s"] == 2.0 and ttft["objective"] == 0.99
          and all(w["total"] > 0 and w["burn_rate"] >= 0
                  for w in ttft["windows"].values()),
          f"{label} /debug/slo {st} {slo}")
    summ = cont.stats_summary()
    check(summ["n_slots"] == 8 and summ["block_size"] == 128
          and (summ["tp_degree"], summ["mesh_devices"]) == (1, 1)
          and summ["kv_blocks_free"] + summ["kv_blocks_in_use"]
          == cont._pool.num_blocks - 1
          and 0 <= summ["batch_occupancy"] <= 1
          and summ["goodput_tokens_per_sec"] > 0
          and 0 <= summ["prefix_hit_rate"] <= 1
          and summ["kv_dtype"] == cont.kv_dtype and not summ["draining"]
          and summ["cache_summary"]["fingerprints"],
          f"{label} stats_summary {dict(summ, cache_summary='...')}")
    unauth = {path: get_text(port, path)[0] for path in
              ("/debug/spans", "/debug/slo", "/debug/flightrecorder")}
    unauth["/debug/slo (wrong token)"] = get_text(port, "/debug/slo",
                                                  "x" + tok)[0]
    check(set(unauth.values()) == {401}, f"{label} without the token {unauth}")
    st, body, _ = get_text(port, "/cache/summary")
    check(st == 200 and json.loads(body)["serving"]["n_slots"] == 8,
          f"{label} /cache/summary {st}")

    # one host sync a decode window, with the instrumentation on
    site = readback_site()
    seq0 = cont.profiler.snapshot()[-1].seq
    with sync_capture() as caught:
        cont.serve(rng.integers(1, V, 512).tolist(), OBSERVE_NEW,
                   timeout=900)
    windows = sum(1 for r in cont.profiler.snapshot(since_seq=seq0)
                  if r.phase == "decode")
    sites = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)
        and "prototype" not in str(w.message))
    instr = {s: n for s, n in sites.items() if s.split(":")[0] in (
        "stepprof.py", "flightrecorder.py", "tracing.py", "server.py")}
    check(sites[site] == windows > 0 and not instr,
          f"{label} host syncs over one request: {dict(sites)} for "
          f"{windows} decode windows (the readback at {site})")

    # unchecked: what the instrumentation costs the host a window
    prof = StepProfiler(n_slots=cont.n_slots, kv_stats=lambda: (
        cont._pool.used_blocks, cont._pool.free_blocks))
    fr = FlightRecorder(capacity=4096)
    record_us = host_us(lambda: prof.record(
        "decode", bucket=4, live_rows=8, live_tokens=32, padded_tokens=0,
        start=0.0, end=1.0, steps=4), reps=2000)
    note_us = host_us(lambda: fr.note(
        "retire", queue_depth=cont._queue.qsize(),
        kv_in_use=cont._pool.used_blocks, kv_free=cont._pool.free_blocks,
        req=1, slot=0, tokens=OBSERVE_NEW, freed_blocks=5,
        cancelled=False), reps=2000)
    times = record.get("int8_times" if int8 else "serving_times", {})
    decode_ms = times.get("decode_ms_per_token")
    print(f"{label} {card}: GET /metrics ({len(families)} families, "
          f"{len(a)} samples) served and parsed, the engine's counters "
          f"equal ({'the flight ring whole, ' if whole_ring else ''}"
          f"{ring['recorded']} events so far); a burst of {len(answers)} "
          f"completions {dict(tally)}: every delta equal, {len(recs)} step "
          f"records folded once ({decode_steps} decode steps x {layers} = "
          f"{chk.name}'s {chk.launches} launches, within tolerance of its "
          f"plain version, max |kernel - plain| {chk.max_err:.3e}, live "
          f"splits {walk}"
          + (f"; quant_matmul {qmm[0]} launches, all on the tensor-core "
             "route" if cont.weight_dtype == "int8" else "")
          + f"); {len(polled)} flight events replayed once by ?since=; "
          f"/debug/spans, /debug/slo, stats_summary sane; 401 without the "
          f"token {unauth}; host syncs over one request {dict(sites)} for "
          f"{windows} decode windows")
    print(f"{label} {card}, unchecked: a scrape {scrape_ms:.2f} ms; "
          f"profiler.record {record_us:.2f} us + a flight note "
          f"{note_us:.2f} us = {record_us + note_us:.2f} us the "
          f"instrumentation adds to a decode window (predicted under 30); "
          f"{'[20]' if int8 else '[16]'} decode on the instrumented server "
          + (f"{decode_ms:.3f} ms per token per slot"
             if decode_ms is not None else "not run"))
    record["observe_" + cont.kv_dtype] = {
        "families": len(families), "scrape_ms": scrape_ms,
        "record_us": record_us, "note_us": note_us,
        "answers": {f"{r}/{o}": n for (r, o), n in tally.items()},
        "step_records": len(recs), "decode_steps": decode_steps,
        "launches": launches, "max_err": chk.max_err, "split_walk": walk,
        "flight_replayed": len(polled), "window_syncs": dict(sites),
        "decode_windows": windows, "decode_ms_per_token": decode_ms,
    }
    record.setdefault("phase_s", {})[label] = time.perf_counter() - t_phase
    return launches


def rounded(xs):
    return [round(x, 3) for x in xs]


def time_kernel(dev, fa, chk, card, launches, F, tc_launches):
    """#9's entry of the ``kernels`` line: its time per launch on the
    heaviest captured call, its plain version's, the
    scaled_dot_product_attention yardstick's on the same q/k/v, its bound
    from this call's data and (``tc_launches``: its tensor-core launches
    on the path) the CUDA-core kernel's time on the same call."""
    import torch

    name = "flash_attention_ragged"
    args = chk.heaviest
    q, k, v, off, lens = args
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    elt = q.element_size()
    kernel = getattr(fa, name)
    ms = cuda_ms(lambda: kernel(*args), reps=20)
    plain_ms = cuda_ms(lambda: chk.plain(*args), reps=3)
    t = torch.arange(T, device=dev)
    s = torch.arange(S, device=dev)
    keys = torch.where(lens[:, None] == 0, S, torch.minimum(
        off + t[None, :] + 1, lens[:, None].long()).clamp(max=S))
    ops = 4 * D * H * int(keys.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
    mask = ((s[None, None, None, :] <= off + t[None, None, :, None])
            & (s[None, None, None, :] < lens[:, None, None, None]))
    what = (f"q [{B}, {T}, {H}, {D}] at offset {off}, keys [{B}, {S}], "
            f"row_len {int(lens[0])}")
    qs, ks_, vs_ = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks_, vs_, attn_mask=mask, enable_gqa=True), reps=10)
    op_ms = ops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    bound_by = "operations" if op_ms >= byte_ms else "bytes"
    core_ms = cuda_core_ms(name, args)
    what += (f", tensor cores (the CUDA-core kernel on this call "
             f"{core_ms:.4f} ms)")
    print(f"[16] {card}: {name} {ms:.4f} ms/launch on {what}; plain "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention {library_ms:.4f}"
          f" ms; bound {bound_ms:.5f} ms ({bound_by}: {ops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB); {launches} launches on the main path, "
          f"{tc_launches} on the tensor-core route")
    return {
        "cores": TC_CORES, "cuda_core_ms": core_ms,
        "tc_launches": tc_launches,
        "name": name,
        "route": "cuda",
        "source": TC_SOURCE,
        "replaces": "kubeinfer_tpu/inference/flash_attention.py:288",
        "launches": launches,
        "max_abs_err": chk.max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(enable_gqa, boolean mask) on the same q/k/v",
        "check": f"within tolerance of its plain version (bf16: 2**-6 of "
                 f"each live row's magnitude) on {chk.calls} calls of the "
                 "full-width path",
    }


# --- the split-K decode kernel (#10, #11, #12): times ---------------------------

SPLIT_SOURCE = "kubeinfer_tpu_torch/inference/csrc/decode_split.cu"
DECODE_REPLACES = {
    "decode_attention": "kubeinfer_tpu/inference/flash_attention.py:504",
    "decode_attention_blocks":
        "kubeinfer_tpu/inference/flash_attention.py:779",
    "decode_attention_blocks_q8":
        "kubeinfer_tpu/inference/flash_attention.py:1115",
}


def old_decode(fa, name):
    """The kernel #10, #11 or #12 ran before the split-K one
    (``decode_attention.cu``: one block per (row, kv head)) as a function
    of the wrapper's arguments, launched through its library outside the
    wrappers' counts. Only ``--tie-probe`` runs it."""
    import torch

    from kubeinfer_tpu_torch import _build

    lib = _build.load_kernel_library("decode_attention")

    def run(*args):
        q = args[0]
        B, T, H, D = q.shape
        out = torch.empty_like(q)
        dt = 0 if q.dtype == torch.float32 else 1
        scale = 1.0 / float(D) ** 0.5
        if name == "decode_attention":
            _, k, v, ln = args
            fa._launch(lib, "decode_attention_launch", q, k, v, ln, out, B,
                       H, k.shape[2], D, k.shape[1], scale, dt)
        elif name == "decode_attention_blocks_q8":
            _, kp, vp, ks, vs, kt, vt, tbl, ln = args
            fa._launch(lib, "decode_attention_blocks_q8_launch", q, kp, vp,
                       ks, vs, kt, vt, tbl, ln, out, B, T, H, kp.shape[2], D,
                       kp.shape[1], tbl.shape[1], scale, dt)
        else:
            _, kp, vp, tbl, ln = args
            fa._launch(lib, "decode_attention_blocks_launch", q, kp, vp, tbl,
                       ln, out, B, T, H, kp.shape[2], D, kp.shape[1],
                       tbl.shape[1], scale, dt)
        return out

    return run


class OldDecode:
    """Stands the old kernel (``old_decode``) in for the wrapper ``name``
    while the path runs, for a before/after on the same call."""

    def __init__(self, fa, name):
        self.fa, self.name = fa, name
        self.kernel = getattr(fa, name)

    def __enter__(self):
        setattr(self.fa, self.name, old_decode(self.fa, self.name))
        return self

    def __exit__(self, *exc):
        setattr(self.fa, self.name, self.kernel)


def device_ms(fn, reps=20):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events, so the host's
    per-call work is out of the time (a warm-up call first builds,
    allocates and sets what it needs outside the capture)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


# the first mega kernel (five grid barriers a round, the window read from
# L2) at 10k x 1k on an H100 80GB HBM3 at 700 W: PERF.md, the baseline of
# the redesign (scripts/torch_mega_stamps.py)
OLD_MEGA_MS = 1.7249


def grid_barrier_us(blocks, iters=1000):
    """us of one grid barrier of the mega kernel's kind on ``blocks``
    blocks of 512 threads (``mega_barrier_launch``: ``iters`` barriers and
    nothing else, by CUDA events; the best of three launches)."""
    import torch

    from kubeinfer_tpu_torch import _build

    lib = _build.load_kernel_library("mega_solve")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best = float("inf")
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.mega_barrier_launch(blocks, iters, out.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        check(err == 0, f"mega_barrier_launch: {lib.error_string(err)}")
        best = min(best, start.elapsed_time(end) * 1e3 / iters)
    return best


def host_us(fn, reps=200):
    """The host's us per call of ``fn``, the device left to run behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def engine_decode(params, cfg, caches, offset, dev, steps=16):
    """The engine route's decode loop on one row's dense caches: ``steps``
    step_forward calls from position ``offset`` (token 1 each step, the
    caches' positions from ``offset`` on rewritten). Returns (ms per
    token by CUDA events over the run, device busy ms per token under
    torch.profiler)."""
    import torch

    from kubeinfer_tpu_torch.inference.stepper import step_forward

    tok = torch.ones(1, dtype=torch.int64, device=dev)
    cache_len = caches[0][0].shape[1]

    def run():
        off = torch.full((1,), offset, dtype=torch.int32, device=dev)
        for _ in range(steps):
            step_forward(params, cfg, tok, off, caches, cache_len)
            off = off + 1

    ms = cuda_ms(run, reps=1) / steps
    _, busy, _ = device_profile(run)
    return ms, busy / steps


def decode_views(fa, name, args):
    """(K, V, live rows) of one decode call, K and V as linear caches [B,
    S, n_kv, D] in the compute dtype: the cache itself (#10), the pools
    gathered through the tables (#11), the int8 pool dequantize-gathered
    at the tail base max(len - T, 0) // bs (#12: on a live row, the
    tiles the kernel folds)."""
    import torch

    q, lens = args[0], args[-1]
    T = q.shape[1]
    if name == "decode_attention":
        return args[1], args[2], lens > 0
    tbl = args[-2]
    live = (tbl[:, 0] != 0) & (lens >= T)
    if name == "decode_attention_blocks":
        return (fa.gather_block_kv(args[1], tbl),
                fa.gather_block_kv(args[2], tbl), live)
    _, kp, vp, ks, vs, kt, vt, _, _ = args
    tb = torch.clamp(lens.long() - T, min=0) // kp.shape[1]
    return (fa.dequant_gather_block_kv(kp, ks, kt, tbl, tb),
            fa.dequant_gather_block_kv(vp, vs, vt, tbl, tb), live)


def f32_errors(fa, q, kk, vv, lens, live, outs):
    """Each route's distance from an f32 evaluation of the same call: the
    plain fold (``decode_split_combine_plain`` in one split) on q and the
    effective K/V upcast to f32 (for #12 the dequantized tiles as the
    function rounds them). Per route in ``outs``, over the live rows:
    the largest of each row's max |out - f32| and the mean of each row's
    mean |out - f32|, both over the row's largest |f32 value|."""
    B = q.shape[0]
    ref = fa.decode_split_combine_plain(q.float(), kk.float(), vv.float(),
                                        lens, kk.shape[1])
    mag = ref.abs().reshape(B, -1).amax(dim=1)[live]
    errs = {}
    for route, out in outs.items():
        e = (out.float() - ref).abs().reshape(B, -1)[live]
        errs[route] = {"max_rel": float((e.amax(dim=1) / mag).max()),
                       "mean_rel": float((e.mean(dim=1) / mag).mean())}
    return errs


def time_decode(dev, fa, chk, card, name, launches, F, tag="[16]"):
    """#10's, #11's or #12's entry of the ``kernels`` line, on the
    heaviest captured call: the split-K kernel's device time per launch
    (``ms``: a CUDA graph of 20 launches, replays timed by CUDA events;
    ``device_ms``), its wall per call (CUDA events over 20 back-to-back
    calls) and the wrapper's host us per call; the plain version's;
    scaled_dot_product_attention's device and wall time on the same q and
    K/V (``decode_views``, made beforehand); the bound from this call's
    live K/V (#12: int8 codes and scales of the committed pages, tail
    positions in q's dtype); each route's distance from an f32 evaluation
    (``f32_errors``)."""
    import torch

    args = chk.heaviest
    q, lens = args[0], args[-1]
    B, T, H, D = q.shape
    elt = q.element_size()
    kernel = getattr(fa, name)
    ms = device_ms(lambda: kernel(*args))
    wall_ms = cuda_ms(lambda: kernel(*args), reps=20)
    wrapper_us = host_us(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: chk.plain(*args), reps=3)
    kk, vv, live = decode_views(fa, name, args)
    S, n_kv = kk.shape[1], kk.shape[2]
    live_len = torch.where(live, lens.long(), 0)
    ops = 4 * D * H * T * int(live_len.sum())
    if name == "decode_attention_blocks_q8":
        bs = args[1].shape[1]
        tb = torch.clamp(live_len - T, min=0) // bs
        paged = torch.minimum(live_len, tb * bs)
        nbytes = (2 * n_kv * D * (int(paged.sum())
                                  + elt * int((live_len - paged).sum()))
                  + 2 * 4 * n_kv * int(tb.sum()) + 2 * q.numel() * elt)
    else:
        nbytes = (2 * n_kv * D * int(live_len.sum()) + 2 * q.numel()) * elt
    s = torch.arange(S, device=dev)
    t = torch.arange(T, device=dev)
    mask = s[None, None, None, :] <= (lens[:, None, None, None] - T
                                      + t[None, None, :, None])
    qs, ks_, vs_ = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=mask,
                                              enable_gqa=True)

    library_ms = device_ms(sdpa)
    library_wall_ms = cuda_ms(sdpa, reps=20)
    op_ms = ops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    bound_by = "operations" if op_ms >= byte_ms else "bytes"
    splits = int(split_walk(fa, name, args))
    errs = f32_errors(fa, q, kk, vv, lens, live, {
        "split_k": kernel(*args),
        "sdpa": sdpa().transpose(1, 2)})
    print(f"{tag} {card}: {name} (split-K, decode_split.cu) {ms:.4f} ms "
          f"device time a launch, {wall_ms:.4f} ms wall a call, wrapper "
          f"{wrapper_us:.1f} us of host a call, {splits} live splits, on q "
          f"[{B}, {T}, {H}, {D}], {int(live.sum())} live rows, lengths "
          f"{lens.tolist()}; plain "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention {library_ms:.4f}"
          f" ms device, {library_wall_ms:.4f} ms wall; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {ops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB); {launches} launches on the main path")
    print(f"{tag} {name} against an f32 evaluation of the call, |out - "
          f"f32| over each live row's largest |f32|, largest row max (mean "
          f"of row means): " + "; ".join(
              f"{route} {e['max_rel']:.3e} ({e['mean_rel']:.3e})"
              for route, e in errs.items()))
    return {
        "name": name,
        "route": "cuda",
        "source": SPLIT_SOURCE,
        "replaces": DECODE_REPLACES[name],
        "launches": launches,
        "max_abs_err": chk.max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "wall_ms": wall_ms,
        "host_us": wrapper_us,
        "library_wall_ms": library_wall_ms,
        "live_splits": splits,
        "f32_err": errs,
        "timing": "ms, library_ms: device time a launch (a CUDA "
                  "graph of 20 launches, replays timed by CUDA events); "
                  "*_wall_ms: CUDA events "
                  "over 20 back-to-back calls; host_us: the wrapper's host "
                  "time a call",
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(enable_gqa, boolean mask) on the same q/k/v"
                        + {"decode_attention": "",
                           "decode_attention_blocks":
                               ", K/V gathered through the table beforehand",
                           "decode_attention_blocks_q8":
                               ", K/V gathered through the table, "
                               "dequantized, tails overlaid beforehand"}[name],
        "check": f"within tolerance of its plain version (bf16: 2**-6 of "
                 f"each live row's magnitude) on {chk.calls} calls of the "
                 "full-width path; the kernel's own count of its live "
                 "splits equal to decode_split_walk's",
    }


# --- the int8 serving path: phases (17)-(20) ----------------------------------

QMM_REPLACES = "kubeinfer_tpu/inference/weight_quant.py:222"


def qmm_share(rows):
    """#15's device ms in a profile's rows: every kernel of
    ``quant_matmul.cu`` and ``quant_matmul_tc.cu`` (their names hold
    ``qmm_``)."""
    return sum(ms for name, ms, _ in rows if "qmm_" in name)


def launches_per_step(cont, cfg, commit_steps=None, k=4):
    """Device kernels, device-busy ms, wall ms and #15's device ms per
    decode step: one K-step window of the engine's slot state under
    torch.profiler (greedy gates; rows flow through the same math active
    or not)."""
    import torch

    from kubeinfer_tpu_torch.inference.stepper import RowFlags, decode_window

    flags = RowFlags(sampled=False, top_k=False, top_p=False, penalty=False)
    with torch.inference_mode():
        decode_window(cont.params, cont._state, cfg, k, flags, commit_steps)
        wall, busy, rows = device_profile(lambda: decode_window(
            cont.params, cont._state, cfg, k, flags, commit_steps))
    return (sum(c for _, _, c in rows) / k, busy / k, wall / k,
            qmm_share(rows) / k)


def matmul_err(got, want):
    """(largest |kernel - plain|, within tolerance) as two device
    scalars, with no host sync: f32 1e-5 and bf16 2**-6 (2 bf16 ulps) of
    each output row's largest |plain value|; a value that is not finite
    fails (its comparison is False)."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs().reshape(-1, g.shape[-1])
    mag = w.abs().reshape(-1, g.shape[-1]).amax(dim=1, keepdim=True)
    rel = 1e-5 if got.dtype == torch.float32 else BF16_REL
    return err.max(), (err <= rel * mag).all()


class CheckedMatmul:
    """A stand-in for ``weight_quant.quant_matmul`` that runs the kernel
    and its plain version on the same inputs, hands the kernel's result
    on, and holds every call within the stated tolerance when
    ``verify`` reads the calls' outcomes back (one host sync for all of
    them, so the served path is not paced by the check). Counts the
    calls by route (``qmm_route``: "tc" the tensor-core kernel, else
    "mma" or "f32" on ``quant_matmul.cu``) and keeps the call with the
    most operations for the times. While it stands in, the wrapper's
    ``launches += 1`` and ``tc_launches += 1`` resolve to this object's
    counts, off the wrapper's own. ``keep_f32`` keeps each weight's f32
    copy (about 4 bytes a weight, freed on exit) for the plain version's
    product, the same arithmetic as ``quant_matmul_plain`` without
    converting the weight on every call; the first call is held bitwise
    to ``quant_matmul_plain``."""

    def __init__(self, wq, keep_f32=False):
        self.wq = wq
        self.kernel, self.plain = wq.quant_matmul, wq.quant_matmul_plain
        self.w32 = {} if keep_f32 else None
        self.launches = self.tc_launches = self.calls = 0
        self.routes = collections.Counter()
        self.max_err = 0.0
        self.m_values = set()
        self.heaviest = None
        self.error = None
        self.pending = []  # (err, ok, x shape, qw shape) not yet read back
        # (35): {data_ptr of a tp rank's int8 codes: rank}; the calls are
        # then tallied by rank and by (M, K, N)
        self.ranks, self.per_rank = None, collections.Counter()
        self.shapes = collections.Counter()

    def __enter__(self):
        self.wq.quant_matmul = self
        return self

    def __exit__(self, *exc):
        self.wq.quant_matmul = self.kernel
        if self.w32 is not None:
            self.w32.clear()

    def plain_of(self, x, qw, scale):
        """The plain version's result, with the weight's f32 copy kept
        where ``keep_f32`` is set."""
        import torch

        if self.w32 is None:
            return self.plain(x, qw, scale)
        w32 = self.w32.get(qw.data_ptr())
        if w32 is None:
            w32 = self.w32[qw.data_ptr()] = qw.float()
        want = (torch.matmul(x.float(), w32) * scale.float()).to(x.dtype)
        if self.calls == 0:
            check(torch.equal(want, self.plain(x, qw, scale)),
                  "quant_matmul: the kept f32 weight's product differs "
                  "from quant_matmul_plain's")
        return want

    def __call__(self, x, qw, scale):
        import torch

        route = ("tc" if self.wq.qmm_route(x, qw) else
                 "f32" if x.dtype == torch.float32 else "mma")
        if self.ranks is not None:
            self.per_rank[self.ranks.get(qw.data_ptr(), -1)] += 1
            self.shapes[(x.numel() // x.shape[-1], *qw.shape)] += 1
        got = self.kernel(x, qw, scale)
        err, ok = matmul_err(got, self.plain_of(x, qw, scale))
        self.pending.append((err, ok, tuple(x.shape), tuple(qw.shape)))
        M = x.numel() // x.shape[-1]
        K, N = qw.shape
        self.m_values.add(M)
        self.routes[route] += 1
        if self.heaviest is None or M * N * K > self.heaviest[0].shape[0] * \
                self.heaviest[1].numel():
            self.heaviest = (x.reshape(M, K).clone(), qw, scale)
        self.calls += 1
        return got

    def verify(self):
        """Read every pending call's outcome back; the first call out of
        tolerance becomes ``error``. Returns ``error``."""
        import torch

        if self.pending:
            first = self.calls - len(self.pending)
            errs = torch.stack([p[0] for p in self.pending]).tolist()
            oks = torch.stack([p[1] for p in self.pending]).tolist()
            self.max_err = max(self.max_err, *errs)
            bad = [i for i, ok in enumerate(oks) if not ok]
            if bad and self.error is None:
                _, _, xs, ws = self.pending[bad[0]]
                self.error = (f"quant_matmul: kernel vs plain out of "
                              f"tolerance on call {first + bad[0]} of "
                              f"{self.calls} ({len(bad)} such), x {xs} @ "
                              f"{ws} (max err {errs[bad[0]]})")
            self.pending = []
        return self.error

    def all_tc(self, tag):
        """Every call within tolerance and on the tensor-core route, and
        the counts say so."""
        check(self.verify() is None, str(self.error))
        check(self.calls > 0 and self.routes["tc"] == self.calls
              and self.tc_launches == self.calls
              and self.launches == self.calls,
              f"{tag} #15 routes {dict(self.routes)}, launches "
              f"{self.launches}, tc_launches {self.tc_launches} of "
              f"{self.calls} calls")
        return dict(self.routes)


def q8_live(q, kp, vp, ks, vs, kt, vt, tbl, ln):
    return (tbl[:, 0] != 0) & (ln >= q.shape[1])


def int8_phases(dev, record, card):
    """Phases (17)-(20): the int8 serving path (``--kv-dtype int8
    --weight-dtype int8``) at full width through the port's
    InferenceServer; #12 and #15 against their plain versions on the
    path's own calls; HTTP with the launch counts; the card against the
    CPU; times. Returns the two kernels' entries of the ``kernels``
    line."""
    import gc

    import torch
    import torch.nn.functional as F

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import model as tm
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.engine import make_caches, prefill_attn
    from kubeinfer_tpu_torch.inference.stepper import RowFlags, decode_window

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    srv, cont = server.build_server(
        ["--model", "llama-3-8b", "--random-init", "--port", "0",
         "--host", "127.0.0.1", "--batch-slots", "8", *observe_flags(),
         "--kv-dtype", "int8",
         "--weight-dtype", "int8"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = srv.engine
    cfg = engine.cfg
    V, layers = cfg.vocab_size, cfg.num_hidden_layers
    check(cont.cache_len == 4096 and cont.block_size == 128
          and cont._pool.num_blocks == 513 and cont.kv_dtype == "int8"
          and cont.weight_dtype == "int8" and engine.params is not None,
          "int8 slot geometry")
    bf16 = record["serving"]
    gib = torch.cuda.memory_allocated() / 2**30
    st = cont._state
    sizes = {
        "gib_on_card": gib, "gib_before_build": before_gib,
        "model_param_bytes": cont.model_param_bytes,
        "kv_pool_bytes": cont.kv_pool_bytes,
        "pages_bytes": st.q8_pages.numel(),
        "scales_bytes": st.q8_scales.numel() * 4,
        "tails_bytes": st.q8_tails.numel() * st.q8_tails.element_size(),
    }
    print(f"[17] llama-3-8b int8 weights + int8 KV ({layers} layers, H "
          f"{cfg.hidden_size}, vocab {V}) from init_params(seed=0, "
          f"weight_dtype='int8'): {gib:.2f} GiB on the card ({before_gib:.2f}"
          f" before the build), built in {build_s:.1f} s; model_param_bytes "
          f"{cont.model_param_bytes / 2**30:.3f} GiB (bf16 "
          f"{bf16['model_param_bytes'] / 2**30:.3f}); kv_pool_bytes "
          f"{cont.kv_pool_bytes / 2**30:.3f} GiB = pages "
          f"{sizes['pages_bytes'] / 2**30:.3f} + scales "
          f"{sizes['scales_bytes'] / 2**20:.3f} MiB + tails "
          f"{sizes['tails_bytes'] / 2**30:.3f} (bf16 "
          f"{bf16['kv_pool_bytes'] / 2**30:.3f})")
    record["int8_sizes"] = sizes
    cont.start()

    # (17) #12 and #15 against their plain versions on the path's calls
    rng = np.random.default_rng(17)
    chk12 = CheckedAttention(
        fa, "decode_attention_blocks_q8", fa.decode_attention_blocks_q8_plain,
        live=q8_live,
        weight=lambda q, kp, vp, ks, vs, kt, vt, tbl, ln: (
            int((tbl[:, 0] != 0).sum()), int(ln.sum())), walk=True)
    chk15 = CheckedMatmul(wq)
    fa.decode_attention_blocks.launches = 0
    with torch.inference_mode(), chk12, chk15:
        prompts = [rng.integers(1, V, 512).tolist() for _ in range(8)]
        try:
            in_threads(lambda p: cont.generate(p, 4, timeout=180), prompts)
            long_prompt = rng.integers(1, V, 4100).tolist()
            engine.generate([long_prompt], 2)
        finally:
            check(chk12.error is None, str(chk12.error))
            check(chk15.verify() is None, str(chk15.error))
    check(chk12.calls >= layers and chk12.calls % layers == 0,
          f"#12 checked on {chk12.calls} calls")
    check({8, 512, 2048} <= chk15.m_values,
          f"#15 saw M in {sorted(chk15.m_values)}")
    routes17 = chk15.all_tc("[17]")
    check(fa.decode_attention_blocks.launches == 0,
          "#11 launched on the int8 pool")
    # #12 launches the split-K kernel (decode_split.cu) on every call: its
    # own count of the live splits it walked equals the mirror's
    walk17 = chk12.walk_check("[17]")[0]
    print(f"[17] decode_attention_blocks_q8: {chk12.calls} calls on every "
          f"layer of the int8 continuous engine's decode windows (8 requests"
          f" of 512 tokens, 4 new), within tolerance; max |kernel - plain| "
          f"{chk12.max_err:.3e} (bf16); split-K (decode_split.cu): {walk17} "
          f"live splits walked by the kernel's own count, equal to "
          f"decode_split_walk's")
    print(f"[17] quant_matmul: {chk15.calls} calls on every projection of "
          f"those admits and windows and of an Engine generate with a "
          f"4100-token prompt (M in {sorted(chk15.m_values)}), within tolerance; "
          f"max |kernel - plain| {chk15.max_err:.3e} (bf16); routes "
          f"{routes17} (tc: quant_matmul_tc.cu, wgmma + TMA), "
          f"tc_launches {chk15.tc_launches}")

    # (18) the main path over HTTP, counted
    srv.start()
    shared = rng.integers(1, V, 256).tolist()
    bodies = [dict(prompt=shared + rng.integers(1, V, 256).tolist(),
                   max_tokens=64) for _ in range(2)]
    bodies += [dict(prompt=rng.integers(1, V, 512).tolist(), max_tokens=64)
               for _ in range(2)]
    bodies.append(dict(prompt=rng.integers(1, V, 512).tolist(),
                       max_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
                       seed=7))
    bodies.append(dict(prompt=rng.integers(1, V, 4100).tolist(),
                       max_tokens=16))
    names = (*SERVE_KERNELS, "decode_attention_blocks_q8")
    for name in names:
        getattr(fa, name).launches = 0
    qb0 = cont.quant_blocks_total
    split12 = CountedSplit(fa, "decode_attention_blocks_q8", dev)
    chk18 = CheckedMatmul(wq)
    t0 = time.perf_counter()
    with torch.inference_mode(), split12, chk18:
        try:
            resps = in_threads(lambda b: post_json(srv.port, b), bodies)
        finally:
            check(chk18.verify() is None, str(chk18.error))
        http_s = time.perf_counter() - t0
        counts = {name: getattr(fa, name).launches for name in names}
    counts["quant_matmul"] = chk18.launches
    routes18 = chk18.all_tc("[18]")
    walk18 = split12.walk_check("[18]")[0]
    check(counts["decode_attention_blocks_q8"] > 0
          and counts["quant_matmul"] > 0
          and counts["flash_attention_ragged"] > 0
          and counts["decode_attention"] > 0
          and counts["decode_attention_blocks"] == 0,
          f"int8 path launches {counts}")
    routes = [r["kubeinfer"]["route"] for r in resps]
    check(routes == ["continuous"] * 5 + ["engine"], f"routes {routes}")
    for b, r in zip(bodies, resps):
        toks = r["choices"][0]["tokens"]
        check(len(toks) == b["max_tokens"]
              and all(0 <= x < V for x in toks), "tokens out of range")
    with torch.inference_mode():
        lg, _ = tm.forward(engine.params, torch.tensor(
            [bodies[0]["prompt"][:64]], device=dev), cfg)
    check(bool(torch.isfinite(lg).all()), "NaN/inf logits")
    flags = RowFlags(sampled=True, top_k=True, top_p=True, penalty=True)
    with torch.inference_mode():
        _, sites = count_syncs(lambda: decode_window(
            cont.params, cont._state, cfg, 4, flags)[1].cpu())
    n_sync = sum(sites.values())
    check(n_sync == 1, f"int8 decode window host syncs {dict(sites)}")
    qb = cont.quant_blocks_total
    print(f"[18] /v1/completions over HTTP on the int8 server: 4 greedy + 1 "
          f"sampled 512-token prompts (64 new) on route continuous, 1 of "
          f"4100 tokens (16 new) on route engine, {http_s:.1f} s; launches "
          f"{counts} (#12 on the split-K kernel, {walk18} live splits walked "
          f"by its own count, equal to decode_split_walk's; #15 within "
          f"tolerance of its plain version on all {chk18.calls} calls, "
          f"routes {routes18}); host syncs in "
          f"one decode window (K=4, gates on) + its "
          f"readback: {n_sync}; quant_blocks_total {qb} ({qb - qb0} in this "
          f"run); logits finite")
    record["int8_serving"] = {"launches": counts, "http_s": http_s,
                              "qmm_routes": routes18,
                              "qmm_max_err": chk18.max_err,
                              "split_walk_12": walk18,
                              "window_syncs": n_sync,
                              "quant_blocks_total": qb}

    # (19) the card against the CPU
    card_vs_cpu_int8(dev, record)

    # (20) times
    ttft = []
    for _ in range(5):
        req = cont.serve(rng.integers(1, V, 512).tolist(), 1)
        ttft.append((req.t_first - req.t_submit) * 1e3)
    reqs = in_threads(lambda p: cont.serve(p, 64),
                      [rng.integers(1, V, 512).tolist() for _ in range(8)])
    t_all = max(r.t_first for r in reqs)
    gaps = []
    for r in reqs:
        times = [x for x in r.token_times if x > t_all]
        gaps += list(np.diff(times) * 1e3)
    decode_ms = statistics.median(gaps)
    lens = torch.tensor([4100], dtype=torch.int32, device=dev)
    prompt = torch.zeros((1, 8192), dtype=torch.int64, device=dev)
    prompt[0, :4100] = torch.tensor(long_prompt, device=dev)
    chunk_ms = []
    with torch.inference_mode():
        caches = make_caches(cfg, 1, 8192, torch.bfloat16, dev)
        for c0 in range(0, 8192, 2048):
            chunk_ms.append(cuda_ms(lambda c0=c0: tm.forward(
                engine.params, prompt[:, c0:c0 + 2048], cfg,
                kv_caches=caches, cache_offset=c0,
                attn_fn=prefill_attn(c0, lens), return_hidden=True),
                reps=1, warmup=0))
        del caches
    adm_wall, adm_busy, adm_top = device_profile(
        lambda: cont.serve(rng.integers(1, V, 512).tolist(), 1))
    dec_wall, dec_busy, dec_top = device_profile(
        lambda: in_threads(lambda p: cont.serve(p, 32), [
            rng.integers(1, V, 512).tolist() for _ in range(8)]))
    for what, wall, busy, top in (
            ("one 512-token admit (TTFT)", adm_wall, adm_busy, adm_top),
            ("8 requests of 512 + 32 new", dec_wall, dec_busy, dec_top)):
        print(f"[20] int8 profile, {what}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms ({100 * busy / wall:.1f}%); #15 "
              f"{qmm_share(top):.2f} ms of it; top kernels "
              + "; ".join(f"{n[:60]} {ms:.1f} ms x{c}"
                          for n, ms, c in top[:6]))
    step = launches_per_step(cont, cfg, commit_steps=[False] * 4)
    step_c = launches_per_step(cont, cfg)
    bf = record["profile"]["decode_step"]
    print(f"[20] per decode step (8 slots, one K=4 window profiled): bf16 "
          f"{bf['launches']:.0f} device launches, {bf['busy_ms']:.2f} ms "
          f"busy; int8 {step[0]:.0f} launches, {step[1]:.2f} ms busy, "
          f"#15 {step[3]:.3f} ms of it (on a step with the tail commit: {step_c[0]:.0f}, "
          f"{step_c[1]:.2f} ms)")
    print(f"[20] {card}: int8 TTFT of a 512-token prompt p50 "
          f"{statistics.median(ttft):.2f} ms ({[round(x, 2) for x in ttft]});"
          f" decode at 8 live slots p50 {decode_ms:.3f} ms per token per "
          f"slot, {8e3 / decode_ms:.1f} tokens/s; engine route prefill chunk"
          f" (2048 queries, 8192-wide cache) p50 "
          f"{statistics.median(chunk_ms):.2f} ms "
          f"({[round(x, 2) for x in chunk_ms]})")
    record["int8_profile"] = {
        "admit": {"wall_ms": adm_wall, "busy_ms": adm_busy,
                  "qmm_ms": qmm_share(adm_top), "top": adm_top[:12]},
        "decode_8x32": {"wall_ms": dec_wall, "busy_ms": dec_busy,
                        "qmm_ms": qmm_share(dec_top), "top": dec_top[:12]},
        "decode_step": {"launches": step[0], "busy_ms": step[1],
                        "wall_ms": step[2], "qmm_ms": step[3]},
        "decode_step_commit": {"launches": step_c[0], "busy_ms": step_c[1],
                               "wall_ms": step_c[2]},
    }
    record["int8_times"] = {
        "ttft_ms": ttft, "decode_ms_per_token": decode_ms,
        "tokens_per_s": 8e3 / decode_ms, "prefill_chunk_ms": chunk_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    with torch.inference_mode():
        entries = [time_decode(dev, fa, chk12, card,
                               "decode_attention_blocks_q8",
                               counts["decode_attention_blocks_q8"], F,
                               tag="[20]"),
                   time_qmm(dev, wq, chk15, card, counts,
                            engine.params["layers"][0], record)]
    # (30b) disaggregated prefill and decode on the int8 server's first
    # SPEC_INT8_LAYERS layers (a second server on its tensors: the whole
    # run keeps inside its time limit with (34) added); (31c) drains it
    # onto (30b)'s decode replica
    migrate = {}
    try:
        cut_srv, cut = cut_server(dev, srv, cont, SPEC_INT8_LAYERS)
        try:
            launches = disagg_phase(
                dev, record, card, cut_srv, cut,
                then=lambda dec_srv, dec: migrate.update(migrate_phase(
                    dev, record, card, cut_srv, cut, dec_srv, dec)))
        finally:
            cut_srv.stop()
            cut.stop()
        del cut_srv, cut
        gc.collect()
        torch.cuda.empty_cache()
        # (32b) on the full-depth server
        observe = observe_phase(dev, record, card, srv, cont)
    finally:
        srv.stop()
        cont.stop()
    entries[0]["observe_launches"] = observe["decode_attention_blocks_q8"]
    entries[1]["observe_launches"] = observe["quant_matmul"]
    entries[0]["disagg_launches"] = launches["decode_attention_blocks_q8"]
    entries[1]["disagg_launches"] = launches["quant_matmul"]
    entries[0]["migrate_launches"] = migrate["decode_attention_blocks_q8"]
    entries[1]["migrate_launches"] = migrate["quant_matmul"]
    return entries


def card_vs_cpu_int8(dev, record):
    """Phase (19): int8 weights quantized on the card and on the CPU from
    the same f32 draw at llama-3-8b widths cut to 1 layer: codes and
    scales bitwise equal; then the Engine (greedy) and the int8-pool
    ContinuousEngine (one greedy and one sampled row in one batch, blocks
    of 128, prompts of about 120 so the decode crosses a block edge) on
    both: equal streams, the card's through #10 and #12 (their guards
    hold at block 128 and D 128), the CPU's through the dense route."""
    import dataclasses

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.model import init_params, params_to
    from kubeinfer_tpu_torch.inference.weight_quant import (
        QUANT_LEAVES,
        quantize_params,
    )

    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=CPU_CHECK_LAYERS)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (118, 121)]
    kws = ({}, dict(temperature=0.8, top_k=50, top_p=0.9,
                    repetition_penalty=1.2, seed=3))
    p_cpu = init_params(cfg, seed=19, dtype=torch.float32, device="cpu")
    q_cpu = quantize_params(p_cpu)
    q_card = quantize_params(params_to(p_cpu, dev))
    n_leaves = 0
    for a, b in zip(q_card["layers"], q_cpu["layers"]):
        for name in QUANT_LEAVES:
            for part in ("qw", "scale"):
                check(torch.equal(a[name][part].cpu(), b[name][part]),
                      f"[19] int8 {name}.{part} differs between card and CPU")
                n_leaves += 1
    del p_cpu

    def run(params, device):
        eng = Engine(params, cfg, max_cache_len=256, device=device)
        out = [eng.generate(prompts, 20).tokens.tolist()]
        cont = ContinuousEngine(params, cfg, n_slots=2, cache_len=256,
                                block_size=128, kv_dtype="int8",
                                weight_dtype="int8", device=device).start()
        try:
            out.append(in_threads(lambda i: cont.generate(
                prompts[i], 20, **kws[i]), [0, 1]))
        finally:
            cont.stop()
        return out, cont

    t0 = time.perf_counter()
    want, c_cpu = run(q_cpu, "cpu")
    host_s = time.perf_counter() - t0
    fa.decode_attention.launches = fa.decode_attention_blocks_q8.launches = 0
    t0 = time.perf_counter()
    got, c_card = run(q_card, dev)
    card_s = time.perf_counter() - t0
    n10, n12 = (fa.decode_attention.launches,
                fa.decode_attention_blocks_q8.launches)
    check(n10 > 0 and n12 > 0, f"[19] the card took the dense route: #10 "
          f"{n10} launches, #12 {n12}")
    pages = (c_card._state.q8_pages.cpu(), c_cpu._state.q8_pages)
    diff = (pages[0].int() - pages[1].int()).abs()
    n_diff = int((diff > 0).sum())
    print(f"[19] int8 codes and scales of {n_leaves} leaves quantized on the "
          f"card and on the CPU: bitwise equal; int8 pool codes that differ "
          f"after the runs: {n_diff} of {diff.numel()} (max |diff| "
          f"{int(diff.max())})")
    for name, g, w in zip(("Engine greedy (int8 weights)",
                           "ContinuousEngine greedy + sampled (int8 both)"),
                          got, want):
        if g != w:
            first = next(i for i, (a, b) in enumerate(
                zip(np.ravel(g), np.ravel(w))) if a != b)
            print(f"[19] {name}: streams differ first at flat index {first}")
        check(g == w, f"[19] {name}: card {g} != CPU {w}")
    print(f"[19] llama-3-8b widths, {CPU_CHECK_LAYERS} layer, f32, int8 "
          f"weights + int8 KV "
          f"(block 128), 2 prompts of 118 and 121, 20 new: Engine greedy and"
          f" ContinuousEngine greedy + sampled on the card (#10 {n10} "
          f"launches, #12 {n12}) equal to device='cpu' (the dense route; "
          f"host {host_s:.1f} s, card {card_s:.1f} s)")
    record["card_vs_cpu_int8"] = {"host_s": host_s, "card_s": card_s,
                                  "launches_10": n10, "launches_12": n12,
                                  "pool_codes_differing": n_diff,
                                  "streams": got}
    del q_card, q_cpu, c_card, c_cpu


QMM_M = (8, 40, 512, 2048)  # decode, a T = 5 verify window, an admit, a chunk
QMM_LEAVES = ("gate_proj", "down_proj")  # 4096 x 14336 and 14336 x 4096


def qmm_library(x, qw, scale, reps):
    """``torch._weight_int8pack_mm`` (int8 weight [N, K], the same
    function) as (ms, label): device time at decode sizes, CUDA events
    over ``reps`` calls where a call takes many ms; (None, reason) where
    the installed torch does not run it on CUDA."""
    import torch

    try:
        w_nk = qw.t().contiguous()
        s16 = scale.to(x.dtype)
        torch._weight_int8pack_mm(x, w_nk, s16)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch._weight_int8pack_mm not run: {e}"[:120]
    fn = lambda: torch._weight_int8pack_mm(x, w_nk, s16)  # noqa: E731
    if x.shape[0] <= 64:
        return device_ms(fn), "torch._weight_int8pack_mm, device time"
    return (cuda_ms(fn, reps=reps, warmup=0),
            "torch._weight_int8pack_mm, CUDA events over calls")


def qmm_bound(M, N, K, elt):
    """(bound ms, bound_by, ops, bytes) of one #15 call: 2 M N K
    operations at the bf16 tensor-core rate against x, the int8 weight,
    the scale and out read or written once at HBM speed."""
    ops = 2 * M * N * K
    nbytes = M * K * elt + K * N + 4 * N + M * N * elt
    op_ms = ops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", ops, nbytes)


def time_qmm(dev, wq, chk, card, counts, layer, record):
    """#15's entry of the ``kernels`` line and its times: on the captured
    call with the most operations, and at M in ``QMM_M`` on layer 0's
    gate and down projections (x random, seeded): device time (a CUDA
    graph of 20 launches), the wrapper's host us a call, the plain
    version, ``torch._weight_int8pack_mm`` and, as a lower yardstick
    the port never calls, ``torch.matmul`` on the pre-dequantized bf16
    weight (twice the weight bytes, no conversion)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    for leaf in QMM_LEAVES:
        qw, scale = layer[leaf]["qw"], layer[leaf]["scale"]
        K, N = qw.shape
        w16 = (qw.float() * scale).to(torch.bfloat16)
        for M in QMM_M:
            x = torch.randn((M, K), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
            bound, by, ops, nbytes = qmm_bound(M, N, K, 2)
            ms = device_ms(lambda: wq.quant_matmul(x, qw, scale))
            us = host_us(lambda: wq.quant_matmul(x, qw, scale), reps=100)
            mm_ms = device_ms(lambda: torch.matmul(x, w16))
            lib_ms, lib_label = qmm_library(x, qw, scale, reps=2)
            rows.append(dict(
                leaf=leaf, M=M, K=K, N=N, device_ms=ms,
                host_us=us, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, library_call=lib_label,
                matmul_bf16_ms=mm_ms,
                tflops=ops / ms / 1e9, gbps=nbytes / ms / 1e6))
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
            print(f"[20] {card}: quant_matmul {leaf} M {M} (x [{M}, {K}] @ "
                  f"int8 [{K}, {N}]): device {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} "
                  f"GB/s), host {us:.1f} us a call; bound {bound:.5f} ms "
                  f"({by}); "
                  f"_weight_int8pack_mm {lib_txt} ms; torch.matmul on the "
                  f"bf16 weight {mm_ms:.4f} ms")
        del w16
    record["qmm_times"] = rows

    x, qw, scale = chk.heaviest
    M, K = x.shape
    N = qw.shape[1]
    ms = device_ms(lambda: wq.quant_matmul(x, qw, scale))
    wall_ms = cuda_ms(lambda: wq.quant_matmul(x, qw, scale), reps=20)
    us = host_us(lambda: wq.quant_matmul(x, qw, scale), reps=100)
    plain_ms = cuda_ms(lambda: chk.plain(x, qw, scale), reps=3)
    lib_ms, lib_label = qmm_library(x, qw, scale, reps=2)
    bound, by, ops, nbytes = qmm_bound(M, N, K, x.element_size())
    print(f"[20] {card}: quant_matmul on the path's heaviest call, x [{M}, "
          f"{K}] @ int8 [{K}, {N}]: device {ms:.4f} ms (wall {wall_ms:.4f},"
          f" host {us:.1f} us), plain "
          f"{plain_ms:.4f}, bound {bound:.5f} ({by})")
    return {
        "name": "quant_matmul", "route": "cuda",
        "source": "kubeinfer_tpu_torch/inference/csrc/quant_matmul_tc.cu",
        "kernel_route": "tc" if wq.qmm_route(x, qw) else "mma",
        "routes": dict(chk.routes),
        "replaces": QMM_REPLACES, "launches": counts["quant_matmul"],
        "max_abs_err": chk.max_err, "ms": ms, "device_ms": ms,
        "wall_ms": wall_ms, "host_us": us,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms, "library_call": lib_label,
        "shape_mkn": [M, K, N], "times": rows,
        "timing": "ms, device_ms: device time a launch (a "
                  "CUDA graph of 20 launches, replays timed by CUDA "
                  "events); wall_ms: CUDA events over 20 calls; host_us: "
                  "the wrapper's host time a call",
        "check": f"within tolerance of its plain version (bf16: 2**-6 of "
                 f"each output row's magnitude) on {chk.calls} calls of the "
                 "full-width int8 path",
    }


# --- the training step: phases (21)-(23) --------------------------------------

TRAIN_KERNELS = ("flash_ragged_lse", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_SOURCES = {
    "flash_ragged_lse": ("kubeinfer_tpu_torch/inference/csrc/"
                         "flash_prefill_tc.cu",
                         "kubeinfer_tpu/inference/flash_attention.py:1525"),
    "flash_bwd_dq": ("kubeinfer_tpu_torch/inference/csrc/"
                     "flash_backward_tc.cu",
                     "kubeinfer_tpu/inference/flash_attention.py:1590"),
    "flash_bwd_dkv": ("kubeinfer_tpu_torch/inference/csrc/"
                      "flash_backward_tc.cu",
                      "kubeinfer_tpu/inference/flash_attention.py:1617"),
}
TRAIN_CORES = {"flash_ragged_lse": TC_CORES, "flash_bwd_dq": BWD_TC_CORES,
               "flash_bwd_dkv": BWD_TC_CORES}
# flops per live (head, query, key) pair and head width: #13 q.k and
# P.v; #14's dQ recomputes q.k, dO.v and adds dS.K; dK/dV recomputes
# both and adds P^T.dO and dS^T.Q
TRAIN_FLOPS_PER_D = {"flash_ragged_lse": 4, "flash_bwd_dq": 6,
                     "flash_bwd_dkv": 8}
LSE_ABS = 1e-4  # f32 logsumexp, kernel vs plain (sums in another order)


def grad_err(got, want, noise=None):
    """(largest |kernel - plain|, within tolerance, rows held to their
    rounding floor and not to 2**-6): every value finite,
    each row of the last axis within 1e-5 (f32) or 2**-6 (bf16, 2 ulps)
    of that row's largest |plain value|; with ``noise`` (#14's dQ and dK
    in bf16, ``flash_bwd_noise``), within the row's f32 rounding floor
    where that is larger: a row whose dS cancels (a query's first key)
    is rounding noise in both, and the tensor cores sum dP in another
    order than the plain version."""
    import torch

    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        return float("inf"), False, 0
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    err = (g - w).abs().amax(dim=1)
    if got.dtype == torch.float32:
        return (float(err.max()),
                bool((err <= 1e-5 * w.abs().amax(dim=1)).all()), 0)
    rel = BF16_REL * w.abs().amax(dim=1)
    tol = rel if noise is None else torch.maximum(
        rel, noise.reshape(-1, g.shape[-1]).amax(dim=1))
    return (float(err.max()), bool((err <= tol).all()),
            int((err > rel).sum()))


class CheckedTrain:
    """A stand-in for one of the training wrappers of
    ``inference.flash_attention`` (#13 ``flash_ragged_lse``, #14
    ``flash_bwd_dq`` / ``flash_bwd_dkv``): runs the kernel and its plain
    version on the same inputs, holds every output within the stated
    tolerance (the lse within LSE_ABS) and, for #13, its o bitwise equal
    to #9's on the same inputs; hands the kernel's result on. Keeps the
    first call's inputs for the times. Its ``launches`` (and
    ``tc_launches``) take the wrapper's counts while it stands in, and the
    #9 launch of the comparison is taken off #9's count. For #14 the
    first call runs with ``walk_counter`` set: the kernel's own count of
    its folded steps, held to n_kv times ``flash_bwd_walk``'s, is kept in
    ``walked`` as (card, plain mirror); ``walk_counter`` is None
    otherwise. #14's dQ and dK rows are held with their rounding floor
    (``grad_err``)."""

    def __init__(self, fa, name, plain):
        self.fa, self.name = fa, name
        self.kernel, self.plain = getattr(fa, name), plain
        self.launches = self.tc_launches = self.calls = 0
        self.walk_counter = None
        self.walked = None
        self.max_err = 0.0
        self.floor_rows = [0, 0]  # rows held to their rounding floor, rows
        self.first = None

    def __enter__(self):
        setattr(self.fa, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.fa, self.name, self.kernel)

    def __call__(self, *args):
        import torch

        bwd = self.name in ("flash_bwd_dq", "flash_bwd_dkv")
        if bwd and self.calls == 0:
            self.walk_counter = torch.zeros(1, dtype=torch.int32,
                                            device=args[0].device)
        try:
            got = self.kernel(*args)
        finally:
            counter, self.walk_counter = self.walk_counter, None
        if counter is not None:
            q, k = args[0], args[1]
            n_kv = k.shape[2]
            steps = self.fa.flash_bwd_walk(
                q.shape[1], k.shape[1], int(args[6]), args[7],
                q.shape[2] // n_kv)[self.name == "flash_bwd_dkv"]
            self.walked = (int(counter), n_kv * int(steps.sum()))
            check(self.walked[0] == self.walked[1],
                  f"{self.name}: the kernel folded {self.walked[0]} steps, "
                  f"flash_bwd_walk says {self.walked[1]}")
        want = self.plain(*args)
        gs = got if isinstance(got, tuple) else (got,)
        ws = want if isinstance(want, tuple) else (want,)
        noise = [None] * len(gs)
        if bwd:
            dq_n, dk_n = self.fa.flash_bwd_noise(*args)
            noise = [dq_n] if self.name == "flash_bwd_dq" else [dk_n, None]
        for i, (g, w) in enumerate(zip(gs, ws)):
            if self.name == "flash_ragged_lse" and i == 1:
                err = float((g - w).abs().max())
                ok = bool(g.isfinite().all()) and err <= LSE_ABS
            else:
                err, ok, floor = grad_err(g, w, noise[i])
                self.floor_rows[0] += floor
                self.floor_rows[1] += g.numel() // g.shape[-1]
            check(ok, f"{self.name}: kernel vs plain out of tolerance on "
                      f"call {self.calls}, output {i} (max err {err})")
            self.max_err = max(self.max_err, err)
        if self.name == "flash_ragged_lse":
            f9 = self.fa.flash_attention_ragged
            n9 = (f9.launches, f9.tc_launches)
            o9 = f9(*args)
            f9.launches, f9.tc_launches = n9
            check(torch.equal(o9, gs[0]),
                  f"#13's o differs from #9's on call {self.calls}")
        if self.first is None:
            self.first = args
        self.calls += 1
        return got


def live_pairs(T, S, q_offset, row_lens):
    """Live (query, key) pairs of the ragged causal mask, summed over the
    rows: this run's data, not the worst case."""
    t = np.arange(T)
    total = 0
    for n in row_lens:
        total += int(np.minimum(q_offset + t + 1, n).clip(min=0).sum()) \
            if n > 0 else 0
    return total


def train_phases(dev, record, card):
    """Phases (21)-(23): ``train.train_step`` on llama-3-8b at full width
    and depth (bf16, one sequence of 2048, no attn_fn, so forward's
    default binding takes the flash route), #13 and both #14 kernels
    against their plain versions on every layer's call of the first step,
    the launch counts of two more steps; times; then the card against
    the CPU at 1 layer in f32. Returns the three kernels' entries of the
    ``kernels`` line."""
    import gc

    import torch
    import torch.nn.functional as F

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import train
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params, param_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = PRESETS["llama-3-8b"]
    V, layers = cfg.vocab_size, cfg.num_hidden_layers
    T = 2048
    # outside inference_mode: the step saves these for the backward
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(1, V, (1, T + 1))).to(dev)
    check(fa.flash_available(T, T, cfg.head_dim, dev),
          "the flash route does not take T = S = 2048")
    weights_gib = param_bytes(params) / 2**30

    # (21) step 1 with every call of the three kernels checked
    plains = {"flash_ragged_lse": fa.flash_ragged_lse_plain,
              "flash_bwd_dq": fa.flash_bwd_dq_plain,
              "flash_bwd_dkv": fa.flash_bwd_dkv_plain}
    chks = {n: CheckedTrain(fa, n, p) for n, p in plains.items()}
    fa.flash_attention_ragged.launches = 0
    with chks["flash_ragged_lse"], chks["flash_bwd_dq"], \
            chks["flash_bwd_dkv"]:
        t0 = time.perf_counter()
        _, loss1 = train.train_step(params, tokens, cfg, lr=1e-3)
        loss1 = float(loss1)
        first_s = time.perf_counter() - t0
    for n, c in chks.items():
        check(c.calls == layers, f"{n} checked on {c.calls} calls")
    for n, c in chks.items():
        check(c.tc_launches == layers,
              f"{n}: {c.tc_launches} of {layers} bf16 calls on the "
              "tensor-core route")
    check(fa.flash_attention_ragged.launches == 0,
          "#9 launched in the training step")
    # the main path, counted: two more steps
    for name in (*TRAIN_KERNELS, "flash_attention_ragged"):
        getattr(fa, name).launches = 0
    for name in TRAIN_KERNELS:
        getattr(fa, name).tc_launches = 0
    losses = [loss1]
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = train.train_step(params, tokens, cfg, lr=1e-3)
        losses.append(float(loss))  # the readback ends the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {n: getattr(fa, n).launches
              for n in (*TRAIN_KERNELS, "flash_attention_ragged")}
    check(counts == {"flash_ragged_lse": 2 * layers,
                     "flash_bwd_dq": 2 * layers,
                     "flash_bwd_dkv": 2 * layers,
                     "flash_attention_ragged": 0},
          f"training launches over 2 steps {counts}")
    tcs = {n: getattr(fa, n).tc_launches for n in TRAIN_KERNELS}
    check(tcs == {n: 2 * layers for n in TRAIN_KERNELS},
          f"tensor-core launches over 2 steps {tcs}: every bf16 call of "
          "#13 and #14 takes the tensor-core route")
    check(all(np.isfinite(losses)), f"losses {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[21] train_step on llama-3-8b (H {cfg.hidden_size}, {layers} "
          f"layers, {cfg.num_attention_heads}/{cfg.num_key_value_heads} "
          f"heads, D {cfg.head_dim}, vocab {V}), bf16 init_params(seed=0) "
          f"({weights_gib:.2f} GiB), tokens [1, {T + 1}], lr 1e-3, no "
          f"attn_fn: step 1 ({first_s:.1f} s) with "
          + ", ".join(f"{n} on {c.calls} calls (max |kernel - plain| "
                      f"{c.max_err:.3e})" for n, c in chks.items())
          + f" within tolerance and #13's o bitwise #9's; #14's walks on "
          f"layer 0 (kernel's count, flash_bwd_walk's): dQ "
          f"{chks['flash_bwd_dq'].walked}, dK/dV "
          f"{chks['flash_bwd_dkv'].walked}; rows held to their rounding "
          f"floor (a cancelling dS) and not to 2**-6 of their magnitude: "
          + ", ".join(f"{n} {c.floor_rows[0]} of {c.floor_rows[1]}"
                      for n, c in chks.items() if n != "flash_ragged_lse")
          + f"; losses {losses}; "
          f"launches over steps 2-3 {counts} (on the tensor-core route: "
          f"{tcs}); peak "
          f"{peak_gib:.2f} GiB")
    record["train"] = {"losses": losses, "launches_2_steps": counts,
                       "tc_launches_2_steps": tcs,
                       "walked": {n: chks[n].walked
                                  for n in ("flash_bwd_dq", "flash_bwd_dkv")},
                       "floor_rows": {n: chks[n].floor_rows
                                      for n in ("flash_bwd_dq",
                                                "flash_bwd_dkv")},
                       "weights_gib": weights_gib, "peak_gib": peak_gib,
                       "first_step_s": first_s}

    # (23) times
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = train.train_step(params, tokens, cfg, lr=1e-3)
        float(loss)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(step_ms)
    tok_s = T / p50 * 1e3
    print(f"[23] {card}: train_step p50 {p50:.1f} ms "
          f"({[round(x, 1) for x in step_ms]}), {tok_s:.0f} tokens/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    peak23 = torch.cuda.max_memory_allocated() / 2**30
    # where a step's device time goes: one step under torch.profiler
    wall, busy, rows = device_profile(
        lambda: train.train_step(params, tokens, cfg, lr=1e-3))
    top = [(name, round(ms, 3), n) for name, ms, n in rows[:15]]
    print(f"[23] {card}: one train_step under torch.profiler: wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.0f}%); top device operations (name, ms, "
          f"count): {top}")
    entries = [time_train_kernel(dev, fa, chks[n], card, n, counts[n], F,
                                 tcs[n])
               for n in TRAIN_KERNELS]
    record["train_times"] = {
        "step_ms": step_ms, "step_p50_ms": p50, "tokens_per_s": tok_s,
        "peak_gib": peak23, "profile_wall_ms": wall,
        "profile_busy_ms": busy,
        "profile_top": [list(r) for r in rows[:40]]}
    del params, chks, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # (22) the card against the CPU
    train_card_vs_cpu(dev, record)
    return entries


def time_train_kernel(dev, fa, chk, card, name, launches, F, tc_launches):
    """One training kernel's entry of the ``kernels`` line: its time per
    launch on the first checked call (layer 0 of step 1), its plain
    version's, its bound from this call's live pairs, and the library
    yardstick: scaled_dot_product_attention (causal, GQA) forward for
    #13, its backward alone (dq, dk, dv in one call) for #14; and the
    CUDA-core kernel on the same call."""
    import torch

    args = chk.first
    q, k, v = args[:3]
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    elt = q.element_size()
    off, lens = (args[3], args[4]) if name == "flash_ragged_lse" else \
        (args[6], args[7])
    kernel = getattr(fa, name)
    ms = cuda_ms(lambda: kernel(*args), reps=20)
    plain_ms = cuda_ms(lambda: chk.plain(*args), reps=3)
    pairs = live_pairs(T, S, int(off), lens.tolist()) * H
    ops = TRAIN_FLOPS_PER_D[name] * D * pairs
    rows = B * T * H * 4  # lse (and drow) f32 per folded row
    qkv = q.numel() + k.numel() + v.numel()
    if name == "flash_ragged_lse":
        nbytes = (qkv + q.numel()) * elt + rows
    elif name == "flash_bwd_dq":
        nbytes = (qkv + 2 * q.numel()) * elt + 2 * rows
    else:
        nbytes = (qkv + q.numel() + k.numel() + v.numel()) * elt + 2 * rows
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    if name == "flash_ragged_lse":
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), reps=10)
        label = ("torch.nn.functional.scaled_dot_product_attention "
                 "(is_causal, enable_gqa) forward on the same q/k/v")
    else:
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
            dout = args[3].transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), dout, retain_graph=True), reps=10)
            both_ms = cuda_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                               enable_gqa=True),
                (qg, kg, vg), dout), reps=10)
        label = ("torch.nn.functional.scaled_dot_product_attention "
                 "(is_causal, enable_gqa) backward alone: dq, dk and dv in "
                 f"one call (forward + backward {both_ms:.4f} ms)")
    op_ms = ops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    bound_by = "operations" if op_ms >= byte_ms else "bytes"
    source, replaces = TRAIN_SOURCES[name]
    core_ms = cuda_core_ms(name, args)
    core = (f"tensor cores ({tc_launches} of the path's launches; the "
            f"CUDA-core kernel on this call {core_ms:.4f} ms); ")
    print(f"[23] {card}: {name} {ms:.4f} ms/launch on q [{B}, {T}, {H}, "
          f"{D}], k/v [{B}, {S}, {n_kv}, {D}], {pairs / 1e6:.1f} M live "
          f"(head, pair)s; {core}plain {plain_ms:.4f} ms; {label} "
          f"{library_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; "
          f"{ops / ms / 1e9:.1f} TFLOP/s, {ms / pairs * 1e9:.1f} ps a "
          f"pair); {launches} launches on the main path")
    return {
        "cores": TRAIN_CORES[name], "cuda_core_ms": core_ms,
        "tc_launches": tc_launches,
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": chk.max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": label,
        "check": f"within tolerance of its plain version (bf16: 2**-6 of "
                 f"each row's magnitude; lse {LSE_ABS} absolute) on "
                 f"{chk.calls} calls of the full-width training step"
                 + (", o bitwise equal to #9's" if name == "flash_ragged_lse"
                    else ""),
    }


def train_card_vs_cpu(dev, record):
    """Phase (22): the same f32 weights at llama-3-8b widths cut to 2
    layers, tokens [2, 513], on the card (the flash route: #13, #14) and
    on the CPU (the dense route): the loss within 1e-5 relative and
    every gradient leaf within 1e-4 of its largest |value| (two routes,
    sums in another order); then TRAIN_CHECK_STEPS steps at lr 5e-2 on
    each side, which must lower the loss on both."""
    import dataclasses

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import train
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params, params_to

    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=CPU_CHECK_LAYERS)
    rng = np.random.default_rng(22)
    toks = rng.integers(1, cfg.vocab_size, (2, 513))
    p_cpu = init_params(cfg, seed=22, dtype=torch.float32, device="cpu")
    p_card = params_to(p_cpu, dev)
    sides = {"card": (p_card, torch.from_numpy(toks).to(dev)),
             "cpu": (p_cpu, torch.from_numpy(toks))}
    out = {}
    n13 = (fa.flash_ragged_lse.launches, fa.flash_ragged_lse.tc_launches)
    for side, (params, tk) in sides.items():
        leaves = train._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        t0 = time.perf_counter()
        loss = train.causal_lm_loss(params, tk, cfg)
        grads = torch.autograd.grad(loss, leaves)
        out[side] = (float(loss.detach()), [g.cpu() for g in grads])
        for p in leaves:
            p.requires_grad_(False)
        out[side + "_s"] = time.perf_counter() - t0
    check(fa.flash_ragged_lse.launches > n13[0],
          "[22] the card's step did not take the flash route")
    check(fa.flash_ragged_lse.tc_launches == n13[1],
          "[22] an f32 call took the tensor-core route")
    (lc, gc_), (lh, gh) = out["card"], out["cpu"]
    rel_loss = abs(lc - lh) / abs(lh)
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(gc_, gh))
    check(rel_loss <= 1e-5, f"[22] loss card {lc} CPU {lh}")
    check(worst <= 1e-4, f"[22] a gradient leaf differs by {worst} of its "
                         "largest value")
    curves = {}
    for side, (params, tk) in sides.items():
        curve = []
        t0 = time.perf_counter()
        for _ in range(TRAIN_CHECK_STEPS):
            _, loss = train.train_step(params, tk, cfg, lr=5e-2)
            curve.append(float(loss))
        curves[side] = curve
        check(curve[-1] < curve[0], f"[22] {side}: loss did not fall {curve}")
        out[side + "_steps_s"] = time.perf_counter() - t0
    print(f"[22] llama-3-8b widths, {CPU_CHECK_LAYERS} layer, f32, tokens "
          f"[2, 513]: loss "
          f"card (flash route) {lc:.6f}, CPU (dense route) {lh:.6f} (rel "
          f"{rel_loss:.2e}); gradients within {worst:.2e} of each leaf's "
          f"largest value; {TRAIN_CHECK_STEPS} steps at lr 5e-2: card "
          f"{curves['card']}, CPU "
          f"{curves['cpu']} (host {out['cpu_s'] + out['cpu_steps_s']:.1f} s)")
    record["train_card_vs_cpu"] = {"loss_card": lc, "loss_cpu": lh,
                                   "rel_loss": rel_loss,
                                   "worst_leaf_rel": worst, "curves": curves}
    del p_card, p_cpu, sides


# --- #9b and speculative decoding: phases (24)-(28) ---------------------------

MASK_REPLACES = "kubeinfer_tpu/inference/flash_attention.py:323"
# a greedy stream may leave the plain engine's only at a near-tie of the
# bf16 model: where the two tokens' logits under an f32 forward of the
# same weights (the exact model) differ by no more than two bf16 paths'
# errors can swap. A position's bf16 allowance is 2 x the bf16 forward's
# own error on its two top logits, plus one bf16 ulp of the head's output
# at the top logits (about 5, where an ulp is 2**-5); a divergence is
# held to the largest allowance of any position of the streams
# (``held_streams``). The verify forward runs T = k + 1 rows through
# the projections where plain decode runs T = 1, and cuBLAS rounds the
# two differently; at full depth the bf16 hidden states sit about 9% off
# the f32 forward's ([24]), so the top logits move by up to ~0.25
GAP_ULP = 2.0 ** -5
# the same in f32 at full depth (phase 25c): two f32 routes' logits differ
# by about the bf16 error scaled by the unit roundoffs' ratio (2**-24 /
# 2**-8 of ~0.2, a few 1e-6; TF32 is off), so a tie is a gap within
# 2**-10, some 300x that and some 200x below the median top-2 gap (~0.19)
F32_TIE = 2.0 ** -10
# the final hidden states of the live rows, bf16 at full depth: the #9b
# route's relative L2 error against an f32 forward of the same weights
# (dense route) may be at most this multiple of the bf16 dense route's
# (max and mean over the rows): the two bf16 routes round P at different
# places, and 32 layers of residual stream carry it
HIDDEN_RATIO = 2.0
HIDDEN_F32_ABS = 1e-4  # the same at 2 layers in f32, card against the CPU


def packed_mask(T, docs, pad):
    """bool [T, T]: block-diagonal causal over documents of the given
    lengths, then ``pad`` rows (and columns) that see nothing."""
    m = np.zeros((T, T), bool)
    s = 0
    for n in docs:
        m[s:s + n, s:s + n] = np.tril(np.ones((n, n), bool))
        s += n
    check(s + pad == T, "packed mask lengths")
    return m


class CheckedMasked(CheckedAttention):
    """``CheckedAttention`` for #9b that also holds every all-False mask
    row to the uniform mean of v over all S keys (bf16: 2**-6 of the
    row's largest |mean|)."""

    def __call__(self, q, k, v, mask):
        import torch

        got = super().__call__(q, k, v, mask)
        dead = ~mask.any(dim=2)  # [B, T]
        G = q.shape[2] // k.shape[2]
        mean = v.float().mean(dim=1).repeat_interleave(G, dim=1)  # [B, H, D]
        for b in range(q.shape[0]):
            rows = got[b][dead[b]].float()  # [n, H, D]
            if rows.numel():
                want = mean[b][None].expand_as(rows)
                err = (rows - want).abs().amax(dim=-1)  # [n, H]
                tol = BF16_REL * want.abs().amax(dim=-1)
                if got.dtype == torch.float32:
                    tol = torch.full_like(tol, 1e-5)
                if not bool((err <= tol).all()):
                    self.error = (f"flash_attention: all-False rows differ "
                                  f"from the mean of v by {float(err.max())}")
                    raise AssertionError(self.error)
        return got


def cast_tree(params, dtype):
    """The parameter tree with every tensor cast to ``dtype`` (a copy); an
    int8 weight leaf becomes its dequantized weight in ``dtype``."""
    from kubeinfer_tpu_torch.inference import weight_quant as wq

    if wq.is_quant_leaf(params):
        return wq.dequantize_weight(params, dtype)
    if isinstance(params, dict):
        return {key: cast_tree(x, dtype) for key, x in params.items()}
    if isinstance(params, list):
        return [cast_tree(x, dtype) for x in params]
    return params.to(dtype)


def forced_logits(params, cfg, prompt, out, dev, served=True):
    """Teacher-forced logits of every token of ``out`` after ``prompt``,
    (served [n, V] or None, f32 [n, V]) as f32 tensors: the tree as it
    serves (no cache; skipped unless ``served``), and the same weights
    cast to f32 one layer at a time (dense attention). Row i is the
    distribution ``out[i]`` was drawn from, on the stream's own
    prefix."""
    import torch

    from kubeinfer_tpu_torch.inference import model as tm

    toks = torch.tensor([list(prompt) + list(out[:-1])], device=dev)
    T, first = toks.shape[1], len(prompt) - 1
    head = tm.lm_head_matrix(params, cfg)
    lg16 = None
    with torch.inference_mode():
        if served:
            h16, _ = tm.forward(params, toks, cfg, return_hidden=True)
            lg16 = (h16[0, first:] @ head).float()
        cos, sin = tm.rope_tables(torch.arange(T, device=dev)[None],
                                  cfg.head_dim, cfg.rope_theta)
        check(not cfg.scale_embeddings, "f32 logits: an unscaled embedding")
        x = params["embed_tokens"][toks].float()
        mask = tm.causal_mask(T, dev)[None]
        for layer in params["layers"]:
            x, _ = tm.decoder_layer(cast_tree(layer, torch.float32), x, cos,
                                    sin, mask, cfg)
        x = tm.rms_norm(x[0, first:], params["norm"].float(),
                        cfg.rms_norm_eps, offset=cfg.rmsnorm_offset)
        lg32 = x @ head.float()
    return lg16, lg32


def token_gaps(stream, lg32, lg16=None):
    """Per position of ``stream``: (the f32 argmax's logit minus the
    token's, or minus the runner-up's where the token is the argmax;
    whether the token is the argmax; the bf16 allowance 2 x the served
    forward's largest error on those two logits + GAP_ULP, or None)."""
    import torch

    top2 = lg32.topk(2, dim=-1).indices
    toks = torch.tensor(stream, device=lg32.device)
    rows = torch.arange(len(stream), device=lg32.device)
    a = top2[:, 0]
    b = torch.where(toks == a, top2[:, 1], toks)
    gap = lg32[rows, a] - lg32[rows, b]
    allow = None
    if lg16 is not None:
        err = (lg16 - lg32).abs()
        allow = 2 * torch.maximum(err[rows, a], err[rows, b]) + GAP_ULP
    return gap, toks == a, allow


def stream_ties(got, want, prompts, params, cfg, dev):
    """Each greedy bf16 stream of ``got`` against the plain engine's
    (``want``) and a teacher-forced f32 forward of the same weights.
    Returns (the first divergences as (output index, the two tokens' f32
    logit gap, the bf16 forward's largest error on them, the route whose
    token the f32 forward ranks lower), the per-token counts [positions,
    not the f32 argmax, outside the bf16 allowance] of both sets of
    streams, the largest bf16 allowance of any position of any of them).
    The allowance of a position is 2 x the bf16 forward's largest error on
    the two logits + GAP_ULP (``token_gaps``)."""
    stats = {"speculative": [0, 0, 0], "plain": [0, 0, 0]}
    divs, envelope = [], 0.0
    for g, w, p in zip(got, want, prompts):
        rows = {}
        for name, stream in (("speculative", g), ("plain", w)):
            l16, l32 = forced_logits(params, cfg, p, stream, dev)
            gap, is_top, allow = token_gaps(stream, l32, l16)
            st = stats[name]
            st[0] += len(stream)
            st[1] += int((~is_top).sum())
            st[2] += int((~is_top & (gap > allow)).sum())
            envelope = max(envelope, float(allow.max()))
            rows[name] = (l16, l32)
        if g == w:
            continue
        i = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                 min(len(g), len(w)))
        if i >= min(len(g), len(w)):
            divs.append((i, float("inf"), float("inf"), "length"))
            continue
        l16, l32 = rows["speculative"]  # the same prefix up to row i
        x, y = g[i], w[i]
        err = max(abs(float(l16[i, x] - l32[i, x])),
                  abs(float(l16[i, y] - l32[i, y])))
        gap = float(l32[i, x] - l32[i, y])
        divs.append((i, round(abs(gap), 5), round(err, 5),
                     "plain" if gap > 0 else "speculative"))
    return divs, stats, envelope


def held_streams(label, got, want, prompts, params, cfg, dev):
    """Greedy bf16 streams (``got``) equal to the plain engine's
    (``want``), or leaving them first at a near-tie of the bf16 model:
    the two tokens' logits under a teacher-forced f32 forward of the same
    weights on the shared prefix differ by no more than the bf16 model's
    error can swap, the largest bf16 allowance (2 x the dense bf16
    forward's error on a position's two top logits + GAP_ULP) of any
    position of these streams. The allowance at the divergence itself is
    reported beside it and not checked: a divergence happens where the two
    routes' own errors are large, which one sample of a third forward's
    error on two logits does not bound (``--tie-probe``: on (25a)'s
    streams over 12 prompt sets it rejected the kernels before the
    split-K one on 5). Prints each divergence as (output index, that f32
    gap, that bf16 error, the route whose token f32 ranks lower), and for
    both sets of streams how many tokens are not the f32 forward's argmax
    and how many lie outside their own position's allowance, the plain
    engine's as the control (phase 25c holds every token in f32).
    Returns (the count of divergences, the per-token counts [positions,
    not the argmax, outside] of both sets)."""
    divs, stats, envelope = stream_ties(got, want, prompts, params, cfg,
                                        dev)
    print(f"{label} greedy divergences from the plain engine (output index,"
          f" f32 logit gap of the two tokens, bf16 error on them, the route "
          f"f32 ranks lower): {divs}; within 2 x that error + an ulp: "
          f"{sum(gap <= 2 * err + GAP_ULP for _, gap, err, _ in divs)} of "
          f"{len(divs)}; the largest allowance of any position "
          f"{envelope:.5f}")
    print(f"{label} every greedy token against a teacher-forced f32 forward "
          f"on its own prefix (positions, not the f32 argmax, outside the "
          f"bf16 allowance): speculative {stats['speculative']}, the plain "
          f"engine {stats['plain']}")
    check(all(gap <= envelope for _, gap, _, _ in divs),
          f"{label}: a stream leaves the plain engine's where the two "
          f"tokens' f32 logits differ by more than the bf16 model's error "
          f"can swap")
    return len(divs), stats


def f32_streams(label, got, want, prompts, params, cfg, dev):
    """Greedy f32 streams: every token of ``got`` the argmax of a
    teacher-forced f32 forward on its own prefix or within F32_TIE of
    it, and each stream equal to the plain engine's (``want``) or leaving
    it first where both tokens are such near-ties. Returns (divergences,
    tokens not the argmax, positions whose f32 top-2 gap is within
    F32_TIE: where the check cannot tell the top two apart)."""
    excused = blind = 0
    divs, bad = [], []
    for g, w, p in zip(got, want, prompts):
        _, l32 = forced_logits(params, cfg, p, g, dev, served=False)
        gap, is_top, _ = token_gaps(g, l32)
        excused += int((~is_top).sum())
        blind += int((gap <= F32_TIE).sum())
        bad += [(i, float(gap[i])) for i in range(len(g))
                if not bool(is_top[i]) and float(gap[i]) > F32_TIE]
        if g == w:
            continue
        i = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                 min(len(g), len(w)))
        if i >= min(len(g), len(w)):
            divs.append((i, float("inf")))  # lengths differ
            continue
        divs.append((i, float(l32[i].max() - l32[i, w[i]])))
    print(f"{label} every greedy token against a teacher-forced f32 forward "
          f"on its own prefix: {sum(map(len, got))} positions, {excused} "
          f"not its argmax, {blind} with a top-2 gap within {F32_TIE}; "
          f"tokens outside it {bad}; divergences from the plain engine "
          f"(output index, the plain token's gap to the argmax): {divs}")
    check(not bad and all(gap <= F32_TIE for _, gap in divs),
          f"{label}: an f32 greedy token is not the f32 forward's argmax "
          f"within {F32_TIE}")
    return len(divs), excused, blind


def spec_counters(label, eng, reqs, before, k):
    """The verify counters against the emitted lengths: every row-window
    proposed k drafts, emitted n_dev = accepted + 1 device tokens, of which
    the host kept all but a truncation (at most k per request, at its
    end); accepted tokens never exceed proposals; the per-request sums
    equal the engine's."""
    st = eng.scheduler_stats()
    d = {key: st[key] - before[key] for key in
         ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks")}
    row_windows = d["spec_draft_tokens"] // k
    emitted = sum(len(r.out_tokens) - 1 for r in reqs)
    check(d["spec_draft_tokens"] == k * row_windows
          and d["spec_accepted_tokens"] <= d["spec_draft_tokens"]
          and d["spec_rollbacks"] <= row_windows
          and emitted <= d["spec_accepted_tokens"] + row_windows
          <= emitted + k * len(reqs)
          and sum(r.spec_accepted for r in reqs) == d["spec_accepted_tokens"]
          and sum(r.spec_rollbacks for r in reqs) == d["spec_rollbacks"],
          f"{label}: verify counters {d} against {emitted} emitted tokens "
          f"over {len(reqs)} requests")
    return d, row_windows, emitted


def timed_windows(cont, prompts, new):
    """Admit ``prompts`` into a scheduler that is not running, then run
    verify windows by hand until every row retires: (ms per window, tokens
    emitted per live row per window, windows)."""
    reqs = [cont.submit(p, new) for p in prompts]
    cont._admit_pending()
    ms, per_row = [], []
    while any(r is not None for r in cont._slot_req):
        live = [r for r in cont._slot_req if r is not None]
        n0 = sum(len(r.out_tokens) for r in live)
        t0 = time.perf_counter()
        cont._verify_pass()  # ends in the window's readback
        ms.append((time.perf_counter() - t0) * 1e3)
        per_row.append((sum(len(r.out_tokens) for r in live) - n0)
                       / len(live))
    check(all(r.done.is_set() and len(r.out_tokens) == new for r in reqs),
          "timed verify windows left a request unfinished")
    return statistics.median(ms), float(np.mean(per_row)), len(ms)


def decode_ms_per_token(cont, prompts, new):
    """Concurrent requests through the running scheduler: per request,
    (last token - the moment every row is live) / tokens after it; the
    median over requests (ms per emitted token per slot)."""
    reqs = in_threads(lambda p: cont.serve(p, new, timeout=900), prompts)
    t_all = max(r.t_first for r in reqs)
    per = []
    for r in reqs:
        times = [x for x in r.token_times if x > t_all]
        if len(times) > 1:
            per.append((times[-1] - t_all) / len(times) * 1e3)
    return statistics.median(per)


def masked_phase(dev, record, card):
    """Phase (24): #9b on its entry, ``forward(params, tokens, cfg,
    attn_mask=packed, attn_fn=attention_auto)`` on llama-3-8b at full
    width and depth (bf16), every layer's call checked; the launch count
    of a second forward; the live rows' hidden states against the dense
    route; 2 layers in f32 on the card against the CPU; #9b's times.
    Returns the kernels-line entry."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import model as tm
    from kubeinfer_tpu_torch.inference.config import PRESETS

    gc.collect()
    torch.cuda.empty_cache()
    cfg = PRESETS["llama-3-8b"]
    V, layers, D = cfg.vocab_size, cfg.num_hidden_layers, cfg.head_dim
    T, docs, pad = 2048, (512, 1024, 384), 128
    params = tm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(24)
    tokens = torch.from_numpy(rng.integers(1, V, (1, T))).to(dev)
    mask = torch.from_numpy(packed_mask(T, docs, pad)[None]).to(dev)
    live_pairs = int(mask.sum())
    check(fa.flash_available(T, T, D, dev), "#9b's guard refuses T = 2048")

    chk = CheckedMasked(
        fa, "flash_attention", fa.flash_attention_plain,
        live=lambda q, k, v, m: torch.ones(q.shape[0], dtype=torch.bool,
                                           device=q.device),
        weight=lambda q, k, v, m: 0)
    with torch.inference_mode(), chk:
        try:
            tm.forward(params, tokens, cfg, attn_mask=mask,
                       attn_fn=fa.attention_auto, return_hidden=True)
        finally:
            check(chk.error is None, str(chk.error))
    check(chk.calls == layers, f"#9b checked on {chk.calls} calls")
    check(chk.tc_launches == layers,
          f"#9b: {chk.tc_launches} of {layers} bf16 calls on the "
          "tensor-core route")
    # the main path, counted; the kernel also counts the key tiles its
    # blocks fold, held against the walk's plain mirror
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    n_kv = cfg.num_key_value_heads
    G = cfg.num_attention_heads // n_kv
    walk = fa.flash_mask_walk(mask, fa.TC_ROWS // G, fa.TC_KEYS)
    fa.flash_attention.walk_counter = torch.zeros(1, dtype=torch.int32,
                                                  device=dev)
    try:
        with torch.inference_mode():
            hid, _ = tm.forward(params, tokens, cfg, attn_mask=mask,
                                attn_fn=fa.attention_auto, return_hidden=True)
        kernel_walked = int(fa.flash_attention.walk_counter)
    finally:
        fa.flash_attention.walk_counter = None
    launches = fa.flash_attention.launches
    tc_launches = fa.flash_attention.tc_launches
    check(launches == layers and tc_launches == layers,
          f"#9b launched {launches} times in a forward, {tc_launches} on "
          "the tensor-core route")
    # (block, key tile) steps a kv head a launch: the kernel's count and
    # the mirror's
    walked, mirror, steps = (kernel_walked // (layers * n_kv),
                             int(walk.sum()), walk.numel())
    check(kernel_walked == layers * n_kv * mirror,
          f"#9b's kernel folded {kernel_walked} key tiles in {layers} "
          f"launches; flash_mask_walk names {layers} x {n_kv} x {mirror}")
    with torch.inference_mode():
        dense, _ = tm.forward(params, tokens, cfg, attn_mask=mask,
                              attn_fn=tm.attention, return_hidden=True)
        p32 = cast_tree(params, torch.float32)
        h32, _ = tm.forward(p32, tokens, cfg, attn_mask=mask,
                            attn_fn=tm.attention, return_hidden=True)
        del p32
    live = slice(0, T - pad)

    def rel_rows(a, b):
        a, b = a[0, live].float(), b[0, live].float()
        return (a - b).norm(dim=-1) / b.norm(dim=-1)

    rel = rel_rows(hid, dense)
    rk, rd = rel_rows(hid, h32), rel_rows(dense, h32)
    check(bool(torch.isfinite(hid).all())
          and float(rk.max()) <= HIDDEN_RATIO * float(rd.max())
          and float(rk.mean()) <= HIDDEN_RATIO * float(rd.mean()),
          f"#9b route against the f32 forward: max {float(rk.max())}, mean "
          f"{float(rk.mean())}; the dense bf16 route's max "
          f"{float(rd.max())}, mean {float(rd.mean())}")
    print(f"[24] forward(attn_mask=packed, attn_fn=attention_auto) on "
          f"llama-3-8b bf16 (init_params(seed=0), {layers} layers), tokens "
          f"[1, {T}], documents {docs} + {pad} rows that see nothing: "
          f"flash_attention on {chk.calls} calls within tolerance of its "
          f"plain version (max |kernel - plain| {chk.max_err:.3e}), the "
          f"all-False rows equal to the mean of v over all {T} keys; "
          f"{launches} launches in a counted forward, {tc_launches} on the "
          f"tensor-core route, whose blocks folded {walked} of {steps} "
          f"(block, key tile) steps a kv head a launch by their own count "
          f"(flash_mask_walk, the plain mirror: {mirror}); the {T - pad} live "
          f"rows' hidden states against attn_fn=model.attention: relative "
          f"L2 max {float(rel.max()):.3e}, mean {float(rel.mean()):.3e}; "
          f"against an f32 forward of the same weights: #9b route max "
          f"{float(rk.max()):.3e} mean {float(rk.mean()):.3e}, dense bf16 "
          f"route max {float(rd.max()):.3e} mean {float(rd.mean()):.3e} "
          f"(limit {HIDDEN_RATIO}x the dense route's)")

    # #9b's times (phase 28) on the layer-0 call
    args = chk.heaviest
    q, k, v, m = args
    H = q.shape[2]
    with torch.inference_mode():
        ms = cuda_ms(lambda: fa.flash_attention(*args), reps=10)
        core_ms = cuda_core_ms("flash_attention", args)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(*args), reps=3)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m[:, None], enable_gqa=True), reps=10)
    elt = q.element_size()
    # the work this mask needs: QK^T and PV over the live pairs of every
    # head, and one mean of v over all S keys per kv head for the rows
    # that see nothing (the kernel folds every tile of their blocks)
    ops = 4 * live_pairs * H * D + n_kv * T * D
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + m.numel()
    op_ms = ops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    bound_by = "operations" if op_ms >= byte_ms else "bytes"
    print(f"[28] {card}: flash_attention {ms:.4f} ms/launch on q [1, {T}, "
          f"{H}, {D}] with the packed mask ({live_pairs} live pairs a head, "
          f"{100 * live_pairs / T / T:.1f}% of T x S), tensor cores walking "
          f"{walked} of {steps} (block, key tile) steps a kv head, as the "
          f"kernel counted them in [24] (the "
          f"CUDA-core kernel on this call, every tile: {core_ms:.4f} ms); "
          f"plain {plain_ms:.4f} "
          f"ms; scaled_dot_product_attention (bool mask, GQA) "
          f"{library_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{ops / 1e9:.3f} GFLOP over the live pairs, {nbytes / 1e6:.3f} "
          f"MB); {launches} launches on the main path, {tc_launches} on the "
          f"tensor-core route")
    entry = {
        "cores": TC_CORES, "cuda_core_ms": core_ms,
        "tc_launches": tc_launches, "walked_steps": [walked, steps],
        "name": "flash_attention", "route": "cuda",
        "source": TC_SOURCE,
        "replaces": MASK_REPLACES, "launches": launches,
        "max_abs_err": chk.max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(enable_gqa, the same boolean mask) on the same "
                        "q/k/v",
        "check": f"within tolerance of its plain version (bf16: 2**-6 of "
                 f"each row's magnitude) on {chk.calls} calls, all-False "
                 "rows equal to the mean of v",
    }
    record["masked"] = {"launches": launches, "live_pairs": live_pairs,
                        "hidden_rel_max": float(rel.max()),
                        "hidden_rel_mean": float(rel.mean()),
                        "f32_rel_9b": [float(rk.max()), float(rk.mean())],
                        "f32_rel_dense": [float(rd.max()), float(rd.mean())],
                        "ms": ms, "plain_ms": plain_ms,
                        "cuda_core_ms": core_ms, "walked_steps": walked,
                        "library_ms": library_ms, "bound_ms": bound_ms}
    del chk, args, q, k, v, m, hid, dense, h32, rel, rk, rd
    gc.collect()

    # 2 layers in f32: the card (#9b) against the CPU (dense route)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    p2 = tm.init_params(cfg2, seed=24, dtype=torch.float32, device=dev)
    T2 = 512
    tok2 = torch.from_numpy(rng.integers(1, V, (1, T2)))
    m2 = torch.from_numpy(packed_mask(T2, (128, 256, 64), 64)[None])
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    with torch.inference_mode():
        h_card, _ = tm.forward(p2, tok2.to(dev), cfg2, attn_mask=m2.to(dev),
                               attn_fn=fa.attention_auto, return_hidden=True)
        n_card = fa.flash_attention.launches
        check(fa.flash_attention.tc_launches == 0,
              "[24] an f32 call took the tensor-core route")
        p2c = tm.params_to(p2, "cpu")
        del p2
        t0 = time.perf_counter()
        h_cpu, _ = tm.forward(p2c, tok2, cfg2, attn_mask=m2,
                              attn_fn=fa.attention_auto, return_hidden=True)
        host_s = time.perf_counter() - t0
    err = float((h_card.cpu() - h_cpu).abs().max())
    check(n_card == 2 and err <= HIDDEN_F32_ABS,
          f"[24] 2 layers f32: #9b launches {n_card}, card vs CPU {err}")
    print(f"[24] llama-3-8b widths cut to 2 layers, f32, tokens [1, {T2}] "
          f"with a packed mask: the card (#9b, {n_card} launches) against "
          f"device='cpu' (the dense route of attention_auto, {host_s:.1f} s):"
          f" max |diff| of the hidden states {err:.3e} (limit "
          f"{HIDDEN_F32_ABS})")
    record["masked"]["f32_card_vs_cpu_abs"] = err
    del p2c, h_card, h_cpu, params
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def spec_phases(dev, record, card):
    """Phases (25)-(28): verify windows on llama-3-8b bf16 at 8 slots, a
    self-draft library engine (a) and the server with a seed-1 draft (b),
    both at SPEC_INT8_LAYERS of the preset's layers, with the plain
    engine's streams at the same depth; the draft groups and the side-car
    (26); the int8 verify server (27, at SPEC_INT8_LAYERS); times (28).
    Returns
    nothing: #10, #11 and #12 keep their kernels-line entries from phases
    16 and 20."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.stepper import RowFlags, verify_window

    cfg = PRESETS["llama-3-8b"]
    # the server's target, init_params(seed=0) in bf16, cut to
    # SPEC_INT8_LAYERS for (a) as for (b) (a self draft's windows cost two
    # forwards of the target's depth a step)
    cfg_a = dataclasses.replace(cfg, num_hidden_layers=SPEC_INT8_LAYERS)
    params = init_params(cfg_a, seed=0, dtype=torch.bfloat16, device=dev)
    V, layers, k = cfg.vocab_size, cfg.num_hidden_layers, 4
    rng = np.random.default_rng(25)
    prompts_a = [rng.integers(1, V, 512).tolist() for _ in range(8)]
    prompts_b = [rng.integers(1, V, 512).tolist() for _ in range(4)]
    times = {}
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        record.setdefault("spec_s", {})[name] = now - t_mark[0]
        t_mark[0] = now

    def checkers(trim11=False):
        """#11 (trimmed where its heaviest call is not timed later) and
        #10, each on every call."""
        return (
            CheckedAttention(
                fa, "decode_attention_blocks",
                fa.decode_attention_blocks_plain,
                live=lambda q, kp, vp, tbl, ln: ((tbl[:, 0] != 0)
                                                 & (ln >= q.shape[1])),
                weight=lambda q, kp, vp, tbl, ln: (
                    int((tbl[:, 0] != 0).sum()), int(ln.sum())), walk=True,
                trim=trim11),
            CheckedAttention(
                fa, "decode_attention", fa.decode_attention_plain,
                live=lambda q, kk, vv, ln: ln > 0, weight=lambda *a: 0,
                walk=True, trim=True))

    def one_sync(cont):
        flags = RowFlags(sampled=True, top_k=True, top_p=True, penalty=True)
        with torch.inference_mode():
            _, sites = count_syncs(lambda: verify_window(
                cont.params, cont._state, cont._dparams, cont._dstate,
                cont.cfg, cont._dcfg, k, flags)[2].cpu())
        n = sum(sites.values())
        check(n == 1, f"verify window host syncs {dict(sites)}")
        return n

    # the plain engine's greedy streams (no draft) and its decode pace
    e0 = ContinuousEngine(params, cfg_a, n_slots=8, cache_len=4096,
                          device=dev).start()
    try:
        with torch.inference_mode():
            plain_a = in_threads(lambda p: e0.generate(p, 64, timeout=900),
                                 prompts_a)
            times["decode_plain_ms"] = decode_ms_per_token(
                e0, [rng.integers(1, V, 512).tolist() for _ in range(8)], 64)
    finally:
        e0.stop()
    del e0
    gc.collect()
    torch.cuda.empty_cache()
    mark("[25] plain streams")

    # (25a) a library engine whose draft is the target itself
    ea = ContinuousEngine(params, cfg_a, n_slots=8, cache_len=4096,
                          spec_draft=(params, cfg_a), spec_k=k, device=dev)
    with torch.inference_mode():
        times["window_a"] = timed_windows(
            ea, [rng.integers(1, V, 512).tolist() for _ in range(8)], 64)
    ea.start()
    chk11, chk10 = checkers()
    sampled = [dict(temperature=0.8, top_k=50, top_p=0.9, seed=s)
               for s in (3, 4)]
    before = ea.scheduler_stats()
    jobs = [(p, {}) for p in prompts_a] + [
        (rng.integers(1, V, 512).tolist(), kw) for kw in sampled]
    fa.decode_attention_blocks.launches = fa.decode_attention.launches = 0
    with torch.inference_mode(), chk11, chk10:
        try:
            reqs = in_threads(lambda j: ea.serve(j[0], 64, timeout=900,
                                                 **j[1]), jobs)
        finally:
            check(chk11.error is None and chk10.error is None,
                  f"{chk11.error} {chk10.error}")
    check(chk11.calls > 0 and chk11.calls % cfg_a.num_hidden_layers == 0
          and chk10.calls == (k - 1) * chk11.calls
          and fa.decode_attention_blocks.launches == 0,
          f"(a) #11 {chk11.calls} calls, #10 {chk10.calls}")
    walks_a = [chk.walk_check("[25a]")[0] for chk in (chk11, chk10)]
    for r in reqs:
        check(len(r.out_tokens) == 64 and all(0 <= x < V
                                              for x in r.out_tokens),
              "(a) tokens")
    cnt_a = spec_counters("[25a]", ea, reqs, before, k)
    div_a, tok_a = held_streams("[25a]", [r.out_tokens for r in reqs[:8]],
                                plain_a, prompts_a, params, cfg_a, dev)
    sync_a = one_sync(ea)
    print(f"[25a] ContinuousEngine(llama-3-8b bf16 at "
          f"{cfg_a.num_hidden_layers} layers, 8 "
          f"slots, cache 4096, "
          f"spec_draft = the target itself, spec_k {k}): 8 greedy + 2 "
          f"sampled 512-token prompts, 64 new: decode_attention_blocks at "
          f"T = {k + 1} on {chk11.calls} calls and decode_attention on the "
          f"draft steps' {chk10.calls} calls within tolerance (max "
          f"|kernel - plain| {chk11.max_err:.3e}, {chk10.max_err:.3e}; "
          f"split-K, live splits walked {walks_a[0]} and {walks_a[1]} by "
          f"the kernel's own count, equal to decode_split_walk's); "
          f"counters {cnt_a[0]} over {cnt_a[1]} row-windows, {cnt_a[2]} "
          f"tokens after the admits; greedy streams equal to the plain "
          f"engine's but {div_a} (each at a near-tie of the bf16 model); "
          f"{sync_a} host sync per verify window")
    ea.stop()
    record["spec_a"] = {"counters": cnt_a[0], "row_windows": cnt_a[1],
                        "divergences": div_a, "f32_token_stats": tok_a,
                        "checked_11": chk11.calls,
                        "checked_10": chk10.calls}
    heavy11 = chk11
    del ea, chk10, params
    gc.collect()
    torch.cuda.empty_cache()
    mark("[25a]")

    # (25b) the server with a seed-1 draft of the same preset, both cut to
    # SPEC_INT8_LAYERS (every window rolls back at any depth), and the plain
    # engine's streams on the server's own weights
    argv = ["--model", "llama-3-8b", "--random-init", "--port", "0",
            "--host", "127.0.0.1", "--batch-slots", "8", "--draft-model",
            "llama-3-8b", "--speculation-depth", str(k)]
    t0 = time.perf_counter()
    full = PRESETS["llama-3-8b"]
    PRESETS["llama-3-8b"] = dataclasses.replace(
        full, num_hidden_layers=SPEC_INT8_LAYERS)
    try:
        srv, cont = server.build_server(argv + ["--speculative-draft"])
    finally:
        PRESETS["llama-3-8b"] = full
    torch.cuda.synchronize()
    cfg_b = cont.cfg
    eb = ContinuousEngine(srv.engine.params, cfg_b, n_slots=8,
                          cache_len=4096, device=dev).start()
    try:
        with torch.inference_mode():
            plain_b = in_threads(lambda p: eb.generate(p, 64, timeout=900),
                                 prompts_b)
    finally:
        eb.stop()
    del eb
    gc.collect()
    torch.cuda.empty_cache()
    gib = torch.cuda.memory_allocated() / 2**30
    print(f"[25b] server.build_server({' '.join(argv[:3] + argv[7:])} "
          f"--speculative-draft) at {SPEC_INT8_LAYERS} layers: {gib:.1f} GiB "
          f"on the card (target, draft, pool, draft caches), built in "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        times["window_b"] = timed_windows(
            cont, [rng.integers(1, V, 512).tolist() for _ in range(8)], 16)
    cont.start()
    srv.start()
    chk11, chk10 = checkers(trim11=True)
    bodies = [dict(prompt=p, max_tokens=64) for p in prompts_b]
    bodies.append(dict(prompt=rng.integers(1, V, 512).tolist(),
                       max_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
                       seed=7))
    before = cont.scheduler_stats()
    fa.decode_attention_blocks.launches = fa.decode_attention.launches = 0
    with torch.inference_mode(), chk11, chk10:
        try:
            resps = in_threads(lambda b: post_json(srv.port, b), bodies)
        finally:
            check(chk11.error is None and chk10.error is None,
                  f"{chk11.error} {chk10.error}")
    check(chk11.calls > 0 and chk10.calls == (k - 1) * chk11.calls,
          f"(b) #11 {chk11.calls} calls, #10 {chk10.calls}")
    walks_b = [chk.walk_check("[25b]")[0] for chk in (chk11, chk10)]
    routes = [r["kubeinfer"]["route"] for r in resps]
    check(routes == ["continuous"] * 5, f"(b) routes {routes}")
    outs = [r["choices"][0]["tokens"] for r in resps]
    check(all(len(o) == 64 and all(0 <= x < V for x in o) for o in outs),
          "(b) tokens")
    st = cont.scheduler_stats()
    d = {key: st[key] - before[key] for key in
         ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks")}
    # each request's verify accounting rides its engine.decode span (as in
    # the reference), found by the completion id's request id
    _, body, _ = get_text(srv.port, "/debug/spans")
    spans = {e["args"]["req"]: e["args"]
             for e in json.loads(body)["traceEvents"]
             if e.get("name") == "engine.decode" and "req" in e.get("args", {})}
    rids = [int(r["id"].rsplit("-", 1)[1]) for r in resps]
    acc = sum(spans[i]["kubeinfer.spec_accepted"] for i in rids)
    rb = sum(spans[i]["kubeinfer.spec_rollbacks"] for i in rids)
    row_windows = d["spec_draft_tokens"] // k
    emitted = sum(len(o) - 1 for o in outs)
    check(acc == d["spec_accepted_tokens"] and rb == d["spec_rollbacks"]
          and emitted <= d["spec_accepted_tokens"] + row_windows
          <= emitted + k * len(outs) and rb <= row_windows,
          f"(b) verify counters {d} against {emitted} tokens")
    div_b, tok_b = held_streams("[25b]", outs[:4], plain_b, prompts_b,
                                srv.engine.params, cfg_b, dev)
    sync_b = one_sync(cont)
    print(f"[25b] /v1/completions on that server: 4 greedy + 1 sampled "
          f"512-token prompts, 64 new, route continuous: #11 at T = {k + 1} "
          f"on {chk11.calls} calls and #10 on {chk10.calls} within "
          f"tolerance (max |kernel - plain| {chk11.max_err:.3e}, "
          f"{chk10.max_err:.3e}; live splits walked {walks_b[0]} and "
          f"{walks_b[1]}, equal to decode_split_walk's); counters {d} over "
          f"{row_windows} "
          f"row-windows (the requests' engine.decode spans sum to them); "
          f"greedy streams "
          f"equal to the plain engine's but {div_b} (each at a near-tie of the "
          f"bf16 model); {sync_b} host sync per verify window")
    record["spec_b"] = {"counters": d, "row_windows": row_windows,
                        "divergences": div_b, "f32_token_stats": tok_b,
                        "checked_11": chk11.calls,
                        "checked_10": chk10.calls}
    srv.stop()
    cont.stop()
    del srv, cont, chk10
    gc.collect()
    torch.cuda.empty_cache()
    mark("[25b]")
    spec_card_vs_cpu(dev, record, "bf16")
    mark("[25] card vs CPU")
    spec_f32_full(dev, record, k)
    mark("[25c]")

    # (26) the same server without --speculative-draft: draft groups own
    # the eligible traffic; and the side-car's bulk generate
    srv, cont = server.build_server(argv)
    srv.start()
    body = dict(max_tokens=32, temperature=0.8, top_p=0.9, seed=11)
    group_prompts = [rng.integers(1, V, 512).tolist() for _ in range(4)]
    greedy_prompt = rng.integers(1, V, 512).tolist()
    served0 = cont.spec_served
    import threading

    out = {}

    def post_in_thread(key, bodies):
        th = threading.Thread(target=lambda: out.__setitem__(key, in_threads(
            lambda b: post_json(srv.port, b), bodies)))
        th.start()
        return th

    def queued(n):
        deadline = time.perf_counter() + 60
        while cont._queue.qsize() < n and time.perf_counter() < deadline:
            time.sleep(0.01)
        check(cont._queue.qsize() == n, f"(26) {n} requests did not queue")

    # every request queued before the scheduler starts, the four sampled
    # ones (same seed) first: they join one group, the greedy one a slot
    th_s = post_in_thread("sampled", [dict(prompt=p, **body)
                                      for p in group_prompts])
    queued(4)
    th_g = post_in_thread("greedy", [dict(prompt=greedy_prompt,
                                          max_tokens=32)])
    queued(5)
    fa.flash_attention_ragged.launches = 0
    cont.start()
    th_s.join()
    th_g.join()
    resps = out["sampled"] + out["greedy"]
    check(all(r["kubeinfer"]["route"] == "continuous" for r in resps)
          and cont.spec_served - served0 == 4
          and all(len(r["choices"][0]["tokens"]) == 32 for r in resps),
          f"(26) group: served {cont.spec_served - served0}, routes "
          f"{[r['kubeinfer']['route'] for r in resps]}")
    n9_group = fa.flash_attention_ragged.launches
    check(n9_group == 2 * layers, f"(26) group prefill #9 {n9_group}")
    spec = srv.speculative
    p1 = rng.integers(1, V, 512).tolist()
    fa.flash_attention_ragged.launches = 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        out = spec.generate([p1], max_new_tokens=32)
        gen_s = time.perf_counter() - t0
    n9 = fa.flash_attention_ragged.launches
    # one chunk of 512 for the target and for the draft, every layer
    check(n9 == 2 * layers, f"(26) side-car prefill launched #9 {n9} times")
    with torch.inference_mode():
        van = srv.engine.generate([p1], 32).tokens[0].tolist()
    div_c, tok_c = held_streams("[26]", [out.tokens[0].tolist()], [van], [p1],
                         srv.engine.params, cfg, dev)
    print(f"[26] the server without --speculative-draft: 4 sampled requests "
          f"(seed 11) served by one draft group and 1 greedy on a slot, 32 "
          f"new each, route continuous; the group's prefill launched "
          f"flash_attention_ragged {n9_group} times (target and draft, one "
          f"512 chunk, every layer); SpeculativeEngine.generate([512 "
          f"tokens], 32) in {gen_s:.2f} s, {spec.last_stats['rounds']} "
          f"rounds, {int(spec.last_stats['accepted_drafts'][0])} accepted "
          f"drafts, #9 {n9} launches; greedy equal to Engine.generate but "
          f"{div_c} (at a near-tie of the bf16 model)")
    record["spec_groups"] = {"served": cont.spec_served - served0,
                             "group_n9": n9_group, "sidecar_n9": n9,
                             "sidecar_s": gen_s, "divergences": div_c,
                             "f32_token_stats": tok_c}
    srv.stop()
    cont.stop()
    del srv, cont, spec
    gc.collect()
    torch.cuda.empty_cache()
    mark("[26]")

    # (27) int8: the verify server with --kv-dtype int8 --weight-dtype int8,
    # the preset cut to SPEC_INT8_LAYERS for the server's build
    full = PRESETS["llama-3-8b"]
    PRESETS["llama-3-8b"] = dataclasses.replace(
        full, num_hidden_layers=SPEC_INT8_LAYERS)
    try:
        srv, cont = server.build_server(argv + [
            "--speculative-draft", "--kv-dtype", "int8", "--weight-dtype",
            "int8"])
    finally:
        PRESETS["llama-3-8b"] = full
    layers = SPEC_INT8_LAYERS
    srv.start()
    cont.start()
    bs = cont.block_size
    crossing = [0]

    def q8_live_crossing(q, kp, vp, ks, vs, kt, vt, tbl, ln):
        live = q8_live(q, kp, vp, ks, vs, kt, vt, tbl, ln)
        T = q.shape[1]
        cross = live & ((ln - T) // bs != (ln - 1) // bs)
        crossing[0] += int(cross.sum())
        return live

    chk12 = CheckedAttention(
        fa, "decode_attention_blocks_q8", fa.decode_attention_blocks_q8_plain,
        live=q8_live_crossing,
        weight=lambda q, kp, vp, ks, vs, kt, vt, tbl, ln: (
            int((tbl[:, 0] != 0).sum()), int(ln.sum())), walk=True)
    # windows from offset 600 on cross the edge at 640
    bodies = [dict(prompt=rng.integers(1, V, n).tolist(), max_tokens=64)
              for n in (600, 610, 620, 630)]
    bodies.append(dict(prompt=rng.integers(1, V, 605).tolist(),
                       max_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
                       seed=7))
    for name in ("decode_attention_blocks", "decode_attention_blocks_q8"):
        getattr(fa, name).launches = 0
    qb0 = cont.quant_blocks_total
    before = cont.scheduler_stats()
    chk15 = CheckedMatmul(wq)
    with torch.inference_mode(), chk12, chk15:
        try:
            resps = in_threads(lambda b: post_json(srv.port, b), bodies)
        finally:
            check(chk12.error is None, str(chk12.error))
            check(chk15.verify() is None, str(chk15.error))
    n11, n15 = fa.decode_attention_blocks.launches, chk15.launches
    routes27 = chk15.all_tc("[27]")
    st = cont.scheduler_stats()
    check(chk12.calls > 0 and chk12.calls % layers == 0 and n11 == 0
          and n15 > 0 and n15 % (7 * layers) == 0 and crossing[0] > 0
          and st["spec_draft_tokens"] > before["spec_draft_tokens"],
          f"(27) #12 {chk12.calls} calls, #11 {n11}, #15 {n15}, windows "
          f"over a block edge {crossing[0]}")
    outs = [r["choices"][0]["tokens"] for r in resps]
    check(all(len(o) == 64 and all(0 <= x < V for x in o) for o in outs),
          "(27) tokens")
    walk27 = chk12.walk_check("[27]")[0]
    sync_q = one_sync(cont)
    print(f"[27] the int8 verify server (--kv-dtype int8 --weight-dtype "
          f"int8, seed-1 bf16 draft; {layers} layers, full width): 4 greedy "
          f"+ 1 sampled prompts of "
          f"600-630 tokens, 64 new: decode_attention_blocks_q8 at T = "
          f"{k + 1} on {chk12.calls} calls within tolerance (max |kernel - "
          f"plain| {chk12.max_err:.3e}; split-K, {walk27} live splits walked "
          f"by the kernel's own count, equal to decode_split_walk's), "
          f"{crossing[0]} row-windows spilling "
          f"into tail slot 1; #11 {n11} launches; quant_matmul {n15} "
          f"launches (7 a layer per target forward), all within tolerance "
          f"of its plain version, routes {routes27}; quant_blocks_total "
          f"+{cont.quant_blocks_total - qb0}; {sync_q} host sync per "
          f"verify window")
    record["spec_int8"] = {"checked_12": chk12.calls, "crossing": crossing[0],
                           "quant_matmul": n15, "qmm_routes": routes27,
                           "qmm_max_err": chk15.max_err,
                           "quant_blocks": cont.quant_blocks_total - qb0}
    srv.stop()
    cont.stop()
    heavy12 = chk12
    del srv, cont
    gc.collect()
    torch.cuda.empty_cache()
    mark("[27]")
    spec_card_vs_cpu(dev, record, "int8")
    mark("[27] card vs CPU")

    # (28) times
    with torch.inference_mode():
        e11 = time_decode(dev, fa, heavy11, card, "decode_attention_blocks",
                          heavy11.calls, F, tag="[28]")
        e12 = time_decode(dev, fa, heavy12, card,
                          "decode_attention_blocks_q8", heavy12.calls, F,
                          tag="[28]")
    wa, wb = times["window_a"], times["window_b"]
    print(f"[28] {card}: a verify window (k {k}, 8 slots) {wa[0]:.1f} ms "
          f"p50 emitting {wa[1]:.2f} tokens per row in (a), the self-draft "
          f"({wa[2]} windows); {wb[0]:.1f} ms emitting {wb[1]:.2f} in (b), "
          f"the seed-1 draft at {SPEC_INT8_LAYERS} layers ({wb[2]} windows); "
          f"decode per emitted token per "
          f"slot: {wa[0] / wa[1]:.2f} ms (a), {wb[0] / wb[1]:.2f} ms (b), "
          f"plain decode without a draft {times['decode_plain_ms']:.2f} ms")
    record["spec_times"] = {
        "window_a_ms": wa[0], "tokens_per_row_window_a": wa[1],
        "window_b_ms": wb[0], "tokens_per_row_window_b": wb[1],
        "decode_plain_ms": times["decode_plain_ms"],
        "t5_11": {key: e11[key] for key in (
            "ms", "wall_ms", "host_us", "plain_ms",
            "bound_ms", "library_ms", "library_wall_ms", "live_splits",
            "f32_err")},
        "t5_12": {key: e12[key] for key in (
            "ms", "wall_ms", "host_us", "plain_ms",
            "bound_ms", "library_ms", "library_wall_ms", "live_splits",
            "f32_err")},
    }
    mark("[28]")
    for name, sec in record["spec_s"].items():
        print(f"[s] {name}: {sec:.1f} s")


def tie_probe(seeds, dev=None):
    """``python3 chip_smoke.py --tie-probe SEED ...``: phase (25a)'s
    streams on other prompts, for the near-tie allowance of
    ``held_streams``. For each seed, the prompts that (25a) draws from
    ``np.random.default_rng(seed)`` (25 is (25a)'s own) go through the
    plain engine and the self-draft engine as in (25a), once with #10 and
    #11 on their split-K kernels and once on the ones before them
    (``OldDecode``); prints a line per (kernel, seed): the divergences as
    ``stream_ties`` gives them, whether each lies within its allowance,
    and the largest allowance of any position of the run's streams
    (``envelope``); then a summary per kernel. Checks nothing."""
    import contextlib
    import gc

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params

    dev = dev or torch.device("cuda")
    print(card_line())
    cfg = PRESETS["llama-3-8b"]
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    V, k = cfg.vocab_size, 4
    summary = {}
    for kernel in ("split-K", "old"):
        with contextlib.ExitStack() as stack:
            if kernel == "old":
                for name in ("decode_attention", "decode_attention_blocks"):
                    stack.enter_context(OldDecode(fa, name))
            e0 = ContinuousEngine(params, cfg, n_slots=8, cache_len=4096,
                                  device=dev).start()
            ea = ContinuousEngine(params, cfg, n_slots=8, cache_len=4096,
                                  spec_draft=(params, cfg), spec_k=k,
                                  device=dev).start()
            rows = []
            try:
                for seed in seeds:
                    rng = np.random.default_rng(seed)
                    # (25a)'s draws in its order: its prompts, (25b)'s,
                    # two timing sets, then the two sampled requests'
                    draws = [rng.integers(1, V, 512).tolist()
                             for _ in range(8 + 4 + 8 + 8 + 2)]
                    prompts = draws[:8]
                    jobs = [(p, {}) for p in prompts] + [
                        (p, dict(temperature=0.8, top_k=50, top_p=0.9,
                                 seed=s)) for p, s in zip(draws[-2:], (3, 4))]
                    with torch.inference_mode():
                        plain = in_threads(
                            lambda p: e0.generate(p, 64, timeout=900),
                            prompts)
                        reqs = in_threads(lambda j: ea.serve(
                            j[0], 64, timeout=900, **j[1]), jobs)
                    divs, stats, env = stream_ties(
                        [r.out_tokens for r in reqs[:8]], plain, prompts,
                        params, cfg, dev)
                    out = [(i, gap, err, worse, gap <= 2 * err + GAP_ULP,
                            gap <= env) for i, gap, err, worse in divs]
                    rows.append(out)
                    print(f"[tie-probe] {kernel} seed {seed}: divergences "
                          f"(index, f32 gap, bf16 error, the route f32 ranks"
                          f" lower, within its allowance, within the "
                          f"envelope) {out}; envelope {env:.5f}; tokens "
                          f"[positions, not the f32 argmax, outside] {stats};"
                          f" allowance "
                          f"{'PASS' if all(o[4] for o in out) else 'FAIL'}",
                          flush=True)
            finally:
                e0.stop()
                ea.stop()
            del e0, ea
            gc.collect()
            torch.cuda.empty_cache()
        divs = [d for r in rows for d in r]
        summary[kernel] = {
            "seeds_failing": sum(not all(d[4] for d in r) for r in rows),
            "seeds": len(rows),
            "divergences_outside": sum(not d[4] for d in divs),
            "divergences": len(divs),
            "mean_gap": float(np.mean([d[1] for d in divs])) if divs else 0.0,
            "speculative_ranked_lower": sum(d[3] == "speculative"
                                            for d in divs),
            "outside_envelope": sum(not d[5] for d in divs)}
    print(json.dumps({"tie_probe": summary}))
    return 0


def spec_f32_full(dev, record, k):
    """Phase (25c): llama-3-8b at full width in f32, cut to
    SPEC_INT8_LAYERS layers (init_params(seed=0)), 8 slots, 8 greedy 512-token prompts of 64 new
    tokens through the plain engine, then through verify windows with
    the target as its own draft (acceptance near 1) and with a bigram
    draft (the target's embedding, norm and head, 0 layers: most windows
    roll back). Every token of the speculative streams is held to a
    teacher-forced f32 forward (``f32_streams``), with the verify
    counters against the emitted lengths."""
    import dataclasses
    import gc

    import torch

    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params

    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=SPEC_INT8_LAYERS)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    bigram = {key: params[key] for key in ("embed_tokens", "norm",
                                           "lm_head")}
    bigram["layers"] = []
    drafts = {"self": (params, cfg),
              "bigram": (bigram, dataclasses.replace(cfg,
                                                     num_hidden_layers=0))}
    rng = np.random.default_rng(250)
    prompts = [rng.integers(1, cfg.vocab_size, 512).tolist()
               for _ in range(8)]

    def streams(label, **kw):
        cont = ContinuousEngine(params, cfg, n_slots=8, cache_len=4096,
                                device=dev, **kw).start()
        try:
            before = cont.scheduler_stats()
            with torch.inference_mode():
                reqs = in_threads(lambda p: cont.serve(p, 64, timeout=900),
                                  prompts)
            counts = None
            if kw:
                counts = spec_counters(f"[25c] {label}", cont, reqs, before,
                                       k)
        finally:
            cont.stop()
        return [r.out_tokens for r in reqs], counts

    t0 = time.perf_counter()
    plain, _ = streams("plain")
    out = {}
    for name, draft in drafts.items():
        got, counts = streams(name, spec_draft=draft, spec_k=k)
        gc.collect()
        torch.cuda.empty_cache()
        divs, excused, blind = f32_streams(f"[25c] {name}", got, plain,
                                           prompts, params, cfg, dev)
        out[name] = {"counters": counts[0], "row_windows": counts[1],
                     "divergences": divs, "not_argmax": excused,
                     "blind": blind}
    run_s = time.perf_counter() - t0
    print(f"[25c] llama-3-8b f32 at full width, {SPEC_INT8_LAYERS} layers, "
          f"8 slots, 8 greedy "
          f"512-token prompts, 64 new, spec_k {k}: plain engine, self draft "
          f"{out['self']['counters']} over {out['self']['row_windows']} "
          f"row-windows, bigram draft {out['bigram']['counters']} over "
          f"{out['bigram']['row_windows']}; divergences from the plain "
          f"engine {out['self']['divergences']} and "
          f"{out['bigram']['divergences']}, every token within {F32_TIE} "
          f"of the f32 argmax ({run_s:.1f} s)")
    record["spec_f32_full"] = out
    del params, bigram, drafts
    gc.collect()
    torch.cuda.empty_cache()


def spec_card_vs_cpu(dev, record, kv_dtype):
    """The verify route at llama-3-8b widths cut to 1 layer, f32, blocks
    of 128 (prompts of about 120: the windows cross a block edge), a
    bigram draft (the target's embedding, norm and head, 0 layers: it
    mostly guesses wrong), on the card (the kernels: the guard holds at
    block 128 and D 128) and on the CPU (the dense route): one greedy and
    one sampled row with a repetition penalty; every token and every
    acceptance and rollback equal. ``kv_dtype`` "bf16" is the plain pool
    (#11, phase 25), "int8" the int8 pool with int8 weights (#12 and #15,
    phase 27), where the pool codes that differ are counted too."""
    import dataclasses

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params, params_to
    from kubeinfer_tpu_torch.inference.weight_quant import quantize_params

    int8 = kv_dtype == "int8"
    tag = "[27]" if int8 else "[25]"
    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=CPU_CHECK_LAYERS)
    dcfg = dataclasses.replace(cfg, num_hidden_layers=0)
    rng = np.random.default_rng(27 if int8 else 25)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (119, 122)]
    kws = ({}, dict(temperature=0.8, top_k=50, top_p=0.9,
                    repetition_penalty=1.2, seed=3))
    p_cpu = init_params(cfg, seed=27 if int8 else 25, dtype=torch.float32,
                        device="cpu")
    if int8:
        p_cpu = quantize_params(p_cpu)
    kernel = fa.decode_attention_blocks_q8 if int8 else \
        fa.decode_attention_blocks

    def run(q, device):
        d = {key: q[key] for key in ("embed_tokens", "norm", "lm_head")}
        d["layers"] = []
        cont = ContinuousEngine(q, cfg, n_slots=2, cache_len=256,
                                block_size=128, kv_dtype=kv_dtype,
                                weight_dtype=kv_dtype, spec_draft=(d, dcfg),
                                spec_k=4, device=device).start()
        try:
            out = in_threads(lambda i: cont.generate(prompts[i],
                                                     SPEC_CHECK_NEW,
                                                     **kws[i]), [0, 1])
        finally:
            cont.stop()
        return out, cont

    t0 = time.perf_counter()
    want, c_cpu = run(p_cpu, "cpu")
    host_s = time.perf_counter() - t0
    kernel.launches = 0
    got, c_card = run(params_to(p_cpu, dev), dev)
    launches = kernel.launches
    st, st_cpu = c_card.scheduler_stats(), c_cpu.scheduler_stats()
    keys = ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks")
    counters = {key: st[key] for key in keys}
    check(got == want and launches > 0 and st["spec_rollbacks"] > 0
          and counters == {key: st_cpu[key] for key in keys}
          and c_card.quant_blocks_total == c_cpu.quant_blocks_total,
          f"{tag} {kv_dtype} verify, card {got} != CPU {want} (counters "
          f"{counters}, CPU {st_cpu}, {kernel.__name__} {launches})")
    rec = {"host_s": host_s, "counters": counters, "streams": got}
    codes = ""
    if int8:
        pages = (c_card._state.q8_pages.cpu(), c_cpu._state.q8_pages)
        diff = (pages[0].int() - pages[1].int()).abs()
        rec["pool_codes_differing"] = n_diff = int((diff > 0).sum())
        codes = (f", quant_blocks_total {c_card.quant_blocks_total} on both;"
                 f" int8 pool codes that differ: {n_diff} of {diff.numel()}")
    pool = ("int8 weights + int8 KV" if int8 else "the plain pool") + \
        " (block 128, prompts of 119 and 122)"
    print(f"{tag} llama-3-8b widths, {CPU_CHECK_LAYERS} layer, f32, {pool}, "
          f"a bigram draft, "
          f"spec_k 4: greedy + sampled (with a repetition penalty) streams "
          f"on the card ({kernel.__name__} {launches} launches) equal to "
          f"device='cpu' (host {host_s:.1f} s), with equal verify counters "
          f"{counters}{codes}")
    record[f"spec_{kv_dtype}_card_vs_cpu"] = rec


AGENT_LAYERS = 4  # (33): llama-3-8b width at 4 layers, about 3.85 GB bf16
AGENT_TOKEN = "chip-smoke-agent-token"
AGENT_SERVICE = "chip-smoke-native"
AGENT_MODEL = "chip-smoke/llama-3-8b-4l"


def card_memory():
    """(free, total) bytes of card 0 from ``cudaMemGetInfo``: every
    process's allocations count, the spawned servers' too."""
    import torch

    return torch.cuda.mem_get_info(0)


def hf_config(cfg) -> dict:
    """A llama ``config.json`` for ``cfg``."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_position_embeddings,
            "tie_word_embeddings": False, "hidden_act": "silu",
            "torch_dtype": "bfloat16"}


def hf_tensors(params) -> dict:
    """The port's tree under HF llama names, each projection ``[out, in]``
    as a torch checkpoint stores it, in layer order."""
    out = {"model.embed_tokens.weight": params["embed_tokens"]}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = layer["input_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[p + f"self_attn.{n}.weight"] = layer[n].T
        out[p + "post_attention_layernorm.weight"] = \
            layer["post_attention_layernorm"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[p + f"mlp.{n}.weight"] = layer[n].T
    out["model.norm.weight"] = params["norm"]
    out["lm_head.weight"] = params["lm_head"].T
    return out


def write_shard(path, tensors) -> int:
    """One ``.safetensors`` file written with json and numpy alone (the
    card's machine has no ``safetensors``): the 8-byte little-endian
    header length, the JSON header, then each bf16 buffer as its int16
    bits, copied off the card one tensor at a time. Returns its bytes."""
    import torch

    header, off = {}, 0
    for name, t in tensors.items():
        check(t.dtype == torch.bfloat16, f"{name}: {t.dtype}, not bf16")
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).cpu().numpy().data)
    return 8 + len(raw) + off


def write_hf_checkpoint(root, params, cfg, shards=2) -> int:
    """``config.json`` and ``shards`` bf16 shards of ``params`` split at
    even bytes, in name order; returns the shards' bytes."""
    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(hf_config(cfg)))
    tensors = hf_tensors(params)
    total = sum(t.numel() * 2 for t in tensors.values())
    parts, cur, acc = [], {}, 0
    for name, t in tensors.items():
        cur[name] = t
        acc += t.numel() * 2
        if acc >= total * (len(parts) + 1) / shards and len(parts) < \
                shards - 1:
            parts.append(cur)
            cur = {}
    parts.append(cur)
    return sum(write_shard(root / f"model-{i + 1:05d}-of-{shards:05d}"
                           ".safetensors", part)
               for i, part in enumerate(parts))


def same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}.get(a.dtype)
    return torch.equal(a.view(view), b.view(view)) if view else \
        torch.equal(a, b)


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def trees_bitwise(got, want, what):
    g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
    check(sorted(g) == sorted(w), f"{what}: leaves {sorted(g)} != "
          f"{sorted(w)}")
    bad = [n for n in w if not same_bits(g[n], w[n])]
    check(not bad, f"{what}: {len(bad)} leaves differ, first {bad[:3]}")
    return len(w)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def checkpoint_phase(dev, record, cfg, root):
    """(33a): the checkpoint written from ``init_params(cfg, seed=0)``,
    loaded bitwise (bf16; int8 against ``quantize_weight`` on the card),
    saved and restored bitwise. Returns (the mirror dir, its bytes, the
    bytes of the int8 tree a ``--weight-dtype int8`` server holds)."""
    import torch

    from kubeinfer_tpu_torch.inference import checkpoint as ck
    from kubeinfer_tpu_torch.inference import weights
    from kubeinfer_tpu_torch.inference.config import ModelConfig
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.weight_quant import (
        QUANT_LEAVES,
        quantize_weight,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    check(ModelConfig.from_hf_dict(hf_config(cfg)) == cfg,
          "config.json does not round-trip the configuration")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    mirror = root / "mirror"
    nbytes, write_s = timed(lambda: write_hf_checkpoint(mirror, params, cfg))
    (got, gcfg), load_s = timed(lambda: weights.load_pretrained(
        str(mirror), device=dev))
    check(gcfg == cfg, f"load_pretrained's config {gcfg}")
    n = trees_bitwise(got, params, "(33a) load_pretrained bf16")
    del got
    (q, _), q_load_s = timed(lambda: weights.load_pretrained(
        str(mirror), weight_dtype="int8", device=dev))
    nq = 0
    for i, layer in enumerate(q["layers"]):
        for name in QUANT_LEAVES:
            want = quantize_weight(params["layers"][i][name])
            check(same_bits(layer[name]["qw"], want["qw"])
                  and same_bits(layer[name]["scale"], want["scale"]),
                  f"(33a) int8 layer {i} {name}: codes or scales differ "
                  "from quantize_weight on the card")
            nq += 1
        for name, leaf in layer.items():
            if name not in QUANT_LEAVES:
                check(same_bits(leaf, params["layers"][i][name]),
                      f"(33a) int8 load: layer {i} {name} differs")
    for name in ("embed_tokens", "norm", "lm_head"):
        check(same_bits(q[name], params[name]), f"(33a) int8 load: {name}")
    times = {}
    for label, tree in (("bf16", params), ("int8", q)):
        path = root / f"ck-{label}"
        _, times[f"save_{label}_s"] = timed(
            lambda: ck.save_checkpoint(str(path), tree, cfg, step=33))
        (back, bcfg, step), times[f"restore_{label}_s"] = timed(
            lambda: ck.restore_checkpoint(str(path), device=dev))
        check(bcfg == cfg and step == 33, f"(33a) {label} restore meta")
        trees_bitwise(back, tree, f"(33a) {label} save/restore")
        times[f"{label}_bytes"] = tree_bytes(tree)
        del back
        shutil.rmtree(path)
    int8_bytes = times["int8_bytes"]
    del params, q
    gb = nbytes / 1e9
    print(f"[33a] llama-3-8b width at {cfg.num_hidden_layers} layers: "
          f"{gb:.3f} GB of bf16 in 2 HF shards written in {write_s:.2f} s; "
          f"load_pretrained onto the card {load_s:.2f} s ({gb / load_s:.2f}"
          f" GB/s), {n} leaves bitwise the tensors written; int8 load "
          f"{q_load_s:.2f} s, the codes and scales of {nq} projections "
          f"bitwise quantize_weight's on the card; save/restore bitwise "
          f"(bf16 {times['save_bf16_s']:.2f} s / "
          f"{times['restore_bf16_s']:.2f} s, int8 "
          f"{times['save_int8_s']:.2f} s / {times['restore_int8_s']:.2f} "
          "s; warm page cache)")
    record["agent_checkpoint"] = {
        "bytes": nbytes, "write_s": write_s, "load_s": load_s,
        "load_gb_s": gb / load_s, "int8_load_s": q_load_s, "leaves": n,
        "int8_projections": nq, **times}
    return mirror, nbytes, int8_bytes


def agent_bodies(V, long=True):
    """The bodies of (14): 4 greedy 512-token prompts (two share 256
    tokens) and 1 sampled, 64 new; with ``long`` a 4100-token prompt (16
    new) for the engine route. The sampled body is (14)'s (top_k 50,
    top_p 0.9): ``sampled_tie`` judges both filters' edges."""
    rng = np.random.default_rng(33)
    shared = rng.integers(1, V, 256).tolist()
    bodies = [dict(prompt=shared + rng.integers(1, V, 256).tolist(),
                   max_tokens=64) for _ in range(2)]
    bodies += [dict(prompt=rng.integers(1, V, 512).tolist(), max_tokens=64)
               for _ in range(2)]
    bodies.append(dict(prompt=rng.integers(1, V, 512).tolist(),
                       max_tokens=64, temperature=0.8, top_k=50, top_p=0.9,
                       seed=7))
    if long:
        bodies.append(dict(prompt=rng.integers(1, V, 4100).tolist(),
                           max_tokens=16))
    return bodies


def port_open(port) -> bool:
    import socket

    with socket.socket() as s:
        s.settimeout(0.5)
        return s.connect_ex(("127.0.0.1", port)) == 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def agent_phase(dev, record, card):
    """Phase (33): the node's model path on the card. (33a) the checkpoint
    (``checkpoint_phase``); (33b) the manager in-process (its device the
    card) and two ``python -m kubeinfer_tpu_torch.agent`` processes
    (node-0 bf16, node-1 ``--kv-dtype int8 --weight-dtype int8``) bring a
    ``runtime: native`` LLMService with a shared cache to Running: the
    coordinator's ``hub_download`` runs ``huggingface-cli`` (a shim first
    on PATH that copies the mirror), the follower pulls from the
    coordinator's model server, and each spawned server loads its node's
    cache dir onto the card (the card's free memory, read in this
    process, falls by at least the weights each holds as it goes Ready:
    the checkpoint's bytes in bf16, the int8 tree's in int8); the bodies of (14) over HTTP, one at a time, on each
    spawned server (the 4100-token prompt on the bf16 one only); (33c)
    SIGTERM: both agents exit 0, the serving ports close, the memory
    returns; then in-process servers built by
    ``server.build_server(["--model", <the same cache dir>, ...])`` take
    the same bodies with #11 (bf16), #12 and #15 (int8), #9 and #10 (the
    engine route) held against their plain versions on every call and
    counted; their streams equal the spawned servers' up to [25]'s
    near-tie rule. Returns the launches: the tick's (#1-#8) while the
    agents ran, and the in-process servers' (#9-#12, #15)."""
    import dataclasses
    import filecmp
    import gc
    import os
    import signal
    import threading

    import torch

    from kubeinfer_tpu_torch.agent.node_agent import model_cache_dir
    from kubeinfer_tpu_torch.api.workload import NodeState
    from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.manager import Manager, ManagerConfig
    from kubeinfer_tpu_torch.solver import kernels

    t_phase = time.perf_counter()
    cpu = dev.type == "cpu"  # a rehearsal: every process on the CPU
    # every tokenizer lookup is of a local directory: never the hub
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    # the in-process servers' _load_tokenizer imports transformers (where
    # it is installed) once for this process: imported meanwhile, on a
    # thread, its seconds stay off (33c)
    warm: dict = {}
    warm_thread = threading.Thread(target=import_seconds,
                                   args=("transformers", warm), daemon=True)
    warm_thread.start()
    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=AGENT_LAYERS)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-agent-"))
    repo = str(pathlib.Path(__file__).resolve().parent)
    agents: list = []
    mgr = None
    try:
        # (33b) the manager and the two agents, started first: their
        # processes come up while (33a) runs (the probe's CUDA context in
        # each is there before the card's free memory is first read)
        mirror = root / "mirror"
        bin_dir = root / "bin"
        bin_dir.mkdir()
        stamps = root / "download.json"
        shim = bin_dir / "huggingface-cli"
        shim.write_text(
            f"#!{sys.executable}\n"
            "import json, shutil, sys, time\n"
            "t0 = time.time()\n"
            "a = sys.argv[1:]\n"
            "assert a[0] == 'download', a\n"
            f"shutil.copytree({str(mirror)!r}, "
            "a[a.index('--local-dir') + 1], dirs_exist_ok=True)\n"
            f"open({str(stamps)!r}, 'w').write(json.dumps("
            "[t0, time.time()]))\n")
        shim.chmod(0o755)
        (root / "token").write_text(AGENT_TOKEN)
        reset_counts(kernels)
        mgr = Manager(ManagerConfig(
            store_bind_port=0, metrics_bind_port=0, health_bind_port=0,
            auth_token=AGENT_TOKEN, tick_interval_s=0.3,
            device="cpu" if cpu else None)).start()
        remote = RemoteStore(mgr.store_address, token=AGENT_TOKEN)
        ports = [free_port(), free_port()]
        envs = []
        for i, port in enumerate(ports):
            extra = ["--kv-dtype int8 --weight-dtype int8"] if i else []
            env = dict(
                os.environ, PYTHONPATH=os.pathsep.join(
                    [repo] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]),
                NODE_NAME=f"node-{i}", STORE_ADDR=mgr.store_address,
                STORE_TOKEN_FILE=str(root / "token"),
                MODEL_PATH=str(root / f"node-{i}"), GPU_CAPACITY="1",
                AUTO_DETECT_ACCELERATORS="1", START_RUNTIMES="1",
                HEARTBEAT_INTERVAL_S="0.3", LEASE_DURATION_S="2",
                LEASE_RENEW_S="1", LEASE_RETRY_S="0.2",
                VLLM_PORT=str(port), VLLM_HOST="127.0.0.1",
                VLLM_HEALTH_TIMEOUT_S="120",
                VLLM_EXTRA_ARGS=" ".join(extra + (["--device cpu"] if cpu
                                                  else [])),
                PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
            envs.append(env)
            with open(root / f"agent-{i}.log", "w") as log:
                # its own session: the agent and the server it spawns are
                # one process group, killed together in the finally below
                agents.append(subprocess.Popen(
                    [sys.executable, "-m", "kubeinfer_tpu_torch.agent"],
                    cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        t_agents = time.perf_counter()
        # (33a)
        _, nbytes, int8_bytes = checkpoint_phase(dev, record, cfg, root)
        # the weights each spawned server holds: node-0 the checkpoint's
        # bf16 tensors, node-1 its int8 tree (codes, scales, bf16 rest)
        held = {"node-0": nbytes, "node-1": int8_bytes}
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter() - t_agents

        total = card_memory()[1]

        def probed():
            got = {d["metadata"]["name"]: NodeState.from_dict(d)
                   for d in remote.list("Node")}
            return len(got) == 2 and all(
                n.gpu_memory_bytes == total and n.gpu_capacity == 1
                for n in got.values())

        wait_until(probed, "both agents' heartbeats with the probed memory",
                   timeout=120)
        free0 = card_memory()[0]
        caches = [pathlib.Path(model_cache_dir(str(root / f"node-{i}"),
                                               AGENT_MODEL))
                  for i in range(2)]
        t_apply = time.time()
        remote.create("LLMService", {
            "apiVersion": "ai.kubeinfer-tpu.io/v1", "kind": "LLMService",
            "metadata": {"name": AGENT_SERVICE, "namespace": "default"},
            "spec": {"model": AGENT_MODEL, "replicas": 2,
                     "gpuPerReplica": 1, "runtime": "native",
                     "cacheStrategy": "shared", "gpuMemory": "8Gi",
                     "schedulerPolicy": "jax-greedy"}})
        ready, first_file, synced = [], {}, {}
        deadline = time.time() + 240
        while True:
            now = time.time()
            for i, c in enumerate(caches):
                if i not in first_file and c.exists() and any(c.iterdir()):
                    first_file[i] = now
                if i not in synced and (c / ".kubeinfer-sync-complete"
                                        ).exists():
                    synced[i] = now
            names = {d["metadata"]["name"] for d in remote.list("Workload")}
            reps = remote.get("Workload", AGENT_SERVICE)["replicas"] \
                if AGENT_SERVICE in names else []
            failed = [r for r in reps if r.get("phase") == "Failed"]
            if failed:
                node = int(failed[0]["node"].rsplit("-", 1)[1])
                failed_replica_tail(envs[node], caches[node], repo)
                check(False, f"(33b) replica {failed[0]['index']} on "
                      f"{failed[0]['node']} went Failed")
            for r in reps:
                if r.get("phase") == "Ready" and r["node"] not in [
                        x[0] for x in ready]:
                    ready.append((r["node"], now, card_memory()[0]))
            phase = remote.get("LLMService", AGENT_SERVICE).get(
                "status", {}).get("phase")
            if len(ready) == 2 and phase == "Running":
                break
            check(now < deadline,
                  f"(33b) the service did not reach Running: {reps}")
            time.sleep(0.05)
        running_s = time.time() - t_apply
        check(sorted(r["node"] for r in reps) == ["node-0", "node-1"],
              f"(33b) placement {[r['node'] for r in reps]}")
        coord = [r for r in reps if r.get("podIP")]
        check(len(coord) == 1, f"(33b) {len(coord)} coordinators")
        c_node = int(coord[0]["node"].rsplit("-", 1)[1])
        f_node = 1 - c_node
        check(ready[0][0] == f"node-{c_node}",
              "(33b) the follower was Ready before the coordinator")

        def listing(d):
            return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                          if p.is_file() and not p.name.startswith("."))

        check(listing(caches[0]) == listing(caches[1]) == listing(mirror),
              "(33b) the caches hold other files than the checkpoint's")
        for name in listing(mirror):
            check(filecmp.cmp(caches[c_node] / name, caches[f_node] / name,
                              shallow=False),
                  f"(33b) the follower's {name} differs from the "
                  "coordinator's")
        for k, (node, _, free) in enumerate(ready):
            need = sum(held[n] for n, _, _ in ready[:k + 1])
            check(free0 - free >= need,
                  f"(33b) {k + 1} replicas Ready ({node} last) but the "
                  f"card's free memory fell by {(free0 - free) / 1e9:.3f} "
                  f"GB, under their {need / 1e9:.3f} GB of weights")
        dl = json.loads(stamps.read_text())
        times = {
            "download_s": dl[1] - dl[0],
            "coordinator_spawn_to_ready_s": ready[0][1] - dl[1],
            "follower_sync_s": synced[f_node] - first_file[f_node],
            "follower_spawn_to_ready_s": ready[1][1] - synced[f_node],
            "apply_to_running_s": running_s,
            "card_free_drop_gb": [(free0 - f) / 1e9 for _, _, f in ready],
        }
        # (between two polls on a small rehearsal: no rate)
        times["follower_sync_gb_s"] = (
            nbytes / 1e9 / times["follower_sync_s"]
            if times["follower_sync_s"] > 0 else float("nan"))
        print(f"[33b] {card}: the manager and 2 agents (node-{c_node} "
              f"coordinator, node-{f_node} follower): the service Running "
              f"{running_s:.1f} s after it was written; hub download (the "
              f"shim's copy) {times['download_s']:.2f} s; the follower's "
              f"sync {nbytes / 1e9:.3f} GB in {times['follower_sync_s']:.2f}"
              f" s ({times['follower_sync_gb_s']:.3f} GB/s, first file to "
              f"the sync marker, sha256 included); spawn to Ready: "
              f"coordinator {times['coordinator_spawn_to_ready_s']:.1f} s, "
              f"follower {times['follower_spawn_to_ready_s']:.1f} s; the "
              f"card's free memory fell by "
              f"{[round(x, 3) for x in times['card_free_drop_gb']]} GB as "
              f"each went Ready ({ready[0][0]} first; the weights: bf16 "
              f"{nbytes / 1e9:.3f} GB, int8 {int8_bytes / 1e9:.3f} GB); "
              f"the follower's files byte-equal to the coordinator's; "
              f"NodeStates report the probed {total / 2**30:.1f} GiB")

        # the bodies of (14), one at a time, on each spawned server
        V = cfg.vocab_size
        spawned = {}
        for i, port in enumerate(ports):
            bodies = agent_bodies(V, long=i == 0)
            t0 = time.perf_counter()
            resps = [post_json(port, b) for b in bodies]
            routes = [r["kubeinfer"]["route"] for r in resps]
            check(routes == ["continuous"] * 5 + ["engine"] * (i == 0),
                  f"(33b) node-{i} routes {routes}")
            for b, r in zip(bodies, resps):
                toks = r["choices"][0]["tokens"]
                check(len(toks) == b["max_tokens"]
                      and all(0 <= t < V for t in toks),
                      f"(33b) node-{i}: tokens out of range")
            spawned[i] = [r["choices"][0]["tokens"] for r in resps]
            times[f"node{i}_ttft_ms"] = resps[0]["kubeinfer"]["ttft_ms"]
            times[f"node{i}_http_s"] = time.perf_counter() - t0
        tick = {name: getattr(kernels, name).launches
                for name in TICK_LAUNCHES}
        check(all(tick[k] > 0 for k in ROUND_KERNELS),
              f"(33b) the tick did not run the pipelined loop: {tick}")
        print(f"[33b] the bodies of (14) over HTTP, one at a time: node-0 "
              f"(bf16) 5 on route continuous + 4100 tokens on route engine "
              f"in {times['node0_http_s']:.1f} s, first TTFT "
              f"{times['node0_ttft_ms']:.1f} ms; node-1 (int8) 5 in "
              f"{times['node1_http_s']:.1f} s, first TTFT "
              f"{times['node1_ttft_ms']:.1f} ms; the tick's launches while "
              f"the agents ran {tick}")

        # (33c) teardown
        t0 = time.perf_counter()
        for p in agents:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in agents]
        check(rcs == [0, 0], f"(33c) the agents exited {rcs}")
        wait_until(lambda: not any(port_open(p) for p in ports),
                   "(33c) the serving ports to close", timeout=30)
        mgr.stop()
        mgr = None
        wait_until(lambda: card_memory()[0] >= free0 - (256 << 20),
                   "(33c) the card's memory to return", timeout=30)
        times["teardown_s"] = time.perf_counter() - t0
        print(f"[33c] SIGTERM: both agents exited 0 in "
              f"{times['teardown_s']:.1f} s, the serving ports closed, the "
              f"card's free memory back to {card_memory()[0] / 1e9:.2f} GB "
              f"(before the replicas: {free0 / 1e9:.2f} GB)")

        # the same bodies on in-process servers over the same cache dirs
        warm_thread.join(120)
        times["transformers_import_s"] = warm.get("transformers")
        launches = dict(tick)
        for i in range(2):
            launches.update(inprocess_check(
                dev, times, caches[i], i, agent_bodies(V, long=i == 0),
                spawned[i], cpu))
        record["agent"] = {"times": times, "launches": launches,
                           "checkpoint_s": t_a,
                           "phase_s": time.perf_counter() - t_phase}
        print(f"[33] {time.perf_counter() - t_phase:.1f} s ((33a) "
              f"{t_a:.1f} s); launches {launches}")
        return launches
    finally:
        for p in agents:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(p.pid, signal.SIGKILL)
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=10)
        if mgr is not None:
            mgr.stop()
        shutil.rmtree(root, ignore_errors=True)


def inprocess_check(dev, times, cache, node, bodies, spawned, cpu):
    """(33c) ``server.build_server`` on ``cache`` with the spawned server's
    flags (node 1: int8), the same bodies one at a time with #11 (#12 and
    #15) and, on the engine route, #9 and #10 held against their plain
    versions on every call; the streams held to the spawned server's.
    Returns the launches."""
    import gc

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq

    int8 = node == 1
    flags = ["--kv-dtype", "int8", "--weight-dtype", "int8"] if int8 else []
    t0 = time.perf_counter()
    with Timed(server, "_load_tokenizer") as tok:
        srv, cont = server.build_server(
            ["--model", str(cache), "--port", "0", "--host", "127.0.0.1",
             "--batch-slots", "8", *flags,
             *(["--device", "cpu"] if cpu else [])], device=dev)
    cont.start()
    srv.start()
    build_s = time.perf_counter() - t0
    times[f"inproc{node}_tokenizer_s"] = sum(tok.ms) / 1e3
    checks = [attention_check(fa, int8)]
    if int8:
        # the projections' f32 copies kept: 4 bytes a weight, 3.5 GB here
        checks.append(CheckedMatmul(wq, keep_f32=True))
    else:
        checks.append(CheckedAttention(
            fa, "flash_attention_ragged", fa.flash_attention_ragged_plain,
            live=lambda q, k, v, off, ln: torch.ones(
                q.shape[0], dtype=torch.bool, device=q.device),
            weight=lambda q, k, v, off, ln: off))
        checks.append(CheckedAttention(
            fa, "decode_attention", fa.decode_attention_plain,
            live=lambda q, k, v, ln: ln > 0, weight=lambda q, k, v, ln: 0,
            walk=True, trim=True))
    label = f"(33c) node-{node} {'int8' if int8 else 'bf16'}"
    try:
        with contextlib.ExitStack() as stack:
            for c in checks:
                stack.enter_context(c)
            got = [post_json(srv.port, b)["choices"][0]["tokens"]
                   for b in bodies]
        out = {}
        for c in checks:
            if isinstance(c, CheckedMatmul):
                c.all_tc(label)
                out["quant_matmul"] = c.launches
                continue
            check(c.error is None, f"{label} {c.error}")
            check(c.calls > 0 and c.launches == c.calls,
                  f"{label} {c.name}: {c.launches} launches of "
                  f"{c.calls} checked calls")
            if c.walk:
                c.walk_check(label)
            if c.name == "flash_attention_ragged":
                check(c.tc_launches == c.calls,
                      f"{label} #9: {c.tc_launches} of {c.calls} calls on "
                      "the tensor-core route")
            out[c.name] = c.launches
        jobs = [(b["prompt"], {k: v for k, v in b.items()
                               if k not in ("prompt", "max_tokens")})
                for b in bodies]
        divs = held_pairs(label, spawned, got, jobs, cont.params, cont.cfg,
                          dev)
        times[f"inproc{node}_build_s"] = build_s
        times[f"inproc{node}_divergences"] = divs
        print(f"{label}: build_server on the cache dir {build_s:.1f} s "
              f"(the tokenizer lookup {sum(tok.ms) / 1e3:.2f} s of it; "
              f"transformers imported on a thread in "
              f"{times.get('transformers_import_s')} s, None: absent); "
              f"{len(bodies)} bodies, every call held against its plain "
              f"version, launches {out}; streams equal to the spawned "
              f"server's but for {divs} (near-ties by [25]'s rule)")
        return out
    finally:
        srv.stop()
        cont.stop()
        del srv, cont
        gc.collect()
        torch.cuda.empty_cache()


def import_seconds(name, out):
    """Import ``name``; ``out[name]`` = its seconds, None when it is not
    installed or fails to import."""
    import importlib

    t0 = time.perf_counter()
    try:
        importlib.import_module(name)
        out[name] = time.perf_counter() - t0
    except Exception:
        out[name] = None


def failed_replica_tail(env, cache_dir, repo):
    """A replica went Failed: the runtime sends its server's output to
    /dev/null, so run the same command in the foreground for up to 60 s
    and print the tail of its stderr."""
    from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig

    args = RuntimeConfig.from_env({**env, "RUNTIME_KIND": "native",
                                   "MODEL_PATH": str(cache_dir)}).build_args()
    args[args.index("--port") + 1] = str(free_port())
    try:
        tail = subprocess.run(args, capture_output=True, text=True,
                              timeout=60, cwd=repo, env=env).stderr
    except subprocess.TimeoutExpired as e:
        tail = e.stderr.decode(errors="replace") if isinstance(
            e.stderr, bytes) else (e.stderr or "")
    print(f"[33b] {' '.join(args)}: stderr tail:\n{tail[-4000:]}")


def main(placement_only=False) -> int:
    """The whole smoke test; ``placement_only`` (``--placement``) stops
    after [12] (the solver's four libraries, the placement and route
    phases, their entries of the kernels line)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubeinfer_tpu_torch.scheduler import (
        NativeGreedyBackend,
        SolveRequest,
        get_backend,
        solve_service_handler,
    )
    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.solver import kernels
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        _gang_repair,
        cost_field,
        seed_incumbents,
    )
    from kubeinfer_tpu_torch.solver.kernels import RANK_INF, mega_window
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    dev = torch.device("cuda")
    record: dict = {}
    t_main = time.perf_counter()

    # (0) the card
    card = card_line()
    record["card"] = card
    print(f"[0] card: {card}")

    # (1) the build, from this checkout's sources
    t0 = time.perf_counter()
    solver_libs = ["mega_solve", "round_ops", "auction", "route_pick"]
    built = _build.build_all(solver_libs + ([] if placement_only else [
        "flash_prefill", "quant_matmul",
        "flash_backward", "flash_prefill_tc", "flash_backward_tc",
        "decode_split", "quant_matmul_tc"]))
    for name in built:
        check(_build.load_kernel_library(name) is not None,
              f"{name} library did not load")
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    for name, (lib_path, report) in built.items():
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        print(f"[1] built {lib_path.name}; ptxas: {ptxas}")
    print(f"[1] {len(built)} libraries built in parallel in {build_s:.2f} s")

    # (2) kernel vs plain at the headline shape, three cases
    w = ScoreWeights()
    req10 = build_request(10000, 1000)
    cases = {}

    p_a, perm_a = problem_of(req10, dev)
    f_a = cost_field(p_a, w)
    asg0, gf0, mf0, _ = seed_incumbents(p_a, False)
    cases["fresh"] = (f_a, p_a.jobs, asg0, f_a.rankf, p_a.jobs.valid,
                      gf0, mf0, 64)

    req_g = build_request(10000, 1000, seed=1, gang_fraction=0.25)
    p_g, _ = problem_of(req_g, dev)
    f_g = cost_field(p_g, w)
    a0, g0, m0, _ = seed_incumbents(p_g, False)
    main_g = f_g.run(kernels.mega_rounds, p_g.jobs, a0, f_g.rankf,
                     p_g.jobs.valid, g0, m0, 64)[0]
    # unplace 10% of the non-gang jobs, then repair + fill as the solve does
    rng = np.random.default_rng(7)
    drop = torch.from_numpy(rng.random(main_g.shape[0]) < 0.1).to(dev)
    drop &= p_g.jobs.gang_id < 0
    asg_g, gf_g, mf_g = _gang_repair(p_g, torch.where(drop, -1, main_g))
    jobs_g = p_g.jobs
    rank_fill = torch.where((jobs_g.gang_id >= 0) & (asg_g < 0), RANK_INF,
                            f_g.rankf)
    fillable = (asg_g < 0) & jobs_g.valid & (jobs_g.gang_id < 0)
    W = mega_window(p_g.nodes.valid.shape[0], jobs_g.valid.shape[0])
    cases["gang_fill"] = (
        f_g, jobs_g, asg_g, rank_fill, fillable,
        torch.where(p_g.nodes.valid, gf_g, -1.0), mf_g, W + 1,
    )

    fresh_plain = f_a.run(kernels.mega_rounds, p_a.jobs, asg0, f_a.rankf,
                          p_a.jobs.valid, gf0, mf0, 64)[0]
    J10 = req10.num_jobs
    current = np.empty(J10, np.int32)
    current[perm_a] = fresh_plain[:J10].cpu().numpy()
    departed = rng.random(J10) < 0.1
    current[departed] = -1
    churn_gpu = req10.job_gpu.copy()
    churn_gpu[departed] = rng.integers(1, 8, int(departed.sum()))
    req_c = SolveRequest(**{**req10.__dict__, "job_gpu": churn_gpu,
                            "job_current_node": current})
    p_c, _ = problem_of(req_c, dev)
    f_c = cost_field(p_c, w)
    a_c, g_c, m_c, _ = seed_incumbents(p_c, True)
    cases["churn_seeded"] = (f_c, p_c.jobs, a_c, f_c.rankf, p_c.jobs.valid,
                             g_c, m_c, 64)

    def field_call(f, jobs, asg, rank, may, gfe, mfe, cap):
        return lambda fn: f.run(fn, jobs, asg, rank, may, gfe, mfe, cap)

    calls = {name: field_call(*c) for name, c in cases.items()}
    # the widest node axis the router sends to mega: N = 16384, W = 128,
    # 8 windows, R = 128 nodes a block
    wide, wide_c = dyadic_mega_inputs(14, 16384, 1024, dev)
    check(mega_window(16384, 1024) == 128, "16384 x 1024 is not W = 128")
    calls["wide_16384"] = lambda fn: fn(*wide, max_rounds=64, **wide_c)

    max_err = 0.0
    fresh_out = None
    walks = {}
    for name, call in calls.items():
        counter = torch.zeros(4, dtype=torch.int64, device=dev)
        kernels.mega_solve.walk_counter = counter
        ko = call(kernels.mega_solve)
        kernels.mega_solve.walk_counter = None
        po = call(kernels.mega_rounds)
        walk = call(kernels.mega_walk)
        torch.cuda.synchronize()
        walks[name] = counter.cpu().tolist()
        check(torch.equal(counter.cpu(), walk),
              f"{name}: the kernel's walk {walks[name]} != mega_walk's "
              f"{walk.tolist()}")
        check(walks[name][3] == 1 + 2 * walks[name][1],
              f"{name}: not two barriers a round and one a launch")
        err = max(
            float((ko[0] - po[0]).abs().max()),
            float((ko[1] - po[1]).abs().max()),
            float((ko[2] - po[2]).abs().max()),
        )
        max_err = max(max_err, err)
        same = (
            torch.equal(ko[0], po[0]) and torch.equal(ko[1], po[1])
            and torch.equal(ko[2], po[2]) and int(ko[3]) == int(po[3])
            and bool(ko[4]) == bool(po[4])
        )
        print(f"[2] {name}: kernel rounds={int(ko[3])} capped={bool(ko[4])} "
              f"placed={int((ko[0] >= 0).sum())} plain rounds={int(po[3])} "
              f"bitwise_equal={same} max_abs_err={err}; walk (windows, "
              f"rounds, fenced, barriers) {walks[name]} = mega_walk's")
        check(same, f"mega_solve != mega_rounds in case {name}")
        record[f"case_{name}"] = {"rounds": int(ko[3]),
                                  "capped": bool(ko[4]),
                                  "walk": walks[name]}
        if name == "fresh":
            fresh_out = ko

    # (3) the main path, counted
    backend = get_backend("jax-greedy")
    cpu_backend = get_backend("jax-greedy", "cpu")
    reset_counts(kernels)
    res = backend.solve(req10)
    res_g = backend.solve(req_g)
    bodies = {
        "32x8": handler_body(32, 8, 3, fractional=False),
        "1kx128": handler_body(1000, 128, 4, fractional=True),
    }
    handled = {k: solve_service_handler(b) for k, b in bodies.items()}
    launches = kernels.mega_solve.launches
    check(launches > 0, "the main path never launched mega_solve")
    round_on_32 = {k: getattr(kernels, k).launches for k in ROUND_KERNELS}
    check(all(round_on_32.values()),
          "/solve 32x8 (a 64x64 bucket) did not run the pipelined loop")
    placed = check_assignment(req10, res.assignment, "10kx1k", True)
    check_assignment(req_g, res_g.assignment, "10kx1k gang 0.25")
    for k, out in handled.items():
        b = bodies[k]
        hreq = SolveRequest(
            job_gpu=np.asarray(b["jobs"]["gpu"], np.float32),
            job_mem_gib=np.asarray(b["jobs"]["memGib"], np.float32),
            node_gpu_free=np.asarray(b["nodes"]["gpuFree"], np.float32),
            node_mem_free_gib=np.asarray(b["nodes"]["memFreeGib"],
                                         np.float32),
        )
        n_placed = check_assignment(
            hreq, np.asarray(out["assignment"], np.int32), f"/solve {k}"
        )
        check(n_placed == out["placed"], f"/solve {k}: placed miscounted")
        cpu_out = solve_service_handler(b, device="cpu")
        check(cpu_out["assignment"] == out["assignment"],
              f"/solve {k}: card and CPU assignments differ")
        path = "pipelined loop" if k == "32x8" else "mega"
        print(f"[3] /solve {k}: placed {out['placed']}/{len(out['assignment'])}"
              f" rounds {out['rounds']}, equal to the CPU solve ({path})")
    print(f"[3] /solve 32x8 ran the pipelined loop: launches {round_on_32}")
    t_cpu = time.perf_counter()
    res_cpu = cpu_backend.solve(req10)
    cpu_s = time.perf_counter() - t_cpu
    check(np.array_equal(res_cpu.assignment, res.assignment),
          "10kx1k: card and CPU assignments differ")
    kernels.mega_solve.launches = 0
    backend.solve(req10)
    launches_10k = kernels.mega_solve.launches
    print(f"[3] jax-greedy 10kx1k: placed {placed}/{J10} rounds {res.rounds}"
          f" mega_solve launches {launches} on the main path "
          f"({launches_10k} per 10kx1k solve); equal to the device='cpu' "
          f"solve ({cpu_s:.1f} s on the host)")
    record["main_path"] = {"launches": launches,
                           "launches_per_10k_solve": launches_10k,
                           "placed": placed, "rounds": res.rounds}

    # (4) times
    def p50_solve(req, reps):
        for _ in range(2):
            backend.solve(req)
        ms = [backend.solve(req) for _ in range(reps)]
        return (statistics.median(r.solve_ms for r in ms),
                statistics.median(r.extras["encode_ms"] for r in ms))

    p50_10k, enc_10k = p50_solve(req10, 20)
    req50 = build_request(50000, 1000)
    p50_50k, enc_50k = p50_solve(req50, 10)
    res50 = backend.solve(req50)
    check_assignment(req50, res50.assignment, "50kx1k")
    f, jobs, asg, rank, may, gfe, mfe, cap = cases["fresh"]
    kernel_ms = device_ms(lambda: calls["fresh"](kernels.mega_solve))
    events_ms = cuda_ms(lambda: calls["fresh"](kernels.mega_solve), reps=20)
    plain_ms = cuda_ms(lambda: calls["fresh"](kernels.mega_rounds), reps=3)
    # the kernel at 50k x 1k (65536 x 1024: 32 windows)
    p50k, _ = problem_of(req50, dev)
    f50 = cost_field(p50k, w)
    a50, g50, m50, _ = seed_incumbents(p50k, False)
    call50 = field_call(f50, p50k.jobs, a50, f50.rankf, p50k.jobs.valid,
                        g50, m50, 64)
    kernel50_ms = device_ms(lambda: call50(kernels.mega_solve))
    rounds50 = int(call50(kernels.mega_solve)[3])
    # per-layer split of one 10k x 1k solve: pack (host, above), one
    # host-to-device copy + views, the cost field, the mega loop
    buf, _, _, Jp, Np = pack_problem_arrays(
        **{k: v for k, v in req10.__dict__.items()}, job_perm=perm_a
    )
    unpack_ms = cuda_ms(lambda: unpack_problem(buf, Jp, Np, dev), reps=20)
    field_ms = cuda_ms(lambda: cost_field(p_a, w), reps=20)
    native = NativeGreedyBackend()
    native.warmup()
    native_ms = statistics.median(
        native.solve(req10).solve_ms for _ in range(5)
    )
    N, J = f.S.shape
    W = mega_window(N, J)
    rounds = int(fresh_out[3])
    # one grid barrier alone, on the kernel's grid
    plan = kernels.mega_plan(N, W, kernels._sm_count(dev))
    barrier_us = grid_barrier_us(plan.blocks)
    in_bytes = N * J * 4 + J * (6 * 4 + 1) + N * 4 * 4
    out_bytes = J * 4 + 2 * N * 4 + 8
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    rounds_bound_ms = (rounds * N * W * 4 + N * J * 4) / HBM_BYTES_PER_S * 1e3
    print(f"[4] {card}: p50 pack+solve 10kx1k {p50_10k:.3f} ms "
          f"(pack {enc_10k:.3f} ms), 50kx1k {p50_50k:.3f} ms "
          f"(pack {enc_50k:.3f} ms, placed {res50.placed}); native_p50_ms "
          f"{native_ms:.3f}; layers: copy+unpack {unpack_ms:.3f} ms, "
          f"cost field {field_ms:.3f} ms")
    print(f"[4] mega_solve 10kx1k: {kernel_ms:.4f} ms device time (a CUDA "
          f"graph of 20 launches; {events_ms:.4f} by CUDA events over "
          f"calls), {rounds} rounds, "
          f"{J // W} windows, {kernel_ms * 1e3 / max(rounds, 1):.2f} us a "
          f"round (the first kernel: {OLD_MEGA_MS} ms, "
          f"{OLD_MEGA_MS * 1e3 / 48:.1f} us a round over its 48, PERF.md); "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms (rounds x "
          f"window {rounds_bound_ms:.4f} ms); plan {plan._asdict()}; one "
          f"grid barrier {barrier_us:.3f} us; 50kx1k: {kernel50_ms:.4f} ms, "
          f"{rounds50} rounds, {p50k.jobs.valid.shape[0] // W} windows")
    record["times"] = {
        "p50_10k_ms": p50_10k, "pack_10k_ms": enc_10k,
        "p50_50k_ms": p50_50k, "pack_50k_ms": enc_50k,
        "placed_50k": res50.placed, "rounds_50k": res50.rounds,
        "mega_ms": kernel_ms, "mega_events_ms": events_ms,
        "mega_rounds": rounds,
        "windows": J // W, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "rounds_bound_ms": rounds_bound_ms, "barrier_us": barrier_us,
        "mega_plan": plan._asdict(), "mega_50k_ms": kernel50_ms,
        "mega_50k_rounds": rounds50, "native_p50_ms": native_ms,
        "cpu_solve_10k_s": cpu_s, "unpack_10k_ms": unpack_ms,
        "cost_field_10k_ms": field_ms,
    }

    phase_s = record["phase_s"] = {"[1] build": build_s,
                                   "[2]-[4]": time.perf_counter() - t_main
                                   - build_s}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    round_entries = phase("[5]-[7]", pipelined_phases, dev, backend,
                          cpu_backend, kernels, record, card)
    auction_entry = phase("[9]-[11]", auction_phases, dev, kernels, record,
                          card)
    route_entry = phase("[12]", route_phases, dev, kernels, record, card)
    tick_launches = phase("[29]", tick_phase, dev, kernels, record, card)
    auction_entry["tick_launches"] = tick_launches["auction_solve"]
    route_entry["tick_launches"] = tick_launches["route_pick"]
    serve_entries = int8_entries = train_entries = mask_entry = []
    agent_launches = tp_launches = sp_launches = moe_launches = {}
    if not placement_only:
        serve_entries = phase("[13]-[16]", serving_phases, dev, record, card)
        int8_entries = phase("[17]-[20]", int8_phases, dev, record, card)
        train_entries = phase("[21]-[23]", train_phases, dev, record, card)
        mask_entry = [phase("[24], [28]", masked_phase, dev, record, card)]
        phase("[25]-[28]", spec_phases, dev, record, card)
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        agent_launches = phase("[33]", agent_phase, dev, record, card)
        route_entry["fleet_launches"] = record["fleet"]["launches"][
            "route_pick"]
        gc.collect()
        torch.cuda.empty_cache()
        tp_launches = phase("(35)", tp_phase, dev, record, card)
        gc.collect()
        torch.cuda.empty_cache()
        sp_launches, moe_launches = phase("(36)", sp_moe_phase, dev, record,
                                          card)
    for name, sec in phase_s.items():
        print(f"[s] {name}: {sec:.1f} s")

    # (8) the kernels line
    kline = {"kernels": [{
        "name": "mega_solve",
        "route": "cuda",
        "source": "kubeinfer_tpu_torch/solver/csrc/mega_solve.cu",
        "replaces": "kubeinfer_tpu/solver/pallas_kernels.py:909",
        "launches": launches,
        "tick_launches": tick_launches["mega_solve"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "check": "bitwise equal to mega_rounds in 3 cases at 12288x1024 "
                 "(one with the W + 1 fill cap) and at 16384 nodes x 1024; "
                 "walk counts equal to mega_walk's",
    }, *round_entries, auction_entry, route_entry, *serve_entries,
        *int8_entries, *train_entries, *mask_entry]}
    for entry in kline["kernels"]:
        if entry["name"] in agent_launches:
            entry["agent_launches"] = agent_launches[entry["name"]]
        if entry["name"] in tp_launches:
            entry["tp_launches"] = tp_launches[entry["name"]]
        if entry["name"] in sp_launches:
            entry["sp_launches"] = sp_launches[entry["name"]]
        if entry["name"] in moe_launches:
            entry["moe_launches"] = moe_launches[entry["name"]]
    record.update(kline)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / ("placement.json" if placement_only else "chip_smoke.json")
     ).write_text(json.dumps(record, indent=1))
    print(json.dumps(kline))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def qmm_plan_sweep(dev, wq, layer, gen):
    """Device ms of the tensor-core kernel under each (rows, splits)
    plan at the llama-3-8b projections, launched through its library
    beside ``qmm_tc_plan``'s choice (marked "*"): the evidence for that
    rule. Each plan's output is held to the plain version."""
    import torch

    from kubeinfer_tpu_torch import _build

    lib = _build.load_kernel_library("quant_matmul_tc")
    rows_out = []
    for leaf, d in layer.items():
        K, N = d["qw"].shape
        for M in QMM_M:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            want = wq.quant_matmul_plain(x, d["qw"], d["scale"])
            k_tiles = -(-K // wq.TC_BK)
            chosen = wq.qmm_tc_plan(M, N, K)
            cells = []
            for rows in ((next(r for r in wq.TC_DECODE_ROWS if M <= r),)
                         if M <= wq.TC_DECODE_ROWS[-1] else (128, 256)):
                for splits in (1, 2, 4, 8, 16):
                    per = -(-k_tiles // splits)
                    if -(-k_tiles // per) != splits:
                        continue
                    tiles = -(-M // rows) * -(-N // wq.TC_BN)
                    ws = torch.empty(splits * M * N, dtype=torch.float32,
                                     device=dev)
                    tk = torch.zeros(tiles, dtype=torch.int32, device=dev)
                    out = torch.empty((M, N), dtype=torch.bfloat16,
                                      device=dev)

                    def go(rows=rows, splits=splits, per=per, ws=ws, tk=tk,
                           out=out):
                        stream = torch.cuda.current_stream().cuda_stream
                        err = lib.quant_matmul_tc_launch(
                            x.data_ptr(), d["qw"].data_ptr(),
                            d["scale"].data_ptr(), out.data_ptr(),
                            ws.data_ptr(), tk.data_ptr(), M, N, K, rows,
                            splits, per, stream)
                        check(err == 0, f"quant_matmul_tc_launch: {err}")

                    go()
                    check(bool(matmul_err(out, want)[1]),
                          f"plan r{rows} s{splits} on {leaf} M {M}")
                    ms = device_ms(go)
                    mark = "*" if (rows, splits) == chosen[:2] else ""
                    cells.append(f"r{rows}s{splits}{mark} {ms:.4f}")
                    rows_out.append(dict(leaf=leaf, M=M, rows=rows,
                                         splits=splits, ms=ms,
                                         chosen=bool(mark)))
            print(f"[qmm] plans, {leaf} M {M} (device ms; * = qmm_tc_plan): "
                  + "; ".join(cells))
    return rows_out


def placement_p50s() -> int:
    """``--p50s``: the placement p50s of [4], [7] and [11] alone, as one
    JSON line (card only; about 40 s). For a parent/change comparison in
    one chip call, run it from each tree's root in turns (the package it
    times is the one beside this file)."""
    from kubeinfer_tpu_torch.scheduler import get_backend

    greedy, auction = get_backend("jax-greedy"), get_backend("jax-auction")
    out = {"card": card_line()}
    for label, be, req, reps in (
        ("[4] 10kx1k", greedy, build_request(10000, 1000), 20),
        ("[4] 50kx1k", greedy, build_request(50000, 1000), 10),
        ("[7] 10kx20k", greedy, build_request(10000, 20000, seed=5), 10),
        ("[11] auction 1kx1k", auction, whole_node_request(1000, 1000), 25),
    ):
        for _ in range(2):
            be.solve(req)
        out[label] = statistics.median(be.solve(req).solve_ms
                                       for _ in range(reps))
    print(json.dumps(out))
    return 0


def qmm_probe() -> int:
    """``--qmm``: #15 alone (card only; about a minute): builds both of
    its libraries, holds the kernel to its plain version at the
    llama-3-8b projections (random seeded weights, quantized on the
    card) for M in ``QMM_M`` and twice for the same bits, prints the
    times ``time_qmm`` takes on the path's layer 0, and the sweep of
    (rows, splits) plans that ``qmm_tc_plan`` was read off."""
    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import weight_quant as wq

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    for name, (path, report) in _build.build_all(
            ["quant_matmul", "quant_matmul_tc"]).items():
        print(f"[qmm] built {path.name}; ptxas: " + "; ".join(
            ln.strip() for ln in report.splitlines()
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln))
    gen = torch.Generator(device=dev).manual_seed(15)
    layer = {}
    for leaf, (K, N) in (("q_proj", (4096, 4096)), ("k_proj", (4096, 1024)),
                         ("gate_proj", (4096, 14336)),
                         ("down_proj", (14336, 4096))):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        layer[leaf] = wq.quantize_weight(w)
        del w
    chk = CheckedMatmul(wq)
    with torch.inference_mode(), chk:
        for leaf, d in layer.items():
            K = d["qw"].shape[0]
            for M in (*QMM_M, 77):
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                got = wq.quant_matmul(x, d["qw"], d["scale"])
                again = wq.quant_matmul(x, d["qw"], d["scale"])
                check(torch.equal(got, again), f"{leaf} M {M}: two calls "
                      "differ")
    torch.cuda.synchronize()
    routes = chk.all_tc("[qmm]")
    print(f"[qmm] {chk.calls} calls within tolerance of the plain version, "
          f"max |kernel - plain| {chk.max_err:.3e}, routes {routes}; "
          f"repeated calls bitwise equal")
    record = {}
    with torch.inference_mode():
        entry = time_qmm(dev, wq, chk, card, {"quant_matmul": chk.launches},
                         layer, record)
        sweep = qmm_plan_sweep(dev, wq, layer, gen)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "qmm_probe.json").write_text(json.dumps(
        {"card": card, "entry": entry, "plans": sweep}, indent=1))
    print(card)
    return 0


def disagg_probe() -> int:
    """``--disagg``: phase (30) alone (card only; about two minutes):
    builds the decode and #15 libraries, then the bf16 server of (13) and
    the int8 server of (17), each in turn the prefill replica of
    ``disagg_phase``."""
    import gc

    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import server

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["decode_split", "quant_matmul", "quant_matmul_tc"])
    record = {"card": card}
    argv = ["--model", "llama-3-8b", "--random-init", "--port", "0",
            "--host", "127.0.0.1", "--batch-slots", "8", *observe_flags()]
    for flags in ([], ["--kv-dtype", "int8", "--weight-dtype", "int8"]):
        srv, cont = server.build_server(argv + flags)
        cont.start()
        srv.start()
        try:
            disagg_phase(dev, record, card, srv, cont)
        finally:
            srv.stop()
            cont.stop()
        del srv, cont
        gc.collect()
        torch.cuda.empty_cache()
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "disagg_probe.json").write_text(json.dumps(record, indent=1))
    print(record["phase_s"])
    print(card)
    return 0


def migrate_probe() -> int:
    """``--migrate``: phase (31) alone (card only): builds the decode and
    #15 libraries, then the bf16 server of (13) with a decode replica
    beside it ((31b), then (31a) and (31a2) on its parameter tensors), then
    the int8 server of (17) with its own ((31c))."""
    import gc

    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import server

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["decode_split", "quant_matmul", "quant_matmul_tc"])
    record = {"card": card}
    argv = ["--model", "llama-3-8b", "--random-init", "--port", "0",
            "--host", "127.0.0.1", "--batch-slots", "8", *observe_flags()]
    for flags in ([], ["--kv-dtype", "int8", "--weight-dtype", "int8"]):
        srv, cont = server.build_server(argv + flags)
        cont.start()
        srv.start()
        try:
            dec_srv, dec = decode_replica(dev, srv, cont)
            try:
                launches = migrate_phase(dev, record, card, srv, cont,
                                         dec_srv, dec)
            finally:
                dec_srv.stop()
                dec.stop()
            del dec_srv, dec
            if not flags:
                launches.update(preempt_phases(dev, record, card, cont.params,
                                               cont.cfg, cont.cache_len))
            record.setdefault("launches", {}).update(launches)
        finally:
            srv.stop()
            cont.stop()
        del srv, cont
        gc.collect()
        torch.cuda.empty_cache()
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "migrate_probe.json").write_text(json.dumps(record, indent=1))
    print(record["phase_s"])
    print(card)
    return 0


def fleet_probe() -> int:
    """``--fleet``: phase (34) alone (card only): builds the route pick and
    decode libraries, then the bf16 server of (13), and runs
    ``fleet_on_cut`` over it."""
    import gc

    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import server

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["route_pick", "decode_split"])
    record = {"card": card}
    srv, cont = server.build_server(
        ["--model", "llama-3-8b", "--random-init", "--port", "0", "--host",
         "127.0.0.1", "--batch-slots", "8", *observe_flags()])
    cont.start()
    srv.start()
    try:
        fleet_on_cut(dev, record, card, srv, cont)
    finally:
        srv.stop()
        cont.stop()
    del srv, cont
    gc.collect()
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fleet_probe.json").write_text(json.dumps(record, indent=1))
    print(record["phase_s"])
    print(card)
    return 0


def observe_probe() -> int:
    """``--observe``: phase (32) alone (card only): builds the decode and
    #15 libraries, then the bf16 server of (13) and the int8 server of
    (17), with their observability flags, each in turn fresh."""
    import gc

    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import server

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["decode_split", "quant_matmul", "quant_matmul_tc",
                      "flash_prefill", "flash_prefill_tc"])
    record = {"card": card}
    argv = ["--model", "llama-3-8b", "--random-init", "--port", "0",
            "--host", "127.0.0.1", "--batch-slots", "8", *observe_flags()]
    for flags in ([], ["--kv-dtype", "int8", "--weight-dtype", "int8"]):
        srv, cont = server.build_server(argv + flags)
        cont.start()
        srv.start()
        try:
            record.setdefault("launches", {}).update(
                observe_phase(dev, record, card, srv, cont))
        finally:
            srv.stop()
            cont.stop()
        del srv, cont
        gc.collect()
        torch.cuda.empty_cache()
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "observe_probe.json").write_text(json.dumps(record, indent=1))
    print(record["phase_s"])
    print(card)
    return 0


TP_LAYERS = 8  # (35): llama-3-8b width at 8 of its 32 layers
TP_NEW = 32  # new tokens of each (35a)/(35b) request
TP8_NEW = 16  # (35c): new tokens of the tp=8 request
TP_ENGINE_PROMPT = 8180  # (35d): past the batcher's 4096 and the draft's
TP_KERNELS = ("flash_attention_ragged", "decode_attention",
              "decode_attention_blocks", "decode_attention_blocks_q8",
              "quant_matmul")


def tp_engine(cfg, params, tp, kv, dev):
    """(35)'s continuous engine: [13]'s slot geometry (8 slots over a
    4096-token row, blocks of 128), at tp=1 on ``dev`` or over ``tp``
    ranks of cuda:0 (``EngineLayout.build(tp, ["cuda:0"] * tp)``),
    started."""
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.sharding import EngineLayout

    return ContinuousEngine(
        params, cfg, n_slots=8, cache_len=4096, block_size=128,
        prefill_chunk_blocks=4, kv_dtype=kv, weight_dtype=kv,
        layout=EngineLayout.build(tp, [dev] * tp) if tp > 1 else None,
        device=None if tp > 1 else dev).start()


def tp_serve(cont, jobs, new):
    """The jobs' streams, all in flight together."""
    return in_threads(lambda j: cont.generate(j[0], new, timeout=600, **j[1]),
                      jobs)


def pool_ranks(cont):
    """{data_ptr of a tp rank's pool piece: rank} over every layer."""
    return {p.data_ptr(): r for c in cont._state.caches_k
            for r, p in enumerate(c)}


def code_ranks(sp):
    """{data_ptr of a tp rank's int8 codes: rank} over every leaf."""
    from kubeinfer_tpu_torch.inference import weight_quant as wq

    return {leaf["qw"].data_ptr(): r for r, shard in enumerate(sp.shards)
            for layer in shard["layers"] for leaf in layer.values()
            if wq.is_quant_leaf(leaf)}


def tp_phase(dev, record, card):
    """Phase (35): tensor parallelism on one H100, llama-3-8b at full width
    cut to ``TP_LAYERS`` layers, ``init_params(seed=0)``, the tp ranks
    repeated ``cuda:0`` devices (the port's single-process mesh; two cards
    are not measured).

    - (35a) bf16 ``ContinuousEngine`` at tp=1 and tp=2 on [14]'s kind of
      traffic (four greedy 512-token prompts and a sampled one, TP_NEW new
      tokens): the tp=2 streams the tp=1 ones up to [25]'s near-tie rule
      (``held_pairs``), every #11 call held to its plain version on its
      shard, launches tallied by the rank whose pool they read; decode ms
      a token a slot at both.
    - (35b) the same on the int8 pool with int8 weights: #12 and every
      #15 call held on their shards; #15's device time at each shard
      shape beside the tp=1 shape.
    - (35c) tp=8 bf16 (n_kv == tp: one KV head a rank), one greedy
      16-token prompt.
    - (35d) ``build_server([... "--tensor-parallel-size", "2",
      "--draft-model", ...], mesh=...)`` over HTTP: a verify-window
      request (#11 at T = k + 1 a rank) and an engine-route request (#9,
      #10 a rank), both against tp=1, and the tp gauges; a tp=2 server
      without a mesh on one card raises.

    Returns {kernel: launches on the tp path}."""
    import dataclasses
    import gc

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.sharding import make_inference_mesh

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=TP_LAYERS)
    V = cfg.vocab_size
    rng = np.random.default_rng(35)
    sampled = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    jobs = [(rng.integers(1, V, 512).tolist(), {}) for _ in range(4)]
    jobs.append((rng.integers(1, V, 512).tolist(), sampled))
    timed = [rng.integers(1, V, 512).tolist() for _ in range(4)]
    short = rng.integers(1, V, 16).tolist()
    long_prompt = rng.integers(1, V, TP_ENGINE_PROMPT).tolist()
    launches = collections.Counter()
    out = record["tp"] = {"layers": TP_LAYERS, "card": card}
    marks = out["phase_s"] = {}

    def mark(name, t0):
        marks[name] = time.perf_counter() - t0

    for kv in ("bf16", "int8"):
        tag = "(35a)" if kv == "bf16" else "(35b)"
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                             weight_dtype=kv)
        one = tp_engine(cfg, params, 1, kv, dev)
        try:
            with torch.inference_mode():
                want = tp_serve(one, jobs, TP_NEW)
                ms1 = decode_ms_per_token(one, timed, TP_NEW)
                want8 = one.generate(short, TP8_NEW) if kv == "bf16" else None
        finally:
            one.stop()
        del one
        two = tp_engine(cfg, params, 2, kv, dev)
        chk = attention_check(fa, kv == "int8")
        chk.ranks = pool_ranks(two)
        mm = CheckedMatmul(wq) if kv == "int8" else contextlib.nullcontext()
        if kv == "int8":
            mm.ranks = code_ranks(two.params)
        try:
            with torch.inference_mode(), chk, mm:
                try:
                    got = tp_serve(two, jobs, TP_NEW)
                finally:
                    check(chk.error is None, f"{tag} {chk.error}")
                    if kv == "int8":
                        check(mm.verify() is None, f"{tag} {mm.error}")
            walks = chk.walk_check(tag)
            with torch.inference_mode():
                ms2 = decode_ms_per_token(two, timed, TP_NEW)
        finally:
            two.stop()
        per_rank = [chk.per_rank[r] for r in range(2)]
        check(chk.per_rank[-1] == 0 and per_rank[0] == per_rank[1] > 0
              and chk.launches == chk.calls == sum(per_rank),
              f"{tag} {chk.name}: {chk.launches} launches, {chk.calls} "
              f"calls, by rank {dict(chk.per_rank)}")
        launches[chk.name] += chk.launches
        divs = held_pairs(tag, got, want, jobs, params, cfg, dev)
        entry = out[kv] = {
            chk.name: {"launches": chk.launches, "per_rank": per_rank,
                       "max_err": chk.max_err, "split_walk": walks},
            "decode_ms_per_token_slot": {"tp1": ms1, "tp2": ms2},
            "divergences": divs}
        print(f"{tag} {card}: llama-3-8b width, {TP_LAYERS} layers, {kv} "
              f"pool and weights, tp=2 over cuda:0 twice: 4 greedy + 1 "
              f"sampled 512-token prompts, {TP_NEW} new: streams equal to "
              f"tp=1 but {divs} (near-ties held); {chk.name} {chk.launches} "
              f"launches, {per_rank} a rank, every call within tolerance of "
              f"its plain version on its shard (max err {chk.max_err:.3e}),"
              f" split-K walk {walks[0]} = decode_split_walk's; decode ms a "
              f"token a slot: tp=1 {ms1:.2f}, tp=2 {ms2:.2f}")
        if kv == "int8":
            mm_ranks = [mm.per_rank[r] for r in range(2)]
            check(mm.per_rank[-1] == 0 and mm_ranks[0] == mm_ranks[1] > 0
                  and mm.launches == mm.calls == sum(mm_ranks),
                  f"{tag} #15: {mm.launches} launches, by rank "
                  f"{dict(mm.per_rank)}")
            launches["quant_matmul"] += mm.launches
            # #15's device time at the decode window's M (8 slots) on each
            # shard shape, beside the tp=1 shape of the same projection
            rows = []
            layer0 = [two.params.shards[0]["layers"][0], params["layers"][0]]
            for name in ("q_proj", "k_proj", "o_proj", "gate_proj",
                         "down_proj"):
                pair = []
                for leaf in (layer0[0][name], layer0[1][name]):
                    K, N = leaf["qw"].shape
                    x = torch.randn((8, K), dtype=torch.bfloat16, device=dev)
                    ms = device_ms(lambda: wq.quant_matmul(x, leaf["qw"],
                                                           leaf["scale"]))
                    pair.append({"K": K, "N": N, "ms": ms,
                                 "tc": wq.qmm_route(x, leaf["qw"]),
                                 "bound_ms": qmm_bound(8, N, K, 2)[0]})
                rows.append({"leaf": name, "tp2": pair[0], "tp1": pair[1]})
            entry["quant_matmul"] = {
                "launches": mm.launches, "per_rank": mm_ranks,
                "max_err": mm.max_err, "routes": dict(mm.routes),
                "shapes": {f"{m}x{k}x{n}": c
                           for (m, k, n), c in sorted(mm.shapes.items())},
                "device_ms_m8": rows}
            print(f"{tag} #15 {mm.launches} launches, {mm_ranks} a rank, "
                  f"routes {dict(mm.routes)}, every call within tolerance "
                  f"(max err {mm.max_err:.3e}); device ms at M 8, shard "
                  f"(tp=2) / whole (tp=1): " + "; ".join(
                      f"{r['leaf']} {r['tp2']['K']}x{r['tp2']['N']} "
                      f"{r['tp2']['ms']:.4f}{' tc' if r['tp2']['tc'] else ''}"
                      f" / {r['tp1']['K']}x{r['tp1']['N']} "
                      f"{r['tp1']['ms']:.4f}" for r in rows))
        del two
        mark(tag, t0)
        if kv == "bf16":
            t0 = time.perf_counter()
            # (35c) tp=8: one KV head a rank
            eight = tp_engine(cfg, params, 8, kv, dev)
            chk8 = attention_check(fa, False)
            chk8.ranks = pool_ranks(eight)
            try:
                with torch.inference_mode(), chk8:
                    try:
                        got8 = eight.generate(short, TP8_NEW)
                    finally:
                        check(chk8.error is None, f"(35c) {chk8.error}")
                with torch.inference_mode():
                    ms8 = decode_ms_per_token(eight, timed[:1], TP8_NEW)
            finally:
                eight.stop()
            del eight
            per8 = [chk8.per_rank[r] for r in range(8)]
            check(chk8.per_rank[-1] == 0 and len(set(per8)) == 1
                  and per8[0] > 0 and chk8.launches == sum(per8),
                  f"(35c) #11 by rank {dict(chk8.per_rank)}")
            launches[chk8.name] += chk8.launches
            divs8 = held_pairs("(35c)", [got8], [want8], [(short, {})],
                               params, cfg, dev)
            out["tp8"] = {"launches": chk8.launches, "per_rank": per8,
                          "max_err": chk8.max_err, "divergences": divs8,
                          "decode_ms_per_token_slot": ms8}
            print(f"(35c) tp=8 over cuda:0 eight times (one KV head a "
                  f"rank): a 16-token prompt, {TP8_NEW} new: equal to tp=1 "
                  f"but {divs8}; #11 {chk8.launches} launches, {per8[0]} a "
                  f"rank, within tolerance (max err {chk8.max_err:.3e}); "
                  f"decode ms a token (one slot live) {ms8:.2f}")
            mark("(35c)", t0)
            out["all_reduce"] = all_reduce_cost(dev)
            t0 = time.perf_counter()
            tp_server_check(dev, out, launches, cfg, params, jobs[0][0],
                            want[0], long_prompt)
            mark("(35d)", t0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if torch.cuda.device_count() < 2:
        try:
            server.build_server(["--model", "tiny", "--random-init",
                                 "--tensor-parallel-size", "2"])
        except ValueError as e:
            check("needs 2 devices, have 1" in str(e), f"(35) {e}")
            print(f"(35) --tensor-parallel-size 2 without a mesh on one "
                  f"card: ValueError({e})")
        else:
            check(False, "(35) a tp=2 server on one card without a mesh "
                  "did not raise")
    check(all(launches[k] > 0 for k in TP_KERNELS),
          f"(35) a kernel of the tp path never launched: {dict(launches)}")
    out["launches"] = dict(launches)
    marks["(35)"] = time.perf_counter() - t_phase
    print(f"(35) tp launches {dict(launches)}; times {marks}")
    return dict(launches)


def all_reduce_cost(dev):
    """``sharding.all_reduce`` of two bf16 partials at a decode step's
    [8, 1, 4096] and a 512-token admit's [1, 512, 4096]: device ms (a CUDA
    graph of 20) and the host's us a call, printed and returned."""
    import torch

    from kubeinfer_tpu_torch.inference.sharding import all_reduce

    rows = {}
    for shape in ((8, 1, 4096), (1, 512, 4096)):
        parts = [torch.randn(shape, dtype=torch.bfloat16, device=dev)
                 for _ in range(2)]
        rows["x".join(map(str, shape))] = {
            "device_ms": device_ms(lambda: all_reduce(parts)),
            "host_us": host_us(lambda: all_reduce(parts))}
    print(f"(35) sharding.all_reduce of two bf16 partials (f32 sum, one "
          f"cast): {rows}")
    return rows


def tp_server_check(dev, out, launches, cfg, params, prompt, want,
                    long_prompt):
    """(35d): the tp=2 server over a mesh of cuda:0 twice, built from the
    flags with (35)'s cut swapped in for the llama-3-8b preset, the draft
    the same cut seeded 1 and riding the batch (``--speculative-draft``):
    a greedy 512-token request on the verify route and a
    ``TP_ENGINE_PROMPT``-token request on the engine route, together over
    HTTP, every #9, #10 and #11 call held to its plain version; the
    streams against tp=1 (``want``, and the tp=1 ``Engine`` here); the
    gauges."""
    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.sharding import make_inference_mesh

    with torch.inference_mode():
        want_long = Engine(params, cfg, max_cache_len=8192,
                           device=dev).generate([long_prompt], 8)
    want_long = want_long.tokens[0].tolist()
    mesh = make_inference_mesh(tp=2, sp=1, dp=1, devices=["cuda:0"] * 2)
    full = PRESETS["llama-3-8b"]
    PRESETS["llama-3-8b"] = cfg
    try:
        srv, cont = server.build_server(
            ["--model", "llama-3-8b", "--random-init", "--port", "0",
             "--host", "127.0.0.1", "--batch-slots", "4",
             "--tensor-parallel-size", "2", "--draft-model", "llama-3-8b",
             "--speculative-draft", "--speculation-depth", "4"], mesh=mesh)
    finally:
        PRESETS["llama-3-8b"] = full
    cont.start()
    srv.start()
    chk9 = CheckedAttention(
        fa, "flash_attention_ragged", fa.flash_attention_ragged_plain,
        live=lambda q, k, v, off, ln: torch.ones(q.shape[0], dtype=torch.bool,
                                                 device=q.device),
        weight=lambda q, k, v, off, ln: off)
    chk10 = CheckedAttention(
        fa, "decode_attention", fa.decode_attention_plain,
        live=lambda q, k, v, ln: ln > 0, weight=lambda q, k, v, ln: 0,
        walk=True, trim=True)
    chk11 = attention_check(fa, False)
    chk11.ranks = pool_ranks(cont)
    bodies = [dict(prompt=prompt, max_tokens=TP_NEW),
              dict(prompt=long_prompt, max_tokens=8)]
    t0 = time.perf_counter()
    try:
        with torch.inference_mode(), chk9, chk10, chk11:
            try:
                resps = in_threads(lambda b: post_json(srv.port, b), bodies)
            finally:
                for c in (chk9, chk10, chk11):
                    check(c.error is None, f"(35d) {c.error}")
        http_s = time.perf_counter() - t0
        _, text, _ = get_text(srv.port, "/metrics")
        sched = cont.scheduler_stats()
    finally:
        srv.stop()
        cont.stop()
    gauges = metric_samples(text)
    routes = [r["kubeinfer"]["route"] for r in resps]
    check(routes == ["continuous", "engine"], f"(35d) routes {routes}")
    check(gauges.get("kubeinfer_engine_tp_degree") == 2.0
          and gauges.get("kubeinfer_mesh_devices") == 2.0,
          "(35d) the tp gauges")
    check(sched["spec_draft_tokens"] > 0 and sched["windows"] > 0,
          f"(35d) no verify window ran: {sched}")
    walks = {c.name: c.walk_check("(35d)") for c in (chk10, chk11)}
    check(chk9.calls > 0 and chk9.tc_launches == chk9.calls
          and chk10.calls > 0 and chk11.calls > 0
          and chk11.per_rank[0] == chk11.per_rank[1] > 0,
          f"(35d) #9 {chk9.calls} calls ({chk9.tc_launches} on tensor "
          f"cores), #10 {chk10.calls}, #11 by rank {dict(chk11.per_rank)}")
    toks = [r["choices"][0]["tokens"] for r in resps]
    divs = held_pairs("(35d)", toks, [want, want_long],
                      [(prompt, {}), (long_prompt, {})], params, cfg, dev)
    for c in (chk9, chk10, chk11):
        launches[c.name] += c.launches
    out["server"] = {
        "routes": routes, "http_s": http_s, "divergences": divs,
        "spec": {k: sched[k] for k in ("spec_draft_tokens",
                                       "spec_accepted_tokens", "windows")},
        "launches": {c.name: c.launches for c in (chk9, chk10, chk11)},
        "per_rank_11": [chk11.per_rank[0], chk11.per_rank[1]],
        "max_err": {c.name: c.max_err for c in (chk9, chk10, chk11)},
        "gauges": {k: gauges[k] for k in ("kubeinfer_engine_tp_degree",
                                          "kubeinfer_mesh_devices")}}
    print(f"(35d) build_server(--tensor-parallel-size 2, --draft-model, "
          f"--speculative-draft, mesh=cuda:0 twice) over HTTP in "
          f"{http_s:.1f} s: routes {routes}, streams equal to tp=1 but "
          f"{divs}; #9 {chk9.launches} launches ({chk9.tc_launches} tensor "
          f"cores), #10 {chk10.launches} (the engine route's ranks and the "
          f"replicated draft's propose steps), #11 {chk11.launches} "
          f"({[chk11.per_rank[0], chk11.per_rank[1]]} a rank, verify "
          f"windows at T = 5), every call within tolerance; split-K walks "
          f"{walks}; verify counters {out['server']['spec']}; gauges "
          f"{out['server']['gauges']}")


def tp_probe() -> int:
    """``--tp``: phase (35) alone (card only): builds the libraries of the
    tp path, then runs ``tp_phase``."""
    import torch

    from kubeinfer_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["decode_split", "quant_matmul", "quant_matmul_tc",
                      "flash_prefill", "flash_prefill_tc"])
    record = {"card": card}
    tp_phase(dev, record, card)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tp_probe.json").write_text(json.dumps(record, indent=1))
    print(record["tp"]["phase_s"])
    print(card)
    return 0


SP_LAYERS = 8  # (36a)-(36c), (36e): llama-3-8b width at 8 of its 32 layers
SP_PROMPT = 2048  # (36a)-(36c): the sp requests' prompt
SP_NEW = 32  # new tokens of each sp request
MOE_LAYERS = 4  # (36d): mixtral-8x7b width at 4 of its 32 layers
MOE_NEW = 32  # new tokens of each (36d) batcher request
MOE_ENGINE_PROMPT = 4100  # (36d): past the batcher's 4096
HANDOFF_REL = 2.0 ** -4  # (36a): handed-off K/V against chunked_prefill's
PP_REL = 2.0 ** -4  # (36e): pp logits against the dense forward's


def decode10_check(fa):
    """The stand-in that holds #10 against its plain version on every
    call, on the whole tiles the live rows reach, split-K walk counted."""
    import torch

    return CheckedAttention(
        fa, "decode_attention", fa.decode_attention_plain,
        live=lambda q, k, v, ln: ln > 0, weight=lambda q, k, v, ln: 0,
        walk=True, trim=True)


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in f32."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    return err, err / max(float(w.abs().max()), 1e-30)


def sp_streams(spe, jobs, new):
    return [spe.generate([p], new, **kw).tokens[0].tolist()
            for p, kw in jobs]


def sp_moe_phase(dev, record, card):
    """Phase (36): sequence, expert and pipeline parallelism on one H100,
    the ranks repeated ``cuda:0`` devices (one process, one card).

    - (36a) sp=2: llama-3-8b width cut to ``SP_LAYERS`` layers
      (``init_params(seed=0)``, bf16), ``SPEngine.generate`` on a greedy
      and a sampled (top_p 0.9) ``SP_PROMPT``-token prompt, ``SP_NEW``
      new tokens, against ``Engine.generate`` on the same params up to
      the near-tie rules (``held_pairs``); every #10 call held to its
      plain version; the handed-off caches against ``chunked_prefill``'s;
      one layer's ``ring_attention`` against the dense causal attention
      at [1, 2048, 32, 128]; sp prefill, chunked prefill, ring and
      handoff times, decode ms a token.
    - (36b) sp=2 x tp=2 over four ranks: the same prompts, #10 on each tp
      rank (launches equal), streams equal to (36a)'s up to near-ties; a
      mesh naming more cards than there are raises.
    - (36c) ``build_server([... "--sequence-parallel-size", "2",
      "--sp-min-prompt", "1024", "--draft-model", ...], mesh=...)`` over
      HTTP: the ``SP_PROMPT`` request routes "sp" (by ``/metrics``) and
      equals (36a)'s stream; a 512-token request takes the batcher.
    - (36e) ``pipeline_forward`` on (36a)'s params at pp 2 and 4, M 2 and
      4, tokens [4, 512], against ``forward(attn_fn=attention)``.
    - (36d) mixtral-8x7b width cut to ``MOE_LAYERS`` layers: the
      continuous engine at [13]'s slot geometry on 4 greedy + 1 sampled
      512-token prompts, ``MOE_NEW`` new: bf16 with every #11 call held,
      tp=2 streams against tp=1, a ``MOE_ENGINE_PROMPT``-token engine
      request (#9, #10 held), the MoE block's share of a decode step,
      ``moe_block_ep`` at ep 2 and 8 against ``moe_block``, the int8 pool
      and weights (#12, every #15 call held, the experts bf16), and the
      card against the CPU at 1 layer in f32.

    Returns ({kernel: launches on the sp path}, {kernel: launches on the
    MoE path})."""
    import dataclasses
    import gc

    import torch

    from kubeinfer_tpu_torch.inference import flash_attention as fa
    from kubeinfer_tpu_torch.inference import model as tm
    from kubeinfer_tpu_torch.inference import server
    from kubeinfer_tpu_torch.inference import sp_engine
    from kubeinfer_tpu_torch.inference import weight_quant as wq
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import (
        Engine,
        chunked_prefill,
        make_caches,
        prefill_chunk_for,
        prepare_prompts,
    )
    from kubeinfer_tpu_torch.inference.moe import (
        make_ep_mesh,
        moe_block,
        moe_block_ep,
    )
    from kubeinfer_tpu_torch.inference.pipeline import (
        make_pp_mesh,
        pipeline_forward,
    )
    from kubeinfer_tpu_torch.inference.ring_attention import ring_attention
    from kubeinfer_tpu_torch.inference.sharding import (
        Sharded,
        make_inference_mesh,
        shard_params,
    )
    from kubeinfer_tpu_torch.inference.stepper import step_forward

    t_phase = time.perf_counter()
    out = record["sp_moe"] = {"card": card, "sp_layers": SP_LAYERS,
                              "moe_layers": MOE_LAYERS}
    marks = out["phase_s"] = {}
    sp_launches, moe_launches = collections.Counter(), collections.Counter()

    def mark(name, t0):
        marks[name] = time.perf_counter() - t0

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    # (36a) sp=2
    t0 = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["llama-3-8b"],
                              num_hidden_layers=SP_LAYERS)
    V = cfg.vocab_size
    rng = np.random.default_rng(36)
    jobs = [(rng.integers(1, V, SP_PROMPT).tolist(), {}),
            (rng.integers(1, V, SP_PROMPT).tolist(),
             dict(temperature=0.8, top_p=0.9, seed=7))]
    params = tm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        eng = Engine(params, cfg, max_cache_len=8192, device=dev)
        want = [eng.generate([p], SP_NEW, **kw).tokens[0].tolist()
                for p, kw in jobs]
        mesh = make_inference_mesh(tp=1, sp=2, dp=1, devices=[dev] * 2)
        spe = sp_engine.SPEngine(params, cfg, mesh, max_cache_len=8192,
                                 min_prompt=1024)
        chk = decode10_check(fa)
        with chk:
            try:
                got = sp_streams(spe, jobs, SP_NEW)
            finally:
                check(chk.error is None, f"(36a) {chk.error}")
        walk = chk.walk_check("(36a)")
        check(chk.launches == chk.calls == SP_LAYERS * (SP_NEW - 1)
              * len(jobs), f"(36a) #10 {chk.launches} launches, "
              f"{chk.calls} calls")
        sp_launches["decode_attention"] += chk.launches
        divs = held_pairs("(36a)", got, want, jobs, params, cfg, dev,
                      scan=True)
        # the handoff against chunked_prefill's caches, and the times
        padded, lens, cache_len = prepare_prompts([jobs[0][0]], SP_NEW, 8192)
        prompt = torch.from_numpy(padded).to(dev)
        plen = torch.from_numpy(lens).to(dev)
        (caches, logits), sp_ms = synced(lambda: sp_engine.sp_prefill(
            params, prompt, plen, cfg, mesh, ranks=spe.ranks))
        (caches, logits), sp_ms = synced(lambda: sp_engine.sp_prefill(
            params, prompt, plen, cfg, mesh, ranks=spe.ranks))
        ref = make_caches(cfg, 1, cache_len, torch.bfloat16, dev)
        C = prefill_chunk_for(1, padded.shape[1])
        (ref, ref_logits), chunk_ms = synced(lambda: chunked_prefill(
            params, prompt, plen, cfg, ref, C))
        L = int(lens[0])
        layer_rel = [max(rel_err(k[:, :L], rk[:, :L])[1],
                         rel_err(v[:, :L], rv[:, :L])[1])
                     for (k, v), (rk, rv) in zip(caches, ref)]
        logit_err = rel_err(logits, ref_logits)
        check(max(layer_rel) <= HANDOFF_REL,
              f"(36a) handed-off K/V off chunked_prefill's: {layer_rel}")
        T_loc = padded.shape[1] // 2
        local = [[(k[:, s * T_loc:(s + 1) * T_loc].contiguous(),
                   v[:, s * T_loc:(s + 1) * T_loc].contiguous())
                  for k, v in caches] for s in range(2)]
        handoff_ms = cuda_ms(lambda: [
            (sp_engine._expand(k, cache_len), sp_engine._expand(v, cache_len))
            for k, v in sp_engine.handoff(local, [dev])], reps=5)
        # one layer's ring against the dense causal attention
        g = torch.Generator(device=dev)
        g.manual_seed(36)
        q, k, v = (torch.randn((1, SP_PROMPT, n, cfg.head_dim), generator=g,
                               device=dev).to(torch.bfloat16)
                   for n in (cfg.num_attention_heads,
                             cfg.num_key_value_heads,
                             cfg.num_key_value_heads))
        qs, ks, vs = (list(x.split(SP_PROMPT // 2, dim=1))
                      for x in (q, k, v))
        ring = torch.cat(ring_attention(qs, ks, vs), dim=1)
        mask = tm.causal_mask(SP_PROMPT, dev)[None]
        dense = tm.attention(q, k, v, mask)
        ring_err, ring_ok = attn_err(ring, dense, torch.ones(
            1, dtype=torch.bool, device=dev))
        check(ring_ok, f"(36a) ring attention off the dense: {ring_err}")
        ring_ms = cuda_ms(lambda: ring_attention(qs, ks, vs), reps=5)
        dense_ms = cuda_ms(lambda: tm.attention(q, k, v, mask), reps=5)
        del q, k, v, qs, ks, vs, ring, dense, local, caches, ref
        _, gen_ms = synced(lambda: spe.generate([jobs[0][0]], SP_NEW))
    decode_ms = (gen_ms - sp_ms) / (SP_NEW - 1)
    out["sp2"] = {"launches": chk.launches, "max_err": chk.max_err,
                  "split_walk": walk, "divergences": divs,
                  "handoff_layer_rel": layer_rel, "next_logits_err":
                  logit_err, "sp_prefill_ms": sp_ms,
                  "chunked_prefill_ms": chunk_ms, "handoff_ms": handoff_ms,
                  "ring_err": ring_err, "ring_ms": ring_ms,
                  "dense_attention_ms": dense_ms, "generate_ms": gen_ms,
                  "decode_ms_per_token": decode_ms}
    print(f"(36a) {card}: llama-3-8b width, {cfg.num_hidden_layers} "
          f"layers, bf16, sp=2 over cuda:0 twice: a greedy and a sampled (top_p 0.9) "
          f"{SP_PROMPT}-token prompt, {SP_NEW} new: SPEngine equal to "
          f"Engine but {divs} (near-ties held); #10 {chk.launches} launches,"
          f" every call within tolerance of its plain version (max err "
          f"{chk.max_err:.3e}), split-K walk {walk[0]}; handed-off K/V "
          f"against chunked_prefill's, largest error over the largest value "
          f"per layer {[round(x, 5) for x in layer_rel]} (<= {HANDOFF_REL}),"
          f" next logits {logit_err[0]:.4f} abs; ring attention at [1, "
          f"{SP_PROMPT}, 32, 128] against the dense causal: max err "
          f"{ring_err:.3e}; sp prefill {sp_ms:.1f} ms beside chunked "
          f"{chunk_ms:.1f} (host ms to sync); ring {ring_ms:.3f} ms, dense "
          f"{dense_ms:.3f} (CUDA events over calls); handoff (concatenate "
          f"and widen, every layer) {handoff_ms:.3f} ms; decode "
          f"{decode_ms:.2f} ms a token")
    mark("(36a)", t0)

    # (36b) sp=2 x tp=2
    t0 = time.perf_counter()
    mesh4 = make_inference_mesh(tp=2, sp=2, dp=1, devices=[dev] * 4)
    spe4 = sp_engine.SPEngine(shard_params(params, mesh4, cfg), cfg, mesh4,
                              max_cache_len=8192, min_prompt=1024)
    chk4 = decode10_check(fa)
    chk4.ranks = {}
    expand = sp_engine._expand

    def tallied(c, cache_len):
        # the decode caches' pieces, each tallied by its tp rank
        w = expand(c, cache_len)
        if isinstance(w, Sharded):
            chk4.ranks.update({p.data_ptr(): r for r, p in enumerate(w)})
        return w

    sp_engine._expand = tallied
    try:
        with torch.inference_mode(), chk4:
            try:
                got4 = sp_streams(spe4, jobs, SP_NEW)
            finally:
                check(chk4.error is None, f"(36b) {chk4.error}")
    finally:
        sp_engine._expand = expand
    walk4 = chk4.walk_check("(36b)")
    per_rank = [chk4.per_rank[r] for r in range(2)]
    check(chk4.per_rank[-1] == 0 and per_rank[0] == per_rank[1]
          == SP_LAYERS * (SP_NEW - 1) * len(jobs)
          and chk4.launches == chk4.calls == sum(per_rank),
          f"(36b) #10 {chk4.launches} launches, by rank "
          f"{dict(chk4.per_rank)}")
    sp_launches["decode_attention"] += chk4.launches
    divs4 = held_pairs("(36b)", got4, got, jobs, params, cfg, dev,
                      scan=True)
    del spe4
    if torch.cuda.device_count() < 2:
        try:
            make_inference_mesh(tp=1, sp=2, dp=1)
        except ValueError as e:
            check(f"needs 2 devices, have {torch.cuda.device_count()}"
                  in str(e), f"(36b) {e}")
        else:
            check(False, "(36b) an sp=2 mesh of the visible cards on one "
                  "card did not raise")
    out["sp2tp2"] = {"launches": chk4.launches, "per_rank": per_rank,
                     "max_err": chk4.max_err, "split_walk": walk4,
                     "divergences": divs4}
    print(f"(36b) sp=2 x tp=2 over cuda:0 four times: the same prompts, "
          f"streams equal to (36a)'s but {divs4}; #10 {chk4.launches} "
          f"launches, {per_rank} a tp rank, every call within tolerance "
          f"(max err {chk4.max_err:.3e}); an sp=2 mesh of the visible "
          f"cards on one card raises")
    mark("(36b)", t0)

    # (36c) the server, a self draft beside the sp route
    t0 = time.perf_counter()
    full = PRESETS["llama-3-8b"]
    PRESETS["llama-3-8b"] = cfg
    try:
        srv, cont = server.build_server(
            ["--model", "llama-3-8b", "--random-init", "--port", "0",
             "--host", "127.0.0.1", "--batch-slots", "4",
             "--sequence-parallel-size", "2", "--sp-min-prompt", "1024",
             "--draft-model", "llama-3-8b"], mesh=mesh)
    finally:
        PRESETS["llama-3-8b"] = full
    cont.start()
    srv.start()
    short = rng.integers(1, V, 512).tolist()
    chk10 = decode10_check(fa)
    chk11 = attention_check(fa, False)
    try:
        with torch.inference_mode(), chk10, chk11:
            try:
                resps = [post_json(srv.port, dict(prompt=p, max_tokens=n))
                         for p, n in ((jobs[0][0], SP_NEW), (short, 16))]
            finally:
                for c in (chk10, chk11):
                    check(c.error is None, f"(36c) {c.error}")
        _, text, _ = get_text(srv.port, "/metrics")
    finally:
        srv.stop()
        cont.stop()
    routes = [r["kubeinfer"]["route"] for r in resps]
    check(routes[0] == "sp" and routes[1] in ("continuous", "speculative"),
          f"(36c) routes {routes}")
    sp_reqs = [ln for ln in text.splitlines()
               if ln.startswith("kubeinfer_inference_requests_total")
               and 'route="sp"' in ln]
    check(len(sp_reqs) == 1 and 'outcome="ok"' in sp_reqs[0]
          and float(sp_reqs[0].split()[-1]) == 1.0,
          f"(36c) /metrics: {sp_reqs}")
    check(len(resps[1]["choices"][0]["tokens"]) == 16,
          "(36c) the 512-token request's tokens")
    # the 512-token request rides the batcher's draft groups (dense
    # rounds; #11 only where a row decodes on its own)
    check(chk10.calls >= SP_LAYERS * (SP_NEW - 1),
          f"(36c) #10 {chk10.calls} calls, #11 {chk11.calls}")
    divs_c = held_pairs("(36c)", [resps[0]["choices"][0]["tokens"]],
                        [got[0]], jobs[:1], params, cfg, dev)
    sp_launches["decode_attention"] += chk10.launches
    out["server"] = {"routes": routes, "metrics": sp_reqs,
                     "divergences": divs_c,
                     "launches": {c.name: c.launches for c in (chk10, chk11)}}
    print(f"(36c) build_server(--sequence-parallel-size 2, --sp-min-prompt "
          f"1024, --draft-model, mesh=cuda:0 twice) over HTTP: routes "
          f"{routes}, {sp_reqs}; the {SP_PROMPT}-token stream equal to "
          f"(36a)'s but {divs_c}; #10 {chk10.launches} launches, #11 "
          f"{chk11.launches}, every call within tolerance")
    del srv, cont
    gc.collect()
    torch.cuda.empty_cache()
    mark("(36c)", t0)

    # (36e) pipeline parallelism on (36a)'s params
    t0 = time.perf_counter()
    toks = torch.from_numpy(rng.integers(1, V, (4, 512))).to(dev)
    with torch.inference_mode():
        dense, _ = tm.forward(params, toks, cfg, attn_fn=tm.attention)
        dense_fwd_ms = cuda_ms(lambda: tm.forward(params, toks, cfg,
                                                  attn_fn=tm.attention),
                               reps=3)
        pp_rows = {}
        for pp in (2, 4):
            pmesh = make_pp_mesh(pp, [dev] * pp)
            for M in (2, 4):
                lg = pipeline_forward(params, toks, cfg, pmesh, M)
                err = rel_err(lg, dense)
                same = float((lg.argmax(-1) == dense.argmax(-1)).float()
                             .mean())
                check(err[1] <= PP_REL, f"(36e) pp={pp} M={M}: logits off "
                      f"the dense forward's by {err}")
                pp_rows[f"pp{pp}_m{M}"] = {
                    "max_err": err[0], "rel": err[1], "argmax_equal": same,
                    "ms": cuda_ms(lambda: pipeline_forward(
                        params, toks, cfg, pmesh, M), reps=3)}
                del lg
    out["pp"] = {"rows": pp_rows, "dense_forward_ms": dense_fwd_ms}
    print(f"(36e) pipeline_forward at llama-3-8b width, {SP_LAYERS} layers, "
          f"tokens [4, 512], against forward(attn_fn=attention) "
          f"({dense_fwd_ms:.2f} ms): " + "; ".join(
              f"{k} max err {r['max_err']:.4f} ({r['rel']:.5f} of the "
              f"largest logit, <= {PP_REL}), argmax equal "
              f"{r['argmax_equal']:.4f}, {r['ms']:.2f} ms"
              for k, r in pp_rows.items()))
    del dense, params, eng, spe
    gc.collect()
    torch.cuda.empty_cache()
    mark("(36e)", t0)

    # (36d) Mixtral served
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(PRESETS["mixtral-8x7b"],
                               num_hidden_layers=MOE_LAYERS)
    MV = mcfg.vocab_size
    mjobs = [(rng.integers(1, MV, 512).tolist(), {}) for _ in range(4)]
    mjobs.append((rng.integers(1, MV, 512).tolist(),
                  dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)))
    timed = [rng.integers(1, MV, 512).tolist() for _ in range(4)]
    mp = tm.init_params(mcfg, seed=0, dtype=torch.bfloat16, device=dev)
    expert_gb = sum(layer["moe"][k].numel() * 2 for layer in mp["layers"]
                    for k in ("gate_proj", "up_proj", "down_proj")) / 1e9
    one = tp_engine(mcfg, mp, 1, "bf16", dev)
    chk11 = attention_check(fa, False)
    try:
        with torch.inference_mode(), chk11:
            try:
                mwant = tp_serve(one, mjobs, MOE_NEW)
            finally:
                check(chk11.error is None, f"(36d) {chk11.error}")
        with torch.inference_mode():
            mms = decode_ms_per_token(one, timed, 16)
    finally:
        one.stop()
    del one
    walk11 = chk11.walk_check("(36d)")
    check(chk11.launches == chk11.calls > 0, f"(36d) #11 {chk11.calls}")
    moe_launches["decode_attention_blocks"] += chk11.launches
    two = tp_engine(mcfg, mp, 2, "bf16", dev)
    chk2 = attention_check(fa, False)
    chk2.ranks = pool_ranks(two)
    try:
        with torch.inference_mode(), chk2:
            try:
                mgot = tp_serve(two, mjobs, MOE_NEW)
            finally:
                check(chk2.error is None, f"(36d) tp=2 {chk2.error}")
    finally:
        two.stop()
    del two
    per2 = [chk2.per_rank[r] for r in range(2)]
    check(chk2.per_rank[-1] == 0 and per2[0] == per2[1] > 0
          and chk2.launches == sum(per2),
          f"(36d) tp=2 #11 by rank {dict(chk2.per_rank)}")
    moe_launches["decode_attention_blocks"] += chk2.launches
    mdivs = held_pairs("(36d) tp=2", mgot, mwant, mjobs, mp, mcfg, dev)
    # the engine route past the batcher's row
    long_prompt = rng.integers(1, MV, MOE_ENGINE_PROMPT).tolist()
    chk9 = CheckedAttention(
        fa, "flash_attention_ragged", fa.flash_attention_ragged_plain,
        live=lambda q, k, v, off, ln: torch.ones(q.shape[0], dtype=torch.bool,
                                                 device=q.device),
        weight=lambda q, k, v, off, ln: off)
    chk10 = decode10_check(fa)
    with torch.inference_mode(), chk9, chk10:
        try:
            Engine(mp, mcfg, max_cache_len=8192, device=dev).generate(
                [long_prompt], 8)
        finally:
            for c in (chk9, chk10):
                check(c.error is None, f"(36d) engine route {c.error}")
    bucket = prepare_prompts([long_prompt], 8, 8192)[0].shape[1]
    chunks = bucket // prefill_chunk_for(1, bucket)
    check(chk9.calls == chunks * MOE_LAYERS
          and chk9.tc_launches == chk9.calls
          and chk10.calls == 7 * MOE_LAYERS,
          f"(36d) engine route #9 {chk9.calls} calls ({chk9.tc_launches} "
          f"tensor cores), #10 {chk10.calls}")
    moe_launches["flash_attention_ragged"] += chk9.launches
    moe_launches["decode_attention"] += chk10.launches
    # the MoE block's share of a decode step's device time (engine route,
    # 8 rows at 512 positions)
    with torch.inference_mode():
        caches = make_caches(mcfg, 8, 1024, torch.bfloat16, dev)
        tok = torch.ones(8, dtype=torch.long, device=dev)
        off = torch.full((8,), 512, dtype=torch.int32, device=dev)
        step_wall, step_busy, _ = device_profile(
            lambda: step_forward(mp, mcfg, tok, off, caches, 1024))
        moe0 = mp["layers"][0]["moe"]
        h8 = torch.randn((8, 1, mcfg.hidden_size), device=dev).to(
            torch.bfloat16)
        moe_ms = device_ms(lambda: moe_block(moe0, h8, 2))
        del caches
        # expert parallelism against the dense block
        ep_rows = {}
        for ep in (2, 8):
            emesh = make_ep_mesh(ep, [dev] * ep)
            for shape in ((8, 1, mcfg.hidden_size),
                          (1, 512, mcfg.hidden_size)):
                x = torch.randn(shape, device=dev).to(torch.bfloat16)
                want_x = moe_block(moe0, x, 2)
                got_x = moe_block_ep(moe0, x, emesh, 2)
                err, ok = attn_err(got_x, want_x, torch.ones(
                    shape[0], dtype=torch.bool, device=dev))
                check(ok, f"(36d) moe_block_ep ep={ep} {shape}: {err}")
                ep_rows[f"ep{ep}_{'x'.join(map(str, shape))}"] = {
                    "max_err": err,
                    "ms": cuda_ms(lambda: moe_block_ep(moe0, x, emesh, 2),
                                  reps=5),
                    "moe_block_ms": cuda_ms(lambda: moe_block(moe0, x, 2),
                                            reps=5)}
    share = MOE_LAYERS * moe_ms / step_busy if step_busy else None
    del mp, moe0
    gc.collect()
    torch.cuda.empty_cache()
    # the int8 pool and weights: the experts stay bf16
    p8 = tm.init_params(mcfg, seed=0, dtype=torch.bfloat16, device=dev,
                        weight_dtype="int8")
    check(all(wq.is_quant_leaf(layer[n]) for layer in p8["layers"]
              for n in ("q_proj", "k_proj", "v_proj", "o_proj"))
          and all(layer["moe"][n].dtype == torch.bfloat16
                  for layer in p8["layers"] for n in layer["moe"]),
          "(36d) int8: the attention projections int8, the experts bf16")
    eng8 = tp_engine(mcfg, p8, 1, "int8", dev)
    chk12 = attention_check(fa, True)
    mm = CheckedMatmul(wq)
    try:
        with torch.inference_mode(), chk12, mm:
            try:
                got8 = tp_serve(eng8, mjobs, MOE_NEW)
            finally:
                check(chk12.error is None, f"(36d) int8 {chk12.error}")
                check(mm.verify() is None, f"(36d) int8 {mm.error}")
    finally:
        eng8.stop()
    del eng8, p8
    routes8 = mm.all_tc("(36d) int8")
    check(all(len(g) == MOE_NEW for g in got8), "(36d) int8 streams")
    check(chk12.launches == chk12.calls > 0, f"(36d) #12 {chk12.calls}")
    moe_launches["decode_attention_blocks_q8"] += chk12.launches
    moe_launches["quant_matmul"] += mm.launches
    gc.collect()
    torch.cuda.empty_cache()
    # the card against the CPU, 1 layer in f32
    c1 = dataclasses.replace(mcfg, num_hidden_layers=1)
    p32 = tm.init_params(c1, seed=0, dtype=torch.float32, device=dev)
    short2 = [rng.integers(1, MV, n).tolist() for n in (24, 32)]
    # tp=2 against tp=1 in f32: bf16 routing flips between the served and
    # the f32 forward (a router near-tie picks other experts) widen the
    # bf16 allowance above, so the batcher is held here in f32 too
    f32_jobs = [(p, {}) for p, _ in mjobs[:4]]

    def f32_serve(tp):
        e = tp_engine(c1, p32, tp, "bf16", dev)
        c = attention_check(fa, False)
        try:
            with torch.inference_mode(), c:
                try:
                    return tp_serve(e, f32_jobs, 16), c
                finally:
                    check(c.error is None, f"(36d) f32 tp={tp} {c.error}")
        finally:
            e.stop()

    w32, c1_chk = f32_serve(1)
    g32, c2_chk = f32_serve(2)
    for c in (c1_chk, c2_chk):
        check(c.launches == c.calls > 0, f"(36d) f32 #11 {c.calls}")
        moe_launches["decode_attention_blocks"] += c.launches
    tp_f32 = f32_streams("(36d) tp=2 against tp=1, f32, 1 layer", g32, w32,
                         [p for p, _ in f32_jobs], p32, c1, dev)
    t_cpu = time.perf_counter()
    with torch.inference_mode():
        on_card = Engine(p32, c1, device=dev).generate(short2, 8)
        on_cpu = Engine(tm.params_to(p32, "cpu"), c1,
                        device="cpu").generate(short2, 8)
    cpu_s = time.perf_counter() - t_cpu
    f32_divs = f32_streams("(36d) card vs CPU", on_card.tokens.tolist(),
                           on_cpu.tokens.tolist(), short2, p32, c1, dev)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    out["moe"] = {"expert_gb": expert_gb, "divergences_tp2": mdivs,
                  "launches": dict(moe_launches),
                  "per_rank_11_tp2": per2, "split_walk_11": walk11,
                  "max_err": {c.name: c.max_err for c in
                              (chk11, chk9, chk10, chk12)},
                  "qmm": {"max_err": mm.max_err, "routes": routes8},
                  "decode_ms_per_token_slot": mms,
                  "step_busy_ms": step_busy, "step_wall_ms": step_wall,
                  "moe_block_ms": moe_ms, "moe_share": share,
                  "ep": ep_rows, "card_vs_cpu": {"f32": f32_divs,
                                                 "s": cpu_s},
                  "tp2_f32": tp_f32}
    print(f"(36d) mixtral-8x7b width, {MOE_LAYERS} layers ({expert_gb:.2f} "
          f"GB of bf16 experts), [13]'s slot geometry, 4 greedy + 1 sampled "
          f"512-token prompts, {MOE_NEW} new: bf16 #11 {chk11.launches} "
          f"launches, every call within tolerance; tp=2 over cuda:0 twice "
          f"equal to tp=1 but {mdivs}, #11 {per2} a rank; the "
          f"{MOE_ENGINE_PROMPT}-token engine route #9 {chk9.launches} "
          f"(tensor cores), #10 {chk10.launches}, held; int8 #12 "
          f"{chk12.launches}, #15 {mm.launches} ({routes8}), every call "
          f"held, the experts bf16; tp=2 against tp=1 at 1 layer f32 "
          f"{tp_f32}; card vs CPU at 1 layer f32 "
          f"{f32_divs} ({cpu_s:.1f} s); decode {mms:.2f} ms a token a slot; "
          f"a decode step (engine route, 8 rows) busy {step_busy:.3f} ms, "
          f"the MoE block {moe_ms:.4f} ms a layer (share "
          f"{share if share is None else round(share, 3)}); moe_block_ep: "
          + "; ".join(f"{k} err {r['max_err']:.3e} {r['ms']:.3f} ms "
                      f"(moe_block {r['moe_block_ms']:.3f})"
                      for k, r in ep_rows.items()))
    mark("(36d)", t0)
    for name, n in (("decode_attention", sp_launches["decode_attention"]),):
        check(n > 0, f"(36) {name} never launched on the sp path")
    check(all(moe_launches[k] > 0 for k in TP_KERNELS),
          f"(36) a kernel of the MoE path never launched: "
          f"{dict(moe_launches)}")
    out["sp_launches"] = dict(sp_launches)
    marks["(36)"] = time.perf_counter() - t_phase
    print(f"(36) sp launches {dict(sp_launches)}, moe launches "
          f"{dict(moe_launches)}; times {marks}")
    return dict(sp_launches), dict(moe_launches)


def sp_probe() -> int:
    """``--sp``: phase (36) alone (card only): builds the libraries of the
    sp and MoE paths, then runs ``sp_moe_phase``; writes
    ``chiprun_out/sp_probe.json``."""
    import torch

    from kubeinfer_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["decode_split", "quant_matmul", "quant_matmul_tc",
                      "flash_prefill", "flash_prefill_tc"])
    record = {"card": card}
    sp_moe_phase(dev, record, card)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "sp_probe.json").write_text(json.dumps(record, indent=1))
    print(record["sp_moe"]["phase_s"])
    print(card)
    return 0


def agent_probe() -> int:
    """``--agent``: phase (33) alone (card only): builds the libraries the
    tick and the spawned and in-process servers launch, then runs
    ``agent_phase``."""
    import torch

    from kubeinfer_tpu_torch import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all(["mega_solve", "round_ops", "auction", "route_pick",
                      "decode_split", "quant_matmul", "quant_matmul_tc",
                      "flash_prefill", "flash_prefill_tc"])
    record = {"card": card}
    agent_phase(dev, record, card)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "agent_probe.json").write_text(json.dumps(record, indent=1))
    print(record["agent"]["phase_s"])
    print(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--agent"]:
        sys.exit(agent_probe())
    if sys.argv[1:2] == ["--observe"]:
        sys.exit(observe_probe())
    if sys.argv[1:2] == ["--disagg"]:
        sys.exit(disagg_probe())
    if sys.argv[1:2] == ["--migrate"]:
        sys.exit(migrate_probe())
    if sys.argv[1:2] == ["--fleet"]:
        sys.exit(fleet_probe())
    if sys.argv[1:2] == ["--sp"]:
        sys.exit(sp_probe())
    if sys.argv[1:2] == ["--tp"]:
        sys.exit(tp_probe())
    if sys.argv[1:2] == ["--tie-probe"]:
        sys.exit(tie_probe([int(a) for a in sys.argv[2:]] or [25]))
    if sys.argv[1:2] == ["--qmm"]:
        sys.exit(qmm_probe())
    if sys.argv[1:2] == ["--p50s"]:
        sys.exit(placement_p50s())
    sys.exit(main(placement_only=sys.argv[1:2] == ["--placement"]))
