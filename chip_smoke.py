#!/usr/bin/env python3
"""Drive the PyTorch port (``langstream_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases (``--phases`` picks a subset, comma-separated, for a partial run):

1. ``build``   — compiles every CUDA kernel of the port from the sources in
   the checkout (one ``nvcc`` per source, all started together, into
   ``build/kernels/``) and prints the build time, each kernel
   instantiation's ptxas register / spill report (and any wgmma
   serialization warning), the segment kernel's SASS instruction mix
   (HGMMA, UTMALDG, ...) and the decode kernel's (UBLKCP bulk copies,
   SYNCS mbarriers, UCGABAR cluster barriers, ...), and the card's name
   and power limit (the decode library's mix also per cache type, with
   its I2F and F2F: int8 widens by prmt and one FADD, not by conversions).
2. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main paths' shapes (H 32, Hkv 8, D 128, page 64; prefill S 200
   and 1024 at B 2; paged decode at B 8 with ragged lengths 1..1500 and
   at B 32 with lengths 256, 512, ..., 8192, bf16 and int8 pages; segment
   S 200 at offset 1000, S 1024 at offsets 0 and 5000 (B 2, through a
   [..., :6024] view) and S 2048 at offset 6144, in a T 8192 cache, bf16
   and int8; dense decode at B 8, lengths 1..1500, through a [..., :2048]
   view of a T 8192 cache — int8 also through a [..., :2048] view of the
   engine's 8,193-wide sink-column cache, whose scale rows are not 16-byte
   aligned — and at B 32, lengths 256..8192, through the whole cache, bf16
   and int8): every output element within ``atol +
   rtol * |ref|`` of the plain version (and the same check shown to
   reject planted faults: a zeroed 64-key V tile, a K tile or page
   holding the one before it, a causal frontier or lengths one off, and
   for decode one cluster rank's share of keys dropped, and for int8 a
   64-row tile's K scales taken from another tile), NaN past every decode
   row's length (int8: in the scales) leaving the output
   bit-equal, the max abs error, the kernel's time, the plain
   version's time, the bound of the card, and one library call as a
   yardstick where one computes the same function (SDPA, with an explicit
   mask where the kernel masks); the flash rows also give their TFLOP/s
   and bound share, and the segment rows their grid and the K/V bytes it
   streams from L2. Dense decode is also timed against the
   masked read the JAX package takes there under ``auto`` (the port's
   reference ``attention`` over the bounded view), and run at the dense
   verify's flattened shape: 8 cache rows x 5 queries (``queries_per_row``
   5) ~400 tokens in and one row at 2045, through a [..., :2048] view of a
   T 8192 cache, bf16 and int8 — its planted faults include the row map
   off by one (query row q reading cache row q / 5 + 1), NaN past every
   row's longest query leaves it bit-equal, and it is timed beside the 8
   first queries at qpr 1 and SDPA with a per-query length mask. Then
   the local shapes a TP-2 rank of llama-3-8b launches (H 16, Hkv 4, D
   128: prefill S 1024 B 2, paged decode B 8 lengths 1..1500, the segment
   S 2048 at offset 6144), each held against its plain version with the
   same planted faults, timed beside its bound (``by_shape`` of the
   decode row; the others' own ``kernel`` lines). Last, the
   ``fused_segment_decode_attention`` routing (no kernel of its own) over
   one T 8192 cache of 4 rows, bf16 and int8: two segments of S 1024 at
   offsets 0 and 5000 bit-equal to a direct segment kernel call on the
   gathered rows, two decode rows of 1500 and 700 keys (a [..., :2048]
   bound) bit-equal to the masked read.
3. ``e2e``     — the port's ``ServingEngine`` serving llama-3-8b at full
   width and depth (32 layers, bf16, random weights from ``--seed``) on the
   paged layout: 8 requests of 21..1501 byte tokens, greedy, 64 new tokens
   each, with every kernel count set to 0 just before and read just after.
   Every serving run's decode chunks are CUDA-graph replays (``start()``
   captures one graph per sampling branch): each run fails unless its
   replays equal its decode chunks, and its decode kernel's launches must
   be exactly layers x decode steps (counted per replay); its line
   reports the captures, replays, capture seconds and the graph pool's
   bytes. Then a reference check on the same weights: prefill and paged
   decode logits of the kernel path against the reference attention path.
4. ``int8``    — a shorter end-to-end run over the int8 page pool (the
   int8 paged decode kernel), counts read the same way.
5. ``dense``   — the same engine on the dense layout, max_seq_len 8192 (an
   8 GiB big cache): 8 requests of 21..7001 byte tokens, greedy, 32 new
   tokens each; the 3001- and 7001-token prompts prefill in 2 and 4
   segments of 2048 (the segment kernel), decode runs the dense decode
   kernel. Then a dense reference check: a 3000-token prompt through 2
   ``prefill_segment`` calls and 4 ``decode_step_inplace`` steps, kernel
   path against reference path.
6. ``dense_int8`` — 4 requests (one of 3001 tokens), 16 new tokens, over an
   int8 dense cache (the int8 segment and dense decode kernels).
7. ``paged_long`` — llama-3-8b on the paged layout with max_seq_len 8192:
   the ``dense`` phase's 8 requests, whose 3001- and 7001-token prompts
   prefill in 2 and 4 segments of 2048 straight into their pages (the
   segment kernel over the gathered pages), decode through the paged
   decode kernel; then 4 requests (41..3001 tokens, 16 new) over int8
   pages (the int8 segment kernel). Then a paged reference check (a
   3000-token prompt through 2 ``paged_prefill_segment_inplace`` calls
   and 4 paged decode steps, kernel path against reference path), NaN
   planted past a segment's frontier and in the sink page (the kernel
   path's logits must stay bit-equal), and the page gather's time beside
   the segment kernel's for the 2048-token segment at offset 6144.
8. ``graphs``  — the captured decode chunk at full width and 8 of the 32
   layers (``SHALLOW_LAYERS``: the depth is cut so the default run keeps
   its time with the ``ring`` phase; nothing it checks depends on depth):
   for paged bf16,
   paged int8 (max_seq_len 2048) and dense bf16 (8192 wide), 7 requests
   admitted by hand, one chunk, an 8th admitted, then one replay against
   a direct call of the same chunk function on a copy of the same state —
   tokens equal and the pool or cache bit-equal afterwards; on the paged
   layout a replay whose dispatch table was not refreshed after that
   admission must differ (the planted fault). Then two lifecycle drills
   on the card: ``decode@3`` on a one-slot engine (the request in flight
   fails, the engine restarts and captures its graphs again, the queued
   request is token-exact against a fault-free engine) and ``nan@3`` on a
   two-slot engine (one slot quarantined, its pages read back as zeros,
   the survivor token-exact against a fault-free run).
9. ``prefix``  — prefix KV reuse: llama-3-8b at full width and depth,
   bf16, paged, page 64, max-batch 8, ``prefix-cache`` on. A 1024-token
   shared preamble (a RAG or agent system prompt): request 0, the
   preamble plus a 40-token turn, admitted alone (cold; it publishes the
   preamble, 16 pages), then 8 requests of the preamble plus 20..120-token
   turns together, each a warm suffix segment at offset 1024 over 16
   aliased pages; 32 new tokens each, greedy. The same traffic with
   reuse off (its pages in use and TTFT, and the cold first-token logits),
   and a copy-on-write pass whose buckets include 1000 (15 aliased pages
   and 1 copied page a hit). Each run: cold against warm TTFT, tokens/s,
   hit rate, prefill tokens saved, alias rate, peak pages in use, page
   copies (0 and 1 a hit, required), segment launches (32 a warm
   admission, required), decode launches = layers x steps and replays =
   chunks, and each admission's host milliseconds. The warm first-token
   logits of two prompts must be within 5% of the largest cold logit,
   top-1 equal (greedy-token agreement is printed); NaN planted in the
   copy-on-write source page at and past the prefix's end and in the sink
   page must leave a warm suffix's logits bit-equal; the warm admission
   is timed (device and host) beside a cold 1024-token prefill.
10. ``spec``    — self-speculative decoding: llama-3-8b at full width and
   8 of its 32 layers (``SHALLOW_LAYERS``), bf16, paged, page 64, max_seq_len 2048, max-batch 8, k 4. 8
   requests of 400 byte tokens — 4 built to repeat (a 24-byte span cycled)
   and 4 plain — 64 new tokens each, greedy, served with speculation on
   (every decode iteration one verify: one graph replay, its attention the
   paged decode kernel over the B x (k+1) queries flattened into
   single-query rows) and then off, on fresh engines: tokens/s, TTFT, the
   acceptance rate, accepted tokens a verify step, the draft hit rate, and
   back-to-back replays' device and wall ms a verify step beside a decode
   step's. Required: paged decode launches = layers x verify dispatches,
   replays = verify dispatches, every request ending with its token count.
   Greedy-token agreement of speculation against none is printed per
   request, with the top-2 margin at the first diverging position (the
   GEMMs' M differs, so exactness is not required on the card). Then a
   verify replay against a direct call of ``_verify_chunk`` on a copy of
   the same state (bit-equal), the kernel path's verify logits against the
   reference path's (gathered masked read) on the same pool — within 5% of
   the largest logit and top-1 equal at every one of the k+1 positions —
   and NaN planted past every row's frontier and in the sink page leaving
   the kernel path's verify logits bit-equal. A speculative engine with
   brownout on (the default) captures the decode set beside the verify
   set: 6 graphs.
11. ``tenancy`` — multi-tenant overload control and observability at
   llama-3-8b's full width (since PR 20 at 8 of its 32 layers,
   ``SHALLOW_LAYERS``, to keep the default run's time beside ``rag``)
   (bf16, paged, page 64, max-batch 8,
   max_seq_len 2048, decode chunk 16, greedy, speculation k 4; the
   ``spec`` prompts, 32 new tokens a request). (1) 16 low-priority
   "aggressor" requests (max-slots 6, queue share 0.5) and 4 "victim"
   requests queued before ``start()``: every request ends with its tokens,
   no flight frame and no polled ``tenants`` snapshot shows the aggressor
   past 6 slots, each tenant's TTFT (from ``start()``), and the tokens
   equal a tenant-free engine's, but for ties (``_same_or_tie``). (2)
   Brownout pinned at levels 0, 1, 2 and 0 again, the 8 prompts one
   after another: the same tokens but for ties; level 2 dispatches no
   verify and replays one decode graph a chunk, levels 0 and 1 one
   verify graph a verify; paged decode launches exactly layers x (decode
   steps + verifies). (3) The capture's parts (warm-up, each branch of
   each set), the graph pool and the engine's peak — live tensors and
   the allocator's growth — against ``serving/memory.py``'s plan for one
   set (speculation off), one set (speculation on, brownout off) and both
   sets; a peak past the plan fails. (4) The ``e2e`` burst with
   observability on and off (tokens/s, the same tokens but for ties), then
   ``tenant-burst@1`` and ``nan@1`` planted in the phase's engine: the
   burst's sheds counted against "chaos-burst", one ``nan-quarantine``
   flight dump that validates and holds no token content.
12. ``agentic`` — the agentic tier at llama-3-8b's full width and 8 of
   its 32 layers (``SHALLOW_LAYERS``: since PR 20 the depth is cut so the
   default run keeps its time with the ``rag`` phase; the tier's checks
   hold at any depth) (bf16, paged, page 64, max-batch 8, max_seq_len 2048, buckets up to
   512, decode chunk 16, greedy, 64 new tokens): three random rank-16
   adapters (scale 0.5) over a pool of base + 2 rows, 4 grammar slots. The ``e2e``
   prompt lengths (21..1501 byte tokens; past 512 they prefill in
   segments) in two waves, each queued before the engine thread runs: 2
   base requests, 2 for each of two adapters, then 2 for the third
   adapter (an LRU swap); 4 of the 8 carry a JSON-schema or regex
   ``response_format``, 3 of those with an adapter. Required: every
   constrained output parses (``json.loads`` and the schema, or a regex
   fullmatch) and ends with "stop", every other one with its 64 tokens,
   paged decode launches = layers x decode steps, replays = chunks, 3
   adapter swaps, no plain version run; the adapter and grammar pools'
   bytes equal the plan's terms, and the engine's peak stays within the
   plan. Then an adapter's prefill and 4 paged decode steps, kernel path
   against reference path (within 5% of the largest logit, top-1 equal
   at the first token), and the prefill through an adapter at scales 1,
   0.5 (the phase's) and 0, kernel and reference path in bf16, against
   the reference path in f32 (the kernel path no further from f32 than
   1.25 x the bf16 reference path + 0.1%); ``adapter@1`` planted: one request fails with the
   adapter-row corruption, one valid ``adapter-quarantine`` dump, the
   others' tokens as a fault-free run's (but for ties), and an adapter's
   tokens differ from the base model's on the same prompts. The same
   traffic with speculation on (every output in its grammar; launches =
   layers x verifies), the tier off (``constrained-decoding: off``, no
   adapters) and grammars alone (the default engine): back-to-back
   replays' device and wall ms a decode step (tier on: with the profiler's
   top kernels), the capture's parts and the graph pool of each. Prints
   each grammar's compile seconds (the first includes the 128256-entry
   token byte table) and the swaps' host seconds.
13. ``embed``   — RAG on the card through ``TorchServingProvider``
   (llama-3-8b at full width and 8 of its 32 layers, ``SHALLOW_LAYERS``,
   drawn by the provider from ``--seed``, bf16): 32 byte-tokenized texts
   of 16..512 tokens (one of them twice) embedded by its embeddings
   service — wall and device ms a call and the peak growth, each vector within ``EMBED_TOL`` (L2) of an
   f32 ``encode`` on the card (weights widened a layer at a time), unit
   norms, the duplicate's vectors equal; one layer's attention of the
   port beside SDPA with a key-padding mask (a yardstick). Then the
   ``local-vector`` store on the card: 262,144 seeded rows of 4096 f32
   plus the 32 embeddings, 64 queries (the embeddings and 32 seeded) at
   top-k 5 and 64, each list held to an f64 reference's (a plain f64
   matmul on the card over the store's host rows; neighbours within ``VECTOR_TIE`` may swap), each text ranking its own row first,
   device and wall ms a query beside the byte bound of one read of the
   rows. Then one batch embedded again and again on another thread while
   the provider's engine is built, captures its graphs and serves the
   ``e2e`` requests (one wave): every such batch within
   ``EMBED_CONCURRENT_TOL`` of the idle one, the tokens equal to the same
   wave served after.
14. ``dense_tiers`` — the rest of the dense layout at llama-3-8b's full
   width (since PR 20 at 8 of its 32 layers, as ``tenancy``)
   (max_seq_len 8192): the ``spec`` traffic with
   speculation on and off (acceptance, the verify step's device / wall ms
   against the decode step's from back-to-back replays, dense decode
   launches exactly layers x verifies, replays = verifies, tokens on vs
   off equal or one-ulp ties); the verify's kernel path against its
   reference path on one cache (5%, top-1 equal but for one-ulp ties);
   two requests with a JSON-schema response format served with
   speculation, each in its grammar; brownout pinned at level 2 with both graph sets captured
   (decode chunks only, tokens as speculation off's or ties); then the
   ``prefix`` traffic with reuse on and off, bf16 and int8 KV: 8 warm
   admissions of one suffix segment a layer, 8 x 1024 prefill tokens
   saved, the pool as allocated equal to the plan's term, warm TTFT
   beside cold, warm first-token logits within 5% of the cold ones,
   top-1 equal.
15. ``tiered``  — the host KV tier and the durable tier at llama-3-8b's
   full width and 8 of its 32 layers (``SHALLOW_LAYERS``: the default
   run's time; the tree drawn from ``--seed`` as a provider of
   that preset draws it, so the durable pass's providers serve the same
   weights) (bf16, paged, page 64, max-batch 8, max_seq_len
   2048, ``prefix-cache`` auto). 24 sessions, each a seeded 1024-token
   history: round 1 (history + a 40-token turn, 16 new tokens, greedy, all
   24 queued at once) publishes 16 pages a session — 384 pages, more than
   the pool's prefix headroom — then round 2 (history + a new 20..120-token
   turn, one session at a time) hits at 1024. Three engines serve it: a
   pool of 640 pages nothing is evicted from (the tokens' reference), the
   default pool (320 pages) with the tier off (evicted prefixes
   re-prefill), and the default pool with ``host-kv-fraction`` 2.0 and
   ``spill-idle-s`` 0 (a 1.25 GiB pinned arena at 8 layers; its bytes and allocation
   seconds printed): every round of each ends with its tokens, no plain
   version, replays = chunks, paged decode launches = layers x steps and
   segment launches = layers x warm admissions. Between the rounds, on the
   stopped tiered engine, one entry's 16 pages read to the host are held
   against its arena copy, then demoted and restored by the engine and held
   bit-equal again; the restore's ms, its checksum's host ms (the
   engine's threads, and one thread), its upload's device ms and a pinned
   host-to-device copy of those bytes (the bound), and the spill's copy of those
   pages, are timed. Required: round 1 demotes,
   round 2 restores with no restore failure and no recompute fallback,
   both rounds' tokens the reference's (or one-ulp ties,
   ``_same_or_tie``), the restored turns' first-token logits bit-equal to
   the no-eviction engine's warm hits and within 5% of the tier-off
   engine's cold admissions of the same prompts (top-1 equal, or a tie
   both logits show within one bf16 ulp: the cold group's GEMMs have other
   shapes), the engine's peak within its memory plan. Printed: the spill /
   restore / demotion totals, the spill worker's GB/s, round-2 TTFT p50 /
   max beside the tier-off and no-eviction engines', a captured decode
   step's device ms alone and with 4 x 2 GiB of spill copies in flight
   (the engine's DMA, and the same copies staged through torch's strided
   ``copy_``), 4 concurrent decoders' largest gap between token bursts
   when a hibernated session's turn arrives and restores against the
   same turn as a device hit, the launches. Then ``spill@1``: a hibernated session's restore meets a
   flipped arena byte, refuses it, re-prefills cold with the reference's
   tokens (or ties). The int8 pass: 8 sessions one at a time through a
   64-page int8 pool (bytes a page printed): the bit-equal restore, round
   2 restores, tokens as a no-eviction int8 run's, the same drill. The
   durable pass: the first 8 sessions' first turns through a provider
   with ``durable-dir`` (a directory under ``build/``, removed after) and
   ``fault-injection: disk-corrupt@1``, then ``hibernate()`` (entries,
   bytes, the checkpoints' GB/s); a second provider on the same directory
   in the same process must rehydrate all 8 and serve their second turns
   from disk: 7 durable restores, each session's pages bit-equal to its
   checkpoint, the corrupted one a ``durable-restore-failed`` dump and a
   cold prefill, every turn's tokens the reference's (or ties); a
   restore's ms beside a sequential read of one checkpoint file (from the
   host's page cache, just written).
16. ``fleet``   — KV-page migration and the in-process fleet at llama-3-8b's
   full width (since PR 20 at 8 of its 32 layers, as ``tenancy``) (bf16, paged, page 64, max_seq_len 4096,
   max-batch 8, decode chunk 16, ``prefix-cache`` auto, buckets 32…2048 on
   both engines): two port engines on ONE weight tree, "pre"
   (``migrate_staging``) and "dec", started one after the other, behind a
   ``FleetRouter`` of two ``InProcessReplica``s ("prefill" and "decode"
   roles, ``prefill_route_threshold`` 2048), the router's refresh thread
   running. Traffic: 8 requests of 2100, 2350 … 3850 byte tokens
   (long-context RAG and agent prompts), 32 new tokens each, greedy, all
   submitted at once, each through ``stream_generate`` on its own thread.
   (1) The reference: the same router with ``migrate=False``, every
   request decoded in place on "pre" (its prefixes then released). (2)
   The disaggregated burst: prefill and the first token on "pre", the
   published 2048-token prefix's 32 pages migrated (``serving/migrate.py``,
   v1 frames) into "dec", the rest decoded warm there. Required: every
   request served by pre then dec; tokens pass 1's (or one-ulp ties,
   ``_same_or_tie``); 8 migrations and no fallback; dec's pages in = pre's
   pages out = 8 x 32; pre holds no entry for any prompt; both pools leak-
   free; no restart; launches exactly layers x (segments, decode steps) of
   both engines, dec one warm segment a request, replays = chunks; dec's
   migrated pages hashed against the sender's stamps; the peak of both
   engines within their two plans beyond the one weight tree. (3) Drills:
   ``migrate@1`` and ``net-cut@1`` through ``set_wire_injector``, one
   request each: decoded in place on pre with pass 1's tokens, dec's free
   pages unchanged, pre keeping its entry, one valid ``migrate-failed``
   dump with ``fallback`` decode-in-place. (4) P2P: the two engines as
   mixed replicas; a 1024-token preamble published on one, a prompt
   sharing it routed to the other (the owner 5 load units worse at λ
   256), whose ``_p2p_fetch`` copies the 16 pages: 1024 prefill tokens
   saved, the owner keeps its entry, tokens a cold run's (or ties). (5)
   From the host arena: "pre" again with ``host-kv-fraction`` 1.0 and
   ``spill-idle-s`` 0 (a 128-page pool); once a published prefix spilled,
   its migration reports tier host, ships the stored stamps, and dec's
   pages are bit-equal to the arena's. Then, on the stopped dec, two
   captured chunks with and without a 32-page bind between them. (6)
   int8: 4 of the requests over int8 pools on both engines (the int8
   segment and paged decode kernels), migrated as in (2); dec's int8 page
   bytes equal the sender's frames. Printed: each
   request's TTFT (on pre), handoff gap and total against pass 1's; each
   migration's snapshot, copy, checksum, encode / decode, verify, upload
   and bind ms, pages, bytes and GB/s beside one pinned host-to-device
   copy of the same bytes; dec's decoders' gaps; the memory reading.
17. ``fleet_http`` — the fleet across two processes on the one card, at
   llama-3-8b's full width and 4 layers (the package's ``llama-3-8b-shallow``
   preset: the replica draws its tree by name; the ``fleet`` phase's engine settings:
   bf16, paged, page 64, max_seq_len 4096, max-batch 8, decode chunk 16,
   ``prefix-cache`` auto, buckets 32…2048): this process runs
   ``TorchServingProvider`` with ``fleet: auto`` and ``fleet-role:
   prefill``; one replica process (``python -m
   langstream_tpu_torch.serving.fleet``, ``fleet-role: decode``) draws its
   own tree from the same seed and serves its HTTP routes on a loopback
   port. Traffic: the ``fleet`` phase's 8 prompts of 2100…3850 byte tokens,
   32 new tokens each, greedy, all at once through the provider's
   completions service. (1) The reference: the provider's router with
   migration off (every request decodes in place here), and the drill's and
   the weights check's prompts one at a time. (2) The drill: a prompt
   prefilled here, its pages pushed to the replica, whose first stream frame
   its ``wire-fault-injection: net-cut@1`` cuts: the stream fails over to
   this process with the reference's tokens (or one-ulp ties). (3) The
   weights check: one prompt served by the replica alone, its tokens this
   process's (or ties). (4) The burst, disaggregated over HTTP with v2
   negotiated (``lstpu-kvmig-v2`` pushes, ``lstpu-frames-v2`` streams):
   prefill and the first token here, each 32-page prefix pushed to the
   replica and decoded there. Required: tokens the reference's (or ties); 8
   migrations and no fallback; this process's pages out 256, read back
   from the replica's pool over ``POST /fleet/pages`` and held to the
   sender's stamps; launches exactly layers x (segments, decode steps) here
   (counts zeroed before the burst) and in the replica (its life, reported
   on its exit line). (5) A cancel: a request under ``cancel-key``, decoded
   on the replica, cancelled in this process after 3 chunks — the cancel
   forwarded over ``POST /fleet/cancel``, the stream ends ``cancelled``, the
   replica's slot freed. Then the provider closes, the replica's stdin
   closes: it drains, exits 0 with its counters (pages in = this process's
   out over the phase, its pool leak-free), and the card's free memory is
   back. Printed: each request's TTFT, handoff gap and total against pass
   1's (and the ``fleet`` phase's when it ran), each migration's phases,
   bytes and GB/s beside one pinned copy, the wire bytes of each codec.
18. ``spmd``    — the SPMD plane at llama-3-8b's full width (bf16, random
   weights from ``--seed``), paged, prefix reuse and speculation on,
   ``spmd-parity-echo`` on. (a) A leader engine and a follower engine in
   this process over a loopback channel at 8 of the 32 layers
   (``SHALLOW_LAYERS``, as ``graphs``), one weight tree (each graph set's capture announced as ``OP_WARMUP`` and the two
   engines' captures serialised): the ``e2e`` prompts, 64 new tokens,
   greedy, through the leader; every decode chunk and verify echoed and
   held by the follower; launches exactly 2 x layers x (steps + verifies)
   in the process (each engine's half); the line reports announces, wire
   bytes a block and the mean announce ms. Then a dropped idle heartbeat
   (``spmd-drop``) must resync once; an ``spmd-crash`` must recover once,
   both sides rebuilding and capturing again, and the prompts served again
   must give the same tokens (or one-ulp ties); a planted echo corruption
   must end the follower with ``SpmdDivergenceError`` and an
   ``spmd-divergence`` dump. (b) and (c) serve the package's
   ``llama-3-8b-shallow`` preset (full width, 4 layers), each process
   drawing its tree from the seed. (b) The provider, built through the port's
   ``REGISTRY``, with ``mesh: {data: 2}``: this process is rank 0 and the
   provider starts rank 1 on the same card (``python -m
   langstream_tpu_torch.parallel.spmd_serving``; its log under
   ``build/spmd/``); 8 requests through the completions service with echo
   on; ``close()`` must see the follower exit 0, its exit line's launches
   above 0, and the card's free memory back within 2 GiB. (c) The provider
   with ``mesh: {model: 1}`` — a world-1 NCCL group, the TP collectives
   inside the captured chunks — against one without a mesh on the same
   weights, each request served alone: tokens bit-equal; each decode
   step's device ms (back-to-back replays). (a) and (b) keep the tiers
   off (``constrained-decoding: off``) and each gains a tier pass with
   them on: two seeded adapters at scale 0.5, constrained decoding, and
   the host KV tier over a 40-page pool where a 1641-token chat history
   demotes the other session's hibernated prefix. 8 requests one at a
   time (session A, session B, an adapter, a grammar, an adapter with a
   grammar, a plain turn, A returning — restored —, B returning with
   ``spmd-restore`` planted): (a) on a new loopback pair with echo on,
   (b) through the provider with ``mesh: {data: 2}`` and its follower
   process. Each fails unless the follower replays every chunk (echo)
   and stops cleanly, every constrained output ends inside its grammar,
   the tokens equal a no-mesh engine's (or provider's) on the same tree
   (one-ulp ties excepted), A's return restores with every restored page
   read back bit-equal to its arena blocks on each rank, the drill falls
   back on both ranks (one counted recompute), and each engine launches
   exactly layers x decode steps paged decode kernels, layers x cold
   groups prefill kernels and layers x warm admissions segment kernels
   (the follower process's from its exit line, which also carries its
   restores, swaps and arena bytes).
19. ``ring``    — ring prefill over the seq axis at llama-3-8b's full
   width and 8 of its 32 layers (``SHALLOW_LAYERS``; bf16, random weights from ``--seed``). Two seq ranks
   cannot share one card under NCCL, so the ring runs as an in-process
   loopback pair (``spmd_serving.LoopbackRing``, two threads). (a)
   ``ring_prefill`` of a 7001-token prompt padded to 8192 over the pair
   against the port's dense chunked prefill (4 segments of 2048) on the
   same weights: last-token logits within 5% of the largest, top-1 equal,
   layer 0's K/V within ``RING_KV_TOL``; both timed, the ring's peak
   memory. (b) A leader and a follower engine as the {seq: 2} pair
   (``LoopbackChannel`` with echo), dense, max_seq_len 8192: the ``dense``
   phase's 8 requests (21..7001 tokens), 32 new tokens each, greedy.
   Required: the 3001- and 7001-token prompts ring-admitted (the
   ``ring-admissions-total`` count, no segment), each engine's dense
   decode launches exactly layers x decode steps, each engine's replays
   = chunks, every request its 32 tokens, tokens equal to the ``dense``
   phase's segment loop or one-ulp ties (``_same_or_tie``), and the
   follower's tokens, positions and ring slots' cache rows bit-equal to
   the leader's; the ring prompts' TTFT beside the segment loop's. Then
   the ``dense_int8`` phase's 3001-token prompt over an int8 dense cache
   (16 new tokens), the same checks against that phase's tokens. (The
   segment loop's tokens come from ``dense`` / ``dense_int8`` when they
   ran in the same process, else the phase serves them.) No gain is expected: both ranks share one card.
20. ``load``    — serve a safetensors checkpoint: ``llama-3-8b-shallow``
   (llama-3-8b's full width at 4 of its 32 layers: the depth is cut so the
   default run keeps its time with the ``fleet`` phase; the seeded tree,
   bf16, 3.85 GB) written by ``save_params_hf`` in shards of at most 5 GB
   (the published checkpoint's shard size: one shard) under ``build/ckpt/``, flushed and dropped from the page
   cache; loaded streamed with 4 workers
   (first, then again) and eagerly, each tree ``torch.equal`` to the
   written one, each load's total / read / transform / transfer seconds,
   staging peak and GB/s beside a plain sequential read of the shards
   (after another drop, then again) and one pinned 1 GiB host-to-device
   copy; loaded int8 on load, bit-equal to ``quantize_params`` of the
   written tree, with the device's peak over the load beside the int8 tree
   plus one bf16 layer; served through the provider (``weights: <dir>``,
   streamed) bf16 — the ``e2e`` requests, 64 new tokens, one after another
   — and int8 on load (16 new tokens), each token-exact against an engine
   over the in-memory tree (its ``quantize_params``) served the same way,
   launches required as in ``e2e``, with the cold start from the provider's
   construction to the first token split into load, engine build and graph
   capture, and the memory plan's total beside ``max_memory_allocated``
   after ``start()`` and after the first admission and the allocator's
   growth (the weights and pool terms exact; a peak past the plan fails —
   with int8 weights the plan charges the widened weights of the graph
   pool and the eager path); then a copy of the last shard one byte
   short must raise ``WeightLoadError`` naming the shard and a tensor
   when the index is built, before any upload, and
   ``fault-injection: weight-load@1`` through the provider must leave no
   engine and no params, the injector fired once. The checkpoint is
   deleted and both trees freed before ``moe``.
21. ``moe``     — mixtral-8x7b at full width and depth (32 layers, 8
   experts, top-2) with int8 weights drawn on the card (46.9 GB; the
   llama weights are dropped first), paged bf16 KV, max_seq_len 4096: 9
   requests of 21..3001 tokens, 32 new each (the 3001-token prompt takes 2
   paged segments through ``moe_ffn``); tokens/s, TTFT, peak memory (under
   80 GB) and the mean decode step. Then the kernel path against the
   reference path (a 200-token prompt, 4 paged decode steps) and one
   layer's ``moe_ffn`` timed at decode (8 tokens) and at a 2048-token
   segment beside its weight-byte bound.
22. ``app``     — the application plane on the card: the example app
   ``examples/applications/tpu-completions`` copied under ``build/app/``
   (its ``tpu-serving`` resource given ``max-seq-len`` 2048, room for the
   longest question with the chat template and 256 new tokens, and this
   run's ``seed``; an instance of its own sets ``serving-model``
   llama-3-8b: full width and depth, bf16, random weights) run through the
   code of ``python -m langstream_tpu_torch.cli run local`` (parser,
   planner, memory broker, local runner, document-to-json and the
   chat-completions step, the port's ``tpu-serving`` provider, the chat
   gateway on a free port, ``/metrics``). 8 chat websockets, one
   ``sessionId`` each, ask the ``e2e`` phase's prompt lengths at once
   (greedy) and read answer messages until each one's last chunk. Every
   answer's chunks must equal the text of its tokens, and its tokens the
   same questions served directly through the provider's
   ``get_chat_completions`` (equal, or a one-ulp tie as the fleet phases
   hold them); the debug topic's final records carry the same answers;
   the prefill and paged decode kernels' launches are exactly layers x
   admit groups and layers x decode steps (no segment, no plain version,
   every decode chunk a graph replay). It prints, per request, the
   client's TTFT (websocket send to first answer message) beside the
   engine's ``ttft_ms``, then the burst's seconds and answer tokens/s,
   with the card's name and power limit.
23. ``rag``     — the RAG app on the card: the example app
   ``examples/applications/tpu-rag`` copied under ``build/rag/`` (its
   ``tpu-serving`` resource given ``max-seq-len`` 2048, ``weights:
   random`` and this run's seed; the crawl's ``seed-urls`` and
   ``allowed-domains`` pointed at a site on the loopback, its politeness
   delay lowered to ``RAG_MIN_TIME_MS``; the vector store's ``path`` under
   ``build/rag/``; an instance serving llama-3-8b: full width and 8 of its
   32 layers, ``SHALLOW_MODEL``, bf16), run through the code of ``run local``. The site
   (``ThreadingHTTPServer`` on 127.0.0.1) has 50 seeded pages of ~3.5 KB of
   text linking each other and another host, a path ``robots.txt``
   disallows and a link that answers 404. The crawl pipeline (crawl,
   extract, split at 400 / 50, embed on the card, index in the on-card
   store) must emit exactly the pages a plain breadth-first crawl of the
   site's own link lists gives (robots, domains, the 404, ``max-urls``
   50), index as many rows as the port's splitter gives chunks over those
   pages on the host, each stored vector within ``EMBED_TOL`` of the
   provider's direct encode of its text. Then 8 questions at once through
   the ``ask`` service gateway over HTTP: each one's top-10 must equal a
   plain f64 cosine top-k over the saved ``.npz`` index (swaps only within
   ``VECTOR_TIE``), its re-rank picks a plain f64 MMR over the hits (only
   within ``RAG_MMR_TIE``), its answer the direct path's on the same
   prompt (equal or a one-ulp tie), and the prefill and paged decode
   launches exactly layers x admit groups and layers x decode steps (a
   segment only for a chunked prompt, counted; no plain version, every
   decode chunk a replay). It prints the crawl's pages/s, chunks embedded
   a second and the embed's share of the write path, the top-k's time a
   query, per question send to answer, engine TTFT and the time in embed /
   search / re-rank / completion, the burst's answer tokens/s and the
   phase's seconds, each with the card's name and power limit.
24. ``remote``  — the remote providers, gateway authentication and the
   flow / HTTP / storage agents on the card: three example apps, each
   copied under ``build/remote/`` (the files under ``examples/`` stay as
   they are) and run through the code of ``run local`` with an instance
   serving llama-3-8b (full width and 8 of its 32 layers, ``SHALLOW_MODEL``,
   bf16, random weights from this run's seed; each ``tpu-serving`` resource given ``max-seq-len``
   2048). The outside services are stdlib stubs on the loopback.
   (a) ``gateway-authentication``: Google sign-in (its ``certs-uri``
   pointed at a JWKS stub, the example's ``client-id``) over the chat on
   the card; the tokens are signed on the stdlib with a fixed RSA-2048 key
   (``REMOTE_RSA_*``, test data). 8 chat websockets at once, each its own
   ``sub``, ask the ``e2e`` phase's prompt lengths: each answer's
   ``langstream-user`` header must be its token's subject, each answer its
   request's tokens, the tokens the direct path's (the same requests
   straight to the engine; equal or a one-ulp tie), the launches exact
   (prefill layers x admit groups, paged decode layers x decode steps,
   replays = chunks); five connects must be refused with 401 and reach no
   engine (a tampered signature, an expired token, a wrong audience, an
   unknown ``kid``, ``test-credentials`` with no test provider). It prints
   each session's websocket connect to answer and the stdlib RSA check's
   ms a token. (b) ``slack``: 8 pages of the ``e2e`` lengths into
   ``pages-topic``; ``ai-text-completions`` on the card, then
   ``http-request`` POSTs each summary to a webhook stub: the stub must
   get 8 bodies, each ``{"text": "<its record's summary>"}``, each
   ``notified-topic`` record the stub's answer in ``slack-response``, the
   summaries the engine's tokens and the direct path's, the launches
   exact. (c) ``rag-aws``: ``ingest.yaml`` reads 4 objects from an S3
   stub (a ListObjectsV2 listing, then GETs; the copy keeps the objects,
   structures each chunk with ``document-to-json`` and sizes the index to
   the model's 4096), extracts, splits, embeds on the card and indexes in
   the on-card store: the rows must be the host's chunks, each vector
   within ``EMBED_TOL`` of a direct encode; then 2 questions through
   ``chatbot.yaml`` (embed on the card, query the store, a Bedrock stub
   answers): every S3 and Bedrock request signed SigV4 (the scope's region
   and service, ``host`` and ``x-amz-date`` signed, a 64-hex signature),
   the stub given each question's retrieved texts, each answer the stub's.
   No attention kernel runs in (c): the embeddings are computed outside
   any kernel, as in JAX. The build phase also prints whether ``grpc``,
   ``google.protobuf`` and ``cryptography`` import on the machine.
25. ``python``  — apps whose steps are user Python, each in a child process
   over the gRPC bridge (``grpc_runtime/``), run through the code of ``run
   local`` (the files under ``examples/`` stay as they are): (a)
   ``python-agent`` as it stands, its user code included: 16 keyed records
   in, each ``value + "!!"`` out with its key, in order; then the
   ``process`` round trip to that child, one record (200 trips) and a
   batch of 64 short records (50 trips), p50 / p99. (b)
   ``python-source-sink`` with its sink's file under ``build/python/``:
   the 10 ticks, shouted, in order. (c) a served app written under
   ``build/python/served/``: a ``python-source`` emits 8 questions of the
   ``e2e`` lengths (and records its commits), ``ai-chat-completions`` on
   ``tpu-serving`` answers them (llama-3-8b, full width and 8 of its 32
   layers, ``SHALLOW_MODEL``, bf16, random weights from this run's seed, paged, 64 new tokens), a
   ``python-processor`` wraps each answer into an Avro record ``{question,
   answer, n}``, ``compute`` adds 1000 to ``n`` (the Avro path of
   ``MutableRecord``), a ``python-sink`` writes JSON lines: every answer
   its request's tokens and the direct path's (equal or a one-ulp tie),
   8 commits, the schema interned once a stream on the runtime side,
   every sink row an Avro value of that schema with ``n`` edited, the
   launches exact (prefill layers x admit groups, paged decode layers x
   decode steps, replays = chunks, no segment, no plain version). (d) the
   processor's child kills itself (``os._exit(13)``) at its first record,
   once: the bridge restarts it mid-serve (a new pid), the batch fails and
   comes back, every answer reaches the sink exactly once by key, the
   launches stay exact. (e) every child reports no module of the JAX
   package loaded (the source loads the two examples' user modules first)
   and an empty ``CUDA_VISIBLE_DEVICES``; no child holds a ``/dev/nvidia*``
   file, and ``nvidia-smi --query-compute-apps`` lists no process but
   this one. It prints each child's spawn to banner, the round trips, the
   burst's answer tokens/s, each request's engine TTFT and the phase's
   seconds, each with the card's name and power limit.
26. ``control`` — the control plane on the card: ``ControlPlaneServer``
   (``webservice/``) over ``make_local_service`` on a disk root under
   ``build/control/``, a gateway serving the runner its runtime manager
   holds, and the port's ``AdminClient``. The ``app`` phase's
   tpu-completions copy (its step asking 64 new tokens, its resource's seed
   read from the instance) is deployed over HTTP (a multipart zip and an
   instance; llama-3-8b at full width and 8 of its 32 layers,
   ``SHALLOW_MODEL``, bf16, random weights), 8
   chat websockets ask the ``e2e`` lengths, ``apps get`` and ``apps list``
   report it; two ``apps logs -f`` streams (one ``--filter`` to the chat
   step's replica) must see a runner task's line tagged with its replica,
   an engine build or capture line tagged ``app`` and no seq twice, and
   end at the update. The update (``PATCH``, the instance's seed changed)
   must stop the old engine's thread and release its tree before the new
   one draws (the peak over the update and round 2 at most round 1's + 1
   GiB), leave one engine serving, and answer at least one question
   differently; the delete must bring allocated memory within 64 MiB of
   the baseline before the deploy, answer ``apps get`` with 404 and end
   the log stream. In each round every answer is the text of its
   request's tokens and the launches are exact (prefill layers x admit
   groups, paged decode layers x decode steps, replays = chunks). It
   prints each round's client TTFTs, answer tokens/s, deploy (update) to
   first token and the served decode step's wall with the log hub and
   without, each HTTP call's seconds, the memory readings and the phase's
   seconds, with the card's name and power limit.
27. ``brokers`` — the ``app`` phase's tpu-completions traffic over each
   broker's wire: ``streamingCluster.type`` ``kafka``, ``pulsar`` and
   ``pravega`` in turn, each against the port's own fake broker in a child
   process of its own (``messaging/fake_process.py``: stdlib asyncio, no
   torch, no card), through ``run local``'s code with the 8 chat
   websockets at the ``APP_BYTES`` lengths and random weights from
   ``--seed``. kafka (the production instance's broker) serves llama-3-8b
   at full width and depth, pulsar and pravega at ``SHALLOW_LAYERS``. Each
   run holds: every answer's messages once and in order, the answers'
   tokens against the same prompts without a broker (the ``app`` phase's
   answers for kafka at 32 layers, else the provider's direct path) equal
   or one-ulp ties (``_same_or_tie``), launches exact (prefill layers x
   admit groups, paged decode layers x decode steps, replays = chunks),
   the debug topic's final records, and the completions step's committed
   position on the questions topic at the broker equal to the questions
   sent. The fake is stopped and its ports closed at the end of each run,
   a failed one too. It prints each request's client TTFT, send-to-submit
   and engine-end-to-last-message ms (the two broker hops) beside the
   ``app`` phase's memory-broker figures, answer tokens/s, the host's
   pure-Python CRC-32C per record batch, and the phase's seconds, with the
   card's name and power limit.
28. ``k8s`` — the production instance (``examples/instances/kubernetes.yaml``:
   Kafka, ``computeCluster: kubernetes``, llama-3-8b) end to end, each role
   a process of its own: the port's Kafka fake, the port's API-server fake
   (``python -m langstream_tpu_torch.k8s.http_fake``), the ``operator`` and
   ``gateway`` roles and every pod (``python -m
   langstream_tpu_torch.entrypoint <role>``). The control plane runs in this
   process over a disk store, its runtime ``KubernetesRuntimeManager`` on
   the fake. The admin client deploys the ``app`` phase's tpu-completions
   copy with one card on its chat step (``resources.tpu``) over REST; the
   operator reconciles the Application CR through its setup and deployer
   jobs into Agent CRs, Secrets, Services and StatefulSets. The script plays
   the kubelet: for every StatefulSet replica it runs the init container's
   command (with ``CONTROL_PLANE_URL`` and ``TARGET_DIR``, which a cluster
   supplies), writes the config Secret where ``POD_CONFIGURATION`` points,
   and starts the runtime container's command (``HOSTNAME`` the pod's name,
   ``HTTP_PORT`` free) under a wrapper that reads the pod's own kernel
   counts, engine counters and served requests when its stdin closes. A
   warm-up question (the chat pod builds its engine at its first request),
   then 8 chat websockets at the ``APP_BYTES`` lengths go through the
   gateway role's port, 256 new tokens each, llama-3-8b at full width and
   depth.
   Then the app is deleted over REST and each pod whose StatefulSet is gone
   gets SIGTERM. Checks: the Application CR DEPLOYED; the chat StatefulSet
   requests ``nvidia.com/gpu: "1"`` on ``nvidia-h100-80gb`` with the config
   checksum annotation; every Secret's pod configuration the port's
   deployer's for the CR (the JAX deployer's, byte for byte, is held by the
   CPU tests); only the chat pod holds the card's device files; launches
   in the pod exact (prefill layers x admit groups, paged decode layers x
   decode steps, replays = chunks, no plain version, one engine start, no
   restart); answers equal to the ``app`` phase's at 32 layers (else the
   direct path) or one-ulp ties; every answer's messages once and in order;
   the 9 questions committed at the Kafka fake; after the delete no Agent
   CR, StatefulSet, Service, Secret or Job of the app left, every process
   exited, its ports closed, the card's free memory within 1 GiB of the
   phase's start. It prints each REST call and step of the deploy, each
   pod's start to ``/info``, the chat pod's draw and capture, deploy to
   the first answer token, each request's client TTFT, send to submit and
   engine end to last message, answer tokens/s beside the ``brokers``
   phase's Kafka run, the operator's reconcile passes and watch events,
   delete to the last pod's exit and the phase's seconds, with the card's
   name and power limit.
29. ``profile`` — (not run by default) three short llama-3-8b bursts, bf16
   and int8 page pools and the bf16 dense cache (8192 wide), traced with
   torch.profiler: the device's busy share of the wall and the top
   kernels (no split-K decode kernel may appear).

``--ab PARENT`` runs none of these: it compares the kernel times of another
checkout (say the parent commit, unpacked with ``git archive <commit> | tar
-x -C build/parent``) with this one's, running ``--phases build,kernels``
from each in the order parent, change, change, parent.

Every run (the default one, a partial one, ``--ab``) runs under the port's
lock-order recorder (``langstream_tpu_torch.analysis.lockorder``), armed
right after the arguments are parsed and before any module of the port is
imported (a module-level lock made earlier would go untracked): every
``threading.Lock`` made in a ``langstream_tpu_torch`` frame in this process
records which lock its thread held when it took it, across every phase at
that phase's own width and depth. Before the kernels record the run prints
``lockorder {...}``: the lock sites tracked, the locks made, the distinct
edges, the tracked acquisitions, the cycles, and the host cost of one
tracked acquire beside a real one (a loop of 1e5 on the host); any cycle in
the edge graph fails the run with the recorder's report. Child processes
(the SPMD follower, the ``fleet_http`` replica, the gRPC child, the broker
fakes, the ``k8s`` pods) run their own ``threading`` and are not watched.

Every check raises on failure, so any failure exits non-zero. On success
the last three lines are the ``{"kernels": [...]}`` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``;
a run that left out a default phase ends with ``{"partial": true, ...}``
instead, and never says ok.
Without a CUDA card, or outside a checkout of the repository, it exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import math
import random
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "e2e", "int8", "dense", "dense_int8", "paged_long", "graphs",
          "prefix", "spec", "tenancy", "agentic", "embed", "dense_tiers", "tiered", "fleet",
          "fleet_http", "spmd", "ring", "load", "moe", "app", "rag", "remote", "python",
          "control", "brokers", "k8s", "profile")
DEFAULT_PHASES = PHASES[:28]

# a run still going this many seconds after its first phase began prints
# every thread's stack to stderr: a run cut at a time limit shows where
STACKS_AT_S = 1100.0

# H100 SXM published peaks (dense), the denominators of every bound below
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card: every element must satisfy
# |out - ref| <= atol + rtol * |ref|. bf16 outputs round at 2^-8 relative;
# the flash kernels also round p to bf16 against the RUNNING max where the
# plain version uses the row's final max, while the decode kernels keep p
# in f32. Each check must also reject planted faults — the plain version
# with one 64-key V tile zeroed, or with the causal frontier or the
# lengths one off — or the run fails: the 8k-token segment's outputs
# average ~7000 keys (rms ~0.02), so a tolerance of that size sees nothing.
FLASH_TOL = {"atol": 3e-3, "rtol": 2e-2}
DECODE_TOL = {"atol": 1e-3, "rtol": 2e-2}
# kernel path vs reference attention path, end-to-end logits at 32 layers
# in bf16: relative to the largest reference logit
MODEL_REL_TOL = 5e-2

H, HKV, D, PAGE = 32, 8, 128, 64
DECODE_LENGTHS = (1, 64, 200, 511, 700, 1024, 1280, 1500)
# the second decode shape: B = 32 rows of 256, 512, ..., 8192 keys (dense
# through a T = 8192 cache, paged through a pool of exactly their pages
# plus the sink)
DECODE_LENGTHS_LONG = tuple(256 * i for i in range(1, 33))
# dense cases: the cache width, and the decode chunk's readable view of it
DENSE_T, DENSE_VIEW = 8192, 2048
# the batched segment case reads the T = 8192 cache through this view
SEGMENT_VIEW = 6024


def log(msg: str) -> None:
    print(msg, flush=True)


def _excess(out, ref, tol: dict) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 passes."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()


def hold(name: str, out, ref, tol: dict, planted: dict | None = None) -> dict:
    """Hold a kernel's output against its plain version's within ``tol``;
    with ``planted`` ({fault: the plain version's output with that fault}),
    also require the same check to reject every planted fault. Returns the
    readings for the record."""
    err = (out.float() - ref.float()).abs().max().item()
    ratio = _excess(out, ref, tol)
    if not math.isfinite(err) or not ratio <= 1.0:
        raise AssertionError(f"{name}: max abs err {err}, {ratio:.3g}x the tolerance {tol}")
    rec = {"max_abs_err": err, "tolerance": tol, "tolerance_used": ratio}
    if planted:
        rec["planted"] = {}
        for fault, wrong in planted.items():
            seen = _excess(wrong, ref, tol)
            rec["planted"][fault] = {
                "max_abs_err": (wrong.float() - ref.float()).abs().max().item(),
                "tolerance_used": seen,
            }
            if not seen > 1.0:
                raise AssertionError(f"{name}: the check cannot see the planted fault {fault} "
                                     f"({seen:.3g}x the tolerance)")
    return rec


def _zero_rows(entry, index):
    """A copy of a cache entry (tensor, or int8 dict) with ``entry[index]``
    zeroed (int8: its values, so the dequantized rows are 0)."""
    if isinstance(entry, dict):
        entry = {n: a.clone() for n, a in entry.items()}
        entry["q"][index] = 0
    else:
        entry = entry.clone()
        entry[index] = 0
    return entry


def _stale_tile(entry, row: int, tile: int, rows: int = 64):
    """A copy of a cache entry (tensor, or int8 dict) whose ``rows``-key
    tile [tile, tile + rows) of batch row ``row`` holds the tile before it —
    what a producer that refilled a ring stage late, or from the wrong
    tile, would leave. (Indexed on the leading dim: a dense row, or a
    page of a pool.)"""
    def stale(a):
        a = a.clone()
        a[row, :, tile:tile + rows] = a[row, :, tile - rows:tile]
        return a
    if isinstance(entry, dict):
        return {n: stale(a) for n, a in entry.items()}
    return stale(entry)


def _stale_scales(entry: dict, row: int, tile: int, rows: int = 64) -> dict:
    """A copy of an int8 cache entry whose ``rows``-key tile [tile, tile +
    rows) of batch row ``row`` keeps its values but holds the K scales of
    the tile before it — what a scale copy from the wrong tile would leave.
    (Indexed on the leading dim: a dense row, or a page of a pool.)"""
    s = entry["s"].clone()
    s[row, :, tile:tile + rows] = s[row, :, tile - rows:tile]
    return {"q": entry["q"], "s": s}


def _flash_rates(rec: dict, flops: float) -> None:
    """The flash rows' rate and their share of the bound, from this run."""
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch device time with CUDA events, the 50 MB L2 flushed before
    every launch (the main path finds each layer's K/V cold). A spin kernel
    queued ahead of the start event keeps the stream busy while the host
    enqueues the launch, so host-side wrapper time never reads as device
    time."""

    SPIN_CYCLES = 6_000_000  # ~3 ms at the H100's clocks

    def __init__(self, torch) -> None:
        self.torch = torch
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def phase_build(ctx: dict) -> None:
    from langstream_tpu_torch.ops import _build

    t0 = time.monotonic()
    seconds = _build.build_all()
    ctx["build_s"] = time.monotonic() - t0
    log(f"build: {ctx['build_s']:.1f}s total; per source {json.dumps(seconds)}")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line:  # which instantiation the next lines report
                    m = re.search(r"(flash_segment|decode_cluster)_kernel(I\w+?E)E", line)
                    line = f"entry {m.group(1)}<{_template_args(m.group(2))}>" if m else line
                elif not re.search(r"registers|spill|error|C75\d\d", line, re.I):
                    continue
                log(f"  ptxas[{name}] {line.strip()[:220]}")
        _build.library(name)  # loads and binds every symbol
    log(f"packages: {json.dumps(_package_versions())} (grpc and protobuf: the python "
        "agents' gRPC bridge, driven by the python phase)")
    for name, ops in SASS_OPS.items():
        mix = sass_mix(_build.library_path(name), ops)
        log(f"sass[{name}] {json.dumps(mix['all'])}")
        for kind in ("bf16", "int8"):  # the instantiations of each cache type
            log(f"sass[{name} {kind}] {json.dumps(mix[kind])}")
    log(f"card: {smi_line()}")


def _package_versions() -> dict:
    """Whether ``grpc``, ``google.protobuf`` and ``cryptography`` import on
    this machine, with their versions."""
    import importlib

    out = {}
    for name in ("grpc", "google.protobuf", "cryptography"):
        try:
            mod = importlib.import_module(name)
            out[name] = getattr(mod, "__version__", "imported, no __version__")
        except Exception as e:  # noqa: BLE001 — absent or broken: record which
            out[name] = f"not importable: {type(e).__name__}: {e}"[:160]
    return out


def _template_args(mangled: str) -> str:
    """'IaLi128ELi4E' → 'int8, 128, 4' (the kernels' template arguments)."""
    names = {"a": "int8", "13__nv_bfloat16": "bf16"}
    return ", ".join(names.get(t, t.strip("LiE"))
                     for t in re.findall(r"Li\d+E|13__nv_bfloat16|a", mangled[1:]))


# the instruction families that show each library's design in its SASS:
# HGMMA (wgmma), UTMALDG (TMA tensor loads), UBLKCP (bulk copies), SYNCS
# (mbarrier operations), UCGABAR (cluster barriers), HMMA (mma.sync, none
# expected), SHFL (warp shuffles), MUFU (ex2 and the rest), I2F and F2F
# (quarter-rate conversions; the decode kernel widens int8 with PRMT and an
# FADD instead)
SASS_OPS = {
    "flash_segment": ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "MUFU"),
    "ragged_decode": ("UBLKCP", "SYNCS", "UCGABAR", "SHFL", "HMMA", "MUFU", "I2F", "F2F",
                      "PRMT"),
}


def sass_mix(lib: Path, families: tuple) -> dict:
    """Counts of the instructions of each family in a library's SASS
    (cuobjdump from the toolkit) → {"all": counts, "bf16": counts of the
    bf16-cache instantiations, "int8": of the int8 ones}. A family is the
    opcode itself, or the opcode and a suffix after "_" (UCGABAR_ARV) — so
    F2F counts no F2FP, I2F no I2FP."""
    from langstream_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {key: dict.fromkeys(families, 0) for key in ("all", "bf16", "int8")}
    parts = re.split(r"Function : (\S+)", sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        kind = "int8" if re.search(r"_kernelIa", name) else "bf16"
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
            for f in families:
                if op == f or op.startswith(f + "_"):
                    counts["all"][f] += 1
                    counts[kind][f] += 1
    return counts


def _prefill_case(torch, ctx, timer, b: int, s: int, cfg=None) -> dict:
    """The prefill kernel at B x S, at ``cfg``'s head counts (default
    llama-3-8b's)."""
    import torch.nn.functional as F

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_prefill_attention,
        flash_prefill_reference,
        flash_segment_reference,
    )

    cfg = cfg or MODEL_PRESETS["llama-3-8b"]
    H, HKV = cfg.n_heads, cfg.n_kv_heads  # this case's head counts
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + s)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, HKV, s, D), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, HKV, s, D), generator=g, device="cuda").to(torch.bfloat16)
    out = flash_prefill_attention(q, k, v, cfg)
    ref = flash_prefill_reference(q, k, v, cfg)
    tile = (s // 2) // 64 * 64  # a 64-key tile in the middle of the prompt
    planted = {
        "v_tile_zeroed": flash_prefill_reference(
            q, k, _zero_rows(v, (0, 0, slice(tile, tile + 64))), cfg
        ),
        "causal_off_by_one": flash_segment_reference(
            q, k, v, torch.ones(b, dtype=torch.int32, device="cuda"), cfg
        ),
        "k_tile_stale": flash_prefill_reference(q, _stale_tile(k, 0, tile), v, cfg),
    }
    check = hold(f"flash_prefill S={s}", out, ref, FLASH_TOL, planted)
    del planted
    qh = q.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qh, k, v, is_causal=True, enable_gqa=True)

        def library():
            return F.scaled_dot_product_attention(qh, k, v, is_causal=True, enable_gqa=True)
    except TypeError:  # no enable_gqa: expand K/V once, outside the timing
        ke = k.repeat_interleave(H // HKV, dim=1)
        ve = v.repeat_interleave(H // HKV, dim=1)

        def library():
            return F.scaled_dot_product_attention(qh, ke, ve, is_causal=True)

    flops = 2.0 * b * H * s * (s + 1) * D  # QK^T and PV over the lower triangle
    nbytes = 2 * (2 * b * s * H * D + 2 * b * HKV * s * D)  # q, out, k, v in bf16
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    rec = {
        "shape": f"B={b} S={s} H={H} Hkv={HKV} D={D} bf16",
        **check,
        "ms": timer.ms(lambda: flash_prefill_attention(q, k, v, cfg)),
        "plain_ms": timer.ms(lambda: flash_prefill_reference(q, k, v, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
    }
    _flash_rates(rec, flops)
    log(f"kernel flash_prefill {json.dumps(rec)}")
    return rec


def _drop_keys(entry, row: int, a: int, b: int):
    """A copy of a dense cache entry (tensor, or int8 dict) whose batch row
    ``row`` lacks keys [a, b): the keys after b move up by b - a (pair it
    with that row's length cut by b - a)."""
    def drop(x):
        x = x.clone()
        x[row, :, a:x.shape[2] - (b - a)] = x[row, :, b:].clone()
        return x
    if isinstance(entry, dict):
        return {n: drop(x) for n, x in entry.items()}
    return drop(entry)


def _pages_dense(entry, table):
    """A pool entry (tensor, or int8 dict) gathered through the table into a
    dense cache [B, Hkv, Tp * page, ...], pages clamped as the kernels do."""
    def gather(a):
        x = a[table.long().clamp(0, a.shape[0] - 1)].transpose(1, 2)  # [B, Hkv, Tp, page, ...]
        return x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:])
    if isinstance(entry, dict):
        return {n: gather(a) for n, a in entry.items()}
    return gather(entry)


def _rank_share(length: int, plan: dict) -> tuple[int, int]:
    """The keys [a, b) of a row of ``length`` keys that cluster rank 1 of
    the decode kernel reads under ``plan``."""
    from langstream_tpu_torch.ops.attention import decode_rank_tiles

    share = decode_rank_tiles(length, plan, 1)
    tr = plan["tile_rows"]
    return share.start * tr, min(length, share.stop * tr)


def _paged_table(torch, rng, lengths, spare: int):
    """A ragged page table over a shuffled pool of exactly the rows' pages
    plus ``spare`` unmapped ones; unmapped entries carry the sentinel (the
    sink page's index) → (table on the host, number of pages)."""
    need = [math.ceil(n / PAGE) for n in lengths]
    num_pages = sum(need) + spare
    perm = list(range(num_pages))
    rng.shuffle(perm)
    table = torch.full((len(lengths), max(need)), num_pages, dtype=torch.int32)
    cursor = 0
    for row, n in enumerate(need):
        table[row, :n] = torch.tensor(perm[cursor:cursor + n], dtype=torch.int32)
        cursor += n
    return table, num_pages


def _pool_entry(torch, g, shape, int8: bool):
    if int8:
        return {
            "q": torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8),
            "s": torch.rand(shape[:-1], generator=g, device="cuda") * 0.01 + 0.005,
        }
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def _decode_case(torch, ctx, timer, int8: bool, lengths_list: tuple, cfg=None) -> dict:
    """The paged decode kernel over rows of ``lengths_list``, at ``cfg``'s
    head counts (default llama-3-8b's)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        decode_launch_plan,
        paged_decode_reference,
        ragged_decode_reference,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    cfg = cfg or MODEL_PRESETS["llama-3-8b"]
    H, HKV = cfg.n_heads, cfg.n_kv_heads  # this case's head counts
    b = len(lengths_list)
    long = b > len(DECODE_LENGTHS)
    rng = random.Random(ctx["seed"] + (1 if int8 else 0) + (100 if long else 0))
    # the short case keeps 16 unmapped pages; the long one a pool of exactly
    # its rows' pages (plus the sink)
    table, num_pages = _paged_table(torch, rng, lengths_list, 0 if long else 16)
    table = table.cuda()
    tp = table.shape[1]
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 7 + (100 if long else 0))
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)
    shape = (num_pages + 1, HKV, PAGE, D)  # + the sink page
    k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
    kernel = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
    out = kernel(q, k, v, lengths, table, cfg, PAGE)
    ref = paged_decode_reference(q, k, v, lengths, table, cfg, PAGE)
    name = "paged_decode_int8" if int8 else "paged_decode"
    # faults in the row of 1024 keys, whose every tile weighs in its output
    row = lengths_list.index(1024)
    n_row = math.ceil(1024 / PAGE)
    mid_page = int(table[row, n_row // 2])
    kq = k["q"] if int8 else k
    plan = decode_launch_plan(q.shape, kq.shape, kq.stride(), kq.dtype, "paged", table_width=tp,
                              scale_strides=k["s"].stride() if int8 else None)
    a, z = _rank_share(1024, plan)
    short = lengths.clone()
    short[row] -= z - a

    def stale_page(entry):
        def stale(x):
            x = x.clone()
            x[mid_page] = x[int(table[row, n_row // 2 - 1])]
            return x
        return {n: stale(x) for n, x in entry.items()} if isinstance(entry, dict) else stale(entry)

    planted = {
        "v_page_zeroed": paged_decode_reference(
            q, k, _zero_rows(v, mid_page), lengths, table, cfg, PAGE
        ),
        "lengths_one_short": paged_decode_reference(
            q, k, v, (lengths - 1).clamp_min(0), table, cfg, PAGE
        ),
        "k_tile_stale": paged_decode_reference(q, stale_page(k), v, lengths, table, cfg, PAGE),
        "split_dropped": ragged_decode_reference(
            q, _drop_keys(_pages_dense(k, table), row, a, z),
            _drop_keys(_pages_dense(v, table), row, a, z), short, cfg,
        ),
    }
    if int8:
        # the mid page's K scales from the page before it (one 64-row tile)
        stale = k["s"].clone()
        stale[mid_page] = stale[int(table[row, n_row // 2 - 1])]
        planted["scale_tile_stale"] = paged_decode_reference(
            q, {"q": k["q"], "s": stale}, v, lengths, table, cfg, PAGE
        )
    check = hold(f"{name} B={b}", out, ref, DECODE_TOL, planted)
    del planted
    tokens = sum(lengths_list)
    item = 1 if int8 else 2
    nbytes = (
        tokens * HKV * D * 2 * item  # K and V rows inside each length
        + (tokens * HKV * 2 * 4 if int8 else 0)  # their f32 scales
        + 2 * b * H * D * 2  # q in, out
        + b * 4 + sum(math.ceil(n / PAGE) for n in lengths_list) * 4  # lengths, table entries
    )
    flops = 4.0 * tokens * H * D  # q.k and p.v per (token, query head)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
    lens = (f"lengths={list(lengths_list)}" if not long
            else f"lengths=256..{lengths_list[-1]} step 256")
    rec = {
        "shape": f"B={b} {lens} H={H} Hkv={HKV} D={D} page={PAGE} "
                 + ("int8 pages, bf16 q" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, lengths, table, cfg, PAGE)),
        "plain_ms": timer.ms(
            lambda: paged_decode_reference(q, k, v, lengths, table, cfg, PAGE), iters=5
        ),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS else "operations",
    }
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["plan"] = {key: plan[key] for key in ("cluster", "tile_rows", "stages", "smem_bytes")}
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _verify_case(torch, ctx, timer) -> dict:
    """The paged decode kernel at the spec phase's verify shape: B = 8 rows
    of k + 1 = 5 queries, flattened on the card by ``verify_queries`` into
    40 single-query rows, each row's 5 sharing its table (page 64, Tp = 32:
    the engine's at max_seq_len 2048). Seven rows sit ~400 tokens in; the
    last sits 3 columns before the table's end, so its last two queries'
    lengths are capped at Tp·ps. Held against the plain version at the
    decode tolerance, which must reject planted faults: every length one
    long (a rejected draft's column read), one short, and the tables
    shifted by one flattened query. Timed beside the same 40 queries over
    pages of their own (each query its own copy of its row's pages: 5x the
    bytes) and beside the 8 rows' first queries alone (the decode step's
    launch at these lengths)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.transformer import verify_queries
    from langstream_tpu_torch.ops.attention import (
        paged_decode_reference,
        ragged_paged_decode_attention,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    s, tp = SPEC_KW["speculation_tokens"] + 1, SPEC_KW["max_seq_len"] // PAGE
    rng = random.Random(ctx["seed"] + 200)
    positions = [SPEC_PROMPT - 1 + rng.randrange(64) for _ in range(7)] + [tp * PAGE - 3]
    # each row's readable columns: through its last draft, at most the table
    columns = [min(p + s, tp * PAGE) for p in positions]
    table, num_pages = _paged_table(torch, rng, columns, 0)
    assert table.shape[1] == tp
    table = table.cuda()
    flat, lengths = verify_queries(table, torch.tensor(positions, device="cuda"), s, PAGE)
    if lengths[-3:].tolist() != [tp * PAGE] * 3:
        raise AssertionError(f"verify lengths not capped at the table: {lengths.tolist()}")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 201)
    q = torch.randn((len(lengths), H, D), generator=g, device="cuda").to(torch.bfloat16)
    shape = (num_pages + 1, HKV, PAGE, D)  # + the sink page
    k, v = _pool_entry(torch, g, shape, False), _pool_entry(torch, g, shape, False)
    out = ragged_paged_decode_attention(q, k, v, lengths, flat, cfg, PAGE)
    ref = paged_decode_reference(q, k, v, lengths, flat, cfg, PAGE)
    planted = {
        "lengths_one_long": paged_decode_reference(
            q, k, v, (lengths + 1).clamp_max(tp * PAGE), flat, cfg, PAGE
        ),
        "lengths_one_short": paged_decode_reference(q, k, v, lengths - 1, flat, cfg, PAGE),
        "tables_shifted_one_query": paged_decode_reference(
            q, k, v, lengths, flat.roll(1, 0), cfg, PAGE
        ),
    }
    check = hold(f"paged_decode verify B={len(positions)}x{s}", out, ref, DECODE_TOL, planted)
    del planted
    # the same 40 queries, each over its own copy of its row's pages
    own, own_pages = _paged_table(torch, rng, lengths.tolist(), 0)
    own = own.cuda()
    ok, ov = (_pool_entry(torch, g, (own_pages + 1, HKV, PAGE, D), False) for _ in range(2))
    first = torch.arange(0, len(lengths), s, device="cuda")
    keys = sum(columns)
    nbytes = (
        keys * HKV * D * 2 * 2  # each row's K and V columns, read once for its 5 queries
        + 2 * len(lengths) * H * D * 2  # q in, out
        + len(lengths) * 4 + sum(math.ceil(n / PAGE) for n in lengths.tolist()) * 4
    )
    flops = 4.0 * int(lengths.sum()) * H * D  # q.k and p.v per (key, query head)
    rec = {
        "shape": f"verify B={len(positions)} x {s} queries (40 rows), positions "
                 f"{positions}, table {tp} pages of {PAGE}, H={H} Hkv={HKV} D={D} bf16",
        **check,
        "ms": timer.ms(lambda: ragged_paged_decode_attention(q, k, v, lengths, flat, cfg, PAGE)),
        "plain_ms": timer.ms(
            lambda: paged_decode_reference(q, k, v, lengths, flat, cfg, PAGE), iters=5
        ),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS
                     else "operations"),
        "own_pages_ms": timer.ms(
            lambda: ragged_paged_decode_attention(q, ok, ov, lengths, own, cfg, PAGE)
        ),
        "first_queries_ms": timer.ms(lambda: ragged_paged_decode_attention(
            q[first], k, v, lengths[first], table, cfg, PAGE
        )),
    }
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel paged_decode verify {json.dumps(rec)}")
    return rec


def _sdpa(torch, q, k, v, mask):
    """One scaled_dot_product_attention call over q [B, H, S, D] and GQA
    k/v [B, Hkv, T, D] with a boolean mask (True = attend); K/V are
    expanded to H heads once, outside the timed call, where this PyTorch
    has no enable_gqa."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:
        ke = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        ve = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)


def _dense_cache(torch, g, b: int, t: int, int8: bool, hkv: int = HKV, d: int = D):
    shape = (b, hkv, t, d)
    if int8:
        return {
            "q": torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8),
            "s": torch.rand(shape[:-1], generator=g, device="cuda") * 0.01 + 0.005,
        }
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def _bf16(torch, entry):
    """The bf16 cache the int8 segment kernel computes with (dequantized
    as it does), for the library yardstick."""
    if isinstance(entry, dict):
        return (entry["q"].float() * entry["s"][..., None]).to(torch.bfloat16)
    return entry


def kv_stream_bytes(s: int, offsets, t: int, item: int, positions_per_item: int,
                    hkv: int = HKV) -> float:
    """Bytes of K and V (and int8 scales) that a segment launch streams from
    L2 into shared memory, computed from its work items: every item of
    ``positions_per_item`` query positions of one kv head reads the keys up
    to its causal frontier min(T, offset + item end), once for its whole
    group of heads (``hkv`` kv heads)."""
    row = hkv * D * 2 * item + (hkv * 2 * 4 if item == 1 else 0)  # K, V (and scales) of a key
    keys = sum(min(t, off + min(s, q0 + positions_per_item))
               for off in offsets for q0 in range(0, s, positions_per_item))
    return float(keys * row)


def _segment_case(torch, ctx, timer, int8: bool, s: int, offsets: tuple,
                  view: int | None = None, cfg=None) -> dict:
    """The segment kernel against its plain version: rows of S queries at
    ``offsets`` in a T = 8192 cache (read through a [..., :view] view where
    given), planted faults in the last row's mid-prefix, times, bound; at
    ``cfg``'s head counts (default llama-3-8b's)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
        flash_segment_int8_reference,
        flash_segment_reference,
        segment_launch_plan,
    )

    cfg = cfg or MODEL_PRESETS["llama-3-8b"]
    H, HKV = cfg.n_heads, cfg.n_kv_heads  # this case's head counts
    b = len(offsets)
    seed = ctx["seed"] + 11 + s + int8 + (100 * b if b > 1 else 0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    k = _dense_cache(torch, g, b, DENSE_T, int8, HKV)
    v = _dense_cache(torch, g, b, DENSE_T, int8, HKV)
    t = view or DENSE_T
    if view:
        k, v = ({n: a[:, :, :view] for n, a in e.items()} if int8 else e[:, :, :view]
                for e in (k, v))
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kernel = flash_segment_attention_int8 if int8 else flash_segment_attention
    plain = flash_segment_int8_reference if int8 else flash_segment_reference
    out = kernel(q, k, v, off, cfg)
    ref = plain(q, k, v, off, cfg)
    name = "flash_segment_int8" if int8 else "flash_segment"
    last = b - 1
    tile = (offsets[last] // 2) // 64 * 64  # a 64-key tile in the middle of the last row's prefix
    planted = {
        "v_tile_zeroed": plain(q, k, _zero_rows(v, (last, 0, slice(tile, tile + 64))), off, cfg),
        "causal_off_by_one": plain(q, k, v, off + 1, cfg),
        "k_tile_stale": plain(q, _stale_tile(k, last, tile), v, off, cfg),
    }
    where = f"S={s} offset={offsets[0]}" if b == 1 else f"B={b} S={s} offsets={list(offsets)}"
    check = hold(f"{name} {where}", out, ref, FLASH_TOL, planted)
    del planted
    pos = off.long()[:, None] + torch.arange(s, device="cuda")[None, :]  # [B, S]
    mask = torch.arange(t, device="cuda")[None, None, :] <= pos[:, :, None]  # [B, S, T]
    library = _sdpa(torch, q.transpose(1, 2), _bf16(torch, k), _bf16(torch, v),
                    mask[0] if b == 1 else mask[:, None])
    # work this input needs: query i of row r sees keys [0, offset_r + i];
    # the cache rows below offset_r + S are read once, q read and out
    # written once
    pairs = sum(min(o + i + 1, t) for o in offsets for i in range(s))
    flops = 4.0 * H * D * pairs
    rows = sum(min(o + s, t) for o in offsets)
    item = 1 if int8 else 2
    nbytes = (2 * 2 * b * s * H * D + rows * HKV * D * 2 * item
              + (rows * HKV * 2 * 4 if int8 else 0) + 4 * b)
    plan = segment_launch_plan(q.shape, (b, HKV, t, D), (k["q"] if int8 else k).stride(),
                               torch.int8 if int8 else torch.bfloat16,
                               scale_strides=k["s"].stride() if int8 else None)
    shape = (f"B=1 S={s} offset={offsets[0]} T={DENSE_T}" if b == 1 else
             f"B={b} S={s} offsets={list(offsets)} view T={t} of {DENSE_T}")
    rec = {
        "shape": f"{shape} H={H} Hkv={HKV} D={D} "
                 + ("int8 cache, bf16 q; SDPA over the dequantized cache" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, off, cfg)),
        "plain_ms": timer.ms(lambda: plain(q, k, v, off, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": (
            "operations" if flops / PEAK_BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        ),
        "grid": plan["grid"],
        "work_items": plan["work_items"],
        "l2_kv_gb": kv_stream_bytes(s, offsets, t, item, plan["positions_per_item"], HKV) / 1e9,
    }
    _flash_rates(rec, flops)
    rec["l2_kv_tb_per_s"] = rec["l2_kv_gb"] / rec["ms"]  # GB per ms is TB/s
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _dense_decode_case(torch, ctx, timer, int8: bool, lengths_list: tuple, view: int,
                       width: int = DENSE_T) -> dict:
    """Dense decode against its plain version: rows of ``lengths_list`` keys
    through a [..., :view] view of a cache ``width`` columns wide (8192, or
    the engine's 8193 with its sink column; view == width: the whole
    cache), planted faults in the row of 1024 keys, times, bound."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        decode_launch_plan,
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_decode_reference,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(lengths_list)
    long = b > len(DECODE_LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 21 + int8 + (100 if long else 0))
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)

    def cut(entry):
        if isinstance(entry, dict):
            return {n: a[:, :, :view] for n, a in entry.items()}
        return entry[:, :, :view]

    k = cut(_dense_cache(torch, g, b, width, int8))
    v = cut(_dense_cache(torch, g, b, width, int8))
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device="cuda")
    kernel = ragged_decode_attention_int8 if int8 else ragged_decode_attention
    out = kernel(q, k, v, lengths, cfg)
    ref = ragged_decode_reference(q, k, v, lengths, cfg)
    name = "dense_decode_int8" if int8 else "dense_decode"
    # faults in the row of 1024 keys, whose every tile weighs in its output
    row = lengths_list.index(1024)
    tile = 512  # a mid-row tile of that row
    kq = k["q"] if int8 else k
    plan = decode_launch_plan(q.shape, kq.shape, kq.stride(), kq.dtype, "dense",
                              scale_strides=k["s"].stride() if int8 else None)
    a, z = _rank_share(1024, plan)
    short = lengths.clone()
    short[row] -= z - a
    planted = {
        "v_tile_zeroed": ragged_decode_reference(
            q, k, _zero_rows(v, (row, slice(None), slice(tile, tile + 64))), lengths, cfg
        ),
        "lengths_one_short": ragged_decode_reference(
            q, k, v, (lengths - 1).clamp_min(0), cfg
        ),
        "k_tile_stale": ragged_decode_reference(
            q, _stale_tile(k, row, tile, plan["tile_rows"]), v, lengths, cfg
        ),
        "split_dropped": ragged_decode_reference(
            q, _drop_keys(k, row, a, z), _drop_keys(v, row, a, z), short, cfg
        ),
    }
    if int8:
        planted["scale_tile_stale"] = ragged_decode_reference(
            q, _stale_scales(k, row, tile, plan["tile_rows"]), v, lengths, cfg
        )
    check = hold(f"{name} B={b}", out, ref, DECODE_TOL, planted)
    del planted
    mask = torch.arange(view, device="cuda")[None, :] < lengths.long()[:, None]  # [B, T]
    library = _sdpa(
        torch, q[:, :, None], _bf16(torch, k), _bf16(torch, v), mask[:, None, None, :]
    )
    tokens = sum(min(n, view) for n in lengths_list)
    item = 1 if int8 else 2
    nbytes = (
        tokens * HKV * D * 2 * item  # K and V rows inside each length
        + (tokens * HKV * 2 * 4 if int8 else 0)  # their f32 scales
        + 2 * b * H * D * 2  # q in, out
        + b * 4  # lengths
    )
    flops = 4.0 * tokens * H * D  # q.k and p.v per (token, query head)
    lens = (f"lengths={list(lengths_list)}" if not long
            else f"lengths=256..{lengths_list[-1]} step 256")
    where = f"view T={view} of {width}" if view < width else f"T={width}"
    rec = {
        "shape": f"B={b} {lens} {where} H={H} Hkv={HKV} D={D} "
                 + ("int8 cache, bf16 q" if int8 else "bf16"),
        **check,
        "ms": timer.ms(lambda: kernel(q, k, v, lengths, cfg)),
        "plain_ms": timer.ms(lambda: ragged_decode_reference(q, k, v, lengths, cfg), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS else "operations",
    }
    if not long:
        # the masked read the JAX package takes under "auto" (reference
        # attention over the bounded view, int8 through its hoisted-scale path)
        masked_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8" if int8 else "model")
        rec["masked_path_ms"] = timer.ms(
            lambda: tf.attention(q[:, None], k, v, mask[:, None, :], masked_cfg), iters=5
        )
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["plan"] = {key: plan[key] for key in ("cluster", "tile_rows", "stages", "smem_bytes")}
    log(f"kernel {name} {json.dumps(rec)}")
    return rec


def _rows_shifted(entry):
    """A copy of a dense cache entry (tensor, or int8 dict) whose row r
    holds row r + 1 (the last row wraps to row 0): the cache a flattened
    verify reads when query row q takes cache row q / qpr + 1."""
    if isinstance(entry, dict):
        return {n: a.roll(-1, 0) for n, a in entry.items()}
    return entry.roll(-1, 0)


def _dense_verify_case(torch, ctx, timer, int8: bool) -> dict:
    """The dense decode kernel at the dense verify's flattened shape: 8
    cache rows of k + 1 = 5 queries (``queries_per_row`` 5, 40 query rows),
    seven rows ~400 tokens in and one at 2045, through a [..., :2048] view
    of a T 8192 cache (the last row's last two lengths capped at the
    view). Held against the plain version at the decode tolerance, which
    must reject planted faults: every length one long (a rejected draft's
    column), one short, the row map off by one (query row q reading cache
    row q / 5 + 1), a zeroed V tile of the long row (int8: a stale scale
    tile too). NaN past every row's longest length leaves the output
    bit-equal. Timed beside the 8 rows' first queries alone at qpr 1 (the
    decode step's launch at these lengths) and SDPA over the same queries
    with a per-query length mask."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.transformer import dense_verify_queries
    from langstream_tpu_torch.ops.attention import (
        decode_launch_plan,
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_decode_reference,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    s = SPEC_KW["speculation_tokens"] + 1
    rng = random.Random(ctx["seed"] + 300 + int8)
    positions = [SPEC_PROMPT - 1 + rng.randrange(64) for _ in range(7)] + [DENSE_VIEW - 3]
    b = len(positions)
    lengths = dense_verify_queries(torch.tensor(positions, device="cuda"), s, DENSE_VIEW)
    if lengths[-2:].tolist() != [DENSE_VIEW] * 2:
        raise AssertionError(f"dense verify lengths not capped at the view: {lengths.tolist()}")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 301 + int8)
    q = torch.randn((b * s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    full_k, full_v = (_dense_cache(torch, g, b, DENSE_T, int8) for _ in range(2))

    def view(entry):
        if isinstance(entry, dict):
            return {n: a[:, :, :DENSE_VIEW] for n, a in entry.items()}
        return entry[:, :, :DENSE_VIEW]

    k, v = view(full_k), view(full_v)
    kernel = ragged_decode_attention_int8 if int8 else ragged_decode_attention
    name = "dense_decode_int8" if int8 else "dense_decode"
    out = kernel(q, k, v, lengths, cfg, queries_per_row=s)
    ref = ragged_decode_reference(q, k, v, lengths, cfg, s)
    kq = k["q"] if int8 else k
    plan = decode_launch_plan((b * s, H, D), kq.shape, kq.stride(), kq.dtype, "dense",
                              scale_strides=k["s"].stride() if int8 else None,
                              queries_per_row=s)
    row, tile = b - 1, 1024  # the long row, a mid-row tile
    planted = {
        "lengths_one_long": ragged_decode_reference(
            q, k, v, (lengths + 1).clamp_max(DENSE_VIEW), cfg, s),
        "lengths_one_short": ragged_decode_reference(q, k, v, lengths - 1, cfg, s),
        "row_map_off_by_one": ragged_decode_reference(
            q, _rows_shifted(k), _rows_shifted(v), lengths, cfg, s),
        "v_tile_zeroed": ragged_decode_reference(
            q, k, _zero_rows(v, (row, slice(None), slice(tile, tile + 64))), lengths, cfg, s),
    }
    if int8:
        planted["scale_tile_stale"] = ragged_decode_reference(
            q, _stale_scales(k, row, tile, plan["tile_rows"]), v, lengths, cfg, s)
    check = hold(f"{name} verify {b}x{s}", out, ref, DECODE_TOL, planted)
    del planted
    # NaN past every row's longest query, inside the view and beyond it
    longest = lengths.view(b, s).max(dim=1).values.tolist()

    def poisoned(entry):
        entry = {n: a.clone() for n, a in entry.items()} if int8 else entry.clone()
        leaf = entry["s"] if int8 else entry  # int8 codes cannot hold NaN: the scales
        for r, n in enumerate(longest):
            leaf[r, :, n:] = float("nan")
        return entry

    nk, nv = poisoned(full_k), poisoned(full_v)
    again = kernel(q, view(nk), view(nv), lengths, cfg, queries_per_row=s)
    if not torch.equal(again, out):
        raise AssertionError(f"{name} verify: NaN past the rows' lengths changed the output")
    del nk, nv
    first = torch.arange(0, b * s, s, device="cuda")
    mask = (torch.arange(DENSE_VIEW, device="cuda")[None, None, :]
            < lengths.view(b, s).long()[:, :, None])  # [B, S, T]
    library = _sdpa(torch, q.view(b, s, H, D).transpose(1, 2), _bf16(torch, k), _bf16(torch, v),
                    mask[:, None])
    item = 1 if int8 else 2
    keys = sum(longest)  # each row's K and V, read once for its 5 queries
    nbytes = (keys * HKV * D * 2 * item + (keys * HKV * 2 * 4 if int8 else 0)
              + 2 * b * s * H * D * 2 + b * s * 4)
    flops = 4.0 * int(lengths.sum()) * H * D
    rec = {
        "shape": f"verify {b} rows x {s} queries (qpr {s}, 40 query rows), positions "
                 f"{positions}, view T={DENSE_VIEW} of {DENSE_T} H={H} Hkv={HKV} D={D} "
                 + ("int8 cache, bf16 q" if int8 else "bf16"),
        **check,
        "nan_past_lengths_bit_equal": True,
        "ms": timer.ms(lambda: kernel(q, k, v, lengths, cfg, queries_per_row=s)),
        "plain_ms": timer.ms(lambda: ragged_decode_reference(q, k, v, lengths, cfg, s), iters=5),
        "library_ms": timer.ms(library),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS
                     else "operations"),
        "first_queries_qpr1_ms": timer.ms(
            lambda: kernel(q[first].contiguous(), k, v, lengths[first].contiguous(), cfg)),
        "plan": {key: plan[key] for key in ("queries_per_row", "grid", "cluster", "tile_rows",
                                            "stages", "smem_bytes")},
    }
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel {name} verify {json.dumps(rec)}")
    return rec


def _nan_past_length(torch, ctx) -> dict:
    """NaN written where no row may read — past each row's length inside its
    last page or tile and beyond it, and in every unmapped page (the sink
    included) — must leave each decode kernel's output bit-equal to the
    clean run: rows past a row's valid ones never reach the sums, not even
    as 0 * NaN. (The card's twin of tests/test_torch_ops.py::
    test_paged_decode_ignores_pages_past_the_length; int8 caches take the
    NaN in their scales.)"""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    b = len(DECODE_LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 41)
    q = torch.randn((b, H, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    nan = float("nan")

    def values(entry):  # where the NaN goes: bf16 values, or int8 scales
        return entry["s"] if isinstance(entry, dict) else entry

    def clone(entry):
        return {n: a.clone() for n, a in entry.items()} if isinstance(entry, dict) else entry.clone()

    seen = {}
    for int8 in (False, True):
        table, num_pages = _paged_table(torch, random.Random(ctx["seed"] + 43), DECODE_LENGTHS, 16)
        shape = (num_pages + 1, HKV, PAGE, D)
        k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
        paged = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
        clean = paged(q, k, v, lengths, table.cuda(), cfg, PAGE)
        mapped = {int(p) for p in table.flatten() if int(p) < num_pages}
        unmapped = [p for p in range(num_pages + 1) if p not in mapped]
        dirty = []
        for entry in (k, v):
            entry = clone(entry)
            for row, n in enumerate(DECODE_LENGTHS):
                if n % PAGE:
                    values(entry)[int(table[row, (n - 1) // PAGE]), :, n % PAGE:] = nan
            values(entry)[unmapped] = nan
            dirty.append(entry)
        out = paged(q, *dirty, lengths, table.cuda(), cfg, PAGE)
        seen[paged.__name__] = bool(torch.equal(clean, out))
        del k, v, dirty
        # the engine's sink-column width: int8 scale rows off the 16-byte grid
        big_k = _dense_cache(torch, g, b, DENSE_T + 1, int8)
        big_v = _dense_cache(torch, g, b, DENSE_T + 1, int8)

        def cut(entry):
            if isinstance(entry, dict):
                return {n: a[:, :, :DENSE_VIEW] for n, a in entry.items()}
            return entry[:, :, :DENSE_VIEW]

        dense = ragged_decode_attention_int8 if int8 else ragged_decode_attention
        clean = dense(q, cut(big_k), cut(big_v), lengths, cfg)
        for entry in (big_k, big_v):
            for row, n in enumerate(DECODE_LENGTHS):
                values(entry)[row, :, n:] = nan  # inside the view and beyond it
        out = dense(q, cut(big_k), cut(big_v), lengths, cfg)
        seen[dense.__name__] = bool(torch.equal(clean, out))
        del big_k, big_v
    bad = [n for n, ok in seen.items() if not ok]
    if bad:
        raise AssertionError(f"NaN past the lengths changed the output of {bad}")
    log(f"kernel nan past the length: bit-equal {json.dumps(seen)}")
    return seen


def _edge_cases(torch, ctx) -> dict:
    """The segment and decode kernels against their plain versions away
    from llama's shape: head dims 64 / 64 / 128 / 256 with groups 1 / 2 / 4
    / 8, a soft cap, per-row offsets 0 and unaligned, a segment whose
    queries run past the cache width, strided [..., :T] views; dense decode
    lengths 0, 1, a tile - 1, a tile, a tile + 1, exactly the view and past
    it; paged decode over pages of 16 (a tile each) and 128 (two tiles of
    64) with lengths 0, 1, page - 1, page, page + 1, the table's width and
    past it, unmapped entries and rows whose cluster ranks have no tiles.
    Each within its tolerance."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
        flash_segment_int8_reference,
        flash_segment_reference,
        paged_decode_reference,
        ragged_decode_attention,
        ragged_decode_attention_int8,
        ragged_decode_reference,
        ragged_paged_decode_attention,
        ragged_paged_decode_attention_int8,
    )

    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 31)
    errs = {}
    for h, hkv, d, cap in ((8, 8, 64, None), (16, 8, 64, None), (32, 8, 128, 30.0),
                           (16, 2, 256, None)):
        cfg = dataclasses.replace(
            MODEL_PRESETS["llama-3-8b"], n_heads=h, n_kv_heads=hkv, head_dim=d,
            attn_logit_softcap=cap,
        )
        for int8 in (False, True):
            # [..., :300] views of 301-column caches
            k = _dense_cache(torch, g, 3, 301, int8, hkv, d)
            v = _dense_cache(torch, g, 3, 301, int8, hkv, d)
            k, v = ({n: a[:, :, :300] for n, a in e.items()} if int8 else e[:, :, :300]
                    for e in (k, v))
            # segment: 77 queries at offsets 0, 37 and 260 (the last row's
            # queries run past the 300-column view)
            q = torch.randn((3, 77, h, d), generator=g, device="cuda").to(torch.bfloat16)
            off = torch.tensor([0, 37, 260], dtype=torch.int32, device="cuda")
            seg = flash_segment_attention_int8 if int8 else flash_segment_attention
            plain = flash_segment_int8_reference if int8 else flash_segment_reference
            name = f"{seg.__name__} H={h} Hkv={hkv} D={d} softcap={cap}"
            errs[name] = hold(name, seg(q, k, v, off, cfg), plain(q, k, v, off, cfg), FLASH_TOL)
            # dense decode over [..., :300] views of 301-column caches
            lengths = torch.tensor([0, 1, 63, 64, 65, 300, 1000], dtype=torch.int32,
                                   device="cuda")
            kd = _dense_cache(torch, g, len(lengths), 301, int8, hkv, d)
            vd = _dense_cache(torch, g, len(lengths), 301, int8, hkv, d)
            kd, vd = ({n: a[:, :, :300] for n, a in e.items()} if int8 else e[:, :, :300]
                      for e in (kd, vd))
            qd = torch.randn((len(lengths), h, d), generator=g, device="cuda").to(torch.bfloat16)
            dec = ragged_decode_attention_int8 if int8 else ragged_decode_attention
            out = dec(qd, kd, vd, lengths, cfg)
            name = f"{dec.__name__} H={h} Hkv={hkv} D={d} softcap={cap}"
            errs[name] = hold(name, out, ragged_decode_reference(qd, kd, vd, lengths, cfg),
                              DECODE_TOL)
            if bool(out[0].abs().max() != 0):
                raise AssertionError(f"{name}: a length-0 row is not 0")
            # paged decode: a table 6 pages wide over a pool of 40 (+ sink)
            paged = ragged_paged_decode_attention_int8 if int8 else ragged_paged_decode_attention
            for ps in (16, 128):
                pk, pv = (_pool_entry(torch, g, (41, hkv, ps, d), int8) for _ in range(2))
                lengths = torch.tensor([0, 1, ps - 1, ps, ps + 1, 6 * ps, 1000],
                                       dtype=torch.int32, device="cuda")
                table = torch.randint(0, 40, (len(lengths), 6), generator=g, device="cuda",
                                      dtype=torch.int32)
                table[0, 1:] = 40  # unmapped: the sentinel (the sink page)
                table[2, 1:] = 40
                out = paged(qd, pk, pv, lengths, table, cfg, ps)
                name = f"{paged.__name__} page={ps} H={h} Hkv={hkv} D={d} softcap={cap}"
                errs[name] = hold(
                    name, out, paged_decode_reference(qd, pk, pv, lengths, table, cfg, ps),
                    DECODE_TOL,
                )
    torch.cuda.synchronize()
    log(f"kernel edge cases {json.dumps(errs)}")
    return errs


def phase_kernels(ctx: dict) -> None:
    import torch

    timer = Timer(torch)
    ctx["kernel_runs"] = {
        "flash_prefill": [_prefill_case(torch, ctx, timer, 2, s) for s in (200, 1024)],
    }
    for int8 in (False, True):
        name = "paged_decode_int8" if int8 else "paged_decode"
        ctx["kernel_runs"][name] = [_decode_case(torch, ctx, timer, int8, lengths)
                                    for lengths in (DECODE_LENGTHS, DECODE_LENGTHS_LONG)]
    # the spec phase's flattened verify shape, before the widest (the record's)
    ctx["kernel_runs"]["paged_decode"].insert(1, _verify_case(torch, ctx, timer))
    for int8 in (False, True):
        name = "flash_segment_int8" if int8 else "flash_segment"
        ctx["kernel_runs"][name] = [
            _segment_case(torch, ctx, timer, int8, s, offs, view)
            for s, offs, view in (((200, (1000,), None), (1024, (0, 5000), SEGMENT_VIEW),
                                   (2048, (6144,), None)))
        ]
        name = "dense_decode_int8" if int8 else "dense_decode"
        # int8 also reads the engine's 8,193-wide cache, whose scale rows
        # are not 16-byte aligned; the widest shape stays last (the record's)
        cases = ((DECODE_LENGTHS, DENSE_VIEW, DENSE_T),)
        if int8:
            cases += ((DECODE_LENGTHS, DENSE_VIEW, DENSE_T + 1),)
        ctx["kernel_runs"][name] = [
            _dense_decode_case(torch, ctx, timer, int8, lengths, view, width)
            for lengths, view, width in cases + ((DECODE_LENGTHS_LONG, DENSE_T, DENSE_T),)
        ]
        # the dense verify's flattened shape (qpr 5), before the widest
        ctx["kernel_runs"][name].insert(-1, _dense_verify_case(torch, ctx, timer, int8))
    # the local shapes a TP-2 rank of llama-3-8b launches (H 16, Hkv 4,
    # D 128), before each kernel's widest shape (the record's)
    tp2 = _tp2_config()
    ctx["kernel_runs"]["flash_prefill"].insert(-1, _prefill_case(torch, ctx, timer, 2, 1024, tp2))
    ctx["kernel_runs"]["paged_decode"].insert(
        -1, _decode_case(torch, ctx, timer, False, DECODE_LENGTHS, tp2))
    ctx["kernel_runs"]["flash_segment"].insert(
        -1, _segment_case(torch, ctx, timer, False, 2048, (6144,), None, tp2))
    for int8 in (False, True):
        _fused_case(torch, ctx, int8)
    _nan_past_length(torch, ctx)
    _edge_cases(torch, ctx)
    del timer


def _fused_case(torch, ctx, int8: bool) -> None:
    """``fused_segment_decode_attention`` (a routing, no kernel of its own)
    at the segment shapes above: two rows of S 1024 at offsets 0 and 5000
    and two decode rows of 1500 and 700 keys read through a [..., :2048]
    bound, in one T 8192 cache of 4 rows. Its segment half must be
    bit-equal to a direct ``flash_segment_attention`` (``_int8``) call on
    the gathered rows, its decode half to the masked read over them."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.transformer import attention
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
        fused_segment_decode_attention,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 31 + int8)
    k = _dense_cache(torch, g, 4, DENSE_T, int8, hkv, d)
    v = _dense_cache(torch, g, 4, DENSE_T, int8, hkv, d)
    q_seg = torch.randn((2, 1024, h, d), generator=g, device="cuda").to(torch.bfloat16)
    q_dec = torch.randn((2, h, d), generator=g, device="cuda").to(torch.bfloat16)
    seg_rows = torch.tensor([1, 3], device="cuda")
    offsets = torch.tensor([0, 5000], dtype=torch.int32, device="cuda")
    dec_rows = torch.tensor([0, 2], device="cuda")
    dec_lengths = torch.tensor([1500, 700], device="cuda")
    seg_out, dec_out = fused_segment_decode_attention(
        q_seg, offsets, q_dec, k, v, seg_rows, dec_rows, dec_lengths, cfg, kv_bound=DENSE_VIEW)

    def rows(entry, index, cols=DENSE_T):
        if int8:
            return {n: a[index, :, :cols] for n, a in entry.items()}
        return entry[index, :, :cols]

    kernel = flash_segment_attention_int8 if int8 else flash_segment_attention
    direct = kernel(q_seg, rows(k, seg_rows), rows(v, seg_rows), offsets, cfg)
    mask = torch.arange(DENSE_VIEW, device="cuda")[None, None, :] < dec_lengths[:, None, None]
    read = attention(q_dec[:, None], rows(k, dec_rows, DENSE_VIEW), rows(v, dec_rows, DENSE_VIEW),
                     mask, cfg)[:, 0]
    rec = {"shape": f"segments B=2 S=1024 offsets=[0, 5000], decode B=2 lengths=[1500, 700] "
                    f"kv_bound={DENSE_VIEW}, T={DENSE_T} H={h} Hkv={hkv} D={d} "
                    + ("int8 cache" if int8 else "bf16"),
           "segment_bit_equal": torch.equal(seg_out, direct),
           "segment_max_abs_diff": (seg_out.float() - direct.float()).abs().max().item(),
           "decode_bit_equal": torch.equal(dec_out, read),
           "finite": bool(torch.isfinite(seg_out).all() and torch.isfinite(dec_out).all())}
    log(f"fused routing {json.dumps(rec)}")
    if not (rec["segment_bit_equal"] and rec["decode_bit_equal"] and rec["finite"]):
        raise AssertionError(f"fused_segment_decode_attention: {rec}")


def _tp2_config():
    """llama-3-8b as a TP-2 rank computes it (``parallel.sharding
    .local_config`` over model 2): H 16, Hkv 4, D 128."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.parallel.sharding import local_config

    mesh = type("Mesh", (), {"shape": {"data": 1, "expert": 1, "seq": 1, "model": 2}})()
    return local_config(MODEL_PRESETS["llama-3-8b"], mesh)


def _prompts(n_bytes: list[int], seed: int) -> list[str]:
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz     ,.ABCDEFGHIJ0123456789"
    return ["".join(rng.choice(alphabet) for _ in range(n)) for n in n_bytes]


def _serve(ctx, cfg, params, n_bytes: list[int], new_tokens: int, prompts=None,
           steady: bool = False, engine=None, sequential: bool = False, **engine_kw) -> dict:
    """Warm the engine with one short request, zero the kernel counts, serve
    the batch (``prompts`` as token lists, else byte prompts of ``n_bytes``),
    read the counts; checks every request's tokens, that no kernel's plain
    version ran, and that every decode chunk or speculative verify was one
    graph replay. With ``prompts`` the run keeps its tokens (``_tokens``);
    ``steady`` adds back-to-back replays' times once the engine stopped.
    ``engine``: serve on this (started) engine instead of building one;
    ``sequential``: each request submitted once the one before finished, so
    every admission is a group of one whatever the timing (two engines
    served so run the same shapes and give the same tokens)."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    if engine is None:
        engine = ServingEngine(
            cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
            eos_token_id=tok.eos_token_id, rng_seed=ctx["seed"], device="cuda", **engine_kw,
        )
    engine.start()
    try:
        engine.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
        keep = prompts is not None
        if not keep:
            prompts = [tok.encode(p) for p in _prompts(n_bytes, ctx["seed"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = engine.stats()
        opts = GenerationOptions(max_new_tokens=new_tokens, temperature=0.0)
        reset_kernel_counts()
        t0 = time.monotonic()
        if sequential:
            results = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)).result(
                timeout=900) for p in prompts]
        else:
            reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
                    for p in prompts]
            results = [r.result(timeout=900) for r in reqs]
        wall = time.monotonic() - t0
        counts = kernel_counts()
        run_replays = engine.stats()["graph-replays-total"] - before["graph-replays-total"]
    finally:
        engine.stop()
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"plain versions ran on the card's main path: {plain}")
    for p, r in zip(prompts, results):
        if r.error is not None or r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request of {len(p)} tokens ended {r.finish_reason}: {r.error}")
        if r.finish_reason == "length" and len(r.tokens) != new_tokens:
            raise AssertionError(f"request of {len(p)} tokens gave {len(r.tokens)} tokens")
        if any(t < 0 or t >= cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request of {len(p)} tokens has out-of-range tokens")
    with torch.no_grad():
        steady_replays = _replay_rate(torch, engine) if steady else None
        if steady:
            steady_replays["top_kernels"] = _replay_profile(torch, engine)
    after = engine.stats()
    groups = after["admit-groups-total"] - before["admit-groups-total"]
    segments = after["prefill-segments-total"] - before["prefill-segments-total"]
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    chunks = after["decode-chunks-total"] - before["decode-chunks-total"]
    verifies = after["spec-verify-dispatches-total"] - before["spec-verify-dispatches-total"]
    replays = run_replays
    # every decode chunk (with speculation: every verify) of the run is one
    # replay of a graph start() captured
    dispatches = chunks + verifies
    # one graph a sampling branch, of each set start() captured (a
    # speculative engine with brownout on: the verify and the decode set)
    sets = len(after["graph-sets"])
    if dispatches <= 0 or replays != dispatches or after["graph-captures-total"] != 3 * sets:
        raise AssertionError(f"{chunks} decode chunks and {verifies} verifies but {replays} "
                             f"graph replays, {after['graph-captures-total']} captures of "
                             f"{sets} sets")
    generated = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_s for r in results)
    spec = {}
    if after["speculation"]:
        spec = {
            "verify_dispatches": verifies,
            "spec_acceptance_rate": after["spec-acceptance-rate"],
            "spec_accepted_tokens_per_step": after["spec-accepted-tokens-per-step"],
            "spec_draft_hit_rate": after["spec-draft-hit-rate"],
            "spec_draft_tokens": after["spec-draft-tokens-total"]
            - before["spec-draft-tokens-total"],
            "spec_accepted_tokens": after["spec-accepted-tokens-total"]
            - before["spec-accepted-tokens-total"],
        }
    return {
        "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts],
        "generated_tokens": generated,
        "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "ttft_longest_prompt_s": max(zip(prompts, results), key=lambda pr: len(pr[0]))[1].ttft_s,
        "admit_groups": groups,
        "segments": segments,
        "decode_steps": steps,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kernel_launches": {k: v["launches"] for k, v in counts.items()},
        "finish_reasons": sorted({r.finish_reason for r in results}),
        "decode_chunks": chunks,
        "graph_replays": replays,
        "graph_captures": after["graph-captures-total"],
        "graph_capture_s": after["graph-capture-s"],
        "graph_pool_bytes": after["graph-pool-bytes"],
        **spec,
        **({"steady_replays": steady_replays} if steady else {}),
        **({"request_total_s": [r.total_s for r in results],
            "ttft_s": [r.ttft_s for r in results],
            "_tokens": [r.tokens for r in results]} if keep else {}),
    }


def _require_launches(run: dict, kernel: str, per_unit: str, layers: int) -> None:
    """The kernel ran on the run's path: one launch per layer per unit. The
    decode kernels run only inside the captured chunks, whose launches are
    counted per replay: theirs must be exactly layers x decode steps (a
    replay that went uncounted, or a capture counted as launches, fails).
    The prefill and segment kernels are held to the lower bound."""
    got = run["kernel_launches"][kernel]
    want = layers * run[per_unit]
    if "decode" in kernel:
        if got != want or got <= 0:
            raise AssertionError(f"{kernel}: {got} launches != {layers} x {per_unit} "
                                 f"{run[per_unit]}")
    elif got <= 0 or got < want:
        raise AssertionError(f"{kernel}: {got} launches < {layers} x {per_unit} {run[per_unit]}")


def _hold_logits(label: str, logits: dict) -> dict:
    """Kernel-path logits against reference-path logits, step by step:
    finite, within MODEL_REL_TOL of the largest reference logit, and the
    top-1 of each step (recorded)."""
    import torch

    out = {}
    for i, (a, b) in enumerate(zip(logits["kernel"], logits["reference"])):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} step {i}: non-finite kernel-path logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out[f"step{i}_rel_err"] = rel
        out[f"step{i}_top1_equal"] = bool(torch.argmax(a) == torch.argmax(b))
        if rel > MODEL_REL_TOL:
            raise AssertionError(f"{label} step {i}: rel err {rel} > {MODEL_REL_TOL}")
    out["tolerance"] = MODEL_REL_TOL
    return out


def _model_check(ctx, cfg, params, lora=None, adapter_row: int = 0) -> dict:
    """Kernel path vs reference attention path on the same weights: prefill
    logits of a 200-token prompt, then 4 paged decode steps over a pool
    filled by that prefill (``lora`` / ``adapter_row``: through that
    adapter of the pool)."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    prompt = [256] + [(37 * i + 11) % 250 for i in range(199)]
    tokens = torch.tensor([prompt], dtype=torch.long, device="cuda")
    lengths = torch.tensor([len(prompt)], device="cuda")
    s = tokens.shape[1]
    logits = {}
    pools = {}
    table = torch.arange(math.ceil((s + 8) / PAGE), dtype=torch.int32, device="cuda")[None]
    adapter = {} if lora is None else {
        "lora": lora, "adapter_rows": torch.tensor([adapter_row], device="cuda")}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        cache = tf.make_kv_cache(c, 1, s, device="cuda")
        lg, cache = tf.prefill(params, tokens, lengths, cache, c, **adapter)
        pool = tf.make_page_pool(c, table.shape[1], PAGE, device="cuda")
        tf.paged_insert_cache(pool, cache, table, PAGE)
        logits[name] = [lg.float()]
        pools[name] = pool
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([s + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.paged_decode_step_inplace(params, tok, pos, pools[name], table, c, PAGE,
                                                 **adapter)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits(f"model check {cfg.name}", logits)


def _llama_params(ctx):
    import torch

    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    if "params" not in ctx:
        cfg = MODEL_PRESETS["llama-3-8b"]
        g = torch.Generator(device="cuda").manual_seed(ctx["seed"])
        t0 = time.monotonic()
        ctx["params"] = init_params(cfg, g, device="cuda")
        torch.cuda.synchronize()
        log(f"llama-3-8b random weights on the card in {time.monotonic() - t0:.1f}s "
            f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    return ctx["params"]


# the depth the phases whose checks do not depend on it run at, to keep
# the default run inside its limit: replay against direct call and the
# lifecycle drills (``graphs``), the SPMD loopback pair and the world-1
# group (``spmd`` (a), (c)), ``tenancy``, ``agentic``, ``embed``,
# ``dense_tiers``, ``fleet``, ``spec``, ``ring``, ``tiered``, and the
# apps of ``rag``, ``remote``, ``python``, ``control`` and ``brokers``
# (pulsar, pravega). A phase whose engine also runs in a child process
# (``spmd`` (b), ``fleet_http``) serves the package's own
# ``llama-3-8b-shallow`` preset instead: a child knows no preset of this
# process
SHALLOW_LAYERS = 8
SHALLOW_MODEL = "llama-3-8b-8-layers"


def _shallow_model() -> str:
    """The name of llama-3-8b at ``SHALLOW_LAYERS`` layers as a model
    preset, registered in this process (a provider or an app's instance
    names it; each draws its tree from the seed)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    MODEL_PRESETS.setdefault(SHALLOW_MODEL, dataclasses.replace(
        MODEL_PRESETS["llama-3-8b"], name=SHALLOW_MODEL, n_layers=SHALLOW_LAYERS))
    return SHALLOW_MODEL


def _shallow(cfg, params) -> tuple:
    """llama-3-8b's full width at its first ``SHALLOW_LAYERS`` layers: the
    config and the same tree's layers sliced (views: nothing is copied)."""
    layers = SHALLOW_LAYERS
    tree = dict(params)
    tree["layers"] = {
        k: ({n: a[:layers] for n, a in v.items()} if isinstance(v, dict) else v[:layers])
        for k, v in params["layers"].items()
    }
    return dataclasses.replace(cfg, n_layers=layers), tree


def phase_e2e(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [20, 90, 150, 300, 600, 900, 1200, 1500], 64)
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    log(f"e2e llama-3-8b bf16 {json.dumps(run)}")
    ctx["e2e"] = run
    check = _model_check(ctx, cfg, params)
    log(f"model check llama-3-8b bf16 {json.dumps(check)}")


def phase_int8(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = dataclasses.replace(MODEL_PRESETS["llama-3-8b"], kv_cache_dtype="int8")
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [40, 300, 700, 1100], 32)
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode_int8", "decode_steps", cfg.n_layers)
    log(f"e2e llama-3-8b int8-kv {json.dumps(run)}")
    ctx["int8"] = run


def _dense_model_check(ctx, cfg, params) -> dict:
    """Kernel path vs reference attention path on the dense layout, same
    weights: a 3000-token prompt through 2 segments of 2048 (the engine's
    kv_bound rule: 2048, then 4096) into a 4096-column local cache, then 4
    decode steps over it."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    n, width, cols = 3000, 2048, 4096
    prompt = torch.tensor([[256] + [(37 * i + 11) % 250 for i in range(n - 1)]], device="cuda")
    logits = {}
    caches = {}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        cache = tf.make_kv_cache(c, 1, cols + 1, device="cuda")
        for s0, bound in ((0, width), (width, cols)):
            seg = torch.zeros((1, width), dtype=torch.long, device="cuda")
            real = min(width, n - s0)
            seg[0, :real] = prompt[0, s0 : s0 + real]
            lg, _ = tf.prefill_segment(
                params, seg, torch.tensor([s0], device="cuda"),
                torch.tensor([real], device="cuda"), cache, c, kv_bound=bound,
            )
        logits[name] = [lg.float()]
        caches[name] = cache
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([n + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.decode_step_inplace(params, tok, pos, caches[name], c, kv_bound=cols)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits("dense model check", logits)


DENSE_KW = {"kv_layout": "dense", "max_seq_len": 8192}
DENSE_BYTES = [20, 90, 300, 600, 1200, 1500, 3000, 7000]
DENSE_INT8_BYTES = [40, 300, 1100, 3000]


def phase_dense(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    prompts = [ByteTokenizer().encode(p) for p in _prompts(DENSE_BYTES, ctx["seed"])]
    run = _serve(ctx, cfg, params, [], 32, prompts=prompts, **DENSE_KW)
    # the segment loop's tokens and TTFT: the ring phase's reference
    ctx["dense_reference"] = {"prompts": prompts, "new": 32, "_tokens": run.pop("_tokens"),
                              "ttft_s": run["ttft_s"], "layers": cfg.n_layers}
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "dense_decode", "decode_steps", cfg.n_layers)
    log(f"dense llama-3-8b bf16 {json.dumps(run)}")
    ctx["dense"] = run
    check = _dense_model_check(ctx, cfg, params)
    log(f"dense model check llama-3-8b bf16 {json.dumps(check)}")


def phase_dense_int8(ctx: dict) -> None:
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(MODEL_PRESETS["llama-3-8b"], kv_cache_dtype="int8")
    params = _llama_params(ctx)
    prompts = [ByteTokenizer().encode(p) for p in _prompts(DENSE_INT8_BYTES, ctx["seed"])]
    run = _serve(ctx, cfg, params, [], 16, prompts=prompts, **DENSE_KW)
    ctx["dense_int8_reference"] = {"prompts": prompts, "new": 16, "_tokens": run.pop("_tokens"),
                                   "ttft_s": run["ttft_s"], "layers": cfg.n_layers}
    _require_launches(run, "flash_segment_int8", "segments", cfg.n_layers)
    _require_launches(run, "dense_decode_int8", "decode_steps", cfg.n_layers)
    log(f"dense llama-3-8b int8-kv {json.dumps(run)}")
    ctx["dense_int8"] = run


PAGED_LONG_KW = {"max_seq_len": 8192}


def _segment_tokens(torch, prompt, s0: int, width: int):
    """One segment of ``prompt`` [1, n] at ``s0``, padded to ``width`` → (tokens
    [1, width], its true length)."""
    seg = torch.zeros((1, width), dtype=torch.long, device="cuda")
    real = min(width, prompt.shape[1] - s0)
    seg[0, :real] = prompt[0, s0:s0 + real]
    return seg, real


def _long_prompt(torch, n: int):
    return torch.tensor([[256] + [(37 * i + 11) % 250 for i in range(n - 1)]], device="cuda")


def _paged_model_check(ctx, cfg, params) -> dict:
    """Kernel path vs reference attention path on the paged layout, same
    weights: a 3000-token prompt through 2 ``paged_prefill_segment_inplace``
    calls of 2048 straight into its 47 pages (the engine's kv_bound rule:
    2048, then 4096), then 4 paged decode steps through the same table."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    n, width = 3000, 2048
    prompt = _long_prompt(torch, n)
    table = torch.arange(math.ceil((n + 4) / PAGE), dtype=torch.int32, device="cuda")[None]
    logits, pools = {}, {}
    for name, c in (("kernel", cfg), ("reference", ref_cfg)):
        pool = tf.make_page_pool(c, table.shape[1], PAGE, device="cuda")
        for s0 in (0, width):
            seg, real = _segment_tokens(torch, prompt, s0, width)
            lg, _ = tf.paged_prefill_segment_inplace(
                params, seg, torch.tensor([s0], device="cuda"), torch.tensor([real], device="cuda"),
                pool, table, c, PAGE, kv_bound=s0 + width,
            )
        logits[name] = [lg.float()]
        pools[name] = pool
    # both paths decode the SAME token chain (the reference path's greedy)
    tok = torch.argmax(logits["reference"][0], dim=-1)
    for step in range(4):
        pos = torch.tensor([n + step], device="cuda")
        for name, c in (("kernel", cfg), ("reference", ref_cfg)):
            lg, _ = tf.paged_decode_step_inplace(params, tok, pos, pools[name], table, c, PAGE)
            logits[name].append(lg.float())
        tok = torch.argmax(logits["reference"][-1], dim=-1)
    return _hold_logits("paged model check", logits)


def _paged_nan_check(ctx, cfg, params) -> dict:
    """NaN written into the slot's pages past a segment's frontier — the
    rest of the frontier's page and every later page of its 8192-token
    table — and into the pool's sink page leaves the kernel path's segment
    logits bit-equal: the 2048-token segment at offset 1000 (a mid-page
    frontier, 3048) gathers only its first 48 pages and reads them through
    a [..., :3048] view."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    width, s0 = 2048, 1000
    frontier = s0 + width
    pages = 8192 // PAGE
    table = torch.arange(pages, dtype=torch.int32, device="cuda")[None]
    pool = tf.make_page_pool(cfg, pages, PAGE, device="cuda")
    prompt = _long_prompt(torch, frontier)
    seg, real = _segment_tokens(torch, prompt[:, :s0], 0, width)  # the prefix [0, 1000)
    tf.paged_prefill_segment_inplace(
        params, seg, torch.tensor([0], device="cuda"), torch.tensor([real], device="cuda"),
        pool, table, cfg, PAGE, kv_bound=width,
    )
    seg, real = _segment_tokens(torch, prompt, s0, width)

    def segment():
        return tf.paged_prefill_segment_inplace(
            params, seg, torch.tensor([s0], device="cuda"), torch.tensor([real], device="cuda"),
            pool, table, cfg, PAGE, kv_bound=frontier,
        )[0]

    clean = segment()
    page, row = divmod(frontier, PAGE)
    for name in ("k", "v"):
        pool[name][:, page, :, row:] = float("nan")
        pool[name][:, page + 1:] = float("nan")  # later pages and the sink
    planted = segment()
    same = bool(torch.equal(clean, planted)) and bool(torch.isfinite(clean).all())
    if not same:
        raise AssertionError("NaN past the paged segment's frontier changed its logits")
    return {"frontier": frontier, "pages_gathered": math.ceil(frontier / PAGE),
            "table_pages": pages, "bit_equal": same}


def _gather_cost(torch, ctx, timer) -> dict:
    """The page gather of the 2048-token segment at offset 6144 (one layer,
    128 pages of 64 through a shuffled table, bf16 and int8 pages) beside
    the segment kernel over what it gathered: ms, the gather's byte bound
    and its share of the two; and, as a yardstick, the same gather by
    PyTorch advanced indexing (``pool[pages, heads]``)."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import (
        flash_segment_attention,
        flash_segment_attention_int8,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    s, off = 2048, 6144
    n_pages = (off + s) // PAGE
    rng = random.Random(ctx["seed"] + 51)
    perm = list(range(n_pages))
    rng.shuffle(perm)
    pages = torch.tensor([perm], dtype=torch.long, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 53)
    q = torch.randn((1, s, H, D), generator=g, device="cuda").to(torch.bfloat16)
    offset = torch.tensor([off], dtype=torch.int32, device="cuda")
    out = {}
    for int8 in (False, True):
        shape = (n_pages + 1, HKV, PAGE, D)
        k, v = _pool_entry(torch, g, shape, int8), _pool_entry(torch, g, shape, int8)
        rows = tf._page_rows(pages, HKV)
        kg, vg = tf._gather_pages(k, rows, 1), tf._gather_pages(v, rows, 1)
        hidx = torch.arange(HKV, device="cuda")[None, :, None]
        indexed = {n: a[pages[:, None, :], hidx].flatten(2, 3) for n, a in
                   (k.items() if int8 else (("k", k),))}
        got = kg if int8 else {"k": kg}
        if not all(torch.equal(got[n], indexed[n]) for n in indexed):
            raise AssertionError("the page gather differs from advanced indexing")
        kernel = flash_segment_attention_int8 if int8 else flash_segment_attention
        item = 1 if int8 else 2
        row = HKV * D * item + (HKV * 4 if int8 else 0)  # a token's K (or V) bytes
        nbytes = 2 * 2 * (off + s) * row  # K and V read once, written once

        def by_indexing():
            return [tf._map(lambda a: a[pages[:, None, :], hidx], e) for e in (k, v)]

        rec = {
            "gather_ms": timer.ms(lambda: (tf._gather_pages(k, rows, 1),
                                           tf._gather_pages(v, rows, 1))),
            "gather_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "indexing_ms": timer.ms(by_indexing),
            "segment_ms": timer.ms(lambda: kernel(q, kg, vg, offset, cfg)),
        }
        rec["gather_share"] = rec["gather_ms"] / (rec["gather_ms"] + rec["segment_ms"])
        out["int8" if int8 else "bf16"] = rec
        del k, v, kg, vg
    return out


def phase_paged_long(ctx: dict) -> None:
    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    run = _serve(ctx, cfg, params, [20, 90, 300, 600, 1200, 1500, 3000, 7000], 32, **PAGED_LONG_KW)
    if run["segments"] != 2 + 4:
        raise AssertionError(f"paged_long: {run['segments']} segments, expected 6")
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    if run["kernel_launches"]["dense_decode"]:
        raise AssertionError("paged_long: the dense decode kernel ran on the paged layout")
    log(f"paged_long llama-3-8b bf16 {json.dumps(run)}")
    ctx["paged_long"] = run
    int8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    run8 = _serve(ctx, int8_cfg, params, [40, 300, 1100, 3000], 16, **PAGED_LONG_KW)
    _require_launches(run8, "flash_segment_int8", "segments", cfg.n_layers)
    _require_launches(run8, "paged_decode_int8", "decode_steps", cfg.n_layers)
    log(f"paged_long llama-3-8b int8-kv {json.dumps(run8)}")
    ctx["paged_long_int8"] = run8
    log(f"paged model check llama-3-8b bf16 {json.dumps(_paged_model_check(ctx, cfg, params))}")
    log(f"paged segment nan past the frontier {json.dumps(_paged_nan_check(ctx, cfg, params))}")
    timer = Timer(torch)
    log(f"paged segment gather S=2048 offset=6144 {json.dumps(_gather_cost(torch, ctx, timer))}")
    del timer


# the graphs phase's paged engines: a 2048-token sequence limit keeps the
# pool (and its copies) small; the dense engine is the dense phase's 8192
GRAPHS_KW = {"max_seq_len": 2048}


def _decode_state(engine) -> list:
    """Every tensor a decode chunk (with speculation: a verify) reads or
    writes: the KV pool or cache, the chain, the sampling params, the
    dispatch table (and the drafts), the agentic tier's per-slot rows and
    DFA states, and the output, last."""
    tree = engine._pagepool.dev if engine._paged else engine._cache
    leaves = [leaf for e in tree.values() for leaf in (e.values() if isinstance(e, dict) else (e,))]
    out = engine._verify_out if engine._spec_enabled else engine._chunk_out
    chain = (engine._tokens_dev, engine._positions_dev, engine._temp_dev, engine._top_k_dev,
             engine._top_p_dev, engine._table_dev, engine._drafts_dev, engine._arows_dev,
             engine._g_rows_dev, engine._dfa_state_dev, engine._vstates_dev, out)
    return leaves + [t for t in chain if t is not None]


def _snapshot(engine) -> tuple:
    memo = engine._table_uploaded
    return [t.clone() for t in _decode_state(engine)], None if memo is None else memo.copy()


def _restore(engine, snap: tuple) -> None:
    tensors, memo = snap
    for dst, src in zip(_decode_state(engine), tensors):
        dst.copy_(src)
    engine._table_uploaded = None if memo is None else memo.copy()


def _differs(engine, snap: tuple) -> dict:
    """Which of the live decode state's tensors differ from a snapshot's
    (bit for bit): {"tokens": the output, "state": anything else}."""
    import torch

    live = _decode_state(engine)
    out_differs = not torch.equal(live[-1], snap[0][-1])
    rest = sum(int(not torch.equal(a, b)) for a, b in zip(live[:-1], snap[0][:-1]))
    return {"tokens": out_differs, "state": rest}


def _hand_admit(engine, prompts, opts) -> None:
    """Admit ``prompts`` through the engine's own admission, driven from
    this thread (the engine thread is not running), first tokens read."""
    from langstream_tpu_torch.serving.engine import GenerationRequest

    for prompt in prompts:
        engine.submit(GenerationRequest(prompt_tokens=prompt, options=opts))
    for entry in engine._admit(10**9):
        engine._process_entry(entry)


def _replay_check(ctx, cfg, params, plant: bool, **engine_kw) -> dict:
    """One captured chunk against a direct call of the same chunk function
    on a copy of the same state, hand-driven at full width: 7 requests
    admitted, one chunk dispatched, an 8th admitted (its slot's table row
    changes), then the chunk replayed and, from the same state, called
    directly — the tokens must be equal and the pool or cache bit-equal.
    With ``plant`` (the paged layout), a replay whose dispatch table was
    not refreshed after that admission must differ, or the check cannot
    see a stale table; and two replays of the sampled branch from one
    state must draw different tokens (the generator advances per
    replay)."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = ServingEngine(cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
                           rng_seed=ctx["seed"], device="cuda", **engine_kw)
    engine._capture_graphs()
    prompts = [tok.encode(p) for p in _prompts([20, 90, 150, 300, 600, 900, 1200, 1500],
                                               ctx["seed"] + 7)]
    opts = GenerationOptions(max_new_tokens=64)
    rec: dict = {}
    with torch.no_grad():
        _hand_admit(engine, prompts[:7], opts)
        engine._process_entry(engine._dispatch_chunk())
        _hand_admit(engine, prompts[7:], opts)
        branch = engine._branch()
        if plant:
            pre = _snapshot(engine)
            engine._run_chunk(branch)  # the table still masks the 8th slot's row
            stale = _snapshot(engine)
            _restore(engine, pre)
            del pre
        engine._prepare_chunk()
        prepared = _snapshot(engine)
        engine._run_chunk(branch)
        replayed = _snapshot(engine)
        _restore(engine, prepared)
        del prepared
        engine._decode_chunk(*branch)
        torch.cuda.synchronize()
        rec["replay_vs_direct"] = _differs(engine, replayed)
        if plant:
            rec["stale_table_vs_direct"] = _differs(engine, stale)
            del stale
        del replayed
        if plant:
            # the sampled branch twice from one state: the generator is
            # registered with the graph, so the second replay draws anew
            engine._temp_dev.fill_(1.0)
            state = _snapshot(engine)
            engine._run_chunk((True, False))
            first = engine._chunk_out.clone()
            _restore(engine, state)
            del state
            engine._run_chunk((True, False))
            rec["sampled_replays_differ"] = not torch.equal(first, engine._chunk_out)
    stats = engine.stats()
    rec.update({
        "graph_captures": stats["graph-captures-total"],
        "graph_capture_s": stats["graph-capture-s"],
        "graph_pool_bytes": stats["graph-pool-bytes"],
        "active_slots": stats["active-slots"],
    })
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if rec["replay_vs_direct"] != {"tokens": False, "state": 0}:
        raise AssertionError(f"replay differs from the direct call: {rec['replay_vs_direct']}")
    if plant and not (rec["stale_table_vs_direct"]["tokens"]
                      or rec["stale_table_vs_direct"]["state"]):
        raise AssertionError("a replay with a stale dispatch table was not caught")
    if plant and not rec["sampled_replays_differ"]:
        raise AssertionError("two replays of the sampled chunk drew the same numbers")
    return rec


def _first_token(engine, prompt, max_new: int):
    """Submit and wait for the first token (the request is then in a slot)."""
    import threading

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest

    got = threading.Event()
    req = GenerationRequest(prompt_tokens=prompt, options=GenerationOptions(max_new_tokens=max_new),
                            on_token=lambda _t: got.set())
    engine.submit(req)
    if not got.wait(600):
        raise AssertionError("first token never arrived")
    return req


def _decode_fault_drill(ctx, cfg, params) -> dict:
    """``decode@3`` on a one-slot paged engine: the request in flight fails
    with the injected fault, the engine restarts (device state rebuilt,
    the three graphs captured again), and the request queued behind it is
    served token-exact against a fault-free engine."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    p1, p2 = (tok.encode(p) for p in _prompts([300, 120], ctx["seed"] + 9))
    kw = dict(max_batch=1, decode_chunk=16, page_size=PAGE, rng_seed=ctx["seed"],
              device="cuda", **GRAPHS_KW)
    opts = GenerationOptions(max_new_tokens=32)
    ref_engine = ServingEngine(cfg, params, **kw)
    ref_engine.start()
    try:
        ref = ref_engine.generate(p2, opts, timeout=600).tokens
    finally:
        ref_engine.stop()
    engine = ServingEngine(cfg, params, fault_injector=FaultInjector("decode@3", seed=0),
                           restart_backoff_s=0.05, **kw)
    t0 = time.monotonic()
    engine.start()
    try:
        r1 = _first_token(engine, p1, 400)
        r2 = engine.submit(GenerationRequest(prompt_tokens=p2, options=opts))
        try:
            r1.result(timeout=600)
            raise AssertionError("decode@3 did not fail the request in flight")
        except InjectedFault:
            pass
        tokens = r2.result(timeout=600).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    rec = {
        "restarts": stats["engine-restarts-total"],
        "graph_captures": stats["graph-captures-total"],
        "graph_capture_s": stats["graph-capture-s"],
        "quarantined": stats["quarantined-slots-total"],
        "survivor_tokens": len(tokens),
        "survivor_token_exact": tokens == ref,
        "wall_s": time.monotonic() - t0,
    }
    if rec["restarts"] != 1 or rec["graph_captures"] != 6 or not rec["survivor_token_exact"]:
        raise AssertionError(f"decode fault drill: {rec}")
    return rec


def _nan_drill(ctx, cfg, params) -> dict:
    """``nan@3`` on a two-slot paged engine: one slot fails with
    LogitsNaNError, its pages (recorded as the quarantine frees them) read
    back as zeros once the next iteration zeroed them, and the survivor is
    token-exact against the same two requests on a fault-free engine."""
    import torch

    from langstream_tpu_torch.serving.engine import LogitsNaNError, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts([200, 90], ctx["seed"] + 11)]
    kw = dict(max_batch=2, decode_chunk=16, page_size=PAGE, rng_seed=ctx["seed"],
              device="cuda", **GRAPHS_KW)
    outcomes = {}
    for label, injector in (("reference", None), ("fault", FaultInjector("nan@3", seed=0))):
        engine = ServingEngine(cfg, params, fault_injector=injector, **kw)
        freed: dict = {}
        keep = engine._quarantine_pages

        def recording(idx, engine=engine, keep=keep, freed=freed):
            freed[idx] = engine._pagepool.slot_pages(idx)
            keep(idx)

        engine._quarantine_pages = recording
        engine.start()
        try:
            reqs = [_first_token(engine, p, 48) for p in prompts]
            got = []
            for r in reqs:
                try:
                    got.append(r.result(timeout=600).tokens)
                except LogitsNaNError:
                    got.append(None)
            deadline = time.monotonic() + 60
            while engine._pending_page_zero and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            leaves = [leaf for e in engine._pagepool.dev.values()
                      for leaf in (e.values() if isinstance(e, dict) else (e,))]
            pages = sorted(p for ps in freed.values() for p in ps)
            zero = bool(pages) and all(
                bool((leaf[:, torch.tensor(pages, device="cuda")] == 0).all()) for leaf in leaves
            )
            stats = engine.stats()
        finally:
            engine.stop()
            del engine._quarantine_pages  # the recorder holds the engine
        outcomes[label] = {"tokens": got, "pages": pages, "zero": zero, "stats": stats}
    ref, fault = outcomes["reference"], outcomes["fault"]
    victims = [i for i, t in enumerate(fault["tokens"]) if t is None]
    rec = {
        "victims": victims,
        "quarantined_pages": len(fault["pages"]),
        "pages_zero": fault["zero"],
        "nan_guard_total": fault["stats"]["nan-guard-total"],
        "survivors_token_exact": all(
            t == r for t, r in zip(fault["tokens"], ref["tokens"]) if t is not None
        ),
        "pages_in_use_after": fault["stats"]["kv-pages-in-use"],
    }
    if (len(victims) != 1 or not rec["pages_zero"] or not rec["survivors_token_exact"]
            or rec["nan_guard_total"] != 1 or rec["pages_in_use_after"] != 0):
        raise AssertionError(f"nan drill: {rec}")
    return rec


def phase_graphs(ctx: dict) -> None:
    """Replay against direct call at full width and ``SHALLOW_LAYERS``
    depth (paged bf16 and int8 with a planted stale table, dense bf16 at
    8192), then the lifecycle drills on the card (a decode fault's restart
    and re-capture, a NaN quarantine)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    int8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    for label, c, kw, plant in (("paged bf16", cfg, GRAPHS_KW, True),
                                ("paged int8", int8_cfg, GRAPHS_KW, True),
                                ("dense bf16", cfg, DENSE_KW, False)):
        log(f"graphs replay {label} {json.dumps(_replay_check(ctx, c, params, plant, **kw))}")
    log(f"graphs drill decode@3 {json.dumps(_decode_fault_drill(ctx, cfg, params))}")
    log(f"graphs drill nan@3 {json.dumps(_nan_drill(ctx, cfg, params))}")


# the prefix phase: a 1024-token shared preamble (16 pages of 64) and the
# turns of the 8 requests that share it; the copy-on-write pass publishes at
# a 1000 bucket (15 whole pages and one partial page)
PREFIX_PREAMBLE, PREFIX_FIRST_TURN = 1024, 40
PREFIX_TURNS = (20, 34, 48, 62, 77, 91, 105, 120)
PREFIX_NEW = 32
PREFIX_KW = {"max_seq_len": 2048}
COW_BUCKETS = (32, 64, 128, 256, 512, 1000, 2048)


def _prefix_prompts(seed: int) -> tuple[list[int], list[list[int]]]:
    """(request 0: the preamble plus a 40-token turn, the 8 requests: the
    preamble plus turns of 20..120 tokens), byte tokens from ``seed``."""
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    texts = _prompts([PREFIX_PREAMBLE, PREFIX_FIRST_TURN, *PREFIX_TURNS], seed + 1)
    preamble = tok.encode(texts[0])[:PREFIX_PREAMBLE]
    turns = [list(texts[i].encode()) for i in range(1, len(texts))]
    return preamble + turns[0], [preamble + t for t in turns[1:]]


def _capture_first_logits(engine) -> dict:
    """Keep a device copy of every admission's first-token logits, keyed by
    prompt length (the phase's prompt lengths are distinct): wraps the
    engine's chain seeding, which every admission path calls once."""
    seen: dict = {}
    seed_chain = engine._seed_chain

    def capture(logits, slots, lengths, *rest):
        for j, n in enumerate(lengths):
            seen[int(n)] = logits[j].float().clone()
        return seed_chain(logits, slots, lengths, *rest)

    engine._seed_chain = capture
    return seen


def _time_calls(engine, name: str) -> list:
    """Wrap one of the engine's methods to record each call's host wall
    (start and end, ``time.monotonic``): how long the engine thread spends
    dispatching it."""
    spans: list = []
    method = getattr(engine, name)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return method(*args, **kwargs)
        finally:
            spans.append((t0, time.monotonic()))

    setattr(engine, name, timed)
    return spans


def _serve_prefix(ctx, cfg, params, prefix: bool, **engine_kw) -> dict:
    """The prefix traffic on one engine: a short warm-up (below every
    publish boundary), every count set to 0, then request 0 alone (cold; it
    publishes the preamble), then the 8 requests together (warm suffix
    segments when reuse is on), counts read just after. Checks every
    request's tokens, that no plain version ran, and the replays; polls the
    pool's pages in use for its peak."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    first, batch = _prefix_prompts(ctx["seed"])
    engine = ServingEngine(
        cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
        eos_token_id=tok.eos_token_id, rng_seed=ctx["seed"], device="cuda",
        prefix_cache="auto" if prefix else "off", **{**PREFIX_KW, **engine_kw},
    )
    logits = _capture_first_logits(engine)
    warm_spans = _time_calls(
        engine, "_paged_prefill_prefix" if engine._paged else "_dense_prefill_prefix")
    group_spans = _time_calls(engine, "_prefill_group")
    pool = engine._pagepool  # None on the dense layout: no pages to poll
    engine.start()
    try:
        engine.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
        torch.cuda.synchronize()
        before = engine.stats()
        opts = GenerationOptions(max_new_tokens=PREFIX_NEW, temperature=0.0)
        reset_kernel_counts()
        cold = engine.generate(first, opts, timeout=600)
        mid = engine.stats()
        t0 = time.monotonic()
        del warm_spans[:], group_spans[:]
        reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in batch]
        peak = pool.pages_in_use if pool else None
        while not all(r._done.is_set() for r in reqs):
            if pool:
                peak = max(peak, pool.pages_in_use)
            time.sleep(0.001)
        results = [r.result(timeout=900) for r in reqs]
        wall = time.monotonic() - t0
        counts = kernel_counts()
        after = engine.stats()
    finally:
        engine.stop()
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"plain versions ran on the card's prefix path: {plain}")
    for p, r in zip([first, *batch], [cold, *results]):
        if r.error is not None or r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request of {len(p)} tokens ended {r.finish_reason}: {r.error}")
        if any(t < 0 or t >= cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request of {len(p)} tokens has out-of-range tokens")

    def delta(key):
        return after[key] - before[key]

    chunks, replays = delta("decode-chunks-total"), delta("graph-replays-total")
    if chunks <= 0 or replays != chunks or after["graph-captures-total"] != 3:
        raise AssertionError(f"{chunks} decode chunks but {replays} graph replays, "
                             f"{after['graph-captures-total']} captures")
    ttfts = sorted(r.ttft_s for r in results)
    generated = sum(len(r.tokens) for r in [cold, *results])
    spans = sorted(warm_spans + group_spans)
    dispatch_ms = [(b - a) * 1e3 for a, b in spans]
    return {
        "prefix_cache": prefix,
        "prompt_tokens": [len(first)] + [len(p) for p in batch],
        "cold_ttft_s": cold.ttft_s,
        "warm_ttft_p50_s": ttfts[len(ttfts) // 2],
        "warm_ttft_max_s": ttfts[-1],
        "batch_wall_s": wall,
        "tokens_per_s": sum(len(r.tokens) for r in results) / wall,
        "generated_tokens": generated,
        "hit_rate": after["prefix-cache-hit-rate"],
        "prefill_tokens": delta("prefill-tokens-total"),
        "prefill_tokens_saved": delta("prefill-tokens-saved-total"),
        "alias_rate": after["kv-page-alias-rate"],
        "page_copies": delta("page-copies-total"),
        "copy_bytes_saved": delta("prefix-copy-bytes-saved-total"),
        "pages_in_use_after_first": mid.get("kv-pages-in-use"),
        "peak_kv_pages_in_use": peak,
        "prefix_entries": after["prefix-cache-entries"],
        "prefix_pool_bytes": after["prefix-pool-bytes-in-use"],
        # the dense pool's rows as allocated, beside the plan's term
        "prefix_pool_allocated_bytes": (
            sum(t.numel() * t.element_size() for t in _param_leaves(engine._prefix_pool.dev))
            if engine._prefix_pool else 0),
        "plan_prefix_pool_bytes": engine.memory_plan.prefix_pool_bytes,
        "admit_groups": delta("admit-groups-total"),
        "warm_admissions": delta("warm-admissions-total"),
        # the wave's admissions on the engine thread: host ms each (warm
        # admissions or cold groups), and from the wave's submit to the
        # first's start and the last's end
        "admission_host_ms": dispatch_ms,
        "admissions_start_end_s": [spans[0][0] - t0, spans[-1][1] - t0] if spans else None,
        "decode_steps": delta("decode-steps-total"),
        "decode_chunks": chunks,
        "graph_replays": replays,
        "kernel_launches": {k: v["launches"] for k, v in counts.items()},
        "_logits": logits,
        "_tokens": [r.tokens for r in results],
    }


def _require_prefix_run(run: dict, cfg, copies_per_hit: int) -> None:
    """Every one of the 8 requests a warm hit at the preamble: one suffix
    segment (one segment launch a layer) each and ``copies_per_hit`` page
    copies each; request 0 alone took the cold group's prefill kernel;
    decode launches exactly layers x steps."""
    hits = len(PREFIX_TURNS)
    if run["warm_admissions"] != hits or run["page_copies"] != copies_per_hit * hits:
        raise AssertionError(f"prefix: {run['warm_admissions']} warm admissions and "
                             f"{run['page_copies']} page copies, expected {hits} and "
                             f"{copies_per_hit * hits}")
    segments = run["kernel_launches"]["flash_segment"]
    if segments != cfg.n_layers * hits:
        raise AssertionError(f"prefix: {segments} segment launches != {cfg.n_layers} x {hits}")
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)


def _warm_vs_cold(warm: dict, cold: dict, lengths: list[int]) -> dict:
    """The warm admissions' first-token logits against the same prompts'
    cold admissions on the reuse-off engine (same weights): within
    MODEL_REL_TOL of the largest cold logit, top-1 equal."""
    import torch

    out = {}
    for n in lengths:
        a, b = warm[n], cold[n]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"warm logits of the {n}-token prompt are not finite")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        top1 = bool(torch.argmax(a) == torch.argmax(b))
        out[f"len{n}"] = {"rel_err": rel, "top1_equal": top1}
        if rel > MODEL_REL_TOL or not top1:
            raise AssertionError(f"warm vs cold logits of the {n}-token prompt: rel err {rel} "
                                 f"(tolerance {MODEL_REL_TOL}), top-1 equal {top1}")
    out["tolerance"] = MODEL_REL_TOL
    return out


def _prefix_nan_check(ctx, cfg, params, timer) -> dict:
    """A publisher's 1064-token prompt prefilled into pages 0..16; a reader
    of 1024 tokens that shares its first 1000 aliases pages 0..14, copies
    page 15 (copy-on-write) into page 17 and runs its 24-token suffix as one
    32-wide segment at offset 1000 (pad positions past 1024 land in the
    sink). NaN planted in page 15's columns at and past 1000 and in the
    sink page, before the copy, must leave the suffix logits bit-equal.
    Also times the warm admission (copy + suffix segment) beside a cold
    prefill of the reader's whole prompt and one stream of the weights."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    p, width = 1000, 32
    publisher = _long_prompt(torch, 1064)
    reader = torch.cat([publisher[:, :p], _long_prompt(torch, 25)[:, 1:]], dim=1)  # 1024
    pool = tf.make_page_pool(cfg, 18, PAGE, device="cuda")
    sink = 18
    pub_table = torch.full((1, 32), sink, dtype=torch.int32, device="cuda")
    pub_table[0, :17] = torch.arange(17, dtype=torch.int32, device="cuda")
    seg, real = _segment_tokens(torch, publisher, 0, 2048)
    tf.paged_prefill_segment_inplace(
        params, seg, torch.tensor([0], device="cuda"), torch.tensor([real], device="cuda"),
        pool, pub_table, cfg, PAGE, kv_bound=2048,
    )
    table = torch.full((1, 32), sink, dtype=torch.int32, device="cuda")
    table[0, :15] = torch.arange(15, dtype=torch.int32, device="cuda")
    table[0, 15] = 17
    suffix, real = _segment_tokens(torch, reader, p, width)
    offsets = torch.tensor([p], device="cuda")
    seg_len = torch.tensor([real], device="cuda")

    def warm():
        tf.page_copy(pool, 15, 17)
        return tf.paged_prefill_segment_inplace(
            params, suffix, offsets, seg_len, pool, table, cfg, PAGE, kv_bound=p + width,
        )[0]

    clean = warm()
    saved = {name: pool[name][:, 15].clone() for name in ("k", "v")}
    for name in ("k", "v"):
        pool[name][:, 15, :, p % PAGE:] = float("nan")
        pool[name][:, sink] = float("nan")
    planted = warm()
    same = bool(torch.equal(clean, planted)) and bool(torch.isfinite(clean).all())
    if not same:
        raise AssertionError("NaN past the copy-on-write frontier or in the sink changed the "
                             "warm suffix logits")
    for name in ("k", "v"):
        pool[name][:, 15] = saved[name]
    # the default spin hides 3 ms of enqueue: a longer one hides the eager
    # dispatch of 32 layers too, so these read device time
    timer.SPIN_CYCLES = 160_000_000
    warm_ms = timer.ms(warm, iters=10)
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    cold_cache = tf.make_kv_cache(cfg, 1, 1024, device="cuda")
    lengths = torch.tensor([reader.shape[1]], device="cuda")
    cold_ms = timer.ms(lambda: tf.prefill(params, reader, lengths, cold_cache, cfg), iters=5)
    del timer.SPIN_CYCLES
    weight_bytes = sum(t.numel() * t.element_size() for t in _param_leaves(params))
    return {"p": p, "suffix": real, "width": width, "bit_equal": same,
            "warm_admission_ms": warm_ms, "warm_admission_host_ms": sorted(host_ms)[2],
            "cold_prefill_1024_ms": cold_ms,
            "weight_bytes": weight_bytes,
            "weight_stream_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}


def _param_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _param_leaves(v)]
    return [tree]


def phase_prefix(ctx: dict) -> None:
    """Prefix KV reuse at llama-3-8b's full width and depth (bf16, paged,
    page 64, max-batch 8): the preamble traffic with reuse on (16 aliased
    pages a hit, no copy), the same traffic with reuse off (the pages and
    TTFT it costs, and the cold logits the warm ones are held against),
    and a copy-on-write pass (a 1000 bucket: 15 aliased pages and one
    copied page a hit); then the planted-NaN check and the warm
    admission's time."""
    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    warm = _serve_prefix(ctx, cfg, params, prefix=True)
    _require_prefix_run(warm, cfg, copies_per_hit=0)
    off = _serve_prefix(ctx, cfg, params, prefix=False)
    _require_launches(off, "paged_decode", "decode_steps", cfg.n_layers)
    cow = _serve_prefix(ctx, cfg, params, prefix=True, prefill_buckets=COW_BUCKETS)
    _require_prefix_run(cow, cfg, copies_per_hit=1)
    held = [warm["prompt_tokens"][1], warm["prompt_tokens"][-1]]  # shortest, longest turn
    check = _warm_vs_cold(warm["_logits"], off["_logits"], held)
    check_cow = _warm_vs_cold(cow["_logits"], off["_logits"], held)
    agree = {
        label: [sum(a == b for a, b in zip(x, y)) / len(y) for x, y in zip(run["_tokens"],
                                                                           off["_tokens"])]
        for label, run in (("alias", warm), ("cow", cow))
    }
    for label, run in (("alias", warm), ("off", off), ("cow", cow)):
        log(f"prefix {label} llama-3-8b bf16 "
            f"{json.dumps({k: v for k, v in run.items() if not k.startswith('_')})}")
    log(f"prefix pages in use: reuse on {warm['peak_kv_pages_in_use']}, "
        f"off {off['peak_kv_pages_in_use']}")
    log(f"prefix warm vs cold logits alias {json.dumps(check)} cow {json.dumps(check_cow)}")
    log(f"prefix greedy-token agreement with the cold run (printed, not required) "
        f"{json.dumps(agree)}")
    timer = Timer(torch)
    nan_check = _prefix_nan_check(ctx, cfg, params, timer)
    log(f"prefix copy-on-write nan check {json.dumps(nan_check)}")
    del timer
    ctx["prefix"] = {k: v for k, v in warm.items() if not k.startswith("_")}


SPEC_KW = {"max_seq_len": 2048, "speculation_tokens": 4}
SPEC_PROMPT = 400
SPEC_NEW = 64


def _spec_prompts(seed: int) -> list[list[int]]:
    """8 prompts of SPEC_PROMPT byte tokens (BOS first): 4 built to repeat —
    a 24-byte span cycled — and 4 plain random text."""
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    texts = _prompts([24] * 4 + [SPEC_PROMPT] * 4, seed + 3)
    repeated = [tok.encode(t * (SPEC_PROMPT // 24 + 1))[:SPEC_PROMPT] for t in texts[:4]]
    return repeated + [tok.encode(t)[:SPEC_PROMPT] for t in texts[4:]]


def _first_divergence(ctx, cfg, params, prompt, a: list, b: list, lora=None,
                      adapter_row: int = 0):
    """The first generated position where two greedy runs differ, with the
    top-2 logits there on the kernel path (a prefill of the prompt and the
    tokens both runs share; ``lora`` / ``adapter_row``: through that
    adapter): a small margin is a near-tie that rounding of another GEMM
    shape can flip. None when the runs agree."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return None
    context = torch.tensor([prompt + a[:i]], dtype=torch.long, device="cuda")
    n = context.shape[1]
    cache = tf.make_kv_cache(cfg, 1, n, device="cuda")
    rows = torch.tensor([adapter_row], device="cuda") if lora is not None else None
    logits, _ = tf.prefill(params, context, torch.tensor([n], device="cuda"), cache, cfg,
                           lora=lora, adapter_rows=rows)
    row = logits[0].float()
    top = torch.topk(row, 2)
    chosen = [a[i], b[i]]
    return {"position": i, "spec": a[i], "off": b[i], "top2": top.indices.tolist(),
            "top2_values": top.values.tolist(),
            "chosen_values": row[chosen].tolist(),
            "chosen_ranks": [int((row > row[t]).sum()) for t in chosen],
            "margin": (top.values[0] - top.values[1]).item(),
            "margin_rel": ((top.values[0] - top.values[1]) / logits[0].abs().max()).item()}


def _verify_replay_check(ctx, cfg, params, prompts) -> dict:
    """One captured verify against a direct call of ``_verify_chunk`` on a
    copy of the same state, hand-driven at full width: the 8 prompts
    admitted through the engine's own admission, drafts proposed from their
    indexes, then the greedy verify replayed and, from the same state,
    called directly — the output and the pool must be bit-equal."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=8, page_size=PAGE, rng_seed=ctx["seed"],
                           device="cuda", speculation="auto", **SPEC_KW)
    engine._capture_graphs()
    with torch.no_grad():
        _hand_admit(engine, prompts, GenerationOptions(max_new_tokens=SPEC_NEW))
        # a few verifies first, so the indexes hold cycles to propose from
        for _ in range(6):
            engine._process_entry(engine._dispatch_verify())
        _, proposed = engine._propose_drafts()
        branch = engine._branch()
        engine._prepare_chunk()
        prepared = _snapshot(engine)
        engine._run_chunk(branch)
        replayed = _snapshot(engine)
        _restore(engine, prepared)
        del prepared
        engine._verify_chunk(*branch)
        torch.cuda.synchronize()
        rec = {"replay_vs_direct": _differs(engine, replayed),
               "proposed": proposed.tolist(),
               "accepted": engine._verify_out[:, -1].tolist()}
        del replayed
    rec["graph_captures"] = engine.stats()["graph-captures-total"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if rec["replay_vs_direct"] != {"tokens": False, "state": 0}:
        raise AssertionError(f"verify replay differs from the direct call: {rec}")
    return rec


def _verify_reference_check(ctx, cfg, params, prompts) -> dict:
    """The kernel path's verify against the reference path's on the same
    pool: the prompts' K/V prefilled (kernel path) into their pages, one
    copy for each path; then one verify of each row's last prompt token and
    the 4 tokens the prompt's own repetition continues with, at the row's
    length — logits within MODEL_REL_TOL of the largest reference logit,
    and top-1 equal at every one of the k+1 positions of every row. A
    position whose top-1 differs passes only as a tie that both paths see
    in the logits they emit (bf16 out of the head): the reference's logit
    of the kernel's top-1 within one bf16 ulp (at its top's magnitude)
    below the reference's top-1, the kernel's logit of the reference's
    top-1 within one ulp below the kernel's; and at most 1 in 8 positions
    so. Every such tie is printed, with the two tokens' gaps in the head's
    f32 output (each path's last hidden states through the final norm and
    the lm_head again in f32: whether the tie is more than the bf16
    rounding); any other difference fails. Then NaN in every pool column
    past each row's frontier (position + k) and in the sink page must
    leave the kernel path's logits bit-equal."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    k = SPEC_KW["speculation_tokens"]
    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    b, n = len(prompts), SPEC_PROMPT
    per_row = math.ceil((n + k + 1) / PAGE)
    tp = SPEC_KW["max_seq_len"] // PAGE
    num_pages = b * per_row
    table = torch.full((b, tp), num_pages, dtype=torch.int32, device="cuda")
    for row in range(b):
        table[row, :per_row] = torch.arange(row * per_row, (row + 1) * per_row,
                                            dtype=torch.int32, device="cuda")
    tokens = torch.tensor(prompts, dtype=torch.long, device="cuda")
    cache = tf.make_kv_cache(cfg, b, n, device="cuda")
    tf.prefill(params, tokens, torch.full((b,), n, device="cuda"), cache, cfg)
    pool = tf.make_page_pool(cfg, num_pages, PAGE, device="cuda")
    tf.paged_insert_cache(pool, cache, table, PAGE)
    del cache
    # the verify inputs: the last prompt token, then what the prompt's
    # period continues with (a repeated prompt's drafts are right)
    inputs = torch.stack([torch.tensor(p[n - 1:n] + [p[n - 24 + j] for j in range(k)])
                          for p in prompts]).to("cuda")
    positions = torch.full((b,), n - 1, dtype=torch.long, device="cuda")
    ref_pool = {name: pool[name].clone() for name in ("k", "v")}
    hidden = []  # each path's last hidden states, as the head takes them (for f32 gaps)
    unembed = tf._unembed

    def keep(p, x, c, *rest):
        hidden.append(x)
        return unembed(p, x, c, *rest)

    tf._unembed = keep
    try:
        kernel = tf.paged_verify_step_inplace(params, inputs, positions, pool, table, cfg,
                                              PAGE)[0]
        reference = tf.paged_verify_step_inplace(params, inputs, positions, ref_pool, table,
                                                 ref_cfg, PAGE)[0]
    finally:
        tf._unembed = unembed
    head = params["lm_head"].float()
    f32 = [tf.rms_norm(x, params["final_norm"], cfg.rms_norm_eps).float() @ head
           for x in hidden]
    del head, hidden
    rec: dict = {"rows": b, "positions": k + 1, "tolerance": MODEL_REL_TOL}
    rels, ties, flips = [], [], []
    eps = torch.finfo(torch.bfloat16).eps
    for row in range(b):
        for j in range(k + 1):
            a, r = kernel[row, j].float(), reference[row, j].float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"verify row {row} position {j}: non-finite logits")
            rels.append(((a - r).abs().max() / r.abs().max()).item())
            got, top = int(torch.argmax(a)), int(torch.argmax(r))
            if got == top:
                continue
            gaps = {"reference_gap": (r[top] - r[got]).item(),
                    "kernel_gap": (a[got] - a[top]).item()}
            ulps = [eps * 2.0 ** math.floor(math.log2(abs(x[i].item())))
                    for x, i in ((r, top), (a, got))]
            fa, fr = f32[0][row, j], f32[1][row, j]
            (ties if gaps["reference_gap"] <= ulps[0] and gaps["kernel_gap"] <= ulps[1]
             else flips).append({
                "row": row, "position": j, "reference_top1": top, "kernel_top1": got,
                **gaps, "bf16_ulp": ulps[0], "reference_gap_f32": (fr[top] - fr[got]).item(),
                "kernel_gap_f32": (fa[got] - fa[top]).item(),
            })
    rec.update({"max_rel_err": max(rels), "rel_err_by_row": [
        [round(x, 5) for x in rels[i * (k + 1):(i + 1) * (k + 1)]] for i in range(b)
    ], "top1_ties_within_one_ulp": ties, "top1_unequal": flips})
    log(f"spec verify reference numbers {json.dumps(rec)}")
    if max(rels) > MODEL_REL_TOL:
        raise AssertionError(f"verify logits: rel err {max(rels)} > {MODEL_REL_TOL}")
    if flips or 8 * len(ties) > b * (k + 1):
        raise AssertionError(f"verify top-1 differs from the reference path: {flips}, "
                             f"{len(ties)} one-ulp ties of {b * (k + 1)} positions")
    # NaN past every row's frontier (its own pages past position + k, and
    # the sink): the same verify again must give the same bits
    for row in range(b):
        frontier = n - 1 + k
        for lp in range(per_row):
            first = max(0, frontier + 1 - lp * PAGE)
            if first < PAGE:
                for name in ("k", "v"):
                    pool[name][:, row * per_row + lp, :, first:] = float("nan")
    for name in ("k", "v"):
        pool[name][:, num_pages] = float("nan")
    again = tf.paged_verify_step_inplace(params, inputs, positions, pool, table, cfg, PAGE)[0]
    rec["nan_past_frontier_bit_equal"] = bool(torch.equal(again, kernel))
    if not rec["nan_past_frontier_bit_equal"]:
        raise AssertionError("NaN past the verify frontier or in the sink changed the logits")
    return rec


def phase_spec(ctx: dict) -> None:
    """Self-speculative decoding at llama-3-8b's full width and
    ``SHALLOW_LAYERS`` of its layers (bf16, paged, page 64, max-batch 8, k 4): the 8 requests with speculation on
    and then off (fresh engines, a fresh sink), their steady replays, the
    agreement of their greedy tokens; then the replay, reference and
    planted-NaN checks of the verify."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    prompts = _spec_prompts(ctx["seed"])
    on = _serve(ctx, cfg, params, [], SPEC_NEW, prompts=prompts, steady=True,
                speculation="auto", **SPEC_KW)
    _require_launches(on, "paged_decode", "verify_dispatches", cfg.n_layers)
    _require_launches(on, "flash_prefill", "admit_groups", cfg.n_layers)
    if on["decode_chunks"] != 0:
        raise AssertionError(f"spec: {on['decode_chunks']} decode chunks beside the verifies")
    off = _serve(ctx, cfg, params, [], SPEC_NEW, prompts=prompts, steady=True,
                 max_seq_len=SPEC_KW["max_seq_len"])
    _require_launches(off, "paged_decode", "decode_steps", cfg.n_layers)
    agree, diverge = [], []
    for prompt, a, b in zip(prompts, on["_tokens"], off["_tokens"]):
        agree.append(sum(x == y for x, y in zip(a, b)) / max(1, len(b)))
        diverge.append(_first_divergence(ctx, cfg, params, prompt, a, b))
    for label, run in (("on", on), ("off", off)):
        log(f"spec {label} llama-3-8b bf16 "
            f"{json.dumps({k: v for k, v in run.items() if not k.startswith('_')})}")
    verify, decode = on["steady_replays"], off["steady_replays"]
    log("spec summary " + json.dumps({
        "tokens_per_s_on": on["tokens_per_s"], "tokens_per_s_off": off["tokens_per_s"],
        "speedup": on["tokens_per_s"] / off["tokens_per_s"],
        "verify_step_device_ms": verify["device_ms_per_step"],
        "verify_step_wall_ms": verify["wall_ms_per_step"],
        "decode_step_device_ms": decode["device_ms_per_step"],
        "decode_step_wall_ms": decode["wall_ms_per_step"],
        "acceptance_rate": on["spec_acceptance_rate"],
        "accepted_tokens_per_step": on["spec_accepted_tokens_per_step"],
        "draft_hit_rate": on["spec_draft_hit_rate"],
        "verify_dispatches": on["verify_dispatches"],
    }))
    log(f"spec greedy-token agreement with speculation off, per request (printed, not "
        f"required; the first 4 prompts repeat) {json.dumps(agree)}")
    log(f"spec first divergence per request {json.dumps(diverge)}")
    replay = _verify_replay_check(ctx, cfg, params, prompts)
    log(f"spec verify replay check {json.dumps(replay)}")
    reference = _verify_reference_check(ctx, cfg, params, prompts)
    log(f"spec verify reference check: max rel err {reference['max_rel_err']}, NaN past the "
        f"frontier bit-equal {reference['nan_past_frontier_bit_equal']}")
    ctx["spec"] = {k: v for k, v in on.items() if not k.startswith("_")}


# the tenancy phase: two tenants (and the drill's "chaos-burst" with a
# small queue share, so the burst sheds), 32 new tokens a request
TENANCY_NEW = 32
TENANCY_TENANTS = [
    {"name": "victim", "weight": 1},
    {"name": "aggressor", "weight": 1, "max-slots": 6, "queue-share": 0.5},
    {"name": "chaos-burst", "queue-share": 0.1},
]
TENANCY_QUEUE = 40


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _same_or_tie(ctx, cfg, params, label: str, prompts, got, want, lora=None,
                 rows=None) -> dict:
    """Greedy tokens of two runs of the same requests: equal, or the first
    position where a request's runs differ holds a tie — on the kernel
    path's logits there (a prefill of the prompt and the shared tokens)
    the two tokens the runs chose both rank first (ranks count the logits
    strictly above: a three-way tie ranks two tokens second) and lie
    within one bf16 ulp each way of each other (the ``spec`` phase's
    rule): a GEMM of another shape (another admit group's rows, a decode
    step's 8 rows against a verify's 40) rounds such a pair either way.
    Returns the agreement per request, every divergence, and ``ok``: False
    when one is not such a tie (the phase fails at its end). ``lora`` /
    ``rows``: the adapter pool and each request's row in it."""
    agree, ties, bad = [], [], []
    for i, (prompt, a, b) in enumerate(zip(prompts, got, want)):
        agree.append(sum(x == y for x, y in zip(a, b)) / max(1, len(b)))
        if a == b:
            continue
        d = _first_divergence(ctx, cfg, params, prompt, a, b, lora=lora,
                              adapter_row=rows[i] if rows else 0)
        if d is None:
            bad.append({"lengths": [len(a), len(b)]})
            continue
        vals = d["chosen_values"]
        d["ulp"] = _bf16_ulp(d["top2_values"][0])
        tie = max(d["chosen_ranks"]) <= 1 and abs(vals[0] - vals[1]) <= 2 * d["ulp"]
        (ties if tie else bad).append(d)
    return {"label": label, "agreement": agree, "ties": ties, "not_ties": bad,
            "equal": not ties and not bad, "ok": not bad}


def _memory_reading(torch, engine, base_alloc: int, base_reserved: int) -> dict:
    """The engine's peak beside its plan, from a reset taken before it was
    built: the peak of live tensors and the growth of what the allocator
    holds (the graph pool's blocks stay reserved while free), each against
    the plan's bytes beyond the weights; fails where a peak passes it."""
    plan = engine.memory_plan
    beyond = plan.total_bytes - plan.weights_bytes
    rec = {
        "graph_sets": list(plan.graph_sets),
        "plan_beyond_weights_bytes": beyond,
        "plan_graph_pool_bytes": plan.graph_pool_bytes,
        "plan_summary": plan.summary(),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated() - base_alloc,
        "peak_reserved_growth_bytes": torch.cuda.max_memory_reserved() - base_reserved,
    }
    for key in ("peak_allocated_bytes", "peak_reserved_growth_bytes"):
        if rec[key] > beyond:
            raise AssertionError(f"memory: {key} {rec[key]} passes the plan's {beyond} beyond "
                                 f"the weights ({plan.summary()})")
    return rec


def _fresh_base(torch) -> tuple[int, int]:
    import gc

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _capture_reading(engine) -> dict:
    stats = engine.stats()
    return {
        "graph_sets": stats["graph-sets"],
        "graph_captures": stats["graph-captures-total"],
        "graph_capture_s": stats["graph-capture-s"],
        "graph_capture_parts_s": stats["graph-capture-parts-s"],
        "graph_pool_bytes": stats["graph-pool-bytes"],
    }


def _run_all(engine, prompts, options) -> list:
    """Every (prompt, options) submitted now → results, each required to
    end with all its tokens."""
    from langstream_tpu_torch.serving.engine import GenerationRequest

    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=o))
            for p, o in zip(prompts, options)]
    results = [r.result(timeout=900) for r in reqs]
    for p, r in zip(prompts, results):
        if r.finish_reason != "length" or len(r.tokens) != TENANCY_NEW:
            raise AssertionError(f"request of {len(p)} tokens ended {r.finish_reason} with "
                                 f"{len(r.tokens)} tokens")
    return results


def _tenant_traffic(prompts):
    """16 low-priority aggressor requests, then 4 normal victim ones."""
    from langstream_tpu_torch.models.configs import GenerationOptions

    reqs = [(prompts[i % len(prompts)], GenerationOptions(
        max_new_tokens=TENANCY_NEW, tenant="aggressor", priority="low")) for i in range(16)]
    reqs += [(prompts[(i + 3) % len(prompts)], GenerationOptions(
        max_new_tokens=TENANCY_NEW, tenant="victim")) for i in range(4)]
    return [p for p, _ in reqs], [o for _, o in reqs]


def _forced_levels(ctx, cfg, params, engine, prompts) -> dict:
    """The 8 requests one after another at brownout levels 0, 1, 2 and 0
    again (pinned by hand; the dwell never elapses): the same tokens in
    every pass; level 2 dispatches no verify and replays the decode set
    once a chunk, levels 0 and 1 replay the verify set once a verify; the
    paged decode kernel launches exactly layers x (decode steps +
    verifies) in each pass."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest

    opts = GenerationOptions(max_new_tokens=TENANCY_NEW)
    passes = []
    for level in (0, 1, 2, 0):
        engine._brownout.level = level
        before = engine.stats()
        reset_kernel_counts()
        t0 = time.monotonic()
        results = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)).result(
            timeout=900) for p in prompts]
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        counts = kernel_counts()
        after = engine.stats()

        def delta(key):
            return after[key] - before[key]

        kinds = {k: after["graph-replays-by-kind"][k] - before["graph-replays-by-kind"][k]
                 for k in ("decode", "verify")}
        rec = {
            "level": level,
            "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in results) / wall,
            "verifies": delta("spec-verify-dispatches-total"),
            "decode_chunks": delta("decode-chunks-total"),
            "decode_steps": delta("decode-steps-total"),
            "draft_tokens": delta("spec-draft-tokens-total"),
            "replays_by_kind": kinds,
            "paged_decode_launches": counts["paged_decode"]["launches"],
            "_tokens": [r.tokens for r in results],
        }
        plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
        if plain:
            raise AssertionError(f"brownout level {level}: plain versions ran: {plain}")
        if any(len(r.tokens) != TENANCY_NEW for r in results):
            raise AssertionError(f"brownout level {level}: a request ended short")
        if level == 2 and (rec["verifies"] or kinds["decode"] != rec["decode_chunks"]
                           or not rec["decode_chunks"]):
            raise AssertionError(f"brownout level 2: {rec}")
        if level < 2 and (kinds["verify"] != rec["verifies"] or not rec["verifies"]
                          or rec["decode_chunks"]):
            raise AssertionError(f"brownout level {level}: {rec}")
        want = cfg.n_layers * (rec["decode_steps"] + rec["verifies"])
        if rec["paged_decode_launches"] != want:
            raise AssertionError(f"brownout level {level}: {rec['paged_decode_launches']} paged "
                                 f"decode launches != {cfg.n_layers} x (steps + verifies) "
                                 f"{want}")
        if level == 1 and rec["draft_tokens"] > 2 * rec["verifies"] * 8:
            raise AssertionError(f"brownout level 1 proposed more than k/2 drafts: {rec}")
        passes.append(rec)
    engine._brownout.level = 0
    base = passes[0]["_tokens"]
    for rec in passes[1:]:
        rec["same_as_level0"] = _same_or_tie(ctx, cfg, params, f"brownout level {rec['level']}",
                                             prompts, rec["_tokens"], base)
    return {"passes": [{k: v for k, v in r.items() if not k.startswith("_")} for r in passes]}


def _observability_drill(engine) -> dict:
    """``nan@1`` and ``tenant-burst@1`` planted in the phase's engine at
    level 2 (decode chunks, where the ``nan`` site reads): the burst's
    max-batch requests under "chaos-burst" — its queue share takes 4, the
    rest shed against it — and one ``nan-quarantine`` dump that passes the
    port's ``validate_flight_dump`` and holds no token content."""
    from langstream_tpu_torch.serving import observability as obs
    from langstream_tpu_torch.serving.faultinject import FaultInjector

    before = [d for d in obs.recent_dumps() if d["reason"] == "nan-quarantine"]
    engine._brownout.level = 2
    engine._injector = FaultInjector("tenant-burst@1,nan@1")
    deadline = time.monotonic() + 120
    while True:
        stats = engine.stats()
        burst = stats["tenants"].get("chaos-burst", {})
        if burst.get("admitted-total", 0) + burst.get("shed-total", 0) >= engine.max_batch and (
                stats["active-slots"] == 0 and stats["queued"] == 0):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"tenant-burst drill did not settle: {burst}")
        time.sleep(0.05)
    engine._brownout.level = 0
    dumps = [d for d in obs.recent_dumps() if d["reason"] == "nan-quarantine"]
    new = dumps[len(before):]
    if len(new) != 1:
        raise AssertionError(f"{len(new)} nan-quarantine dumps, not 1")
    obs.validate_flight_dump(new[0])
    text = json.dumps(new[0])
    if any(f'"{k}"' in text for k in ("tokens", "prompt", "generated", "drafts", "text")):
        raise AssertionError("the nan-quarantine dump carries token content")
    if burst.get("shed-total") != engine.max_batch - 4 or stats["fault-injection"] != {
            "tenant-burst": 1, "nan": 1}:
        raise AssertionError(f"tenant-burst drill: {burst}, {stats['fault-injection']}")
    return {
        "chaos_burst": {k: burst[k] for k in ("submitted-total", "admitted-total",
                                              "shed-total")},
        "nan_dump_iterations": len(new[0]["iterations"]),
        "nan_dump_extra": new[0]["extra"],
        "fault_injection": stats["fault-injection"],
        "nan_guard_total": stats["nan-guard-total"],
        "flight_dumps_total": stats["flight-dumps-total"],
    }


def phase_tenancy(ctx: dict) -> None:
    """Multi-tenant overload control and observability at llama-3-8b's
    full width and SHALLOW_LAYERS of its depth (bf16, paged, page 64, max-batch 8, max_seq_len
    2048, decode chunk 16, greedy, speculation k 4; the ``spec`` phase's
    prompts, 32 new tokens a request):

    1. tenancy — 16 low-priority "aggressor" requests (max-slots 6, queue
       share 0.5) then 4 "victim" requests, queued before ``start()``:
       every request ends with its tokens, no flight frame and no
       ``tenants`` snapshot shows the aggressor past 6 slots, and the
       tokens equal a tenant-free engine's (a tie aside, ``_same_or_tie``);
       each tenant's TTFT p50 and maximum;
    2. brownout, forced — ``_forced_levels``;
    3. capture and memory — the capture's parts, the graph pool and the
       engine's peak against its plan (``_memory_reading``) for one set
       (speculation off), one set (speculation on, brownout off) and both
       sets;
    4. observability — the ``e2e`` requests with observability on, off, off
       and on (tokens/s of each; the same tokens, a tie aside), then
       ``_observability_drill``.

    Token comparisons that fail are raised at the end of the phase, after
    every reading is printed."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    prompts = _spec_prompts(ctx["seed"])
    tok = ByteTokenizer()
    kw = dict(max_batch=8, decode_chunk=16, page_size=PAGE, eos_token_id=tok.eos_token_id,
              rng_seed=ctx["seed"], device="cuda", speculation="auto", **SPEC_KW)
    traffic, options = _tenant_traffic(prompts)
    out: dict = {"capture": {}, "memory": {}}

    # 1 + 3 (both sets): the tenant engine, its traffic queued before start()
    base = _fresh_base(torch)
    engine = ServingEngine(cfg, params, tenants=TENANCY_TENANTS, queue_depth=TENANCY_QUEUE,
                           brownout_dwell_s=1e9, **kw)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=o))
            for p, o in zip(traffic, options)]
    engine.start()
    # the burst met an engine that had just captured its graphs: its
    # TTFT counts from there
    opened = time.monotonic()
    peak_active = 0
    while not all(r._done.is_set() for r in reqs):
        peak_active = max(peak_active, engine.stats()["tenants"].get("aggressor", {}).get(
            "active-slots", 0))
        time.sleep(0.02)
    results = [r.result(timeout=900) for r in reqs]
    out["memory"]["both_sets"] = _memory_reading(torch, engine, *base)
    out["capture"]["both_sets"] = _capture_reading(engine)
    for p, r in zip(traffic, results):
        if r.finish_reason != "length" or len(r.tokens) != TENANCY_NEW:
            raise AssertionError(f"tenancy: request of {len(p)} tokens ended "
                                 f"{r.finish_reason} with {len(r.tokens)} tokens")
    frames = engine._obs.flight.iterations()
    frame_peak = max(f["tenants"].get("aggressor", 0) for f in frames)
    if frame_peak > 6 or peak_active > 6:
        raise AssertionError(f"tenancy: the aggressor held {frame_peak} slots in a frame, "
                             f"{peak_active} in a snapshot (max-slots 6)")
    stats = engine.stats()
    ttft = {}
    for tenant in ("victim", "aggressor"):
        vals = sorted(q.submitted_at + r.ttft_s - opened
                      for q, r, o in zip(reqs, results, options) if o.tenant == tenant)
        ttft[tenant] = {"ttft_after_start_p50_s": vals[len(vals) // 2],
                        "ttft_after_start_max_s": vals[-1],
                        "counters": {k: stats["tenants"][tenant][k] for k in (
                            "submitted-total", "admitted-total", "shed-total",
                            "generated-tokens-total")}}
    out["tenancy"] = {"tenants": ttft, "aggressor_peak_slots_frames": frame_peak,
                      "aggressor_peak_slots_snapshots": peak_active,
                      "frames": len(frames)}

    # 3 (one set, speculation on, brownout off) — and the tenant-free
    # reference of part 1, its traffic queued before start() as well
    engine.stop()  # parked while the reference serves; restarted for part 2
    base_b = _fresh_base(torch)
    engine_b = ServingEngine(cfg, params, brownout="off", queue_depth=TENANCY_QUEUE, **kw)
    reqs = [engine_b.submit(GenerationRequest(prompt_tokens=p, options=GenerationOptions(
        max_new_tokens=TENANCY_NEW))) for p in traffic]
    engine_b.start()
    ref = [r.result(timeout=900) for r in reqs]
    out["memory"]["verify_set"] = _memory_reading(torch, engine_b, *base_b)
    out["capture"]["verify_set"] = _capture_reading(engine_b)
    engine_b.stop()
    del engine_b
    out["tenancy"]["same_as_no_tenants"] = _same_or_tie(
        ctx, cfg, params, "tenancy vs no tenants", traffic, [r.tokens for r in results],
        [r.tokens for r in ref])

    # 2 + 4 (the drill) on the tenant engine
    engine.start()
    try:
        out["brownout"] = _forced_levels(ctx, cfg, params, engine, prompts)
        out["drill"] = _observability_drill(engine)
    finally:
        engine.stop()
    del engine
    gc.collect()

    # 3 (one set, speculation off)
    base_a = _fresh_base(torch)
    engine_a = ServingEngine(cfg, params, **{**kw, "speculation": "off"})
    engine_a.start()
    try:
        _run_all(engine_a, prompts, [GenerationOptions(max_new_tokens=TENANCY_NEW)] * 8)
        out["memory"]["decode_set"] = _memory_reading(torch, engine_a, *base_a)
        out["capture"]["decode_set"] = _capture_reading(engine_a)
    finally:
        engine_a.stop()
    del engine_a
    gc.collect()
    torch.cuda.empty_cache()

    # 4: the e2e burst, observability on and off
    e2e = [tok.encode(p)
           for p in _prompts([20, 90, 150, 300, 600, 900, 1200, 1500], ctx["seed"])]
    # in turns (on, off, off, on), each on a fresh engine, so neither side
    # owns the card's warm-up
    runs = [(on, _serve(ctx, cfg, params, [], 64, prompts=e2e, observability=on))
            for on in (True, False, False, True)]
    out["observability"] = {
        "tokens_per_s_on": [r["tokens_per_s"] for on, r in runs if on],
        "tokens_per_s_off": [r["tokens_per_s"] for on, r in runs if not on],
        "ttft_p50_s_on": [r["ttft_p50_s"] for on, r in runs if on],
        "ttft_p50_s_off": [r["ttft_p50_s"] for on, r in runs if not on],
        "same_tokens": [
            _same_or_tie(ctx, cfg, params, f"observability {'on' if on else 'off'} vs on", e2e,
                         r["_tokens"], runs[0][1]["_tokens"])
            for on, r in runs[1:]
        ],
    }
    for part in ("tenancy", "brownout", "capture", "memory", "observability", "drill"):
        log(f"tenancy {part} {json.dumps(out[part])}")
    ctx["tenancy"] = out
    compared = [out["tenancy"]["same_as_no_tenants"], *out["observability"]["same_tokens"]] + [
        r["same_as_level0"] for r in out["brownout"]["passes"][1:]]
    failed = [c for c in compared if not c["ok"]]
    if failed:
        raise AssertionError(f"tenancy: tokens differ, not at a tie: {json.dumps(failed)}")


AGENTIC_NEW = 64
AGENTIC_KW = {"max_seq_len": 2048, "prefill_buckets": (32, 64, 128, 256, 512)}
# three rank-16 adapters over a pool of base + 2 rows: the third needs a
# swap. Both factors are random (a trained adapter's B starts at zero), so
# at scale 1 a delta is as large as its base projection and the bf16
# reference path itself lands 8.5% of the largest logit off an f32
# reference (``_adapter_precision``): the phase serves them at 0.5
AGENTIC_ADAPTERS = [{"name": f"tenant-{c}", "rank": 16, "scale": 0.5, "seed": 1000 + i}
                    for i, c in enumerate("abc")]
# the kernel path's error against an f32 reference may exceed the bf16
# reference path's own error by at most this factor, plus 0.1% of the
# largest logit
PRECISION_FACTOR = 1.25
AGENTIC_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8}, "n": {"type": "integer"},
    "ok": {"type": "boolean"}}}
AGENTIC_FORMATS = {
    "record": {"type": "json_schema", "json_schema": {"schema": AGENTIC_SCHEMA}},
    "verdict": {"type": "regex", "regex": "(yes|no)-[0-9]{2,4}"},
    "words": {"type": "regex", "regex": "[a-z]{2,10}( [a-z]{2,10}){1,3}\\."},
}
# (prompt, adapter, response format) of the two waves: 2 base requests and
# 2 for each adapter; 4 constrained, 3 of them with an adapter. The second
# wave's adapter finds both usable rows taken (by idle adapters): a swap
AGENTIC_WAVES = (
    ((0, None, None), (1, None, "record"), (2, "tenant-a", None), (3, "tenant-a", "verdict"),
     (4, "tenant-b", None), (5, "tenant-b", "record")),
    ((6, "tenant-c", None), (7, "tenant-c", "words")),
)


def _pause(engine) -> None:
    """Stop the engine thread without failing anything, so the requests
    submitted next wait in the queue together (one admission, whatever the
    timing); ``start()`` resumes it with the graphs it captured."""
    engine._stop.set()
    engine._thread.join(timeout=120)
    engine._thread = None


def _in_grammar(rf: dict, text: str) -> bool:
    if rf["type"] == "regex":
        return re.fullmatch(rf["regex"], text) is not None
    try:
        doc = json.loads(text)
    except ValueError:
        return False
    return (isinstance(doc, dict) and list(doc) == ["name", "n", "ok"]
            and isinstance(doc["name"], str) and len(doc["name"]) <= 8
            and isinstance(doc["n"], int) and isinstance(doc["ok"], bool))


def _agentic_waves(engine, prompts, waves, new_tokens: int) -> dict:
    """Serve ``waves`` of (prompt, adapter, format) one after another, each
    queued while the engine thread is paused, with the kernel counts zeroed
    before the first; every constrained output must parse and end with
    "stop", every other one end with its ``new_tokens`` (or at EOS, as in
    ``_serve``); no plain version
    may run, and every decode chunk or verify is one replay."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    before = engine.stats()
    reset_kernel_counts()
    results: dict = {}
    t0 = time.monotonic()
    for wave in waves:
        _pause(engine)
        reqs = [(i, a, f, engine.submit(GenerationRequest(
            prompt_tokens=prompts[i], options=GenerationOptions(
                max_new_tokens=new_tokens, adapter=a,
                response_format=AGENTIC_FORMATS[f] if f else None))))
            for i, a, f in wave]
        engine.start()
        for i, a, f, r in reqs:
            results[i] = (a, f, r.result(timeout=900))
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    counts = kernel_counts()
    after = engine.stats()
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"agentic: plain versions ran on the card's main path: {plain}")
    outputs = []
    for i in sorted(results):
        a, f, r = results[i]
        text = tok.decode(r.tokens)
        rec = {"prompt_tokens": len(prompts[i]), "adapter": a, "format": f,
               "finish": r.finish_reason, "tokens": len(r.tokens)}
        if f is not None:
            rec["text"] = text
            if r.finish_reason != "stop" or not _in_grammar(AGENTIC_FORMATS[f], text):
                raise AssertionError(f"agentic: constrained output {rec} is not in its grammar")
        elif r.finish_reason not in ("length", "stop") or (
                r.finish_reason == "length" and len(r.tokens) != new_tokens):
            raise AssertionError(f"agentic: request {rec} ended short")
        if any(t < 0 or t >= 256 for t in r.tokens) and f is not None:
            raise AssertionError(f"agentic: constrained output holds a non-byte token: {rec}")
        outputs.append(rec)

    def delta(key):
        return after[key] - before[key]

    steps, verifies = delta("decode-steps-total"), delta("spec-verify-dispatches-total")
    dispatches = delta("decode-chunks-total") + verifies
    replays = delta("graph-replays-total")
    launches = {k: v["launches"] for k, v in counts.items()}
    layers = engine.config.n_layers
    if launches["paged_decode"] != layers * (steps + verifies) or replays != dispatches:
        raise AssertionError(f"agentic: {launches['paged_decode']} paged decode launches for "
                             f"{steps} steps + {verifies} verifies of {layers} layers; "
                             f"{replays} replays of {dispatches} dispatches")
    if launches["flash_prefill"] <= 0 or launches["flash_segment"] <= 0:
        raise AssertionError(f"agentic: prefill kernels did not run: {launches}")
    return {
        "outputs": outputs,
        "wall_s": wall,
        "tokens_per_s": sum(o["tokens"] for o in outputs) / wall,
        "decode_steps": steps,
        "verifies": verifies,
        "graph_replays": replays,
        "kernel_launches": launches,
        "admit_groups": delta("admit-groups-total"),
        "segments": delta("prefill-segments-total"),
        "adapter_swaps": delta("adapter-swaps-total"),
        "grammar_swaps": delta("grammar-swaps-total"),
        "constrained_requests": delta("constrained-requests-total"),
        "_tokens": {i: results[i][2].tokens for i in results},
    }


def _agentic_drill(ctx, cfg, params, engine, prompts) -> dict:
    """Prompts 1 and 3, each as a base request and through "tenant-c", 32
    new tokens, queued together: once clean, then with ``adapter@1``
    planted (the first decode dispatch bumps one active slot's
    dispatch-facing adapter row). Exactly one request fails with the
    adapter-row corruption, one new ``adapter-quarantine`` dump validates
    and names a slot, the survivors' tokens are the clean run's (but for
    ties), no restart; and in the clean run the adapter's tokens differ
    from the base model's on both prompts."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving import observability as obs
    from langstream_tpu_torch.serving.engine import GenerationRequest
    from langstream_tpu_torch.serving.faultinject import FaultInjector

    items = [(1, None), (1, "tenant-c"), (3, None), (3, "tenant-c")]

    def run():
        _pause(engine)
        reqs = [engine.submit(GenerationRequest(prompt_tokens=prompts[i], options=(
            GenerationOptions(max_new_tokens=32, adapter=a)))) for i, a in items]
        engine.start()
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=900))
            except RuntimeError as e:
                out.append(e)
        return out

    clean = run()
    if any(isinstance(r, Exception) for r in clean):
        raise AssertionError(f"agentic drill: the clean run failed: {clean}")
    for j in (0, 2):
        if clean[j].tokens == clean[j + 1].tokens:
            raise AssertionError(f"agentic drill: tenant-c gave the base model's tokens on "
                                 f"prompt {items[j][0]}")
    before = [d for d in obs.recent_dumps() if d["reason"] == "adapter-quarantine"]
    quarantined0 = engine.stats()["quarantined-slots-total"]
    engine._injector = FaultInjector("adapter@1")
    try:
        faulty = run()
    finally:
        engine._injector = None
    stats = engine.stats()
    dumps = [d for d in obs.recent_dumps() if d["reason"] == "adapter-quarantine"]
    new = dumps[len(before):]
    victims = [j for j, r in enumerate(faulty) if isinstance(r, Exception)]
    if len(victims) != 1 or "adapter-row corruption" not in str(faulty[victims[0]]):
        raise AssertionError(f"agentic drill: victims {victims}: {faulty}")
    if len(new) != 1 or new[0]["extra"]["slot"] not in range(engine.max_batch):
        raise AssertionError(f"agentic drill: {len(new)} adapter-quarantine dumps")
    obs.validate_flight_dump(new[0])
    if stats["quarantined-slots-total"] - quarantined0 != 1 or stats["engine-restarts-total"]:
        raise AssertionError(f"agentic drill: {stats['quarantined-slots-total']} quarantined, "
                             f"{stats['engine-restarts-total']} restarts")
    rows = engine._adapters._by_name["tenant-c"].row
    survivors = [j for j in range(len(items)) if j not in victims]
    same = _same_or_tie(
        ctx, cfg, params, "adapter drill survivors vs clean",
        [prompts[items[j][0]] for j in survivors], [faulty[j].tokens for j in survivors],
        [clean[j].tokens for j in survivors], lora=engine._adapters.pool,
        rows=[rows if items[j][1] else 0 for j in survivors],
    )
    return {"victim": items[victims[0]], "dump_slot": new[0]["extra"]["slot"],
            "dump_iterations": len(new[0]["iterations"]), "survivors": same,
            "base_vs_adapter_agreement": [
                sum(x == y for x, y in zip(clean[j].tokens, clean[j + 1].tokens)) / 32
                for j in (0, 2)]}


def _adapter_precision(ctx, cfg, params) -> dict:
    """Prefill logits of ``_model_check``'s 200-token prompt through
    "tenant-c" at scales 1.0, 0.5 (the phase's) and 0 (the base model):
    the kernel path and the reference path in bf16, each against the
    reference path in f32 (the weights and factors widened). Fails where
    the kernel path's error against f32 passes PRECISION_FACTOR times the
    bf16 reference path's plus 0.1%: the kernel path must be as exact as
    the reference it is held to."""
    import torch

    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.serving.adapters import AdapterRegistry

    reg = AdapterRegistry(cfg, 3, 16, device="cuda")
    for spec in AGENTIC_ADAPTERS:
        reg.register(spec)
    row = reg.acquire("tenant-c")
    ref = dataclasses.replace(cfg, attention_impl="jnp")
    f32 = dataclasses.replace(cfg, attention_impl="jnp", dtype="float32")
    prompt = [256] + [(37 * i + 11) % 250 for i in range(199)]
    tokens = torch.tensor([prompt], dtype=torch.long, device="cuda")
    lengths = torch.tensor([len(prompt)], device="cuda")
    rows = torch.tensor([row], device="cuda")

    def widen(tree):
        return {k: widen(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()

    def logits(c, p, lora):
        cache = tf.make_kv_cache(c, 1, len(prompt), device="cuda")
        return tf.prefill(p, tokens, lengths, cache, c, lora=lora, adapter_rows=rows)[0].float()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    out = {}
    with torch.no_grad():
        for scale in (1.0, 0.5, 0.0):
            reg.pool["scale"][row].fill_(scale)
            kernel, ref_bf16 = logits(cfg, params, reg.pool), logits(ref, params, reg.pool)
            wide = widen(params)
            ref_f32 = logits(f32, wide, widen(reg.pool))
            del wide
            torch.cuda.empty_cache()
            rec = {"kernel_vs_reference": rel(kernel, ref_bf16),
                   "kernel_vs_f32": rel(kernel, ref_f32),
                   "reference_vs_f32": rel(ref_bf16, ref_f32),
                   "top1": [int(kernel.argmax()), int(ref_bf16.argmax()), int(ref_f32.argmax())]}
            out[f"scale_{scale}"] = rec
            if rec["kernel_vs_f32"] > PRECISION_FACTOR * rec["reference_vs_f32"] + 1e-3:
                raise AssertionError(f"agentic: at adapter scale {scale} the kernel path is "
                                     f"further from f32 than the bf16 reference path: {rec}")
    out["factor"] = PRECISION_FACTOR
    return out


def phase_agentic(ctx: dict) -> None:
    """The agentic tier at llama-3-8b's full width and SHALLOW_LAYERS of
    its depth (module docstring, phase 12): the tier-on engine's two waves, its pools and
    memory against the plan, an adapter's model check, the ``adapter``
    drill and back-to-back replays; the same traffic with speculation on;
    an engine with the tier off for the replay and capture comparison.
    Token comparisons that fail are raised at the end, after every reading
    is printed."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.memory import tree_bytes
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts([20, 90, 150, 300, 600, 900, 1200, 1500],
                                               ctx["seed"] + 11)]
    kw = dict(max_batch=8, decode_chunk=16, page_size=PAGE, eos_token_id=tok.eos_token_id,
              rng_seed=ctx["seed"], device="cuda", brownout="off", **AGENTIC_KW)
    tier = dict(adapters=AGENTIC_ADAPTERS, adapter_pool_rows=3, grammar_slots=4,
                grammar_tokenizer=tok)
    out: dict = {}

    # the tier on
    base = _fresh_base(torch)
    engine = ServingEngine(cfg, params, **kw, **tier)
    engine.start()
    reg = engine._constrain_reg
    compile_s = {}
    for name, rf in AGENTIC_FORMATS.items():
        t0 = time.monotonic()
        dfa = reg.compile(rf)
        compile_s[name] = {"s": time.monotonic() - t0, "states": dfa.n_states,
                           "exceptions": dfa.n_exceptions}
    run = _agentic_waves(engine, prompts, AGENTIC_WAVES, AGENTIC_NEW)
    if run["adapter_swaps"] != 3 or run["constrained_requests"] != 4:
        raise AssertionError(f"agentic: {run['adapter_swaps']} adapter swaps (3 expected), "
                             f"{run['constrained_requests']} constrained requests")
    out["serve"] = {k: v for k, v in run.items() if not k.startswith("_")}
    out["memory"] = _memory_reading(torch, engine, *base)
    plan = engine.memory_plan
    pools = {
        "adapter_pool_bytes": tree_bytes(engine._adapters.pool),
        "plan_adapter_pool_bytes": plan.adapter_pool_bytes,
        "adapter_row_bytes": tree_bytes(engine._adapters.pool) // engine._adapters.rows,
        "grammar_pool_bytes": sum(t.numel() * t.element_size() for t in reg.pool),
        "plan_grammar_pool_bytes": plan.grammar_pool_bytes,
    }
    out["pools"] = pools
    if (pools["adapter_pool_bytes"] != pools["plan_adapter_pool_bytes"]
            or pools["grammar_pool_bytes"] != pools["plan_grammar_pool_bytes"]):
        raise AssertionError(f"agentic: pool bytes against the plan's terms: {pools}")
    out["host"] = {
        "compile": compile_s,
        "adapter_swap_s": engine._adapters.swap_s_total / max(1, engine._adapters.swaps_total),
        "grammar_swap_s": reg.swap_s_total / max(1, reg.swaps_total),
        "constrain_overhead_ms": engine.stats()["constrain-overhead-ms"],
    }
    capture_on = _capture_reading(engine)
    engine.stop()
    with torch.no_grad():
        replay_on = _replay_rate(torch, engine)
        replay_on["top_kernels"] = _replay_profile(torch, engine)
    out["model_check"] = _model_check(
        ctx, cfg, params, lora=engine._adapters.pool,
        adapter_row=engine._adapters._by_name["tenant-c"].row,
    )
    if not out["model_check"]["step0_top1_equal"]:
        raise AssertionError(f"agentic: adapter first-token top-1 differs: {out['model_check']}")
    engine.start()
    try:
        out["drill"] = _agentic_drill(ctx, cfg, params, engine, prompts)
    finally:
        engine.stop()
    tokens_on = run["_tokens"]
    del engine, reg
    gc.collect()
    torch.cuda.empty_cache()

    # the same traffic with speculation on
    engine = ServingEngine(cfg, params, speculation="auto", speculation_tokens=4, **kw, **tier)
    engine.start()
    try:
        spec = _agentic_waves(engine, prompts, AGENTIC_WAVES, AGENTIC_NEW)
    finally:
        engine.stop()
    out["spec"] = {k: v for k, v in spec.items() if not k.startswith("_")}
    out["spec"]["agreement_with_decode"] = [
        sum(x == y for x, y in zip(spec["_tokens"][i], tokens_on[i])) / max(1, len(tokens_on[i]))
        for i in sorted(tokens_on)]
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the tier off: the 8 prompts as base requests
    engine = ServingEngine(cfg, params, constrained_decoding="off", **kw)
    engine.start()
    try:
        reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=GenerationOptions(
            max_new_tokens=AGENTIC_NEW))) for p in prompts]
        off = [r.result(timeout=900) for r in reqs]
    finally:
        engine.stop()
    with torch.no_grad():
        replay_off = _replay_rate(torch, engine)
    capture_off = _capture_reading(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # grammars alone: the default engine (constrained decoding on, no
    # adapters), its replays on idle slots
    engine = ServingEngine(cfg, params, **kw)
    engine.start()
    engine.stop()
    with torch.no_grad():
        replay_grammar = _replay_rate(torch, engine)
    capture_grammar = _capture_reading(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["precision"] = _adapter_precision(ctx, cfg, params)
    out["tier_on_off"] = {
        "replays_on": replay_on, "replays_off": replay_off,
        "replays_grammar_only": replay_grammar,
        "decode_step_device_ms_added": replay_on["device_ms_per_step"]
        - replay_off["device_ms_per_step"],
        "grammar_step_device_ms_added": replay_grammar["device_ms_per_step"]
        - replay_off["device_ms_per_step"],
        "capture_on": capture_on, "capture_off": capture_off,
        "capture_grammar_only": capture_grammar,
        "capture_ratio": capture_on["graph_capture_s"] / capture_off["graph_capture_s"],
        "graph_pool_bytes_added": capture_on["graph_pool_bytes"]
        - capture_off["graph_pool_bytes"],
        # a base request rides grammar row 0 and adapter row 0
        "base_same_as_tier_off": _same_or_tie(ctx, cfg, params, "tier on vs off, base",
                                              [prompts[0]], [tokens_on[0]], [off[0].tokens]),
    }
    for part in ("serve", "spec", "pools", "memory", "host", "model_check", "precision",
                 "drill", "tier_on_off"):
        log(f"agentic {part} {json.dumps(out[part])}")
    ctx["agentic"] = run
    compared = [out["drill"]["survivors"], out["tier_on_off"]["base_same_as_tier_off"]]
    failed = [c for c in compared if not c["ok"]]
    if failed:
        raise AssertionError(f"agentic: tokens differ, not at a tie: {json.dumps(failed)}")


# the checkpoint phase: shards of at most 5 GB, as the published
# Meta-Llama-3-8B checkpoint is sharded, written inside the checkout
# the embed phase: 32 byte-tokenized texts of 16..512 tokens (the sizes of
# RAG ingestion chunks), one of them twice
EMBED_TEXTS = 32
EMBED_SIZES = tuple(16 + (496 * i) // (EMBED_TEXTS - 1) for i in range(EMBED_TEXTS))
EMBED_DUPLICATE = (15, 16)  # text 16 is a copy of text 15
# each embedding (a unit vector) against an f32 reference computed on the
# card: ||bf16 - f32|| at most MODEL_REL_TOL (the 5% of every model check),
# stated before the phase's first run
EMBED_TOL = MODEL_REL_TOL
# the batch embedded while the engine captures and serves, against the
# same batch embedded with the engine idle: max |a - b|
EMBED_CONCURRENT_TOL = 1e-6
# the local-vector store: seeded rows of llama-3-8b's width, f32
VECTOR_ROWS, VECTOR_QUERIES = 262_144, 64
# a top-k list may hold two neighbours in the other order than the numpy
# f64 reference's only where the reference's scores of the two rows lie
# within this: an f32 product of two unit vectors of 4096 elements rounds
# at ~1e-9, so a gap this small is a tie the f32 product cannot order
VECTOR_TIE = 1e-7
E2E_BYTES = [20, 90, 150, 300, 600, 900, 1200, 1500]


def _embed_texts(seed: int) -> list[str]:
    """EMBED_SIZES tokens each with the byte tokenizer's BOS (n - 1 bytes)."""
    texts = _prompts([n - 1 for n in EMBED_SIZES], seed + 7)
    a, b = EMBED_DUPLICATE
    texts[b] = texts[a]
    return texts


def _encode_flops(cfg, params, lengths: list) -> float:
    """The operations of ``encode`` over rows of ``lengths`` tokens: two a
    layer weight and token, and the attention's 4 x S^2 x H x D a row and
    layer (the embedding lookup and the norms not counted)."""
    layer_weights = sum(v.numel() for v in params["layers"].values()
                        if v.dim() > 2)  # the projections, not the norms
    attn = 4.0 * sum(n * n for n in lengths) * cfg.n_heads * cfg.resolved_head_dim
    return 2.0 * layer_weights * sum(lengths) + attn * cfg.n_layers


def _encode_f32(torch, params, tokens, lengths, cfg):
    """``encode`` in f32 on the card, each layer's weights widened to f32
    just before its use (the reference the bf16 embeddings are held to)."""
    from langstream_tpu_torch.models import transformer as tf

    c32 = dataclasses.replace(cfg, dtype="float32", attention_impl="jnp")
    b, s = tokens.shape
    positions = torch.arange(s, device="cuda").expand(b, s)
    sin, cos = tf._rope_freqs(positions, c32)
    valid = positions < lengths.long()[:, None]
    mask = valid[:, None, :] & valid[:, :, None]
    x = tf._embed(params, tokens, cfg).float()
    for i in range(c32.n_layers):
        lp = {k: v[i].float() for k, v in params["layers"].items()}
        x = tf._layer(x, lp, sin, cos, mask, c32, causal=False)
        del lp
    x = tf.rms_norm(x, params["final_norm"].float(), c32.rms_norm_eps)
    w = valid[:, :, None].float()
    pooled = (x * w).sum(1) / w.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


def _attention_yardstick(torch, ctx, cfg, timer) -> dict:
    """One layer's bidirectional attention at the batch's shape (32 x 512,
    random q/k/v, the batch's lengths): the port's ``attention`` (what
    ``encode`` runs) beside SDPA with a key-padding mask — a yardstick,
    not a path of the port."""
    import torch.nn.functional as F

    from langstream_tpu_torch.models import transformer as tf

    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 71)
    b, s = EMBED_TEXTS, max(EMBED_SIZES)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor(EMBED_SIZES, device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    mask = valid[:, None, :] & valid[:, :, None]
    port_ms = timer.ms(lambda: tf.attention(q, k, v, mask, cfg), iters=5)
    ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    qh = q.transpose(1, 2)
    sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        qh, ke, ve, attn_mask=valid[:, None, None, :]), iters=5)
    flops = 4.0 * b * s * s * h * d
    return {"port_attention_ms": port_ms, "sdpa_key_padding_ms": sdpa_ms,
            "operations_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}


def _ranked_rows(np, scores, k: int):
    """The reference top-k of each row of ``scores`` [Q, N]: by score
    descending, the lower row first among equal scores (``lax.top_k``)."""
    out = []
    for row in scores:
        cand = np.argpartition(-row, k)[: k + 8]
        order = np.lexsort((cand, -row[cand]))[:k]
        out.append(cand[order])
    return out


def _vector_store_check(torch, ctx, vectors) -> dict:
    """The local-vector store on the card: VECTOR_ROWS seeded rows of
    4096 f32 plus the 32 embeddings, searched by the 32 embeddings and 32
    seeded queries at top-k 5 and 64. Each list is held to a plain f64
    reference's (a matmul on the card; equal, but for neighbours within VECTOR_TIE); each
    embedded text ranks its own row first (a duplicate text: tied for
    first); the search's device time and wall a query beside the byte
    bound of one read of the rows."""
    import numpy as np

    from langstream_tpu_torch.agents.vector import LocalVectorDataSource

    dim = vectors.shape[1]
    rng = np.random.default_rng(ctx["seed"] + 11)
    t0 = time.monotonic()
    # the rows drawn on the card from the seed and read back (numpy's
    # generator spends ~20 s of one host core on these 1.07 G values)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 11)
    data = torch.randn((VECTOR_ROWS, dim), generator=g, device="cuda").cpu().numpy()
    gen_s = time.monotonic() - t0
    store = LocalVectorDataSource({})
    t0 = time.monotonic()
    store.upsert_many("docs", [f"doc-{i}" for i in range(VECTOR_ROWS)], data,
                      [{"chunk": i} for i in range(VECTOR_ROWS)])
    store.upsert_many("docs", [f"text-{i}" for i in range(len(vectors))], vectors,
                      [{"text": i} for i in range(len(vectors))])
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    idx = store._indexes["docs"]
    n = len(idx["ids"])
    queries = np.concatenate([vectors, rng.standard_normal((VECTOR_QUERIES - len(vectors), dim),
                                                           dtype=np.float32)])
    # the f64 reference over the same rows (the store's host copy): a plain
    # f64 matmul on the card, not the store's search
    t0 = time.monotonic()
    qn = torch.from_numpy(queries).cuda().double()
    qn /= qn.norm(dim=1, keepdim=True) + 1e-9
    scores = torch.empty((len(queries), n), dtype=torch.float64, device="cuda")
    for a in range(0, n, 32768):
        blk = torch.from_numpy(idx["matrix"][a:min(a + 32768, n)]).cuda().double()
        blk /= blk.norm(dim=1, keepdim=True) + 1e-9
        scores[:, a:a + len(blk)] = qn @ blk.T
    scores = scores.cpu().numpy()
    del qn, blk
    ref_s = time.monotonic() - t0
    rec = {"rows": n, "dim": dim, "capacity": idx["matrix"].shape[0],
           "device_copy_bytes": idx["dev"].numel() * 4, "valid_bytes": n * dim * 4,
           "generate_s": gen_s, "upsert_s": load_s, "f64_reference_s": ref_s}
    bound_ms = n * dim * 4 / HBM_BYTES_PER_S * 1e3
    for k in (5, 64):
        want = _ranked_rows(np, scores, k)
        t0 = time.monotonic()
        results = [store.search("docs", q.tolist(), k) for q in queries]
        wall_ms = (time.monotonic() - t0) * 1e3 / len(queries)
        swaps = []
        for qi, (res, ref) in enumerate(zip(results, want)):
            got = [idx["pos"][r["id"]] for r in res]
            if len(got) != k:
                raise AssertionError(f"top-{k} of query {qi}: {len(got)} results")
            for j, (a, b) in enumerate(zip(got, ref.tolist())):
                if a != b:
                    gap = abs(scores[qi, a] - scores[qi, b])
                    swaps.append({"query": qi, "rank": j, "f64_gap": gap})
                    if gap > VECTOR_TIE:
                        raise AssertionError(f"top-{k} of query {qi} rank {j}: row {a} vs the "
                                             f"f64 reference's {b} (gap {gap})")
        for i in range(len(vectors)):
            own = n - len(vectors) + i
            first = idx["pos"][results[i][0]["id"]]
            if first != own and scores[i, first] != scores[i, own]:
                raise AssertionError(f"text {i} ranks row {first} first, not its own {own}")
        q_dev = torch.from_numpy(queries).cuda()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for q in q_dev:
            store._search(q, idx["dev"][:n], None, k, normalized=True)
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / len(queries)
        rec[f"top{k}"] = {"device_ms_per_query": device_ms, "wall_ms_per_query": wall_ms,
                          "bound_ms": bound_ms, "bound_share": bound_ms / device_ms,
                          "swapped_ties": swaps}
    del store, data, scores
    return rec


def _served_tokens(engine, prompts, opts) -> list:
    """The prompts served as one wave: the engine thread paused while all
    are queued (one admission whatever the timing), then resumed."""
    from langstream_tpu_torch.serving.engine import GenerationRequest

    _pause(engine)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts]
    engine.start()
    return [r.result(timeout=900).tokens for r in reqs]


def phase_embed(ctx: dict) -> None:
    """RAG on the card (module docstring, phase 13): the provider's
    embeddings service over llama-3-8b, the local-vector store's top-k, and
    an embedding batch run while the provider's engine captures and
    serves."""
    import asyncio
    import gc
    import threading

    import numpy as np
    import torch

    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    # the provider draws the tree itself from the seed, at SHALLOW_LAYERS
    # (nothing the phase checks depends on depth); a later phase draws the
    # 32-layer tree again
    cfg = MODEL_PRESETS[_shallow_model()]
    ctx.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    provider = TorchServingProvider({
        "model": cfg.name, "seed": ctx["seed"], "max-seq-len": 2048, "max-batch": 8,
        "decode-chunk": 16, "page-size": PAGE,
    })
    holder = provider.get_completions_service({})
    svc = provider.get_embeddings_service({})  # max-text-tokens 512
    t0 = time.monotonic()
    params = holder.params()
    log(f"embed: {cfg.name} drawn by the provider in {time.monotonic() - t0:.1f}s")
    texts = _embed_texts(ctx["seed"])
    tokens, lengths = svc.batch(texts)
    sizes = list(EMBED_SIZES)
    sizes[EMBED_DUPLICATE[1]] = sizes[EMBED_DUPLICATE[0]]
    if tokens.shape != (EMBED_TEXTS, 512) or lengths.tolist() != sizes:
        raise AssertionError(f"embed batch {tokens.shape}, lengths {lengths.tolist()}")
    idle = svc.embed(texts)  # the first call, then timed ones
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        svc.embed(texts)
        walls.append((time.monotonic() - t0) * 1e3)
    tok_t, len_t = torch.from_numpy(tokens).cuda(), torch.from_numpy(lengths).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    device_ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = tf.encode(params, tok_t, len_t, cfg)
        end.record()
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
    growth = torch.cuda.max_memory_allocated() - base
    stream_diff = float(np.abs(out.cpu().numpy() - idle).max())
    if stream_diff > EMBED_CONCURRENT_TOL:
        raise AssertionError(f"embed: the service's vectors (its own stream) differ from "
                             f"encode's on the default stream by {stream_diff}")
    ref = _encode_f32(torch, params, tok_t, len_t, cfg).cpu().numpy()
    err = np.linalg.norm(idle - ref, axis=1)
    cos = (idle * ref).sum(1) / np.linalg.norm(ref, axis=1)
    norms = np.linalg.norm(idle, axis=1)
    a, b = EMBED_DUPLICATE
    dup = float(np.abs(idle[a] - idle[b]).max())
    rec = {
        "texts": EMBED_TEXTS, "tokens": int(lengths.sum()), "padded_tokens": int(tokens.size),
        "wall_ms_per_call": walls, "device_ms_per_call": device_ms,
        "peak_growth_bytes": growth,
        # 2 x the layers' weights x tokens, plus the attention's 4 x S x S
        # x H x D a row and layer, at the bf16 peak: over the padded batch
        # (the work the call does) and over the real tokens
        "flop_bound_ms_padded": _encode_flops(cfg, params, [tokens.shape[1]] * len(texts))
        / PEAK_BF16_FLOPS * 1e3,
        "flop_bound_ms_real": _encode_flops(cfg, params, lengths.tolist())
        / PEAK_BF16_FLOPS * 1e3,
        "f32_max_l2_err": float(err.max()), "f32_min_cosine": float(cos.min()),
        "tolerance_l2": EMBED_TOL, "max_norm_err": float(np.abs(norms - 1).max()),
        "duplicate_max_abs_diff": dup, "duplicate_bit_equal": dup == 0.0,
        "service_stream_vs_default_stream_max_abs_diff": stream_diff,
    }
    if err.max() > EMBED_TOL or np.abs(norms - 1).max() > 1e-5 or dup > 1e-6:
        raise AssertionError(f"embed: {rec}")
    timer = Timer(torch)
    rec["one_layer_attention"] = _attention_yardstick(torch, ctx, cfg, timer)
    del timer, out, tok_t, len_t
    log(f"embed {cfg.name} bf16 {json.dumps(rec)}")
    store = _vector_store_check(torch, ctx, idle)
    log(f"embed local-vector store {json.dumps(store)}")
    gc.collect()
    torch.cuda.empty_cache()
    # one batch again and again on the service's thread while the engine
    # of the same provider captures its graphs, then serves the e2e burst
    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts(E2E_BYTES, ctx["seed"])]
    opts = GenerationOptions(max_new_tokens=64, temperature=0.0)
    runs: list = []
    started, done = threading.Event(), threading.Event()

    def embed_loop():
        while not done.is_set():
            t0 = time.monotonic()
            vectors = svc.embed(texts)
            runs.append((t0, time.monotonic(), vectors))
            started.set()

    thread = threading.Thread(target=embed_loop, name="embed-loop")
    thread.start()
    started.wait(600)
    t_build = time.monotonic()
    engine = holder.engine()  # built and captured now, beside the embeddings
    t_captured = time.monotonic()
    reset_kernel_counts()
    served = _served_tokens(engine, prompts, opts)
    t_served = time.monotonic()
    counts = kernel_counts()
    done.set()
    thread.join(600)
    quiet = _served_tokens(engine, prompts, opts)
    asyncio.run(provider.close())
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"embed: plain versions ran while serving: {plain}")
    overlap = {
        "during_capture": sum(1 for s, e, _ in runs if s < t_captured and e > t_build),
        "during_serving": sum(1 for s, e, _ in runs if s < t_served and e > t_captured),
    }
    diffs = [float(np.abs(v - idle).max()) for s, e, v in runs if s < t_served and e > t_build]
    conc = {"batches": len(runs), **overlap,
            # each batch's wall and its start from the engine's build
            "batch_s": [[round(s - t_build, 3), round(e - s, 3)] for s, e, _ in runs],
            "max_abs_diff": max(diffs, default=None),
            "bit_equal": all(d == 0.0 for d in diffs), "tolerance": EMBED_CONCURRENT_TOL,
            "tokens_equal": served == quiet, "capture_s": t_captured - t_build,
            "launches": {k: v["launches"] for k, v in counts.items() if v["launches"]}}
    log(f"embed concurrent with the engine {json.dumps(conc)}")
    if not overlap["during_capture"] or not overlap["during_serving"]:
        raise AssertionError(f"embed: no batch overlapped the capture and the serving: {conc}")
    if max(diffs) > EMBED_CONCURRENT_TOL or served != quiet:
        raise AssertionError(f"embed: concurrent vectors or tokens changed: {conc}")
    ctx["embed"] = {**rec, "store": store, "concurrent": conc}


def _dense_verify_model_check(ctx, cfg, params, prompts) -> dict:
    """The dense verify's kernel path (the flattened queries through the
    dense decode kernel) against its reference path on the same cache:
    the prompts prefilled into a [8, ..., 8193] cache (one copy a path),
    then one verify of each row's last prompt token and the 4 tokens its
    repetition continues with — logits within MODEL_REL_TOL of the largest
    reference logit; a position whose top-1 differs passes only as a tie
    within one bf16 ulp each way (the spec phase's rule), at most 1 in 8."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    k = SPEC_KW["speculation_tokens"]
    ref_cfg = dataclasses.replace(cfg, attention_impl="jnp")
    b, n = len(prompts), SPEC_PROMPT
    t = DENSE_KW["max_seq_len"]
    tokens = torch.tensor(prompts, dtype=torch.long, device="cuda")
    local = tf.make_kv_cache(cfg, b, n, device="cuda")
    tf.prefill(params, tokens, torch.full((b,), n, device="cuda"), local, cfg)
    cache = tf.make_kv_cache(cfg, b, t + 1, device="cuda")
    tf.dense_insert_cache(cache, local, torch.arange(b, device="cuda"))
    del local
    ref_cache = {name: cache[name].clone() for name in ("k", "v")}
    inputs = torch.stack([torch.tensor(p[n - 1:n] + [p[n - 24 + j] for j in range(k)])
                          for p in prompts]).to("cuda")
    positions = torch.full((b,), n - 1, dtype=torch.long, device="cuda")
    kernel = tf.verify_step_inplace(params, inputs, positions, cache, cfg, t)[0]
    reference = tf.verify_step_inplace(params, inputs, positions, ref_cache, ref_cfg, t)[0]
    del cache, ref_cache
    rels, ties, flips = [], [], []
    for row in range(b):
        for j in range(k + 1):
            a, r = kernel[row, j].float(), reference[row, j].float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"dense verify row {row} position {j}: non-finite logits")
            rels.append(((a - r).abs().max() / r.abs().max()).item())
            got, top = int(torch.argmax(a)), int(torch.argmax(r))
            if got == top:
                continue
            tie = ((r[top] - r[got]).item() <= _bf16_ulp(r[top].item())
                   and (a[got] - a[top]).item() <= _bf16_ulp(a[got].item()))
            (ties if tie else flips).append({"row": row, "position": j, "kernel": got,
                                             "reference": top})
    rec = {"max_rel_err": max(rels), "tolerance": MODEL_REL_TOL, "ties": ties, "flips": flips}
    if max(rels) > MODEL_REL_TOL or flips or 8 * len(ties) > b * (k + 1):
        raise AssertionError(f"dense verify model check: {rec}")
    return rec


def _dense_constrained_and_level2(ctx, cfg, params, prompts, off_tokens) -> dict:
    """A speculative dense engine with brownout on (both graph sets
    captured): two requests with a JSON-schema response format served
    with speculation, each output in its grammar; then brownout pinned at level
    2 (the dwell never elapses) and the spec prompts served by the decode
    set — no verify, one replay a chunk, dense decode launches exactly
    layers x steps — their tokens the speculation-off run's or ties."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = ServingEngine(cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
                           eos_token_id=tok.eos_token_id, rng_seed=ctx["seed"], device="cuda",
                           speculation="auto", speculation_tokens=SPEC_KW["speculation_tokens"],
                           brownout_dwell_s=1e9, grammar_tokenizer=tok, **DENSE_KW)
    engine.start()
    try:
        outputs = []
        for name, text in (("record", "Reply with a JSON record for the order: "),
                           ("record", "Describe the last shipment as JSON: ")):
            rf = AGENTIC_FORMATS[name]
            res = engine.submit(GenerationRequest(
                prompt_tokens=tok.encode(text),
                options=GenerationOptions(max_new_tokens=64, response_format=rf),
            )).result(timeout=600)
            out = tok.decode(res.tokens)
            outputs.append({"format": name, "text": out, "finish": res.finish_reason,
                            "in_grammar": _in_grammar(rf, out)})
        stats = engine.stats()
        engine._brownout.level = 2
        before = engine.stats()
        reset_kernel_counts()
        level2 = _served_tokens(engine, prompts, GenerationOptions(max_new_tokens=SPEC_NEW))
        counts = kernel_counts()
        after = engine.stats()
    finally:
        engine.stop()
    rec = {
        "graph_sets": stats["graph-sets"], "constrained": outputs,
        "spec_verifies_constrained": stats["spec-verify-dispatches-total"],
        "level2_verifies": after["spec-verify-dispatches-total"]
        - before["spec-verify-dispatches-total"],
        "level2_decode_chunks": after["decode-chunks-total"] - before["decode-chunks-total"],
        "level2_decode_steps": after["decode-steps-total"] - before["decode-steps-total"],
        "level2_decode_replays": after["graph-replays-by-kind"]["decode"]
        - before["graph-replays-by-kind"]["decode"],
        "level2_dense_decode_launches": counts["dense_decode"]["launches"],
    }
    if sorted(stats["graph-sets"]) != ["decode", "verify"] or not rec["spec_verifies_constrained"]:
        raise AssertionError(f"dense tiers: both graph sets and verifies expected: {rec}")
    if not all(o["in_grammar"] and o["finish"] == "stop" for o in outputs):
        raise AssertionError(f"dense tiers: a constrained output does not parse: {outputs}")
    if (rec["level2_verifies"] or not rec["level2_decode_chunks"]
            or rec["level2_decode_replays"] != rec["level2_decode_chunks"]
            or rec["level2_dense_decode_launches"] != cfg.n_layers * rec["level2_decode_steps"]):
        raise AssertionError(f"dense tiers: brownout level 2: {rec}")
    rec["level2_vs_off"] = _same_or_tie(ctx, cfg, params, "dense level 2 vs off", prompts,
                                        level2, off_tokens)
    if not rec["level2_vs_off"]["ok"]:
        raise AssertionError(f"dense tiers: level 2 tokens: {rec['level2_vs_off']}")
    return rec


def _require_dense_prefix_run(run: dict, cfg, segment: str) -> None:
    """Every one of the 8 requests a warm hit at the preamble: one suffix
    segment a layer each (``segment``: the segment kernel of the KV type),
    the preamble's tokens saved each; request 0 alone took the cold group's
    prefill kernel; dense decode launches exactly layers x steps; the
    pool's rows as allocated equal the plan's term."""
    hits = len(PREFIX_TURNS)
    if run["warm_admissions"] != hits or run["prefill_tokens_saved"] != hits * PREFIX_PREAMBLE:
        raise AssertionError(f"dense prefix: {run['warm_admissions']} warm admissions, "
                             f"{run['prefill_tokens_saved']} tokens saved")
    if run["kernel_launches"][segment] != cfg.n_layers * hits:
        raise AssertionError(f"dense prefix: {run['kernel_launches'][segment]} {segment} "
                             f"launches != {cfg.n_layers} x {hits}")
    if run["plan_prefix_pool_bytes"] != run["prefix_pool_allocated_bytes"]:
        raise AssertionError(f"dense prefix: pool {run['prefix_pool_allocated_bytes']} bytes "
                             f"vs the plan's {run['plan_prefix_pool_bytes']}")
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    decode = "dense_decode_int8" if segment.endswith("int8") else "dense_decode"
    _require_launches(run, decode, "decode_steps", cfg.n_layers)


def phase_dense_tiers(ctx: dict) -> None:
    """The rest of the dense layout at llama-3-8b's full width and
    SHALLOW_LAYERS of its depth (module docstring, phase 14): speculation (the spec traffic on and off,
    the verify's model check, two constrained requests, brownout pinned at
    level 2) and prefix reuse (the prefix traffic on and off, bf16 and int8
    KV)."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    prompts = _spec_prompts(ctx["seed"])
    spec = {"speculation_tokens": SPEC_KW["speculation_tokens"], **DENSE_KW}
    on = _serve(ctx, cfg, params, [], SPEC_NEW, prompts=prompts, steady=True,
                speculation="auto", **spec)
    if on["decode_chunks"] != 0:
        raise AssertionError(f"dense spec: {on['decode_chunks']} decode chunks beside verifies")
    _require_launches(on, "dense_decode", "verify_dispatches", cfg.n_layers)
    _require_launches(on, "flash_prefill", "admit_groups", cfg.n_layers)
    off = _serve(ctx, cfg, params, [], SPEC_NEW, prompts=prompts, steady=True, **DENSE_KW)
    _require_launches(off, "dense_decode", "decode_steps", cfg.n_layers)
    same = _same_or_tie(ctx, cfg, params, "dense spec on vs off", prompts, on["_tokens"],
                        off["_tokens"])
    for label, run in (("on", on), ("off", off)):
        log(f"dense spec {label} llama-3-8b bf16 "
            f"{json.dumps({k: v for k, v in run.items() if not k.startswith('_')})}")
    verify, decode = on["steady_replays"], off["steady_replays"]
    summary = {
        "tokens_per_s_on": on["tokens_per_s"], "tokens_per_s_off": off["tokens_per_s"],
        "verify_step_device_ms": verify["device_ms_per_step"],
        "verify_step_wall_ms": verify["wall_ms_per_step"],
        "decode_step_device_ms": decode["device_ms_per_step"],
        "decode_step_wall_ms": decode["wall_ms_per_step"],
        "acceptance_rate": on["spec_acceptance_rate"],
        "accepted_tokens_per_step": on["spec_accepted_tokens_per_step"],
        "verify_dispatches": on["verify_dispatches"],
        "dense_decode_launches": on["kernel_launches"]["dense_decode"],
        "graph_replays": on["graph_replays"],
        "tokens_on_vs_off": same,
    }
    log(f"dense spec summary {json.dumps(summary)}")
    if not same["ok"]:
        raise AssertionError(f"dense spec: tokens on vs off: {same}")
    check = _dense_verify_model_check(ctx, cfg, params, prompts)
    log(f"dense verify model check {json.dumps(check)}")
    tiers = _dense_constrained_and_level2(ctx, cfg, params, prompts, off["_tokens"])
    log(f"dense constrained and brownout level 2 {json.dumps(tiers)}")
    prefix = {}
    for kv in ("model", "int8"):
        c = cfg if kv == "model" else dataclasses.replace(cfg, kv_cache_dtype="int8")
        segment = "flash_segment_int8" if kv == "int8" else "flash_segment"
        warm = _serve_prefix(ctx, c, params, prefix=True, **DENSE_KW)
        _require_dense_prefix_run(warm, c, segment)
        cold = _serve_prefix(ctx, c, params, prefix=False, **DENSE_KW)
        held = [warm["prompt_tokens"][1], warm["prompt_tokens"][-1]]
        check = _warm_vs_cold(warm["_logits"], cold["_logits"], held)
        for label, run in (("on", warm), ("off", cold)):
            log(f"dense prefix {kv} {label} llama-3-8b "
                f"{json.dumps({k: v for k, v in run.items() if not k.startswith('_')})}")
        log(f"dense prefix {kv} warm vs cold logits {json.dumps(check)}")
        prefix[kv] = {k: v for k, v in warm.items() if not k.startswith("_")}
    ctx["dense_tiers"] = {"spec": summary, "prefix": prefix}
    ctx["dense_spec"] = {k: v for k, v in on.items() if not k.startswith("_")}
    ctx["dense_prefix"], ctx["dense_prefix_int8"] = prefix["model"], prefix["int8"]


# llama-3-8b's widths at 4 layers (3.85 GB): the depth is cut for the
# run's time; the shard size is the published checkpoint's
LOAD_MODEL = "llama-3-8b-shallow"
LOAD_SHARD_BYTES = 5 * 10**9
LOAD_INT8_NEW = 16
LOAD_SERVE_KW = {"max-seq-len": 2048, "max-batch": 8, "decode-chunk": 16, "page-size": PAGE}


def _sequential_read(files) -> dict:
    """The plain read bound: every shard read front to back in 256 MiB
    pieces into one reused buffer."""
    buf = bytearray(256 * 2**20)
    view = memoryview(buf)
    total = 0
    t0 = time.monotonic()
    for f in files:
        with open(f, "rb", buffering=0) as fh:
            while True:
                n = fh.readinto(view)
                if not n:
                    break
                total += n
    s = time.monotonic() - t0
    return {"bytes": total, "s": s, "gb_per_s": total / s / 1e9}


def _pinned_copy(torch, nbytes: int = 2**30) -> dict:
    """The host-to-device bound: one pinned copy of ``nbytes`` (1 GiB;
    median of 5)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dev.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    s = sorted(times)[2]
    del host, dev
    return {"bytes": nbytes, "s": s, "gb_per_s": nbytes / s / 1e9}


def _trees_equal(torch, label: str, got, want) -> None:
    """Leaf by leaf, same dtype, shape and bits."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _trees_equal(torch, f"{label}.{k}", got[k], want[k])
        return
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: differs ({got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)})")


def _report_line(report, gb: float) -> dict:
    rep = report.as_dict()
    keys = ("total-s", "read-s", "transform-s", "transfer-s", "staging-peak-bytes", "shards",
            "workers", "tensors", "bytes-read")
    out = {k: rep.get(k) for k in keys}
    out["setup-s"] = report.setup_s
    out["staging-alloc-s"] = report.staging_alloc_s
    out["gb_per_s"] = gb / rep["total-s"]
    return out


def _served_from_disk(ctx, cfg, path, params, prompts, quantize: bool, new_tokens: int) -> dict:
    """The provider with ``weights: <path>`` (streamed; with ``quantize``
    int8 on load): the cold start from its construction to the first
    token, split into load, engine build and graph capture; the memory
    plan beside the loaded weights' allocation and the engine's own peak
    (the weights term exact against the config's meta tree, the pool term
    against the pool built); the e2e
    requests served one after another, against an engine over ``params``
    (the in-memory tree, or its ``quantize_params``) served the same way:
    the same tokens, the kernels' launches required."""
    import gc

    import torch

    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.models.loader import expected_params
    from langstream_tpu_torch.serving.engine import GenerationRequest
    from langstream_tpu_torch.serving.memory import tree_bytes
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    resource = {"model": cfg.name, "weights": str(path), "seed": ctx["seed"], **LOAD_SERVE_KW,
                **({"quantization": "int8"} if quantize else {})}
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    svc = TorchCompletionsService(resource)
    loaded = svc.params()
    t_load = time.monotonic() - t0
    # the engine's own peak: measured from here, after the load's copies
    # and its transient buffers are gone, so the load's peak is not in it
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()  # also frees the load's blocks held for its stream
    weights_allocated = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    loaded_base = torch.cuda.memory_allocated()
    reserved_base = torch.cuda.memory_reserved()
    t1 = time.monotonic()
    engine = svc.engine()
    t_engine = time.monotonic() - t1
    engine_peak = torch.cuda.max_memory_allocated() - loaded_base
    capture_s = engine.stats()["graph-capture-s"]
    first = []
    req = GenerationRequest(prompt_tokens=ByteTokenizer().encode("warm up"),
                            options=GenerationOptions(max_new_tokens=4),
                            on_token=lambda _: first or first.append(time.monotonic()))
    engine.submit(req).result(timeout=600)
    # through the first admission too (int8: its eager widened weights),
    # and what the allocator holds (the graph pool's blocks stay reserved)
    served_peak = torch.cuda.max_memory_allocated() - loaded_base
    served_reserved = torch.cuda.max_memory_reserved() - reserved_base
    plan = engine.memory_plan
    # the weights term against the tree the config serves (meta tensors,
    # counted apart from the plan), the pool term against the pool built
    weights = tree_bytes(expected_params(cfg, quantized=quantize))
    pool = engine._pagepool.bytes_total
    if plan.weights_bytes != weights or plan.page_pool_bytes != pool:
        raise AssertionError(f"memory plan: weights {plan.weights_bytes} vs {weights}, "
                             f"pool {plan.page_pool_bytes} vs {pool}")
    cold = {
        "load_s": t_load,
        "engine_build_s": t_engine - capture_s,
        "graph_capture_s": capture_s,
        "first_token_s": first[0] - t0,
        "weight_load": engine.stats()["weight-load-s"],
        "plan_total_bytes": plan.total_bytes,
        "plan_weights_bytes": plan.weights_bytes,
        "plan_page_pool_bytes": plan.page_pool_bytes,
        "plan_beyond_weights_bytes": plan.total_bytes - plan.weights_bytes,
        "plan_summary": plan.summary(),
        "weights_allocated_bytes": weights_allocated,
        "engine_peak_bytes": engine_peak,
        "weights_plus_engine_peak_bytes": weights_allocated + engine_peak,
        "served_peak_bytes": served_peak,
        "served_reserved_growth_bytes": served_reserved,
        "plan_graph_pool_bytes": plan.graph_pool_bytes,
        "plan_eager_widened_bytes": plan.eager_widened_bytes,
        "graph_pool_bytes": engine.stats()["graph-pool-bytes"],
    }
    # the plan covers the engine (F4: the int8 path's widened weights in
    # the graph pool and on the eager path)
    for key in ("engine_peak_bytes", "served_peak_bytes", "served_reserved_growth_bytes"):
        if weights_allocated + cold[key] > plan.total_bytes:
            raise AssertionError(f"memory plan: weights {weights_allocated} + {key} {cold[key]} "
                                 f"pass the plan's {plan.total_bytes} ({plan.summary()})")
    try:
        run = _serve(ctx, cfg, None, [], new_tokens, prompts=prompts, engine=engine,
                     sequential=True)
        stats = engine.stats()
    finally:
        svc.close()
    run["weight_load"] = {k: v for k, v in stats.items() if k.startswith("weight-load")}
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    del svc, engine, loaded
    gc.collect()
    torch.cuda.empty_cache()
    ref = _serve(ctx, cfg, params, [], new_tokens, prompts=prompts, sequential=True,
                 max_seq_len=LOAD_SERVE_KW["max-seq-len"])
    if run["_tokens"] != ref["_tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(run["_tokens"], ref["_tokens"])) if a != b]
        raise AssertionError(f"served from disk: requests {diff} differ from the in-memory tree")
    run["cold_start"] = cold
    run["reference_tokens_per_s"] = ref["tokens_per_s"]
    return run


def phase_load(ctx: dict) -> None:
    """Serve a safetensors checkpoint: write ``LOAD_MODEL`` (the seeded
    tree) in shards of at most 5 GB, load it streamed (twice) and eagerly
    (each bit-equal to the written tree) beside the read and copy bounds,
    load it int8 on load (bit-equal to ``quantize_params``, the device peak
    beside the int8 tree plus one bf16 layer), serve it through the
    provider (bf16 and int8 on load, token-exact against the in-memory
    trees), and refuse a truncated shard and an injected read fault."""
    import gc
    import os
    import shutil

    import torch

    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.loader import load_params, save_params_hf
    from langstream_tpu_torch.models.quant import quantize_params
    from langstream_tpu_torch.models.streamload import (
        ShardIndex,
        WeightLoadError,
        load_params_streamed,
    )
    from langstream_tpu_torch.serving.memory import tree_bytes
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    root = ROOT / "build" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ctx.pop("params", None)  # the card holds one llama tree at a time
    usage = shutil.disk_usage(root)
    log(f"load: checkpoint under {root}: {usage.free / 2**30:.1f} GiB free of "
        f"{usage.total / 2**30:.1f} GiB; {LOAD_MODEL}")
    cfg = MODEL_PRESETS[LOAD_MODEL]
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"])
    params = init_params(cfg, g, device="cuda")
    path = root / cfg.name
    nbytes = tree_bytes(params)
    t0 = time.monotonic()
    save_params_hf(params, cfg, path, max_shard_bytes=LOAD_SHARD_BYTES)
    files = sorted(path.glob("*.safetensors"))
    write_s = time.monotonic() - t0
    log(f"load write {cfg.name}: " + json.dumps({
        "bytes": nbytes, "shards": [f.stat().st_size for f in files], "s": write_s,
        "gb_per_s": nbytes / write_s / 1e9}))
    gb = nbytes / 1e9
    loads = {}
    # the shards were just written, so every read here may come from the
    # host's page cache: "first" and "again" are two loads, not a cold and
    # a warm one
    for label in ("streamed_first", "streamed_again"):
        torch.cuda.synchronize()
        tree, rep = load_params_streamed(path, cfg, workers=4, device="cuda")
        _trees_equal(torch, f"{label} {cfg.name}", tree, params)
        loads[label] = _report_line(rep, gb)
        del tree
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    tree = load_params(path, cfg, device="cuda")
    torch.cuda.synchronize()
    eager_s = time.monotonic() - t0
    _trees_equal(torch, f"eager {cfg.name}", tree, params)
    loads["eager"] = {"total-s": eager_s, "read-s": None, "transform-s": None,
                      "transfer-s": None, "staging-peak-bytes": None, "gb_per_s": gb / eager_s}
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    bounds = {"sequential_read": _sequential_read(files), "pinned_h2d_1gib": _pinned_copy(torch)}
    log(f"load {cfg.name} bf16 (4 workers; each tree torch.equal to the written one) "
        + json.dumps({"loads": loads, "bounds": bounds}))

    # int8 on load: the device's peak over the load against the int8 tree
    # plus one bf16 layer, then bit-equal to quantize_params on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qtree, rep = load_params_streamed(path, cfg, workers=4, quantize=True, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    layer = sum(tree_bytes(v) for v in params["layers"].values()) // cfg.n_layers
    want = quantize_params(params, cfg)
    _trees_equal(torch, f"int8 on load {cfg.name}", qtree, want)
    log(f"load {cfg.name} int8 on load (bit-equal to quantize_params) " + json.dumps({
        **_report_line(rep, gb), "device_peak_bytes": peak,
        "int8_tree_bytes": tree_bytes(qtree), "bf16_layer_bytes": layer,
        "int8_tree_plus_one_layer": tree_bytes(qtree) + layer}))
    del qtree
    gc.collect()
    torch.cuda.empty_cache()

    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts([20, 90, 150, 300, 600, 900, 1200, 1500],
                                               ctx["seed"])]
    run = _served_from_disk(ctx, cfg, path, params, prompts, quantize=False, new_tokens=64)
    log(f"load served {cfg.name} bf16 from disk "
        f"{json.dumps({k: v for k, v in run.items() if not k.startswith('_')})}")
    ctx["load"] = {k: v for k, v in run.items() if not k.startswith("_")}
    # 16 new tokens, not 64: the int8 weight path dequantizes every weight
    # at every matmul (~70 ms a decode step), and these are served one
    # request at a time
    run8 = _served_from_disk(ctx, cfg, path, want, prompts, quantize=True,
                             new_tokens=LOAD_INT8_NEW)
    log(f"load served {cfg.name} int8 on load from disk "
        f"{json.dumps({k: v for k, v in run8.items() if not k.startswith('_')})}")
    del want
    gc.collect()
    torch.cuda.empty_cache()

    # faults: a copy of the last shard one byte short (the others linked)
    # refused when the index is built, before any upload; an injected read
    # fault through the provider leaves nothing behind
    bad = root / "truncated"
    bad.mkdir()
    for f in files[:-1]:
        os.symlink(f, bad / f.name)
    with open(files[-1], "rb") as src, open(bad / files[-1].name, "wb") as dst:
        shutil.copyfileobj(src, dst, 64 * 2**20)
        dst.truncate(files[-1].stat().st_size - 1)
    before = torch.cuda.memory_allocated()
    for attempt in (lambda: ShardIndex(bad),
                    lambda: load_params_streamed(bad, cfg, device="cuda")):
        try:
            attempt()
        except WeightLoadError as e:
            msg = str(e)
            if files[-1].name not in msg or "tensor '" not in msg:
                raise AssertionError(f"truncated shard: message names no shard / tensor: {msg}")
        else:
            raise AssertionError("a shard one byte short was not refused")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("the truncated checkpoint uploaded before it was refused")
    svc = TorchCompletionsService({"model": cfg.name, "weights": str(path), **LOAD_SERVE_KW,
                                   "fault-injection": "weight-load@1", "fault-seed": 0})
    try:
        svc.engine()
    except WeightLoadError as e:
        injected = str(e)
    else:
        raise AssertionError("weight-load@1 did not fire")
    fired = svc._fault_injector().stats()
    if svc._engine is not None or svc._params is not None or fired != {"weight-load": 1}:
        raise AssertionError(f"weight-load@1 left engine {svc._engine}, params "
                             f"{svc._params is not None}, fired {fired}")
    log(f"load faults: truncated shard refused at index time ({msg}); "
        f"weight-load@1 refused, fired {fired}, no engine, no params ({injected})")
    del svc, params
    shutil.rmtree(root)
    ctx.pop("params", None)  # both trees go before moe
    gc.collect()
    torch.cuda.empty_cache()


MOE_KW = {"max_seq_len": 4096}
# a layer's int8 expert weights: gate, up and down of mixtral-8x7b's 8
# experts (1.41 GB), each read once at the least
MOE_EXPERT_BYTES = 3 * 8 * 4096 * 14336


def _decode_step_ms(torch, cfg, params, batch: int = 8, steps: int = 8) -> float:
    """Mean wall of one paged decode step at ``batch`` rows (positions
    300..307, pages of 64) on the stream, host dispatch included."""
    from langstream_tpu_torch.models import transformer as tf

    per_row = math.ceil((300 + batch + steps + 2) / PAGE)
    pool = tf.make_page_pool(cfg, batch * per_row, PAGE, device="cuda")
    table = torch.arange(batch * per_row, dtype=torch.int32, device="cuda").reshape(batch, per_row)
    tokens = torch.zeros(batch, dtype=torch.long, device="cuda")
    pos = 300 + torch.arange(batch, device="cuda")
    for i in range(2):  # warm
        tf.paged_decode_step_inplace(params, tokens, pos + i, pool, table, cfg, PAGE)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        tf.paged_decode_step_inplace(params, tokens, pos + 2 + i, pool, table, cfg, PAGE)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _moe_ffn_times(torch, ctx, cfg, params) -> dict:
    """One layer's ``moe_ffn`` at decode (8 tokens) and at a 2048-token
    segment, each beside the time to read the layer's int8 expert weights
    once at the card's memory rate; the segment also beside its operations
    bound (2 experts a token, three products, at the bf16 peak)."""
    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.models.bridge import torch_dtype

    timer = Timer(torch)
    lp = tf._layer_params(params["layers"], 0)
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"] + 61)
    weight_ms = MOE_EXPERT_BYTES / HBM_BYTES_PER_S * 1e3
    out = {}
    for label, shape in (("decode T=8", (8, 1, cfg.d_model)), ("segment T=2048", (1, 2048, cfg.d_model))):
        x = torch.randn(shape, generator=g, device="cuda").to(torch_dtype(cfg.dtype))
        tokens = shape[0] * shape[1]
        flops = 2.0 * tokens * cfg.n_experts_per_tok * 3 * cfg.d_model * cfg.d_ff
        out[label] = {
            "ms": timer.ms(lambda: tf.moe_ffn(x, lp, cfg), iters=5, warmup=2),
            "weight_bytes_bound_ms": weight_ms,
            "operations_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "capacity": tf.moe_capacity(tokens, cfg),
        }
    del timer
    return out


def _moe_model_check(ctx, cfg, params) -> dict:
    """``_model_check`` on the MoE model, with each ``moe_ffn`` call's expert
    choice recorded per path (recomputed from its input): the (token,
    layer) pairs whose top-k set differs between the kernel and the
    reference path are counted beside the logits' error — a near-tied
    router choice that flips sends a token through another expert."""
    import torch

    from langstream_tpu_torch.models import transformer as tf

    routes = {"auto": [], "jnp": []}
    moe = tf.moe_ffn

    def recording(x, lp, c, *rest):
        logits = torch.matmul(x.reshape(-1, x.shape[-1]), lp["router"]).float()
        top = torch.topk(logits, c.n_experts_per_tok, dim=-1).indices
        routes[c.attention_impl].append(top.sort(dim=-1).values)
        return moe(x, lp, c, *rest)

    tf.moe_ffn = recording
    try:
        check = _model_check(ctx, cfg, params)
    finally:
        tf.moe_ffn = moe
    pairs = list(zip(routes["auto"], routes["jnp"]))
    check["routing_flips"] = sum(int((a != b).any(dim=-1).sum()) for a, b in pairs)
    check["routed_token_layers"] = sum(a.shape[0] for a, _ in pairs)
    return check


def phase_moe(ctx: dict) -> None:
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.quant import init_random_quantized_params

    cfg = MODEL_PRESETS["mixtral-8x7b"]
    ctx.pop("params", None)  # the llama weights: the card holds one model at a time
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    g = torch.Generator(device="cuda").manual_seed(ctx["seed"])
    t0 = time.monotonic()
    params = init_random_quantized_params(cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"mixtral-8x7b random int8 weights on the card in {time.monotonic() - t0:.1f}s "
        f"({before:.2f} GiB allocated before, {torch.cuda.memory_allocated() / 2**30:.2f} after)")
    run = _serve(ctx, cfg, params, [20, 90, 150, 300, 600, 900, 1200, 1500, 3000], 32, **MOE_KW)
    if run["segments"] != 2:
        raise AssertionError(f"moe: {run['segments']} segments, expected 2")
    _require_launches(run, "flash_prefill", "admit_groups", cfg.n_layers)
    _require_launches(run, "flash_segment", "segments", cfg.n_layers)
    _require_launches(run, "paged_decode", "decode_steps", cfg.n_layers)
    if run["peak_memory_gib"] * 2**30 >= 80e9:
        raise AssertionError(f"moe: peak memory {run['peak_memory_gib']:.2f} GiB is not under 80 GB")
    run["decode_step_ms"] = _decode_step_ms(torch, cfg, params)
    log(f"moe mixtral-8x7b int8 weights {json.dumps(run)}")
    ctx["moe"] = run
    log(f"model check mixtral-8x7b int8 weights {json.dumps(_moe_model_check(ctx, cfg, params))}")
    log(f"moe_ffn mixtral-8x7b layer 0 {json.dumps(_moe_ffn_times(torch, ctx, cfg, params))}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# the app phase: the e2e phase's prompt lengths as chat questions, one
# websocket each; the copied app's resource holds the longest with the chat
# template and the step's 256 new tokens (the step forwards no max-tokens)
APP_BYTES = [20, 90, 150, 300, 600, 900, 1200, 1500]
APP_MAX_SEQ_LEN = 2048
APP_NAME = "smoke-app"
# the longest wait for a chat's next answer message (the first one waits
# for an engine's draw and capture): a message lost fails the phase
# within the run's limit
APP_MESSAGE_S = 180.0


def _app_copy(ctx, dst: Path | None = None, model: str = "llama-3-8b",
              cluster: tuple[str, dict] = ("memory", {})) -> tuple[Path, Path]:
    """``build/app/`` (or ``dst``): the tpu-completions example with its
    resource's ``max-seq-len`` raised to ``APP_MAX_SEQ_LEN`` and this run's
    seed, and an instance of its own serving ``model`` over the streaming
    cluster ``cluster`` (type, configuration; the files under ``examples/``
    stay as they are)."""
    import shutil

    from langstream_tpu_torch.core.yaml_reader import safe_dump

    dst = dst or ROOT / "build" / "app"
    shutil.rmtree(dst, ignore_errors=True)
    app = dst / "tpu-completions"
    shutil.copytree(ROOT / "examples" / "applications" / "tpu-completions", app)
    conf = app / "configuration.yaml"
    text = conf.read_text()
    if "        max-seq-len: 512\n" not in text:
        raise AssertionError("app: the example's configuration.yaml changed; update _app_copy")
    conf.write_text(text.replace(
        "        max-seq-len: 512\n",
        f"        max-seq-len: {APP_MAX_SEQ_LEN}\n        weights: random\n"
        f"        seed: {ctx['seed']}\n"))
    kind, config = cluster
    streaming = {"type": kind, **({"configuration": config} if config else {})}
    instance = dst / "instance.yaml"
    instance.write_text(safe_dump({"instance": {
        "streamingCluster": streaming, "computeCluster": {"type": "local"},
        "globals": {"serving-model": model}}}))
    return app, instance


async def _app_chat(ws_url: str, session: str, question: str) -> dict:
    """One chat websocket: ask, then read answer messages until the last
    chunk; the client's TTFT is send to first message. A message whose
    value is null (Pulsar's runtime reads an empty payload, an empty
    chunk's, as null: the JAX package's rule) adds no text and is counted."""
    import asyncio

    from langstream_tpu_torch.gateway.websocket import connect

    ws = await connect(f"{ws_url}/v1/chat/default/{APP_NAME}/chat?param:sessionId={session}")
    t0 = time.monotonic()
    await ws.send_str(json.dumps({"value": question}))
    chunks, first, last = [], None, None
    while True:
        msg = await asyncio.wait_for(ws.receive(), APP_MESSAGE_S)
        if msg.kind != "text":
            raise AssertionError(f"app: session {session}'s socket closed ({msg.data})")
        if first is None:
            first = time.monotonic() - t0
        record = json.loads(msg.data)["record"]
        headers = record["headers"]
        if headers.get("langstream-client-session-id") != session:
            raise AssertionError(f"app: session {session} got another session's chunk")
        chunks.append((int(headers["stream-index"]), record["value"]))
        if headers.get("stream-last-message") == "true":
            last = time.monotonic()
            break
    total = last - t0
    await ws.close()
    if [i for i, _ in chunks] != list(range(len(chunks))):
        raise AssertionError(f"app: session {session}'s chunk indices {[i for i, _ in chunks]}")
    return {"ttft_s": first, "total_s": total, "messages": len(chunks), "sent_at": t0,
            "last_at": last, "text": "".join(v or "" for _, v in chunks),
            "first_text": chunks[0][1] or "",
            "null_messages": sum(1 for _, v in chunks if v is None)}


def _launch_check(cfg, counts, before: dict, after: dict, problems: list) -> dict:
    """Exact launches over a window: the prefill kernel layers x admit
    groups, the paged decode kernel layers x decode steps, every decode
    chunk a graph replay, no segment, no other kernel, no plain version."""
    groups = after["admit-groups-total"] - before["admit-groups-total"]
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    segments = after["prefill-segments-total"] - before["prefill-segments-total"]
    chunks = after["decode-chunks-total"] - before["decode-chunks-total"]
    replays = after["graph-replays-total"] - before["graph-replays-total"]
    launches = {k: v["launches"] for k, v in counts.items()}
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    layers = cfg.n_layers
    if plain:
        problems.append(f"plain versions ran: {plain}")
    if groups <= 0 or launches["flash_prefill"] != layers * groups:
        problems.append(f"flash_prefill launches {launches['flash_prefill']} != "
                        f"{layers} x {groups} admit groups")
    if steps <= 0 or launches["paged_decode"] != layers * steps:
        problems.append(f"paged_decode launches {launches['paged_decode']} != "
                        f"{layers} x {steps} decode steps")
    others = {k: n for k, n in launches.items() if n and k not in ("flash_prefill",
                                                                   "paged_decode")}
    if segments or others:
        problems.append(f"{segments} segments and other kernels launched: {others}")
    if chunks <= 0 or replays != chunks:
        problems.append(f"{chunks} decode chunks but {replays} graph replays")
    return {"layers": layers, "admit_groups": groups, "decode_steps": steps,
            "decode_chunks": chunks, "graph_replays": replays, "kernel_launches": launches}


async def _app_run(ctx, app_dir: Path, instance: Path, label: str = "app",
                   reference: dict | None = None, fake: "_FakeBroker | None" = None) -> dict:
    """The app through ``run local``'s code: 8 chat websockets at the
    ``APP_BYTES`` lengths, each answer's chunks once and in order, launches
    exact, the answers against a broker-free reference (``reference``:
    ``{"prompts", "tokens"}`` of an earlier run at this depth; else the
    provider's direct path, run here), the debug topic's final records;
    with ``fake`` (a broker in its own process) the completions step's
    committed position on the questions topic at the broker."""
    import asyncio

    import torch

    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.cli.main import start_local
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    t0 = time.monotonic()
    app = await start_local(app_dir, instance, name=APP_NAME, gateway_port=0, metrics_port=0)
    deploy_s = time.monotonic() - t0
    try:
        svc = app.runner._service_registry.get_provider().holder
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        engine = await loop.run_in_executor(None, svc.engine)  # draws, builds, captures
        engine_s = time.monotonic() - t0
        cfg = svc.model_config
        await svc.get_chat_completions([ChatMessage("user", "warm up")], {"max-tokens": 4})
        # every request the engine takes, with its result (a tap on submit:
        # the app's path and the direct path both go through it)
        taps: list = []
        submit = engine.submit

        def tapped(request):
            at = time.monotonic()
            future = submit(request)
            taps.append((request, future, at))
            return future

        engine.submit = tapped
        questions = _prompts(APP_BYTES, ctx["seed"])
        prompts = [svc.tokenizer.encode(svc._render_prompt([ChatMessage("user", q)]))
                   for q in questions]
        torch.cuda.synchronize()
        before = engine.stats()
        reset_kernel_counts()
        t_run = time.monotonic()
        chats = await asyncio.gather(*(
            _app_chat(app.gateway.ws_url, f"s{i}", q) for i, q in enumerate(questions)))
        wall = time.monotonic() - t_run
        counts = kernel_counts()
        after = engine.stats()
        served = {tuple(r.prompt_tokens): f.result(timeout=60) for r, f, _ in taps}
        submitted = {tuple(r.prompt_tokens): at for r, _, at in taps}
        debug = await app.runner.consume("debug-topic", n=len(questions), timeout=120)
        committed = await _committed_at_broker(fake, len(questions)) if fake else None
        taps.clear()
        texts = {}
        if reference is None:
            direct = await asyncio.gather(*(
                svc.get_chat_completions([ChatMessage("user", q)],
                                         {"model": "llama-3-8b", "min-chunks-per-message": 10,
                                          "tenant": "default"})
                for q in questions))
            direct_served = {tuple(r.prompt_tokens): f.result(timeout=60) for r, f, _ in taps}
            want = [direct_served[tuple(p)].tokens for p in prompts]
            texts["direct"] = [d.content for d in direct]
        else:
            if [list(p) for p in reference["prompts"]] != [list(p) for p in prompts]:
                raise AssertionError(f"{label}: the reference was served other prompts")
            want = reference["tokens"]
        metrics = app.metrics.metrics_text()
        params = svc.params()
        app_tokens = [served[tuple(p)].tokens for p in prompts]
        same = _same_or_tie(ctx, cfg, params, label, prompts, app_tokens, want)
    finally:
        await app.stop()
    problems = []
    for i, (chat, prompt) in enumerate(zip(chats, prompts)):
        result = served[tuple(prompt)]
        if result.finish_reason not in ("length", "stop") or result.error is not None:
            problems.append(f"s{i} ended {result.finish_reason}: {result.error}")
        if chat["text"] != svc.tokenizer.decode(result.tokens):
            problems.append(f"s{i}: the chunks are not the text of the answer's tokens")
        if texts and result.tokens == want[i] and chat["text"] != texts["direct"][i]:
            problems.append(f"s{i}: equal tokens but the text differs from the direct path's")
    finals = {}
    for record in debug:
        value = json.loads(record.value)
        session = {h.key: h.value for h in record.headers}["langstream-client-session-id"]
        finals[session] = value
    for i, (chat, q) in enumerate(zip(chats, questions)):
        final = finals.get(f"s{i}")
        if final is None or final["answer"] != chat["text"] or final["question"] != q:
            problems.append(f"s{i}: the debug topic's final record does not carry the answer")
    launch = _launch_check(cfg, counts, before, after, problems)
    if not same["ok"]:
        problems.append(f"answers differ from the broker-free reference beyond one-ulp ties: "
                        f"{same['not_ties']}")
    if "agent_" not in metrics or "completions_num_calls_total" not in metrics:
        problems.append("/metrics lacks the completions step's counters")
    nulls = sum(c["null_messages"] for c in chats)
    if nulls and not (fake and fake.kind == "pulsar"):
        problems.append(f"{nulls} answer messages arrived with a null value")
    if committed is not None and not committed["ok"]:
        problems.append(f"the questions topic's committed position at the broker: "
                        f"{committed}")
    tokens = sum(len(t) for t in app_tokens)
    # the plane's own cost: websocket send to the engine's submit (gateway,
    # broker, runner, document-to-json, the step), and the engine's end to
    # the last answer message at the client (the chunk writer, broker,
    # consume gateway, websocket)
    inbound = [submitted[tuple(p)] - c["sent_at"] for c, p in zip(chats, prompts)]
    outbound = [c["last_at"] - submitted[tuple(p)] - served[tuple(p)].total_s
                for c, p in zip(chats, prompts)]
    run = {
        "requests": len(questions),
        "prompt_tokens": [len(p) for p in prompts],
        "answer_tokens": [len(t) for t in app_tokens],
        "client_ttft_s": [c["ttft_s"] for c in chats],
        "engine_ttft_ms": [served[tuple(p)].ttft_s * 1000.0 for p in prompts],
        "client_total_s": [c["total_s"] for c in chats],
        "engine_total_s": [served[tuple(p)].total_s for p in prompts],
        "inbound_ms": [s * 1000.0 for s in inbound],
        "outbound_ms": [s * 1000.0 for s in outbound],
        "empty_answers": sum(1 for c in chats if not c["text"]),
        "null_messages": nulls,
        "messages": [c["messages"] for c in chats],
        "first_message_chars": [len(c["first_text"]) for c in chats],
        "wall_s": wall,
        "answer_tokens_per_s": tokens / wall,
        "deploy_s": deploy_s,
        "engine_build_s": engine_s,
        **{k: launch[k] for k in ("admit_groups", "decode_steps", "decode_chunks",
                                  "graph_replays", "kernel_launches")},
        "same_as_direct": {k: same[k] for k in ("agreement", "ties", "equal")},
        "layers": launch["layers"],
        **({"committed": committed} if committed is not None else {}),
    }
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems) + f" ({json.dumps(run)[:2000]})")
    run["_reference"] = {"prompts": prompts, "tokens": app_tokens}
    return run


def phase_app(ctx: dict) -> None:
    import gc

    import torch

    ctx.pop("params", None)  # the app's provider draws its own tree (the same seed)
    gc.collect()
    torch.cuda.empty_cache()
    app_dir, instance = _app_copy(ctx)
    run = _app_run_sync(ctx, app_dir, instance)
    # the broker-free answers at this depth: the brokers phase's kafka reference
    ctx["app_reference"] = {"layers": run["layers"], **run.pop("_reference")}
    card = smi_line()
    for i, (client, engine) in enumerate(zip(run["client_ttft_s"], run["engine_ttft_ms"])):
        log(f"app ttft s{i} ({run['prompt_tokens'][i]} prompt tokens, "
            f"{run['answer_tokens'][i]} answer tokens, {run['messages'][i]} messages): "
            f"client {client * 1000.0:.1f} ms (send to first answer message), engine "
            f"{engine:.1f} ms; send to submit {run['inbound_ms'][i]:.1f} ms, engine end to "
            f"last message {run['outbound_ms'][i]:.1f} ms [{card}]")
    log("app note: the provider sends a chunk after 1, 2, 4, 8 tokens, then every "
        "min-chunks-per-message (10) tokens, and only when the text grew: tokens the byte "
        f"tokenizer decodes to nothing send nothing ({run['empty_answers']} of "
        f"{run['requests']} answers decode to empty text with random weights, so their "
        "first message is their last)")
    log(f"app burst: {run['wall_s']:.3f} s, {sum(run['answer_tokens'])} answer tokens, "
        f"{run['answer_tokens_per_s']:.1f} tokens/s [{card}]")
    log(f"app tpu-completions llama-3-8b {json.dumps(run)}")
    ctx["app"] = run
    gc.collect()
    torch.cuda.empty_cache()


def _app_run_sync(ctx, app_dir: Path, instance: Path) -> dict:
    import asyncio

    return asyncio.run(_app_run(ctx, app_dir, instance))


# the rag phase: a seeded site on the loopback, crawled, indexed and asked
RAG_NAME = "smoke-rag"
RAG_PAGES = 50
RAG_PARAGRAPHS, RAG_PARAGRAPH_WORDS = 5, 110  # ~3.5 KB of text a page
RAG_QUESTIONS = 8
# the crawler's politeness delay for a server on the loopback (the
# example's own, 500 ms between requests, is for other people's sites)
RAG_MIN_TIME_MS = 5
# the example's own settings, held by the checks
RAG_MAX_URLS, RAG_TOP_K, RAG_MMR_MAX, RAG_MMR_LAMBDA = 50, 10, 3, 0.5
RAG_CHUNK_SIZE, RAG_CHUNK_OVERLAP = 400, 50
# a re-rank pick may differ from the f64 plain MMR's only where the two
# candidates' MMR scores lie this close (the agent computes in f32)
RAG_MMR_TIE = 1e-6
RAG_WORDS = (
    "tensor core stream record topic agent pipeline vector index query answer memory cache "
    "page kernel batch token embedding chunk crawl site schema latency throughput replica "
    "gateway broker partition offset commit window state checkpoint router tenant quota "
    "prompt context retrieval ranking model layer attention decode prefill graph card"
).split()


def _rag_site(seed: int) -> dict:
    """The site: ``/doc/0.html`` .. ``/doc/49.html``, each RAG_PARAGRAPHS
    paragraphs of seeded words with links to pages i+1, i+3 (relative), i+11
    (with a fragment) and to another host (``localhost``, never allowed);
    page 0 also links a path robots.txt disallows and one that answers 404.
    path → {"body": html bytes, "links": the absolute urls its links name
    (fragments dropped, as written by hand: the plain crawl below reads
    these, not the HTML)}; the base url is filled in by ``{base}``."""
    rng = random.Random(seed + 23)
    site = {}
    for i in range(RAG_PAGES):
        paras = ["<p>" + " ".join(rng.choice(RAG_WORDS) for _ in range(RAG_PARAGRAPH_WORDS))
                 + ".</p>" for _ in range(RAG_PARAGRAPHS)]
        nxt, third, far = (i + 1) % RAG_PAGES, (i + 3) % RAG_PAGES, (i + 11) % RAG_PAGES
        hrefs = [(f"/doc/{nxt}.html", f"{{base}}/doc/{nxt}.html"),
                 (f"{third}.html", f"{{base}}/doc/{third}.html"),
                 (f"/doc/{far}.html#part", f"{{base}}/doc/{far}.html"),
                 (f"http://localhost:{{port}}/doc/{far}.html",
                  f"http://localhost:{{port}}/doc/{far}.html")]
        if i == 0:
            hrefs += [("/private/notes.html", "{base}/private/notes.html"),
                      ("/doc/missing.html", "{base}/doc/missing.html"),
                      ("mailto:site@example.com", None)]
        links = " ".join(f'<a href="{h}">link</a>' for h, _ in hrefs)
        body = (f"<!DOCTYPE html><html><head><title>Document {i}</title>"
                "<style>p { margin: 0 }</style></head><body>"
                f"<h1>Document {i}</h1>{''.join(paras)}<nav>{links}</nav>"
                f"<script>var page = {i};</script></body></html>")
        site[f"/doc/{i}.html"] = {"body": body, "links": [a for _, a in hrefs if a]}
    site["/private/notes.html"] = {"body": "<html><p>robots keep this out</p></html>",
                                   "links": []}
    return site


class _RagServer:
    """The site on a ``ThreadingHTTPServer`` at 127.0.0.1 (a free port):
    ``/robots.txt`` disallows ``/private/``, a path not in the site answers
    404; each request's path, status and time are logged."""

    def __init__(self, site: dict) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.log: list = []
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/robots.txt":
                    status, ctype, data = 200, "text/plain", b"User-agent: *\nDisallow: /private/\n"
                elif self.path in site:
                    status, ctype = 200, "text/html; charset=utf-8"
                    data = server.render(site[self.path]["body"]).encode()
                else:
                    status, ctype, data = 404, "text/html", b"<html>not found</html>"
                server.log.append((self.path, status, time.monotonic()))
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="rag-site",
                                       daemon=True)
        self.thread.start()

    def render(self, text: str) -> str:
        return text.replace("{base}", self.base).replace("{port}", str(self.port))

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(30)


def _rag_plain_crawl(site: dict, server: _RagServer) -> list[str]:
    """The pages a breadth-first crawl of the example's settings emits, in
    order, from the site's own link lists: only 127.0.0.1, nothing under
    ``/private/``, a 404 visited (it counts toward ``max-urls``), at most
    RAG_MAX_URLS urls visited or emitted."""
    pending = [(f"{server.base}/doc/0.html", 0)]
    seen, emitted = set(), []
    while pending and len(seen) < RAG_MAX_URLS:
        url, depth = pending.pop(0)
        if url in seen or not url.startswith(server.base + "/"):
            continue
        path = url[len(server.base):]
        if path.startswith("/private/"):
            continue
        seen.add(url)
        if path not in site:
            continue
        pending += [(server.render(a), depth + 1) for a in site[path]["links"]
                    if server.render(a) not in seen]
        emitted.append(url)
    return emitted


def _rag_copy(ctx, server: _RagServer) -> tuple[Path, Path]:
    """``build/rag/``: the tpu-rag example with its resource's ``max-seq-len``
    raised to ``APP_MAX_SEQ_LEN``, ``weights: random`` and this run's seed,
    the crawl pointed at the local site with the politeness delay lowered
    to RAG_MIN_TIME_MS, the vector store's ``path`` under ``build/rag/``,
    and an instance serving llama-3-8b (the files under ``examples/`` stay
    as they are; everything else keeps the example's settings)."""
    import shutil

    dst = ROOT / "build" / "rag"
    shutil.rmtree(dst, ignore_errors=True)
    app = dst / "tpu-rag"
    shutil.copytree(ROOT / "examples" / "applications" / "tpu-rag", app)
    edits = {
        "configuration.yaml": [
            ("        max-seq-len: 512\n", f"        max-seq-len: {APP_MAX_SEQ_LEN}\n"
             f"        weights: random\n        seed: {ctx['seed']}\n"),
            ('        path: "${secrets.vector-database.path}"\n',
             f'        path: "{dst / "vectors"}"\n'),
        ],
        "crawl.yaml": [
            ('      seed-urls: ["https://example.com/"]\n      allowed-domains: ["example.com"]\n',
             f'      seed-urls: ["{server.base}/doc/0.html"]\n'
             '      allowed-domains: ["127.0.0.1"]\n'
             f"      min-time-between-requests: {RAG_MIN_TIME_MS}\n"),
        ],
    }
    for name, pairs in edits.items():
        text = (app / name).read_text()
        for old, new in pairs:
            if old not in text:
                raise AssertionError(f"rag: the example's {name} changed; update _rag_copy")
            text = text.replace(old, new)
        (app / name).write_text(text)
    for name, want in (("crawl.yaml", f"max-urls: {RAG_MAX_URLS}"),
                       ("crawl.yaml", f"chunk_size: {RAG_CHUNK_SIZE}"),
                       ("crawl.yaml", f"chunk_overlap: {RAG_CHUNK_OVERLAP}"),
                       ("query.yaml", f'"topK": {RAG_TOP_K}'),
                       ("query.yaml", f"max: {RAG_MMR_MAX}"),
                       ("query.yaml", "output-mode: text")):
        if want not in (app / name).read_text():
            raise AssertionError(f"rag: the example's {name} no longer says {want!r}")
    instance = dst / "instance.yaml"
    instance.write_text("instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n"
                        f"    type: local\n  globals:\n    serving-model: {_shallow_model()}\n")
    return app, instance


def _rag_chunks(bodies: list[bytes], size: int = RAG_CHUNK_SIZE,
                overlap: int = RAG_CHUNK_OVERLAP) -> list[str]:
    """The port's text-extractor and text-splitter at the example's
    settings (or ``size`` / ``overlap``) over each body, on the host."""
    import asyncio

    from langstream_tpu_torch.agents.text import TextExtractorAgent, TextSplitterAgent
    from langstream_tpu_torch.api.record import SimpleRecord

    async def run():
        extract, split = TextExtractorAgent(), TextSplitterAgent()
        await extract.init({})
        await split.init({"chunk_size": size, "chunk_overlap": overlap})
        out = []
        for body in bodies:
            text = (await extract.process_record(SimpleRecord.of(body)))[0]
            out += [r.value for r in await split.process_record(text)]
        return out

    return asyncio.run(run())


def _rag_questions(seed: int) -> list[str]:
    """RAG_QUESTIONS distinct questions of the site's words."""
    rng = random.Random(seed + 29)
    out: list[str] = []
    while len(out) < RAG_QUESTIONS:
        q = (f"What does the site say about {rng.choice(RAG_WORDS)} and "
             f"{rng.choice(RAG_WORDS)} for the {rng.choice(RAG_WORDS)}?")
        if q not in out:
            out.append(q)
    return out


def _rag_ask(url: str, question: str) -> dict:
    """One question through the service gateway: POST, the reply record
    (a blocking call for a worker thread)."""
    import urllib.request

    request = urllib.request.Request(url, data=json.dumps({"value": question}).encode(),
                                     method="POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    t0 = time.monotonic()
    with opener.open(request, timeout=900) as resp:
        reply = json.loads(resp.read())
    return {"reply": reply, "sent_at": t0, "answered_at": time.monotonic()}


def _plain_mmr(np, q, vectors, k: int, lam: float) -> tuple[list, list]:
    """MMR in f64: (picked indices, each pick's margin over the runner-up)."""
    def cos(a, b):
        return float(a @ b) / (float(np.linalg.norm(a) * np.linalg.norm(b)) + 1e-9)

    vecs = [np.asarray(v, np.float64) for v in vectors]
    q = np.asarray(q, np.float64)
    picked, margins, left = [], [], list(range(len(vecs)))
    while left and len(picked) < k:
        scores = [lam * cos(vecs[i], q) - (1 - lam) * max(
            (cos(vecs[i], vecs[j]) for j in picked), default=0.0) for i in left]
        order = sorted(range(len(left)), key=lambda j: (-scores[j], j))
        best = left[order[0]]
        margins.append(scores[order[0]] - scores[order[1]] if len(order) > 1 else math.inf)
        picked.append(best)
        left.remove(best)
    return picked, margins


def _rag_retrieval_check(np, store_dir: Path, replies: list) -> dict:
    """Each question's top-k against a plain f64 cosine top-k over the
    saved index (the lower row first among equal scores; a neighbour pair
    in the other order only within VECTOR_TIE), and its re-rank picks
    against a plain f64 MMR over the same hits (a pick may differ only
    where the MMR scores lie within RAG_MMR_TIE)."""
    matrix = np.load(store_dir / "docs.npz")["matrix"].astype(np.float64)
    meta = json.loads((store_dir / "docs.json").read_text())
    row_of = {id_: r for r, id_ in enumerate(meta["ids"])}
    rows = matrix / (np.linalg.norm(matrix, axis=1, keepdims=True) + 1e-9)
    swaps, mmr_ties = [], []
    for qi, value in enumerate(replies):
        q = np.asarray(value["embeddings"], np.float64)
        scores = rows @ (q / (np.linalg.norm(q) + 1e-9))
        want = _ranked_rows(np, scores[None], RAG_TOP_K)[0].tolist()
        got = [row_of[hit["id"]] for hit in value["related"]]
        if len(got) != RAG_TOP_K:
            raise AssertionError(f"rag: question {qi} got {len(got)} hits, not {RAG_TOP_K}")
        for j, (a, b) in enumerate(zip(got, want)):
            if a != b:
                gap = abs(scores[a] - scores[b])
                swaps.append({"question": qi, "rank": j, "f64_gap": gap})
                if gap > VECTOR_TIE:
                    raise AssertionError(f"rag: question {qi} rank {j}: row {a}, the plain "
                                         f"top-k's {b} (gap {gap})")
        for hit in value["related"]:
            if hit["vector"] != matrix[row_of[hit["id"]]].astype(np.float32).tolist():
                raise AssertionError(f"rag: question {qi}: a hit's vector is not its stored row")
        picked, margins = _plain_mmr(np, value["embeddings"],
                                     [h["vector"] for h in value["related"]], RAG_MMR_MAX,
                                     RAG_MMR_LAMBDA)
        plain_texts = [value["related"][i]["text"] for i in picked]
        if plain_texts != value["context"]:
            close = [m for m in margins if m <= RAG_MMR_TIE]
            if not close:
                raise AssertionError(f"rag: question {qi}'s re-rank picks differ from the "
                                     f"plain MMR's (margins {margins})")
            mmr_ties.append({"question": qi, "margins": margins})
    return {"rows": len(meta["ids"]), "topk_swapped_ties": swaps, "mmr_ties": mmr_ties}


def _rag_embed_threads(torch, emb, holder, text: str, n: int = 8) -> dict:
    """One text embedded ``n`` times: serially through the service, from
    ``n`` threads at once through the service (its lock serializes the
    device work), and from ``n`` threads each calling ``encode`` on a
    stream of its own without the lock: the wall ms of each way."""
    from langstream_tpu_torch.models import transformer as tf

    tokens, lengths = emb.batch([text])
    params = holder.params()

    def unlocked():
        with torch.cuda.stream(torch.cuda.Stream()):
            tf.encode(params, torch.from_numpy(tokens).cuda(), torch.from_numpy(lengths).cuda(),
                      holder.model_config).cpu()

    def at_once(fn) -> float:
        threads = [threading.Thread(target=fn) for _ in range(n)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return (time.monotonic() - t0) * 1e3

    emb.embed([text])
    unlocked()
    t0 = time.monotonic()
    for _ in range(n):
        emb.embed([text])
    serial = (time.monotonic() - t0) * 1e3
    return {"calls": n, "tokens": int(lengths[0]), "width": int(tokens.shape[1]),
            "serial_ms": serial, "threads_locked_ms": at_once(lambda: emb.embed([text])),
            "threads_unlocked_ms": at_once(unlocked)}


async def _rag_run(ctx, app_dir: Path, instance: Path, server: _RagServer,
                   expected_pages: list, chunks: list) -> dict:
    from langstream_tpu_torch.agents.vector import (
        LocalVectorDataSource,
        QueryVectorDBAgent,
        ReRankAgent,
    )
    from langstream_tpu_torch.ai.torch_serving import TorchEmbeddingsService
    from langstream_tpu_torch.cli.main import start_local

    # each stage's calls, timed where they run: (stage, key, start, end)
    spans: list = []
    patched = []

    def timed(cls, name, stage, key):
        original = getattr(cls, name)

        async def wrapper(self, *args):
            t0 = time.monotonic()
            try:
                return await original(self, *args)
            finally:
                spans.append((stage, key(*args), t0, time.monotonic()))

        patched.append((cls, name, original))
        setattr(cls, name, wrapper)

    def question_of(record):
        value = record.value
        return (json.loads(value) if isinstance(value, (str, bytes)) else value).get("question")

    timed(TorchEmbeddingsService, "compute_embeddings", "embed", lambda texts: tuple(texts))
    timed(QueryVectorDBAgent, "process_record", "search", question_of)
    timed(ReRankAgent, "process_record", "rerank", question_of)
    search = LocalVectorDataSource.search
    search_ms: list = []

    def timed_search(self, *args, **kw):
        t0 = time.monotonic()
        out = search(self, *args, **kw)  # reads its results back: the card is done
        search_ms.append((time.monotonic() - t0) * 1e3)
        return out

    LocalVectorDataSource.search = timed_search
    try:
        t_start = time.monotonic()
        app = await start_local(app_dir, instance, name=RAG_NAME, gateway_port=0, metrics_port=0)
        deploy_s = time.monotonic() - t_start
        try:
            return await _rag_serve(ctx, app, server, expected_pages, chunks, spans, search_ms,
                                    t_start, deploy_s)
        finally:
            await app.stop()
    finally:
        for cls, name, original in patched:
            setattr(cls, name, original)
        LocalVectorDataSource.search = search


async def _rag_serve(ctx, app, server, expected_pages, chunks, spans, search_ms, t_start,
                     deploy_s) -> dict:
    """The running app's checks: the write path (pages, chunks, stored
    vectors), then the 8 questions through ``ask`` and the direct path."""
    import asyncio

    import numpy as np
    import torch

    from langstream_tpu_torch.agents.genai import el
    from langstream_tpu_torch.agents.genai.mutable import MutableRecord
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.api.record import SimpleRecord
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    registry = app.runner._service_registry
    svc = registry.get_provider().holder
    store = registry.get_datasource("vdb")
    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    await loop.run_in_executor(None, svc.params)  # drawn by the first embedding, or now
    params_s = time.monotonic() - t0
    # the write path: until the index holds every chunk of the site
    deadline = time.monotonic() + 900
    while True:
        rows = len(store._indexes.get("docs", {}).get("ids", []))
        if rows >= len(chunks):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"rag: {rows} of {len(chunks)} chunks indexed after 900 s")
        await asyncio.sleep(0.05)
    t_indexed = time.monotonic()
    await asyncio.sleep(1.0)  # nothing more may arrive
    pages = [p for p, status, _ in server.log if status == 200 and p.startswith("/doc/")]
    fetched = [p for p, _, _ in server.log if p != "/robots.txt"]
    page_times = [t for p, status, t in server.log if status == 200 and p.startswith("/doc/")]
    problems = []
    want_pages = [u[len(server.base):] for u in expected_pages]
    if pages != want_pages:
        problems.append(f"pages crawled {pages} != the plain crawl's {want_pages}")
    if "/private/notes.html" in fetched or fetched.count("/doc/missing.html") != 1:
        problems.append(f"robots or the 404 not held: {fetched}")
    idx = store._indexes["docs"]
    stored_texts = [m["text"] for m in idx["meta"]]
    if len(stored_texts) != len(chunks) or sorted(stored_texts) != sorted(chunks):
        problems.append(f"index holds {len(stored_texts)} rows, the host's splitter gives "
                        f"{len(chunks)} chunks (or other texts)")
    # every stored vector against the provider's direct encode of its text,
    # in batches of 64 texts of like lengths
    emb = registry.get_provider().get_embeddings_service({})
    order = sorted(range(len(stored_texts)), key=lambda i: len(stored_texts[i]))
    direct = np.empty_like(idx["matrix"][:len(stored_texts)])
    for a in range(0, len(order), 64):
        rows = order[a:a + 64]
        direct[rows] = emb.embed([stored_texts[i] for i in rows])
    stored = idx["matrix"][:len(stored_texts)]
    vec_err = np.linalg.norm(stored - direct, axis=1)
    if vec_err.max() > EMBED_TOL:
        problems.append(f"stored vectors differ from direct encodes by up to {vec_err.max()}")
    write_embeds = [(t0, t1) for stage, _, t0, t1 in spans if stage == "embed"]
    # the time at least one embedding call ran (the runner's records embed
    # concurrently, in the event loop's executor)
    embed_busy, reached = 0.0, -math.inf
    for t0, t1 in sorted(write_embeds):
        if t1 > reached:
            embed_busy += t1 - max(t0, reached)
            reached = t1
    write = {
        "pages": len(pages), "chunks": len(chunks), "deploy_s": deploy_s,
        "weights_ready_s": params_s,
        "crawl_wall_s": page_times[-1] - page_times[0] if len(page_times) > 1 else 0.0,
        "write_path_s": t_indexed - t_start,
        "embed_calls": len(write_embeds), "embed_busy_s": embed_busy,
        "embed_share": embed_busy / (t_indexed - t_start),
        "chunks_per_s_write_path": len(chunks) / (t_indexed - t_start),
        "chunks_per_s_embedding": len(chunks) / embed_busy if embed_busy else None,
        "stored_vs_direct_max_l2": float(vec_err.max()), "tolerance_l2": EMBED_TOL,
    }
    write["pages_per_s"] = (len(pages) / write["crawl_wall_s"]) if write["crawl_wall_s"] else None
    write["embed_threads"] = _rag_embed_threads(torch, emb, svc, chunks[0])
    if problems:
        raise AssertionError("rag write path: " + "; ".join(problems)
                             + f" ({json.dumps(write)[:2000]})")
    spans.clear()
    search_ms.clear()
    # the read path: the engine built and warm, then the questions at once
    t0 = time.monotonic()
    engine = await loop.run_in_executor(None, svc.engine)
    engine_s = time.monotonic() - t0
    cfg = svc.model_config
    await svc.get_chat_completions([ChatMessage("user", "warm up")], {"max-tokens": 4})
    taps: list = []
    submit = engine.submit

    def tapped(request):
        at = time.monotonic()
        future = submit(request)
        taps.append((request, future, at))
        return future

    engine.submit = tapped
    questions = _rag_questions(ctx["seed"])
    url = (f"{app.gateway.url}/api/gateways/service/default/{RAG_NAME}/ask"
           "?option:timeout=900")
    torch.cuda.synchronize()
    before = engine.stats()
    reset_kernel_counts()
    t_run = time.monotonic()
    asks = await asyncio.gather(*(asyncio.to_thread(_rag_ask, url, q) for q in questions))
    wall = time.monotonic() - t_run
    counts = kernel_counts()
    after = engine.stats()
    served = [(r, f.result(timeout=60), at) for r, f, at in taps]
    taps.clear()
    replies = [json.loads(a["reply"]["record"]["value"]) for a in asks]
    by_question = {}
    for (req, result, at) in served:
        text = svc.tokenizer.decode(req.prompt_tokens)
        owner = [q for q in questions if q in text]
        if len(owner) != 1:
            raise AssertionError(f"rag: a completion request names {len(owner)} questions")
        by_question[owner[0]] = (req, result, at)
    # the direct path: the same messages through the provider
    messages = []
    for value in replies:
        record = MutableRecord.from_record(SimpleRecord.of(json.dumps(value)))
        messages.append([
            ChatMessage("system", el.render_template(
                "Answer using this context: {{ value.context }}", record)),
            ChatMessage("user", value["question"])])
    await asyncio.gather(*(svc.get_chat_completions(m, {"model": "llama-3-8b",
                                                        "tenant": "default"})
                           for m in messages))
    direct = {}
    for req, future, _ in taps:
        direct[tuple(req.prompt_tokens)] = future.result(timeout=60)
    store.flush()
    retrieval = _rag_retrieval_check(np, Path(store._path), replies)
    params = svc.params()
    prompts = [list(by_question[q][0].prompt_tokens) for q in questions]
    app_tokens = [by_question[q][1].tokens for q in questions]
    problems = []
    missing = [i for i, p in enumerate(prompts) if tuple(p) not in direct]
    if missing:
        problems.append(f"questions {missing}: the direct path rendered another prompt")
    want = [direct[tuple(p)].tokens if tuple(p) in direct else [] for p in prompts]
    same = _same_or_tie(ctx, cfg, params, "rag", prompts, app_tokens, want)
    for i, (q, value) in enumerate(zip(questions, replies)):
        result = by_question[q][1]
        if value["question"] != q or value["answer"] != svc.tokenizer.decode(result.tokens):
            problems.append(f"question {i}: the reply does not carry its answer")
        if result.finish_reason not in ("length", "stop") or result.error is not None:
            problems.append(f"question {i} ended {result.finish_reason}: {result.error}")
        if len(value["context"]) != RAG_MMR_MAX:
            problems.append(f"question {i}: {len(value['context'])} context texts")
    groups = after["admit-groups-total"] - before["admit-groups-total"]
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    segments = after["prefill-segments-total"] - before["prefill-segments-total"]
    chunks_n = after["decode-chunks-total"] - before["decode-chunks-total"]
    replays = after["graph-replays-total"] - before["graph-replays-total"]
    launches = {k: v["launches"] for k, v in counts.items()}
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    layers = cfg.n_layers
    if plain:
        problems.append(f"plain versions ran: {plain}")
    if groups <= 0 or launches["flash_prefill"] != layers * groups:
        problems.append(f"flash_prefill launches {launches['flash_prefill']} != {layers} x "
                        f"{groups} admit groups")
    if steps <= 0 or launches["paged_decode"] != layers * steps:
        problems.append(f"paged_decode launches {launches['paged_decode']} != {layers} x "
                        f"{steps} decode steps")
    if launches.get("flash_segment", 0) != layers * segments:
        problems.append(f"flash_segment launches {launches.get('flash_segment')} != {layers} "
                        f"x {segments} prefill segments")
    others = {k: n for k, n in launches.items()
              if n and k not in ("flash_prefill", "paged_decode", "flash_segment")}
    if others:
        problems.append(f"other kernels launched: {others}")
    if chunks_n <= 0 or replays != chunks_n:
        problems.append(f"{chunks_n} decode chunks but {replays} graph replays")
    if not same["ok"]:
        problems.append(f"answers differ from the direct path beyond one-ulp ties: "
                        f"{same['not_ties']}")

    def span(stage, key):
        got = [(t1 - t0) * 1e3 for s, k, t0, t1 in spans if s == stage and k == key]
        return got[0] if len(got) == 1 else None

    per_question = []
    for q, ask in zip(questions, asks):
        req, result, at = by_question[q]
        per_question.append({
            "prompt_tokens": len(req.prompt_tokens), "answer_tokens": len(result.tokens),
            "send_to_answer_ms": (ask["answered_at"] - ask["sent_at"]) * 1e3,
            "engine_ttft_ms": result.ttft_s * 1e3,
            "embed_ms": span("embed", (q,)), "search_ms": span("search", q),
            "rerank_ms": span("rerank", q), "completion_ms": result.total_s * 1e3,
            "send_to_submit_ms": (at - ask["sent_at"]) * 1e3,
        })
    tokens = sum(len(t) for t in app_tokens)
    run = {
        "write": write, "questions": len(questions), "per_question": per_question,
        "topk_ms_per_query": list(search_ms), "wall_s": wall,
        "answer_tokens_per_s": tokens / wall, "engine_build_s": engine_s,
        "admit_groups": groups, "decode_steps": steps, "prefill_segments": segments,
        "decode_chunks": chunks_n, "graph_replays": replays, "kernel_launches": launches,
        "retrieval": retrieval,
        "same_as_direct": {k: same[k] for k in ("agreement", "ties", "equal")},
    }
    if problems:
        raise AssertionError("rag: " + "; ".join(problems) + f" ({json.dumps(run)[:2000]})")
    return run


def phase_rag(ctx: dict) -> None:
    """The tpu-rag example on the card (module docstring, phase 23)."""
    import asyncio
    import gc

    import torch

    ctx.pop("params", None)  # the app's provider draws its own tree (the same seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    site = _rag_site(ctx["seed"])
    server = _RagServer(site)
    try:
        expected = _rag_plain_crawl(site, server)
        chunks = _rag_chunks([server.render(site[u[len(server.base):]]["body"]).encode()
                              for u in expected])
        app_dir, instance = _rag_copy(ctx, server)
        log(f"rag: site of {len(site)} pages at {server.base}; the plain crawl emits "
            f"{len(expected)} pages, {len(chunks)} chunks; min-time-between-requests "
            f"{RAG_MIN_TIME_MS} ms (the example's: 500 ms)")
        run = asyncio.run(_rag_run(ctx, app_dir, instance, server, expected, chunks))
    finally:
        server.close()
    card = smi_line()
    w = run["write"]
    log(f"rag crawl: {w['pages']} pages in {w['crawl_wall_s']:.3f} s ({w['pages_per_s']:.2f} "
        f"pages/s), {w['chunks']} chunks indexed {w['write_path_s']:.3f} s after the app "
        f"started ({w['chunks_per_s_write_path']:.2f} chunks/s; "
        f"{w['chunks_per_s_embedding']:.2f} chunks/s while an embedding ran; the share of the "
        f"write path with an embedding running {w['embed_share']:.3f}) [{card}]")
    th = w["embed_threads"]
    log(f"rag embed calls: {th['calls']} of one {th['tokens']}-token text ({th['width']} wide) "
        f"{th['serial_ms']:.1f} ms one after another, {th['threads_locked_ms']:.1f} ms from "
        f"{th['calls']} threads through the service's lock, {th['threads_unlocked_ms']:.1f} "
        f"ms from {th['calls']} threads without it [{card}]")
    topk = run["topk_ms_per_query"]
    log(f"rag top-k: {sum(topk) / len(topk):.3f} ms a query over {w['chunks']} rows "
        f"(host wall of the store's search, the card's result read back) [{card}]")
    for i, q in enumerate(run["per_question"]):
        log(f"rag q{i} ({q['prompt_tokens']} prompt tokens, {q['answer_tokens']} answer "
            f"tokens): send to answer {q['send_to_answer_ms']:.1f} ms, engine ttft "
            f"{q['engine_ttft_ms']:.1f} ms; embed {q['embed_ms']:.1f} ms, search "
            f"{q['search_ms']:.1f} ms, re-rank {q['rerank_ms']:.1f} ms, completion "
            f"{q['completion_ms']:.1f} ms [{card}]")
    log(f"rag burst: {run['wall_s']:.3f} s, {run['answer_tokens_per_s']:.1f} answer tokens/s "
        f"[{card}]")
    run["phase_s"] = time.monotonic() - t_phase
    log(f"rag phase: {run['phase_s']:.1f} s [{card}]")
    log(f"rag tpu-rag {SHALLOW_MODEL} {json.dumps(run)}")
    ctx["rag"] = run
    ctx.setdefault("summaries", []).append(("rag", {
        "pages": w["pages"], "chunks": w["chunks"], "write_path_s": w["write_path_s"],
        "embed_share": w["embed_share"], "burst_s": run["wall_s"],
        "answer_tokens_per_s": run["answer_tokens_per_s"],
        "launches": {k: n for k, n in run["kernel_launches"].items() if n}}))
    gc.collect()
    torch.cuda.empty_cache()


# the remote phase: gateway-authentication, slack and rag-aws, each a copy
# under build/remote/ run through the code of ``run local`` (module
# docstring, phase 24); the outside services are stdlib stubs on the loopback
REMOTE_REGION = "us-east-1"
REMOTE_OBJECTS, REMOTE_OBJECT_WORDS = 4, 150
REMOTE_QUESTIONS = 2
REMOTE_SPLIT = (400, 40)  # rag-aws's text-splitter: chunk_size, chunk_overlap
# the phase's RSA-2048 key, fixed test data (modulus, public and private
# exponents): the tokens are signed on the stdlib, EMSA-PKCS1-v1_5 then
# pow(m, d, n); the card's machine has no ``cryptography`` to make one
REMOTE_RSA_N = int(
    "c62923a642248ac79cf00e855c135c3d2d0c6c03063ac7d7f40e0907e5ca07fe86ad5fc63e55d1ee3d6122e9"
    "f6a3d38766b34cb520279ef66b442f5ac4a3a12c93156e7e6067edcf4ca57d8f9188ec67c83068d9630b814e"
    "47213736f91e4b1cfdbc291aeae639fe8bfb4644d3a3e5c2d905634202c6c99daa1b726bc537973c655192af"
    "cf0d1960edbd8dc89de7a5a0eeac7633566f6f24a17bcf2708788c4a1dba10956125738b86372b59a70a394b"
    "9ef926ea5c509e007fdc852be953c3cccc214b25c68d1987b69d450fe5fd04b23a14f7cfb82bf9e82176f1d1"
    "14e3021d9d587ae35440000a4d0b676dd690eef7fc8b8d2bc572fcd4603120d5ebb70a53", 16)
REMOTE_RSA_E = 65537
REMOTE_RSA_D = int(
    "298423fa68c0242d47058a5d4959ab090c1f9e9f91960e198201d0c58d50a31521dd4004163a3fb5d4b93da9"
    "dbe91ddfafd61fdb90c58c49df56553f84942da7db96f163dbc9da6a8489e5810742331959393f365048704a"
    "589fae643f9427b386bb7db72c8098a4ea69f622645ee1bbcd61121719e2d109cdc25b5a15e31c358638ffc2"
    "75df922ca2fde61cacaedd9d8178f1e846d90078806118aa07d258875324105985cb3ca4b790d81b189917ce"
    "ca5becde37cd9585b365b54e83c47b7eaf14b60e7ba53679b457a0b0cfacedc5b64997bef4cdae08a98c91f8"
    "f4c8869644900af4262eb5a592d7b2295524fa09084c95f09faa7d3c682b328abcf7e291", 16)
REMOTE_KID = "smoke-key"
SIGV4_AUTH = re.compile(
    r"^AWS4-HMAC-SHA256 Credential=[^/]+/\d{8}/(?P<region>[^/]+)/(?P<service>[^/]+)/aws4_request, "
    r"SignedHeaders=(?P<signed>[^,]+), Signature=(?P<signature>[0-9a-f]{64})$")


class _Stub:
    """A stdlib HTTP server at 127.0.0.1 (a free port) answering through
    ``handler(method, path, query, headers, body) → (status, content type,
    body bytes)``; every call is logged with its time."""

    def __init__(self, handler) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlsplit

        self.calls: list = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _serve(self):
                parts = urlsplit(self.path)
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                headers = {k.lower(): v for k, v in self.headers.items()}
                call = {"method": self.command, "path": parts.path,
                        "query": dict(parse_qsl(parts.query)), "headers": headers, "body": body,
                        "at": time.monotonic()}
                stub.calls.append(call)
                status, ctype, data = handler(call)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_DELETE = _serve

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="remote-stub",
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(30)


def _b64u(data: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _rs256_token(claims: dict, kid: str = REMOTE_KID) -> str:
    """A JWT signed RS256 with the phase's key on the stdlib."""
    import hashlib

    head = _b64u(json.dumps({"alg": "RS256", "typ": "JWT", "kid": kid}).encode())
    signed = f"{head}.{_b64u(json.dumps(claims).encode())}"
    k = (REMOTE_RSA_N.bit_length() + 7) // 8
    t = bytes.fromhex("3031300d060960864801650304020105000420") + hashlib.sha256(
        signed.encode()).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), REMOTE_RSA_D, REMOTE_RSA_N).to_bytes(k, "big")
    return f"{signed}.{_b64u(sig)}"


def _remote_copy(ctx, name: str, edits: dict, dst: Path) -> Path:
    """``build/remote/<name>``: the example with ``edits`` ({file: [(old,
    new)]}, every old text present) — the files under ``examples/`` stay
    as they are."""
    import shutil

    app = dst / name
    shutil.rmtree(app, ignore_errors=True)
    shutil.copytree(ROOT / "examples" / "applications" / name, app)
    for file, pairs in edits.items():
        text = (app / file).read_text()
        for old, new in pairs:
            if old not in text:
                raise AssertionError(f"remote: the example's {name}/{file} changed "
                                     f"({old.strip()!r} not found); update the phase")
            text = text.replace(old, new)
        (app / file).write_text(text)
    return app


def _remote_files(ctx, dst: Path, secrets: dict) -> tuple[Path, Path]:
    """The instance (llama-3-8b) and a secrets file: the example's
    ``google`` client id and ``secrets`` ({id: {key: value}})."""
    from langstream_tpu_torch.core.yaml_reader import safe_load

    example = safe_load((ROOT / "examples" / "secrets" / "secrets.yaml").read_text())
    google = next(s for s in example["secrets"] if s["id"] == "google")["data"]
    lines = ["secrets:"]
    for sid, data in {"google": google, **secrets}.items():
        lines += [f"  - id: {sid}", "    data:"]
        lines += [f"      {k}: {json.dumps(str(v))}" for k, v in data.items()]
    (dst / "secrets.yaml").write_text("\n".join(lines) + "\n")
    (dst / "instance.yaml").write_text(
        "instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n"
        f"    type: local\n  globals:\n    serving-model: {_shallow_model()}\n")
    return dst / "instance.yaml", dst / "secrets.yaml"


def _serving_edit(ctx, old: str) -> tuple[str, str]:
    """The tpu-serving resource's ``max-seq-len`` raised to
    APP_MAX_SEQ_LEN, random weights from this run's seed."""
    return (old, f"        max-seq-len: {APP_MAX_SEQ_LEN}\n        weights: random\n"
                 f"        seed: {ctx['seed']}\n")


def _tap(engine) -> list:
    """Every request the engine takes, with its future and submit time."""
    taps: list = []
    submit = engine.submit

    def tapped(request):
        at = time.monotonic()
        future = submit(request)
        taps.append((request, future, at))
        return future

    engine.submit = tapped
    return taps


async def _direct_tokens(engine, requests: list) -> list:
    """The direct path: the app's requests (prompt tokens and options)
    submitted straight to the engine, all at once → each one's tokens."""
    import asyncio

    from langstream_tpu_torch.serving.engine import GenerationRequest

    submitted = [engine.submit(GenerationRequest(prompt_tokens=list(r.prompt_tokens),
                                                 options=r.options)) for r in requests]
    results = await asyncio.get_running_loop().run_in_executor(
        None, lambda: [s.result(timeout=900) for s in submitted])
    return [r.tokens for r in results]


async def _served_app(ctx, app_dir: Path, instance: Path, secrets: Path, name: str):
    """``run local``'s code: the app started, its engine built and warm."""
    import asyncio

    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.cli.main import start_local

    t0 = time.monotonic()
    app = await start_local(app_dir, instance, secrets, name=name, gateway_port=0,
                            metrics_port=-1)
    svc = app.runner._service_registry.get_provider().holder
    engine = await asyncio.get_running_loop().run_in_executor(None, svc.engine)
    await svc.get_chat_completions([ChatMessage("user", "warm up")], {"max-tokens": 4})
    return app, svc, engine, time.monotonic() - t0


async def _remote_auth(ctx, dst: Path) -> dict:
    """(a) gateway-authentication: Google sign-in against a JWKS stub in
    front of the chat on the card."""
    import asyncio
    import base64

    import torch

    from langstream_tpu_torch.auth import RsaPublicKey, _verify_rs256
    from langstream_tpu_torch.core.yaml_reader import safe_load
    from langstream_tpu_torch.gateway.websocket import HandshakeError, connect
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    jwks = {"keys": [{"kty": "RSA", "kid": REMOTE_KID, "alg": "RS256",
                      "n": _b64u(REMOTE_RSA_N.to_bytes(256, "big")),
                      "e": _b64u(REMOTE_RSA_E.to_bytes(3, "big"))}]}
    stub = _Stub(lambda call: (200, "application/json", json.dumps(jwks).encode()))
    name = "smoke-auth"
    try:
        app_dir = _remote_copy(ctx, "gateway-authentication", {
            "configuration.yaml": [_serving_edit(ctx, "        max-seq-len: 512\n")],
            "gateways.yaml": [('        client-id: "${secrets.google.client-id}"\n',
                               '        client-id: "${secrets.google.client-id}"\n'
                               f'        certs-uri: "{stub.base}/certs"\n')],
        }, dst)
        instance, secrets = _remote_files(ctx, dst, {})
        client_id = next(s for s in safe_load(secrets.read_text())["secrets"]
                         if s["id"] == "google")["data"]["client-id"]
        app, svc, engine, start_s = await _served_app(ctx, app_dir, instance, secrets, name)
        try:
            cfg = svc.model_config
            now = time.time()

            def claims(sub: str, **over) -> dict:
                return {"sub": sub, "aud": client_id, "iss": "https://accounts.google.com",
                        "email": f"{sub}@example.com", "exp": now + 900, **over}

            good = _rs256_token(claims("user-0"))
            head, body, sig = good.split(".")
            tampered = f"{head}.{body}.{sig[:-4]}{'AAAA' if sig[-4:] != 'AAAA' else 'BBBB'}"
            refused_queries = {
                "tampered signature": f"credentials={tampered}",
                "expired": f"credentials={_rs256_token(claims('user-x', exp=now - 60))}",
                "wrong audience": f"credentials={_rs256_token(claims('user-x', aud='other'))}",
                "unknown kid": f"credentials={_rs256_token(claims('user-x'), kid='other')}",
                "test-credentials": "test-credentials=anything",
            }
            questions = _prompts(APP_BYTES, ctx["seed"] + 41)
            subjects = [f"user-{i}" for i in range(len(questions))]
            tokens = [_rs256_token(claims(s)) for s in subjects]
            base = f"{app.gateway.ws_url}/v1/chat/default/{name}/chat"
            taps = _tap(engine)
            torch.cuda.synchronize()
            before = engine.stats()
            reset_kernel_counts()
            refused = {}
            for label, query in refused_queries.items():
                try:
                    ws = await connect(f"{base}?{query}")
                    await ws.close()
                    refused[label] = "open"
                except HandshakeError as e:
                    refused[label] = e.status
            taps_after_refusals = len(taps)

            async def ask(subject: str, token: str, question: str) -> dict:
                t0 = time.monotonic()
                ws = await connect(f"{base}?credentials={token}")
                connected = time.monotonic()
                await ws.send_str(json.dumps({"value": question}))
                msg = await asyncio.wait_for(ws.receive(), APP_MESSAGE_S)
                first = time.monotonic()
                await ws.close()
                if msg.kind != "text":
                    raise AssertionError(f"remote auth: {subject}'s socket closed ({msg.data})")
                record = json.loads(msg.data)["record"]
                return {"subject": subject, "headers": record["headers"],
                        "value": json.loads(record["value"]), "connect_ms": (connected - t0) * 1e3,
                        "connect_to_answer_s": first - t0, "question": question}

            t_run = time.monotonic()
            answers = await asyncio.gather(*(ask(s, t, q) for s, t, q in
                                             zip(subjects, tokens, questions)))
            wall = time.monotonic() - t_run
            counts = kernel_counts()
            after = engine.stats()
            served = [(r, f.result(timeout=60)) for r, f, _ in taps]
            taps.clear()
            direct = await _direct_tokens(engine, [r for r, _ in served])
            params = svc.params()
            # the verifier's own cost: the stdlib RSA check of one token
            key = RsaPublicKey(REMOTE_RSA_N, REMOTE_RSA_E)
            signed, _, sig64 = good.rpartition(".")
            signature = base64.urlsafe_b64decode(sig64 + "=" * (-len(sig64) % 4))
            t0 = time.perf_counter()
            for _ in range(200):
                ok = _verify_rs256(key, signature, signed.encode())
            verify_ms = (time.perf_counter() - t0) * 1e3 / 200
        finally:
            await app.stop()
    finally:
        stub.close()
    problems = []
    if not ok:
        problems.append("the stdlib RSA check refused a good token")
    if any(v != 401 for v in refused.values()) or taps_after_refusals:
        problems.append(f"refused connects: {refused}, {taps_after_refusals} engine requests")
    by_prompt = {svc.tokenizer.decode(req.prompt_tokens): (req, result)
                 for req, result in served}
    for a in answers:
        if a["headers"].get("langstream-user") != a["subject"]:
            problems.append(f"{a['subject']}: langstream-user {a['headers'].get('langstream-user')}")
        owner = [k for k in by_prompt if a["question"] in k]
        if len(owner) != 1:
            problems.append(f"{a['subject']}: {len(owner)} engine requests carry its question")
            continue
        req, result = by_prompt[owner[0]]
        if a["value"].get("answer") != svc.tokenizer.decode(result.tokens):
            problems.append(f"{a['subject']}: the answer is not its request's tokens")
        if result.finish_reason not in ("length", "stop") or result.error is not None:
            problems.append(f"{a['subject']} ended {result.finish_reason}: {result.error}")
    if len(served) != len(questions):
        problems.append(f"{len(served)} engine requests for {len(questions)} questions")
    prompts = [list(r.prompt_tokens) for r, _ in served]
    got = [res.tokens for _, res in served]
    same = _same_or_tie(ctx, cfg, params, "remote-auth", prompts, got, direct)
    if not same["ok"]:
        problems.append(f"answers differ from the direct path beyond one-ulp ties: "
                        f"{same['not_ties']}")
    run = _launch_check(cfg, counts, before, after, problems)
    run.update({
        "requests": len(questions), "refused": refused, "jwks_fetches": len(stub.calls),
        "prompt_tokens": [len(p) for p in prompts], "answer_tokens": [len(t) for t in got],
        "connect_ms": [a["connect_ms"] for a in answers],
        "connect_to_answer_s": [a["connect_to_answer_s"] for a in answers],
        "wall_s": wall, "answer_tokens_per_s": sum(len(t) for t in got) / wall,
        "verify_ms_per_token": verify_ms, "start_s": start_s,
        "same_as_direct": {k: same[k] for k in ("agreement", "ties", "equal")},
    })
    if problems:
        raise AssertionError("remote auth: " + "; ".join(problems)
                             + f" ({json.dumps(run)[:2000]})")
    return run


async def _remote_slack(ctx, dst: Path) -> dict:
    """(b) slack: summaries on the card, posted to a webhook stub."""
    import asyncio

    import torch

    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    def webhook(call):
        return 200, "text/plain", f"ok {len(call['body'])}".encode()

    stub = _Stub(webhook)
    name = "smoke-slack"
    try:
        app_dir = _remote_copy(ctx, "slack", {
            "configuration.yaml": [_serving_edit(ctx, "        max-seq-len: 256\n")]}, dst)
        instance, secrets = _remote_files(ctx, dst, {
            "slack": {"webhook-url": f"{stub.base}/services/T/B/X"}})
        app, svc, engine, start_s = await _served_app(ctx, app_dir, instance, secrets, name)
        try:
            cfg = svc.model_config
            pages = _prompts(APP_BYTES, ctx["seed"] + 43)
            taps = _tap(engine)
            torch.cuda.synchronize()
            before = engine.stats()
            reset_kernel_counts()
            t_run = time.monotonic()
            for i, page in enumerate(pages):
                await app.runner.produce("pages-topic", json.dumps({"text": page}),
                                         key=f"page-{i}")
            notified = await app.runner.consume("notified-topic", n=len(pages), timeout=900)
            wall = time.monotonic() - t_run
            counts = kernel_counts()
            after = engine.stats()
            served = [(r, f.result(timeout=60)) for r, f, _ in taps]
            taps.clear()
            direct = await _direct_tokens(engine, [r for r, _ in served])
            params = svc.params()
        finally:
            await app.stop()
    finally:
        stub.close()
    problems = []
    bodies = [c["body"].decode("utf-8") for c in stub.calls]
    records = [json.loads(r.value) for r in notified[:len(pages)]]
    if len(bodies) != len(pages) or len(notified) != len(pages):
        problems.append(f"{len(bodies)} webhook bodies, {len(notified)} notified records for "
                        f"{len(pages)} pages")
    for i, rec in enumerate(records):
        body = '{"text": "' + rec.get("summary", "") + '"}'
        if body not in bodies:
            problems.append(f"record {i}: no webhook body carries its summary")
        if rec.get("slack-response") != f"ok {len(body.encode())}":
            problems.append(f"record {i}: slack-response {rec.get('slack-response')!r}")
        if rec.get("text") not in pages:
            problems.append(f"record {i}: not one of the pages")
    if len(served) != len(pages):
        problems.append(f"{len(served)} engine requests for {len(pages)} pages")
    summaries = {svc.tokenizer.decode(res.tokens) for _, res in served}
    if {r.get("summary") for r in records} != summaries:
        problems.append("the summaries are not the engine's answers")
    prompts = [list(r.prompt_tokens) for r, _ in served]
    got = [res.tokens for _, res in served]
    same = _same_or_tie(ctx, cfg, params, "remote-slack", prompts, got, direct)
    if not same["ok"]:
        problems.append(f"summaries differ from the direct path beyond one-ulp ties: "
                        f"{same['not_ties']}")
    run = _launch_check(cfg, counts, before, after, problems)
    posted = [c["at"] for c in stub.calls]
    run.update({
        "pages": len(pages), "prompt_tokens": [len(p) for p in prompts],
        "answer_tokens": [len(t) for t in got], "wall_s": wall,
        "answer_tokens_per_s": sum(len(t) for t in got) / wall,
        "first_post_s": min(posted) - t_run if posted else None,
        "last_post_s": max(posted) - t_run if posted else None, "start_s": start_s,
        "same_as_direct": {k: same[k] for k in ("agreement", "ties", "equal")},
    })
    if problems:
        raise AssertionError("remote slack: " + "; ".join(problems)
                             + f" ({json.dumps(run)[:2000]})")
    return run


def _sigv4_problems(calls: list, service: str) -> list:
    """Each call's Authorization must be SigV4: the credential scope
    ``…/<region>/<service>/aws4_request``, ``host`` and ``x-amz-date``
    among the signed headers, a 64-hex signature."""
    out = []
    for c in calls:
        m = SIGV4_AUTH.match(c["headers"].get("authorization", ""))
        signed = m.group("signed").split(";") if m else []
        if (not m or m.group("region") != REMOTE_REGION or m.group("service") != service
                or "host" not in signed or "x-amz-date" not in signed
                or not c["headers"].get("x-amz-date")):
            out.append(f"{c['method']} {c['path']}: not SigV4 for {service}: "
                       f"{c['headers'].get('authorization')!r}")
    return out


async def _remote_rag_aws(ctx, dst: Path) -> dict:
    """(c) rag-aws: S3 ingest embedded on the card into the on-card store,
    then questions answered by a Bedrock stub from the retrieved context."""
    import asyncio
    import shutil
    from urllib.parse import unquote

    import numpy as np

    from langstream_tpu_torch.cli.main import start_local
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    rng = random.Random(ctx["seed"] + 47)
    objects = {f"docs/object-{i}.txt": " ".join(rng.choice(RAG_WORDS) for _ in range(
        REMOTE_OBJECT_WORDS)).encode() + b"." for i in range(REMOTE_OBJECTS)}
    chunks = await asyncio.to_thread(_rag_chunks, list(objects.values()), *REMOTE_SPLIT)

    def s3(call):
        if call["path"] == "/langstream-source" and call["query"].get("list-type") == "2":
            keys = "".join(f"<Contents><Key>{k}</Key><Size>{len(v)}</Size></Contents>"
                           for k, v in objects.items())
            return 200, "application/xml", (
                '<?xml version="1.0" encoding="UTF-8"?><ListBucketResult '
                'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><Name>langstream-source</Name>'
                f"{keys}</ListBucketResult>").encode()
        key = unquote(call["path"][len("/langstream-source/"):])
        if call["method"] == "GET" and key in objects:
            return 200, "text/plain", objects[key]
        return 404, "text/plain", b"no such key"

    answer_text = "bedrock answer from the stub"

    def bedrock(call):
        body = json.loads(call["body"])
        return 200, "application/json", json.dumps({
            "content": [{"type": "text", "text": answer_text}], "stop_reason": "end_turn",
            "usage": {"input_tokens": len(body.get("system", "")), "output_tokens": 5}}).encode()

    s3_stub, bedrock_stub = _Stub(s3), _Stub(bedrock)
    name = "smoke-rag-aws"
    store_dir = dst / "rag-aws-vectors"
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        # the example's ingest embeds ``{{ value.text }}`` of the splitter's
        # plain-string chunks (empty texts, the rows' text None, in both
        # packages): the copy structures each chunk first, as tpu-rag's
        # crawl does; the asset's dimension is the model's width (the
        # example's 32 fits no served model); the objects stay in the
        # bucket (a commit's DELETE between the source's listing and its
        # GET fails the GET, in both packages' s3-source)
        app_dir = _remote_copy(ctx, "rag-aws", {
            "configuration.yaml": [_serving_edit(ctx, "        max-seq-len: 1024\n")],
            "ingest.yaml": [
                ("      dimension: 32\n", "      dimension: 4096\n"),
                ('      secret-key: "${secrets.s3.secret-key}"\n',
                 '      secret-key: "${secrets.s3.secret-key}"\n      delete-objects: false\n'),
                ("      chunk_overlap: 40\n", "      chunk_overlap: 40\n"
                 "  - name: to-structure\n    type: document-to-json\n    configuration:\n"
                 "      text-field: text\n"),
            ],
        }, dst)
        if f"chunk_size: {REMOTE_SPLIT[0]}" not in (app_dir / "ingest.yaml").read_text():
            raise AssertionError("remote: rag-aws's chunk_size changed; update REMOTE_SPLIT")
        instance, secrets = _remote_files(ctx, dst, {
            "s3": {"bucket": "langstream-source", "endpoint": s3_stub.base,
                   "access-key": "smoke-access", "secret-key": "smoke-secret"},
            "bedrock": {"region": REMOTE_REGION, "endpoint": bedrock_stub.base,
                        "access-key": "smoke-access", "secret-key": "smoke-secret"},
            "vector-database": {"path": str(store_dir)},
        })
        reset_kernel_counts()
        t_start = time.monotonic()
        app = await start_local(app_dir, instance, secrets, name=name, gateway_port=0,
                                metrics_port=-1)
        try:
            registry = app.runner._service_registry
            store = registry.get_datasource("vdb")
            deadline = time.monotonic() + 600
            while len(store._indexes.get("aws-docs", {}).get("ids", [])) < len(chunks):
                if time.monotonic() > deadline:
                    raise AssertionError("remote rag-aws: the index never held every chunk")
                await asyncio.sleep(0.05)
            t_indexed = time.monotonic()
            await asyncio.sleep(1.0)  # nothing more may arrive
            idx = store._indexes["aws-docs"]
            stored_texts = [m["text"] for m in idx["meta"]]
            stored = idx["matrix"][:len(stored_texts)].copy()
            emb = registry.get_provider().get_embeddings_service({})
            direct = np.asarray(emb.embed(stored_texts))
            answers = []
            t_ask = time.monotonic()
            questions = [f"What do the documents say about {rng.choice(RAG_WORDS)}?"
                         for _ in range(REMOTE_QUESTIONS)]
            for k, q in enumerate(questions):
                await app.runner.produce("aws-questions", q,
                                         headers=[("langstream-client-session-id", f"q{k}")])
                got = await app.runner.consume("aws-answers", n=k + 1, timeout=300)
                answers.append(json.loads(got[k].value))
            ask_s = time.monotonic() - t_ask
            counts = kernel_counts()
        finally:
            await app.stop()
    finally:
        s3_stub.close()
        bedrock_stub.close()
    problems = _sigv4_problems(s3_stub.calls, "s3") + _sigv4_problems(bedrock_stub.calls,
                                                                       "bedrock")
    if sorted(stored_texts) != sorted(chunks):
        problems.append(f"the index holds {len(stored_texts)} rows, not the host's "
                        f"{len(chunks)} chunks")
    vec_err = float(np.linalg.norm(stored - direct, axis=1).max())
    if vec_err > EMBED_TOL:
        problems.append(f"stored vectors differ from direct encodes by up to {vec_err}")
    gets = sorted(unquote(c["path"]) for c in s3_stub.calls if c["method"] == "GET"
                  and c["path"] != "/langstream-source")
    if gets != sorted(f"/langstream-source/{k}" for k in objects):
        problems.append(f"objects fetched: {gets}")
    systems = [json.loads(c["body"]).get("system", "") for c in bedrock_stub.calls]
    if len(systems) != len(questions):
        problems.append(f"{len(systems)} Bedrock calls for {len(questions)} questions")
    for k, (q, value) in enumerate(zip(questions, answers)):
        if value.get("answer") != answer_text or value.get("question") != q:
            problems.append(f"question {k}: the answer is not the stub's")
        context = value.get("context") or []
        if not context or k >= len(systems) or not all(
                hit.get("text") and hit["text"] in systems[k] for hit in context):
            problems.append(f"question {k}: the Bedrock stub did not get its retrieved context")
    launched = {n: c["launches"] for n, c in counts.items() if c["launches"] or c["cpu_calls"]}
    if launched:
        problems.append(f"kernels ran on a path that has none: {launched}")
    run = {"objects": len(objects), "chunks": len(chunks),
           "write_path_s": t_indexed - t_start, "chunks_per_s": len(chunks) / (
               t_indexed - t_start), "questions": len(questions), "ask_s": ask_s,
           "s3_calls": len(s3_stub.calls), "bedrock_calls": len(bedrock_stub.calls),
           "stored_vs_direct_max_l2": vec_err, "tolerance_l2": EMBED_TOL,
           "context_hits": [len(a.get("context") or []) for a in answers]}
    if problems:
        raise AssertionError("remote rag-aws: " + "; ".join(problems)
                             + f" ({json.dumps(run)[:2000]})")
    return run


def phase_remote(ctx: dict) -> None:
    """gateway-authentication, slack and rag-aws on the card (module
    docstring, phase 24)."""
    import asyncio
    import gc

    import torch

    ctx.pop("params", None)  # each app's provider draws its own tree (the same seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    dst = ROOT / "build" / "remote"
    dst.mkdir(parents=True, exist_ok=True)
    runs = {}
    for label, part in (("auth", _remote_auth), ("slack", _remote_slack),
                        ("rag_aws", _remote_rag_aws)):
        t0 = time.monotonic()
        runs[label] = asyncio.run(part(ctx, dst))
        runs[label]["part_s"] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
    card = smi_line()
    a, b, c = runs["auth"], runs["slack"], runs["rag_aws"]
    for i, s in enumerate(a["connect_to_answer_s"]):
        log(f"remote auth user-{i} ({a['prompt_tokens'][i]} prompt tokens, "
            f"{a['answer_tokens'][i]} answer tokens): websocket connect to answer "
            f"{s * 1000.0:.1f} ms (the handshake with the token's check {a['connect_ms'][i]:.1f} "
            f"ms) [{card}]")
    log(f"remote auth: refused {json.dumps(a['refused'])}; {a['jwks_fetches']} JWKS fetch(es); "
        f"the stdlib RSA check {a['verify_ms_per_token']:.3f} ms a token (host); the burst "
        f"{a['wall_s']:.3f} s, {a['answer_tokens_per_s']:.1f} answer tokens/s; launches "
        f"{json.dumps({k: n for k, n in a['kernel_launches'].items() if n})} = "
        f"{a['layers']} x {a['admit_groups']} admit groups, {a['layers']} x "
        f"{a['decode_steps']} decode steps; "
        f"{a['graph_replays']} replays = {a['decode_chunks']} chunks [{card}]")
    log(f"remote slack: {b['pages']} pages summarized and posted in {b['wall_s']:.3f} s "
        f"(first post {b['first_post_s']:.3f} s, last {b['last_post_s']:.3f} s after the "
        f"first page), {b['answer_tokens_per_s']:.1f} summary tokens/s; launches "
        f"{json.dumps({k: n for k, n in b['kernel_launches'].items() if n})} = "
        f"{b['layers']} x {b['admit_groups']} admit groups, {b['layers']} x "
        f"{b['decode_steps']} decode steps; "
        f"{b['graph_replays']} replays = {b['decode_chunks']} chunks [{card}]")
    log(f"remote rag-aws: {c['objects']} S3 objects, {c['chunks']} chunks indexed "
        f"{c['write_path_s']:.3f} s after the app started ({c['chunks_per_s']:.2f} chunks/s); "
        f"{c['questions']} questions answered by the Bedrock stub in {c['ask_s']:.3f} s; "
        f"SigV4 on {c['s3_calls']} S3 and {c['bedrock_calls']} Bedrock calls; no attention "
        "kernel on this path (embeddings are computed outside any kernel, as in JAX) "
        f"[{card}]")
    run = {"auth": a, "slack": b, "rag_aws": c, "phase_s": time.monotonic() - t_phase}
    # the kernels the path launched: (a) and (b) (rag-aws launches none)
    run["kernel_launches"] = {k: a["kernel_launches"].get(k, 0) + b["kernel_launches"].get(k, 0)
                              for k in set(a["kernel_launches"]) | set(b["kernel_launches"])}
    log(f"remote phase: {run['phase_s']:.1f} s [{card}]")
    log(f"remote apps {SHALLOW_MODEL} {json.dumps(run)}")
    ctx["remote"] = run
    ctx.setdefault("summaries", []).append(("remote", {
        "auth_burst_s": a["wall_s"], "auth_refused": a["refused"],
        "verify_ms_per_token": a["verify_ms_per_token"], "slack_wall_s": b["wall_s"],
        "rag_aws_write_path_s": c["write_path_s"], "phase_s": run["phase_s"],
        "launches": {k: n for k, n in run["kernel_launches"].items() if n}}))
    gc.collect()
    torch.cuda.empty_cache()


# the python phase: apps whose steps are user Python in child processes over
# gRPC (module docstring, phase 25)
PYTHON_NAME = "smoke-python"
PYTHON_NEW = 64  # the served app's completions step asks for 64 new tokens
PYTHON_RECORDS = 16  # python-agent's records
PYTHON_TICKS = 10  # python-source-sink's countdown (the example's count)
PYTHON_RTT_SINGLE = 200  # process round trips of one record
PYTHON_RTT_BATCH = (50, 64)  # round trips of a batch of 64 short records
PYTHON_CHILD_TIMEOUT_S = 60
PYTHON_SCHEMA = {"type": "record", "name": "Answer", "namespace": "smoke", "fields": [
    {"name": "question", "type": "string"}, {"name": "answer", "type": "string"},
    {"name": "n", "type": "long"}]}
PYTHON_N_EDIT = 1000  # the compute step adds this to ``n``
# the served app's user code, written under build/python/served/python/ (it
# imports the SDK under the JAX package's paths, as user code does: the port's
# child answers them with the port's modules)
PYTHON_STEPS = '''"""User steps of the python phase's served app (written by chip_smoke.py)."""

import asyncio
import importlib
import json
import os
import sys

from langstream_tpu.api.agent import AgentSink, AgentSource, SingleRecordProcessor
from langstream_tpu.api.avro import AvroValue, parse_schema
from langstream_tpu.api.record import SimpleRecord


def probe(configuration, role):
    """Append what this child has loaded to the probe file: the modules whose
    file lies under the JAX package, torch, the card's visibility."""
    jax_dir = configuration["jax-package"]
    files = {n: getattr(m, "__file__", None) for n, m in list(sys.modules.items())}
    row = {"role": role, "pid": os.getpid(),
           "jax_package_modules": sorted(n for n, f in files.items()
                                         if f and os.path.realpath(f).startswith(jax_dir)),
           "torch": "torch" in sys.modules,
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    with open(configuration["probe-file"], "a") as f:
        f.write(json.dumps(row) + "\\n")


class Questions(AgentSource):
    """Emits every question at once when the go file appears; records each
    commit. Loads the examples' user modules first (the probe sees them)."""

    async def init(self, configuration):
        self.c = configuration
        for path in configuration["example-paths"]:
            sys.path.insert(0, path)
        for name in configuration["example-modules"]:
            importlib.import_module(name)
        with open(configuration["questions-file"]) as f:
            self.questions = json.load(f)
        self.sent = False
        probe(configuration, "source")

    async def read(self):
        if self.sent or not os.path.exists(self.c["go-file"]):
            await asyncio.sleep(0.005)
            return []
        self.sent = True
        return [SimpleRecord.of(json.dumps({"question": q}), key=f"q{i}")
                for i, q in enumerate(self.questions)]

    async def commit(self, records):
        with open(self.c["commits-file"], "a") as f:
            for r in records:
                f.write(f"{r.key}\\n")


class WrapAvro(SingleRecordProcessor):
    """Wraps each answer into an Avro record; the first record it ever sees
    kills its process (once: the marker file)."""

    async def init(self, configuration):
        self.c = configuration
        self.schema = parse_schema(json.dumps(configuration["schema"]))
        probe(configuration, "processor")

    async def process_record(self, record):
        if not os.path.exists(self.c["marker-file"]):
            open(self.c["marker-file"], "w").close()
            os._exit(13)
        value = json.loads(record.value)
        data = {"question": value["question"], "answer": value["answer"],
                "n": int(record.key[1:])}
        return [SimpleRecord.of(AvroValue(self.schema, data), key=record.key)]


class JsonLines(AgentSink):
    """Writes each record as a JSON line: its key, the value's type, schema
    and datum."""

    async def init(self, configuration):
        self.path = configuration["path"]
        probe(configuration, "sink")

    async def write(self, record):
        v = record.value
        avro = isinstance(v, AvroValue)
        row = {"key": record.key, "type": type(v).__name__,
               "schema": v.schema.canonical() if avro else None,
               "data": v.data if avro else v}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\\n")
'''


def _python_served_copy(ctx, dst: Path, files: dict, questions: list) -> Path:
    """``build/python/served/``: the served app (a python-source, the chat on
    ``tpu-serving``, a python-processor wrapping Avro, ``compute`` editing
    ``n``, a python-sink) and its user code."""
    import shutil

    app = dst / "served"
    shutil.rmtree(app, ignore_errors=True)
    (app / "python").mkdir(parents=True)
    (app / "python" / "served_steps.py").write_text(PYTHON_STEPS)
    files["questions"].write_text(json.dumps(questions))
    common = {"jax-package": str((ROOT / "langstream_tpu").resolve()) + "/",
              "probe-file": str(files["probe"])}

    def conf(extra: dict) -> str:
        return "".join(f"      {k}: {json.dumps(v)}\n" for k, v in {**extra, **common}.items())

    examples = ROOT / "examples" / "applications"
    (app / "pipeline.yaml").write_text(
        "module: default\nid: smoke-python\nname: python steps around the served model\n"
        "topics:\n" + "".join(f"  - name: {t}\n    creation-mode: create-if-not-exists\n"
                               for t in ("questions-topic", "answers-topic", "wrapped-topic",
                                         "edited-topic"))
        + "errors:\n  retries: 5\n  on-failure: fail\npipeline:\n"
        "  - name: ask\n    type: python-source\n    output: questions-topic\n"
        "    configuration:\n      className: served_steps.Questions\n"
        + conf({"questions-file": str(files["questions"]), "go-file": str(files["go"]),
                "commits-file": str(files["commits"]),
                "example-paths": [str(examples / "python-agent" / "python"),
                                  str(examples / "python-source-sink" / "python")],
                "example-modules": ["example_agent", "trio"]})
        + "  - name: answer\n    type: ai-chat-completions\n    input: questions-topic\n"
        "    output: answers-topic\n    configuration:\n"
        '      model: "${globals.serving-model}"\n      completion-field: value.answer\n'
        f"      max-tokens: {PYTHON_NEW}\n      messages:\n        - role: user\n"
        '          content: "{{ value.question }}"\n'
        "  - name: wrap\n    type: python-processor\n    input: answers-topic\n"
        "    output: wrapped-topic\n    configuration:\n      className: served_steps.WrapAvro\n"
        + conf({"schema": PYTHON_SCHEMA, "marker-file": str(files["marker"])})
        + "  - name: edit\n    type: compute\n    input: wrapped-topic\n    output: edited-topic\n"
        "    configuration:\n      fields:\n        - name: value.n\n"
        f'          expression: "value.n + {PYTHON_N_EDIT}"\n          type: INT64\n'
        "  - name: write\n    type: python-sink\n    input: edited-topic\n"
        "    configuration:\n      className: served_steps.JsonLines\n"
        + conf({"path": str(files["sink"])}))
    (app / "configuration.yaml").write_text(
        "configuration:\n  resources:\n    - type: tpu-serving\n      name: tpu\n"
        '      configuration:\n        model: "${globals.serving-model}"\n'
        "        tokenizer: byte\n        max-batch: 8\n        decode-chunk: 16\n"
        + _serving_edit(ctx, "")[1])
    return app


class _ChildLog:
    """Every agent child the bridge starts (its class, pid, spawn to banner)
    and every Avro schema the runtime side's codecs ship or receive, per
    stream (a ``reset()`` starts a stream): patched into the port's bridge
    and codec for the phase, restored after."""

    def __init__(self) -> None:
        from langstream_tpu_torch.grpc_runtime import bridge, convert

        self.starts: list = []
        # id(codec) → one {"schemas": [(direction, id, schema)], "avro": values} a stream
        self.streams: dict = {}
        server, codec = bridge.PythonGrpcServer, convert.SchemaCodec
        self._saved = [(server, "start", server.start)] + [
            (codec, name, getattr(codec, name))
            for name in ("reset", "register", "to_value", "from_value")]
        log_ = self
        start, reset, register, to_value, from_value = (f for _, _, f in self._saved)

        async def start_(server):
            t0 = time.monotonic()
            await start(server)  # spawn, then wait for the banner
            log_.starts.append({"class": server.config["className"], "pid": server.process.pid,
                                "ms": (time.monotonic() - t0) * 1e3})

        def stream(codec) -> dict:
            return log_.streams.setdefault(id(codec), [{"schemas": [], "avro": 0}])[-1]

        def reset_(codec):
            log_.streams.setdefault(id(codec), []).append({"schemas": [], "avro": 0})
            return reset(codec)

        def register_(codec, schemas):
            schemas = list(schemas)
            stream(codec)["schemas"] += [("in", s.schema_id, s.value.decode()) for s in schemas]
            return register(codec, schemas)

        def to_value_(codec, obj, new_schemas):
            n = len(new_schemas)
            out = to_value(codec, obj, new_schemas)
            s = stream(codec)
            s["schemas"] += [("out", m.schema_id, m.value.decode()) for m in new_schemas[n:]]
            s["avro"] += out.WhichOneof("kind") == "avro_value"
            return out

        def from_value_(codec, value):
            stream(codec)["avro"] += value.WhichOneof("kind") == "avro_value"
            return from_value(codec, value)

        for (cls, name, _), new in zip(self._saved, (start_, reset_, register_, to_value_,
                                                     from_value_)):
            setattr(cls, name, new)

    def restore(self) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)

    def intern_problems(self) -> list:
        """Each stream that carried Avro values carried each schema exactly
        once; a stream that carried none carried no schema."""
        problems = []
        for codec, streams in self.streams.items():
            for i, s in enumerate(streams):
                texts = [t for _, _, t in s["schemas"]]
                if s["avro"] and (not texts or len(texts) != len(set(texts))):
                    problems.append(f"codec {codec} stream {i}: {s['avro']} Avro values, "
                                    f"schemas {s['schemas']}")
                if not s["avro"] and texts:
                    problems.append(f"codec {codec} stream {i}: schemas without Avro values")
        return problems


async def _until_file(path: Path, lines: int, timeout_s: float, what: str, app) -> float:
    """Poll ``path`` until it holds ``lines`` lines → the time it did; fail
    at once when one of the app's agents has crashed."""
    import asyncio

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if path.exists() and len(path.read_text().splitlines()) >= lines:
            return time.monotonic()
        if app.runner._failed is not None:
            raise AssertionError(f"python: {what}: an agent crashed: {app.runner._failed}")
        await asyncio.sleep(0.005)
    got = len(path.read_text().splitlines()) if path.exists() else 0
    raise AssertionError(f"python: {what}: {got} of {lines} lines in {timeout_s} s")


def _percentiles(values: list) -> dict:
    values = sorted(values)
    return {"p50": values[len(values) // 2], "p99": values[min(len(values) - 1,
                                                                int(len(values) * 0.99))]}


async def _python_agent(ctx, dst: Path, instance: Path) -> dict:
    """(a) python-agent as it stands: 16 keyed records, each value + "!!";
    then the ``process`` round trip through the bridge to the example's
    child, one record and batches of 64."""
    from langstream_tpu_torch.api.record import SimpleRecord
    from langstream_tpu_torch.cli.main import start_local
    from langstream_tpu_torch.grpc_runtime.bridge import GrpcAgentProcessor

    example = ROOT / "examples" / "applications" / "python-agent"
    app = await start_local(example, instance, name="smoke-python-agent", gateway_port=0,
                            metrics_port=-1)
    try:
        t0 = time.monotonic()
        for i in range(PYTHON_RECORDS):
            await app.runner.produce("input-topic", f"record {i}", key=f"k{i}")
        out = await app.runner.consume("output-topic", n=PYTHON_RECORDS,
                                       timeout=PYTHON_CHILD_TIMEOUT_S)
        wall = time.monotonic() - t0
    finally:
        await app.stop()
    got = [(r.key, r.value) for r in out[:PYTHON_RECORDS]]
    want = [(f"k{i}", f"record {i}!!") for i in range(PYTHON_RECORDS)]
    if got != want:
        raise AssertionError(f"python-agent: {got} != {want}")
    agent = GrpcAgentProcessor()
    await agent.init({"className": "example_agent.Exclaim", "suffix": "!!",
                      "pythonPath": str(example / "python")})
    await agent.start()
    try:
        single, batch = [], []
        for i in range(PYTHON_RTT_SINGLE):
            t = time.perf_counter()
            (result,) = await agent.process([SimpleRecord.of(f"r{i}")])
            single.append((time.perf_counter() - t) * 1e3)
            if result.records[0].value != f"r{i}!!":
                raise AssertionError(f"python-agent round trip: {result}")
        rounds, size = PYTHON_RTT_BATCH
        for i in range(rounds):
            records = [SimpleRecord.of(f"b{i}.{j}") for j in range(size)]
            t = time.perf_counter()
            results = await agent.process(records)
            batch.append((time.perf_counter() - t) * 1e3)
            if [r.records[0].value for r in results] != [f"b{i}.{j}!!" for j in range(size)]:
                raise AssertionError("python-agent batch round trip: wrong answers")
    finally:
        await agent.close()
    return {"records": len(got), "wall_s": wall, "rtt_one_ms": _percentiles(single),
            "rtt_batch64_ms": _percentiles(batch),
            "batch_records_per_s": size / (_percentiles(batch)["p50"] / 1e3)}


async def _python_source_sink(ctx, dst: Path, instance: Path) -> dict:
    """(b) python-source-sink with its sink's file under build/python/."""
    from langstream_tpu_torch.cli.main import start_local

    out = dst / "python-trio-out.txt"
    out.unlink(missing_ok=True)
    app_dir = _remote_copy(ctx, "python-source-sink", {"pipeline.yaml": [
        ('path: "/tmp/python-trio-out.txt"', f'path: "{out}"')]}, dst)
    t0 = time.monotonic()
    app = await start_local(app_dir, instance, name="smoke-python-trio", gateway_port=0,
                            metrics_port=-1)
    try:
        done = await _until_file(out, PYTHON_TICKS, PYTHON_CHILD_TIMEOUT_S, "the trio's file",
                                 app)
    finally:
        await app.stop()
    want = "".join(f"TICK-{i}\n" for i in range(PYTHON_TICKS - 1, -1, -1))
    if out.read_text() != want:
        raise AssertionError(f"python-source-sink wrote {out.read_text()!r}, not {want!r}")
    return {"ticks": PYTHON_TICKS, "start_to_last_tick_s": done - t0}


def _smi_compute_pids() -> list:
    run = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [int(p) for p in run.stdout.split() if p.strip().isdigit()]


def _card_files(pid: int) -> list:
    """The NVIDIA device files a process holds open (a CUDA context opens
    ``/dev/nvidia*``)."""
    import os

    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.append(target)
    except OSError:
        return ["unreadable"]
    return sorted(set(out))


async def _python_served(ctx, dst: Path, instance: Path, log_: "_ChildLog") -> dict:
    """(c) the served app and (d) its crash drill; (e) read while its
    children run."""
    import asyncio
    import os

    import torch

    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    files = {k: dst / f"served-{k}" for k in ("questions", "go", "commits", "marker", "sink",
                                            "probe")}
    for path in files.values():
        path.unlink(missing_ok=True)
    questions = _prompts(APP_BYTES, ctx["seed"] + 47)
    app_dir = _python_served_copy(ctx, dst, files, questions)
    app, svc, engine, start_s = await _served_app(ctx, app_dir, instance, None, PYTHON_NAME)
    try:
        cfg = svc.model_config
        taps = _tap(engine)
        torch.cuda.synchronize()
        before = engine.stats()
        reset_kernel_counts()
        t_go = time.monotonic()
        files["go"].write_text("go\n")
        t_last = await _until_file(files["sink"], len(questions), 300, "the sink's rows", app)
        wall = t_last - t_go
        counts = kernel_counts()
        after = engine.stats()
        await _until_file(files["commits"], len(questions), 60, "the source's commits", app)
        probes = [json.loads(line) for line in files["probe"].read_text().splitlines()]
        live = [p["pid"] for p in probes if os.path.exists(f"/proc/{p['pid']}")]
        smi_pids = _smi_compute_pids()
        card_files = {pid: _card_files(pid) for pid in live}
        own_files = _card_files(os.getpid())
        served = [(r, f.result(timeout=60)) for r, f, _ in taps]
        taps.clear()
        direct = await _direct_tokens(engine, [r for r, _ in served])
        params = svc.params()
    finally:
        await app.stop()
    problems = []
    rows = [json.loads(line) for line in files["sink"].read_text().splitlines()]
    keys = [r["key"] for r in rows]
    if sorted(keys) != sorted(f"q{i}" for i in range(len(questions))):
        problems.append(f"the sink's keys {keys}: not every question exactly once")
    schema = json.dumps(PYTHON_SCHEMA, separators=(",", ":"))
    from langstream_tpu_torch.api.avro import parse_schema

    canonical = parse_schema(schema).canonical()
    by_prompt = {svc.tokenizer.decode(req.prompt_tokens): (req, result)
                 for req, result in served}
    for row in rows:
        i = int(row["key"][1:])
        if row["type"] != "AvroValue" or row["schema"] != canonical:
            problems.append(f"{row['key']}: a {row['type']} of schema {row['schema']}")
            continue
        data = row["data"]
        if data["n"] != i + PYTHON_N_EDIT or data["question"] != questions[i]:
            problems.append(f"{row['key']}: n {data['n']}, question {data['question'][:20]!r}")
        owner = [k for k in by_prompt if questions[i] in k]
        if len(owner) != 1:
            problems.append(f"{row['key']}: {len(owner)} engine requests carry its question")
            continue
        req, result = by_prompt[owner[0]]
        if data["answer"] != svc.tokenizer.decode(result.tokens):
            problems.append(f"{row['key']}: the answer is not its request's tokens")
        if result.finish_reason not in ("length", "stop") or result.error is not None:
            problems.append(f"{row['key']} ended {result.finish_reason}: {result.error}")
    commits = files["commits"].read_text().splitlines()
    if sorted(commits) != sorted(f"q{i}" for i in range(len(questions))):
        problems.append(f"source commits {commits}")
    if len(served) != len(questions):
        problems.append(f"{len(served)} engine requests for {len(questions)} questions")
    prompts = [list(r.prompt_tokens) for r, _ in served]
    got = [res.tokens for _, res in served]
    same = _same_or_tie(ctx, cfg, params, "python", prompts, got, direct)
    if not same["ok"]:
        problems.append(f"answers differ from the direct path beyond one-ulp ties: "
                        f"{same['not_ties']}")
    run = _launch_check(cfg, counts, before, after, problems)
    # (d) the crash drill: the processor's first child died, a new one answered
    wraps = [p["pid"] for p in probes if p["role"] == "processor"]
    if not files["marker"].exists() or len(wraps) != 2 or wraps[0] == wraps[1]:
        problems.append(f"the crash drill: processor pids {wraps}, marker "
                        f"{files['marker'].exists()}")
    problems += log_.intern_problems()
    # (e) no JAX and no card in the children
    for p in probes:
        if p["jax_package_modules"] or p["cuda_visible_devices"] != "":
            problems.append(f"child {p['role']} {p['pid']}: JAX package modules "
                            f"{p['jax_package_modules']}, CUDA_VISIBLE_DEVICES "
                            f"{p['cuda_visible_devices']!r}")
    if any(card_files.values()):
        problems.append(f"children hold the card's device files: {card_files}")
    # nvidia-smi lists pids of the host's namespace, which may not be this
    # one's: then this process is the one entry it may list
    own_listed = os.getpid() in smi_pids
    extra = [p for p in smi_pids if p != os.getpid()] if own_listed else smi_pids[1:]
    if set(smi_pids) & set(live) or extra:
        problems.append(f"nvidia-smi's compute processes {smi_pids}: not only this one "
                        f"({os.getpid()}; children {live})")
    run.update({
        "requests": len(questions), "prompt_tokens": [len(p) for p in prompts],
        "answer_tokens": [len(t) for t in got], "wall_s": wall,
        "answer_tokens_per_s": sum(len(t) for t in got) / wall,
        "engine_ttft_ms": [res.ttft_s * 1000.0 for _, res in served],
        "start_s": start_s, "commits": len(commits), "sink_rows": len(rows),
        "processor_pids": wraps, "children_seen": probes, "live_children": live,
        "smi_compute_pids": smi_pids, "own_pid": os.getpid(), "own_pid_listed": own_listed,
        "own_card_files": own_files,
        "children_card_files": card_files,
        "schema_streams": [s for streams in log_.streams.values() for s in streams
                           if s["avro"] or s["schemas"]],
        "same_as_direct": {k: same[k] for k in ("agreement", "ties", "equal")},
    })
    if problems:
        raise AssertionError("python served: " + "; ".join(problems)
                             + f" ({json.dumps(run)[:3000]})")
    return run


def phase_python(ctx: dict) -> None:
    """python-agent, python-source-sink and a served app whose other steps
    are user Python (module docstring, phase 25)."""
    import asyncio
    import gc

    import torch

    from langstream_tpu_torch.messaging.memory import MemoryBroker

    ctx.pop("params", None)  # the served app's provider draws its own tree (the same seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    dst = ROOT / "build" / "python"
    dst.mkdir(parents=True, exist_ok=True)
    instance = dst / "instance.yaml"
    instance.write_text("instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n"
                        f"    type: local\n  globals:\n    serving-model: {_shallow_model()}\n")
    log_ = _ChildLog()
    runs = {}
    try:
        for label, part in (("agent", _python_agent), ("trio", _python_source_sink),
                            ("served", lambda c, d, i: _python_served(c, d, i, log_))):
            t0 = time.monotonic()
            # each app starts on an empty broker, as `run local` does in a new
            # process: the earlier phases' apps left records on topics of the
            # same names (the app phase's answer chunks on answers-topic)
            MemoryBroker.reset()
            runs[label] = asyncio.run(part(ctx, dst, instance))
            runs[label]["part_s"] = time.monotonic() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        log_.restore()
    card = smi_line()
    a, b, c = runs["agent"], runs["trio"], runs["served"]
    for s in log_.starts:
        log(f"python child {s['class']} pid {s['pid']}: spawn to banner {s['ms']:.1f} ms "
            f"[{card}]")
    log(f"python agent: {a['records']} records through python-agent in {a['wall_s']:.3f} s; "
        f"process round trip of one record p50 {a['rtt_one_ms']['p50']:.3f} ms p99 "
        f"{a['rtt_one_ms']['p99']:.3f} ms ({PYTHON_RTT_SINGLE} trips), of {PYTHON_RTT_BATCH[1]} "
        f"records p50 {a['rtt_batch64_ms']['p50']:.3f} ms p99 {a['rtt_batch64_ms']['p99']:.3f} "
        f"ms ({PYTHON_RTT_BATCH[0]} trips, {a['batch_records_per_s']:.0f} records/s) [{card}]")
    log(f"python trio: {b['ticks']} ticks shouted into the sink's file "
        f"{b['start_to_last_tick_s']:.3f} s after the app's start [{card}]")
    for i, ms in enumerate(c["engine_ttft_ms"]):
        log(f"python served request {i} ({c['prompt_tokens'][i]} prompt tokens, "
            f"{c['answer_tokens'][i]} answer tokens): engine ttft {ms:.1f} ms [{card}]")
    log(f"python served: {c['requests']} questions from a python-source to the python-sink "
        f"in {c['wall_s']:.3f} s, {c['answer_tokens_per_s']:.1f} answer tokens/s, the "
        f"processor's child killed once (pids {c['processor_pids']}); launches "
        f"{json.dumps({k: n for k, n in c['kernel_launches'].items() if n})} = "
        f"{c['layers']} x {c['admit_groups']} admit groups, {c['layers']} x "
        f"{c['decode_steps']} decode steps; {c['graph_replays']} replays = "
        f"{c['decode_chunks']} chunks; nvidia-smi compute pids {c['smi_compute_pids']} "
        f"(this process {c['own_pid']}, children {c['live_children']}) [{card}]")
    run = {"agent": a, "trio": b, "served": c, "children": log_.starts,
           "phase_s": time.monotonic() - t_phase, "kernel_launches": c["kernel_launches"]}
    log(f"python phase: {run['phase_s']:.1f} s [{card}]")
    log(f"python apps {SHALLOW_MODEL} {json.dumps(run)}")
    ctx["python"] = run
    ctx.setdefault("summaries", []).append(("python", {
        "spawn_to_banner_ms": [round(s["ms"], 1) for s in log_.starts],
        "rtt_one_ms": a["rtt_one_ms"], "rtt_batch64_ms": a["rtt_batch64_ms"],
        "served_wall_s": c["wall_s"], "answer_tokens_per_s": c["answer_tokens_per_s"],
        "phase_s": run["phase_s"],
        "launches": {k: n for k, n in run["kernel_launches"].items() if n}}))
    gc.collect()
    torch.cuda.empty_cache()


# the control phase: the tpu-completions app deployed, updated and deleted
# through the control plane's REST API (webservice/) while it serves
CONTROL_NEW = 64  # the copied step's max-tokens
CONTROL_SEEDS = (0, 1)  # added to this run's seed: the deploy's and the update's trees
CONTROL_PEAK_SLACK = 1 << 30  # the update's peak over round 1's
CONTROL_BASE_SLACK = 64 << 20  # memory after the delete over the baseline
CONTROL_FOLLOW_S = 120.0


def _control_copy(ctx) -> tuple[Path, Path, Path]:
    """``build/control/``: ``_app_copy``'s tpu-completions with its step
    asking ``max-tokens`` 64 and its resource's seed read from the
    instance's globals, and two instances: the deploy's and the update's
    (another seed)."""
    import shutil

    src, _ = _app_copy(ctx)
    dst = ROOT / "build" / "control"
    shutil.rmtree(dst, ignore_errors=True)
    app = dst / "tpu-completions"
    shutil.copytree(src, app)
    conf = app / "configuration.yaml"
    seed_line = f"        seed: {ctx['seed']}\n"
    text = conf.read_text()
    if seed_line not in text:
        raise AssertionError("control: _app_copy's configuration changed; update _control_copy")
    conf.write_text(text.replace(seed_line, '        seed: "${globals.serving-seed}"\n'))
    pipe = app / "pipeline.yaml"
    text = pipe.read_text()
    if "      max-new-tokens: 64\n" not in text:
        raise AssertionError("control: the example's pipeline.yaml changed; update _control_copy")
    pipe.write_text(text.replace("      max-new-tokens: 64\n",
                                 f"      max-new-tokens: 64\n      max-tokens: {CONTROL_NEW}\n"))
    instances = []
    for i, add in enumerate(CONTROL_SEEDS):
        inst = dst / f"instance-{i}.yaml"
        inst.write_text("instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n"
                        f"    type: local\n  globals:\n    serving-model: {_shallow_model()}\n"
                        f"    serving-seed: {ctx['seed'] + add}\n")
        instances.append(inst)
    return app, instances[0], instances[1]


class _ManagedApps:
    """The gateway's application provider over the control plane's runtime
    manager: each connection takes the runner the manager holds then (after
    an update, the new one; ``run local`` keeps the first deploy's)."""

    def __init__(self, runtime) -> None:
        self.runtime = runtime

    async def get_application(self, tenant: str, application_id: str):
        from langstream_tpu_torch.gateway.server import GatewayApplication

        runner = self.runtime.get_runner(tenant, application_id)
        if runner is None:
            raise KeyError(f"application {tenant}/{application_id} not found")
        return GatewayApplication(runner.application, runner.topic_runtime)

    def agent_service_uri(self, tenant: str, application_id: str, agent_id: str):
        return None


class _Follower:
    """``AdminClient.follow_logs`` read on a thread until its stream ends."""

    def __init__(self, url: str, replica: str = "") -> None:
        from langstream_tpu_torch.cli.client import AdminClient

        self.entries: list = []
        self.error: list = []
        self._gen = AdminClient(url).follow_logs(APP_NAME, replica)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        try:
            for entry in self._gen:
                self.entries.append(entry)
        except Exception as e:  # noqa: BLE001 — reported by ended()
            self.error.append(repr(e))

    def ended(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()


def _settled_bytes(torch) -> int:
    """Allocated bytes once garbage is collected and the cuBLAS workspaces
    are dropped: cuBLAS keeps one a (handle, stream) for the process, and a
    new engine's streams add theirs (PyTorch's own leak check clears them
    before it reads, as here)."""
    import gc

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _live_blocks(torch, top: int = 8) -> list:
    """The sizes of the largest blocks still allocated, largest first."""
    sizes = [b["size"] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
             if b["state"] == "active_allocated"]
    return sorted(sizes, reverse=True)[:top]


def _served_step_ms(engine) -> float:
    """The mean wall of the served decode steps since the histograms were
    last reset (``engine_decode_step_s``)."""
    h = engine.stats()["histograms"]["engine_decode_step_s"]
    return h["sum"] / max(h["count"], 1) * 1000.0


async def _control_round(ctx, runtime, gateway, questions, label: str, t_ref: float) -> dict:
    """One deploy's serving: the provider's engine built (drawn and
    captured) off the loop, then the 8 questions over chat websockets, the
    launches exact, every answer the text of its request's tokens; then
    the same questions sent straight to the provider with the log hub
    attached and detached (the decode step's wall each way)."""
    import asyncio

    import torch

    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.runtime.log_stream import install_hub, remove_hub

    runner = runtime.get_runner("default", APP_NAME)
    svc = runner._service_registry.get_provider().holder
    loop = asyncio.get_running_loop()
    t0 = time.monotonic()
    engine = await loop.run_in_executor(None, svc.engine)  # draws, builds, captures
    engine_s = time.monotonic() - t0
    cfg = svc.model_config
    taps: list = []
    submit = engine.submit

    def tapped(request):
        future = submit(request)
        taps.append((request, future))
        return future

    engine.submit = tapped
    prompts = [svc.tokenizer.encode(svc._render_prompt([ChatMessage("user", q)]))
               for q in questions]
    problems: list = []
    try:
        torch.cuda.synchronize()
        before = engine.stats()
        reset_kernel_counts()
        t_run = time.monotonic()
        chats = await asyncio.gather(*(
            _app_chat(gateway.ws_url, f"{label}{i}", q) for i, q in enumerate(questions)))
        wall = time.monotonic() - t_run
        counts = kernel_counts()
        after = engine.stats()
        served = {tuple(r.prompt_tokens): f.result(timeout=60) for r, f in taps}
        taps.clear()
        launch = _launch_check(cfg, counts, before, after, problems)
        tokens = []
        for i, (chat, prompt) in enumerate(zip(chats, prompts)):
            result = served.get(tuple(prompt))
            if result is None:
                problems.append(f"{label}{i}: its prompt never reached the engine")
                continue
            if result.finish_reason not in ("length", "stop") or result.error is not None:
                problems.append(f"{label}{i} ended {result.finish_reason}: {result.error}")
            if chat["text"] != svc.tokenizer.decode(result.tokens):
                problems.append(f"{label}{i}: the chunks are not the text of its tokens")
            tokens.append(result.tokens)
        # the decode step's wall with the app's log hub attached, then without
        step_ms = {}
        for hub in ("on", "off"):
            if hub == "off":
                remove_hub(runner._log_handler)
            try:
                engine.reset_histograms()
                await asyncio.gather(*(
                    svc.get_chat_completions([ChatMessage("user", q)],
                                             {"max-tokens": CONTROL_NEW}) for q in questions))
                step_ms[hub] = _served_step_ms(engine)
            finally:
                if hub == "off":
                    runner._log_handler = install_hub(runner.log_hub)
        taps.clear()
    finally:
        del engine.submit  # the class's method again
    first_at = min(c["sent_at"] + c["ttft_s"] for c in chats)
    n_tokens = sum(len(t) for t in tokens)
    return {
        "problems": problems,
        "tokens": tokens,
        "replica_tags": [f"{r.node.id}-{r.replica}" for r in runner.runners],
        "engine_thread": engine._thread,
        "run": {
            "engine_build_s": engine_s,
            "client_ttft_s": [c["ttft_s"] for c in chats],
            "answer_tokens": [len(t) for t in tokens],
            "wall_s": wall,
            "answer_tokens_per_s": n_tokens / wall,
            "to_first_token_s": first_at - t_ref,
            "decode_step_ms_hub_on": step_ms["on"],
            "decode_step_ms_hub_off": step_ms["off"],
            **{k: launch[k] for k in ("layers", "admit_groups", "decode_steps",
                                      "decode_chunks", "graph_replays", "kernel_launches")},
        },
    }


def _log_problems(label: str, follower: _Follower, tags: list, problems: list) -> dict:
    entries = follower.entries
    seqs = [e["seq"] for e in entries]
    runner_lines = [e for e in entries if e["replica"] in tags and "completion" in e["message"]]
    ambient = [e for e in entries if e["replica"] == "app" and (
        "serving memory plan" in e["message"] or "captured" in e["message"])]
    if follower.error:
        problems.append(f"{label} logs: the follow failed: {follower.error}")
    if not runner_lines:
        problems.append(f"{label} logs: no line of a runner task tagged {tags}")
    if not ambient:
        problems.append(f"{label} logs: no ambient engine build / capture line tagged app")
    if len(set(seqs)) != len(seqs):
        problems.append(f"{label} logs: duplicate seq")
    return {"lines": len(entries), "runner_lines": len(runner_lines),
            "ambient_engine_lines": len(ambient)}


async def _control_run(ctx, app_dir: Path, instances: tuple, questions: list) -> dict:
    import asyncio
    import gc
    import shutil
    import weakref

    import torch

    from langstream_tpu_torch.cli.client import AdminClient, AdminClientError
    from langstream_tpu_torch.gateway.server import GatewayServer
    from langstream_tpu_torch.webservice.server import ControlPlaneServer
    from langstream_tpu_torch.webservice.service import make_local_service

    root = ROOT / "build" / "control" / "root"
    shutil.rmtree(root, ignore_errors=True)
    applications, tenants, runtime = make_local_service(str(root))
    server = ControlPlaneServer(applications, tenants, port=0)
    await server.start()
    gateway = GatewayServer(_ManagedApps(runtime), port=0)
    await gateway.start()
    client = AdminClient(server.url)
    loop = asyncio.get_running_loop()
    problems: list = []
    out: dict = {"memory": {}}
    mem = out["memory"]
    try:
        mem["baseline_bytes"] = _settled_bytes(torch)
        torch.cuda.reset_peak_memory_stats()
        # 1. deploy over HTTP (a multipart zip with its instance)
        t_deploy = time.monotonic()
        body = await loop.run_in_executor(None, client.deploy, APP_NAME, app_dir, instances[0])
        out["deploy_http_s"] = time.monotonic() - t_deploy
        if body.get("application-id") != APP_NAME or not body.get("code-archive-id"):
            problems.append(f"deploy answered {body}")
        follow1 = _Follower(server.url)
        r1 = await _control_round(ctx, runtime, gateway, questions, "d", t_deploy)
        problems += [f"round 1: {p}" for p in r1["problems"]]
        mem["round1_peak_bytes"] = torch.cuda.max_memory_allocated()
        tags = r1["replica_tags"]
        narrow = _Follower(server.url, replica=tags[0])
        described = await loop.run_in_executor(None, client.get, APP_NAME)
        listed = await loop.run_in_executor(None, client.list)
        if described.get("status", {}).get("status") != "DEPLOYED":
            problems.append(f"apps get: {json.dumps(described)[:300]}")
        if [a["application-id"] for a in listed] != [APP_NAME]:
            problems.append(f"apps list: {listed}")
        old_engine = weakref.ref(runtime.get_runner("default", APP_NAME)._service_registry
                                 .get_provider().holder._engine)
        old_thread = r1.pop("engine_thread")
        # 4. update: the same zip, another seed in the instance
        torch.cuda.reset_peak_memory_stats()
        t_update = time.monotonic()
        body = await loop.run_in_executor(
            None, lambda: client.deploy(APP_NAME, app_dir, instances[1], update=True))
        out["update_http_s"] = time.monotonic() - t_update
        if not follow1.ended(CONTROL_FOLLOW_S) or not narrow.ended(CONTROL_FOLLOW_S):
            problems.append("the old run's log streams did not end at the update")
        out["logs"] = _log_problems("round 1", follow1, tags, problems)
        wrong = [e for e in narrow.entries if e["replica"] != tags[0]]
        if wrong or not narrow.entries:
            problems.append(f"--filter={tags[0]}: {len(narrow.entries)} lines, "
                            f"{len(wrong)} of another replica")
        out["logs"]["filtered_lines"] = len(narrow.entries)
        if old_thread.is_alive():
            problems.append("the old engine's thread still runs after the update")
        if old_engine() is not None:
            problems.append("the old engine is still referenced after the update")
        follow2 = _Follower(server.url)
        r2 = await _control_round(ctx, runtime, gateway, questions, "u", t_update)
        problems += [f"round 2: {p}" for p in r2["problems"]]
        mem["update_peak_bytes"] = torch.cuda.max_memory_allocated()
        engines = [t for t in threading.enumerate() if t.name == "serving-engine"]
        if len(engines) != 1:
            problems.append(f"{len(engines)} engine threads serve after the update")
        if r1["tokens"] == r2["tokens"]:
            problems.append("every answer of the updated app equals round 1's: the old tree "
                            "served")
        if mem["update_peak_bytes"] > mem["round1_peak_bytes"] + CONTROL_PEAK_SLACK:
            problems.append(f"the update peaked at {mem['update_peak_bytes']} bytes, over round "
                            f"1's {mem['round1_peak_bytes']} + 1 GiB")
        r2.pop("engine_thread")
        # 5. delete
        t0 = time.monotonic()
        body = await loop.run_in_executor(None, client.delete, APP_NAME)
        out["delete_http_s"] = time.monotonic() - t0
        if body != {"deleted": APP_NAME}:
            problems.append(f"delete answered {body}")
        gc.collect()
        torch.cuda.empty_cache()
        mem["after_delete_with_workspaces_bytes"] = torch.cuda.memory_allocated()
        mem["after_delete_bytes"] = _settled_bytes(torch)
        out["live_blocks_after_delete"] = _live_blocks(torch)
        if abs(mem["after_delete_bytes"] - mem["baseline_bytes"]) > CONTROL_BASE_SLACK:
            problems.append(f"{mem['after_delete_bytes']} bytes allocated after the delete, "
                            f"{mem['baseline_bytes']} before the deploy (live blocks "
                            f"{out['live_blocks_after_delete']})")
        try:
            await loop.run_in_executor(None, client.get, APP_NAME)
            problems.append("apps get still answers after the delete")
        except AdminClientError as e:
            if e.status != 404:
                problems.append(f"apps get after the delete: {e}")
        if not follow2.ended(CONTROL_FOLLOW_S):
            problems.append("the log stream did not end at the delete")
        out["logs_round2"] = _log_problems("round 2", follow2, r2["replica_tags"], problems)
        out["round1"], out["round2"] = r1["run"], r2["run"]
        out["answers_differing"] = sum(a != b for a, b in zip(r1["tokens"], r2["tokens"]))
    finally:
        await gateway.stop()
        await runtime.close()
        await server.stop()
    if problems:
        raise AssertionError("control: " + "; ".join(problems) + f" ({json.dumps(out)[:2000]})")
    return out


def phase_control(ctx: dict) -> None:
    """The tpu-completions app deployed, chatted with, followed, updated
    and deleted through the control plane (module docstring, phase 26)."""
    import asyncio
    import gc

    import torch

    from langstream_tpu_torch.messaging.memory import MemoryBroker

    ctx.pop("params", None)  # each deploy's provider draws its own tree
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    app_dir, first, second = _control_copy(ctx)
    MemoryBroker.reset()  # an empty broker, as a new control plane process starts
    run = asyncio.run(_control_run(ctx, app_dir, (first, second),
                                   _prompts(APP_BYTES, ctx["seed"])))
    run["phase_s"] = time.monotonic() - t_phase
    card = smi_line()
    gib = 1 << 30
    m = run["memory"]
    for label in ("round1", "round2"):
        r = run[label]
        log(f"control {label}: client ttft ms "
            f"{[round(s * 1000.0, 1) for s in r['client_ttft_s']]}, {sum(r['answer_tokens'])} "
            f"answer tokens in {r['wall_s']:.3f} s = {r['answer_tokens_per_s']:.1f} tokens/s; "
            f"engine draw + capture {r['engine_build_s']:.2f} s; "
            f"{'deploy' if label == 'round1' else 'update'} to first token "
            f"{r['to_first_token_s']:.2f} s; decode step wall {r['decode_step_ms_hub_on']:.3f} ms "
            f"with the log hub, {r['decode_step_ms_hub_off']:.3f} ms without; launches "
            f"{json.dumps({k: n for k, n in r['kernel_launches'].items() if n})} = "
            f"{r['layers']} x {r['admit_groups']} admit groups, {r['layers']} x "
            f"{r['decode_steps']} decode steps; "
            f"{r['graph_replays']} replays = {r['decode_chunks']} chunks [{card}]")
    log(f"control http: deploy {run['deploy_http_s']:.3f} s, update {run['update_http_s']:.3f} "
        f"s, delete {run['delete_http_s']:.3f} s [{card}]")
    log(f"control memory: baseline {m['baseline_bytes'] / gib:.3f} GiB, round 1 peak "
        f"{m['round1_peak_bytes'] / gib:.3f} GiB, update + round 2 peak "
        f"{m['update_peak_bytes'] / gib:.3f} GiB, after the delete "
        f"{m['after_delete_with_workspaces_bytes']} bytes with the cuBLAS workspaces, "
        f"{m['after_delete_bytes']} without (baseline {m['baseline_bytes']}; largest live "
        f"blocks {run['live_blocks_after_delete']}) [{card}]")
    log(f"control logs: {json.dumps(run['logs'])}, after the update "
        f"{json.dumps(run['logs_round2'])}; {run['answers_differing']} of {len(APP_BYTES)} "
        "answers differ after the update")
    log(f"control phase: {run['phase_s']:.1f} s [{card}]")
    log(f"control tpu-completions {SHALLOW_MODEL} {json.dumps(run)}")
    ctx["control"] = {**run, "kernel_launches": {
        k: run["round1"]["kernel_launches"][k] + run["round2"]["kernel_launches"][k]
        for k in run["round1"]["kernel_launches"]}}
    ctx.setdefault("summaries", []).append(("control", {
        "deploy_http_s": run["deploy_http_s"], "update_http_s": run["update_http_s"],
        "deploy_to_first_token_s": run["round1"]["to_first_token_s"],
        "update_to_first_token_s": run["round2"]["to_first_token_s"],
        "tokens_per_s": [run["round1"]["answer_tokens_per_s"],
                         run["round2"]["answer_tokens_per_s"]],
        "decode_step_ms_hub_on_off": [run["round1"]["decode_step_ms_hub_on"],
                                      run["round1"]["decode_step_ms_hub_off"]],
        "memory_gib": {k: v / gib for k, v in m.items()}, "phase_s": run["phase_s"]}))
    gc.collect()
    torch.cuda.empty_cache()


# the brokers phase: the app phase's traffic over each broker's wire, the
# broker one of the port's fakes in a process of its own
BROKER_KINDS = ("kafka", "pulsar", "pravega")
# kafka, the production instance's broker, runs at full depth; pulsar and
# pravega at SHALLOW_LAYERS (the default run's time; nothing the phase
# checks depends on depth)
BROKER_SHALLOW = ("pulsar", "pravega")
BROKER_START_S = 60.0  # the fake's process to its first line
BROKER_STOP_S = 20.0  # stdin closed to its exit
BROKER_COMMIT_S = 10.0  # the last debug record to the questions' last commit
# record-batch sizes whose CRC-32C the phase times on the host
CRC_BYTES = (256, 4096, 65536)


class _FakeBroker:
    """One of the port's fake brokers in a child process
    (``python -m langstream_tpu_torch.messaging.fake_process``): its
    instance configuration, the committed position of a topic at the
    broker, and its stop. The child imports no torch and sees no card."""

    def __init__(self, kind: str, log_path: Path) -> None:
        import os
        import queue

        log_path.parent.mkdir(parents=True, exist_ok=True)
        self.kind = kind
        self._log = open(log_path, "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(p for p in (str(ROOT),
                                                          os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.messaging.fake_process", kind],
            cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._log, text=True)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, name=f"{kind}-fake-out", daemon=True).start()
        self.ports: list = []
        t0 = time.monotonic()
        try:
            hello = self._line(BROKER_START_S)
        except BaseException:
            self.close()
            raise
        self.start_s = time.monotonic() - t0
        self.configuration, self.ports, self.pid = (hello["configuration"], hello["ports"],
                                                     hello["pid"])

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def _line(self, timeout: float) -> dict:
        import queue

        try:
            line = self._lines.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"brokers: the {self.kind} fake said nothing in {timeout} s")
        if line is None:
            raise AssertionError(f"brokers: the {self.kind} fake exited "
                                 f"({self.proc.poll()}); see {self._log.name}")
        return json.loads(line)

    def committed(self, topic: str) -> dict:
        self.proc.stdin.write(f"committed {topic}\n")
        self.proc.stdin.flush()
        return self._line(BROKER_STOP_S)

    def close(self) -> dict:
        """Close its stdin (the fake stops its broker and exits); kill it
        past ``BROKER_STOP_S``. Reports whether it stopped, its exit code,
        and whether every port it listened on is closed."""
        t0 = time.monotonic()
        stopped = False
        try:
            self.proc.stdin.close()
            while not stopped:
                stopped = bool(self._line(BROKER_STOP_S).get("stopped"))
        except (AssertionError, OSError, ValueError):
            pass
        try:
            code = self.proc.wait(BROKER_STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            code = self.proc.wait()
        self._log.close()
        open_ports = []
        for port in self.ports:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                open_ports.append(port)
            except OSError:
                pass
        return {"stopped": stopped, "exit": code, "ports": self.ports,
                "open_ports": open_ports, "stop_s": time.monotonic() - t0,
                "ok": stopped and code == 0 and not open_ports}


async def _committed_at_broker(fake: _FakeBroker, n: int) -> dict:
    """The questions topic at the broker once its ``n`` questions are
    committed: its records, and the records each group (subscription)
    committed; ``ok`` when one group committed exactly the ``n`` records
    the topic holds. Polled for ``BROKER_COMMIT_S``: the step commits after
    its final record is written."""
    import asyncio

    t0 = time.monotonic()
    while True:
        doc = await asyncio.to_thread(fake.committed, "questions-topic")
        ok = doc.get("records") == n and list(doc.get("committed", {}).values()) == [n]
        waited = time.monotonic() - t0
        if ok or waited > BROKER_COMMIT_S:
            return {**doc, "sent": n, "waited_s": waited, "ok": ok}
        await asyncio.sleep(0.05)


def _crc_cost() -> dict:
    """Host ms of the pure-Python CRC-32C (``native.crc32c``) over a record
    batch of each ``CRC_BYTES`` size."""
    from langstream_tpu_torch.native import crc32c

    rng = random.Random(0)
    out = {}
    for n in CRC_BYTES:
        data = rng.randbytes(n)
        reps = max(3, 200_000 // n)
        t0 = time.perf_counter()
        for _ in range(reps):
            crc32c(data)
        out[n] = (time.perf_counter() - t0) * 1000.0 / reps
    return out


def phase_brokers(ctx: dict) -> None:
    """The tpu-completions app over Kafka, Pulsar and Pravega (module
    docstring, phase 27)."""
    import asyncio
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    ctx.pop("params", None)  # each run's provider draws its own tree
    gc.collect()
    torch.cuda.empty_cache()
    card = smi_line()
    t_phase = time.monotonic()
    crc = _crc_cost()
    log(f"brokers crc32c on the host (pure Python): "
        + ", ".join(f"{n} B {ms:.4f} ms" for n, ms in crc.items()))
    memory = ctx.get("app")
    runs = {}
    for kind in BROKER_KINDS:
        model = _shallow_model() if kind in BROKER_SHALLOW else "llama-3-8b"
        layers = MODEL_PRESETS[model].n_layers
        t0 = time.monotonic()
        fake = _FakeBroker(kind, ROOT / "build" / "brokers" / f"{kind}_fake.log")
        try:
            app_dir, instance = _app_copy(ctx, ROOT / "build" / "brokers" / kind, model,
                                          (kind, fake.configuration))
            ref = ctx.get("app_reference")
            reference = ref if ref and ref["layers"] == layers else None
            run = asyncio.run(_app_run(ctx, app_dir, instance, f"brokers {kind}", reference,
                                       fake))
        finally:
            stop = fake.close()
        if not stop["ok"]:
            raise AssertionError(f"brokers {kind}: the fake did not stop cleanly: {stop}")
        run.pop("_reference")
        run.update(fake=stop, fake_start_s=fake.start_s, run_s=time.monotonic() - t0,
                   reference="app phase" if reference else "direct path")
        for i, (client, engine) in enumerate(zip(run["client_ttft_s"], run["engine_ttft_ms"])):
            log(f"brokers {kind} s{i} ({run['prompt_tokens'][i]} prompt tokens, "
                f"{run['answer_tokens'][i]} answer tokens, {run['messages'][i]} messages): "
                f"client ttft {client * 1000.0:.1f} ms, engine ttft {engine:.1f} ms; send to "
                f"submit {run['inbound_ms'][i]:.1f} ms, engine end to last message "
                f"{run['outbound_ms'][i]:.1f} ms [{card}]")
        vs = (f"; memory broker (app phase): send to submit p50 "
              f"{_percentiles(memory['inbound_ms'])['p50']:.1f} ms, engine end to last "
              f"message p50 {_percentiles(memory['outbound_ms'])['p50']:.1f} ms, "
              f"{memory['answer_tokens_per_s']:.1f} tokens/s" if memory else "")
        log(f"brokers {kind} ({layers} layers): {sum(run['answer_tokens'])} answer tokens in "
            f"{run['wall_s']:.3f} s = {run['answer_tokens_per_s']:.1f} tokens/s; send to "
            f"submit p50 {_percentiles(run['inbound_ms'])['p50']:.1f} ms, engine end to last "
            f"message p50 {_percentiles(run['outbound_ms'])['p50']:.1f} ms{vs}; launches "
            f"{json.dumps({k: n for k, n in run['kernel_launches'].items() if n})} = "
            f"{layers} x {run['admit_groups']} admit groups, {layers} x "
            f"{run['decode_steps']} decode steps; {run['graph_replays']} replays = "
            f"{run['decode_chunks']} chunks; answers vs the {run['reference']} "
            f"{json.dumps(run['same_as_direct'])}; committed at the broker "
            f"{json.dumps(run['committed'])}; fake start {fake.start_s:.2f} s, stop "
            f"{stop['stop_s']:.2f} s, ports {stop['ports']} closed; run {run['run_s']:.1f} s "
            f"[{card}]")
        log(f"brokers {kind} tpu-completions {model} {json.dumps(run)}")
        ctx[f"brokers_{kind}"] = run
        runs[kind] = run
        gc.collect()
        torch.cuda.empty_cache()
    phase_s = time.monotonic() - t_phase
    log(f"brokers phase: {phase_s:.1f} s [{card}]")
    ctx.setdefault("summaries", []).append(("brokers", {
        "crc32c_ms": crc, "phase_s": phase_s,
        **{kind: {"layers": r["layers"], "tokens_per_s": r["answer_tokens_per_s"],
                  "client_ttft_s": r["client_ttft_s"],
                  "inbound_ms_p50": _percentiles(r["inbound_ms"])["p50"],
                  "outbound_ms_p50": _percentiles(r["outbound_ms"])["p50"], "run_s": r["run_s"],
                  "committed": r["committed"]["committed"]} for kind, r in runs.items()},
    }))


# the k8s phase: the production instance (examples/instances/kubernetes.yaml:
# Kafka, computeCluster kubernetes, llama-3-8b) from a REST deploy through the
# operator to pods, every role a process of its own
K8S_NAMESPACE = "langstream-default"  # the default tenant's (crds.tenant_namespace)
K8S_START_S = 120.0  # a role's process to its first line or open port
K8S_DEPLOYED_S = 120.0  # the REST deploy to the Application CR's DEPLOYED
K8S_POD_S = 180.0  # a pod's start to its /info (the chat pod imports torch)
K8S_STOP_S = 30.0  # SIGTERM (or stdin closed) to the process's exit
K8S_MEMORY_SLACK = 1 << 30  # the card's free memory after the delete against before
K8S_WARM_UP = "warm up"  # the first question, its own session, before the burst
# how the kubelet stand-in starts a container: this interpreter runs the
# container's command (``python -m <module> <args>``) under a wrapper that,
# when its stdin closes, prints one ``ROLE_REPORT <json>`` line read from the
# process itself: in a pod the kernel counts since its engine's capture, the
# engine's counters then and now, its draw and capture, and every request it
# served; in the operator its reconcile passes and watch events. The entry
# point gains nothing for it.
K8S_ROLE_WRAPPER = r'''
import json, runpy, sys, threading, time

mode, module, args = sys.argv[1], sys.argv[3], sys.argv[4:]
report = {"starts": 0}
KEYS = ("admit-groups-total", "decode-steps-total", "prefill-segments-total",
        "decode-chunks-total", "graph-replays-total", "engine-restarts-total")
if mode == "pod":
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.ops import attention
    from langstream_tpu_torch.serving.engine import ServingEngine

    engines, served = [], []
    build, start, submit = (TorchCompletionsService.engine, ServingEngine.start,
                            ServingEngine.submit)

    def engine(self):
        first = self._engine is None
        t0 = time.monotonic()
        out = build(self)
        if first:
            report["draw_and_capture_s"] = time.monotonic() - t0
        return out

    def started(self):
        start(self)
        attention.reset_kernel_counts()
        report["starts"] += 1
        engines.append((self, {k: self.stats()[k] for k in KEYS}))

    def submitted(self, request):
        at = time.monotonic()
        future = submit(self, request)
        served.append((request, future, at))
        return future

    TorchCompletionsService.engine = engine
    ServingEngine.start, ServingEngine.submit = started, submitted

    def read():
        out = {"kernels": attention.kernel_counts(), "served": []}
        if engines:
            engine, before = engines[0]
            stats = engine.stats()
            out.update(before=before, after={k: stats[k] for k in KEYS})
        for request, future, at in served:
            r = future.result(timeout=60)
            out["served"].append({
                "prompt": list(request.prompt_tokens), "tokens": list(r.tokens),
                "submit_at": at, "ttft_s": r.ttft_s, "total_s": r.total_s,
                "finish_reason": r.finish_reason, "error": repr(r.error) if r.error else None})
        return out
elif mode == "operator":
    from langstream_tpu_torch.k8s.client import KubeApiClient

    report.update(passes=0, watch_events=0)
    listed, watched = KubeApiClient.list, KubeApiClient.watch

    def counted_list(self, kind, namespace=None):
        if kind == "Application":
            report["passes"] += 1
        return listed(self, kind, namespace)

    def counted_watch(self, *a, **k):
        for event in watched(self, *a, **k):
            report["watch_events"] += 1
            yield event

    KubeApiClient.list, KubeApiClient.watch = counted_list, counted_watch

    def read():
        return {}


def on_eof():
    sys.stdin.read()
    print("ROLE_REPORT " + json.dumps({**report, **read()}), flush=True)


threading.Thread(target=on_eof, name="role-report", daemon=True).start()
sys.argv = [module, *args]
runpy.run_module(module, run_name="__main__", alter_sys=True)
'''


class _Role:
    """One role of the deployment in a process of its own: a container's
    ``command`` (``python`` is this interpreter) with its env, optionally
    under ``K8S_ROLE_WRAPPER`` in ``wrap`` mode; its stderr in ``log_path``,
    its stdout lines on a queue."""

    def __init__(self, name: str, command: list, env: dict, log_path: Path,
                 wrap: str | None = None) -> None:
        import os
        import queue

        log_path.parent.mkdir(parents=True, exist_ok=True)
        self.name = name
        self._log = open(log_path, "w")
        argv = [sys.executable if command[0] == "python" else command[0], *command[1:]]
        if wrap is not None:
            if argv[1] != "-m":
                raise AssertionError(f"k8s: {name}'s command {command} runs no module")
            argv = [sys.executable, "-c", K8S_ROLE_WRAPPER, wrap, *argv[1:]]
        path = os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(argv, cwd=ROOT, env={**os.environ, "PYTHONPATH": path,
                                                          **env},
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self._log, text=True)
        self.pid = self.proc.pid
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, name=f"{name}-out", daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def line(self, timeout: float, prefix: str = "") -> str:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"k8s: {self.name} printed no {prefix!r} line in "
                                     f"{timeout} s; see {self._log.name}")
            if line is None:
                raise AssertionError(f"k8s: {self.name} exited ({self.proc.poll()}); see "
                                     f"{self._log.name}")
            if line.startswith(prefix):
                return line[len(prefix):]

    def report(self) -> dict:
        """Close its stdin: the wrapper prints its report line."""
        self.proc.stdin.close()
        return json.loads(self.line(K8S_STOP_S, "ROLE_REPORT "))

    def stop(self) -> dict:
        """SIGTERM, as a kubelet stops a container; killed past
        ``K8S_STOP_S``. The exit code and the seconds to the exit."""
        t0 = time.monotonic()
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            code = self.proc.wait(K8S_STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            code = self.proc.wait()
            code = f"killed after {K8S_STOP_S} s ({code})"
        if not self._log.closed:
            self._log.close()
        return {"exit": code, "stop_s": time.monotonic() - t0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_open(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
        return True
    except OSError:
        return False


def _wait(pred, timeout: float, what: str, role: "_Role | None" = None) -> float:
    """Seconds until ``pred()``; fails past ``timeout`` or when ``role``'s
    process has exited."""
    t0 = time.monotonic()
    while not pred():
        if role is not None and role.proc.poll() is not None:
            raise AssertionError(f"k8s: {role.name} exited ({role.proc.poll()}) before {what}")
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"k8s: {what} not within {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def _k8s_copy(ctx, fake: "_FakeBroker") -> tuple[Path, Path]:
    """``build/k8s/``: the ``app`` phase's tpu-completions copy with one card
    (``resources.tpu``) on its chat step, and the production instance's
    shape: ``streamingCluster`` Kafka (the fake), ``computeCluster``
    kubernetes, llama-3-8b."""
    from langstream_tpu_torch.core.yaml_reader import safe_dump

    app, instance = _app_copy(ctx, ROOT / "build" / "k8s", "llama-3-8b",
                              ("kafka", fake.configuration))
    pipeline = app / "pipeline.yaml"
    step = "  - name: chat\n    type: ai-chat-completions\n"
    if step not in pipeline.read_text():
        raise AssertionError("k8s: the example's pipeline.yaml changed; update _k8s_copy")
    pipeline.write_text(pipeline.read_text().replace(
        step, step + '    resources:\n      tpu:\n        topology: "1"\n'))
    instance.write_text(safe_dump({"instance": {
        "streamingCluster": {"type": "kafka", "configuration": fake.configuration},
        "computeCluster": {"type": "kubernetes"},
        "globals": {"serving-model": "llama-3-8b"}}}))
    return app, instance


def _app_objects(kube) -> dict:
    """The app's objects at the API server, by kind."""
    return {kind: sorted(m["metadata"]["name"] for m in kube.list(kind, K8S_NAMESPACE))
            for kind in ("Application", "Agent", "StatefulSet", "Service", "Secret", "Job")}


def _container_env(container: dict) -> dict:
    return {e["name"]: e["value"] for e in container.get("env", []) if "value" in e}


def _start_pods(kube, control_url: str, sts: dict, pods_dir: Path) -> list:
    """The kubelet stand-in for one StatefulSet: for each replica ordinal,
    the init container's command to its end (with the two values a cluster
    supplies: ``CONTROL_PLANE_URL`` and ``TARGET_DIR`` on a directory of
    its own), the config Secret written where the runtime container's
    ``POD_CONFIGURATION`` points (its volume under ``pods_dir``), then the
    runtime container's command as a process with ``HOSTNAME`` the pod's
    name and ``HTTP_PORT`` a free port; a container whose limits name no
    ``nvidia.com/gpu`` sees no card (``CUDA_VISIBLE_DEVICES`` empty), as the
    NVIDIA device plugin leaves it none."""
    name = sts["metadata"]["name"]
    spec = sts["spec"]["template"]["spec"]
    (init,), (runtime,) = spec["initContainers"], spec["containers"]
    (secret_volume,) = [v for v in spec["volumes"] if "secret" in v]
    secret = kube.get("Secret", K8S_NAMESPACE, secret_volume["secret"]["secretName"])
    pods = []
    for ordinal in range(int(sts["spec"]["replicas"])):
        pod = f"{name}-{ordinal}"
        root = pods_dir / pod
        mounts = {m["name"]: root / m["name"] for m in runtime["volumeMounts"]}
        for path in mounts.values():
            path.mkdir(parents=True, exist_ok=True)
        for key, text in secret["stringData"].items():
            (mounts[secret_volume["name"]] / key).write_text(text)
        paths = {m["mountPath"]: mounts[m["name"]] for m in runtime["volumeMounts"]}
        t0 = time.monotonic()
        env = {**_container_env(init), "CONTROL_PLANE_URL": control_url,
               "TARGET_DIR": str(paths["/app-code-download"]), "HOSTNAME": pod}
        init_role = _Role(f"{pod} init", init["command"], env, root / "init.log")
        code = init_role.proc.wait(K8S_START_S)
        init_role.stop()
        if code != 0:
            raise AssertionError(f"k8s: {pod}'s init container exited {code}; see "
                                 f"{root / 'init.log'}")
        init_s = time.monotonic() - t0
        env = _container_env(runtime)
        if not runtime["resources"]["limits"].get("nvidia.com/gpu"):
            # the device plugin gives a container that asks for no card none
            env["CUDA_VISIBLE_DEVICES"] = ""
        config = env["POD_CONFIGURATION"]
        mount = next(m for m in paths if config.startswith(m + "/"))
        env["POD_CONFIGURATION"] = str(paths[mount] / config[len(mount) + 1:])
        port = _free_port()
        env.update(HOSTNAME=pod, HTTP_PORT=str(port))
        role = _Role(pod, runtime["command"], env, root / "runtime.log", wrap="pod")
        pods.append({"name": pod, "statefulset": name, "role": role, "port": port,
                     "init_s": init_s, "gpus": runtime["resources"]["limits"].get(
                         "nvidia.com/gpu")})
    return pods


def _info(port: int) -> list | None:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info", timeout=2) as resp:
            return json.loads(resp.read())
    except OSError:
        return None


async def _k8s_direct(svc, questions: list, prompts: list) -> list:
    """The provider's direct path on this process's card (the tokens each
    prompt gets without a broker), for a run without the ``app`` phase's
    reference."""
    import asyncio

    from langstream_tpu_torch.ai.provider import ChatMessage

    loop = asyncio.get_running_loop()
    engine = await loop.run_in_executor(None, svc.engine)
    taps = []
    submit = engine.submit
    engine.submit = lambda request: taps.append((request, submit(request))) or taps[-1][1]
    await asyncio.gather(*(svc.get_chat_completions(
        [ChatMessage("user", q)], {"model": "llama-3-8b", "min-chunks-per-message": 10,
                                   "tenant": "default"}) for q in questions))
    served = {tuple(r.prompt_tokens): f.result(timeout=60).tokens for r, f in taps}
    return [served[tuple(p)] for p in prompts]


async def _k8s_run(ctx) -> dict:
    import asyncio
    import shutil

    import torch

    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.cli.client import AdminClient
    from langstream_tpu_torch.k8s.client import KubeApiClient
    from langstream_tpu_torch.k8s.controllers import InProcessJobExecutor
    from langstream_tpu_torch.k8s.crds import ApplicationCustomResource
    from langstream_tpu_torch.k8s.fake import FakeKubeServer
    from langstream_tpu_torch.k8s.runtime_manager import KubernetesRuntimeManager
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.webservice.server import ControlPlaneServer
    from langstream_tpu_torch.webservice.service import ApplicationService, TenantService
    from langstream_tpu_torch.webservice.stores import (
        LocalDiskApplicationStore,
        LocalDiskCodeStorage,
        LocalDiskGlobalMetadataStore,
    )

    loop = asyncio.get_running_loop()
    base = ROOT / "build" / "k8s"
    shutil.rmtree(base, ignore_errors=True)
    problems: list = []
    out: dict = {"memory": {}}
    roles: list = []  # every process this phase started, stopped in its finally
    pods: list = []
    server = None
    _settled_bytes(torch)
    out["memory"]["free_before_bytes"] = torch.cuda.mem_get_info()[0]
    fake = _FakeBroker("kafka", base / "logs" / "kafka_fake.log")
    try:
        app_dir, instance = _k8s_copy(ctx, fake)
        api = _Role("api-server fake", ["python", "-m", "langstream_tpu_torch.k8s.http_fake"],
                    {"CUDA_VISIBLE_DEVICES": ""}, base / "logs" / "api_fake.log")
        roles.append(api)
        api_url = json.loads(api.line(K8S_START_S))["url"]
        api_port = int(api_url.rsplit(":", 1)[1])
        kube = KubeApiClient(api_url)
        operator_log = base / "logs" / "operator.log"
        operator = _Role("operator", ["python", "-m", "langstream_tpu_torch.entrypoint",
                                      "operator"],
                         {"KUBE_API_SERVER": api_url, "OPERATOR_POLL_SECONDS": "2"},
                         operator_log, wrap="operator")
        roles.append(operator)
        # the control plane in this process, its runtime the operator's CRs
        root = base / "root"
        store = LocalDiskApplicationStore(f"{root}/apps")
        applications = ApplicationService(store, LocalDiskCodeStorage(f"{root}/code"),
                                          KubernetesRuntimeManager(kube, store))
        tenants = TenantService(LocalDiskGlobalMetadataStore(str(root)))
        tenants.put("default")
        server = ControlPlaneServer(applications, tenants, port=0)
        await server.start()
        gw_port = _free_port()
        gateway = _Role("gateway", ["python", "-m", "langstream_tpu_torch.entrypoint",
                                    "gateway"],
                        {"STORAGE_ROOT": str(root), "GATEWAY_PORT": str(gw_port)},
                        base / "logs" / "gateway.log")
        roles.append(gateway)
        await loop.run_in_executor(None, _wait, lambda: _port_open(gw_port), K8S_START_S,
                                   "the gateway's port", gateway)
        # the operator's first pass runs as it comes up, before the deploy
        await loop.run_in_executor(None, _wait, lambda: "operator up against" in
                                   operator_log.read_text(), K8S_START_S, "the operator",
                                   operator)
        client = AdminClient(server.url)
        # 2. the deploy over REST, 3. the operator's reconcile
        t_deploy = time.monotonic()
        body = await loop.run_in_executor(None, client.deploy, APP_NAME, app_dir, instance)
        out["deploy_http_s"] = time.monotonic() - t_deploy
        if body.get("application-id") != APP_NAME:
            problems.append(f"the deploy answered {body}")

        def deployed():
            cr = kube.get("Application", K8S_NAMESPACE, APP_NAME)
            return (cr or {}).get("status", {}).get("phase") == "DEPLOYED"

        await loop.run_in_executor(None, _wait, deployed, K8S_DEPLOYED_S,
                                   "the Application CR's DEPLOYED", operator)
        t_deployed = time.monotonic()
        out["deploy_to_deployed_s"] = t_deployed - t_deploy

        def all_statefulsets():
            agents = kube.list("Agent", K8S_NAMESPACE)
            sets = kube.list("StatefulSet", K8S_NAMESPACE)
            return agents and len(sets) == len(agents)

        await loop.run_in_executor(None, _wait, all_statefulsets, K8S_DEPLOYED_S,
                                   "a StatefulSet for every Agent CR", operator)
        out["deployed_to_statefulsets_s"] = time.monotonic() - t_deployed
        statefulsets = kube.list("StatefulSet", K8S_NAMESPACE)
        agents = {a["metadata"]["name"]: a for a in kube.list("Agent", K8S_NAMESPACE)}
        chat = [s for s in statefulsets if agents[s["metadata"]["name"]]["spec"]["resources"]
                .get("tpu")]
        if len(chat) != 1 or len(statefulsets) != 2:
            raise AssertionError(f"k8s: StatefulSets {[s['metadata']['name'] for s in statefulsets]}, "
                                 f"{len(chat)} with a card; want the converter and the chat")
        (chat,) = chat
        chat_name = chat["metadata"]["name"]
        pod_spec = chat["spec"]["template"]["spec"]
        limits = pod_spec["containers"][0]["resources"]["limits"]
        if limits.get("nvidia.com/gpu") != "1" or pod_spec["containers"][0]["resources"][
                "requests"].get("nvidia.com/gpu") != "1":
            problems.append(f"the chat StatefulSet's resources {limits}")
        if pod_spec.get("nodeSelector") != {"cloud.google.com/gke-accelerator":
                                            "nvidia-h100-80gb"}:
            problems.append(f"the chat StatefulSet's node selector {pod_spec.get('nodeSelector')}")
        checksum = chat["metadata"]["annotations"].get("langstream.tpu/config-checksum")
        if not checksum or checksum != agents[chat_name]["spec"]["configChecksum"] or \
                chat["spec"]["template"]["metadata"]["annotations"].get(
                    "langstream.tpu/config-checksum") != checksum:
            problems.append(f"the chat StatefulSet's checksum annotation {checksum}")
        # the operator's Secret against the port's executor on the same CR
        # (the JAX executor's JSON, byte for byte: tests/test_torch_k8s.py)
        cr = kube.get("Application", K8S_NAMESPACE, APP_NAME)
        local = FakeKubeServer()
        local.apply({**cr, "status": {}})
        InProcessJobExecutor(local).run_deployer(ApplicationCustomResource.from_manifest(cr))
        for sts in statefulsets:
            ref = agents[sts["metadata"]["name"]]["spec"]["configSecretRef"]
            got = kube.get("Secret", K8S_NAMESPACE, ref)["stringData"]["pod-configuration"]
            want = local.get("Secret", K8S_NAMESPACE, ref)["stringData"]["pod-configuration"]
            if got != want:
                problems.append(f"{ref}'s pod configuration differs from the executor's")
        pod_config = json.loads(kube.get("Secret", K8S_NAMESPACE, agents[chat_name]["spec"]
                                         ["configSecretRef"])["stringData"]["pod-configuration"])
        (resource,) = [r["configuration"] for r in pod_config["resources"].values()
                       if r["type"] == "tpu-serving"]
        # 4. the kubelet stand-in: the converter's pod, then the chat's
        for sts in sorted(statefulsets, key=lambda s: s is chat):
            # off this loop: the init containers download from its control plane
            started = await loop.run_in_executor(None, _start_pods, kube, server.url, sts,
                                                 base / "pods")
            pods += started
            roles += [p["role"] for p in started]
        def all_info() -> bool:
            for pod in pods:
                if pod["role"].proc.poll() is not None:
                    raise AssertionError(f"k8s: {pod['name']} exited "
                                         f"({pod['role'].proc.poll()}) before its /info")
                if "info_s" not in pod and _info(pod["port"]) is not None:
                    pod["info_s"] = time.monotonic() - pod["role"].t0
            return all("info_s" in pod for pod in pods)

        await loop.run_in_executor(None, _wait, all_info, K8S_POD_S, "every pod's /info")
        (chat_pod,) = [p for p in pods if p["statefulset"] == chat_name]
        # 5. the chat: 8 websockets through the gateway role
        questions = _prompts(APP_BYTES, ctx["seed"])
        svc = TorchCompletionsService(resource)  # resolved only: the prompts' tokens
        prompts = [svc.tokenizer.encode(svc._render_prompt([ChatMessage("user", q)]))
                   for q in questions]
        # the first question after the deploy: the chat pod builds its engine
        # (draw and capture) at its first request, as a pod does in a cluster
        warm = await _app_chat(f"ws://127.0.0.1:{gw_port}", "warm-up", K8S_WARM_UP)
        out["deploy_to_first_token_s"] = warm["sent_at"] + warm["ttft_s"] - t_deploy
        out["warm_up_client_ttft_s"] = warm["ttft_s"]
        t_run = time.monotonic()
        chats = await asyncio.gather(*(
            _app_chat(f"ws://127.0.0.1:{gw_port}", f"s{i}", q) for i, q in enumerate(questions)))
        wall = time.monotonic() - t_run
        committed = await _committed_at_broker(fake, len(questions) + 1)  # and the warm-up
        if not committed["ok"]:
            problems.append(f"the questions topic's committed position at the broker: {committed}")
        # who holds the card, while every process lives
        holders = {r.name: _card_files(r.pid) for r in roles if r.proc.poll() is None}
        holders["kafka fake"] = _card_files(fake.pid)
        out["card_files"] = holders
        out["smi_compute_pids"] = _smi_compute_pids()
        if not holders.get(chat_pod["name"]):
            problems.append(f"the chat pod holds no card file: {holders}")
        others = {k: v for k, v in holders.items() if v and k != chat_pod["name"]}
        if others:
            problems.append(f"processes other than the chat pod hold the card: {others}")
        # the pods' and the operator's own readings, before they stop
        reports = {p["name"]: await loop.run_in_executor(None, p["role"].report) for p in pods}
        report = reports[chat_pod["name"]]
        out["operator"] = await loop.run_in_executor(None, operator.report)
        cfg = MODEL_PRESETS["llama-3-8b"]
        counts = {k: {"launches": v["launches"], "cpu_calls": v["cpu_calls"]}
                  for k, v in report["kernels"].items()}
        launch = _launch_check(cfg, counts, report["before"], report["after"], problems)
        restarts = report["after"]["engine-restarts-total"] - report["before"][
            "engine-restarts-total"]
        if report["starts"] != 1 or restarts:
            problems.append(f"the engine started {report['starts']} times, {restarts} restarts")
        for name, r in reports.items():
            if name != chat_pod["name"] and (r["served"] or any(
                    v["launches"] or v["cpu_calls"] for v in r["kernels"].values())):
                problems.append(f"{name} served or launched: {r}")
        served = {tuple(s["prompt"]): s for s in report["served"]}
        missing = [i for i, p in enumerate(prompts) if tuple(p) not in served]
        if missing or len(served) != len(prompts) + 1:
            raise AssertionError(f"k8s: the chat pod served {len(served)} prompts, not the "
                                 f"warm-up and the 8 questions (missing {missing})")
        got = [served[tuple(p)]["tokens"] for p in prompts]
        for i, (c, p) in enumerate(zip(chats, prompts)):
            s = served[tuple(p)]
            if s["finish_reason"] not in ("length", "stop") or s["error"]:
                problems.append(f"s{i} ended {s['finish_reason']}: {s['error']}")
            if c["text"] != svc.tokenizer.decode(s["tokens"]):
                problems.append(f"s{i}: the chunks are not the text of the answer's tokens")
            if c["null_messages"]:
                problems.append(f"s{i}: {c['null_messages']} answer messages with a null value")
        # 6. the delete over REST; the stand-in stops each pod whose
        # StatefulSet is gone with SIGTERM
        t_delete = time.monotonic()
        body = await loop.run_in_executor(None, client.delete, APP_NAME)
        out["delete_http_s"] = time.monotonic() - t_delete
        if body != {"deleted": APP_NAME}:
            problems.append(f"the delete answered {body}")
        running = list(pods)
        while running:
            names = {s["metadata"]["name"] for s in kube.list("StatefulSet", K8S_NAMESPACE)}
            for pod in [p for p in running if p["statefulset"] not in names]:
                pod["stop"] = await loop.run_in_executor(None, pod["role"].stop)
                pod["exited_after_delete_s"] = time.monotonic() - t_delete
                running.remove(pod)
            if running and time.monotonic() - t_delete > K8S_DEPLOYED_S:
                raise AssertionError(f"k8s: StatefulSets {sorted(names)} outlived the delete")
            await asyncio.sleep(0.05)
        out["delete_to_last_pod_exit_s"] = time.monotonic() - t_delete
        left = await loop.run_in_executor(None, _app_objects, kube)
        if any(left.values()):
            problems.append(f"left at the API server after the delete: {left}")
        # the card's free memory back where the phase found it
        t0 = time.monotonic()
        while True:
            free = torch.cuda.mem_get_info()[0]
            if abs(free - out["memory"]["free_before_bytes"]) <= K8S_MEMORY_SLACK or \
                    time.monotonic() - t0 > K8S_STOP_S:
                break
            await asyncio.sleep(0.2)
        out["memory"]["free_after_bytes"] = free
        if abs(free - out["memory"]["free_before_bytes"]) > K8S_MEMORY_SLACK:
            problems.append(f"the card's free memory {free} after the delete, "
                            f"{out['memory']['free_before_bytes']} before")
        # the answers against the app phase's at this depth, or the direct path
        ref = ctx.get("app_reference")
        if ref and ref["layers"] == cfg.n_layers:
            if [list(p) for p in ref["prompts"]] != [list(p) for p in prompts]:
                raise AssertionError("k8s: the app phase's reference was served other prompts")
            want, out["reference"] = ref["tokens"], "app phase"
        else:
            want, out["reference"] = await _k8s_direct(svc, questions, prompts), \
                "direct path"
        if got != want:
            same = _same_or_tie(ctx, svc.model_config, svc.params(), "k8s", prompts, got, want)
        else:
            same = {"agreement": [1.0] * len(got), "ties": [], "equal": True, "ok": True}
        if not same["ok"]:
            problems.append(f"answers differ from the {out['reference']} beyond one-ulp ties: "
                            f"{same['not_ties']}")
        svc.close()
        # the other roles stop; every process exits and its ports close
        for role in (operator, gateway, api):
            out[f"{role.name}_stop"] = await loop.run_in_executor(None, role.stop)
        out["kafka_fake_stop"] = fake.close()
        if not out["kafka_fake_stop"]["ok"]:
            problems.append(f"the kafka fake did not stop cleanly: {out['kafka_fake_stop']}")
        alive = [r.name for r in roles if r.proc.poll() is None]
        ports = [p["port"] for p in pods] + [gw_port, api_port]
        open_ports = [p for p in ports if _port_open(p)]
        if alive or open_ports:
            problems.append(f"still running: {alive}; ports still open: {open_ports}")
        inbound = [served[tuple(p)]["submit_at"] - c["sent_at"] for c, p in zip(chats, prompts)]
        outbound = [c["last_at"] - served[tuple(p)]["submit_at"] - served[tuple(p)]["total_s"]
                    for c, p in zip(chats, prompts)]
        tokens = sum(len(t) for t in got)
        out.update({
            "requests": len(questions), "layers": launch["layers"],
            "prompt_tokens": [len(p) for p in prompts], "answer_tokens": [len(t) for t in got],
            "client_ttft_s": [c["ttft_s"] for c in chats],
            "engine_ttft_ms": [served[tuple(p)]["ttft_s"] * 1000.0 for p in prompts],
            "inbound_ms": [s * 1000.0 for s in inbound],
            "outbound_ms": [s * 1000.0 for s in outbound],
            "messages": [c["messages"] for c in chats],
            "wall_s": wall, "answer_tokens_per_s": tokens / wall,
            "draw_and_capture_s": report.get("draw_and_capture_s"),
            "pods": {p["name"]: {"init_s": p["init_s"], "start_to_info_s": p["info_s"],
                                 "gpus": p["gpus"], "stop": p["stop"],
                                 "exited_after_delete_s": p["exited_after_delete_s"]}
                     for p in pods},
            "committed": committed,
            **{k: launch[k] for k in ("admit_groups", "decode_steps", "decode_chunks",
                                      "graph_replays", "kernel_launches")},
            "same_as_reference": {k: same[k] for k in ("agreement", "ties", "equal")},
        })
    finally:
        for role in roles:
            if role.proc.poll() is None:
                role.stop()
        fake.close()
        if server is not None:
            await server.stop()
    if problems:
        raise AssertionError("k8s: " + "; ".join(problems) + f" ({json.dumps(out)[:3000]})")
    return out


def phase_k8s(ctx: dict) -> None:
    """The production instance on the card: a REST deploy reconciled by the
    operator into StatefulSets, an operator-made pod serving llama-3-8b
    over Kafka (module docstring, phase 28)."""
    import asyncio
    import gc

    import torch

    ctx.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    run = asyncio.run(_k8s_run(ctx))
    run["phase_s"] = time.monotonic() - t_phase
    card = smi_line()
    for i, (client, engine) in enumerate(zip(run["client_ttft_s"], run["engine_ttft_ms"])):
        log(f"k8s s{i} ({run['prompt_tokens'][i]} prompt tokens, {run['answer_tokens'][i]} "
            f"answer tokens, {run['messages'][i]} messages): client ttft {client * 1000.0:.1f} "
            f"ms, engine ttft {engine:.1f} ms; send to submit {run['inbound_ms'][i]:.1f} ms, "
            f"engine end to last message {run['outbound_ms'][i]:.1f} ms [{card}]")
    kafka = ctx.get("brokers_kafka")
    vs = (f" (brokers phase over kafka: {kafka['answer_tokens_per_s']:.1f} tokens/s, send to "
          f"submit p50 {_percentiles(kafka['inbound_ms'])['p50']:.1f} ms)" if kafka else "")
    pods = "; ".join(f"{name}: init {p['init_s']:.2f} s, start to /info "
                     f"{p['start_to_info_s']:.2f} s, cards {p['gpus']}, exit {p['stop']['exit']}"
                     for name, p in run["pods"].items())
    log(f"k8s deploy: REST deploy {run['deploy_http_s']:.3f} s, deploy to Application "
        f"DEPLOYED {run['deploy_to_deployed_s']:.3f} s, DEPLOYED to every StatefulSet "
        f"{run['deployed_to_statefulsets_s']:.3f} s; {pods}; the chat pod's draw and capture "
        f"{run['draw_and_capture_s']:.2f} s; deploy to the first answer token (the warm-up "
        f"question's) {run['deploy_to_first_token_s']:.2f} s, its client ttft "
        f"{run['warm_up_client_ttft_s']:.2f} s [{card}]")
    log(f"k8s chat: {sum(run['answer_tokens'])} answer tokens in {run['wall_s']:.3f} s = "
        f"{run['answer_tokens_per_s']:.1f} tokens/s{vs}; send to submit p50 "
        f"{_percentiles(run['inbound_ms'])['p50']:.1f} ms, engine end to last message p50 "
        f"{_percentiles(run['outbound_ms'])['p50']:.1f} ms; launches in the pod "
        f"{json.dumps({k: n for k, n in run['kernel_launches'].items() if n})} = "
        f"{run['layers']} x {run['admit_groups']} admit groups, {run['layers']} x "
        f"{run['decode_steps']} decode steps; {run['graph_replays']} replays = "
        f"{run['decode_chunks']} chunks; answers vs the {run['reference']} "
        f"{json.dumps(run['same_as_reference'])}; committed at the broker "
        f"{json.dumps(run['committed']['committed'])} [{card}]")
    log(f"k8s operator: {run['operator']['passes']} reconcile passes, "
        f"{run['operator']['watch_events']} watch events; delete over REST "
        f"{run['delete_http_s']:.3f} s, delete to the last pod's exit "
        f"{run['delete_to_last_pod_exit_s']:.3f} s; card files {json.dumps(run['card_files'])}, "
        f"nvidia-smi compute pids {run['smi_compute_pids']}; free memory "
        f"{run['memory']['free_before_bytes']} bytes before, "
        f"{run['memory']['free_after_bytes']} after [{card}]")
    log(f"k8s phase: {run['phase_s']:.1f} s [{card}]")
    log(f"k8s tpu-completions llama-3-8b {json.dumps(run)}")
    ctx["k8s"] = run
    ctx.setdefault("summaries", []).append(("k8s", {
        "deploy_to_deployed_s": run["deploy_to_deployed_s"],
        "deployed_to_statefulsets_s": run["deployed_to_statefulsets_s"],
        "pod_start_to_info_s": {n: p["start_to_info_s"] for n, p in run["pods"].items()},
        "draw_and_capture_s": run["draw_and_capture_s"],
        "deploy_to_first_token_s": run["deploy_to_first_token_s"],
        "tokens_per_s": run["answer_tokens_per_s"], "operator": run["operator"],
        "delete_to_last_pod_exit_s": run["delete_to_last_pod_exit_s"],
        "phase_s": run["phase_s"]}))
    gc.collect()
    torch.cuda.empty_cache()


def _replay_rate(torch, engine, chunks: int = 4) -> dict:
    """Back-to-back replays of the greedy chunk (with speculation: the
    greedy verify) on a burst's engine (its slots idle by then): the card's
    time per decode step (per verify step), the wall's, and the host's time
    to queue one chunk."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    start.record()
    for _ in range(chunks):
        engine._run_chunk((False, False))
    end.record()
    host_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    steps = chunks * (1 if engine._spec_enabled else engine.decode_chunk)
    return {
        "device_ms_per_step": start.elapsed_time(end) / steps,
        "wall_ms_per_step": wall_ms / steps,
        "host_ms_per_chunk": host_ms / chunks,
    }


def _replay_profile(torch, engine, replays: int = 3) -> list:
    """The device kernels of back-to-back greedy replays under
    torch.profiler, grouped by kernel name: [name, device ms per step,
    launches per step] of the 12 that took the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            engine._run_chunk((False, False))
        torch.cuda.synchronize()
    steps = replays * (1 if engine._spec_enabled else engine.decode_chunk)
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return [[e.key[:70], e.self_device_time_total / 1e3 / steps, e.count / steps] for e in top]


def phase_profile(ctx: dict) -> None:
    """Three traced bursts (8 short prompts, 32 new tokens each; bf16 and
    int8 page pools, the bf16 dense cache) under torch.profiler: wall
    time, the summed device time of CUDA kernels, the device's busy share
    of the wall, and the kernels that took the most; then, untraced, the
    time per decode step of back-to-back replays. Every decode launch must
    be the one cluster kernel: a split-K kernel or its merge launch fails
    the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    base = MODEL_PRESETS["llama-3-8b"]
    for label, cfg, kw in (("bf16", base, {}),
                           ("int8-kv", dataclasses.replace(base, kv_cache_dtype="int8"), {}),
                           ("dense-bf16", base, DENSE_KW)):
        engine = ServingEngine(cfg, _llama_params(ctx), max_batch=8, decode_chunk=16,
                               page_size=PAGE, device="cuda", **kw)
        engine.start()
        try:
            prompts = [tok.encode(p) for p in _prompts([100] * 8, ctx["seed"] + 1)]
            opts = GenerationOptions(max_new_tokens=32)
            engine.generate(prompts[0], opts, timeout=600)  # warm
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
                        for p in prompts]
                for r in reqs:
                    r.result(timeout=600)
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - t0) * 1e3
            stats = engine.stats()
        finally:
            engine.stop()
        with torch.no_grad():
            steady = _replay_rate(torch, engine)
        # device activity (kernels, copies, fills) carries self device time;
        # the host-side ops that launched it carry none
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        log(f"profile llama-3-8b {label} decode burst " + json.dumps({
            "wall_ms": wall_ms,
            "device_kernel_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "graph_replays": stats["graph-replays-total"],
            "steady_replays": steady,
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
        }))
        stale = [e.key for e in kernels if "decode_split" in e.key or "decode_combine" in e.key]
        if stale:
            raise AssertionError(f"profile {label}: split-K decode kernels launched: {stale}")


TIERED_SESSIONS = 24
TIERED_HISTORY = 1024
TIERED_FIRST_TURN = 40
TIERED_SECOND_TURNS = (20, 120)  # the shortest and the longest second turn
TIERED_NEW = 16
TIERED_KW = {"max_seq_len": 2048, "prefix_cache": "auto"}
# the arena: twice the pool's pages (320 at the default: 1.25 GiB pinned at
# SHALLOW_LAYERS), every published prefix hibernating as soon as it is idle
TIERED_TIER = {"host_kv_fraction": 2.0, "spill_idle_s": 0.0}
# a pool no session's prefix is ever evicted from (24 x 16 + 8 x 19 pages)
TIERED_BIG_POOL = 640
# the int8 pass: 8 sessions one at a time through a pool of 64 pages, so
# all but the last two hibernate and demote
TIERED_INT8_SESSIONS = 8
TIERED_INT8_POOL = 64
# the durable pass: the first 8 sessions through two providers on one
# directory under build/ (git-ignored, removed at the end)
TIERED_DURABLE_SESSIONS = 8


def _tiered_prompts(seed: int) -> tuple[list, list, list]:
    """24 sessions' seeded 1024-token histories (byte tokens, BOS first),
    their first turns (history + 40 tokens) and their second turns
    (history + 20..120 tokens, every length distinct)."""
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    n = TIERED_SESSIONS
    lo, hi = TIERED_SECOND_TURNS
    second = [lo + round((hi - lo) * i / (n - 1)) for i in range(n)]
    texts = _prompts([TIERED_HISTORY] * n + [TIERED_FIRST_TURN] * n + second, seed + 7)
    histories = [tok.encode(t)[:TIERED_HISTORY] for t in texts[:n]]
    first = [h + list(texts[n + i].encode()) for i, h in enumerate(histories)]
    again = [h + list(texts[2 * n + i].encode()) for i, h in enumerate(histories)]
    return histories, first, again


def _tiered_engine(ctx, cfg, params, **kw):
    from langstream_tpu_torch.serving.engine import ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    return ServingEngine(
        cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE,
        eos_token_id=ByteTokenizer().eos_token_id, rng_seed=ctx["seed"], device="cuda",
        **{**TIERED_KW, **kw},
    )


def _admission_routes(engine) -> dict:
    """Record each admission's route by prompt length: a warm suffix
    segment (restored from the host tier or not) or a cold group's row."""
    routes: dict = {}
    warm, group = engine._paged_prefill_prefix, engine._prefill_group

    def warm_call(idx, request, p):
        routes[len(request.prompt_tokens)] = "restored" if request._tier_restored else "warm"
        return warm(idx, request, p)

    def group_call(width, rows):
        for _, request in rows:
            routes[len(request.prompt_tokens)] = "cold"
        return group(width, rows)

    engine._paged_prefill_prefix, engine._prefill_group = warm_call, group_call
    return routes


def _tier_round(ctx, cfg, params, engine, prompts, sequential: bool) -> dict:
    """One round of turns on a tiered (or reference) engine through
    ``_serve`` (every request ends with its tokens, no plain version,
    replays = chunks), with the tier's and the prefix index's counters over
    the round and the segment and decode launches required."""
    before = engine.stats()
    run = _serve(ctx, cfg, params, [], TIERED_NEW, prompts=prompts, engine=engine,
                 sequential=sequential)
    engine._drain_spills()
    after = engine.stats()
    keys = ("warm-admissions-total", "admit-groups-total", "spill-pages-total",
            "spill-bytes-total", "host-demotions-total", "host-evictions-total",
            "restored-hits-total", "restore-failures-total", "recompute-fallbacks-total",
            "restore-pages-total", "restore-bytes-total", "durable-restored-hits-total",
            "prefix-cache-evictions-total")
    run["tier"] = {k: after[k] - before[k] for k in keys}
    run["warm_admissions"] = run["tier"]["warm-admissions-total"]
    segments = run["kernel_launches"].get(_kernel_name("flash_segment", cfg), 0)
    if segments != cfg.n_layers * run["warm_admissions"]:
        raise AssertionError(f"tiered: {segments} segment launches != {cfg.n_layers} x "
                             f"{run['warm_admissions']} warm admissions")
    _require_launches(run, _kernel_name("paged_decode", cfg), "decode_steps", cfg.n_layers)
    if run["tier"]["recompute-fallbacks-total"] or run["tier"]["restore-failures-total"]:
        raise AssertionError(f"tiered: a clean round fell back: {run['tier']}")
    return run


def _restored_logits(logits: dict, ref_logits: dict, cold_logits: dict, restored: list,
                     cold: list) -> dict:
    """The restored turns' first-token logits: bit-equal to the same
    prompts' on the no-eviction engine (a warm suffix segment over pages
    that never left the card: the restore changed nothing), and — for the
    shortest and longest of them that the tier-off engine re-prefilled —
    within MODEL_REL_TOL of that cold admission's, top-1 equal or a tie
    both logits show within one bf16 ulp each way (the cold group's GEMMs
    have other shapes; ``_same_or_tie``'s rule)."""
    import torch

    unequal = [n for n in restored if not torch.equal(logits[n], ref_logits[n])]
    if unequal:
        raise AssertionError(f"tiered: restored logits of {unequal}-token prompts differ from "
                             "the no-eviction engine's")
    out = {"bit_equal_to_no_eviction": len(restored)}
    for n in cold[:1] + cold[-1:]:
        a, b = logits[n], cold_logits[n]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        ta, tb = int(torch.argmax(a)), int(torch.argmax(b))
        gaps = [abs((x[ta] - x[tb]).item()) for x in (a, b)]
        ulps = [2 * _bf16_ulp(x.max().item()) for x in (a, b)]
        tie = ta != tb and all(g <= u for g, u in zip(gaps, ulps))
        out[f"len{n}"] = {"rel_err": rel, "top1_equal": ta == tb, "tie": tie,
                          "top1": [ta, tb], "gaps": gaps}
        if rel > MODEL_REL_TOL or not (ta == tb or tie):
            raise AssertionError(f"tiered: restored vs cold logits of the {n}-token prompt: "
                                 f"{out[f'len{n}']} (tolerance {MODEL_REL_TOL})")
    out["tolerance"] = MODEL_REL_TOL
    return out


def _kernel_name(base: str, cfg) -> str:
    return f"{base}_int8" if cfg.kv_cache_dtype == "int8" else base


def _entry_for(engine, prompt):
    """The live prefix entry covering ``prompt``'s history, or None."""
    for _, entry in reversed(engine._prefix_index.candidates(prompt)):
        if not entry.dropped:
            return entry
    return None


def _page_image(torch, engine, pages) -> list:
    """The pool pages' byte images (``join_page_bytes`` of their leaves,
    read with ``page_read``: no device temporaries)."""
    from langstream_tpu_torch.serving.pagepool import join_page_bytes, page_read, pool_leaves

    leaves = pool_leaves(engine._pagepool.dev)
    out = []
    for p in pages:
        blocks = [torch.empty((leaf.shape[0],) + tuple(leaf.shape[2:]), dtype=leaf.dtype)
                  for leaf in leaves]
        page_read(engine._pagepool.dev, p, blocks)
        out.append(join_page_bytes(blocks))
    return out


def _restore_check(torch, engine, timer) -> dict:
    """On a stopped engine: one entry holding device pages and its host
    copy — its 16 pages read to the host, held against the arena's copy;
    the entry demoted and restored by the engine (``_restore_entry``,
    timed) and its new pages held against the first read; then the
    restore's parts timed alone: the checksum of the 16 slots (host; the
    engine's parallel ``read_slots``, and one slot after another on one
    thread), their upload into free pages (device), and a pinned
    host-to-device copy of the same bytes (the bound); and the spill's copy of the same pages
    (device). The entry is left hibernated."""
    from langstream_tpu_torch.serving.pagepool import HASH_THREADS, page_write

    pool, index, tier = engine._pagepool, engine._prefix_index, engine._host_tier
    engine._drain_spills()
    # a device-only entry (read, then spilled here), else one spilled already
    entry = min((e for e in index._live if e.pages and e.spilling is None),
                key=lambda e: bool(e.host), default=None)
    if entry is None:
        raise AssertionError("tiered: no entry holds device pages")
    n = len(entry.pages)
    before = _page_image(torch, engine, entry.pages)
    if not entry.host:
        engine._spill_worker.start()  # start() would; the stopped engine's is idle
        if not engine._ensure_spilled(entry) or not entry.spilling.event.wait(120):
            raise AssertionError("tiered: the entry's spill did not complete")
        engine._drain_spills()
    arena = [tier.page_bytes(s) for s in entry.host]
    if arena != before:
        raise AssertionError("tiered: the arena's copy differs from the device pages")
    index.release_device_pages(pool, entry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = engine._restore_entry(entry, entry.length)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if not ok or _page_image(torch, engine, entry.pages) != before:
        raise AssertionError(f"tiered: the restore (ok {ok}) is not bit-equal to the pages "
                             "read before the spill")
    t0 = time.perf_counter()
    one_by_one = [tier.read(s) for s in entry.host]
    checksum_one_thread_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    blocks = tier.read_slots(entry.host)
    checksum_ms = (time.perf_counter() - t0) * 1e3
    if blocks is None or any(b is None for b in one_by_one):
        raise AssertionError("tiered: an arena slot failed its checksum")
    dst = pool.alloc_pages(n)
    if dst is None:
        raise AssertionError("tiered: no free pages to time the upload")

    def upload():
        for d, b in zip(dst, blocks):
            page_write(pool.dev, d, b, non_blocking=True)

    upload_ms = timer.ms(upload, iters=5, warmup=1)
    pool.decref(dst)
    nbytes = n * tier.bytes_per_page
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    bound_ms = timer.ms(lambda: dev.copy_(pinned, non_blocking=True), iters=5, warmup=1)
    # the spill's copy of the same pages, into the entry's own slots (the
    # same bytes, so their stamps stay true)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._spill_copy(entry.pages, entry.host).synchronize()
    spill_copy_ms = (time.perf_counter() - t0) * 1e3
    if [tier.page_bytes(s) for s in entry.host] != before:
        raise AssertionError("tiered: the spill copy of the restored pages changed the arena")
    # the timing buffers are the phase's, not the engine's: give their
    # blocks back before the engine's peak is read
    del pinned, dev, blocks, one_by_one
    torch.cuda.empty_cache()
    index.release_device_pages(pool, entry)  # hibernated again
    return {"pages": n, "bytes": nbytes, "bit_equal": True, "arena_equal": True,
            "restore_ms": restore_ms, "checksum_host_ms": checksum_ms,
            "checksum_one_thread_ms": checksum_one_thread_ms, "hash_threads": HASH_THREADS,
            "upload_device_ms": upload_ms, "pinned_copy_bound_ms": bound_ms,
            "pinned_copy_gbps": nbytes / bound_ms / 1e6,
            "spill_copy_ms": spill_copy_ms, "spill_copy_gbps": nbytes / spill_copy_ms / 1e6}


def _spill_overlap(torch, engine) -> dict:
    """A captured decode chunk's device ms a step alone, then with the
    spill stream copying pool pages into free arena slots at the same time
    (up to 256 pages, 4 times over, so the copies outlast the chunk), on a
    stopped engine: the engine's copies (``_spill_copy``: one 2-D DMA a
    page leaf), and the same pages through torch's strided ``copy_`` (each
    page leaf staged contiguous on the device by a copy kernel, then
    copied: the previous design)."""
    from langstream_tpu_torch.serving.pagepool import pool_leaves

    pool, tier, stream = engine._pagepool, engine._host_tier, engine._spill_stream

    def chunk_ms() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        engine._run_chunk((False, False))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / engine.decode_chunk

    def staged(pages, slots):
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for page, slot in zip(pages, slots):
                for leaf, dst in zip(pool_leaves(pool.dev), tier.blocks(slot)):
                    dst.copy_(leaf[:, page], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return done

    torch.cuda.synchronize()
    chunk_ms()  # warm
    idle = sorted(chunk_ms() for _ in range(3))[1]
    n = min(256, tier.free_slots, pool.num_pages)
    if n <= 0:
        raise AssertionError("tiered: no free arena slots to copy into")
    slots = tier.alloc(n)
    out = {"decode_step_ms_idle": idle, "spill_pages": n, "repeats": 4}
    for label, copy in (("dma", engine._spill_copy), ("staged", staged)):
        torch.cuda.synchronize()
        s0 = torch.cuda.Event(enable_timing=True)
        s0.record(stream)
        for _ in range(4):
            done = copy(list(range(n)), slots)
        s1 = torch.cuda.Event(enable_timing=True)
        s1.record(stream)
        busy = chunk_ms()
        done.synchronize()
        copy_ms = s0.elapsed_time(s1)
        out[label] = {"decode_step_ms_spill_in_flight": busy, "spill_copy_ms": copy_ms,
                      "spill_copy_gbps": 4 * n * tier.bytes_per_page / copy_ms / 1e6,
                      "chunk_ms_with_spill": busy * engine.decode_chunk}
    pool.wait_fences(range(n))  # the engine's copies fenced the pages
    tier.free(slots)
    torch.cuda.empty_cache()  # the staged copies' temporaries are the phase's
    out["decode_step_ms_spill_in_flight"] = out["dma"]["decode_step_ms_spill_in_flight"]
    out["spill_copy_ms"] = out["dma"]["spill_copy_ms"]
    return out


def _restore_itl(ctx, torch, engine, prompts) -> dict:
    """Concurrent sessions' decode while a returning session restores: 4
    decoders (40-byte prompts, 128 new tokens) run on the tiered engine,
    and once each has 32 tokens a hibernated session's next turn arrives —
    once restoring from the arena, then again on the pages that restore
    left (a device hit, with 4 other decoders). Decoder 0's tokens land a
    chunk at a time: the gaps between its bursts before the arrival (p50)
    and the largest after it, for each run; the difference between the
    runs' largest gaps is what the restore itself held every decoder
    back."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    engine._drain_spills()
    pick = next((i for i, p in enumerate(prompts)
                 if (e := _entry_for(engine, p)) is not None and e.tier == "host"), None)
    if pick is None:
        raise AssertionError("tiered itl: no hibernated session to restore")
    tok = ByteTokenizer()
    texts = _prompts([40] * 8, ctx["seed"] + 11)
    dec_opts = GenerationOptions(max_new_tokens=128, temperature=0.0)
    opts = GenerationOptions(max_new_tokens=TIERED_NEW, temperature=0.0)
    out: dict = {"session": pick}
    engine.start()
    try:
        for label, batch in (("restore", texts[:4]), ("device_hit", texts[4:])):
            before = engine.stats()
            stamps: list = [[] for _ in batch]
            decs = [engine.submit(GenerationRequest(
                prompt_tokens=tok.encode(t), options=dec_opts,
                on_token=lambda _tok, got=got: got.append(time.monotonic())))
                for t, got in zip(batch, stamps)]
            deadline = time.monotonic() + 300
            while min(len(got) for got in stamps) < 32:
                if time.monotonic() > deadline:
                    raise AssertionError("tiered itl: the decoders stalled")
                time.sleep(0.0005)
            arrive = time.monotonic()
            back = engine.submit(GenerationRequest(prompt_tokens=prompts[pick], options=opts))
            r = back.result(timeout=600)
            for d in decs:
                d.result(timeout=600)
            after = engine.stats()
            times = stamps[0]
            gaps = [(b, (b - a) * 1e3) for a, b in zip(times, times[1:]) if b - a > 1e-3]
            pre = sorted(g for t, g in gaps if t < arrive)
            post = [g for t, g in gaps if t >= arrive]
            restored = after["restored-hits-total"] - before["restored-hits-total"]
            if restored != (1 if label == "restore" else 0) or r.error is not None:
                raise AssertionError(f"tiered itl {label}: {restored} restores, {r.error}")
            out[label] = {
                "gap_p50_ms_before": pre[len(pre) // 2] if pre else None,
                "gap_max_ms_after": max(post) if post else None,
                "returning_ttft_s": r.ttft_s,
                "restore_verify_ms": (after["restore-verify-s-total"]
                                      - before["restore-verify-s-total"]) * 1e3,
            }
    finally:
        engine.stop()
    a, b = out["restore"]["gap_max_ms_after"], out["device_hit"]["gap_max_ms_after"]
    out["restore_stall_ms"] = a - b if a is not None and b is not None else None
    return out


def _spill_drill(ctx, cfg, params, engine, prompts, reference: list) -> dict:
    """``spill@1`` planted on a stopped tiered engine: a hibernated
    session's next turn flips one arena byte before its restore reads it —
    the checksum refuses it, the turn re-prefills cold and its tokens
    equal the reference run's (or a one-ulp tie: the cold group's GEMM
    shapes differ from a warm segment's)."""
    from langstream_tpu_torch.serving.faultinject import FaultInjector

    engine._drain_spills()
    pick = next((i for i, p in enumerate(prompts)
                 if (e := _entry_for(engine, p)) is not None and e.tier == "host"), None)
    if pick is None:
        raise AssertionError("tiered drill: no hibernated session to restore")
    engine._injector = FaultInjector("spill@1")
    before = engine.stats()
    run = _serve(ctx, cfg, params, [], TIERED_NEW, prompts=[prompts[pick]], engine=engine,
                 sequential=True)
    after = engine.stats()
    engine._injector = None
    delta = {k: after[k] - before[k] for k in ("restore-failures-total",
                                               "recompute-fallbacks-total",
                                               "restored-hits-total")}
    fired = after["fault-injection"]["spill"]
    if fired != 1 or delta != {"restore-failures-total": 1, "recompute-fallbacks-total": 1,
                               "restored-hits-total": 0}:
        raise AssertionError(f"tiered drill: spill fired {fired}, counters {delta}")
    same = _same_or_tie(ctx, cfg, params, "tiered spill drill vs reference", [prompts[pick]],
                        run["_tokens"], [reference[pick]])
    if not same["ok"]:
        raise AssertionError(f"tiered drill: the cold fallback's tokens: {same}")
    return {"session": pick, "fired": fired, **delta, "tokens": same}


def _tiered_durable(ctx, cfg, histories, first, again, reference) -> dict:
    """The durable tier through two providers on one directory: provider A
    (``fault-injection: disk-corrupt@1``: its first checkpoint's data file
    gets one byte flipped under a valid manifest) serves the first turns of
    8 sessions, each spill checkpointed by the durable worker, then
    ``hibernate()``; provider B, built in the same process on the same
    directory, must rehydrate every session and serve their second turns
    from disk: every session but the corrupted one a durable restore,
    bit-equal to its checkpoint; the corrupted one a
    ``durable-restore-failed`` dump and a cold prefill; every turn's tokens
    those of the reference run (or one-ulp ties)."""
    import gc
    import shutil

    import torch

    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.serving.durable import DATA_SUFFIX, DurableStore
    from langstream_tpu_torch.serving.pagepool import prefix_digest

    n = TIERED_DURABLE_SESSIONS
    root = ROOT / "build" / "durable"
    shutil.rmtree(root, ignore_errors=True)
    resource = {"model": cfg.name, "seed": ctx["seed"], "max-seq-len": 2048,
                "max-batch": 8, "decode-chunk": 16, "page-size": PAGE, "prefix-cache": "auto",
                "host-kv-fraction": 2.0, "durable-dir": str(root)}
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {}
    try:
        holder = TorchServingProvider({**resource, "fault-injection": "disk-corrupt@1"}) \
            .get_completions_service({})
        engine = holder.engine()
        params = holder.params()
        round1 = _serve(ctx, cfg, params, [], TIERED_NEW, prompts=first[:n], engine=engine)
        t0 = time.perf_counter()
        ledger = engine.hibernate("replica-a")
        hib_s = time.perf_counter() - t0
        stats = engine.stats()
        hist = stats["histograms"]["engine_durable_checkpoint_s"]
        out["a"] = {
            "hibernate": ledger, "hibernate_s": hib_s,
            "checkpoints": stats["durable-checkpoints-total"],
            "checkpoint_bytes": stats["durable-checkpoint-bytes-total"],
            "checkpoint_failures": stats["durable-checkpoint-failures-total"],
            "entries": stats["durable-entries"], "bytes_on_disk": stats["durable-bytes-on-disk"],
            "checkpoint_s_sum": hist["sum"], "checkpoint_s_p50": hist["p50"],
            "checkpoint_gbps": stats["durable-checkpoint-bytes-total"] / max(hist["sum"], 1e-9)
            / 1e9,
            "disk_corrupt_fired": stats["fault-injection"]["disk-corrupt"],
        }
        if stats["durable-entries"] != n or out["a"]["disk_corrupt_fired"] != 1:
            raise AssertionError(f"durable: provider A checkpointed {out['a']}")
        holder.close()
        del holder, engine, params
        gc.collect()
        torch.cuda.empty_cache()
        holder = TorchServingProvider(resource).get_completions_service({})
        t0 = time.perf_counter()
        engine = holder.engine()
        out["b_build_s"] = time.perf_counter() - t0
        params = holder.params()
        rehydrated = engine.stats()["durable-entries"]
        if rehydrated != n:
            raise AssertionError(f"durable: provider B rehydrated {rehydrated} of {n} sessions")
        run = _serve(ctx, cfg, params, [], TIERED_NEW, prompts=again[:n], engine=engine,
                     sequential=True)
        stats = engine.stats()
        dump = engine._obs.flight.last_dump
        digests = [prefix_digest(h) for h in histories[:n]]
        dead = dump["extra"]["entry-digest"] if dump else None
        if (dump is None or dump["reason"] != "durable-restore-failed" or dead not in digests
                or stats["durable-restored-hits-total"] != n - 1
                or stats["durable-restore-failures-total"] != 1):
            raise AssertionError(f"durable: B restored {stats['durable-restored-hits-total']}, "
                                 f"failed {stats['durable-restore-failures-total']}, dump "
                                 f"{dump and dump['reason']} {dead}")
        same = _same_or_tie(ctx, cfg, params, "durable round 2 vs reference", again[:n],
                            run["_tokens"], reference[:n])
        if not same["ok"]:
            raise AssertionError(f"durable: round-2 tokens {same}")
        # bit-equal to the checkpoint: each restored session's pages as they
        # lie now (device pages, else the arena's copy) against a fresh
        # read of its checkpoint
        reader = DurableStore(str(root))
        reader.rehydrate()
        checked = []
        for i in range(n):
            if digests[i] == dead or len(checked) == 2:
                continue
            entry = _entry_for(engine, again[i])
            want = reader.restore(digests[i])["pages"]
            if entry.pages:
                got = _page_image(torch, engine, entry.pages[:len(want)])
            else:
                got = [engine._host_tier.page_bytes(s) for s in entry.host[:len(want)]]
            if got != want:
                raise AssertionError(f"durable: session {i}'s pages differ from its checkpoint")
            checked.append({"session": i, "tier": entry.tier, "pages": len(want)})
        data = root / f"{digests[0 if dead != digests[0] else 1]}{DATA_SUFFIX}"
        t0 = time.perf_counter()
        nbytes = len(data.read_bytes())
        read_ms = (time.perf_counter() - t0) * 1e3
        hist = stats["histograms"]["engine_durable_restore_s"]
        out["b"] = {
            "rehydrated": rehydrated, "durable_restored_hits": stats["durable-restored-hits-total"],
            "restore_failures": stats["durable-restore-failures-total"],
            "dead_entries": stats["durable-dead-entries-total"],
            "restore_bytes": stats["durable-restore-bytes-total"],
            "restore_ms_p50": hist["p50"] * 1e3,
            "restore_ms_mean": hist["sum"] / max(1, hist["count"]) * 1e3,
            "file_bytes": nbytes, "sequential_read_ms": read_ms,
            "sequential_read_gbps": nbytes / read_ms / 1e6,
            "reads_from": "the host's page cache (the file was just written)",
            "ttft_p50_s": run["ttft_p50_s"], "ttft_max_s": run["ttft_max_s"],
            "corrupted_session": digests.index(dead), "dump_error": dump["extra"]["error"],
            "bit_equal_to_checkpoint": checked, "tokens": same,
        }
        holder.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del round1
    return out


def phase_tiered(ctx: dict) -> None:
    """The host KV tier and the durable tier at llama-3-8b's full width and
    ``SHALLOW_LAYERS`` of its depth (module docstring, phase 15): the reference, tier-off and tiered
    engines over the two rounds, the restore check and its timings, the
    decode step beside a spill, the ``spill@1`` drill, the int8 pass and the
    durable pass."""
    import gc

    import torch

    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    # SHALLOW_LAYERS of llama-3-8b, drawn from the seed as the
    # durable pass's providers of the same preset draw it: their tokens are
    # held to this tree's reference
    cfg = MODEL_PRESETS[_shallow_model()]
    ctx.pop("params", None)  # the 32-layer tree; a later phase draws it again
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(ctx["seed"]),
                         device="cuda")
    histories, first, again = _tiered_prompts(ctx["seed"])
    timer = Timer(torch)
    # the reference: a pool no prefix is evicted from
    ref = _tiered_engine(ctx, cfg, params, kv_pages=TIERED_BIG_POOL)
    ref_logits = _capture_first_logits(ref)
    ref1 = _tier_round(ctx, cfg, params, ref, first, sequential=False)
    ref2 = _tier_round(ctx, cfg, params, ref, again, sequential=True)
    if ref2["warm_admissions"] != TIERED_SESSIONS:
        raise AssertionError(f"tiered reference: {ref2['warm_admissions']} warm admissions")
    del ref
    # the tier off: the same pool as the tiered engine's, evicted prefixes
    # re-prefill
    off = _tiered_engine(ctx, cfg, params, host_kv_fraction=0.0)
    off_logits = _capture_first_logits(off)
    off_routes = _admission_routes(off)
    off1 = _tier_round(ctx, cfg, params, off, first, sequential=False)
    off_routes.clear()
    off2 = _tier_round(ctx, cfg, params, off, again, sequential=True)
    del off
    base_alloc, base_reserved = _fresh_base(torch)
    engine = _tiered_engine(ctx, cfg, params, **TIERED_TIER)
    tier = engine._host_tier
    log(f"tiered arena: {tier.num_pages} slots of {tier.bytes_per_page} bytes = "
        f"{tier.bytes_total} bytes ({tier.bytes_total / 2**30:.2f} GiB, pinned {tier.pinned}) "
        f"allocated in {tier.alloc_s:.3f}s; pool {engine._pagepool.num_pages} pages")
    logits = _capture_first_logits(engine)
    routes = _admission_routes(engine)
    r1 = _tier_round(ctx, cfg, params, engine, first, sequential=False)
    if r1["tier"]["host-demotions-total"] <= 0:
        raise AssertionError(f"tiered: round 1 demoted nothing: {r1['tier']}")
    check = _restore_check(torch, engine, timer)
    routes.clear()
    r2 = _tier_round(ctx, cfg, params, engine, again, sequential=True)
    if r2["tier"]["restored-hits-total"] <= 0 or r2["warm_admissions"] != TIERED_SESSIONS:
        raise AssertionError(f"tiered: round 2 {r2['warm_admissions']} warm, {r2['tier']}")
    overlap = _spill_overlap(torch, engine)
    try:
        memory, memory_error = _memory_reading(torch, engine, base_alloc, base_reserved), None
    except AssertionError as e:  # raised once the phase's readings are printed
        memory, memory_error = {"error": str(e)}, e
    itl = _restore_itl(ctx, torch, engine, again)
    stats = engine.stats()
    same1 = _same_or_tie(ctx, cfg, params, "tiered round 1 vs reference", first,
                         r1["_tokens"], ref1["_tokens"])
    same2 = _same_or_tie(ctx, cfg, params, "tiered round 2 vs reference", again,
                         r2["_tokens"], ref2["_tokens"])
    # the restored turns' first-token logits against the no-eviction
    # engine's (bit-equal) and the tier-off engine's cold admissions
    restored = sorted(n for n, r in routes.items() if r == "restored")
    both = [n for n in restored if off_routes.get(n) == "cold"]
    if not both:
        raise AssertionError("tiered: no prompt restored here and re-prefilled without the tier")
    held = _restored_logits(logits, ref_logits, off_logits, restored, both)
    drill = _spill_drill(ctx, cfg, params, engine, again, ref2["_tokens"])
    spill_hist = stats["histograms"]["engine_spill_s"]
    restore_hist = stats["histograms"]["engine_restore_s"]
    totals = {k: stats[k] for k in (
        "spill-pages-total", "spill-bytes-total", "host-demotions-total",
        "restored-hits-total", "restore-failures-total", "recompute-fallbacks-total",
        "restore-pages-total", "restore-bytes-total", "restore-verify-s-total",
        "host-evictions-total", "host-pages-in-use", "spill-failures-total")}
    log(f"tiered totals llama-3-8b bf16 {json.dumps(totals)}")
    log(f"tiered spill worker: {spill_hist['count']} entries, {spill_hist['sum']:.3f}s "
        f"(wait + checksum), {stats['spill-bytes-total'] / max(spill_hist['sum'], 1e-9) / 1e9:.3f}"
        f" GB/s; p50 {spill_hist['p50'] * 1e3:.1f} ms an entry")
    log(f"tiered restore (one entry, stopped engine) {json.dumps(check)}")
    log(f"tiered restores in round 2: {restore_hist['count']}, p50 "
        f"{restore_hist['p50'] * 1e3:.1f} ms, mean "
        f"{restore_hist['sum'] / max(1, restore_hist['count']) * 1e3:.1f} ms an entry")
    ttft = {"tier": [r2["ttft_p50_s"], r2["ttft_max_s"]],
            "tier_off": [off2["ttft_p50_s"], off2["ttft_max_s"]],
            "no_eviction": [ref2["ttft_p50_s"], ref2["ttft_max_s"]],
            "tier_off_cold": sum(1 for r in off_routes.values() if r == "cold"),
            "tier_restored": sum(1 for r in routes.values() if r == "restored")}
    log(f"tiered round-2 TTFT p50/max s (one turn at a time) {json.dumps(ttft)}")
    log(f"tiered decode step with a spill in flight {json.dumps(overlap)}")
    log(f"tiered decoders beside a restore {json.dumps(itl)}")
    log(f"tiered launches round 1 {json.dumps(r1['kernel_launches'])} round 2 "
        f"{json.dumps(r2['kernel_launches'])} ({r2['warm_admissions']} warm admissions, "
        f"{r2['decode_steps']} decode steps, {r2['decode_chunks']} chunks, "
        f"{r2['graph_replays']} replays)")
    log(f"tiered memory {json.dumps(memory)}")
    log(f"tiered tokens {json.dumps({'round1': same1, 'round2': same2})}")
    log(f"tiered restored vs cold logits {json.dumps(held)}")
    log(f"tiered spill drill {json.dumps(drill)}")
    brief = ("wall_s", "tokens_per_s", "ttft_p50_s", "ttft_max_s", "admit_groups",
             "warm_admissions", "decode_steps", "decode_chunks", "graph_replays",
             "graph_capture_s", "tier")
    for label, run in (("round1", r1), ("round2", r2), ("off_round1", off1),
                       ("off_round2", off2), ("ref_round2", ref2)):
        log(f"tiered {label} {json.dumps({k: run.get(k) for k in brief})}")
    for same in (same1, same2):
        if not same["ok"]:
            raise AssertionError(f"tiered tokens: {same}")
    if memory_error is not None:
        raise memory_error
    engine.stop()
    del engine, logits, off_logits, ref_logits
    _fresh_base(torch)
    # the int8 pass: 8 sessions one at a time through a 64-page int8 pool
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    k = TIERED_INT8_SESSIONS
    ref8 = _tiered_engine(ctx, cfg8, params)
    _tier_round(ctx, cfg8, params, ref8, first[:k], sequential=True)
    ref8_2 = _tier_round(ctx, cfg8, params, ref8, again[:k], sequential=True)
    del ref8
    eng8 = _tiered_engine(ctx, cfg8, params, kv_pages=TIERED_INT8_POOL, **TIERED_TIER)
    a8 = _tier_round(ctx, cfg8, params, eng8, first[:k], sequential=True)
    check8 = _restore_check(torch, eng8, timer)
    b8 = _tier_round(ctx, cfg8, params, eng8, again[:k], sequential=True)
    same8 = _same_or_tie(ctx, cfg8, params, "tiered int8 round 2 vs reference", again[:k],
                         b8["_tokens"], ref8_2["_tokens"])
    drill8 = _spill_drill(ctx, cfg8, params, eng8, again[:k], ref8_2["_tokens"])
    stats8 = eng8.stats()
    bytes8 = eng8._pagepool.bytes_per_page
    eng8.stop()
    log(f"tiered int8: {bytes8} bytes a page (bf16 "
        f"{tier.bytes_per_page}); totals "
        f"{json.dumps({key: stats8[key] for key in totals})}; restore {json.dumps(check8)}; "
        f"round 2 {json.dumps(b8['tier'])}; tokens {json.dumps(same8)}; drill {json.dumps(drill8)}")
    if not same8["ok"] or b8["tier"]["restored-hits-total"] <= 0:
        raise AssertionError(f"tiered int8: tokens {same8}, round 2 {b8['tier']}")
    del eng8, a8
    durable = _tiered_durable(ctx, cfg, histories, first, again, ref2["_tokens"])
    log(f"tiered durable {json.dumps(durable)}")
    launches: dict = {}
    for run in (r1, r2, b8):
        for name, count in run["kernel_launches"].items():
            launches[name] = launches.get(name, 0) + count
    ctx["tiered"] = {"kernel_launches": launches}
    # the readings again, short: printed after every phase, where a reader
    # of only the output's last lines still finds them
    restore = ("restore_ms", "checksum_host_ms", "checksum_one_thread_ms", "upload_device_ms",
               "pinned_copy_bound_ms", "spill_copy_ms")
    ctx["summaries"] = ctx.get("summaries", []) + [("tiered", {
        "arena": [tier.bytes_total, round(tier.alloc_s, 3)],
        "totals": totals,
        "spill_worker_gbps": stats["spill-bytes-total"] / max(spill_hist["sum"], 1e-9) / 1e9,
        "spill_worker_ms_p50": spill_hist["p50"] * 1e3,
        "restore_bf16": {k: check[k] for k in restore},
        "restores_round2_ms": [restore_hist["p50"] * 1e3,
                               restore_hist["sum"] / max(1, restore_hist["count"]) * 1e3],
        "ttft_round2": ttft,
        "decode_step_ms": [overlap["decode_step_ms_idle"],
                           overlap["dma"]["decode_step_ms_spill_in_flight"],
                           overlap["dma"]["spill_copy_ms"],
                           overlap["staged"]["decode_step_ms_spill_in_flight"],
                           overlap["staged"]["spill_copy_ms"]],
        "itl_beside_restore": itl,
        "memory": [memory.get("peak_allocated_bytes"), memory.get("peak_reserved_growth_bytes"),
                   memory.get("plan_beyond_weights_bytes")],
        "logits": held, "tokens_equal": [same1["equal"], same2["equal"]],
        "int8": {"bytes_a_page": bytes8,
                 "restore": {k: check8[k] for k in restore},
                 "restored_hits": b8["tier"]["restored-hits-total"],
                 "tokens_equal": same8["equal"]},
        "durable": {"checkpoint_gbps": durable["a"]["checkpoint_gbps"],
                    "hibernate_s": durable["a"]["hibernate_s"],
                    "restore_ms": [durable["b"]["restore_ms_p50"], durable["b"]["restore_ms_mean"]],
                    "file_read_ms": durable["b"]["sequential_read_ms"],
                    "restored_hits": durable["b"]["durable_restored_hits"],
                    "ttft": [durable["b"]["ttft_p50_s"], durable["b"]["ttft_max_s"]]},
    })]
    del timer


FLEET_BYTES = tuple(2100 + 250 * i for i in range(8))  # 2100, 2350, ..., 3850 byte tokens
FLEET_NEW = 32
# both engines: the default buckets (32 ... 2048: a prompt binds at the
# same boundary on either), page 64, 4096 wide; every prompt is longer
# than the widest bucket, so it prefills in segments on "pre" and resumes
# on "dec" as one warm segment past its 2048-token prefix
FLEET_KW = {"max_seq_len": 4096, "prefix_cache": "auto"}
FLEET_PREFIX = 2048
FLEET_INT8_REQUESTS = 4
FLEET_PREAMBLE = 1024
FLEET_TURNS = (40, 60)


def _fleet_engine(ctx, cfg, params, **kw):
    """One port engine of the phase, started (engines are started one
    after the other: each captures its graphs alone) and warmed up."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import ServingEngine
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = ServingEngine(
        cfg, params, max_batch=8, decode_chunk=16, page_size=PAGE, eos_token_id=tok.eos_token_id,
        rng_seed=ctx["seed"], device="cuda", **{**FLEET_KW, **kw},
    )
    engine.start()
    engine.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
    return engine


def _fleet_router(pre, dec, migrate: bool = True, roles=("prefill", "decode"), **kw):
    from langstream_tpu_torch.serving.fleet import FleetRouter, InProcessReplica

    kw.setdefault("prefill_route_threshold", FLEET_PREFIX)
    return FleetRouter([InProcessReplica("pre", pre, role=roles[0]),
                        InProcessReplica("dec", dec, role=roles[1])], migrate=migrate, **kw)


class _MigrationLog:
    """Records each migration through ``serving/migrate.py``'s module
    functions (the router's ``_migrate`` / ``_p2p_fetch`` and ``transfer``
    call them): the start (the export's snapshot), the page frames'
    stamps (``keep_bytes``: their bytes too), the ACK with both sides'
    phases, and the end."""

    def __init__(self, keep_bytes: bool = False) -> None:
        from langstream_tpu_torch.serving import migrate

        self.mig, self.keep_bytes = migrate, keep_bytes
        self.export, self.bind = migrate.export_frames, migrate.bind_frames
        self.records: list = []
        self.starts: dict = {}
        self.lock = threading.Lock()

    def __enter__(self) -> "_MigrationLog":
        import base64

        def export(engine, tokens, *a, **kw):
            if kw.get("phases") is None:
                kw["phases"] = {}
            self.starts[threading.get_ident()] = (time.perf_counter(), kw["phases"])
            return self.export(engine, tokens, *a, **kw)

        def bind(engine, frames, *a, **kw):
            t0, sent = self.starts.pop(threading.get_ident(), (None, {}))
            rec = {"t0": t0, "sent": sent, "stamps": [], "page_bytes": []}

            def tap():
                try:
                    for f in frames:
                        if f.get("kind") == "begin":
                            rec["tokens"] = list(f["prompt_tokens"])
                        elif f.get("kind") == "page":
                            rec["stamps"].append(f["checksum"])
                            if self.keep_bytes:
                                rec["page_bytes"].append(
                                    f["raw"] if f.get("raw") is not None
                                    else b"".join(base64.b64decode(d) for d in f["data"]))
                        yield f
                finally:
                    frames.close()

            ack = self.bind(engine, tap(), *a, **kw)
            rec["t1"] = time.perf_counter()
            rec["ack"] = ack
            with self.lock:
                self.records.append(rec)
            return ack

        self.mig.export_frames, self.mig.bind_frames = export, bind
        return self

    def __exit__(self, *exc) -> None:
        self.mig.export_frames, self.mig.bind_frames = self.export, self.bind

    def phases(self, rec: dict) -> dict:
        """One migration's phases (ms), pages, bytes and GB/s end to end."""
        ack, sent = rec["ack"], rec["sent"]
        total = (rec["t1"] - rec["t0"]) * 1e3 if rec["t0"] is not None else None
        return {
            "tier": sent.get("tier"), "pages": ack["pages"], "bytes": ack["bytes"],
            "snapshot_ms": sent.get("snapshot_ms"), "copy_ms": sent.get("copy_ms"),
            "checksum_ms": sent.get("checksum_ms"), "encode_ms": sent.get("encode_ms"),
            "decode_ms": ack.get("decode_ms"), "verify_ms": ack.get("verify_ms"),
            "upload_ms": ack.get("upload_ms"), "bind_ms": ack.get("bind_ms"),
            "total_ms": total,
            "gb_per_s": ack["bytes"] / total / 1e6 if total else None,
        }


def _fleet_burst(router, prompts, new: int) -> list:
    """Every prompt through ``router.stream_generate`` at once, each on its
    own thread, greedy: per request its tokens, the replicas that served
    them, each token's arrival, the terminal frame and the submit time."""
    out: list = [None] * len(prompts)
    errors: list = []

    def run(i: int) -> None:
        try:
            rec = {"t0": time.monotonic(), "tokens": [], "stamps": [], "served": [],
                   "end": None}
            for f in router.stream_generate(prompts[i], {"max-tokens": new, "temperature": 0.0}):
                if f["kind"] == "tokens":
                    now = time.monotonic()
                    rec["tokens"].extend(f["tokens"])
                    rec["stamps"].extend([now] * len(f["tokens"]))
                    rec["served"].append(f["replica"])
                elif f["kind"] == "end":
                    rec["end"] = f
                    rec["t_end"] = time.monotonic()
            out[i] = rec
        except BaseException as e:  # noqa: BLE001 — raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"fleet burst: {errors or 'a stream did not end'}")
    for p, r in zip(prompts, out):
        if r["end"] is None or len(r["tokens"]) != new:
            raise AssertionError(f"fleet: a {len(p)}-token request ended {r['end']} with "
                                 f"{len(r['tokens'])} tokens")
    return out


def _fleet_times(runs: list) -> list:
    """Each request's TTFT, handoff gap (first to second token) and total,
    in seconds."""
    return [[r["stamps"][0] - r["t0"], r["stamps"][1] - r["stamps"][0], r["t_end"] - r["t0"]]
            for r in runs]


def _fleet_leak_check(engine, label: str) -> None:
    """Every page in use is held by the prefix index or a slot (JAX's
    ``tests/test_migration.py`` leak check)."""
    pool = engine._pagepool
    slot_pages = sum(len(pool.slot_pages(i)) for i in range(engine.max_batch))
    if pool.pages_in_use > engine._prefix_index.pages_held + slot_pages or (
            pool.free_pages + pool.pages_in_use != pool.num_pages):
        raise AssertionError(f"fleet {label}: pages leaked ({pool.pages_in_use} in use, "
                             f"{engine._prefix_index.pages_held} held, {slot_pages} in slots)")


FLEET_KEYS = ("prefill-segments-total", "decode-steps-total", "decode-chunks-total",
              "graph-replays-total", "prefill-tokens-saved-total", "migrate-pages-in-total",
              "migrate-pages-out-total", "engine-restarts-total")


def _fleet_pass(ctx, cfg, router, engines: dict, prompts, keep_bytes: bool = False) -> dict:
    """One routed burst with the kernel counts zeroed just before and read
    just after: the runs, each engine's counter deltas, the launches (no
    plain version may run), the router's stats and the migrations."""
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    before = {name: e.stats() for name, e in engines.items()}
    router.start()
    try:
        with _MigrationLog(keep_bytes) as mlog:
            reset_kernel_counts()
            runs = _fleet_burst(router, prompts, FLEET_NEW)
            counts = kernel_counts()
    finally:
        router.stop()
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    if plain:
        raise AssertionError(f"fleet: plain versions ran on the card's main path: {plain}")
    after = {name: e.stats() for name, e in engines.items()}
    delta = {name: {k: after[name][k] - before[name][k] for k in FLEET_KEYS} for name in engines}
    launches = {k: v["launches"] for k, v in counts.items()}
    # every decode chunk of either engine is one graph replay, and the
    # kernels ran exactly layers x the work each engine counts
    for name, d in delta.items():
        if d["graph-replays-total"] != d["decode-chunks-total"]:
            raise AssertionError(f"fleet {name}: {d['decode-chunks-total']} chunks, "
                                 f"{d['graph-replays-total']} replays")
        if d["engine-restarts-total"]:
            raise AssertionError(f"fleet {name}: {d['engine-restarts-total']} restarts")
    segments = sum(d["prefill-segments-total"] for d in delta.values())
    steps = sum(d["decode-steps-total"] for d in delta.values())
    seg, dec = _kernel_name("flash_segment", cfg), _kernel_name("paged_decode", cfg)
    if launches.get(seg, 0) != cfg.n_layers * segments or launches.get(dec, 0) != (
            cfg.n_layers * steps) or steps <= 0:
        raise AssertionError(f"fleet: launches {launches} against {segments} segments and "
                             f"{steps} decode steps of {cfg.n_layers} layers")
    return {"runs": runs, "delta": delta, "kernel_launches": launches,
            "router": router.stats(), "migrations": mlog.records, "log": mlog}


def _fleet_migrated(ctx, cfg, p2: dict, pre, dec, prompts, label: str) -> dict:
    """Pass 2's (or the int8 pass's) handoff checks: every request served by
    pre then dec, one migration each and no fallback, dec's pages in equal
    to pre's pages out (a 2048-token prefix a request), pre holding no entry
    for any prompt, dec one warm segment a request over its prefix, both
    pools leak-free; and the migrated pages on dec against the sender's
    stamps (``keep_bytes``: their bytes)."""
    import hashlib

    n = len(prompts)
    pages = FLEET_PREFIX // PAGE
    for p, r in zip(prompts, p2["runs"]):
        if set(r["served"]) != {"pre", "dec"} or r["served"][0] != "pre":
            raise AssertionError(f"fleet {label}: a {len(p)}-token request served by "
                                 f"{r['served']}")
    st, dp, dd = p2["router"], p2["delta"]["pre"], p2["delta"]["dec"]
    if st["fleet-migrations-total"] != n or st["fleet-migrate-fallbacks-total"] != 0:
        raise AssertionError(f"fleet {label}: router {st}")
    if not dd["migrate-pages-in-total"] == dp["migrate-pages-out-total"] == n * pages:
        raise AssertionError(f"fleet {label}: pages in {dd} out {dp}")
    if dd["prefill-segments-total"] != n or dd["prefill-tokens-saved-total"] != n * FLEET_PREFIX:
        raise AssertionError(f"fleet {label}: dec's warm resumes {dd}")
    if any(pre._prefix_index.deepest_entry(p) is not None for p in prompts):
        raise AssertionError(f"fleet {label}: pre kept an entry after the release")
    _fleet_leak_check(pre, f"{label} pre")
    _fleet_leak_check(dec, f"{label} dec")
    import torch

    held = 0
    for rec in p2["migrations"]:
        # the frames carry the prefix's tokens: one more makes it usable
        hit = dec._prefix_index.deepest_entry(rec["tokens"] + [0])
        if hit is None or hit[0] != FLEET_PREFIX:
            raise AssertionError(f"fleet {label}: dec holds no {FLEET_PREFIX}-token entry")
        image = _page_image(torch, dec, hit[1].pages[:pages])
        sums = [hashlib.blake2b(b, digest_size=16).hexdigest() for b in image]
        if sums != rec["stamps"] or (rec["page_bytes"] and image != rec["page_bytes"]):
            raise AssertionError(f"fleet {label}: dec's migrated pages differ from the sender's")
        held += len(sums)
    return {"pages_held_to_sender": held, "bytes_compared": bool(p2["migrations"][0]["page_bytes"])}


def _fleet_drill(ctx, cfg, params, pre, dec, spec: str, prompt, want) -> dict:
    """One request with the wire site ``spec`` planted in its migration: it
    decodes in place on pre with pass 1's tokens (or ties), dec's free pages
    stay as they were, pre keeps its entry, and one valid ``migrate-failed``
    dump says decode-in-place."""
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.fleet import set_wire_injector
    from langstream_tpu_torch.serving.observability import recent_dumps, validate_flight_dump

    router = _fleet_router(pre, dec)
    dumps0 = len([d for d in recent_dumps() if d.get("reason") == "migrate-failed"])
    free_dec = dec._pagepool.free_pages
    set_wire_injector(FaultInjector(spec, seed=0))
    try:
        router.start()
        run = _fleet_burst(router, [prompt], FLEET_NEW)[0]
    finally:
        router.stop()
        set_wire_injector(None)
    st = router.stats()
    dumps = [d for d in recent_dumps() if d.get("reason") == "migrate-failed"]
    same = _same_or_tie(ctx, cfg, params, f"fleet drill {spec}", [prompt], [run["tokens"]],
                        [want])
    out = {"served": sorted(set(run["served"])), "fallbacks": st["fleet-migrate-fallbacks-total"],
           "dec_free_pages": [free_dec, dec._pagepool.free_pages],
           "pre_retains": pre._prefix_index.deepest_entry(prompt) is not None,
           "dumps": len(dumps) - dumps0, "tokens": same}
    if (out["served"] != ["pre"] or out["fallbacks"] != 1 or free_dec != dec._pagepool.free_pages
            or not out["pre_retains"] or out["dumps"] != 1 or not validate_flight_dump(dumps[-1])
            or dumps[-1]["extra"].get("fallback") != "decode-in-place" or not same["ok"]):
        raise AssertionError(f"fleet drill {spec}: {out}")
    out["error"] = dumps[-1]["extra"].get("error")
    return out


def _fleet_p2p(ctx, cfg, params, a, b) -> dict:
    """Two mixed engines: a 1024-token preamble published on ``a``; a
    prompt sharing it, routed to ``b`` (``a`` made the worse route by its
    load at λ 256), admits warm through the router's P2P fetch of ``a``'s
    pages; ``a`` keeps its entry; the tokens are a cold run's (or ties)."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    texts = _prompts([FLEET_PREAMBLE - 1, *FLEET_TURNS], ctx["seed"] + 23)
    preamble = tok.encode(texts[0])[:FLEET_PREAMBLE]
    first, prompt = (preamble + list(t.encode()) for t in texts[1:])
    greedy = GenerationOptions(max_new_tokens=FLEET_NEW, temperature=0.0)
    cold = b.generate(prompt, greedy, timeout=600).tokens
    b.migrate_release(prompt, FLEET_PREAMBLE)  # b forgets it: the fetch must bring it
    a.generate(first, GenerationOptions(max_new_tokens=4), timeout=600)
    router = _fleet_router(a, b, roles=("mixed", "mixed"), lam=256.0, p2p_threshold=256,
                           refresh_interval_s=3600.0)
    router.refresh_all()
    with router._lock:
        # the owner 5 load units above the other: 1024 - 256 x 5 < 0
        other = router._replicas["dec"].beacon["load_score"]
        router._replicas["pre"].beacon["load_score"] = other + 5.0
    saved0 = b.stats()["prefill-tokens-saved-total"]
    with _MigrationLog() as mlog:
        run = _fleet_burst(router, [prompt], FLEET_NEW)[0]
    st = router.stats()
    same = _same_or_tie(ctx, cfg, params, "fleet p2p vs cold", [prompt], [run["tokens"]], [cold])
    out = {"served": sorted(set(run["served"])), "p2p_fetch": st["fleet-p2p-fetch-total"],
           "p2p_fallback": st["fleet-p2p-fetch-fallback-total"],
           "p2p_bytes": st["fleet-p2p-bytes-in-total"],
           "saved": b.stats()["prefill-tokens-saved-total"] - saved0,
           "owner_keeps": a._prefix_index.deepest_entry(first) is not None,
           "ttft_s": run["stamps"][0] - run["t0"],
           "fetch": [mlog.phases(r) for r in mlog.records], "tokens": same}
    if (out["served"] != ["dec"] or out["p2p_fetch"] != 1 or out["p2p_fallback"] != 0
            or out["saved"] != FLEET_PREAMBLE or not out["owner_keeps"] or not same["ok"]):
        raise AssertionError(f"fleet p2p: {out}")
    return out


def _fleet_host_arena(ctx, cfg, params, dec, prompt) -> dict:
    """"pre" with the host tier (``host-kv-fraction`` 1.0, ``spill-idle-s``
    0): once the prompt's published prefix has spilled, its migration
    reports tier host and ships the stored stamps, and dec's pages are
    bit-equal to the arena's."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving import migrate

    import torch

    # a 128-page pool (its arena 1 GiB pinned) holds the one request
    pre = _fleet_engine(ctx, cfg, params, host_kv_fraction=1.0, spill_idle_s=0.0,
                        migrate_staging=True, kv_pages=128)
    try:
        pre.generate(prompt, GenerationOptions(max_new_tokens=1), timeout=600)
        pages = FLEET_PREFIX // PAGE
        deadline = time.monotonic() + 120
        while pre.stats()["spill-pages-total"] < pages:
            if time.monotonic() > deadline:
                raise AssertionError("fleet host: the prefix never spilled")
            time.sleep(0.01)
        time.sleep(0.05)  # the engine thread folds the finished spill in
        _, entry = pre._prefix_index.deepest_entry(prompt)
        tier = pre._host_tier
        if len(entry.host) < pages or entry.spilling is not None:
            raise AssertionError("fleet host: the entry holds no complete host copy")
        slots = entry.host[:pages]
        arena = [tier.page_bytes(s) for s in slots]
        stamps = [tier.checksum(s).hex() for s in slots]
        phases: dict = {}
        with _MigrationLog() as mlog:
            ack = migrate.transfer(pre, dec, prompt, phases=phases)
        hit = dec._prefix_index.deepest_entry(prompt)
        image = _page_image(torch, dec, hit[1].pages[:pages])
        out = {"tier": phases["tier"], "pages": ack["pages"], "stamps_stored": mlog.records[0][
            "stamps"] == stamps, "bit_equal": image == arena,
            "migration": mlog.phases(mlog.records[0]), "arena_bytes": tier.bytes_total,
            "arena_alloc_s": tier.alloc_s}
        if out["tier"] != "host" or not out["stamps_stored"] or not out["bit_equal"]:
            raise AssertionError(f"fleet host: {out}")
        return out
    finally:
        pre.stop()


def phase_fleet(ctx: dict) -> None:
    """KV-page migration and the fleet on one card (module docstring, phase
    16): the no-migration reference, the disaggregated burst, the two
    drills, the P2P fetch between two mixed engines, the host-arena
    migration and the int8 pass."""
    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    tok = ByteTokenizer()
    prompts = [tok.encode(t) for t in _prompts(list(FLEET_BYTES), ctx["seed"] + 19)]
    base_alloc, base_reserved = _fresh_base(torch)
    # two engines on ONE weight tree (nothing copies it), started one after
    # the other
    pre = _fleet_engine(ctx, cfg, params, migrate_staging=True)
    built = {"pre": torch.cuda.max_memory_allocated() - base_alloc}
    torch.cuda.reset_peak_memory_stats()
    base_dec = torch.cuda.memory_allocated()
    dec = _fleet_engine(ctx, cfg, params)
    built["dec"] = torch.cuda.max_memory_allocated() - base_dec
    engines = {"pre": pre, "dec": dec}
    # pass 1: every request decodes in place on pre
    p1 = _fleet_pass(ctx, cfg, _fleet_router(pre, dec, migrate=False), engines, prompts)
    if any(set(r["served"]) != {"pre"} for r in p1["runs"]):
        raise AssertionError("fleet reference: a request left pre")
    for p in prompts:
        pre.migrate_release(p, FLEET_PREFIX)
    # pass 2: prefill and the first token on pre, the pages to dec, the
    # rest decoded warm on dec
    p2 = _fleet_pass(ctx, cfg, _fleet_router(pre, dec), engines, prompts)
    migrated = _fleet_migrated(ctx, cfg, p2, pre, dec, prompts, "burst")
    # each engine's build and the burst's peak of both against their
    # plans: the weights were on the card before the resets, so each plan
    # is charged beyond its weights term and the one shared tree is
    # counted once, in the baseline
    plans = [e.memory_plan.total_bytes - e.memory_plan.weights_bytes for e in (pre, dec)]
    memory = {"plans_beyond_weights_bytes": plans, "build_peak_bytes": built,
              "plan_summaries": [e.memory_plan.summary() for e in (pre, dec)],
              "peak_allocated_bytes": torch.cuda.max_memory_allocated() - base_alloc,
              "peak_reserved_growth_bytes": torch.cuda.max_memory_reserved() - base_reserved}
    for p in prompts:
        dec.migrate_release(p, FLEET_PREFIX)
    drills = [_fleet_drill(ctx, cfg, params, pre, dec, spec, prompts[i], p1["runs"][i]["tokens"])
              for i, spec in enumerate(("migrate@1", "net-cut@1"))]
    same = _same_or_tie(ctx, cfg, params, "fleet burst vs no migration", prompts,
                        [r["tokens"] for r in p2["runs"]], [r["tokens"] for r in p1["runs"]])
    p2p = _fleet_p2p(ctx, cfg, params, pre, dec)
    pre.stop()
    del pre, engines
    host = _fleet_host_arena(ctx, cfg, params, dec, prompts[2])
    dec.stop()
    beside = _bind_beside_decode(torch, dec, prompts[2])
    del dec
    _fresh_base(torch)
    # the int8 pass: 4 requests over int8 pools on both engines
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    k = FLEET_INT8_REQUESTS
    pre8 = _fleet_engine(ctx, cfg8, params, migrate_staging=True)
    dec8 = _fleet_engine(ctx, cfg8, params)
    e8 = {"pre": pre8, "dec": dec8}
    m8 = _fleet_pass(ctx, cfg8, _fleet_router(pre8, dec8), e8, prompts[:k], keep_bytes=True)
    migrated8 = _fleet_migrated(ctx, cfg8, m8, pre8, dec8, prompts[:k], "int8")
    bytes8 = pre8._pagepool.bytes_per_page
    pre8.stop()
    dec8.stop()
    del pre8, dec8, e8
    # the readings
    mig_bytes = p2["migrations"][0]["ack"]["bytes"]
    copy = _pinned_copy(torch, mig_bytes)
    migrations = [p2["log"].phases(r) for r in p2["migrations"]]
    times = {"no_migration": _fleet_times(p1["runs"]), "migrated": _fleet_times(p2["runs"])}
    dec_step = _fleet_dec_gaps(p2, p1)
    log(f"fleet requests (TTFT on pre, handoff gap, total s; prompt tokens "
        f"{[len(p) for p in prompts]}) {json.dumps(times)}")
    for i, m in enumerate(migrations):
        log(f"fleet migration {i} {json.dumps(m)}")
    log(f"fleet migration bytes {mig_bytes} beside one pinned host-to-device copy of them "
        f"{json.dumps(copy)}")
    log(f"fleet dec decode gaps {json.dumps(dec_step)}")
    log(f"fleet dec decode step beside a bind {json.dumps(beside)}")
    log(f"fleet burst {json.dumps({k: v for k, v in p2['router'].items() if k != 'histograms'})}")
    log(f"fleet engines {json.dumps({'pass1': p1['delta'], 'pass2': p2['delta']})}")
    log(f"fleet launches pass 1 {json.dumps(p1['kernel_launches'])} pass 2 "
        f"{json.dumps(p2['kernel_launches'])} int8 {json.dumps(m8['kernel_launches'])}")
    log(f"fleet migrated pages {json.dumps(migrated)} int8 {json.dumps(migrated8)} "
        f"({bytes8} bytes an int8 page)")
    log(f"fleet memory {json.dumps(memory)}")
    log(f"fleet tokens {json.dumps(same)}")
    for d in drills:
        log(f"fleet drill {json.dumps(d)}")
    log(f"fleet p2p {json.dumps(p2p)}")
    log(f"fleet host arena {json.dumps(host)}")
    if (memory["peak_allocated_bytes"] > sum(plans) or memory["peak_reserved_growth_bytes"] > (
            sum(plans)) or built["pre"] > plans[0] or built["dec"] > plans[1]):
        raise AssertionError(f"fleet memory: the peak passes both plans: {memory}")
    if not same["ok"]:
        raise AssertionError(f"fleet tokens: {same}")
    launches: dict = {}
    for run in (p2, m8):
        for name, count in run["kernel_launches"].items():
            launches[name] = launches.get(name, 0) + count
    ctx["fleet"] = {"kernel_launches": launches}
    mean = {key: sum(m[key] for m in migrations) / len(migrations)
            for key in ("snapshot_ms", "copy_ms", "checksum_ms", "encode_ms", "decode_ms",
                        "verify_ms", "upload_ms", "bind_ms", "total_ms", "gb_per_s")}
    ctx["summaries"] = ctx.get("summaries", []) + [("fleet", {
        "ttft_s": [[round(t[0], 4) for t in times[k]] for k in times],
        "handoff_gap_s": [[round(t[1], 4) for t in times[k]] for k in times],
        "total_s": [[round(t[2], 4) for t in times[k]] for k in times],
        "migration_mean": mean, "pinned_copy_gbps": copy["gb_per_s"],
        "dec_gaps": dec_step, "bind_beside_decode": beside, "ties": len(same["ties"]),
        "memory": [memory["peak_allocated_bytes"], memory["peak_reserved_growth_bytes"], plans],
        "drills": [d["served"] for d in drills], "p2p": [p2p["saved"], p2p["fetch"]],
        "host": [host["tier"], host["bit_equal"], host["migration"]],
        "int8_bytes_equal": migrated8["bytes_compared"],
    })]


def _fleet_dec_gaps(p2: dict, p1: dict) -> dict:
    """Dec's decoders during the burst: the gaps between their token bursts
    (a captured chunk of 16 steps each, past the handoff) at p50, and the
    largest; beside pass 1's on pre (the same traffic, no migration binding
    between its chunks)."""
    def gaps(runs, skip: int):
        out = []
        for r in runs:
            ts = sorted(set(r["stamps"][skip:]))
            out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
        return sorted(out)

    got, ref = gaps(p2["runs"], 1), gaps(p1["runs"], 1)
    pick = (lambda g: [g[len(g) // 2], g[-1]] if g else [None, None])
    return {"dec_gap_p50_max_ms": pick(got), "pre_in_place_gap_p50_max_ms": pick(ref)}


def _bind_beside_decode(torch, dec, prompt) -> dict:
    """On the stopped dec engine: two captured decode chunks back to back,
    and the same two with a migration's bind of a 2048-token prefix
    (``_bind_prefix``: 32 page uploads in place, on the engine's thread
    and stream) between them — what one bind costs the decoders of the
    engine it lands on: device and wall ms a step, and the bind's own host
    ms."""
    import random as _random

    # the engine's own command, its staging slots held for the binds below
    out = dec._migrate_cmd("snapshot", {"tokens": list(prompt), "ticket": threading.Event()})
    if out.get("event") is not None:
        out["event"].synchronize()
    blocks = out["blocks"]
    rng = _random.Random(5)
    fake = [rng.randrange(256) for _ in range(FLEET_PREFIX)]

    def two_chunks(bind: bool) -> tuple:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        start.record()
        dec._run_chunk((False, False))
        bind_ms = None
        if bind:
            t1 = time.monotonic()
            dec._bind_prefix(fake, FLEET_PREFIX, blocks)
            bind_ms = (time.monotonic() - t1) * 1e3
        dec._run_chunk((False, False))
        end.record()
        end.synchronize()
        steps = 2 * dec.decode_chunk
        if bind:
            _, entry = dec._prefix_index.deepest_entry(fake + [0])
            dec._prefix_index._drop(dec._pagepool, entry)
        return (start.elapsed_time(end) / steps, (time.monotonic() - t0) * 1e3 / steps, bind_ms)

    two_chunks(False)  # warm
    idle = sorted(two_chunks(False) for _ in range(3))[1]
    busy = sorted(two_chunks(True) for _ in range(3))[1]
    return {"idle_device_ms_per_step": idle[0], "idle_wall_ms_per_step": idle[1],
            "bind_device_ms_per_step": busy[0], "bind_wall_ms_per_step": busy[1],
            "bind_host_ms": busy[2], "pages": len(blocks)}


# ---------------------------------------------------------------------------
# fleet_http: the fleet across two processes on one card
# ---------------------------------------------------------------------------

FLEET_HTTP_MODEL = "llama-3-8b-shallow"  # 4 layers at full width: the default run's time
FLEET_HTTP_DEVICE = "cuda"
# the drill's prompt, the prompt that proves both processes hold the same
# weights, and the cancelled request's (all past the prefill threshold,
# none of them one of the burst's)
FLEET_HTTP_EXTRA_BYTES = (2200, 2300, 2400)
FLEET_HTTP_CANCEL_NEW = 1024
FLEET_HTTP_CANCEL_KEY = "fleet-http-cancel"


class _Lines:
    """A child's stdout lines, read on a thread (``get`` with a timeout)."""

    def __init__(self, stream) -> None:
        import queue

        self.q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._pump, args=(stream,), daemon=True).start()

    def _pump(self, stream) -> None:
        for line in stream:
            self.q.put(line)
        self.q.put(None)

    def get(self, timeout_s: float) -> dict:
        import queue

        deadline = time.monotonic() + timeout_s
        while True:
            try:
                line = self.q.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"fleet_http: the replica printed nothing in {timeout_s}s")
            if line is None:
                raise AssertionError("fleet_http: the replica's stdout closed")
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)


class _RouterTap:
    """Records what the provider's router does: each ``stream_generate``
    call's frames (its tokens, their arrival, the replicas that served
    them), each migration's ACK and span (``_migrate``), and the stamps of
    the page frames the parent exported."""

    def __init__(self, router, migrate_mod) -> None:
        self.router, self.mig = router, migrate_mod
        self.streams: dict = {}
        self.migrations: list = []
        self.stamps: dict = {}
        self.lock = threading.Lock()
        self._stream, self._migrate = router.stream_generate, router._migrate
        self._export = migrate_mod.export_frames
        tap = self

        def stream_generate(tokens, *a, **kw):
            rec = {"t0": time.monotonic(), "tokens": [], "stamps": [], "served": [], "end": None}
            with tap.lock:
                tap.streams[tuple(tokens)] = rec
            gen = tap._stream(tokens, *a, **kw)
            try:
                for f in gen:
                    if f["kind"] == "tokens":
                        now = time.monotonic()
                        rec["tokens"].extend(f["tokens"])
                        rec["stamps"].extend([now] * len(f["tokens"]))
                        rec["served"].append(f["replica"])
                    elif f["kind"] == "end":
                        rec["end"] = {k: v for k, v in f.items() if k != "decision"}
                        rec["t_end"] = time.monotonic()
                    yield f
            finally:
                gen.close()

        def migrate(src, dst, prompt, state):
            t0 = time.perf_counter()
            ack = tap._migrate(src, dst, prompt, state)
            with tap.lock:
                tap.migrations.append({"tokens": list(prompt), "ack": ack,
                                       "ms": (time.perf_counter() - t0) * 1e3})
            return ack

        def export(engine, tokens, *a, **kw):
            frames = tap._export(engine, tokens, *a, **kw)
            stamps: list = []
            with tap.lock:
                tap.stamps[tuple(tokens)] = stamps

            def gen():
                try:
                    for f in frames:
                        if f.get("kind") == "page":
                            stamps.append(f["checksum"])
                        yield f
                finally:
                    frames.close()
            return gen()

        router.stream_generate, router._migrate = stream_generate, migrate
        migrate_mod.export_frames = export

    def close(self) -> None:
        self.router.stream_generate, self.router._migrate = self._stream, self._migrate
        self.mig.export_frames = self._export

    def runs(self, prompts) -> list:
        return [self.streams[tuple(p)] for p in prompts]


def _completions(svc, texts, opts, consumer=None) -> list:
    """Every text through the provider's completions service at once."""
    import asyncio

    async def main():
        return await asyncio.gather(*(
            svc.get_text_completions([t], dict(opts), consumer) for t in texts
        ))

    return asyncio.run(main())


def _replica_pages_held(migrate_mod, url: str, migrations: list, stamps: dict) -> dict:
    """Each migrated prefix read back from the replica's pool over ``POST
    /fleet/pages`` (a copy: the replica hashes the pages it holds on the
    card, and keeps them), its stamps held against the ones the parent
    shipped."""
    held = 0
    for m in migrations:
        sent = stamps[tuple(m["tokens"])]
        got = [f["checksum"] for f in migrate_mod.fetch_pages(url, m["tokens"] + [0], 120.0)
               if f.get("kind") == "page"]
        if not sent or got != sent:
            raise AssertionError(f"fleet_http: the replica's pages of a {len(m['tokens'])}-token "
                                 f"prompt differ from the sender's stamps ({len(got)} pages)")
        held += len(got)
    return {"pages_held_to_sender": held}


def _wait_routable(router, n: int, timeout_s: float = 60.0) -> float:
    t0 = time.monotonic()
    while router.stats()["fleet-routable-replicas"] < n:
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"fleet_http: {router.stats()['fleet-routable-replicas']} of "
                                 f"{n} replicas routable after {timeout_s}s")
        time.sleep(0.1)
    return time.monotonic() - t0


def phase_fleet_http(ctx: dict) -> None:
    """The fleet across two processes on one card (module docstring, phase
    17): the provider with ``fleet: auto`` in this process (role prefill)
    and one replica process (role decode) behind its HTTP server."""
    import torch

    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
    from langstream_tpu_torch.models.loader import expected_params
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving import lifecycle
    from langstream_tpu_torch.serving import migrate as migrate_mod
    from langstream_tpu_torch.serving import wire
    from langstream_tpu_torch.serving.fleet import HttpReplica
    from langstream_tpu_torch.serving.memory import tree_bytes
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = MODEL_PRESETS[FLEET_HTTP_MODEL]
    ctx.pop("params", None)  # each process draws the seeded tree itself
    _fresh_base(torch)
    free_before = torch.cuda.mem_get_info()[0]
    tok = ByteTokenizer()
    texts = _prompts(list(FLEET_BYTES), ctx["seed"] + 19)  # the fleet phase's prompts
    drill_text, weights_text, cancel_text = _prompts(list(FLEET_HTTP_EXTRA_BYTES),
                                                     ctx["seed"] + 23)
    prompts = [tok.encode(t) for t in texts]
    base = {"model": FLEET_HTTP_MODEL, "seed": ctx["seed"], "device": FLEET_HTTP_DEVICE,
            "max-batch": 8, "decode-chunk": 16, "page-size": PAGE, "max-seq-len": 4096,
            "prefix-cache": "auto", "drain-grace-s": 30}
    # the replica: role decode, on a port chosen here; its wire cuts its
    # first stream frame (the drill's: the first stream it serves)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    replica_cfg = dict(base, **{"fleet-role": "decode", "fleet-replica-id": "dec",
                                "wire-fault-injection": "net-cut@1"})
    log_path = ROOT / "build" / "fleet_http_replica.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t_spawn = time.monotonic()
    with open(log_path, "w") as errlog:
        proc = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.serving.fleet", "--config",
             json.dumps(replica_cfg), "--port", str(port)],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=errlog, text=True,
        )
    provider = None
    tap = None
    try:
        lines = _Lines(proc.stdout)
        # this process's provider builds while the replica builds
        provider = TorchServingProvider(dict(base, **{
            "fleet": "auto", "fleet-role": "prefill", "fleet-replica-id": "pre",
            "fleet-replicas": [{"id": "dec", "url": url}],
            "fleet-prefill-threshold": FLEET_PREFIX, "fleet-migrate-timeout-s": 120,
        }))
        svc = provider.get_completions_service({})
        t0 = time.monotonic()
        engine = svc.engine()
        engine.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
        parent_build_s = time.monotonic() - t0
        start = lines.get(600)
        replica_start_s = time.monotonic() - t_spawn
        if start["url"] != url:
            raise AssertionError(f"fleet_http: the replica serves {start['url']}, not {url}")
        router = svc.fleet_router()
        _wait_routable(router, 2)
        tap = _RouterTap(router, migrate_mod)
        greedy = {"max-tokens": FLEET_NEW, "temperature": 0.0}
        params = svc.params()
        # pass 1, the reference: the provider's router with migration off
        # (each request routes here, the prefill replica, and decodes in
        # place: the provider would serve such a route natively, so the
        # router is driven directly for its tokens); then the drill's and
        # the weights check's prompts the same way, one at a time
        router.migrate_enabled = False
        t0 = time.monotonic()
        p1 = _fleet_burst(router, prompts, FLEET_NEW)
        p1_wall = time.monotonic() - t0
        drill_prompt, weights_prompt = tok.encode(drill_text), tok.encode(weights_text)
        ref_drill = _fleet_burst(router, [drill_prompt], FLEET_NEW)[0]["tokens"]
        ref_weights = _fleet_burst(router, [weights_prompt], FLEET_NEW)[0]["tokens"]
        router.migrate_enabled = True
        if any(set(r["served"]) != {"pre"} for r in p1):
            raise AssertionError("fleet_http reference: a request left this process")
        for p in prompts + [drill_prompt, weights_prompt]:
            engine.migrate_release(p, FLEET_PREFIX)
        router.refresh_all()  # the router no longer sees those prefixes here
        # the drill: prefill here, the pages to the replica, whose first
        # stream frame is cut — the router fails over to this engine with
        # prompt + delivered
        st0 = router.stats()
        _completions(svc, [drill_text], greedy)
        drill = tap.runs([drill_prompt])[0]
        st1 = router.stats()
        drill_out = {
            "served": drill["served"], "end_replica": drill["end"].get("replica"),
            "failovers": st1["fleet-stream-failovers-total"] - st0["fleet-stream-failovers-total"],
            "migrations": st1["fleet-migrations-total"] - st0["fleet-migrations-total"],
            "tokens": _same_or_tie(ctx, cfg, params, "fleet_http drill", [drill_prompt],
                                   [drill["tokens"]], [ref_drill]),
            "readmitted_after_s": _wait_routable(router, 2),
        }
        if (drill_out["failovers"] != 1 or drill_out["migrations"] != 1
                or drill_out["end_replica"] != "pre" or not drill_out["tokens"]["ok"]):
            raise AssertionError(f"fleet_http drill: {drill_out}")
        # the weights check: one request served by the replica alone, cold
        replica = HttpReplica("dec", url)
        replica.fetch_beacon()
        got = replica.generate(weights_prompt, greedy)["tokens"]
        weights_same = _same_or_tie(ctx, cfg, params, "fleet_http replica vs this process",
                                    [weights_prompt], [got], [ref_weights])
        if not weights_same["ok"]:
            raise AssertionError(f"fleet_http: the replica's tokens {weights_same}")
        # pass 2: disaggregated over HTTP, v2 negotiated
        if not ({"kvmig2", "frames2"} <= router._replicas["dec"].caps):
            raise AssertionError(f"fleet_http: the replica's caps {router._replicas['dec'].caps}")
        tap.streams.clear()
        tap.migrations.clear()
        wire0 = wire.wire_stats()
        before = engine.stats()
        st0 = router.stats()
        reset_kernel_counts()
        t0 = time.monotonic()
        _completions(svc, texts, greedy)
        p2_wall = time.monotonic() - t0
        counts = kernel_counts()
        after = engine.stats()
        st2 = router.stats()
        wire2 = {k: v - wire0[k] for k, v in wire.wire_stats().items()}
        p2 = tap.runs(prompts)
        migrations = list(tap.migrations)
        for p, r in zip(prompts, p2):
            if r["served"][0] != "pre" or set(r["served"]) != {"pre", "dec"}:
                raise AssertionError(f"fleet_http: a {len(p)}-token request served by "
                                     f"{r['served']}")
        routed = {k: st2[k] - st0[k] for k in (
            "fleet-migrations-total", "fleet-migrate-fallbacks-total", "fleet-migrate-pages-total",
            "fleet-migrate-bytes-total", "fleet-stream-failovers-total")}
        delta = {k: after[k] - before[k] for k in FLEET_KEYS}
        pages = len(prompts) * (FLEET_PREFIX // PAGE)
        if (routed["fleet-migrations-total"] != len(prompts)
                or routed["fleet-migrate-fallbacks-total"] or routed["fleet-stream-failovers-total"]
                or delta["migrate-pages-out-total"] != pages or len(migrations) != len(prompts)
                or any(m["ack"] is None for m in migrations)):
            raise AssertionError(f"fleet_http burst: router {routed}, engine {delta}")
        plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
        launches = {k: v["launches"] for k, v in counts.items()}
        seg, dec_k = _kernel_name("flash_segment", cfg), _kernel_name("paged_decode", cfg)
        if plain or launches.get(seg, 0) != cfg.n_layers * delta["prefill-segments-total"] or (
                launches.get(dec_k, 0) != cfg.n_layers * delta["decode-steps-total"]) or (
                delta["graph-replays-total"] != delta["decode-chunks-total"]):
            raise AssertionError(f"fleet_http parent: launches {launches} (plain {plain}) against "
                                 f"{delta}")
        same = _same_or_tie(ctx, cfg, params, "fleet_http burst vs no migration", prompts,
                            [r["tokens"] for r in p2], [r["tokens"] for r in p1])
        held = _replica_pages_held(migrate_mod, url, migrations, tap.stamps)
        # pass 4: a cancel forwarded by cancel-key, once the replica has
        # streamed 16 tokens of the request (random weights' tokens decode to
        # no text, so no chunk can say when)
        cancel_prompt = tok.encode(cancel_text)
        fired: dict = {}

        def canceller() -> None:
            t1 = time.monotonic()
            while time.monotonic() - t1 < 120:
                rec = tap.streams.get(tuple(cancel_prompt))
                if rec is not None and rec["served"].count("dec") and len(rec["tokens"]) >= 16:
                    fired["at_tokens"] = len(rec["tokens"])
                    fired["local"] = lifecycle.cancel(FLEET_HTTP_CANCEL_KEY)
                    return
                time.sleep(0.002)

        watcher = threading.Thread(target=canceller)
        watcher.start()
        t0 = time.monotonic()
        res = _completions(svc, [cancel_text], {
            "max-tokens": FLEET_HTTP_CANCEL_NEW, "temperature": 0.0,
            "cancel-key": FLEET_HTTP_CANCEL_KEY})[0]
        watcher.join()
        cancel = {"finish_reason": res.finish_reason, "completion_tokens": res.completion_tokens,
                  "s": time.monotonic() - t0, **fired,
                  "served": tap.runs([cancel_prompt])[0]["served"][-1]}
        t1 = time.monotonic()
        while replica.fetch_beacon()["active_slots"] and time.monotonic() - t1 < 30:
            time.sleep(0.05)
        cancel["slot_freed_after_s"] = time.monotonic() - t1
        if (res.finish_reason != "cancelled" or res.completion_tokens >= FLEET_HTTP_CANCEL_NEW
                or cancel["served"] != "dec" or cancel.get("local") != 0
                or replica.fetch_beacon()["active_slots"] or lifecycle._remote_by_key):
            raise AssertionError(f"fleet_http cancel: {cancel}")
        # the pages this process migrated out over the phase (the engine's
        # own counter also counts the releases after pass 1)
        migrated_total = router.stats()["fleet-migrate-pages-total"]
        _fleet_leak_check(engine, "parent")
        tap.close()
        tap = None
        # both processes down: this one's provider, then the replica (stdin)
        asyncio_close(provider)
        provider = svc = engine = router = params = None
        _fresh_base(torch)
        free_replica = torch.cuda.mem_get_info()[0]
        proc.stdin.close()
        exit_line = lines.get(300)
        code = proc.wait(timeout=120)
    finally:
        if tap is not None:
            tap.close()
        if provider is not None:
            asyncio_close(provider)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    free_after = torch.cuda.mem_get_info()[0]
    rs = exit_line["stats"]
    r_launches = {k: v["launches"] for k, v in exit_line["kernels"].items()}
    r_plain = {k: v["cpu_calls"] for k, v in exit_line["kernels"].items() if v["cpu_calls"]}
    if code != 0 or r_plain or rs["engine-restarts-total"] or (
            r_launches.get(seg, 0) != cfg.n_layers * rs["prefill-segments-total"]) or (
            r_launches.get(dec_k, 0) != cfg.n_layers * rs["decode-steps-total"]) or (
            rs["decode-steps-total"] <= 0 or rs["graph-replays-total"] != rs["decode-chunks-total"]):
        raise AssertionError(f"fleet_http replica: exit {code}, launches {r_launches} (plain "
                             f"{r_plain}) against {rs}")
    # the replica's pages in = this process's pages out (the drill's, the
    # burst's 256 and the cancelled request's), its pool leak-free
    if rs["migrate-pages-in-total"] != migrated_total or migrated_total != pages + 2 * (
            FLEET_PREFIX // PAGE) or rs["active-slots"] or (
            rs["kv-pages-in-use"] * rs["kv-bytes-per-page"] != rs["prefix-pool-bytes-in-use"]) or (
            rs["kv-pages-in-use"] + rs["kv-pages-free"] != rs["kv-pages-total"]):
        raise AssertionError(f"fleet_http replica: pages in {rs}, this process's out "
                             f"{migrated_total}")
    # the readings
    mig_bytes = migrations[0]["ack"]["bytes"]
    copy = _pinned_copy(torch, mig_bytes)
    phases = []
    for m in migrations:
        ack = m["ack"]
        ph = ack.get("phases") or {}
        phases.append({
            "pages": ack["pages"], "bytes": ack["bytes"],
            **{k: ph.get(k) for k in ("snapshot_ms", "copy_ms", "checksum_ms", "encode_ms",
                                     "transfer_ms")},
            **{k: ack.get(k) for k in ("decode_ms", "verify_ms", "upload_ms", "bind_ms")},
            "total_ms": m["ms"], "gb_per_s": ack["bytes"] / m["ms"] / 1e6,
        })
    times = {"no_migration": _fleet_times(p1), "migrated": _fleet_times(p2)}
    in_process = dict(ctx.get("summaries", [])).get("fleet")
    log(f"fleet_http start: replica {replica_start_s:.1f}s to its start line, this process's "
        f"provider {parent_build_s:.1f}s to warm")
    log(f"fleet_http requests (TTFT on pre, handoff gap, total s; prompt tokens "
        f"{[len(p) for p in prompts]}) {json.dumps(times)}")
    if in_process is not None:
        log(f"fleet_http beside the in-process fleet phase of this run (TTFT, handoff gap, total "
            f"s: no migration, migrated) {json.dumps({k: in_process[k] for k in ('ttft_s', 'handoff_gap_s', 'total_s', 'migration_mean')})}")
    for i, m in enumerate(phases):
        log(f"fleet_http migration {i} {json.dumps(m)}")
    log(f"fleet_http migration bytes {mig_bytes} beside one pinned host-to-device copy of them "
        f"{json.dumps(copy)}")
    log(f"fleet_http wire bytes: burst {json.dumps(wire2)}, this process "
        f"{json.dumps(wire.wire_stats())}, the replica {json.dumps(exit_line['wire'])}")
    log(f"fleet_http burst router {json.dumps(routed)} engine {json.dumps(delta)} walls "
        f"{p1_wall:.3f}s / {p2_wall:.3f}s")
    log(f"fleet_http launches: this process's burst {json.dumps(launches)}, the replica's life "
        f"{json.dumps(r_launches)}")
    log(f"fleet_http replica exit {json.dumps(rs)}")
    log(f"fleet_http pages {json.dumps(held)} pages out {migrated_total} in "
        f"{rs['migrate-pages-in-total']}")
    log(f"fleet_http tokens {json.dumps(same)}")
    log(f"fleet_http weights check {json.dumps(weights_same)}")
    log(f"fleet_http drill {json.dumps(drill_out)}")
    log(f"fleet_http cancel {json.dumps(cancel)}")
    memory = {"free_before_bytes": free_before, "free_replica_alive_bytes": free_replica,
              "free_after_bytes": free_after, "replica_released_bytes": free_after - free_replica,
              "this_process_kept_bytes": free_before - free_after}
    log(f"fleet_http memory {json.dumps(memory)}")
    merged: dict = dict(launches)
    for name, count in r_launches.items():
        merged[name] = merged.get(name, 0) + count
    ctx["fleet_http"] = {"kernel_launches": merged}
    mean = {key: sum(m[key] or 0.0 for m in phases) / len(phases)
            for key in ("snapshot_ms", "copy_ms", "checksum_ms", "encode_ms", "transfer_ms",
                        "decode_ms", "verify_ms", "upload_ms", "bind_ms", "total_ms",
                        "gb_per_s")}
    ctx["summaries"] = ctx.get("summaries", []) + [("fleet_http", {
        "ttft_s": [[round(t[0], 4) for t in times[k]] for k in times],
        "handoff_gap_s": [[round(t[1], 4) for t in times[k]] for k in times],
        "total_s": [[round(t[2], 4) for t in times[k]] for k in times],
        "migration_mean": mean, "pinned_copy_gbps": copy["gb_per_s"], "wire": wire2,
        "ties": len(same["ties"]), "drill": drill_out["served"], "cancel": cancel,
        "starts_s": [replica_start_s, parent_build_s], "memory": memory,
    })]
    # the replica gave back at least its weight tree when it exited, and the
    # card's free memory is within 1 GiB of what it was before the phase
    # (what this process keeps: its engine's cuBLAS and graph leftovers)
    tree = tree_bytes(expected_params(cfg))
    if memory["replica_released_bytes"] < tree or memory["this_process_kept_bytes"] > (1 << 30):
        raise AssertionError(f"fleet_http memory: {memory} (a tree is {tree} bytes)")
    if not same["ok"]:
        raise AssertionError(f"fleet_http tokens: {same}")


SPMD_NEW = 64
SPMD_KW = {"max_seq_len": 2048, "prefix_cache": "auto", "speculation": "auto",
           "speculation_tokens": 4}
SPMD_WATCHDOG_S = 2.0
# (b) and (c): the package's 4-layer preset at llama-3-8b's width (the
# follower process draws its tree by name; the default run's time)
SPMD_SERVE = {"model": "llama-3-8b-shallow", "max-seq-len": 2048, "max-batch": 8, "decode-chunk": 16,
              "page-size": PAGE}
SPMD_PROC_NEW = 32
SPMD_PROC_BYTES = (40, 80, 120, 160, 200, 240, 280, 320)


def _spmd_wait(pred, timeout_s: float, what: str) -> float:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"spmd: timed out after {timeout_s}s waiting for {what}")
        time.sleep(0.01)
    return time.monotonic() - t0


def _counting_channel(**kw):
    """A loopback wire counting its announcements by op (``by_op``) and
    timing them (``announce_s``)."""
    from langstream_tpu_torch.parallel import spmd_serving as wire

    class Channel(wire.LoopbackChannel):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.by_op: dict = {}
            self.announce_s = 0.0

        def announce(self, block):
            t0 = time.perf_counter()
            super().announce(block)
            self.announce_s += time.perf_counter() - t0
            self.by_op[block.op] = self.by_op.get(block.op, 0) + 1

    return Channel(**kw)


def _count_dispatches(leader, follower, methods: tuple) -> dict:
    """Count each engine's calls of ``methods`` (to wait for the follower
    to catch up with the leader) → {"leader": n, "follower": n}, live."""
    dispatched = {"leader": 0, "follower": 0}
    for name, engine in (("leader", leader), ("follower", follower)):
        for method in methods:
            real = getattr(engine, method)

            def counted(*a, _real=real, _name=name, **k):
                dispatched[_name] += 1
                return _real(*a, **k)

            setattr(engine, method, counted)
    return dispatched


def _spmd_loopback(ctx, cfg, params) -> dict:
    """Part (a): a leader and a follower engine in this process over a
    loopback channel, one weight tree, echo on. Returns the readings; raises
    on any failed check."""
    import numpy as np
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.parallel import spmd_serving as wire
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.observability import recent_dumps, validate_flight_dump
    from langstream_tpu_torch.serving.pagepool import table_len_for
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    # the tiers off (the tier pass builds its own pair with them on)
    kw = dict(max_batch=8, decode_chunk=16, page_size=PAGE, eos_token_id=tok.eos_token_id,
              rng_seed=ctx["seed"], device="cuda", prefill_batch=8, constrained_decoding="off",
              **SPMD_KW)
    ch = _counting_channel(prefill_batch=8, max_width=2048, max_batch=8,
                           table_len=table_len_for(SPMD_KW["max_seq_len"], PAGE),
                           spec_tokens=SPMD_KW["speculation_tokens"], echo=True, decode_chunk=16)
    leader = ServingEngine(cfg, params, spmd=ch, **kw)
    follower = ServingEngine(cfg, params, spmd=ch, **kw)
    dispatched = _count_dispatches(leader, follower, ("_dev_decode", "_dev_verify"))
    errors: list = []

    def run():
        try:
            wire.follower_loop(follower, ch)
        except BaseException as e:  # noqa: BLE001 — read below
            errors.append(e)

    thread = threading.Thread(target=run, name="spmd-follower", daemon=True)
    thread.start()
    t0 = time.monotonic()
    leader.start()
    sets = len(leader._graph_kinds())
    _spmd_wait(lambda: follower.graph_captures_total >= 3 * sets or errors, 300,
               "the follower's captures")
    capture_s = time.monotonic() - t0
    out: dict = {"pair_capture_s": capture_s, "graph_sets": list(leader._graph_kinds())}

    def caught_up():
        return errors or (ch._q.qsize() == 0 and dispatched["follower"] == dispatched["leader"])

    def serve(prompts, label: str) -> tuple:
        opts = GenerationOptions(max_new_tokens=SPMD_NEW, temperature=0.0)
        before, a0, b0 = leader.stats(), ch.announces_total, ch.bytes_announced_total
        s0, n0 = ch.announce_s, sum(ch.by_op.values())
        torch.cuda.synchronize()
        reset_kernel_counts()
        t = time.monotonic()
        reqs = [leader.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts]
        results = [r.result(timeout=900) for r in reqs]
        wall = time.monotonic() - t
        _spmd_wait(caught_up, 120, "the follower to replay the burst")
        torch.cuda.synchronize()
        counts = kernel_counts()
        after = leader.stats()
        if errors:
            raise AssertionError(f"spmd {label}: the follower failed: {errors[0]!r}")
        for p, r in zip(prompts, results):
            if r.error is not None or len(r.tokens) != SPMD_NEW:
                raise AssertionError(f"spmd {label}: request of {len(p)} tokens ended "
                                     f"{r.finish_reason}: {r.error}")
        steps = after["decode-steps-total"] - before["decode-steps-total"]
        verifies = after["spec-verify-dispatches-total"] - before["spec-verify-dispatches-total"]
        want = cfg.n_layers * (steps + verifies)
        got = counts["paged_decode"]["launches"]
        # the follower replays the leader's every dispatch: each engine
        # launches layers x (decode steps + verifies), the process twice that
        if got != 2 * want or want <= 0:
            raise AssertionError(f"spmd {label}: paged_decode launches {got} != 2 x {want}")
        if counts["flash_prefill"]["launches"] <= 0:
            raise AssertionError(f"spmd {label}: flash_prefill never launched")
        n = sum(ch.by_op.values()) - n0
        run = {
            "requests": len(results), "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in results) / wall,
            "decode_steps": steps, "verifies": verifies,
            "kernel_launches_per_engine": {k: v["launches"] // 2 for k, v in counts.items()},
            "announces": ch.announces_total - a0,
            "announce_bytes": ch.bytes_announced_total - b0,
            "announce_ms_mean": (ch.announce_s - s0) * 1e3 / max(1, n),
            "echoes": ch.by_op.get(wire.OP_ECHO, 0),
            "_tokens": [r.tokens for r in results],
        }
        run["bytes_per_announce"] = run["announce_bytes"] / max(1, run["announces"])
        return run

    prompts = [tok.encode(p) for p in _prompts(E2E_BYTES, ctx["seed"])]
    try:
        first = serve(prompts, "burst")
        dispatches = first["decode_steps"] // 16 + first["verifies"]
        if ch.by_op.get(wire.OP_ECHO, 0) < dispatches:
            raise AssertionError(f"spmd: {ch.by_op.get(wire.OP_ECHO, 0)} echoes for "
                                 f"{dispatches} decode chunks and verifies")
        out["burst"] = {k: v for k, v in first.items() if k != "_tokens"}
        ctx["spmd"] = {"kernel_launches": first["kernel_launches_per_engine"]}
        # a dropped idle heartbeat: the seq gap is reported, the leader
        # answers OP_RESYNC, the follower verifies and rejoins
        ch.watchdog_s = SPMD_WATCHDOG_S
        time.sleep(SPMD_WATCHDOG_S / 2)
        ch.injector = FaultInjector("spmd-drop@1", seed=0)
        out["resync_s"] = _spmd_wait(lambda: leader.stats()["spmd-resyncs-total"] >= 1, 60,
                                     "the resync")
        out["spmd_resyncs"] = leader.stats()["spmd-resyncs-total"]
        if out["spmd_resyncs"] != 1 or errors:
            raise AssertionError(f"spmd: resyncs {out['spmd_resyncs']}, follower {errors}")
        ch.watchdog_s = 0.0
        # an spmd-crash at the leader's iteration top: OP_RECOVER, both sides
        # rebuild and capture again, and serve on
        captured = (leader.graph_captures_total, follower.graph_captures_total)
        leader._injector = FaultInjector("spmd-crash@1", seed=0)
        t = time.monotonic()
        _spmd_wait(lambda: leader.stats()["spmd-recoveries-total"] >= 1, 60, "the recovery")
        leader._injector = None
        _spmd_wait(lambda: (leader.graph_captures_total >= captured[0] + 3 * sets
                            and follower.graph_captures_total >= captured[1] + 3 * sets
                            and not leader.recovering) or errors, 300,
                   "both sides' captures after the recovery")
        out["recover_s"] = time.monotonic() - t
        out["spmd_recoveries"] = leader.stats()["spmd-recoveries-total"]
        if out["spmd_recoveries"] != 1 or errors or not thread.is_alive():
            raise AssertionError(f"spmd: recoveries {out['spmd_recoveries']}, follower {errors}")
        second = serve(prompts, "after recovery")
        out["after_recovery"] = {k: v for k, v in second.items() if k != "_tokens"}
        out["tokens_after_recovery"] = _same_or_tie(ctx, cfg, params, "spmd recovery", prompts,
                                                   second["_tokens"], first["_tokens"])
        if not out["tokens_after_recovery"]["ok"]:
            raise AssertionError(f"spmd: tokens after the recovery: "
                                 f"{out['tokens_after_recovery']}")
        # a planted echo corruption (every echoed token + 1): the follower
        # must reject it — SpmdDivergenceError and an spmd-divergence dump
        real_echo = leader._spmd_echo

        def corrupt(kind, host):
            real_echo(kind, np.asarray(host) + 1)

        leader._spmd_echo = corrupt
        leader.generate(prompts[0], GenerationOptions(max_new_tokens=32), timeout=300)
        thread.join(timeout=60)
        if not errors or not isinstance(errors[0], wire.SpmdDivergenceError):
            raise AssertionError(f"spmd: the corrupted echo was not rejected: {errors}")
        dumps = [d for d in recent_dumps() if d.get("reason") == "spmd-divergence"]
        if not dumps:
            raise AssertionError("spmd: no spmd-divergence dump")
        validate_flight_dump(dumps[-1])
        out["planted_echo"] = {"rejected": type(errors[0]).__name__, "why": str(errors[0])[:160]}
    finally:
        leader.stop()
        thread.join(timeout=30)
    return out


def _spmd_two_processes(ctx, cfg) -> dict:
    """Part (b): the provider with ``mesh: {data: 2}`` from the port's
    registry — this process rank 0, the follower process on the same card —
    serves 8 requests with echo on; each process launches layers x (the
    leader's decode steps + verifies) paged decode kernels for them, exactly;
    ``close()`` must see the follower exit 0 and the card's free memory come
    back."""
    import gc

    import torch

    from langstream_tpu_torch.core.registry import REGISTRY
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    resource = dict(SPMD_SERVE, seed=ctx["seed"], mesh={"data": 2}, **{
        "spmd-parity-echo": True, "prefix-cache": "auto", "speculation": "auto",
        "constrained-decoding": "off"})
    t0 = time.monotonic()
    provider = REGISTRY.resource("tpu-serving").factory(resource)
    svc = provider.get_completions_service({})  # both ranks draw the seeded tree
    try:
        svc.engine()  # built, captured and started: the follower captures as announced
        start_s = time.monotonic() - t0
        texts = _prompts(list(SPMD_PROC_BYTES), ctx["seed"] + 3)
        before = svc.engine_stats()
        torch.cuda.synchronize()
        reset_kernel_counts()
        t = time.monotonic()
        results = _completions(svc, texts, {"max-tokens": SPMD_PROC_NEW, "temperature": 0})
        wall = time.monotonic() - t
        _spmd_wait(lambda: svc.engine_stats()["active-slots"] == 0, 60, "the leader's idle")
        torch.cuda.synchronize()
        leader = {k: v["launches"] for k, v in kernel_counts().items()}
        stats = svc.engine_stats()
        peak_free = torch.cuda.mem_get_info()[0]
    finally:
        asyncio_close(provider)
    codes, exit_lines, logs = svc.follower_exit_codes, svc.follower_exit_lines, svc.follower_logs
    svc._engine = None
    provider = svc = None
    gc.collect()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    if codes != [0]:
        raise AssertionError(f"spmd two processes: follower exit codes {codes} (logs {logs})")
    if len(results) != 8 or any(r.completion_tokens != SPMD_PROC_NEW for r in results):
        raise AssertionError(f"spmd two processes: {[r.completion_tokens for r in results]}")
    steps = stats["decode-steps-total"] - before["decode-steps-total"]
    verifies = stats["spec-verify-dispatches-total"] - before["spec-verify-dispatches-total"]
    want = cfg.n_layers * (steps + verifies)
    follower = (exit_lines[0] or {}).get("kernels", {}) if exit_lines else {}
    # the follower zeroed its counts after its last announced capture, and
    # replays every decode chunk and verify the leader dispatched
    if want <= 0 or leader["paged_decode"] != want or follower.get("paged_decode") != want:
        raise AssertionError(f"spmd two processes: paged_decode launches leader "
                             f"{leader['paged_decode']}, follower {follower.get('paged_decode')}, "
                             f"want {cfg.n_layers} x ({steps} + {verifies}) = {want}")
    if leader["flash_prefill"] <= 0 or follower.get("flash_prefill", 0) != leader["flash_prefill"]:
        raise AssertionError(f"spmd two processes: flash_prefill launches leader "
                             f"{leader['flash_prefill']}, follower {follower.get('flash_prefill')}")
    if free1 < free0 - 2 * 2**30:
        raise AssertionError(f"spmd two processes: free memory {free1 / 2**30:.2f} GiB after "
                             f"close vs {free0 / 2**30:.2f} GiB before")
    ctx["spmd_leader"] = {"kernel_launches": leader}
    ctx["spmd_follower"] = {"kernel_launches": follower}
    return {
        "requests": len(results), "wall_s": wall, "start_s": start_s,
        "decode_steps": steps, "verifies": verifies,
        "announces": stats["spmd-announces-total"],
        "announce_bytes": stats["spmd-announce-bytes-total"],
        "follower_exit_codes": codes, "leader_kernel_launches": leader,
        "follower_kernel_launches": follower,
        "free_gib_before": free0 / 2**30, "free_gib_serving": peak_free / 2**30,
        "free_gib_after": free1 / 2**30,
    }


def _spmd_world1(ctx) -> dict:
    """Part (c): the provider with ``mesh: {model: 1}`` — a world-1 NCCL
    group, the TP collectives inside the captured chunks — against one
    without a mesh on the same weights: each request served alone, tokens
    bit-equal; the decode step's device ms of each."""
    import torch

    from langstream_tpu_torch.core.registry import REGISTRY
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts(list(SPMD_PROC_BYTES), ctx["seed"] + 5)]
    runs = {}
    for label, extra in (("no_mesh", {}), ("mesh_model1", {"mesh": {"model": 1}})):
        provider = REGISTRY.resource("tpu-serving").factory(
            dict(SPMD_SERVE, seed=ctx["seed"], **extra))  # both draw the seeded tree
        svc = provider.get_completions_service({})
        try:
            engine = svc.engine()
            if extra and engine._tp is None:
                raise AssertionError("spmd: mesh {model: 1} built no TP handle")
            opts = GenerationOptions(max_new_tokens=SPMD_PROC_NEW, temperature=0.0)
            tokens = [engine.generate(p, opts, timeout=600).tokens for p in prompts]
            with torch.no_grad():
                rate = _replay_rate(torch, engine)
        finally:
            asyncio_close(provider)
        runs[label] = {"tokens": tokens, **rate}
    if runs["mesh_model1"]["tokens"] != runs["no_mesh"]["tokens"]:
        raise AssertionError("spmd: {model: 1} tokens differ from the no-mesh run")
    return {label: {k: v for k, v in r.items() if k != "tokens"} for label, r in runs.items()}


# The tier pass (F15): a multi-rank replica with two seeded adapters at
# scale 0.5, constrained decoding and the host KV tier over a pool of 40
# pages of 64, where a 1641-token chat history (27 pages, 16 published)
# demotes the other session's hibernated prefix. The mix, one request at a
# time: session A, session B (A's prefix demoted), an adapter, a grammar, an
# adapter with a grammar, a plain turn, A returning (restored), B returning
# with ``spmd-restore`` planted (the agreed fallback on every rank). Chunks
# of 8 steps and 32 new tokens keep the pass near 40 s; both grammars end
# within 32 bytes.
SPMD_TIER_NEW = 32
SPMD_TIER_CHUNK = 8
SPMD_TIER_HISTORY = 1600
SPMD_TIER_PUBLISHED = 1024  # the histories' published prefix (16 pages)
SPMD_TIER_FORMATS = {"verdict": AGENTIC_FORMATS["verdict"],
                     "words": {"type": "regex", "regex": "[a-z]{2,6}( [a-z]{2,6}){1,2}\\."}}
SPMD_TIER_ENGINE = {"max_seq_len": 2048, "prefix_cache": "auto", "kv_pages": 40,
                    "host_kv_fraction": 2.0, "spill_idle_s": 0.0, "speculation": "off",
                    "brownout": "off", "adapters": AGENTIC_ADAPTERS[:2], "adapter_pool_rows": 3,
                    "constrained_decoding": "on", "grammar_slots": 4}
SPMD_TIER_RESOURCE = {"prefix-cache": "auto", "kv-pages": 40, "host-kv-fraction": 2.0,
                      "spill-idle-s": 0.0, "speculation": "off", "brownout": "off",
                      "adapters": AGENTIC_ADAPTERS[:2], "adapter-pool-rows": 3,
                      "constrained-decoding": "auto", "grammar-slots": 4,
                      "decode-chunk": SPMD_TIER_CHUNK}


def _spmd_tier_mix(seed: int) -> list:
    """The tier pass's 8 requests (byte tokens, BOS first)."""
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    hist = _prompts([SPMD_TIER_HISTORY] * 2, seed + 21)
    turns = _prompts([40, 40, 60, 60, 60, 60, 30, 30], seed + 22)
    a, b = hist[0] + turns[0], hist[1] + turns[1]
    return [
        {"prompt": tok.encode(a)},
        {"prompt": tok.encode(b), "hibernated": 1},
        {"prompt": tok.encode(turns[2]), "adapter": "tenant-a"},
        {"prompt": tok.encode(turns[3]), "format": "verdict"},
        {"prompt": tok.encode(turns[4]), "adapter": "tenant-b", "format": "words"},
        {"prompt": tok.encode(turns[5])},
        {"prompt": tok.encode(a + turns[6]), "hibernated": 2},
        {"prompt": tok.encode(b + turns[7]), "drill": True},
    ]


def _hibernated(engine) -> int:
    """Live prefix entries of a session history holding a host copy."""
    return sum(1 for e in list(engine._prefix_index._live)
               if e.length >= SPMD_TIER_PUBLISHED and e.host and e.spilling is None)


def _serve_tier_mix(engine, mix: list, drill=None) -> dict:
    """Serve the mix one request at a time through ``engine`` (waiting for
    the session prefixes' host copies where a request needs one, and
    ``drill()`` before the drilled request) → its tokens and stats delta;
    every constrained output must end "stop" inside its grammar, every
    other one run to its tokens."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    before = engine.stats()
    results = []
    t0 = time.monotonic()
    for r in mix:
        if r.get("hibernated"):
            _spmd_wait(lambda: _hibernated(engine) >= r["hibernated"], 60,
                       "a session prefix's host copy")
        if r.get("drill") and drill is not None:
            drill()
        fmt = r.get("format")
        opts = GenerationOptions(max_new_tokens=SPMD_TIER_NEW, temperature=0.0,
                                 adapter=r.get("adapter"),
                                 response_format=SPMD_TIER_FORMATS[fmt] if fmt else None)
        res = engine.generate(r["prompt"], opts, timeout=600)
        text = tok.decode(res.tokens)
        if fmt is not None:
            if res.finish_reason != "stop" or not _in_grammar(SPMD_TIER_FORMATS[fmt], text):
                raise AssertionError(f"spmd tiers: {fmt} output {text!r} ({res.finish_reason}) "
                                     "is not in its grammar")
        elif res.error is not None or len(res.tokens) != SPMD_TIER_NEW:
            raise AssertionError(f"spmd tiers: a {len(r['prompt'])}-token request ended "
                                 f"{res.finish_reason}: {res.error}")
        results.append(res)
    wall = time.monotonic() - t0
    after = engine.stats()
    keys = ("admit-groups-total", "warm-admissions-total", "prefill-segments-total",
            "decode-steps-total", "spill-pages-total", "host-demotions-total",
            "restored-hits-total", "restore-pages-total", "restore-failures-total",
            "recompute-fallbacks-total", "adapter-swaps-total", "constrained-requests-total")
    return {"wall_s": wall, "tokens": [res.tokens for res in results],
            "delta": {k: after[k] - before[k] for k in keys}}


def _tier_launches(label: str, got: dict, layers: int, delta: dict, engines: int = 1) -> dict:
    """Each engine's launches of the mix: paged decode exactly layers x
    decode steps, the prefill kernel layers x cold groups, the segment
    kernel layers x (warm admissions + segments)."""
    want = {
        "paged_decode": layers * delta["decode-steps-total"],
        "flash_prefill": layers * delta["admit-groups-total"],
        "flash_segment": layers * (delta["warm-admissions-total"]
                                   + delta["prefill-segments-total"]),
    }
    for name, n in want.items():
        if got.get(name) != engines * n or n <= 0:
            raise AssertionError(f"spmd tiers {label}: {name} launches {got.get(name)} != "
                                 f"{engines} x {n}")
    return want


def _tier_restores(label: str, delta: dict) -> None:
    """One restore served (A's return), the drill the one fallback."""
    if (delta["restored-hits-total"] < 1 or delta["recompute-fallbacks-total"] != 1
            or delta["restore-failures-total"] < 1 or delta["host-demotions-total"] < 1):
        raise AssertionError(f"spmd tiers {label}: restores and fallbacks {delta}")


def _checked_restores(engine, record: list) -> None:
    """Read every page a restore uploads back from the card and hold it
    against the arena blocks it came from (verified against their
    spill-time stamps first)."""
    import torch

    from langstream_tpu_torch.serving.pagepool import pool_leaves

    upload = engine._restore_pages

    def checked(pages, blocks):
        upload(pages, blocks)
        leaves = pool_leaves(engine._pagepool.dev)
        for page, page_blocks in zip(pages, blocks):
            record.append(all(torch.equal(leaf[:, int(page)].cpu(), b.cpu())
                              for leaf, b in zip(leaves, page_blocks)))

    engine._restore_pages = checked


def _swap_ms(engine) -> dict:
    out = {}
    for name, reg in (("adapter", engine._adapters), ("grammar", engine._constrain_reg)):
        out[f"{name}_swaps"] = reg.swaps_total
        out[f"{name}_swap_ms"] = reg.swap_s_total * 1e3 / max(1, reg.swaps_total)
    return out


def _spmd_tier_pair(ctx, cfg, params) -> dict:
    """The tier pass of part (a): a leader and a follower with the tiers on
    over a loopback channel (echo on) serve the mix; then a no-mesh engine
    on the same tree serves it for the tokens."""
    import torch

    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.parallel import spmd_serving as wire
    from langstream_tpu_torch.serving.engine import ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.pagepool import table_len_for
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    kw = dict(max_batch=8, decode_chunk=SPMD_TIER_CHUNK, page_size=PAGE,
              eos_token_id=tok.eos_token_id, rng_seed=ctx["seed"], device="cuda",
              prefill_batch=8, grammar_tokenizer=tok, **SPMD_TIER_ENGINE)
    ch = _counting_channel(prefill_batch=8, max_width=2048, max_batch=8,
                           table_len=table_len_for(2048, PAGE), echo=True,
                           decode_chunk=SPMD_TIER_CHUNK)
    leader = ServingEngine(cfg, params, spmd=ch, **kw)
    follower = ServingEngine(cfg, params, spmd=ch, **kw)
    checks = {"leader": [], "follower": []}
    _checked_restores(leader, checks["leader"])
    _checked_restores(follower, checks["follower"])
    dispatched = _count_dispatches(leader, follower, ("_dev_decode",))
    errors: list = []

    def run():
        try:
            wire.follower_loop(follower, ch)
        except BaseException as e:  # noqa: BLE001 — read below
            errors.append(e)

    thread = threading.Thread(target=run, name="spmd-tier-follower", daemon=True)
    thread.start()
    t0 = time.monotonic()
    leader.start()
    sets = len(leader._graph_kinds())
    _spmd_wait(lambda: follower.graph_captures_total >= 3 * sets or errors, 300,
               "the follower's captures")
    out: dict = {"pair_capture_s": time.monotonic() - t0}
    mix = _spmd_tier_mix(ctx["seed"])

    def drill():
        leader._injector = FaultInjector("spmd-restore@1", seed=0)

    try:
        torch.cuda.synchronize()
        reset_kernel_counts()
        a0, b0 = ch.announces_total, ch.bytes_announced_total
        served = _serve_tier_mix(leader, mix, drill)
        _spmd_wait(lambda: errors or (ch._q.qsize() == 0
                                      and dispatched["follower"] == dispatched["leader"]),
                   120, "the follower to replay the mix")
        torch.cuda.synchronize()
        counts = {k: v["launches"] for k, v in kernel_counts().items()}
        if errors:
            raise AssertionError(f"spmd tiers: the follower failed: {errors[0]!r}")
        chunks = dispatched["leader"]
        out.update({
            "wall_s": served["wall_s"], "stats": served["delta"],
            "announces": ch.announces_total - a0, "announce_bytes": ch.bytes_announced_total - b0,
            "announce_bytes_per_chunk": (ch.bytes_announced_total - b0) / max(1, chunks),
            "by_op": {str(k): v for k, v in sorted(ch.by_op.items())},
            "echoes": ch.by_op.get(wire.OP_ECHO, 0), "agreements": ch.agreements_total,
            "kernel_launches": counts,
        })
        out["launches_per_engine"] = _tier_launches("(a)", counts, cfg.n_layers,
                                                    served["delta"], engines=2)
        _tier_restores("(a)", served["delta"])
        out["restores"] = {}
        for name, engine in (("leader", leader), ("follower", follower)):
            rec = checks[name]
            out["restores"][name] = {
                "pages_checked": len(rec), "bit_equal": all(rec),
                "restore_pages": engine.restore_pages_total,
                "restore_failures": engine.restore_failures_total,
                "restore_ms": engine.restore_s_total * 1e3,
                "arena_bytes": engine._host_tier.bytes_total, **_swap_ms(engine),
            }
            if not rec or not all(rec) or engine.restore_failures_total < 1:
                raise AssertionError(f"spmd tiers: {name}'s restores {out['restores'][name]}")
        if checks["follower"] != checks["leader"] or follower.restore_pages_total != (
                served["delta"]["restore-pages-total"]):
            raise AssertionError(f"spmd tiers: the ranks restored different pages: "
                                 f"{out['restores']}")
        if out["echoes"] < chunks:
            raise AssertionError(f"spmd tiers: {out['echoes']} echoes for {chunks} chunks")
        ctx["spmd_tiers"] = {"kernel_launches": {k: v // 2 for k, v in counts.items()}}
    finally:
        leader.stop()
        thread.join(timeout=60)
    if errors or thread.is_alive():
        raise AssertionError(f"spmd tiers: the follower did not stop cleanly: {errors}")
    ref_kw = {k: v for k, v in kw.items()}
    reference = ServingEngine(cfg, params, **ref_kw)
    t = time.monotonic()
    reference.start()
    out["reference_capture_s"] = time.monotonic() - t
    try:
        want = _serve_tier_mix(reference, mix)
        rows = [reference._adapters._by_name[r["adapter"]].row if r.get("adapter") else 0
                for r in mix]
        out["same_as_no_mesh"] = _same_or_tie(ctx, cfg, params, "spmd tiers (a)",
                                              [r["prompt"] for r in mix], served["tokens"],
                                              want["tokens"], lora=reference._adapters.pool,
                                              rows=rows)
    finally:
        reference.stop()
    if not out["same_as_no_mesh"]["ok"]:
        raise AssertionError(f"spmd tiers (a): tokens against no mesh {out['same_as_no_mesh']}")
    return out


def _spmd_tier_provider(ctx, cfg) -> dict:
    """The tier pass of part (b): the provider with ``mesh: {data: 2}`` and
    the tier keys (this process rank 0, the follower process on the card,
    echo on) serves the mix; each process launches exactly what the mix
    needs, the follower exits 0 with its share of the tiers in its exit
    line; then a provider without a mesh on the same drawn tree serves the
    mix for the tokens."""
    import gc

    import torch

    from langstream_tpu_torch.core.registry import REGISTRY
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.serving.faultinject import FaultInjector

    mix = _spmd_tier_mix(ctx["seed"] + 1)
    resource = dict(SPMD_SERVE, seed=ctx["seed"], **SPMD_TIER_RESOURCE)
    out: dict = {}
    t0 = time.monotonic()
    provider = REGISTRY.resource("tpu-serving").factory(
        dict(resource, mesh={"data": 2}, **{"spmd-parity-echo": True}))
    svc = provider.get_completions_service({})
    record: list = []
    try:
        engine = svc.engine()
        out["start_s"] = time.monotonic() - t0
        out["leader_capture_s"] = engine.graph_capture_s
        _checked_restores(engine, record)
        torch.cuda.synchronize()
        reset_kernel_counts()

        def drill():
            engine._injector = FaultInjector("spmd-restore@1", seed=0)

        served = _serve_tier_mix(engine, mix, drill)
        _spmd_wait(lambda: svc.engine_stats()["active-slots"] == 0, 60, "the leader's idle")
        torch.cuda.synchronize()
        leader = {k: v["launches"] for k, v in kernel_counts().items()}
        stats = svc.engine_stats()
        out["leader"] = {"restore_ms": engine.restore_s_total * 1e3,
                         "arena_bytes": engine._host_tier.bytes_total, **_swap_ms(engine)}
    finally:
        asyncio_close(provider)
    codes, exit_lines = svc.follower_exit_codes, svc.follower_exit_lines
    svc._engine = None
    provider = svc = engine = None
    gc.collect()
    torch.cuda.empty_cache()
    if codes != [0] or not exit_lines:
        raise AssertionError(f"spmd tiers (b): follower exit codes {codes}")
    follower = exit_lines[0].get("kernels", {})
    out.update({"wall_s": served["wall_s"], "stats": served["delta"],
                "announces": stats["spmd-announces-total"],
                "announce_bytes": stats["spmd-announce-bytes-total"],
                "leader_kernel_launches": leader, "follower_kernel_launches": follower,
                "follower_tier": exit_lines[0].get("tier", {}),
                "leader_pages_checked": len(record), "leader_bit_equal": all(record)})
    _tier_launches("(b) leader", leader, cfg.n_layers, served["delta"])
    _tier_launches("(b) follower", follower, cfg.n_layers, served["delta"])
    _tier_restores("(b)", served["delta"])
    tier = out["follower_tier"]
    if (not record or not all(record) or tier.get("restore-failures", 0) < 1
            or tier.get("restore-pages") != served["delta"]["restore-pages-total"]):
        raise AssertionError(f"spmd tiers (b): restores leader {record}, follower {tier}")
    ctx["spmd_tiers_leader"] = {"kernel_launches": leader}
    ctx["spmd_tiers_follower"] = {"kernel_launches": follower}
    provider = REGISTRY.resource("tpu-serving").factory(resource)
    svc = provider.get_completions_service({})
    try:
        engine = svc.engine()
        want = _serve_tier_mix(engine, mix)
        rows = [engine._adapters._by_name[r["adapter"]].row if r.get("adapter") else 0
                for r in mix]
        out["same_as_no_mesh"] = _same_or_tie(ctx, cfg, svc.params(), "spmd tiers (b)",
                                              [r["prompt"] for r in mix], served["tokens"],
                                              want["tokens"], lora=engine._adapters.pool,
                                              rows=rows)
    finally:
        asyncio_close(provider)
    svc._engine = None
    provider = svc = engine = None
    gc.collect()
    torch.cuda.empty_cache()
    if not out["same_as_no_mesh"]["ok"]:
        raise AssertionError(f"spmd tiers (b): tokens against no mesh {out['same_as_no_mesh']}")
    return out


def phase_spmd(ctx: dict) -> None:
    """The SPMD plane on the card at llama-3-8b's full width: (a) at
    ``SHALLOW_LAYERS`` depth, (b) and (c) at ``SPMD_SERVE``'s 4 layers."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    cfg = MODEL_PRESETS["llama-3-8b"]
    params = _llama_params(ctx)
    t = time.monotonic()
    shallow = _shallow(cfg, params)
    pair = _spmd_loopback(ctx, *shallow)
    pair["part_s"] = time.monotonic() - t
    log(f"spmd loopback llama-3-8b bf16 {json.dumps(pair)}")
    t = time.monotonic()
    tier_pair = _spmd_tier_pair(ctx, *shallow)
    tier_pair["part_s"] = time.monotonic() - t
    shallow = None
    log(f"spmd tiers (a) loopback llama-3-8b bf16 {json.dumps(tier_pair)}")
    t = time.monotonic()
    # (b) and (c) draw SPMD_SERVE's tree (part (b) collects this one); a
    # later phase draws it again
    ctx.pop("params", None)
    params = None
    procs = _spmd_two_processes(ctx, MODEL_PRESETS[SPMD_SERVE["model"]])
    procs["part_s"] = time.monotonic() - t
    log(f"spmd two processes {{data: 2}} {json.dumps(procs)}")
    t = time.monotonic()
    tier_procs = _spmd_tier_provider(ctx, MODEL_PRESETS[SPMD_SERVE["model"]])
    tier_procs["part_s"] = time.monotonic() - t
    log(f"spmd tiers (b) two processes {{data: 2}} {json.dumps(tier_procs)}")
    t = time.monotonic()
    world1 = _spmd_world1(ctx)
    world1["part_s"] = time.monotonic() - t
    log(f"spmd world-1 nccl {{model: 1}} {json.dumps(world1)}")
    ctx.setdefault("summaries", []).append(("spmd", {
        "announce_bytes_per_chunk": pair["burst"]["bytes_per_announce"],
        "announce_ms_mean": pair["burst"]["announce_ms_mean"],
        "pair_capture_s": pair["pair_capture_s"], "resyncs": pair["spmd_resyncs"],
        "recoveries": pair["spmd_recoveries"], "follower_start_s": procs["start_s"],
        "decode_ms_no_mesh": world1["no_mesh"]["device_ms_per_step"],
        "decode_ms_model1": world1["mesh_model1"]["device_ms_per_step"],
        "tiers_pair_capture_s": {"off": pair["pair_capture_s"], "on": tier_pair["pair_capture_s"]},
        "tiers_announce_bytes_per_chunk": tier_pair["announce_bytes_per_chunk"],
        "tiers_part_a_s": tier_pair["part_s"], "tiers_part_b_s": tier_procs["part_s"],
        "tiers_follower_start_s": {"off": procs["start_s"], "on": tier_procs["start_s"]},
    }))


RING_NEW = 32
RING_INT8_NEW = 16
RING_PREFILL_BYTES = 7000  # a 7001-token prompt, padded to 8192 over 2 seq ranks
# layer 0's K/V, ring against the segment loop: the same projections at
# other GEMM shapes (M 4096 a rank against 2048 a segment), so bf16
# roundings one ulp apart: |diff| <= atol + rtol * |ref| element by element
RING_KV_TOL = {"atol": 1e-2, "rtol": 1e-2}


def _ring_ranks(fn, n: int = 2) -> list:
    """``fn(rank)`` on ``n`` threads, one a seq rank of a loopback ring →
    the results in rank order; a rank that raised fails the run."""
    out: list = [None] * n
    errors: list = []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), name=f"ring-rank-{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"ring: a rank failed or hung: {errors!r}")
    return out


def _ring_prefill_check(ctx, cfg, params) -> dict:
    """Part (a): ``ring_prefill`` of a 7001-token prompt padded to 8192 over
    a loopback pair (seq ranks 0 and 1 on two threads) against the port's
    dense chunked prefill (4 segments of 2048, the engine's kv_bound rule)
    on the same weights: last-token logits within MODEL_REL_TOL of the
    largest, top-1 equal; layer 0's K/V within RING_KV_TOL. Times both and
    the ring's peak memory."""
    import torch

    from langstream_tpu_torch.models import transformer as tf
    from langstream_tpu_torch.parallel.sp import ring_prefill
    from langstream_tpu_torch.parallel.spmd_serving import LoopbackRing
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    prompt = ByteTokenizer().encode(_prompts([RING_PREFILL_BYTES], ctx["seed"])[0])
    n, s_pad, width = len(prompt), 8192, 2048
    tokens = torch.zeros((1, s_pad), dtype=torch.long, device="cuda")
    tokens[0, :n] = torch.tensor(prompt, device="cuda")
    lengths = torch.tensor([n], device="cuda")
    rings = LoopbackRing.ranks(2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def rank(r):
        logits, kv = ring_prefill(params, tokens, lengths, cfg, rings[r])
        return logits, kv["k"][0].clone(), kv["v"][0].clone()  # layer 0 of this rank's block

    t0 = time.monotonic()
    outs = _ring_ranks(rank)
    torch.cuda.synchronize()
    ring_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.equal(outs[0][0], outs[1][0]):
        raise AssertionError("ring prefill: the two ranks' logits differ")
    ring_k = torch.cat([o[1] for o in outs], dim=2)  # [B, Hkv, S_pad, D]
    ring_v = torch.cat([o[2] for o in outs], dim=2)
    cache = tf.make_kv_cache(cfg, 1, s_pad + 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for s0 in range(0, n, width):
        seg, real = _segment_tokens(torch, tokens[:, :n], s0, width)
        dense, _ = tf.prefill_segment(params, seg, torch.tensor([s0], device="cuda"),
                                      torch.tensor([real], device="cuda"), cache, cfg,
                                      kv_bound=min(s0 + width, s_pad))
    torch.cuda.synchronize()
    dense_s = time.monotonic() - t0
    check = _hold_logits("ring prefill", {"kernel": [outs[0][0].float()],
                                          "reference": [dense.float()]})
    if not check["step0_top1_equal"]:
        raise AssertionError(f"ring prefill: top-1 differs from the segment loop's {check}")
    kv = {name: hold(f"ring prefill layer-0 {name.upper()}", mine[..., :n, :],
                     cache[name][0][..., :n, :], RING_KV_TOL)
          for name, mine in (("k", ring_k), ("v", ring_v))}
    return {"prompt_tokens": n, "padded": s_pad, "ranks": 2, "logits": check, "layer0_kv": kv,
            "ring_s": ring_s, "segment_loop_s": dense_s, "peak_gib": peak / 2**30}


def _ring_pair(ctx, cfg, params, prompts, new_tokens: int) -> dict:
    """Part (b): a leader and a follower engine as the {seq: 2} pair of one
    replica (loopback channel with echo, ``LoopbackRing``), dense layout,
    max_seq_len 8192, serving ``prompts`` greedy after one warm-up request,
    kernel counts zeroed just before. Raises unless every long prompt was
    ring-admitted, no segment ran, each engine launched exactly layers x
    decode steps dense decode kernels (the process twice that), each
    engine's replays equal the leader's chunks, every request gave
    ``new_tokens``, and the follower's tokens, positions and ring slots'
    cache rows are bit-equal to the leader's afterwards."""
    import torch

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.parallel import spmd_serving as wire
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.pagepool import pool_leaves
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    kw = dict(max_batch=8, decode_chunk=16, eos_token_id=tok.eos_token_id,
              rng_seed=ctx["seed"], device="cuda", prefill_batch=8, **DENSE_KW)
    ch = _counting_channel(prefill_batch=8, max_width=2048, max_batch=8, table_len=0,
                           echo=True, decode_chunk=16)
    rings = wire.LoopbackRing.ranks(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    leader = ServingEngine(cfg, params, spmd=ch, ring=rings[0], **kw)
    follower = ServingEngine(cfg, params, spmd=ch, ring=rings[1], **kw)
    ring_slots: list = []
    real_ring = leader._dev_ring

    def ring_counted(tokens, prompt_len, *a, **k):
        ring_slots.append((a[3], tokens.shape[1]))  # (slot, padded width)
        return real_ring(tokens, prompt_len, *a, **k)

    leader._dev_ring = ring_counted
    dispatched = _count_dispatches(leader, follower, ("_dev_decode",))
    errors: list = []

    def run():
        try:
            wire.follower_loop(follower, ch)
        except BaseException as e:  # noqa: BLE001 — read below
            errors.append(e)

    thread = threading.Thread(target=run, name="ring-follower", daemon=True)
    thread.start()
    out: dict = {}
    try:
        t0 = time.monotonic()
        leader.start()
        _spmd_wait(lambda: follower.graph_captures_total >= 3 * len(leader._graph_kinds())
                   or errors, 300, "the follower's captures")
        out["pair_capture_s"] = time.monotonic() - t0
        leader.generate(tok.encode("warm up"), GenerationOptions(max_new_tokens=4), timeout=600)
        _spmd_wait(lambda: errors or (ch._q.qsize() == 0
                                      and dispatched["follower"] == dispatched["leader"]),
                   120, "the follower to replay the warm-up")
        torch.cuda.synchronize()
        before = leader.stats()
        f_replays0 = follower.graph_replays_total
        ring_slots.clear()
        opts = GenerationOptions(max_new_tokens=new_tokens, temperature=0.0)
        reset_kernel_counts()
        t0 = time.monotonic()
        reqs = [leader.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts]
        results = [r.result(timeout=900) for r in reqs]
        out["wall_s"] = time.monotonic() - t0
        _spmd_wait(lambda: errors or (ch._q.qsize() == 0
                                      and dispatched["follower"] == dispatched["leader"]),
                   120, "the follower to replay the burst")
        torch.cuda.synchronize()
        counts = kernel_counts()
        after = leader.stats()
        if errors:
            raise AssertionError(f"ring pair: the follower failed: {errors[0]!r}")
        f_replays = follower.graph_replays_total - f_replays0
        # lockstep: the decode chain and the ring slots' cache rows (the
        # sink column left out), every leaf (int8: values and scales)
        cols = leader.max_seq_len
        same = {
            "tokens": torch.equal(leader._tokens_dev, follower._tokens_dev),
            "positions": torch.equal(leader._positions_dev, follower._positions_dev),
            "ring_rows": all(
                torch.equal(a[:, i, :, :cols], b[:, i, :, :cols])
                for a, b in zip(pool_leaves(leader._cache), pool_leaves(follower._cache))
                for i, _ in ring_slots
            ),
        }
    finally:
        leader.stop()
        thread.join(timeout=60)
    widest = max(leader.prefill_buckets)
    long_prompts = sum(len(p) > widest for p in prompts)
    rings_admitted = after["ring-admissions-total"] - before["ring-admissions-total"]
    segments = after["prefill-segments-total"] - before["prefill-segments-total"]
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    chunks = after["decode-chunks-total"] - before["decode-chunks-total"]
    groups = after["admit-groups-total"] - before["admit-groups-total"]
    replays = after["graph-replays-total"] - before["graph-replays-total"]
    decode = "dense_decode_int8" if cfg.kv_cache_dtype == "int8" else "dense_decode"
    got = counts[decode]["launches"]
    plain = {k: v["cpu_calls"] for k, v in counts.items() if v["cpu_calls"]}
    problems = []
    if plain:
        problems.append(f"plain versions ran: {plain}")
    if rings_admitted != long_prompts or len(ring_slots) != long_prompts or segments:
        problems.append(f"{rings_admitted} ring admissions ({len(ring_slots)} dispatches) and "
                        f"{segments} segments for {long_prompts} long prompts")
    if got != 2 * cfg.n_layers * steps or steps <= 0:
        problems.append(f"{decode} launches {got} != 2 x {cfg.n_layers} x {steps} steps")
    if groups and counts["flash_prefill"]["launches"] < 2 * cfg.n_layers * groups:
        problems.append(f"flash_prefill launches {counts['flash_prefill']['launches']} < "
                        f"2 x {cfg.n_layers} x {groups} admit groups")
    if counts["flash_segment"]["launches"] or counts["flash_segment_int8"]["launches"]:
        problems.append("a segment kernel ran on the ring pair's path")
    if replays != chunks or f_replays != chunks or chunks <= 0:
        problems.append(f"{chunks} chunks, replays leader {replays} follower {f_replays}")
    for p, r in zip(prompts, results):
        if r.error is not None or len(r.tokens) != new_tokens:
            problems.append(f"request of {len(p)} tokens ended {r.finish_reason}: {r.error}")
    if not all(same.values()):
        problems.append(f"follower not bit-equal to the leader: {same}")
    if problems:
        raise AssertionError("ring pair: " + "; ".join(problems))
    widths = sorted({w for _, w in ring_slots})
    out.update({
        "requests": len(results), "prompt_tokens": [len(p) for p in prompts],
        "ring_admissions": rings_admitted, "ring_padded_widths": widths,
        "admit_groups": groups, "segments": segments, "decode_steps": steps,
        "decode_chunks": chunks, "graph_replays": {"leader": replays, "follower": f_replays},
        "kernel_launches": {k: v["launches"] // 2 for k, v in counts.items()},
        "ring_announces": ch.by_op.get(wire.OP_RING, 0), "echoes": ch.by_op.get(wire.OP_ECHO, 0),
        "ttft_s": [r.ttft_s for r in results],
        "tokens_per_s": sum(len(r.tokens) for r in results) / out["wall_s"],
        "lockstep": same, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "_tokens": [r.tokens for r in results],
    })
    return out


def _ring_reference(ctx, cfg, params, prompts, new_tokens: int, key: str) -> dict:
    """A single engine's segment loop over ``prompts`` (dense, 8192) → their
    tokens and TTFT: from the ``dense`` / ``dense_int8`` phase's run
    (``key``) when it served them in this process at ``cfg``'s depth, else
    served here. A request's tokens do not depend on the other rows of its
    batch (decode runs all max_batch rows whatever is active; a long prompt
    prefills alone)."""
    ref = ctx.get(key)
    if (ref is None or ref["new"] != new_tokens or ref["layers"] != cfg.n_layers
            or any(p not in ref["prompts"] for p in prompts)):
        run = _serve(ctx, cfg, params, [], new_tokens, prompts=prompts, **DENSE_KW)
        ref = ctx[key] = {"prompts": prompts, "new": new_tokens, "_tokens": run["_tokens"],
                          "ttft_s": run["ttft_s"], "layers": cfg.n_layers}
    at = [ref["prompts"].index(p) for p in prompts]
    return {"_tokens": [ref["_tokens"][i] for i in at], "ttft_s": [ref["ttft_s"][i] for i in at]}


def phase_ring(ctx: dict) -> None:
    """Ring prefill over the seq axis at llama-3-8b's full width and
    ``SHALLOW_LAYERS`` of its layers (bf16, random weights from ``--seed``): (a) ``ring_prefill`` over a
    loopback pair against the segment loop; (b) the {seq: 2} loopback
    pair of engines serving the ``dense`` phase's traffic against a single
    engine's segment loop, then an int8 dense cache with a 3001-token
    prompt. Both ranks share one card, so no gain is expected."""
    import gc

    import torch

    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg, params = _shallow(MODEL_PRESETS["llama-3-8b"], _llama_params(ctx))
    smi = smi_line()
    t = time.monotonic()
    pre = _ring_prefill_check(ctx, cfg, params)
    pre["part_s"] = time.monotonic() - t
    log(f"ring prefill llama-3-8b bf16 ({smi}) {json.dumps(pre)}")
    gc.collect()
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in _prompts(DENSE_BYTES, ctx["seed"])]
    ref = _ring_reference(ctx, cfg, params, prompts, RING_NEW, "dense_reference")
    t = time.monotonic()
    pair = _ring_pair(ctx, cfg, params, prompts, RING_NEW)
    pair["part_s"] = time.monotonic() - t
    pair["tokens_vs_segment_loop"] = _same_or_tie(ctx, cfg, params, "ring pair", prompts,
                                                  pair.pop("_tokens"), ref["_tokens"])
    widest = 2048
    pair["ring_ttft_s"] = {len(p): [a, b] for p, a, b in zip(prompts, pair["ttft_s"],
                                                              ref["ttft_s"]) if len(p) > widest}
    log(f"ring pair {{seq: 2}} llama-3-8b bf16 ({smi}; ring_ttft_s: prompt tokens -> "
        f"[ring, segment loop]) {json.dumps(pair)}")
    if not pair["tokens_vs_segment_loop"]["ok"]:
        raise AssertionError(f"ring pair tokens: {pair['tokens_vs_segment_loop']}")
    ctx["ring"] = {"kernel_launches": pair["kernel_launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    # the dense_int8 phase's 3001-token prompt
    long8 = [tok.encode(_prompts(DENSE_INT8_BYTES, ctx["seed"])[-1])]
    ref8 = _ring_reference(ctx, cfg8, params, long8, RING_INT8_NEW, "dense_int8_reference")
    t = time.monotonic()
    pair8 = _ring_pair(ctx, cfg8, params, long8, RING_INT8_NEW)
    pair8["part_s"] = time.monotonic() - t
    pair8["tokens_vs_segment_loop"] = _same_or_tie(ctx, cfg8, params, "ring pair int8", long8,
                                                   pair8.pop("_tokens"), ref8["_tokens"])
    log(f"ring pair {{seq: 2}} llama-3-8b int8-kv ({smi}) {json.dumps(pair8)}")
    if not pair8["tokens_vs_segment_loop"]["ok"]:
        raise AssertionError(f"ring pair int8 tokens: {pair8['tokens_vs_segment_loop']}")
    ctx["ring_int8"] = {"kernel_launches": pair8["kernel_launches"]}
    ctx.setdefault("summaries", []).append(("ring", {
        "prefill_s": pre["ring_s"], "segment_loop_s": pre["segment_loop_s"],
        "prefill_peak_gib": pre["peak_gib"], "logits_rel_err": pre["logits"]["step0_rel_err"],
        "ring_ttft_s": pair["ring_ttft_s"], "pair_tokens_per_s": pair["tokens_per_s"],
        "ties": len(pair["tokens_vs_segment_loop"]["ties"]),
    }))


def asyncio_close(provider) -> None:
    import asyncio

    asyncio.run(provider.close())


def kernel_record(ctx: dict) -> dict:
    # kernel → (source, the TPU kernel it replaces, the phase whose path
    # counts its launches)
    sources = {
        "flash_prefill": ("flash_segment.cu", "langstream_tpu/ops/attention.py:143", "e2e"),
        "paged_decode": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:849", "e2e"),
        "paged_decode_int8": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:979", "int8"),
        "flash_segment": ("flash_segment.cu", "langstream_tpu/ops/attention.py:289", "dense"),
        "flash_segment_int8": (
            "flash_segment.cu", "langstream_tpu/ops/attention.py:383", "dense_int8"
        ),
        "dense_decode": ("ragged_decode.cu", "langstream_tpu/ops/attention.py:526", "dense"),
        "dense_decode_int8": (
            "ragged_decode.cu", "langstream_tpu/ops/attention.py:670", "dense_int8"
        ),
    }
    # every serving run's launches of each kernel (counts zeroed before each)
    served = ("e2e", "int8", "dense", "dense_int8", "paged_long", "paged_long_int8", "prefix",
              "spec", "agentic", "dense_spec", "dense_prefix", "dense_prefix_int8", "tiered",
              "fleet", "fleet_http", "spmd", "spmd_leader", "spmd_follower", "spmd_tiers",
              "spmd_tiers_leader", "spmd_tiers_follower", "ring", "ring_int8",
              "load", "moe", "app", "rag", "remote", "python", "control", "brokers_kafka",
              "brokers_pulsar", "brokers_pravega", "k8s")
    out = []
    for name, (src, replaces, path) in sources.items():
        runs = ctx.get("kernel_runs", {}).get(name)
        if not runs:
            continue
        main = runs[-1]  # the widest shape measured
        run = ctx.get(path)
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"langstream_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": run["kernel_launches"][name] if run else None,
            "launches_by_phase": {p: ctx[p]["kernel_launches"][name] for p in served if p in ctx},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            "tolerance": main["tolerance"],
            # the flash rows' rate, and every row's share of its bound, at that shape
            **{key: main[key] for key in ("tflops", "bound_share", "gbps") if key in main},
            # the decode rows at each of their shapes
            **({"by_shape": [
                {key: r[key] for key in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_share", "gbps")}
                for r in runs
            ]} if "decode" in name else {}),
        })
    return {"kernels": out}


def arm_lockorder():
    """Install the port's lock-order recorder before any module of the port
    is imported (a lock made at import before the factory is in place goes
    untracked) → the recorder. Importing it loads the package's
    ``__init__`` (no lock, no torch) and the stdlib-only ``analysis``
    package, nothing else of the port."""
    early = sorted(m for m in sys.modules if m.split(".")[0] == "langstream_tpu_torch")
    if early:
        raise AssertionError(f"port modules imported before the recorder: {early}")
    from langstream_tpu_torch.analysis import lockorder

    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "langstream_tpu_torch"
                    and m != "langstream_tpu_torch"
                    and not m.startswith("langstream_tpu_torch.analysis"))
    if loaded:
        raise AssertionError(f"arming the recorder imported port modules: {loaded}")
    return lockorder.activate()


def lockorder_line(rec) -> dict:
    """What the recorder saw over the run, and the host cost of one tracked
    acquire against a real one; raises with the report on any cycle."""
    from langstream_tpu_torch.analysis import lockorder

    out = rec.summary()
    cost = lockorder.acquire_cost_ns(100_000)
    out.update(tracked_acquire_ns=round(cost["tracked_ns"], 1),
               real_acquire_ns=round(cost["real_ns"], 1), cost_loop=cost["n"],
               edge_list=[[a, b, n] for (a, b), n in sorted(rec.edges().items())])
    if out["cycles"]:
        raise AssertionError(f"lock-order cycle(s) in the port:\n{rec.report()}")
    return out


def ab_times(parent: Path) -> dict[str, list]:
    """Kernel times of another checkout (``parent``) and this one on one
    card: ``chip_smoke.py --phases build,kernels`` run from each, in the
    order parent, change, change, parent → {kernel and shape: [(label,
    ms), ...]}."""
    times: dict[str, list] = {}
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", "build,kernels"],
            cwd=tree, capture_output=True, text=True, timeout=420,
        )
        if run.returncode != 0:
            raise RuntimeError(f"{label} run in {tree} failed:\n{run.stderr[-3000:]}")
        for line in run.stdout.splitlines():
            m = re.match(r"kernel (\S+) (\{.*\})$", line)
            if m:
                rec = json.loads(m.group(2))
                times.setdefault(f"{m.group(1)} {rec['shape']}", []).append((label, rec["ms"]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help=f"comma-separated subset of {PHASES} (default: {DEFAULT_PHASES})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=Path, metavar="PARENT",
                    help="instead of the phases, compare the kernel times of the checkout "
                         "PARENT with this one's (parent, change, change, parent)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not (ROOT / "langstream_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(langstream_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    recorder = arm_lockorder()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if args.ab is not None:
        for key, runs in ab_times(args.ab.resolve()).items():
            log(f"ab {key}: " + " ".join(f"{label}={ms:.5f}" for label, ms in runs))
        log(f"lockorder {json.dumps(lockorder_line(recorder))}")
        print(smi_line())
        print(json.dumps({"partial": True, "ab": str(args.ab)}))
        return 0
    ctx: dict = {"seed": args.seed}
    t_all = time.monotonic()
    faulthandler.dump_traceback_later(STACKS_AT_S, exit=False)
    phase_s: dict = {}
    for phase in PHASES:
        if phase in phases:
            t0 = time.monotonic()
            globals()[f"phase_{phase}"](ctx)
            phase_s[phase] = round(time.monotonic() - t0, 1)
            log(f"phase {phase}: {phase_s[phase]:.1f}s")
            # on stderr as well, beside the phases' own warnings: the
            # progress of a run that was cut
            print(f"phase {phase}: {phase_s[phase]:.1f}s after "
                  f"{time.monotonic() - t_all:.1f}s", file=sys.stderr, flush=True)
    faulthandler.cancel_dump_traceback_later()
    # every phase's seconds again on one line (the tool keeps the output's
    # tail, where the phase lines of a full run have scrolled away)
    log(f"all phases: {time.monotonic() - t_all:.1f}s {json.dumps(phase_s)}")
    for name, summary in ctx.get("summaries", []):
        log(f"{name} summary {json.dumps(summary)}")
    complete = set(DEFAULT_PHASES) <= set(phases)
    log(f"lockorder {json.dumps(lockorder_line(recorder))}")
    record = kernel_record(ctx)
    if complete:
        for k in record["kernels"]:
            if not k["launches"]:
                raise AssertionError(f"{k['name']} was never launched on its path")
    print(json.dumps(record))
    print(smi_line())
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    # only a run of every default phase may say ok: a partial run checked
    # less, and says so instead
    if complete:
        print(json.dumps({"ok": True, "device": device}))
    else:
        print(json.dumps({"partial": True, "phases": phases, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
